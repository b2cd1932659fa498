"""Simple CNN classifier.

Counterpart of ``biapy_tpu/models/simple_cnn.py::SimpleCNN`` in 3D and 2D:
two blocks of three convs (32 then 64 filters; 3, 3 and 5 wide), each
block's tail in the JAX module's order (the 5-wide conv, the 2x2x2 (2D:
2x2) max-pool, the activation, then BatchNorm and dropout 0.4), and a head
of dropout 0.5 and one Dense layer on the channels-last flattened
features. The convs route through ``blocks.Conv`` (3x3x3: the conv3d
kernel; 5x5x5: zcat and one 2D conv; in 2D a PyTorch convolution), the
pools through the pool kernel. Returns the logits; the
workflow applies the softmax at inference.

Children carry Flax's auto-names (``Conv_0``...``Conv_5``,
``BatchNorm_0``...``BatchNorm_5`` in call order, ``Dense_0``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from biapy_tpu_torch.models.blocks import (BatchNorm, Conv, Dense, Dropout, FlaxNamed,
                                           get_activation, max_pool)


class SimpleCNN(FlaxNamed):
    """``input_shape`` is DATA.PATCH_SIZE, ``(z, y, x, C)`` or ``(y, x, C)``:
    the Dense layer's width (Flax infers it at init) is the features left
    after two pools, which floor as XLA's VALID pooling does."""

    def __init__(self, ndim: int = 3, n_classes: int = 2, activation: str = "relu",
                 input_shape: Sequence[int] = (32, 64, 64, 1),
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.act = get_activation(activation)
        self.window = (2,) * ndim
        c = int(input_shape[-1])
        for feats in (32, 64):
            for k in (3, 3, 5):
                self.child("Conv", Conv(c, feats, (k,) * ndim, gen=gen))
                c = feats
            for _ in range(3):
                self.child("BatchNorm", BatchNorm(feats))
        self.drops = torch.nn.ModuleList([Dropout(0.4), Dropout(0.4), Dropout(0.5)])
        flat = c * math.prod(int(s) // 2 // 2 for s in input_shape[:ndim])
        self.child("Dense", Dense(flat, n_classes, gen=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self.act
        h = x
        for b in range(2):
            conv = [getattr(self, f"Conv_{3 * b + i}") for i in range(3)]
            bn = [getattr(self, f"BatchNorm_{3 * b + i}") for i in range(3)]
            h = act(bn[0](conv[0](h)))
            h = act(bn[1](conv[1](h)))
            h = act(max_pool(conv[2](h), self.window))
            h = self.drops[b](bn[2](h))
        # channels-last (N, [D,] H, W, C) flattened in that order, as Flax does
        h = self.drops[2](h.reshape(h.shape[0], -1))
        return self.Dense_0(h)
