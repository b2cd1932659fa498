"""EfficientNet B0-B7 classifier.

Counterpart of ``biapy_tpu/models/efficientnet.py::EfficientNet`` (2D,
channels-last; no pretrained weights, as in the JAX package): a strided
stem, MBConv blocks with squeeze-and-excitation and stochastic depth under
compound width / depth scaling (Tan & Le 2019), a 1x1 head conv, the
spatial mean, dropout and a Dense layer returning ``{"class": logits}``.
Every conv is a ``blocks.StridedConv`` (the strided and depthwise convs a
PyTorch convolution after XLA's SAME padding, the 1x1 convs a
``torch.matmul``); BatchNorm at eps 1e-3 and momentum 0.9. Children carry
Flax's auto-names (``Conv_<i>``, ``BatchNorm_<i>``, ``MBConv_<i>``,
``Dense_0``).

The torchvision weight import (JAX ``torchvision_key_map`` /
``load_torchvision_efficientnet``, MODEL.SOURCE torchvision) is ROADMAP
items 10-11.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from biapy_tpu_torch.models.blocks import (BatchNorm, Dense, DropPath, Dropout, FlaxNamed,
                                           StridedConv)

# (width_mult, depth_mult, dropout)
_VARIANTS = {
    "efficientnet_b0": (1.0, 1.0, 0.2),
    "efficientnet_b1": (1.0, 1.1, 0.2),
    "efficientnet_b2": (1.1, 1.2, 0.3),
    "efficientnet_b3": (1.2, 1.4, 0.3),
    "efficientnet_b4": (1.4, 1.8, 0.4),
    "efficientnet_b5": (1.6, 2.2, 0.4),
    "efficientnet_b6": (1.8, 2.6, 0.5),
    "efficientnet_b7": (2.0, 3.1, 0.5),
}

# base B0 stages: (expand, channels, layers, stride, kernel)
_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]


def _round_channels(c: float, mult: float, divisor: int = 8) -> int:
    c *= mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, eps=1e-3, momentum=0.9)


class MBConv(FlaxNamed):
    """Expand 1x1 (unless ``expand`` is 1), depthwise k x k at ``stride``,
    SiLU after each BatchNorm, SE of ``max(1, in_ch // 4)`` channels (of the
    block's INPUT), project 1x1 and BatchNorm; the residual, through
    DropPath, only at stride 1 with equal widths."""

    def __init__(self, in_ch: int, out_ch: int, expand: int, stride: int, kernel: int,
                 sd_prob: float = 0.0, gen: Optional[torch.Generator] = None):
        super().__init__()
        mid = in_ch * expand
        se_ch = max(1, in_ch // 4)
        self.expand = expand
        self.residual = stride == 1 and in_ch == out_ch
        if expand != 1:
            self.parts["expand"] = self.child("Conv", StridedConv(
                in_ch, mid, (1, 1), use_bias=False, gen=gen))
            self.parts["bn_expand"] = self.child("BatchNorm", _bn(mid))
        self.parts["dw"] = self.child("Conv", StridedConv(
            mid, mid, (kernel, kernel), strides=stride, groups=mid, use_bias=False, gen=gen))
        self.parts["bn_dw"] = self.child("BatchNorm", _bn(mid))
        self.parts["se_reduce"] = self.child("Conv", StridedConv(mid, se_ch, (1, 1), gen=gen))
        self.parts["se_expand"] = self.child("Conv", StridedConv(se_ch, mid, (1, 1), gen=gen))
        self.parts["project"] = self.child("Conv", StridedConv(
            mid, out_ch, (1, 1), use_bias=False, gen=gen))
        self.parts["bn_project"] = self.child("BatchNorm", _bn(out_ch))
        self.drop_path = DropPath(sd_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.parts
        h = x
        if self.expand != 1:
            h = F.silu(p["bn_expand"](p["expand"](h)))
        h = F.silu(p["bn_dw"](p["dw"](h)))
        s = h.mean(dim=(1, 2), keepdim=True)
        s = p["se_expand"](F.silu(p["se_reduce"](s)))
        h = h * torch.sigmoid(s)
        h = p["bn_project"](p["project"](h))
        if self.residual:
            h = x + self.drop_path(h)
        return h


class EfficientNet(FlaxNamed):
    """``variant`` one of ``efficientnet_b0`` ... ``b7``; ``in_channels``
    the images' (Flax infers it at init). Stochastic depth rises linearly
    to 0.2 over the blocks (``0.2 * bi / (total - 1)``); the head's dropout
    is the variant's."""

    def __init__(self, variant: str = "efficientnet_b0", n_classes: int = 2,
                 in_channels: int = 3, gen: Optional[torch.Generator] = None):
        super().__init__()
        wm, dm, dropout = _VARIANTS[variant]
        c = _round_channels(32, wm)
        self.child("Conv", StridedConv(in_channels, c, (3, 3), strides=2, use_bias=False,
                                       gen=gen))
        self.child("BatchNorm", _bn(c))
        total = sum(int(math.ceil(layers * dm)) for _, _, layers, _, _ in _STAGES)
        self.blocks = []
        bi = 0
        for expand, ch, layers, stride, kernel in _STAGES:
            out_ch = _round_channels(ch, wm)
            for li in range(int(math.ceil(layers * dm))):
                sd = 0.2 * bi / max(total - 1, 1)
                self.blocks.append(self.child("MBConv", MBConv(
                    c, out_ch, expand, stride if li == 0 else 1, kernel, sd, gen=gen)))
                c = out_ch
                bi += 1
        head = _round_channels(1280, wm)
        self.child("Conv", StridedConv(c, head, (1, 1), use_bias=False, gen=gen))
        self.child("BatchNorm", _bn(head))
        self.drop = Dropout(dropout)
        self.child("Dense", Dense(head, n_classes, gen=gen))

    def forward(self, x: torch.Tensor):
        h = F.silu(self.BatchNorm_0(self.Conv_0(x)))
        for blk in self.blocks:
            h = blk(h)
        h = F.silu(self.BatchNorm_1(self.Conv_1(h)))
        h = self.drop(h.mean(dim=(1, 2)))
        return {"class": self.Dense_0(h)}
