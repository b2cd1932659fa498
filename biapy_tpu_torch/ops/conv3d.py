"""Stride-1 SAME convolution on channels-last tensors.

Counterpart of ``biapy_tpu/ops/conv3d.py::conv3d_dispatch`` for the convs
of the U-Net family (stride 1, SAME, ungrouped, undilated). Weights keep
the JAX package's layout, ``kernel_size + (Cin, Cout)``.

- A 3x3x3 conv goes to the hand-written kernel (``ops/kernels/conv3d.py``).
- A 1x1x1 conv is a ``torch.matmul`` over the channel axis.
- Every other kernel size (the 5x5x5 LARGER_IO convs, anisotropic
  (1, k, k) levels) stays a PyTorch convolution, as the JAX package leaves
  it to XLA; float32 runs there without TF32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from biapy_tpu_torch.ops.kernels.conv3d import conv3d as conv3d_k3


def conv_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv of ``(N, *spatial, Cin)`` with ``(*k, Cin, Cout)``."""
    ks = tuple(w.shape[:-2])
    if ks == (3, 3, 3):
        return conv3d_k3(x.contiguous(), w.contiguous())
    if all(k == 1 for k in ks):
        return torch.matmul(x, w.reshape(w.shape[-2], w.shape[-1]))
    # XLA's SAME at stride 1: k - 1 padding, the odd voxel after
    flat = []
    for k in reversed(ks):
        flat += [(k - 1) // 2, k - 1 - (k - 1) // 2]
    xc = F.pad(x.movedim(-1, 1), flat)
    wc = w.permute(len(ks) + 1, len(ks), *range(len(ks)))  # (k..., I, O) -> (O, I, k...)
    conv = F.conv3d if len(ks) == 3 else F.conv2d
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = conv(xc, wc)
    return y.movedim(1, -1).contiguous()
