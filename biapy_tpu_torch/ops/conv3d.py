"""Stride-1 SAME convolution on channels-last tensors.

Counterpart of ``biapy_tpu/ops/conv3d.py::conv3d_dispatch`` /
``conv3d_folded`` for the convs of the U-Net family (stride 1, SAME,
ungrouped, undilated). Weights keep the JAX package's layout,
``kernel_size + (Cin, Cout)``. Every route is differentiable.

- A 3x3x3 conv goes to the hand-written kernel (``ops/kernels/conv3d.py``).
- A 1x1x1 conv is a ``torch.matmul`` over the channel axis.
- Any other 3D conv with an odd kz > 1 (the 5x5x5 LARGER_IO convs) takes
  the cat2d form of the JAX package's folded path: the ``zcat`` kernel
  concatenates the kz z-shifted planes into channels and ONE 2D conv with
  the ``(ky, kx, kz*Cin, Cout)`` kernel does the rest; its backward runs
  the ``zcat_bwd`` kernel. The JAX package chooses between this and the
  sum-of-taps form from timings on its own hardware; the port always takes
  cat2d.
- What is left (anisotropic (1, k, k) levels, 2D convs) is a PyTorch
  convolution, as the JAX package leaves it to XLA; float32 runs there
  without TF32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from biapy_tpu_torch.ops.kernels.conv3d import conv3d as conv3d_k3
from biapy_tpu_torch.ops.kernels.shuffle import zcat


def conv3d_cat2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(kz, ky, kx) SAME stride-1 conv, kz odd, as one 2D conv over
    z-concatenated channels (``biapy_tpu/ops/conv3d.py::conv3d_cat2d``)."""
    n, d, h, wd, c = x.shape
    kz, cout = w.shape[0], w.shape[-1]
    xc = zcat(x.contiguous().view(n * d, h, wd, c), kz, d)
    wk = torch.cat([w[dz] for dz in range(kz)], dim=2)  # (ky, kx, kz*Cin, Cout)
    return conv_same(xc, wk).view(n, d, h, wd, cout)


def conv_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv of ``(N, *spatial, Cin)`` with ``(*k, Cin, Cout)``."""
    ks = tuple(w.shape[:-2])
    if ks == (3, 3, 3):
        return conv3d_k3(x.contiguous(), w.contiguous())
    if all(k == 1 for k in ks):
        return torch.matmul(x, w.reshape(w.shape[-2], w.shape[-1]))
    if len(ks) == 3 and ks[0] > 1 and ks[0] % 2 == 1:
        return conv3d_cat2d(x, w)
    xc = x.movedim(-1, 1)
    wc = w.permute(len(ks) + 1, len(ks), *range(len(ks)))  # (k..., I, O) -> (O, I, k...)
    conv = F.conv3d if len(ks) == 3 else F.conv2d
    if all(k % 2 for k in ks):
        pad = [k // 2 for k in ks]
    else:
        # XLA's SAME at stride 1: k - 1 padding, the odd voxel after
        flat = []
        for k in reversed(ks):
            flat += [(k - 1) // 2, k - 1 - (k - 1) // 2]
        xc, pad = F.pad(xc, flat), 0
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = conv(xc, wc, padding=pad)
    return y.movedim(1, -1).contiguous()
