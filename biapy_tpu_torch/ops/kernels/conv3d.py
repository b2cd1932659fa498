"""3x3x3 stride-1 SAME convolution, channels-last: the hand-written Hopper
kernel (``csrc/conv3d.cu``) and its plain PyTorch version.

Counterpart of ``biapy_tpu/ops/pallas/conv3d.py::conv3d`` (forward). Same
layouts as the JAX function: x is ``(N, D, H, W, Cin)``, w is DHWIO
``(3, 3, 3, Cin, Cout)``, the sum is kept in float32 and the output has the
input's dtype. No bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from biapy_tpu_torch.ops.kernels import build


def conv3d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 27-tap sum of shifted ``(..., Cin) @ (Cin, Cout)`` products in
    float32, cast to x's dtype at the end. Uses no cuDNN and no TF32
    (a float32 matmul runs in full float32 unless the caller changed
    ``torch.backends.cuda.matmul.allow_tf32``)."""
    n, d, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                tap = xp[:, dz:dz + d, dy:dy + h, dx:dx + wd, :] @ wf[dz, dy, dx]
                acc = tap if acc is None else acc + tap
    return acc.to(x.dtype)


def conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3x3 SAME conv: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return conv3d_plain(x, w)
    name = "conv3d"
    build.check_cuda(x, name)
    build.check_cuda(w, name)
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"{name}: want x (N,D,H,W,Cin) and w (3,3,3,Cin,Cout), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[3] != x.shape[4] or w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"{name}: weight {tuple(w.shape)} {w.dtype} does not match "
                         f"input {tuple(x.shape)} {x.dtype}")
    n, d, h, wd, cin = x.shape
    cout = w.shape[4]
    code = build.dtype_code(x)
    y = torch.empty((n, d, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        rc = build.lib().biapy_conv3d_k3(x.data_ptr(), w.data_ptr(), y.data_ptr(), code,
                                         n, d, h, wd, cin, cout, build.stream_ptr(x))
    build.check_rc(rc, name)
    build.LAUNCHES[name] += 1
    return y
