"""3x3x3 stride-1 SAME convolution, channels-last: the hand-written Hopper
kernel (``csrc/conv3d.cu``), its plain PyTorch version and the
differentiable entry point.

Counterpart of ``biapy_tpu/ops/pallas/conv3d.py::conv3d`` and its
``custom_vjp``. Same layouts as the JAX function: x is ``(N, D, H, W, Cin)``,
w is DHWIO ``(3, 3, 3, Cin, Cout)``, the sum is kept in float32 and the
output has the input's dtype. No bias.

The backward, as there: dx is the same kernel on the spatially flipped,
IO-swapped weights; dw is the weight gradient of the cat2d form (one 2D
3x3 conv over z-concatenated channels), whose operand the ``zcat`` kernel
builds and whose contraction stays a library product, as the JAX package
leaves it to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from biapy_tpu_torch.ops.kernels import build
from biapy_tpu_torch.ops.kernels.shuffle import zcat_fwd


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


def conv3d_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward alone: the CUDA kernel for a CUDA tensor, the plain
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


def conv3d_wgrad(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """dw of the 3x3x3 SAME conv, ``(3, 3, 3, Cin, Cout)`` in x's dtype.

    The cat2d form (``biapy_tpu/ops/conv3d.py::conv3d_cat2d``): the three
    z-shifted planes concatenated into channels by the ``zcat`` kernel (no
    tap crosses an image seam), then the weight gradient of ONE 2D 3x3 conv
    of ``(N*D, H, W, 3*Cin)`` against ``gy`` as a library product (float32
    without TF32, bf16 with float32 accumulation), un-concatenated."""
    n, d, h, wd, cin = x.shape
    cout = gy.shape[-1]
    xc = zcat_fwd(x.reshape(n * d, h, wd, cin), 3, d)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        # NCHW-shaped views of the channels-last tensors: no copy
        dw2 = torch.nn.grad.conv2d_weight(xc.permute(0, 3, 1, 2), (cout, 3 * cin, 3, 3),
                                          gy.reshape(n * d, h, wd, cout).permute(0, 3, 1, 2),
                                          padding=1)
    del xc  # kz times the activation: freed before the caller goes on
    # (Cout, kz*Cin, ky, kx) -> (kz, ky, kx, Cin, Cout)
    return dw2.reshape(cout, 3, cin, 3, 3).permute(1, 3, 4, 2, 0).contiguous()


class Conv3dK3(torch.autograd.Function):
    """3x3x3 SAME conv with the JAX package's backward: dx through the same
    kernel, dw through ``conv3d_wgrad``; each only when asked for."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3d_fwd(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_fwd(gy, w.flip(0, 1, 2).transpose(3, 4).contiguous())
        if ctx.needs_input_grad[1]:
            dw = conv3d_wgrad(x, gy).to(w.dtype)
        return dx, dw


def conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3x3 SAME conv of contiguous ``(N, D, H, W, Cin)`` with
    ``(3, 3, 3, Cin, Cout)``, differentiable."""
    return Conv3dK3.apply(x, w)
