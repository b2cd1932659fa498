"""3x3x3 stride-1 SAME convolution, channels-last: the three hand-written
Hopper kernels (``csrc/conv3d.cu``), the plain PyTorch version and the
differentiable entry point.

Counterpart of ``biapy_tpu/ops/pallas/conv3d.py::conv3d`` and its
``custom_vjp``. Same layouts as the JAX function: x is ``(N, D, H, W, Cin)``,
w is DHWIO ``(3, 3, 3, Cin, Cout)``, the sum is kept in float32 and the
output has the input's dtype. No bias.

All three kernels replace ``biapy_tpu/ops/pallas/conv3d.py::_kernel``.
Which one a CUDA launch takes is a rule on dtype, Cin and Cout alone
(``conv3d_route``), never a ``try`` and never a setting:

- ``"stem"``: float32 or bfloat16 with ``Cin < STEM_CIN`` (the 1-channel
  input of every U-Net, 3-channel images). K = 27 * Cin is too short for a
  tensor-core tile and the output is what the card must write, so the
  function is bound by bytes: a block stages a halo brick of x and the
  weights in shared memory once, a thread computes 32 output channels at
  one (y, x) of two z planes with float32 FMAs and writes them with
  16-byte stores.
- ``"wgmma"``, the tensor-core kernel: bfloat16 at every other Cin and
  any Cout, bound by operations. bf16 tiles staged by TMA, whose
  out-of-bounds zero fill is the SAME padding and the channel tail;
  float32 accumulators in registers; a ring of stages. TMA wants x's
  channel rows a multiple of 16 bytes, so an x whose Cin 8 does not divide
  (28, 36, 84) is handed over as a channel-padded copy (``pad_channels``,
  a copy kernel of its own, counted apart: one more read and write of
  the activation, bound by those bytes). It reads the weights packed K-major and zero-padded, ``(27, Cout_p, Cin_p)``
  with both widths rounded up to 8 (``pack_weights``, repacked at every
  launch: no cache to go stale). The tile is Cout_p wide, channels are
  walked 32 (or 64) at a time with a 16-channel tail step, and only the
  real output channels are written.
- ``"tf32x3"``, the 3xTF32 kernel: float32 at ``Cin >= STEM_CIN`` and
  any Cout, on the tensor cores at float32's accuracy. One TF32 product
  keeps 11 bits of each operand (about 1e-3 of relative error), so each
  operand is split into ``hi = tf32(a)`` and ``lo = tf32(a - hi)`` and
  each product taken as ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` (``lo b_lo``,
  2^-22 of it, dropped): three TF32 products where bf16 takes one, so the
  bound is a third of the card's TF32 rate, 2.5x its float32 FMA rate.
  The bf16 kernel's TMA ring and brick with float32 tiles of both halves
  of each pair: x is split by a kernel of its own (``split_x``, counted
  apart, channel-padded to 4: one read of x and two writes, bound by
  those bytes), the weights are packed as for bf16 and split here
  (``tf32_split``, on the bit pattern exactly as the card's
  ``cvt.rna.tf32.f32`` rounds). The tensor cores add with truncation, so
  their sums are kept short: each ring step's ``a_hi b_hi`` products go
  into a fresh accumulator that is then added to a float32 total, and the
  two small terms into an accumulator of their own, whose roundings are
  2^-11 of the others' (one accumulator for all three over a ring step left
  the instance template's float32 step 4.3e-5 from float64, farther than
  the JAX package's 3.2e-5). Any other dtype takes this route and is
  refused there.

The backward, as in the JAX package: dx is the same kernel on the spatially
flipped, IO-swapped weights, whose packed form is ``w.flip(0, 1, 2)`` in
its own layout (a flip and no transpose); dw is the weight gradient of the
cat2d form (one 2D 3x3 conv over z-concatenated channels), whose operand
the ``zcat`` kernel builds and whose contraction stays a library product,
as the JAX package leaves it to XLA.
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
    ``torch.backends.cuda.matmul.allow_tf32``).

    Each tap's window of x is made contiguous before its product, so that
    the product is one ``(voxels, Cin) @ (Cin, Cout)`` matmul in either
    form. Outside autograd the window is copied into one buffer and the
    product lands in one of two more, all allocated once, and is added to
    the sum in place: the same products and sums as the functional form,
    which a caller that differentiates the plain version gets, without three
    new full-size tensors a tap, each of which the CPU's allocator maps and
    faults in anew."""
    n, d, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w.float()
    taps = [(dz, dy, dx) for dz in range(3) for dy in range(3) for dx in range(3)]
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        acc = None
        for dz, dy, dx in taps:
            tap = xp[:, dz:dz + d, dy:dy + h, dx:dx + wd, :].contiguous() @ wf[dz, dy, dx]
            acc = tap if acc is None else acc + tap
        return acc.to(x.dtype)
    acc = torch.empty((n, d, h, wd, w.shape[-1]), device=x.device)
    tap = torch.empty_like(acc)
    win = torch.empty((n, d, h, wd, x.shape[-1]), device=x.device)
    for i, (dz, dy, dx) in enumerate(taps):
        win.copy_(xp[:, dz:dz + d, dy:dy + h, dx:dx + wd, :])
        torch.matmul(win, wf[dz, dy, dx], out=tap if i else acc)
        if i:
            acc += tap
    return acc.to(x.dtype)


# Cin below this takes the stem kernel: at 1 x 128^3 -> 32 on an H100 the
# stem kernel is faster than the tensor cores (whose K then pads to 16) at
# Cin 1-3 and level with them at 4 (PERF.md, tools/torch_conv3d_f32_ab.py --cut)
STEM_CIN = 4


def conv3d_route(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The kernel a CUDA launch takes: ``"stem"`` for float32 or bfloat16
    with ``0 < cin < STEM_CIN``, ``"wgmma"`` for any other bfloat16 conv,
    else ``"tf32x3"``."""
    if dtype in (torch.float32, torch.bfloat16) and 0 < cin < STEM_CIN and cout > 0:
        return "stem"
    if dtype == torch.bfloat16 and cin > 0 and cout > 0:
        return "wgmma"
    return "tf32x3"


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (10 mantissa bits, the low 13 bits
    zero) as the card's ``cvt.rna.tf32.f32`` rounds: to nearest, ties away
    from zero. On the bit pattern, whose low 31 bits are the magnitude:
    add half of the 13 dropped bits' unit, then clear them. NaN stays NaN."""
    bits = t.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(t.isnan(), t, r)


def tf32_split(t: torch.Tensor):
    """``(hi, lo)``: ``hi = tf32_round(t)``, ``lo = tf32_round(t - hi)``
    (``t - hi`` is exact in float32), so ``hi + lo`` lies within 2^-22 of
    ``t``'s magnitude: the operands of the 3xTF32 kernel."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """DHWIO ``(3, 3, 3, Cin, Cout)`` -> ``(27, Cout_p, Cin_p)`` contiguous,
    both widths rounded up to a multiple of 8 and zero past the real ones:
    the K-major B operand of the tensor-core kernel,
    ``pack(w)[t, co, ci] == w.reshape(27, Cin, Cout)[t, ci, co]``."""
    cin, cout = w.shape[3], w.shape[4]
    p = w.reshape(27, cin, cout).transpose(1, 2)
    if cin % 8 or cout % 8:  # (a zero F.pad would copy once more)
        p = F.pad(p, (0, _round8(cin) - cin, 0, _round8(cout) - cout))
    return p.contiguous()


def pack_weights_dx(w: torch.Tensor) -> torch.Tensor:
    """The packed weights of the dx conv (w flipped in space, I and O
    swapped) without a transpose: ``pack_weights(w.flip(0, 1, 2)
    .transpose(3, 4)) == w.flip(0, 1, 2).reshape(27, Cin, Cout)``, zero-padded
    in the same way, because the rows of the flipped w are already the dx
    conv's output channels with its reduction dimension contiguous."""
    cin, cout = w.shape[3], w.shape[4]
    p = w.flip(0, 1, 2).reshape(27, cin, cout)
    if cin % 8 or cout % 8:
        p = F.pad(p, (0, _round8(cout) - cout, 0, _round8(cin) - cin))
    return p.contiguous()


def pad_channels(x: torch.Tensor) -> torch.Tensor:
    """x with its channels zero-padded to a multiple of 8 (TMA's 16-byte
    rows), or x itself where 8 divides them. A CPU x takes ``F.pad``; a
    CUDA x must be bfloat16 (the tensor-core route's dtype) and is copied
    by the ``biapy_pad_channels`` kernel, counted in
    ``build.LAUNCHES["pad_channels"]``."""
    c = x.shape[-1]
    if c % 8 == 0:
        return x
    if x.device.type == "cpu":
        return F.pad(x, (0, _round8(c) - c))
    build.check_cuda(x, "pad_channels")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"pad_channels: the kernel takes bfloat16, got {x.dtype}")
    y = torch.empty(x.shape[:-1] + (_round8(c),), dtype=x.dtype, device=x.device)
    if y.numel():
        with torch.cuda.device(x.device):
            rc = build.lib().biapy_pad_channels(x.data_ptr(), y.data_ptr(), x.numel() // c, c,
                                                build.stream_ptr(x))
        build.check_rc(rc, "pad_channels")
        build.LAUNCHES["pad_channels"] += 1
    return y


def split_x(x: torch.Tensor):
    """``(x_hi, x_lo)``: float32 x split into TF32 pairs (``tf32_split``)
    with its channels zero-padded to a multiple of 4 (TMA's 16-byte rows),
    the 3xTF32 kernel's A operands. A CPU x takes ``tf32_split`` and
    ``F.pad``; a CUDA x is split by the ``biapy_tf32_split`` kernel (one read
    of x, two writes), counted in ``build.LAUNCHES["tf32_split"]``."""
    c = x.shape[-1]
    cp = -(-c // 4) * 4
    if x.device.type == "cpu":
        return tuple(F.pad(t, (0, cp - c)) for t in tf32_split(x))
    build.check_cuda(x, "tf32_split")
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split: the kernel takes float32, got {x.dtype}")
    hi, lo = (torch.empty(x.shape[:-1] + (cp,), dtype=x.dtype, device=x.device)
              for _ in range(2))
    if hi.numel():
        with torch.cuda.device(x.device):
            rc = build.lib().biapy_tf32_split(x.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                              x.numel() // c, c, build.stream_ptr(x))
        build.check_rc(rc, "tf32_split")
        build.LAUNCHES["tf32_split"] += 1
    return hi, lo


def _check_operands(x: torch.Tensor, w: torch.Tensor, cin_axis: int, name: str) -> None:
    build.check_cuda(x, name)
    build.check_cuda(w, name)
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"{name}: want x (N,D,H,W,C) and w (3,3,3,Cin,Cout), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[cin_axis] != x.shape[4] or w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"{name}: weight {tuple(w.shape)} {w.dtype} does not match "
                         f"input {tuple(x.shape)} {x.dtype}")


def _launch(x: torch.Tensor, w: torch.Tensor, dx: bool) -> torch.Tensor:
    """One kernel launch on the route of ``(x.dtype, C of x, C of y)``, with
    the operands in the form that route's kernel reads: the forward conv of
    x with w, or (``dx``) the conv of x with w flipped and IO-swapped."""
    name = "conv3d"
    n, d, h, wd, cin = x.shape
    cout = w.shape[3] if dx else w.shape[4]
    route = conv3d_route(x.dtype, cin, cout)
    y = torch.empty((n, d, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        if route == "stem":
            wk = w.flip(0, 1, 2).transpose(3, 4).contiguous() if dx else w
            rc = build.lib().biapy_conv3d_k3_stem(x.data_ptr(), wk.data_ptr(), y.data_ptr(),
                                                  build.dtype_code(x), n, d, h, wd, cin, cout,
                                                  build.stream_ptr(x))
        else:
            want = torch.bfloat16 if route == "wgmma" else torch.float32
            if x.dtype != want:
                raise TypeError(f"{name}: the {route} kernel takes {want}, got {x.dtype}")
            wp = pack_weights_dx(w) if dx else pack_weights(w)
            # bf16: x (channel-padded) and the pack; float32: their TF32 pairs
            ops = [pad_channels(x), wp] if route == "wgmma" else [*split_x(x), *tf32_split(wp)]
            if any(t.data_ptr() % 16 for t in ops + [y]):
                raise ValueError(f"{name}: the tensor-core kernels need 16-byte aligned tensors")
            fn = getattr(build.lib(), "biapy_conv3d_k3_" + route)
            rc = fn(*[t.data_ptr() for t in ops], y.data_ptr(), n, d, h, wd, ops[0].shape[-1],
                    cout, build.stream_ptr(x))
    build.check_rc(rc, f"{name} ({route})")
    build.LAUNCHES[name] += 1
    build.CONV3D_ROUTES[route] += 1
    return y


def conv3d_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward alone: a CUDA kernel (``conv3d_route`` says which) for a
    CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return conv3d_plain(x, w)
    _check_operands(x, w, 3, "conv3d")
    return _launch(x, w, dx=False)


def conv3d_dx(gy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input gradient: the same conv of ``gy (N, D, H, W, Cout)`` with the
    spatially flipped, IO-swapped weights, ``(N, D, H, W, Cin)``."""
    if gy.device.type == "cpu":
        return conv3d_plain(gy, w.flip(0, 1, 2).transpose(3, 4).contiguous())
    _check_operands(gy, w, 4, "conv3d")
    return _launch(gy, w, dx=True)


# the float32 weight gradient on the card in groups of this many (N*D)
# planes, the groups' sums then added: with one library reduction over all
# planes the instance template's float32 step lay 5.4e-5 of scale from
# float64, with groups of 4 (and the kernel's chunk sums) 2.8e-6
_WGRAD_F32_PLANES = 4


def conv3d_wgrad(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """dw of the 3x3x3 SAME conv, ``(3, 3, 3, Cin, Cout)`` in x's dtype.

    The cat2d form (``biapy_tpu/ops/conv3d.py::conv3d_cat2d``): the three
    z-shifted planes concatenated into channels by the ``zcat`` kernel (no
    tap crosses an image seam), then the weight gradient of ONE 2D 3x3 conv
    of ``(N*D, H, W, 3*Cin)`` against ``gy`` as a library product (float32
    without TF32, bf16 with float32 accumulation), un-concatenated. Float32
    on the card takes the planes ``_WGRAD_F32_PLANES`` at a time and adds
    the groups' sums."""
    n, d, h, wd, cin = x.shape
    cout = gy.shape[-1]
    xc = zcat_fwd(x.reshape(n * d, h, wd, cin), 3, d)
    gy2 = gy.reshape(n * d, h, wd, cout)
    planes = _WGRAD_F32_PLANES if x.is_cuda and x.dtype == torch.float32 else n * d
    parts = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for i in range(0, n * d, planes):
            # NCHW-shaped views of the channels-last tensors: no copy
            parts.append(torch.nn.grad.conv2d_weight(
                xc[i:i + planes].permute(0, 3, 1, 2), (cout, 3 * cin, 3, 3),
                gy2[i:i + planes].permute(0, 3, 1, 2), padding=1))
    dw2 = parts[0] if len(parts) == 1 else torch.stack(parts).sum(0)
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
            dx = conv3d_dx(gy, w)
        if ctx.needs_input_grad[1]:
            dw = conv3d_wgrad(x, gy).to(w.dtype)
        return dx, dw


def conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3x3 SAME conv of contiguous ``(N, D, H, W, Cin)`` with
    ``(3, 3, 3, Cin, Cout)``, differentiable."""
    return Conv3dK3.apply(x, w)
