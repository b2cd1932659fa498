"""Folded-layout shuffles: the hand-written Hopper kernels
(``csrc/shuffle.cu``), their plain PyTorch versions and the differentiable
entry points.

Counterparts of ``biapy_tpu/ops/pallas/shuffle.py::pool_max_folded``,
``::zd2s`` and ``::zcat`` with their custom VJPs. All take the z-folded
``(rows, h, w, c)`` layout (rows = batch * depth), which is a free ``view``
of a contiguous NDHWC tensor.

``pool_max_folded``, ``zd2s`` and ``zcat`` are ``torch.autograd.Function``s:
the forward and the backward are each one kernel on a CUDA tensor and the
plain version on a CPU tensor (the plain backward, not autograd of the plain
forward: the pool's tie rule would differ). A tensor anywhere else raises.

The pool, its backward and zcat take one of three routes, a rule on
shape, itemsize and pointer alignment (``pool_route``, ``zcat_route``; no
setting, no ``try``), all in one source: ``"channels16"`` when a position's
channels are whole 16-byte vectors (``c * itemsize % 16 == 0``; each thread
one vector of channels, straight from and to device memory), ``"rows16"``
when they are not but every contiguous run of the launch lies on the
16-byte grid (runs staged in shared memory, streamed through registers by
the pool backward, or at zcat's c = 1 interleaved in registers: 16-byte
vectors at any channel count), else ``"scalar"`` (the same kernels with one
element per access). The wrapper
passes the route to the C entry, which refuses a launch its route cannot
serve, and counts it in ``build.SHUFFLE_ROUTES``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from biapy_tpu_torch.ops.kernels import build


ROUTE_CODES = {"channels16": 0, "rows16": 1, "scalar": 2}


def _launch(name: str, symbol: str, on: torch.Tensor, *args, route: Optional[str] = None) -> None:
    """One kernel launch on ``on``'s device and current stream, counted (by
    route too, when the kernel has routes)."""
    if route is not None:
        args = args + (ROUTE_CODES[route],)
    with torch.cuda.device(on.device):
        rc = getattr(build.lib(), symbol)(*args, build.stream_ptr(on))
    build.check_rc(rc, name)
    build.LAUNCHES[name] += 1
    if route is not None:
        build.SHUFFLE_ROUTES[name][route] += 1


def _on_grid(*values: int) -> bool:
    """All byte counts and addresses are multiples of 16."""
    return all(v % 16 == 0 for v in values)


def pool_route(shape: Sequence[int], itemsize: int, win: Sequence[int], *ptrs: int) -> str:
    """The route of the pool forward (pointers x, y) or its backward (x, y,
    g, dx) for ``(rows, h, w, c)``: ``"channels16"`` when c * itemsize and
    every pointer lie on the 16-byte grid, ``"rows16"`` when an input row
    (w * c elements), a pooled row ((w / wx) * c) and every pointer do, else
    ``"scalar"``."""
    _, _, w, c = shape
    if not _on_grid(*ptrs):
        return "scalar"
    if _on_grid(c * itemsize):
        return "channels16"
    row = w * c * itemsize
    return "rows16" if _on_grid(row, row // int(win[2])) else "scalar"


def zcat_route(shape: Sequence[int], itemsize: int, x_ptr: int, out_ptr: int) -> str:
    """zcat's route for ``(rows, h, w, c)``: ``"channels16"`` when
    c * itemsize and both pointers lie on the 16-byte grid, ``"rows16"``
    when a plane (h * w * c elements) and both pointers do, else
    ``"scalar"``."""
    _, h, w, c = shape
    if not _on_grid(x_ptr, out_ptr):
        return "scalar"
    if _on_grid(c * itemsize):
        return "channels16"
    return "rows16" if _on_grid(h * w * c * itemsize) else "scalar"


def _check_same(name: str, ref: torch.Tensor, *others: torch.Tensor) -> None:
    for t in others:
        build.check_cuda(t, name)
        if t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{name}: operands differ in dtype or device "
                             f"({t.dtype} on {t.device} vs {ref.dtype} on {ref.device})")


# ---------------------------------------------------------------------------
# max pool, window == stride
# ---------------------------------------------------------------------------
def pool_max_folded_plain(x: torch.Tensor, win: Sequence[int]) -> torch.Tensor:
    """Non-overlapping (wz, wy, wx) max: reshape and ``amax``."""
    wz, wy, wx = win
    rows, h, w, c = x.shape
    xr = x.reshape(rows // wz, wz, h // wy, wy, w // wx, wx, c)
    return xr.amax(dim=(1, 3, 5))


def pool_max_folded_bwd_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                              win: Sequence[int]) -> torch.Tensor:
    """``where(x == upsample(y), upsample(g), 0)``: every tied slot gets the
    full cotangent, NaN compares false, in g's dtype."""
    wz, wy, wx = win
    rows, h, w, c = x.shape
    xr = x.reshape(rows // wz, wz, h // wy, wy, w // wx, wx, c)
    yb = y[:, None, :, None, :, None, :]
    gb = g[:, None, :, None, :, None, :]
    return torch.where(xr == yb, gb, torch.zeros((), dtype=g.dtype, device=g.device)
                       ).reshape(x.shape)


def _pool_args(x: torch.Tensor, win: Sequence[int]):
    wz, wy, wx = (int(v) for v in win)
    if x.dim() != 4:
        raise ValueError(f"pool_max_folded: want (rows, h, w, c), got {tuple(x.shape)}")
    rows, h, w, _ = x.shape
    if rows % wz or h % wy or w % wx:
        raise ValueError(f"pool_max_folded: window {(wz, wy, wx)} does not divide "
                         f"{(rows, h, w)}")
    return wz, wy, wx


def pool_max_folded_fwd(x: torch.Tensor, win: Sequence[int]) -> torch.Tensor:
    """The forward alone: (rows, h, w, c) -> (rows/wz, h/wy, w/wx, c). NaN
    propagates as in ``jnp.max``."""
    wz, wy, wx = _pool_args(x, win)
    if x.device.type == "cpu":
        return pool_max_folded_plain(x, (wz, wy, wx))
    name = "pool_max_folded"
    build.check_cuda(x, name)
    code = build.dtype_code(x)
    rows, h, w, c = x.shape
    y = torch.empty((rows // wz, h // wy, w // wx, c), dtype=x.dtype, device=x.device)
    if y.numel():
        route = pool_route(x.shape, x.element_size(), (wz, wy, wx), x.data_ptr(), y.data_ptr())
        _launch(name, "biapy_pool_max_folded", x, x.data_ptr(), y.data_ptr(), code, rows, h, w,
                c, wz, wy, wx, route=route)
    return y


def pool_max_folded_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                        win: Sequence[int]) -> torch.Tensor:
    """The pool's VJP: dx of x's shape from the saved input ``x``, the
    saved output ``y`` and the cotangent ``g`` of y's shape."""
    wz, wy, wx = _pool_args(x, win)
    if y.shape != g.shape or y.shape != (x.shape[0] // wz, x.shape[1] // wy, x.shape[2] // wx,
                                         x.shape[3]):
        raise ValueError(f"pool_max_folded_bwd: x {tuple(x.shape)}, y {tuple(y.shape)}, "
                         f"g {tuple(g.shape)} do not fit window {(wz, wy, wx)}")
    if x.device.type == "cpu":
        return pool_max_folded_bwd_plain(x, y, g, (wz, wy, wx))
    dx = torch.empty_like(x)
    _launch_pool_bwd(x, y, g, dx, (wz, wy, wx))
    return dx


def _launch_pool_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, dx: torch.Tensor,
                     win: Sequence[int]) -> None:
    """The pool backward's kernel into ``dx`` (x's shape), on the route
    ``pool_route`` gives for the four pointers."""
    name = "pool_max_folded_bwd"
    build.check_cuda(x, name)
    _check_same(name, x, y, g, dx)
    if dx.shape != x.shape:
        raise ValueError(f"{name}: dx {tuple(dx.shape)} is not x's shape {tuple(x.shape)}")
    code = build.dtype_code(x)
    rows, h, w, c = x.shape
    wz, wy, wx = win
    if y.numel():
        ptrs = (x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr())
        _launch(name, "biapy_pool_max_folded_bwd", x, *ptrs, code, rows, h, w, c, wz, wy, wx,
                route=pool_route(x.shape, x.element_size(), win, *ptrs))


class PoolMaxFolded(torch.autograd.Function):
    """Max pool on folded rows; the backward sends the full cotangent to
    every slot that equals its window's maximum, as the JAX package does."""

    @staticmethod
    def forward(ctx, x, win):
        y = pool_max_folded_fwd(x, win)
        ctx.save_for_backward(x, y)
        ctx.win = tuple(int(v) for v in win)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return pool_max_folded_bwd(x, y, g.to(x.dtype).contiguous(), ctx.win), None


def pool_max_folded(x: torch.Tensor, win: Sequence[int]) -> torch.Tensor:
    """Max pool on folded rows: (rows, h, w, c) -> (rows/wz, h/wy, w/wx, c),
    differentiable."""
    return PoolMaxFolded.apply(x, tuple(win))


# ---------------------------------------------------------------------------
# z depth-to-space and its inverse
# ---------------------------------------------------------------------------
def zd2s_plain(x: torch.Tensor, sz: int) -> torch.Tensor:
    """out[r*sz + a] = x[r, :, :, a*c:(a+1)*c]: reshape and permute."""
    rows, h, w, szc = x.shape
    c = szc // sz
    return x.reshape(rows, h, w, sz, c).permute(0, 3, 1, 2, 4).reshape(rows * sz, h, w, c)


def zs2d_plain(g: torch.Tensor, sz: int) -> torch.Tensor:
    """dx[r, :, :, a*c:(a+1)*c] = g[r*sz + a]: the inverse of ``zd2s_plain``."""
    rsz, h, w, c = g.shape
    return g.reshape(rsz // sz, sz, h, w, c).permute(0, 2, 3, 1, 4).reshape(rsz // sz, h, w,
                                                                             sz * c)


def zd2s_fwd(x: torch.Tensor, sz: int) -> torch.Tensor:
    """The forward alone: (rows, h, w, sz*c) -> (rows*sz, h, w, c)."""
    sz = int(sz)
    if x.dim() != 4 or sz < 1 or x.shape[-1] % sz:
        raise ValueError(f"zd2s: want (rows, h, w, sz*c) with sz={sz}, got {tuple(x.shape)}")
    rows, h, w, szc = x.shape
    c = szc // sz
    if x.device.type == "cpu":
        return zd2s_plain(x, sz)
    name = "zd2s"
    build.check_cuda(x, name)
    y = torch.empty((rows * sz, h, w, c), dtype=x.dtype, device=x.device)
    if y.numel():
        _launch(name, "biapy_zd2s", x, x.data_ptr(), y.data_ptr(), x.element_size(), rows, h, w,
                c, sz)
    return y


def zs2d(g: torch.Tensor, sz: int) -> torch.Tensor:
    """z space-to-depth, zd2s's VJP: (rows*sz, h, w, c) -> (rows, h, w, sz*c)."""
    sz = int(sz)
    if g.dim() != 4 or sz < 1 or g.shape[0] % sz:
        raise ValueError(f"zs2d: want (rows*sz, h, w, c) with sz={sz}, got {tuple(g.shape)}")
    rsz, h, w, c = g.shape
    if g.device.type == "cpu":
        return zs2d_plain(g, sz)
    name = "zs2d"
    build.check_cuda(g, name)
    dx = torch.empty((rsz // sz, h, w, sz * c), dtype=g.dtype, device=g.device)
    if dx.numel():
        _launch(name, "biapy_zs2d", g, g.data_ptr(), dx.data_ptr(), g.element_size(), rsz // sz,
                h, w, c, sz)
    return dx


class ZD2S(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sz):
        ctx.sz = int(sz)
        return zd2s_fwd(x, sz)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return zs2d(g.contiguous(), ctx.sz), None


def zd2s(x: torch.Tensor, sz: int) -> torch.Tensor:
    """z depth-to-space: (rows, h, w, sz*c) -> (rows*sz, h, w, c),
    differentiable."""
    return ZD2S.apply(x, int(sz))


# ---------------------------------------------------------------------------
# z-window channel concatenation (the cat2d conv operand)
# ---------------------------------------------------------------------------
def _zcat_args(name: str, t: torch.Tensor, kz: int, depth: Optional[int]):
    kz = int(kz)
    if t.dim() != 4 or kz < 1 or kz % 2 == 0:
        raise ValueError(f"{name}: want (rows, h, w, c) and odd kz, got {tuple(t.shape)}, "
                         f"kz={kz}")
    rows = t.shape[0]
    depth = rows if depth is None else int(depth)
    if depth < 1 or rows % depth:
        raise ValueError(f"{name}: depth {depth} does not divide rows {rows}")
    return kz, depth


def zcat_plain(x: torch.Tensor, kz: int, depth: Optional[int] = None) -> torch.Tensor:
    """out[r, :, :, t*c:(t+1)*c] = x[r + t - kz//2], zero where that plane
    lies outside r's image (images are ``depth`` rows each): pad z, slice,
    concatenate."""
    rows, h, w, c = x.shape
    depth = rows if depth is None else depth
    hz = kz // 2
    x5 = x.reshape(rows // depth, depth, h, w, c)
    xp = torch.nn.functional.pad(x5, (0, 0, 0, 0, 0, 0, hz, hz))
    taps = [xp[:, t:t + depth] for t in range(kz)]
    return torch.cat(taps, dim=-1).reshape(rows, h, w, kz * c)


def zcat_bwd_plain(g: torch.Tensor, kz: int, depth: Optional[int] = None) -> torch.Tensor:
    """dx[r] = sum over t of g[r - t + kz//2, :, :, t*c:(t+1)*c] where that
    row lies in r's image; summed in float32 in tap order, cast to g's
    dtype."""
    rows, h, w, kzc = g.shape
    c = kzc // kz
    depth = rows if depth is None else depth
    hz = kz // 2
    g6 = g.reshape(rows // depth, depth, h, w, kz, c)
    acc = torch.zeros((rows // depth, depth, h, w, c), dtype=torch.float32, device=g.device)
    for t in range(kz):
        off = hz - t  # dx[z] takes g[z + off, tap t]
        lo, hi = max(0, -off), min(depth, depth - off)
        if lo < hi:
            acc[:, lo:hi] += g6[:, lo + off:hi + off, :, :, t].float()
    return acc.to(g.dtype).reshape(rows, h, w, c)


def zcat_fwd(x: torch.Tensor, kz: int, depth: Optional[int] = None) -> torch.Tensor:
    """The forward alone: (rows, h, w, c) -> (rows, h, w, kz*c)."""
    name = "zcat"
    kz, depth = _zcat_args(name, x, kz, depth)
    if x.device.type == "cpu":
        return zcat_plain(x, kz, depth)
    build.check_cuda(x, name)
    rows, h, w, c = x.shape
    out = torch.empty((rows, h, w, kz * c), dtype=x.dtype, device=x.device)
    if out.numel():
        route = zcat_route(x.shape, x.element_size(), x.data_ptr(), out.data_ptr())
        _launch(name, "biapy_zcat", x, x.data_ptr(), out.data_ptr(), x.element_size(), rows, h,
                w, c, kz, depth, route=route)
    return out


def zcat_bwd(g: torch.Tensor, kz: int, depth: Optional[int] = None) -> torch.Tensor:
    """zcat's VJP: (rows, h, w, kz*c) -> (rows, h, w, c)."""
    name = "zcat_bwd"
    kz, depth = _zcat_args(name, g, kz, depth)
    if g.shape[-1] % kz:
        raise ValueError(f"{name}: channels {g.shape[-1]} are not a multiple of kz={kz}")
    if g.device.type == "cpu":
        return zcat_bwd_plain(g, kz, depth)
    build.check_cuda(g, name)
    code = build.dtype_code(g)
    rows, h, w, kzc = g.shape
    dx = torch.empty((rows, h, w, kzc // kz), dtype=g.dtype, device=g.device)
    if dx.numel():
        _launch(name, "biapy_zcat_bwd", g, g.data_ptr(), dx.data_ptr(), code, rows, h, w,
                kzc // kz, kz, depth)
    return dx


class ZCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kz, depth):
        ctx.kz, ctx.depth = int(kz), depth
        return zcat_fwd(x, kz, depth)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return zcat_bwd(g.contiguous(), ctx.kz, ctx.depth), None, None


def zcat(x: torch.Tensor, kz: int, depth: Optional[int] = None) -> torch.Tensor:
    """z-window concatenation: (rows, h, w, c) -> (rows, h, w, kz*c),
    differentiable. ``depth`` (default: rows, one image) is the number of
    rows per image; no tap crosses an image seam."""
    return ZCat.apply(x, int(kz), depth)
