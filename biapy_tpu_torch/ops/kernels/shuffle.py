"""Folded-layout shuffles: the hand-written Hopper kernels
(``csrc/shuffle.cu``) and their plain PyTorch versions, forward only.

Counterparts of ``biapy_tpu/ops/pallas/shuffle.py::pool_max_folded`` and
``::zd2s``. Both take the z-folded ``(rows, h, w, c)`` layout (rows =
batch * depth), which is a free ``view`` of a contiguous NDHWC tensor.
"""

from __future__ import annotations

from typing import Sequence

import torch

from biapy_tpu_torch.ops.kernels import build


def pool_max_folded_plain(x: torch.Tensor, win: Sequence[int]) -> torch.Tensor:
    """Non-overlapping (wz, wy, wx) max: reshape and ``amax``."""
    wz, wy, wx = win
    rows, h, w, c = x.shape
    xr = x.reshape(rows // wz, wz, h // wy, wy, w // wx, wx, c)
    return xr.amax(dim=(1, 3, 5))


def pool_max_folded(x: torch.Tensor, win: Sequence[int]) -> torch.Tensor:
    """Max pool on folded rows: (rows, h, w, c) -> (rows/wz, h/wy, w/wx, c).
    NaN propagates as in ``jnp.max``."""
    wz, wy, wx = (int(v) for v in win)
    if x.dim() != 4:
        raise ValueError(f"pool_max_folded: want (rows, h, w, c), got {tuple(x.shape)}")
    rows, h, w, c = x.shape
    if rows % wz or h % wy or w % wx:
        raise ValueError(f"pool_max_folded: window {(wz, wy, wx)} does not divide "
                         f"{(rows, h, w)}")
    if x.device.type == "cpu":
        return pool_max_folded_plain(x, (wz, wy, wx))
    name = "pool_max_folded"
    build.check_cuda(x, name)
    code = build.dtype_code(x)
    y = torch.empty((rows // wz, h // wy, w // wx, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        rc = build.lib().biapy_pool_max_folded(x.data_ptr(), y.data_ptr(), code, rows, h, w,
                                               c, wz, wy, wx, build.stream_ptr(x))
    build.check_rc(rc, name)
    build.LAUNCHES[name] += 1
    return y


def zd2s_plain(x: torch.Tensor, sz: int) -> torch.Tensor:
    """out[r*sz + a] = x[r, :, :, a*c:(a+1)*c]: reshape and permute."""
    rows, h, w, szc = x.shape
    c = szc // sz
    return x.reshape(rows, h, w, sz, c).permute(0, 3, 1, 2, 4).reshape(rows * sz, h, w, c)


def zd2s(x: torch.Tensor, sz: int) -> torch.Tensor:
    """z depth-to-space: (rows, h, w, sz*c) -> (rows*sz, h, w, c)."""
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
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        rc = build.lib().biapy_zd2s(x.data_ptr(), y.data_ptr(), x.element_size(), rows, h, w,
                                    c, sz, build.stream_ptr(x))
    build.check_rc(rc, name)
    build.LAUNCHES[name] += 1
    return y
