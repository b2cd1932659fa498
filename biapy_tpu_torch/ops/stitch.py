"""On-device sliding-window inference with spline-blend stitching.

Counterpart of ``biapy_tpu/ops/stitch.py::sliding_window_inference``. The
whole volume lives on the device; the patch grid is the JAX package's
(``data/patching.py::axis_grid``), each patch core is weighted by the same
separable spline window and accumulated in place, and the blend divisor is
the same outer product of per-axis weight sums, so no weight volume is
accumulated.

PyTorch runs eagerly, so one in-place accumulation loop over patch batches
takes the place of both XLA runners (the overlap-add fold and the
read-modify-write accumulate). It follows the fold runner's arithmetic:
the windowed core is rounded to ``out_dtype``, summed in float32, scaled by
the per-axis inverse weight sums, then cast to ``out_dtype``.

``pre_padded`` skips the halo pad for callers whose block already carries
it (the by-chunks engine's tiles): re-padding an already-extended block
makes the grid cover halo voxels with full extra patch rows, (k+1)^nd
patches where k^nd suffice.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from biapy_tpu_torch.data.patching import axis_grid, spline_window, spline_window_1d


def _axis_weight_sums(grids, core) -> list:
    """Per-axis blend divisor: ws_d[p] = sum_i w1d_d(p - start_i)."""
    out = []
    for d, g in enumerate(grids):
        w1 = spline_window_1d(core[d], g.ov_px)
        ws = np.zeros(g.length, np.float64)
        for i in range(g.n):
            s = g.start(i)
            ws[s:s + core[d]] += w1
        out.append(np.maximum(ws, 1e-18).astype(np.float32))
    return out


def _median(volume: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values for an even count."""
    flat = volume.reshape(-1).float()
    n = flat.numel()
    lo = torch.kthvalue(flat, (n + 1) // 2).values
    hi = torch.kthvalue(flat, n // 2 + 1).values
    return ((lo + hi) / 2).to(volume.dtype)


def _pad(volume: torch.Tensor, widths, mode: str, value=None) -> torch.Tensor:
    """``jnp.pad`` over the spatial axes (channels last, never padded):
    'reflect' as numpy reflects (by index gathers, any dtype and width),
    'constant' with ``value``."""
    nd = len(widths)
    if mode == "constant":
        shape = tuple(volume.shape[d] + lo + hi for d, (lo, hi) in enumerate(widths))
        out = torch.full(shape + tuple(volume.shape[nd:]), float(value), dtype=volume.dtype,
                         device=volume.device)
        out[tuple(slice(lo, lo + volume.shape[d]) for d, (lo, _) in enumerate(widths))] = volume
        return out
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            idx = np.pad(np.arange(volume.shape[d]), (lo, hi), mode=mode)
            volume = volume.index_select(d, torch.as_tensor(idx, device=volume.device))
    return volume


def sliding_window_inference(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    volume: torch.Tensor,
    patch: Sequence[int],
    overlap: Sequence[float],
    padding: Sequence[int],
    out_channels: int,
    batch_size: int = 1,
    out_dtype: torch.dtype = torch.float32,
    pad_mode: str = "reflect",
    pre_padded=False,
    quant_uint8: bool = False,
) -> torch.Tensor:
    """Stitched prediction for one channels-last volume ``(spatial..., C)``
    on its device. ``apply_fn`` maps a ``(B, *patch, C)`` batch to
    ``(B, *patch, out_channels)`` activated predictions. Returns
    ``(spatial..., out_channels)`` in ``out_dtype``, or uint8
    ``round(clip(p, 0, 1) * 255)`` with ``quant_uint8`` (half to even, as
    ``jnp.round``).

    ``pre_padded``: a bool, or one per axis. A True axis ALREADY carries
    ``padding[d]`` voxels of real halo per side: the grid covers only that
    axis's core and the result has the core's extent there."""
    nd = len(patch)
    dev = volume.device
    if pad_mode == "median":
        # DATA.TEST.MEDIAN_PADDING: borders take the volume's median
        pad_kw = dict(mode="constant", value=_median(volume).item())
    else:
        pad_kw = dict(mode=pad_mode)

    pp = (tuple(bool(v) for v in pre_padded) if isinstance(pre_padded, (tuple, list))
          else (bool(pre_padded),) * nd)
    min_core = tuple(patch[d] - 2 * padding[d] for d in range(nd))
    orig_spatial = tuple(volume.shape[d] - (2 * padding[d] if pp[d] else 0) for d in range(nd))
    if any(s <= 0 for s in orig_spatial):
        raise ValueError(f"pre_padded volume {tuple(volume.shape[:nd])} smaller than twice the "
                         f"padding {tuple(padding)}")
    # reflect-pad axes shorter than the patch core (undone on return), the
    # device analog of DATA.REFLECT_TO_COMPLETE_SHAPE; on a pre_padded axis
    # the pad extends OUTSIDE the real halo, which shifts inward with the core
    deficits = [max(0, min_core[d] - orig_spatial[d]) for d in range(nd)]
    if any(deficits):
        volume = _pad(volume, [(d // 2, d - d // 2) for d in deficits], **pad_kw)
    spatial = tuple(volume.shape[d] - (2 * padding[d] if pp[d] else 0) for d in range(nd))
    pad_width = [(0, 0) if pp[d] else (padding[d], padding[d]) for d in range(nd)]
    vol_p = volume
    if any(w != (0, 0) for w in pad_width):
        vol_p = _pad(volume, pad_width, **pad_kw)

    grids = [axis_grid(spatial[d], patch[d], overlap[d], padding[d]) for d in range(nd)]
    axes_starts = [np.array([g.start(i) for i in range(g.n)], np.int64) for g in grids]
    mesh = np.meshgrid(*axes_starts, indexing="ij")
    starts = np.stack([m.reshape(-1) for m in mesh], axis=-1)
    n = len(starts)
    # pad the patch list to a batch multiple; duplicates weigh zero, so an
    # overlap band shared with a neighbour is not over-weighted
    n_pad = (-n) % batch_size
    valid = np.ones(n + n_pad, np.float32)
    if n_pad:
        starts = np.concatenate([starts, np.repeat(starts[-1:], n_pad, axis=0)])
        valid[n:] = 0.0
    valid_t = torch.as_tensor(valid, device=dev)

    core = tuple(patch[d] - 2 * padding[d] for d in range(nd))
    ov_px = tuple(g.ov_px for g in grids)
    window_np = spline_window(core, ov_px)  # (*core, 1)
    flat_window = bool(np.all(window_np == 1.0))
    window = torch.as_tensor(window_np, dtype=torch.float32, device=dev)
    core_sl = tuple(slice(padding[d], patch[d] - padding[d]) for d in range(nd))
    wsums = _axis_weight_sums(grids, core)
    flat_weights = all(np.allclose(w, 1.0) for w in wsums)

    acc = torch.zeros(spatial + (out_channels,), dtype=torch.float32, device=dev)
    for b0 in range(0, n + n_pad, batch_size):
        batch_starts = starts[b0:b0 + batch_size]
        x = torch.stack([vol_p[tuple(slice(int(s[d]), int(s[d]) + patch[d])
                                     for d in range(nd))] for s in batch_starts])
        y = apply_fn(x).float()
        y_core = y[(slice(None),) + core_sl]
        if not flat_window:
            y_core = y_core * window
        vb = valid_t[b0:b0 + batch_size].reshape((-1,) + (1,) * (nd + 1))
        y_core = (y_core * vb).to(out_dtype).float()
        for i, s in enumerate(batch_starts):
            dst = tuple(slice(int(s[d]), int(s[d]) + core[d]) for d in range(nd))
            acc[dst] += y_core[i]
    out = acc
    if not flat_weights:
        for d in range(nd):
            shape = [1] * (nd + 1)
            shape[d] = spatial[d]
            out = out * torch.as_tensor(1.0 / wsums[d], device=dev).reshape(shape)
    out = out.to(out_dtype)
    if any(deficits):
        out = out[tuple(slice(d // 2, d // 2 + s) for d, s in zip(deficits, orig_spatial))]
    if quant_uint8:
        # TEST.OUTPUT_QUANT_UINT8: probabilities drain as round(p*255) uint8
        out = torch.round(torch.clamp(out.float(), 0.0, 1.0) * 255.0).to(torch.uint8)
    return out
