"""Cellpose-style flow integration on the workflow's device, and the
clustering of the landings on the host.

Counterpart of the JAX package's ``ops/flows.py``. ``follow_flows`` is its
``jax.jit`` / ``lax.fori_loop`` integration written as a loop of tensor ops
on the flows' device (no Pallas kernel there, so no hand-written kernel
here): every pixel of the grid steps along the bilinearly sampled flow,
``step / (1 + t)`` at step ``t`` when ``suppressed`` (Omnipose), and is
clipped to the volume after each step. Positions stay float32 and the JAX
package's order of operations is kept, with the fused multiply-adds that
XLA's CPU code makes of it done exactly (``_fma``), so that the result
matches the JAX package's bit for bit, on the CPU and on the card alike. ``_cluster_landings`` and
``flows_to_instances`` are copies (NumPy on the host); the host receives
the positions once, after the loop.

Reference analog: biapy/data/post_processing/gradient_tracking.py
(flow Euler integration :610, omnipose suppressed stepping :677).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once, as a fused multiply-add:
    the product is exact in float64 and the sum is rounded there; that sum
    rounds to the float32 nearest the exact one unless it lies halfway
    between two float32 values while the exact sum does not (its error, by
    TwoSum, is not 0), and there it moves one float64 ulp toward the exact
    sum first. The same IEEE float64 operations on every device, so the CPU
    and the card give the same bits, and those of XLA's CPU code, which
    contracts the JAX package's ``mul`` + ``add`` into FMAs. Elementwise
    throughout: no branch on the data, so no wait for the device."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    # the low 29 of the 52 mantissa bits that a float32 drops: half its ulp
    half = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    return torch.where(half & (err != 0), torch.nextafter(s, s + err), s).float()


def _bilinear_sample(field: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Sample a (spatial..., C) field at fractional positions (..., nd): the
    2^nd corners in the JAX package's order (axis d is bit d of the corner's
    number), indices clipped to the field, each corner's weight multiplied
    axis by axis, and the corners summed as XLA's CPU code sums them: the
    second corner's product, then the first corner's and each later one's
    fused into the sum (``_fma``)."""
    nd = pos.shape[-1]
    shape = field.shape[:nd]
    flat = field.reshape(-1, field.shape[-1])
    p0 = torch.floor(pos)
    frac = pos - p0
    p0 = p0.to(torch.int64)
    idx_of, w_of = [], []  # per axis: (bit 0, bit 1)
    for d in range(nd):
        stride = int(np.prod(shape[d + 1:], dtype=np.int64))
        idx_of.append(tuple(torch.clamp(p0[..., d] + bit, 0, shape[d] - 1) * stride
                            for bit in (0, 1)))
        w_of.append((1.0 - frac[..., d], frac[..., d]))
    # partial sums and products over the leading axes, shared by the corners
    parts = {(): (None, None)}
    for d in range(nd):
        parts = {key + (bit,): (idx_of[d][bit] if i is None else i + idx_of[d][bit],
                                w_of[d][bit] if w is None else w * w_of[d][bit])
                 for key, (i, w) in parts.items() for bit in (0, 1)}
    terms = []
    for corner in range(2 ** nd):
        idx, w = parts[tuple((corner >> d) & 1 for d in range(nd))]
        terms.append((flat[idx], w[..., None]))
    out = _fma(*terms[0], terms[1][0] * terms[1][1])
    for g, w in terms[2:]:
        out = _fma(g, w, out)
    return out


def follow_flows(flows: torch.Tensor, n_iter: int = 200, step: float = 1.0,
                 suppressed: bool = False) -> torch.Tensor:
    """Integrate every pixel along the flow field, on ``flows``' device.

    ``flows``: (spatial..., nd) float32 unit vectors pointing toward
    instance centers. Returns the final positions (spatial..., nd), float32,
    on the same device. ``suppressed`` uses Omnipose's 1/(1+t) damped
    stepping (reference: omnipose_core.py:222)."""
    if flows.dtype != torch.float32:
        raise ValueError(f"follow_flows: want float32 flows, got {flows.dtype}")
    nd = flows.shape[-1]
    spatial = tuple(flows.shape[:-1])
    dev = flows.device
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=dev)
                             for s in spatial], indexing="ij")
    pos = torch.stack(grids, dim=-1)
    hi = [float(s - 1) for s in spatial]
    step32 = torch.tensor(step, dtype=torch.float32, device=dev)
    for t in range(n_iter):
        v = _bilinear_sample(flows, pos)
        s = step32 / torch.tensor(1.0 + t, dtype=torch.float32, device=dev) \
            if suppressed else step32
        new = _fma(s.expand_as(v), v, pos)
        pos = torch.stack([torch.clamp(new[..., d], 0.0, hi[d]) for d in range(nd)], dim=-1)
    return pos


_RPAD = 20  # histogram padding, reference gradient_tracking.py:241 (rpad)


def _cluster_landings(final: np.ndarray, fg: np.ndarray,
                      expansion_gate: str = "cellpose") -> np.ndarray:
    """Cellpose's exact histogram-peak + gated-expansion clustering
    (reference: gradient_tracking.py _cluster_to_instances:200-315).

    1. Truncate convergence positions to int (Cellpose ``.astype('int32')``).
    2. Padded landing histogram over foreground pixels.
    3. Seeds = local maxima within a 5-bin window per axis with h > 10.
    4. 5 iterations of 3^nd neighbourhood growth **gated by h > 2** — the
       expansion follows the landing cloud only, so sinks of adjacent cells
       separated by a zero-density gap are NOT bridged (an earlier unmasked
       dilation under-segmented densely packed small cells).
    5. Seeds whose gated clouds CONNECT are merged by connected components.
       This is the one deliberate deviation from Cellpose's strongest-seed-
       wins overlap rule: an under-converged network lands one cell's
       pixels in several sub-sinks inside ONE diffuse connected cloud —
       per-seed ownership fragments that cell, while cloud connectivity
       keeps it whole; converged networks produce tight clouds separated
       by zero-density gaps, where both rules agree.
    6. Each fg pixel takes the label of its landing bin.
    """
    nd = final.shape[-1]
    shape = fg.shape
    hshape = tuple(s + 2 * _RPAD for s in shape)
    pflow = tuple(
        np.clip(final[..., d][fg].astype(np.int32) + _RPAD, 0, hshape[d] - 1)
        for d in range(nd))
    h = np.zeros(hshape, np.float32)
    np.add.at(h, pflow, 1)
    hmax = h.copy()
    for d in range(nd):
        hmax = ndimage.maximum_filter1d(hmax, 5, axis=d)
    seeds_mask = (h - hmax > -1e-6) & (h > 10)
    if not seeds_mask.any():
        # tiny-image fallback (a cell must land >10 px in one bin to seed;
        # oracle tests run on cells near that floor): any occupied peak bin
        peak_th = max(2.0, float(h.max()) * 0.05) if h.max() > 4 else 0.0
        seeds_mask = (h - hmax > -1e-6) & (h > peak_th)
        if not seeds_mask.any():
            return np.zeros(shape, np.int32)
    seed_idx = np.nonzero(seeds_mask)
    order = np.argsort(h[seed_idx])  # ascending: larger label = stronger seed
    lab_map = np.zeros(hshape, np.int32)
    lab_map[tuple(s[order] for s in seed_idx)] = np.arange(1, len(order) + 1)
    # Gate (PROBLEM.INSTANCE_SEG.CELLPOSE.EXPANSION_GATE):
    # 'cellpose' — Cellpose's hardcoded h > 2: the expansion follows the
    # landing cloud only, so the zero-density gap between two distinct
    # cells' sinks is never bridged (correct for converged networks, whose
    # clouds are tight). 'none' — ungated 5-step growth: an under-converged
    # flow field has MULTIPLE stable attractors inside one cell, separated
    # by zero-density gaps the gated expansion cannot cross; ungated growth
    # + the connectivity merge below reunites sinks within ~10 bins.
    if expansion_gate == "none":
        gate = np.ones(hshape, bool)
    else:
        gate = (h > 2) | seeds_mask
    for _ in range(5):
        # the largest label over each 3^nd neighbourhood (the JAX package
        # takes it over 3^nd - 1 rolls; rpad=20 > 5 growth steps keeps the
        # histogram's border 0, so the rolls' wrap and this filter's zero
        # padding agree)
        cur = ndimage.maximum_filter(lab_map, size=3, mode="constant", cval=0)
        lab_map = np.where(gate, cur, 0)
    from biapy_tpu_torch.native import connected_components

    cc, n_cc = connected_components(lab_map > 0)
    labels = np.zeros(shape, np.int32)
    labels[fg] = cc[pflow]
    return labels


def flows_to_instances(
    flows: np.ndarray,
    fg_mask: np.ndarray,
    n_iter: int = 200,
    suppressed: bool = False,
    min_size: int = 15,
    flow_error_th: float = 0.0,
    expansion_gate: str = "cellpose",
    device="cpu",
) -> np.ndarray:
    """Flow field + foreground mask -> instance labels (reference:
    gradient_tracking.py:610 create_instances_from_flows).

    Pixels integrate to their sinks on ``device`` (``follow_flows``); sinks
    are clustered on the host with Cellpose's histogram-peak + gated-
    expansion strategy and every foreground pixel takes the label of its
    landing bin.
    """
    nd = flows.shape[-1]
    final = follow_flows(torch.as_tensor(np.asarray(flows, np.float32), device=device),
                         n_iter=n_iter, suppressed=suppressed).cpu().numpy()
    fg = np.asarray(fg_mask, bool)
    if not fg.any():
        return np.zeros(fg.shape, np.int32)
    labels = _cluster_landings(final, fg, expansion_gate)
    # drop tiny fragments
    from biapy_tpu_torch.data.post_processing import relabel_sequential, remove_small_instances

    labels = remove_small_instances(labels, min_size)
    # flow-error QC (reference: regenerate flows per mask, drop high-MSE
    # masks — gradient_tracking.py _flow_error:404, Cellpose
    # metrics.flow_error, flow_threshold=0.4). The repo trains UNIT flows
    # (pre_processing.cellpose_flows), so the prediction is compared at its
    # trained scale — raw, not per-pixel re-normalized — keeping the
    # magnitude component the reference keeps (it compares dP/5, not unit
    # fields); in 3D the z term is down-weighted by 0.5 exactly as Cellpose
    # does (reference gradient_tracking.py:426,473).
    if flow_error_th > 0:
        from biapy_tpu_torch.data.pre_processing import cellpose_flows

        regen = cellpose_flows(labels, device=device)
        axis_w = np.ones((nd,), np.float32)
        if nd == 3:
            axis_w[0] = 0.5
        sq = np.sum((regen - flows) ** 2 * axis_w, axis=-1)
        # each instance inside its bounding box: the same voxels in the same
        # order as over the whole volume, so the same means
        for lab, sl in enumerate(ndimage.find_objects(labels), 1):
            if sl is None:
                continue
            m = labels[sl] == lab
            if float(np.mean(sq[sl][m])) > flow_error_th:
                labels[sl][m] = 0
    return relabel_sequential(labels)
