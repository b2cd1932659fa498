"""StarDist ray-polygon NMS and rasterization, copied from the JAX package's
``data/polygon_nms.py`` (NumPy/SciPy on the host).

Reference analog: biapy/data/post_processing/polygon_nms.py
(non_maximum_suppression + polygon/polyhedron rasterization :395).

2D star-convex polygons: candidate centers are probability peaks; greedy NMS
accepts candidates in descending probability order, rejecting those whose
polygon overlaps an already-accepted polygon above ``iou_threshold``
(overlap computed on the rasterized grid — exact for grid polygons).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _rasterize_polygon(center: np.ndarray, dists: np.ndarray, shape) -> np.ndarray:
    """Boolean mask of the star-convex polygon given per-ray distances."""
    n = len(dists)
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ys = center[0] + dists * np.sin(angles)
    xs = center[1] + dists * np.cos(angles)
    # bounding box
    y0 = max(0, int(np.floor(ys.min())))
    y1 = min(shape[0], int(np.ceil(ys.max())) + 1)
    x0 = max(0, int(np.floor(xs.min())))
    x1 = min(shape[1], int(np.ceil(xs.max())) + 1)
    if y1 <= y0 or x1 <= x0:
        return np.zeros(shape, bool)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dy = yy - center[0]
    dx = xx - center[1]
    ang = np.arctan2(dy, dx) % (2 * np.pi)
    r = np.sqrt(dy**2 + dx**2)
    # interpolate the boundary distance at each pixel's angle
    k = ang / (2 * np.pi / n)
    k0 = np.floor(k).astype(int) % n
    k1 = (k0 + 1) % n
    frac = k - np.floor(k)
    bound = dists[k0] * (1 - frac) + dists[k1] * frac
    mask = np.zeros(shape, bool)
    mask[y0:y1, x0:x1] = r <= bound
    return mask


def stardist_nms_2d(
    prob: np.ndarray,
    rays: np.ndarray,
    prob_threshold: float = 0.5,
    iou_threshold: float = 0.4,
    max_candidates: int = 1000,
    grid_step: int = 2,
) -> np.ndarray:
    """Probability + ray-distance maps -> instance labels.

    ``prob``: (H, W); ``rays``: (H, W, nrays). Candidates are sampled on a
    ``grid_step`` lattice (StarDist's grid subsampling), sorted by
    probability, greedily accepted under the pairwise-IoU constraint, and
    rasterized in acceptance order (earlier = higher probability wins pixel
    ties).
    """
    from scipy import ndimage

    h, w = prob.shape
    # candidates are LOCAL MAXIMA of the probability map (like the
    # reference's maximum_filter peak picking) — taking every above-
    # threshold pixel let bright instances consume the candidate cap with
    # duplicates while dim instances got no candidate at all
    sub = prob[::grid_step, ::grid_step]
    peaks = (sub == ndimage.maximum_filter(sub, size=3)) & (sub > prob_threshold)
    cand = np.argwhere(peaks) * grid_step
    if len(cand) == 0:
        return np.zeros((h, w), np.int32)
    scores = prob[cand[:, 0], cand[:, 1]]
    order = np.argsort(-scores)
    if max_candidates and len(order) > max_candidates:
        print(f"WARNING: stardist NMS capped {len(order)} peak candidates "
              f"at {max_candidates}")
        order = order[:max_candidates]
    cand = cand[order]

    labels = np.zeros((h, w), np.int32)
    accepted: List[tuple] = []  # (local bool mask, (y0, x0)) — bbox-local
    next_id = 0
    for c in cand:
        d = rays[c[0], c[1]]
        m = _rasterize_polygon(c.astype(np.float64), np.maximum(d, 1.0), (h, w))
        area = int(m.sum())
        if area < 4:
            continue
        ys, xs = np.nonzero(m)
        y0, y1 = int(ys.min()), int(ys.max()) + 1
        x0, x1 = int(xs.min()), int(xs.max()) + 1
        local = m[y0:y1, x0:x1]
        ok = True
        for am, (ay0, ax0) in accepted:
            iou = _bbox_iou_masks(local, (y0, x0), am, (ay0, ax0))
            if iou > iou_threshold:
                ok = False
                break
        if not ok:
            continue
        next_id += 1
        labels[m & (labels == 0)] = next_id
        accepted.append((local, (y0, x0)))
    return labels


# ------------------------------------------------------------------ 3D
def _rasterize_polyhedron(center: np.ndarray, dists: np.ndarray,
                          ray_dirs: np.ndarray, shape: Tuple[int, int, int],
                          pad: int = 2):
    """Voxelize the convex hull of the polyhedron vertices
    (reference: _rasterize_3d_convex, polygon_nms.py:172). Returns
    (local bool mask, bbox starts) or None for degenerate candidates."""
    from scipy.spatial import Delaunay, QhullError

    verts = center[None, :] + dists[:, None] * ray_dirs  # (R, 3) in (z,y,x)
    lo = np.maximum(0, np.floor(verts.min(0)).astype(int) - pad)
    hi = np.minimum(shape, np.ceil(verts.max(0)).astype(int) + pad + 1)
    if np.any(hi <= lo):
        return None
    try:
        tri = Delaunay(verts)
    except QhullError:
        return None
    gz, gy, gx = np.mgrid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    pts = np.stack([gz.ravel(), gy.ravel(), gx.ravel()], axis=1)
    inside = tri.find_simplex(pts) >= 0
    return inside.reshape(tuple(hi - lo)), lo


def _bbox_iou_masks(ma, la, mb, lb) -> float:
    """IoU of two bbox-local boolean masks given their bbox starts."""
    ha = np.asarray(ma.shape) + la
    hb = np.asarray(mb.shape) + lb
    lo = np.maximum(la, lb)
    hi = np.minimum(ha, hb)
    if np.any(hi <= lo):
        return 0.0
    sa = tuple(slice(int(a), int(b)) for a, b in zip(lo - la, hi - la))
    sb = tuple(slice(int(a), int(b)) for a, b in zip(lo - lb, hi - lb))
    inter = int((ma[sa] & mb[sb]).sum())
    if inter == 0:
        return 0.0
    return inter / (int(ma.sum()) + int(mb.sum()) - inter)


def stardist_nms_3d(
    prob: np.ndarray,
    rays: np.ndarray,
    prob_threshold: float = 0.5,
    iou_threshold: float = 0.3,
    max_candidates: int = 2000,
    grid_step: int = 2,
) -> np.ndarray:
    """StarDist3D: probability + per-voxel ray distances -> instance labels
    via greedy polyhedron IoU-NMS (reference:
    stardist_instances_from_prediction, polygon_nms.py:398; rasterization
    :172). ``prob``: (Z,Y,X); ``rays``: (Z,Y,X,nrays). Ray directions come
    from the same Fibonacci sphere used by the channel compiler
    (pre_processing.generate_rays), so reconstruction matches training."""
    from biapy_tpu_torch.data.pre_processing import generate_rays

    shape = prob.shape
    ray_dirs = generate_rays(rays.shape[-1], 3).astype(np.float64)
    g = max(1, int(grid_step))
    from scipy import ndimage as _ndi

    # local-maxima peaks, like 2D (every above-threshold voxel exhausted the
    # candidate cap on duplicates of bright instances)
    sub = prob[::g, ::g, ::g]
    peaks = (sub == _ndi.maximum_filter(sub, size=3)) & (sub > prob_threshold)
    cand = np.argwhere(peaks) * g
    if len(cand) == 0:
        return np.zeros(shape, np.int32)
    scores = prob[tuple(cand.T)]
    order = np.argsort(-scores)
    if max_candidates and len(order) > max_candidates:
        print(f"WARNING: stardist NMS capped {len(order)} peak candidates "
              f"at {max_candidates}")
        order = order[:max_candidates]
    cand = cand[order]

    labels = np.zeros(shape, np.int32)
    accepted: List[Tuple[np.ndarray, np.ndarray]] = []  # (local mask, bbox lo)
    next_id = 0
    for c in cand:
        d = np.maximum(rays[tuple(c)].astype(np.float64), 1.0)
        r = _rasterize_polyhedron(c.astype(np.float64), d, ray_dirs, shape)
        if r is None:
            continue
        m, lo = r
        if int(m.sum()) < 8:
            continue
        if any(_bbox_iou_masks(m, lo, am, alo) > iou_threshold for am, alo in accepted):
            continue
        next_id += 1
        sl = tuple(slice(int(a), int(a) + s) for a, s in zip(lo, m.shape))
        region = labels[sl]
        region[m & (region == 0)] = next_id
        accepted.append((m, lo))
    return labels
