"""Omnipose: smooth (eikonal) distance field, flows, and mask reconstruction,
copied from the JAX package's ``ops/omnipose.py``. The Euler integration
runs on the caller's device through the port's ``ops/flows.follow_flows``,
and the clustering of the convergence points is the port's own DBSCAN
(``dbscan_labels``, on ``scipy.spatial.cKDTree``), which gives
scikit-learn's labels without needing scikit-learn.

Reference analog: biapy/data/omnipose_core.py (a faithful port of
omnipose.core): masks_to_flows (omni=True) for training targets and
compute_masks_omnipose (:501) for inference. This implementation keeps the
same algorithms but works on dense grids with shifted-array (np.roll-style)
vectorization instead of the reference's sparse pixel-graph indexing; the
Euler integration runs on device via ops/flows.follow_flows (suppressed
1/(1+t) stepping).

Pipeline parity:
- training: ``Db`` (omnipose) channel = eikonal distance (background
  negative), ``Gv/Gh(/Gz)`` = smoothed gradient of that distance.
- inference: hysteresis foreground on the distance, divergence-rescaled unit
  flow, niter from the mean diameter, suppressed Euler integration, DBSCAN
  clustering of the convergence points (skeleton labelling for large cells),
  flow-error QC, relabel.
"""

from __future__ import annotations

from itertools import product
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage


def _offset_groups(nd: int):
    """Neighbour offsets grouped by step length (cardinal, ordinal, ...)."""
    offs = [o for o in product((-1, 0, 1), repeat=nd) if any(o)]
    groups = {}
    for o in offs:
        f = float(np.linalg.norm(o))
        groups.setdefault(round(f, 6), []).append(o)
    return sorted(groups.items())  # [(f, [offsets])] ascending step length


def _shift(arr: np.ndarray, off) -> np.ndarray:
    """arr value at position p+off (zero outside)."""
    out = np.zeros_like(arr)
    src = tuple(slice(max(0, o), arr.shape[d] + min(0, o)) for d, o in enumerate(off))
    dst = tuple(slice(max(0, -o), arr.shape[d] + min(0, -o)) for d, o in enumerate(off))
    out[dst] = arr[src]
    return out


def _eikonal_group_solve(mins, f: float) -> np.ndarray:
    """Solve the 2-input eikonal quadratic over the two smallest per-pixel
    pair minima (the reference's _update is exactly this d==2 case,
    omnipose_core.py:137 — its groups feed only two pairs in 2D; in 3D we
    take the two SMALLEST pairs rather than the reference's first-two, the
    algorithmically consistent choice)."""
    if mins.shape[0] == 1:
        return mins[0] + f
    a = np.sort(mins, axis=0)
    a0, a1 = a[0], a[1]
    sum_a = a0 + a1
    sum_a2 = a0 * a0 + a1 * a1
    return 0.5 * (sum_a + np.sqrt(np.clip(sum_a * sum_a - 2 * (sum_a2 - f * f), 0, None)))


def smooth_distance(labels: np.ndarray, n_iter: int = 60, eps: float = 1e-3) -> np.ndarray:
    """Omnipose's smooth distance: eikonal relaxation with Dirichlet 0 at
    label boundaries (reference: _iterate, omnipose_core.py:168). Returns 0
    on background, positive inside instances."""
    fg = labels > 0
    if not fg.any():
        return np.zeros(labels.shape, np.float32)
    nd = labels.ndim
    groups = _offset_groups(nd)
    # same-label neighbour masks are label-dependent only — hoist them out
    # of the sweep loop (recomputing them doubled the cost of the hottest
    # loop in training-target generation)
    same_of = {}
    pair_offs = []
    for f, offs in groups:
        seen = set()
        pairs = []
        for o in offs:
            if tuple(-np.array(o)) in seen:
                continue
            seen.add(tuple(o))
            om = tuple(-x for x in o)
            same_of.setdefault(o, _shift(labels, o) == labels)
            same_of.setdefault(om, _shift(labels, om) == labels)
            pairs.append((o, om))
        pair_offs.append((f, pairs, offs))
    T = fg.astype(np.float32)
    prev = T
    for t in range(n_iter):
        phi = np.ones_like(T)
        for f, pairs, _ in pair_offs:
            mins = []
            for o, om in pairs:
                vp = np.where(same_of[o], _shift(T, o), 0.0)
                vm = np.where(same_of[om], _shift(T, om), 0.0)
                mins.append(np.minimum(vp, vm))
            phi *= _eikonal_group_solve(np.stack(mins), f)
        T = np.where(fg, phi ** (1.0 / len(groups)), 0.0)
        if t == 0:
            # Omnipose's one-time initial smoothing: a FIXED 1/3^nd divisor
            # over the full stencil (center contributes 0), reference
            # _iterate Tn.mean(axis=0) — a same-label-count divisor gave
            # boundary pixels systematically larger values
            acc = np.zeros_like(T)
            n_steps = 3 ** nd
            for f, _, offs in pair_offs:
                for o in offs:
                    acc += np.where(same_of.setdefault(o, _shift(labels, o) == labels),
                                    _shift(T, o), 0.0)
            T = np.where(fg, acc / n_steps, 0.0)
        if t % 10 == 9 and float(np.mean((T - prev) ** 2)) < eps:
            break
        prev = T
    return T.astype(np.float32)


def omnipose_flows(labels: np.ndarray, n_iter: int = 60) -> Tuple[np.ndarray, np.ndarray]:
    """(distance, flows) training targets (reference: omnipose_masks_to_flows,
    omnipose_core.py:222). flows shape (*spatial, nd), NOT unit-normalized —
    magnitude decays to 0 at the skeleton, which the dynamics rely on."""
    T = smooth_distance(labels, n_iter=n_iter)
    nd = labels.ndim
    groups = _offset_groups(nd)
    fg = labels > 0
    comps = np.zeros(labels.shape + (nd,), np.float32)
    n_axes = 0
    for f, offs in groups:
        seen = set()
        acc = np.zeros_like(comps)
        for o in offs:
            if tuple(-np.array(o)) in seen:
                continue
            seen.add(tuple(o))
            same_p = _shift(labels, o) == labels
            same_m = _shift(labels, tuple(-x for x in o)) == labels
            vp = np.where(same_p, _shift(T, o), 0.0)
            vm = np.where(same_m, _shift(T, tuple(-x for x in o)), 0.0)
            diff = (vp - vm) / (2 * f * f)
            for d in range(nd):
                acc[..., d] += diff * o[d]  # uphill: toward the skeleton
        comps += acc
        n_axes += 1
    mu = comps / max(1, n_axes)
    mu *= fg[..., None]
    # neighbour smoothing weighted by |mu_neigh . mu_central| (reference
    # _gradient, omnipose_core.py:205-218) — the raw stencil gradient is
    # noisier at boundaries/skeletons
    wsum = np.zeros(labels.shape, np.float32)
    out = np.zeros_like(mu)
    for f, offs in groups:
        for o in offs:
            same = _shift(labels, o) == labels
            mu_n = np.stack([_shift(mu[..., d], o) for d in range(nd)], axis=-1)
            w = np.abs(np.sum(mu_n * mu, axis=-1)) * same
            out += mu_n * w[..., None]
            wsum += w
    mu = np.where(wsum[..., None] > 0, out / np.maximum(wsum[..., None], 1e-12), mu)
    mu *= fg[..., None]
    return T, mu.astype(np.float32)


# ------------------------------------------------------------- inference
def _hysteresis(dist: np.ndarray, low: float, high: float) -> np.ndarray:
    seed = dist > high
    grow = dist > low
    lab, _ = ndimage.label(grow)
    keep = np.unique(lab[seed])
    return np.isin(lab, keep[keep > 0])


def _normalize99(x: np.ndarray, lo=0.01, hi=99.99) -> np.ndarray:
    a, b = np.percentile(x, lo), np.percentile(x, hi)
    return np.clip((x - a) / max(b - a, 1e-8), 0, 1)


def _div_rescale(flows: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Unit-normalize then rescale by normalized divergence (reference:
    _div_rescale, omnipose_core.py:308)."""
    v = flows * mask[..., None]
    mag = np.sqrt((v ** 2).sum(-1, keepdims=True))
    v = v / np.maximum(mag, 1e-8)
    div = np.zeros(mask.shape, np.float32)
    for d in range(v.shape[-1]):
        div += np.gradient(v[..., d], axis=d)
    return v * _normalize99(div)[..., None]


def _mean_diameter(dist: np.ndarray, fg: np.ndarray, nd: int) -> float:
    dt = np.abs(dist[fg])
    return float(2 * (nd + 1) * dt.mean()) if dt.size else 0.0


def compute_masks_omnipose(
    flows: np.ndarray,
    dist: np.ndarray,
    mask_threshold: float = 0.0,
    flow_threshold: float = 0.4,
    niter: Optional[int] = None,
    eps: Optional[float] = None,
    min_samples: int = 5,
    diam_threshold: float = 12.0,
    cluster: bool = False,
    device="cpu",
) -> np.ndarray:
    """Flow + distance predictions -> instance labels (reference:
    compute_masks_omnipose, omnipose_core.py:501). ``flows``: (*spatial, nd)
    channels-last; ``dist``: (*spatial) with negative background. The
    integration runs on ``device``."""
    import torch

    from biapy_tpu_torch.ops.flows import follow_flows

    nd = dist.ndim
    fg = _hysteresis(dist, mask_threshold - 1, mask_threshold)
    if not fg.any():
        return np.zeros(dist.shape, np.int32)
    dP = _div_rescale(flows.astype(np.float32), fg)
    if niter is None:
        niter = max(1, int(_mean_diameter(dist, fg, nd)))
    pos = follow_flows(torch.as_tensor(dP, device=device), n_iter=int(niter),
                       suppressed=True).cpu().numpy()

    cell_idx = np.nonzero(fg)
    pts = pos[cell_idx]  # (N, nd) convergence points
    d = _mean_diameter(dist, fg, nd)
    if eps is None:
        eps = 2 ** 0.5
    out = np.zeros(dist.shape, np.int32)
    if cluster or d <= diam_threshold:
        from scipy.spatial import cKDTree

        lab = dbscan_labels(pts, eps=eps, min_samples=min_samples)
        noise = np.where(lab == -1)[0]
        if len(noise):
            tree = cKDTree(pts)
            nd_, ni = tree.query(pts[noise], k=min(5, len(pts)))
            for row, (dists_, idxs_) in enumerate(zip(np.atleast_2d(nd_), np.atleast_2d(ni))):
                cand = lab[idxs_]
                ok = np.where(cand != -1)[0]
                if len(ok) and dists_[ok[0]] < eps:
                    lab[noise[row]] = cand[ok[0]]
        out[cell_idx] = lab + 1
    else:
        snapped = tuple(np.clip(np.rint(pts[:, d_]).astype(int), 0, dist.shape[d_] - 1)
                        for d_ in range(nd))
        skel = np.zeros(dist.shape, bool)
        skel[snapped] = True
        skel_lab, _ = ndimage.label(skel, structure=np.ones((3,) * nd))
        out[cell_idx] = skel_lab[snapped]

    if out.max() > 0 and flow_threshold and flow_threshold > 0:
        out = _remove_bad_flow_masks(out, flows, flow_threshold)
    out *= fg
    if out.max() > 0:
        _, out = np.unique(out, return_inverse=True)
        out = out.reshape(dist.shape)
    return out.astype(np.int32)


def dbscan_labels(pts: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN cluster labels of the points ``pts`` (N, nd), -1 for noise: the
    labels ``sklearn.cluster.DBSCAN(eps=eps, min_samples=min_samples)
    .fit(pts).labels_`` gives. A point's neighbourhood holds every point
    within ``eps``, itself and the boundary included (squared distances in
    float64 against ``eps * eps``, as scikit-learn's k-d tree compares
    them); a core point has at least ``min_samples``. scikit-learn grows
    the clusters from the core points in index order, each to its end
    before the next starts, and a border point stays in the first cluster
    that reaches it. So a cluster is a connected component of the core
    points, numbered by its lowest index, and a border point takes the
    lowest number among its core neighbours' clusters."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    x = np.asarray(pts, np.float64)
    n = len(x)
    labels = np.full(n, -1, np.intp)
    if n == 0:
        return labels
    # the tree's pairs within a hair more than eps, then the exact test;
    # each point is its own neighbour
    pairs = cKDTree(x).query_pairs(float(eps) * (1 + 1e-9), output_type="ndarray")
    pairs = pairs[np.sum((x[pairs[:, 0]] - x[pairs[:, 1]]) ** 2, axis=1)
                  <= float(eps) * float(eps)]
    a, b = pairs[:, 0].astype(np.intp), pairs[:, 1].astype(np.intp)
    core = 1 + np.bincount(a, minlength=n) + np.bincount(b, minlength=n) >= min_samples
    cc = core[a] & core[b]
    graph = csr_matrix((np.ones(int(cc.sum()), np.int8), (a[cc], b[cc])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    core_idx = np.nonzero(core)[0]
    if len(core_idx) == 0:
        return labels
    # clusters numbered in the order of their lowest core index (core_idx
    # ascends, so a component's first occurrence is its lowest)
    comps, first = np.unique(comp[core_idx], return_index=True)
    rank = np.empty(int(comp.max()) + 1, np.intp)
    rank[comps[np.argsort(first, kind="stable")]] = np.arange(len(comps))
    labels[core_idx] = rank[comp[core_idx]]
    # border points: the lowest cluster among their core neighbours
    ab, ba = core[b] & ~core[a], core[a] & ~core[b]
    b_rows = np.concatenate([a[ab], b[ba]])
    b_labs = np.concatenate([labels[b[ab]], labels[a[ba]]])
    order = np.lexsort((b_labs, b_rows))
    b_rows, b_labs = b_rows[order], b_labs[order]
    head = np.ones(len(b_rows), bool)
    head[1:] = b_rows[1:] != b_rows[:-1]
    labels[b_rows[head]] = b_labs[head]
    return labels


def _remove_bad_flow_masks(labels: np.ndarray, flows: np.ndarray, th: float) -> np.ndarray:
    """Drop masks whose regenerated flow disagrees with the prediction
    (reference: _remove_bad_flow_masks, omnipose_core.py:493)."""
    _, mu = omnipose_flows(labels, n_iter=30)
    # reference _flow_error (omnipose_core.py:480): per-mask MSE between the
    # regenerated flow and the prediction, summed over components, against
    # the raw threshold — the old unit-direction metric with th*4 only
    # removed masks whose mean angular error exceeded ~78 degrees
    err = ((flows - mu) ** 2).sum(-1)
    bad = []
    # each mask inside its bounding box: the same voxels in the same order as
    # over the whole image, so the same means
    for lb, sl in enumerate(ndimage.find_objects(labels), 1):
        if sl is not None and float(err[sl][labels[sl] == lb].mean()) > th:
            bad.append(lb)
    if bad:
        labels = labels.copy()
        labels[np.isin(labels, bad)] = 0
    return labels
