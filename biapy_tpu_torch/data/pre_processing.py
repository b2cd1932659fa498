"""The GT -> channel-representation compiler, channel bookkeeping and the
DATA.PREPROCESS pipeline, copied from the JAX package's
``data/pre_processing.py``: ``labels_into_channels`` and its helpers
(``_edt`` on the native distance transform, ``_contours``,
``hover_channels``, ``cellpose_flows``, ``radial_distances``,
``affinities``), ``affinity_offsets`` and ``channels_per_code`` (which the
TTA spec reads), ``create_detection_masks`` (CSV points to the dilated
point mask of the detection workflow, with its class channel), and ``resize_image``, ``apply_gaussian_blur``,
``apply_median_blur``, ``match_histogram``, ``apply_clahe``,
``detect_edges`` and ``preprocess_image``. The Omnipose channels (flows
and the distance field) come from the port's ``ops/omnipose.py``. The
EmbedSeg channels raise ``NotImplementedError`` (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to biapy_tpu_torch yet "
                               "(ROADMAP: queue 1 item 9, other workflows)")


def _edt(mask: np.ndarray) -> np.ndarray:
    """Exact EDT, float32: first-party threaded FH transform (native.edt,
    the analog of the reference's `edt` C-extension dep, pyproject.toml:28)
    with a scipy fallback if the native build is unavailable."""
    try:
        from biapy_tpu_torch import native

        return native.edt(mask)
    except Exception:
        return ndimage.distance_transform_edt(mask).astype(np.float32)


def affinity_offsets(extra: Dict, nd: int) -> List[Tuple[int, int]]:
    """Single source of truth for the 'A' block: (axis, distance) pairs in
    grouped-by-axis order (z first in 3D). Each axis list defaults to [1]
    (the reference defaults all three to [1], affinity_channel_names
    pre_processing.py:987); an explicitly-empty list emits no channel for
    that axis. Shared by the target compiler, channels_per_code and the
    TTA spec so they can never drift apart."""
    a = extra.get("A", {})
    keys = (["z_affinities"] if nd == 3 else []) + ["y_affinities", "x_affinities"]
    out: List[Tuple[int, int]] = []
    for d, key in enumerate(keys):
        dists = a.get(key, [1])
        if not dists:
            continue
        out.extend((d, int(x)) for x in dists)
    return out


def channels_per_code(code: str, extra: Dict, nd: int = 2) -> int:
    if code == "E":
        return 2 * nd + 1
    if code in ("E_offset", "E_sigma"):
        return nd
    if code == "E_seediness":
        return 1
    if code == "R":
        return int(extra.get("R", {}).get("nrays", 32))
    if code == "A":
        return len(affinity_offsets(extra, nd))
    return 1


def _binary_dilate(mask: np.ndarray, it: int) -> np.ndarray:
    return ndimage.binary_dilation(mask, iterations=it) if it > 0 else mask


def _binary_erode(mask: np.ndarray, it: int) -> np.ndarray:
    return ndimage.binary_erosion(mask, iterations=it) if it > 0 else mask


def _contours(labels: np.ndarray, thickness: int = 1) -> np.ndarray:
    """Instance contours: voxels adjacent to a different label or background."""
    fg = labels > 0
    eroded = ndimage.grey_erosion(labels, size=(3,) * labels.ndim)
    dilated = ndimage.grey_dilation(labels, size=(3,) * labels.ndim)
    border = fg & ((eroded != labels) | (dilated != labels))
    if thickness > 1:
        border = ndimage.binary_dilation(border, iterations=thickness - 1) & fg
    return border


def _per_instance(labels: np.ndarray):
    for lab in np.unique(labels):
        if lab == 0:
            continue
        yield int(lab), labels == lab


def hover_channels(labels: np.ndarray, norm: bool = True) -> np.ndarray:
    """HoVer-Net signed offsets to the instance centroid per axis
    (reference: config.py H/V/Z docs; Graham et al. 2019)."""
    nd = labels.ndim
    out = np.zeros(labels.shape + (nd,), np.float32)
    coords = np.indices(labels.shape).astype(np.float32)
    objs = ndimage.find_objects(labels)
    for lab, sl in zip(range(1, len(objs) + 1), objs):
        if sl is None:
            continue
        m = labels[sl] == lab
        for d in range(nd):
            c = coords[d][sl]
            cen = c[m].mean()
            off = (c - cen) * m
            if norm:
                mx = np.abs(off[m]).max()
                if mx > 0:
                    off = off / mx
            out[sl + (d,)][m] = off[m]
    # axis order (y, x) in 2D -> channels (H=x? reference: H horizontal, V
    # vertical). We emit (V, H) for 2D and (Z, V, H) for 3D, then the caller
    # reorders by requested code.
    return out


def _diffuse(pad: np.ndarray, center, it: int, device) -> np.ndarray:
    """``cellpose_flows``' heat diffusion in float64 on ``device``: ``it``
    times, one unit of heat added at ``center``, then the 2*nd-neighbour
    average (the two neighbours of each axis summed, the axes added in
    order, divided by 2*nd) kept inside the mask ``pad``. Additions and one
    division, each rounded as IEEE float64 on any device: the NumPy loop's
    bits."""
    import torch

    m = torch.from_numpy(pad).to(device, torch.float64)
    h = torch.zeros_like(m)
    nd = pad.ndim
    for _ in range(it):
        h[center] += 1.0
        acc = torch.zeros_like(h)
        for d in range(nd):
            acc += torch.roll(h, 1, d) + torch.roll(h, -1, d)
        h = (acc / (2 * nd)) * m
    return h.cpu().numpy()


def _shifted(a, d: int, s: int):
    """``a``'s value at p - s along axis ``d`` (s = 1 or -1), 0 past the edge."""
    out = a.new_zeros(a.shape)
    n = a.shape[d]
    if s == 1:
        out.narrow(d, 1, n - 1).copy_(a.narrow(d, 0, n - 1))
    else:
        out.narrow(d, 0, n - 1).copy_(a.narrow(d, 1, n - 1))
    return out


def _median_centres(labels: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Each instance's centre as ``cellpose_flows`` takes it, the median of
    its voxels' coordinates on each axis truncated to an integer, for all
    instances at once: (len(ids), nd). np.median's middle element, or the
    mean of the two middle ones."""
    fg = labels > 0
    lab = labels[fg].astype(np.int64)
    coords = np.nonzero(fg)
    counts = np.bincount(lab, minlength=int(labels.max()) + 1)
    starts = np.cumsum(counts) - counts
    n, s = counts[ids], starts[ids]
    out = np.empty((len(ids), labels.ndim), np.int64)
    for d, c in enumerate(coords):
        srt = c[np.lexsort((c, lab))].astype(np.float64)
        hi = srt[s + n // 2]
        lo = srt[s + (n - 1) // 2]
        out[:, d] = np.where(n % 2 == 1, hi, (lo + hi) / 2.0).astype(int)
    return out


def _flows_together(labels: np.ndarray, ids: np.ndarray, its: np.ndarray, device):
    """``cellpose_flows``' per-instance gradients of the log heat, for all
    instances at once: the diffusions over the whole volume in float64 on
    ``device`` (each voxel averages only the neighbours of its own instance;
    the others and the volume's outside count 0, as the zero ring of an
    instance's padded box does; each instance takes its own heat at its own
    centre and stops after its own number of steps; a centre outside its
    instance reads exactly 1 to that instance's neighbours, as ``_diffuse``
    leaves it: zeroed at each step's end, 1 added at the next one's start),
    then on the host ``np.log1p`` and the central differences with the
    other instances' neighbours as 0. The same operations in the same order
    as box by box, so the same bits. Returns the gradients, (*shape, nd),
    0 off the instances."""
    import torch

    dev = torch.device(device)
    nd = labels.ndim
    centres = _median_centres(labels, ids)
    inside = labels[tuple(centres.T)] == ids
    lab_t = torch.from_numpy(labels.astype(np.int64)).to(dev)
    it_of = torch.zeros(int(labels.max()) + 1, dtype=torch.int64, device=dev)
    it_of[torch.from_numpy(ids).to(dev)] = torch.from_numpy(its).to(dev)
    vox_its = it_of[lab_t]  # each voxel's instance's steps (0 off the instances)
    c_in = torch.from_numpy(centres[inside]).to(dev)
    c_its = torch.from_numpy(its[inside]).to(dev)
    m = (lab_t > 0).to(torch.float64)
    same = [(_shifted(lab_t, d, 1) == lab_t, _shifted(lab_t, d, -1) == lab_t) for d in range(nd)]
    # a centre outside its instance: its neighbours of that instance read 1
    src = [[np.zeros(labels.shape, bool) for _ in range(2)] for _ in range(nd)]
    for lab, c in zip(ids[~inside], centres[~inside]):
        for d in range(nd):
            for k, step in enumerate((1, -1)):  # the lo side reads p - e_d: p = c + e_d
                p = c.copy()
                p[d] += step
                if 0 <= p[d] < labels.shape[d] and labels[tuple(p)] == lab:
                    src[d][k][tuple(p)] = True
    src = [[torch.from_numpy(a).to(dev, torch.float64) for a in pair] for pair in src]
    h = torch.zeros(labels.shape, dtype=torch.float64, device=dev)
    for t in range(int(its.max())):
        at = tuple(c_in[c_its > t].T)
        h[at] = h[at] + 1.0
        acc = torch.zeros_like(h)
        for d in range(nd):
            (lo, hi), (s_lo, s_hi) = same[d], src[d]
            acc += (torch.where(lo, _shifted(h, d, 1), s_lo)
                    + torch.where(hi, _shifted(h, d, -1), s_hi))
        h = torch.where(vox_its > t, (acc / (2 * nd)) * m, h)
    f = torch.from_numpy(np.log1p(h.cpu().numpy())).to(dev)
    g = torch.stack([(torch.where(hi, _shifted(f, d, -1), 0.0)
                      - torch.where(lo, _shifted(f, d, 1), 0.0)) / 2.0
                     for d, (lo, hi) in enumerate(same)], dim=-1)
    return (g * m[..., None]).cpu().numpy()


def _flows_in_boxes(labels: np.ndarray, ids: np.ndarray, its: np.ndarray, device):
    """``cellpose_flows``' per-instance gradients of the log heat, instance by
    instance, each in its bounding box padded by one zero voxel
    (``_diffuse`` on ``device``), 0 off the instances."""
    nd = labels.ndim
    objs = ndimage.find_objects(labels)
    g_all = np.zeros(labels.shape + (nd,), np.float64)
    crop = tuple(slice(1, -1) for _ in range(nd))
    for lab, it in zip(ids, its):
        sl = objs[lab - 1]
        # pad the crop so diffusion has a zero boundary
        pad = np.pad(labels[sl] == lab, 1)
        center = tuple(np.median(np.argwhere(pad), axis=0).astype(int))
        h = _diffuse(pad, center, int(it), device)
        # gradient PER INSTANCE on the padded crop, like the reference's
        # per-instance kernels (_extend_centers_2d/3d) — a global gradient
        # would mix a touching neighbour's heat field exactly at the
        # instance-separating boundary, the case flows exist to split
        grads = np.gradient(np.log1p(h))
        gcrop = np.stack([gr[crop] for gr in grads], axis=-1)
        sub = pad[crop]
        tgt = g_all[sl]
        tgt[sub] = gcrop[sub]
        g_all[sl] = tgt
    return g_all


def cellpose_flows(labels: np.ndarray, n_iter: Optional[int] = None,
                   device="cpu") -> np.ndarray:
    """Cellpose heat-diffusion flows (reference: instances_to_flows:790 +
    numba _extend_centers_2d/3d:700/747; Stringer et al. 2021).

    Diffuses heat from each instance's median center within the instance
    mask (up to twice an instance's extent in steps over its box: the
    loop that sets the cost, on ``device``), then returns the normalized
    gradient of the heat potential, per axis, stacked channels-last.
    Background = 0. All instances at once (``_flows_together``) on the
    card, and on the CPU where that is less work than box by box
    (``_flows_in_boxes``); the same bits either way.
    """
    import torch

    nd = labels.ndim
    fg = labels > 0
    objs = ndimage.find_objects(labels)
    ids = np.asarray([lab for lab, sl in enumerate(objs, 1) if sl is not None], np.int64)
    if len(ids) == 0:
        return np.zeros(labels.shape + (nd,), np.float32)
    boxes = [tuple(s.stop - s.start + 2 for s in sl) for sl in objs if sl is not None]
    its = np.asarray([n_iter or 2 * max(b) for b in boxes], np.int64)
    if (torch.device(device).type != "cpu"
            or int(its.max()) * labels.size < int(sum(it * np.prod(b)
                                                      for it, b in zip(its, boxes)))):
        g_all = _flows_together(labels, ids, its, device)
    else:
        g_all = _flows_in_boxes(labels, ids, its, device)
    mag = np.sqrt(np.sum(g_all**2, axis=-1, keepdims=True))
    g = np.where(mag > 1e-8, g_all / np.maximum(mag, 1e-8), 0.0)
    return (g * fg[..., None]).astype(np.float32)


def generate_rays(nrays: int, nd: int = 2) -> np.ndarray:
    """Unit ray directions, (nrays, nd) in (y,x) / (z,y,x) axis order
    (reference: generate_rays, pre_processing.py:1859 — 2D circle, 3D
    Fibonacci sphere). Shared by the channel compiler and the NMS so training
    targets and polyhedron reconstruction agree."""
    if nd == 2:
        a = np.linspace(0, 2 * np.pi, nrays, endpoint=False)
        return np.stack([np.sin(a), np.cos(a)], axis=1).astype(np.float32)  # (dy, dx)
    i = np.arange(nrays, dtype=np.float64)
    phi = (1 + np.sqrt(5.0)) / 2.0
    z = 1 - 2 * (i + 0.5) / nrays
    r = np.sqrt(np.maximum(0.0, 1 - z * z))
    theta = 2 * np.pi * i / phi
    dirs = np.stack([z, r * np.sin(theta), r * np.cos(theta)], axis=1)  # (dz, dy, dx)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-12
    return dirs.astype(np.float32)


def radial_distances(labels: np.ndarray, nrays: int = 32) -> np.ndarray:
    """StarDist radial ray distances, 2D polygons or 3D polyhedra
    (reference: _radial_distances_2d/_3d numba kernels,
    pre_processing.py:1904,1971). For each foreground voxel, the distance
    along each ray direction to the instance boundary. Vectorized ray
    marching: all foreground voxels advance one unit step per iteration until
    they leave their instance."""
    nd = labels.ndim
    rays = generate_rays(nrays, nd)
    shape = np.asarray(labels.shape)
    coords = np.argwhere(labels > 0)  # (n, nd)
    out = np.zeros(labels.shape + (nrays,), np.float32)
    if len(coords) == 0:
        return out
    labs = labels[tuple(coords.T)]
    max_steps = int(np.ceil(np.linalg.norm(shape))) + 1
    for k in range(nrays):
        d = rays[k]
        t = np.ones(len(coords), np.float32)
        active = np.ones(len(coords), bool)
        for _ in range(max_steps):
            pos = np.round(coords[active] + d * t[active, None]).astype(np.int64)
            inside = np.all((pos >= 0) & (pos < shape), axis=1)
            same = np.zeros(len(pos), bool)
            if inside.any():
                same[inside] = labels[tuple(pos[inside].T)] == labs[active][inside]
            idx = np.nonzero(active)[0]
            t[idx[same]] += 1.0
            active[idx[~same]] = False
            if not active.any():
                break
        out[tuple(coords.T) + (k,)] = t
    return out


def affinities(labels: np.ndarray, extra: Dict) -> np.ndarray:
    """Affinity channels: 1 where the voxel and its offset neighbour share an
    instance (reference: util.py:588 seg2aff_pni)."""
    nd = labels.ndim
    offsets = affinity_offsets(extra, nd)  # (axis, distance)
    chans = []
    for axis, dist in offsets:
        shifted = np.roll(labels, -dist, axis=axis)
        valid = np.ones_like(labels, bool)
        sl = [slice(None)] * nd
        sl[axis] = slice(labels.shape[axis] - dist, None)
        valid[tuple(sl)] = False
        aff = (labels == shifted) & (labels > 0) & valid
        chans.append(aff.astype(np.float32))
    return np.stack(chans, axis=-1)


def labels_into_channels(
    instance_labels: np.ndarray,
    mode: Sequence[str] = ("F", "C"),
    channel_extra_opts: Optional[Dict] = None,
    resolution: Sequence[float] = (1, 1, 1),
) -> np.ndarray:
    """Compile an instance label map (channels-last, trailing dim 1) into the
    requested channel representation (reference: labels_into_channels:1041)."""
    extra = channel_extra_opts or {}
    labels = np.asarray(instance_labels)
    if labels.ndim in (3, 4) and labels.shape[-1] == 1:
        labels = labels[..., 0]
    labels = labels.astype(np.int32)
    nd = labels.ndim
    fg = labels > 0

    hover = None
    flows = None
    outs: List[np.ndarray] = []
    for code in mode:
        opts = extra.get(code, {})
        if code == "F":
            m = fg.copy()
            m = _binary_erode(m, int(opts.get("erosion", 0)))
            m = _binary_dilate(m, int(opts.get("dilation", 0)))
            outs.append(m.astype(np.float32)[..., None])
        elif code == "B":
            outs.append((~fg).astype(np.float32)[..., None])
        elif code == "M":
            # legacy BCM mask channel: foreground without erosion tweaks
            # (reference: config.py:383 — binary like 'F', used by Voronoi)
            outs.append(fg.astype(np.float32)[..., None])
        elif code == "C":
            outs.append(_contours(labels, int(opts.get("thickness", 1))).astype(np.float32)[..., None])
        elif code == "P":
            pts = np.zeros(labels.shape, np.float32)
            for lab, sl in zip(range(1, 10**9), ndimage.find_objects(labels)):
                if sl is None:
                    continue
                m = labels[sl] == lab
                com = ndimage.center_of_mass(m)
                target = pts[sl]
                target[tuple(int(round(c)) for c in com)] = 1.0
            if int(opts.get("dilation", 2)) > 0:
                pts = ndimage.binary_dilation(pts > 0, iterations=int(opts.get("dilation", 2))).astype(np.float32)
            outs.append(pts[..., None])
        elif code in ("H", "V", "Z"):
            if hover is None:
                hover = hover_channels(labels, norm=bool(extra.get(code, {}).get("norm", True)))
            # hover axes order: (y, x) in 2D / (z, y, x) in 3D
            axis = {"Z": 0, "V": nd - 2, "H": nd - 1}[code]
            outs.append(hover[..., axis : axis + 1])
        elif code in ("Gh", "Gv", "Gz"):
            if flows is None:
                gtype = next((str(extra.get(g, {}).get("gradient_type", ""))
                              for g in ("Gv", "Gh", "Gz")
                              if extra.get(g, {}).get("gradient_type")), "cellpose")
                if gtype == "omnipose":
                    # Omnipose flows: smoothed gradient of the eikonal
                    # distance (reference: pre_processing.py:840)
                    from biapy_tpu_torch.ops.omnipose import omnipose_flows

                    flows = omnipose_flows(labels)[1]
                else:
                    flows = cellpose_flows(labels)
            axis = {"Gz": 0, "Gv": nd - 2, "Gh": nd - 1}[code]
            outs.append(flows[..., axis : axis + 1])
        elif code == "Db":
            if str(opts.get("val_type", "norm")) == "omnipose":
                # Omnipose distance field, background -dist_bg (reference:
                # pre_processing.py:1347)
                from biapy_tpu_torch.ops.omnipose import smooth_distance

                d = smooth_distance(labels)
                d[d <= 0] = -float(opts.get("dist_bg", 5.0))
                outs.append(d[..., None])
            else:
                d = _edt(fg)
                if bool(opts.get("norm", True)):
                    for lab, m in _per_instance(labels):
                        mx = d[m].max()
                        if mx > 0:
                            d[m] = d[m] / mx
                outs.append((d * fg)[..., None])
        elif code == "Dc":
            dc = np.zeros(labels.shape, np.float32)
            coords = np.indices(labels.shape).astype(np.float32)
            for lab, sl in zip(range(1, 10**9), ndimage.find_objects(labels)):
                if sl is None:
                    continue
                m = labels[sl] == lab
                com = ndimage.center_of_mass(m)
                dist = np.zeros(m.shape, np.float32)
                for d_ in range(nd):
                    c = coords[d_][sl]
                    dist += (c - (sl[d_].start + com[d_])) ** 2
                dist = np.sqrt(dist)
                if bool(opts.get("norm", True)) and dist[m].max() > 0:
                    dist = dist / dist[m].max()
                tgt = dc[sl]
                tgt[m] = dist[m]
                dc[sl] = tgt
            outs.append(dc[..., None])
        elif code == "Dn":
            dn = np.zeros(labels.shape, np.float32)
            for lab, m in _per_instance(labels):
                others = fg & ~m
                if others.any():
                    d = _edt(~others)
                    dn[m] = d[m]
            if dn.max() > 0:
                dn = dn / dn.max()
            outs.append(dn[..., None])
        elif code == "D":
            dpos = _edt(fg)
            dneg = _edt(~fg)
            sdf = dpos - dneg
            if bool(opts.get("norm", True)):
                sdf = np.tanh(sdf / 10.0)
            outs.append(sdf[..., None])
        elif code == "T":
            touch = np.zeros(labels.shape, bool)
            dil = ndimage.grey_dilation(labels, size=(3,) * nd)
            ero = ndimage.grey_erosion(np.where(fg, labels, np.int32(10**9)), size=(3,) * nd)
            touch = fg & (dil != labels) & (dil > 0)
            near_other = fg & (ero != labels) & (ero != 10**9) & (ero > 0)
            outs.append((touch | near_other).astype(np.float32)[..., None])
        elif code == "A":
            outs.append(affinities(labels, extra))
        elif code == "R":
            outs.append(radial_distances(labels, int(extra.get("R", {}).get("nrays", 32))))
        elif code == "We":
            # U-Net border weight map — GT-only channel the loss consumes
            # (reference: PROBLEM.INSTANCE_SEG.BORDER_EXTRA_WEIGHTS,
            # pre_processing.py:1565 + util.py:199)
            from biapy_tpu_torch.utils.util import unet_weight_map

            if nd == 3:
                wm = np.stack([unet_weight_map(labels[z]) for z in range(labels.shape[0])])
            else:
                wm = unet_weight_map(labels)
            outs.append(wm.astype(np.float32)[..., None])
        elif code in ("E", "E_sigma", "E_seediness"):
            raise _not_ported("EmbedSeg channels")
        else:
            raise ValueError(f"Unknown instance channel code: {code}")
    return np.concatenate(outs, axis=-1)


def create_detection_masks(points: np.ndarray, shape: Sequence[int],
                           dilation: Sequence[int] = (2, 2),
                           classes: Optional[np.ndarray] = None,
                           n_classes: int = 2) -> np.ndarray:
    """Point coordinates -> dilated point heatmap mask (reference:
    create_detection_masks, pre_processing.py; detection workflow GT). With
    ``n_classes`` > 2 a second channel carries each point's class
    (``classes``, 1 where absent) over its dilated blob."""
    nd = len(shape)
    multiclass = n_classes > 2
    out = np.zeros(tuple(shape) + (2 if multiclass else 1,), np.float32)
    pts = np.zeros(tuple(shape), bool)
    cls_map = np.zeros(tuple(shape), np.float32) if multiclass else None
    cls = (np.asarray(classes).reshape(-1) if classes is not None
           else np.ones(len(points)))
    for i, p in enumerate(np.asarray(points, dtype=int)):
        # points outside the image are skipped, not clipped (reference
        # pre_processing.py create_detection_masks: "Skip if center point is
        # outside array boundaries")
        if any(p[d] < 0 or p[d] >= shape[d] for d in range(nd)):
            continue
        idx = tuple(int(p[d]) for d in range(nd))
        pts[idx] = True
        if cls_map is not None:
            cls_map[idx] = float(cls[i]) if i < len(cls) else 1.0
    struct = np.ones(tuple(2 * int(d) + 1 for d in (dilation if len(dilation) == nd else [dilation[0]] * nd)), bool)
    pts = ndimage.binary_dilation(pts, structure=struct)
    out[..., 0] = pts.astype(np.float32)
    if cls_map is not None:
        # dilate class ids onto each point's blob (nearest seed wins ties)
        _, idxs = ndimage.distance_transform_edt(cls_map == 0, return_indices=True)
        out[..., 1] = np.where(pts, cls_map[tuple(idxs)], 0.0)
    return out


# ---------------------------------------------------------------------------
# DATA.PREPROCESS pipeline (reference: preprocess_data, pre_processing.py:3872
# and the per-op helpers :3657-3870). Pure NumPy/SciPy host code applied once
# per image at load time (train/val/test gated by DATA.PREPROCESS.{TRAIN,VAL,
# TEST}); skimage-free implementations of CLAHE / Canny / histogram matching.
# ---------------------------------------------------------------------------


def resize_image(img: np.ndarray, output_shape: Sequence[int], order: int = 1,
                 mode: str = "reflect", cval: float = 0.0, clip: bool = True,
                 preserve_range: bool = True, anti_aliasing: bool = False) -> np.ndarray:
    """Resize spatial axes to ``output_shape`` (reference: resize_images ->
    skimage.transform.resize). Channels-last; channel axis untouched."""
    nd = len(output_shape)
    factors = [output_shape[d] / img.shape[d] for d in range(nd)] + [1.0] * (img.ndim - nd)
    out = img.astype(np.float32)
    if anti_aliasing and any(f < 1 for f in factors[:nd]):
        sig = [max(0.0, (1 / f - 1) / 2) if f < 1 else 0.0 for f in factors]
        out = ndimage.gaussian_filter(out, sig, mode=mode, cval=cval)
    sc_mode = {"reflect": "mirror", "symmetric": "reflect", "edge": "nearest",
               "wrap": "grid-wrap", "constant": "constant"}.get(mode, mode)
    out = ndimage.zoom(out, factors, order=order, mode=sc_mode, cval=cval, grid_mode=True)
    # zoom rounding can land one pixel off the target; fix exactly
    sl = tuple(slice(0, s) for s in output_shape) + (slice(None),) * (img.ndim - nd)
    pads = [(0, max(0, output_shape[d] - out.shape[d])) for d in range(nd)] + \
           [(0, 0)] * (img.ndim - nd)
    if any(p[1] for p in pads):
        out = np.pad(out, pads, mode="edge")
    out = out[sl]
    if clip:
        out = np.clip(out, img.min(), img.max())
    if not preserve_range:
        # skimage semantics: scale by the DTYPE range (img_as_float), so
        # inter-image brightness relations survive; per-image min-max would
        # contrast-stretch each image independently
        if np.issubdtype(img.dtype, np.integer):
            info = np.iinfo(img.dtype)
            out = (out - info.min) / float(info.max - info.min)
    return out.astype(img.dtype if preserve_range else np.float32)


def apply_gaussian_blur(img: np.ndarray, sigma: float = 1.0, mode: str = "nearest",
                        channel_axis=-1) -> np.ndarray:
    sig = [float(sigma)] * img.ndim
    if channel_axis is not None:
        sig[channel_axis] = 0.0
    return ndimage.gaussian_filter(img.astype(np.float32), sig, mode=mode).astype(img.dtype)


def apply_median_blur(img: np.ndarray, kernel_size: Sequence[int] = (3, 3, 1)) -> np.ndarray:
    ks = list(kernel_size) + [1] * (img.ndim - len(kernel_size))
    return ndimage.median_filter(img, size=tuple(ks)).astype(img.dtype)


def match_histogram(img: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Per-channel quantile mapping of ``img`` onto ``reference``'s intensity
    distribution (reference: _histogram_matching via skimage
    match_histograms)."""
    out = np.empty_like(img, dtype=np.float32)
    for c in range(img.shape[-1]):
        src = img[..., c].ravel()
        ref = reference[..., min(c, reference.shape[-1] - 1)].ravel()
        s_vals, s_inv, s_cnt = np.unique(src, return_inverse=True, return_counts=True)
        r_vals, r_cnt = np.unique(ref, return_counts=True)
        s_q = np.cumsum(s_cnt).astype(np.float64) / src.size
        r_q = np.cumsum(r_cnt).astype(np.float64) / ref.size
        mapped = np.interp(s_q, r_q, r_vals.astype(np.float64))
        out[..., c] = mapped[s_inv].reshape(img.shape[:-1])
    return out.astype(img.dtype)


def _clahe_2d(plane: np.ndarray, kernel_size: Tuple[int, int], clip_limit: float,
              nbins: int = 256) -> np.ndarray:
    """CLAHE on one 2D float plane in [0,1] (reference: skimage
    equalize_adapthist): per-tile clipped-histogram CDF mappings, bilinearly
    interpolated between tile centers."""
    h, w = plane.shape
    th, tw = kernel_size
    ny, nx = max(1, int(np.ceil(h / th))), max(1, int(np.ceil(w / tw)))
    ph, pw = ny * th, nx * tw
    p = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="reflect")
    q = np.clip((p * (nbins - 1)).astype(np.int32), 0, nbins - 1)
    # per-tile clipped histogram -> CDF lookup tables
    luts = np.empty((ny, nx, nbins), np.float32)
    clip_cnt = max(1.0, clip_limit * th * tw)
    for i in range(ny):
        for j in range(nx):
            tile = q[i * th:(i + 1) * th, j * tw:(j + 1) * tw]
            hist = np.bincount(tile.ravel(), minlength=nbins).astype(np.float64)
            excess = np.maximum(hist - clip_cnt, 0).sum()
            hist = np.minimum(hist, clip_cnt) + excess / nbins
            cdf = np.cumsum(hist)
            cdf = (cdf - cdf[0]) / max(cdf[-1] - cdf[0], 1e-12)
            luts[i, j] = cdf.astype(np.float32)
    # bilinear interpolation between the 4 surrounding tile mappings
    yy, xx = np.mgrid[0:ph, 0:pw]
    fy = (yy + 0.5) / th - 0.5
    fx = (xx + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(fy).astype(np.int32), 0, ny - 1)
    x0 = np.clip(np.floor(fx).astype(np.int32), 0, nx - 1)
    y1 = np.minimum(y0 + 1, ny - 1)
    x1 = np.minimum(x0 + 1, nx - 1)
    wy = np.clip(fy - y0, 0, 1)
    wx = np.clip(fx - x0, 0, 1)
    v00 = luts[y0, x0, q]
    v01 = luts[y0, x1, q]
    v10 = luts[y1, x0, q]
    v11 = luts[y1, x1, q]
    out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
           v10 * wy * (1 - wx) + v11 * wy * wx)
    return out[:h, :w]


def apply_clahe(img: np.ndarray, kernel_size=None, clip_limit: float = 0.01) -> np.ndarray:
    """CLAHE over the last two spatial axes (per z-slice for 3D stacks),
    preserving dtype/range like the reference (pre_processing.py:3838)."""
    lo, hi = float(img.min()), float(img.max())
    scale = max(hi - lo, 1e-12)
    norm = ((img.astype(np.float32) - lo) / scale)
    sp = norm.shape[:-1]
    ks = tuple(kernel_size) if kernel_size else (max(1, sp[-2] // 8), max(1, sp[-1] // 8))
    out = np.empty_like(norm)
    planes = norm.reshape((-1,) + sp[-2:] + (norm.shape[-1],))
    op = out.reshape(planes.shape)
    for i in range(planes.shape[0]):
        for c in range(planes.shape[-1]):
            op[i, ..., c] = _clahe_2d(planes[i, ..., c], ks, clip_limit)
    out = op.reshape(norm.shape)
    if np.issubdtype(img.dtype, np.integer):
        return (out * np.iinfo(img.dtype).max).astype(img.dtype)
    return out.astype(img.dtype)


def detect_edges(img: np.ndarray, low_threshold=None, high_threshold=None,
                 sigma: float = 1.0) -> np.ndarray:
    """Canny edges over the last two spatial axes (reference: detect_edges ->
    skimage.feature.canny): gaussian smooth, Sobel gradients, 4-sector
    non-max suppression, hysteresis linking. Returns the input dtype with
    edges at max-range."""
    sp = img.shape[:-1]
    planes = img.reshape((-1,) + sp[-2:] + (img.shape[-1],)).astype(np.float32)
    out = np.zeros_like(planes)
    for i, ci in [(i, ci) for i in range(planes.shape[0])
                  for ci in range(planes.shape[-1])]:
        g = planes[i, ..., ci]
        rng = max(float(g.max() - g.min()), 1e-12)
        g = (g - g.min()) / rng
        g = ndimage.gaussian_filter(g, sigma)
        gy = ndimage.sobel(g, axis=0, mode="nearest")
        gx = ndimage.sobel(g, axis=1, mode="nearest")
        mag = np.hypot(gy, gx)
        lo = low_threshold if low_threshold is not None else 0.1 * float(mag.max())
        hi = high_threshold if high_threshold is not None else 0.2 * float(mag.max())
        ang = np.mod(np.arctan2(gy, gx), np.pi)
        sector = ((ang + np.pi / 8) // (np.pi / 4)).astype(np.int32) % 4
        offs = {0: (0, 1), 1: (1, 1), 2: (1, 0), 3: (1, -1)}
        nms = np.zeros_like(mag, bool)
        for s, (dy, dx) in offs.items():
            m = sector == s
            n1 = np.roll(np.roll(mag, dy, 0), dx, 1)
            n2 = np.roll(np.roll(mag, -dy, 0), -dx, 1)
            nms |= m & (mag >= n1) & (mag >= n2)
        strong = nms & (mag >= hi)
        weak = nms & (mag >= lo)
        lab, n = ndimage.label(weak, structure=np.ones((3, 3)))
        keep = np.zeros(n + 1, bool)
        keep[np.unique(lab[strong])] = True
        keep[0] = False
        out[i, ..., ci] = keep[lab].astype(np.float32)
    out = out.reshape(img.shape)
    if np.issubdtype(img.dtype, np.integer):
        return (out * np.iinfo(img.dtype).max).astype(img.dtype)
    return out.astype(img.dtype)


def preprocess_image(pre_cfg, img: np.ndarray, is_mask: bool = False,
                     only_resize: bool = False, is_2d: bool = True,
                     _ref_cache: Dict = {}) -> np.ndarray:
    """Apply the enabled DATA.PREPROCESS ops to one channels-last image
    (reference: preprocess_data, pre_processing.py:3872). Targets get only
    the resize — nearest-neighbour when they are masks (is_y_mask there)."""
    if pre_cfg.RESIZE.ENABLE:
        img = resize_image(
            img, tuple(pre_cfg.RESIZE.OUTPUT_SHAPE),
            order=0 if is_mask else int(pre_cfg.RESIZE.ORDER),
            mode=str(pre_cfg.RESIZE.MODE), cval=float(pre_cfg.RESIZE.CVAL),
            clip=bool(pre_cfg.RESIZE.CLIP),
            preserve_range=bool(pre_cfg.RESIZE.PRESERVE_RANGE),
            anti_aliasing=bool(pre_cfg.RESIZE.ANTI_ALIASING))
    if is_mask or only_resize:
        return img
    if pre_cfg.GAUSSIAN_BLUR.ENABLE:
        img = apply_gaussian_blur(img, sigma=float(pre_cfg.GAUSSIAN_BLUR.SIGMA),
                                  mode=str(pre_cfg.GAUSSIAN_BLUR.MODE),
                                  channel_axis=(-1 if pre_cfg.GAUSSIAN_BLUR.CHANNEL_AXIS
                                                is None else pre_cfg.GAUSSIAN_BLUR.CHANNEL_AXIS))
    if pre_cfg.MEDIAN_BLUR.ENABLE:
        img = apply_median_blur(img, tuple(pre_cfg.MEDIAN_BLUR.KERNEL_SIZE))
    if pre_cfg.MATCH_HISTOGRAM.ENABLE:
        ref_path = str(pre_cfg.MATCH_HISTOGRAM.REFERENCE_PATH)
        ref = _ref_cache.get(ref_path)
        if ref is None:
            from biapy_tpu_torch.data.io import list_image_files, read_img_as_ndarray

            files = list_image_files(ref_path)
            if not files:
                raise FileNotFoundError(
                    f"DATA.PREPROCESS.MATCH_HISTOGRAM.REFERENCE_PATH '{ref_path}' has no images")
            ref = read_img_as_ndarray(files[0], is_3d=not is_2d)
            _ref_cache[ref_path] = ref
        img = match_histogram(img, ref)
    if pre_cfg.CLAHE.ENABLE:
        img = apply_clahe(img, pre_cfg.CLAHE.KERNEL_SIZE,
                          float(pre_cfg.CLAHE.CLIP_LIMIT))
    if pre_cfg.CANNY.ENABLE:
        img = detect_edges(img, pre_cfg.CANNY.LOW_THRESHOLD,
                           pre_cfg.CANNY.HIGH_THRESHOLD)
    return img
