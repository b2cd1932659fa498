"""Instance post-processing of predictions, copied from the JAX package's
``data/post_processing.py``: Otsu's threshold, ``watershed_by_channels``
(marker-controlled watershed over the channel maps), small-instance
removal, sequential relabelling, ``voronoi_on_mask``,
``apply_median_filter`` (``TEST.POST_PROCESSING.MEDIAN_FILTER``), instance
properties (measure, CSV, filter), ``apply_label_refinement`` and
``repair_large_blobs``, and the point helpers of the detection and synapse
workflows: ``peak_local_max`` and ``blob_log``, ``remove_close_points``
(and its ``_by_mask`` variant) on one greedy suppression, and
``detection_watershed`` (instances grown from points, with the ring-shaped
"donut" cells' extra seed dilation). The watershed, connected components
and hole filling are the native host ops (``biapy_tpu_torch/native``);
everything else is NumPy/SciPy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy import ndimage

from biapy_tpu_torch.native import connected_components, fill_holes, watershed


def _otsu(x: np.ndarray) -> float:
    """Otsu threshold on float data (reference uses skimage's
    threshold_otsu for its automatic seed thresholds)."""
    hist, edges = np.histogram(x.reshape(-1), bins=256)
    centers = (edges[:-1] + edges[1:]) / 2
    w = hist.astype(np.float64)
    total = w.sum()
    if total == 0:
        return 0.5
    sum_all = (w * centers).sum()
    w_bg = np.cumsum(w)
    sum_bg = np.cumsum(w * centers)
    w_fg = total - w_bg
    valid = (w_bg > 0) & (w_fg > 0)
    mean_bg = np.where(valid, sum_bg / np.maximum(w_bg, 1e-12), 0)
    mean_fg = np.where(valid, (sum_all - sum_bg) / np.maximum(w_fg, 1e-12), 0)
    between = w_bg * w_fg * (mean_bg - mean_fg) ** 2
    return float(centers[int(np.argmax(between))])


def watershed_by_channels(
    data: np.ndarray,
    channel_codes: Sequence[str],
    seed_channels: Optional[Sequence[str]] = None,
    seed_channel_ths: Optional[Sequence[float]] = None,
    growth_mask_channels: Optional[Sequence[str]] = None,
    growth_mask_channel_ths: Optional[Sequence[float]] = None,
    topo_surface_channel: str = "",
    seed_morph_sequence: Sequence[str] = (),
    seed_morph_radius: Sequence[int] = (),
    erode_and_dilate_growth_mask: bool = False,
    fore_erosion_radius: int = 5,
    fore_dilation_radius: int = 5,
    remove_before: bool = False,
    thres_small_before: int = 10,
) -> np.ndarray:
    """Marker-controlled watershed over predicted channels (reference:
    watershed_by_channels, post_processing.py:121).

    ``data``: channels-last predictions; ``channel_codes``: the semantic code
    of each channel (e.g. ["F","C"]). Seeds = AND of thresholded seed
    channels (contour channels contribute inverted, "under threshold");
    growth mask = thresholded foreground; topography = -distance channel if
    present else contour probability else -EDT of the mask.
    """

    def chan(code: str) -> Optional[np.ndarray]:
        off = 0
        for c, n in zip(channel_codes, [1] * len(channel_codes)):
            if c == code:
                return data[..., off]
            off += 1
        return None

    seed_channels = list(seed_channels) if seed_channels else []
    seed_channel_ths = list(seed_channel_ths) if seed_channel_ths else []
    growth_mask_channels = list(growth_mask_channels) if growth_mask_channels else []
    growth_mask_channel_ths = list(growth_mask_channel_ths) if growth_mask_channel_ths else []

    if all(c == "A" for c in channel_codes):
        # Affinities-only recipe (reference: post_processing.py:273-292):
        # first three affinities, min over them to enhance borders; seeds =
        # min-affinity > th (auto = Otsu), growth = min-affinity > th/2,
        # topography = -min-affinity.
        fp = np.min(data[..., :3], axis=-1) if data.shape[-1] >= 3 \
            else np.min(data, axis=-1)
        th = (float(seed_channel_ths[0])
              if seed_channel_ths and seed_channel_ths[0] not in ("auto", -1, None)
              # reference post_processing.py:275-281 slices to the first three
              # affinities (data = data[..., [0,1,2]]) before Otsu — match that
              # slice so >3 configured affinities don't skew the auto threshold
              else _otsu(data[..., :3] if data.shape[-1] >= 3 else data))
        seeds_mask = fp > th
        for op, r in zip(seed_morph_sequence, seed_morph_radius):
            it = max(1, int(r))
            if op == "erode":
                seeds_mask = ndimage.binary_erosion(seeds_mask, iterations=it)
            elif op == "dilate":
                seeds_mask = ndimage.binary_dilation(seeds_mask, iterations=it)
        gth = (float(growth_mask_channel_ths[0])
               if growth_mask_channel_ths
               and growth_mask_channel_ths[0] not in ("auto", -1, None)
               else th / 2.0)
        growth = fp > gth
        seeds_mask &= growth
        markers, n = connected_components(seeds_mask)
        if remove_before and thres_small_before > 0 and n > 0:
            sizes = np.bincount(markers.reshape(-1))
            small = np.nonzero(sizes < thres_small_before)[0]
            if len(small):
                markers[np.isin(markers, small)] = 0
        return watershed(-fp, markers, growth)

    # default seed recipe (reference auto mode): F over th AND C under th
    if not seed_channels:
        seed_channels = [c for c in ("F", "P", "Db", "D") if chan(c) is not None][:1] or ["F"]
        if chan("C") is not None:
            seed_channels.append("C")
        seed_channel_ths = ["auto"] * len(seed_channels)
    if not growth_mask_channels:
        # a background-only representation grows inside 1-B (reference picks
        # the same complement, instance_seg.py:1216)
        growth_mask_channels = ["F"] if (chan("F") is not None
                                         or chan("B") is None) else ["1-B"]
        growth_mask_channel_ths = ["auto"]
    # a short threshold/radius list silently zip-truncated its channel list;
    # pad with the last entry (or 'auto') instead
    seed_channel_ths += ["auto"] * (len(seed_channels) - len(seed_channel_ths))
    growth_mask_channel_ths += ["auto"] * (len(growth_mask_channels)
                                           - len(growth_mask_channel_ths))
    if seed_morph_sequence and len(seed_morph_radius) < len(seed_morph_sequence):
        last = seed_morph_radius[-1] if seed_morph_radius else 2
        seed_morph_radius = list(seed_morph_radius) + \
            [last] * (len(seed_morph_sequence) - len(seed_morph_radius))

    seeds_mask = np.ones(data.shape[:-1], bool)
    for code, th in zip(seed_channels, seed_channel_ths):
        c = chan(code)
        if c is None:
            continue
        t = _otsu(c) if (th in ("auto", -1, None)) else float(th)
        if code == "C":  # contours suppress seeds
            seeds_mask &= c < t
        else:
            seeds_mask &= c > t

    # seed morphology (reference: SEED_MORPH_SEQUENCE)
    for op, r in zip(seed_morph_sequence, seed_morph_radius):
        it = max(1, int(r))
        if op == "erode":
            seeds_mask = ndimage.binary_erosion(seeds_mask, iterations=it)
        elif op == "dilate":
            seeds_mask = ndimage.binary_dilation(seeds_mask, iterations=it)

    growth = np.ones(data.shape[:-1], bool)
    for code, th in zip(growth_mask_channels, growth_mask_channel_ths):
        c = chan(code)
        if code == "1-B" and chan("B") is not None:
            c = 1.0 - chan("B")
        if c is None:
            continue
        t = _otsu(c) if (th in ("auto", -1, None)) else float(th)
        growth &= c > t
    if erode_and_dilate_growth_mask:
        growth = ndimage.binary_erosion(growth, iterations=max(1, fore_erosion_radius))
        growth = ndimage.binary_dilation(growth, iterations=max(1, fore_dilation_radius))
    seeds_mask &= growth

    markers, n = connected_components(seeds_mask)
    if remove_before and thres_small_before > 0 and n > 0:
        sizes = np.bincount(markers.reshape(-1))
        small = np.nonzero(sizes < thres_small_before)[0]
        if len(small):
            markers[np.isin(markers, small)] = 0

    # topography: an explicit TOPOGRAPHIC_SURFACE_CHANNEL wins (distance
    # channels flood inverted, probability channels as-is); else prefer a
    # distance channel (invert), else the contour map, else -EDT of the mask
    topo = None
    if topo_surface_channel:
        c = chan(str(topo_surface_channel))
        if c is not None:
            inv = str(topo_surface_channel) in ("Db", "D", "Dc", "Dn", "F", "P")
            topo = (-c if inv else c).astype(np.float32)
        else:
            print(f"WARNING: TOPOGRAPHIC_SURFACE_CHANNEL "
                  f"'{topo_surface_channel}' is not among the predicted "
                  f"channels {list(channel_codes)}; falling back to the "
                  "automatic surface")
    if topo is None:
        dist = chan("Db") if chan("Db") is not None else chan("D")
        if dist is not None:
            topo = -dist.astype(np.float32)
        elif chan("C") is not None:
            topo = chan("C").astype(np.float32)
        else:
            from biapy_tpu_torch.data.pre_processing import _edt
            topo = -_edt(growth)

    return watershed(topo, markers, growth)


def remove_small_instances(labels: np.ndarray, min_size: int) -> np.ndarray:
    if min_size <= 0:
        return labels
    sizes = np.bincount(labels.reshape(-1))
    small = np.nonzero(sizes < min_size)[0]
    out = labels.copy()
    out[np.isin(out, small) & (out > 0)] = 0
    return out


def relabel_sequential(labels: np.ndarray) -> np.ndarray:
    uniq = np.unique(labels)
    uniq = uniq[uniq > 0]
    remap = np.zeros(int(labels.max()) + 1, labels.dtype)
    remap[uniq] = np.arange(1, len(uniq) + 1, dtype=labels.dtype)
    return remap[labels]


def peak_local_max(img: np.ndarray, min_distance: int = 1, threshold_abs: float = 0.0,
                   exclude_border: bool = False,
                   threshold_rel: Optional[float] = None) -> np.ndarray:
    """Local maxima coordinates (reference uses skimage peak_local_max in the
    detection workflow). Returns (n, ndim) coords sorted by peak value desc.
    ``threshold_rel`` overrides ``threshold_abs`` as a fraction of the image
    maximum (skimage semantics)."""
    if threshold_rel is not None:
        threshold_abs = float(threshold_rel) * float(img.max())
    size = 2 * min_distance + 1
    maxf = ndimage.maximum_filter(img, size=size, mode="constant", cval=-np.inf)
    peaks = (img == maxf) & (img > threshold_abs)
    if exclude_border and min_distance > 0:
        for d in range(img.ndim):
            sl = [slice(None)] * img.ndim
            sl[d] = slice(0, min_distance)
            peaks[tuple(sl)] = False
            sl[d] = slice(-min_distance, None)
            peaks[tuple(sl)] = False
    coords = np.argwhere(peaks)
    if len(coords) == 0:
        return coords
    vals = img[tuple(coords.T)]
    order = np.argsort(-vals)
    coords = coords[order]
    # greedy min-distance suppression, like peak_local_max's behavior
    if min_distance > 1 and len(coords) > 1:
        kept = _greedy_suppress(coords.astype(np.float32), float(min_distance))
        coords = coords[kept]
    return coords


def blob_log(img: np.ndarray, min_sigma: float = 5, max_sigma: float = 10,
             num_sigma: int = 2, threshold: Optional[float] = 0.1,
             threshold_rel: Optional[float] = None,
             exclude_border: bool = False) -> np.ndarray:
    """Laplacian-of-Gaussian blob detection (reference uses skimage blob_log,
    e.g. detection point creation and synapse extraction). Returns
    ``(n, ndim + 1)`` rows ``(coords..., sigma)`` like skimage."""
    img = img.astype(np.float32)
    sigmas = np.linspace(min_sigma, max_sigma, max(1, int(num_sigma)))
    # scale-normalized negative LoG stack: blobs are maxima
    stack = np.stack([-(s ** 2) * ndimage.gaussian_laplace(img, s) for s in sigmas])
    if threshold_rel is not None:
        threshold = float(threshold_rel) * float(stack.max())
    maxf = ndimage.maximum_filter(stack, size=3, mode="constant", cval=-np.inf)
    peaks = (stack == maxf) & (stack > (threshold if threshold is not None else 0.0))
    if exclude_border:
        b = int(np.ceil(max_sigma))
        for d in range(1, peaks.ndim):
            sl = [slice(None)] * peaks.ndim
            sl[d] = slice(0, b)
            peaks[tuple(sl)] = False
            sl[d] = slice(-b, None)
            peaks[tuple(sl)] = False
    coords = np.argwhere(peaks)
    if len(coords) == 0:
        return np.zeros((0, img.ndim + 1), np.float32)
    out = np.concatenate([coords[:, 1:].astype(np.float32),
                          sigmas[coords[:, 0]][:, None].astype(np.float32)], axis=1)
    vals = stack[tuple(coords.T)]
    return out[np.argsort(-vals)]



def _greedy_suppress(scaled: np.ndarray, radius: float,
                     labs: Optional[np.ndarray] = None) -> List[int]:
    """Greedy min-distance suppression in priority order via a cKDTree
    (the O(n^2) pure-python loop took hours at by-chunks point counts).
    ``labs``: optional per-point component labels — points only conflict
    within the same non-zero label."""
    from scipy.spatial import cKDTree

    tree = cKDTree(scaled)
    alive = np.ones(len(scaled), bool)
    kept: List[int] = []
    for i in range(len(scaled)):
        if not alive[i]:
            continue
        kept.append(i)
        for j in tree.query_ball_point(scaled[i], radius):
            if j > i and (labs is None or (labs[i] != 0 and labs[i] == labs[j])):
                alive[j] = False
    return kept


def remove_close_points(points: np.ndarray, radius: float,
                        resolution: Sequence[float] = (1, 1, 1),
                        return_keep: bool = False):
    """Greedy removal of points closer than ``radius`` (reference:
    post_processing.py:1994). ``return_keep`` also returns the kept
    indices, so that per-point side arrays (classes, scores) stay in step."""
    if len(points) == 0:
        return (points, []) if return_keep else points
    res = np.asarray(resolution[: points.shape[1]], np.float32)
    pts = np.asarray(points, np.float32) * res
    kept = _greedy_suppress(pts, radius)
    out = np.asarray(points)[kept]
    return (out, kept) if return_keep else out


def remove_close_points_by_mask(points: np.ndarray, radius: float,
                                mask_labels: np.ndarray,
                                resolution: Sequence[float] = (1, 1, 1)) -> np.ndarray:
    """Greedy close-point removal CONSTRAINED to the same mask component:
    two points only conflict when they fall inside the same non-zero label
    of ``mask_labels`` (reference: remove_close_points_by_mask,
    post_processing.py:1839 — used by the synapse workflow so points of
    different synapses never suppress each other)."""
    if len(points) == 0:
        return points
    pts_i = np.asarray(points, int)
    labs = np.array([mask_labels[tuple(np.clip(p, 0, np.array(mask_labels.shape) - 1))]
                     for p in pts_i])
    res = np.asarray(resolution[: pts_i.shape[1]], np.float32)
    scaled = np.asarray(points, np.float32) * res
    kept = _greedy_suppress(scaled, radius, labs=labs)
    return np.asarray(points)[kept]



def voronoi_on_mask(labels: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Expand instances to fill a mask by nearest-instance assignment
    (reference: voronoi expansion, post_processing.py:1742)."""
    if labels.max() == 0:
        return labels
    dist, (inds) = ndimage.distance_transform_edt(labels == 0, return_indices=True)
    expanded = labels[tuple(inds)]
    out = labels.copy()
    grow = (labels == 0) & (mask > 0)
    out[grow] = expanded[grow]
    return out


def apply_median_filter(img: np.ndarray, axes: Sequence[str], sizes: Sequence[int]) -> np.ndarray:
    """Axis-restricted median filtering (reference: post_processing.py:1218,
    TEST.POST_PROCESSING.MEDIAN_FILTER)."""
    out = img
    for axis_spec, s in zip(axes, sizes):
        size = [1] * out.ndim
        spec = axis_spec.lower()
        nd = out.ndim - 1  # channels-last
        ax_map = {"z": 0, "y": nd - 2, "x": nd - 1} if nd == 3 else {"y": 0, "x": 1}
        for a in spec:
            if a in ax_map:
                size[ax_map[a]] = s
        out = ndimage.median_filter(out, size=tuple(size))
    return out


def measure_instance_properties(labels: np.ndarray, resolution: Sequence[float] = (1, 1, 1),
                                extra_props: Sequence[str] = ()) -> Dict[str, np.ndarray]:
    """Per-instance morphology: size, centroid, diameter (+ EXTRA_PROPS:
    perimeter/surface_area, bbox, circularity/sphericity, elongation, area/
    volume in physical units) — reference: measure/filter props -> CSV,
    post_processing.py:2420 with MEASURE_PROPERTIES.EXTRA_PROPS."""
    nd = labels.ndim
    extras = [str(p).lower() for p in extra_props]
    res = np.asarray(list(resolution)[:nd] + [1.0] * max(0, nd - len(resolution)), np.float64)
    objs = ndimage.find_objects(labels)
    ids, sizes, centroids, diameters = [], [], [], []
    perims, bboxes, rounds, elongs, physs = [], [], [], [], []
    want_perim = any(p in extras for p in ("perimeter", "surface_area",
                                           "circularity", "sphericity"))
    for lab, sl in zip(range(1, len(objs) + 1), objs):
        if sl is None:
            continue
        m = labels[sl] == lab
        ids.append(lab)
        sizes.append(int(m.sum()))
        com = ndimage.center_of_mass(m)
        centroids.append([float(c + s.start) for c, s in zip(com, sl)])
        diameters.append(float(2 * (m.sum() * 3 / (4 * np.pi)) ** (1 / 3)) if nd == 3
                         else float(2 * np.sqrt(m.sum() / np.pi)))
        if want_perim:
            core = ndimage.binary_erosion(m)
            perims.append(int((m & ~core).sum()))
        if "bbox" in extras:
            bboxes.append([int(s.start) for s in sl] + [int(s.stop) for s in sl])
        if "elongation" in extras:
            ext = [s.stop - s.start for s in sl]
            elongs.append(float(max(ext) / max(min(ext), 1)))
        if any(p in extras for p in ("area", "volume")):
            physs.append(float(m.sum() * np.prod(res)))
    out = {"id": np.asarray(ids), "size": np.asarray(sizes),
           "centroid": np.asarray(centroids), "diameter": np.asarray(diameters)}
    if want_perim:
        p = np.asarray(perims, np.float64)
        out["surface_area" if nd == 3 else "perimeter"] = p
        s = np.asarray(sizes, np.float64)
        if nd == 2 and "circularity" in extras:
            out["circularity"] = np.where(p > 0, 4 * np.pi * s / np.maximum(p, 1) ** 2, 0.0)
        if nd == 3 and "sphericity" in extras:
            out["sphericity"] = np.where(
                p > 0, np.pi ** (1 / 3) * (6 * s) ** (2 / 3) / np.maximum(p, 1), 0.0)
    if "bbox" in extras:
        out["bbox"] = np.asarray(bboxes)
    if "elongation" in extras:
        out["elongation"] = np.asarray(elongs)
    if any(p in extras for p in ("area", "volume")):
        out["volume" if nd == 3 else "area"] = np.asarray(physs)
    return out


def instance_properties_csv(labels: np.ndarray, path: str,
                            resolution: Sequence[float] = (1, 1, 1),
                            extra_props: Sequence[str] = ()) -> None:
    """Write the per-instance property table (reference: the CSV pandas dump
    in post_processing.py:2420)."""
    import csv
    import os

    props = measure_instance_properties(labels, resolution, extra_props)
    nd = labels.ndim
    cols = ["id", "size", "diameter"] + [k for k in props
                                         if k not in ("id", "size", "diameter", "centroid", "bbox")]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        header = cols[:2] + [f"centroid-{d}" for d in range(nd)] + cols[2:]
        if "bbox" in props:
            header += [f"bbox-{d}" for d in range(2 * nd)]
        w.writerow(header)
        for i in range(len(props["id"])):
            row = [int(props["id"][i]), int(props["size"][i])]
            row += [float(c) for c in props["centroid"][i]]
            row += [float(props[k][i]) for k in cols[2:]]
            if "bbox" in props:
                row += [int(b) for b in props["bbox"][i]]
            w.writerow(row)


def filter_instances_by_properties(labels: np.ndarray, props: Sequence[str],
                                   values: Sequence[float], signs: Sequence[str],
                                   resolution: Sequence[float] = (1, 1, 1)) -> np.ndarray:
    """Remove instances matching the (prop, sign, value) conditions. The
    requested props are passed through as EXTRA_PROPS so derived measures
    (circularity/sphericity/elongation/physical area) are actually computed
    — a filter on an unmeasured property would otherwise silently pass."""
    # measured keys are dimension-specific (2D area/perimeter/circularity vs
    # 3D volume/surface_area/sphericity); accept either name for a filter
    nd3 = labels.ndim == 3
    alias = ({"area": "volume", "perimeter": "surface_area",
              "circularity": "sphericity"} if nd3 else
             {"volume": "area", "surface_area": "perimeter",
              "sphericity": "circularity"})
    props = [alias.get(str(p), str(p)) for p in props]
    measured = measure_instance_properties(labels, resolution=resolution,
                                           extra_props=props)
    drop = np.zeros(len(measured["id"]), bool)
    fns = {"gt": np.greater, "lt": np.less, "ge": np.greater_equal, "le": np.less_equal,
           "gte": np.greater_equal, "lte": np.less_equal}
    for p, v, s in zip(props, values, signs):
        if p in measured:
            drop |= fns[s](measured[p], v)
        else:
            print(f"WARNING: REMOVE_BY_PROPERTIES property '{p}' cannot be "
                  f"measured on this {labels.ndim}D image — condition skipped")
    out = labels.copy()
    for lab in measured["id"][drop]:
        out[out == lab] = 0
    return out


def apply_label_refinement(labels: np.ndarray, operations: Sequence[str],
                           values: Sequence) -> np.ndarray:
    """Sequential label cleanups over an instance image (reference:
    apply_label_refinement, post_processing.py:2900 — the
    TEST.POST_PROCESSING.INSTANCE_REFINEMENT chain). ``values`` is
    positional with ``operations``; value-less ops carry 'none'."""
    out = labels.copy()
    for op, value in zip(operations, values):
        op = str(op)
        if op == "fill_holes":
            # Per-instance cavity fill inside a grown bbox so holes cut by
            # the bbox edge still close (reference: fill_label_holes:2962).
            objs = ndimage.find_objects(out)
            filled = np.zeros_like(out)
            for lab, sl in zip(range(1, len(objs) + 1), objs):
                if sl is None:
                    continue
                grown = tuple(slice(max(s.start - 1, 0), min(s.stop + 1, sz))
                              for s, sz in zip(sl, out.shape))
                m = fill_holes(out[grown] == lab)
                filled[grown][m] = lab
            out = filled
        elif op == "clear_border":
            border = np.zeros(out.shape, bool)
            for ax in range(out.ndim):
                sl = [slice(None)] * out.ndim
                for edge in (0, -1):
                    sl[ax] = edge
                    border[tuple(sl)] = True
            for lab in np.unique(out[border]):
                if lab:
                    out[out == lab] = 0
        elif op == "erosion":
            out = ndimage.grey_erosion(out, size=(int(value),) * out.ndim)
        elif op == "dilation":
            out = ndimage.grey_dilation(out, size=(int(value),) * out.ndim)
        elif op == "remove_small_objects":
            out = remove_small_instances(out, int(value))
        elif op == "remove_big_objects":
            sizes = np.bincount(out.reshape(-1))
            big = np.flatnonzero(sizes > int(value))
            out[np.isin(out, big) & (out > 0)] = 0
        else:
            raise ValueError(f"Label refinement operation '{op}' not recognized")
    return out


def repair_large_blobs(labels: np.ndarray, max_size: int) -> np.ndarray:
    """Split oversized instances (usually watershed under-segmentation) by
    re-running a distance-transform watershed inside the blob
    (reference: repair_large_blobs, post_processing.py:2803)."""
    if max_size <= 0:
        return labels
    out = labels.copy()
    next_id = int(out.max())
    objs = ndimage.find_objects(out)
    for lab, sl in zip(range(1, len(objs) + 1), objs):
        if sl is None:
            continue
        m = out[sl] == lab
        if m.sum() <= max_size:
            continue
        from biapy_tpu_torch.data.pre_processing import _edt
        dist = _edt(m)
        peaks = peak_local_max(dist, min_distance=max(3, int(dist.max() / 2)), threshold_abs=1.0)
        if len(peaks) < 2:
            continue
        seeds = np.zeros(m.shape, np.int32)
        for i, c in enumerate(peaks):
            seeds[tuple(c)] = i + 1
        split = watershed(-dist, seeds, m)
        region = out[sl]
        region[m & (split > 1)] = 0  # keep piece 1 under the original id
        for i in range(2, int(split.max()) + 1):
            next_id += 1
            region[split == i] = next_id
        out[sl] = region
    return out


def _donut_line_ushape(line: np.ndarray, smooth_ticks: int):
    """Detect the two-peaks-around-a-valley profile of a ring ('donuts')
    cell along one center line (reference: detection_watershed donut
    analysis, post_processing.py:2246-2320). Returns (is_ushape, peak_span,
    left_gradient_ok, right_gradient_ok)."""
    from scipy.signal import find_peaks, savgol_filter

    if len(line) < max(5, smooth_ticks + 1):
        return False, 0, False, False
    win = min(len(line) - (1 - len(line) % 2), max(5, smooth_ticks | 1))
    sm = savgol_filter(line.astype(np.float64), win, 2)
    mid = len(sm) // 2
    valley = float(sm[mid])
    peaks, _ = find_peaks(sm)
    lefts = [p for p in peaks if p <= mid and sm[p] >= valley * 1.5]
    rights = [p for p in peaks if p > mid and sm[p] >= valley * 1.5]
    if not lefts or not rights:
        return False, 0, False, False
    lp = max(lefts, key=lambda p: sm[p])
    rp = max(rights, key=lambda p: sm[p])
    lgrad = bool(sm[:lp].size and sm[:lp].min() < sm[lp] * 0.7)
    rgrad = bool(sm[rp:].size and sm[rp:].min() < sm[rp] * 0.7)
    return True, int(rp - lp), lgrad, rgrad


def detection_watershed(points: np.ndarray, img: np.ndarray,
                        first_dilation: Sequence[int] = (2, 2),
                        growth_mask: Optional[np.ndarray] = None,
                        classes: Optional[np.ndarray] = None,
                        donuts_classes: Sequence[int] = (-1,),
                        donuts_patch: Sequence[int] = (13, 120, 120),
                        donuts_nucleus_diameter: int = 30) -> np.ndarray:
    """Grow instances around detected points via watershed over the image
    intensity (reference: detection_watershed, post_processing.py:2100).

    Ring-shaped ('donuts') cells confuse a point-seeded watershed: the seed
    sits in the dark lumen. For points of ``donuts_classes`` (every point
    when ``classes`` is None; none when it is ``[-1]``), the center
    intensity lines are profiled; a U-shape on both axes with healthy outer
    gradients triggers an extra per-seed dilation sized to the ring span so
    the seed reaches the bright membrane (reference :2178-2360). The
    instances grow within ``growth_mask`` (default: the image above its Otsu
    threshold) and the seeds."""
    nd = img.ndim
    points = np.asarray(points, int)
    seeds = np.zeros(img.shape, np.int32)
    for i, p in enumerate(points):
        idx = tuple(np.clip(p[d], 0, img.shape[d] - 1) for d in range(nd))
        seeds[idx] = i + 1
    fd = [int(d) for d in (list(first_dilation) + [list(first_dilation)[-1]] * nd)[:nd]]
    if any(d > 0 for d in fd):
        seeds = ndimage.grey_dilation(seeds, size=tuple(2 * max(d, 0) + 1 for d in fd))

    if list(donuts_classes) and int(list(donuts_classes)[0]) != -1:
        half = [p // 2 for p in list(donuts_patch)[-nd:]]
        ticks = [max(5, (p // 8) | 1) for p in list(donuts_patch)[-nd:]]
        for i, p in enumerate(points):
            if classes is not None and int(classes[i]) not in [int(c) for c in donuts_classes]:
                continue
            c = [int(np.clip(p[d], 0, img.shape[d] - 1)) for d in range(nd)]
            sl = tuple(slice(max(c[d] - half[d], 0), min(c[d] + half[d], img.shape[d]))
                       for d in range(nd))
            patch = img[sl]
            center = [c[d] - sl[d].start for d in range(nd)]
            # center lines along the last two axes (y through x-center, x
            # through y-center); 3D profiles at the seed's z plane
            if nd == 2:
                line_y = patch[:, center[1]]
                line_x = patch[center[0], :]
            else:
                line_y = patch[center[0], :, center[2]]
                line_x = patch[center[0], center[1], :]
            uy, span_y, lg_y, rg_y = _donut_line_ushape(line_y, ticks[-2])
            ux, span_x, lg_x, rg_x = _donut_line_ushape(line_x, ticks[-1])
            if not (uy and ux):
                continue
            if span_y + span_x < 2 * donuts_nucleus_diameter:
                continue  # donut-shaped but small: normal growth suffices
            if not (lg_y and rg_y and lg_x and rg_x):
                continue  # weak outer gradient: dilation would bleed out
            # dilate THIS seed by ~60% of the ring span per axis
            extra = [0] * nd
            extra[-2] = max(0, int((span_y - fd[-2]) * 0.6) // 2)
            extra[-1] = max(0, int((span_x - fd[-1]) * 0.6) // 2)
            if nd == 3:
                extra[0] = max(fd[0], 1)
            if all(e == 0 for e in extra):
                continue
            own = seeds == (i + 1)
            grown = ndimage.binary_dilation(
                own, structure=np.ones(tuple(2 * e + 1 for e in extra), bool))
            seeds[grown & (seeds == 0)] = i + 1

    if growth_mask is None:
        growth_mask = img > _otsu(img.astype(np.float32))
    growth_mask = growth_mask | (seeds > 0)  # seeds always belong to an instance
    topo = -img.astype(np.float32)
    return watershed(topo, seeds, growth_mask)
