"""Synapse detection data layer (CREMI-format point annotations), copied
from the JAX package's ``data/synapses.py`` (but for the pre/post pairing,
which finds the same closest pres with a k-d tree). CREMI files are read through
``data/io.py::open_lazy`` (Zarr and N5 with NumPy and zlib alone; HDF5
through h5py, imported only when such a file is opened).

Reference analogs:
- GT point loading: load_synapse_gt_points (data_3D_manipulation.py:1703)
- training channel painting: synapse_channel_creation (pre_processing.py:2272)
  with modes simpsyn (F_pre+F_post), F_post_only, synful (F_post+H/V/Z offset
  vectors to the presynaptic site) and cleft (darkest point along the
  pre->post beam on the smoothed raw volume)
- prediction -> points: create_synapses_from_point_probs /
  extract_points_in_predictions / extract_synful_synapses /
  connect_pre_post_synapse_points_by_distance (post_processing.py:437-1217)

Annotations follow the CREMI schema: ``annotations/ids`` (synaptic partner
ids), ``annotations/partners`` ((pre_id, post_id) pairs),
``annotations/locations`` (world coordinates, nm) and a ``resolution``
attribute on the raw volume.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from biapy_tpu_torch.data.io import open_lazy
from biapy_tpu_torch.data.post_processing import blob_log, peak_local_max


# --------------------------------------------------------------------- utils
def generate_ellipse_footprint(radii: Sequence[int]) -> np.ndarray:
    """Boolean ellipsoid footprint with per-axis radii (reference:
    generate_ellipse_footprint, pre_processing.py)."""
    r = [max(0, int(x)) for x in radii]
    grids = np.meshgrid(*[np.arange(-x, x + 1) for x in r], indexing="ij")
    s = np.zeros_like(grids[0], dtype=np.float64)
    for g, x in zip(grids, r):
        s += (g / max(1, x)) ** 2
    return s <= 1.0


def _read_nested(filename: str, inner: str):
    """Read a nested dataset from a Zarr/H5 file; returns (array-like, handle)."""
    return open_lazy(filename, inner)


def load_synapse_gt_points(
    filename: str,
    id_path: str = "annotations.ids",
    partners_path: str = "annotations.partners",
    locations_path: str = "annotations.locations",
    resolution_path: str = "volumes.raw",
) -> Dict[str, object]:
    """Load CREMI synapse annotations into voxel-space point lists
    (reference: load_synapse_gt_points, data_3D_manipulation.py:1703).

    Returns {"pre": [...], "post": [...], "cleft": [...], "resolution": [...]},
    cleft points being pre/post midpoints."""
    handles = []
    try:
        ids_arr, h = _read_nested(filename, id_path)
        handles.append(h)
        ids = list(np.asarray(ids_arr).ravel())
        partners, h = _read_nested(filename, partners_path)
        handles.append(h)
        partners = np.asarray(partners)
        locations, h = _read_nested(filename, locations_path)
        handles.append(h)
        locations = np.asarray(locations)
        res_node, h = _read_nested(filename, resolution_path)
        handles.append(h)
        resolution = res_node.attrs.get("resolution") if hasattr(res_node, "attrs") else None
        if resolution is None:
            raise ValueError(
                "No 'resolution' attribute at '{}' in {}. Set it like "
                "data['{}'].attrs['resolution'] = (8,8,8)".format(resolution_path, filename, resolution_path)
            )
    finally:
        for h in handles:
            if h is not None:
                h.close()
    resolution = [float(x) for x in resolution]
    id_to_pos = {int(sid): i for i, sid in enumerate(ids)}
    res = np.asarray(resolution)
    pre_pts: Dict[tuple, np.ndarray] = {}
    post_pts: Dict[tuple, np.ndarray] = {}
    pairs: List[Tuple[np.ndarray, np.ndarray]] = []
    for pre_id, post_id in np.asarray(partners):
        pi, qi = id_to_pos.get(int(pre_id)), id_to_pos.get(int(post_id))
        if pi is None or qi is None:
            continue  # inconsistent annotation; skip quietly like the reference
        pre = (locations[pi] // res).astype(np.int64)
        post = (locations[qi] // res).astype(np.int64)
        pre_pts.setdefault(tuple(pre.tolist()), pre)
        post_pts.setdefault(tuple(post.tolist()), post)
        pairs.append((pre, post))
    pre_list = list(pre_pts.values())
    post_list = list(post_pts.values())
    cleft_list = [(a + b) / 2 for a, b in zip(pre_list, post_list)]
    return {"pre": pre_list, "post": post_list, "cleft": cleft_list,
            "resolution": resolution, "pairs": pairs}


def _in_bounds(p: np.ndarray, shape: Sequence[int]) -> bool:
    return bool(np.all(p >= 0) and np.all(p < np.asarray(shape)))


# -------------------------------------------------- training channel painting
def select_synapse_method(channels: Sequence[str]) -> str:
    """Channel set -> synapse method (reference: instance_seg.py:224-234)."""
    ch = list(channels)
    if set(ch) == {"F_pre", "F_post"} and len(ch) == 2:
        return "simpsyn"
    if set(ch) == {"F_post", "Z", "V", "H"} and len(ch) == 4:
        return "synful"
    if ch == ["F_cleft"]:
        return "cleft"
    if ch == ["F_post"]:
        return "F_post_only"
    raise ValueError(f"Unknown synapse prediction method for channels {channels}")


def synapse_channel_creation(
    filename: str,
    out_path: str,
    channels: Sequence[str],
    channel_extra_opts: Optional[Dict] = None,
    zarr_info: Optional[Dict[str, str]] = None,
    raw_path: Optional[str] = None,
    verbose: bool = False,
) -> str:
    """Paint the synapse training representation for one CREMI file into a
    channels-last Zarr at ``out_path`` (reference: synapse_channel_creation,
    pre_processing.py:2272). Returns ``out_path``.

    Modes (selected from ``channels``):
    - simpsyn: F_pre/F_post binary balls around each point (per-channel
      ellipsoid dilation).
    - F_post_only: just the post channel.
    - synful: F_post ball + H/V/Z voxel-offset vectors toward the paired
      presynaptic site, painted over the pre-dilation ball around each post
      site (optionally normalized).
    - cleft: darkest point along each pre->post segment of the (smoothed)
      raw volume, dilated.
    """
    from biapy_tpu_torch.data.zarr_store import ZarrArray

    opts = dict(channel_extra_opts or {})
    zi = dict(zarr_info or {})
    method = select_synapse_method(channels)
    gt = load_synapse_gt_points(
        filename,
        id_path=zi.get("id_path", "annotations.ids"),
        partners_path=zi.get("partners_path", "annotations.partners"),
        locations_path=zi.get("locations_path", "annotations.locations"),
        resolution_path=zi.get("resolution_path", "volumes.raw"),
    )
    raw_inner = raw_path or zi.get("raw_data_path") or "volumes.raw"
    arr, fh = open_lazy(filename, raw_inner)
    try:
        shape_zyx = tuple(int(s) for s in arr.shape[:3])
    finally:
        if fh is not None:
            fh.close()

    n_ch = len(channels)
    dtype = "float32" if method == "synful" else "uint8"
    out = ZarrArray.create(
        out_path,
        shape=shape_zyx + (n_ch,),
        chunks=(min(32, shape_zyx[0]), min(128, shape_zyx[1]), min(128, shape_zyx[2]), n_ch),
        dtype=dtype,
        compressor={"id": "zlib", "level": 1},
        overwrite=True,
    )

    if method == "synful":
        pre_dil = opts.get("H", {}).get("dilation", [3, 25, 25])
    else:
        pre_dil = opts.get("F_pre", {}).get("dilation", [1, 3, 3])
    post_dil = opts.get("F_post", {}).get("dilation", [1, 3, 3])
    pre_fp = generate_ellipse_footprint(pre_dil)
    post_fp = generate_ellipse_footprint(post_dil)
    norm = any(opts.get(k, {}).get("norm", True) for k in ("Z", "V", "H"))
    width = np.maximum(np.asarray(pre_dil), np.asarray(post_dil)) + 1

    # group post sites per pre site
    pre_post: Dict[tuple, List[np.ndarray]] = {}
    for pre, post in gt["pairs"]:
        if _in_bounds(pre, shape_zyx) and _in_bounds(post, shape_zyx):
            pre_post.setdefault(tuple(pre.tolist()), []).append(post)

    if method == "cleft":
        raw_full, fh = open_lazy(filename, raw_inner)

    for pre_t, posts in pre_post.items():
        pre = np.asarray(pre_t)
        pts = np.vstack([pre[None]] + [p[None] for p in posts])
        lo = np.maximum(0, pts.min(0) - width)
        hi = np.minimum(shape_zyx, pts.max(0) + width + 1)
        pshape = tuple((hi - lo).tolist())
        patch = np.zeros(pshape + (n_ch,), np.float32)
        pre_l = pre - lo

        if method in ("simpsyn",):
            c = channels.index("F_pre")
            seed = np.zeros(pshape, bool)
            seed[max(0, pre_l[0] - 1): pre_l[0] + 1, pre_l[1], pre_l[2]] = True
            patch[..., c] = ndimage.binary_dilation(seed, structure=pre_fp)
        if method in ("simpsyn", "F_post_only", "synful"):
            c = channels.index("F_post")
            seed = np.zeros(pshape, bool)
            for post in posts:
                pl = post - lo
                seed[max(0, pl[0] - 1): pl[0] + 1, pl[1], pl[2]] = True
            patch[..., c] = ndimage.binary_dilation(seed, structure=post_fp)
        if method == "synful":
            # offsets toward the pre site over a ball grown around each post
            grow = np.zeros(pshape, bool)
            for post in posts:
                pl = post - lo
                grow[pl[0], pl[1], pl[2]] = True
            grow = ndimage.binary_dilation(grow, structure=pre_fp)
            zz, yy, xx = np.nonzero(grow)
            vec = pre_l[None, :] - np.stack([zz, yy, xx], axis=1).astype(np.float32)
            if norm and len(vec):
                scale = float(np.abs(vec).max() or 1.0)
                vec = vec / scale
            for axis, code in enumerate(("Z", "V", "H")):
                c = channels.index(code)
                patch[zz, yy, xx, c] = vec[:, axis]
        if method == "cleft":
            dil = opts.get("F_cleft", {}).get("dilation", [1, 3, 3])
            sdil = opts.get("F_cleft", {}).get("search_dilation", [1, 5, 5])
            n_samples = int(opts.get("F_cleft", {}).get("n_samples", 51))
            t0, t1 = opts.get("F_cleft", {}).get("t_range", (0.15, 0.85))
            sl = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
            raw_patch = np.asarray(raw_full[sl], np.float32)
            smooth = ndimage.uniform_filter(
                raw_patch, size=[2 * int(s) + 1 for s in sdil], mode="nearest")
            seed = np.zeros(pshape, bool)
            ts = np.linspace(t0, t1, n_samples, dtype=np.float32)
            for post in posts:
                pl = (post - lo).astype(np.float32)
                pts_line = pl[None] + ts[:, None] * (pre_l.astype(np.float32)[None] - pl[None])
                coords = np.clip(np.round(pts_line).astype(int), 0,
                                 np.asarray(pshape) - 1)
                prof = smooth[coords[:, 0], coords[:, 1], coords[:, 2]]
                z, y, x = coords[int(np.argmin(prof))]
                seed[z, y, x] = True
            patch[..., 0] = ndimage.binary_dilation(
                seed, structure=generate_ellipse_footprint(dil))

        sl = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi)) + (slice(None),)
        cur = out[sl]
        # write only where empty, like the reference's background check
        out[sl] = np.where(cur == 0, patch.astype(cur.dtype), cur)

    if method == "cleft" and fh is not None:
        fh.close()
    if verbose:
        print(f"Synapse channels ({method}) written to {out_path}")
    return out_path


# ------------------------------------------------------ prediction -> points
def _write_points_csv(path: str, rows: List[Dict], fields: List[str]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r in rows:
            w.writerow(r)


def extract_points_in_predictions(
    data: np.ndarray,
    point_type: str,
    point_creation_func: str = "peak_local_max",
    min_th_to_be_peak: float = 0.2,
    min_distance: int = 1,
    min_sigma: float = 5,
    max_sigma: float = 10,
    num_sigma: int = 2,
    exclude_border: bool = False,
    relative_th_value: bool = False,
    out_dir: Optional[str] = None,
) -> Tuple[List[Dict], np.ndarray]:
    """Point extraction from one predicted channel (reference:
    extract_points_in_predictions, post_processing.py:631). Returns
    (rows, (n, ndim) coords); rows carry id/coords/probability."""
    assert point_creation_func in ("peak_local_max", "blob_log")
    kw: Dict = dict(exclude_border=exclude_border)
    if relative_th_value:
        th_abs, th_rel = None, min_th_to_be_peak
    else:
        th_abs, th_rel = min_th_to_be_peak, None
    if point_creation_func == "peak_local_max":
        coords = peak_local_max(data, min_distance=min_distance,
                                threshold_abs=th_abs if th_abs is not None else -np.inf,
                                threshold_rel=th_rel, **kw)
    else:
        coords = blob_log(data * 255, min_sigma=min_sigma, max_sigma=max_sigma,
                          num_sigma=num_sigma, threshold=th_abs,
                          threshold_rel=th_rel, **kw)[:, :data.ndim].astype(int)
    rows = []
    for i, c in enumerate(coords):
        rows.append({f"{point_type}_id": i + 1,
                     **{f"axis-{d}": int(v) for d, v in enumerate(c)},
                     "probability": float(data[tuple(c)]),
                     f"{point_type} th": min_th_to_be_peak})
    if out_dir is not None:
        fields = ([f"{point_type}_id"] + [f"axis-{d}" for d in range(data.ndim)]
                  + ["probability", f"{point_type} th"])
        _write_points_csv(os.path.join(out_dir, f"pred_{point_type}_locations.csv"), rows, fields)
    return rows, np.asarray(coords, int).reshape(len(coords), data.ndim)


def _closest_pre(post: np.ndarray, pre: np.ndarray) -> np.ndarray:
    """Each post's closest pre, as ``np.argmin`` over the float32 norms of all
    pairs gives it (the first of equal ones), through a k-d tree: the pres
    within a hair of the nearest float64 distance, then their float32 norms.
    A float32 norm is within 1e-6 (relative) of the exact distance, so the
    argmin over all pairs is always among those candidates."""
    from scipy.spatial import cKDTree

    tree = cKDTree(pre.astype(np.float64))
    d, _ = tree.query(post.astype(np.float64))
    out = np.empty(len(post), np.int64)
    for j, cand in enumerate(tree.query_ball_point(post.astype(np.float64),
                                                   d * (1 + 1e-5) + 1e-6)):
        cand = np.sort(np.asarray(cand, np.int64))
        out[j] = cand[np.argmin(np.linalg.norm(post[j][None] - pre[cand], axis=-1))]
    return out


def connect_pre_post_points_by_distance(
    pre_points: np.ndarray, post_points: np.ndarray,
    out_dir: Optional[str] = None,
) -> List[Tuple[int, int]]:
    """Assign each post point to its closest pre point; pres without posts map
    to -1 (reference: connect_pre_post_synapse_points_by_distance,
    post_processing.py:437). Returns (pre_id, post_id) 1-based pairs. The
    closest pre by ``_closest_pre``: the JAX package's choice, in n log n
    rather than in the memory of every pair."""
    pairs: List[Tuple[int, int]] = []
    if len(pre_points) and len(post_points):
        closest = _closest_pre(np.asarray(post_points, np.float32),
                               np.asarray(pre_points, np.float32))
        assigned = set()
        for j in range(len(post_points)):
            pairs.append((int(closest[j]) + 1, j + 1))
            assigned.add(int(closest[j]) + 1)
        for i in range(len(pre_points)):
            if i + 1 not in assigned:
                pairs.append((i + 1, -1))
        pairs.sort()
    if out_dir is not None:
        _write_points_csv(os.path.join(out_dir, "pre_post_mapping.csv"),
                          [{"pre_id": a, "post_id": b} for a, b in pairs],
                          ["pre_id", "post_id"])
    return pairs


def extract_synful_synapses(
    data: np.ndarray,
    channels: Sequence[str],
    threshold_abs: float = 0.2,
    min_distance: int = 1,
    cluster_distance: float = 5.0,
    out_dir: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Synful vector decoding (reference: extract_synful_synapses,
    post_processing.py:1082): F_post peaks are post sites; each projects a
    pre site along its (Z,V,H) offset vector; projected pres are clustered
    (single linkage) into unique T-bars."""
    from scipy.cluster.hierarchy import fcluster, linkage

    ch = list(channels)
    fp, hi, vi, zi = (ch.index("F_post"), ch.index("H"), ch.index("V"), ch.index("Z"))
    post_coords = peak_local_max(data[..., fp], min_distance=min_distance,
                                 threshold_abs=threshold_abs).astype(int)
    if len(post_coords) == 0:
        return {"pre": np.zeros((0, 3)), "post": np.zeros((0, 3)), "pairs": []}
    proj = []
    for z, y, x in post_coords:
        vec = np.array([data[z, y, x, zi], data[z, y, x, hi], data[z, y, x, vi]])
        proj.append(np.array([z, y, x], np.float32) + vec)
    proj = np.asarray(proj, np.float32)
    if len(proj) > 1:
        labels = fcluster(linkage(proj, method="single", metric="euclidean"),
                          t=cluster_distance, criterion="distance")
    else:
        labels = np.array([1])
    pres = np.stack([proj[labels == lb].mean(0) for lb in np.unique(labels)])
    pairs = [(int(lb), j + 1) for j, lb in enumerate(labels)]
    if out_dir is not None:
        _write_points_csv(os.path.join(out_dir, "pred_pre_locations.csv"),
                          [{"pre_id": i + 1, "axis-0": float(p[0]), "axis-1": float(p[1]),
                            "axis-2": float(p[2])} for i, p in enumerate(pres)],
                          ["pre_id", "axis-0", "axis-1", "axis-2"])
        _write_points_csv(os.path.join(out_dir, "pred_post_locations.csv"),
                          [{"post_id": j + 1, "axis-0": int(c[0]), "axis-1": int(c[1]),
                            "axis-2": int(c[2]),
                            "probability": float(data[tuple(c)][fp])}
                           for j, c in enumerate(post_coords)],
                          ["post_id", "axis-0", "axis-1", "axis-2", "probability"])
        _write_points_csv(os.path.join(out_dir, "pre_post_mapping.csv"),
                          [{"pre_id": a, "post_id": b} for a, b in pairs],
                          ["pre_id", "post_id"])
    return {"pre": pres, "post": post_coords.astype(np.float32), "pairs": pairs}
