"""StarDist rays and Cellpose / Omnipose flows in the port against the JAX
package.

Small seeded inputs, the same on both sides, one module at a time:

* the ray NMS (``data/polygon_nms.py``), 2D with a probability map and with
  the probability 1 everywhere that the template's ['Db', 'R'] gives, and
  3D: identical labels;
* ``ops/flows.py::follow_flows`` on the CPU, plain and suppressed stepping,
  2D and 3D: identical positions (the JAX package's order of operations in
  float32, with the fused multiply-adds XLA's CPU code makes of it);
* ``flows_to_instances`` with the flow-error check on: identical labels;
  ``cellpose_flows`` (its diffusion in torch float64): identical flows;
* ``ops/omnipose.py``: the compiler's channels (smooth distance, flows)
  within 1e-6, ``compute_masks_omnipose`` on its DBSCAN and its skeleton
  branch: identical labels; the port's own DBSCAN against scikit-learn's:
  identical labels;
* the instance workflow's dispatch (``instance_seg_process`` for rays,
  flows and Omnipose) on compiled channels: identical labels;
* the Cellpose test-time rescale hooks and the diameter estimate: equal.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.config.config import get_cfg_defaults as jax_cfg_defaults
from biapy_tpu.data import polygon_nms as JNMS
from biapy_tpu.data import pre_processing as JP
from biapy_tpu.data.tiff import write_tiff
from biapy_tpu.engine.instance_seg import Instance_Segmentation_Workflow as JaxWF
from biapy_tpu.ops import flows as JF
from biapy_tpu.ops import omnipose as JO
from biapy_tpu_torch.config.config import get_cfg_defaults
from biapy_tpu_torch.data import polygon_nms as TNMS
from biapy_tpu_torch.data import pre_processing as TP
from biapy_tpu_torch.engine.instance_seg import Instance_Segmentation_Workflow as TorchWF
from biapy_tpu_torch.ops import flows as TF
from biapy_tpu_torch.ops import omnipose as TO

torch.set_num_threads(2)


def _discs(shape, n, seed, r_range=(7, 12)):
    """Seeded non-touching discs (2D) or balls (3D): int32 labels."""
    rng = np.random.default_rng(seed)
    grid = np.indices(shape)
    lab = np.zeros(shape, np.int32)
    placed = []
    for _ in range(300):
        if len(placed) == n:
            break
        r = int(rng.integers(*r_range))
        c = [int(rng.integers(r + 1, s - r - 1)) for s in shape]
        if any(sum((a - b) ** 2 for a, b in zip(c, o)) < (r + ro + 3) ** 2 for *o, ro in placed):
            continue
        lab[sum((g - ci) ** 2 for g, ci in zip(grid, c)) < r * r] = len(placed) + 1
        placed.append((*c, r))
    return lab


def _noisy(x, seed, scale):
    return (x + np.random.default_rng(seed).normal(0, scale, x.shape)).astype(np.float32)


# ------------------------------------------------------------------ rays
@pytest.mark.parametrize("prob_kind", ["edt", "ones"])
def test_nms_2d_equals_jax(prob_kind):
    lab = _discs((80, 72), 6, seed=2)
    rays = _noisy(TP.radial_distances(lab, 32), 3, 0.5)
    if prob_kind == "ones":
        # the template's ['Db', 'R']: no P or F, every grid point a peak
        prob = np.ones(lab.shape, np.float32)
    else:
        prob = _noisy(ndimage.distance_transform_edt(lab > 0) / 10.0, 4, 0.05)
    kw = dict(prob_threshold=0.4, iou_threshold=0.3, max_candidates=400)
    want = JNMS.stardist_nms_2d(prob, rays, **kw)
    got = TNMS.stardist_nms_2d(prob, rays, **kw)
    assert got.dtype == want.dtype and want.max() > 0
    np.testing.assert_array_equal(got, want)


def test_nms_3d_equals_jax():
    lab = np.zeros((24, 48, 48), np.int32)
    zz, yy, xx = np.mgrid[:24, :48, :48]
    for i, (cz, cy, cx, r) in enumerate([(8, 12, 12, 8), (14, 32, 30, 9), (10, 14, 36, 7)]):
        lab[((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) < r * r] = i + 1
    rays = _noisy(TP.radial_distances(lab, 64), 5, 0.3)
    dist = ndimage.distance_transform_edt(lab > 0).astype(np.float32)
    prob = np.zeros_like(dist)
    for lb in (1, 2, 3):
        m = lab == lb
        prob[m] = dist[m] / dist[m].max()
    kw = dict(prob_threshold=0.6, iou_threshold=0.3, grid_step=2)
    want = JNMS.stardist_nms_3d(prob, rays, **kw)
    got = TNMS.stardist_nms_3d(prob, rays, **kw)
    assert want.max() >= 3
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ flows
def _flows(nd, seed):
    lab = _discs((64, 56) if nd == 2 else (20, 36, 32), 5 if nd == 2 else 4, seed,
                 (7, 12) if nd == 2 else (4, 8))
    return lab, _noisy(TP.cellpose_flows(lab), seed + 1, 0.2)


@pytest.mark.parametrize("suppressed", [False, True], ids=["plain", "suppressed"])
@pytest.mark.parametrize("nd", [2, 3])
def test_follow_flows_equals_jax(nd, suppressed):
    import jax.numpy as jnp

    _, flows = _flows(nd, 7)
    want = np.asarray(JF.follow_flows(jnp.asarray(flows), n_iter=60, suppressed=suppressed))
    got = TF.follow_flows(torch.from_numpy(flows), n_iter=60, suppressed=suppressed)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    assert float(np.abs(got - want).max()) <= 1e-5
    np.testing.assert_array_equal(got, want)


def test_follow_flows_wants_float32():
    with pytest.raises(ValueError, match="float32"):
        TF.follow_flows(torch.zeros(4, 4, 2, dtype=torch.float64), n_iter=1)


@pytest.mark.parametrize("nd", [2, 3])
def test_flows_to_instances_equals_jax(nd):
    lab, flows = _flows(nd, 11)
    fg = lab > 0
    kw = dict(n_iter=80, flow_error_th=0.4)
    want = JF.flows_to_instances(flows, fg, **kw)
    got = TF.flows_to_instances(flows, fg, device="cpu", **kw)
    assert want.max() > 0
    np.testing.assert_array_equal(got, want)


def _touching(shape, seed):
    """Overlapping seeded balls, later ones over earlier ones: touching,
    cut and non-convex instances, some at the volume's faces, and a
    U-shaped one whose median centre lies outside it."""
    rng = np.random.default_rng(seed)
    grid = np.indices(shape)
    lab = np.zeros(shape, np.int32)
    for i in range(1, 14):
        c = [int(rng.integers(0, s)) for s in shape]
        lab[sum((g - ci) ** 2 for g, ci in zip(grid, c)) < int(rng.integers(2, 7)) ** 2] = i
    u = (slice(2, 4),) * (len(shape) - 2) + (slice(2, 12), slice(2, 4))
    lab[u] = 20
    lab[u[:-2] + (slice(10, 12), slice(2, 12))] = 20
    lab[u[:-2] + (slice(2, 12), slice(10, 12))] = 20
    return lab


@pytest.mark.parametrize("nd", [2, 3])
def test_cellpose_flows_equal_jax(nd):
    """The compiler's flows, and both of its diffusion paths (all instances
    at once, box by box) on their own: the JAX package's bits."""
    lab = _touching((30, 34) if nd == 2 else (12, 22, 20), 37 + nd)
    want = JP.cellpose_flows(lab)
    got = TP.cellpose_flows(lab)
    assert got.dtype == want.dtype == np.float32 and np.abs(want).max() > 0
    np.testing.assert_array_equal(got, want)
    ids = np.unique(lab[lab > 0]).astype(np.int64)
    its = np.asarray([2 * max(s.stop - s.start + 2 for s in sl)
                      for sl in ndimage.find_objects(lab) if sl is not None], np.int64)
    together = TP._flows_together(lab, ids, its, "cpu")
    boxes = TP._flows_in_boxes(lab, ids, its, "cpu")
    np.testing.assert_array_equal(together, boxes)


# ---------------------------------------------------------------- omnipose
@pytest.mark.parametrize("nd", [2, 3])
def test_omnipose_compiler_channels_equal_jax(nd):
    lab = _discs((48, 40) if nd == 2 else (16, 28, 24), 4, 13, (5, 9) if nd == 2 else (4, 7))
    codes = ["Db", "Gv", "Gh"] + (["Gz"] if nd == 3 else [])
    extra = {"Db": {"val_type": "omnipose", "dist_bg": 5.0},
             "Gv": {"gradient_type": "omnipose"}}
    want = JP.labels_into_channels(lab[..., None], codes, extra)
    got = TP.labels_into_channels(lab[..., None], codes, extra)
    assert got.dtype == want.dtype and got.shape == want.shape == lab.shape + (len(codes),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("branch", ["dbscan", "skeleton"])
def test_compute_masks_omnipose_equals_jax(branch):
    # small cells (mean diameter <= 12) take DBSCAN, large ones the skeleton
    r_range = (4, 6) if branch == "dbscan" else (11, 15)
    lab = _discs((64, 64), 5, 17, r_range)
    T, mu = JO.omnipose_flows(lab)
    dist = T.copy()
    dist[lab == 0] = -5.0
    dist = _noisy(dist, 18, 0.05)
    mu = _noisy(mu, 19, 0.05)
    want = JO.compute_masks_omnipose(mu, dist, flow_threshold=0.4)
    got = TO.compute_masks_omnipose(mu, dist, flow_threshold=0.4, device="cpu")
    d = JO._mean_diameter(dist, JO._hysteresis(dist, -1.0, 0.0), 2)
    assert (d <= 12.0) == (branch == "dbscan") and want.max() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["blobs2d", "grid3d", "sparse"])
def test_dbscan_matches_sklearn(case):
    from sklearn.cluster import DBSCAN

    rng = np.random.default_rng(23)
    if case == "blobs2d":
        cent = rng.uniform(0, 60, (12, 2))
        pts = cent[rng.integers(0, 12, 4000)] + rng.normal(0, 0.8, (4000, 2))
    elif case == "grid3d":
        # points on the integer grid: distances equal to eps on the boundary
        pts = rng.integers(0, 12, (1500, 3)).astype(np.float64)
    else:
        pts = rng.uniform(0, 40, (600, 2))
    pts = pts.astype(np.float32)
    for eps, ms in ((2 ** 0.5, 5), (1.0, 3), (2.0, 8)):
        want = DBSCAN(eps=eps, min_samples=ms).fit(pts).labels_
        got = TO.dbscan_labels(pts, eps=eps, min_samples=ms)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- workflows
def _workflows(codes, extra=None, nd=2, process=""):
    sides = {}
    for side, (defaults, cls) in {"jax": (jax_cfg_defaults, JaxWF),
                                  "torch": (get_cfg_defaults, TorchWF)}.items():
        cfg = defaults()
        cfg.merge_from_dict({
            "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": f"{nd}D",
                        "INSTANCE_SEG": {"DATA_CHANNELS": list(codes),
                                         "DATA_CHANNELS_EXTRA_OPTS": [extra or {}],
                                         "INSTANCE_CREATION_PROCESS": process}},
            "DATA": {"PATCH_SIZE": (32, 32, 1) if nd == 2 else (16, 32, 32, 1)},
        })
        wf = cls.__new__(cls)
        wf.cfg = cfg
        wf.nd = nd
        wf.device = torch.device("cpu")
        wf.define_activations_and_channels()
        sides[side] = wf
    return sides


MODES = {
    "rays": (["F", "R"], {"R": {"nrays": 24}}, ""),
    "flows": (["F", "Gv", "Gh"], {}, ""),
    "omnipose": (["F", "Db", "Gv", "Gh"], {"Db": {"val_type": "omnipose"},
                                          "Gv": {"gradient_type": "omnipose"}}, "omnipose"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_instance_seg_process_equals_jax(mode):
    codes, extra, process = MODES[mode]
    lab = _discs((72, 64), 5, 29)
    chans = _noisy(JP.labels_into_channels(lab[..., None], codes, extra), 30, 0.05)
    sides = _workflows(codes, extra, process=process)
    want = sides["jax"].instance_seg_process(chans)
    got = sides["torch"].instance_seg_process(chans)
    assert want.max() > 0
    np.testing.assert_array_equal(got, want)


def test_cellpose_rescale_hooks_equal_jax(tmp_path):
    """DIAMETER > 0 rescales the input in-plane by DIAM_MEAN / DIAMETER and
    the merged prediction back to the input's size, as in the JAX package;
    Omnipose and by-chunks runs do not rescale."""
    (tmp_path / "x").mkdir()
    write_tiff(str(tmp_path / "x" / "a.tif"), np.zeros((64, 64), np.uint8))
    cfg = {
        "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": "2D",
                    "INSTANCE_SEG": {"DATA_CHANNELS": ["F", "Gv", "Gh"],
                                     "CELLPOSE": {"DIAMETER": 48.0, "DIAM_MEAN": 30.0}}},
        "DATA": {"PATCH_SIZE": (32, 32, 1),
                 "TRAIN": {"PATH": str(tmp_path / "x"), "GT_PATH": str(tmp_path / "x")},
                 "TEST": {"PATH": str(tmp_path / "x"), "LOAD_GT": False}},
        "TRAIN": {"ENABLE": True},
        "TEST": {"ENABLE": True},
    }
    rng = np.random.default_rng(31)
    img = rng.uniform(0, 255, (64, 60, 1)).astype(np.float32)
    wfs = {}
    for side, pkg, kw in (("jax", biapy_tpu, {}), ("torch", biapy_tpu_torch, {"device": "cpu"})):
        job = pkg.BiaPy(cfg, result_dir=str(tmp_path / side), name="cp", silent=True, **kw)
        job._build_workflow()
        wfs[side] = job.workflow
    outs = {s: wf.before_test_sample(img, None, "a.tif")[0] for s, wf in wfs.items()}
    assert outs["torch"].shape == outs["jax"].shape == (40, 38, 1)   # factor 30/48
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    pred = rng.normal(0, 1, (40, 38, 3)).astype(np.float32)
    backs = {s: wf.post_merge_transform(pred, "a.tif") for s, wf in wfs.items()}
    assert backs["torch"].shape == (64, 60, 3)
    np.testing.assert_array_equal(backs["torch"], backs["jax"])
    lab = _discs((64, 60), 5, 32)
    assert wfs["torch"]._estimate_diameter(lab) == wfs["jax"]._estimate_diameter(lab)
    assert wfs["torch"]._estimate_diameter(lab[None]) == wfs["jax"]._estimate_diameter(lab[None])
    c = {**cfg, "PROBLEM": {**cfg["PROBLEM"], "INSTANCE_SEG": {
        **cfg["PROBLEM"]["INSTANCE_SEG"], "INSTANCE_CREATION_PROCESS": "omnipose"}}}
    job = biapy_tpu_torch.BiaPy(c, result_dir=str(tmp_path / "omni"), name="cp", silent=True,
                                device="cpu")
    job._build_workflow()
    wf = wfs["torch"]
    for w, chunks in ((job.workflow, False), (wf, True)):
        if chunks:  # the Cellpose rescale stays off by chunks
            w.cfg.defrost()
            w.cfg.TEST.BY_CHUNKS.ENABLE = True
        assert w.before_test_sample(img, None, "a.tif")[0] is img
        assert w.post_merge_transform(pred, "a.tif") is pred
