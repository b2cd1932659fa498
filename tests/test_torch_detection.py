"""The point-detection modules of the port against the JAX package.

Small numpy-seeded inputs, one function at a time:

* exact: ``blob_log``, ``remove_close_points`` (and by mask),
  ``detection_watershed`` (with the donut cells' extra dilation),
  ``create_detection_masks`` and the cached mask TIFFs (byte-equal, with the
  point-check reports), ``read_points_csv``, ``owned_tiles`` /
  ``core_keep_mask``, ``detection_metrics`` with ``resolution`` and
  ``tolerance``, and the whole of ``data/synapses.py`` on a CREMI volume
  (GT points, the channel Zarr's bytes for the four methods, extracted
  points, pairs, synful clusters);
* ``detection_loss`` in float32 within 1e-6 relative of the JAX function
  evaluated in float64, its gradient within 1e-6 of the JAX gradient;
* the detection workflow's ``_extract_points`` under each option (Otsu and
  manual thresholds, ``blob_log``, the border box, close-point removal with
  a resolution) and the synapse workflow's in-memory point extraction and
  metrics (thresholds, ``blob_log``, removal by radius and by mask):
  identical points;
* ``all_gather_objects``: one process, and two over gloo.
"""

import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biapy_tpu.config.config import get_cfg_defaults as jax_cfg_defaults
from biapy_tpu.data import post_processing as JPP
from biapy_tpu.data import pre_processing as JP
from biapy_tpu.data import synapses as JS
from biapy_tpu.engine import chunked as JC
from biapy_tpu.engine import detection as JD
from biapy_tpu.engine import metrics as JM
from biapy_tpu.engine.instance_seg import Instance_Segmentation_Workflow as JaxISW
from biapy_tpu.utils import matching as JMA
from biapy_tpu_torch.config.config import get_cfg_defaults
from biapy_tpu_torch.data import post_processing as TPP
from biapy_tpu_torch.data import pre_processing as TP
from biapy_tpu_torch.data import synapses as TS
from biapy_tpu_torch.data.tiff import write_tiff
from biapy_tpu_torch.engine import chunked as TC
from biapy_tpu_torch.engine import detection as TD
from biapy_tpu_torch.engine import metrics as TM
from biapy_tpu_torch.engine.instance_seg import Instance_Segmentation_Workflow as TorchISW
from biapy_tpu_torch.parallel import all_gather_objects
from biapy_tpu_torch.utils import matching as TMA

from test_synapses import _make_cremi

torch.set_num_threads(2)


def blobs(shape=(14, 40, 44), n=9, seed=0, sigma=(1.5, 2.5, 2.5), noise=0.05):
    """A float32 heatmap of ``n`` seeded Gaussian blobs in noise and the
    blob centres."""
    rng = np.random.default_rng(seed)
    centres = np.stack([rng.integers(2, s - 2, n) for s in shape], axis=1)
    grid = np.ogrid[tuple(slice(0, s) for s in shape)]
    heat = np.zeros(shape, np.float32)
    for c in centres:
        d2 = sum(((g - ci) / si) ** 2 for g, ci, si in zip(grid, c, sigma))
        heat = np.maximum(heat, rng.uniform(0.6, 1.0) * np.exp(-0.5 * d2))
    heat += rng.normal(0, noise, shape).astype(np.float32)
    return heat.astype(np.float32), centres


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- post-processing
BLOB_LOG = {
    "default": dict(min_sigma=1, max_sigma=3, num_sigma=3, threshold=0.05),
    "relative": dict(min_sigma=1, max_sigma=2, num_sigma=2, threshold=None,
                     threshold_rel=0.3),
    "border": dict(min_sigma=1.5, max_sigma=2.5, num_sigma=2, threshold=0.02,
                   exclude_border=True),
}


@pytest.mark.parametrize("case", list(BLOB_LOG))
def test_blob_log_equals_jax(case):
    heat, _ = blobs(seed=1)
    got, want = TPP.blob_log(heat, **BLOB_LOG[case]), JPP.blob_log(heat, **BLOB_LOG[case])
    assert len(want) > 3
    _equal(got, want)


def test_remove_close_points_equal_jax():
    rng = np.random.default_rng(2)
    pts = rng.integers(0, 30, (120, 3)).astype(np.int64)
    for radius, res in ((3.0, (1, 1, 1)), (5.5, (2.0, 1.0, 1.0))):
        _equal(TPP.remove_close_points(pts, radius, resolution=res),
               JPP.remove_close_points(pts, radius, resolution=res))
    labs = np.zeros((30, 30, 30), np.int32)
    labs[:15] = 1
    labs[15:, :10] = 2
    _equal(TPP.remove_close_points_by_mask(pts, 6.0, labs),
           JPP.remove_close_points_by_mask(pts, 6.0, labs))
    _equal(TPP.remove_close_points_by_mask(pts.astype(np.float32), 4.0, labs, (2, 1, 1)),
           JPP.remove_close_points_by_mask(pts.astype(np.float32), 4.0, labs, (2, 1, 1)))


def _rings(shape=(9, 64, 64), seed=3):
    """Bright ring-shaped cells (a dark lumen) in noise and their centres."""
    rng = np.random.default_rng(seed)
    grid = np.ogrid[tuple(slice(0, s) for s in shape)]
    img = rng.normal(20, 3, shape)
    centres = [(4, 18, 20), (4, 44, 40), (4, 20, 50)]
    for c, r in zip(centres, (12, 14, 8)):
        d = np.sqrt(sum((g - ci) ** 2 for g, ci in zip(grid[1:], c[1:])))
        img = img + 120 * np.exp(-((d - r) ** 2) / 4.0) * (abs(grid[0] - c[0]) < 4)
    return img.astype(np.float32), np.asarray(centres)


@pytest.mark.parametrize("donuts", [False, True])
def test_detection_watershed_equals_jax(donuts):
    img, pts = _rings()
    kw = dict(first_dilation=[1, 2, 2])
    if donuts:
        kw.update(donuts_classes=[1], donuts_patch=[9, 40, 40], donuts_nucleus_diameter=6)
    got, want = TPP.detection_watershed(pts, img, **kw), JPP.detection_watershed(pts, img, **kw)
    _equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2, 3}
    for k in range(3):
        line = img[pts[k][0], pts[k][1]]
        _equal(TPP._donut_line_ushape(line, 7), JPP._donut_line_ushape(line, 7))


# ---------------------------------------------------------------- CSV, masks
def _write_csv(path, rows, header=None):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        if header:
            w.writerow(header)
        w.writerows(rows)


CSVS = {
    "by-name": (["", "axis-0", "axis-1", "axis-2"], [[i, 3 + i, 10.5, 7] for i in range(5)]),
    "classes": (["axis-2", "axis-0", "class", "axis-1"], [[1, 2, 3, 4], [5, 6, "x", 8]]),
    "headerless": (None, [[1, 2, 3], [4, 5, 6, 2], ["z", "y", "x"]]),
    "empty": (None, []),
}


@pytest.mark.parametrize("case", list(CSVS))
def test_read_points_csv_equals_jax(tmp_path, case):
    header, rows = CSVS[case]
    p = str(tmp_path / "pts.csv")
    _write_csv(p, rows, header)
    _equal(TD.read_points_csv(p, 3), JD.read_points_csv(p, 3))


def test_create_detection_masks_equals_jax():
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.integers(0, 20, (15, 3)), [[-1, 3, 3], [5, 25, 5]]])
    for shape, dil in (((12, 20, 24), (1, 2, 2)), ((12, 20, 24), (2,)), ((20, 24), (3, 1))):
        p = pts[:, -len(shape):]
        _equal(TP.create_detection_masks(p, shape, dilation=dil),
               JP.create_detection_masks(p, shape, dilation=dil))


def _det_wf(cls, defaults, test=None, data=None):
    cfg = defaults()
    cfg.merge_from_dict({"PROBLEM": {"TYPE": "DETECTION", "NDIM": "3D"},
                         "DATA": dict({"PATCH_SIZE": (8, 32, 32, 1)}, **(data or {})),
                         "TEST": test or {}})
    wf = cls.__new__(cls)
    wf.cfg, wf.nd, wf.is_3d, wf.verbose = cfg, 3, True, False
    wf.define_activations_and_channels()
    return wf


def test_cached_point_masks_are_byte_equal(tmp_path):
    """The CSV -> point-mask compile of both workflows: the TIFFs and the
    CHECK_POINTS_CREATED reports byte for byte, GT_PATH moved to the cache."""
    rng = np.random.default_rng(5)
    os.makedirs(tmp_path / "x")
    os.makedirs(tmp_path / "csv")
    for i in range(2):
        write_tiff(str(tmp_path / "x" / f"{i}.tif"),
                   rng.integers(0, 255, (10, 30, 28), dtype=np.uint8))
        rows = [[j, *map(int, rng.integers(0, 28, 3) % (10, 30, 28))] for j in range(8)]
        rows += [[8, 50, 3, 3], [9, rows[0][1], rows[0][2] + 1, rows[0][3]]]
        _write_csv(str(tmp_path / "csv" / f"{i}.csv"), rows, ["", "axis-0", "axis-1", "axis-2"])
    out = {}
    for side, cls, defaults in (("jax", JD.Detection_Workflow, jax_cfg_defaults),
                                ("torch", TD.Detection_Workflow, get_cfg_defaults)):
        mask_dir = str(tmp_path / f"masks_{side}")
        wf = _det_wf(cls, defaults, data={"TRAIN": {
            "PATH": str(tmp_path / "x"), "GT_PATH": str(tmp_path / "csv"),
            "DETECTION_MASK_DIR": mask_dir}})
        wf._prepare_detection_masks("TRAIN")
        assert wf.cfg.DATA.TRAIN.GT_PATH == mask_dir
        out[side] = {f: open(os.path.join(mask_dir, f), "rb").read()
                     for f in sorted(os.listdir(mask_dir))}
    assert list(out["torch"]) == ["0.tif", "0_point_check.csv", "1.tif", "1_point_check.csv"]
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------- by-chunks helpers
@pytest.mark.parametrize("world", [1, 3])
def test_owned_tiles_and_core_keep_mask_equal_jax(world):
    rng = np.random.default_rng(6)
    spatial = (30, 70, 50)
    for rank in range(world):
        cis = [mod.ChunkedInference(None, (16, 32, 32), (0.0,) * 3, (2, 4, 4), (1, 2, 1), 1,
                                    "/nonexistent", rank=rank, world=world)
               for mod in (TC, JC)]
        (t_tiles, t_mine), (j_tiles, j_mine) = (TC.owned_tiles(cis[0], spatial),
                                                JC.owned_tiles(cis[1], spatial))
        assert [tuple(t.__dict__.values()) for t in t_tiles] == \
            [tuple(t.__dict__.values()) for t in j_tiles]
        assert [i for i, _ in t_mine] == [i for i, _ in j_mine]
        for (_, tt), (_, jt) in zip(t_mine, j_mine):
            local = rng.integers(-2, 40, (50, 3))
            _equal(TC.core_keep_mask(local, tt, 3), JC.core_keep_mask(local, jt, 3))


def test_detection_metrics_equal_jax():
    rng = np.random.default_rng(7)
    t = rng.uniform(0, 40, (30, 3)).astype(np.float32)
    p = (t[:25] + rng.normal(0, 2, (25, 3))).astype(np.float32)
    p = np.concatenate([p, rng.uniform(0, 40, (6, 3))])
    for tol, res in ((3.0, (1, 1, 1)), (8.0, (2.0, 1.0, 1.0)), (24.0, (8, 8, 8))):
        assert TMA.detection_metrics(t, p, tol, resolution=res) == \
            JMA.detection_metrics(t, p, tol, resolution=res)
    assert TMA.detection_metrics(t[:0], p, 3.0) == JMA.detection_metrics(t[:0], p, 3.0)


# ---------------------------------------------------------------- loss
@pytest.mark.parametrize("rebalance,weights", [(True, (1.0,)), (False, (2.5,))])
def test_detection_loss_and_gradient_equal_jax(rebalance, weights):
    rng = np.random.default_rng(8)
    y = (rng.random((2, 6, 12, 14, 1)) > 0.93).astype(np.float32)
    logits = rng.normal(0, 2.0, y.shape).astype(np.float32)
    kw = dict(channel_weights=weights, class_rebalance_within_channels=rebalance)
    jg = jax.grad(lambda p: JM.detection_loss(**kw)(p, jnp.asarray(y)))(jnp.asarray(logits))
    # the value against the JAX function in float64: XLA's float32 mean of
    # these 2016 terms is itself 1.1e-6 (relative) off the float64 value
    with jax.enable_x64(True):
        jv = float(JM.detection_loss(**kw)(jnp.asarray(logits, jnp.float64),
                                           jnp.asarray(y, jnp.float64)))
    tp = torch.tensor(logits, requires_grad=True)
    tv = TM.detection_loss(**kw)(tp, torch.from_numpy(y))
    tv.backward()
    assert tv.dtype == torch.float32
    assert abs(tv.item() - jv) <= 1e-6 * abs(jv), (tv.item(), jv)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- point extraction
EXTRACT = {
    "manual": {"DET_MIN_TH_TO_BE_PEAK": 0.4, "DET_PEAK_LOCAL_MAX_MIN_DISTANCE": 2},
    "auto": {"DET_TH_TYPE": "auto"},
    "blob_log": {"DET_POINT_CREATION_FUNCTION": "blob_log", "DET_MIN_TH_TO_BE_PEAK": 0.3,
                 "DET_BLOB_LOG_MIN_SIGMA": 1, "DET_BLOB_LOG_MAX_SIGMA": 3,
                 "DET_BLOB_LOG_NUM_SIGMA": 3},
    "border-box": {"DET_MIN_TH_TO_BE_PEAK": 0.3, "DET_IGNORE_POINTS_OUTSIDE_BOX": [2, 6, 6],
                   "DET_EXCLUDE_BORDER": True},
    "close-points": {"DET_MIN_TH_TO_BE_PEAK": 0.2,
                     "POST_PROCESSING": {"REMOVE_CLOSE_POINTS": True,
                                         "REMOVE_CLOSE_POINTS_RADIUS": 6.0}},
    "close-points-resolution": {"DET_MIN_TH_TO_BE_PEAK": 0.2,
                                "POST_PROCESSING": {"REMOVE_CLOSE_POINTS": True,
                                                    "REMOVE_CLOSE_POINTS_RADIUS": 6.0}},
}


@pytest.mark.parametrize("case", list(EXTRACT))
def test_extract_points_equals_jax(case):
    heat, _ = blobs(shape=(16, 48, 52), n=14, seed=9, noise=0.08)
    data = {"TEST": {"RESOLUTION": (3.0, 1.0, 1.0)}} if case.endswith("resolution") else None
    wfs = [_det_wf(cls, defaults, test=EXTRACT[case], data=data)
           for cls, defaults in ((JD.Detection_Workflow, jax_cfg_defaults),
                                 (TD.Detection_Workflow, get_cfg_defaults))]
    want = wfs[0]._extract_points(heat[..., None])
    got = wfs[1]._extract_points(heat[..., None])
    assert len(want) >= 4
    _equal(got, want)
    _equal(wfs[1]._extract_points(heat[..., None], global_post=False),
           wfs[0]._extract_points(heat[..., None], global_post=False))


# ---------------------------------------------------------------- synapses
METHODS = {
    "simpsyn": (["F_pre", "F_post"], {"F_pre": {"dilation": [1, 2, 2]},
                                      "F_post": {"dilation": [1, 3, 3]}}),
    "synful": (["F_post", "Z", "V", "H"], {"H": {"dilation": [1, 4, 4]}}),
    "synful-raw": (["F_post", "Z", "V", "H"], {"H": {"dilation": [2, 5, 5], "norm": False},
                                               "V": {"norm": False}, "Z": {"norm": False}}),
    "cleft": (["F_cleft"], {"F_cleft": {"dilation": [1, 2, 2], "n_samples": 21}}),
    "F_post_only": (["F_post"], {}),
}


@pytest.fixture(scope="module")
def cremi(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cremi") / "vol.zarr")
    pres, posts = _make_cremi(path, shape=(16, 64, 64), n_syn=7, seed=12)
    return path, pres, posts


def test_synapse_gt_points_equal_jax(cremi):
    path = cremi[0]
    kw = dict(partners_path="annotations.partners")
    got, want = TS.load_synapse_gt_points(path, **kw), JS.load_synapse_gt_points(path, **kw)
    assert sorted(got) == sorted(want) and got["resolution"] == want["resolution"]
    for k in ("pre", "post", "cleft"):
        _equal(np.asarray(got[k]), np.asarray(want[k]))
    _equal(np.asarray(got["pairs"]), np.asarray(want["pairs"]))
    for r in ((1, 2, 2), (0, 3, 1)):
        _equal(TS.generate_ellipse_footprint(r), JS.generate_ellipse_footprint(r))
    for ch in (["F_pre", "F_post"], ["F_post", "Z", "V", "H"], ["F_cleft"], ["F_post"]):
        assert TS.select_synapse_method(ch) == JS.select_synapse_method(ch)


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("method", list(METHODS))
def test_synapse_channel_zarr_is_byte_equal(tmp_path, cremi, method):
    codes, opts = METHODS[method]
    zi = {"partners_path": "annotations.partners"}
    out = {}
    for side, mod in (("jax", JS), ("torch", TS)):
        p = mod.synapse_channel_creation(cremi[0], str(tmp_path / f"{side}.zarr"), codes,
                                         opts, zarr_info=zi)
        out[side] = _tree_bytes(p)
    assert ".zarray" in out["torch"] and len(out["torch"]) >= 2
    assert out["torch"] == out["jax"]


def _oracle(path, codes, opts, tmp):
    """The compiled channels, smoothed so that each blob has one peak: the
    'prediction' of a perfect model."""
    from scipy import ndimage

    from biapy_tpu.data.zarr_store import ZarrArray

    zi = {"partners_path": "annotations.partners"}
    src = np.asarray(ZarrArray(JS.synapse_channel_creation(path, tmp, codes, opts,
                                                           zarr_info=zi)), np.float32)
    for c, code in enumerate(codes):
        if code.startswith("F_"):
            s = ndimage.gaussian_filter(src[..., c], 1.0)
            src[..., c] = s / max(s.max(), 1e-8)
    return src


def test_synapse_point_helpers_equal_jax(tmp_path, cremi):
    pred = _oracle(cremi[0], *METHODS["simpsyn"], str(tmp_path / "o.zarr"))
    for kw in (dict(min_th_to_be_peak=0.5, min_distance=2),
               dict(min_th_to_be_peak=0.4, relative_th_value=True, exclude_border=True),
               dict(point_creation_func="blob_log", min_th_to_be_peak=20.0, min_sigma=1,
                    max_sigma=2, num_sigma=2)):
        (tr, tc), (jr, jc) = [mod.extract_points_in_predictions(
            pred[..., 0], "pre", out_dir=str(tmp_path / side), **kw)
            for side, mod in (("t", TS), ("j", JS))]
        assert tr == jr and len(tr) > 0
        _equal(tc, jc)
    (_, pre), (_, post) = [TS.extract_points_in_predictions(pred[..., c], "x",
                                                            min_th_to_be_peak=0.5)
                           for c in (0, 1)]
    assert TS.connect_pre_post_points_by_distance(pre, post, out_dir=str(tmp_path / "t")) == \
        JS.connect_pre_post_points_by_distance(pre, post, out_dir=str(tmp_path / "j"))
    for f in ("pred_pre_locations.csv", "pre_post_mapping.csv"):
        assert open(tmp_path / "t" / f).read() == open(tmp_path / "j" / f).read()
    # the port finds the closest pres with a k-d tree: ties in the distances
    # (small integer grids), float coordinates
    rng = np.random.default_rng(13)
    for pre, post in ((rng.integers(0, 6, (300, 3)), rng.integers(0, 6, (500, 3))),
                      (rng.integers(0, 40, (900, 3)), rng.integers(0, 40, (700, 3))),
                      (rng.uniform(0, 30, (400, 3)), rng.uniform(0, 30, (600, 3)))):
        assert TS.connect_pre_post_points_by_distance(pre, post) == \
            JS.connect_pre_post_points_by_distance(pre, post)
    codes = METHODS["synful-raw"][0]
    syn = _oracle(cremi[0], *METHODS["synful-raw"], str(tmp_path / "s.zarr"))
    got = TS.extract_synful_synapses(syn, codes, out_dir=str(tmp_path / "ts"))
    want = JS.extract_synful_synapses(syn, codes, out_dir=str(tmp_path / "js"))
    assert got["pairs"] == want["pairs"] and len(got["pairs"]) >= len(cremi[2])
    _equal(got["pre"], want["pre"])
    _equal(got["post"], want["post"])
    assert _tree_bytes(str(tmp_path / "ts")) == _tree_bytes(str(tmp_path / "js"))


SYN_EXTRACT = {
    "simpsyn-manual": ("simpsyn", {"TH_TYPE": "manual", "MIN_TH_TO_BE_PEAK": 0.5,
                                   "REMOVE_CLOSE_PRE_POINTS_RADIUS": 3.0}),
    "simpsyn-auto-by-mask": ("simpsyn", {"TH_TYPE": "auto",
                                         "REMOVE_CLOSE_PRE_POINTS_RADIUS": 6.0,
                                         "REMOVE_CLOSE_POST_POINTS_RADIUS": 6.0,
                                         "REMOVE_CLOSE_POINTS_RADIUS_BY_MASK": True}),
    "simpsyn-blob_log": ("simpsyn", {"POINT_CREATION_FUNCTION": "blob_log",
                                     "MIN_TH_TO_BE_PEAK": 20.0, "BLOB_LOG_MIN_SIGMA": 1,
                                     "BLOB_LOG_MAX_SIGMA": 2}),
    "synful": ("synful-raw", {}),
    "cleft": ("cleft", {"TH_TYPE": "relative", "MIN_TH_TO_BE_PEAK": 0.5}),
    "F_post_only": ("F_post_only", {"MIN_TH_TO_BE_PEAK": 0.5,
                                    "REMOVE_CLOSE_POST_POINTS_RADIUS": 4.0}),
}


@pytest.mark.parametrize("case", list(SYN_EXTRACT))
def test_synapse_workflow_points_and_metrics_equal_jax(tmp_path, cremi, case):
    """The in-memory synapse branch of ``after_merge_patches`` fed the same
    oracle prediction: identical points, CSVs and metrics."""
    method, syn = SYN_EXTRACT[case]
    codes, opts = METHODS[method]
    pred = _oracle(cremi[0], codes, opts, str(tmp_path / "o.zarr"))
    out = {}
    for side, cls, defaults in (("jax", JaxISW, jax_cfg_defaults),
                                ("torch", TorchISW, get_cfg_defaults)):
        cfg = defaults()
        cfg.merge_from_dict({
            "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": "3D",
                        "INSTANCE_SEG": {"TYPE": "synapses", "DATA_CHANNELS": codes,
                                         "DATA_CHANNELS_EXTRA_OPTS": [opts],
                                         "SYNAPSES": syn}},
            "DATA": {"PATCH_SIZE": (8, 32, 32, 1),
                     "TEST": {"LOAD_GT": True,
                              "INPUT_ZARR_MULTIPLE_DATA_PARTNERS_PATH": "annotations.partners"}},
            "TEST": {"DET_TOLERANCE": 24},
            "PATHS": {"RESULT_DIR": {"PER_IMAGE_INSTANCES": str(tmp_path / side)}},
        })
        wf = cls.__new__(cls)
        wf.cfg, wf.nd, wf.is_3d, wf.verbose, wf.save_to_disk = cfg, 3, True, False, True
        wf.metrics_per_test_file, wf._predictions = [], []
        wf._current_test_file = cremi[0]
        wf.define_activations_and_channels()
        wf.after_merge_patches(pred, None, "vol.zarr")
        out[side] = (wf._predictions, wf.metrics_per_test_file,
                     _tree_bytes(str(tmp_path / side)))
    (tp, tm, tf), (jp, jm, jf) = out["torch"], out["jax"]
    assert tm == jm and len(tm) == 1 and tf == jf
    assert sorted(tp[0]["points"]) == sorted(jp[0]["points"])
    for k in tp[0]["points"]:
        _equal(tp[0]["points"][k], jp[0]["points"][k])
    assert any(len(v) for v in tp[0]["points"].values())


# ---------------------------------------------------------------- gather
def _gather_worker(rank, port, q):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        obj = {"pts": np.arange(3 * rank).reshape(-1, 3)} if rank else {}
        q.put((rank, all_gather_objects(obj)))
    finally:
        dist.destroy_process_group()


def test_all_gather_objects_one_process_and_two_over_gloo():
    import socket

    import torch.multiprocessing as mp

    obj = {"a": np.zeros((0, 3))}
    assert all_gather_objects(obj) == [obj]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_gather_worker, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    got = dict(q.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs)
    for rank in (0, 1):
        assert got[rank][0] == {}
        _equal(got[rank][1]["pts"], np.arange(3).reshape(-1, 3))


def test_detection_template_passes_the_configuration_check():
    """templates/detection/3d_detection.yaml as it is (its placeholder data
    paths unchecked) builds the port's detection workflow."""
    import yaml

    import biapy_tpu_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "templates/detection/3d_detection.yaml")) as f:
        cfg = yaml.safe_load(f)
    job = biapy_tpu_torch.BiaPy(cfg, result_dir="/nonexistent", name="t", silent=True,
                                check_data_paths=False, device="cpu")
    job._build_workflow()
    wf = job.workflow
    assert isinstance(wf, TD.Detection_Workflow)
    assert wf.output_channels == [1] and wf.activations == ["ce_sigmoid"]
    assert wf.cfg.DATA.TRAIN.DETECTION_MASK_DIR == "/path/to/train/y_detection_masks"
