"""Whole 2D semantic, instance and detection jobs, the port against the JAX
package.

Each job runs ``run_job()`` on both packages from the same JAX-written
initial checkpoint (``run_both``: the JAX workflow's model initialised
under ``jax.jit``, quicker on the CPU than its eager init): seeded uint8
2D TIFFs, 32 x 32 patches, float32, SGD, no worker threads, the
templates' augmentations (RANDOM_ROT, VFLIP, HFLIP), the JAX job on one
device of the test mesh, each package compiling its own copy of the
instance channels and point masks.

* semantic segmentation (``unet`` [4, 8, 16], as the 2D template's unet):
  the loss curve within 1e-4, the written prediction within 1e-4, the IoU
  within 1e-6;
* instance segmentation (``resunet`` [4, 8], the 2D template's ``F, C``
  with MEASURE_PROPERTIES): the compile caches byte-equal, the loss curve,
  the channel maps within 1e-4, the instances (REMOVE_BY_PROPERTIES on
  circularity) and the property CSV (area, perimeter, bbox) identical,
  the matching within 1e-6;
* detection (``unet`` [4, 8], CENTRAL_POINT_DILATION [2], RESOLUTION
  (1, 1), REMOVE_CLOSE_POINTS): the point masks byte-equal, the loss curve,
  the heatmap within 1e-4, the ``axis-0, axis-1`` CSVs identical, P/R/F1
  within 1e-6;
* and, unit by unit, the 2D host work equal to the JAX package's: the
  label -> channel compiler, the watershed chain with its options
  (MEASURE_PROPERTIES' 2D area, perimeter and circularity among them), the
  property table, the matching, and the point masks with a 2D
  CENTRAL_POINT_DILATION.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from biapy_tpu.config.config import get_cfg_defaults as jax_cfg_defaults
from biapy_tpu.data import post_processing as JPP
from biapy_tpu.data import pre_processing as JP
from biapy_tpu.data.tiff import read_tiff, write_tiff
from biapy_tpu.engine import base_workflow as jax_base_workflow
from biapy_tpu.engine.instance_seg import Instance_Segmentation_Workflow as JaxWF
from biapy_tpu.utils import matching as JMA
from biapy_tpu_torch.config.config import get_cfg_defaults
from biapy_tpu_torch.data import post_processing as TPP
from biapy_tpu_torch.data import pre_processing as TP
from biapy_tpu_torch.engine.instance_seg import Instance_Segmentation_Workflow as TorchWF
from biapy_tpu_torch.utils import matching as TMA
from test_torch_detection import _write_csv, blobs
from test_torch_restoration_job import records, tree_bytes
from test_torch_restoration_job import run_both as restoration_run_both

torch.set_num_threads(2)

SHAPES = {"train": ((64, 64), 2), "test": ((60, 52), 1)}


def disks(shape, n, rng, r_range=(3, 7), gap=2):
    """Seeded non-touching disks in noise: a uint8 image, uint16 labels."""
    lab = np.zeros(shape, np.uint16)
    img = np.zeros(shape, np.float32)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    centres = []
    for _ in range(400):
        if len(centres) == n:
            break
        r = int(rng.integers(*r_range))
        c = [int(rng.integers(r, s - r)) for s in shape]
        if any((c[0] - y) ** 2 + (c[1] - x) ** 2 < (r + ro + gap) ** 2 for y, x, ro in centres):
            continue
        m = (yy - c[0]) ** 2 + (xx - c[1]) ** 2 < r * r
        lab[m] = len(centres) + 1
        img += m * 0.7
        centres.append((*c, r))
    img += rng.normal(0, 0.08, shape)
    return (img * 200).clip(0, 255).astype(np.uint8), lab


def _jit_init(build):
    """``build_model`` whose module's ``init`` runs under ``jax.jit``: on the
    CPU the eager init of a U-Net takes seconds, op by op."""
    def wrapped(*args, **kwargs):
        model, kw = build(*args, **kwargs)
        init = jax.jit(lambda rngs, x, train=False: type(model).init(model, rngs, x, train=train),
                       static_argnames="train")
        object.__setattr__(model, "init", init)
        return model, kw
    return wrapped


def run_both(base, name, make_cfg):
    """The job ``name`` on both packages from one JAX-written initial
    checkpoint (``test_torch_restoration_job.run_both``), the JAX
    workflow's model initialised under ``jax.jit``; ``make_cfg(side) ->
    cfg``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base_workflow, "build_model", _jit_init(jax_base_workflow.build_model))
        return restoration_run_both(base, name, make_cfg)


def _write(root):
    rng = np.random.default_rng(13)
    seed = 40
    for split, (shape, n) in SHAPES.items():
        for d in ("x", "y", "csv"):
            os.makedirs(f"{root}/{split}/{d}")
        for i in range(n):
            img, lab = disks(shape, 10, rng)
            write_tiff(f"{root}/{split}/x/{i:03d}.tif", img)
            write_tiff(f"{root}/{split}/y/{i:03d}.tif", lab)
            heat, pts = blobs(shape, n=8, seed=seed, sigma=(2.0, 2.0), noise=0.0)
            seed += 1
            det = 30 + 180 * heat + np.random.default_rng(seed).normal(0, 12, shape)
            os.makedirs(f"{root}/{split}/det", exist_ok=True)
            write_tiff(f"{root}/{split}/det/{i:03d}.tif", det.clip(0, 255).astype(np.uint8))
            _write_csv(f"{root}/{split}/csv/{i:03d}.csv", pts.tolist(), ["axis-0", "axis-1"])


def _cfg(root, kind):
    x = "det" if kind == "detection" else "x"
    gt = {"semantic": "y", "instance": "y", "detection": "csv"}[kind]
    cfg = {
        "PROBLEM": {"TYPE": {"semantic": "SEMANTIC_SEG", "instance": "INSTANCE_SEG",
                             "detection": "DETECTION"}[kind], "NDIM": "2D"},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {
            "PATCH_SIZE": [32, 32, 1],
            "TRAIN": {"PATH": f"{root}/train/{x}", "GT_PATH": f"{root}/train/{gt}",
                      "IN_MEMORY": True},
            "VAL": {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.25},
            "TEST": {"PATH": f"{root}/test/{x}", "GT_PATH": f"{root}/test/{gt}",
                     "IN_MEMORY": True, "LOAD_GT": True, "PADDING": [4, 4]},
        },
        "AUGMENTOR": {"ENABLE": True, "RANDOM_ROT": True, "VFLIP": True, "HFLIP": True},
        "MODEL": {"ARCHITECTURE": "unet", "FEATURE_MAPS": [4, 8, 16],
                  "DROPOUT_VALUES": [0.0, 0.0, 0.0], "SAVE_CKPT_FREQ": 1},
        "TRAIN": {"ENABLE": True, "EPOCHS": 2, "BATCH_SIZE": 2, "OPTIMIZER": ["SGD"],
                  "LR": [0.02], "MIXED_PRECISION": False},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": False},
        "LOG": {"CHART_CREATION_FREQ": 0},
    }
    if kind == "instance":
        cfg["PROBLEM"]["INSTANCE_SEG"] = {"DATA_CHANNELS": ["F", "C"]}
        cfg["MODEL"].update(ARCHITECTURE="resunet", FEATURE_MAPS=[4, 8],
                            DROPOUT_VALUES=[0.0, 0.0])
        cfg["TEST"].update(MATCHING_STATS_THS=[0.3, 0.5],
                           POST_PROCESSING={"MEASURE_PROPERTIES": {
                               "ENABLE": True,
                               "EXTRA_PROPS": ["area", "perimeter", "bbox"],
                               "REMOVE_BY_PROPERTIES": {
                                   "ENABLE": True, "PROPS": [["circularity"]],
                                   "VALUES": [[0.2]], "SIGNS": [["lt"]]}}})
    elif kind == "detection":
        cfg["PROBLEM"]["DETECTION"] = {"CENTRAL_POINT_DILATION": [2]}
        cfg["MODEL"].update(FEATURE_MAPS=[4, 8], DROPOUT_VALUES=[0.0, 0.0])
        cfg["DATA"]["TEST"]["RESOLUTION"] = [1, 1]
        cfg["TEST"].update(DET_MIN_TH_TO_BE_PEAK=0.3, DET_TOLERANCE=4,
                           POST_PROCESSING={"REMOVE_CLOSE_POINTS": True,
                                            "REMOVE_CLOSE_POINTS_RADIUS": 3})
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("jobs2d"))
    roots = {side: f"{base}/{side}_data" for side in ("jax", "torch")}
    _write(roots["jax"])
    shutil.copytree(roots["jax"], roots["torch"])
    return {kind: run_both(f"{base}/{kind}", kind, lambda side, k=kind: _cfg(roots[side], k))
            | {"roots": roots} for kind in ("semantic", "instance", "detection")}


_CURVES = {"semantic": ("loss", "val_loss", "iou", "val_iou", "lr"),
           "instance": ("loss", "val_loss", "lr"),
           "detection": ("loss", "val_loss", "lr")}


@pytest.mark.parametrize("kind", sorted(_CURVES))
def test_loss_curve_matches_jax(runs, kind):
    jr, tr = records(runs[kind]["jax"], kind), records(runs[kind]["torch"], kind)
    assert [r["epoch"] for r in tr] == [r["epoch"] for r in jr] == [0, 1]
    for j, t in zip(jr, tr):
        for k in _CURVES[kind]:
            assert abs(t[k] - j[k]) <= 1e-4, (k, t[k], j[k])


@pytest.mark.parametrize("kind,channels", [("semantic", 1), ("instance", 2), ("detection", 1)])
def test_written_prediction_matches_jax(runs, kind, channels):
    preds = {side: read_tiff(os.path.join(runs[kind][side].workflow.cfg.PATHS.RESULT_DIR.PER_IMAGE,
                                          "000.tif")) for side in ("jax", "torch")}
    shape = SHAPES["test"][0] + ((channels,) if channels > 1 else ())
    assert preds["torch"].shape == preds["jax"].shape == shape
    np.testing.assert_allclose(preds["torch"], preds["jax"], atol=1e-4, rtol=0)


def test_semantic_iou_matches_jax(runs):
    j, t = (runs["semantic"][s].workflow.stats for s in ("jax", "torch"))
    assert set(t) == set(j) and "iou" in t
    assert abs(t["iou"] - j["iou"]) <= 1e-6


def test_instance_outputs_match_jax(runs):
    """The compile caches, the instances and their property CSV, and the
    matching stats."""
    r = runs["instance"]
    caches = {s: tree_bytes(f"{r['roots'][s]}/train/y_FC_11") for s in ("jax", "torch")}
    assert caches["torch"] == caches["jax"] and len(caches["torch"]) == 3
    out = {s: r[s].workflow.cfg.PATHS.RESULT_DIR.PER_IMAGE_INSTANCES for s in ("jax", "torch")}
    inst = {s: read_tiff(f"{out[s]}/000.tif") for s in out}
    assert inst["torch"].shape == inst["jax"].shape == SHAPES["test"][0]
    assert inst["torch"].max() > 0
    np.testing.assert_array_equal(inst["torch"], inst["jax"])
    props = {s: open(f"{out[s]}/000_properties.csv").read() for s in out}
    assert props["torch"] == props["jax"]
    assert props["torch"].splitlines()[0] == ("id,size,centroid-0,centroid-1,diameter,perimeter,"
                                              "area,bbox-0,bbox-1,bbox-2,bbox-3")
    js, ts = (r[s].workflow.matching_stats for s in ("jax", "torch"))
    assert [s["thresh"] for s in ts] == [s["thresh"] for s in js] == [0.3, 0.5]
    for j, t in zip(js, ts):
        for k in ("precision", "recall", "f1", "mean_matched_score", "panoptic_quality"):
            assert abs(t[k] - j[k]) <= 1e-6, (k, t[k], j[k])


def test_detection_outputs_match_jax(runs):
    """The point masks (uint8 TIFFs), the points CSVs and P/R/F1."""
    r = runs["detection"]
    masks = {s: tree_bytes(r[s].workflow.cfg.DATA.TRAIN.DETECTION_MASK_DIR)
             for s in ("jax", "torch")}
    assert masks["torch"] == masks["jax"] and {"000.tif", "001.tif"} <= set(masks["torch"])
    csvs = {}
    for s in ("jax", "torch"):
        d = os.path.join(r[s].workflow.cfg.PATHS.RESULT_DIR.PATH, "per_image_local_max_check")
        csvs[s] = {os.path.basename(p): open(p).read() for p in glob.glob(f"{d}/*.csv")}
    assert csvs["torch"] == csvs["jax"] and csvs["torch"]
    head = next(iter(csvs["torch"].values())).splitlines()[0]
    assert "axis-0" in head and "axis-1" in head and "axis-2" not in head
    js, ts = (r[s].workflow.stats for s in ("jax", "torch"))
    for k in ("det_precision", "det_recall", "det_f1"):
        assert abs(ts[k] - js[k]) <= 1e-6, (k, ts[k], js[k])


# --------------------------------------------------------------------------
# the 2D host work of the instance and detection workflows
# --------------------------------------------------------------------------
def _labels2d(seed, n=9, shape=(48, 52)):
    return disks(shape, n, np.random.default_rng(seed), gap=0)[1].astype(np.int32)


_CODES = {
    "BCD": (["B", "C", "D"], {}),
    "BP": (["B", "P"], {}),
    "FC": (["F", "C"], {"F": {"erosion": 1}, "C": {"thickness": 2}}),
    "BDc": (["B", "Dc"], {}),
    "HV": (["B", "H", "V"], {}),
    "BCWe": (["B", "C", "We"], {}),
}


@pytest.mark.parametrize("codes", list(_CODES))
def test_labels_into_channels_2d_equals_jax(codes):
    mode, extra = _CODES[codes]
    lab = _labels2d(1)[..., None]
    got = TP.labels_into_channels(lab, mode, extra)
    want = JP.labels_into_channels(lab, mode, extra)
    assert got.dtype == want.dtype and got.shape == want.shape and got.shape[:2] == (48, 52)
    np.testing.assert_array_equal(got, want)


def _workflows2d(codes, pp):
    """The two packages' instance workflows with only their channel
    definitions (no model, no data), in 2D."""
    out = []
    for cls, defaults in ((JaxWF, jax_cfg_defaults), (TorchWF, get_cfg_defaults)):
        wf = cls.__new__(cls)
        wf.cfg = defaults()
        wf.cfg.merge_from_dict({
            "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": "2D",
                        "INSTANCE_SEG": {"DATA_CHANNELS": list(codes)}},
            "DATA": {"PATCH_SIZE": (28, 28, 1)}, "TEST": {"POST_PROCESSING": pp}})
        wf.nd = 2
        wf.verbose = False
        wf.define_activations_and_channels()
        out.append(wf)
    return out


_PP = {
    "BCD": (["B", "C", "D"], {}),
    "FC-properties": (["F", "C"], {"MEASURE_PROPERTIES": {
        "ENABLE": True, "REMOVE_BY_PROPERTIES": {
            "ENABLE": True, "PROPS": [["area"], ["circularity"], ["perimeter"]],
            "VALUES": [[30], [0.6], [12]], "SIGNS": [["lt"], ["lt"], ["lt"]]}}}),
    "BP-large-blobs": (["B", "P"], {"REPARE_LARGE_BLOBS_SIZE": 150}),
    "BDc-refinement": (["B", "Dc"], {"INSTANCE_REFINEMENT": {
        "ENABLE": True, "OPERATIONS": ["fill_holes", "dilation", "clear_border"],
        "VALUES": ["none", 2, "none"]}}),
}


@pytest.mark.parametrize("case", list(_PP))
def test_instance_creation_2d_equals_jax(case):
    """The watershed chain on prediction-like maps (the compiled channels
    plus smooth seeded noise) on the native host ops in 2D."""
    from scipy import ndimage

    codes, pp = _PP[case]
    jwf, twf = _workflows2d(codes, pp)
    lab = _labels2d(2)
    chans = JP.labels_into_channels(lab[..., None], codes, {})
    flat = [c for c in codes for _ in range(JP.channels_per_code(c, {}, 2))]
    for seed in range(2):
        rng = np.random.default_rng(seed)
        pred = (chans + ndimage.gaussian_filter(rng.normal(0, 0.6, chans.shape), (1, 1, 0))
                ).astype(np.float32)
        for k, c in enumerate(flat):
            if c in ("B", "F", "P", "C"):
                pred[..., k] = np.clip(pred[..., k], 0, 1)
            elif c == "D":
                pred[..., k] = np.clip(pred[..., k], -1, 1)
        got, want = twf.instance_seg_process(pred), jwf.instance_seg_process(pred)
        assert got.dtype == want.dtype and got.shape == (48, 52)
        np.testing.assert_array_equal(got, want)
        assert got.max() > 0


def test_properties_and_matching_2d_equal_jax(tmp_path):
    """MEASURE_PROPERTIES' 2D table (area, perimeter, circularity,
    elongation, bbox, with a resolution) and the CSV, and the matching."""
    gt = _labels2d(4)
    extras = ["area", "perimeter", "circularity", "elongation", "bbox"]
    got = TPP.measure_instance_properties(gt, (0.5, 2.0), extras)
    want = JPP.measure_instance_properties(gt, (0.5, 2.0), extras)
    assert sorted(got) == sorted(want)
    assert {"area", "perimeter", "circularity"} <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    csvs = []
    for mod, name in ((TPP, "t.csv"), (JPP, "j.csv")):
        mod.instance_properties_csv(gt, str(tmp_path / name), (0.5, 2.0), extras)
        csvs.append((tmp_path / name).read_text())
    assert csvs[0] == csvs[1]
    pred = np.roll(gt, 2, axis=1)
    pred[pred == 3] = 0
    assert (TMA.matching(gt, pred, thresh=[0.3, 0.5, 0.75], report_matches=True)
            == JMA.matching(gt, pred, thresh=[0.3, 0.5, 0.75], report_matches=True))


@pytest.mark.parametrize("dilation", [[3], [2, 3]])
def test_detection_masks_2d_equal_jax(dilation):
    """CENTRAL_POINT_DILATION in 2D (one value or one per axis); points
    outside the image are skipped."""
    pts = np.array([[3, 4], [20, 30], [47, 51], [50, 10], [0, 0]])
    got = TP.create_detection_masks(pts, (48, 52), dilation)
    want = JP.create_detection_masks(pts, (48, 52), dilation)
    assert got.shape == want.shape == (48, 52, 1)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# chip_smoke.py's phase-3 rows for phase 16
# --------------------------------------------------------------------------
@pytest.mark.parametrize("key", ["semantic", "instance", "detection", "denoising",
                                 "image_to_image", "super_resolution", "classification"])
def test_chip_smoke_2d_pool_rows_are_the_templates_shapes(tmp_path, monkeypatch, key):
    """``chip_smoke.py`` phase 3 holds the pool and its backward at the 2D
    templates' shapes (phase 16 runs them with super-resolution on
    ``unet``, classification on ``simple_cnn``): its rows must be the
    pools the template's model runs at its batch and patch (one forward at
    batch 1 here, the rows scale with the batch), each on the unit-depth
    view with window 1 x 2 x 2."""
    import sys

    import yaml

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.ops.kernels import shuffle

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    with open(os.path.join(repo, chip_smoke.TWOD_TEMPLATES[key])) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"]["ARCHITECTURE"] = {"super_resolution": "unet",
                                    "classification": "simple_cnn"}.get(
        key, raw["MODEL"]["ARCHITECTURE"])
    job = BiaPy(raw, result_dir=str(tmp_path), name="t", silent=True, check_data_paths=False,
                device="cpu")
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    cfg = wf.cfg
    seen = []
    pool_plain = shuffle.pool_max_folded_plain
    monkeypatch.setattr(shuffle, "pool_max_folded_plain", lambda x, win: (
        seen.append((tuple(x.shape), tuple(win))), pool_plain(x, win))[1])
    with torch.no_grad():
        wf.model(torch.zeros((1,) + tuple(int(v) for v in cfg.DATA.PATCH_SIZE)))
    bs = int(cfg.TRAIN.BATCH_SIZE)
    want = [((bs,) + shape[1:], win) for shape, win in seen]
    assert want == chip_smoke.TWOD_POOLS.get(key, [])
    assert all(win == (1, 2, 2) for _, win in seen)
