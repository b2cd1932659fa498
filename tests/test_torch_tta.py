"""Test-time augmentation and the rest of the per-image test path, the port
against the JAX package, on the CPU.

Both packages load one JAX-written checkpoint (a seeded model with
non-trivial BatchNorm statistics, resunet 4/8, patch 16^3, float32) and run
``test()`` on one TIFF volume with its mask: test-time augmentation
(``TEST.AUGMENTATION_MODE`` mean/min/max, ``TEST.AUGMENTATION_GROUP``
full/flips) on the host crop/merge path, ``DATA.TEST.ROI_MASK``,
``TEST.REUSE_PREDICTIONS`` and ``TEST.POST_PROCESSING.MEDIAN_FILTER``; then a
by-chunks run with test-time augmentation on a small Zarr. The predictions
agree within 1e-4 (float32 sums in other orders), the uint8 stores within
one LSB. Under ``TEST.REDUCE_MEMORY`` the port predicts with its bf16
inference copy where the JAX package keeps float32 weights on bf16 inputs:
held at the bf16 tolerance of the serving path (5e-2 worst, 5e-3 mean).
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.data.tiff import read_tiff, write_tiff
from biapy_tpu.engine import base_workflow as jax_base_workflow
from biapy_tpu.parallel import get_mesh as jax_get_mesh
from biapy_tpu.utils.misc import save_model as jax_save_model
from biapy_tpu_torch.data import zarr_store as tzs
from biapy_tpu_torch.models.flax_import import export_flax_variables

from test_torch_chunked import _chunks_cfg, _write_zarr

torch.set_num_threads(2)

NAME = "tta"
VOL = (14, 26, 22)


def _cfg(root, ckpt):
    return {
        "PROBLEM": {"TYPE": "SEMANTIC_SEG", "NDIM": "3D"},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {"PATCH_SIZE": [16, 16, 16, 1],
                 "TEST": {"PATH": f"{root}/test/x", "GT_PATH": f"{root}/test/y", "LOAD_GT": True,
                          "IN_MEMORY": False, "PADDING": [2, 2, 2],
                          "OVERLAP": [0.0, 0.25, 0.0]}},
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8], "DROPOUT_VALUES": [0.0, 0.0],
                  "Z_DOWN": [2], "YX_DOWN": [2], "CONV_LAYERS": [2, 2], "NORMALIZATION": "bn",
                  "ACTIVATION": "elu", "LOAD_CHECKPOINT": True},
        "PATHS": {"CHECKPOINT_FILE": ckpt},
        "TRAIN": {"ENABLE": False, "BATCH_SIZE": 8},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": False, "OUTPUT_QUANT_UINT8": False,
                 "AUGMENTATION": True},
    }


def _one_device(mp):
    # the port runs on one card: the JAX jobs on one device of the test mesh
    mp.setattr(jax_base_workflow, "get_mesh", lambda spatial=1: jax_get_mesh(jax.devices()[:1]))
    mp.setattr(jax, "local_devices", lambda *a, **k: jax.devices()[:1])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tta"))
    rng = np.random.default_rng(6)
    for d in ("x", "y"):
        os.makedirs(f"{root}/test/{d}")
    img = rng.integers(0, 256, VOL, dtype=np.uint8)
    write_tiff(f"{root}/test/x/vol.tif", img)
    write_tiff(f"{root}/test/y/vol.tif", ((img > 120) * 255).astype(np.uint8))
    # an ROI: a box in the middle of the volume
    roi = np.zeros(VOL, np.uint8)
    roi[3:11, 6:20, 5:16] = 1
    os.makedirs(f"{root}/roi")
    write_tiff(f"{root}/roi/vol.tif", roi)
    init_cfg = _cfg(root, "")
    init_cfg["MODEL"]["LOAD_CHECKPOINT"] = False
    init_cfg["TRAIN"]["ENABLE"] = True
    init = biapy_tpu_torch.BiaPy(init_cfg, result_dir=f"{root}/init", name=NAME, silent=True,
                                 check_data_paths=False, device="cpu")
    init._build_workflow()
    init.workflow.prepare_model()
    params, stats = export_flax_variables(init.workflow.model)
    stats = jax.tree.map(lambda a: a + rng.random(a.shape).astype(np.float32) * 0.3, stats)
    ckpt = jax_save_model(init.workflow.cfg, f"{root}/init", "init", params, 0, stats)
    jobs = {}
    with pytest.MonkeyPatch.context() as mp:
        _one_device(mp)
        jobs["jax"] = biapy_tpu.BiaPy(_cfg(root, ckpt), result_dir=f"{root}/jax", name=NAME,
                                      silent=True)
        jobs["jax"]._build_workflow()
    jobs["torch"] = biapy_tpu_torch.BiaPy(_cfg(root, ckpt), result_dir=f"{root}/torch", name=NAME,
                                          silent=True, device="cpu")
    jobs["torch"]._build_workflow()
    return dict(root=root, ckpt=ckpt, jobs=jobs)


def _run(setup, case, **keys):
    """Set ``keys`` ("TEST.AUGMENTATION_MODE": "min", ...) on both
    workflows' configs, write this case's results to directories of its own
    (unless it reuses a case's), run ``test()``; the raw prediction, the
    binarised TIFF written and the IoU of each package."""
    out = {}
    for side, job in setup["jobs"].items():
        wf = job.workflow
        cfg = wf.cfg
        cfg.defrost()
        base = f"{setup['root']}/{side}/results"
        r = cfg.PATHS.RESULT_DIR
        r.PER_IMAGE, r.PER_IMAGE_BIN = f"{base}/{case}/raw", f"{base}/{case}/bin"
        for k, v in keys.items():
            node = cfg
            *path, leaf = k.split(".")
            for p in path:
                node = getattr(node, p)
            setattr(node, leaf, v)
        cfg.freeze()
        with pytest.MonkeyPatch.context() as mp:
            _one_device(mp)
            wf.test()
        (pred,) = [p["pred"] for p in wf._predictions if p["role"] == "raw"]
        out[side] = dict(pred=np.asarray(pred, np.float32), iou=wf.stats["iou"],
                         bin=read_tiff(f"{r.PER_IMAGE_BIN}/vol.tif"))
    return out["jax"], out["torch"]


@pytest.mark.parametrize("mode,group", [
    ("mean", "full"), ("min", "full"), ("max", "full"),
    ("mean", "flips"), ("min", "flips"), ("max", "flips")])
def test_tta_per_image_matches_jax(setup, mode, group):
    j, t = _run(setup, f"tta_{mode}_{group}", **{"TEST.AUGMENTATION_MODE": mode,
                                                  "TEST.AUGMENTATION_GROUP": group})
    assert t["pred"].shape == j["pred"].shape == VOL + (1,)
    np.testing.assert_allclose(t["pred"], j["pred"], rtol=0, atol=1e-4)
    assert abs(t["iou"] - j["iou"]) <= 1e-4
    # the ensemble is not the identity's prediction alone
    assert t["pred"].std() > 0


def test_roi_mask_matches_jax(setup):
    j, t = _run(setup, "roi", **{"TEST.AUGMENTATION_MODE": "mean", "TEST.AUGMENTATION_GROUP": "flips",
                                 "DATA.TEST.ROI_MASK.ENABLE": True,
                                 "DATA.TEST.ROI_MASK.PATH": f"{setup['root']}/roi"})
    np.testing.assert_allclose(t["pred"], j["pred"], rtol=0, atol=1e-4)
    roi = read_tiff(f"{setup['root']}/roi/vol.tif")
    assert not t["pred"][roi == 0].any() and t["pred"][roi > 0].any()
    assert abs(t["iou"] - j["iou"]) <= 1e-4


def test_reuse_predictions_matches_jax(setup):
    """A second pass with TEST.REUSE_PREDICTIONS reads the first pass's
    saved prediction back and recomputes the metrics."""
    first = _run(setup, "reuse", **{"TEST.AUGMENTATION_MODE": "max",
                                    "TEST.AUGMENTATION_GROUP": "flips"})
    j, t = _run(setup, "reuse", **{"TEST.REUSE_PREDICTIONS": True})
    for side, (a, b) in (("jax", (first[0], j)), ("torch", (first[1], t))):
        np.testing.assert_array_equal(b["pred"], a["pred"], err_msg=side)
        assert b["iou"] == a["iou"], side
    np.testing.assert_allclose(t["pred"], j["pred"], rtol=0, atol=1e-4)
    assert abs(t["iou"] - j["iou"]) <= 1e-4
    with pytest.raises(FileNotFoundError, match="REUSE_PREDICTIONS"):
        _run(setup, "reuse_missing")
    for side in ("jax", "torch"):  # later cases predict again
        cfg = setup["jobs"][side].workflow.cfg
        cfg.defrost()
        cfg.TEST.REUSE_PREDICTIONS = False
        cfg.freeze()


def test_median_filter_matches_jax(setup):
    """TEST.POST_PROCESSING.MEDIAN_FILTER filters the prediction the
    binarised TIFF is made from; the raw prediction stays as it was."""
    j, t = _run(setup, "median", **{"TEST.AUGMENTATION": False,
                                    "TEST.POST_PROCESSING.MEDIAN_FILTER": True,
                                    "TEST.POST_PROCESSING.MEDIAN_FILTER_AXIS": ["zyx"],
                                    "TEST.POST_PROCESSING.MEDIAN_FILTER_SIZE": [3]})
    np.testing.assert_allclose(t["pred"], j["pred"], rtol=0, atol=1e-4)
    assert np.abs(t["bin"].astype(int) - j["bin"].astype(int)).max() <= 1
    assert np.count_nonzero(t["bin"] != j["bin"]) <= 1e-3 * t["bin"].size
    unfiltered = (t["pred"][..., 0] > 0.5).astype(np.uint8)
    assert not np.array_equal(t["bin"], unfiltered)


def test_test_side_preprocessing_matches_jax(setup):
    """DATA.PREPROCESS.TEST (a blur) on each test image read from disk."""
    j, t = _run(setup, "preprocess", **{"TEST.AUGMENTATION": False,
                                        "TEST.POST_PROCESSING.MEDIAN_FILTER": False,
                                        "DATA.PREPROCESS.TEST": True,
                                        "DATA.PREPROCESS.GAUSSIAN_BLUR.ENABLE": True})
    np.testing.assert_allclose(t["pred"], j["pred"], rtol=0, atol=1e-4)
    assert abs(t["iou"] - j["iou"]) <= 1e-4
    first = _run(setup, "no_preprocess", **{"DATA.PREPROCESS.TEST": False})
    assert not np.allclose(first[1]["pred"], t["pred"], atol=1e-3)


def test_tta_bf16_inference_copy_against_jax(tmp_path, setup):
    """Under TEST.REDUCE_MEMORY the port's host path predicts with the pass's
    bf16 model copy (the JAX package: float32 weights on bf16 inputs)."""
    root = setup["root"]
    cfg = _cfg(root, setup["ckpt"])
    # the JAX host path returns bf16 predictions, which its TIFF writer
    # refuses: no raw output is written on either side
    cfg["TEST"].update(REDUCE_MEMORY=True, AUGMENTATION_GROUP="flips",
                       SAVE_MODEL_RAW_OUTPUT=False)
    preds = []
    with pytest.MonkeyPatch.context() as mp:
        _one_device(mp)
        jjob = biapy_tpu.BiaPy(copy.deepcopy(cfg), result_dir=str(tmp_path / "jax"), name=NAME,
                               silent=True)
        jjob._build_workflow()
        jjob.workflow.test()
        preds.append(jjob.workflow._predictions[0]["pred"])
    tjob = biapy_tpu_torch.BiaPy(copy.deepcopy(cfg), result_dir=str(tmp_path / "torch"), name=NAME,
                                 silent=True, device="cpu")
    tjob._build_workflow()
    tjob.workflow.test()
    preds.append(tjob.workflow._predictions[0]["pred"])
    diff = np.abs(np.asarray(preds[1], np.float32) - np.asarray(preds[0], np.float32))
    assert float(diff.max()) <= 5e-2 and float(diff.mean()) <= 5e-3


@pytest.fixture(scope="module")
def chunk_stores(setup, tmp_path_factory):
    """TEST.BY_CHUNKS with TEST.AUGMENTATION (every tile on the host
    crop/merge path) in both packages, float32 then uint8 stores: a second
    test pass of each workflow with TEST.OUTPUT_QUANT_UINT8 set."""
    root = str(tmp_path_factory.mktemp("tta_chunks"))
    os.makedirs(f"{root}/test")
    vol = np.random.default_rng(8).integers(0, 256, (14, 30, 26, 1), dtype=np.uint8)
    _write_zarr(f"{root}/test/vol.zarr", vol, (24, 24, 24, 1))
    cfg = _chunks_cfg(root, setup["ckpt"], False)
    cfg["TEST"].update(AUGMENTATION=True, AUGMENTATION_GROUP="flips")
    stores = {}
    for side, pkg, kw in (("jax", biapy_tpu, {}), ("torch", biapy_tpu_torch, {"device": "cpu"})):
        with pytest.MonkeyPatch.context() as mp:
            _one_device(mp)
            job = pkg.BiaPy(copy.deepcopy(cfg), result_dir=f"{root}/{side}", name=NAME,
                            silent=True, **kw)
            job.run_job()
            c = job.workflow.cfg
            stores[side, "f32"] = c.PATHS.RESULT_DIR.PER_IMAGE
            c.defrost()
            c.TEST.OUTPUT_QUANT_UINT8 = True
            c.PATHS.RESULT_DIR.PER_IMAGE += "_uint8"
            c.freeze()
            job.workflow.test()
            stores[side, "uint8"] = c.PATHS.RESULT_DIR.PER_IMAGE
    return vol.shape, stores


@pytest.mark.parametrize("store", ["f32", "uint8"])
def test_by_chunks_tta_matches_jax(chunk_stores, store):
    """``raw_pred.zarr`` of the by-chunks run with test-time augmentation
    within 1e-4, or 1 LSB in uint8."""
    shape, stores = chunk_stores
    j, t = (tzs.ZarrArray(f"{stores[side, store]}/vol_chunks/raw_pred.zarr")
            for side in ("jax", "torch"))
    assert t.shape == j.shape == shape and t.dtype == j.dtype
    assert t.dtype == (np.uint8 if store == "uint8" else np.float32)
    a, b = np.asarray(t[:]).astype(np.float64), np.asarray(j[:]).astype(np.float64)
    assert float(np.abs(a - b).max()) <= (1 if store == "uint8" else 1e-4)
    assert a.std() > 0


def test_median_filter_on_a_2d_stack_matches_jax(setup, tmp_path):
    """With TEST.ANALIZE_2D_IMGS_AS_3D_STACK the 2D predictions are stacked
    and median-filtered along z, and the stack is written. The port runs 3D
    models only (2D comes with ROADMAP queue 1 item 10), so the hook is held
    on workflows switched to 2D after they are built."""
    preds = np.random.default_rng(9).random((5, 12, 10, 1)).astype(np.float32)
    out = {}
    for side, pkg, kw in (("jax", biapy_tpu, {}), ("torch", biapy_tpu_torch, {"device": "cpu"})):
        job = pkg.BiaPy(_cfg(setup["root"], setup["ckpt"]), result_dir=str(tmp_path / side),
                        name=NAME, silent=True, **kw)
        job._build_workflow()
        wf = job.workflow
        wf.is_3d = False
        cfg = wf.cfg
        cfg.defrost()
        cfg.TEST.ANALIZE_2D_IMGS_AS_3D_STACK = True
        pp = cfg.TEST.POST_PROCESSING
        pp.MEDIAN_FILTER, pp.MEDIAN_FILTER_AXIS, pp.MEDIAN_FILTER_SIZE = True, ["z"], [3]
        cfg.freeze()
        wf._predictions = [{"role": "raw", "pred": p} for p in preds]
        wf.after_all_images()
        stack = wf._predictions[-1]
        assert stack["role"] == "as_3d_stack"
        out[side] = (stack["pred"], read_tiff(f"{cfg.PATHS.RESULT_DIR.AS_3D_STACK}/stack.tif"))
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    assert not np.array_equal(out["torch"][0], preds)
