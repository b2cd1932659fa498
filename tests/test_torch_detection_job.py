"""Whole point-detection jobs, the port against the JAX package.

* A tiny 3D detection job (DET_WATERSHED on): seeded TIFF volumes of Gaussian blobs with CSV
  GT points, ``resunet`` [4, 8], 16 x 32 x 32 patches, ``run_job()`` on
  both packages from the same JAX-written initial checkpoint (the Flax
  parameter import), float32, no worker threads, the JAX job on one device
  of the test mesh, each package compiling its own copy of the point masks.
  The mask caches are byte-equal; the loss curve agrees within 1e-4 (the
  instance job's tolerance, tests/test_torch_instance_job.py); the
  ``_points.csv`` files and the DET_WATERSHED instance TIFFs are identical
  and the metrics equal within 1e-6.
* The same job's best checkpoint tested by chunks on a small Zarr with
  WORKFLOW_PROCESS on, in both packages: identical per-tile and merged
  point CSVs and metrics.
* Synapses by chunks with the compiled GT channels (smoothed) as the
  prediction, as ``tests/test_synapses.py::test_synapse_by_chunks`` does, for
  each synapse method: the same pre/post/cleft points, pairs and metrics.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.data.tiff import write_tiff
from biapy_tpu.engine import base_workflow as jax_base_workflow
from biapy_tpu.parallel import get_mesh as jax_get_mesh
from biapy_tpu.utils.misc import save_model as jax_save_model

from test_synapses import _make_cremi
from test_torch_detection import METHODS, _oracle, _tree_bytes, _write_csv, blobs

torch.set_num_threads(2)

NAME = "det"
SHAPES = {"train": ((20, 48, 48), 2), "test": ((18, 44, 40), 1)}
CHUNK_SHAPE = (26, 60, 52)


def _volume(shape, seed):
    heat, centres = blobs(shape, n=8, seed=seed, sigma=(1.5, 2.0, 2.0), noise=0.0)
    img = 30 + 180 * heat + np.random.default_rng(seed + 50).normal(0, 12, shape)
    return img.clip(0, 255).astype(np.uint8), centres


def _write(root):
    seed = 20
    for split, (shape, n) in SHAPES.items():
        os.makedirs(f"{root}/{split}/x")
        os.makedirs(f"{root}/{split}/csv")
        for i in range(n):
            img, pts = _volume(shape, seed)
            seed += 1
            write_tiff(f"{root}/{split}/x/{i:03d}.tif", img)
            _write_csv(f"{root}/{split}/csv/{i:03d}.csv", pts.tolist(),
                       ["axis-0", "axis-1", "axis-2"])
    from biapy_tpu_torch.data.zarr_store import ZarrArray

    os.makedirs(f"{root}/chunks/x")
    os.makedirs(f"{root}/chunks/csv")
    img, pts = _volume(CHUNK_SHAPE, seed)
    z = ZarrArray.create(f"{root}/chunks/x/vol.zarr", shape=img.shape + (1,),
                         chunks=(13, 30, 26, 1), dtype="uint8",
                         compressor={"id": "zlib", "level": 1})
    z[:, :, :, :] = img[..., None]
    _write_csv(f"{root}/chunks/csv/vol.csv", pts.tolist(), ["axis-0", "axis-1", "axis-2"])


def _cfg(root):
    return {
        "PROBLEM": {"TYPE": "DETECTION", "NDIM": "3D",
                    "DETECTION": {"CENTRAL_POINT_DILATION": [1, 2, 2]}},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {
            "PATCH_SIZE": [16, 32, 32, 1],
            "TRAIN": {"PATH": f"{root}/train/x", "GT_PATH": f"{root}/train/csv",
                      "IN_MEMORY": True},
            "VAL": {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.3},
            "TEST": {"PATH": f"{root}/test/x", "GT_PATH": f"{root}/test/csv", "IN_MEMORY": True,
                     "LOAD_GT": True, "PADDING": [2, 4, 4], "RESOLUTION": [2, 1, 1]},
        },
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8],
                  "DROPOUT_VALUES": [0.0, 0.0], "Z_DOWN": [1], "SAVE_CKPT_FREQ": 1},
        "TRAIN": {"ENABLE": True, "EPOCHS": 2, "BATCH_SIZE": 2, "OPTIMIZER": ["SGD"],
                  "LR": [0.01], "MIXED_PRECISION": False},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": False, "DET_MIN_TH_TO_BE_PEAK": 0.3,
                 "DET_PEAK_LOCAL_MAX_MIN_DISTANCE": 2, "DET_TOLERANCE": 6,
                 "POST_PROCESSING": {"REMOVE_CLOSE_POINTS": True,
                                     "REMOVE_CLOSE_POINTS_RADIUS": 3, "DET_WATERSHED": True,
                                     "DET_WATERSHED_FIRST_DILATION": [1, 2, 2],
                                     "MEASURE_PROPERTIES": {"ENABLE": True, "REMOVE_BY_PROPERTIES": {
                                         "ENABLE": True, "PROPS": [["sphericity"]], "VALUES": [[0.1]],
                                         "SIGNS": [["lt"]]}}}},
        "LOG": {"CHART_CREATION_FREQ": 0},
    }


def _run(side, cfg, result_dir, test_only=False):
    if side == "jax":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_base_workflow, "get_mesh",
                       lambda spatial=1: jax_get_mesh(jax.devices()[:1]))
            job = biapy_tpu.BiaPy(cfg, result_dir=result_dir, name=NAME, silent=True)
            job.test() if test_only else job.run_job()
    else:
        job = biapy_tpu_torch.BiaPy(cfg, result_dir=result_dir, name=NAME, silent=True,
                                    device="cpu")
        job.test() if test_only else job.run_job()
    return job


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("det"))
    roots = {side: f"{base}/{side}_data" for side in ("jax", "torch")}
    _write(roots["jax"])
    shutil.copytree(roots["jax"], roots["torch"])
    init = biapy_tpu.BiaPy(_cfg(roots["jax"]), result_dir=f"{base}/init", name=NAME,
                           silent=True)
    init._build_workflow()
    init.workflow.prepare_model()
    st = init.workflow.state
    init_ckpt = jax_save_model(init.workflow.cfg, f"{base}/init", "init",
                               jax.tree.map(np.asarray, st.params), 0,
                               jax.tree.map(np.asarray, st.batch_stats))
    jobs = {}
    for side in ("jax", "torch"):
        cfg = _cfg(roots[side])
        cfg["MODEL"].update(LOAD_CHECKPOINT=True, ITEMS_TO_LOAD_FROM_CHECKPOINT=["weights"])
        cfg["PATHS"] = {"CHECKPOINT_FILE": init_ckpt}
        jobs[side] = _run(side, cfg, f"{base}/{side}")
    # by chunks: the JAX job's best checkpoint on each side
    best = f"{jobs['jax'].job_dir}/checkpoints/{NAME}-checkpoint-best.ckpt"
    chunks = {}
    for side in ("jax", "torch"):
        cfg = _cfg(roots[side])
        cfg["TRAIN"]["ENABLE"] = False
        cfg["MODEL"]["LOAD_CHECKPOINT"] = True
        cfg["PATHS"] = {"CHECKPOINT_FILE": best}
        cfg["DATA"]["TEST"].update(PATH=f"{roots[side]}/chunks/x",
                                   GT_PATH=f"{roots[side]}/chunks/csv", IN_MEMORY=False)
        cfg["TEST"]["BY_CHUNKS"] = {"ENABLE": True,
                                    "WORKFLOW_PROCESS": {"ENABLE": True,
                                                         "PATCHES_PER_TILE": [1, 2, 1]}}
        chunks[side] = _run(side, cfg, f"{base}/chunks_{side}", test_only=True)
    return dict(base=base, roots=roots, chunks=chunks, **jobs)


def test_point_mask_caches_are_byte_equal(runs):
    caches = {side: _tree_bytes(f"{runs['roots'][side]}/train/y_detection_masks")
              for side in runs["roots"]}
    assert sorted(caches["torch"]) == ["000.tif", "001.tif"]
    assert caches["torch"] == caches["jax"]
    assert runs["torch"].workflow.cfg.DATA.TRAIN.GT_PATH == \
        f"{runs['roots']['torch']}/train/y_detection_masks"


def _records(job):
    with open(f"{job.cfg.LOG.LOG_DIR}/{NAME}_train.jsonl") as f:
        return [json.loads(line) for line in f]


def test_loss_curve_matches_jax(runs):
    jr, tr = _records(runs["jax"]), _records(runs["torch"])
    assert [r["epoch"] for r in tr] == [r["epoch"] for r in jr] == [0, 1]
    for j, t in zip(jr, tr):
        for k in ("loss", "val_loss", "iou", "val_iou", "lr"):
            assert abs(t[k] - j[k]) <= 1e-4, (k, t[k], j[k])
    assert tr[1]["loss"] < tr[0]["loss"]


def test_points_csv_watershed_and_metrics_match_jax(runs):
    out = {}
    for side in ("jax", "torch"):
        wf = runs[side].workflow
        out[side] = (_tree_bytes(wf.cfg.PATHS.RESULT_DIR.DET_LOCAL_MAX_COORDS_CHECK), wf.stats,
                     _tree_bytes(wf.cfg.PATHS.WATERSHED_DIR))
    (tf, ts, tw), (jf, js, jw) = out["torch"], out["jax"]
    assert list(tf) == ["000_points.csv"] and tf == jf
    # DET_WATERSHED grows instances from the points over the raw test image
    assert list(tw) == ["000.tif"] and tw == jw
    assert tf["000_points.csv"].count(b"\n") > 3  # header and points
    assert sorted(ts) == sorted(js) and "det_f1" in ts
    for k in ts:
        assert abs(ts[k] - js[k]) <= 1e-6, (k, ts[k], js[k])


def test_detection_by_chunks_points_match_jax(runs):
    out = {}
    for side in ("jax", "torch"):
        wf = runs["chunks"][side].workflow
        R = wf.cfg.PATHS.RESULT_DIR
        out[side] = (_tree_bytes(R.DET_LOCAL_MAX_COORDS_CHECK),
                     _tree_bytes(R.DET_LOCAL_MAX_COORDS_CHECK_POST_PROCESSING),
                     wf.metrics_per_test_file,
                     [p["points"] for p in wf._predictions if p["role"] == "points"])
    (t_tiles, t_all, tm, tp), (j_tiles, j_all, jm, jp) = out["torch"], out["jax"]
    assert len(t_tiles) == 18 and t_tiles == j_tiles  # 3 x 2 x 3 tiles of 12 x 48 x 24
    assert list(t_all) == ["vol_all_points.csv"] and t_all == j_all
    assert len(tp) == 1 and len(tp[0]) > 3
    np.testing.assert_array_equal(tp[0], jp[0])
    assert len(tm) == 1 and tm == jm


@pytest.mark.parametrize("method", ["simpsyn", "synful-raw", "cleft", "F_post_only"])
def test_synapses_by_chunks_match_jax(tmp_path, method):
    """Oracle channels as the raw prediction: per-tile extraction with core
    ownership, the merge, close-point removal, the pairing and the metrics
    of both packages."""
    from biapy_tpu.config.config import get_cfg_defaults as jax_cfg_defaults
    from biapy_tpu.data.zarr_store import ZarrArray
    from biapy_tpu.engine.chunked import ChunkedInference as JaxCI
    from biapy_tpu.engine.instance_seg import Instance_Segmentation_Workflow as JaxWF
    from biapy_tpu_torch.config.config import get_cfg_defaults
    from biapy_tpu_torch.engine.chunked import ChunkedInference as TorchCI
    from biapy_tpu_torch.engine.instance_seg import Instance_Segmentation_Workflow as TorchWF

    codes, opts = METHODS[method]
    vol = str(tmp_path / "vol.zarr")
    _make_cremi(vol, shape=(32, 96, 96), n_syn=8, seed=11)
    src = _oracle(vol, codes, opts, str(tmp_path / "chan.zarr"))
    raw_path = str(tmp_path / "raw_pred.zarr")
    raw = ZarrArray.create(raw_path, shape=src.shape, chunks=(16, 48, 48, src.shape[-1]),
                           dtype="f4", compressor={"id": "zlib", "level": 1})
    raw[:, :, :, :] = src
    out = {}
    for side, cls, defaults, ci_cls in (("jax", JaxWF, jax_cfg_defaults, JaxCI),
                                        ("torch", TorchWF, get_cfg_defaults, TorchCI)):
        res = str(tmp_path / side)
        cfg = defaults()
        cfg.merge_from_dict({
            "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": "3D",
                        "INSTANCE_SEG": {"TYPE": "synapses", "DATA_CHANNELS": codes,
                                         "DATA_CHANNELS_EXTRA_OPTS": [opts],
                                         "SYNAPSES": {"TH_TYPE": "manual",
                                                      "MIN_TH_TO_BE_PEAK": 0.5,
                                                      "REMOVE_CLOSE_PRE_POINTS_RADIUS": 3.0,
                                                      "REMOVE_CLOSE_POST_POINTS_RADIUS": 3.0}}},
            "DATA": {"PATCH_SIZE": (16, 32, 32, 1),
                     "TEST": {"LOAD_GT": True,
                              "INPUT_ZARR_MULTIPLE_DATA_PARTNERS_PATH": "annotations.partners"}},
            "TEST": {"DET_TOLERANCE": 24,
                     "BY_CHUNKS": {"ENABLE": True, "WORKFLOW_PROCESS": {"ENABLE": True}}},
            "PATHS": {"RESULT_DIR": {"PER_IMAGE_INSTANCES": f"{res}/all",
                                     "DET_LOCAL_MAX_COORDS_CHECK": f"{res}/tiles"}},
        })
        wf = cls.__new__(cls)
        wf.cfg, wf.nd, wf.is_3d, wf.verbose, wf.save_to_disk = cfg, 3, True, False, True
        wf.metrics_per_test_file, wf._predictions = [], []
        wf._current_test_file = vol
        wf.define_activations_and_channels()
        ci = ci_cls(wf, (16, 32, 32), (0, 0, 0), (2, 4, 4), (1, 1, 1), len(codes), res)
        wf.after_by_chunks_prediction(ci, raw_path, "vol")
        out[side] = (wf._predictions, wf.metrics_per_test_file, _tree_bytes(res))
    (tp, tm, tf), (jp, jm, jf) = out["torch"], out["jax"]
    assert len(tm) == 1 and tm == jm
    assert len(tf) > 8 and tf == jf
    assert sorted(tp[0]["points"]) == sorted(jp[0]["points"])
    for k, v in tp[0]["points"].items():
        np.testing.assert_array_equal(v, jp[0]["points"][k])
    # the oracle recovers the annotations (synful's pres are projections,
    # clustered: not every one lands within the tolerance)
    assert all(v == 1.0 for k, v in tm[0].items()
               if k.startswith("recall") and not (method.startswith("synful") and "pre" in k)), tm
