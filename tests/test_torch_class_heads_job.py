"""Whole jobs with the class heads (DATA.N_CLASSES > 2), the port against
the JAX package.

Each job runs ``run_job()`` on both packages from one JAX-written initial
checkpoint (``tests/test_torch_2d_job.py::run_both``: float32, SGD, no
worker threads, the JAX job on one device of the test mesh), each package
compiling its own copy of the data:

* 3D instances (B, C, D, resunet [4, 8]) with a class head: GT labels
  beside a class map, the class head's trailing DATA_CHANNEL_WEIGHTS entry;
  the loss curve within 1e-4, the channel maps and class probabilities
  within 1e-4, the instances and their voted classes identical, the class
  IoU and the matching within 1e-6;
* detection with a ``class`` column in the CSVs, in 2D in memory and in 3D
  by chunks (with separated decoders): the masks with their class channel
  byte-equal, the loss curve within 1e-4, the point CSVs (per tile and
  merged) with their class columns identical, the points and classes
  equal, the metrics with their class-aware ones within 1e-6.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from biapy_tpu.data.tiff import read_tiff, write_tiff

from test_torch_2d_job import run_both
from test_torch_class_heads import N_CLASSES, _equal
from test_torch_detection import _write_csv, blobs
from test_torch_instance import spheres
from test_torch_restoration_job import records, tree_bytes

torch.set_num_threads(2)

INST_NAME, DET_NAME = "inst_cls", "det_cls"


def _write_instance(root):
    rng = np.random.default_rng(80)
    for split, n, shape in (("train", 2, (16, 40, 40)), ("test", 1, (14, 36, 40))):
        for d in ("x", "y"):
            os.makedirs(f"{root}/{split}/{d}")
        for i in range(n):
            img, lab = spheres(shape, 8, rng)
            cls = np.zeros_like(lab)
            imgf = img.astype(np.float32)
            for k in range(1, int(lab.max()) + 1):
                c = 1 + int(rng.integers(0, 2))
                cls[lab == k] = c
                imgf[lab == k] += 40.0 * (c - 1)  # class 2 brighter
            write_tiff(f"{root}/{split}/x/{i:03d}.tif", imgf.clip(0, 255).astype(np.uint8))
            write_tiff(f"{root}/{split}/y/{i:03d}.tif", np.stack([lab, cls], axis=-1))


def _instance_cfg(root):
    return {
        "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": "3D",
                    "INSTANCE_SEG": {"DATA_CHANNELS": ["B", "C", "D"],
                                     "DATA_CHANNEL_WEIGHTS": [1.0, 1.0, 1.0, 0.5]}},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {
            "PATCH_SIZE": [8, 32, 32, 1], "N_CLASSES": N_CLASSES,
            "TRAIN": {"PATH": f"{root}/train/x", "GT_PATH": f"{root}/train/y",
                      "IN_MEMORY": True},
            "VAL": {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.3},
            "TEST": {"PATH": f"{root}/test/x", "GT_PATH": f"{root}/test/y", "IN_MEMORY": True,
                     "LOAD_GT": True, "PADDING": [2, 4, 4]},
        },
        "AUGMENTOR": {"ENABLE": True, "VFLIP": True, "ZFLIP": True},
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8],
                  "DROPOUT_VALUES": [0.0, 0.0], "Z_DOWN": [1]},
        "TRAIN": {"ENABLE": True, "EPOCHS": 2, "BATCH_SIZE": 2, "OPTIMIZER": ["SGD"],
                  "LR": [0.02], "MIXED_PRECISION": False},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": False, "MATCHING_STATS_THS": [0.3, 0.5]},
        "LOG": {"CHART_CREATION_FREQ": 0},
    }


@pytest.fixture(scope="module")
def instance_jobs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("inst_cls"))
    roots = {side: f"{base}/{side}_data" for side in ("jax", "torch")}
    _write_instance(roots["jax"])
    shutil.copytree(roots["jax"], roots["torch"])
    return run_both(base, INST_NAME, lambda side: _instance_cfg(roots[side]))


def test_instance_class_head_job_matches_jax(instance_jobs):
    jobs = instance_jobs
    jr, tr = records(jobs["jax"], INST_NAME), records(jobs["torch"], INST_NAME)
    assert len(tr) == len(jr) == 2
    for j, t in zip(jr, tr):
        for k in ("loss", "val_loss", "iou", "val_iou"):
            assert abs(t[k] - j[k]) <= 1e-4, (k, t[k], j[k])
    out = {}
    for side, job in jobs.items():
        wf = job.workflow
        res = wf.cfg.PATHS.RESULT_DIR
        preds = {p["role"]: p for p in wf._predictions}
        out[side] = (read_tiff(f"{res.PER_IMAGE}/000.tif"),
                     read_tiff(f"{res.PER_IMAGE_INSTANCES}/000.tif"),
                     preds["class_map"]["classes"], wf._class_ious, wf.matching_stats)
    (jraw, jinst, jcls, jiou, jms), (traw, tinst, tcls, tiou, tms) = out["jax"], out["torch"]
    # B, C, D and the three class probabilities, flat
    assert traw.shape == jraw.shape == (14, 36, 40, 3 + N_CLASSES)
    np.testing.assert_allclose(traw, jraw, rtol=0, atol=1e-4)
    assert tinst.shape == (14, 36, 40, 2) and tinst[..., 0].max() > 2
    _equal(tinst, jinst)  # the instances and their voted classes side by side
    _equal(tcls, jcls)
    assert set(np.unique(tcls)) <= {0, 1, 2}
    assert len(tiou) == len(jiou) == 1 and abs(tiou[0] - jiou[0]) <= 1e-6
    for j, t in zip(jms, tms):
        assert abs(t["f1"] - j["f1"]) <= 1e-6


def _write_detection(root, ndim):
    seed = 90
    shapes = ({"train": ((48, 48), 2), "test": ((44, 40), 1)} if ndim == 2 else
              {"train": ((12, 40, 40), 2), "chunks": ((16, 48, 48), 1)})
    for split, (shape, n) in shapes.items():
        for d in ("x", "csv"):
            os.makedirs(f"{root}/{split}/{d}")
        for i in range(n):
            heat, pts = blobs(shape, n=8, seed=seed, sigma=(1.5,) * ndim, noise=0.0)
            cls = np.random.default_rng(seed).integers(1, N_CLASSES, len(pts))
            img = 30 + 100 * heat * cls.max() + np.random.default_rng(seed + 1).normal(0, 10, shape)
            seed += 2
            img = img.clip(0, 255).astype(np.uint8)
            header = [f"axis-{d}" for d in range(ndim)] + ["class"]
            rows = [list(map(int, p)) + [int(c)] for p, c in zip(pts, cls)]
            if split == "chunks":
                from biapy_tpu_torch.data.zarr_store import ZarrArray

                z = ZarrArray.create(f"{root}/{split}/x/vol.zarr", shape=img.shape + (1,),
                                     chunks=(8, 24, 24, 1), dtype="uint8",
                                     compressor={"id": "zlib", "level": 1})
                z[:, :, :, :] = img[..., None]
                _write_csv(f"{root}/{split}/csv/vol.csv", rows, header)
            else:
                write_tiff(f"{root}/{split}/x/{i:03d}.tif", img)
                _write_csv(f"{root}/{split}/csv/{i:03d}.csv", rows, header)


def _detection_cfg(root, ndim):
    return {
        "PROBLEM": {"TYPE": "DETECTION", "NDIM": f"{ndim}D",
                    "DETECTION": {"CENTRAL_POINT_DILATION": [1, 2, 2][-ndim:],
                                  "SEPARATED_DECODERS_PER_HEAD": ndim == 3}},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {
            "PATCH_SIZE": [8, 32, 32, 1][-ndim - 1:], "N_CLASSES": N_CLASSES,
            "TRAIN": {"PATH": f"{root}/train/x", "GT_PATH": f"{root}/train/csv",
                      "IN_MEMORY": True},
            "VAL": {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.3},
            "TEST": ({"PATH": f"{root}/test/x", "GT_PATH": f"{root}/test/csv", "IN_MEMORY": True,
                      "LOAD_GT": True, "PADDING": [4, 4], "RESOLUTION": [1, 1]} if ndim == 2 else
                     {"PATH": f"{root}/chunks/x", "GT_PATH": f"{root}/chunks/csv",
                      "IN_MEMORY": False, "LOAD_GT": True, "PADDING": [2, 4, 4],
                      "RESOLUTION": [2, 1, 1]}),
        },
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8],
                  "DROPOUT_VALUES": [0.0, 0.0], "Z_DOWN": [1]},
        "TRAIN": {"ENABLE": True, "EPOCHS": 2, "BATCH_SIZE": 2, "OPTIMIZER": ["SGD"],
                  "LR": [0.02], "MIXED_PRECISION": False},
        "TEST": dict({"ENABLE": True, "REDUCE_MEMORY": False, "DET_MIN_TH_TO_BE_PEAK": 0.3,
                      "DET_PEAK_LOCAL_MAX_MIN_DISTANCE": 2, "DET_TOLERANCE": 4,
                      "POST_PROCESSING": {"REMOVE_CLOSE_POINTS": True,
                                          "REMOVE_CLOSE_POINTS_RADIUS": 3}},
                     **({} if ndim == 2 else {"BY_CHUNKS": {
                         "ENABLE": True, "WORKFLOW_PROCESS": {
                             "ENABLE": True, "PATCHES_PER_TILE": [2, 1, 2]}}})),
        "LOG": {"CHART_CREATION_FREQ": 0},
    }


@pytest.mark.parametrize("ndim", [2, 3], ids=["2d-in-memory", "3d-by-chunks"])
def test_detection_class_head_job_matches_jax(ndim, tmp_path):
    base = str(tmp_path)
    roots = {side: f"{base}/{side}_data" for side in ("jax", "torch")}
    _write_detection(roots["jax"], ndim)
    shutil.copytree(roots["jax"], roots["torch"])
    jobs = run_both(base, DET_NAME, lambda side: _detection_cfg(roots[side], ndim))
    jr, tr = records(jobs["jax"], DET_NAME), records(jobs["torch"], DET_NAME)
    for j, t in zip(jr, tr):
        for k in ("loss", "val_loss", "iou", "val_iou"):
            assert abs(t[k] - j[k]) <= 1e-4, (k, t[k], j[k])
    out = {}
    for side, job in jobs.items():
        wf = job.workflow
        R = wf.cfg.PATHS.RESULT_DIR
        masks = tree_bytes(f"{roots[side]}/train/y_detection_masks")
        pts = [p for p in wf._predictions if p["role"] == "points"]
        files = tree_bytes(R.DET_LOCAL_MAX_COORDS_CHECK)
        if ndim == 3:
            files.update(tree_bytes(R.DET_LOCAL_MAX_COORDS_CHECK_POST_PROCESSING))
        out[side] = (masks, files, pts, wf.metrics_per_test_file)
    (tmask, tf, tp, tm), (jmask, jf, jp, jm) = out["torch"], out["jax"]
    assert len([f for f in tmask if f.endswith(".tif")]) == 2 and tmask == jmask  # class channels too
    assert tf == jf and all(b.startswith(b"axis-0") and b"class" in b.split(b"\n")[0]
                            for b in tf.values())
    if ndim == 3:
        # tiles of 8 x 24 x 48 cores: 2 x 2 x 1
        assert len(tf) == 1 + 2 * 2 * 1 and "vol_all_points.csv" in tf
    assert len(tp) == len(jp) == 1 and len(tp[0]["points"]) > 3
    _equal(tp[0]["points"], jp[0]["points"])
    _equal(tp[0]["classes"], jp[0]["classes"])
    assert len(tm) == len(jm) == 1 and sorted(tm[0]) == sorted(jm[0])
    assert "det_f1_class" in tm[0]
    for k in tm[0]:
        assert abs(tm[0][k] - jm[0][k]) <= 1e-6, (k, tm[0][k], jm[0][k])
