"""A whole 3D instance-segmentation job, the port against the JAX package.

One tiny dataset of seeded TIFFs (sphere instances in noise), the
repository template's codes (B, C, D) at ``resunet`` [4, 8] and a 16 x 32 x
32 patch, ``run_job()`` on both packages from the same JAX-written initial
checkpoint, float32, SGD, no worker threads, the JAX job on one device of
the test mesh. Each package compiles its own copy of the data. SGD at a
learning rate of 0.02: the D channel is trained with L1 on its logits,
whose gradient is a sign, so a voxel whose logit lies within float32
summation-order noise of its target can take either sign. AdamW's
per-weight normalisation (2.6e-4 in D after two epochs) or SGD at 0.05
(2.2e-4 in the second epoch's validation loss, the head's weights 4.7e-5
apart) amplify that into more than the tolerances; SGD at 0.02 keeps every
number below 5e-6. AdamW's own parity is held by tests/test_torch_train.py.
The tests hold:

* the compile caches: byte-equal ``.npy`` files and ``_channels_meta.json``,
  and each package reuses the other's cache without rewriting it;
* the loss curve within 1e-4 and the best epoch;
* the test pass's channel maps within 1e-4;
* the instances: equal counts, matching F1 >= 0.99 at IoU 0.5 between the
  two packages' instances, under 0.1% of voxels differing;
* the dataset matching stats within 1e-3.
"""

import glob
import json
import os
import shutil

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
from biapy_tpu_torch.utils.matching import matching

from test_torch_instance import spheres

torch.set_num_threads(2)

NAME = "inst"
CACHE = "train/y_BCD_11"


def _write(root):
    rng = np.random.default_rng(11)
    for split, n, shape in (("train", 2, (20, 48, 48)), ("test", 1, (18, 44, 40))):
        for d in ("x", "y"):
            os.makedirs(f"{root}/{split}/{d}")
        for i in range(n):
            img, lab = spheres(shape, 8, rng)
            write_tiff(f"{root}/{split}/x/{i:03d}.tif", img)
            write_tiff(f"{root}/{split}/y/{i:03d}.tif", lab)


def _cfg(root):
    return {
        "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": "3D",
                    "INSTANCE_SEG": {"DATA_CHANNELS": ["B", "C", "D"]}},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {
            "PATCH_SIZE": [16, 32, 32, 1],
            "TRAIN": {"PATH": f"{root}/train/x", "GT_PATH": f"{root}/train/y",
                      "IN_MEMORY": True},
            "VAL": {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.3},
            "TEST": {"PATH": f"{root}/test/x", "GT_PATH": f"{root}/test/y", "IN_MEMORY": True,
                     "LOAD_GT": True, "PADDING": [2, 4, 4]},
        },
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8],
                  "DROPOUT_VALUES": [0.0, 0.0], "Z_DOWN": [1], "SAVE_CKPT_FREQ": 1},
        "TRAIN": {"ENABLE": True, "EPOCHS": 2, "BATCH_SIZE": 2, "OPTIMIZER": ["SGD"],
                  "LR": [0.02], "MIXED_PRECISION": False},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": False, "MATCHING_STATS_THS": [0.3, 0.5]},
        "LOG": {"CHART_CREATION_FREQ": 0},
    }


def _cache_mtimes(root):
    return {p: os.stat(p).st_mtime_ns for p in sorted(glob.glob(f"{root}/{CACHE}/*"))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("inst"))
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
        if side == "jax":
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_base_workflow, "get_mesh",
                           lambda spatial=1: jax_get_mesh(jax.devices()[:1]))
                job = biapy_tpu.BiaPy(cfg, result_dir=f"{base}/jax", name=NAME, silent=True)
                job.run_job()
        else:
            job = biapy_tpu_torch.BiaPy(cfg, result_dir=f"{base}/torch", name=NAME,
                                        silent=True, device="cpu")
            job.run_job()
        jobs[side] = job
    return dict(base=base, roots=roots, **jobs)


def test_compile_caches_are_byte_equal_and_shared(runs):
    roots = runs["roots"]
    files = {side: sorted(os.path.basename(p) for p in glob.glob(f"{roots[side]}/{CACHE}/*"))
             for side in roots}
    assert files["torch"] == files["jax"] == ["000.npy", "001.npy", "_channels_meta.json"]
    for f in files["torch"]:
        with open(f"{roots['torch']}/{CACHE}/{f}", "rb") as a, \
                open(f"{roots['jax']}/{CACHE}/{f}", "rb") as b:
            assert a.read() == b.read(), f
    # each package reuses the other's cache: nothing is rewritten, and the
    # workflow reads its training GT from there
    for side, pkg, kw in (("torch", biapy_tpu, {}),
                          ("jax", biapy_tpu_torch, {"device": "cpu"})):
        before = _cache_mtimes(roots[side])
        job = pkg.BiaPy(_cfg(roots[side]), result_dir=f"{runs['base']}/reuse_{side}", name=NAME,
                        silent=True, **kw)
        job._build_workflow()
        job.workflow._prepare_instance_data("TRAIN")
        assert _cache_mtimes(roots[side]) == before
        assert job.workflow.cfg.DATA.TRAIN.GT_PATH == f"{roots[side]}/{CACHE}"


def _records(job):
    with open(f"{job.cfg.LOG.LOG_DIR}/{NAME}_train.jsonl") as f:
        return [json.loads(line) for line in f]


def test_loss_curve_and_best_epoch_match_jax(runs):
    from biapy_tpu.utils.misc import load_checkpoint as jax_load

    jr, tr = _records(runs["jax"]), _records(runs["torch"])
    assert [r["epoch"] for r in tr] == [r["epoch"] for r in jr] == [0, 1]
    for j, t in zip(jr, tr):
        for k in ("loss", "val_loss", "iou", "val_iou", "lr"):
            assert abs(t[k] - j[k]) <= 1e-4, (k, t[k], j[k])
    assert tr[1]["loss"] < tr[0]["loss"]
    best = [jax_load(f"{runs[s].job_dir}/checkpoints/{NAME}-checkpoint-best.ckpt")["epoch"]
            for s in ("jax", "torch")]
    assert best[0] == best[1]


def _outputs(job):
    res = job.workflow.cfg.PATHS.RESULT_DIR
    raw = read_tiff(f"{res.PER_IMAGE}/000.tif")
    inst = read_tiff(f"{res.PER_IMAGE_INSTANCES}/000.tif")
    return raw, inst


def test_channel_maps_and_instances_match_jax(runs):
    (jraw, jinst), (traw, tinst) = _outputs(runs["jax"]), _outputs(runs["torch"])
    assert traw.shape == jraw.shape == (18, 44, 40, 3)
    np.testing.assert_allclose(traw, jraw, rtol=0, atol=1e-4)
    assert tinst.shape == jinst.shape == (18, 44, 40) and tinst.dtype == jinst.dtype
    assert tinst.max() == jinst.max() > 0
    f1 = matching(jinst.astype(np.int32), tinst.astype(np.int32), thresh=[0.5])[0]["f1"]
    assert f1 >= 0.99, f1
    assert np.count_nonzero(tinst != jinst) < 1e-3 * tinst.size


def test_dataset_matching_stats_match_jax(runs):
    js, ts = runs["jax"].workflow.matching_stats, runs["torch"].workflow.matching_stats
    assert [s["thresh"] for s in ts] == [s["thresh"] for s in js] == [0.3, 0.5]
    for j, t in zip(js, ts):
        for k in ("precision", "recall", "f1", "mean_matched_score", "panoptic_quality"):
            assert abs(t[k] - j[k]) <= 1e-3, (k, t[k], j[k])
    ji, ti = runs["jax"].workflow.stats["iou"], runs["torch"].workflow.stats["iou"]
    assert abs(ti - ji) <= 1e-4
