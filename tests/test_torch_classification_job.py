"""A whole 3D classification job, the port against the JAX package.

``run_job()`` on both packages from one JAX-written initial checkpoint:
seeded uint8 TIFF volumes in two class folders (dark and bright, as
``tests/test_e2e_workflows.py``'s classification job), RESIZE to the patch
(8 x 16 x 16), the template's flips and rotation, simple_cnn, ADAMW (at
lr 1e-5) with the one-cycle schedule, two epochs, float32, the JAX job on
one device of the test mesh. Dropout is neutralised on both sides (Flax's intercepted to
the identity, the port's forward replaced by the identity): the two
packages' random streams cannot agree. The loss curve (train and
validation loss and accuracy) agrees within 1e-4, ``predictions.csv`` byte
for byte, the test accuracy exactly and the test probabilities within
1e-4. Then each package reads the other's best checkpoint and tests with
it (the probabilities within 1e-5, the same CSV), and ``BiaPy(ckpt).predict(volume)`` writes nothing.
"""

import os

import numpy as np
import pytest
import torch
from flax import linen as nn

import jax

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.data.tiff import write_tiff
from biapy_tpu.utils.misc import save_model as jax_save_model
from biapy_tpu_torch.models.blocks import Dropout
from test_torch_classification import _no_dropout
from test_torch_restoration_job import records, run, tree_bytes

torch.set_num_threads(2)

NAME = "cls"


def _write(root):
    rng = np.random.default_rng(17)
    for split, n in (("train", 16), ("test", 4)):
        for ci, cname in enumerate(["dark", "bright"]):
            os.makedirs(f"{root}/{split}/{cname}", exist_ok=True)
            for i in range(n // 2):
                base = 40 if ci == 0 else 200
                vol = rng.normal(base, 15, (10, 20, 20)).clip(0, 255).astype(np.uint8)
                write_tiff(f"{root}/{split}/{cname}/{i}.tif", vol)


def _cfg(root):
    return {
        "PROBLEM": {"TYPE": "CLASSIFICATION", "NDIM": "3D"},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {"PATCH_SIZE": [8, 16, 16, 1], "N_CLASSES": 2,
                 "PREPROCESS": {"TRAIN": True, "TEST": True,
                                "RESIZE": {"ENABLE": True, "OUTPUT_SHAPE": [8, 16, 16]}},
                 "TRAIN": {"PATH": f"{root}/train", "IN_MEMORY": True},
                 "VAL": {"SPLIT_TRAIN": 0.25},
                 "TEST": {"PATH": f"{root}/test", "IN_MEMORY": True, "LOAD_GT": True}},
        "AUGMENTOR": {"ENABLE": True, "RANDOM_ROT": True, "VFLIP": True, "HFLIP": True,
                      "ZFLIP": True},
        "MODEL": {"ARCHITECTURE": "simple_cnn"},
        # Adam steps each weight by about lr whatever its gradient, and
        # Dense_0 sums 2048 features: at the template's 1e-3 a step moves the
        # logits by units, the curve turns chaotic and float32 noise grows to
        # 1e-3 within two epochs; at 1e-5 the loss still moves 100x the
        # tolerance
        "TRAIN": {"ENABLE": True, "OPTIMIZER": ["ADAMW"], "LR": [1e-5], "BATCH_SIZE": 4,
                  "EPOCHS": 2, "LR_SCHEDULER": {"NAME": "onecycle"},
                  "MIXED_PRECISION": False},
        "TEST": {"ENABLE": True, "METRICS": ["accuracy"]},
        "LOG": {"CHART_CREATION_FREQ": 0},
    }


def _run(side, cfg, result_dir, name):
    """``run`` with dropout neutralised on ``side``."""
    if side == "jax":
        with nn.intercept_methods(_no_dropout):
            return run(side, cfg, result_dir, name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Dropout, "forward", lambda self, x: x)
        return run(side, cfg, result_dir, name)


def _csv(job):
    with open(os.path.join(job.workflow.cfg.PATHS.RESULT_DIR.PATH, "predictions.csv"), "rb") as f:
        return f.read()


def test_classification_job_matches_jax(tmp_path):
    root = str(tmp_path)
    _write(root)
    init = biapy_tpu.BiaPy(_cfg(root), result_dir=f"{root}/init", name=NAME, silent=True)
    init._build_workflow()
    init.workflow.prepare_model()
    st = init.workflow.state
    ckpt = jax_save_model(init.workflow.cfg, f"{root}/init", "init",
                          jax.tree.map(np.asarray, st.params), 0,
                          jax.tree.map(np.asarray, st.batch_stats))
    jobs = {}
    for side in ("jax", "torch"):
        cfg = _cfg(root)
        cfg["MODEL"].update(LOAD_CHECKPOINT=True, ITEMS_TO_LOAD_FROM_CHECKPOINT=["weights"])
        cfg["PATHS"] = {"CHECKPOINT_FILE": ckpt}
        jobs[side] = _run(side, cfg, f"{root}/{side}", NAME)

    jr, tr = records(jobs["jax"], NAME), records(jobs["torch"], NAME)
    assert [r["epoch"] for r in tr] == [r["epoch"] for r in jr] == [0, 1]
    for j, t in zip(jr, tr):
        assert set(t) == set(j)
        for k in ("loss", "accuracy", "val_loss", "val_accuracy"):
            assert abs(t[k] - j[k]) <= 1e-4, (k, t[k], j[k])
    assert _csv(jobs["torch"]) == _csv(jobs["jax"])
    assert _csv(jobs["torch"]).startswith(b"filename,class\r\n")
    assert jobs["torch"].workflow.stats == jobs["jax"].workflow.stats
    assert jobs["torch"].workflow.val_stats.keys() == jobs["jax"].workflow.val_stats.keys()
    probs = {side: np.stack([p["pred"] for p in job.workflow._predictions])
             for side, job in jobs.items()}
    # the trained weights carry the loss curve's float32 noise
    np.testing.assert_allclose(probs["torch"], probs["jax"], rtol=0, atol=1e-4)
    assert probs["torch"].shape == (4, 2)

    # each package tests with the other's best checkpoint
    best = {side: os.path.join(job.workflow.cfg.PATHS.CHECKPOINT, f"{NAME}-checkpoint-best.ckpt")
            for side, job in jobs.items()}
    for src in ("jax", "torch"):
        tested = {}
        for side, api, kw in (("jax", biapy_tpu, {}), ("torch", biapy_tpu_torch,
                                                       {"device": "cpu"})):
            job = api.BiaPy(best[src], result_dir=f"{root}/from_{src}", name=f"{side}_reads",
                            silent=True, **kw)
            job.test()
            tested[side] = (np.stack([p["pred"] for p in job.workflow._predictions]), _csv(job))
        np.testing.assert_allclose(tested["torch"][0], tested["jax"][0], rtol=0, atol=1e-5)
        assert tested["torch"][1] == tested["jax"][1]

    # predict in memory writes nothing
    before = tree_bytes(root)
    job = biapy_tpu_torch.BiaPy(best["torch"], result_dir=f"{root}/predict", name="p",
                                silent=True, device="cpu")
    vol = np.full((8, 16, 16), 200, np.uint8)
    out = job.predict(vol)
    assert len(out) == 1 and out[0]["pred"].shape == (2,)
    assert abs(float(out[0]["pred"].sum()) - 1.0) <= 1e-6
    assert tree_bytes(root) == before
