"""Whole Noise2Void denoising and self-supervised (crappify) jobs, the port
against the JAX package.

Each job runs ``run_job()`` on both packages from the same JAX-written
initial checkpoint (the Flax parameter import): seeded uint8 TIFF volumes,
``unet`` [4, 8], 8 x 32 x 32 patches, float32, no worker threads, the
template's flips, the JAX job on one device of the test mesh. The N2V
manipulation and crappify run in the loader with each sample's own rng, so
both packages train on the same batches. The loss curve (train and
validation) agrees within 1e-4 (the instance and detection jobs'
tolerance) and the written predictions within 1e-4. The N2V job also
dumps the generator check and augmented samples (a target of two channels:
values and mask), byte-equal to the JAX package's.
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
from biapy_tpu.data.tiff import read_tiff, write_tiff
from biapy_tpu.engine import base_workflow as jax_base_workflow
from biapy_tpu.parallel import get_mesh as jax_get_mesh
from biapy_tpu.utils.misc import save_model as jax_save_model

torch.set_num_threads(2)

TRAIN_SHAPE, TEST_SHAPE = (8, 48, 48), (8, 40, 44)
JOBS = {
    "n2v": {"PROBLEM": {"TYPE": "DENOISING", "NDIM": "3D",
                        "DENOISING": {"N2V_PERC_PIX": 2.0, "N2V_MANIPULATOR": "uniform_withCP",
                                      "N2V_NEIGHBORHOOD_RADIUS": 3}},
            "DATA": {"NORMALIZATION": {"TYPE": "zero_mean_unit_variance"},
                     "CHECK_GENERATORS": True},
            "AUGMENTOR": {"AUG_SAMPLES": True, "AUG_NUM_SAMPLES": 2},
            "TRAIN": {"OPTIMIZER": ["ADAMW"], "LR": [1e-3]}},
    "crappify": {"PROBLEM": {"TYPE": "SELF_SUPERVISED", "NDIM": "3D",
                             "SELF_SUPERVISED": {"PRETEXT_TASK": "crappify",
                                                 "RESIZING_FACTOR": 4, "NOISE": 0.2}},
                 "MODEL": {"ARCHITECTURE": "resunet", "Z_DOWN": [1]},
                 "TRAIN": {"OPTIMIZER": ["ADAMW"], "LR": [1e-3]}},
}


def smooth_volume(shape, seed, noise=12.0):
    """A uint8 volume of smooth seeded structures (a sum of Gaussian bumps)
    plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    grid = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    img = np.full(shape, 40.0, np.float32)
    for _ in range(12):
        c = [rng.uniform(0, s) for s in shape]
        sig = [rng.uniform(1.5, 3.0)] + [rng.uniform(3.0, 8.0)] * 2
        img += rng.uniform(60, 150) * np.exp(
            -sum(((g - ci) / si) ** 2 for g, ci, si in zip(grid, c, sig)) / 2)
    img += rng.normal(0, noise, shape)
    return img.clip(0, 255).astype(np.uint8)


def job_cfg(root, overrides):
    cfg = {
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {"PATCH_SIZE": [8, 32, 32, 1],
                 "TRAIN": {"PATH": f"{root}/train/x", "IN_MEMORY": True},
                 "VAL": {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.25},
                 "TEST": {"PATH": f"{root}/test/x", "IN_MEMORY": True, "PADDING": [2, 4, 4]}},
        "AUGMENTOR": {"ENABLE": True, "VFLIP": True, "HFLIP": True, "ZFLIP": True},
        "MODEL": {"ARCHITECTURE": "unet", "FEATURE_MAPS": [4, 8],
                  "DROPOUT_VALUES": [0.0, 0.0], "SAVE_CKPT_FREQ": 1},
        "TRAIN": {"ENABLE": True, "EPOCHS": 2, "BATCH_SIZE": 2, "MIXED_PRECISION": False},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": False},
        "LOG": {"CHART_CREATION_FREQ": 0},
    }
    for sect, vals in overrides.items():
        for k, v in vals.items():
            if isinstance(v, dict) and isinstance(cfg.get(sect, {}).get(k), dict):
                cfg[sect][k].update(v)
            else:
                cfg.setdefault(sect, {})[k] = v
    return cfg


def run(side, cfg, result_dir, name):
    if side == "jax":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_base_workflow, "get_mesh",
                       lambda spatial=1: jax_get_mesh(jax.devices()[:1]))
            job = biapy_tpu.BiaPy(cfg, result_dir=result_dir, name=name, silent=True)
            job.run_job()
    else:
        job = biapy_tpu_torch.BiaPy(cfg, result_dir=result_dir, name=name, silent=True,
                                    device="cpu")
        job.run_job()
    return job


def run_both(base, name, make_cfg):
    """The job ``name`` on both packages from one JAX-written initial
    checkpoint; ``make_cfg(side) -> cfg``."""
    init = biapy_tpu.BiaPy(make_cfg("jax"), result_dir=f"{base}/init", name=name, silent=True)
    init._build_workflow()
    init.workflow.prepare_model()
    st = init.workflow.state
    ckpt = jax_save_model(init.workflow.cfg, f"{base}/init", f"init_{name}",
                          jax.tree.map(np.asarray, st.params), 0,
                          jax.tree.map(np.asarray, st.batch_stats))
    jobs = {}
    for side in ("jax", "torch"):
        cfg = make_cfg(side)
        cfg["MODEL"].update(LOAD_CHECKPOINT=True, ITEMS_TO_LOAD_FROM_CHECKPOINT=["weights"])
        cfg["PATHS"] = {"CHECKPOINT_FILE": ckpt}
        jobs[side] = run(side, cfg, f"{base}/{side}", name)
    return jobs


def records(job, name):
    with open(f"{job.cfg.LOG.LOG_DIR}/{name}_train.jsonl") as f:
        return [json.loads(line) for line in f]


def assert_loss_curves_match(jobs, name, keys):
    jr, tr = records(jobs["jax"], name), records(jobs["torch"], name)
    assert [r["epoch"] for r in tr] == [r["epoch"] for r in jr] == [0, 1]
    for j, t in zip(jr, tr):
        for k in keys:
            assert abs(t[k] - j[k]) <= 1e-4, (k, t[k], j[k])


def tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def assert_generator_dumps_match(jobs, n_channels_y):
    """DATA.CHECK_GENERATORS and AUGMENTOR.AUG_SAMPLES wrote the same files."""
    dumps = {side: {k: tree_bytes(getattr(job.workflow.cfg.PATHS, k))
                    for k in ("GEN_CHECKS", "DA_SAMPLES")} for side, job in jobs.items()}
    assert dumps["torch"] == dumps["jax"]
    aug = dumps["torch"]["DA_SAMPLES"]
    assert sorted(aug) == ["aug_0_x.tif", "aug_0_y.tif", "aug_1_x.tif", "aug_1_y.tif"]
    y = read_tiff(os.path.join(jobs["torch"].workflow.cfg.PATHS.DA_SAMPLES, "aug_0_y.tif"))
    assert (y.shape[-1] if y.ndim == 4 else 1) == n_channels_y


def written_predictions(jobs, fname):
    return {side: read_tiff(os.path.join(job.workflow.cfg.PATHS.RESULT_DIR.PER_IMAGE, fname))
            for side, job in jobs.items()}


def _write(root):
    seed = 30
    for split, n, shape in (("train", 2, TRAIN_SHAPE), ("test", 1, TEST_SHAPE)):
        os.makedirs(f"{root}/{split}/x")
        for i in range(n):
            write_tiff(f"{root}/{split}/x/{i:03d}.tif", smooth_volume(shape, seed))
            seed += 1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("restoration"))
    roots = {side: f"{base}/{side}_data" for side in ("jax", "torch")}
    _write(roots["jax"])
    shutil.copytree(roots["jax"], roots["torch"])
    return {name: run_both(base, name, lambda side, o=over: job_cfg(roots[side], o))
            for name, over in JOBS.items()}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_loss_curve_matches_jax(runs, name):
    keys = ("loss", "val_loss", "lr") + (("psnr", "val_psnr") if name == "crappify" else ())
    assert_loss_curves_match(runs[name], name, keys)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_written_prediction_matches_jax(runs, name):
    preds = written_predictions(runs[name], "000.tif")
    assert preds["torch"].shape == preds["jax"].shape == TEST_SHAPE  # one channel
    assert preds["torch"].dtype == np.float32
    np.testing.assert_allclose(preds["torch"], preds["jax"], atol=1e-4, rtol=0)
    # no GT for these workflows' test sets: no metrics
    assert runs[name]["torch"].workflow.metrics_per_test_file == []


def test_generator_dumps_match_jax(runs):
    assert_generator_dumps_match(runs["n2v"], n_channels_y=2)
