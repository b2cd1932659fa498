"""A whole semantic-segmentation job, the port against the JAX package.

One tiny 3D dataset of TIFF files (spheres in noise, patch 16^3), one dict
config, ``run_job()`` on both packages: read the train and validation data
from disk, two epochs of SGD with validation and checkpoints, the best
checkpoint reloaded, every test TIFF predicted and written. Both jobs start
from the same JAX-written checkpoint (``MODEL.LOAD_CHECKPOINT`` with items
``["weights"]``, so both start at epoch 0), float32, dropout 0, no worker
threads, the JAX job on one device of the test mesh: the sample lists, the batch order, the per-epoch losses, the best
epoch, the checkpoint files and the written predictions must agree. Each
package runs once for the module.
"""

import copy
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
from biapy_tpu.data import generators as JG
from biapy_tpu.engine import base_workflow as jax_base_workflow
from biapy_tpu.parallel import get_mesh as jax_get_mesh
from biapy_tpu.data.data_manipulation import load_and_prepare_train_data as jax_train_data
from biapy_tpu.data.norm import build_norm_dict as jax_norm_dict
from biapy_tpu.data.tiff import read_tiff, write_tiff
from biapy_tpu.utils.misc import save_model as jax_save_model
from biapy_tpu_torch.data import generators as TG
from biapy_tpu_torch.data import io as tio
from biapy_tpu_torch.data.data_manipulation import load_and_prepare_train_data
from biapy_tpu_torch.data.norm import build_norm_dict
from biapy_tpu_torch.models.flax_import import export_flax_variables, flatten
from biapy_tpu_torch.utils.misc import load_checkpoint

torch.set_num_threads(2)

NAME = "job"


def _make_volumes(root, d, n, shape, seed):
    """``n`` uint8 volumes of spheres in noise and their 0/255 masks."""
    os.makedirs(f"{root}/{d}/x")
    os.makedirs(f"{root}/{d}/y")
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    for i in range(n):
        img = np.zeros(shape, np.float32)
        msk = np.zeros(shape, np.uint8)
        for _ in range(4):
            c = [rng.integers(4, s - 4) for s in shape]
            r = rng.integers(3, 7)
            ball = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 < r * r
            msk |= ball
            img += ball * 0.6
        img += rng.normal(0, 0.15, shape)
        write_tiff(f"{root}/{d}/x/{i:03d}.tif", (img * 127 + 64).clip(0, 255).astype(np.uint8))
        write_tiff(f"{root}/{d}/y/{i:03d}.tif", (msk * 255).astype(np.uint8))


def _cfg(root, **train):
    return {
        "PROBLEM": {"TYPE": "SEMANTIC_SEG", "NDIM": "3D"},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {
            "PATCH_SIZE": [16, 16, 16, 1],
            "TRAIN": {"PATH": f"{root}/train/x", "GT_PATH": f"{root}/train/y", "IN_MEMORY": True},
            "VAL": {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.3},
            "TEST": {"PATH": f"{root}/test/x", "GT_PATH": f"{root}/test/y", "IN_MEMORY": False,
                     "LOAD_GT": True, "PADDING": [2, 2, 2], "OVERLAP": [0.0, 0.0, 0.0]},
        },
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8], "DROPOUT_VALUES": [0.0, 0.0],
                  "Z_DOWN": [2], "YX_DOWN": [2], "CONV_LAYERS": [2, 2], "NORMALIZATION": "bn",
                  "ACTIVATION": "elu", "SAVE_CKPT_FREQ": 1},
        "TRAIN": dict({"ENABLE": True, "EPOCHS": 2, "BATCH_SIZE": 2, "OPTIMIZER": ["SGD"],
                       "LR": [0.05], "MIXED_PRECISION": False}, **train),
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": False, "OUTPUT_QUANT_UINT8": False},
        "LOG": {"CHART_CREATION_FREQ": 0},
    }


def _records(job):
    with open(f"{job.cfg.LOG.LOG_DIR}/{NAME}_train.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("job"))
    _make_volumes(root, "train", 2, (32, 32, 32), 0)
    _make_volumes(root, "test", 1, (20, 36, 28), 1)
    cfg = _cfg(root)
    # the shared starting point: the JAX workflow's initialisation, saved by
    # the JAX package
    init = biapy_tpu.BiaPy(copy.deepcopy(cfg), result_dir=f"{root}/init", name=NAME, silent=True)
    init._build_workflow()
    init.workflow.prepare_model()
    st = init.workflow.state
    init_ckpt = jax_save_model(init.workflow.cfg, f"{root}/init", "init",
                               jax.tree.map(np.asarray, st.params), 0,
                               jax.tree.map(np.asarray, st.batch_stats))
    cfg["MODEL"].update(LOAD_CHECKPOINT=True, ITEMS_TO_LOAD_FROM_CHECKPOINT=["weights"])
    cfg["PATHS"] = {"CHECKPOINT_FILE": init_ckpt}
    # the port runs on one card: the JAX job on one device of the test mesh,
    # so that its global batch is the port's (it would tile all eight)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base_workflow, "get_mesh",
                   lambda spatial=1: jax_get_mesh(jax.devices()[:1]))
        jjob = biapy_tpu.BiaPy(copy.deepcopy(cfg), result_dir=f"{root}/jax", name=NAME,
                               silent=True)
        jjob.run_job()
    tjob = biapy_tpu_torch.BiaPy(copy.deepcopy(cfg), result_dir=f"{root}/torch", name=NAME,
                                 silent=True, device="cpu")
    tjob.run_job()
    return dict(root=root, cfg=cfg, jax=jjob, torch=tjob)


def _loaders(pkg_data, pkg_gen, norm_dict, cfg, job):
    c = job.workflow.cfg
    tr, va = pkg_data(c, norm_dict(c))
    loader = pkg_gen.BatchLoader(pkg_gen.PairDataset(tr, c, norm_dict(c), augment=False), 2,
                                 seed=0, num_workers=0)
    return tr, va, loader


def test_train_val_samples_and_batch_order_match_jax(runs):
    jtr, jva, jl = _loaders(jax_train_data, JG, jax_norm_dict, runs["cfg"], runs["jax"])
    ttr, tva, tl = _loaders(load_and_prepare_train_data, TG, build_norm_dict, runs["cfg"],
                            runs["torch"])

    def key(ds):
        return [(s.fid, s.coords.starts, s.coords.ends) for s in ds.sample_list]

    assert key(ttr) == key(jtr) and key(tva) == key(jva)
    assert len(ttr.sample_list) == 11 and len(tva.sample_list) == 5
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        np.testing.assert_array_equal(tl._index_order(), jl._index_order())
        for jb, tb in zip(jl, tl):
            for k in ("x", "y"):
                np.testing.assert_array_equal(tb[k], jb[k])


def test_loss_curve_matches_jax(runs):
    """Per-epoch train and validation loss and IoU within 1e-4: float32
    sums in other orders over 12 SGD steps."""
    jr = _records(runs["jax"])
    tr = _records(runs["torch"])
    assert [r["epoch"] for r in tr] == [r["epoch"] for r in jr] == [0, 1]
    for j, t in zip(jr, tr):
        for k in ("loss", "val_loss", "iou", "val_iou", "lr"):
            assert abs(t[k] - j[k]) <= 1e-4, (k, t[k], j[k])
    assert tr[1]["loss"] < tr[0]["loss"]


def test_best_epoch_and_checkpoint_files_match_jax(runs):
    from biapy_tpu.utils.misc import load_checkpoint as jax_load

    files = {}
    for side in ("jax", "torch"):
        d = f"{runs[side].job_dir}/checkpoints"
        files[side] = sorted(os.listdir(d))
        best = jax_load(f"{d}/{NAME}-checkpoint-best.ckpt")
        files[side + "_best_epoch"] = best["epoch"]
    assert files["torch"] == files["jax"] == [f"{NAME}-checkpoint-{t}.ckpt"
                                              for t in ("0", "1", "best")]
    assert files["torch_best_epoch"] == files["jax_best_epoch"]
    # the port's model after run_job is the best checkpoint, reloaded
    best = jax_load(f"{runs['torch'].job_dir}/checkpoints/{NAME}-checkpoint-best.ckpt")
    params, _ = export_flax_variables(runs["torch"].workflow.model)
    for k, v in params["Conv_0"].items():
        np.testing.assert_array_equal(v, best["params"]["Conv_0"][k])


def test_test_outputs_and_iou_match_jax(runs):
    """The written raw predictions within 1e-4 (float32), the binarised ones
    within 1 uint8 step (a voxel at 0.5 may round either way), the IoU
    within 1e-4."""
    out = {}
    for side in ("jax", "torch"):
        res = runs[side].workflow.cfg.PATHS.RESULT_DIR
        raw = sorted(glob.glob(f"{res.PER_IMAGE}/*.tif"))
        binar = sorted(glob.glob(f"{res.PER_IMAGE_BIN}/*.tif"))
        assert [os.path.basename(p) for p in raw] == ["000.tif"] == \
               [os.path.basename(p) for p in binar]
        out[side] = (read_tiff(raw[0]), read_tiff(binar[0]))
    assert out["torch"][0].shape == out["jax"][0].shape == (20, 36, 28)
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=0, atol=1e-4)
    assert np.abs(out["torch"][1].astype(int) - out["jax"][1].astype(int)).max() <= 1
    ti, ji = runs["torch"].workflow.stats["iou"], runs["jax"].workflow.stats["iou"]
    assert abs(ti - ji) <= 1e-4, (ti, ji)
    csv = f"{runs['torch'].workflow.cfg.PATHS.RESULT_DIR.PATH}/{NAME}_per_image_metrics.csv"
    assert open(csv).read().splitlines()[0] == "image,iou"


def test_resume_from_epoch_0_reproduces_the_run(runs, tmp_path):
    """The port resumed from its own epoch-0 checkpoint (weights, BatchNorm
    statistics, SGD momentum and count, ``last_on_train`` -> epoch 1) trains
    epoch 1 as the uninterrupted run did."""
    src = f"{runs['torch'].job_dir}/checkpoints/{NAME}-checkpoint-0.ckpt"
    ck = str(tmp_path / "resume.ckpt")
    shutil.copy(src, ck)
    cfg = copy.deepcopy(runs["cfg"])
    cfg["MODEL"].update(LOAD_CHECKPOINT_EPOCH="last_on_train",
                        ITEMS_TO_LOAD_FROM_CHECKPOINT=["weights", "optimizer"])
    cfg["PATHS"] = {"CHECKPOINT_FILE": ck}
    cfg["TEST"]["ENABLE"] = False
    job = biapy_tpu_torch.BiaPy(cfg, result_dir=str(tmp_path), name=NAME, silent=True,
                                device="cpu")
    job.train()
    assert job.workflow.start_epoch == 1
    assert float(job.workflow.state.optimizer.state["count"]) == 12
    (rec,) = _records(job)
    (ref,) = _records(runs["torch"])[1:]
    for k in ("loss", "val_loss", "iou", "val_iou"):
        assert abs(rec[k] - ref[k]) <= 1e-6, (k, rec[k], ref[k])
    # the weights and statistics that epoch 1 ended with, on both runs
    last = f"{NAME}-checkpoint-1.ckpt"
    got = load_checkpoint(f"{job.job_dir}/checkpoints/{last}")
    want = load_checkpoint(f"{runs['torch'].job_dir}/checkpoints/{last}")
    for part in ("params", "batch_stats"):
        g, w = flatten(got[part]), flatten(want[part])
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("what", ["augment", "nifti"])
def test_inputs_not_ported_name_the_roadmap(what, tmp_path):
    """Augmentation and NIfTI inputs, which raised until ROADMAP queue 1
    item 5 landed, now load: the augmented training batches differ from the
    plain ones in values, not in shape; a NIfTI dataset gives the samples
    of the same volumes as TIFF files (their parity with the JAX package:
    tests/test_torch_augment.py)."""
    root = str(tmp_path)
    _make_volumes(root, "train", 1, (16, 16, 16), 0)
    cfg = _cfg(root)
    if what == "augment":
        cfg["AUGMENTOR"] = {"ENABLE": True, "VFLIP": True, "HFLIP": True, "AUG_SAMPLES": False}
    else:
        for d in ("x", "y"):
            os.makedirs(f"{root}/nii/{d}")
            tio.imwrite(f"{root}/nii/{d}/000.nii.gz", read_tiff(f"{root}/train/{d}/000.tif"))
        cfg["DATA"]["TRAIN"].update(PATH=f"{root}/nii/x", GT_PATH=f"{root}/nii/y")
    job = biapy_tpu_torch.BiaPy(cfg, result_dir=root, name=NAME, silent=True, device="cpu",
                                check_data_paths=False)
    job._build_workflow()
    wf = job.workflow
    wf.prepare_train_generators()
    plain = copy.deepcopy(_cfg(root))
    ref = biapy_tpu_torch.BiaPy(plain, result_dir=root, name=NAME, silent=True, device="cpu",
                                check_data_paths=False)
    ref._build_workflow()
    ref.workflow.prepare_train_generators()
    got, want = (w.train_data.get(0, np.random.default_rng(1))
                 for w in (wf, ref.workflow))
    assert got["x"].shape == want["x"].shape == (16, 16, 16, 1)
    if what == "augment":
        assert wf.train_data.aug is not None and ref.workflow.train_data.aug.a.ENABLE is False
        np.testing.assert_array_equal(np.sort(got["x"], axis=None), np.sort(want["x"], axis=None))
        assert any(not np.array_equal(wf.train_data.get(0, np.random.default_rng(s))["x"],
                                      want["x"]) for s in range(4))
    else:
        for k in ("x", "y"):
            np.testing.assert_array_equal(got[k], want[k])
