"""Whole 2D restoration and classification jobs, the port against the JAX
package (the helpers and tolerances of ``test_torch_restoration_job.py``).

Each job runs ``run_job()`` on both packages from one JAX-written initial
checkpoint (``test_torch_2d_job.run_both``): seeded uint8 2D TIFFs, ``unet`` [4, 8], 16 x 16 patches (SR:
the LR patch), float32, no worker threads, the templates' flips, the JAX
job on one device of the test mesh.

* denoising with Noise2Void (the 2D template's manipulator and radius);
* image-to-image (a seeded blur and inversion of the source as target);
* super-resolution x2 with ``unet`` (the 2D template's alternative to
  rcan, ``pre`` up-sampling, the host crop/merge test pass);
* self-supervised ``crappify``;
* classification with ``simple_cnn`` on 3-channel images in class folders
  with RESIZE, dropout neutralised on both sides.

The loss curves (and train metrics) within 1e-4, the written predictions
within 1e-4, PSNR within 1e-6 and SSIM within 1e-5 where the test set has
GT; for classification ``predictions.csv`` byte for byte, the accuracy
exactly and the probabilities within 1e-4.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from flax import linen as nn
from scipy import ndimage

from biapy_tpu.data.tiff import write_tiff
from biapy_tpu_torch.models.blocks import Dropout
from test_torch_classification import _no_dropout
from test_torch_2d_job import run_both
from test_torch_restoration_job import (assert_loss_curves_match, records, smooth_volume,
                                        written_predictions)

torch.set_num_threads(2)

SHAPES = {"train": ((32, 32), 2), "test": ((28, 36), 1)}


def _write(root):
    seed = 60
    for split, (shape, n) in SHAPES.items():
        for d in ("x", "lr", "hr", "src", "tgt"):
            os.makedirs(f"{root}/{split}/{d}")
        for i in range(n):
            write_tiff(f"{root}/{split}/x/{i:03d}.tif", smooth_volume(shape, seed))
            hr = smooth_volume((2 * shape[0], 2 * shape[1]), seed + 10).astype(np.float32)
            lr = hr.reshape(shape[0], 2, shape[1], 2).mean(axis=(1, 3))
            write_tiff(f"{root}/{split}/hr/{i:03d}.tif", hr.astype(np.uint8))
            write_tiff(f"{root}/{split}/lr/{i:03d}.tif", np.round(lr).astype(np.uint8))
            src = smooth_volume(shape, seed + 20)
            tgt = 255 - ndimage.gaussian_filter(src.astype(np.float32), 1.5)
            write_tiff(f"{root}/{split}/src/{i:03d}.tif", src)
            write_tiff(f"{root}/{split}/tgt/{i:03d}.tif", tgt.clip(0, 255).astype(np.uint8))
            seed += 1
    rng = np.random.default_rng(17)
    for split, n in (("train", 8), ("test", 4)):
        for ci, cname in enumerate(["dark", "bright"]):
            os.makedirs(f"{root}/cls_{split}/{cname}")
            for i in range(n // 2):
                img = rng.normal(40 if ci == 0 else 200, 15, (20, 24, 3))
                write_tiff(f"{root}/cls_{split}/{cname}/{i}.tif",
                           img.clip(0, 255).astype(np.uint8))


def _cfg(root, kind):
    x, y = {"n2v": ("x", None), "i2i": ("src", "tgt"), "sr": ("lr", "hr"),
            "crappify": ("x", None), "cls": (None, None)}[kind]
    cfg = {
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {"PATCH_SIZE": [16, 16, 1],
                 "TRAIN": {"PATH": f"{root}/train/{x}", "IN_MEMORY": True},
                 "VAL": {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.25},
                 "TEST": {"PATH": f"{root}/test/{x}", "IN_MEMORY": True, "PADDING": [4, 4]}},
        "AUGMENTOR": {"ENABLE": True, "VFLIP": True, "HFLIP": True},
        "MODEL": {"ARCHITECTURE": "unet", "FEATURE_MAPS": [4, 8],
                  "DROPOUT_VALUES": [0.0, 0.0], "SAVE_CKPT_FREQ": 1},
        "TRAIN": {"ENABLE": True, "EPOCHS": 2, "BATCH_SIZE": 2, "OPTIMIZER": ["ADAMW"],
                  "LR": [1e-3], "MIXED_PRECISION": False},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": False},
        "LOG": {"CHART_CREATION_FREQ": 0},
    }
    if y:
        cfg["DATA"]["TRAIN"]["GT_PATH"] = f"{root}/train/{y}"
        cfg["DATA"]["TEST"].update(GT_PATH=f"{root}/test/{y}", LOAD_GT=True)
        cfg["TEST"]["METRICS"] = ["psnr", "ssim"]
    if kind == "n2v":
        cfg["PROBLEM"] = {"TYPE": "DENOISING", "NDIM": "2D",
                          "DENOISING": {"N2V_PERC_PIX": 2.0, "N2V_MANIPULATOR": "uniform_withCP",
                                        "N2V_NEIGHBORHOOD_RADIUS": 5}}
        cfg["DATA"]["NORMALIZATION"] = {"TYPE": "zero_mean_unit_variance"}
    elif kind == "i2i":
        cfg["PROBLEM"] = {"TYPE": "IMAGE_TO_IMAGE", "NDIM": "2D"}
        cfg["DATA"]["NORMALIZATION"] = {"TYPE": "scale_range"}
    elif kind == "sr":
        cfg["PROBLEM"] = {"TYPE": "SUPER_RESOLUTION", "NDIM": "2D",
                          "SUPER_RESOLUTION": {"UPSCALING": [2, 2]}}
        cfg["DATA"]["NORMALIZATION"] = {"TYPE": "div"}
        cfg["MODEL"]["UNET_SR_UPSAMPLE_POSITION"] = "pre"
        cfg["TRAIN"].update(OPTIMIZER=["ADAM"], LR_SCHEDULER={"NAME": "onecycle"})
    elif kind == "crappify":
        cfg["PROBLEM"] = {"TYPE": "SELF_SUPERVISED", "NDIM": "2D",
                          "SELF_SUPERVISED": {"PRETEXT_TASK": "crappify", "RESIZING_FACTOR": 4,
                                              "NOISE": 0.2}}
        cfg["MODEL"]["ARCHITECTURE"] = "resunet"
    else:
        cfg["PROBLEM"] = {"TYPE": "CLASSIFICATION", "NDIM": "2D"}
        cfg["DATA"].update(PATCH_SIZE=[16, 16, 3], N_CLASSES=2,
                           PREPROCESS={"TRAIN": True, "TEST": True,
                                       "RESIZE": {"ENABLE": True, "OUTPUT_SHAPE": [16, 16]}})
        cfg["DATA"]["TRAIN"]["PATH"] = f"{root}/cls_train"
        cfg["DATA"]["TEST"] = {"PATH": f"{root}/cls_test", "IN_MEMORY": True, "LOAD_GT": True}
        cfg["AUGMENTOR"]["RANDOM_ROT"] = True
        cfg["MODEL"] = {"ARCHITECTURE": "simple_cnn"}
        # Adam steps each weight by about lr: at 1e-5 the loss still moves
        # 100x the tolerance (tests/test_torch_classification_job.py)
        cfg["TRAIN"].update(LR=[1e-5], BATCH_SIZE=4, LR_SCHEDULER={"NAME": "onecycle"})
        cfg["TEST"]["METRICS"] = ["accuracy"]
    return cfg


JOBS = ("cls", "crappify", "i2i", "n2v", "sr")
# the written prediction's shape (None: no per-image prediction)
OUT_SHAPES = {"n2v": SHAPES["test"][0], "i2i": SHAPES["test"][0], "crappify": SHAPES["test"][0],
              "sr": tuple(2 * s for s in SHAPES["test"][0])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("restoration2d"))
    roots = {side: f"{base}/{side}_data" for side in ("jax", "torch")}
    _write(roots["jax"])
    shutil.copytree(roots["jax"], roots["torch"])
    out = {}
    for kind in JOBS:
        with pytest.MonkeyPatch.context() as mp, nn.intercept_methods(_no_dropout):
            # dropout neutralised on both sides: the two packages' random
            # streams cannot agree (simple_cnn's only; the U-Nets have none)
            mp.setattr(Dropout, "forward", lambda self, x: x)
            out[kind] = run_both(f"{base}/{kind}", kind,
                                 lambda side, k=kind: _cfg(roots[side], k))
    return out


_KEYS = {"n2v": ("loss", "val_loss", "lr"),
         "crappify": ("loss", "val_loss", "lr", "psnr", "val_psnr"),
         "i2i": ("loss", "val_loss", "lr", "psnr", "val_psnr", "ssim", "val_ssim"),
         "sr": ("loss", "val_loss", "lr", "psnr", "val_psnr", "ssim", "val_ssim"),
         "cls": ("loss", "accuracy", "val_loss", "val_accuracy")}


@pytest.mark.parametrize("kind", JOBS)
def test_loss_curve_matches_jax(runs, kind):
    assert_loss_curves_match(runs[kind], kind, _KEYS[kind])


@pytest.mark.parametrize("kind", sorted(OUT_SHAPES))
def test_written_prediction_matches_jax(runs, kind):
    preds = written_predictions(runs[kind], "000.tif")
    assert preds["torch"].shape == preds["jax"].shape == OUT_SHAPES[kind]
    np.testing.assert_allclose(preds["torch"], preds["jax"], atol=1e-4, rtol=0)
    stats = {side: job.workflow.metrics_per_test_file for side, job in runs[kind].items()}
    if kind in ("n2v", "crappify"):
        assert stats["torch"] == stats["jax"] == []  # no GT: no metrics
        return
    t, j = stats["torch"][0], stats["jax"][0]
    assert sorted(t) == sorted(j) == ["psnr", "ssim"]
    assert abs(t["psnr"] - j["psnr"]) <= 1e-6, (t, j)
    assert abs(t["ssim"] - j["ssim"]) <= 1e-5, (t, j)


def test_classification_outputs_match_jax(runs):
    jobs = runs["cls"]
    csv = {}
    for side, job in jobs.items():
        with open(os.path.join(job.workflow.cfg.PATHS.RESULT_DIR.PATH, "predictions.csv"),
                  "rb") as f:
            csv[side] = f.read()
    assert csv["torch"] == csv["jax"] and csv["torch"].startswith(b"filename,class\r\n")
    assert jobs["torch"].workflow.stats == jobs["jax"].workflow.stats
    probs = {side: np.stack([p["pred"] for p in job.workflow._predictions])
             for side, job in jobs.items()}
    assert probs["torch"].shape == (4, 2)
    np.testing.assert_allclose(probs["torch"], probs["jax"], rtol=0, atol=1e-4)
    assert len(records(jobs["torch"], "cls")) == 2
