"""Whole super-resolution and image-to-image jobs, the port against the JAX
package (the helpers and tolerances of ``test_torch_restoration_job.py``).

* Super-resolution (1, 2, 2), ``post`` upsampling, ADAM with the one-cycle
  schedule: LR volumes the 2 x 2 y-x block mean of seeded HR ones; the test
  pass takes the host crop/merge path with the output and its padding
  scaled. The loss and the train metrics (PSNR, MAE, MSE, SSIM in every
  step) within 1e-4, the written HR prediction within 1e-4, PSNR against the
  test GT within 1e-6 and SSIM (float32, as in JAX) within 1e-5; the
  generator check and augmented samples (HR targets) byte-equal.
* Image-to-image with two heads on separated decoders (the second head
  sigmoid-activated at inference): the target a fixed seeded transform of
  the source (a blur and an inversion); the same checks.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from scipy import ndimage

from biapy_tpu.data.tiff import write_tiff
from test_torch_restoration_job import (assert_generator_dumps_match, assert_loss_curves_match,
                                        job_cfg, run_both, smooth_volume, written_predictions)

torch.set_num_threads(2)

LR_SHAPE, TEST_SHAPE = (8, 32, 32), (8, 28, 36)
METRICS = ("psnr", "mae", "mse", "ssim")


def _write(root):
    seed = 50
    for split, n, shape in (("train", 2, LR_SHAPE), ("test", 1, TEST_SHAPE)):
        for d in ("lr", "hr", "src", "tgt"):
            os.makedirs(f"{root}/{split}/{d}")
        for i in range(n):
            hr = smooth_volume((shape[0], 2 * shape[1], 2 * shape[2]), seed).astype(np.float32)
            lr = hr.reshape(shape[0], shape[1], 2, shape[2], 2).mean(axis=(2, 4))
            write_tiff(f"{root}/{split}/hr/{i:03d}.tif", hr.astype(np.uint8))
            write_tiff(f"{root}/{split}/lr/{i:03d}.tif", np.round(lr).astype(np.uint8))
            src = smooth_volume(shape, seed + 10)
            blur = 255 - ndimage.gaussian_filter(src.astype(np.float32), (0.5, 1.5, 1.5))
            tgt = np.stack([blur, ndimage.gaussian_filter(blur, 1.0)], axis=-1)
            write_tiff(f"{root}/{split}/src/{i:03d}.tif", src)
            write_tiff(f"{root}/{split}/tgt/{i:03d}.tif", tgt.clip(0, 255).astype(np.uint8))
            seed += 1


def _sr(root):
    return job_cfg(root, {
        "PROBLEM": {"TYPE": "SUPER_RESOLUTION", "NDIM": "3D",
                    "SUPER_RESOLUTION": {"UPSCALING": [1, 2, 2]}},
        "DATA": {"PATCH_SIZE": [8, 16, 16, 1], "NORMALIZATION": {"TYPE": "div"},
                 "CHECK_GENERATORS": True,
                 "TRAIN": {"PATH": f"{root}/train/lr", "GT_PATH": f"{root}/train/hr"},
                 "TEST": {"PATH": f"{root}/test/lr", "GT_PATH": f"{root}/test/hr",
                          "LOAD_GT": True}},
        "AUGMENTOR": {"ZFLIP": False, "AUG_SAMPLES": True, "AUG_NUM_SAMPLES": 2},
        "MODEL": {"UNET_SR_UPSAMPLE_POSITION": "post"},
        "TRAIN": {"OPTIMIZER": ["ADAM"], "LR": [1e-3], "LR_SCHEDULER": {"NAME": "onecycle"}},
        "TEST": {"METRICS": ["psnr", "ssim"]},
    })


def _i2i(root):
    return job_cfg(root, {
        "PROBLEM": {"TYPE": "IMAGE_TO_IMAGE", "NDIM": "3D",
                    "IMAGE_TO_IMAGE": {"CHANNELS_PER_HEAD_INFO": [1, 1], "OUTPUT_CHANNELS": 2,
                                       "OUTPUT_CHANNEL_ACT": ["linear", "sigmoid"],
                                       "SEPARATED_DECODERS_PER_HEAD": True}},
        "DATA": {"PATCH_SIZE": [8, 16, 16, 1], "NORMALIZATION": {"TYPE": "scale_range"},
                 "TRAIN": {"PATH": f"{root}/train/src", "GT_PATH": f"{root}/train/tgt"},
                 "TEST": {"PATH": f"{root}/test/src", "GT_PATH": f"{root}/test/tgt",
                          "LOAD_GT": True}},
        "TRAIN": {"OPTIMIZER": ["ADAMW"], "LR": [1e-3]},
        "TEST": {"METRICS": ["psnr", "ssim"]},
    })


JOBS = {"sr": (_sr, TEST_SHAPE[:1] + (2 * TEST_SHAPE[1], 2 * TEST_SHAPE[2])),
        "i2i": (_i2i, TEST_SHAPE + (2,))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("sr_i2i"))
    roots = {side: f"{base}/{side}_data" for side in ("jax", "torch")}
    _write(roots["jax"])
    shutil.copytree(roots["jax"], roots["torch"])
    return {name: run_both(base, name, lambda side, f=make: f(roots[side]))
            for name, (make, _) in JOBS.items()}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_loss_and_train_metrics_match_jax(runs, name):
    keys = ("loss", "val_loss", "lr") + METRICS + tuple("val_" + m for m in METRICS)
    assert_loss_curves_match(runs[name], name, keys)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_written_prediction_and_metrics_match_jax(runs, name):
    preds = written_predictions(runs[name], "000.tif")
    assert preds["torch"].shape == preds["jax"].shape == JOBS[name][1]
    np.testing.assert_allclose(preds["torch"], preds["jax"], atol=1e-4, rtol=0)
    stats = {side: job.workflow.metrics_per_test_file for side, job in runs[name].items()}
    assert len(stats["torch"]) == len(stats["jax"]) == 1
    t, j = stats["torch"][0], stats["jax"][0]
    assert sorted(t) == sorted(j) == ["psnr", "ssim"]
    # PSNR in float64 on the host; SSIM in float32 (as in JAX) over
    # predictions that differ by float32 order noise: SSIM's tolerance
    assert abs(t["psnr"] - j["psnr"]) <= 1e-6, (t, j)
    assert abs(t["ssim"] - j["ssim"]) <= 1e-5, (t, j)


def test_sr_generator_dumps_match_jax(runs):
    assert_generator_dumps_match(runs["sr"], n_channels_y=1)
