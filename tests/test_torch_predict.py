"""The PyTorch port's serving slice end to end against the JAX package.

One dict config (3D semantic segmentation, ``resunet`` with feature maps
(4, 8, 16), BatchNorm, patch 24^3, halo 2, overlap 0.5) goes through
``biapy_tpu.BiaPy(...).predict(vol)`` and
``biapy_tpu_torch.BiaPy(..., device="cpu").predict(vol)`` on one seeded
uint8 volume, with the JAX workflow's weights (seeded values, BatchNorm
statistics included) carried into the port's model. The volume gives a
multi-patch grid, so the on-device normalisation, the spline blend and the
blend divisor are all exercised; (30, 30, 30) gives a regular grid (the
JAX package's fold runner), (36, 30, 30) an irregular one (its accumulate
runner).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.ops.stitch import sliding_window_inference as jax_sliding_window
from biapy_tpu_torch.models.flax_import import load_flax_variables
from biapy_tpu_torch.ops.stitch import sliding_window_inference

torch.set_num_threads(2)


def _cfg(reduce_memory=False):
    return {
        "PROBLEM": {"TYPE": "SEMANTIC_SEG", "NDIM": "3D"},
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8, 16],
                  "DROPOUT_VALUES": [0.0, 0.0, 0.0], "Z_DOWN": [2, 2], "YX_DOWN": [2, 2],
                  "CONV_LAYERS": [2, 2, 2], "NORMALIZATION": "bn", "ACTIVATION": "elu"},
        "DATA": {"PATCH_SIZE": [24, 24, 24, 1],
                 "TEST": {"PADDING": [2, 2, 2], "OVERLAP": [0.5, 0.5, 0.5]}},
        "TRAIN": {"ENABLE": True, "BATCH_SIZE": 2},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": reduce_memory,
                 "OUTPUT_QUANT_UINT8": reduce_memory},
    }


def _seeded_variables(state, rng):
    """Seeded values for every leaf of the JAX workflow's state: kernels
    ~ N(0, 1/fan_in), norm scales and running variances in [0.5, 1.5],
    biases and running means ~ N(0, 0.2)."""
    def leaf(path, p):
        name = path[-1].key
        shape = np.shape(p)
        if name == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return (1.0 + rng.uniform(-0.5, 0.5, shape)).astype(np.float32)
        return rng.normal(0.0, 0.2, shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, state.params)
    stats = jax.tree_util.tree_map_with_path(leaf, state.batch_stats)
    return params, stats


def _both(cfg, vol, tmp_path, gt=None):
    jjob = biapy_tpu.BiaPy(copy.deepcopy(cfg), result_dir=str(tmp_path), name="jax",
                           silent=True, check_data_paths=False)
    jjob._build_workflow()
    wf = jjob.workflow
    wf.prepare_model()
    params, stats = _seeded_variables(wf.state, np.random.default_rng(0))
    wf.state = wf.state.replace(params=jax.tree.map(jax.numpy.asarray, params),
                                batch_stats=jax.tree.map(jax.numpy.asarray, stats))
    ref = jjob.predict(vol, gt)[0]

    tjob = biapy_tpu_torch.BiaPy(copy.deepcopy(cfg), result_dir=str(tmp_path), name="torch",
                                 silent=True, check_data_paths=False, device="cpu")
    tjob._build_workflow()
    tjob.workflow.prepare_model()
    # the numpy trees go across as they are: the bridge imports no JAX
    load_flax_variables(tjob.workflow.model, params, stats)
    got = tjob.predict(vol, gt)[0]
    return ref, got


@pytest.mark.parametrize("shape", [(30, 30, 30), (36, 30, 30)])
def test_predict_matches_jax_f32(shape, tmp_path):
    vol = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    gt = (vol > 128).astype(np.uint8)
    ref_res, got_res = _both(_cfg(), vol, tmp_path, gt)
    ref, got = ref_res["pred"], got_res["pred"]
    # the per-image IoU thresholds probabilities that agree to ~1e-6
    assert abs(got_res["metrics"]["iou"] - ref_res["metrics"]["iou"]) < 1e-3
    assert got.shape == ref.shape == shape + (1,)
    assert got.dtype == np.float32
    assert np.all(np.isfinite(got))
    # float32 probabilities after ~10 convs, a blend and a divide in
    # another summation order: differences ~1e-6
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_predict_matches_jax_bf16_uint8_drain(tmp_path):
    vol = np.random.default_rng(2).integers(0, 256, (30, 30, 30), dtype=np.uint8)
    ref, got = (r["pred"] for r in _both(_cfg(reduce_memory=True), vol, tmp_path))
    assert got.shape == ref.shape == (30, 30, 30, 1)
    assert np.array_equal(got, np.round(got)) and got.min() >= 0 and got.max() <= 255
    # bf16 weights and activations round at other places in the two
    # frameworks; the uint8 drain (round(p*255)) may then differ by 1 LSB
    assert np.abs(got - ref).max() <= 1.0


@pytest.mark.parametrize("pad_mode", ["reflect", "median"])
def test_stitch_matches_jax_deficit_median_and_batch_padding(pad_mode):
    """A volume shorter than the patch core in z (reflect-extended, then
    cropped), median or reflect borders, an irregular overlapping grid, and
    a batch size that leaves zero-weight duplicate patches."""
    vol = np.random.default_rng(3).standard_normal((9, 21, 17, 2)).astype(np.float32)
    geometry = dict(patch=(16, 16, 16), overlap=(0.3, 0.3, 0.3), padding=(2, 2, 2),
                    out_channels=1, batch_size=4, pad_mode=pad_mode)

    # depends on the whole patch, so overlapping patches disagree and the
    # blend weights show
    def j_apply(_, x):
        return jax.nn.sigmoid(x[..., :1] * x[..., 1:] + x.mean(axis=(1, 2, 3, 4), keepdims=True))

    def t_apply(x):
        return torch.sigmoid(x[..., :1] * x[..., 1:] + x.mean(dim=(1, 2, 3, 4), keepdim=True))

    ref = np.asarray(jax_sliding_window(j_apply, None, jnp.asarray(vol), **geometry))
    got = sliding_window_inference(t_apply, torch.from_numpy(vol), **geometry).numpy()
    assert got.shape == ref.shape == (9, 21, 17, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)  # float32 blend sums


def test_default_device_needs_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        biapy_tpu_torch.BiaPy(_cfg(), result_dir=str(tmp_path), name="nocuda", silent=True,
                              check_data_paths=False)
