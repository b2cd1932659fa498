"""The port's 2D models and 2D inference against the JAX package.

Modules and models take the same seeded Flax variables (every leaf,
carried over by ``load_flax_variables`` and read back by
``export_flax_variables``: 2D kernels are ``(ky, kx, Cin, Cout)`` on both
sides) and the same numpy inputs, in float32:

- ``ConvTranspose`` with 2D scales (one matmul and the y/x shuffle, no z
  phase), ``max_pool`` on ``(N, H, W, C)`` (tied windows, a NaN window, a
  shape the window does not divide) and the 3x3, 5x5 and 1x1 SAME convs:
  forward within 1e-6 of scale, gradients within 1e-5;
- each 2D U-Net variant (with and without LARGER_IO, SR ``pre`` / ``post``,
  separated decoders) within 1e-5; ``simple_cnn`` and ``vit`` in 2D,
  logits within 1e-5;
- ``BiaPy.predict`` through the 2D stitch, with TEST.FULL_IMG, and with
  test-time augmentation (the 8 symmetries of the square), within 1e-5;
  the stitch itself on a channels-last ``(H, W, C)`` image with reflect
  and median padding and the 2D spline window, within 1e-5;
  TEST.ANALIZE_2D_IMGS_AS_3D_STACK with the z median filter through
  ``test()`` from disk.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.data.tiff import write_tiff
from biapy_tpu.models.blocks import Conv as FlaxConv
from biapy_tpu.models.blocks import ConvTranspose as FlaxConvTranspose
from biapy_tpu.models.blocks import max_pool as jax_max_pool
from biapy_tpu.models.simple_cnn import SimpleCNN as FlaxSimpleCNN
from biapy_tpu.models.unet_family import UNetFamily as FlaxUNet
from biapy_tpu.models.vit import ViT as FlaxViT
from biapy_tpu.ops.stitch import sliding_window_inference as jax_sliding_window
from biapy_tpu_torch.models.blocks import Conv, ConvTranspose, max_pool
from biapy_tpu_torch.models.flax_import import (export_flax_variables, flatten,
                                                load_flax_variables)
from biapy_tpu_torch.models.simple_cnn import SimpleCNN
from biapy_tpu_torch.models.unet_family import UNetFamily
from biapy_tpu_torch.models.vit import ViT
from biapy_tpu_torch.ops.stitch import sliding_window_inference
from test_torch_model import _random_variables
from test_torch_predict import _seeded_variables

torch.set_num_threads(2)


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, tol, scale)


def _round_trip(model, params, stats=None):
    """The bridge both ways: the port's leaves are the Flax leaves, name by
    name and shape by shape."""
    p, s = export_flax_variables(model)
    for mine, theirs in ((p, params), (s, stats or {})):
        a, b = flatten(mine), flatten(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == np.shape(b[k]) and np.array_equal(a[k], np.asarray(b[k])), k


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [(2, 2), (1, 2), (3, 2)])
def test_conv_transpose_2d_matches_flax(scale):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    m = FlaxConvTranspose(3, kernel_size=scale, strides=scale)
    params, _ = _random_variables(m.init, x.shape, rng)
    ref = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    t = ConvTranspose(4, 3, scale)
    load_flax_variables(t, params)
    _round_trip(t, params)
    xt = torch.from_numpy(x).requires_grad_()
    got = t(xt)
    _close(got.detach().numpy(), ref, 1e-6)  # one 4-term dot per pixel
    g = rng.standard_normal(ref.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, p: m.apply({"params": p}, a), jnp.asarray(x), params)
    gx, gp = vjp(jnp.asarray(g))
    got.backward(torch.from_numpy(g))
    _close(xt.grad.numpy(), gx, 1e-5)
    _close(t.kernel.grad.numpy(), gp["kernel"], 1e-5)
    _close(t.bias.grad.numpy(), gp["bias"], 1e-5)


def _tied(shape, rng):
    """Few distinct values (tied windows), a NaN and a -0."""
    x = (np.round(rng.standard_normal(shape) * 2) / 2).astype(np.float32)
    x.reshape(-1)[7] = np.nan
    x.reshape(-1)[11] = -0.0
    return x


@pytest.mark.parametrize("shape,window", [((2, 8, 12, 3), (2, 2)), ((1, 6, 9, 2), (3, 3)),
                                          ((2, 9, 11, 4), (2, 2)), ((1, 7, 8, 2), (2, 3))],
                         ids=["ties-nan", "ties-3x3", "non-divisible", "non-divisible-2x3"])
def test_max_pool_2d_matches_jax(shape, window):
    """The divisible windows run the pool kernel's plain version on the
    unit-depth view; every tied slot gets the full cotangent, a NaN window
    gives NaN and no gradient, as the JAX package's reshape-max. A shape the
    window does not divide floors like XLA's VALID ``reduce_window``
    (random values: no ties, whose gradient XLA gives to one slot)."""
    rng = np.random.default_rng(2)
    divisible = all(s % w == 0 for s, w in zip(shape[1:3], window))
    x = _tied(shape, rng) if divisible else rng.standard_normal(shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_max_pool(a, window), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = max_pool(xt, window)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))  # NaN == NaN
    g = rng.standard_normal(ref.shape).astype(np.float32)
    got.backward(torch.from_numpy(g))
    (gx,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx))
    if divisible:
        assert np.isnan(got.detach().numpy()).any()
        # some window ties: more non-zero gradient slots than windows
        assert np.count_nonzero(xt.grad.numpy()) > g.size - np.isnan(ref).sum()


@pytest.mark.parametrize("k,cin,cout", [(3, 3, 5), (5, 2, 4), (1, 6, 3)])
def test_conv_2d_matches_flax(k, cin, cout):
    """2D convs go to PyTorch's conv2d with TF32 off (1x1: a matmul), as
    the JAX package leaves them to ``lax.conv_general_dilated``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 9, cin)).astype(np.float32)
    m = FlaxConv(cout, kernel_size=(k, k), padding="SAME")
    params, _ = _random_variables(m.init, x.shape, rng)
    ref, vjp = jax.vjp(lambda a, p: m.apply({"params": p}, a), jnp.asarray(x), params)
    t = Conv(cin, cout, (k, k))
    load_flax_variables(t, params)
    _round_trip(t, params)
    xt = torch.from_numpy(x).requires_grad_()
    got = t(xt)
    _close(got.detach().numpy(), ref, 1e-6)
    g = rng.standard_normal(ref.shape).astype(np.float32)
    got.backward(torch.from_numpy(g))
    gx, gp = vjp(jnp.asarray(g))
    _close(xt.grad.numpy(), gx, 1e-5)
    _close(t.kernel.grad.numpy(), gp["kernel"], 1e-5)
    _close(t.bias.grad.numpy(), gp["bias"], 1e-5)


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------
def _unet_kwargs(variant, norm, **extra):
    kw = dict(variant=variant, ndim=2, feature_maps=(4, 8, 16), normalization=norm,
              z_down=(2, 2), yx_down=(2, 2), conv_layers=(2, 2, 2), isotropy=(True,),
              larger_io=False, activation="elu", output_channels=(1,))
    kw.update(extra)
    return kw


_LARGER_IO = dict(larger_io=True, upsample_layer="upsampling", activation="relu",
                  conv_block_order="norm_act_conv")


@pytest.mark.parametrize("variant,norm,extra", [
    ("unet", "bn", {}),
    ("resunet", "bn", {}),
    ("seunet", "bn", {}),
    ("resunet_se", "in", {}),
    ("attention_unet", "bn", {}),
    ("unet", "none", _LARGER_IO),
    ("resunet", "bn", _LARGER_IO),
    ("unet", "bn", dict(upsampling_factor=(2, 2), upsampling_position="pre")),
    ("unet", "bn", dict(upsampling_factor=(2, 2), upsampling_position="post",
                        larger_io=True)),
    ("unet", "bn", dict(output_channels=(1, 2), separated_decoders=True,
                        divide_decoder_feature_maps=True)),
    ("resunet", "bn", dict(output_channels=(2, 1), separated_decoders=True)),
], ids=["unet", "resunet", "seunet", "resunet_se-in", "attention_unet", "unet-larger_io",
        "resunet-larger_io", "sr-pre", "sr-post", "unet-separated", "resunet-separated"])
def test_unet_family_2d_matches_flax(variant, norm, extra):
    rng = np.random.default_rng(4)
    kw = _unet_kwargs(variant, norm, **extra)
    info = tuple(f"head{i}" for i in range(len(kw["output_channels"])))
    flax_model = FlaxUNet(**kw, drop_values=(0.0, 0.0, 0.0), output_channel_info=info)
    x = rng.standard_normal((2, 16, 20, 1)).astype(np.float32)
    params, stats = _random_variables(
        lambda k, a: flax_model.init(k, a, train=False), x.shape, rng)
    jvars = {"params": params, **({"batch_stats": stats} if stats else {})}
    # jitted: op by op, the Flax forward takes seconds on the CPU
    ref = np.asarray(jax.jit(lambda v, a: flax_model.apply(v, a, train=False))(
        jvars, jnp.asarray(x)))
    model = UNetFamily(**kw, in_channels=1, gen=torch.Generator().manual_seed(0)).eval()
    load_flax_variables(model, params, stats)
    _round_trip(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    up = 2 if "upsampling_factor" in extra else 1
    assert got.shape == (2, 16 * up, 20 * up, sum(kw["output_channels"]))
    _close(got, ref, 1e-5)


def test_simple_cnn_2d_matches_flax():
    """Three-channel input, 3x3 and 5x5 convs, two 2x2 pools, BatchNorm and
    the channels-last flatten (y, x, C) into Dense_0."""
    rng = np.random.default_rng(5)
    patch = (20, 16, 3)
    x = rng.standard_normal((2,) + patch).astype(np.float32)
    fm = FlaxSimpleCNN(ndim=2, n_classes=4)
    params, stats = _random_variables(lambda k, a: fm.init(k, a, train=False), x.shape, rng)
    ref = np.asarray(jax.jit(fm.apply)({"params": params, "batch_stats": stats},
                                       jnp.asarray(x))["class"])
    model = SimpleCNN(ndim=2, n_classes=4, input_shape=patch).eval()
    load_flax_variables(model, params, stats)
    _round_trip(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 4)
    _close(got, ref, 1e-5)


def test_vit_2d_matches_flax():
    """The patch embedding over 2 axes, (img // patch) ** 2 tokens plus the
    class token."""
    rng = np.random.default_rng(6)
    kw = dict(ndim=2, img_size=16, patch_size=4, in_channels=3, embed_dim=32, depth=2,
              num_heads=2, mlp_ratio=4.0)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    fm = FlaxViT(**kw, n_classes=3)
    params, _ = _random_variables(lambda k, a: fm.init(k, a), x.shape, rng)
    ref = np.asarray(jax.jit(fm.apply)({"params": params}, jnp.asarray(x))["class"])
    model = ViT(**kw, n_classes=3).eval()
    load_flax_variables(model, params)
    _round_trip(model, params)
    assert tuple(model.pos_embed.shape) == (1, (16 // 4) ** 2 + 1, 32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, ref, 1e-5)


# --------------------------------------------------------------------------
# inference
# --------------------------------------------------------------------------
def _cfg(**test):
    return {
        "PROBLEM": {"TYPE": "SEMANTIC_SEG", "NDIM": "2D"},
        "MODEL": {"ARCHITECTURE": "unet", "FEATURE_MAPS": [4, 8, 16],
                  "DROPOUT_VALUES": [0.0, 0.0, 0.0], "NORMALIZATION": "bn"},
        "DATA": {"PATCH_SIZE": [32, 32, 1],
                 "TEST": {"PADDING": [4, 4], "OVERLAP": [0.5, 0.5]}},
        "TRAIN": {"ENABLE": True, "BATCH_SIZE": 2},
        "TEST": {"ENABLE": True, **test},
    }


def _jobs(cfg, tmp_path):
    """The JAX workflow with seeded weights and the port's with the same."""
    jjob = biapy_tpu.BiaPy(copy.deepcopy(cfg), result_dir=str(tmp_path), name="jax",
                           silent=True, check_data_paths=False)
    jjob._build_workflow()
    wf = jjob.workflow
    wf.prepare_model()
    params, stats = _seeded_variables(wf.state, np.random.default_rng(0))
    wf.state = wf.state.replace(params=jax.tree.map(jnp.asarray, params),
                                batch_stats=jax.tree.map(jnp.asarray, stats))
    tjob = biapy_tpu_torch.BiaPy(copy.deepcopy(cfg), result_dir=str(tmp_path), name="torch",
                                 silent=True, check_data_paths=False, device="cpu")
    tjob._build_workflow()
    tjob.workflow.prepare_model()
    load_flax_variables(tjob.workflow.model, params, stats)
    return jjob, tjob


@pytest.mark.parametrize("test,shape", [
    ({}, (50, 45)),
    ({"FULL_IMG": True}, (50, 45)),
    ({"AUGMENTATION": True}, (40, 36)),
    ({"AUGMENTATION": True, "FULL_IMG": True}, (40, 36)),
    ({"REDUCE_MEMORY": True, "FULL_IMG": True}, (50, 45)),
], ids=["stitch", "full-img", "tta", "tta-full-img", "full-img-bf16"])
def test_predict_2d_matches_jax(test, shape, tmp_path):
    """The 2D stitch (an irregular overlapping grid), the whole-image forward
    (reflect-padded to 64 x 64, cropped back), and the 8 symmetries of the
    square averaged on the host crop/merge path."""
    img = np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8)
    gt = (img > 128).astype(np.uint8)
    jjob, tjob = _jobs(_cfg(**test), tmp_path)
    ref, got = jjob.predict(img, gt)[0], tjob.predict(img, gt)[0]
    assert got["pred"].shape == ref["pred"].shape == shape + (1,)
    if test.get("REDUCE_MEMORY"):
        # bf16 weights and activations round at other places in the two
        # frameworks (an ulp of bf16 is 2^-8 of the value), which moves
        # pixels near 0.5 across the IoU's threshold
        _close(got["pred"], ref["pred"], 2e-2)
        return
    # the per-image IoU thresholds probabilities that agree to ~1e-6
    assert abs(got["metrics"]["iou"] - ref["metrics"]["iou"]) < 1e-3
    _close(got["pred"], ref["pred"], 1e-5)


def test_analize_2d_as_3d_stack_matches_jax(tmp_path):
    """TEST.ANALIZE_2D_IMGS_AS_3D_STACK: the 2D predictions of the test
    directory stacked in z and median-filtered along z, through ``test()``
    from disk, written to RESULT_DIR.AS_3D_STACK."""
    rng = np.random.default_rng(8)
    test_dir = tmp_path / "test"
    os.makedirs(test_dir)
    for i in range(3):
        write_tiff(str(test_dir / f"im{i}.tif"), rng.integers(0, 256, (36, 40), dtype=np.uint8))
    cfg = _cfg(ANALIZE_2D_IMGS_AS_3D_STACK=True,
               POST_PROCESSING={"MEDIAN_FILTER": True, "MEDIAN_FILTER_AXIS": ["z"],
                                "MEDIAN_FILTER_SIZE": [3]})
    cfg["DATA"]["TEST"].update(PATH=str(test_dir), LOAD_GT=False)
    jjob, tjob = _jobs(cfg, tmp_path)
    stacks = []
    for job in (jjob, tjob):
        job.workflow.test()
        (st,) = [p["pred"] for p in job.workflow._predictions if p["role"] == "as_3d_stack"]
        stacks.append(st)
        out = os.path.join(job.workflow.cfg.PATHS.RESULT_DIR.AS_3D_STACK, "stack.tif")
        assert os.path.exists(out)
    assert stacks[1].shape == stacks[0].shape == (3, 36, 40, 1)
    _close(stacks[1], stacks[0], 1e-5)


@pytest.mark.parametrize("pad_mode", ["reflect", "median"])
def test_stitch_2d_matches_jax(pad_mode):
    """An image narrower than the patch core in y (reflect-extended, then
    cropped), median or reflect borders, an irregular overlapping grid, a
    batch size that leaves zero-weight duplicate patches."""
    img = np.random.default_rng(9).standard_normal((11, 37, 2)).astype(np.float32)
    geometry = dict(patch=(16, 16), overlap=(0.3, 0.3), padding=(2, 2), out_channels=1,
                    batch_size=4, pad_mode=pad_mode)

    def j_apply(_, x):
        return jax.nn.sigmoid(x[..., :1] * x[..., 1:] + x.mean(axis=(1, 2, 3), keepdims=True))

    def t_apply(x):
        return torch.sigmoid(x[..., :1] * x[..., 1:] + x.mean(dim=(1, 2, 3), keepdim=True))

    ref = np.asarray(jax_sliding_window(j_apply, None, jnp.asarray(img), **geometry))
    got = sliding_window_inference(t_apply, torch.from_numpy(img), **geometry).numpy()
    assert got.shape == (11, 37, 1)
    _close(got, ref, 1e-5)
