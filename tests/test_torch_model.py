"""The PyTorch port's U-Net family against the JAX package's Flax model.

All five variants (``unet``, ``resunet``, ``seunet``, ``resunet_se``,
``attention_unet``). The same weights (seeded numpy values for every Flax leaf, so biases, norm
scales and BatchNorm statistics are all non-trivial) go through the Flax
module and, carried over by ``load_flax_variables``, through the
port's module; eval-mode float32 outputs must agree. The JAX side runs both
its plain 5D formulation and its z-folded one (``BIAPY_TPU_FOLD3D``), so
the folded ConvTranspose and pool are pinned too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biapy_tpu.models.blocks import ConvTranspose as FlaxConvTranspose
from biapy_tpu.models.unet_family import UNetFamily as FlaxUNet
from biapy_tpu_torch.models.blocks import ConvTranspose
from biapy_tpu_torch.models.flax_import import load_flax_variables
from biapy_tpu_torch.models.unet_family import UNetFamily

torch.set_num_threads(2)


def _random_variables(init, x_shape, rng):
    """Seeded numpy values for every leaf of ``init(key, x)``, shaped by
    tracing it (nothing runs): kernels ~ N(0, 1/fan_in), norm scales and
    running variances in [0.5, 1.5], biases and running means ~ N(0, 0.2)."""
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jnp.zeros(x_shape)))

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return (1.0 + rng.uniform(-0.5, 0.5, s.shape)).astype(np.float32)
        return rng.normal(0.0, 0.2, s.shape).astype(np.float32)

    out = jax.tree_util.tree_map_with_path(leaf, shapes)
    return out["params"], out.get("batch_stats", {})


def _model_kwargs(variant, norm, **extra):
    """Keyword arguments both UNetFamily classes take."""
    kw = dict(variant=variant, ndim=3, feature_maps=(4, 8, 16), normalization=norm,
              z_down=(2, 2), yx_down=(2, 2), conv_layers=(2, 2, 2), isotropy=(True,),
              larger_io=False, activation="elu", output_channels=(1,))
    kw.update(extra)
    return kw


# LARGER_IO 5x5x5 / (1,5,5) convs, anisotropic (1,3,3) levels and linear
# upsampling: the convs that stay PyTorch calls, and UpLayer's other mode
_OTHER_PATHS = dict(larger_io=True, isotropy=(False, True, True), upsample_layer="upsampling",
                    activation="relu", conv_block_order="norm_act_conv")


@pytest.mark.parametrize("variant,norm,fold,extra", [
    ("resunet", "bn", "0", {}),
    ("resunet", "bn", "1", {}),
    ("unet", "bn", "0", {}),
    ("unet", "bn", "1", {}),
    ("resunet", "in", "1", {}),  # the config default norm (GroupNorm, one group per channel)
    ("unet", "gn", "0", {}),
    ("resunet", "bn", "0", _OTHER_PATHS),
    ("unet", "none", "0", _OTHER_PATHS),
    # the variants: SqExBlock after every conv, the residual extra conv with
    # one SqExBlock, AttentionGate on every skip (its 1-channel Norm too)
    ("seunet", "bn", "1", {}),
    ("resunet_se", "bn", "0", {}),
    ("attention_unet", "bn", "0", {}),
    ("attention_unet", "in", "1", {}),
    ("resunet_se", "bn", "1", _OTHER_PATHS),
], ids=["resunet-bn-0", "resunet-bn-1", "unet-bn-0", "unet-bn-1", "resunet-in-1",
        "unet-gn-0", "resunet-other", "unet-other", "seunet-bn-1", "resunet_se-bn-0",
        "attention_unet-bn-0", "attention_unet-in-1", "resunet_se-other"])
def test_unet_family_matches_flax(variant, norm, fold, extra, monkeypatch):
    monkeypatch.setenv("BIAPY_TPU_FOLD3D", fold)
    rng = np.random.default_rng(0)
    kw = _model_kwargs(variant, norm, **extra)
    flax_model = FlaxUNet(**kw, drop_values=(0.0, 0.0, 0.0))
    x = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    params, stats = _random_variables(
        lambda k, a: flax_model.init(k, a, train=False), x.shape, rng)
    jvars = {"params": params, **({"batch_stats": stats} if stats else {})}
    ref = np.asarray(flax_model.apply(jvars, jnp.asarray(x), train=False))

    model = UNetFamily(**kw, in_channels=1, gen=torch.Generator().manual_seed(0)).eval()
    load_flax_variables(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()

    n_flax = sum(int(np.prod(np.shape(p))) for p in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_flax
    assert got.shape == ref.shape
    # ten-odd float32 layers summed in other orders: differences ~1e-6
    # relative; outputs are O(1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("scale", [(2, 2, 2), (1, 2, 2), (2, 1, 3)])
def test_conv_transpose_mirroring_matches_flax(scale):
    """kernel == stride ConvTranspose: lax.conv_transpose mirrors the kernel,
    so output phase a takes tap s-1-a on every axis."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    m = FlaxConvTranspose(7, kernel_size=scale, strides=scale)
    params, _ = _random_variables(m.init, x.shape, rng)
    ref = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    t = ConvTranspose(6, 7, scale)
    load_flax_variables(t, params)
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)  # one 6-term f32 dot per voxel


def test_weight_bridge_checks_names_and_shapes():
    kw = _model_kwargs("resunet", "bn")
    model = UNetFamily(**kw, in_channels=1)
    flax_model = FlaxUNet(**kw)
    params, stats = _random_variables(lambda k, a: flax_model.init(k, a, train=False),
                                      (1, 8, 8, 8, 1), np.random.default_rng(2))
    load_flax_variables(model, params, stats)

    missing = dict(params)
    missing.pop("Conv_0")
    with pytest.raises(KeyError, match="Conv_0"):
        load_flax_variables(model, missing, stats)
    extra = dict(params, Extra_0={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="Extra_0"):
        load_flax_variables(model, extra, stats)
    bad = jax.tree.map(lambda a: a, params)
    bad["Conv_0"] = dict(bad["Conv_0"], bias=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="Conv_0/bias"):
        load_flax_variables(model, bad, stats)
    with pytest.raises(KeyError, match="batch_stats"):
        load_flax_variables(model, params, {})
