"""The port's super-resolution family against the JAX package.

- ``pixel_shuffle``: bit-equal to JAX's in 2D and 3D at scales 2, 3 and 4
  with 1 and 3 output channels (the JAX layout splits the channels as
  ``(r, r[, r], out_c)``, not as ``torch.nn.PixelShuffle`` does).
- EDSR (x2 and x4), RCAN (x2, x3), WDSR and DFCAN in 2D, RCAN and DFCAN in
  3D at small widths and depths: the same seeded Flax variables (every
  leaf, carried over by ``load_flax_variables``) and inputs through both
  modules, float32, within 1e-5 of the output's scale, 1e-4 for DFCAN
  (its FFT sums in another order on each side).
- Every Flax leaf name and shape equal to the port's at the templates'
  defaults (``jax.eval_shape``, nothing runs): RCAN 10 x 20 x 16 in 2D and
  3D, DFCAN in 2D and 3D, WDSR and EDSR in 2D.
- WDSR's WeightNorm: its scale is one Flax leaf whose key holds slashes
  (``WeightNorm_<i>/"Conv_<i>/kernel/scale"``); the checkpoint bytes of the
  parameter tree are the same from either package's writer, and a
  checkpoint written by either package loads into the other and gives the
  same output.
- One float32 ADAM training step of 2D RCAN through both workflows' train
  steps: the loss within 2e-5, the updated weights within 1e-5 of each
  tensor's scale.
- The JAX factory's rule ``scale = UPSCALING[-1]``, pinned in both
  packages: under the 3D template's anisotropic ``(1, 2, 2)`` RCAN doubles
  z as well, and the first training step fails at the loss (the output is
  twice the HR target in z); outside super-resolution (empty UPSCALING) the
  family builds x2 on every axis.
- ``chip_smoke.py``'s conv3d and zcat rows for phase 14 (c) are the shapes
  the 3D template's RCAN and DFCAN give at UPSCALING (2, 2, 2), its launch
  reader's routes are those of each conv's dtype in a bf16 forward (DFCAN's
  FFT makes float32 of everything after the first FCAB's third conv, as
  JAX's type promotion does), and its per-forward counts are the model's.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.engine.train_engine import make_train_step as jax_make_train_step
from biapy_tpu.models import sr_models as J
from biapy_tpu.utils.misc import apply_checkpoint_params as jax_apply_checkpoint_params
from biapy_tpu.utils.misc import load_checkpoint as jax_load_checkpoint
from biapy_tpu_torch.engine.train_engine import make_train_step
from biapy_tpu_torch.models import sr_models as T
from biapy_tpu_torch.models.flax_import import (apply_checkpoint_params, export_flax_variables,
                                                flatten, load_flax_variables)
from biapy_tpu_torch.utils.flax_msgpack import msgpack_serialize
from biapy_tpu_torch.utils.misc import load_checkpoint
from test_torch_train import _moved, _tree_close

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, tol, scale)


def _leaf(path, s, rng):
    """Seeded values: kernels ~ N(0, 1/fan_in), WeightNorm scales in [0.5,
    1.5], biases ~ N(0, 0.2)."""
    name = path[-1].key
    if name == "kernel":
        return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
    if name.endswith("scale"):
        return (1.0 + rng.uniform(-0.5, 0.5, s.shape)).astype(np.float32)
    return rng.normal(0.0, 0.2, s.shape).astype(np.float32)


def _seeded(flax_model, x_shape, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: flax_model.init(jax.random.PRNGKey(0), jnp.zeros(x_shape)))
    return jax.tree_util.tree_map_with_path(lambda p, s: _leaf(p, s, rng), shapes)["params"]


# --------------------------------------------------------------------------
# pixel shuffle
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("out_c", [1, 3])
def test_pixel_shuffle_is_jax_bit_for_bit(ndim, scale, out_c):
    rng = np.random.default_rng(scale * 10 + out_c)
    spatial = (3, 4, 5)[3 - ndim:]
    x = rng.standard_normal((2,) + spatial + (out_c * scale ** ndim,)).astype(np.float32)
    ref = np.asarray(J.pixel_shuffle(jnp.asarray(x), scale))
    got = T.pixel_shuffle(torch.from_numpy(x), scale).numpy()
    assert got.shape == ref.shape == (2,) + tuple(s * scale for s in spatial) + (out_c,)
    assert np.array_equal(got, ref)


# --------------------------------------------------------------------------
# the models in eval, float32
# --------------------------------------------------------------------------
CASES = {
    "edsr-2d-x2": (J.EDSR, T.EDSR, dict(ndim=2, scale=2, num_filters=8, num_res_blocks=2), 1e-5),
    "edsr-2d-x4": (J.EDSR, T.EDSR, dict(ndim=2, scale=4, num_filters=8, num_res_blocks=1,
                                        num_channels=2), 1e-5),
    "rcan-2d-x2": (J.RCAN, T.RCAN, dict(ndim=2, scale=2, filters=8, num_rg=1, num_rcab=2,
                                        reduction=4), 1e-5),
    "rcan-2d-x3-out2": (J.RCAN, T.RCAN, dict(ndim=2, scale=3, filters=8, num_rg=2, num_rcab=1,
                                             reduction=4, out_channels=2), 1e-5),
    "wdsr-2d": (J.WDSR, T.WDSR, dict(ndim=2, scale=2, num_filters=8, num_res_blocks=2,
                                     res_block_expansion=2), 1e-5),
    "dfcan-2d": (J.DFCAN, T.DFCAN, dict(ndim=2, scale=2, n_resgroup=1, n_rcab=2), 1e-4),
    "rcan-3d": (J.RCAN, T.RCAN, dict(ndim=3, scale=2, filters=8, num_rg=1, num_rcab=2,
                                     reduction=4), 1e-5),
    "dfcan-3d": (J.DFCAN, T.DFCAN, dict(ndim=3, scale=2, n_resgroup=1, n_rcab=1), 1e-4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_flax(case):
    jcls, tcls, kw, tol = CASES[case]
    nd = kw["ndim"]
    x_shape = (2,) + ((4, 6, 5) if nd == 3 else (10, 9)) + (kw.get("num_channels", 1),)
    fm = jcls(**kw)
    params = _seeded(fm, x_shape, 0)
    x = np.random.default_rng(1).standard_normal(x_shape).astype(np.float32)
    ref = np.asarray(jax.jit(fm.apply)({"params": params}, jnp.asarray(x)))
    model = tcls(**kw).eval()
    load_flax_variables(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape[1:-1] == tuple(s * kw["scale"] for s in x_shape[1:-1])
    _close(got, ref, tol)


# --------------------------------------------------------------------------
# leaf names and shapes at the templates' defaults
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,ndim", [("rcan", 2), ("rcan", 3), ("dfcan", 2), ("dfcan", 3),
                                       ("wdsr", 2), ("edsr", 2)])
def test_leaves_match_flax_at_the_defaults(arch, ndim):
    """The Flax modules' and the port's defaults (RCAN's: MODEL.RCAN_*)."""
    jcls = {"rcan": J.RCAN, "dfcan": J.DFCAN, "wdsr": J.WDSR, "edsr": J.EDSR}[arch]
    tcls = {"rcan": T.RCAN, "dfcan": T.DFCAN, "wdsr": T.WDSR, "edsr": T.EDSR}[arch]
    x_shape = (1,) + (8,) * ndim + (1,)
    shapes = jax.eval_shape(lambda: jcls(ndim=ndim).init(jax.random.PRNGKey(0),
                                                          jnp.zeros(x_shape)))
    want = {k: tuple(v.shape) for k, v in flatten(shapes["params"]).items()}
    got = {n.replace(".", "/"): tuple(p.shape) for n, p in tcls(ndim=ndim).named_parameters()}
    assert got == want
    assert not list(tcls(ndim=ndim).buffers())


# --------------------------------------------------------------------------
# WDSR's WeightNorm through checkpoints, both ways
# --------------------------------------------------------------------------
WDSR_KW = dict(ndim=2, scale=2, num_filters=8, num_res_blocks=2, res_block_expansion=2)


def test_wdsr_weightnorm_checkpoints_both_ways(tmp_path):
    x_shape = (1, 8, 8, 1)
    fm = J.WDSR(**WDSR_KW)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(x_shape).astype(np.float32))
    target = jax.tree.map(np.asarray, _seeded(fm, x_shape, 4))
    assert target["WeightNorm_1"]["Conv_1/kernel/scale"].shape == (16,)
    # the port writes, the JAX package reads
    model = T.WDSR(**WDSR_KW).eval()
    load_flax_variables(model, _seeded(fm, x_shape, 5))
    params, _ = export_flax_variables(model)
    assert params["WeightNorm_1"]["Conv_1/kernel/scale"].shape == (16,)
    blob = msgpack_serialize({"params": params})
    assert blob == serialization.msgpack_serialize({"params": params})
    (tmp_path / "port.ckpt").write_bytes(blob)
    loaded = jax_load_checkpoint(str(tmp_path / "port.ckpt"))["params"]
    merged = jax_apply_checkpoint_params(target, loaded, skip_unmatched=False)
    with torch.no_grad():
        got = model(torch.from_numpy(np.asarray(x))).numpy()
    _close(got, fm.apply({"params": merged}, x), 1e-5)
    # the JAX package writes, the port reads
    jparams = _seeded(fm, x_shape, 6)
    (tmp_path / "jax.ckpt").write_bytes(serialization.msgpack_serialize({"params": jparams}))
    apply_checkpoint_params(model, load_checkpoint(str(tmp_path / "jax.ckpt"))["params"],
                            skip_unmatched=False)
    with torch.no_grad():
        got = model(torch.from_numpy(np.asarray(x))).numpy()
    _close(got, fm.apply({"params": jparams}, x), 1e-5)


# --------------------------------------------------------------------------
# through the workflows
# --------------------------------------------------------------------------
def _sr_cfg(ndim, upscaling, arch="rcan", ptype="SUPER_RESOLUTION"):
    patch = [4, 8, 8, 1] if ndim == 3 else [12, 12, 1]
    prob = {"TYPE": ptype, "NDIM": f"{ndim}D"}
    if upscaling is not None:
        prob["SUPER_RESOLUTION"] = {"UPSCALING": list(upscaling)}
    return {"PROBLEM": prob,
            "DATA": {"PATCH_SIZE": patch, "NORMALIZATION": {"TYPE": "div"}},
            "MODEL": {"ARCHITECTURE": arch, "RCAN_RG_BLOCK_NUM": 1, "RCAN_RCAB_BLOCK_NUM": 2,
                      "RCAN_CONV_FILTERS": 8, "RCAN_REDUCTION_RATIO": 4},
            "TRAIN": {"ENABLE": True, "BATCH_SIZE": 2, "OPTIMIZER": "ADAM", "LR": 1e-4,
                      "MIXED_PRECISION": False},
            "TEST": {"ENABLE": False}}


def _workflows(cfg, tmp_path):
    jjob = biapy_tpu.BiaPy(copy.deepcopy(cfg), result_dir=str(tmp_path), name="jax",
                           silent=True, check_data_paths=False)
    jjob._build_workflow()
    jwf = jjob.workflow
    jwf.prepare_model()
    tjob = biapy_tpu_torch.BiaPy(copy.deepcopy(cfg), result_dir=str(tmp_path), name="torch",
                                 silent=True, check_data_paths=False, device="cpu")
    tjob._build_workflow()
    twf = tjob.workflow
    twf.prepare_model()
    return jwf, twf


def test_rcan_adam_step_matches_jax(tmp_path):
    jwf, twf = _workflows(_sr_cfg(2, (2, 2)), tmp_path)
    load_flax_variables(twf.model, jax.tree.map(np.asarray, jwf.state.params))
    p0, _ = export_flax_variables(twf.model)
    rng = np.random.default_rng(7)
    batch = {"x": rng.uniform(0, 1, (2, 12, 12, 1)).astype(np.float32),
             "y": rng.uniform(0, 1, (2, 24, 24, 1)).astype(np.float32)}
    jstate, jm = jax_make_train_step(jwf.loss, jwf.train_metrics, donate=False)(
        jwf.state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    tstate, tm = make_train_step(twf.loss, twf.train_metrics)(twf.state, batch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-5
    params, _ = export_flax_variables(tstate.model)
    assert _moved(p0, params) > 5e-5  # ADAM's first step moves each weight by about lr
    _tree_close(params, jax.tree.map(np.asarray, jstate.params), 1e-5, "params")


def test_sr_anisotropic_upscaling_fails_at_the_loss_in_both_packages(tmp_path):
    """A fault of the reference, kept for parity: ``scale = UPSCALING[-1]``
    and ``pixel_shuffle`` shuffles every axis, so under the 3D template's
    ``(1, 2, 2)`` RCAN doubles z too and the first step's loss cannot take
    the HR target (z not doubled)."""
    jwf, twf = _workflows(_sr_cfg(3, (1, 2, 2)), tmp_path)
    batch = {"x": np.zeros((2, 4, 8, 8, 1), np.float32),
             "y": np.zeros((2, 4, 16, 16, 1), np.float32)}
    jout = jwf.state.apply_fn({"params": jwf.state.params}, jnp.asarray(batch["x"]))
    with torch.no_grad():
        tout = twf.model(torch.from_numpy(batch["x"]))
    assert tuple(jout.shape) == tuple(tout.shape) == (2, 8, 16, 16, 1)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_make_train_step(jwf.loss, jwf.train_metrics, donate=False)(
            jwf.state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    with pytest.raises(RuntimeError, match="must match"):
        make_train_step(twf.loss, twf.train_metrics)(twf.state, batch)


@pytest.mark.parametrize("arch,ptype", [("rcan", "SEMANTIC_SEG"), ("edsr", "IMAGE_TO_IMAGE"),
                                        ("dfcan", "SELF_SUPERVISED")])
def test_sr_family_outside_super_resolution_builds_x2(arch, ptype, tmp_path):
    """With UPSCALING empty (any workflow but SR) the JAX factory builds
    scale 2 on every axis; the port builds the same model."""
    jwf, twf = _workflows(_sr_cfg(2, None, arch, ptype), tmp_path)
    x = np.zeros((1, 12, 12, 1), np.float32)
    jout = jwf.state.apply_fn({"params": jwf.state.params}, jnp.asarray(x))
    with torch.no_grad():
        tout = twf.model(torch.from_numpy(x))
    assert tuple(jout.shape) == tuple(tout.shape) == (1, 24, 24, jout.shape[-1])
    assert twf.model_build_kwargs["scale"] == jwf.model_build_kwargs["scale"] == 2


# --------------------------------------------------------------------------
# the card run's rows
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["rcan", "dfcan"])
def test_chip_smoke_sr3d_rows_and_routes_are_the_models(arch, tmp_path):
    """``chip_smoke.py`` phase 3 holds conv3d and zcat at the shapes phase
    14 (c) gives them (the 3D template's patch and batch at UPSCALING (2, 2,
    2)), and phase 14 (c) holds the launches by route to ``_sr_launches``,
    which reads each conv's dtype off the model. One bf16 forward at batch
    1 and a reduced depth here records every 3x3x3 conv's input and output
    shape and input dtype: DFCAN's spectrum makes float32 of everything
    after the first FCAB's third conv. The full model at the template's
    depth runs ``_sr3d_step_counts`` of each shape."""
    import yaml

    from biapy_tpu_torch.models.blocks import Conv
    from biapy_tpu_torch.ops.kernels.conv3d import conv3d_route

    sys.path.insert(0, REPO)
    import chip_smoke

    with open(os.path.join(REPO, "templates/super-resolution/3d_super-resolution.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"]["ARCHITECTURE"] = arch
    raw["PROBLEM"]["SUPER_RESOLUTION"]["UPSCALING"] = [2, 2, 2]
    job = biapy_tpu_torch.BiaPy(copy.deepcopy(raw), result_dir=str(tmp_path), name="t",
                                silent=True, check_data_paths=False, device="cpu")
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    full = [m for m in wf.model.modules()
            if isinstance(m, Conv) and tuple(m.kernel.shape[:3]) == (3, 3, 3)]
    assert len(full) == sum(chip_smoke._sr3d_step_counts(arch))
    model = (T.RCAN(ndim=3, scale=2, filters=16, num_rg=1, num_rcab=1, reduction=16)
             if arch == "rcan" else T.DFCAN(ndim=3, scale=2, n_resgroup=1, n_rcab=2)).eval()
    b = int(wf.cfg.TRAIN.BATCH_SIZE)
    seen = []
    for m in model.modules():
        if isinstance(m, Conv) and tuple(m.kernel.shape[:3]) == (3, 3, 3):
            m.register_forward_hook(lambda m, args, out: seen.append(
                (tuple(args[0].shape[1:4]), args[0].shape[-1], out.shape[-1], args[0].dtype)))
    d, h, w = (int(v) for v in wf.cfg.DATA.PATCH_SIZE[:3])
    with torch.no_grad():
        model(torch.zeros((1, d, h, w, 1), dtype=torch.bfloat16))
    fwd, dx, zcats = chip_smoke._sr3d_rows(arch)
    assert {((b,) + vol, cin, cout) for vol, cin, cout, _ in seen} == set(fwd)
    assert set(dx) == {(v, cout, cin) for v, cin, cout in fwd if cin > 1}
    assert set(zcats) == {((b * v[1],) + v[2:] + (cin,), 3, v[1]) for v, cin, _ in fwd}
    routes = dict.fromkeys(chip_smoke.CONV3D_ROUTE_NAMES, 0)
    for _, cin, cout, dt in seen:
        routes[conv3d_route(dt, cin, cout)] += 1
    assert chip_smoke._sr_launches(model, torch.bfloat16, False)[1] == routes
    if arch == "dfcan":
        assert [dt for *_, dt in seen].count(torch.bfloat16) == 3
