"""The port's training step against the JAX package.

- losses and the IoU metric against ``biapy_tpu.engine.metrics``;
- schedules and each optimizer against the optax transformations that
  ``biapy_tpu.engine.schedulers.build_optimizer`` builds, over five updates
  of a small tree, gradient clipping and layer freezing included;
- whole training steps: one dict config goes through both packages' job
  APIs, the JAX workflow's Flax initialisation is carried into the port by
  ``load_flax_variables``, and three steps of ``make_train_step`` run on
  both sides from the same seeded batch: loss, gradients, updated weights
  and BatchNorm statistics must agree.

Inputs come from a numpy seed and go to both sides. Dropout is 0 in the
parity cases (the two packages' random streams cannot agree); its rate and
scaling have their own test.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.config.config import get_cfg_defaults as jax_cfg_defaults
from biapy_tpu.engine import metrics as JM
from biapy_tpu.engine import schedulers as JS
from biapy_tpu.engine.train_engine import make_train_step as jax_make_train_step
from biapy_tpu_torch.config.config import get_cfg_defaults
from biapy_tpu_torch.engine import metrics as M
from biapy_tpu_torch.engine import schedulers as S
from biapy_tpu_torch.engine.train_engine import (loss_and_grads, make_eval_step,
                                                 make_train_step, resolve_mixed_precision)
from biapy_tpu_torch.models.blocks import BatchNorm, Dropout, dropout_generator
from biapy_tpu_torch.models.flax_import import (export_flax_variables, flatten,
                                                load_flax_variables)

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# losses and metrics
# --------------------------------------------------------------------------
def _binary(rng, ignore=False):
    logits = rng.standard_normal((2, 4, 5, 6, 1)).astype(np.float32) * 2
    y = (rng.random((2, 4, 5, 6, 1)) > 0.7).astype(np.float32)
    if ignore:
        y[rng.random(y.shape) > 0.8] = 255.0
    return logits, y


def _multi(rng, ignore=False):
    logits = rng.standard_normal((2, 4, 5, 6, 3)).astype(np.float32) * 2
    y = rng.integers(0, 3, (2, 4, 5, 6, 1)).astype(np.float32)
    if ignore:
        y[rng.random(y.shape) > 0.8] = 255.0
    return logits, y


_LOSS_CASES = {
    "ce-binary": ("cross_entropy_loss", _binary, dict()),
    "ce-binary-auto": ("cross_entropy_loss", _binary, dict(class_rebalance="auto")),
    "ce-binary-manual": ("cross_entropy_loss", _binary,
                         dict(class_rebalance="manual", class_weights=[0.3, 1.7])),
    "ce-binary-ignore": ("cross_entropy_loss", _binary, dict(ignore_index=255)),
    "ce-multi": ("cross_entropy_loss", _multi, dict(num_classes=3)),
    "ce-multi-manual-ignore": ("cross_entropy_loss", _multi,
                               dict(num_classes=3, class_rebalance="manual",
                                    class_weights=[0.2, 1.0, 2.0], ignore_index=255)),
    "dice": ("dice_loss", _binary, dict()),
    "dice-ce-binary": ("dice_ce_loss", _binary, dict(w_dice=0.3, w_ce=0.7)),
    "dice-ce-binary-ignore": ("dice_ce_loss", _binary, dict(ignore_index=255)),
    "dice-ce-multi": ("dice_ce_loss", _multi, dict(num_classes=3)),
    "dice-ce-multi-ignore": ("dice_ce_loss", _multi, dict(num_classes=3, ignore_index=255)),
    "iou-binary": ("jaccard_index", _binary, dict()),
    "iou-binary-ignore": ("jaccard_index", _binary, dict(ignore_index=255)),
    "iou-multi": ("jaccard_index", _multi, dict(num_classes=3)),
    "iou-multi-ignore": ("jaccard_index", _multi, dict(num_classes=3, ignore_index=255)),
}


@pytest.mark.parametrize("case", sorted(_LOSS_CASES))
def test_losses_and_metrics_match_jax(case):
    fn, make, kw = _LOSS_CASES[case]
    logits, y = make(np.random.default_rng(len(case)), ignore="ignore_index" in kw)
    ref = float(getattr(JM, fn)(jnp.asarray(logits), jnp.asarray(y), **kw))
    got = float(getattr(M, fn)(torch.from_numpy(logits), torch.from_numpy(y), **kw))
    # float32 means over 240 voxels, transcendental functions of two libraries
    assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref)), (got, ref)


def test_elementwise_losses_match_jax():
    rng = np.random.default_rng(0)
    logits, y = _binary(rng)
    np.testing.assert_allclose(
        M.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(y)).numpy(),
        np.asarray(JM.bce_with_logits(jnp.asarray(logits), jnp.asarray(y))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        M.weight_binary_ratio(torch.from_numpy(y)).numpy(),
        np.asarray(JM.weight_binary_ratio(jnp.asarray(y))), rtol=1e-6, atol=0)
    ml, my = _multi(rng)
    mask = (rng.random(my.shape) > 0.5).astype(np.float32)
    ref = float(JM.softmax_ce_with_logits(jnp.asarray(ml), jnp.asarray(my), mask=jnp.asarray(mask)))
    got = float(M.softmax_ce_with_logits(torch.from_numpy(ml), torch.from_numpy(my),
                                         mask=torch.from_numpy(mask)))
    assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref))


# --------------------------------------------------------------------------
# schedules and optimizers against optax
# --------------------------------------------------------------------------
def _opt_cfgs(overrides):
    out = []
    for defaults in (jax_cfg_defaults, get_cfg_defaults):
        cfg = defaults()
        cfg.merge_from_dict(copy.deepcopy(overrides))
        out.append(cfg)
    return out


_SCHED = {
    "constant": {},
    "warmupcosine": {"NAME": "warmupcosine", "WARMUP_COSINE_DECAY_EPOCHS": 1, "MIN_LR": [1e-4]},
    "onecycle": {"NAME": "onecycle"},
    "plateau": {"NAME": "reduceonplateau", "REDUCEONPLATEAU_PATIENCE": 0},
    "warmupplateau": {"NAME": "warmupreduceonplateau", "WARMUP_COSINE_DECAY_EPOCHS": 2,
                      "REDUCEONPLATEAU_PATIENCE": 0},
}


@pytest.mark.parametrize("clip,freeze", [(0.0, False), (0.5, True)], ids=["plain", "clip-freeze"])
@pytest.mark.parametrize("sched", sorted(_SCHED))
@pytest.mark.parametrize("opt", ["SGD", "ADAM", "ADAMW"])
def test_optimizer_matches_optax_over_five_updates(opt, sched, clip, freeze):
    """Same parameters, same five gradients: the weights after every update
    and the learning rate read back agree with optax within 1e-6 (float32
    arithmetic in another order). Three steps per epoch and two epochs, so
    the five updates cross the warm-up and reach the decay; the plateau
    controllers lower the rate after update 3."""
    overrides = {"TRAIN": {"OPTIMIZER": [opt], "LR": [0.05], "W_DECAY": 0.02, "EPOCHS": 2,
                           "OPT_BETAS": [[0.8, 0.95]], "GRADIENT_CLIP_NORM": clip,
                           "LR_SCHEDULER": _SCHED[sched]},
                 "MODEL": {"FREEZE_LAYERS_MATCHING": ["^b/"] if freeze else []}}
    jcfg, tcfg = _opt_cfgs(overrides)
    rng = np.random.default_rng(0)
    shapes = {"a": {"kernel": (3, 4), "bias": (4,)}, "b": {"kernel": (4, 2)}}
    p0 = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                      is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), p0)
             for _ in range(5)]

    tx, jplateau = JS.build_optimizer(jcfg, 3)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = tx.init(jparams)

    tparams = {k.replace("/", "."): torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in flatten(p0).items()}
    topt, tplateau = S.build_optimizer(tcfg, 3, tparams.items())
    assert (jplateau is None) == (tplateau is None)
    assert abs(S.get_learning_rate(topt) - JS.get_learning_rate(jstate)) <= 1e-6

    for i, g in enumerate(grads):
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.update({k.replace("/", "."): torch.from_numpy(v) for k, v in flatten(g).items()})
        for k, ref in flatten(jparams).items():
            np.testing.assert_allclose(tparams[k.replace("/", ".")].detach().numpy(),
                                       np.asarray(ref), rtol=0, atol=1e-6, err_msg=f"{k} @ {i}")
        assert abs(S.get_learning_rate(topt) - JS.get_learning_rate(jstate)) <= 1e-6
        if jplateau is not None and i == 2:
            for loss in (1.0, 1.0):  # no improvement, patience 0: halve
                new_lr = jplateau.step(loss)
                assert tplateau.step(loss) == new_lr
            assert new_lr == 0.025
            jstate = JS.set_learning_rate(jstate, new_lr)
            S.set_learning_rate(topt, new_lr)
    if freeze:
        np.testing.assert_array_equal(tparams["b.kernel"].detach().numpy(), p0["b"]["kernel"])
        assert not tparams["b.kernel"].requires_grad


def test_optimizer_update_is_dropped_where_ok_is_false():
    p = torch.nn.Parameter(torch.ones(3))
    opt = S.Optimizer([("p", p)], "ADAMW", 0.1, weight_decay=0.02)
    before = {k: v.clone() for k, v in opt.state.items()}
    opt.update({"p": torch.full((3,), float("nan"))}, ok=torch.tensor(False))
    assert torch.equal(p.detach(), torch.ones(3))
    for k, v in opt.state.items():
        assert torch.equal(v, before[k]), k
    opt.update({"p": torch.ones(3)}, ok=torch.tensor(True))
    assert float(opt.state["count"]) == 1.0 and not torch.equal(p.detach(), torch.ones(3))


def test_multihead_optimizers_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        S.build_multihead_optimizer(None, 1, None, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        S.head_param_labels(None, None, None, None, None)


# --------------------------------------------------------------------------
# blocks in training mode
# --------------------------------------------------------------------------
def test_batchnorm_training_matches_flax_with_biased_running_variance():
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 3, 4, 5, 6)) * 2 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0, 0.2, 6).astype(np.float32)
    fbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
    ref, upd = fbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(6).train()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    # the BIASED batch variance (torch's BatchNorm would store n/(n-1) of it)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)
    n = x.size // 6
    assert abs(bn.var.numpy()[0] - (0.9 + 0.1 * x[..., 0].var())) < 1e-5
    assert abs(bn.var.numpy()[0] - (0.9 + 0.1 * x[..., 0].var() * n / (n - 1))) > 1e-4
    # bf16 activations: float32 statistics and buffers, bf16 out
    out = bn(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and bn.mean.dtype == torch.float32
    # eval: the buffers are read, not written
    before = bn.mean.clone()
    bn.eval()(torch.from_numpy(x))
    assert torch.equal(bn.mean, before)


def test_dropout_rate_scaling_and_generator():
    d = Dropout(0.25).train()
    x = torch.ones(200_000)
    with dropout_generator(torch.Generator().manual_seed(0)):
        a = d(x)
    with dropout_generator(torch.Generator().manual_seed(0)):
        b = d(x)
    assert torch.equal(a, b)  # the explicit generator decides the mask
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01  # rate
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))  # scaling
    assert torch.equal(d.eval()(x), x)  # identity in eval
    assert torch.equal(Dropout(1.0).train()(x), torch.zeros_like(x))


# --------------------------------------------------------------------------
# whole training steps
# --------------------------------------------------------------------------
def _cfg(arch="resunet", norm="bn", larger_io=False, train=None):
    return {
        "PROBLEM": {"TYPE": "SEMANTIC_SEG", "NDIM": "3D"},
        "MODEL": {"ARCHITECTURE": arch, "FEATURE_MAPS": [4, 8], "DROPOUT_VALUES": [0.0, 0.0],
                  "Z_DOWN": [2], "YX_DOWN": [2], "CONV_LAYERS": [2, 2], "NORMALIZATION": norm,
                  "ACTIVATION": "elu", "LARGER_IO": larger_io},
        "DATA": {"PATCH_SIZE": [16, 16, 16, 1]},
        # a learning rate at which three updates move the weights far beyond
        # the tolerances below
        "TRAIN": dict({"ENABLE": True, "BATCH_SIZE": 2, "OPTIMIZER": ["SGD"], "LR": [0.05]},
                      **(train or {})),
        "TEST": {"ENABLE": False},
    }


def _batch(seed=1, nan=False):
    rng = np.random.default_rng(seed)
    x = rng.random((2, 16, 16, 16, 1), dtype=np.float32)
    y = (rng.random((2, 16, 16, 16, 1), dtype=np.float32) > 0.5).astype(np.float32)
    if nan:
        x[0, 3, 4, 5, 0] = np.nan
    return {"x": x, "y": y}


def _jobs(cfg, tmp_path):
    """Both packages' workflows built from one config, the port's model
    loaded with the JAX workflow's Flax initialisation."""
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
    load_flax_variables(twf.model, jax.tree.map(np.asarray, jwf.state.params),
                        jax.tree.map(np.asarray, jwf.state.batch_stats))
    return jwf, twf


def _tree_close(got, ref, tol, what):
    got, ref = flatten(got), flatten(ref)
    assert set(got) == set(ref)
    for k in ref:
        r = np.asarray(ref[k], np.float32)
        scale = max(1.0, float(np.abs(r).max()))
        err = float(np.abs(got[k] - r).max())
        assert err <= tol * scale, f"{what} {k}: max err {err:.3g} > {tol} * {scale:.3g}"


def _moved(before, after):
    b, a = flatten(before), flatten(after)
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)


@pytest.mark.parametrize("arch,norm,larger_io,mixed,train", [
    ("resunet", "bn", False, False, None),
    ("unet", "none", False, False, {"OPTIMIZER": ["ADAMW"], "LR": [0.002]}),
    ("resunet", "bn", True, False, {"GRADIENT_CLIP_NORM": 0.5}),
    ("resunet", "bn", False, True, None),
    ("seunet", "bn", False, False, None),
    ("resunet_se", "bn", False, False, None),
    ("attention_unet", "bn", False, False, None),
], ids=["resunet-sgd", "unet-adamw", "larger-io-clip", "resunet-mixed", "seunet-sgd",
        "resunet_se-sgd", "attention_unet-sgd"])
def test_three_train_steps_match_jax(arch, norm, larger_io, mixed, train, tmp_path):
    """Loss of every step, weights and BatchNorm statistics after step 3.
    Float32: 1e-4 of each tensor's scale (about twenty float32 layers,
    forward and backward, summed in other orders, three times over). Mixed
    precision: 3e-2 (bf16 rounds at other places in the two frameworks)."""
    tol = 3e-2 if mixed else 1e-4
    jwf, twf = _jobs(_cfg(arch, norm, larger_io, train), tmp_path)
    p0, _ = export_flax_variables(twf.model)
    jstep = jax_make_train_step(jwf.loss, jwf.train_metrics, donate=False,
                                mixed_precision=mixed)
    tstep = make_train_step(twf.loss, twf.train_metrics, mixed_precision=mixed)
    batch = _batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    jstate, tstate = jwf.state, twf.state
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, batch)
        for k in ("loss", "iou"):
            # the IoU counts thresholded voxels: a logit within rounding of 0
            # may flip one of 8192
            mtol = tol if k == "loss" else max(tol, 2e-3)
            assert abs(float(tm[k]) - float(jm[k])) <= mtol, (i, k, float(tm[k]), float(jm[k]))
    assert tstate.step == 3 and int(jstate.step) == 3
    params, stats = export_flax_variables(tstate.model)
    assert _moved(p0, params) > 30 * tol or mixed
    _tree_close(params, jstate.params, tol, "params")
    _tree_close(stats, jstate.batch_stats, tol, "batch_stats")
    # the updated model still serves: predict runs it in eval mode and
    # writes no statistics
    with twf.inference_pass():
        twf.predict_block_on_device(batch["x"][0])
    assert not twf.model.training
    _tree_close(export_flax_variables(twf.model)[1], stats, 0.0, "batch_stats after predict")


def test_gradients_of_first_step_match_jax(tmp_path):
    """Every gradient of step 1 (LARGER_IO on, so the 3x3x3 kernel's VJP,
    the cat2d convs, the pool's eq-mask and zd2s's inverse all take part)
    within 1e-4 of its tensor's scale."""
    jwf, twf = _jobs(_cfg("resunet", "bn", True), tmp_path)
    batch = _batch(seed=2)
    state = jwf.state

    def loss_of(params):
        out, _ = state.apply_fn({"params": params, "batch_stats": state.batch_stats},
                                jnp.asarray(batch["x"]), train=True, mutable=["batch_stats"])
        return jwf.loss(out, jnp.asarray(batch["y"]))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(state.params)
    loss, _, grads = loss_and_grads(twf.model, twf.loss, torch.from_numpy(batch["x"]),
                                    torch.from_numpy(batch["y"]))
    assert abs(float(loss) - float(jloss)) <= 1e-5
    got = {k.replace(".", "/"): v.numpy() for k, v in grads.items()}
    _tree_close(got, jax.tree.map(np.asarray, jgrads), 1e-4, "grad")
    assert max(float(np.abs(g).max()) for g in got.values()) > 1e-2


def test_nan_batch_leaves_weights_unchanged_on_both_sides(tmp_path):
    """A non-finite loss: weights and optimizer state stay, the step count
    and the BatchNorm statistics advance, and the next clean step trains."""
    jwf, twf = _jobs(_cfg(train={"OPTIMIZER": ["ADAM"], "LR": [0.01]}), tmp_path)
    jstep = jax_make_train_step(jwf.loss, jwf.train_metrics, donate=False)
    tstep = make_train_step(twf.loss, twf.train_metrics)
    p0, s0 = export_flax_variables(twf.model)
    opt0 = {k: v.clone() for k, v in twf.state.optimizer.state.items()}
    bad = _batch(nan=True)
    jstate, jm = jstep(jwf.state, jax.tree.map(jnp.asarray, bad), jax.random.PRNGKey(0))
    tstate, tm = tstep(twf.state, bad)
    assert not np.isfinite(float(jm["loss"])) and not np.isfinite(float(tm["loss"]))
    params, stats = export_flax_variables(tstate.model)
    _tree_close(params, p0, 0.0, "params after NaN")
    _tree_close(jax.tree.map(np.asarray, jstate.params), p0, 0.0, "JAX params after NaN")
    for k, v in tstate.optimizer.state.items():
        assert torch.equal(v, opt0[k]), k
    assert tstate.step == 1 and int(jstate.step) == 1
    # the statistics did advance (and took the NaN with them, as in Flax)
    assert _moved(s0, {k: np.nan_to_num(v, nan=9.0) for k, v in flatten(stats).items()}) > 0
    jstats = flatten(jax.tree.map(np.asarray, jstate.batch_stats))
    for k, v in flatten(stats).items():
        np.testing.assert_array_equal(np.isnan(v), np.isnan(jstats[k]))


def test_eval_step_and_mixed_precision_setting(tmp_path):
    _, twf = _jobs(_cfg(), tmp_path)
    _, stats = export_flax_variables(twf.model)
    m = make_eval_step(twf.loss, twf.train_metrics)(twf.state, _batch())
    assert np.isfinite(float(m["loss"])) and 0.0 <= float(m["iou"]) <= 1.0
    _tree_close(export_flax_variables(twf.model)[1], stats, 0.0, "eval writes no statistics")
    assert resolve_mixed_precision("auto", "cpu") is False
    assert resolve_mixed_precision("auto", torch.device("cuda:0")) is True
    assert resolve_mixed_precision(True, "cpu") is True
    assert resolve_mixed_precision("false", "cuda:0") is False


def test_epoch_loop_names_the_roadmap(tmp_path):
    """The epoch loop runs (tests/test_torch_job.py), and so does what it
    once refused naming the roadmap: LOG.PROFILE_STEPS (ROADMAP item 7,
    the profiler hook). A CPU run with PROFILE_STEPS 2 writes a
    ``torch.profiler`` trace of steps 3 and 4 (counted over the run, here
    across the epoch boundary) into PATHS.PROFILER and trains the same
    steps as a run without it."""
    import json

    from test_torch_job import _cfg as job_cfg
    from test_torch_job import _make_volumes

    root = str(tmp_path)
    _make_volumes(root, "train", 2, (16, 32, 32), 0)
    runs = {}
    for steps in (0, 2):
        cfg = job_cfg(root)
        cfg["TEST"]["ENABLE"] = False
        cfg["LOG"]["PROFILE_STEPS"] = steps
        job = biapy_tpu_torch.BiaPy(cfg, result_dir=f"{root}/p{steps}", name="t", silent=True,
                                    device="cpu")
        job.train()
        runs[steps] = job.workflow
    prof = runs[2].profiler
    assert runs[0].profiler.path is None and prof.done and prof.seen == 5
    assert len(runs[2].train_loader) < 5  # the trace ran on into the second epoch
    assert prof.path == f"{runs[2].cfg.PATHS.PROFILER}/t_trace.json"
    with open(prof.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    assert [(h["loss"], h["val_loss"]) for h in runs[2].history] == \
        [(h["loss"], h["val_loss"]) for h in runs[0].history]
