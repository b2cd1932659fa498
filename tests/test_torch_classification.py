"""The port's 3D classification against the JAX package, unit by unit.

- ``SimpleCNN`` and the ViT (embed 32, 2 layers, 2 heads, 3D): the same
  seeded weights (every Flax leaf, carried over by ``load_flax_variables``)
  and inputs through both modules in eval, float32; and one training step
  through both packages' workflows and train steps (SGD and ADAMW), with
  dropout neutralised on both sides (Flax's ``Dropout`` intercepted to the
  identity, the port's at rate 0: the two packages' random streams cannot
  agree). The loss within 2e-5 (against a float64 step, the port's
  float32 loss lies 4.6e-6 away and the JAX package's 1.1e-6:
  ``tools/torch_classification_step_witness.py --case unit``), the updated
  weights and BatchNorm statistics within 1e-5 of each tensor's scale.
- ``accuracy_metric``, ``top_k_accuracy`` (ties rank the lower class
  first) and ``softmax_ce_with_logits`` on ``(B, C)`` logits.
- ``_fit_to_patch`` (crop, pad, mixed axes), ``load_classification_dataset``
  with RESIZE, and the train / validation split of both workflows'
  ``_build_loaders`` (cross-validation folds 1 and 3, SPLIT_TRAIN).
"""

import copy
import os

import numpy as np
import pytest
import torch
from flax import linen as nn

import jax
import jax.numpy as jnp

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.data.tiff import write_tiff
from biapy_tpu.engine import classification as JC
from biapy_tpu.engine import metrics as JM
from biapy_tpu.engine.train_engine import make_train_step as jax_make_train_step
from biapy_tpu.models.simple_cnn import SimpleCNN as FlaxSimpleCNN
from biapy_tpu.models.vit import ViT as FlaxViT
from biapy_tpu_torch.engine import classification as TC
from biapy_tpu_torch.engine import metrics as M
from biapy_tpu_torch.engine.train_engine import loss_and_grads, make_train_step
from biapy_tpu_torch.models.blocks import Dropout
from biapy_tpu_torch.models.flax_import import export_flax_variables, load_flax_variables
from biapy_tpu_torch.models.simple_cnn import SimpleCNN
from biapy_tpu_torch.models.vit import ViT
from test_torch_model import _random_variables
from test_torch_train import _moved, _tree_close

torch.set_num_threads(2)

PATCH = (8, 16, 16, 1)
VIT = dict(ndim=3, img_size=16, patch_size=8, in_channels=1, embed_dim=32, depth=2,
           num_heads=2, mlp_ratio=4.0)


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(got, np.float32) - ref).max())
    assert err <= tol * scale, (err, tol, scale)


# --------------------------------------------------------------------------
# the modules in eval
# --------------------------------------------------------------------------
def test_simple_cnn_matches_flax():
    """Six convs (two 5x5x5 on the cat2d path), two pools, BatchNorm in the
    reference's odd block tails and the channels-last flatten into Dense_0."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2,) + PATCH).astype(np.float32)
    fm = FlaxSimpleCNN(ndim=3, n_classes=3)
    params, stats = _random_variables(lambda k, a: fm.init(k, a, train=False), x.shape, rng)
    ref = np.asarray(fm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))["class"])
    model = SimpleCNN(ndim=3, n_classes=3, input_shape=PATCH).eval()
    load_flax_variables(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 3)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("global_pool,features,final_norm,save", [
    (False, False, True, None), (True, False, True, None),
    (False, True, True, None), (False, True, False, (1, 2)),
], ids=["cls-token", "global-pool", "features", "features-saved-raw"])
def test_vit_matches_flax(global_pool, features, final_norm, save):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    n_classes = 0 if features else 3
    fm = FlaxViT(**VIT, n_classes=n_classes, global_pool=global_pool, final_norm=final_norm)
    params, _ = _random_variables(
        lambda k, a: fm.init(k, a, features=features, save_layers=save), x.shape, rng)
    ref = fm.apply({"params": params}, jnp.asarray(x), features=features, save_layers=save)
    model = ViT(**VIT, n_classes=n_classes, global_pool=global_pool,
                final_norm=final_norm).eval()
    load_flax_variables(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x), features=features, save_layers=save)
    if save:
        (ref, ref_saved), (got, got_saved) = ref, got
        assert len(got_saved) == len(ref_saved) == 2
        for g, r in zip(got_saved, ref_saved):
            _close(g.numpy(), r, 1e-5)
    if not features:
        ref = ref["class"]
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got.numpy(), ref, 1e-5)


# --------------------------------------------------------------------------
# one training step through both workflows
# --------------------------------------------------------------------------
def _cfg(arch, optimizer, lr):
    model = {"ARCHITECTURE": arch}
    patch = list(PATCH)
    if arch == "vit":
        model.update(VIT_TOKEN_SIZE=8, VIT_EMBED_DIM=32, VIT_NUM_LAYERS=2, VIT_NUM_HEADS=2)
        patch = [16, 16, 16, 1]
    return {"PROBLEM": {"TYPE": "CLASSIFICATION", "NDIM": "3D"},
            "DATA": {"PATCH_SIZE": patch, "N_CLASSES": 3},
            "MODEL": model,
            "TRAIN": {"ENABLE": True, "BATCH_SIZE": 4, "OPTIMIZER": [optimizer], "LR": [lr],
                      "MIXED_PRECISION": False},
            "TEST": {"ENABLE": False}}


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.mark.parametrize("arch,optimizer,lr", [
    ("simple_cnn", "SGD", 0.05), ("simple_cnn", "ADAMW", 1e-3), ("vit", "SGD", 0.05),
], ids=["simple_cnn-sgd", "simple_cnn-adamw", "vit-sgd"])
def test_train_step_matches_jax(arch, optimizer, lr, tmp_path):
    cfg = _cfg(arch, optimizer, lr)
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
    for m in twf.model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    p0, _ = export_flax_variables(twf.model)
    rng = np.random.default_rng(2)
    shape = (4,) + tuple(cfg["DATA"]["PATCH_SIZE"])
    batch = {"x": rng.standard_normal(shape).astype(np.float32),
             "y": np.array([[0], [2], [1], [2]], np.float32)}
    jstep = jax_make_train_step(jwf.loss, jwf.train_metrics, donate=False)
    with nn.intercept_methods(_no_dropout):
        jstate, jm = jstep(jwf.state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    grads = loss_and_grads(copy.deepcopy(twf.model), twf.loss, torch.from_numpy(batch["x"]),
                           torch.from_numpy(batch["y"]))[2]
    tstate, tm = make_train_step(twf.loss, twf.train_metrics)(twf.state, batch)
    # float32 noise: the 5x5x5 convs sum 4000 products, and batch-statistics
    # BatchNorm scales their rounding up; against a float64 step the port's
    # float32 loss lies 4.6e-6 away, the JAX package's 1.1e-6
    # (tools/torch_classification_step_witness.py --case unit)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-5, (float(tm["loss"]),
                                                                 float(jm["loss"]))
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    params, stats = export_flax_variables(tstate.model)
    assert _moved(p0, params) > 1e-3
    jparams = jax.tree.map(np.asarray, jstate.params)
    if optimizer == "ADAMW":
        # Adam's first update is lr * g / (|g| + eps): where either package's
        # |g| < 1e-5, float32 noise in g decides it (the biases of the convs
        # that feed a batch-statistics BatchNorm have an exact gradient of 0:
        # the normalisation takes their shift back). There each side moved by
        # at most lr (plus the decay); every other element must agree.
        def jax_loss(p):
            variables = {"params": p, "batch_stats": jwf.state.batch_stats}
            out = jwf.state.apply_fn(variables, jnp.asarray(batch["x"]), train=True,
                                     mutable=["batch_stats"])[0]
            return jwf.loss(out, jnp.asarray(batch["y"]))

        with nn.intercept_methods(_no_dropout):
            jgrads = jax.jit(jax.grad(jax_loss))(jwf.state.params)
        for k, g in grads.items():
            path = k.split(".")
            jg = jgrads
            for part in path:
                jg = jg[part]
            noisy = (g.abs().numpy() < 1e-5) | (np.abs(np.asarray(jg)) < 1e-5)
            for side in (params, jparams):
                node, start = side, p0
                for part in path[:-1]:
                    node, start = node[part], start[part]
                leaf, w0 = np.array(node[path[-1]]), start[path[-1]]
                assert np.all(np.abs(leaf - w0)[noisy] <= lr * (1.001 + np.abs(w0[noisy]))), k
                leaf[noisy] = w0[noisy]
                node[path[-1]] = leaf
    _tree_close(params, jparams, 1e-5, "params")
    _tree_close(stats, jstate.batch_stats, 1e-5, "batch_stats")


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------
def test_classification_metrics_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((16, 7)).astype(np.float32)
    # ties: rows with equal logits across several classes, labels on them
    logits[0] = 1.0
    logits[1, :4] = 2.0
    logits[2, 2:] = 3.0
    labels = rng.integers(0, 7, (16, 1)).astype(np.float32)
    labels[0], labels[1], labels[2] = 5, 2, 6
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    lj, yj = jnp.asarray(logits), jnp.asarray(labels)
    assert float(M.accuracy_metric(lt, yt)) == float(JM.accuracy_metric(lj, yj))
    for k in (1, 3, 5, 9):
        got = float(M.top_k_accuracy(lt, yt.to(torch.int64), k))
        assert got == float(JM.top_k_accuracy(lj, yj.astype(jnp.int32), k)), k
    # the tied rows alone: the top 3 are classes 0-2, 0-2 and 2-4, so only
    # the second row's label is among them
    assert float(M.top_k_accuracy(lt[:3], yt[:3].to(torch.int64), 3)) == float(np.float32(1 / 3))
    _close(float(M.softmax_ce_with_logits(lt, yt)), float(JM.softmax_ce_with_logits(lj, yj)),
           1e-6)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(12, 20, 24, 1), (5, 9, 13, 2), (12, 9, 16, 1), (8, 16, 16, 1)],
                         ids=["crop", "pad", "mixed", "same"])
def test_fit_to_patch_matches_jax(shape):
    img = np.random.default_rng(4).random(shape).astype(np.float32)
    got = TC._fit_to_patch(img, PATCH[:3])
    np.testing.assert_array_equal(got, JC._fit_to_patch(img, PATCH[:3]))
    assert got.shape == PATCH[:3] + shape[3:]


def _class_folders(root, n_per_class=5, shape=(10, 20, 22), classes=("a", "b", "c")):
    rng = np.random.default_rng(5)
    for ci, c in enumerate(classes):
        os.makedirs(f"{root}/{c}", exist_ok=True)
        for i in range(n_per_class):
            vol = rng.normal(60 + 60 * ci, 20, shape).clip(0, 255).astype(np.uint8)
            write_tiff(f"{root}/{c}/v{i}.tif", vol)


def test_load_classification_dataset_matches_jax(tmp_path):
    _class_folders(str(tmp_path), n_per_class=2)
    from biapy_tpu.config.config import get_cfg_defaults as jax_defaults
    from biapy_tpu_torch.config.config import get_cfg_defaults

    sides = {}
    for side, defaults, mod in (("jax", jax_defaults, JC), ("torch", get_cfg_defaults, TC)):
        c = defaults()
        c.DATA.PREPROCESS.RESIZE.ENABLE = True
        c.DATA.PREPROCESS.RESIZE.OUTPUT_SHAPE = (8, 14, 12)
        sides[side] = mod.load_classification_dataset(
            str(tmp_path), True, expected_classes=3, preprocess_cfg=c.DATA.PREPROCESS,
            patch_size=PATCH[:3])
    j, t = sides["jax"], sides["torch"]
    assert [(f.path, f.class_num, f.class_name, f.shape) for f in t.dataset_info] == \
        [(f.path, f.class_num, f.class_name, f.shape) for f in j.dataset_info]
    assert len(t.sample_list) == 6
    for a, b in zip(t.sample_list, j.sample_list):
        assert a.img.shape == PATCH
        np.testing.assert_array_equal(a.img, b.img)
    with pytest.raises(ValueError, match="N_CLASSES=2"):
        TC.load_classification_dataset(str(tmp_path), True, expected_classes=2)


@pytest.mark.parametrize("val", [
    {"CROSS_VAL": True, "CROSS_VAL_NFOLD": 4, "CROSS_VAL_FOLD": 1},
    {"CROSS_VAL": True, "CROSS_VAL_NFOLD": 4, "CROSS_VAL_FOLD": 3},
    {"SPLIT_TRAIN": 0.3},
], ids=["fold-1", "fold-3", "split-train"])
def test_train_val_split_matches_jax(val, tmp_path):
    """The same train and validation files as the JAX workflow's
    ``_build_loaders``; its k-fold is not stratified (ROADMAP section 3)."""
    root = str(tmp_path / "train")
    _class_folders(root)
    cfg = {"PROBLEM": {"TYPE": "CLASSIFICATION", "NDIM": "3D"},
           "DATA": {"PATCH_SIZE": list(PATCH), "N_CLASSES": 3,
                    "TRAIN": {"PATH": root, "IN_MEMORY": True}, "VAL": dict(val)},
           "MODEL": {"ARCHITECTURE": "simple_cnn"},
           "TRAIN": {"ENABLE": True}, "TEST": {"ENABLE": False}}
    files = {}
    for side, api, kw in (("jax", biapy_tpu, {}), ("torch", biapy_tpu_torch, {"device": "cpu"})):
        job = api.BiaPy(copy.deepcopy(cfg), result_dir=str(tmp_path), name=side, silent=True,
                        **kw)
        job._build_workflow()
        tr, va = job.workflow._build_loaders()
        files[side] = [[(d.ds.dataset_info[s.fid].path, d.ds.dataset_info[s.fid].class_num)
                        for s in d.ds.sample_list] for d in (tr, va)]
    assert files["torch"] == files["jax"]
    assert len(files["torch"][1]) == 4  # of 15: a fold of ceil(15 / 4), round(0.3 * 15)


# --------------------------------------------------------------------------
# chip_smoke.py's phase-3 rows for phase 15
# --------------------------------------------------------------------------
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", ["simple_cnn", "seunet", "resunet_se", "attention_unet"])
def test_chip_smoke_rows_are_the_models_shapes(arch, tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 3 holds the kernels at the classification
    template's shapes (``_cls_rows``) and the U-Net variants' on the semantic
    template (``_variant_convs``): the shapes the models give them, read by
    hooks on a forward (the classifier at batch 1 on its template's patch,
    the variants on a small input whose levels are the template's)."""
    import sys

    import yaml

    sys.path.insert(0, REPO)
    import chip_smoke
    from biapy_tpu_torch.models.blocks import Conv
    from biapy_tpu_torch.ops.kernels import shuffle

    tpl = ("classification/3d_classification.yaml" if arch == "simple_cnn"
           else "semantic_segmentation/3d_semantic_segmentation.yaml")
    with open(os.path.join(REPO, "templates", tpl)) as f:
        raw = yaml.safe_load(f)
    raw["MODEL"]["ARCHITECTURE"] = arch
    job = biapy_tpu_torch.BiaPy(raw, result_dir=str(tmp_path), name="t", silent=True,
                                check_data_paths=False, device="cpu")
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    seen = {"conv": [], "pool": [], "zcat": []}
    pool_plain, zcat_plain = shuffle.pool_max_folded_plain, shuffle.zcat_plain
    monkeypatch.setattr(shuffle, "pool_max_folded_plain", lambda x, win: (
        seen["pool"].append((tuple(x.shape), tuple(win))), pool_plain(x, win))[1])
    monkeypatch.setattr(shuffle, "zcat_plain", lambda x, kz, depth=None: (
        seen["zcat"].append((tuple(x.shape), kz, depth)), zcat_plain(x, kz, depth))[1])
    for m in wf.model.modules():
        if isinstance(m, Conv) and tuple(m.kernel.shape[:3]) == (3, 3, 3):
            m.register_forward_hook(lambda m, args, out: seen["conv"].append(
                (tuple(args[0].shape[:4]), m.kernel.shape[3], m.kernel.shape[4])))
    shape = tuple(wf.cfg.DATA.PATCH_SIZE[:3]) if arch == "simple_cnn" else (8, 32, 32)
    with torch.no_grad():
        wf.model(torch.zeros((1,) + shape + (1,)))
    if arch == "simple_cnn":
        convs, dx, pools, zcat5, zcat3 = chip_smoke._cls_rows(b=1)
        assert seen["conv"] == convs
        assert dx == [(vol, cout, cin) for vol, cin, cout in convs[1:]]
        assert seen["pool"] == pools
        assert seen["zcat"] == zcat5
        assert zcat3 == [((d, h, w, cin), 3, d) for (_, d, h, w), cin, _ in convs]
    else:
        levels = [(int(np.log2(32 // vol[2])), cin, cout) for vol, cin, cout in seen["conv"]]
        assert levels == chip_smoke._variant_convs(arch)
        assert [win for _, win in seen["pool"]] == [(1, 2, 2)] * 3
        assert [c for (_, _, _, c), _ in seen["pool"]] == list(chip_smoke.TEMPLATE_FM[:3])
