"""Checkpoints shared by the port and the JAX package.

- the port's msgpack codec (``utils/flax_msgpack.py``, no ``msgpack``
  package) writes the bytes ``flax.serialization.msgpack_serialize`` writes
  and reads them back, Flax's chunked arrays included;
- a checkpoint the JAX package saved loads into the port, whose predictions
  then match the JAX package's within 1e-4 (float32);
- a checkpoint the port saved is read by the JAX package bit for bit, and its
  embedded config by PyYAML;
- the port's optimizer state in the checkpoint has the keys, shapes and
  values of ``flax.serialization.to_state_dict`` of the optax state the JAX
  package builds for the same config, and loads back;
- ``get_checkpoint_path`` picks the file the JAX package picks.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import yaml
from flax import serialization

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.config.config import get_cfg_defaults as jax_cfg_defaults
from biapy_tpu.engine import schedulers as JS
from biapy_tpu.utils.misc import get_checkpoint_path as jax_get_checkpoint_path
from biapy_tpu.utils.misc import load_checkpoint as jax_load_checkpoint
from biapy_tpu.utils.misc import save_model as jax_save_model
from biapy_tpu_torch.config.config import get_cfg_defaults
from biapy_tpu_torch.engine import schedulers as S
from biapy_tpu_torch.models.flax_import import export_flax_variables, flatten
from biapy_tpu_torch.utils import flax_msgpack as FM
from biapy_tpu_torch.utils.misc import get_checkpoint_path, load_checkpoint

torch.set_num_threads(2)


def _tree(rng):
    """Every kind of leaf a checkpoint holds, keys out of order."""
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "params": {"b": {"kernel": rng.standard_normal((3, 3, 3, 2, 4)).astype(np.float32),
                         "bias": np.zeros(4, np.float32)},
                   "a": {"scale": rng.standard_normal(7).astype(np.float32)}},
        "cfg": "PROBLEM:\n  TYPE: SEMANTIC_SEG\n" + "x" * 300, "name": "é", "empty": "",
        "epoch": 3, "ints": [0, 1, -1, -33, 200, 70000, -40000, 2 ** 40, -(2 ** 40)],
        "lr": 1.5e-4, "flag": True, "off": False, "none": None, "nested_empty": {},
        "count": np.asarray(7, np.int32), "scalar": np.float32(0.25),
        "int_array": np.arange(-6, 6, dtype=np.int64).reshape(3, 4),
        "bf16": jnp.asarray(bf, jnp.bfloat16),
        "many": {str(i): i for i in range(40)}, "blob": b"\x00\x01" * 200,
    }


def _port_tree(tree):
    """The same tree with the bf16 leaf as the port holds it."""
    out = dict(tree)
    out["bf16"] = torch.from_numpy(np.asarray(tree["bf16"]).view(np.int16).copy()).view(
        torch.bfloat16)
    return out


def _assert_same(got, ref, path="tree"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            _assert_same(got[k], ref[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32), path)
    elif isinstance(ref, np.ndarray) or isinstance(ref, np.generic):
        assert type(got) is type(ref) and got.dtype == ref.dtype, path
        np.testing.assert_array_equal(got, ref, path)
    else:
        assert type(got) is type(ref) and got == ref, path


@pytest.mark.parametrize("chunk", [None, 64], ids=["plain", "chunked"])
def test_codec_writes_flax_bytes_and_reads_them_back(chunk, monkeypatch):
    """Byte for byte what Flax writes (``chunked``: both sides' chunk size
    lowered to 64 bytes, so the larger arrays travel as Flax's chunked-array
    maps), and both readers give the same tree back."""
    if chunk:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(FM, "MAX_CHUNK_SIZE", chunk)
    tree = _tree(np.random.default_rng(0))
    ref = serialization.msgpack_serialize(copy.deepcopy(tree))
    got = FM.msgpack_serialize(_port_tree(tree))
    assert got == ref
    assert (b"__msgpack_chunked_array__" in got) == bool(chunk)
    flax_back = serialization.msgpack_restore(got)
    port_back = FM.msgpack_restore(got)
    _assert_same(port_back, flax_back)
    assert FM.msgpack_serialize(port_back) == ref


def _semantic_cfg(**train):
    return {
        "PROBLEM": {"TYPE": "SEMANTIC_SEG", "NDIM": "3D"},
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8], "DROPOUT_VALUES": [0.0, 0.0],
                  "Z_DOWN": [2], "YX_DOWN": [2], "CONV_LAYERS": [2, 2], "NORMALIZATION": "bn",
                  "ACTIVATION": "elu"},
        "DATA": {"PATCH_SIZE": [16, 16, 16, 1],
                 "TEST": {"PADDING": [2, 2, 2], "OVERLAP": [0.0, 0.0, 0.0]}},
        "TRAIN": dict({"ENABLE": True, "BATCH_SIZE": 2}, **train),
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": False, "OUTPUT_QUANT_UINT8": False},
    }


def test_jax_checkpoint_loads_into_the_port_and_predicts_the_same(tmp_path):
    job = biapy_tpu.BiaPy(_semantic_cfg(), result_dir=str(tmp_path), name="j", silent=True,
                          check_data_paths=False)
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    rng = np.random.default_rng(1)
    # non-trivial BatchNorm statistics, so that a lost batch_stats shows
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
        np.float32), wf.state.batch_stats)
    ckpt = jax_save_model(wf.cfg, str(tmp_path / "ck"), "j", jax.tree.map(np.asarray,
                          wf.state.params), 4, stats)
    vol = rng.integers(0, 256, (20, 23, 18), dtype=np.uint8)
    ref = biapy_tpu.BiaPy(ckpt, result_dir=str(tmp_path), name="jr", silent=True,
                          check_data_paths=False).predict(vol)[0]["pred"]
    port = biapy_tpu_torch.BiaPy(ckpt, result_dir=str(tmp_path), name="tr", silent=True,
                                 check_data_paths=False, device="cpu")
    got = port.predict(vol)[0]["pred"]
    assert got.shape == ref.shape == (20, 23, 18, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    params, batch_stats = export_flax_variables(port.workflow.model)
    for k, v in flatten(stats).items():
        np.testing.assert_array_equal(flatten(batch_stats)[k], v, k)
    assert set(flatten(params)) == set(flatten(jax.tree.map(np.asarray, wf.state.params)))


def test_port_checkpoint_is_read_by_jax_bit_for_bit(tmp_path):
    job = biapy_tpu_torch.BiaPy(_semantic_cfg(), result_dir=str(tmp_path), name="t", silent=True,
                                check_data_paths=False, device="cpu")
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    path = wf.save_checkpoint(5, with_optimizer=True)
    assert os.path.basename(path) == "t-checkpoint-5.ckpt"
    ck = jax_load_checkpoint(path)
    params, batch_stats = export_flax_variables(wf.model)
    for got, ref in ((ck["params"], params), (ck["batch_stats"], batch_stats)):
        got, ref = flatten(got), flatten(ref)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], ref[k], k)
    assert ck["epoch"] == 5 and isinstance(ck["biapy_tpu_version"], str)
    # the embedded config is YAML the JAX package reads; the port reads the
    # file back to the same tree
    assert yaml.safe_load(ck["cfg"]) == yaml.safe_load(yaml.safe_dump(wf.cfg.to_dict()))
    _assert_same(load_checkpoint(path), ck)


_OPT_CASES = {
    "sgd": {"OPTIMIZER": ["SGD"]},
    "adamw": {"OPTIMIZER": ["ADAMW"], "W_DECAY": 0.01},
    "adam-warmupcosine": {"OPTIMIZER": ["ADAM"], "LR_SCHEDULER": {
        "NAME": "warmupcosine", "WARMUP_COSINE_DECAY_EPOCHS": 1, "MIN_LR": [1e-5]}},
    "adamw-onecycle": {"OPTIMIZER": ["ADAMW"], "LR_SCHEDULER": {"NAME": "onecycle"}},
    "sgd-clip-warmplateau": {"OPTIMIZER": ["SGD"], "GRADIENT_CLIP_NORM": 0.5, "LR_SCHEDULER": {
        "NAME": "warmupreduceonplateau", "WARMUP_COSINE_DECAY_EPOCHS": 1}},
}


@pytest.mark.parametrize("freeze", [False, True], ids=["all", "frozen"])
@pytest.mark.parametrize("case", sorted(_OPT_CASES))
def test_optimizer_state_has_the_optax_layout_and_values(case, freeze):
    """Keys, shapes and dtypes of ``to_state_dict`` of the optax state for
    the same config, over a resunet's parameters, after two identical
    updates; values within 1e-6. Loading the JAX layout into a fresh port
    optimizer gives the port's state back."""
    over = {"TRAIN": dict({"LR": [0.01], "EPOCHS": 2}, **_OPT_CASES[case]),
            "MODEL": {"FREEZE_LAYERS_MATCHING": ["^Conv_0/"] if freeze else []}}
    jcfg, tcfg = jax_cfg_defaults(), get_cfg_defaults()
    jcfg.merge_from_dict(copy.deepcopy(over))
    tcfg.merge_from_dict(copy.deepcopy(over))
    rng = np.random.default_rng(0)
    shapes = {"Conv_0": {"kernel": (3, 3, 3, 1, 4), "bias": (4,)},
              "UpBlock_0": {"BatchNorm_0": {"scale": (4,), "bias": (4,)}}}
    p0 = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                      is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), p0)
             for _ in range(2)]

    tx, _ = JS.build_optimizer(jcfg, 3)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = tx.init(jparams)
    tparams = {k.replace("/", "."): torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in flatten(p0).items()}
    topt, _ = S.build_optimizer(tcfg, 3, tparams.items())
    for g in grads:
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.update({k.replace("/", "."): torch.from_numpy(v) for k, v in flatten(g).items()
                     if tparams[k.replace("/", ".")].requires_grad})
    ref = serialization.msgpack_restore(serialization.msgpack_serialize(
        serialization.to_state_dict(jstate)))
    got = S.optax_state_dict(topt)

    def leaves(t, prefix=""):
        out = {}
        for k, v in t.items():
            p = f"{prefix}/{k}"
            out.update(leaves(v, p) if isinstance(v, dict) and v else {p: v})
        return out

    gl, rl = leaves(got), leaves(ref)
    assert sorted(gl) == sorted(rl)
    for k, r in rl.items():
        if isinstance(r, dict):
            assert gl[k] == {}, k
            continue
        g = gl[k]
        assert g.shape == r.shape and g.dtype == r.dtype, (k, g.shape, r.shape, g.dtype, r.dtype)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6, err_msg=k)
    # the same bytes on disk, as far as the values agree
    assert len(FM.msgpack_serialize(got)) == len(serialization.msgpack_serialize(ref))

    fresh_params = {k: torch.nn.Parameter(v.detach().clone()) for k, v in tparams.items()}
    fresh, _ = S.build_optimizer(tcfg, 3, fresh_params.items())
    S.load_optax_state_dict(fresh, ref)
    for k, v in topt.state.items():
        np.testing.assert_allclose(fresh.state[k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_optimizer_state_of_another_layout_raises_and_changes_nothing():
    cfg = get_cfg_defaults()
    cfg.merge_from_dict({"TRAIN": {"OPTIMIZER": ["ADAMW"]}})
    p = torch.nn.Parameter(torch.ones(3))
    opt, _ = S.build_optimizer(cfg, 3, [("a.kernel", p)])
    sgd_cfg = get_cfg_defaults()
    sgd, _ = S.build_optimizer(sgd_cfg, 3, [("a.kernel", torch.nn.Parameter(torch.ones(3)))])
    before = {k: v.clone() for k, v in opt.state.items()}
    with pytest.raises(KeyError):
        S.load_optax_state_dict(opt, S.optax_state_dict(sgd))
    wrong = S.optax_state_dict(opt)
    wrong["inner_state"]["0"]["mu"]["a"]["kernel"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="shape"):
        S.load_optax_state_dict(opt, wrong)
    for k, v in opt.state.items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("which,files,explicit", [
    ("best_on_val", ["0", "1", "best"], False),
    ("best_on_val", ["0", "3", "12"], False),  # no best: the last epoch
    ("last_on_train", ["2", "10", "best"], False),
    (3, ["1", "3", "best"], False),
    (7, ["1", "3"], False),  # no such epoch
    ("best_on_val", [], False),
    ("best_on_val", ["0", "best"], True),  # PATHS.CHECKPOINT_FILE wins
])
def test_get_checkpoint_path_picks_the_file_jax_picks(which, files, explicit, tmp_path):
    for tag in files:
        (tmp_path / f"job-checkpoint-{tag}.ckpt").write_bytes(b"")
    (tmp_path / "other-checkpoint-9.ckpt").write_bytes(b"")
    over = {"MODEL": {"LOAD_CHECKPOINT_EPOCH": which},
            "PATHS": {"CHECKPOINT": str(tmp_path),
                      "CHECKPOINT_FILE": str(tmp_path / "x.ckpt") if explicit else ""}}
    jcfg, tcfg = jax_cfg_defaults(), get_cfg_defaults()
    jcfg.merge_from_dict(copy.deepcopy(over))
    tcfg.merge_from_dict(copy.deepcopy(over))
    got = get_checkpoint_path(tcfg, "job")
    assert got == jax_get_checkpoint_path(jcfg, "job")
    if explicit:
        assert got == str(tmp_path / "x.ckpt")
    elif not files or which == 7:
        assert got is None
    elif which == 3:
        assert got.endswith("job-checkpoint-3.ckpt")
    else:
        tag = "best" if "best" in files and which == "best_on_val" else max(
            (f for f in files if f.isdigit()), key=int)
        assert got.endswith(f"job-checkpoint-{tag}.ckpt"), got
