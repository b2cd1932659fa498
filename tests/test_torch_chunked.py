"""The by-chunks engine and the chunked-file readers, the port against the
JAX package.

Zarr/N5/HDF5 bytes in both directions, the tile grid and its ownership,
the stitch's ``pre_padded``, ``predict_volume``
with identity stub workflows (ROI, axes orders, uint8 storage, Z ranges,
ranks), a by-chunks ``run_job`` in both packages from one JAX-written
checkpoint on a Zarr volume whose last tile is ragged on every axis, Zarr
training samples, and the parts that raise. ``_write_zarr`` and
``_chunks_cfg`` build a tiny by-chunks job (patch 16^3, padding 2, 2x2x2
patches per tile).
"""

import contextlib
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.data import io as jio
from biapy_tpu.data import zarr_store as jzs
from biapy_tpu.data.tiff import read_tiff
from biapy_tpu.engine import base_workflow as jax_base_workflow
from biapy_tpu.engine import chunked as jch
from biapy_tpu.ops.stitch import sliding_window_inference as jax_swi
from biapy_tpu.parallel import get_mesh as jax_get_mesh
from biapy_tpu.utils.misc import save_model as jax_save_model
from biapy_tpu_torch.data import io as tio
from biapy_tpu_torch.data import zarr_store as tzs
from biapy_tpu_torch.engine import chunked as tch
from biapy_tpu_torch.models.flax_import import export_flax_variables
from biapy_tpu_torch.ops.stitch import sliding_window_inference as torch_swi

torch.set_num_threads(2)

NAME = "chunks"
# 30 = 24 + 6 and 52 = 2 * 24 + 4 leave last tiles thinner than one patch
# core (12): the stitch's deficit path on a pre-padded axis; 40 = 24 + 16
# leaves one wider than a core (a shifted last patch)
VOL_SHAPE = (30, 40, 52)
# the by-chunks job's volume: 20 < 24 is one short tile in z (a shifted last
# patch), y and x as above; one z extent keeps the JAX job to one program
JOB_SHAPE = (20, 40, 52)


def _write_zarr(path, data, chunks, pkg=tzs):
    z = pkg.ZarrArray.create(path, shape=data.shape, chunks=chunks, dtype=data.dtype,
                             compressor={"id": "zlib", "level": 1})
    z[tuple(slice(None) for _ in data.shape)] = data
    return z


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# ------------------------------------------------------------------ formats
@pytest.mark.parametrize("fmt", ["zarr", "n5", "h5"])
def test_chunked_files_are_mutually_readable_and_byte_identical(fmt, tmp_path):
    data = np.random.default_rng(0).integers(0, 256, (9, 14, 11, 2), dtype=np.uint8)
    paths = {}
    for side, io, zs in (("jax", jio, jzs), ("torch", tio, tzs)):
        p = str(tmp_path / side / f"vol.{fmt}")
        if fmt == "zarr":
            _write_zarr(p, data, (4, 8, 8, 2), zs)
        elif fmt == "n5":
            zs.N5Array.create(p, shape=data.shape, chunks=(4, 8, 8, 2), dtype="uint8",
                              compression="gzip")[:, :, :, :] = data
        else:
            io.imwrite(p, data, data_path="volumes.raw")
        paths[side] = p
    if fmt != "h5":  # h5py's files hold creation times; their bytes differ
        files = {side: _files(p) for side, p in paths.items()}
        assert files["torch"] == files["jax"] and len(files["torch"]) > 4
    for reader, writer in (("jax", "torch"), ("torch", "jax")):
        io = jio if reader == "jax" else tio
        dp = "volumes.raw" if fmt == "h5" else None
        np.testing.assert_array_equal(io.imread(paths[writer], data_path=dp), data)
        patch = io.read_patch_lazy(paths[writer], (2, 3, 1), (7, 14, 6), is_3d=True,
                                   data_path=dp)
        np.testing.assert_array_equal(patch, data[2:7, 3:14, 1:6])


# ------------------------------------------------------------ tile geometry
@pytest.mark.parametrize("shape,tile,halo", [
    ((48, 96, 96), (24, 48, 48), (4, 4, 4)),
    (VOL_SHAPE, (24, 24, 24), (2, 2, 2)),
    ((7, 50, 33), (5, 16, 32), (3, 0, 5)),
], ids=["even", "ragged", "ragged-uneven-halo"])
def test_tile_grid_and_ownership_match_jax(shape, tile, halo):
    jtiles = jch.tile_grid(shape, tile, halo)
    ttiles = tch.tile_grid(shape, tile, halo)
    assert ttiles == [tch.Tile(*vars(t).values()) for t in jtiles]
    owned = []
    for world in (1, 2, 3):
        for rank in range(world):
            ci, jci = (pkg.ChunkedInference(None, (tile[0] + 2 * halo[0],) * 3, (0,) * 3, halo,
                                            (1, 1, 1), 1, "", rank=rank, world=world)
                       for pkg in (tch, jch))
            mine = ci.my_tiles(ttiles)
            assert mine == [tch.Tile(*vars(t).values()) for t in jci.my_tiles(jtiles)]
            assert [ci.owns(i) for i in range(len(ttiles))] == [
                jci.owns(i) for i in range(len(jtiles))]
            owned += [(world, t.index) for t in mine]
    # each world size shares out every tile exactly once
    assert sorted(owned) == sorted((w, t.index) for w in (1, 2, 3) for t in ttiles)


# ------------------------------------------------------------------ stitch
def _apply_torch(x):
    # depends on where the patch lies (its mean), so a grid that differs
    # gives other values
    return torch.sigmoid(x * 1.3 + x.mean(dim=(1, 2, 3), keepdim=True) - 0.4).repeat(1, 1, 1, 1, 2)


def _apply_jax(_, x):
    return jnp.tile(jax.nn.sigmoid(x * 1.3 + x.mean(axis=(1, 2, 3), keepdims=True) - 0.4),
                    (1, 1, 1, 1, 2))


@pytest.mark.parametrize("case", [
    dict(pre_padded=True),
    dict(pre_padded=(True, False, True), overlap=(0.5, 0.0, 0.25)),
    dict(pre_padded=True, overlap=(0.25, 0.5, 0.0), pad_mode="median"),
    dict(pre_padded=(False, False, True), batch_size=4),
    dict(pre_padded=True, quant_uint8=True, batch_size=3),
], ids=["pre_padded", "per-axis+overlap", "median-deficit", "batch-duplicates", "uint8"])
def test_stitch_slab_arguments_match_jax(case):
    case = dict(case)
    overlap = case.pop("overlap", (0.0, 0.0, 0.0))
    vol = np.random.default_rng(2).random((18, 28, 9, 1)).astype(np.float32)
    kw = dict(patch=(12, 12, 12), overlap=overlap, padding=(2, 2, 2), out_channels=2, **case)
    got = torch_swi(_apply_torch, torch.from_numpy(vol), **kw)
    want = np.asarray(jax_swi(_apply_jax, {}, jnp.asarray(vol), **kw))
    assert tuple(got.shape) == want.shape
    if case.get("quant_uint8"):
        assert got.dtype == torch.uint8
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_stitch_rejects_a_pre_padded_volume_smaller_than_its_halo():
    with pytest.raises(ValueError, match="smaller than twice the padding"):
        torch_swi(_apply_torch, torch.zeros(4, 20, 20, 1), (12, 12, 12), (0.0,) * 3, (2, 2, 2),
                  out_channels=2, pre_padded=True)


# ---------------------------------------------------- predict_volume stubs
class _Stub:
    """Identity prediction under ``predict_block_on_device``'s by-chunks
    contract: blocks arrive padded by ``padding`` per side (pre_padded) and
    the core comes back, rounded to uint8 under the quantized store."""

    norm_spec = {"type": "none", "percentile_clip": False, "out_dtype": "float32"}

    def __init__(self, torch_side, quant=False):
        self.calls = self.passes = 0
        self.torch_side = torch_side
        self.quant = quant
        if quant:
            from biapy_tpu_torch.config.config import Config

            self.cfg = Config("", "x").get_cfg_defaults()
            self.cfg.merge_from_dict({"TEST": {"OUTPUT_QUANT_UINT8": True}})

    @contextlib.contextmanager
    def inference_pass(self):
        self.passes += 1
        yield

    def predict_block_on_device(self, block, overlap=None, padding=None, device=None,
                                sync=False, norm_stats=None, out_splits=None, pre_padded=False):
        self.calls += 1
        nd = block.ndim - 1
        core = block[tuple(slice(padding[d], block.shape[d] - padding[d]) for d in range(nd))]
        if self.torch_side:
            return (torch.round(core.clamp(0, 1) * 255).to(torch.uint8) if self.quant
                    else core.clone())
        core = np.asarray(core)
        if self.quant:
            core = np.round(np.clip(core, 0, 1) * 255).astype(np.uint8)
        return tuple(core[z0:z1] for z0, z1 in out_splits)


def _run_volume(pkg, torch_side, vol_path, out_dir, quant=False, ranks=((0, 1),), **kw):
    stub = _Stub(torch_side, quant)
    out_path = None
    for rank, world in ranks:
        ci = pkg.ChunkedInference(stub, (16, 16, 16), (0.0,) * 3, (2, 2, 2), (2, 2, 2), 2,
                                  out_dir, rank=rank, world=world)
        out_path = ci.predict_volume(vol_path, verbose=False, **kw)
    # the port's engine opens one inference pass per volume
    assert stub.passes == (len(ranks) if torch_side else 0)
    return np.asarray(jzs.ZarrArray(out_path)), stub.calls


@pytest.mark.parametrize("case", ["roi", "czyx", "channels-last-default", "uint8", "z-ranges",
                                  "two-ranks"])
def test_predict_volume_matches_jax(case, tmp_path):
    rng = np.random.default_rng(3)
    vol = rng.random(VOL_SHAPE + (2,)).astype(np.float32)
    disk, kw, ranks, quant = vol, {}, ((0, 1),), False
    if case == "czyx":
        disk = np.moveaxis(vol, -1, 0)
        kw = dict(axes_order="CZYX")
    elif case == "channels-last-default":
        kw = dict(axes_order="TZCYX", axes_order_is_default=True)
    elif case == "uint8":
        quant = True
    elif case == "roi":
        roi = np.zeros(VOL_SHAPE, np.uint8)
        roi[:, :20, :] = 1  # half of the first tile row in y, none of the second
        kw = dict(roi=roi)
    vol_path = str(tmp_path / "vol.zarr")
    _write_zarr(vol_path, disk, (12, 16, 16, 2)[:disk.ndim] if case != "czyx"
                else (2, 12, 16, 16))
    outs = {}
    for side, pkg in (("jax", jch), ("torch", tch)):
        d = str(tmp_path / side)
        if case == "z-ranges":  # two sub-jobs, split at a tile's core start
            _run_volume(pkg, side == "torch", vol_path, d, z_range=(-1, 24))
            outs[side] = _run_volume(pkg, side == "torch", vol_path, d, z_range=(24, -1))
        elif case == "two-ranks":
            outs[side] = _run_volume(pkg, side == "torch", vol_path, d, ranks=((0, 2), (1, 2)))
        else:
            outs[side] = _run_volume(pkg, side == "torch", vol_path, d, quant=quant, **kw)
    (got, calls), (want, jcalls) = outs["torch"], outs["jax"]
    assert got.dtype == want.dtype and got.shape == want.shape == VOL_SHAPE + (2,)
    np.testing.assert_array_equal(got, want)
    if case == "roi":
        assert calls == jcalls == 6  # 2x3 of the 12 tiles have no ROI voxel
        np.testing.assert_array_equal(got[:, :20], vol[:, :20])
        assert not got[:, 20:].any()
    elif case == "uint8":
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.round(vol * 255).astype(np.uint8))
    else:
        np.testing.assert_array_equal(got, vol)


# ------------------------------------------------------ the slice as a whole
def _chunks_cfg(root, ckpt, quant):
    return {
        "PROBLEM": {"TYPE": "SEMANTIC_SEG", "NDIM": "3D"},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {"PATCH_SIZE": [16, 16, 16, 1],
                 "NORMALIZATION": {"TYPE": "div"},
                 "TEST": {"PATH": f"{root}/test", "LOAD_GT": False, "PADDING": [2, 2, 2],
                          "OVERLAP": [0.0, 0.0, 0.0]}},
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8], "DROPOUT_VALUES": [0.0, 0.0],
                  "Z_DOWN": [2], "YX_DOWN": [2], "CONV_LAYERS": [2, 2], "NORMALIZATION": "bn",
                  "ACTIVATION": "elu", "LOAD_CHECKPOINT": ckpt is not None},
        "PATHS": {"CHECKPOINT_FILE": ckpt or ""},
        "TRAIN": {"ENABLE": ckpt is None, "BATCH_SIZE": 2},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": False, "OUTPUT_QUANT_UINT8": quant,
                 "BY_CHUNKS": {"ENABLE": True, "SAVE_OUT_TIF": True,
                               "WORKFLOW_PROCESS": {"PATCHES_PER_TILE": [2, 2, 2]}}},
    }


@pytest.fixture(scope="module")
def chunk_jobs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chunks"))
    rng = np.random.default_rng(4)
    os.makedirs(f"{root}/test")
    _write_zarr(f"{root}/test/vol.zarr",
                rng.integers(0, 256, JOB_SHAPE + (1,), dtype=np.uint8), (24, 24, 24, 1))
    # the shared starting point: a seeded model with non-trivial BatchNorm
    # statistics, written by the JAX package
    init = biapy_tpu_torch.BiaPy(_chunks_cfg(root, None, False), result_dir=f"{root}/init",
                                 name=NAME, silent=True, check_data_paths=False, device="cpu")
    init._build_workflow()
    init.workflow.prepare_model()
    params, stats = export_flax_variables(init.workflow.model)
    stats = jax.tree.map(lambda a: a + rng.random(a.shape).astype(np.float32) * 0.3, stats)
    ckpt = jax_save_model(init.workflow.cfg, f"{root}/init", "init", params, 0, stats)
    jobs = {}
    # the port runs on one card: the JAX job on one device. One JAX job
    # writes both stores: the uint8 one by a second test pass of the same
    # workflow with TEST.OUTPUT_QUANT_UINT8 set (its model is built once)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base_workflow, "get_mesh", lambda spatial=1: jax_get_mesh(jax.devices()[:1]))
        mp.setattr(jax, "local_devices", lambda *a, **k: jax.devices()[:1])
        jjob = biapy_tpu.BiaPy(_chunks_cfg(root, ckpt, False), result_dir=f"{root}/jax", name=NAME,
                               silent=True)
        jjob.run_job()
        jcfg = jjob.workflow.cfg
        per_image = {"f32": jcfg.PATHS.RESULT_DIR.PER_IMAGE,
                     "uint8": jcfg.PATHS.RESULT_DIR.PER_IMAGE + "_uint8"}
        jcfg.defrost()
        jcfg.TEST.OUTPUT_QUANT_UINT8 = True
        jcfg.PATHS.RESULT_DIR.PER_IMAGE = per_image["uint8"]
        jcfg.freeze()
        jjob.workflow.test()
    for quant, tag in ((False, "f32"), (True, "uint8")):
        tjob = biapy_tpu_torch.BiaPy(_chunks_cfg(root, ckpt, quant), result_dir=f"{root}/torch_{tag}",
                                     name=NAME, silent=True, device="cpu")
        tjob.run_job()
        jobs[tag] = dict(jax=per_image[tag], torch=tjob)
    return dict(root=root, ckpt=ckpt, jobs=jobs)


@pytest.mark.parametrize("store", ["f32", "uint8"])
def test_by_chunks_job_matches_jax(chunk_jobs, store):
    """``raw_pred.zarr`` within 1e-4 (f32 store) or 1 uint8 LSB, with the same
    shape, chunks and dtype; the SAVE_OUT_TIF volume the same way."""
    raw, tif = {}, {}
    for side, job in chunk_jobs["jobs"][store].items():
        per_image = job if side == "jax" else job.workflow.cfg.PATHS.RESULT_DIR.PER_IMAGE
        raw[side] = jzs.ZarrArray(f"{per_image}/vol_chunks/raw_pred.zarr")
        tif[side] = read_tiff(f"{per_image}/vol.tif")
    t, j = raw["torch"], raw["jax"]
    assert (t.shape, t.chunks, t.dtype) == (j.shape, j.chunks, j.dtype)
    assert t.shape == JOB_SHAPE + (1,) and t.chunks == (24, 24, 24, 1)
    assert t.dtype == (np.uint8 if store == "uint8" else np.float32)
    tol = 1 if store == "uint8" else 1e-4
    got, want = np.asarray(t).astype(np.float64), np.asarray(j).astype(np.float64)
    assert np.abs(got - want).max() <= tol
    assert 0.0 < got.std()  # a real prediction, not a constant
    assert tif["torch"].shape == tif["jax"].shape == JOB_SHAPE
    assert np.abs(tif["torch"] - tif["jax"]).max() <= (1 / 255 if store == "uint8" else 1e-4)
    stats = chunk_jobs["jobs"][store]["torch"].workflow.last_chunked.last_drain_stats
    assert stats["tiles"] == 6 and stats["skipped"] == 0
    assert stats["bytes"] == int(np.prod(JOB_SHAPE)) * (1 if store == "uint8" else 4)


def test_by_chunks_equals_the_whole_volume_predict(chunk_jobs, tmp_path):
    """With real halos, overlap 0 and a volume of whole patch cores the tile
    grid is the whole-volume grid: by-chunks equals ``predict`` on the
    volume in memory (up to float sums in another order)."""
    job = chunk_jobs["jobs"]["f32"]["torch"]
    vol = np.random.default_rng(7).integers(0, 256, (24, 36, 48, 1), dtype=np.uint8)
    _write_zarr(str(tmp_path / "vol.zarr"), vol, (24, 24, 24, 1))
    ci = tch.ChunkedInference(job.workflow, (16, 16, 16), (0.0,) * 3, (2, 2, 2), (2, 2, 2), 1,
                              str(tmp_path))
    raw = np.asarray(jzs.ZarrArray(ci.predict_volume(str(tmp_path / "vol.zarr"), verbose=False)))
    whole = job.predict(vol)[0]["pred"]
    np.testing.assert_allclose(raw, whole, rtol=0, atol=1e-5)


def test_inference_model_is_built_once_per_pass(chunk_jobs, monkeypatch):
    """The bf16 inference copy (TEST.REDUCE_MEMORY) is made once per pass,
    a nested pass reuses it, it is dropped when the pass ends, and
    ``predict_block_on_device`` outside a pass raises."""
    from biapy_tpu_torch.engine import base_workflow as tbw

    wf = chunk_jobs["jobs"]["f32"]["torch"].workflow
    block = np.random.default_rng(6).random((16, 16, 16, 1)).astype(np.float32)
    with pytest.raises(RuntimeError, match="inside an inference pass"):
        wf.predict_block_on_device(block)
    copies, deepcopy = [], copy.deepcopy
    monkeypatch.setattr(tbw.copy, "deepcopy", lambda x, memo=None: (
        copies.append(x) if x is wf.model else None) or deepcopy(x, memo))
    wf.cfg.defrost()
    wf.cfg.TEST.REDUCE_MEMORY = True
    try:
        with wf.inference_pass():
            model = wf._pass_model
            with wf.inference_pass():
                assert wf._pass_model is model
                a = wf.predict_block_on_device(block)
            b = wf.predict_block_on_device(block)
        assert copies == [wf.model] and model is not wf.model
        assert next(model.parameters()).dtype == torch.bfloat16
        assert wf._pass_model is None
    finally:
        wf.cfg.TEST.REDUCE_MEMORY = False
        wf.cfg.freeze()
    np.testing.assert_array_equal(a, b)
    assert a.shape == (16, 16, 16, 1) and np.isfinite(a).all()


def test_per_image_test_reads_a_zarr_with_its_inner_path_and_axes(chunk_jobs, tmp_path):
    """DATA.TEST.INPUT_ZARR_MULTIPLE_DATA and INPUT_IMG_AXES_ORDER reach the
    per-image reader: a CZYX volume at ``volumes.raw`` predicts as the same
    volume in memory."""
    vol = np.asarray(jzs.ZarrArray(f"{chunk_jobs['root']}/test/vol.zarr"))[:20, :20, :20]
    os.makedirs(tmp_path / "test")
    tio.imwrite(str(tmp_path / "test/vol.zarr"), np.moveaxis(vol, -1, 0), data_path="volumes.raw")
    cfg = _chunks_cfg(str(tmp_path), chunk_jobs["ckpt"], False)
    cfg["TEST"]["BY_CHUNKS"]["ENABLE"] = False
    cfg["DATA"]["TEST"].update(INPUT_ZARR_MULTIPLE_DATA=True, IN_MEMORY=False,
                               INPUT_ZARR_MULTIPLE_DATA_RAW_PATH="volumes.raw",
                               INPUT_IMG_AXES_ORDER="CZYX")
    job = biapy_tpu_torch.BiaPy(cfg, result_dir=str(tmp_path), name=NAME, silent=True,
                                device="cpu")
    job.test()
    written = read_tiff(f"{job.workflow.cfg.PATHS.RESULT_DIR.PER_IMAGE}/vol.tif")
    want = job.predict(vol)[0]["pred"][..., 0]
    np.testing.assert_array_equal(written, want)


def test_zarr_training_samples_and_first_batch_match_jax(tmp_path):
    """INPUT_ZARR_MULTIPLE_DATA with IN_MEMORY False: the same lazy sample
    list and the same first batch as the JAX package."""
    from biapy_tpu.data import generators as JG
    from biapy_tpu.data.data_manipulation import load_and_prepare_train_data as jax_train_data
    from biapy_tpu.data.norm import build_norm_dict as jax_norm_dict
    from biapy_tpu_torch.data import generators as TG
    from biapy_tpu_torch.data.data_manipulation import load_and_prepare_train_data
    from biapy_tpu_torch.data.norm import build_norm_dict

    rng = np.random.default_rng(5)
    os.makedirs(tmp_path / "train")
    for i, shape in enumerate(((20, 36, 28), (18, 16, 40))):
        p = str(tmp_path / f"train/{i:03d}.zarr")
        tio.imwrite(p, rng.integers(0, 256, shape, dtype=np.uint8), data_path="volumes.raw")
        g = tzs.open_zarr(p, mode="a")
        g.create_dataset("volumes/labels", shape=shape, chunks=(8, 8, 8), dtype="u1",
                         compressor={"id": "zlib", "level": 1})[:, :, :] = (
            rng.random(shape) > 0.7).astype(np.uint8)
    cfg = _chunks_cfg(str(tmp_path), None, False)
    cfg["DATA"]["TRAIN"] = {"PATH": str(tmp_path / "train"), "GT_PATH": str(tmp_path / "train"),
                            "IN_MEMORY": False, "INPUT_ZARR_MULTIPLE_DATA": True,
                            "INPUT_ZARR_MULTIPLE_DATA_RAW_PATH": "volumes.raw",
                            "INPUT_ZARR_MULTIPLE_DATA_GT_PATH": "volumes.labels",
                            "INPUT_IMG_AXES_ORDER": "ZYX", "PADDING": [2, 2, 2]}
    cfg["DATA"]["VAL"] = {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.25}
    cfg["TEST"]["ENABLE"] = False
    got = []
    for pkg, data, gen, norm in (
            (biapy_tpu, jax_train_data, JG, jax_norm_dict),
            (biapy_tpu_torch, load_and_prepare_train_data, TG, build_norm_dict)):
        kw = {} if pkg is biapy_tpu else {"device": "cpu"}
        job = pkg.BiaPy(copy.deepcopy(cfg), result_dir=str(tmp_path / pkg.__name__), name=NAME,
                        silent=True, **kw)
        c = job.cfg
        tr, va = data(c, norm(c))
        loader = gen.BatchLoader(gen.PairDataset(tr, c, norm(c), augment=False), 2, seed=0,
                                 num_workers=0)
        loader.set_epoch(0)
        got.append(([(s.fid, s.coords.starts, s.coords.ends) for s in tr.sample_list],
                    [(s.fid, s.coords.starts) for s in va.sample_list], next(iter(loader))))
    (jtr, jva, jb), (ttr, tva, tb) = got
    assert ttr == jtr and tva == jva and len(ttr) > 8
    for k in ("x", "y"):
        np.testing.assert_array_equal(tb[k], jb[k])
    assert tb["y"].any() and tb["x"].std() > 0


@pytest.mark.parametrize("what", ["tta"])
def test_left_out_parts_name_the_roadmap(what, chunk_jobs, tmp_path):
    """Test-time augmentation under TEST.BY_CHUNKS, left out until ROADMAP
    queue 1 item 1, now takes the host crop/merge path and writes the store
    (its values against the JAX package's: tests/test_torch_tta.py)."""
    cfg = _chunks_cfg(chunk_jobs["root"], chunk_jobs["ckpt"], False)
    cfg["TEST"].update(AUGMENTATION=True, AUGMENTATION_GROUP="flips")
    job = biapy_tpu_torch.BiaPy(cfg, result_dir=str(tmp_path), name=NAME, silent=True,
                                device="cpu")
    job.test()
    raw = tzs.ZarrArray(f"{job.workflow.cfg.PATHS.RESULT_DIR.PER_IMAGE}/vol_chunks/"
                        "raw_pred.zarr")
    assert raw.shape == JOB_SHAPE + (1,) and np.asarray(raw[:]).std() > 0
