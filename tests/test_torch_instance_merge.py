"""The by-chunks instance merge of the port against the JAX package.

``ChunkedInference.create_and_merge_instances`` (passes A-E) on one seeded
raw-prediction Zarr: the F/C channels of a label volume whose spheres
straddle the tile cores' faces in z, y and x, each package's watershed as
the per-tile instance function. The tests hold:

* the merged ``instances.zarr`` equal to the JAX package's, id for id, for
  a float32 and a uint8 store, with and without the size filter after the
  merge (``min_instance_size``), and each straddling sphere one instance;
* two simulated ranks (threads with thread-backed collectives, as
  ``tests/test_chunked.py`` runs the JAX merge) give the one-rank ids;
* the order of the merge edges does not change the ids;
* the instance workflow's by-chunks hook: ``chunk_by_chunk`` with a size
  rule and a rule it does not apply (the warning), and ``entire_pred``,
  equal to the JAX package's;
* a small 3D instance job by chunks through ``run_job`` on both packages
  from one trained checkpoint: raw predictions within 1e-4 and identical
  instances.
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.config.config import get_cfg_defaults as jax_cfg_defaults
from biapy_tpu.data import pre_processing as JP
from biapy_tpu.data import zarr_store as jzs
from biapy_tpu.data.tiff import write_tiff
from biapy_tpu.engine import base_workflow as jax_base_workflow
from biapy_tpu.engine import chunked as jch
from biapy_tpu.engine.instance_seg import Instance_Segmentation_Workflow as JaxWF
from biapy_tpu.parallel import get_mesh as jax_get_mesh
from biapy_tpu_torch import native as TN
from biapy_tpu_torch.config.config import get_cfg_defaults
from biapy_tpu_torch.data import zarr_store as tzs
from biapy_tpu_torch.engine import chunked as tch
from biapy_tpu_torch.engine.instance_seg import Instance_Segmentation_Workflow as TorchWF

from test_torch_instance import spheres

torch.set_num_threads(2)

SHAPE = (24, 48, 52)
PATCH, PAD = (16, 32, 32), (2, 4, 4)  # cores 12 x 24 x 24: 2 x 2 x 3 tiles, the last ragged
# spheres centred on a core face in z, in y and in x (and one on the x face
# between the second and the ragged third tile)
STRADDLE = [((12, 10, 10), 4), ((5, 24, 11), 4), ((6, 36, 24), 5), ((17, 12, 48), 4)]


def _labels(seed=0):
    """The straddling spheres and seeded others, 2 voxels apart or more."""
    lab = np.zeros(SHAPE, np.int32)
    zz, yy, xx = np.ogrid[: SHAPE[0], : SHAPE[1], : SHAPE[2]]
    placed = list(STRADDLE)
    rng = np.random.default_rng(seed)
    for _ in range(300):
        if len(placed) == 14:
            break
        r = int(rng.integers(3, 6))
        c = tuple(int(rng.integers(r, s - r)) for s in SHAPE)
        if all(sum((a - b) ** 2 for a, b in zip(c, o)) >= (r + ro + 2) ** 2 for o, ro in placed):
            placed.append((c, r))
    for i, (c, r) in enumerate(placed):
        lab[(zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 < r * r] = i + 1
    return lab


def _cfg(defaults, test=None):
    cfg = defaults()
    cfg.merge_from_dict({
        "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": "3D",
                    "INSTANCE_SEG": {"DATA_CHANNELS": ["F", "C"]}},
        "DATA": {"PATCH_SIZE": PATCH + (1,)},
        "TEST": test or {},
    })
    return cfg


def _workflows(test=None):
    out = []
    for cls, defaults in ((JaxWF, jax_cfg_defaults), (TorchWF, get_cfg_defaults)):
        wf = cls.__new__(cls)
        wf.cfg = _cfg(defaults, test)
        wf.nd = 3
        wf.verbose = False
        wf.save_to_disk = False
        wf._predictions = []
        wf.all_matching_stats = []
        wf._class_ious = []
        wf.define_activations_and_channels()
        out.append(wf)
    return out


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """The F/C channels of ``_labels`` as a float32 and a uint8
    raw-prediction store (the JAX package writes them; the port reads the
    same bytes)."""
    base = tmp_path_factory.mktemp("merge")
    lab = _labels()
    chans = JP.labels_into_channels(lab, ["F", "C"]).astype(np.float32)
    paths = {}
    for store, data, dt in (("f4", chans, "f4"),
                            ("u1", np.round(chans * 255).astype(np.uint8), "u1")):
        p = str(base / f"raw_{store}.zarr")
        z = jzs.ZarrArray.create(p, shape=data.shape, chunks=(12, 24, 24, 2), dtype=dt,
                                 compressor={"id": "zlib", "level": 1})
        z[:, :, :, :] = data
        paths[store] = p
    return dict(labels=lab, paths=paths)


def _merge(pkg, wf, raw_path, out_dir, rank=0, world=1, **kw):
    ci = pkg.ChunkedInference(None, PATCH, (0.0,) * 3, PAD, (1, 1, 1), 2, str(out_dir),
                              rank=rank, world=world)
    path = ci.create_and_merge_instances(raw_path, wf.instance_seg_process, merge_iou_th=0.2,
                                         verbose=False, **kw)
    return ci, path


@pytest.mark.parametrize("min_size", [0, 150], ids=["no-size-filter", "size-filter"])
@pytest.mark.parametrize("store", ["f4", "u1"])
def test_merge_equals_jax_id_for_id(raw, store, min_size, tmp_path):
    jwf, twf = _workflows()
    _, jpath = _merge(jch, jwf, raw["paths"][store], tmp_path / "jax", min_instance_size=min_size)
    ci, tpath = _merge(tch, twf, raw["paths"][store], tmp_path / "torch",
                       min_instance_size=min_size)
    want = np.asarray(jzs.ZarrArray(jpath)[:])
    got = np.asarray(tzs.ZarrArray(tpath)[:])
    assert got.dtype == want.dtype == np.int32 and got.shape == SHAPE
    np.testing.assert_array_equal(got, want)
    st = ci.last_merge_stats
    assert st["tiles"] == 12 and st["edges"] >= len(STRADDLE)
    # ids that a tile's labels hold only in its halo keep their place (the
    # JAX merge's compaction counts them), so ids may skip; the size filter
    # drops them (size 0) and leaves the ids compact
    assert st["ids_before"] > st["ids_after"] >= got.max() > 0
    if min_size:
        assert st["ids_after"] == len(np.unique(got)) - 1 == got.max()
    lab = raw["labels"]
    for i in range(1, len(STRADDLE) + 1):  # each straddling sphere is one instance
        ids = np.unique(got[lab == i])
        assert len(ids) == 1 and ids[0] > 0, (i, ids)
    if min_size:
        sizes = np.bincount(got.ravel())[1:]
        assert sizes.min() >= min_size and len(sizes) < len(np.unique(lab)) - 1


def _thread_collectives(world):
    """barrier and all_gather_objects for ``world`` threads named
    ``rank<i>``: each gather deposits under (generation, rank), waits for
    every rank and reads all of them (tests/test_chunked.py's simulation)."""
    sync = threading.Barrier(world)
    box, gen, lock = {}, [0], threading.Lock()

    def barrier(name="barrier"):
        sync.wait(timeout=120)

    def gather(obj):
        rank = int(threading.current_thread().name[-1])
        with lock:
            g = gen[0]
            box[(g, rank)] = obj
        sync.wait(timeout=120)
        out = [box[(g, r)] for r in range(world)]
        sync.wait(timeout=120)
        with lock:
            if (g, 0) in box:
                for r in range(world):
                    box.pop((g, r), None)
                gen[0] += 1
        return out

    return barrier, gather


def test_two_simulated_ranks_give_the_one_rank_ids(raw, tmp_path, monkeypatch):
    jwf, twf = _workflows()
    _, jpath = _merge(jch, jwf, raw["paths"]["f4"], tmp_path / "jax", min_instance_size=50)
    barrier, gather = _thread_collectives(2)
    monkeypatch.setattr(tch, "barrier", barrier)
    monkeypatch.setattr(tch, "all_gather_objects", gather)
    results, errors = {}, []

    def run(rank):
        try:
            results[rank] = _merge(tch, twf, raw["paths"]["f4"], tmp_path / "torch", rank=rank,
                                   world=2, min_instance_size=50)
        except Exception as e:  # reported below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,), name=f"rank{r}") for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "rank thread hung"
    assert not errors, errors
    assert [results[r][0].last_merge_stats["tiles"] for r in (0, 1)] == [6, 6]
    got = np.asarray(tzs.ZarrArray(results[0][1])[:])
    np.testing.assert_array_equal(got, np.asarray(jzs.ZarrArray(jpath)[:]))


def test_edge_order_does_not_change_the_ids(raw, tmp_path, monkeypatch):
    _, twf = _workflows()
    _, ref = _merge(tch, twf, raw["paths"]["f4"], tmp_path / "ref")
    # the edges gathered in reverse order, each pair swapped
    plain = tch.all_gather_objects
    monkeypatch.setattr(tch, "all_gather_objects",
                        lambda obj: [[(b, a) for a, b in reversed(obj)]] if isinstance(obj, list)
                        else plain(obj))
    _, rev = _merge(tch, twf, raw["paths"]["f4"], tmp_path / "rev")
    np.testing.assert_array_equal(np.asarray(tzs.ZarrArray(rev)[:]),
                                  np.asarray(tzs.ZarrArray(ref)[:]))
    # union-find alone: every permutation of a chain of edges, each id to
    # its component's smallest
    rng = np.random.default_rng(1)
    edges = rng.integers(1, 40, (30, 2))
    want = TN.union_find_merge(edges, 40)
    for _ in range(5):
        perm = edges[rng.permutation(len(edges))][:, rng.permutation(2)]
        np.testing.assert_array_equal(TN.union_find_merge(perm, 40), want)
    assert all(want[i] <= i for i in range(41))


@pytest.mark.parametrize("kind", ["chunk_by_chunk", "entire_pred"])
def test_workflow_hook_equals_jax(raw, kind, tmp_path, capsys):
    test = {"BY_CHUNKS": {"ENABLE": True, "WORKFLOW_PROCESS": {
                "ENABLE": True, "TYPE": kind, "INSTANCE_SEG_MERGE_IOU_TH": 0.2}},
            "POST_PROCESSING": {"MEASURE_PROPERTIES": {
                "ENABLE": True, "REMOVE_BY_PROPERTIES": {
                    "ENABLE": True, "PROPS": [["size"], ["circularity"]],
                    "VALUES": [[150], [0.1]], "SIGNS": [["lt"], ["lt"]]}}}}
    got = []
    for pkg, wf in zip((jch, tch), _workflows(test)):
        wf.verbose = True
        ci = pkg.ChunkedInference(None, PATCH, (0.0,) * 3, PAD, (1, 1, 1), 2,
                                  str(tmp_path / pkg.__name__.split(".")[0]))
        capsys.readouterr()
        wf.after_by_chunks_prediction(ci, raw["paths"]["f4"], "vol")
        said = capsys.readouterr().out
        if kind == "chunk_by_chunk":
            assert "NOT applied: [('circularity', 'lt', 0.1)]" in said
            (p,) = [p for p in wf._predictions if p["role"] == "instances_zarr"]
            assert p["file"] == "vol"
            store = jzs if pkg is jch else tzs
            got.append(np.asarray(store.ZarrArray(p["path"])[:]))
        else:
            (p,) = [p for p in wf._predictions if p["role"] == "instances"]
            assert p["file"] == "vol.tif"
            got.append(p["instances"])
    np.testing.assert_array_equal(got[1], got[0])
    sizes = np.bincount(got[1].ravel())[1:]
    assert len(sizes) > 5 and sizes[sizes > 0].min() >= 150


# ---------------------------------------------------------------- a job by chunks
JOB_NAME = "inst_chunks"


def _job_cfg(root, train):
    cfg = {
        "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": "3D",
                    "INSTANCE_SEG": {"DATA_CHANNELS": ["B", "C"]}},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {
            "PATCH_SIZE": [16, 32, 32, 1],
            "TRAIN": {"PATH": f"{root}/train/x", "GT_PATH": f"{root}/train/y",
                      "IN_MEMORY": True},
            "VAL": {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.25},
            "TEST": {"PATH": f"{root}/test", "LOAD_GT": False, "IN_MEMORY": False,
                     "PADDING": [2, 4, 4]},
            # fixed statistics: a tile is otherwise normalised by its own
            "NORMALIZATION": {"TYPE": "zero_mean_unit_variance", "ZERO_MEAN_UNIT_VAR": {
                "MEAN_VAL": [60.0], "STD_VAL": [60.0]}},
        },
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8],
                  "DROPOUT_VALUES": [0.0, 0.0], "Z_DOWN": [1]},
        "TRAIN": {"ENABLE": train, "EPOCHS": 6, "BATCH_SIZE": 4, "OPTIMIZER": ["ADAMW"],
                  "LR": [0.01], "MIXED_PRECISION": False},
        "TEST": {"ENABLE": not train, "REDUCE_MEMORY": False,
                 "BY_CHUNKS": {"ENABLE": True, "WORKFLOW_PROCESS": {
                     "ENABLE": True, "PATCHES_PER_TILE": [1, 1, 1]}}},
        "LOG": {"CHART_CREATION_FREQ": 0},
    }
    return cfg


def test_instance_job_by_chunks_matches_jax(tmp_path):
    root = str(tmp_path)
    rng = np.random.default_rng(4)
    for d in ("train/x", "train/y", "test"):
        os.makedirs(f"{root}/{d}")
    for i in range(2):
        img, lab = spheres((20, 48, 48), 9, rng)
        write_tiff(f"{root}/train/x/{i:03d}.tif", img)
        write_tiff(f"{root}/train/y/{i:03d}.tif", lab)
    img, _ = spheres((24, 48, 48), 10, rng)
    z = jzs.ZarrArray.create(f"{root}/test/vol.zarr", shape=img.shape + (1,),
                             chunks=(12, 24, 24, 1), dtype="u1",
                             compressor={"id": "zlib", "level": 1})
    z[:, :, :, :] = img[..., None]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base_workflow, "get_mesh",
                   lambda spatial=1: jax_get_mesh(jax.devices()[:1]))
        trainer = biapy_tpu.BiaPy(_job_cfg(root, True), result_dir=f"{root}/train_run",
                                  name=JOB_NAME, silent=True)
        trainer.run_job()
        ckpt = f"{trainer.workflow.cfg.PATHS.CHECKPOINT}/{JOB_NAME}-checkpoint-best.ckpt"
        out = {}
        for side, pkg, kw in (("jax", biapy_tpu, {}),
                              ("torch", biapy_tpu_torch, {"device": "cpu"})):
            cfg = _job_cfg(root, False)
            cfg["MODEL"]["LOAD_CHECKPOINT"] = True
            cfg["PATHS"] = {"CHECKPOINT_FILE": ckpt}
            job = pkg.BiaPy(cfg, result_dir=f"{root}/{side}", name=JOB_NAME, silent=True, **kw)
            job.run_job()
            (p,) = [p for p in job.workflow._predictions if p["role"] == "instances_zarr"]
            store = jzs if side == "jax" else tzs
            chunks = os.path.dirname(p["path"])
            out[side] = (np.asarray(store.ZarrArray(f"{chunks}/raw_pred.zarr")[:], np.float32),
                         np.asarray(store.ZarrArray(p["path"])[:]))
    (jraw, jinst), (traw, tinst) = out["jax"], out["torch"]
    assert traw.shape == jraw.shape == (24, 48, 48, 2)
    np.testing.assert_allclose(traw, jraw, rtol=0, atol=1e-4)
    assert tinst.shape == (24, 48, 48) and tinst.max() > 3
    np.testing.assert_array_equal(tinst, jinst)
