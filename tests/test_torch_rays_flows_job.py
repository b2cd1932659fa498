"""StarDist and Cellpose jobs, the port against the JAX package.

Two tiny jobs on seeded TIFFs, float32, SGD, no worker threads, the JAX job
on one device of the test mesh:

* 2D StarDist, codes F and R (the probability from F), ``resunet`` [4, 8]
  on 32 x 32 patches;
* 3D Cellpose, codes F, Gv, Gh and Gz, ``resunet`` [4, 8] on 16 x 32 x 32
  patches, with the Cellpose defaults (DIAMETER 0, so the test pass takes the
  diameter from a first pass on one patch and rescales the volume in-plane
  before the model and the prediction back after it).

Each job trains on both packages from one JAX-written initial checkpoint
(the loss curves within 1e-4), and the port then runs its test pass again
from the JAX job's best checkpoint, whose weights it carries across:
identical instance ids and an identical metrics CSV. The compile caches
(the R channels, the flows, ``cellpose_diam.json``) are byte-equal.

By chunks: the ray NMS tile by tile and the merge across the tiles
(``create_and_merge_instances`` with the workflow's instance function) on
one seeded F/R raw-prediction Zarr: the same ``instances.zarr`` as the JAX
package's, id for id.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.data import pre_processing as JP
from biapy_tpu.data import zarr_store as jzs
from biapy_tpu.data.tiff import read_tiff, write_tiff
from biapy_tpu.engine import base_workflow as jax_base_workflow
from biapy_tpu.engine import chunked as jch
from biapy_tpu.parallel import get_mesh as jax_get_mesh
from biapy_tpu.utils.misc import save_model as jax_save_model
from biapy_tpu_torch.data import zarr_store as tzs
from biapy_tpu_torch.engine import chunked as tch

from test_torch_instance import spheres
from test_torch_instance_merge import _workflows as merge_workflows

torch.set_num_threads(2)

NAME = "rf"


def _discs(shape, n, rng):
    lab = np.zeros(shape, np.uint16)
    img = np.zeros(shape, np.float32)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    placed = []
    for _ in range(300):
        if len(placed) == n:
            break
        r = int(rng.integers(5, 9))
        c = (int(rng.integers(r + 1, shape[0] - r - 1)), int(rng.integers(r + 1, shape[1] - r - 1)))
        if any((c[0] - a) ** 2 + (c[1] - b) ** 2 < (r + ro + 3) ** 2 for a, b, ro in placed):
            continue
        m = (yy - c[0]) ** 2 + (xx - c[1]) ** 2 < r * r
        lab[m] = len(placed) + 1
        img += m * 0.7
        placed.append((*c, r))
    img += rng.normal(0, 0.08, shape)
    return (img * 200).clip(0, 255).astype(np.uint8), lab


# SGD rates: at 0.02 the Cellpose job's second epoch raises the validation
# loss (1.87 to 2.08), a step that turns the first epoch's 2e-5 between the
# packages into 3.4e-4; at 0.01 both epochs descend
KINDS = {
    "stardist": dict(nd=2, codes=["F", "R"], extra={"R": {"nrays": 16}},
                     shapes=((64, 64), (60, 56)), patch=[32, 32, 1], pad=[4, 4],
                     cache="train/y_FR_11", lr=0.02),
    "cellpose": dict(nd=3, codes=["F", "Gv", "Gh", "Gz"], extra={},
                     shapes=((16, 40, 40), (16, 36, 40)), patch=[16, 32, 32, 1],
                     pad=[2, 4, 4], cache="train/y_FGvGhGz_11", lr=0.01),
}


def _write(root, kind):
    k = KINDS[kind]
    rng = np.random.default_rng(3)
    for split, n, shape in (("train", 2, k["shapes"][0]), ("test", 1, k["shapes"][1])):
        for d in ("x", "y"):
            os.makedirs(f"{root}/{split}/{d}")
        for i in range(n):
            img, lab = (_discs(shape, 6, rng) if k["nd"] == 2
                        else spheres(shape, 6, rng, r_range=(3, 6)))
            write_tiff(f"{root}/{split}/x/{i:03d}.tif", img)
            write_tiff(f"{root}/{split}/y/{i:03d}.tif", lab)


def _cfg(root, kind):
    k = KINDS[kind]
    return {
        "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": f"{k['nd']}D",
                    "INSTANCE_SEG": {"DATA_CHANNELS": k["codes"],
                                     "DATA_CHANNELS_EXTRA_OPTS": [k["extra"]]}},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {
            "PATCH_SIZE": k["patch"],
            "TRAIN": {"PATH": f"{root}/train/x", "GT_PATH": f"{root}/train/y",
                      "IN_MEMORY": True},
            "VAL": {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.3},
            "TEST": {"PATH": f"{root}/test/x", "GT_PATH": f"{root}/test/y", "IN_MEMORY": True,
                     "LOAD_GT": True, "PADDING": k["pad"]},
        },
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8],
                  "DROPOUT_VALUES": [0.0, 0.0], "Z_DOWN": [1], "SAVE_CKPT_FREQ": 1},
        "TRAIN": {"ENABLE": True, "EPOCHS": 2, "BATCH_SIZE": 2, "OPTIMIZER": ["SGD"],
                  "LR": [k["lr"]], "MIXED_PRECISION": False},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": False, "MATCHING_STATS_THS": [0.3, 0.5]},
        "LOG": {"CHART_CREATION_FREQ": 0},
    }


def _run_jax(cfg, result_dir):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_base_workflow, "get_mesh",
                   lambda spatial=1: jax_get_mesh(jax.devices()[:1]))
        job = biapy_tpu.BiaPy(cfg, result_dir=result_dir, name=NAME, silent=True)
        job.run_job()
    return job


@pytest.fixture(scope="module", params=list(KINDS))
def runs(request, tmp_path_factory):
    kind = request.param
    base = str(tmp_path_factory.mktemp(kind))
    roots = {side: f"{base}/{side}_data" for side in ("jax", "torch")}
    _write(roots["jax"], kind)
    shutil.copytree(roots["jax"], roots["torch"])
    init = biapy_tpu.BiaPy(_cfg(roots["jax"], kind), result_dir=f"{base}/init", name=NAME,
                           silent=True)
    init._build_workflow()
    init.workflow.prepare_model()
    st = init.workflow.state
    init_ckpt = jax_save_model(init.workflow.cfg, f"{base}/init", "init",
                               jax.tree.map(np.asarray, st.params), 0,
                               jax.tree.map(np.asarray, st.batch_stats))
    jobs = {}
    for side in ("jax", "torch"):
        cfg = _cfg(roots[side], kind)
        cfg["MODEL"].update(LOAD_CHECKPOINT=True, ITEMS_TO_LOAD_FROM_CHECKPOINT=["weights"])
        cfg["PATHS"] = {"CHECKPOINT_FILE": init_ckpt}
        if side == "jax":
            jobs[side] = _run_jax(cfg, f"{base}/jax")
        else:
            jobs[side] = biapy_tpu_torch.BiaPy(cfg, result_dir=f"{base}/torch", name=NAME,
                                               silent=True, device="cpu")
            jobs[side].run_job()
    # the port's test pass from the JAX job's best checkpoint, on the JAX
    # job's data
    cfg = _cfg(roots["jax"], kind)
    cfg["TRAIN"]["ENABLE"] = False
    cfg["MODEL"]["LOAD_CHECKPOINT"] = True
    cfg["PATHS"] = {"CHECKPOINT_FILE":
                    f"{jobs['jax'].job_dir}/checkpoints/{NAME}-checkpoint-best.ckpt"}
    carried = biapy_tpu_torch.BiaPy(cfg, result_dir=f"{base}/carried", name=NAME, silent=True,
                                    device="cpu")
    carried.run_job()
    return dict(kind=kind, base=base, roots=roots, carried=carried, **jobs)


def test_compile_caches_are_byte_equal(runs):
    cache = KINDS[runs["kind"]]["cache"]
    files = {side: sorted(os.path.basename(p) for p in glob.glob(f"{root}/{cache}/*"))
             for side, root in runs["roots"].items()}
    want = ["000.npy", "001.npy", "_channels_meta.json"]
    if runs["kind"] == "cellpose":
        want.append("cellpose_diam.json")
    assert files["torch"] == files["jax"] == want
    for f in files["torch"]:
        with open(f"{runs['roots']['torch']}/{cache}/{f}", "rb") as a, \
                open(f"{runs['roots']['jax']}/{cache}/{f}", "rb") as b:
            assert a.read() == b.read(), f
    if runs["kind"] == "cellpose":
        with open(f"{runs['roots']['torch']}/{cache}/cellpose_diam.json") as f:
            assert runs["torch"].workflow.cellpose_diameter == json.load(f)["median_diameter"]


def test_loss_curves_match_jax(runs):
    recs = {}
    for side in ("jax", "torch"):
        with open(f"{runs[side].cfg.LOG.LOG_DIR}/{NAME}_train.jsonl") as f:
            recs[side] = [json.loads(line) for line in f]
    assert [r["epoch"] for r in recs["torch"]] == [r["epoch"] for r in recs["jax"]] == [0, 1]
    for j, t in zip(recs["jax"], recs["torch"]):
        for k in ("loss", "val_loss"):
            assert abs(t[k] - j[k]) <= 1e-4, (k, t[k], j[k])


def test_carried_weights_give_identical_instances_and_csv(runs):
    jax_wf, port_wf = runs["jax"].workflow, runs["carried"].workflow
    res = {side: wf.cfg.PATHS.RESULT_DIR for side, wf in (("jax", jax_wf), ("torch", port_wf))}
    jinst = read_tiff(f"{res['jax'].PER_IMAGE_INSTANCES}/000.tif")
    tinst = read_tiff(f"{res['torch'].PER_IMAGE_INSTANCES}/000.tif")
    shape = KINDS[runs["kind"]]["shapes"][1]
    assert tinst.shape == jinst.shape == shape and tinst.dtype == jinst.dtype
    assert jinst.max() > 0
    np.testing.assert_array_equal(tinst, jinst)
    traw = read_tiff(f"{res['torch'].PER_IMAGE}/000.tif")
    jraw = read_tiff(f"{res['jax'].PER_IMAGE}/000.tif")
    np.testing.assert_allclose(traw, jraw, rtol=0, atol=1e-5)
    csvs = {s: open(f"{r.PATH}/{NAME}_per_image_metrics.csv").read() for s, r in res.items()}
    assert csvs["torch"] == csvs["jax"] and csvs["jax"].count("\n") == 2
    assert [s["f1"] for s in port_wf.matching_stats] == [s["f1"] for s in jax_wf.matching_stats]
    if runs["kind"] == "cellpose":
        # the diameter of the first pass, and the rescale it gave
        assert port_wf._cellpose_diam == jax_wf._cellpose_diam > 0
        assert port_wf._cellpose_factor == jax_wf._cellpose_factor


def test_rays_by_chunks_equal_jax_id_for_id(tmp_path):
    """The ray NMS tile by tile and the merge across the tiles: the same
    ``instances.zarr`` as the JAX package's."""
    from test_torch_instance_merge import PAD, PATCH, _labels

    lab = _labels(seed=4)
    rng = np.random.default_rng(5)
    chans = JP.labels_into_channels(lab, ["F", "R"], {"R": {"nrays": 32}}).astype(np.float32)
    chans += rng.normal(0, 0.05, chans.shape).astype(np.float32)
    raw = str(tmp_path / "raw.zarr")
    z = jzs.ZarrArray.create(raw, shape=chans.shape, chunks=(12, 24, 24, chans.shape[-1]),
                             dtype="f4", compressor={"id": "zlib", "level": 1})
    z[:, :, :, :] = chans
    test = {"BY_CHUNKS": {"ENABLE": True}}
    jwf, twf = merge_workflows(test)
    for wf in (jwf, twf):
        wf.cfg.defrost()
        wf.cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNELS = ["F", "R"]
        wf.cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNELS_EXTRA_OPTS = [{"R": {"nrays": 32}}]
        wf.device = torch.device("cpu")
        wf.define_activations_and_channels()
    paths = {}
    for side, pkg, wf in (("jax", jch, jwf), ("torch", tch, twf)):
        ci = pkg.ChunkedInference(None, PATCH, (0.0,) * 3, PAD, (1, 1, 1), 2,
                                  str(tmp_path / side))
        paths[side] = ci.create_and_merge_instances(raw, wf._instance_fn_no_size_filter,
                                                    merge_iou_th=0.2, verbose=False)
    want = np.asarray(jzs.ZarrArray(paths["jax"])[:])
    got = np.asarray(tzs.ZarrArray(paths["torch"])[:])
    assert got.dtype == want.dtype == np.int32 and got.shape == lab.shape
    assert want.max() >= 4
    np.testing.assert_array_equal(got, want)
