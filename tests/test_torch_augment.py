"""Augmentation, pre-processing and NIfTI, the port against the JAX package.

The JAX augmentors call OpenCV; the port resamples with ``F.grid_sample``
and integer gathers (``data/augmentors.py``). From the same seed:

* every transform that does not interpolate gives the JAX package's output
  exactly (the same numpy draws in the same order);
* the warps (affine in each border mode, rotation, shear, shift, zoom,
  elastic, misalignment, motion blur, cutblur) give images within
  ``IMG_TOL`` and masks with at most ``MASK_SHARE`` of their voxels off
  (none expected): OpenCV resamples images of 1, 3 or 4 channels at float
  coordinates and others on a 1/32-pixel grid, which the port reproduces;
  float32 sums in other orders remain (measured: below 3e-5 on these data,
  whose values span about 20);
* the whole pipeline with every op on, a ``BatchLoader`` epoch with the
  repository template's set (RANDOM_ROT, VFLIP, HFLIP, ZFLIP), and two
  small training jobs against the JAX package's loss curves;
* ``preprocess_image`` with each ``DATA.PREPROCESS`` option; NIfTI files
  written by either package read back by the other.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.config.config import get_cfg_defaults as jax_cfg_defaults
from biapy_tpu.data import augmentors as JA
from biapy_tpu.data import generators as JG
from biapy_tpu.data import pre_processing as JP
from biapy_tpu.data.data_manipulation import load_and_prepare_train_data as jax_train_data
from biapy_tpu.data.norm import build_norm_dict as jax_norm_dict
from biapy_tpu.engine import base_workflow as jax_base_workflow
from biapy_tpu.parallel import get_mesh as jax_get_mesh
from biapy_tpu.utils.misc import save_model as jax_save_model
from biapy_tpu_torch.config.config import get_cfg_defaults
from biapy_tpu_torch.data import augmentors as TA
from biapy_tpu_torch.data import generators as TG
from biapy_tpu_torch.data import io as tio
from biapy_tpu_torch.data import pre_processing as TP
from biapy_tpu_torch.data.data_manipulation import load_and_prepare_train_data
from biapy_tpu_torch.data.norm import build_norm_dict

from test_torch_job import _cfg as _job_cfg
from test_torch_job import _make_volumes

torch.set_num_threads(2)

IMG_TOL = 2e-4
MASK_SHARE = 1e-3
NAME = "aug"


def _data(shape, seed, mask_channels=1):
    """A smooth image plus noise (values spanning about 20) and a blob mask."""
    rng = np.random.default_rng(seed)
    img = (ndimage.gaussian_filter(rng.normal(size=shape), 1) * 3
           + rng.normal(size=shape)).astype(np.float32)
    msk = (ndimage.gaussian_filter(rng.random(shape[:-1] + (mask_channels,)), 2) > 0.5)
    return img, msk.astype(np.float32)


# 3D patches with one and two channels (OpenCV's float and fixed-point
# resampling), a 2D patch with three
SHAPES = [((6, 30, 34, 1), 1), ((5, 28, 33, 2), 2), ((30, 34, 3), 1)]
SHAPE_IDS = ["3d-c1", "3d-c2", "2d-c3"]


def _both(fn_j, fn_t, shape, mask_ch, seed):
    img, msk = _data(shape, seed, mask_ch)
    a = fn_j(img.copy(), msk.copy(), np.random.default_rng(seed))
    b = fn_t(img.copy(), msk.copy(), np.random.default_rng(seed))
    return (a, b) if isinstance(a, tuple) else ((a, None), (b, None))


EXACT = {
    "vflip": lambda m, i, k, r: m.flip(i, k, -3),
    "hflip": lambda m, i, k, r: m.flip(i, k, -2),
    "zflip": lambda m, i, k, r: m.flip(i, k, 0),
    "rot90": lambda m, i, k, r: m.rot90(i, k, r),
    "dropout": lambda m, i, k, r: m.dropout(i, r),
    "cutout": lambda m, i, k, r: m.cutout(i, k, r, apply_to_mask=True),
    "cutnoise": lambda m, i, k, r: m.cutnoise(i, r),
    "salt": lambda m, i, k, r: m.salt(i, r),
    "pepper": lambda m, i, k, r: m.pepper(i, r),
    "salt_and_pepper": lambda m, i, k, r: m.salt_and_pepper(i, r),
    "gaussian_noise": lambda m, i, k, r: m.gaussian_noise(i, r),
    "poisson_noise": lambda m, i, k, r: m.poisson_noise(i, r),
    "gamma": lambda m, i, k, r: m.gamma_contrast(i - i.min(), r),
    "brightness": lambda m, i, k, r: m.brightness(i, r),
    "contrast": lambda m, i, k, r: m.contrast(i, r),
    "grayscale": lambda m, i, k, r: m.grayscale(i, r),
    "channel_shuffle": lambda m, i, k, r: m.channel_shuffle(i, r),
    "gridmask": lambda m, i, k, r: m.gridmask(i, r),
    "missing_sections": lambda m, i, k, r: m.missing_sections(i, r, iterations=(2, 4)),
    "gaussian_blur": lambda m, i, k, r: m.gaussian_blur(i, r),
    "median_blur": lambda m, i, k, r: m.median_blur(i, r),
    "zoom_z": lambda m, i, k, r: m.zoom_3d_z(i, k, r),
    "cutmix": lambda m, i, k, r: m.cutmix(i, i[::-1].copy(), k, k[::-1].copy(), r),
}


_ONLY_3D = ("zflip", "missing_sections", "zoom_z")


@pytest.mark.parametrize("name,shape,mask_ch", [
    pytest.param(name, shape, ch, id=f"{name}-{sid}")
    for name in EXACT for (shape, ch), sid in zip(SHAPES, SHAPE_IDS)
    if not (name in _ONLY_3D and len(shape) == 3)])
def test_transforms_without_interpolation_equal_jax(name, shape, mask_ch):
    fn = EXACT[name]
    for seed in range(3):
        (ji, jm), (ti, tm) = _both(lambda i, k, r: fn(JA, i, k, r), lambda i, k, r: fn(TA, i, k, r),
                                   shape, mask_ch, seed)
        assert ti.dtype == ji.dtype and ti.shape == ji.shape
        np.testing.assert_array_equal(ti, ji)
        if jm is not None:
            np.testing.assert_array_equal(tm, jm)


def _affine(mode, **kw):
    kw = kw or dict(zoom=(1.2, 0.9), rot_deg=23.7, shear_deg=11.0, shift_frac=(0.1, -0.15))
    return lambda m, i, k, r: m.affine_2d(i, k, r, mode=mode, **kw)


WARPS = {
    "affine-reflect": _affine("reflect"),
    "affine-constant": _affine("constant"),
    "affine-wrap": _affine("wrap"),
    "affine-symmetric": _affine("symmetric"),
    "rotation": _affine("reflect", rot_deg=-131.0),
    "shear": _affine("reflect", shear_deg=-17.0),
    "shift": _affine("reflect", shift_frac=(-0.2, 0.13)),
    "zoom": _affine("constant", zoom=(0.6, 0.6)),
    "elastic-constant": lambda m, i, k, r: m.elastic(i, k, r),
    "elastic-reflect": lambda m, i, k, r: m.elastic(i, k, r, mode="reflect"),
    "misalignment-rotate": lambda m, i, k, r: m.misalignment(i, k, r, rotate_ratio=1.0),
    "misalignment-shift": lambda m, i, k, r: m.misalignment(i, k, r, rotate_ratio=0.0),
    "motion_blur": lambda m, i, k, r: m.motion_blur(i, r),
    "cutblur-inside": lambda m, i, k, r: m.cutblur(i, r),
    "cutblur-outside": lambda m, i, k, r: m.cutblur(i, r, inside=False),
}


@pytest.mark.parametrize("shape,mask_ch", SHAPES + [((6, 30, 34, 1), 2)],
                         ids=SHAPE_IDS + ["3d-mask-c2"])
@pytest.mark.parametrize("name", list(WARPS))
def test_warps_within_the_pinned_tolerance(name, shape, mask_ch):
    fn = WARPS[name]
    for seed in range(3):
        (ji, jm), (ti, tm) = _both(lambda i, k, r: fn(JA, i, k, r), lambda i, k, r: fn(TA, i, k, r),
                                   shape, mask_ch, seed)
        assert ti.dtype == ji.dtype and ti.shape == ji.shape
        err = float(np.abs(ti - ji).max())
        assert err <= IMG_TOL, (name, seed, err)
        if jm is not None:
            assert tm.shape == jm.shape and tm.dtype == jm.dtype
            assert np.count_nonzero(tm != jm) <= MASK_SHARE * tm.size


def _all_ops(cfg):
    a = cfg.AUGMENTOR
    a.ENABLE = True
    for k in ("ZOOM", "RANDOM_ROT", "SHEAR", "SHIFT", "ROT90", "VFLIP", "HFLIP", "ZFLIP",
              "ELASTIC", "G_BLUR", "MEDIAN_BLUR", "MOTION_BLUR", "GAMMA_CONTRAST", "BRIGHTNESS",
              "CONTRAST", "DROPOUT", "CUTOUT", "CUTBLUR", "CUTNOISE", "MISALIGNMENT",
              "MISSING_SECTIONS", "GRAYSCALE", "CHANNEL_SHUFFLE", "GRIDMASK", "GAUSSIAN_NOISE",
              "POISSON_NOISE", "SALT", "PEPPER", "SALT_AND_PEPPER", "CUTMIX"):
        setattr(a, k, True)
    a.MISSP_ITERATIONS = [1, 2]
    return cfg


@pytest.mark.parametrize("flips_only", [True, False], ids=["flips", "every-op"])
def test_pipeline_matches_jax(flips_only):
    """``AugmentorPipeline`` and ``maybe_cutmix`` from one generator per
    sample: exact with flips only. With every op on, the generator states
    agree afterwards (no op drew more or less than the JAX one), the masks
    are within the warps' share and the images within ``IMG_TOL`` but at
    most ``MASK_SHARE`` of their voxels: Poisson noise draws integer counts
    from the values the warps left, so a 1e-5 difference upstream can move
    a voxel by a count (up to 3e-3 on these data)."""
    cfgs = []
    for defaults in (jax_cfg_defaults, get_cfg_defaults):
        cfg = defaults()
        if flips_only:
            cfg.AUGMENTOR.ENABLE = True
            cfg.AUGMENTOR.VFLIP = cfg.AUGMENTOR.HFLIP = cfg.AUGMENTOR.ZFLIP = True
        else:
            _all_ops(cfg)
        cfgs.append(cfg)
    pj, pt = JA.AugmentorPipeline(cfgs[0], ndim=3), TA.AugmentorPipeline(cfgs[1], ndim=3)
    for seed in range(12):
        img, msk = _data((6, 30, 34, 1), seed)
        out = []
        for p in (pj, pt):
            rng = np.random.default_rng(seed)
            i, m = p.maybe_cutmix(img.copy(), msk.copy(), img[:, ::-1].copy(),
                                  msk[:, ::-1].copy(), rng)
            i, m = p(i, m, rng)
            out.append((i, m, rng.random()))
        (ji, jm, jr), (ti, tm, tr) = out
        assert tr == jr, seed
        if flips_only:
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)
        else:
            assert np.count_nonzero(np.abs(ti - ji) > IMG_TOL) <= MASK_SHARE * ti.size, seed
            assert np.count_nonzero(tm != jm) <= MASK_SHARE * tm.size


# ------------------------------------------------------------ loader and jobs
def _template_aug(cfg):
    """The repository template's augmentations
    (templates/semantic_segmentation/3d_semantic_segmentation.yaml)."""
    cfg["AUGMENTOR"] = {"ENABLE": True, "RANDOM_ROT": True, "VFLIP": True, "HFLIP": True,
                        "ZFLIP": True, "AUG_SAMPLES": False}
    return cfg


def test_batch_loader_epoch_with_the_template_set_matches_jax(tmp_path):
    root = str(tmp_path)
    _make_volumes(root, "train", 2, (32, 32, 32), 0)
    cfg = _template_aug(_job_cfg(root))
    cfg["TEST"]["ENABLE"] = False
    batches = []
    for pkg, data, gen, norm in ((biapy_tpu, jax_train_data, JG, jax_norm_dict),
                                 (biapy_tpu_torch, load_and_prepare_train_data, TG,
                                  build_norm_dict)):
        kw = {} if pkg is biapy_tpu else {"device": "cpu"}
        c = pkg.BiaPy(copy.deepcopy(cfg), result_dir=root, name=NAME, silent=True, **kw).cfg
        tr, _ = data(c, norm(c))
        loader = gen.BatchLoader(gen.PairDataset(tr, c, norm(c), augment=True), 2, seed=0,
                                 num_workers=2)
        loader.set_epoch(1)
        batches.append(list(loader))
    assert len(batches[1]) == len(batches[0]) == 6
    for jb, tb in zip(*batches):
        assert float(np.abs(tb["x"] - jb["x"]).max()) <= IMG_TOL
        assert np.count_nonzero(tb["y"] != jb["y"]) <= MASK_SHARE * tb["y"].size
        assert tb["x"].shape == jb["x"].shape == (2, 16, 16, 16, 1)


@pytest.mark.parametrize("in_memory", [True, False], ids=["in-memory", "from-disk"])
def test_preprocessed_training_batches_match_jax(tmp_path, in_memory):
    """DATA.PREPROCESS.TRAIN (a resize and a blur) before the patch grid and
    the statistics, in memory or at sample time from disk: the sample grid
    and the first loader batch equal the JAX package's."""
    root = str(tmp_path)
    _make_volumes(root, "train", 2, (32, 32, 32), 0)
    cfg = _job_cfg(root)
    cfg["TEST"]["ENABLE"] = False
    cfg["DATA"]["TRAIN"]["IN_MEMORY"] = in_memory
    cfg["DATA"]["PREPROCESS"] = {"TRAIN": True, "VAL": True,
                                 "RESIZE": {"ENABLE": True, "OUTPUT_SHAPE": [24, 40, 36]},
                                 "GAUSSIAN_BLUR": {"ENABLE": True, "SIGMA": 1.0}}
    got = []
    for pkg, data, gen, norm in ((biapy_tpu, jax_train_data, JG, jax_norm_dict),
                                 (biapy_tpu_torch, load_and_prepare_train_data, TG,
                                  build_norm_dict)):
        kw = {} if pkg is biapy_tpu else {"device": "cpu"}
        c = pkg.BiaPy(copy.deepcopy(cfg), result_dir=root, name=NAME, silent=True, **kw).cfg
        tr, va = data(c, norm(c))
        loader = gen.BatchLoader(gen.PairDataset(tr, c, norm(c), augment=True), 2, seed=0,
                                 num_workers=0)
        got.append(([(s.fid, s.coords.starts) for s in tr.sample_list + va.sample_list],
                    next(iter(loader))))
    (jkeys, jb), (tkeys, tb) = got
    assert tkeys == jkeys and len(tkeys) > 16  # the resize grew the patch grid
    for k in ("x", "y"):
        np.testing.assert_array_equal(tb[k], jb[k])


@pytest.fixture(scope="module")
def aug_jobs(tmp_path_factory):
    """Two small jobs in each package from one JAX-written checkpoint: flips
    only, and the template's set (RANDOM_ROT added)."""
    root = str(tmp_path_factory.mktemp("augjob"))
    _make_volumes(root, "train", 2, (32, 32, 32), 0)
    _make_volumes(root, "test", 1, (20, 36, 28), 1)
    base = _job_cfg(root)
    base["TEST"]["ENABLE"] = False
    init = biapy_tpu.BiaPy(copy.deepcopy(base), result_dir=f"{root}/init", name=NAME, silent=True)
    init._build_workflow()
    init.workflow.prepare_model()
    st = init.workflow.state
    ckpt = jax_save_model(init.workflow.cfg, f"{root}/init", "init",
                          jax.tree.map(np.asarray, st.params), 0,
                          jax.tree.map(np.asarray, st.batch_stats))
    base["MODEL"].update(LOAD_CHECKPOINT=True, ITEMS_TO_LOAD_FROM_CHECKPOINT=["weights"])
    base["PATHS"] = {"CHECKPOINT_FILE": ckpt}
    out = {}
    for tag in ("flips", "template"):
        cfg = _template_aug(copy.deepcopy(base))
        if tag == "flips":
            cfg["AUGMENTOR"]["RANDOM_ROT"] = False
        cfg["DATA"]["CHECK_GENERATORS"] = True
        cfg["AUGMENTOR"].update(AUG_SAMPLES=True, AUG_NUM_SAMPLES=3)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_base_workflow, "get_mesh",
                       lambda spatial=1: jax_get_mesh(jax.devices()[:1]))
            jjob = biapy_tpu.BiaPy(copy.deepcopy(cfg), result_dir=f"{root}/jax_{tag}", name=NAME,
                                   silent=True)
            jjob.train()
        tjob = biapy_tpu_torch.BiaPy(copy.deepcopy(cfg), result_dir=f"{root}/torch_{tag}",
                                     name=NAME, silent=True, device="cpu")
        tjob.train()
        out[tag] = (jjob, tjob)
    return out


def _records(job):
    with open(f"{job.cfg.LOG.LOG_DIR}/{NAME}_train.jsonl") as f:
        return [json.loads(line) for line in f]


# flips only: the batches are exact, so float32 sums in other orders over
# 12 SGD steps (as tests/test_torch_job.py). With RANDOM_ROT the images
# differ by up to 3e-5 from OpenCV's (the tolerance above) and the masks
# not at all, which moves these losses by less than 1e-5: held at 1e-4 too.
LOSS_TOL = {"flips": 1e-4, "template": 1e-4}


@pytest.mark.parametrize("tag", ["flips", "template"])
def test_augmented_job_loss_curve_matches_jax(aug_jobs, tag):
    jjob, tjob = aug_jobs[tag]
    jr, tr = _records(jjob), _records(tjob)
    assert [r["epoch"] for r in tr] == [r["epoch"] for r in jr] == [0, 1]
    for j, t in zip(jr, tr):
        for k in ("loss", "val_loss", "iou", "val_iou"):
            assert abs(t[k] - j[k]) <= LOSS_TOL[tag], (tag, k, t[k], j[k])


def test_generator_checks_and_augmented_samples_are_written(aug_jobs):
    """DATA.CHECK_GENERATORS and AUGMENTOR.AUG_SAMPLES write what the JAX
    package writes (the samples' names; the first batch's values)."""
    jjob, tjob = aug_jobs["flips"]
    for sub in (os.path.join(tjob.cfg.PATHS.GEN_CHECKS, "x"), tjob.cfg.PATHS.GEN_MASK_CHECKS,
                tjob.cfg.PATHS.DA_SAMPLES):
        jsub = sub.replace(tjob.job_dir, jjob.job_dir)
        names = sorted(os.listdir(sub))
        assert names == sorted(os.listdir(jsub)) and names
        for n in names:
            np.testing.assert_array_equal(
                tio.read_img_as_ndarray(os.path.join(sub, n), is_3d=True),
                tio.read_img_as_ndarray(os.path.join(jsub, n), is_3d=True))


# ------------------------------------------------------------ pre-processing
PREPROCESS = {
    "resize": {"RESIZE": {"ENABLE": True, "OUTPUT_SHAPE": [10, 20, 18]}},
    "resize-aa": {"RESIZE": {"ENABLE": True, "OUTPUT_SHAPE": [6, 9, 11], "ANTI_ALIASING": True,
                             "ORDER": 3}},
    "gaussian_blur": {"GAUSSIAN_BLUR": {"ENABLE": True, "SIGMA": 1.5}},
    "median_blur": {"MEDIAN_BLUR": {"ENABLE": True, "KERNEL_SIZE": [3, 3, 1]}},
    "match_histogram": {"MATCH_HISTOGRAM": {"ENABLE": True}},
    "clahe": {"CLAHE": {"ENABLE": True, "CLIP_LIMIT": 0.02}},
    "canny": {"CANNY": {"ENABLE": True}},
}


@pytest.mark.parametrize("name", list(PREPROCESS))
def test_preprocess_image_matches_jax(name, tmp_path):
    rng = np.random.default_rng(3)
    img = (ndimage.gaussian_filter(rng.random((8, 24, 22, 1)), 1.5) * 255).astype(np.uint8)
    msk = (img > 128).astype(np.uint8)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    tio.imwrite(str(ref_dir / "ref.tif"), (rng.random((8, 24, 22)) * 90).astype(np.uint8))
    outs = []
    for defaults, P in ((jax_cfg_defaults, JP), (get_cfg_defaults, TP)):
        pre = defaults().DATA.PREPROCESS
        for op, kv in PREPROCESS[name].items():
            for k, v in kv.items():
                setattr(getattr(pre, op), k, v)
        pre.MATCH_HISTOGRAM.REFERENCE_PATH = str(ref_dir)
        outs.append((P.preprocess_image(pre, img, is_2d=False),
                     P.preprocess_image(pre, msk, is_mask=True, is_2d=False)))
    (ji, jm), (ti, tm) = outs
    assert ti.dtype == ji.dtype and ti.shape == ji.shape
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)


def test_nifti_round_trip_between_packages(tmp_path):
    """A .nii.gz written by either package reads back in the other, through
    the readers' dispatch (``imread`` / ``imwrite``)."""
    from biapy_tpu.data import io as jio

    rng = np.random.default_rng(0)
    for data in (rng.normal(size=(7, 9, 11)).astype(np.float32),
                 rng.integers(0, 256, (5, 6, 4), dtype=np.uint8)):
        for writer, reader in ((jio, tio), (tio, jio)):
            for ext in (".nii", ".nii.gz"):
                p = str(tmp_path / f"{writer.__name__.split('.')[0]}{ext}")
                writer.imwrite(p, data)
                got = reader.imread(p)
                assert got.dtype == data.dtype
                np.testing.assert_array_equal(got, data)
        raw = str(tmp_path / "raw.nii")
        tio.imwrite(raw, data)
        assert open(raw, "rb").read() == open(str(tmp_path / "biapy_tpu.nii"), "rb").read()
