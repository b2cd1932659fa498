"""The restoration workflows' parts, the port against the JAX package.

* Every restoration loss and metric on the same seeded float32 batches:
  SSIM within 1e-5 (float32 Gaussian filtering summed in other orders),
  including an axis shorter than the 11-tap filter's 5-voxel pad, where
  numpy's ``symmetric`` padding reflects more than once; the others within
  1e-6. ``restoration_test_metrics`` likewise.
* ``n2v_manipulate`` for every manipulator, with and without the struct
  mask, and ``crappify``: exactly equal for the same rng.
* The super-resolution ``pre`` / ``post`` models and separated decoders
  (with and without divided feature maps, with and without LARGER_IO)
  from the same Flax variables through the weight bridge: forward within
  1e-5 in float32.
* ``PairDataset`` with ``y_upscaling``, ``gt_as_image`` and the workflows'
  ``target_fn`` (N2V, crappify, image-to-image): the same samples as the
  JAX package's, in random-crop and patch-grid modes, CutMix included.
* ``scan_multiple_raw_one_target``, and an image-to-image dataset built
  with it.
* ``chip_smoke.py``'s phase 3 rows for the restoration templates: the
  pools, zd2s and zcats each template's model runs at its patch and batch.
* A fault of the reference, kept for parity: with RANDOM_ROT the SR target
  comes back cropped to the LR size in both packages.
* The parts that are not ported name their ROADMAP item.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu.data import data_manipulation as jdm
from biapy_tpu.data import generators as jgen
from biapy_tpu.data.tiff import write_tiff
from biapy_tpu.engine import denoising as jden
from biapy_tpu.engine import metrics as JM
from biapy_tpu.engine import self_supervised as jssl
from biapy_tpu.models.unet_family import UNetFamily as FlaxUNet
from biapy_tpu_torch.data import data_manipulation as tdm
from biapy_tpu_torch.data import generators as tgen
from biapy_tpu_torch.engine import denoising as tden
from biapy_tpu_torch.engine import metrics as TM
from biapy_tpu_torch.engine import self_supervised as tssl
from biapy_tpu_torch.models.flax_import import load_flax_variables
from biapy_tpu_torch.models.unet_family import UNetFamily

from test_torch_model import _random_variables
from test_torch_restoration_job import job_cfg, smooth_volume

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------
# losses and metrics
# --------------------------------------------------------------------------
def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, np.float32)
    b = (a + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    return a, b


# (2, 3, 17, 9, 2): z of 3 is shorter than the 5-voxel pad
SHAPES = [(2, 8, 20, 24, 1), (1, 3, 17, 9, 2), (2, 12, 14, 3)]
LOSSES = ["mse_metric", "mae_metric", "psnr_metric", "ssim_metric", "ssim_loss",
          "w_mae_ssim_loss", "w_mse_ssim_loss"]


@pytest.mark.parametrize("shape", SHAPES, ids=["3d", "3d-short-z", "2d"])
@pytest.mark.parametrize("name", LOSSES)
def test_restoration_losses_and_metrics_match_jax(name, shape):
    a, b = _pair(shape, 0)
    j = float(getattr(JM, name)(jnp.asarray(a), jnp.asarray(b)))
    t = float(getattr(TM, name)(torch.from_numpy(a), torch.from_numpy(b)))
    tol = 1e-5 if "ssim" in name else 1e-6
    assert abs(t - j) <= tol * max(1.0, abs(j)), (t, j)


def test_ssim_data_range_and_n2v_loss_match_jax():
    a, b = _pair((2, 6, 16, 16, 2), 1)
    j = float(JM.ssim_metric(jnp.asarray(a), jnp.asarray(b), data_range=3.7))
    t = float(TM.ssim_metric(torch.from_numpy(a), torch.from_numpy(b), data_range=3.7))
    assert abs(t - j) <= 1e-5
    m = (np.random.default_rng(2).random(a.shape) < 0.1).astype(np.float32)
    j = float(JM.n2v_loss_mse(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m)))
    t = float(TM.n2v_loss_mse(*(torch.from_numpy(v) for v in (a, b, m))))
    assert abs(t - j) <= 1e-6 * max(1.0, j)


def test_ssim_gradient_matches_jax():
    a, b = _pair((1, 6, 16, 16, 1), 3)
    gj = np.asarray(jax.grad(lambda p: JM.w_mae_ssim_loss(p, jnp.asarray(b)))(jnp.asarray(a)))
    pt = torch.from_numpy(a).requires_grad_(True)
    TM.w_mae_ssim_loss(pt, torch.from_numpy(b)).backward()
    np.testing.assert_allclose(pt.grad.numpy(), gj, atol=1e-7, rtol=1e-4)


@pytest.mark.parametrize("names", [[], ["psnr", "ssim"], ["mae", "mse"]])
def test_restoration_test_metrics_match_jax(names):
    a, b = _pair((5, 30, 26, 1), 4)
    j = JM.restoration_test_metrics(a, b * 3.0, names)
    t = TM.restoration_test_metrics(a, b * 3.0, names)
    assert sorted(t) == sorted(j)
    for k in t:
        assert abs(t[k] - j[k]) <= (1e-5 if k == "ssim" else 1e-6) * max(1.0, abs(j[k])), k
    assert sorted(TM.build_restoration_train_metrics(names)) == sorted(
        JM.build_restoration_train_metrics(names))


# --------------------------------------------------------------------------
# the loader's target functions
# --------------------------------------------------------------------------
MANIPULATORS = ["uniform_withCP", "uniform_withoutCP", "normal_withoutCP", "normal_additive",
                "normal_fitted", "identity", "mean", "median"]


@pytest.mark.parametrize("struct_mask", [False, True])
@pytest.mark.parametrize("manipulator", MANIPULATORS)
def test_n2v_manipulate_equals_jax(manipulator, struct_mask):
    img = np.random.default_rng(5).standard_normal((6, 24, 20, 2)).astype(np.float32)
    out = [f(img, np.random.default_rng(9), perc_pix=3.0, manipulator=manipulator, radius=2,
             struct_mask=struct_mask) for f in (jden.n2v_manipulate, tden.n2v_manipulate)]
    for j, t in zip(*out):
        np.testing.assert_array_equal(t, j)
    assert out[1][2].sum() > 0


@pytest.mark.parametrize("factor,noise", [(4, 0.2), (2, 0.0), (6, 0.5)])
def test_crappify_equals_jax(factor, noise):
    img = np.random.default_rng(6).random((10, 28, 24, 1)).astype(np.float32)
    j = jssl.crappify(img, factor, noise, np.random.default_rng(7))
    t = tssl.crappify(img, factor, noise, np.random.default_rng(7))
    np.testing.assert_array_equal(t, j)


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------
MODELS = {
    "sr-pre": dict(upsampling_factor=(1, 2, 2), upsampling_position="pre"),
    "sr-post": dict(upsampling_factor=(1, 2, 2), upsampling_position="post"),
    "sr-pre-larger-io": dict(upsampling_factor=(2, 2, 2), upsampling_position="pre",
                             larger_io=True),
    "sr-post-larger-io": dict(upsampling_factor=(1, 2, 2), upsampling_position="post",
                              larger_io=True),
    "two-decoders": dict(output_channels=(1, 2), separated_decoders=True),
    "two-decoders-divided": dict(output_channels=(1, 2), separated_decoders=True,
                                 divide_decoder_feature_maps=True, larger_io=True),
}


@pytest.mark.parametrize("variant", ["unet", "resunet"])
@pytest.mark.parametrize("case", sorted(MODELS))
def test_sr_and_separated_decoder_models_match_flax(case, variant):
    rng = np.random.default_rng(0)
    kw = dict(variant=variant, ndim=3, feature_maps=(4, 8), normalization="bn", z_down=(2,),
              yx_down=(2,), conv_layers=(2, 2), isotropy=(True,), larger_io=False,
              activation="elu", output_channels=(1,))
    kw.update(MODELS[case])
    flax_model = FlaxUNet(**kw, drop_values=(0.0, 0.0),
                          output_channel_info=tuple(f"head{i}" for i in
                                                    range(len(kw["output_channels"]))))
    x = rng.standard_normal((2, 8, 16, 16, 1)).astype(np.float32)
    params, stats = _random_variables(lambda k, a: flax_model.init(k, a, train=False),
                                      x.shape, rng)
    ref = np.asarray(flax_model.apply({"params": params, "batch_stats": stats},
                                      jnp.asarray(x), train=False))
    model = UNetFamily(**kw).eval()
    load_flax_variables(model, params, stats)  # every leaf, by Flax's names
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("restoration_data"))
    for d in ("lr", "hr", "src", "tgt", "noisy"):
        os.makedirs(f"{root}/{d}")
    for i in range(2):
        hr = smooth_volume((8, 48, 40), 70 + i)
        write_tiff(f"{root}/hr/{i}.tif", hr)
        write_tiff(f"{root}/lr/{i}.tif", hr[:, ::2, ::2])
        write_tiff(f"{root}/src/{i}.tif", smooth_volume((8, 36, 40), 80 + i))
        write_tiff(f"{root}/tgt/{i}.tif", 255 - smooth_volume((8, 36, 40), 80 + i, noise=0))
        write_tiff(f"{root}/noisy/{i}.tif", smooth_volume((8, 36, 40), 90 + i))
    # the multiple-raw-one-target layout: per scene several raws, one target
    for scene, n in (("s1", 2), ("s2", 3)):
        for d in ("mx", "my"):
            os.makedirs(f"{root}/{d}/{scene}")
        for k in range(n):
            write_tiff(f"{root}/mx/{scene}/{k}.tif", smooth_volume((8, 32, 32), 100 + k))
        write_tiff(f"{root}/my/{scene}/t.tif", smooth_volume((8, 32, 32), 110))
    return root


def _dataset_cfg(root, kind, random_crop):
    over = {"DATA": {"PATCH_SIZE": [8, 16, 16, 1], "TRAIN": {"EXTRACT_RANDOM_PATCH": random_crop}},
            "AUGMENTOR": {"ZFLIP": True}}
    if kind == "sr":
        over["PROBLEM"] = {"TYPE": "SUPER_RESOLUTION", "NDIM": "3D",
                           "SUPER_RESOLUTION": {"UPSCALING": [1, 2, 2]}}
        over["DATA"].update(NORMALIZATION={"TYPE": "div"},
                            TRAIN={"PATH": f"{root}/lr", "GT_PATH": f"{root}/hr",
                                   "EXTRACT_RANDOM_PATCH": random_crop})
    elif kind == "i2i":
        over["PROBLEM"] = {"TYPE": "IMAGE_TO_IMAGE", "NDIM": "3D"}
        over["DATA"].update(NORMALIZATION={"TYPE": "scale_range"},
                            TRAIN={"PATH": f"{root}/src", "GT_PATH": f"{root}/tgt",
                                   "EXTRACT_RANDOM_PATCH": random_crop})
        over["AUGMENTOR"].update(CUTMIX=True, CUTMIX_PROB=0.7)
    elif kind == "n2v":
        over["PROBLEM"] = {"TYPE": "DENOISING", "NDIM": "3D",
                           "DENOISING": {"N2V_PERC_PIX": 3.0, "N2V_STRUCTMASK": True}}
        over["DATA"]["TRAIN"].update(PATH=f"{root}/noisy")
    else:
        over["PROBLEM"] = {"TYPE": "SELF_SUPERVISED", "NDIM": "3D",
                           "SELF_SUPERVISED": {"PRETEXT_TASK": "crappify"}}
        over["DATA"]["TRAIN"].update(PATH=f"{root}/noisy")
    cfg = job_cfg(root, over)
    cfg["TEST"]["ENABLE"] = False
    return cfg


def _samples(pkg, cfg, result_dir, n=6):
    """``n`` training samples of ``cfg``'s workflow, drawn from seeded rngs."""
    if pkg == "jax":
        job = biapy_tpu.BiaPy(cfg, result_dir=result_dir, name="d", silent=True)
        dm, gen = jdm, jgen
    else:
        job = biapy_tpu_torch.BiaPy(cfg, result_dir=result_dir, name="d", silent=True,
                                    device="cpu")
        dm, gen = tdm, tgen
    job._build_workflow()
    wf = job.workflow
    # the same flag under the JAX package's name and the port's
    gt = {"gt_is_mask": not wf.gt_as_image} if pkg == "jax" else {"gt_as_image": wf.gt_as_image}
    train, _ = dm.load_and_prepare_train_data(wf.cfg, wf.norm_spec, wf.y_upscaling, **gt)
    ds = gen.PairDataset(train, wf.cfg, wf.norm_spec, augment=True,
                         random_crop=bool(wf.cfg.DATA.TRAIN.EXTRACT_RANDOM_PATCH),
                         target_fn=wf.prepare_targets_fn(), y_upscaling=wf.y_upscaling,
                         gt_as_image=wf.gt_as_image)
    return [ds.get(i % len(ds), np.random.default_rng(40 + i)) for i in range(n)]


@pytest.mark.parametrize("random_crop", [True, False], ids=["random-crop", "grid"])
@pytest.mark.parametrize("kind", ["sr", "i2i", "n2v", "crappify"])
def test_pair_dataset_samples_equal_jax(data_root, tmp_path, kind, random_crop):
    cfg = _dataset_cfg(data_root, kind, random_crop)
    j = _samples("jax", cfg, str(tmp_path / "j"))
    t = _samples("torch", cfg, str(tmp_path / "t"))
    for sj, st in zip(j, t):
        assert sorted(st) == sorted(sj) == ["x", "y"]
        for k in sj:
            np.testing.assert_array_equal(st[k], sj[k])
    x, y = t[0]["x"], t[0]["y"]
    want = {"sr": (8, 32, 32, 1), "n2v": (8, 16, 16, 2)}.get(kind, (8, 16, 16, 1))
    assert x.shape == (8, 16, 16, 1) and y.shape == want
    if kind in ("sr", "i2i"):
        assert y.max() <= 1.0 + 1e-6  # value-normalised (div, scale_range), not binarised
        assert len(np.unique(y)) > 2


def test_scan_multiple_raw_one_target_equals_jax(data_root):
    x, y = f"{data_root}/mx", f"{data_root}/my"
    t = tdm.scan_multiple_raw_one_target(x, y)
    assert t == jdm.scan_multiple_raw_one_target(x, y)
    assert len(t) == 5 and len({p for _, p in t}) == 2
    assert tdm.scan_multiple_raw_one_target(x, None) == jdm.scan_multiple_raw_one_target(x, None)
    with pytest.raises(FileNotFoundError):
        tdm.scan_multiple_raw_one_target(f"{data_root}/lr", None)


def test_multiple_raw_one_target_dataset_equals_jax(data_root, tmp_path):
    cfg = _dataset_cfg(data_root, "i2i", True)
    cfg["PROBLEM"]["IMAGE_TO_IMAGE"] = {"MULTIPLE_RAW_ONE_TARGET_LOADER": True}
    cfg["DATA"]["TRAIN"].update(PATH=f"{data_root}/mx", GT_PATH=f"{data_root}/my")
    cfg["AUGMENTOR"]["CUTMIX"] = False
    j = _samples("jax", cfg, str(tmp_path / "j"), n=5)
    t = _samples("torch", cfg, str(tmp_path / "t"), n=5)
    for sj, st in zip(j, t):
        for k in sj:
            np.testing.assert_array_equal(st[k], sj[k])


def test_sr_rotation_crops_the_target_in_both_packages(data_root, tmp_path):
    """A fault of the reference, kept for parity: ``affine_2d`` warps the GT
    with the input's matrix to the input's size, so with RANDOM_ROT an SR
    target twice the input in y and x comes back at the LR size."""
    cfg = _dataset_cfg(data_root, "sr", True)
    cfg["AUGMENTOR"] = {"ENABLE": True, "RANDOM_ROT": True, "RANDOM_ROT_PROB": 1.0}
    for pkg in ("jax", "torch"):
        for s in _samples(pkg, cfg, str(tmp_path / pkg), n=2):
            assert s["x"].shape == s["y"].shape == (8, 16, 16, 1), pkg


# --------------------------------------------------------------------------
# the card run's kernel rows
# --------------------------------------------------------------------------
@pytest.mark.parametrize("key,template", [
    ("denoising", "templates/denoising/3d_denoising.yaml"),
    ("sr", "templates/super-resolution/3d_super-resolution.yaml"),
    ("i2i", "templates/image-to-image/3d_image-to-image.yaml"),
])
def test_chip_smoke_restoration_rows_are_the_templates_shapes(tmp_path, monkeypatch, key,
                                                             template):
    """``chip_smoke.py`` phase 3 holds each kernel against its plain version
    at the restoration templates' shapes: its rows must be the ones the
    template's model gives at its batch and patch (one forward at batch 1
    here, the rows scale with the batch)."""
    import yaml

    from biapy_tpu_torch.models.blocks import Conv
    from biapy_tpu_torch.ops.kernels import shuffle

    sys.path.insert(0, REPO)
    import chip_smoke

    with open(os.path.join(REPO, template)) as f:
        raw = yaml.safe_load(f)
    job = biapy_tpu_torch.BiaPy(raw, result_dir=str(tmp_path), name="t", silent=True,
                                check_data_paths=False, device="cpu")
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    cfg = wf.cfg
    d, h, w = (int(v) for v in cfg.DATA.PATCH_SIZE[:3])
    assert chip_smoke.RESTORATION_ROWS[key] == chip_smoke._unet_rows(int(cfg.TRAIN.BATCH_SIZE),
                                                                     d, h, w)
    seen = {"pool": [], "zd2s": [], "zcat": []}
    pool_plain, zd2s_plain = shuffle.pool_max_folded_plain, shuffle.zd2s_plain
    monkeypatch.setattr(shuffle, "pool_max_folded_plain", lambda x, win: (
        seen["pool"].append((tuple(x.shape), tuple(win))), pool_plain(x, win))[1])
    monkeypatch.setattr(shuffle, "zd2s_plain", lambda x, sz: (
        seen["zd2s"].append((tuple(x.shape), sz)), zd2s_plain(x, sz))[1])
    for m in wf.model.modules():
        if isinstance(m, Conv) and tuple(m.kernel.shape[:3]) == (3, 3, 3):
            # a weight gradient takes one zcat of the conv's input, folded
            m.register_forward_hook(lambda m, args, out: seen["zcat"].append(
                ((args[0].shape[0] * args[0].shape[1],) + tuple(args[0].shape[2:]), 3,
                 args[0].shape[1])))
    with torch.no_grad():
        wf.model(torch.zeros((1, d, h, w, 1)))
    assert (seen["pool"], seen["zd2s"], seen["zcat"]) == tuple(
        list(rows) for rows in chip_smoke._unet_rows(1, d, h, w))


# --------------------------------------------------------------------------
# what is not ported
# --------------------------------------------------------------------------
@pytest.mark.parametrize("over,item", [
    # nafnet and the perceptual metrics are 2D-only in the configuration
    # check: the workflow refuses them before the model is built
    ({"PROBLEM": {"TYPE": "DENOISING", "NDIM": "2D", "DENOISING": {"LOAD_GT_DATA": True}},
      "DATA": {"PATCH_SIZE": [64, 64, 1], "TRAIN": {"GT_PATH": "gt"}},
      "MODEL": {"ARCHITECTURE": "nafnet"}}, "9.8, the GAN slice"),
    ({"PROBLEM": {"TYPE": "SELF_SUPERVISED", "NDIM": "3D",
                  "SELF_SUPERVISED": {"PRETEXT_TASK": "masking"}},
      "DATA": {"PATCH_SIZE": [16, 16, 16, 1]}, "MODEL": {"ARCHITECTURE": "mae"}}, "item 10"),
    ({"PROBLEM": {"TYPE": "IMAGE_TO_IMAGE", "NDIM": "2D"}, "DATA": {"PATCH_SIZE": [64, 64, 1]},
      "TEST": {"METRICS": ["psnr", "lpips"], "METRIC_WEIGHTS": {"LPIPS": __file__}}},
     "9.8, the GAN slice"),
    # 2D runs the U-Net family, the super-resolution family, simple_cnn, vit
    # and efficientnet_b0-b7 (the ids "sr-rcan-2d" and
    # "classification-efficientnet" date from before rcan and
    # efficientnet_b0 were ported: they now hold a super-resolution model
    # and an EfficientNet that are not, multiresunet and efficientnet_v2_s);
    # a stratified k-fold asked of the data layer directly raises too (the
    # workflow splits its own data, unstratified, as the JAX workflow does)
    ({"PROBLEM": {"TYPE": "SUPER_RESOLUTION", "NDIM": "2D",
                  "SUPER_RESOLUTION": {"UPSCALING": [2, 2]}},
      "DATA": {"PATCH_SIZE": [64, 64, 1], "NORMALIZATION": {"TYPE": "div"}},
      "MODEL": {"ARCHITECTURE": "multiresunet"}}, "item 10, rest of the zoo"),
    ({"PROBLEM": {"TYPE": "CLASSIFICATION", "NDIM": "2D"}, "DATA": {"PATCH_SIZE": [64, 64, 3]},
      "MODEL": {"ARCHITECTURE": "efficientnet_v2_s", "SOURCE": "torchvision",
                "TORCHVISION_MODEL_NAME": "efficientnet_v2_s", "TORCHVISION_WEIGHTS": __file__}},
     "item 10, rest of the zoo"),
    ({"PROBLEM": {"TYPE": "CLASSIFICATION", "NDIM": "3D"},
      "DATA": {"VAL": {"FROM_TRAIN": True, "CROSS_VAL": True}},
      "MODEL": {"ARCHITECTURE": "simple_cnn"}}, "classification k-fold is never stratified"),
], ids=["n2v-gan", "ssl-masking", "perceptual-metrics", "sr-rcan-2d",
        "classification-efficientnet", "classification-stratified-kfold"])
def test_unported_restoration_parts_name_the_roadmap(tmp_path, over, item):
    cfg = {"DATA": {"PATCH_SIZE": [8, 16, 16, 1]}, "TRAIN": {"ENABLE": True}}
    for sect, vals in over.items():
        cfg.setdefault(sect, {}).update(vals)
    kfold = cfg["DATA"].get("VAL", {}).get("CROSS_VAL", False)
    if kfold:
        os.makedirs(tmp_path / "train")
        write_tiff(str(tmp_path / "train" / "a.tif"), np.zeros((8, 16, 16), np.uint8))
        cfg["DATA"]["TRAIN"] = {"PATH": str(tmp_path / "train")}
    job = biapy_tpu_torch.BiaPy(cfg, result_dir=str(tmp_path), name="t", silent=True,
                                check_data_paths=False, device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        if kfold:
            tdm.load_and_prepare_train_data(job.cfg)
        elif cfg["PROBLEM"]["TYPE"] == "SUPER_RESOLUTION":
            # super-resolution reads its data before it builds the model:
            # the model alone
            job._build_workflow()
            job.workflow.prepare_model()
        else:
            job.train()
