"""The instance-segmentation modules of the port against the JAX package.

Small seeded inputs, one module at a time:

* the native host ops (watershed, connected components, hole filling, the
  distance transform with and without ``sampling``, the union-find relabel):
  exactly equal, since both packages build the same C++ source;
* the label -> channel compiler (``labels_into_channels``) on a seeded 3D
  label volume for nine code sets: exactly equal;
* ``instance_seg_process`` fed the same prediction maps, with the
  post-processing chain's options: identical labels;
* ``matching`` and ``aggregate_matching``: equal;
* ``instance_segmentation_loss``: value within 1e-6 relative, gradients
  within 1e-5, float32;
* augmented batches from the compile cache with the repository template's
  augmentations (rotation included, so the D column is regenerated from the
  warped label column): within the tolerances that
  ``tests/test_torch_augment.py`` pins for warps;
* the watershed of a GT's own B/C/D channels recovers the instances;
* each instance mode still to port (EmbedSeg, the contrastive head) raises
  ``NotImplementedError`` naming ROADMAP item 9.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import biapy_tpu
import biapy_tpu_torch
from biapy_tpu import native as JN
from biapy_tpu.config.config import get_cfg_defaults as jax_cfg_defaults
from biapy_tpu.data import generators as JG
from biapy_tpu.data import pre_processing as JP
from biapy_tpu.data.data_manipulation import load_and_prepare_train_data as jax_train_data
from biapy_tpu.data.norm import build_norm_dict as jax_norm_dict
from biapy_tpu.data.tiff import write_tiff
from biapy_tpu.engine import metrics as JM
from biapy_tpu.engine.instance_seg import Instance_Segmentation_Workflow as JaxWF
from biapy_tpu.utils import matching as JMA
from biapy_tpu_torch import native as TN
from biapy_tpu_torch.config.config import get_cfg_defaults
from biapy_tpu_torch.data import generators as TG
from biapy_tpu_torch.data import pre_processing as TP
from biapy_tpu_torch.data.data_manipulation import load_and_prepare_train_data
from biapy_tpu_torch.data.norm import build_norm_dict
from biapy_tpu_torch.engine import metrics as TM
from biapy_tpu_torch.engine.instance_seg import Instance_Segmentation_Workflow as TorchWF
from biapy_tpu_torch.utils import matching as TMA

torch.set_num_threads(2)

# the warps' tolerances of tests/test_torch_augment.py
IMG_TOL = 2e-4
MASK_SHARE = 1e-3


def spheres(shape, n, rng, r_range=(3, 6), gap=2):
    """Seeded non-touching spheres: a uint8 image and its uint16 labels."""
    lab = np.zeros(shape, np.uint16)
    img = np.zeros(shape, np.float32)
    zz, yy, xx = np.mgrid[: shape[0], : shape[1], : shape[2]]
    centers = []
    for _ in range(400):
        if len(centers) == n:
            break
        r = int(rng.integers(*r_range))
        c = [int(rng.integers(min(r, s // 2), max(s - r, s // 2 + 1))) for s in shape]
        if any(sum((a - b) ** 2 for a, b in zip(c, o)) < (r + ro + gap) ** 2
               for *o, ro in centers):
            continue
        m = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 < r * r
        lab[m] = len(centers) + 1
        img += m * 0.7
        centers.append((*c, r))
    img += rng.normal(0, 0.08, shape)
    return (img * 200).clip(0, 255).astype(np.uint8), lab


def _labels(seed=0, shape=(12, 28, 30), n=7, gap=0):
    """A label volume whose instances may touch (gap 0), as GT often has."""
    return spheres(shape, n, np.random.default_rng(seed), gap=gap)[1]


# ---------------------------------------------------------------- native ops
def _native_case(name, mod, rng):
    m = rng.random((9, 17, 21)) > 0.45
    if name == "watershed":
        topo = rng.random(m.shape).astype(np.float32)
        markers = np.zeros(m.shape, np.int32)
        idx = rng.choice(m.size, 12, replace=False)
        markers.flat[idx] = np.arange(1, 13)
        return mod.watershed(topo, markers, m), mod.watershed(topo, markers)
    if name == "connected_components":
        return mod.connected_components(m)
    if name == "fill_holes":
        return mod.fill_holes(m), mod.fill_holes(m[0])
    if name == "edt":
        return mod.edt(m), mod.edt(m[0])
    if name == "edt_sampling":
        return mod.edt(m, sampling=(2.0, 1.0, 0.5)), mod.edt(m[0], sampling=(1.5, 1.0))
    if name == "union_find":
        edges = rng.integers(1, 30, (25, 2))
        return (mod.union_find_merge(edges, 30),)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["watershed", "connected_components", "fill_holes", "edt",
                                  "edt_sampling", "union_find"])
def test_native_ops_equal_jax(name):
    for seed in range(2):
        got = _native_case(name, TN, np.random.default_rng(seed))
        want = _native_case(name, JN, np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert type(g) is type(w)
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- compiler
CODE_SETS = {
    "BCD": (["B", "C", "D"], {}),
    "BC": (["B", "C"], {}),
    "BCM": (["B", "C", "M"], {}),
    "BP": (["B", "P"], {}),
    "FC": (["F", "C"], {"F": {"erosion": 1}, "C": {"thickness": 2}}),
    "BDc": (["B", "Dc"], {}),
    "A": (["A"], {"A": {"z_affinities": [1], "y_affinities": [1, 3], "x_affinities": [2]}}),
    "HVZ": (["H", "V", "Z"], {}),
    "BCWe": (["B", "C", "We"], {}),
}


@pytest.mark.parametrize("codes", list(CODE_SETS))
def test_labels_into_channels_equals_jax(codes):
    mode, extra = CODE_SETS[codes]
    lab = _labels(seed=1)[..., None]
    got = TP.labels_into_channels(lab, mode, extra)
    want = JP.labels_into_channels(lab, mode, extra)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_omnipose_and_embedseg_channels_raise_naming_item_9():
    # the Omnipose channels are ported (tests/test_torch_rays_flows.py holds
    # them against the JAX package); the EmbedSeg ones still raise
    lab = _labels()[..., None]
    with pytest.raises(NotImplementedError, match="item 9"):
        TP.labels_into_channels(lab, ["E"], {})


# ---------------------------------------------------------------- workflows
def _cfg(defaults, codes, extra=None, test=None):
    cfg = defaults()
    cfg.merge_from_dict({
        "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": "3D",
                    "INSTANCE_SEG": {"DATA_CHANNELS": list(codes),
                                     "DATA_CHANNELS_EXTRA_OPTS": [extra or {}]}},
        "DATA": {"PATCH_SIZE": (12, 28, 28, 1)},
        "TEST": test or {},
    })
    return cfg


def _workflows(codes, extra=None, test=None):
    """The two packages' workflows with only their channel definitions (no
    model, no data), as tests/test_instance_creation.py builds the JAX one."""
    out = []
    for cls, defaults in ((JaxWF, jax_cfg_defaults), (TorchWF, get_cfg_defaults)):
        wf = cls.__new__(cls)
        wf.cfg = _cfg(defaults, codes, extra, test)
        wf.nd = 3
        wf.verbose = False
        wf.define_activations_and_channels()
        out.append(wf)
    return out


def _prediction(lab, codes, extra, seed):
    """Prediction-like maps: the compiled channels plus smooth seeded noise,
    the binary ones in [0, 1]."""
    from scipy import ndimage

    chans = JP.labels_into_channels(lab[..., None], codes, extra)
    rng = np.random.default_rng(seed)
    noise = ndimage.gaussian_filter(rng.normal(0, 0.6, chans.shape), (1, 1, 1, 0))
    pred = (chans + noise).astype(np.float32)
    flat = [c for c in codes for _ in range(JP.channels_per_code(c, extra, 3))]
    for k, c in enumerate(flat):
        if c in ("B", "F", "P", "C", "T", "M", "A"):
            pred[..., k] = np.clip(pred[..., k], 0, 1)
        elif c == "D":
            pred[..., k] = np.clip(pred[..., k], -1, 1)
    return pred


PP = {
    "BCD": (["B", "C", "D"], {}, {}),
    "BCD-refinement": (["B", "C", "D"], {}, {"INSTANCE_REFINEMENT": {
        "ENABLE": True, "OPERATIONS": ["fill_holes", "dilation", "remove_small_objects"],
        "VALUES": ["none", 3, 20]}}),
    "FP-large-blobs": (["F", "P"], {}, {"REPARE_LARGE_BLOBS_SIZE": 150}),
    "BCM-voronoi": (["B", "C", "M"], {}, {"VORONOI_ON_MASK": True, "VORONOI_TH": 0.4}),
    "FC-properties": (["F", "C"], {}, {"MEASURE_PROPERTIES": {
        "ENABLE": True, "REMOVE_BY_PROPERTIES": {
            "ENABLE": True, "PROPS": [["size"], ["sphericity"]], "VALUES": [[60], [0.5]],
            "SIGNS": [["lt"], ["lt"]]}}}),
    "BDc-clear-border": (["B", "Dc"], {}, {"INSTANCE_REFINEMENT": {
        "ENABLE": True, "OPERATIONS": ["clear_border"], "VALUES": ["none"]}}),
    "A": (["A"], {}, {}),
}


@pytest.mark.parametrize("case", list(PP))
def test_instance_creation_equals_jax(case):
    codes, extra, pp = PP[case]
    jwf, twf = _workflows(codes, extra, {"POST_PROCESSING": pp})
    lab = _labels(seed=2, n=9)
    for seed in range(2):
        pred = _prediction(lab, codes, extra, seed)
        got, want = twf.instance_seg_process(pred), jwf.instance_seg_process(pred)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert got.max() > 0


def test_watershed_oracle_recovers_spheres():
    """The watershed of a GT's own B/C/D channels (the template's codes)
    recovers non-touching spheres: F1 > 0.9 at IoU 0.5."""
    (_, twf) = _workflows(["B", "C", "D"])
    lab = spheres((24, 48, 48), 8, np.random.default_rng(3), r_range=(4, 7))[1].astype(np.int32)
    chans = TP.labels_into_channels(lab[..., None], ["B", "C", "D"])
    inst = twf.instance_seg_process(chans)
    stats = TMA.matching(lab, inst, thresh=[0.5])[0]
    assert stats["f1"] > 0.9, stats


def test_matching_and_aggregate_equal_jax():
    gt = _labels(seed=4, n=8).astype(np.int32)
    per_image = {"jax": [], "torch": []}
    for seed in range(3):
        pred = np.roll(gt, seed, axis=2)
        pred[pred == 3] = 0
        if seed:
            pred[_labels(seed=5 + seed, n=3) > 0] = 40 + seed
        for side, mod in (("jax", JMA), ("torch", TMA)):
            per_image[side].append(mod.matching(gt, pred, thresh=[0.3, 0.5, 0.75],
                                                report_matches=True))
        assert per_image["torch"][-1] == per_image["jax"][-1]
    for by_image in (True, False):
        assert (TMA.aggregate_matching(per_image["torch"], by_image=by_image)
                == JMA.aggregate_matching(per_image["jax"], by_image=by_image))


# ---------------------------------------------------------------- loss
LOSSES = {
    "template": (["B", "C", "D"], None, {}, True),
    "masked-distances": (["B", "Dc", "Db", "H"], ["bce", "l1", "mse", "mse"],
                         {"Dc": True, "Db": True, "H": True}, False),
    "rebalance-border-weight": (["F", "C", "D", "We"], ["bce", "bce", "l1", "bce"],
                                {}, True),
    "affinities-no-binary": (["A", "Dc"], ["bce", "l1"], {"Dc": True}, True),
}


@pytest.mark.parametrize("case", list(LOSSES))
def test_instance_loss_and_gradients_equal_jax(case):
    """Float32, channels last: the loss within 1e-6 relative, its gradient
    with respect to the logits within 1e-5."""
    codes, losses, masks, rebalance = LOSSES[case]
    extra = {}
    widths = [JP.channels_per_code(c, extra, 3) for c in codes]
    losses = losses or ["bce", "bce", "l1"]
    weights = [1.0, 0.5, 2.0, 1.0][: len(codes)]
    lab = np.stack([_labels(seed=s, shape=(6, 14, 16), n=4) for s in (6, 7)])
    y = np.stack([JP.labels_into_channels(l[..., None], codes, extra) for l in lab])
    n_pred = sum(w for c, w in zip(codes, widths) if c != "We")
    logits = np.random.default_rng(8).normal(0, 1.5, y.shape[:-1] + (n_pred,)).astype(np.float32)
    kw = dict(out_channels=codes, losses_to_use=losses, channel_weights=weights,
              channels_per_output=widths, mask_distances=masks,
              class_rebalance_within_channels=rebalance)
    jl = JM.instance_segmentation_loss(**kw)
    tl = TM.instance_segmentation_loss(**kw)
    jv, jg = jax.value_and_grad(lambda p: jl(p, jnp.asarray(y)))(jnp.asarray(logits))
    tp = torch.tensor(logits, requires_grad=True)
    tv = tl(tp, torch.from_numpy(y))
    tv.backward()
    assert abs(tv.item() - float(jv)) <= 1e-6 * abs(float(jv)), (tv.item(), float(jv))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-5)


# ---------------------------------------------------------------- batches
def _write_dataset(root, n=2, shape=(14, 40, 40), seed=9):
    rng = np.random.default_rng(seed)
    for d in ("x", "y"):
        os.makedirs(f"{root}/train/{d}")
    for i in range(n):
        img, lab = spheres(shape, 6, rng)
        write_tiff(f"{root}/train/x/{i:03d}.tif", img)
        write_tiff(f"{root}/train/y/{i:03d}.tif", lab)


def test_augmented_batches_from_the_cache_match_jax(tmp_path):
    """The template's augmentations (RANDOM_ROT, VFLIP, HFLIP, ZFLIP) on
    samples from the compile cache: images within the warps' IMG_TOL, the
    B/C/D targets with at most MASK_SHARE of their voxels off, and the label
    column dropped. Rotated samples recompile their D column from the warped
    labels (the port's regeneration is counted)."""
    root = str(tmp_path)
    _write_dataset(root)
    cfg = {
        "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": "3D",
                    "INSTANCE_SEG": {"DATA_CHANNELS": ["B", "C", "D"]}},
        "SYSTEM": {"NUM_WORKERS": 0, "SEED": 0},
        "DATA": {"PATCH_SIZE": [8, 24, 24, 1],
                 "TRAIN": {"PATH": f"{root}/train/x", "GT_PATH": f"{root}/train/y",
                           "IN_MEMORY": True},
                 "VAL": {"FROM_TRAIN": True, "SPLIT_TRAIN": 0.25}},
        "AUGMENTOR": {"ENABLE": True, "RANDOM_ROT": True, "VFLIP": True, "HFLIP": True,
                      "ZFLIP": True},
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [4, 8], "Z_DOWN": [1]},
        "TRAIN": {"ENABLE": True},
        "TEST": {"ENABLE": False},
    }
    sides = {}
    for side, pkg, data_fn, gen, norm in (
            ("jax", biapy_tpu, jax_train_data, JG, jax_norm_dict),
            ("torch", biapy_tpu_torch, load_and_prepare_train_data, TG, build_norm_dict)):
        kw = {"device": "cpu"} if side == "torch" else {}
        job = pkg.BiaPy(copy.deepcopy(cfg), result_dir=f"{root}/{side}", name="aug",
                        silent=True, **kw)
        job._build_workflow()
        wf = job.workflow
        wf._prepare_instance_data("TRAIN")  # the JAX side writes, the port reuses
        c = wf.cfg
        tr, _ = data_fn(c, norm(c))
        ds = gen.PairDataset(tr, c, norm(c), augment=True, channel_handler=wf.aug_channel_handler)
        sides[side] = (ds, wf.aug_channel_handler)
    regens = []
    h = sides["torch"][1]
    plain_regen = h.regen
    h.regen = lambda mask: (regens.append(1), plain_regen(mask))[1]
    n = len(sides["torch"][0])
    assert n == len(sides["jax"][0]) > 1
    for i in range(2 * n):
        got = sides["torch"][0].get(i % n, np.random.default_rng(i))
        want = sides["jax"][0].get(i % n, np.random.default_rng(i))
        assert got["y"].shape == want["y"].shape == (8, 24, 24, 3)
        assert float(np.abs(got["x"] - want["x"]).max()) <= IMG_TOL
        off = np.any(np.abs(got["y"] - want["y"]) > 1e-6, axis=-1)
        assert np.count_nonzero(off) <= MASK_SHARE * off.size
    assert regens, "no sample was rotated"


# ---------------------------------------------------------------- not ported
UNPORTED = {
    "embedseg": {"PROBLEM": {"INSTANCE_SEG": {"DATA_CHANNELS": ["E_offset", "E_sigma",
                                                                 "E_seediness"]}}},
    "contrast": {"LOSS": {"CONTRAST": {"ENABLE": True}}},
}


@pytest.mark.parametrize("mode", list(UNPORTED))
def test_unported_instance_modes_raise_naming_item_9(mode):
    cfg = _cfg(get_cfg_defaults, ["B", "C", "D"])
    cfg.merge_from_dict(UNPORTED[mode])
    wf = TorchWF.__new__(TorchWF)
    wf.cfg = cfg
    wf.nd = 3
    with pytest.raises(NotImplementedError, match="ROADMAP: queue 1 item 9"):
        wf.define_activations_and_channels()
