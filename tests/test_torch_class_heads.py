"""The class heads (DATA.N_CLASSES > 2) of the instance and detection
workflows, the port against the JAX package.

* The U-Net family with a ``"class"`` head, in 2D and 3D, one decoder or
  one per head, on the same seeded weights carried across by name (Flax's
  auto-names of the second head's ``Conv_<j>``): the dict forward within
  1e-5.
* The losses with their class terms (the instance class CE on the
  instances, dict or flat; the detection CE on the point blobs, with manual
  class weights): values within 1e-6 relative, gradients within 1e-5.
* The host parts, exactly equal: the point masks' class channel, the CSVs'
  class column, the close-point removal's kept indices, the detection
  watershed with classes and a growth mask, the per-instance majority vote
  and the per-point classes.

Whole jobs with class heads: ``tests/test_torch_class_heads_job.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biapy_tpu.config.config import get_cfg_defaults as jax_cfg_defaults
from biapy_tpu.data import post_processing as JPP
from biapy_tpu.data import pre_processing as JP
from biapy_tpu.engine import detection as JD
from biapy_tpu.engine import metrics as JM
from biapy_tpu.engine.instance_seg import Instance_Segmentation_Workflow as JaxWF
from biapy_tpu.models.unet_family import UNetFamily as FlaxUNet
from biapy_tpu_torch.config.config import get_cfg_defaults
from biapy_tpu_torch.data import post_processing as TPP
from biapy_tpu_torch.data import pre_processing as TP
from biapy_tpu_torch.engine import detection as TD
from biapy_tpu_torch.engine import metrics as TM
from biapy_tpu_torch.engine.instance_seg import Instance_Segmentation_Workflow as TorchWF
from biapy_tpu_torch.models.flax_import import load_flax_variables
from biapy_tpu_torch.models.unet_family import UNetFamily

from test_torch_2d_job import disks
from test_torch_detection import _write_csv, blobs
from test_torch_instance import spheres
from test_torch_model import _random_variables

torch.set_num_threads(2)

N_CLASSES = 3


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- the model
HEADS = {"instance": ((2, N_CLASSES), ("F+C", "class")),
         "detection": ((1, N_CLASSES), ("points", "class"))}


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("kind,separated", [("instance", False), ("detection", True)])
def test_dict_forward_matches_flax(ndim, kind, separated):
    rng = np.random.default_rng(ndim)
    chans, info = HEADS[kind]
    kw = dict(variant="resunet", ndim=ndim, feature_maps=(4, 8), normalization="bn",
              z_down=(1,), yx_down=(2,), conv_layers=(2, 2), isotropy=(True,),
              larger_io=False, activation="elu", output_channels=chans,
              output_channel_info=info, separated_decoders=separated)
    flax_model = FlaxUNet(**kw, drop_values=(0.0, 0.0))
    shape = (2, 16, 16, 1) if ndim == 2 else (2, 6, 16, 16, 1)
    x = rng.standard_normal(shape).astype(np.float32)
    params, stats = _random_variables(lambda k, a: flax_model.init(k, a, train=False),
                                      x.shape, rng)
    ref = jax.jit(lambda v, a: flax_model.apply(v, a, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    model = UNetFamily(**kw, in_channels=1, gen=torch.Generator().manual_seed(0)).eval()
    load_flax_variables(model, params, stats)  # every name and shape, both heads
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert sorted(got) == sorted(ref) == ["class", "pred"]
    assert tuple(got["class"].shape) == shape[:-1] + (N_CLASSES,)
    for k in ("pred", "class"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5)
    # one head: the flat tensor, as before
    single = dict(kw, output_channels=chans[:1], output_channel_info=info[:1],
                  separated_decoders=False)
    assert isinstance(UNetFamily(**single, in_channels=1)(torch.from_numpy(x)), torch.Tensor)


# ---------------------------------------------------------------- the losses
def _class_batch(ndim, seed):
    """Two samples of F/C channels with their class map (0 off the
    instances) as the last GT channel, and seeded logits."""
    rng = np.random.default_rng(seed)
    if ndim == 3:
        labs = [spheres((6, 14, 16), 4, rng)[1] for _ in range(2)]
    else:
        labs = [disks((20, 22), 4, rng)[1] for _ in range(2)]
    ys = []
    for lab in labs:
        cls = np.zeros(lab.shape, np.float32)
        for i in range(1, int(lab.max()) + 1):
            cls[lab == i] = 1 + (i % 2)
        chans = JP.labels_into_channels(lab[..., None], ["F", "C"], {})
        ys.append(np.concatenate([chans, cls[..., None]], axis=-1))
    y = np.stack(ys).astype(np.float32)
    pred = rng.normal(0, 1.5, y.shape[:-1] + (2,)).astype(np.float32)
    cls_logits = rng.normal(0, 1.5, y.shape[:-1] + (N_CLASSES,)).astype(np.float32)
    return y, pred, cls_logits


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("layout", ["dict", "flat"])
def test_instance_class_loss_and_gradients_equal_jax(ndim, layout):
    y, pred, cls_logits = _class_batch(ndim, 10 + ndim)
    kw = dict(out_channels=["F", "C"], losses_to_use=["bce", "bce"], channel_weights=[1.0, 0.5],
              channels_per_output=[1, 1], n_classes=N_CLASSES, class_channel_weight=0.3)
    jl, tl = JM.instance_segmentation_loss(**kw), TM.instance_segmentation_loss(**kw)
    if layout == "dict":
        jv, jg = jax.value_and_grad(lambda p, c: jl({"pred": p, "class": c}, jnp.asarray(y)),
                                    argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(cls_logits))
        tp, tc = (torch.tensor(a, requires_grad=True) for a in (pred, cls_logits))
        tv = tl({"pred": tp, "class": tc}, torch.from_numpy(y))
    else:
        flat = np.concatenate([pred, cls_logits], axis=-1)
        jv, jg = jax.value_and_grad(lambda p: jl(p, jnp.asarray(y)))(jnp.asarray(flat))
        jg = (jg,)
        tp = torch.tensor(flat, requires_grad=True)
        tc = None
        tv = tl(tp, torch.from_numpy(y))
    tv.backward()
    assert abs(tv.item() - float(jv)) <= 1e-6 * abs(float(jv)), (tv.item(), float(jv))
    for t, j in zip([tp, tc], jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    # the class term counts: without it the value differs
    plain = TM.instance_segmentation_loss(**dict(kw, n_classes=0))
    assert abs(plain(torch.from_numpy(pred), torch.from_numpy(y[..., :-1])).item()
               - tv.item()) > 1e-3


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("weights", ["none", "manual"])
def test_detection_class_loss_and_gradients_equal_jax(ndim, weights):
    rng = np.random.default_rng(20 + ndim)
    shape = (14, 40) if ndim == 2 else (6, 14, 16)
    pts = np.stack([rng.integers(0, s, 5) for s in shape], axis=1)
    masks = [JP.create_detection_masks(pts + k, shape, dilation=[1] * ndim,
                                       classes=rng.integers(1, N_CLASSES, 5), n_classes=N_CLASSES)
             for k in range(2)]
    y = np.stack(masks).astype(np.float32)
    pred = rng.normal(0, 1.5, y.shape[:-1] + (1,)).astype(np.float32)
    cls_logits = rng.normal(0, 1.5, y.shape[:-1] + (N_CLASSES,)).astype(np.float32)
    kw = dict(channel_weights=(1.0, 0.7), num_classes=N_CLASSES)
    if weights == "manual":
        kw.update(class_rebalance="manual", class_weights=[0.2, 1.0, 2.5])
    jl, tl = JM.detection_loss(**kw), TM.detection_loss(**kw)
    with jax.enable_x64(True):
        jv = float(jl({"pred": jnp.asarray(pred, jnp.float64),
                       "class": jnp.asarray(cls_logits, jnp.float64)},
                      jnp.asarray(y, jnp.float64)))
    jg = jax.grad(lambda p, c: jl({"pred": p, "class": c}, jnp.asarray(y)), argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(cls_logits))
    tp, tc = (torch.tensor(a, requires_grad=True) for a in (pred, cls_logits))
    tv = tl({"pred": tp, "class": tc}, torch.from_numpy(y))
    tv.backward()
    assert tv.dtype == torch.float32
    assert abs(tv.item() - jv) <= 1e-6 * abs(jv), (tv.item(), jv)
    for t, j in zip((tp, tc), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    assert np.abs(tc.grad.numpy()).max() > 0


# ---------------------------------------------------------------- host parts
@pytest.mark.parametrize("ndim", [2, 3])
def test_detection_masks_with_classes_equal_jax(ndim):
    rng = np.random.default_rng(30 + ndim)
    shape = (40, 44) if ndim == 2 else (10, 30, 28)
    pts = np.stack([rng.integers(-2, s + 2, 14) for s in shape], axis=1)  # some outside
    pts[1] = pts[0] + 1  # two touching blobs: the nearest point's class wins
    cls = rng.integers(1, N_CLASSES, 14)
    for kw in (dict(classes=cls, n_classes=N_CLASSES), dict(classes=cls[:9], n_classes=N_CLASSES),
               dict(n_classes=N_CLASSES), dict(classes=cls)):
        t = TP.create_detection_masks(pts, shape, dilation=[1, 2, 2][-ndim:], **kw)
        _equal(t, JP.create_detection_masks(pts, shape, dilation=[1, 2, 2][-ndim:], **kw))
    assert t.shape[-1] == 1
    t = TP.create_detection_masks(pts, shape, dilation=[1, 2, 2][-ndim:], classes=cls,
                                  n_classes=N_CLASSES)
    assert t.shape[-1] == 2 and set(np.unique(t[..., 1])) <= {0.0, 1.0, 2.0}


CSVS = {
    "by-name": (["", "axis-0", "axis-1", "axis-2", "class"],
                [[i, 3 + i, 10.5, 7, 1 + i % 2] for i in range(5)]),
    "no-class-column": (["axis-0", "axis-1", "axis-2"], [[1, 2, 3], [4, 5, 6]]),
    "bad-class": (["axis-2", "axis-0", "class", "axis-1"], [[1, 2, 3, 4], [5, 6, "x", 8]]),
    "headerless": (None, [[1, 2, 3, 2], [4, 5, 6], ["z", "y", "x"]]),
    "empty": (None, []),
}


@pytest.mark.parametrize("case", list(CSVS))
def test_read_points_csv_with_classes_equals_jax(tmp_path, case):
    header, rows = CSVS[case]
    p = str(tmp_path / "pts.csv")
    _write_csv(p, rows, header)
    for got, want in zip(TD.read_points_csv(p, 3, with_classes=True),
                         JD.read_points_csv(p, 3, with_classes=True)):
        _equal(got, want)


def test_remove_close_points_and_watershed_with_classes_equal_jax():
    rng = np.random.default_rng(40)
    pts = rng.integers(0, 30, (60, 3)).astype(np.float32)
    cls = rng.integers(1, N_CLASSES, 60)
    for res in ((1, 1, 1), (2.0, 1.0, 1.0)):
        t = TPP.remove_close_points(pts, 4.0, resolution=res, return_keep=True)
        j = JPP.remove_close_points(pts, 4.0, resolution=res, classes=cls, return_keep=True)
        _equal(t[0], j[0])
        assert list(t[1]) == list(j[1]) and len(t[1]) < len(pts)
        _equal(t[0], TPP.remove_close_points(pts, 4.0, resolution=res))
    assert TPP.remove_close_points(pts[:0], 4.0, return_keep=True)[1] == []
    # the detection watershed with classes (donut profiling only for class
    # 2) and a growth mask
    img = (40 + 160 * blobs((12, 40, 40), n=6, seed=41, noise=0.02)[0]).astype(np.float32)
    seeds = np.argwhere(img > 150)[::40][:6]
    growth = img > 90
    for kw in (dict(classes=cls[:len(seeds)], donuts_classes=[2], donuts_patch=[5, 20, 20],
                    donuts_nucleus_diameter=4),
               dict(growth_mask=growth),
               dict(growth_mask=growth, classes=cls[:len(seeds)], donuts_classes=[1])):
        _equal(TPP.detection_watershed(seeds, img, first_dilation=[1, 2, 2], **kw),
               JPP.detection_watershed(seeds, img, first_dilation=[1, 2, 2], **kw))


def _instance_wfs(ndim):
    out = []
    for cls, defaults in ((JaxWF, jax_cfg_defaults), (TorchWF, get_cfg_defaults)):
        wf = cls.__new__(cls)
        cfg = defaults()
        cfg.merge_from_dict({
            "PROBLEM": {"TYPE": "INSTANCE_SEG", "NDIM": f"{ndim}D",
                        "INSTANCE_SEG": {"DATA_CHANNELS": ["B", "C", "D"],
                                         "DATA_CHANNEL_WEIGHTS": [1.0, 1.0, 1.0, 0.4]}},
            "DATA": {"PATCH_SIZE": (8, 16, 16, 1)[-ndim - 1:], "N_CLASSES": N_CLASSES}})
        wf.cfg, wf.nd, wf.verbose = cfg, ndim, False
        wf.define_activations_and_channels()
        wf.define_metrics()
        out.append(wf)
    return out


@pytest.mark.parametrize("ndim", [2, 3])
def test_instance_head_definition_and_majority_vote_equal_jax(ndim):
    jwf, twf = _instance_wfs(ndim)
    for k in ("output_channels", "output_channel_info", "activations", "_act_channels",
              "n_class_channels"):
        assert getattr(twf, k) == getattr(jwf, k), k
    assert twf.output_channels == [3, N_CLASSES]
    tspec, jspec = twf.tta_spec(), jwf.tta_spec()
    # the class probabilities are scalars under test-time augmentation
    assert tspec.n_channels == jspec.n_channels == 3 + N_CLASSES
    assert [(type(g).__name__, tuple(g.channels)) for g in tspec.groups] == \
        [(type(g).__name__, tuple(g.channels)) for g in jspec.groups]
    rng = np.random.default_rng(50 + ndim)
    shape = (20, 24) if ndim == 2 else (6, 20, 24)
    inst = rng.integers(0, 9, shape).astype(np.int32)
    inst[inst == 5] = 0  # an id that is missing
    pix = rng.integers(0, N_CLASSES, shape).astype(np.int32)
    pix[inst == 7] = 0  # an instance with no class evidence: class 1
    pix[inst == 3] = np.where(rng.random(np.count_nonzero(inst == 3)) < 0.5, 1, 2)  # near-ties
    got = twf._majority_vote_classes(inst, pix)
    _equal(got, jwf._majority_vote_classes(inst, pix))
    assert set(np.unique(got[inst == 7])) == {1} and not got[inst == 0].any()
    _equal(twf._majority_vote_classes(np.zeros_like(inst), pix),
           jwf._majority_vote_classes(np.zeros_like(inst), pix))
    # the loss carries the class head's trailing DATA_CHANNEL_WEIGHTS entry
    y, pred, cls_logits = _class_batch(ndim, 60)
    y = np.concatenate([np.repeat(y[..., :1], 3, axis=-1), y[..., -1:]], axis=-1)
    pred = np.concatenate([pred, pred[..., :1]], axis=-1)
    out = {"pred": pred, "class": cls_logits}
    jv = float(jwf.loss(jax.tree.map(jnp.asarray, out), jnp.asarray(y)))
    tv = twf.loss({k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(y)).item()
    assert abs(tv - jv) <= 1e-6 * abs(jv)


@pytest.mark.parametrize("ndim", [2, 3])
def test_point_classes_and_metrics_equal_jax(ndim):
    rng = np.random.default_rng(70 + ndim)
    shape = (48, 48) if ndim == 2 else (12, 40, 40)
    heat, centres = blobs(shape, n=7, seed=71, sigma=(2.0,) * ndim, noise=0.02)
    cls = rng.integers(1, N_CLASSES, len(centres))
    gt = JP.create_detection_masks(centres, shape, dilation=[1] * ndim, classes=cls,
                                   n_classes=N_CLASSES)
    probs = rng.random(shape + (N_CLASSES,)).astype(np.float32)
    for c, k in zip(centres, cls):  # each blob's class, where the blob is
        box = tuple(slice(max(0, v - 2), v + 3) for v in c)
        probs[box + (k,)] += 1.0 if k != cls[0] else 0.2  # the first class voted from noise
    pred = np.concatenate([heat[..., None], probs], axis=-1)
    ms = []
    for mod, defaults in ((JD, jax_cfg_defaults), (TD, get_cfg_defaults)):
        cfg = defaults()
        cfg.merge_from_dict({"PROBLEM": {"TYPE": "DETECTION", "NDIM": f"{ndim}D"},
                             "DATA": {"PATCH_SIZE": (8, 32, 32, 1)[-ndim - 1:],
                                      "N_CLASSES": N_CLASSES},
                             "TEST": {"DET_MIN_TH_TO_BE_PEAK": 0.5, "DET_TOLERANCE": 3}})
        wf = mod.Detection_Workflow.__new__(mod.Detection_Workflow)
        wf.cfg, wf.nd, wf.is_3d, wf.verbose = cfg, ndim, ndim == 3, False
        wf.define_activations_and_channels()
        assert wf.output_channels == [1, N_CLASSES]
        ms.append((wf.metric_calculation(pred, gt), wf._last_classes))
    (jm, jc), (tm, tc) = ms
    _equal(tc, jc)
    assert sorted(tm) == sorted(jm) and "det_f1_class" in tm
    for k in tm:
        assert abs(tm[k] - jm[k]) <= 1e-6, (k, tm[k], jm[k])
