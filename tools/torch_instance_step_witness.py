"""How close a float32 training step of the 3D instance template's resunet
comes to exact arithmetic: the JAX package's on the CPU, and the port's on
the CPU and on the card.

The instance template (resunet 28/36/48/64, B/C/D channels, patch 40 x 128
x 128) with DATA.N_CLASSES 3, as ``chip_smoke.py`` phase 17 runs it. Two
cases (``--weights``):

* ``seeded``: weights drawn from a numpy seed (the same on every machine),
  a batch of ``--batch`` windows of one volume of seeded ellipsoids made as
  phase 12 makes them (``chip_smoke._ellipsoids``, a seeded class for each
  ellipsoid), around its largest ellipsoids;
* ``phase17`` (on the card): phase 17 (a)'s instance job, trained as that
  phase trains it (``chip_smoke._class_head_job``), its best checkpoint
  written to ``chiprun_out/instance_step_witness_phase17.ckpt``, and phase
  17's own training sample (one window around the largest test
  ellipsoid), at the template's patch; or a checkpoint's path: that
  checkpoint and phase 17's sample (to hold the JAX package on the card's
  checkpoint).

Each window is normalised by its own statistics and its GT compiled as
phase 17 compiles it. Dropout is off (the template's rate is 0). Each
side's loss, parameter gradients and BatchNorm running statistics after
the step (none: the template normalises by instance norm) are held against
the port's step on the CPU in float64 (its convs too): the largest
difference over tensors, scaled by max(1, |reference|), and the tensor
where it lies.

    JAX_PLATFORMS=cpu python tools/torch_instance_step_witness.py --sides jax,cpu
    python tools/torch_instance_step_witness.py --sides card,cpu   # on the card
    python tools/torch_instance_step_witness.py --sides card,cpu --weights phase17
    JAX_PLATFORMS=cpu python tools/torch_instance_step_witness.py --sides jax,cpu \
        --weights chiprun_out/instance_step_witness_phase17.ckpt

``--sides``: ``jax`` (the JAX package's float32 step, CPU), ``cpu`` (the
port's float32 step on the CPU, the kernels' plain versions), ``card``
(the port's float32 step on ``cuda:0``, the kernels). The result goes to
``chiprun_out/instance_step_witness_<sides>_<case>.json`` and to the
console. At batch 2 the float64 step takes about 71 s on 6 CPU threads and
the JAX step about 74 s, each about 10 GiB of host memory.
"""

import argparse
import copy
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SEED = 16


def _float64_reference():
    """The port's 3x3x3 conv (the plain version that its CPU route runs) and
    BatchNorm compute in float64 for float64 inputs; everything else of the
    step already keeps its input's dtype."""
    import torch.nn.functional as F

    from biapy_tpu_torch.models import blocks
    from biapy_tpu_torch.ops.kernels import conv3d as kconv

    plain, bn_forward = kconv.conv3d_plain, blocks.BatchNorm.forward

    def plain64(x, w):
        if x.dtype != torch.float64:
            return plain(x, w)
        n, d, h, wd, _ = x.shape
        xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
        acc = torch.zeros((n, d, h, wd, w.shape[-1]), dtype=torch.float64, device=x.device)
        for dz in range(3):
            for dy in range(3):
                for dx in range(3):
                    acc += xp[:, dz:dz + d, dy:dy + h, dx:dx + wd, :] @ w[dz, dy, dx].double()
        return acc

    def bn64(self, x):
        if x.dtype != torch.float64 or not self.training:
            return bn_forward(self, x)
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
        with torch.no_grad():
            self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias

    kconv.conv3d_plain, blocks.BatchNorm.forward = plain64, bn64


def _probe(port_step):
    """The card's float32 step with one part of the 3x3x3 conv in float64 on
    the card (rounded to float32 once): the weight gradient, or the forward
    and the input gradient. Which part brings the card to the CPU's
    distance from float64 names the layer."""
    from biapy_tpu_torch.ops.kernels import conv3d as kconv

    fwd, dx, wgrad = kconv.conv3d_fwd, kconv.conv3d_dx, kconv.conv3d_wgrad
    out = {}
    try:
        kconv.conv3d_wgrad = lambda x, gy: wgrad(x.double(), gy.double()).float()
        out["port float32, card, weight gradient in float64"] = port_step(torch.float32,
                                                                           "cuda:0")
        kconv.conv3d_wgrad = wgrad
        kconv.conv3d_fwd = lambda x, w: kconv.conv3d_plain(x.double(), w.double()).float()
        kconv.conv3d_dx = lambda gy, w: kconv.conv3d_plain(
            gy.double(), w.flip(0, 1, 2).transpose(3, 4).contiguous().double()).float()
        out["port float32, card, forward and input gradient in float64"] = port_step(
            torch.float32, "cuda:0")
    finally:
        kconv.conv3d_fwd, kconv.conv3d_dx, kconv.conv3d_wgrad = fwd, dx, wgrad
    return out


def _seeded_weights(model):
    """Every parameter drawn from one numpy seed: conv and dense kernels
    normal with variance 2 / fan-in, biases 0.01, BatchNorm scales about 1
    and shifts about 0."""
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            shape = tuple(p.shape)
            if name.endswith("kernel"):
                v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
            elif name.endswith("scale"):
                v = 1.0 + 0.1 * rng.standard_normal(shape)
            else:
                v = 0.01 * rng.standard_normal(shape)
            p.copy_(torch.from_numpy(v.astype(np.float32)))


def _windows(wf, img, gt, centres):
    import chip_smoke

    patch = tuple(int(v) for v in wf.cfg.DATA.PATCH_SIZE[:3])
    xs, ys = [], []
    for c in centres:
        win = chip_smoke._class_window(c, patch, img.shape)
        b = chip_smoke._class_step_batch("instance", wf, img, gt, win)
        xs.append(b["x"])
        ys.append(b["y"])
    return np.concatenate(xs), np.concatenate(ys)


def _seeded_batch(wf, n):
    """``n`` windows of the patch's size around the largest ellipsoids of
    phase 12's test volume."""
    import chip_smoke

    img, lab = chip_smoke._ellipsoids(chip_smoke.INSTANCE_SHAPE, chip_smoke.INSTANCE_COUNT,
                                      seed=2)
    rng = np.random.default_rng(17)
    cls_of = np.concatenate([[0], 1 + rng.integers(0, chip_smoke.CLASS_N - 1, int(lab.max()))])
    big = np.argsort(np.bincount(lab.ravel())[1:])[::-1][:n] + 1
    return _windows(wf, img, (lab, cls_of[lab].astype(lab.dtype)),
                    [np.argwhere(lab == i).mean(0) for i in big])


def _phase17_sample(wf):
    """Phase 17 (a)'s training sample: its test volume (phase 12's seed 2),
    its class map (the second draw of its seed-17 generator, after the
    training volume's), one window around the largest test ellipsoid."""
    import chip_smoke

    rng = np.random.default_rng(17)
    out = {}
    for split, seed in (("train", 0), ("test", 2)):
        img, lab = chip_smoke._ellipsoids(chip_smoke.INSTANCE_SHAPE, chip_smoke.INSTANCE_COUNT,
                                          seed=seed)
        cls_of = np.concatenate([[0], 1 + rng.integers(0, chip_smoke.CLASS_N - 1,
                                                       int(lab.max()))])
        out[split] = (img, lab, cls_of[lab].astype(lab.dtype))
    img, lab, cls = out["test"]
    big = int(np.argmax(np.bincount(lab.ravel())[1:])) + 1
    return _windows(wf, img, (lab, cls), [np.argwhere(lab == big).mean(0)])


def _phase17_checkpoint(smi):
    """Phase 17 (a)'s instance job on the card, as that phase runs it; its
    best checkpoint copied to chiprun_out."""
    import shutil

    import chip_smoke
    from biapy_tpu_torch import native
    from biapy_tpu_torch.data.tiff import read_tiff, write_tiff

    native._load()
    root0 = Path(tempfile.mkdtemp())
    srcs = chip_smoke._class_head_sources(root0)
    rng = np.random.default_rng(17)
    root = root0 / "instance"
    cfg = chip_smoke._class_head_cfg(srcs["instance"], "instance", root)
    for split in ("train", "test"):
        src_y = sorted((Path(srcs["instance"]["root"]) / split / "y").iterdir())[0]
        lab = read_tiff(str(src_y))
        cls_of = np.concatenate([[0], 1 + rng.integers(0, chip_smoke.CLASS_N - 1,
                                                       int(lab.max()))])
        write_tiff(str(root / split / "y" / src_y.name),
                   np.stack([lab, cls_of[lab].astype(lab.dtype)], axis=-1))
    total = {"launches": {}, "conv3d_routes": {}, "shuffle_routes": {}}
    _, r = chip_smoke._class_head_job("instance", cfg, root, smi, total)
    dest = REPO / "chiprun_out" / "instance_step_witness_phase17.ckpt"
    dest.parent.mkdir(exist_ok=True)
    shutil.copy(r["best"], dest)
    shutil.rmtree(root0, ignore_errors=True)
    return str(dest)


def _worst(got, ref):
    if not ref:
        return (0.0, "none")
    return max(((got[k] - r).abs().max().item() / max(1.0, r.abs().max().item()), k)
               for k, r in ref.items())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sides", default="jax,cpu")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--patch", default="", help="z,y,x in place of the template's patch")
    ap.add_argument("--weights", default="seeded", help="seeded, phase17 or a checkpoint")
    ap.add_argument("--probe", action="store_true",
                    help="with card: parts of the conv in float64, the grouped weight gradient")
    args = ap.parse_args()
    sides = args.sides.split(",")
    torch.set_num_threads(args.threads)
    import yaml

    import chip_smoke
    from biapy_tpu_torch import BiaPy

    with open(chip_smoke.INSTANCE_TEMPLATE) as f:
        cfg = yaml.safe_load(f)
    cfg["DATA"]["N_CLASSES"] = chip_smoke.CLASS_N
    if args.patch:
        cfg["DATA"]["PATCH_SIZE"] = [int(v) for v in args.patch.split(",")] + [1]
    root = Path(tempfile.mkdtemp())
    job = BiaPy(copy.deepcopy(cfg), result_dir=str(root), name="witness", silent=True,
                check_data_paths=False, device="cpu")
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    model0 = wf.model
    out = {"weights": args.weights, "sides": {}}
    if "card" in sides:
        import subprocess

        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    if args.weights == "seeded":
        _seeded_weights(model0)
        x, y = _seeded_batch(wf, args.batch)
    else:
        from biapy_tpu_torch.models.flax_import import apply_checkpoint_params
        from biapy_tpu_torch.utils.misc import load_checkpoint

        path = _phase17_checkpoint(out["card"]) if args.weights == "phase17" else args.weights
        ck = load_checkpoint(path)
        apply_checkpoint_params(model0, ck["params"], ck.get("batch_stats"),
                                skip_unmatched=False)
        x, y = _phase17_sample(wf)
    out["batch"] = list(x.shape)

    def port_step(dtype, dev):
        model = copy.deepcopy(model0).to(dev, dtype)
        model.train()
        t0 = time.perf_counter()
        o = model(torch.from_numpy(x).to(dev, dtype))
        loss = wf.loss(o, torch.from_numpy(y).to(dev, dtype))
        names, leaves = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        if dev != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stats = {k: v.detach().double().cpu() for k, v in model.named_buffers()}
        return (loss.item(), {k: g.double().cpu() for k, g in zip(names, grads)}, stats, secs)

    _float64_reference()
    l64, g64, s64, secs64 = port_step(torch.float64, "cpu")
    out["float64_seconds"] = secs64
    gc.collect()
    got = {}
    if "cpu" in sides:
        got["port float32, CPU"] = port_step(torch.float32, "cpu")
    if "card" in sides:
        got["port float32, card"] = port_step(torch.float32, "cuda:0")
        if args.probe:
            got.update(_probe(port_step))
    if "jax" in sides:
        got["JAX float32, CPU"] = _jax_step(cfg, root, model0, x, y)
    print(f"batch {x.shape}; against the port's float64 step (loss {l64:.9f}):")
    for name, (loss_, g, s, secs) in got.items():
        r = dict(loss=abs(loss_ - l64) / max(1.0, abs(l64)), grad=_worst(g, g64),
                 stats=_worst(s, s64), seconds=secs)
        out["sides"][name] = r
        print(f"  {name}: loss {r['loss']:.3g}, gradients {r['grad'][0]:.3g} "
              f"({r['grad'][1]}), statistics {r['stats'][0]:.3g} ({r['stats'][1]}); "
              f"step {secs:.2f} s")
    case = "seeded" if args.weights == "seeded" else "phase17"
    dest = REPO / "chiprun_out" / f"instance_step_witness_{'_'.join(sides)}_{case}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))


def _jax_step(cfg, root, model0, x, y):
    """The JAX package's float32 step from the same weights (carried over
    by ``flax_import``): loss, gradients and the updated statistics under
    the port's names."""
    import jax
    import jax.numpy as jnp

    import biapy_tpu
    from biapy_tpu_torch.models.flax_import import export_flax_variables, load_flax_variables

    jjob = biapy_tpu.BiaPy(copy.deepcopy(cfg), result_dir=str(root), name="jax", silent=True,
                           check_data_paths=False)
    jjob._build_workflow()
    jwf = jjob.workflow
    jwf.prepare_model()
    params, stats = export_flax_variables(model0)
    fm = jwf.model

    def loss_fn(p):
        o, upd = fm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                          mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return jwf.loss(o, jnp.asarray(y)), upd

    t0 = time.perf_counter()
    (loss, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    loss = float(loss)
    secs = time.perf_counter() - t0
    back = copy.deepcopy(model0)
    load_flax_variables(back, jax.tree.map(np.asarray, grads),
                        jax.tree.map(np.asarray, upd["batch_stats"]))
    return (loss, {k: v.detach().double() for k, v in back.named_parameters()},
            {k: v.double() for k, v in back.named_buffers()}, secs)


if __name__ == "__main__":
    main()
