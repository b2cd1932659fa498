"""How close a float32 training step of a super-resolution template with
rcan or dfcan comes to exact arithmetic: the JAX package's on the CPU, and
the port's on the CPU and on the card.

The 3D template (``templates/super-resolution/3d_super-resolution.yaml``)
at UPSCALING (2, 2, 2), as ``chip_smoke.py`` phase 14 c runs it, or with
``--ndim 2`` the 2D one, as phase 16 runs it, with ``--arch`` at full width
and depth, from the port's seeded initial weights (SYSTEM.SEED, drawn on
the CPU: the same on every machine), on one seeded sample: a
``--lr-shape`` LR crop of a smooth volume or image made as
``chip_smoke._smooth_volume`` makes one (here on the CPU) and its HR
target, twice it on every axis, normalised as the templates do (div).
Each side's loss, parameter gradients and the weights after one SGD update
at ``--lr`` (``chip_smoke.py``'s step check: phase 8's rate) are held
against the port's step on the CPU in float64 (its 3x3x3 convs too;
DFCAN's FFT takes complex64 on every side, as the model has it): the
largest difference over tensors, scaled by max(1, |reference|), and the
tensor where it lies.

    JAX_PLATFORMS=cpu python tools/torch_sr_step_witness.py --arch rcan --sides jax,cpu
    JAX_PLATFORMS=cpu python tools/torch_sr_step_witness.py --arch rcan --ndim 2 --sides jax,cpu
    python tools/torch_sr_step_witness.py --arch rcan --sides card,cpu   # on the card

The result goes to ``chiprun_out/sr_step_witness_<arch>_<ndim>d_<sides>.json``
and to the console.
"""

import argparse
import copy
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

TEMPLATES = {3: "templates/super-resolution/3d_super-resolution.yaml",
             2: "templates/super-resolution/2d_super-resolution.yaml"}


def _sample(lr_shape, seed=19):
    """A smooth seeded HR volume or image (a random field on a coarse grid,
    linearly upsampled, plus noise) twice ``lr_shape``, its LR the 2 x 2 (x
    2) block mean, both as uint8 and then divided by 255 (the templates'
    div)."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    hr_shape = tuple(2 * n for n in lr_shape)
    coarse = [max(2, n // 16) for n in hr_shape]
    field = F.interpolate(torch.randn([1, 1] + coarse, generator=g), size=hr_shape,
                          mode="trilinear" if len(hr_shape) == 3 else "bilinear",
                          align_corners=False)[0, 0]
    field = (field - field.min()) / (field.max() - field.min())
    hr = (40 + 170 * field + 6 * torch.randn(hr_shape, generator=g)).clamp(0, 255).round()
    hr = hr.numpy().astype(np.uint8)
    blocks = sum(([n, 2] for n in lr_shape), [])
    lr = np.round(hr.reshape(blocks).mean(axis=tuple(range(1, 2 * len(lr_shape), 2))))
    return ((lr.astype(np.uint8) / 255.0).astype(np.float32)[None, ..., None],
            (hr / 255.0).astype(np.float32)[None, ..., None])


def _float64_conv2d():
    """The 2D convs in float64 on contiguous NCHW copies (PyTorch's float64
    CPU convolution wants contiguous operands for its weight gradient)."""
    import torch.nn.functional as F

    from biapy_tpu_torch.models import blocks

    conv_same = blocks.conv_same

    def conv64(x, w):
        ks = tuple(w.shape[:-2])
        if x.dtype != torch.float64 or len(ks) != 2 or ks == (1, 1):
            return conv_same(x, w)
        y = F.conv2d(x.movedim(-1, 1).contiguous(), w.permute(3, 2, 0, 1).contiguous(),
                     padding=[k // 2 for k in ks])
        return y.movedim(1, -1).contiguous()

    blocks.conv_same = conv64


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rcan", choices=("rcan", "dfcan"))
    ap.add_argument("--sides", default="jax,cpu")
    ap.add_argument("--ndim", type=int, default=3, choices=(2, 3))
    ap.add_argument("--lr-shape", default="", help="default 8,64,64 (3D) or 64,64 (2D)")
    ap.add_argument("--lr", type=float, default=0.05, help="the SGD update's rate")
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    sides = args.sides.split(",")
    torch.set_num_threads(args.threads)
    import yaml

    from biapy_tpu_torch import BiaPy
    from torch_instance_step_witness import _float64_reference, _worst

    with open(REPO / TEMPLATES[args.ndim]) as f:
        cfg = yaml.safe_load(f)
    cfg["MODEL"]["ARCHITECTURE"] = args.arch
    cfg["PROBLEM"]["SUPER_RESOLUTION"]["UPSCALING"] = [2] * args.ndim
    root = Path(tempfile.mkdtemp())
    job = BiaPy(copy.deepcopy(cfg), result_dir=str(root), name="witness", silent=True,
                check_data_paths=False, device="cpu")
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    model0 = wf.model
    lr_shape = args.lr_shape or ("8,64,64" if args.ndim == 3 else "64,64")
    x, y = _sample(tuple(int(v) for v in lr_shape.split(",")))
    out = {"arch": args.arch, "ndim": args.ndim, "batch": list(x.shape), "lr": args.lr,
           "sides": {}}
    w0 = {k: v.detach().double() for k, v in model0.named_parameters()}

    def updated(g):
        return {k: w0[k] - args.lr * v for k, v in g.items()}
    if "card" in sides:
        import subprocess

        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()

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
        return (loss.item(), {k: g.double().cpu() for k, g in zip(names, grads)},
                float(o.detach().abs().max()), time.perf_counter() - t0)

    _float64_reference()
    _float64_conv2d()
    l64, g64, out_max, secs64 = port_step(torch.float64, "cpu")
    out.update(float64_seconds=secs64, float64_loss=l64, output_abs_max=out_max)
    got = {}
    if "cpu" in sides:
        got["port float32, CPU"] = port_step(torch.float32, "cpu")
    if "card" in sides:
        got["port float32, card"] = port_step(torch.float32, "cuda:0")
    if "jax" in sides:
        got["JAX float32, CPU"] = _jax_step(cfg, root, model0, x, y)
    print(f"{args.arch}, batch {x.shape}, output up to {out_max:.4g}; against the port's "
          f"float64 step (loss {l64:.9g}):")
    for name, (loss_, g, _, secs) in got.items():
        r = dict(loss=abs(loss_ - l64) / max(1.0, abs(l64)), grad=_worst(g, g64),
                 weight=_worst(updated(g), updated(g64)), seconds=secs)
        out["sides"][name] = r
        print(f"  {name}: loss {r['loss']:.3g}, gradients {r['grad'][0]:.3g} "
              f"({r['grad'][1]}), weights after SGD at {args.lr} {r['weight'][0]:.3g} "
              f"({r['weight'][1]}); step {secs:.2f} s")
    dest = (REPO / "chiprun_out"
            / f"sr_step_witness_{args.arch}_{args.ndim}d_{'_'.join(sides)}.json")
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))


def _jax_step(cfg, root, model0, x, y):
    """The JAX package's float32 step from the same weights (carried over by
    ``flax_import``): loss and gradients under the port's names."""
    import jax
    import jax.numpy as jnp

    import biapy_tpu
    from biapy_tpu.models import build_model
    from biapy_tpu_torch.models.flax_import import export_flax_variables, load_flax_variables

    jjob = biapy_tpu.BiaPy(copy.deepcopy(cfg), result_dir=str(root), name="jax", silent=True,
                           check_data_paths=False)
    jjob._build_workflow()
    jwf = jjob.workflow
    params, _ = export_flax_variables(model0)
    fm = build_model(jwf.cfg, jwf.output_channels, jwf.output_channel_info,
                     jwf.activations)[0]

    def loss_fn(p):
        return jwf.loss(fm.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))

    t0 = time.perf_counter()
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = float(loss)
    secs = time.perf_counter() - t0
    back = copy.deepcopy(model0)
    load_flax_variables(back, jax.tree.map(np.asarray, grads))
    return loss, {k: v.detach().double() for k, v in back.named_parameters()}, None, secs


if __name__ == "__main__":
    main()
