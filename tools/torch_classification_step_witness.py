"""How close a float32 training step of simple_cnn can come to exact
arithmetic, in the port and in the JAX package.

``--case template``: the 3D classification template with its data as
``chip_smoke.py`` phase 15 makes it (seeded class folders, made here on the
CPU), the template's batch of validation samples and the seeded initial
weights. ``--case unit``: the inputs and weights of
``tests/test_torch_classification.py::test_train_step_matches_jax``
(patch 8 x 16 x 16, batch 4, the JAX package's initial weights). Dropout
off on both sides, BatchNorm training. One step's loss, parameter
gradients and BatchNorm running statistics of the port in float32 and of the JAX package in float32 (the
same weights, carried over by ``flax_import``), each against the port's
step on the CPU in float64 (its convs and BatchNorm too), as the largest difference over tensors scaled by
max(1, |reference|). Also the max-pool windows whose two largest inputs lie
within 1e-6 of the output's scale (a rounding can flip their winner).

    JAX_PLATFORMS=cpu python tools/torch_classification_step_witness.py \
        [--case template|unit] [--batch 8]

The template case's JAX side at batch 8 takes about 35 GiB of host memory
and a few minutes; the unit case seconds.
"""

import argparse
import copy
import gc
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import yaml

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _float64_reference():
    """The port's convs and BatchNorm compute in float64 for float64 inputs
    (the kernels' plain versions, like the kernels, sum in float32)."""
    import torch.nn.functional as F

    from biapy_tpu_torch.models import blocks

    conv_same, bn_forward = blocks.conv_same, blocks.BatchNorm.forward

    def conv64(x, w):
        if x.dtype != torch.float64:
            return conv_same(x, w)
        pad = [k // 2 for k in w.shape[:3]]
        return F.conv3d(x.movedim(-1, 1), w.permute(4, 3, 0, 1, 2), padding=pad).movedim(1, -1)

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

    blocks.conv_same, blocks.BatchNorm.forward = conv64, bn64


def _worst(got, ref):
    return max(((got[k] - r).abs().max().item() / max(1.0, r.abs().max().item()), k)
               for k, r in ref.items())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=("template", "unit"), default="template")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(4)

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.models.blocks import Dropout
    from biapy_tpu_torch.models.flax_import import export_flax_variables, load_flax_variables

    root = Path(tempfile.mkdtemp())
    if args.case == "template":
        import chip_smoke

        chip_smoke.DEVICE = "cpu"
        chip_smoke._write_classification_data(root / "data")
        with open(REPO / chip_smoke.CLASSIFICATION_TEMPLATE) as f:
            cfg = yaml.safe_load(f)
        cfg["DATA"]["TRAIN"]["PATH"] = str(root / "data/train")
        cfg["DATA"]["TEST"]["PATH"] = str(root / "data/test")
    else:
        sys.path.insert(0, str(REPO / "tests"))
        from test_torch_classification import _cfg

        cfg = _cfg("simple_cnn", "SGD", 0.05)
    job = BiaPy(copy.deepcopy(cfg), result_dir=str(root / "results"), name="witness",
                silent=True, check_data_paths=args.case == "template", device="cpu")
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    model0 = wf.model
    if args.case == "template":
        _, val = wf._build_loaders()
        samples = [val.get(i % len(val), np.random.default_rng(0)) for i in range(args.batch)]
        x, y = (np.stack([smp[k] for smp in samples]) for k in ("x", "y"))
    else:
        import biapy_tpu
        import jax

        jjob = biapy_tpu.BiaPy(copy.deepcopy(cfg), result_dir=str(root / "results"),
                               name="jax", silent=True, check_data_paths=False)
        jjob._build_workflow()
        jjob.workflow.prepare_model()
        state = jjob.workflow.state
        load_flax_variables(model0, jax.tree.map(np.asarray, state.params),
                            jax.tree.map(np.asarray, state.batch_stats))
        rng = np.random.default_rng(2)
        x = rng.standard_normal((4,) + tuple(cfg["DATA"]["PATCH_SIZE"])).astype(np.float32)
        y = np.array([[0], [2], [1], [2]], np.float32)
    for m in model0.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0

    def port_step(dtype):
        model = copy.deepcopy(model0).to(dtype)
        pre = {}
        for i in (2, 5):
            getattr(model, f"Conv_{i}").register_forward_hook(
                lambda m, a, o, i=i: pre.__setitem__(i, o.detach()))
        model.train()
        # the loss in the step's dtype (the train engine's casts the logits
        # to float32 first)
        loss = wf.loss(model(torch.from_numpy(x).to(dtype)), torch.from_numpy(y).to(dtype))
        names, leaves = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        stats = {k: v.double() for k, v in model.named_buffers()}
        return loss.item(), {k: g.double() for k, g in zip(names, grads)}, stats, pre

    _float64_reference()
    l64, g64, s64, pre = port_step(torch.float64)
    for i, o in pre.items():
        n, d, h, w, c = o.shape
        win = o.reshape(n, d // 2, 2, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
        top = win.reshape(-1, 8).topk(2, dim=1).values
        near = int(((top[:, 0] - top[:, 1]) < 1e-6 * o.abs().max()).sum())
        print(f"Conv_{i}'s pool: {top.shape[0]} windows, {near} within 1e-6 of a tie")
    del pre
    sides = {"port float32": port_step(torch.float32)[:3]}
    gc.collect()

    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from biapy_tpu.models.simple_cnn import SimpleCNN as FlaxSimpleCNN

    params, stats = export_flax_variables(model0)
    fm = FlaxSimpleCNN(ndim=3, n_classes=int(cfg["DATA"]["N_CLASSES"]))

    def no_dropout(next_fun, args_, kwargs, context):
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            return args_[0]
        return next_fun(*args_, **kwargs)

    def loss_fn(p):
        out, upd = fm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        logp = jax.nn.log_softmax(out["class"])
        labels = jnp.asarray(y[:, 0].astype(np.int32))[:, None]
        return -jnp.mean(jnp.take_along_axis(logp, labels, 1)), upd

    with nn.intercept_methods(no_dropout):
        (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    back = copy.deepcopy(model0)
    load_flax_variables(back, jax.tree.map(np.asarray, grads),
                        jax.tree.map(np.asarray, upd["batch_stats"]))
    sides["JAX float32"] = (float(loss), {k: v.detach().double()
                                          for k, v in back.named_parameters()},
                            {k: v.double() for k, v in back.named_buffers()})
    print(f"batch {x.shape}, labels {y[:, 0].astype(int).tolist()}; against the port's "
          f"float64 step (loss {l64:.9f}):")
    for name, (loss_, g, s) in sides.items():
        print(f"  {name}: loss {abs(loss_ - l64) / abs(l64):.3g}, gradients "
              f"{_worst(g, g64)}, statistics {_worst(s, s64)}")


if __name__ == "__main__":
    main()
