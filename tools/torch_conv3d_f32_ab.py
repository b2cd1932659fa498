"""Float32 times of the port's 3x3x3 conv on the card, for one source tree:
the CUDA-core kernel's forward at every conv of the 3D instance template's
resunet (28/36/48/64, patch 40 x 128 x 128, batch 2), the weight gradient
at the same shapes, and one float32 forward and backward of the whole
model. Run it on two trees in one call to compare them on the same card:

    python tools/torch_conv3d_f32_ab.py --tree OLD --tree NEW --tree NEW --tree OLD

Each ``--tree`` runs in a process of its own (its kernels built from its
own ``biapy_tpu_torch/csrc``), in the order given. Times are device-side:
CUDA events around ``--reps`` back-to-back calls after two warm-up calls,
divided by ``--reps``; for the whole model the median of ``--reps`` single
forward-and-backward passes (loss: the mean square of the output). The
model's weights come from its seeded initialisation and the input from a
numpy seed, the same in every tree. The card's name and power limit are
printed first; one JSON line per tree, then a table. ``--out`` writes the
lines to a file as well.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

TEMPLATE = "templates/instance_segmentation/3d_instance_segmentation.yaml"


def _one_tree(tree: Path, reps: int) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    import yaml

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.ops.kernels import conv3d as kconv

    def dev_ms(fn):
        for _ in range(2):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    with open(tree / TEMPLATE) as f:
        cfg = yaml.safe_load(f)
    cfg["TRAIN"]["ENABLE"] = True
    job = BiaPy(cfg, result_dir=str(tree / "chiprun_out" / "conv3d_f32_ab"), name="ab",
                silent=True, check_data_paths=False, device="cuda:0")
    job._build_workflow()
    wf = job.workflow
    wf.prepare_model()
    model = wf.model
    patch = [int(v) for v in wf.cfg.DATA.PATCH_SIZE]
    x = torch.from_numpy(np.random.default_rng(0).random((2,) + tuple(patch), np.float32))
    x = x.to("cuda:0")
    # the shapes every conv of one forward gets, in order
    shapes, fwd = [], kconv.conv3d_fwd

    def record(xx, ww):
        shapes.append((tuple(xx.shape), tuple(ww.shape)))
        return fwd(xx, ww)
    kconv.conv3d_fwd = record
    with torch.no_grad():
        model.train()
        model(x)
    kconv.conv3d_fwd = fwd
    g = torch.Generator(device="cpu").manual_seed(1)
    rows = []
    for xs, ws in shapes:
        xi = torch.randn(xs, generator=g).to("cuda:0")
        wi = (torch.randn(ws, generator=g) * 0.05).to("cuda:0")
        gy = torch.randn(xs[:4] + (ws[4],), generator=g).to("cuda:0")
        rows.append(dict(x=list(xs), cout=ws[4], route=kconv.conv3d_route(torch.float32, xs[4],
                                                                           ws[4]),
                         fwd_ms=dev_ms(lambda: kconv.conv3d_fwd(xi, wi)),
                         wgrad_ms=dev_ms(lambda: kconv.conv3d_wgrad(xi, gy))))

    def step():
        out = model(x)
        loss = (out.float() ** 2).mean()
        torch.autograd.grad(loss, [p for p in model.parameters() if p.requires_grad])
    times = []
    for i in range(reps + 2):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        step()
        b.record()
        b.synchronize()
        if i >= 2:
            times.append(a.elapsed_time(b))
    return dict(tree=str(tree), patch=patch, convs=len(rows),
                fwd_ms=sum(r["fwd_ms"] for r in rows),
                wgrad_ms=sum(r["wgrad_ms"] for r in rows),
                step_ms=statistics.median(times), rows=rows)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a child's own tree
    args = ap.parse_args()
    if args.one:
        print(json.dumps(_one_tree(args.one.resolve(), args.reps)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lines = []
    for tree in (t.resolve() for t in args.tree):
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree", str(tree),
                              "--one", str(tree), "--reps", str(args.reps)],
                             capture_output=True, text=True, cwd=str(tree))
        if run.returncode:
            sys.exit(f"{tree}: exit {run.returncode}\n{run.stderr[-4000:]}")
        out = run.stdout.strip().splitlines()[-1]
        print(out, flush=True)
        lines.append(json.loads(out))
    if args.out:
        args.out.write_text("\n".join([json.dumps({"card": smi})]
                                      + [json.dumps(r) for r in lines]) + "\n")
    print(f"{'tree':40s} {'fwd ms':>9s} {'wgrad ms':>9s} {'step ms':>9s}  ({smi})")
    for r in lines:
        print(f"{r['tree'][-40:]:40s} {r['fwd_ms']:9.3f} {r['wgrad_ms']:9.3f} "
              f"{r['step_ms']:9.3f}")


if __name__ == "__main__":
    main()
