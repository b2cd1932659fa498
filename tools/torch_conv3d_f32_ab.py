"""Times of the port's 3x3x3 conv on the card, for one source tree, at the
convs of the 3D instance template's resunet (28/36/48/64, patch 40 x 128 x
128, batch 2; the semantic, detection and self-supervised templates share
its widths).

``--dtype float32`` (the default): the forward at every conv, the weight
gradient at the same shapes, the input gradient of every conv but the
stem's, the main path's other 9 forward convs and their input gradients,
the 3D super-resolution template's 10 forward convs and 9 input gradients
(unet 16/32/64 at its 8 x 128 x 128 patch, batch 4:
``chip_smoke._sr_conv_rows``), and one float32 forward and backward of the
whole model. ``--dtype bfloat16``: the forward at every
conv, the input gradient of every conv but the stem's, the stems of
the main path (1 -> 32 at 1 x 128^3), the templates (1 -> 28 at 2 x 40 x
128^2) and the classification template (1 -> 32 at 8 x 32 x 64 x 64), and
the main path's other 9 forward convs and their input gradients (a 128^3
patch through resunet 32/64/128, ``chip_smoke.MAIN_CONVS``);
each row with the route it took, ``F.conv3d``'s time on the same inputs
(for dx: on the flipped, IO-swapped weights; float32 with TF32 off) and
the bound as ``chip_smoke.py::bound`` computes it for the route (the
3xTF32 route: three TF32 products a float32 one). ``--cut`` (bfloat16, trees with a stem
route) also times the stem kernel and the tensor-core kernel, each through
its C entry, side by side at Cin 1-8 at 1 x 128^3 -> 32: where the stem route
should end. Run it on two trees in one call to compare them on the same
card:

    python tools/torch_conv3d_f32_ab.py --tree OLD --tree NEW --tree NEW --tree OLD
    python tools/torch_conv3d_f32_ab.py --dtype bfloat16 --cut --tree OLD --tree NEW ...

Each ``--tree`` runs in a process of its own (its kernels built from its
own ``biapy_tpu_torch/csrc``), in the order given. Times are device-side:
``chip_smoke.py::device_ms``, CUDA events around ``--reps`` back-to-back
calls queued behind a spin kernel that outlasts their host work, divided
by ``--reps``; for the whole model the median of ``--reps`` single
forward-and-backward passes (loss: the mean square of the output). The
model's weights come from its seeded initialisation and the inputs from
seeded generators, the same in every tree. The card's name and power
limit are printed first; one JSON line per tree, then a table. ``--out``
writes the lines to a file as well.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

TEMPLATE = "templates/instance_segmentation/3d_instance_segmentation.yaml"
# (N, D, H, W), Cin, Cout: the main path's, the templates' and the
# classification template's 1-channel stems
STEMS = [((1, 128, 128, 128), 1, 32), ((2, 40, 128, 128), 1, 28), ((8, 32, 64, 64), 1, 32)]
CUT_CINS = range(1, 9)


def _one_tree(tree: Path, reps: int, dtype_name: str, cut: bool) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    import torch.nn.functional as F
    import yaml

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.ops.kernels import conv3d as kconv

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    # chip_smoke imports only the standard library at import
    from chip_smoke import DX_CONVS, MAIN_CONVS, _sr_conv_rows, bound, device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    dt = getattr(torch, dtype_name)

    def dev_ms(fn):
        fn()
        return device_ms(fn, reps)[0]

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

    def operands(xs, cin, cout):
        xi = torch.randn(xs + (cin,), generator=g).to("cuda:0", dt)
        wi = (torch.randn((3, 3, 3, cin, cout), generator=g) / (27 * cin) ** 0.5).to("cuda:0", dt)
        return xi, wi

    def conv_row(kind, xi, wi, run):
        """``run`` computes the row's conv of ``xi``: the forward with ``wi``,
        or (dx) the conv with ``wi`` flipped and IO-swapped."""
        wl = wi.flip(0, 1, 2).transpose(3, 4) if kind.endswith("dx") else wi
        cin, cout = wl.shape[3], wl.shape[4]
        xc = xi.permute(0, 4, 1, 2, 3)  # NCDHW view in channels_last_3d strides
        wc = wl.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        m = xi.numel() // cin
        route = kconv.conv3d_route(dt, cin, cout)
        b_ms, b_by = bound(2 * 27 * cin * cout * m,
                           (xi.numel() + wi.numel() + m * cout) * xi.element_size(), dtype_name,
                           card, route)
        rows.append(dict(kind=kind, x=list(xi.shape), cout=cout, route=route, ms=dev_ms(run),
                         library_ms=dev_ms(lambda: F.conv3d(xc, wc, padding=1)),
                         bound_ms=b_ms, bound_by=b_by))
        return rows[-1]

    def fwd_dx_rows(kind, vol, cin, cout, dx=True):
        """The forward row of one conv and (``dx``) its input gradient's."""
        xi, wi = operands(vol, cin, cout)
        conv_row(kind, xi, wi, lambda: kconv.conv3d_fwd(xi, wi))
        if dx:
            gy = torch.randn(vol + (cout,), generator=g).to("cuda:0", dt)
            conv_row(kind + "_dx", gy, wi, lambda: kconv.conv3d_dx(gy, wi))

    if dtype_name == "float32":
        for i, (xs, ws) in enumerate(shapes):
            xi, wi = operands(xs[:4], ws[3], ws[4])
            gy = torch.randn(xs[:4] + (ws[4],), generator=g).to("cuda:0")
            conv_row("fwd", xi, wi, lambda: kconv.conv3d_fwd(xi, wi))["wgrad_ms"] = \
                dev_ms(lambda: kconv.conv3d_wgrad(xi, gy))
            if i:  # the stem's input needs no gradient
                conv_row("dx", gy, wi, lambda: kconv.conv3d_dx(gy, wi))
            del xi, wi, gy
        for s, cin, cout in MAIN_CONVS[1:]:
            fwd_dx_rows("main", (1, s, s, s), cin, cout)
        sr_fwd, _ = _sr_conv_rows()
        for i, (vol, cin, cout) in enumerate(sr_fwd):
            fwd_dx_rows("sr", vol, cin, cout, dx=i > 0)
        torch.cuda.empty_cache()

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
        sums = {f"{pre}{kind}_ms": sum(r[key] for r in rows if r["kind"] == kind)
                for kind in ("fwd", "dx", "main", "main_dx", "sr", "sr_dx")
                for pre, key in (("", "ms"), ("library_", "library_ms"), ("bound_", "bound_ms"))}
        return dict(tree=str(tree), dtype=dtype_name, card=card, patch=patch,
                    wgrad_ms=sum(r["wgrad_ms"] for r in rows if r["kind"] == "fwd"),
                    step_ms=statistics.median(times), rows=rows, **sums)

    for i, (xs, ws) in enumerate(shapes):
        xi, wi = operands(xs[:4], ws[3], ws[4])
        conv_row("fwd", xi, wi, lambda: kconv.conv3d_fwd(xi, wi))
        if i:  # the stem's input needs no gradient
            gy = torch.randn(xs[:4] + (ws[4],), generator=g).to("cuda:0", dt)
            conv_row("dx", gy, wi, lambda: kconv.conv3d_dx(gy, wi))
        del xi, wi
    for vol, cin, cout in STEMS:
        xi, wi = operands(vol, cin, cout)
        conv_row("stem", xi, wi, lambda: kconv.conv3d_fwd(xi, wi))
        del xi, wi
    for s, cin, cout in MAIN_CONVS[1:] + DX_CONVS:
        xi, wi = operands((1, s, s, s), cin, cout)
        conv_row("main", xi, wi, lambda: kconv.conv3d_fwd(xi, wi))
        del xi, wi
    cut_rows = []
    if cut and hasattr(kconv, "STEM_CIN"):
        from biapy_tpu_torch.ops.kernels import build as kbuild

        def launch(route, xi, wi):
            """One launch of the stem or tensor-core kernel through its C
            entry, whatever the rule says for this Cin."""
            y = torch.empty(xi.shape[:4] + (wi.shape[4],), dtype=xi.dtype, device=xi.device)
            if route == "stem":
                rc = kbuild.lib().biapy_conv3d_k3_stem(
                    xi.data_ptr(), wi.data_ptr(), y.data_ptr(), kbuild.dtype_code(xi),
                    *xi.shape, wi.shape[4], kbuild.stream_ptr(xi))
            else:
                xk, wp = kconv.pad_channels(xi), kconv.pack_weights(wi)
                rc = kbuild.lib().biapy_conv3d_k3_wgmma(
                    xk.data_ptr(), wp.data_ptr(), y.data_ptr(), *xi.shape[:4], xk.shape[-1],
                    wi.shape[4], kbuild.stream_ptr(xi))
            kbuild.check_rc(rc, route)
            return y

        for cin in CUT_CINS:
            xi, wi = operands((1, 128, 128, 128), cin, 32)
            ref = kconv.conv3d_plain(xi, wi).float()
            row = dict(cin=cin, rule=kconv.conv3d_route(dt, cin, 32))
            for route in ("stem", "wgmma"):
                got = launch(route, xi, wi).float()
                row[route + "_err"] = (got - ref).abs().max().item() / max(
                    1.0, ref.abs().max().item())
                row[route + "_ms"] = dev_ms(lambda: launch(route, xi, wi))
            cut_rows.append(row)
            del xi, wi, ref
    torch.cuda.empty_cache()

    def total(kinds, key="ms"):
        return sum(r[key] for r in rows if r["kind"] in kinds)
    return dict(tree=str(tree), dtype=dtype_name, card=card, patch=patch,
                fwd_ms=total({"fwd"}), fwd_dx_ms=total({"fwd", "dx"}),
                stems_ms=total({"stem"}), main_ms=total({"main"}),
                library_main_ms=total({"main"}, "library_ms"),
                library_fwd_ms=total({"fwd"}, "library_ms"),
                library_fwd_dx_ms=total({"fwd", "dx"}, "library_ms"),
                library_stems_ms=total({"stem"}, "library_ms"),
                bound_fwd_ms=total({"fwd"}, "bound_ms"),
                bound_fwd_dx_ms=total({"fwd", "dx"}, "bound_ms"), rows=rows, cut=cut_rows)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--cut", action="store_true")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a child's own tree
    args = ap.parse_args()
    if args.one:
        print(json.dumps(_one_tree(args.one.resolve(), args.reps, args.dtype, args.cut)),
              flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lines = []
    for tree in (t.resolve() for t in args.tree):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--tree", str(tree), "--one",
               str(tree), "--reps", str(args.reps), "--dtype", args.dtype]
        run = subprocess.run(cmd + (["--cut"] if args.cut else []), capture_output=True,
                             text=True, cwd=str(tree))
        if run.returncode:
            sys.exit(f"{tree}: exit {run.returncode}\n{run.stderr[-4000:]}")
        out = run.stdout.strip().splitlines()[-1]
        lines.append(json.loads(out))
    if args.out:
        args.out.write_text("\n".join([json.dumps({"card": smi})]
                                      + [json.dumps(r) for r in lines]) + "\n")
    for r in lines:
        print(f"== {r['tree']} ({smi}; ms, F.conv3d ms, bound ms)")
        for row in r["rows"]:
            print(f"  {row['kind']:7s} {str(tuple(row['x'])):24s} -> {row['cout']:3d} "
                  f"{row['route']:6s} {row['ms']:8.4f} {row['library_ms']:8.4f} "
                  f"{row['bound_ms']:8.4f} ({row['bound_by']})")
    if args.dtype == "float32":
        kinds = ("fwd", "dx", "main", "main_dx", "sr", "sr_dx")
        print(f"sums of the rows by kind (ms; fwd / dx: the instance template's 14 forward "
              f"convs and 13 input gradients; main: the main path's 9 after the stem; sr: the "
              f"super-resolution template's; {smi})")
        print(f"{'tree':40s} " + " ".join(f"{k:>9s}" for k in kinds)
              + f" {'wgrad':>9s} {'step':>9s}")
        for r in lines:
            print(f"{r['tree'][-40:]:40s} " + " ".join(f"{r[k + '_ms']:9.3f}" for k in kinds)
                  + f" {r['wgrad_ms']:9.3f} {r['step_ms']:9.3f}")
        for r in lines:  # F.conv3d's and the bound by the tree's routes
            for pre in ("library_", "bound_"):
                print(f"{pre[:-1] + ' ' + r['tree'][-32:]:40s} "
                      + " ".join(f"{r[pre + k + '_ms']:9.3f}" for k in kinds))
        return
        for row in r["cut"]:
            print(f"  cut Cin {row['cin']} (rule: {row['rule']}): stem {row['stem_ms']:.4f} ms, "
                  f"wgmma {row['wgmma_ms']:.4f} ms")
    print(f"{'tree':40s} {'fwd':>8s} {'fwd+dx':>8s} {'stems':>8s} {'main':>8s} | F.conv3d "
          f"{'fwd':>8s} {'fwd+dx':>8s} {'stems':>8s} {'main':>8s} | bound {'fwd':>7s} "
          f"{'fwd+dx':>7s}  (ms; {smi})")
    for r in lines:
        print(f"{r['tree'][-40:]:40s} {r['fwd_ms']:8.3f} {r['fwd_dx_ms']:8.3f} "
              f"{r['stems_ms']:8.3f} {r['main_ms']:8.3f} | {'':8s} {r['library_fwd_ms']:8.3f} "
              f"{r['library_fwd_dx_ms']:8.3f} {r['library_stems_ms']:8.3f} "
              f"{r['library_main_ms']:8.3f} | {'':5s} {r['bound_fwd_ms']:7.3f} "
              f"{r['bound_fwd_dx_ms']:7.3f}")


if __name__ == "__main__":
    main()
