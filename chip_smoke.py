#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``biapy_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit code:

1. environment: the card's name and power limit (nvidia-smi), CUDA version;
   no CUDA device, or no ``biapy_tpu_torch`` beside this script, exits 2;
2. build: the hand-written kernels from ``biapy_tpu_torch/csrc`` (nvcc,
   sm_90a), with the build seconds;
3. kernels vs plain: every kernel at every main-path shape (bf16 and f32
   for conv3d, plus one odd shape) against its plain PyTorch version, with
   kernel, plain and library times (CUDA events, median) and the bound;
4. main path: ``BiaPy(cfg).predict`` at the bench's full width (resunet
   32/64/128, BatchNorm, ELU, 128^3 patches, halo 10, bf16, uint8 drain) on
   a seeded 216^3 uint8 volume, three calls, with the launch counters
   checked at 10 conv3d, 2 pool and 2 zd2s per patch;
5. whole path vs plain path: the same model at reduced width on the card
   and on the CPU (plain versions), probabilities compared;
6. a ``{"kernels": [...]}`` line; the last line is ``{"ok": true, ...}``.

Details too long for the console go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"

# (spatial size, Cin, Cout) of the 3x3x3 convs of one 128^3 patch through
# resunet 32/64/128, in network order: 10 launches
MAIN_CONVS = [(128, 1, 32), (128, 32, 32), (64, 32, 64), (64, 64, 64), (32, 64, 128),
              (32, 128, 128), (64, 192, 64), (64, 64, 64), (128, 96, 32), (128, 32, 32)]
MAIN_POOLS = [((128, 128, 128, 32), (2, 2, 2)), ((64, 64, 64, 64), (2, 2, 2))]
MAIN_ZD2S = [((32, 64, 64, 256), 2), ((64, 128, 128, 128), 2)]
KERNEL_META = {
    "conv3d": ("biapy_tpu_torch/csrc/conv3d.cu", "biapy_tpu/ops/pallas/conv3d.py:213"),
    "pool_max_folded": ("biapy_tpu_torch/csrc/shuffle.cu", "biapy_tpu/ops/pallas/shuffle.py:232"),
    "zd2s": ("biapy_tpu_torch/csrc/shuffle.cu", "biapy_tpu/ops/pallas/shuffle.py:294"),
}


def peaks(card_name: str):
    """Dense peak rates of the card (NVIDIA data sheets): FLOP/s by dtype,
    bytes/s of device memory."""
    if "PCIe" in card_name or "PCIE" in card_name:
        return {"bfloat16": 756e12, "float32": 51e12}, 2.0e12
    return {"bfloat16": 989e12, "float32": 67e12}, 3.35e12


def bound(flops, nbytes, dtype_name, card):
    rates, bw = peaks(card)
    t_ops = flops / rates[dtype_name] * 1e3
    t_bytes = nbytes / bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, reps=10, warmup=2):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        sys.exit(2)
    if not (REPO / "biapy_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no biapy_tpu_torch package beside {__file__}", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
          f"count {torch.cuda.device_count()}")
    # the plain versions and library yardsticks run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, name


def phase_build():
    from biapy_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.lib()
    secs = time.perf_counter() - t0
    print(f"[build] kernels ready in {secs:.1f} s (cached: {build.BUILD_INFO.get('cached')})")
    for line in str(build.BUILD_INFO.get("log", "")).splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("[build] " + line.strip())
    return secs


def _check(got, ref, tol):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    ok = err <= tol * scale
    return err, err / scale, ok


def phase_kernels(card):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from biapy_tpu_torch.ops.kernels.conv3d import conv3d, conv3d_plain
    from biapy_tpu_torch.ops.kernels.shuffle import (pool_max_folded, pool_max_folded_plain,
                                                     zd2s, zd2s_plain)

    dev = torch.device("cuda:0")
    g = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    failures = []
    # float32: both sides sum the same products in float32 in other orders;
    # bfloat16: both sum bf16 products in float32 and round once, so they
    # differ by at most about one bf16 ulp of the output (2^-8 relative)
    tols = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

    conv_shapes = sorted(set(MAIN_CONVS)) + [(None, 24, 40)]
    for dt in (torch.bfloat16, torch.float32):
        for s, cin, cout in conv_shapes:
            shape = (1, s, s, s, cin) if s else (2, 13, 7, 9, cin)
            x = torch.randn(shape, generator=g).to(dev, dt)
            w = (torch.randn((3, 3, 3, cin, cout), generator=g) / (27 * cin) ** 0.5).to(dev, dt)
            got = conv3d(x, w)
            ref = conv3d_plain(x, w)
            torch.cuda.synchronize()
            err, rel, ok = _check(got, ref, tols[dt])
            ms = time_ms(lambda: conv3d(x, w))
            plain_ms = time_ms(lambda: conv3d_plain(x, w))
            xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view in channels_last_3d strides
            wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            lib_ms = time_ms(lambda: F.conv3d(xc, wc, padding=1))
            m = x.numel() // cin
            item = x.element_size()
            flops = 2 * 27 * cin * cout * m
            nbytes = (x.numel() + w.numel() + m * cout) * item
            b_ms, b_by = bound(flops, nbytes, str(dt).split(".")[-1], card)
            row = dict(kernel="conv3d", dtype=str(dt).split(".")[-1], shape=list(shape),
                       cout=cout, max_abs_err=err, max_rel_err=rel, tol=tols[dt], ok=ok,
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by, tflops=flops / ms / 1e9)
            rows.append(row)
            print(f"[kernels] conv3d {row['dtype']:8s} x{tuple(shape)} ->{cout}: "
                  f"err {err:.3g} (rel {rel:.3g}, tol {tols[dt]}) {'ok' if ok else 'FAIL'} | "
                  f"kernel {ms:.3f} ms ({row['tflops']:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
                  f"F.conv3d {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
            if not ok:
                failures.append(row)
            del x, w, got, ref

    for dt in (torch.bfloat16, torch.float32):
        for shape, win in MAIN_POOLS:
            x = torch.randn(shape, generator=g).to(dev, dt)
            got = pool_max_folded(x, win)
            ref = pool_max_folded_plain(x, win)
            torch.cuda.synchronize()
            ok = torch.equal(got, ref)
            err = (got.float() - ref.float()).abs().max().item()
            ms = time_ms(lambda: pool_max_folded(x, win))
            plain_ms = time_ms(lambda: pool_max_folded_plain(x, win))
            x5 = x.view(1, *shape).permute(0, 4, 1, 2, 3)
            lib_ms = time_ms(lambda: F.max_pool3d(x5, win, stride=win))
            nbytes = (x.numel() + got.numel()) * x.element_size()
            b_ms, b_by = bound(0, nbytes, str(dt).split(".")[-1], card)
            row = dict(kernel="pool_max_folded", dtype=str(dt).split(".")[-1], shape=list(shape),
                       max_abs_err=err, tol=0.0, ok=ok, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       gbps=nbytes / ms / 1e6)
            rows.append(row)
            print(f"[kernels] pool_max_folded {row['dtype']:8s} {tuple(shape)}: exact "
                  f"{'ok' if ok else 'FAIL'} | kernel {ms:.3f} ms ({row['gbps']:.0f} GB/s), "
                  f"plain {plain_ms:.3f} ms, F.max_pool3d {lib_ms:.3f} ms, bound {b_ms:.3f} ms")
            if not ok:
                failures.append(row)
        for shape, sz in MAIN_ZD2S:
            x = torch.randn(shape, generator=g).to(dev, dt)
            got = zd2s(x, sz)
            ref = zd2s_plain(x, sz)
            torch.cuda.synchronize()
            ok = torch.equal(got, ref)
            ms = time_ms(lambda: zd2s(x, sz))
            plain_ms = time_ms(lambda: zd2s_plain(x, sz))
            r, h, w, szc = shape
            lib_ms = time_ms(lambda: x.reshape(r, h, w, sz, szc // sz).permute(0, 3, 1, 2, 4)
                             .contiguous())
            nbytes = 2 * x.numel() * x.element_size()
            b_ms, b_by = bound(0, nbytes, str(dt).split(".")[-1], card)
            row = dict(kernel="zd2s", dtype=str(dt).split(".")[-1], shape=list(shape),
                       max_abs_err=0.0 if ok else float("nan"), tol=0.0, ok=ok, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       gbps=nbytes / ms / 1e6)
            rows.append(row)
            print(f"[kernels] zd2s {row['dtype']:8s} {tuple(shape)} sz={sz}: exact "
                  f"{'ok' if ok else 'FAIL'} | kernel {ms:.3f} ms ({row['gbps']:.0f} GB/s), "
                  f"plain {plain_ms:.3f} ms, permute().contiguous() {lib_ms:.3f} ms, "
                  f"bound {b_ms:.3f} ms")
            if not ok:
                failures.append(row)
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"{len(failures)} kernel checks failed: {failures}")
    return rows


def _main_cfg():
    """The bench's job (bench.py build()): resunet 32/64/128, BatchNorm, ELU,
    128^3 patches, halo 10, overlap 0, bf16 (REDUCE_MEMORY), uint8 drain."""
    return {
        "PROBLEM": {"TYPE": "SEMANTIC_SEG", "NDIM": "3D"},
        "MODEL": {"ARCHITECTURE": "resunet", "FEATURE_MAPS": [32, 64, 128],
                  "DROPOUT_VALUES": [0.0, 0.0, 0.0], "Z_DOWN": [2, 2, 2],
                  "YX_DOWN": [2, 2, 2], "CONV_LAYERS": [2, 2, 2],
                  "NORMALIZATION": "bn", "ACTIVATION": "elu"},
        "DATA": {"PATCH_SIZE": [128, 128, 128, 1],
                 "TEST": {"PADDING": [10, 10, 10], "OVERLAP": [0.0, 0.0, 0.0]}},
        "TRAIN": {"ENABLE": True, "BATCH_SIZE": 1},
        "TEST": {"ENABLE": True, "REDUCE_MEMORY": True, "OUTPUT_QUANT_UINT8": True},
    }


def _random_bn_stats(model, seed):
    """Seeded, non-trivial BatchNorm running statistics (the weights come
    from the model's own seeded initialisation)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            vals = torch.rand(buf.shape, generator=g)
            buf.copy_(vals * 0.4 - 0.2 if name.endswith("mean") else vals + 0.5)


def phase_main_path():
    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy
    from biapy_tpu_torch.ops.kernels import build

    job = BiaPy(_main_cfg(), result_dir=str(OUT_DIR), name="chip_smoke", silent=True,
                check_data_paths=False)
    job._build_workflow()
    job.workflow.prepare_model()
    _random_bn_stats(job.workflow.model, seed=0)
    n_params = sum(p.numel() for p in job.workflow.model.parameters())
    vol = np.random.default_rng(0).integers(0, 256, (216, 216, 216), dtype=np.uint8)
    n_patches = 8  # (216 / (128 - 2*10))^3

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    secs = []
    out = None
    for _ in range(3):
        t0 = time.perf_counter()
        out = job.predict(vol)[0]["pred"]  # returns host numpy: synchronised
        secs.append(time.perf_counter() - t0)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"conv3d": 10, "pool_max_folded": 2, "zd2s": 2}
    for k, per_patch in want.items():
        if launches[k] != 3 * n_patches * per_patch:
            raise AssertionError(f"{k}: {launches[k]} launches in 3 predict calls, want "
                                 f"{3 * n_patches * per_patch} ({per_patch} per patch)")
    if out.shape != (216, 216, 216, 1):
        raise AssertionError(f"prediction shape {out.shape}")
    if not np.all(np.isfinite(out)) or not np.array_equal(out, np.round(out)):
        raise AssertionError("prediction is not finite uint8-valued")
    p = out / 255.0
    if p.min() < 0.0 or p.max() > 1.0:
        raise AssertionError(f"probabilities outside [0, 1]: {p.min()}..{p.max()}")
    steady = secs[1:]
    mvox = [216 ** 3 / s / 1e6 for s in steady]
    print(f"[main] resunet 32/64/128 ({n_params:,} params), 216^3 uint8, 8 patches of 128^3 "
          f"per call, bf16 + uint8 drain: call seconds {[round(s, 4) for s in secs]}")
    print(f"[main] calls 2-3: {[round(m, 3) for m in mvox]} Mvox/s, "
          f"{[round(s / n_patches, 4) for s in steady]} s/patch, peak memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}; p mean {p.mean():.4f}")

    # where the time goes: one more call under the profiler (not in the
    # numbers above), device time summed by kernel name
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        job.predict(vol)
        prof_wall = time.perf_counter() - t0
    table = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): a host op's device time
        # repeats that of the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            table.append((ev.key, dev_us / 1e3, ev.count))
    table.sort(key=lambda r: -r[1])
    dev_total = sum(r[1] for r in table)
    print(f"[profile] one call: wall {prof_wall:.3f} s, device busy {dev_total / 1e3:.3f} s "
          f"({100 * dev_total / 1e3 / prof_wall:.1f}% of wall)")
    for key, ms, cnt in table[:12]:
        print(f"[profile] {ms:10.2f} ms  {cnt:5d}x  {key[:90]}")
    return dict(call_seconds=secs, mvox_per_s=mvox, s_per_patch=[s / n_patches for s in steady],
                peak_bytes=peak, launches=launches, n_params=n_params,
                profile=dict(wall_s=prof_wall, device_ms=dev_total,
                             top=[dict(name=k, ms=m, count=c) for k, m, c in table[:40]]))


def phase_whole_vs_plain():
    """The port at reduced width on the card (kernels) and on the CPU (plain
    versions), same weights, same volume, float32."""
    import numpy as np
    import torch

    from biapy_tpu_torch import BiaPy

    cfg = _main_cfg()
    cfg["MODEL"]["FEATURE_MAPS"] = [8, 16, 32]
    cfg["DATA"]["PATCH_SIZE"] = [32, 32, 32, 1]
    cfg["DATA"]["TEST"] = {"PADDING": [4, 4, 4], "OVERLAP": [0.25, 0.25, 0.25]}
    cfg["TEST"] = {"ENABLE": True, "REDUCE_MEMORY": False, "OUTPUT_QUANT_UINT8": False}
    vol = np.random.default_rng(1).integers(0, 256, (40, 37, 45), dtype=np.uint8)
    preds = []
    for dev in ("cuda:0", "cpu"):
        job = BiaPy(cfg, result_dir=str(OUT_DIR), name=f"chip_smoke_small_{dev[:3]}",
                    silent=True, check_data_paths=False, device=dev)
        job._build_workflow()
        job.workflow.prepare_model()  # seeded init: the same weights on both devices
        _random_bn_stats(job.workflow.model, seed=1)
        preds.append(job.predict(vol)[0]["pred"])
    diff = float(np.abs(preds[0] - preds[1]).max())
    tol = 1e-4  # float32 sums in other orders on the two devices
    print(f"[whole-vs-plain] fm 8/16/32, patch 32^3, volume (40, 37, 45), f32: "
          f"max |p_card - p_cpu| = {diff:.3g} (tol {tol})")
    if not diff <= tol:
        raise AssertionError(f"card and CPU paths differ by {diff} > {tol}")
    return diff


def summarise(rows, main):
    """One entry per kernel: per-patch sums over its main-path launches, in
    the main path's dtype (bf16)."""
    kernels = []
    per_patch_shapes = {
        "conv3d": [dict(shape=[1, s, s, s, cin], cout=cout) for s, cin, cout in MAIN_CONVS],
        "pool_max_folded": [dict(shape=list(s)) for s, _ in MAIN_POOLS],
        "zd2s": [dict(shape=list(s)) for s, _ in MAIN_ZD2S],
    }
    for name, shapes in per_patch_shapes.items():
        picked = []
        for want in shapes:
            for r in rows:
                if (r["kernel"] == name and r["dtype"] == "bfloat16"
                        and r["shape"] == want["shape"] and r.get("cout") == want.get("cout")):
                    picked.append(r)
                    break
        assert len(picked) == len(shapes), name
        ops_ms = sum(r["bound_ms"] for r in picked if r["bound_by"] == "operations")
        byte_ms = sum(r["bound_ms"] for r in picked if r["bound_by"] == "bytes")
        src, replaces = KERNEL_META[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=main["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            ms=sum(r["ms"] for r in picked), plain_ms=sum(r["plain_ms"] for r in picked),
            bound_ms=sum(r["bound_ms"] for r in picked),
            bound_by="operations" if ops_ms >= byte_ms else "bytes",
            library_ms=sum(r["library_ms"] for r in picked)))
    return kernels


def main():
    smi, name = phase_environment()
    build_s = phase_build()
    rows = phase_kernels(smi)
    main_res = phase_main_path()
    diff = phase_whole_vs_plain()
    kernels = summarise(rows, main_res)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, build_seconds=build_s, kernel_rows=rows, main=main_res,
        whole_vs_plain_max_abs=diff, kernels=kernels), indent=1))
    import torch

    print("(kernels: ms, plain_ms, bound_ms and library_ms are per-patch sums over each "
          "kernel's main-path launches, bf16; launches are the 3 main-path calls')")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
