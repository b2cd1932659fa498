"""Every tile variant of the port's tensor-core conv3d kernels at the 3D
templates' and the main path's shapes, on the card: which variant
``biapy_conv3d_k3_wgmma``'s dispatcher (bf16) and
``biapy_conv3d_k3_tf32x3``'s (``--dtype float32``) should pick.

    python tools/torch_conv3d_tiles.py [--dtype float32] [--out conv3d_tiles.json]

For float32 (``TF32_VARIANTS``: BN, KC, MINB, NWG) the variants read the
TF32 pair of x that ``split_x`` writes (its kernel's time is ``split_ms``:
add it) and the wrapper's split packs.

It compiles ``biapy_tpu_torch/csrc/conv3d.cu`` once more (nvcc, sm_90a, into
a temporary directory) with one extra entry point that launches the kernel
instance named by an index (``VARIANTS``: BN, KC, MINB, NWG), and times, at
each shape, the wrapper (``conv3d_fwd``: the dispatcher's choice, the
weight pack and any channel pad included), the channel pad alone, every
variant whose tile holds Cout (its output checked against the wrapper's)
and ``F.conv3d``. Where 8 does not divide Cin the variants read the
channel-padded copy of x (add the pad's time). Device-side times:
``chip_smoke.py::device_ms`` over 30 back-to-back calls (queued behind a
spin kernel that outlasts their host work) after three warm-up calls. The
card's name and power limit are printed first.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# (BN, KC, MINB, NWG): instances of conv3d_k3_wgmma_kernel
VARIANTS = [(8, 32, 2, 2), (16, 32, 2, 2),
            (32, 32, 2, 2), (32, 32, 1, 2), (32, 32, 2, 4), (32, 64, 2, 2), (32, 64, 2, 4),
            (40, 32, 2, 2), (40, 32, 1, 2), (40, 32, 2, 4), (40, 32, 1, 4),
            (48, 32, 2, 2), (48, 32, 1, 2), (48, 32, 1, 4), (48, 64, 2, 2), (48, 64, 1, 4),
            (64, 32, 2, 2), (64, 32, 1, 2), (64, 32, 1, 4), (64, 64, 2, 2), (64, 64, 1, 2),
            (64, 64, 1, 4), (96, 32, 2, 2), (96, 32, 1, 4), (128, 32, 2, 2), (128, 32, 1, 4),
            (192, 32, 1, 2), (256, 32, 1, 2)]
# (BN, KC, MINB, NWG): instances of conv3d_k3_tf32x3_kernel
TF32_VARIANTS = ([(bn, kc, 1, 2) for bn in (8, 16, 32, 40, 48, 64) for kc in (16, 32)]
                 + [(96, 16, 1, 2), (128, 16, 1, 2), (32, 16, 2, 2), (40, 16, 2, 2),
                    (48, 16, 1, 4), (64, 16, 1, 4)])


def _build(tmp: Path, f32: bool) -> ctypes.CDLL:
    """The library of one entry: ``tiles_tf32`` (``f32``) or ``tiles_tc``."""
    cases = "\n".join(f"    case {i}: return launch_tc<{bn}, {kc}, {minb}, {nwg}>(x, wp, y, n, D, H, "
                      f"W, Cin, Cout, s);" for i, (bn, kc, minb, nwg) in enumerate(VARIANTS))
    cases32 = "\n".join(
        f"    case {i}: return launch_tf32x3<{bn}, {kc}, {minb}, {nwg}>(xh, xl, wh, wl, y, n, D, H, "
        f"W, Cin, Cout, s);" for i, (bn, kc, minb, nwg) in enumerate(TF32_VARIANTS))
    src = tmp / "tiles.cu"
    tc = f'''extern "C" int tiles_tc(int v, const void* x, const void* wp, void* y, int n, int D, int H,
                        int W, int Cin, int Cout, void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {{
{cases}
  }}
  return (int)cudaErrorInvalidValue;
}}
'''
    tf32 = f'''extern "C" int tiles_tf32(int v, const void* xh, const void* xl, const void* wh, const void* wl,
                          void* y, int n, int D, int H, int W, int Cin, int Cout,
                          void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {{
{cases32}
  }}
  return (int)cudaErrorInvalidValue;
}}
'''
    src.write_text(f'#include "{REPO / "biapy_tpu_torch" / "csrc" / "conv3d.cu"}"\n'
                   + (tf32 if f32 else tc))
    so = tmp / "tiles.so"
    from biapy_tpu_torch.ops.kernels import build

    run = subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                          "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared",
                          str(src), "-ldl", "-o", str(so)], capture_output=True, text=True)
    # registers and spills of every instance (the tensor-core ones by name)
    print("\n".join(line for line in run.stderr.splitlines()
                    if "tf32x3" in line or "wgmma_kernel" in line or "spill" in line
                    or "Used" in line or "C75" in line)[-12000:], flush=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed:\n{run.stderr[-6000:]}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    if f32:
        lib.tiles_tf32.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.tiles_tf32.restype = i
    else:
        lib.tiles_tc.argtypes = [i, p, p, p, i, i, i, i, i, i, p]
        lib.tiles_tc.restype = i
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from biapy_tpu_torch.ops.kernels import conv3d as kconv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False

    def ms(fn):
        for _ in range(3):
            fn()
        return chip_smoke.device_ms(fn, 30)[0]

    fwd, dx = chip_smoke._template_conv_rows()
    shapes = list(dict.fromkeys(fwd[1:] + dx))
    shapes += [((1, s, s, s), cin, cout) for s, cin, cout in
               sorted(set(chip_smoke.MAIN_CONVS[1:] + chip_smoke.DX_CONVS))]
    f32 = args.dtype == "float32"
    dt = torch.float32 if f32 else torch.bfloat16
    g = torch.Generator().manual_seed(0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        lib = _build(Path(tmp), f32)
        for vol, cin, cout in shapes:
            x = torch.randn(vol + (cin,), generator=g).to("cuda:0", dt)
            w = (torch.randn((3, 3, 3, cin, cout), generator=g) / (27 * cin) ** 0.5).to(
                "cuda:0", dt)
            xk, wp = (x if f32 else kconv.pad_channels(x)), kconv.pack_weights(w)
            ref = kconv.conv3d_plain(x, w) if f32 else kconv.conv3d_fwd(x, w)
            xc = x.permute(0, 4, 1, 2, 3)
            wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            row = dict(shape=list(vol) + [cin], cout=cout,
                       wrapper_ms=ms(lambda: kconv.conv3d_fwd(x, w)),
                       pad_ms=ms(lambda: kconv.pad_channels(x)) if cin % 8 and not f32 else 0.0,
                       library_ms=ms(lambda: F.conv3d(xc, wc, padding=1)), variants={})
            if f32:
                (xh, xl), (wh, wl) = kconv.split_x(x), kconv.tf32_split(wp)
                row["split_ms"] = ms(lambda: kconv.split_x(x))
            cout_p = -(-cout // 8) * 8
            stream = torch.cuda.current_stream().cuda_stream
            for v, var in enumerate(TF32_VARIANTS if f32 else VARIANTS):
                bn = var[0]
                if bn < min(cout_p, 64 if f32 else 256) or bn > 2 * cout_p + 8:
                    continue
                y = torch.empty_like(ref)
                if f32:
                    def run(v=v, y=y):
                        return lib.tiles_tf32(v, xh.data_ptr(), xl.data_ptr(), wh.data_ptr(),
                                              wl.data_ptr(), y.data_ptr(), *vol, xh.shape[-1],
                                              cout, stream)
                else:
                    def run(v=v, y=y):
                        return lib.tiles_tc(v, xk.data_ptr(), wp.data_ptr(), y.data_ptr(), *vol,
                                            xk.shape[-1], cout, stream)
                if run() != 0:  # KC = 64 takes Cin % 64 == 0 only
                    continue
                torch.cuda.synchronize()
                tol = 1e-4 * max(1.0, ref.abs().max().item()) if f32 else 0.05
                if (y.float() - ref.float()).abs().max() > tol:
                    raise AssertionError(f"{vol} {cin}->{cout}: variant {var} disagrees")
                row["variants"][str(var)] = ms(run)
            rows.append(row)
            best = min(row["variants"].items(), key=lambda kv: kv[1])
            print(f"{tuple(vol)} {cin:3d} -> {cout:3d}: wrapper {row['wrapper_ms']:.4f} ms, pad "
                  f"{row['pad_ms']:.4f} ms, best kernel {best[0]} {best[1]:.4f} ms, F.conv3d "
                  f"{row['library_ms']:.4f} ms"
                  + (f", split {row['split_ms']:.4f} ms; " + ", ".join(
                      f"{k} {t:.4f}" for k, t in sorted(row["variants"].items(),
                                                         key=lambda kv: kv[1]))
                     if f32 else ""), flush=True)
            del x, w, xk, wp, ref, xc, wc
    if args.out:
        args.out.write_text(json.dumps(dict(card=smi, dtype=args.dtype, rows=rows,
                                            variants=TF32_VARIANTS if f32 else VARIANTS)))


if __name__ == "__main__":
    main()
