"""Build and load the port's hand-written CUDA kernels.

The sources in ``biapy_tpu_torch/csrc/*.cu`` expose a plain C interface.
At first use they are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together, then one link) into a shared library
under ``biapy_tpu_torch/_build/<hash of the sources and flags>/``, and
loaded with ``ctypes``. A changed source gets a new directory, so a stale
library is never loaded. A failed build raises.

Every wrapper counts its launches in ``LAUNCHES`` (one per kernel launch,
nothing else), so a run can show that its path went through the kernels;
``CONV3D_ROUTES`` splits conv3d's count by the kernel that ran, and
``SHUFFLE_ROUTES`` the pool's, its backward's and zcat's by the access
width.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> launches since the last reset
# (pad_channels: the channel-padded copy of x that conv3d's bf16
# tensor-core route takes where 8 does not divide Cin; tf32_split: the TF32
# pair of x that its 3xTF32 route takes; kernels of their own)
LAUNCHES: Dict[str, int] = {"conv3d": 0, "pad_channels": 0, "tf32_split": 0,
                            "pool_max_folded": 0, "pool_max_folded_bwd": 0, "zd2s": 0,
                            "zs2d": 0, "zcat": 0, "zcat_bwd": 0}

# conv3d's launches by route (``conv3d.conv3d_route``): "wgmma" (bf16,
# tensor cores), "stem" (Cin below the stem cut, CUDA cores) or "tf32x3"
# (float32, tensor cores); the three add up to LAUNCHES["conv3d"]
CONV3D_ROUTES: Dict[str, int] = {"wgmma": 0, "stem": 0, "tf32x3": 0}

# the pool's, its backward's and zcat's launches by route
# (``shuffle.pool_route``, ``shuffle.zcat_route``): "channels16" and "rows16"
# (16-byte vectors) or "scalar" (one element per access); each adds up to
# its kernel's LAUNCHES
SHUFFLE_ROUTES: Dict[str, Dict[str, int]] = {
    k: {"channels16": 0, "rows16": 0, "scalar": 0}
    for k in ("pool_max_folded", "pool_max_folded_bwd", "zcat")}

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, CONV3D_ROUTES, *SHUFFLE_ROUTES.values()):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source set has no library yet) and
    return the library's path."""
    srcs = _sources()
    out_dir = BUILD_DIR / _digest(srcs)
    lib_path = out_dir / "libbiapy_kernels.so"
    if lib_path.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("cached", True)
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for s in srcs:
            obj = Path(tmp) / (s.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
            procs.append((s, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
        logs = []
        failed = []
        for s, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {s.name}\n{out}")
            if p.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib_path.name
        # -ldl: conv3d.cu looks cuTensorMapEncodeTiled up in libcuda with dlsym
        link = subprocess.run([nvcc, "-shared", *[str(o) for _, o, _ in procs], "-ldl", "-o",
                               str(tmp_lib)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp_lib, lib_path)
        (out_dir / "build.log").write_text("\n".join(logs))
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False, log="\n".join(logs))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.biapy_conv3d_k3_tf32x3.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        handle.biapy_conv3d_k3_wgmma.argtypes = [p, p, p, i, i, i, i, i, i, p]
        handle.biapy_conv3d_k3_stem.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        handle.biapy_pad_channels.argtypes = [p, p, ctypes.c_longlong, i, p]
        handle.biapy_tf32_split.argtypes = [p, p, p, ctypes.c_longlong, i, p]
        handle.biapy_pool_max_folded.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p]
        handle.biapy_pool_max_folded_bwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        handle.biapy_zd2s.argtypes = [p, p, i, i, i, i, i, i, p]
        handle.biapy_zs2d.argtypes = [p, p, i, i, i, i, i, i, p]
        handle.biapy_zcat.argtypes = [p, p, i, i, i, i, i, i, i, i, p]
        handle.biapy_zcat_bwd.argtypes = [p, p, i, i, i, i, i, i, i, p]
        for fn in (handle.biapy_conv3d_k3_tf32x3, handle.biapy_conv3d_k3_wgmma,
                   handle.biapy_conv3d_k3_stem, handle.biapy_pad_channels,
                   handle.biapy_tf32_split,
                   handle.biapy_pool_max_folded,
                   handle.biapy_pool_max_folded_bwd, handle.biapy_zd2s, handle.biapy_zs2d,
                   handle.biapy_zcat, handle.biapy_zcat_bwd):
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_rc(rc: int, name: str) -> None:
    """Raises unless the launcher returned 0 (a positive code is a
    cudaError, a negative one the launcher's own: see its source)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {rc}")


def check_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {t.device}; the kernel takes CUDA tensors "
                         "(CPU tensors take the plain version)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
