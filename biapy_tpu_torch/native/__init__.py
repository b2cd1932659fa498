"""ctypes bindings for the native host ops (``hostops.cpp``), copied from
the JAX package's ``native/__init__.py``: marker-controlled watershed,
connected components, hole filling, the threaded exact distance transform
and the union-find relabel.

The source is compiled at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``biapy_tpu_torch/_build/host-<hash of the source and
flags>/_hostops.so`` (written to a temporary file and renamed, so
concurrent first uses never load a half-written library; a changed source
gets a new directory).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "hostops.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None


def _build() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    out_dir = _BUILD_DIR / f"host-{h.hexdigest()[:16]}"
    so = out_dir / "_hostops.so"
    if so.exists():
        return str(so)
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return str(so)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.watershed.argtypes = [f32p, i32p, u8p, i64p, ctypes.c_int]
    lib.watershed.restype = None
    lib.connected_components.argtypes = [u8p, i32p, i64p, ctypes.c_int]
    lib.connected_components.restype = ctypes.c_int32
    lib.fill_holes.argtypes = [u8p, i64p, ctypes.c_int]
    lib.fill_holes.restype = None
    lib.union_find_merge.argtypes = [i32p, i32p, ctypes.c_int64, i32p, ctypes.c_int64]
    lib.union_find_merge.restype = None
    lib.edt.argtypes = [u8p, f32p, i64p, f32p, ctypes.c_int, ctypes.c_int]
    lib.edt.restype = None
    _lib = lib
    return lib


def _shape_arr(a: np.ndarray):
    return (ctypes.c_int64 * a.ndim)(*a.shape)


def watershed(topography: np.ndarray, markers: np.ndarray,
              mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Marker-controlled watershed (priority flood).

    ``topography``: flood in increasing order of this map; ``markers``: int
    seed labels (0 = unlabelled); ``mask``: restrict growth to mask != 0.
    """
    lib = _load()
    topo = np.ascontiguousarray(topography, dtype=np.float32)
    labels = np.ascontiguousarray(markers, dtype=np.int32).copy()
    m = None
    if mask is not None:
        m = np.ascontiguousarray(mask != 0, dtype=np.uint8)
    lib.watershed(
        topo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if m is not None else None,
        _shape_arr(topo), topo.ndim,
    )
    return labels


def connected_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """Label face-connected components of a binary mask; returns (labels, n)."""
    lib = _load()
    m = np.ascontiguousarray(mask != 0, dtype=np.uint8)
    labels = np.zeros(m.shape, dtype=np.int32)
    n = lib.connected_components(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _shape_arr(m), m.ndim,
    )
    return labels, int(n)


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """Fill background cavities not connected to the border."""
    lib = _load()
    m = np.ascontiguousarray(mask != 0, dtype=np.uint8)
    lib.fill_holes(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _shape_arr(m), m.ndim)
    return m.astype(bool)


def edt(mask: np.ndarray, sampling=None, n_threads: int = 0) -> np.ndarray:
    """Exact Euclidean distance transform, scipy semantics (distance from
    every nonzero element to the nearest zero), float32 output.

    Felzenszwalb-Huttenlocher separable passes threaded per line — the
    first-party replacement for the reference's multi-threaded `edt` C
    extension dependency (reference pyproject.toml:28), O(n) per axis vs
    scipy's single-threaded implementation.
    """
    lib = _load()
    m = np.ascontiguousarray(mask != 0, dtype=np.uint8)
    out = np.empty(m.shape, dtype=np.float32)
    if sampling is None:
        samp = np.ones(m.ndim, dtype=np.float32)
    else:
        samp = np.asarray(np.broadcast_to(np.asarray(sampling, np.float32),
                                          (m.ndim,)), dtype=np.float32).copy()
    if n_threads <= 0:
        n_threads = min(16, os.cpu_count() or 1)
    lib.edt(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _shape_arr(m),
        samp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        m.ndim, int(n_threads),
    )
    return out


def union_find_merge(edges: np.ndarray, n_labels: int) -> np.ndarray:
    """Canonical relabel map from merge edges (k, 2) over labels 1..n."""
    lib = _load()
    e = np.ascontiguousarray(edges, dtype=np.int32).reshape(-1, 2)
    a = np.ascontiguousarray(e[:, 0])
    b = np.ascontiguousarray(e[:, 1])
    remap = np.zeros(n_labels + 1, dtype=np.int32)
    lib.union_find_merge(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(e), remap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_labels,
    )
    return remap
