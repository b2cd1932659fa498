"""Minimal self-contained NIfTI-1 reader/writer (.nii / .nii.gz), copied from
the JAX package's ``data/nifti.py``.

Reference analog: the reference reads NIfTI volumes through nibabel
(data_manipulation.py imread dispatch); this build is dependency-free, like
its TIFF and Zarr codecs. Covers the single-file NIfTI-1 layout: 348-byte
header, optional extensions, raw data at ``vox_offset``; scl_slope/inter
scaling applied on read when meaningful.
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> np.ndarray:
    """Read a NIfTI-1 volume; returns the data array in on-disk (Fortran)
    axis order transposed to C order (x fastest on disk -> last axis here)."""
    with _open(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"Truncated NIfTI header in {path}")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        if sizeof_hdr != 348:
            if struct.unpack(">i", hdr[0:4])[0] == 348:
                raise ValueError("Big-endian NIfTI not supported")
            raise ValueError(f"Not a NIfTI-1 file: {path}")
        magic = hdr[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise ValueError(f"Bad NIfTI magic in {path}: {magic!r}")
        dim = struct.unpack("<8h", hdr[40:56])
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1: 1 + ndim])
        datatype = struct.unpack("<h", hdr[70:72])[0]
        if datatype not in _DTYPES:
            raise ValueError(f"Unsupported NIfTI datatype code {datatype}")
        dtype = np.dtype(_DTYPES[datatype])
        vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
        scl_slope = struct.unpack("<f", hdr[112:116])[0]
        scl_inter = struct.unpack("<f", hdr[116:120])[0]
        f.seek(max(vox_offset, 348))
        n = int(np.prod(shape))
        data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
    arr = data.reshape(shape, order="F")
    # disk layout is x,y,z[,t]; return z,y,x-style C order (reference keeps
    # nibabel's x,y,z then transposes through the axes-order machinery)
    arr = np.transpose(arr, tuple(reversed(range(arr.ndim))))
    if scl_slope not in (0.0, 1.0) or scl_inter not in (0.0,):
        arr = arr.astype(np.float32) * (scl_slope or 1.0) + scl_inter
    return np.ascontiguousarray(arr)


def write_nifti(path: str, data: np.ndarray) -> None:
    """Write an array as single-file NIfTI-1 (optionally gzipped)."""
    arr = np.asarray(data)
    if arr.dtype not in _CODES:
        arr = arr.astype(np.float32)
    # our in-memory order is z,y,x[,c]; disk wants x fastest (Fortran x,y,z)
    disk = np.transpose(arr, tuple(reversed(range(arr.ndim))))
    dim = [disk.ndim] + list(disk.shape) + [1] * (7 - disk.ndim)
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[disk.dtype])
    struct.pack_into("<h", hdr, 72, disk.dtype.itemsize * 8)  # bitpix
    pixdim = [1.0] * 8
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    hdr[344:348] = b"n+1\x00"
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.asfortranarray(disk).tobytes(order="F"))
