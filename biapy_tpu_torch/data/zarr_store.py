"""Minimal Zarr v2 / N5 store (read/write), dependency-free, copied from the
JAX package's ``data/zarr_store.py``: the two packages write the same
``.zarray`` and chunk bytes and read each other's stores.

The reference uses the ``zarr`` package for chunked volume IO
(reference: biapy/data/data_3D_manipulation.py:210-340, chunked generators).
That package is not available here, so this module implements the Zarr v2
on-disk format directly: a directory with a ``.zarray`` JSON metadata file
and one file per chunk, named by chunk grid coordinates.

Supported compressors: ``null`` (raw), ``zlib``, ``gzip``. Chunks written by
this store default to zlib. Blosc-compressed stores (the zarr-python default)
are detected and rejected with a clear error.

Concurrency contract (same as the reference relies on): concurrent writers
must own **disjoint chunk sets**; a chunk file is written atomically via
rename so readers never observe partial chunks.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np


def _encode(data: bytes, compressor: Optional[Dict]) -> bytes:
    if compressor is None:
        return data
    cid = compressor.get("id")
    if cid in ("zlib", "gzip"):
        return zlib.compress(data, compressor.get("level", 1))
    raise ValueError(f"Unsupported zarr compressor for writing: {cid}")


def _decode(data: bytes, compressor: Optional[Dict]) -> bytes:
    if compressor is None:
        return data
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.decompress(data)
    if cid == "gzip":
        import gzip as _gz

        return _gz.decompress(data)
    if cid == "blosc":
        raise ValueError(
            "This store cannot read blosc-compressed zarr arrays. "
            "Re-write the array with compressor 'zlib' or none."
        )
    raise ValueError(f"Unsupported zarr compressor: {cid}")


class ZarrArray:
    """A chunked N-D array backed by a Zarr v2 directory.

    Supports numpy-style slicing for read (``arr[10:20, :, 5]``) and
    assignment for write. Reads and writes go chunk-by-chunk, touching only
    the chunks that overlap the request — a terabyte array is never
    materialised.
    """

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        meta_path = os.path.join(path, ".zarray")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"Only zarr v2 supported, got format {meta.get('zarr_format')}")
        if meta.get("order", "C") != "C":
            raise ValueError("Only C-order zarr arrays supported")
        if meta.get("filters"):
            raise ValueError("Zarr filters not supported")
        self.shape: Tuple[int, ...] = tuple(meta["shape"])
        self.chunks: Tuple[int, ...] = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.compressor: Optional[Dict] = meta.get("compressor")
        self.fill_value = meta.get("fill_value", 0)
        if self.fill_value is None:
            self.fill_value = 0
        self.sep = meta.get("dimension_separator", ".")
        self._meta = meta

    # -- creation ----------------------------------------------------------
    @staticmethod
    def create(
        path: str,
        shape: Sequence[int],
        chunks: Sequence[int],
        dtype: Union[str, np.dtype],
        compressor: Optional[Dict] = None,
        fill_value: Union[int, float] = 0,
        overwrite: bool = False,
        dimension_separator: str = ".",
    ) -> "ZarrArray":
        if os.path.exists(os.path.join(path, ".zarray")):
            if not overwrite:
                existing = ZarrArray(path, mode="r+")
                if (tuple(existing.shape) != tuple(int(s) for s in shape)
                        or np.dtype(existing.dtype) != np.dtype(dtype)):
                    # silently reusing a mismatched array would clip writes
                    # to the old shape and keep stale chunk data
                    raise ValueError(
                        f"Zarr array at {path} already exists with shape "
                        f"{tuple(existing.shape)}/dtype {existing.dtype}, "
                        f"but shape {tuple(shape)}/dtype {np.dtype(dtype)} "
                        "was requested — pass overwrite=True or remove it")
                return existing
            # overwrite: drop stale chunk files from the previous array —
            # a different chunk grid would otherwise read them back as data
            import shutil

            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
        dt = np.dtype(dtype)
        meta = {
            "zarr_format": 2,
            "shape": list(int(s) for s in shape),
            "chunks": list(int(c) for c in chunks),
            "dtype": dt.str,
            "compressor": compressor,
            "fill_value": fill_value,
            "order": "C",
            "filters": None,
            "dimension_separator": dimension_separator,
        }
        tmp = tempfile.NamedTemporaryFile("w", dir=path, delete=False, suffix=".tmp")
        json.dump(meta, tmp)
        tmp.close()
        os.replace(tmp.name, os.path.join(path, ".zarray"))
        return ZarrArray(path, mode="r+")

    # -- helpers -------------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def nchunks(self) -> Tuple[int, ...]:
        return tuple(-(-s // c) for s, c in zip(self.shape, self.chunks))

    def _chunk_path(self, coords: Tuple[int, ...]) -> str:
        name = self.sep.join(str(c) for c in coords)
        return os.path.join(self.path, name)

    def _read_chunk(self, coords: Tuple[int, ...]) -> np.ndarray:
        p = self._chunk_path(coords)
        if not os.path.exists(p):
            return np.full(self.chunks, self.fill_value, dtype=self.dtype)
        with open(p, "rb") as f:
            raw = _decode(f.read(), self.compressor)
        return np.frombuffer(raw, dtype=self.dtype).reshape(self.chunks).copy()

    def _write_chunk(self, coords: Tuple[int, ...], data: np.ndarray) -> None:
        if self.mode == "r":
            raise PermissionError("ZarrArray opened read-only")
        raw = _encode(np.ascontiguousarray(data, dtype=self.dtype).tobytes(), self.compressor)
        p = self._chunk_path(coords)
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".part")
        with os.fdopen(fd, "wb") as f:
            f.write(raw)
        os.replace(tmp, p)

    def _normalize_key(self, key) -> Tuple[Tuple[int, int], ...]:
        """Turn a slicing key into per-dim (start, stop); ints keep a size-1 dim
        marked for squeezing (returned separately)."""
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            idx = key.index(Ellipsis)
            fill = self.ndim - (len(key) - 1)
            key = key[:idx] + (slice(None),) * fill + key[idx + 1 :]
        key = key + (slice(None),) * (self.ndim - len(key))
        ranges = []
        squeeze = []
        for d, k in enumerate(key):
            n = self.shape[d]
            if isinstance(k, (int, np.integer)):
                i = int(k)
                if i < 0:
                    i += n
                if not (0 <= i < n):
                    raise IndexError(f"index {k} out of bounds for dim {d} (size {n})")
                ranges.append((i, i + 1))
                squeeze.append(d)
            elif isinstance(k, slice):
                start, stop, step = k.indices(n)
                if step != 1:
                    raise IndexError("Only step-1 slices supported")
                ranges.append((start, max(start, stop)))
            else:
                raise IndexError(f"Unsupported index type: {type(k)}")
        return tuple(ranges), tuple(squeeze)

    def _overlapping_chunks(self, ranges):
        """Yield (chunk_coords, chunk_slice_within, out_slice) for all chunks
        overlapping the requested per-dim ranges."""
        lo = [r[0] // c for r, c in zip(ranges, self.chunks)]
        hi = [max(r[0], r[1] - 1) // c for r, c in zip(ranges, self.chunks)]

        def rec(d, coords):
            if d == self.ndim:
                yield tuple(coords)
                return
            for i in range(lo[d], hi[d] + 1):
                yield from rec(d + 1, coords + [i])

        if any(r[1] <= r[0] for r in ranges):
            return
        for coords in rec(0, []):
            cs, os_ = [], []
            for d, ci in enumerate(coords):
                c0 = ci * self.chunks[d]
                s = max(ranges[d][0], c0)
                e = min(ranges[d][1], c0 + self.chunks[d])
                cs.append(slice(s - c0, e - c0))
                os_.append(slice(s - ranges[d][0], e - ranges[d][0]))
            yield coords, tuple(cs), tuple(os_)

    # -- numpy protocol ------------------------------------------------------
    def __getitem__(self, key) -> np.ndarray:
        ranges, squeeze = self._normalize_key(key)
        out_shape = tuple(r[1] - r[0] for r in ranges)
        out = np.full(out_shape, self.fill_value, dtype=self.dtype)
        for coords, cs, osl in self._overlapping_chunks(ranges):
            out[osl] = self._read_chunk(coords)[cs]
        if squeeze:
            out = np.squeeze(out, axis=tuple(squeeze))
        return out

    def __setitem__(self, key, value) -> None:
        ranges, squeeze = self._normalize_key(key)
        req_shape = tuple(r[1] - r[0] for r in ranges)
        value = np.asarray(value, dtype=self.dtype)
        value = np.broadcast_to(value, tuple(s for d, s in enumerate(req_shape) if d not in squeeze))
        value = value.reshape(req_shape)
        full_chunk = self.chunks
        for coords, cs, osl in self._overlapping_chunks(ranges):
            piece = value[osl]
            covers_all = all(
                s.stop - s.start == c for s, c in zip(cs, full_chunk)
            )
            if covers_all:
                chunk = piece
            else:
                chunk = self._read_chunk(coords)
                chunk[cs] = piece
            self._write_chunk(coords, chunk)

    def __array__(self, dtype=None) -> np.ndarray:
        out = self[tuple(slice(None) for _ in self.shape)]
        return out.astype(dtype) if dtype is not None else out

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def attrs(self) -> "ZarrAttrs":
        return ZarrAttrs(self.path)


class ZarrAttrs:
    """User attributes of a zarr array/group, backed by ``.zattrs``."""

    def __init__(self, node_path: str):
        self._file = os.path.join(node_path, ".zattrs")

    def _read(self) -> Dict:
        if os.path.exists(self._file):
            with open(self._file) as f:
                return json.load(f)
        return {}

    def __getitem__(self, key: str):
        return self._read()[key]

    def get(self, key: str, default=None):
        return self._read().get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self._read()

    def __setitem__(self, key: str, value) -> None:
        d = self._read()
        d[key] = value
        tmp = tempfile.NamedTemporaryFile("w", dir=os.path.dirname(self._file), delete=False, suffix=".tmp")
        json.dump(d, tmp)
        tmp.close()
        os.replace(tmp.name, self._file)

    def keys(self):
        return self._read().keys()


class ZarrGroup:
    """A Zarr v2 group: directory with ``.zgroup``, containing arrays/groups."""

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode

    @staticmethod
    def create(path: str) -> "ZarrGroup":
        os.makedirs(path, exist_ok=True)
        meta_path = os.path.join(path, ".zgroup")
        if not os.path.exists(meta_path):
            with open(meta_path, "w") as f:
                json.dump({"zarr_format": 2}, f)
        return ZarrGroup(path, mode="r+")

    def keys(self):
        for name in sorted(os.listdir(self.path)):
            sub = os.path.join(self.path, name)
            if os.path.isdir(sub) and (
                os.path.exists(os.path.join(sub, ".zarray")) or os.path.exists(os.path.join(sub, ".zgroup"))
            ):
                yield name

    def __contains__(self, name: str) -> bool:
        sub = os.path.join(self.path, name.replace("/", os.sep))
        return os.path.isdir(sub)

    def __getitem__(self, name: str) -> Union[ZarrArray, "ZarrGroup"]:
        sub = os.path.join(self.path, name.replace("/", os.sep))
        if os.path.exists(os.path.join(sub, ".zarray")):
            return ZarrArray(sub, self.mode)
        if os.path.exists(os.path.join(sub, ".zgroup")):
            return ZarrGroup(sub, self.mode)
        raise KeyError(f"'{name}' not found in zarr store {self.path}")

    def create_dataset(self, name: str, **kwargs) -> ZarrArray:
        # Materialize intermediate groups so nested paths stay valid zarr.
        parts = name.split("/")
        cur = self.path
        for p in parts[:-1]:
            cur = os.path.join(cur, p)
            ZarrGroup.create(cur)
        return ZarrArray.create(os.path.join(self.path, name.replace("/", os.sep)), **kwargs)

    @property
    def attrs(self) -> ZarrAttrs:
        return ZarrAttrs(self.path)


def open_zarr(path: str, mode: str = "r") -> Union[ZarrArray, ZarrGroup]:
    """Open a zarr (or N5, see below) array or group at ``path``."""
    if os.path.exists(os.path.join(path, ".zarray")):
        return ZarrArray(path, mode)
    if os.path.exists(os.path.join(path, ".zgroup")):
        return ZarrGroup(path, mode)
    if _is_n5(path):
        with open(os.path.join(path, "attributes.json")) as f:
            return (N5Array(path, mode) if "dimensions" in json.load(f)
                    else N5Group(path, mode))
    raise FileNotFoundError(f"No zarr array/group at {path}")


# ---------------------------------------------------------------------------
# N5 (https://github.com/saalfeldlab/n5) — the reference reads N5 via the
# zarr package's N5 store (SURVEY §2.5: TIFF/H5/Zarr/N5 IO). N5 differs from
# zarr v2 in every on-disk detail: per-node ``attributes.json`` metadata,
# "dimensions"/"blockSize" listed fastest-axis first (reversed vs numpy),
# nested ``<x>/<y>/<z>`` chunk paths in that same reversed order, and
# big-endian blocks carrying their own header (mode, ndim, per-dim size) so
# edge blocks may be truncated. Compression: raw / gzip (zlib-wrapped
# streams are accepted too).
# ---------------------------------------------------------------------------

_N5_DTYPES = {
    "uint8": "u1", "uint16": "u2", "uint32": "u4", "uint64": "u8",
    "int8": "i1", "int16": "i2", "int32": "i4", "int64": "i8",
    "float32": "f4", "float64": "f8",
}


def _n5_decompress(data: bytes, ctype: str) -> bytes:
    if ctype in ("raw", ""):
        return data
    if ctype == "gzip":
        try:
            return zlib.decompress(data, 16 + zlib.MAX_WBITS)  # gzip wrapper
        except zlib.error:
            return zlib.decompress(data)  # zlib wrapper (useZlib=true)
    raise ValueError(f"Unsupported N5 compression: {ctype}")


def _n5_compress(data: bytes, ctype: str) -> bytes:
    if ctype in ("raw", ""):
        return data
    if ctype == "gzip":
        import gzip as _gzip

        return _gzip.compress(data, 1)
    raise ValueError(f"Unsupported N5 compression for writing: {ctype}")


class N5Array(ZarrArray):
    """An N5 dataset with the same numpy-slicing interface as ZarrArray.
    ``shape``/``chunks`` are exposed in numpy (C) order — the reverse of the
    on-disk "dimensions"/"blockSize" attributes."""

    def __init__(self, path: str, mode: str = "r"):  # noqa: D401
        self.path = path
        self.mode = mode
        with open(os.path.join(path, "attributes.json")) as f:
            meta = json.load(f)
        if "dimensions" not in meta:
            raise ValueError(f"{path} is an N5 group, not a dataset")
        self.shape = tuple(reversed([int(s) for s in meta["dimensions"]]))
        self.chunks = tuple(reversed([int(c) for c in meta["blockSize"]]))
        dt = meta.get("dataType", "float32")
        if dt not in _N5_DTYPES:
            raise ValueError(f"Unsupported N5 dataType: {dt}")
        self.dtype = np.dtype(_N5_DTYPES[dt])
        comp = meta.get("compression")
        self._n5_ctype = (comp.get("type") if isinstance(comp, dict)
                          else meta.get("compressionType", "raw")) or "raw"
        self.fill_value = 0
        self.sep = "/"
        self._meta = meta

    @staticmethod
    def create(path: str, shape: Sequence[int], chunks: Sequence[int],
               dtype: Union[str, np.dtype], compression: str = "gzip",
               overwrite: bool = False, **_ignored) -> "N5Array":
        if os.path.exists(os.path.join(path, "attributes.json")) and not overwrite:
            return N5Array(path, mode="r+")
        os.makedirs(path, exist_ok=True)
        dt = np.dtype(dtype)
        name = {v: k for k, v in _N5_DTYPES.items()}.get(dt.str.lstrip("<>|="))
        if name is None:
            raise ValueError(f"Unsupported dtype for N5: {dt}")
        meta = {
            "dimensions": [int(s) for s in reversed(list(shape))],
            "blockSize": [int(c) for c in reversed(list(chunks))],
            "dataType": name,
            "compression": {"type": compression},
        }
        tmp = tempfile.NamedTemporaryFile("w", dir=path, delete=False, suffix=".tmp")
        json.dump(meta, tmp)
        tmp.close()
        os.replace(tmp.name, os.path.join(path, "attributes.json"))
        return N5Array(path, mode="r+")

    # chunk coords arrive in numpy order; on disk they are reversed and
    # nested one directory level per axis
    def _chunk_path(self, coords: Tuple[int, ...]) -> str:
        return os.path.join(self.path, *[str(c) for c in reversed(coords)])

    def _read_chunk(self, coords: Tuple[int, ...]) -> np.ndarray:
        p = self._chunk_path(coords)
        if not os.path.exists(p):
            return np.full(self.chunks, self.fill_value, dtype=self.dtype)
        with open(p, "rb") as f:
            raw = f.read()
        mode = int.from_bytes(raw[0:2], "big")
        ndim = int.from_bytes(raw[2:4], "big")
        off = 4
        block_dims = []
        for _ in range(ndim):
            block_dims.append(int.from_bytes(raw[off : off + 4], "big"))
            off += 4
        if mode == 1:  # varlength: explicit element count
            off += 4
        payload = _n5_decompress(raw[off:], self._n5_ctype)
        np_dims = tuple(reversed(block_dims))  # header dims are reversed too
        arr = np.frombuffer(payload, dtype=self.dtype.newbyteorder(">"))
        arr = arr[: int(np.prod(np_dims))].reshape(np_dims).astype(self.dtype)
        if np_dims == tuple(self.chunks):
            return arr.copy()
        out = np.full(self.chunks, self.fill_value, dtype=self.dtype)
        out[tuple(slice(0, d) for d in np_dims)] = arr
        return out

    def _write_chunk(self, coords: Tuple[int, ...], data: np.ndarray) -> None:
        if self.mode == "r":
            raise PermissionError("N5Array opened read-only")
        # truncate edge blocks to the in-bounds extent (per spec)
        dims = tuple(min(self.chunks[d], self.shape[d] - coords[d] * self.chunks[d])
                     for d in range(self.ndim))
        data = np.ascontiguousarray(
            data[tuple(slice(0, d) for d in dims)], dtype=self.dtype)
        header = (0).to_bytes(2, "big") + self.ndim.to_bytes(2, "big")
        for d in reversed(dims):
            header += int(d).to_bytes(4, "big")
        payload = _n5_compress(data.astype(self.dtype.newbyteorder(">")).tobytes(),
                               self._n5_ctype)
        p = self._chunk_path(coords)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p), suffix=".part")
        with os.fdopen(fd, "wb") as f:
            f.write(header + payload)
        os.replace(tmp, p)

    @property
    def attrs(self) -> "ZarrAttrs":
        raise NotImplementedError("N5 user attributes live in attributes.json")


class N5Group(ZarrGroup):
    """An N5 group: any directory under an N5 root; children with a
    'dimensions' attribute are datasets. Subclasses ZarrGroup so generic
    group-walking code (``_first_zarr_array``) treats both alike."""

    def keys(self):
        for name in sorted(os.listdir(self.path)):
            sub = os.path.join(self.path, name)
            if os.path.isdir(sub):
                yield name

    def __contains__(self, name: str) -> bool:
        return os.path.isdir(os.path.join(self.path, name.replace("/", os.sep)))

    def __getitem__(self, name: str) -> Union[N5Array, "N5Group"]:
        sub = os.path.join(self.path, name.replace("/", os.sep))
        attrs = os.path.join(sub, "attributes.json")
        if os.path.exists(attrs):
            with open(attrs) as f:
                if "dimensions" in json.load(f):
                    return N5Array(sub, self.mode)
        if os.path.isdir(sub):
            return N5Group(sub, self.mode)
        raise KeyError(f"'{name}' not found in N5 store {self.path}")

    def create_dataset(self, name: str, **kwargs) -> N5Array:
        return N5Array.create(os.path.join(self.path, name.replace("/", os.sep)), **kwargs)

    @staticmethod
    def create(path: str) -> "N5Group":
        os.makedirs(path, exist_ok=True)
        attrs = os.path.join(path, "attributes.json")
        if not os.path.exists(attrs):
            with open(attrs, "w") as f:
                json.dump({"n5": "2.0.0"}, f)
        return N5Group(path, mode="r+")


def _is_n5(path: str) -> bool:
    attrs = os.path.join(path, "attributes.json")
    if not os.path.exists(attrs) or os.path.exists(os.path.join(path, ".zarray")) \
            or os.path.exists(os.path.join(path, ".zgroup")):
        return False
    return True
