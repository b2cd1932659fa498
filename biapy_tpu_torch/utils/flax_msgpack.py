"""Flax's msgpack checkpoint format, read and written without the ``msgpack``
package.

Counterpart of ``flax.serialization.msgpack_serialize`` /
``msgpack_restore``, which the JAX package's ``.ckpt`` files are made of:

- a tree of maps (string keys), lists, str, bytes (bin), ints, floats
  (float64), bools and nil;
- arrays as msgpack ext type 1 whose payload is itself a packed
  ``[shape, dtype name, C-order bytes]``; numpy scalars as ext type 3 with
  the same payload; arrays larger than 2**30 bytes as Flax's chunked-array
  map (``__msgpack_chunked_array__``);
- ``serialize`` writes exactly the bytes Flax writes for the same tree: map
  keys in sorted order (Flax copies the tree through ``jax.tree_util``,
  which sorts dict keys), Python floats as float64, ints in the smallest
  msgpack form, str as str8/16/32, bytes as bin, and no tuples (Flax packs
  with ``strict_types``).

``bfloat16`` arrays decode to ``torch.bfloat16`` tensors (numpy has no such
dtype without ``ml_dtypes``); a ``torch.Tensor`` leaf encodes as the array
Flax would write for it. Every other array is a numpy array.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # Flax splits arrays above this many bytes
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------
def _pack_int(n: int, out: List[bytes]) -> None:
    if n < 0:
        if n >= -32:
            out.append(struct.pack("b", n))
        elif n >= -(1 << 7):
            out.append(b"\xd0" + struct.pack(">b", n))
        elif n >= -(1 << 15):
            out.append(b"\xd1" + struct.pack(">h", n))
        elif n >= -(1 << 31):
            out.append(b"\xd2" + struct.pack(">i", n))
        elif n >= -(1 << 63):
            out.append(b"\xd3" + struct.pack(">q", n))
        else:
            raise OverflowError(f"int {n} does not fit msgpack")
    elif n < 128:
        out.append(bytes([n]))
    elif n < 1 << 8:
        out.append(b"\xcc" + struct.pack(">B", n))
    elif n < 1 << 16:
        out.append(b"\xcd" + struct.pack(">H", n))
    elif n < 1 << 32:
        out.append(b"\xce" + struct.pack(">I", n))
    elif n < 1 << 64:
        out.append(b"\xcf" + struct.pack(">Q", n))
    else:
        raise OverflowError(f"int {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[bytes, ...], widths: Tuple[str, ...],
              out: List[bytes]) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` (8, 16, 32 bits) whose width holds ``n``."""
    if fix_max and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, w in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(w)):
            out.append(code + struct.pack(">" + w, n))
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_str(s: str, out: List[bytes]) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"), ("B", "H", "I"), out)
    out.append(b)


def _pack_bin(b: bytes, out: List[bytes]) -> None:
    _pack_len(len(b), 0, 0, (b"\xc4", b"\xc5", b"\xc6"), ("B", "H", "I"), out)
    out.append(b)


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    fixed = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, 0, 0, (b"\xc7", b"\xc8", b"\xc9"), ("B", "H", "I"), out)
    out.append(struct.pack("b", code))
    out.append(data)


def _array_payload(shape, dtype_name: str, data: bytes) -> bytes:
    """Flax's ``_ndarray_to_bytes``: ``packb((shape, name, bytes))``."""
    out: List[bytes] = [b"\x93"]  # a 3-element array
    _pack_len(len(shape), 0x90, 16, (b"\xdc", b"\xdd"), ("H", "I"), out)
    for d in shape:
        _pack_int(int(d), out)
    _pack_str(dtype_name, out)
    _pack_bin(data, out)
    return b"".join(out)


def _as_numpy_or_bf16(x):
    """A leaf array as ``(shape, dtype name, numpy array)``; bf16 tensors
    travel as their raw 16-bit words."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy()
        x = t.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of "
                         "ndarrays.")
    return x.shape, x.dtype.name, x


def _chunk(shape, name: str, arr: np.ndarray) -> Dict[str, Any]:
    """Flax's ``_chunk``: a map of flat chunks of at most 2**30 bytes."""
    chunksize = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + chunksize] for i in range(0, flat.size, chunksize)]
    if name == "bfloat16":
        chunks = [torch.from_numpy(c.copy()).view(torch.bfloat16) for c in chunks]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(x, out: List[bytes], sort: bool = True) -> None:
    """Pack ``x``; maps in sorted key order, except Flax's chunked-array maps,
    which it builds after sorting (``sort=False``)."""
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif t is int:
        _pack_int(x, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        _pack_str(x, out)
    elif t is bytes:
        _pack_bin(x, out)
    elif t is dict:
        _pack_len(len(x), 0x80, 16, (b"\xde", b"\xdf"), ("H", "I"), out)
        for k in (sorted(x) if sort else x):
            _pack(k, out)
            _pack(x[k], out, sort)
    elif t is list:
        _pack_len(len(x), 0x90, 16, (b"\xdc", b"\xdd"), ("H", "I"), out)
        for v in x:
            _pack(v, out)
    elif isinstance(x, np.generic):
        a = np.asarray(x)
        _pack_ext(_EXT_NPSCALAR, _array_payload(a.shape, a.dtype.name, a.tobytes("C")), out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        shape, name, arr = _as_numpy_or_bf16(x)
        if arr.size * arr.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(_chunk(shape, name, arr), out, sort=False)
        else:
            _pack_ext(_EXT_NDARRAY, _array_payload(shape, name, arr.tobytes("C")), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` gives."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------
class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # True: str as bytes (Flax unpacks array payloads so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        return _decode_ext(code, bytes(self.take(n)))

    def read(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q", 0xCA: "f", 0xCB: "d"}
        if b in ints:
            v = self.unpack(ints[b])
            return float(v) if b in (0xCA, 0xCB) else v
        lens = {0xC4: "B", 0xC5: "H", 0xC6: "I", 0xD9: "B", 0xDA: "H", 0xDB: "I",
                0xDC: "H", 0xDD: "I", 0xDE: "H", 0xDF: "I", 0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if b in lens:
            n = self.unpack(lens[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.str_(n)
            if b <= 0xDD:
                return [self.read() for _ in range(n)]
            return self.map_(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unknown msgpack type byte 0x{b:02x} at {self.pos - 1}")

    def map_(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _array_from_payload(data: bytes):
    shape, name, buf = _Reader(data, raw=True).read()
    if name == b"bfloat16":
        t = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return t.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape, order="C")


def _decode_ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_payload(data)
    if code == _EXT_NPSCALAR:
        a = _array_from_payload(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"msgpack ext type {code} is not an array or a numpy scalar (Flax's "
                     "complex scalars are not read)")


def _unchunk(d: Dict[str, Any]):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(x):
    if isinstance(x, dict):
        if _CHUNKED in x:
            return _unchunk(x)
        return {k: _unchunk_tree(v) for k, v in x.items()}
    return x


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore(data)`` gives (bf16
    arrays as ``torch.bfloat16`` tensors)."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return _unchunk_tree(tree)
