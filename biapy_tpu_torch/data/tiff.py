"""Self-contained TIFF reading/writing, copied from the JAX package's
``data/tiff.py``.

* reading parses uncompressed striped files directly (any dtype and channel
  count); compressed or tiled files fall back to PIL, imported only then,
* writing uses a minimal built-in little-endian TIFF writer (uncompressed,
  one strip per page, multipage for stacks, ImageJ description tag so Fiji
  opens Z-stacks/channels correctly).
"""

from __future__ import annotations

import struct

import numpy as np

_SAMPLE_FORMAT = {"u": 1, "i": 2, "f": 3}


def read_tiff(path: str) -> np.ndarray:
    """Read a (possibly multipage) TIFF into an ndarray.

    Returns (H, W) / (H, W, C) for single page, (Z, H, W[, C]) for stacks.
    Tries the built-in raw parser first (handles any dtype/channel-count for
    uncompressed files); falls back to PIL for compressed/exotic encodings.
    """
    try:
        return _read_tiff_raw(path)
    except _UnsupportedTiff:
        pass
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as im:
        n = getattr(im, "n_frames", 1)
        pages = []
        for i in range(n):
            im.seek(i)
            pages.append(np.asarray(im))
    if len(pages) == 1:
        return pages[0]
    return np.stack(pages, axis=0)


class _UnsupportedTiff(Exception):
    pass


_TAG_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_TAG_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}


def _read_tiff_raw(path: str) -> np.ndarray:
    """Parse an uncompressed striped/chunky TIFF directly."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise _UnsupportedTiff("not a TIFF")
    magic, off = struct.unpack(bo + "HI", data[2:8])
    if magic != 42:
        raise _UnsupportedTiff("BigTIFF not supported by raw parser")
    pages = []
    while off:
        ntags = struct.unpack(bo + "H", data[off : off + 2])[0]
        tags = {}
        for i in range(ntags):
            e = off + 2 + i * 12
            code, ttype, cnt = struct.unpack(bo + "HHI", data[e : e + 8])
            size = _TAG_SIZES.get(ttype, 1) * cnt
            if size <= 4:
                raw = data[e + 8 : e + 8 + size]
            else:
                voff = struct.unpack(bo + "I", data[e + 8 : e + 12])[0]
                raw = data[voff : voff + size]
            if ttype in _TAG_FMT:
                vals = struct.unpack(bo + str(cnt) + _TAG_FMT[ttype], raw)
                tags[code] = vals
            else:
                tags[code] = raw
        off = struct.unpack(bo + "I", data[off + 2 + ntags * 12 : off + 6 + ntags * 12])[0]

        if tags.get(259, (1,))[0] != 1:
            raise _UnsupportedTiff("compressed")
        if tags.get(284, (1,))[0] != 1:
            raise _UnsupportedTiff("planar config")
        if 322 in tags:
            raise _UnsupportedTiff("tiled")
        w = tags[256][0]
        h = tags[257][0]
        spp = tags.get(277, (1,))[0]
        bps = tags.get(258, (8,))
        if len(set(bps)) != 1:
            raise _UnsupportedTiff("mixed bits per sample")
        bits = bps[0]
        sf = tags.get(339, (1,))[0]
        kind = {1: "u", 2: "i", 3: "f"}.get(sf)
        if kind is None or bits % 8:
            raise _UnsupportedTiff("sample format")
        dt = np.dtype(f"{bo}{kind}{bits // 8}")
        strip_offs = tags[273]
        strip_counts = tags.get(279, (h * w * spp * dt.itemsize,))
        buf = b"".join(data[o : o + c] for o, c in zip(strip_offs, strip_counts))
        arr = np.frombuffer(buf, dtype=dt).reshape(h, w, spp) if spp > 1 else np.frombuffer(
            buf, dtype=dt
        ).reshape(h, w)
        if bo == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        pages.append(arr)
    if len(pages) == 1:
        return pages[0]
    return np.stack(pages, axis=0)


def write_tiff(path: str, data: np.ndarray, imagej: bool = True) -> None:
    """Write ``data`` as an uncompressed (multipage) TIFF.

    Accepts (H, W), (H, W, C), (Z, H, W) or (Z, H, W, C) arrays. Each leading
    Z-slice becomes one page; channels are interleaved samples-per-pixel.
    """
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[None, :, :, None]
    elif data.ndim == 3:
        # Heuristic matching the reference's channels-last convention: a
        # trailing dim of <= 4 is channels, otherwise it's a Z stack.
        if data.shape[-1] <= 4:
            data = data[None]
        else:
            data = data[..., None]
    elif data.ndim != 4:
        raise ValueError(f"write_tiff expects 2-4D data, got shape {data.shape}")
    z, h, w, c = data.shape
    if not data.flags.c_contiguous:
        data = np.ascontiguousarray(data)
    dt = data.dtype
    if dt == np.bool_:
        data = data.astype(np.uint8)
        dt = data.dtype
    if dt.byteorder == ">":
        data = data.astype(dt.newbyteorder("<"))
        dt = data.dtype
    sample_format = _SAMPLE_FORMAT.get(dt.kind)
    if sample_format is None:
        raise ValueError(f"Unsupported dtype for TIFF: {dt}")
    bits = dt.itemsize * 8

    desc = b""
    if imagej:
        desc = (f"ImageJ=1.53\nimages={z}\nslices={z}\nhyperstack=true\nmode=grayscale\nloop=false\n").encode()
        if desc[-1:] != b"\x00":
            desc += b"\x00"

    page_bytes = h * w * c * dt.itemsize

    def tag(code, ttype, count, value) -> bytes:
        # ttype: 3=SHORT, 4=LONG, 2=ASCII
        if ttype == 3 and count == 1:
            return struct.pack("<HHIHH", code, 3, 1, value, 0)
        if ttype == 4 and count == 1:
            return struct.pack("<HHII", code, 4, 1, value)
        if ttype in (2, 3) and count > 1:
            return struct.pack("<HHII", code, ttype, count, value)  # value = offset
        raise AssertionError

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, 8))
        offset = 8
        # Layout per page: IFD, [extra values], pixel data, then next IFD.
        for zi in range(z):
            tags = []
            extra = b""
            # Photometric: RGB(2) for 3/4 channels, grayscale(1) otherwise.
            photometric = 2 if c in (3, 4) else 1
            n_extra_samples = {1: 0, 2: 1, 3: 0, 4: 1}.get(c, c - 1)
            ntags = 11 + (1 if (desc and zi == 0) else 0) + (1 if n_extra_samples else 0)
            ifd_size = 2 + ntags * 12 + 4
            extra_off = offset + ifd_size

            # BitsPerSample: c values (if c>1 they can't fit inline for c>2)
            if c > 2:
                bps_val = extra_off + len(extra)
                extra += struct.pack(f"<{c}H", *([bits] * c))
                bps_tag = tag(258, 3, c, bps_val)
            elif c == 2:
                bps_tag = struct.pack("<HHIHH", 258, 3, 2, bits, bits)
            else:
                bps_tag = tag(258, 3, 1, bits)
            desc_tag = b""
            if desc and zi == 0:
                if len(desc) <= 4:
                    desc_tag = struct.pack("<HHI4s", 270, 2, len(desc), desc.ljust(4, b"\x00"))
                else:
                    dv = extra_off + len(extra)
                    extra += desc
                    desc_tag = tag(270, 2, len(desc), dv)
            if len(extra) % 2:
                extra += b"\x00"
            es_tag = b""
            if n_extra_samples == 1:
                es_tag = tag(338, 3, 1, 0)  # ExtraSamples: unspecified
            elif n_extra_samples > 1:
                es_val = extra_off + len(extra)
                extra += struct.pack(f"<{n_extra_samples}H", *([0] * n_extra_samples))
                if len(extra) % 2:
                    extra += b"\x00"
                es_tag = tag(338, 3, n_extra_samples, es_val)

            data_off = extra_off + len(extra)
            next_ifd = data_off + page_bytes + (page_bytes % 2)
            tags.append(tag(256, 4, 1, w))  # ImageWidth
            tags.append(tag(257, 4, 1, h))  # ImageLength
            tags.append(bps_tag)  # BitsPerSample
            tags.append(tag(259, 3, 1, 1))  # Compression: none
            tags.append(tag(262, 3, 1, photometric))
            if desc_tag:
                tags.append(desc_tag)
            tags.append(tag(273, 4, 1, data_off))  # StripOffsets
            tags.append(tag(277, 3, 1, c))  # SamplesPerPixel
            tags.append(tag(278, 4, 1, h))  # RowsPerStrip
            tags.append(tag(279, 4, 1, page_bytes))  # StripByteCounts
            tags.append(tag(284, 3, 1, 1))  # PlanarConfig: chunky
            tags.append(tag(339, 3, 1, sample_format))  # SampleFormat
            if es_tag:
                tags.append(es_tag)
            tags.sort(key=lambda t: struct.unpack("<H", t[:2])[0])
            assert len(tags) == ntags, (len(tags), ntags)

            ifd = struct.pack("<H", ntags) + b"".join(tags)
            ifd += struct.pack("<I", next_ifd if zi < z - 1 else 0)
            f.write(ifd)
            f.write(extra)
            f.write(data[zi].tobytes())
            if page_bytes % 2:
                f.write(b"\x00")
            offset = next_ifd
