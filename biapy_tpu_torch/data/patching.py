"""Patch-grid cropping and spline-blended merging, N-dimensional.

Reference analog: ``crop_data_with_overlap`` / ``merge_data_with_overlap``
(biapy/data/data_2D_manipulation.py:54,366) and their 3D twins
(biapy/data/data_3D_manipulation.py:346,683). The reference implements 2D and
3D separately; here one N-D implementation covers both, with the grid math
kept semantically identical so patch counts and coordinates match the
reference exactly (validated by tests/test_patching.py).

Grid semantics (per axis, from the reference):
* ``step = int((patch - 2*pad) * (1 - overlap))`` with ``overlap==0 -> step = patch - 2*pad``
* number of patches ``n = ceil(L / step)``
* the excess of the last patch is redistributed as extra overlap across all
  patches (``ov_per_block``), any remainder absorbed by the final patch.

The merge weights each patch core by a squared-spline window whose taper
width equals the real per-axis overlap, accumulates patch*window and window
into sum/weight buffers, and divides. The on-device version of this stitch
(scatter-add under jit) lives in biapy_tpu/ops/stitch.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from itertools import product as iproduct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class PatchCoords:
    """Spatial coordinates of one patch in the (unpadded) source image.

    Reference analog: biapy/data/dataset.py:333 (PatchCoords).
    ``starts``/``ends`` are per-axis (y,x) or (z,y,x), end-exclusive; they may
    exceed the image bounds by up to ``padding`` on each side (the padded
    region is filled by reflect/zero padding at crop time).
    """

    starts: Tuple[int, ...]
    ends: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(e - s for s, e in zip(self.starts, self.ends))

    def to_dict(self) -> dict:
        names = ("z", "y", "x")[-len(self.starts):]
        d = {}
        for n, s, e in zip(names, self.starts, self.ends):
            d[f"{n}_start"] = int(s)
            d[f"{n}_end"] = int(e)
        return d


def scale_coords(pc: PatchCoords, up: Sequence[int]) -> PatchCoords:
    """``pc`` in a grid ``up`` times finer per axis (a super-resolution
    target's patch of an input patch)."""
    if all(u == 1 for u in up):
        return pc
    return PatchCoords(starts=tuple(st * u for st, u in zip(pc.starts, up)),
                       ends=tuple(en * u for en, u in zip(pc.ends, up)))


@dataclass(frozen=True)
class AxisGrid:
    n: int          # patches along this axis
    step: int       # stride between patch starts (padded coords)
    last_shift: int  # extra back-shift applied to the final patch(es)
    patch: int      # full patch extent (incl. 2*pad)
    pad: int
    length: int     # original (unpadded) axis length
    ov_px: int      # real overlap in pixels between adjacent patch cores

    def start(self, i: int) -> int:
        """Patch start in PADDED coordinates."""
        d = 0 if (i * self.step + self.patch) < (self.length + 2 * self.pad) else self.last_shift
        return i * self.step - d

    def core_start(self, i: int) -> int:
        """Core (padding-stripped) start in UNPADDED coordinates."""
        core = self.patch - 2 * self.pad
        d = 0 if (i * self.step + core) < self.length else self.last_shift
        return i * self.step - d


def axis_grid(length: int, patch: int, overlap: float, pad: int) -> AxisGrid:
    if not (0 <= overlap < 1):
        raise ValueError("'overlap' values must be floats in [0, 1)")
    if pad >= patch // 2:
        raise ValueError(f"padding {pad} must be < half the patch size {patch}")
    if patch > length + 2 * pad:
        raise ValueError(
            f"patch size {patch} greater than axis length {length} "
            "(reduce DATA.PATCH_SIZE or use DATA.REFLECT_TO_COMPLETE_SHAPE)"
        )
    ov = 1.0 if overlap == 0 else 1.0 - overlap
    core = patch - 2 * pad
    # very high overlap can truncate the step to 0 (infinite grid); one pixel
    # is the densest achievable stride
    step = max(1, int(core * ov))
    n = max(1, math.ceil(length / step))
    padded = length + 2 * pad
    last = 0 if n == 1 else ((n - 1) * step + patch) - padded
    ov_per_block = last // (n - 1) if n > 1 else 0
    step -= ov_per_block
    last -= ov_per_block * (n - 1)
    ov_px = core - step if n > 1 else 0
    return AxisGrid(n=n, step=step, last_shift=last, patch=patch, pad=pad, length=length, ov_px=ov_px)


def compute_patch_grid(
    spatial_shape: Sequence[int],
    patch_size: Sequence[int],
    overlap: Sequence[float],
    padding: Sequence[int],
) -> Tuple[List[PatchCoords], Tuple[AxisGrid, ...]]:
    """Full patch grid for one image. Returns coords in UNPADDED image space
    (starts may be negative / ends beyond the image by up to pad)."""
    nd = len(spatial_shape)
    grids = tuple(axis_grid(spatial_shape[d], patch_size[d], overlap[d], padding[d]) for d in range(nd))
    coords = []
    for idx in iproduct(*(range(g.n) for g in grids)):
        starts = tuple(g.start(i) - g.pad for g, i in zip(grids, idx))
        ends = tuple(s + g.patch for s, g in zip(starts, grids))
        coords.append(PatchCoords(starts=starts, ends=ends))
    return coords, grids


def extract_patch(
    img: np.ndarray,
    coords: PatchCoords,
    pad_type: str = "reflect",
) -> np.ndarray:
    """Extract one patch (channels-last image), padding out-of-bounds regions."""
    nd = len(coords.starts)
    slices = []
    pads = []
    for d in range(nd):
        s, e = coords.starts[d], coords.ends[d]
        lo_pad = max(0, -s)
        hi_pad = max(0, e - img.shape[d])
        slices.append(slice(max(0, s), min(img.shape[d], e)))
        pads.append((lo_pad, hi_pad))
    patch = img[tuple(slices)]
    if any(p != (0, 0) for p in pads):
        mode = "constant" if pad_type == "zeros" else pad_type
        patch = np.pad(patch, pads + [(0, 0)] * (img.ndim - nd), mode=mode)
    return patch


def crop_data_with_overlap(
    data: np.ndarray,
    crop_shape: Sequence[int],
    data_mask: Optional[np.ndarray] = None,
    overlap: Sequence[float] = (0, 0),
    padding: Sequence[int] = (0, 0),
    verbose: bool = False,
    load_data: bool = True,
    pad_type: str = "reflect",
):
    """Crop a batch of images into overlapping patches.

    ``data``: (n, y, x, c) or (z, y, x, c)-as-single-volume depending on the
    caller; the leading axis is iterated, spatial axes follow, channels last.
    ``crop_shape`` includes the channel dim (reference convention), e.g.
    (256, 256, 1).
    """
    nd = len(crop_shape) - 1
    spatial = data.shape[1 : 1 + nd]
    patch_size = crop_shape[:nd]
    coords, grids = compute_patch_grid(spatial, patch_size, overlap, padding)
    if verbose:
        print(f"### OV-CROP ### {data.shape} -> {crop_shape}, overlap {tuple(overlap)}, padding {tuple(padding)}")
        print(f"{tuple(g.n for g in grids)} patches per axis; real overlap px {tuple(g.ov_px for g in grids)}")
    all_coords = coords * data.shape[0]
    if not load_data:
        return all_coords
    out = np.empty((data.shape[0] * len(coords),) + tuple(patch_size) + (data.shape[-1],), dtype=data.dtype)
    out_mask = None
    if data_mask is not None:
        out_mask = np.empty(
            (data.shape[0] * len(coords),) + tuple(patch_size) + (data_mask.shape[-1],), dtype=data_mask.dtype
        )
    c = 0
    for z in range(data.shape[0]):
        for pc in coords:
            out[c] = extract_patch(data[z], pc, pad_type)
            if out_mask is not None:
                out_mask[c] = extract_patch(data_mask[z], pc, pad_type)
            c += 1
    if data_mask is not None:
        return out, out_mask, all_coords
    return out, all_coords


def spline_window_1d(size: int, ov_pixels: int, power: int = 2) -> np.ndarray:
    """Squared-spline taper: ~1 in the patch interior, smoothly to ~0 across
    the ``ov_pixels`` overlap band at each end (reference:
    data_2D_manipulation.py:318 _get_spline_window_2D)."""
    wind = np.ones(size, dtype=np.float32)
    if ov_pixels > 0:
        ov_pixels = min(ov_pixels, size // 2)
        x = np.linspace(0, 1, ov_pixels + 2)[1:-1]
        taper = (x**power) / (x**power + (1 - x) ** power + 1e-8)
        wind[:ov_pixels] = taper
        wind[-ov_pixels:] = taper[::-1]
    return wind


def spline_window(core_shape: Sequence[int], ov_pixels: Sequence[int], power: int = 2) -> np.ndarray:
    """N-D separable spline window with a trailing channel axis of size 1."""
    w = None
    for d, (s, o) in enumerate(zip(core_shape, ov_pixels)):
        w1 = spline_window_1d(s, o, power)
        shape = [1] * len(core_shape)
        shape[d] = s
        w1 = w1.reshape(shape)
        w = w1 if w is None else w * w1
    return w[..., None].astype(np.float32)


def merge_data_with_overlap(
    data: np.ndarray,
    original_shape: Sequence[int],
    data_mask: Optional[np.ndarray] = None,
    overlap: Sequence[float] = (0, 0),
    padding: Sequence[int] = (0, 0),
    verbose: bool = False,
):
    """Merge overlapping patches back into images with spline blending.

    ``data``: (num_patches_total, *patch_spatial, c); ``original_shape``:
    (n, *spatial, c_out). Inverse of :func:`crop_data_with_overlap`.
    """
    nd = data.ndim - 2
    spatial = tuple(original_shape[1 : 1 + nd])
    grids = tuple(
        axis_grid(spatial[d], data.shape[1 + d], overlap[d], padding[d]) for d in range(nd)
    )
    core_slices = tuple(slice(padding[d], data.shape[1 + d] - padding[d]) for d in range(nd))
    core = data[(slice(None),) + core_slices]
    core_mask = data_mask[(slice(None),) + core_slices] if data_mask is not None else None
    core_shape = core.shape[1 : 1 + nd]
    window = spline_window(core_shape, tuple(g.ov_px for g in grids))

    merged = np.zeros(tuple(original_shape), dtype=np.float32)
    merged_mask = (
        np.zeros(tuple(original_shape[:-1]) + (data_mask.shape[-1],), dtype=np.float32)
        if data_mask is not None
        else None
    )
    weights = np.zeros(tuple(original_shape[:-1]) + (1,), dtype=np.float32)

    n_per_img = int(np.prod([g.n for g in grids]))
    c = 0
    for z in range(original_shape[0]):
        for idx in iproduct(*(range(g.n) for g in grids)):
            sl = tuple(
                slice(g.core_start(i), g.core_start(i) + core_shape[d])
                for d, (g, i) in enumerate(zip(grids, idx))
            )
            merged[(z,) + sl] += core[c] * window
            if merged_mask is not None:
                merged_mask[(z,) + sl] += core_mask[c] * window
            weights[(z,) + sl] += window
            c += 1
    assert c == len(data), f"patch count mismatch: {c} vs {len(data)}"
    merged = (merged / (weights + 1e-18)).astype(data.dtype)
    if verbose:
        print(f"### MERGE-OV-CROP ### -> {merged.shape}")
    if merged_mask is not None:
        merged_mask = (merged_mask / (weights + 1e-18)).astype(data_mask.dtype)
        return merged, merged_mask
    return merged


def pad_to_min_shape(img: np.ndarray, patch_size: Sequence[int], mode: str = "reflect") -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Reflect-pad an image so every spatial axis >= patch size
    (reference: DATA.REFLECT_TO_COMPLETE_SHAPE / pad_to_shape,
    data_manipulation.py:3126). Returns padded image and the pads applied."""
    nd = len(patch_size)
    pads = []
    for d in range(nd):
        deficit = max(0, patch_size[d] - img.shape[d])
        pads.append((deficit // 2, deficit - deficit // 2))
    pads_full = pads + [(0, 0)] * (img.ndim - nd)
    if any(p != (0, 0) for p in pads):
        img = np.pad(img, pads_full, mode=mode)
    return img, pads
