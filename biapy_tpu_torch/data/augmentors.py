"""The augmentation suite: 30 toggleable ops, copied from the JAX package's
``data/augmentors.py`` with the same parameters and the same numpy draws in
the same order, so that both packages augment a sample alike from the same
``np.random.Generator``.

Host-side implementations operating on channels-last images — ``(y, x, c)``
or ``(z, y, x, c)``. Geometric ops transform image and mask together (mask
with nearest interpolation); intensity ops touch the image only. 3D
geometric ops apply slice-wise over z (EM volumes are anisotropic).

The JAX package calls OpenCV for five operations; the port does not depend
on it. Each call sits behind a private helper with OpenCV's semantics:
``_warp_affine`` (``cv2.warpAffine``) and ``_remap`` (``cv2.remap``) resample
every z slice of a sample at once, linear through ``F.grid_sample`` on CPU
tensors (it releases the GIL, so the loader's threads overlap) and nearest
by integer gathers; the border modes map as ``BORDER_REFLECT_101`` ->
reflection about the edge pixels, ``BORDER_REFLECT`` -> reflection about the
edges, ``BORDER_WRAP`` -> coordinates folded onto a one-pixel wrapped pad,
``BORDER_CONSTANT`` -> zeros outside. ``_filter2d`` (``cv2.filter2D``) is
``ndimage.correlate`` with ``mode="mirror"``, ``_resize_nearest``
(``cv2.resize`` with ``INTER_NEAREST``) is ``src[floor(i * src / dst)]`` and
``_rotation_matrix_2d`` is ``cv2.getRotationMatrix2D``'s closed form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage


# --------------------------------------------------------------------------
# OpenCV's operations
# --------------------------------------------------------------------------
# AUGMENTOR.AFFINE_MODE -> OpenCV border mode (the JAX package's mapping)
_BORDERS = {"reflect": "reflect101", "constant": "constant", "wrap": "wrap",
            "symmetric": "reflect"}


def _rotation_matrix_2d(center, angle_deg: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle_deg, scale)``."""
    a = np.deg2rad(angle_deg)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _fold(i: np.ndarray, n: int, border: str) -> np.ndarray:
    """Integer source indices mapped into ``[0, n)`` by the border mode
    (``constant``: left as they are; the caller masks them)."""
    if border == "reflect101":
        if n == 1:
            return np.zeros_like(i)
        p = 2 * (n - 1)
        i = np.mod(i, p)
        return np.where(i >= n, p - i, i)
    if border == "reflect":
        p = 2 * n
        i = np.mod(i, p)
        return np.where(i >= n, p - 1 - i, i)
    if border == "wrap":
        return np.mod(i, n)
    return i


def _sample(x: np.ndarray, sx: np.ndarray, sy: np.ndarray, linear: bool,
            border: str) -> np.ndarray:
    """Resample every slice of ``x`` (n, h, w, c) at the source coordinates
    ``sx``, ``sy`` (h, w; float64, OpenCV's pixel-centre convention), as
    ``cv2.remap`` does with ``INTER_LINEAR`` / ``INTER_NEAREST`` and the border
    mode; float32 out."""
    n, h, w, c = x.shape
    if not linear:
        # OpenCV rounds a source coordinate half up
        ix = np.floor(sx + 0.5).astype(np.int64)
        iy = np.floor(sy + 0.5).astype(np.int64)
        jx = np.clip(_fold(ix, w, border), 0, w - 1)
        jy = np.clip(_fold(iy, h, border), 0, h - 1)
        out = x[:, jy, jx, :]
        if border == "constant":
            inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            out = np.where(inside[None, ..., None], out, 0)
        return np.ascontiguousarray(out, dtype=np.float32)
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).permute(0, 3, 1, 2)
    if border == "wrap":
        # one wrapped row and column at the far edges, coordinates folded
        # into [0, size): every tap lands inside the padded image
        t = torch.cat([t, t[:, :, :1]], 2)
        t = torch.cat([t, t[..., :1]], 3)
        gx, gy = np.mod(sx, w) / w * 2 - 1, np.mod(sy, h) / h * 2 - 1
        pad_mode, corners = "border", True
    elif border == "reflect":
        # reflection about the edges: grid_sample's without aligned corners
        gx, gy = (sx + 0.5) / w * 2 - 1, (sy + 0.5) / h * 2 - 1
        pad_mode, corners = "reflection", False
    else:
        # reflection about the edge pixels, or zeros outside
        gx, gy = sx / max(w - 1, 1) * 2 - 1, sy / max(h - 1, 1) * 2 - 1
        pad_mode, corners = ("zeros" if border == "constant" else "reflection"), True
    grid = torch.from_numpy(np.stack([gx, gy], -1).astype(np.float32))
    out = F.grid_sample(t, grid[None].expand(n, h, w, 2), mode="bilinear",
                        padding_mode=pad_mode, align_corners=corners)
    return out.permute(0, 2, 3, 1).contiguous().numpy()


def _fixed_point(x: np.ndarray) -> bool:
    """OpenCV resamples images of 1, 3 or 4 channels at float coordinates
    and others on a fixed-point grid: 1/32 pixel for linear interpolation,
    whole pixels for nearest."""
    return x.shape[-1] not in (1, 3, 4)


def _warp_affine(x: np.ndarray, m2x3: np.ndarray, linear: bool, border: str,
                 size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """``cv2.warpAffine(slice, m2x3, (w, h), flags, borderMode)`` on every
    slice of ``x`` (n, y, x, c), to an output of ``size`` (h, w), the
    slice's own by default: the forward matrix is inverted as OpenCV
    inverts it."""
    h, w = size or x.shape[1:3]
    (a, b, e), (c, d, f) = m2x3
    det = a * d - b * c
    det = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = d * det, a * det, -b * det, -c * det
    b1, b2 = -a11 * e - a12 * f, -a21 * e - a22 * f
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    if _fixed_point(x):
        # OpenCV's fixed point: 1/1024 pixel per row and per column, summed,
        # then rounded half up to the interpolation's grid
        bits = 5 if linear else 0

        def coord(per_col, per_row, offset):
            fx = (np.rint((per_row * ys + offset) * 1024)[:, None] + (1 << (9 - bits))
                  + np.rint(per_col * xs * 1024)[None, :]).astype(np.int64)
            return (fx >> (10 - bits)) / float(1 << bits)

        return _sample(x, coord(a11, a12, b1), coord(a21, a22, b2), linear, border)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return _sample(x, a11 * xx + a12 * yy + b1, a21 * xx + a22 * yy + b2, linear, border)


def _remap(x: np.ndarray, mapx: np.ndarray, mapy: np.ndarray, linear: bool,
           border: str) -> np.ndarray:
    """``cv2.remap(slice, mapx, mapy, interp, borderMode)`` on every slice of
    ``x`` (n, h, w, c)."""
    sx, sy = mapx.astype(np.float64), mapy.astype(np.float64)
    if _fixed_point(x):
        # OpenCV rounds float maps half to even onto its grid
        q = 32.0 if linear else 1.0
        sx, sy = np.rint(sx * q) / q, np.rint(sy * q) / q
    return _sample(x, sx, sy, linear, border)


def _filter2d(x: np.ndarray, kern: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(x, -1, kern)`` (correlation, centred anchor,
    ``BORDER_REFLECT_101``) on a (h, w, c) float32 image."""
    return ndimage.correlate(x, kern[..., None], mode="mirror")


def _resize_nearest(x: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(x, (w, h), interpolation=cv2.INTER_NEAREST)`` on a
    (hh, ww, c) image: output pixel ``i`` takes source ``floor(i * src / dst)``."""
    hh, ww = x.shape[:2]
    iy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / hh))).astype(np.int64), hh - 1)
    ix = np.minimum(np.floor(np.arange(w) * (1.0 / (w / ww))).astype(np.int64), ww - 1)
    return x[iy][:, ix]


def _slices(x: np.ndarray) -> np.ndarray:
    """A (y, x, c) image or a (z, y, x, c) volume as (n, y, x, c) slices."""
    return x if x.ndim == 4 else x[None]


def _resampled(x: np.ndarray, out: np.ndarray) -> np.ndarray:
    """``out`` (n, y, x, c) float32 back in the shape and dtype of ``x``."""
    out = out if x.ndim == 4 else out[0]
    return out.astype(x.dtype) if x.dtype != np.float32 else out


def _rand_range(rng, rr) -> float:
    return float(rng.uniform(rr[0], rr[1]))


def _per_slice_2d(fn, img):
    """Apply a (y,x,c) op per z-slice of a (z,y,x,c) volume."""
    return np.stack([fn(img[z]) for z in range(img.shape[0])], axis=0)


# --------------------------------------------------------------------------
# geometric — composed affine (zoom / rot / shear / shift), rot90, flips
# --------------------------------------------------------------------------
def affine_2d(
    img: np.ndarray,
    mask: Optional[np.ndarray],
    rng: np.random.Generator,
    zoom: Optional[Tuple[float, float]] = None,
    rot_deg: Optional[float] = None,
    shear_deg: Optional[float] = None,
    shift_frac: Optional[Tuple[float, float]] = None,
    mode: str = "reflect",
):
    """One resampling pass composing zoom/rotation/shear/shift (reference:
    augmentors.py affine composition; AUGMENTOR.AFFINE_MODE)."""
    h, w = img.shape[-3:-1]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    m = np.eye(3, dtype=np.float64)

    def compose(t):
        nonlocal m
        m = t @ m

    # translate to center
    compose(np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], dtype=np.float64))
    if zoom is not None:
        compose(np.diag([zoom[1], zoom[0], 1.0]))
    if rot_deg:
        a = np.deg2rad(rot_deg)
        compose(np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]))
    if shear_deg:
        s = np.tan(np.deg2rad(shear_deg))
        compose(np.array([[1, s, 0], [0, 1, 0], [0, 0, 1]]))
    compose(np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], dtype=np.float64))
    if shift_frac is not None:
        compose(np.array([[1, 0, shift_frac[1] * w], [0, 1, shift_frac[0] * h], [0, 0, 1]]))

    m2x3 = m[:2]
    border = _BORDERS.get(mode, "reflect101")

    def warp(x, linear):
        # the image's output size for the mask too, as the reference's
        # cv2.warpAffine(mask, m2x3, (w, h)): a mask of another size (a
        # super-resolution target) comes back at the image's size
        return _resampled(x, _warp_affine(_slices(x), m2x3, linear, border, (h, w)))

    img_out = warp(img, True)
    mask_out = warp(mask, False) if mask is not None else None
    return img_out, mask_out


def rot90_k(img, mask, k: int):
    axes = (-3, -2)
    img = np.rot90(img, k, axes=axes).copy()
    if mask is not None:
        mask = np.rot90(mask, k, axes=axes).copy()
    return img, mask


def rot90(img, mask, rng):
    return rot90_k(img, mask, int(rng.integers(1, 4)))


def flip(img, mask, axis: int):
    img = np.flip(img, axis=axis).copy()
    if mask is not None:
        mask = np.flip(mask, axis=axis).copy()
    return img, mask


def elastic(img, mask, rng, alpha=(12, 16), sigma=4.0, mode="constant"):
    """Elastic deformation (Simard 2003; reference: augmentors.py elastic)."""
    a = _rand_range(rng, alpha)
    h, w = img.shape[-3:-1]
    dx = ndimage.gaussian_filter(rng.uniform(-1, 1, (h, w)), sigma, mode="constant") * a
    dy = ndimage.gaussian_filter(rng.uniform(-1, 1, (h, w)), sigma, mode="constant") * a
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    mapx = (xx + dx).astype(np.float32)
    mapy = (yy + dy).astype(np.float32)
    border = "constant" if mode == "constant" else "reflect101"

    def remap(x, linear):
        return _resampled(x, _remap(_slices(x), mapx, mapy, linear, border))

    img = remap(img, True)
    mask = remap(mask, False) if mask is not None else None
    return img, mask


# --------------------------------------------------------------------------
# blur family
# --------------------------------------------------------------------------
def gaussian_blur(img, rng, sigma=(1.0, 2.0)):
    s = _rand_range(rng, sigma)
    sig = [0.0] * img.ndim
    for ax in ((0, 1) if img.ndim == 3 else (1, 2)):
        sig[ax] = s
    return ndimage.gaussian_filter(img.astype(np.float32), sigma=sig).astype(img.dtype)


def median_blur(img, rng, k_range=(3, 7)):
    k = int(rng.integers(k_range[0] // 2, k_range[1] // 2 + 1)) * 2 + 1
    size = [1] * img.ndim
    for ax in ((0, 1) if img.ndim == 3 else (1, 2)):
        size[ax] = k
    return ndimage.median_filter(img, size=tuple(size))


def motion_blur(img, rng, k_range=(8, 12)):
    k = int(rng.integers(k_range[0], k_range[1] + 1)) | 1
    kern = np.zeros((k, k), np.float32)
    ang = rng.uniform(0, 180)
    c = (k - 1) / 2
    dx, dy = np.cos(np.deg2rad(ang)), np.sin(np.deg2rad(ang))
    for t in np.linspace(-c, c, k * 2):
        y, x = int(round(c + t * dy)), int(round(c + t * dx))
        if 0 <= y < k and 0 <= x < k:
            kern[y, x] = 1
    kern /= max(kern.sum(), 1)

    def f2(s):
        return _filter2d(s.astype(np.float32), kern).astype(s.dtype)

    return _per_slice_2d(f2, img) if img.ndim == 4 else f2(img)


# --------------------------------------------------------------------------
# intensity family
# --------------------------------------------------------------------------
def gamma_contrast(img, rng, gamma=(1.25, 1.75)):
    g = _rand_range(rng, gamma)
    mn, mx = float(img.min()), float(img.max())
    if mx - mn < 1e-8:
        return img
    x = (img.astype(np.float32) - mn) / (mx - mn)
    return (np.power(x, g) * (mx - mn) + mn).astype(img.dtype)


def brightness(img, rng, factor=(-0.1, 0.1)):
    f = _rand_range(rng, factor)
    rng_span = max(float(img.max()) - float(img.min()), 1e-8)
    return (img.astype(np.float32) + f * rng_span).astype(img.dtype)


def contrast(img, rng, factor=(-0.1, 0.1)):
    f = 1.0 + _rand_range(rng, factor)
    mean = float(img.mean())
    return ((img.astype(np.float32) - mean) * f + mean).astype(img.dtype)


def dropout(img, rng, drop_range=(0, 0.2)):
    p = _rand_range(rng, drop_range)
    mask = rng.random(img.shape[:-1]) >= p
    return img * mask[..., None].astype(img.dtype)


def grayscale(img, rng=None):
    if img.shape[-1] != 3:
        return img
    w = np.array([0.299, 0.587, 0.114], dtype=np.float32)
    g = np.tensordot(img.astype(np.float32), w, axes=([-1], [0]))
    return np.repeat(g[..., None], 3, axis=-1).astype(img.dtype)


def channel_shuffle(img, rng):
    if img.shape[-1] < 2:
        return img
    perm = rng.permutation(img.shape[-1])
    return img[..., perm]


# --------------------------------------------------------------------------
# cut* family
# --------------------------------------------------------------------------
def _rand_box(rng, shape_yx, size_range):
    h, w = shape_yx
    sy = max(1, int(_rand_range(rng, size_range) * h))
    sx = max(1, int(_rand_range(rng, size_range) * w))
    y0 = int(rng.integers(0, max(1, h - sy + 1)))
    x0 = int(rng.integers(0, max(1, w - sx + 1)))
    return y0, x0, sy, sx


def cutout(img, mask, rng, nb_iterations=(1, 3), size=(0.05, 0.3), cval=0.0, apply_to_mask=False):
    out = img.copy()
    mout = mask.copy() if (mask is not None and apply_to_mask) else mask
    n = int(rng.integers(nb_iterations[0], nb_iterations[1] + 1))
    for _ in range(n):
        y0, x0, sy, sx = _rand_box(rng, img.shape[-3:-1], size)
        sl = (Ellipsis, slice(y0, y0 + sy), slice(x0, x0 + sx), slice(None))
        out[sl] = cval
        if mout is not None and apply_to_mask:
            mout[sl] = 0
    return out, mout


def cutblur(img, rng, size=(0.2, 0.4), down_range=(2, 8), inside=True):
    """Replace a box with a down-up-sampled version (or the inverse)
    (reference: CutBlur; augmentors.py)."""
    out = img.astype(np.float32).copy()
    y0, x0, sy, sx = _rand_box(rng, img.shape[-3:-1], size)
    d = int(rng.integers(down_range[0], down_range[1] + 1))

    def degrade(x):
        hh, ww = x.shape[:2]
        small = _resize_nearest(x, max(1, ww // d), max(1, hh // d))
        return _resize_nearest(small, ww, hh)

    do_inside = inside or rng.random() < 0.5

    def one(sl2d):
        if do_inside:
            sl2d[y0 : y0 + sy, x0 : x0 + sx] = degrade(sl2d[y0 : y0 + sy, x0 : x0 + sx])
        else:
            deg = degrade(sl2d)
            deg[y0 : y0 + sy, x0 : x0 + sx] = sl2d[y0 : y0 + sy, x0 : x0 + sx]
            sl2d[:] = deg
        return sl2d

    if out.ndim == 4:
        for z in range(out.shape[0]):
            one(out[z])
    else:
        one(out)
    return out.astype(img.dtype)


def cutmix(img_a, img_b, mask_a, mask_b, rng, size=(0.2, 0.4)):
    """Swap a box between two samples (reference: CutMix variant that swaps
    image AND mask content)."""
    out_i, out_m = img_a.copy(), (mask_a.copy() if mask_a is not None else None)
    y0, x0, sy, sx = _rand_box(rng, img_a.shape[-3:-1], size)
    sl = (Ellipsis, slice(y0, y0 + sy), slice(x0, x0 + sx), slice(None))
    out_i[sl] = img_b[sl]
    if out_m is not None and mask_b is not None:
        out_m[sl] = mask_b[sl]
    return out_i, out_m


def cutnoise(img, rng, scale=(0.05, 0.1), nb_iterations=(1, 3), size=(0.2, 0.4)):
    out = img.astype(np.float32).copy()
    n = int(rng.integers(nb_iterations[0], nb_iterations[1] + 1))
    span = max(float(img.max()) - float(img.min()), 1e-8)
    for _ in range(n):
        y0, x0, sy, sx = _rand_box(rng, img.shape[-3:-1], size)
        s = _rand_range(rng, scale) * span
        sl = (Ellipsis, slice(y0, y0 + sy), slice(x0, x0 + sx), slice(None))
        out[sl] = out[sl] + rng.normal(0, s, out[sl].shape)
    return out.astype(img.dtype)


# --------------------------------------------------------------------------
# EM-specific
# --------------------------------------------------------------------------
def misalignment(img, mask, rng, displacement=16, rotate_ratio=0.5):
    """Shift (or rotate) a block of z-slices to simulate EM section
    misalignment (reference: augmentors.py misalignment)."""
    if img.ndim != 4 or img.shape[0] < 3:
        return img, mask
    out, mout = img.copy(), (mask.copy() if mask is not None else None)
    z0 = int(rng.integers(1, img.shape[0]))
    if rng.random() < rotate_ratio:
        ang = rng.uniform(-5, 5)
        h, w = img.shape[1:3]
        m2 = _rotation_matrix_2d((w / 2, h / 2), ang, 1.0)
        out[z0:] = _warp_affine(img[z0:], m2, True, "reflect101").astype(img.dtype)
        if mout is not None:
            mout[z0:] = _warp_affine(mask[z0:], m2, False, "reflect101").astype(mask.dtype)
    else:
        dy = int(rng.integers(-displacement, displacement + 1))
        dx = int(rng.integers(-displacement, displacement + 1))
        for z in range(z0, img.shape[0]):
            out[z] = np.roll(img[z], (dy, dx), axis=(0, 1))
            if mout is not None:
                mout[z] = np.roll(mask[z], (dy, dx), axis=(0, 1))
    return out, mout


def missing_sections(img, rng, iterations=(10, 30), channel_prob=0.5):
    """Zero random z-sections (reference: augmentors.py missing_sections)."""
    if img.ndim != 4 or img.shape[0] < 3:
        return img
    out = img.copy()
    n = int(rng.integers(iterations[0], iterations[1] + 1))
    n = min(n, max(1, img.shape[0] // 4))
    zs = rng.choice(img.shape[0], size=n, replace=False)
    for z in zs:
        if rng.random() < channel_prob:
            out[z] = 0
    return out


def gridmask(img, rng, ratio=0.6, d_range=(0.4, 1.0), rotate=1.0, invert=False):
    """GridMask occlusion (reference: augmentors.py GridMask). ``rotate``
    caps the random rotation of the grid pattern in degrees * 90 (the
    reference's rotate=1 -> up to 90deg)."""
    h, w = img.shape[-3:-1]
    d = int(_rand_range(rng, d_range) * min(h, w))
    d = max(2, d)
    keep = int(ratio * d)
    # build the grid on a diagonal-sized canvas so a rotated crop has no
    # blank corners, then rotate and crop the center
    if rotate:
        side = int(np.ceil(np.sqrt(h * h + w * w)))
    else:
        side = max(h, w)
    gy = ((np.arange(side + d) % d) < keep)[:side]
    gx = ((np.arange(side + d) % d) < keep)[:side]
    m = np.outer(gy, gx)
    if rotate:
        angle = float(rng.uniform(-90.0, 90.0)) * float(rotate)
        m = ndimage.rotate(m.astype(np.float32), angle, reshape=False,
                           order=0) > 0.5
    y0, x0 = (side - h) // 2, (side - w) // 2
    m = m[y0:y0 + h, x0:x0 + w]
    if invert:
        m = ~m
    return img * m[..., None].astype(img.dtype) if img.ndim == 3 else img * m[None, ..., None].astype(img.dtype)


# --------------------------------------------------------------------------
# noise family
# --------------------------------------------------------------------------
def gaussian_noise(img, rng, mean=0.0, var=0.05, use_input_stats=False):
    if use_input_stats:
        mean, var = float(img.mean()), float(img.var())
    noise = rng.normal(mean, np.sqrt(var), img.shape).astype(np.float32)
    return (img.astype(np.float32) + noise).astype(img.dtype)


def poisson_noise(img, rng):
    x = img.astype(np.float32)
    mn, mx = float(x.min()), float(x.max())
    span = max(mx - mn, 1e-8)
    x01 = (x - mn) / span
    # photon-count domain: quantized data keeps its own level count (the
    # reference formula); continuous float data — this pipeline augments
    # AFTER normalization — would see ~one level per pixel and the noise
    # would vanish, so cap at the uint8-equivalent 256 levels
    n_levels = len(np.unique(x01))
    if n_levels >= x01.size // 2:
        vals = 256.0
    else:
        vals = float(2 ** np.ceil(np.log2(max(n_levels, 2))))
    noisy = rng.poisson(x01 * vals) / vals
    return (noisy * span + mn).astype(img.dtype)


def salt(img, rng, amount=0.05):
    out = img.copy()
    m = rng.random(img.shape[:-1]) < amount
    out[m] = img.max()
    return out


def pepper(img, rng, amount=0.05):
    out = img.copy()
    m = rng.random(img.shape[:-1]) < amount
    out[m] = img.min()
    return out


def salt_and_pepper(img, rng, amount=0.05, prop=0.5):
    out = img.copy()
    m = rng.random(img.shape[:-1]) < amount
    salt_m = m & (rng.random(img.shape[:-1]) < prop)
    pep_m = m & ~salt_m
    out[salt_m] = img.max()
    out[pep_m] = img.min()
    return out


def zoom_3d_z(img, mask, rng, zoom_range=(0.5, 1.5)):
    """Zoom including the z axis (AUGMENTOR.ZOOM_IN_Z)."""
    f = _rand_range(rng, zoom_range)
    zf = [f] * (img.ndim - 1) + [1.0]
    out = ndimage.zoom(img, zf, order=1)
    mout = ndimage.zoom(mask, zf, order=0) if mask is not None else None
    # center-crop / pad back to the original shape
    out = _match_shape(out, img.shape)
    if mout is not None:
        mout = _match_shape(mout, mask.shape)
    return out, mout


def _match_shape(x, shape):
    slices, pads = [], []
    for d, (s, t) in enumerate(zip(x.shape, shape)):
        if s >= t:
            o = (s - t) // 2
            slices.append(slice(o, o + t))
            pads.append((0, 0))
        else:
            slices.append(slice(None))
            d0 = (t - s) // 2
            pads.append((d0, t - s - d0))
    x = x[tuple(slices)]
    if any(p != (0, 0) for p in pads):
        x = np.pad(x, pads, mode="reflect")
    return x


# --------------------------------------------------------------------------
# pipeline
# --------------------------------------------------------------------------
class AugmentorPipeline:
    """Config-driven augmentation pass over one (img, mask) pair.

    Each enabled op rolls independently against its own probability
    (reference: AUGMENTOR per-op *_PROB keys; the geometric trio composes
    into a single resampling, config.py:1104-1110).
    """

    def __init__(self, cfg, ndim: int = 2, channel_handler=None):
        self.a = cfg.AUGMENTOR
        self.ndim = ndim
        # TrainChannelHandler (data/tta.py): representation-aware geometric
        # handling of compiled instance channels — exact remap for flips /
        # rot90, regeneration from the carried label column for resampling
        # transforms (reference: pair_base_data_generator.py:1567).
        self.handler = channel_handler

    def _mask_geom(self, mask, t, needs_regen: bool) -> bool:
        """Fix mask channel CONTENTS after orthogonal transform ``t`` was
        applied spatially. Returns the updated needs_regen flag."""
        h = self.handler
        if h is None or mask is None:
            return needs_regen
        if h.supports(t):
            h.remap_forward(mask, t)
            return needs_regen
        return True  # e.g. 3D rays under rot90: only regeneration is exact

    def __call__(self, img, mask, rng: np.random.Generator):
        a = self.a
        if not a.ENABLE:
            return img, mask
        h = self.handler
        needs_regen = False
        affine_mode = (h.affine_mode if h is not None and h.affine_mode
                       else a.AFFINE_MODE)

        # -- composed affine pass -------------------------------------------
        zoom = rot = shear = shift = None
        if a.ZOOM and rng.random() < a.ZOOM_PROB:
            if self.ndim == 3 and a.ZOOM_IN_Z:
                img, mask = zoom_3d_z(img, mask, rng, a.ZOOM_RANGE)
                needs_regen = mask is not None
            else:
                f = _rand_range(rng, a.ZOOM_RANGE)
                zoom = (f, f)
        if a.RANDOM_ROT and rng.random() < a.RANDOM_ROT_PROB:
            rot = _rand_range(rng, a.RANDOM_ROT_RANGE)
        if a.SHEAR and rng.random() < a.SHEAR_PROB:
            shear = _rand_range(rng, a.SHEAR_RANGE)
        if a.SHIFT and rng.random() < a.SHIFT_PROB:
            s = _rand_range(rng, a.SHIFT_RANGE)
            shift = (s * rng.choice([-1, 1]), s * rng.choice([-1, 1]))
        if any(v is not None for v in (zoom, rot, shear, shift)):
            img, mask = affine_2d(img, mask, rng, zoom, rot, shear, shift, affine_mode)
            needs_regen = mask is not None

        if a.ROT90 and rng.random() < a.ROT90_PROB:
            k = int(rng.integers(1, 4))
            img, mask = rot90_k(img, mask, k)
            if h is not None and mask is not None:
                from biapy_tpu_torch.data.tta import rot90_transform

                needs_regen = self._mask_geom(
                    mask, rot90_transform(k, self.ndim), needs_regen)
        if a.VFLIP and rng.random() < a.VFLIP_PROB:
            img, mask = flip(img, mask, -3)
            if h is not None and mask is not None:
                from biapy_tpu_torch.data.tta import flip_transform

                needs_regen = self._mask_geom(
                    mask, flip_transform(self.ndim - 2, self.ndim), needs_regen)
        if a.HFLIP and rng.random() < a.HFLIP_PROB:
            img, mask = flip(img, mask, -2)
            if h is not None and mask is not None:
                from biapy_tpu_torch.data.tta import flip_transform

                needs_regen = self._mask_geom(
                    mask, flip_transform(self.ndim - 1, self.ndim), needs_regen)
        if self.ndim == 3 and a.ZFLIP and rng.random() < a.ZFLIP_PROB:
            img, mask = flip(img, mask, 0)
            if h is not None and mask is not None:
                from biapy_tpu_torch.data.tta import flip_transform

                needs_regen = self._mask_geom(
                    mask, flip_transform(0, self.ndim), needs_regen)
        if a.ELASTIC and rng.random() < a.ELASTIC_PROB:
            img, mask = elastic(img, mask, rng, a.E_ALPHA, a.E_SIGMA, a.E_MODE)
            needs_regen = needs_regen or mask is not None

        # -- image-only ops ----------------------------------------------------
        if a.G_BLUR and rng.random() < a.G_BLUR_PROB:
            img = gaussian_blur(img, rng, a.G_SIGMA)
        if a.MEDIAN_BLUR and rng.random() < a.MEDIAN_BLUR_PROB:
            img = median_blur(img, rng, a.MB_KERNEL)
        if a.MOTION_BLUR and rng.random() < a.MOTION_BLUR_PROB:
            img = motion_blur(img, rng, a.MOTB_K_RANGE)
        if a.GAMMA_CONTRAST and rng.random() < a.GAMMA_CONTRAST_PROB:
            img = gamma_contrast(img, rng, a.GC_GAMMA)
        if a.BRIGHTNESS and rng.random() < a.BRIGHTNESS_PROB:
            img = brightness(img, rng, a.BRIGHTNESS_FACTOR)
        if a.CONTRAST and rng.random() < a.CONTRAST_PROB:
            img = contrast(img, rng, a.CONTRAST_FACTOR)
        if a.DROPOUT and rng.random() < a.DROPOUT_PROB:
            img = dropout(img, rng, a.DROP_RANGE)
        if a.CUTOUT and rng.random() < a.CUTOUT_PROB:
            img, mask = cutout(img, mask, rng, a.COUT_NB_ITERATIONS, a.COUT_SIZE,
                               a.COUT_CVAL, a.COUT_APPLY_TO_MASK)
            needs_regen = needs_regen or (a.COUT_APPLY_TO_MASK and mask is not None)
        if a.CUTBLUR and rng.random() < a.CUTBLUR_PROB:
            img = cutblur(img, rng, a.CBLUR_SIZE, a.CBLUR_DOWN_RANGE, a.CBLUR_INSIDE)
        if a.CUTNOISE and rng.random() < a.CUTNOISE_PROB:
            img = cutnoise(img, rng, a.CNOISE_SCALE, a.CNOISE_NB_ITERATIONS, a.CNOISE_SIZE)
        if self.ndim == 3 and a.MISALIGNMENT and rng.random() < a.MISALIGNMENT_PROB:
            img, mask = misalignment(img, mask, rng, a.MS_DISPLACEMENT, a.MS_ROTATE_RATIO)
            needs_regen = needs_regen or mask is not None
        if self.ndim == 3 and a.MISSING_SECTIONS and rng.random() < a.MISSING_SECTIONS_PROB:
            img = missing_sections(img, rng, a.MISSP_ITERATIONS, a.MISSP_CHANNEL_PB)
        if a.GRAYSCALE and rng.random() < a.GRAYSCALE_PROB:
            img = grayscale(img, rng)
        if a.CHANNEL_SHUFFLE and rng.random() < a.CHANNEL_SHUFFLE_PROB:
            img = channel_shuffle(img, rng)
        if a.GRIDMASK and rng.random() < a.GRIDMASK_PROB:
            img = gridmask(img, rng, a.GRID_RATIO, a.GRID_D_RANGE, a.GRID_ROTATE, a.GRID_INVERT)
        if a.GAUSSIAN_NOISE and rng.random() < a.GAUSSIAN_NOISE_PROB:
            img = gaussian_noise(img, rng, a.GAUSSIAN_NOISE_MEAN, a.GAUSSIAN_NOISE_VAR,
                                 a.GAUSSIAN_NOISE_USE_INPUT_IMG_MEAN_AND_VAR)
        if a.POISSON_NOISE and rng.random() < a.POISSON_NOISE_PROB:
            img = poisson_noise(img, rng)
        if a.SALT and rng.random() < a.SALT_PROB:
            img = salt(img, rng, a.SALT_AMOUNT)
        if a.PEPPER and rng.random() < a.PEPPER_PROB:
            img = pepper(img, rng, a.PEPPER_AMOUNT)
        if a.SALT_AND_PEPPER and rng.random() < a.SALT_AND_PEPPER_PROB:
            img = salt_and_pepper(img, rng, a.SALT_AND_PEPPER_AMOUNT, a.SALT_AND_PEPPER_PROP)
        if needs_regen and h is not None and mask is not None and h.can_regen:
            mask = h.regen(np.ascontiguousarray(mask, dtype=np.float32))
        return img, mask

    @property
    def uses_cutmix(self) -> bool:
        return bool(self.a.CUTMIX)

    def maybe_cutmix(self, img_a, mask_a, img_b, mask_b, rng):
        if self.a.CUTMIX and rng.random() < self.a.CUTMIX_PROB:
            img_a, mask_a = cutmix(img_a, img_b, mask_a, mask_b, rng, self.a.CMIX_SIZE)
            # the pasted box severs instance channels at its border —
            # recompile from the combined label column (reference regenerates
            # after every transform, pair_base_data_generator.py:1567)
            h = self.handler
            if h is not None and mask_a is not None and h.can_regen:
                mask_a = h.regen(np.ascontiguousarray(mask_a, dtype=np.float32))
        return img_a, mask_a
