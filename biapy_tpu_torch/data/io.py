"""Image layout helpers, copied from the JAX package's ``data/io.py``
(``ensure_channels_last`` and its ``_fit_axes_order``). The file readers and
writers of that module are not part of the serving slice yet.

Convention preserved from the reference: images are channels-last ndarrays —
``(y, x, c)`` in 2D, ``(z, y, x, c)`` in 3D.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _fit_axes_order(order: str, disk_ndim: int) -> str:
    """Adapt a configured axes order (e.g. the 'TZCYX' default) to data with
    fewer axes by dropping the non-spatial letters (T, then C) — matching the
    reference's tolerance for DATA.*.INPUT_IMG_AXES_ORDER supersets."""
    order = order.upper()
    for drop in ("T", "C"):
        if len(order) > disk_ndim and drop in order:
            order = order.replace(drop, "")
    if len(order) != disk_ndim:
        raise ValueError(f"axes_order '{order}' does not match data ndim {disk_ndim}")
    return order


def ensure_channels_last(img: np.ndarray, ndim: int, axes_order: Optional[str] = None) -> np.ndarray:
    """Normalize an image to the channels-last convention.

    ``ndim`` is the problem dimensionality (2 or 3); output is ``(y, x, c)``
    or ``(z, y, x, c)``. ``axes_order`` (e.g. "ZCYX", "TZCYX") overrides the
    heuristic, matching ``DATA.*.INPUT_IMG_AXES_ORDER`` semantics.
    """
    img = np.asarray(img)
    if axes_order:
        # tolerate superset orders (the 'TZCYX' config default) on data with
        # fewer axes, like the by-chunks lazy path (_fit_axes_order)
        axes_order = _fit_axes_order(axes_order, img.ndim)
        # Drop any singleton T axis.
        if "T" in axes_order:
            t = axes_order.index("T")
            if img.shape[t] != 1:
                raise ValueError("Time axis with size > 1 not supported")
            img = np.take(img, 0, axis=t)
            axes_order = axes_order.replace("T", "")
        want = "ZYXC" if ndim == 3 else "YXC"
        if "C" not in axes_order:
            img = img[..., None]
            axes_order += "C"
        if set(axes_order) != set(want):
            raise ValueError(f"axes_order '{axes_order}' incompatible with {want}")
        img = np.transpose(img, [axes_order.index(a) for a in want])
        return img

    if ndim == 2:
        if img.ndim == 2:
            return img[..., None]
        if img.ndim == 3:
            # channels-first (c small, leading) -> move to last
            if img.shape[0] <= 4 and img.shape[-1] > 4:
                return np.moveaxis(img, 0, -1)
            return img
        raise ValueError(f"Cannot interpret shape {img.shape} as a 2D image")
    else:
        if img.ndim == 3:
            return img[..., None]
        if img.ndim == 4:
            if img.shape[0] <= 4 and img.shape[-1] > 4:
                return np.moveaxis(img, 0, -1)
            return img
        raise ValueError(f"Cannot interpret shape {img.shape} as a 3D volume")
