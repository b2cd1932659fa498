"""Image IO, copied from the JAX package's ``data/io.py``: TIFF and ``.npy``
files (``imread``, ``imwrite``, ``read_img_as_ndarray``, ``list_image_files``,
``save_tif``) and the layout helpers (``ensure_channels_last`` and its
``_fit_axes_order``). HDF5, Zarr, NIfTI and PNG/JPG raise
``NotImplementedError``: their readers come with the by-chunks engine
(ROADMAP queue 1 item 6).

Convention preserved from the reference: images are channels-last ndarrays —
``(y, x, c)`` in 2D, ``(z, y, x, c)`` in 3D.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from biapy_tpu_torch.data.tiff import read_tiff, write_tiff

TIFF_EXTS = (".tif", ".tiff")
H5_EXTS = (".h5", ".hdf5", ".hdf")
ZARR_EXTS = (".zarr", ".n5")
PNG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")
NPY_EXTS = (".npy",)
NIFTI_EXTS = (".nii", ".nii.gz")

SUPPORTED_EXTS = TIFF_EXTS + H5_EXTS + ZARR_EXTS + PNG_EXTS + NPY_EXTS + NIFTI_EXTS


def _is_nifti(path: str) -> bool:
    p = path.lower()  # the file lister matches case-insensitively too
    return p.endswith(".nii") or p.endswith(".nii.gz")


def _format_not_ported(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"reading or writing {path!r}: only TIFF and .npy files are ported to biapy_tpu_torch "
        "yet; HDF5, Zarr, NIfTI and PNG/JPG come with the data readers (ROADMAP queue 1 item 6, "
        "5, by-chunks engine)")


def imread(path: str, data_path: Optional[str] = None) -> np.ndarray:
    """Read an image file into an ndarray (no axis normalization applied)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in TIFF_EXTS:
        return read_tiff(path)
    if ext in NPY_EXTS:
        return np.load(path)
    raise _format_not_ported(path)


def imwrite(path: str, data: np.ndarray, data_path: Optional[str] = None) -> None:
    """Write an ndarray to ``path``, dispatching on extension."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext in TIFF_EXTS:
        write_tiff(path, data)
        return
    if ext in NPY_EXTS:
        np.save(path, data)
        return
    raise _format_not_ported(path)


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


def read_img_as_ndarray(path: str, is_3d: bool = False, data_path: Optional[str] = None,
                        axes_order: Optional[str] = None) -> np.ndarray:
    """Read an image and normalize to channels-last (reference:
    data_manipulation.py:3417)."""
    return ensure_channels_last(imread(path, data_path), 3 if is_3d else 2, axes_order=axes_order)


def list_image_files(directory: str) -> List[str]:
    """Sorted list of image files (or zarr dirs) in a directory: the same
    list as the JAX package's, so that images pair with their masks the
    same way; the formats not ported yet raise when read."""
    out = []
    for name in sorted(os.listdir(directory)):
        p = os.path.join(directory, name)
        ext = os.path.splitext(name)[1].lower()
        if ext in SUPPORTED_EXTS or _is_nifti(name.lower()):
            out.append(p)
        elif os.path.isdir(p) and (
            os.path.exists(os.path.join(p, ".zarray")) or os.path.exists(os.path.join(p, ".zgroup"))
        ):
            out.append(p)
    return out


def save_tif(
    data: np.ndarray,
    out_dir: str,
    filenames: Optional[List[str]] = None,
    verbose: bool = True,
) -> None:
    """Save a batch of images as TIFFs (reference: data_manipulation.py:3821).

    ``data`` is (n, y, x, c) or (n, z, y, x, c).
    """
    os.makedirs(out_dir, exist_ok=True)
    if verbose:
        print(f"Saving {len(data)} images in {out_dir} . . .")
    for i in range(len(data)):
        if filenames is not None:
            base = os.path.splitext(os.path.basename(filenames[i]))[0] + ".tif"
        else:
            base = f"{i:03d}.tif"
        write_tiff(os.path.join(out_dir, base), data[i])
