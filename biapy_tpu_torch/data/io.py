"""Image IO, copied from the JAX package's ``data/io.py``: TIFF, ``.npy``,
NIfTI (``data/nifti.py``, numpy and gzip only), Zarr v2 / N5
(``data/zarr_store.py``, numpy and zlib only), HDF5 (``h5py``, optional:
imported only inside the functions that open an ``.h5`` file) and PNG/JPG
(``imageio``, optional likewise) — ``imread``, ``imwrite``, ``read_img_as_ndarray``,
``list_image_files``, ``save_tif``, the lazy readers the by-chunks engine
and the lazy training samples stream from (``open_lazy``,
``lazy_image_shape``, ``LazyCanonicalView``, ``read_patch_lazy``,
``read_patch_as_ndarray``) and the layout helpers
(``ensure_channels_last`` and its ``_fit_axes_order``).

Convention preserved from the reference: images are channels-last ndarrays —
``(y, x, c)`` in 2D, ``(z, y, x, c)`` in 3D.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

import numpy as np

from biapy_tpu_torch.data.tiff import read_tiff, write_tiff
from biapy_tpu_torch.data.zarr_store import ZarrArray, ZarrGroup, open_zarr

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


def _imageio(path: str):
    """``imageio.v2``, which PNG/JPG files need; a clear error without it."""
    try:
        import imageio.v2 as iio
    except ImportError as e:
        raise ImportError(
            f"reading or writing {path!r}: PNG/JPG files need the optional package "
            "'imageio', which is not installed; TIFF, NIfTI, .npy, Zarr, N5 and HDF5 "
            "files need nothing beyond numpy") from e
    return iio


def _norm_inner_path(data_path: str) -> str:
    """Nested Zarr/H5 paths accept dot notation (reference:
    read_chunked_nested_zarr, data_3D_manipulation.py:1423)."""
    return data_path.replace(".", "/") if "/" not in data_path else data_path


def _first_h5_dataset(h5file, data_path: Optional[str] = None):
    import h5py

    if data_path:
        return h5file[_norm_inner_path(data_path)]
    found = []

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset) and not found:
            found.append(obj)

    h5file.visititems(visit)
    if not found:
        raise ValueError(f"No dataset found in HDF5 file {h5file.filename}")
    return found[0]


def _first_zarr_array(z: Union[ZarrArray, ZarrGroup], data_path: Optional[str] = None) -> ZarrArray:
    if isinstance(z, ZarrArray):
        return z
    if data_path:
        arr = z[_norm_inner_path(data_path)]
        if isinstance(arr, ZarrArray):
            return arr
        raise ValueError(f"{data_path} is a group, not an array")
    for name in z.keys():
        sub = z[name]
        if isinstance(sub, ZarrArray):
            return sub
        if isinstance(sub, ZarrGroup):
            try:
                return _first_zarr_array(sub)
            except ValueError:
                continue
    raise ValueError(f"No array found in zarr group {z.path}")


def imread(path: str, data_path: Optional[str] = None) -> np.ndarray:
    """Read an image file into an ndarray (no axis normalization applied)."""
    if _is_nifti(path):
        from biapy_tpu_torch.data.nifti import read_nifti

        return read_nifti(path)
    ext = os.path.splitext(path)[1].lower()
    if ext in TIFF_EXTS:
        return read_tiff(path)
    if ext in H5_EXTS:
        import h5py

        with h5py.File(path, "r") as f:
            return _first_h5_dataset(f, data_path)[...]
    if ext in ZARR_EXTS or (os.path.isdir(path) and (
            os.path.exists(os.path.join(path, ".zarray"))
            or os.path.exists(os.path.join(path, ".zgroup"))
            or os.path.exists(os.path.join(path, "attributes.json")))):
        return np.asarray(_first_zarr_array(open_zarr(path), data_path))
    if ext in NPY_EXTS:
        return np.load(path)
    if ext in PNG_EXTS:
        return np.asarray(_imageio(path).imread(path))
    raise ValueError(f"Unsupported image extension: {path}")


def open_lazy(path: str, data_path: Optional[str] = None):
    """Open a chunked file (zarr/h5) without reading it; returns an
    array-like supporting slicing, plus a file handle to close (or None).

    Reference analog: ``load_img_part_from_efficient_file`` and the lazy
    handles used throughout biapy/data/data_3D_manipulation.py.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext in H5_EXTS:
        import h5py

        f = h5py.File(path, "r")
        return _first_h5_dataset(f, data_path), f
    if ext in ZARR_EXTS or (os.path.isdir(path) and (
            os.path.exists(os.path.join(path, ".zarray"))
            or os.path.exists(os.path.join(path, ".zgroup"))
            or os.path.exists(os.path.join(path, "attributes.json")))):
        return _first_zarr_array(open_zarr(path), data_path), None
    # Non-chunked formats: read fully.
    return imread(path, data_path), None


def _is_chunked(path: str) -> bool:
    ext = os.path.splitext(path)[1].lower()
    return ext in H5_EXTS or ext in ZARR_EXTS or (
        os.path.isdir(path) and (os.path.exists(os.path.join(path, ".zarray"))
                                 or os.path.exists(os.path.join(path, ".zgroup"))
                                 or os.path.exists(os.path.join(path, "attributes.json"))))


def _default_axes_order(disk_shape: Tuple[int, ...], ndim: int) -> str:
    """Heuristic on-disk axes order for a chunked file (mirrors
    ``ensure_channels_last``'s channels-first/last guess)."""
    n = len(disk_shape)
    spatial = "ZYX" if ndim == 3 else "YX"
    if n == ndim:
        return spatial
    if n == ndim + 1:
        if disk_shape[0] <= 4 and disk_shape[-1] > 4:
            return "C" + spatial
        return spatial + "C"
    if n == ndim + 2 and disk_shape[0] == 1:
        return "T" + (_default_axes_order(disk_shape[1:], ndim))
    raise ValueError(f"Cannot interpret disk shape {disk_shape} as a {ndim}D image")


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


def lazy_image_shape(path: str, is_3d: bool = False, data_path: Optional[str] = None,
                     axes_order: Optional[str] = None) -> Tuple[Tuple[int, ...], np.dtype]:
    """Channels-last logical shape + dtype of a chunked file WITHOUT loading
    pixels (reference analog: load_3D_efficient_files shape discovery,
    data_3D_manipulation.py)."""
    arr, fh = open_lazy(path, data_path)
    try:
        disk_shape = tuple(int(s) for s in arr.shape)
        dtype = np.dtype(arr.dtype)
    finally:
        if fh is not None:
            fh.close()
    nd = 3 if is_3d else 2
    order = (_fit_axes_order(axes_order, len(disk_shape)) if axes_order
             else _default_axes_order(disk_shape, nd))
    want = ("ZYXC" if is_3d else "YXC")
    out = []
    for a in want:
        out.append(disk_shape[order.index(a)] if a in order else 1)
    return tuple(out), dtype


class LazyCanonicalView:
    """Channels-last lazy view over a chunked array with arbitrary on-disk
    axes order (``DATA.*.INPUT_IMG_AXES_ORDER``): exposes a canonical
    (z,)y,x,c ``shape`` and translates canonical slices to on-disk slices on
    access, so by-chunks streaming never materialises the volume (reference
    analog: the order_dimensions slice translation in
    chunked_test_pair_data_generator.py:194,524)."""

    def __init__(self, arr, is_3d: bool = True, axes_order: Optional[str] = None):
        disk_shape = tuple(int(s) for s in arr.shape)
        self.arr = arr
        self.nd = 3 if is_3d else 2
        self.order = (_fit_axes_order(axes_order, len(disk_shape)) if axes_order
                      else _default_axes_order(disk_shape, self.nd))
        want = "ZYXC" if is_3d else "YXC"
        self.shape = tuple(disk_shape[self.order.index(a)] if a in self.order else 1
                           for a in want)
        self.dtype = np.dtype(arr.dtype)

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        key = tuple(key) + (slice(None),) * (self.nd + 1 - len(key))
        spatial = "ZYX" if self.nd == 3 else "YX"
        sl = []
        for a in self.order:
            if a in spatial:
                sl.append(key[spatial.index(a)])
            elif a == "C":
                sl.append(key[self.nd])
            else:  # T: first frame
                sl.append(slice(0, 1))
        region = np.asarray(self.arr[tuple(sl)])
        return ensure_channels_last(region, self.nd, axes_order=self.order)


def read_patch_lazy(path: str, starts, ends, is_3d: bool = False,
                    data_path: Optional[str] = None,
                    axes_order: Optional[str] = None) -> np.ndarray:
    """Read only a spatial region of a chunked (zarr/h5) file, returned
    channels-last. ``starts``/``ends`` are (y,x) or (z,y,x) in logical
    channels-last space and must be in-bounds (callers handle padding).

    Reference analog: extract_patch_from_efficient_file
    (data_3D_manipulation.py:210)."""
    arr, fh = open_lazy(path, data_path)
    try:
        disk_shape = tuple(int(s) for s in arr.shape)
        nd = 3 if is_3d else 2
        order = (_fit_axes_order(axes_order, len(disk_shape)) if axes_order
                 else _default_axes_order(disk_shape, nd))
        spatial = "ZYX" if is_3d else "YX"
        sl = []
        for a in order:
            if a in spatial:
                i = spatial.index(a)
                sl.append(slice(int(starts[i]), int(ends[i])))
            else:  # C or T
                sl.append(slice(None))
        region = arr[tuple(sl)]
    finally:
        if fh is not None:
            fh.close()
    return ensure_channels_last(np.asarray(region), nd, axes_order=order)


_LAZY_SHAPE_CACHE: dict = {}


def read_patch_as_ndarray(path: str, coords, is_3d: bool = False,
                          data_path: Optional[str] = None,
                          axes_order: Optional[str] = None,
                          pad_type: str = "reflect") -> np.ndarray:
    """Lazy patch read honoring out-of-bounds ``PatchCoords`` (negative
    starts / ends beyond the volume): the in-bounds region is read from disk
    and the overhang is filled by padding, matching ``extract_patch``."""
    # the logical shape is constant per file — cache it so the training
    # hot loop doesn't open/parse every chunked file twice per patch
    key = (path, data_path, is_3d, axes_order)
    shape = _LAZY_SHAPE_CACHE.get(key)
    if shape is None:
        shape, _ = lazy_image_shape(path, is_3d=is_3d, data_path=data_path,
                                    axes_order=axes_order)
        if len(_LAZY_SHAPE_CACHE) > 4096:
            _LAZY_SHAPE_CACHE.clear()
        _LAZY_SHAPE_CACHE[key] = shape
    nd = 3 if is_3d else 2
    starts, ends, pads = [], [], []
    for d in range(nd):
        s, e = int(coords.starts[d]), int(coords.ends[d])
        pads.append((max(0, -s), max(0, e - shape[d])))
        starts.append(max(0, s))
        ends.append(min(shape[d], e))
    region = read_patch_lazy(path, starts, ends, is_3d=is_3d,
                             data_path=data_path, axes_order=axes_order)
    if any(p != (0, 0) for p in pads):
        region = np.pad(region, pads + [(0, 0)] * (region.ndim - nd), mode=pad_type)
    return region


def imwrite(path: str, data: np.ndarray, data_path: Optional[str] = None) -> None:
    """Write an ndarray to ``path``, dispatching on extension."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if _is_nifti(path):
        from biapy_tpu_torch.data.nifti import write_nifti

        write_nifti(path, data)
        return
    ext = os.path.splitext(path)[1].lower()
    if ext in TIFF_EXTS:
        write_tiff(path, data)
        return
    if ext in H5_EXTS:
        import h5py

        with h5py.File(path, "w") as f:
            # same dot->slash normalization imread applies, so a
            # write/read round trip with equal data_path succeeds
            f.create_dataset(_norm_inner_path(data_path) if data_path else "data",
                             data=data, compression="gzip")
        return
    if ext in ZARR_EXTS:
        target = path
        if data_path:
            target = os.path.join(path, *_norm_inner_path(data_path).split("/"))
            os.makedirs(path, exist_ok=True)
            zg = os.path.join(path, ".zgroup")
            if not os.path.exists(zg):
                with open(zg, "w") as f:
                    f.write('{"zarr_format": 2}')
        arr = ZarrArray.create(
            target,
            shape=data.shape,
            chunks=tuple(min(s, 256) for s in data.shape),
            dtype=data.dtype,
            compressor={"id": "zlib", "level": 1},
            overwrite=True,
        )
        arr[tuple(slice(None) for _ in data.shape)] = data
        return
    if ext in NPY_EXTS:
        np.save(path, data)
        return
    if ext in PNG_EXTS:
        _imageio(path).imwrite(path, data)
        return
    raise ValueError(f"Unsupported image extension: {path}")


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
    """Sorted list of readable image files (or zarr dirs) in a directory."""
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
