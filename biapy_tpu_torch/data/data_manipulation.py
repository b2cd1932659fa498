"""Train/val/test dataset preparation, copied from the JAX package's
``data/data_manipulation.py``.

Builds metadata-first ``BiaPyDataset`` objects: scan directories, pair image
and GT files by sorted order, compute the patch-coordinate grid (overlap +
padding) per file, optionally load pixels in memory, split train/val
(fraction, k-fold, or separate dir), and filter samples by simple
properties (foreground fraction / mean / min / max).

Zarr/N5/HDF5 inputs as in the JAX package: the Zarr multiple-data layout
(``DATA.*.INPUT_ZARR_MULTIPLE_DATA``, raw and GT at inner paths of one
file), ``DATA.*.INPUT_IMG_AXES_ORDER`` and, with ``IN_MEMORY: False``, lazy
samples whose patches stream from disk (``io.read_patch_as_ndarray``).
``DATA.PREPROCESS`` runs on every image as it is read, before the patch
grid and the normalisation statistics (``data/pre_processing.py``). The
restoration workflows' options are the JAX package's too: the
super-resolution GT grid scaled by ``y_upscaling``, image GT pre-processed
as an image (``gt_as_image``) and the image-to-image
multiple-raw-one-target layout (``scan_multiple_raw_one_target``).

Not ported, raising ``NotImplementedError`` that names the roadmap: a
stratified k-fold through ``load_and_prepare_train_data`` (the JAX
package's StratifiedKFold branch, which its classification workflow never
reaches; ROADMAP section 3).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from biapy_tpu_torch.data.dataset import BiaPyDataset, DataSample, DatasetFile
from biapy_tpu_torch.data.io import (_is_chunked, lazy_image_shape, list_image_files,
                                     read_img_as_ndarray, read_patch_as_ndarray)
from biapy_tpu_torch.data.norm import normalize_image
from biapy_tpu_torch.data.patching import (compute_patch_grid, extract_patch, pad_to_min_shape,
                                           scale_coords)
from biapy_tpu_torch.data.pre_processing import preprocess_image


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to biapy_tpu_torch yet (ROADMAP: {item})")


def _scan_pairs(x_path: str, y_path: Optional[str]) -> List[Tuple[str, Optional[str]]]:
    xs = list_image_files(x_path)
    if not xs:
        raise FileNotFoundError(f"No images found in {x_path}")
    if y_path is None:
        return [(x, None) for x in xs]
    ys = list_image_files(y_path)
    if len(xs) != len(ys):
        raise ValueError(f"Image/GT count mismatch: {len(xs)} in {x_path} vs {len(ys)} in {y_path}")
    return list(zip(xs, ys))


def scan_multiple_raw_one_target(x_root: str, y_root: Optional[str]) -> List[Tuple[str, Optional[str]]]:
    """Folder-of-folders layout: each subfolder of ``x_root`` holds several
    acquisitions of the same scene, paired with the SINGLE target image in
    the same-named subfolder of ``y_root`` (reference:
    PROBLEM.IMAGE_TO_IMAGE.MULTIPLE_RAW_ONE_TARGET_LOADER,
    data_manipulation.py:306 — the LightMyCells layout)."""
    subs = sorted(d for d in os.listdir(x_root)
                  if os.path.isdir(os.path.join(x_root, d)))
    if not subs:
        raise FileNotFoundError(
            f"MULTIPLE_RAW_ONE_TARGET_LOADER expects subfolders under {x_root}")
    pairs: List[Tuple[str, Optional[str]]] = []
    for d in subs:
        raws = list_image_files(os.path.join(x_root, d))
        tgt = None
        if y_root is not None:
            tgts = list_image_files(os.path.join(y_root, d))
            if len(tgts) != 1:
                raise ValueError(
                    f"Expected exactly one target in {os.path.join(y_root, d)}, "
                    f"found {len(tgts)}")
            tgt = tgts[0]
        pairs.extend((r, tgt) for r in raws)
    return pairs


def _sample_props(img: np.ndarray, gt: Optional[np.ndarray]) -> Dict[str, float]:
    """Reference formulas (sample_satisfy_conds, data_manipulation.py:2877):
    target_* are GT-intensity stats; diff is the L1 image/target difference,
    optionally scaled by the image or target intensity range (here the
    sample's own range — the reference uses the enclosing image's)."""
    props = {
        "mean": float(img.mean()),
        "min": float(img.min()),
        "max": float(img.max()),
        "foreground": float((gt > 0).mean()) if gt is not None else 0.0,
    }
    if gt is not None:
        props["target_mean"] = float(gt.mean())
        props["target_min"] = float(gt.min())
        props["target_max"] = float(gt.max())
        if gt.shape == img.shape:
            d = float(np.sum(np.abs(img.astype(np.float64) - gt)))
            props["diff"] = d
            props["diff_by_min_max_ratio"] = d * float(img.max() - img.min())
            props["diff_by_target_min_max_ratio"] = d * float(gt.max() - gt.min())
    return props


_SIGN_FNS = {
    "gt": lambda a, b: a > b, "lt": lambda a, b: a < b,
    "ge": lambda a, b: a >= b, "le": lambda a, b: a <= b,
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "gte": lambda a, b: a >= b, "lte": lambda a, b: a <= b,
}


def filter_samples_by_properties(
    ds: BiaPyDataset,
    props: Sequence[Sequence[str]],
    values: Sequence[Sequence[float]],
    signs: Sequence[Sequence[str]],
    is_3d: bool,
    save_dir: Optional[str] = None,
    save_num: int = 3,
    by_image: bool = False,
    norm_spec: Optional[Dict] = None,
    preprocess_cfg=None,
    crop_shape: Optional[Sequence[int]] = None,
    reflect: bool = False,
) -> BiaPyDataset:
    """Drop samples matching any AND-group of (prop, sign, value) conditions
    (reference: filter_samples_by_properties, data_manipulation.py:2415).
    ``save_dir`` dumps the first ``save_num`` dropped samples for inspection
    (reference: DATA.SAVE_FILTERED_IMAGES / PATHS.FIL_SAMPLES_DIR).
    ``by_image`` evaluates the conditions on the WHOLE image, dropping every
    patch of a failing file together (reference: DATA.FILTER_BY_IMAGE);
    ``norm_spec`` normalizes before measuring (FILTER_SAMPLES.NORM_BEFORE)."""
    if not props:
        return ds
    kept = []
    dropped_saved = 0
    file_verdicts: Dict[int, bool] = {}

    def _decide(img, gt, stats=None) -> bool:
        if norm_spec is not None:
            # the file's cached stats, so the measured values match what
            # training actually sees (fresh per-patch stats can differ by
            # orders of magnitude for integer data)
            img, _ = normalize_image(img, norm_spec, stats=stats)
        p = _sample_props(img, gt)
        for group_p, group_v, group_s in zip(props, values, signs):
            vals = [p.get(pr) for pr in group_p]
            if any(v is None for v in vals):
                continue  # not measurable on this sample (e.g. diff w/o GT)
            if all(_SIGN_FNS[sg](v, vv) for v, vv, sg in zip(vals, group_v, group_s)):
                return True
        return False

    for s in ds.sample_list:
        f = ds.dataset_info[s.fid]
        img = s.img
        gt = s.gt
        if by_image and s.fid in file_verdicts:
            if not file_verdicts[s.fid]:
                kept.append(s)
            continue
        if img is None or by_image:
            if s.coords and _is_chunked(f.path) and not by_image:
                img = read_patch_as_ndarray(f.path, s.coords, is_3d=is_3d,
                                            data_path=f.data_path, axes_order=f.input_axes)
                if f.gt_path:
                    gt = read_patch_as_ndarray(f.gt_path, s.coords, is_3d=is_3d,
                                               data_path=f.gt_data_path, axes_order=f.gt_input_axes)
            else:
                img = read_img_as_ndarray(f.path, is_3d=is_3d, data_path=f.data_path,
                                          axes_order=f.input_axes)
                gt = None
                if f.gt_path:
                    gt = read_img_as_ndarray(f.gt_path, is_3d=is_3d, data_path=f.gt_data_path,
                                             axes_order=f.gt_input_axes)
                # mirror the geometry the patch grid was computed on
                # (preprocess + reflect pad), else coords select the wrong
                # region of the raw image
                if preprocess_cfg is not None:
                    img = preprocess_image(preprocess_cfg, img, is_2d=not is_3d)
                    if gt is not None:
                        gt = preprocess_image(preprocess_cfg, gt, is_mask=True,
                                              only_resize=True, is_2d=not is_3d)
                if reflect and crop_shape is not None:
                    img, _ = pad_to_min_shape(img, crop_shape[: img.ndim - 1])
                    if gt is not None:
                        gt, _ = pad_to_min_shape(gt, crop_shape[: gt.ndim - 1])
                if s.coords and not by_image:
                    img = extract_patch(img, s.coords)
                    if gt is not None:
                        gt = extract_patch(gt, s.coords)
        drop = _decide(img, gt, stats=f.norm_stats)
        if by_image:
            file_verdicts[s.fid] = drop
        if not drop:
            kept.append(s)
        elif save_dir and dropped_saved < save_num:
            from biapy_tpu_torch.data.io import save_tif

            stem = os.path.splitext(os.path.basename(f.path))[0]
            save_tif(img[None], save_dir, [f"filtered_{dropped_saved}_{stem}.tif"],
                     verbose=False)
            dropped_saved += 1
    out = BiaPyDataset(dataset_info=ds.dataset_info, sample_list=kept)
    if len(kept) == 0:
        raise ValueError("All samples were filtered out by DATA.*.FILTER_SAMPLES")
    return out


def build_dataset(
    x_path: str,
    y_path: Optional[str],
    crop_shape: Sequence[int],
    overlap: Sequence[float],
    padding: Sequence[int],
    is_3d: bool,
    in_memory: bool = True,
    norm_spec: Optional[Dict] = None,
    reflect_to_complete_shape: bool = True,
    whole_images: bool = False,
    convert_to_rgb: bool = False,
    input_axes: Optional[str] = None,
    zarr_multiple: bool = False,
    raw_path_in_file: Optional[str] = None,
    gt_path_in_file: Optional[str] = None,
    preprocess_cfg=None,
    y_upscaling: Sequence[int] = (),
    gt_as_image: bool = False,
    multiple_raw_one_target: bool = False,
) -> BiaPyDataset:
    """Scan a directory pair into a BiaPyDataset with patch-grid samples.

    ``whole_images``: one sample per image (random-crop training mode or
    per-image test mode); otherwise a full patch grid per image.
    ``zarr_multiple``: raw + GT live inside one Zarr/H5 per file at
    ``raw_path_in_file`` / ``gt_path_in_file`` (reference:
    DATA.*.INPUT_ZARR_MULTIPLE_DATA, samples_from_zarr
    data_manipulation.py:1850). Chunked files with ``in_memory=False``
    become LAZY: only metadata is read here, pixels stream patch-by-patch
    at sample time. ``preprocess_cfg`` (DATA.PREPROCESS) runs on every
    image read here, before the grid and the statistics. ``y_upscaling``: SR
    factor — GT coords are scaled accordingly (reference: LR->HR crop
    pairing through the data layer). ``gt_as_image``: True for image
    targets, which the pre-processing resizes as images.
    """
    nd = 3 if is_3d else 2
    up = list(y_upscaling) if y_upscaling else [1] * nd
    if zarr_multiple:
        xs = list_image_files(x_path)
        if not xs:
            raise FileNotFoundError(f"No Zarr/H5 files found in {x_path}")
        if gt_path_in_file:
            pairs = [(x, x) for x in xs]  # raw + GT nested in the same file
        elif y_path and os.path.isdir(y_path) and y_path != x_path:
            # raw nested in the zarr, GT in a separate dir
            ys = list_image_files(y_path)
            if len(xs) != len(ys):
                raise ValueError(f"Image/GT count mismatch: {len(xs)} vs {len(ys)}")
            pairs = list(zip(xs, ys))
        else:
            pairs = [(x, None) for x in xs]
    elif multiple_raw_one_target:
        pairs = scan_multiple_raw_one_target(x_path, y_path)
    else:
        pairs = _scan_pairs(x_path, y_path)
    ds = BiaPyDataset()
    for fi, (xp, yp) in enumerate(pairs):
        dpath = raw_path_in_file if zarr_multiple else None
        same_file = yp == xp
        gpath = gt_path_in_file if zarr_multiple and same_file else None
        if not in_memory and _is_chunked(xp):
            if preprocess_cfg is not None and preprocess_cfg.RESIZE.ENABLE:
                raise ValueError(
                    "DATA.PREPROCESS.RESIZE cannot be combined with lazy Zarr/H5 "
                    "streaming (patches are read straight from disk); load the data "
                    "in memory or resize it offline")
            # Lazy path: metadata only; per-patch normalization at load time.
            g_ax = input_axes if same_file else None
            shape, _ = lazy_image_shape(xp, is_3d=is_3d, data_path=dpath, axes_order=input_axes)
            gt_shape = None
            if yp is not None:
                gt_shape, _ = lazy_image_shape(yp, is_3d=is_3d, data_path=gpath, axes_order=g_ax)
            f = DatasetFile(path=xp, shape=shape, gt_path=yp, gt_shape=gt_shape,
                            input_axes=input_axes, gt_input_axes=g_ax,
                            data_path=dpath, gt_data_path=gpath)
            ds.dataset_info.append(f)
            if whole_images:
                ds.sample_list.append(DataSample(fid=fi, coords=None))
            else:
                coords, _ = compute_patch_grid(shape[:nd], crop_shape[:nd], overlap, padding)
                ds.sample_list.extend(DataSample(fid=fi, coords=pc) for pc in coords)
            continue
        # axes orders only describe chunked (Zarr/H5) layouts; TIFF readers
        # use the channels-last heuristic.
        ax = input_axes if _is_chunked(xp) else None
        g_ax = ax if same_file else None
        img = read_img_as_ndarray(xp, is_3d=is_3d, data_path=dpath, axes_order=ax)
        if convert_to_rgb and img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        gt = read_img_as_ndarray(yp, is_3d=is_3d, data_path=gpath, axes_order=g_ax) if yp else None
        if preprocess_cfg is not None:
            # before grid/stats: resize changes geometry (reference:
            # preprocess_data at load, pre_processing.py:3872)
            img = preprocess_image(preprocess_cfg, img, is_2d=not is_3d)
            if gt is not None:
                gt = preprocess_image(preprocess_cfg, gt, is_mask=not gt_as_image,
                                      only_resize=True, is_2d=not is_3d)
        if reflect_to_complete_shape:
            img, _ = pad_to_min_shape(img, crop_shape[:nd])
            if gt is not None:
                gt, _ = pad_to_min_shape(gt, [crop_shape[d] * up[d] for d in range(nd)])
        stats = None
        if norm_spec is not None:
            _, stats = normalize_image(img, norm_spec)
        f = DatasetFile(path=xp, shape=img.shape, gt_path=yp,
                        gt_shape=gt.shape if gt is not None else None, norm_stats=stats,
                        input_axes=ax, gt_input_axes=g_ax,
                        data_path=dpath, gt_data_path=gpath)
        ds.dataset_info.append(f)
        if whole_images:
            ds.sample_list.append(DataSample(fid=fi, coords=None,
                                             img=img if in_memory else None,
                                             gt=gt if in_memory else None))
        else:
            coords, _ = compute_patch_grid(img.shape[:nd], crop_shape[:nd], overlap, padding)
            for pc in coords:
                s = DataSample(fid=fi, coords=pc)
                if in_memory:
                    s.img = extract_patch(img, pc)
                    if gt is not None:
                        s.gt = extract_patch(gt, scale_coords(pc, up))
                ds.sample_list.append(s)
    return ds


def split_train_val(
    ds: BiaPyDataset, val_split: float, seed: int, shuffle: bool = True,
    cross_val: bool = False, cross_val_nsplits: int = 5, cross_val_fold: int = 1,
) -> Tuple[BiaPyDataset, BiaPyDataset]:
    """Fraction split or k-fold split over SAMPLES (reference:
    load_and_prepare_train_data val handling). The classification
    workflow's stratified k-fold comes with that workflow."""
    n = len(ds.sample_list)
    idx = np.arange(n)
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(idx)
    if cross_val:
        fold_size = math.ceil(n / cross_val_nsplits)
        lo = (cross_val_fold - 1) * fold_size
        hi = min(n, lo + fold_size)
        val_idx = set(idx[lo:hi].tolist())
    else:
        n_val = int(round(n * val_split))
        val_idx = set(idx[:n_val].tolist())
    tr, va = BiaPyDataset(dataset_info=ds.dataset_info), BiaPyDataset(dataset_info=ds.dataset_info)
    for i, s in enumerate(ds.sample_list):
        (va if i in val_idx else tr).sample_list.append(s)
    return tr, va


def _multiple_raw_one_target(cfg) -> bool:
    return cfg.PROBLEM.TYPE == "IMAGE_TO_IMAGE" and bool(
        cfg.PROBLEM.IMAGE_TO_IMAGE.MULTIPLE_RAW_ONE_TARGET_LOADER)


def load_and_prepare_train_data(cfg, norm_spec: Optional[Dict] = None,
                                y_upscaling: Sequence[int] = (),
                                gt_as_image: bool = False) -> Tuple[BiaPyDataset, BiaPyDataset]:
    """Top-level train+val preparation from config (reference:
    load_and_prepare_train_data, data_manipulation.py:83)."""
    is_3d = cfg.PROBLEM.NDIM == "3D"
    crop_shape = tuple(cfg.DATA.PATCH_SIZE)
    random_crops = bool(cfg.DATA.TRAIN.EXTRACT_RANDOM_PATCH)
    use_gt = _needs_gt(cfg)
    pre = cfg.DATA.PREPROCESS
    mrot = _multiple_raw_one_target(cfg)

    train = build_dataset(
        cfg.DATA.TRAIN.PATH,
        cfg.DATA.TRAIN.GT_PATH if use_gt else None,
        crop_shape,
        tuple(cfg.DATA.TRAIN.OVERLAP),
        tuple(cfg.DATA.TRAIN.PADDING),
        is_3d=is_3d,
        in_memory=bool(cfg.DATA.TRAIN.IN_MEMORY),
        norm_spec=norm_spec,
        reflect_to_complete_shape=bool(cfg.DATA.REFLECT_TO_COMPLETE_SHAPE) or random_crops,
        whole_images=random_crops,
        convert_to_rgb=bool(cfg.DATA.FORCE_RGB),
        input_axes=str(cfg.DATA.TRAIN.INPUT_IMG_AXES_ORDER) or None,
        zarr_multiple=bool(cfg.DATA.TRAIN.INPUT_ZARR_MULTIPLE_DATA),
        raw_path_in_file=str(cfg.DATA.TRAIN.INPUT_ZARR_MULTIPLE_DATA_RAW_PATH) or None,
        gt_path_in_file=(str(cfg.DATA.TRAIN.INPUT_ZARR_MULTIPLE_DATA_GT_PATH) or None) if use_gt else None,
        preprocess_cfg=pre if pre.TRAIN else None,
        y_upscaling=y_upscaling,
        gt_as_image=gt_as_image,
        multiple_raw_one_target=mrot,
    )
    fs = cfg.DATA.TRAIN.FILTER_SAMPLES
    if fs.ENABLE:
        train = filter_samples_by_properties(
            train, fs.PROPS, fs.VALUES, fs.SIGNS, is_3d,
            save_dir=(cfg.PATHS.FIL_SAMPLES_DIR if cfg.DATA.SAVE_FILTERED_IMAGES else None),
            save_num=int(cfg.DATA.SAVE_FILTERED_IMAGES_NUM),
            by_image=bool(cfg.DATA.FILTER_BY_IMAGE),
            norm_spec=(norm_spec if fs.NORM_BEFORE else None),
            preprocess_cfg=pre if pre.TRAIN else None,
            crop_shape=crop_shape,
            reflect=bool(cfg.DATA.REFLECT_TO_COMPLETE_SHAPE) or random_crops)

    if not cfg.DATA.VAL.FROM_TRAIN:
        val = build_dataset(
            cfg.DATA.VAL.PATH,
            cfg.DATA.VAL.GT_PATH if use_gt else None,
            crop_shape,
            tuple(cfg.DATA.VAL.OVERLAP),
            tuple(cfg.DATA.VAL.PADDING),
            is_3d=is_3d,
            in_memory=bool(cfg.DATA.VAL.IN_MEMORY),
            norm_spec=norm_spec,
            reflect_to_complete_shape=bool(cfg.DATA.REFLECT_TO_COMPLETE_SHAPE) or random_crops,
            whole_images=random_crops,
            convert_to_rgb=bool(cfg.DATA.FORCE_RGB),
            input_axes=str(cfg.DATA.VAL.INPUT_IMG_AXES_ORDER) or None,
            zarr_multiple=bool(cfg.DATA.VAL.INPUT_ZARR_MULTIPLE_DATA),
            raw_path_in_file=str(cfg.DATA.VAL.INPUT_ZARR_MULTIPLE_DATA_RAW_PATH) or None,
            gt_path_in_file=(str(cfg.DATA.VAL.INPUT_ZARR_MULTIPLE_DATA_GT_PATH) or None) if use_gt else None,
            preprocess_cfg=pre if pre.VAL else None,
            y_upscaling=y_upscaling,
            gt_as_image=gt_as_image,
            multiple_raw_one_target=mrot,
        )
        vfs = cfg.DATA.VAL.FILTER_SAMPLES
        if vfs.ENABLE:
            val = filter_samples_by_properties(
                val, vfs.PROPS, vfs.VALUES, vfs.SIGNS, is_3d,
                by_image=bool(cfg.DATA.FILTER_BY_IMAGE),
                norm_spec=(norm_spec if vfs.NORM_BEFORE else None))
    else:
        if cfg.PROBLEM.TYPE == "CLASSIFICATION" and bool(cfg.DATA.VAL.CROSS_VAL):
            # the classification workflow splits its own datasets, unstratified
            # as the JAX workflow does; only this direct call would stratify
            raise _not_ported("the stratified k-fold of a direct call",
                              "section 3, the classification k-fold is never stratified")
        train, val = split_train_val(
            train,
            float(cfg.DATA.VAL.SPLIT_TRAIN),
            seed=cfg.SYSTEM.SEED,
            cross_val=bool(cfg.DATA.VAL.CROSS_VAL),
            cross_val_nsplits=int(cfg.DATA.VAL.CROSS_VAL_NFOLD),
            cross_val_fold=int(cfg.DATA.VAL.CROSS_VAL_FOLD),
        )
    return train, val


def load_and_prepare_test_data(cfg, norm_spec: Optional[Dict] = None,
                               gt_as_image: bool = False) -> BiaPyDataset:
    """Per-image test dataset: one whole-image sample per file (reference:
    load_and_prepare_test_data, data_manipulation.py:955)."""
    is_3d = cfg.PROBLEM.NDIM == "3D"
    use_gt = bool(cfg.DATA.TEST.LOAD_GT)
    if cfg.PROBLEM.TYPE == "INSTANCE_SEG" and str(cfg.PROBLEM.INSTANCE_SEG.TYPE) == "synapses":
        use_gt = False  # synapse GT are CREMI point annotations, not arrays
    ds = build_dataset(
        cfg.DATA.TEST.PATH,
        cfg.DATA.TEST.GT_PATH if use_gt else None,
        tuple(cfg.DATA.PATCH_SIZE),
        (0.0,) * (3 if is_3d else 2),
        (0,) * (3 if is_3d else 2),
        is_3d=is_3d,
        in_memory=bool(cfg.DATA.TEST.IN_MEMORY),
        norm_spec=norm_spec,
        reflect_to_complete_shape=bool(cfg.DATA.REFLECT_TO_COMPLETE_SHAPE),
        whole_images=True,
        convert_to_rgb=bool(cfg.DATA.FORCE_RGB),
        input_axes=str(cfg.DATA.TEST.INPUT_IMG_AXES_ORDER) or None,
        zarr_multiple=bool(cfg.DATA.TEST.INPUT_ZARR_MULTIPLE_DATA),
        raw_path_in_file=str(cfg.DATA.TEST.INPUT_ZARR_MULTIPLE_DATA_RAW_PATH) or None,
        gt_path_in_file=(str(cfg.DATA.TEST.INPUT_ZARR_MULTIPLE_DATA_GT_PATH) or None) if use_gt else None,
        preprocess_cfg=cfg.DATA.PREPROCESS if cfg.DATA.PREPROCESS.TEST else None,
        gt_as_image=gt_as_image,
        multiple_raw_one_target=_multiple_raw_one_target(cfg),
    )
    tfs = cfg.DATA.TEST.FILTER_SAMPLES
    if tfs.ENABLE:
        ds = filter_samples_by_properties(
            ds, tfs.PROPS, tfs.VALUES, tfs.SIGNS, is_3d,
            by_image=True,  # test samples are whole images
            norm_spec=(norm_spec if tfs.NORM_BEFORE else None))
    return ds


def prepare_in_memory_test_data(image: np.ndarray, gt: Optional[np.ndarray], is_3d: bool) -> BiaPyDataset:
    """Wrap an in-memory array for the Python predict() API (reference:
    prepare_in_memory_test_data, data_manipulation.py:1086)."""
    from biapy_tpu_torch.data.io import ensure_channels_last

    img = ensure_channels_last(np.asarray(image), 3 if is_3d else 2)
    g = ensure_channels_last(np.asarray(gt), 3 if is_3d else 2) if gt is not None else None
    ds = BiaPyDataset()
    ds.dataset_info.append(DatasetFile(path="<in_memory>", shape=img.shape))
    ds.sample_list.append(DataSample(fid=0, coords=None, img=img, gt=g))
    return ds


def _needs_gt(cfg) -> bool:
    if cfg.PROBLEM.TYPE == "DENOISING":
        # supervised (GAN) denoising pairs noisy/clean images
        return bool(cfg.PROBLEM.DENOISING.LOAD_GT_DATA)
    return cfg.PROBLEM.TYPE not in ("CLASSIFICATION", "SELF_SUPERVISED")
