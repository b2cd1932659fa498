"""Training/eval data generators: the host-side input pipeline, copied from
the JAX package's ``data/generators.py`` (``PairDataset``, ``BatchLoader``,
``save_aug_samples``, ``check_generator_consistence``).

A deterministic sample pipeline (seeded per (seed, epoch, position)) feeds a
background prefetch thread; batches are channels-last numpy arrays, padded
to the batch size; the workflow moves them to its device. The shuffle, the
``DATA.PREPROCESS`` ops and the augmentations (``AUGMENTOR.*``, CutMix) are
the JAX package's, numpy draw for numpy draw, so both packages see the same
batches in the same order. The loader's threads each resample with at most
two torch threads (``AUG_THREADS``). Multi-process sharding comes with the
runtime (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from biapy_tpu_torch.data.augmentors import AugmentorPipeline
from biapy_tpu_torch.data.dataset import BiaPyDataset
from biapy_tpu_torch.data.io import _is_chunked, read_img_as_ndarray, read_patch_as_ndarray
from biapy_tpu_torch.data.norm import normalize_image, normalize_mask
from biapy_tpu_torch.data.patching import extract_patch, scale_coords
from biapy_tpu_torch.data.pre_processing import preprocess_image

PREFETCH = 2  # batches the loader's thread prepares ahead
AUG_THREADS = 2  # torch threads of each loader thread (the warps' grid_sample)


class PairDataset:
    """Image+mask sample source with pre-processing, normalization and
    augmentation. ``augment`` marks the training set: its samples take
    ``AUGMENTOR.*`` (when enabled) and ``DATA.PREPROCESS.TRAIN``, and its
    random crops follow ``DATA.TRAIN.PROBABILITY_MAP``. ``channel_handler``
    is the instance workflows' (``data/tta.py::TrainChannelHandler``): it
    remaps or regenerates the compiled channels under augmentation, and its
    label column is dropped before a sample leaves ``get``; semantic
    segmentation passes None.

    The restoration workflows' options: ``target_fn(img, gt, rng) -> (x, y)``
    runs last, on the augmented sample with the sample's own rng (N2V
    manipulation, crappify, image-target normalisation); ``y_upscaling``
    scales the GT crops (super-resolution targets live in HR space); with
    ``gt_as_image`` the targets are value-normalised like the inputs
    instead of binarised as masks, CutMix partners included."""

    def __init__(
        self,
        ds: BiaPyDataset,
        cfg,
        norm_spec: Dict,
        augment: bool = True,
        random_crop: bool = False,
        n_classes: int = 2,
        channel_handler=None,
        target_fn: Optional[Callable] = None,
        y_upscaling: Sequence[int] = (),
        gt_as_image: bool = False,
    ):
        self.ds = ds
        self.cfg = cfg
        self.is_3d = cfg.PROBLEM.NDIM == "3D"
        self.nd = 3 if self.is_3d else 2
        self.crop_shape = tuple(cfg.DATA.PATCH_SIZE)
        self.norm_spec = norm_spec
        self.channel_handler = channel_handler
        self.aug = (AugmentorPipeline(cfg, self.nd, channel_handler=channel_handler)
                    if augment else None)
        self._grid_overlay = False  # save_aug_samples draws a grid on its samples
        self.random_crop = random_crop
        self.n_classes = n_classes
        self.target_fn = target_fn
        self.y_upscaling = list(y_upscaling) if y_upscaling else [1] * self.nd
        self.gt_as_image = gt_as_image

    def __len__(self) -> int:
        return len(self.ds.sample_list)

    def _load(self, idx: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        s = self.ds.sample_list[idx]
        f = self.ds.dataset_info[s.fid]
        img, gt = s.img, s.gt
        # DATA.PREPROCESS for samples materialized here (in-memory samples
        # were preprocessed at dataset build, before the patch grid)
        pre = self.cfg.DATA.PREPROCESS
        pre = pre if (pre.TRAIN if self.aug is not None else pre.VAL) else None
        if img is None:
            if s.coords is not None and _is_chunked(f.path):
                # Lazy Zarr/H5: stream only this patch's region from disk.
                img = read_patch_as_ndarray(f.path, s.coords, is_3d=self.is_3d,
                                            data_path=f.data_path, axes_order=f.input_axes)
                if f.gt_path:
                    gt = read_patch_as_ndarray(f.gt_path,
                                               scale_coords(s.coords, self.y_upscaling),
                                               is_3d=self.is_3d,
                                               data_path=f.gt_data_path,
                                               axes_order=f.gt_input_axes)
                if self.cfg.DATA.FORCE_RGB and img.shape[-1] == 1:
                    img = np.repeat(img, 3, axis=-1)
                if pre is not None:  # per-patch ops (resize rejected at build)
                    img = preprocess_image(pre, img, is_2d=not self.is_3d)
                return img, gt
            # disk-backed sample: mirror EXACTLY the geometry the dataset
            # build computed its patch grid on (FORCE_RGB, preprocess,
            # reflect pad) — coords live in that processed space
            img = read_img_as_ndarray(f.path, is_3d=self.is_3d, data_path=f.data_path,
                                      axes_order=f.input_axes)
            if self.cfg.DATA.FORCE_RGB and img.shape[-1] == 1:
                img = np.repeat(img, 3, axis=-1)
            gt_full = None
            if f.gt_path:
                gt_full = read_img_as_ndarray(f.gt_path, is_3d=self.is_3d,
                                              data_path=f.gt_data_path,
                                              axes_order=f.gt_input_axes)
            if pre is not None:
                img = preprocess_image(pre, img, is_2d=not self.is_3d)
                if gt_full is not None:
                    gt_full = preprocess_image(pre, gt_full, is_mask=not self.gt_as_image,
                                               only_resize=True, is_2d=not self.is_3d)
            if bool(self.cfg.DATA.REFLECT_TO_COMPLETE_SHAPE) or self.random_crop:
                from biapy_tpu_torch.data.patching import pad_to_min_shape

                img, _ = pad_to_min_shape(img, self.crop_shape[: self.nd])
                if gt_full is not None:
                    gt_full, _ = pad_to_min_shape(gt_full, [
                        self.crop_shape[d] * self.y_upscaling[d] for d in range(self.nd)])
            if s.coords is not None:
                img = extract_patch(img, s.coords)
            if gt_full is not None:
                gt = (extract_patch(gt_full, scale_coords(s.coords, self.y_upscaling))
                      if s.coords is not None else gt_full)
        return img, gt

    def _prob_map_cdf(self, idx: int, gt: np.ndarray):
        """Foreground-weighted sampling distribution for random crops
        (reference: calculate_volume_prob_map, pre_processing.py:3524 —
        DATA.TRAIN.PROBABILITY_MAP with W_FOREGROUND/W_BACKGROUND)."""
        cache = getattr(self, "_pm_cache", None)
        if cache is None:
            cache = self._pm_cache = {}
        ent = cache.get(idx)
        if ent is None:
            from scipy import ndimage

            tr = self.cfg.DATA.TRAIN
            fg = (gt > 0).any(axis=-1)

            # drop border-touching objects (reference uses clear_border):
            # per-slice in 3D, matching the reference's loop over z
            def _clear(m2):
                lab, n = ndimage.label(m2)
                if n:
                    edge = np.unique(np.concatenate([
                        lab[0], lab[-1], lab[:, 0], lab[:, -1]]))
                    m2 = m2 & ~np.isin(lab, edge[edge > 0])
                return m2
            if fg.ndim == 3:
                fg = np.stack([_clear(fg[z]) for z in range(fg.shape[0])])
            else:
                fg = _clear(fg)
            n_fg, n_bg = int(fg.sum()), int((~fg).sum())
            # W_FOREGROUND is the TOTAL mass of the foreground region
            # (reference divides by the pixel counts, pre_processing.py:3584)
            w = np.where(fg, float(tr.W_FOREGROUND) / max(n_fg, 1) * (n_fg > 0),
                         float(tr.W_BACKGROUND) / max(n_bg, 1) * (n_bg > 0))
            tot = w.sum()
            if tot <= 0:
                w = np.full(fg.shape, 1.0 / fg.size)
                tot = 1.0
            cdf = np.cumsum(w.ravel() / tot)
            ent = cache[idx] = (cdf, fg.shape)
        return ent

    def _random_crop(self, img, gt, rng, idx=None):
        ps = self.crop_shape[: self.nd]
        if self.cfg.DATA.TRAIN.PROBABILITY_MAP and gt is not None and self.aug is not None:
            # sample the crop center from the foreground-weighted map, then
            # clamp the window inside the image
            cdf, shape = self._prob_map_cdf(-1 if idx is None else int(idx), gt)
            flat = int(np.searchsorted(cdf, float(rng.random())))
            center = np.unravel_index(min(flat, int(np.prod(shape)) - 1), shape)
            starts = [int(np.clip(center[d] - ps[d] // 2, 0,
                                  max(0, img.shape[d] - ps[d])))
                      for d in range(self.nd)]
        else:
            starts = [int(rng.integers(0, max(1, img.shape[d] - ps[d] + 1)))
                      for d in range(self.nd)]
        sl = tuple(slice(st, st + ps[d]) for d, st in enumerate(starts))
        if gt is None:
            return img[sl], None
        gsl = tuple(slice(st * u, (st + ps[d]) * u)
                    for d, (st, u) in enumerate(zip(starts, self.y_upscaling)))
        return img[sl], gt[gsl]

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        img, gt = self._load(idx)
        if self.random_crop:
            img, gt = self._random_crop(img, gt, rng, idx)
        f = self.ds.dataset_info[self.ds.sample_list[idx].fid]
        img, _ = normalize_image(img, self.norm_spec, stats=f.norm_stats)
        if gt is not None:
            gt = self._norm_target(gt)
        if self.aug is not None:
            if self.aug.uses_cutmix and len(self) > 1:
                j = int(rng.integers(0, len(self)))
                img_b, gt_b = self._load(j)
                if self.random_crop:
                    img_b, gt_b = self._random_crop(img_b, gt_b, rng, j)
                f_b = self.ds.dataset_info[self.ds.sample_list[j].fid]
                img_b, _ = normalize_image(img_b, self.norm_spec, stats=f_b.norm_stats)
                if gt_b is not None:
                    # the partner's target goes the primary's way: a binarised
                    # image target would paste a silhouette into it
                    gt_b = self._norm_target(gt_b)
                img, gt = self.aug.maybe_cutmix(img, gt, img_b, gt_b, rng)
            if self._grid_overlay:
                img = _draw_grid(img)
            img, gt = self.aug(img, gt, rng)
        ch = self.channel_handler
        if gt is not None and ch is not None and ch.label_col is not None:
            # the compile cache's raw instance-label column serves only the
            # train-time regeneration of geometry-derived channels
            gt = np.delete(gt, ch.label_col, axis=-1)
        if self.target_fn is not None:
            img, gt = self.target_fn(img, gt, rng)
        out = {"x": np.ascontiguousarray(img, dtype=np.float32)}
        if gt is not None:
            out["y"] = np.ascontiguousarray(gt, dtype=np.float32)
        return out

    def _norm_target(self, gt: np.ndarray) -> np.ndarray:
        """An image target value-normalised on its own statistics; a mask
        that is not float yet binarised."""
        if self.gt_as_image:
            return normalize_image(gt.astype(np.float32), self.norm_spec)[0]
        if gt.dtype.kind != "f":
            return normalize_mask(gt, self.n_classes)
        return gt


class BatchLoader:
    """Epoch iterator: shuffles, batches (the last batch padded with copies
    of its last sample), and prefetches on a background thread (the
    host-pipeline parallelism that torch DataLoader workers provide in the
    reference, misc.py:1148)."""

    def __init__(
        self,
        dataset: PairDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = -1,
        replicate: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        # sample-loading thread pool (the reference's DataLoader worker
        # budget, misc.py:1148 — capped at 8 there too)
        if num_workers < 0:
            num_workers = min(8, max(1, (os.cpu_count() or 2) // 2))
        self.num_workers = num_workers
        self.replicate = max(1, int(replicate))
        self._pool = None
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) * self.replicate
        return (n + self.batch_size - 1) // self.batch_size

    def _index_order(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.replicate > 1:
            # DATA.TRAIN.REPLICATE / extra_data_factor: each epoch walks the
            # dataset N times (useful for tiny datasets with heavy
            # augmentation; reference generators/__init__.py:301)
            idx = np.tile(idx, self.replicate)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def _get_one(self, pos_and_idx):
        pos, i = pos_and_idx
        # rng keyed on the EPOCH POSITION, not the dataset index, so
        # REPLICATE'd walks of the same sample draw different augmentations
        rng = np.random.default_rng((self.seed, self.epoch, int(pos)))
        return self.dataset.get(int(i), rng)

    def _make_batch(self, indices: List) -> Dict[str, np.ndarray]:
        if self.num_workers > 1 and len(indices) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                # torch.set_num_threads in a thread sizes that thread's
                # OpenMP team: the workers do not each start a full pool
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                                thread_name_prefix="loader",
                                                initializer=torch.set_num_threads,
                                                initargs=(AUG_THREADS,))
            samples = list(self._pool.map(self._get_one, indices))
        else:
            samples = [self._get_one(i) for i in indices]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        if len(indices) < self.batch_size:
            pad = self.batch_size - len(indices)
            batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]) for k, v in batch.items()}
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(enumerate(self._index_order()))  # (epoch position, idx)
        chunks = [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = object()

        err: List[BaseException] = []

        def producer():
            try:
                for c in chunks:
                    q.put(self._make_batch(list(c)))
            except BaseException as e:  # re-raised on the consumer side —
                # a swallowed error would silently truncate the epoch
                err.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
        if err:
            raise err[0]


def _draw_grid(img: np.ndarray, spacing: Optional[int] = None) -> np.ndarray:
    """Overlay bright grid lines so geometric augmentations (elastic, shear,
    rotation) are visible in saved samples (reference: draw_grid option of
    get_transformed_samples, generators/__init__.py:404-412)."""
    img = img.copy()
    v = float(img.max()) if img.size else 1.0
    sp = spacing or max(8, img.shape[-2] // 5)
    # lines along the last two spatial axes (works for 2D and 3D stacks)
    img[..., ::sp, :, :] = v
    img[..., :, ::sp, :] = v
    return img


def save_aug_samples(dataset: PairDataset, out_dir: str, n: int = 10,
                     draw_grid: bool = True, seed: int = 0):
    """Save ``n`` augmented training samples (with their un-augmented
    originals) for visual inspection (reference: AUGMENTOR.AUG_SAMPLES,
    generators/__init__.py:404-412)."""
    from biapy_tpu_torch.data.io import save_tif

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = min(n, len(dataset))
    try:
        if draw_grid:
            dataset._grid_overlay = True
        for i in range(n):
            idx = int(rng.integers(0, len(dataset)))
            out = dataset.get(idx, rng)
            save_tif(out["x"][None], out_dir, [f"aug_{i}_x.tif"], verbose=False)
            if "y" in out:
                save_tif(out["y"][None], out_dir, [f"aug_{i}_y.tif"], verbose=False)
    finally:
        dataset._grid_overlay = False


def check_generator_consistence(loader: BatchLoader, out_dir: str, n: int = 3,
                                mask_dir: Optional[str] = None):
    """Dump generator output for visual inspection (reference:
    DATA.CHECK_GENERATORS, generators/__init__.py:884; masks go to
    PATHS.GEN_MASK_CHECKS when given)."""
    from biapy_tpu_torch.data.io import save_tif

    os.makedirs(out_dir, exist_ok=True)
    it = iter(loader)
    batch = next(it)
    save_tif(batch["x"][:n], os.path.join(out_dir, "x"), verbose=False)
    if "y" in batch:
        save_tif(batch["y"][:n], mask_dir or os.path.join(out_dir, "y"), verbose=False)
