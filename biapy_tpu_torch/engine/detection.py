"""Detection workflow: point heatmap regression.

Counterpart of ``biapy_tpu/engine/detection.py``: GT points (CSV files of
(z,)y,x coordinates, or point masks) are dilated into point masks
(``data/pre_processing.py::create_detection_masks``, cached in
DATA.<split>.DETECTION_MASK_DIR as TIFFs byte-identical to the JAX
package's, so either package reuses the other's); the model regresses the
heatmap with rebalanced BCE; at test time peaks are extracted
(``peak_local_max`` or ``blob_log``, threshold manual or Otsu), filtered by
the border box and TEST.POST_PROCESSING.REMOVE_CLOSE_POINTS, written to
CSV, optionally grown into instances (DET_WATERSHED), and scored against
the GT points within TEST.DET_TOLERANCE. By chunks, points are extracted
tile by tile with core ownership and merged once over the volume.

With DATA.N_CLASSES > 2 the model grows a separated class head: the GT
masks carry each point's class (the CSVs' ``class`` column) over its blob,
the loss adds the class cross-entropy on the blobs, each point takes the
majority class of the head's argmax around it, and the CSVs and the
metrics carry the classes.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict, List, Optional

import numpy as np

from biapy_tpu_torch.data.io import list_image_files, read_img_as_ndarray, save_tif
from biapy_tpu_torch.data.post_processing import peak_local_max, remove_close_points
from biapy_tpu_torch.data.pre_processing import create_detection_masks
from biapy_tpu_torch.engine import metrics as M
from biapy_tpu_torch.engine.base_workflow import Base_Workflow
from biapy_tpu_torch.utils.matching import detection_metrics


def _bbox_keep(points: np.ndarray, box, shape, nd: int) -> np.ndarray:
    """Mask of the points outside the DET_IGNORE_POINTS_OUTSIDE_BOX border
    margin."""
    box = list(box or [])
    keep = np.ones(len(points), bool)
    for d in range(min(nd, len(box))):
        m = int(box[d])
        if m > 0 and len(points):
            keep &= (points[:, d] >= m) & (points[:, d] <= max(shape[d] - m, 0))
    return keep


def _filter_bbox(points: np.ndarray, box, shape, nd: int) -> np.ndarray:
    """Drop points within the DET_IGNORE_POINTS_OUTSIDE_BOX border margin."""
    if not list(box or []) or not len(points):
        return points
    return points[_bbox_keep(points, box, shape, nd)]


def _test_resolution(cfg, nd: int):
    """DATA.TEST.RESOLUTION as an nd-tuple; the unset sentinel (-1) means
    isotropic voxel units."""
    res = [float(r) for r in cfg.DATA.TEST.RESOLUTION]
    if not res or any(r <= 0 for r in res) or len(res) < nd:
        return (1.0,) * nd
    return tuple(res[:nd])


def read_points_csv(path: str, ndim: int, with_classes: bool = False):
    """Read point coordinates from a CSV. A header with 'axis-0'/'axis-1'/
    'axis-2' (and 'class') columns selects by NAME — pandas-style exports
    carry a leading unnamed index column that positional parsing would
    misread as the first coordinate (the reference reads df['axis-0'] by
    name, detection.py:660). Headerless files fall back to positional
    (z,)y,x [,class]. With ``with_classes`` also returns the per-point class
    column (1 where absent)."""
    with open(path) as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        coords = np.zeros((0, ndim), np.float32)
        return (coords, np.zeros(0, np.int32)) if with_classes else coords

    axis_names = [f"axis-{d}" for d in range(ndim)]
    header = rows[0]
    col_idx = None
    if any(h.strip().lower() in axis_names for h in header):
        names = [h.strip().lower() for h in header]
        col_idx = [names.index(a) for a in axis_names if a in names]
        if len(col_idx) != ndim:
            raise ValueError(f"CSV {path} names only {len(col_idx)} of the "
                             f"{ndim} coordinate columns {axis_names}")
        cls_idx = names.index("class") if "class" in names else None
        body = rows[1:]
    else:
        body = rows
        cls_idx = ndim

    pts, cls = [], []
    for row in body:
        try:
            if col_idx is not None:
                vals = [float(row[i]) for i in col_idx]
            else:
                vals = [float(v) for v in row[:ndim]]
        except ValueError:
            continue  # headerless-mode header line
        pts.append(vals)
        try:
            cls.append(float(row[cls_idx]) if cls_idx is not None
                       and cls_idx < len(row) else 1.0)
        except (ValueError, TypeError):
            cls.append(1.0)
    coords = np.asarray(pts, dtype=np.float32).reshape(-1, ndim)
    if with_classes:
        return coords, np.asarray(cls, np.int32).reshape(-1)
    return coords


def points_from_mask(mask: np.ndarray) -> np.ndarray:
    """Centroids of the connected components of a point mask."""
    from scipy import ndimage

    from biapy_tpu_torch.native import connected_components

    lab, n = connected_components(mask > 0.5)
    if n == 0:
        return np.zeros((0, mask.ndim), np.float32)
    coms = ndimage.center_of_mass(mask > 0.5, lab, range(1, n + 1))
    return np.asarray(coms, dtype=np.float32)


def write_points_csv(path: str, coords: np.ndarray, nd: int, cast=int,
                     classes: Optional[np.ndarray] = None) -> None:
    """Points as a CSV with the 'axis-0'.. header ``read_points_csv`` reads,
    and a 'class' column when ``classes`` is given."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["axis-0", "axis-1", "axis-2"][:nd] + (["class"] if classes is not None
                                                          else []))
        for i, c in enumerate(coords):
            w.writerow([cast(v) for v in c] + ([int(classes[i])] if classes is not None
                                               else []))


class Detection_Workflow(Base_Workflow):
    def define_activations_and_channels(self):
        self.n_classes = max(int(self.cfg.DATA.N_CLASSES), 2)
        self.output_channels = [1]
        self.activations = ["ce_sigmoid"]
        self._act_channels = [1]
        self.output_channel_info = ["points"]
        self.separated_class_channel = self.n_classes > 2
        if self.separated_class_channel:
            # the points heatmap and an N_CLASSES softmax class head
            # (reference: detection.py:143-148); the class probabilities
            # travel flat after the heatmap at inference
            self.output_channels = [1, self.n_classes]
            self.activations = ["ce_sigmoid", "ce_softmax"]
            self._act_channels = [1, self.n_classes]
            self.output_channel_info = ["points", "class"]

    def define_metrics(self):
        det = self.cfg.PROBLEM.DETECTION
        self.loss = M.detection_loss(
            channel_weights=tuple(det.DATA_CHANNEL_WEIGHTS),
            class_rebalance_within_channels=bool(det.CLASS_REBALANCE_WITHIN_CHANNELS),
            num_classes=self.n_classes,
        )
        self.train_metrics = {"iou": lambda out, y: M.jaccard_index(out, y[..., :1])}

    # -- data: CSV points -> point masks ----------------------------------------
    def _prepare_detection_masks(self, split: str):
        """If the GT dir holds CSV point lists, compile cached point-mask
        TIFFs into DATA.<split>.DETECTION_MASK_DIR (reference:
        prepare_detection_data / create_detection_masks) and point
        DATA.<split>.GT_PATH at them."""
        node = self.cfg.DATA[split]
        csvs = sorted(glob.glob(os.path.join(str(node.GT_PATH), "*.csv")))
        if not csvs:
            return  # GT is already masks
        mask_dir = node.DETECTION_MASK_DIR
        xs = list_image_files(node.PATH)
        if len(xs) != len(csvs):
            raise ValueError(f"{split}: {len(xs)} images but {len(csvs)} CSV point files")
        if not os.path.isdir(mask_dir) or len(list_image_files(mask_dir)) != len(csvs):
            os.makedirs(mask_dir, exist_ok=True)
            dil = list(self.cfg.PROBLEM.DETECTION.CENTRAL_POINT_DILATION)
            if len(dil) == 1:
                dil = dil * self.nd
            check_points = bool(self.cfg.PROBLEM.DETECTION.CHECK_POINTS_CREATED)
            for xp, cp in zip(xs, csvs):
                img = read_img_as_ndarray(xp, is_3d=self.is_3d)
                pts, pt_cls = read_points_csv(cp, self.nd, with_classes=True)
                if check_points:
                    self._check_created_points(pts, img.shape[: self.nd], dil,
                                               os.path.basename(cp), mask_dir)
                mask = create_detection_masks(pts, img.shape[: self.nd], dilation=dil,
                                              classes=pt_cls, n_classes=self.n_classes)
                save_tif(mask[None].astype(np.uint8), mask_dir, [os.path.basename(xp)],
                         verbose=False)
        frozen = self.cfg.is_frozen()
        if frozen:
            self.cfg.defrost()
        self.cfg.DATA[split].GT_PATH = mask_dir
        if frozen:
            self.cfg.freeze()

    def _check_created_points(self, pts: np.ndarray, shape, dil, csv_name: str,
                              out_dir: str):
        """PROBLEM.DETECTION.CHECK_POINTS_CREATED: flags (a) points outside
        the image, which mask creation skips, and (b) point pairs closer than
        the dilation footprint, whose blobs fuse into one; writes
        ``<csv>_point_check.csv`` next to the masks when anything is found."""
        pts = np.asarray(pts, dtype=float)
        rows = []
        if len(pts):
            for i, p in enumerate(pts):
                if any(p[d] < 0 or p[d] >= shape[d] for d in range(self.nd)):
                    rows.append([int(i), *[int(v) for v in p], "out_of_bounds"])
            from scipy.spatial import cKDTree

            r = float(max(dil)) * 2.0 + 1.0
            for i, j in sorted(cKDTree(pts).query_pairs(r)):
                rows.append([int(i), *[int(v) for v in pts[i]],
                             f"within_dilation_of_point_{int(j)}"])
        if not rows:
            return
        hdr = ["point_id"] + [f"axis-{d}" for d in range(self.nd)] + ["issue"]
        rpt = os.path.join(out_dir, os.path.splitext(csv_name)[0] + "_point_check.csv")
        with open(rpt, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(hdr)
            w.writerows(rows)
        if self.verbose:
            n_oob = sum(1 for r in rows if r[-1] == "out_of_bounds")
            print(f"WARNING: {csv_name}: {n_oob} out-of-bounds point(s) (skipped) and "
                  f"{len(rows) - n_oob} too-close pair flag(s); report: {rpt}")

    def train(self):
        self._prepare_detection_masks("TRAIN")
        if not self.cfg.DATA.VAL.FROM_TRAIN:
            self._prepare_detection_masks("VAL")
        super().train()

    def test(self, image=None, gt=None):
        self._original_test_gt_path = str(self.cfg.DATA.TEST.GT_PATH)
        by_chunks = bool(self.cfg.TEST.BY_CHUNKS.ENABLE) and self.is_3d
        if image is None and self.cfg.DATA.TEST.LOAD_GT and not by_chunks:
            # by chunks reads the GT points straight from the CSV (reference:
            # detection.py:1069): no whole-volume point mask
            self._prepare_detection_masks("TEST")
        super().test(image=image, gt=gt)

    # -- test -------------------------------------------------------------------
    def _extract_points(self, heatmap: np.ndarray, global_post: bool = True) -> np.ndarray:
        """Peak extraction. ``global_post=False`` skips the whole-image post
        steps (border box, close-point removal) so that the by-chunks path
        applies them once over the merged point set (reference:
        detection.py:984-1040)."""
        cfg = self.cfg
        # DET_TH_TYPE 'auto': Otsu per image (reference: detection.py:366)
        if str(cfg.TEST.DET_TH_TYPE) == "auto":
            from biapy_tpu_torch.data.post_processing import _otsu

            th = float(_otsu(heatmap[..., 0]))
        else:
            th = float(cfg.TEST.DET_MIN_TH_TO_BE_PEAK)
        if str(cfg.TEST.DET_POINT_CREATION_FUNCTION) == "blob_log":
            from biapy_tpu_torch.data.post_processing import blob_log

            blobs = blob_log(
                heatmap[..., 0],
                min_sigma=float(cfg.TEST.DET_BLOB_LOG_MIN_SIGMA),
                max_sigma=float(cfg.TEST.DET_BLOB_LOG_MAX_SIGMA),
                num_sigma=int(cfg.TEST.DET_BLOB_LOG_NUM_SIGMA),
                threshold=th * 0.1,  # scale-normalised LoG runs ~10x below raw peaks
                exclude_border=bool(cfg.TEST.DET_EXCLUDE_BORDER),
            )
            coords = np.round(blobs[:, : self.nd]).astype(np.int64)
        else:
            coords = peak_local_max(
                heatmap[..., 0],
                min_distance=int(cfg.TEST.DET_PEAK_LOCAL_MAX_MIN_DISTANCE),
                threshold_abs=th,
                exclude_border=bool(cfg.TEST.DET_EXCLUDE_BORDER),
            )
        # points within a fixed margin of the border dropped (reference:
        # TEST.DET_IGNORE_POINTS_OUTSIDE_BOX, detection.py:699)
        box = list(cfg.TEST.DET_IGNORE_POINTS_OUTSIDE_BOX or []) if global_post else []
        coords = _filter_bbox(coords, box, heatmap.shape, self.nd)
        pp = cfg.TEST.POST_PROCESSING
        if global_post and pp.REMOVE_CLOSE_POINTS and len(coords):
            coords = remove_close_points(coords, float(pp.REMOVE_CLOSE_POINTS_RADIUS),
                                         resolution=_test_resolution(cfg, self.nd))
        return coords

    def _point_classes(self, pred: np.ndarray, coords: np.ndarray) -> np.ndarray:
        """The majority class of the class head's argmax over the nonzero
        classes in a box of radius 3 around each point, 1 where the box has
        none (reference: detection.py:400-426 votes over the dilated point
        area); zeros without a class head."""
        if not self.separated_class_channel or not len(coords):
            return np.zeros(len(coords), np.int32)
        cls_map = np.argmax(pred[..., 1:1 + self.n_classes], axis=-1)
        r = 3
        out = []
        for c in coords:
            sl = tuple(slice(max(0, int(c[d]) - r), int(c[d]) + r + 1) for d in range(self.nd))
            region = cls_map[sl].ravel()
            region = region[region > 0]
            out.append(int(np.bincount(region).argmax()) if len(region) else 1)
        return np.asarray(out, np.int32)

    def metric_calculation(self, pred: np.ndarray, gt: Optional[np.ndarray]) -> Dict[str, float]:
        m: Dict[str, float] = {}
        if gt is not None:
            gtb = (gt[..., :1] > 0.5).astype(np.float32)
            m["iou"] = float(M.jaccard_index_numpy(gtb, pred[..., :1]))
        coords = self._extract_points(pred)
        self._last_points = coords
        self._last_classes = self._point_classes(pred, coords)
        if gt is not None:
            # the border box applies to both sets, or every border GT point
            # would count as a miss (reference: detection.py:698-752)
            true_pts = _filter_bbox(points_from_mask(gt[..., 0]),
                                    self.cfg.TEST.DET_IGNORE_POINTS_OUTSIDE_BOX,
                                    gt.shape, self.nd)
            tc = pc = None
            if self.separated_class_channel and gt.shape[-1] >= 2:
                # each GT point's class: the mask's class channel at it
                lim = np.asarray(gt.shape[: self.nd]) - 1
                tc = np.asarray([int(gt[tuple(np.clip(np.round(p).astype(int), 0, lim))][1])
                                 for p in true_pts], np.int32)
                pc = self._last_classes
            dm = detection_metrics(true_pts, coords, float(self.cfg.TEST.DET_TOLERANCE),
                                   resolution=_test_resolution(self.cfg, self.nd),
                                   true_classes=tc, pred_classes=pc)
            m.update({f"det_{k}": float(v) for k, v in dm.items()})
        return m

    def after_merge_patches(self, pred, sample, fname):
        coords = getattr(self, "_last_points", None)
        if coords is None:
            coords = self._extract_points(pred)
        classes = getattr(self, "_last_classes", None)
        if classes is None or len(classes) != len(coords):
            classes = self._point_classes(pred, coords)
        multiclass = self.separated_class_channel
        if self.save_to_disk:
            out_dir = self.cfg.PATHS.RESULT_DIR.DET_LOCAL_MAX_COORDS_CHECK
            os.makedirs(out_dir, exist_ok=True)
            write_points_csv(os.path.join(out_dir, os.path.splitext(fname)[0] + "_points.csv"),
                             coords, self.nd, classes=classes if multiclass else None)
        pp = self.cfg.TEST.POST_PROCESSING
        if pp.DET_WATERSHED and len(coords):
            # instances grown around the points over the raw image intensity
            # (reference: TEST.POST_PROCESSING.DET_WATERSHED,
            # post_processing.py:2100-2360)
            from biapy_tpu_torch.data.post_processing import detection_watershed

            img_path = getattr(self, "_current_test_file", None)
            if img_path and os.path.exists(str(img_path)):
                raw = read_img_as_ndarray(str(img_path), is_3d=self.is_3d)[..., 0]
                fdil = [d for d in pp.DET_WATERSHED_FIRST_DILATION if d > 0] or [2] * self.nd
                inst = detection_watershed(
                    coords, raw.astype(np.float32), first_dilation=fdil,
                    donuts_classes=list(pp.DET_WATERSHED_DONUTS_CLASSES),
                    donuts_patch=list(pp.DET_WATERSHED_DONUTS_PATCH),
                    donuts_nucleus_diameter=int(pp.DET_WATERSHED_DONUTS_NUCLEUS_DIAMETER))
                if self.save_to_disk:
                    save_tif(inst[None][..., None].astype(
                        np.uint16 if inst.max() < 2**16 else np.uint32),
                        self.cfg.PATHS.WATERSHED_DIR, [fname], verbose=False)
                self._predictions.append({"role": "post", "pred": inst, "file": fname})
        entry = {"role": "points", "points": coords, "file": fname}
        if multiclass:
            entry["classes"] = classes
        self._predictions.append(entry)
        self._last_points = None
        self._last_classes = None

    def after_by_chunks_prediction(self, ci, raw_path: str, base: str) -> None:
        """Per-tile peak extraction and one merge over the volume (reference:
        detection.py after_one_chunk_raw_prediction:902 — each tile's points
        shifted to volume coordinates, a CSV per tile — and
        after_all_chunk_prediction_workflow_process_master_rank:992 — the
        merged set, the border box and REMOVE_CLOSE_POINTS once,
        ``_all_points.csv``, the metrics against the GT CSV)."""
        cfg = self.cfg
        if not cfg.TEST.BY_CHUNKS.WORKFLOW_PROCESS.ENABLE:
            return
        from biapy_tpu_torch.data.zarr_store import ZarrArray
        from biapy_tpu_torch.engine.chunked import core_keep_mask, dequant_pred, owned_tiles
        from biapy_tpu_torch.parallel import all_gather_objects, is_main_process

        pred = ZarrArray(raw_path)
        spatial = tuple(pred.shape[: self.nd])
        tiles, mine = owned_tiles(ci, spatial)
        check_dir = cfg.PATHS.RESULT_DIR.DET_LOCAL_MAX_COORDS_CHECK
        if self.save_to_disk:
            os.makedirs(check_dir, exist_ok=True)
        zfill = len(str(len(tiles)))
        multiclass = self.separated_class_channel
        local_pts: List[np.ndarray] = []
        local_cls: List[np.ndarray] = []
        for ti, t in mine:
            region = tuple(slice(t.halo_start[d], t.halo_end[d]) for d in range(self.nd))
            hm = dequant_pred(pred[region + (slice(None),)])
            coords = self._extract_points(hm, global_post=False)
            if len(coords):
                coords = coords[core_keep_mask(coords, t, self.nd)]
            classes = self._point_classes(hm, coords)  # local coordinates, the tile's map
            coords = np.asarray(coords, np.int64).reshape(-1, self.nd) \
                + np.asarray(t.halo_start, np.int64)
            if self.save_to_disk:
                write_points_csv(os.path.join(
                    check_dir, f"{base}_patch{str(ti).zfill(zfill)}_points.csv"),
                    coords, self.nd, classes=classes if multiclass else None)
            local_pts.append(coords)
            local_cls.append(np.asarray(classes, np.int32).reshape(-1))
        gathered = all_gather_objects((local_pts, local_cls))
        if not is_main_process():
            return
        flat = [p for g, _ in gathered for p in g if len(p)]
        flat_cls = [c for _, gc in gathered for c in gc if len(c)]
        coords = np.concatenate(flat, axis=0) if flat else np.zeros((0, self.nd), np.int64)
        classes = np.concatenate(flat_cls) if flat_cls else np.zeros(0, np.int32)
        # the whole-volume post steps, once over the merged set
        keep = _bbox_keep(coords, cfg.TEST.DET_IGNORE_POINTS_OUTSIDE_BOX, spatial, self.nd)
        coords = coords[keep]
        if len(classes) == len(keep):
            classes = classes[keep]
        pp = cfg.TEST.POST_PROCESSING
        out_dir = check_dir
        if pp.REMOVE_CLOSE_POINTS and len(coords):
            out_dir = cfg.PATHS.RESULT_DIR.DET_LOCAL_MAX_COORDS_CHECK_POST_PROCESSING
            coords, kept = remove_close_points(coords, float(pp.REMOVE_CLOSE_POINTS_RADIUS),
                                               resolution=_test_resolution(cfg, self.nd),
                                               return_keep=True)
            if len(classes):
                classes = classes[kept]
        coords = coords.astype(np.float64)
        zoom = cfg.DATA.PREPROCESS.ZOOM
        if zoom.ENABLE:
            # DATA.PREPROCESS.ZOOM only rescales the final point coordinates
            # by chunks, by the per-axis factor aligned with
            # INPUT_IMG_AXES_ORDER (reference: detection.py:1044-1052)
            axes = str(cfg.DATA.TEST.INPUT_IMG_AXES_ORDER)
            factor = {a: f for a, f in zip(axes, list(zoom.ZOOM_FACTOR))}
            coords = coords / np.array([factor.get(a, 1.0) for a in ("Z", "Y", "X")[-self.nd:]],
                                       np.float64)
        if self.save_to_disk:
            os.makedirs(out_dir, exist_ok=True)
            write_points_csv(os.path.join(out_dir, base + "_all_points.csv"), coords, self.nd,
                             cast=float, classes=classes if multiclass else None)
        entry = {"role": "points", "points": coords, "file": base}
        if multiclass:
            entry["classes"] = classes
        self._predictions.append(entry)
        # the metrics straight from the GT CSV (no point mask)
        gt_dir = getattr(self, "_original_test_gt_path", "")
        if not (cfg.DATA.TEST.LOAD_GT and gt_dir and os.path.isdir(gt_dir)):
            return
        csvs = sorted(glob.glob(os.path.join(gt_dir, "*.csv")))
        match = [c for c in csvs if os.path.splitext(os.path.basename(c))[0] == base]
        gt_csv = match[0] if match else None
        if gt_csv is None and len(csvs) == 1:
            # the reference warns and takes the only candidate (detection.py:1069)
            print(f"WARNING: no GT CSV named {base}.csv — using {csvs[0]}")
            gt_csv = csvs[0]
        elif gt_csv is None and csvs:
            print(f"WARNING: no GT CSV named {base}.csv among {len(csvs)} "
                  "candidates — skipping metrics for this volume")
        if gt_csv:
            true_pts, true_cls = read_points_csv(gt_csv, self.nd, with_classes=True)
            keep = _bbox_keep(true_pts, cfg.TEST.DET_IGNORE_POINTS_OUTSIDE_BOX, spatial,
                              self.nd)
            true_pts, true_cls = true_pts[keep], true_cls[keep]
            dm = detection_metrics(true_pts, coords.astype(np.float32),
                                   float(cfg.TEST.DET_TOLERANCE),
                                   resolution=_test_resolution(cfg, self.nd),
                                   true_classes=true_cls if multiclass else None,
                                   pred_classes=classes if multiclass else None)
            self.metrics_per_test_file.append({f"det_{k}": float(v) for k, v in dm.items()})
