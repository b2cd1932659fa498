"""Instance and point matching metrics, copied from the JAX package's
``utils/matching.py``.

Reference analog: biapy/utils/matching.py (matching:429,
wrapper_matching_dataset_lazy:601 — the StarDist matching port: label
overlap matrix, IoU/IoT/IoP criteria, Hungarian assignment, precision/
recall/F1/panoptic-quality at a threshold list) and
biapy/engine/metrics.py:1795 (detection_metrics — point matching by
distance tolerance).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment


def label_overlap_matrix(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """Dense overlap counts between true and predicted labels (reference:
    matching.py label_overlap)."""
    yt = y_true.reshape(-1).astype(np.int64)
    yp = y_pred.reshape(-1).astype(np.int64)
    nt, npred = int(yt.max()) + 1, int(yp.max()) + 1
    overlap = np.zeros((nt, npred), dtype=np.int64)
    np.add.at(overlap, (yt, yp), 1)
    return overlap


def _scores(overlap: np.ndarray, criterion: str = "iou") -> np.ndarray:
    n_pixels_true = overlap.sum(axis=1, keepdims=True)
    n_pixels_pred = overlap.sum(axis=0, keepdims=True)
    if criterion == "iou":
        denom = n_pixels_true + n_pixels_pred - overlap
    elif criterion == "iot":
        denom = n_pixels_true
    elif criterion == "iop":
        denom = n_pixels_pred
    else:
        raise ValueError(f"Unknown criterion {criterion}")
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(denom > 0, overlap / denom, 0.0)
    return s


def matching(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    thresh: Sequence[float] = (0.5,),
    criterion: str = "iou",
    report_matches: bool = False,
) -> List[Dict]:
    """Instance matching stats at each IoU threshold (reference:
    matching.py:429). Returns one dict per threshold with tp/fp/fn,
    precision, recall, f1, panoptic_quality, mean_matched_score."""
    # compact non-sequential ids first: raw curated GT labels (e.g. {1,5,9})
    # would otherwise create phantom zero-pixel instances that inflate
    # fn/n_true and make matrix indices disagree with the real label values
    true_ids = np.unique(y_true)
    true_ids = true_ids[true_ids > 0]
    pred_ids = np.unique(y_pred)
    pred_ids = pred_ids[pred_ids > 0]
    tmap = np.zeros(int(y_true.max()) + 1, np.int64)
    tmap[true_ids] = np.arange(1, len(true_ids) + 1)
    pmap = np.zeros(int(y_pred.max()) + 1, np.int64)
    pmap[pred_ids] = np.arange(1, len(pred_ids) + 1)
    overlap = label_overlap_matrix(tmap[y_true.reshape(-1).astype(np.int64)],
                                   pmap[y_pred.reshape(-1).astype(np.int64)])
    scores = _scores(overlap, criterion)[1:, 1:]  # drop background
    n_true, n_pred = scores.shape
    results = []
    for th in thresh:
        if n_true > 0 and n_pred > 0:
            cost = -(scores >= th).astype(float) - scores / (2 * max(n_true, n_pred))
            ti, pi = linear_sum_assignment(cost)
            valid = scores[ti, pi] >= th
            tp = int(valid.sum())
            matched_scores = scores[ti[valid], pi[valid]]
        else:
            tp = 0
            matched_scores = np.zeros(0)
        fp = n_pred - tp
        fn = n_true - tp
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * tp / (2 * tp + fp + fn) if 2 * tp + fp + fn else 0.0
        mean_matched = float(matched_scores.mean()) if tp else 0.0
        sq = mean_matched
        pq = sq * f1
        r = {
            "thresh": float(th), "tp": tp, "fp": fp, "fn": fn,
            "precision": precision, "recall": recall, "f1": f1,
            "n_true": n_true, "n_pred": n_pred,
            "mean_matched_score": mean_matched, "panoptic_quality": pq,
            "accuracy": tp / (tp + fp + fn) if tp + fp + fn else 0.0,
        }
        if report_matches and n_true and n_pred:
            # report ORIGINAL label values, not compacted matrix indices
            r["matched_pairs"] = [(int(true_ids[t]), int(pred_ids[p]))
                                  for t, p in zip(ti[valid], pi[valid])]
            r["matched_scores"] = matched_scores.tolist()
        results.append(r)
    return results


def aggregate_matching(per_image: List[List[Dict]], by_image: bool = False) -> List[Dict]:
    """Aggregate matching stats over a dataset (reference:
    wrapper_matching_dataset_lazy:601). ``by_image=False`` micro-aggregates
    the tp/fp/fn counts; ``by_image=True`` macro-averages each per-image
    score (reference: TEST.MATCHING_STATS_BY_IMAGE)."""
    if not per_image:
        return []
    n_th = len(per_image[0])
    if by_image:
        out = []
        score_keys = ("precision", "recall", "f1", "mean_matched_score",
                      "panoptic_quality")
        for t in range(n_th):
            entry = {"thresh": per_image[0][t]["thresh"],
                     "tp": sum(r[t]["tp"] for r in per_image),
                     "fp": sum(r[t]["fp"] for r in per_image),
                     "fn": sum(r[t]["fn"] for r in per_image)}
            for k in score_keys:
                entry[k] = float(np.mean([r[t][k] for r in per_image]))
            out.append(entry)
        return out
    out = []
    for t in range(n_th):
        tp = sum(r[t]["tp"] for r in per_image)
        fp = sum(r[t]["fp"] for r in per_image)
        fn = sum(r[t]["fn"] for r in per_image)
        weighted = sum(r[t]["mean_matched_score"] * r[t]["tp"] for r in per_image)
        f1 = 2 * tp / (2 * tp + fp + fn) if 2 * tp + fp + fn else 0.0
        out.append({
            "thresh": per_image[0][t]["thresh"], "tp": tp, "fp": fp, "fn": fn,
            "precision": tp / (tp + fp) if tp + fp else 0.0,
            "recall": tp / (tp + fn) if tp + fn else 0.0,
            "f1": f1,
            "mean_matched_score": weighted / tp if tp else 0.0,
            "panoptic_quality": (weighted / tp if tp else 0.0) * f1,
        })
    return out


def detection_metrics(
    true_points: np.ndarray,
    pred_points: np.ndarray,
    tolerance: float,
    resolution: Sequence[float] = (1, 1, 1),
    true_classes: Optional[np.ndarray] = None,
    pred_classes: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Point-detection precision/recall/F1 with distance tolerance via
    optimal assignment (reference: detection_metrics, metrics.py:1795).
    When per-point classes are given, spatially-matched pairs additionally
    score class agreement (reference multi-head detection: 'Precision
    (class)' etc., detection.py:231)."""
    t = np.asarray(true_points, np.float32)
    p = np.asarray(pred_points, np.float32)
    with_cls = true_classes is not None and pred_classes is not None
    out: Dict[str, float] = {}
    if len(t) == 0 and len(p) == 0:
        out = {"precision": 1.0, "recall": 1.0, "f1": 1.0, "tp": 0, "fp": 0, "fn": 0}
        if with_cls:
            out.update({"precision_class": 1.0, "recall_class": 1.0,
                        "f1_class": 1.0, "tp_class": 0})
        return out
    if len(t) == 0 or len(p) == 0:
        out = {"precision": 0.0, "recall": 0.0, "f1": 0.0, "tp": 0,
               "fp": len(p), "fn": len(t)}
        if with_cls:
            out.update({"precision_class": 0.0, "recall_class": 0.0,
                        "f1_class": 0.0, "tp_class": 0})
        return out
    res = np.asarray(resolution[: t.shape[1]], np.float32)
    d = np.linalg.norm((t[:, None, :] - p[None, :, :]) * res, axis=-1)
    cost = np.where(d <= tolerance, d, 1e9)
    ti, pi = linear_sum_assignment(cost)
    ok = d[ti, pi] <= tolerance
    tp = int(ok.sum())
    fp = len(p) - tp
    fn = len(t) - tp
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * tp / (2 * tp + fp + fn) if 2 * tp + fp + fn else 0.0
    out = {"precision": precision, "recall": recall, "f1": f1,
           "tp": tp, "fp": fp, "fn": fn}
    if with_cls:
        tc = np.asarray(true_classes).reshape(-1)
        pc = np.asarray(pred_classes).reshape(-1)
        tp_c = int(np.sum(tc[ti[ok]] == pc[pi[ok]]))
        out["tp_class"] = tp_c
        out["precision_class"] = tp_c / len(p) if len(p) else 0.0
        out["recall_class"] = tp_c / len(t) if len(t) else 0.0
        denom = out["precision_class"] + out["recall_class"]
        out["f1_class"] = (2 * out["precision_class"] * out["recall_class"] / denom
                           if denom else 0.0)
    return out
