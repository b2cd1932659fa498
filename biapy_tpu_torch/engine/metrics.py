"""Losses and metrics of the semantic-segmentation workflow.

Copied from the JAX package's ``engine/metrics.py`` (``bce_with_logits``,
``softmax_ce_with_logits``, ``weight_binary_ratio``, ``cross_entropy_loss``,
``dice_loss``, ``dice_ce_loss``, ``jaccard_index``, ``jaccard_index_numpy``)
and written with torch ops. Losses take channels-last tensors
``(B, ..., C)`` of logits (the engine applies activations only at
inference) and return 0-d tensors on the logits' device; nothing here
reads a value back to the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-7


# --------------------------------------------------------------------------
# elementwise losses
# --------------------------------------------------------------------------
def bce_with_logits(logits, targets, weight=None):
    """Numerically-stable binary cross-entropy on logits."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    loss = -(targets * log_p + (1.0 - targets) * log_not_p)
    if weight is not None:
        loss = loss * weight
    return loss


def softmax_ce_with_logits(logits, labels_int, class_weights=None, ignore_index=None,
                           mask=None):
    """Per-pixel softmax cross-entropy; ``labels_int`` integer class map
    (B, ..., 1) or (B, ...). ``mask`` restricts the loss to foreground
    pixels, normalized by the mask mass."""
    if labels_int.shape[-1] == 1:
        labels_int = labels_int[..., 0]
    labels_int = labels_int.to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    nclass = logits.shape[-1]
    safe_labels = torch.clamp(labels_int, 0, nclass - 1)
    picked = torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    loss = -picked
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=loss.dtype, device=loss.device)[safe_labels]
        loss = loss * w
    valid = None
    if ignore_index is not None:
        valid = (labels_int != ignore_index).to(loss.dtype)
    if mask is not None:
        m = mask[..., 0] if mask.dim() == loss.dim() + 1 else mask
        m = m.to(loss.dtype)
        valid = m if valid is None else valid * m
    if valid is not None:
        loss = loss * valid
        return torch.sum(loss) / torch.clamp(torch.sum(valid), min=1.0)
    return torch.mean(loss)


def weight_binary_ratio(target):
    """Per-element weight map balancing foreground/background frequency.
    Returns weights >= 1."""
    fg = torch.clamp(torch.mean((target > 0.5).float()), EPS, 1 - EPS)
    # weight foreground by (1-fg)/fg when foreground is the minority (and
    # symmetrically otherwise), normalized so that weights >= 1.
    alpha = torch.where(fg <= 0.5, (1.0 - fg) / fg, fg / (1.0 - fg))
    is_minority_fg = fg <= 0.5
    one = torch.ones((), dtype=alpha.dtype, device=alpha.device)
    w_fg = torch.where(is_minority_fg, alpha, one)
    w_bg = torch.where(is_minority_fg, one, alpha)
    return torch.where(target > 0.5, w_fg, w_bg)


# --------------------------------------------------------------------------
# composite losses
# --------------------------------------------------------------------------
def cross_entropy_loss(
    logits,
    targets,
    num_classes: int = 2,
    class_rebalance: str = "none",
    class_weights: Optional[Sequence[float]] = None,
    ignore_index: Optional[int] = None,
):
    """BCE (binary) / softmax CE (multiclass) with optional rebalancing."""
    if isinstance(logits, dict):
        logits = logits["pred"]
    if num_classes <= 2 and logits.shape[-1] == 1:
        weight = None
        if class_rebalance == "auto":
            weight = weight_binary_ratio(targets)
        elif class_rebalance == "manual" and class_weights:
            w_bg, w_fg = float(class_weights[0]), float(class_weights[-1])
            weight = torch.where(targets > 0.5, w_fg, w_bg).to(logits.dtype)
        bce = bce_with_logits(logits, targets.to(logits.dtype), weight)
        if ignore_index is not None:
            # LOSS.IGNORE_INDEX applies on the binary path too: unlabeled
            # pixels must not contribute gradient
            valid = (targets != ignore_index).to(bce.dtype)
            return torch.sum(bce * valid) / torch.clamp(torch.sum(valid), min=1.0)
        return torch.mean(bce)
    cw = class_weights if (class_rebalance == "manual" and class_weights) else None
    return softmax_ce_with_logits(logits, targets, cw, ignore_index)


def dice_loss(logits, targets, smooth: float = 1e-5, apply_sigmoid: bool = True):
    """Soft Dice over the batch."""
    p = torch.sigmoid(logits) if apply_sigmoid else logits
    t = targets.to(p.dtype)
    axes = tuple(range(1, p.dim()))
    inter = torch.sum(p * t, dim=axes)
    denom = torch.sum(p, dim=axes) + torch.sum(t, dim=axes)
    dice = (2.0 * inter + smooth) / (denom + smooth)
    return 1.0 - torch.mean(dice)


def dice_ce_loss(
    logits, targets, num_classes: int = 2, w_dice: float = 0.5, w_ce: float = 0.5,
    class_rebalance: str = "none", class_weights=None, ignore_index=None,
):
    """Combined Dice + CE."""
    if isinstance(logits, dict):
        logits = logits["pred"]
    ce = cross_entropy_loss(logits, targets, num_classes, class_rebalance, class_weights,
                            ignore_index)
    if num_classes > 2 and logits.shape[-1] > 1:
        # out-of-range labels (an ignore index) one-hot to all zeros, as
        # jax.nn.one_hot gives them
        lab = targets[..., 0].to(torch.int64)
        t1h = (lab[..., None] == torch.arange(logits.shape[-1], device=lab.device)
               ).to(logits.dtype)
        if ignore_index is not None:
            t1h = t1h * (targets[..., :1] != ignore_index)
        d = dice_loss(torch.softmax(logits, dim=-1), t1h, apply_sigmoid=False)
    elif ignore_index is not None:
        # drop ignored pixels from BOTH dice terms (a zeroed target alone
        # would still count the prediction in the denominator)
        valid = (targets != ignore_index).to(logits.dtype)
        d = dice_loss(torch.sigmoid(logits) * valid, targets * valid, apply_sigmoid=False)
    else:
        d = dice_loss(logits, targets)
    return w_dice * d + w_ce * ce


# --------------------------------------------------------------------------
# segmentation metrics
# --------------------------------------------------------------------------
def jaccard_index(y_pred, y_true, num_classes: int = 2, t: float = 0.5,
                  ignore_index: Optional[int] = None, apply_activation: bool = True):
    """IoU / Jaccard. Binary: sigmoid+threshold each channel; multiclass:
    argmax vs integer labels, mean over the classes that occur."""
    if isinstance(y_pred, dict):
        y_pred = y_pred["pred"]
    if num_classes > 2 and y_pred.shape[-1] > 1:
        pred_lab = torch.argmax(y_pred, dim=-1)
        true_lab = (y_true[..., 0] if y_true.shape[-1] == 1 else y_true).to(torch.int64)
        valid = (torch.ones_like(true_lab, dtype=torch.bool) if ignore_index is None
                 else true_lab != ignore_index)
        ious = []
        for c in range(num_classes):
            p = (pred_lab == c) & valid
            g = (true_lab == c) & valid
            inter = torch.sum(p & g)
            union = torch.sum(p | g)
            ious.append(torch.where(union > 0, inter / torch.clamp(union, min=1),
                                    torch.full((), float("nan"), device=inter.device)))
        return torch.nanmean(torch.stack(ious))
    p = torch.sigmoid(y_pred) if apply_activation else y_pred
    pb = p > t
    gb = y_true > 0.5
    if ignore_index is not None:
        valid = y_true != ignore_index
        pb = pb & valid
        gb = gb & valid
    inter = torch.sum(pb & gb)
    union = torch.sum(pb | gb)
    return torch.where(union > 0, inter / torch.clamp(union, min=1),
                       torch.ones((), device=inter.device))


def jaccard_index_numpy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Binary IoU on numpy arrays (reference: metrics.py:25)."""
    tp = np.count_nonzero((y_pred > 0.5) & (y_true > 0.5))
    fp = np.count_nonzero((y_pred > 0.5) & (y_true <= 0.5))
    fn = np.count_nonzero((y_pred <= 0.5) & (y_true > 0.5))
    denom = tp + fp + fn
    return 1.0 if denom == 0 else tp / denom
