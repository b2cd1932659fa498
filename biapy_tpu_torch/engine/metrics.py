"""Losses and metrics of the semantic-segmentation, instance-segmentation and
detection workflows.

Copied from the JAX package's ``engine/metrics.py`` (``bce_with_logits``,
``softmax_ce_with_logits``, ``weight_binary_ratio``, ``cross_entropy_loss``,
``dice_loss``, ``dice_ce_loss``, ``_channel_loss``,
``instance_segmentation_loss``, ``detection_loss``, ``jaccard_index``, ``jaccard_index_numpy``)
and written with torch ops. Losses take channels-last tensors
``(B, ..., C)`` of logits (the engine applies activations only at
inference) and return 0-d tensors on the logits' device; nothing here
reads a value back to the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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


def _channel_loss(name: str, logits, target, weight=None):
    """One channel's loss by name (bce / mse / l1=mae / ce)."""
    name = name.lower()
    if name in ("bce", "ce_sigmoid"):
        return torch.mean(bce_with_logits(logits, target, weight))
    if name in ("mse", "l2"):
        err = torch.square(logits - target)
    elif name in ("mae", "l1"):
        err = torch.abs(logits - target)
    else:
        raise ValueError(f"Unknown channel loss: {name}")
    if weight is not None:
        # normalize by the weight mass OVER THE BROADCAST error shape so a
        # (..., 1) foreground mask on an nrays-wide channel yields a true
        # mean over rays (reference: metrics.py:1760 "'R' rays is a true
        # mean over rays (matching StarDist)")
        w = torch.broadcast_to(weight, err.shape)
        return torch.sum(err * w) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(err)


def instance_segmentation_loss(
    out_channels: Sequence[str],
    losses_to_use: Sequence[str],
    channel_weights: Sequence[float],
    channels_per_output: Sequence[int],
    mask_distances: Optional[Dict[str, bool]] = None,
    class_rebalance_within_channels: bool = False,
):
    """Build the multi-channel instance-seg loss
    (reference: instance_segmentation_loss, metrics.py:1400).

    ``out_channels`` e.g. ["B","C","D"]; ``channels_per_output`` gives how
    many prediction channels each representation occupies (e.g. affinities
    take one per offset). The ground truth is laid out with the same
    channel structure. Regression channels (distances) can be masked to the
    foreground (``mask_distances``), and binary channels can be rebalanced.
    The class head (``DATA.N_CLASSES`` > 2) is not ported (ROADMAP queue 1
    item 9).
    """
    mask_distances = mask_distances or {}

    # 'We': GT carries a U-Net border weight map as its LAST channel; it is
    # never predicted. BCE channels add it to their per-pixel weight
    # (w(x) = w_c(x) + w_border(x), the U-Net paper formula); other losses
    # apply it multiplicatively (reference: metrics.py:1637,1744).
    border_weight = "We" in out_channels
    active = [(ch, ln, w, n) for ch, ln, w, n in
              zip(out_channels, losses_to_use, channel_weights, channels_per_output)
              if ch != "We"]

    def loss_fn(y_pred, y_true):
        if isinstance(y_pred, dict):
            y_pred = y_pred["pred"]
        w_borders = None
        if border_weight:
            w_borders = y_true[..., -1:]
            y_true = y_true[..., :-1]
        total = 0.0
        off = 0
        # the F (or first binary) channel index, used as mask for regression
        fg_idx = None
        o = 0
        for ch, _, _, n in active:
            if ch in ("F", "B", "P", "C", "F_pre", "F_post", "F_cleft"):
                fg_idx = o
                break
            o += n
        for ch, lname, w, n in active:
            pred_c = y_pred[..., off : off + n]
            true_c = y_true[..., off : off + n].to(pred_c.dtype)
            weight = None
            if lname.lower() in ("bce",) and class_rebalance_within_channels:
                weight = weight_binary_ratio(true_c)
            if mask_distances.get(ch, False):
                if fg_idx is not None:
                    fg = (y_true[..., fg_idx : fg_idx + 1] > 0.5).to(pred_c.dtype)
                else:
                    # no binary channel in the set: fall back to (target != 0)
                    # on the masked channel itself, as the reference does for
                    # 'R' without 'F' (reference config.py:217 uses R > 0)
                    fg = (torch.abs(true_c) > 0).any(dim=-1, keepdim=True).to(pred_c.dtype)
                weight = fg if weight is None else weight * fg
            if w_borders is not None:
                wb = w_borders.to(pred_c.dtype)
                if lname.lower() == "bce":
                    weight = wb if weight is None else weight + wb
                else:
                    weight = wb if weight is None else weight * wb
            total = total + w * _channel_loss(lname, pred_c, true_c, weight)
            off += n
        return total

    return loss_fn


def detection_loss(
    channel_weights=(1.0,),
    class_rebalance_within_channels: bool = True,
    num_classes: int = 2,
):
    """Point-heatmap detection loss: rebalanced BCE on the point channel
    (reference: detection_loss, metrics.py:571). The CE term of the
    separated class head (``num_classes`` > 2) is not ported (ROADMAP
    queue 1 item 9) and raises."""
    if num_classes > 2:
        raise NotImplementedError(
            "the detection class head's CE term (DATA.N_CLASSES > 2) is not ported to "
            "biapy_tpu_torch yet (ROADMAP: queue 1 item 9, other workflows)")
    w0 = float(channel_weights[0])

    def loss_fn(y_pred, y_true):
        if isinstance(y_pred, dict):
            y_pred = y_pred["pred"]
        t = y_true[..., :1].to(y_pred.dtype)
        weight = weight_binary_ratio(t) if class_rebalance_within_channels else None
        return w0 * torch.mean(bce_with_logits(y_pred[..., :1], t, weight))

    return loss_fn


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
