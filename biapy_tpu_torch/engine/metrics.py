"""Losses and metrics of the semantic-segmentation, instance-segmentation,
detection, restoration and classification workflows.

Copied from the JAX package's ``engine/metrics.py`` (``bce_with_logits``,
``softmax_ce_with_logits``, ``weight_binary_ratio``, ``cross_entropy_loss``,
``dice_loss``, ``dice_ce_loss``, ``_channel_loss``,
``instance_segmentation_loss``, ``detection_loss``, ``jaccard_index``,
``jaccard_index_numpy``, ``accuracy_metric``, ``top_k_accuracy``, and the restoration losses and metrics: ``n2v_loss_mse``, ``mse_metric``,
``mae_metric``, ``psnr_metric``, ``ssim_metric`` and the SSIM losses,
``build_restoration_train_metrics``, ``restoration_test_metrics``)
and written with torch ops. Losses take channels-last tensors
``(B, ..., C)`` of logits (the engine applies activations only at
inference) and return 0-d tensors on the logits' device; nothing here
reads a value back to the host.
"""

from __future__ import annotations

import math
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
    n_classes: int = 0,
    class_channel_weight: float = 1.0,
):
    """Build the multi-channel instance-seg loss
    (reference: instance_segmentation_loss, metrics.py:1400).

    ``out_channels`` e.g. ["B","C","D"]; ``channels_per_output`` gives how
    many prediction channels each representation occupies (e.g. affinities
    take one per offset). The ground truth is laid out with the same
    channel structure. Regression channels (distances) can be masked to the
    foreground (``mask_distances``), and binary channels can be rebalanced.

    ``n_classes`` > 0 adds the class head's term (DATA.N_CLASSES > 2): its
    ``n_classes`` softmax logits (the model's ``"class"`` output, or the
    last ``n_classes`` channels of a flat prediction) scored by
    cross-entropy against the class-index map carried as the LAST
    ground-truth channel, only where an instance exists, times
    ``class_channel_weight``.
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
        cls_pred = None
        if isinstance(y_pred, dict):
            cls_pred = y_pred.get("class")
            y_pred = y_pred["pred"]
        class_term = 0.0
        if n_classes > 0:
            if cls_pred is None:  # flat layout (stitched/TTA-merged arrays)
                cls_pred = y_pred[..., -n_classes:]
                y_pred = y_pred[..., :-n_classes]
            # the class map is the very last GT channel (appended after the
            # compiled channels, reference pre_processing.py:549)
            cls_true = y_true[..., -1:]
            y_true = y_true[..., :-1]
            # scored only where an instance exists: the background would
            # otherwise drown the term (reference: metrics.py:1783-1787)
            class_term = class_channel_weight * softmax_ce_with_logits(
                cls_pred, cls_true, mask=(cls_true > 0))
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
        return total + class_term

    return loss_fn


def detection_loss(
    channel_weights=(1.0,),
    class_rebalance_within_channels: bool = True,
    num_classes: int = 2,
    class_rebalance: str = "none",
    class_weights=None,
):
    """Point-heatmap detection loss: rebalanced BCE on the point channel and,
    with a separated class head (``num_classes`` > 2, the model's
    ``"class"`` output), softmax cross-entropy against the GT's class
    channel, only where a point blob exists, weighted by the last
    ``channel_weights`` entry and, with ``class_rebalance`` 'manual', per
    class by ``class_weights`` (reference: detection_loss, metrics.py:571)."""
    w0 = float(channel_weights[0])
    w_cls = float(channel_weights[-1]) if len(channel_weights) > 1 else 1.0
    cw = class_weights if (class_rebalance == "manual" and class_weights) else None

    def loss_fn(y_pred, y_true):
        cls_pred = None
        if isinstance(y_pred, dict):
            cls_pred = y_pred.get("class")
            y_pred = y_pred["pred"]
        t = y_true[..., :1].to(y_pred.dtype)
        weight = weight_binary_ratio(t) if class_rebalance_within_channels else None
        loss = w0 * torch.mean(bce_with_logits(y_pred[..., :1], t, weight))
        if cls_pred is not None and num_classes > 2:
            # class CE only where a point blob exists (reference masks the
            # class term to the foreground, metrics.py:693-697)
            loss = loss + w_cls * softmax_ce_with_logits(
                cls_pred, y_true[..., 1:2], cw, mask=(y_true[..., :1] > 0))
        return loss

    return loss_fn


def n2v_loss_mse(pred, target, mask):
    """Noise2Void masked MSE: loss only on manipulated pixels
    (reference: n2v_loss_mse, metrics.py:2247)."""
    m = mask.to(pred.dtype)
    return torch.sum(torch.square(pred - target) * m) / torch.clamp(torch.sum(m), min=1.0)


# --------------------------------------------------------------------------
# image-quality losses / metrics (SR, denoising, I2I, SSL)
# --------------------------------------------------------------------------
def mse_metric(pred, target):
    return torch.mean(torch.square(pred - target))


def mae_metric(pred, target):
    return torch.mean(torch.abs(pred - target))


def psnr_metric(pred, target, data_range: float = 1.0):
    mse = torch.mean(torch.square(pred - target))
    return 20.0 * math.log10(data_range) - 10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * torch.square(x / sigma))
    return g / torch.sum(g)


def _ssim_filter(img, ndim: int, size: int = 11, sigma: float = 1.5):
    """Separable Gaussian filter over the spatial dims of (B, ..., C): per
    axis numpy's ``symmetric`` padding (the edge sample repeated, as
    ``jnp.pad(mode="symmetric")``; its indices from ``np.pad`` itself, so a
    pad longer than the axis reflects again as numpy does), then a VALID
    correlation. Float32 without TF32 in the library convolution."""
    g = _gaussian_kernel1d(size, sigma, img.device)
    conv = (F.conv1d, F.conv2d, F.conv3d)[ndim - 1]
    # (B, *spatial, C) -> (B * C, 1, *spatial): each channel on its own
    x = img.movedim(-1, 1)
    lead = x.shape[:2]
    out = x.reshape((-1, 1) + tuple(x.shape[2:]))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for d in range(ndim):
            axis = 2 + d
            idx = np.pad(np.arange(out.shape[axis]), (size // 2, size // 2), mode="symmetric")
            out = torch.index_select(out, axis, torch.from_numpy(idx).to(out.device))
            w = g.view((1, 1) + tuple(size if e == d else 1 for e in range(ndim)))
            out = conv(out, w)
    return out.reshape(lead + tuple(out.shape[2:])).movedim(1, -1)


def ssim_metric(pred, target, data_range: float = 1.0, size: int = 11, sigma: float = 1.5):
    """SSIM over channels-last batches (matches pytorch_msssim defaults used
    by the reference's SSIM losses, metrics.py:2109)."""
    ndim = pred.dim() - 2
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x = _ssim_filter(pred, ndim, size, sigma)
    mu_y = _ssim_filter(target, ndim, size, sigma)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sx = _ssim_filter(pred * pred, ndim, size, sigma) - mu_x2
    sy = _ssim_filter(target * target, ndim, size, sigma) - mu_y2
    sxy = _ssim_filter(pred * target, ndim, size, sigma) - mu_xy
    ssim_map = ((2 * mu_xy + c1) * (2 * sxy + c2)) / ((mu_x2 + mu_y2 + c1) * (sx + sy + c2))
    return torch.mean(ssim_map)


def ssim_loss(pred, target, data_range: float = 1.0):
    return 1.0 - ssim_metric(pred, target, data_range)


def w_mae_ssim_loss(pred, target, w_mae: float = 0.5, w_ssim: float = 0.5):
    """Weighted MAE + SSIM (reference: W_MAE_SSIM_loss, metrics.py:2155)."""
    return w_mae * mae_metric(pred, target) + w_ssim * ssim_loss(pred, target)


def w_mse_ssim_loss(pred, target, w_mse: float = 0.5, w_ssim: float = 0.5):
    """Weighted MSE + SSIM (reference: W_MSE_SSIM_loss, metrics.py:2200)."""
    return w_mse * mse_metric(pred, target) + w_ssim * ssim_loss(pred, target)


def restoration_loss(ltype: str, weights, workflow: str):
    """LOSS.TYPE of the super-resolution, self-supervised and image-to-image
    workflows (default MAE; LOSS.WEIGHTS default [0.5, 0.5])."""
    ltype = (ltype or "MAE").upper()
    w = list(weights) if weights else [0.5, 0.5]
    fns = {"MAE": mae_metric, "MSE": mse_metric, "SSIM": ssim_loss,
           "W_MAE_SSIM": lambda p, t: w_mae_ssim_loss(p, t, w[0], w[1]),
           "W_MSE_SSIM": lambda p, t: w_mse_ssim_loss(p, t, w[0], w[1])}
    if ltype not in fns:
        raise ValueError(f"Unsupported LOSS.TYPE for {workflow}: {ltype}")
    return fns[ltype]


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


def accuracy_metric(logits, labels):
    """Top-1 accuracy for classification; ``torch.argmax`` returns the first
    of tied maxima, as ``jnp.argmax`` does."""
    pred = torch.argmax(logits, dim=-1)
    labels = labels.reshape(pred.shape)
    return (pred == labels).float().mean()


def top_k_accuracy(logits, labels, k: int = 5):
    """Share of samples whose label is among the ``k`` largest logits. Ties
    rank the lower class index first, as ``jax.lax.top_k`` does (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    k = min(k, logits.shape[-1])
    topk = torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]
    labels = labels.reshape(labels.shape[0], 1)
    return (topk == labels).any(dim=-1).float().mean()


def jaccard_index_numpy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Binary IoU on numpy arrays (reference: metrics.py:25)."""
    tp = np.count_nonzero((y_pred > 0.5) & (y_true > 0.5))
    fp = np.count_nonzero((y_pred > 0.5) & (y_true <= 0.5))
    fn = np.count_nonzero((y_pred <= 0.5) & (y_true > 0.5))
    denom = tp + fp + fn
    return 1.0 if denom == 0 else tp / denom


# ---------------------------------------------------------------------------
# TRAIN/TEST.METRICS selection for the restoration workflows (SR, I2I, SSL,
# denoising). Reference: per-name torchmetrics construction in
# super_resolution.py:130-200 / multiple_metrics metrics.py:249.
# ---------------------------------------------------------------------------

RESTORATION_METRIC_NAMES = ("psnr", "mae", "mse", "ssim")


def build_restoration_train_metrics(cfg_names):
    """Train-step metric dict from TRAIN.METRICS names (default: all four)."""
    names = [str(n).lower() for n in (cfg_names or [])] or list(RESTORATION_METRIC_NAMES)
    fns = {"psnr": psnr_metric, "mae": mae_metric, "mse": mse_metric, "ssim": ssim_metric}
    return {n: fns[n] for n in names if n in fns}


def restoration_test_metrics(pred: np.ndarray, gt_norm: np.ndarray, cfg_names,
                             device=None) -> dict:
    """Host-side per-image metrics from TEST.METRICS names, in float64; SSIM
    in float32 on ``device`` (default the CPU). ``gt_norm`` must already be
    value-normalized like the prediction. The set-level fid / is / lpips are
    refused by the workflow before it gets here."""
    names = [str(n).lower() for n in (cfg_names or [])] or list(RESTORATION_METRIC_NAMES)
    out = {}
    diff = pred.astype(np.float64) - gt_norm.astype(np.float64)
    rng_ = max(float(gt_norm.max() - gt_norm.min()), 1e-6)
    for n in names:
        if n == "mse":
            out["mse"] = float((diff ** 2).mean())
        elif n == "mae":
            out["mae"] = float(np.abs(diff).mean())
        elif n == "psnr":
            mse = float((diff ** 2).mean())
            out["psnr"] = float(20 * np.log10(rng_) - 10 * np.log10(max(mse, 1e-12)))
        elif n == "ssim":
            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a, np.float32))[None].to(device)

            with torch.no_grad():
                out["ssim"] = float(ssim_metric(t(pred), t(gt_norm), data_range=rng_))
    return out
