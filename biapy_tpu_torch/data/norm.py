"""Image normalization.

Reference analog: biapy/data/norm.py (normalize_image:38, percentile_clip:389,
norm_range01:490, zero_mean_unit_variance_normalization:577, undo_*:634-760).

Behaviour preserved:
* three types — ``div`` (divide by 255/65535 chosen from data max, or by
  data min/max when ``scale_range``), ``scale_range``, ``zero_mean_unit_variance``
  (optionally with user-provided mean/std),
* optional percentile clipping before normalization (percentiles or explicit
  bound values, per channel),
* per-channel statistics recorded so the normalization is exactly invertible
  (``denormalize``), and reusable across patches of the same image,
* masks/labels are never value-normalized (only dtype-converted).

All functions are pure NumPy (host side) — they run in the input pipeline,
not on device.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def build_norm_dict(cfg) -> Dict[str, Any]:
    """Build a normalization spec dict from config (DATA.NORMALIZATION.*)."""
    n = cfg.DATA.NORMALIZATION
    spec: Dict[str, Any] = {
        "type": n.TYPE,
        "measure_by": getattr(n, "MEASURE_BY", "image"),
        "percentile_clip": bool(n.PERC_CLIP.ENABLE),
        "out_dtype": "float32",
    }
    if n.PERC_CLIP.ENABLE:
        spec["lower_perc"] = float(n.PERC_CLIP.LOWER_PERC)
        spec["upper_perc"] = float(n.PERC_CLIP.UPPER_PERC)
        lv = list(n.PERC_CLIP.LOWER_VALUE)
        uv = list(n.PERC_CLIP.UPPER_VALUE)
        spec["lower_value"] = None if (not lv or lv[0] == -1) else [float(v) for v in lv]
        spec["upper_value"] = None if (not uv or uv[0] == -1) else [float(v) for v in uv]
    if n.TYPE in ("zero_mean_unit_var", "zero_mean_unit_variance"):
        zm = n.ZERO_MEAN_UNIT_VAR
        mv = list(zm.MEAN_VAL)
        sv = list(zm.STD_VAL)
        spec["mean"] = None if (not mv or mv[0] == -1) else [float(v) for v in mv]
        spec["std"] = None if (not sv or sv[0] == -1) else [float(v) for v in sv]
    return spec


def _per_channel(img: np.ndarray, vals: Optional[List[float]]) -> Optional[List[float]]:
    if vals is None:
        return None
    if len(vals) == 1:
        return [vals[0]] * img.shape[-1]
    if len(vals) != img.shape[-1]:
        raise ValueError(f"Expected 1 or {img.shape[-1]} values, got {len(vals)}")
    return list(vals)


def normalize_image(
    img: np.ndarray,
    spec: Dict[str, Any],
    stats: Optional[Dict[str, Any]] = None,
) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Normalize a channels-last image; returns (normalized, stats).

    ``stats`` from a previous call on the same source image can be passed to
    reuse its values (so every patch of one image is normalized identically,
    as the reference caches stats on ``DatasetFile``).
    """
    assert img.ndim >= 3, "expected channels-last image (y,x,c) or (z,y,x,c)"
    c = img.shape[-1]
    ntype = spec["type"]
    out = img.astype(np.float32, copy=True)
    if stats is None:
        stats = {"type": ntype, "orig_dtype": str(img.dtype), "channels": [{} for _ in range(c)]}
        fresh = True
    else:
        fresh = False

    # -- percentile clip ----------------------------------------------------
    if spec.get("percentile_clip"):
        if fresh:
            low_v = _per_channel(img, spec.get("lower_value"))
            up_v = _per_channel(img, spec.get("upper_value"))
            for ci in range(c):
                ch = out[..., ci]
                lo = low_v[ci] if low_v else float(np.percentile(ch, spec.get("lower_perc", 2.0)))
                hi = up_v[ci] if up_v else float(np.percentile(ch, spec.get("upper_perc", 98.0)))
                stats["channels"][ci]["clip_low"] = lo
                stats["channels"][ci]["clip_high"] = hi
        for ci in range(c):
            s = stats["channels"][ci]
            np.clip(out[..., ci], s["clip_low"], s["clip_high"], out=out[..., ci])

    # -- value normalization ---------------------------------------------------
    if ntype in ("div", "scale_range"):
        for ci in range(c):
            ch = out[..., ci]
            s = stats["channels"][ci]
            if fresh:
                cmin, cmax = float(ch.min()), float(ch.max())
                if ntype == "scale_range":
                    s["min"], s["max"] = cmin, cmax
                else:
                    if cmin == 0.0 and cmax == 1.0:
                        # already in [0,1]; identity transform
                        s["min"], s["max"] = 0.0, 1.0
                    else:
                        s["min"] = 0.0
                        s["max"] = 65535.0 if cmax > 255 else 255.0
            denom = max(s["max"] - s["min"], 1e-6)
            out[..., ci] = (ch - s["min"]) / denom
    elif ntype in ("zero_mean_unit_var", "zero_mean_unit_variance"):
        mean_v = _per_channel(img, spec.get("mean"))
        std_v = _per_channel(img, spec.get("std"))
        for ci in range(c):
            ch = out[..., ci]
            s = stats["channels"][ci]
            if fresh:
                s["mean"] = mean_v[ci] if mean_v else float(ch.mean())
                s["std"] = std_v[ci] if std_v else float(ch.std())
            out[..., ci] = (ch - s["mean"]) / max(s["std"], 1e-6)
    elif ntype != "none":
        raise ValueError(f"Unknown normalization type: {ntype}")

    # Honor the spec's output width: under TEST.REDUCE_MEMORY the test norm
    # spec asks for bfloat16 so blocks ship half-width over H2D and the
    # device-side cast is a no-op (reference analog: float16 normalization
    # under the same flag, base_workflow.py:181,385). Stats stay float32.
    out_dt = spec.get("out_dtype", "float32")
    if out_dt not in ("float32", np.float32):
        out = out.astype(_np_dtype(out_dt))
    return out, stats


def _np_dtype(name):
    """Resolve a dtype name to numpy, including 'bfloat16' via ml_dtypes."""
    if str(name) == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def compute_norm_stats(img: np.ndarray, spec: Dict[str, Any]) -> Dict[str, Any]:
    """Compute the normalization stats of ``normalize_image`` WITHOUT
    materializing the normalized float copy.

    Used by the by-chunks device-normalization path: the host reads the raw
    (usually uint8/uint16) block, computes the per-channel stats here, and
    ships the raw bytes to the chip where cast + clip + affine fuse into one
    elementwise kernel (half/quarter the H2D bytes of a pre-normalized
    block on the bandwidth-capped transports this framework targets).
    The returned dict is interchangeable with ``normalize_image``'s stats:
    passing it back to ``normalize_image(img, spec, stats)`` reproduces the
    host-normalized block bit-for-bit (module tests pin this).
    """
    assert img.ndim >= 3, "expected channels-last image (y,x,c) or (z,y,x,c)"
    c = img.shape[-1]
    ntype = spec["type"]
    stats: Dict[str, Any] = {"type": ntype, "orig_dtype": str(img.dtype),
                             "channels": [{} for _ in range(c)]}
    clip = bool(spec.get("percentile_clip"))
    if clip:
        low_v = _per_channel(img, spec.get("lower_value"))
        up_v = _per_channel(img, spec.get("upper_value"))
        for ci in range(c):
            ch = img[..., ci]
            lo = low_v[ci] if low_v else float(np.percentile(ch, spec.get("lower_perc", 2.0)))
            hi = up_v[ci] if up_v else float(np.percentile(ch, spec.get("upper_perc", 98.0)))
            stats["channels"][ci]["clip_low"] = lo
            stats["channels"][ci]["clip_high"] = hi
    if ntype in ("div", "scale_range"):
        for ci in range(c):
            ch = img[..., ci]
            s = stats["channels"][ci]
            cmin, cmax = float(ch.min()), float(ch.max())
            if clip:
                # clipping is monotonic: min/max of the clipped data are the
                # clipped min/max — no clipped copy needed
                cmin = float(np.clip(cmin, s["clip_low"], s["clip_high"]))
                cmax = float(np.clip(cmax, s["clip_low"], s["clip_high"]))
            if ntype == "scale_range":
                s["min"], s["max"] = cmin, cmax
            else:
                if cmin == 0.0 and cmax == 1.0:
                    s["min"], s["max"] = 0.0, 1.0
                else:
                    s["min"] = 0.0
                    s["max"] = 65535.0 if cmax > 255 else 255.0
    elif ntype in ("zero_mean_unit_var", "zero_mean_unit_variance"):
        mean_v = _per_channel(img, spec.get("mean"))
        std_v = _per_channel(img, spec.get("std"))
        for ci in range(c):
            s = stats["channels"][ci]
            if mean_v and std_v:
                s["mean"], s["std"] = mean_v[ci], std_v[ci]
                continue
            ch = img[..., ci]
            if clip:
                # mean/std are over the clipped values: match
                # normalize_image's float32 pipeline exactly
                ch = np.clip(ch.astype(np.float32),
                             s["clip_low"], s["clip_high"])
            elif ch.dtype != np.float32:
                ch = ch.astype(np.float32)
            s["mean"] = mean_v[ci] if mean_v else float(ch.mean())
            s["std"] = std_v[ci] if std_v else float(ch.std())
    elif ntype != "none":
        raise ValueError(f"Unknown normalization type: {ntype}")
    return stats


def stats_to_affine(stats: Dict[str, Any]):
    """Flatten a stats dict into per-channel ``(lo, hi, sub, div)`` float32
    arrays so the device applies ``(clip(x, lo, hi) - sub) / div`` — the
    exact ``normalize_image`` value transform — inside the jitted program.
    Channels without clipping get ±inf bounds (the fused clip is free)."""
    chans = stats["channels"]
    c = len(chans)
    lo = np.full(c, -np.inf, np.float32)
    hi = np.full(c, np.inf, np.float32)
    sub = np.zeros(c, np.float32)
    div = np.ones(c, np.float32)
    ntype = stats["type"]
    for ci, s in enumerate(chans):
        if "clip_low" in s:
            lo[ci], hi[ci] = s["clip_low"], s["clip_high"]
        if ntype in ("div", "scale_range"):
            sub[ci] = s["min"]
            div[ci] = max(s["max"] - s["min"], 1e-6)
        elif ntype in ("zero_mean_unit_var", "zero_mean_unit_variance"):
            sub[ci] = s["mean"]
            div[ci] = max(s["std"], 1e-6)
    return lo, hi, sub, div


def denormalize(img: np.ndarray, stats: Dict[str, Any]) -> np.ndarray:
    """Invert ``normalize_image`` (reference: undo_image_norm, norm.py:634).

    Clipping is not invertible; values return in the clipped range. The
    result is cast back to the original dtype.
    """
    out = img.astype(np.float32, copy=True)
    ntype = stats["type"]
    for ci in range(out.shape[-1]):
        s = stats["channels"][ci]
        if ntype in ("div", "scale_range"):
            denom = max(s["max"] - s["min"], 1e-6)
            out[..., ci] = out[..., ci] * denom + s["min"]
        elif ntype in ("zero_mean_unit_var", "zero_mean_unit_variance"):
            out[..., ci] = out[..., ci] * max(s["std"], 1e-6) + s["mean"]
    odt = np.dtype(stats.get("orig_dtype", "float32"))
    if odt.kind in "ui":
        info = np.iinfo(odt)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(odt)


def normalize_mask(mask: np.ndarray, n_classes: int = 2) -> np.ndarray:
    """Prepare a mask for training: binary masks with {0,255} values are
    rescaled to {0,1}; multi-class label maps pass through as integers
    (reference: norm.py:215 normalize_mask)."""
    if mask.dtype.kind == "f":
        return mask.astype(np.float32)
    m = mask.astype(np.float32)
    if n_classes <= 2:
        mx = m.max()
        if mx > 1:
            m = (m > 0).astype(np.float32)
    return m


def merge_stats(stats_list: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Average per-channel stats over a dataset (for 'dataset'-level
    normalization measurement, DATA.NORMALIZATION.MEASURE_BY == 'dataset')."""
    if not stats_list:
        raise ValueError("empty stats list")
    out = copy.deepcopy(stats_list[0])
    keys = out["channels"][0].keys()
    for ci in range(len(out["channels"])):
        for k in keys:
            out["channels"][ci][k] = float(np.mean([s["channels"][ci][k] for s in stats_list]))
    return out
