"""Legacy-config migration.

Translates configs written for older BiaPy versions into the current key
schema before merging onto the defaults, and reports what changed.

Reference analog: ``convert_old_model_cfg_to_current_version`` and
``diff_between_configs`` (reference: biapy/engine/check_configuration.py:3573-4256).
This is a re-implementation of the same key-level translations, table-driven
where possible.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Tuple


def _get(d: Dict, *path):
    for p in path:
        if not isinstance(d, dict) or p not in d:
            return None
        d = d[p]
    return d


def _ensure(d: Dict, *path) -> Dict:
    for p in path:
        d = d.setdefault(p, {})
    return d


def _pop(d: Dict, *path):
    """Pop a nested key if present; returns (found, value)."""
    parent = _get(d, *path[:-1]) if len(path) > 1 else d
    if isinstance(parent, dict) and path[-1] in parent:
        return True, parent.pop(path[-1])
    return False, None


# Keys the current version simply dropped.
_DELETED = [
    ("TRAIN", "ACCUM_ITER"),
    ("TEST", "EVALUATE"),
    ("TEST", "BY_CHUNKS", "FORMAT"),
    ("TEST", "BY_CHUNKS", "WORKFLOW_PROCESS", "INSTANCE_SEG_HALO"),
    ("AUGMENTOR", "BRIGHTNESS_EM"),
    ("AUGMENTOR", "BRIGHTNESS_EM_FACTOR"),
    ("AUGMENTOR", "BRIGHTNESS_EM_MODE"),
    ("AUGMENTOR", "BRIGHTNESS_MODE"),
    ("AUGMENTOR", "CONTRAST_MODE"),
    ("DATA", "NORMALIZATION", "CUSTOM_MODE"),
    ("DATA", "NORMALIZATION", "APPLICATION_MODE"),
    ("DATA", "VAL", "BINARY_MASKS"),
    ("DATA", "TEST", "ARGMAX_TO_OUTPUT"),
    ("PROBLEM", "INSTANCE_SEG", "SYNAPSES", "NORMALIZE_DISTANCES"),
    ("PROBLEM", "INSTANCE_SEG", "SYNAPSES", "POSTSITE_DILATION_DISTANCE_CHANNELS"),
    ("PROBLEM", "INSTANCE_SEG", "SYNAPSES", "POSTSITE_DILATION"),
]

# Plain renames: old path -> new path (value carried over unchanged).
_RENAMED = [
    (("MODEL", "N_CLASSES"), ("DATA", "N_CLASSES")),
    (("MODEL", "CONVNEXT_LAYERS"), ("MODEL", "CONV_LAYERS")),
    (("MODEL", "UNETR_DEC_ACTIVATION"), ("MODEL", "ACTIVATION")),
    (("MODEL", "UNETR_DEC_KERNEL_SIZE"), ("MODEL", "KERNEL_SIZE")),
    (("MODEL", "BMZ", "SOURCE_MODEL_DOI"), ("MODEL", "BMZ", "SOURCE_MODEL_ID")),
    (("DATA", "EXTRACT_RANDOM_PATCH"), ("DATA", "TRAIN", "EXTRACT_RANDOM_PATCH")),
    (("DATA", "PROBABILITY_MAP"), ("DATA", "TRAIN", "PROBABILITY_MAP")),
    (("DATA", "W_FOREGROUND"), ("DATA", "TRAIN", "W_FOREGROUND")),
    (("DATA", "W_BACKGROUND"), ("DATA", "TRAIN", "W_BACKGROUND")),
]

# Old flat instance-seg keys that moved under PROBLEM.INSTANCE_SEG.WATERSHED.
_INST_TO_WATERSHED = [
    ("SEED_MORPH_SEQUENCE", "SEED_MORPH_SEQUENCE"),
    ("SEED_MORPH_RADIUS", "SEED_MORPH_RADIUS"),
    ("ERODE_AND_DILATE_GROWTH_MASK", "ERODE_AND_DILATE_GROWTH_MASK"),
    ("FORE_EROSION_RADIUS", "FORE_EROSION_RADIUS"),
    ("FORE_DILATION_RADIUS", "FORE_DILATION_RADIUS"),
    ("DATA_CHECK_MW", "DATA_CHECK_MW"),
    ("DATA_REMOVE_BEFORE_MW", "DATA_REMOVE_BEFORE_MW"),
    ("DATA_REMOVE_SMALL_OBJ_BEFORE", "DATA_REMOVE_SMALL_OBJ_BEFORE"),
    ("WATERSHED_BY_2D_SLICES", "BY_2D_SLICES"),
]

_PER_AUG_PROB_KEYS = [
    "ZOOM_PROB", "RANDOM_ROT_PROB", "ROT90_PROB", "SHEAR_PROB", "SHIFT_PROB", "VFLIP_PROB",
    "HFLIP_PROB", "ZFLIP_PROB", "ELASTIC_PROB", "G_BLUR_PROB", "MEDIAN_BLUR_PROB",
    "MOTION_BLUR_PROB", "GAMMA_CONTRAST_PROB", "BRIGHTNESS_PROB", "CONTRAST_PROB",
    "DROPOUT_PROB", "CUTOUT_PROB", "CUTBLUR_PROB", "CUTMIX_PROB", "CUTNOISE_PROB",
    "MISALIGNMENT_PROB", "MISSING_SECTIONS_PROB", "GRAYSCALE_PROB", "CHANNEL_SHUFFLE_PROB",
    "GRIDMASK_PROB", "GAUSSIAN_NOISE_PROB", "POISSON_NOISE_PROB", "SALT_PROB", "PEPPER_PROB",
    "SALT_AND_PEPPER_PROB",
]


def convert_old_model_cfg_to_current_version(old_cfg: dict, verbose: bool = False) -> dict:
    """Translate a (possibly old) raw config dict to the current schema."""
    cfg = copy.deepcopy(old_cfg)
    changes: List[str] = []

    def note(msg: str):
        changes.append(msg)

    # ---- scalars that became per-head lists ----
    tr = cfg.get("TRAIN", {})
    for k in ("OPTIMIZER", "LR"):
        if k in tr and not isinstance(tr[k], (list, tuple)):
            tr[k] = [tr[k]]
            note(f"TRAIN.{k}: scalar -> list")
    if "OPT_BETAS" in tr and isinstance(tr["OPT_BETAS"], str):
        clean = tr["OPT_BETAS"].strip().strip("()")
        tr["OPT_BETAS"] = [[float(x.strip()) for x in clean.split(",")]]
        note("TRAIN.OPT_BETAS: string -> list of lists")
    sched = tr.get("LR_SCHEDULER", {})
    if "MIN_LR" in sched and isinstance(sched["MIN_LR"], float):
        sched["MIN_LR"] = [sched["MIN_LR"]] * len(tr.get("OPTIMIZER", [0]))
        note("TRAIN.LR_SCHEDULER.MIN_LR: scalar -> list")

    # ---- simple deletes and renames ----
    for path in _DELETED:
        found, _ = _pop(cfg, *path)
        if found:
            note(".".join(path) + ": removed (key no longer exists)")
    for old, new in _RENAMED:
        found, val = _pop(cfg, *old)
        if found:
            _ensure(cfg, *new[:-1])[new[-1]] = val
            note(".".join(old) + " -> " + ".".join(new))

    # TEST.STATS dropped entirely; only FULL_IMG survives as TEST.FULL_IMG.
    found, stats = _pop(cfg, "TEST", "STATS")
    if found and isinstance(stats, dict):
        if "FULL_IMG" in stats:
            _ensure(cfg, "TEST")["FULL_IMG"] = stats["FULL_IMG"]
        note("TEST.STATS removed (FULL_IMG kept as TEST.FULL_IMG)")

    ndim = 3 if _get(cfg, "PROBLEM", "NDIM") == "3D" else 2

    # ---- TEST.POST_PROCESSING reshapes ----
    pp = _get(cfg, "TEST", "POST_PROCESSING")
    if isinstance(pp, dict):
        for axis_key, axis in (("YZ_FILTERING", "yz"), ("Z_FILTERING", "z")):
            if axis_key in pp:
                del pp[axis_key]
                fsize = pp.pop(axis_key + "_SIZE", 5)
                pp["MEDIAN_FILTER"] = True
                pp["MEDIAN_FILTER_AXIS"] = [axis]
                pp["MEDIAN_FILTER_SIZE"] = [fsize]
                note(f"TEST.POST_PROCESSING.{axis_key} -> MEDIAN_FILTER(axis={axis})")
        mp = pp.get("MEASURE_PROPERTIES", {})
        rbp = mp.get("REMOVE_BY_PROPERTIES", {}) if isinstance(mp, dict) else {}
        if isinstance(rbp, dict) and "SIGN" in rbp:
            rbp["SIGNS"] = rbp.pop("SIGN")
            note("TEST.POST_PROCESSING.MEASURE_PROPERTIES.REMOVE_BY_PROPERTIES.SIGN -> SIGNS")
        if "REMOVE_BY_PROPERTIES" in pp:
            props = pp.pop("REMOVE_BY_PROPERTIES")
            mp = pp.setdefault("MEASURE_PROPERTIES", {})
            mp["ENABLE"] = True
            rbp = mp.setdefault("REMOVE_BY_PROPERTIES", {})
            rbp["ENABLE"] = True
            rbp["PROPS"] = props
            if "REMOVE_BY_PROPERTIES_VALUES" in pp:
                rbp["VALUES"] = pp.pop("REMOVE_BY_PROPERTIES_VALUES")
            if "REMOVE_BY_PROPERTIES_SIGN" in pp:
                rbp["SIGNS"] = pp.pop("REMOVE_BY_PROPERTIES_SIGN")
            note("TEST.POST_PROCESSING.REMOVE_BY_PROPERTIES -> MEASURE_PROPERTIES.REMOVE_BY_PROPERTIES")
        if isinstance(pp.get("REMOVE_CLOSE_POINTS_RADIUS"), list):
            v = pp.pop("REMOVE_CLOSE_POINTS_RADIUS")
            if v:
                pp["REMOVE_CLOSE_POINTS_RADIUS"] = v[0]
            note("TEST.POST_PROCESSING.REMOVE_CLOSE_POINTS_RADIUS: list -> scalar")
        dwd = pp.get("DET_WATERSHED_FIRST_DILATION")
        if isinstance(dwd, list) and dwd and isinstance(dwd[0], list):
            pp["DET_WATERSHED_FIRST_DILATION"] = dwd[0]
            note("TEST.POST_PROCESSING.DET_WATERSHED_FIRST_DILATION: nested list flattened")
        for flag, op in (("CLEAR_BORDER", "clear_border"), ("FILL_HOLES", "fill_holes")):
            if flag in pp:
                val = pp.pop(flag)
                ir = pp.setdefault("INSTANCE_REFINEMENT", {"ENABLE": False, "OPERATIONS": [], "VALUES": []})
                if val:
                    ir["ENABLE"] = True
                    ir.setdefault("OPERATIONS", []).append(op)
                    ir.setdefault("VALUES", []).append("none")
                note(f"TEST.POST_PROCESSING.{flag} -> INSTANCE_REFINEMENT.{op}")
        if "APPLY_MASK" in pp:
            apply_mask = pp.pop("APPLY_MASK")
            if apply_mask:
                _ensure(cfg, "DATA", "TEST", "ROI_MASK")["ENABLE"] = True
            note("TEST.POST_PROCESSING.APPLY_MASK -> DATA.TEST.ROI_MASK.ENABLE")

    # DATA.TEST.BINARY_MASKS -> ROI mask path
    found, bin_masks = _pop(cfg, "DATA", "TEST", "BINARY_MASKS")
    if found:
        roi = _ensure(cfg, "DATA", "TEST", "ROI_MASK")
        roi["ENABLE"] = True
        roi["PATH"] = bin_masks
        note("DATA.TEST.BINARY_MASKS -> DATA.TEST.ROI_MASK.PATH")

    # ---- TEST scalars ----
    t = cfg.get("TEST", {})
    for k in ("DET_MIN_TH_TO_BE_PEAK", "DET_TOLERANCE"):
        if isinstance(t.get(k), list):
            if t[k]:
                t[k] = t[k][0]
            else:
                del t[k]
            note(f"TEST.{k}: list -> scalar")

    # ---- BY_CHUNKS data keys that moved to DATA.TEST ----
    bc = _get(cfg, "TEST", "BY_CHUNKS")
    if isinstance(bc, dict):
        for x in ("INPUT_IMG_AXES_ORDER", "INPUT_MASK_AXES_ORDER", "INPUT_ZARR_MULTIPLE_DATA",
                  "INPUT_ZARR_MULTIPLE_DATA_RAW_PATH", "INPUT_ZARR_MULTIPLE_DATA_GT_PATH"):
            if x in bc:
                _ensure(cfg, "DATA", "TEST")[x] = bc.pop(x)
                note(f"TEST.BY_CHUNKS.{x} -> DATA.TEST.{x}")

    # ---- PROBLEM reshapes ----
    det = _get(cfg, "PROBLEM", "DETECTION")
    if isinstance(det, dict) and "CENTRAL_POINT_DILATION" in det and not isinstance(
        det["CENTRAL_POINT_DILATION"], list
    ):
        det["CENTRAL_POINT_DILATION"] = [det["CENTRAL_POINT_DILATION"]] * ndim
        note("PROBLEM.DETECTION.CENTRAL_POINT_DILATION: scalar -> per-axis list")
    sr = _get(cfg, "PROBLEM", "SUPER_RESOLUTION")
    if isinstance(sr, dict) and "UPSCALING" in sr and not isinstance(sr["UPSCALING"], (list, tuple)):
        v = sr["UPSCALING"]
        if isinstance(v, str) and v.strip().startswith("("):
            # YAML-quoted tuple form used by the reference templates: "(2,2)"
            import ast

            sr["UPSCALING"] = tuple(ast.literal_eval(v))
            note("PROBLEM.SUPER_RESOLUTION.UPSCALING: string tuple -> tuple")
        else:
            sr["UPSCALING"] = tuple([v] * ndim)
            note("PROBLEM.SUPER_RESOLUTION.UPSCALING: scalar -> per-axis tuple")

    inst = _get(cfg, "PROBLEM", "INSTANCE_SEG")
    if isinstance(inst, dict):
        ws = inst.setdefault("WATERSHED", {})
        # channel string -> list with renamed codes
        if isinstance(inst.get("DATA_CHANNELS"), str):
            remap = {"B": "F", "D": "Db", "Dv2": "D", "F": "HVZ"}
            # parse a concatenated code string like "BC" / "BCD" / "BP" char-wise,
            # honouring 2-char codes
            s = inst["DATA_CHANNELS"]
            codes: List[str] = []
            i = 0
            two_char = ("Db", "Dc", "Dn", "Gh", "Gv", "Gz", "Dv")
            while i < len(s):
                if s[i : i + 3] == "Dv2":
                    codes.append("Dv2")
                    i += 3
                elif s[i : i + 2] in two_char:
                    codes.append(s[i : i + 2])
                    i += 2
                else:
                    codes.append(s[i])
                    i += 1
            codes = [remap.get(c, c) for c in codes]
            if "HVZ" in codes:
                codes.remove("HVZ")
                codes.extend(["V", "H"] if ndim == 2 else ["V", "H", "Z"])
            inst["DATA_CHANNELS"] = codes
            note(f"PROBLEM.INSTANCE_SEG.DATA_CHANNELS: '{s}' -> {codes}")
        found, val = _pop(inst, "DISTANCE_CHANNEL_MASK")
        if found and val is False and "D" in (inst.get("DATA_CHANNELS") or []):
            inst["DATA_CHANNELS_EXTRA_OPTS"] = [{"D": {"mask_values": False}}]
            note("PROBLEM.INSTANCE_SEG.DISTANCE_CHANNEL_MASK -> DATA_CHANNELS_EXTRA_OPTS")
        # manual thresholds moved under WATERSHED
        found, th_type = _pop(inst, "DATA_MW_TH_TYPE")
        manual = found and th_type == "manual"
        th_map = {
            "DATA_MW_TH_BINARY_MASK": ("SEED_CHANNELS", "SEED_CHANNELS_THRESH", "F"),
            "DATA_MW_TH_FOREGROUND": ("GROWTH_MASK_CHANNELS", "GROWTH_MASK_CHANNELS_THRESH", "F"),
            "DATA_MW_TH_CONTOUR": ("SEED_CHANNELS", "SEED_CHANNELS_THRESH", "C"),
            "DATA_MW_TH_DISTANCE": ("SEED_CHANNELS", "SEED_CHANNELS_THRESH", "D"),
            "DATA_MW_TH_POINTS": ("SEED_CHANNELS", "SEED_CHANNELS_THRESH", "P"),
        }
        for old_key, (chan_key, th_key, code) in th_map.items():
            found, v = _pop(inst, old_key)
            if found and manual:
                ws.setdefault(chan_key, []).append(code)
                ws.setdefault(th_key, []).append(v)
                note(f"PROBLEM.INSTANCE_SEG.{old_key} -> WATERSHED.{th_key}")
            elif found:
                note(f"PROBLEM.INSTANCE_SEG.{old_key}: removed (auto thresholds)")
        for old_key, new_key in _INST_TO_WATERSHED:
            found, v = _pop(inst, old_key)
            if found:
                ws[new_key] = v
                note(f"PROBLEM.INSTANCE_SEG.{old_key} -> WATERSHED.{new_key}")
        if not ws:
            inst.pop("WATERSHED", None)

    # ---- DATA reshapes ----
    dtr = _get(cfg, "DATA", "TRAIN")
    if isinstance(dtr, dict) and "MINIMUM_FOREGROUND_PER" in dtr:
        min_fore = dtr.pop("MINIMUM_FOREGROUND_PER")
        if min_fore and min_fore > 0:
            dtr["FILTER_SAMPLES"] = {"ENABLE": True, "PROPS": [["foreground"]], "VALUES": [[min_fore]], "SIGNS": [["lt"]]}
        note("DATA.TRAIN.MINIMUM_FOREGROUND_PER -> FILTER_SAMPLES")
    norm = _get(cfg, "DATA", "NORMALIZATION")
    if isinstance(norm, dict):
        if norm.get("TYPE") == "custom":
            # legacy 'custom' = zero-mean-unit-var with user mean/std
            # (reference: check_configuration.py:3951)
            norm["TYPE"] = "zero_mean_unit_variance"
            zm = norm.setdefault("ZERO_MEAN_UNIT_VAR", {})
            if "CUSTOM_MEAN" in norm:
                zm["MEAN_VAL"] = [norm.pop("CUSTOM_MEAN")]
            if "CUSTOM_STD" in norm:
                zm["STD_VAL"] = [norm.pop("CUSTOM_STD")]
            note("DATA.NORMALIZATION.TYPE 'custom' -> 'zero_mean_unit_variance'")
        if "PERC_CLIP" in norm and not isinstance(norm["PERC_CLIP"], dict):
            val = norm.pop("PERC_CLIP")
            pc = norm.setdefault("PERC_CLIP", {})
            pc["ENABLE"] = bool(val)
            if "PERC_LOWER" in norm:
                pc["LOWER_PERC"] = norm.pop("PERC_LOWER")
            if "PERC_UPPER" in norm:
                pc["UPPER_PERC"] = norm.pop("PERC_UPPER")
            note("DATA.NORMALIZATION.PERC_CLIP: bool -> section")
        pc = norm.get("PERC_CLIP", {})
        if isinstance(pc, dict):
            for k in ("LOWER_VALUE", "UPPER_VALUE"):
                if k in pc and not isinstance(pc[k], list):
                    pc[k] = [pc[k]]
                    note(f"DATA.NORMALIZATION.PERC_CLIP.{k}: scalar -> list")
        zm = norm.get("ZERO_MEAN_UNIT_VAR", {})
        if isinstance(zm, dict):
            for k in ("MEAN_VAL", "STD_VAL"):
                if k in zm and not isinstance(zm[k], list):
                    zm[k] = [zm[k]]
                    note(f"DATA.NORMALIZATION.ZERO_MEAN_UNIT_VAR.{k}: scalar -> list")

    # ---- AUGMENTOR: global DA_PROB fan-out ----
    aug = cfg.get("AUGMENTOR", {})
    if "DA_PROB" in aug:
        da_prob = aug.pop("DA_PROB")
        for k in _PER_AUG_PROB_KEYS:
            aug.setdefault(k, da_prob)
        note(f"AUGMENTOR.DA_PROB ({da_prob}) fanned out to per-augmentation *_PROB keys")

    # ---- LOSS.CLASS_REBALANCE bool -> mode string ----
    loss = cfg.get("LOSS", {})
    if isinstance(loss.get("CLASS_REBALANCE"), bool):
        val = loss["CLASS_REBALANCE"]
        wf = _get(cfg, "PROBLEM", "TYPE") or "SEMANTIC_SEG"
        loss["CLASS_REBALANCE"] = "none"
        if wf == "INSTANCE_SEG":
            _ensure(cfg, "PROBLEM", "INSTANCE_SEG")["CLASS_REBALANCE_WITHIN_CHANNELS"] = val
        elif wf == "DETECTION":
            _ensure(cfg, "PROBLEM", "DETECTION")["CLASS_REBALANCE_WITHIN_CHANNELS"] = val
        elif val and loss.get("CLASS_WEIGHTS"):
            # 'manual' is only meaningful with explicit weights (reference:
            # check_configuration.py:4014-4016)
            loss["CLASS_REBALANCE"] = "manual"
        note("LOSS.CLASS_REBALANCE: bool -> mode string")
    elif str(loss.get("CLASS_REBALANCE", "")).lower() == "auto":
        # legacy 'auto' mode was dropped upstream; closest current semantics
        loss["CLASS_REBALANCE"] = "none"
        wf = _get(cfg, "PROBLEM", "TYPE") or "SEMANTIC_SEG"
        if wf == "INSTANCE_SEG":
            _ensure(cfg, "PROBLEM", "INSTANCE_SEG")["CLASS_REBALANCE_WITHIN_CHANNELS"] = True
        elif wf == "DETECTION":
            _ensure(cfg, "PROBLEM", "DETECTION")["CLASS_REBALANCE_WITHIN_CHANNELS"] = True
        note("LOSS.CLASS_REBALANCE: 'auto' -> within-channel rebalance")

    # ---- MODEL checkpoint-loading flags ----
    mdl = cfg.get("MODEL", {})
    load_ckpt = bool(mdl.get("LOAD_CHECKPOINT"))
    if "LOAD_MODEL_FROM_CHECKPOINT" in mdl:
        if mdl.pop("LOAD_MODEL_FROM_CHECKPOINT") and load_ckpt:
            mdl["ITEMS_TO_LOAD_FROM_CHECKPOINT"] = ["weights", "norm", "model_arch"]
        note("MODEL.LOAD_MODEL_FROM_CHECKPOINT -> ITEMS_TO_LOAD_FROM_CHECKPOINT")
    if "LOAD_CHECKPOINT_ONLY_WEIGHTS" in mdl:
        if mdl.pop("LOAD_CHECKPOINT_ONLY_WEIGHTS"):
            mdl["ITEMS_TO_LOAD_FROM_CHECKPOINT"] = ["weights"]
        note("MODEL.LOAD_CHECKPOINT_ONLY_WEIGHTS -> ITEMS_TO_LOAD_FROM_CHECKPOINT")
    if "BATCH_NORMALIZATION" in mdl:
        if mdl.pop("BATCH_NORMALIZATION"):
            mdl["NORMALIZATION"] = "bn"
        note("MODEL.BATCH_NORMALIZATION -> MODEL.NORMALIZATION")
    bmz = mdl.get("BMZ", {})
    if isinstance(bmz, dict) and "EXPORT_MODEL" in bmz:
        em = bmz.pop("EXPORT_MODEL")
        exp = bmz.setdefault("EXPORT", {})
        exp["ENABLED"] = em.get("ENABLE", False)
        if "NAME" in em:
            exp["MODEL_NAME"] = em["NAME"]
        if "DESCRIPTION" in em:
            exp["DESCRIPTION"] = em["DESCRIPTION"]
        note("MODEL.BMZ.EXPORT_MODEL -> MODEL.BMZ.EXPORT")

    if verbose and changes:
        print("Old configuration detected; the following keys were migrated:")
        for c in changes:
            print("  - " + c)

    return cfg


def diff_between_configs(a: dict, b: dict, prefix: str = "") -> List[Tuple[str, Any, Any]]:
    """Key-level diff of two config dicts (reference: check_configuration.py:4219)."""
    out: List[Tuple[str, Any, Any]] = []
    for k in sorted(set(a) | set(b)):
        path = f"{prefix}.{k}" if prefix else k
        va, vb = a.get(k), b.get(k)
        if isinstance(va, dict) and isinstance(vb, dict):
            out.extend(diff_between_configs(va, vb, path))
        elif va != vb:
            out.append((path, va, vb))
    return out
