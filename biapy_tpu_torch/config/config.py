"""Configuration tree for biapy_tpu.

A lightweight, dependency-free replacement for the reference's YACS-based
config (reference: biapy/config/config.py). Behaviour preserved:

* attribute access (``cfg.DATA.PATCH_SIZE``) over a nested tree of defaults,
* merging user YAML files / dicts onto the defaults, with YACS-style
  coercion of tuple-literal strings (``"(256, 256, 1)"`` -> ``(256, 256, 1)``),
* ``update_dependencies`` recomputing derived path keys after every merge
  (reference: biapy/config/config.py:2327-2388),
* freezing, cloning and YAML dumping.
"""

from __future__ import annotations

import ast
import copy
import json
import math
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

from biapy_tpu_torch.config.defaults import get_defaults_dict


def _coerce(new: Any, old: Any, path: str) -> Any:
    """Coerce a user-provided value to the type of the default value.

    Mirrors YACS's ``_check_and_coerce_cfg_value_type`` semantics: strings
    that look like Python literals become tuples/lists when the default is a
    tuple/list; int<->float promotion; list<->tuple interchange.
    """
    if old is None:
        return new
    if isinstance(new, str) and isinstance(old, (tuple, list)):
        try:
            new = ast.literal_eval(new)
        except (ValueError, SyntaxError):
            # Legacy scalar form of a list-valued key (e.g. "OPTIMIZER: ADAMW");
            # the reference migrates these to single-element lists
            # (check_configuration.py convert_old_model_cfg_to_current_version).
            new = [new]
    if isinstance(old, list) and not isinstance(new, (tuple, list)):
        new = [new]
    if isinstance(old, tuple) and isinstance(new, list):
        new = tuple(new)
    elif isinstance(old, list) and isinstance(new, tuple):
        new = list(new)
    if isinstance(old, bool) and not isinstance(new, bool):
        if new in (0, 1):
            return bool(new)
        if isinstance(new, str) and path.endswith("STUNET.PRETRAINED"):
            return new  # bool-or-local-path (no-egress pretrained loading)
        raise ValueError(f"Config key {path}: expected bool, got {new!r}")
    if isinstance(old, float) and isinstance(new, int):
        new = float(new)
    if isinstance(old, int) and not isinstance(old, bool) and isinstance(new, float) and new.is_integer():
        new = int(new)
    if type(new) is not type(old) and not (isinstance(new, (int, float)) and isinstance(old, (int, float))):
        # Permissive for strings standing in for typed values the reference
        # also treats loosely (e.g. -1 vs "auto") — only hard-fail on
        # container/scalar mismatches.
        if isinstance(old, (tuple, list)) != isinstance(new, (tuple, list)):
            raise ValueError(
                f"Config key {path}: type mismatch (expected {type(old).__name__}, got {type(new).__name__}: {new!r})"
            )
    return new


def _flow_yaml(v: Any) -> str:
    """One value as YAML flow text that PyYAML's ``safe_load`` reads back:
    JSON, except floats, which YAML 1.1 reads as floats only with a dot in
    the mantissa (``1.0e-05``, not ``1e-05``) and spells ``.inf``/``.nan``."""
    if isinstance(v, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {_flow_yaml(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow_yaml(x) for x in v) + "]"
    if isinstance(v, float) and not isinstance(v, bool):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        mant, _, exp = repr(v).partition("e")
        if "." not in mant:
            mant += ".0"
        return mant + ("e" + exp if exp else "")
    return json.dumps(v)


class CN:
    """A config node: nested attribute-dict with freeze support."""

    __slots__ = ("_data", "_frozen")

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_frozen", False)
        if data:
            for k, v in data.items():
                self._data[k] = CN(v) if isinstance(v, dict) else v

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self._data[name]
        except KeyError:
            raise AttributeError(f"Config has no key '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if self._frozen:
            raise AttributeError(f"Config is frozen; cannot set '{name}'")
        self._data[name] = CN(value) if isinstance(value, dict) and not isinstance(value, CN) else value

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self.__setattr__(name, value)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, CN):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"CN({self.to_dict()!r})"

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    # -- freeze / clone ----------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, "_frozen", True)
        for v in self._data.values():
            if isinstance(v, CN):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, "_frozen", False)
        for v in self._data.values():
            if isinstance(v, CN):
                v.defrost()

    def is_frozen(self) -> bool:
        return self._frozen

    def clone(self) -> "CN":
        return CN(self.to_dict())

    # -- conversion ----------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, CN) else copy.deepcopy(v)
        return out

    def dump(self) -> str:
        """The config as YAML text, without PyYAML: flow style (JSON with
        YAML 1.1 floats), one top-level section per line; tuples are
        rendered as lists, like YACS output. ``yaml.safe_load`` gives back
        ``to_dict()``."""
        items = [f"{json.dumps(k)}: {_flow_yaml(v)}" for k, v in self.to_dict().items()]
        return "{" + ",\n ".join(items) + "}\n"

    # -- merging -------------------------------------------------------------
    def merge_from_dict(self, other: Dict[str, Any], _path: str = "", allow_new: bool = False) -> None:
        if self._frozen:
            raise AttributeError("Config is frozen")
        for k, v in other.items():
            path = f"{_path}.{k}" if _path else k
            if k not in self._data:
                if allow_new:
                    self._data[k] = CN(v) if isinstance(v, dict) else v
                    continue
                raise KeyError(f"Unknown config key: {path}")
            cur = self._data[k]
            if isinstance(cur, CN):
                if not isinstance(v, dict):
                    raise ValueError(f"Config key {path} is a section; got scalar {v!r}")
                cur.merge_from_dict(v, path, allow_new)
            else:
                self._data[k] = _coerce(v, cur, path)

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        self.merge_from_dict(raw)

    def merge_from_other_cfg(self, other: "CN") -> None:
        self.merge_from_dict(other.to_dict())

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge from a flat ['KEY.SUBKEY', value, ...] list (YACS-style)."""
        assert len(opts) % 2 == 0, "Override list must have even length"
        for key, val in zip(opts[0::2], opts[1::2]):
            parts = key.split(".")
            node = self
            for p in parts[:-1]:
                node = getattr(node, p)
            old = node.get(parts[-1])
            if isinstance(val, str):
                try:
                    val = ast.literal_eval(val)
                except (ValueError, SyntaxError):
                    pass
            node[parts[-1]] = _coerce(val, old, key)


class Config:
    """Owns the default tree, bound to a job dir/name.

    Reference analog: ``biapy.config.config.Config`` (config.py:24-52).
    """

    def __init__(self, job_dir: str = ".", job_identifier: str = "job"):
        if "/" in job_identifier:
            raise ValueError("Job name can not contain / character. Provided: {}".format(job_identifier))
        self.job_dir = job_dir
        self.job_identifier = job_identifier
        self._C = CN(get_defaults_dict())
        update_dependencies(self._C, job_dir, job_identifier)

    def get_cfg_defaults(self) -> CN:
        return self._C.clone()

    def update_dependencies(self) -> None:
        update_dependencies(self._C, self.job_dir, self.job_identifier)


def update_dependencies(cfg: CN, job_dir: str = ".", job_identifier: str = "job") -> None:
    """Recompute derived keys after a merge.

    Reference analog: biapy/config/config.py:2327-2388 — instance-channel
    dirs, detection-mask dirs, SSL source dirs, and all result/checkpoint/log
    paths derive from user-set keys.
    """
    frozen = cfg.is_frozen()
    if frozen:
        cfg.defrost()

    # 3D problems: default 2-length OVERLAP/PADDING tuples gain a leading z
    # entry (the reference's defaults are per-NDIM; ours is one tree).
    if cfg.PROBLEM.NDIM == "3D":
        for split in ("TRAIN", "VAL", "TEST"):
            node = cfg.DATA[split]
            for key in ("OVERLAP", "PADDING"):
                v = node[key]
                if len(v) == 2:
                    node[key] = type(v)((0,)) + type(v)(v) if isinstance(v, tuple) else [0] + list(v)

    # All-zero dropout lists broadcast to the U-Net depth (reference:
    # check_configuration.py:2628 adjusts DROPOUT_VALUES to FEATURE_MAPS).
    fm, dv = cfg.MODEL.FEATURE_MAPS, cfg.MODEL.DROPOUT_VALUES
    if len(dv) != len(fm) and all(float(x) == 0 for x in dv):
        cfg.MODEL.DROPOUT_VALUES = [0.0] * len(fm)

    # All-zero Z_DOWN/YX_DOWN (the "auto" default) become one 2 per
    # downsampling level (reference: check_configuration.py:2688-2695;
    # multiresunet's fixed 4-level encoder gets (2, 2, 2, 2)).
    n_down = 4 if cfg.MODEL.ARCHITECTURE.lower() == "multiresunet" else max(1, len(fm) - 1)
    for key in ("Z_DOWN", "YX_DOWN"):
        v = cfg.MODEL[key]
        if all(int(x) == 0 for x in v):
            cfg.MODEL[key] = [2] * n_down

    # Instance channel dirs sit next to the GT dirs, tagged by the channel code.
    chans = cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNELS
    tag = "".join(chans) if isinstance(chans, (list, tuple)) else str(chans)
    if cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNEL_WEIGHTS:
        tag += "_" + "".join(str(w) for w in cfg.PROBLEM.INSTANCE_SEG.DATA_CHANNEL_WEIGHTS)
    for split in ("TRAIN", "VAL", "TEST"):
        node = cfg.DATA[split]
        if node.INPUT_ZARR_MULTIPLE_DATA:
            # Zarr-multiple mode: channel zarrs live next to the data
            # (reference: update_dependencies, config.py:2360-2372)
            base = os.path.join(str(node.PATH), "_")
        else:
            base = node.GT_PATH if split != "TEST" or node.LOAD_GT else node.PATH
        node.INSTANCE_CHANNELS_MASK_DIR = os.path.join(os.path.dirname(str(base)), f"y_{tag}")
        node.DETECTION_MASK_DIR = os.path.join(os.path.dirname(str(base)), "y_detection_masks")
        node.SSL_SOURCE_DIR = os.path.join(os.path.dirname(str(node.PATH)), "x_ssl_source")

    res = os.path.join(job_dir, "results", job_identifier)
    R = cfg.PATHS.RESULT_DIR
    R.PATH = res
    R.PER_IMAGE = os.path.join(res, "per_image")
    R.PER_IMAGE_BIN = os.path.join(res, "per_image_binarized")
    R.PER_IMAGE_INSTANCES = os.path.join(res, "per_image_instances")
    R.PER_IMAGE_POST_PROCESSING = os.path.join(res, "per_image_post_processing")
    R.FULL_IMAGE = os.path.join(res, "full_image")
    R.FULL_IMAGE_BIN = os.path.join(res, "full_image_binarized")
    R.FULL_IMAGE_INSTANCES = os.path.join(res, "full_image_instances")
    R.FULL_IMAGE_POST_PROCESSING = os.path.join(res, "full_image_post_processing")
    R.AS_3D_STACK = os.path.join(res, "as_3d_stack")
    R.AS_3D_STACK_BIN = os.path.join(res, "as_3d_stack_binarized")
    R.AS_3D_STACK_POST_PROCESSING = os.path.join(res, "as_3d_stack_post_processing")
    R.DET_LOCAL_MAX_COORDS_CHECK = os.path.join(res, "per_image_local_max_check")
    R.DET_LOCAL_MAX_COORDS_CHECK_POST_PROCESSING = os.path.join(res, "per_image_local_max_check_post_processing")
    R.DET_ASSOC_POINTS = os.path.join(res, "point_associations")
    R.INST_ASSOC_POINTS = os.path.join(res, "instance_associations")
    P = cfg.PATHS
    if not P.BMZ_EXPORT_PATH or os.path.basename(str(P.BMZ_EXPORT_PATH)) == "BMZ_files":
        # derive unless the user pinned a custom export dir
        P.BMZ_EXPORT_PATH = os.path.join(res, "BMZ_files")
    P.PROFILER = os.path.join(res, "profiler")
    P.CHARTS = os.path.join(res, "charts")
    P.DA_SAMPLES = os.path.join(res, "aug")
    P.GEN_CHECKS = os.path.join(res, "gen_check")
    P.GEN_MASK_CHECKS = os.path.join(res, "gen_mask_check")
    P.TRAIN_INSTANCE_CHANNELS_CHECK = os.path.join(res, "train_instance_channels")
    P.VAL_INSTANCE_CHANNELS_CHECK = os.path.join(res, "val_instance_channels")
    P.TEST_INSTANCE_CHANNELS_CHECK = os.path.join(res, "test_instance_channels")
    P.CHECKPOINT = os.path.join(job_dir, "checkpoints")
    P.PROB_MAP_DIR = os.path.join(job_dir, "prob_map")
    P.WATERSHED_DIR = os.path.join(res, "watershed")
    P.MAE_OUT_DIR = os.path.join(res, "MAE_checks")
    P.FIL_SAMPLES_DIR = os.path.join(res, "filtering_information")
    cfg.LOG.LOG_DIR = os.path.join(job_dir, "logs")
    cfg.LOG.TENSORBOARD_LOG_DIR = os.path.join(res, "tensorboard")
    cfg.LOG.LOG_FILE_PREFIX = job_identifier

    if frozen:
        cfg.freeze()


def get_cfg_defaults(job_dir: str = ".", job_identifier: str = "job") -> CN:
    return Config(job_dir, job_identifier).get_cfg_defaults()
