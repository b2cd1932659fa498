"""Top-level BiaPy job API of the PyTorch port.

Counterpart of ``biapy_tpu/_biapy.py::BiaPy``: config load (YAML, dict, or
a ``.ckpt`` checkpoint of either package with its embedded config),
migrate/merge/check, the workflow build (SEMANTIC_SEG, INSTANCE_SEG,
DETECTION, DENOISING, SUPER_RESOLUTION, SELF_SUPERVISED, IMAGE_TO_IMAGE,
CLASSIFICATION),
``train()``,
``test()``, ``run_job()`` and the in-memory ``predict``. BMZ is not ported
yet (ROADMAP queue 1).

Device rule: ``device=None`` means the CUDA card ``cuda:<gpu>`` (``gpu``
defaults to 0) and raises when PyTorch sees no CUDA device; the CPU is used
only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import importlib
import os
import sys
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from biapy_tpu_torch.config.config import CN, Config, update_dependencies
from biapy_tpu_torch.config.migrate import convert_old_model_cfg_to_current_version
from biapy_tpu_torch.engine.check_configuration import check_configuration

_WORKFLOW_MODULES = {
    "SEMANTIC_SEG": ("biapy_tpu_torch.engine.semantic_seg", "Semantic_Segmentation_Workflow"),
    "INSTANCE_SEG": ("biapy_tpu_torch.engine.instance_seg", "Instance_Segmentation_Workflow"),
    "DETECTION": ("biapy_tpu_torch.engine.detection", "Detection_Workflow"),
    "DENOISING": ("biapy_tpu_torch.engine.denoising", "Denoising_Workflow"),
    "SUPER_RESOLUTION": ("biapy_tpu_torch.engine.super_resolution", "Super_resolution_Workflow"),
    "SELF_SUPERVISED": ("biapy_tpu_torch.engine.self_supervised", "Self_supervised_Workflow"),
    "IMAGE_TO_IMAGE": ("biapy_tpu_torch.engine.image_to_image", "Image_to_Image_Workflow"),
    "CLASSIFICATION": ("biapy_tpu_torch.engine.classification", "Classification_Workflow"),
}


class _Tee:
    """Mirror stdout/stderr into the per-run log file."""

    def __init__(self, stream, logfile):
        self.stream = stream
        self.logfile = logfile

    def write(self, data):
        self.stream.write(data)
        self.logfile.write(data)

    def flush(self):
        self.stream.flush()
        self.logfile.flush()


def resolve_device(device: Union[None, str, torch.device], gpu: Optional[str] = None
                   ) -> torch.device:
    """``device`` if given; otherwise the CUDA card ``gpu`` (first index of
    a comma list, default 0). Never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "biapy_tpu_torch runs on a CUDA device and PyTorch sees none; pass "
            "device='cpu' to run on the CPU explicitly")
    idx = int(str(gpu).split(",")[0]) if gpu not in (None, "") else 0
    return torch.device(f"cuda:{idx}")


class BiaPy:
    """One configured job: built from a YAML path, a dict or a CN."""

    def __init__(
        self,
        config: Union[str, Dict, CN],
        result_dir: str = "",
        name: str = "my_2d_semantic_segmentation",
        run_id: int = 1,
        gpu: Optional[str] = None,
        silent: bool = False,
        check_data_paths: bool = True,
        device: Union[None, str, torch.device] = None,
        **kwargs,
    ):
        self.device = resolve_device(device, gpu)
        self.job_identifier = name
        if "/" in name:
            raise ValueError("Job name can not contain / character")
        self.run_id = run_id
        result_dir = result_dir or os.getenv("HOME", ".")
        self.job_dir = os.path.join(result_dir, name)

        raw = self._load_raw_config(config)
        raw = convert_old_model_cfg_to_current_version(
            raw, verbose=raw.get("PROBLEM", {}).get("PRINT_OLD_KEY_CHANGES", True) and not silent
        )
        cfg_holder = Config(self.job_dir, self.job_identifier)
        self.cfg = cfg_holder.get_cfg_defaults()
        self.cfg.merge_from_dict(raw)
        if str(raw.get("MODEL", {}).get("SOURCE", "")).lower() == "bmz":
            raise NotImplementedError("MODEL.SOURCE 'bmz' is not ported to biapy_tpu_torch yet "
                                      "(ROADMAP queue 1 item 11, BMZ)")
        update_dependencies(self.cfg, self.job_dir, self.job_identifier)
        check_configuration(self.cfg, self.job_identifier, check_data_paths=check_data_paths)

        self._silent = silent
        self._tee_handles = None
        if not silent:
            os.makedirs(self.cfg.LOG.LOG_DIR, exist_ok=True)
            log_path = os.path.join(self.cfg.LOG.LOG_DIR,
                                    f"{self.cfg.LOG.LOG_FILE_PREFIX}_{run_id}.log")
            logfile = open(log_path, "a")
            sys.stdout = _Tee(sys.__stdout__, logfile)
            sys.stderr = _Tee(sys.__stderr__, logfile)
            self._tee_handles = logfile

        self.workflow = None

    @staticmethod
    def _load_raw_config(config) -> Dict:
        if isinstance(config, CN):
            return config.to_dict()
        if isinstance(config, dict):
            return dict(config)
        if isinstance(config, str):
            if config.endswith((".yaml", ".yml")):
                import yaml

                with open(config) as f:
                    return yaml.safe_load(f) or {}
            if config.endswith(".ckpt"):
                # the embedded config is YAML text (block style from the JAX
                # package, flow style from the port): PyYAML reads both
                import yaml

                from biapy_tpu_torch.utils.misc import load_checkpoint

                ck = load_checkpoint(config)
                raw = yaml.safe_load(ck["cfg"]) or {}
                raw.setdefault("PATHS", {})["CHECKPOINT_FILE"] = config
                raw.setdefault("MODEL", {})["LOAD_CHECKPOINT"] = True
                return raw
            raise ValueError(f"Config file must be .yaml/.yml/.ckpt: {config}")
        raise ValueError(f"Unsupported config type: {type(config)}")

    def _build_workflow(self):
        if self.workflow is not None:
            return
        # check_configuration admits only these eight workflows
        mod_name, cls_name = _WORKFLOW_MODULES[self.cfg.PROBLEM.TYPE]
        cls = getattr(importlib.import_module(mod_name), cls_name)
        self.cfg.freeze()
        self.workflow = cls(self.cfg, self.job_identifier, verbose=not self._silent,
                            device=self.device)

    def train(self):
        self._build_workflow()
        self.workflow.train()

    def test(self):
        self._build_workflow()
        self.workflow.test()

    def predict(self, image: np.ndarray, gt: Optional[np.ndarray] = None) -> List[Dict[str, Any]]:
        """In-memory inference; returns predictions without writing anything
        to disk."""
        self._build_workflow()
        cfg = self.workflow.cfg
        was_frozen = cfg.is_frozen()
        if was_frozen:
            cfg.defrost()
        cfg.TEST.ENABLE = True
        cfg.TEST.BY_CHUNKS.ENABLE = False
        if was_frozen:
            cfg.freeze()
        self.workflow.save_to_disk = False
        try:
            self.workflow.test(image=image, gt=gt)
            return list(self.workflow._predictions)
        finally:
            self.workflow.save_to_disk = True

    def run_job(self):
        """train() then test() (reference: run_job, _biapy.py:1906)."""
        if self.cfg.MODEL.BMZ.EXPORT.ENABLE:
            raise NotImplementedError("MODEL.BMZ.EXPORT is not ported to biapy_tpu_torch yet "
                                      "(ROADMAP queue 1 item 11, BMZ)")
        if self.cfg.TRAIN.ENABLE:
            self.train()
        if self.cfg.TEST.ENABLE:
            self.test()
        if not self._silent:
            print("FINISHED JOB {} !!".format(self.job_identifier))
