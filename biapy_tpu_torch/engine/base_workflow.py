"""Base workflow: the model and train-state build, and inference.

Counterpart of ``biapy_tpu/engine/base_workflow.py``: ``apply_activations``,
``prepare_model`` (model, optimizer and ``TrainState``, which
``engine/train_engine.py::make_train_step`` advances),
``predict_block_on_device`` (whole-volume sliding-window inference on the
card, normalisation of the raw volume included), ``process_test_sample`` on
the device path and ``test`` on the in-memory branch. The epoch loop of
``train()``, checkpoints, test-time augmentation, the host crop/merge path,
ROI masks and reading test data from disk are not ported yet (ROADMAP
queue 1) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import glob
import os
from abc import ABCMeta, abstractmethod
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from biapy_tpu_torch.data.data_manipulation import prepare_in_memory_test_data
from biapy_tpu_torch.data.norm import build_norm_dict, compute_norm_stats, stats_to_affine
from biapy_tpu_torch.engine.schedulers import (PlateauController, build_multihead_optimizer,
                                                build_optimizer)
from biapy_tpu_torch.engine.train_engine import TrainState
from biapy_tpu_torch.models import build_model
from biapy_tpu_torch.ops.stitch import sliding_window_inference


def apply_activations(pred: torch.Tensor, acts: List[str], channels: List[int],
                      training: bool = False) -> torch.Tensor:
    """Per-head output activations; 'ce_*' activations belong to the loss in
    training and are applied only at inference."""
    outs = []
    off = 0
    for act, ch in zip(acts, channels):
        seg = pred[..., off:off + ch]
        a = act.lower()
        if a in ("ce_sigmoid", "sigmoid"):
            if not (training and a == "ce_sigmoid"):
                seg = torch.sigmoid(seg)
        elif a in ("ce_softmax", "softmax"):
            if not (training and a == "ce_softmax"):
                seg = torch.softmax(seg, dim=-1)
        elif a == "tanh":
            seg = torch.tanh(seg)
        elif a in ("linear", "none"):
            pass
        else:
            raise ValueError(f"Unknown head activation: {act}")
        outs.append(seg)
        off += ch
    return torch.cat(outs, dim=-1)


LEFT_OUT = "queue 1 item 1, left out of the serving slice"


def _not_ported(what: str, item: str = LEFT_OUT) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to biapy_tpu_torch yet (ROADMAP: {item})")


class Base_Workflow(metaclass=ABCMeta):
    """Shared train-state and inference machinery; subclasses define
    channels/activations, losses, metrics and post-processing hooks."""

    def __init__(self, cfg, job_identifier: str = "job", verbose: bool = True,
                 device: Optional[torch.device] = None):
        self.cfg = cfg
        self.job_identifier = job_identifier
        self.verbose = verbose
        self.device = torch.device(device) if device is not None else torch.device("cuda:0")
        self.is_3d = cfg.PROBLEM.NDIM == "3D"
        self.nd = 3 if self.is_3d else 2
        self.norm_spec = build_norm_dict(cfg)
        self.test_norm_spec = dict(self.norm_spec)
        if bool(cfg.TEST.REDUCE_MEMORY):
            self.test_norm_spec["out_dtype"] = "bfloat16"

        self.activations: List[str] = []
        self.output_channels: List[int] = []
        self.output_channel_info: List[str] = []
        self.define_activations_and_channels()
        self.loss = None
        self.train_metrics: Dict[str, Any] = {}
        self.define_metrics()

        self.model: Optional[torch.nn.Module] = None
        self.state: Optional[TrainState] = None
        self.plateau: Optional[PlateauController] = None
        self.model_build_kwargs: Dict = {}
        self._predictions: List[Dict[str, Any]] = []
        self.save_to_disk = True
        self.metrics_per_test_file: List[Dict[str, float]] = []

    # ---------------------------------------------------------------- hooks
    @abstractmethod
    def define_activations_and_channels(self):
        """Set self.activations / output_channels / output_channel_info."""

    @abstractmethod
    def define_metrics(self):
        """Set self.loss (callable) and self.train_metrics dict."""

    def metric_calculation(self, pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
        return {}

    def after_merge_patches(self, pred: np.ndarray, sample, fname: str) -> None:
        """Post-hook on the stitched prediction."""

    def after_all_images(self) -> None:
        """Post-hook after the whole test set."""

    # ------------------------------------------------------------- model
    def prepare_model(self):
        """Build the model on the workflow's device, initialised from a
        ``torch.Generator`` seeded with SYSTEM.SEED, and the train state
        (step 0, the optimizer over the model's parameters, the plateau
        controller if the schedule has one)."""
        if self.model is not None:
            return
        if self.cfg.MODEL.LOAD_CHECKPOINT:
            raise _not_ported("MODEL.LOAD_CHECKPOINT (the checkpoint reader)",
                              "queue 1 item 4, checkpoint reader")
        gen = torch.Generator().manual_seed(int(self.cfg.SYSTEM.SEED))
        model, self.model_build_kwargs = build_model(
            self.cfg, self.output_channels, self.output_channel_info, self.activations, gen=gen)
        self.model = model.to(self.device).eval()
        if self.verbose:
            n = sum(p.numel() for p in self.model.parameters())
            print(f"Model: {self.cfg.MODEL.ARCHITECTURE} — {n:,} parameters")
        steps_per_epoch = max(1, getattr(self, "_steps_per_epoch", 100))
        n_declared = max(len(self.cfg.TRAIN.OPTIMIZER), len(self.cfg.TRAIN.LR))
        if n_declared > 1 and len(self.output_channels) > 1:
            build_multihead_optimizer()
        optimizer, self.plateau = build_optimizer(self.cfg, steps_per_epoch,
                                                  self.model.named_parameters())
        self.state = TrainState(step=0, model=self.model, optimizer=optimizer,
                                plateau=self.plateau)

    def train(self):
        raise _not_ported("the epoch loop of Base_Workflow.train() (data generators, "
                          "augmentors, checkpoints, loggers; the train step itself is "
                          "engine/train_engine.py::make_train_step)",
                          "queue 1 item 3, training loop")

    def _ensure_model_for_test(self):
        if self.model is None:
            self.prepare_model()
            ck = self.cfg.PATHS.CHECKPOINT_FILE or glob.glob(os.path.join(
                str(self.cfg.PATHS.CHECKPOINT), f"{self.job_identifier}-checkpoint-*.ckpt"))
            if ck:
                raise _not_ported(f"loading the job's checkpoint ({ck})",
                                  "queue 1 item 4, checkpoint reader")

    # ------------------------------------------------------------- inference
    def predict_block_on_device(self, block_n: np.ndarray,
                                overlap: Optional[Sequence[float]] = None,
                                padding: Optional[Sequence[int]] = None,
                                norm_stats=None) -> Optional[np.ndarray]:
        """Whole-block sliding-window inference on the workflow's device:
        the block is uploaded once, the patch grid runs the model (bf16
        weights and activations under TEST.REDUCE_MEMORY) and blended cores
        accumulate in place; one result comes back. Returns None when the
        device path does not apply (test-time augmentation).

        ``norm_stats`` (a ``compute_norm_stats`` dict) moves normalisation
        onto the device: the RAW block ships (uint8 at 1 byte/voxel) and
        ``(clip(x, lo, hi) - sub) / div`` runs there in float32 before the
        cast to the compute dtype — ``normalize_image``'s transform."""
        if self.cfg.TEST.AUGMENTATION:
            return None
        self._ensure_model_for_test()
        cfg = self.cfg
        chans = self.output_channels
        reduce_mem = bool(cfg.TEST.REDUCE_MEMORY)
        # eval mode: running statistics, no dropout, no buffer is written
        # (a train step leaves the model in training mode)
        self.model.eval()
        model = copy.deepcopy(self.model).to(torch.bfloat16) if reduce_mem else self.model
        acts = self.activations

        def apply_fn(x):
            if reduce_mem:
                x = x.to(torch.bfloat16)
            return apply_activations(model(x).float(), acts, chans, training=False)

        bs = max(int(cfg.TRAIN.BATCH_SIZE), 1)
        patch = tuple(cfg.DATA.PATCH_SIZE)[: self.nd]
        ov = tuple(overlap) if overlap is not None else tuple(cfg.DATA.TEST.OVERLAP)
        pad = tuple(padding) if padding is not None else tuple(cfg.DATA.TEST.PADDING)
        quant = bool(cfg.TEST.OUTPUT_QUANT_UINT8)
        out_dt = torch.bfloat16 if reduce_mem else torch.float32
        pad_mode = "median" if cfg.DATA.TEST.MEDIAN_PADDING else "reflect"
        vol_dt = torch.bfloat16 if reduce_mem else torch.float32
        with torch.inference_mode():
            blk = torch.from_numpy(np.ascontiguousarray(block_n)).to(self.device)
            if norm_stats is not None:
                c = block_n.shape[-1]
                lo, hi, sub, div = (torch.as_tensor(np.broadcast_to(
                    np.asarray(a, np.float32), (c,)).copy(), device=self.device)
                    for a in stats_to_affine(norm_stats))
                x = torch.clamp(blk.float(), lo, hi)
                x = ((x - sub) / div).to(vol_dt)
            else:
                x = blk.to(vol_dt)
            out = sliding_window_inference(
                apply_fn, x, patch, ov, pad, out_channels=sum(chans), batch_size=bs,
                out_dtype=out_dt, pad_mode=pad_mode, quant_uint8=quant)
            return out.float().cpu().numpy()

    def process_test_sample(self, img: np.ndarray, gt: Optional[np.ndarray], fname: str,
                            sample=None):
        """Sliding-window inference on one image, on the device path."""
        cfg = self.cfg
        if cfg.TEST.REUSE_PREDICTIONS:
            raise _not_ported("TEST.REUSE_PREDICTIONS")
        if cfg.DATA.TEST.ROI_MASK.ENABLE:
            raise _not_ported("DATA.TEST.ROI_MASK")
        ov = tuple(cfg.DATA.TEST.OVERLAP)
        pad = tuple(cfg.DATA.TEST.PADDING)
        # stats from the raw bytes; the device normalises (uint8 ships at
        # 1 byte/voxel)
        stats = compute_norm_stats(img, self.test_norm_spec)
        # one card: the JAX package's multi-chip z-slabbing does not apply
        merged = self.predict_block_on_device(img, overlap=ov, padding=pad, norm_stats=stats)
        if merged is None:
            raise _not_ported("test-time augmentation (the host crop/merge path)")
        m = self.metric_calculation(merged, gt) if gt is not None else {}
        if m:
            self.metrics_per_test_file.append(m)
            if self.verbose:
                print(f"  {fname}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
        self.after_merge_patches(merged, sample, fname)
        self._predictions.append({"role": "raw", "pred": merged, "file": fname, "metrics": m})
        return {"pred": merged}

    def test(self, image: Optional[np.ndarray] = None, gt: Optional[np.ndarray] = None):
        """Inference on an in-memory image (the ``predict()`` surface)."""
        self._predictions = []
        self.metrics_per_test_file = []
        self._ensure_model_for_test()
        if image is None:
            raise _not_ported("reading test data from disk (TEST with DATA.TEST.PATH)",
                              "queue 1 items 1 and 5")
        if self.save_to_disk:
            raise _not_ported("writing test results to disk")
        ds = prepare_in_memory_test_data(image, gt, self.is_3d)
        if self.verbose:
            print("###############\n#  INFERENCE  #\n###############")
            print(f"Processing {len(ds.sample_list)} test images")
        for i, s in enumerate(ds.sample_list):
            self.process_test_sample(s.img, s.gt, f"pred_{i}.tif", s)
        self.after_all_images()
        self.print_stats()

    def print_stats(self):
        """Aggregate and print the per-image metrics."""
        if not self.metrics_per_test_file:
            return None
        keys = self.metrics_per_test_file[0].keys()
        agg = {k: float(np.mean([m[k] for m in self.metrics_per_test_file])) for k in keys}
        for k, v in agg.items():
            print(f"Test {k} (per image): {v:.6f}")
        self.stats = agg
        return agg
