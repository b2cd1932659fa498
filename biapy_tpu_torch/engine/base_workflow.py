"""Base workflow: the model and train state, the epoch loop, checkpoints and
inference.

Counterpart of ``biapy_tpu/engine/base_workflow.py``: ``apply_activations``,
``prepare_model`` (model, optimizer and ``TrainState``, which
``engine/train_engine.py::make_train_step`` advances; checkpoint loading and
resume), ``train`` (data from disk with pre-processing and augmentation,
the generator checks, the epoch loop with validation, the plateau
controller, early stopping, ``TRAIN.CHECKPOINT_MONITOR``, the JAX package's
``.ckpt`` checkpoints, the loggers, the best checkpoint reloaded at the
end), ``predict_block_on_device`` (whole-volume sliding-window inference on
the card, normalisation of the raw volume included), ``predict_patches``
(patch batches through the model on the card, with test-time augmentation
when TEST.AUGMENTATION is on), ``process_test_sample`` (the device path, or
the host crop/merge path under test-time augmentation; ROI masks;
TEST.REUSE_PREDICTIONS; the host path also under super-resolution, with the
output scaled), ``process_test_by_chunks`` (the by-chunks engine over
Zarr/N5/HDF5 volumes, ``engine/chunked.py``) and ``test`` from disk or from
an in-memory image. The restoration workflows' hooks (``y_upscaling``,
``gt_as_image``, ``prepare_targets_fn``, ``restoration_metric_calculation``)
are the JAX package's. LOG.PROFILE_STEPS traces training steps with
``torch.profiler`` (``StepProfiler``); in 2D, TEST.FULL_IMG predicts each
test image in one forward. A model with a class head returns a dict
(``{"pred", "class"}``): the losses take it whole, and inference flattens
it, the class channels after the others (``flat_outputs``). The contrastive
training branch and per-head optimizers are not ported yet (ROADMAP queue
1) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from abc import ABCMeta, abstractmethod
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from biapy_tpu_torch.data.data_manipulation import (load_and_prepare_test_data,
                                                     load_and_prepare_train_data,
                                                     prepare_in_memory_test_data)
from biapy_tpu_torch.data.generators import (BatchLoader, PairDataset,
                                             check_generator_consistence, save_aug_samples)
from biapy_tpu_torch.data.io import list_image_files, open_lazy, read_img_as_ndarray, save_tif
from biapy_tpu_torch.data.norm import (build_norm_dict, compute_norm_stats, normalize_image,
                                       stats_to_affine)
from biapy_tpu_torch.data.patching import (crop_data_with_overlap, extract_patch,
                                           merge_data_with_overlap)
from biapy_tpu_torch.data.pre_processing import preprocess_image
from biapy_tpu_torch.data.tta import ensemble_predictions
from biapy_tpu_torch.engine.chunked import ChunkedInference, dequant_pred
from biapy_tpu_torch.engine.schedulers import (PlateauController, build_multihead_optimizer,
                                                build_optimizer, load_optax_state_dict,
                                                optax_state_dict, set_learning_rate)
from biapy_tpu_torch.engine.train_engine import (TrainState, make_eval_step, make_train_step,
                                                  resolve_mixed_precision)
from biapy_tpu_torch.models import build_model
from biapy_tpu_torch.models.flax_import import apply_checkpoint_params, export_flax_variables
from biapy_tpu_torch.ops.stitch import sliding_window_inference
from biapy_tpu_torch.parallel import barrier, is_main_process, process_count, process_index
from biapy_tpu_torch.utils.callbacks import EarlyStopping
from biapy_tpu_torch.utils.misc import (JsonLogger, MetricLogger, TensorboardLogger,
                                        get_checkpoint_path, load_checkpoint, save_model,
                                        set_seed)


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


def flat_outputs(out) -> torch.Tensor:
    """A model's outputs as one channels-last tensor: a class head's
    channels (``{"pred": ..., "class": ...}``) travel after the others, so
    that the stitch, test-time augmentation and the by-chunks store see one
    array (the JAX package's ``_predict_fn``); a classifier's
    ``{"class": logits}`` is its logits."""
    if isinstance(out, dict):
        parts = [out[k] for k in ("pred", "class") if k in out]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return out


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to biapy_tpu_torch yet (ROADMAP: {item})")


class StepProfiler:
    """LOG.PROFILE_STEPS: a ``torch.profiler`` trace of the training steps
    3 to 2 + ``steps`` of the run (counted from 1, over epochs) written as
    ``<name>_trace.json`` (Chrome trace format) under ``out_dir``, the JAX
    package's xplane hook (``base_workflow.py:575-596``). ``before_step()``
    runs before each step; ``stop()`` ends a trace the run outlived."""

    def __init__(self, steps: int, out_dir: str, name: str, device: torch.device,
                 verbose: bool = True):
        self.steps, self.out_dir, self.name = int(steps), out_dir, name
        self.device, self.verbose = device, verbose
        self.seen = 0
        self.done = self.steps <= 0
        self.prof = None
        self.path: Optional[str] = None

    def before_step(self) -> None:
        if self.done:
            return
        self.seen += 1
        if self.seen == 3 and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        elif self.prof is not None and self.seen >= 3 + self.steps:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        self.path = os.path.join(self.out_dir, f"{self.name}_trace.json")
        self.prof.export_chrome_trace(self.path)
        self.prof, self.done = None, True
        if self.verbose:
            print(f"Profiler trace written to {self.path}")


class Base_Workflow(metaclass=ABCMeta):
    """Shared train-state and inference machinery; subclasses define
    channels/activations, losses, metrics and post-processing hooks."""

    def __init__(self, cfg, job_identifier: str = "job", verbose: bool = True,
                 device: Optional[torch.device] = None):
        self.cfg = cfg
        self.job_identifier = job_identifier
        self.verbose = verbose
        self.device = torch.device(device) if device is not None else torch.device("cuda:0")
        set_seed(int(cfg.SYSTEM.SEED))
        self.is_3d = cfg.PROBLEM.NDIM == "3D"
        self.nd = 3 if self.is_3d else 2
        self.norm_spec = build_norm_dict(cfg)
        self.test_norm_spec = dict(self.norm_spec)
        if bool(cfg.TEST.REDUCE_MEMORY):
            self.test_norm_spec["out_dtype"] = "bfloat16"
        self.y_upscaling = [1] * self.nd

        self.activations: List[str] = []
        self.output_channels: List[int] = []
        self.output_channel_info: List[str] = []
        # channels of each entry of ``activations`` at inference; None: one
        # entry per head (``output_channels``). The instance workflow applies
        # its activations channel by channel.
        self._act_channels: Optional[List[int]] = None
        # the instance workflows' train-time channel handler (data/tta.py)
        self.aug_channel_handler = None
        self.gt_as_image = False  # SR/I2I/SSL/denoising: the GT is an image, not a mask
        self.define_activations_and_channels()
        self.loss = None
        self.train_metrics: Dict[str, Any] = {}
        self.define_metrics()
        # the set-level TEST.METRICS of the image-target workflows need the
        # perceptual networks (the JAX package's engine/perceptual.py)
        if self.gt_as_image and {str(n).lower() for n in self.cfg.TEST.METRICS or []} & {
                "fid", "is", "lpips"}:
            raise _not_ported("TEST.METRICS fid / is / lpips", "queue 1 item 9.8, the GAN slice")

        self.model: Optional[torch.nn.Module] = None
        # the model of the current inference pass (inference_pass)
        self._pass_model: Optional[torch.nn.Module] = None
        self.state: Optional[TrainState] = None
        self.plateau: Optional[PlateauController] = None
        self.model_build_kwargs: Dict = {}
        self.start_epoch = 0
        self._predictions: List[Dict[str, Any]] = []
        # the test file being processed (per image or by chunks)
        self._current_test_file: Optional[str] = None
        self.save_to_disk = True
        self.metrics_per_test_file: List[Dict[str, float]] = []
        self.profiler: Optional[StepProfiler] = None

    # ---------------------------------------------------------------- hooks
    @abstractmethod
    def define_activations_and_channels(self):
        """Set self.activations / output_channels / output_channel_info."""

    @abstractmethod
    def define_metrics(self):
        """Set self.loss (callable) and self.train_metrics dict."""

    def prepare_targets_fn(self) -> Optional[Callable]:
        """Return target_fn(img, gt, rng) -> (x, y) for the generator."""
        return None

    def metric_calculation(self, pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
        return {}

    def restoration_metric_calculation(self, pred, gt) -> Dict[str, float]:
        """Shared per-image metrics for image-target workflows (SR / SSL /
        denoising / I2I): TEST.METRICS restoration metrics on the normalized
        GT (reference: check_configuration.py:1277 defaults psnr/mae/mse/ssim),
        SSIM on the workflow's device."""
        if gt is None:
            return {}
        from biapy_tpu_torch.engine.metrics import restoration_test_metrics

        g, _ = normalize_image(gt.astype("float32"), self.norm_spec)
        return restoration_test_metrics(pred, g, self.cfg.TEST.METRICS, device=self.device)

    def after_merge_patches(self, pred: np.ndarray, sample, fname: str) -> None:
        """Post-hook on the stitched prediction."""

    def after_all_images(self) -> None:
        """Post-hook after the whole test set."""

    def after_by_chunks_prediction(self, ci, raw_path: str, base: str) -> None:
        """Workflow hook after the raw-prediction Zarr exists (the instance
        workflow runs the tile watershed and merge here)."""

    def tta_spec(self):
        """Channel-semantics spec for TTA; None = all scalars. Instance seg
        overrides with its representation spec."""
        return None

    # ------------------------------------------------------------- model
    def prepare_model(self):
        """Build the model on the workflow's device, initialised from a
        ``torch.Generator`` seeded with SYSTEM.SEED, and the train state
        (step 0, the optimizer over the model's parameters, the plateau
        controller if the schedule has one); then, with MODEL.LOAD_CHECKPOINT,
        load the checkpoint's MODEL.ITEMS_TO_LOAD_FROM_CHECKPOINT (finetune or
        resume, reference: load_model_checkpoint, misc.py:516-660)."""
        if self.model is not None:
            return
        cfg = self.cfg
        gen = torch.Generator().manual_seed(int(cfg.SYSTEM.SEED))
        model, self.model_build_kwargs = build_model(
            cfg, self.output_channels, self.output_channel_info, self.activations, gen=gen)
        self.model = model.to(self.device).eval()
        if self.verbose:
            n = sum(p.numel() for p in self.model.parameters())
            print(f"Model: {cfg.MODEL.ARCHITECTURE} — {n:,} parameters")
        steps_per_epoch = max(1, getattr(self, "_steps_per_epoch", 100))
        n_declared = max(len(cfg.TRAIN.OPTIMIZER), len(cfg.TRAIN.LR))
        if n_declared > 1 and len(self.output_channels) > 1:
            build_multihead_optimizer()
        optimizer, self.plateau = build_optimizer(cfg, steps_per_epoch,
                                                  self.model.named_parameters())
        self.state = TrainState(step=0, model=self.model, optimizer=optimizer,
                                plateau=self.plateau)
        if not cfg.MODEL.LOAD_CHECKPOINT:
            return
        path = get_checkpoint_path(cfg, self.job_identifier)
        if not (path and os.path.exists(path)):
            if self.verbose:
                print("No checkpoint found to load")
            return
        ck = load_checkpoint(path)
        items = list(cfg.MODEL.ITEMS_TO_LOAD_FROM_CHECKPOINT or ["weights"])
        if "weights" in items:
            apply_checkpoint_params(self.model, ck["params"], ck.get("batch_stats"),
                                    skip_unmatched=bool(cfg.MODEL.SKIP_UNMATCHED_LAYERS))
        if ("optimizer" in items or "opts" in items) and ck.get("opt_state"):
            try:
                load_optax_state_dict(optimizer, ck["opt_state"])
                if self.verbose:
                    print("Optimizer state loaded from checkpoint")
            except (KeyError, ValueError, TypeError) as e:
                if self.verbose:
                    print(f"Optimizer state in checkpoint incompatible, reinitialized ({e!r})")
        if "epoch" in items or cfg.MODEL.LOAD_CHECKPOINT_EPOCH == "last_on_train":
            # checkpoints record the COMPLETED epoch index, so resume starts
            # at the next one: a finished run resumes as a no-op
            self.start_epoch = int(ck.get("epoch", -1)) + 1
        if self.verbose:
            print(f"Loaded checkpoint {path} (epoch {self.start_epoch})")

    def save_checkpoint(self, epoch: int, metric: str = "", with_optimizer: bool = False) -> str:
        """Write the model (and the optimizer state) as a ``.ckpt`` of the JAX
        package's format under PATHS.CHECKPOINT."""
        params, batch_stats = export_flax_variables(self.model)
        return save_model(self.cfg, self.cfg.PATHS.CHECKPOINT, self.job_identifier, params,
                          epoch, batch_stats,
                          opt_state=optax_state_dict(self.state.optimizer) if with_optimizer
                          else None,
                          model_build_kwargs=self.model_build_kwargs, metric=metric)

    # ------------------------------------------------------------- training
    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A loader batch on the workflow's device: through pinned memory
        and without waiting for the copy on a CUDA device."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def prepare_train_generators(self):
        """The train and validation loaders from DATA.TRAIN / DATA.VAL
        (reference: prepare_train_generators); sets ``train_loader``,
        ``val_loader`` and the steps per epoch the schedules read."""
        cfg = self.cfg
        train_ds, val_ds = load_and_prepare_train_data(cfg, self.norm_spec, self.y_upscaling,
                                                       gt_as_image=self.gt_as_image)
        seed = int(cfg.SYSTEM.SEED)
        kw = dict(random_crop=bool(cfg.DATA.TRAIN.EXTRACT_RANDOM_PATCH),
                  n_classes=int(cfg.DATA.N_CLASSES), channel_handler=self.aug_channel_handler,
                  target_fn=self.prepare_targets_fn(), y_upscaling=self.y_upscaling,
                  gt_as_image=self.gt_as_image)
        self.train_data = PairDataset(train_ds, cfg, self.norm_spec, augment=True, **kw)
        self.val_data = PairDataset(val_ds, cfg, self.norm_spec, augment=False, **kw)
        bs = int(cfg.TRAIN.BATCH_SIZE)
        self.train_loader = BatchLoader(self.train_data, bs,
                                        num_workers=int(cfg.SYSTEM.NUM_WORKERS),
                                        shuffle=cfg.AUGMENTOR.SHUFFLE_TRAIN_DATA_EACH_EPOCH,
                                        seed=seed,
                                        replicate=max(1, int(cfg.DATA.TRAIN.REPLICATE or 0)))
        self.val_loader = BatchLoader(self.val_data, bs,
                                      shuffle=bool(cfg.AUGMENTOR.SHUFFLE_VAL_DATA_EACH_EPOCH),
                                      seed=seed)
        self._steps_per_epoch = len(self.train_loader)
        # runtime self-checks (reference: DATA.CHECK_GENERATORS dumps
        # generator output, generators/__init__.py:884; AUGMENTOR.AUG_SAMPLES
        # saves augmented examples, :404-412) — rank 0 only
        if is_main_process():
            if cfg.DATA.CHECK_GENERATORS and cfg.PATHS.GEN_CHECKS:
                check_generator_consistence(self.train_loader, cfg.PATHS.GEN_CHECKS,
                                            mask_dir=cfg.PATHS.GEN_MASK_CHECKS or None)
            if cfg.AUGMENTOR.ENABLE and cfg.AUGMENTOR.AUG_SAMPLES and cfg.PATHS.DA_SAMPLES:
                save_aug_samples(self.train_data, cfg.PATHS.DA_SAMPLES,
                                 n=int(cfg.AUGMENTOR.AUG_NUM_SAMPLES),
                                 draw_grid=bool(cfg.AUGMENTOR.DRAW_GRID))
        if self.verbose:
            print(f"Train samples: {len(self.train_data)}, val samples: {len(self.val_data)}, "
                  f"batch: {bs} on {self.device}")

    def train_one_epoch(self, train_step: Callable, epoch: int,
                        generator: Optional[torch.Generator] = None) -> MetricLogger:
        """One pass over ``train_loader`` (reference: train_one_epoch,
        train_engine.py:25). The metrics of a step are read on the host after
        the next step is queued, so the card does not wait for the host
        between steps."""
        self.train_loader.set_epoch(epoch)
        logger = MetricLogger(verbose=self.verbose)
        opt = self.state.optimizer
        pending = None
        for batch in logger.log_every(self.train_loader, 10, header=f"Epoch: [{epoch}]"):
            if self.profiler is not None:
                self.profiler.before_step()
            self.state, mtr = train_step(self.state, self._to_device(batch), generator)
            # the rate this update used, captured before the next one changes it
            mtr["lr"] = opt.state["lr"].clone()
            if pending is not None:
                logger.update(**{k: float(v) for k, v in pending.items()})
            pending = mtr
        if pending is not None:
            logger.update(**{k: float(v) for k, v in pending.items()})
        return logger

    def evaluate(self, eval_step: Callable) -> Dict[str, float]:
        """Validation metrics over ``val_loader`` in eval mode (running
        BatchNorm statistics). DATA.VAL.DIST_EVAL (reference:
        generators/__init__.py:489-503): True pads the ragged last batch with
        duplicates (the loader does); False evaluates its samples one by one,
        each repeated over the batch, and weights batches by true count."""
        bs = self.val_loader.batch_size
        n_full, n_rem = divmod(len(self.val_data), bs)
        dist_eval = bool(self.cfg.DATA.VAL.DIST_EVAL)
        vals: Dict[str, List[float]] = {}
        weights: List[float] = []

        def eval_one(b, weight):
            for k, v in eval_step(self.state, self._to_device(b)).items():
                vals.setdefault(k, []).append(float(v))
            weights.append(weight)

        for bi, batch in enumerate(self.val_loader):
            if not dist_eval and n_rem and bi == n_full:
                for j in range(n_rem):
                    eval_one({k: np.repeat(v[j:j + 1], bs, axis=0) for k, v in batch.items()},
                             1.0)
            else:
                eval_one(batch, float(bs))
        return {("val_" + k): float(np.average(v, weights=weights)) for k, v in vals.items()}

    def train(self):
        """The epoch loop (reference: base_workflow.py:1007; the JAX package's
        base_workflow.py:451-717)."""
        cfg = self.cfg
        if self.verbose:
            print("###########################\n#  PREPARE TRAINING DATA  #\n"
                  "###########################")
        self.prepare_train_generators()
        if self.verbose and bool(cfg.DATA.VAL.DIST_EVAL) and len(self.val_data) % int(
                cfg.TRAIN.BATCH_SIZE):
            print("Warning: Enabling distributed evaluation with an eval dataset not divisible "
                  "by the batch size. This will slightly alter validation results as extra "
                  "duplicate entries are added to fill the last batch. Set "
                  "DATA.VAL.DIST_EVAL=False for exact metrics.")
        self.prepare_model()
        train_step = make_train_step(
            self.loss, self.train_metrics,
            mixed_precision=resolve_mixed_precision(cfg.TRAIN.MIXED_PRECISION, self.device))
        eval_step = make_eval_step(self.loss, self.train_metrics)
        early = EarlyStopping(patience=int(cfg.TRAIN.PATIENCE)) if cfg.TRAIN.PATIENCE >= 0 else None
        jsonlog = JsonLogger(os.path.join(cfg.LOG.LOG_DIR, f"{self.job_identifier}_train.jsonl"))
        tb = TensorboardLogger(cfg.LOG.TENSORBOARD_LOG_DIR)
        gen = torch.Generator(device=self.device).manual_seed(int(cfg.SYSTEM.SEED))
        best_val = float("inf")
        self.history: List[Dict[str, float]] = []
        self.profiler = self.make_profiler()

        if self.verbose:
            print("#####################\n#  TRAIN THE MODEL  #\n#####################")
        for epoch in range(self.start_epoch, int(cfg.TRAIN.EPOCHS)):
            t0 = time.time()
            logger = self.train_one_epoch(train_step, epoch, gen)
            if not np.isfinite(logger.meters["loss"].global_avg):
                raise RuntimeError("Loss is NaN — stopping training "
                                   "(reference: train_engine.py:160)")
            record = {"epoch": epoch, **{k: m.global_avg for k, m in logger.meters.items()}}

            if len(self.val_data) > 0:
                val_metrics = self.evaluate(eval_step)
                record.update(val_metrics)
                val_loss = val_metrics["val_loss"]
                if self.plateau is not None:
                    set_learning_rate(self.state.optimizer, self.plateau.step(val_loss))
                # TRAIN.CHECKPOINT_MONITOR picks the best-checkpoint metric
                # (reference: config.py:1787); '*loss' minimizes, else maximizes
                monitor = str(cfg.TRAIN.CHECKPOINT_MONITOR or "val_loss")
                if not monitor.startswith("val_"):
                    monitor = "val_" + monitor
                if monitor in val_metrics:
                    mon_val = val_metrics[monitor]
                    score = mon_val if "loss" in monitor else -mon_val
                else:
                    # an absent metric falls back to the loss and must also
                    # MINIMIZE
                    if epoch == self.start_epoch and self.verbose:
                        print(f"WARNING: TRAIN.CHECKPOINT_MONITOR '{monitor}' is not among the "
                              f"validation metrics {sorted(val_metrics)}; monitoring val_loss")
                    score = val_loss
                if score < best_val:
                    best_val = score
                    self.save_checkpoint(epoch, metric="best")
                if early is not None and early(val_loss):
                    if self.verbose:
                        print(f"Early stopping at epoch {epoch}")
                    break
            freq = int(cfg.MODEL.SAVE_CKPT_FREQ)  # -1 => only best + final
            if (freq > 0 and (epoch + 1) % freq == 0) or epoch == cfg.TRAIN.EPOCHS - 1:
                self.save_checkpoint(epoch, with_optimizer=True)  # resume restores it
            record["time"] = time.time() - t0
            jsonlog.write(record)
            tb.update(step=epoch,
                      **{k: v for k, v in record.items() if isinstance(v, (int, float))})
            self.history.append(record)
            freq = int(cfg.LOG.CHART_CREATION_FREQ)
            if freq > 0 and ((epoch + 1) % freq == 0 or epoch == cfg.TRAIN.EPOCHS - 1):
                from biapy_tpu_torch.utils.util import create_plots

                create_plots(self.history, cfg.PATHS.CHARTS, self.job_identifier)
            if self.verbose:
                print(f"Epoch {epoch} done in {record['time']:.1f}s: "
                      + " ".join(f"{k}={v:.4f}" for k, v in record.items() if isinstance(v, float)))
        tb.close()
        self.profiler.stop()

        # reload the best checkpoint for testing (reference: :1244)
        best_path = os.path.join(cfg.PATHS.CHECKPOINT,
                                 f"{self.job_identifier}-checkpoint-best.ckpt")
        if os.path.exists(best_path):
            ck = load_checkpoint(best_path)
            apply_checkpoint_params(self.model, ck["params"], ck.get("batch_stats"))
            if self.verbose:
                print("Reloaded best checkpoint for testing")

    def make_profiler(self) -> StepProfiler:
        """The run's StepProfiler (inactive unless LOG.PROFILE_STEPS > 0)."""
        return StepProfiler(int(getattr(self.cfg.LOG, "PROFILE_STEPS", 0) or 0),
                            str(self.cfg.PATHS.PROFILER), self.job_identifier, self.device,
                            self.verbose)

    def _ensure_model_for_test(self):
        """The model for inference: the trained one, or a new one with the
        job's checkpoint (PATHS.CHECKPOINT_FILE or MODEL.LOAD_CHECKPOINT_EPOCH
        under PATHS.CHECKPOINT) loaded when there is one."""
        if self.state is not None:
            return
        self.prepare_model()
        if not self.cfg.MODEL.LOAD_CHECKPOINT:
            path = get_checkpoint_path(self.cfg, self.job_identifier)
            if path and os.path.exists(path):
                ck = load_checkpoint(path)
                apply_checkpoint_params(self.model, ck["params"], ck.get("batch_stats"))
                if self.verbose:
                    print(f"Loaded checkpoint {path} for inference")

    # ------------------------------------------------------------- inference
    @contextlib.contextmanager
    def inference_pass(self):
        """One inference pass (a ``test()``/``predict()`` call, or one
        by-chunks volume): the model the stitch runs is built once, at its
        start, and dropped at its end, since training updates the model in
        place and a copy kept across passes would go stale. That model is in
        eval mode (running statistics, no dropout, no buffer written; a
        train step leaves it in training mode), and a bf16 copy under
        TEST.REDUCE_MEMORY. A pass opened inside another reuses the outer
        one's model."""
        if self._pass_model is not None:
            yield
            return
        self._ensure_model_for_test()
        self.model.eval()
        self._pass_model = (copy.deepcopy(self.model).to(torch.bfloat16)
                            if bool(self.cfg.TEST.REDUCE_MEMORY) else self.model)
        try:
            yield
        finally:
            self._pass_model = None

    def predict_block_on_device(self, block_n, overlap: Optional[Sequence[float]] = None,
                                padding: Optional[Sequence[int]] = None, sync: bool = True,
                                norm_stats=None, pre_padded=False):
        """Whole-block sliding-window inference on the workflow's device,
        inside an ``inference_pass``: the block (a numpy array or a host
        tensor, pinned for an asynchronous copy) is uploaded once, the patch
        grid runs the pass's model (bf16 weights and activations under
        TEST.REDUCE_MEMORY) and blended cores accumulate in place. Returns
        the result as a float32 numpy array, or with ``sync=False`` the
        device tensor without waiting for it; None under test-time
        augmentation, which runs on the host crop/merge path
        (``predict_patches``).

        ``norm_stats`` (a ``compute_norm_stats`` dict) moves normalisation
        onto the device: the RAW block ships (uint8 at 1 byte/voxel) and
        ``(clip(x, lo, hi) - sub) / div`` runs there in float32 before the
        cast to the compute dtype — ``normalize_image``'s transform.
        ``pre_padded`` is ``sliding_window_inference``'s."""
        if self.cfg.TEST.AUGMENTATION:
            return None
        model = self._pass_model
        if model is None:
            raise RuntimeError("predict_block_on_device runs inside an inference pass: "
                               "`with workflow.inference_pass(): ...`")
        cfg = self.cfg
        chans = self._act_channels or self.output_channels
        reduce_mem = bool(cfg.TEST.REDUCE_MEMORY)
        acts = self.activations

        def apply_fn(x):
            if reduce_mem:
                x = x.to(torch.bfloat16)
            return apply_activations(flat_outputs(model(x)).float(), acts, chans,
                                     training=False)

        bs = max(int(cfg.TRAIN.BATCH_SIZE), 1)
        patch = tuple(cfg.DATA.PATCH_SIZE)[: self.nd]
        ov = tuple(overlap) if overlap is not None else tuple(cfg.DATA.TEST.OVERLAP)
        pad = tuple(padding) if padding is not None else tuple(cfg.DATA.TEST.PADDING)
        quant = bool(cfg.TEST.OUTPUT_QUANT_UINT8)
        out_dt = torch.bfloat16 if reduce_mem else torch.float32
        pad_mode = "median" if cfg.DATA.TEST.MEDIAN_PADDING else "reflect"
        vol_dt = torch.bfloat16 if reduce_mem else torch.float32
        with torch.inference_mode():
            blk = (block_n if isinstance(block_n, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(block_n)))
            blk = blk.to(self.device, non_blocking=True)
            if norm_stats is not None:
                c = blk.shape[-1]
                lo, hi, sub, div = (torch.as_tensor(np.broadcast_to(
                    np.asarray(a, np.float32), (c,)).copy(), device=self.device)
                    for a in stats_to_affine(norm_stats))
                x = torch.clamp(blk.float(), lo, hi)
                x = ((x - sub) / div).to(vol_dt)
            else:
                x = blk.to(vol_dt)
            out = sliding_window_inference(
                apply_fn, x, patch, ov, pad, out_channels=sum(self.output_channels),
                batch_size=bs,
                out_dtype=out_dt, pad_mode=pad_mode, pre_padded=pre_padded, quant_uint8=quant)
        if not sync:
            return out
        return out.float().cpu().numpy()

    def predict_patches(self, patches: np.ndarray) -> np.ndarray:
        """The pass's model over ``patches`` (n, *patch, c; normalised
        float32) in batches of TRAIN.BATCH_SIZE on the workflow's device,
        activations applied;
        float32 numpy out. With TEST.AUGMENTATION each patch is predicted in
        every orientation of TEST.AUGMENTATION_GROUP and the inverted
        predictions reduced by TEST.AUGMENTATION_MODE (``ensemble_predictions``).
        Runs inside an ``inference_pass`` (bf16 under TEST.REDUCE_MEMORY)."""
        model = self._pass_model
        if model is None:
            raise RuntimeError("predict_patches runs inside an inference pass: "
                               "`with workflow.inference_pass(): ...`")
        bs = max(int(self.cfg.TRAIN.BATCH_SIZE), 1)
        dt = torch.bfloat16 if bool(self.cfg.TEST.REDUCE_MEMORY) else torch.float32
        pin = self.device.type == "cuda"
        chans = self._act_channels or self.output_channels

        def run_batches(p):
            outs = []
            with torch.inference_mode():
                for i in range(0, len(p), bs):
                    x = torch.from_numpy(np.ascontiguousarray(p[i:i + bs], dtype=np.float32))
                    if pin:
                        x = x.pin_memory()
                    x = x.to(self.device, non_blocking=True).to(dt)
                    y = apply_activations(flat_outputs(model(x)).float(), self.activations,
                                          chans, training=False)
                    outs.append(y.cpu().numpy())
            return np.concatenate(outs, axis=0)

        if self.cfg.TEST.AUGMENTATION:
            # representation-aware TTA (reference: ensemble_predictions,
            # post_processing.py:1371; tta.py)
            mode = (self.cfg.TEST.AUGMENTATION_MODE or "mean").lower()
            return ensemble_predictions(run_batches, patches, spec=self.tta_spec(),
                                        ndim=self.nd, mode=mode,
                                        group_level=str(self.cfg.TEST.AUGMENTATION_GROUP or "full"))
        return run_batches(patches)

    def before_test_sample(self, img: np.ndarray, gt: Optional[np.ndarray], fname: str):
        """Workflow hook run before inference on one image (e.g. the Cellpose
        test-time diameter rescale, reference: workflow_utils/cellpose.py)."""
        return img, gt

    def post_merge_transform(self, pred: np.ndarray, fname: str) -> np.ndarray:
        """Workflow hook run on the merged prediction before metrics and
        instance creation (e.g. resizing Cellpose flows back to native)."""
        return pred

    def process_test_sample(self, img: np.ndarray, gt: Optional[np.ndarray], fname: str,
                            sample=None):
        """Sliding-window inference on one image (reference:
        process_test_sample, base_workflow.py:1840): on the device path, or
        under test-time augmentation on the host crop/merge path with the
        same normalisation statistics; then the ROI mask. With
        TEST.REUSE_PREDICTIONS the saved prediction is read back instead."""
        cfg = self.cfg
        if cfg.TEST.REUSE_PREDICTIONS:
            # Skip the model entirely: reload this image's saved prediction
            # and re-run only metrics + workflow post-processing (reference:
            # TEST.REUSE_PREDICTIONS, config.py:1861, base_workflow.py:1850) —
            # the recovery path for tweaking post-proc without re-predicting.
            prev = os.path.join(cfg.PATHS.RESULT_DIR.PER_IMAGE, fname)
            if not os.path.exists(prev):
                prev = os.path.join(cfg.PATHS.RESULT_DIR.FULL_IMAGE, fname)
            if not os.path.exists(prev):
                raise FileNotFoundError(
                    f"TEST.REUSE_PREDICTIONS: no saved prediction for '{fname}' under "
                    f"{cfg.PATHS.RESULT_DIR.PER_IMAGE} — run a prediction pass first")
            merged = read_img_as_ndarray(prev, is_3d=self.is_3d).astype(np.float32)
            m = self.metric_calculation(merged, gt) if gt is not None else {}
            if m:
                self.metrics_per_test_file.append(m)
                if self.verbose:
                    print(f"  {fname} (reused): " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
            self.after_merge_patches(merged, sample, fname)
            self._predictions.append({"role": "raw", "pred": merged, "file": fname, "metrics": m})
            return {"pred": merged}
        img, gt = self.before_test_sample(img, gt, fname)
        ov = tuple(cfg.DATA.TEST.OVERLAP)
        pad = tuple(cfg.DATA.TEST.PADDING)
        # stats from the raw bytes; the device normalises (uint8 ships at
        # 1 byte/voxel); the host path normalises with the same stats
        stats = compute_norm_stats(img, self.test_norm_spec)
        up = self.y_upscaling
        if cfg.TEST.FULL_IMG and not self.is_3d:
            return self._process_full_image(img, gt, fname, sample, stats)
        merged = None
        if all(u == 1 for u in up):
            # one card: the JAX package's multi-chip z-slabbing does not apply;
            # super-resolution takes the host crop/merge path, as in JAX
            merged = self.predict_block_on_device(img, overlap=ov, padding=pad,
                                                  norm_stats=stats)
        if merged is None:
            # float32 on the host; predict_patches casts to the pass's dtype
            img_n = normalize_image(img, dict(self.test_norm_spec, out_dtype="float32"),
                                    stats=stats)[0]
            patches, _ = crop_data_with_overlap(
                img_n[None], tuple(cfg.DATA.PATCH_SIZE), overlap=ov, padding=pad,
                pad_type="median" if cfg.DATA.TEST.MEDIAN_PADDING else "reflect")
            preds = self.predict_patches(patches)
            out_spatial = tuple(img.shape[d] * up[d] for d in range(self.nd))
            merged = merge_data_with_overlap(
                preds, (1,) + out_spatial + (preds.shape[-1],), overlap=ov,
                padding=tuple(p * u for p, u in zip(pad, up)))[0]
        merged = self.post_merge_transform(merged, fname)
        merged = self.apply_roi_mask(merged, fname)
        m = self.metric_calculation(merged, gt) if gt is not None else {}
        if m:
            self.metrics_per_test_file.append(m)
            if self.verbose:
                print(f"  {fname}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
        self.after_merge_patches(merged, sample, fname)
        self._predictions.append({"role": "raw", "pred": merged, "file": fname, "metrics": m})
        if self.save_to_disk and cfg.TEST.SAVE_MODEL_RAW_OUTPUT:
            # raw (pre-post-processing) output next to the final artifacts
            # (reference: TEST.SAVE_MODEL_RAW_OUTPUT, base_workflow.py:2113)
            save_tif(merged[None], cfg.PATHS.RESULT_DIR.PER_IMAGE, [fname], verbose=False)
        return {"pred": merged}

    def _process_full_image(self, img: np.ndarray, gt: Optional[np.ndarray], fname: str,
                            sample, stats):
        """TEST.FULL_IMG in 2D (the JAX package's ``base_workflow.py:1084-1104``):
        the normalised image reflect-padded at its end to a multiple of 64
        on each axis, one forward (``predict_patches``, with test-time
        augmentation when it is on), the output cropped to the image's
        extent (times the SR up-scaling), the ROI mask, the metrics and the
        hooks; written under RESULT_DIR.FULL_IMAGE."""
        cfg = self.cfg
        img_n = normalize_image(img, dict(self.test_norm_spec, out_dtype="float32"),
                                stats=stats)[0]
        mult = 64
        pads = [(0, (-img_n.shape[d]) % mult) for d in range(self.nd)] + [(0, 0)]
        full = np.pad(img_n, pads, mode="reflect") if any(p[1] for p in pads) else img_n
        pred = self.predict_patches(full[None])[0]
        up = self.y_upscaling
        pred = pred[tuple(slice(0, img.shape[d] * up[d]) for d in range(self.nd))]
        pred = self.post_merge_transform(pred, fname)
        merged = self.apply_roi_mask(pred, fname)
        m = self.metric_calculation(merged, gt) if gt is not None else {}
        if m:
            self.metrics_per_test_file.append(m)
        self.after_merge_patches(merged, sample, fname)
        self._predictions.append({"role": "raw", "pred": merged, "file": fname, "metrics": m})
        if self.save_to_disk:
            save_tif(merged[None], cfg.PATHS.RESULT_DIR.FULL_IMAGE, [fname], verbose=False)
        return {"pred": merged}

    def test(self, image: Optional[np.ndarray] = None, gt: Optional[np.ndarray] = None):
        """Inference on every image of DATA.TEST.PATH (or the validation split
        with DATA.TEST.USE_VAL_AS_TEST), by chunks with TEST.BY_CHUNKS, or on
        an in-memory image (the ``predict()`` surface); results written
        unless ``save_to_disk`` is off."""
        self._predictions = []
        self.metrics_per_test_file = []
        with self.inference_pass():
            if image is None and self.cfg.TEST.BY_CHUNKS.ENABLE and self.is_3d:
                self.process_test_by_chunks()
            else:
                self._test_images(image, gt)

    def _test_images(self, image: Optional[np.ndarray], gt: Optional[np.ndarray]):
        cfg = self.cfg
        if image is not None:
            ds = prepare_in_memory_test_data(image, gt, self.is_3d)
        elif cfg.DATA.TEST.USE_VAL_AS_TEST:
            # the held-out validation split (or cross-val fold) is the test
            # set (reference: DATA.TEST.USE_VAL_AS_TEST, base_workflow.py:1283)
            _, ds = load_and_prepare_train_data(cfg, self.norm_spec, self.y_upscaling,
                                                gt_as_image=self.gt_as_image)
            if self.verbose:
                print(f"Using the validation split as test set ({len(ds.sample_list)} samples)")
        else:
            ds = load_and_prepare_test_data(cfg, self.norm_spec,
                                            gt_as_image=self.gt_as_image)
        if self.verbose:
            print("###############\n#  INFERENCE  #\n###############")
            print(f"Processing {len(ds.sample_list)} test images")
        if not is_main_process():
            # the per-image path runs on rank 0 only (only by-chunks shares
            # inference out); concurrent ranks would race on the same files
            barrier("per_image_test")
            return
        for i, s in enumerate(ds.sample_list):
            f = ds.dataset_info[s.fid]
            img, g = s.img, s.gt
            if img is None:
                img = read_img_as_ndarray(f.path, is_3d=self.is_3d,
                                          data_path=f.data_path, axes_order=f.input_axes)
                if f.gt_path:
                    g = read_img_as_ndarray(f.gt_path, is_3d=self.is_3d,
                                            data_path=f.gt_data_path, axes_order=f.gt_input_axes)
                if cfg.DATA.PREPROCESS.TEST:
                    img = preprocess_image(cfg.DATA.PREPROCESS, img, is_2d=not self.is_3d)
                    if g is not None:
                        g = preprocess_image(cfg.DATA.PREPROCESS, g,
                                             is_mask=not self.gt_as_image,
                                             only_resize=True, is_2d=not self.is_3d)
                if s.coords is not None:  # patch sample (e.g. USE_VAL_AS_TEST)
                    img = extract_patch(img, s.coords)
                    if g is not None:
                        g = extract_patch(g, s.coords)
            fname = os.path.basename(f.path) if f.path != "<in_memory>" else f"pred_{i}.tif"
            if s.coords is not None:
                stem, ext = os.path.splitext(fname)
                fname = f"{stem}_sample{i}{ext or '.tif'}"
            # the source file, for the hooks that read it again (DET_WATERSHED
            # reads the raw image, synapses the CREMI annotations)
            self._current_test_file = f.path
            self.process_test_sample(img, g, fname, s)
        self.after_all_images()
        self.print_stats()
        barrier("per_image_test")  # pairs with the non-main early return

    def apply_roi_mask(self, pred: np.ndarray, fname: str) -> np.ndarray:
        """Restrict inference to a region-of-interest mask (reference:
        apply_roi_mask, base_workflow.py:1801; data/roi_mask.py): the
        prediction is zeroed outside the mask."""
        roi_cfg = self.cfg.DATA.TEST.ROI_MASK
        if not roi_cfg.ENABLE:
            return pred
        path = str(roi_cfg.PATH)
        candidates = list_image_files(path) if os.path.isdir(path) else [path]
        # patch samples carry a '_sample{i}' suffix — strip it for matching
        base = fname
        stem, ext = os.path.splitext(fname)
        if "_sample" in stem:
            base = stem.rsplit("_sample", 1)[0] + ext
        match = [c for c in candidates if os.path.basename(c) in (fname, base)]
        if not match and len(candidates) == 1:
            match = candidates  # a single mask file serves every volume
        if not match:
            # same rule as the by-chunks path: never silently apply an
            # arbitrary mask out of several candidates
            print(f"WARNING: no ROI mask named {base} in {path} and several "
                  "candidates exist — skipping the ROI for this image")
            return pred
        roi = read_img_as_ndarray(match[0], is_3d=self.is_3d)
        m = (roi[..., :1] > 0).astype(pred.dtype)
        if m.shape[: self.nd] != pred.shape[: self.nd]:
            from scipy import ndimage

            zoom = [pred.shape[d] / m.shape[d] for d in range(self.nd)] + [1.0]
            m = (ndimage.zoom(m, zoom, order=0) > 0).astype(pred.dtype)
        return pred * m

    def process_test_by_chunks(self):
        """Tile-streamed inference over Zarr/N5/HDF5 volumes (reference:
        process_test_sample_by_chunks, base_workflow.py:2469; the JAX
        package's base_workflow.py:1252-1317): one ``raw_pred.zarr`` per
        volume under ``PER_IMAGE/<name>_chunks/``, Z_START / Z_END sub-jobs,
        the ROI mask (tiles without an ROI voxel are skipped), the whole
        prediction as a TIFF with SAVE_OUT_TIF."""
        cfg = self.cfg
        bc = cfg.TEST.BY_CHUNKS
        files = list_image_files(cfg.DATA.TEST.PATH)
        out_ch = sum(self.output_channels)
        phases = [str(p) for p in bc.PHASES]
        data_path = (str(cfg.DATA.TEST.INPUT_ZARR_MULTIPLE_DATA_RAW_PATH) or None
                     if cfg.DATA.TEST.INPUT_ZARR_MULTIPLE_DATA else None)
        for f in files:
            self._current_test_file = f
            base = os.path.splitext(os.path.basename(f))[0]
            out_dir = os.path.join(cfg.PATHS.RESULT_DIR.PER_IMAGE, base + "_chunks")
            ci = ChunkedInference(
                self, tuple(cfg.DATA.PATCH_SIZE)[: self.nd], tuple(cfg.DATA.TEST.OVERLAP),
                tuple(cfg.DATA.TEST.PADDING), tuple(bc.WORKFLOW_PROCESS.PATCHES_PER_TILE),
                out_ch, out_dir, rank=process_index(), world=process_count(),
            )
            raw_path = os.path.join(out_dir, "raw_pred.zarr")
            if "prediction" in phases:
                roi = roi_handle = None
                roi_cfg = cfg.DATA.TEST.ROI_MASK
                if roi_cfg.ENABLE:
                    # by-chunks skips tiles with no ROI overlap instead of
                    # zeroing after the fact (reference: config.py:934)
                    rpath = str(roi_cfg.PATH)
                    cands = list_image_files(rpath) if os.path.isdir(rpath) else [rpath]
                    match = [c for c in cands if os.path.basename(c) == os.path.basename(f)]
                    if not match and len(cands) == 1:
                        match = cands  # a single mask file serves every volume
                    elif not match and cands:
                        print(f"WARNING: no ROI mask named {os.path.basename(f)} in {rpath} and "
                              "several candidates exist — skipping the ROI for this volume")
                    if match:
                        roi, roi_handle = open_lazy(match[0])
                ao = str(cfg.DATA.TEST.INPUT_IMG_AXES_ORDER) or None
                try:
                    raw_path = ci.predict_volume(
                        f, z_range=(int(bc.Z_START), int(bc.Z_END)), verbose=self.verbose,
                        data_path=data_path, roi=roi, axes_order=ao,
                        axes_order_is_default=(ao == "TZCYX"))
                finally:
                    if roi_handle is not None:
                        roi_handle.close()
                self.last_chunked = ci
                if bc.SAVE_OUT_TIF and is_main_process():
                    # whole-volume TIFF of the raw prediction (reference:
                    # TEST.BY_CHUNKS.SAVE_OUT_TIF, base_workflow.py:2581)
                    vol, handle = open_lazy(raw_path)
                    save_tif(dequant_pred(vol[:])[None], cfg.PATHS.RESULT_DIR.PER_IMAGE,
                             [base + ".tif"], verbose=False)
                    if handle is not None:
                        handle.close()
            self.after_by_chunks_prediction(ci, raw_path, base)
        self.after_all_images()
        self.print_stats()

    def print_stats(self):
        """Aggregate and print the per-image metrics; write them as a CSV
        (reference: print_stats :2307 and the metrics_per_test_file CSV,
        base_workflow.py:1534)."""
        if not self.metrics_per_test_file or not is_main_process():
            return None
        keys = self.metrics_per_test_file[0].keys()
        agg = {k: float(np.mean([m[k] for m in self.metrics_per_test_file])) for k in keys}
        for k, v in agg.items():
            print(f"Test {k} (per image): {v:.6f}")
        self.stats = agg
        if self.save_to_disk:
            import csv

            out = os.path.join(str(self.cfg.PATHS.RESULT_DIR.PATH),
                               f"{self.job_identifier}_per_image_metrics.csv")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=["image"] + list(keys))
                w.writeheader()
                files = [p.get("file", f"{i}") for i, p in enumerate(self._predictions)
                         if p.get("role") in ("raw",)]
                for i, m in enumerate(self.metrics_per_test_file):
                    w.writerow({"image": files[i] if i < len(files) else i, **m})
        return agg
