"""Classification workflow.

Counterpart of ``biapy_tpu/engine/classification.py``: image-level labels
from per-class sub-directories (sorted), DATA.PREPROCESS (resize) and a
centre crop / reflect pad to the patch, softmax cross-entropy on the
logits, accuracy (and top-5 accuracy above five classes), its own epoch
loop (the best checkpoint only, on ``val_loss``; a JSON log; early
stopping; ``val_stats``), and a test pass of one image per call with
per-image normalisation, ``predictions.csv`` (``filename,class``), the
accuracy and, in verbose mode, the confusion matrix. Test-time outputs are
the softmax probabilities. The port runs the classifiers ``simple_cnn``
and ``vit`` in 3D and 2D and ``efficientnet_b0``-``b7`` in 2D (whose head
returns ``{"class": logits}``: the loss, the metrics and inference read
the logits from either form); the other classifiers raise naming the
ROADMAP item.

With DATA.VAL.CROSS_VAL the fold is the contiguous slice of the shuffled
indices (``data_manipulation.py::split_train_val``), as in the JAX
workflow, which never asks for its stratified split.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from biapy_tpu_torch.data.data_manipulation import split_train_val
from biapy_tpu_torch.data.dataset import BiaPyDataset, DataSample, DatasetFile
from biapy_tpu_torch.data.generators import BatchLoader, PairDataset
from biapy_tpu_torch.data.io import list_image_files, read_img_as_ndarray
from biapy_tpu_torch.data.norm import normalize_image
from biapy_tpu_torch.data.pre_processing import preprocess_image
from biapy_tpu_torch.engine import metrics as M
from biapy_tpu_torch.engine.base_workflow import Base_Workflow, _not_ported
from biapy_tpu_torch.engine.train_engine import (make_eval_step, make_train_step,
                                                  resolve_mixed_precision)
from biapy_tpu_torch.models import EFFICIENTNETS
from biapy_tpu_torch.utils.callbacks import EarlyStopping
from biapy_tpu_torch.utils.misc import JsonLogger


def _fit_to_patch(img: np.ndarray, patch: tuple) -> np.ndarray:
    """Centre-crop or reflect-pad each spatial axis to the patch size (the
    odd voxel of a crop or a pad goes after)."""
    nd = len(patch)
    if tuple(img.shape[:nd]) == tuple(patch):
        return img
    out = img
    for d in range(nd):
        diff = out.shape[d] - patch[d]
        if diff > 0:
            lo = diff // 2
            out = out[tuple([slice(None)] * d + [slice(lo, lo + patch[d])])]
        elif diff < 0:
            pad = [(0, 0)] * out.ndim
            pad[d] = (-diff // 2, -diff - (-diff // 2))
            out = np.pad(out, pad, mode="reflect")
    return out


def load_classification_dataset(path: str, is_3d: bool, in_memory: bool = True,
                                expected_classes: Optional[int] = None,
                                preprocess_cfg=None,
                                patch_size: Optional[tuple] = None) -> BiaPyDataset:
    """One sample per image of each class folder under ``path`` (folders
    sorted by name give the class numbers); ``preprocess_cfg`` applies
    DATA.PREPROCESS and ``patch_size`` fits each sample to the model input."""
    class_dirs = sorted(d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d)))
    if expected_classes and len(class_dirs) != expected_classes:
        raise ValueError(
            f"Found {len(class_dirs)} class folders in {path} but DATA.N_CLASSES={expected_classes}"
        )
    ds = BiaPyDataset()
    for ci, cname in enumerate(class_dirs):
        for p in list_image_files(os.path.join(path, cname)):
            img = read_img_as_ndarray(p, is_3d=is_3d) if in_memory else None
            if img is not None:
                if preprocess_cfg is not None:
                    img = preprocess_image(preprocess_cfg, img, is_2d=not is_3d)
                if patch_size is not None:
                    img = _fit_to_patch(img, tuple(patch_size))
            ds.dataset_info.append(DatasetFile(path=p, shape=img.shape if img is not None else None,
                                               class_num=ci, class_name=cname))
            ds.sample_list.append(DataSample(fid=len(ds.dataset_info) - 1, img=img))
    if not ds.sample_list:
        raise FileNotFoundError(f"No class-organised images found in {path}")
    return ds


class _ClassifDataset(PairDataset):
    """PairDataset yielding (image, class number): per-image normalisation,
    augmentation without a mask, the label ``[class_num]`` as float32."""

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        img, _ = self._load(idx)
        f = self.ds.dataset_info[self.ds.sample_list[idx].fid]
        img, _ = normalize_image(img, self.norm_spec, stats=f.norm_stats)
        if self.aug is not None:
            img, _ = self.aug(img, None, rng)
        return {"x": np.ascontiguousarray(img, dtype=np.float32),
                "y": np.asarray([f.class_num], dtype=np.float32)}


def _logits(out):
    """The logits of a classifier that returns them (simple_cnn, vit) or a
    ``{"class": logits}`` dict (EfficientNet), as the JAX workflow reads
    either."""
    return out["class"] if isinstance(out, dict) else out


class Classification_Workflow(Base_Workflow):
    def define_activations_and_channels(self):
        arch = str(self.cfg.MODEL.ARCHITECTURE).lower()
        if arch not in ("simple_cnn", "vit") + EFFICIENTNETS:
            raise _not_ported(f"the classifier '{arch}'", "queue 1 item 10, rest of the zoo")
        self.n_classes = max(int(self.cfg.DATA.N_CLASSES), 2)
        self.output_channels = [self.n_classes]
        # the JAX workflow keeps the head linear and takes the softmax in its
        # predict function; here the inference activation does it
        self.activations = ["softmax"]
        self.output_channel_info = ["class"]

    def define_metrics(self):
        self.loss = lambda out, y: M.softmax_ce_with_logits(_logits(out), y)
        self.train_metrics = {"accuracy": lambda out, y: M.accuracy_metric(_logits(out), y)}
        if self.n_classes > 5:
            self.train_metrics["top_5_accuracy"] = lambda out, y: M.top_k_accuracy(
                _logits(out), y.to(torch.int64), 5)

    # -- data -----------------------------------------------------------------
    def _build_loaders(self):
        cfg = self.cfg
        patch = tuple(cfg.DATA.PATCH_SIZE)[: self.nd]
        train_ds = load_classification_dataset(
            cfg.DATA.TRAIN.PATH, self.is_3d,
            in_memory=bool(cfg.DATA.TRAIN.IN_MEMORY),
            expected_classes=self.n_classes,
            preprocess_cfg=cfg.DATA.PREPROCESS if cfg.DATA.PREPROCESS.TRAIN else None,
            patch_size=patch)
        if not cfg.DATA.VAL.FROM_TRAIN:
            val_ds = load_classification_dataset(
                cfg.DATA.VAL.PATH, self.is_3d,
                preprocess_cfg=cfg.DATA.PREPROCESS if cfg.DATA.PREPROCESS.VAL else None,
                patch_size=patch)
        else:
            train_ds, val_ds = split_train_val(
                train_ds, float(cfg.DATA.VAL.SPLIT_TRAIN), seed=cfg.SYSTEM.SEED,
                cross_val=bool(cfg.DATA.VAL.CROSS_VAL),
                cross_val_nsplits=int(cfg.DATA.VAL.CROSS_VAL_NFOLD),
                cross_val_fold=int(cfg.DATA.VAL.CROSS_VAL_FOLD))
        return (_ClassifDataset(train_ds, cfg, self.norm_spec, augment=True,
                                n_classes=self.n_classes),
                _ClassifDataset(val_ds, cfg, self.norm_spec, augment=False,
                                n_classes=self.n_classes))

    def train(self):
        """The JAX workflow's loop: a best checkpoint on ``val_loss`` only,
        each epoch's record in the JSON log, early stopping on ``val_loss``;
        the model stays as the last epoch left it. The validation metrics
        are plain means over the loader's padded batches."""
        cfg = self.cfg
        self.train_data, self.val_data = self._build_loaders()
        bs = int(cfg.TRAIN.BATCH_SIZE)
        seed = int(cfg.SYSTEM.SEED)
        self.train_loader = BatchLoader(self.train_data, bs, shuffle=True, seed=seed)
        val_loader = BatchLoader(self.val_data, bs, shuffle=False, seed=seed)
        self._steps_per_epoch = len(self.train_loader)
        if self.verbose:
            print(f"Train samples: {len(self.train_data)}, val samples: {len(self.val_data)}, "
                  f"batch: {bs} on {self.device}")
        self.prepare_model()
        train_step = make_train_step(
            self.loss, self.train_metrics,
            mixed_precision=resolve_mixed_precision(cfg.TRAIN.MIXED_PRECISION, self.device))
        eval_step = make_eval_step(self.loss, self.train_metrics)
        early = EarlyStopping(patience=int(cfg.TRAIN.PATIENCE)) if cfg.TRAIN.PATIENCE >= 0 else None
        jsonlog = JsonLogger(os.path.join(cfg.LOG.LOG_DIR, f"{self.job_identifier}_train.jsonl"))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        best_val = float("inf")
        self.history: List[Dict[str, float]] = []
        self.profiler = self.make_profiler()
        record: Dict[str, float] = {}
        for epoch in range(self.start_epoch, int(cfg.TRAIN.EPOCHS)):
            t0 = time.time()
            logger = self.train_one_epoch(train_step, epoch, gen)
            # the JAX workflow's log holds the step's metrics, no learning rate
            record = {"epoch": epoch, **{k: m.global_avg for k, m in logger.meters.items()
                                         if k != "lr"}}
            vals: Dict[str, List[float]] = {}
            for batch in val_loader:
                for k, v in eval_step(self.state, self._to_device(batch)).items():
                    vals.setdefault(k, []).append(float(v))
            record.update({("val_" + k): float(np.mean(v)) for k, v in vals.items()})
            if record.get("val_loss", np.inf) < best_val:
                best_val = record["val_loss"]
                self.save_checkpoint(epoch, metric="best")
            record["time"] = time.time() - t0
            jsonlog.write(record)
            self.history.append(record)
            if self.verbose:
                print(f"Epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in record.items()
                                                    if isinstance(v, float)))
            if early is not None and early(record.get("val_loss", np.inf)):
                break
        self.profiler.stop()
        self.val_stats = {k: v for k, v in record.items() if isinstance(v, (int, float))}

    # -- test -----------------------------------------------------------------
    def test(self, image: Optional[np.ndarray] = None, gt=None):
        """Every image of DATA.TEST.PATH's class folders, or one in-memory
        image (``gt`` its class number), normalised on its own statistics and
        predicted alone; ``_predictions`` holds each image's probabilities."""
        from biapy_tpu_torch.data.io import ensure_channels_last

        cfg = self.cfg
        self._predictions = []
        if image is not None:
            imgs = [ensure_channels_last(np.asarray(image), self.nd)]
            labels = [int(gt) if gt is not None else -1]
            names = ["in_memory"]
        else:
            ds = load_classification_dataset(
                cfg.DATA.TEST.PATH, self.is_3d,
                preprocess_cfg=cfg.DATA.PREPROCESS if cfg.DATA.PREPROCESS.TEST else None,
                patch_size=tuple(cfg.DATA.PATCH_SIZE)[: self.nd])
            imgs, labels, names = [], [], []
            for s in ds.sample_list:
                f = ds.dataset_info[s.fid]
                imgs.append(s.img if s.img is not None else read_img_as_ndarray(f.path, self.is_3d))
                labels.append(f.class_num if cfg.DATA.TEST.LOAD_GT else -1)
                names.append(os.path.basename(f.path))
        preds = []
        with self.inference_pass():
            for img, name in zip(imgs, names):
                x, _ = normalize_image(img, self.norm_spec)
                out = self.predict_patches(x[None])
                preds.append(int(np.argmax(out[0])))
                self._predictions.append({"role": "class", "pred": out[0], "file": name})
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        if (labels >= 0).any():
            mask = labels >= 0
            acc = float((preds[mask] == labels[mask]).mean())
            self.stats = {"accuracy": acc}
            if self.verbose:
                print(f"Test accuracy: {acc:.6f}")
                n = self.n_classes
                conf = np.zeros((n, n), dtype=int)
                for p, lab in zip(preds[mask], labels[mask]):
                    conf[lab, p] += 1
                print("Confusion matrix (rows=true):")
                print(conf)
        if self.save_to_disk:
            import csv

            os.makedirs(cfg.PATHS.RESULT_DIR.PATH, exist_ok=True)
            with open(os.path.join(cfg.PATHS.RESULT_DIR.PATH, "predictions.csv"), "w",
                      newline="") as f:
                w = csv.writer(f)
                w.writerow(["filename", "class"])
                for nme, p in zip(names, preds):
                    w.writerow([nme, int(p)])
