"""Semantic segmentation workflow.

Counterpart of ``biapy_tpu/engine/semantic_seg.py``: one head, sigmoid
(binary) or softmax (multi-class); CE / Dice / CE+Dice losses (LOSS.TYPE)
and the IoU train metric; foreground IoU per image at test time;
``TEST.POST_PROCESSING.MEDIAN_FILTER`` on each prediction (and on the stack
of 2D predictions with ``TEST.ANALIZE_2D_IMGS_AS_3D_STACK``); the binarised
prediction written per image (two classes).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import numpy as np

from biapy_tpu_torch.data.io import save_tif
from biapy_tpu_torch.data.post_processing import apply_median_filter
from biapy_tpu_torch.engine import metrics as M
from biapy_tpu_torch.engine.base_workflow import Base_Workflow, _not_ported


class Semantic_Segmentation_Workflow(Base_Workflow):
    def define_activations_and_channels(self):
        cfg = self.cfg
        self.n_classes = max(int(cfg.DATA.N_CLASSES), 2)
        if self.n_classes > 2:
            self.output_channels = [self.n_classes]
            self.activations = ["ce_softmax"]
        else:
            self.output_channels = [1]
            self.activations = ["ce_sigmoid"]
        self.output_channel_info = ["semantic mask"]

    def define_metrics(self):
        cfg = self.cfg
        # Empty LOSS.TYPE selects the workflow default: CE for semantic seg
        ltype = (cfg.LOSS.TYPE or "CE").upper()
        rebalance = cfg.LOSS.CLASS_REBALANCE
        cweights = list(cfg.LOSS.CLASS_WEIGHTS) if cfg.LOSS.CLASS_WEIGHTS else None
        ignore = int(cfg.LOSS.IGNORE_INDEX) if cfg.LOSS.IGNORE_INDEX != -1 else None
        n_classes = max(int(cfg.DATA.N_CLASSES), 2)
        if ltype == "CE":
            self.loss = partial(M.cross_entropy_loss, num_classes=n_classes,
                                class_rebalance=rebalance, class_weights=cweights,
                                ignore_index=ignore)
        elif ltype == "DICE":
            self.loss = lambda out, y: M.dice_loss(out["pred"] if isinstance(out, dict) else out,
                                                   y)
        elif ltype in ("W_CE_DICE", "DICE_CE", "CE_DICE"):
            w = list(cfg.LOSS.WEIGHTS) if cfg.LOSS.WEIGHTS else [0.5, 0.5]
            self.loss = partial(M.dice_ce_loss, num_classes=n_classes, w_ce=w[0], w_dice=w[1],
                                class_rebalance=rebalance, class_weights=cweights,
                                ignore_index=ignore)
        else:
            raise ValueError(f"Unsupported LOSS.TYPE for semantic seg: {cfg.LOSS.TYPE}")
        if cfg.LOSS.CONTRAST.ENABLE:
            raise _not_ported("LOSS.CONTRAST (pixel-contrastive co-training)",
                              "queue 1 item 9, other workflows")
        self.train_metrics = {
            "iou": partial(M.jaccard_index, num_classes=n_classes, ignore_index=ignore),
        }

    def metric_calculation(self, pred: np.ndarray, gt: Optional[np.ndarray]) -> Dict[str, float]:
        if gt is None:
            return {}
        gtb = (gt > 0.5).astype(np.float32) if self.n_classes <= 2 else gt
        if self.n_classes > 2 and pred.shape[-1] > 1:
            lab = np.argmax(pred, axis=-1)
            g = gtb[..., 0].astype(np.int64)
            # foreground IoU: all non-background classes vs background
            p_fg, g_fg = lab > 0, g > 0
            union = np.count_nonzero(p_fg | g_fg)
            iou = 1.0 if union == 0 else np.count_nonzero(p_fg & g_fg) / union
        else:
            iou = M.jaccard_index_numpy(gtb, pred[..., :1])
        return {"iou": float(iou)}

    def after_merge_patches(self, pred, sample, fname):
        cfg = self.cfg
        pp = cfg.TEST.POST_PROCESSING
        if pp.MEDIAN_FILTER and not (cfg.TEST.ANALIZE_2D_IMGS_AS_3D_STACK and not self.is_3d):
            pred = apply_median_filter(pred, [str(a) for a in pp.MEDIAN_FILTER_AXIS],
                                       [int(s) for s in pp.MEDIAN_FILTER_SIZE])
        if self.save_to_disk and cfg.DATA.N_CLASSES <= 2:
            binar = (pred > 0.5).astype(np.uint8)
            save_tif(binar[None], cfg.PATHS.RESULT_DIR.PER_IMAGE_BIN, [fname], verbose=False)

    def after_all_images(self):
        """2D predictions analysed as one 3D stack, with optional z-median
        filtering (reference: TEST.ANALIZE_2D_IMGS_AS_3D_STACK +
        POST_PROCESSING.MEDIAN_FILTER; run_checks Test1)."""
        cfg = self.cfg
        if not cfg.TEST.ANALIZE_2D_IMGS_AS_3D_STACK or self.is_3d:
            return
        raws = [p for p in self._predictions if p.get("role") == "raw"]
        if not raws:
            return
        try:
            stack = np.stack([p["pred"] for p in raws], axis=0)
        except ValueError:
            return  # ragged shapes: nothing to stack
        pp = cfg.TEST.POST_PROCESSING
        if pp.MEDIAN_FILTER:
            stack = apply_median_filter(stack, [str(a) for a in pp.MEDIAN_FILTER_AXIS],
                                        [int(s) for s in pp.MEDIAN_FILTER_SIZE])
        self._predictions.append({"role": "as_3d_stack", "pred": stack})
        if self.save_to_disk:
            save_tif(stack[None], cfg.PATHS.RESULT_DIR.AS_3D_STACK, ["stack.tif"], verbose=False)
