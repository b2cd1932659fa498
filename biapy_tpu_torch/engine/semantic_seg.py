"""Semantic segmentation workflow, inference subset.

Counterpart of ``biapy_tpu/engine/semantic_seg.py``: one head, sigmoid
(binary) or softmax (multi-class), foreground IoU per image at test time.
The training losses come with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

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
        if self.cfg.TEST.POST_PROCESSING.MEDIAN_FILTER:
            raise _not_ported("TEST.POST_PROCESSING.MEDIAN_FILTER")
