"""Image-to-image translation workflow.

Counterpart of ``biapy_tpu/engine/image_to_image.py``: generic image
regression (e.g. stain translation), optional multi-head output
(PROBLEM.IMAGE_TO_IMAGE.CHANNELS_PER_HEAD_INFO, with one decoder per head
under SEPARATED_DECODERS_PER_HEAD), per-head activations, MAE/MSE/SSIM
losses, PSNR/SSIM evaluation.
"""

from __future__ import annotations

import numpy as np

from biapy_tpu_torch.data.norm import normalize_image
from biapy_tpu_torch.engine import metrics as M
from biapy_tpu_torch.engine.base_workflow import Base_Workflow


class Image_to_Image_Workflow(Base_Workflow):
    def define_activations_and_channels(self):
        i2i = self.cfg.PROBLEM.IMAGE_TO_IMAGE
        heads = list(i2i.CHANNELS_PER_HEAD_INFO) if i2i.CHANNELS_PER_HEAD_INFO else []
        if heads:
            self.output_channels = [int(h) for h in heads]
        else:
            self.output_channels = [int(i2i.OUTPUT_CHANNELS)]
        acts = list(i2i.OUTPUT_CHANNEL_ACT) if i2i.OUTPUT_CHANNEL_ACT else []
        self.activations = ([str(a).lower() for a in acts] if acts
                            else ["linear"] * len(self.output_channels))
        self.output_channel_info = [f"head{i}" for i in range(len(self.output_channels))]

        self.gt_as_image = True

    def define_metrics(self):
        self.loss = M.restoration_loss(self.cfg.LOSS.TYPE, self.cfg.LOSS.WEIGHTS,
                                       "image-to-image")
        self.train_metrics = M.build_restoration_train_metrics(self.cfg.TRAIN.METRICS)

    def prepare_targets_fn(self):
        # GT is a raw image: normalize it like the input rather than as a mask.
        spec = self.norm_spec

        def target_fn(img, gt, rng):
            if gt is not None and gt.max() > 1.5:
                gt, _ = normalize_image(gt.astype(np.float32), spec)
            return img, gt

        return target_fn

    def metric_calculation(self, pred, gt):
        # TEST.METRICS selects which restoration metrics to report
        # (reference: check_configuration.py:1277 defaults psnr/mae/mse/ssim)
        return self.restoration_metric_calculation(pred, gt)
