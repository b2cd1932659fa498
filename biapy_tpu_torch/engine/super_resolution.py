"""Super-resolution workflow.

Counterpart of ``biapy_tpu/engine/super_resolution.py``: per-axis
upscaling factor paired through the data layer (LR input crops, HR GT
crops), MAE loss by default, PSNR/SSIM evaluation. The model's
upsampling (``MODEL.UNET_SR_UPSAMPLE_POSITION``) is built by
``models/__init__.py::build_model``; the test pass takes the host
crop/merge path with the output scaled.
"""

from __future__ import annotations

from biapy_tpu_torch.engine import metrics as M
from biapy_tpu_torch.engine.base_workflow import Base_Workflow


class Super_resolution_Workflow(Base_Workflow):
    def define_activations_and_channels(self):
        cfg = self.cfg
        out_c = int(cfg.DATA.PATCH_SIZE[-1])
        self.output_channels = [out_c]
        self.activations = ["linear"]
        self.output_channel_info = ["image"]
        self.y_upscaling = [int(u) for u in cfg.PROBLEM.SUPER_RESOLUTION.UPSCALING]

        self.gt_as_image = True

    def define_metrics(self):
        self.loss = M.restoration_loss(self.cfg.LOSS.TYPE, self.cfg.LOSS.WEIGHTS,
                                       "super-resolution")
        self.train_metrics = M.build_restoration_train_metrics(self.cfg.TRAIN.METRICS)

    def metric_calculation(self, pred, gt):
        return self.restoration_metric_calculation(pred, gt)
