"""Self-supervised pretraining workflow.

Counterpart of ``biapy_tpu/engine/self_supervised.py`` for the ``crappify``
pretext task: the input is degraded (downsample by RESIZING_FACTOR +
gaussian noise) and the model restores the original, with any SR-style
loss. ``crappify`` is a verbatim copy (numpy and scipy, the same draws from
the sample's rng). The ``masking`` pretext needs the MAE model (ROADMAP
queue 1 item 10) and raises.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from biapy_tpu_torch.engine import metrics as M
from biapy_tpu_torch.engine.base_workflow import Base_Workflow, _not_ported


def crappify(img: np.ndarray, resizing_factor: float, noise_level: float,
             rng: np.random.Generator) -> np.ndarray:
    """Downsample + gaussian noise degradation (reference:
    pre_processing.py:3390 crappify): each axis shrinks by
    sqrt(resizing_factor) (a straight 1/factor per axis was a much harder
    4x-fewer-pixels task in 2D), and the noise is added to the FULL-RES
    image before downsampling, with std = noise_level * max(img) (reference
    add_gaussian_noise:3494), not a post-downsample relative std."""
    nd = img.ndim - 1
    if noise_level > 0:
        # std = noise_level * max (reference add_gaussian_noise:3494);
        # guard for normalized data whose max can be <= 0 (zmuv dark patch)
        std = noise_level * max(abs(float(img.max())), 1e-6)
        img = img + rng.normal(0, std, img.shape)
    shrink = 1.0 / np.sqrt(resizing_factor)
    zoom = [shrink] * nd + [1.0]
    small = ndimage.zoom(img, zoom, order=1)
    back = ndimage.zoom(small, [img.shape[d] / small.shape[d] for d in range(img.ndim)], order=1)
    return back.astype(np.float32)


class Self_supervised_Workflow(Base_Workflow):
    def define_activations_and_channels(self):
        self.pretext = self.cfg.PROBLEM.SELF_SUPERVISED.PRETEXT_TASK
        if self.pretext == "masking":
            raise _not_ported("the self-supervised 'masking' pretext (the MAE model)",
                              "queue 1 item 10, rest of the zoo")
        out_c = int(self.cfg.DATA.PATCH_SIZE[-1])
        self.output_channels = [out_c]
        self.activations = ["linear"]
        self.output_channel_info = ["image"]

        self.gt_as_image = True

    def define_metrics(self):
        # the same SR-style loss family the reference SSL workflow accepts —
        # an unknown type must error, not silently become MAE
        self.loss = M.restoration_loss(self.cfg.LOSS.TYPE, self.cfg.LOSS.WEIGHTS,
                                       "SSL crappify")
        self.train_metrics = {"psnr": M.psnr_metric}

    def prepare_targets_fn(self):
        s = self.cfg.PROBLEM.SELF_SUPERVISED

        def target_fn(img, gt, rng):
            return crappify(img, float(s.RESIZING_FACTOR), float(s.NOISE), rng), img

        return target_fn

    def metric_calculation(self, pred, gt):
        return self.restoration_metric_calculation(pred, gt)
