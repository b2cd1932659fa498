"""Denoising workflow (Noise2Void).

Counterpart of ``biapy_tpu/engine/denoising.py``: self-supervised
Noise2Void — a stratified subset of pixels is replaced by values drawn from
their neighbourhood (manipulators: uniform/normal/mean/median, with/without
the center pixel, optional struct-mask), and the loss is MSE restricted to
the manipulated pixels. ``n2v_manipulate`` and ``_manipulated_values`` are
verbatim copies (numpy, the same draws from the sample's rng). The
supervised GAN mode (``nafnet`` with PROBLEM.DENOISING.LOAD_GT_DATA) comes
with the GAN slice (ROADMAP queue 1 item 9.8) and raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from biapy_tpu_torch.engine import metrics as M
from biapy_tpu_torch.engine.base_workflow import Base_Workflow, _not_ported


def n2v_manipulate(
    img: np.ndarray,
    rng: np.random.Generator,
    perc_pix: float = 0.198,
    manipulator: str = "uniform_withCP",
    radius: int = 5,
    struct_mask: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stratified pixel manipulation (reference: denoising.py:499-1036).

    Returns (manipulated_img, target_values, mask) with channels-last shapes
    equal to ``img``; mask=1 where pixels were replaced.
    """
    spatial = img.shape[:-1]
    nd = len(spatial)
    out = img.copy()
    mask = np.zeros_like(img, dtype=np.float32)
    target = img.copy()

    # stratified sampling: one candidate per grid cell of size box
    # the reference uses round(sqrt(100/perc)) for BOTH 2D and 3D
    # (denoising.py:1013) — a cube-root 3D box manipulated ~2x more voxels
    box = max(2, int(round(np.sqrt(100.0 / perc_pix))))
    grids = [np.arange(0, s, box) for s in spatial]
    coords = np.meshgrid(*grids, indexing="ij")
    offsets = [rng.integers(0, box, c.shape) for c in coords]
    pix = [np.minimum(c + o, s - 1).reshape(-1) for c, o, s in zip(coords, offsets, spatial)]
    idx = tuple(pix)

    for c in range(img.shape[-1]):
        vals = _manipulated_values(img[..., c], idx, rng, manipulator, radius)
        out[..., c][idx] = vals
        mask[..., c][idx] = 1.0
    if struct_mask and nd >= 2:
        # structN2V blinds the +-4 x-neighbours IN THE INPUT with random
        # uniform values in [-2, 2) (reference apply_structN2Vmask,
        # denoising.py:915-980, default 1x11 mask with center/end zeros);
        # the LOSS mask stays at the manipulated centers. Extending the
        # loss mask instead (the old behavior) left the structured noise
        # visible and trained the identity at those pixels.
        w = spatial[nd - 1]
        for c in range(img.shape[-1]):
            for dx in (-4, -3, -2, -1, 1, 2, 3, 4):
                x = idx[nd - 1] + dx
                ok = (x >= 0) & (x < w)  # clip INSIDE bounds, never wrap or
                # collapse onto the center pixel
                if not ok.any():
                    continue
                nb = tuple(ax[ok] for ax in idx[: nd - 1]) + (x[ok],)
                out[..., c][nb] = rng.random(int(ok.sum())) * 4 - 2
    return out, target, mask


def _manipulated_values(ch: np.ndarray, idx, rng, manipulator: str, radius: int):
    n = len(idx[0])
    spatial = ch.shape
    nd = len(spatial)
    if manipulator.startswith("normal_additive"):
        return ch[idx] + rng.normal(0, ch.std(), n)
    # neighbourhood-based manipulators
    def sample_neigh():
        cols = []
        for d in range(nd):
            off = rng.integers(-radius, radius + 1, n)
            cols.append(np.clip(idx[d] + off, 0, spatial[d] - 1))
        return cols

    neigh_idx = sample_neigh()
    if "withoutCP" in manipulator:
        # resample coordinates that landed ON the center (after clipping!)
        # until every neighbour differs somewhere — the reference's
        # random_neighbor loop (denoising.py:551); forcing one axis off-zero
        # both skipped valid neighbours and let border clipping feed the
        # center value back in
        for _ in range(16):
            same = np.ones(n, bool)
            for d in range(nd):
                same &= neigh_idx[d] == idx[d]
            if not same.any():
                break
            redraw = sample_neigh()
            for d in range(nd):
                neigh_idx[d] = np.where(same, redraw[d], neigh_idx[d])
        else:
            for d in range(nd):  # guaranteed off-center fallback
                neigh_idx[d] = np.where(same & (idx[d] > 0), idx[d] - 1,
                                        np.where(same, idx[d] + 1, neigh_idx[d]))
                same &= neigh_idx[d] == idx[d]
    neigh_vals = ch[tuple(neigh_idx)]
    if manipulator.startswith(("uniform", "normal_withCP", "normal_withoutCP")):
        return neigh_vals
    if manipulator.startswith(("mean", "median")):
        # sample a small neighbourhood per pixel
        samples = [neigh_vals]
        for _ in range(4):
            alt = []
            for d in range(nd):
                off = rng.integers(-radius, radius + 1, n)
                alt.append(np.clip(idx[d] + off, 0, spatial[d] - 1))
            samples.append(ch[tuple(alt)])
        stack = np.stack(samples)
        return np.mean(stack, axis=0) if manipulator.startswith("mean") else np.median(stack, axis=0)
    return neigh_vals


class Denoising_Workflow(Base_Workflow):
    def define_activations_and_channels(self):
        if (str(self.cfg.MODEL.ARCHITECTURE).lower() == "nafnet"
                and bool(self.cfg.PROBLEM.DENOISING.LOAD_GT_DATA)):
            raise _not_ported("supervised GAN denoising (nafnet with "
                              "PROBLEM.DENOISING.LOAD_GT_DATA)", "queue 1 item 9.8, the GAN slice")
        out_c = int(self.cfg.DATA.PATCH_SIZE[-1])
        self.out_c = out_c
        self.output_channels = [out_c]
        self.activations = ["linear"]
        self.output_channel_info = ["image"]

        self.gt_as_image = True

    def define_metrics(self):
        c = int(self.cfg.DATA.PATCH_SIZE[-1])

        def loss(out, y):
            return M.n2v_loss_mse(out, y[..., :c], y[..., c:])

        self.loss = loss
        self.train_metrics = {}

    def prepare_targets_fn(self):
        d = self.cfg.PROBLEM.DENOISING

        def target_fn(img, gt, rng):
            manip, target, mask = n2v_manipulate(
                img, rng, perc_pix=float(d.N2V_PERC_PIX), manipulator=str(d.N2V_MANIPULATOR),
                radius=int(d.N2V_NEIGHBORHOOD_RADIUS), struct_mask=bool(d.N2V_STRUCTMASK),
            )
            return manip, np.concatenate([target, mask], axis=-1)

        return target_fn

    def metric_calculation(self, pred, gt):
        return self.restoration_metric_calculation(pred, gt)
