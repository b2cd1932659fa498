"""Training charts and the U-Net border weight map, copied from the JAX
package's ``utils/util.py`` (``create_plots``, reference analog:
biapy/utils/util.py:37; ``unet_weight_map``, the instance workflow's 'We'
channel).

matplotlib is optional: where it is missing, the charts are skipped with one
line and the per-epoch JSON log (``LOG.LOG_DIR``) keeps the same numbers.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def create_plots(history: List[Dict], out_dir: str, job_identifier: str) -> None:
    """Loss/metric training charts (reference: util.py:37)."""
    if not history:
        return
    try:
        import matplotlib
    except ImportError:
        print(f"Training charts skipped: matplotlib is not installed (the numbers are in the "
              f"job's {job_identifier}_train.jsonl)")
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    epochs = [h.get("epoch", i) for i, h in enumerate(history)]
    keys = sorted({k for h in history for k in h
                   if isinstance(h.get(k), (int, float)) and k not in ("epoch", "time", "lr")})
    # pair train/val series of the same metric
    bases = sorted({k[4:] if k.startswith("val_") else k for k in keys})
    for base in bases:
        fig, ax = plt.subplots(figsize=(6, 4))
        if base in keys:
            ax.plot(epochs, [h.get(base, np.nan) for h in history], label=f"train {base}")
        if ("val_" + base) in keys:
            ax.plot(epochs, [h.get("val_" + base, np.nan) for h in history], label=f"val {base}")
        ax.set_xlabel("epoch")
        ax.set_ylabel(base)
        ax.legend()
        ax.set_title(f"{job_identifier}: {base}")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{job_identifier}_{base}.png"), dpi=100)
        plt.close(fig)


def unet_weight_map(mask: np.ndarray, w0: float = 10.0, sigma: float = 5.0) -> np.ndarray:
    """U-Net border weight map (reference: util.py:199; Ronneberger 2015):
    emphasises pixels between close instances via the two nearest instance
    distances."""
    from scipy import ndimage

    from biapy_tpu_torch.native import connected_components

    labels, n = connected_components(mask > 0)
    if n < 2:
        return np.ones(mask.shape, np.float32)
    dists = []
    for lab in range(1, n + 1):
        from biapy_tpu_torch.data.pre_processing import _edt
        dists.append(_edt(labels != lab))
    d = np.sort(np.stack(dists), axis=0)
    w = w0 * np.exp(-((d[0] + d[1]) ** 2) / (2 * sigma**2))
    return (1.0 + w * (mask == 0)).astype(np.float32)
