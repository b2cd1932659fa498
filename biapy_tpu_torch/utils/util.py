"""Training charts, copied from the JAX package's ``utils/util.py``
(``create_plots``; reference analog: biapy/utils/util.py:37).

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
