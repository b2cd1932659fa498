"""Test-time metrics, copied from the JAX package's ``engine/metrics.py``
(``jaccard_index_numpy``). Training losses and metrics come with the
training slice.
"""

from __future__ import annotations

import numpy as np


def jaccard_index_numpy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Binary IoU on numpy arrays (reference: metrics.py:25)."""
    tp = np.count_nonzero((y_pred > 0.5) & (y_true > 0.5))
    fp = np.count_nonzero((y_pred > 0.5) & (y_true <= 0.5))
    fn = np.count_nonzero((y_pred <= 0.5) & (y_true > 0.5))
    denom = tp + fp + fn
    return 1.0 if denom == 0 else tp / denom
