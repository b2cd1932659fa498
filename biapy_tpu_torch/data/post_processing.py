"""Post-processing of predictions, copied from the JAX package's
``data/post_processing.py``: ``apply_median_filter``
(``TEST.POST_PROCESSING.MEDIAN_FILTER``). The instance post-processing in
that module needs the native host ops and comes with the instance workflow
(ROADMAP queue 1 item 9).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage


def apply_median_filter(img: np.ndarray, axes: Sequence[str], sizes: Sequence[int]) -> np.ndarray:
    """Axis-restricted median filtering (reference: post_processing.py:1218,
    TEST.POST_PROCESSING.MEDIAN_FILTER)."""
    out = img
    for axis_spec, s in zip(axes, sizes):
        size = [1] * out.ndim
        spec = axis_spec.lower()
        nd = out.ndim - 1  # channels-last
        ax_map = {"z": 0, "y": nd - 2, "x": nd - 1} if nd == 3 else {"y": 0, "x": 1}
        for a in spec:
            if a in ax_map:
                size[ax_map[a]] = s
        out = ndimage.median_filter(out, size=tuple(size))
    return out
