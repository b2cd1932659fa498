"""In-memory test data for the Python ``predict()`` API, copied from the
JAX package's ``data/data_manipulation.py`` (``prepare_in_memory_test_data``).
The directory loaders of that module are not part of the serving slice yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from biapy_tpu_torch.data.dataset import BiaPyDataset, DataSample, DatasetFile


def prepare_in_memory_test_data(image: np.ndarray, gt: Optional[np.ndarray], is_3d: bool) -> BiaPyDataset:
    """Wrap an in-memory array for the Python predict() API (reference:
    prepare_in_memory_test_data, data_manipulation.py:1086)."""
    from biapy_tpu_torch.data.io import ensure_channels_last

    img = ensure_channels_last(np.asarray(image), 3 if is_3d else 2)
    g = ensure_channels_last(np.asarray(gt), 3 if is_3d else 2) if gt is not None else None
    ds = BiaPyDataset()
    ds.dataset_info.append(DatasetFile(path="<in_memory>", shape=img.shape))
    ds.sample_list.append(DataSample(fid=0, coords=None, img=img, gt=g))
    return ds
