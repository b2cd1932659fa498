"""Metadata-first dataset model.

Reference analog: biapy/data/dataset.py (DatasetFile:48, DataSample:179,
PatchCoords:333, BiaPyDataset:476). A dataset is a list of files plus a flat
list of samples; each sample points at its file and carries the patch
coordinates, and optionally the in-memory pixels when DATA.*.IN_MEMORY.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from biapy_tpu_torch.data.patching import PatchCoords


@dataclass
class DatasetFile:
    """One source image (and optionally its ground truth)."""

    path: str
    shape: Optional[tuple] = None          # channels-last spatial+C shape
    gt_path: Optional[str] = None
    gt_shape: Optional[tuple] = None
    norm_stats: Optional[Dict[str, Any]] = None  # per-image normalization stats
    class_num: int = -1                     # classification label (folder-derived)
    class_name: str = ""
    input_axes: Optional[str] = None        # Zarr/H5 axes order, e.g. "ZYXC"
    gt_input_axes: Optional[str] = None
    data_path: Optional[str] = None         # internal path for Zarr/H5 groups
    gt_data_path: Optional[str] = None


@dataclass
class DataSample:
    """One training/eval sample: a patch of one file."""

    fid: int                                  # index into BiaPyDataset.dataset_info
    coords: Optional[PatchCoords] = None      # None => whole image
    img: Optional[np.ndarray] = None          # loaded pixels when in-memory
    gt: Optional[np.ndarray] = None
    path_in_zarr: Optional[str] = None

    def get_shape(self):
        return self.coords.shape if self.coords else (self.img.shape if self.img is not None else None)


@dataclass
class BiaPyDataset:
    """Files + samples (reference: dataset.py:476)."""

    dataset_info: List[DatasetFile] = field(default_factory=list)
    sample_list: List[DataSample] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.sample_list)

    def file_of(self, sample: DataSample) -> DatasetFile:
        return self.dataset_info[sample.fid]

    def clean_samples(self) -> None:
        """Drop in-memory pixels (keep metadata)."""
        for s in self.sample_list:
            s.img = None
            s.gt = None
