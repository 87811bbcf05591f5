"""Dataset interface (counterpart of ``nerfstyle_tpu/data/base.py``).

Host-side numpy only; the renderer moves poses to its device.  The
path-based loading template of the JAX base class serves the LLFF and Replica
loaders, which the port does not have yet.
"""

from __future__ import annotations

from abc import ABC
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..config import DatasetConfig
from ..core.types import BBox, DatasetSplit, Intrinsics


class BaseDataset(ABC):
    cfg: DatasetConfig
    split: DatasetSplit
    fns: List[str]
    images: Optional[np.ndarray]  # [N, 3, H, W] float32
    poses: np.ndarray  # [N, 4, 4] float32
    bbox: BBox
    intr: Intrinsics
    seg_groups: Optional[np.ndarray]  # [N, H, W] float32 (train split only)
    num_classes: int
    has_gt: bool

    def __getitem__(self, index: int):
        """(image [C(+1), H, W] or None, pose [4, 4]); the segment map rides
        as an extra channel on the train split."""
        if self.seg_groups is not None:
            seg = self.seg_groups[index].astype(np.float32)
            return np.concatenate([self.images[index], seg[None]], axis=0), self.poses[index]
        if self.has_gt:
            return self.images[index], self.poses[index]
        return None, self.poses[index]

    def __len__(self):
        return len(self.poses)

    def iter_shuffled_indexed(self, seed: int = 0):
        """Endless ``(index, item)`` over the split, each pass in a new
        order of numpy's ``default_rng(seed)``: the JAX package's pose order
        exactly."""
        rng = np.random.default_rng(seed)
        while True:
            for i in rng.permutation(len(self)):
                yield int(i), self[int(i)]

    def __str__(self) -> str:
        split_str = ["train", "validation", "test"][self.split.value]
        return (
            f'{type(self).__name__} "{Path(self.cfg.root_path).stem}" '
            f"{split_str} split with {len(self)} entries"
        )
