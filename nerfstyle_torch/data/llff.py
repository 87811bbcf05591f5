"""LLFF dataset in torch-ngp's ``transforms_{split}.json`` layout
(counterpart of ``nerfstyle_tpu/data/llff.py``)::

    <root>/transforms_train.json   h, w, fl_x, fl_y, cx, cy and frames
                                   [{file_path, transform_matrix}]
    <root>/transforms_test.json    the test poses (no frames are read)
    <root>/<seg_name>/<fn>_seg.npz segment maps (key ``seg_map``), optional

Frames are 8-bit PNG (``images_8/*.png``) or ``.npy``; the test split has
poses only (``has_gt`` False).  The poses are used as written: their camera
flip is ``cfgs/renderer/llff.yaml``'s ``flip_camera``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..config import DatasetConfig
from ..core.types import DatasetSplit, Intrinsics
from .base import BaseDataset, load_seg_maps


class LLFFDataset(BaseDataset):
    def __init__(self, cfg: DatasetConfig, split: DatasetSplit,
                 max_count: Optional[int] = None):
        self.root = Path(cfg.root_path)
        with open(self.root / f"transforms_{split.name.lower()}.json") as f:
            self.split_json = json.load(f)
        super().__init__(cfg, split, max_count)

    def _get_image_paths(self) -> Optional[List[Path]]:
        if self.split == DatasetSplit.TEST:
            return None
        return [self.root / f["file_path"] for f in self.split_json["frames"]]

    def _get_seg_groups(self) -> Optional[np.ndarray]:
        return load_seg_maps(self.root / self.cfg.seg_name, self.fns)

    def _get_poses(self) -> np.ndarray:
        return np.array([f["transform_matrix"] for f in self.split_json["frames"]],
                        dtype=np.float32)

    def _get_intr(self) -> Intrinsics:
        j = self.split_json
        return Intrinsics(h=int(j["h"]), w=int(j["w"]), fx=j["fl_x"], fy=j["fl_y"],
                          cx=j["cx"], cy=j["cy"])
