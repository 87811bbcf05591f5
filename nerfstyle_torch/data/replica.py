"""Replica indoor scenes in Semantic-NeRF's render layout (counterpart of
``nerfstyle_tpu/data/replica.py``)::

    <root>/<replica_cfg.name>/Sequence_<traj>/rgb/rgb_<i>.png
    <root>/<replica_cfg.name>/Sequence_<traj>/traj_w_c.txt   (N x 16 floats)
    <root>/<seg_name>/<fn>_seg.npz                           (optional)

The trajectories of ``replica_cfg.traj_ids`` are concatenated, frames in
numeric order; every 8th frame (from frame 0) is the test split.  Poses are
RDF cameras in an RFU world; ``focal_ratio`` gives the focal length as a
fraction of the longer side; ``black2white`` turns pure black pixels white.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from .. import utils
from ..config import DatasetConfig
from ..core.poses import convert_poses
from ..core.types import DatasetSplit, Intrinsics
from .base import BaseDataset, load_seg_maps

_SPLIT_EVERY = 8


class ReplicaDataset(BaseDataset):
    def __init__(self, cfg: DatasetConfig, split: DatasetSplit,
                 max_count: Optional[int] = None):
        if cfg.replica_cfg is None:
            raise ValueError("the Replica dataset needs replica_cfg")
        self.rcfg = cfg.replica_cfg
        scene_dir = Path(cfg.root_path) / self.rcfg.name

        paths: List[Path] = []
        poses: List[np.ndarray] = []
        for traj in self.rcfg.traj_ids:
            seq_dir = scene_dir / f"Sequence_{traj}"
            mats = np.loadtxt(seq_dir / "traj_w_c.txt").reshape(-1, 4, 4).astype(np.float32)
            rgb_paths = sorted((seq_dir / "rgb").glob("rgb_*.png"),
                               key=lambda p: int(p.stem.split("_")[-1]))
            if len(rgb_paths) != len(mats):
                raise ValueError(f"{seq_dir}: {len(rgb_paths)} frames for {len(mats)} poses")
            paths += rgb_paths
            poses.append(mats)
        all_poses = np.concatenate(poses)

        ids = utils.train_test_split(len(paths), _SPLIT_EVERY, split == DatasetSplit.TRAIN)
        self._image_paths = [paths[i] for i in ids]
        self._poses = convert_poses(all_poses[ids], w_coord="rfu", c_coord="rdf")

        super().__init__(cfg, split, max_count)

        if self.rcfg.black2white and self.images is not None:
            black = np.all(self.images < 1e-3, axis=1, keepdims=True)
            self.images = np.where(black, 1.0, self.images)

    def _get_image_paths(self) -> Optional[List[Path]]:
        return self._image_paths

    def _get_poses(self) -> np.ndarray:
        return self._poses

    def _get_seg_groups(self) -> Optional[np.ndarray]:
        return load_seg_maps(Path(self.cfg.root_path) / self.cfg.seg_name, self.fns)

    def _get_intr(self) -> Intrinsics:
        w, h = utils.png_size(self._image_paths[0])
        focal = max(w, h) * self.rcfg.focal_ratio
        return Intrinsics(h=h, w=w, fx=focal, fy=focal, cx=w / 2.0, cy=h / 2.0)
