"""Dataset interface and the path-based loading template (counterpart of
``nerfstyle_tpu/data/base.py``).

Host-side numpy only; the renderer moves poses to its device.  A loader
names its frames, poses, segment maps and intrinsics through four hooks;
:meth:`BaseDataset.__init__` loads them in the JAX package's order: pose
scale, frames (alpha to white), unique file names, contiguous class ids
(train split only), colour transfer, ``max_count`` subsampling, then
intrinsics and the bounding box.  ``SyntheticDataset`` keeps its own
``__init__``.
"""

from __future__ import annotations

from abc import ABC
from pathlib import Path
from typing import List, Optional

import numpy as np

from .. import utils
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

    def __init__(self, cfg: DatasetConfig, split: DatasetSplit,
                 max_count: Optional[int] = None):
        self.cfg = cfg
        self.split = split
        self.max_count = max_count
        if not Path(cfg.root_path).exists():
            raise FileNotFoundError(f'Root path "{cfg.root_path}" does not exist')

        self.poses = self._get_poses().astype(np.float32)
        if self.poses.ndim != 3 or self.poses.shape[1:] != (4, 4):
            raise ValueError(f"poses must be [N, 4, 4], got {self.poses.shape}")
        self.poses[:, :3, 3] *= cfg.scale

        # Frames, RGBA composited on white; file names made unique with the
        # parent directory's name when stems repeat.
        image_paths = self._get_image_paths()
        self.has_gt = image_paths is not None
        if self.has_gt:
            self.fns = [Path(p).stem for p in image_paths]
            if len(set(self.fns)) != len(self.fns):
                self.fns = [Path(p).parent.stem + "_" + Path(p).stem for p in image_paths]
            self.images = np.stack([utils.parse_rgb(p) for p in image_paths])
            if self.images.shape[1] == 4:
                rgb, alpha = self.images[:, :3], self.images[:, 3:]
                self.images = rgb * alpha + (1 - alpha)
            if len(self.images) != len(self.poses):
                raise ValueError(f"{len(self.images)} frames for {len(self.poses)} poses")
        else:
            self.images = None
            w = len(str(len(self)))
            self.fns = ["frame_{:0{w}d}".format(i, w=w) for i in range(len(self))]

        # Segment groups: train split only; ids contiguous from 0 (negative
        # ids are ignored pixels).
        self.seg_groups, self.num_classes = None, 0
        if split == DatasetSplit.TRAIN:
            self.seg_groups = self._get_seg_groups()
            if self.seg_groups is not None:
                unique = np.unique(self.seg_groups)
                if unique[0] < 0:
                    unique = unique[1:]
                self.num_classes = len(unique)
                if self.seg_groups.shape[-2:] != self.images.shape[-2:]:
                    raise ValueError(f"segment maps of {self.seg_groups.shape[-2:]} for frames "
                                     f"of {self.images.shape[-2:]}")
                if not np.all(unique == np.arange(self.num_classes)):
                    raise ValueError("segment group ids must be contiguous starting at 0")

        if cfg.ct_image is not None and self.images is not None:
            style = utils.parse_rgb(cfg.ct_image)
            transferred, _ = utils.match_colors_for_image_set(
                np.moveaxis(self.images, 1, -1), np.moveaxis(style, 0, -1))
            self.images = np.moveaxis(transferred, -1, 1)

        if self.max_count is not None and self.max_count < len(self):
            if self.max_count <= 0:
                raise ValueError(f'Invalid value for "max_count": {self.max_count}')
            ids = np.round(np.linspace(0, len(self), self.max_count + 1)[:-1]).astype(int)
            self.fns = [self.fns[i] for i in ids]
            self.poses = self.poses[ids]
            if self.has_gt:
                self.images = self.images[ids]
            if self.seg_groups is not None:
                self.seg_groups = self.seg_groups[ids]

        self.intr = self._get_intr()
        self.bbox = BBox.from_radius(cfg.bound)

    # ---- the loader's hooks ----

    def _get_image_paths(self) -> Optional[List[Path]]:
        """The split's frames, or None for a split of poses only."""
        raise NotImplementedError

    def _get_poses(self) -> np.ndarray:
        """[N, 4, 4] camera-to-world poses in the canonical convention."""
        raise NotImplementedError

    def _get_seg_groups(self) -> Optional[np.ndarray]:
        """[N, H, W] segment ids of the frames (``self.fns``), or None."""
        return None

    def _get_intr(self) -> Intrinsics:
        raise NotImplementedError

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


def load_seg_maps(seg_dir: Path, fns: List[str]) -> Optional[np.ndarray]:
    """[N, H, W] float32 from ``<seg_dir>/<fn>_seg.npz`` (key ``seg_map``),
    or None unless every frame has one."""
    paths = [Path(seg_dir) / f"{fn}_seg.npz" for fn in fns]
    if not all(p.exists() for p in paths):
        return None
    maps = []
    for p in paths:
        with np.load(p) as z:
            maps.append(z["seg_map"])
    return np.stack(maps).astype(np.float32)
