"""Style images (counterpart of ``nerfstyle_tpu/data/style.py``).

``SingleImage`` is the one style image of a run, resized to the train
frames' longer edge and cycled forever.  ``WikiartDataset`` is the
multi-style corpus (dormant in the reference: no entry point reads it, as
in the JAX package): random square crops of its JPEGs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from .. import utils
from ..core.types import DatasetSplit
from ..imageio.jpeg import read_jpeg


class SingleImage:
    def __init__(self, image_path: Path, longer_edge: Optional[int] = None):
        self.image_name = Path(image_path).name
        self.style_image = utils.parse_rgb(image_path, size=longer_edge)  # [C, H, W]

    def __getitem__(self, _):
        return self.style_image

    def __len__(self):
        return 1

    def __str__(self) -> str:
        return f'single style image "{self.image_name}"'


class WikiartDataset:
    """Multi-style training corpus: random square crops of 40-60% of an
    image's area, resized to ``crop_size``, in [C, H, W] float32 (the JAX
    package's class, with its listing, its ``np.random.default_rng(seed)``
    draws in the same order and its crop; the resize is the port's
    PIL-equivalent bicubic, within 1/255 of PIL's)."""

    def __init__(
        self,
        root_path: str,
        split: DatasetSplit,
        max_images: Optional[int] = 100,
        fix_id: Optional[int] = None,
        crop_size: int = 256,
        seed: int = 0,
    ):
        self.root_dir = Path(root_path)
        self.split = split
        self.paths = sorted((self.root_dir / split.name.lower()).glob("*.jpg"))
        if max_images is not None:
            self.paths = self.paths[:max_images]
        self.fix_id = fix_id
        self.crop_size = crop_size
        self._rng = np.random.default_rng(seed)

    def __getitem__(self, index: int) -> np.ndarray:
        if self.fix_id is not None:
            index = self.fix_id
        img = read_jpeg(self.paths[index])
        if img.shape[-1] == 1:  # gray -> RGB, as PIL's convert("RGB")
            img = np.repeat(img, 3, axis=-1)
        h, w = img.shape[:2]
        scale = self._rng.uniform(0.4, 0.6)
        side = min(int(round((scale * w * h) ** 0.5)), w, h)
        x0 = int(self._rng.integers(0, max(1, w - side + 1)))
        y0 = int(self._rng.integers(0, max(1, h - side + 1)))
        crop = img[y0:y0 + side, x0:x0 + side]
        crop = utils._resize_bicubic(crop, (self.crop_size, self.crop_size))
        return np.moveaxis(crop.astype(np.float32) / 255.0, -1, 0)

    def __len__(self):
        return 1 if self.fix_id is not None else len(self.paths)

    def __str__(self) -> str:
        split_str = ["train", "validation", "test"][self.split.value]
        return f"WikiartDataset {split_str} split with {len(self)} entries"
