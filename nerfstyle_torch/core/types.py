"""Shared primitive types (counterpart of ``nerfstyle_tpu/core/types.py``).

Static camera metadata stays a frozen dataclass of Python values; per-batch
data (rays, bounding box) are NamedTuples of tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class DatasetSplit(Enum):
    TRAIN = 0
    VAL = 1
    TEST = 2


@dataclass(frozen=True)
class Intrinsics:
    """Pinhole camera intrinsics."""

    h: int
    w: int
    fx: float
    fy: float
    cx: float
    cy: float

    def __post_init__(self):
        for name, tp in (("h", int), ("w", int), ("fx", float), ("fy", float),
                         ("cx", float), ("cy", float)):
            object.__setattr__(self, name, tp(getattr(self, name)))

    @classmethod
    def from_np(cls, intr_np: np.ndarray, dims: Optional[Tuple[int, int]] = None) -> "Intrinsics":
        if intr_np.shape != (4, 4):
            raise ValueError(f"intrinsics matrix must be 4x4, got {intr_np.shape}")
        cx, cy = intr_np[0, 2], intr_np[1, 2]
        fx, fy = intr_np[0, 0], intr_np[1, 1]
        h, w = (int(cy * 2), int(cx * 2)) if dims is None else dims
        return cls(h, w, fx, fy, cx, cy)

    def size(self) -> Tuple[int, int]:
        return self.w, self.h

    @property
    def num_pixels(self) -> int:
        return self.h * self.w

    def scale(self, w: int, h: int) -> "Intrinsics":
        """Rescale to new dims; focal rescaled by the shorter-edge ratio."""
        old_ar = self.w / self.h
        new_ar = w / h
        ratio = h / self.h if new_ar >= old_ar else w / self.w
        return Intrinsics(h, w, self.fx * ratio, self.fy * ratio, w / 2.0, h / 2.0)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


class RayBundle(NamedTuple):
    """A batch of N rays; ``dirs`` are unit-normalized by :func:`make_rays`."""

    origins: torch.Tensor  # [N, 3]
    dirs: torch.Tensor  # [N, 3]

    def __len__(self):
        return self.dirs.shape[0]


def make_rays(origins: torch.Tensor, dirs: torch.Tensor) -> RayBundle:
    """Tile a single origin and unit-normalize the directions."""
    if origins.dim() == 1:
        origins = origins.expand(dirs.shape).contiguous()
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return RayBundle(origins, dirs)


class BBox(NamedTuple):
    """Axis-aligned scene bounding box."""

    min_pt: torch.Tensor  # [3]
    max_pt: torch.Tensor  # [3]

    @classmethod
    def from_radius(cls, radius: float, device=None) -> "BBox":
        r = torch.full((3,), float(radius), dtype=torch.float32, device=device)
        return cls(-r, r)

    @property
    def size(self) -> torch.Tensor:
        return self.max_pt - self.min_pt

    def to(self, device) -> "BBox":
        return BBox(self.min_pt.to(device), self.max_pt.to(device))

    def normalize(self, pts: torch.Tensor) -> torch.Tensor:
        """Map coordinates so min_pt -> 0 and max_pt -> 1."""
        return (pts - self.min_pt) / self.size
