"""Shared primitive types (counterpart of ``nerfstyle_tpu/core/types.py``).

Static camera metadata (intrinsics, a 2D patch) stays a frozen dataclass of
Python values; per-batch data (rays, bounding boxes, a voxel map) are
NamedTuples of tensors.  :func:`warp_ndc`, :class:`RotatedBBox` and
:class:`VoxelOccupancyMap` are library API, as in JAX: no path of either
package calls them, and both renderers refuse ``use_ndc``.
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


class DatasetCoordSystem(Enum):
    RFU = 0  # X = right, Y = front, Z = up
    RDF = 1  # X = right, Y = down, Z = front


@dataclass(frozen=True)
class Box2D:
    """A 2D patch in pixel coordinates: columns ``x .. x + w``, rows ``y ..
    y + h``."""

    x: int
    y: int
    w: int
    h: int

    def wrange(self) -> slice:
        return slice(self.x, self.x + self.w)

    def hrange(self) -> slice:
        return slice(self.y, self.y + self.h)


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

    def lerp(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Points at parameter ``coeffs`` along each ray: [N] -> [N, 3],
        [N, K] -> [N, K, 3]."""
        if coeffs.dim() == 1:
            return self.origins + self.dirs * coeffs[:, None]
        return self.origins[:, None, :] + self.dirs[:, None, :] * coeffs[..., None]


def make_rays(origins: torch.Tensor, dirs: torch.Tensor) -> RayBundle:
    """Tile a single origin and unit-normalize the directions."""
    if origins.dim() == 1:
        origins = origins.expand(dirs.shape).contiguous()
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return RayBundle(origins, dirs)


def warp_ndc(rays: RayBundle, near: float, intr: Intrinsics) -> RayBundle:
    """Rays warped to normalized device coordinates (the forward-facing
    scene's NDC, origins moved to the plane ``z = -near`` first)."""
    o, d = rays.origins, rays.dirs
    t = -(near + o[:, 2]) / d[:, 2]
    ndc_o = o + t[:, None] * d
    w_tmp = -1.0 / (intr.w / (2.0 * intr.fx))
    h_tmp = -1.0 / (intr.h / (2.0 * intr.fy))
    new_origins = torch.stack([
        w_tmp * ndc_o[:, 0] / ndc_o[:, 2],
        h_tmp * ndc_o[:, 1] / ndc_o[:, 2],
        1.0 + 2.0 * near / ndc_o[:, 2],
    ], dim=-1)
    new_dirs = torch.stack([
        w_tmp * (d[:, 0] / d[:, 2] - ndc_o[:, 0] / ndc_o[:, 2]),
        h_tmp * (d[:, 1] / d[:, 2] - ndc_o[:, 1] / ndc_o[:, 2]),
        -2.0 * near / ndc_o[:, 2],
    ], dim=-1)
    return make_rays(new_origins, new_dirs)


class RotatedBBox(NamedTuple):
    """An oriented box by its 8 corners (top face v0-v3 clockwise, bottom
    face v4-v7 clockwise, v3 above v4) and its 6 faces' origins and
    normals; a point is inside when it lies on the inner side of every
    face."""

    pts: torch.Tensor  # [8, 3]
    face_origins: torch.Tensor  # [6, 3]
    face_normals: torch.Tensor  # [6, 3]

    @classmethod
    def from_corners(cls, pts: np.ndarray, device=None) -> "RotatedBBox":
        pts = np.asarray(pts)
        if pts.shape != (8, 3):
            raise ValueError(f"a rotated box takes [8, 3] corners, got {pts.shape}")
        faces = np.array([[0, 1, 2], [4, 3, 2], [5, 2, 1], [6, 1, 0], [7, 0, 3], [4, 5, 6]])
        p0, p1, p2 = pts[faces[:, 0]], pts[faces[:, 1]], pts[faces[:, 2]]
        normals = np.cross(p1 - p0, p2 - p0)
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        return cls(pts=as_t(pts), face_origins=as_t(p0), face_normals=as_t(normals))

    @property
    def min_pt(self) -> torch.Tensor:
        return self.pts.min(dim=0).values

    @property
    def max_pt(self) -> torch.Tensor:
        return self.pts.max(dim=0).values

    def contains(self, pts: torch.Tensor, outside: bool = False) -> torch.Tensor:
        """[N] bool: inside (every face's normal has a positive dot with the
        point's offset from the face), or with ``outside`` its complement
        up to points on a face (some dot <= 0)."""
        dots = torch.einsum("nfc,fc->nf", pts[:, None, :] - self.face_origins[None],
                            self.face_normals)
        if outside:
            return (dots <= 0).any(dim=-1)
        return (dots > 0).all(dim=-1)


class VoxelOccupancyMap(NamedTuple):
    """A boolean voxel map over an axis-aligned box, looked up by point; its
    flat grid ends in one False entry that every point outside the box
    reads."""

    grid_flat: torch.Tensor  # [res0 * res1 * res2 + 1] bool, the last False
    global_min_pt: torch.Tensor  # [3]
    global_max_pt: torch.Tensor  # [3]
    res: torch.Tensor  # [3] float

    @classmethod
    def from_dense(cls, grid: np.ndarray, min_pt, max_pt, device=None) -> "VoxelOccupancyMap":
        flat = np.append(np.asarray(grid).reshape(-1).astype(bool), False)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        return cls(grid_flat=torch.as_tensor(flat, device=device), global_min_pt=f32(min_pt),
                   global_max_pt=f32(max_pt), res=f32(np.asarray(grid).shape))

    @classmethod
    def load(cls, path, device=None) -> "VoxelOccupancyMap":
        """From an ``.npz`` of ``map``, ``global_min_pt`` and ``global_max_pt``."""
        data = np.load(path)
        return cls.from_dense(data["map"], data["global_min_pt"], data["global_max_pt"], device)

    @property
    def voxel_size(self) -> torch.Tensor:
        return (self.global_max_pt - self.global_min_pt) / self.res

    def pts_to_indices(self, pts: torch.Tensor) -> torch.Tensor:
        return torch.floor((pts - self.global_min_pt) / self.voxel_size).to(torch.int32)

    def query(self, pts: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
        """[N] bool: the voxel of each point, False within ``epsilon`` of the
        box's faces and outside it."""
        invalid = ((pts >= self.global_max_pt - epsilon)
                   | (pts < self.global_min_pt + epsilon)).any(dim=-1)
        basis = torch.stack([self.res[2] * self.res[1], self.res[2],
                             torch.ones_like(self.res[0])]).to(torch.int32)
        lin = (self.pts_to_indices(pts) * basis).sum(dim=-1)
        lin = torch.where(invalid, self.grid_flat.shape[0] - 1, lin)
        return self.grid_flat[lin]


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

    @property
    def mid_pt(self) -> torch.Tensor:
        return (self.max_pt + self.min_pt) / 2

    def scaled(self, factor: float) -> "BBox":
        """The box scaled by ``factor`` about its middle."""
        mid = self.mid_pt
        return BBox((self.min_pt - mid) * factor + mid, (self.max_pt - mid) * factor + mid)

    def to(self, device) -> "BBox":
        return BBox(self.min_pt.to(device), self.max_pt.to(device))

    def normalize(self, pts: torch.Tensor) -> torch.Tensor:
        """Map coordinates so min_pt -> 0 and max_pt -> 1."""
        return (pts - self.min_pt) / self.size
