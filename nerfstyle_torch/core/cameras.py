"""Camera ray generation (counterpart of ``nerfstyle_tpu/core/cameras.py``).

The camera-frame direction grid is static per intrinsics (and precrop
window) and computed once with numpy; the pose rotation runs on the target
device.  Rendering takes every pixel (:func:`generate_rays`); a train step
takes pixels drawn with replacement from the (precropped) grid
(:func:`sample_pixels`, :func:`pixel_rays`).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .types import Intrinsics, RayBundle, make_rays


@functools.lru_cache(maxsize=32)
def camera_dir_grid(
    intr: Intrinsics, camera_flip: int = 0, precrop: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Camera-frame direction grid ``dirs [h', w', 3]`` at symmetric pixel
    centers, and the full-frame pixel rows ``ys [h']`` and columns ``xs
    [w']`` of its entries.  ``precrop < 1`` keeps the central
    ``int(w*precrop) x int(h*precrop)`` window.  Bit 2 of ``camera_flip``
    flips X, bit 1 Y, bit 0 Z."""
    if not 0.0 <= precrop <= 1.0:
        raise ValueError(f"precrop must lie in [0, 1], got {precrop}")
    fw, fh = intr.size()
    x_coords = np.linspace(0, fw, num=2 * fw + 1, dtype=np.float32)[1::2]
    y_coords = np.linspace(0, fh, num=2 * fh + 1, dtype=np.float32)[1::2]
    xs = np.arange(fw, dtype=np.int32)
    ys = np.arange(fh, dtype=np.int32)
    if precrop < 1.0:
        w, h = int(fw * precrop), int(fh * precrop)
        dx, dy = (fw - w) // 2, (fh - h) // 2
        x_coords, y_coords = x_coords[dx:dx + w], y_coords[dy:dy + h]
        xs, ys = xs[dx:dx + w], ys[dy:dy + h]
    i, j = np.meshgrid(x_coords, y_coords, indexing="xy")
    dirs = np.stack(
        [(i - intr.cx) / intr.fx, (j - intr.cy) / intr.fy, np.ones_like(i)], axis=-1
    ).astype(np.float32)
    flip = np.where([(camera_flip >> b) & 1 for b in [2, 1, 0]], -1.0, 1.0).astype(np.float32)
    return dirs * flip, ys, xs


def generate_rays(
    pose: torch.Tensor, intr: Intrinsics, camera_flip: int = 0
) -> RayBundle:
    """World-space rays of every pixel, row-major, for a [4, 4]
    camera-to-world ``pose`` (the device of ``pose`` is the device of the
    rays)."""
    cam_dirs_np, _, _ = camera_dir_grid(intr, camera_flip)
    cam_dirs = torch.from_numpy(cam_dirs_np).to(pose.device)
    rot, trans = pose[:3, :3], pose[:3, 3]
    rays_d = torch.einsum("ij,hwj->hwi", rot, cam_dirs).reshape(-1, 3)
    return make_rays(trans, rays_d)


def sample_pixels(
    num: int, num_pixels: int, generator: torch.Generator, device: Optional[torch.device] = None
) -> torch.Tensor:
    """``num`` flat indices into a grid of ``num_pixels`` entries, drawn
    uniformly WITH replacement (as the JAX train step does), int64."""
    dev = generator.device if device is None else device
    return torch.randint(0, num_pixels, (num,), generator=generator, device=dev)


def pixel_rays(cam_dirs: torch.Tensor, pose: torch.Tensor, idx: torch.Tensor) -> RayBundle:
    """World rays of the flat grid entries ``idx`` of ``cam_dirs`` [g, 3]
    (a :func:`camera_dir_grid` flattened) for a [4, 4] camera-to-world pose."""
    rays_d = cam_dirs[idx] @ pose[:3, :3].T
    return make_rays(pose[:3, 3], rays_d)
