"""Camera ray generation (counterpart of ``nerfstyle_tpu/core/cameras.py``).

Full-frame rays only: the camera-frame direction grid is static per
intrinsics and computed once with numpy; the pose rotation runs on the
target device.  Random pixel subsampling belongs to training.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .types import Intrinsics, RayBundle, make_rays


@functools.lru_cache(maxsize=32)
def camera_dir_grid(intr: Intrinsics, camera_flip: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Camera-frame direction grid ``dirs [h, w, 3]`` at symmetric pixel
    centers, and the pixel rows ``ys [h]`` and columns ``xs [w]``.  Bit 2 of
    ``camera_flip`` flips X, bit 1 Y, bit 0 Z."""
    fw, fh = intr.size()
    x_coords = np.linspace(0, fw, num=2 * fw + 1, dtype=np.float32)[1::2]
    y_coords = np.linspace(0, fh, num=2 * fh + 1, dtype=np.float32)[1::2]
    xs = np.arange(fw, dtype=np.int32)
    ys = np.arange(fh, dtype=np.int32)
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
