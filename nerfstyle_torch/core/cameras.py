"""Camera ray generation (counterpart of ``nerfstyle_tpu/core/cameras.py``).

The camera-frame direction grid is static per intrinsics (and precrop
window or patch) and computed once with numpy; the pose rotation runs on the
target device.  Rendering takes every pixel of the grid, or ``num_rays`` of
them drawn without replacement, with their target pixels
(:func:`generate_rays`); a train step takes pixels drawn with replacement
from the (precropped) grid (:func:`sample_pixels`, :func:`pixel_rays`).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .types import Box2D, Intrinsics, RayBundle, make_rays


@functools.lru_cache(maxsize=32)
def camera_dir_grid(
    intr: Intrinsics, camera_flip: int = 0, precrop: float = 1.0, patch: Optional[Box2D] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Camera-frame direction grid ``dirs [h', w', 3]`` at symmetric pixel
    centers, and the full-frame pixel rows ``ys [h']`` and columns ``xs
    [w']`` of its entries.  ``precrop < 1`` keeps the central
    ``int(w*precrop) x int(h*precrop)`` window; ``patch`` keeps its box of
    the frame (not with a precrop).  Bit 2 of ``camera_flip`` flips X, bit
    1 Y, bit 0 Z."""
    if not 0.0 <= precrop <= 1.0:
        raise ValueError(f"precrop must lie in [0, 1], got {precrop}")
    if precrop < 1.0 and patch is not None:
        raise ValueError("precrop and patch are mutually exclusive")
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
    if patch is not None:
        x_coords, y_coords = x_coords[patch.wrange()], y_coords[patch.hrange()]
        xs, ys = xs[patch.wrange()], ys[patch.hrange()]
    i, j = np.meshgrid(x_coords, y_coords, indexing="xy")
    dirs = np.stack(
        [(i - intr.cx) / intr.fx, (j - intr.cy) / intr.fy, np.ones_like(i)], axis=-1
    ).astype(np.float32)
    flip = np.where([(camera_flip >> b) & 1 for b in [2, 1, 0]], -1.0, 1.0).astype(np.float32)
    return dirs * flip, ys, xs


def generate_rays(
    pose: torch.Tensor,
    intr: Intrinsics,
    img: Optional[torch.Tensor] = None,
    patch: Optional[Box2D] = None,
    precrop: float = 1.0,
    num_rays: Optional[int] = None,
    camera_flip: int = 0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[RayBundle, Optional[torch.Tensor]]:
    """World-space rays for a [4, 4] camera-to-world ``pose`` (the rays lie
    on its device): every pixel of the grid (:func:`camera_dir_grid` of
    ``precrop`` or ``patch``) row-major, or with ``num_rays`` that many
    drawn uniformly without replacement (``torch.randperm`` on
    ``generator``, which is required then).

    Returns ``(rays, target)``: ``target`` [K, C] holds each ray's pixel of
    ``img`` (channels-first [C, H, W], C = 3, or 4 with a segmentation
    channel), or is None without ``img``."""
    cam_dirs_np, ys_np, xs_np = camera_dir_grid(intr, camera_flip, precrop, patch)
    h, w = cam_dirs_np.shape[:2]
    dev = pose.device
    cam_dirs = torch.from_numpy(cam_dirs_np).to(dev)
    rot, trans = pose[:3, :3], pose[:3, 3]
    rays_d = torch.einsum("ij,hwj->hwi", rot, cam_dirs).reshape(-1, 3)
    target = None
    if img is not None:  # the grid's full-frame pixel rows and columns
        ys = torch.from_numpy(ys_np).to(img.device, torch.int64)
        xs = torch.from_numpy(xs_np).to(img.device, torch.int64)
    if num_rays is None:
        if img is not None:
            target = img[:, ys][:, :, xs].reshape(img.shape[0], h * w).T
    else:
        if generator is None:
            raise ValueError("drawing num_rays pixels takes a torch.Generator")
        idx = torch.randperm(w * h, generator=generator, device=generator.device)[:num_rays]
        rays_d = rays_d[idx.to(dev)]
        if img is not None:
            idx = idx.to(img.device)
            target = img[:, ys[idx // w], xs[idx % w]].T
    return make_rays(trans, rays_d), target


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
