"""Ray/AABB intersection, slab test (counterpart of
``nerfstyle_tpu/ops/aabb.py``).  Elementwise math: plain PyTorch on every
device."""

from __future__ import annotations

from typing import Tuple

import torch

FLT_MAX = 3.402823466e38


def near_far_from_aabb(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabb: torch.Tensor,
    min_near: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray entry/exit distances ([N] each) for the box ``aabb`` = (xmin,
    ymin, zmin, xmax, ymax, zmax).  Rays that miss get FLT_MAX in both."""
    rd = 1.0 / rays_d  # inf on zero components, as 1/0 in the reference kernel
    t0 = (aabb[None, :3] - rays_o) * rd
    t1 = (aabb[None, 3:] - rays_o) * rd
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    flt_max = torch.tensor(FLT_MAX, dtype=near.dtype, device=near.device)
    return torch.where(miss, flt_max, near), torch.where(miss, flt_max, far)
