"""Dense stratified sampling and chunked volume integration (counterpart of
``nerfstyle_tpu/ops/stratified.py``): the render math from before the
occupancy grid, kept as the compositing oracle a marched render is held
against, and for dense ablation renders.

:func:`sample_points` draws one jittered sample in each of ``num_samples``
equal strata of ``[near, far]`` a ray, its jitter from an explicit
``torch.Generator`` on the rays' device; :func:`integrate_points`
composites a chunk of samples a ray and carries (rgb, acc, trans) so that
chunks compose; :func:`global_to_local` shifts blocks of points into
per-voxel frames.  Plain tensor functions, as JAX's are plain XLA (the
reference's ``nerf_lib.py`` is pure torch and stands in for no CUDA
kernel): they run on the device of their inputs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.types import RayBundle
from ..utils import density2alpha


def sample_points(rays: RayBundle, near: float, far: float, num_samples: int,
                  generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified samples: ``(pts [N, K, 3], dists [N, K])``, sample k of a
    ray uniform in ``[z_k, z_{k+1})`` of ``K + 1`` equally spaced edges from
    ``near`` to ``far``; ``dists`` the gaps to the next sample, the last
    1e10."""
    n, dev = len(rays), rays.dirs.device
    z_edges = torch.linspace(near, far, num_samples + 1, dtype=torch.float32, device=dev)
    lower, upper = z_edges[:-1].expand(n, num_samples), z_edges[1:].expand(n, num_samples)
    t_rand = torch.rand((n, num_samples), generator=generator, device=dev)
    z_vals = lower + (upper - lower) * t_rand
    pts = rays.lerp(z_vals)
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full((n, 1), 1e10, dtype=z_vals.dtype, device=dev)], dim=-1)
    return pts, dists


def integrate_points(
    dists: torch.Tensor,
    rgbs: torch.Tensor,
    densities: torch.Tensor,
    prev_rgb: torch.Tensor,
    prev_acc: torch.Tensor,
    prev_trans: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Volume rendering of a chunk of K samples a ray, resumable:
    ``alpha_i = 1 - exp(-relu(sigma_i) * dist_i)``, ``T_i = prev_trans *
    prod_{j<i} (1 - alpha_j)``; returns ``(rgb [N, C], acc [N, 1], trans
    [N, 1])`` with the chunk added to ``prev_rgb`` and ``prev_acc``, and the
    transmittance past its last sample."""
    alpha = density2alpha(densities, dists)  # [N, K]
    trans = torch.cumprod(torch.cat([prev_trans, 1.0 - alpha[:, :-1]], dim=-1), dim=-1)
    weights = alpha * trans
    rgb_map = prev_rgb + torch.sum(weights[..., None] * rgbs, dim=1)
    acc_map = prev_acc + torch.sum(weights, dim=1, keepdim=True)
    trans_map = (trans[:, -1] * (1.0 - alpha[:, -1]))[:, None]
    return rgb_map, acc_map, trans_map


def global_to_local(points: torch.Tensor, mid_points: torch.Tensor, voxel_size: float,
                    batch_sizes: Sequence[int]) -> torch.Tensor:
    """Points in consecutive blocks of ``batch_sizes``, block i shifted by
    ``mid_points[i]``, then scaled by ``2 / voxel_size``: each block in its
    voxel's frame, [-1, 1] inside the voxel."""
    out, ptr = [], 0
    for mid, bsize in zip(mid_points, batch_sizes):
        out.append(points[ptr:ptr + bsize] - mid)
        ptr += bsize
    return torch.cat(out) / (voxel_size / 2)
