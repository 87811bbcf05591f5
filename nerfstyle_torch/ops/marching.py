"""Occupancy-guided ray marching with exact-size compaction (counterpart of
``nerfstyle_tpu/ops/marching.py``).

The step is the constant ``dt = 2*sqrt(3)/max_steps``, so every sample lies
on the lattice ``t_k = near + k*dt``.  A lattice point is kept when its
cascade cell is occupied and ``t_k < far``; a ray keeps at most
``max_steps`` points.  Samples are emitted ray-major, ascending in k.

The JAX package compacts into a static budget (and reports the demand);
here every output is sized exactly from the count, so nothing is ever
truncated — the same samples the JAX marcher emits once its budget covers
the demand.  :func:`march_rays` launches kernel K3 (``csrc/march.cu``) on
CUDA tensors and runs :func:`march_rays_plain` (the dense-lattice semantics
of the JAX ``_kept_mask_dense``, then ray-major compaction) on CPU tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels, use_kernel
from .occupancy import cell_linear_index

SQRT3 = 1.7320508075688772


@dataclass(frozen=True)
class MarchPlan:
    """Static marching geometry, from RendererConfig and the scene bound."""

    bound: float
    cascade: int  # 1 + ceil(log2(bound))
    grid_size: int
    max_steps: int  # per-ray cap on kept samples
    min_near: float = 0.2

    @property
    def dt(self) -> float:
        """Constant step, rounded to fp32 (the value every device computes with)."""
        return float(np.float32(2.0 * SQRT3 / self.max_steps))

    @property
    def t_lattice(self) -> int:
        """Lattice length: the cube diagonal 2*bound*sqrt(3) is bound*max_steps steps."""
        return int(math.ceil(self.bound * self.max_steps)) + 1

    @property
    def mip_dt_level(self) -> int:
        """Constant mip-from-dt term: frexp exponent of dt*H/2, clamped to
        [0, cascade-1] (computed in double from the unrounded step, as the
        JAX package does)."""
        e = math.frexp(2.0 * SQRT3 / self.max_steps * self.grid_size * 0.5)[1]
        return min(self.cascade - 1, max(0, e))

    def aabb(self, device=None) -> torch.Tensor:
        b = self.bound
        return torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, device=device)


class SampleBatch(NamedTuple):
    """Marched samples, ray-major and exact-size (M = offsets[-1])."""

    xyz: torch.Tensor  # [M, 3] world positions (clamped to the bound)
    dirs: torch.Tensor  # [M, 3] unit ray dirs
    tau: torch.Tensor  # [M] depth integrand t + dt - near
    ray_id: torch.Tensor  # [M] i32
    step: torch.Tensor  # [M] i32 lattice index k
    offsets: torch.Tensor  # [N+1] i64: ray r owns samples offsets[r] .. offsets[r+1]-1

    @property
    def num_kept(self) -> int:
        return self.xyz.shape[0]


def cell_index_and_size(
    xyz: torch.Tensor, *, bound: float, cascade: int, grid_size: int, mip_dt_level: int = 0
):
    """Cascaded-grid cell index, world cell size, level and max|x| of world
    points [..., 3]."""
    h = grid_size
    mx = xyz.abs().amax(dim=-1)
    _, e = torch.frexp(mx)  # mx = m * 2^e, m in [0.5, 1)
    level = e.clamp(min=mip_dt_level).clamp(0, cascade - 1)
    mip_bound = torch.ldexp(torch.ones_like(mx), level).clamp(max=bound)
    coords = (0.5 * (xyz / mip_bound[..., None] + 1.0) * h).to(torch.int32)
    coords = coords.clamp(0, h - 1)
    idx = level * (h * h * h) + cell_linear_index(coords, h)
    return idx, 2.0 * mip_bound / h, level, mx


def _positions(origins, dirs, t, bound):
    return (origins + dirs * t[..., None]).clamp(-bound, bound)


def march_rays_plain(
    plan: MarchPlan,
    bitfield: torch.Tensor,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    nears: torch.Tensor,
    fars: torch.Tensor,
) -> SampleBatch:
    """Dense [N, T] lattice sweep (in blocks of rays to bound memory), then
    ray-major compaction."""
    n, t_lat, dt = origins.shape[0], plan.t_lattice, plan.dt
    dev = origins.device
    k = torch.arange(t_lat, dtype=torch.float32, device=dev)
    block = max(1, (1 << 22) // t_lat)
    rids, steps = [], []
    for s in range(0, n, block):
        e = min(n, s + block)
        t = nears[s:e, None] + k[None, :] * dt  # [b, T]
        xyz = _positions(origins[s:e, None, :], dirs[s:e, None, :], t, plan.bound)
        idx, _, _, _ = cell_index_and_size(
            xyz, bound=plan.bound, cascade=plan.cascade, grid_size=plan.grid_size,
            mip_dt_level=plan.mip_dt_level,
        )
        kept = bitfield[idx] & (t < fars[s:e, None])
        kept &= torch.cumsum(kept, dim=1) <= plan.max_steps
        r, kk = kept.nonzero(as_tuple=True)  # row-major: ray-major, ascending k
        rids.append(r + s)
        steps.append(kk)
    rid = torch.cat(rids) if rids else torch.zeros((0,), dtype=torch.int64, device=dev)
    kk = torch.cat(steps) if steps else torch.zeros((0,), dtype=torch.int64, device=dev)
    near = nears[rid]
    t_sel = near + kk.to(torch.float32) * dt
    offsets = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(rid, minlength=n), 0)
    return SampleBatch(
        xyz=_positions(origins[rid], dirs[rid], t_sel, plan.bound),
        dirs=dirs[rid],
        tau=t_sel + dt - near,
        ray_id=rid.to(torch.int32),
        step=kk.to(torch.int32),
        offsets=offsets,
    )


def march_rays(
    plan: MarchPlan,
    bitfield: torch.Tensor,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    nears: torch.Tensor,
    fars: torch.Tensor,
    *,
    plain: bool = False,
) -> SampleBatch:
    """March N rays over the occupancy ``bitfield`` ([cascade*H^3] bool).

    CUDA tensors go through kernel K3; CPU tensors (or ``plain=True``)
    through :func:`march_rays_plain`."""
    if not use_kernel(origins, plain):
        return march_rays_plain(plan, bitfield, origins, dirs, nears, fars)
    out = kernels.march_rays(
        origins.contiguous(), dirs.contiguous(), nears.contiguous(), fars.contiguous(),
        bitfield.contiguous(), dt=plan.dt, bound=plan.bound, t_lattice=plan.t_lattice,
        cascade=plan.cascade, grid_size=plan.grid_size, mip_dt_level=plan.mip_dt_level,
        max_steps=plan.max_steps,
    )
    return SampleBatch(*out)
