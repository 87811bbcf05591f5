"""Occupancy-guided ray marching with exact-size compaction (counterpart of
``nerfstyle_tpu/ops/marching.py``).

The step is the constant ``dt = 2*sqrt(3)/max_steps``, so every sample lies
on the lattice ``t_k = near + k*dt``.  A lattice point is kept when its
cascade cell is occupied and ``t_k < far``; a ray keeps at most
``max_steps`` points.  Samples are emitted ray-major, ascending in k.

:func:`march_rays` takes an :class:`OccField`.  With a skip distance (the
renderer's default, ``adaptive_march``) it runs the two-stage march of the
JAX ``_march_two_stage``: windows of ``WINDOW`` lattice points are tested
at their first point against the skip distance of every cascade level, and
only candidate windows take the exact occupancy test (kernel K3s on CUDA
tensors, :func:`march_rays_two_stage_plain` on CPU tensors).  With the
bitfield alone it sweeps the dense lattice (kernel K3,
:func:`march_rays_plain`).  Both emit the same samples.

The JAX package compacts into a static budget (and reports the demand);
here every output is sized exactly from the count, so nothing is ever
truncated — the same samples the JAX marcher emits once its budget covers
the demand.  The two-stage march reports its candidate-window count
``num_cand`` beside the samples, for observability; there is no
window-budget ladder to feed.

:func:`occupancy_lookup` is JAX's gather of points' cell bits, library
API: the marchers look cells up inside their kernels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
import functools
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import kernels, use_kernel
from .occupancy import cell_linear_index

SQRT3 = 1.7320508075688772
# Lattice points of a two-stage window (the JAX marcher's stride S).
WINDOW = 8


class OccField(NamedTuple):
    """What the marcher reads: the occupancy bitfield and, for the two-stage
    march, the skip distance (``ops.occupancy.skipdist_from_bitfield``)."""

    bitfield: torch.Tensor  # [cascade * H^3] bool
    skipdist: Optional[torch.Tensor] = None  # [cascade * H^3] u8, 0 = occupied


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
    num_cand: int = 0  # candidate windows of the two-stage march (0 on the dense path)

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


def occupancy_lookup(
    xyz: torch.Tensor, bitfield: torch.Tensor, *, bound: float, cascade: int, grid_size: int,
    mip_dt_level: int = 0,
) -> torch.Tensor:
    """Occupancy bits [...] of world points [..., 3] in the cascaded grid
    ``bitfield`` [cascade * grid_size^3] (JAX's ``occupancy_lookup``).
    Library API: the marchers K3 and K3s look their cells up inside the
    kernel, so this stays a tensor gather on either device."""
    idx, _, _, _ = cell_index_and_size(xyz, bound=bound, cascade=cascade, grid_size=grid_size,
                                       mip_dt_level=mip_dt_level)
    return bitfield[idx]


def _positions(origins, dirs, t, bound):
    return (origins + dirs * t[..., None]).clamp(-bound, bound)


def _sweep(plan: MarchPlan, bitfield, origins, dirs, nears, fars, ray, k):
    """Whether lattice points ``k`` of rays ``ray`` (int64 index tensors that
    broadcast together) are kept: occupied cell, t < far, k < t_lattice."""
    t = nears[ray] + k.to(torch.float32) * plan.dt
    xyz = _positions(origins[ray], dirs[ray], t, plan.bound)
    idx, _, _, _ = cell_index_and_size(
        xyz, bound=plan.bound, cascade=plan.cascade, grid_size=plan.grid_size,
        mip_dt_level=plan.mip_dt_level,
    )
    return bitfield[idx] & (t < fars[ray]) & (k < plan.t_lattice)


def _batch(rid: torch.Tensor, kk: torch.Tensor, plan: MarchPlan, origins, dirs, nears,
           num_cand: int = 0) -> SampleBatch:
    """The ray-major SampleBatch of kept lattice points (ray ``rid``, index
    ``kk``), in that order."""
    n, dt = origins.shape[0], plan.dt
    near = nears[rid]
    t_sel = near + kk.to(torch.float32) * dt
    offsets = torch.zeros((n + 1,), dtype=torch.int64, device=origins.device)
    offsets[1:] = torch.cumsum(torch.bincount(rid, minlength=n), 0)
    return SampleBatch(
        xyz=_positions(origins[rid], dirs[rid], t_sel, plan.bound),
        dirs=dirs[rid],
        tau=t_sel + dt - near,
        ray_id=rid.to(torch.int32),
        step=kk.to(torch.int32),
        offsets=offsets,
        num_cand=num_cand,
    )


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
    n, t_lat = origins.shape[0], plan.t_lattice
    dev = origins.device
    k = torch.arange(t_lat, device=dev)[None, :]
    block = max(1, (1 << 22) // t_lat)
    rids, steps = [], []
    for s in range(0, n, block):
        e = min(n, s + block)
        kept = _sweep(plan, bitfield, origins, dirs, nears, fars,
                      torch.arange(s, e, device=dev)[:, None], k)
        kept &= torch.cumsum(kept, dim=1) <= plan.max_steps
        r, kk = kept.nonzero(as_tuple=True)  # row-major: ray-major, ascending k
        rids.append(r + s)
        steps.append(kk)
    empty = torch.zeros((0,), dtype=torch.int64, device=dev)
    rid = torch.cat(rids) if rids else empty
    kk = torch.cat(steps) if steps else empty
    return _batch(rid, kk, plan, origins, dirs, nears)


def window_reach(plan: MarchPlan) -> float:
    """S*dt as the JAX marcher compares with it: the double, rounded to f32."""
    return float(np.float32(WINDOW * 2.0 * SQRT3 / plan.max_steps))


def _level_cells(plan: MarchPlan) -> list:
    """World cell size of each cascade level, 2*min(2^lv, bound)/H in
    double, rounded to f32 (as JAX's Python double meets its f32 array)."""
    return [float(np.float32(2.0 * min(2.0**lv, plan.bound) / plan.grid_size))
            for lv in range(plan.cascade)]


@functools.lru_cache(maxsize=16)
def level_cells(plan: MarchPlan, device: torch.device) -> torch.Tensor:
    """:func:`_level_cells` as the f32 [cascade] tensor K3s reads."""
    return torch.tensor(_level_cells(plan), dtype=torch.float32, device=device)


def march_rays_two_stage_plain(
    plan: MarchPlan,
    occ: OccField,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    nears: torch.Tensor,
    fars: torch.Tensor,
) -> SampleBatch:
    """The JAX ``_march_two_stage`` semantics in PyTorch (in blocks of rays
    to bound memory).  Window j of a ray starts at k = j*S; at that coarse
    point, d_world = min over every level lv of (skipdist[lv, cell_lv] - 1)
    * cell_size_lv, and the window is a candidate iff d_world < S*dt and its
    t < far.  Candidate windows' fine points take the exact test (k <
    t_lattice, t < far); the per-ray cap keeps a ray's first max_steps kept
    points across its windows."""
    n, t_lat, h = origins.shape[0], plan.t_lattice, plan.grid_size
    dev = origins.device
    s = WINDOW
    tc = -(-t_lat // s)
    h3 = h * h * h
    reach, cells = window_reach(plan), _level_cells(plan)
    kc = torch.arange(tc, dtype=torch.float32, device=dev) * s
    block = max(1, (1 << 22) // (tc * s))
    rids, steps, num_cand = [], [], 0
    for b0 in range(0, n, block):
        b1 = min(n, b0 + block)
        # Stage 1: coarse candidates [b, Tc].
        t_c = nears[b0:b1, None] + kc[None, :] * plan.dt
        xyz_c = _positions(origins[b0:b1, None, :], dirs[b0:b1, None, :], t_c, plan.bound)
        d_world = torch.full(t_c.shape, float("inf"), dtype=torch.float32, device=dev)
        for lv in range(plan.cascade):
            mip_bound = min(2.0**lv, plan.bound)
            coords = (0.5 * (xyz_c / mip_bound + 1.0) * h).to(torch.int32).clamp(0, h - 1)
            d_lv = occ.skipdist[lv * h3 + cell_linear_index(coords, h)]
            d_world = torch.minimum(d_world, (d_lv.to(torch.float32) - 1.0) * cells[lv])
        cand = (d_world < reach) & (t_c < fars[b0:b1, None])
        num_cand += int(cand.sum())
        # Stage 2: exact occupancy on the candidate windows' fine points.
        wray, wj = cand.nonzero(as_tuple=True)  # ray-major, ascending windows
        wray = wray + b0
        k = wj[:, None] * s + torch.arange(s, device=dev)[None, :]  # [W, S]
        kept = _sweep(plan, occ.bitfield, origins, dirs, nears, fars, wray[:, None], k)
        # Per-ray cap: kept points of the same ray in earlier windows.
        in_win = torch.cumsum(kept, dim=1)
        win_tot = in_win[:, -1]
        before = torch.cumsum(win_tot, 0) - win_tot  # kept before the window, all rays
        first = torch.zeros((b1 - b0 + 1,), dtype=torch.int64, device=dev)
        first[1:] = torch.cumsum(torch.bincount(wray - b0, minlength=b1 - b0), 0)
        start = torch.cat([before, before.new_zeros(1)])[first[:-1]]  # at each ray's 1st window
        ray_prefix = before - start[wray - b0]
        kept &= (ray_prefix[:, None] + in_win) <= plan.max_steps
        w_idx, i = kept.nonzero(as_tuple=True)
        rids.append(wray[w_idx])
        steps.append(k[w_idx, i])
    empty = torch.zeros((0,), dtype=torch.int64, device=dev)
    rid = torch.cat(rids) if rids else empty
    kk = torch.cat(steps) if steps else empty
    return _batch(rid, kk, plan, origins, dirs, nears, num_cand)


def march_rays(
    plan: MarchPlan,
    occ: Union[OccField, torch.Tensor],
    origins: torch.Tensor,
    dirs: torch.Tensor,
    nears: torch.Tensor,
    fars: torch.Tensor,
    *,
    plain: bool = False,
) -> SampleBatch:
    """March N rays over the occupancy grid.

    ``occ``: an :class:`OccField` with a skip distance (the two-stage march,
    kernel K3s) or without one, or a bare [cascade*H^3] bool bitfield (the
    dense lattice sweep, kernel K3).  CUDA tensors go through the kernels;
    CPU tensors (or ``plain=True``) through the plain versions."""
    if not isinstance(occ, OccField):
        occ = OccField(occ)
    two_stage = occ.skipdist is not None
    if not use_kernel(origins, plain):
        if two_stage:
            return march_rays_two_stage_plain(plan, occ, origins, dirs, nears, fars)
        return march_rays_plain(plan, occ.bitfield, origins, dirs, nears, fars)
    rays = (origins.contiguous(), dirs.contiguous(), nears.contiguous(), fars.contiguous(),
            occ.bitfield.contiguous())
    geom = dict(dt=plan.dt, bound=plan.bound, t_lattice=plan.t_lattice, cascade=plan.cascade,
                grid_size=plan.grid_size, mip_dt_level=plan.mip_dt_level,
                max_steps=plan.max_steps)
    skip = None
    if two_stage:
        skip = (occ.skipdist.contiguous(), level_cells(plan, origins.device), WINDOW,
                window_reach(plan))
    *out, num_cand = kernels.march_rays(*rays, skip, **geom)
    return SampleBatch(*out, num_cand=num_cand)
