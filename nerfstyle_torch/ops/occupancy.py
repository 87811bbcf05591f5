"""Cascaded occupancy grid: its state and its maintenance during training
(counterpart of ``nerfstyle_tpu/ops/occupancy.py``).

Cells are addressed linearly (x*H*H + y*H + z); the bitfield is a bool per
cell, ``[cascade * H^3]``.  Beside it the state holds ``skipdist``, each
cell's L-inf distance in cells to the nearest occupied cell of its cascade
(capped at ``SKIP_DMAX``), which the two-stage marcher reads to skip empty
windows of a ray.  It is derived data: a checkpoint keeps the five
persisted leaves (:class:`PersistedOccupancy`), and the skip distance is
rebuilt on every restore and after every merge (kernel K6c on CUDA tensors,
at any grid size, :func:`skipdist_from_bitfield`).

Maintenance, every ``update_iter`` train steps: jittered probes of every cell
(:func:`occupancy_update_full`) or of H^3/4 uniform plus H^3/4 occupied cells
a cascade (:func:`occupancy_update_random`) go through the density branch;
their densities are scatter-maxed into a probe grid and merged into the
density grid by EMA decay-max, and the grid is thresholded to the bitfield
at ``min(mean, density_thresh)`` (:func:`merge_and_threshold`).  The
scatter-max and the merge/threshold are kernel K6 (``csrc/occupancy.cu``) on
CUDA tensors; the plain versions (:func:`scatter_max_plain`,
:func:`merge_and_threshold_plain`) run on CPU tensors.

:func:`packbits` / :func:`unpackbits` convert the bitfield to and from the
reference's packed uint8 form (kernel K8a, ``csrc/interop.cu``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import kernels, use_kernel

# Points per density-branch call of an update (the JAX default chunk).
PROBE_CHUNK = 64 * 64 * 64


# Cap on the stored skip distance, in cells: SKIP_DMAX means "at least".
SKIP_DMAX = 15


class OccupancyState(NamedTuple):
    """The occupancy state as the renderer holds it on its device (the JAX
    ``OccupancyState``, same field order)."""

    density_grid: torch.Tensor  # [cascade, H^3] f32
    bitfield: torch.Tensor  # [cascade * H^3] bool
    skipdist: torch.Tensor  # [cascade * H^3] u8, 0 = occupied
    mean_density: torch.Tensor  # f32 scalar
    mean_count: torch.Tensor  # i32 scalar
    local_step: torch.Tensor  # i32 scalar


class PersistedOccupancy(NamedTuple):
    """The occupancy state as a checkpoint stores it: the five persisted
    leaves in the JAX package's order (the skip distance is rebuilt on
    restore)."""

    density_grid: torch.Tensor  # [cascade, H^3] f32
    bitfield: torch.Tensor  # [cascade * H^3] bool
    mean_density: torch.Tensor  # f32 scalar
    mean_count: torch.Tensor  # i32 scalar
    local_step: torch.Tensor  # i32 scalar


def occupancy_persistable(s: OccupancyState) -> PersistedOccupancy:
    return PersistedOccupancy(s.density_grid, s.bitfield, s.mean_density, s.mean_count,
                              s.local_step)


def occupancy_init(cascade: int, grid_size: int, device=None) -> OccupancyState:
    """An empty grid (no cell occupied: every skip distance at the cap)."""
    n = grid_size**3
    return OccupancyState(
        density_grid=torch.zeros((cascade, n), dtype=torch.float32, device=device),
        bitfield=torch.zeros((cascade * n,), dtype=torch.bool, device=device),
        skipdist=torch.full((cascade * n,), SKIP_DMAX, dtype=torch.uint8, device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        mean_count=torch.zeros((), dtype=torch.int32, device=device),
        local_step=torch.zeros((), dtype=torch.int32, device=device),
    )


def occupancy_restore(p: PersistedOccupancy, grid_size: int, device=None) -> OccupancyState:
    """A checkpoint's occupancy leaves on ``device``, checked against the
    grid, with the skip distance rebuilt from the bitfield."""
    p = PersistedOccupancy(*(torch.as_tensor(v).to(device) for v in p))
    n = grid_size**3
    if p.bitfield.dtype != torch.bool or p.bitfield.numel() % n:
        raise ValueError(
            f"bitfield of {p.bitfield.numel()} {p.bitfield.dtype} cells does not "
            f"fit a {grid_size}^3 grid"
        )
    return OccupancyState(
        density_grid=p.density_grid,
        bitfield=p.bitfield,
        skipdist=skipdist_from_bitfield(p.bitfield, grid_size),
        mean_density=p.mean_density,
        mean_count=p.mean_count,
        local_step=p.local_step,
    )


def _dilate3(occ: torch.Tensor) -> torch.Tensor:
    """3x3x3 binary dilation of [cascade, H, H, H], non-wrapping."""
    for ax in (1, 2, 3):
        n = occ.shape[ax]
        out = occ.clone()
        out.narrow(ax, 1, n - 1).logical_or_(occ.narrow(ax, 0, n - 1))
        out.narrow(ax, 0, n - 1).logical_or_(occ.narrow(ax, 1, n - 1))
        occ = out
    return occ


def skipdist_plain(bitfield: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Plain K6c: the JAX iterated dilation.  dist = k at the first of
    SKIP_DMAX - 1 dilations that reaches the cell, SKIP_DMAX if none does."""
    h = grid_size
    occ = bitfield.reshape(-1, h, h, h)
    dist = torch.full(occ.shape, SKIP_DMAX, dtype=torch.uint8, device=occ.device)
    for k in range(SKIP_DMAX):
        dist = dist.masked_fill(occ & (dist == SKIP_DMAX), k)
        if k < SKIP_DMAX - 1:
            occ = _dilate3(occ)
    return dist.reshape(-1)


def skipdist_from_bitfield(bitfield: torch.Tensor, grid_size: int, *,
                           plain: bool = False) -> torch.Tensor:
    """[cascade * H^3] bool -> [cascade * H^3] u8: each cell's L-inf distance
    in cells to the nearest occupied cell of its cascade, capped at
    SKIP_DMAX, the grid not wrapping.  On CUDA tensors kernel K6c, one
    launch at every grid size."""
    if not use_kernel(bitfield, plain):
        return skipdist_plain(bitfield, grid_size)
    return kernels.occupancy_skipdist(bitfield.contiguous(), grid_size, SKIP_DMAX)


def cell_linear_index(coords: torch.Tensor, grid_size: int) -> torch.Tensor:
    """[..., 3] int cell coords -> [...] linear index (x-major)."""
    return (coords[..., 0] * grid_size + coords[..., 1]) * grid_size + coords[..., 2]


def all_cell_coords(grid_size: int, device=None) -> torch.Tensor:
    """[H^3, 3] int32 coords of every cell in linear-index order."""
    r = torch.arange(grid_size, dtype=torch.int32, device=device)
    xx, yy, zz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)


def cells_to_cascade_points(
    coords: torch.Tensor,
    cas: int,
    grid_size: int,
    bound: float,
    jitter: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """World-space probe points [P, 3] of cells ``coords`` [P, 3] at cascade
    ``cas``: the cell's point on the [-1, 1] lattice, scaled into the
    cascade, plus ``jitter`` [P, 3] in [-1, 1) times half a cell (drawn from
    ``generator`` when not given)."""
    cas_bound = min(2.0**cas, bound)
    half = cas_bound / grid_size
    xyz = 2.0 * coords.to(torch.float32) / (grid_size - 1) - 1.0
    pts = xyz * np.float32(cas_bound - half)
    if jitter is None:
        jitter = torch.rand(pts.shape, generator=generator, device=pts.device) * 2.0 - 1.0
    return pts + jitter * np.float32(half)


def _probe(sigma_fn: Callable[[torch.Tensor], torch.Tensor], pts: torch.Tensor,
           chunk: int) -> torch.Tensor:
    return torch.cat([sigma_fn(pts[i:i + chunk]) for i in range(0, pts.shape[0], chunk)])


def scatter_max_plain(tmp: torch.Tensor, idx: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """Plain K6 scatter-max, in place: ``scatter_reduce_`` with ``amax``."""
    return tmp.scatter_reduce_(0, idx, sig, "amax")


def scatter_max(tmp: torch.Tensor, idx: torch.Tensor, sig: torch.Tensor, *,
                plain: bool = False) -> torch.Tensor:
    """tmp [K] <- max(tmp[idx], sig) in place (probe sigmas >= 0 over a -1
    fill); kernel K6 on CUDA tensors."""
    if not use_kernel(tmp, plain):
        return scatter_max_plain(tmp, idx, sig)
    return kernels.occupancy_scatter_max(tmp, idx.contiguous(), sig.contiguous())


def merge_and_threshold_plain(grid: torch.Tensor, tmp: torch.Tensor, decay: float,
                              density_thresh: float):
    """Plain K6 merge: the JAX formula (the mean summed in float64)."""
    valid = (grid >= 0) & (tmp >= 0)
    merged = torch.where(valid, torch.maximum(grid * decay, tmp), grid)
    mean = torch.clamp(merged, min=0.0).sum(dtype=torch.float64) / merged.numel()
    mean = mean.to(torch.float32)
    bitfield = merged > torch.clamp(mean, max=density_thresh)
    return merged, bitfield, mean


def merge_and_threshold(state: OccupancyState, tmp: torch.Tensor, density_decay: float,
                        density_thresh: float, *, grid_size: int,
                        plain: bool = False) -> OccupancyState:
    """EMA decay-max merge of the probe grid ``tmp`` [cascade, H^3] into the
    density grid, then bitfield = grid > min(mean, density_thresh) and its
    skip distance (H = ``grid_size``)."""
    shape = state.density_grid.shape
    grid, t = state.density_grid.reshape(-1), tmp.reshape(-1)
    if not use_kernel(grid, plain):
        merged, bitfield, mean = merge_and_threshold_plain(grid, t, density_decay, density_thresh)
    else:
        merged, bitfield, mean = kernels.occupancy_merge(grid.contiguous(), t.contiguous(),
                                                         density_decay, density_thresh)
    return state._replace(density_grid=merged.reshape(shape), bitfield=bitfield,
                          skipdist=skipdist_from_bitfield(bitfield, grid_size, plain=plain),
                          mean_density=mean)


def occupancy_update_full(
    state: OccupancyState,
    sigma_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    bound: float,
    density_scale: float,
    density_decay: float,
    density_thresh: float,
    jitter: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    chunk: int = PROBE_CHUNK,
    plain: bool = False,
) -> OccupancyState:
    """Full sweep: one jittered probe in every cell of every cascade.

    ``sigma_fn`` maps [P, 3] world points to [P] raw densities (called under
    no_grad, ``chunk`` points at a time).  ``jitter`` [cascade, H^3, 3] in
    [-1, 1) is drawn from ``generator`` when not given."""
    cascade, n = state.density_grid.shape
    grid_size = round(n ** (1 / 3))
    coords = all_cell_coords(grid_size, state.density_grid.device)
    tmp = []
    with torch.no_grad():
        for cas in range(cascade):
            pts = cells_to_cascade_points(coords, cas, grid_size, bound,
                                          None if jitter is None else jitter[cas], generator)
            tmp.append(_probe(sigma_fn, pts, chunk) * density_scale)
        return merge_and_threshold(state, torch.stack(tmp), density_decay, density_thresh,
                                   grid_size=grid_size, plain=plain)


def draw_occupied_cells(grid_row: torch.Tensor, num: int, generator: torch.Generator) -> torch.Tensor:
    """``num`` cells [num] i64 drawn uniformly from the cells of one
    cascade's density grid [H^3] that are > 0 (from all cells when none is),
    by inverse CDF over the occupancy mask: no host sync."""
    mask = grid_row > 0
    mask = torch.where(mask.any(), mask, torch.ones_like(mask))
    cdf = torch.cumsum(mask, 0)
    u = torch.rand((num,), generator=generator, device=grid_row.device)
    k = torch.floor(u * cdf[-1].to(torch.float64)).to(torch.int64)
    k = torch.minimum(k, cdf[-1] - 1)  # u * total may round up to total
    return torch.searchsorted(cdf, k, right=True)


def occupancy_update_random(
    state: OccupancyState,
    sigma_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    bound: float,
    density_scale: float,
    density_decay: float,
    density_thresh: float,
    generator: torch.Generator,
    chunk: int = PROBE_CHUNK,
    plain: bool = False,
) -> OccupancyState:
    """Random update: per cascade, H^3/4 uniform cells and H^3/4 cells drawn
    from the occupied ones, one jittered probe each; scatter-max into a -1
    grid (a cell drawn twice keeps its larger density), then the merge."""
    cascade, n = state.density_grid.shape
    grid_size = round(n ** (1 / 3))
    num = n // 4
    dev = state.density_grid.device
    tmp = torch.full((cascade * n,), -1.0, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for cas in range(cascade):
            unif = torch.randint(0, n, (num,), generator=generator, device=dev)
            occ = draw_occupied_cells(state.density_grid[cas], num, generator)
            idx = torch.cat([unif, occ])
            coords = torch.stack([idx // (grid_size * grid_size), (idx // grid_size) % grid_size,
                                  idx % grid_size], dim=-1)
            pts = cells_to_cascade_points(coords, cas, grid_size, bound, generator=generator)
            sig = _probe(sigma_fn, pts, chunk) * density_scale
            scatter_max(tmp, idx + cas * n, sig, plain=plain)
        return merge_and_threshold(state, tmp.reshape(cascade, n), density_decay,
                                   density_thresh, grid_size=grid_size, plain=plain)


def update_mean_count(state: OccupancyState, batch_points: int) -> OccupancyState:
    """Running mean of the marched samples per train batch (EMA 0.875, the
    first batch taken as is) and one more local step."""
    bp = torch.tensor(float(batch_points), dtype=torch.float32, device=state.mean_count.device)
    mc = state.mean_count.to(torch.float32)
    new = torch.where(state.local_step == 0, bp, 0.875 * mc + 0.125 * bp)
    return state._replace(mean_count=new.to(torch.int32), local_step=state.local_step + 1)


_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def packbits_plain(bitfield: torch.Tensor) -> torch.Tensor:
    """Plain K8a pack: bool [K] -> u8 [K/8], LSB-first."""
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=bitfield.device)
    return (bitfield.reshape(-1, 8).to(torch.uint8) * w).sum(dim=1, dtype=torch.uint8)


def unpackbits_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain K8a unpack: u8 [K/8] -> bool [K], LSB-first."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts[None, :]) & 1).reshape(-1).to(torch.bool)


def packbits(bitfield: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """bool [K] -> u8 [K/8], LSB-first (bit = cell % 8, the reference's
    packed bitfield); kernel K8a on CUDA tensors."""
    if bitfield.dim() != 1 or bitfield.shape[0] % 8:
        raise ValueError(f"packbits takes a flat bool field of a multiple of 8 cells, got "
                         f"{tuple(bitfield.shape)}")
    if not use_kernel(bitfield, plain):
        return packbits_plain(bitfield)
    return kernels.packbits(bitfield.contiguous())


def unpackbits(packed: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """u8 [K/8] -> bool [K], LSB-first; kernel K8a on CUDA tensors."""
    packed = packed.reshape(-1)
    if not use_kernel(packed, plain):
        return unpackbits_plain(packed)
    return kernels.unpackbits(packed.contiguous())
