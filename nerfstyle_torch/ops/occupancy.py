"""Cascaded occupancy grid state, as rendering reads it (counterpart of
``nerfstyle_tpu/ops/occupancy.py``).

Cells are addressed linearly (x*H*H + y*H + z); the bitfield is a bool per
cell, ``[cascade * H^3]``.  The marcher (kernel K3) walks the dense lattice,
so the skip-distance field the JAX two-stage marcher builds on restore is not
needed here.  The grid's maintenance during training (probes, EMA merge)
belongs to a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PersistedOccupancy(NamedTuple):
    """The occupancy state, both as the renderer holds it on its device and
    as a checkpoint stores it, in the leaf order the JAX package saves.  (The
    JAX state also holds a skip-distance field, derived on restore; the
    port's marcher does not read one.)"""

    density_grid: torch.Tensor  # [cascade, H^3] f32
    bitfield: torch.Tensor  # [cascade * H^3] bool
    mean_density: torch.Tensor  # f32 scalar
    mean_count: torch.Tensor  # i32 scalar
    local_step: torch.Tensor  # i32 scalar


def occupancy_init(cascade: int, grid_size: int, device=None) -> PersistedOccupancy:
    """An empty grid (also the template a checkpoint's leaves restore into)."""
    n = grid_size**3
    return PersistedOccupancy(
        density_grid=torch.zeros((cascade, n), dtype=torch.float32, device=device),
        bitfield=torch.zeros((cascade * n,), dtype=torch.bool, device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        mean_count=torch.zeros((), dtype=torch.int32, device=device),
        local_step=torch.zeros((), dtype=torch.int32, device=device),
    )


def occupancy_restore(p: PersistedOccupancy, grid_size: int, device=None) -> PersistedOccupancy:
    """A checkpoint's occupancy state on ``device``, checked against the grid."""
    state = PersistedOccupancy(*(torch.as_tensor(v).to(device) for v in p))
    n = grid_size**3
    if state.bitfield.dtype != torch.bool or state.bitfield.numel() % n:
        raise ValueError(
            f"bitfield of {state.bitfield.numel()} {state.bitfield.dtype} cells does not "
            f"fit a {grid_size}^3 grid"
        )
    return state


def cell_linear_index(coords: torch.Tensor, grid_size: int) -> torch.Tensor:
    """[..., 3] int cell coords -> [...] linear index (x-major)."""
    return (coords[..., 0] * grid_size + coords[..., 1]) * grid_size + coords[..., 2]
