"""Reference-checkpoint interop: the reference's occupancy layout to the
port's, and back (counterpart of ``nerfstyle_tpu/interop.py``).

The reference Renderer persists its occupancy state in Morton (Z-order)
cell order: ``density_grid`` ``[cascade, H^3]`` f32 indexed by the Morton
code of the cell, and ``density_bitfield`` packed 8 cells a byte (bit =
cell % 8).  The port, as the JAX package, stores both linearly (x-major)
with a bool bitfield.  The permutations are gathers by the Morton codes of
the cells (kernel K8b on CUDA tensors), the packing is kernel K8a
(``ops/occupancy.py``).

(The reference's tiny-cuda-nn MLP blobs are packed layouts internal to that
library and are not convertible: grids import, MLP heads must be retrained
or exported layer-wise on the reference side.)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .ops.morton import morton3d, morton3d_invert
from .ops.occupancy import all_cell_coords, cell_linear_index, packbits, unpackbits


def _check_grid(grid_size: int) -> None:
    if grid_size < 1 or grid_size & (grid_size - 1) or grid_size > 1024:
        raise ValueError(f"Morton order needs a power-of-two grid of at most 1024 cells a "
                         f"side, got {grid_size}")


def morton_grid_to_linear(grid_morton: torch.Tensor, grid_size: int, *,
                          plain: bool = False) -> torch.Tensor:
    """[..., H^3] Morton-indexed cell values -> linear (x-major) indexing:
    ``linear[..., lin(x, y, z)] = morton[..., morton3d(x, y, z)]``."""
    _check_grid(grid_size)
    coords = all_cell_coords(grid_size, grid_morton.device)
    codes = morton3d(coords, plain=plain).to(torch.int64)
    return grid_morton[..., codes]


def linear_grid_to_morton(grid_linear: torch.Tensor, grid_size: int, *,
                          plain: bool = False) -> torch.Tensor:
    """Inverse of :func:`morton_grid_to_linear`: ``morton[..., code] =
    linear[..., lin(morton3d_invert(code))]``."""
    _check_grid(grid_size)
    codes = torch.arange(grid_size**3, dtype=torch.int32, device=grid_linear.device)
    coords = morton3d_invert(codes, plain=plain).to(torch.int64)
    return grid_linear[..., cell_linear_index(coords, grid_size)]


def reference_bitfield_to_linear(packed_morton: torch.Tensor, grid_size: int, cascade: int, *,
                                 plain: bool = False) -> torch.Tensor:
    """The reference's packed bitfield (u8 [cascade * H^3 / 8], Morton cell
    order, bit = cell % 8) -> the port's bool [cascade * H^3] linear field."""
    bits = unpackbits(packed_morton.reshape(-1), plain=plain)
    if bits.numel() != cascade * grid_size**3:
        raise ValueError(f"a packed bitfield of {packed_morton.numel()} bytes does not hold "
                         f"{cascade} cascades of {grid_size}^3 cells")
    return morton_grid_to_linear(bits.reshape(cascade, -1), grid_size, plain=plain).reshape(-1)


def linear_bitfield_to_reference(bitfield: torch.Tensor, grid_size: int, *,
                                 plain: bool = False) -> torch.Tensor:
    """Inverse of :func:`reference_bitfield_to_linear`: bool [cascade * H^3]
    linear -> u8 [cascade * H^3 / 8], Morton order, packed."""
    per = grid_size**3
    morton = linear_grid_to_morton(bitfield.reshape(-1, per), grid_size, plain=plain)
    return packbits(morton.reshape(-1).contiguous(), plain=plain)


def import_reference_grid_state(
    density_grid_morton, bitfield_packed, grid_size: int, device=None, *, plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference checkpoint's (density_grid, density_bitfield) pair ->
    (density grid [cascade, H^3] f32, bitfield bool [cascade * H^3]), linear,
    on ``device``, ready for ``PersistedOccupancy``."""
    grid = torch.as_tensor(np.asarray(density_grid_morton, np.float32)).to(device)
    if grid.dim() == 1:
        grid = grid[None]
    packed = torch.as_tensor(np.asarray(bitfield_packed, np.uint8)).to(device)
    grid_lin = morton_grid_to_linear(grid, grid_size, plain=plain)
    bits_lin = reference_bitfield_to_linear(packed, grid_size, grid.shape[0], plain=plain)
    return grid_lin, bits_lin
