"""3D Morton (Z-order) codes and their inverse (counterpart of
``nerfstyle_tpu/ops/morton.py``): the reference's cell order of the
occupancy grid, needed only to convert its checkpoints.

The code interleaves the low 10 bits of x, y and z (x at bit 3i, y at
3i + 1, z at 3i + 2) by the reference's multiply-and-mask bit spreading in
uint32 arithmetic.  CUDA tensors go through kernel K8b
(``csrc/interop.cu``); CPU tensors through the plain versions, which
compute in int64 and mask to 32 bits (PyTorch's CPU has no uint32
arithmetic).
"""

from __future__ import annotations

import torch

from .. import kernels, use_kernel

_U32 = 0xFFFFFFFF
_SPREAD = ((0x00010001, 0xFF0000FF), (0x00000101, 0x0F00F00F), (0x00000011, 0xC30C30C3),
           (0x00000005, 0x49249249))
_COMPACT = ((2, 0xC30C30C3), (4, 0x0F00F00F), (8, 0xFF0000FF), (16, 0x0000FFFF))


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64) & _U32
    for mul, mask in _SPREAD:
        v = (v * mul) & _U32 & mask
    return v


def _compact_bits(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x49249249
    for shift, mask in _COMPACT:
        v = (v | (v >> shift)) & mask
    return v


def morton3d_plain(coords: torch.Tensor) -> torch.Tensor:
    """Plain K8b: [N, 3] int coordinates -> [N] i32 codes."""
    x, y, z = (_expand_bits(coords[..., a]) for a in range(3))
    return (x | (y << 1) | (z << 2)).to(torch.int32)


def morton3d_invert_plain(codes: torch.Tensor) -> torch.Tensor:
    """Plain K8b inverse: [N] codes -> [N, 3] i32 coordinates."""
    c = codes.to(torch.int64) & _U32
    return torch.stack([_compact_bits(c >> a) for a in range(3)], dim=-1).to(torch.int32)


def morton3d(coords: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """[N, 3] int cell coordinates -> [N] i32 Morton codes; kernel K8b on
    CUDA tensors."""
    if not use_kernel(coords, plain):
        return morton3d_plain(coords)
    return kernels.morton3d(coords.to(torch.int32).contiguous())


def morton3d_invert(codes: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """[N] Morton codes -> [N, 3] i32 cell coordinates; kernel K8b on CUDA
    tensors."""
    if not use_kernel(codes, plain):
        return morton3d_invert_plain(codes)
    return kernels.morton3d_invert(codes.to(torch.int32).contiguous())
