"""Multiresolution hash-grid encoding (counterpart of
``nerfstyle_tpu/ops/hashgrid.py``).

Same geometry laws as the JAX package: per-level kernel resolution
``floor(2^(l*log2(s)) * H)`` in fp32, table sizes by the ceil law
``min(2^log2_size, ceil(H*s^l)^3)`` rounded up to a multiple of 8, the
spatial-prime XOR hash in uint32 ``% size + offset``, zero features outside
``[0, 1]^3`` and level-major ``[B, L*C]`` output.  Levels below
``simplex_start`` interpolate trilinearly (8 corners); levels from it on
(``simplex_from >= 0``) on the Freudenthal simplex of the cell (4 vertices,
the JAX ``_flat_block_simplex``): with the fractions' descending ranks
(ties broken x before y before z) and sorted fractions s1 >= s2 >= s3,
vertex v includes axis d iff rank_d < v, is hashed as the trilinear corner
with the same integer coordinates, and weighs (1 - s1, s1 - s2, s2 - s3, s3)
in turn.

Every level takes the hash path: the dense index law of the JAX module
applies only when ``(res+1)^3 * 512 <= table size``, and since ``table size
<= ceil(H*s^l)^3 <= (res+1)^3`` that never holds.

:func:`hashgrid_encode` is differentiable in the table (:class:`HashGridEncode`):
its forward launches kernel K1 and its backward kernel K2, the table
gradient (``csrc/hashgrid.cu``), on CUDA tensors; on CPU tensors they run
:func:`hashgrid_encode_plain` and :func:`hashgrid_backward_plain`.  The
gradient of the input positions is zero, as in the JAX fast VJP.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels, use_kernel

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridSpec:
    """Static hash-grid geometry."""

    num_levels: int
    level_dim: int
    base_resolution: int
    per_level_scale: float
    log2_hashmap_size: int
    resolutions: Tuple[int, ...]  # kernel (floor) law per level
    table_sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]  # len L+1, in table rows
    simplex_from: int = -1

    @property
    def total_params(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def simplex_start(self) -> int:
        """First simplex level (``num_levels`` when there is none)."""
        if self.simplex_from < 0:
            return self.num_levels
        return min(self.simplex_from, self.num_levels)


def hashgrid_spec(
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    per_level_scale: float = 2.0,
    log2_hashmap_size: int = 19,
    desired_resolution: Optional[float] = None,
    simplex_from: int = -1,
) -> HashGridSpec:
    """Build the static spec (floor law for kernel resolutions, ceil law for
    table sizes)."""
    if desired_resolution is not None:
        per_level_scale = float(
            np.exp2(np.log2(desired_resolution / base_resolution) / (num_levels - 1))
        )
    max_params = 2**log2_hashmap_size
    offsets = [0]
    table_sizes = []
    resolutions = []
    s_log2 = np.float32(np.log2(per_level_scale))
    for lvl in range(num_levels):
        res_ceil = int(np.ceil(base_resolution * per_level_scale**lvl))
        params = min(max_params, res_ceil**3)
        params = int(np.ceil(params / 8) * 8)
        table_sizes.append(params)
        offsets.append(offsets[-1] + params)
        resolutions.append(
            int(np.floor(np.exp2(np.float32(lvl) * s_log2) * np.float32(base_resolution)))
        )
    return HashGridSpec(
        num_levels=num_levels,
        level_dim=level_dim,
        base_resolution=base_resolution,
        per_level_scale=float(per_level_scale),
        log2_hashmap_size=log2_hashmap_size,
        resolutions=tuple(resolutions),
        table_sizes=tuple(table_sizes),
        offsets=tuple(offsets),
        simplex_from=simplex_from,
    )


def hashgrid_init(
    spec: HashGridSpec, generator: torch.Generator, device=None
) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) table [total_params, level_dim]."""
    t = torch.empty((spec.total_params, spec.level_dim), dtype=torch.float32)
    t.uniform_(-1e-4, 1e-4, generator=generator)
    return t.to(device)


@functools.lru_cache(maxsize=16)
def level_table(spec: HashGridSpec, device: torch.device) -> torch.Tensor:
    """int32 [4, L]: level resolutions, table sizes (rows), row offsets and
    1 on simplex levels (0 on trilinear ones) — the level constants K1 and
    K2 read."""
    simplex = [int(lv >= spec.simplex_start) for lv in range(spec.num_levels)]
    rows = [spec.resolutions, spec.table_sizes, spec.offsets[:-1], simplex]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _cells(spec: HashGridSpec, x: torch.Tensor, lv0: int, lv1: int):
    """Integer corners pg [B, L', 3] i64 and fractions [B, L', 3] of levels
    [lv0, lv1), in the JAX order of operations."""
    scale = torch.tensor(spec.resolutions[lv0:lv1], dtype=torch.float32, device=x.device)
    pos = x[:, None, :] * scale[None, :, None]
    pg = torch.minimum(torch.floor(pos).clamp(min=0.0), (scale - 1.0)[None, :, None])
    return pg.to(torch.int64), pos - pg


def _rows(spec: HashGridSpec, coords, lv0: int, lv1: int) -> torch.Tensor:
    """Table rows [B, L'] i64 of integer corners [B, L', 3] at levels [lv0,
    lv1): the uint32 XOR hash (in int64, masked), % size + offset."""
    dev = coords.device
    sizes = torch.tensor(spec.table_sizes[lv0:lv1], dtype=torch.int64, device=dev)
    offs = torch.tensor(spec.offsets[lv0:lv1], dtype=torch.int64, device=dev)
    h = torch.zeros(coords.shape[:2], dtype=torch.int64, device=dev)
    for d in range(3):
        h = h ^ ((coords[..., d] * PRIMES[d]) & _U32)
    return h % sizes + offs


def _corners(spec: HashGridSpec, x: torch.Tensor):
    """Every (point, level)'s corners (trilinear levels, 8) or simplex
    vertices (4), in the JAX order of operations: [(lv0, lv1, rows [B, L']
    i64, weights [B, L'] f32)], one entry a corner slot of the levels [lv0,
    lv1), and the out-of-range mask [B]."""
    lc, nl = spec.simplex_start, spec.num_levels
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    corners = []
    if lc > 0:
        pg, frac = _cells(spec, x, 0, lc)
        for s in range(8):
            w = torch.ones(pg.shape[:2], dtype=torch.float32, device=x.device)
            bits = [(s >> d) & 1 for d in range(3)]
            for d in range(3):
                w = w * (frac[..., d] if bits[d] else 1.0 - frac[..., d])
            corners.append((0, lc, _rows(spec, pg + torch.tensor(bits, device=x.device), 0, lc),
                            w))
    if lc < nl:
        pg, frac = _cells(spec, x, lc, nl)
        fx, fy, fz = frac.unbind(-1)
        rank = torch.stack([(fy > fx).long() + (fz > fx).long(),
                            (fx >= fy).long() + (fz > fy).long(),
                            (fx >= fz).long() + (fy >= fz).long()], dim=-1)
        s1 = torch.maximum(fx, torch.maximum(fy, fz))
        s3 = torch.minimum(fx, torch.minimum(fy, fz))
        s2 = fx + fy + fz - s1 - s3
        for v, w in enumerate((1.0 - s1, s1 - s2, s2 - s3, s3)):
            corners.append((lc, nl, _rows(spec, pg + (rank < v).long(), lc, nl), w))
    return corners, oob


def hashgrid_encode_plain(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch encode, in the JAX order of operations:
    [B, 3] in [0, 1] -> [B, L*C]."""
    b, c = x.shape[0], table.shape[1]
    corners, oob = _corners(spec, x)
    out = torch.zeros((b, spec.num_levels, c), dtype=torch.float32, device=x.device)
    for lv0, lv1, rows, w in corners:
        out[:, lv0:lv1] = out[:, lv0:lv1] + table[rows] * w[..., None]
    out = torch.where(oob[:, None, None], 0.0, out)
    return out.reshape(b, spec.num_levels * c)


def hashgrid_backward_plain(
    spec: HashGridSpec, x: torch.Tensor, g: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain table gradient: ``index_add_`` of every corner's (or simplex
    vertex's) ``w * g`` into a zero [num_rows, C] table (in g's dtype);
    out-of-range points add nothing."""
    b = x.shape[0]
    c = g.shape[1] // spec.num_levels
    corners, oob = _corners(spec, x)
    g3 = torch.where(oob[:, None, None], 0.0, g.reshape(b, spec.num_levels, c))
    grad = torch.zeros((num_rows, c), dtype=g.dtype, device=x.device)
    for lv0, lv1, rows, w in corners:
        grad.index_add_(0, rows.reshape(-1), (w[..., None] * g3[:, lv0:lv1]).reshape(-1, c))
    return grad


class HashGridEncode(torch.autograd.Function):
    """Encode, differentiable in the table: forward K1, backward K2 (or
    their plain versions).  No gradient reaches the points."""

    @staticmethod
    def forward(ctx, table, x, spec, plain):
        ctx.spec, ctx.plain, ctx.num_rows = spec, plain, table.shape[0]
        ctx.save_for_backward(x)
        if not use_kernel(x, plain):
            return hashgrid_encode_plain(spec, table, x)
        return kernels.hashgrid_encode(x.contiguous(), table.contiguous(),
                                       level_table(spec, x.device))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        spec = ctx.spec
        if not use_kernel(x, ctx.plain):
            grad = hashgrid_backward_plain(spec, x, g, ctx.num_rows)
        else:
            grad = kernels.hashgrid_backward(x.contiguous(), g.contiguous(),
                                             level_table(spec, x.device), ctx.num_rows)
        return grad, None, None, None


def hashgrid_encode(
    spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor, *, plain: bool = False
) -> torch.Tensor:
    """Encode [B, 3] points in [0, 1] through all levels -> [B, L*C].

    CUDA tensors go through kernels K1 (and K2 in the backward); CPU tensors
    (or ``plain=True``, the reference a kernel check compares against)
    through the plain versions."""
    return HashGridEncode.apply(table, x, spec, plain)
