"""Multiresolution hash-grid encoding (counterpart of
``nerfstyle_tpu/ops/hashgrid.py``).

Same geometry laws as the JAX package: per-level kernel resolution
``floor(2^(l*log2(s)) * H)`` in fp32, table sizes by the ceil law
``min(2^log2_size, ceil(H*s^l)^3)`` rounded up to a multiple of 8, the
spatial-prime XOR hash in uint32 ``% size + offset``, trilinear weights, zero
features outside ``[0, 1]^3`` and level-major ``[B, L*C]`` output.

Every level takes the hash path: the dense index law of the JAX module
applies only when ``(res+1)^3 * 512 <= table size``, and since ``table size
<= ceil(H*s^l)^3 <= (res+1)^3`` that never holds.  Simplex levels
(``simplex_from >= 0``) are not ported yet and raise.

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


def _check_trilinear(spec: HashGridSpec) -> None:
    if 0 <= spec.simplex_from < spec.num_levels:
        raise NotImplementedError(
            f"simplex levels (simplex_from={spec.simplex_from}) are not ported yet"
        )


@functools.lru_cache(maxsize=16)
def level_table(spec: HashGridSpec, device: torch.device) -> torch.Tensor:
    """int32 [3, L]: level resolutions, table sizes (rows) and row offsets —
    the level constants K1 reads."""
    rows = [spec.resolutions, spec.table_sizes, spec.offsets[:-1]]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _corners(spec: HashGridSpec, x: torch.Tensor):
    """The 8 trilinear corners of every (point, level), in the JAX order of
    operations: [(rows [B, L] i64, weights [B, L] f32)] and the
    out-of-range mask [B]."""
    _check_trilinear(spec)
    b, dev = x.shape[0], x.device
    scale = torch.tensor(spec.resolutions, dtype=torch.float32, device=dev)
    sizes = torch.tensor(spec.table_sizes, dtype=torch.int64, device=dev)
    offs = torch.tensor(spec.offsets[:-1], dtype=torch.int64, device=dev)
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    pos = x[:, None, :] * scale[None, :, None]  # [B, L, 3]
    pg = torch.minimum(torch.floor(pos).clamp(min=0.0), (scale - 1.0)[None, :, None])
    frac = pos - pg
    pgi = pg.to(torch.int64)
    corners = []
    for s in range(8):
        w = torch.ones((b, spec.num_levels), dtype=torch.float32, device=dev)
        h = torch.zeros((b, spec.num_levels), dtype=torch.int64, device=dev)
        for d in range(3):
            bit = (s >> d) & 1
            w = w * (frac[..., d] if bit else 1.0 - frac[..., d])
            h = h ^ (((pgi[..., d] + bit) * PRIMES[d]) & _U32)
        corners.append((h % sizes + offs, w))
    return corners, oob


def hashgrid_encode_plain(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch encode, in the JAX order of operations:
    [B, 3] in [0, 1] -> [B, L*C]."""
    b, c = x.shape[0], table.shape[1]
    corners, oob = _corners(spec, x)
    out = torch.zeros((b, spec.num_levels, c), dtype=torch.float32, device=x.device)
    for rows, w in corners:
        out = out + table[rows] * w[..., None]
    out = torch.where(oob[:, None, None], 0.0, out)
    return out.reshape(b, spec.num_levels * c)


def hashgrid_backward_plain(
    spec: HashGridSpec, x: torch.Tensor, g: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain table gradient: ``index_add_`` of every corner's ``w * g`` into
    a zero [num_rows, C] table (in g's dtype); out-of-range points add
    nothing."""
    b = x.shape[0]
    c = g.shape[1] // spec.num_levels
    corners, oob = _corners(spec, x)
    g3 = torch.where(oob[:, None, None], 0.0, g.reshape(b, spec.num_levels, c))
    grad = torch.zeros((num_rows, c), dtype=g.dtype, device=x.device)
    for rows, w in corners:
        grad.index_add_(0, rows.reshape(-1), (w[..., None] * g3).reshape(-1, c))
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
        _check_trilinear(spec)
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
