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
applies only when ``(res+1)^3 * 512 <= table size``, and a table of
``hashgrid_spec`` holds at most ``ceil(ceil(H*s^l)^3 / 8) * 8`` rows, below
``(res+1)^3 * 512`` for the floor-law ``res`` of its level (at least
``ceil - 1``, and ``ceil^3 <= 8 (ceil - 1)^3`` for ``ceil >= 2``).
:func:`level_indices` is that law whole, with the style slot (a fourth
prime on hashed levels, ``style * stride`` on dense ones, JAX's
``_level_indices``); the encoder's :func:`_rows` is its hashed branch, the
style slot's term :func:`style_term` XOR-ed in.

:func:`corner_indices_weights` gives every level's 8 corner rows and
weights in JAX's ``[B, L, 8]`` layout (simplex weights on their corners'
slots), library API on tensor operations.

:func:`grid_initialize` copies a reference table's style-0 rows into every
style slot of a new table (JAX's ``grid_initialize``): kernel K9 on CUDA
tensors, :func:`grid_initialize_plain` on CPU tensors.

:func:`hashgrid_encode` is differentiable in the table (:class:`HashGridEncode`):
its forward launches kernel K1 and its backward kernel K2, the table
gradient (``csrc/hashgrid.cu``), on CUDA tensors; on CPU tensors they run
:func:`hashgrid_encode_plain` and :func:`hashgrid_backward_plain`.  The
gradient of the input positions is zero, as in the JAX fast VJP
(``fast_vjp=True``, the default); with ``fast_vjp=False`` the backward
also returns it, as JAX's autodiff does: kernel K2x on CUDA tensors,
autograd through :func:`hashgrid_encode_plain` on CPU tensors (``floor``
and the clamp pass no gradient, so d frac / d x = res; on simplex levels
``torch.maximum``/``torch.minimum`` halve a tie's gradient as
``jnp.maximum``/``jnp.minimum`` do, in the same nesting).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels, use_kernel

PRIMES = (1, 2654435761, 805459861)
# The style slot's prime and the style capacity of the dense law.
STYLE_PRIME = 3674653429
MAX_STYLES = 512
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


def remainder_magic(size: int) -> int:
    """K2x's constant for ``hash % size`` on a table whose size is not a
    power of two: ``M = ceil(2^64 / size)``, with which ``((M * hash) mod
    2^64 * size) >> 64`` is ``hash % size`` for every 32-bit hash (Lemire,
    Kaser and Kurz, "Faster remainder by direct computation", 2019); 0 on a
    power-of-two size, where the kernel masks."""
    return 0 if size & (size - 1) == 0 else (2**64 - 1) // size + 1


@functools.lru_cache(maxsize=16)
def position_grad_table(spec: HashGridSpec, device: torch.device) -> torch.Tensor:
    """int32 [6, L]: K2x's level table, :func:`level_table`'s four rows and
    each level's :func:`remainder_magic` as its low and high 32-bit words
    (bit patterns)."""
    magic = [remainder_magic(size) for size in spec.table_sizes]
    words = [[(m >> shift & _U32) - ((m >> shift & _U32) >> 31 << 32) for m in magic]
             for shift in (0, 32)]
    return torch.cat([level_table(spec, device),
                      torch.tensor(words, dtype=torch.int32, device=device)])


def _cells(spec: HashGridSpec, x: torch.Tensor, lv0: int, lv1: int):
    """Integer corners pg [B, L', 3] i64 and fractions [B, L', 3] of levels
    [lv0, lv1), in the JAX order of operations."""
    scale = torch.tensor(spec.resolutions[lv0:lv1], dtype=torch.float32, device=x.device)
    pos = x[:, None, :] * scale[None, :, None]
    pg = torch.minimum(torch.floor(pos).clamp(min=0.0), (scale - 1.0)[None, :, None])
    return pg.to(torch.int64), pos - pg


def style_term(style: int) -> int:
    """The style slot's hash term on hashed levels, ``(style * 3674653429)
    & 0xFFFFFFFF``, for any integer style (JAX's ``_level_indices``
    computes it in Python alike and checks no range)."""
    return (int(style) * STYLE_PRIME) & _U32


def _rows(spec: HashGridSpec, coords, lv0: int, lv1: int, style: int = 0) -> torch.Tensor:
    """Table rows [B, L'] i64 of integer corners [B, L', 3] at levels [lv0,
    lv1): the uint32 XOR hash with the style term (in int64, masked), %
    size + offset.  Every level of a ``hashgrid_spec`` hashes (see the
    module docstring), so the dense branch of the law never applies."""
    dev = coords.device
    sizes = torch.tensor(spec.table_sizes[lv0:lv1], dtype=torch.int64, device=dev)
    offs = torch.tensor(spec.offsets[lv0:lv1], dtype=torch.int64, device=dev)
    h = torch.full(coords.shape[:2], style_term(style), dtype=torch.int64, device=dev)
    for d in range(3):
        h = h ^ ((coords[..., d] * PRIMES[d]) & _U32)
    return h % sizes + offs


def _corners(spec: HashGridSpec, x: torch.Tensor, style: int = 0):
    """Every (point, level)'s corners (trilinear levels, 8) or simplex
    vertices (4) at a style slot, in the JAX order of operations: [(lv0,
    lv1, rows [B, L'] i64, weights [B, L'] f32)], one entry a corner slot of
    the levels [lv0, lv1), and the out-of-range mask [B]."""
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
            corners.append((0, lc, _rows(spec, pg + torch.tensor(bits, device=x.device), 0, lc,
                                         style), w))
    if lc < nl:
        pg, frac = _cells(spec, x, lc, nl)
        rank, vertex_w = _simplex(frac)
        for v, w in enumerate(vertex_w):
            corners.append((lc, nl, _rows(spec, pg + (rank < v).long(), lc, nl, style), w))
    return corners, oob


def _simplex(frac: torch.Tensor):
    """The Freudenthal simplex of cell fractions [..., 3]: each axis's
    descending rank [..., 3] i64 (ties x before y before z) and the four
    vertices' weights (1 - s1, s1 - s2, s2 - s3, s3), in the JAX order of
    operations."""
    fx, fy, fz = frac.unbind(-1)
    rank = torch.stack([(fy > fx).long() + (fz > fx).long(),
                        (fx >= fy).long() + (fz > fy).long(),
                        (fx >= fz).long() + (fy >= fz).long()], dim=-1)
    s1 = torch.maximum(fx, torch.maximum(fy, fz))
    s3 = torch.minimum(fx, torch.minimum(fy, fz))
    s2 = fx + fy + fz - s1 - s3
    return rank, (1.0 - s1, s1 - s2, s2 - s3, s3)


def corner_indices_weights(spec: HashGridSpec, x: torch.Tensor, style: int = 0):
    """Every level's 8 corner rows and weights in JAX's layout (JAX's
    ``corner_indices_weights``): ``(flat_idx [B, L, 8] i32, weights [B, L,
    8] f32, oob [B] bool)``, slot s the corner with bits ``(s >> d) & 1``
    on axis d.  Weights are trilinear on the levels below
    ``simplex_start``; on the levels from it the four simplex vertices'
    weights sit on their corners' slots and the other four slots are 0.
    Library API: K1, K2 and K2x find the corners inside the kernel, so this
    stays tensor operations (the hash in int64, masked to 32 bits) on
    either device."""
    nl, lc = spec.num_levels, spec.simplex_start
    corners, oob = _corners(spec, x, style)
    pg, frac = _cells(spec, x, 0, nl)
    bits = torch.tensor([[(s >> d) & 1 for d in range(3)] for s in range(8)], device=x.device)
    flat_idx = torch.stack([_rows(spec, pg + bits[s], 0, nl, style) for s in range(8)], dim=-1)
    weights = torch.zeros(flat_idx.shape, dtype=torch.float32, device=x.device)
    if lc > 0:
        weights[:, :lc] = torch.stack([w for _, _, _, w in corners[:8]], dim=-1)
    if lc < nl:
        rank, vertex_w = _simplex(frac[:, lc:])
        slots = [((rank < v).long() << torch.arange(3, device=x.device)).sum(-1)
                 for v in range(4)]
        for slot, w in zip(slots, vertex_w):
            weights[:, lc:].scatter_(-1, slot[..., None], w[..., None])
    return flat_idx.to(torch.int32), weights, oob


def hashgrid_encode_plain(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor,
                          style: int = 0) -> torch.Tensor:
    """Plain PyTorch encode at a style slot, in the JAX order of operations:
    [B, 3] in [0, 1] -> [B, L*C].  Differentiable in ``table`` and ``x``
    (autograd: the plain version of K2 and of K2x)."""
    b, c = x.shape[0], table.shape[1]
    corners, oob = _corners(spec, x, style)
    out = torch.zeros((b, spec.num_levels, c), dtype=torch.float32, device=x.device)
    for lv0, lv1, rows, w in corners:
        out[:, lv0:lv1] = out[:, lv0:lv1] + table[rows] * w[..., None]
    out = torch.where(oob[:, None, None], 0.0, out)
    return out.reshape(b, spec.num_levels * c)


def hashgrid_backward_plain(
    spec: HashGridSpec, x: torch.Tensor, g: torch.Tensor, num_rows: int, style: int = 0
) -> torch.Tensor:
    """Plain table gradient: ``index_add_`` of every corner's (or simplex
    vertex's) ``w * g`` into a zero [num_rows, C] table (in g's dtype);
    out-of-range points add nothing."""
    b = x.shape[0]
    c = g.shape[1] // spec.num_levels
    corners, oob = _corners(spec, x, style)
    g3 = torch.where(oob[:, None, None], 0.0, g.reshape(b, spec.num_levels, c))
    grad = torch.zeros((num_rows, c), dtype=g.dtype, device=x.device)
    for lv0, lv1, rows, w in corners:
        grad.index_add_(0, rows.reshape(-1), (w[..., None] * g3[:, lv0:lv1]).reshape(-1, c))
    return grad


def hashgrid_position_grad_plain(spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor,
                                 g: torch.Tensor, style: int = 0) -> torch.Tensor:
    """Plain K2x: d x [B, 3] of ``<g, encode(x)>``, by autograd through
    :func:`hashgrid_encode_plain`."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = hashgrid_encode_plain(spec, table.detach(), xg, style)
        (dx,) = torch.autograd.grad(out, xg, g)
    return dx


class HashGridEncode(torch.autograd.Function):
    """Encode, differentiable in the table: forward K1, backward K2 (or
    their plain versions); with ``fast_vjp`` False (CUDA tensors only:
    :func:`hashgrid_encode` takes the plain version's autograd otherwise)
    the backward also gives the points' gradient (K2x), else zero for them
    (JAX's fast VJP)."""

    @staticmethod
    def forward(ctx, table, x, spec, style, fast_vjp, plain):
        ctx.spec, ctx.plain, ctx.num_rows = spec, plain, table.shape[0]
        ctx.style, ctx.fast_vjp = style, fast_vjp
        if fast_vjp:
            ctx.save_for_backward(x)
        else:  # K2x reads the table's rows
            ctx.save_for_backward(x, table)
        if not use_kernel(x, plain):
            return hashgrid_encode_plain(spec, table, x, style)
        return kernels.hashgrid_encode(x.contiguous(), table.contiguous(),
                                       level_table(spec, x.device), style_term(style))

    @staticmethod
    def backward(ctx, g):
        x = ctx.saved_tensors[0]
        spec, style = ctx.spec, ctx.style
        kernel = use_kernel(x, ctx.plain)
        grad = dx = None
        if ctx.needs_input_grad[0]:
            if not kernel:
                grad = hashgrid_backward_plain(spec, x, g, ctx.num_rows, style)
            else:
                grad = kernels.hashgrid_backward(x.contiguous(), g.contiguous(),
                                                 level_table(spec, x.device), ctx.num_rows,
                                                 style_term(style))
        if ctx.needs_input_grad[1] and not ctx.fast_vjp:  # else zero (None)
            dx = kernels.hashgrid_position_grad(
                x.contiguous(), g.contiguous(), ctx.saved_tensors[1].contiguous(),
                position_grad_table(spec, x.device), style_term(style))
        return grad, dx, None, None, None, None


def hashgrid_encode(
    spec: HashGridSpec, table: torch.Tensor, x: torch.Tensor, *, style: int = 0,
    fast_vjp: bool = True, plain: bool = False,
) -> torch.Tensor:
    """Encode [B, 3] points in [0, 1] through all levels at style slot
    ``style`` -> [B, L*C].

    CUDA tensors go through kernel K1 (and K2 in the backward; K2x too with
    ``fast_vjp=False``); CPU tensors (or ``plain=True``, the reference a
    kernel check compares against) through the plain versions.  With
    ``fast_vjp`` (the default) the points get a zero gradient, as in JAX's
    fast VJP; without it their gradient, as JAX's autodiff gives it."""
    if not fast_vjp and not use_kernel(x, plain):
        return hashgrid_encode_plain(spec, table, x, style)
    return HashGridEncode.apply(table, x, spec, style, fast_vjp, plain)


# ---------------------------------------------------------------------------
# The style slot and grid_initialize
# ---------------------------------------------------------------------------


def dense_level(res: int, table_size: int) -> bool:
    """True where the index law of a level of resolution ``res`` in a table
    of ``table_size`` rows is dense (every axis and the style slot fit the
    table), False where it hashes: the static decision of JAX's
    ``_level_indices``."""
    stride = 1
    for _ in range(3):
        if stride > table_size:
            return False
        stride *= res + 1
    if stride <= table_size:
        stride *= MAX_STYLES
    return stride <= table_size


def _yz_part(y: torch.Tensor, z: torch.Tensor, side: int, dense: bool) -> torch.Tensor:
    """The y and z terms of a level's index law (i64, masked corners):
    ``y * side + z * side^2`` on a dense level, the XOR of their
    spatial-prime products on a hashed one."""
    if dense:
        return y * side + z * side * side
    return ((y * PRIMES[1]) & _U32) ^ ((z * PRIMES[2]) & _U32)


def _law_rows(x: torch.Tensor, yz: torch.Tensor, res: int, table_size: int, dense: bool,
              style: int) -> torch.Tensor:
    """Rows (without the level's offset) of corners with x coordinate ``x``
    and y, z part ``yz`` (:func:`_yz_part`), broadcast, at one style."""
    if dense:
        h = (x + yz + style * (res + 1) ** 3) & _U32
    else:
        h = x ^ yz ^ ((style * STYLE_PRIME) & _U32)
    return h % table_size


def level_indices(pos: torch.Tensor, res: int, table_size: int, style: int = 0) -> torch.Tensor:
    """Row index (without the level's offset) of integer corners ``pos``
    [..., 3] at one level: JAX's ``_level_indices`` in uint32 arithmetic,
    computed in int64 and masked.  Dense levels: ``x + y*(res+1) +
    z*(res+1)^2 + style*(res+1)^3``; hashed levels: the spatial-prime XOR
    with ``(style * 3674653429) & 0xFFFFFFFF``; then ``% table_size``."""
    pg = pos.to(torch.int64) & _U32
    dense = dense_level(res, table_size)
    return _law_rows(pg[..., 0], _yz_part(pg[..., 1], pg[..., 2], res + 1, dense), res,
                     table_size, dense, style)


def _corner_ids(res: int, start: int, stop: int, device) -> torch.Tensor:
    """Integer corners [n, 3] of ids [start, stop) of the (res+1)^3 lattice,
    x slowest, as JAX's grid_initialize enumerates them."""
    side = res + 1
    ids = torch.arange(start, stop, dtype=torch.int64, device=device)
    return torch.stack([ids // (side * side), (ids // side) % side, ids % side], dim=-1)


def _set_rows(out_level: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> None:
    """``out_level[rows] = vals`` where ``rows`` may repeat, each row written
    whole from its last occurrence: an indexed store of repeated rows
    writes element by element and may mix two sources' channels in a row."""
    n = rows.shape[0]
    last = torch.full((out_level.shape[0],), -1, dtype=torch.int64, device=rows.device)
    last.scatter_reduce_(0, rows, torch.arange(n, device=rows.device), reduce="amax")
    hit = torch.nonzero(last >= 0).squeeze(1)
    out_level[hit] = vals[last[hit]]


def grid_initialize_plain(spec: HashGridSpec, ref_spec: HashGridSpec, ref_table: torch.Tensor,
                          num_styles: int = 64, chunk: int = 1 << 24) -> torch.Tensor:
    """Plain K9: for each level and each integer corner in [0, res]^3, the
    reference table's style-0 row written at the row of every style slot
    ``s < num_styles`` of a new zero table [spec.total_params, C].  The
    corners go in x-planes of about ``chunk`` corners, each (y, z) column's
    part of the index law formed once a level (:func:`_yz_part`).
    Colliding writes leave one of their rows whole (the last in corner
    order): which one is arbitrary in JAX and in K9."""
    c, dev = ref_table.shape[1], ref_table.device
    out = torch.zeros((spec.total_params, c), dtype=ref_table.dtype, device=dev)
    for lvl in range(spec.num_levels):
        res, side = spec.resolutions[lvl], spec.resolutions[lvl] + 1
        ref_size, size = ref_spec.table_sizes[lvl], spec.table_sizes[lvl]
        ref_dense, dense = dense_level(res, ref_size), dense_level(res, size)
        y = torch.arange(side, dtype=torch.int64, device=dev)[:, None]
        z = torch.arange(side, dtype=torch.int64, device=dev)[None, :]
        ref_yz = _yz_part(y, z, side, ref_dense).reshape(-1)
        yz = _yz_part(y, z, side, dense).reshape(-1)
        out_level = out[spec.offsets[lvl]:spec.offsets[lvl] + size]
        planes = max(1, chunk // side**2)
        for x0 in range(0, side, planes):
            x = torch.arange(x0, min(x0 + planes, side), dtype=torch.int64, device=dev)[:, None]
            vals = ref_table[_law_rows(x, ref_yz, res, ref_size, ref_dense, 0).reshape(-1)
                             + ref_spec.offsets[lvl]]
            for s in range(num_styles):
                _set_rows(out_level, _law_rows(x, yz, res, size, dense, s).reshape(-1), vals)
    return out


def grid_init_levels(spec: HashGridSpec, ref_spec: HashGridSpec, device) -> torch.Tensor:
    """int32 [7, L]: each level's resolution, then the reference table's
    size, row offset and dense flag, then the new table's: the level
    constants K9 reads."""
    rows = [spec.resolutions,
            ref_spec.table_sizes[:spec.num_levels], ref_spec.offsets[:spec.num_levels],
            [int(dense_level(r, t)) for r, t in zip(spec.resolutions, ref_spec.table_sizes)],
            spec.table_sizes, spec.offsets[:-1],
            [int(dense_level(r, t)) for r, t in zip(spec.resolutions, spec.table_sizes)]]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def grid_initialize(spec: HashGridSpec, ref_spec: HashGridSpec, ref_table: torch.Tensor,
                    num_styles: int = 64, *, plain: bool = False) -> torch.Tensor:
    """Multi-style table init: a new [spec.total_params, C] table holding,
    at the row of every style slot of every corner, the corner's style-0
    row of ``ref_table`` (laid out by ``ref_spec``, with at least
    ``spec.num_levels`` levels).  Kernel K9 on CUDA tensors, the plain
    version on CPU tensors (or with ``plain=True``)."""
    if not 1 <= num_styles <= MAX_STYLES:
        raise ValueError(f"num_styles must be in 1..{MAX_STYLES}, got {num_styles}")
    if ref_spec.num_levels < spec.num_levels or ref_table.shape[0] != ref_spec.total_params:
        raise ValueError("ref_table must hold ref_spec's rows, for every level of spec")
    if not use_kernel(ref_table, plain):
        return grid_initialize_plain(spec, ref_spec, ref_table, num_styles)
    return kernels.grid_initialize(ref_table.contiguous(),
                                   grid_init_levels(spec, ref_spec, ref_table.device),
                                   num_styles, spec.total_params)
