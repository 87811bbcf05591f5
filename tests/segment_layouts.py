"""Crafted ray layouts for K7b (the backward of the per-ray channel sum), and
a numpy emulation of the kernel's work split (``nerfstyle_torch/csrc/
composite.cu``): the stream is cut into tiles of TILE samples; a tile finds
its first and last ray by a warp's 32-way search of the offsets; each of
its rays marks the sample it starts at, and a sample's ray is the running
max of the marks; a thread a sample writes its C products into a staged
piece of OUT_FLOATS floats, copied to d ch flat, 16 bytes a thread.  The
CPU tests hold the emulation against JAX's VJP of ``jax.ops.segment_sum``;
the card tests hand the same layouts to the kernel.  Imports no JAX.
"""

import numpy as np

TILE = 1024  # kBwdTile
OUT_FLOATS = 4096  # kBwdOutFloats
MAX_CHANNELS = 64
CHANNELS = (3, 4, 7, 11)
LAYOUTS = ("empty rays", "across a tile edge", "one ray longer than a tile", "style-like",
           "more rays than a tile stages", "one sample")


def counts(name: str, rng) -> np.ndarray:
    """Samples a ray for the layout."""
    if name == "empty rays":
        # Runs of empty rays at the start, inside and at the end; rays of
        # 0-3 samples between.
        c = np.concatenate([np.zeros(300, np.int64), rng.integers(0, 4, size=900)])
        c[500:520] = 0
        return np.concatenate([c, np.zeros(7, np.int64)])
    if name == "across a tile edge":
        # Rays of 9 samples and a 40-sample ray over sample TILE.
        c = np.full(300, 9, np.int64)
        c[100:110] = 0
        c[113] = 40
        return c
    if name == "one ray longer than a tile":
        c = rng.integers(0, 5, size=400)
        c[150] = 3 * TILE + 77
        c[151] = 0
        return c
    if name == "style-like":
        # ~26 samples a ray on an object's rows, the background's rays
        # empty (a style pose cache: ~84% of rays empty).
        c = rng.poisson(26.0, size=(40, 120))
        c[:, :90] = 0
        c[:5] = 0
        return c.reshape(-1)
    if name == "more rays than a tile stages":
        # 3000 empty rays between two short runs of samples in one tile.
        c = np.zeros(3200, np.int64)
        c[:50] = 3
        c[3050:3100] = 4
        return c
    if name == "one sample":
        c = np.zeros(500, np.int64)
        c[257] = 1
        return c
    raise ValueError(name)


def layout(name: str, channels: int, seed: int = 0):
    """(w [S], ch [S, C], g [N, C] f32, offsets [N+1] i64)."""
    rng = np.random.default_rng(seed + channels)
    c = counts(name, rng)
    offsets = np.concatenate([[0], np.cumsum(c)]).astype(np.int64)
    s, n = int(offsets[-1]), c.shape[0]
    w = rng.uniform(0, 1, s).astype(np.float32)
    ch = rng.normal(size=(s, channels)).astype(np.float32)
    g = rng.normal(size=(n, channels)).astype(np.float32)
    return w, ch, g, offsets


def warp_last_ray_at_most(offsets: np.ndarray, n: int, key: int) -> int:
    """The kernel's warp search: the last r of [0, n) with offsets[r] <=
    key, 32 probes a step."""
    lo, hi = 0, n - 1
    lanes = np.arange(32)
    while lo < hi:
        step = (hi - lo + 32) // 32
        p = lo + lanes * step
        ok = (p <= hi) & (offsets[np.minimum(p, hi)] <= key)
        nxt = lo + int(np.flatnonzero(ok).max()) * step
        hi, lo = min(hi, nxt + step - 1), nxt
    return lo


def emulate(w, ch, g, offsets, need_dw: bool):
    """The kernel's split -> (d_ch [S, C], d_w [S] or None, writes [S*C]:
    how many times each float of d ch was written)."""
    n_rays, c = g.shape
    s = w.shape[0]
    d_ch = np.zeros(s * c, np.float32)
    writes = np.zeros(s * c, np.int64)
    d_w = np.zeros(s, np.float32) if need_dw else None
    for s0 in range(0, s, TILE):
        n = min(TILE, s - s0)
        r0 = warp_last_ray_at_most(offsets, n_rays, s0)
        nr = warp_last_ray_at_most(offsets, n_rays, s0 + n - 1) - r0 + 1
        q = np.arange(n)
        # Marks: each non-empty ray after the first at the sample it starts
        # at; a sample's ray is the running max (the first ray holds 0).
        marks = np.zeros(n, np.int64)
        a = offsets[r0 + 1:r0 + nr] - s0
        live = a < offsets[r0 + 2:r0 + nr + 1] - s0
        marks[a[live]] = np.arange(1, nr)[live]
        ray = np.maximum.accumulate(marks)
        gr = g[r0:r0 + nr]
        if need_dw:
            acc = np.zeros(n, np.float32)
            for k in range(c):
                acc = acc + ch[s0 + q, k] * gr[ray, k]
            d_w[s0 + q] = acc
        piece = OUT_FLOATS // c & ~3  # samples a staged piece: a multiple of 4
        for p0 in range(0, n, piece):
            m = min(piece, n - p0)
            out = (w[s0 + p0:s0 + p0 + m, None] * gr[ray[p0:p0 + m]]).reshape(-1)
            start = (s0 + p0) * c
            assert start % 4 == 0  # a 16-byte boundary of d ch
            d_ch[start:start + m * c] = out
            writes[start:start + m * c] += 1
    return d_ch.reshape(s, c), d_w, writes
