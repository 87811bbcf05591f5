"""Crafted occupancy grids for K6c (the skip distance), and a numpy emulation
of the kernel's algorithm (``nerfstyle_torch/csrc/occupancy.cu``,
:func:`emulate_tiles`): (x, y) tiles with a halo of dmax - 1 cells each
side clipped at the faces, z-lines packed as 32-bit words and cut into
chunks with a word of halo each side, rounds of dilation over the lines
still exact, and the distance's bits flipped round by round.  The CPU
tests hold it against the JAX package's iterated dilation; the card tests
hand the same grids to the kernel.

A grid is a flat bool array ``[cascade * h^3]``, cell (c, x, y, z) at
``((c * h + x) * h + y) * h + z``.
"""

from __future__ import annotations

import numpy as np

SLAB = 2  # planes SLAB - 1 and SLAB: a border between two x-slabs of the grid
DMAX = 15  # SKIP_DMAX


def _cells(h: int, cascade: int, points) -> np.ndarray:
    occ = np.zeros((cascade, h, h, h), bool)
    for p in points:
        occ[p] = True
    return occ.reshape(-1)


def _points(name: str, h: int, cascade: int):
    """The occupied cells of a crafted grid, or None for the full grid."""
    m, e, last = h // 2, h - 1, cascade - 1
    if name == "empty":
        return []
    if name == "full":
        return None
    fixed = {
        "corner": [(0, 0, 0, 0)],
        "far corner": [(last, e, e, e)],
        "edge": [(0, m, 0, e)],
        "centre": [(last, m, m, m)],
        # Planes SLAB - 1 and SLAB of one cascade: two CTAs' slabs.
        "slab border": [(0, SLAB - 1, 3, 5), (0, SLAB, e - 3, e - 5)],
        # Inside the halo of the slab of plane m, on either side.
        "inside a halo": [(last, min(e, m + SLAB + 13), m, 1), (0, max(0, m - 14), 1, m)],
        # z-word borders: cells 31 and 32 of a line.
        "word border": [(0, m, m, 31), (last, 3, e, 32)],
    }
    if name in fixed:
        return fixed[name]
    # Occupied cells 14 and 15 cells from a probe cell at the origin, along
    # each axis and the diagonal: the probe reads 14 and 15.
    d, _, along = name.split(" ", 2)
    d = int(d)
    return [{"x": (0, d, 0, 0), "y": (0, 0, d, 0), "z": (0, 0, 0, d),
             "the diagonal": (0, d, d, d)}[along]]


def names(h: int):
    """The crafted grids of a grid size (probe distances need h >= 16; the
    slab border and halo cells h >= 6; the word border h > 32)."""
    out = ["empty", "full", "corner", "far corner", "edge", "centre"]
    if h >= 16:
        out += [f"{d} along {a}" for d in (14, 15) for a in ("x", "y", "z", "the diagonal")]
    if h >= 6:
        out += ["slab border", "inside a halo"]
    return out + (["word border"] if h > 32 else [])


def grid(name: str, h: int, cascade: int) -> np.ndarray:
    """A crafted grid: flat bool [cascade * h^3]."""
    points = _points(name, h, cascade)
    if points is None:
        return np.ones(cascade * h**3, bool)
    return _cells(h, cascade, points)


def sparse_random(h: int = 128, cascade: int = 2, density: float = 2e-4, seed: int = 3):
    """A sparse random grid, distances up to the cap."""
    return np.random.default_rng(seed).random(cascade * h**3) < density


def _nibble(x: np.ndarray) -> np.ndarray:
    """Four bool bytes of a uint32 -> 4 bits (the kernel's multiply)."""
    return ((x * np.uint32(0x01020408)) >> np.uint32(24)) & np.uint32(0xF)


def _spread(x: np.ndarray) -> np.ndarray:
    """4 bits -> 4 bytes of 0 or 1 (the kernel's multiply)."""
    return (x * np.uint32(0x00204081)) & np.uint32(0x01010101)


def pack(lines: np.ndarray) -> np.ndarray:
    """[..., h] bool lines -> [..., W] uint32 words, 4 bytes a nibble."""
    h = lines.shape[-1]
    w = -(-h // 32)
    b = np.zeros(lines.shape[:-1] + (w * 32,), np.uint8)
    b[..., :h] = lines
    quads = b.reshape(lines.shape[:-1] + (w, 8, 4)).copy().view("<u4")[..., 0]  # [..., W, 8]
    nib = _nibble(quads.astype(np.uint32))
    return np.bitwise_or.reduce(nib << (np.uint32(4) * np.arange(8, dtype=np.uint32)), axis=-1)


def _dilate_z(v: np.ndarray, tail: np.uint32) -> np.ndarray:
    one, s31 = np.uint32(1), np.uint32(31)
    d = v | (v << one) | (v >> one)
    d[..., 1:] |= v[..., :-1] >> s31
    d[..., :-1] |= v[..., 1:] << s31
    d[..., -1] &= tail
    return d


def tiling(h: int, tile: int):
    """The kernel's tiling of a grid size at a tile side: (tile, words a
    line chunk, central words of it) -- whole lines up to 4 words, else
    chunks of 2 central words and a word of halo each side."""
    w = -(-h // 32)
    return (tile, w, w) if w <= 4 else (tile, 4, 2)


def emulate_tiles(bits: np.ndarray, h: int, tile: int, nw: int, wc: int,
                  dmax: int = DMAX) -> np.ndarray:
    """K6c's scheme (``skipdist_kernel`` in csrc/occupancy.cu) -> u8 [n], one
    CTA (cascade, x tile, y tile, chunk of z-words) at a time: central
    cells ``tile`` a side, ``wc`` central words a line chunk of ``nw`` words
    (a word of halo each side when nw > wc; the kernel takes nw = wc = W up
    to W = 4, else nw = 4 and wc = 2).  A chunk's words past the grid are 0
    and the cells past h in a tail word are not masked: no occupied cell
    lies outside the grid, so dilating into those cells changes no cell
    inside it.  Rounds compute only the lines still exact: r cells in from
    each halo side that is not a face.  The count of rounds 0..dmax-1 that
    have not covered a cell keeps its bit j flipped at round r when 2^j
    divides r + 1."""
    assert 1 <= dmax <= 15 and nw >= wc
    occ = bits.reshape(-1, h, h, h)
    out = np.empty(occ.shape, np.uint8)
    halo, w_all, zoff = dmax - 1, -(-h // 32), (nw - wc + 1) // 2
    words = pack(occ)  # [cascade, h, h, W]
    for cas in range(occ.shape[0]):
        for x0 in range(0, h, tile):
            for y0 in range(0, h, tile):
                for w0 in range(0, w_all, wc):
                    sx, sy, swc = min(tile, h - x0), min(tile, h - y0), min(wc, w_all - w0)
                    xs, ys = max(0, x0 - halo), max(0, y0 - halo)
                    xe, ye = min(h, x0 + sx + halo), min(h, y0 + sy + halo)
                    cx, cy = x0 - xs, y0 - ys
                    a_buf = np.zeros((xe - xs, ye - ys, nw), np.uint32)
                    for j in range(nw):
                        word = w0 - zoff + j
                        if 0 <= word < w_all:
                            a_buf[..., j] = words[cas, xs:xe, ys:ye, word]
                    cnt = np.zeros((4, sx, sy, nw), np.uint32)
                    central = (slice(cx, cx + sx), slice(cy, cy + sy))
                    for r in range(halo + 1):
                        if r:
                            ax, ay = (r if xs > 0 else 0), (r if ys > 0 else 0)
                            bx = a_buf.shape[0] - r if xe < h else a_buf.shape[0]
                            by = a_buf.shape[1] - r if ye < h else a_buf.shape[1]
                            y = a_buf.copy()
                            y[:, 1:] |= a_buf[:, :-1]
                            y[:, :-1] |= a_buf[:, 1:]
                            yz = _dilate_z(y, np.uint32(0xFFFFFFFF))
                            pad = np.zeros((1,) + yz.shape[1:], np.uint32)
                            yz = np.concatenate([pad, yz, pad])  # planes -1 .. nx
                            b_buf = a_buf.copy()
                            b_buf[ax:bx, ay:by] = (yz[ax:bx] | yz[ax + 1:bx + 1]
                                                   | yz[ax + 2:bx + 2])[:, ay:by]
                            a_buf = b_buf
                        for j in range(4):
                            if (r + 1) % (1 << j) == 0:
                                cnt[j] ^= ~a_buf[central]
                    z = np.arange(32 * w0, min(h, 32 * (w0 + swc)))
                    word, bit = z // 32 - w0 + zoff, (z % 32).astype(np.uint32)
                    val = sum(((cnt[j][..., word] >> bit) & np.uint32(1)) << np.uint32(j)
                              for j in range(4))
                    out[cas, x0:x0 + sx, y0:y0 + sy, z[0]:z[-1] + 1] = val
    return out.reshape(-1)
