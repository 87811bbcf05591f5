"""Crafted occupancy grids for K6c (the skip distance), and a numpy emulation
of the kernel's algorithm (``nerfstyle_torch/csrc/occupancy.cu``): the
bitfield packed as 32-bit words a z-line, a CTA's slab of SLAB x-planes with a
halo of dmax - 1 planes each side, dmax - 1 rounds of a dilation (y and z
of each plane, then x across three planes, into the other buffer) over the
planes still exact, and the distance kept as a bit-sliced 4-bit counter,
expanded to bytes at the end.  The CPU tests hold
it against the JAX package's iterated dilation; the card tests hand the same
grids to the kernel.

A grid is a flat bool array ``[cascade * h^3]``, cell (c, x, y, z) at
``((c * h + x) * h + y) * h + z``.
"""

from __future__ import annotations

import numpy as np

SLAB = 2  # central x-planes a CTA (kSkipSlab)
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
    word border h > 32)."""
    out = ["empty", "full", "corner", "far corner", "edge", "centre"]
    out += [f"{d} along {a}" for d in (14, 15) for a in ("x", "y", "z", "the diagonal")]
    out += ["slab border", "inside a halo"] + (["word border"] if h > 32 else [])
    return out


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


def _count(b, v, tail):
    c = ~v
    c[..., -1] &= tail
    for i in range(3):
        k = b[i] & c
        b[i] ^= c
        c = k
    b[3] ^= c


def emulate(bits: np.ndarray, h: int, dmax: int = DMAX) -> np.ndarray:
    """The kernel's algorithm, one CTA (cascade, slab) at a time -> u8 [n]."""
    assert h % 16 == 0 and 1 <= dmax <= 15
    occ = bits.reshape(-1, h, h, h)
    out = np.empty(occ.shape, np.uint8)
    halo = dmax - 1
    tail = np.uint32((1 << (h % 32)) - 1 if h % 32 else 0xFFFFFFFF)
    zero = np.zeros((1, h, -(-h // 32)), np.uint32)
    for cas in range(occ.shape[0]):
        for x0 in range(0, h, SLAB):
            sc = min(SLAB, h - x0)
            xs, xe = max(0, x0 - halo), min(h, x0 + sc + halo)
            np_, c0 = xe - xs, x0 - xs
            a_buf = pack(occ[cas, xs:xe])  # [np, h, W]
            b_buf = np.zeros_like(a_buf)
            cnt = [np.zeros((sc, h, a_buf.shape[2]), np.uint32) for _ in range(4)]
            _count(cnt, a_buf[c0:c0 + sc].copy(), tail)
            for r in range(1, halo + 1):
                a = r if xs > 0 else 0
                b = np_ - r if xe < h else np_
                # yz(p): lines y-1..y+1 ORed, then z-dilated; then
                # B[p] = yz(p-1) | yz(p) | yz(p+1), the buffers swapped.
                y = a_buf.copy()
                y[:, 1:] |= a_buf[:, :-1]
                y[:, :-1] |= a_buf[:, 1:]
                yz = _dilate_z(y, tail)
                lo = yz[a - 1:b - 1] if a > 0 else np.concatenate([zero, yz[:b - 1]])
                hi = yz[a + 1:b + 1] if b < np_ else np.concatenate([yz[a + 1:b], zero])
                b_buf[a:b] = lo | yz[a:b] | hi
                a_buf, b_buf = b_buf, a_buf
                _count(cnt, a_buf[c0:c0 + sc].copy(), tail)
            # Expand: 4 cells a multiply a bit plane.
            cells = np.zeros((sc, h, cnt[0].shape[2] * 32), np.uint8)
            for k in range(8):
                q = np.zeros(cnt[0].shape, np.uint32)
                for j in range(4):
                    q |= _spread((cnt[j] >> np.uint32(4 * k)) & np.uint32(0xF)) << np.uint32(j)
                four = q[..., None].view(np.uint8).reshape(q.shape + (4,))
                idx = (np.arange(cnt[0].shape[2])[:, None] * 32 + 4 * k + np.arange(4)).reshape(-1)
                cells[..., idx] = four.reshape(sc, h, -1)
            out[cas, x0:x0 + sc] = cells[..., :h]
    return out.reshape(-1)
