"""JPEG decoder (numpy and the standard library only).

Reads what the JAX package reads through PIL for the repository's images:
Huffman-coded JPEGs of 8-bit samples, sequential (SOF0 and SOF1) or
progressive (SOF2), gray (one component), YCbCr (three; RGB when an Adobe
marker or the component ids say so) or CMYK (four, Adobe transform 0 or no
Adobe marker), each component's sampling factors 1 or 2 on each axis
(4:4:4, 4:2:2, 4:2:0, 4:4:0), restart intervals, interleaved or one scan a
component, any image size.  It decodes as libjpeg does under PIL's
defaults, so that the result is PIL's to the bit:

* a progressive file's four kinds of scan (``jdphuff.c``: DC first, DC
  refinement, AC first with end-of-band runs, AC refinement with its
  correction bits) fill the same coefficient store as a sequential file's
  scans; spectral selection, successive approximation and AC scans over a
  component's whole block grid included.  libjpeg's block smoothing
  (``jdcoefct.c``) applies only while some coefficient's successive
  approximation is incomplete, so a file whose scans leave any
  coefficient incomplete raises ``ValueError``;
* the accurate integer inverse DCT (``JDCT_ISLOW``, ``jidctint.c``) and the
  post-IDCT range limit of ``jdmaster.c``;
* fancy (triangle) upsampling of downsampled components (``jdsample.c``:
  h2v1, h1v2, h2v2, with the edge samples replicated, and plain
  replication for a component no wider than 2 samples);
* the fixed-point YCbCr -> RGB tables of ``jdcolor.c``;
* CMYK samples as stored, then inverted as PIL inverts every 4-component
  JPEG (it assumes the Adobe convention of inverted storage): PIL's
  ``[H, W, 4]`` array.

EXIF orientation is not applied (nor is it by ``PIL.Image.open``).
Arithmetic-coded, lossless and hierarchical JPEGs, 12-bit samples and YCCK
images (Adobe transform 2) raise ``ValueError`` naming the format.

The Huffman decode reads 16 bits at a time through a 65,536-entry lookup
table a code table (symbol and code length in one entry), and each
segment's bytes as a list of 32-bit big-endian windows, one a byte.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

# Zigzag position k -> natural (row-major) index in the 8x8 block.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
_ZZ = ZIGZAG.tolist()

_UNSUPPORTED = {
    0xC3: "lossless JPEG", 0xC5: "hierarchical JPEG",
    0xC6: "hierarchical progressive JPEG", 0xC7: "hierarchical lossless JPEG",
    0xC9: "arithmetic-coded JPEG", 0xCA: "arithmetic-coded progressive JPEG",
    0xCB: "arithmetic-coded lossless JPEG", 0xCD: "arithmetic-coded hierarchical JPEG",
    0xCE: "arithmetic-coded hierarchical progressive JPEG",
    0xCF: "arithmetic-coded hierarchical lossless JPEG", 0xCC: "arithmetic-coded JPEG",
}
# The end of a scan's entropy-coded data: a marker that is not a restart
# marker (0xFF00 is a stuffed 0xFF, 0xFFFF fill).
_SCAN_END = re.compile(rb"\xff[\x01-\xcf\xd8-\xfe]")
_RST = re.compile(rb"\xff[\xd0-\xd7]")


def is_jpeg(head: bytes) -> bool:
    """True for the first bytes of a JPEG file (its SOI marker)."""
    return head[:3] == b"\xff\xd8\xff"


def read_jpeg(path: Union[str, Path]) -> np.ndarray:
    """A JPEG file -> [H, W, C] uint8 (C = 1 for gray, 3 for RGB, 4 for
    CMYK as PIL reads it)."""
    return decode_jpeg(Path(path).read_bytes(), str(path))


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "td", "ta", "bw", "bh", "dw", "dh", "coef", "pred")

    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.td = self.ta = 0
        self.pred = 0


def _huffman_table(counts: List[int], symbols: List[int]) -> List[int]:
    """65,536 entries: for every 16-bit window, (symbol << 5) | code length
    of the code it starts with (0 where no code does)."""
    table = np.zeros(1 << 16, dtype=np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = (symbols[k] << 5) | length
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _windows(data: bytes) -> List[int]:
    """For every byte offset, the 32 bits from there, big-endian (zeros past
    the end, as libjpeg reads zeros once a segment's data runs out)."""
    b = np.frombuffer(data + b"\x00" * 8, dtype=np.uint8).astype(np.int64)
    n = len(data) + 4
    w = (b[:n] << 24) | (b[1:n + 1] << 16) | (b[2:n + 2] << 8) | b[3:n + 3]
    return w.tolist()


def _decode_segment(data: bytes, units: List[Tuple[_Component, int, int, int, int]], mcus: int,
                    mcu_origin: int, mcus_per_row: int, dc_tables, ac_tables, src: str) -> None:
    """Decode ``mcus`` MCUs of one restart segment (DC predictions reset at
    its start) into the components' coefficient lists.  ``units`` lists an
    MCU's blocks in order: (component, block column and row inside the MCU,
    the MCU's width and height in the component's blocks)."""
    win = _windows(data)
    limit = 8 * len(data) + 64  # libjpeg pads with zero bits; more is corrupt
    pos = 0
    for unit in units:
        unit[0].pred = 0
    for m in range(mcu_origin, mcu_origin + mcus):
        my, mx = divmod(m, mcus_per_row)
        for comp, bx, by, mh, mv in units:
            dct, act = dc_tables[comp.td], ac_tables[comp.ta]
            coef = comp.coef
            base = ((my * mv + by) * comp.bw + mx * mh + bx) * 64
            # DC: a category, then that many bits of difference.
            e = dct[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e & 31:
                raise ValueError(f"{src}: corrupt JPEG data (bad Huffman code)")
            pos += e & 31
            s = e >> 5
            if s:
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < (1 << (s - 1)):
                    v += 1 - (1 << s)
                comp.pred += v
            coef[base] = comp.pred
            k = 1
            while k < 64:
                e = act[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e & 31:
                    raise ValueError(f"{src}: corrupt JPEG data (bad Huffman code)")
                pos += e & 31
                rs = e >> 5
                s = rs & 15
                if s:
                    k += rs >> 4
                    v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                    pos += s
                    if v < (1 << (s - 1)):
                        v += 1 - (1 << s)
                    if k > 63:
                        raise ValueError(f"{src}: corrupt JPEG data (coefficient past 63)")
                    coef[base + _ZZ[k]] = v
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:  # end of block
                    break
            if pos > limit:
                raise ValueError(f"{src}: corrupt JPEG data (scan ends early)")


def _dc_first(data: bytes, units, mcus: int, mcu_origin: int, mcus_per_row: int, dc_tables,
              al: int, src: str) -> None:
    """A progressive DC first scan's segment (``jdphuff.c``
    decode_mcu_DC_first): each block's DC difference as in a sequential
    scan, its running sum stored shifted left by ``al``."""
    win = _windows(data)
    limit = 8 * len(data) + 64
    pos = 0
    for unit in units:
        unit[0].pred = 0
    for m in range(mcu_origin, mcu_origin + mcus):
        my, mx = divmod(m, mcus_per_row)
        for comp, bx, by, mh, mv in units:
            dct = dc_tables[comp.td]
            e = dct[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e & 31:
                raise ValueError(f"{src}: corrupt JPEG data (bad Huffman code)")
            pos += e & 31
            s = e >> 5
            if s:
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < (1 << (s - 1)):
                    v += 1 - (1 << s)
                comp.pred += v
            comp.coef[((my * mv + by) * comp.bw + mx * mh + bx) * 64] = comp.pred << al
        if pos > limit:
            raise ValueError(f"{src}: corrupt JPEG data (scan ends early)")


def _dc_refine(data: bytes, units, mcus: int, mcu_origin: int, mcus_per_row: int,
               al: int, src: str) -> None:
    """A progressive DC refinement scan's segment (decode_mcu_DC_refine):
    one raw bit a block, OR-ed in at bit ``al``."""
    win = _windows(data)
    limit = 8 * len(data) + 64
    pos = 0
    p1 = 1 << al
    for m in range(mcu_origin, mcu_origin + mcus):
        my, mx = divmod(m, mcus_per_row)
        for comp, bx, by, mh, mv in units:
            if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
                comp.coef[((my * mv + by) * comp.bw + mx * mh + bx) * 64] |= p1
            pos += 1
        if pos > limit:
            raise ValueError(f"{src}: corrupt JPEG data (scan ends early)")


def _ac_first(data: bytes, comp: _Component, blocks: int, block_origin: int, per_row: int,
              act: List[int], ss: int, se: int, al: int, src: str) -> None:
    """A progressive AC first scan's segment (decode_mcu_AC_first) over one
    component's blocks: coefficients ``ss..se`` shifted left by ``al``,
    end-of-band runs spanning blocks."""
    win = _windows(data)
    limit = 8 * len(data) + 64
    pos = 0
    coef = comp.coef
    eobrun = 0
    for b in range(block_origin, block_origin + blocks):
        if eobrun:
            eobrun -= 1
            continue
        by, bx = divmod(b, per_row)
        base = (by * comp.bw + bx) * 64
        k = ss
        while k <= se:
            e = act[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if not e & 31:
                raise ValueError(f"{src}: corrupt JPEG data (bad Huffman code)")
            pos += e & 31
            rs = e >> 5
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < (1 << (s - 1)):
                    v += 1 - (1 << s)
                if k > 63:
                    raise ValueError(f"{src}: corrupt JPEG data (coefficient past 63)")
                coef[base + _ZZ[k]] = v << al
                k += 1
            elif r == 15:
                k += 16
            else:  # an end-of-band run of 2^r + r more bits' worth of blocks
                eobrun = 1 << r
                if r:
                    eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                    pos += r
                eobrun -= 1
                break
        if pos > limit:
            raise ValueError(f"{src}: corrupt JPEG data (scan ends early)")


def _ac_refine(data: bytes, comp: _Component, blocks: int, block_origin: int, per_row: int,
               act: List[int], ss: int, se: int, al: int, src: str) -> None:
    """A progressive AC refinement scan's segment (decode_mcu_AC_refine)
    over one component's blocks: newly nonzero coefficients of +-2^al, and
    a correction bit for every coefficient already nonzero that the scan
    passes over (within the band up to an end-of-band run's end)."""
    win = _windows(data)
    limit = 8 * len(data) + 64
    pos = 0
    coef = comp.coef
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    zz = _ZZ
    for b in range(block_origin, block_origin + blocks):
        by, bx = divmod(b, per_row)
        base = (by * comp.bw + bx) * 64
        k = ss
        if not eobrun:
            while k <= se:
                e = act[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e & 31:
                    raise ValueError(f"{src}: corrupt JPEG data (bad Huffman code)")
                pos += e & 31
                rs = e >> 5
                r, s = rs >> 4, rs & 15
                if s:  # a new coefficient of magnitude 1 at this bit, its sign a bit
                    s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                        pos += r
                    break
                # Pass over nonzero coefficients (a correction bit each) and
                # r zero ones; stop at the zero that takes s (or the 16th: ZRL).
                while k <= se:
                    i = base + zz[k]
                    c = coef[i]
                    if c:
                        if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                            coef[i] = c + (p1 if c >= 0 else m1)
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    if k > 63:
                        raise ValueError(f"{src}: corrupt JPEG data (coefficient past 63)")
                    coef[base + zz[k]] = s
                k += 1
        if eobrun:
            # The band's rest in an end-of-band run: correction bits only.
            while k <= se:
                i = base + zz[k]
                c = coef[i]
                if c:
                    if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                        coef[i] = c + (p1 if c >= 0 else m1)
                    pos += 1
                k += 1
            eobrun -= 1
        if pos > limit:
            raise ValueError(f"{src}: corrupt JPEG data (scan ends early)")


# jidctint.c's constants: FIX(x) = round(x * 2^13).
_CONST_BITS, _PASS1_BITS = 13, 2
_F = {name: int(round(x * (1 << _CONST_BITS))) for name, x in (
    ("0_298631336", 0.298631336), ("0_390180644", 0.390180644), ("0_541196100", 0.541196100),
    ("0_765366865", 0.765366865), ("0_899976223", 0.899976223), ("1_175875602", 1.175875602),
    ("1_501321110", 1.501321110), ("1_847759065", 1.847759065), ("1_961570560", 1.961570560),
    ("2_053119869", 2.053119869), ("2_562915447", 2.562915447), ("3_072711026", 3.072711026))}


def _idct_1d(x: List[np.ndarray]) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """One pass of jidctint.c's islow IDCT over 8 inputs (int64 arrays):
    (the four sums, the four differences) before the pass's descale, in
    output order 0..3 and 7..4."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F["0_541196100"]
    tmp2 = z1 + z3 * -_F["1_847759065"]
    tmp3 = z1 + z2 * _F["0_765366865"]
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175875602"]
    t0 = t0 * _F["0_298631336"]
    t1 = t1 * _F["2_053119869"]
    t2 = t2 * _F["3_072711026"]
    t3 = t3 * _F["1_501321110"]
    z1 = z1 * -_F["0_899976223"]
    z2 = z2 * -_F["2_562915447"]
    z3 = z3 * -_F["1_961570560"] + z5
    z4 = z4 * -_F["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return ([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0],
            [tmp10 - t3, tmp11 - t2, tmp12 - t1, tmp13 - t0])


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """[B, 64] quantized coefficients (natural order) and their [64] table
    -> [B, 8, 8] uint8 samples, libjpeg's ``jpeg_idct_islow`` to the bit
    (its shortcuts for all-zero AC columns and rows give the same values)."""
    blk = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    # Pass 1: columns (input rows 0..7 of each column) into the workspace.
    head, tail = _idct_1d([blk[:, k, :] for k in range(8)])
    n1 = _CONST_BITS - _PASS1_BITS
    ws = np.stack([_descale(v, n1) for v in head] + [_descale(v, n1) for v in tail[::-1]], 1)
    # Pass 2: rows of the workspace, descaled by the pass bits and the 8.
    head, tail = _idct_1d([ws[:, :, k] for k in range(8)])
    n2 = _CONST_BITS + _PASS1_BITS + 3
    out = np.stack([_descale(v, n2) for v in head] + [_descale(v, n2) for v in tail[::-1]], 2)
    # jdmaster.c's post-IDCT range limit, indexed by the value & 1023.
    x = out & 1023
    return np.where(x < 128, x + 128, np.where(x < 512, 255, np.where(x < 896, 0, x - 896))
                    ).astype(np.uint8)


def _edge(a: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """(a shifted by one towards the start, by one towards the end) along
    ``axis``, the edge sample replicated: a[i - 1] and a[i + 1]."""
    first = np.take(a, [0], axis=axis)
    last = np.take(a, [a.shape[axis] - 1], axis=axis)
    body = np.take(a, np.arange(a.shape[axis] - 1), axis=axis)
    rest = np.take(a, np.arange(1, a.shape[axis]), axis=axis)
    return np.concatenate([first, body], axis), np.concatenate([rest, last], axis)


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's [dh, dw] samples upsampled by (fh, fv) in {1, 2} as
    libjpeg's fancy upsampling does (``jdsample.c``); a component no wider
    than 2 samples is replicated instead, as libjpeg does."""
    p = plane.astype(np.int64)
    if fh == 1 and fv == 1:
        return plane
    if p.shape[1] <= 2:
        return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)
    if fv == 1:  # h2v1
        left, right = _edge(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1).astype(np.uint8)
    above, below = _edge(p, 0)
    if fh == 1:  # h1v2
        return _interleave((3 * p + above + 1) >> 2, (3 * p + below + 2) >> 2, 0).astype(np.uint8)
    rows = []
    for near in (above, below):  # h2v2: output rows 2i (above) and 2i + 1 (below)
        cs = 3 * p + near
        left, right = _edge(cs, 1)
        rows.append(_interleave((3 * cs + left + 8) >> 4, (3 * cs + right + 7) >> 4, 1))
    return _interleave(rows[0], rows[1], 0).astype(np.uint8)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """YCbCr -> [H, W, 3] RGB by ``jdcolor.c``'s fixed-point tables."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    yy = y.astype(np.int64)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yy + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg(blob: bytes, src: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> [H, W, C] uint8 (see the module docstring)."""
    if not is_jpeg(blob):
        raise ValueError(f"{src} is not a JPEG file")
    quant: Dict[int, np.ndarray] = {}
    dc_tables: Dict[int, List[int]] = {}
    ac_tables: Dict[int, List[int]] = {}
    comps: List[_Component] = []
    width = height = 0
    restart = 0
    adobe_transform = None
    pos = 2
    frame_seen = progressive = False
    coef_bits: Dict[int, List[int]] = {}
    while True:
        pos = blob.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(blob):
            break
        marker = blob[pos + 1]
        if marker in (0xFF, 0x00) or 0xD0 <= marker <= 0xD7:
            pos += 1
            continue
        if marker == 0xD9:  # EOI
            break
        length = int.from_bytes(blob[pos + 2:pos + 4], "big")
        seg = blob[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in _UNSUPPORTED:
            raise ValueError(f"{src}: {_UNSUPPORTED[marker]} is not decoded (Huffman-coded "
                             "sequential and progressive JPEG only)")
        if marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + n], dtype=">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals.astype(np.int64)
                quant[tq] = q
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                n = sum(counts)
                table = _huffman_table(counts, list(seg[i + 17:i + 17 + n]))
                (ac_tables if tc else dc_tables)[th] = table
                i += 17 + n
        elif marker == 0xDD:  # DRI
            restart = int.from_bytes(seg[:2], "big")
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0 / SOF1 sequential, SOF2 progressive
            if frame_seen:
                raise ValueError(f"{src}: JPEG with a second frame header")
            progressive = marker == 0xC2
            precision = seg[0]
            if precision != 8:
                raise ValueError(f"{src}: {precision}-bit JPEG is not decoded (8-bit only)")
            height, width = int.from_bytes(seg[1:3], "big"), int.from_bytes(seg[3:5], "big")
            nf = seg[5]
            if nf not in (1, 3, 4):
                raise ValueError(f"{src}: a {nf}-component JPEG is not decoded")
            comps = [_Component(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15,
                                seg[8 + 3 * k]) for k in range(nf)]
            if height == 0 or any(c.h not in (1, 2) or c.v not in (1, 2) for c in comps):
                raise ValueError(f"{src}: sampling factors other than 1 and 2 (or a DNL "
                                 "height) are not decoded")
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c.bw, c.bh = mcux * c.h, mcuy * c.v
                c.dw, c.dh = -(-width * c.h // hmax), -(-height * c.v // vmax)
                c.coef = [0] * (c.bw * c.bh * 64)
            # Each coefficient's successive-approximation bit still to come
            # (libjpeg's coef_bits): -1 before its first scan, 0 once whole.
            coef_bits = {c.cid: [-1] * 64 for c in comps}
            frame_seen = True
        elif marker == 0xDA:  # SOS, then the entropy-coded data
            if not frame_seen:
                raise ValueError(f"{src}: JPEG scan before its frame header")
            ns = seg[0]
            by_id = {c.cid: c for c in comps}
            scomps = []
            for k in range(ns):
                c = by_id[seg[1 + 2 * k]]
                c.td, c.ta = seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15
                scomps.append(c)
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
            end = _SCAN_END.search(blob, pos)
            data = blob[pos:end.start() if end else len(blob)]
            pos = end.start() if end else len(blob)
            if progressive:
                _check_progressive_scan(scomps, coef_bits, ss, se, ah, al, src)
            if ns == 1:  # non-interleaved: a block an MCU over the component's own extent
                c = scomps[0]
                per_row, rows = -(-c.dw // 8), -(-c.dh // 8)
                units = [(c, 0, 0, 1, 1)]
            else:
                hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
                per_row, rows = -(-width // (8 * hmax)), -(-height // (8 * vmax))
                units = [(c, bx, by, c.h, c.v) for c in scomps for by in range(c.v)
                         for bx in range(c.h)]
            total = per_row * rows
            interval = restart or total
            done = 0
            for piece in _RST.split(data):
                if done >= total:
                    break
                n = min(interval, total - done)
                piece = piece.replace(b"\xff\x00", b"\xff")
                if not progressive:
                    _decode_segment(piece, units, n, done, per_row, dc_tables, ac_tables, src)
                elif ss == 0:
                    if ah:
                        _dc_refine(piece, units, n, done, per_row, al, src)
                    else:
                        _dc_first(piece, units, n, done, per_row, dc_tables, al, src)
                else:
                    ac = _ac_refine if ah else _ac_first
                    ac(piece, scomps[0], n, done, per_row, ac_tables[scomps[0].ta], ss, se, al,
                       src)
                done += n
            if done < total:
                raise ValueError(f"{src}: corrupt JPEG data (a scan ends early)")
    if not frame_seen:
        raise ValueError(f"{src}: JPEG without a frame header")
    if progressive:
        for c in comps:
            if any(coef_bits[c.cid]):
                raise ValueError(
                    f"{src}: progressive JPEG whose scans leave component {c.cid}'s "
                    "successive approximation incomplete is not decoded (libjpeg would "
                    "block-smooth it)")
    if len(comps) == 4 and adobe_transform == 2:
        raise ValueError(f"{src}: YCCK JPEG (Adobe transform 2) is not decoded")

    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        blocks = idct_islow(np.asarray(c.coef, dtype=np.int64).reshape(-1, 64), quant[c.tq])
        plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        plane = upsample(plane[:c.dh, :c.dw], hmax // c.h, vmax // c.v)
        planes.append(plane[:height, :width])
    if len(comps) == 1:
        return planes[0][..., None]
    if len(comps) == 4:  # CMYK as stored, inverted as PIL reads it
        return 255 - np.stack(planes, -1)
    rgb_ids = [c.cid for c in comps] == [ord("R"), ord("G"), ord("B")]
    if adobe_transform == 0 or (adobe_transform is None and rgb_ids):
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)


def _check_progressive_scan(scomps: List[_Component], coef_bits: Dict[int, List[int]], ss: int,
                            se: int, ah: int, al: int, src: str) -> None:
    """A progressive scan's header against the JPEG rules libjpeg enforces
    (``jdphuff.c`` start_pass_phuff_decoder), and its coefficients' bits
    brought up to date: a DC scan takes no AC coefficient, an AC scan one
    component, and a refinement follows its coefficient's last scan."""
    if ss == 0 and se != 0 or ss > se or se > 63 or (ss > 0 and len(scomps) != 1):
        raise ValueError(f"{src}: corrupt progressive JPEG (scan of coefficients {ss}-{se} "
                         f"over {len(scomps)} components)")
    if ah and ah - 1 != al:
        raise ValueError(f"{src}: corrupt progressive JPEG (successive approximation "
                         f"{ah} -> {al})")
    for c in scomps:
        bits = coef_bits[c.cid]
        if ss > 0 and bits[0] < 0:
            raise ValueError(f"{src}: corrupt progressive JPEG (AC scan before the DC scan)")
        for k in range(ss, se + 1):
            if bits[k] != (ah if ah else -1):
                raise ValueError(f"{src}: corrupt progressive JPEG (coefficient {k} of "
                                 f"component {c.cid} refined out of order)")
            bits[k] = al
