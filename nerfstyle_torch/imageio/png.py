"""8-bit PNG reader and writer (``zlib`` from the standard library).

:func:`read_png` takes what PIL gives the JAX package as 8 bits a sample:
gray, gray + alpha, RGB and RGBA, plain or Adam7-interlaced, and returns
them as PIL's ``np.asarray`` does ([H, W, C] uint8; C = 1, 2, 3, 4).
Palette PNGs and other bit depths raise ``ValueError``: PIL hands the JAX
package a palette image's raw indices and a 16-bit gray image's I;16
values, neither of which is an image in [0, 1] to match.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Tuple, Union

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # color type -> channels (gray, gray + alpha, RGB, RGBA)
# Adam7's passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def write_png(img: np.ndarray, path: Union[str, Path]) -> None:
    """[H, W, C] uint8 (C = 1, 3 or 4) -> a non-interlaced 8-bit PNG, every
    row unfiltered."""
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    Path(path).write_bytes(
        PNG_SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, w: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters of [h, 1 + w * bpp] filtered rows ->
    [h, w * bpp] uint8."""
    h, stride = rows.shape[0], w * bpp
    out = np.zeros((h, stride), dtype=np.int64)
    prev = np.zeros(stride, dtype=np.int64)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:  # None
            cur = line
        elif ftype == 1:  # Sub: each byte adds the byte bpp to its left
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) % 256
        elif ftype == 2:  # Up
            cur = (line + prev) % 256
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, dtype=np.int64)
            left = np.zeros(bpp, dtype=np.int64)
            up_left = np.zeros(bpp, dtype=np.int64)
            for x in range(w):
                sl = slice(x * bpp, (x + 1) * bpp)
                up = prev[sl]
                pred = (left + up) // 2 if ftype == 3 else _paeth(left, up, up_left)
                cur[sl] = (line[sl] + pred) % 256
                left, up_left = cur[sl], up
        else:
            raise ValueError(f"unknown PNG row filter {ftype}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def png_size(path: Union[str, Path]) -> Tuple[int, int]:
    """(width, height) of a PNG from its IHDR chunk, which the format puts
    first, without decoding the image."""
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE) + 16)
    if not head.startswith(PNG_SIGNATURE) or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return w, h


def read_png(path: Union[str, Path]) -> np.ndarray:
    """An 8-bit PNG (gray, gray + alpha, RGB or RGBA; plain or Adam7) ->
    [H, W, C] uint8."""
    blob = Path(path).read_bytes()
    if not blob.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        tag, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if color_type == 3:
        raise ValueError(f"{path}: palette PNGs are not read (PIL gives the palette's indices, "
                         "not colours)")
    if depth != 8 or color_type not in _CHANNELS or interlace not in (0, 1):
        raise ValueError(f"{path}: only 8-bit gray, gray + alpha, RGB or RGBA PNGs are read "
                         f"(bit depth {depth}, color type {color_type}, interlace {interlace})")
    c = _CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if interlace == 0:
        passes = [(0, 0, 1, 1)]
    else:
        passes = _ADAM7
    out = np.zeros((h, w, c), dtype=np.uint8)
    at = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx) if w > x0 else 0, -(-(h - y0) // dy) if h > y0 else 0
        if pw == 0 or ph == 0:  # an empty pass has no rows, not even filter bytes
            continue
        n = ph * (1 + pw * c)
        if at + n > raw.size:
            raise ValueError(f"{path}: PNG data holds {raw.size} bytes, fewer than its size needs")
        rows = raw[at:at + n].reshape(ph, 1 + pw * c)
        out[y0::dy, x0::dx] = _unfilter(rows, pw, c).reshape(ph, pw, c)
        at += n
    if at != raw.size:
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected {at}")
    return out
