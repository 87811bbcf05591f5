"""Animated GIF89a writer (numpy and the standard library only), for the
style stage's ``video.gif`` (``nerfstyle_tpu.utils.save_gif``, which PIL
writes for the JAX package).

Each frame gets its own palette of at most 256 colours by median cut: the
frame's distinct colours, weighted by their pixel counts, start in one box;
the box with the widest channel range is cut at the weighted median of that
channel until there are 256 boxes or no box spans more than one colour;
each box's colour is the weighted mean of its colours, and each pixel takes
the palette's nearest colour.  A frame with at most 256 colours is kept exactly.  The
indices are LZW-coded (8-bit root, codes up to 12 bits, a clear code when
the table is full).  Every frame shows for the same delay (GIF counts in
hundredths of a second: ``duration_ms // 10``, as PIL writes it), and the
NETSCAPE2.0 extension makes the animation loop forever.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Sequence, Tuple, Union

import numpy as np


# Colours a frame's palette holds (GIF's most), and the LZW root size.
_COLORS, _ROOT_BITS = 256, 8


def median_cut(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[H, W, 3] uint8 -> (palette [K, 3] uint8 with K <= 256, indices
    [H, W] uint8)."""
    key = img.reshape(-1, 3).astype(np.int64)
    key = (key[:, 0] << 16) | (key[:, 1] << 8) | key[:, 2]
    ukey, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    uniq = np.stack([ukey >> 16, (ukey >> 8) & 255, ukey & 255], axis=1)
    boxes = [np.arange(len(uniq))]
    spans = [np.ptp(uniq, axis=0)]
    while len(boxes) < _COLORS:
        widest = int(np.argmax([sp.max() for sp in spans]))
        if spans[widest].max() == 0:
            break
        box, ch = boxes[widest], int(np.argmax(spans[widest]))
        order = box[np.argsort(uniq[box, ch], kind="stable")]
        vals = uniq[order, ch]
        cum = np.cumsum(counts[order])
        # The weighted median, moved to the nearest change of value so that
        # both halves keep colours (the span is above 0: there is one).
        cut = int(np.searchsorted(cum, cum[-1] / 2.0))
        changes = np.nonzero(vals[1:] != vals[:-1])[0]  # cut after these positions
        cut = int(changes[np.argmin(np.abs(changes - cut))])
        halves = [order[:cut + 1], order[cut + 1:]]
        boxes[widest:widest + 1] = halves
        spans[widest:widest + 1] = [np.ptp(uniq[h], axis=0) for h in halves]
    palette = np.zeros((len(boxes), 3), dtype=np.int64)
    for i, b in enumerate(boxes):
        w = counts[b].astype(np.float64)
        palette[i] = np.round((uniq[b] * w[:, None]).sum(0) / w.sum())
    # Each colour takes its nearest palette entry (squared distance, the
    # first of equals): argmin of |p|^2 - 2 u.p, exact in float32 for 8-bit
    # values.
    pal = palette.astype(np.float32)
    score = (pal * pal).sum(1)[None] - 2.0 * (uniq.astype(np.float32) @ pal.T)
    nearest = np.argmin(score, axis=1).astype(np.uint8)
    return palette.astype(np.uint8), nearest[inverse.reshape(-1)].reshape(img.shape[:2])


def lzw_encode(indices: np.ndarray) -> bytes:
    """GIF's LZW of a byte stream: variable-width codes (one bit wider once
    the decoder's table reaches the width), least significant bit first, a
    clear code first and whenever the 4096-entry table fills, the end code
    last."""
    clear, end = 1 << _ROOT_BITS, (1 << _ROOT_BITS) + 1
    out = bytearray()
    acc = nacc = 0
    width = _ROOT_BITS + 1

    def emit(code: int) -> None:
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    table: dict = {}
    next_code = end + 1
    emit(clear)
    data = indices.reshape(-1).tolist()
    if not data:
        emit(end)
        return bytes(out) + (bytes([acc]) if nacc else b"")
    prefix = data[0]
    for k in data[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        table[key] = next_code
        next_code += 1
        if next_code == 4096:  # the table is full: start again
            emit(clear)
            table.clear()
            next_code = end + 1
            width = _ROOT_BITS + 1
        elif next_code > (1 << width):
            width += 1
        prefix = k
    emit(prefix)
    emit(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(frames: Sequence[np.ndarray], path: Union[str, Path], duration_ms: int) -> None:
    """[H, W, 3] uint8 frames (all one size) -> an animated GIF89a that
    loops forever, each frame with its own median-cut palette and shown for
    ``duration_ms // 10`` hundredths of a second."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    h, w = frames[0].shape[:2]
    if any(f.shape != (h, w, 3) or f.dtype != np.uint8 for f in frames):
        raise ValueError("GIF frames must all be [H, W, 3] uint8 of one size")
    parts: List[bytes] = [
        b"GIF89a",
        struct.pack("<HHBBB", w, h, 0x70, 0, 0),  # no global table, 8-bit colour resolution
        b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00",  # loop forever
    ]
    delay = int(duration_ms) // 10
    for f in frames:
        palette, idx = median_cut(f)
        table = np.zeros((_COLORS, 3), dtype=np.uint8)
        table[:len(palette)] = palette
        parts += [
            # Graphic control: keep the frame, no transparency, the delay.
            b"\x21\xf9\x04" + struct.pack("<BHB", 0x04, delay, 0) + b"\x00",
            b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),  # a local table of 256 colours
            table.tobytes(),
            bytes([_ROOT_BITS]) + _sub_blocks(lzw_encode(idx)),
        ]
    parts.append(b"\x3b")
    Path(path).write_bytes(b"".join(parts))
