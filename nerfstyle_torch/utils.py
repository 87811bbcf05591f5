"""Host utilities of the port: logging, the overwrite prompt, PNG output,
PSNR, the segmentation palette and the checkpoint's version stamp.

Counterpart of ``nerfstyle_tpu/utils.py`` for what rendering and training
need.  PNGs are
written with ``zlib`` from the standard library, so the port needs no image
package.
"""

from __future__ import annotations

import logging
import math
import struct
import subprocess
import sys
import zlib
from pathlib import Path
from typing import Union

import numpy as np

_ANSI = {
    "DEBUG": "\x1b[38;21m",
    "INFO": "\x1b[38;5;39m",
    "WARNING": "\x1b[38;5;226m",
    "ERROR": "\x1b[38;5;196m",
    "CRITICAL": "\x1b[31;1m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _ANSI.get(record.levelname, "")
        return logging.Formatter(f"{color}[%(levelname)s] %(name)s: %(message)s{_RESET}").format(
            record
        )


def create_logger(name: str, level: str = "info") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level.upper())
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(_ColorFormatter())
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def prompt_bool(msg: str, assume_yes: bool = False) -> bool:
    """Y/N guard for destructive operations; a run without a TTY answers no
    unless ``assume_yes``."""
    if assume_yes:
        return True
    if not sys.stdin.isatty():
        print(f"{msg} — no TTY; answering no (pass --yes to confirm).")
        return False
    result = None
    while result not in ("y", "n"):
        result = input(msg + " (Y/N) ").lower()
    return result == "y"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def save_image(arr: np.ndarray, path: Union[str, Path]) -> None:
    """Save a [C, H, W] or [H, W, C] float array in [0, 1] as an 8-bit PNG
    (values clipped, NaN -> 0)."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 3 and arr.shape[0] in (1, 3, 4) and arr.shape[-1] not in (1, 3, 4):
        arr = np.moveaxis(arr, 0, -1)
    if arr.ndim == 2:
        arr = arr[..., None]
    img = (np.clip(np.nan_to_num(arr), 0.0, 1.0) * 255).astype(np.uint8)
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(raw, 6))
        + _png_chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def compute_psnr(mse: float) -> float:
    return -10.0 * math.log(mse) / math.log(10.0) if mse > 0 else float("inf")


def tab10_colormap(n: int) -> np.ndarray:
    """First n colors of the tab10 palette as [n, 3] floats (segmentation
    images)."""
    base = np.array(
        [
            (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
            (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
            (188, 189, 34), (23, 190, 207),
        ],
        dtype=np.float32,
    ) / 255.0
    return np.tile(base, ((n + 9) // 10, 1))[:n]


def get_git_sha() -> str:
    """The checkout's commit, for a checkpoint's version stamp ("unknown"
    outside a git checkout)."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=Path(__file__).parent, stderr=subprocess.DEVNULL,
        ).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
