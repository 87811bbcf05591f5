"""Host utilities of the port: logging, the overwrite prompt, PNG input and
output, PSNR, the segmentation palette, the style collage, the datasets'
train/test split and colour transfer, and the checkpoint's version stamp.

Counterpart of ``nerfstyle_tpu/utils.py`` for what rendering, training and
the dataset loaders need.  Images are read and written by
:mod:`nerfstyle_torch.imageio` (numpy and the standard library), so the port
needs no image package: :func:`parse_rgb` takes 8-bit PNGs (gray, gray +
alpha, RGB, RGBA; plain or Adam7-interlaced), Huffman JPEGs and ``.npy``
arrays, told apart by their content; :func:`png_size` reads a PNG's size
from its header; :func:`save_gif` writes an animated GIF.
"""

from __future__ import annotations

import logging
import math
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .imageio import gif, jpeg, png
from .imageio.png import png_size, read_png  # noqa: F401  (the module's API)

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


def save_image(arr: np.ndarray, path: Union[str, Path]) -> None:
    """Save a [C, H, W] or [H, W, C] float array in [0, 1] as an 8-bit PNG
    (values clipped, NaN -> 0)."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 3 and arr.shape[0] in (1, 3, 4) and arr.shape[-1] not in (1, 3, 4):
        arr = np.moveaxis(arr, 0, -1)
    if arr.ndim == 2:
        arr = arr[..., None]
    png.write_png((np.clip(np.nan_to_num(arr), 0.0, 1.0) * 255).astype(np.uint8), path)


def save_gif(frames: List[np.ndarray], path: Union[str, Path], fps: float = 3.75) -> None:
    """Save [H, W, 3] uint8 frames as an animated GIF that loops, each frame
    shown int(1000 / fps) ms (``nerfstyle_tpu.utils.save_gif``; see
    :mod:`nerfstyle_torch.imageio.gif`)."""
    gif.write_gif(frames, path, duration_ms=int(1000 / fps))


def _resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 at ``size`` = (w, h): PIL's default
    resize (bicubic, a = -0.5, antialiased when shrinking), which torch's
    antialiased bicubic on uint8 reproduces (within 1/255).  RGBA is resized
    with its color premultiplied by alpha, in PIL's integer arithmetic; PIL's
    own rounding of that path differs by a few /255 where alpha is small."""
    if img.shape[-1] == 4:
        rgb, alpha = img[..., :3].astype(np.int64), img[..., 3:].astype(np.int64)
        tmp = rgb * alpha + 128
        pre = np.concatenate([((tmp >> 8) + tmp) >> 8, alpha], axis=-1).astype(np.uint8)
        out = _resize_channels(pre, size).astype(np.int64)
        a = out[..., 3:]
        un = np.clip((255 * out[..., :3]) // np.maximum(a, 1), 0, 255)
        rgb = np.where((a == 0) | (a == 255), out[..., :3], un)
        return np.concatenate([rgb, a], axis=-1).astype(np.uint8)
    return _resize_channels(img, size)


def _resize_channels(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Each channel of [H, W, C] uint8 resized on its own (see
    :func:`_resize_bicubic`)."""
    w, h = size
    t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(img, -1, 0)))[None]
    out = torch.nn.functional.interpolate(t, size=(h, w), mode="bicubic", antialias=True,
                                          align_corners=False)
    if out.dtype != torch.uint8:
        out = out.round().clamp(0, 255).to(torch.uint8)
    return np.moveaxis(out[0].numpy(), 0, -1)


def parse_rgb(path: Union[str, Path], size: Optional[Union[int, Tuple[int, int]]] = None
              ) -> np.ndarray:
    """Load an image -> [C, H, W] float32 in [0, 1], optionally resized to a
    longer edge (int) or to (w, h), as ``nerfstyle_tpu.utils.parse_rgb``
    does with PIL.

    Reads, by their content as PIL does: 8-bit PNGs (gray, gray + alpha,
    RGB, RGBA; plain or Adam7-interlaced), sequential and progressive
    Huffman JPEGs (gray, colour or CMYK: [H, W, 1], [H, W, 3] or PIL's
    [H, W, 4], decoded to PIL's bits) and ``.npy`` arrays of
    [H, W] or [H, W, C] (uint8, or float in [0, 1], which is quantized to 8
    bits as a PNG would be)."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(png.PNG_SIGNATURE):
        img = png.read_png(path)
    elif jpeg.is_jpeg(head):
        img = jpeg.read_jpeg(path)
    elif head.startswith(b"\x93NUMPY"):
        arr = np.load(path)
        if arr.dtype != np.uint8:
            arr = (np.clip(np.nan_to_num(arr.astype(np.float32)), 0.0, 1.0) * 255).astype(np.uint8)
        img = arr[..., None] if arr.ndim == 2 else arr
    else:
        raise ValueError(f"{path}: images are read as .png (8-bit), .jpg/.jpeg (Huffman) "
                         f"or .npy; its first bytes are {head!r}")
    if size is not None:
        if isinstance(size, int):
            h, w = img.shape[:2]
            size = (size, int(size * h / w)) if w > h else (int(size * w / h), size)
        img = _resize_bicubic(img, tuple(size))
    return np.moveaxis(img.astype(np.float32) / 255.0, -1, 0)


def match_colors_for_image_set(
    image_set: np.ndarray, style_img: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """SVD colour transfer of an image set onto a style image's colour
    statistics, in float64 (as ``nerfstyle_tpu.utils``).

    Args:
        image_set: [N, H, W, 3] float in [0, 1].
        style_img: [H, W, 3].

    Returns:
        (transferred [N, H, W, 3] float32, color_tf [4, 4]).
    """
    sh = image_set.shape
    x = image_set.reshape(-1, 3).astype(np.float64)
    s = style_img.reshape(-1, 3).astype(np.float64)

    mu_c = x.mean(0, keepdims=True)
    mu_s = s.mean(0, keepdims=True)

    cov_c = (x - mu_c).T @ (x - mu_c) / x.shape[0]
    cov_s = (s - mu_s).T @ (s - mu_s) / s.shape[0]

    u_c, sig_c, _ = np.linalg.svd(cov_c)
    u_s, sig_s, _ = np.linalg.svd(cov_s)

    scl_c = np.diag(1.0 / np.sqrt(np.clip(sig_c, 1e-8, 1e8)))
    scl_s = np.diag(np.sqrt(np.clip(sig_s, 1e-8, 1e8)))

    tmp_mat = u_s @ scl_s @ u_s.T @ u_c @ scl_c @ u_c.T
    tmp_vec = mu_s - mu_c @ tmp_mat.T

    out = x @ tmp_mat.T + tmp_vec
    out = np.clip(out, 0.0, 1.0).reshape(sh).astype(np.float32)

    color_tf = np.eye(4)
    color_tf[:3, :3] = tmp_mat
    color_tf[:3, 3] = tmp_vec[0]
    return out, color_tf


def train_test_split(total: int, split_every: int, is_train: bool) -> List[int]:
    """Frame ids of a split that holds out every ``split_every``-th frame
    (from frame 0) for testing."""
    return [i for i in range(total) if (i % split_every == 0) != is_train]


def collage_h(img1: np.ndarray, img2: np.ndarray) -> np.ndarray:
    """Horizontal collage of two [C, H, W] images, bottom-padded with zeros."""
    img1, img2 = np.asarray(img1), np.asarray(img2)
    if img1.ndim == 4:
        img1 = img1[0]
    if img2.ndim == 4:
        img2 = img2[0]
    h_out = max(img1.shape[-2], img2.shape[-2])

    def pad(img):
        if img.shape[-2] < h_out:
            zeros = np.zeros((img.shape[0], h_out - img.shape[-2], img.shape[-1]), img.dtype)
            return np.concatenate([img, zeros], axis=-2)
        return img

    return np.concatenate([pad(img1), pad(img2)], axis=-1)


def compute_psnr(mse: float) -> float:
    return -10.0 * math.log(mse) / math.log(10.0) if mse > 0 else float("inf")


def density2alpha(densities: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """``1 - exp(-relu(sigma) * dist)``, as ``nerfstyle_tpu.utils.density2alpha``."""
    return 1.0 - torch.exp(-torch.clamp(densities, min=0.0) * dists)


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
