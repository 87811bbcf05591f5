"""Host utilities of the port: logging (a logger whose errors end the
process), a named wall clock, the overwrite prompt, PNG input and output,
PSNR, the segmentation palette, the style collage, the datasets' train/test
split and colour transfer, colour names, chunked execution, byte sizes and
device memory, the data-file loader decorator, and the checkpoint's version
stamp.

Counterpart of ``nerfstyle_tpu/utils.py``, helper for helper.  Images are read and written by
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
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

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


class ExitHandler(logging.StreamHandler):
    """A stream handler after which an error record ends the process
    (``sys.exit(1)``): ``logger.error`` is a hard failure."""

    def emit(self, record):
        super().emit(record)
        if record.levelno >= logging.ERROR:
            sys.exit(1)


def create_logger(name: str, level: str = "info", exit_on_error: bool = True) -> logging.Logger:
    """The logger ``name`` writing coloured ``[LEVEL] name: message`` lines
    to stdout; with ``exit_on_error`` an error record ends the process.  A
    logger keeps the handler of its first call."""
    logger = logging.getLogger(name)
    logger.setLevel(level.upper())
    if not logger.handlers:
        handler = ExitHandler(sys.stdout) if exit_on_error else logging.StreamHandler(sys.stdout)
        handler.setFormatter(_ColorFormatter())
        logger.addHandler(handler)
        logger.propagate = False
    return logger


class Clock:
    """Named wall-clock probe: :meth:`click` with a name records the time
    since the last click under it; min/max/avg/count by name."""

    def __init__(self):
        self._last: Optional[float] = None
        self._stats: Dict[str, List[float]] = {}

    def click(self, name: Optional[str] = None) -> None:
        now = time.perf_counter()
        if name is not None and self._last is not None:
            self._stats.setdefault(name, []).append(now - self._last)
        self._last = now

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"min": min(v), "max": max(v), "avg": sum(v) / len(v), "count": len(v)}
                for k, v in self._stats.items()}

    def report(self) -> str:
        return "\n".join(
            f"{k}: avg {s['avg'] * 1e3:.2f}ms min {s['min'] * 1e3:.2f}ms "
            f"max {s['max'] * 1e3:.2f}ms (n={s['count']})" for k, s in self.summary().items())


global_clock = Clock()


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


def batch_exec(fn, *out_buffers, bsize: int):
    """Chunked execution into preallocated numpy ``out_buffers``: the
    returned runner calls ``fn`` on ``bsize``-row slices of its inputs and
    writes each result (a tensor, an array or a tuple of them) into the
    buffers' slices; returns the buffers (the one buffer when one)."""

    def runner(*inputs):
        n = len(inputs[0])
        for start in range(0, n, bsize):
            sl = slice(start, min(start + bsize, n))
            res = fn(*[inp[sl] for inp in inputs])
            if not isinstance(res, tuple):
                res = (res,)
            for buf, r in zip(out_buffers, res):
                buf[sl] = r.detach().cpu().numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
        return out_buffers if len(out_buffers) > 1 else out_buffers[0]

    return runner


def format_bytes(bytes_count: int, unit: str = "B", prec: int = 3) -> str:
    """``bytes_count`` in B, KB, MB or GB (powers of 1024), ``prec`` decimals."""
    units = {"B": 0, "KB": 1, "MB": 2, "GB": 3}
    assert unit in units
    return f"{bytes_count / (1024 ** units[unit]):.{prec}f}{unit}"


def print_memory_usage(desc: str, unit: str = "MB", device=None) -> None:
    """Print ``<desc>: In use - <bytes>, Peak - <bytes>`` from the CUDA
    allocator's statistics of ``device`` (the current card by default);
    zeros on the CPU, which keeps none."""
    dev = torch.device("cuda" if device is None and torch.cuda.is_available() else device or "cpu")
    stats = torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}
    used = format_bytes(stats.get("allocated_bytes.all.current", 0), unit)
    peak = format_bytes(stats.get("allocated_bytes.all.peak", 0), unit)
    print(f"{desc}: In use - {used}, Peak - {peak}")


# The colour names color_str2rgb takes, as matplotlib's CSS4 and Tableau
# tables give them (the single-letter base colours are in _BASE_COLORS).
_CSS4_COLORS = dict(kv.split(":") for kv in """
aliceblue:f0f8ff antiquewhite:faebd7 aqua:00ffff aquamarine:7fffd4 azure:f0ffff
beige:f5f5dc bisque:ffe4c4 black:000000 blanchedalmond:ffebcd blue:0000ff
blueviolet:8a2be2 brown:a52a2a burlywood:deb887 cadetblue:5f9ea0 chartreuse:7fff00
chocolate:d2691e coral:ff7f50 cornflowerblue:6495ed cornsilk:fff8dc crimson:dc143c
cyan:00ffff darkblue:00008b darkcyan:008b8b darkgoldenrod:b8860b darkgray:a9a9a9
darkgreen:006400 darkgrey:a9a9a9 darkkhaki:bdb76b darkmagenta:8b008b
darkolivegreen:556b2f darkorange:ff8c00 darkorchid:9932cc darkred:8b0000
darksalmon:e9967a darkseagreen:8fbc8f darkslateblue:483d8b darkslategray:2f4f4f
darkslategrey:2f4f4f darkturquoise:00ced1 darkviolet:9400d3 deeppink:ff1493
deepskyblue:00bfff dimgray:696969 dimgrey:696969 dodgerblue:1e90ff firebrick:b22222
floralwhite:fffaf0 forestgreen:228b22 fuchsia:ff00ff gainsboro:dcdcdc ghostwhite:f8f8ff
gold:ffd700 goldenrod:daa520 gray:808080 green:008000 greenyellow:adff2f grey:808080
honeydew:f0fff0 hotpink:ff69b4 indianred:cd5c5c indigo:4b0082 ivory:fffff0 khaki:f0e68c
lavender:e6e6fa lavenderblush:fff0f5 lawngreen:7cfc00 lemonchiffon:fffacd
lightblue:add8e6 lightcoral:f08080 lightcyan:e0ffff lightgoldenrodyellow:fafad2
lightgray:d3d3d3 lightgreen:90ee90 lightgrey:d3d3d3 lightpink:ffb6c1 lightsalmon:ffa07a
lightseagreen:20b2aa lightskyblue:87cefa lightslategray:778899 lightslategrey:778899
lightsteelblue:b0c4de lightyellow:ffffe0 lime:00ff00 limegreen:32cd32 linen:faf0e6
magenta:ff00ff maroon:800000 mediumaquamarine:66cdaa mediumblue:0000cd
mediumorchid:ba55d3 mediumpurple:9370db mediumseagreen:3cb371 mediumslateblue:7b68ee
mediumspringgreen:00fa9a mediumturquoise:48d1cc mediumvioletred:c71585
midnightblue:191970 mintcream:f5fffa mistyrose:ffe4e1 moccasin:ffe4b5 navajowhite:ffdead
navy:000080 oldlace:fdf5e6 olive:808000 olivedrab:6b8e23 orange:ffa500 orangered:ff4500
orchid:da70d6 palegoldenrod:eee8aa palegreen:98fb98 paleturquoise:afeeee
palevioletred:db7093 papayawhip:ffefd5 peachpuff:ffdab9 peru:cd853f pink:ffc0cb
plum:dda0dd powderblue:b0e0e6 purple:800080 rebeccapurple:663399 red:ff0000
rosybrown:bc8f8f royalblue:4169e1 saddlebrown:8b4513 salmon:fa8072 sandybrown:f4a460
seagreen:2e8b57 seashell:fff5ee sienna:a0522d silver:c0c0c0 skyblue:87ceeb
slateblue:6a5acd slategray:708090 slategrey:708090 snow:fffafa springgreen:00ff7f
steelblue:4682b4 tan:d2b48c teal:008080 thistle:d8bfd8 tomato:ff6347 turquoise:40e0d0
violet:ee82ee wheat:f5deb3 white:ffffff whitesmoke:f5f5f5 yellow:ffff00
yellowgreen:9acd32
""".split())
_TABLEAU_COLORS = dict(kv.split(":") for kv in """
blue:1f77b4 orange:ff7f0e green:2ca02c red:d62728 purple:9467bd brown:8c564b pink:e377c2
gray:7f7f7f olive:bcbd22 cyan:17becf
""".split())
_BASE_COLORS = {"b": (0.0, 0.0, 1.0), "g": (0.0, 0.5, 0.0), "r": (1.0, 0.0, 0.0),
                "c": (0.0, 0.75, 0.75), "m": (0.75, 0.0, 0.75), "y": (0.75, 0.75, 0.0),
                "k": (0.0, 0.0, 0.0), "w": (1.0, 1.0, 1.0)}


def color_str2rgb(color: str) -> Tuple[float, float, float]:
    """A colour string -> RGB floats in [0, 1], as matplotlib's ``to_rgb``
    reads it: a CSS4 name (``"white"``, ``"darkslategray"``; any case), a
    Tableau name (``"tab:blue"``), a base letter (``"r"``), a hex string
    (``#rgb``, ``#rgba``, ``#rrggbb``, ``#rrggbbaa``; alpha dropped) or a
    gray level (``"0.5"``).  Other strings (the xkcd names, the ``C0``
    cycle) raise ``ValueError``."""
    c = color.lower()
    if c.startswith("tab:") and c[4:] in _TABLEAU_COLORS:
        c = "#" + _TABLEAU_COLORS[c[4:]]
    elif c in _CSS4_COLORS:
        c = "#" + _CSS4_COLORS[c]
    elif color in _BASE_COLORS:
        return _BASE_COLORS[color]
    if c.startswith("#"):
        digits = c[1:]
        if len(digits) in (3, 4):
            digits = "".join(d * 2 for d in digits)
        if len(digits) in (6, 8) and all(d in "0123456789abcdef" for d in digits):
            return tuple(int(digits[i:i + 2], 16) / 255 for i in (0, 2, 4))
    else:
        try:
            gray = float(c)
        except ValueError:
            gray = None
        if gray is not None and 0.0 <= gray <= 1.0:
            return (gray, gray, gray)
    raise ValueError(f"Invalid color {color!r}")


class loader:
    """Decorator of a data-file reader ``fn(path, ...)``: a missing path, or
    an ``OSError``, ``KeyError`` or ``ValueError`` while reading, becomes
    ``logger.error`` (which ends the process through an
    :class:`ExitHandler`), or ``FileNotFoundError`` without a logger."""

    def __init__(self, logger=None):
        self.logger = logger

    def __call__(self, fn):
        def wrapped(path, *args, **kwargs):
            p = Path(path)
            msg = None
            if not p.exists():
                msg = f'Path "{p}" does not exist'
            else:
                try:
                    return fn(path, *args, **kwargs)
                except (OSError, KeyError, ValueError) as e:
                    msg = f'Failed loading "{p}": {e}'
            if self.logger is not None:
                self.logger.error(msg)
            else:
                raise FileNotFoundError(msg)

        return wrapped


def cycle(iterable: Iterable):
    """The items of ``iterable`` over and over."""
    while True:
        for item in iterable:
            yield item


def rmtree(path: Path) -> None:
    """Delete a file, or a directory and everything in it."""
    path = Path(path)
    if path.is_file():
        path.unlink()
    else:
        for child in path.iterdir():
            rmtree(child)
        path.rmdir()


def get_git_sha() -> str:
    """The checkout's commit, for a checkpoint's version stamp ("unknown"
    outside a git checkout)."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=Path(__file__).parent, stderr=subprocess.DEVNULL,
        ).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
