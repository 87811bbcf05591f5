"""Loader and launch wrappers of the hand-written Hopper kernels.

The CUDA sources in ``nerfstyle_torch/csrc/*.cu`` are compiled by ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, on first
use, under ``build/`` at the repository root (one ``nvcc -c`` per source,
all started together, then one link).  The library is keyed by a hash of the
sources, so a rebuilt checkout reuses it and an edited source rebuilds.  It
is loaded with ``ctypes``; every pointer and the stream travel as
``c_void_p``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on PyTorch's current stream without synchronising, raises
if the launch returns a nonzero CUDA status, and adds one to its entry of
:data:`launch_counts` per launch.  The wrappers take CUDA tensors only: the
plain PyTorch versions live beside their callers in ``nerfstyle_torch.ops``.

Nothing here runs at import: the CPU test suite imports this module on a
machine without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# Launches per kernel since the last reset_launch_counts().
launch_counts: Dict[str, int] = {
    "hashgrid_encode": 0,
    "hashgrid_backward": 0,
    "march_count": 0,
    "march_write": 0,
    "march_skip_count": 0,
    "march_skip_write": 0,
    "composite_weights": 0,
    "composite_backward": 0,
    "segment_sum": 0,
    "segment_sum_backward": 0,
    "mlp_forward": 0,
    "mlp_backward": 0,
    "mlp_dw_reduce": 0,
    "occupancy_scatter_max": 0,
    "occupancy_merge": 0,
    "occupancy_skipdist": 0,
    "occupancy_skipdist_general": 0,
    "packbits": 0,
    "unpackbits": 0,
    "morton3d": 0,
    "morton3d_invert": 0,
    "empty_kernel": 0,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "nst_hashgrid_encode": (_P, _P, _P, _P, _LL, _I, _I, _P),
    "nst_hashgrid_backward": (_P, _P, _P, _P, _LL, _I, _I, _P),
    "nst_march_count": (
        _P, _P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P,
    ),
    "nst_march_write": (
        _P, _P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P,
        _P, _P,
    ),
    "nst_composite_weights": (_P, _P, _P, _I, _F, _F, _P, _P, _P, _P, _P),
    "nst_composite_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P),
    "nst_segment_sum": (_P, _P, _P, _I, _I, _P, _P),
    "nst_segment_sum_backward": (_P, _P, _P, _P, _I, _I, _P, _P, _P),
    "nst_mlp_forward": (_P, _P, _LL, _I, _I, _I, _I, _I, _I, _P, _P),
    "nst_mlp_backward": (_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "nst_mlp_backward_grid": (_LL, _I, _I, _I, _I, ctypes.POINTER(_I)),
    "nst_mlp_dw_reduce": (_P, _I, _I, _I, _I, _I, _I, _P, _P),
    "nst_occupancy_scatter_max": (_P, _P, _P, _LL, _P),
    "nst_occupancy_num_partials": (),
    "nst_occupancy_merge": (_P, _P, _F, _LL, _F, _P, _P, _P, _P, _P),
    "nst_occupancy_skipdist": (_P, _I, _LL, _I, _P, _P),
    "nst_occupancy_skipdist_pass": (_P, _I, _I, _LL, _LL, _I, _P, _P),
    "nst_packbits": (_P, _LL, _P, _P),
    "nst_unpackbits": (_P, _LL, _P, _P),
    "nst_morton3d": (_P, _LL, _P, _P),
    "nst_morton3d_invert": (_P, _LL, _P, _P),
    "nst_empty_kernel": (_P,),
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if it is not built yet; return its path.

    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's output
    (registers, shared memory and spills of every kernel)."""
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD_DIR / f"libnerfstyle_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    procs: List[Tuple[Path, subprocess.Popen]] = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for obj, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(out, end="")
        if proc.returncode != 0:
            failed.append(f"{obj.stem}.cu (rc {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib.with_name(lib.name + f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for o, _ in procs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc {link.returncode}):\n{link.stdout}")
    os.replace(tmp, lib)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """Build (once) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.nst_error_string.argtypes = [ctypes.c_int]
            lib.nst_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _same_device(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    if any(t.device != dev for t in ts[1:]):
        raise ValueError("all tensors must lie on one device")


def _launched(lib: ctypes.CDLL, status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} launch failed: {lib.nst_error_string(status).decode()}")
    launch_counts[what] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# Table row widths K1 and K2 take (csrc/hashgrid.cu's instantiations).
HASHGRID_WIDTHS = (1, 2, 4)


def hashgrid_encode(x: torch.Tensor, table: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """K1: [B, 3] points in [0, 1] -> [B, L*C] features (see csrc/hashgrid.cu).

    ``levels`` is the int32 [4, L] table of level resolutions, table sizes,
    row offsets and simplex flags (``ops.hashgrid.level_table``)."""
    b = x.shape[0]
    _check("x", x, torch.float32, (None, 3))
    _check("table", table, torch.float32, (None, None))
    _check("levels", levels, torch.int32, (4, None))
    _same_device(x, table, levels)
    num_levels, c = levels.shape[1], table.shape[1]
    if c not in HASHGRID_WIDTHS:
        raise ValueError(f"table rows of width {c} are not supported {HASHGRID_WIDTHS}")
    out = torch.empty((b, num_levels * c), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    lib = library()
    status = lib.nst_hashgrid_encode(
        x.data_ptr(), table.data_ptr(), levels.data_ptr(), out.data_ptr(),
        b, num_levels, c, _stream(x),
    )
    _launched(lib, status, "hashgrid_encode")
    return out


def hashgrid_backward(
    x: torch.Tensor, g: torch.Tensor, levels: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """K2: the [num_rows, C] table gradient of K1 for the output cotangent
    ``g`` [B, L*C] at points ``x`` [B, 3] (see csrc/hashgrid.cu)."""
    b = x.shape[0]
    _check("x", x, torch.float32, (None, 3))
    _check("levels", levels, torch.int32, (4, None))
    num_levels = levels.shape[1]
    _check("g", g, torch.float32, (b, None))
    _same_device(x, g, levels)
    c = g.shape[1] // num_levels
    if c not in HASHGRID_WIDTHS or g.shape[1] != num_levels * c:
        raise ValueError(f"cotangent of width {g.shape[1]} is not L*C for C in {HASHGRID_WIDTHS}")
    grad = torch.zeros((num_rows, c), dtype=torch.float32, device=x.device)
    if b == 0:
        return grad
    lib = library()
    status = lib.nst_hashgrid_backward(
        x.data_ptr(), g.data_ptr(), levels.data_ptr(), grad.data_ptr(), b, num_levels, c,
        _stream(x),
    )
    _launched(lib, status, "hashgrid_backward")
    return grad


def _march_args(origins, dirs, nears, fars, bitfield, skip, dt, bound, t_lattice, cascade,
                grid_size, mip_dt_level, max_steps) -> tuple:
    """Check the inputs of both march passes; return their arguments up to
    the ray count, in the C order.  ``skip`` is None (the dense march, K3)
    or (skipdist [cascade*H^3] u8 from K6c, cells [cascade] f32 the world
    cell size of each level, the window length S, reach f32(S*dt)) for the
    two-stage march, K3s."""
    n = origins.shape[0]
    _check("origins", origins, torch.float32, (n, 3))
    _check("dirs", dirs, torch.float32, (n, 3))
    _check("nears", nears, torch.float32, (n,))
    _check("fars", fars, torch.float32, (n,))
    _check("bitfield", bitfield, torch.bool, (cascade * grid_size**3,))
    _same_device(origins, dirs, nears, fars, bitfield)
    skipdist_ptr, cells_ptr, window, reach = None, None, 8, 0.0
    if skip is not None:
        skipdist, cells, window, reach = skip
        _check("skipdist", skipdist, torch.uint8, (cascade * grid_size**3,))
        _check("cells", cells, torch.float32, (cascade,))
        _same_device(origins, skipdist, cells)
        skipdist_ptr, cells_ptr = skipdist.data_ptr(), cells.data_ptr()
    return (origins.data_ptr(), dirs.data_ptr(), nears.data_ptr(), fars.data_ptr(),
            bitfield.data_ptr(), skipdist_ptr, cells_ptr, dt, bound, t_lattice, cascade,
            grid_size, mip_dt_level, max_steps, window, reach, n)


def _sample_buffers(m: int, dev) -> Tuple[torch.Tensor, ...]:
    """The write pass's outputs: xyz [M, 3], dirs [M, 3], tau [M] f32, ray
    id and lattice index [M] i32."""
    return (torch.empty((m, 3), dtype=torch.float32, device=dev),
            torch.empty((m, 3), dtype=torch.float32, device=dev),
            torch.empty((m,), dtype=torch.float32, device=dev),
            torch.empty((m,), dtype=torch.int32, device=dev),
            torch.empty((m,), dtype=torch.int32, device=dev))


def march_count(origins, dirs, nears, fars, bitfield, skip=None,
                **geom) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3 pass 1 (K3s with ``skip``, see :func:`_march_args`): the
    kept-sample count [N] i32 of each ray, and its candidate windows [N] i32
    (None for the dense march).  ``geom`` holds dt, bound, t_lattice,
    cascade, grid_size, mip_dt_level and max_steps (see csrc/march.cu)."""
    args = _march_args(origins, dirs, nears, fars, bitfield, skip, **geom)
    n = origins.shape[0]
    counts = torch.zeros((n,), dtype=torch.int32, device=origins.device)
    cand = None if skip is None else torch.zeros_like(counts)
    if n > 0:
        lib = library()
        status = lib.nst_march_count(*args, counts.data_ptr(),
                                     None if cand is None else cand.data_ptr(), _stream(origins))
        _launched(lib, status, "march_count" if skip is None else "march_skip_count")
    return counts, cand


def march_write(origins, dirs, nears, fars, bitfield, offsets, num_kept: int, skip=None,
                **geom):
    """K3 pass 2 (K3s with ``skip``): (xyz [M,3], dirs [M,3], tau [M],
    ray_id [M] i32, step [M] i32) at the ray ``offsets`` [N+1] i64 that
    pass 1's counts give, M = ``num_kept``."""
    args = _march_args(origins, dirs, nears, fars, bitfield, skip, **geom)
    _check("offsets", offsets, torch.int64, (origins.shape[0] + 1,))
    _same_device(origins, offsets)
    out = _sample_buffers(num_kept, origins.device)
    if num_kept > 0:
        lib = library()
        status = lib.nst_march_write(*args, offsets.data_ptr(), *(t.data_ptr() for t in out),
                                     _stream(origins))
        _launched(lib, status, "march_write" if skip is None else "march_skip_write")
    return out


def march_rays(origins, dirs, nears, fars, bitfield, skip=None, **geom):
    """K3, or K3s with ``skip``: march N rays; returns (xyz [M,3], dirs [M,3],
    tau [M], ray_id [M] i32, step [M] i32, offsets [N+1] i64), ray-major, and
    the candidate-window count ``num_cand`` (a host int, 0 for the dense
    march) (see csrc/march.cu).

    Pass 1, an exclusive scan of its counts, and pass 2.  Synchronises once,
    for the sample and candidate counts."""
    counts, cand = march_count(origins, dirs, nears, fars, bitfield, skip, **geom)
    offsets = torch.zeros((counts.shape[0] + 1,), dtype=torch.int64, device=counts.device)
    offsets[1:] = torch.cumsum(counts, 0, dtype=torch.int64)
    if cand is None:
        m, num_cand = int(offsets[-1]), 0
    else:
        m, num_cand = torch.stack([offsets[-1], cand.sum(dtype=torch.int64)]).tolist()
    out = march_write(origins, dirs, nears, fars, bitfield, offsets, m, skip, **geom)
    return (*out, offsets, num_cand)


def composite_weights(
    sigmas: torch.Tensor,
    tau: torch.Tensor,
    offsets: torch.Tensor,
    dt: float,
    t_thresh: float,
):
    """K4 forward: per-sample weights w [M], per-ray weights_sum [N] and
    depth [N], and each ray's included count n_inc [N] i32 (samples with
    entering T >= t_thresh) over ray-major segments (see csrc/composite.cu)."""
    m = sigmas.shape[0]
    n = offsets.shape[0] - 1
    _check("sigmas", sigmas, torch.float32, (m,))
    _check("tau", tau, torch.float32, (m,))
    _check("offsets", offsets, torch.int64, (n + 1,))
    _same_device(sigmas, tau, offsets)
    w = torch.empty_like(sigmas)
    ws = torch.empty((n,), dtype=torch.float32, device=sigmas.device)
    depth = torch.empty((n,), dtype=torch.float32, device=sigmas.device)
    n_inc = torch.empty((n,), dtype=torch.int32, device=sigmas.device)
    if n > 0:
        lib = library()
        status = lib.nst_composite_weights(
            sigmas.data_ptr(), tau.data_ptr(), offsets.data_ptr(), n, dt, t_thresh,
            w.data_ptr(), ws.data_ptr(), depth.data_ptr(), n_inc.data_ptr(), _stream(sigmas),
        )
        _launched(lib, status, "composite_weights")
    return w, ws, depth, n_inc


def composite_backward(sigmas, ch, tau, w, offsets, n_inc, g_img, g_ws, g_depth, dt: float):
    """K4 backward: (d_sigmas [M], d_ch [M, C]) of the image [N, C],
    weights_sum [N] and depth [N] cotangents, given the forward's w and
    n_inc (see csrc/composite.cu)."""
    m, n = sigmas.shape[0], offsets.shape[0] - 1
    _check("sigmas", sigmas, torch.float32, (m,))
    _check("ch", ch, torch.float32, (m, None))
    c = ch.shape[1]
    _check("tau", tau, torch.float32, (m,))
    _check("w", w, torch.float32, (m,))
    _check("offsets", offsets, torch.int64, (n + 1,))
    _check("n_inc", n_inc, torch.int32, (n,))
    _check("g_img", g_img, torch.float32, (n, c))
    _check("g_ws", g_ws, torch.float32, (n,))
    _check("g_depth", g_depth, torch.float32, (n,))
    _same_device(sigmas, ch, tau, w, offsets, n_inc, g_img, g_ws, g_depth)
    d_sigmas = torch.empty_like(sigmas)
    d_ch = torch.empty_like(ch)
    if n > 0 and m > 0:
        lib = library()
        status = lib.nst_composite_backward(
            sigmas.data_ptr(), ch.data_ptr(), tau.data_ptr(), w.data_ptr(), offsets.data_ptr(),
            n_inc.data_ptr(), g_img.data_ptr(), g_ws.data_ptr(), g_depth.data_ptr(), n, c, dt,
            d_sigmas.data_ptr(), d_ch.data_ptr(), _stream(sigmas),
        )
        _launched(lib, status, "composite_backward")
    return d_sigmas, d_ch


# Channels a K7 or K7b launch takes (a CTA stages its rays' rows in shared
# memory, csrc/composite.cu).  A wider stream launches once a slice of at
# most this many channels: channels are independent, so the result is the
# same.
SEGMENT_MAX_CHANNELS = 64


def _channel_slices(c: int) -> List[slice]:
    return [slice(a, min(c, a + SEGMENT_MAX_CHANNELS))
            for a in range(0, c, SEGMENT_MAX_CHANNELS)]


def segment_sum(w: torch.Tensor, ch: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """K7: out[r] = sum of w[i] * ch[i] over ray r's segment -> [N, C]; one
    launch a slice of SEGMENT_MAX_CHANNELS channels."""
    s = w.shape[0]
    n = offsets.shape[0] - 1
    _check("w", w, torch.float32, (s,))
    _check("ch", ch, torch.float32, (s, None))
    _check("offsets", offsets, torch.int64, (n + 1,))
    _same_device(w, ch, offsets)
    c = ch.shape[1]
    if c > SEGMENT_MAX_CHANNELS:
        return torch.cat([segment_sum(w, ch[:, cs].contiguous(), offsets)
                          for cs in _channel_slices(c)], dim=1)
    out = torch.empty((n, c), dtype=torch.float32, device=w.device)
    if n > 0 and c > 0:
        lib = library()
        status = lib.nst_segment_sum(
            w.data_ptr(), ch.data_ptr(), offsets.data_ptr(), n, c, out.data_ptr(),
            _stream(w),
        )
        _launched(lib, status, "segment_sum")
    return out


def segment_sum_backward(
    w: torch.Tensor, ch: Optional[torch.Tensor], g: torch.Tensor, offsets: torch.Tensor,
    need_dw: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K7b: (d_ch [S, C], d_w [S] or None) of K7 for the output cotangent
    ``g`` [N, C]: d_ch = w * g[ray], d_w = sum_c ch * g[ray] (only with
    ``need_dw``, which reads ``ch``).  ``offsets`` [N+1] must cover the
    stream: offsets[0] = 0, offsets[N] = S (see csrc/composite.cu).  One
    launch a slice of SEGMENT_MAX_CHANNELS channels; d_w then adds the
    slices' sums in order."""
    s = w.shape[0]
    n = offsets.shape[0] - 1
    _check("w", w, torch.float32, (s,))
    _check("g", g, torch.float32, (n, None))
    _check("offsets", offsets, torch.int64, (n + 1,))
    c = g.shape[1]
    _same_device(w, g, offsets)
    if need_dw:
        _check("ch", ch, torch.float32, (s, c))
        _same_device(w, ch)
    if c > SEGMENT_MAX_CHANNELS:
        parts = [segment_sum_backward(w, ch[:, cs].contiguous() if need_dw else None,
                                      g[:, cs].contiguous(), offsets, need_dw)
                 for cs in _channel_slices(c)]
        d_w = None
        if need_dw:
            d_w = parts[0][1]
            for _, part in parts[1:]:
                d_w = d_w + part
        return torch.cat([d for d, _ in parts], dim=1), d_w
    d_ch = torch.empty((s, c), dtype=torch.float32, device=w.device)
    d_w = torch.empty((s,), dtype=torch.float32, device=w.device) if need_dw else None
    if n > 0 and c > 0 and s > 0:
        lib = library()
        status = lib.nst_segment_sum_backward(
            w.data_ptr(), ch.data_ptr() if need_dw else None, g.data_ptr(), offsets.data_ptr(),
            n, c, d_ch.data_ptr(), d_w.data_ptr() if need_dw else None, _stream(w),
        )
        _launched(lib, status, "segment_sum_backward")
    return d_ch, d_w


# K5's instantiations (csrc/mlp.cu): input widths, hidden width, hidden
# layers, output widths 1..MLP_MAX_OUT.
MLP_IN_DIMS = (16, 32)
MLP_HIDDEN = 64
MLP_HIDDEN_LAYERS = (1, 2)
MLP_MAX_OUT = 64


def _mlp_args(x: torch.Tensor, weights) -> Tuple[torch.Tensor, int, int]:
    """Check K5's input and weights; return the packed weights, the hidden
    depth and the output width."""
    _check("x", x, torch.float32, (None, None))
    in_dim, n = x.shape[1], len(weights)
    if in_dim not in MLP_IN_DIMS or n - 1 not in MLP_HIDDEN_LAYERS:
        raise ValueError(f"K5 takes inputs of width {MLP_IN_DIMS} and 1 or 2 hidden layers, "
                         f"got width {in_dim} and {n} layers")
    out_dim = weights[-1].shape[1]
    want = [(in_dim, MLP_HIDDEN)] + [(MLP_HIDDEN, MLP_HIDDEN)] * (n - 2) + [(MLP_HIDDEN, out_dim)]
    for i, (wt, shp) in enumerate(zip(weights, want)):
        if wt.dtype != torch.float32 or tuple(wt.shape) != shp:
            raise ValueError(f"K5 weight {i}: expected float32 {shp}, got {wt.dtype} "
                             f"{tuple(wt.shape)}")
    if not 1 <= out_dim <= MLP_MAX_OUT:
        raise ValueError(f"K5 takes outputs of width 1..{MLP_MAX_OUT}, got {out_dim}")
    _same_device(x, *weights)
    packed = torch.cat([wt.detach().reshape(-1) for wt in weights])
    return packed, n - 1, out_dim


def mlp_forward(x: torch.Tensor, weights, sigmoid: bool, bf16: bool) -> torch.Tensor:
    """K5 forward: the bias-free ReLU MLP of ``weights`` ([d_in, d_out]
    float32 each) on ``x`` [M, in] -> [M, out] float32, rounded to bf16 as
    under mixed precision when ``bf16`` (see csrc/mlp.cu)."""
    packed, n_hidden, out_dim = _mlp_args(x, weights)
    m = x.shape[0]
    out = torch.empty((m, out_dim), dtype=torch.float32, device=x.device)
    if m > 0:
        lib = library()
        status = lib.nst_mlp_forward(
            x.data_ptr(), packed.data_ptr(), m, x.shape[1], n_hidden, MLP_HIDDEN, out_dim,
            int(bf16), int(sigmoid), out.data_ptr(), _stream(x),
        )
        _launched(lib, status, "mlp_forward")
    return out


def mlp_backward_grid(m: int, in_dim: int, n_hidden: int, out_dim: int) -> int:
    """CTAs of K5's bf16 backward for ``m`` rows on the current device: its
    persistent grid, (CTAs that fit an SM) x (SMs), at most one a 64-row
    tile (see csrc/mlp.cu)."""
    lib = library()
    grid = ctypes.c_int(0)
    status = lib.nst_mlp_backward_grid(m, in_dim, n_hidden, MLP_HIDDEN, out_dim,
                                       ctypes.byref(grid))
    if status != 0:
        raise RuntimeError(f"mlp_backward grid query failed: {lib.nst_error_string(status).decode()}")
    return grid.value


def mlp_backward(x: torch.Tensor, weights, g: torch.Tensor, sigmoid: bool, bf16: bool,
                 need_dw) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """K5 backward: (d x [M, in], [d W_l or None]) for the output cotangent
    ``g`` [M, out]; d W_l only where ``need_dw[l]``, each summed over all
    rows and then rounded to bf16 when ``bf16``.

    In fp32 the gradient adds up with fp32 atomics.  Under ``bf16`` the
    kernel runs on the tensor cores over a persistent grid that writes one
    partial d W a CTA to a scratch, and a second launch (``mlp_dw_reduce``)
    sums the partials in CTA order: d W is the same bits from run to run."""
    packed, n_hidden, out_dim = _mlp_args(x, weights)
    m, in_dim = x.shape
    _check("g", g, torch.float32, (m, out_dim))
    _same_device(x, g)
    mask = sum(1 << i for i, need in enumerate(need_dw) if need)
    dx = torch.empty_like(x)
    dw = torch.zeros_like(packed) if mask else None
    if m > 0:
        lib = library()
        stream = _stream(x)
        target, grid = dw, 0
        if bf16 and mask:
            grid = mlp_backward_grid(m, in_dim, n_hidden, out_dim)
            target = torch.empty((grid, packed.numel()), dtype=torch.float32, device=x.device)
        status = lib.nst_mlp_backward(
            x.data_ptr(), packed.data_ptr(), g.data_ptr(), m, in_dim, n_hidden, MLP_HIDDEN,
            out_dim, int(bf16), int(sigmoid), mask, dx.data_ptr(),
            target.data_ptr() if mask else None, stream,
        )
        _launched(lib, status, "mlp_backward")
        if grid:
            status = lib.nst_mlp_dw_reduce(target.data_ptr(), grid, in_dim, n_hidden, MLP_HIDDEN,
                                           out_dim, mask, dw.data_ptr(), stream)
            _launched(lib, status, "mlp_dw_reduce")
    grads: List[Optional[torch.Tensor]] = []
    start = 0
    for i, wt in enumerate(weights):
        size = wt.numel()
        if mask >> i & 1:
            gw = dw[start:start + size].view(wt.shape)
            grads.append(gw.to(torch.bfloat16).float() if bf16 else gw)
        else:
            grads.append(None)
        start += size
    return dx, grads


def occupancy_scatter_max(tmp: torch.Tensor, idx: torch.Tensor, sig: torch.Tensor) -> torch.Tensor:
    """K6 scatter-max, in place: tmp[idx[p]] = max(tmp[idx[p]], sig[p]) over a
    grid ``tmp`` [K] filled below every probe (-1), probes ``sig`` >= 0 (see
    csrc/occupancy.cu).  Returns ``tmp``."""
    p = idx.shape[0]
    _check("tmp", tmp, torch.float32, (None,))
    _check("idx", idx, torch.int64, (p,))
    _check("sig", sig, torch.float32, (p,))
    _same_device(tmp, idx, sig)
    if p > 0:
        lib = library()
        status = lib.nst_occupancy_scatter_max(
            tmp.data_ptr(), idx.data_ptr(), sig.data_ptr(), p, _stream(tmp)
        )
        _launched(lib, status, "occupancy_scatter_max")
    return tmp


def occupancy_merge(grid: torch.Tensor, tmp: torch.Tensor, decay: float, density_thresh: float):
    """K6 merge and threshold of a density grid [K] with the probe grid
    ``tmp`` [K]: (merged grid [K], bitfield [K] bool, mean density f32
    scalar), see csrc/occupancy.cu.  One cooperative launch, no host sync;
    the same bits from launch to launch."""
    k = grid.shape[0]
    _check("grid", grid, torch.float32, (k,))
    _check("tmp", tmp, torch.float32, (k,))
    _same_device(grid, tmp)
    out = torch.empty_like(grid)
    bitfield = torch.empty((k,), dtype=torch.bool, device=grid.device)
    mean = torch.zeros((), dtype=torch.float32, device=grid.device)
    if k > 0:
        lib = library()
        partials = torch.empty((lib.nst_occupancy_num_partials(),), dtype=torch.float64,
                               device=grid.device)
        status = lib.nst_occupancy_merge(grid.data_ptr(), tmp.data_ptr(), decay, k,
                                         density_thresh, out.data_ptr(), bitfield.data_ptr(),
                                         partials.data_ptr(), mean.data_ptr(), _stream(grid))
        _launched(lib, status, "occupancy_merge")
    return out, bitfield, mean


# Launches a call of occupancy_skipdist (K6c): one fused pass; of
# occupancy_skipdist_general: three axis passes.
SKIPDIST_LAUNCHES = 1
SKIPDIST_GENERAL_LAUNCHES = 3
# Largest grid size the one-launch K6c takes (kSkipMaxGrid, csrc/occupancy.cu).
SKIPDIST_MAX_GRID = 128


def skipdist_one_launch_holds(grid_size: int) -> bool:
    """True for the grid sizes the one-launch K6c takes: multiples of 16 up
    to SKIPDIST_MAX_GRID (a slab and its halo in shared memory)."""
    return grid_size % 16 == 0 and 0 < grid_size <= SKIPDIST_MAX_GRID


def _skipdist_args(bitfield: torch.Tensor, grid_size: int) -> Tuple[int, torch.Tensor]:
    _check("bitfield", bitfield, torch.bool, (None,))
    n, h3 = bitfield.shape[0], grid_size**3
    if n % h3:
        raise ValueError(f"bitfield of {n} cells does not fit a {grid_size}^3 grid")
    return n, torch.empty((n,), dtype=torch.uint8, device=bitfield.device)


def occupancy_skipdist(bitfield: torch.Tensor, grid_size: int, dmax: int) -> torch.Tensor:
    """K6c: the [cascade*H^3] u8 skip distance of a bool bitfield (L-inf
    cells to the nearest occupied cell of the cascade, capped at ``dmax``),
    in one launch: a CTA dilates a slab of x-planes and its halo, packed as
    bits, in shared memory (see csrc/occupancy.cu).  Takes grid sizes that
    are multiples of 16 up to 128, and ``dmax`` up to 15; other grid sizes
    go to :func:`occupancy_skipdist_general`."""
    n, out = _skipdist_args(bitfield, grid_size)
    if n == 0:
        return out
    if not skipdist_one_launch_holds(grid_size):
        raise ValueError(f"K6c takes grid sizes that are multiples of 16 up to "
                         f"{SKIPDIST_MAX_GRID} (a slab and its halo in shared memory), got "
                         f"{grid_size}")
    if not 1 <= dmax <= 15:
        raise ValueError(f"K6c counts distances in 4 bits: dmax 1..15, got {dmax}")
    if bitfield.data_ptr() % 16:
        raise ValueError("bitfield: K6c reads 16 cells at once and needs a 16-byte aligned "
                         "tensor")
    lib = library()
    status = lib.nst_occupancy_skipdist(bitfield.data_ptr(), grid_size, n, dmax, out.data_ptr(),
                                        _stream(bitfield))
    _launched(lib, status, "occupancy_skipdist")
    return out


def occupancy_skipdist_general(bitfield: torch.Tensor, grid_size: int,
                               dmax: int) -> torch.Tensor:
    """K6c at any grid size: the same skip distance as
    :func:`occupancy_skipdist`, in three separable axis passes (z, y, x),
    one launch each (see csrc/occupancy.cu)."""
    n, out = _skipdist_args(bitfield, grid_size)
    if n == 0:
        return out
    if not 1 <= dmax <= 255:
        raise ValueError(f"K6c general keeps distances in a byte: dmax 1..255, got {dmax}")
    tmp = torch.empty_like(out)
    lib = library()
    stream = _stream(bitfield)
    for src, dst, stride in ((bitfield, out, 1), (out, tmp, grid_size),
                             (tmp, out, grid_size * grid_size)):
        status = lib.nst_occupancy_skipdist_pass(src.data_ptr(), int(src is bitfield), grid_size,
                                                 n, stride, dmax, dst.data_ptr(), stream)
        _launched(lib, status, "occupancy_skipdist_general")
    return out


def _aligned8(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 8:
        raise ValueError(f"{name}: K8a reads and writes 8 cells at once and needs an "
                         "8-byte aligned tensor")


def packbits(bitfield: torch.Tensor) -> torch.Tensor:
    """K8a pack: bool [K] -> u8 [K/8], LSB-first (see csrc/interop.cu)."""
    _check("bitfield", bitfield, torch.bool, (None,))
    k = bitfield.shape[0]
    if k % 8:
        raise ValueError(f"packbits takes a multiple of 8 cells, got {k}")
    _aligned8("bitfield", bitfield)
    out = torch.empty((k // 8,), dtype=torch.uint8, device=bitfield.device)
    if k > 0:
        lib = library()
        status = lib.nst_packbits(bitfield.data_ptr(), k // 8, out.data_ptr(), _stream(bitfield))
        _launched(lib, status, "packbits")
    return out


def unpackbits(packed: torch.Tensor) -> torch.Tensor:
    """K8a unpack: u8 [K/8] -> bool [K], LSB-first (see csrc/interop.cu)."""
    _check("packed", packed, torch.uint8, (None,))
    nb = packed.shape[0]
    out = torch.empty((8 * nb,), dtype=torch.bool, device=packed.device)
    if nb > 0:
        lib = library()
        status = lib.nst_unpackbits(packed.data_ptr(), nb, out.data_ptr(), _stream(packed))
        _launched(lib, status, "unpackbits")
    return out


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """K8b: [N, 3] i32 cell coordinates -> [N] i32 Morton codes (see
    csrc/interop.cu)."""
    _check("coords", coords, torch.int32, (None, 3))
    n = coords.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=coords.device)
    if n > 0:
        lib = library()
        status = lib.nst_morton3d(coords.data_ptr(), n, out.data_ptr(), _stream(coords))
        _launched(lib, status, "morton3d")
    return out


def morton3d_invert(codes: torch.Tensor) -> torch.Tensor:
    """K8b inverse: [N] i32 Morton codes -> [N, 3] i32 coordinates."""
    _check("codes", codes, torch.int32, (None,))
    n = codes.shape[0]
    out = torch.empty((n, 3), dtype=torch.int32, device=codes.device)
    if n > 0:
        lib = library()
        status = lib.nst_morton3d_invert(codes.data_ptr(), n, out.data_ptr(), _stream(codes))
        _launched(lib, status, "morton3d_invert")
    return out


def empty_kernel(device: torch.device) -> None:
    """Launch an empty kernel (one warp) on ``device``'s current stream: the
    least time a launch takes, which K8a's few microseconds are held
    against."""
    lib = library()
    status = lib.nst_empty_kernel(torch.cuda.current_stream(device).cuda_stream)
    _launched(lib, status, "empty_kernel")
