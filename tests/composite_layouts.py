"""Crafted ray layouts for the compositor (K4 forward, K4b backward), and a
numpy emulation of the kernels' order of operations (one warp a ray: chunks
of 32 samples, warp scans and warp sums in a fixed tree).

The CPU tests hold the port's plain versions against the JAX package on
these layouts and the emulation against float64; the card tests
(tests/test_torch_kernels.py) hold the kernels against the plain versions
on them.  Imports no JAX.
"""

import numpy as np

DT = 2.0 * 1.7320508075688772 / 128
T_THRESH = 1e-4
LENGTHS = (0, 1, 31, 32, 33, 63, 64, 65, 1000)
LAYOUTS = ("lengths", "cutoff on lane 31", "cutoff on lane 0 of the next chunk",
           "saturated at the first sample", "inf mid-chunk", "zero density")
CHANNELS = (3, 4, 7)


def _rays(name: str, rng):
    """The layout's rays (densities, one array a ray) and the included count
    each crafted ray must have (None where it is left to the densities).
    Every layout starts with an empty ray and a faint 20-sample one, whose
    gradients are of a train step's size (the saturated layout's are ~1e-6
    on their own)."""
    rays, want = [np.zeros(0), np.exp(rng.normal(np.log(0.3), 0.5, size=20))], [0, 20]
    if name == "lengths":
        # Faint rays (optical depth ~0.005 a sample: none stops, the
        # 1000-sample one included whole) and denser ones (~0.025: the
        # 1000-sample ray stops in a later chunk).
        for scale, stops in ((0.15, False), (0.8, True)):
            for k in LENGTHS:
                rays.append(np.exp(rng.normal(np.log(scale), 0.5, size=k)))
                want.append(None if stops else k)
    elif name.startswith("cutoff"):
        # Optical depth 0.008 a sample, then 20 at sample k - 1: samples 0 ..
        # k - 1 are included, the first excluded is sample k, on lane 31 (k =
        # 31, 63) or on lane 0 of the next chunk (k = 32, 64).
        cuts = (31, 63) if name == "cutoff on lane 31" else (32, 64)
        for k in cuts:
            for n in (k + 9, 100):
                s = np.full(n, 0.3)
                s[k - 1] = 20.0 / DT
                rays.append(s)
                want.append(k)
    elif name == "saturated at the first sample":
        # Optical depth 12 (T = 6e-6 behind it) or an infinite density (the
        # cap, 100) at sample 0.
        for n, first in ((1, 12.0 / DT), (5, 12.0 / DT), (40, 12.0 / DT), (40, np.inf)):
            s = np.exp(rng.normal(0.0, 0.5, size=n))
            s[0] = first
            rays.append(s)
            want.append(1)
    elif name == "inf mid-chunk":
        for n, at in ((40, 10), (100, 45)):
            s = np.exp(rng.normal(np.log(0.3), 0.5, size=n))
            s[at] = np.inf
            rays.append(s)
            want.append(at + 1)
    elif name == "zero density":
        for n in (1, 5, 33, 100):
            rays.append(np.zeros(n))
            want.append(n)
    else:
        raise ValueError(name)
    return rays, want


def layout(name: str, channels: int):
    """A ray-major stream of the named layout: (sigmas [M] f32, tau [M] f32,
    ch [M, C] f32, offsets [N+1] i64, (gI [N, C], gW [N], gD [N]) f32, want)
    with want [N] the included count each crafted ray must have (-1 where
    the densities decide)."""
    rng = np.random.default_rng(LAYOUTS.index(name) * 10 + channels)
    rays, want = _rays(name, rng)
    counts = [r.shape[0] for r in rays]
    m, n = sum(counts), len(rays)
    sigmas = np.concatenate(rays).astype(np.float32)
    tau = rng.uniform(0.0, 3.0, size=m).astype(np.float32)
    ch = rng.normal(size=(m, channels)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    g = tuple(rng.normal(size=s).astype(np.float32) for s in ((n, channels), (n,), (n,)))
    return sigmas, tau, ch, offsets, g, np.array([-1 if k is None else k for k in want])


def per_ray(a, offsets, fill=0, rays=20, row=1024):
    """[rays, row, ...]: ray r's samples at the front of row r, the rest
    ``fill`` (one ray a row, for a per-ray evaluation of the JAX package)."""
    out = np.full((rays, row) + a.shape[1:], fill, a.dtype)
    for r in range(offsets.shape[0] - 1):
        out[r, :offsets[r + 1] - offsets[r]] = a[offsets[r]:offsets[r + 1]]
    return out


# ---------------------------------------------------------------------------
# The kernels' order of operations in numpy float32 (csrc/composite.cu).
# np.exp of a float32 is not CUDA's expf (both within ~1 ulp); every sum and
# product is rounded on its own in the kernels' order.
# ---------------------------------------------------------------------------

_LANES = np.arange(32)


def _scan(x):
    """Inclusive warp scan (lane order, Kogge-Stone)."""
    x = x.copy()
    for off in (1, 2, 4, 8, 16):
        x[off:] = x[:-off] + x[off:]
    return x


def _suffix_scan(x):
    """Inclusive warp scan from the last lane down."""
    x = x.copy()
    for off in (1, 2, 4, 8, 16):
        x[:-off] = x[:-off] + x[off:]
    return x


def _warp_sum(x):
    """Butterfly warp sum (every lane the same bits)."""
    for off in (16, 8, 4, 2, 1):
        x = x + x[_LANES ^ off]
    return x[0]


def _chunk(sig, base, end):
    """Lane indices, validity and capped optical depth of the chunk at base."""
    i = base + _LANES
    valid = i < end
    s = np.where(valid, sig[np.minimum(i, max(end - 1, 0))], np.float32(0))
    sdt = np.where(valid, np.minimum(s * np.float32(DT), np.float32(100)), np.float32(0))
    return i, valid, sdt.astype(np.float32)


def emulate_weights(sigmas, tau, offsets):
    """K4's forward, warp by warp: (w [M], weights_sum [N], depth [N],
    n_inc [N])."""
    f32 = np.float32
    n = offsets.shape[0] - 1
    w = np.zeros_like(sigmas)
    ws, dep, n_inc = np.zeros(n, f32), np.zeros(n, f32), np.zeros(n, np.int64)
    with np.errstate(over="ignore", invalid="ignore"):
        for r in range(n):
            begin, end = int(offsets[r]), int(offsets[r + 1])
            carry, s_w, s_d, stop = f32(0), f32(0), f32(0), end
            for base in range(begin, end, 32):
                i, valid, sdt = _chunk(sigmas, base, end)
                incl = _scan(sdt)
                excl = np.concatenate([[f32(0)], incl[:-1]]).astype(f32)
                trans = np.exp(-(carry + excl)).astype(f32)
                out = valid & ~(trans >= f32(T_THRESH))
                cut = int(np.argmax(out)) if out.any() else 32
                inc = valid & (_LANES < cut)
                wi = np.where(inc, (f32(1) - np.exp(-sdt)) * trans, f32(0)).astype(f32)
                w[i[valid]] = wi[valid]
                t = np.where(inc, tau[np.minimum(i, end - 1)], f32(0)).astype(f32)
                s_w = f32(s_w + _warp_sum(wi))
                s_d = f32(s_d + _warp_sum((wi * t).astype(f32)))
                if out.any():
                    stop = base + cut
                    break
                carry = f32(carry + incl[31])
            ws[r], dep[r], n_inc[r] = s_w, s_d, stop - begin
    return w, ws, dep, n_inc


def emulate_backward(sigmas, ch, tau, w, offsets, n_inc, g_img, g_ws, g_depth):
    """K4b, warp by warp: (d_sigmas [M], d_ch [M, C])."""
    f32 = np.float32
    n, c = offsets.shape[0] - 1, ch.shape[1]
    d_s, d_c = np.zeros_like(sigmas), np.zeros_like(ch)
    with np.errstate(over="ignore", invalid="ignore"):
        for r in range(n):
            begin = int(offsets[r])
            stop = begin + int(n_inc[r])
            if stop == begin:
                continue
            carry, t_next = f32(0), {}
            for base in range(begin, stop, 32):
                i, valid, sdt = _chunk(sigmas, base, stop)
                incl = _scan(sdt)
                t_next[base] = np.exp(-(carry + incl)).astype(f32)
                carry = f32(carry + incl[31])
            later = f32(0)
            for base in sorted(t_next, reverse=True):
                i, valid, _ = _chunk(sigmas, base, stop)
                j = np.minimum(i, stop - 1)
                v = (g_ws[r] + g_depth[r] * tau[j]).astype(f32)
                for k in range(c):
                    v = (v + g_img[r, k] * ch[j, k]).astype(f32)
                p = np.where(valid, w[j] * v, f32(0)).astype(f32)
                incl = _suffix_scan(p)
                excl = np.concatenate([incl[1:], [f32(0)]]).astype(f32)
                dsdt = (t_next[base] * v - (later + excl)).astype(f32)
                capped = ~(sigmas[j] * f32(DT) < f32(100))
                ds = np.where(capped, f32(0), f32(DT) * dsdt).astype(f32)
                d_s[i[valid]] = ds[valid]
                later = f32(later + incl[0])
            d_c[begin:stop] = w[begin:stop, None] * g_img[r][None, :]
    return d_s, d_c


def edge_rays(trans64: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """[N] bool: rays with a sample whose exact entering T lies within 1e-4
    relative of t_thresh (where fp32 may decide the cutoff either way)."""
    near = np.abs(trans64 - T_THRESH) <= 1e-4 * T_THRESH
    return np.add.reduceat(np.concatenate([near, [False]]).astype(np.int64),
                           offsets[:-1]) * (np.diff(offsets) > 0) > 0
