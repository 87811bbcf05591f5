"""Volume-rendering compositor over a ray-major sample stream (counterpart
of ``nerfstyle_tpu/ops/compositing.py``).

A stream is described by ray offsets ``[N+1]``: ray r owns samples
``offsets[r] .. offsets[r+1]-1`` in front-to-back order (what the marcher
emits).  Per ray, sample i gets

    sdt_i = min(sigma_i * dt, 100),  alpha_i = 1 - exp(-sdt_i),
    T_i = exp(-sum_{j<i} sdt_j),     w_i = alpha_i * T_i  if T_i >= t_thresh else 0,

and the per-ray outputs are ``weights_sum = sum w_i``, ``depth = sum w_i *
tau_i``, for channels ``ch`` ``sum w_i * ch_i``, and the included count
``n_inc`` (samples with ``T_i >= t_thresh``, a prefix of the ray).

:func:`sample_weights` launches kernel K4 (forward) and :func:`segment_sum`
kernel K7 (``csrc/composite.cu``) on CUDA tensors.  Their plain versions
keep the JAX formula — the exclusive in-ray cumsum as a flat cumsum minus
the sum in front of the segment, and segment sums — but accumulate in
float64: on a frame-sized stream a flat fp32 cumsum reaches ~1e6 and loses
the digits of a late ray's optical depth.

:func:`sample_weights_entering` is K4 for a round of the incremental
renderer (kernel K4i): each ray's samples enter with the transmittance
``t0`` the ray kept from its earlier rounds, ``T_i = t0 * exp(-sum_{j<i}
sdt_j)``, and the ray leaves with ``t_out = t0 * exp(-sum sdt)``.

:func:`segment_sum_grad` is K7 made differentiable on its own
(:class:`SegmentSum`), for a stream whose weights are fixed, as the style
stage's cached weights are: its backward is kernel K7b, ``d ch = w *
g[ray]``, and it gives ``d w`` only when ``w`` asks for one.

:func:`composite_rays` is the differentiable compositor of a train step
(:class:`CompositeRays`): K4 forward then K7, and in the backward kernel
K4b, one reverse pass per ray for the density and channel gradients.  Its
plain backward is autograd through the plain forward.

:class:`CompositeOutput`, :func:`segment_exclusive_cumsum` and
:func:`significance` are JAX's names for the compositor's record and its
scan over a padded ``ray_id`` stream; no path calls them (the kernels
scan inside a ray's warp), so they stay tensor operations.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import kernels, use_kernel

# Optical-depth cap: alpha == 1 and T == 0 exactly in fp32 above ~88, so the
# cap changes nothing but keeps an inf density from making inf - inf.
OPTICAL_DEPTH_CAP = 100.0


class CompositeOutput(NamedTuple):
    """Per-ray outputs of a compositor (JAX's ``CompositeOutput``)."""

    image: torch.Tensor  # [N, C] accumulated channels (rgb + class logits)
    weights_sum: torch.Tensor  # [N] pixel alpha
    depth: torch.Tensor  # [N] weighted depth integral (before normalization)


def segment_exclusive_cumsum(x: torch.Tensor, ray_id: torch.Tensor, num_rays: int) -> torch.Tensor:
    """Exclusive cumulative sum of ``x`` [M] within each ray's contiguous
    segment (JAX's ``segment_exclusive_cumsum``): samples sorted by
    ``ray_id`` [M], padding rows at ``ray_id == num_rays``.

    Library API, as :func:`significance`: no path calls either.  Kernels
    K4 and K4i scan each ray's optical depth in their own warps, so these
    stay tensor operations on either device, JAX's formula (a flat cumsum
    less the sum of the segments in front) with float64 sums (integer x:
    int64), returned in x's dtype."""
    acc = torch.float64 if x.is_floating_point() else torch.int64
    x64 = x.to(acc)
    seg_totals = torch.zeros((num_rays + 1,), dtype=acc, device=x.device)
    seg_totals.index_add_(0, ray_id.to(torch.int64), x64)
    prev_total = torch.cumsum(seg_totals, 0) - seg_totals
    return (torch.cumsum(x64, 0) - x64 - prev_total[ray_id.to(torch.int64)]).to(x.dtype)


def significance(
    sigmas: torch.Tensor,
    ray_id: torch.Tensor,
    valid: torch.Tensor,
    num_rays: int,
    dt: float,
    t_thresh: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The inclusion math of the compositor (JAX's ``significance``) on a
    stream of densities ``sigmas`` [M] (density_scale applied), their
    ``ray_id`` and ``valid`` mask: ``(included, sdt, trans)``, the mask
    ``T_i >= t_thresh`` (not and-ed with ``valid``: an invalid row's
    optical depth is 0), each sample's optical depth capped at
    ``OPTICAL_DEPTH_CAP`` and the transmittance entering it.  Library API
    on plain tensor operations (see :func:`segment_exclusive_cumsum`):
    the paths' compositors compute the same inside K4 and K4i."""
    sdt = torch.where(valid, torch.clamp(sigmas * dt, max=OPTICAL_DEPTH_CAP),
                      torch.zeros_like(sigmas))
    trans = torch.exp(-segment_exclusive_cumsum(sdt, ray_id, num_rays))
    return trans >= t_thresh, sdt, trans


def ray_ids(offsets: torch.Tensor) -> torch.Tensor:
    """[M] ray index of every sample of a stream with the given offsets."""
    n = offsets.shape[0] - 1
    counts = offsets[1:] - offsets[:-1]
    return torch.repeat_interleave(torch.arange(n, device=offsets.device), counts)


def weight_cutoffs(w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """[N] int64: the number of samples of each ray up to and including its
    last nonzero weight (0 for a ray without one): where the ray stopped."""
    n = offsets.shape[0] - 1
    rid = ray_ids(offsets)
    local = torch.arange(w.shape[0], device=w.device) - offsets[:-1][rid]
    last = torch.where(w != 0, local + 1, torch.zeros_like(local))
    return torch.zeros(n, dtype=torch.int64, device=w.device).scatter_reduce_(0, rid, last, "amax")


def segment_totals_plain(v: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-ray sums [N, ...] of the stream rows v [M, ...], as differences of
    a float64 (integer v: int64) running sum, returned in v's dtype."""
    acc = torch.float64 if v.is_floating_point() else torch.int64
    cs = torch.zeros((v.shape[0] + 1,) + tuple(v.shape[1:]), dtype=acc, device=v.device)
    cs[1:] = torch.cumsum(v.to(acc), dim=0)
    return (cs[offsets[1:]] - cs[offsets[:-1]]).to(v.dtype)


def entering_transmittance_plain(
    sigmas: torch.Tensor, offsets: torch.Tensor, dt: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sdt [M], T [M]): each sample's capped optical depth and the
    transmittance entering it, by the JAX formula ``excl = cumsum(sdt) - sdt
    - (sum of the rays in front)[ray]`` with float64 sums."""
    rid = ray_ids(offsets)
    sdt = torch.clamp(sigmas * dt, max=OPTICAL_DEPTH_CAP)
    sdt64 = sdt.to(torch.float64)
    seg_totals = segment_totals_plain(sdt64, offsets)
    prev_total = torch.cumsum(seg_totals, dim=0) - seg_totals
    excl = (torch.cumsum(sdt64, dim=0) - sdt64 - prev_total[rid]).to(sigmas.dtype)
    return sdt, torch.exp(-excl)


def sample_weights_plain(
    sigmas: torch.Tensor,
    tau: torch.Tensor,
    offsets: torch.Tensor,
    dt: float,
    t_thresh: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K4: (w [M], weights_sum [N], depth [N], n_inc [N] i32)."""
    sdt, trans = entering_transmittance_plain(sigmas, offsets, dt)
    alpha = 1.0 - torch.exp(-sdt)
    inc = trans >= t_thresh
    w = alpha * trans * inc.to(sigmas.dtype)
    n_inc = segment_totals_plain(inc.to(torch.int64), offsets).to(torch.int32)
    return w, segment_totals_plain(w, offsets), segment_totals_plain(w * tau, offsets), n_inc


def sample_weights(
    sigmas: torch.Tensor,
    tau: torch.Tensor,
    offsets: torch.Tensor,
    dt: float,
    t_thresh: float,
    *,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compositing weights ``w`` [M] (already density_scale-multiplied
    ``sigmas``) with the per-ray ``weights_sum``, ``depth`` and included
    count ``n_inc`` [N].

    CUDA tensors go through kernel K4; CPU tensors (or ``plain=True``)
    through :func:`sample_weights_plain`."""
    if not use_kernel(sigmas, plain):
        return sample_weights_plain(sigmas, tau, offsets, dt, t_thresh)
    return kernels.composite_weights(
        sigmas.contiguous(), tau.contiguous(), offsets.contiguous(), dt, t_thresh
    )


def sample_weights_entering_plain(
    sigmas: torch.Tensor,
    tau: torch.Tensor,
    offsets: torch.Tensor,
    t0: torch.Tensor,
    dt: float,
    t_thresh: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K4i: (w [M], weights_sum [N], depth [N], t_out [N]), JAX's
    round composite (``make_incremental_renderer``) with float64 sums."""
    sdt, trans = entering_transmittance_plain(sigmas, offsets, dt)
    trans = t0[ray_ids(offsets)] * trans
    alpha = 1.0 - torch.exp(-sdt)
    w = alpha * trans * (trans >= t_thresh).to(sigmas.dtype)
    total = segment_totals_plain(sdt.to(torch.float64), offsets).to(sigmas.dtype)
    return (w, segment_totals_plain(w, offsets), segment_totals_plain(w * tau, offsets),
            t0 * torch.exp(-total))


def sample_weights_entering(
    sigmas: torch.Tensor,
    tau: torch.Tensor,
    offsets: torch.Tensor,
    t0: torch.Tensor,
    dt: float,
    t_thresh: float,
    *,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weights ``w`` [M] of a round of samples (``sigmas`` already
    density_scale-multiplied) whose rays enter with transmittance ``t0``
    [N], with the per-ray ``weights_sum``, ``depth`` and leaving
    transmittance ``t_out`` [N].  No gradient: inference only.

    CUDA tensors go through kernel K4i; CPU tensors (or ``plain=True``)
    through :func:`sample_weights_entering_plain`."""
    if not use_kernel(sigmas, plain):
        return sample_weights_entering_plain(sigmas, tau, offsets, t0, dt, t_thresh)
    return kernels.composite_weights_entering(
        sigmas.contiguous(), tau.contiguous(), offsets.contiguous(), t0.contiguous(), dt, t_thresh
    )


def segment_sum_plain(w: torch.Tensor, ch: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain K7: [N, C] per-ray sums of w[:, None] * ch (float64 sums)."""
    return segment_totals_plain(w[:, None] * ch, offsets)


def segment_sum(
    w: torch.Tensor, ch: torch.Tensor, offsets: torch.Tensor, *, plain: bool = False
) -> torch.Tensor:
    """Per-ray weighted channel sums ``sum_i w_i * ch_i`` -> [N, C].

    CUDA tensors go through kernel K7; CPU tensors (or ``plain=True``)
    through :func:`segment_sum_plain`."""
    if not use_kernel(w, plain):
        return segment_sum_plain(w, ch, offsets)
    return kernels.segment_sum(w.contiguous(), ch.contiguous(), offsets.contiguous())


def segment_sum_backward_plain(w: torch.Tensor, ch: torch.Tensor, g: torch.Tensor,
                               offsets: torch.Tensor, need_dw: bool = False):
    """Plain K7b: (d_ch = w * g[ray] [S, C], d_w = sum_c ch * g[ray] [S] or
    None)."""
    g_rows = g[ray_ids(offsets)]
    d_w = (ch * g_rows).sum(dim=1) if need_dw else None
    return w[:, None] * g_rows, d_w


class SegmentSum(torch.autograd.Function):
    """Differentiable K7: forward K7, backward K7b (or their plain
    versions).  ``offsets`` must cover the stream (offsets[0] = 0,
    offsets[N] = S)."""

    @staticmethod
    def forward(ctx, w, ch, offsets, plain):
        ctx.save_for_backward(w, ch, offsets)
        ctx.plain = plain
        return segment_sum(w, ch, offsets, plain=plain)

    @staticmethod
    def backward(ctx, g):
        w, ch, offsets = ctx.saved_tensors
        need_dw = ctx.needs_input_grad[0]
        if use_kernel(w, ctx.plain):
            d_ch, d_w = kernels.segment_sum_backward(w.contiguous(), ch.contiguous(),
                                                     g.contiguous(), offsets.contiguous(), need_dw)
        else:
            d_ch, d_w = segment_sum_backward_plain(w, ch, g, offsets, need_dw)
        return d_w, d_ch, None, None


def segment_sum_grad(
    w: torch.Tensor, ch: torch.Tensor, offsets: torch.Tensor, *, plain: bool = False
) -> torch.Tensor:
    """:func:`segment_sum`, differentiable in ``ch`` (and in ``w`` when it
    requires a gradient); see :class:`SegmentSum`."""
    return SegmentSum.apply(w, ch, offsets, plain)


def composite_backward_plain(sigmas, ch, tau, offsets, g_img, g_ws, g_depth, dt, t_thresh):
    """Plain K4b: (d_sigmas [M], d_ch [M, C]) by autograd through the plain
    forward (float64 sums), the inclusion mask held fixed as in JAX."""
    with torch.enable_grad():
        s = sigmas.detach().requires_grad_(True)
        c = ch.detach().requires_grad_(True)
        w, ws, depth, _ = sample_weights_plain(s, tau, offsets, dt, t_thresh)
        image = segment_sum_plain(w, c, offsets)
        return torch.autograd.grad((image, ws, depth), (s, c), (g_img, g_ws, g_depth),
                                   allow_unused=True)


class CompositeRays(torch.autograd.Function):
    """Differentiable compositor: forward K4 + K7, backward K4b (or their
    plain versions); ``n_inc`` is returned without a gradient."""

    @staticmethod
    def forward(ctx, sigmas, ch, tau, offsets, dt, t_thresh, plain):
        w, ws, depth, n_inc = sample_weights(sigmas, tau, offsets, dt, t_thresh, plain=plain)
        image = segment_sum(w, ch, offsets, plain=plain)
        ctx.save_for_backward(sigmas, ch, tau, offsets, w, n_inc)
        ctx.dt, ctx.t_thresh, ctx.plain = dt, t_thresh, plain
        ctx.mark_non_differentiable(n_inc)
        return image, ws, depth, n_inc

    @staticmethod
    def backward(ctx, g_img, g_ws, g_depth, _g_n_inc):
        # Cotangents of unused outputs arrive as zeros (materialized grads).
        sigmas, ch, tau, offsets, w, n_inc = ctx.saved_tensors
        if use_kernel(sigmas, ctx.plain):
            d_sig, d_ch = kernels.composite_backward(
                *(t.contiguous() for t in (sigmas, ch, tau, w, offsets, n_inc, g_img, g_ws,
                                           g_depth)), ctx.dt,
            )
        else:
            d_sig, d_ch = composite_backward_plain(sigmas, ch, tau, offsets, g_img, g_ws,
                                                   g_depth, ctx.dt, ctx.t_thresh)
        return d_sig, d_ch, None, None, None, None, None


def composite_rays(
    sigmas: torch.Tensor,
    ch: torch.Tensor,
    tau: torch.Tensor,
    offsets: torch.Tensor,
    dt: float,
    t_thresh: float,
    *,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite per-sample densities ``sigmas`` [M] (density_scale applied)
    and channels ``ch`` [M, C] of a ray-major stream into (image [N, C],
    weights_sum [N], depth [N], n_inc [N] i32), differentiable in sigmas and
    ch (see :class:`CompositeRays`)."""
    return CompositeRays.apply(sigmas, ch, tau, offsets, dt, t_thresh, plain)
