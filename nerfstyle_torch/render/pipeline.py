"""Field evaluation and compositing of a train batch (counterpart of
``nerfstyle_tpu/render/pipeline.py``).

Single-phase: the whole field on every marched sample, then the
differentiable compositor.  Two-phase (``TrainConfig.two_phase_train``, the
default): phase A runs the density branch without gradient on every marched
sample and K4 gives each ray's included count ``n_inc`` (entering T >=
t_thresh); phase B runs the whole differentiable field on each ray's first
``n_inc`` samples only, then the compositor.  A sample past a ray's cutoff
has weight and gradient exactly zero, so the two agree up to float
reassociation.  The keep set is ``T >= t_thresh``, not ``w > eps``: a kept
sample of zero density has zero weight but a nonzero density gradient.

Every buffer is sized from the counts, so (unlike the JAX capacity ladders)
nothing is truncated.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.types import BBox
from ..models.fields import FieldSpec, Params, field_apply, field_density
from ..ops.compositing import composite_rays, sample_weights
from ..ops.marching import SampleBatch


def kept_prefix(samples: SampleBatch, n_inc: torch.Tensor):
    """(idx [K] i64, kept offsets [N+1] i64): the stream positions of each
    ray's first ``n_inc`` samples, ray-major."""
    rid = samples.ray_id.long()
    local = torch.arange(samples.num_kept, device=rid.device) - samples.offsets[:-1][rid]
    idx = torch.nonzero(local < n_inc.to(torch.int64)[rid]).squeeze(1)
    kept = torch.zeros_like(samples.offsets)
    kept[1:] = torch.cumsum(n_inc.to(torch.int64), 0)
    return idx, kept


def eval_composite(
    spec: FieldSpec,
    params: Params,
    bbox: BBox,
    samples: SampleBatch,
    dt: float,
    t_thresh: float,
    density_scale: float,
    compute_dtype: torch.dtype = torch.float32,
    *,
    two_phase: bool = True,
    plain: bool = False,
) -> Dict[str, object]:
    """Evaluate and composite a marched batch: ``image`` [N, C],
    ``weights_sum`` [N], ``depth`` [N] (differentiable in ``params``) and
    the host count ``num_sig`` of samples with entering T >= t_thresh."""
    if not two_phase:
        ch, sigmas = field_apply(spec, params, bbox, samples.xyz, compute_dtype, plain=plain)
        image, ws, depth, n_inc = composite_rays(sigmas * density_scale, ch, samples.tau,
                                                 samples.offsets, dt, t_thresh, plain=plain)
        return {"image": image, "weights_sum": ws, "depth": depth,
                "num_sig": int(n_inc.sum())}

    with torch.no_grad():
        sig_a = field_density(spec, params, bbox, samples.xyz, compute_dtype, plain=plain)
        _, _, _, n_inc = sample_weights(sig_a * density_scale, samples.tau, samples.offsets,
                                        dt, t_thresh, plain=plain)
        idx, offsets = kept_prefix(samples, n_inc)
    ch, sigmas = field_apply(spec, params, bbox, samples.xyz[idx], compute_dtype, plain=plain)
    image, ws, depth, _ = composite_rays(sigmas * density_scale, ch, samples.tau[idx], offsets,
                                         dt, t_thresh, plain=plain)
    return {"image": image, "weights_sum": ws, "depth": depth, "num_sig": idx.shape[0]}
