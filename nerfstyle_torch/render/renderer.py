"""Rendering and the occupancy grid's upkeep (counterpart of
``nerfstyle_tpu/render/renderer.py``): the differentiable :func:`render_rays`
of a train batch, the inference path ``Renderer.render`` ->
``make_two_phase_renderer``, and the ``Renderer``'s occupancy maintenance
during training (``maybe_update_state``, ``note_batch_points``).

Inference, per chunk of rays:

  1. ``near_far_from_aabb``, then ``march_rays`` emits the ray-major sample
     stream, sized exactly from its count pass: the two-stage march over
     the skip distance (kernel K3s) with ``adaptive_march`` (the default, as
     in the JAX package), the dense lattice sweep (kernel K3) without;
  2. phase A: the density branch on every marched sample (kernel K1 on the
     density table, then the density MLP), and ``sample_weights`` (kernel
     K4) gives each sample's weight and each ray's weights_sum and depth;
  3. phase B: the weight-significant samples (``w > sig_eps``, compacted
     with ``torch.nonzero``, which keeps ray-major order) run the color
     branch (kernel K1 on the color table, class/color1/color2 MLPs), and
     ``segment_sum`` (kernel K7) composites their channels per ray;
  4. white background on rgb, depth normalized to [near, far].

A train batch (:func:`render_rays`) marches the same way, then evaluates
and composites through ``render/pipeline.py``, whose phase B keeps each
ray's samples with entering T >= t_thresh.

Every buffer is sized from the marcher's count, so unlike the JAX renderer
there are no capacity buckets to grow and nothing is truncated: the output
equals the JAX one once its ladders have grown to the demand.  A frame is
cut into chunks, and a chunk's field evaluations into batches, only to bound
device memory.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from .. import DeviceLike, resolve_device
from ..core.cameras import generate_rays
from ..core.types import BBox, Intrinsics
from ..models.fields import FieldSpec, Params, check_field_spec, field_color, field_density
from ..ops.aabb import near_far_from_aabb
from ..ops.compositing import sample_weights, segment_sum
from ..ops.marching import MarchPlan, OccField, march_rays
from ..ops.occupancy import (
    OccupancyState,
    PersistedOccupancy,
    occupancy_init,
    occupancy_restore,
    occupancy_update_full,
    occupancy_update_random,
    update_mean_count,
)
from .pipeline import eval_composite

MAP_KEYS = ("rgb_map", "trans_map", "classes", "weights_sum")
COUNT_KEYS = ("num_marched", "num_sig", "num_cand")
# Rays per chunk and samples per field batch: bounds on device memory only
# (a frame chunk of 2^16 rays peaks at a few GiB at the default configs).
CHUNK_RAYS = 1 << 16
FIELD_BATCH = 1 << 21


@dataclass(frozen=True)
class RenderSettings:
    """Render configuration (the RendererConfig fields inference reads)."""

    grid_size: int = 128
    min_near: float = 0.2
    t_thresh: float = 1e-4
    use_ndc: bool = False
    flip_camera: int = 0
    max_steps: int = 1024
    density_scale: float = 1.0
    # Weight threshold of phase B under adaptive_march: a dropped sample adds
    # < sig_eps to each channel of its pixel.  Without adaptive_march phase B
    # keeps every w > 0 sample (sig_eps 0), as the JAX package's dense frame
    # colors every sample.
    sig_eps: float = 1e-5
    # Occupancy upkeep during training.
    update_iter: int = 16
    update_thres: int = 256
    density_thresh: float = 10.0
    density_decay: float = 0.95
    grid_bsize: Optional[int] = None
    # March with the skip distance (two-stage, kernel K3s); False sweeps the
    # dense lattice (kernel K3).  Both emit the same samples.
    adaptive_march: bool = True
    # Only for the checkpoint's budget_bucket, by which the JAX package
    # sizes its buffers (the port sizes every buffer exactly).
    max_samples_per_ray: int = 256
    max_budget_samples: int = 1_048_576


# The JAX package's compaction-bucket ladder (samples per ray) and its
# candidate-window ladder: the port writes budget_bucket and window_bucket
# into a checkpoint so that the JAX style and render stages size their
# buffers from it.
BUDGET_BUCKETS = (4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)
WINDOW_BUCKET_MAX = 1024


def bucket_for(per_ray_want: float, max_per_ray: int) -> int:
    """Smallest ladder bucket covering ``per_ray_want`` samples a ray."""
    for b in BUDGET_BUCKETS:
        if per_ray_want <= b <= max_per_ray:
            return b
    return min(max(BUDGET_BUCKETS), max_per_ray)


def cascade_for_bound(bound: float) -> int:
    """1 + ceil(log2(bound)) cascades."""
    return 1 + max(0, math.ceil(math.log2(bound)))


def _batched(fn: Callable[[torch.Tensor], torch.Tensor], pts: torch.Tensor, batch: int) -> torch.Tensor:
    if pts.shape[0] <= batch:
        return fn(pts)
    return torch.cat([fn(pts[i:i + batch]) for i in range(0, pts.shape[0], batch)])


def render_chunk(
    field_spec: FieldSpec,
    plan: MarchPlan,
    params: Params,
    occ: OccField,
    bbox: BBox,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    *,
    t_thresh: float,
    density_scale: float,
    compute_dtype: torch.dtype = torch.float32,
    sig_eps: float = 1e-5,
    field_batch: int = FIELD_BATCH,
    plain: bool = False,
) -> Dict[str, object]:
    """Two-phase render of one chunk of N rays over the occupancy ``occ``
    (an ``OccField``, or a bare bitfield for the dense march).

    Returns ``rgb_map`` [N, 3], ``trans_map`` [N] (normalized depth),
    ``classes`` [N, K], ``weights_sum`` [N] and the host counters
    ``num_marched`` (samples marched and density-evaluated), ``num_sig``
    (samples color-evaluated) and ``num_cand`` (the two-stage march's
    candidate windows).  ``plain=True`` runs the plain
    PyTorch version of every kernel (the reference a kernel run is checked
    against)."""
    nears, fars = near_far_from_aabb(origins, dirs, plan.aabb(origins.device), plan.min_near)
    sb = march_rays(plan, occ, origins, dirs, nears, fars, plain=plain)

    # Phase A: density on the whole stream, exact weights.
    sigmas = _batched(
        lambda p: field_density(field_spec, params, bbox, p, compute_dtype, plain=plain),
        sb.xyz, field_batch,
    ) * density_scale
    w, weights_sum, depth, _ = sample_weights(sigmas, sb.tau, sb.offsets, plan.dt, t_thresh,
                                              plain=plain)

    # Phase B: color on the weight-significant samples only.
    keep = w > sig_eps
    idx = torch.nonzero(keep).squeeze(1)
    kept_before = torch.zeros((keep.shape[0] + 1,), dtype=torch.int64, device=keep.device)
    kept_before[1:] = torch.cumsum(keep, 0)
    sig_offsets = kept_before[sb.offsets]
    ch = _batched(
        lambda p: field_color(field_spec, params, bbox, p, compute_dtype, plain=plain),
        sb.xyz[idx], field_batch,
    )
    image = segment_sum(w[idx], ch, sig_offsets, plain=plain)

    n_sig = idx.shape[0]
    return {
        "rgb_map": image[:, :3] + (1.0 - weights_sum)[:, None],
        "trans_map": torch.clamp(depth - nears, min=0.0) / torch.clamp(fars - nears, min=1e-10),
        "classes": image[:, 3:],
        "weights_sum": weights_sum,
        "num_marched": sb.num_kept,
        "num_sig": n_sig,
        "num_cand": sb.num_cand,
    }


def render_rays(
    field_spec: FieldSpec,
    plan: MarchPlan,
    params: Params,
    occ: OccField,
    bbox: BBox,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    *,
    t_thresh: float,
    density_scale: float,
    compute_dtype: torch.dtype = torch.float32,
    two_phase: bool = True,
    plain: bool = False,
) -> Dict[str, object]:
    """Differentiable render of a train batch of N rays (one chunk): AABB,
    march over ``occ`` (K3s, or K3 for a bare bitfield),
    :func:`~nerfstyle_torch.render.pipeline.eval_composite`,
    the white-background blend and the depth normalization.

    Returns ``rgb_map`` [N, 3], ``trans_map`` [N], ``classes`` [N, K],
    ``weights_sum`` [N] and the host counts ``num_points`` (samples marched)
    and ``num_sig`` (samples with entering T >= t_thresh)."""
    nears, fars = near_far_from_aabb(origins, dirs, plan.aabb(origins.device), plan.min_near)
    sb = march_rays(plan, occ, origins, dirs, nears, fars, plain=plain)
    out = eval_composite(field_spec, params, bbox, sb, plan.dt, t_thresh, density_scale,
                         compute_dtype, two_phase=two_phase, plain=plain)
    image, ws = out["image"], out["weights_sum"]
    return {
        "rgb_map": image[:, :3] + (1.0 - ws)[:, None],
        "trans_map": torch.clamp(out["depth"] - nears, min=0.0)
        / torch.clamp(fars - nears, min=1e-10),
        "classes": image[:, 3:],
        "weights_sum": ws,
        "num_points": sb.num_kept,
        "num_sig": out["num_sig"],
    }


class Renderer:
    """Holds the occupancy grid and the render geometry on its device,
    renders frames chunk by chunk, and keeps the grid up to date during
    training."""

    def __init__(
        self,
        field_spec: FieldSpec,
        bbox: BBox,
        settings: RenderSettings,
        intr: Intrinsics,
        bound: float,
        raymarch_channels: int = 3,
        compute_dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
    ):
        if settings.use_ndc:
            raise NotImplementedError("NDC rendering is not implemented (nor enabled by the reference)")
        self.device = resolve_device(device)
        check_field_spec(field_spec, self.device)
        # fp32 products must not run in TF32 (see ops/mlp.py).
        torch.backends.cuda.matmul.allow_tf32 = False
        self.field_spec = field_spec
        self.settings = settings
        self.intr = intr
        self.bound = float(bound)
        self.bbox = bbox.to(self.device)
        self.raymarch_channels = raymarch_channels
        self.compute_dtype = compute_dtype
        self.cascade = cascade_for_bound(self.bound)
        self.plan = MarchPlan(
            bound=self.bound, cascade=self.cascade, grid_size=settings.grid_size,
            max_steps=settings.max_steps, min_near=settings.min_near,
        )
        self.occ_state: OccupancyState = occupancy_init(
            self.cascade, settings.grid_size, self.device
        )
        self.precrop_frac = 1.0
        self.update_occ = True
        self._local_step_host = 0
        self._last_num_rays = 1
        # Host clock of every occupancy update by kind, each ending in a
        # device sync.
        self.update_ms: Dict[str, List[float]] = {"full": [], "random": []}

    # ---- occupancy maintenance ----

    def update_state(self, params: Params, generator: torch.Generator, plain: bool = False) -> None:
        """Occupancy refresh: a full sweep while fewer than ``update_thres``
        train steps have run, a random update after."""
        s = self.settings
        kind = "full" if self._local_step_host < s.update_thres else "random"
        t0 = time.perf_counter()

        def sigma_fn(pts):
            return field_density(self.field_spec, params, self.bbox, pts, self.compute_dtype,
                                 plain=plain)

        kw = dict(bound=self.bound, density_scale=s.density_scale,
                  density_decay=s.density_decay, density_thresh=s.density_thresh,
                  generator=generator, plain=plain)
        if s.grid_bsize:
            kw["chunk"] = int(s.grid_bsize)
        update = occupancy_update_full if kind == "full" else occupancy_update_random
        self.occ_state = update(self.occ_state, sigma_fn, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.update_ms[kind].append((time.perf_counter() - t0) * 1e3)

    def maybe_update_state(self, params: Params, generator: torch.Generator,
                           plain: bool = False) -> bool:
        """Refresh the grid every ``update_iter`` train steps (step 0
        included); True when it did."""
        if self.update_occ and self._local_step_host % self.settings.update_iter == 0:
            self.update_state(params, generator, plain)
            return True
        return False

    def note_batch_points(self, num_points: int, num_rays: Optional[int] = None) -> None:
        """Feed a train batch's marched-sample count into mean_count."""
        self.occ_state = update_mean_count(self.occ_state, num_points)
        self._local_step_host += 1
        if num_rays:
            self._last_num_rays = num_rays

    def restore_occupancy(self, persisted: PersistedOccupancy) -> None:
        """Take a checkpoint's occupancy leaves (the skip distance is
        rebuilt: kernel K6c)."""
        self.occ_state = occupancy_restore(persisted, self.settings.grid_size, self.device)
        self._local_step_host = int(self.occ_state.local_step)

    @property
    def occ_field(self) -> OccField:
        """What the marcher reads: the skip distance beside the bitfield
        under ``adaptive_march``, the bitfield alone otherwise."""
        if self.settings.adaptive_march:
            return OccField(self.occ_state.bitfield, self.occ_state.skipdist)
        return OccField(self.occ_state.bitfield)

    def budget_bucket(self) -> int:
        """The JAX package's samples-per-ray bucket for this run's demand:
        the ladder value covering 1.25 x mean_count per ray, under the
        per-ray cap and the budget's memory cap."""
        s = self.settings
        mem_cap = max(min(BUDGET_BUCKETS), s.max_budget_samples // max(1, self._last_num_rays))
        cap = min(s.max_samples_per_ray, mem_cap)
        mean_count = int(self.occ_state.mean_count)
        if mean_count <= 0:
            return min(s.max_samples_per_ray, 256)
        return bucket_for(mean_count * 1.25 / max(1, self._last_num_rays), cap)

    def state_dict_static(self) -> Dict[str, object]:
        """The checkpoint's renderer fields, under the JAX package's keys."""
        return {
            "intr": self.intr.asdict(),
            "precrop_frac": self.precrop_frac,
            "raymarch_channels": self.raymarch_channels,
            "bound": self.bound,
            "budget_bucket": self.budget_bucket(),
            "last_num_rays": self._last_num_rays,
            "window_bucket": WINDOW_BUCKET_MAX,
            "max_steps": self.settings.max_steps,
        }

    def render_rays(
        self, params: Params, origins: torch.Tensor, dirs: torch.Tensor, plain: bool = False
    ) -> Dict[str, object]:
        """Render N rays chunk by chunk; maps concatenate, counters add up."""
        s = self.settings
        pieces = [
            render_chunk(
                self.field_spec, self.plan, params, self.occ_field, self.bbox,
                origins[i:i + CHUNK_RAYS], dirs[i:i + CHUNK_RAYS],
                t_thresh=s.t_thresh, density_scale=s.density_scale,
                compute_dtype=self.compute_dtype,
                sig_eps=s.sig_eps if s.adaptive_march else 0.0, plain=plain,
            )
            for i in range(0, origins.shape[0], CHUNK_RAYS)
        ]
        out: Dict[str, object] = {k: torch.cat([p[k] for p in pieces]) for k in MAP_KEYS}
        for k in COUNT_KEYS:
            out[k] = sum(p[k] for p in pieces)
        return out

    def render(self, params: Params, pose: torch.Tensor, plain: bool = False) -> Dict[str, object]:
        """Render every pixel of ``self.intr`` from a [4, 4] camera-to-world
        pose (row-major maps, see :meth:`render_rays`)."""
        rays = generate_rays(pose.to(self.device, torch.float32), self.intr, self.settings.flip_camera)
        return self.render_rays(params, rays.origins, rays.dirs, plain=plain)

    def load_state_dict_static(self, sd: Dict[str, object]) -> None:
        """Check the checkpoint's renderer fields against this renderer and
        take its demand estimate, as the JAX package does: ``mean_count``
        (restore the occupancy first) counts samples at the checkpoint's
        ``max_steps`` and is rescaled to this renderer's, so that
        :meth:`budget_bucket` sizes for this lattice.  The JAX package's
        capacity buckets that ride along are not needed here."""
        for k in ("raymarch_channels", "bound"):
            if k in sd and abs(float(getattr(self, k)) - float(sd[k])) >= 1e-9:
                raise ValueError(f'checkpoint mismatch for "{k}": {sd[k]} vs {getattr(self, k)}')
        if "budget_bucket" not in sd:
            return
        self._last_num_rays = int(sd.get("last_num_rays", 1))
        scale = self.settings.max_steps / max(1, int(sd.get("max_steps", self.settings.max_steps)))
        mean_count = self.occ_state.mean_count
        if scale != 1.0 and int(mean_count) > 0:
            self.occ_state = self.occ_state._replace(
                mean_count=(mean_count.to(torch.float32) * scale).to(torch.int32))

