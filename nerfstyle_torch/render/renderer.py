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
     branch (kernel K1 on the color table, class/color1/color2 MLPs; with
     their view directions where the field reads them, kernel K5d; the
     base field's whole forward), and ``segment_sum`` (kernel K7)
     composites their channels per ray;
  4. white background on rgb, depth normalized to [near, far].

With ``RenderSettings.infer_two_phase`` False a chunk renders through the
reference's incremental scheme instead (``render_test``; JAX's
``make_incremental_renderer``), :func:`render_chunk_incremental`: the same
march, then rounds in which every alive ray takes its next
``infer_round_size`` samples (their rows gathered by kernel P0), the whole
field runs on them (K1, K5, and K5d where it reads directions), kernel K4i
composites them with the transmittance each ray carries from its earlier
rounds, K7 sums their channels, and a ray dies once its transmittance
falls below ``t_thresh`` or its samples run out.  A saturated ray's later
samples are never evaluated.

A train batch (:func:`render_rays`) marches the same way, then evaluates
and composites through ``render/pipeline.py``, whose phase B keeps each
ray's samples with entering T >= t_thresh.

Every buffer is sized from the marcher's count, so unlike the JAX renderer
there are no capacity buckets to grow and nothing is truncated: the output
equals the JAX one once its ladders have grown to the demand.  A frame is
cut into chunks, and a chunk's field evaluations into batches, only to bound
device memory.

With a data-parallel mesh (``Renderer.mesh``, set by the trainer or the
render CLI; :mod:`nerfstyle_torch.parallel`) each rank renders its slice of
each chunk's rays, one all-gather gives every rank the chunk's maps and one
more its counters (JAX ``renderer.py:429-450``, ``:694-720``); an
occupancy update's density sweep splits its points over the ranks and
gathers them (``:777-845``), so every rank keeps the same grid.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from .. import DeviceLike, resolve_device
from ..core.cameras import generate_rays
from ..core.types import BBox, Box2D, Intrinsics
from ..models.fields import (FieldSpec, Params, check_field_spec, field_apply, field_color,
                             field_density)
from ..ops.aabb import near_far_from_aabb
from ..ops.compositing import sample_weights, sample_weights_entering, segment_sum
from ..ops.gather import take_rows
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
# The incremental chunk's counters: samples marched and evaluated, rounds.
INCREMENTAL_COUNT_KEYS = ("num_marched", "num_points", "num_cand", "rounds")
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
    # Inference scheme: two-phase (density on every marched sample, color on
    # the weight-significant ones), or the reference's incremental rounds
    # (render_chunk_incremental) of infer_round_size samples an alive ray.
    infer_two_phase: bool = True
    infer_round_size: int = 32
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


def _batched(fn: Callable[..., torch.Tensor], pts: torch.Tensor, batch: int,
             dirs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fn(pts) -- fn(pts, dirs) where ``dirs`` is given -- in batches of at
    most ``batch`` rows."""
    args = (pts,) if dirs is None else (pts, dirs)
    if pts.shape[0] <= batch:
        return fn(*args)
    return torch.cat([fn(*(a[i:i + batch] for a in args))
                      for i in range(0, pts.shape[0], batch)])


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
        lambda p, d=None: field_color(field_spec, params, bbox, p, compute_dtype, dirs=d,
                                      plain=plain),
        sb.xyz[idx], field_batch, sb.dirs[idx] if field_spec.needs_dirs else None,
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


def render_chunk_incremental(
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
    round_size: int = 32,
    field_batch: int = FIELD_BATCH,
    plain: bool = False,
) -> Dict[str, object]:
    """Incremental render of one chunk of N rays (the reference's inference
    rounds; JAX's ``make_incremental_renderer`` without its TPU buckets).

    One march, sized exactly; then rounds: every alive ray takes its next
    ``round_size`` marched samples (one P0 gather of their [xyz, tau] rows,
    and of their directions where the field reads them), the whole field
    runs on them (``field_apply``: one encode of the style kind's two
    tables), K4i gives their weights from the transmittance the ray entered
    the round with, K7 sums their channels, and one ``index_add_`` a map
    adds each alive ray's row to the chunk's.  A ray dies when its leaving
    transmittance is below ``t_thresh`` or its samples are used up.  Each
    round ends in one host read (how many rays live on and how many
    samples they take next): a chunk of ``rounds`` rounds (at most
    ceil(max_steps / round_size)) makes ``rounds`` + 1 reads.

    Returns the maps of :func:`render_chunk` and the host counters
    ``num_marched`` (samples marched), ``num_points`` (samples evaluated),
    ``num_cand`` and ``rounds``."""
    device = origins.device
    n = origins.shape[0]
    nears, fars = near_far_from_aabb(origins, dirs, plan.aabb(device), plan.min_near)
    sb = march_rays(plan, occ, origins, dirs, nears, fars, plain=plain)
    counts = sb.offsets[1:] - sb.offsets[:-1]
    starts = sb.offsets[:-1]
    # The stream's rows a round gathers: [xyz, tau] (16 bytes), and the
    # directions where the field reads them (32 bytes).
    cols = [sb.xyz, sb.tau[:, None]]
    if field_spec.needs_dirs:
        cols += [sb.dirs, torch.zeros_like(sb.tau)[:, None]]
    rows = torch.cat(cols, dim=1)
    channels = field_spec.out_channels
    acc = torch.zeros((n, channels), dtype=torch.float32, device=device)
    acc_ws = torch.zeros((n,), dtype=torch.float32, device=device)
    acc_depth = torch.zeros((n,), dtype=torch.float32, device=device)
    consumed = torch.zeros((n,), dtype=torch.int64, device=device)
    trans = torch.ones((n,), dtype=torch.float32, device=device)
    alive_mask = counts > 0
    arange_n = torch.arange(n, device=device)

    def next_round():
        """(alive rays [A], their take [A], the round's sample count): one
        host read."""
        take = torch.where(alive_mask, torch.clamp(counts - consumed, max=round_size), 0)
        n_alive, m = (int(v) for v in torch.stack([alive_mask.sum(), take.sum()]).tolist())
        slot = torch.where(alive_mask, torch.cumsum(alive_mask, 0) - 1, n_alive)
        alive = torch.empty((n_alive + 1,), dtype=torch.int64, device=device)
        alive[slot] = arange_n
        alive = alive[:n_alive]
        return alive, take[alive], m

    rounds, points = 0, 0
    max_rounds = -(-plan.max_steps // round_size) + 1
    alive, take, m = next_round()
    while alive.numel() > 0:
        rounds += 1
        assert rounds <= max_rounds, "the incremental loop outran ceil(max_steps / round_size)"
        offsets = torch.zeros((alive.numel() + 1,), dtype=torch.int64, device=device)
        offsets[1:] = torch.cumsum(take, 0)
        rid = torch.repeat_interleave(torch.arange(alive.numel(), device=device), take,
                                      output_size=m)
        pos = (starts[alive] + consumed[alive] - offsets[:-1])[rid] + torch.arange(m, device=device)
        got = take_rows(rows, pos.to(torch.int32), plain=plain)
        xyz, tau = got[:, :3].contiguous(), got[:, 3].contiguous()
        pdirs = got[:, 4:7].contiguous() if field_spec.needs_dirs else None
        outs = [field_apply(field_spec, params, bbox, xyz[i:i + field_batch], compute_dtype,
                            dirs=None if pdirs is None else pdirs[i:i + field_batch], plain=plain)
                for i in range(0, m, field_batch)]
        ch, sigmas = outs[0] if len(outs) == 1 else (torch.cat(t) for t in zip(*outs))
        w, ws, depth, t_out = sample_weights_entering(sigmas * density_scale, tau, offsets,
                                                      trans[alive], plan.dt, t_thresh, plain=plain)
        acc.index_add_(0, alive, segment_sum(w, ch, offsets, plain=plain))
        acc_ws.index_add_(0, alive, ws)
        acc_depth.index_add_(0, alive, depth)
        used = consumed[alive] + take
        consumed[alive] = used
        trans[alive] = t_out
        alive_mask[alive] = (t_out >= t_thresh) & (used < counts[alive])
        points += m
        alive, take, m = next_round()

    return {
        "rgb_map": acc[:, :3] + (1.0 - acc_ws)[:, None],
        "trans_map": torch.clamp(acc_depth - nears, min=0.0) / torch.clamp(fars - nears, min=1e-10),
        "classes": acc[:, 3:],
        "weights_sum": acc_ws,
        "num_marched": sb.num_kept,
        "num_points": points,
        "num_cand": sb.num_cand,
        "rounds": rounds,
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
        "num_cand": sb.num_cand,
    }


class Renderer:
    """Holds the occupancy grid and the render geometry on its device,
    renders frames chunk by chunk, and keeps the grid up to date during
    training.  ``raymarch_channels`` is the field's ``out_channels``: 3 +
    class_dim for the style kind, 3 for the base kind (an empty
    ``classes`` map)."""

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
        # The data-parallel mesh (None: one rank).
        self.mesh = None
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

        def density(p, pts):
            return field_density(self.field_spec, p, self.bbox, pts, self.compute_dtype,
                                 plain=plain)

        if self.mesh is not None:
            from ..parallel.mesh import sharded_density_fn

            density = sharded_density_fn(self.mesh, density)

        def sigma_fn(pts):
            return density(params, pts)

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
        self, params: Params, origins: torch.Tensor, dirs: torch.Tensor, plain: bool = False,
        chunk: Optional[int] = None,
    ) -> Dict[str, object]:
        """Render N rays chunk by chunk (``chunk`` rays, CHUNK_RAYS by
        default), through :func:`render_chunk` or, without
        ``infer_two_phase``, :func:`render_chunk_incremental`; maps
        concatenate, counters add up."""
        s = self.settings
        chunk = chunk or CHUNK_RAYS
        common = dict(t_thresh=s.t_thresh, density_scale=s.density_scale,
                      compute_dtype=self.compute_dtype, plain=plain)
        if s.infer_two_phase:
            chunk_fn, keys = render_chunk, COUNT_KEYS
            common["sig_eps"] = s.sig_eps if s.adaptive_march else 0.0
        else:
            chunk_fn, keys = render_chunk_incremental, INCREMENTAL_COUNT_KEYS
            common["round_size"] = s.infer_round_size
        pieces = []
        for i in range(0, origins.shape[0], chunk):
            o, d = origins[i:i + chunk], dirs[i:i + chunk]
            if self.mesh is None:
                pieces.append(chunk_fn(self.field_spec, self.plan, params, self.occ_field,
                                       self.bbox, o, d, **common))
                continue
            sl = self.mesh.rows(o.shape[0])
            piece = chunk_fn(self.field_spec, self.plan, params, self.occ_field, self.bbox,
                             o[sl], d[sl], **common)
            pieces.append(self._gather_chunk(piece, o.shape[0], keys))
        out: Dict[str, object] = {k: torch.cat([p[k] for p in pieces]) for k in MAP_KEYS}
        for k in keys:
            out[k] = sum(p[k] for p in pieces)
        return out

    def _gather_chunk(self, piece: Dict[str, object], n: int, keys) -> Dict[str, object]:
        """A chunk of n rays from this rank's slice ``piece``: the maps
        gathered from every rank (one all-gather of the packed rows) and the
        counters ``keys`` from every rank (one all-gather), summed but for
        ``rounds``, the chunk's being its slowest rank's."""
        k = piece["classes"].shape[1]
        packed = torch.cat([piece["rgb_map"], piece["trans_map"][:, None], piece["classes"],
                            piece["weights_sum"][:, None]], dim=1)
        whole = self.mesh.all_gather_rows(packed, n)
        mine = torch.tensor([[piece[c] for c in keys]], dtype=torch.int64, device=packed.device)
        per_rank = self.mesh.all_gather_rows(mine, self.mesh.size)
        counts = {c: int(per_rank[:, i].max() if c == "rounds" else per_rank[:, i].sum())
                  for i, c in enumerate(keys)}
        return {"rgb_map": whole[:, :3], "trans_map": whole[:, 3], "classes": whole[:, 4:4 + k],
                "weights_sum": whole[:, 4 + k], **counts}

    def render_ray_batch(self, params: Params, origins: torch.Tensor, dirs: torch.Tensor,
                         plain: bool = False) -> Dict[str, object]:
        """A ray batch through the train path (:func:`render_rays`, two
        phases), as a train step renders it."""
        s = self.settings
        return render_rays(self.field_spec, self.plan, params, self.occ_field, self.bbox,
                           origins, dirs, t_thresh=s.t_thresh, density_scale=s.density_scale,
                           compute_dtype=self.compute_dtype, plain=plain)

    def render(
        self,
        params: Params,
        pose: torch.Tensor,
        image: Optional[torch.Tensor] = None,
        patch: Optional[Box2D] = None,
        num_rays: Optional[int] = None,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
        chunk: Optional[int] = None,
        plain: bool = False,
    ) -> Dict[str, object]:
        """Render from a [4, 4] camera-to-world pose (JAX's
        ``Renderer.render``): the pixels of ``self.intr``, of a ``patch`` of
        it, or ``num_rays`` of them drawn without replacement
        (``generator``); row-major maps (see :meth:`render_rays`) and
        ``target``, each ray's pixel of ``image`` ([C, H, W]; None without
        it).  ``training`` renders through the train path
        (:meth:`render_ray_batch`; a frame or patch in chunks of ``chunk``
        rays), else through the inference path in chunks."""
        rays, target = generate_rays(pose.to(self.device, torch.float32), self.intr,
                                     None if image is None else image.to(self.device),
                                     patch=patch, num_rays=num_rays,
                                     camera_flip=self.settings.flip_camera, generator=generator)
        if not training:
            out = self.render_rays(params, rays.origins, rays.dirs, plain=plain, chunk=chunk)
        elif num_rays is not None:
            out = self.render_ray_batch(params, rays.origins, rays.dirs, plain=plain)
        else:
            step = chunk or CHUNK_RAYS
            pieces = [self.render_ray_batch(params, rays.origins[i:i + step],
                                            rays.dirs[i:i + step], plain=plain)
                      for i in range(0, len(rays), step)]
            out = {k: torch.cat([p[k] for p in pieces]) for k in MAP_KEYS}
            for k in ("num_points", "num_sig"):
                out[k] = sum(p[k] for p in pieces)
        return {"target": target, **out}

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

