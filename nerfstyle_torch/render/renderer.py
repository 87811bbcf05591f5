"""Novel-view rendering: the two-phase chunk renderer and the frame loop
(counterpart of ``nerfstyle_tpu/render/renderer.py``, the inference path
``Renderer.render`` -> ``make_two_phase_renderer``).

Per chunk of rays:

  1. ``near_far_from_aabb``, then ``march_rays`` (kernel K3) emits the
     ray-major sample stream, sized exactly from its count pass;
  2. phase A: the density branch on every marched sample (kernel K1 on the
     density table, then the density MLP), and ``sample_weights`` (kernel
     K4) gives each sample's weight and each ray's weights_sum and depth;
  3. phase B: the weight-significant samples (``w > sig_eps``, compacted
     with ``torch.nonzero``, which keeps ray-major order) run the color
     branch (kernel K1 on the color table, class/color1/color2 MLPs), and
     ``segment_sum`` (kernel K7) composites their channels per ray;
  4. white background on rgb, depth normalized to [near, far].

Every buffer is sized from the marcher's count, so unlike the JAX renderer
there are no capacity buckets to grow and nothing is truncated: the output
equals the JAX one once its ladders have grown to the demand.  A frame is
cut into chunks, and a chunk's field evaluations into batches, only to bound
device memory.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import torch

from .. import DeviceLike, resolve_device
from ..core.cameras import generate_rays
from ..core.types import BBox, Intrinsics
from ..models.fields import FieldSpec, Params, field_color, field_density
from ..ops.aabb import near_far_from_aabb
from ..ops.compositing import sample_weights, segment_sum
from ..ops.marching import MarchPlan, march_rays
from ..ops.occupancy import PersistedOccupancy, occupancy_init

MAP_KEYS = ("rgb_map", "trans_map", "classes", "weights_sum")
COUNT_KEYS = ("num_marched", "num_sig")
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
    # Weight threshold of phase B: a dropped sample adds < sig_eps to each
    # channel of its pixel; 0 keeps every w > 0 sample.
    sig_eps: float = 1e-5


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
    bitfield: torch.Tensor,
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
    """Two-phase render of one chunk of N rays.

    Returns ``rgb_map`` [N, 3], ``trans_map`` [N] (normalized depth),
    ``classes`` [N, K], ``weights_sum`` [N] and the host counters
    ``num_marched`` (samples marched and density-evaluated) and ``num_sig``
    (samples color-evaluated).  ``plain=True`` runs the plain
    PyTorch version of every kernel (the reference a kernel run is checked
    against)."""
    nears, fars = near_far_from_aabb(origins, dirs, plan.aabb(origins.device), plan.min_near)
    sb = march_rays(plan, bitfield, origins, dirs, nears, fars, plain=plain)

    # Phase A: density on the whole stream, exact weights.
    sigmas = _batched(
        lambda p: field_density(field_spec, params, bbox, p, compute_dtype, plain=plain),
        sb.xyz, field_batch,
    ) * density_scale
    w, weights_sum, depth = sample_weights(sigmas, sb.tau, sb.offsets, plan.dt, t_thresh, plain=plain)

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
    }


class Renderer:
    """Holds the occupancy grid and the render geometry on its device and
    renders frames chunk by chunk."""

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
        self.occ_state: PersistedOccupancy = occupancy_init(
            self.cascade, settings.grid_size, self.device
        )

    def render_rays(
        self, params: Params, origins: torch.Tensor, dirs: torch.Tensor, plain: bool = False
    ) -> Dict[str, object]:
        """Render N rays chunk by chunk; maps concatenate, counters add up."""
        s = self.settings
        pieces = [
            render_chunk(
                self.field_spec, self.plan, params, self.occ_state.bitfield, self.bbox,
                origins[i:i + CHUNK_RAYS], dirs[i:i + CHUNK_RAYS],
                t_thresh=s.t_thresh, density_scale=s.density_scale,
                compute_dtype=self.compute_dtype, sig_eps=s.sig_eps, plain=plain,
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
        """Check the checkpoint's renderer fields against this renderer.  The
        JAX package's capacity buckets that ride along are not needed here."""
        for k in ("raymarch_channels", "bound"):
            if k in sd and abs(float(getattr(self, k)) - float(sd[k])) >= 1e-9:
                raise ValueError(f'checkpoint mismatch for "{k}": {sd[k]} vs {getattr(self, k)}')

