#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (nerfstyle_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written kernels (nerfstyle_torch/csrc -> build/) and
   prints the card's name and power limit.
2. Writes a full-width checkpoint with the port's own save_checkpoint:
   seeded random params at the default network config (16 levels x 2
   features, 2^19 tables, 64-wide heads, class_dim from the synthetic train
   split), the default renderer config (grid 128, max_steps 1024, bound 2 ->
   2 cascades) and a procedural occupancy grid: the cells covering the three
   spheres of the synthetic scene.  density_offset = 6.0 makes occupied
   space nearly opaque (sigma ~ e^6, ~7 samples to saturate), so rays end
   as in a trained scene.
3. Per kernel, at the shapes of the main path (a 2^16-ray chunk of the
   1008x756 frame; 2^20 points for K1): the CUDA kernel against its plain
   PyTorch version on the same inputs, with the tolerance stated at each
   check, and both timed with CUDA events after warm-up.
4. The main path: ``python -m nerfstyle_torch.render <ckpt> --out-dims 1008
   756 --max-count 1 --yes``, in-process, with every launch counter set to 0
   just before and read just after; each kernel must have launched.
5. Checks the frame: finite, of the expected shape, its opacity matching
   the spheres' analytic silhouette, and a 4096-ray crop matching the plain
   path on the card.
6. The train path: ``python -m nerfstyle_torch.train`` in-process at the
   default configs (4096 rays a step, two 2^19-row tables, grid 128, AMP)
   on the synthetic scene for 300 steps, past update_thres, so that both
   occupancy updates run; launch counters set to 0 just before and read
   just after, each train kernel (K1-K6, K7) must have launched, no
   step may be non-finite, and the EMA params' test PSNR must rise 5 dB
   above the untrained field's on the same views.  Prints step times early
   and late, train rays/s, occupancy-update times, samples per ray and peak
   memory.
7. One more step with the kernels against the same step with every plain
   version, from the same state and rays (tolerances at step_vs_plain);
   K2, K4b and K6 against their plain versions at the step's shapes, and K5
   with its weight gradients at a batch's shape, timed; one late step under
   the profiler.
8. The style path: ``python -m nerfstyle_torch.train --ckpt <the train
   phase's checkpoint> --style-image <png> --style_seg_path <npz>
   --max_steps 512`` in-process, on a 504x378 synthetic scene (30 train
   views, 3 test views), 200 iterations (cfgs/training/style.yaml) with
   their launch counters set to 0 just before and read just after; each
   style kernel (K1-K5, K7, K7b) must have launched, every loss must be
   finite, the mean style term of the last 10 iterations must lie below the
   first's, and the written checkpoint must differ from the train phase's
   only in x_color_embedder.  Prints the cache builds, the first epoch (30
   builds), the median steady iteration, the whole run, peak memory and
   each kernel's launches a step.  Then one style step with the kernels
   against the same step with every plain version, K5 forward and backward
   and K7b at the style stream's shape against their plain versions, timed,
   and one steady iteration under the profiler.

Prints the kernel table as one JSON line, then the last line
``{"ok": true, "device": {...}}``.  Exits nonzero, printing no result,
without a CUDA device or when any phase fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate, fp32 outside the
# tensor cores, bf16 dense on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
OUT_DIMS = (1008, 756)
# Train steps of the train path: past update_thres (256), so that both
# occupancy updates (full sweep, then random) run.
TRAIN_STEPS = 300
RENDER_COUNTERS = ("hashgrid_encode", "march_count", "march_write", "composite_weights",
                   "segment_sum", "mlp_forward")
TRAIN_COUNTERS = ("hashgrid_encode", "hashgrid_backward", "march_count", "march_write",
                  "composite_weights", "composite_backward", "segment_sum", "mlp_forward",
                  "mlp_backward", "occupancy_scatter_max", "occupancy_merge",
                  "occupancy_threshold")
# The style path: the README's size (504x378, 30 train views, 3 test views),
# max_steps 512, the 200 iterations of cfgs/training/style.yaml.
STYLE_DIMS = (504, 378)
STYLE_VIEWS, STYLE_TEST_VIEWS = 30, 3
STYLE_COUNTERS = ("hashgrid_encode", "hashgrid_backward", "march_count", "march_write",
                  "composite_weights", "mlp_forward", "mlp_backward", "segment_sum",
                  "segment_sum_backward")
STYLE_STEP_COUNTERS = ("hashgrid_encode", "hashgrid_backward", "mlp_forward", "mlp_backward",
                       "segment_sum", "segment_sum_backward")
K1_POINTS = 1 << 20
DENSITY_OFFSET = 6.0
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_PER_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Scene and checkpoint
# ---------------------------------------------------------------------------


def sphere_bitfield(cascade: int, grid: int, bound: float, spheres: np.ndarray) -> np.ndarray:
    """Cells (of every cascade) that a sphere of the scene intersects."""
    idx = np.arange(grid, dtype=np.float64)
    bits = []
    for lv in range(cascade):
        mip = min(2.0**lv, bound)
        cell = 2.0 * mip / grid
        c = (idx + 0.5) * cell - mip  # cell centers along one axis
        x, y, z = np.meshgrid(c, c, c, indexing="ij")
        occ = np.zeros(x.shape, bool)
        for cx, cy, cz, r in spheres.astype(np.float64):
            dist = np.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
            occ |= dist <= r + 0.5 * math.sqrt(3.0) * cell
        bits.append(occ.reshape(-1))
    return np.concatenate(bits)


def write_checkpoint(path: Path):
    from nerfstyle_torch.config import DatasetConfig, NetworkConfig, RendererConfig, TrainConfig
    from nerfstyle_torch.core.types import DatasetSplit
    from nerfstyle_torch.data import get_dataset
    from nerfstyle_torch.data.synthetic import _SPHERES
    from nerfstyle_torch.models.fields import field_init, make_grid_spec, style_field_spec
    from nerfstyle_torch.ops.occupancy import PersistedOccupancy
    from nerfstyle_torch.render.renderer import cascade_for_bound
    from nerfstyle_torch.training.checkpoint import save_checkpoint

    dataset_cfg = DatasetConfig(root_path=WORK / "scene", type="Synthetic", bound=2.0)
    net_cfg = NetworkConfig(density_offset=DENSITY_OFFSET)
    render_cfg = RendererConfig()
    train_cfg = TrainConfig()
    train_set = get_dataset(dataset_cfg, DatasetSplit.TRAIN)
    pe = net_cfg.pos_enc
    grid = make_grid_spec(pe.n_lvls, pe.n_feats_per_lvl, pe.hashmap_size, pe.min_res,
                          pe.max_res_coeff, float(train_set.bbox.size.max()))
    spec = style_field_spec(grid, class_dim=train_set.num_classes,
                            density_offset=net_cfg.density_offset)
    params = field_init(spec, torch.Generator().manual_seed(0))
    cascade = cascade_for_bound(dataset_cfg.bound)
    bits = sphere_bitfield(cascade, render_cfg.grid_size, dataset_cfg.bound, _SPHERES)
    occ = PersistedOccupancy(
        torch.from_numpy(bits.astype(np.float32).reshape(cascade, -1)),
        torch.from_numpy(bits),
        torch.tensor(float(bits.mean()), dtype=torch.float32),
        torch.tensor(0, dtype=torch.int32),
        torch.tensor(0, dtype=torch.int32),
    )
    meta = {
        "version": "chip_smoke", "log_dir": str(WORK / "log"), "iter_ctr": 0,
        "dataset_cfg": dataset_cfg.asdict(), "net_cfg": net_cfg.asdict(),
        "render_cfg": render_cfg.asdict(), "train_cfg": train_cfg.asdict(),
        "renderer_static": {"raymarch_channels": 3 + train_set.num_classes,
                            "bound": dataset_cfg.bound},
    }
    save_checkpoint(path, meta, {"params": params, "occ": occ})
    log(f"checkpoint: {path} ({path.stat().st_size / 2**20:.1f} MiB), "
        f"{grid.total_params} table rows x 2 tables, class_dim {spec.class_dim}, "
        f"occupied cells {int(bits.sum())} of {bits.size}, density_offset {DENSITY_OFFSET}")
    return spec


# ---------------------------------------------------------------------------
# Per-kernel phases
# ---------------------------------------------------------------------------


def touched_rows(spec, x: torch.Tensor) -> int:
    """Distinct table rows the trilinear corners of x read (K1's least bytes)."""
    from nerfstyle_torch.ops.hashgrid import PRIMES

    mask = torch.zeros(spec.total_params, dtype=torch.bool, device=x.device)
    inside = x[((x >= 0) & (x <= 1)).all(dim=-1)]
    for lv in range(spec.num_levels):
        res = spec.resolutions[lv]
        pos = inside * float(res)
        pg = torch.minimum(torch.floor(pos).clamp(min=0.0), torch.tensor(res - 1.0, device=x.device))
        pgi = pg.to(torch.int64)
        for s in range(8):
            h = torch.zeros(inside.shape[0], dtype=torch.int64, device=x.device)
            for d in range(3):
                h = h ^ (((pgi[:, d] + ((s >> d) & 1)) * PRIMES[d]) & 0xFFFFFFFF)
            mask[h % spec.table_sizes[lv] + spec.offsets[lv]] = True
    return int(mask.sum())


def kernel_phases(renderer, params, rays_o, rays_d):
    """K3, K1, K4, K7 on a 2^16-ray chunk of the frame; returns the kernel
    table (without launches) and a list of failures."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.models.fields import _encoder_input, field_color, field_density
    from nerfstyle_torch.ops import compositing, hashgrid, marching
    from nerfstyle_torch.ops.aabb import near_far_from_aabb
    from nerfstyle_torch.render.renderer import CHUNK_RAYS

    fails, table = [], {}
    plan, spec, bbox = renderer.plan, renderer.field_spec, renderer.bbox
    n = rays_o.shape[0]
    mid = n // 2
    o = rays_o[mid - CHUNK_RAYS // 2: mid + CHUNK_RAYS // 2].contiguous()
    d = rays_d[mid - CHUNK_RAYS // 2: mid + CHUNK_RAYS // 2].contiguous()
    bits = renderer.occ_state.bitfield
    nears, fars = near_far_from_aabb(o, d, plan.aabb(o.device), plan.min_near)

    # K3: march.  Exact: same lattice, same rounding, same order.
    sb = marching.march_rays(plan, bits, o, d, nears, fars)
    ref = marching.march_rays(plan, bits, o, d, nears, fars, plain=True)
    exact = all(torch.equal(getattr(sb, f), getattr(ref, f))
                for f in ("ray_id", "step", "offsets", "xyz", "dirs", "tau"))
    err = float((sb.xyz - ref.xyz).abs().max()) if sb.num_kept == ref.num_kept else float("inf")
    if not exact:
        fails.append(f"K3 march differs from its plain version (num_kept {sb.num_kept} vs "
                     f"{ref.num_kept}, max xyz err {err})")
    # K3's time is its two kernels' device time, each timed on its own so
    # that the host synchronisation between them (to size the outputs) is
    # outside the timed window.
    m = sb.num_kept
    geom = dict(dt=plan.dt, bound=plan.bound, t_lattice=plan.t_lattice, cascade=plan.cascade,
                grid_size=plan.grid_size, mip_dt_level=plan.mip_dt_level,
                max_steps=plan.max_steps)
    rays = (o, d, nears.contiguous(), fars.contiguous(), bits)
    count_ms = cuda_ms(lambda: kernels.march_count(*rays, **geom), reps=10)
    write_ms = cuda_ms(lambda: kernels.march_write(*rays, sb.offsets, m, **geom), reps=10)
    ms = count_ms + write_ms
    plain_ms = cuda_ms(lambda: marching.march_rays(plan, bits, o, d, nears, fars, plain=True),
                       reps=2, warmup=1)
    # Inputs: rays (o, d, near, far) and the bitfield; outputs: 36 bytes a
    # kept sample and the offsets.  The function's operations: 8 for each
    # kept sample (o + d*t, tau); the lattice points of empty cells need not
    # be visited at all (a skip-distance march jumps them).
    b_ms, b_by = bound_ms(
        nbytes=CHUNK_RAYS * 32 + bits.numel() + m * 36 + (CHUNK_RAYS + 1) * 8,
        flops=8 * m,
    )
    table["K3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None)
    log(f"K3 march_rays: {CHUNK_RAYS} rays -> {m} samples ({m / CHUNK_RAYS:.1f}/ray); "
        f"equal to plain: {exact}; ms {ms:.3f} (march_count {count_ms:.3f} + march_write "
        f"{write_ms:.3f}), plain_ms {plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by})")

    # K1: hash-grid encode on 2^20 points of the chunk's stream (density
    # table).  Same rounding as the plain version: tolerance 1e-6 of the
    # largest output.
    pick = torch.randint(0, m, (K1_POINTS,), generator=torch.Generator().manual_seed(1))
    x = _encoder_input(bbox, sb.xyz[pick.to(sb.xyz.device)]).contiguous()
    tab = params["x_density_embedder"]
    enc = hashgrid.hashgrid_encode(spec.grid, tab, x)
    enc_ref = hashgrid.hashgrid_encode(spec.grid, tab, x, plain=True)
    err = float((enc - enc_ref).abs().max())
    tol = 1e-6 * float(enc_ref.abs().max())
    if not err <= tol:
        fails.append(f"K1 encode error {err} > {tol}")
    ms = cuda_ms(lambda: hashgrid.hashgrid_encode(spec.grid, tab, x), reps=20)
    plain_ms = cuda_ms(lambda: hashgrid.hashgrid_encode(spec.grid, tab, x, plain=True), reps=3)
    rows = touched_rows(spec.grid, x)
    c = tab.shape[1]
    b_ms, b_by = bound_ms(
        nbytes=K1_POINTS * 12 + rows * c * 4 + K1_POINTS * spec.grid.output_dim * 4,
        flops=K1_POINTS * spec.grid.num_levels * 8 * (3 + 2 * c),
    )
    table["K1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None)
    log(f"K1 hashgrid_encode: {K1_POINTS} points x {spec.grid.num_levels} levels, "
        f"{rows} distinct rows read; max_abs_err {err:.3e} (tol {tol:.3e}); ms {ms:.3f}, "
        f"plain_ms {plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by})")

    # K4: weights on the chunk's stream with the path's densities.  The
    # reference is the plain version on the same inputs in float64 (exact).
    # Every ray must stop at the same sample as the reference, except an
    # edge ray: one with a sample whose exact entering T lies within 1e-4
    # relative of t_thresh, where the kernel's fp32 optical depth (~5e-7
    # rounding an addition near ln 1e4) may decide the other way.  Other
    # rays agree to fp32 rounding: atol 2e-6 on w and weights_sum, 2e-6 *
    # max(tau) on depth; an edge ray may gain or lose one weight below
    # t_thresh: atol 1e-4, 1e-4 * max(tau).
    s = renderer.settings
    sig = field_density(spec, params, bbox, sb.xyz, renderer.compute_dtype) * s.density_scale
    w, ws, dep, _ = compositing.sample_weights(sig, sb.tau, sb.offsets, plan.dt, s.t_thresh)
    w64, ws64, dep64, _ = compositing.sample_weights(sig.double(), sb.tau.double(), sb.offsets,
                                                     plan.dt, s.t_thresh, plain=True)
    _, trans64 = compositing.entering_transmittance_plain(sig.double(), sb.offsets, plan.dt)
    near = (trans64 - s.t_thresh).abs() <= 1e-4 * s.t_thresh
    edge = compositing.segment_totals_plain(near.double(), sb.offsets) > 0
    cut_diff = compositing.weight_cutoffs(w, sb.offsets) != compositing.weight_cutoffs(w64,
                                                                                        sb.offsets)
    bad_cuts = int((cut_diff & ~edge).sum())
    on_edge = edge[sb.ray_id.long()]
    tau_max = float(sb.tau.max())
    errs, tols = [], []
    for mask_s, mask_r, tight in ((~on_edge, ~edge, 2e-6), (on_edge, edge, 1e-4)):
        errs += [float((a.double() - b)[mk].abs().max()) if bool(mk.any()) else 0.0
                 for a, b, mk in ((w, w64, mask_s), (ws, ws64, mask_r), (dep, dep64, mask_r))]
        tols += [tight, tight, tight * tau_max]
    if bad_cuts or not all(e <= t for e, t in zip(errs, tols)):
        fails.append(f"K4: {bad_cuts} rays stop at another sample than the plain version; "
                     f"errors w/ws/depth (inner rays, then edge rays) {errs} vs {tols}")
    ms = cuda_ms(lambda: compositing.sample_weights(sig, sb.tau, sb.offsets, plan.dt,
                                                    s.t_thresh), reps=20)
    plain_ms = cuda_ms(lambda: compositing.sample_weights(sig, sb.tau, sb.offsets, plan.dt,
                                                          s.t_thresh, plain=True), reps=5)
    # Bytes: offsets, sigma and tau of the samples in front of each ray's
    # cutoff (entering T >= t_thresh: the rest are never read), w of every
    # sample, weights_sum and depth.  About 8 operations a read sample.
    n_read = int((trans64 >= s.t_thresh).sum())
    b_ms, b_by = bound_ms(nbytes=(CHUNK_RAYS + 1) * 8 + n_read * 8 + m * 4 + CHUNK_RAYS * 8,
                          flops=n_read * 8)
    table["K4"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None)
    log(f"K4 composite_weights: {m} samples, {n_read} in front of the cutoffs, "
        f"{int(edge.sum())} edge rays, {bad_cuts} other rays stopping elsewhere; max_abs_err "
        f"w/ws/depth inner, edge {errs} (tol {tols}); ms {ms:.3f}, plain_ms {plain_ms:.3f}, "
        f"bound_ms {b_ms:.4f} ({b_by})")

    # K7: phase B's channel sum over the significant samples.  Reference:
    # the plain version (float64 sums); the kernel sums in fp32 in stream
    # order: tolerance 1e-5 of the largest output.
    keep = w > s.sig_eps
    idx = torch.nonzero(keep).squeeze(1)
    before = torch.zeros(m + 1, dtype=torch.int64, device=w.device)
    before[1:] = torch.cumsum(keep, 0)
    sig_off = before[sb.offsets]
    ch = field_color(spec, params, bbox, sb.xyz[idx], renderer.compute_dtype).contiguous()
    w_sig = w[idx].contiguous()
    img = compositing.segment_sum(w_sig, ch, sig_off)
    img_ref = compositing.segment_sum(w_sig, ch, sig_off, plain=True)
    err = float((img - img_ref).abs().max())
    tol = 1e-5 * float(img_ref.abs().max()) + 1e-6
    if not err <= tol:
        fails.append(f"K7 segment sum error {err} > {tol}")
    ms = cuda_ms(lambda: compositing.segment_sum(w_sig, ch, sig_off), reps=20)
    plain_ms = cuda_ms(lambda: compositing.segment_sum(w_sig, ch, sig_off, plain=True), reps=5)
    rid = compositing.ray_ids(sig_off)
    src = w_sig[:, None] * ch
    acc = torch.zeros(CHUNK_RAYS, ch.shape[1], device=w.device)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, rid, src), reps=20)
    nsig, cc = idx.shape[0], ch.shape[1]
    b_ms, b_by = bound_ms(nbytes=nsig * 4 * (1 + cc) + (CHUNK_RAYS + 1) * 8 + CHUNK_RAYS * cc * 4,
                          flops=2 * nsig * cc)
    table["K7"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms)
    log(f"K7 segment_sum: {nsig} significant samples x {cc} channels; max_abs_err {err:.3e} "
        f"(tol {tol:.3e}); ms {ms:.3f}, plain_ms {plain_ms:.3f}, index_add_ ms {lib_ms:.3f}, "
        f"bound_ms {b_ms:.4f} ({b_by})")
    return table, fails


# ---------------------------------------------------------------------------
# The train path
# ---------------------------------------------------------------------------


def train_argv(steps: int, *extra: str):
    """Flags of ``python -m nerfstyle_torch.train`` at the default configs on
    the synthetic scene (24 train views of 128x96, 6 test views)."""
    return ["--device", DEVICE, "--log-dir", str(WORK / "train"),
            "--data-cfg", str(WORK / "data.yaml"), "--num_iterations", str(steps),
            "--intervals.print", "50", "--intervals.log", "0", "--intervals.test", "0",
            "--intervals.ckpt", str(steps), "--yes", *extra]


def clone_tree(t):
    """A copy of a tree of tensors (dicts, lists, tuples, NamedTuples)."""
    if isinstance(t, torch.Tensor):
        return t.detach().clone()
    if isinstance(t, dict):
        return {k: clone_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [clone_tree(v) for v in t]
    if isinstance(t, tuple):
        items = [clone_tree(v) for v in t]
        return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
    return t


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64 (||a - b|| when b is 0)."""
    a, b = a.detach().double().reshape(-1), b.detach().double().reshape(-1)
    num, den = float(torch.linalg.vector_norm(a - b)), float(torch.linalg.vector_norm(b))
    return num / den if den > 0 else num


def step_vs_plain(trainer, fails):
    """One train step with the kernels and the same step with ``plain=True``
    (the plain PyTorch version of every kernel, on the card) from the same
    state and the same rays; the trainer keeps the kernel step's state.

    Tolerances: the kernels sum in fp32 where the plain versions sum in
    float64 (K4, K4b, K7) or in another order (K2's atomics), and under AMP
    a cotangent that lands on the other side of a bf16 rounding step moves by
    2^-8 of itself.  Loss terms: 1e-5 relative.  Marched samples equal; kept
    samples within 1e-3 (a ray whose entering T lies within rounding of
    t_thresh keeps one sample more or less).  Each gradient leaf, each
    Adam moment leaf and each param and EMA update (new - old): relative L2
    error 5e-3 (measured up to 6.2e-4 on an H100)."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.training.checkpoint import tree_flatten

    frame, idx = trainer.sample_batch()
    o, d, target = trainer.ray_batch(frame, idx)
    start = clone_tree((trainer.params, trainer.opt_state, trainer.ema_state))
    runs = {}
    for plain in (False, True):
        params, opt_state, ema_state = clone_tree(start)
        trainer.params = trainer._trainable(params)
        trainer.opt_state, trainer.ema_state = opt_state, ema_state
        kernels.reset_launch_counts()
        losses, grads, counts = trainer.loss_and_grads(o, d, target, plain=plain)
        applied = trainer.apply_grads(grads)
        torch.cuda.synchronize()
        runs[plain] = dict(losses=losses, grads=grads, counts=counts, applied=applied,
                           state=(trainer.params, trainer.opt_state, trainer.ema_state),
                           launches=dict(kernels.launch_counts))
    k, p = runs[False], runs[True]
    trainer.params, trainer.opt_state, trainer.ema_state = k["state"]

    step_kernels = ("hashgrid_encode", "hashgrid_backward", "march_count", "march_write",
                    "composite_weights", "composite_backward", "segment_sum", "mlp_forward",
                    "mlp_backward")
    missing = [c for c in step_kernels if k["launches"][c] <= 0]
    if missing:
        fails.append(f"the kernel step launched no {missing}")
    if any(p["launches"].values()):
        fails.append(f"the plain step launched kernels: {p['launches']}")
    if not (k["applied"] and p["applied"]):
        fails.append("a compared step was skipped as non-finite")
    loss_err = {name: abs(float(k["losses"][name]) - float(v)) / max(abs(float(v)), 1e-30)
                for name, v in p["losses"].items()}
    kc, pc = k["counts"], p["counts"]
    sig_err = abs(kc["num_sig"] - pc["num_sig"]) / max(pc["num_sig"], 1)
    (p0, o0, e0), (pk, ok, ek), (pp, op, ep) = start, k["state"], p["state"]
    errs = {
        "grads": max(rel_l2(a, b) for a, b in zip(tree_flatten(k["grads"]),
                                                  tree_flatten(p["grads"]))),
        "param_update": max(rel_l2(a - z, b - z) for a, b, z in zip(
            tree_flatten(pk), tree_flatten(pp), tree_flatten(p0))),
        "adam_state": max(rel_l2(a, b) for a, b in zip(tree_flatten(ok), tree_flatten(op))
                          if a.is_floating_point()),
        "ema_update": max(rel_l2(a - z, b - z) for a, b, z in zip(
            tree_flatten(ek.shadow), tree_flatten(ep.shadow), tree_flatten(e0.shadow))),
    }
    log(f"train step with kernels vs plain, same state and rays: loss relative errors "
        f"{loss_err}; samples marched {kc['num_points']} vs {pc['num_points']}, kept "
        f"{kc['num_sig']} vs {pc['num_sig']}; relative L2 errors (worst leaf) {errs}")
    if not all(e <= 1e-5 for e in loss_err.values()):
        fails.append(f"train step losses differ from the plain step: {loss_err}")
    if kc["num_points"] != pc["num_points"] or sig_err > 1e-3:
        fails.append(f"train step sample counts differ from the plain step: {kc} vs {pc}")
    if not all(e <= 5e-3 for e in errs.values()):
        fails.append(f"train step gradients or state differ from the plain step: {errs}")


def train_kernel_phases(trainer, fails):
    """K2, K4b and K6 at the train step's shapes (a batch of the trained
    state; the random occupancy update's probe count) against their plain
    versions; returns their kernel-table entries."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.models.fields import _encoder_input, field_apply, field_density
    from nerfstyle_torch.ops import compositing, hashgrid, marching, occupancy
    from nerfstyle_torch.ops.aabb import near_far_from_aabb
    from nerfstyle_torch.render.pipeline import kept_prefix

    table = {}
    r, spec, s = trainer.renderer, trainer.field_spec, trainer.settings
    plan, bbox, dev = r.plan, r.bbox, trainer.device
    gen = torch.Generator(device=dev).manual_seed(5)
    frame, idx = trainer.sample_batch()
    o, d, _ = trainer.ray_batch(frame, idx)
    n = o.shape[0]
    nears, fars = near_far_from_aabb(o, d, plan.aabb(dev), plan.min_near)
    sb = marching.march_rays(plan, r.occ_state.bitfield, o, d, nears, fars)
    with torch.no_grad():
        sig_a = field_density(spec, trainer.params, bbox, sb.xyz, trainer.compute_dtype)
        *_, n_inc = compositing.sample_weights(sig_a * s.density_scale, sb.tau, sb.offsets,
                                               plan.dt, s.t_thresh)
        keep, offsets = kept_prefix(sb, n_inc)
        xyz, tau = sb.xyz[keep], sb.tau[keep].contiguous()
        ch, sig = field_apply(spec, trainer.params, bbox, xyz, trainer.compute_dtype)
    k = keep.shape[0]

    # K2: the table gradient of phase B's encode (the [T, 4] fused tables)
    # for a random cotangent.  The fp32 atomics add in an order that varies
    # from run to run, up to ~10^5 contributions a row on the coarse levels;
    # against the plain version's float64 sums: 1e-4 of the largest row.
    x = _encoder_input(bbox, xyz).contiguous()
    lvl, c, rows = spec.grid.num_levels, 2 * spec.grid.level_dim, spec.grid.total_params
    lv = hashgrid.level_table(spec.grid, dev)

    def k2_check(pts, what):
        cot = torch.randn((pts.shape[0], lvl * c), generator=gen, device=dev)
        ref = hashgrid.hashgrid_backward_plain(spec.grid, pts, cot.double(), rows)
        got = kernels.hashgrid_backward(pts, cot, lv, rows)
        err = float((got.double() - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        if not err <= tol:
            fails.append(f"K2 table gradient error {err} > {tol} ({what})")
        return cot, err, tol

    # At an early step's shape first: with every cell occupied (the grid
    # before the first updates prune it) a batch marches all its lattice
    # samples, and phase B keeps them all.
    sb0 = marching.march_rays(plan, torch.ones_like(r.occ_state.bitfield), o, d, nears, fars)
    x0 = _encoder_input(bbox, sb0.xyz).contiguous()
    del sb0
    g0, err0, tol0 = k2_check(x0, "early shape")
    ms0 = cuda_ms(lambda: kernels.hashgrid_backward(x0, g0, lv, rows), reps=3, warmup=1)
    log(f"K2 hashgrid_backward at an early step's shape: {x0.shape[0]} samples "
        f"({x0.shape[0] / n:.1f} a ray) x {lvl} levels x 8 corners; max_abs_err {err0:.3e} "
        f"(tol {tol0:.3e}); ms {ms0:.3f}")
    del x0, g0
    g, err, tol = k2_check(x, "late shape")
    ms = cuda_ms(lambda: kernels.hashgrid_backward(x, g, lv, rows), reps=10)
    plain_ms = cuda_ms(lambda: hashgrid.hashgrid_backward_plain(spec.grid, x, g, rows), reps=3)
    corners, oob = hashgrid._corners(spec.grid, x)
    g3 = torch.where(oob[:, None, None], 0.0, g.reshape(k, lvl, c))
    flat_rows = torch.cat([cr.reshape(-1) for cr, _ in corners])
    vals = torch.cat([(w[..., None] * g3).reshape(-1, c) for _, w in corners])
    del corners, g3
    acc = torch.zeros((rows, c), device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, flat_rows, vals), reps=10)
    del flat_rows, vals, acc
    # Bytes: points, cotangent, the [T, C] gradient written once.
    # Operations: per (point, level, corner) 5 for the weight, 2C for w * g
    # and the add.
    b_ms, b_by = bound_ms(nbytes=k * 12 + k * lvl * c * 4 + rows * c * 4,
                          flops=k * lvl * 8 * (5 + 2 * c))
    table["K2"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms)
    log(f"K2 hashgrid_backward: {k} kept samples x {lvl} levels x 8 corners into [{rows}, {c}]; "
        f"max_abs_err {err:.3e} (tol {tol:.3e}); ms {ms:.3f}, plain_ms {plain_ms:.3f}, "
        f"index_add_ ms {lib_ms:.3f}, bound_ms {b_ms:.4f} ({b_by})")

    # K4b: the compositor's backward on phase B's stream for random
    # cotangents, against the plain backward on float64 inputs.  Rays with
    # an entering T within 1e-4 relative of t_thresh may include one sample
    # more or less in fp32 and are left out.  d ch = w * gI: 1e-5 of the
    # largest (w's fp32 rounding); d sigma = dt (T_{i+1} v - suffix) loses
    # digits to the difference: 1e-4 of the largest.
    sigmas = (sig * s.density_scale).contiguous()
    chc = ch.contiguous()
    gi = torch.randn((n, chc.shape[1]), generator=gen, device=dev)
    gw = torch.randn((n,), generator=gen, device=dev)
    gd = torch.randn((n,), generator=gen, device=dev)
    w, _, _, n_inc_b = kernels.composite_weights(sigmas, tau, offsets, plan.dt, s.t_thresh)
    d_s, d_c = kernels.composite_backward(sigmas, chc, tau, w, offsets, n_inc_b, gi, gw, gd,
                                          plan.dt)
    ref_s, ref_c = compositing.composite_backward_plain(
        sigmas.double(), chc.double(), tau.double(), offsets, gi.double(), gw.double(),
        gd.double(), plan.dt, s.t_thresh)
    _, trans64 = compositing.entering_transmittance_plain(sigmas.double(), offsets, plan.dt)
    near = (trans64 - s.t_thresh).abs() <= 1e-4 * s.t_thresh
    edge = compositing.segment_totals_plain(near.double(), offsets) > 0
    inner = ~edge[compositing.ray_ids(offsets)]
    err_s = float((d_s.double() - ref_s)[inner].abs().max()) if bool(inner.any()) else 0.0
    err_c = float((d_c.double() - ref_c)[inner].abs().max()) if bool(inner.any()) else 0.0
    tol_s, tol_c = 1e-4 * float(ref_s.abs().max()), 1e-5 * float(ref_c.abs().max())
    if not (err_s <= tol_s and err_c <= tol_c):
        fails.append(f"K4b errors d_sigma {err_s} (tol {tol_s}), d_ch {err_c} (tol {tol_c})")
    ms = cuda_ms(lambda: kernels.composite_backward(sigmas, chc, tau, w, offsets, n_inc_b, gi,
                                                    gw, gd, plan.dt), reps=20)
    plain_ms = cuda_ms(lambda: compositing.composite_backward_plain(
        sigmas, chc, tau, offsets, gi, gw, gd, plan.dt, s.t_thresh), reps=5)
    cc = chc.shape[1]
    # Bytes: sigma, tau, w and ch of every sample, offsets, n_inc and the
    # cotangents of every ray; d sigma and d ch written once.
    b_ms, b_by = bound_ms(nbytes=k * 4 * (3 + cc) + (n + 1) * 8 + n * 4 * (3 + cc)
                          + k * 4 * (1 + cc), flops=k * (4 * cc + 12))
    table["K4b"] = dict(max_abs_err=max(err_s, err_c), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
    log(f"K4b composite_backward: {k} kept samples x {cc} channels, {int(edge.sum())} edge rays "
        f"left out; max_abs_err d_sigma {err_s:.3e} (tol {tol_s:.3e}), d_ch {err_c:.3e} "
        f"(tol {tol_c:.3e}); ms {ms:.3f}, plain_ms {plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by})")

    # K5 at a train batch's shape, with weight gradients: the color1 head on
    # the kept samples' color features and the density head on their density
    # features (tolerances at mlp_check).
    with torch.no_grad():
        h_c = hashgrid.hashgrid_encode(spec.grid, trainer.params["x_color_embedder"], x)
        h_d = hashgrid.hashgrid_encode(spec.grid, trainer.params["x_density_embedder"], x)
    errs = {head: mlp_check(trainer.params[head], hh, None, trainer.compute_dtype, True, gen,
                            fails, f"{head} at a train batch")
            for head, hh in (("color1_net", h_c), ("density_net", h_d))}
    log(f"K5 at a train batch ({k} rows, {trainer.compute_dtype}, with d W): max abs err "
        f"(out, d x, d W...) {errs}")

    # K6: the random update's probes (H^3/4 uniform and H^3/4 occupied cells a
    # cascade) scatter-maxed into a -1 grid, then the merge and threshold of
    # the trained grid.  Both exact (a max and elementwise arithmetic); the
    # mean sums float64 partials in another order: 1e-6 relative.
    grid = r.occ_state.density_grid
    cascade, ncell = grid.shape
    num = ncell // 4
    pidx = torch.cat([torch.cat([torch.randint(0, ncell, (num,), generator=gen, device=dev),
                                 occupancy.draw_occupied_cells(grid[cas], num, gen)]) + cas * ncell
                      for cas in range(cascade)])
    psig = torch.rand((pidx.shape[0],), generator=gen, device=dev) * 20.0
    tmp = occupancy.scatter_max(torch.full((cascade * ncell,), -1.0, device=dev), pidx, psig)
    tmp_ref = occupancy.scatter_max(torch.full((cascade * ncell,), -1.0, device=dev), pidx, psig,
                                    plain=True)
    if not torch.equal(tmp, tmp_ref):
        fails.append("K6 scatter-max differs from scatter_reduce_")
    scratch = torch.full((cascade * ncell,), -1.0, device=dev)
    ms = cuda_ms(lambda: kernels.occupancy_scatter_max(scratch, pidx, psig), reps=20)
    plain_ms = cuda_ms(lambda: occupancy.scatter_max_plain(scratch, pidx, psig), reps=20)
    lib_ms = cuda_ms(lambda: scratch.scatter_reduce_(0, pidx, psig, "amax"), reps=20)
    p, kc = pidx.shape[0], cascade * ncell
    b_ms, b_by = bound_ms(nbytes=p * 12 + kc * 8, flops=p)
    table["K6s"] = dict(max_abs_err=float((tmp - tmp_ref).abs().max()), ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    log(f"K6 occupancy_scatter_max: {p} probes into {kc} cells; equal to plain: "
        f"{torch.equal(tmp, tmp_ref)}; ms {ms:.3f}, plain_ms {plain_ms:.3f}, scatter_reduce_ ms "
        f"{lib_ms:.3f}, bound_ms {b_ms:.4f} ({b_by})")

    flat = grid.reshape(-1).contiguous()
    merged, bits, mean = kernels.occupancy_merge(flat, tmp, s.density_decay, s.density_thresh)
    merged_p, bits_p, mean_p = occupancy.merge_and_threshold_plain(flat, tmp, s.density_decay,
                                                                   s.density_thresh)
    mean_err = abs(float(mean) - float(mean_p)) / max(abs(float(mean_p)), 1e-30)
    if not (torch.equal(merged, merged_p) and torch.equal(bits, bits_p) and mean_err <= 1e-6):
        fails.append(f"K6 merge differs from plain (mean relative error {mean_err})")
    ms = cuda_ms(lambda: kernels.occupancy_merge(flat, tmp, s.density_decay, s.density_thresh),
                 reps=20)
    plain_ms = cuda_ms(lambda: occupancy.merge_and_threshold_plain(
        flat, tmp, s.density_decay, s.density_thresh), reps=20)
    # Bytes: grid and probe grid read, merged grid and bitfield written.
    b_ms, b_by = bound_ms(nbytes=kc * 13 + 4, flops=kc * 5)
    table["K6m"] = dict(max_abs_err=float((merged - merged_p).abs().max()), ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"K6 occupancy_merge + threshold: {kc} cells, {int(bits.sum())} occupied, mean "
        f"{float(mean):.5f} (relative error {mean_err:.2e}); ms {ms:.3f}, plain_ms "
        f"{plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by})")
    return table


def mlp_check(weights, x, act, dtype, need_dw: bool, gen, fails, what: str):
    """K5 forward and backward (d x, and every d W when ``need_dw``) against
    the plain matmul chain and its autograd on the same inputs and a random
    cotangent; returns the max abs errors (output, d x, d W...).

    Tolerance: fp32 sums in another order, 1e-5 of the largest value; under
    bf16 a value near a rounding step may land on the other side (2^-8 of
    itself) and carry that into what follows: 2^-7 of the largest value."""
    from nerfstyle_torch.ops.mlp import mlp_apply

    g = torch.randn((x.shape[0], weights[-1].shape[1]), generator=gen, device=x.device)
    res = {}
    for plain in (False, True):
        ws = [w.detach().clone().requires_grad_(need_dw) for w in weights]
        xr = x.detach().clone().requires_grad_(True)
        out = mlp_apply(ws, xr, act, dtype, plain=plain)
        res[plain] = (out.detach(),) + torch.autograd.grad(out, [xr] + (ws if need_dw else []), g)
    frac = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    errs = []
    for a, b in zip(res[False], res[True]):
        err, tol = float((a - b).abs().max()), frac * float(b.abs().max())
        errs.append(err)
        if not err <= tol:
            fails.append(f"K5 {what}: error {err} > {tol}")
    return errs


def profile_once(fn, label: str, card: str) -> None:
    """One call of fn under torch.profiler: the kernel table by device time
    and the device's idle share of the call's wall time."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        events = prof.key_averages()
        log(events.table(sort_by="cuda_time_total", row_limit=20, max_name_column_width=60))
        # Device events only: an operator's row repeats its kernels' time.
        busy_ms = sum(e.self_device_time_total for e in events
                      if e.device_type == DeviceType.CUDA) / 1e3
        log(f"profiled {label} ({card}): device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall, "
            f"idle share {1 - busy_ms / wall_ms:.3f}")
    except Exception as e:  # the profiler is a diagnostic only; report and go on
        log(f"profiler unavailable: {type(e).__name__}: {e}")


def train_phase(card: str, fails):
    """The train path through ``python -m nerfstyle_torch.train`` (in-process)
    at the default configs; returns the trainer and its kernel launches."""
    from nerfstyle_torch import kernels, train

    (WORK / "data.yaml").write_text(
        f"root_path: {WORK / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    # The untrained field's test PSNR, as the trainer reports it before its
    # first step (same seed, same views).
    untrained = train.main(train_argv(0, "--test_before_train")).test_history[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train.main(train_argv(TRAIN_STEPS))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name in TRAIN_COUNTERS:
        if launches[name] <= 0:
            fails.append(f"train path launched no {name} kernel")
    notfinite = int(trainer.opt_state.total_notfinite)
    if notfinite or not all(bool(torch.isfinite(v)) for v in trainer.last_losses.values()):
        fails.append(f"non-finite losses: {notfinite} steps skipped, last {trainer.last_losses}")
    rays = trainer.train_cfg.num_rays_per_batch
    ms = trainer.iter_ms
    early, late = float(np.median(ms[1:16])), float(np.median(ms[-50:]))
    cnt = trainer.iter_counts
    per_ray = {f"{what} {k}": float(np.mean([c[k] for c in part])) / rays
               for what, part in (("early", cnt[1:16]), ("late", cnt[-50:]))
               for k in ("num_points", "num_sig")}
    upd = trainer.renderer.update_ms
    if not (upd["full"] and upd["random"]):
        fails.append(f"the run did not take both occupancy updates: {upd}")
    log(f"train ({card}): {TRAIN_STEPS} steps of {rays} rays in {wall_s:.1f} s (first step "
        f"{ms[0]:.1f} ms); step ms median early (steps 1-15) {early:.2f}, late (last 50) "
        f"{late:.2f}; {rays / late * 1e3:.0f} train rays/s late; occupancy update ms full "
        f"median {np.median(upd['full']):.2f} of {len(upd['full'])}, random median "
        f"{np.median(upd['random'] or [0]):.2f} of {len(upd['random'])}; samples/ray (marched = "
        f"num_points, kept = num_sig) {per_ray}; peak memory {peak_gib:.2f} GiB; launches "
        f"{launches} ({ {k: v / TRAIN_STEPS for k, v in launches.items()} } a step)")

    final = trainer.test_networks()
    log(f"test PSNR of the EMA params ({len(trainer.test_set)} views): untrained "
        f"{untrained['psnr']:.3f} dB, after {TRAIN_STEPS} steps {final['psnr']:.3f} dB")
    if not final["psnr"] >= untrained["psnr"] + 5.0:
        fails.append(f"test PSNR rose from {untrained['psnr']:.3f} to {final['psnr']:.3f} dB, "
                     "less than 5 dB")
    return trainer, launches


# ---------------------------------------------------------------------------
# The style path
# ---------------------------------------------------------------------------


def style_assets():
    """The 504x378 synthetic scene with its data YAML, a 256x192 gradient
    style PNG and its 4-quadrant segment map (as bench.py makes them)."""
    from nerfstyle_torch import utils
    from nerfstyle_torch.data.synthetic import generate_scene

    w, h = STYLE_DIMS
    scene = WORK / f"style_scene_{h}x{w}_v{STYLE_VIEWS}"
    generate_scene(scene, num_train=STYLE_VIEWS, num_test=STYLE_TEST_VIEWS, h=h, w=w)
    data_cfg = WORK / "style_data.yaml"
    data_cfg.write_text(f"root_path: {scene}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    yy, xx = np.meshgrid(np.linspace(0, 1, 192), np.linspace(0, 1, 256), indexing="ij")
    style_png, seg_npz = WORK / "style.png", WORK / "style_seg.npz"
    utils.save_image(np.stack([yy, xx, 1 - yy], axis=-1).astype(np.float32), style_png)
    np.savez(seg_npz, seg_map=(yy > 0.5).astype(np.int64) * 2 + (xx > 0.5).astype(np.int64))
    return data_cfg, style_png, seg_npz


def style_phase(card: str, ckpt: Path, fails):
    """The style path through ``python -m nerfstyle_torch.train`` (in-process)
    from the train phase's checkpoint; returns the trainer and its launches."""
    from nerfstyle_torch import kernels, train
    from nerfstyle_torch.training import checkpoint as ckpt_lib

    t0 = time.perf_counter()
    data_cfg, style_png, seg_npz = style_assets()
    log(f"style assets: {STYLE_DIMS[0]}x{STYLE_DIMS[1]} scene of {STYLE_VIEWS} + "
        f"{STYLE_TEST_VIEWS} views, style image and segment map in "
        f"{time.perf_counter() - t0:.1f} s")
    argv = ["--device", DEVICE, "--ckpt", str(ckpt), "--log-dir", str(WORK / "style"),
            "--data-cfg", str(data_cfg), "--style-image", str(style_png),
            "--style_seg_path", str(seg_npz), "--max_steps", "512", "--test_before_train",
            "--intervals.test", "0", "--intervals.print", "20", "--intervals.log", "0",
            "--intervals.ckpt", "200", "--yes"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    st = train.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_iter = st.train_cfg.num_iterations
    for name in STYLE_COUNTERS:
        if launches[name] <= 0:
            fails.append(f"style path launched no {name} kernel")

    hist = {k: np.array([float(h[k]) for h in st.loss_history]) for k in ("content", "style",
                                                                         "total")}
    notfinite = int(st.opt_state.total_notfinite)
    if notfinite or not all(np.isfinite(v).all() for v in hist.values()):
        fails.append(f"style losses not finite ({notfinite} steps skipped)")
    if len(st.loss_history) != n_iter:
        fails.append(f"the style run took {len(st.loss_history)} of {n_iter} iterations")
    first, last10 = float(hist["style"][0]), float(hist["style"][-10:].mean())
    if not last10 < first:
        fails.append(f"the style term did not fall: first {first}, last 10 mean {last10}")

    # Only x_color_embedder may move.
    final = WORK / "style" / f"iter_{n_iter}.ckpt"
    _, before = ckpt_lib.load_checkpoint(ckpt)
    _, after = ckpt_lib.load_checkpoint(final)
    p0 = ckpt_lib.restore_tree(st.params, before["params"])
    p1 = ckpt_lib.restore_tree(st.params, after["params"])
    moved = {k: not all(torch.equal(a, b) for a, b in zip(ckpt_lib.tree_flatten(p0[k]),
                                                        ckpt_lib.tree_flatten(p1[k])))
             for k in p0}
    if moved != {k: k == "x_color_embedder" for k in p0}:
        fails.append(f"style checkpoint leaves moved: {moved}")

    cs = st.cache_stats
    ms = st.iter_ms
    epoch = min(STYLE_VIEWS, len(ms))
    per_ray = [c["sig_per_ray"] for c in cs]
    log(f"style cache builds ({card}): {len(cs)} poses, significant samples/ray mean "
        f"{np.mean(per_ray):.2f} (min {min(per_ray):.2f}, max {max(per_ray):.2f}) of "
        f"{np.mean([c['marched_per_ray'] for c in cs]):.2f} marched, "
        f"{np.mean([c['bytes'] for c in cs]) / 2**20:.1f} MiB a pose, max dropped weight/ray "
        f"{max(c['drop_max'] for c in cs):.3e}, build ms median "
        f"{np.median([c['build_ms'] for c in cs]):.1f}")
    log(f"style run ({card}): {n_iter} iterations at {STYLE_DIMS[0]}x{STYLE_DIMS[1]} in "
        f"{sum(ms) / 1e3:.2f} s of iterations ({wall_s:.2f} s through the entry point, set-up "
        f"included); epoch 1 ({epoch} iterations, {len(cs)} cache builds) {sum(ms[:epoch]) / 1e3:.2f}"
        f" s; median steady iteration {np.median(ms[epoch:]):.2f} ms; peak memory "
        f"{peak_gib:.2f} GiB; style_weights: {'pretrained' if st.fx.pretrained else 'random'}; "
        f"style term first {first:.5f}, last-10 mean {last10:.5f}; content first "
        f"{hist['content'][0]:.6f}, last {hist['content'][-1]:.6f}; matching "
        f"{[int(m) for m in st.style_loss.matching]}; launches {launches}")
    return st, launches


def style_step_vs_plain(st, fails):
    """One style step with the kernels and the same step with every plain
    version, from the same params and pose cache.  Loss terms: 1e-5
    relative; the color-table gradient: relative L2 error 5e-3 (K2's atomics
    and fp32 sums in another order, and under bf16 a cotangent landing on the
    other side of a rounding step)."""
    from nerfstyle_torch import kernels

    pose = next(iter(st._geom_cache))
    cache = st.geom_cache(pose)
    runs = {}
    for plain in (False, True):
        kernels.reset_launch_counts()
        losses, grads = st.loss_and_grads(cache, plain=plain)
        torch.cuda.synchronize()
        runs[plain] = (losses, grads["x_color_embedder"], dict(kernels.launch_counts))
    (lk, gk, ck), (lp, gp, cp) = runs[False], runs[True]
    missing = [c for c in STYLE_STEP_COUNTERS if ck[c] <= 0]
    if missing:
        fails.append(f"the style step launched no {missing}")
    if any(cp.values()):
        fails.append(f"the plain style step launched kernels: {cp}")
    loss_err = {k: abs(float(lk[k]) - float(v)) / max(abs(float(v)), 1e-30)
                for k, v in lp.items()}
    grad_err = rel_l2(gk, gp)
    log(f"style step with kernels vs plain (pose {pose}): loss relative errors {loss_err}; "
        f"color-table gradient relative L2 error {grad_err:.3e}; launches a step {ck}")
    if not all(e <= 1e-5 for e in loss_err.values()):
        fails.append(f"style step losses differ from the plain step: {loss_err}")
    if not grad_err <= 5e-3:
        fails.append(f"style step gradient differs from the plain step: {grad_err}")
    return ck


def style_kernel_phases(st, fails):
    """K5 (the three color heads) forward and backward, and K7b, at the style
    stream's shape, against their plain versions; returns their table
    entries."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.models.fields import _encoder_input
    from nerfstyle_torch.ops import compositing, hashgrid
    from nerfstyle_torch.ops.mlp import mlp_apply, mlp_apply_plain

    table = {}
    dev, dtype, params = st.device, st.compute_dtype, st.params
    gen = torch.Generator(device=dev).manual_seed(11)
    cache = st.geom_cache(next(iter(st._geom_cache)))
    n_rows = cache["w"].shape[0]
    with torch.no_grad():
        x = _encoder_input(st.renderer.bbox, cache["xyz"]).contiguous()
        h_c = hashgrid.hashgrid_encode(st.field_spec.grid, params["x_color_embedder"], x)
        c1 = mlp_apply(params["color1_net"], h_c, None, dtype)
    heads = [(params["class_net"], h_c, None), (params["color1_net"], h_c, None),
             (params["color2_net"], c1, "sigmoid")]
    errs = [mlp_check(w, hh, act, dtype, False, gen, fails, f"head {i} at the style stream")
            for i, (w, hh, act) in enumerate(heads)]
    bf16 = dtype == torch.bfloat16
    gs = [torch.randn((n_rows, w[-1].shape[1]), generator=gen, device=dev) for w, _, _ in heads]

    def fwd(plain):
        fn = mlp_apply_plain if plain else mlp_apply
        return [fn(w, hh, act, dtype) for w, hh, act in heads]

    def bwd():
        return [kernels.mlp_backward(hh, w, g, act == "sigmoid", bf16, [False] * len(w))
                for (w, hh, act), g in zip(heads, gs)]

    def bwd_plain():
        outs = []
        for (w, hh, act), g in zip(heads, gs):
            xr = hh.detach().requires_grad_(True)
            outs.append(torch.autograd.grad(mlp_apply_plain(w, xr, act, dtype), xr, g))
        return outs

    with torch.no_grad():
        f_ms = cuda_ms(lambda: fwd(False), reps=10)
        f_plain = cuda_ms(lambda: fwd(True), reps=5)
        f_lib = cuda_ms(lambda: fwd(True), reps=5)
        b_ms = cuda_ms(bwd, reps=10)
    b_plain = cuda_ms(bwd_plain, reps=5)
    # Bytes: each launch reads its input rows and writes its output rows
    # (the backward: reads x and g, writes d x); the weights once.
    # Operations: 2 d_in d_out a row a layer (the backward recomputes the
    # forward and then takes d x: twice that).  Peak: bf16 dense tensor
    # cores under AMP (fp32 otherwise).
    dims = [[w.shape[0] for w in ws] + [ws[-1].shape[1]] for ws, _, _ in heads]
    macs = sum(sum(a * b for a, b in zip(d[:-1], d[1:])) for d in dims)
    wbytes = sum(w.numel() * 4 for ws, _, _ in heads for w in ws)
    peak = PEAK_BF16_PER_S if bf16 else PEAK_FP32_PER_S
    fb_ms, fb_by = bound_ms(n_rows * 4 * sum(d[0] + d[-1] for d in dims) + wbytes,
                            2 * n_rows * macs, peak)
    bb_ms, bb_by = bound_ms(n_rows * 4 * sum(2 * d[0] + d[-1] for d in dims) + wbytes,
                            4 * n_rows * macs, peak)
    table["K5f"] = dict(max_abs_err=max(e[0] for e in errs), ms=f_ms, plain_ms=f_plain,
                        bound_ms=fb_ms, bound_by=fb_by, library_ms=f_lib)
    table["K5b"] = dict(max_abs_err=max(e[1] for e in errs), ms=b_ms, plain_ms=b_plain,
                        bound_ms=bb_ms, bound_by=bb_by, library_ms=b_plain)
    log(f"K5 color heads at the style stream ({n_rows} rows, {dtype}, layer widths {dims}): max "
        f"abs err (out, d x) {errs}; forward ms {f_ms:.3f} (plain {f_plain:.3f}, torch.matmul "
        f"chain {f_lib:.3f}), bound_ms {fb_ms:.4f} ({fb_by}); backward ms {b_ms:.3f} (plain "
        f"forward + autograd {b_plain:.3f}), bound_ms {bb_ms:.4f} ({bb_by})")

    # K7b: d ch = w * g[ray] for a random pixel cotangent: one fp32 product,
    # equal bits.
    w, offsets = cache["w"], cache["offsets"]
    n_pix, cc = offsets.shape[0] - 1, 3 + st.field_spec.class_dim
    g = torch.randn((n_pix, cc), generator=gen, device=dev)
    d_ch, _ = kernels.segment_sum_backward(w, None, g, offsets)
    ref, _ = compositing.segment_sum_backward_plain(w, None, g, offsets)
    err = float((d_ch - ref).abs().max())
    if not torch.equal(d_ch, ref):
        fails.append(f"K7b differs from its plain version: max abs err {err}")
    ms = cuda_ms(lambda: kernels.segment_sum_backward(w, None, g, offsets), reps=20)
    plain_ms = cuda_ms(lambda: compositing.segment_sum_backward_plain(w, None, g, offsets),
                       reps=10)
    b_ms, b_by = bound_ms(n_rows * 4 + n_pix * cc * 4 + (n_pix + 1) * 8 + n_rows * cc * 4,
                          n_rows * cc)
    table["K7b"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None)
    log(f"K7b segment_sum_backward: {n_rows} samples x {cc} channels over {n_pix} rays; equal "
        f"to plain: {torch.equal(d_ch, ref)}; ms {ms:.3f}, plain_ms {plain_ms:.3f}, bound_ms "
        f"{b_ms:.4f} ({b_by})")
    return table


# ---------------------------------------------------------------------------
# Frame checks
# ---------------------------------------------------------------------------


def silhouette_iou(rays_o: torch.Tensor, rays_d: torch.Tensor, ws: torch.Tensor) -> float:
    """IoU of the rendered opacity (weights_sum > 0.5) and the spheres'
    analytic silhouette."""
    from nerfstyle_torch.data.synthetic import _SPHERES

    hit = torch.zeros(rays_o.shape[0], dtype=torch.bool, device=rays_o.device)
    for cx, cy, cz, r in _SPHERES.tolist():
        oc = rays_o - torch.tensor([cx, cy, cz], device=rays_o.device)
        b = (rays_d * oc).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - r * r)
        hit |= (disc > 0) & (-b + torch.sqrt(disc.clamp(min=0)) > 0)
    opaque = ws > 0.5
    return float((hit & opaque).sum()) / max(1, int((hit | opaque).sum()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from nerfstyle_torch import kernels
    from nerfstyle_torch.core.cameras import generate_rays
    from nerfstyle_torch.render import cli

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = kernels.build(verbose=True)
    kernels.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib.relative_to(ROOT)}")

    WORK.mkdir(parents=True, exist_ok=True)
    ckpt = WORK / "smoke.ckpt"
    write_checkpoint(ckpt)
    renderer, params, test_set, _ = cli.load_renderer(ckpt, DEVICE, OUT_DIMS, max_count=1)
    pose = torch.from_numpy(np.asarray(test_set[0][1]))
    rays = generate_rays(pose.to(DEVICE), renderer.intr, renderer.settings.flip_camera)

    table, fails = kernel_phases(renderer, params, rays.origins, rays.dirs)

    # The main path, through the CLI entry point.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    summary = cli.main([str(ckpt), "--out-dims", *map(str, OUT_DIMS), "--max-count", "1",
                        "--yes", "--out-dir", str(WORK / "render"), "--device", DEVICE])
    launches = dict(kernels.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name in RENDER_COUNTERS:
        if launches[name] <= 0:
            fails.append(f"render path launched no {name} kernel")
    out = summary["last"]
    npix = OUT_DIMS[0] * OUT_DIMS[1]
    shapes = {"rgb_map": (npix, 3), "trans_map": (npix,), "weights_sum": (npix,),
              "classes": (npix, renderer.raymarch_channels - 3)}
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp or not bool(torch.isfinite(out[k]).all()):
            fails.append(f"frame {k}: shape {tuple(out[k].shape)} (want {shp}) or not finite")
    frame_ms = summary["frame_ms"][0]
    log(f"main path ({card}): frame {frame_ms:.1f} ms ({summary['fps']:.2f} FPS, first frame "
        f"of the process), {out['num_marched'] / npix:.2f} samples/ray marched, "
        f"{out['num_sig'] / npix:.2f} significant, peak memory {peak_gib:.2f} GiB, "
        f"launches {launches}")

    iou = silhouette_iou(rays.origins, rays.dirs, out["weights_sum"])
    log(f"opacity vs analytic sphere silhouette: IoU {iou:.4f}")
    if not iou >= 0.8:
        fails.append(f"frame opacity IoU with the spheres {iou:.4f} < 0.8")

    # A 4096-ray crop (the central 64x64 pixels) through the plain path on
    # the card.  K1, K3 exact; K4 may flip a sample at the t_thresh cutoff
    # (<= 1e-4 per ray); bf16 MLP activations may round to the neighbouring
    # value where cuBLAS sums a different batch in another order: atol 2e-3
    # on rgb, opacity and depth, 2e-2 on class logits.
    w, h = OUT_DIMS
    ys, xs = np.meshgrid(np.arange(h // 2 - 32, h // 2 + 32), np.arange(w // 2 - 32, w // 2 + 32),
                         indexing="ij")
    crop = torch.from_numpy((ys * w + xs).reshape(-1)).to(DEVICE)
    ref = renderer.render_rays(params, rays.origins[crop], rays.dirs[crop], plain=True)
    crop_err = {k: float((out[k][crop] - ref[k]).abs().max()) for k in shapes}
    crop_tol = {"rgb_map": 2e-3, "trans_map": 2e-3, "weights_sum": 2e-3, "classes": 2e-2}
    log(f"crop of 4096 rays vs plain path: max abs err {crop_err} (tol {crop_tol}), "
        f"crop samples marched {ref['num_marched']}")
    for k, tol in crop_tol.items():
        if not crop_err[k] <= tol:
            fails.append(f"crop {k} error {crop_err[k]} > {tol}")

    # Steady state: the same frame again (kernels built, cuBLAS warm), and
    # its device time by kernel.
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        renderer.render(params, pose)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    log(f"steady frame ({card}): {min(times):.1f} ms min of {['%.1f' % t for t in times]} "
        f"-> {1e3 / min(times):.2f} FPS at {w}x{h}")
    profile_once(lambda: renderer.render(params, pose), "frame", card)
    del renderer, params, rays, ref, out, summary
    torch.cuda.empty_cache()

    # The train path, through the train entry point; then one step against
    # the plain versions, the train kernels at the step's shapes, and one
    # late step under the profiler.
    trainer, train_launches = train_phase(card, fails)
    step_vs_plain(trainer, fails)
    table.update(train_kernel_phases(trainer, fails))
    profile_once(trainer.run_iter, "late train step", card)
    ckpt_train = trainer.log_dir / f"iter_{TRAIN_STEPS}.ckpt"
    del trainer
    torch.cuda.empty_cache()

    # The style path from the train phase's checkpoint; then one step
    # against the plain versions, K5 and K7b at the style stream's shape, and
    # one steady iteration under the profiler.
    st, style_launches = style_phase(card, ckpt_train, fails)
    style_step_vs_plain(st, fails)
    table.update(style_kernel_phases(st, fails))
    profile_once(st.run_iter, "steady style iteration", card)

    # A kernel's launches: its count on the render, train and style paths.
    # K3 is two kernels (count and write passes), K6's merge two (merge and
    # threshold): their launches are both's.
    meta = {
        "K1": ("hashgrid_encode", "nerfstyle_torch/csrc/hashgrid.cu",
               "nerfstyle_tpu/ops/hashgrid.py:818", ("hashgrid_encode",)),
        "K2": ("hashgrid_backward", "nerfstyle_torch/csrc/hashgrid.cu",
               "nerfstyle_tpu/ops/hashgrid.py:959", ("hashgrid_backward",)),
        "K3": ("march_rays", "nerfstyle_torch/csrc/march.cu",
               "nerfstyle_tpu/ops/marching.py:320", ("march_count", "march_write")),
        "K4": ("composite_weights", "nerfstyle_torch/csrc/composite.cu",
               "nerfstyle_tpu/ops/compositing.py:94", ("composite_weights",)),
        "K4b": ("composite_backward", "nerfstyle_torch/csrc/composite.cu",
                "nerfstyle_tpu/ops/compositing.py:116", ("composite_backward",)),
        "K6s": ("occupancy_scatter_max", "nerfstyle_torch/csrc/occupancy.cu",
                "nerfstyle_tpu/ops/occupancy.py:281", ("occupancy_scatter_max",)),
        "K6m": ("occupancy_merge", "nerfstyle_torch/csrc/occupancy.cu",
                "nerfstyle_tpu/ops/occupancy.py:157", ("occupancy_merge", "occupancy_threshold")),
        "K7": ("segment_sum", "nerfstyle_torch/csrc/composite.cu",
               "nerfstyle_tpu/render/renderer.py:648", ("segment_sum",)),
        "K5f": ("mlp_forward", "nerfstyle_torch/csrc/mlp.cu",
                "nerfstyle_tpu/ops/mlp.py:45", ("mlp_forward",)),
        "K5b": ("mlp_backward", "nerfstyle_torch/csrc/mlp.cu",
                "nerfstyle_tpu/ops/mlp.py:45", ("mlp_backward",)),
        "K7b": ("segment_sum_backward", "nerfstyle_torch/csrc/composite.cu",
                "nerfstyle_tpu/training/style_trainer.py:875", ("segment_sum_backward",)),
    }
    rows = []
    for kid, (name, source, replaces, counters) in meta.items():
        label = kid[:2] if kid[:2] in ("K5", "K6") else kid  # K5's and K6's two rows
        rows.append({"name": f"{label} {name}", "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(launches[c] + train_launches[c] + style_launches[c]
                                     for c in counters),
                     **table[kid]})
    if fails:
        for f in fails:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
