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
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
OUT_DIMS = (1008, 756)
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


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_PER_S * 1e3
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
    w, ws, dep = compositing.sample_weights(sig, sb.tau, sb.offsets, plan.dt, s.t_thresh)
    w64, ws64, dep64 = compositing.sample_weights(sig.double(), sb.tau.double(), sb.offsets,
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
    for name, count in launches.items():
        if count <= 0:
            fails.append(f"main path launched no {name} kernel")
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
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            renderer.render(params, pose)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        events = prof.key_averages()
        log(events.table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=60))
        # Device events only: an operator's row repeats its kernels' time.
        busy_ms = sum(e.self_device_time_total for e in events
                      if e.device_type == DeviceType.CUDA) / 1e3
        log(f"profiled frame ({card}): device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall, "
            f"idle share {1 - busy_ms / wall_ms:.3f}")
    except Exception as e:  # the profiler is a diagnostic only; report and go on
        log(f"profiler unavailable: {type(e).__name__}: {e}")

    # K3 is two kernels (count and write passes): its launches are both's.
    meta = {
        "K1": ("hashgrid_encode", "nerfstyle_torch/csrc/hashgrid.cu",
               "nerfstyle_tpu/ops/hashgrid.py:818", ("hashgrid_encode",)),
        "K3": ("march_rays", "nerfstyle_torch/csrc/march.cu",
               "nerfstyle_tpu/ops/marching.py:320", ("march_count", "march_write")),
        "K4": ("composite_weights", "nerfstyle_torch/csrc/composite.cu",
               "nerfstyle_tpu/ops/compositing.py:94", ("composite_weights",)),
        "K7": ("segment_sum", "nerfstyle_torch/csrc/composite.cu",
               "nerfstyle_tpu/render/renderer.py:648", ("segment_sum",)),
    }
    rows = []
    for kid, (name, source, replaces, counters) in meta.items():
        rows.append({"name": f"{kid} {name}", "route": "cuda", "source": source,
                     "replaces": replaces, "launches": sum(launches[c] for c in counters),
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
