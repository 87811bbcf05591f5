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
   1008x756 frame; the 2 x 128^3 grid for K6c, and a sparse random grid):
   the CUDA kernel against its plain PyTorch version on the same inputs,
   with the tolerance stated at each check, and both timed with CUDA events
   after warm-up (K4, K6c, K7 and K7's `index_add_` yardstick, shorter than
   the host's work a call, from a CUDA graph of 20 calls).  The two-stage
   march (K3s) is also held against
   the dense march (K3), bit for bit; K7 also on rays longer than its
   staged tile.  K1 and K1s on the chunk's two streams in march order
   (phase A's marched samples, phase B's kept ones) and on a probe chunk of
   each occupancy update; K1, K1s and K2s also at 2^20 random picks of the
   chunk's stream, the earlier tables' shape, logged only.
4. The main path: ``python -m nerfstyle_torch.render <ckpt> --out-dims 1008
   756 --max-count 1 --yes``, in-process, with every launch counter set to 0
   just before and read just after; each kernel must have launched (the
   two-stage march, and K6c on the checkpoint's restore).
5. Checks the frame: finite, of the expected shape, its opacity matching
   the spheres' analytic silhouette, a 4096-ray crop matching the plain
   path on the card, and the same frame with adaptive_march off (the dense
   march, its launches counted; every sample of nonzero weight colored)
   equal to the two-stage frame at sig_eps 0; steady frames with the march
   on and off in turns.
6. The import path: the checkpoint's tables, heads and grid written as a
   reference ``iter_*.pth`` (Morton order and packed bits through K8a/K8b,
   held against their plain versions) and imported through ``python -m
   nerfstyle_torch.import_reference``, launches counted; tables and grid
   equal to the source and its frame equal to the main path's; K8a and
   K8b timed at the grid's size.
7. The train path: ``python -m nerfstyle_torch.train`` in-process at the
   default configs (4096 rays a step, two 2^19-row tables, grid 128, AMP)
   on the synthetic scene for 300 steps, past update_thres, so that both
   occupancy updates run; launch counters set to 0 just before and read
   just after, each train kernel (K1-K6, K6c, K3s, K7) must have launched,
   no step may be non-finite, and the EMA params' test PSNR must rise 5 dB
   above the untrained field's on the same views.  Prints step times early
   and late, train rays/s, occupancy-update times, samples per ray and peak
   memory.
8. One more step with the kernels against the same step with every plain
   version, from the same state and rays (tolerances at step_vs_plain);
   K3 and K3s at a late batch, K1 and K4 on its marched and kept streams,
   K2 and K4b on the kept one, K6 against their plain versions at the
   step's shapes, and K5 with its weight gradients at a batch's
   shape; K5's backward with every weight gradient at 2^20 rows (two
   launches must give the same bits), timed; late steps with
   adaptive_march on and off in turns (the
   off turns' dense-march launches counted); one late step under the
   profiler; eight more through the trainer's own trace window
   (``--profile_dir``), split step by step (``read_trace``).
9. The style path: ``python -m nerfstyle_torch.train --ckpt <the train
   phase's checkpoint> --style-image tests/data/style.jpg --style_seg_path <npz>
   --max_steps 512`` in-process, on a 504x378 synthetic scene (30 train
   views, 3 test views), 200 iterations (cfgs/training/style.yaml) with
   their launch counters set to 0 just before and read just after; each
   style kernel (K1-K5, K3s, K6c, K7, K7b) must have launched, every loss
   must be finite, the mean style term of the last 10 iterations must lie
   below the first's, and the written checkpoint must differ from the train
   phase's only in x_color_embedder; its test pass writes video.gif, one
   frame a test view.  Prints the cache builds, the first
   epoch (30 builds), the median steady iteration, the whole run, peak
   memory and each kernel's launches a step.  Then one style step with the
   kernels against the same step with every plain version, the gradient
   compared with the step's discrete choices pinned to the plain step's
   and the flips bounded (style_step_vs_plain); the error split by source
   (style_error_split: each step's noise, one kernel family at a time
   routed to its plain version, the flips, a rounding-sized nudge of the
   plain step's image, pinned and not); K1 and K2 on a
   pose's cached stream, K4 on a pose's marched chunk, K5 forward and
   backward and K7b at the style stream's shape against their plain
   versions, timed, K5's cuBLAS chain (its library yardstick:
   mlp_library_chain, with K5's rounding points) held against the plain
   version and timed, and one steady iteration under the profiler.  Then
   the two-pass scheme (``style_two_pass_phase``): ``--style_geom_cache``
   from the same checkpoint on the same scene, TWO_PASS_ITERS iterations
   (6 windows of 200 x 200) with their launches counted, each of its
   kernels on its two-pass streams (count_two_pass_streams); losses
   finite, the style term falling, only x_color_embedder moved; the median
   iteration and its split beside the cached one, peak memory, one
   iteration under the profiler; on one pose its loss against the eps-0
   cached step's, pass 2's gradient against the cache's VJP and against
   plain (two_pass_check), again with the view-direction field (K5d
   assemble must launch); K1, K2, K4 and K4b on its streams.
10. The simplex path: ``python -m nerfstyle_torch.train
   --pos_enc.simplex_from 10`` at the default width for 150 steps (its
   launches counted: K1s, K2s), the test PSNR must rise 5 dB, one step
   against every plain version, K1s and K2s on a late batch's streams, and
   one frame from its checkpoint through the render entry point.
11. The view configuration (``view_phase``, after the main frame): the
   render checkpoint's network as the style field with the view-direction
   input (``use_dir``, SH degree 4: color2 [32, 64, 64, 3]) and as the base
   field (``kind="base"``, density_out_dims 16: rgb_net [31 padded to 32,
   64, 64, 3]), seeded random weights, each through ``Renderer.render``
   (library API: the entry points build neither) on the 1008x756 frame,
   launch counters set to 0 before the occupancy restore and read after
   the frame: K5d's second entry (sh_assemble, the color head's input),
   K1, K3s, K4, K5, K7 and K6c must launch, K5d's first entry not;
   finite maps, the opacity IoU with the spheres >= 0.8, a 4096-ray crop
   within the render phase's tolerances of the plain path; steady frames
   of the default field and both families in turns, and one frame of each
   under the profiler.  No other run may launch K5d.
13. The incremental renderer (``incremental_phase``, after the view
   phase): the main frame through ``RenderSettings(infer_two_phase=False)``
   (library API, as in JAX: rounds of infer_round_size samples an alive
   ray), launch counters set to 0 just before and read just after: K4i
   (K4 with each ray's entering transmittance), P0 (the rounds' row
   gathers), K1, K5, K7 and K3s must launch, K4 and K5d not; finite maps,
   the frame against the two-phase frame at sig_eps 0 and a 4096-ray crop
   against the plain path; rounds a chunk, the round loop's host reads and
   the frame's synchronizing calls (torch.cuda's sync debug mode), samples
   evaluated beside the two-phase frame's phase A and B, steady frames of
   both schemes in turns; K4i, P0, K1 and K5's forward on the frame's
   largest round against their plain versions, timed (P0 also on the
   view-dependent fields' 32-byte rows, K4i also on a later round at round
   size 4); K4i and P0 also cold (``cold_ms``: a 128 MiB write before
   each launch, so that the round's bytes come from HBM; their share of
   the bound is taken from it), beside an empty kernel's warm and cold
   times.  K8b's rows (import phase) are timed cold too.
14. Before the style path: VGG16's input gradient on a planted-tie frame
   (exact-zero pre-activations, tied pool windows) on the card against the
   CPU, layer by layer (``vgg_tie_check``).  The style path reads its
   style image from tests/data/style.jpg (a baseline JPEG written by PIL),
   whose decode must equal tests/data/style_jpg_pil.npy (PIL's) bit for
   bit, and writes video.gif of its test views (one frame a view).  After
   it, steady style iterations with VGG16's ReLU as torch.relu and as the
   port's (JAX's gradient at 0), in turns (``relu_ab_ms``).

15. The library API (``library_api_phase``, after the incremental
   renderer; no entry point of either package calls it): K1 and K1s at
   style slots 0, 1, 63 and 511 on the frame's phase-A stream (2^21
   points), bit for bit against the plain encode at the same slot, rows at
   63 and s = 63 against s = 0 in turns; on the late train batches'
   phase-B streams (the default and the simplex run's,
   ``train_stream_rows``) K1/K1s at slots 1, 63 and 511 bit for bit and
   K2/K2s at 1 and 63 (rows at 63); a multi-style round trip (K9 to 64 slots on a small grid, K1 at 63
   against the plain encode of that table); K2x, the position gradient of
   ``hashgrid_encode(fast_vjp=False)``, on the frame chunk's kept stream
   (129,929 points, C = 2) and with simplex levels, against autograd
   through the plain encode within K2X_TOL of the largest |d x|; the room
   frame's baseline and progressive JPEGs (SHA256 of PIL's decodes, host
   ms) and a CMYK JPEG (PIL's array); the dense stratified oracle
   (``ops/stratified.py``, STRATIFIED_SAMPLES a ray, the field through K1 +
   K5, unoccupied cells and each ray's outside at density 0) on the
   frame's central 64x64 crop and on the 64x64 window nearest half
   opacity (a silhouette) against the two-phase frame within
   STRATIFIED_BOUND; ``Renderer.render`` of that patch against the
   frame's crop, and of a 4096-ray training batch (finite maps, each
   target its ray's pixel); VGG19's fallback filters on the card against
   the CPU, every ``convN_M`` key within 1e-5 of its largest entry.

12. The real-scene layouts (``real_scene_phase``, after the train path):
   the synthetic room written as an LLFF layout (``write_llff_layout``: 32
   train views of 504x378, the size of LLFF's images_8, with seg maps, and
   8 test poses whose images the layout withholds; poses with the camera's
   y and z negated, translations over the data config's scale 0.33) and as
   one Replica trajectory (``write_replica_layout``: 48 views of 320x240).
   LLFF: 300 steps through ``python -m nerfstyle_torch.train`` at the
   default width (cfgs/renderer/llff.yaml: flip_camera 3), steps 284-291
   traced (``--profile_dir``); the test split rendered through ``python -m
   nerfstyle_torch.render`` from that and from a one-step checkpoint, whose
   PSNR against the withheld views must be 5 dB lower; 20 style iterations
   from the 300-step checkpoint (the style term's last-5 mean below its
   first; K7b must launch).  Replica: 150 steps; the trainer's test PSNR
   (every 8th frame) must rise 5 dB.  Each run's launches are counted on
   its own.  The trace is read step by step (``read_trace``): wall time,
   device busy time and kernels, the runtime's launch calls, syncs and
   device-to-host copies, the rest; every train-path hand kernel must
   appear in it by its ``__global__`` name.

16. Data parallelism over rays (``dp_phase``, after every other path):
   dp_run unsharded in this process, then in dp_world()'s ranks (two
   processes sharing the card over gloo; NCCL over every card where there
   are two or more), started together: the train phase's run resumed at
   step 300 (the first late batch's losses and gradient, 8 late steps
   with an occupancy update, 4 more with each collective between device
   syncs), a cached style step (pinned to the unsharded step's choices,
   and unpinned), pass 1 and pass 2 of the two-pass scheme on one pose,
   and the 1008x756 frame, each held against the unsharded run at its
   path's card tolerance; the ranks' params and grids must agree, and each
   part must launch its kernels on every rank.  Prints one JSON line
   ``{"dp": ...}``: the card, the late step with and without the mesh, the
   collectives a step, their bytes and their share of a step.

Before the main path: K5d's first entry (sh_encode) at a frame chunk's
kept stream (129,929 rows) and at a style cache's size (640,000), and its
second (sh_assemble: features, SH basis and K5's zero padding in one
tensor) at the kept stream for both view families, bit for bit against
plain and against the chain of operators it replaces, timed beside it; K9
(grid_initialize, on no path) at the default grid with one style (bit for
bit against plain at full size: the reference on every reached row) and
two styles, and at a small spec with three styles every reached row
holding a colliding corner's value; P0 (take_rows) at the TPU kernel's
own shape and at 2^20 indices, bit for bit, beside ``index_select``.  K9's
bound counts its corner traffic, a row (4C bytes) an access, at an L2 rate
the script measures (``l2_rate``, the launch floor taken off).  The run's
seconds are logged at the end.

K1 and K2 have a row in the kernel table for each stream they run on,
timed on that stream and given that stream's launches: each launch of
theirs on a path is counted by stream (``count_hashgrid_streams``).  So
have K4 (a frame chunk's and a style pose's marched chunk, a late train
batch's marched stream and its kept prefix) and K4b (the kept prefix),
timed from CUDA graphs of the kernel call alone
(``count_composite_streams``); a launch outside these streams fails the
run.  K6, K6c, K7b and K8 are timed from CUDA graphs too, K8a beside an
empty kernel's time (the launch floor).  Each row has ``calls`` beside
``launches``: the calls of a row's wrapper (K3 and K3s launch two kernels
a call, K6c kernels.SKIPDIST_LAUNCHES), and the rule-2 queue, calls x (ms
- bound_ms), is logged.

Grid sizes and class heads off the defaults: K6c against the plain
version at 2 x 256^3, 2 x 100^3, 2 x 512^3 and 1 x 24^3, warm and cold,
an occupancy restore and merge at grid 256 through ops/occupancy.py (K6c,
no plain version), and a 4096-ray crop rendered at grid 256 against the
plain path (skipdist_sizes_phase); class heads of width 0 (field_apply and
field_color forward and backward) and 70 (the head through K5 in 64-column
slices, K7 and K7b at 73 channels) against their plain versions
(class_head_phase).

Prints the kernel table as one JSON line, then the last line
``{"ok": true, "device": {...}}``.  Exits nonzero, printing no result,
without a CUDA device or when any phase fails.

    python3 chip_smoke.py --late-step

runs the train path alone (the train phase above) and then five late
steps, each under the profiler, and prints what each step issued
(operators, kernel launches, device events, synchronizations) and its
device busy time as one JSON line.

    python3 chip_smoke.py --view-frame

renders the main path's frame through the default field and both
view-dependent families (as the view phase builds them), two frames of
each under the profiler, and prints what each frame issued as one JSON
line.  A copy of this file in each of two checkouts compares their late
steps or their frames by what they issue, which the host's noise does not
move.

    python3 chip_smoke.py --round-kernels

times the incremental frame's round kernels alone, as the incremental
phase does (P0 on the largest round's 16- and 32-byte rows, K4i on the
largest round and on a round-size-4 round, warm and cold, beside the
launch floor; P0 also at its own shape and at 2^20 indices) and prints
them as one JSON line; a copy of this file in a
parent's checkout times the parent's kernels on the same card (run
parent, change, change, parent in one call).

    python3 chip_smoke.py --k6c-k2x

times K6c (2 x 256^3, 2 x 100^3, 2 x 512^3 and 2 x 128^3) and K2x (a frame
chunk's kept stream, trilinear and simplex levels, beside K1 on it) alone,
warm and cold, each held against its plain version, with K6c at fixed
tile sides, and the SASS instructions of K2x, K1, K2 and K6c, as one
JSON line (k6c_k2x_rows); a copy in another checkout that has this mode
times that tree's kernels in turns as above.

    python3 chip_smoke.py --dp

writes the render checkpoint, trains the train phase's 300 steps and
writes the style assets, then runs the dp phase alone and prints its JSON
line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import shutil
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
# Each path's kernels.  The two-stage march (K3s) is the default on every
# path; the dense march (K3) runs with adaptive_march off.  K6c rebuilds the
# skip distance on every restore and occupancy update.
RENDER_COUNTERS = ("hashgrid_encode", "march_skip_count", "march_skip_write",
                   "composite_weights", "segment_sum", "mlp_forward", "occupancy_skipdist")
DENSE_COUNTERS = ("march_count", "march_write")
TRAIN_COUNTERS = ("hashgrid_encode", "hashgrid_backward", "march_skip_count", "march_skip_write",
                  "composite_weights", "composite_backward", "segment_sum", "mlp_forward",
                  "mlp_backward", "occupancy_scatter_max", "occupancy_merge",
                  "occupancy_skipdist")
STEP_COUNTERS = ("hashgrid_encode", "hashgrid_backward", "march_skip_count", "march_skip_write",
                 "composite_weights", "composite_backward", "segment_sum", "mlp_forward",
                 "mlp_backward")
# The simplex configuration (levels 10-15 on 4 Freudenthal vertices): a
# short run at the default width, then a frame from its checkpoint.
SIMPLEX_FROM = 10
SIMPLEX_STEPS = 150
# The import path: a synthetic reference checkpoint (grid 128, 2 cascades)
# through python -m nerfstyle_torch.import_reference.
IMPORT_COUNTERS = ("unpackbits", "morton3d")
# The style path: the README's size (504x378, 30 train views, 3 test views),
# max_steps 512, the 200 iterations of cfgs/training/style.yaml.
STYLE_DIMS = (504, 378)
STYLE_VIEWS, STYLE_TEST_VIEWS = 30, 3
STYLE_COUNTERS = ("hashgrid_encode", "hashgrid_backward", "march_skip_count",
                  "march_skip_write", "composite_weights", "mlp_forward", "mlp_backward",
                  "segment_sum", "segment_sum_backward", "occupancy_skipdist")
STYLE_STEP_COUNTERS = ("hashgrid_encode", "hashgrid_backward", "mlp_forward", "mlp_backward",
                       "segment_sum", "segment_sum_backward")
# The two-pass style scheme (style_two_pass_phase): one epoch (the 30
# train views) of ``--style_geom_cache`` (the flag toggles its default true)
# on the style path's scene and checkpoint, windows of the default
# defer_patch_size 200 (3 x 2 at 504x378, the bottom row shifted).  Its
# kernels, each on its two-pass streams (K1 and K4 in pass 1 and in pass
# 2's windows, phases A and B; K2 and K4b in the windows' backward).
TWO_PASS_ITERS = 30
TWO_PASS_COUNTERS = ("hashgrid_encode", "hashgrid_backward", "march_skip_count",
                     "march_skip_write", "composite_weights", "composite_backward",
                     "mlp_forward", "mlp_backward", "segment_sum", "occupancy_skipdist")
TWO_PASS_STREAMS = tuple(f"two-pass {p} {ab}" for p in ("frame", "window") for ab in "AB")
TWO_PASS_STREAM_COUNTERS = (
    *(f"hashgrid_encode:{t}" for t in TWO_PASS_STREAMS),
    *(f"composite_weights:{t}" for t in TWO_PASS_STREAMS),
    "hashgrid_backward:two-pass window B", "composite_backward:two-pass window B",
)
# Flips of a style step's discrete choices, kernels against plain, allowed
# at most: about 4x the most of five poses measured on an H100 (class
# argmax 0, nearest style feature 5-14, VGG16 ReLU masks 3-7, max-pool
# picks of a window above 0 5-11; PERF.md §6).
STYLE_FLIP_BOUND = {"preds": 50, "nearest": 60, "relu": 40, "pool": 60}
K1_POINTS = 1 << 20
# The incremental renderer (incremental_phase): the main frame through
# RenderSettings(infer_two_phase=False), rounds of infer_round_size samples
# an alive ray: P0 gathers a round's rows, K1 and K5 evaluate them, K4i
# composites them with each ray's entering transmittance, K7 sums their
# channels; the two-stage march before.
INCREMENTAL_COUNTERS = ("composite_weights_entering", "take_rows", "hashgrid_encode",
                        "mlp_forward", "segment_sum", "march_skip_count", "march_skip_write")
# The style path's style image: a JPEG written by PIL and the array PIL
# decodes from it (the chip machine has no PIL: the port's decoder must give
# the same bits).
STYLE_JPEG = ROOT / "tests" / "data" / "style.jpg"
STYLE_JPEG_PIL = ROOT / "tests" / "data" / "style_jpg_pil.npy"
# A 1008x756 4:2:0 JPEG of the synthetic room (PIL, quality 90) and the
# SHA256 of PIL's decode of it: the port's decode time on the host.
ROOM_JPEG = ROOT / "tests" / "data" / "room_1008x756.jpg"
ROOM_JPEG_SHA256 = ROOT / "tests" / "data" / "room_1008x756_pil.sha256"
# The same frame re-encoded by PIL as a progressive JPEG (quality 90, 4:2:0)
# and PIL's decode's SHA256; a small CMYK JPEG (PIL, Adobe transform 0) and
# PIL's array of it.
ROOM_PROGRESSIVE = ROOT / "tests" / "data" / "room_1008x756_progressive.jpg"
ROOM_PROGRESSIVE_SHA256 = ROOT / "tests" / "data" / "room_1008x756_progressive_pil.sha256"
CMYK_JPEG = ROOT / "tests" / "data" / "cmyk_48x40.jpg"
CMYK_JPEG_PIL = ROOT / "tests" / "data" / "cmyk_48x40_pil.npy"
# library_api_phase: the style slots K1 and K1s are held at, and the dense
# stratified crop's samples a ray and its bounds against the two-phase
# frame's crop (written in PERF.md before the first run): the mean |rgb|
# and |opacity| differences over the crop, and the share of pixels whose
# rgb differs by more than 0.1.
LIBRARY_STYLES = (0, 1, 63, 511)
STRATIFIED_SAMPLES = 1024
STRATIFIED_BOUND = {"rgb mean": 0.02, "opacity mean": 0.02, "rgb > 0.1 share": 0.05}
# K2x against autograd through the plain encode (another order of sums):
# every entry within this share of the largest |d x|.
K2X_TOL = 1e-5
# The real-scene layouts (real_scene_phase): the synthetic room written as
# an LLFF layout at images_8's size (504x378; data config of
# cfgs/dataset/llff_room.yaml: bound 2.0, scale 0.33; cfgs/renderer/llff.yaml:
# flip_camera 3) and as one Replica trajectory at half of Semantic-NeRF's
# 640x480.  The LLFF run traces steps 284-291 (the random occupancy update
# of step 288 inside).
LLFF_DIMS, LLFF_VIEWS, LLFF_TEST_VIEWS, LLFF_STEPS = (504, 378), 32, 8, 300
LLFF_TRACE_START, LLFF_TRACE_STEPS, LLFF_STYLE_ITERS = 284, 8, 20
REPLICA_DIMS, REPLICA_VIEWS, REPLICA_STEPS = (320, 240), 48, 150
# The __global__ kernels of each train-path launch counter (csrc/*.cu).
TRAIN_GLOBALS = {
    "hashgrid_encode": ("hashgrid_encode_kernel",),
    "hashgrid_backward": ("hashgrid_backward_kernel",),
    "march_skip_count": ("march_kernel",), "march_skip_write": ("march_kernel",),
    "composite_weights": ("composite_weights_kernel",),
    "composite_backward": ("composite_backward_kernel",),
    "segment_sum": ("segment_sum_kernel",),
    "mlp_forward": ("mlp_forward_kernel", "mlp_forward_tc_kernel"),
    "mlp_backward": ("mlp_backward_kernel", "mlp_backward_tc_kernel"),
    "occupancy_scatter_max": ("scatter_max_kernel",),
    "occupancy_merge": ("merge_threshold_kernel",),
    "occupancy_skipdist": ("skipdist_kernel",),
}
# Grid sizes of K6c off the default 128: 256 (the timed row, a restore, a
# merge and a crop at it), one that is not a multiple of 16, 512 (z-lines
# in chunks of words), and a small one (one tile a cascade).
SKIPDIST_GRIDS = (256, 100, 512, 24)
# Rows of the timed K5 backward with every weight gradient (a train batch).
K5_DW_ROWS = 1 << 20
# Written before each cold launch (cold_ms): 2.5x the H100's 50 MB L2.
COLD_FLUSH_BYTES = 128 * 2**20
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


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps calls captured in one CUDA graph
    and replayed (CUDA events around the replay): the host's per-call work
    (Python, a wrapper's checks, the launch) stays outside the window.  For
    a kernel of a few microseconds that work is longer than the kernel, and
    cuda_ms then measures the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() launched with a cold L2: before each launch
    a buffer of COLD_FLUSH_BYTES (2.5x the H100's 50 MB L2) is written, so
    fn's inputs come from HBM and the L2 it finds holds dirty lines to
    write back; CUDA events bracket fn() alone.  A spin kernel holds the
    stream while the host enqueues every launch, so that no event waits on
    the host (the spin is doubled and the reps run again if it ended
    first).  Kernels whose working set fits in L2 read warm from a CUDA
    graph's replays (graph_ms); their share of an HBM bound is taken from
    this time."""
    flush = torch.empty((COLD_FLUSH_BYTES // 4,), device=DEVICE)
    fn()
    torch.cuda.synchronize()
    spin = 1 << 24
    for _ in range(6):
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(reps)]
        torch.cuda._sleep(spin)
        for i, (start, end) in enumerate(pairs):
            flush.fill_(float(i))
            start.record()
            fn()
            end.record()
        held = not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        if held:
            return sum(a.elapsed_time(b) for a, b in pairs) / reps
        spin *= 2
    raise RuntimeError("cold_ms: the host did not enqueue the launches within the spin")


def launch_floor() -> dict:
    """An empty kernel (one warp) from a CUDA graph and cold (cold_ms: the
    events' own floor), beside the rows of kernels of a few µs."""
    from nerfstyle_torch import kernels

    dev = torch.device(DEVICE)
    return {"empty_kernel_ms": graph_ms(lambda: kernels.empty_kernel(dev)),
            "empty_kernel_cold_ms": cold_ms(lambda: kernels.empty_kernel(dev))}


def cold_share(what: str, b_ms: float, c_ms: float, fails) -> float:
    """The bound's share of the cold time; above 1 the cold time is not a
    time the card could take, and the check fails."""
    share = b_ms / c_ms
    if not share <= 1.0:
        fails.append(f"{what}: bound {b_ms:.5f} ms is {share:.0%} of the cold time {c_ms:.5f}")
    return share


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


def touched_rows(spec, x: torch.Tensor, style: int = 0) -> int:
    """Distinct table rows the corners (or simplex vertices) of x read at a
    style slot: K1's least bytes."""
    from nerfstyle_torch.ops.hashgrid import _corners

    mask = torch.zeros(spec.total_params, dtype=torch.bool, device=x.device)
    inside = x[((x >= 0) & (x <= 1)).all(dim=-1)]
    for i in range(0, inside.shape[0], 1 << 18):
        corners, _ = _corners(spec, inside[i:i + (1 << 18)], style)
        for _, _, rows, _ in corners:
            mask[rows.reshape(-1)] = True
    return int(mask.sum())


# ---------------------------------------------------------------------------
# K1 and K2 by stream
#
# K1 (encode) and K2 (table gradient) run on several streams: a frame
# chunk's marched samples (phase A, density table) and kept samples (phase
# B, color table), a train batch's marched samples (phase A) and kept
# samples (phase B, the fused [T, 4] table), a style pose's cached samples
# (color table), and the occupancy updates' probes (density table).  Each
# has a row of its own in the kernel table, timed on that stream in the
# order the path hands it over, with the launches of that stream.  A
# launch's stream is read off the call stack at the launch (K1: the field
# function and the step that called it) or off its table width (K2: the
# train step's fused table is 4 wide, the style step's color table 2).
# The two-pass style scheme runs the train path's field and compositor
# (eval_composite, field_apply) on a pass-1 frame chunk and on each pass-2
# window: while StyleTrainer.render_frame or .window_grads runs
# (count_two_pass_streams), a launch falls in "two-pass frame" or
# "two-pass window", phase A or B as in the train step, ahead of every
# other stream (K2 and K4b launch from autograd's device thread, off the
# caller's stack).
# ---------------------------------------------------------------------------

# Stream -> the callers that mark it, looked for from the launch outwards.
ENCODE_STREAMS = (
    ("train B", ("field_apply",)),
    ("style", ("render_cache",)),
    ("frame B", ("field_color",)),
    ("probe full", ("occupancy_update_full",)),
    ("probe random", ("occupancy_update_random",)),
    ("train A", ("eval_composite",)),
    ("frame A", ("render_chunk", "_build_geom_cache")),
)
BACKWARD_STREAMS = {4: "train B", 2: "style"}
_stream_counts: dict = {}
_two_pass_phase: list = []  # the two-pass phase running, if any (count_two_pass_streams)


def count_two_pass_streams() -> None:
    """Wrap StyleTrainer's two passes so that the K1, K2, K4 and K4b
    launches inside them count under their two-pass streams."""
    import functools

    from nerfstyle_torch.training.style_trainer import StyleTrainer

    def wrap(fn, phase):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            _two_pass_phase.append(phase)
            try:
                return fn(*args, **kwargs)
            finally:
                _two_pass_phase.pop()
        return inner

    StyleTrainer.render_frame = wrap(StyleTrainer.render_frame, "two-pass frame")
    StyleTrainer.window_grads = wrap(StyleTrainer.window_grads, "two-pass window")


def _tally(name: str, stream: str, before: int) -> None:
    """Count a launch of kernel ``name`` under ``<name>:<stream>`` if its
    wrapper's own count moved past ``before``."""
    from nerfstyle_torch import kernels

    if kernels.launch_counts[name] > before:
        key = f"{name}:{stream}"
        _stream_counts[key] = _stream_counts.get(key, 0) + 1


def _encode_stream() -> str:
    names, f = set(), sys._getframe(2)
    while f is not None and len(names) < 40:
        names.add(f.f_code.co_name)
        f = f.f_back
    if _two_pass_phase:
        return f"{_two_pass_phase[-1]} {'B' if 'field_apply' in names else 'A'}"
    if "render_chunk_incremental" in names:
        return "incremental"
    for stream, callers in ENCODE_STREAMS:
        if any(c in names for c in callers):
            return stream
    return "other"


def count_hashgrid_streams() -> None:
    """Wrap the K1 and K2 wrappers so that each launch also counts under
    ``<kernel>:<stream>`` (read_counts); the wrappers' own counts are
    untouched."""
    from nerfstyle_torch import kernels

    enc, bwd = kernels.hashgrid_encode, kernels.hashgrid_backward

    def encode(x, table, levels, *style_term):
        before = kernels.launch_counts["hashgrid_encode"]
        out = enc(x, table, levels, *style_term)
        _tally("hashgrid_encode", _encode_stream(), before)
        return out

    def backward(x, g, levels, num_rows, *style_term):
        before = kernels.launch_counts["hashgrid_backward"]
        out = bwd(x, g, levels, num_rows, *style_term)
        c = g.shape[1] // levels.shape[1]
        stream = (f"{_two_pass_phase[-1]} B" if _two_pass_phase
                  else BACKWARD_STREAMS.get(c, "other"))
        _tally("hashgrid_backward", stream, before)
        return out

    kernels.hashgrid_encode, kernels.hashgrid_backward = encode, backward


# ---------------------------------------------------------------------------
# K4 and K4b by stream
#
# K4 (compositing weights) runs on a frame chunk's marched samples (phase A
# of render_chunk), a style pose's marched chunk (the cache build), a train
# batch's marched samples (phase A of eval_composite, which keeps only
# n_inc) and its kept prefix (phase B, inside CompositeRays.forward).  K4b
# (its backward) runs where that forward ran: the stream of a K4b launch is
# the stream of the K4 launch that wrote its w.  A single-phase train step
# (two_phase_train off) runs on no path; its launches would be "other".  The
# two-pass style scheme's launches go to its own streams (see
# count_two_pass_streams).
# ---------------------------------------------------------------------------

COMPOSITE_STREAMS = (
    ("style", "StyleTrainer._build_geom_cache"),
    ("train A", "eval_composite"),
    ("frame A", "render_chunk"),
)


def _composite_stream() -> str:
    frames, f = {}, sys._getframe(2)
    while f is not None and len(frames) < 40:
        frames.setdefault(f.f_code.co_qualname, f)
        f = f.f_back
    if _two_pass_phase:
        return f"{_two_pass_phase[-1]} {'B' if 'CompositeRays.forward' in frames else 'A'}"
    if "CompositeRays.forward" in frames:
        ev = frames.get("eval_composite")
        return "train B" if ev is not None and ev.f_locals.get("two_phase") else "other"
    for stream, caller in COMPOSITE_STREAMS:
        if caller in frames:
            return stream
    return "other"


def count_composite_streams() -> None:
    """Wrap the K4 and K4b wrappers so that each launch also counts under
    ``<kernel>:<stream>`` (read_counts); the wrappers' own counts are
    untouched."""
    from nerfstyle_torch import kernels

    fwd, bwd = kernels.composite_weights, kernels.composite_backward
    writer = {}  # w's data pointer -> the stream of the K4 launch that wrote it

    def weights(sigmas, tau, offsets, dt, t_thresh):
        before = kernels.launch_counts["composite_weights"]
        out = fwd(sigmas, tau, offsets, dt, t_thresh)
        stream = _composite_stream()
        writer[out[0].data_ptr()] = stream
        _tally("composite_weights", stream, before)
        return out

    def backward(sigmas, ch, tau, w, *rest):
        before = kernels.launch_counts["composite_backward"]
        out = bwd(sigmas, ch, tau, w, *rest)
        _tally("composite_backward", writer.get(w.data_ptr(), "other"), before)
        return out

    kernels.composite_weights, kernels.composite_backward = weights, backward


def reset_counts() -> None:
    from nerfstyle_torch import kernels

    kernels.reset_launch_counts()
    _stream_counts.clear()


def read_counts() -> dict:
    """Every wrapper's launches since reset_counts, and K1's and K2's by
    stream."""
    from nerfstyle_torch import kernels

    return {**kernels.launch_counts, **_stream_counts}


def k1_row(grid, table, x, what: str, fails, style: int = 0) -> dict:
    """K1 on the stream x (as the path hands it over) at style slot
    ``style`` against its plain version, bit for bit (the same rounding);
    both timed (the kernel from a CUDA graph); its bound from the distinct
    rows read.  Returns the kernel-table entry."""
    from nerfstyle_torch.ops import hashgrid

    kid = "K1s" if grid.simplex_start < grid.num_levels else "K1"
    if style:
        kid, what = f"{kid} (style {style})", f"{what} at style {style}"
    enc = hashgrid.hashgrid_encode(grid, table, x, style=style)
    ref = hashgrid.hashgrid_encode(grid, table, x, style=style, plain=True)
    err = float((enc - ref).abs().max()) if x.shape[0] else 0.0
    if not torch.equal(enc, ref):
        fails.append(f"{kid} encode at {what} differs from its plain version (max abs err {err})")
    del enc, ref
    # From a CUDA graph: at a train batch's or a kept stream's size the
    # host's work a call outlasts the kernel.
    ms = graph_ms(lambda: hashgrid.hashgrid_encode(grid, table, x, style=style))
    plain_ms = cuda_ms(lambda: hashgrid.hashgrid_encode(grid, table, x, style=style, plain=True),
                       reps=3, warmup=1)
    n, c, rows = x.shape[0], table.shape[1], touched_rows(grid, x, style)
    lc, nl = grid.simplex_start, grid.num_levels
    corners = 8 * lc + 4 * (nl - lc)
    # Bytes: points, the distinct rows read, the features written once.
    # Operations: per corner or vertex the weight's few and 2C for the sum.
    b_ms, b_by = bound_ms(nbytes=n * 12 + rows * c * 4 + n * nl * c * 4,
                          flops=n * corners * (3 + 2 * c))
    log(f"{kid} hashgrid_encode at {what}: {n} points x {nl} levels (C={c}), {rows} distinct rows "
        f"read ({n * corners / max(rows, 1):.1f} corner reads a row); bit-equal to plain: "
        f"{err == 0.0}; ms {ms:.4f}, plain_ms {plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def k2_row(grid, x, c: int, what: str, gen, fails, style: int = 0) -> dict:
    """K2 on the stream x for a random cotangent, against the plain version's
    float64 sums: its fp32 atomics add in an order that varies from run to
    run, up to ~10^5 contributions a row on the coarse levels: each level's
    rows within 1e-4 of the level's largest on simplex grids (K2s: a coarse
    trilinear row sums hundreds of contributions, a fine simplex row a few,
    so one tolerance for the whole table would not see an error on the
    simplex levels), and within 1e-4 of the largest row on trilinear ones.
    Timed (from a CUDA graph, as its ``index_add_`` of the same
    contributions; the plain version launch by launch).  Returns the
    kernel-table entry."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.ops import hashgrid

    n, nl, rows = x.shape[0], grid.num_levels, grid.total_params
    lc = grid.simplex_start
    kid = "K2s" if lc < nl else "K2"
    if style:
        kid, what = f"{kid} (style {style})", f"{what} at style {style}"
    lv, term = hashgrid.level_table(grid, x.device), hashgrid.style_term(style)
    cot = torch.randn((n, nl * c), generator=gen, device=x.device)
    got = kernels.hashgrid_backward(x, cot, lv, rows, term)
    ref = hashgrid.hashgrid_backward_plain(grid, x, cot.double(), rows, style)
    diff = (got.double() - ref).abs()
    err = float(diff.max())
    spans = ([(grid.offsets[i], grid.offsets[i + 1]) for i in range(nl)] if kid == "K2s"
             else [(0, rows)])
    worst = 0.0  # the largest error of a level (K2: of the table) over its tolerance
    for a, b in spans:
        span_err, span_tol = float(diff[a:b].max()), 1e-4 * float(ref[a:b].abs().max())
        worst = max(worst, span_err / max(span_tol, 1e-30))
        if not span_err <= span_tol:
            fails.append(f"{kid} table gradient at {what}: error {span_err} > {span_tol} on rows "
                         f"{a}-{b}")
    del got, ref, diff
    ms = graph_ms(lambda: kernels.hashgrid_backward(x, cot, lv, rows, term))
    plain_ms = cuda_ms(lambda: hashgrid.hashgrid_backward_plain(grid, x, cot, rows, style),
                       reps=3, warmup=1)
    corners, oob = hashgrid._corners(grid, x, style)
    g3 = torch.where(oob[:, None, None], 0.0, cot.reshape(n, nl, c))
    flat_rows = torch.cat([r.reshape(-1) for _, _, r, _ in corners])
    vals = torch.cat([(w[..., None] * g3[:, a:b]).reshape(-1, c) for a, b, _, w in corners])
    del corners, g3
    acc = torch.zeros((rows, c), device=x.device)
    lib_ms = graph_ms(lambda: acc.zero_().index_add_(0, flat_rows, vals))
    del flat_rows, vals, acc
    per_point = 8 * lc + 4 * (nl - lc)
    # Bytes: points, cotangent, the [T, C] gradient written once.
    # Operations: per (point, level, corner or vertex) the weight's few and
    # 2C for w * g and the add.
    b_ms, b_by = bound_ms(nbytes=n * 12 + n * nl * c * 4 + rows * c * 4,
                          flops=n * per_point * (5 + 2 * c))
    log(f"{kid} hashgrid_backward at {what}: {n} points x {nl} levels ({per_point} corners and "
        f"vertices a point) into [{rows}, {c}]; max_abs_err {err:.3e}, worst "
        f"{'level' if kid == 'K2s' else 'table'} at {worst:.3f} of its tolerance; ms {ms:.4f}, "
        f"plain_ms {plain_ms:.3f}, index_add_ ms {lib_ms:.4f}, bound_ms {b_ms:.4f} ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def ray_stats(offsets: torch.Tensor, n_inc: torch.Tensor) -> str:
    """A stream's shape as a warp a ray sees it: samples and included
    samples a ray, and the 32-sample chunks the rays span."""
    lens = (offsets[1:] - offsets[:-1]).double()
    inc = n_inc.double()
    chunks = int(torch.ceil(lens / 32).sum())
    return (f"{lens.shape[0]} rays, samples/ray mean {float(lens.mean()):.2f} max "
            f"{int(lens.max())}, empty {float((lens == 0).double().mean()):.3f}, <= 32 "
            f"{float((lens <= 32).double().mean()):.3f}; n_inc mean {float(inc.mean()):.2f} max "
            f"{int(inc.max())}, <= 32 {float((inc <= 32).double().mean()):.3f}; {chunks} "
            f"32-sample chunks")


def ray_length_stats(offsets: torch.Tensor) -> str:
    """Samples a ray of a stream: mean, max and the share of empty rays."""
    lens = (offsets[1:] - offsets[:-1]).double()
    return (f"samples/ray mean {float(lens.mean()):.2f} max {int(lens.max())}, empty "
            f"{float((lens == 0).double().mean()):.3f}")


def k4_row(sig, tau, offsets, dt: float, t_thresh: float, what: str, fails,
           same_last_weight: bool = False):
    """K4 on the stream (sig, tau, offsets) as the path hands it over
    (densities with density_scale applied) against its plain version;
    timed from a CUDA graph of the kernel call alone (and launch by launch,
    logged).  Returns the kernel-table entry and the kernel's w.

    A ray stops where its entering T falls below t_thresh: the kernel's
    n_inc must be the plain version's.  ``same_last_weight`` (the frame
    chunk's check) also asks for the same last nonzero weight:
    that is the stop wherever no included sample has a density so low that
    its fp32 alpha, 1 - e^-sdt, rounds to 0 (a trained field's samples can;
    the frame's seeded densities, ~e^6, cannot)."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.ops import compositing

    n, m = offsets.shape[0] - 1, sig.shape[0]
    # The reference is the plain version on the same inputs in float64
    # (exact).  Every ray must stop at the same sample as the reference,
    # except an edge ray: one with a sample whose exact entering T lies
    # within 1e-4 relative of t_thresh, where the kernel's fp32 optical depth
    # (~5e-7 rounding an addition near ln 1e4) may decide the other way.
    # Other rays agree to fp32 rounding: atol 2e-6 on w and weights_sum,
    # 2e-6 * max(tau) on depth; an edge ray may gain or lose one weight
    # below t_thresh: atol 1e-4, 1e-4 * max(tau).
    w, ws, dep, n_inc = compositing.sample_weights(sig, tau, offsets, dt, t_thresh)
    w64, ws64, dep64, n_inc64 = compositing.sample_weights(sig.double(), tau.double(), offsets,
                                                           dt, t_thresh, plain=True)
    _, trans64 = compositing.entering_transmittance_plain(sig.double(), offsets, dt)
    near = (trans64 - t_thresh).abs() <= 1e-4 * t_thresh
    edge = compositing.segment_totals_plain(near.double(), offsets) > 0
    cut_k = compositing.weight_cutoffs(w, offsets)
    cut_p = compositing.weight_cutoffs(w64, offsets)
    other = ((n_inc != n_inc64) | ((cut_k != cut_p) if same_last_weight else False)) & ~edge
    bad_cuts = int(other.sum())
    moved = torch.nonzero((cut_k != cut_p) & ~edge).squeeze(1)[:4].tolist()
    if moved:
        log(f"K4 at {what}: rays {moved} end their nonzero weights elsewhere than the float64 "
            f"plain version: n_inc {n_inc[moved].tolist()} vs {n_inc64[moved].tolist()}, last "
            f"nonzero weight at {cut_k[moved].tolist()} vs {cut_p[moved].tolist()} (float64 "
            f"weight there {[float(w64[offsets[r] + cut_p[r] - 1]) for r in moved]})")
    on_edge = edge[compositing.ray_ids(offsets)]
    tau_max = float(tau.max()) if m else 0.0
    errs, tols = [], []
    for mask_s, mask_r, tight in ((~on_edge, ~edge, 2e-6), (on_edge, edge, 1e-4)):
        errs += [float((a.double() - b)[mk].abs().max()) if bool(mk.any()) else 0.0
                 for a, b, mk in ((w, w64, mask_s), (ws, ws64, mask_r), (dep, dep64, mask_r))]
        tols += [tight, tight, tight * tau_max]
    if bad_cuts or not all(e <= t for e, t in zip(errs, tols)):
        fails.append(f"K4 at {what}: {bad_cuts} rays stop at another sample than the plain "
                     f"version; errors w/ws/depth (inner rays, then edge rays) {errs} vs {tols}")
    # From a CUDA graph: the wrapper's checks and allocations stay outside
    # the window.  Launch by launch (host work included), logged beside.
    ms = graph_ms(lambda: kernels.composite_weights(sig, tau, offsets, dt, t_thresh))
    host_ms = cuda_ms(lambda: kernels.composite_weights(sig, tau, offsets, dt, t_thresh),
                      reps=20)
    plain_ms = cuda_ms(lambda: compositing.sample_weights(sig, tau, offsets, dt, t_thresh,
                                                          plain=True), reps=5)
    # Bytes: offsets, sigma and tau of the samples in front of each ray's
    # cutoff (entering T >= t_thresh: the rest are never read), w of every
    # sample, weights_sum and depth.  About 8 operations a read sample.
    n_read = int((trans64 >= t_thresh).sum())
    b_ms, b_by = bound_ms(nbytes=(n + 1) * 8 + n_read * 8 + m * 4 + n * 8, flops=n_read * 8)
    log(f"K4 composite_weights at {what}: {m} samples, {n_read} in front of the cutoffs, "
        f"{int(edge.sum())} edge rays, {bad_cuts} other rays stopping elsewhere; "
        f"{ray_stats(offsets, n_inc)}; max_abs_err w/ws/depth inner, edge {errs} (tol {tols}); "
        f"ms {ms:.4f} (graph; {host_ms:.4f} launched one by one), plain_ms {plain_ms:.3f}, "
        f"bound_ms {b_ms:.4f} ({b_by})")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None), w


def probe_streams(renderer, table_dev):
    """Encoder inputs of one probe chunk of each occupancy update, as the
    updates hand them over: the middle PROBE_CHUNK of cascade 0's full sweep
    (cells in linear order, jittered) and the first of cascade 0's random
    update (uniformly drawn cells)."""
    from nerfstyle_torch.models.fields import _encoder_input
    from nerfstyle_torch.ops import occupancy

    plan, bbox = renderer.plan, renderer.bbox
    h, k = plan.grid_size, occupancy.PROBE_CHUNK
    gen = torch.Generator(device=table_dev).manual_seed(13)
    mid = (h**3 // k) // 2
    coords = occupancy.all_cell_coords(h, table_dev)[mid * k: (mid + 1) * k]
    full = occupancy.cells_to_cascade_points(coords, 0, h, plan.bound, generator=gen)
    idx = torch.randint(0, h**3, (k,), generator=gen, device=table_dev)
    coords = torch.stack([idx // (h * h), (idx // h) % h, idx % h], dim=-1)
    rand = occupancy.cells_to_cascade_points(coords, 0, h, plan.bound, generator=gen)
    return (_encoder_input(bbox, full).contiguous(), _encoder_input(bbox, rand).contiguous())


def march_phase(plan, state, o, d, fails, what: str):
    """The two-stage march (K3s) against its plain version and against the
    dense march (K3), and K3 against its plain version, on rays (o, d) over
    the occupancy ``state``; both kernels timed.  Returns their kernel-table
    entries and the sample and candidate counts."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.ops import marching
    from nerfstyle_torch.ops.aabb import near_far_from_aabb

    n = o.shape[0]
    nears, fars = near_far_from_aabb(o, d, plan.aabb(o.device), plan.min_near)
    nears, fars = nears.contiguous(), fars.contiguous()
    bits, skip = state.bitfield, state.skipdist
    occ = marching.OccField(bits, skip)
    two = marching.march_rays(plan, occ, o, d, nears, fars)
    two_ref = marching.march_rays(plan, occ, o, d, nears, fars, plain=True)
    dense = marching.march_rays(plan, bits, o, d, nears, fars)
    dense_ref = marching.march_rays(plan, bits, o, d, nears, fars, plain=True)
    fields = ("ray_id", "step", "offsets", "xyz", "dirs", "tau")

    def same(a, b):
        return a.num_kept == b.num_kept and all(torch.equal(getattr(a, f), getattr(b, f))
                                                for f in fields)

    def xyz_err(a, b):
        return float((a.xyz - b.xyz).abs().max()) if a.num_kept == b.num_kept else float("inf")

    # Exact: same lattice, same rounding, same order.
    checks = {"K3 against its plain version": same(dense, dense_ref),
              "K3s against its plain version": same(two, two_ref)
              and two.num_cand == two_ref.num_cand,
              "K3s against K3": same(two, dense)}
    for k, ok in checks.items():
        if not ok:
            fails.append(f"{k} differs at {what} (num_kept K3s {two.num_kept}, plain "
                         f"{two_ref.num_kept}, K3 {dense.num_kept}, K3 plain "
                         f"{dense_ref.num_kept}; num_cand {two.num_cand} vs {two_ref.num_cand})")
    # Each kernel's time is its two passes' device time, each pass timed on
    # its own so that the host synchronisation between them (to size the
    # outputs) is outside the timed window.
    m = two.num_kept
    geom = dict(dt=plan.dt, bound=plan.bound, t_lattice=plan.t_lattice, cascade=plan.cascade,
                grid_size=plan.grid_size, mip_dt_level=plan.mip_dt_level,
                max_steps=plan.max_steps)
    rays = (o, d, nears, fars, bits)
    sk = (skip, marching.level_cells(plan, o.device), marching.WINDOW,
          marching.window_reach(plan))
    k3 = (cuda_ms(lambda: kernels.march_count(*rays, **geom), reps=10),
          cuda_ms(lambda: kernels.march_write(*rays, dense.offsets, m, **geom), reps=10))
    k3s = (cuda_ms(lambda: kernels.march_count(*rays, sk, **geom), reps=10),
           cuda_ms(lambda: kernels.march_write(*rays, two.offsets, m, sk, **geom), reps=10))
    plain = cuda_ms(lambda: marching.march_rays(plan, bits, o, d, nears, fars, plain=True),
                    reps=2, warmup=1)
    plain_s = cuda_ms(lambda: marching.march_rays(plan, occ, o, d, nears, fars, plain=True),
                      reps=2, warmup=1)
    # Inputs: rays (o, d, near, far) and the occupancy read once (the
    # bitfield; K3s also the skip distance); outputs: 36 bytes a kept sample
    # and the offsets.  The function's operations: 8 for each kept sample
    # (o + d*t, tau): the lattice points of empty space need not be visited.
    out_bytes = n * 32 + m * 36 + (n + 1) * 8
    b3 = bound_ms(nbytes=out_bytes + bits.numel(), flops=8 * m)
    b3s = bound_ms(nbytes=out_bytes + bits.numel() + skip.numel(), flops=8 * m)
    table = {
        "K3": dict(max_abs_err=xyz_err(dense, dense_ref), ms=sum(k3), plain_ms=plain,
                   bound_ms=b3[0], bound_by=b3[1], library_ms=None),
        "K3s": dict(max_abs_err=max(xyz_err(two, two_ref), xyz_err(two, dense)), ms=sum(k3s),
                    plain_ms=plain_s, bound_ms=b3s[0], bound_by=b3s[1], library_ms=None),
    }
    windows = n * -(-plan.t_lattice // marching.WINDOW)
    log(f"march at {what}: {n} rays -> {m} samples ({m / n:.2f}/ray); two-stage candidates "
        f"{two.num_cand} of {windows} windows ({two.num_cand / windows:.4f}); "
        f"{ {k: bool(v) for k, v in checks.items()} }; K3 ms {sum(k3):.4f} (count "
        f"{k3[0]:.4f} + write {k3[1]:.4f}), plain_ms {plain:.3f}, bound_ms {b3[0]:.4f} "
        f"({b3[1]}); K3s ms {sum(k3s):.4f} (count {k3s[0]:.4f} + write {k3s[1]:.4f}), plain_ms "
        f"{plain_s:.3f}, bound_ms {b3s[0]:.4f} ({b3s[1]})")
    return table, {"samples": m, "num_cand": two.num_cand, "windows": windows}


def kernel_phases(renderer, params, rays_o, rays_d):
    """K6c on the checkpoint's grid; K3, K3s, K4, K1 and K1s (phase A's and
    phase B's streams), K7 on a 2^16-ray chunk of the frame; K1 and K1s on
    the occupancy updates' probe chunks; returns the kernel table (without
    launches) and a list of failures."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.models.fields import _encoder_input, field_color, field_density
    from nerfstyle_torch.ops import compositing, marching, occupancy
    from nerfstyle_torch.ops.aabb import near_far_from_aabb
    from nerfstyle_torch.render.renderer import CHUNK_RAYS, FIELD_BATCH

    fails, table = [], {}
    plan, spec, bbox = renderer.plan, renderer.field_spec, renderer.bbox
    n = rays_o.shape[0]
    mid = n // 2
    o = rays_o[mid - CHUNK_RAYS // 2: mid + CHUNK_RAYS // 2].contiguous()
    d = rays_d[mid - CHUNK_RAYS // 2: mid + CHUNK_RAYS // 2].contiguous()
    state = renderer.occ_state
    nears, fars = near_far_from_aabb(o, d, plan.aabb(o.device), plan.min_near)

    # K6c: the skip distance of the checkpoint's grid (2 x 128^3), and of a
    # sparse random grid (distances up to the cap).  Integer arithmetic:
    # equal to the plain version.  Each grid timed from a CUDA graph of the
    # kernel call alone (launch by launch logged beside); the row is the
    # checkpoint's grid.
    h = plan.grid_size
    sparse = torch.rand(state.bitfield.shape, generator=torch.Generator().manual_seed(3)) < 2e-4
    for label, bits in (("checkpoint", state.bitfield), ("random 0.02%", sparse.to(DEVICE))):
        got = occupancy.skipdist_from_bitfield(bits, h)
        ref = occupancy.skipdist_from_bitfield(bits, h, plain=True)
        again = occupancy.skipdist_from_bitfield(bits, h)
        if not (torch.equal(got, ref) and torch.equal(got, again)):
            fails.append(f"K6c skip distance differs from plain or between two launches "
                         f"({label} grid)")
        ms = graph_ms(lambda: kernels.occupancy_skipdist(bits, h, occupancy.SKIP_DMAX))
        c_ms = cold_ms(lambda: kernels.occupancy_skipdist(bits, h, occupancy.SKIP_DMAX))
        host_ms = cuda_ms(lambda: kernels.occupancy_skipdist(bits, h, occupancy.SKIP_DMAX),
                          reps=20)
        plain_ms = cuda_ms(lambda: occupancy.skipdist_from_bitfield(bits, h, plain=True), reps=3)
        # Bytes: the bitfield in, the distances out.  Operations: the
        # function's least, about 6 integer operations a cell.
        b_ms, b_by = bound_ms(nbytes=2 * bits.numel(), flops=6 * bits.numel())
        log(f"K6c skipdist ({label} grid, {int(bits.sum())} occupied of {bits.numel()}): equal "
            f"to plain: {torch.equal(got, ref)}, two launches equal: {torch.equal(got, again)}; "
            f"distance histogram {torch.bincount(got.long(), minlength=16).tolist()}; ms "
            f"{ms:.4f} (graph; cold {c_ms:.4f}; {host_ms:.4f} launched one by one; "
            f"{kernels.SKIPDIST_LAUNCHES} launches a call; tile "
            f"{kernels.skipdist_plan(h, bits.numel() // h**3, occupancy.SKIP_DMAX)}), "
            f"plain_ms {plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by})")
        if label == "checkpoint":
            table["K6c"] = dict(max_abs_err=float((got.int() - ref.int()).abs().max()), ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # K3 and K3s on the chunk.
    march_table, _ = march_phase(plan, state, o, d, fails, "the frame chunk")
    table.update(march_table)
    sb = marching.march_rays(plan, renderer.occ_field, o, d, nears, fars)
    m = sb.num_kept

    # K4: weights on the chunk's stream with the path's densities.
    s = renderer.settings
    sig = field_density(spec, params, bbox, sb.xyz, renderer.compute_dtype) * s.density_scale
    table["K4 frame A"], w = k4_row(sig, sb.tau, sb.offsets, plan.dt, s.t_thresh,
                                    "a frame chunk's marched samples (phase A)", fails,
                                    same_last_weight=True)

    keep = w > s.sig_eps
    idx = torch.nonzero(keep).squeeze(1)

    # K1 and K1s on the frame's streams, in march order: phase A encodes
    # the chunk's marched samples with the density table, FIELD_BATCH a
    # launch (the chunk's first launch), phase B the kept ones with the
    # color table; and on a probe chunk of each occupancy update (density
    # table).  K1s: the same streams with simplex levels
    # from SIMPLEX_FROM (the simplex run's own checkpoint has other weights;
    # the streams are of the same kind).
    grid_s = dataclasses.replace(spec.grid, simplex_from=SIMPLEX_FROM)
    dens, color = params["x_density_embedder"], params["x_color_embedder"]
    x_a = _encoder_input(bbox, sb.xyz[:FIELD_BATCH]).contiguous()
    x_b = _encoder_input(bbox, sb.xyz[idx]).contiguous()
    full, rand = probe_streams(renderer, x_a.device)
    for grid, kid in ((spec.grid, "K1"), (grid_s, "K1s")):
        table[f"{kid} frame A"] = k1_row(grid, dens, x_a, "a frame chunk's marched samples "
                                         "(phase A, density)", fails)
        table[f"{kid} frame B"] = k1_row(grid, color, x_b, "a frame chunk's kept samples "
                                         "(phase B, color)", fails)
        table[f"{kid} probe full"] = k1_row(grid, dens, full, "a full sweep's probe chunk", fails)
    table["K1 probe random"] = k1_row(spec.grid, dens, rand, "a random update's probe chunk",
                                      fails)
    # The yardstick of earlier tables, no longer a row: 2^20 random picks
    # from the chunk's stream, K1 and K1s on the density table, K2s on the
    # fused tables' width.
    pick = torch.randint(0, m, (K1_POINTS,), generator=torch.Generator().manual_seed(1))
    x = _encoder_input(bbox, sb.xyz[pick.to(sb.xyz.device)]).contiguous()
    bridge = {"K1": k1_row(spec.grid, dens, x, "2^20 random picks", fails),
              "K1s": k1_row(grid_s, dens, x, "2^20 random picks", fails),
              "K2s": k2_row(grid_s, x, 2 * spec.grid.level_dim, "2^20 random picks",
                            torch.Generator(device=x.device).manual_seed(2), fails)}
    log("at 2^20 random picks of the chunk's stream (the earlier tables' shape): " + ", ".join(
        f"{k} ms {v['ms']:.4f} (bound {v['bound_ms']:.4f})" for k, v in bridge.items()))
    del x, x_a, x_b, full, rand

    # K7: phase B's channel sum over the significant samples.  Reference:
    # the plain version (float64 sums); the kernel sums in fp32 in stream
    # order: tolerance 1e-5 of the largest output.
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
    # Device times from a CUDA graph of 20 launches (the host's per-call work
    # is longer than either call); the host-bound rates beside them.
    ms = graph_ms(lambda: compositing.segment_sum(w_sig, ch, sig_off))
    host_ms = cuda_ms(lambda: compositing.segment_sum(w_sig, ch, sig_off), reps=20)
    plain_ms = cuda_ms(lambda: compositing.segment_sum(w_sig, ch, sig_off, plain=True), reps=5)
    rid = compositing.ray_ids(sig_off)
    src = w_sig[:, None] * ch
    acc = torch.zeros(CHUNK_RAYS, ch.shape[1], device=w.device)
    lib_ms = graph_ms(lambda: acc.zero_().index_add_(0, rid, src))
    lib_host_ms = cuda_ms(lambda: acc.zero_().index_add_(0, rid, src), reps=20)
    nsig, cc = idx.shape[0], ch.shape[1]
    b_ms, b_by = bound_ms(nbytes=nsig * 4 * (1 + cc) + (CHUNK_RAYS + 1) * 8 + CHUNK_RAYS * cc * 4,
                          flops=2 * nsig * cc)
    # The same stream with rays longer than one staged tile of K7 (at most
    # 1024 samples a piece) in front, empty rays among them: rays of 5000,
    # 0 and 3 samples, then the chunk's own rays.  The 5000-sample ray must
    # equal a sequential fp32 sum in stream order (np.add.accumulate, each
    # product and sum rounded on its own) bit for bit (against float64 sums
    # its fp32 rounding grows with its length); every other ray is held to
    # the plain version as above.
    lead = torch.tensor([0, 0, 5000, 5000, 5003], dtype=torch.int64, device=w.device)
    long_off = torch.cat([lead, sig_off[sig_off > 5003]])
    got = compositing.segment_sum(w_sig, ch, long_off)
    want = compositing.segment_sum(w_sig, ch, long_off, plain=True)
    others = torch.arange(got.shape[0], device=w.device) != 1
    long_err = float((got - want)[others].abs().max())
    long_tol = 1e-5 * float(want[others].abs().max()) + 1e-6
    seq = np.add.accumulate((w_sig[:5000, None] * ch[:5000]).cpu().numpy(), axis=0,
                            dtype=np.float32)[-1]
    long_exact = bool(np.array_equal(got[1].cpu().numpy(), seq))
    if not (long_err <= long_tol and long_exact):
        fails.append(f"K7 segment sum on long rays: error {long_err} (tol {long_tol}); the "
                     f"5000-sample ray equal to the sequential fp32 sum: {long_exact}")
    table["K7"] = dict(max_abs_err=max(err, long_err), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms)
    log(f"K7 segment_sum: {nsig} significant samples x {cc} channels; max_abs_err {err:.3e} "
        f"(tol {tol:.3e}); with rays of 5000, 0, 3 samples in front: max_abs_err "
        f"{long_err:.3e} (tol {long_tol:.3e}), the 5000-sample ray equal to the sequential fp32 "
        f"sum: {long_exact}; ms {ms:.4f} (graph; {host_ms:.4f} launched one by one), plain_ms "
        f"{plain_ms:.3f}, index_add_ ms {lib_ms:.4f} (graph; {lib_host_ms:.4f} one by one), "
        f"bound_ms {b_ms:.4f} ({b_by})")
    return table, fails


# ---------------------------------------------------------------------------
# The train path
# ---------------------------------------------------------------------------


def skipdist_sizes_phase(renderer, params, rays_o, rays_d, fails) -> dict:
    """K6c at grid sizes off the default (128), reached through
    ``ops.occupancy.skipdist_from_bitfield``: equal to the plain version bit
    for bit and between two calls, one launch a call, at 2 x 256^3 (the
    scene's spheres and a sparse random grid), 2 x 100^3, 2 x 512^3 and 1 x
    24^3, each timed from a CUDA graph of the call alone and cold; an
    occupancy restore and merge at grid 256 launch it and not the plain
    version; and a 4096-ray crop (the frame's central 64x64 pixels)
    rendered at grid 256, where K3s forms its window reach from a finer
    cell, equal to the plain path within the main crop's tolerances.
    Returns the table entry (2 x 256^3, the spheres)."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.data.synthetic import _SPHERES
    from nerfstyle_torch.ops import occupancy
    from nerfstyle_torch.render.renderer import Renderer

    dev = torch.device(DEVICE)
    cascade, bound = renderer.cascade, renderer.bound
    big, odd, huge, small = SKIPDIST_GRIDS
    spheres = torch.from_numpy(sphere_bitfield(cascade, big, bound, _SPHERES)).to(dev)

    def sparse(h: int, cas: int, density: float) -> torch.Tensor:
        gen = torch.Generator().manual_seed(h)
        return (torch.rand(cas * h**3, generator=gen) < density).to(dev)

    cases = {f"{cascade} x {big}^3, the spheres": (spheres, big),
             f"2 x {big}^3, random 0.02%": (sparse(big, 2, 2e-4), big),
             f"2 x {odd}^3, random 0.02%": (sparse(odd, 2, 2e-4), odd),
             f"2 x {huge}^3, random 0.02%": (sparse(huge, 2, 2e-4), huge),
             f"1 x {small}^3, random 0.1%": (sparse(small, 1, 1e-3), small)}
    entry = None
    for label, (bits, h) in cases.items():
        reset_counts()
        got = occupancy.skipdist_from_bitfield(bits, h)
        again = occupancy.skipdist_from_bitfield(bits, h)
        torch.cuda.synchronize()
        counts = read_counts()
        ref = occupancy.skipdist_from_bitfield(bits, h, plain=True)
        if not (torch.equal(got, ref) and torch.equal(got, again)
                and counts["occupancy_skipdist"] == 2 * kernels.SKIPDIST_LAUNCHES):
            fails.append(f"K6c ({label}): equal to plain {torch.equal(got, ref)}, two calls "
                         f"equal {torch.equal(got, again)}, {counts['occupancy_skipdist']} "
                         "launches for two calls")
        ms = graph_ms(lambda: kernels.occupancy_skipdist(bits, h, occupancy.SKIP_DMAX))
        c_ms = cold_ms(lambda: kernels.occupancy_skipdist(bits, h, occupancy.SKIP_DMAX))
        plain_ms = cuda_ms(lambda: occupancy.skipdist_plain(bits, h), reps=3)
        # Bytes: the bitfield in, the distances out (as the grid-128 row).
        b_ms, b_by = bound_ms(nbytes=2 * bits.numel(), flops=6 * bits.numel())
        log(f"K6c skipdist ({label}, {int(bits.sum())} occupied): equal to plain: "
            f"{torch.equal(got, ref)}, two calls equal: {torch.equal(got, again)}; distance "
            f"histogram {torch.bincount(got.long(), minlength=16).tolist()}; ms {ms:.4f} (graph; "
            f"cold {c_ms:.4f}; {kernels.SKIPDIST_LAUNCHES} launch a call; tile "
            f"{kernels.skipdist_plan(h, bits.numel() // h**3, occupancy.SKIP_DMAX)}), "
            f"plain_ms {plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by})")
        if entry is None:
            entry = dict(max_abs_err=float((got.int() - ref.int()).abs().max()), ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del got, again, ref
    del cases
    torch.cuda.empty_cache()

    # A restore and a merge at grid 256 through ops/occupancy.py: K6c,
    # never the plain version.
    persisted = occupancy.PersistedOccupancy(
        spheres.float().reshape(cascade, -1).cpu(), spheres.cpu(),
        torch.tensor(float(spheres.float().mean())), torch.tensor(0, dtype=torch.int32),
        torch.tensor(0, dtype=torch.int32))
    plain_calls = []
    skipdist_plain = occupancy.skipdist_plain

    def counted_plain(*args, **kwargs):
        plain_calls.append(1)
        return skipdist_plain(*args, **kwargs)

    occupancy.skipdist_plain = counted_plain
    try:
        reset_counts()
        state = occupancy.occupancy_restore(persisted, big, dev)
        merged = occupancy.merge_and_threshold(state, torch.full_like(state.density_grid, -1.0),
                                               renderer.settings.density_decay,
                                               renderer.settings.density_thresh, grid_size=big)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        occupancy.skipdist_plain = skipdist_plain
    exact = all(torch.equal(st.skipdist, skipdist_plain(st.bitfield, big))
                for st in (state, merged))
    if plain_calls or not exact or (
            counts["occupancy_skipdist"] != 2 * kernels.SKIPDIST_LAUNCHES):
        fails.append(f"the grid-{big} restore and merge: plain calls {len(plain_calls)}, K6c "
                     f"launches {counts['occupancy_skipdist']}, equal to plain {exact}")
    del state, merged

    # A crop rendered at the large grid: K3s over K6c's distances.
    r_big = Renderer(renderer.field_spec, renderer.bbox,
                     dataclasses.replace(renderer.settings, grid_size=big), renderer.intr, bound,
                     raymarch_channels=renderer.raymarch_channels,
                     compute_dtype=renderer.compute_dtype, device=DEVICE)
    reset_counts()
    r_big.restore_occupancy(persisted)
    w, h = OUT_DIMS
    ys, xs = np.meshgrid(np.arange(h // 2 - 32, h // 2 + 32), np.arange(w // 2 - 32, w // 2 + 32),
                         indexing="ij")
    crop = torch.from_numpy((ys * w + xs).reshape(-1)).to(dev)
    with torch.no_grad():
        got = r_big.render_rays(params, rays_o[crop], rays_d[crop])
        torch.cuda.synchronize()
        counts = read_counts()
        ref = r_big.render_rays(params, rays_o[crop], rays_d[crop], plain=True)
    tol = {"rgb_map": 2e-3, "trans_map": 2e-3, "weights_sum": 2e-3, "classes": 2e-2}
    err = {k: float((got[k] - ref[k]).abs().max()) for k in tol}
    if not (all(err[k] <= tol[k] for k in tol) and got["num_marched"] == ref["num_marched"]
            and counts["march_skip_count"] > 0 and counts["occupancy_skipdist"] > 0):
        fails.append(f"the grid-{big} crop: max abs err {err} (tol {tol}), samples "
                     f"{got['num_marched']} vs {ref['num_marched']}, launches {counts}")
    log(f"grid {big}: restore + merge launched K6c, no plain version; a 4096-ray crop "
        f"({counts['occupancy_skipdist']} K6c launches at its restore): samples "
        f"{got['num_marched']} (plain {ref['num_marched']}), candidate windows "
        f"{got['num_cand']}, max abs err against plain {err} (tol {tol})")
    del r_big
    torch.cuda.empty_cache()
    return entry


def class_head_phase(renderer, params, fails) -> None:
    """Class heads off the default width, on the card, against their plain
    versions.  Width 0 (a dataset without segment maps): ``field_apply`` and
    ``field_color`` of the checkpoint's field with an empty class head,
    forward within K5's tolerance and each parameter's gradient within 5e-3
    relative L2 (the train step's tolerance), the class head launching
    nothing.  Width 70: the class head (K5 twice, 64 + 6 columns) forward and
    backward with every d W within K5's tolerance (mlp_check), and K7 and K7b
    at 3 + 70 channels (two launches each): K7 against the float64 sums
    (rtol 1e-5, atol 1e-6 of the largest), K7b's d ch equal to the plain
    bits and d w within 1e-6 of the largest."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.models.fields import field_apply, field_color
    from nerfstyle_torch.ops import compositing, hashgrid
    from nerfstyle_torch.ops.mlp import mlp_init
    from nerfstyle_torch.training.checkpoint import tree_flatten

    spec, bbox, dtype = renderer.field_spec, renderer.bbox, renderer.compute_dtype
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(17)
    pts = bbox.min_pt + torch.rand((1 << 17, 3), generator=gen, device=dev) * bbox.size
    enc = spec.grid.output_dim

    def head(width: int):
        return mlp_init(torch.Generator().manual_seed(width), enc, spec.density_hidden_dims,
                        spec.density_hidden_layers, width, dev)

    spec0 = dataclasses.replace(spec, class_dim=0)
    base0 = {**params, "class_net": head(0)}
    for branch in ("field_apply", "field_color"):
        g = torch.randn((pts.shape[0], 3), generator=gen, device=dev)
        g_sig = torch.randn((pts.shape[0],), generator=gen, device=dev) * 1e-3
        runs = {}
        for plain in (False, True):
            p = {k: [w.detach().clone().requires_grad_(True) for w in v] if isinstance(v, list)
                 else v.detach().clone().requires_grad_(True) for k, v in base0.items()}
            reset_counts()
            if branch == "field_apply":
                ch, sig = field_apply(spec0, p, bbox, pts, dtype, plain=plain)
                loss = (ch * g).sum() + (sig * g_sig).sum()
            else:
                ch = field_color(spec0, p, bbox, pts, dtype, plain=plain)
                loss = (ch * g).sum()
            leaves = tree_flatten(p)
            grads = [torch.zeros_like(w) if d is None else d
                     for w, d in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
            torch.cuda.synchronize()
            runs[plain] = (ch.detach(), grads, read_counts())
        (ch, grads, counts), (ch_p, grads_p, counts_p) = runs[False], runs[True]
        err, tol = float((ch - ch_p).abs().max()), k5_tolerance(ch_p, dtype)
        grad_err = max(rel_l2(a, b) for a, b in zip(grads, grads_p))
        heads = 3 if branch == "field_apply" else 2  # density (apply), color1, color2
        ok = (tuple(ch.shape) == (pts.shape[0], 3) and err <= tol and grad_err <= 5e-3
              and counts["mlp_forward"] == heads and not any(
                  v for k, v in counts_p.items() if ":" not in k))
        if not ok:
            fails.append(f"class_dim 0, {branch}: shape {tuple(ch.shape)}, max abs err {err} "
                         f"(tol {tol}), worst gradient relative L2 {grad_err} (tol 5e-3), K5 "
                         f"launches {counts['mlp_forward']} (want {heads})")
        log(f"class_dim 0, {branch} on {pts.shape[0]} points ({dtype}): channels "
            f"{tuple(ch.shape)}, max abs err {err:.3e} (tol {tol:.3e}), worst gradient relative "
            f"L2 {grad_err:.3e} (tol 5e-3), K5 forward launches {counts['mlp_forward']}")

    # Width 70: the class head in two K5 calls, forward and backward.
    with torch.no_grad():
        h_color = hashgrid.hashgrid_encode(spec.grid, params["x_color_embedder"], pts)
    reset_counts()
    errs = mlp_check(head(70), h_color, None, dtype, True, gen, fails, "a 70-class head")
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["mlp_forward"] != 2 or counts["mlp_backward"] != 2:
        fails.append(f"a 70-class head: K5 launches {counts['mlp_forward']} forward, "
                     f"{counts['mlp_backward']} backward (want 2 each)")
    log(f"a 70-class head on {h_color.shape[0]} rows ({dtype}): max abs err (out, d x, d W...) "
        f"{errs}; K5 launches {counts['mlp_forward']} forward, {counts['mlp_backward']} "
        f"backward")

    # K7 and K7b at 3 + 70 channels on a ragged stream of 2^16 rays.
    counts_ray = torch.randint(0, 24, (1 << 16,), generator=gen, device=dev)
    offsets = torch.zeros((counts_ray.shape[0] + 1,), dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts_ray, 0)
    n_s = int(offsets[-1])
    w = torch.rand((n_s,), generator=gen, device=dev)
    ch = torch.randn((n_s, 73), generator=gen, device=dev)
    g = torch.randn((counts_ray.shape[0], 73), generator=gen, device=dev)
    reset_counts()
    got = kernels.segment_sum(w, ch, offsets)
    d_ch, d_w = kernels.segment_sum_backward(w, ch, g, offsets, True)
    torch.cuda.synchronize()
    counts = read_counts()
    want = compositing.segment_sum(w.double(), ch.double(), offsets, plain=True)
    p_ch, p_w = compositing.segment_sum_backward_plain(w, ch, g, offsets, True)
    k7_err = float((got.double() - want).abs().max())
    k7_tol = 1e-6 * float(want.abs().max())
    k7_rel = float(((got.double() - want).abs() - 1e-5 * want.abs()).max())
    dw_err, dw_tol = float((d_w - p_w).abs().max()), 1e-6 * float(p_w.abs().max())
    ok = (k7_rel <= k7_tol and torch.equal(d_ch, p_ch) and dw_err <= dw_tol
          and counts["segment_sum"] == 2 and counts["segment_sum_backward"] == 2)
    if not ok:
        fails.append(f"K7/K7b at 73 channels: K7 max abs err {k7_err}, d ch equal "
                     f"{torch.equal(d_ch, p_ch)}, d w err {dw_err} (tol {dw_tol}), launches "
                     f"{counts['segment_sum']} and {counts['segment_sum_backward']} (want 2)")
    log(f"K7/K7b at 73 channels on {n_s} samples of {counts_ray.shape[0]} rays: K7 max abs err "
        f"{k7_err:.3e}; K7b d ch equal to plain: {torch.equal(d_ch, p_ch)}, d w max abs err "
        f"{dw_err:.3e} (tol {dw_tol:.3e}); launches {counts['segment_sum']} + "
        f"{counts['segment_sum_backward']}")


def train_argv(steps: int, *extra: str, log_dir: str = "train", data_cfg: str = "data.yaml"):
    """Flags of ``python -m nerfstyle_torch.train`` at the default configs on
    the data config ``WORK / data_cfg`` (by default the synthetic scene: 24
    train views of 128x96, 6 test views)."""
    return ["--device", DEVICE, "--log-dir", str(WORK / log_dir),
            "--data-cfg", str(WORK / data_cfg), "--num_iterations", str(steps),
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

    missing = [c for c in STEP_COUNTERS if k["launches"][c] <= 0]
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


def late_batch(trainer) -> dict:
    """A late train batch as the step builds it (``eval_composite``): see
    marched_batch."""
    frame, idx = trainer.sample_batch()
    o, d, _ = trainer.ray_batch(frame, idx)
    return marched_batch(trainer, o, d)


def marched_batch(trainer, o, d) -> dict:
    """The rays (o, d) as ``render_rays`` hands them to ``eval_composite``:
    the rays, the marched stream (phase A) with its densities
    (density_scale applied) and the kept prefix of each ray (phase B), with
    both streams' encoder inputs in march order."""
    from nerfstyle_torch.models.fields import _encoder_input, field_density
    from nerfstyle_torch.ops import compositing, marching
    from nerfstyle_torch.ops.aabb import near_far_from_aabb
    from nerfstyle_torch.render.pipeline import kept_prefix

    r, spec, s = trainer.renderer, trainer.field_spec, trainer.settings
    plan, bbox = r.plan, r.bbox
    nears, fars = near_far_from_aabb(o, d, plan.aabb(o.device), plan.min_near)
    sb = marching.march_rays(plan, r.occ_field, o, d, nears, fars)
    with torch.no_grad():
        sig_a = field_density(spec, trainer.params, bbox, sb.xyz,
                              trainer.compute_dtype) * s.density_scale
        *_, n_inc = compositing.sample_weights(sig_a, sb.tau, sb.offsets, plan.dt, s.t_thresh)
        keep, offsets = kept_prefix(sb, n_inc)
    return dict(o=o.contiguous(), d=d.contiguous(), nears=nears, fars=fars, sb=sb, sig_a=sig_a,
                keep=keep, offsets=offsets, x_a=_encoder_input(bbox, sb.xyz).contiguous(),
                x_b=_encoder_input(bbox, sb.xyz[keep]).contiguous())


def train_stream_rows(trainer, batch, fails, gen) -> dict:
    """K1 on a late train batch's two streams (phase A: density table;
    phase B: the fused [T, 4] tables) and K2 on phase B's; on phase B's
    also K1 at style slots 1, 63 and 511, bit for bit against the plain
    encode, and K2 at 1 and 63 (library API: ``hashgrid_encode(style=s)``;
    the row at 63); K1s and K2s when the trainer's grid has simplex
    levels (the simplex run's streams)."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.ops import hashgrid

    grid, params = trainer.field_spec.grid, trainer.params
    simplex = grid.simplex_start < grid.num_levels
    k1, k2 = ("K1s", "K2s") if simplex else ("K1", "K2")
    fused = torch.cat([params["x_density_embedder"], params["x_color_embedder"]], dim=1).detach()
    kept = "a late train batch's kept samples (phase B, fused [T, 4])"
    lv = hashgrid.level_table(grid, fused.device)
    for style in (1, 63, 511):
        got = kernels.hashgrid_encode(batch["x_b"], fused, lv, hashgrid.style_term(style))
        if not torch.equal(got, hashgrid.hashgrid_encode(grid, fused, batch["x_b"], style=style,
                                                         plain=True)):
            fails.append(f"{k1} at style {style} on {kept} differs from the plain encode")
    log(f"{k1} at styles 1, 63, 511 on {kept} ({batch['x_b'].shape[0]} points) checked against "
        "the plain encode, bit for bit")
    k2_row(grid, batch["x_b"], fused.shape[1], kept, gen, fails, style=1)
    return {
        f"{k1} train A": k1_row(grid, params["x_density_embedder"].detach(), batch["x_a"],
                                "a late train batch's marched samples (phase A, density)", fails),
        f"{k1} train B": k1_row(grid, fused, batch["x_b"], kept, fails),
        f"{k2} train B": k2_row(grid, batch["x_b"], fused.shape[1], kept, gen, fails),
        f"{k2} train B s63": k2_row(grid, batch["x_b"], fused.shape[1], kept, gen, fails,
                                    style=63),
    }


def k4b_row(sigmas, ch, tau, offsets, dt: float, t_thresh: float, what: str, gen,
            fails) -> dict:
    """K4b, the compositor's backward, on a kept prefix (densities with
    density_scale applied, channels) for random cotangents, against the
    plain backward on float64 inputs.  Rays with an entering T within 1e-4
    relative of t_thresh may include one sample more or less in fp32 and are
    left out.  d ch = w * gI: 1e-5 of the largest (w's fp32 rounding); d
    sigma = dt (T_{i+1} v - suffix) loses digits to the difference: 1e-4 of
    the largest.  Timed from a CUDA graph of the kernel call alone (launch by
    launch logged).  Returns the kernel-table entry."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.ops import compositing

    n, k, dev = offsets.shape[0] - 1, sigmas.shape[0], sigmas.device
    chc = ch.contiguous()
    gi = torch.randn((n, chc.shape[1]), generator=gen, device=dev)
    gw = torch.randn((n,), generator=gen, device=dev)
    gd = torch.randn((n,), generator=gen, device=dev)
    w, _, _, n_inc_b = kernels.composite_weights(sigmas, tau, offsets, dt, t_thresh)
    d_s, d_c = kernels.composite_backward(sigmas, chc, tau, w, offsets, n_inc_b, gi, gw, gd, dt)
    ref_s, ref_c = compositing.composite_backward_plain(
        sigmas.double(), chc.double(), tau.double(), offsets, gi.double(), gw.double(),
        gd.double(), dt, t_thresh)
    _, trans64 = compositing.entering_transmittance_plain(sigmas.double(), offsets, dt)
    near = (trans64 - t_thresh).abs() <= 1e-4 * t_thresh
    edge = compositing.segment_totals_plain(near.double(), offsets) > 0
    inner = ~edge[compositing.ray_ids(offsets)]
    err_s = float((d_s.double() - ref_s)[inner].abs().max()) if bool(inner.any()) else 0.0
    err_c = float((d_c.double() - ref_c)[inner].abs().max()) if bool(inner.any()) else 0.0
    tol_s, tol_c = 1e-4 * float(ref_s.abs().max()), 1e-5 * float(ref_c.abs().max())
    if not (err_s <= tol_s and err_c <= tol_c):
        fails.append(f"K4b at {what}: errors d_sigma {err_s} (tol {tol_s}), d_ch {err_c} (tol "
                     f"{tol_c})")
    ms = graph_ms(lambda: kernels.composite_backward(sigmas, chc, tau, w, offsets, n_inc_b, gi,
                                                     gw, gd, dt))
    host_ms = cuda_ms(lambda: kernels.composite_backward(sigmas, chc, tau, w, offsets, n_inc_b,
                                                         gi, gw, gd, dt), reps=20)
    plain_ms = cuda_ms(lambda: compositing.composite_backward_plain(
        sigmas, chc, tau, offsets, gi, gw, gd, dt, t_thresh), reps=5)
    cc = chc.shape[1]
    # Bytes: sigma, tau, w and ch of every sample, offsets, n_inc and the
    # cotangents of every ray; d sigma and d ch written once.
    b_ms, b_by = bound_ms(nbytes=k * 4 * (3 + cc) + (n + 1) * 8 + n * 4 * (3 + cc)
                          + k * 4 * (1 + cc), flops=k * (4 * cc + 12))
    log(f"K4b composite_backward at {what}: {k} kept samples x {cc} channels, "
        f"{ray_stats(offsets, n_inc_b)}, {int(edge.sum())} edge rays left out; max_abs_err "
        f"d_sigma {err_s:.3e} (tol {tol_s:.3e}), d_ch {err_c:.3e} (tol {tol_c:.3e}); ms "
        f"{ms:.4f} (graph; {host_ms:.4f} launched one by one), plain_ms {plain_ms:.3f}, "
        f"bound_ms {b_ms:.4f} ({b_by})")
    return dict(max_abs_err=max(err_s, err_c), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def train_kernel_phases(trainer, fails):
    """K3 and K3s, K1, K2 and K4 on a late batch's streams, K4b and K6 at
    the train step's shapes (a batch of the trained state; the random
    occupancy update's probe count) against their plain versions; returns
    the K1, K2, K4, K4b and K6 kernel-table entries."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.models.fields import _encoder_input, field_apply
    from nerfstyle_torch.ops import hashgrid, marching, occupancy

    r, spec, s = trainer.renderer, trainer.field_spec, trainer.settings
    plan, bbox, dev = r.plan, r.bbox, trainer.device
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = late_batch(trainer)
    o, d, nears, fars = batch["o"], batch["d"], batch["nears"], batch["fars"]
    n = o.shape[0]
    march_phase(plan, r.occ_state, o, d, fails, "a late train batch")
    sb, keep, offsets, x = batch["sb"], batch["keep"], batch["offsets"], batch["x_b"]
    with torch.no_grad():
        tau = sb.tau[keep].contiguous()
        ch, sig = field_apply(spec, trainer.params, bbox, sb.xyz[keep], trainer.compute_dtype)
    k = keep.shape[0]
    table = train_stream_rows(trainer, batch, fails, gen)

    # K2 at an early step's shape: with every cell occupied (the grid before
    # the first updates prune it) a batch marches all its lattice samples,
    # and phase B keeps them all.  The fused [T, 4] tables' width, a random
    # cotangent; against the plain version's float64 sums: 1e-4 of the
    # largest row (k2_row).
    lvl, c, rows = spec.grid.num_levels, 2 * spec.grid.level_dim, spec.grid.total_params
    lv = hashgrid.level_table(spec.grid, dev)
    sb0 = marching.march_rays(plan, torch.ones_like(r.occ_state.bitfield), o, d, nears, fars)
    x0 = _encoder_input(bbox, sb0.xyz).contiguous()
    del sb0
    g0 = torch.randn((x0.shape[0], lvl * c), generator=gen, device=dev)
    ref0 = hashgrid.hashgrid_backward_plain(spec.grid, x0, g0.double(), rows)
    err0 = float((kernels.hashgrid_backward(x0, g0, lv, rows).double() - ref0).abs().max())
    tol0 = 1e-4 * float(ref0.abs().max())
    if not err0 <= tol0:
        fails.append(f"K2 table gradient error {err0} > {tol0} (early shape)")
    del ref0
    ms0 = cuda_ms(lambda: kernels.hashgrid_backward(x0, g0, lv, rows), reps=3, warmup=1)
    log(f"K2 hashgrid_backward at an early step's shape: {x0.shape[0]} samples "
        f"({x0.shape[0] / n:.1f} a ray) x {lvl} levels x 8 corners; max_abs_err {err0:.3e} "
        f"(tol {tol0:.3e}); ms {ms0:.3f}")
    del x0, g0

    # K4 on the batch's two streams: phase A's marched samples (only n_inc
    # is used) and phase B's kept prefix (inside the differentiable
    # compositor).
    sigmas = (sig * s.density_scale).contiguous()
    table["K4 train A"], _ = k4_row(batch["sig_a"], sb.tau, sb.offsets, plan.dt, s.t_thresh,
                                    "a late train batch's marched samples (phase A)", fails)
    table["K4 train B"], _ = k4_row(sigmas, tau, offsets, plan.dt, s.t_thresh,
                                    "a late train batch's kept prefix (phase B)", fails)

    table["K4b train B"] = k4b_row(sigmas, ch, tau, offsets, plan.dt, s.t_thresh,
                                   "a late train batch's kept prefix (phase B)", gen, fails)

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
    table["K5bw"] = k5_weight_grad_phase(trainer, x, gen, fails)

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
    # Kernel and library call from CUDA graphs of the call alone; launch by
    # launch logged beside.
    ms = graph_ms(lambda: kernels.occupancy_scatter_max(scratch, pidx, psig))
    host_ms = cuda_ms(lambda: kernels.occupancy_scatter_max(scratch, pidx, psig), reps=20)
    plain_ms = cuda_ms(lambda: occupancy.scatter_max_plain(scratch, pidx, psig), reps=20)
    lib_ms = graph_ms(lambda: scratch.scatter_reduce_(0, pidx, psig, "amax"))
    p, kc = pidx.shape[0], cascade * ncell
    b_ms, b_by = bound_ms(nbytes=p * 12 + kc * 8, flops=p)
    table["K6s"] = dict(max_abs_err=float((tmp - tmp_ref).abs().max()), ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    log(f"K6 occupancy_scatter_max: {p} probes into {kc} cells; equal to plain: "
        f"{torch.equal(tmp, tmp_ref)}; ms {ms:.4f} (graph; {host_ms:.4f} launched one by one), "
        f"plain_ms {plain_ms:.3f}, scatter_reduce_ ms {lib_ms:.4f} (graph), bound_ms {b_ms:.4f} "
        f"({b_by})")

    # The merge: the grid and the bitfield equal the plain bits; the mean
    # within 1e-6 relative (float64 partial sums in another order); a second
    # launch gives the same bits, mean included.
    flat = grid.reshape(-1).contiguous()
    merged, bits, mean = kernels.occupancy_merge(flat, tmp, s.density_decay, s.density_thresh)
    again = kernels.occupancy_merge(flat, tmp, s.density_decay, s.density_thresh)
    merged_p, bits_p, mean_p = occupancy.merge_and_threshold_plain(flat, tmp, s.density_decay,
                                                                   s.density_thresh)
    mean_err = abs(float(mean) - float(mean_p)) / max(abs(float(mean_p)), 1e-30)
    if not (torch.equal(merged, merged_p) and torch.equal(bits, bits_p) and mean_err <= 1e-6):
        fails.append(f"K6 merge differs from plain (mean relative error {mean_err})")
    same = (torch.equal(merged, again[0]) and torch.equal(bits, again[1])
            and float(mean) == float(again[2]))
    if not same:
        fails.append("K6 merge differs between two launches")
    ms = graph_ms(lambda: kernels.occupancy_merge(flat, tmp, s.density_decay, s.density_thresh))
    host_ms = cuda_ms(lambda: kernels.occupancy_merge(flat, tmp, s.density_decay,
                                                      s.density_thresh), reps=20)
    plain_ms = cuda_ms(lambda: occupancy.merge_and_threshold_plain(
        flat, tmp, s.density_decay, s.density_thresh), reps=20)
    # Bytes: grid and probe grid read, merged grid and bitfield written.
    b_ms, b_by = bound_ms(nbytes=kc * 13 + 4, flops=kc * 5)
    table["K6m"] = dict(max_abs_err=float((merged - merged_p).abs().max()), ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"K6 occupancy_merge + threshold: {kc} cells, {int(bits.sum())} occupied, mean "
        f"{float(mean):.5f} (relative error {mean_err:.2e}); two launches equal: {same}; ms "
        f"{ms:.4f} (graph; {host_ms:.4f} launched one by one; 1 launch a call), plain_ms "
        f"{plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by})")
    return table


def k5_weight_grad_phase(trainer, x, gen, fails):
    """K5 backward with every d W, as the train step runs it, on a train
    batch of K5_DW_ROWS rows (the density_net and color1_net heads on points
    drawn from a late batch's kept samples ``x``): held against the plain
    chain's autograd, run twice on the same inputs (d W must be the same
    bits: the partial sums add in CTA order), and timed.  Returns the
    kernel-table entry.

    Tolerance: at this many rows some hidden pre-activation lies within the
    fp32 sum-order noise of 0, and its ReLU mask differs between the two
    versions, which moves that row's d x by a whole term.  So d x: at most
    1e-4 of the rows beyond 2^-7 of the largest value (mlp_check's
    tolerance); d W (summed over all rows): relative L2 error 5e-3, as the
    train step's gradients."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.ops import hashgrid
    from nerfstyle_torch.ops.mlp import mlp_apply_plain

    spec, params, dtype, dev = trainer.field_spec, trainer.params, trainer.compute_dtype, x.device
    pick = torch.randint(0, x.shape[0], (K5_DW_ROWS,), generator=gen, device=dev)
    xw = x[pick].contiguous()
    with torch.no_grad():
        heads = [([w.detach() for w in params[head]],
                  hashgrid.hashgrid_encode(spec.grid, params[tab], xw))
                 for head, tab in (("density_net", "x_density_embedder"),
                                   ("color1_net", "x_color_embedder"))]
    del xw
    bf16 = dtype == torch.bfloat16
    gs = [torch.randn((K5_DW_ROWS, ws[-1].shape[1]), generator=gen, device=dev) for ws, _ in heads]

    def bwd():
        return [kernels.mlp_backward(hh, ws, g, False, bf16, [True] * len(ws))
                for (ws, hh), g in zip(heads, gs)]

    def bwd_plain(chain=mlp_apply_plain):
        outs = []
        for (ws, hh), g in zip(heads, gs):
            wr = [w.clone().requires_grad_(True) for w in ws]
            xr = hh.detach().requires_grad_(True)
            d = torch.autograd.grad(chain(wr, xr, None, dtype), [xr] + wr, g)
            outs.append((d[0], [gw.to(torch.bfloat16).float() if bf16 else gw for gw in d[1:]]))
        return outs

    first, second = bwd(), bwd()
    same = all(torch.equal(a[0], b[0]) and all(torch.equal(p, q) for p, q in zip(a[1], b[1]))
               for a, b in zip(first, second))
    if not same:
        fails.append("K5 backward: two launches on the same inputs gave different d x or d W")
    errs, far_rows, dw_rel = [], [], []
    for (dx, dws), (dx_p, dws_p) in zip(first, bwd_plain()):
        tol = k5_tolerance(dx_p, dtype)
        diff = (dx - dx_p).abs()
        far_rows.append(int((diff > tol).any(dim=1).sum()))
        dw_rel.append(max(rel_l2(a, b) for a, b in zip(dws, dws_p)))
        errs.append([float(diff.max())] + [float((a - b).abs().max()) for a, b in zip(dws, dws_p)])
    if not (max(far_rows) <= 1e-4 * K5_DW_ROWS and max(dw_rel) <= 5e-3):
        fails.append(f"K5 backward with d W at {K5_DW_ROWS} rows: rows of d x beyond tolerance "
                     f"{far_rows}, d W relative L2 errors {dw_rel}")
    del first, second
    ms = cuda_ms(bwd, reps=10)
    plain_ms = cuda_ms(bwd_plain, reps=3, warmup=1)
    with cublas_fp32_sums():
        lib_ms = cuda_ms(lambda: bwd_plain(mlp_library_chain), reps=3, warmup=1)
    grids = [kernels.mlp_backward_grid(K5_DW_ROWS, ws[0].shape[0], len(ws) - 1, ws[-1].shape[1])
             for ws, _ in heads]
    # Bytes: each head reads x and g and writes d x (fp32 rows), reads its
    # weights and writes their gradient.  Operations: 2 d_in d_out a row a
    # layer for the forward recompute, d x (or d h) and d W each.
    dims = [[w.shape[0] for w in ws] + [ws[-1].shape[1]] for ws, _ in heads]
    macs = sum(sum(a * b for a, b in zip(d[:-1], d[1:])) for d in dims)
    wbytes = sum(w.numel() * 4 for ws, _ in heads for w in ws)
    b_ms, b_by = bound_ms(K5_DW_ROWS * 4 * sum(2 * d[0] + d[-1] for d in dims) + 2 * wbytes,
                          6 * K5_DW_ROWS * macs, PEAK_BF16_PER_S if bf16 else PEAK_FP32_PER_S)
    log(f"K5 backward with every d W at a train batch of {K5_DW_ROWS} rows ({dtype}, layer "
        f"widths {dims}, grids {grids} CTAs): max abs err (d x, d W...) {errs}, rows of d x "
        f"beyond 2^-7 of the largest {far_rows}, d W relative L2 {dw_rel}; two launches "
        f"bit-equal: {same}; ms {ms:.3f} (both heads, the d W reduction included), plain_ms "
        f"(forward + autograd) {plain_ms:.3f}, cuBLAS chain + autograd {lib_ms:.3f}, bound_ms "
        f"{b_ms:.4f} ({b_by})")
    return dict(max_abs_err=max(max(e) for e in errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def mlp_library_chain(weights, x, act, dtype):
    """K5's function through cuBLAS, with K5's rounding points: K5's library
    yardstick, used nowhere in the port.

    Under bf16 each hidden layer is one bf16 ``torch.matmul`` (fp32 sums,
    output rounded to bf16) followed by the ReLU: ReLU and round-to-nearest
    commute, so this is r(relu(h r(W))) up to the order of the fp32 sums.
    The first of two hidden layers, which K5 sums on fp32 FMAs in the plain
    chain's order, is an fp32 ``torch.matmul`` of the bf16-exact operands,
    then the ReLU and the rounding: the plain chain's masks and roundings
    there, as K5's (a bf16 GEMM sums in another order, and a first-layer
    value that rounds to the other bf16 neighbour moves the head's output
    by up to a few 2^-8 of it).  The output layer is an fp32
    ``torch.matmul`` of the bf16-exact operands (h_L and r(W_L)), then the
    sigmoid where the head has one.  In fp32 it is the plain fp32 chain.
    Run it under :func:`cublas_fp32_sums`."""
    if dtype == torch.float32:
        h = x
        for i, w in enumerate(weights):
            h = torch.matmul(h, w)
            if i < len(weights) - 1:
                h = torch.relu(h)
    else:
        h = x.to(dtype)
        for i, w in enumerate(weights[:-1]):
            if i == 0 and len(weights) > 2:
                h = torch.relu(torch.matmul(h.float(), w.to(dtype).float())).to(dtype)
            else:
                h = torch.relu(torch.matmul(h, w.to(dtype)))
        h = torch.matmul(h.float(), weights[-1].to(dtype).float())
    return torch.sigmoid(h) if act == "sigmoid" else h


@contextlib.contextmanager
def cublas_fp32_sums():
    """Keep cuBLAS on fp32 sums inside (no TF32, no reduced-precision bf16
    reductions); restore both flags after."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32, m.allow_bf16_reduced_precision_reduction = False, False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def k5_tolerance(want: torch.Tensor, dtype) -> float:
    """K5's absolute tolerance against the plain chain: fp32 sums in another
    order, 1e-5 of the largest value; under bf16 a value near a rounding step
    may land on the other side (2^-8 of itself) and carry that into what
    follows: 2^-7 of the largest value."""
    return (2.0**-7 if dtype == torch.bfloat16 else 1e-5) * float(want.abs().max())


def library_check(weights, x, act, dtype, fails, what: str) -> float:
    """The cuBLAS chain against the plain version on the same inputs, with
    K5's tolerance; returns the max abs error."""
    from nerfstyle_torch.ops.mlp import mlp_apply_plain

    with torch.no_grad(), cublas_fp32_sums():
        got = mlp_library_chain(weights, x, act, dtype)
        want = mlp_apply_plain(weights, x, act, dtype)
    err, tol = float((got - want).abs().max()), k5_tolerance(want, dtype)
    if not err <= tol:
        fails.append(f"K5's cuBLAS chain {what}: error {err} > {tol} against the plain version")
    return err


def relu_mask_report(weights, x, dtype, rows: torch.Tensor) -> str:
    """For each given row, each hidden layer's pre-activations of the plain
    chain (its fp32 GEMM on the full batch) against the same sums in float64
    (of the same bf16-exact operands): the smallest |pre-activation| in
    float64, the row's largest, and how many units the fp32 sum puts on the
    other side of 0.  A row whose d x is off by a whole term and whose
    smallest |pre-activation| is far below the fp32 resolution of its largest
    has a ReLU mask that follows the order of the sums."""
    def rnd(t):
        return t if dtype == torch.float32 else t.to(dtype).float()

    out = []
    with torch.no_grad():
        h = rnd(x)
        for i, w in enumerate(weights[:-1]):
            v32 = torch.matmul(h, rnd(w))
            v64 = h[rows].double() @ rnd(w).double()
            off = ((v32[rows] > 0) != (v64 > 0)).sum(dim=1)
            out.append([(i, float(v64[n].abs().min()), float(v64[n].abs().max()), int(off[n]))
                        for n in range(rows.shape[0])])
            h = rnd(torch.relu(v32))
    return "; ".join(f"row {int(r)}: " + ", ".join(
        f"layer {i} min |v| {lo:.3e} of max {hi:.3e}, fp32 signs off {n}" for i, lo, hi, n in per)
        for r, per in zip(rows.tolist(), zip(*out)))


def mlp_check(weights, x, act, dtype, need_dw: bool, gen, fails, what: str):
    """K5 forward and backward (d x, and every d W when ``need_dw``) against
    the plain matmul chain and its autograd on the same inputs and a random
    cotangent, each within k5_tolerance; returns the max abs errors (output,
    d x, d W...).  A d x past its tolerance is logged with the ReLU masks of
    its worst rows (relu_mask_report)."""
    from nerfstyle_torch.ops.mlp import mlp_apply

    g = torch.randn((x.shape[0], weights[-1].shape[1]), generator=gen, device=x.device)
    res = {}
    for plain in (False, True):
        ws = [w.detach().clone().requires_grad_(need_dw) for w in weights]
        xr = x.detach().clone().requires_grad_(True)
        out = mlp_apply(ws, xr, act, dtype, plain=plain)
        res[plain] = (out.detach(),) + torch.autograd.grad(out, [xr] + (ws if need_dw else []), g)
    errs = []
    for n, (a, b) in enumerate(zip(res[False], res[True])):
        diff = (a - b).abs()
        err, tol = float(diff.max()), k5_tolerance(b, dtype)
        errs.append(err)
        if not err <= tol:
            fails.append(f"K5 {what}: error {err} > {tol}")
            if n == 1:
                far = (diff > tol).any(dim=1).nonzero().flatten()
                worst = far[diff[far].amax(dim=1).argsort(descending=True)[:8]]
                log(f"K5 {what}: {far.shape[0]} rows of d x past {tol}; the worst: "
                    f"{relu_mask_report(weights, x, dtype, worst)}")
    return errs


def profile_once(fn, label: str, card: str) -> dict:
    """One call of fn under torch.profiler: the kernel table by device time,
    the device's idle share of the call's wall time, and what the call
    issued: operators (``aten::`` events), kernel launches (the runtime's
    launch calls), device events and synchronizations.  Returns these."""
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
        host = [e for e in events if e.device_type == DeviceType.CPU]
        issued = {
            "operators": sum(e.count for e in host if e.key.startswith("aten::")),
            "launches": sum(e.count for e in host if "LaunchKernel" in e.key),
            "device_events": sum(e.count for e in events if e.device_type == DeviceType.CUDA),
            "syncs": sum(e.count for e in host if "Synchronize" in e.key),
        }
        log(f"profiled {label} ({card}): device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall, "
            f"idle share {1 - busy_ms / wall_ms:.3f}; issued {issued}")
        return {"busy_ms": busy_ms, "wall_ms": wall_ms, **issued}
    except Exception as e:  # the profiler is a diagnostic only; report and go on
        log(f"profiler unavailable: {type(e).__name__}: {e}")
        return {}


def train_phase(card: str, fails):
    """The train path through ``python -m nerfstyle_torch.train`` (in-process)
    at the default configs; returns the trainer and its kernel launches."""
    from nerfstyle_torch import train

    (WORK / "data.yaml").write_text(
        f"root_path: {WORK / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    # The untrained field's test PSNR, as the trainer reports it before its
    # first step (same seed, same views).
    untrained = train.main(train_argv(0, "--test_before_train")).test_history[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer = train.main(train_argv(TRAIN_STEPS))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
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


def step_ms_on_off(trainer, card: str, steps: int = 10):
    """Late train steps with adaptive_march on and off, in turns (on, off,
    off, on), ``steps`` a turn: the median step ms of each side, and the
    kernel launches of the off turns (the dense march's)."""

    r = trainer.renderer
    on = r.settings
    times = {True: [], False: []}
    off_launches = {}
    for adaptive in (True, False, False, True):
        r.settings = dataclasses.replace(on, adaptive_march=adaptive)
        reset_counts()
        for _ in range(steps):
            trainer.run_iter()
        times[adaptive] += trainer.iter_ms[-steps:]
        if not adaptive:
            for k, v in read_counts().items():
                off_launches[k] = off_launches.get(k, 0) + v
    r.settings = on
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"late train step ({card}), {steps} steps a turn, on/off/off/on: adaptive_march on "
        f"median {med[True]:.2f} ms {['%.2f' % t for t in times[True]]}, off median "
        f"{med[False]:.2f} ms {['%.2f' % t for t in times[False]]}")
    return off_launches


def simplex_phase(card: str, fails):
    """The simplex configuration through ``python -m nerfstyle_torch.train
    --pos_enc.simplex_from 10`` (in-process, default width, SIMPLEX_STEPS
    steps): the test PSNR must rise 5 dB, one step must match its plain
    version, and one frame must render from its checkpoint through
    ``python -m nerfstyle_torch.render``; then K1s and K2s on a late batch's
    streams.  Returns the run's and the frame's kernel launches, and the K1s
    and K2s table entries."""
    from nerfstyle_torch import train
    from nerfstyle_torch.render import cli

    extra = ("--pos_enc.simplex_from", str(SIMPLEX_FROM))
    untrained = train.main(train_argv(0, "--test_before_train", *extra,
                                      log_dir="simplex")).test_history[0]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer = train.main(train_argv(SIMPLEX_STEPS, *extra, log_dir="simplex"))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    # Fewer steps than update_thres: only full sweeps, no scatter-max.
    for name in TRAIN_COUNTERS:
        if name != "occupancy_scatter_max" and launches[name] <= 0:
            fails.append(f"simplex train path launched no {name} kernel")
    grid = trainer.field_spec.grid
    if grid.simplex_start != SIMPLEX_FROM:
        fails.append(f"the simplex run encodes simplex levels from {grid.simplex_start}")
    notfinite = int(trainer.opt_state.total_notfinite)
    if notfinite or not all(bool(torch.isfinite(v)) for v in trainer.last_losses.values()):
        fails.append(f"simplex run: non-finite losses ({notfinite} steps skipped)")
    final = trainer.test_networks()
    ms = trainer.iter_ms
    log(f"simplex run ({card}): simplex levels {grid.simplex_start}-{grid.num_levels - 1}, "
        f"{SIMPLEX_STEPS} steps in {wall_s:.1f} s, step ms median early (1-15) "
        f"{np.median(ms[1:16]):.2f}, late (last 50) {np.median(ms[-50:]):.2f}; test PSNR "
        f"untrained {untrained['psnr']:.3f} dB, after {final['psnr']:.3f} dB; launches {launches}")
    if not final["psnr"] >= untrained["psnr"] + 5.0:
        fails.append(f"simplex run: test PSNR rose from {untrained['psnr']:.3f} to "
                     f"{final['psnr']:.3f} dB, less than 5 dB")
    step_vs_plain(trainer, fails)
    table = train_stream_rows(trainer, late_batch(trainer), fails,
                              torch.Generator(device=DEVICE).manual_seed(6))
    ckpt = trainer.log_dir / f"iter_{SIMPLEX_STEPS}.ckpt"
    del trainer
    torch.cuda.empty_cache()
    reset_counts()
    summary = cli.main([str(ckpt), "--out-dims", *map(str, OUT_DIMS), "--max-count", "1",
                        "--yes", "--out-dir", str(WORK / "simplex_render"), "--device", DEVICE])
    frame_launches = read_counts()
    out = summary["last"]
    if not (tuple(out["rgb_map"].shape) == (OUT_DIMS[0] * OUT_DIMS[1], 3)
            and bool(torch.isfinite(out["rgb_map"]).all())):
        fails.append("the simplex checkpoint's frame is not finite or of another shape")
    for name in RENDER_COUNTERS:
        if frame_launches[name] <= 0:
            fails.append(f"the simplex frame launched no {name} kernel")
    log(f"simplex frame ({card}): {summary['frame_ms'][0]:.1f} ms, "
        f"{out['num_marched'] / out['rgb_map'].shape[0]:.2f} samples/ray; launches "
        f"{frame_launches}")
    both = {k: launches.get(k, 0) + frame_launches.get(k, 0) for k in {*launches, *frame_launches}}
    return both, table


def _reference_cfg(**fields):
    """A config object of a module that is gone when the file is loaded,
    as the reference's config classes are: the importer's tolerant
    unpickler must stand in for it."""
    import types

    mod = sys.modules.setdefault("reference_config_module", types.ModuleType(
        "reference_config_module"))
    if not hasattr(mod, "Cfg"):
        mod.Cfg = type("Cfg", (), {"__module__": "reference_config_module"})
    obj = mod.Cfg()
    obj.__dict__.update(fields)
    return obj


def import_phase(card: str, ckpt: Path, spec, frame, fails):
    """The import path: the render checkpoint's tables, heads and occupancy
    (grid 128, 2 cascades) written as a reference ``iter_*.pth`` (its
    occupancy in Morton order and packed by the port's plain interop, no
    kernel), imported through ``python -m nerfstyle_torch.import_reference``,
    whose launches alone are counted; tables and occupancy must equal the
    source bit for bit and the imported checkpoint must render the render
    path's frame.  Then K8a and K8b, both directions, against their plain
    versions at the grid's size.  Returns the import's kernel launches and
    the table entries."""
    from nerfstyle_torch import import_reference, interop, kernels
    from nerfstyle_torch.ops import morton, occupancy
    from nerfstyle_torch.render import cli
    from nerfstyle_torch.training import checkpoint as ckpt_lib

    meta, groups = ckpt_lib.load_checkpoint(ckpt)
    params = ckpt_lib.restore_tree(cli.param_template(spec), groups["params"], DEVICE)
    occ = ckpt_lib.restore_tree(occupancy.PersistedOccupancy(*[0] * 5), groups["occ"], DEVICE)
    h = meta["render_cfg"]["grid_size"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mor_grid = interop.linear_grid_to_morton(occ.density_grid, h, plain=True)
    packed = interop.linear_bitfield_to_reference(occ.bitfield, h, plain=True)
    pe = meta["net_cfg"]["pos_enc"]
    state = {
        "version": "chip_smoke reference", "iter_ctr": 0, "cfg": _reference_cfg(style_image=None),
        "dataset_cfg": _reference_cfg(**meta["dataset_cfg"]),
        "train_cfg": _reference_cfg(**meta["train_cfg"]),
        "net_cfg": _reference_cfg(**{**meta["net_cfg"], "pos_enc": _reference_cfg(**pe)}),
        "render_cfg": _reference_cfg(**meta["render_cfg"]),
        "renderer": {
            "model": {
                "x_density_embedder.embeddings": params["x_density_embedder"].cpu(),
                "x_color_embedder.embeddings": params["x_color_embedder"].cpu(),
                **{f"{net}.params": torch.zeros(16) for net in import_reference.HEADS},
            },
            "raymarch_channels": meta["renderer_static"]["raymarch_channels"],
            "bound": meta["renderer_static"]["bound"],
            "density_grid": mor_grid.cpu(), "density_bitfield": packed.cpu(),
            "local_step": int(occ.local_step), "mean_count": int(occ.mean_count),
            "mean_density": float(occ.mean_density),
        },
    }
    pth, npz, out_ckpt = WORK / "reference.pth", WORK / "reference_heads.npz", WORK / "imported.ckpt"
    torch.save(state, pth)
    del sys.modules["reference_config_module"]
    np.savez(npz, **{f"{net}.{i}": w.cpu().numpy() for net in import_reference.HEADS
                     for i, w in enumerate(params[net])})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reset_counts()
    import_reference.main([str(pth), "--out", str(out_ckpt), "--mlp-npz", str(npz),
                           "--root-path", str(WORK / "scene"), "--device", DEVICE])
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t1
    launches = read_counts()
    for name in IMPORT_COUNTERS:
        if launches[name] <= 0:
            fails.append(f"the import path launched no {name} kernel")
    _, got = ckpt_lib.load_checkpoint(out_ckpt)
    equal = {
        "params": len(got["params"]) == len(groups["params"]) and all(
            np.array_equal(a, b) and a.dtype == b.dtype
            for a, b in zip(got["params"], groups["params"])),
        "occupancy grid and bitfield": all(np.array_equal(got["occ"][i], groups["occ"][i])
                                           for i in (0, 1)),
    }
    if not all(equal.values()):
        fails.append(f"the imported checkpoint differs from the source: {equal}")
    renderer, iparams, test_set, _ = cli.load_renderer(out_ckpt, DEVICE, OUT_DIMS, max_count=1)
    pose = torch.from_numpy(np.asarray(test_set[0][1]))
    with torch.no_grad():
        iframe = renderer.render(iparams, pose)
    err = float((iframe["rgb_map"] - frame["rgb_map"]).abs().max())
    if not (bool(torch.isfinite(iframe["rgb_map"]).all()) and err <= 1e-6):
        fails.append(f"the imported checkpoint's frame differs from the render path's: {err}")
    log(f"import ({card}): reference .pth {pth.stat().st_size / 2**20:.1f} MiB (grid {h}, "
        f"{occ.density_grid.shape[0]} cascades), exported in {t1 - t0:.2f} s, imported in "
        f"{import_s:.2f} s; equal to the source: {equal}; frame from the imported checkpoint "
        f"max abs err against the render path's {err:.3e}; launches {launches}")

    # K8a and K8b at the grid's size, against their plain versions (exact).
    # The import runs unpack and morton3d; pack and invert, the export
    # direction, run on no path of either package and are checked here only.
    table = {}
    bits, n = occ.bitfield, occ.bitfield.numel()
    codes = torch.arange(h**3, dtype=torch.int32, device=DEVICE)
    coords = occupancy.all_cell_coords(h, DEVICE)
    pk = occupancy.packbits(bits)
    cases = {
        "K8a pack": (lambda: kernels.packbits(bits), lambda: occupancy.packbits_plain(bits),
                     n + n // 8, n),
        "K8a unpack": (lambda: kernels.unpackbits(pk), lambda: occupancy.unpackbits_plain(pk),
                       n // 8 + n, n),
        "K8b morton": (lambda: kernels.morton3d(coords), lambda: morton.morton3d_plain(coords),
                       16 * h**3, 3 * 12 * h**3),
        "K8b invert": (lambda: kernels.morton3d_invert(codes),
                       lambda: morton.morton3d_invert_plain(codes), 16 * h**3, 3 * 12 * h**3),
    }
    # The floor of kernels this short: an empty kernel's time from a CUDA
    # graph, printed beside the K8a rows.
    floor_ms = graph_ms(lambda: kernels.empty_kernel(torch.device(DEVICE)))
    log(f"empty kernel (one warp): ms {floor_ms:.4f} (graph), the launch floor beside K8a")
    for kid, (fn, plain_fn, nbytes, flops) in cases.items():
        exact = torch.equal(fn(), plain_fn())
        if not exact:
            fails.append(f"{kid} differs from its plain version")
        ms = graph_ms(fn)
        host_ms = cuda_ms(fn, reps=20)
        plain_ms = cuda_ms(plain_fn, reps=5)
        b_ms, b_by = bound_ms(nbytes=nbytes, flops=flops)
        table[kid] = dict(max_abs_err=0.0 if exact else float("inf"), ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
        cold = ""
        if kid.startswith("K8a"):
            table[kid]["empty_kernel_ms"] = floor_ms
        else:
            # K8b's 33.5 MB stay in L2 across a graph's replays: its share
            # of the HBM bound is taken from the cold time.
            c_ms = cold_ms(fn)
            share = cold_share(kid, b_ms, c_ms, fails)
            table[kid].update(cold_ms=c_ms, cold_share=share)
            cold = f"; cold {c_ms:.4f}, the bound {share:.0%} of it"
        log(f"{kid}: {n if 'K8a' in kid else h**3} cells; equal to plain: {exact}; ms "
            f"{ms:.4f} (graph; {host_ms:.4f} launched one by one; empty kernel {floor_ms:.4f}"
            f"{cold}), plain_ms {plain_ms:.4f}, bound_ms {b_ms:.5f} ({b_by})")
    return launches, table


# ---------------------------------------------------------------------------
# The real-scene layouts: LLFF and Replica
# ---------------------------------------------------------------------------


def png_psnr(out_dir: Path, gt: np.ndarray) -> list:
    """PSNR of each ``frame_<i>.png`` in ``out_dir`` against ``gt[i]``
    ([N, H, W, 3] in [0, 1])."""
    from nerfstyle_torch import utils

    frames = sorted(out_dir.glob("frame_*.png"), key=lambda p: int(p.stem.split("_")[1]))
    if len(frames) != len(gt):
        raise RuntimeError(f"{len(frames)} frames in {out_dir} for {len(gt)} withheld views")
    return [utils.compute_psnr(float(np.mean((np.moveaxis(utils.parse_rgb(f), 0, -1) - g) ** 2)))
            for f, g in zip(frames, gt)]


def _union_ms(intervals) -> float:
    """The length of a union of (start, end) intervals in µs, in ms."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def read_trace(path: Path, steps: int, fails, kernels_of=TRAIN_GLOBALS) -> dict:
    """Split each traced step of a Chrome trace from the trainer's window
    (``step <n>`` ranges, ``steps`` of them): its wall time, the device's
    busy time (the union of the kernels, copies and fills its runtime calls
    issued) and kernel count, and its host time in the runtime's launch
    calls, synchronizations, device-to-host copies and other calls, and the
    rest.  A kernel of every counter of ``kernels_of`` must appear among the
    kernel events."""
    if path is None or not path.is_file() or path.stat().st_size == 0:
        fails.append(f"the trace window wrote no trace ({path})")
        return {}
    events = [e for e in json.loads(path.read_text()).get("traceEvents", []) if e.get("ph") == "X"]
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e["name"].startswith("step ")), key=lambda e: e["ts"])
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    device = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.setdefault(e.get("args", {}).get("correlation"), []).append(e)
    kernel_names = {e["name"] for v in device.values() for e in v if e["cat"] == "kernel"}
    if len(ranges) != steps:
        fails.append(f"{path.name} holds {len(ranges)} step ranges, not {steps}")
    out = {}
    for st in ranges:
        t0, t1 = st["ts"], st["ts"] + st["dur"]
        # Calls made inside another call of the same thread (cuLaunchKernel under
        # cudaLaunchKernel) belong to it.
        calls, nested = [], {}
        for e in sorted((e for e in runtime if t0 <= e["ts"] <= t1),
                        key=lambda e: (e["tid"], e["ts"])):
            top = calls[-1] if calls else None
            if top is not None and top["tid"] == e["tid"] and e["ts"] + e["dur"] <= top["ts"] + top["dur"]:
                nested.setdefault(id(top), []).append(e)
            else:
                calls.append(e)
        split = {k: [0, 0.0] for k in ("launch", "sync", "d2h", "other")}
        dev = []
        for e in calls:
            issued = [d for c in (e, *nested.get(id(e), ()))
                      for d in device.get(c.get("args", {}).get("correlation"), [])]
            dev += issued
            if "Launch" in e["name"]:
                kind = "launch"
            elif "Synchronize" in e["name"]:
                kind = "sync"
            elif "Memcpy" in e["name"] and any("DtoH" in d["name"] for d in issued):
                kind = "d2h"
            else:
                kind = "other"
            split[kind][0] += 1
            split[kind][1] += e["dur"] / 1e3
        wall = st["dur"] / 1e3
        row = {"wall_ms": wall,
               "device_busy_ms": _union_ms((d["ts"], d["ts"] + d["dur"]) for d in dev),
               "kernels": sum(d["cat"] == "kernel" for d in dev),
               **{f"{k}_calls": v[0] for k, v in split.items()},
               **{f"{k}_ms": v[1] for k, v in split.items()},
               "rest_ms": wall - sum(v[1] for v in split.values())}
        out[st["name"]] = row
    for counter, names in kernels_of.items():
        if not any(re.search(rf"(?<![A-Za-z0-9_]){n}(?![A-Za-z0-9_])", k)
                   for n in names for k in kernel_names):
            fails.append(f"{path.name} holds no kernel of {counter} ({' or '.join(names)})")
    return out


def trace_late_steps(trainer, card: str, fails, steps: int = 8) -> dict:
    """``steps`` more steps of a trained ``trainer`` through its own trace
    window (``Trainer.run`` with ``profile_dir``), split by read_trace."""
    tc = trainer.train_cfg
    tc.profile_dir, tc.profile_start, tc.profile_steps = WORK / "train_trace", trainer.iter_ctr, steps
    tc.num_iterations = trainer.iter_ctr + steps + 1  # the last step, after the window, saves
    trainer.run()
    split = read_trace(trainer.trace_path, steps, fails,
                       {k: v for k, v in TRAIN_GLOBALS.items() if k in STEP_COUNTERS})
    log_trace(split, f"the synthetic train's late steps, {card}")
    return split


def log_trace(split: dict, label: str) -> None:
    for name, r in split.items():
        log(f"trace {name} ({label}): wall {r['wall_ms']:.3f} ms, device busy "
            f"{r['device_busy_ms']:.3f} ms in {r['kernels']} kernels; launch calls "
            f"{r['launch_calls']} in {r['launch_ms']:.3f} ms, syncs {r['sync_calls']} in "
            f"{r['sync_ms']:.3f} ms, device-to-host copies {r['d2h_calls']} in "
            f"{r['d2h_ms']:.3f} ms, other runtime calls {r['other_calls']} in "
            f"{r['other_ms']:.3f} ms, the rest {r['rest_ms']:.3f} ms")
    if split:
        keys = ("wall_ms", "device_busy_ms", "kernels", "launch_calls", "launch_ms", "sync_calls",
                "sync_ms", "d2h_calls", "d2h_ms", "other_calls", "other_ms", "rest_ms")
        med = {k: float(np.median([r[k] for r in split.values()])) for k in keys}
        log(f"trace median of {len(split)} steps ({label}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))


def llff_layout():
    """The synthetic room at LLFF_DIMS written as an LLFF layout (train views
    with seg maps, test poses only) and its data config; returns the config
    and the withheld test views [N, H, W, 3]."""
    from nerfstyle_torch.data.synthetic import generate_scene, write_llff_layout

    w, h = LLFF_DIMS
    scene = WORK / f"llff_scene_{h}x{w}_v{LLFF_VIEWS}"
    generate_scene(scene, num_train=LLFF_VIEWS, num_test=LLFF_TEST_VIEWS, h=h, w=w, room=True)
    gt = write_llff_layout(scene, WORK / "llff", scale=0.33)
    (WORK / "llff_data.yaml").write_text(
        f"root_path: {WORK / 'llff'}\ntype: LLFF\nbound: 2.0\nscale: 0.33\n")
    return "llff_data.yaml", gt


def replica_layout() -> str:
    """The synthetic room's REPLICA_VIEWS train views at REPLICA_DIMS as one
    Replica trajectory, and its data config (focal_ratio the scene's fx / w)."""
    from nerfstyle_torch.data.synthetic import generate_scene, write_replica_layout

    w, h = REPLICA_DIMS
    scene = WORK / f"replica_scene_{h}x{w}_v{REPLICA_VIEWS}"
    generate_scene(scene, num_train=REPLICA_VIEWS, num_test=1, h=h, w=w, room=True)
    ratio = write_replica_layout(scene, WORK / "replica", name="room", traj=0)
    (WORK / "replica_data.yaml").write_text(
        f"root_path: {WORK / 'replica'}\ntype: Replica\nbound: 2.0\nscale: 1.0\n"
        f"replica_cfg:\n  name: room\n  focal_ratio: {ratio!r}\n  traj_ids: [0]\n")
    return "replica_data.yaml"


def real_scene_phase(card: str, fails) -> dict:
    """The LLFF and Replica loaders through the entry points at the default
    network.  LLFF: 300 steps through ``python -m nerfstyle_torch.train``
    (flip_camera 3), a late window traced (``--profile_dir``), the test split
    rendered through ``python -m nerfstyle_torch.render`` from the 300-step
    and a one-step checkpoint (PSNR against the withheld views must rise
    5 dB), and LLFF_STYLE_ITERS style iterations from the 300-step
    checkpoint; Replica: REPLICA_STEPS steps, the trainer's test PSNR (every
    8th frame) must rise 5 dB.  Each run's launches are counted on its own;
    the trace is split step by step.  Returns the runs' launches."""
    from nerfstyle_torch import train
    from nerfstyle_torch.render import cli

    runs = {}
    t_phase = t0 = time.perf_counter()
    data_cfg, gt = llff_layout()
    log(f"LLFF layout: {LLFF_VIEWS} train views of {LLFF_DIMS[0]}x{LLFF_DIMS[1]} with seg maps, "
        f"{LLFF_TEST_VIEWS} test poses in {time.perf_counter() - t0:.1f} s")
    train.main(train_argv(1, log_dir="llff_run1", data_cfg=data_cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer = train.main(train_argv(
        LLFF_STEPS, "--profile_dir", str(WORK / "llff_trace"), "--profile_start",
        str(LLFF_TRACE_START), "--profile_steps", str(LLFF_TRACE_STEPS), log_dir="llff_run",
        data_cfg=data_cfg))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    runs["llff train"] = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if (trainer.settings.flip_camera, trainer.settings.min_near) != (3, 0.2):
        fails.append(f"the LLFF run rendered with {trainer.settings}, not llff.yaml's")
    for name in TRAIN_COUNTERS:
        if runs["llff train"][name] <= 0:
            fails.append(f"the LLFF train path launched no {name} kernel")
    notfinite = int(trainer.opt_state.total_notfinite)
    if notfinite or not all(bool(torch.isfinite(v)) for v in trainer.last_losses.values()):
        fails.append(f"LLFF run: non-finite losses ({notfinite} steps skipped)")
    rays, ms, cnt = trainer.train_cfg.num_rays_per_batch, trainer.iter_ms, trainer.iter_counts
    traced = range(LLFF_TRACE_START, LLFF_TRACE_START + LLFF_TRACE_STEPS)
    late = [i for i in range(LLFF_STEPS - 50, LLFF_STEPS) if i not in traced]
    per_ray = {f"{what} {k}": float(np.mean([cnt[i][k] for i in part])) / rays
               for what, part in (("early", range(1, 16)), ("late", late))
               for k in ("num_points", "num_sig")}
    late_ms = float(np.median([ms[i] for i in late]))
    log(f"LLFF train ({card}): {LLFF_STEPS} steps of {rays} rays in {wall_s:.1f} s; step ms "
        f"median early (1-15) {np.median(ms[1:16]):.2f}, late (last 50 but the traced "
        f"{traced.start}-{traced.stop - 1}) {late_ms:.2f}, traced median "
        f"{np.median([ms[i] for i in traced]):.2f}; {rays / late_ms * 1e3:.0f} train rays/s late; "
        f"samples/ray {per_ray}; peak memory {peak_gib:.2f} GiB; launches {runs['llff train']}")
    log_trace(read_trace(trainer.trace_path, LLFF_TRACE_STEPS, fails), f"LLFF, {card}")
    ckpt = trainer.log_dir / f"iter_{LLFF_STEPS}.ckpt"
    del trainer
    torch.cuda.empty_cache()

    # The test split (poses only) through the render entry point.
    psnr, summaries = {}, {}
    trained = f"{LLFF_STEPS} steps"
    for label, path in (("one step", WORK / "llff_run1" / "iter_1.ckpt"), (trained, ckpt)):
        reset_counts()
        summaries[label] = cli.main([str(path), "--out-dims", *map(str, LLFF_DIMS), "--yes",
                                     "--out-dir", str(WORK / f"llff_render_{label.split()[0]}"),
                                     "--device", DEVICE])
        runs["llff render"] = read_counts()
        psnr[label] = png_psnr(summaries[label]["out_dir"], gt)
    for name in RENDER_COUNTERS:
        if runs["llff render"][name] <= 0:
            fails.append(f"the LLFF render launched no {name} kernel")
    summ = summaries[trained]
    mean = {k: float(np.mean(v)) for k, v in psnr.items()}
    log(f"LLFF render ({card}): {summ['frames']} test views at {LLFF_DIMS[0]}x{LLFF_DIMS[1]}, "
        f"frame ms first {summ['frame_ms'][0]:.1f}, median of the rest "
        f"{np.median(summ['frame_ms'][1:]):.1f} ({summ['fps']:.2f} FPS over all), "
        f"{summ['num_marched'] / summ['frames'] / np.prod(LLFF_DIMS):.2f} samples/ray marched; "
        f"PSNR against the withheld views: one step {mean['one step']:.3f} dB, {trained} "
        f"{mean[trained]:.3f} dB ({['%.2f' % v for v in psnr[trained]]}); launches "
        f"{runs['llff render']}")
    if not mean[trained] >= mean["one step"] + 5.0:
        fails.append(f"LLFF render PSNR rose from {mean['one step']:.3f} to "
                     f"{mean[trained]:.3f} dB, less than 5 dB")

    # The style stage on the LLFF checkpoint.
    _, style_png, seg_npz = style_assets(fails)
    reset_counts()
    t0 = time.perf_counter()
    st = train.main(["--device", DEVICE, "--ckpt", str(ckpt), "--log-dir", str(WORK / "llff_style"),
                     "--data-cfg", str(WORK / data_cfg), "--style-image", str(style_png),
                     "--style_seg_path", str(seg_npz), "--max_steps", "512", "--num_iterations",
                     str(LLFF_STYLE_ITERS), "--intervals.test", "0", "--intervals.print", "10",
                     "--intervals.log", "0", "--intervals.ckpt", str(LLFF_STYLE_ITERS), "--yes"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    runs["llff style"] = read_counts()
    for name in STYLE_COUNTERS:
        if runs["llff style"][name] <= 0:
            fails.append(f"the LLFF style run launched no {name} kernel")
    style = np.array([float(h["style"]) for h in st.loss_history])
    total = np.array([float(h["total"]) for h in st.loss_history])
    if len(style) != LLFF_STYLE_ITERS or not (np.isfinite(style).all() and np.isfinite(total).all()):
        fails.append(f"LLFF style run: {len(style)} iterations, losses finite: "
                     f"{np.isfinite(total).all()}")
    elif not style[-5:].mean() < style[0]:
        fails.append(f"LLFF style term did not fall: first {style[0]}, last 5 mean "
                     f"{style[-5:].mean()}")
    log(f"LLFF style ({card}): {LLFF_STYLE_ITERS} iterations at {LLFF_DIMS[0]}x{LLFF_DIMS[1]} in "
        f"{wall_s:.2f} s through the entry point ({sum(st.iter_ms) / 1e3:.2f} s of iterations, "
        f"{len(st.cache_stats)} cache builds, median iteration {np.median(st.iter_ms):.2f} ms); "
        f"style term first {style[0]:.5f}, last-5 mean {style[-5:].mean():.5f}; launches "
        f"{runs['llff style']}")
    del st
    torch.cuda.empty_cache()

    # A Replica trajectory.
    data_cfg = replica_layout()
    reset_counts()
    t0 = time.perf_counter()
    trainer = train.main(train_argv(REPLICA_STEPS, "--test_before_train", log_dir="replica_run",
                                    data_cfg=data_cfg))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    runs["replica train"] = read_counts()
    for name in TRAIN_COUNTERS:  # fewer steps than update_thres: no scatter-max
        if name != "occupancy_scatter_max" and runs["replica train"][name] <= 0:
            fails.append(f"the Replica train path launched no {name} kernel")
    notfinite = int(trainer.opt_state.total_notfinite)
    if notfinite or not all(bool(torch.isfinite(v)) for v in trainer.last_losses.values()):
        fails.append(f"Replica run: non-finite losses ({notfinite} steps skipped)")
    untrained, final = trainer.test_history[0], trainer.test_networks()
    ms = trainer.iter_ms
    log(f"Replica train ({card}): {len(trainer.train_set)} train / {len(trainer.test_set)} test "
        f"views of {REPLICA_DIMS[0]}x{REPLICA_DIMS[1]} (focal {trainer.train_set.intr.fx:.1f}), "
        f"{REPLICA_STEPS} steps in {wall_s:.1f} s, step ms median early (1-15) "
        f"{np.median(ms[1:16]):.2f}, late (last 50) {np.median(ms[-50:]):.2f}; test PSNR untrained "
        f"{untrained['psnr']:.3f} dB, after {final['psnr']:.3f} dB; launches {runs['replica train']}")
    if not final["psnr"] >= untrained["psnr"] + 5.0:
        fails.append(f"Replica run: test PSNR rose from {untrained['psnr']:.3f} to "
                     f"{final['psnr']:.3f} dB, less than 5 dB")
    del trainer
    torch.cuda.empty_cache()
    log(f"real-scene phase ran {time.perf_counter() - t_phase:.1f} s")
    return runs



# ---------------------------------------------------------------------------
# The style path
# ---------------------------------------------------------------------------


def jpeg_decode_ms(fails) -> dict:
    """Host time of the port's JPEG decode (``imageio.jpeg.read_jpeg``) of
    the 1008x756 4:2:0 frame, baseline and progressive, three decodes each;
    each decode's SHA256 must be PIL's.  Also the small CMYK JPEG, equal to
    PIL's array.  Set-up work (style images, dataset frames), not the hot
    path.  Returns the times by file."""
    import hashlib

    from nerfstyle_torch.imageio.jpeg import read_jpeg

    times = {}
    for path, sha in ((ROOM_JPEG, ROOM_JPEG_SHA256), (ROOM_PROGRESSIVE, ROOM_PROGRESSIVE_SHA256)):
        want = sha.read_text().split()[0]
        times[path.name] = []
        for _ in range(3):
            t = time.perf_counter()
            img = read_jpeg(path)
            times[path.name].append((time.perf_counter() - t) * 1e3)
        got = hashlib.sha256(img.tobytes()).hexdigest()
        if img.shape != (756, 1008, 3) or got != want:
            fails.append(f"{path.name} decodes to shape {img.shape}, SHA256 {got}; PIL's is {want}")
        log(f"JPEG decode on the host ({path.name}, {path.stat().st_size} bytes, 1008x756 "
            f"4:2:0): {['%.1f' % t for t in times[path.name]]} ms; SHA256 equal to PIL's "
            f"decode: {got == want}")
    cmyk, want = read_jpeg(CMYK_JPEG), np.load(CMYK_JPEG_PIL)
    if cmyk.shape != want.shape or not np.array_equal(cmyk, want):
        fails.append(f"{CMYK_JPEG.name} decodes to other values than PIL's array")
    log(f"CMYK JPEG {CMYK_JPEG.name}: shape {cmyk.shape}, equal to PIL's array: "
        f"{cmyk.shape == want.shape and np.array_equal(cmyk, want)}")
    return times


def style_assets(fails):
    """The 504x378 synthetic scene with its data YAML, the style image (a
    256x192 gradient with stripes, a baseline 4:2:0 JPEG written by PIL:
    the README's ``--style-image style.jpg`` route) and its 4-quadrant
    segment map.  The port's decode of the JPEG must equal the array PIL
    decoded from it, bit for bit."""
    from nerfstyle_torch import utils

    from nerfstyle_torch.data.synthetic import generate_scene

    w, h = STYLE_DIMS
    scene = WORK / f"style_scene_{h}x{w}_v{STYLE_VIEWS}"
    generate_scene(scene, num_train=STYLE_VIEWS, num_test=STYLE_TEST_VIEWS, h=h, w=w)
    data_cfg = WORK / "style_data.yaml"
    data_cfg.write_text(f"root_path: {scene}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    got = np.moveaxis(utils.parse_rgb(STYLE_JPEG), 0, -1)
    want = np.load(STYLE_JPEG_PIL).astype(np.float32) / 255.0
    if got.shape != want.shape or not np.array_equal(got, want):
        fails.append(f"the style JPEG decodes to other values than PIL's: shape {got.shape} vs "
                     f"{want.shape}, max abs err "
                     f"{float(np.abs(got - want).max()) if got.shape == want.shape else 'n/a'}")
    log(f"style image {STYLE_JPEG.relative_to(ROOT)} ({STYLE_JPEG.stat().st_size} bytes): the "
        f"port's decode equals PIL's bit for bit: {np.array_equal(got, want)}")
    yy, xx = np.meshgrid(np.linspace(0, 1, want.shape[0]), np.linspace(0, 1, want.shape[1]),
                         indexing="ij")
    seg_npz = WORK / "style_seg.npz"
    np.savez(seg_npz, seg_map=(yy > 0.5).astype(np.int64) * 2 + (xx > 0.5).astype(np.int64))
    return data_cfg, STYLE_JPEG, seg_npz


def style_phase(card: str, ckpt: Path, fails):
    """The style path through ``python -m nerfstyle_torch.train`` (in-process)
    from the train phase's checkpoint; returns the trainer and its launches."""
    from nerfstyle_torch import train
    from nerfstyle_torch.training import checkpoint as ckpt_lib

    t0 = time.perf_counter()
    data_cfg, style_img, seg_npz = style_assets(fails)
    log(f"style assets: {STYLE_DIMS[0]}x{STYLE_DIMS[1]} scene of {STYLE_VIEWS} + "
        f"{STYLE_TEST_VIEWS} views, style image and segment map in "
        f"{time.perf_counter() - t0:.1f} s")
    argv = ["--device", DEVICE, "--ckpt", str(ckpt), "--log-dir", str(WORK / "style"),
            "--data-cfg", str(data_cfg), "--style-image", str(style_img),
            "--style_seg_path", str(seg_npz), "--max_steps", "512", "--test_before_train",
            "--intervals.test", "0", "--intervals.print", "20", "--intervals.log", "0",
            "--intervals.ckpt", "200", "--yes"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    st = train.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
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
    # The trainer's test pass (the flags above toggle style.yaml's
    # test_before_train off): the test views' collages as video.gif.
    st.test_networks()
    gif = WORK / "style" / "epoch_{:0{w}d}".format(st.iter_ctr, w=len(str(n_iter))) / "video.gif"
    n_gif = gif_frames(gif) if gif.exists() else 0
    if n_gif != STYLE_TEST_VIEWS:
        fails.append(f"{gif} holds {n_gif} frames (exists: {gif.exists()}), want one a test "
                     f"view ({STYLE_TEST_VIEWS})")
    log(f"style video.gif: {n_gif} frames, {gif.stat().st_size if gif.exists() else 0} bytes")

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


def style_step_vs_plain(st, fails) -> dict:
    """One style step with the kernels and the same step with every plain
    version, from the same params and pose cache.  Loss terms: 1e-5
    relative.  The colour-table gradient: relative L2 error 5e-3 with the
    step's discrete choices (class map, nearest style features, VGG16's ReLU
    masks and max-pool picks) pinned to the plain step's in both steps (K2's
    atomics, fp32 sums in another order, bf16 rounding steps); unpinned, a
    rounding-sized change of the forward flips a few of them, which moves a
    flipped pixel's gradient and not the loss (the error split below).  The
    flips, of each kind at most STYLE_FLIP_BOUND.  The unpinned error is
    logged.  Returns the numbers."""
    pose = next(iter(st._geom_cache))
    cache = st.geom_cache(pose)
    k, p = style_step_run(st, cache), style_step_run(st, cache, True)
    kp, pp = style_step_run(st, cache, pin=p[2]), style_step_run(st, cache, True, pin=p[2])
    ck, cp = k[3], p[3]
    missing = [c for c in STYLE_STEP_COUNTERS if ck[c] <= 0]
    if missing:
        fails.append(f"the style step launched no {missing}")
    if any(cp.values()) or any(pp[3].values()):
        fails.append(f"the plain style step launched kernels: {cp}")
    loss_err = {n: abs(float(k[0][n]) - float(v)) / max(abs(float(v)), 1e-30)
                for n, v in p[0].items()}
    out = {"unpinned": rel_l2(k[1], p[1]), "pinned": rel_l2(kp[1], pp[1]),
           "flips": k[2].flips(p[2]), "loss": loss_err}
    log(f"style step with kernels vs plain (pose {pose}): loss relative errors {loss_err}; "
        f"color-table gradient relative L2 error {out['pinned']:.3e} with every discrete choice "
        f"pinned to the plain step's (tol 5e-3), {out['unpinned']:.3e} unpinned; flips "
        f"{out['flips']} (at most {STYLE_FLIP_BOUND}) of {p[2].sizes()}; launches a step {ck}")
    if not all(e <= 1e-5 for e in loss_err.values()):
        fails.append(f"style step losses differ from the plain step: {loss_err}")
    if not out["pinned"] <= 5e-3:
        fails.append(f"style step gradient differs from the plain step with the choices "
                     f"pinned: {out['pinned']}")
    over = {n: v for n, v in out["flips"].items() if v > STYLE_FLIP_BOUND[n]}
    if over:
        fails.append(f"the style step's discrete choices flipped more than "
                     f"{STYLE_FLIP_BOUND}: {over}")
    return out


# ---------------------------------------------------------------------------
# The style step's gradient against its plain step, split by source
#
# A style step makes discrete choices from values the kernels compute: the
# class argmax that segments the frame (StyleTrainer._preds), each relu3
# pixel's nearest style feature (torch.amin over the masked cosine
# distances, SemanticStyleLoss), and inside VGG16 every ReLU's mask and
# every max-pool's pick.  A near-tie that a rounding difference in the
# forward flips moves the gradient and not the loss.  StepChoices records a
# step's choices, or pins them to another step's, and style_step_run routes
# kernel families to their plain versions, each by wrapping functions for
# the length of one step: the package has no switch for it.
# ---------------------------------------------------------------------------


class _Proxy:
    """A module whose names are ``base``'s, except those given."""

    def __init__(self, base, **names):
        self._base, self._names = base, names

    def __getattr__(self, name):
        return self._names[name] if name in self._names else getattr(self._base, name)


class StepChoices:
    """The discrete choices of one style step, in the order the step makes
    them: ``preds`` (the class map), ``nearest`` (each relu3 pixel's style
    feature), ``relu`` (VGG16's masks), ``pool`` (its max-pool picks).
    Given ``pinned`` choices, the step takes those instead of its own."""

    KINDS = ("preds", "nearest", "relu", "pool")

    def __init__(self, pinned: "StepChoices" = None):
        self.pinned = pinned
        self.made = {k: [] for k in self.KINDS}
        self.pool_live = []

    def _take(self, kind, own):
        i = len(self.made[kind])
        choice = own() if self.pinned is None else self.pinned.made[kind][i]
        self.made[kind].append(choice)
        return choice

    def preds(self, st, cls):
        return self._take("preds", lambda: type(st)._preds(st, cls))

    def amin(self, t, dim):
        idx = self._take("nearest", lambda: torch.argmin(t, dim=dim))
        if self.pinned is None:
            return torch.amin(t, dim=dim)
        return t.gather(dim, idx[:, None]).squeeze(dim)

    def relu(self, x):
        from nerfstyle_torch.models.vgg import _Relu

        mask = self._take("relu", lambda: x > 0)
        return _Relu.apply(x) if self.pinned is None else torch.where(mask, x, 0.0)

    def max_pool2d(self, x, k, s):
        if self.pinned is None:
            out, idx = torch.nn.functional.max_pool2d(x, k, s, return_indices=True)
            self.made["pool"].append(idx)
            self.pool_live.append(out > 0)
            return out
        idx = self._take("pool", None)
        return x.flatten(-2).gather(-1, idx.flatten(-2)).view(idx.shape)

    def flips(self, other: "StepChoices") -> dict:
        """Choices that differ from ``other``'s, by kind; a max-pool pick
        only where ``other``'s window max is above 0 (after a ReLU a window
        of zeros is a tie whose pick takes no gradient)."""
        out = {k: sum(int((a != b).sum()) for a, b in zip(self.made[k], other.made[k]))
               for k in self.KINDS}
        out["pool"] = sum(int(((a != b) & live).sum()) for a, b, live in
                          zip(self.made["pool"], other.made["pool"], other.pool_live))
        return out

    def sizes(self) -> dict:
        return {k: sum(c.numel() for c in self.made[k]) for k in self.KINDS}


def _style_families(spec):
    """Kernel family -> {wrapper name in nerfstyle_torch.kernels: its plain
    version with the wrapper's signature}, for a style step."""
    from nerfstyle_torch.ops import compositing, hashgrid
    from nerfstyle_torch.ops.mlp import mlp_apply_plain

    def act(sigmoid):
        return "sigmoid" if sigmoid else None

    def dtype(bf16):
        return torch.bfloat16 if bf16 else torch.float32

    def mlp_backward(x, weights, g, sigmoid, bf16, need_dw):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            ws = [w.detach().requires_grad_(bool(n)) for w, n in zip(weights, need_dw)]
            out = mlp_apply_plain(ws, xr, act(sigmoid), dtype(bf16))
            wanted = [xr] + [w for w, n in zip(ws, need_dw) if n]
            grads = list(torch.autograd.grad(out, wanted, g))
        dx, dws = grads[0], iter(grads[1:])
        return dx, [next(dws) if n else None for n in need_dw]

    return {
        "K1": {"hashgrid_encode": lambda x, table, levels, style_term=0:
               hashgrid.hashgrid_encode_plain(spec, table, x)},
        "K5 forward": {"mlp_forward": lambda x, weights, sigmoid, bf16:
                       mlp_apply_plain(weights, x, act(sigmoid), dtype(bf16))},
        "K5 backward": {"mlp_backward": mlp_backward},
        "K7/K7b": {"segment_sum": compositing.segment_sum_plain,
                   "segment_sum_backward": compositing.segment_sum_backward_plain},
        "K2": {"hashgrid_backward": lambda x, g, levels, num_rows, style_term=0:
               hashgrid.hashgrid_backward_plain(spec, x, g, num_rows)},
    }


def style_step_run(st, cache, plain=False, route=(), pin=None, nudge=0.0):
    """One style step over ``cache``: (losses, colour-table gradient, its
    StepChoices, its kernel launches).  ``route`` names kernel families run as their plain
    versions; ``pin`` (a StepChoices) pins the discrete choices to its
    own; ``nudge`` scales the rendered image by 1 + nudge * (+-1 a value,
    from a fixed seed), a rounding-sized change of the forward."""
    from unittest import mock

    from nerfstyle_torch import kernels
    from nerfstyle_torch.losses import style as style_loss
    from nerfstyle_torch.models import vgg

    choices = StepChoices(pin)
    render = st.render_cache
    kernels.reset_launch_counts()

    def nudged(params, cache, plain=False):
        rgb, cls = render(params, cache, plain)
        sign = torch.randint(0, 2, rgb.shape, generator=torch.Generator(rgb.device).manual_seed(5),
                             device=rgb.device) * 2.0 - 1.0
        return rgb * (1.0 + nudge * sign), cls

    families = _style_families(st.field_spec.grid)
    with contextlib.ExitStack() as stack:
        for fam in route:
            for name, fn in families[fam].items():
                stack.enter_context(mock.patch.object(kernels, name, fn))
        stack.enter_context(mock.patch.object(st, "_preds", lambda cls: choices.preds(st, cls)))
        stack.enter_context(mock.patch.object(style_loss, "torch",
                                              _Proxy(torch, amin=choices.amin)))
        stack.enter_context(mock.patch.object(vgg, "relu", choices.relu))
        stack.enter_context(mock.patch.object(vgg, "F", _Proxy(
            torch.nn.functional, max_pool2d=choices.max_pool2d)))
        if nudge:
            stack.enter_context(mock.patch.object(st, "render_cache", nudged))
        losses, grads = st.loss_and_grads(cache, plain=plain)
    torch.cuda.synchronize()
    return losses, grads["x_color_embedder"], choices, dict(kernels.launch_counts)


def style_error_split(st, poses: int = 4) -> None:
    """The style step's colour-table gradient error against the plain step,
    split by source, on the first pose cache: each step's run-to-run noise,
    the error with one kernel family at a time routed to its plain version,
    the flips of the discrete choices, the plain step against itself with
    its image nudged by one rounding step, and the errors with the plain
    step's choices pinned in both steps (also with each family routed).
    Then the unpinned and pinned errors and the flips on ``poses`` poses."""
    keys = list(st._geom_cache)[:poses]
    cache = st.geom_cache(keys[0])
    run = lambda plain=False, **kw: style_step_run(st, cache, plain, **kw)  # noqa: E731
    k1, k2, p1, p2 = run(), run(), run(True), run(True)
    pp, kp = run(True, pin=p1[2]), run(pin=p1[2])
    fams = list(_style_families(st.field_spec.grid))
    nudged = run(True, nudge=2.0**-23)
    out = {
        "kernel noise": rel_l2(k2[1], k1[1]),
        "plain noise": rel_l2(p2[1], p1[1]),
        "unpinned": rel_l2(k1[1], p1[1]),
        "routed": {f: rel_l2(run(route=(f,))[1], p1[1]) for f in fams},
        "all routed": rel_l2(run(route=fams)[1], p1[1]),
        "flips": k1[2].flips(p1[2]),
        "nudged plain": rel_l2(nudged[1], p1[1]),
        "nudged flips": nudged[2].flips(p1[2]),
        "nudged pinned": rel_l2(run(True, nudge=2.0**-23, pin=p1[2])[1], pp[1]),
        "pinned": rel_l2(kp[1], pp[1]),
        "pinned routed": {f: rel_l2(run(route=(f,), pin=p1[2])[1], pp[1]) for f in fams},
        "pinned loss equal": all(float(pp[0][k]) == float(v) for k, v in p1[0].items()),
    }
    fmt = lambda d: {f: f"{e:.3e}" for f, e in d.items()}  # noqa: E731
    log(f"style step error split (pose {keys[0]}): kernel step against itself "
        f"{out['kernel noise']:.3e}, plain step against itself {out['plain noise']:.3e}; kernel "
        f"against plain {out['unpinned']:.3e}; one family routed to plain {fmt(out['routed'])}, "
        f"all routed {out['all routed']:.3e}; flips {out['flips']} of {p1[2].sizes()}; the plain "
        f"step with its image nudged by 2^-23 (relative, +-1 a value) {out['nudged plain']:.3e}, "
        f"flips {out['nudged flips']}, pinned {out['nudged pinned']:.3e}; kernel against plain "
        f"with every choice pinned (the plain step's) {out['pinned']:.3e} (pinned plain loss "
        f"equal to its unpinned loss: {out['pinned loss equal']}); pinned, one family routed "
        f"{fmt(out['pinned routed'])}")
    for key in keys:
        cache = st.geom_cache(key)
        k, p = run(), run(True)
        kp, pp = run(pin=p[2]), run(True, pin=p[2])
        log(f"style step, pose {key}: kernel against plain {rel_l2(k[1], p[1]):.3e}, every "
            f"choice pinned {rel_l2(kp[1], pp[1]):.3e}; flips {k[2].flips(p[2])}")


def style_chunk(st):
    """K4's stream at a style cache build, as ``_build_geom_cache`` hands it
    over: the second CHUNK_RAYS rays of the first pose (the middle chunk of
    a 504x378 pose's three), marched, with their densities (density_scale
    applied): (sigmas, tau, offsets, dt, t_thresh)."""
    from nerfstyle_torch.core.types import make_rays
    from nerfstyle_torch.models.fields import field_density
    from nerfstyle_torch.ops.aabb import near_far_from_aabb
    from nerfstyle_torch.ops.marching import march_rays
    from nerfstyle_torch.render.renderer import CHUNK_RAYS, FIELD_BATCH, _batched

    s, plan, r = st.settings, st.renderer.plan, st.renderer
    cam_dirs, _, _ = st._frame_grid()
    pose = st._poses_dev[0]
    rays = make_rays(pose[:3, 3], cam_dirs @ pose[:3, :3].T)
    i = min(CHUNK_RAYS, max(rays.dirs.shape[0] - CHUNK_RAYS, 0))
    o = rays.origins[i:i + CHUNK_RAYS].contiguous()
    d = rays.dirs[i:i + CHUNK_RAYS].contiguous()
    nears, fars = near_far_from_aabb(o, d, plan.aabb(o.device), plan.min_near)
    with torch.no_grad():
        sb = march_rays(plan, r.occ_field, o, d, nears, fars)
        sig = _batched(lambda x: field_density(st.field_spec, st.params, r.bbox, x,
                                               st.compute_dtype), sb.xyz, FIELD_BATCH)
    return (sig * s.density_scale).contiguous(), sb.tau, sb.offsets, plan.dt, s.t_thresh


def style_kernel_phases(st, fails):
    """K1 and K2 on a pose's cached stream, K5 (the three color heads)
    forward and backward, and K7b, at the style stream's shape, and K4 on a
    pose's marched chunk, against their plain versions; returns their table
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
    what = "a style pose's cached samples (color)"
    table["K1 style"] = k1_row(st.field_spec.grid, params["x_color_embedder"].detach(), x, what,
                               fails)
    table["K2 style"] = k2_row(st.field_spec.grid, x, params["x_color_embedder"].shape[1], what,
                               torch.Generator(device=dev).manual_seed(12), fails)
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

    def bwd_plain(chain=mlp_apply_plain):
        outs = []
        for (w, hh, act), g in zip(heads, gs):
            xr = hh.detach().requires_grad_(True)
            outs.append(torch.autograd.grad(chain(w, xr, act, dtype), xr, g))
        return outs

    lib_errs = [library_check(w, hh, act, dtype, fails, f"head {i} at the style stream")
                for i, (w, hh, act) in enumerate(heads)]
    with torch.no_grad():
        f_ms = cuda_ms(lambda: fwd(False), reps=10)
        f_plain = cuda_ms(lambda: fwd(True), reps=5)
        with cublas_fp32_sums():
            f_lib = cuda_ms(lambda: [mlp_library_chain(w, hh, act, dtype)
                                     for w, hh, act in heads], reps=10)
        b_ms = cuda_ms(bwd, reps=10)
        head_f_ms = [cuda_ms(lambda w=w, hh=hh, act=act: mlp_apply(w, hh, act, dtype), reps=10)
                     for w, hh, act in heads]
        head_ms = [cuda_ms(lambda w=w, hh=hh, act=act, g=g: kernels.mlp_backward(
            hh, w, g, act == "sigmoid", bf16, [False] * len(w)), reps=10)
            for (w, hh, act), g in zip(heads, gs)]
    b_plain = cuda_ms(bwd_plain, reps=5)
    with cublas_fp32_sums():
        b_lib = cuda_ms(lambda: bwd_plain(mlp_library_chain), reps=5)
    grids = [kernels.mlp_backward_grid(n_rows, w[0].shape[0], len(w) - 1, w[-1].shape[1])
             for w, _, _ in heads] if bf16 else None
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
                        bound_ms=bb_ms, bound_by=bb_by, library_ms=b_lib)
    log(f"K5 color heads at the style stream ({n_rows} rows, {dtype}, layer widths {dims}): max "
        f"abs err (out, d x) {errs}; cuBLAS chain against plain {lib_errs}; forward ms "
        f"{f_ms:.3f} (a head: {['%.3f' % t for t in head_f_ms]}; plain {f_plain:.3f}, cuBLAS "
        f"chain {f_lib:.3f}), bound_ms {fb_ms:.4f} ({fb_by}); backward ms {b_ms:.3f} (a head: "
        f"{['%.3f' % t for t in head_ms]}, grids {grids} CTAs; plain forward + autograd "
        f"{b_plain:.3f}, cuBLAS chain + autograd {b_lib:.3f}), bound_ms {bb_ms:.4f} ({bb_by})")

    table["K4 style"] = k4_row(*style_chunk(st), "a style pose's marched chunk (the cache "
                               "build)", fails)[0]

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
    again, _ = kernels.segment_sum_backward(w, None, g, offsets)
    if not torch.equal(d_ch, again):
        fails.append("K7b: two launches on the same inputs gave different bits")
    ms = graph_ms(lambda: kernels.segment_sum_backward(w, None, g, offsets))
    host_ms = cuda_ms(lambda: kernels.segment_sum_backward(w, None, g, offsets), reps=20)
    plain_ms = cuda_ms(lambda: compositing.segment_sum_backward_plain(w, None, g, offsets),
                       reps=10)
    b_ms, b_by = bound_ms(n_rows * 4 + n_pix * cc * 4 + (n_pix + 1) * 8 + n_rows * cc * 4,
                          n_rows * cc)
    table["K7b"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None)
    log(f"K7b segment_sum_backward: {n_rows} samples x {cc} channels over {n_pix} rays; equal "
        f"to plain: {torch.equal(d_ch, ref)}; {ray_length_stats(offsets)}; ms {ms:.4f} (graph; "
        f"{host_ms:.4f} launched one by one), plain_ms {plain_ms:.3f}, bound_ms {b_ms:.4f} "
        f"({b_by})")
    return table


# ---------------------------------------------------------------------------
# The two-pass style scheme
# ---------------------------------------------------------------------------


def two_pass_check(st, pose: int, gen, what: str, fails) -> dict:
    """On one pose with the trainer's params: (a) the two-pass loss (pass 1,
    the pixel gradient) against the cached step's at style_geom_cache_eps 0
    (the same samples: 1e-4 relative); (b) pass 2's colour-table gradient
    for a fixed random cotangent, summed over the windows, against one VJP
    through the eps-0 cache (5e-3 relative L2: float sums in other orders,
    bf16 rounding steps, and no discrete choice to flip); (c) the same pass
    2 with the kernels against every plain version (5e-3 relative L2; K2,
    K4b and K5 on the window streams must launch).  The cache's view
    directions ride along where the field reads them.  Returns the
    numbers."""
    from nerfstyle_torch import kernels

    eps = st.train_cfg.style_geom_cache_eps
    st.train_cfg.style_geom_cache_eps = 0.0
    cache = st._build_geom_cache(pose)
    st.train_cfg.style_geom_cache_eps = eps
    losses_c, _ = st.loss_and_grads(cache)
    rgb, cls = st.render_frame(st.params, pose)
    losses_t, _ = st.pixel_grad(rgb, st.target(pose), st._preds(cls))
    loss_err = abs(float(losses_t["total"]) - float(losses_c["total"])) / abs(
        float(losses_c["total"]))
    table = st.params["x_color_embedder"]
    cot = torch.randn(rgb.shape, generator=gen, device=rgb.device)
    kernels.reset_launch_counts()
    g_win = st.window_grads(st.params, pose, cot)["x_color_embedder"]
    torch.cuda.synchronize()
    launched = {c: kernels.launch_counts[c] for c in ("hashgrid_backward", "composite_backward",
                                                      "mlp_backward")}
    rgb_c, _ = st.render_cache(st.params, cache)
    (g_cache,) = torch.autograd.grad(rgb_c, table, cot)
    g_plain = st.window_grads(st.params, pose, cot, plain=True)["x_color_embedder"]
    out = {"loss": loss_err, "cache": rel_l2(g_win, g_cache), "plain": rel_l2(g_win, g_plain),
           "launched": launched}
    log(f"two-pass checks ({what}, pose {pose}): (a) loss against the eps-0 cached step "
        f"{loss_err:.3e} relative (tol 1e-4; {float(losses_t['total']):.6f} vs "
        f"{float(losses_c['total']):.6f}); (b) pass 2's gradient against one VJP through the "
        f"eps-0 cache {out['cache']:.3e} relative L2 (tol 5e-3); (c) pass 2 with the kernels "
        f"against plain {out['plain']:.3e} (tol 5e-3); window backward launches {launched}")
    if not loss_err <= 1e-4:
        fails.append(f"two-pass ({what}): loss {loss_err} off the eps-0 cached step's")
    if not out["cache"] <= 5e-3:
        fails.append(f"two-pass ({what}): pass 2's gradient {out['cache']} off the cache's VJP")
    if not out["plain"] <= 5e-3:
        fails.append(f"two-pass ({what}): pass 2's gradient {out['plain']} off its plain version")
    if not all(launched.values()):
        fails.append(f"two-pass ({what}): pass 2 launched no window backward kernel: {launched}")
    return out


def two_pass_stream_rows(st, pose: int, gen, fails) -> dict:
    """K1 and K4 on the two-pass streams as the passes hand them over (a
    pass-1 chunk of 2^16 rays, the middle of the pose's three, and pass 2's
    top middle window of 200 x 200 rays; phase A: marched samples, density
    table; phase B: the kept prefix, the fused [T, 4] tables), K2 and K4b
    on the window's phase B, against their plain versions; returns their
    table entries."""
    from nerfstyle_torch.models.fields import field_apply
    from nerfstyle_torch.render.renderer import CHUNK_RAYS

    grid, params, spec, s = st.field_spec.grid, st.params, st.field_spec, st.settings
    plan, bbox = st.renderer.plan, st.renderer.bbox
    fused = torch.cat([params["x_density_embedder"], params["x_color_embedder"]], dim=1).detach()
    rays = st.pose_rays(pose)
    i = min(CHUNK_RAYS, max(len(rays) - CHUNK_RAYS, 0))
    tiles = st.window_tiling()[0]
    win = tiles[min(1, tiles.shape[0] - 1)]
    streams = {
        "frame": ("a pass-1 chunk", rays.origins[i:i + CHUNK_RAYS].contiguous(),
                  rays.dirs[i:i + CHUNK_RAYS].contiguous()),
        "window": ("a pass-2 window", rays.origins[win].contiguous(), rays.dirs[win].contiguous()),
    }
    table = {}
    for name, (what, o, d) in streams.items():
        b = marched_batch(st, o, d)
        sb, keep = b["sb"], b["keep"]
        with torch.no_grad():
            ch, sig = field_apply(spec, params, bbox, sb.xyz[keep], st.compute_dtype)
        sig = (sig * s.density_scale).contiguous()
        tau = sb.tau[keep].contiguous()
        table[f"K1 two-pass {name} A"] = k1_row(
            grid, params["x_density_embedder"].detach(), b["x_a"],
            f"{what}'s marched samples (phase A, density)", fails)
        table[f"K1 two-pass {name} B"] = k1_row(grid, fused, b["x_b"],
                                                f"{what}'s kept samples (phase B, fused [T, 4])",
                                                fails)
        table[f"K4 two-pass {name} A"], _ = k4_row(b["sig_a"], sb.tau, sb.offsets, plan.dt,
                                                   s.t_thresh, f"{what}'s marched samples "
                                                   "(phase A)", fails)
        table[f"K4 two-pass {name} B"], _ = k4_row(sig, tau, b["offsets"], plan.dt, s.t_thresh,
                                                   f"{what}'s kept prefix (phase B)", fails)
        if name == "window":
            table["K2 two-pass window B"] = k2_row(
                grid, b["x_b"], fused.shape[1],
                f"{what}'s kept samples (phase B, fused [T, 4]; the density half dropped)", gen,
                fails)
            table["K4b two-pass window B"] = k4b_row(sig, ch, tau, b["offsets"], plan.dt,
                                                     s.t_thresh, f"{what}'s kept prefix "
                                                     "(phase B)", gen, fails)
    return table


def style_two_pass_phase(card: str, ckpt: Path, cached_ms: float, fails):
    """The two-pass style scheme through ``python -m nerfstyle_torch.train
    ... --style_geom_cache`` (in-process) from the train phase's checkpoint,
    on the style path's scene, TWO_PASS_ITERS iterations with their launch
    counters set to 0 just before and read just after: its kernels must
    launch, each on its two-pass streams, the losses must be finite, no Adam
    step skipped, the mean style term of the last 10 iterations below the
    first, and only x_color_embedder may move in the written checkpoint.
    Logs the median iteration and its split beside the cached path's
    (``cached_ms``), peak memory, launches an iteration by stream, and one
    profiled iteration.  Then two_pass_check, again with the view-direction
    field (the trainer's field_spec and color2 head replaced, as a library
    user reaches it: K5d's assemble entry must launch in its cache and
    pass 2, and one cached render within 2e-3 of plain), and the two-pass
    streams' kernel rows.  Returns the run's launches and the rows."""
    from nerfstyle_torch import kernels, train
    from nerfstyle_torch.models.fields import field_init
    from nerfstyle_torch.training import checkpoint as ckpt_lib

    data_cfg, style_img, seg_npz = style_assets(fails)
    argv = ["--device", DEVICE, "--ckpt", str(ckpt), "--log-dir", str(WORK / "style_two_pass"),
            "--data-cfg", str(data_cfg), "--style-image", str(style_img),
            "--style_seg_path", str(seg_npz), "--max_steps", "512", "--test_before_train",
            "--style_geom_cache", "--num_iterations", str(TWO_PASS_ITERS),
            "--intervals.test", "0", "--intervals.print", "10", "--intervals.log", "0",
            "--intervals.ckpt", str(TWO_PASS_ITERS), "--yes"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    st = train.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if st.train_cfg.style_geom_cache or st._geom_cache:
        fails.append("the two-pass run took the cached path")
    for name in (*TWO_PASS_COUNTERS, *TWO_PASS_STREAM_COUNTERS):
        if launches.get(name, 0) <= 0:
            fails.append(f"two-pass style path launched no {name} kernel")
    hist = {k: np.array([float(h[k]) for h in st.loss_history]) for k in ("content", "style",
                                                                         "total")}
    notfinite = int(st.opt_state.total_notfinite)
    if notfinite or not all(np.isfinite(v).all() for v in hist.values()):
        fails.append(f"two-pass style losses not finite ({notfinite} steps skipped)")
    if len(st.loss_history) != TWO_PASS_ITERS:
        fails.append(f"the two-pass run took {len(st.loss_history)} of {TWO_PASS_ITERS} "
                     f"iterations")
    first, last10 = float(hist["style"][0]), float(hist["style"][-10:].mean())
    if not last10 < first:
        fails.append(f"the two-pass style term did not fall: first {first}, last 10 mean "
                     f"{last10}")
    _, before = ckpt_lib.load_checkpoint(ckpt)
    _, after = ckpt_lib.load_checkpoint(WORK / "style_two_pass" / f"iter_{TWO_PASS_ITERS}.ckpt")
    p0 = ckpt_lib.restore_tree(st.params, before["params"])
    p1 = ckpt_lib.restore_tree(st.params, after["params"])
    moved = {k: not all(torch.equal(a, b) for a, b in zip(ckpt_lib.tree_flatten(p0[k]),
                                                        ckpt_lib.tree_flatten(p1[k])))
             for k in p0}
    if moved != {k: k == "x_color_embedder" for k in p0}:
        fails.append(f"two-pass style checkpoint leaves moved: {moved}")
    split = {k: float(np.median([t[k] for t in st.two_pass_ms])) for k in st.TWO_PASS_PHASES}
    per_iter = {k: v / TWO_PASS_ITERS for k, v in launches.items() if v}
    n_win = st.window_tiling()[0].shape[0]
    log(f"two-pass style run ({card}): {TWO_PASS_ITERS} iterations at {STYLE_DIMS[0]}x"
        f"{STYLE_DIMS[1]}, {n_win} windows of {st.window_tiling()[0].shape[1]} rays "
        f"(defer_patch_size {st.train_cfg.defer_patch_size}), in {sum(st.iter_ms) / 1e3:.2f} s "
        f"({wall_s:.2f} s through the entry point, set-up included); median iteration "
        f"{np.median(st.iter_ms):.2f} ms (first {st.iter_ms[0]:.2f} ms), split by phase "
        f"(medians, each ended by a sync) {split}; the cached path's median steady iteration "
        f"{cached_ms:.2f} ms (the style phase above, same checkpoint and scene): "
        f"{np.median(st.iter_ms) / cached_ms:.2f}x; peak memory {peak_gib:.2f} GiB; style term "
        f"first {first:.5f}, last-10 mean {last10:.5f}; matching "
        f"{[int(m) for m in st.style_loss.matching]}; launches an iteration {per_iter}")
    profile_once(st.run_iter, "two-pass style iteration", card)

    gen = torch.Generator(device=DEVICE).manual_seed(15)
    pose = next(iter(st.train_set.iter_shuffled_indexed(seed=st.train_cfg.rng_seed)))[0]
    checks = {"default": two_pass_check(st, pose, gen, "the style field", fails)}

    # The view-direction field: the spec and the color2 head replaced.
    spec0, head0 = st.field_spec, st.params["color2_net"]
    spec = dataclasses.replace(spec0, use_dir=True, sh_degree=4)
    st.field_spec = spec
    st.params["color2_net"] = field_init(spec, torch.Generator().manual_seed(16),
                                         DEVICE)["color2_net"]
    st._geom_cache.clear()
    reset_counts()
    cache = st.geom_cache(pose)
    with torch.no_grad():
        rgb_k, _ = st.render_cache(st.params, cache)
        rgb_p, _ = st.render_cache(st.params, cache, plain=True)
    dir_err = float((rgb_k - rgb_p).abs().max())
    assembled = kernels.launch_counts["sh_assemble"]
    if "dirs" not in cache or not dir_err <= 2e-3:
        fails.append(f"use_dir style cache: dirs cached {'dirs' in cache}, cached render against "
                     f"plain max abs err {dir_err} (tol 2e-3)")
    if assembled <= 0:
        fails.append("the use_dir style cache launched no K5d assemble")
    checks["use_dir"] = two_pass_check(st, pose, gen, "the style field with use_dir", fails)
    log(f"use_dir style cache (pose {pose}): {cache['w'].shape[0]} significant samples, "
        f"{st._cache_nbytes(cache) / 2**20:.1f} MiB with their directions; cached render with "
        f"the kernels against plain max abs err {dir_err:.3e} (tol 2e-3); K5d assemble "
        f"launched {assembled} times in the cache's build and render, "
        f"{kernels.launch_counts['sh_assemble'] - assembled} more in the two checks")
    del cache, rgb_k, rgb_p
    st.field_spec, st.params["color2_net"] = spec0, head0
    st._geom_cache.clear()
    table = two_pass_stream_rows(st, pose, gen, fails)
    return launches, table


# ---------------------------------------------------------------------------
# K5d, K9 and P0, and the view-dependent field families
# ---------------------------------------------------------------------------


def k5d_row(dirs: torch.Tensor, what: str, fails) -> dict:
    """K5d's first entry (sh_encode) at degree 4 on ``dirs`` [M, 3] unit
    directions (as (dirs + 1) / 2) against its plain version, bit for bit
    (the same rounding); both timed (the kernel from a CUDA graph)."""
    from nerfstyle_torch.ops import sh

    d01 = ((dirs + 1.0) / 2.0).contiguous()
    got, ref = sh.sh_encode(d01, 4), sh.sh_encode(d01, 4, plain=True)
    err = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        fails.append(f"K5d sh_encode at {what} differs from its plain version (max abs err {err})")
    ms = graph_ms(lambda: sh.sh_encode(d01, 4))
    plain_ms = cuda_ms(lambda: sh.sh_encode(d01, 4, plain=True), reps=5)
    m = d01.shape[0]
    # Bytes: 12 in, 64 out a row.  Operations: 45 fp32 a row at degree 4
    # (the map to [-1, 1] 6, degree 2 3, degree 3 11, degree 4 25).
    b_ms, b_by = bound_ms(nbytes=m * (12 + 64), flops=m * 45)
    log(f"K5d sh_encode at {what}: {m} rows, degree 4; bit-equal to plain: {err == 0.0}; ms "
        f"{ms:.5f} (graph), plain_ms {plain_ms:.3f}, bound_ms {b_ms:.5f} ({b_by}), "
        f"{b_ms / ms:.2f} of the bound; library: none (no single PyTorch call)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def k5d_assemble_row(dirs: torch.Tensor, fails) -> dict:
    """K5d's second entry (sh_assemble) on a view frame chunk's kept stream:
    ``dirs`` [M, 3] raw unit directions and seeded features, degree 4, K5's
    width 32, for the style field's color2 (color1's 16 columns) and the
    base field's rgb_net (15 columns, the strided view ``out[:, 1:]`` of a
    [M, 16] tensor); bit for bit against its plain version and against the
    chain the fields ran before this entry (add, divide, sh_encode, cat,
    and on the base field K5's zero-column pad), both timed from CUDA
    graphs.  That chain is the row's library column: no single PyTorch call
    computes the function.  The row is the style field's."""
    import torch.nn.functional as F

    from nerfstyle_torch.ops import sh

    m = dirs.shape[0]
    gen = torch.Generator().manual_seed(13)
    wide = torch.randn((m, 16), generator=gen).to(DEVICE)
    row = None
    for what, feat in (("style color2, k = 16", wide), ("base rgb_net, k = 15 strided",
                                                         wide[:, 1:])):
        k = feat.shape[1]

        def chain():
            x = torch.cat([feat, sh.sh_encode((dirs + 1.0) / 2.0, 4)], dim=-1)
            return F.pad(x, (0, 32 - x.shape[1])) if x.shape[1] < 32 else x

        got = sh.sh_assemble(feat, dirs, 4, 32)
        ref = sh.sh_assemble(feat, dirs, 4, 32, plain=True)
        old = chain()
        err = float((got - ref).abs().max())
        if not (torch.equal(got, ref) and torch.equal(got, old)):
            fails.append(f"K5d sh_assemble ({what}) differs from its plain version or from the "
                         f"chain it replaces (max abs err {err})")
        ms = graph_ms(lambda: sh.sh_assemble(feat, dirs, 4, 32))
        plain_ms = graph_ms(lambda: sh.sh_assemble(feat, dirs, 4, 32, plain=True))
        chain_ms = graph_ms(chain)
        # Bytes: feat 4k, dirs 12 in, 128 out a row; operations: the basis's
        # 45 and the fold's 6 a row.
        b_ms, b_by = bound_ms(nbytes=m * (4 * k + 12 + 128), flops=m * 51)
        log(f"K5d sh_assemble ({what}) at a view frame chunk's kept stream: {m} rows, degree "
            f"4, width 32; bit-equal to plain and to the old chain: {err == 0.0}; ms {ms:.5f} "
            f"(graph), plain_ms {plain_ms:.5f} (graph), the old chain (add, div, sh_encode, "
            f"cat{', pad' if k < 16 else ''}) {chain_ms:.5f} ms (graph), bound_ms {b_ms:.5f} "
            f"({b_by}), {b_ms / ms:.2f} of the bound")
        if row is None:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=chain_ms)
    return row


def l2_rate() -> tuple[float, float, float]:
    """Bytes a second that a device copy moves inside the 50 MB L2, the
    rate K9's corner traffic is held against (NVIDIA publishes none for the
    H100): 8 MiB read and 8 MiB written a copy, 50 copies in one CUDA
    graph, less 50 empty kernels' time in one graph (the launch floor, ~40%
    of a copy this short).  Returns the rate, a copy's ms and the floor's."""
    from nerfstyle_torch import kernels

    a = torch.ones(1 << 21, device=DEVICE)
    b = torch.empty_like(a)
    copy_ms = graph_ms(lambda: b.copy_(a), reps=50)
    floor_ms = graph_ms(lambda: kernels.empty_kernel(torch.device(DEVICE)), reps=50)
    return 2 * a.numel() * 4 / (max(copy_ms - floor_ms, 1e-6) * 1e-3), copy_ms, floor_ms


def grid_init_holds(out, spec, ref_spec, ref, num_styles):
    """Check (b): every row of ``out`` reached by a (corner, style) pair
    holds the style-0 value of one such pair; every other row is 0.
    Returns the reached mask and the number of rows that break the check."""
    from nerfstyle_torch.ops import hashgrid as th

    ok = torch.zeros(out.shape[0], dtype=torch.bool, device=out.device)
    reached = torch.zeros_like(ok)
    for lvl in range(spec.num_levels):
        res = spec.resolutions[lvl]
        pos = th._corner_ids(res, 0, (res + 1) ** 3, out.device)
        vals = ref[th.level_indices(pos, res, ref_spec.table_sizes[lvl]) + ref_spec.offsets[lvl]]
        for s in range(num_styles):
            rows = th.level_indices(pos, res, spec.table_sizes[lvl], s) + spec.offsets[lvl]
            reached[rows] = True
            ok[rows[(out[rows] == vals).all(dim=1)]] = True
    bad = int((reached & ~ok).sum()) + int((~reached & out.ne(0).any(dim=1)).sum())
    return reached, bad


def k9_sectors(grid, row_bytes: int) -> int:
    """32-byte sectors K9's warps touch reading the corners of ``grid`` (or
    writing one style of them): a warp's 32 lanes on an aligned block of
    32 x of a column read 32 rows, row_bytes sectors, on a power-of-two
    table; a column's last block of a < 32 lanes at most min(a, row_bytes).
    (On a level of another size a block may straddle one sector more: a
    count for the coarse levels' small share.)"""
    total = 0
    for res in grid.resolutions:
        side = res + 1
        full, rest = divmod(side, 32)
        total += side * side * (full * row_bytes + min(rest, row_bytes))
    return total


def k9_rows(grid, table: torch.Tensor, fails) -> dict:
    """K9 (grid_initialize) at the default grid (``grid``, the render
    checkpoint's 16 levels; its color table the reference), one style
    (check (a): the reference on every reached row and 0 elsewhere, so
    bit-equal to the plain version at full size) and two styles (the
    reached rows equal to plain's), each timed; check (b) at a small spec
    with three styles.  The bound is the larger of the table read and the
    new table written once at the HBM rate, and every corner's row read
    and its num_styles rows written at the L2 rate ``l2_rate`` measures
    (the launch floor taken off)
    (4C bytes an access: a warp's 32 neighbouring x of a column land in
    whole 32-byte sectors).  Logged beside: the sector traffic of a sector
    an access (the design before the warp a column) and an upper bound on
    this kernel's (``k9_sectors``)."""
    from nerfstyle_torch.ops import hashgrid as th

    rate, copy_ms, floor_ms = l2_rate()
    log(f"L2 copy rate: {rate / 1e12:.3f} TB/s (8 MiB copied in {copy_ms:.5f} ms from a graph, "
        f"less an empty kernel's {floor_ms:.5f} ms; {2 * 8 * 2**20 / copy_ms / 1e9:.3f} TB/s "
        f"with the floor in)")
    corners = sum((r + 1) ** 3 for r in grid.resolutions)
    row_bytes = 4 * table.shape[1]
    rows = {}
    for styles, reps in ((1, 2), (2, 1)):
        t0 = time.perf_counter()
        got = th.grid_initialize(grid, grid, table, num_styles=styles)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        ms = cuda_ms(lambda: th.grid_initialize(grid, grid, table, num_styles=styles), reps=reps,
                     warmup=0)
        t0 = time.perf_counter()
        ref = th.grid_initialize(grid, grid, table, num_styles=styles, plain=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        reached = got.ne(0).any(dim=1)
        same_rows = torch.equal(reached, ref.ne(0).any(dim=1))
        err = float((got - ref).abs().max()) if styles == 1 else 0.0
        if styles == 1 and not (torch.equal(got, ref) and torch.equal(got[reached], table[reached])
                                and same_rows):
            fails.append(f"K9 grid_initialize at the default grid, one style, differs from its "
                         f"plain version or from the reference (max abs err {err})")
        if styles > 1 and not same_rows:
            fails.append("K9 grid_initialize at two styles reaches other rows than plain")
        t_hbm = 2 * table.numel() * 4 / PEAK_BYTES_PER_S * 1e3
        t_l2 = corners * (1 + styles) * row_bytes / rate * 1e3
        b_ms, b_by = max((t_hbm, "table bytes at HBM"), (t_l2, "corner rows at the L2 rate"))
        log(f"K9 grid_initialize, {styles} style(s), the default grid: {corners} corners, "
            f"{grid.total_params} rows x {table.shape[1]}, {int(reached.sum())} rows reached; "
            f"equal to plain (1 style, bit for bit, and the reference on every reached row) or "
            f"its reached rows (2 styles): {err == 0.0 and same_rows}; ms {ms:.1f} (first call "
            f"{first_s:.2f} s), plain_ms {plain_ms:.1f} (one call), bound_ms {b_ms:.1f} "
            f"({b_by}: table bytes at HBM {t_hbm:.4f} ms, corner rows at the L2 rate "
            f"{rate / 1e12:.3f} TB/s measured here {t_l2:.1f} ms; sector traffic at that "
            f"rate: a 32-byte sector an access {t_l2 * 32 / row_bytes:.1f} ms, this kernel's "
            f"{k9_sectors(grid, row_bytes) * (1 + styles) * 32 / rate * 1e3:.1f} ms); "
            f"{b_ms / ms:.2f} of the bound; library: none")
        rows[f"K9 {styles}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by="bytes", bound_from=b_by, library_ms=None,
                                    l2_tb_s=rate / 1e12)
        del got, ref, reached
    small = th.hashgrid_spec(num_levels=4, level_dim=2, base_resolution=16, per_level_scale=1.5,
                             log2_hashmap_size=14)
    ref = torch.rand((small.total_params, 2), generator=torch.Generator().manual_seed(9))
    ref = (ref * 2 - 1).to(DEVICE)
    out = th.grid_initialize(small, small, ref, num_styles=3)
    plain = th.grid_initialize(small, small, ref, num_styles=3, plain=True)
    reached, bad = grid_init_holds(out, small, small, ref, 3)
    ok = bad == 0
    same = torch.equal(reached, plain.ne(0).any(dim=1))
    log(f"K9 check (b) at 4 levels x 2^14 rows, three styles: every reached row holds a "
        f"colliding corner's value: {ok}; reached rows equal to plain: {same}")
    if not (ok and same):
        fails.append("K9 grid_initialize at three styles fails check (b)")
    return rows


def p0_rows(fails) -> dict:
    """P0 (take_rows) at its own shape (256 int32 indices into a [1024, 128]
    f32 table; launch-bound) and at 2^20 indices into the same table,
    bit-equal to ``table[idx]``, the kernel and ``index_select`` (its
    library yardstick) from CUDA graphs.  Bound: the indices and the
    distinct rows read once, the output written once."""
    from nerfstyle_torch.ops import gather

    gen = torch.Generator().manual_seed(12)
    table = torch.randn((1024, 128), generator=gen).to(DEVICE)
    rows = {}
    for n, key in ((256, "P0"), (1 << 20, "P0 2^20")):
        idx = torch.randint(0, 1024, (n,), generator=gen, dtype=torch.int32).to(DEVICE)
        got, ref = gather.take_rows(table, idx), gather.take_rows(table, idx, plain=True)
        if not torch.equal(got, ref):
            fails.append(f"P0 take_rows at {n} indices differs from table[idx]")
        ms = graph_ms(lambda: gather.take_rows(table, idx))
        plain_ms = graph_ms(lambda: gather.take_rows(table, idx, plain=True))
        lib_ms = graph_ms(lambda: torch.index_select(table, 0, idx))
        distinct = int(torch.unique(idx).numel())
        b_ms, b_by = bound_ms(nbytes=n * 4 + distinct * 512 + n * 512, flops=0)
        log(f"P0 take_rows: {n} indices ({distinct} distinct rows) into [1024, 128]; bit-equal "
            f"to table[idx]: {torch.equal(got, ref)}; ms {ms:.5f} (graph), plain_ms "
            f"{plain_ms:.5f}, index_select ms {lib_ms:.5f}, bound_ms {b_ms:.5f} ({b_by}; "
            f"{n * 1024 / 1e9:.3f} GB if every gathered row were read from memory)")
        rows[key] = dict(max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return rows


def new_kernel_phases(renderer, params, rays_d, fails) -> dict:
    """K5d's first entry at a frame chunk's kept stream and at a style
    cache's size, its second at the kept stream, K9 and P0 (on no path),
    against their plain versions; returns their kernel-table rows."""
    table = {"K5d": k5d_row(rays_d[:129929], "a frame chunk's kept stream (129,929 rows)",
                            fails),
             "K5d style": k5d_row(rays_d[:640000], "a style cache's size (640,000 rows)", fails),
             "K5d assemble": k5d_assemble_row(rays_d[:129929].contiguous(), fails)}
    table.update(k9_rows(renderer.field_spec.grid, params["x_color_embedder"], fails))
    table.update(p0_rows(fails))
    return table


# The view configuration: the render checkpoint's network with a view
# direction input (the style field under use_dir, SH degree 4: color2 [32,
# 64, 64, 3]) and the base field (density_out_dims 16, rgb_net [31 -> 32,
# 64, 64, 3]); each field must launch these on its frame (K6c on the
# restore; K5d's second entry builds the color head's input).
VIEW_COUNTERS = ("sh_assemble", "hashgrid_encode", "march_skip_count", "march_skip_write",
                 "composite_weights", "mlp_forward", "segment_sum", "occupancy_skipdist")
# K5d's counters: no run but a view frame launches either entry, and a view
# frame only the second.
K5D_COUNTERS = ("sh_encode", "sh_assemble")


def view_families(renderer) -> dict:
    """The view-dependent families at the render checkpoint's width, each a
    Renderer (on the render renderer's bbox, settings and camera) and
    seeded random params: name -> (renderer, params)."""
    from nerfstyle_torch.models.fields import FieldSpec, field_init
    from nerfstyle_torch.render.renderer import Renderer

    spec = renderer.field_spec
    specs = {
        "view style": dataclasses.replace(spec, use_dir=True, sh_degree=4),
        "view base": FieldSpec(grid=spec.grid, kind="base", density_out_dims=16,
                               density_offset=spec.density_offset),
    }
    out = {}
    for seed, (name, fspec) in enumerate(specs.items(), start=1):
        params = field_init(fspec, torch.Generator().manual_seed(seed), DEVICE)
        out[name] = (Renderer(fspec, renderer.bbox, renderer.settings, renderer.intr,
                              renderer.bound, raymarch_channels=fspec.out_channels,
                              compute_dtype=renderer.compute_dtype, device=DEVICE), params)
    return out


def view_phase(renderer, default_params, pose, rays, card: str, fails) -> dict:
    """Each view-dependent family (seeded random weights at the render
    checkpoint's full width) through ``Renderer.render`` on the 1008x756
    frame, the way the render phase drives its frame: a Renderer on the
    family's FieldSpec, the checkpoint's occupancy restored (K6c), the
    launch counters set to 0 before the restore and read after the frame;
    the maps finite and of the family's channels, the opacity's IoU with
    the spheres >= 0.8, a 4096-ray crop within the render phase's
    tolerances of the plain path; then steady frames of the default field
    (``renderer``, ``default_params``) and both families in turns, and one
    frame of each under the profiler (what it issues).  Returns each
    family's launches."""
    from nerfstyle_torch.ops.occupancy import occupancy_persistable

    persisted = occupancy_persistable(renderer.occ_state)
    w, h = OUT_DIMS
    npix = w * h
    ys, xs = np.meshgrid(np.arange(h // 2 - 32, h // 2 + 32), np.arange(w // 2 - 32, w // 2 + 32),
                         indexing="ij")
    crop = torch.from_numpy((ys * w + xs).reshape(-1)).to(DEVICE)
    runs, frames = {}, {"default": (renderer, default_params)}
    for name, (r, params) in view_families(renderer).items():
        fspec = r.field_spec
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r.restore_occupancy(persisted)
        with torch.no_grad():
            out = r.render(params, pose)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        runs[name] = read_counts()
        for counter in VIEW_COUNTERS:
            if runs[name][counter] <= 0:
                fails.append(f"{name} frame launched no {counter} kernel")
        if runs[name]["sh_encode"]:
            fails.append(f"{name} frame launched K5d's first entry: the field takes the second")
        shapes = {"rgb_map": (npix, 3), "trans_map": (npix,), "weights_sum": (npix,),
                  "classes": (npix, fspec.out_channels - 3)}
        for k, shp in shapes.items():
            if tuple(out[k].shape) != shp or not bool(torch.isfinite(out[k]).all()):
                fails.append(f"{name} frame {k}: shape {tuple(out[k].shape)} (want {shp}) or "
                             f"not finite")
        iou = silhouette_iou(rays.origins, rays.dirs, out["weights_sum"])
        if not iou >= 0.8:
            fails.append(f"{name} frame opacity IoU with the spheres {iou:.4f} < 0.8")
        with torch.no_grad():
            ref = r.render_rays(params, rays.origins[crop], rays.dirs[crop], plain=True)
        crop_tol = {"rgb_map": 2e-3, "trans_map": 2e-3, "weights_sum": 2e-3, "classes": 2e-2}
        crop_err = {k: float((out[k][crop] - ref[k]).abs().max()) if ref[k].numel() else 0.0
                    for k in crop_tol}
        for k, tol in crop_tol.items():
            if not crop_err[k] <= tol:
                fails.append(f"{name} crop {k} error {crop_err[k]} > {tol}")
        log(f"{name} frame ({card}): {fspec.kind} field, use_dir {fspec.use_dir}, SH degree "
            f"{fspec.sh_degree}, color head input {fspec.rgb_in_dims} wide, {fspec.out_channels} "
            f"channels; restore + first frame {first_ms:.1f} ms, {out['num_marched'] / npix:.2f} "
            f"samples/ray marched, {out['num_sig'] / npix:.2f} significant; opacity IoU "
            f"{iou:.4f}; crop of 4096 rays vs plain max abs err {crop_err} (tol {crop_tol}); "
            f"launches {runs[name]}")
        frames[name] = (r, params)
        del out, ref
    times = {k: [] for k in frames}
    order = list(frames) + list(frames)[::-1]
    for name in order:
        r, params = frames[name]
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                r.render(params, pose)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
    log(f"steady frames ({card}) at {w}x{h}, in turns {order}: " + ", ".join(
        f"{k} min {min(v):.1f} ms {['%.1f' % t for t in v]}" for k, v in times.items()))
    for name, (r, params) in frames.items():
        profile_once(lambda: r.render(params, pose), f"{name} frame", card)
    return runs


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


def frame_on_off(renderer, params, pose, out, card: str, fails):
    """The frame with adaptive_march off (the dense march, K3; phase B
    colors every sample of nonzero weight) against the two-stage march's
    (K3s) at sig_eps 0: the same samples, so the same maps; then steady
    frames with it on and off in turns (on, off, off, on).  Returns the off
    frame's kernel launches."""
    from nerfstyle_torch.ops.marching import WINDOW

    on = renderer.settings
    off = dataclasses.replace(on, adaptive_march=False)
    renderer.settings = off
    reset_counts()
    with torch.no_grad():
        dense = renderer.render(params, pose)
    torch.cuda.synchronize()
    launches = read_counts()
    # The dense frame colors every sample of nonzero weight (sig_eps 0, as
    # JAX's single-phase frame): the two-stage march at sig_eps 0 gives the
    # same samples, so the same maps.
    renderer.settings = dataclasses.replace(on, sig_eps=0.0)
    with torch.no_grad():
        every = renderer.render(params, pose)
    renderer.settings = on
    for name in DENSE_COUNTERS:
        if launches[name] <= 0:
            fails.append(f"the adaptive_march=False frame launched no {name} kernel")
    if launches["march_skip_count"] or launches["march_skip_write"]:
        fails.append("the adaptive_march=False frame launched the two-stage march")
    errs = {k: float((dense[k] - every[k]).abs().max()) for k in ("rgb_map", "weights_sum")}
    if (dense["num_marched"], dense["num_sig"]) != (every["num_marched"], every["num_sig"]) \
            or not all(e <= 1e-6 for e in errs.values()):
        fails.append(f"the dense-march frame differs from the two-stage frame at sig_eps 0: "
                     f"samples {dense['num_marched']} vs {every['num_marched']}, colored "
                     f"{dense['num_sig']} vs {every['num_sig']}, max abs err {errs}")
    dropped = float((dense["rgb_map"] - out["rgb_map"]).abs().max())
    times = {True: [], False: []}
    for adaptive in (True, False, False, True):
        renderer.settings = on if adaptive else off
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            renderer.render(params, pose)
            torch.cuda.synchronize()
            times[adaptive].append((time.perf_counter() - t) * 1e3)
    renderer.settings = on
    w, h = OUT_DIMS
    npix = w * h
    log(f"frame with adaptive_march off: samples {dense['num_marched']}, colored "
        f"{dense['num_sig']} (on: {out['num_marched']}, colored {out['num_sig']} of w > "
        f"{on.sig_eps}, {out['num_cand']} candidate windows of "
        f"{npix * -(-renderer.plan.t_lattice // WINDOW)}); max abs err against on at sig_eps 0 "
        f"{errs}, rgb against on {dropped:.3e}; steady "
        f"frames ({card}) on/off/off/on: on min {min(times[True]):.1f} ms "
        f"{['%.1f' % t for t in times[True]]}, off min {min(times[False]):.1f} ms "
        f"{['%.1f' % t for t in times[False]]} at {w}x{h}")
    return launches


# ---------------------------------------------------------------------------
# The incremental renderer
# ---------------------------------------------------------------------------


def count_syncs(fn) -> int:
    """The synchronizing CUDA calls fn() makes (torch.cuda's sync debug
    mode warns at each)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def k4i_row(sig, tau, offsets, t0, dt: float, t_thresh: float, what: str, fails) -> dict:
    """K4i on a round stream as the path hands it over (densities with
    density_scale applied, each ray's entering transmittance t0) against
    its plain version in float64; timed from a CUDA graph of the kernel
    call alone (and launch by launch, logged).  Tolerances: K4's (k4_row):
    atol 2e-6 on w and weights_sum, 2e-6 * max(tau) on depth, 1e-4 on a ray
    with a sample within 1e-4 relative of t_thresh; t_out rtol 1e-5 (fp32
    against float64 sums of the round's optical depth)."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.ops import compositing

    n, m = offsets.shape[0] - 1, sig.shape[0]
    got = compositing.sample_weights_entering(sig, tau, offsets, t0, dt, t_thresh)
    want = compositing.sample_weights_entering(sig.double(), tau.double(), offsets, t0.double(),
                                               dt, t_thresh, plain=True)
    rid = compositing.ray_ids(offsets)
    _, trans64 = compositing.entering_transmittance_plain(sig.double(), offsets, dt)
    trans64 = t0.double()[rid] * trans64
    near = ((trans64 - t_thresh).abs() <= 1e-4 * t_thresh).double()
    edge = compositing.segment_totals_plain(near, offsets) > 0
    on_edge = edge[rid]
    tau_max = float(tau.max()) if m else 0.0
    errs, tols = [], []
    for mask_s, mask_r, tight in ((~on_edge, ~edge, 2e-6), (on_edge, edge, 1e-4)):
        errs += [float((a.double() - b)[mk].abs().max()) if bool(mk.any()) else 0.0
                 for a, b, mk in ((got[0], want[0], mask_s), (got[1], want[1], mask_r),
                                  (got[2], want[2], mask_r))]
        tols += [tight, tight, tight * tau_max]
    big = want[3] > 1e-30
    t_err = float(((got[3].double() - want[3]) / want[3].clamp(min=1e-30))[big].abs().max())
    if not (all(e <= t for e, t in zip(errs, tols)) and t_err <= 1e-5):
        fails.append(f"K4i at {what}: errors w/ws/depth (inner rays, then edge rays) {errs} vs "
                     f"{tols}, t_out relative {t_err} vs 1e-5")
    ms = graph_ms(lambda: kernels.composite_weights_entering(sig, tau, offsets, t0, dt, t_thresh))
    host_ms = cuda_ms(lambda: kernels.composite_weights_entering(sig, tau, offsets, t0, dt,
                                                                 t_thresh), reps=20)
    plain_ms = cuda_ms(lambda: compositing.sample_weights_entering(sig, tau, offsets, t0, dt,
                                                                   t_thresh, plain=True), reps=5)
    c_ms = cold_ms(lambda: kernels.composite_weights_entering(sig, tau, offsets, t0, dt, t_thresh))
    # Bytes: offsets, t0, every sample's sigma (t_out sums the whole round),
    # tau of the included samples, w of every sample, three per-ray outputs.
    # About 8 operations a sample.
    n_inc = int((trans64 >= t_thresh).sum())
    b_ms, b_by = bound_ms(nbytes=(n + 1) * 8 + n * 4 + m * 4 + n_inc * 4 + m * 4 + n * 12,
                          flops=m * 8)
    share = cold_share(f"K4i at {what}", b_ms, c_ms, fails)
    log(f"K4i composite_weights_entering at {what}: {m} samples over {n} rays "
        f"({ray_length_stats(offsets)}), entering T min {float(t0.min()):.3e}, {n_inc} samples "
        f"included, {int(edge.sum())} edge rays; max_abs_err w/ws/depth inner, edge {errs} (tol "
        f"{tols}), t_out relative {t_err:.2e}; ms {ms:.4f} (graph; {host_ms:.4f} launched one by "
        f"one; cold {c_ms:.4f}, the bound {share:.0%} of it), plain_ms {plain_ms:.3f}, bound_ms "
        f"{b_ms:.4f} ({b_by})")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, cold_ms=c_ms, cold_share=share)


def p0_round_row(rows, pos, what: str, fails) -> dict:
    """P0 on a round's gather as the path hands it over (the chunk's rows,
    the round's int32 positions), bit-equal to ``rows[pos]``; the kernel,
    the plain version and ``index_select`` (its library yardstick) from
    CUDA graphs, and the kernel cold (cold_ms).  Bound: the positions, the
    rows read once, the output written once."""
    from nerfstyle_torch.ops import gather

    got, ref = gather.take_rows(rows, pos), gather.take_rows(rows, pos, plain=True)
    if not torch.equal(got, ref):
        fails.append(f"P0 take_rows at {what} differs from rows[pos]")
    ms = graph_ms(lambda: gather.take_rows(rows, pos))
    plain_ms = graph_ms(lambda: gather.take_rows(rows, pos, plain=True))
    lib_ms = graph_ms(lambda: torch.index_select(rows, 0, pos))
    c_ms = cold_ms(lambda: gather.take_rows(rows, pos))
    n, c = pos.shape[0], rows.shape[1]
    b_ms, b_by = bound_ms(nbytes=n * 4 + 2 * n * c * 4, flops=0)
    share = cold_share(f"P0 at {what}", b_ms, c_ms, fails)
    log(f"P0 take_rows at {what}: {n} positions into [{rows.shape[0]}, {c}] f32; bit-equal to "
        f"rows[pos]: {torch.equal(got, ref)}; ms {ms:.4f} (graph; cold {c_ms:.4f}, the bound "
        f"{share:.0%} of it), plain_ms {plain_ms:.4f}, index_select ms {lib_ms:.4f}, bound_ms "
        f"{b_ms:.4f} ({b_by})")
    return dict(max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, cold_ms=c_ms, cold_share=share)


def capture_rounds(renderer, params, pose, inc):
    """The frame through the incremental renderer at settings ``inc``, then
    at round size 4, with the renderer's round calls watched.  Returns the
    round-size-4 frame; the largest round's K4i arguments, its P0 arguments
    (the chunk's [xyz, tau] rows, the round's positions) and its chunk's
    march stream; and the K4i arguments of the first round-size-4 round
    whose rays enter with T < 1 (None if no ray lived into a second
    round)."""
    from unittest import mock

    from nerfstyle_torch.render import renderer as rmod

    best, pending, later = {"m": -1}, {}, {}

    def march_spy(*args, **kw):
        pending["sb"] = real_march(*args, **kw)
        return pending["sb"]

    def p0_spy(table, idx, **kw):
        pending["p0"] = (table, idx)
        return real_p0(table, idx, **kw)

    def k4i_spy(*args, **kw):
        if args[0].shape[0] > best["m"]:
            best.update(m=args[0].shape[0], k4i=args[:6], p0=pending["p0"], sb=pending["sb"])
        if "k4i" not in later and float(args[3].min()) < 1.0:
            later["k4i"] = args[:6]
        return real_k4i(*args, **kw)

    real_k4i, real_p0, real_march = rmod.sample_weights_entering, rmod.take_rows, rmod.march_rays
    base = renderer.settings
    try:
        with mock.patch.object(rmod, "sample_weights_entering", k4i_spy), \
                mock.patch.object(rmod, "take_rows", p0_spy), \
                mock.patch.object(rmod, "march_rays", march_spy), torch.no_grad():
            renderer.settings = inc
            renderer.render(params, pose)
            renderer.settings = dataclasses.replace(inc, infer_round_size=4)
            out4 = renderer.render(params, pose)
    finally:
        renderer.settings = base
    return out4, best, later.get("k4i")


def round_rows(best, later, fails) -> dict:
    """K4i and P0 on the largest round of an incremental frame (P0 on its
    16-byte [xyz, tau] rows, and on the same positions into the 32-byte
    [xyz, tau, dirs, 0] rows that the view-dependent fields gather, built
    from the chunk's march stream as render/renderer.py builds them), and
    K4i on a later round at round size 4; warm and cold."""
    sig, tau, offsets, t0, dt, t_thresh = best["k4i"]
    rows, pos = best["p0"]
    sb = best["sb"]
    wide = torch.cat([sb.xyz, sb.tau[:, None], sb.dirs, torch.zeros_like(sb.tau)[:, None]], 1)
    if not torch.equal(wide[:, :4], rows):
        fails.append("the captured march stream does not hold the largest round's rows")
    what = f"an incremental frame's largest round ({sig.shape[0]} samples)"
    table = {"K4i": k4i_row(sig, tau, offsets, t0, dt, t_thresh, what, fails),
             "P0 incremental": p0_round_row(rows, pos, what, fails),
             "P0 incremental 32 B": p0_round_row(wide, pos, what + ", 32-byte view-field rows",
                                                 fails)}
    if later is None:
        fails.append("the incremental frame at round size 4 carried no ray into a second round")
    else:
        table["K4i later"] = k4i_row(*later, f"a later round at round size 4 ({later[0].shape[0]} "
                                             "samples, rays entering with T < 1)", fails)
    return table


def k5f_heads_row(heads, dtype, what: str, fails) -> dict:
    """K5's forward on each head (weights, input, activation) against the
    plain chain within k5_tolerance, and the heads' forwards timed
    together: K5, the plain chain and K5's cuBLAS chain (its library
    yardstick, held against plain first).  Bound: each head's input read
    and output written once, the weights once; 2 d_in d_out operations a
    row a layer at the bf16 tensor-core peak under AMP (fp32 otherwise)."""
    from nerfstyle_torch.ops.mlp import mlp_apply, mlp_apply_plain

    errs = []
    with torch.no_grad():
        for i, (w, x, act) in enumerate(heads):
            got, want = mlp_apply(w, x, act, dtype), mlp_apply_plain(w, x, act, dtype)
            err, tol = float((got - want).abs().max()), k5_tolerance(want, dtype)
            errs.append(err)
            if not err <= tol:
                fails.append(f"K5 forward, head {i} at {what}: error {err} > {tol}")
        lib_errs = [library_check(w, x, act, dtype, fails, f"head {i} at {what}")
                    for i, (w, x, act) in enumerate(heads)]
        ms = cuda_ms(lambda: [mlp_apply(w, x, act, dtype) for w, x, act in heads], reps=10)
        plain_ms = cuda_ms(lambda: [mlp_apply_plain(w, x, act, dtype) for w, x, act in heads],
                           reps=5)
        with cublas_fp32_sums():
            lib_ms = cuda_ms(lambda: [mlp_library_chain(w, x, act, dtype) for w, x, act in heads],
                             reps=10)
    n = heads[0][1].shape[0]
    dims = [[w.shape[0] for w in ws] + [ws[-1].shape[1]] for ws, _, _ in heads]
    macs = sum(sum(a * b for a, b in zip(d[:-1], d[1:])) for d in dims)
    wbytes = sum(w.numel() * 4 for ws, _, _ in heads for w in ws)
    peak = PEAK_BF16_PER_S if dtype == torch.bfloat16 else PEAK_FP32_PER_S
    b_ms, b_by = bound_ms(n * 4 * sum(d[0] + d[-1] for d in dims) + wbytes, 2 * n * macs, peak)
    log(f"K5 forward at {what} ({n} rows, {dtype}, layer widths {dims}): max abs err {errs}, "
        f"cuBLAS chain against plain {lib_errs}; ms {ms:.3f}, plain_ms {plain_ms:.3f}, cuBLAS "
        f"chain {lib_ms:.3f}, bound_ms {b_ms:.4f} ({b_by})")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def incremental_phase(renderer, params, pose, rays, card: str, fails):
    """The main frame through the incremental renderer
    (``RenderSettings(infer_two_phase=False)``: rounds of infer_round_size
    samples an alive ray), launch counters set to 0 just before and read
    just after: K4i, P0, K1, K5, K7 and the two-stage march must launch, K4
    and K5d not.  Checks: finite maps of the frame's shapes; the frame
    against the two-phase frame at sig_eps 0, which colors every sample of
    nonzero weight (the same weights: K4i's optical depth carried from
    round to round as a product of transmittances, K4's as one sum, and the
    channels summed a round at a time: atol 2e-4 on rgb, opacity and depth,
    2e-3 on class logits, for a sample at the t_thresh cutoff that the two
    round differently); a 4096-ray crop against the plain path on the card
    (the main frame's tolerances: 2e-3, class logits 2e-2).  Logs rounds a
    chunk, the loop's host reads and the frame's synchronizing calls
    (counted by torch.cuda's sync debug mode) beside the two-phase frame's,
    samples evaluated beside the two-phase frame's phase A and B, and
    steady frames of both in turns (two-phase, incremental, incremental,
    two-phase).  The frame at round size 4 (rays live into later rounds)
    against the same two-phase frame.  Then K4i, P0, K1 and K5 on the
    frame's largest round, and K4i on a later round of the round-size-4
    frame (rays entering with T < 1).  Returns the frame's launches and the
    kernel-table rows."""
    from nerfstyle_torch.models.fields import _encoder_input
    from nerfstyle_torch.render import renderer as rmod

    base = renderer.settings
    inc = dataclasses.replace(base, infer_two_phase=False)
    eps0 = dataclasses.replace(base, sig_eps=0.0)

    def frame(settings, o=None, d=None, plain=False):
        renderer.settings = settings
        try:
            with torch.no_grad():
                if o is None:
                    return renderer.render(params, pose, plain=plain)
                return renderer.render_rays(params, o, d, plain=plain)
        finally:
            renderer.settings = base

    two, every = frame(base), frame(eps0)
    torch.cuda.synchronize()
    reset_counts()
    out = frame(inc)
    torch.cuda.synchronize()
    launches = read_counts()
    for name in INCREMENTAL_COUNTERS:
        if launches[name] <= 0:
            fails.append(f"incremental frame launched no {name} kernel")
    for name in ("composite_weights", *K5D_COUNTERS):
        if launches[name]:
            fails.append(f"incremental frame launched {name} {launches[name]} times")
    w, h = OUT_DIMS
    npix = w * h
    shapes = {"rgb_map": (npix, 3), "trans_map": (npix,), "weights_sum": (npix,),
              "classes": (npix, renderer.raymarch_channels - 3)}
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp or not bool(torch.isfinite(out[k]).all()):
            fails.append(f"incremental frame {k}: shape {tuple(out[k].shape)} (want {shp}) or "
                         "not finite")
    tol = {"rgb_map": 2e-4, "trans_map": 2e-4, "weights_sum": 2e-4, "classes": 2e-3}
    errs = {k: float((out[k] - every[k]).abs().max()) for k in tol}
    if out["num_marched"] != every["num_marched"] or not all(errs[k] <= t
                                                              for k, t in tol.items()):
        fails.append(f"incremental frame against the two-phase frame at sig_eps 0: marched "
                     f"{out['num_marched']} vs {every['num_marched']}, max abs err {errs} (tol "
                     f"{tol})")
    half = min(32, h // 4, w // 4)
    ys, xs = np.meshgrid(np.arange(h // 2 - half, h // 2 + half),
                         np.arange(w // 2 - half, w // 2 + half), indexing="ij")
    crop = torch.from_numpy((ys * w + xs).reshape(-1)).to(DEVICE)
    ref = frame(inc, rays.origins[crop], rays.dirs[crop], plain=True)
    crop_tol = {"rgb_map": 2e-3, "trans_map": 2e-3, "weights_sum": 2e-3, "classes": 2e-2}
    crop_err = {k: float((out[k][crop] - ref[k]).abs().max()) for k in crop_tol}
    for k, t in crop_tol.items():
        if not crop_err[k] <= t:
            fails.append(f"incremental crop {k} error {crop_err[k]} > {t}")
    syncs = {"two-phase": count_syncs(lambda: frame(base)),
             "incremental": count_syncs(lambda: frame(inc))}
    times = {"two-phase": [], "incremental": []}
    for which in ("two-phase", "incremental", "incremental", "two-phase"):
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            frame(inc if which == "incremental" else base)
            torch.cuda.synchronize()
            times[which].append((time.perf_counter() - t) * 1e3)
    chunks = -(-npix // rmod.CHUNK_RAYS)
    log(f"incremental frame ({card}, round size {inc.infer_round_size}): {out['rounds']} rounds "
        f"over {chunks} chunks ({out['rounds'] / chunks:.2f} a chunk, at most "
        f"{-(-base.max_steps // inc.infer_round_size) + 1}), {out['rounds'] + chunks} host reads "
        f"of the round loops; synchronizing calls a frame {syncs}; samples evaluated "
        f"{out['num_points']} ({out['num_points'] / npix:.2f}/ray) of {out['num_marched']} "
        f"marched, against the two-phase frame's phase A {two['num_marched']} and phase B "
        f"{two['num_sig']} (sig_eps {base.sig_eps}); max abs err against the two-phase frame at "
        f"sig_eps 0 {errs} (tol {tol}), against the default two-phase frame "
        f"{float((out['rgb_map'] - two['rgb_map']).abs().max()):.3e} on rgb; 4096-ray crop "
        f"against plain {crop_err} (tol {crop_tol}); steady frames two-phase/incremental/"
        f"incremental/two-phase: two-phase min {min(times['two-phase']):.1f} ms "
        f"{['%.1f' % t for t in times['two-phase']]}, incremental min "
        f"{min(times['incremental']):.1f} ms {['%.1f' % t for t in times['incremental']]}; "
        f"launches {launches}")

    # The rounds as the path hands them over: the frame's largest round (P0's
    # gather and K4i's composite of one round) for the rows; the frame at
    # round size 4, where rays that hit a sphere (~7 samples to saturate)
    # live into a second round, against the two-phase frame at sig_eps 0,
    # and its first round whose rays enter with T < 1 for one more check of
    # K4i.
    out4, best, later = capture_rounds(renderer, params, pose, inc)
    errs4 = {k: float((out4[k] - every[k]).abs().max()) for k in tol}
    if not all(errs4[k] <= t for k, t in tol.items()):
        fails.append(f"incremental frame at round size 4 against the two-phase frame at sig_eps "
                     f"0: max abs err {errs4} (tol {tol})")
    log(f"incremental frame at round size 4: {out4['rounds']} rounds over {chunks} chunks "
        f"({out4['rounds'] / chunks:.2f} a chunk), samples evaluated {out4['num_points']}; max "
        f"abs err against the two-phase frame at sig_eps 0 {errs4} (tol {tol})")
    floor = launch_floor()
    log(f"empty kernel (one warp) beside the round rows: {floor}")
    table = round_rows(best, later, fails)
    for kid in ("K4i", "P0 incremental"):
        table[kid].update(floor)
    rows, pos = best["p0"]
    what = f"an incremental frame's largest round ({pos.shape[0]} samples)"
    spec, dtype = renderer.field_spec, renderer.compute_dtype
    fused = torch.cat([params["x_density_embedder"], params["x_color_embedder"]], 1).detach()
    x = _encoder_input(renderer.bbox, rows[pos.long(), :3]).contiguous()
    table["K1 incremental"] = k1_row(spec.grid, fused, x, what + ", fused [T, 4]", fails)
    with torch.no_grad():
        from nerfstyle_torch.ops.hashgrid import hashgrid_encode
        from nerfstyle_torch.ops.mlp import mlp_apply

        c = spec.grid.level_dim
        hh = hashgrid_encode(spec.grid, fused, x).reshape(-1, spec.grid.num_levels, 2 * c)
        h_d = hh[..., :c].reshape(-1, spec.grid.output_dim).contiguous()
        h_c = hh[..., c:].reshape(-1, spec.grid.output_dim).contiguous()
        c1 = mlp_apply(params["color1_net"], h_c, None, dtype)
    heads = [(params["density_net"], h_d, None), (params["class_net"], h_c, None),
             (params["color1_net"], h_c, None), (params["color2_net"], c1, "sigmoid")]
    table["K5f incremental"] = k5f_heads_row(heads, dtype, what, fails)
    return launches, table


# ---------------------------------------------------------------------------
# The library API: hashgrid_encode's style slot and position gradient, the
# stratified oracle, Renderer.render's patch and ray batch, VGG19, JPEGs
# ---------------------------------------------------------------------------


def frame_streams(renderer, params, rays_o, rays_d):
    """The middle 2^16-ray chunk of the frame as render_chunk hands it to
    K1: phase A's first FIELD_BATCH marched samples and phase B's kept
    ones, as encoder inputs."""
    from nerfstyle_torch.models.fields import _encoder_input, field_density
    from nerfstyle_torch.ops import compositing, marching
    from nerfstyle_torch.ops.aabb import near_far_from_aabb
    from nerfstyle_torch.render.renderer import CHUNK_RAYS, FIELD_BATCH

    plan, bbox, s = renderer.plan, renderer.bbox, renderer.settings
    mid = rays_o.shape[0] // 2
    o = rays_o[mid - CHUNK_RAYS // 2: mid + CHUNK_RAYS // 2].contiguous()
    d = rays_d[mid - CHUNK_RAYS // 2: mid + CHUNK_RAYS // 2].contiguous()
    nears, fars = near_far_from_aabb(o, d, plan.aabb(o.device), plan.min_near)
    sb = marching.march_rays(plan, renderer.occ_field, o, d, nears, fars)
    with torch.no_grad():
        sig = field_density(renderer.field_spec, params, bbox, sb.xyz,
                            renderer.compute_dtype) * s.density_scale
        w, *_ = compositing.sample_weights(sig, sb.tau, sb.offsets, plan.dt, s.t_thresh)
    return (_encoder_input(bbox, sb.xyz[:FIELD_BATCH]).contiguous(),
            _encoder_input(bbox, sb.xyz[w > s.sig_eps]).contiguous())


def k2x_row(grid, table, x, what: str, gen, fails) -> dict:
    """K2x (``hashgrid_encode(fast_vjp=False)``'s position gradient) on the
    stream x for a random cotangent, against autograd through the plain
    encode: every entry within K2X_TOL of the largest |d x| (the sums run
    in another order); points outside [0, 1]^3 exactly 0.  Timed from a
    CUDA graph and cold; the plain version launch by launch.  Bound by
    bytes: the points, the cotangent, the distinct rows read and d x written
    once.  Returns the kernel-table entry."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.ops import hashgrid

    n, nl, c = x.shape[0], grid.num_levels, table.shape[1]
    kid = "K2x (simplex levels)" if grid.simplex_start < nl else "K2x"
    lv = hashgrid.position_grad_table(grid, x.device)
    g = torch.randn((n, nl * c), generator=gen, device=x.device)
    got = kernels.hashgrid_position_grad(x, g, table, lv)
    ref = hashgrid.hashgrid_position_grad_plain(grid, table, x, g)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    outside = ~((x >= 0) & (x <= 1)).all(dim=-1)
    if not (err <= K2X_TOL * scale and not bool(got[outside].any())):
        fails.append(f"{kid} at {what}: max abs err {err} > {K2X_TOL} x {scale}, or a point "
                     "outside [0, 1]^3 with a gradient")
    del got, ref
    ms = graph_ms(lambda: kernels.hashgrid_position_grad(x, g, table, lv))
    c_ms = cold_ms(lambda: kernels.hashgrid_position_grad(x, g, table, lv))
    plain_ms = cuda_ms(lambda: hashgrid.hashgrid_position_grad_plain(grid, table, x, g), reps=3,
                       warmup=1)
    rows = touched_rows(grid, x)
    lc = grid.simplex_start
    corners = 8 * lc + 4 * (nl - lc)
    # Operations: per corner or vertex the C-wide dot (2C) and its weight
    # derivatives (~9).
    b_ms, b_by = bound_ms(nbytes=n * 12 + n * nl * c * 4 + rows * c * 4 + n * 12,
                          flops=n * corners * (2 * c + 9))
    log(f"{kid} hashgrid_position_grad at {what}: {n} points x {nl} levels (C={c}), {rows} "
        f"distinct rows read; max_abs_err {err:.3e} of largest |d x| {scale:.3e} (tol "
        f"{K2X_TOL} of it); ms {ms:.4f} (graph; cold {c_ms:.4f}), plain_ms {plain_ms:.3f}, "
        f"bound_ms {b_ms:.4f} ({b_by}), library none")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def stratified_crop_check(renderer, params, rays, crop, frame, fails) -> dict:
    """The dense stratified oracle (ops/stratified.py) on the frame's crop:
    STRATIFIED_SAMPLES jittered samples a ray over the crop's widest
    near_far_from_aabb interval, the field through K1 + K5, density 0
    outside each ray's own interval and in unoccupied cells (what the
    marcher skips), composited by integrate_points over the white
    background; against the two-phase frame's crop within
    STRATIFIED_BOUND."""
    from nerfstyle_torch.core.types import RayBundle
    from nerfstyle_torch.models.fields import field_color, field_density
    from nerfstyle_torch.ops.aabb import near_far_from_aabb
    from nerfstyle_torch.ops.marching import cell_index_and_size
    from nerfstyle_torch.ops.stratified import integrate_points, sample_points

    plan, s, spec = renderer.plan, renderer.settings, renderer.field_spec
    o, d = rays.origins[crop].contiguous(), rays.dirs[crop].contiguous()
    nears, fars = near_far_from_aabb(o, d, plan.aabb(o.device), plan.min_near)
    hit = fars > nears
    near, far = float(nears[hit].min()), float(fars[hit].max())
    gen = torch.Generator(device=o.device).manual_seed(9)
    rgb, acc = [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(0, o.shape[0], 1024):
            rb = RayBundle(o[i:i + 1024], d[i:i + 1024])
            pts, dists = sample_points(rb, near, far, STRATIFIED_SAMPLES, gen)
            k = pts.shape[1]
            flat = pts.reshape(-1, 3)
            z = ((pts - rb.origins[:, None]) * rb.dirs[:, None]).sum(-1)  # unit dirs
            inside = (z >= nears[i:i + 1024, None]) & (z < fars[i:i + 1024, None])
            idx, *_ = cell_index_and_size(flat.clamp(-plan.bound, plan.bound), bound=plan.bound,
                                          cascade=plan.cascade, grid_size=plan.grid_size,
                                          mip_dt_level=plan.mip_dt_level)
            occupied = renderer.occ_state.bitfield[idx].reshape(-1, k)
            sig = field_density(spec, params, renderer.bbox, flat, renderer.compute_dtype)
            sig = (sig * s.density_scale).reshape(-1, k) * (inside & occupied)
            ch = field_color(spec, params, renderer.bbox, flat, renderer.compute_dtype)
            zeros = torch.zeros((rb.origins.shape[0], 1), device=o.device)
            r, a, _ = integrate_points(dists, ch[:, :3].reshape(-1, k, 3), sig,
                                       torch.zeros((zeros.shape[0], 3), device=o.device), zeros,
                                       torch.ones_like(zeros))
            rgb.append(r + (1.0 - a))
            acc.append(a[:, 0])
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    rgb, acc = torch.cat(rgb), torch.cat(acc)
    drgb = (rgb - frame["rgb_map"][crop]).abs()
    dacc = (acc - frame["weights_sum"][crop]).abs()
    got = {"rgb mean": float(drgb.mean()), "opacity mean": float(dacc.mean()),
           "rgb > 0.1 share": float((drgb.amax(-1) > 0.1).double().mean())}
    bad = {k: v for k, v in got.items() if not v <= STRATIFIED_BOUND[k]}
    if bad:
        fails.append(f"the dense stratified crop departs from the two-phase frame's: {bad} "
                     f"(bounds {STRATIFIED_BOUND})")
    log(f"dense stratified crop ({o.shape[0]} rays x {STRATIFIED_SAMPLES} samples over "
        f"[{near:.3f}, {far:.3f}], the field through K1 + K5, {dense_s:.2f} s) against the "
        f"two-phase frame's crop: {got} (bounds {STRATIFIED_BOUND}); max |rgb| "
        f"{float(drgb.max()):.4f}, max |opacity| {float(dacc.max()):.4f}; mean opacity dense "
        f"{float(acc.mean()):.4f}, frame {float(frame['weights_sum'][crop].mean()):.4f}")
    return got


def library_api_phase(renderer, params, pose, rays, frame, card: str, fails) -> dict:
    """The library API on the card (no entry point calls it, in either
    package): K1/K1s at style slots LIBRARY_STYLES on the frame's phase-A
    stream, bit for bit against the plain encode at the same slot (rows at
    63; s = 63 and s = 0 timed in turns); a multi-style round trip (K9 to
    64 slots on a small grid, then K1 at 63 against the plain encode of
    that table); K2x on the frame's kept stream (C = 2) and on a simplex
    spec; the progressive and CMYK JPEGs; the dense stratified crop against
    the two-phase frame's (a central and a silhouette crop);
    ``Renderer.render`` of a patch against the frame's crop and of a
    training ray batch; VGG19's fallback filters on
    the card against the CPU.  Returns the kernel-table entries."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.core.types import Box2D
    from nerfstyle_torch.models import vgg
    from nerfstyle_torch.ops import hashgrid

    t_phase = time.perf_counter()
    table = {}
    spec = renderer.field_spec
    grid_s = dataclasses.replace(spec.grid, simplex_from=SIMPLEX_FROM)
    dens, color = params["x_density_embedder"], params["x_color_embedder"]
    x_a, x_b = frame_streams(renderer, params, rays.origins, rays.dirs)

    # K1 and K1s at every style slot; the rows at 63; 63 and 0 in turns.
    for grid, kid in ((spec.grid, "K1"), (grid_s, "K1s")):
        lv = hashgrid.level_table(grid, x_a.device)
        for style in LIBRARY_STYLES:
            got = kernels.hashgrid_encode(x_a, dens, lv, hashgrid.style_term(style))
            want = hashgrid.hashgrid_encode(grid, dens, x_a, style=style, plain=True)
            if not torch.equal(got, want):
                fails.append(f"{kid} at style {style} on the frame's phase-A stream differs from "
                             f"the plain encode (max abs err {float((got - want).abs().max())})")
        del got, want
        table[f"{kid} frame A s63"] = k1_row(grid, dens, x_a, "a frame chunk's marched samples "
                                             "(phase A, density)", fails, style=63)
        turns = [graph_ms(lambda s=st: hashgrid.hashgrid_encode(grid, dens, x_a, style=s))
                 for st in (0, 63, 63, 0)]
        log(f"{kid} on the frame's phase-A stream ({x_a.shape[0]} points), bit-equal to plain at "
            f"styles {LIBRARY_STYLES}; ms in turns s=0, 63, 63, 0: "
            f"{['%.4f' % t for t in turns]} ({card})")

    # The multi-style round trip.
    small = hashgrid.hashgrid_spec(num_levels=6, level_dim=2, base_resolution=8,
                                   per_level_scale=1.5, log2_hashmap_size=14)
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    ref = torch.rand((small.total_params, 2), generator=gen, device=DEVICE) * 2 - 1
    multi = hashgrid.grid_initialize(small, small, ref, 64)
    pts = torch.rand((1 << 16, 3), generator=gen, device=DEVICE)
    got = hashgrid.hashgrid_encode(small, multi, pts, style=63)
    want = hashgrid.hashgrid_encode(small, multi, pts, style=63, plain=True)
    same_as_ref = float((got == hashgrid.hashgrid_encode(small, ref, pts)).all(-1).double().mean())
    if not torch.equal(got, want):
        fails.append("K1 at style 63 of a K9-initialized 64-slot table differs from the plain "
                     "encode of that table")
    log(f"multi-style round trip: K9 to 64 slots ({small.total_params} rows), K1 at style 63 "
        f"bit-equal to plain: {torch.equal(got, want)}; points whose features equal the "
        f"reference's at style 0: {same_as_ref:.4f} (the rest read a row a colliding corner "
        f"wrote)")

    # K2x on the kept stream, trilinear and simplex levels.
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    table["K2x frame B"] = k2x_row(spec.grid, color, x_b, "a frame chunk's kept samples "
                                   "(phase B, color, C=2)", gen, fails)
    table["K2x simplex"] = k2x_row(grid_s, color, x_b, "a frame chunk's kept samples with "
                                   f"simplex levels from {SIMPLEX_FROM}", gen, fails)
    del x_a, x_b

    jpeg_decode_ms(fails)

    # The dense stratified oracle on the frame's central 64 x 64 pixels (a
    # sphere's inside) and on the 64 x 64 window (of a 32-pixel stride)
    # whose mean opacity is nearest 0.5 (a silhouette); Renderer.render's
    # patch on the central one.
    w, h = OUT_DIMS
    opacity = torch.nn.functional.avg_pool2d(frame["weights_sum"].reshape(1, h, w), 64, 32)
    wy, wx = divmod(int((opacity[0] - 0.5).abs().argmin()), opacity.shape[2])
    crops = {}
    for name, (y0, x0) in (("central", (h // 2 - 32, w // 2 - 32)),
                           ("silhouette", (32 * wy, 32 * wx))):
        ys, xs = np.meshgrid(np.arange(y0, y0 + 64), np.arange(x0, x0 + 64), indexing="ij")
        crops[name] = torch.from_numpy((ys * w + xs).reshape(-1)).to(DEVICE)
        log(f"the {name} crop: pixels x {x0}-{x0 + 63}, y {y0}-{y0 + 63}")
        stratified_crop_check(renderer, params, rays, crops[name], frame, fails)
    crop = crops["central"]
    patch = renderer.render(params, pose, patch=Box2D(x=w // 2 - 32, y=h // 2 - 32, w=64, h=64))
    tol = {"rgb_map": 2e-3, "trans_map": 2e-3, "weights_sum": 2e-3, "classes": 2e-2}
    errs = {k: float((patch[k] - frame[k][crop]).abs().max()) for k in tol}
    equal = all(torch.equal(patch[k], frame[k][crop]) for k in tol)
    if not all(errs[k] <= v for k, v in tol.items()):
        fails.append(f"Renderer.render of the central patch departs from the frame's crop: {errs}")
    log(f"Renderer.render(patch=Box2D 64x64) against the frame's crop: bit-equal {equal}, max "
        f"abs err {errs} (tol, the crop check's: {tol})")
    ygrid, xgrid = torch.meshgrid(torch.arange(h, device=DEVICE), torch.arange(w, device=DEVICE),
                                  indexing="ij")
    img = torch.stack([ygrid, xgrid, ygrid * w + xgrid]).float()
    batch = renderer.render(params, pose, img, num_rays=4096, training=True,
                            generator=torch.Generator(device=DEVICE).manual_seed(13))
    tgt = batch["target"]
    ok = (all(bool(torch.isfinite(batch[k]).all()) for k in tol)
          and tgt.shape == (4096, 3) and torch.equal(tgt[:, 0] * w + tgt[:, 1], tgt[:, 2])
          and torch.unique(tgt[:, 2]).numel() == 4096)
    if not ok:
        fails.append("Renderer.render(training=True, num_rays=4096): maps not finite, or a "
                     "target that is not its ray's pixel, or a repeated pixel")
    log(f"Renderer.render(training=True, num_rays=4096): finite maps and distinct targets that "
        f"match their pixels: {ok}; {batch['num_points']} samples marched, mean opacity "
        f"{float(batch['weights_sum'].mean()):.4f}")

    # VGG19's fallback filters, every convN_M key, card against the CPU.
    keys = [f"conv{b + 1}_{i + 1}" for b, blk in enumerate(vgg.VGG19_LAYERS)
            for i in range(len(blk))]
    params19 = vgg._init_params(vgg._VGG19_BLOCKS)
    img = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(14))
    on_cpu = vgg.VGG19FeatureExtractor(keys, params=params19)(img)
    on_card = vgg.VGG19FeatureExtractor(keys, device=DEVICE, params=params19)(img.to(DEVICE))
    report = {k: float((on_card[k].cpu() - on_cpu[k]).abs().max() / on_cpu[k].abs().max())
              for k in keys}
    bad = {k: v for k, v in report.items() if not v <= 1e-5}
    if bad:
        fails.append(f"VGG19 on the card departs from the CPU past 1e-5 of the largest entry: {bad}")
    log(f"VGG19 (fallback filters) at 64x64, card against CPU, max abs err over the largest "
        f"entry: worst {max(report.values()):.2e} ({max(report, key=report.get)}), every key "
        f"within 1e-5: {not bad}")
    log(f"library_api_phase ran {time.perf_counter() - t_phase:.1f} s")
    return table


# ---------------------------------------------------------------------------
# VGG16 at ties, and the style image
# ---------------------------------------------------------------------------


def vgg_tie_check(fails) -> None:
    """VGG16's input gradient on a planted-tie frame on the card against
    the CPU, layer by layer (tests/test_torch_vgg_ties.py's frame at
    128x96, the fallback filters: a white background, whose features tie
    in every pool window; a band of the ImageNet mean, which normalizes to
    exactly 0, so that the zero-bias filters give exactly-0
    pre-activations; a patch of repeated 2x2 windows).  cuDNN's
    convolutions and max-pool backward must keep what the CPU's keep (the
    JAX package's rules: half the gradient at an exact 0, a pool tie to the
    window's first element): atol 1e-4 of the largest entry (fp32 sums in
    another order).  Logs each layer's error and the exact zeros of each
    conv layer on both devices."""
    from nerfstyle_torch.models import vgg

    keys = [f"{op}{b + 1}_{i + 1}" for b, blk in enumerate(vgg.VGG16_LAYERS[:3])
            for i in range(len(blk)) for op in ("conv", "relu")]
    params = vgg._init_params(vgg._VGG16_BLOCKS[:3])
    fx = {"cpu": vgg.VGG16FeatureExtractor(keys, params=params),
          "cuda": vgg.VGG16FeatureExtractor(keys, device=DEVICE, params=params)}
    h, w = 96, 128
    rng = np.random.default_rng(0)
    img = np.ones((3, h, w), np.float32)
    img[:, :, :40] = np.asarray(vgg._IMAGENET_MEAN, np.float32)[:, None, None]
    patch = rng.random((3, 24, 32)).astype(np.float32)
    img[:, 32:80, 48:112] = np.repeat(np.repeat(patch, 2, axis=1), 2, axis=2)
    report, zeros = {}, {}
    for key in keys:
        grads = {}
        for dev, f in fx.items():
            x = torch.from_numpy(img).to("cpu" if dev == "cpu" else DEVICE).requires_grad_(True)
            feats = f(x)
            if key.startswith("conv"):
                zeros.setdefault(key, {})[dev] = int((feats[key] == 0).sum())
            cot = torch.from_numpy(np.random.default_rng(1).normal(
                size=tuple(feats[key].shape)).astype(np.float32)).to(x.device)
            (g,) = torch.autograd.grad((feats[key] * cot).sum(), x)
            grads[dev] = g.cpu()
        report[key] = float((grads["cuda"] - grads["cpu"]).abs().max()
                            / grads["cpu"].abs().max())
    bad = {k: v for k, v in report.items() if not v <= 1e-4}
    if bad:
        fails.append(f"VGG16 input gradient on the planted-tie frame, card against CPU: {bad} "
                     "past 1e-4 of the largest entry (the first departing layer first)")
    log(f"VGG16 planted-tie frame ({w}x{h}), card against CPU, max abs err of the input "
        f"gradient over its largest entry by layer: "
        + ", ".join(f"{k} {v:.1e}" for k, v in report.items())
        + "; exact zeros of the conv layers (cpu, cuda): "
        + ", ".join(f"{k} {z['cpu']}/{z['cuda']}" for k, z in zeros.items()))


def relu_ab_ms(st, card: str, reps: int = 5) -> dict:
    """Steady style iterations with VGG16's ReLU as ``torch.relu`` (gradient
    0 at an exact 0: the extractor before its tie repair) and as the port's
    ``vgg.relu`` (JAX's 0.5 there), in turns (old, new, new, old, ``reps``
    iterations each, host clock to a device sync): the repair's cost on
    the device-bound iteration.  Returns the medians."""
    from unittest import mock

    from nerfstyle_torch.models import vgg

    times = {"torch.relu": [], "vgg.relu": []}
    for which in ("torch.relu", "vgg.relu", "vgg.relu", "torch.relu"):
        with mock.patch.object(vgg, "relu", torch.relu if which == "torch.relu" else vgg.relu):
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                st.run_iter()
                torch.cuda.synchronize()
                times[which].append((time.perf_counter() - t) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"steady style iteration ({card}) by VGG16 ReLU, in turns old/new/new/old: "
        f"torch.relu median {med['torch.relu']:.2f} ms "
        f"{['%.2f' % t for t in times['torch.relu']]}, "
        f"vgg.relu (0.5 at 0) median {med['vgg.relu']:.2f} ms "
        f"{['%.2f' % t for t in times['vgg.relu']]}")
    return med


def gif_frames(path: Path) -> int:
    """The image descriptors of a GIF file, walked block by block."""
    blob = path.read_bytes()
    if blob[:6] != b"GIF89a":
        raise ValueError(f"{path} does not start with GIF89a")
    pos = 13 + (3 << ((blob[10] & 7) + 1) if blob[10] & 0x80 else 0)
    frames = 0

    def skip_sub_blocks(at):
        while blob[at]:
            at += blob[at] + 1
        return at + 1

    while pos < len(blob) and blob[pos] != 0x3B:
        if blob[pos] == 0x21:
            pos = skip_sub_blocks(pos + 2)
        elif blob[pos] == 0x2C:
            frames += 1
            flags = blob[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)
        else:
            raise ValueError(f"{path}: unknown GIF block 0x{blob[pos]:02x} at {pos}")
    return frames


# ---------------------------------------------------------------------------
# Data parallelism over rays (nerfstyle_torch.parallel): the dp phase
# ---------------------------------------------------------------------------

DP_STEPS = 8  # late train steps a run (from step 300: one occupancy update, at 304)
DP_TIMED_STEPS = 4  # then with each collective bracketed by device syncs
DP_POSE = 0  # the style steps' train pose
DP_TRAIN_COUNTERS = ("hashgrid_encode", "hashgrid_backward", "march_skip_count",
                     "march_skip_write", "composite_weights", "composite_backward",
                     "mlp_forward", "mlp_backward", "occupancy_scatter_max", "occupancy_merge",
                     "occupancy_skipdist", "segment_sum")
DP_STYLE_COUNTERS = ("hashgrid_encode", "hashgrid_backward", "mlp_forward", "mlp_backward",
                     "segment_sum", "segment_sum_backward")
DP_PASS2_COUNTERS = ("hashgrid_encode", "hashgrid_backward", "march_skip_count",
                     "composite_weights", "composite_backward", "mlp_forward", "mlp_backward")
DP_FRAME_COUNTERS = ("hashgrid_encode", "march_skip_count", "march_skip_write",
                     "composite_weights", "mlp_forward", "segment_sum")


def dp_world() -> tuple:
    """(ranks, backend): NCCL over every card where there are two or more,
    else two ranks sharing the one card over gloo."""
    n = torch.cuda.device_count()
    return (n, "nccl") if n >= 2 else (2, "gloo")


def dp_train_argv(ckpt: Path, log_dir: Path) -> list:
    """The train phase's run resumed from its checkpoint (step 300), every
    interval off."""
    return ["--ckpt", str(ckpt), "--log-dir", str(log_dir), "--data-cfg", str(WORK / "data.yaml"),
            "--num_iterations", str(TRAIN_STEPS + 1000), "--intervals.print", "0",
            "--intervals.log", "0", "--intervals.test", "0", "--intervals.ckpt", "0", "--yes"]


def dp_style_argv(ckpt: Path, log_dir: Path) -> list:
    """The style phase's configuration from the train checkpoint, every
    interval off (the scheme does not matter: the checks call the steps'
    parts)."""
    return ["--ckpt", str(ckpt), "--log-dir", str(log_dir),
            "--data-cfg", str(WORK / "style_data.yaml"), "--style-image", str(STYLE_JPEG),
            "--style_seg_path", str(WORK / "style_seg.npz"), "--max_steps", "512",
            "--intervals.print", "0", "--intervals.log", "0", "--intervals.test", "0",
            "--intervals.ckpt", "0", "--yes"]


def dp_trainer(argv: list, device, mesh=None):
    from nerfstyle_torch.config import BaseConfig
    from nerfstyle_torch.training.trainer import get_trainer

    cfg, nargs = BaseConfig.read_nargs(argv)
    return get_trainer(cfg, nargs, device, mesh)


def dp_run(tt, st, renderer, params, pose, pin=None) -> dict:
    """The dp phase's work on one rank (or unsharded, without a mesh): the
    first late batch's losses and gradient (no step applied), DP_STEPS late
    steps, DP_TIMED_STEPS more with the collectives timed, a cached style
    step (pinned to ``pin``'s choices, and unpinned), pass 1 and pass 2 of
    the two-pass scheme on one pose, and a 1008x756 frame; each part's
    kernel launches."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.parallel import MeshStats

    out: dict = {"launches": {}}
    mesh = tt.mesh

    def counted(part, fn):
        kernels.reset_launch_counts()
        r = fn()
        torch.cuda.synchronize()
        out["launches"][part] = dict(kernels.launch_counts)
        return r

    batch = tt.ray_batch(*tt.sample_batch())
    losses, grads, counts = counted("first batch", lambda: tt.loss_and_grads(*batch))
    out["first"] = {"losses": {k: float(v) for k, v in losses.items()}, "counts": counts,
                    "grads": {k: [g.detach() for g in (v if isinstance(v, list) else [v])]
                              for k, v in grads.items()}}
    if mesh is None:  # the run-to-run noise of the same batch (K2's atomics)
        again = tt.loss_and_grads(*batch)[1]
        out["first"]["noise"] = {
            f"{k}.{i}": rel_l2(a, b) for k, v in again.items()
            for i, (a, b) in enumerate(zip(v if isinstance(v, list) else [v],
                                           out["first"]["grads"][k]))}
        del again
    del grads, batch

    def steps(n):
        before = len(tt.iter_ms)
        for _ in range(n):
            tt.run_iter()
        torch.cuda.synchronize()
        return tt.iter_ms[before:]

    if mesh is not None:
        mesh.stats = MeshStats()
    out["step_ms"] = counted("train steps", lambda: steps(DP_STEPS))
    out["step_losses"] = [float(tt.last_losses["total"])]
    if mesh is not None:
        out["untimed_stats"] = dataclasses.asdict(mesh.stats)
        mesh.stats, mesh.timed = MeshStats(), True
        out["timed_step_ms"] = steps(DP_TIMED_STEPS)
        mesh.timed = False
        out["timed_stats"] = dataclasses.asdict(mesh.stats)
    out["update_ms"] = {k: list(v) for k, v in tt.renderer.update_ms.items()}
    out["params_sum"] = float(sum(w.detach().double().sum() for v in tt.params.values()
                                  for w in (v if isinstance(v, list) else [v])))
    out["bitfield_sum"] = int(tt.renderer.occ_state.bitfield.sum())

    cache = st.geom_cache(DP_POSE)
    st.init_matching(cache)
    if pin is not None:
        k = style_step_run(st, cache, pin=pin)
        out["cached_pinned"] = {"losses": {n: float(v) for n, v in k[0].items()}, "grad": k[1]}
    k = style_step_run(st, cache)
    out["launches"]["cached step"] = k[3]
    out["cached"] = {"losses": {n: float(v) for n, v in k[0].items()}, "grad": k[1],
                     "choices": (k[2].made, k[2].pool_live)}
    if pin is not None:
        out["cached"]["flips"] = k[2].flips(pin)
    with torch.no_grad():
        rgb, cls = st.render_frame(st.params, DP_POSE)
    _, pix = st.pixel_grad(rgb, st.target(DP_POSE), st._preds(cls))
    out["pass1"] = {"rgb": rgb, "classes": cls}
    out["pass2"] = counted("pass 2", lambda: st.window_grads(st.params, DP_POSE, pix))[
        "x_color_embedder"]
    with torch.no_grad():
        frame = counted("frame", lambda: renderer.render(params, pose))
    out["frame"] = {k: frame[k] for k in ("rgb_map", "trans_map", "classes", "weights_sum",
                                          "num_marched", "num_sig", "num_cand")}
    return out


def dp_rank(rank: int, world: int, backend: str, job_dir: str) -> None:
    """One rank of the dp phase (a process of its own): the mesh, the
    trainers on it, dp_run; rank 0 writes its results, every rank its
    checksums and launches."""
    sys.path.insert(0, str(ROOT))
    from nerfstyle_torch.parallel import make_mesh
    from nerfstyle_torch.render import cli

    job_dir = Path(job_dir)
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    mesh = make_mesh(dev, backend, init_method=f"file://{job_dir / 'init'}", rank=rank,
                     world_size=world)
    try:
        tt = dp_trainer(dp_train_argv(WORK / "train" / f"iter_{TRAIN_STEPS}.ckpt",
                                      job_dir / "train"), dev, mesh)
        st = dp_trainer(dp_style_argv(WORK / "train" / f"iter_{TRAIN_STEPS}.ckpt",
                                      job_dir / "style"), dev, mesh)
        renderer, params, test_set, _ = cli.load_renderer(WORK / "smoke.ckpt", dev, OUT_DIMS,
                                                          max_count=1, mesh=mesh)
        assert tt.mesh is mesh and st.mesh is mesh and renderer.mesh is mesh
        pin = StepChoices()
        pin.made, pin.pool_live = torch.load(job_dir / "choices.pt", map_location=dev,
                                             weights_only=False)
        pose = torch.from_numpy(np.asarray(test_set[0][1]))
        out = dp_run(tt, st, renderer, params, pose, pin)
        if rank:
            out = {k: out[k] for k in ("launches", "params_sum", "bitfield_sum", "step_losses")}
        out["cached"] = {k: v for k, v in out.get("cached", {}).items() if k != "choices"}
        torch.save(out, job_dir / f"rank{rank}.pt")
    finally:
        mesh.close()


def dp_phase(card: str, fails) -> dict:
    """Data parallelism over rays on the card(s): the unsharded run of
    dp_run here, then the same run on dp_world()'s ranks (processes of
    their own, started together), each held against the unsharded run at
    its path's card tolerance: the first late batch's losses (1e-5
    relative) and gradient (5e-3 relative L2 a leaf), the losses after the
    late steps (1e-3 relative: the same steps' updates in another order of
    sums), the cached style step with its discrete choices pinned to the
    unsharded step's (losses 1e-5, gradient 5e-3) and its flips unpinned
    (at most STYLE_FLIP_BOUND), pass 1 (the gathered frame: 2e-3 absolute),
    pass 2 (5e-3 relative L2) and the 1008x756 frame (the crop's
    tolerances; bit-equality counted).  Every rank's parameters and grid
    must be equal after the steps (their sums), and every part must launch
    its kernels on every rank.  Logs and returns the step times with and
    without the mesh, the collectives a step, the bytes they move and their
    share of a step."""
    import torch.multiprocessing as mp

    from nerfstyle_torch.render import cli

    world, backend = dp_world()
    job_dir = WORK / "dp"
    shutil.rmtree(job_dir, ignore_errors=True)
    job_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    ckpt = WORK / "train" / f"iter_{TRAIN_STEPS}.ckpt"
    tt = dp_trainer(dp_train_argv(ckpt, job_dir / "train_ref"), DEVICE)
    st = dp_trainer(dp_style_argv(ckpt, job_dir / "style_ref"), DEVICE)
    renderer, params, test_set, _ = cli.load_renderer(WORK / "smoke.ckpt", DEVICE, OUT_DIMS,
                                                      max_count=1)
    pose = torch.from_numpy(np.asarray(test_set[0][1]))
    ref = dp_run(tt, st, renderer, params, pose)
    del tt, st, renderer, params
    torch.cuda.empty_cache()
    torch.save(ref["cached"]["choices"], job_dir / "choices.pt")
    ref_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    mp.spawn(dp_rank, args=(world, backend, str(job_dir)), nprocs=world, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(job_dir / f"rank{r}.pt", map_location=DEVICE, weights_only=False)
             for r in range(world)]
    got = ranks[0]

    checks = {}
    lerr = {k: abs(got["first"]["losses"][k] - v) / max(abs(v), 1e-30)
            for k, v in ref["first"]["losses"].items()}
    checks["first losses"] = (max(lerr.values()), 1e-5)
    gerr = {f"{k}.{i}": rel_l2(a, b) for k, v in ref["first"]["grads"].items()
            for i, (a, b) in enumerate(zip(got["first"]["grads"][k], v))}
    checks["first gradient"] = (max(gerr.values()), 5e-3)
    worst = max(gerr, key=gerr.get)
    noise = ref["first"]["noise"]
    if got["first"]["counts"] != ref["first"]["counts"]:
        fails.append(f"dp: the first batch's counts {got['first']['counts']} differ from the "
                     f"unsharded {ref['first']['counts']}")
    checks["late losses"] = (abs(got["step_losses"][0] - ref["step_losses"][0])
                             / abs(ref["step_losses"][0]), 1e-3)
    pl = got["cached_pinned"]["losses"]
    checks["cached losses"] = (max(abs(pl[k] - v) / max(abs(v), 1e-30)
                                   for k, v in ref["cached"]["losses"].items()), 1e-5)
    checks["cached gradient, pinned"] = (rel_l2(got["cached_pinned"]["grad"],
                                                ref["cached"]["grad"]), 5e-3)
    checks["pass 1 rgb"] = (float((got["pass1"]["rgb"] - ref["pass1"]["rgb"]).abs().max()), 2e-3)
    checks["pass 2 gradient"] = (rel_l2(got["pass2"], ref["pass2"]), 5e-3)
    frame_err = {k: float((got["frame"][k] - ref["frame"][k]).abs().max())
                 for k in ("rgb_map", "trans_map", "weights_sum", "classes")}
    for k, tol in {"rgb_map": 2e-3, "trans_map": 2e-3, "weights_sum": 2e-3,
                   "classes": 2e-2}.items():
        checks[f"frame {k}"] = (frame_err[k], tol)
    frame_equal = all(torch.equal(got["frame"][k], ref["frame"][k]) for k in frame_err)
    for name, (err, tol) in checks.items():
        if not err <= tol:
            fails.append(f"dp: {name} off the unsharded run by {err} (tol {tol})")
    if any(got["frame"][k] != ref["frame"][k] for k in ("num_marched", "num_sig", "num_cand")):
        fails.append("dp: the sharded frame's counters differ from the unsharded frame's")
    same = [(r["params_sum"], r["bitfield_sum"], r["step_losses"]) for r in ranks]
    if any(s != same[0] for s in same):
        fails.append(f"dp: the ranks' params, grids or losses differ after the steps: {same}")
    need = {"first batch": TRAIN_COUNTERS[:2], "train steps": DP_TRAIN_COUNTERS,
            "cached step": DP_STYLE_COUNTERS, "pass 2": DP_PASS2_COUNTERS,
            "frame": DP_FRAME_COUNTERS}
    for r, res in enumerate(ranks):
        for part, names in need.items():
            missing = [n for n in names if res["launches"][part].get(n, 0) <= 0]
            if missing:
                fails.append(f"dp: rank {r}'s {part} launched no {missing}")
    unpinned = rel_l2(got["cached"]["grad"], ref["cached"]["grad"])
    flips = got["cached"]["flips"]
    over = {n: v for n, v in flips.items() if v > STYLE_FLIP_BOUND[n]}
    if over:
        fails.append(f"dp: the sharded style step's choices flipped more than "
                     f"{STYLE_FLIP_BOUND}: {over}")

    ts, us = got["timed_stats"], got["untimed_stats"]
    timed_ms = float(np.median(got["timed_step_ms"]))
    coll_ms = ts["seconds"] * 1e3 / DP_TIMED_STEPS
    res = {
        "card": card, "ranks": world, "backend": backend,
        "shared_card": backend == "gloo", "late_steps": DP_STEPS,
        "step_ms_one_rank": float(np.median(ref["step_ms"])),
        "step_ms_sharded": float(np.median(got["step_ms"])),
        "step_ms_sharded_timed": timed_ms,
        "collective_ms_a_step": coll_ms,
        "collective_share": coll_ms / timed_ms,
        "collectives_a_step": us["collectives"] / DP_STEPS,
        "bytes_a_step": us["bytes"] / DP_STEPS,
        "occupancy_update_ms": {"one rank": ref["update_ms"]["random"][-1:],
                                "sharded": got["update_ms"]["random"][-1:]},
        "frame_bit_equal": frame_equal,
        "cached_gradient_unpinned_rel_l2": unpinned, "cached_flips": flips,
        "first_gradient_worst_leaf": [worst, gerr[worst], noise[worst]],
        "first_gradient_noise_max": max(noise.values()),
        "errors": {k: v[0] for k, v in checks.items()},
        "reference_s": ref_s, "ranks_s": spawn_s,
    }
    log(f"dp ({card}): {world} ranks over {backend}{' sharing one card' if backend == 'gloo' else ''}"
        f"; late step {res['step_ms_one_rank']:.2f} ms on one rank, {res['step_ms_sharded']:.2f} "
        f"ms sharded ({timed_ms:.2f} ms with the collectives timed: {coll_ms:.2f} ms of "
        f"collectives, share {res['collective_share']:.3f}); {res['collectives_a_step']:.1f} "
        f"collectives and {res['bytes_a_step'] / 2**20:.1f} MiB a rank a step; errors against "
        f"the unsharded run {res['errors']}; cached gradient unpinned {unpinned:.3e} (flips "
        f"{flips}); first gradient worst leaf {worst} {gerr[worst]:.3e} (one rank against itself "
        f"on the same batch: {noise[worst]:.3e}, all leaves at most {max(noise.values()):.3e}); "
        f"frame "
        f"bit-equal: {frame_equal}; unsharded run {ref_s:.1f} s, ranks {spawn_s:.1f} s")
    print(json.dumps({"dp": res}), flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from nerfstyle_torch import kernels
    from nerfstyle_torch.core.cameras import generate_rays
    from nerfstyle_torch.render import cli

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = kernels.build(verbose=True)
    kernels.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib.relative_to(ROOT)}")

    WORK.mkdir(parents=True, exist_ok=True)
    ckpt = WORK / "smoke.ckpt"
    spec = write_checkpoint(ckpt)
    renderer, params, test_set, _ = cli.load_renderer(ckpt, DEVICE, OUT_DIMS, max_count=1)
    pose = torch.from_numpy(np.asarray(test_set[0][1]))
    rays, _ = generate_rays(pose.to(DEVICE), renderer.intr,
                            camera_flip=renderer.settings.flip_camera)

    count_hashgrid_streams()
    count_composite_streams()
    table, fails = kernel_phases(renderer, params, rays.origins, rays.dirs)
    # Grid sizes and class heads off the defaults.
    table["K6c 256"] = skipdist_sizes_phase(renderer, params, rays.origins, rays.dirs, fails)
    class_head_phase(renderer, params, fails)
    # K5d, K9 and P0 against their plain versions.
    table.update(new_kernel_phases(renderer, params, rays.dirs, fails))

    # The main path, through the CLI entry point (the checkpoint's restore
    # rebuilds the skip distance: K6c).
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    summary = cli.main([str(ckpt), "--out-dims", *map(str, OUT_DIMS), "--max-count", "1",
                        "--yes", "--out-dir", str(WORK / "render"), "--device", DEVICE])
    runs = {"render": read_counts()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name in RENDER_COUNTERS:
        if runs["render"][name] <= 0:
            fails.append(f"render path launched no {name} kernel")
    for name in DENSE_COUNTERS:
        if runs["render"][name]:
            fails.append(f"render path launched the dense march ({name}) with adaptive_march on")
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
        f"{out['num_sig'] / npix:.2f} significant, {out['num_cand'] / npix:.2f} candidate "
        f"windows/ray, peak memory {peak_gib:.2f} GiB, launches {runs['render']}")

    iou = silhouette_iou(rays.origins, rays.dirs, out["weights_sum"])
    log(f"opacity vs analytic sphere silhouette: IoU {iou:.4f}")
    if not iou >= 0.8:
        fails.append(f"frame opacity IoU with the spheres {iou:.4f} < 0.8")

    # A 4096-ray crop (the central 64x64 pixels) through the plain path on
    # the card.  K1, K3s exact; K4 may flip a sample at the t_thresh cutoff
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

    # The dense march's frame against the main path's, and steady frames
    # with adaptive_march on and off; the on frame's device time by kernel.
    runs["dense frame"] = frame_on_off(renderer, params, pose, out, card, fails)
    profile_once(lambda: renderer.render(params, pose), "frame", card)
    # The view configuration: both view-dependent families through the
    # Renderer on the same frame.
    runs.update(view_phase(renderer, params, pose, rays, card, fails))
    # The incremental renderer (infer_two_phase False) on the same frame.
    runs["incremental"], inc_table = incremental_phase(renderer, params, pose, rays, card, fails)
    table.update(inc_table)
    # The library API on the same frame: style slots, K2x, the stratified
    # oracle, Renderer.render's patch and ray batch, VGG19, the JPEGs.
    table.update(library_api_phase(renderer, params, pose, rays, out, card, fails))

    # The import path, from the render checkpoint; its frame must equal the
    # main path's.
    runs["import"], import_table = import_phase(card, ckpt, spec, out, fails)
    table.update(import_table)
    del renderer, params, rays, ref, out, summary
    torch.cuda.empty_cache()

    # The train path, through the train entry point; then one step against
    # the plain versions, the train kernels at the step's shapes, late steps
    # with adaptive_march on and off, and one late step under the profiler.
    trainer, runs["train"] = train_phase(card, fails)
    step_vs_plain(trainer, fails)
    table.update(train_kernel_phases(trainer, fails))
    runs["dense train"] = step_ms_on_off(trainer, card)
    for name in DENSE_COUNTERS:
        if runs["dense train"][name] <= 0:
            fails.append(f"the adaptive_march=False train steps launched no {name} kernel")
    profile_once(trainer.run_iter, "late train step", card)
    trace_late_steps(trainer, card, fails)
    ckpt_train = trainer.log_dir / f"iter_{TRAIN_STEPS}.ckpt"
    del trainer
    torch.cuda.empty_cache()

    # The LLFF and Replica layouts through train, render and style; the
    # LLFF run's trace window split step by step.
    runs.update(real_scene_phase(card, fails))

    # The style path from the train phase's checkpoint; then one step
    # against the plain versions, K5 and K7b at the style stream's shape, and
    # one steady iteration under the profiler.
    vgg_tie_check(fails)
    st, runs["style"] = style_phase(card, ckpt_train, fails)
    cached_ms = float(np.median(st.iter_ms[STYLE_VIEWS:]))
    style_step_vs_plain(st, fails)
    style_error_split(st)
    table.update(style_kernel_phases(st, fails))
    profile_once(st.run_iter, "steady style iteration", card)
    relu_ab_ms(st, card)
    del st
    torch.cuda.empty_cache()

    # The two-pass style scheme from the same checkpoint, its checks
    # against the cached path and the plain versions (also with the view
    # direction), and its streams' kernel rows.
    count_two_pass_streams()
    runs["two-pass"], two_pass_table = style_two_pass_phase(card, ckpt_train, cached_ms, fails)
    table.update(two_pass_table)
    torch.cuda.empty_cache()

    # The simplex configuration: a short run and a frame from its checkpoint.
    runs["simplex"], simplex_table = simplex_phase(card, fails)
    table.update(simplex_table)

    # Data parallelism over rays: the late train steps, a cached style step,
    # pass 1 and 2 of the two-pass scheme and the 1008x756 frame on
    # dp_world()'s ranks against the same work unsharded.
    dp_phase(card, fails)
    torch.cuda.empty_cache()

    # A kernel's launches: its counts on the paths it serves (K3's on the
    # adaptive_march=False frame and steps; K1s's and K2s's on the simplex
    # run and its frame, K1's and K2's on the main paths, each by stream;
    # K8a unpack's and K8b morton3d's on the import).
    # K8a pack and K8b invert serve no path: 0 launches, checked against
    # their plain versions only.  K3 and K3s are two passes each (count and
    # write), K6c kernels.SKIPDIST_LAUNCHES a rebuild: their launches are all
    # of theirs.
    main_paths = ("render", "train", "style", "two-pass", "incremental")
    # K1 and K2: a row a stream, with that stream's launches (see
    # ENCODE_STREAMS); every launch of theirs must fall in a stream with a
    # row.
    for path in (*main_paths, "simplex", "llff train", "llff render", "llff style",
                 "replica train"):
        for name in ("hashgrid_encode", "hashgrid_backward"):
            split = {k.split(":")[1]: v for k, v in runs[path].items()
                     if k.startswith(name + ":")}
            log(f"{name} launches on the {path} path by stream: {split}")
            if sum(split.values()) != runs[path][name] or split.get("other"):
                fails.append(f"{name} launches on the {path} path fall outside the streams "
                             f"with a row: {split} of {runs[path][name]}")
    # K4 and K4b: likewise, on every run (see COMPOSITE_STREAMS).
    composite_rows = {
        "frame A": "a frame chunk's marched samples (phase A)",
        "style": "a style pose's marched chunk (the cache build)",
        "train A": "a late train batch's marched samples (phase A: n_inc only)",
        "train B": "a late train batch's kept prefix (phase B)",
        "two-pass frame A": "a two-pass pass-1 chunk's marched samples (phase A: n_inc only)",
        "two-pass frame B": "a two-pass pass-1 chunk's kept prefix (phase B)",
        "two-pass window A": "a two-pass pass-2 window's marched samples (phase A: n_inc only)",
        "two-pass window B": "a two-pass pass-2 window's kept prefix (phase B)",
    }
    for path, counts in runs.items():
        for name in ("composite_weights", "composite_backward"):
            split = {k.split(":")[1]: v for k, v in counts.items() if k.startswith(name + ":")}
            log(f"{name} launches on the {path} run by stream: {split}")
            if sum(split.values()) != counts[name] or set(split) - set(composite_rows):
                fails.append(f"{name} launches on the {path} run fall outside the streams "
                             f"with a row: {split} of {counts[name]}")
    # The default paths launch no K5d: their field reads no direction.
    for path, counts in runs.items():
        k5d = sum(counts[c] for c in K5D_COUNTERS)
        if not path.startswith("view") and k5d:
            fails.append(f"the {path} run launched K5d {k5d} times")
    hg, cp = "nerfstyle_torch/csrc/hashgrid.cu", "nerfstyle_torch/csrc/composite.cu"
    encode_rows = {
        "frame A": "a frame chunk's marched samples (phase A: density, C=2)",
        "frame B": "a frame chunk's kept samples (phase B: color, C=2)",
        "train A": "a late train batch's marched samples (phase A: density, C=2)",
        "train B": "a late train batch's kept samples (phase B: fused [T, 4])",
        "style": "a style pose's cached samples (color, C=2)",
        "probe full": "a full occupancy sweep's probe chunk (density, C=2)",
        "probe random": "a random occupancy update's probe chunk (density, C=2)",
        "two-pass frame A": "a two-pass pass-1 chunk's marched samples (phase A: density, C=2)",
        "two-pass frame B": "a two-pass pass-1 chunk's kept samples (phase B: fused [T, 4])",
        "two-pass window A": "a two-pass pass-2 window's marched samples (phase A: density, "
                             "C=2)",
        "two-pass window B": "a two-pass pass-2 window's kept samples (phase B: fused [T, 4])",
    }
    meta = [(f"K1 {k}", f"K1 hashgrid_encode, {v}", hg, "nerfstyle_tpu/ops/hashgrid.py:818",
             (f"hashgrid_encode:{k}",), main_paths) for k, v in encode_rows.items()]
    meta += [(f"K1s {k}", f"K1s hashgrid_encode (simplex levels), {encode_rows[k]}", hg,
              "nerfstyle_tpu/ops/hashgrid.py:483", (f"hashgrid_encode:{k}",), ("simplex",))
             for k in ("frame A", "frame B", "train A", "train B", "probe full")]
    meta += [
        ("K2 train B", f"K2 hashgrid_backward, {encode_rows['train B']}", hg,
         "nerfstyle_tpu/ops/hashgrid.py:959", ("hashgrid_backward:train B",), main_paths),
        ("K2 style", f"K2 hashgrid_backward, {encode_rows['style']}", hg,
         "nerfstyle_tpu/ops/hashgrid.py:959", ("hashgrid_backward:style",), main_paths),
        ("K2s train B", f"K2s hashgrid_backward (simplex levels), {encode_rows['train B']}", hg,
         "nerfstyle_tpu/ops/hashgrid.py:979", ("hashgrid_backward:train B",), ("simplex",)),
        ("K3", "K3 march_rays (dense)", "nerfstyle_torch/csrc/march.cu",
         "nerfstyle_tpu/ops/marching.py:166", DENSE_COUNTERS, ("dense frame", "dense train")),
        ("K3s", "K3s march_rays (two-stage)", "nerfstyle_torch/csrc/march.cu",
         "nerfstyle_tpu/ops/marching.py:191", ("march_skip_count", "march_skip_write"),
         main_paths),
        ("K2 two-pass window B", f"K2 hashgrid_backward, {encode_rows['two-pass window B']}",
         hg, "nerfstyle_tpu/ops/hashgrid.py:959", ("hashgrid_backward:two-pass window B",),
         main_paths),
        *[(f"K4 {k}", f"K4 composite_weights, {v}", cp, "nerfstyle_tpu/ops/compositing.py:94",
           (f"composite_weights:{k}",), main_paths) for k, v in composite_rows.items()],
        ("K4b train B", f"K4b composite_backward, {composite_rows['train B']}", cp,
         "nerfstyle_tpu/ops/compositing.py:116", ("composite_backward:train B",), main_paths),
        ("K4b two-pass window B", f"K4b composite_backward, {composite_rows['two-pass window B']}",
         cp, "nerfstyle_tpu/ops/compositing.py:116", ("composite_backward:two-pass window B",),
         main_paths),
        ("K5f", "K5 mlp_forward", "nerfstyle_torch/csrc/mlp.cu",
         "nerfstyle_tpu/ops/mlp.py:45", ("mlp_forward",), main_paths),
        ("K5b", "K5 mlp_backward", "nerfstyle_torch/csrc/mlp.cu",
         "nerfstyle_tpu/ops/mlp.py:45", ("mlp_backward",), main_paths),
        ("K5bw", "K5 mlp_backward with d W (+ mlp_dw_reduce), 2^20-row train batch",
         "nerfstyle_torch/csrc/mlp.cu", "nerfstyle_tpu/ops/mlp.py:45", ("mlp_dw_reduce",),
         main_paths),
        ("K6s", "K6 occupancy_scatter_max", "nerfstyle_torch/csrc/occupancy.cu",
         "nerfstyle_tpu/ops/occupancy.py:281", ("occupancy_scatter_max",), main_paths),
        ("K6m", "K6 occupancy_merge", "nerfstyle_torch/csrc/occupancy.cu",
         "nerfstyle_tpu/ops/occupancy.py:157", ("occupancy_merge",), main_paths),
        ("K6c", "K6c occupancy_skipdist", "nerfstyle_torch/csrc/occupancy.cu",
         "nerfstyle_tpu/ops/occupancy.py:99", ("occupancy_skipdist",), main_paths),
        ("K6c 256", "K6c occupancy_skipdist, 2 x 256^3 (--grid_size 256; on no path at the "
         "default grid, 128)", "nerfstyle_torch/csrc/occupancy.cu",
         "nerfstyle_tpu/ops/occupancy.py:99", ("occupancy_skipdist",), ()),
        ("K7", "K7 segment_sum", "nerfstyle_torch/csrc/composite.cu",
         "nerfstyle_tpu/render/renderer.py:648", ("segment_sum",), main_paths),
        ("K7b", "K7b segment_sum_backward", "nerfstyle_torch/csrc/composite.cu",
         "nerfstyle_tpu/training/style_trainer.py:875", ("segment_sum_backward",), main_paths),
        ("K8a pack", "K8a packbits", "nerfstyle_torch/csrc/interop.cu",
         "nerfstyle_tpu/ops/occupancy.py:299", ("packbits",), ()),
        ("K8a unpack", "K8a unpackbits", "nerfstyle_torch/csrc/interop.cu",
         "nerfstyle_tpu/ops/occupancy.py:309", ("unpackbits",), ("import",)),
        ("K8b morton", "K8b morton3d", "nerfstyle_torch/csrc/interop.cu",
         "nerfstyle_tpu/ops/morton.py:27", ("morton3d",), ("import",)),
        ("K8b invert", "K8b morton3d_invert", "nerfstyle_torch/csrc/interop.cu",
         "nerfstyle_tpu/ops/morton.py:44", ("morton3d_invert",), ()),
        ("K5d", "K5d sh_encode (first entry) at a frame chunk's kept stream, 129,929 rows (on "
         "no path: the fields take the second entry)", "nerfstyle_torch/csrc/sh.cu",
         "nerfstyle_tpu/ops/sh.py:19", ("sh_encode",), ()),
        ("K5d style", "K5d sh_encode (first entry) at a style cache's size, 640,000 rows (on "
         "no path: the style stage's view-direction input takes the second entry)",
         "nerfstyle_torch/csrc/sh.cu", "nerfstyle_tpu/ops/sh.py:19", ("sh_encode",), ()),
        ("K5d assemble", "K5d sh_assemble (second entry): color2's input from color1 and the "
         "SH basis, a view frame chunk's kept samples (the view frames' phase B)",
         "nerfstyle_torch/csrc/sh.cu", "nerfstyle_tpu/ops/sh.py:19", ("sh_assemble",),
         ("view style", "view base")),
        ("K1 frame A s63", f"K1 hashgrid_encode at style 63, {encode_rows['frame A']} (on no "
         "path: the style slot is library API)", hg, "nerfstyle_tpu/ops/hashgrid.py:818",
         ("hashgrid_encode",), ()),
        ("K1s frame A s63", f"K1s hashgrid_encode (simplex levels) at style 63, "
         f"{encode_rows['frame A']} (on no path)", hg, "nerfstyle_tpu/ops/hashgrid.py:483",
         ("hashgrid_encode",), ()),
        ("K2 train B s63", f"K2 hashgrid_backward at style 63, {encode_rows['train B']} (on no "
         "path)", hg, "nerfstyle_tpu/ops/hashgrid.py:959", ("hashgrid_backward",), ()),
        ("K2s train B s63", f"K2s hashgrid_backward (simplex levels) at style 63, "
         f"{encode_rows['train B']} (on no path)", hg, "nerfstyle_tpu/ops/hashgrid.py:979",
         ("hashgrid_backward",), ()),
        ("K2x frame B", "K2x hashgrid_position_grad (hashgrid_encode(fast_vjp=False)'s d x), a "
         "frame chunk's kept samples (color, C=2; on no path: library API)", hg,
         "nerfstyle_tpu/ops/hashgrid.py:840", ("hashgrid_position_grad",), ()),
        ("K2x simplex", "K2x hashgrid_position_grad with simplex levels, a frame chunk's kept "
         "samples (color, C=2; on no path)", hg, "nerfstyle_tpu/ops/hashgrid.py:840",
         ("hashgrid_position_grad",), ()),
        ("K9 1", "K9 grid_initialize, default grid, one style (on no path)", hg,
         "nerfstyle_tpu/ops/hashgrid.py:351", ("grid_initialize",), ()),
        ("K9 2", "K9 grid_initialize, default grid, two styles (on no path)", hg,
         "nerfstyle_tpu/ops/hashgrid.py:351", ("grid_initialize",), ()),
        ("K4i", "K4i composite_weights_entering, an incremental frame chunk's round (each "
         "ray entering with the transmittance of its earlier rounds)", cp,
         "nerfstyle_tpu/render/renderer.py:364", ("composite_weights_entering",),
         ("incremental",)),
        ("K4i later", "K4i composite_weights_entering, a later round of the incremental frame "
         "at round size 4 (rays entering with T < 1; on no path: the default round size is 32)",
         cp, "nerfstyle_tpu/render/renderer.py:364", ("composite_weights_entering",), ()),
        ("P0 incremental", "P0 take_rows, an incremental round's gather of its samples' [xyz, "
         "tau] rows (16 bytes a row)", "nerfstyle_torch/csrc/gather.cu",
         "tools/exp_encoder_r4.py:120", ("take_rows",), ("incremental",)),
        ("P0 incremental 32 B", "P0 take_rows, the same positions into the view-dependent "
         "fields' [xyz, tau, dirs, 0] rows (32 bytes a row; on no path: those fields are library "
         "API)", "nerfstyle_torch/csrc/gather.cu", "tools/exp_encoder_r4.py:120", ("take_rows",),
         ()),
        ("K1 incremental", "K1 hashgrid_encode, an incremental round's samples (fused [T, 4])",
         hg, "nerfstyle_tpu/ops/hashgrid.py:818", ("hashgrid_encode:incremental",),
         ("incremental",)),
        ("K5f incremental", "K5 mlp_forward, an incremental round's samples (density, class, "
         "color1 and color2 heads)", "nerfstyle_torch/csrc/mlp.cu", "nerfstyle_tpu/ops/mlp.py:45",
         ("mlp_forward",), ("incremental",)),
        ("P0", "P0 take_rows, 256 int32 indices into [1024, 128] f32 (the TPU kernel's own "
         "shape, on no path)",
         "nerfstyle_torch/csrc/gather.cu", "tools/exp_encoder_r4.py:120", ("take_rows",), ()),
        ("P0 2^20", "P0 take_rows, 2^20 int32 indices into [1024, 128] f32 (on no "
         "path)",
         "nerfstyle_torch/csrc/gather.cu", "tools/exp_encoder_r4.py:120", ("take_rows",), ()),
    ]
    # Calls: a row's launches over the launches a call makes.  The rule-2
    # queue ranks the rows by calls x (ms - bound), where ms times a call.
    # A call of a row with several counters (K3, K3s: count and write, the
    # write skipped when nothing is kept) is a launch of its first; K6c
    # launches kernels.SKIPDIST_LAUNCHES a call.
    per_call = {"K6c": kernels.SKIPDIST_LAUNCHES}
    rows, loss = [], {}
    for kid, name, source, replaces, counters, paths in meta:
        if kid not in table:
            fails.append(f"{name}: no kernel-table row (its phase did not measure it)")
            continue
        launches = sum(runs[p].get(c, 0) for p in paths for c in counters)
        if paths and launches <= 0:
            fails.append(f"{name} launched no time on {paths}")
        calls, rem = divmod(sum(runs[p].get(counters[0], 0) for p in paths),
                            per_call.get(kid, 1))
        if rem:
            fails.append(f"{name}: {launches} launches are not whole calls of "
                         f"{per_call[kid]} launches")
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches, "calls": calls, **table[kid]})
        loss[kid] = calls * (table[kid]["ms"] - table[kid]["bound_ms"])
    log("rule-2 queue, calls x (ms - bound_ms) in ms over the run: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(loss.items(), key=lambda kv: -kv[1])))
    log(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s, the kernels' build included")
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


def late_step_main(steps: int = 5) -> int:
    """``--late-step``: the train phase, then ``steps`` late steps each
    under the profiler; one JSON line of what each issued."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from nerfstyle_torch import kernels

    card = card_line()
    log(f"card: {card}")
    kernels.build(verbose=True)
    kernels.library()
    WORK.mkdir(parents=True, exist_ok=True)
    write_checkpoint(WORK / "smoke.ckpt")  # and the synthetic scene
    count_hashgrid_streams()
    count_composite_streams()
    fails = []
    trainer, _ = train_phase(card, fails)
    late_ms = float(np.median(trainer.iter_ms[-50:]))
    profiled = [profile_once(trainer.run_iter, f"late train step {i}", card)
                for i in range(steps)]
    if fails or not all(profiled):
        for f in fails:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"late_median_ms": late_ms, "steps": profiled}))
    return 0


def view_frame_main(frames: int = 2) -> int:
    """``--view-frame``: the render checkpoint's frame through the default
    field and both view-dependent families (as ``view_phase`` builds them),
    each warmed up and then ``frames`` frames under the profiler; one JSON
    line of what each frame issued."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from nerfstyle_torch import kernels
    from nerfstyle_torch.ops.occupancy import occupancy_persistable
    from nerfstyle_torch.render import cli

    card = card_line()
    log(f"card: {card}")
    kernels.build(verbose=True)
    kernels.library()
    WORK.mkdir(parents=True, exist_ok=True)
    write_checkpoint(WORK / "smoke.ckpt")
    renderer, params, test_set, _ = cli.load_renderer(WORK / "smoke.ckpt", DEVICE, OUT_DIMS,
                                                      max_count=1)
    pose = torch.from_numpy(np.asarray(test_set[0][1]))
    families = {"default": (renderer, params), **view_families(renderer)}
    persisted = occupancy_persistable(renderer.occ_state)
    issued = {}
    for name, (r, p) in families.items():
        if r is not renderer:
            r.restore_occupancy(persisted)
        for _ in range(2):
            r.render(p, pose)
        issued[name] = [profile_once(lambda: r.render(p, pose), f"{name} frame {i}", card)
                        for i in range(frames)]
    if not all(all(v) for v in issued.values()):
        print("FAIL: the profiler recorded nothing", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"frames": issued}))
    return 0


def round_kernels_main() -> int:
    """``--round-kernels``: the incremental frame's round kernels alone, as
    incremental_phase times them (P0 on the largest round's 16- and 32-byte
    rows, K4i on the largest round and on a later round at round size 4,
    each warm from a CUDA graph and cold), and P0 at its own shape and at
    2^20 indices (p0_rows), beside the launch floor; one JSON line.  Copied
    into a parent's ``git archive`` it times the parent's kernels on the
    same card: run parent, change, change, parent in one call."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from nerfstyle_torch import kernels
    from nerfstyle_torch.render import cli

    card = card_line()
    log(f"card: {card}")
    kernels.build(verbose=True)
    kernels.library()
    WORK.mkdir(parents=True, exist_ok=True)
    write_checkpoint(WORK / "smoke.ckpt")
    renderer, params, test_set, _ = cli.load_renderer(WORK / "smoke.ckpt", DEVICE, OUT_DIMS,
                                                      max_count=1)
    pose = torch.from_numpy(np.asarray(test_set[0][1]))
    inc = dataclasses.replace(renderer.settings, infer_two_phase=False)
    _, best, later = capture_rounds(renderer, params, pose, inc)
    fails = []
    rows = round_rows(best, later, fails)
    rows.update(p0_rows(fails))
    rows["launch floor"] = launch_floor()
    if fails:
        for f in fails:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"round_kernels": rows}))
    return 0


def dp_main() -> int:
    """``--dp``: the render checkpoint, the train phase's 300 steps and the
    style assets, then the dp phase alone; one JSON line of its numbers."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from nerfstyle_torch import kernels, train

    card = card_line()
    log(f"card: {card}")
    kernels.build()
    kernels.library()
    WORK.mkdir(parents=True, exist_ok=True)
    write_checkpoint(WORK / "smoke.ckpt")  # and the synthetic scene
    (WORK / "data.yaml").write_text(
        f"root_path: {WORK / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    train.main(train_argv(TRAIN_STEPS))
    fails = []
    style_assets(fails)
    res = dp_phase(card, fails)
    if fails:
        for f in fails:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"dp": res}))
    return 0


def sass_counts(lib: Path, path: Path,
                names=("position_grad", "hashgrid_encode_kernel", "hashgrid_backward_kernel",
                       "skipdist"),
                keep=("position_grad_kernelILi2ELb0E", "encode_kernelILi2ELb0",
                      "skipdist_kernel")) -> dict:
    """SASS instructions of each kernel of the library whose mangled name
    holds one of ``names`` (``cuobjdump -sass``), or {} without cuobjdump;
    the SASS of the kernels whose name holds one of ``keep`` (K2x and K1 at
    C = 2, K6c) is written to ``path``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                             timeout=300).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    counts, fn, kept, blocks = {}, None, False, []
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(n in m.group(1) for n in names) else None
            kept = any(k in m.group(1) for k in keep)
            if fn:
                counts[fn] = 0
        elif fn and re.match(r"\s*/\*[0-9a-f]{4}\*/\s+\S", line):
            counts[fn] += 1
        if kept:
            blocks.append(line)
    path.write_text("\n".join(blocks))
    return counts


def k6c_k2x_rows(renderer, params, rays, card: str, fails) -> dict:
    """K6c and K2x alone, each warm from a CUDA graph and cold (cold_ms) and
    held against its plain version: K6c at 2 x 256^3 (the scene's spheres,
    and random 0.02%), 2 x 100^3 and 2 x 512^3 (random 0.02%) and 2 x 128^3
    (the spheres, random 0.02%), at the host's tile side and at fixed ones;
    K2x on a frame chunk's kept stream (C = 2; trilinear and simplex levels)
    beside K1 on the same stream."""
    from nerfstyle_torch import kernels
    from nerfstyle_torch.data.synthetic import _SPHERES
    from nerfstyle_torch.ops import hashgrid, occupancy

    dev = torch.device(DEVICE)
    dmax = occupancy.SKIP_DMAX
    rows = {}

    def sparse(h: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed(h)
        return (torch.rand(2 * h**3, generator=gen) < 2e-4).to(dev)

    def spheres(h: int) -> torch.Tensor:
        return torch.from_numpy(sphere_bitfield(renderer.cascade, h, renderer.bound,
                                                _SPHERES)).to(dev)

    def timed(fn, ref, what: str) -> dict:
        got, again = fn(), fn()
        torch.cuda.synchronize()
        if not (torch.equal(got, ref) and torch.equal(got, again)):
            fails.append(f"{what}: equal to plain {torch.equal(got, ref)}, two calls equal "
                         f"{torch.equal(got, again)}")
        del got, again
        return {"ms": graph_ms(fn, reps=10), "cold_ms": cold_ms(fn, reps=10)}

    cases = {"2 x 256^3 spheres": (256, spheres), "2 x 256^3 random": (256, sparse),
             "2 x 100^3 random": (100, sparse), "2 x 512^3 random": (512, sparse),
             "2 x 128^3 spheres": (128, spheres), "2 x 128^3 random": (128, sparse)}
    for label, (h, make) in cases.items():
        bits = make(h)
        ref = occupancy.skipdist_plain(bits, h)
        row = {"occupied": int(bits.sum()), "plan": kernels.skipdist_plan(h, 2, dmax)}
        entries = {"K6c": lambda: kernels.occupancy_skipdist(bits, h, dmax)}
        for tile in (8, 10, 12, 14, 16, 20, 24, 28, 32):
            if tile < h and kernels.skipdist_plan(h, 2, dmax, tile=tile)["tile"]:
                entries[f"K6c tile {tile}"] = (
                    lambda t=tile: kernels.occupancy_skipdist(bits, h, dmax, tile=t))
        for name, fn in entries.items():
            row[name] = timed(fn, ref, f"K6c {name} at {label}")
        rows[f"K6c {label}"] = row
        log(f"K6c {label}: {row} ({card})")
        del bits, ref
        torch.cuda.empty_cache()

    x_b = frame_streams(renderer, params, rays.origins, rays.dirs)[1]
    table = params["x_color_embedder"]
    grid = renderer.field_spec.grid
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    for kid, spec in (("K2x", grid), ("K2x simplex", dataclasses.replace(
            grid, simplex_from=SIMPLEX_FROM))):
        lv = hashgrid.position_grad_table(spec, dev)
        g = torch.randn((x_b.shape[0], spec.num_levels * table.shape[1]), generator=gen,
                        device=dev)
        ref = hashgrid.hashgrid_position_grad_plain(spec, table, x_b, g)
        scale = float(ref.abs().max())
        row = {"points": x_b.shape[0]}
        k1_lv = hashgrid.level_table(spec, dev)
        fns = {"K1": lambda: kernels.hashgrid_encode(x_b, table, k1_lv),
               "K2x": lambda: kernels.hashgrid_position_grad(x_b, g, table, lv)}
        err = float((fns["K2x"]() - ref).abs().max())
        if not err <= K2X_TOL * scale:
            fails.append(f"{kid}: max abs err {err} > {K2X_TOL} x {scale}")
        row["K2x"] = {"max_abs_err": err}
        # Three turns over K1 and K2x, 100 calls a graph: the median of the
        # three is the row's ms.
        turns = {name: [] for name in fns}
        for _ in range(3):
            for name, fn in fns.items():
                turns[name].append(graph_ms(fn, reps=100))
        for name, fn in fns.items():
            row.setdefault(name, {}).update(ms=sorted(turns[name])[1], turns=turns[name],
                                            cold_ms=cold_ms(fn))
        rows[kid] = row
        log(f"{kid} on a frame chunk's kept stream: {row} ({card})")
    return rows


def k6c_k2x_main() -> int:
    """``--k6c-k2x``: K6c and K2x alone (k6c_k2x_rows) and the SASS
    instructions of K2x, K1, K2 and K6c's kernels (sass_counts; their SASS
    in build/smoke/kernels.sass), as one JSON line.  A copy in another
    checkout times that tree's kernels on the same card: run parent,
    change, change, parent in one call."""
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
    lib = kernels.build(verbose=True)
    kernels.library()
    WORK.mkdir(parents=True, exist_ok=True)
    write_checkpoint(WORK / "smoke.ckpt")
    renderer, params, test_set, _ = cli.load_renderer(WORK / "smoke.ckpt", DEVICE, OUT_DIMS,
                                                      max_count=1)
    pose = torch.from_numpy(np.asarray(test_set[0][1]))
    rays, _ = generate_rays(pose.to(DEVICE), renderer.intr,
                            camera_flip=renderer.settings.flip_camera)
    fails = []
    rows = k6c_k2x_rows(renderer, params, rays, card, fails)
    rows["sass"] = sass_counts(lib, WORK / "kernels.sass")
    if fails:
        for f in fails:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"k6c_k2x": rows}))
    return 0


MODES = {"--late-step": late_step_main, "--view-frame": view_frame_main,
         "--round-kernels": round_kernels_main, "--k6c-k2x": k6c_k2x_main, "--dp": dp_main}

if __name__ == "__main__":
    sys.exit(MODES[sys.argv[1]]() if sys.argv[1:] and sys.argv[1] in MODES else main())
