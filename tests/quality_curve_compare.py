"""Held-out PSNR of the JAX package's stage-1 trainer and the port's over
many steps, side by side on the CPU, with the occupancy grid's state and the
samples a ray logged beside it::

    JAX_PLATFORMS=cpu python tests/quality_curve_compare.py OUT_DIR --impl jax|port \\
        [--scene spheres|room] [--res 48x64] [--views 30] [--steps 1000] [--every 100] \\
        [--rays 1024] [--resume CKPT] [--device cpu|cuda] [--threads 4] \\
        [--save] [-- EXTRA FLAGS]

Both trainers run the quality run's regime (``psnr_room_run.TRAIN_FLAGS``,
the JAX bench's) less ``--adaptive_batch``, at a fixed ``--rays`` rays a
step, on the bench scene (``psnr_room_run.make_bench_scene``, equal to the
JAX bench's).  Both start from the same state: by default the JAX trainer's
initial params, Adam and EMA state, loaded into the port's trainer; with
``--resume CKPT`` a checkpoint of either package (params, Adam, EMA, the
occupancy grid and the step count), read by each package's own reader.
The EXTRA flags must then give the checkpoint's network and renderer.
Their pixel draws come from each package's own generators, so the curves
agree in distribution, not step by step.  Run ``--impl jax`` and ``--impl
port`` as two processes and compare their files.  ``--impl port --resume
CKPT`` imports neither JAX nor the JAX package, so it also runs on the card
(``--device cuda``), where the port launches its kernels: the same window
on both devices tells whether the kernels take part in what a curve shows.

Every ``--every`` steps one JSON line goes to
``OUT_DIR/<scene>_<impl>[_<device>].jsonl`` (the device only where it is
not the CPU) and stdout: ``step`` (the trainer's step count, a resumed run's
included), ``test_psnr`` (the EMA params on the scene's 3 test views),
``train_psnr`` (the mean of the interval's batch PSNRs), ``occ_share`` (the
share of occupied cells), ``mean_density`` (the grid's mean, whose minimum
with ``density_thresh`` is the occupancy threshold), ``max_density``,
``p999_density`` and ``hot_cells`` (``psnr_room_run.grid_stats``),
``marched`` and ``kept`` (samples a ray marched and significant, the
interval's mean), ``budget`` (the JAX march budget's samples a ray; null
for the port, which sizes every buffer from the march) and ``seconds``
since the start.  With ``--save`` the trainer writes its checkpoint after
the last step, under ``OUT_DIR/<scene>_<impl>[_<device>]/<impl>_logs``.

This file imports both packages, as the tests do; the port does not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _jax_state(jt):
    """The JAX trainer's (params, opt_state, ema_state) as numpy trees."""
    import jax
    import numpy as np

    return [jax.tree_util.tree_map(np.asarray, t) for t in (jt.params, jt.opt_state,
                                                           jt.ema_state)]


def _share(bitfield) -> float:
    import numpy as np

    return float(np.asarray(bitfield).astype(np.float64).mean())


class _JaxRun:
    """The JAX trainer, one step at a time, with its counts recorded."""

    def __init__(self, jt):
        self.t, self.points = jt, []
        note = jt.renderer.note_batch_points

        def noted(num_points, num_rays=None, num_cand=None):
            self.points.append(num_points)
            return note(num_points, num_rays, num_cand)

        jt.renderer.note_batch_points = noted

    def step(self):
        self.t.run_iter()
        return (float(self.t.last_losses["psnr"]), int(self.points.pop()),
                int(self.t._last_num_sig))

    def test_psnr(self) -> float:
        return float(self.t.test_networks()["psnr"])

    def occ(self):
        """(occupied share, mean density, ``grid_stats``) of the grid."""
        import numpy as np

        from nerfstyle_torch.tools.psnr_room_run import grid_stats

        s = self.t.renderer.occ_state
        return (_share(s.bitfield), float(s.mean_density),
                grid_stats(np.asarray(s.density_grid), self.t.settings.density_thresh))

    def budget(self):
        return int(self.t.renderer._budget_bucket)


class _PortRun:
    def __init__(self, tt):
        self.t = tt

    def step(self):
        self.t.run_iter()
        c = self.t.iter_counts[-1]
        return float(self.t.last_losses["psnr"]), int(c["num_points"]), int(c["num_sig"])

    def test_psnr(self) -> float:
        return float(self.t.test_networks()["psnr"])

    def occ(self):
        from nerfstyle_torch.tools.psnr_room_run import grid_stats

        s = self.t.renderer.occ_state
        return (_share(s.bitfield.cpu().numpy()), float(s.mean_density),
                grid_stats(s.density_grid, self.t.settings.density_thresh))

    def budget(self):
        return None


def make_run(args, work: Path, data_cfg: Path, nargs):
    """The run of ``args.impl``: the JAX trainer, or the port's trainer on
    ``args.device`` started from JAX's initial state or from
    ``args.resume``."""
    resume = Path(args.resume).resolve() if args.resume else None
    if args.impl == "port" and resume is not None:
        from nerfstyle_torch.config import BaseConfig
        from nerfstyle_torch.training.trainer import Trainer

        return _PortRun(Trainer(BaseConfig(log_dir=work / "port_logs", data_cfg=data_cfg,
                                           ckpt=resume, yes=True), list(nargs), args.device))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from nerfstyle_tpu.config import BaseConfig as JBaseConfig
    from nerfstyle_tpu.training.trainer import Trainer as JTrainer

    jt = JTrainer(JBaseConfig(log_dir=work / "jax_logs", data_cfg=data_cfg, ckpt=resume),
                  list(nargs), assume_yes=True)
    if args.impl == "jax":
        return _JaxRun(jt)
    from nerfstyle_torch.config import BaseConfig
    from nerfstyle_torch.models.fields import train_state_from_numpy
    from nerfstyle_torch.training.trainer import Trainer

    tt = Trainer(BaseConfig(log_dir=work / "port_logs", data_cfg=data_cfg, yes=True),
                 list(nargs), device="cpu")
    params, opt, ema = train_state_from_numpy(*_jax_state(jt))
    tt.params, tt.opt_state, tt.ema_state = tt._trainable(params), opt, ema
    del jt
    return _PortRun(tt)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    parser.add_argument("out_dir")
    parser.add_argument("--impl", required=True, choices=("jax", "port"))
    parser.add_argument("--scene", default="spheres", choices=("spheres", "room"))
    parser.add_argument("--res", default="48x64")
    parser.add_argument("--views", type=int, default=30)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--every", type=int, default=100)
    parser.add_argument("--rays", type=int, default=1024)
    parser.add_argument("--resume", default=None, help="a checkpoint of either package")
    parser.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                        help="the port's device (JAX runs on the CPU)")
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--save", action="store_true",
                        help="write the trainer's checkpoint after the last step")
    # Every other argument is an EXTRA flag, after "--" or not (argparse
    # keeps or drops a "--" depending on the Python release).
    args, rest = parser.parse_known_args(argv)
    args.extra = [f for f in rest if f != "--"]
    if args.device != "cpu" and (args.impl != "port" or args.resume is None):
        parser.error("--device cuda takes --impl port --resume CKPT")
    return args


def setup(args):
    """(run, path of its records) for ``args``: the bench scene and data
    config under ``OUT_DIR/<scene>_<impl>[_<device>]``, then the run."""
    import torch

    from nerfstyle_torch.tools import psnr_room_run

    torch.set_num_threads(args.threads)
    out = Path(args.out_dir).resolve()
    os.chdir(ROOT)  # the configs' default files are found from the repository's root
    tag = f"{args.scene}_{args.impl}" + ("" if args.device == "cpu" else f"_{args.device}")
    work = out / tag
    work.mkdir(parents=True, exist_ok=True)
    os.environ.update(NERFSTYLE_BENCH_RES=args.res, NERFSTYLE_BENCH_VIEWS=str(args.views),
                      NERFSTYLE_BENCH_SCENE=args.scene)
    data_cfg, _ = psnr_room_run.make_bench_scene(work)
    nargs = ["--num_iterations", str(args.steps), "--max_eval_count", "3",
             *(f for f in psnr_room_run.TRAIN_FLAGS if f != "--adaptive_batch"),
             "--num_rays_per_batch", str(args.rays), *args.extra]
    return make_run(args, work, data_cfg, nargs), out / f"{tag}.jsonl"


def main(argv=None) -> list:
    """Parse ``argv``, train one package's trainer, write and return its
    records."""
    args = parse_args(argv)
    run, path = setup(args)
    records, t0 = [], time.perf_counter()
    with open(path, "w") as f:
        psnrs, marched, kept = [], [], []
        for i in range(1, args.steps + 1):
            p, n_pts, n_sig = run.step()
            psnrs.append(p)
            marched.append(n_pts / args.rays)
            kept.append(n_sig / args.rays)
            if i % args.every and i != args.steps:
                continue
            share, mean_density, stats = run.occ()
            rec = {"impl": args.impl, "scene": args.scene, "step": run.t.iter_ctr,
                   "test_psnr": run.test_psnr(), "train_psnr": sum(psnrs) / len(psnrs),
                   "occ_share": share, "mean_density": mean_density, **stats,
                   "marched": sum(marched) / len(marched), "kept": sum(kept) / len(kept),
                   "budget": run.budget(), "seconds": round(time.perf_counter() - t0, 1)}
            psnrs, marched, kept = [], [], []
            records.append(rec)
            line = json.dumps(rec)
            f.write(line + "\n")
            f.flush()
            print(line, flush=True)
    if args.save:
        run.t.save_ckpt()
    return records


if __name__ == "__main__":
    main()
