"""Held-out PSNR of the JAX package's stage-1 trainer and the port's over
many steps, side by side on the CPU, with the occupancy grid's state and the
samples a ray logged beside it::

    JAX_PLATFORMS=cpu python tests/quality_curve_compare.py OUT_DIR --impl jax|port \\
        [--scene spheres|room] [--res 48x64] [--views 30] [--steps 1000] [--every 100] \\
        [--rays 1024] [--threads 4] [-- EXTRA FLAGS]

Both trainers run the quality run's regime (``psnr_room_run.TRAIN_FLAGS``,
the JAX bench's) less ``--adaptive_batch``, at a fixed ``--rays`` rays a
step, on the bench scene (``psnr_room_run.make_bench_scene``, equal
to the JAX bench's) and start from the same state: the JAX trainer's
initial params, Adam and EMA state, loaded into the port's trainer.  Their
pixel draws come from each package's own generators, so the curves agree
in distribution, not step by step.  Run ``--impl jax`` and ``--impl port``
as two processes (each builds the JAX trainer for the initial state) and
compare their files.

Every ``--every`` steps one JSON line goes to ``OUT_DIR/<scene>_<impl>.jsonl``
and stdout: ``step``, ``test_psnr`` (the EMA params on the scene's 3 test views),
``train_psnr`` (the mean of the interval's batch PSNRs), ``occ_share`` (the
share of occupied cells), ``mean_density`` (the grid's mean, whose minimum
with ``density_thresh`` is the occupancy threshold), ``marched`` and
``kept`` (samples a ray marched and significant, the interval's mean),
``budget`` (the JAX march budget's samples a ray; null for the port, which
sizes every buffer from the march) and ``seconds`` since the start.

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
        s = self.t.renderer.occ_state
        return _share(s.bitfield), float(s.mean_density)

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
        s = self.t.renderer.occ_state
        return _share(s.bitfield.numpy()), float(s.mean_density)

    def budget(self):
        return None


def main(argv=None) -> list:
    """Parse ``argv``, train one package's trainer, write and return its
    records."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_dir")
    parser.add_argument("--impl", required=True, choices=("jax", "port"))
    parser.add_argument("--scene", default="spheres", choices=("spheres", "room"))
    parser.add_argument("--res", default="48x64")
    parser.add_argument("--views", type=int, default=30)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--every", type=int, default=100)
    parser.add_argument("--rays", type=int, default=1024)
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("extra", nargs="*")
    args = parser.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)

    from nerfstyle_tpu.config import BaseConfig as JBaseConfig
    from nerfstyle_tpu.training.trainer import Trainer as JTrainer
    from nerfstyle_torch.config import BaseConfig
    from nerfstyle_torch.models.fields import train_state_from_numpy
    from nerfstyle_torch.tools import psnr_room_run
    from nerfstyle_torch.training.trainer import Trainer

    out = Path(args.out_dir).resolve()
    os.chdir(ROOT)  # the configs' default files are found from the repository's root
    work = out / f"{args.scene}_{args.impl}"
    work.mkdir(parents=True, exist_ok=True)
    os.environ.update(NERFSTYLE_BENCH_RES=args.res, NERFSTYLE_BENCH_VIEWS=str(args.views),
                      NERFSTYLE_BENCH_SCENE=args.scene)
    data_cfg, _ = psnr_room_run.make_bench_scene(work)
    nargs = ["--num_iterations", str(args.steps), "--max_eval_count", "3",
             *(f for f in psnr_room_run.TRAIN_FLAGS if f != "--adaptive_batch"),
             "--num_rays_per_batch", str(args.rays), *args.extra]
    jt = JTrainer(JBaseConfig(log_dir=work / "jax_logs", data_cfg=data_cfg), list(nargs),
                  assume_yes=True)
    if args.impl == "jax":
        run = _JaxRun(jt)
    else:
        tt = Trainer(BaseConfig(log_dir=work / "port_logs", data_cfg=data_cfg, yes=True),
                     list(nargs), device="cpu")
        params, opt, ema = train_state_from_numpy(*_jax_state(jt))
        tt.params, tt.opt_state, tt.ema_state = tt._trainable(params), opt, ema
        del jt
        run = _PortRun(tt)

    records, t0 = [], time.perf_counter()
    path = out / f"{args.scene}_{args.impl}.jsonl"
    with open(path, "w") as f:
        psnrs, marched, kept = [], [], []
        for step in range(1, args.steps + 1):
            p, n_pts, n_sig = run.step()
            psnrs.append(p)
            marched.append(n_pts / args.rays)
            kept.append(n_sig / args.rays)
            if step % args.every and step != args.steps:
                continue
            share, mean_density = run.occ()
            rec = {"impl": args.impl, "scene": args.scene, "step": step,
                   "test_psnr": run.test_psnr(), "train_psnr": sum(psnrs) / len(psnrs),
                   "occ_share": share, "mean_density": mean_density,
                   "marched": sum(marched) / len(marched), "kept": sum(kept) / len(kept),
                   "budget": run.budget(), "seconds": round(time.perf_counter() - t0, 1)}
            psnrs, marched, kept = [], [], []
            records.append(rec)
            line = json.dumps(rec)
            f.write(line + "\n")
            f.flush()
            print(line, flush=True)
    return records


if __name__ == "__main__":
    main()
