"""Reconstruction quality run: stage 1 on the synthetic bench scene with
held-out PSNR (counterpart of the repository's ``tools/psnr_room_run.py``)::

    PSNR_ITERS=2000 python -m nerfstyle_torch.tools.psnr_room_run [workdir] [--device cpu]

Writes the bench scene and its data config under ``workdir`` (by default
``nerfstyle_room_psnr`` in the temporary directory): the open scene of
spheres on white by default, ``NERFSTYLE_BENCH_SCENE=room`` for the enclosed
room, at ``NERFSTYLE_BENCH_RES`` (HxW, 378x504) with
``NERFSTYLE_BENCH_VIEWS`` train views (30) and 3 test views.  Then trains
``PSNR_ITERS`` steps (2000; the reference's schedule is 15000) at the
default network, renderer and train configs with the JAX bench's whole
regime: a sample cap that cannot bind (``--max_samples_per_ray 1024``), the
sparsity term (0.001 on 8192 samples a step), ``--update_thres 64``,
``--adaptive_batch`` from ``--num_rays_per_batch 1024`` (a fixed budget of
1,048,576 marched samples a step, the ray count on a ladder of powers of two
from 256 to 32,768 that the demand a ray moves), and the test split's 3
views rendered every 500 steps.  The JAX regime's ``--two_phase_init_bucket``
and ``--window_init_bucket`` seed its compiled shapes; the port reads them
and does not act on them.  ``EXTRA`` appends flags.

Prints one JSON line a test evaluation (``step``, ``mse``, ``psnr``, and the
state the trajectory rests on: ``rays``, the ray count at that step,
``occ_share``, the share of occupied cells of the occupancy grid,
``mean_density``, its mean, whose minimum with ``density_thresh`` is the
occupancy threshold, ``max_density`` and ``p999_density``, its largest cell
and its 99.9th percentile, ``hot_cells``, the count a cascade of the cells
above ``HOT_FACTOR`` x ``density_thresh`` (:func:`grid_stats`), and
``marched`` and ``kept``, the samples a ray marched and significant over
the steps since the last evaluation), then the JAX
tool's last line (``iters``, ``train_s``, the final test metrics) with
``rays_trained`` (the rays of all the steps), ``device`` (the card's name,
or ``cpu``),
``late_step_ms`` (the median step of the last 500), ``peak_mib`` (peak
device memory, null on the CPU), ``skipped_steps`` (non-finite steps the
optimizer skipped) and ``ckpt``, the final ``.npz`` checkpoint, which both
packages' checkpoint readers load.
Runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import BaseConfig
from ..data.synthetic import generate_scene
from ..training.trainer import Trainer

# The JAX bench's train regime (bench.TRAIN_REGIME_FLAGS): intervals off,
# the occupancy grid's full sweeps for 64 steps, the sparsity term, a sample
# cap that cannot bind (it only sizes the checkpoint's budget bucket here),
# the adaptive ray count from 1024 rays, and JAX's two shape seeds.
TRAIN_FLAGS = [
    "--intervals.print", "0",
    "--intervals.log", "0",
    "--intervals.test", "0",
    "--intervals.ckpt", "0",
    "--update_thres", "64",
    "--sparsity_lambda", "0.001",
    "--sparsity_samples", "8192",
    "--max_samples_per_ray", "1024",
    "--adaptive_batch",
    "--num_rays_per_batch", "1024",
    "--two_phase_init_bucket", "128",
    "--window_init_bucket", "192",
]
# Steps whose median is the late step time.
LATE_STEPS = 500
# A cell is hot above this many times the renderer's density_thresh.
HOT_FACTOR = 100.0


def grid_stats(density_grid, density_thresh: float) -> Dict[str, object]:
    """What an evaluation line says of the occupancy grid's cells beyond
    their mean: ``max_density``, ``p999_density`` (numpy's linear 99.9th
    percentile over every cell of every cascade) and ``hot_cells``, a count
    a cascade of the cells above ``HOT_FACTOR * density_thresh``.  Takes the
    [cascade, H^3] grid as a tensor or an array of either package."""
    if isinstance(density_grid, torch.Tensor):
        density_grid = density_grid.detach().cpu().numpy()
    g = np.asarray(density_grid, dtype=np.float32)
    return {"max_density": float(g.max()),
            "p999_density": float(np.percentile(g, 99.9)),
            "hot_cells": [int(n) for n in (g > HOT_FACTOR * density_thresh).sum(axis=1)]}


def make_bench_scene(work: Path) -> Tuple[Path, Dict[str, object]]:
    """The bench scene and its data config under ``work``, as the JAX
    bench's ``make_bench_scene`` writes them (the same knobs, directory name
    and ``data.yaml``); returns ``(data_cfg, info)``."""
    h, w = (int(v) for v in os.environ.get("NERFSTYLE_BENCH_RES", "378x504").split("x"))
    views = int(os.environ.get("NERFSTYLE_BENCH_VIEWS", "30"))
    variant = os.environ.get("NERFSTYLE_BENCH_SCENE", "spheres")
    scene = work / f"scene_{variant}_{h}x{w}_v{views}"
    generate_scene(scene, num_train=views, num_test=3, h=h, w=w, room=variant == "room")
    data_cfg = work / "data.yaml"
    data_cfg.write_text(f"root_path: {scene}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    return data_cfg, {"scene_res": f"{h}x{w}", "scene": variant, "views": views}


class PsnrTrainer(Trainer):
    """The stage-1 trainer, printing each test evaluation as a JSON line;
    :func:`main` keeps its final line in ``result``."""

    result: Optional[Dict[str, object]] = None
    _counted = 0  # steps of iter_counts that an evaluation line has covered

    def test_networks(self) -> Dict[str, float]:
        metrics = super().test_networks()
        if metrics and self.is_main:
            counts, rays = self.iter_counts[self._counted:], sum(self.iter_rays[self._counted:])
            self._counted = len(self.iter_counts)
            occ = self.renderer.occ_state
            line = {"step": metrics["iter"], "mse": metrics["mse"], "psnr": metrics["psnr"],
                    "rays": self.iter_rays[-1] if self.iter_rays else self.batch_rays,
                    "occ_share": float(occ.bitfield.float().mean()),
                    "mean_density": float(occ.mean_density),
                    **grid_stats(occ.density_grid, self.settings.density_thresh)}
            for key, name in (("marched", "num_points"), ("kept", "num_sig")):
                line[key] = sum(int(c[name]) for c in counts) / rays if counts else None
            print(json.dumps(line), flush=True)
        return metrics


def main(argv: Optional[Sequence[str]] = None) -> PsnrTrainer:
    """Parse ``argv`` (default ``sys.argv[1:]``), train, print, return the
    trainer."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("workdir", nargs="?",
                        default=str(Path(tempfile.gettempdir()) / "nerfstyle_room_psnr"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    data_cfg, _ = make_bench_scene(work)
    logs = work / "logs"
    shutil.rmtree(logs, ignore_errors=True)
    iters = int(os.environ.get("PSNR_ITERS", "2000"))
    nargs = ["--num_iterations", str(iters), "--max_eval_count", "3", *TRAIN_FLAGS,
             "--intervals.print", "100", "--intervals.test", "500",
             *os.environ.get("EXTRA", "").split()]
    trainer = PsnrTrainer(BaseConfig(log_dir=logs, data_cfg=data_cfg, yes=True), nargs, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer.run()
    if cuda:
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    last = trainer.test_history[-1] if trainer.test_history else None
    metrics = last if last and last["iter"] == trainer.iter_ctr else trainer.test_networks()
    ckpt = trainer.save_ckpt()
    trainer.close()
    trainer.result = {
        "iters": iters,
        "train_s": round(dt, 1),
        **{k: round(float(metrics[k]), 3) for k in ("mse", "psnr") if k in metrics},
        "rays_trained": trainer.rays_trained,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "late_step_ms": float(np.median(trainer.iter_ms[-LATE_STEPS:])) if trainer.iter_ms
        else None,
        "peak_mib": torch.cuda.max_memory_allocated(device) / 2**20 if cuda else None,
        "skipped_steps": int(trainer.opt_state.total_notfinite),
        "ckpt": str(ckpt),
    }
    print(json.dumps(trainer.result), flush=True)
    return trainer


if __name__ == "__main__":
    main()
