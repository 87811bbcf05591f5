"""The port's quality run (``python -m nerfstyle_torch.tools.psnr_room_run``)
over a grid of small configurations, several processes at a time on one
card, and what each curve shows::

    python tests/quality_sweep.py OUT_DIR

A run is a configuration, a scene (``spheres``, the open scene, or
``room``) and a seed (the default ``--rng_seed``, or 1), named
``<config>_<scene>_s<seed>``.  The configurations (``CONFIGS``):

* ``s-ad``: 48x64, 30 views, ``--max_steps 256 --grid_size 64
  --pos_enc.n_lvls 8`` (the CPU comparison's size), in the tool's whole
  regime (``--adaptive_batch`` from 1,024 rays, 2^20 samples a step);
* ``s-512``: the same at 512 rays a step (the ladder ends at 512, and the
  count leaves it only for 256 where demand passes 2^20 / (1.25 x 512) =
  1,638 samples a ray, more than ``max_steps`` allows): the fixed batch of
  ``tests/quality_curve_compare.py``;
* ``m-ad``: 96x128, 30 views, the default network, the tool's regime.

Each run trains 15,000 steps on the card, 12 runs at a time, and evaluates
every 250; its lines go to ``OUT_DIR/<name>.log``.  Then one JSON line a run goes to
``OUT_DIR/summary.jsonl`` and stdout (:func:`summarize`): when the grid's
density grows (the first evaluation at 10 times the lowest mean density so
far, the first with 1,000 hot cells or more, the first at 10^3 times the
mean density of an evaluation at most 500 steps earlier) and the held-out
PSNR's peak, its step and its fall by the last evaluation.  Imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
SMALL = "--max_steps 256 --grid_size 64 --pos_enc.n_lvls 8"
CONFIGS: Dict[str, Dict[str, str]] = {
    "s-ad": {"res": "48x64", "extra": SMALL},
    "s-512": {"res": "48x64",
              "extra": SMALL + " --num_rays_per_batch 512 --adaptive_batch_max_rays 512"},
    "m-ad": {"res": "96x128", "extra": ""},
}
SEEDS = (None, 1)  # None: the config's default rng_seed
STEPS, EVERY, PARALLEL = 15000, 250, 12
# A blow-up: the mean density up this factor within BLOWUP_STEPS.
BLOWUP_FACTOR, BLOWUP_STEPS = 1e3, 500
# Growth: the mean density this factor over its lowest so far; this many
# hot cells (all cascades).
GROWTH_FACTOR, HOT_CELLS = 10.0, 1000


def runs() -> Dict[str, Dict[str, str]]:
    """Every run's name and its environment for the tool."""
    out = {}
    for cfg, c in CONFIGS.items():
        for scene in ("spheres", "room"):
            for seed in SEEDS:
                extra = f"{c['extra']} --intervals.test {EVERY}"
                if seed is not None:
                    extra += f" --rng_seed {seed}"
                out[f"{cfg}_{scene}_s{seed or 0}"] = {
                    "NERFSTYLE_BENCH_SCENE": scene, "NERFSTYLE_BENCH_RES": c["res"],
                    "NERFSTYLE_BENCH_VIEWS": "30", "EXTRA": extra.strip()}
    return out


def summarize(evals: List[dict], psnr_key: str = "psnr") -> dict:
    """What a curve of evaluation lines shows: ``growth_step`` (the first
    step whose ``mean_density`` is GROWTH_FACTOR times the lowest of the
    evaluations before it), ``hot_step`` (the first with HOT_CELLS hot cells
    or more), ``blowup_step`` (the first whose ``mean_density`` is
    BLOWUP_FACTOR times that of an evaluation at most BLOWUP_STEPS earlier,
    with the mean density before and at it), each None where no evaluation
    qualifies; ``peak_psnr`` and ``peak_step``, ``last_psnr`` and ``fall``
    (peak less last)."""
    out: Dict[str, Optional[float]] = {"growth_step": None, "hot_step": None,
                                       "blowup_step": None}
    for i, e in enumerate(evals):
        low = min((p["mean_density"] for p in evals[:i]), default=None)
        if out["growth_step"] is None and low and e["mean_density"] >= GROWTH_FACTOR * low:
            out["growth_step"] = e["step"]
        if out["hot_step"] is None and sum(e["hot_cells"]) >= HOT_CELLS:
            out["hot_step"] = e["step"]
        recent = [p["mean_density"] for p in evals[:i] if e["step"] - p["step"] <= BLOWUP_STEPS]
        low = min(recent, default=None)
        if out["blowup_step"] is None and low and e["mean_density"] >= BLOWUP_FACTOR * low:
            out.update(blowup_step=e["step"], density_before=low,
                       density_at=e["mean_density"])
    if evals:
        peak = max(evals, key=lambda e: e[psnr_key])
        out.update(peak_psnr=peak[psnr_key], peak_step=peak["step"],
                   last_psnr=evals[-1][psnr_key], last_step=evals[-1]["step"],
                   fall=peak[psnr_key] - evals[-1][psnr_key],
                   max_mean_density=max(e["mean_density"] for e in evals))
    return out


def read_lines(log: Path) -> List[dict]:
    """The JSON lines of a tool's log: its evaluations (with a ``step``),
    then its last line (with ``iters``)."""
    return [json.loads(s) for s in log.read_text().splitlines() if s.startswith("{")]


def main(argv=None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_dir")
    args = parser.parse_args(argv)
    out = Path(args.out_dir).resolve()
    out.mkdir(parents=True, exist_ok=True)
    todo = runs()
    sys.path.insert(0, str(ROOT))  # one build before the processes start
    from nerfstyle_torch import kernels

    kernels.build()
    pending, live, t0 = list(todo.items()), {}, time.perf_counter()
    while pending or live:
        while pending and len(live) < PARALLEL:
            name, env = pending.pop(0)
            env = {**os.environ, **env, "PSNR_ITERS": str(STEPS), "OMP_NUM_THREADS": "1"}
            log = open(out / f"{name}.log", "w")
            cmd = [sys.executable, "-m", "nerfstyle_torch.tools.psnr_room_run",
                   str(out / "work" / name)]
            live[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                           stderr=subprocess.STDOUT), log)
        time.sleep(2)
        for name in [n for n, (p, _) in live.items() if p.poll() is not None]:
            proc, log = live.pop(name)
            log.close()
            print(f"{name}: rc {proc.returncode} at {time.perf_counter() - t0:.0f} s",
                  flush=True)
    summary = []
    with open(out / "summary.jsonl", "w") as f:
        for name in todo:
            lines = read_lines(out / f"{name}.log")
            finals = [e for e in lines if "iters" in e]
            rec = {"run": name, **summarize([e for e in lines if "step" in e]),
                   "final": finals[-1] if finals else None}
            summary.append(rec)
            f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
    return summary


if __name__ == "__main__":
    main()
