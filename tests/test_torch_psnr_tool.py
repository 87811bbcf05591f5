"""The port's reconstruction quality run, ``python -m
nerfstyle_torch.tools.psnr_room_run`` (the counterpart of
``tools/psnr_room_run.py``), on the CPU at a tiny size: a 24x32 scene of 6
train views, 20 steps at 256 rays with a test evaluation every 10, and a
small network (4 levels of 2^12 rows, grid 32, 128 steps, fp32).  Run once
for the module; the module runs torch on one thread (~10 s; beside other
busy test workers its threads contend: 622 s on all of them).

* Its JSON lines parse: one a test evaluation, then the final line with
  finite PSNR and no skipped step.
* Its scene and data config are the JAX bench's (``bench.make_bench_scene``
  at the same knobs): every array of the scene's files equal, the config's
  text equal but for the directory.
* Its regime is the JAX bench's ``TRAIN_REGIME_FLAGS``, flag for flag.
* Its checkpoint restores in JAX's checkpoint reader (params into JAX's
  field template, the occupancy grid) and renders through the port's CLI.
* ``tests/quality_curve_compare.py --resume`` starts both packages'
  trainers from that checkpoint with equal params and occupancy grids.
* It imports neither JAX, the JAX package nor ``bench``, and it runs on
  ``cuda`` unless told otherwise.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench
from nerfstyle_torch.render import cli
from nerfstyle_torch.tools import psnr_room_run
from nerfstyle_tpu.config import NetworkConfig as JNetworkConfig, _from_dict as jfrom_dict
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.ops.occupancy import (
    occupancy_init as jocc_init,
    occupancy_persistable as jpersistable,
)
from nerfstyle_tpu.training import checkpoint as jckpt

ROOT = Path(__file__).resolve().parent.parent
ENV = {
    "NERFSTYLE_BENCH_RES": "24x32",
    "NERFSTYLE_BENCH_VIEWS": "6",
    "PSNR_ITERS": "20",
    "EXTRA": "--intervals.test 10 --num_rays_per_batch 256 --pos_enc.n_lvls 4 "
             "--pos_enc.hashmap_size 12 --pos_enc.max_res_coeff 16 --grid_size 32 "
             "--max_steps 128 --enable_amp",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for the module: beside the other busy test
    workers, its threads contend (the tool's run took 622 s on all)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The tool's run under ENV: (workdir, its stdout's JSON lines, trainer)."""
    work = tmp_path_factory.mktemp("psnr_tool")
    mp = pytest.MonkeyPatch()
    for k, v in ENV.items():
        mp.setenv(k, v)
    capture = tmp_path_factory.mktemp("psnr_tool_out") / "stdout.txt"
    try:
        with open(capture, "w") as f:
            old, sys.stdout = sys.stdout, f
            try:
                trainer = psnr_room_run.main([str(work), "--device", "cpu"])
            finally:
                sys.stdout = old
    finally:
        mp.undo()
    lines = [json.loads(s) for s in capture.read_text().splitlines() if s.startswith("{")]
    return work, lines, trainer


def test_torch_psnr_tool_prints_evals_and_final_line(run):
    """An evaluation at steps 10 and 20, each with the ray count of its
    step, the occupancy grid's state and the samples a ray of its 10 steps,
    the last one's grid statistics those of the grid the trainer ends with,
    then ``iters``, ``train_s``, the final metrics (those of step 20),
    ``rays_trained``, the device and the checkpoint.  The run is adaptive
    from 256 rays; its one retune with a demand estimate (step 16) wants a
    rung once, which does not grow the count."""
    _, lines, trainer = run
    evals, final = lines[:-1], lines[-1]
    assert [e["step"] for e in evals] == [10, 20]
    assert trainer.train_cfg.adaptive_batch and trainer.iter_rays == [256] * 20
    for e in evals:
        assert e["rays"] == 256
        assert np.isfinite(e["psnr"]) and e["mse"] > 0
        assert 0.0 <= e["occ_share"] <= 1.0 and np.isfinite(e["mean_density"])
        assert e["marched"] >= e["kept"] >= 0.0 and e["marched"] > 0.0
    grid = trainer.renderer.occ_state.density_grid.numpy()
    thresh = 100.0 * trainer.settings.density_thresh
    assert evals[-1]["max_density"] == float(grid.max())
    assert evals[-1]["p999_density"] == float(np.percentile(grid, 99.9))
    assert evals[-1]["hot_cells"] == [int((row > thresh).sum()) for row in grid]
    for e in evals:
        assert e["max_density"] >= e["p999_density"] >= 0.0
        assert e["max_density"] >= e["mean_density"]
        assert len(e["hot_cells"]) == trainer.renderer.cascade
    counts = trainer.iter_counts
    for e, steps in zip(evals, (counts[:10], counts[10:])):
        assert e["marched"] == sum(c["num_points"] for c in steps) / (10 * 256)
        assert e["kept"] == sum(c["num_sig"] for c in steps) / (10 * 256)
    assert final["iters"] == 20 == trainer.iter_ctr
    assert final["rays_trained"] == 20 * 256 == trainer.rays_trained
    assert final["device"] == "cpu" and final["peak_mib"] is None
    assert np.isfinite(final["psnr"]) and final["psnr"] == round(evals[-1]["psnr"], 3)
    assert final["skipped_steps"] == 0 and final["train_s"] > 0 and final["late_step_ms"] > 0
    assert Path(final["ckpt"]).name == "iter_20.ckpt" and Path(final["ckpt"]).exists()
    assert trainer.train_cfg.num_rays_per_batch == 256


def test_torch_psnr_tool_scene_matches_jax_bench(run, tmp_path, monkeypatch):
    """The scene directory's arrays and the data config equal the JAX
    bench's at the same knobs."""
    work, _, _ = run
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    jax_cfg, info = bench.make_bench_scene(tmp_path)
    assert info == {"scene_res": "24x32", "scene": "spheres", "views": 6}
    assert (work / "data.yaml").read_text() == \
        jax_cfg.read_text().replace(str(tmp_path), str(work))
    name = "scene_spheres_24x32_v6"
    files = sorted(p.name for p in (tmp_path / name).iterdir())
    assert files == sorted(p.name for p in (work / name).iterdir()) and files
    for fn in files:
        want, got = np.load(tmp_path / name / fn), np.load(work / name / fn)
        assert sorted(want.files) == sorted(got.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{fn}:{key}")


def _flag_pairs(flags):
    """[(flag, value or None)] of a flag list."""
    out, i = [], 0
    while i < len(flags):
        value = flags[i + 1] if i + 1 < len(flags) and not flags[i + 1].startswith("--") \
            else None
        out.append((flags[i], value))
        i += 1 if value is None else 2
    return out


def test_torch_psnr_tool_regime_is_the_jax_bench_less_tpu_flags():
    """The tool's flags are the JAX bench's TRAIN_REGIME_FLAGS, pair for
    pair: no TPU flag is left out any more (the name is kept from when four
    were)."""
    assert _flag_pairs(psnr_room_run.TRAIN_FLAGS) == _flag_pairs(bench.TRAIN_REGIME_FLAGS)
    assert psnr_room_run.TRAIN_FLAGS == bench.TRAIN_REGIME_FLAGS


def test_torch_psnr_tool_checkpoint_loads_in_jax_and_renders(run, tmp_path):
    """JAX's reader takes the checkpoint: its params restore into JAX's
    field template of the checkpoint's network config and its occupancy
    into JAX's persisted grid; the port's render CLI renders it."""
    _, lines, trainer = run
    ckpt = Path(lines[-1]["ckpt"])
    meta, groups = jckpt.load_checkpoint(ckpt)
    assert meta["iter_ctr"] == 20
    pe = jfrom_dict(JNetworkConfig, meta["net_cfg"]).pos_enc
    grid = jf.make_grid_spec(pe.n_lvls, pe.n_feats_per_lvl, pe.hashmap_size, pe.min_res,
                             pe.max_res_coeff, float(trainer.train_set.bbox.size.max()))
    spec = jf.style_field_spec(grid, class_dim=trainer.train_set.num_classes)
    params = jckpt.restore_tree(jf.field_init(jax.random.PRNGKey(0), spec), groups["params"])
    for key, want in trainer.params.items():
        got = params[key]
        if isinstance(want, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(got), want.detach().numpy())
    occ = jckpt.restore_tree(jpersistable(jocc_init(trainer.renderer.cascade, 32)),
                             groups["occ"])
    np.testing.assert_array_equal(np.asarray(occ.bitfield).reshape(-1),
                                  trainer.renderer.occ_state.bitfield.numpy().reshape(-1))
    summary = cli.main([str(ckpt), "--device", "cpu", "--max-count", "1", "--yes",
                        "--out-dir", str(tmp_path / "frames")])
    out = summary["last"]
    assert out["rgb_map"].shape == (24 * 32, 3)
    for k in ("rgb_map", "trans_map", "weights_sum", "classes"):
        assert bool(torch.isfinite(out[k]).all()), k
    assert list((tmp_path / "frames").glob("*.png"))


def test_torch_psnr_tool_stands_alone_and_defaults_to_cuda(tmp_path):
    """Importing the tool loads no JAX, JAX package or ``bench``; without
    ``--device cpu`` it raises where CUDA is absent, before any scene is
    written."""
    code = ("import sys; import nerfstyle_torch.tools.psnr_room_run; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'nerfstyle_tpu', 'bench'}); print(bad); sys.exit(bool(bad))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        psnr_room_run.main([str(tmp_path / "work")])
    assert not (tmp_path / "work").exists()


def test_torch_quality_compare_resume_starts_both_from_the_checkpoint(run, tmp_path,
                                                                      monkeypatch):
    """``quality_curve_compare.py --resume CKPT`` at zero steps: JAX's
    trainer (JAX's reader) and the port's (the port's reader, no JAX
    trainer built) hold the checkpoint's step count, params, Adam moments
    and EMA and its occupancy grid, leaf for leaf."""
    import jax.tree_util as jtu

    import quality_curve_compare as qcc
    from nerfstyle_torch.training import checkpoint as pckpt

    _, lines, _ = run
    ckpt = lines[-1]["ckpt"]
    for k in ("NERFSTYLE_BENCH_RES", "NERFSTYLE_BENCH_VIEWS", "NERFSTYLE_BENCH_SCENE"):
        monkeypatch.setenv(k, "")
    monkeypatch.chdir(ROOT)
    meta, groups = pckpt.load_checkpoint(Path(ckpt))
    net = [f for f in ENV["EXTRA"].split() if f not in ("--intervals.test", "10")]
    runs = {}
    for impl in ("jax", "port"):
        args = qcc.parse_args([str(tmp_path), "--impl", impl, "--res", "24x32", "--views", "6",
                               "--steps", "0", "--threads", "1", "--resume", ckpt, "--", *net])
        runs[impl], path = qcc.setup(args)
        assert path == tmp_path / f"spheres_{impl}.jsonl"
    jt, pt = runs["jax"].t, runs["port"].t
    assert jt.iter_ctr == pt.iter_ctr == meta["iter_ctr"] == 20
    for group, want in groups.items():
        if group == "occ":
            continue
        jtree, ptree = {"params": (jt.params, pt.params), "opt_state": (jt.opt_state, pt.opt_state),
                        "ema": (jt.ema_state, pt.ema_state)}[group]
        jleaves, pleaves = jtu.tree_leaves(jtree), pckpt.tree_flatten(ptree)
        assert len(jleaves) == len(pleaves) == len(want), group
        for i, (a, b, w) in enumerate(zip(jleaves, pleaves, want)):
            np.testing.assert_array_equal(np.asarray(a), w, err_msg=f"jax {group}.{i}")
            got = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            np.testing.assert_array_equal(got, w, err_msg=f"port {group}.{i}")
    jo, po = jt.renderer.occ_state, pt.renderer.occ_state
    for name in ("density_grid", "bitfield", "skipdist", "mean_density", "mean_count",
                 "local_step"):
        np.testing.assert_array_equal(np.asarray(getattr(jo, name)).reshape(-1),
                                      getattr(po, name).numpy().reshape(-1), err_msg=name)
    assert runs["jax"].occ()[2] == runs["port"].occ()[2]
