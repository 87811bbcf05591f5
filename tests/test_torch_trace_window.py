"""The profiler trace window of the port's trainers (``--profile_dir``,
``--profile_start``, ``--profile_steps``), on the CPU at a tiny size: the
window's iterations run under ``torch.profiler``, each in a ``step <n>``
range, and are written as one Chrome trace JSON, as the JAX trainer writes
its ``jax.profiler`` window."""

import json

import numpy as np
import pytest

from nerfstyle_torch import train, utils
from nerfstyle_torch.data.synthetic import generate_scene

TINY = ["--device", "cpu", "--num_rays_per_batch", "128", "--pos_enc.n_lvls", "4",
        "--pos_enc.hashmap_size", "12", "--pos_enc.max_res_coeff", "16", "--grid_size", "32",
        "--max_steps", "128", "--max_eval_count", "1", "--intervals.print", "0",
        "--intervals.log", "0", "--intervals.test", "0", "--yes"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace_window")
    generate_scene(root / "scene", num_train=4, num_test=1, h=24, w=32)
    data_cfg = root / "data.yaml"
    data_cfg.write_text(f"root_path: {root / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    return root, data_cfg


def _run(tmp_path, data_cfg, steps, start, length, *extra):
    pdir = tmp_path / "trace"
    trainer = train.main([*TINY, "--log-dir", str(tmp_path / "log"), "--data-cfg", str(data_cfg),
                          "--num_iterations", str(steps), "--intervals.ckpt", str(steps),
                          "--profile_dir", str(pdir), "--profile_start", str(start),
                          "--profile_steps", str(length), *extra])
    return trainer, pdir


def _step_ranges(path):
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["name"] for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("step ")),
                  key=lambda n: int(n.split()[1]))


def test_torch_trace_window_writes_one_range_a_step(scene, tmp_path):
    _, data_cfg = scene
    trainer, pdir = _run(tmp_path, data_cfg, 6, 2, 3)
    assert trainer.iter_ctr == 6
    assert sorted(pdir.iterdir()) == [trainer.trace_path]
    assert trainer.trace_path.name == "trace_steps_2-4.json"
    assert _step_ranges(trainer.trace_path) == ["step 2", "step 3", "step 4"]
    # The traced steps also ran the train step's operators.
    events = json.loads(trainer.trace_path.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_torch_trace_window_past_the_end_writes_nothing(scene, tmp_path):
    _, data_cfg = scene
    trainer, pdir = _run(tmp_path, data_cfg, 3, 5, 2)
    assert trainer.iter_ctr == 3 and trainer.trace_path is None
    assert not pdir.exists()


def test_torch_trace_window_cut_by_the_end_is_written(scene, tmp_path):
    _, data_cfg = scene
    trainer, pdir = _run(tmp_path, data_cfg, 4, 2, 10)
    assert trainer.trace_path == pdir / "trace_steps_2-3.json"
    assert _step_ranges(trainer.trace_path) == ["step 2", "step 3"]


def test_torch_style_stage_takes_the_trace_window(scene, tmp_path):
    root, data_cfg = scene
    recon, _ = _run(tmp_path / "recon", data_cfg, 2, 9, 1)  # a window it never reaches
    assert recon.trace_path is None
    yy, xx = np.meshgrid(np.linspace(0, 1, 20), np.linspace(0, 1, 28), indexing="ij")
    utils.save_image(np.stack([yy, xx, 1 - yy], -1), tmp_path / "style.png")
    np.savez(tmp_path / "seg.npz", seg_map=(yy > .5).astype(int) * 2 + (xx > .5).astype(int))
    pdir = tmp_path / "style_trace"
    st = train.main([*TINY, "--ckpt", str(recon.log_dir / "iter_2.ckpt"),
                     "--log-dir", str(tmp_path / "style"), "--style-image",
                     str(tmp_path / "style.png"), "--style_seg_path", str(tmp_path / "seg.npz"),
                     "--num_iterations", "3", "--intervals.ckpt", "3", "--profile_dir", str(pdir),
                     "--profile_start", "1", "--profile_steps", "2"])
    assert type(st).__name__ == "StyleTrainer" and st.iter_ctr == 3
    assert st.trace_path == pdir / "trace_steps_1-2.json"
    assert _step_ranges(st.trace_path) == ["step 1", "step 2"]
