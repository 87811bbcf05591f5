"""End-to-end smoke of the port's trainer on the CPU: the tiny config of
tests/test_train_smoke.py through ``python -m nerfstyle_torch.train``, and
the entry point's flag rules against the JAX package's config loader."""

import shutil

import numpy as np
import pytest
import torch

from nerfstyle_tpu import config as jcfg
from nerfstyle_tpu.data.synthetic import generate_scene
from nerfstyle_torch import config as tcfg
from nerfstyle_torch import train

TINY = [
    "--num_rays_per_batch", "256",
    "--pos_enc.n_lvls", "4",
    "--pos_enc.hashmap_size", "12",
    "--pos_enc.max_res_coeff", "16",
    "--grid_size", "32",
    "--max_steps", "128",
    "--max_samples_per_ray", "32",
    "--density_offset", "-4",
    "--update_thres", "4",
    "--max_eval_count", "1",
    "--intervals.print", "10",
    "--intervals.log", "10",
    "--intervals.test", "0",
    "--enable_amp",  # toggles the default True off
]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_smoke")
    generate_scene(root / "scene", num_train=6, num_test=2, h=48, w=64)
    data_cfg = root / "data.yaml"
    data_cfg.write_text(f"root_path: {root / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    yield root, data_cfg
    shutil.rmtree(root, ignore_errors=True)


def _argv(root, data_cfg, *extra):
    return ["--device", "cpu", "--log-dir", str(root / "logs"), "--data-cfg", str(data_cfg),
            "--yes", *TINY, *extra]


def test_torch_train_smoke_learns(scene):
    """40 iterations: the EMA params' test PSNR exceeds 10 dB and rises at
    least 3 dB above the untrained field's; the losses stay finite, both
    occupancy updates run, scalars and the final checkpoint are written."""
    root, data_cfg = scene
    trainer = train.main(_argv(root, data_cfg, "--num_iterations", "40",
                               "--intervals.ckpt", "40", "--test_before_train"))
    assert trainer.iter_ctr == 40
    before = trainer.test_history[0]["psnr"]
    metrics = trainer.test_networks()
    assert metrics["psnr"] > 10.0 and metrics["psnr"] > before + 3.0, (before, metrics)
    assert int(trainer.opt_state.total_notfinite) == 0
    assert all(bool(torch.isfinite(v)) for v in trainer.last_losses.values())
    assert trainer.renderer.update_ms["full"] and trainer.renderer.update_ms["random"]
    assert (trainer.log_dir / "iter_40.ckpt").exists()
    assert (trainer.log_dir / "scalars.jsonl").read_text().count("train/mse_loss") == 4
    counts = trainer.iter_counts[-1]
    assert 0 < counts["num_sig"] <= counts["num_points"]


def test_torch_train_entry_point_defaults_to_cuda(scene):
    root, data_cfg = scene
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    argv = _argv(root, data_cfg, "--num_iterations", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(argv[2:])  # no --device: cuda


def test_torch_train_rejects_leftover_flags_and_adaptive_batch(scene):
    root, data_cfg = scene
    with pytest.raises(SystemExit) as exc:
        train.main(_argv(root, data_cfg, "--num_iterations", "1", "--not_a_flag", "3"))
    assert exc.value.code == 1
    with pytest.raises(NotImplementedError):
        train.main(_argv(root, data_cfg, "--num_iterations", "1", "--adaptive_batch"))


def test_torch_train_rejects_profile_dir(scene, tmp_path):
    """--profile_dir is not accepted and ignored: since the trace window is
    ported, a one-step window writes its trace (the window's rules are
    tests/test_torch_trace_window.py's)."""
    root, data_cfg = scene
    trainer = train.main(_argv(root, data_cfg, "--num_iterations", "1", "--profile_dir",
                               str(tmp_path / "trace"), "--profile_start", "0",
                               "--profile_steps", "1"))
    assert trainer.trace_path == tmp_path / "trace" / "trace_steps_0-0.json"
    assert trainer.trace_path.stat().st_size > 0


@pytest.mark.parametrize("group", ["TrainConfig", "NetworkConfig", "RendererConfig"])
def test_torch_config_flags_match_jax(group):
    """The same flags through both packages' layered loaders: equal configs
    and equal leftovers (bool flags toggle their loaded default, nested
    fields take dotted flags, dashes stand for underscores)."""
    nargs = ["--enable_amp", "--intervals.print", "7", "--num-rays-per-batch", "128",
             "--pos_enc.n_lvls", "4", "--density_offset", "-4", "--grid_size", "32",
             "--max_budget_samples", "4096", "--not_a_flag", "1"]
    want, want_rest = getattr(jcfg, group).load_nargs(nargs=nargs)
    got, got_rest = getattr(tcfg, group).load_nargs(nargs=nargs)
    assert got.asdict() == want.asdict()
    assert got_rest == want_rest and "--not_a_flag" in got_rest


def test_torch_config_reads_the_repository_yaml():
    """Every config file under cfgs/ reads as the JAX loader reads it."""
    for group, path in (("DatasetConfig", "cfgs/dataset/llff_fern.yaml"),
                        ("DatasetConfig", "cfgs/dataset/synthetic.yaml"),
                        ("RendererConfig", "cfgs/renderer/llff.yaml"),
                        ("TrainConfig", "cfgs/training/style.yaml")):
        want = getattr(jcfg, group).load(path)
        got = getattr(tcfg, group).load(path)
        assert got.asdict() == want.asdict(), path
    tc = tcfg.TrainConfig.load()
    assert tc.enable_amp and tc.two_phase_train and tc.intervals.print == 100
    assert np.isclose(tc.ema_decay, 0.95)


@pytest.mark.parametrize("precrop,flip", [(1.0, 0), (0.5, 0), (0.37, 3)])
def test_torch_precrop_grid_and_pixel_rays_match_jax(precrop, flip):
    """The train step's camera grid (precrop window, axis flips) and its rays
    for pixel indices drawn with replacement, against the JAX package."""
    import jax.numpy as jnp

    from nerfstyle_tpu.core import cameras as jcam
    from nerfstyle_tpu.core import types as jtypes
    from nerfstyle_torch.core import cameras as tcam
    from nerfstyle_torch.core import types as ttypes

    geom = dict(h=48, w=64, fx=57.6, fy=57.6, cx=32.0, cy=24.0)
    want = jcam.camera_dir_grid(jtypes.Intrinsics(**geom), flip, precrop)
    got = tcam.camera_dir_grid(ttypes.Intrinsics(**geom), flip, precrop)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    gen = torch.Generator().manual_seed(0)
    cam = got[0].reshape(-1, 3)
    idx = tcam.sample_pixels(500, cam.shape[0], gen)
    assert idx.dtype == torch.int64 and 0 <= int(idx.min()) and int(idx.max()) < cam.shape[0]
    assert len(torch.unique(idx)) < 500 or cam.shape[0] > 10 * 500  # with replacement
    rng = np.random.default_rng(1)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.normal(size=3)
    rays = tcam.pixel_rays(torch.from_numpy(cam), torch.from_numpy(pose), idx)
    jdirs = jnp.asarray(cam)[jnp.asarray(idx.numpy())] @ jnp.asarray(pose)[:3, :3].T
    jrays = jtypes.make_rays(jnp.asarray(pose)[:3, 3], jdirs)
    np.testing.assert_allclose(rays.origins.numpy(), np.asarray(jrays.origins), rtol=1e-6)
    np.testing.assert_allclose(rays.dirs.numpy(), np.asarray(jrays.dirs), rtol=1e-5, atol=1e-6)
