"""What the port's renderer takes from a checkpoint, and its dense frame,
against the JAX package on the CPU:

* a checkpoint loaded under another ``max_steps`` (the README's style run:
  ``--max_steps 512`` on a 1024-step checkpoint) has its demand estimate
  ``mean_count`` rescaled, so both packages write the same ``occ``
  ``mean_count`` and ``budget_bucket``;
* the ``adaptive_march=False`` frame colors every sample of nonzero weight,
  as JAX's single-phase frame does.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_torch.config import BaseConfig
from nerfstyle_torch.data.synthetic import generate_scene
from nerfstyle_torch.render import cli
from nerfstyle_torch.training.trainer import Trainer
from nerfstyle_tpu.config import (
    BaseConfig as JBaseConfig,
    DatasetConfig as JDatasetConfig,
    HashGridConfig as JHashGridConfig,
    NetworkConfig as JNetworkConfig,
    RendererConfig as JRendererConfig,
    TrainConfig as JTrainConfig,
)
from nerfstyle_tpu.core.types import DatasetSplit as JSplit
from nerfstyle_tpu.data import get_dataset as jget_dataset
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.ops.occupancy import PersistedOccupancy as JPersisted
from nerfstyle_tpu.ops.occupancy import occupancy_persistable as jpersistable
from nerfstyle_tpu.ops.occupancy import occupancy_restore as jrestore
from nerfstyle_tpu.render.renderer import Renderer as JRenderer
from nerfstyle_tpu.render.renderer import RenderSettings as JRenderSettings
from nerfstyle_tpu.training import checkpoint as jckpt
from nerfstyle_tpu.training.trainer import Trainer as JTrainer

NET = ["--pos_enc.n_lvls", "4", "--pos_enc.hashmap_size", "10", "--pos_enc.max_res_coeff", "8",
       "--grid_size", "16", "--max_eval_count", "1", "--intervals.print", "0",
       "--intervals.log", "0", "--intervals.test", "0"]
RAYS = 256


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("render_static")
    generate_scene(root / "scene", num_train=2, num_test=1, h=24, w=32)
    data_cfg = root / "data.yaml"
    data_cfg.write_text(f"root_path: {root / 'scene'}\ntype: Synthetic\nbound: 1.0\nscale: 1.0\n")
    return root, data_cfg


def _saved(path: Path):
    """(occ mean_count, renderer_static budget_bucket) of a checkpoint."""
    meta, groups = jckpt.load_checkpoint(path)
    occ = jckpt.restore_tree(JPersisted(*[np.zeros(1)] * 5), groups["occ"])
    return int(np.asarray(occ.mean_count)), int(meta["renderer_static"]["budget_bucket"])


# Samples a ray of the recon run's demand (1.25 x mean_count / rays), on
# both sides of several ladder rungs.
@pytest.mark.parametrize("per_ray", [5.5, 13.0, 30.0, 41.0, 150.0])
def test_torch_style_load_rescales_mean_count_like_jax(scene, per_ray, tmp_path):
    """A JAX-written 1024-step checkpoint whose bucket JAX tuned from its
    mean_count, loaded for stylization (model only) at --max_steps 512 by
    both trainers and saved again: equal occ mean_count (int32 of the
    float32 product with 0.5) and equal budget_bucket."""
    root, data_cfg = scene
    recon = JTrainer(JBaseConfig(log_dir=tmp_path / "jax_recon", data_cfg=data_cfg),
                     NET + ["--max_steps", "1024", "--num_rays_per_batch", str(RAYS)],
                     assume_yes=True)
    r = recon.renderer
    mean_count = int(per_ray * RAYS / 1.25)
    r.occ_state = r.occ_state._replace(mean_count=jnp.int32(mean_count))
    r._mean_count_host, r._last_num_rays = mean_count, RAYS
    for _ in range(3):  # a debounced shrink lands on the second call
        r._retune_bucket()
    recon.save_ckpt()
    (ckpt,) = recon.log_dir.glob("*.ckpt")
    assert _saved(ckpt)[0] == mean_count

    argv = NET + ["--max_steps", "512", "--num_rays_per_batch", str(RAYS)]
    jstyle = JTrainer(JBaseConfig(ckpt=ckpt, log_dir=tmp_path / "jax_style", data_cfg=data_cfg),
                      list(argv), load_model_only=True, assume_yes=True)
    jstyle.save_ckpt()
    want = _saved(next(jstyle.log_dir.glob("*.ckpt")))
    tstyle = Trainer(BaseConfig(ckpt=ckpt, log_dir=tmp_path / "port_style", data_cfg=data_cfg,
                                yes=True), list(argv), device="cpu", load_model_only=True)
    got = _saved(tstyle.save_ckpt())
    assert want[0] == int(np.float32(mean_count) * np.float32(0.5))
    assert got == want


def test_torch_same_max_steps_keeps_mean_count(scene, tmp_path):
    """At the checkpoint's own max_steps nothing is rescaled."""
    root, data_cfg = scene
    t = Trainer(BaseConfig(log_dir=tmp_path / "a", data_cfg=data_cfg, yes=True),
                NET + ["--max_steps", "256"], device="cpu")
    t.renderer.occ_state = t.renderer.occ_state._replace(
        mean_count=torch.tensor(12345, dtype=torch.int32))
    t.renderer._last_num_rays = RAYS
    path = t.save_ckpt()
    again = Trainer(BaseConfig(ckpt=path, log_dir=tmp_path / "b", data_cfg=data_cfg, yes=True),
                    NET + ["--max_steps", "256"], device="cpu", load_model_only=True)
    assert int(again.renderer.occ_state.mean_count) == 12345
    assert again.renderer.budget_bucket() == t.renderer.budget_bucket()


# ---------------------------------------------------------------------------
# The adaptive_march=False frame
# ---------------------------------------------------------------------------


def _jax_params(spec, seed):
    params = jf.field_init(jax.random.PRNGKey(seed), spec)
    rng = np.random.default_rng(seed)
    for k in ("x_density_embedder", "x_color_embedder"):  # widen the ±1e-4 init
        params[k] = jnp.asarray(rng.uniform(-1, 1, params[k].shape).astype(np.float32))
    return params


def test_torch_dense_frame_matches_jax(scene, tmp_path):
    """A 32x24 frame with adaptive_march off, through JAX's Renderer.render
    (single phase: every sample colored) and the port's (phase B keeps
    every w > 0 sample).  density_offset -8 leaves most samples below the
    two-phase frame's weight threshold (1e-5), which the frame with
    adaptive_march on drops and the dense frame keeps.  Tolerance: the
    fp32 sums in another order (JAX's flat fp32 cumsum of the optical
    depth, the port's float64 plain sums): atol 1e-6 on every map (measured
    up to 3.6e-7)."""
    root, _ = scene
    dataset_cfg = JDatasetConfig(root_path=root / "scene", type="Synthetic", bound=1.0)
    net_cfg = JNetworkConfig(pos_enc=JHashGridConfig(n_lvls=4, n_feats_per_lvl=2,
                                                     hashmap_size=10, min_res=8,
                                                     max_res_coeff=8), density_offset=-8.0)
    render_cfg = JRendererConfig(grid_size=16, max_steps=128, min_near=0.05)
    train_set = jget_dataset(dataset_cfg, split=JSplit.TRAIN)
    test_set = jget_dataset(dataset_cfg, split=JSplit.TEST, max_count=1)
    grid = jf.make_grid_spec(4, 2, 10, 8, 8, float(np.max(np.asarray(train_set.bbox.size))))
    spec = jf.style_field_spec(grid, class_dim=train_set.num_classes, density_offset=-8.0)
    params = _jax_params(spec, 3)
    bits = np.random.default_rng(4).random(16**3) < 0.3
    occ = JPersisted(jnp.zeros((1, 16**3)), jnp.asarray(bits), jnp.float32(0.0), jnp.int32(0),
                     jnp.int32(0))
    meta = {
        "version": "test", "log_dir": str(tmp_path / "log"), "iter_ctr": 0,
        "dataset_cfg": dataset_cfg.asdict(), "train_cfg": JTrainConfig(enable_amp=False).asdict(),
        "net_cfg": net_cfg.asdict(), "render_cfg": render_cfg.asdict(),
        "renderer_static": {"raymarch_channels": 3 + train_set.num_classes, "bound": 1.0},
    }
    path = tmp_path / "jax.ckpt"
    jckpt.save_checkpoint(path, meta, {"params": params, "occ": occ})

    settings = JRenderSettings(grid_size=16, min_near=0.05, t_thresh=render_cfg.t_thresh,
                               max_steps=128, adaptive_march=False)
    jr = JRenderer(spec, train_set.bbox, settings, test_set.intr, 1.0,
                   raymarch_channels=3 + train_set.num_classes)
    jr.occ_state = jrestore(jckpt.restore_tree(jpersistable(jr.occ_state),
                                               jckpt.load_checkpoint(path)[1]["occ"]), 16)
    jr.update_occ = False
    _, pose = test_set[0]
    want = jr.render(params, jnp.asarray(pose), None, training=False)

    renderer, tparams, _, _ = cli.load_renderer(path, "cpu", None, max_count=1)
    on = renderer.settings
    assert on.adaptive_march
    pose_t = torch.from_numpy(np.asarray(pose))
    renderer.settings = dataclasses.replace(on, adaptive_march=False)
    got = renderer.render(tparams, pose_t)
    renderer.settings = on
    two_phase = renderer.render(tparams, pose_t)
    assert got["num_marched"] == two_phase["num_marched"]
    assert two_phase["num_sig"] < got["num_sig"] == got["num_marched"]
    for key in ("rgb_map", "weights_sum", "classes", "trans_map"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-6,
                                   err_msg=key)
    # The two-phase frame drops what the dense frame keeps: beyond 1e-5.
    assert float(np.abs(two_phase["rgb_map"].numpy() - np.asarray(want["rgb_map"])).max()) > 1e-5
