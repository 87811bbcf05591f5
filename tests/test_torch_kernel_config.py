"""The network configs the CUDA kernels take.  ``check_kernel_config``
(called by ``Trainer.__init__``, ``render.cli.load_renderer`` and, on the
field spec, by ``Renderer``) raises ConfigError on a CUDA device for each
flag outside K5's and K1/K2's instantiations, naming the flag and its
range, before any data loads; on the CPU the plain path takes every
config.  Neither case needs a card: the check reads the device only."""

import pytest
import torch

from nerfstyle_torch.config import ConfigError, NetworkConfig
from nerfstyle_torch.models import fields as tf
from nerfstyle_torch.ops import hashgrid as th

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def _config(**flags) -> NetworkConfig:
    cfg = NetworkConfig()
    for key, value in flags.items():
        if key.startswith("pos_enc."):
            setattr(cfg.pos_enc, key.split(".", 1)[1], value)
        else:
            setattr(cfg, key, value)
    return cfg


@pytest.mark.parametrize("flags,message", [
    ({"density_hidden_dims": 128}, "--density_hidden_dims 128: the CUDA MLP kernel takes 64"),
    ({"rgb_hidden_dims": 32}, "--rgb_hidden_dims 32: the CUDA MLP kernel takes 64"),
    ({"density_hidden_layers": 3}, "--density_hidden_layers 3: the CUDA MLP kernel takes 1 or 2"),
    ({"rgb_hidden_layers": 0}, "--rgb_hidden_layers 0: the CUDA MLP kernel takes 1 or 2"),
    ({"pos_enc.n_feats_per_lvl": 8},
     "--pos_enc.n_feats_per_lvl 8: the CUDA hash-grid kernels take 1, 2, 4"),
    ({"pos_enc.n_lvls": 12},
     "--pos_enc.n_lvls 12 x --pos_enc.n_feats_per_lvl 2 = 24: the CUDA MLP kernel takes "
     "encodings 16 or 32 wide"),
])
def test_torch_kernel_config_refuses_what_the_kernels_do_not_take(flags, message):
    cfg = _config(**flags)
    with pytest.raises(ConfigError) as err:
        tf.check_kernel_config(cfg, CUDA)
    assert message in str(err.value)
    tf.check_kernel_config(cfg, CPU)  # the plain path takes it


def test_torch_kernel_config_takes_the_kernels_ranges():
    """The defaults and the corners of the ranges pass on CUDA, and the
    field spec's check agrees with the config's."""
    for flags in ({}, {"density_hidden_layers": 2, "rgb_hidden_layers": 1},
                  {"pos_enc.n_lvls": 8, "pos_enc.n_feats_per_lvl": 4},
                  {"pos_enc.n_lvls": 16, "pos_enc.n_feats_per_lvl": 1},
                  {"pos_enc.n_lvls": 32, "pos_enc.n_feats_per_lvl": 1}):
        tf.check_kernel_config(_config(**flags), CUDA)
    grid = th.hashgrid_spec(num_levels=8, level_dim=4, base_resolution=16, per_level_scale=1.5,
                            log2_hashmap_size=10)
    tf.check_field_spec(tf.style_field_spec(grid, class_dim=0), CUDA)
    with pytest.raises(ConfigError, match="--rgb_hidden_dims 32"):
        tf.check_field_spec(tf.style_field_spec(grid, class_dim=0, rgb_hidden_dims=32), CUDA)


def test_torch_trainer_and_renderer_refuse_before_loading_data(tmp_path, monkeypatch):
    """With a CUDA device (claimed, no card needed: nothing reaches it), the
    trainer raises on the flag before it loads the dataset (an LLFF config,
    which the port cannot load yet, would raise otherwise), and the
    renderer on its field spec."""
    from nerfstyle_torch.config import BaseConfig
    from nerfstyle_torch.core.types import BBox, Intrinsics
    from nerfstyle_torch.render.renderer import Renderer, RenderSettings
    from nerfstyle_torch.training.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    data = tmp_path / "data.yaml"
    data.write_text(f"root_path: {tmp_path / 'none'}\ntype: LLFF\nbound: 2.0\nscale: 1.0\n")
    cfg, nargs = BaseConfig.read_nargs(["--log-dir", str(tmp_path / "run"), "--data-cfg",
                                        str(data), "--density_hidden_layers", "3"])
    with pytest.raises(ConfigError, match="--density_hidden_layers 3"):
        Trainer(cfg, nargs, "cuda")
    grid = th.hashgrid_spec(num_levels=16, level_dim=2, base_resolution=16, per_level_scale=1.5,
                            log2_hashmap_size=10)
    spec = tf.style_field_spec(grid, class_dim=0, density_hidden_dims=32)
    with pytest.raises(ConfigError, match="--density_hidden_dims 32"):
        Renderer(spec, BBox.from_radius(1.0), RenderSettings(), Intrinsics(h=4, w=4, fx=4.0,
                 fy=4.0, cx=2.0, cy=2.0), 1.0, device="cuda")


def test_torch_field_apply_at_four_features_a_level_matches_jax():
    """At 4 features a level the train step's fused [T, 8] encode would be
    wider than K1's rows: field_apply encodes the two tables on their own
    (on either device), with the same channels, densities and gradients as
    JAX's fused encode (the tolerances of tests/test_torch_field_grad.py)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nerfstyle_torch.core.types import BBox
    from nerfstyle_torch.training.checkpoint import tree_flatten
    from nerfstyle_tpu.core.types import BBox as JBBox
    from nerfstyle_tpu.models import fields as jf
    from nerfstyle_tpu.ops import hashgrid as jh

    grid = dict(num_levels=4, level_dim=4, base_resolution=8, per_level_scale=1.5,
                log2_hashmap_size=10)
    spec_j = jf.style_field_spec(jh.hashgrid_spec(**grid), class_dim=2)
    spec_t = tf.style_field_spec(th.hashgrid_spec(**grid), class_dim=2)
    params_j = jf.field_init(jax.random.PRNGKey(4), spec_j)
    rng = np.random.default_rng(4)
    for k in ("x_density_embedder", "x_color_embedder"):
        params_j[k] = jnp.asarray(rng.uniform(-1, 1, params_j[k].shape).astype(np.float32))
    pts = rng.uniform(-1.1, 1.1, size=(500, 3)).astype(np.float32)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    g_ch = rng.normal(size=(500, 5)).astype(np.float32)
    g_sig = rng.normal(size=(500,)).astype(np.float32) * 0.1

    def f(p):
        ch, sig = jf.field_apply(spec_j, p, JBBox.from_radius(1.0), jnp.asarray(pts),
                                 jnp.asarray(dirs))
        return jnp.sum(ch * g_ch) + jnp.sum(sig * g_sig), (ch, sig)

    (_, (ch_j, sig_j)), grads_j = jax.value_and_grad(f, has_aux=True)(params_j)
    params = tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j))
    leaves = tree_flatten(params)
    for w in leaves:
        w.requires_grad_(True)
    ch, sig = tf.field_apply(spec_t, params, BBox.from_radius(1.0), torch.from_numpy(pts))
    np.testing.assert_allclose(ch.detach().numpy(), np.asarray(ch_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sig.detach().numpy(), np.asarray(sig_j), rtol=1e-5, atol=1e-6)
    loss = (ch * torch.from_numpy(g_ch)).sum() + (sig * torch.from_numpy(g_sig)).sum()
    for g, w in zip(torch.autograd.grad(loss, leaves), jax.tree_util.tree_leaves(grads_j)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())
