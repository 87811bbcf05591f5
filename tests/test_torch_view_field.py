"""Port parity of the two view-dependent field families against the JAX
package: the style field with the view-direction input
(``style_field_spec(use_dir=True)``, color2 on color1 and the direction's
SH basis) and the base field (``FieldSpec(kind="base")``, the reference's
TCNerf: one table, the density MLP's features and the SH basis into
``rgb_net``).  Forward halves at fp32 and bf16 with
``tests/test_torch_field.py``'s tolerances, parameter gradients with
``tests/test_torch_field_grad.py``'s, weights carried over by
``params_from_numpy``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.core.types import BBox as JBBox
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_torch import kernels
from nerfstyle_torch.config import ConfigError
from nerfstyle_torch.core.types import BBox
from nerfstyle_torch.models import fields as tf
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_torch.training.checkpoint import tree_flatten

GRID = dict(num_levels=4, level_dim=2, base_resolution=8, per_level_scale=1.5,
            log2_hashmap_size=10)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_torch_field.py: fp32 reduction order only; bf16 a hidden
# activation may round to the neighbouring bf16 value.
TOL = {"fp32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=0, atol=1e-3)}
FAMILIES = ["style_dir", "base"]


def _specs(family, sh_degree=4):
    if family == "style_dir":
        return (jf.style_field_spec(jh.hashgrid_spec(**GRID), class_dim=3, use_dir=True,
                                    sh_degree=sh_degree),
                tf.style_field_spec(th.hashgrid_spec(**GRID), class_dim=3, use_dir=True,
                                    sh_degree=sh_degree))
    return (jf.FieldSpec(grid=jh.hashgrid_spec(**GRID), kind="base", sh_degree=sh_degree),
            tf.FieldSpec(grid=th.hashgrid_spec(**GRID), kind="base", sh_degree=sh_degree))


def _jax_params(spec, seed):
    params = jf.field_init(jax.random.PRNGKey(seed), spec)
    rng = np.random.default_rng(seed)
    for k in ("x_density_embedder", "x_color_embedder", "x_embedder"):  # widen ±1e-4
        if k in params:
            params[k] = jnp.asarray(rng.uniform(-1, 1, params[k].shape).astype(np.float32))
    return params


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    spec_j, spec_t = _specs(request.param)
    params_j = _jax_params(spec_j, 1)
    tree = jax.tree_util.tree_map(np.asarray, params_j)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.1, 1.1, size=(700, 3)).astype(np.float32)  # some outside the box
    dirs = rng.normal(size=(700, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g_ch = rng.normal(size=(700, spec_t.out_channels)).astype(np.float32)
    g_sig = rng.normal(size=(700,)).astype(np.float32) * 0.1
    return request.param, spec_j, spec_t, params_j, tree, pts, dirs, g_ch, g_sig


def test_torch_view_field_specs():
    style_j, style_t = _specs("style_dir")
    base_j, base_t = _specs("base")
    assert (style_t.out_channels, base_t.out_channels) == (style_j.out_channels,
                                                           base_j.out_channels) == (6, 3)
    assert style_t.rgb_in_dims == 32 and base_t.rgb_in_dims == 31
    assert style_t.needs_dirs and base_t.needs_dirs
    assert not tf.style_field_spec(th.hashgrid_spec(**GRID), class_dim=3).needs_dirs
    for k in ("use_dir", "sh_degree", "density_out_dims", "kind", "density_hidden_dims",
              "rgb_hidden_layers", "density_offset"):
        assert getattr(style_t, k) == getattr(style_j, k)
        assert getattr(base_t, k) == getattr(base_j, k)
    with pytest.raises(ValueError, match="kind"):
        tf.FieldSpec(grid=th.hashgrid_spec(**GRID), kind="nerf")


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_torch_view_field_init_and_params_layout(family, degree):
    """The port's init has the JAX shapes under the JAX keys at every SH
    degree; params round-trip; the checkpoint's leaves are in JAX
    tree_flatten order (base: density_net, rgb_net, x_embedder)."""
    name = family[0]
    spec_j, spec_t = _specs(name, degree)
    params_j = jf.field_init(jax.random.PRNGKey(0), spec_j)
    mine = tf.field_init(spec_t, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params_j)
    assert {k: ([tuple(w.shape) for w in v] if isinstance(v, list) else tuple(v.shape))
            for k, v in mine.items()} == shapes
    back = tf.params_to_numpy(tf.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                           params_j)))
    want_leaves = jax.tree_util.tree_leaves(params_j)
    got_leaves = tree_flatten(back)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(a, np.asarray(b))
    if name == "base":
        assert sorted(mine) == ["density_net", "rgb_net", "x_embedder"]
        with pytest.raises(KeyError, match="rgb_net"):
            tf.params_from_numpy({"x_embedder": np.zeros((8, 2)), "density_net": []})


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_torch_view_field_density_matches_jax(family, dtype):
    _, spec_j, spec_t, params_j, tree, pts, _, _, _ = family
    jd, td = DTYPES[dtype]
    want = jf.field_density(spec_j, params_j, JBBox.from_radius(1.0), jnp.asarray(pts),
                            compute_dtype=jd, use_dedup=False)
    got = tf.field_density(spec_t, tf.params_from_numpy(tree), BBox.from_radius(1.0),
                           torch.from_numpy(pts), td)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_torch_view_field_color_matches_jax(family, dtype):
    _, spec_j, spec_t, params_j, tree, pts, dirs, _, _ = family
    jd, td = DTYPES[dtype]
    want = jf.field_color(spec_j, params_j, JBBox.from_radius(1.0), jnp.asarray(pts),
                          jnp.asarray(dirs), compute_dtype=jd)
    got = tf.field_color(spec_t, tf.params_from_numpy(tree), BBox.from_radius(1.0),
                         torch.from_numpy(pts), td, dirs=torch.from_numpy(dirs))
    assert got.shape == (pts.shape[0], spec_t.out_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


def test_torch_view_field_needs_directions(family):
    _, _, spec_t, _, tree, pts, _, _, _ = family
    with pytest.raises(ValueError, match="dirs"):
        tf.field_apply(spec_t, tf.params_from_numpy(tree), BBox.from_radius(1.0),
                       torch.from_numpy(pts))


def _close_leaves(got, want, atol_frac, what):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=atol_frac * np.abs(w).max(), err_msg=f"{what} leaf {i}")


def _port_params(tree):
    params = tf.params_from_numpy(tree)
    for w in tree_flatten(params):
        w.requires_grad_(True)
    return params


def test_torch_view_field_apply_forward_and_grads_match_jax(family):
    """tests/test_torch_field_grad.py's tolerances: outputs rtol 1e-5;
    gradients rtol 1e-4 with atol 1e-5 of each leaf's largest.  The
    directions take no gradient."""
    name, spec_j, spec_t, params_j, tree, pts, dirs, g_ch, g_sig = family
    bb_j, bb_t = JBBox.from_radius(1.0), BBox.from_radius(1.0)

    def f(p):
        ch, sig = jf.field_apply(spec_j, p, bb_j, jnp.asarray(pts), jnp.asarray(dirs))
        return jnp.sum(ch * g_ch) + jnp.sum(sig * g_sig), (ch, sig)

    (_, (ch_j, sig_j)), grads_j = jax.value_and_grad(f, has_aux=True)(params_j)
    params = _port_params(tree)
    ch, sig = tf.field_apply(spec_t, params, bb_t, torch.from_numpy(pts),
                             dirs=torch.from_numpy(dirs))
    np.testing.assert_allclose(ch.detach().numpy(), np.asarray(ch_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sig.detach().numpy(), np.asarray(sig_j), rtol=1e-5, atol=1e-6)
    ((ch * torch.from_numpy(g_ch)).sum() + (sig * torch.from_numpy(g_sig)).sum()).backward()
    _close_leaves([w.grad for w in tree_flatten(params)], jax.tree_util.tree_leaves(grads_j),
                  1e-5, f"{name} field_apply grads")
    # The base field's color gradient reaches the density MLP and the table.
    table = "x_embedder" if name == "base" else "x_color_embedder"
    assert bool(params[table].grad.any())


def test_torch_view_field_color_grads_match_jax(family):
    """The color branch alone (the frame's phase B, the style stage's
    path): gradients against jax.grad of field_color."""
    name, spec_j, spec_t, params_j, tree, pts, dirs, g_ch, _ = family
    bb_j, bb_t = JBBox.from_radius(1.0), BBox.from_radius(1.0)
    grads_j = jax.grad(lambda p: jnp.sum(
        jf.field_color(spec_j, p, bb_j, jnp.asarray(pts), jnp.asarray(dirs)) * g_ch))(params_j)
    params = _port_params(tree)
    ch = tf.field_color(spec_t, params, bb_t, torch.from_numpy(pts), dirs=torch.from_numpy(dirs))
    (ch * torch.from_numpy(g_ch)).sum().backward()
    got = [torch.zeros_like(w) if w.grad is None else w.grad for w in tree_flatten(params)]
    _close_leaves(got, jax.tree_util.tree_leaves(grads_j), 1e-5, f"{name} field_color grads")


def test_torch_view_field_kernel_config(family):
    """On CUDA the color head's input may be padded up to 32 wide and no
    further; the CPU takes any width."""
    _, _, spec_t, _, _, _, _, _, _ = family
    grid16 = th.hashgrid_spec(**{**GRID, "num_levels": 8})  # a 16-wide encoding, as K5 takes
    for degree in (1, 2, 3, 4):
        tf.check_field_spec(dataclasses.replace(spec_t, grid=grid16, sh_degree=degree),
                            torch.device("cuda"))
    wide = (tf.FieldSpec(grid=grid16, kind="base", density_out_dims=32)
            if spec_t.kind == "base" else None)
    if wide is not None:
        assert wide.rgb_in_dims == 47 > max(kernels.MLP_IN_DIMS)
        with pytest.raises(ConfigError, match="47 wide"):
            tf.check_field_spec(wide, torch.device("cuda"))
        tf.check_field_spec(wide, torch.device("cpu"))
