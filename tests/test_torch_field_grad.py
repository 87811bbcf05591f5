"""Port parity of the field's gradients (the train step's phase B): the fused
dual-table ``field_apply`` (kernels K1 and K2 on the [T, 4] concatenation),
the differentiable ``field_density``, ``trunc_exp`` and the MLP backward, each
against ``jax.grad`` of the JAX function on the same inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.core.types import BBox as JBBox
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_tpu.ops import mlp as jmlp
from nerfstyle_torch.core.types import BBox
from nerfstyle_torch.models import fields as tf
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_torch.ops import mlp as tmlp
from nerfstyle_torch.training.checkpoint import tree_flatten

GRID = dict(num_levels=4, level_dim=2, base_resolution=8, per_level_scale=1.5,
            log2_hashmap_size=10)
CLASSES = 3


@pytest.fixture(scope="module")
def field():
    spec_j = jf.style_field_spec(jh.hashgrid_spec(**GRID), class_dim=CLASSES)
    spec_t = tf.style_field_spec(th.hashgrid_spec(**GRID), class_dim=CLASSES)
    params_j = jf.field_init(jax.random.PRNGKey(1), spec_j)
    rng = np.random.default_rng(1)
    for k in ("x_density_embedder", "x_color_embedder"):  # widen the +-1e-4 init
        params_j[k] = jnp.asarray(rng.uniform(-1, 1, params_j[k].shape).astype(np.float32))
    tree = jax.tree_util.tree_map(np.asarray, params_j)
    pts = rng.uniform(-1.1, 1.1, size=(700, 3)).astype(np.float32)  # some outside the box
    dirs = rng.normal(size=(700, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g_ch = rng.normal(size=(700, 3 + CLASSES)).astype(np.float32)
    g_sig = rng.normal(size=(700,)).astype(np.float32) * 0.1
    return spec_j, spec_t, params_j, tree, pts, dirs, g_ch, g_sig


def _port_params(tree):
    params = tf.params_from_numpy(tree)
    for w in tree_flatten(params):
        w.requires_grad_(True)
    return params


def _close_leaves(got, want, atol_frac, what):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=atol_frac * np.abs(w).max(), err_msg=f"{what} leaf {i}")


def test_torch_field_apply_forward_and_grads_match_jax(field):
    """One encode of the concatenated [T, 4] tables feeds both halves, and
    its table gradient splits back into x_density_embedder and
    x_color_embedder.  fp32: the MLP products reassociate and the JAX table
    gradient takes each row as a difference of one fp32 running sum: outputs
    rtol 1e-5; gradients rtol 1e-4 with atol 1e-5 of each leaf's largest."""
    spec_j, spec_t, params_j, tree, pts, dirs, g_ch, g_sig = field
    bb_j, bb_t = JBBox.from_radius(1.0), BBox.from_radius(1.0)

    def f(p):
        ch, sig = jf.field_apply(spec_j, p, bb_j, jnp.asarray(pts), jnp.asarray(dirs))
        return jnp.sum(ch * g_ch) + jnp.sum(sig * g_sig), (ch, sig)

    (_, (ch_j, sig_j)), grads_j = jax.value_and_grad(f, has_aux=True)(params_j)
    params = _port_params(tree)
    ch, sig = tf.field_apply(spec_t, params, bb_t, torch.from_numpy(pts))
    np.testing.assert_allclose(ch.detach().numpy(), np.asarray(ch_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sig.detach().numpy(), np.asarray(sig_j), rtol=1e-5, atol=1e-6)
    ((ch * torch.from_numpy(g_ch)).sum() + (sig * torch.from_numpy(g_sig)).sum()).backward()
    _close_leaves([w.grad for w in tree_flatten(params)], jax.tree_util.tree_leaves(grads_j),
                  1e-5, "field_apply grads")
    for k in ("x_density_embedder", "x_color_embedder"):
        assert bool(params[k].grad.any()) and bool((params[k].grad == 0).any())


def test_torch_field_density_grads_match_jax(field):
    """The density branch alone (the sparsity loss's path): its gradient
    reaches the density table and density_net only."""
    spec_j, spec_t, params_j, tree, pts, _, _, g_sig = field
    bb_j, bb_t = JBBox.from_radius(1.0), BBox.from_radius(1.0)
    grads_j = jax.grad(lambda p: jnp.sum(
        jf.field_density(spec_j, p, bb_j, jnp.asarray(pts)) * g_sig))(params_j)
    params = _port_params(tree)
    sig = tf.field_density(spec_t, params, bb_t, torch.from_numpy(pts))
    (sig * torch.from_numpy(g_sig)).sum().backward()
    for k in ("x_density_embedder", "density_net"):
        got = [w.grad for w in tree_flatten(params[k])]
        _close_leaves(got, jax.tree_util.tree_leaves(grads_j[k]), 1e-5, k)
    assert params["x_color_embedder"].grad is None and params["class_net"][0].grad is None


def test_torch_trunc_exp_clamps_only_its_gradient():
    x = np.array([-40.0, -15.5, -3.0, 0.0, 2.0, 14.0, 16.0, 95.0], np.float32)
    g = np.linspace(0.5, 2.0, x.size).astype(np.float32)
    y_j, vjp = jax.vjp(jmlp.trunc_exp, jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tmlp.trunc_exp(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-6)
    assert np.isinf(y.detach().numpy()[-1]) and np.isfinite(xt.grad.numpy()).all()


@pytest.mark.parametrize("amp", [False, True])
def test_torch_mlp_backward_matches_jax(amp):
    """Autograd through mlp_apply against jax.grad of jnp.dot: fp32 rtol
    1e-5; bf16 (inputs, weights, activations and their cotangents rounded to
    bf16, products in fp32) atol 1e-2 of the largest gradient, for a
    cotangent landing on the other side of a bf16 rounding step."""
    rng = np.random.default_rng(2)
    ws = [rng.normal(size=s).astype(np.float32) * 0.3 for s in ((32, 64), (64, 64), (64, 5))]
    x = rng.normal(size=(300, 32)).astype(np.float32)
    g = rng.normal(size=(300, 5)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if amp else (jnp.float32, torch.float32)
    grads_j = jax.grad(lambda w, xx: jnp.sum(jmlp.mlp_apply(w, xx, "sigmoid", jdt) * g),
                       argnums=(0, 1))([jnp.asarray(w) for w in ws], jnp.asarray(x))
    wt = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    xt = torch.from_numpy(x).requires_grad_(True)
    (tmlp.mlp_apply(wt, xt, "sigmoid", tdt) * torch.from_numpy(g)).sum().backward()
    got = [w.grad for w in wt] + [xt.grad]
    want = list(grads_j[0]) + [grads_j[1]]
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        if amp:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-2 * np.abs(b).max())
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6 * np.abs(b).max())
