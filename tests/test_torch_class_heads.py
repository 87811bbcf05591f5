"""Class heads of every width: none (a dataset without segment maps) and
wider than K5's 64 outputs.

On the CPU: the port's field at ``class_dim 0`` against the JAX package's
``field_apply`` and ``field_color`` and their gradients (JAX's ``mlp_apply``
with a [64, 0] last layer: [M, 0] logits, zero gradients); the plain K7 and
K7b at 3 + 70 channels against ``jax.ops.segment_sum`` and its VJP; and the
CUDA branch of ``mlp_apply`` with the kernel picked and K5 replaced by its
plain version: no launch at width 0, one launch a 64-column slice above 64.
The kernels meet widths 0 and 70 in ``tests/test_torch_kernels.py`` on the
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_torch import kernels
from nerfstyle_torch.core.types import BBox
from nerfstyle_torch.models import fields as tf
from nerfstyle_torch.ops import compositing as tc
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_torch.ops import mlp as tmlp
from nerfstyle_torch.training.checkpoint import tree_flatten
from nerfstyle_tpu.core.types import BBox as JBBox
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.ops import hashgrid as jh

GRID = dict(num_levels=4, level_dim=2, base_resolution=8, per_level_scale=1.5,
            log2_hashmap_size=10)


@pytest.fixture(scope="module")
def field0():
    spec_j = jf.style_field_spec(jh.hashgrid_spec(**GRID), class_dim=0)
    spec_t = tf.style_field_spec(th.hashgrid_spec(**GRID), class_dim=0)
    params_j = jf.field_init(jax.random.PRNGKey(3), spec_j)
    rng = np.random.default_rng(3)
    for k in ("x_density_embedder", "x_color_embedder"):  # widen the +-1e-4 init
        params_j[k] = jnp.asarray(rng.uniform(-1, 1, params_j[k].shape).astype(np.float32))
    tree = jax.tree_util.tree_map(np.asarray, params_j)
    pts = rng.uniform(-1.1, 1.1, size=(600, 3)).astype(np.float32)
    dirs = rng.normal(size=(600, 3)).astype(np.float32)
    g_ch = rng.normal(size=(600, 3)).astype(np.float32)
    g_sig = rng.normal(size=(600,)).astype(np.float32) * 0.1
    return spec_j, spec_t, params_j, tree, pts, dirs, g_ch, g_sig


def _grads(params, loss):
    leaves = tree_flatten(params)
    return [torch.zeros_like(w) if g is None else g
            for w, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]


def _close_leaves(got, want, what):
    """Each leaf: shape equal, rtol 1e-4 with atol 1e-5 of its largest (the
    tolerances of tests/test_torch_field_grad.py); a zero leaf exactly."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, f"{what} leaf {i}"
        atol = 1e-5 * np.abs(w).max() if w.size else 0.0
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4, atol=atol,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("branch", ["field_apply", "field_color"])
def test_torch_field_without_classes_matches_jax(field0, branch):
    """class_dim 0: the channels are rgb alone, and the class head's
    gradients are zeros (its last layer's of size 0), as in JAX; the other
    leaves' as for a field with classes.  fp32: outputs rtol 1e-5."""
    spec_j, spec_t, params_j, tree, pts, dirs, g_ch, g_sig = field0
    bb_j, bb_t = JBBox.from_radius(1.0), BBox.from_radius(1.0)
    apply = branch == "field_apply"

    def f(p):
        if apply:
            ch, sig = jf.field_apply(spec_j, p, bb_j, jnp.asarray(pts), jnp.asarray(dirs))
            return jnp.sum(ch * g_ch) + jnp.sum(sig * g_sig), ch
        ch = jf.field_color(spec_j, p, bb_j, jnp.asarray(pts))
        return jnp.sum(ch * g_ch), ch

    (_, ch_j), grads_j = jax.value_and_grad(f, has_aux=True)(params_j)
    assert ch_j.shape == (pts.shape[0], 3)
    params = tf.params_from_numpy(tree)
    for w in tree_flatten(params):
        w.requires_grad_(True)
    x = torch.from_numpy(pts)
    if apply:
        ch, sig = tf.field_apply(spec_t, params, bb_t, x)
        loss = (ch * torch.from_numpy(g_ch)).sum() + (sig * torch.from_numpy(g_sig)).sum()
    else:
        ch = tf.field_color(spec_t, params, bb_t, x)
        loss = (ch * torch.from_numpy(g_ch)).sum()
    np.testing.assert_allclose(ch.detach().numpy(), np.asarray(ch_j), rtol=1e-5, atol=1e-6)
    got = _grads(params, loss)
    _close_leaves(got, jax.tree_util.tree_leaves(grads_j), branch)
    class_grads = [g for (k, _, _), g in zip(_named_leaves(params), got) if k == "class_net"]
    assert [tuple(g.shape) for g in class_grads][-1] == (64, 0)
    assert not any(bool(g.any()) for g in class_grads)


def _named_leaves(params):
    return [(k, i, w) for k in sorted(params)
            for i, w in enumerate(params[k] if isinstance(params[k], list) else [params[k]])]


def test_torch_segment_sum_at_73_channels_matches_jax():
    """K7 and K7b's plain versions at 3 + 70 channels (a 70-class head):
    the sum against jax.ops.segment_sum (float64 against fp32 sums: rtol
    1e-5), d ch bit for bit against its VJP, d w within 1e-6 of the
    largest (C products summed in another order)."""
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 40, size=300)
    counts[[0, 7, 8]] = 0
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    s, c = int(offsets[-1]), 73
    w = rng.uniform(0, 1, size=s).astype(np.float32)
    ch = rng.normal(size=(s, c)).astype(np.float32)
    g = rng.normal(size=(counts.shape[0], c)).astype(np.float32)
    rid = jnp.asarray(np.repeat(np.arange(counts.shape[0]), counts))
    out_j, vjp = jax.vjp(lambda ww, cc: jax.ops.segment_sum(ww[:, None] * cc, rid,
                                                            num_segments=counts.shape[0]),
                         jnp.asarray(w), jnp.asarray(ch))
    d_w_j, d_ch_j = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    wt, cht, gt, ot = (torch.from_numpy(a) for a in (w, ch, g, offsets))
    out = tc.segment_sum(wt, cht, ot)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(out_j)).max())
    d_ch, d_w = tc.segment_sum_backward_plain(wt, cht, gt, ot, need_dw=True)
    np.testing.assert_array_equal(d_ch.numpy(), d_ch_j)
    np.testing.assert_allclose(d_w.numpy(), d_w_j, rtol=0, atol=1e-6 * np.abs(d_w_j).max())


@pytest.fixture
def k5_on_the_cpu(monkeypatch):
    """mlp_apply's CUDA branch on CPU tensors: the kernel picked, and K5's
    wrappers replaced by the plain chain (forward) and its autograd
    (backward), each call recorded with its output width."""
    calls = []

    def dtype(bf16):
        return torch.bfloat16 if bf16 else torch.float32

    def forward(x, weights, sigmoid, bf16):
        calls.append(("forward", weights[-1].shape[1]))
        return tmlp.mlp_apply_plain(weights, x, "sigmoid" if sigmoid else None, dtype(bf16))

    def backward(x, weights, g, sigmoid, bf16, need_dw):
        calls.append(("backward", weights[-1].shape[1]))
        with torch.enable_grad():
            xs = x.detach().requires_grad_(True)
            ws = [w.detach().requires_grad_(True) for w in weights]
            out = tmlp.mlp_apply_plain(ws, xs, "sigmoid" if sigmoid else None, dtype(bf16))
            grads = torch.autograd.grad(out, [xs, *ws], g)
        return grads[0], [gw if need else None for gw, need in zip(grads[1:], need_dw)]

    monkeypatch.setattr(tmlp, "use_kernel", lambda t, plain=False: not plain)
    monkeypatch.setattr(kernels, "mlp_forward", forward)
    monkeypatch.setattr(kernels, "mlp_backward", backward)
    return calls


@pytest.mark.parametrize("out_dim", [0, 64, 70, 130])
def test_torch_mlp_apply_splits_heads_wider_than_k5(k5_on_the_cpu, out_dim):
    """Width 0: [M, 0], no launch, zero weight gradients.  Above 64 outputs:
    one K5 call a slice of at most 64 last-layer columns, forward and
    backward, equal to the whole chain (the hidden layers' d W summed over
    the slices: rtol 1e-5)."""
    rng = np.random.default_rng(out_dim)
    dims = [32, 64, out_dim]
    ws = [torch.from_numpy(rng.uniform(-1, 1, size=(a, b)).astype(np.float32) * 0.3)
          .requires_grad_(True) for a, b in zip(dims[:-1], dims[1:])]
    x = torch.from_numpy(rng.normal(size=(200, 32)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(200, out_dim)).astype(np.float32))
    out = tmlp.mlp_apply(ws, x)
    assert out.shape == (200, out_dim)
    grads = torch.autograd.grad((out * g).sum(), [x, *ws], allow_unused=True)
    slices = -(-out_dim // kernels.MLP_MAX_OUT)
    widths = [min(kernels.MLP_MAX_OUT, out_dim - kernels.MLP_MAX_OUT * i) for i in range(slices)]
    assert [c for c in k5_on_the_cpu if c[0] == "forward"] == [("forward", n) for n in widths]
    assert sorted(c for c in k5_on_the_cpu if c[0] == "backward") == [("backward", n)
                                                                       for n in sorted(widths)]
    ref = tmlp.mlp_apply(ws, x, plain=True)
    want = torch.autograd.grad((ref * g).sum(), [x, *ws], allow_unused=True)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    if out_dim == 0:
        assert grads[0] is None and all(not bool(gw.any()) for gw in grads[1:])
        assert [gw.shape for gw in grads[1:]] == [w.shape for w in ws]
        return
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
