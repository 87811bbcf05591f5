"""Port parity: MLP heads and the style field's density and color halves vs
the JAX package, with JAX-initialized weights carried over by
``params_from_numpy``.
"""

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

GRID = dict(num_levels=4, level_dim=2, base_resolution=8, per_level_scale=1.5,
            log2_hashmap_size=10)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: reduction order only.  bf16: a hidden activation may round to the
# neighbouring bf16 value (2^-8 relative) when the fp32 sums differ in order.
TOL = {"fp32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=0, atol=1e-3)}


@pytest.fixture(scope="module")
def fields():
    spec_j = jf.style_field_spec(jh.hashgrid_spec(**GRID), class_dim=3)
    spec_t = tf.style_field_spec(th.hashgrid_spec(**GRID), class_dim=3)
    params_j = jf.field_init(jax.random.PRNGKey(0), spec_j)
    # Tables at init are ~1e-4: widen them so the features carry signal.
    rng = np.random.default_rng(0)
    for k in ("x_density_embedder", "x_color_embedder"):
        params_j[k] = jnp.asarray(rng.uniform(-1, 1, params_j[k].shape).astype(np.float32))
    tree = jax.tree_util.tree_map(np.asarray, params_j)
    return spec_j, spec_t, params_j, tf.params_from_numpy(tree)


def _pts(seed, n=500):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_torch_mlp_apply_matches_jax(dtype):
    rng = np.random.default_rng(1)
    ws = [rng.uniform(-0.5, 0.5, s).astype(np.float32) for s in ((32, 64), (64, 64), (64, 3))]
    x = rng.normal(size=(300, 32)).astype(np.float32)
    jd, td = DTYPES[dtype]
    want = jmlp.mlp_apply([jnp.asarray(w) for w in ws], jnp.asarray(x), "sigmoid", jd)
    got = tmlp.mlp_apply([torch.from_numpy(w) for w in ws], torch.from_numpy(x), "sigmoid", td)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_torch_field_density_matches_jax(fields, dtype):
    spec_j, spec_t, params_j, params_t = fields
    jd, td = DTYPES[dtype]
    pts = _pts(2)
    want = jf.field_density(spec_j, params_j, JBBox.from_radius(1.0), jnp.asarray(pts),
                            compute_dtype=jd, use_dedup=False)
    got = tf.field_density(spec_t, params_t, BBox.from_radius(1.0), torch.from_numpy(pts), td)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_torch_field_color_matches_jax(fields, dtype):
    spec_j, spec_t, params_j, params_t = fields
    jd, td = DTYPES[dtype]
    pts = _pts(3)
    want = jf.field_color(spec_j, params_j, JBBox.from_radius(1.0), jnp.asarray(pts),
                          compute_dtype=jd)
    got = tf.field_color(spec_t, params_t, BBox.from_radius(1.0), torch.from_numpy(pts), td)
    assert got.shape == (pts.shape[0], 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])


def test_torch_params_round_trip_and_layout(fields):
    spec_j, spec_t, params_j, params_t = fields
    back = tf.params_to_numpy(params_t)
    for k, v in params_j.items():
        if isinstance(v, list):
            assert len(back[k]) == len(v)
            for a, b in zip(v, back[k]):
                np.testing.assert_array_equal(np.asarray(a), b)
        else:
            np.testing.assert_array_equal(np.asarray(v), back[k])
    # The port's own init has the JAX shapes under the JAX keys.
    mine = tf.field_init(spec_t, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params_j)
    assert {k: ([tuple(w.shape) for w in v] if isinstance(v, list) else tuple(v.shape))
            for k, v in mine.items()} == shapes
    assert float(mine["x_density_embedder"].abs().max()) <= 1e-4


def test_torch_encoder_input_quirk():
    pts = torch.tensor([[-1.0, 0.0, 1.0]])
    x = tf._encoder_input(BBox.from_radius(1.0), pts)
    assert x.tolist() == [[0.5, 0.75, 1.0]]
