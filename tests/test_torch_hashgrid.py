"""Port parity: hash-grid spec laws and encode (plain K1) vs the JAX package.

Inputs come from numpy and go to both packages.  The CUDA kernel is held
against the plain version in tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.models.fields import make_grid_spec as jax_make_grid_spec
from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_torch import kernels
from nerfstyle_torch.models.fields import make_grid_spec
from nerfstyle_torch.ops import hashgrid as th

TINY = dict(num_levels=4, level_dim=2, base_resolution=16, per_level_scale=1.5,
            log2_hashmap_size=10)


def _points(rng, n):
    # 10% margin outside [0, 1] on each side: exercises the zero rows.
    return rng.uniform(-0.1, 1.1, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("kw", [TINY, {}, dict(num_levels=8, log2_hashmap_size=12,
                                                 desired_resolution=512)])
def test_torch_spec_laws_match_jax(kw):
    a, b = jh.hashgrid_spec(**kw), th.hashgrid_spec(**kw)
    assert a.resolutions == b.resolutions
    assert a.table_sizes == b.table_sizes
    assert a.offsets == b.offsets
    assert a.output_dim == b.output_dim


def test_torch_default_network_grid_matches_jax():
    """The default network config at bound 2 (16 levels, 2^19, 4096 finest)."""
    args = dict(n_lvls=16, n_feats_per_lvl=2, hashmap_size=19, min_res=16,
                max_res_coeff=1024, max_bound=4.0)
    a, b = jax_make_grid_spec(**args), make_grid_spec(**args)
    assert (a.resolutions, a.table_sizes, a.offsets) == (b.resolutions, b.table_sizes, b.offsets)
    assert b.total_params == 6_299_960 and b.resolutions[-1] == 4096


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_torch_encode_plain_matches_jax(channels):
    rng = np.random.default_rng(channels)
    spec_j, spec_t = jh.hashgrid_spec(**TINY), th.hashgrid_spec(**TINY)
    x = _points(rng, 777)
    table = rng.uniform(-1, 1, size=(spec_j.total_params, channels)).astype(np.float32)
    want = np.asarray(jh.hashgrid_encode(spec_j, jnp.asarray(table), jnp.asarray(x), fast_vjp=True))
    got = th.hashgrid_encode(spec_t, torch.from_numpy(table), torch.from_numpy(x)).numpy()
    oob = np.any((x < 0) | (x > 1), axis=-1)
    assert oob.any() and not oob.all()
    assert np.all(got[oob] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_torch_encode_on_cpu_launches_no_kernel():
    spec = th.hashgrid_spec(**TINY)
    kernels.reset_launch_counts()
    out = th.hashgrid_encode(spec, torch.zeros(spec.total_params, 2), torch.rand(5, 3))
    assert out.shape == (5, spec.output_dim)
    assert kernels.launch_counts["hashgrid_encode"] == 0


def test_torch_simplex_levels_not_ported():
    """Simplex levels encode on the CPU through the plain version (no
    kernel launch), and only they differ from the trilinear encode.  (The
    name is kept from when the port raised on simplex levels, so that test
    histories stay comparable.)"""
    spec = th.hashgrid_spec(**TINY, simplex_from=2)
    tri = th.hashgrid_spec(**TINY)
    table, x = torch.rand(spec.total_params, 2), torch.rand(5, 3)
    kernels.reset_launch_counts()
    out = th.hashgrid_encode(spec, table, x).reshape(5, 4, 2)
    assert not any(kernels.launch_counts.values())
    want = th.hashgrid_encode(tri, table, x).reshape(5, 4, 2)
    assert torch.equal(out[:, :2], want[:, :2]) and not torch.equal(out[:, 2:], want[:, 2:])


@pytest.mark.parametrize("simplex_from", [0, 2, 4, 9])
@pytest.mark.parametrize("channels", [2, 4])
def test_torch_simplex_encode_plain_matches_jax(simplex_from, channels):
    """Simplex levels from 0 (all), 2, and past the last level (4, 9: all
    trilinear) against the JAX fast encode: within 1e-6 of the largest."""
    rng = np.random.default_rng(10 * simplex_from + channels)
    spec_j = jh.hashgrid_spec(**TINY, simplex_from=simplex_from)
    spec_t = th.hashgrid_spec(**TINY, simplex_from=simplex_from)
    assert spec_t.simplex_start == spec_j.simplex_start
    x = _points(rng, 777)
    x[:5] = np.array([[0.5, 0.5, 0.5], [0.25, 0.25, 0.75], [0.1, 0.3, 0.3], [1.0, 0.0, 1.0],
                      [0.3, 0.3, 0.1]], np.float32)  # tied fractions
    table = rng.uniform(-1, 1, size=(spec_j.total_params, channels)).astype(np.float32)
    want = np.asarray(jh.hashgrid_encode(spec_j, jnp.asarray(table), jnp.asarray(x)))
    got = th.hashgrid_encode(spec_t, torch.from_numpy(table), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_torch_simplex_weights_are_barycentric():
    """Each simplex level's 4 weights are >= 0 and sum to 1, and the field
    equals the table row at a lattice vertex."""
    spec = th.hashgrid_spec(**TINY, simplex_from=0)
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (500, 3)).astype(np.float32))
    corners, _ = th._corners(spec, x)
    assert len(corners) == 4
    w = torch.stack([c[3] for c in corners])
    assert bool((w >= -1e-7).all())
    torch.testing.assert_close(w.sum(0), torch.ones_like(w[0]), rtol=0, atol=1e-6)
    table = torch.rand(spec.total_params, 1)
    vertex = torch.tensor([[2.0, 5.0, 7.0]]) / spec.resolutions[0]
    out = th.hashgrid_encode(spec, table, vertex)
    row = th._corners(spec, vertex)[0][0][2][0, 0]  # vertex 0: the cell's floor corner
    assert torch.isclose(out[0, 0], table[row, 0], rtol=0, atol=1e-6)


def test_torch_level_table_layout():
    spec = th.hashgrid_spec(**TINY, simplex_from=1)
    lv = th.level_table(spec, torch.device("cpu"))
    assert lv.dtype == torch.int32 and lv.shape == (4, 4)
    assert lv[0].tolist() == list(spec.resolutions)
    assert lv[1].tolist() == list(spec.table_sizes)
    assert lv[2].tolist() == list(spec.offsets[:-1])
    assert lv[3].tolist() == [0, 1, 1, 1]

