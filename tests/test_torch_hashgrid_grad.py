"""Port parity: the table gradient of the hash-grid encode (plain K2) vs
``jax.grad`` of the JAX fast VJP (sort-scatter, bf16 packing off).

Inputs come from numpy and go to both packages.  Kernel K2 is held against
the plain version in tests/test_torch_kernels.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_torch import kernels
from nerfstyle_torch.ops import hashgrid as th

TINY = dict(num_levels=4, level_dim=2, base_resolution=8, per_level_scale=1.5,
            log2_hashmap_size=10)


def _inputs(seed, channels, n=600, simplex_from=-1):
    rng = np.random.default_rng(seed)
    spec = th.hashgrid_spec(**TINY, simplex_from=simplex_from)
    x = rng.uniform(-0.1, 1.1, size=(n, 3)).astype(np.float32)  # some rows outside
    table = rng.uniform(-1, 1, size=(spec.total_params, channels)).astype(np.float32)
    g = rng.normal(size=(n, spec.num_levels * channels)).astype(np.float32)
    return x, table, g


def _jax_grads(x, table, g, simplex_from=-1):
    spec = jh.hashgrid_spec(**TINY, simplex_from=simplex_from)

    def f(emb, pts):
        out = jh.hashgrid_encode(spec, emb, pts, fast_vjp=True, bwd_pack=False)
        return jnp.sum(out * jnp.asarray(g))

    d_emb, d_x = jax.grad(f, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    return np.asarray(d_emb), np.asarray(d_x)


@pytest.mark.parametrize("channels", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_torch_table_grad_matches_jax(seed, channels):
    """Same contributions, summed in another order.  The plain version adds
    each row's contributions in fp32: against float64 sums it holds rtol
    1e-5 (atol 1e-6 of the largest row, for rows that cancel).  The JAX
    backward takes each row's total as a difference of one fp32 running sum
    over all sorted contributions, whose rounding is absolute, up to
    2^-23 * sum|g| of the channel: against JAX, rtol 1e-5 with that atol.
    The points get no gradient."""
    x, table, g = _inputs(seed, channels)
    want_emb, want_x = _jax_grads(x, table, g)
    spec = th.hashgrid_spec(**TINY)
    tab = torch.from_numpy(table).requires_grad_(True)
    pts = torch.from_numpy(x).requires_grad_(True)
    kernels.reset_launch_counts()
    out = th.hashgrid_encode(spec, tab, pts)
    out.backward(torch.from_numpy(g))
    assert all(v == 0 for v in kernels.launch_counts.values())
    assert pts.grad is None and not np.any(want_x)
    got = tab.grad.numpy()
    assert (got != 0).any() and (got == 0).any()  # touched and untouched rows
    exact = th.hashgrid_backward_plain(spec, pts.detach(), torch.from_numpy(g).double(),
                                       spec.total_params).numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-6 * np.abs(exact).max())
    cumsum_atol = 2.0**-23 * np.abs(g).reshape(len(g), -1, channels).sum(axis=(0, 1))
    np.testing.assert_allclose(got, want_emb, rtol=1e-5, atol=cumsum_atol.max())
    assert cumsum_atol.max() < 1e-3 * np.abs(exact).max()  # the atol stays small


@pytest.mark.parametrize("simplex_from", [0, 2, 4])
def test_torch_simplex_table_grad_matches_jax(simplex_from):
    """Simplex levels from 0 (all), 2, and past the last level: the table
    gradient against the JAX fast VJP's within 1e-5 relative L2 (the same
    contributions summed in another order)."""
    x, table, g = _inputs(3 + simplex_from, 4, simplex_from=simplex_from)
    want, _ = _jax_grads(x, table, g, simplex_from)
    spec = th.hashgrid_spec(**TINY, simplex_from=simplex_from)
    tab = torch.from_numpy(table).requires_grad_(True)
    th.hashgrid_encode(spec, tab, torch.from_numpy(x)).backward(torch.from_numpy(g))
    got = tab.grad.numpy().astype(np.float64)
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_torch_table_grad_plain_is_the_scatter_of_weighted_cotangents():
    """The plain backward adds w * g of every in-range corner into its row:
    for one point inside one cell the rows receive the trilinear weights."""
    spec = th.hashgrid_spec(num_levels=1, level_dim=1, base_resolution=4, per_level_scale=2.0,
                            log2_hashmap_size=10)
    x = torch.tensor([[0.3, 0.6, 0.1], [1.5, 0.5, 0.5]])  # the second is outside
    g = torch.tensor([[2.0], [7.0]])
    grad = th.hashgrid_backward_plain(spec, x, g, spec.total_params)
    assert torch.isclose(grad.sum(), torch.tensor(2.0))  # trilinear weights sum to 1
    assert int((grad != 0).sum()) <= 8
