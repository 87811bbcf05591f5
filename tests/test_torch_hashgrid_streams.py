"""Port parity on the streams the hash-grid kernels K1 and K2 run on.

K1 (encode) and K2 (table gradient) take 32 consecutive points a warp and
rely on two facts, held here against the JAX package on the CPU:

* corners s and s|1 of a trilinear cell differ only in x, whose prime is
  1: when the cell's integer x is even their rows are r and r ^ 1 (every
  table size and row offset is even), one aligned pair that one vector
  load reads;
* marched streams are ray-major and t-ordered: neighbouring points share
  cells, so many lanes of a warp read and add into one row.  The plain
  versions (the kernels' reference) agree with JAX's encode and VJP there.

The kernels themselves are held against the plain versions on such streams
in tests/test_torch_kernels.py (on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_tpu.models.fields import make_grid_spec as jax_make_grid_spec
from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_torch import kernels
from nerfstyle_torch.models.fields import make_grid_spec
from nerfstyle_torch.ops import hashgrid as th

DEFAULT = dict(n_lvls=16, n_feats_per_lvl=2, hashmap_size=19, min_res=16, max_res_coeff=1024)
GRIDS = {  # the default network grid at bound 1 and 2 (bbox sizes 2 and 4); a simplex one
    "bound 1": dict(DEFAULT, max_bound=2.0),
    "bound 2": dict(DEFAULT, max_bound=4.0),
    "bound 2, simplex from 10": dict(DEFAULT, max_bound=4.0, simplex_from=10),
}
SMALL = dict(num_levels=4, level_dim=2, base_resolution=16, per_level_scale=1.5,
             log2_hashmap_size=10)


def _cells_with_even_x(rng, res, n=256):
    """n points whose level-res cell has an even integer x, as float32."""
    pg = rng.integers(0, res, size=(n, 3))
    pg[:, 0] -= pg[:, 0] % 2
    return ((pg + rng.uniform(0.05, 0.95, size=(n, 3))) / res).astype(np.float32)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_torch_corner_pairs_are_aligned_row_pairs(grid):
    """On every level, for cells with even integer x, JAX's corner rows
    (``_flat_corners``, column l*8 + s) satisfy row(s|1) == row(s) ^ 1 for
    the four x-pairs; on simplex levels the same holds for consecutive
    vertices v, v+1 that differ in x.  The port's rows (``_corners`` via
    ``_rows``) are JAX's."""
    spec_j, spec_t = jax_make_grid_spec(**GRIDS[grid]), make_grid_spec(**GRIDS[grid])
    assert all(s % 8 == 0 for s in spec_t.table_sizes)
    rng = np.random.default_rng(len(grid))
    lc, nl = spec_t.simplex_start, spec_t.num_levels
    pairs_seen = 0
    for lvl in range(nl):
        res = spec_t.resolutions[lvl]
        x = _cells_with_even_x(rng, res)
        pg, frac = th._cells(spec_t, torch.from_numpy(x), lvl, lvl + 1)
        assert bool((pg[:, 0, 0] % 2 == 0).all())
        rows8, _, rows4, _, oob = (np.asarray(a) for a in jh._flat_corners(spec_j, 0,
                                                                           jnp.asarray(x)))
        assert not oob.any()
        corners, _ = th._corners(spec_t, torch.from_numpy(x))
        if lvl < lc:
            jr = rows8[:, 8 * lvl: 8 * lvl + 8]
            port = np.stack([corners[s][2][:, lvl].numpy() for s in range(8)], axis=1)
            for s in (0, 2, 4, 6):
                assert np.array_equal(jr[:, s + 1], jr[:, s] ^ 1)
                pairs_seen += x.shape[0]
        else:
            jr = rows4[:, 4 * (lvl - lc): 4 * (lvl - lc) + 4]
            port = np.stack([corners[8 * (lc > 0) + v][2][:, lvl - lc].numpy()
                             for v in range(4)], axis=1)
            fx, fy, fz = frac[:, 0].unbind(-1)
            rank_x = ((fy > fx).long() + (fz > fx).long()).numpy()  # x joins at vertex rank_x + 1
            for v in range(3):
                on_x = rank_x == v
                assert np.array_equal(jr[on_x, v + 1], jr[on_x, v] ^ 1)
                pairs_seen += int(on_x.sum())
        assert np.array_equal(port, jr)
    assert pairs_seen >= 4 * 256 * lc


def _ray_stream(rng):
    """Points t-ordered along neighbouring rays, as a marcher hands them
    over: 12 rays of 240 samples (dt ~ 1/300 of the cube) entering the unit
    cube mid-stream, then 300 samples that stay in one level-0 cell."""
    o = np.array([-0.1, 0.05, 0.1]) + rng.uniform(0, 0.02, size=(12, 1, 3))
    d = np.array([0.45, 0.4, 0.35]) + rng.uniform(0, 0.02, size=(12, 1, 3))
    t = np.arange(240)[None, :, None] * 0.006
    rays = (o + t * d).reshape(-1, 3)
    stay = np.array([0.53, 0.47, 0.51]) + np.arange(300)[:, None] * np.array([1e-5, 2e-5, 0.0])
    return np.concatenate([rays, stay]).astype(np.float32)


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("simplex_from", [-1, 2])
@pytest.mark.parametrize("channels", [2, 4])
def test_torch_encode_and_table_grad_match_jax_on_a_ray_stream(channels, simplex_from, dedup):
    """A ray-ordered, contended stream (long runs of one level-0 cell, rays
    entering [0, 1]^3 mid-stream) through JAX's ``hashgrid_encode`` and its
    VJP (with and without JAX's ray-coherent corner dedup on levels 0-1) and
    through the port's plain versions.  Tolerances as in
    tests/test_torch_hashgrid.py and tests/test_torch_hashgrid_grad.py: the
    encode rtol 1e-5, atol 1e-7; the table gradient against float64 sums
    rtol 1e-5, atol 1e-6 of the largest row, and against JAX rtol 1e-5 with
    the atol of JAX's running fp32 sum (2^-23 sum |g| of a channel)."""
    import jax

    rng = np.random.default_rng(channels + simplex_from)
    spec_j = jh.hashgrid_spec(**SMALL, simplex_from=simplex_from)
    spec_t = th.hashgrid_spec(**SMALL, simplex_from=simplex_from)
    x = _ray_stream(rng)
    oob = np.any((x < 0) | (x > 1), axis=-1)
    assert oob.any() and not oob.all()
    table = rng.uniform(-1, 1, size=(spec_t.total_params, channels)).astype(np.float32)
    g = rng.normal(size=(x.shape[0], spec_t.num_levels * channels)).astype(np.float32)
    plan = jh.DedupPlan(groups=((0, 1),), cap_fracs=(1.0,)) if dedup else None

    def f(emb):
        out = jh.hashgrid_encode(spec_j, emb, jnp.asarray(x), fast_vjp=True, dedup=plan)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), want_emb = jax.value_and_grad(f, has_aux=True)(jnp.asarray(table))
    tab = torch.from_numpy(table).requires_grad_(True)
    kernels.reset_launch_counts()
    out = th.hashgrid_encode(spec_t, tab, torch.from_numpy(x))
    out.backward(torch.from_numpy(g))
    assert not any(kernels.launch_counts.values())
    got = out.detach().numpy()
    assert np.all(got[oob] == 0.0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)
    exact = th.hashgrid_backward_plain(spec_t, torch.from_numpy(x), torch.from_numpy(g).double(),
                                       spec_t.total_params).numpy()
    grad = tab.grad.numpy()
    np.testing.assert_allclose(grad, exact, rtol=1e-5, atol=1e-6 * np.abs(exact).max())
    cumsum_atol = 2.0**-23 * np.abs(g).reshape(len(g), -1, channels).sum(axis=(0, 1))
    np.testing.assert_allclose(grad, np.asarray(want_emb), rtol=1e-5, atol=cumsum_atol.max())
    assert cumsum_atol.max() < 1e-3 * np.abs(exact).max()
