"""Port parity: occupancy-grid maintenance (plain K6, K6c) vs the JAX
package — the probe scatter-max and the merge/threshold on the same probes,
the skip distance (on its own, after a merge and after a restore), the full
sweep with the same jitter, the random update's draw of occupied cells, the
running mean of marched samples, and the five checkpoint leaves.  Kernels
K6 and K6c are held against the plain versions in tests/test_torch_kernels.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.core.types import BBox as JBBox
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_tpu.ops import occupancy as jo
from nerfstyle_torch import kernels
from nerfstyle_torch.core.types import BBox
from nerfstyle_torch.models import fields as tf
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_torch.ops import occupancy as to

H = 16
CASCADE = 2
N = H**3
GRID = dict(num_levels=4, level_dim=2, base_resolution=8, per_level_scale=1.5,
            log2_hashmap_size=10)


def _grids(seed):
    rng = np.random.default_rng(seed)
    grid = rng.exponential(1.0, size=(CASCADE, N)).astype(np.float32)
    grid[rng.random(grid.shape) < 0.3] = 0.0
    grid[rng.random(grid.shape) < 0.05] = -1.0  # never-sampled cells are left alone
    idx = rng.integers(0, N, size=(CASCADE, N // 2))  # with repeats
    sig = rng.exponential(2.0, size=(CASCADE, N // 2)).astype(np.float32)
    return grid, idx, sig


def _jax_state(grid):
    n = grid.shape[1]
    return jo.OccupancyState(
        density_grid=jnp.asarray(grid), bitfield=jnp.zeros((grid.size,), bool),
        skipdist=jnp.zeros((grid.size,), jnp.uint8), mean_density=jnp.float32(0),
        mean_count=jnp.int32(0), local_step=jnp.int32(0),
    ), n


def _port_state(grid):
    return to.occupancy_init(CASCADE, H)._replace(density_grid=torch.from_numpy(grid.copy()))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("thresh", [10.0, 0.5])
def test_torch_scatter_max_and_merge_match_jax(seed, thresh):
    """Same probes: the max and the merge are exact, so grid and bitfield
    are equal; the mean is summed in float64 (JAX: fp32), within 1e-6
    relative.  ``thresh`` 10 thresholds at the mean, 0.5 at itself."""
    grid, idx, sig = _grids(seed)
    js, _ = _jax_state(grid)
    tmp_j = -jnp.ones_like(js.density_grid)
    for cas in range(CASCADE):
        tmp_j = tmp_j.at[cas, jnp.asarray(idx[cas])].max(jnp.asarray(sig[cas]))
    want = jo._merge_and_threshold(js, tmp_j, 0.95, thresh)

    tmp = torch.full((CASCADE * N,), -1.0)
    flat = torch.from_numpy(idx + np.arange(CASCADE)[:, None] * N).reshape(-1)
    kernels.reset_launch_counts()
    to.scatter_max(tmp, flat, torch.from_numpy(sig).reshape(-1))
    np.testing.assert_array_equal(tmp.numpy().reshape(CASCADE, N), np.asarray(tmp_j))
    got = to.merge_and_threshold(_port_state(grid), tmp.reshape(CASCADE, N), 0.95, thresh,
                                 grid_size=H)
    assert all(v == 0 for v in kernels.launch_counts.values())
    np.testing.assert_array_equal(got.density_grid.numpy(), np.asarray(want.density_grid))
    np.testing.assert_array_equal(got.bitfield.numpy(), np.asarray(want.bitfield))
    np.testing.assert_array_equal(got.skipdist.numpy(), np.asarray(want.skipdist))
    np.testing.assert_allclose(float(got.mean_density), float(want.mean_density), rtol=1e-6)
    assert 0 < int(got.bitfield.sum()) < got.bitfield.numel()


@pytest.mark.parametrize("cascade,density", [(1, 0.002), (1, 0.3), (2, 0.0005), (2, 0.05),
                                             (2, 0.0)])
def test_torch_skipdist_plain_matches_jax(cascade, density):
    """The plain skip distance equals JAX's iterated dilation, cell for
    cell, on random grids of 1 and 2 cascades: sparse ones (distances up to
    the cap), a dense one, and an empty one (every cell at the cap)."""
    bits = np.random.default_rng(int(density * 1e4) + cascade).random(cascade * N) < density
    want = np.asarray(jo.skipdist_from_bitfield(jnp.asarray(bits), H))
    got = to.skipdist_from_bitfield(torch.from_numpy(bits), H)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).sum() == bits.sum()
    if density == 0.0:
        assert np.all(want == to.SKIP_DMAX)


def test_torch_skipdist_is_the_capped_linf_distance():
    """On one cascade with two occupied cells: the L-inf distance to the
    nearer, within the cascade (no wrap), capped at SKIP_DMAX."""
    h = 32
    bits = torch.zeros(2 * h**3, dtype=torch.bool)
    cells = [(3, 4, 5), (30, 31, 2)]
    for c in cells:
        bits[(c[0] * h + c[1]) * h + c[2]] = True
    dist = to.skipdist_from_bitfield(bits, h).reshape(2, h, h, h)
    g = torch.stack(torch.meshgrid(*[torch.arange(h)] * 3, indexing="ij"), -1)
    linf = torch.stack([(g - torch.tensor(c)).abs().amax(-1) for c in cells]).amin(0)
    assert torch.equal(dist[0].long(), linf.clamp(max=to.SKIP_DMAX))
    assert bool((dist[1] == to.SKIP_DMAX).all())  # the other cascade is empty


def test_torch_restore_rebuilds_skipdist_and_keeps_five_leaves(tmp_path):
    """A checkpoint holds the five persisted leaves in JAX order; restoring
    them in either package rebuilds the same skip distance."""
    from nerfstyle_tpu.training import checkpoint as jckpt
    from nerfstyle_torch.training import checkpoint as tckpt

    grid, _, _ = _grids(4)
    state = to.merge_and_threshold(_port_state(grid), torch.full((CASCADE, N), -1.0), 0.95, 0.5,
                                   grid_size=H)
    persisted = to.occupancy_persistable(state)
    assert len(persisted) == 5 and isinstance(persisted, to.PersistedOccupancy)
    path = tmp_path / "occ.ckpt"
    tckpt.save_checkpoint(path, {}, {"occ": persisted})
    _, groups = tckpt.load_checkpoint(path)
    assert len(groups["occ"]) == 5
    template = to.occupancy_persistable(to.occupancy_init(CASCADE, H))
    back = to.occupancy_restore(tckpt.restore_tree(template, groups["occ"]), H)
    for a, b in zip(back, state):
        assert torch.equal(a, b) and a.dtype == b.dtype
    _, jgroups = jckpt.load_checkpoint(path)
    js = jo.occupancy_restore(jckpt.restore_tree(
        jo.occupancy_persistable(jo.occupancy_init(CASCADE, H)), jgroups["occ"]), H)
    np.testing.assert_array_equal(np.asarray(js.skipdist), back.skipdist.numpy())
    assert 0 < int((back.skipdist == 0).sum()) < CASCADE * N


@pytest.fixture(scope="module")
def field():
    spec_j = jf.style_field_spec(jh.hashgrid_spec(**GRID), class_dim=2)
    spec_t = tf.style_field_spec(th.hashgrid_spec(**GRID), class_dim=2)
    params_j = jf.field_init(jax.random.PRNGKey(3), spec_j)
    rng = np.random.default_rng(3)
    for k in ("x_density_embedder", "x_color_embedder"):  # widen the ±1e-4 init
        params_j[k] = jnp.asarray(rng.uniform(-1, 1, params_j[k].shape).astype(np.float32))
    params_t = tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j))
    return spec_j, spec_t, params_j, params_t


def test_torch_full_sweep_matches_jax_with_the_same_jitter(field):
    """The JAX jitter (from its key) handed to the port: the probe densities
    agree to the MLP's reassociation (rtol 1e-5), so the grid does; a cell
    within that rounding of the threshold may flip: at most 0.1% of cells."""
    spec_j, spec_t, params_j, params_t = field
    bound = 2.0
    grid = np.zeros((CASCADE, N), np.float32)
    grid[:, ::3] = 0.7
    js, _ = _jax_state(grid)
    key = jax.random.PRNGKey(11)
    kw = dict(bound=bound, density_scale=1.0, density_decay=0.95, density_thresh=10.0)
    bb_j = JBBox.from_radius(bound)
    want = jo.occupancy_update_full(
        js, lambda p: jf.field_density(spec_j, params_j, bb_j, p), key, **kw)
    jitter = np.stack([np.asarray(jax.random.uniform(k, (N, 3), jnp.float32, -1.0, 1.0))
                       for k in jax.random.split(key, CASCADE)])
    bb_t = BBox.from_radius(bound)
    got = to.occupancy_update_full(
        _port_state(grid), lambda p: tf.field_density(spec_t, params_t, bb_t, p),
        jitter=torch.from_numpy(jitter), chunk=1000, **kw)
    np.testing.assert_allclose(got.density_grid.numpy(), np.asarray(want.density_grid),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got.mean_density), float(want.mean_density), rtol=1e-5)
    flips = int((got.bitfield.numpy() != np.asarray(want.bitfield)).sum())
    assert flips <= 0.001 * CASCADE * N
    assert 0 < int(got.bitfield.sum()) < CASCADE * N


def test_torch_cells_to_cascade_points_match_jax():
    coords = np.random.default_rng(5).integers(0, H, size=(300, 3)).astype(np.int32)
    key = jax.random.PRNGKey(2)
    jitter = np.array(jax.random.uniform(key, (300, 3), jnp.float32, -1.0, 1.0))
    for cas in range(CASCADE):
        want = jo.cells_to_cascade_points(jnp.asarray(coords), cas, H, 2.0, key)
        got = to.cells_to_cascade_points(torch.from_numpy(coords), cas, H, 2.0,
                                         jitter=torch.from_numpy(jitter))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_torch_random_update_draws_its_occupied_half_from_positive_cells():
    rng = np.random.default_rng(8)
    grid = np.zeros((CASCADE, N), np.float32)
    positive = [rng.choice(N, size=40, replace=False), rng.choice(N, size=3, replace=False)]
    for cas, cells in enumerate(positive):
        grid[cas, cells] = rng.uniform(0.5, 2.0, size=cells.size)
    probes = []

    def sigma_fn(pts):
        probes.append(pts.clone())
        return torch.full((pts.shape[0],), 5.0)

    gen = torch.Generator().manual_seed(0)
    state = to.occupancy_update_random(_port_state(grid), sigma_fn, bound=2.0, density_scale=1.0,
                                       density_decay=0.95, density_thresh=10.0, generator=gen,
                                       chunk=N // 4)
    pts = torch.cat(probes).reshape(CASCADE, 2, N // 4, 3)  # [cascade, uniform|occupied, ...]
    for cas in range(CASCADE):
        cb = min(2.0**cas, 2.0)
        coords = torch.round((pts[cas, 1] / (cb - cb / H) + 1.0) * (H - 1) / 2).long()
        cells = to.cell_linear_index(coords, H).numpy()
        assert set(np.unique(cells)) <= set(positive[cas].tolist())
        assert len(np.unique(cells)) == len(positive[cas])  # each drawn (N/4 draws)
    # Probed cells (density 5) take max(grid * 0.95, 5); others keep theirs.
    probed = (state.density_grid.numpy() == 5.0)
    assert probed.sum() > N // 4
    assert np.all(state.density_grid.numpy()[~probed] == grid[~probed])


def test_torch_draw_occupied_cells_falls_back_to_all_cells():
    gen = torch.Generator().manual_seed(1)
    cells = to.draw_occupied_cells(torch.zeros(N), 2000, gen)
    assert cells.min() >= 0 and cells.max() < N and len(torch.unique(cells)) > 1000
    row = torch.zeros(N)
    row[[7, 4095]] = 1.0
    assert set(to.draw_occupied_cells(row, 500, gen).tolist()) == {7, 4095}


def test_torch_update_mean_count_matches_jax():
    js, _ = _jax_state(np.zeros((CASCADE, N), np.float32))
    ts = to.occupancy_init(CASCADE, H)
    for points in (1000, 2500, 37, 123457):
        js = jo.update_mean_count(js, jnp.int32(points))
        ts = to.update_mean_count(ts, points)
        assert int(ts.mean_count) == int(js.mean_count)
        assert int(ts.local_step) == int(js.local_step)
        assert ts.mean_count.dtype == torch.int32
