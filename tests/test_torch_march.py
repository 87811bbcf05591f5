"""Port parity: ray/AABB, cascade cell index and the march vs the JAX
package at an ample budget: the plain dense march (K3) against the JAX dense
path, the plain two-stage march (K3s) against the JAX two-stage path (skip
distance), and the port's two marches against each other.  Kernels K3 and
K3s are held against the plain versions in tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.core.types import RayBundle
from nerfstyle_tpu.ops import aabb as ja
from nerfstyle_tpu.ops import marching as jm
from nerfstyle_tpu.ops.occupancy import skipdist_from_bitfield
from nerfstyle_torch.ops import aabb as ta
from nerfstyle_torch.ops import marching as tm
from nerfstyle_torch.ops.occupancy import skipdist_from_bitfield as t_skipdist
from nerfstyle_torch.render.renderer import cascade_for_bound

GRID = 16
N_RAYS = 64


def _rays(rng, n, bound):
    """Origins around the box (some inside), unit dirs; ray 0 axis-aligned."""
    o = rng.uniform(-2.5 * bound, 2.5 * bound, size=(n, 3)).astype(np.float32)
    target = rng.uniform(-0.8 * bound, 0.8 * bound, size=(n, 3)).astype(np.float32)
    d = target - o
    d[0] = (0.0, 0.0, 1.0)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _scene(seed, bound, max_steps, density):
    rng = np.random.default_rng(seed)
    cascade = cascade_for_bound(bound)
    bits = rng.random(cascade * GRID**3) < density
    o, d = _rays(rng, N_RAYS, bound)
    return cascade, bits, o, d


CASES = [
    # (bound, max_steps, occupied share): 1 and 2 cascades, a binding
    # per-ray cap (max_steps 16 in fully occupied space)
    (1.0, 128, 0.3),
    (2.0, 128, 0.4),
    (2.0, 16, 1.0),
]


def test_torch_near_far_matches_jax_with_misses():
    rng = np.random.default_rng(3)
    o, d = _rays(rng, 256, 1.0)
    d[1:40] = -d[1:40]  # pointing away: many misses
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    nj, fj = ja.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.05)
    nt, ft = ta.near_far_from_aabb(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(aabb), 0.05)
    assert np.array_equal(np.asarray(nj), nt.numpy())
    assert np.array_equal(np.asarray(fj), ft.numpy())
    miss = nt.numpy() == np.float32(ta.FLT_MAX)
    assert miss.any() and np.all(ft.numpy()[miss] == np.float32(ta.FLT_MAX))


def test_torch_cell_index_matches_jax():
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-2.0, 2.0, size=(4096, 3)).astype(np.float32)
    xyz[:64] *= 1e-3  # deep inside the finest cascade
    kw = dict(bound=2.0, cascade=2, grid_size=GRID, mip_dt_level=0)
    ij, sj, lj, _ = jm.cell_index_and_size(jnp.asarray(xyz), **kw)
    it, st, lt, _ = tm.cell_index_and_size(torch.from_numpy(xyz), **kw)
    assert np.array_equal(np.asarray(ij), it.numpy())
    assert np.array_equal(np.asarray(lj), lt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())


# Each path against its JAX counterpart (the JAX two-stage compile
# dominates this file's time); CASES[2] is a fully occupied grid.
@pytest.mark.parametrize(
    "two_stage,bound,max_steps,density",
    [(False, *c) for c in CASES] + [(True, *c) for c in CASES],
    ids=["dense-1", "dense-2", "dense-cap", "two_stage-1", "two_stage-2", "two_stage-cap"],
)
def test_torch_march_plain_matches_jax(two_stage, bound, max_steps, density):
    cascade, bits, o, d = _scene(11, bound, max_steps, density)
    plan_t = tm.MarchPlan(bound=bound, cascade=cascade, grid_size=GRID,
                          max_steps=max_steps, min_near=0.05)
    t_lat = plan_t.t_lattice
    plan_j = jm.MarchPlan(bound=bound, cascade=cascade, grid_size=GRID, max_steps=max_steps,
                          num_rays=N_RAYS, budget=N_RAYS * t_lat, min_near=0.05)
    assert (plan_t.dt, plan_t.t_lattice, plan_t.mip_dt_level) == (
        float(np.float32(plan_j.dt)), plan_j.t_lattice, plan_j.mip_dt_level)
    rays = RayBundle(jnp.asarray(o), jnp.asarray(d))
    nj, fj = ja.near_far_from_aabb(rays.origins, rays.dirs, plan_j.aabb, 0.05)
    bits_j = jnp.asarray(bits)
    occ = jm.OccField(bits_j, skipdist_from_bitfield(bits_j, GRID)) if two_stage else bits_j
    sj = jm.march_rays(plan_j, occ, rays, nj, fj)

    ot, dt_ = torch.from_numpy(o), torch.from_numpy(d)
    nt, ft = ta.near_far_from_aabb(ot, dt_, plan_t.aabb(), 0.05)
    bits_t = torch.from_numpy(bits)
    occ_t = tm.OccField(bits_t, t_skipdist(bits_t, GRID)) if two_stage else bits_t
    st = tm.march_rays(plan_t, occ_t, ot, dt_, nt, ft)

    m = int(sj.num_kept)
    assert m > N_RAYS and st.num_kept == m
    assert np.array_equal(np.asarray(sj.ray_id)[:m], st.ray_id.numpy())
    np.testing.assert_array_equal(st.xyz.numpy(), np.asarray(sj.xyz)[:m])
    np.testing.assert_array_equal(st.tau.numpy(), np.asarray(sj.tau)[:m])
    np.testing.assert_array_equal(st.dirs.numpy(), np.asarray(sj.dirs)[:m])
    # Lattice index: the JAX dense mask's flat positions.
    kept = np.asarray(jm._kept_mask_dense(plan_j, bits_j, rays, nj, fj)).reshape(-1)
    np.testing.assert_array_equal(st.step.numpy(), np.flatnonzero(kept) % t_lat)
    counts = np.bincount(st.ray_id.numpy(), minlength=N_RAYS)
    np.testing.assert_array_equal(st.offsets.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    if max_steps == 16:
        assert counts.max() == max_steps  # the per-ray cap binds
    # Candidate windows: reported by the two-stage march only.
    assert st.num_cand == int(sj.num_cand)
    if two_stage:
        assert 0 < st.num_cand <= N_RAYS * -(-t_lat // tm.WINDOW)


@pytest.mark.parametrize("seed,bound,max_steps,density",
                         [(s, *c) for s, c in enumerate(CASES)] + [(7, 2.0, 1024, 0.02)])
def test_torch_two_stage_march_equals_dense(seed, bound, max_steps, density):
    """The port's two marches emit the same samples: every occupied lattice
    point lies in a candidate window.  The sparse case skips most windows."""
    cascade, bits, o, d = _scene(seed, bound, max_steps, density)
    plan = tm.MarchPlan(bound=bound, cascade=cascade, grid_size=GRID, max_steps=max_steps,
                        min_near=0.05)
    ot, dt_ = torch.from_numpy(o), torch.from_numpy(d)
    nt, ft = ta.near_far_from_aabb(ot, dt_, plan.aabb(), 0.05)
    bits_t = torch.from_numpy(bits)
    dense = tm.march_rays(plan, bits_t, ot, dt_, nt, ft)
    two = tm.march_rays(plan, tm.OccField(bits_t, t_skipdist(bits_t, GRID)), ot, dt_, nt, ft)
    assert dense.num_kept > 0 and dense.num_cand == 0
    for name in ("xyz", "dirs", "tau", "ray_id", "step", "offsets"):
        assert torch.equal(getattr(two, name), getattr(dense, name)), name
    windows = N_RAYS * -(-plan.t_lattice // tm.WINDOW)
    if density < 0.1:
        assert two.num_cand < 0.5 * windows


def test_torch_march_ray_chunks_concatenate():
    """Rays march independently: the renderer may cut a frame into chunks."""
    cascade, bits, o, d = _scene(5, 2.0, 1024, 0.2)
    plan = tm.MarchPlan(bound=2.0, cascade=cascade, grid_size=GRID, max_steps=1024, min_near=0.05)
    ot, dt_ = torch.from_numpy(o), torch.from_numpy(d)
    nt, ft = ta.near_far_from_aabb(ot, dt_, plan.aabb(), 0.05)
    bits_t = torch.from_numpy(bits)
    for occ in (bits_t, tm.OccField(bits_t, t_skipdist(bits_t, GRID))):
        full = tm.march_rays(plan, occ, ot, dt_, nt, ft)
        halves = [tm.march_rays(plan, occ, ot[s], dt_[s], nt[s], ft[s])
                  for s in (slice(0, 32), slice(32, 64))]
        assert torch.equal(full.xyz, torch.cat([h.xyz for h in halves]))
        assert torch.equal(full.step, torch.cat([h.step for h in halves]))
        assert full.num_cand == sum(h.num_cand for h in halves)

