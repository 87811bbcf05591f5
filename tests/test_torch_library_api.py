"""Port parity of the library pieces no path of either package calls, on
the CPU: ``core/types.py`` (``Box2D``, ``DatasetCoordSystem``, ``BBox.mid_pt``
/ ``scaled``, ``warp_ndc``, ``RotatedBBox``, ``VoxelOccupancyMap``),
``generate_rays``' whole signature, and ``ops/stratified.py`` with
``utils.density2alpha`` (``VGG19FeatureExtractor``: tests/test_torch_vgg19.py).

Tolerances: float32 elementwise math in both packages, exact or within
1e-6 relative where the same expression runs in another library;
``integrate_points``' cumprod and sums 1e-6 relative (atol 1e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_torch import utils as tu
from nerfstyle_torch.core import cameras as tcam
from nerfstyle_torch.core import types as tt
from nerfstyle_torch.ops import stratified as ts
from nerfstyle_tpu import utils as ju
from nerfstyle_tpu.core import cameras as jcam
from nerfstyle_tpu.core import types as jt
from nerfstyle_tpu.ops import stratified as js

GEOM = dict(h=12, w=16, fx=10.0, fy=11.0, cx=8.0, cy=6.0)


def _pose(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = q, rng.normal(size=3)
    return pose


def _close(got: torch.Tensor, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Types
# ---------------------------------------------------------------------------


def test_torch_box2d_coord_system_and_bbox_match_jax():
    """The types, and ``core``'s exports: JAX's but ``LossValue`` (the
    trainer's status printers' record, still to port)."""
    import nerfstyle_torch.core as tcore
    import nerfstyle_tpu.core as jcore

    assert set(tcore.__all__) == set(jcore.__all__) - {"LossValue"}
    box = tt.Box2D(x=2, y=3, w=5, h=4)
    jbox = jt.Box2D(x=2, y=3, w=5, h=4)
    assert (box.wrange(), box.hrange()) == (jbox.wrange(), jbox.hrange())
    assert {e.name: e.value for e in tt.DatasetCoordSystem} == \
        {e.name: e.value for e in jt.DatasetCoordSystem}
    lo, hi = np.array([-1.0, 0.5, -2.0], np.float32), np.array([3.0, 1.5, 0.0], np.float32)
    tb = tt.BBox(torch.from_numpy(lo), torch.from_numpy(hi))
    jb = jt.BBox(jnp.asarray(lo), jnp.asarray(hi))
    _close(tb.mid_pt, jb.mid_pt, 0, 0)
    for factor in (0.5, 1.25):
        ts_, js_ = tb.scaled(factor), jb.scaled(factor)
        _close(ts_.min_pt, js_.min_pt, 0, 0)
        _close(ts_.max_pt, js_.max_pt, 0, 0)


def test_torch_warp_ndc_matches_jax():
    rng = np.random.default_rng(0)
    o = rng.normal(size=(64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.2  # forward-facing: every ray crosses z = -near
    want = jt.warp_ndc(jt.make_rays(jnp.asarray(o), jnp.asarray(d)), 1.0, jt.Intrinsics(**GEOM))
    got = tt.warp_ndc(tt.make_rays(torch.from_numpy(o), torch.from_numpy(d)), 1.0,
                      tt.Intrinsics(**GEOM))
    _close(got.origins, want.origins, 1e-5, 1e-6)
    _close(got.dirs, want.dirs, 1e-5, 1e-6)


def test_torch_rotated_bbox_contains_both_senses():
    """A rotated, scaled unit cube (v3 above v4, normals inward): inside,
    outside and on-face points, both senses, equal to JAX's; the corner
    extremes equal too."""
    cube = np.array([[0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1],
                     [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 0]], dtype=np.float64)
    rot = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3)))[0]
    rot *= np.sign(np.linalg.det(rot))  # a rotation, not a reflection
    pts8 = (cube * [2.0, 1.0, 0.5]) @ rot.T + [0.3, -0.2, 1.0]
    rng = np.random.default_rng(2)
    local = np.concatenate([rng.uniform(-0.5, 1.5, size=(200, 3)),
                            [[0.5, 0.5, 0.5], [1.0, 0.5, 0.5], [0.5, 0.0, 0.5]]])
    q = ((local * [2.0, 1.0, 0.5]) @ rot.T + [0.3, -0.2, 1.0]).astype(np.float32)
    jbox = jt.RotatedBBox.from_corners(pts8)
    tbox = tt.RotatedBBox.from_corners(pts8)
    _close(tbox.min_pt, jbox.min_pt, 0, 0)
    _close(tbox.max_pt, jbox.max_pt, 0, 0)
    for outside in (False, True):
        want = np.asarray(jbox.contains(jnp.asarray(q), outside=outside))
        got = tbox.contains(torch.from_numpy(q), outside=outside).numpy()
        np.testing.assert_array_equal(got, want)
    inside = tbox.contains(torch.from_numpy(q)).numpy()
    strict = np.all((local > 1e-4) & (local < 1 - 1e-4), axis=1)
    assert inside[-3] and not inside[-2] and inside[:200].any() and (~inside[:200]).any()
    np.testing.assert_array_equal(inside[:200][strict[:200]], True)


def test_torch_voxel_occupancy_map_query_and_load(tmp_path):
    rng = np.random.default_rng(3)
    grid = rng.random((5, 4, 6)) < 0.4
    lo, hi = np.array([-1.0, 0.0, 2.0]), np.array([1.5, 2.0, 5.0])
    np.savez(tmp_path / "map.npz", map=grid, global_min_pt=lo, global_max_pt=hi)
    jm = jt.VoxelOccupancyMap.load(tmp_path / "map.npz")
    tm = tt.VoxelOccupancyMap.load(tmp_path / "map.npz", device="cpu")
    pts = rng.uniform(lo - 0.3, hi + 0.3, size=(500, 3)).astype(np.float32)
    pts[:5] = lo + 1e-6  # within epsilon of the box's faces: outside
    _close(tm.voxel_size, jm.voxel_size, 0, 0)
    np.testing.assert_array_equal(tm.pts_to_indices(torch.from_numpy(pts)).numpy(),
                                  np.asarray(jm.pts_to_indices(jnp.asarray(pts))))
    got = tm.query(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.query(jnp.asarray(pts))))
    assert got.any() and not got[:5].any()
    dense = tt.VoxelOccupancyMap.from_dense(grid, lo, hi)
    assert torch.equal(dense.grid_flat, tm.grid_flat) and not bool(dense.grid_flat[-1])


# ---------------------------------------------------------------------------
# generate_rays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"patch": (2, 3, 5, 4)}, {"precrop": 0.5},
                                {"camera_flip": 3, "patch": (0, 0, 16, 1)}],
                         ids=["frame", "patch", "precrop", "flip-row"])
def test_torch_generate_rays_matches_jax(kw):
    """Every pixel of the grid, of a patch or of a precrop window, with the
    image's pixels as the target: JAX's rays and target."""
    kw = dict(kw)
    if "patch" in kw:
        kw["patch"] = tuple(kw["patch"])
    pose = _pose(0)
    img = np.random.default_rng(4).random((4, 12, 16)).astype(np.float32)
    jp = jt.Box2D(*kw["patch"]) if "patch" in kw else None
    tp = tt.Box2D(*kw["patch"]) if "patch" in kw else None
    rest = {k: v for k, v in kw.items() if k != "patch"}
    jrays, jtarget = jcam.generate_rays(jnp.asarray(pose), jt.Intrinsics(**GEOM),
                                        jnp.asarray(img), patch=jp, **rest)
    trays, ttarget = tcam.generate_rays(torch.from_numpy(pose), tt.Intrinsics(**GEOM),
                                        torch.from_numpy(img), patch=tp, **rest)
    _close(trays.origins, jrays.origins, 0, 0)
    _close(trays.dirs, jrays.dirs, 1e-6, 1e-7)
    _close(ttarget, jtarget, 0, 0)
    none_rays, none_target = tcam.generate_rays(torch.from_numpy(pose), tt.Intrinsics(**GEOM),
                                                patch=tp, **rest)
    assert none_target is None and torch.equal(none_rays.dirs, trays.dirs)


def test_torch_generate_rays_draws_distinct_pixels_with_their_targets():
    """``num_rays`` pixels drawn without replacement: each ray is its
    pixel's ray of the full grid, its target that pixel, and no pixel
    repeats; the same generator seed draws the same pixels."""
    pose = torch.from_numpy(_pose(1))
    intr = tt.Intrinsics(**GEOM)
    ys, xs = np.meshgrid(np.arange(12), np.arange(16), indexing="ij")
    img = torch.from_numpy(np.stack([ys, xs, ys * 16 + xs]).astype(np.float32))
    full, _ = tcam.generate_rays(pose, intr)
    for patch in (None, tt.Box2D(x=3, y=2, w=9, h=7)):
        rays, target = tcam.generate_rays(pose, intr, img, patch=patch, num_rays=50,
                                          generator=torch.Generator().manual_seed(5))
        flat = target[:, 2].long()
        assert target.shape == (50, 3) and len(set(flat.tolist())) == 50
        assert torch.equal(target[:, 0] * 16 + target[:, 1], target[:, 2])
        if patch is not None:
            assert ((target[:, 0] >= 2) & (target[:, 0] < 9) & (target[:, 1] >= 3)
                    & (target[:, 1] < 12)).all()
        torch.testing.assert_close(rays.dirs, full.dirs[flat], rtol=0, atol=1e-6)
        again, _ = tcam.generate_rays(pose, intr, img, patch=patch, num_rays=50,
                                      generator=torch.Generator().manual_seed(5))
        assert torch.equal(again.dirs, rays.dirs)
    with pytest.raises(ValueError, match="Generator"):
        tcam.generate_rays(pose, intr, num_rays=4)
    with pytest.raises(ValueError, match="exclusive"):
        tcam.camera_dir_grid(intr, 0, 0.5, tt.Box2D(0, 0, 2, 2))


# ---------------------------------------------------------------------------
# stratified
# ---------------------------------------------------------------------------


def test_torch_density2alpha_and_integrate_points_match_jax():
    """``density2alpha`` and one ``integrate_points`` call against JAX's on
    the same numpy inputs (negative densities clamp to 0), then the frame
    in three chunks resumed through (rgb, acc, trans): equal to one call
    over all samples, as JAX's chunks are."""
    rng = np.random.default_rng(6)
    n, k = 40, 24
    dists = rng.uniform(0.01, 0.2, size=(n, k)).astype(np.float32)
    dists[:, -1] = 1e10
    dens = rng.normal(1.0, 3.0, size=(n, k)).astype(np.float32)
    rgbs = rng.random((n, k, 3)).astype(np.float32)
    _close(tu.density2alpha(torch.from_numpy(dens), torch.from_numpy(dists)),
           ju.density2alpha(jnp.asarray(dens), jnp.asarray(dists)), 1e-6, 1e-7)
    zeros = lambda c: np.zeros((n, c), np.float32)  # noqa: E731
    ones = np.ones((n, 1), np.float32)
    want = js.integrate_points(*map(jnp.asarray, (dists, rgbs, dens, zeros(3), zeros(1), ones)))
    got = ts.integrate_points(*map(torch.from_numpy, (dists, rgbs, dens, zeros(3), zeros(1),
                                                      ones)))
    for g, w in zip(got, want):
        _close(g, w, 1e-6, 1e-7)
    carry_t = tuple(map(torch.from_numpy, (zeros(3), zeros(1), ones)))
    carry_j = tuple(map(jnp.asarray, (zeros(3), zeros(1), ones)))
    for a, b in ((0, 7), (7, 16), (16, k)):
        carry_t = ts.integrate_points(torch.from_numpy(dists[:, a:b]),
                                      torch.from_numpy(rgbs[:, a:b]),
                                      torch.from_numpy(dens[:, a:b]), *carry_t)
        carry_j = js.integrate_points(jnp.asarray(dists[:, a:b]), jnp.asarray(rgbs[:, a:b]),
                                      jnp.asarray(dens[:, a:b]), *carry_j)
    for g, w, whole in zip(carry_t, carry_j, got):
        _close(g, w, 1e-6, 1e-7)
        torch.testing.assert_close(g, whole, rtol=1e-5, atol=1e-6)


def test_torch_sample_points_law_and_global_to_local():
    """One sample in each of the K strata of [near, far], on its ray; the
    last dist 1e10; the generator decides the jitter.  ``global_to_local``
    against JAX's on the same blocks."""
    rng = np.random.default_rng(7)
    o = torch.from_numpy(rng.normal(size=(30, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(30, 3)).astype(np.float32))
    rays = tt.make_rays(o, d)
    pts, dists = ts.sample_points(rays, 0.5, 4.5, 16, torch.Generator().manual_seed(0))
    assert pts.shape == (30, 16, 3) and dists.shape == (30, 16)
    t = ((pts - rays.origins[:, None]) * rays.dirs[:, None]).sum(-1)  # unit dirs
    torch.testing.assert_close(rays.lerp(t), pts, rtol=0, atol=1e-5)  # on the rays
    edges = torch.linspace(0.5, 4.5, 17)
    assert bool(((t >= edges[:-1] - 1e-5) & (t <= edges[1:] + 1e-5)).all())
    assert bool((dists[:, -1] == 1e10).all())
    torch.testing.assert_close(dists[:, :-1], t[:, 1:] - t[:, :-1], rtol=0, atol=2e-5)
    again, _ = ts.sample_points(rays, 0.5, 4.5, 16, torch.Generator().manual_seed(0))
    other, _ = ts.sample_points(rays, 0.5, 4.5, 16, torch.Generator().manual_seed(1))
    assert torch.equal(again, pts) and not torch.equal(other, pts)
    points = rng.normal(size=(12, 3)).astype(np.float32)
    mids = rng.normal(size=(3, 3)).astype(np.float32)
    want = js.global_to_local(jnp.asarray(points), jnp.asarray(mids), 0.25, [5, 4, 3])
    got = ts.global_to_local(torch.from_numpy(points), torch.from_numpy(mids), 0.25, [5, 4, 3])
    _close(got, want, 1e-6, 1e-6)
