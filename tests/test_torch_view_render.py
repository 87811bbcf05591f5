"""Port parity of the view-dependent field families through the renderers:
the two-phase chunk renderer (the frame path; phase B hands each
significant sample's direction to ``field_color``) against JAX's
``make_two_phase_renderer``, and the differentiable ``render_rays`` of a
train batch (phase B's ``field_apply`` on the kept samples and their
directions) against ``jax.grad`` of JAX's ``render_rays``, for the style
field with ``use_dir`` (6 raymarch channels) and the base field (3, an
empty class map).  Sizes and tolerances of ``tests/test_torch_render.py``
and ``tests/test_torch_train_step.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.core.types import BBox as JBBox, make_rays
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_tpu.ops.marching import MarchPlan as JMarchPlan
from nerfstyle_tpu.render.renderer import make_two_phase_renderer, render_rays as jrender_rays
from nerfstyle_torch.core.types import BBox, Intrinsics
from nerfstyle_torch.models import fields as tf
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_torch.ops.marching import MarchPlan
from nerfstyle_torch.ops.occupancy import PersistedOccupancy
from nerfstyle_torch.render.renderer import Renderer, RenderSettings, render_chunk, render_rays
from nerfstyle_torch.training.checkpoint import tree_flatten

GRID = dict(num_levels=4, level_dim=2, base_resolution=8, per_level_scale=1.5,
            log2_hashmap_size=10)
N_RAYS = 32
# tests/test_torch_render.py's map tolerances (fp reduction order).
MAP_TOL = {"rgb_map": 2e-5, "weights_sum": 2e-5, "classes": 2e-4, "trans_map": 2e-5}
CHANNELS = {"style_dir": 6, "base": 3}


def _specs(family):
    # density_offset 2: sigma ~ e^2, rays saturate within the box, so phase B
    # sees insignificant samples to drop.
    if family == "style_dir":
        return (jf.style_field_spec(jh.hashgrid_spec(**GRID), class_dim=3, use_dir=True,
                                    density_offset=2.0),
                tf.style_field_spec(th.hashgrid_spec(**GRID), class_dim=3, use_dir=True,
                                    density_offset=2.0))
    return (jf.FieldSpec(grid=jh.hashgrid_spec(**GRID), kind="base", density_offset=2.0),
            tf.FieldSpec(grid=th.hashgrid_spec(**GRID), kind="base", density_offset=2.0))


@pytest.fixture(scope="module", params=sorted(CHANNELS))
def setup(request):
    spec_j, spec_t = _specs(request.param)
    params_j = jf.field_init(jax.random.PRNGKey(0), spec_j)
    rng = np.random.default_rng(0)
    for k in ("x_density_embedder", "x_color_embedder", "x_embedder"):  # widen ±1e-4
        if k in params_j:
            params_j[k] = jnp.asarray(rng.uniform(-1, 1, params_j[k].shape).astype(np.float32))
    params_t = tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j))
    bits = rng.random(16**3) < 0.4
    o = rng.uniform(-2.5, 2.5, size=(N_RAYS, 3)).astype(np.float32)
    d = (rng.uniform(-0.8, 0.8, size=(N_RAYS, 3)) - o).astype(np.float32)  # most hit the box
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(jnp.asarray(o), jnp.asarray(d))
    return request.param, spec_j, spec_t, params_j, params_t, bits, rays


@pytest.mark.parametrize("sig_eps", [0.0, 1e-5])
def test_torch_view_two_phase_chunk_matches_jax(setup, sig_eps):
    family, spec_j, spec_t, params_j, params_t, bits, rays = setup
    channels = CHANNELS[family]
    plan_j = JMarchPlan(bound=1.0, cascade=1, grid_size=16, max_steps=128,
                        num_rays=N_RAYS, budget=N_RAYS * 128, min_near=0.05)
    render_j = make_two_phase_renderer(spec_j, plan_j, 1e-4, 1.0, sig_eps=sig_eps,
                                       sig_per_ray=128)
    want = render_j(params_j, jnp.asarray(bits), JBBox.from_radius(1.0), rays, channels)
    plan_t = MarchPlan(bound=1.0, cascade=1, grid_size=16, max_steps=128, min_near=0.05)
    got = render_chunk(
        spec_t, plan_t, params_t, torch.from_numpy(bits), BBox.from_radius(1.0),
        torch.tensor(np.asarray(rays.origins)), torch.tensor(np.asarray(rays.dirs)),
        t_thresh=1e-4, density_scale=1.0, sig_eps=sig_eps,
    )
    assert got["num_marched"] == int(want["num_marched"]) > N_RAYS
    assert got["num_sig"] == int(want["num_sig"]) > 0
    if sig_eps > 0:
        assert got["num_sig"] < got["num_marched"]
    assert got["classes"].shape == (N_RAYS, channels - 3) == want["classes"].shape
    for key, atol in MAP_TOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=2e-4, atol=atol, err_msg=key)


def test_torch_view_render_rays_color_grads_match_jax(setup):
    """The colour loss's parameter gradients through the two-phase
    ``render_rays`` (phase B on the kept prefix, with its directions).
    tests/test_torch_train_step.py's tolerances, as a fraction of each
    leaf's largest value: the leaves that carry density (density_net and
    its table; the base field's density_net and x_embedder feed its colour
    too) 1e-2, for JAX's fp32 flat-cumsum transmittance; the colour-only
    leaves 1e-4.  Maps rtol 2e-4 with MAP_TOL."""
    family, spec_j, spec_t, params_j, params_t, bits, rays = setup
    rng = np.random.default_rng(3)
    g_rgb = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    plan_j = JMarchPlan(bound=1.0, cascade=1, grid_size=16, max_steps=128,
                        num_rays=N_RAYS, budget=N_RAYS * 128, min_near=0.05)

    def loss(p):
        out = jrender_rays(spec_j, plan_j, p, jnp.asarray(bits), JBBox.from_radius(1.0), rays,
                           1e-4, 1.0, sig_budget=N_RAYS * 128)
        return jnp.sum(out["rgb_map"] * g_rgb), out

    (_, want), grads_j = jax.value_and_grad(loss, has_aux=True)(params_j)
    for w in tree_flatten(params_t):
        w.requires_grad_(True)
    plan_t = MarchPlan(bound=1.0, cascade=1, grid_size=16, max_steps=128, min_near=0.05)
    got = render_rays(spec_t, plan_t, params_t, torch.from_numpy(bits), BBox.from_radius(1.0),
                      torch.tensor(np.asarray(rays.origins)),
                      torch.tensor(np.asarray(rays.dirs)), t_thresh=1e-4, density_scale=1.0)
    assert got["num_points"] == int(want["num_points"])
    assert got["classes"].shape == (N_RAYS, CHANNELS[family] - 3)
    for key in ("rgb_map", "weights_sum"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), rtol=2e-4,
                                   atol=MAP_TOL[key], err_msg=key)
    (got["rgb_map"] * torch.from_numpy(g_rgb)).sum().backward()
    density = {"density_net", "x_density_embedder", "x_embedder"}
    for k in sorted(params_t):
        leaves = params_t[k] if isinstance(params_t[k], list) else [params_t[k]]
        for i, (w, gj) in enumerate(zip(leaves, jax.tree_util.tree_leaves(grads_j[k]))):
            gj = np.asarray(gj)
            g = np.zeros_like(gj) if w.grad is None else w.grad.numpy()
            np.testing.assert_allclose(g, gj, rtol=1e-4,
                                       atol=(1e-2 if k in density else 1e-4) * np.abs(gj).max(),
                                       err_msg=f"{family} {k} leaf {i}")


def test_torch_view_renderer_frame_and_density_probe(setup):
    """``Renderer`` takes either family through its library API: a frame
    (rays of a 6x5 camera) with the family's channels, and the occupancy
    upkeep's density probe (a full sweep) on the base field's x_embedder."""
    family, _, spec_t, _, params_t, bits, _ = setup
    settings = RenderSettings(grid_size=16, max_steps=128, min_near=0.05)
    intr = Intrinsics(h=5, w=6, fx=5.0, fy=5.0, cx=3.0, cy=2.5)
    r = Renderer(spec_t, BBox.from_radius(1.0), settings, intr, 1.0,
                 raymarch_channels=CHANNELS[family], device="cpu")
    r.restore_occupancy(PersistedOccupancy(
        torch.from_numpy(bits.astype(np.float32))[None], torch.from_numpy(bits),
        torch.tensor(0.4), torch.tensor(0, dtype=torch.int32), torch.tensor(0, dtype=torch.int32)))
    pose = torch.eye(4)
    pose[2, 3] = -2.5  # looking down +z at the box
    with torch.no_grad():
        out = r.render(params_t, pose)
        assert r.maybe_update_state(params_t, torch.Generator().manual_seed(0))
    assert out["rgb_map"].shape == (30, 3) and out["classes"].shape == (30, CHANNELS[family] - 3)
    assert bool(torch.isfinite(out["rgb_map"]).all()) and out["num_sig"] > 0
    assert float(r.occ_state.density_grid.max()) > 0.0
