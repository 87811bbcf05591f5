"""Port parity of the incremental renderer (``RenderSettings.infer_two_phase``
False: ``nerfstyle_torch/render/renderer.py:render_chunk_incremental``) and
of its round composite (plain K4i, ``ops/compositing.py:
sample_weights_entering_plain``) against the JAX package on the CPU.

* The chunk against JAX's ``make_incremental_renderer`` on the setup of
  ``tests/test_render_incremental.py`` (its tolerances: rtol 2e-4, atol 2e-5;
  classes atol 2e-4), and on a field whose rays saturate inside the box,
  so that rays die mid-frame and later rounds carry their transmittance.
* The chunk against the port's own two-phase chunk at ``sig_eps`` 0.
* Plain K4i against plain K4 when every ray enters with T = 1, and the
  rounds of a stream with T carried from round to round against one
  composite of the whole stream.
* ``Renderer.render`` with ``infer_two_phase=False`` against JAX's
  ``Renderer`` with ``infer_two_phase=False`` on a JAX-written checkpoint of
  the synthetic scene, at 32x24.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from composite_layouts import DT, T_THRESH
from nerfstyle_tpu.config import (
    DatasetConfig as JDatasetConfig,
    NetworkConfig as JNetworkConfig,
    RendererConfig as JRendererConfig,
    _from_dict as jfrom_dict,
)
from nerfstyle_tpu.core.types import BBox as JBBox, DatasetSplit as JSplit, make_rays
from nerfstyle_tpu.data import get_dataset as jget_dataset
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_tpu.ops.marching import MarchPlan as JMarchPlan, OccField as JOccField
from nerfstyle_tpu.ops.occupancy import (
    occupancy_persistable as jpersistable,
    occupancy_restore as jrestore,
    skipdist_from_bitfield as jskipdist,
)
from nerfstyle_tpu.render.renderer import (
    Renderer as JRenderer,
    RenderSettings as JRenderSettings,
    make_incremental_renderer,
)
from nerfstyle_tpu.training import checkpoint as jckpt
from nerfstyle_torch import kernels
from nerfstyle_torch.core.types import BBox
from nerfstyle_torch.models import fields as tf
from nerfstyle_torch.ops import compositing as tc
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_torch.ops.marching import MarchPlan, OccField
from nerfstyle_torch.ops.occupancy import skipdist_from_bitfield
from nerfstyle_torch.render import cli
from nerfstyle_torch.render.renderer import render_chunk, render_chunk_incremental
from test_torch_render import _write_jax_checkpoint

GRID = dict(num_levels=4, level_dim=2, base_resolution=8, per_level_scale=1.5,
            log2_hashmap_size=10)
N_RAYS, MAX_STEPS = 32, 128
# tests/test_render_incremental.py's tolerances (fp reduction order).
MAP_TOL = {"rgb_map": 2e-5, "weights_sum": 2e-5, "classes": 2e-4, "trans_map": 2e-5}


def _setup(kind: str):
    """(spec_j, spec_t, params_j, params_t, bits, rays): ``jax_test`` is
    tests/test_render_incremental.py's setup (field_init's faint tables);
    ``saturating`` widens the tables and offsets the density by 4 (sigma ~
    e^4: ~1.5 of optical depth a sample), so that most rays saturate inside
    the box, a few samples in."""
    offset = 4.0 if kind == "saturating" else 0.0
    spec_j = jf.style_field_spec(jh.hashgrid_spec(4, 2, 8, per_level_scale=1.5,
                                                  log2_hashmap_size=10),
                                 class_dim=3, density_offset=offset)
    spec_t = tf.style_field_spec(th.hashgrid_spec(**GRID), class_dim=3, density_offset=offset)
    params_j = jf.field_init(jax.random.PRNGKey(0), spec_j)
    rng = np.random.default_rng(0)
    bits = rng.random(16**3) < 0.4
    o = (rng.normal(size=(N_RAYS, 3)) * 2.0).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    if kind == "saturating":
        for k in ("x_density_embedder", "x_color_embedder"):
            params_j[k] = jnp.asarray(rng.uniform(-1, 1, params_j[k].shape).astype(np.float32))
        d = (rng.uniform(-0.8, 0.8, size=(N_RAYS, 3)) - o).astype(np.float32)  # most hit the box
    params_t = tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j))
    return spec_j, spec_t, params_j, params_t, bits, make_rays(jnp.asarray(o), jnp.asarray(d))


@pytest.fixture(scope="module", params=["jax_test", "saturating"])
def setup(request):
    return (request.param,) + _setup(request.param)


@pytest.fixture(scope="module")
def jax_chunk(setup):
    """JAX's incremental chunk (round 16, bucket 8) on the setup's rays."""
    _, spec_j, _, params_j, _, bits, rays = setup
    plan = JMarchPlan(bound=1.0, cascade=1, grid_size=16, max_steps=MAX_STEPS, num_rays=N_RAYS,
                      budget=N_RAYS * MAX_STEPS, min_near=0.05)
    render = make_incremental_renderer(spec_j, plan, T_THRESH, 1.0, round_size=16, bucket=8)
    bits_j = jnp.asarray(bits)
    return render(params_j, JOccField(bits_j, jskipdist(bits_j, 16)), JBBox.from_radius(1.0),
                  rays, 6)


def _port_chunk(setup, round_size: int, adaptive: bool = True, plain: bool = False):
    _, _, spec_t, _, params_t, bits, rays = setup
    plan = MarchPlan(bound=1.0, cascade=1, grid_size=16, max_steps=MAX_STEPS, min_near=0.05)
    b = torch.from_numpy(bits)
    occ = OccField(b, skipdist_from_bitfield(b, 16)) if adaptive else OccField(b)
    return render_chunk_incremental(
        spec_t, plan, params_t, occ, BBox.from_radius(1.0),
        torch.tensor(np.asarray(rays.origins)), torch.tensor(np.asarray(rays.dirs)),
        t_thresh=T_THRESH, density_scale=1.0, round_size=round_size, plain=plain)


@pytest.mark.parametrize("round_size", [16, 5, 32])
def test_torch_incremental_chunk_matches_jax(setup, jax_chunk, round_size):
    """The port's chunk at three round sizes against JAX's at 16 (whose
    output does not depend on the round: a sample's weight is gated by its
    entering T whatever the round).  At round 16 the samples evaluated are
    JAX's count; every round size ends within ceil(max_steps / round) + 1
    rounds; no kernel launched on the CPU."""
    kernels.reset_launch_counts()
    got = _port_chunk(setup, round_size)
    assert not any(kernels.launch_counts.values())
    assert got["num_marched"] == int(jax_chunk["num_marched"]) > N_RAYS
    assert 0 < got["num_points"] <= got["num_marched"]
    if round_size == 16:
        assert got["num_points"] == int(jax_chunk["num_points"])
    assert 0 < got["rounds"] <= -(-MAX_STEPS // round_size) + 1
    for key, atol in MAP_TOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(jax_chunk[key]), rtol=2e-4,
                                   atol=atol, err_msg=key)


def test_torch_incremental_chunk_matches_two_phase(setup):
    """At ``sig_eps`` 0 the two-phase chunk colors every sample of nonzero
    weight, so the two schemes composite the same weights; only the sums'
    order differs (float64 in both plain compositors): 1e-6.  The
    incremental chunk evaluates fewer samples once rays saturate; the dense
    march gives the same frame."""
    name, _, spec_t, _, params_t, bits, rays = setup
    plan = MarchPlan(bound=1.0, cascade=1, grid_size=16, max_steps=MAX_STEPS, min_near=0.05)
    b = torch.from_numpy(bits)
    two = render_chunk(spec_t, plan, params_t, OccField(b, skipdist_from_bitfield(b, 16)),
                       BBox.from_radius(1.0), torch.tensor(np.asarray(rays.origins)),
                       torch.tensor(np.asarray(rays.dirs)), t_thresh=T_THRESH,
                       density_scale=1.0, sig_eps=0.0)
    inc = _port_chunk(setup, 8)
    dense = _port_chunk(setup, 8, adaptive=False)
    if name == "saturating":
        assert inc["num_points"] < two["num_marched"] // 2
    for key in MAP_TOL:
        for got in (inc, dense):
            np.testing.assert_allclose(got[key].numpy(), two[key].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def _stream(seed, n=40, t0_one=False):
    """A ray-major round stream (0..40 samples a ray, some empty, two rays
    that turn opaque, one ending in an infinite density) and each ray's
    entering transmittance (1, or in [1e-5, 1]: some below t_thresh)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 41, size=n)
    counts[:3] = 0
    counts[-2:] = 8
    m = int(counts.sum())
    sigmas = np.exp(rng.normal(-1.0, 1.0, size=m)).astype(np.float32)
    sigmas[m - 16:] = rng.uniform(40.0, 70.0, size=16).astype(np.float32)
    sigmas[m - 1] = np.inf
    tau = rng.uniform(0.0, 3.0, size=m).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    t0 = np.ones(n, np.float32) if t0_one else (10.0 ** rng.uniform(-5, 0, n)).astype(np.float32)
    return [torch.from_numpy(a) for a in (sigmas, tau, offsets, t0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_k4i_plain_at_unit_entering_t_is_k4(seed):
    """With t0 = 1, K4i's weights, weights_sum and depth are K4's bit for
    bit (the same formula), and t_out is exp(-sum of the capped optical
    depth) of each ray in fp32 (1 for an empty ray, 0 past fp32's range)."""
    sigmas, tau, offsets, t0 = _stream(seed, t0_one=True)
    w, ws, depth, t_out = tc.sample_weights_entering_plain(sigmas, tau, offsets, t0, DT, T_THRESH)
    w4, ws4, depth4, _ = tc.sample_weights_plain(sigmas, tau, offsets, DT, T_THRESH)
    for a, b in ((w, w4), (ws, ws4), (depth, depth4)):
        assert torch.equal(a, b)
    sdt = torch.clamp(sigmas.double() * DT, max=tc.OPTICAL_DEPTH_CAP)
    want = torch.exp(-tc.segment_totals_plain(sdt, offsets).float())
    np.testing.assert_allclose(t_out.numpy(), want.numpy(), rtol=1e-6, atol=0)
    assert (t_out[:3] == 1).all() and (w == 0).any() and (w > 0).any()


@pytest.mark.parametrize("round_size", [1, 7, 32])
def test_torch_k4i_plain_rounds_carry_t(round_size):
    """A stream cut into rounds of ``round_size`` samples a ray, each round's
    rays entering with the t_out of their previous round: the rounds'
    weights are the whole stream's K4 weights (relative 1e-5: exp of a
    sum against a product of exps), their per-ray sums add up to K4's, and
    the last t_out is the whole ray's."""
    sigmas, tau, offsets, _ = _stream(3, t0_one=True)
    w4, ws4, depth4, _ = tc.sample_weights_plain(sigmas, tau, offsets, DT, T_THRESH)
    n = offsets.shape[0] - 1
    counts = offsets[1:] - offsets[:-1]
    t = torch.ones(n)
    ws, depth, w = torch.zeros(n), torch.zeros(n), torch.zeros_like(sigmas)
    done = torch.zeros(n, dtype=torch.int64)
    while (done < counts).any():
        take = torch.clamp(counts - done, max=round_size)
        rid = torch.repeat_interleave(torch.arange(n), take)
        roff = torch.zeros(n + 1, dtype=torch.int64)
        roff[1:] = torch.cumsum(take, 0)
        pos = (offsets[:-1] + done - roff[:-1])[rid] + torch.arange(int(roff[-1]))
        wr, wsr, dr, t = tc.sample_weights_entering_plain(sigmas[pos], tau[pos], roff, t, DT,
                                                          T_THRESH)
        w[pos] = wr
        ws, depth, done = ws + wsr, depth + dr, done + take
    np.testing.assert_allclose(w.numpy(), w4.numpy(), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(ws.numpy(), ws4.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(depth.numpy(), depth4.numpy(), rtol=1e-5, atol=1e-6)
    _, t_whole = tc.sample_weights_entering_plain(sigmas, tau, offsets, torch.ones(n), DT,
                                                  T_THRESH)[::3]
    np.testing.assert_allclose(t.numpy(), t_whole.numpy(), rtol=1e-5, atol=1e-30)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return _write_jax_checkpoint(tmp_path_factory.mktemp("render_incremental"))


def _jax_frame(ckpt, w: int, h: int):
    """JAX's Renderer with ``infer_two_phase=False`` on the checkpoint's
    first test pose (render.py's set-up, inlined)."""
    meta, groups = jckpt.load_checkpoint(ckpt)
    dcfg = jfrom_dict(JDatasetConfig, meta["dataset_cfg"])
    ncfg = jfrom_dict(JNetworkConfig, meta["net_cfg"])
    rcfg = jfrom_dict(JRendererConfig, meta["render_cfg"])
    train_set = jget_dataset(dcfg, split=JSplit.TRAIN)
    test_set = jget_dataset(dcfg, split=JSplit.TEST, max_count=1)
    pe = ncfg.pos_enc
    grid = jf.make_grid_spec(pe.n_lvls, pe.n_feats_per_lvl, pe.hashmap_size, pe.min_res,
                             pe.max_res_coeff, float(np.max(np.asarray(train_set.bbox.size))))
    spec = jf.style_field_spec(grid, class_dim=train_set.num_classes)
    params = jckpt.restore_tree(jf.field_init(jax.random.PRNGKey(0), spec), groups["params"])
    settings = JRenderSettings(grid_size=rcfg.grid_size, min_near=rcfg.min_near,
                               t_thresh=rcfg.t_thresh, max_steps=rcfg.max_steps,
                               infer_two_phase=False)
    renderer = JRenderer(spec, train_set.bbox, settings, test_set.intr.scale(w, h),
                         float(dcfg.bound), raymarch_channels=3 + train_set.num_classes)
    renderer.occ_state = jrestore(
        jckpt.restore_tree(jpersistable(renderer.occ_state), groups["occ"]), settings.grid_size)
    renderer.update_occ = False
    _, pose = test_set[0]
    return renderer.render(params, jnp.asarray(pose), None, training=False)


def test_torch_renderer_incremental_matches_jax(checkpoint):
    """``Renderer.render`` of a JAX-written checkpoint at 32x24 with
    ``infer_two_phase=False`` (the port's rounds) against JAX's ``Renderer``
    with ``infer_two_phase=False``, at the chunk test's tolerances; the
    port's counters add up over the frame."""
    want = _jax_frame(checkpoint, 32, 24)
    renderer, params, test_set, _ = cli.load_renderer(checkpoint, device="cpu",
                                                      out_dims=(32, 24), max_count=1)
    renderer.settings = dataclasses.replace(renderer.settings, infer_two_phase=False)
    _, pose = test_set[0]
    got = renderer.render(params, torch.from_numpy(np.asarray(pose)))
    assert got["rgb_map"].shape == (32 * 24, 3)
    assert 0 < got["num_points"] <= got["num_marched"] and got["rounds"] >= 1
    for key, atol in MAP_TOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=2e-4,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("kind", ["base", "style use_dir"])
def test_torch_incremental_view_field_matches_two_phase(kind):
    """Fields that read the view direction (the base field; the style field
    with ``use_dir``): the rounds gather each sample's direction beside its
    position, and the frame equals the two-phase chunk's at ``sig_eps`` 0
    (1e-5, as above)."""
    grid = th.hashgrid_spec(**GRID)
    if kind == "base":
        spec = tf.FieldSpec(grid=grid, kind="base", density_offset=2.0)
    else:
        spec = dataclasses.replace(tf.style_field_spec(grid, class_dim=3, density_offset=2.0),
                                   use_dir=True)
    params = tf.field_init(spec, torch.Generator().manual_seed(0))
    for k in ("x_embedder", "x_density_embedder", "x_color_embedder"):
        if k in params:
            params[k] = torch.empty_like(params[k]).uniform_(
                -1, 1, generator=torch.Generator().manual_seed(1))
    _, _, _, _, bits, rays = _setup("saturating")
    plan = MarchPlan(bound=1.0, cascade=1, grid_size=16, max_steps=MAX_STEPS, min_near=0.05)
    b = torch.from_numpy(bits)
    occ = OccField(b, skipdist_from_bitfield(b, 16))
    args = (spec, plan, params, occ, BBox.from_radius(1.0),
            torch.tensor(np.asarray(rays.origins)), torch.tensor(np.asarray(rays.dirs)))
    two = render_chunk(*args, t_thresh=T_THRESH, density_scale=1.0, sig_eps=0.0)
    inc = render_chunk_incremental(*args, t_thresh=T_THRESH, density_scale=1.0, round_size=8)
    assert spec.needs_dirs and inc["rounds"] > 1
    for key in MAP_TOL:
        np.testing.assert_allclose(inc[key].numpy(), two[key].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
