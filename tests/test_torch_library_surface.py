"""Port parity of the JAX package's last library surface, on the CPU: no
path of either package calls any of it.

* ``Config.print`` and ``print_col_width``: stdout byte-equal to JAX's for
  each config group with a default file and for a ``BaseConfig``; the
  width is no flag in either package.
* ``BaseDataset.iter_shuffled``: the first 2 x len items equal (images and
  poses bit-equal).
* ``models/vgg.py``'s ``test_fx``: the printed text equal at 32x32.
* ``ops/compositing.py``'s ``CompositeOutput``, ``segment_exclusive_cumsum``
  and ``significance``; ``ops/marching.py``'s ``occupancy_lookup``: on
  padding rows, an empty segment, an infinite density, points on cell faces
  and outside the bound.  JAX sums the scan in fp32, the port in float64:
  the scan within 8 fp32 ulps of the stream's total, and within 1e-6 of a
  float64 loop (the port's fp32 rounding of it); the mask and the capped
  optical depth equal; the transmittance within that scan error,
  relative.
* ``ops/hashgrid.py``'s ``corner_indices_weights`` on trilinear and simplex
  levels at styles 0 and 63: indices and the out-of-range mask equal,
  weights within 1e-6.
* ``Renderer.render_ray_batch_incremental`` against JAX's (its renderer
  with ``infer_two_phase=False``, one compile) on a JAX-written checkpoint
  of the synthetic scene: maps within the incremental chunk tests'
  tolerances (rtol 2e-4; atol 2e-5, classes 2e-4), the counters equal.
* The signatures: every JAX parameter of these names, in JAX's order.
"""

import contextlib
import copy
import dataclasses
import inspect
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfstyle_torch.config as tconf
import nerfstyle_tpu.config as jconf
from nerfstyle_torch import kernels
from nerfstyle_torch.core.cameras import generate_rays
from nerfstyle_torch.core.types import DatasetSplit, RayBundle
from nerfstyle_torch.data import get_dataset
from nerfstyle_torch.data.base import BaseDataset
from nerfstyle_torch.data.synthetic import generate_scene
from nerfstyle_torch.models import vgg as tvgg
from nerfstyle_torch.ops import compositing as tc
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_torch.ops import marching as tm
from nerfstyle_torch.render import cli
from nerfstyle_torch.render.renderer import Renderer
from nerfstyle_tpu.core.types import DatasetSplit as JSplit, RayBundle as JRayBundle
from nerfstyle_tpu.data import get_dataset as jget_dataset
from nerfstyle_tpu.data.base import BaseDataset as JBaseDataset
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.models import vgg as jvgg
from nerfstyle_tpu.ops import compositing as jc
from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_tpu.ops import marching as jm
from nerfstyle_tpu.ops.occupancy import (
    occupancy_persistable as jpersistable,
    occupancy_restore as jrestore,
)
from nerfstyle_tpu.render.renderer import Renderer as JRenderer, RenderSettings as JRenderSettings
from nerfstyle_tpu.training import checkpoint as jckpt
from test_torch_render import _write_jax_checkpoint


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for the module: beside the other busy test
    workers, its threads contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stdout(fn, *args, **kwargs) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Config.print
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", ["DatasetConfig", "NetworkConfig", "RendererConfig",
                                   "TrainConfig", "BaseConfig"])
def test_torch_config_print_matches_jax(group):
    """Byte-equal rows: a group's defaults (``.load()``) and a ``BaseConfig``
    with paths and a bool set; the width 30 is a class variable,
    so ``--print_col_width`` stays a leftover flag in both parsers."""
    if group == "BaseConfig":
        kw = dict(log_dir=Path("logs/run"), data_cfg=Path("cfgs/dataset/synthetic.yaml"),
                  yes=True)
        cfgs = (jconf.BaseConfig(**kw), tconf.BaseConfig(**kw))
    else:
        cfgs = (getattr(jconf, group).load(), getattr(tconf, group).load())
    want, got = (_stdout(c.print) for c in cfgs)
    assert got == want and got.count("\n") > 3
    assert tconf.Config.print_col_width == jconf.Config.print_col_width == 30
    for c in cfgs:
        _, rest = type(c).create_parser().parse_known_args(["--print_col_width", "5"])
        assert rest == ["--print_col_width", "5"]


# ---------------------------------------------------------------------------
# BaseDataset.iter_shuffled
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("surface_scene")
    generate_scene(root / "scene", num_train=5, num_test=2, h=12, w=16)
    kw = dict(root_path=root / "scene", type="Synthetic", bound=2.0)
    return jconf.DatasetConfig(**kw), tconf.DatasetConfig(**kw)


@pytest.mark.parametrize("split", ["TRAIN", "TEST"])
@pytest.mark.parametrize("seed", [0, 7])
def test_torch_iter_shuffled_matches_jax(scene_cfg, split, seed):
    """Two passes of each split in JAX's order: images (the train split's
    with the seg channel) and poses bit-equal."""
    jset = jget_dataset(scene_cfg[0], split=getattr(JSplit, split))
    tset = get_dataset(scene_cfg[1], split=getattr(DatasetSplit, split))
    assert isinstance(jset, JBaseDataset) and isinstance(tset, BaseDataset)
    jit, tit = jset.iter_shuffled(seed), tset.iter_shuffled(seed)
    for _ in range(2 * len(tset)):
        (jimg, jpose), (timg, tpose) = next(jit), next(tit)
        np.testing.assert_array_equal(np.asarray(tpose), np.asarray(jpose))
        np.testing.assert_array_equal(np.asarray(timg), np.asarray(jimg))


# ---------------------------------------------------------------------------
# test_fx
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fx_type", ["vgg16", "vgg19"])
def test_torch_vgg_test_fx_prints_jax_text(fx_type):
    """Every layer and block key's feature size at 32x32, as JAX prints it
    (the fallback filters: no weights here)."""
    want = _stdout(jvgg.test_fx, fx_type, 32, 32)
    got = _stdout(tvgg.test_fx, fx_type, 32, 32, device="cpu")
    assert got == want
    assert got.count("Feature: ") == {"vgg16": 18, "vgg19": 21}[fx_type]


# ---------------------------------------------------------------------------
# The scan, the inclusion math and the occupancy lookup
# ---------------------------------------------------------------------------

NUM_RAYS, DT, T_THRESH = 12, 0.05, 1e-4


def _stream(case: str):
    """(sigmas [M] f32, ray_id [M] i32, valid [M] bool): ray-major rows of 12
    rays, 0..25 samples a ray; ``padding``: 9 trailing rows at ray_id ==
    num_rays (invalid); ``empty``: rays 0, 5 and 11 without samples;
    ``inf``: an infinite density mid-ray in ray 3 and at the end of ray 8."""
    rng = np.random.default_rng({"padding": 0, "empty": 1, "inf": 2}[case])
    counts = rng.integers(1, 26, size=NUM_RAYS)
    if case == "empty":
        counts[[0, 5, 11]] = 0
    ray_id = np.repeat(np.arange(NUM_RAYS), counts)
    sigmas = np.exp(rng.normal(0.5, 1.5, size=ray_id.size)).astype(np.float32)
    valid = rng.random(ray_id.size) < 0.9
    if case == "padding":
        ray_id = np.concatenate([ray_id, np.full(9, NUM_RAYS)])
        sigmas = np.concatenate([sigmas, rng.uniform(0, 5, 9).astype(np.float32)])
        valid = np.concatenate([valid, np.zeros(9, bool)])
    if case == "inf":
        starts = np.concatenate([[0], np.cumsum(counts)])
        for r in (3, 8):
            i = starts[r] + counts[r] // 2 if r == 3 else starts[r + 1] - 1
            sigmas[i], valid[i] = np.inf, True
    return sigmas, ray_id.astype(np.int32), valid


def _scan_loop(x: np.ndarray, ray_id: np.ndarray) -> np.ndarray:
    out, run, prev = np.zeros(x.size), 0.0, -1
    for i, (v, r) in enumerate(zip(x.astype(np.float64), ray_id)):
        run = 0.0 if r != prev else run
        out[i], run, prev = run, run + v, r
    return out


@pytest.mark.parametrize("case", ["padding", "empty", "inf"])
def test_torch_segment_exclusive_cumsum_matches_jax(case):
    """The exclusive in-ray scan of the capped optical depth (the padding
    rows' segment included) against JAX's and a float64 loop."""
    sigmas, ray_id, valid = _stream(case)
    sdt = np.where(valid, np.minimum(sigmas * np.float32(DT), 100.0), 0.0).astype(np.float32)
    got = tc.segment_exclusive_cumsum(torch.from_numpy(sdt), torch.from_numpy(ray_id), NUM_RAYS)
    want = np.asarray(jc.segment_exclusive_cumsum(jnp.asarray(sdt), jnp.asarray(ray_id),
                                                  NUM_RAYS))
    assert got.dtype == torch.float32 and got.shape == want.shape
    total = float(sdt.astype(np.float64).sum())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=8 * 2**-23 * total)
    np.testing.assert_allclose(got.numpy(), _scan_loop(sdt, ray_id), rtol=1e-6, atol=1e-6)
    ints = tc.segment_exclusive_cumsum(torch.from_numpy(ray_id), torch.from_numpy(ray_id),
                                       NUM_RAYS)
    assert ints.dtype == torch.int32
    np.testing.assert_array_equal(ints.numpy(), _scan_loop(ray_id, ray_id).astype(np.int32))


@pytest.mark.parametrize("case", ["padding", "empty", "inf"])
def test_torch_significance_matches_jax(case):
    """``(included, sdt, trans)``: the mask and the capped optical depth
    equal, the transmittance within the scan's error relative; an infinite
    density gives no NaN and T of 0 (or a denormal) behind it."""
    sigmas, ray_id, valid = _stream(case)
    got = tc.significance(torch.from_numpy(sigmas), torch.from_numpy(ray_id),
                          torch.from_numpy(valid), NUM_RAYS, DT, T_THRESH)
    want = [np.asarray(a) for a in jc.significance(jnp.asarray(sigmas), jnp.asarray(ray_id),
                                                   jnp.asarray(valid), NUM_RAYS, DT, T_THRESH)]
    inc, sdt, trans = (t.numpy() for t in got)
    for a in (sdt, trans):
        assert np.isfinite(a).all()
    np.testing.assert_array_equal(sdt, want[1])
    total = float(sdt.astype(np.float64).sum())
    np.testing.assert_allclose(trans, want[2], rtol=8 * 2**-23 * total + 1e-6, atol=1e-30)
    np.testing.assert_array_equal(inc, want[0])
    if case == "inf":
        assert sdt.max() == tc.OPTICAL_DEPTH_CAP and (trans < 1e-40).any()


def test_torch_composite_output_fields():
    assert tc.CompositeOutput._fields == jc.CompositeOutput._fields
    out = tc.CompositeOutput(torch.zeros(2, 3), torch.zeros(2), torch.zeros(2))
    assert out.weights_sum.shape == (2,)


def _lookup_points(kind: str, bound: float, grid: int, cascade: int) -> np.ndarray:
    """World points: on the cell faces of every cascade level (coordinates
    on multiples of each level's cell size, both signs), or outside the
    bound (|x| up to 1.6 bound, on faces and not)."""
    rng = np.random.default_rng(3)
    if kind == "faces":
        pts = []
        for lv in range(cascade):
            mip = min(2.0 ** lv, bound)
            k = rng.integers(0, grid + 1, size=(300, 3))
            pts.append((k * (2.0 * mip / grid) - mip).astype(np.float32))
        return np.concatenate(pts)
    pts = rng.uniform(-1.6 * bound, 1.6 * bound, size=(600, 3)).astype(np.float32)
    pts[:100] = np.round(pts[:100] * 4) / 4
    return pts


@pytest.mark.parametrize("kind", ["faces", "outside"])
def test_torch_occupancy_lookup_matches_jax(kind):
    """The cell bit of each point: equal to JAX's."""
    bound, grid, cascade = 2.0, 8, 2
    bits = np.random.default_rng(4).random(cascade * grid**3) < 0.5
    pts = _lookup_points(kind, bound, grid, cascade)
    got = tm.occupancy_lookup(torch.from_numpy(pts), torch.from_numpy(bits), bound=bound,
                              cascade=cascade, grid_size=grid)
    want = np.asarray(jm.occupancy_lookup(jnp.asarray(pts), jnp.asarray(bits), bound=bound,
                                          cascade=cascade, grid_size=grid))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


# ---------------------------------------------------------------------------
# corner_indices_weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("style", [0, 63])
@pytest.mark.parametrize("simplex_from", [-1, 2])
def test_torch_corner_indices_weights_matches_jax(simplex_from, style):
    """[B, L, 8] rows and weights of 6 levels (from level 2 on simplex
    weights, 4 of 8 slots nonzero) on points inside, on cell faces and
    outside [0, 1]^3."""
    kw = dict(num_levels=6, level_dim=2, base_resolution=8, per_level_scale=1.5,
              log2_hashmap_size=12, simplex_from=simplex_from)
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.1, 1.1, size=(400, 3)).astype(np.float32)
    x[:40] = np.round(x[:40] * 8) / 8
    idx, w, oob = th.corner_indices_weights(th.hashgrid_spec(**kw), torch.from_numpy(x), style)
    want = [np.asarray(a) for a in jh.corner_indices_weights(jh.hashgrid_spec(**kw),
                                                             jnp.asarray(x), style)]
    assert idx.dtype == torch.int32 and idx.shape == (400, 6, 8) and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), want[0])
    np.testing.assert_allclose(w.numpy(), want[1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(oob.numpy(), want[2])
    if simplex_from >= 0:
        assert ((w[:, simplex_from:] != 0).sum(-1) <= 4).all()
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# Renderer.render_ray_batch_incremental
# ---------------------------------------------------------------------------

MAP_TOL = {"rgb_map": 2e-5, "weights_sum": 2e-5, "classes": 2e-4, "trans_map": 2e-5}


@pytest.fixture(scope="module")
def batch_case(tmp_path_factory):
    """A JAX-written checkpoint of the synthetic scene, the port's renderer
    on it at 32x24 (CPU), the test pose's 768 rays, and JAX's
    ``render_ray_batch_incremental`` of them (infer_two_phase False, round
    16: one compile)."""
    ckpt = _write_jax_checkpoint(tmp_path_factory.mktemp("batch_incremental"))
    renderer, params, test_set, _ = cli.load_renderer(ckpt, device="cpu", out_dims=(32, 24),
                                                      max_count=1)
    _, pose = test_set[0]
    rays, _ = generate_rays(torch.from_numpy(np.asarray(pose)), renderer.intr,
                            camera_flip=renderer.settings.flip_camera)
    meta, groups = jckpt.load_checkpoint(ckpt)
    dcfg = jconf._from_dict(jconf.DatasetConfig, meta["dataset_cfg"])
    ncfg = jconf._from_dict(jconf.NetworkConfig, meta["net_cfg"])
    rcfg = jconf._from_dict(jconf.RendererConfig, meta["render_cfg"])
    train_set = jget_dataset(dcfg, split=JSplit.TRAIN)
    pe = ncfg.pos_enc
    grid = jf.make_grid_spec(pe.n_lvls, pe.n_feats_per_lvl, pe.hashmap_size, pe.min_res,
                             pe.max_res_coeff, float(np.max(np.asarray(train_set.bbox.size))))
    spec = jf.style_field_spec(grid, class_dim=train_set.num_classes)
    jparams = jckpt.restore_tree(jf.field_init(jax.random.PRNGKey(0), spec), groups["params"])
    settings = JRenderSettings(grid_size=rcfg.grid_size, min_near=rcfg.min_near,
                               t_thresh=rcfg.t_thresh, max_steps=rcfg.max_steps,
                               infer_two_phase=False)
    jr = JRenderer(spec, train_set.bbox, settings, renderer.intr, float(dcfg.bound),
                   raymarch_channels=3 + train_set.num_classes)
    jr.occ_state = jrestore(jckpt.restore_tree(jpersistable(jr.occ_state), groups["occ"]),
                            settings.grid_size)
    jr.update_occ = False
    want = jr.render_ray_batch_incremental(
        jparams, JRayBundle(jnp.asarray(rays.origins.numpy()), jnp.asarray(rays.dirs.numpy())),
        round_size=16)
    return renderer, params, rays, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("round_size", [16, None, 5])
def test_torch_render_ray_batch_incremental_matches_jax(batch_case, round_size):
    """JAX's keys, maps within the tolerances above and the counters equal
    (samples evaluated: at JAX's round 16); the default round is the
    settings' (32) whatever ``infer_two_phase`` says; no kernel launched on
    the CPU."""
    renderer, params, rays, want = batch_case
    assert renderer.settings.infer_two_phase
    kernels.reset_launch_counts()
    got = renderer.render_ray_batch_incremental(params, RayBundle(rays.origins, rays.dirs),
                                                round_size=round_size)
    assert not any(kernels.launch_counts.values())
    assert set(want) <= set(got)
    assert got["num_marched"] == int(want["num_marched"]) > len(rays)
    assert got["num_cand"] == int(want["num_cand"])
    rs = round_size or renderer.settings.infer_round_size
    assert 0 < got["rounds"] <= -(-renderer.settings.max_steps // rs) + 1
    if round_size == 16:
        assert got["num_points"] == int(want["num_points"])
    for key, atol in MAP_TOL.items():
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=2e-4, atol=atol,
                                   err_msg=key)


def test_torch_render_ray_batch_incremental_equals_frame_rounds(batch_case):
    """The batch equals ``Renderer.render_rays`` of the same rays with
    ``infer_two_phase=False`` (the same chunk function): bit for bit."""
    renderer, params, rays, _ = batch_case
    got = renderer.render_ray_batch_incremental(params, RayBundle(rays.origins, rays.dirs))
    frame_renderer = copy.copy(renderer)
    frame_renderer.settings = dataclasses.replace(renderer.settings, infer_two_phase=False)
    frame = frame_renderer.render_rays(params, rays.origins, rays.dirs)
    for key in MAP_TOL:
        assert torch.equal(got[key], frame[key]), key
    for key in ("num_marched", "num_points", "num_cand", "rounds"):
        assert got[key] == frame[key], key


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------

SURFACE = [
    (jconf.Config.print, tconf.Config.print),
    (JBaseDataset.iter_shuffled, BaseDataset.iter_shuffled),
    (jvgg.test_fx, tvgg.test_fx),
    (jc.segment_exclusive_cumsum, tc.segment_exclusive_cumsum),
    (jc.significance, tc.significance),
    (jm.occupancy_lookup, tm.occupancy_lookup),
    (jh.corner_indices_weights, th.corner_indices_weights),
    (JRenderer.render_ray_batch_incremental, Renderer.render_ray_batch_incremental),
]


@pytest.mark.parametrize("pair", SURFACE, ids=[j.__qualname__ for j, _ in SURFACE])
def test_torch_surface_signatures_match_jax(pair):
    """JAX's parameters lead the port's, in order, with JAX's defaults; the
    port may add parameters after them with defaults (``device``,
    ``plain``)."""
    jsig, tsig = (inspect.signature(f).parameters for f in pair)
    names = list(tsig)
    assert names[:len(jsig)] == list(jsig)
    for name, p in jsig.items():
        assert tsig[name].default == p.default, name
    for name in names[len(jsig):]:
        assert tsig[name].default is not inspect.Parameter.empty, name
