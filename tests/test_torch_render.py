"""Port parity for the whole render slice: the two-phase chunk renderer vs
the JAX ``make_two_phase_renderer``, a JAX-written checkpoint rendered by
``python -m nerfstyle_torch.render --device cpu`` vs the JAX
``Renderer.render``, checkpoint round trips, and the port's independence
from JAX.
"""

import ast
import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.config import (
    DatasetConfig as JDatasetConfig,
    HashGridConfig as JHashGridConfig,
    NetworkConfig as JNetworkConfig,
    RendererConfig as JRendererConfig,
    TrainConfig as JTrainConfig,
)
from nerfstyle_tpu.core.types import BBox as JBBox, DatasetSplit as JSplit, make_rays
from nerfstyle_tpu.data import get_dataset as jget_dataset
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_tpu.ops.marching import MarchPlan as JMarchPlan
from nerfstyle_tpu.ops.occupancy import (
    PersistedOccupancy as JPersisted,
    occupancy_persistable as jpersistable,
    occupancy_restore as jrestore,
)
from nerfstyle_tpu.render.renderer import (
    Renderer as JRenderer,
    RenderSettings as JRenderSettings,
    make_two_phase_renderer,
)
from nerfstyle_tpu.training import checkpoint as jckpt
from nerfstyle_torch import kernels, resolve_device
from nerfstyle_torch.core.types import BBox
from nerfstyle_torch.models import fields as tf
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_torch.ops.marching import MarchPlan
from nerfstyle_torch.ops.occupancy import PersistedOccupancy
from nerfstyle_torch.render import cli
from nerfstyle_torch.render.renderer import render_chunk
from nerfstyle_torch.training import checkpoint as tckpt

REPO = Path(__file__).resolve().parent.parent
GRID = dict(num_levels=4, level_dim=2, base_resolution=8, per_level_scale=1.5,
            log2_hashmap_size=10)
N_RAYS = 32
# The tolerances of tests/test_render_incremental.py (fp reduction order).
MAP_TOL = {"rgb_map": 2e-5, "weights_sum": 2e-5, "classes": 2e-4, "trans_map": 2e-5}


def _jax_params(spec, seed=0):
    params = jf.field_init(jax.random.PRNGKey(seed), spec)
    rng = np.random.default_rng(seed)
    for k in ("x_density_embedder", "x_color_embedder"):  # widen the ±1e-4 init
        params[k] = jnp.asarray(rng.uniform(-1, 1, params[k].shape).astype(np.float32))
    return params


@pytest.fixture(scope="module")
def chunk_setup():
    # density_offset 2: sigma ~ e^2, rays saturate within the box, so phase B
    # sees insignificant samples to drop.
    spec_j = jf.style_field_spec(jh.hashgrid_spec(**GRID), class_dim=3, density_offset=2.0)
    spec_t = tf.style_field_spec(th.hashgrid_spec(**GRID), class_dim=3, density_offset=2.0)
    params_j = _jax_params(spec_j)
    params_t = tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, params_j))
    rng = np.random.default_rng(0)
    bits = rng.random(16**3) < 0.4
    o = rng.uniform(-2.5, 2.5, size=(N_RAYS, 3)).astype(np.float32)
    d = (rng.uniform(-0.8, 0.8, size=(N_RAYS, 3)) - o).astype(np.float32)  # most hit the box
    rays = make_rays(jnp.asarray(o), jnp.asarray(d))
    return spec_j, spec_t, params_j, params_t, bits, rays


@pytest.mark.parametrize("sig_eps", [0.0, 1e-5])
def test_torch_two_phase_chunk_matches_jax(chunk_setup, sig_eps):
    spec_j, spec_t, params_j, params_t, bits, rays = chunk_setup
    plan_j = JMarchPlan(bound=1.0, cascade=1, grid_size=16, max_steps=128,
                        num_rays=N_RAYS, budget=N_RAYS * 128, min_near=0.05)
    render_j = make_two_phase_renderer(spec_j, plan_j, 1e-4, 1.0, sig_eps=sig_eps,
                                       sig_per_ray=128)
    want = render_j(params_j, jnp.asarray(bits), JBBox.from_radius(1.0), rays, 6)
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
    for key, atol in MAP_TOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=2e-4, atol=atol, err_msg=key)


def test_torch_render_chunk_split_into_field_batches(chunk_setup):
    """Field batches (a memory bound) leave the output unchanged, up to the
    matmul's blocking, which may round differently at another batch size."""
    _, spec_t, _, params_t, bits, rays = chunk_setup
    plan = MarchPlan(bound=1.0, cascade=1, grid_size=16, max_steps=128, min_near=0.05)
    args = (spec_t, plan, params_t, torch.from_numpy(bits), BBox.from_radius(1.0),
            torch.tensor(np.asarray(rays.origins)), torch.tensor(np.asarray(rays.dirs)))
    whole = render_chunk(*args, t_thresh=1e-4, density_scale=1.0)
    pieces = render_chunk(*args, t_thresh=1e-4, density_scale=1.0, field_batch=37)
    for key in MAP_TOL:
        torch.testing.assert_close(whole[key], pieces[key], rtol=1e-6, atol=1e-6)


def test_torch_entry_points_need_cuda_unless_cpu_is_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()


# ---------------------------------------------------------------------------
# A JAX-written checkpoint, rendered by both packages
# ---------------------------------------------------------------------------


def _write_jax_checkpoint(root: Path) -> Path:
    dataset_cfg = JDatasetConfig(root_path=root / "scene", type="Synthetic", bound=1.0)
    net_cfg = JNetworkConfig(pos_enc=JHashGridConfig(n_lvls=4, n_feats_per_lvl=2,
                                                     hashmap_size=10, min_res=8,
                                                     max_res_coeff=8))
    render_cfg = JRendererConfig(grid_size=16, max_steps=128, min_near=0.05)
    train_cfg = JTrainConfig(enable_amp=False)
    train_set = jget_dataset(dataset_cfg, split=JSplit.TRAIN)
    grid = jf.make_grid_spec(4, 2, 10, 8, 8, float(np.max(np.asarray(train_set.bbox.size))))
    spec = jf.style_field_spec(grid, class_dim=train_set.num_classes)
    rng = np.random.default_rng(1)
    bits = rng.random(16**3) < 0.3
    occ = JPersisted(jnp.zeros((1, 16**3)), jnp.asarray(bits), jnp.float32(0.0),
                     jnp.int32(0), jnp.int32(0))
    meta = {
        "version": "test", "log_dir": str(root / "log"), "iter_ctr": 0,
        "dataset_cfg": dataset_cfg.asdict(), "train_cfg": train_cfg.asdict(),
        "net_cfg": net_cfg.asdict(), "render_cfg": render_cfg.asdict(),
        "renderer_static": {"raymarch_channels": 3 + train_set.num_classes, "bound": 1.0},
    }
    path = root / "jax.ckpt"
    jckpt.save_checkpoint(path, meta, {"params": _jax_params(spec, 1), "occ": occ})
    return path


def _jax_render(ckpt_path: Path, w: int, h: int):
    """The JAX package's render.py, inlined (without its image output)."""
    from nerfstyle_tpu.config import _from_dict

    meta, groups = jckpt.load_checkpoint(ckpt_path)
    dcfg = _from_dict(JDatasetConfig, meta["dataset_cfg"])
    ncfg = _from_dict(JNetworkConfig, meta["net_cfg"])
    rcfg = _from_dict(JRendererConfig, meta["render_cfg"])
    train_set = jget_dataset(dcfg, split=JSplit.TRAIN)
    test_set = jget_dataset(dcfg, split=JSplit.TEST, max_count=1)
    pe = ncfg.pos_enc
    grid = jf.make_grid_spec(pe.n_lvls, pe.n_feats_per_lvl, pe.hashmap_size, pe.min_res,
                             pe.max_res_coeff, float(np.max(np.asarray(train_set.bbox.size))))
    spec = jf.style_field_spec(grid, class_dim=train_set.num_classes)
    params = jckpt.restore_tree(jf.field_init(jax.random.PRNGKey(0), spec), groups["params"])
    settings = JRenderSettings(grid_size=rcfg.grid_size, min_near=rcfg.min_near,
                               t_thresh=rcfg.t_thresh, max_steps=rcfg.max_steps)
    renderer = JRenderer(spec, train_set.bbox, settings, test_set.intr.scale(w, h),
                         float(dcfg.bound), raymarch_channels=3 + train_set.num_classes)
    renderer.occ_state = jrestore(
        jckpt.restore_tree(jpersistable(renderer.occ_state), groups["occ"]), settings.grid_size
    )
    renderer.update_occ = False
    _, pose = test_set[0]
    return renderer.render(params, jnp.asarray(pose), None, training=False)


def _read_png(path: Path) -> np.ndarray:
    """Decode the port's own 8-bit RGB PNG (filter 0 on every row)."""
    data = path.read_bytes()
    pos, idat, (w, h) = 8, b"", (0, 0)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert np.all(rows[:, 0] == 0)
    return rows[:, 1:].reshape(h, w, 3)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("render")
    path = _write_jax_checkpoint(root)
    return path, _jax_render(path, 16, 12)


def test_torch_cli_renders_jax_checkpoint_like_jax(jax_checkpoint, tmp_path):
    ckpt, want = jax_checkpoint
    summary = cli.main([str(ckpt), "--out-dims", "16", "12", "--max-count", "1",
                        "--device", "cpu", "--yes", "--out-dir", str(tmp_path / "out")])
    got = summary["last"]
    assert summary["frames"] == 1 and got["rgb_map"].shape == (16 * 12, 3)
    # (The JAX counters also count the rays that pad its frame to a chunk.)
    assert 0 < got["num_sig"] <= got["num_marched"]
    for key, atol in MAP_TOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=2e-4, atol=atol, err_msg=key)


def test_torch_cli_module_runs_without_jax(jax_checkpoint, tmp_path):
    """``python -m nerfstyle_torch.render`` in a process where importing jax
    fails; its PNG equals the JAX frame to 8-bit rounding."""
    ckpt, want = jax_checkpoint
    out = tmp_path / "out"
    argv = [str(ckpt), "--out-dims", "16", "12", "--max-count", "1", "--device", "cpu",
            "--yes", "--out-dir", str(out)]
    code = (
        "import runpy, sys; sys.modules['jax'] = None; sys.modules['nerfstyle_tpu'] = None; "
        f"sys.argv = ['render'] + {argv!r}; "
        "runpy.run_module('nerfstyle_torch.render', run_name='__main__')"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FPS" in proc.stdout
    (png,) = sorted(out.glob("*.png"))
    img = _read_png(png).astype(np.int32)
    ref = (np.clip(np.asarray(want["rgb_map"]), 0, 1) * 255).astype(np.int32).reshape(12, 16, 3)
    assert np.abs(img - ref).max() <= 1


def test_torch_checkpoint_round_trip_and_jax_order(tmp_path):
    spec = tf.style_field_spec(th.hashgrid_spec(**GRID), class_dim=3)
    params = tf.field_init(spec, torch.Generator().manual_seed(3))
    occ = PersistedOccupancy(torch.rand(1, 8), torch.rand(8) > 0.5, torch.tensor(0.25),
                             torch.tensor(7, dtype=torch.int32), torch.tensor(3, dtype=torch.int32))
    path = tmp_path / "port.ckpt"
    tckpt.save_checkpoint(path, {"note": "x"}, {"params": params, "occ": occ})
    meta, groups = tckpt.load_checkpoint(path)
    assert meta["note"] == "x"
    back = tckpt.restore_tree(params, groups["params"])
    occ_back = tckpt.restore_tree(occ, groups["occ"])
    for k, v in params.items():
        for a, b in zip(v if isinstance(v, list) else [v], back[k] if isinstance(v, list) else [back[k]]):
            assert torch.equal(a, b)
    assert isinstance(occ_back, PersistedOccupancy)
    for a, b in zip(occ, occ_back):
        assert torch.equal(a, b) and a.dtype == b.dtype
    # The JAX package reads the port's file in its own leaf order.
    jmeta, jgroups = jckpt.load_checkpoint(path)
    jparams = tf.params_to_numpy(params)
    jleaves = jax.tree_util.tree_leaves(jparams)
    assert len(jleaves) == len(jgroups["params"])
    for a, b in zip(jleaves, jgroups["params"]):
        np.testing.assert_array_equal(a, b)
    jocc = jckpt.restore_tree(JPersisted(*[np.zeros(1)] * 5), jgroups["occ"])
    np.testing.assert_array_equal(np.asarray(jocc.bitfield), occ.bitfield.numpy())


def test_torch_launch_counts_untouched_on_cpu(chunk_setup):
    _, spec_t, _, params_t, bits, rays = chunk_setup
    plan = MarchPlan(bound=1.0, cascade=1, grid_size=16, max_steps=128, min_near=0.05)
    kernels.reset_launch_counts()
    render_chunk(spec_t, plan, params_t, torch.from_numpy(bits), BBox.from_radius(1.0),
                 torch.tensor(np.asarray(rays.origins)), torch.tensor(np.asarray(rays.dirs)),
                 t_thresh=1e-4, density_scale=1.0)
    assert all(v == 0 for v in kernels.launch_counts.values())


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------


def _port_files():
    return sorted((REPO / "nerfstyle_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_torch_sources_import_no_jax():
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "nerfstyle_tpu"), f"{path}: imports {name}"


def test_torch_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['nerfstyle_tpu'] = None\n"
        "import nerfstyle_torch\n"
        "names = ['nerfstyle_torch'] + [m.name for m in pkgutil.walk_packages("
        "nerfstyle_torch.__path__, 'nerfstyle_torch.') if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(json.dumps(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    for expected in ("nerfstyle_torch.kernels", "nerfstyle_torch.render.renderer",
                     "nerfstyle_torch.render.cli", "nerfstyle_torch.training.checkpoint",
                     "nerfstyle_torch.data.synthetic"):
        assert expected in names
