"""Port parity of the LLFF path: a layout written from the synthetic room
(``write_llff_layout``: cameras with y and z negated, translations over the
data config's scale 0.33) through both packages' trainers, render entry
points and the reference importer, on the CPU at a tiny size.

* One train step against the JAX trainer's with ``cfgs/renderer/llff.yaml``
  (``flip_camera`` 3) and ``min_near`` 0.2, at the tolerances of
  ``tests/test_torch_train_step.py`` (its helpers).
* The JAX-trained checkpoint rendered by ``python -m nerfstyle_torch.render
  --device cpu`` against the JAX package's ``render.py`` frame through its
  incremental renderer (``infer_two_phase=False``), at the tolerances of
  ``tests/test_torch_render.py``; the no-GT test frame is named as in JAX.
  JAX's default two-phase frame takes each sample's transmittance from an
  fp32 cumsum over the chunk's whole stream (``segment_exclusive_cumsum``):
  on this room's ~1.6 M samples a chunk, capped optical depths summing to
  millions, that moves T by up to ~1e-2 (8e-3 on rgb here), and JAX's own
  incremental frame, which composites a ray at a time, agrees with the port
  to ~2e-7 (the port sums in float64).
* ``python -m nerfstyle_torch.import_reference --root-path <the layout>``
  writes a checkpoint that renders the same frame.
* ``core/poses.py`` and ``utils.train_test_split`` equal JAX's exactly.
"""

import itertools
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu import utils as jutils
from nerfstyle_tpu.config import (
    DatasetConfig as JDatasetConfig,
    NetworkConfig as JNetworkConfig,
    RendererConfig as JRendererConfig,
    TrainConfig as JTrainConfig,
    _from_dict as jfrom_dict,
)
from nerfstyle_tpu.core import poses as jposes
from nerfstyle_tpu.core.types import DatasetSplit as JSplit
from nerfstyle_tpu.data import get_dataset as jget_dataset
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.ops.occupancy import occupancy_persistable, occupancy_restore
from nerfstyle_tpu.render.renderer import Renderer as JRenderer, RenderSettings as JRenderSettings
from nerfstyle_tpu.training import checkpoint as jckpt
from nerfstyle_torch import import_reference, interop, utils
from nerfstyle_torch.core import poses
from nerfstyle_torch.data.synthetic import generate_scene, write_llff_layout
from nerfstyle_torch.render import cli as render_cli
from nerfstyle_torch.training import checkpoint as tckpt
from test_torch_train_step import _check_third_step, _third_step

# The tolerances of tests/test_torch_render.py's cross-package frame.
MAP_TOL = {"rgb_map": 2e-5, "weights_sum": 2e-5, "classes": 2e-4, "trans_map": 2e-5}


@pytest.fixture(scope="module")
def llff(tmp_path_factory):
    root = tmp_path_factory.mktemp("llff_path")
    generate_scene(root / "scene", num_train=6, num_test=2, h=48, w=64, room=True)
    write_llff_layout(root / "scene", root / "llff", scale=0.33)
    data_cfg = root / "data.yaml"
    data_cfg.write_text(f"root_path: {root / 'llff'}\ntype: LLFF\nbound: 2.0\nscale: 0.33\n")
    return root, data_cfg


@pytest.fixture(scope="module")
def llff_step(llff, tmp_path_factory):
    """The third fp32 train step of both packages from the same state."""
    return _third_step(llff, tmp_path_factory.mktemp("llff_step"), False)


def test_torch_llff_train_step_matches_jax(llff_step):
    jt, _, tt, _ = llff_step
    for s in (jt.renderer.settings, tt.settings):
        assert (s.flip_camera, s.min_near) == (3, 0.2)
    assert tt.train_set.num_classes == jt.train_set.num_classes == 4
    _check_third_step(*llff_step, False)


def _jax_render(ckpt):
    """The JAX package's render.py for the first test pose, inlined (no
    image output), through JAX's incremental renderer."""
    meta, groups = jckpt.load_checkpoint(ckpt)
    dcfg = jfrom_dict(JDatasetConfig, meta["dataset_cfg"])
    ncfg = jfrom_dict(JNetworkConfig, meta["net_cfg"])
    rcfg = jfrom_dict(JRendererConfig, meta["render_cfg"])
    tcfg = jfrom_dict(JTrainConfig, meta["train_cfg"])
    train_set = jget_dataset(dcfg, split=JSplit.TRAIN)
    test_set = jget_dataset(dcfg, split=JSplit.TEST, max_count=1)
    pe = ncfg.pos_enc
    grid = jf.make_grid_spec(pe.n_lvls, pe.n_feats_per_lvl, pe.hashmap_size, pe.min_res,
                             pe.max_res_coeff, float(np.max(np.asarray(train_set.bbox.size))))
    spec = jf.style_field_spec(grid, class_dim=train_set.num_classes,
                               density_offset=ncfg.density_offset)
    params = jckpt.restore_tree(jf.field_init(jax.random.PRNGKey(0), spec), groups["params"])
    settings = JRenderSettings(
        grid_size=rcfg.grid_size, update_iter=rcfg.update_iter, min_near=rcfg.min_near,
        t_thresh=rcfg.t_thresh, use_ndc=rcfg.use_ndc, flip_camera=rcfg.flip_camera,
        max_steps=rcfg.max_steps, update_thres=rcfg.update_thres,
        density_scale=rcfg.density_scale, density_thresh=rcfg.density_thresh,
        density_decay=rcfg.density_decay, max_samples_per_ray=rcfg.max_samples_per_ray,
        max_budget_samples=rcfg.max_budget_samples, infer_two_phase=False)
    renderer = JRenderer(spec, train_set.bbox, settings, test_set.intr, float(dcfg.bound),
                         raymarch_channels=3 + train_set.num_classes,
                         compute_dtype=jnp.bfloat16 if tcfg.enable_amp else jnp.float32)
    renderer.occ_state = occupancy_restore(
        jckpt.restore_tree(occupancy_persistable(renderer.occ_state), groups["occ"]),
        settings.grid_size)
    renderer.load_state_dict_static(meta["renderer_static"])
    renderer.update_occ = False
    _, pose = test_set[0]
    return renderer.render(params, jnp.asarray(pose), None, training=False), test_set.fns[0]


def _reference_pth(ckpt, out):
    """The checkpoint as a reference ``iter_*.pth`` (config objects of a
    module absent at unpickle time, Morton-ordered packed occupancy) and its
    heads as ``<net>.<i>`` arrays; the dataset root is not the layout's."""
    mod = types.ModuleType("llff_reference_cfg")
    mod.Cfg = type("Cfg", (), {"__module__": mod.__name__})
    sys.modules[mod.__name__] = mod

    def cfg(**fields):
        obj = mod.Cfg()
        obj.__dict__.update(fields)
        return obj

    meta, groups = tckpt.load_checkpoint(ckpt)
    net = meta["net_cfg"]
    layers = types.SimpleNamespace(density_hidden_layers=net["density_hidden_layers"],
                                   rgb_hidden_layers=net["rgb_hidden_layers"])
    params = tckpt.restore_tree(render_cli.param_template(layers), groups["params"])
    grid_size = meta["render_cfg"]["grid_size"]
    density, bits = (torch.from_numpy(np.asarray(groups["occ"][i])) for i in (0, 1))
    state = {
        "version": "reference", "iter_ctr": 3, "cfg": cfg(style_image=None),
        "dataset_cfg": cfg(**{**meta["dataset_cfg"], "root_path": "/nonexistent"}),
        "train_cfg": cfg(**meta["train_cfg"]),
        "net_cfg": cfg(**{**net, "pos_enc": cfg(**net["pos_enc"])}),
        "render_cfg": cfg(**meta["render_cfg"]),
        "renderer": {
            "model": {"x_density_embedder.embeddings": params["x_density_embedder"],
                      "x_color_embedder.embeddings": params["x_color_embedder"]},
            "raymarch_channels": meta["renderer_static"]["raymarch_channels"],
            "bound": meta["renderer_static"]["bound"],
            "density_grid": interop.linear_grid_to_morton(density, grid_size, plain=True),
            "density_bitfield": interop.linear_bitfield_to_reference(bits, grid_size, plain=True),
        },
    }
    torch.save(state, out / "iter_3.pth")
    del sys.modules[mod.__name__]
    np.savez(out / "heads.npz", **{f"{k}.{i}": w.numpy() for k in import_reference.HEADS
                                   for i, w in enumerate(params[k])})
    return out / "iter_3.pth", out / "heads.npz"


def test_torch_renders_jax_llff_checkpoint_and_its_import(llff, llff_step, tmp_path):
    root, _ = llff
    jt = llff_step[0]
    jt.save_ckpt()
    (ckpt,) = jt.log_dir.glob("iter_*.ckpt")
    want, fn = _jax_render(ckpt)
    summary = render_cli.main([str(ckpt), "--device", "cpu", "--max-count", "1", "--yes",
                               "--out-dir", str(tmp_path / "render")])
    got = summary["last"]
    assert summary["frames"] == 1 and got["rgb_map"].shape == (48 * 64, 3)
    assert 0 < got["num_sig"] <= got["num_marched"]
    for key, atol in MAP_TOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=2e-4,
                                   atol=atol, err_msg=key)
    # The test split has no frames: its views are named frame_<i> in both.
    assert fn == "frame_0" and (tmp_path / "render" / "frame_0.png").exists()

    pth, heads = _reference_pth(ckpt, tmp_path)
    imported = import_reference.main([str(pth), "--out", str(tmp_path / "imported.ckpt"),
                                      "--mlp-npz", str(heads), "--root-path", str(root / "llff"),
                                      "--device", "cpu"])
    again = render_cli.main([str(imported), "--device", "cpu", "--max-count", "1", "--yes",
                             "--out-dir", str(tmp_path / "render_imported")])["last"]
    for key in MAP_TOL:
        torch.testing.assert_close(again[key], got[key], rtol=0, atol=1e-6)


COORDS = ["".join(c) for c in itertools.product("rlfbud", repeat=3)] + ["rd", "rdfu", "xyz"]


def test_torch_poses_match_jax():
    valid = []
    for c in COORDS:
        try:
            want = jposes.get_canonical_coord_mtx(c)
        except ValueError:
            with pytest.raises(ValueError):
                poses.get_canonical_coord_mtx(c)
            continue
        np.testing.assert_array_equal(poses.get_canonical_coord_mtx(c), want)
        valid.append(c)
    assert len(valid) == 24
    rng = np.random.default_rng(0)
    mats = rng.normal(size=(5, 4, 4)).astype(np.float32)
    for w in valid:
        for c in valid[::5]:
            got = poses.convert_poses(mats, w_coord=w, c_coord=c)
            want = jposes.convert_poses(mats, w_coord=w, c_coord=c)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(poses.average_pose(mats), jposes.average_pose(mats))
    np.testing.assert_array_equal(poses.spiral_poses(mats[0], 0.3, 7),
                                  jposes.spiral_poses(mats[0], 0.3, 7))


@pytest.mark.parametrize("total, every", [(0, 8), (1, 8), (17, 8), (48, 8), (10, 3)])
def test_torch_train_test_split_matches_jax(total, every):
    for is_train in (True, False):
        assert (utils.train_test_split(total, every, is_train)
                == jutils.train_test_split(total, every, is_train))
