"""Port parity of ``Renderer.render``'s whole surface (``image``, ``patch``,
``num_rays``, ``training``, ``chunk``) against the JAX package's
``Renderer.render`` on the CPU, on one JAX-written checkpoint of the
synthetic scene at 16x12 (tests/test_torch_render.py's), both renderers
built once for the module.

* Inference over the frame and over a patch, with an image: the target
  JAX's exactly; the patch equal to the same crop of the port's own frame
  within 1e-6 (a chunk of other rays may block its matmuls otherwise;
  the frame's maps are held against JAX's ``render`` through the render
  CLI in tests/test_torch_render.py, whose JAX inference compile this file
  does not repeat); a smaller ``chunk`` leaves the frame within 1e-6.
* ``training`` over the frame and over a patch: the train path in chunks,
  against JAX's ``render(training=True)`` (its ``render_ray_batch`` chunk
  by chunk): the maps within tests/test_torch_render.py's tolerances
  (``MAP_TOL``, rtol 2e-4), the target exactly.
* ``training`` with ``num_rays``: the pixels differ from JAX's draw (its
  PRNG against a ``torch.Generator``), so the port's batch is held against
  JAX's ``render_ray_batch`` on the port's rays (``MAP_TOL``), and every
  target against its ray's pixel of the image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_torch.core.types import Box2D
from nerfstyle_torch.render import cli
from nerfstyle_tpu.config import (DatasetConfig as JDatasetConfig,
                                  NetworkConfig as JNetworkConfig,
                                  RendererConfig as JRendererConfig, _from_dict)
from nerfstyle_tpu.core.types import Box2D as JBox2D, DatasetSplit as JSplit, RayBundle
from nerfstyle_tpu.data import get_dataset as jget_dataset
from nerfstyle_tpu.models import fields as jf
from nerfstyle_tpu.ops.occupancy import (occupancy_persistable as jpersistable,
                                         occupancy_restore as jrestore)
from nerfstyle_tpu.render.renderer import Renderer as JRenderer, RenderSettings as JRenderSettings
from nerfstyle_tpu.training import checkpoint as jckpt
from test_torch_render import MAP_TOL, _write_jax_checkpoint

W, H = 16, 12
PATCH = (3, 2, 9, 7)  # x, y, w, h


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX renderer, JAX params, port renderer, port params, pose, image)."""
    path = _write_jax_checkpoint(tmp_path_factory.mktemp("render_api"))
    meta, groups = jckpt.load_checkpoint(path)
    dcfg = _from_dict(JDatasetConfig, meta["dataset_cfg"])
    ncfg = _from_dict(JNetworkConfig, meta["net_cfg"])
    rcfg = _from_dict(JRendererConfig, meta["render_cfg"])
    train_set = jget_dataset(dcfg, split=JSplit.TRAIN)
    test_set = jget_dataset(dcfg, split=JSplit.TEST, max_count=1)
    pe = ncfg.pos_enc
    grid = jf.make_grid_spec(pe.n_lvls, pe.n_feats_per_lvl, pe.hashmap_size, pe.min_res,
                             pe.max_res_coeff, float(np.max(np.asarray(train_set.bbox.size))))
    spec = jf.style_field_spec(grid, class_dim=train_set.num_classes)
    jparams = jckpt.restore_tree(jf.field_init(jax.random.PRNGKey(0), spec), groups["params"])
    settings = JRenderSettings(grid_size=rcfg.grid_size, min_near=rcfg.min_near,
                               t_thresh=rcfg.t_thresh, max_steps=rcfg.max_steps)
    jr = JRenderer(spec, train_set.bbox, settings, test_set.intr.scale(W, H), float(dcfg.bound),
                   raymarch_channels=3 + train_set.num_classes)
    jr.occ_state = jrestore(jckpt.restore_tree(jpersistable(jr.occ_state), groups["occ"]),
                            settings.grid_size)
    jr.update_occ = False
    tr, tparams, _, _ = cli.load_renderer(path, "cpu", (W, H), max_count=1)
    _, pose = test_set[0]
    image = np.random.default_rng(0).random((4, H, W)).astype(np.float32)
    return jr, jparams, tr, tparams, np.asarray(pose, np.float32), image


def _maps_close(got, want, keys=tuple(MAP_TOL)):
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=2e-4,
                                   atol=MAP_TOL[key], err_msg=key)


@pytest.mark.parametrize("patch", [None, PATCH], ids=["frame", "patch"])
def test_torch_render_image_and_patch_match_jax(both, patch):
    """Inference: the target JAX's (its ``generate_rays``, which its
    ``render`` calls), the patch's maps the same crop of the port's frame
    (whose maps tests/test_torch_render.py holds against JAX's through the
    render CLI), a smaller chunk the same frame; the train path over the
    frame or the patch against JAX's ``render(training=True)``."""
    from nerfstyle_tpu.core.cameras import generate_rays as jgenerate_rays

    jr, jparams, tr, tparams, pose, image = both
    jpatch, tpatch = (None, None) if patch is None else (JBox2D(*patch), Box2D(*patch))
    got = tr.render(tparams, torch.from_numpy(pose), torch.from_numpy(image), patch=tpatch)
    n = W * H if patch is None else PATCH[2] * PATCH[3]
    assert got["rgb_map"].shape == (n, 3) and got["target"].shape == (n, 4)
    _, want_target = jgenerate_rays(jnp.asarray(pose), jr.intr, jnp.asarray(image), patch=jpatch,
                                    camera_flip=jr.settings.flip_camera)
    np.testing.assert_array_equal(got["target"].numpy(), np.asarray(want_target))
    assert 0 < got["num_sig"] <= got["num_marched"]
    frame = tr.render(tparams, torch.from_numpy(pose))
    assert frame["target"] is None
    if patch is not None:
        x, y, w, h = PATCH
        crop = (np.arange(y, y + h)[:, None] * W + np.arange(x, x + w)[None]).reshape(-1)
        for key in MAP_TOL:
            torch.testing.assert_close(got[key], frame[key][crop], rtol=0, atol=1e-6)
    else:
        small = tr.render(tparams, torch.from_numpy(pose), chunk=50)
        for key in MAP_TOL:
            torch.testing.assert_close(small[key], got[key], rtol=0, atol=1e-6)
            torch.testing.assert_close(frame[key], got[key], rtol=0, atol=0)
    want = jr.render(jparams, jnp.asarray(pose), jnp.asarray(image), patch=jpatch,
                     training=True, chunk=64)
    train = tr.render(tparams, torch.from_numpy(pose), torch.from_numpy(image), patch=tpatch,
                      training=True)
    np.testing.assert_array_equal(train["target"].numpy(), np.asarray(want["target"]))
    _maps_close(train, want)


def test_torch_render_training_patch_matches_jax(both):
    """The train path over a patch, in chunks smaller than it (JAX's of 64
    rays, the port's of 32)."""
    jr, jparams, tr, tparams, pose, image = both
    want = jr.render(jparams, jnp.asarray(pose), jnp.asarray(image), patch=JBox2D(*PATCH),
                     training=True, chunk=64)
    got = tr.render(tparams, torch.from_numpy(pose), torch.from_numpy(image),
                    patch=Box2D(*PATCH), training=True, chunk=32)
    np.testing.assert_array_equal(got["target"].numpy(), np.asarray(want["target"]))
    _maps_close(got, want)
    assert got["num_points"] > 0


def test_torch_render_training_ray_batch(both):
    jr, jparams, tr, tparams, pose, image = both
    gen = torch.Generator().manual_seed(3)
    got = tr.render(tparams, torch.from_numpy(pose), torch.from_numpy(image), num_rays=64,
                    training=True, generator=gen)
    assert got["rgb_map"].shape == (64, 3) and bool(torch.isfinite(got["rgb_map"]).all())
    idx = torch.randperm(W * H, generator=torch.Generator().manual_seed(3))[:64]
    want_target = image.reshape(4, -1)[:, idx.numpy()].T
    np.testing.assert_array_equal(got["target"].numpy(), want_target)
    assert len(set(idx.tolist())) == 64
    from nerfstyle_torch.core.cameras import generate_rays

    rays, _ = generate_rays(torch.from_numpy(pose), tr.intr, num_rays=64,
                            camera_flip=tr.settings.flip_camera,
                            generator=torch.Generator().manual_seed(3))
    want = jr.render_ray_batch(jparams, RayBundle(jnp.asarray(rays.origins.numpy()),
                                                  jnp.asarray(rays.dirs.numpy())))
    _maps_close(got, want)
    # The same draw through the inference path: the same target, other maps.
    inf = tr.render(tparams, torch.from_numpy(pose), torch.from_numpy(image), num_rays=64,
                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(inf["target"], got["target"])
