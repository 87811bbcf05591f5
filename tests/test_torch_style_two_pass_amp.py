"""Port parity of the style stage's two-pass scheme (``style_geom_cache``
false) against the JAX package's StyleTrainer on the CPU under AMP (the
default), and the port-only checks of the scheme (the windows against one
whole-image VJP, the two schemes' equality at eps 0, the entry point).  The
fp32 parity tests are in ``tests/test_torch_style_two_pass.py``; the
set-up and the tolerances' reasons: ``tests/style_two_pass_common.py``."""

import numpy as np
import pytest
import torch

import style_two_pass_common as common
from nerfstyle_torch import train
from nerfstyle_torch.training import checkpoint as ckpt_lib
from nerfstyle_torch.training.style_trainer import StyleTrainer
from nerfstyle_tpu.training import checkpoint as jckpt


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """A 32x24 scene, a port-written stage-1 checkpoint (40 steps), a style
    PNG and a 4-quadrant segment map (one a run, shared by both two-pass
    files)."""
    return common.make_stage1(tmp_path_factory)


@pytest.fixture(scope="module")
def pair(stage1, tmp_path_factory):
    """The two-pass JAX and port trainers (AMP on), built once."""
    return common.make_pair(stage1, tmp_path_factory, amp=True)


@pytest.mark.parametrize("amp", [True])
def test_torch_two_pass_iter_matches_jax(pair, amp):
    """One two-pass iteration of both trainers from the same checkpoint
    (AMP): see ``style_two_pass_common.check_two_pass_iter``."""
    jt, tt = pair
    common.check_two_pass_iter(jt, tt, amp)


def test_torch_pass2_windows_equal_whole_image_vjp(stage1, tmp_path):
    """The port alone: the sum over the shifted windows of each window's VJP
    of its owned pixels equals one VJP of the whole frame's render.  The
    same samples and the same arithmetic, only the table gradient's sums in
    another order: rtol 5e-3, atol 2e-3 of the largest (JAX's own test)."""
    _, tt = common.trainers(stage1, tmp_path, common.TWO_PASS, jax_side=False)
    pose = common.first_pose(tt)
    cot = torch.from_numpy(common.cot(4))
    g_win = tt.window_grads(tt.params, pose, cot)["x_color_embedder"]
    out = tt._render_rays(tt.params, tt.pose_rays(pose))
    (g_full,) = torch.autograd.grad(out["rgb_map"], tt.params["x_color_embedder"], cot)
    np.testing.assert_allclose(g_win.numpy(), g_full.numpy(), rtol=5e-3,
                               atol=2e-3 * float(g_full.abs().max()))


def test_torch_two_pass_equals_cached_step(stage1, tmp_path):
    """The port alone: at ``style_geom_cache_eps`` 0 the cache keeps every
    sample of nonzero weight, so the cached step and the two-pass step (pass
    1, the pixel gradient, pass 2) composite the same samples; with the
    matching fixed: loss rtol 1e-4, the table gradient rtol 5e-3 and atol
    2e-3 of the largest (JAX's own test of the two schemes)."""
    extra = ["--style_matching", "0,1,2,3", "--style_geom_cache_eps", "0.0"]
    _, cached = common.trainers(stage1, tmp_path / "c", extra, jax_side=False)
    _, two = common.trainers(stage1, tmp_path / "t", extra + common.TWO_PASS, jax_side=False)
    pose = common.first_pose(two)
    losses_c, grads_c = cached.loss_and_grads(cached.geom_cache(pose))
    rgb, cls = two.render_frame(two.params, pose)
    losses_t, pix = two.pixel_grad(rgb, two.target(pose), two._preds(cls))
    grads_t = two.window_grads(two.params, pose, pix)
    np.testing.assert_allclose(float(losses_t["total"]), float(losses_c["total"]), rtol=1e-4)
    a, b = grads_t["x_color_embedder"].numpy(), grads_c["x_color_embedder"].numpy()
    np.testing.assert_allclose(a, b, rtol=5e-3, atol=2e-3 * np.abs(b).max())
    assert all(grads_t[k] is None and grads_c[k] is None for k in grads_t
               if k != "x_color_embedder")


def test_torch_two_pass_entry_point(stage1, tmp_path):
    """``python -m nerfstyle_torch.train --device cpu --style_geom_cache``:
    two two-pass iterations (each with its four phase times), finite
    losses, no pose cache built, and a checkpoint that the JAX package's
    reader loads, whose leaves other than x_color_embedder are the stage-1
    ones."""
    _, data_cfg, ckpt, png, seg = stage1
    st = train.main(["--device", "cpu", "--ckpt", str(ckpt), "--log-dir", str(tmp_path / "style"),
                     "--data-cfg", str(data_cfg), "--style-image", str(png), "--style_seg_path",
                     str(seg), "--num_iterations", "2", "--test_before_train", "--yes",
                     *common.NET, *common.QUIET[:-2], "--intervals.ckpt", "2", *common.TWO_PASS])
    assert isinstance(st, StyleTrainer) and not st.train_cfg.style_geom_cache
    assert st.iter_ctr == 2 and not st._geom_cache and len(st.two_pass_ms) == 2
    assert all(np.isfinite(float(h["total"])) for h in st.loss_history)
    path = tmp_path / "style" / "iter_2.ckpt"
    meta, groups = jckpt.load_checkpoint(path)
    assert meta["iter_ctr"] == 2
    _, before = ckpt_lib.load_checkpoint(ckpt)
    p0 = ckpt_lib.restore_tree(st.params, before["params"])
    p1 = ckpt_lib.restore_tree(st.params, groups["params"])
    for k in p0:
        same = all(torch.equal(a, b) for a, b in zip(ckpt_lib.tree_flatten(p0[k]),
                                                    ckpt_lib.tree_flatten(p1[k])))
        assert same == (k != "x_color_embedder"), k
