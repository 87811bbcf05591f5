"""Port parity of the style stage's two-pass scheme (``style_geom_cache``
false) and of the style cache's view-direction input against the JAX
package's StyleTrainer on the CPU, in fp32 (``--enable_amp`` toggled off);
the AMP iteration and the port-only checks are in
``tests/test_torch_style_two_pass_amp.py``.  The set-up and the tolerances'
reasons: ``tests/style_two_pass_common.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import style_two_pass_common as common
from nerfstyle_torch import kernels
from nerfstyle_torch.training.style_trainer import _tile_windows
from style_two_pass_common import H, W
from nerfstyle_tpu.training import style_trainer as jstyle


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """A 32x24 scene, a port-written stage-1 checkpoint (40 steps), a style
    PNG and a 4-quadrant segment map (this file's own)."""
    yield from common.make_stage1(tmp_path_factory)


@pytest.fixture(scope="module")
def pair(stage1, tmp_path_factory):
    """The two-pass JAX and port trainers (AMP off), built once."""
    return common.make_pair(stage1, tmp_path_factory, amp=False)


@pytest.mark.parametrize("w,h,ps", [(32, 24, 8), (32, 24, 20), (64, 48, 24), (504, 378, 200),
                                    (32, 24, 200)])
def test_torch_tile_windows_matches_jax(w, h, ps):
    """Bit-equal to JAX's tiling: sizes that divide, that do not (the last
    window of a row and of a column shifted inward), and a patch above the
    frame (one window); each pixel owned by exactly one window."""
    pw, ph = min(ps, w), min(ps, h)
    idx, own = _tile_windows(w, h, pw, ph)
    idx_j, own_j = jstyle._tile_windows(w, h, pw, ph)
    assert idx.dtype == idx_j.dtype and own.dtype == own_j.dtype
    np.testing.assert_array_equal(idx, idx_j)
    np.testing.assert_array_equal(own, own_j)
    owners = np.zeros(w * h)
    np.add.at(owners, idx.reshape(-1), own.reshape(-1))
    np.testing.assert_array_equal(owners, 1.0)


def test_torch_pass2_grads_match_jax(pair):
    """Pass 2's colour-table gradient for a numpy-seeded cotangent, summed
    over the shifted windows, against JAX's ``_pass2_grads`` on the same
    checkpoint and pose (fp32), no kernel launched.  JAX takes each weight
    from an fp32 cumsum over a window's stream, the port's plain compositor
    from float64 sums, and the table gradients add in other orders: relative
    L2 error 1e-4 (measured 1.3e-5), each entry within 1e-4 of the
    largest."""
    jt, tt = pair
    pose = common.first_pose(tt)
    common.no_truncation(jt, pose)
    cot = common.cot(3)
    g_j = common.jax_pass2(jt, pose, cot)
    kernels.reset_launch_counts()
    g_t = tt.window_grads(tt.params, pose, torch.from_numpy(cot))["x_color_embedder"].numpy()
    assert not any(kernels.launch_counts.values())
    assert common.rel_l2(g_t, g_j) <= 1e-4
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-4 * np.abs(g_j).max())


def test_torch_use_dir_cached_step_matches_jax(pair):
    """The cache's view directions: with the ``use_dir`` field in both
    trainers, one cached step (fp32): the cache keeps each sample's unit
    direction (counted in its bytes); the matching equal, the losses (rtol
    1e-5) and the table gradient (atol 2e-3 of the largest), the cached
    step's tolerances."""
    jt, tt = pair
    pose = common.first_pose(tt)
    with common.use_dir(jt, tt):
        image, pose_np = jt.train_set[pose]
        cache_j = jt._build_geom_cache(pose, image, jnp.asarray(pose_np))
        jt._geom_cache.clear()
        s = cache_j["xyz"].shape[0]
        rgb_j, preds_j = jt._fast_fwd_fn(s)(jt.params, *jt._cache_args(cache_j))
        feats = jt.fx(rgb_j.T.reshape(3, H, W))[jt.style_loss.keys[0]][0]
        jt.style_loss.update_matching(feats, preds_j)
        trainable, frozen = jt._split_params()
        _, scalars, grads = jt._fast_step_fn(s)(trainable, frozen, *jt._cache_args(cache_j),
                                                cache_j["target_chw"], cache_j["tgt_feat"])
        grad_j = np.asarray(grads["x_color_embedder"])

        cache_t = tt.geom_cache(pose)
        assert cache_t["dirs"].shape == cache_t["xyz"].shape
        assert tt._cache_nbytes(cache_t) == sum(v.numel() * v.element_size()
                                                for v in cache_t.values())
        np.testing.assert_allclose(torch.linalg.norm(cache_t["dirs"], dim=1).numpy(), 1.0,
                                   atol=1e-6)
        tt.init_matching(cache_t)
        np.testing.assert_array_equal(np.asarray(tt.style_loss.matching),
                                      np.asarray(jt.style_loss.matching))
        losses_t, grads_t = tt.loss_and_grads(cache_t)
    for k, v in scalars.items():
        np.testing.assert_allclose(float(losses_t[k]), float(v), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(grads_t["x_color_embedder"].numpy(), grad_j, rtol=0,
                               atol=2e-3 * np.abs(grad_j).max())


def test_torch_use_dir_pass2_grads_match_jax(pair):
    """The ``use_dir`` field through pass 2: the windows' colour-table
    gradient for a seeded cotangent against JAX's ``_pass2_grads`` (fp32;
    the tolerances of test_torch_pass2_grads_match_jax)."""
    jt, tt = pair
    pose = common.first_pose(tt)
    cot = common.cot(5)
    with common.use_dir(jt, tt):
        g_j = common.jax_pass2(jt, pose, cot)
        g_t = tt.window_grads(tt.params, pose, torch.from_numpy(cot))["x_color_embedder"]
    assert common.rel_l2(g_t.numpy(), g_j) <= 1e-4
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=1e-4 * np.abs(g_j).max())


@pytest.mark.parametrize("amp", [False])
def test_torch_two_pass_iter_matches_jax(pair, amp):
    """One two-pass iteration of both trainers from the same checkpoint
    (fp32): see ``style_two_pass_common.check_two_pass_iter``."""
    jt, tt = pair
    common.check_two_pass_iter(jt, tt, amp)
