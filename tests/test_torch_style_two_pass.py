"""Port parity of the style stage's two-pass scheme (``style_geom_cache``
false) and of the style cache's view-direction input
(``nerfstyle_torch/training/style_trainer.py``) against the JAX package's
StyleTrainer on the CPU.

All on a 32x24 synthetic scene with a port-written stage-1 checkpoint, the
JAX extractor's fallback VGG filters carried into the port, and windows of
20x20 (``defer_patch_size`` 20: two windows a row and a column, the last of
each shifted inward).

The JAX package sizes its pass-1 frame and each pass-2 window from budget
buckets and truncates a window whose demand passes them; the port sizes
every buffer from its march and never truncates.  The tests compare the two
where JAX does not truncate: a budget bucket of 64 samples a ray, checked
against JAX's own counts (pass 1's frame and each window), and every window
in one pass-2 group at the bucket of the densest (JAX's per-window ladder
sizes buffers only; one group compiles once).
"""

import contextlib
import dataclasses
import functools
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfstyle_torch import kernels, train, utils
from nerfstyle_torch.config import BaseConfig
from nerfstyle_torch.data.synthetic import generate_scene
from nerfstyle_torch.models.vgg import vgg_params_from_numpy
from nerfstyle_torch.training import checkpoint as ckpt_lib
from nerfstyle_torch.training.style_trainer import StyleTrainer, _tile_windows
from nerfstyle_torch.training.trainer import Trainer
from nerfstyle_tpu.config import BaseConfig as JBaseConfig
from nerfstyle_tpu.models import fields as jfields
from nerfstyle_tpu.render.renderer import bucket_for
from nerfstyle_tpu.training import checkpoint as jckpt
from nerfstyle_tpu.training import style_trainer as jstyle

REPO = Path(__file__).resolve().parent.parent
W, H = 32, 24
NET = ["--pos_enc.n_lvls", "4", "--pos_enc.hashmap_size", "12", "--pos_enc.max_res_coeff", "16",
       "--grid_size", "32", "--max_steps", "128", "--max_eval_count", "1"]
QUIET = ["--intervals.print", "0", "--intervals.log", "0", "--intervals.test", "0",
         "--intervals.ckpt", "0"]
TWO_PASS = ["--style_geom_cache", "--defer_patch_size", "20"]  # toggles true -> false
BUDGET = 64  # JAX's samples-a-ray bucket here: no truncation (see the module docstring)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """A 32x24 scene, a port-written stage-1 checkpoint (40 steps), a style
    PNG and a 4-quadrant segment map."""
    root = tmp_path_factory.mktemp("style_two_pass")
    generate_scene(root / "scene", num_train=4, num_test=1, h=H, w=W)
    data_cfg = root / "data.yaml"
    data_cfg.write_text(f"root_path: {root / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    tt = Trainer(BaseConfig(log_dir=root / "recon", data_cfg=data_cfg),
                 NET + QUIET[:-2] + ["--num_iterations", "40", "--num_rays_per_batch", "256",
                                     "--update_thres", "4", "--intervals.ckpt", "40",
                                     "--enable_amp"],
                 device="cpu")
    tt.run()
    yy, xx = np.meshgrid(np.linspace(0, 1, 30), np.linspace(0, 1, 40), indexing="ij")
    png, seg = root / "style.png", root / "style_seg.npz"
    utils.save_image(np.stack([yy, xx, 1 - yy], axis=-1).astype(np.float32), png)
    np.savez(seg, seg_map=(yy > 0.5).astype(np.int64) * 2 + (xx > 0.5).astype(np.int64))
    yield root, data_cfg, root / "recon" / "iter_40.ckpt", png, seg
    shutil.rmtree(root, ignore_errors=True)


def _trainers(stage1, log_dir: Path, extra, jax_side=True):
    """The JAX (or None) and the port StyleTrainer from the same checkpoint
    and flags; the port takes the JAX extractor's filters (its own without
    the JAX side)."""
    _, data_cfg, ckpt, png, seg = stage1
    nargs = NET + QUIET + ["--style_seg_path", str(seg), "--test_before_train"] + extra
    jt = vgg = None
    if jax_side:
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(REPO)  # the JAX trainer reads cfgs/training/style.yaml relative to it
            jt = jstyle.StyleTrainer(JBaseConfig(log_dir=log_dir / "jax", data_cfg=data_cfg,
                                                 ckpt=ckpt, style_image=png), list(nargs))
        # No truncation: the bucket fixed (no retune from pass 1's demand),
        # and one device (conftest.py's 8-device mesh would split each
        # window's budget evenly over 8 shards of rays and truncate the
        # dense shards: 0.15 relative L2 off the unsharded gradient).
        jt.renderer._budget_bucket = BUDGET
        jt._retunes_active = False
        jt.mesh = None
        jt._pass2_groups = functools.partial(_one_group, jt)
        # Pass 1 in one chunk of the frame's rays (not padded to 8192).
        jt.renderer.settings = dataclasses.replace(jt.renderer.settings, infer_chunk=W * H)
        vgg = vgg_params_from_numpy(jt.fx.params)
    tt = StyleTrainer(BaseConfig(log_dir=log_dir / "port", data_cfg=data_cfg, ckpt=ckpt,
                                 style_image=png), list(nargs), device="cpu", vgg_params=vgg)
    return jt, tt


@pytest.fixture(scope="module")
def pair(stage1, tmp_path_factory):
    """The two-pass JAX and port trainers, by ``amp``, each built once (a
    JAX trainer takes ~14 s to build and its pass 2 ~10 s to compile).
    Tests that change them put them back, but the iteration test, which
    runs last for each."""
    built = {}

    def get(amp: bool):
        if amp not in built:
            built[amp] = _trainers(stage1, tmp_path_factory.mktemp(f"pair_{amp}"),
                                   TWO_PASS + ([] if amp else ["--enable_amp"]))
        return built[amp]

    return get


def _first_pose(tt) -> int:
    """The pose of the first iteration (the shuffled pass's first index)."""
    return int(np.random.default_rng(tt.train_cfg.rng_seed).permutation(len(tt.train_set))[0])


def _one_group(jt, pose_idx, bitfield, pose):
    """JAX's pass-2 groups: every window at the bucket of the densest."""
    idx, own, _, n_pix = jt._pass2_tiling()
    counts = jt._window_counts(pose_idx, bitfield, pose)
    b = bucket_for(jt.PASS2_MARGIN * float(counts.max()) / n_pix, jt._win_cap())
    return [(b, jnp.asarray(idx), jnp.asarray(own))]


def _no_truncation(jt, pose: int) -> None:
    """JAX's windows of this pose fit their budgets (as its own test asks)."""
    _, _, _, n_pix = jt._pass2_tiling()
    counts = jt._window_counts(pose, jt.renderer.occ_field, jnp.asarray(jt.train_set[pose][1]))
    assert counts.max() > 0 and 1.5 * counts.max() / n_pix <= jt._win_cap(), counts


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cot(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(H * W, 3)).astype(np.float32)


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


def _jax_pass2(jt, pose: int, cot) -> np.ndarray:
    trainable, frozen = jt._split_params()
    return np.asarray(jt._pass2_grads(pose, trainable, frozen, jt.renderer.occ_field,
                                      jnp.asarray(jt.train_set[pose][1]),
                                      jnp.asarray(cot))["x_color_embedder"])


def test_torch_pass2_grads_match_jax(pair):
    """Pass 2's colour-table gradient for a numpy-seeded cotangent, summed
    over the shifted windows, against JAX's ``_pass2_grads`` on the same
    checkpoint and pose (fp32), no kernel launched.  JAX takes each weight
    from an fp32 cumsum over a window's stream, the port's plain compositor
    from float64 sums, and the table gradients add in other orders: relative
    L2 error 1e-4 (measured 1.3e-5), each entry within 1e-4 of the
    largest."""
    jt, tt = pair(False)
    pose = _first_pose(tt)
    _no_truncation(jt, pose)
    cot = _cot(3)
    g_j = _jax_pass2(jt, pose, cot)
    kernels.reset_launch_counts()
    g_t = tt.window_grads(tt.params, pose, torch.from_numpy(cot))["x_color_embedder"].numpy()
    assert not any(kernels.launch_counts.values())
    assert _rel_l2(g_t, g_j) <= 1e-4
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-4 * np.abs(g_j).max())


def test_torch_pass2_windows_equal_whole_image_vjp(stage1, tmp_path):
    """The port alone: the sum over the shifted windows of each window's VJP
    of its owned pixels equals one VJP of the whole frame's render.  The
    same samples and the same arithmetic, only the table gradient's sums in
    another order: rtol 5e-3, atol 2e-3 of the largest (JAX's own test)."""
    _, tt = _trainers(stage1, tmp_path, TWO_PASS, jax_side=False)
    pose = _first_pose(tt)
    cot = torch.from_numpy(_cot(4))
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
    _, cached = _trainers(stage1, tmp_path / "c", extra, jax_side=False)
    _, two = _trainers(stage1, tmp_path / "t", extra + TWO_PASS, jax_side=False)
    pose = _first_pose(two)
    losses_c, grads_c = cached.loss_and_grads(cached.geom_cache(pose))
    rgb, cls = two.render_frame(two.params, pose)
    losses_t, pix = two.pixel_grad(rgb, two.target(pose), two._preds(cls))
    grads_t = two.window_grads(two.params, pose, pix)
    np.testing.assert_allclose(float(losses_t["total"]), float(losses_c["total"]), rtol=1e-4)
    a, b = grads_t["x_color_embedder"].numpy(), grads_c["x_color_embedder"].numpy()
    np.testing.assert_allclose(a, b, rtol=5e-3, atol=2e-3 * np.abs(b).max())
    assert all(grads_t[k] is None and grads_c[k] is None for k in grads_t
               if k != "x_color_embedder")


@contextlib.contextmanager
def _use_dir(jt, tt):
    """Both trainers' field with the view-direction input for the length of
    the block: the spec replaced and the same seeded color2 head (SH degree
    4: [32, 64, 64, 3]) in both, as a library user reaches it (no entry
    point builds it); JAX's compiled pass 2 set aside (it holds the spec)."""
    saved = (jt.field_spec, tt.field_spec, jt.params["color2_net"], tt.params["color2_net"],
             jt._pass2_cache)
    jt.field_spec = dataclasses.replace(jt.field_spec, use_dir=True)
    tt.field_spec = dataclasses.replace(tt.field_spec, use_dir=True)
    head = jfields.field_init(jax.random.PRNGKey(7), jt.field_spec)["color2_net"]
    assert head[0].shape == (32, 64)
    jt.params["color2_net"] = [jnp.asarray(w) for w in head]
    tt.params["color2_net"] = [torch.tensor(np.asarray(w)) for w in head]
    jt._pass2_cache = {}
    try:
        yield
    finally:
        (jt.field_spec, tt.field_spec, jt.params["color2_net"], tt.params["color2_net"],
         jt._pass2_cache) = saved
        tt._geom_cache.clear()
        jt.style_loss.matching = tt.style_loss.matching = None


def test_torch_use_dir_cached_step_matches_jax(pair):
    """The cache's view directions: with the ``use_dir`` field in both
    trainers, one cached step (fp32): the cache keeps each sample's unit
    direction (counted in its bytes); the matching equal, the losses (rtol
    1e-5) and the table gradient (atol 2e-3 of the largest), the cached
    step's tolerances."""
    jt, tt = pair(False)
    pose = _first_pose(tt)
    with _use_dir(jt, tt):
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
    jt, tt = pair(False)
    pose = _first_pose(tt)
    cot = _cot(5)
    with _use_dir(jt, tt):
        g_j = _jax_pass2(jt, pose, cot)
        g_t = tt.window_grads(tt.params, pose, torch.from_numpy(cot))["x_color_embedder"]
    assert _rel_l2(g_t.numpy(), g_j) <= 1e-4
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=1e-4 * np.abs(g_j).max())


@pytest.mark.parametrize("amp", [False, True])
def test_torch_two_pass_iter_matches_jax(pair, amp):
    """One two-pass iteration of both trainers from the same checkpoint:
    the port's pieces and its ``run_iter`` against the pieces of JAX's
    ``_run_iter_two_pass`` (its frame, matching, loss and pixel gradient,
    pass 2, and its optimizer's update; the loss and the update jitted).

    Pass 1: the frame within 1e-4 (rgb and class logits) of JAX's (JAX
    takes its weights from an fp32 cumsum, the port's plain compositor from
    float64 sums), the class map, the target and the matching equal.  The
    pixel gradient, on JAX's frame: relative L2 5e-2, and at most a tenth
    of the pixels beyond 1e-3 of the largest value (measured 2.2e-2 and 30
    of 768 pixels: where VGG16's max-pools and ReLUs meet ties or
    near-ties, as on the white background's equal features, the two
    frameworks pick other elements and a pixel's gradient moves to its
    neighbour; pass 2 below takes JAX's pixel gradient, so the table
    gradient is held tightly).  Pass 2, for JAX's pixel gradient: relative
    L2 1e-4 (fp32), 2e-2 (AMP: bf16 rounding steps and JAX's bf16-packed
    table gradient), as test_torch_pass2_grads_match_jax.  The iteration:
    loss terms rtol 1e-4 (the frames' difference: the content term measured
    2.4e-5 off in fp32); Adam's first step moves each touched entry by about
    lr whatever its gradient's size: where JAX's gradient is at least 5e-2
    of its largest the two agree to 5% of lr, elsewhere within 2 lr.  Every
    other leaf: unchanged on both sides, bit for bit."""
    jt, tt = pair(amp)
    pose = _first_pose(tt)
    _no_truncation(jt, pose)
    image, pose_np = jt.train_set[pose]
    pose_dev = jnp.asarray(pose_np)
    out = jt.renderer.render(jt.params, pose_dev, jnp.asarray(image), training=True)
    assert 0 < int(out["num_points"]) <= H * W * BUDGET
    preds_j = jnp.argmax(out["classes"], axis=1).reshape(H, W)
    relu3 = jax.jit(lambda rgb: jt.fx(rgb.T.reshape(3, H, W))[jt.style_loss.keys[0]][0])
    jt.style_loss.update_matching(relu3(out["rgb_map"]), preds_j)
    target_j = out["target"][:, :3].T.reshape(3, H, W)
    (_, scalars), pix_j = jax.jit(jax.value_and_grad(jt._image_losses, has_aux=True))(
        out["rgb_map"], target_j, preds_j)
    trainable, frozen = jt._split_params()
    g_j = jt._pass2_grads(pose, trainable, frozen, jt.renderer.occ_field, pose_dev, pix_j)
    grad_j = np.asarray(g_j["x_color_embedder"])
    updates, _ = jax.jit(jt.optim.update)(
        {**g_j, **jax.tree_util.tree_map(jnp.zeros_like, frozen)}, jt.opt_state, jt.params)
    params_j = optax.apply_updates(jt.params, updates)

    kernels.reset_launch_counts()
    rgb_t, cls_t = tt.render_frame(tt.params, pose)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(out["rgb_map"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(cls_t.numpy(), np.asarray(out["classes"]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tt._preds(cls_t).numpy(), np.asarray(preds_j))
    tt._update_matching(rgb_t, tt._preds(cls_t))
    np.testing.assert_array_equal(np.asarray(tt.style_loss.matching),
                                  np.asarray(jt.style_loss.matching))
    np.testing.assert_array_equal(tt.target(pose).numpy(), np.asarray(target_j))
    rgb_j = torch.from_numpy(np.array(out["rgb_map"]))
    _, pix_t = tt.pixel_grad(rgb_j, tt.target(pose), torch.from_numpy(np.array(preds_j)))
    off = np.abs(pix_t.numpy() - np.asarray(pix_j)).max(1) > 1e-3 * np.abs(pix_j).max()
    assert _rel_l2(pix_t, pix_j) <= 5e-2 and off.mean() <= 0.1
    grad_t = tt.window_grads(tt.params, pose, torch.from_numpy(np.array(pix_j)))
    assert _rel_l2(grad_t["x_color_embedder"], grad_j) <= (2e-2 if amp else 1e-4)

    before = {k: [w.detach().clone() for w in (v if isinstance(v, list) else [v])]
              for k, v in tt.params.items()}
    tt.run_iter()
    assert not any(kernels.launch_counts.values())
    assert tt.iter_ctr == 1 and list(tt.two_pass_ms[0]) == list(StyleTrainer.TWO_PASS_PHASES)
    for k, v in scalars.items():
        np.testing.assert_allclose(float(tt.loss_history[0][k]), float(v), rtol=1e-4,
                                   err_msg=k)
    lr = tt.train_cfg.initial_learning_rate
    p_t = tt.params["x_color_embedder"].detach().numpy()
    diff = np.abs(p_t - np.asarray(params_j["x_color_embedder"]))
    determined = np.abs(grad_j) >= 5e-2 * np.abs(grad_j).max()
    assert determined.sum() > 100 and diff[determined].max() <= 0.05 * lr
    assert diff.max() <= 2.001 * lr
    assert np.abs(p_t - before["x_color_embedder"][0].numpy()).max() > 0.5 * lr
    for k, v in tt.params.items():
        if k == "x_color_embedder":
            continue
        got = v if isinstance(v, list) else [v]
        want = params_j[k] if isinstance(params_j[k], list) else [params_j[k]]
        for a, b, c in zip(got, before[k], want):
            assert torch.equal(a, b) and not a.requires_grad, k
            np.testing.assert_array_equal(a.numpy(), np.asarray(c), err_msg=k)


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
                     *NET, *QUIET[:-2], "--intervals.ckpt", "2", *TWO_PASS])
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
