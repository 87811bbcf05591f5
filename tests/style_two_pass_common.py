"""Shared set-up of the port's two-pass style parity tests
(``tests/test_torch_style_two_pass.py``, fp32, and
``tests/test_torch_style_two_pass_amp.py``, AMP), which hold the style
stage's two-pass scheme (``style_geom_cache`` false) and the style cache's
view-direction input (``nerfstyle_torch/training/style_trainer.py``)
against the JAX package's StyleTrainer on the CPU.  The two files share one
stage-1 checkpoint (:func:`make_stage1`); each builds only its own JAX
trainer.

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
import fcntl
import functools
import hashlib
import inspect
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfstyle_torch import kernels, utils
from nerfstyle_torch.config import BaseConfig
from nerfstyle_torch.data.synthetic import generate_scene
from nerfstyle_torch.models import vgg as tvgg
from nerfstyle_torch.models.vgg import vgg_params_from_numpy
from nerfstyle_torch.training.style_trainer import StyleTrainer
from nerfstyle_torch.training.trainer import Trainer
from nerfstyle_tpu.config import BaseConfig as JBaseConfig
from nerfstyle_tpu.models import fields as jfields
from nerfstyle_tpu.models import vgg as jvgg
from nerfstyle_tpu.render.renderer import bucket_for
from nerfstyle_tpu.training import style_trainer as jstyle

REPO = Path(__file__).resolve().parent.parent
W, H = 32, 24
NET = ["--pos_enc.n_lvls", "4", "--pos_enc.hashmap_size", "12", "--pos_enc.max_res_coeff", "16",
       "--grid_size", "32", "--max_steps", "128", "--max_eval_count", "1"]
QUIET = ["--intervals.print", "0", "--intervals.log", "0", "--intervals.test", "0",
         "--intervals.ckpt", "0"]
TWO_PASS = ["--style_geom_cache", "--defer_patch_size", "20"]  # toggles true -> false
BUDGET = 64  # JAX's samples-a-ray bucket here: no truncation (see the module docstring)


def make_stage1(tmp_path_factory):
    """A 32x24 scene, a port-written stage-1 checkpoint (40 steps), a style
    PNG and a 4-quadrant segment map, built once a run and shared by the
    files that ask for it: under xdist in the parent of the workers' base
    temp directories, under a file lock, in a directory named by a hash of
    its inputs (the build's source, the flags and the sizes).  The 40
    steps run on one torch thread: beside other busy workers the CPU
    build's threads contend (137 s against 5.7 s measured with two builds
    side by side)."""
    src = inspect.getsource(_build_stage1) + repr((NET, QUIET, W, H))
    key = hashlib.sha256(src.encode()).hexdigest()[:16]
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / f"style_two_pass_stage1_{key}"
    with open(base / f"style_two_pass_stage1_{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (root / "done").exists():
            shutil.rmtree(root, ignore_errors=True)
            _build_stage1(root)
            (root / "done").touch()
    return root, root / "data.yaml", root / "recon" / "iter_40.ckpt", root / "style.png", \
        root / "style_seg.npz"


def _build_stage1(root: Path) -> None:
    generate_scene(root / "scene", num_train=4, num_test=1, h=H, w=W)
    data_cfg = root / "data.yaml"
    data_cfg.write_text(f"root_path: {root / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tt = Trainer(BaseConfig(log_dir=root / "recon", data_cfg=data_cfg),
                     NET + QUIET[:-2] + ["--num_iterations", "40", "--num_rays_per_batch", "256",
                                         "--update_thres", "4", "--intervals.ckpt", "40",
                                         "--enable_amp"],
                     device="cpu")
        tt.run()
    finally:
        torch.set_num_threads(threads)
    yy, xx = np.meshgrid(np.linspace(0, 1, 30), np.linspace(0, 1, 40), indexing="ij")
    utils.save_image(np.stack([yy, xx, 1 - yy], axis=-1).astype(np.float32), root / "style.png")
    np.savez(root / "style_seg.npz",
             seg_map=(yy > 0.5).astype(np.int64) * 2 + (xx > 0.5).astype(np.int64))


def trainers(stage1, log_dir: Path, extra, jax_side=True):
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


def make_pair(stage1, tmp_path_factory, amp: bool):
    """The two-pass JAX and port trainers of one ``amp`` setting (a JAX
    trainer takes ~14 s to build and its pass 2 ~10 s to compile).  Tests
    that change them put them back, but the iteration test, which runs
    last."""
    return trainers(stage1, tmp_path_factory.mktemp(f"pair_{amp}"),
                    TWO_PASS + ([] if amp else ["--enable_amp"]))


def first_pose(tt) -> int:
    """The pose of the first iteration (the shuffled pass's first index)."""
    return int(np.random.default_rng(tt.train_cfg.rng_seed).permutation(len(tt.train_set))[0])


def _one_group(jt, pose_idx, bitfield, pose):
    """JAX's pass-2 groups: every window at the bucket of the densest."""
    idx, own, _, n_pix = jt._pass2_tiling()
    counts = jt._window_counts(pose_idx, bitfield, pose)
    b = bucket_for(jt.PASS2_MARGIN * float(counts.max()) / n_pix, jt._win_cap())
    return [(b, jnp.asarray(idx), jnp.asarray(own))]


def no_truncation(jt, pose: int) -> None:
    """JAX's windows of this pose fit their budgets (as its own test asks)."""
    _, _, _, n_pix = jt._pass2_tiling()
    counts = jt._window_counts(pose, jt.renderer.occ_field, jnp.asarray(jt.train_set[pose][1]))
    assert counts.max() > 0 and 1.5 * counts.max() / n_pix <= jt._win_cap(), counts


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def cot(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(H * W, 3)).astype(np.float32)


def jax_pass2(jt, pose: int, cot) -> np.ndarray:
    trainable, frozen = jt._split_params()
    return np.asarray(jt._pass2_grads(pose, trainable, frozen, jt.renderer.occ_field,
                                      jnp.asarray(jt.train_set[pose][1]),
                                      jnp.asarray(cot))["x_color_embedder"])


@contextlib.contextmanager
def use_dir(jt, tt):
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


def check_two_pass_iter(jt, tt, amp: bool) -> None:
    """One two-pass iteration of both trainers from the same checkpoint:
    the port's pieces and its ``run_iter`` against the pieces of JAX's
    ``_run_iter_two_pass`` (its frame, matching, loss and pixel gradient,
    pass 2, and its optimizer's update; the loss and the update jitted).

    Pass 1: the frame within 1e-4 (rgb and class logits) of JAX's (JAX
    takes its weights from an fp32 cumsum, the port's plain compositor from
    float64 sums), the class map, the target and the matching equal.  The
    pixel gradient, on JAX's frame: relative L2 5e-2, and at most a tenth
    of the pixels beyond 1e-3 of the largest value (measured 2.2e-2 and 30
    of 768 pixels).  The cause is isolated: the two frameworks' VGG16
    pools pick other elements only in windows whose two largest values lie
    within rounding of each other (here one window of pool 1, its values
    4e-7 apart: the two convolutions sum in other orders), and a pixel's
    gradient moves to its neighbour; exact ties pick alike, and the ReLU's
    gradient at an exact 0 is JAX's (``tests/test_torch_vgg_ties.py``).
    With the port's pools pinned to JAX's picks the pixel gradient agrees
    to relative L2 1e-5 and within 1e-5 of the largest value at every
    pixel (measured 2.0e-6).  Pass 2 below takes JAX's pixel gradient, so
    the table gradient is held tightly: relative L2 1e-4 (fp32), 2e-2 (AMP:
    bf16 rounding steps and JAX's bf16-packed table gradient), as
    test_torch_pass2_grads_match_jax.  The iteration:
    loss terms rtol 1e-4 (the frames' difference: the content term measured
    2.4e-5 off in fp32); Adam's first step moves each touched entry by about
    lr whatever its gradient's size: where JAX's gradient is at least 5e-2
    of its largest the two agree to 5% of lr, elsewhere within 2 lr.  Every
    other leaf: unchanged on both sides, bit for bit."""
    pose = first_pose(tt)
    no_truncation(jt, pose)
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
    assert rel_l2(pix_t, pix_j) <= 5e-2 and off.mean() <= 0.1
    picks_j, near_j = jax_pool_picks(jt, out["rgb_map"])
    flips = port_pool_flips(tt, rgb_j, picks_j)
    assert all(near_j[i][f].all() for i, f in enumerate(flips)), "a pick flip off a near-tie"
    with pinned_pools(picks_j):
        _, pix_p = tt.pixel_grad(rgb_j, tt.target(pose), torch.from_numpy(np.array(preds_j)))
    assert rel_l2(pix_p, pix_j) <= 1e-5
    np.testing.assert_allclose(pix_p.numpy(), np.asarray(pix_j), rtol=0,
                               atol=1e-5 * np.abs(pix_j).max())
    grad_t = tt.window_grads(tt.params, pose, torch.from_numpy(np.array(pix_j)))
    assert rel_l2(grad_t["x_color_embedder"], grad_j) <= (2e-2 if amp else 1e-4)

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


def jax_pool_picks(jt, rgb_map):
    """JAX's VGG16 max-pool picks on a frame [HW, 3], by the rule XLA's
    select-and-scatter routes by (the first largest element of a window in
    row-major order), as flat indices into each pool's input plane; and
    for each window whether its two largest values lie within 1e-5 of the
    largest (a near-tie).  Pools 1 and 2, the ones before relu3."""
    fx = jvgg.VGG16FeatureExtractor(["relu1_2", "relu2_2"])
    fx.params = jt.fx.params
    feats = fx(jnp.asarray(rgb_map).T.reshape(3, H, W))
    picks, near = [], []
    for key in ("relu1_2", "relu2_2"):
        r = np.asarray(feats[key])[0]
        c, h, w = r.shape
        win = r.reshape(c, h // 2, 2, w // 2, 2).transpose(0, 1, 3, 2, 4)
        win = win.reshape(c, h // 2, w // 2, 4)
        a = win.argmax(-1)
        top2 = np.sort(win, axis=-1)[..., -2:]
        near.append(top2[..., 1] - top2[..., 0] <= 1e-5 * np.abs(r).max())
        rows = np.arange(h // 2)[:, None] * 2 + a // 2
        flat = rows * w + np.arange(w // 2)[None, :] * 2 + a % 2
        picks.append(torch.from_numpy(flat[None]))
    return picks, near


def port_pool_flips(tt, rgb_map: torch.Tensor, picks):
    """Where the port's own pool picks on a frame differ from ``picks``, in
    windows whose largest value is above 0 (a window of ReLU zeros takes no
    gradient whichever it picks)."""
    fx = tvgg.VGG16FeatureExtractor(["relu1_2", "relu2_2"], params=tt.fx.params)
    taps = fx(rgb_map.T.reshape(3, H, W))
    flips = []
    for key, want in zip(("relu1_2", "relu2_2"), picks):
        out, idx = torch.nn.functional.max_pool2d(taps[key], 2, 2, return_indices=True)
        flips.append(((idx != want) & (out > 0))[0].numpy())
    return flips


@contextlib.contextmanager
def pinned_pools(picks):
    """The port's VGG16 max-pools take ``picks`` for the first forward in
    the block (the rendered frame's: the one under autograd), their own
    afterwards."""
    real = torch.nn.functional.max_pool2d
    taken = []

    def pool(x, k, s):
        if len(taken) == len(picks):
            return real(x, k, s)
        idx = picks[len(taken)]
        taken.append(idx)
        return x.flatten(-2).gather(-1, idx.flatten(-2)).view(idx.shape)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvgg, "F", _FunctionalWith(max_pool2d=pool))
        yield
    assert len(taken) == len(picks)


class _FunctionalWith:
    """``torch.nn.functional`` with some names replaced."""

    def __init__(self, **over):
        self._over = over

    def __getattr__(self, name):
        return self._over.get(name) or getattr(torch.nn.functional, name)
