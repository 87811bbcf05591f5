"""Port parity of the style stage (``nerfstyle_torch/training/style_trainer.py``)
against the JAX package's StyleTrainer on the CPU.

* SegmentSum's backward (kernel K7b's plain version) against the VJP of
  ``jax.ops.segment_sum``.
* The slice as a whole: one iteration of both trainers from the same
  port-written stage-1 checkpoint, on a 32x24 synthetic scene with a segment
  map, with the JAX extractor's fallback VGG filters carried into the port.
* The entry point: a few style iterations through ``python -m
  nerfstyle_torch.train --device cpu``, a checkpoint both packages load, and
  the default device raising where there is no CUDA.
"""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_torch import kernels, train, utils
from nerfstyle_torch.config import BaseConfig
from nerfstyle_torch.data.synthetic import generate_scene
from nerfstyle_torch.models.vgg import vgg_params_from_numpy
from nerfstyle_torch.ops import compositing as tc
from nerfstyle_torch.render import cli as render_cli
from nerfstyle_torch.training import checkpoint as ckpt_lib
from nerfstyle_torch.training.style_trainer import StyleTrainer
from nerfstyle_torch.training.trainer import Trainer
from nerfstyle_tpu.config import BaseConfig as JBaseConfig
from nerfstyle_tpu.training import checkpoint as jckpt
from nerfstyle_tpu.training.style_trainer import StyleTrainer as JStyleTrainer

REPO = Path(__file__).resolve().parent.parent
W, H = 32, 24
NET = ["--pos_enc.n_lvls", "4", "--pos_enc.hashmap_size", "12", "--pos_enc.max_res_coeff", "16",
       "--grid_size", "32", "--max_steps", "128", "--max_eval_count", "1"]
QUIET = ["--intervals.print", "0", "--intervals.log", "0", "--intervals.test", "0"]


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """A 32x24 scene, a port-written stage-1 checkpoint (40 steps), a style
    PNG and a 4-quadrant segment map."""
    root = tmp_path_factory.mktemp("style_step")
    generate_scene(root / "scene", num_train=4, num_test=1, h=H, w=W)
    data_cfg = root / "data.yaml"
    data_cfg.write_text(f"root_path: {root / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    tt = Trainer(BaseConfig(log_dir=root / "recon", data_cfg=data_cfg),
                 NET + QUIET + ["--num_iterations", "40", "--num_rays_per_batch", "256",
                                "--update_thres", "4", "--intervals.ckpt", "40", "--enable_amp"],
                 device="cpu")
    tt.run()
    yy, xx = np.meshgrid(np.linspace(0, 1, 30), np.linspace(0, 1, 40), indexing="ij")
    png, seg = root / "style.png", root / "style_seg.npz"
    utils.save_image(np.stack([yy, xx, 1 - yy], axis=-1).astype(np.float32), png)
    np.savez(seg, seg_map=(yy > 0.5).astype(np.int64) * 2 + (xx > 0.5).astype(np.int64))
    yield root, data_cfg, root / "recon" / "iter_40.ckpt", png, seg
    shutil.rmtree(root, ignore_errors=True)


def test_torch_segment_sum_backward_matches_jax_vjp():
    """d ch = w * g[ray] (one fp32 product: equal) and d w = sum_c ch *
    g[ray] (7 products summed in another order: atol 1e-6 of the largest)
    against the VJP of jax.ops.segment_sum(w * ch)."""
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 6, size=50)
    rid = np.repeat(np.arange(50), counts)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    w = rng.uniform(0, 1, rid.shape[0]).astype(np.float32)
    ch = rng.normal(size=(rid.shape[0], 7)).astype(np.float32)
    g = rng.normal(size=(50, 7)).astype(np.float32)
    _, vjp = jax.vjp(lambda ww, cc: jax.ops.segment_sum(ww[:, None] * cc, jnp.asarray(rid),
                                                        num_segments=50),
                     jnp.asarray(w), jnp.asarray(ch))
    dw_j, dch_j = vjp(jnp.asarray(g))
    wt, ct = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(ch).requires_grad_(True)
    out = tc.segment_sum_grad(wt, ct, torch.from_numpy(offsets))
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ct.grad.numpy(), np.asarray(dch_j))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(dw_j)).max())
    wf = torch.from_numpy(w)
    ct2 = torch.from_numpy(ch).requires_grad_(True)
    tc.segment_sum_grad(wf, ct2, torch.from_numpy(offsets)).backward(torch.from_numpy(g))
    assert wf.grad is None
    np.testing.assert_array_equal(ct2.grad.numpy(), np.asarray(dch_j))


def _jax_first_step(jt, pose):
    """The JAX trainer's cache, matching, losses and gradient of its first
    iteration, taken as _run_iter_cached takes them (the iteration that
    follows reuses them)."""
    image, pose_np = jt.train_set[pose]
    cache = jt._build_geom_cache(pose, image, jnp.asarray(pose_np))
    s = cache["xyz"].shape[0]
    rgb_map, preds = jt._fast_fwd_fn(s)(jt.params, *jt._cache_args(cache))
    feats = jt.fx(rgb_map.T.reshape(3, H, W))[jt.style_loss.keys[0]][0]
    jt.style_loss.update_matching(feats, preds)
    trainable, frozen = jt._split_params()
    _, scalars, grads = jt._fast_step_fn(s)(trainable, frozen, *jt._cache_args(cache),
                                            cache["target_chw"], cache["tgt_feat"])
    return cache, {k: float(v) for k, v in scalars.items()}, np.asarray(grads["x_color_embedder"])


@pytest.mark.parametrize("amp", [False, True])
def test_torch_style_iter_matches_jax(stage1, tmp_path, monkeypatch, amp):
    """One style iteration of both trainers from the same checkpoint.

    The JAX cache takes each weight from an fp32 cumsum over the pose's whole
    stream, the port's plain compositor sums in float64: per-ray cached
    weight and acc_ws atol 1e-4 (measured 6e-5), and a sample whose weight
    lies within that of the cache's eps (1e-4) may be kept by one side only
    (count within 0.1%).  Matching: equal.  fp32: loss terms rtol 1e-5, the
    color-table gradient atol 2e-3 of its largest value (measured 9e-7 and
    2.2e-4: VGG's fp32 convolutions in another order).  AMP: rtol 1e-4 and
    5e-2 (measured 2.3e-5 and 1.5e-2: the bf16 rounding steps, where a value
    near a step may land on either side, and JAX's bf16-packed table-gradient
    contributions).  The update: Adam's first step moves every touched
    element by about lr whatever its gradient's size; where the gradient is
    at least 5e-2 of the largest the two agree to 5% of lr, elsewhere within
    2 lr.  Every other leaf: unchanged, bit for bit, on both sides."""
    monkeypatch.chdir(REPO)  # the JAX trainer reads cfgs/training/style.yaml relative to it
    _, data_cfg, ckpt, png, seg = stage1
    nargs = NET + QUIET + ["--style_seg_path", str(seg), "--test_before_train",
                           "--intervals.ckpt", "0"] + ([] if amp else ["--enable_amp"])
    jt = JStyleTrainer(JBaseConfig(log_dir=tmp_path / "jax", data_cfg=data_cfg, ckpt=ckpt,
                                   style_image=png), list(nargs))
    tt = StyleTrainer(BaseConfig(log_dir=tmp_path / "port", data_cfg=data_cfg, ckpt=ckpt,
                                 style_image=png), list(nargs), device="cpu",
                      vgg_params=vgg_params_from_numpy(jt.fx.params))
    assert tt.train_cfg.initial_learning_rate == 0.1 and tt.iter_ctr == 0
    pose = int(np.random.default_rng(tt.train_cfg.rng_seed).permutation(4)[0])
    cache_j, losses_j, grad_j = _jax_first_step(jt, pose)
    cache_t = tt.geom_cache(pose)
    tt.init_matching(cache_t)
    losses_t, grads_t = tt.loss_and_grads(cache_t)
    before = {k: [w.detach().clone() for w in (v if isinstance(v, list) else [v])]
              for k, v in tt.params.items()}
    kernels.reset_launch_counts()
    jt.run_iter()
    tt.run_iter()
    assert not any(kernels.launch_counts.values())

    hw = W * H
    rid = np.asarray(cache_j["rid"])
    n_j, n_t = int((rid < hw).sum()), cache_t["w"].shape[0]
    assert n_t > 2 * hw and abs(n_t - n_j) <= max(2, 1e-3 * n_j), (n_t, n_j)
    w_ray_j = np.asarray(jax.ops.segment_sum(cache_j["w"], cache_j["rid"], hw + 1))[:hw]
    w_ray_t = tc.segment_totals_plain(cache_t["w"], cache_t["offsets"]).numpy()
    np.testing.assert_allclose(w_ray_t, w_ray_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(cache_t["acc_ws"].numpy(), np.asarray(cache_j["acc_ws"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(tt.style_loss.matching),
                                  np.asarray(jt.style_loss.matching))
    for k, v in losses_j.items():
        np.testing.assert_allclose(float(losses_t[k]), v, rtol=1e-4 if amp else 1e-5, err_msg=k)
    g_t = grads_t["x_color_embedder"].numpy()
    tol = (5e-2 if amp else 2e-3) * np.abs(grad_j).max()
    np.testing.assert_allclose(g_t, grad_j, rtol=0, atol=tol)

    lr = tt.train_cfg.initial_learning_rate
    p_t = tt.params["x_color_embedder"].detach().numpy()
    p_j = np.asarray(jt.params["x_color_embedder"])
    diff = np.abs(p_t - p_j)
    determined = np.abs(grad_j) >= 5e-2 * np.abs(grad_j).max()
    assert determined.sum() > 100 and diff[determined].max() <= 0.05 * lr
    assert diff.max() <= 2.001 * lr
    assert np.abs(p_t - before["x_color_embedder"][0].numpy()).max() > 0.5 * lr
    for k, v in tt.params.items():
        if k == "x_color_embedder":
            continue
        got = v if isinstance(v, list) else [v]
        want = jt.params[k] if isinstance(jt.params[k], list) else [jt.params[k]]
        for a, b, c in zip(got, before[k], want):
            assert torch.equal(a, b) and not a.requires_grad, k
            np.testing.assert_array_equal(a.numpy(), np.asarray(c), err_msg=k)


def test_torch_style_entry_point_and_checkpoint(stage1, tmp_path):
    """``python -m nerfstyle_torch.train --device cpu`` stylizes a few
    iterations and writes a checkpoint that the JAX package's checkpoint
    reader and the port's render CLI load, whose leaves other than
    x_color_embedder are the stage-1 ones; the default device raises
    without CUDA."""
    _, data_cfg, ckpt, png, seg = stage1
    argv = ["--ckpt", str(ckpt), "--log-dir", str(tmp_path / "style"), "--data-cfg",
            str(data_cfg), "--style-image", str(png), "--style_seg_path", str(seg),
            "--num_iterations", "3", "--intervals.ckpt", "3", "--test_before_train", "--yes",
            *NET, *QUIET]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(list(argv))
    st = train.main(["--device", "cpu", *argv])
    assert isinstance(st, StyleTrainer) and st.iter_ctr == 3
    assert st.train_cfg.num_iterations == 3 and st.train_cfg.content_lambda == 0.001
    assert all(np.isfinite(float(h["total"])) for h in st.loss_history)
    path = tmp_path / "style" / "iter_3.ckpt"
    meta, groups = jckpt.load_checkpoint(path)
    assert meta["iter_ctr"] == 3
    _, before = ckpt_lib.load_checkpoint(ckpt)
    p0 = ckpt_lib.restore_tree(st.params, before["params"])
    p1 = ckpt_lib.restore_tree(st.params, groups["params"])
    for k in p0:
        same = all(torch.equal(a, b) for a, b in zip(ckpt_lib.tree_flatten(p0[k]),
                                                    ckpt_lib.tree_flatten(p1[k])))
        assert same == (k != "x_color_embedder"), k
    summary = render_cli.main([str(path), "--device", "cpu", "--max-count", "1", "--yes",
                               "--out-dir", str(tmp_path / "render")])
    assert bool(torch.isfinite(summary["last"]["rgb_map"]).all())
