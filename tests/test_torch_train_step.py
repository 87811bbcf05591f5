"""Port parity of the stage-1 train step: the port's Trainer against the JAX
Trainer at a tiny config on the synthetic scene.

* One step from the same mid-training state: the JAX trainer takes two
  steps, the port starts from its params, Adam moments, EMA and occupancy
  grid, and both take the third step on the same frame and pixels (the
  indices drawn from the JAX key as the JAX loss function draws them).  The
  JAX step is its own loss function, taken from the compiled step's closure,
  with a march budget and a two-phase kept capacity that truncate nothing.
* The two-phase evaluation equals the single-phase one.
* A non-finite gradient skips the update as optax.apply_if_finite does.
* Checkpoints written by either trainer restore into the other.
"""

import shutil

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from nerfstyle_tpu.config import BaseConfig as JBaseConfig
from nerfstyle_tpu.data.synthetic import generate_scene
from nerfstyle_tpu.training import checkpoint as jckpt
from nerfstyle_tpu.training import ema as jema
from nerfstyle_tpu.training.trainer import Trainer as JTrainer
from nerfstyle_torch import kernels
from nerfstyle_torch.config import BaseConfig
from nerfstyle_torch.models.fields import train_state_from_numpy
from nerfstyle_torch.ops.occupancy import PersistedOccupancy
from nerfstyle_torch.render import cli as render_cli
from nerfstyle_torch.training import optim as topt
from nerfstyle_torch.training.checkpoint import tree_flatten
from nerfstyle_torch.training.ema import ema_init, ema_update
from nerfstyle_torch.training.trainer import Trainer

RAYS = 256
TINY = [
    "--num_iterations", "100",
    "--num_rays_per_batch", str(RAYS),
    "--pos_enc.n_lvls", "4",
    "--pos_enc.hashmap_size", "12",
    "--pos_enc.max_res_coeff", "16",
    "--grid_size", "32",
    "--max_steps", "128",
    "--max_samples_per_ray", "1024",
    "--density_offset", "2",
    "--update_thres", "4",
    "--max_eval_count", "1",
    "--intervals.print", "0",
    "--intervals.log", "0",
    "--intervals.test", "0",
    "--intervals.ckpt", "0",
]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_step")
    generate_scene(root / "scene", num_train=6, num_test=2, h=48, w=64)
    data_cfg = root / "data.yaml"
    data_cfg.write_text(f"root_path: {root / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    yield root, data_cfg
    shutil.rmtree(root, ignore_errors=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_loss_fn(jt):
    """value_and_grad of the JAX trainer's own loss function for a march
    budget of every lattice sample and a two-phase kept capacity of the
    whole budget: nothing truncates."""
    lattice = jt.renderer.make_plan(RAYS).t_lattice
    plan = jt.renderer.make_plan(RAYS, budget=RAYS * lattice)
    step = jt._build_train_step(plan, 1.0, sig_budget=plan.budget)
    inner = step.__wrapped__
    cells = dict(zip(inner.__code__.co_freevars, (c.cell_contents for c in inner.__closure__)))
    return jax.jit(jax.value_and_grad(cells["loss_fn"], has_aux=True))


def _jax_iter(jt, vg):
    """One JAX iteration as Trainer.run_iter takes it, through ``vg``;
    returns (frame, step key, losses, grads, num_points, num_sig)."""
    jt._occ_key, k_occ = jax.random.split(jt._occ_key)
    jt.renderer.maybe_update_state(jt.params, k_occ)
    jt._data_key, k_step = jax.random.split(jt._data_key)
    frame = int(jt._frame_rng.integers(0, len(jt.train_set)))
    (_, (losses, num_points, _, num_sig)), grads = vg(
        jt.params, jt.renderer.occ_field, jt._images_dev[frame], jt._poses_dev[frame], k_step)
    updates, jt.opt_state = jt.optim.update(grads, jt.opt_state, jt.params)
    jt.params = optax.apply_updates(jt.params, updates)
    jt.ema_state = jema.ema_update(jt.ema_state, jt.params, jt.train_cfg.ema_decay)
    jt.renderer.note_batch_points(num_points, RAYS)
    return frame, k_step, losses, grads, int(num_points), int(num_sig)


def _port_from_jax(tt, jt):
    """Load the JAX trainer's params, optimizer, EMA and occupancy state into
    the port's trainer."""
    params, opt, ema = train_state_from_numpy(_np(jt.params), _np(jt.opt_state),
                                              _np(jt.ema_state))
    tt.params, tt.opt_state, tt.ema_state = tt._trainable(params), opt, ema
    occ = jt.renderer.occ_state
    tt.renderer.restore_occupancy(PersistedOccupancy(*(
        torch.from_numpy(np.array(v)) for v in
        (occ.density_grid, occ.bitfield, occ.mean_density, occ.mean_count, occ.local_step))))


def _assert_leaves_close(got, want, rtol, atol_frac, what):
    """Leaf by leaf; atol is ``atol_frac`` of the leaf's largest value."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i, g.shape, w.shape)
        if g.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_frac * np.abs(w).max(),
                                       err_msg=f"{what} leaf {i}")


def _third_step(scene, tmp_path, amp, extra=()):
    """(JAX results, port results) of the third step from the same state."""
    root, data_cfg = scene
    nargs = TINY if amp else TINY + ["--enable_amp"]  # the flag toggles the default on off
    nargs = nargs + list(extra)
    jt = JTrainer(JBaseConfig(log_dir=tmp_path / "jax", data_cfg=data_cfg), list(nargs))
    vg = _jax_loss_fn(jt)
    for _ in range(2):
        _jax_iter(jt, vg)
    tt = Trainer(BaseConfig(log_dir=tmp_path / "port", data_cfg=data_cfg), list(nargs),
                 device="cpu")
    _port_from_jax(tt, jt)
    frame, k_step, losses, grads, num_points, num_sig = _jax_iter(jt, vg)
    k_pix, _ = jax.random.split(k_step)
    idx = jax.random.randint(k_pix, (RAYS,), 0, 48 * 64)  # the whole 64x48 grid
    kernels.reset_launch_counts()
    o, d, target = tt.ray_batch(frame, torch.from_numpy(np.array(idx)).long())
    t_losses, t_grads, counts = tt.loss_and_grads(o, d, target)
    assert tt.apply_grads(t_grads)
    assert not any(kernels.launch_counts.values())
    return jt, (losses, grads, num_points, num_sig), tt, (t_losses, t_grads, counts)


@pytest.mark.parametrize("amp", [False, True])
def test_torch_train_step_matches_jax(scene, tmp_path, monkeypatch, amp):
    """Loss terms, gradients, Adam moments, updated params and EMA after one
    step from the same state (the JAX step on the 8 virtual CPU devices that
    tests/conftest.py sets up, as its trainer runs there).

    The JAX compositor takes each sample's transmittance from an fp32 flat
    cumsum over the device's whole stream (optical depths summing to
    hundreds here), which puts a relative error of ~1e-4 on T; the port's
    plain compositor sums in float64.  The density gradient d sigma_i = dt
    (T_{i+1} v_i - sum_{k>i} w_k v_k) is a difference of near-equal terms
    and amplifies it.  So, leaf by leaf, as a fraction of the leaf's largest
    value: gradients and Adam moments of the density branch (density_net,
    x_density_embedder) 1e-2; of the color branch 1e-4 in fp32.  Under AMP
    (JAX without its bf16 packing of the table-gradient contributions) both
    round the MLP inputs, weights and cotangents to bf16, and a cotangent
    that lands on the other side of a rounding step moves by 2^-8 of itself:
    2e-2 on every leaf.  Loss terms: rtol 5e-5 (fp32), 1e-4 (AMP).

    Params and EMA: Adam moves every touched element by about lr, whatever
    its gradient's size.  Where this step's gradient is at least 1e-3 of the
    leaf's largest the two steps agree to 5% of lr; below that (a table row
    whose contributions nearly cancel) the step's sign is not determined by
    fp32 sums and the two may differ by up to 2 lr."""
    if amp:
        monkeypatch.setenv("NERFSTYLE_NO_BWD_PACK", "1")
    _check_third_step(*_third_step(scene, tmp_path, amp), amp)


def test_torch_simplex_train_step_matches_jax(scene, tmp_path):
    """The same step with simplex levels from level 2 on (of 4), fp32:
    the tolerances of test_torch_train_step_matches_jax."""
    out = _third_step(scene, tmp_path, False, ["--pos_enc.simplex_from", "2"])
    jt, _, tt, _ = out
    assert tt.field_spec.grid.simplex_start == jt.field_spec.grid.simplex_start == 2
    _check_third_step(*out, False)


def _check_third_step(jt, jax_out, tt, port_out, amp):
    (losses, grads, num_points, num_sig), (t_losses, t_grads, counts) = jax_out, port_out
    assert counts == {"num_points": num_points, "num_sig": num_sig}
    assert num_sig < num_points  # rays saturate: phase B keeps a prefix
    assert set(t_losses) == set(losses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(t_losses[k]), float(v), rtol=1e-4 if amp else 5e-5,
                                   err_msg=k)

    keys = [k for k in sorted(tt.params)
            for _ in (tt.params[k] if isinstance(tt.params[k], list) else [0])]
    t_adam, j_adam = tt.opt_state.inner_state.inner_state[0], jt.opt_state.inner_state.inner_state[0]
    g_jax = jax.tree_util.tree_leaves(grads)
    for what, got, want in (
        ("grad", tree_flatten(t_grads), g_jax),
        ("mu", tree_flatten(t_adam.mu), jax.tree_util.tree_leaves(j_adam.mu)),
        ("nu", tree_flatten(t_adam.nu), jax.tree_util.tree_leaves(j_adam.nu)),
    ):
        assert len(got) == len(want) == len(keys)
        for key, g, w in zip(keys, got, want):
            frac = 2e-2 if amp else (1e-2 if "density" in key else 1e-4)
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=frac * np.abs(w).max(),
                                       err_msg=f"{what} {key}")

    lr = tt.train_cfg.initial_learning_rate
    for what, got, want in (
        ("params", tree_flatten(tt.params), jax.tree_util.tree_leaves(jt.params)),
        ("ema", tree_flatten(tt.ema_state.shadow), jax.tree_util.tree_leaves(jt.ema_state.shadow)),
    ):
        for key, p, w, g in zip(keys, got, want, g_jax):
            diff = np.abs(p.detach().numpy() - np.asarray(w))
            g = np.abs(np.asarray(g))
            determined = g >= 1e-3 * g.max()
            assert diff[determined].max() <= 0.05 * lr, (what, key, diff[determined].max())
            assert diff.max() <= 2.001 * lr, (what, key, diff.max())

    counters = [tt.opt_state.notfinite_count, tt.opt_state.last_finite,
                tt.opt_state.total_notfinite, t_adam.count,
                tt.opt_state.inner_state.inner_state[1].count, tt.ema_state.num_updates]
    j_counters = [jt.opt_state.notfinite_count, jt.opt_state.last_finite,
                  jt.opt_state.total_notfinite, j_adam.count,
                  jt.opt_state.inner_state.inner_state[1].count, jt.ema_state.num_updates]
    assert [v.item() for v in counters] == [np.asarray(v).item() for v in j_counters]
    assert t_adam.count.item() == 3


def test_torch_two_phase_equals_single_phase(scene, tmp_path):
    """The same batch through single-phase and two-phase evaluation: loss
    rtol 1e-6, gradients rtol 1e-4 with atol 1e-7 (as the JAX package's
    tests/test_two_phase_train.py holds its own two paths); the rays
    saturate, so phase B really drops samples."""
    _, data_cfg = scene
    tt = Trainer(BaseConfig(log_dir=tmp_path / "port", data_cfg=data_cfg),
                 TINY + ["--enable_amp"], device="cpu")
    tt.renderer.maybe_update_state(tt.params, tt._occ_gen)
    frame, idx = tt.sample_batch()
    o, d, target = tt.ray_batch(frame, idx)
    out = {}
    for two_phase in (False, True):
        tt.train_cfg.two_phase_train = two_phase
        out[two_phase] = tt.loss_and_grads(o, d, target)
    (l1, g1, c1), (l2, g2, c2) = out[False], out[True]
    assert c1 == c2 and c2["num_sig"] < 0.8 * c2["num_points"]
    for k in l1:
        np.testing.assert_allclose(float(l2[k]), float(l1[k]), rtol=1e-6, err_msg=k)
    for a, b in zip(tree_flatten(g2), tree_flatten(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-7)


def test_torch_nonfinite_step_is_skipped_as_optax_does():
    """The port's Adam against optax's apply_if_finite(masked(adam)) chain on
    a run of finite and non-finite gradients: the skip leaves params and
    moments, grows notfinite_count and total_notfinite, clears last_finite
    and does not advance the lr schedule; the EMA still counts the step."""
    rng = np.random.default_rng(0)
    params_np = {"x_density_embedder": rng.normal(size=(8, 2)).astype(np.float32),
                 "density_net": [rng.normal(size=(4, 3)).astype(np.float32)],
                 "frozen": rng.normal(size=(3,)).astype(np.float32)}
    keys = ["x_density_embedder", "net"]
    mask = {k: jax.tree_util.tree_map(lambda _, k=k: any(kw in k for kw in keys), v)
            for k, v in params_np.items()}
    chain = optax.apply_if_finite(optax.masked(optax.adam(
        optax.exponential_decay(0.01, transition_steps=30, decay_rate=0.1), b1=0.9, b2=0.999,
        eps=1e-15), mask), max_consecutive_errors=1000)
    j_params = jax.tree_util.tree_map(jnp.asarray, params_np)
    j_state = chain.init(j_params)
    j_ema = jema.ema_init(j_params)
    t_params = {k: ([torch.tensor(w) for w in v] if isinstance(v, list) else torch.tensor(v))
                for k, v in params_np.items()}
    adam = topt.Adam(topt.keyword_mask(t_params, keys), 0.01, 30)
    t_state = adam.init(t_params)
    t_ema = ema_init(t_params)
    for step, bad in enumerate([False, True, True, False, False]):
        g_np = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params_np)
        if bad:
            g_np["density_net"][0][1, 2] = np.nan if step == 1 else np.inf
        updates, j_state = chain.update(jax.tree_util.tree_map(jnp.asarray, g_np), j_state,
                                        j_params)
        j_params = optax.apply_updates(j_params, updates)
        j_ema = jema.ema_update(j_ema, j_params, 0.95)
        g_t = {k: ([torch.tensor(w) for w in v] if isinstance(v, list) else torch.tensor(v))
               for k, v in g_np.items()}
        t_state, applied = adam.update(g_t, t_state, t_params)
        t_ema = ema_update(t_ema, t_params, 0.95)
        assert applied == (not bad)
        _assert_leaves_close([v.numpy() for v in tree_flatten(t_state)],
                             jax.tree_util.tree_leaves(j_state), 1e-6, 1e-7, f"state {step}")
        _assert_leaves_close([v.numpy() for v in tree_flatten(t_params)],
                             jax.tree_util.tree_leaves(j_params), 1e-6, 1e-7, f"params {step}")
        _assert_leaves_close([v.numpy() for v in tree_flatten(t_ema)],
                             jax.tree_util.tree_leaves(j_ema), 1e-6, 1e-7, f"ema {step}")
    assert int(t_state.total_notfinite) == 2 and int(t_ema.num_updates) == 5
    assert int(t_state.inner_state.inner_state[1].count) == 3  # applied updates only


def _assert_same_state(tt, jt):
    for group, t_tree, j_tree in (
        ("params", tt.params, jt.params), ("opt_state", tt.opt_state, jt.opt_state),
        ("ema", tt.ema_state, jt.ema_state),
    ):
        _assert_leaves_close([v.detach().numpy() for v in tree_flatten(t_tree)],
                             jax.tree_util.tree_leaves(j_tree), 0, 0, group)
    jo = jt.renderer.occ_state
    _assert_leaves_close([v.numpy() for v in tree_flatten(tt.renderer.occ_state)],
                         [jo.density_grid, jo.bitfield, jo.skipdist, jo.mean_density,
                          jo.mean_count, jo.local_step], 0, 0, "occ")


def test_torch_checkpoints_restore_across_packages(scene, tmp_path):
    """A checkpoint the port's trainer writes restores into the JAX Trainer's
    templates (params, opt_state, ema, occ) with the optimizer state kept,
    renders through ``python -m nerfstyle_torch.render``, and a JAX
    checkpoint restores into the port's trainer."""
    _checkpoints_restore_across_packages(scene, tmp_path, [])


def test_torch_simplex_checkpoints_restore_across_packages(scene, tmp_path):
    """The same with simplex levels (from level 1 on): the port's checkpoint
    keeps its five occupancy leaves and renders in the JAX package; the
    JAX-written one renders in the port, the same frame as the port's."""
    tt, jt, path = _checkpoints_restore_across_packages(
        scene, tmp_path, ["--pos_enc.simplex_from", "1"])
    _, groups = jckpt.load_checkpoint(path)
    assert len(groups["occ"]) == 5
    assert tt.field_spec.grid.simplex_start == jt.field_spec.grid.simplex_start == 1
    _, pose = tt.test_set[0]
    jt.renderer.update_occ = False
    jframe = jt.renderer.render(jt.ema_state.shadow, jnp.asarray(pose), None, training=False)
    assert jframe["rgb_map"].shape == (48 * 64, 3) and np.isfinite(jframe["rgb_map"]).all()
    frames = [render_cli.main([str(p), "--device", "cpu", "--max-count", "1", "--yes",
                               "--out-dir", str(tmp_path / f"render{i}")])["last"]
              for i, p in enumerate((path, tmp_path / "jax_from_port" / "iter_3.ckpt"))]
    assert torch.equal(frames[0]["rgb_map"], frames[1]["rgb_map"])
    assert frames[0]["num_marched"] > 0


def _checkpoints_restore_across_packages(scene, tmp_path, extra):
    _, data_cfg = scene
    nargs = TINY + ["--enable_amp", "--num_iterations", "3"] + extra
    tt = Trainer(BaseConfig(log_dir=tmp_path / "port", data_cfg=data_cfg), list(nargs),
                 device="cpu")
    tt.run()
    path = tt.log_dir / "iter_3.ckpt"
    tt.save_ckpt()
    jt = JTrainer(JBaseConfig(log_dir=tmp_path / "jax_from_port", data_cfg=data_cfg, ckpt=path),
                  list(nargs))
    assert jt.iter_ctr == 3
    assert int(jax.tree_util.tree_leaves(jt.opt_state)[3]) == 3  # Adam count: not a fresh state
    _assert_same_state(tt, jt)

    summary = render_cli.main([str(path), "--device", "cpu", "--max-count", "1", "--yes",
                               "--out-dir", str(tmp_path / "render")])
    frame = summary["last"]
    assert frame["rgb_map"].shape == (48 * 64, 3) and bool(torch.isfinite(frame["rgb_map"]).all())

    jpath = tmp_path / "jax_from_port" / "iter_3.ckpt"
    jt.save_ckpt()
    tt2 = Trainer(BaseConfig(log_dir=tmp_path / "port_from_jax", data_cfg=data_cfg, ckpt=jpath),
                  list(nargs), device="cpu")
    assert tt2.iter_ctr == 3
    _assert_same_state(tt2, jt)
    return tt, jt, path
