"""Port parity of data parallelism over rays (``nerfstyle_torch/parallel``)
against the JAX package's ``parallel/mesh.py`` on the CPU, and of the
port's sharded paths against its own unsharded ones.

World size 2 over gloo, in one spawn for the whole module: the ranks'
side is ``tests/torch_parallel_ranks.py`` (torch and the port only), which
writes what every test here reads.  Small sizes: a 3-level grid, 64 rays
and an 8^3 occupancy grid for the sharded functions (the set-up of
``tests/test_parallel.py``, its inputs drawn with numpy), the tiny configs
of ``tests/test_torch_train_step.py`` for the trainers.

JAX's side runs on ``make_mesh(2)`` of the 8 virtual CPU devices of
``tests/conftest.py``, with a march budget of every lattice sample, so no
shard of JAX's truncates.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_parallel_ranks as ranks
from nerfstyle_torch import utils
from nerfstyle_torch.config import BaseConfig
from nerfstyle_torch.models.fields import params_from_numpy, train_state_from_numpy
from nerfstyle_torch.parallel import Mesh, init_from_env, make_mesh
from nerfstyle_torch.training.checkpoint import tree_flatten
from nerfstyle_torch.training.trainer import Trainer
from nerfstyle_tpu.config import BaseConfig as JBaseConfig
from nerfstyle_tpu.core.types import BBox as JBBox
from nerfstyle_tpu.data.synthetic import generate_scene
from nerfstyle_tpu.models.fields import field_density as jfield_density
from nerfstyle_tpu.models.fields import field_init as jfield_init
from nerfstyle_tpu.models.fields import style_field_spec as jstyle_field_spec
from nerfstyle_tpu.ops.hashgrid import hashgrid_spec as jhashgrid_spec
from nerfstyle_tpu.ops.marching import MarchPlan as JMarchPlan
from nerfstyle_tpu.parallel import mesh as jmesh
from nerfstyle_tpu.training.trainer import Trainer as JTrainer
from test_torch_train_step import RAYS, TINY, _check_third_step, _jax_iter, _jax_loss_fn, _np

FP32 = TINY + ["--enable_amp"]  # the flag toggles the default on off
# The port checks: sparsity points (64: an even split) and the weight
# regularizer, occupancy updates every 2 steps (random from step 2).
PORT = FP32 + ["--update_iter", "2", "--update_thres", "2", "--sparsity_lambda", "1e-3",
               "--sparsity_samples", "64", "--weight_reg_lambda", "1e-6"]
STEPS = 64  # the sharded functions' max_steps
NET = TINY[4:14]  # the network and renderer flags of TINY
STYLE = NET + ["--enable_amp", "--defer_patch_size", "64", "--max_eval_count", "1",
               "--intervals.print", "0", "--intervals.log", "0", "--intervals.test", "0",
               "--intervals.ckpt", "0"]


def _functions_inputs():
    """JAX's field and occupancy of tests/test_parallel.py (its plan at 64
    steps); rays, targets (a few labels -1), sparsity points, a cotangent
    and density points from numpy."""
    spec = jstyle_field_spec(jhashgrid_spec(3, 2, 8, per_level_scale=1.5, log2_hashmap_size=8),
                             class_dim=3)
    params = jfield_init(jax.random.PRNGKey(0), spec)
    plan = JMarchPlan(bound=1.0, cascade=1, grid_size=8, max_steps=STEPS, num_rays=64,
                      budget=64 * STEPS, min_near=0.05)
    rng = np.random.default_rng(0)
    bitfield = rng.random(8**3) < 0.6
    o = (rng.normal(size=(64, 3)) * 2.0).astype(np.float32)
    # Aimed near the centre, so that most rays cross the grid.
    d = (-o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.3 * rng.normal(size=(64, 3)))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    targets = rng.random((64, 4)).astype(np.float32)
    targets[:, 3] = np.floor(targets[:, 3] * 3)
    valid = targets.copy()  # JAX's mean loss reads every label
    targets[::7, 3] = -1
    sparse = rng.uniform(-1.0, 1.0, size=(16, 3)).astype(np.float32)
    cot = rng.normal(size=(64, 3)).astype(np.float32)
    dpts = rng.uniform(-1.0, 1.0, size=(1000, 3)).astype(np.float32)
    return spec, params, plan, dict(bitfield=bitfield, origins=o, dirs=d, targets=targets,
                                    targets_valid=valid, sparse_pts=sparse, cot=cot,
                                    density_pts=dpts)


def _jax_functions(spec, params, plan, x):
    """JAX's sharded loss terms, cotangent-sum gradient and density sweep on
    a 2-device mesh."""
    mesh2 = jmesh.make_mesh(2)
    bbox = JBBox.from_radius(1.0)
    a = {k: jnp.asarray(v) for k, v in x.items()}
    terms = jax.jit(jmesh.build_sharded_loss_terms(
        mesh2, spec, plan, 1e-4, 1.0, with_class=True, sparsity_exp_coeff=0.05,
        field_density_fn=lambda p, bb, pts: jfield_density(spec, p, bb, pts, use_dedup=False),
    ))(params, a["bitfield"], bbox, a["origins"], a["dirs"], a["targets"], a["sparse_pts"])
    # Under jit, as JAX's own sharded loss is (eager transposition of a
    # shard_map trips XLA's sharding check).
    cot_sum = jmesh.build_sharded_cotangent_sum(mesh2, spec, plan, 1e-4, 1.0)
    value, grads = jax.jit(jax.value_and_grad(cot_sum))(params, a["bitfield"], bbox,
                                                        a["origins"], a["dirs"], a["cot"])
    density = jax.jit(jmesh.build_sharded_density_fn(
        mesh2, lambda p, pts: jfield_density(spec, p, bbox, pts, use_dedup=False)))
    rays = (a["origins"], a["dirs"], a["targets_valid"])
    loss = jmesh.build_sharded_render_loss(mesh2, spec, plan, 1e-4, 1.0, 0.001)
    loss_value, loss_grads = jax.value_and_grad(loss)(params, a["bitfield"], bbox, *rays)
    return {"terms": {k: np.asarray(v) for k, v in terms.items()}, "cot_sum": float(value),
            "cot_grads": _np(grads), "density": np.asarray(density(params, a["density_pts"])),
            "render_loss": float(loss_value), "render_grads": _np(loss_grads)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every check of the module in one spawn of two ranks; the JAX side of
    each, computed here."""
    root = tmp_path_factory.mktemp("parallel")
    generate_scene(root / "scene", num_train=6, num_test=2, h=48, w=64)
    data_cfg = root / "data.yaml"
    data_cfg.write_text(f"root_path: {root / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")

    spec, params, plan, x = _functions_inputs()
    functions = {k: torch.from_numpy(v) for k, v in x.items()}
    functions["params"] = params_from_numpy(_np(params))
    functions["max_steps"] = STEPS
    yy, xx = np.meshgrid(np.linspace(0, 1, 30), np.linspace(0, 1, 40), indexing="ij")
    png, seg = root / "style.png", root / "style_seg.npz"
    utils.save_image(np.stack([yy, xx, 1 - yy], axis=-1).astype(np.float32), png)
    np.savez(seg, seg_map=(yy > 0.5).astype(np.int64) * 2 + (xx > 0.5).astype(np.int64))
    port = dict(data_cfg=str(data_cfg), nargs=PORT, style_image=str(png),
                style_nargs=STYLE + ["--style_seg_path", str(seg)])
    job_dir = root / "job"
    job_dir.mkdir()
    torch.save({"functions": functions, "port": port}, job_dir / "job.pt")
    ctx = ranks.start(job_dir)

    try:
        # Meanwhile JAX's side: the sharded functions, then the third step of
        # test_torch_train_step.py, fp32 (the JAX trainer's two steps, its state
        # for the ranks, then its third step on 8 devices).
        jax_functions = _jax_functions(spec, params, plan, x)
        jt = JTrainer(JBaseConfig(log_dir=root / "jax", data_cfg=data_cfg), list(FP32))
        assert jt.mesh is not None and jt.mesh.devices.size == 8
        vg = _jax_loss_fn(jt)
        for _ in range(2):
            _jax_iter(jt, vg)
        t_params, t_opt, t_ema = train_state_from_numpy(_np(jt.params), _np(jt.opt_state),
                                                        _np(jt.ema_state))
        occ = jt.renderer.occ_state
        occ = [torch.from_numpy(np.array(v)) for v in
               (occ.density_grid, occ.bitfield, occ.mean_density, occ.mean_count, occ.local_step)]
        frame, k_step, losses, grads, num_points, num_sig = _jax_iter(jt, vg)
        k_pix, _ = jax.random.split(k_step)
        idx = torch.from_numpy(np.array(jax.random.randint(k_pix, (RAYS,), 0, 48 * 64))).long()
        torch.save(dict(data_cfg=str(data_cfg), nargs=FP32, params=t_params, opt_state=t_opt,
                        ema=t_ema, occ=occ, frame=frame, idx=idx), job_dir / "jax_step.tmp")
        os.replace(job_dir / "jax_step.tmp", job_dir / "jax_step.pt")
    except BaseException:
        for p in ctx.processes:
            p.terminate()
        raise
    out = ranks.finish(ctx, job_dir)
    return types.SimpleNamespace(ranks=out, jax_functions=jax_functions, jt=jt,
                                 jax_step=(losses, grads, num_points, num_sig), data_cfg=data_cfg,
                                 root=root)


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree):
    return [t.detach() if torch.is_tensor(t) else t for t in tree_flatten(tree)]


def test_torch_sharded_loss_terms_match_jax(run):
    """``sharded_loss_terms`` against JAX's ``build_sharded_loss_terms`` on
    the same inputs: the counts exactly (marched samples, candidate
    windows, included samples, valid labels), the sums at rtol 1e-5; both
    ranks hold the same reduced values."""
    want = run.jax_functions["terms"]
    for out in run.ranks:
        got = out["functions"]["terms"]
        assert set(got) == set(want)
        for k in ("num_points", "num_cand", "num_sig"):
            assert got[k] == int(want[k]), k
        assert float(got["n_lab"]) == float(want["n_lab"])
        for k in ("sq", "nll", "sp"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert run.ranks[0]["functions"]["terms"]["num_points"] > 64 * 4


def test_torch_sharded_cotangent_sum_matches_jax(run):
    """The gradient of ``sharded_cotangent_sum`` (each rank's share summed
    by ``all_reduce_grads``) against ``jax.grad`` of JAX's
    ``build_sharded_cotangent_sum``, leaf by leaf at relative L2 1e-4 (the
    pass-2 tolerance of tests/test_torch_style_two_pass.py, fp32); the
    value at rtol 1e-5."""
    want = run.jax_functions
    want_leaves = jax.tree_util.tree_leaves(want["cot_grads"])
    for out in run.ranks:
        got = out["functions"]
        np.testing.assert_allclose(float(got["cot_sum"]), want["cot_sum"], rtol=1e-5)
        leaves = _leaves(got["cot_grads"])
        assert len(leaves) == len(want_leaves)
        for g, w in zip(leaves, want_leaves):
            assert rel_l2(g.numpy(), w) <= 1e-4
    a, b = (_leaves(r["functions"]["cot_grads"]) for r in run.ranks)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_torch_sharded_density_fn_matches_jax(run):
    """``sharded_density_fn`` against JAX's ``build_sharded_density_fn`` at
    rtol 1e-6 (1000 points, 500 a rank); over 999 points (an uneven split,
    which JAX does not shard) equal to the unsharded call bit for bit."""
    for out in run.ranks:
        got = out["functions"]
        np.testing.assert_allclose(got["density"].numpy(), run.jax_functions["density"],
                                   rtol=1e-6, atol=1e-7)
        assert torch.equal(got["density_odd"], got["density_odd_plain"])


def test_torch_sharded_render_loss_and_train_step_match_jax(run):
    """The library API (``parallel/__init__.py``'s exports, as JAX's):
    ``sharded_render_loss`` against ``build_sharded_render_loss`` (the
    value at rtol 1e-5, its gradient leaf by leaf at relative L2 1e-4);
    ``sharded_train_step`` reports that loss and leaves the params of the
    port's Adam applied by hand to that gradient, bit for bit."""
    want = run.jax_functions
    g_want = jax.tree_util.tree_leaves(want["render_grads"])
    for out in run.ranks:
        got = out["functions"]
        np.testing.assert_allclose(float(got["render_loss"]), want["render_loss"], rtol=1e-5)
        assert float(got["step_loss"]) == float(got["render_loss"])
        for g, w in zip(_leaves(got["render_grads"]), g_want):
            assert rel_l2(g.numpy(), w) <= 1e-4
        assert all(torch.equal(a, b) for a, b in zip(got["stepped"], got["stepped_by_hand"]))
        assert got["step_moved"] > 0.5e-2  # Adam's first step: about lr (1e-2)


def test_torch_sharded_train_step_matches_jax(run):
    """One step of the port's Trainer at world size 2 from the JAX trainer's
    state against the JAX Trainer's step on its 8-device mesh, on the same
    frame and pixels: tests/test_torch_train_step.py's checks and
    tolerances (fp32); the two ranks' steps equal bit for bit."""
    a, b = (r["jax_step"] for r in run.ranks)
    tt = types.SimpleNamespace(params=a["params"], opt_state=a["opt_state"], ema_state=a["ema"],
                               train_cfg=types.SimpleNamespace(initial_learning_rate=a["lr"]))
    _check_third_step(run.jt, run.jax_step, tt, (a["losses"], a["grads"], a["counts"]), False)
    assert a["counts"] == b["counts"]
    for k in a["losses"]:
        assert torch.equal(a["losses"][k], b["losses"][k]), k
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a["params"]), _leaves(b["params"])))


def test_torch_sharded_train_step_matches_unsharded(run):
    """The port's sharded train step (sparsity points and the weight
    regularizer on) against the same batch unsharded: the counts equal, the
    losses at rtol 1e-6, every gradient leaf at relative L2 <= 1e-5."""
    for out in run.ranks:
        (l_s, g_s, c_s), (l_u, g_u, c_u) = out["train_step"]
        assert c_s == c_u and set(l_s) == set(l_u) >= {"sparsity", "weight_reg", "class"}
        for k in l_u:
            np.testing.assert_allclose(float(l_s[k]), float(l_u[k]), rtol=1e-6, err_msg=k)
        for a, b in zip(_leaves(g_s), _leaves(g_u)):
            assert rel_l2(a.numpy(), b.numpy()) <= 1e-5


def test_torch_sharded_amp_step_matches_unsharded(run):
    """Under mixed precision (bf16 MLPs, the trainer's default) the sharded
    step against the unsharded one: the counts equal, the losses at rtol
    1e-6, the hash tables' gradients at relative L2 <= 1e-5 and the MLP
    weights' at most 5e-3 (the card's step tolerance), the largest above
    1e-4.  Each rank's cotangent of a bf16 weight is rounded to bf16 before
    the ranks' sum, as each JAX device's is before its psum, so a weight's
    gradient takes two roundings where the unsharded step takes one."""
    for out in run.ranks:
        (l_s, g_s, c_s), (l_u, g_u, c_u) = out["amp_step"]
        assert c_s == c_u
        for k in l_u:
            np.testing.assert_allclose(float(l_s[k]), float(l_u[k]), rtol=1e-6, err_msg=k)
        mlp = []
        for k in g_u:
            for a, b in zip(_leaves(g_s[k]), _leaves(g_u[k])):
                err = rel_l2(a.numpy(), b.numpy())
                if k.endswith("_embedder"):
                    assert err <= 1e-5, k
                else:
                    assert err <= 5e-3, k
                    mlp.append(err)
        assert max(mlp) > 1e-4


def test_torch_batch_that_does_not_divide_the_ranks_runs_unsharded(run):
    """A trainer of 255 rays a batch on two ranks keeps its ranks (rank 0
    writes, the others wait) but shards neither its steps nor its renderer,
    as JAX's trainer runs unsharded when the batch does not divide its
    devices."""
    for out in run.ranks:
        assert out["odd_batch"] == (True, None, None)


def test_torch_sharded_cached_style_step_matches_unsharded(run):
    """A cached style step: each rank colours half of the cache's stream and
    the partial images are summed; the losses at rtol 1e-6 and the table
    gradient at relative L2 <= 1e-5 against the unsharded step."""
    for out in run.ranks:
        (l_s, g_s), (l_u, g_u) = out["cached"]
        for k in l_u:
            np.testing.assert_allclose(float(l_s[k]), float(l_u[k]), rtol=1e-6, err_msg=k)
        assert g_s["x_color_embedder"].abs().max() > 0
        assert rel_l2(g_s["x_color_embedder"], g_u["x_color_embedder"]) <= 1e-5
        assert all(g_s[k] is None for k in g_s if k != "x_color_embedder")


def test_torch_sharded_two_pass_matches_unsharded(run):
    """Pass 1 gathered from the ranks equals the unsharded frame bit for bit;
    pass 2 (one 64 x 48 window, half its rays a rank) gives the table
    gradient at relative L2 <= 1e-5."""
    for out in run.ranks:
        (rgb_s, cls_s), (rgb_u, cls_u) = out["pass1"]
        assert torch.equal(rgb_s, rgb_u) and torch.equal(cls_s, cls_u)
        w_s, w_u = out["window"]
        assert out["windows"] == 1 and w_s["x_color_embedder"].abs().max() > 0
        assert rel_l2(w_s["x_color_embedder"], w_u["x_color_embedder"]) <= 1e-5


@pytest.mark.parametrize("scheme", ["two-phase", "incremental"])
def test_torch_sharded_frame_equals_unsharded(run, scheme):
    """A test frame through ``Renderer.render`` in chunks of 1000 rays, each
    rank rendering half of a chunk: every map bit-equal to the unsharded
    frame and the counters equal."""
    for out in run.ranks:
        sharded, plain = out["frames"][scheme]
        assert set(sharded) == set(plain)
        for k, v in plain.items():
            if torch.is_tensor(v):
                assert torch.equal(sharded[k], v), k
            else:
                assert sharded[k] == v, k
        assert plain["weights_sum"].max() > 0.5


def test_torch_replicas_stay_in_step(run):
    """After 4 sharded train steps (occupancy updates at steps 0 and 2, the
    second a random update) the two ranks' params, Adam moments and count,
    EMA, and occupancy (bitfield, densities, skip distance, mean count)
    are equal bit for bit; so are the colour table and the losses after a
    cached and a two-pass style iteration."""
    a, b = (r["train_state"] for r in run.ranks)
    assert int(a["local_step"]) == 4 and int(a["count"]) == 4
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, list):
            assert all(torch.equal(x, y) for x, y in zip(va, vb)), k
        else:
            assert torch.equal(va, vb), k
    assert run.ranks[0]["update_ms"]["random"] and run.ranks[0]["update_ms"]["full"]
    assert torch.equal(run.ranks[0]["style_table"], run.ranks[1]["style_table"])
    for la, lb in zip(run.ranks[0]["style_losses"], run.ranks[1]["style_losses"]):
        assert all(torch.equal(la[k], lb[k]) for k in la)
    assert run.ranks[0]["stats"]["collectives"] > 0


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_torch_mesh_of_one_rank_issues_the_same_operators(run, tmp_path):
    """A Trainer given a mesh of one rank (no process group) shards nothing:
    one step issues the operator sequence of a Trainer without a mesh, and
    takes the same step."""
    one = make_mesh("cpu")
    assert one.size == 1 and not one.owns_group and not torch.distributed.is_initialized()
    seqs, params = [], []
    for mesh in (None, one):
        tt = Trainer(BaseConfig(log_dir=tmp_path / str(mesh is None), data_cfg=run.data_cfg),
                     PORT + ["--grid_size", "16"], device="cpu", mesh=mesh)
        assert tt.mesh is None and tt.renderer.mesh is None
        with _Ops() as rec:
            tt.run_iter()
        seqs.append(rec.ops)
        params.append(_leaves(tt.params))
    assert len(seqs[0]) > 100 and seqs[0] == seqs[1]
    assert all(torch.equal(x, y) for x, y in zip(*params))


def test_torch_mesh_refuses_what_it_cannot_run(monkeypatch):
    """NCCL with two ranks on a host of one card raises before any process
    group is made, naming the cause; NCCL on the CPU raises; without
    torchrun's variables there is no mesh, and a world of one is a mesh of
    size 1 without a process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank a card"):
        make_mesh("cuda:0", "nccl", rank=0, world_size=2)
    with pytest.raises(ValueError, match="needs cuda devices"):
        make_mesh("cpu", "nccl", rank=0, world_size=2)
    with pytest.raises(ValueError, match="runs on"):
        make_mesh("cpu", "mpi", rank=0, world_size=2)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert init_from_env("cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    mesh = init_from_env("cpu")
    assert isinstance(mesh, Mesh) and mesh.size == 1 and not mesh.owns_group
    assert not torch.distributed.is_initialized()
