"""Rank side of ``tests/test_torch_parallel.py``: the checks that run in
each rank of a two-rank gloo mesh on the CPU, started by :func:`run` with
``torch.multiprocessing.spawn``.

A spawned child re-imports this module, so it imports torch, numpy and
``nerfstyle_torch`` only (no JAX, no ``conftest.py``).  The test writes the
inputs (``job.pt``, then ``jax_step.pt`` while the ranks run); each rank
runs every check in one go, one torch thread a rank, and writes what the
test compares to ``rank<r>.pt``.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

from nerfstyle_torch.config import BaseConfig
from nerfstyle_torch.core.types import BBox
from nerfstyle_torch.models.fields import field_density, style_field_spec
from nerfstyle_torch.ops.hashgrid import hashgrid_spec
from nerfstyle_torch.ops.marching import MarchPlan, OccField
from nerfstyle_torch.ops.occupancy import PersistedOccupancy
from nerfstyle_torch.parallel import mesh as pmesh
from nerfstyle_torch.training.checkpoint import tree_flatten
from nerfstyle_torch.training.optim import Adam
from nerfstyle_torch.training.style_trainer import StyleTrainer
from nerfstyle_torch.training.trainer import Trainer, _grad_tree

WORLD = 2


def start(job_dir: Path):
    """Spawn the ranks on ``job_dir/job.pt`` without waiting for them: they
    run the port's checks, then wait for ``job_dir/jax_step.pt`` (which the
    test writes meanwhile) and run the JAX step's.  Join with :func:`finish`."""
    return mp.spawn(_rank_main, args=(str(job_dir),), nprocs=WORLD, join=False)


def finish(ctx, job_dir: Path) -> list:
    """Wait for the ranks (a rank's exception is raised here); each rank's
    results."""
    while not ctx.join():
        pass
    return [torch.load(Path(job_dir) / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _wait_for(path: Path, seconds: float = 600.0):
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > seconds:
            raise TimeoutError(f"no {path} after {seconds} s")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def _rank_main(rank: int, job_dir: str) -> None:
    torch.set_num_threads(1)
    job_dir = Path(job_dir)
    job = torch.load(job_dir / "job.pt", weights_only=False)
    mesh = pmesh.make_mesh("cpu", "gloo", init_method=f"file://{job_dir / 'init'}", rank=rank,
                           world_size=WORLD)
    try:
        t0 = time.perf_counter()
        out = {"functions": sharded_functions(mesh, job["functions"])}
        out.update(port_checks(mesh, job["port"], job_dir / "port"))
        t1 = time.perf_counter()
        out["jax_step"] = jax_step(mesh, _wait_for(job_dir / "jax_step.pt"), job_dir / "jax_step")
        out["stats"] = dataclasses.asdict(mesh.stats)
        out["seconds"] = {"port": t1 - t0, "jax step": time.perf_counter() - t1}
        torch.save(out, job_dir / f"rank{rank}.pt")
    finally:
        mesh.close()


def sharded_functions(mesh, f) -> dict:
    """The port's sharded functions on the inputs of JAX's: the loss terms,
    the cotangent sum's gradient, the density sweep (also over an odd
    point count, against the unsharded call), the mean loss with its
    gradient and one train step (the last moves ``params``)."""
    spec = style_field_spec(hashgrid_spec(3, 2, 8, 1.5, 8), class_dim=3)
    plan = MarchPlan(bound=1.0, cascade=1, grid_size=8, max_steps=f["max_steps"], min_near=0.05)
    bbox, occ, params = BBox.from_radius(1.0), OccField(f["bitfield"]), f["params"]
    common = dict(t_thresh=1e-4, density_scale=1.0)
    terms = pmesh.sharded_loss_terms(mesh, spec, plan, params, occ, bbox, f["origins"], f["dirs"],
                                     f["targets"], f["sparse_pts"], with_class=True,
                                     sparsity_exp_coeff=0.05, two_phase=False, **common)
    for w in tree_flatten(params):
        w.requires_grad_(True)
    s = pmesh.sharded_cotangent_sum(mesh, spec, plan, params, occ, bbox, f["origins"],
                                    f["dirs"], f["cot"], **common)
    grads = pmesh.all_reduce_grads(mesh, _grad_tree(params, s))
    for w in tree_flatten(params):
        w.requires_grad_(False)

    def density(p, pts):
        return field_density(spec, p, bbox, pts)

    sharded = pmesh.sharded_density_fn(mesh, density)
    odd = f["density_pts"][:-1]
    sweeps = {"density": sharded(params, f["density_pts"]), "density_odd": sharded(params, odd),
              "density_odd_plain": density(params, odd)}

    # The library API: the mean loss, its gradient, and one Adam step.
    rays = (f["origins"], f["dirs"], f["targets_valid"])
    for w in tree_flatten(params):
        w.requires_grad_(True)
    loss = pmesh.sharded_render_loss(mesh, spec, plan, params, occ, bbox, *rays,
                                     class_lambda=0.001, **common)
    loss_grads = pmesh.all_reduce_grads(mesh, _grad_tree(params, loss))
    optim = Adam({k: True for k in params}, 1e-2, 0)
    by_hand = {k: [w.detach().clone() for w in v] if isinstance(v, list) else v.detach().clone()
               for k, v in params.items()}
    optim.update(loss_grads, optim.init(by_hand), by_hand)
    before = [w.detach().clone() for w in tree_flatten(params)]
    stepped, _, step_loss = pmesh.sharded_train_step(mesh, spec, plan, optim, params,
                                                     optim.init(params), occ, bbox, *rays,
                                                     class_lambda=0.001, **common)
    return {"terms": {k: v.detach() if torch.is_tensor(v) else v for k, v in terms.items()},
            "cot_sum": s.detach(), "cot_grads": grads, **sweeps, "render_loss": loss.detach(), "render_grads": loss_grads,
            "step_loss": step_loss, "stepped": [w.detach() for w in tree_flatten(stepped)],
            "stepped_by_hand": tree_flatten(by_hand),
            "step_moved": max(float((w.detach() - b).abs().max())
                              for w, b in zip(tree_flatten(stepped), before))}


def jax_step(mesh, j, log_dir: Path) -> dict:
    """The third step of ``tests/test_torch_train_step.py`` at world size 2:
    the port's Trainer from the JAX trainer's state, on the JAX step's frame
    and pixels, each rank rendering half of them."""
    tt = Trainer(BaseConfig(log_dir=log_dir, data_cfg=Path(j["data_cfg"])), list(j["nargs"]),
                 device="cpu", mesh=mesh)
    assert tt.mesh is mesh and tt.renderer.mesh is mesh
    tt.params, tt.opt_state, tt.ema_state = tt._trainable(j["params"]), j["opt_state"], j["ema"]
    tt.renderer.restore_occupancy(PersistedOccupancy(*j["occ"]))
    o, d, target = tt.ray_batch(j["frame"], j["idx"])
    losses, grads, counts = tt.loss_and_grads(o, d, target)
    assert tt.apply_grads(grads)
    return {"losses": losses, "grads": grads, "counts": counts, "params": tt.params,
            "opt_state": tt.opt_state, "ema": tt.ema_state,
            "lr": tt.train_cfg.initial_learning_rate}


def _unsharded(obj, fn):
    """``fn()`` with ``obj``'s mesh (and its renderer's) set aside."""
    saved = obj.mesh, obj.renderer.mesh
    obj.mesh = obj.renderer.mesh = None
    try:
        return fn()
    finally:
        obj.mesh, obj.renderer.mesh = saved


def _step_pair(tt):
    """After an occupancy update, one batch's (losses, gradients, counts)
    sharded, then unsharded on the same draws."""
    tt.renderer.maybe_update_state(tt.params, tt._occ_gen)
    o, d, target = tt.ray_batch(*tt.sample_batch())
    gen = tt._data_gen.get_state()
    step = tt.loss_and_grads(o, d, target)
    tt._data_gen.set_state(gen)
    return step, _unsharded(tt, lambda: tt.loss_and_grads(o, d, target))


def _frames(tt, pose) -> dict:
    """The test pose's frame sharded and unsharded, two-phase and
    incremental, in uneven chunks (1000 rays: ranks of 500; the last chunk
    smaller)."""
    r = tt.renderer
    base = r.settings
    out = {}
    with torch.no_grad():
        for scheme, settings in (("two-phase", base),
                                 ("incremental", dataclasses.replace(base, infer_two_phase=False))):
            r.settings = settings
            sharded = r.render(tt.params, pose, chunk=1000)
            plain = _unsharded(tt, lambda: r.render(tt.params, pose, chunk=1000))
            out[scheme] = (sharded, plain)
    r.settings = base
    return out


def _state(tt) -> dict:
    occ = tt.renderer.occ_state
    adam = tt.opt_state.inner_state.inner_state[0]
    return {"params": tree_flatten(tt.params), "mu": tree_flatten(adam.mu),
            "nu": tree_flatten(adam.nu), "count": adam.count,
            "ema": tree_flatten(tt.ema_state.shadow), "bitfield": occ.bitfield,
            "density_grid": occ.density_grid, "skipdist": occ.skipdist,
            "mean_count": occ.mean_count, "local_step": occ.local_step}


def port_checks(mesh, p, log_dir: Path) -> dict:
    """Sharded against unsharded in the port (a train step in fp32 and
    under mixed precision, a cached style
    step, pass 1 and a pass-2 window, both frame schemes), the state of the
    replicas after training and style iterations, and a trainer whose
    batch does not divide the ranks."""
    data_cfg = Path(p["data_cfg"])
    odd = list(p["nargs"])
    odd[odd.index("--num_rays_per_batch") + 1] = "255"
    tt = Trainer(BaseConfig(log_dir=log_dir / "odd", data_cfg=data_cfg), odd, device="cpu",
                 mesh=mesh)
    odd_batch = (tt.world is mesh, tt.mesh, tt.renderer.mesh)
    amp = Trainer(BaseConfig(log_dir=log_dir / "amp", data_cfg=data_cfg),
                  [a for a in p["nargs"] if a != "--enable_amp"], device="cpu", mesh=mesh)
    assert amp.compute_dtype == torch.bfloat16
    amp_step = _step_pair(amp)
    tt = Trainer(BaseConfig(log_dir=log_dir / "train", data_cfg=data_cfg), list(p["nargs"]),
                 device="cpu", mesh=mesh)
    step = _step_pair(tt)
    # Four iterations (no step was applied above): occupancy updates at 0
    # (a full sweep) and 2 (a random update).
    for _ in range(4):
        tt.run_iter()
    out = {"odd_batch": odd_batch, "train_step": step, "amp_step": amp_step,
           "train_state": _state(tt), "update_ms": dict(tt.renderer.update_ms)}
    pose = torch.from_numpy(np.asarray(tt.test_set[0][1]))
    out["frames"] = _frames(tt, pose)
    ckpt = tt.save_ckpt()

    st = StyleTrainer(BaseConfig(log_dir=log_dir / "style", data_cfg=data_cfg, ckpt=ckpt,
                                 style_image=Path(p["style_image"])),
                      list(p["style_nargs"]), device="cpu", mesh=mesh)
    pose_idx = 1
    cache = st.geom_cache(pose_idx)
    st.init_matching(cache)
    cached = st.loss_and_grads(cache)
    cached_plain = _unsharded(st, lambda: st.loss_and_grads(cache))
    with torch.no_grad():
        frame_s = st.render_frame(st.params, pose_idx)
        frame_p = _unsharded(st, lambda: st.render_frame(st.params, pose_idx))
    _, pix = st.pixel_grad(frame_p[0], st.target(pose_idx), st._preds(frame_p[1]))
    window = st.window_grads(st.params, pose_idx, pix)
    window_plain = _unsharded(st, lambda: st.window_grads(st.params, pose_idx, pix))
    out.update({"cached": (cached, cached_plain), "pass1": (frame_s, frame_p),
                "window": (window, window_plain), "windows": len(st.window_tiling()[0])})
    # A cached and a two-pass iteration through run_iter, then the table.
    st.run_iter()
    st.train_cfg.style_geom_cache = False
    st.run_iter()
    out["style_table"] = st.params["x_color_embedder"].detach()
    out["style_losses"] = st.loss_history
    return out
