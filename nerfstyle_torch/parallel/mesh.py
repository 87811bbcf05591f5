"""Data parallelism over rays on ``torch.distributed`` (counterpart of
``nerfstyle_tpu/parallel/mesh.py``).

The design is the JAX package's:

  * every rank holds the whole model (the hash tables and the MLPs) and the
    whole occupancy grid;
  * each rank marches, evaluates and composites its own shard of the rays
    (rank r takes rows ``[r * N // n, (r + 1) * N // n)`` of a batch of N,
    :meth:`Mesh.rows`, so N need not divide n);
  * the only traffic is sums: loss terms and demand counts forward (one
    collective), then the gradients (one collective over a flat buffer,
    before the optimizer, so ``apply_if_finite``'s skip decision is the
    same on every rank); an occupancy sweep and a rendered chunk gather
    their rows instead.

Every random stream (pixel draws, sparsity points, the occupancy's random
cells, the style stage's pose order) is seeded alike on every rank: each
rank draws the whole batch and takes its slice, so the replicas stay equal
bit for bit without a broadcast.

The functions keep JAX's names without the ``build_`` prefix: JAX builds a
function over its mesh for ``jit``, the port calls them eagerly with the
mesh as their first argument.  Each of them, given a mesh of size 1, is the
unsharded computation.

:class:`Mesh` wraps a process group.  The caller names the backend: NCCL
is the default for ``cuda`` devices and gloo for the CPU; gloo also takes
CUDA tensors (it stages them through host memory itself), which lets two
ranks share one card, while NCCL runs one rank a card and
:func:`make_mesh` raises when asked for more ranks than the host has cards.
A mesh asked for on ``cuda`` keeps every tensor on its card.

Not ported: ``local_plan`` and the budget split.  The port's
:class:`~nerfstyle_torch.ops.marching.MarchPlan` carries no ray count and
no budget: each rank sizes its buffers from the march's count, so no shard
truncates (JAX's even budget split truncates a dense shard).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .. import DeviceLike, resolve_device
from ..core.types import BBox
from ..models.fields import FieldSpec, Params, field_density
from ..ops.marching import MarchPlan, OccField
from ..render.renderer import render_rays

BACKENDS = ("nccl", "gloo")


@dataclass
class MeshStats:
    """What a mesh's collectives moved: their number, the bytes each rank
    handed to them and the host seconds spent in them (with ``Mesh.timed``
    each is bracketed by device syncs, so the seconds are the collective's
    own)."""

    collectives: int = 0
    bytes: int = 0
    seconds: float = 0.0


class Mesh:
    """A data-parallel mesh of ``size`` ranks over one process group: this
    rank's ``rank`` and ``device``.  ``size`` is JAX's ``mesh.devices.size``.
    Its collectives run on the default process group; a mesh of size 1
    has none and issues no collective."""

    def __init__(self, rank: int, size: int, device: torch.device, backend: Optional[str] = None,
                 owns_group: bool = False):
        self.rank, self.size, self.device, self.backend = rank, size, device, backend
        self.owns_group = owns_group
        self.stats = MeshStats()
        self.timed = False

    def __repr__(self) -> str:
        return f"Mesh(rank={self.rank}, size={self.size}, device={self.device}, backend={self.backend})"

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes checkpoints, images, logs and scalars."""
        return self.rank == 0

    def span(self, n: int, rank: Optional[int] = None) -> range:
        """The rows ``[r * n // size, (r + 1) * n // size)`` of rank r (this
        one by default) in a batch of n."""
        r = self.rank if rank is None else rank
        return range(r * n // self.size, (r + 1) * n // self.size)

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of n, as a slice."""
        s = self.span(n)
        return slice(s.start, s.stop)

    def _run(self, fn: Callable[[], None], nbytes: int) -> None:
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        fn()
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.seconds += time.perf_counter() - t0
        self.stats.collectives += 1
        self.stats.bytes += nbytes

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        if self.size > 1:
            self._run(lambda: dist.all_reduce(t),
                      t.numel() * t.element_size())
        return t

    def all_gather_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The whole [n, ...] tensor whose rows :meth:`rows` (n) this rank
        holds as ``t``: one all-gather (the shorter shards padded to the
        longest)."""
        if self.size == 1:
            return t
        sizes = [len(self.span(n, r)) for r in range(self.size)]
        pad = t.new_zeros((max(sizes), *t.shape[1:]))
        pad[:t.shape[0]] = t
        parts = [torch.empty_like(pad) for _ in sizes]
        self._run(lambda: dist.all_gather(parts, pad),
                  pad.numel() * pad.element_size())
        return torch.cat([p[:s] for p, s in zip(parts, sizes)])

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def close(self) -> None:
        """Destroy the process group this mesh created (no other)."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(
    device: DeviceLike = None,
    backend: Optional[str] = None,
    *,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_world_size: Optional[int] = None,
) -> Mesh:
    """A mesh of ``world_size`` ranks (this one ``rank``) on ``device``,
    over a process group of ``backend`` (NCCL for ``cuda``, gloo for the
    CPU by default), initialised from ``init_method`` (``env://``: torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``; ``file://<path>``; ``tcp://host:port``).
    Where a process group already exists it is taken as it is.

    A world of one rank makes a mesh of size 1 and no process group.  NCCL
    with more ranks on this host (``local_world_size``, default the world)
    than it has cards raises: NCCL runs one rank a card, and two ranks
    that share one need ``backend="gloo"``."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return Mesh(dist.get_rank(), dist.get_world_size(), dev, dist.get_backend())
    world_size = 1 if world_size is None else int(world_size)
    rank = 0 if rank is None else int(rank)
    if world_size == 1:
        return Mesh(0, 1, dev, backend)
    backend = backend or _default_backend(dev)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the mesh runs on {BACKENDS}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the NCCL backend needs cuda devices, not {dev}")
        local = world_size if local_world_size is None else int(local_world_size)
        cards = torch.cuda.device_count()
        if local > cards:
            raise ValueError(
                f"NCCL runs one rank a card: {local} ranks on this host but {cards} card(s); "
                f"name backend='gloo' for ranks that share a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, **kw)
    return Mesh(rank, world_size, dev, backend, owns_group=True)


def init_from_env(device: str = "cuda", backend: Optional[str] = None,
                  init_method: Optional[str] = None) -> Optional[Mesh]:
    """The mesh of a process that torchrun started (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/
    ``MASTER_PORT``; or ``init_method``, such as ``file://<path>``), or
    None without those variables.  On ``cuda`` the rank runs on
    ``cuda:LOCAL_RANK``; over gloo, ranks that outnumber the cards share
    them (``cuda:LOCAL_RANK % cards``)."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards if backend == "gloo" else local_rank)
    return make_mesh(dev, backend, init_method=init_method, rank=rank, world_size=world,
                     local_world_size=local_world)


def active(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` where it has more than one rank, else None: a path given a
    mesh of size 1 runs exactly as without one."""
    return mesh if mesh is not None and mesh.size > 1 else None


class _RankSum(torch.autograd.Function):
    """Forward: the sum of ``x`` over the ranks (one all-reduce).  Backward:
    the cotangent passes through unchanged.  Each rank's loss is the same
    function of the reduced sum, so each rank's backward gives its own
    shard's share of the gradient; the one all-reduce of the gradients
    (:func:`all_reduce_grads`) then adds the shares.  (An all-reduce in
    the backward as well, as ``torch.distributed.nn``'s, would give n times
    the gradient.)"""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        return mesh.all_reduce(x.detach().clone())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def rank_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable as :class:`_RankSum`."""
    if mesh.size == 1:
        return x
    return _RankSum.apply(x, mesh)


def all_reduce_grads(mesh: Mesh, grads: Params) -> Params:
    """Sum a gradient tree (leaves: tensors, lists of tensors or None) over
    the ranks: one all-reduce of a flat buffer a dtype (all leaves at once,
    as a bucket).  Returns the tree of the summed leaves."""
    if mesh.size == 1:
        return grads
    slots = [(k, i, g) for k, v in grads.items() if v is not None
             for i, g in enumerate(v if isinstance(v, list) else [v])]
    out: Params = {k: (list(v) if isinstance(v, list) else v) for k, v in grads.items()}
    for dtype in sorted({g.dtype for _, _, g in slots}, key=str):
        group = [(k, i, g) for k, i, g in slots if g.dtype == dtype]
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for _, _, g in group]))
        for (k, i, g), piece in zip(group, flat.split([g.numel() for _, _, g in group])):
            piece = piece.view(g.shape)
            if isinstance(out[k], list):
                out[k][i] = piece
            else:
                out[k] = piece
    return out


def _pack_sums(mesh: Mesh, sums: Sequence[torch.Tensor], counts: Sequence[int]):
    """(the reduced sums in their dtypes, the reduced counts as ints): one
    all-reduce of a float64 buffer (exact for two-term sums of float32 and
    for counts below 2^53); the sums differentiable through it."""
    dev = sums[0].device
    buf = torch.cat([torch.stack([s.to(torch.float64) for s in sums]),
                     torch.tensor([float(c) for c in counts], dtype=torch.float64, device=dev)])
    red = rank_sum(mesh, buf)
    got = [red[i].to(s.dtype) for i, s in enumerate(sums)]
    return got, [int(c) for c in red[len(sums):].tolist()]


def sharded_loss_terms(
    mesh: Mesh,
    spec: FieldSpec,
    plan: MarchPlan,
    params: Params,
    occ: OccField,
    bbox: BBox,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    targets: torch.Tensor,
    sparse_pts: Optional[torch.Tensor] = None,
    *,
    t_thresh: float,
    density_scale: float,
    compute_dtype: torch.dtype = torch.float32,
    with_class: bool = False,
    sparsity_exp_coeff: float = 0.0,
    two_phase: bool = True,
    plain: bool = False,
) -> Dict[str, object]:
    """Per-ray loss sums of a train batch, each summed over the ranks
    (JAX's ``build_sharded_loss_terms``): ``sq`` (the squared rgb error),
    ``nll`` and ``n_lab`` (the class cross-entropy over the labels that are
    not -1, and their count) with ``with_class``, ``sp`` (the sparsity
    term over ``sparse_pts``) with ``sparsity_exp_coeff`` > 0, and the
    host counts ``num_points``, ``num_cand``, ``num_sig``.

    Every rank passes the whole batch (``origins``, ``dirs``, ``targets``
    [N, ...], ``sparse_pts`` [P, 3]) and renders its rows (:meth:`Mesh.rows`).
    One all-reduce carries every sum and count; the sums stay
    differentiable, each rank's backward reaching its own shard
    (:func:`rank_sum`).  The caller turns them into means over the global
    counts."""
    sl = mesh.rows(origins.shape[0])
    out = render_rays(spec, plan, params, occ, bbox, origins[sl], dirs[sl], t_thresh=t_thresh,
                      density_scale=density_scale, compute_dtype=compute_dtype,
                      two_phase=two_phase, plain=plain)
    tgt = targets[sl]
    names, sums = ["sq"], [torch.sum((out["rgb_map"] - tgt[:, :3]) ** 2)]
    if with_class and spec.class_dim > 0:
        labels = tgt[:, 3].to(torch.int64)
        mask = labels != -1
        safe = torch.where(mask, labels, torch.zeros_like(labels))
        nll = -torch.log_softmax(out["classes"], dim=-1).gather(-1, safe[:, None])[:, 0]
        names += ["nll", "n_lab"]
        sums += [torch.where(mask, nll, torch.zeros_like(nll)).sum(),
                 mask.sum().to(torch.float32)]
    if sparsity_exp_coeff > 0.0 and sparse_pts is not None:
        pts = sparse_pts[mesh.rows(sparse_pts.shape[0])]
        sig = field_density(spec, params, bbox, pts, compute_dtype, plain=plain)
        names.append("sp")
        sums.append(torch.sum(torch.abs(1.0 - torch.exp(-sparsity_exp_coeff * sig))))
    counts = {"num_points": out["num_points"], "num_cand": out["num_cand"],
              "num_sig": out["num_sig"]}
    got, reduced = _pack_sums(mesh, sums, list(counts.values()))
    terms: Dict[str, object] = dict(zip(names, got))
    if "n_lab" in terms:
        terms["n_lab"] = terms["n_lab"].detach()
    terms.update(zip(counts, reduced))
    return terms


def sharded_cotangent_sum(
    mesh: Mesh,
    spec: FieldSpec,
    plan: MarchPlan,
    params: Params,
    occ: OccField,
    bbox: BBox,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    cot: torch.Tensor,
    *,
    t_thresh: float,
    density_scale: float,
    compute_dtype: torch.dtype = torch.float32,
    plain: bool = False,
) -> torch.Tensor:
    """``sum(rgb(rays) * cot)`` over the whole batch (JAX's
    ``build_sharded_cotangent_sum``), each rank rendering its rows: the
    scalar whose gradient is the style stage's pass-2 VJP.  Its value is
    summed over the ranks; its gradient on each rank is that rank's share,
    to be summed by :func:`all_reduce_grads`."""
    sl = mesh.rows(origins.shape[0])
    out = render_rays(spec, plan, params, occ, bbox, origins[sl], dirs[sl], t_thresh=t_thresh,
                      density_scale=density_scale, compute_dtype=compute_dtype, plain=plain)
    return rank_sum(mesh, torch.sum(out["rgb_map"] * cot[sl]))


def sharded_density_fn(mesh: Mesh, density_fn: Callable[[Params, torch.Tensor], torch.Tensor]
                       ) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """``density_fn(params, pts) -> sigmas`` split over the ranks by rows of
    ``pts`` (JAX's ``build_sharded_density_fn``): each rank evaluates its
    rows, one all-gather gives every rank all of them, so an occupancy
    sweep leaves the same grid on every rank.  Any point count splits (the
    shards differ by at most a row)."""
    if mesh.size == 1:
        return density_fn

    def f(params: Params, pts: torch.Tensor) -> torch.Tensor:
        return mesh.all_gather_rows(density_fn(params, pts[mesh.rows(pts.shape[0])]),
                                    pts.shape[0])

    return f


def sharded_render_loss(
    mesh: Mesh,
    spec: FieldSpec,
    plan: MarchPlan,
    params: Params,
    occ: OccField,
    bbox: BBox,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    targets: torch.Tensor,
    *,
    t_thresh: float,
    density_scale: float,
    class_lambda: float = 0.0,
    compute_dtype: torch.dtype = torch.float32,
    plain: bool = False,
) -> torch.Tensor:
    """The data-parallel loss over rays (JAX's ``build_sharded_render_loss``):
    ``(sum sq / 3 + class_lambda * sum nll) / N`` over the whole batch of N
    rays, each rank rendering its rows; the same value on every rank, its
    gradient each rank's share."""
    sl = mesh.rows(origins.shape[0])
    out = render_rays(spec, plan, params, occ, bbox, origins[sl], dirs[sl], t_thresh=t_thresh,
                      density_scale=density_scale, compute_dtype=compute_dtype, plain=plain)
    tgt = targets[sl]
    local = torch.sum((out["rgb_map"] - tgt[:, :3]) ** 2) / 3.0
    if class_lambda > 0.0 and spec.class_dim > 0:
        labels = tgt[:, 3].to(torch.int64)
        nll = -torch.log_softmax(out["classes"], dim=-1).gather(-1, labels[:, None])[:, 0]
        local = local + class_lambda * torch.sum(nll)
    return rank_sum(mesh, local) / origins.shape[0]


def sharded_train_step(
    mesh: Mesh,
    spec: FieldSpec,
    plan: MarchPlan,
    optim,
    params: Params,
    opt_state,
    occ: OccField,
    bbox: BBox,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    targets: torch.Tensor,
    *,
    t_thresh: float = 1e-4,
    density_scale: float = 1.0,
    class_lambda: float = 0.0,
    compute_dtype: torch.dtype = torch.float32,
    plain: bool = False,
):
    """One data-parallel train step (JAX's ``build_sharded_train_step``):
    :func:`sharded_render_loss`, its gradient, one all-reduce of the
    gradients, and ``optim`` (the port's
    :class:`~nerfstyle_torch.training.optim.Adam`, which updates ``params``
    in place; every leaf of ``params`` requires grad).  Returns (params,
    opt_state, loss)."""
    from ..training.trainer import _grad_tree  # the trainer imports this module

    loss = sharded_render_loss(mesh, spec, plan, params, occ, bbox, origins, dirs, targets,
                               t_thresh=t_thresh, density_scale=density_scale,
                               class_lambda=class_lambda, compute_dtype=compute_dtype,
                               plain=plain)
    grads = all_reduce_grads(mesh, _grad_tree(params, loss))
    opt_state, _ = optim.update(grads, opt_state, params)
    return params, opt_state, loss.detach()

