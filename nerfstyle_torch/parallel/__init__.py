"""Data parallelism over rays (counterpart of ``nerfstyle_tpu/parallel``):
see :mod:`nerfstyle_torch.parallel.mesh`."""

from .mesh import (
    Mesh,
    MeshStats,
    all_reduce_grads,
    init_from_env,
    make_mesh,
    rank_sum,
    sharded_cotangent_sum,
    sharded_density_fn,
    sharded_loss_terms,
    sharded_render_loss,
    sharded_train_step,
)

__all__ = [
    "Mesh",
    "MeshStats",
    "all_reduce_grads",
    "init_from_env",
    "make_mesh",
    "rank_sum",
    "sharded_cotangent_sum",
    "sharded_density_fn",
    "sharded_loss_terms",
    "sharded_render_loss",
    "sharded_train_step",
]
