"""Row gather, ``out = table[idx]`` (counterpart of the one ``pallas_call`` of
the repository, ``tools/exp_encoder_r4.py:exp_mosaic_dyngather``: a kernel
body ``jnp.take(tab, idx, axis=0)`` over a [1024, 128] f32 table and 256
int32 indices).

:func:`take_rows` launches kernel P0 (``csrc/gather.cu``) on CUDA tensors
and runs :func:`take_rows_plain` on CPU tensors or with ``plain=True``.  Its
domain is ``0 <= idx < T``, as P0 draws its indices: the kernel does not
check the bounds, so an index outside it reads outside the table.
"""

from __future__ import annotations

import torch

from .. import kernels, use_kernel


def take_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain P0: ``table[idx]``."""
    return table[idx.long()]


def take_rows(table: torch.Tensor, idx: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Rows ``idx`` [N] (int32, each in [0, T), as P0 draws them) of
    ``table`` [T, C] float32 -> [N, C]."""
    if idx.dtype != torch.int32:
        raise ValueError(f"take_rows takes int32 indices, as P0 does, not {idx.dtype}")
    if not use_kernel(table, plain):
        return take_rows_plain(table, idx)
    return kernels.take_rows(table.contiguous(), idx.contiguous())
