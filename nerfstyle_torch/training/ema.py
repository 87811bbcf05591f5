"""Exponential moving average of the params (counterpart of
``nerfstyle_tpu/training/ema.py``): decay ``min(decay, (1+n)/(10+n))`` at
the n-th update, the ramp of torch_ema's ``use_num_updates``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class EmaState(NamedTuple):
    shadow: dict  # a params tree
    num_updates: torch.Tensor  # i32 scalar, kept on the CPU


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (v if isinstance(v, list) else [v])


def ema_init(params: dict) -> EmaState:
    shadow = {k: [w.detach().clone() for w in v] if isinstance(v, list) else v.detach().clone()
              for k, v in params.items()}
    return EmaState(shadow=shadow, num_updates=torch.zeros((), dtype=torch.int32))


def ema_update(state: EmaState, params: dict, decay: Optional[float]) -> EmaState:
    """shadow <- d * shadow + (1 - d) * params, in place, with d computed in
    fp32 as JAX does.  ``decay=None`` disables the EMA."""
    if decay is None:
        return state
    n = int(state.num_updates) + 1
    d = np.minimum(np.float32(decay), np.float32(1.0 + n) / np.float32(10.0 + n))
    keep, take = float(d), float(np.float32(1.0) - d)
    with torch.no_grad():
        for s, p in zip(_leaves(state.shadow), _leaves(params)):
            s.mul_(keep).add_(p * take)
    return EmaState(shadow=state.shadow, num_updates=torch.tensor(n, dtype=torch.int32))


def ema_params(state: EmaState, params: dict, enabled: bool = True) -> dict:
    """The params to evaluate with: the shadow when the EMA is on."""
    return state.shadow if enabled else params
