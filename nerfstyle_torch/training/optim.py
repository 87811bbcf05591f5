"""The recon trainer's optimizer: the port's counterpart of the optax chain
``apply_if_finite(masked(adam(exponential_decay(lr0, decay, 0.1), 0.9,
0.999, eps=1e-15), mask), max_consecutive_errors=1000)`` of
``nerfstyle_tpu/training/trainer.py`` (``_reset_optim``).

The math is written out in the order optax evaluates it, in fp32:

    mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu,   t = count + 1,
    p += -lr(k) * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps),
    lr(k) = lr0 * 0.1^(k / decay),

where k counts the applied updates (the schedule's own count).  A step whose
gradients are not all finite is skipped: params, moments and both counts
stay, ``notfinite_count`` and ``total_notfinite`` grow, ``last_finite`` is
False (after ``max_consecutive_errors`` skips in a row the update applies
anyway, as optax does).  Params outside the keyword mask keep optax.masked's
behaviour: their raw gradient is added as the update; a leaf whose gradient
is None (a frozen leaf, as in the style stage) is left as it is, where optax
would add its zero gradient.

The state is :class:`OptState`, whose NamedTuples flatten (dict keys sorted,
None holding no leaf) to optax 0.2.6's leaves in order: notfinite_count,
last_finite, total_notfinite, Adam count, mu, nu, schedule count.  So a
checkpoint written by either package resumes in the other.  Counters live on
the CPU; moments beside their params.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # i32
    mu: dict
    nu: dict


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # i32: applied updates, the lr schedule's step


class MaskedState(NamedTuple):
    inner_state: tuple  # (ScaleByAdamState, ScaleByScheduleState or None)


class OptState(NamedTuple):
    notfinite_count: torch.Tensor  # i32
    last_finite: torch.Tensor  # bool
    total_notfinite: torch.Tensor  # i32
    inner_state: MaskedState


def _i32(v: int) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


def opt_state_from_tree(tree) -> OptState:
    """Rebuild an :class:`OptState` from any tree with optax's attribute
    names (an optax state whose leaves are tensors, or a restored one)."""
    adam, sched = tree.inner_state.inner_state
    cpu = lambda t: t.detach().to("cpu")  # noqa: E731
    return OptState(
        notfinite_count=cpu(tree.notfinite_count).to(torch.int32),
        last_finite=cpu(tree.last_finite).to(torch.bool),
        total_notfinite=cpu(tree.total_notfinite).to(torch.int32),
        inner_state=MaskedState((
            ScaleByAdamState(cpu(adam.count).to(torch.int32), adam.mu, adam.nu),
            None if sched is None else ScaleByScheduleState(cpu(sched.count).to(torch.int32)),
        )),
    )


def keyword_mask(params: Dict[str, object], keywords: Optional[Sequence[str]]) -> Dict[str, bool]:
    """Per top-level key: trainable when its name contains a keyword (all
    keys when ``keywords`` is None)."""
    return {k: keywords is None or any(kw in k for kw in keywords) for k in params}


def _as_list(v) -> List[torch.Tensor]:
    return v if isinstance(v, list) else [v]


class Adam:
    """Skip-on-non-finite, keyword-masked Adam with exponential lr decay."""

    def __init__(
        self,
        mask: Dict[str, bool],
        lr0: float,
        decay_steps: int,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-15,
        max_consecutive_errors: int = 1000,
    ):
        self.mask = dict(mask)
        self.lr0, self.decay_steps = lr0, decay_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_consecutive_errors = max_consecutive_errors

    def init(self, params: Dict[str, object]) -> OptState:
        def zeros():
            return {k: ([torch.zeros_like(w) for w in v] if isinstance(v, list)
                        else torch.zeros_like(v)) if self.mask[k] else None
                    for k, v in params.items()}

        sched = ScaleByScheduleState(_i32(0)) if self.decay_steps > 0 else None
        return OptState(_i32(0), torch.tensor(True), _i32(0),
                        MaskedState((ScaleByAdamState(_i32(0), zeros(), zeros()), sched)))

    def learning_rate(self, k: int) -> float:
        """lr0 * 0.1^(k / decay_steps) in fp32 (optax.exponential_decay)."""
        if self.decay_steps <= 0 or k <= 0:
            return float(np.float32(self.lr0))
        p = np.float32(k) / np.float32(self.decay_steps)
        return float(np.float32(self.lr0) * np.power(np.float32(0.1), p))

    def update(
        self, grads: Dict[str, object], state: OptState, params: Dict[str, object]
    ) -> Tuple[OptState, bool]:
        """Apply one update to ``params`` in place; returns the new state and
        whether the update was applied.  Reads one device flag (finite)."""
        flat = [g for k in grads if grads[k] is not None for g in _as_list(grads[k])]
        finite = bool(torch.stack([torch.isfinite(g).all() for g in flat]).all())
        notfinite = 0 if finite else int(state.notfinite_count) + 1
        total = int(state.total_notfinite) + (0 if finite else 1)
        adam, sched = state.inner_state.inner_state
        apply = finite or notfinite > self.max_consecutive_errors
        if apply:
            t = int(adam.count) + 1
            k = 0 if sched is None else int(sched.count)
            bc1 = float(np.float32(1.0) - np.power(np.float32(self.b1), np.float32(t)))
            bc2 = float(np.float32(1.0) - np.power(np.float32(self.b2), np.float32(t)))
            step = -self.learning_rate(k)
            with torch.no_grad():
                for key in params:
                    if grads.get(key) is None:
                        continue
                    ps, gs = _as_list(params[key]), _as_list(grads[key])
                    if not self.mask[key]:
                        for p, g in zip(ps, gs):
                            p.add_(g)
                        continue
                    for p, g, mu, nu in zip(ps, gs, _as_list(adam.mu[key]), _as_list(adam.nu[key])):
                        mu.mul_(self.b1).add_(g * (1.0 - self.b1))
                        nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
                        u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                        p.add_(u * step)
            adam = ScaleByAdamState(_i32(t), adam.mu, adam.nu)
            sched = None if sched is None else ScaleByScheduleState(_i32(k + 1))
        new = OptState(_i32(notfinite), torch.tensor(finite), _i32(total),
                       MaskedState((adam, sched)))
        return new, apply
