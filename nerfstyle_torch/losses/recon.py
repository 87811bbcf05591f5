"""Reconstruction-stage losses (counterpart of
``nerfstyle_tpu/losses/recon.py``): MSE, class cross-entropy with an ignore
label, sparsity and weight regularization."""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def cross_entropy_ignore(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1
) -> torch.Tensor:
    """Mean cross-entropy over the entries whose label is not
    ``ignore_index``; the denominator is max(count, 1), so a batch with
    every label ignored gives 0, not NaN."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, safe[:, None])[:, 0]
    denom = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, nll, torch.zeros_like(nll)).sum() / denom


def sparsity_loss(sigmas: torch.Tensor, exp_coeff: float) -> torch.Tensor:
    """mean |1 - exp(-coeff * sigma)|."""
    return torch.mean(torch.abs(1.0 - torch.exp(-exp_coeff * sigmas)))


def weight_reg_loss(params: Dict[str, object], keywords: Sequence[str] = ("net",)) -> torch.Tensor:
    """Sum of the L2 norms of the params whose top-level key contains a
    keyword."""
    total = 0.0
    for name, sub in params.items():
        if not any(kw in name for kw in keywords):
            continue
        for leaf in sub if isinstance(sub, list) else [sub]:
            total = total + torch.linalg.vector_norm(leaf.reshape(-1))
    return total
