"""Bias-free ReLU MLP stacks and ``trunc_exp`` (counterpart of
``nerfstyle_tpu/ops/mlp.py``).

The JAX package computes these with ``jnp.dot`` outside any kernel, so the
port uses ``torch.matmul`` and takes the backward from autograd (a fused
forward and backward, K5, is later work).  Weights keep the JAX layout
``[d_in, d_out]``.

Mixed precision (``compute_dtype=torch.bfloat16``, the default under
``TrainConfig.enable_amp``) reproduces the JAX function exactly: inputs and
weights rounded to bf16, products accumulated and returned in fp32, hidden
activations rounded to bf16 again after each ReLU.  It is written as
``x.to(bf16).float() @ w.to(bf16).float()`` — a bf16 x bf16 product is exact
in fp32 — because a plain ``bf16 @ bf16`` on CUDA rounds its output to bf16,
which is a different function.  The backward rounds as JAX's does too:
the backward of ``.float()`` rounds each cotangent that reaches a bf16 input
or weight to bf16.  The fp32 products must not run in TF32: ``Renderer`` and
``Trainer`` set ``torch.backends.cuda.matmul.allow_tf32 = False``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def mlp_init(
    generator: torch.Generator,
    in_dim: int,
    hidden_dim: int,
    hidden_layers: int,
    out_dim: int,
    device=None,
) -> List[torch.Tensor]:
    """He-uniform fan-in init of in -> [hidden]*hidden_layers -> out; a list
    of [d_in, d_out] matrices."""
    dims = [in_dim] + [hidden_dim] * hidden_layers + [out_dim]
    ws = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        bound = (6.0 / d_in) ** 0.5
        w = torch.empty((d_in, d_out), dtype=torch.float32)
        w.uniform_(-bound, bound, generator=generator)
        ws.append(w.to(device))
    return ws


def _round(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype, keep fp32 storage for the product."""
    if compute_dtype == torch.float32:
        return t
    return t.to(compute_dtype).float()


def mlp_apply(
    weights: Sequence[torch.Tensor],
    x: torch.Tensor,
    output_activation: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Apply a bias-free ReLU MLP to [M, in_dim] inputs -> [M, out_dim] fp32."""
    h = _round(x, compute_dtype)
    n = len(weights)
    for i, w in enumerate(weights):
        h = torch.matmul(h, _round(w, compute_dtype))
        if i < n - 1:
            h = _round(torch.relu(h), compute_dtype)
    if output_activation == "sigmoid":
        h = torch.sigmoid(h)
    elif output_activation is not None:
        raise ValueError(f"unknown output activation {output_activation!r}")
    return h


class TruncExp(torch.autograd.Function):
    """exp with the backward ``g * exp(clamp(x, -15, 15))``: the forward
    stays unclamped (an overflow to inf is caught by the optimizer's
    non-finite skip), the gradient never overflows."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) with a backward clamped at |x| <= 15 (see :class:`TruncExp`)."""
    return TruncExp.apply(x)
