"""Bias-free ReLU MLP stacks and ``trunc_exp`` (counterpart of
``nerfstyle_tpu/ops/mlp.py``).

:func:`mlp_apply` is the port's only MLP.  On CUDA tensors it runs kernel K5
(``csrc/mlp.cu``), forward and backward (:class:`MlpApply`); on CPU tensors,
or with ``plain=True``, its plain version :func:`mlp_apply_plain`: a
``torch.matmul`` chain with the backward from autograd, the reference K5 is
held against.  Weights keep the JAX layout ``[d_in, d_out]``.

Mixed precision (``compute_dtype=torch.bfloat16``, the default under
``TrainConfig.enable_amp``) reproduces the JAX function exactly: inputs and
weights rounded to bf16, products accumulated and returned in fp32, hidden
activations rounded to bf16 again after each ReLU.  It is written as
``x.to(bf16).float() @ w.to(bf16).float()`` — a bf16 x bf16 product is exact
in fp32 — because a plain ``bf16 @ bf16`` on CUDA rounds its output to bf16,
which is a different function.  The backward rounds as JAX's does too:
the backward of ``.float()`` rounds each cotangent that reaches a bf16 input
or weight to bf16.  The fp32 products must not run in TF32: ``Renderer`` and
``Trainer`` set ``torch.backends.cuda.matmul.allow_tf32 = False``.  K5
computes the same function with the same rounding points; only the order of
its fp32 sums differs.  One deliberate difference from JAX, in both
versions: the ReLU's gradient at exactly 0 is 0 (``jnp.maximum`` splits it,
0.5 each way); a hidden pre-activation is exactly 0 only where the input row
is, and such a row (a point outside the grid) has no table gradient.

K5 is instantiated for inputs 16 or 32 wide (``kernels.MLP_IN_DIMS``).  On
CUDA a narrower input is padded with zero columns to the next width and the
first weight matrix with zero rows (:func:`pad_input`): the zero products
add nothing, so it is the same function, and autograd slices the padding's
gradient off.  The view-dependent color heads' inputs (16 + deg^2 or the
base field's 15 + deg^2 columns) come at that width already, their zero
columns written by ``ops.sh.sh_assemble``, and the field pads only the
weights (:func:`pad_weights`), on every device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import kernels, use_kernel


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


def _check_activation(output_activation: Optional[str]) -> None:
    if output_activation not in (None, "sigmoid"):
        raise ValueError(f"unknown output activation {output_activation!r}")


def mlp_apply_plain(
    weights: Sequence[torch.Tensor],
    x: torch.Tensor,
    output_activation: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain K5: the ``torch.matmul`` chain, differentiable by autograd."""
    _check_activation(output_activation)
    h = _round(x, compute_dtype)
    n = len(weights)
    for i, w in enumerate(weights):
        h = torch.matmul(h, _round(w, compute_dtype))
        if i < n - 1:
            h = _round(torch.relu(h), compute_dtype)
    if output_activation == "sigmoid":
        h = torch.sigmoid(h)
    return h


def kernel_in_width(in_dim: int) -> int:
    """The input width K5 takes for ``in_dim`` columns: the narrowest of
    ``kernels.MLP_IN_DIMS`` that holds them, or ``in_dim`` above the
    widest (K5 then refuses it)."""
    return min((d for d in kernels.MLP_IN_DIMS if d >= in_dim), default=in_dim)


def pad_weights(weights: Sequence[torch.Tensor], in_dim: int):
    """``weights`` with the first matrix padded by zero rows to ``in_dim``
    inputs (unchanged where it has as many)."""
    pad = in_dim - weights[0].shape[0]
    if pad == 0:
        return weights
    return [torch.nn.functional.pad(weights[0], (0, 0, 0, pad)), *weights[1:]]


def pad_input(weights: Sequence[torch.Tensor], x: torch.Tensor):
    """(weights, x) with x [M, in] padded by zero columns, and the first
    weight matrix by zero rows, to the next input width K5 takes, where
    ``in`` is narrower than the widest and not one of them; unchanged
    otherwise (K5 then takes the width or refuses it)."""
    pad = kernel_in_width(x.shape[1]) - x.shape[1]
    if pad == 0:
        return weights, x
    return pad_weights(weights, x.shape[1] + pad), torch.nn.functional.pad(x, (0, pad))


class MlpApply(torch.autograd.Function):
    """K5 forward and backward.  The backward always gives ``d x`` and gives
    ``d W`` only for the weights whose gradient is asked for (none in the
    style stage, whose MLPs are frozen)."""

    @staticmethod
    def forward(ctx, x, sigmoid, bf16, *weights):
        x = x.contiguous()
        ctx.save_for_backward(x, *weights)
        ctx.sigmoid, ctx.bf16 = sigmoid, bf16
        return kernels.mlp_forward(x, weights, sigmoid, bf16)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        dx, dws = kernels.mlp_backward(x, weights, g.contiguous(), ctx.sigmoid, ctx.bf16,
                                       ctx.needs_input_grad[3:])
        return (dx, None, None, *dws)


class EmptyMlp(torch.autograd.Function):
    """An MLP with a last layer of width 0: the [M, 0] output with no
    launch; its weights' gradients are zeros (the last layer's of size 0)
    and its input's none, as the plain chain and JAX's ``mlp_apply`` give."""

    @staticmethod
    def forward(ctx, x, *weights):
        ctx.shapes = [w.shape for w in weights]
        return x.new_empty((x.shape[0], 0))

    @staticmethod
    def backward(ctx, g):
        return (None, *(g.new_zeros(shape) if need else None
                        for shape, need in zip(ctx.shapes, ctx.needs_input_grad[1:])))


def mlp_apply(
    weights: Sequence[torch.Tensor],
    x: torch.Tensor,
    output_activation: Optional[str] = None,
    compute_dtype: torch.dtype = torch.float32,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """Apply a bias-free ReLU MLP to [M, in_dim] inputs -> [M, out_dim] fp32,
    with ``compute_dtype`` bf16 as under mixed precision.

    CUDA tensors go through kernel K5 (:class:`MlpApply`); CPU tensors (or
    ``plain=True``) through :func:`mlp_apply_plain`.  On CUDA an MLP with no
    outputs (a class head without classes) launches nothing
    (:class:`EmptyMlp`), and one with more outputs than K5 takes runs K5
    once for each slice of at most ``kernels.MLP_MAX_OUT`` last-layer
    columns, the hidden layers computed again each time: the columns are
    independent, so the output is the same.  An input narrower than K5
    takes is padded (:func:`pad_input`)."""
    _check_activation(output_activation)
    if not use_kernel(x, plain):
        return mlp_apply_plain(weights, x, output_activation, compute_dtype)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K5 computes in float32 or bfloat16, not {compute_dtype}")
    sigmoid, bf16 = output_activation == "sigmoid", compute_dtype == torch.bfloat16
    out_dim = weights[-1].shape[1]
    if out_dim == 0:
        return EmptyMlp.apply(x, *weights)
    weights, x = pad_input(weights, x)
    if out_dim <= kernels.MLP_MAX_OUT:
        return MlpApply.apply(x, sigmoid, bf16, *weights)
    *hidden, last = weights
    return torch.cat([MlpApply.apply(x, sigmoid, bf16, *hidden, last[:, a:a + kernels.MLP_MAX_OUT])
                      for a in range(0, out_dim, kernels.MLP_MAX_OUT)], dim=1)


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
