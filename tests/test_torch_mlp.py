"""Port parity of the MLP (kernel K5's plain version, the function every
``mlp_apply`` of the port computes): forward, d x and d W against
``jax.vjp`` of ``nerfstyle_tpu.ops.mlp.mlp_apply``, in fp32 and bf16, with
and without the sigmoid, at the shapes of the default network config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_torch import kernels
from nerfstyle_torch.ops import mlp as tmlp
from nerfstyle_tpu.ops import mlp as jmlp

# (in, hidden layers, out): density_net, color1_net, class_net (K = 4),
# color2_net of cfgs/network/default.yaml.
SHAPES = [(32, 1, 1), (32, 1, 16), (32, 1, 4), (16, 2, 3)]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(in_dim, n_hidden, out_dim, rows=257):
    rng = np.random.default_rng(in_dim * 100 + n_hidden * 10 + out_dim)
    dims = [in_dim] + [64] * n_hidden + [out_dim]
    ws = [rng.uniform(-1, 1, size=(a, b)).astype(np.float32) * (6.0 / a) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    x = rng.normal(size=(rows, in_dim)).astype(np.float32)
    g = rng.normal(size=(rows, out_dim)).astype(np.float32)
    return ws, x, g


@pytest.mark.parametrize("act", [None, "sigmoid"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("in_dim,n_hidden,out_dim", SHAPES)
def test_torch_mlp_matches_jax_vjp(in_dim, n_hidden, out_dim, dtype, act):
    """Output, d x and each d W.  fp32: the same sums in another order, rtol
    1e-5 with atol 1e-6 of the largest value.  bf16: inputs, weights, hidden
    activations and the cotangents reaching them rounded to bf16 in both; a
    value landing on the other side of a rounding step moves by 2^-8 of
    itself and carries into what follows: atol 2^-7 of the largest output,
    1e-2 of the largest gradient."""
    ws, x, g = _case(in_dim, n_hidden, out_dim)
    jd, td = DTYPES[dtype]
    out_j, vjp = jax.vjp(lambda w, xx: jmlp.mlp_apply(w, xx, act, jd),
                         [jnp.asarray(w) for w in ws], jnp.asarray(x))
    dws_j, dx_j = vjp(jnp.asarray(g))
    wt = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    xt = torch.from_numpy(x).requires_grad_(True)
    kernels.reset_launch_counts()
    out = tmlp.mlp_apply(wt, xt, act, td)
    (out * torch.from_numpy(g)).sum().backward()
    assert not any(kernels.launch_counts.values())  # CPU tensors: the plain version
    assert out.dtype == torch.float32
    pairs = [(out.detach(), out_j)] + [(xt.grad, dx_j)] + list(zip([w.grad for w in wt], dws_j))
    for i, (got, want) in enumerate(pairs):
        want = np.asarray(want, np.float32)
        assert tuple(got.shape) == want.shape
        if dtype == "fp32":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max(), err_msg=str(i))
        else:
            frac = 2.0**-7 if i == 0 else 1e-2
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=frac * np.abs(want).max(), err_msg=str(i))


def test_torch_mlp_frozen_weights_and_bad_arguments():
    """Weights that ask for no gradient get none (the style stage's frozen
    heads); an unknown activation or compute dtype raises."""
    ws, x, g = _case(32, 1, 16, rows=20)
    wt = [torch.from_numpy(w) for w in ws]
    xt = torch.from_numpy(x).requires_grad_(True)
    (tmlp.mlp_apply(wt, xt, None, torch.bfloat16) * torch.from_numpy(g)).sum().backward()
    assert xt.grad is not None and all(w.grad is None for w in wt)
    with pytest.raises(ValueError, match="activation"):
        tmlp.mlp_apply(wt, xt, "tanh")
    with pytest.raises(ValueError, match="activation"):
        tmlp.mlp_apply_plain(wt, xt, "relu")
