"""K5's library yardstick in ``chip_smoke.py`` (``mlp_library_chain``: the
MLP as a chain of cuBLAS GEMMs with K5's rounding points) against JAX's
``mlp_apply`` under bf16, on the same numpy inputs, at the four shapes K5
is built for (input 16 or 32, one or two hidden layers)."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_tpu.ops import mlp as jmlp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# (in, hidden layers, out, output activation)
SHAPES = [(32, 1, 16, None), (32, 2, 4, "sigmoid"), (16, 1, 4, None), (16, 2, 3, "sigmoid")]


@pytest.mark.parametrize("in_dim,n_hidden,out_dim,act", SHAPES)
def test_torch_mlp_library_chain_matches_jax_bf16(in_dim, n_hidden, out_dim, act):
    """The chain rounds x, every weight and every hidden activation to bf16
    and sums in fp32, as JAX's bf16 ``mlp_apply`` does.  Tolerance: where a
    hidden pre-activation's fp32 sum lies on a bf16 rounding boundary, the
    other order of the sums may round it one bf16 ulp (2^-8 of itself) the
    other way, and that carries into the layers after it: atol 2^-7 of the
    largest output, as K5's own checks."""
    rng = np.random.default_rng(in_dim * 100 + n_hidden * 10 + out_dim)
    dims = [in_dim] + [64] * n_hidden + [out_dim]
    ws = [rng.uniform(-1, 1, size=(a, b)).astype(np.float32) * (6.0 / a) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    x = rng.normal(size=(300, in_dim)).astype(np.float32)
    want = np.asarray(jmlp.mlp_apply([jnp.asarray(w) for w in ws], jnp.asarray(x), act,
                                     jnp.bfloat16), np.float32)
    with chip_smoke.cublas_fp32_sums():
        got = chip_smoke.mlp_library_chain([torch.from_numpy(w) for w in ws],
                                           torch.from_numpy(x), act, torch.bfloat16)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0**-7 * np.abs(want).max())
