"""The color head's assembled input (``ops/sh.py`` ``sh_assemble``, kernel
K5d's second entry) on the CPU: its plain version against the chain it
replaces in the view-dependent fields (``torch.cat`` of the features, the
SH basis of ``(dirs + 1) / 2`` and K5's zero padding), its basis columns
against JAX's ``sh_encode``, and its backward; and the MLP weight padding
that goes with it.  The kernel against this plain version is a card test
(``tests/test_torch_kernels.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.ops import sh as jsh
from nerfstyle_torch import kernels
from nerfstyle_torch.ops import mlp as tmlp
from nerfstyle_torch.ops import sh as tsh


def _inputs(m, k, seed):
    """Unit directions [m, 3] (the axes and their negatives first) and
    features [m, k]: k = 15 as the strided view ``out[:, 1:]`` of a [m, 16]
    tensor (the base field's), else contiguous."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d[:min(m, 6)] = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)[:m]
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    wide = torch.from_numpy(rng.normal(size=(m, 16)).astype(np.float32))
    feat = wide[:, 1:] if k == 15 else torch.from_numpy(
        rng.normal(size=(m, k)).astype(np.float32))
    return feat, torch.from_numpy(d)


def _width(k, degree):
    return tmlp.kernel_in_width(k + degree**2)


@pytest.mark.parametrize("m", [0, 1, 33, 1000])
@pytest.mark.parametrize("k", [15, 16])
@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_torch_sh_assemble_is_the_cat_chain(degree, k, m):
    """Bit for bit the chain the fields ran before: cat of the features,
    ``sh_encode_plain((dirs + 1) / 2)`` and zero columns up to K5's width."""
    feat, dirs = _inputs(m, k, degree * 100 + k + m)
    if k == 15 and m:
        assert feat.stride() == (16, 1)
    width = _width(k, degree)
    got = tsh.sh_assemble(feat, dirs, degree, width)
    basis = tsh.sh_encode_plain((dirs + 1.0) / 2.0, degree)
    want = torch.cat([feat, basis, torch.zeros((m, width - k - degree**2))], dim=-1)
    assert got.shape == (m, width) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_torch_sh_assemble_basis_matches_jax(degree):
    """The basis columns equal JAX's ``sh_encode((dirs + 1) / 2)`` bit for
    bit: the same fp32 operations in the same order, each rounded on its
    own; the feature columns are the features and the rest zeros."""
    feat, dirs = _inputs(2000, 16, degree)
    want = np.asarray(jsh.sh_encode((jnp.asarray(dirs.numpy()) + 1.0) / 2.0, degree))
    got = tsh.sh_assemble(feat, dirs, degree, 32).numpy()
    np.testing.assert_array_equal(got[:, 16:16 + degree**2], want)
    np.testing.assert_array_equal(got[:, :16], feat.numpy())
    assert not got[:, 16 + degree**2:].any()


@pytest.mark.parametrize("k", [15, 16])
def test_torch_sh_assemble_backward_is_the_cat_gradient(k):
    """The features get the cat path's gradient exactly (the first k
    columns of the input gradient, into the strided view's base as well);
    the directions get none, and on the CPU asking for one does not
    raise (on CUDA it does: a card test)."""
    _, dirs = _inputs(500, k, 7)
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.normal(size=(500, 32)).astype(np.float32))
    base = torch.from_numpy(rng.normal(size=(500, 16)).astype(np.float32))
    base_a, base_b = base.clone().requires_grad_(True), base.clone().requires_grad_(True)
    fa, fb = (base_a[:, 1:], base_b[:, 1:]) if k == 15 else (base_a, base_b)
    d = dirs.clone().requires_grad_(True)
    (tsh.sh_assemble(fa, d, 4, 32) * g).sum().backward()
    chain = torch.cat([fb, tsh.sh_encode_plain((dirs + 1.0) / 2.0, 4),
                       torch.zeros((500, 32 - k - 16))], dim=-1)
    (chain * g).sum().backward()
    torch.testing.assert_close(base_a.grad, base_b.grad, rtol=0, atol=0)
    assert d.grad is None


def test_torch_sh_assemble_refuses_bad_arguments():
    feat, dirs = _inputs(8, 16, 0)
    with pytest.raises(ValueError, match="width"):
        tsh.sh_assemble(feat, dirs, 4, 31)
    for degree in (0, 5):
        with pytest.raises(ValueError, match="degrees"):
            tsh.sh_assemble(feat, dirs, degree, 32)


@pytest.mark.parametrize("in_dim,want", [(1, 16), (16, 16), (17, 32), (31, 32), (32, 32),
                                         (47, 47)])
def test_torch_kernel_in_width_and_weight_padding(in_dim, want):
    """K5's input width for ``in_dim`` columns: the narrowest of
    ``kernels.MLP_IN_DIMS`` that holds them, or ``in_dim`` above the widest;
    ``pad_weights`` adds zero rows to the first matrix up to it and hands
    back the same list where none are needed."""
    assert kernels.MLP_IN_DIMS == (16, 32)
    assert tmlp.kernel_in_width(in_dim) == want
    ws = [torch.ones((in_dim, 64)), torch.ones((64, 3))]
    padded = tmlp.pad_weights(ws, want)
    if want == in_dim:
        assert padded is ws
    else:
        assert padded[0].shape == (want, 64) and padded[1] is ws[1]
        assert padded[0][:in_dim].eq(1).all() and not padded[0][in_dim:].any()
