"""Port parity: hash-grid spec laws and encode (plain K1) vs the JAX package.

Inputs come from numpy and go to both packages.  The CUDA kernel is held
against the plain version in tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.models.fields import make_grid_spec as jax_make_grid_spec
from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_torch import kernels
from nerfstyle_torch.models.fields import make_grid_spec
from nerfstyle_torch.ops import hashgrid as th

TINY = dict(num_levels=4, level_dim=2, base_resolution=16, per_level_scale=1.5,
            log2_hashmap_size=10)


def _points(rng, n):
    # 10% margin outside [0, 1] on each side: exercises the zero rows.
    return rng.uniform(-0.1, 1.1, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("kw", [TINY, {}, dict(num_levels=8, log2_hashmap_size=12,
                                                 desired_resolution=512)])
def test_torch_spec_laws_match_jax(kw):
    a, b = jh.hashgrid_spec(**kw), th.hashgrid_spec(**kw)
    assert a.resolutions == b.resolutions
    assert a.table_sizes == b.table_sizes
    assert a.offsets == b.offsets
    assert a.output_dim == b.output_dim


def test_torch_default_network_grid_matches_jax():
    """The default network config at bound 2 (16 levels, 2^19, 4096 finest)."""
    args = dict(n_lvls=16, n_feats_per_lvl=2, hashmap_size=19, min_res=16,
                max_res_coeff=1024, max_bound=4.0)
    a, b = jax_make_grid_spec(**args), make_grid_spec(**args)
    assert (a.resolutions, a.table_sizes, a.offsets) == (b.resolutions, b.table_sizes, b.offsets)
    assert b.total_params == 6_299_960 and b.resolutions[-1] == 4096


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_torch_encode_plain_matches_jax(channels):
    rng = np.random.default_rng(channels)
    spec_j, spec_t = jh.hashgrid_spec(**TINY), th.hashgrid_spec(**TINY)
    x = _points(rng, 777)
    table = rng.uniform(-1, 1, size=(spec_j.total_params, channels)).astype(np.float32)
    want = np.asarray(jh.hashgrid_encode(spec_j, jnp.asarray(table), jnp.asarray(x), fast_vjp=True))
    got = th.hashgrid_encode(spec_t, torch.from_numpy(table), torch.from_numpy(x)).numpy()
    oob = np.any((x < 0) | (x > 1), axis=-1)
    assert oob.any() and not oob.all()
    assert np.all(got[oob] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_torch_encode_on_cpu_launches_no_kernel():
    spec = th.hashgrid_spec(**TINY)
    kernels.reset_launch_counts()
    out = th.hashgrid_encode(spec, torch.zeros(spec.total_params, 2), torch.rand(5, 3))
    assert out.shape == (5, spec.output_dim)
    assert kernels.launch_counts["hashgrid_encode"] == 0


def test_torch_simplex_levels_not_ported():
    spec = th.hashgrid_spec(**TINY, simplex_from=2)
    with pytest.raises(NotImplementedError):
        th.hashgrid_encode(spec, torch.zeros(spec.total_params, 2), torch.rand(5, 3))


def test_torch_level_table_layout():
    spec = th.hashgrid_spec(**TINY)
    lv = th.level_table(spec, torch.device("cpu"))
    assert lv.dtype == torch.int32 and lv.shape == (3, 4)
    assert lv[0].tolist() == list(spec.resolutions)
    assert lv[1].tolist() == list(spec.table_sizes)
    assert lv[2].tolist() == list(spec.offsets[:-1])

