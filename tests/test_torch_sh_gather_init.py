"""Port parity of the three kernels' plain versions: K5d (``ops/sh.py``
``sh_encode``) against JAX's ``sh_encode``; P0 (``ops/gather.py``
``take_rows``) against the body of the repository's one ``pallas_call`` run
in interpret mode; the style slot of the hash-grid index law and K9
(``ops/hashgrid.py`` ``grid_initialize``) against JAX's ``_level_indices``
and ``grid_initialize``; and K5's input padding, through K5's plain chain.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from nerfstyle_tpu.ops import hashgrid as jh
from nerfstyle_tpu.ops import sh as jsh
from nerfstyle_torch import kernels
from nerfstyle_torch.ops import gather as tg
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_torch.ops import mlp as tmlp
from nerfstyle_torch.ops import sh as tsh


def _dirs01(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ((d + 1.0) / 2.0).astype(np.float32)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_torch_sh_encode_matches_jax(degree):
    """The same fp32 operations in the same order: within 1e-6 absolute (the
    values reach 2.9; XLA may contract a product and a sum)."""
    d01 = _dirs01(2000, degree)
    want = np.asarray(jsh.sh_encode(jnp.asarray(d01), degree))
    got = tsh.sh_encode(torch.from_numpy(d01), degree)
    assert got.shape == (2000, degree**2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_torch_sh_encode_refuses_other_degrees():
    for degree in (0, 5):
        with pytest.raises(ValueError, match="degrees"):
            tsh.sh_encode(torch.zeros((4, 3)), degree)


# ---------------------------------------------------------------------------
# P0: the row gather of tools/exp_encoder_r4.py:exp_mosaic_dyngather
# ---------------------------------------------------------------------------


def _p0_pallas(tab, idx):
    """P0's kernel body, restated (it is local to exp_mosaic_dyngather), run
    through pl.pallas_call in interpret mode at P0's own shapes."""

    def kern(tab_ref, idx_ref, out_ref):
        out_ref[...] = jnp.take(tab_ref[...], idx_ref[...], axis=0)

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((idx.shape[0], tab.shape[1]), jnp.float32),
        interpret=True,
    )(tab, idx)


def test_torch_take_rows_matches_the_pallas_kernel():
    """Bit for bit: a gather moves the bits.  P0's shapes, [1024, 128] and
    256 int32 indices over the whole domain [0, T)."""
    rng = np.random.default_rng(0)
    tab = rng.normal(size=(1024, 128)).astype(np.float32)
    idx = rng.integers(0, 1024, size=256).astype(np.int32)
    idx[:2] = (0, 1023)
    want = np.asarray(_p0_pallas(jnp.asarray(tab), jnp.asarray(idx)))
    np.testing.assert_array_equal(want, tab[idx])
    got = tg.take_rows(torch.from_numpy(tab), torch.from_numpy(idx))
    assert got.shape == (256, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="int32"):
        tg.take_rows(torch.from_numpy(tab), torch.from_numpy(idx).long())


# ---------------------------------------------------------------------------
# The style slot of the index law, and grid_initialize (K9)
# ---------------------------------------------------------------------------


# (res, table size): hashed levels (a full 2^10 table, a table the
# size of the cell count, an odd one) and dense ones (every axis and the
# style slot fit: 512 * (res + 1)^3 <= size).
LEVELS = [(15, 1 << 10), (7, 512), (12, 2200), (1, 4096), (3, 1 << 16)]


@pytest.mark.parametrize("res,size", LEVELS)
@pytest.mark.parametrize("style", [0, 1, 5, 63])
def test_torch_level_indices_match_jax(res, size, style):
    """Bit for bit, on every corner of [0, res]^3."""
    side = res + 1
    ids = np.arange(side**3)
    pos = np.stack([ids // side**2, (ids // side) % side, ids % side], -1).astype(np.int32)
    want = np.asarray(jh._level_indices(jnp.asarray(pos), res, size, style))
    got = th.level_indices(torch.from_numpy(pos), res, size, style)
    np.testing.assert_array_equal(got.numpy(), want)
    assert th.dense_level(res, size) == (512 * side**3 <= size)


def test_torch_level_indices_style_0_is_the_encoders_rows():
    """The encoder's rows (_rows, no style slot) are the law at style 0."""
    spec = th.hashgrid_spec(num_levels=3, level_dim=2, base_resolution=6, per_level_scale=1.7,
                            log2_hashmap_size=8)
    pos = torch.from_numpy(np.random.default_rng(1).integers(0, 30, size=(500, 3, 3)))
    rows = th._rows(spec, pos, 0, 3)
    for lv in range(3):
        want = th.level_indices(pos[:, lv], spec.resolutions[lv], spec.table_sizes[lv])
        torch.testing.assert_close(rows[:, lv], want + spec.offsets[lv], rtol=0, atol=0)


GRID_SPECS = {
    "tiny": dict(num_levels=2, level_dim=2, base_resolution=4, per_level_scale=1.5,
                 log2_hashmap_size=7),
    "tiled_and_hashed": dict(num_levels=3, level_dim=4, base_resolution=3, per_level_scale=2.0,
                             log2_hashmap_size=9),
    "one_channel": dict(num_levels=3, level_dim=1, base_resolution=5, per_level_scale=1.4,
                        log2_hashmap_size=8),
}


def _ref_table(spec, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(spec.total_params, spec.level_dim)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(GRID_SPECS))
def test_torch_grid_initialize_one_style_equals_jax(name):
    """Check (a): one style and the reference's own spec, so every write to
    a row carries that row's value: the output is the reference on every
    reached row and 0 elsewhere, bit for bit, and equal to JAX's."""
    spec_j, spec_t = jh.hashgrid_spec(**GRID_SPECS[name]), th.hashgrid_spec(**GRID_SPECS[name])
    ref = _ref_table(spec_t, 2)
    want = np.asarray(jh.grid_initialize(spec_j, spec_j, jnp.asarray(ref), num_styles=1))
    got = th.grid_initialize(spec_t, spec_t, torch.from_numpy(ref), num_styles=1).numpy()
    np.testing.assert_array_equal(got, want)
    reached = np.any(got != 0, axis=1)
    np.testing.assert_array_equal(got[reached], ref[reached])
    assert reached.mean() > 0.5


def _sources(spec, ref, num_styles):
    """For every row, the style-0 values of the (corner, style) pairs that
    map to it (JAX's index law): {row: [values]}."""
    out = {}
    for lvl in range(spec.num_levels):
        res = spec.resolutions[lvl]
        side = res + 1
        ids = np.arange(side**3)
        pos = jnp.asarray(np.stack([ids // side**2, (ids // side) % side, ids % side],
                                   -1).astype(np.int32))
        src = ref[np.asarray(jh._level_indices(pos, res, spec.table_sizes[lvl], 0))
                  + spec.offsets[lvl]]
        for s in range(num_styles):
            rows = np.asarray(jh._level_indices(pos, res, spec.table_sizes[lvl], s)) \
                + spec.offsets[lvl]
            for r, v in zip(rows.tolist(), src):
                out.setdefault(r, []).append(v)
    return out


@pytest.mark.parametrize("name", sorted(GRID_SPECS))
def test_torch_grid_initialize_many_styles_holds_a_colliding_value(name):
    """Check (b), JAX's own (tests/test_hashgrid.py, TestGridInitialize):
    at three styles every reached row holds the style-0 value of some
    (corner, style) pair that maps to it, and every other row is 0; the
    reached rows are JAX's."""
    spec_j, spec_t = jh.hashgrid_spec(**GRID_SPECS[name]), th.hashgrid_spec(**GRID_SPECS[name])
    ref = _ref_table(spec_t, 3)
    got = th.grid_initialize(spec_t, spec_t, torch.from_numpy(ref), num_styles=3).numpy()
    want = np.asarray(jh.grid_initialize(spec_j, spec_j, jnp.asarray(ref), num_styles=3))
    sources = _sources(spec_j, ref, 3)
    for row in range(spec_t.total_params):
        if row in sources:
            assert any(np.array_equal(got[row], v) for v in sources[row]), row
        else:
            assert not got[row].any() and not want[row].any(), row


@pytest.mark.parametrize("ref_kind", ["finer_hashmap", "dense"])
def test_torch_grid_initialize_from_another_spec_matches_jax(ref_kind):
    """A reference of another table size: a finer hashmap, or one whose
    coarse level is dense (its table holds 512 style slots of every corner).
    One style, so each row's survivor may still differ where corners collide
    in the new table; rows reached by one corner only are JAX's bit for
    bit."""
    kw = dict(num_levels=2, level_dim=2, base_resolution=4, per_level_scale=1.5)
    spec_j, spec_t = jh.hashgrid_spec(log2_hashmap_size=6, **kw), \
        th.hashgrid_spec(log2_hashmap_size=6, **kw)
    ref_j, ref_t = jh.hashgrid_spec(log2_hashmap_size=12, **kw), \
        th.hashgrid_spec(log2_hashmap_size=12, **kw)
    if ref_kind == "dense":
        sizes, offsets = (1 << 16, 1 << 16), (0, 1 << 16, 1 << 17)
        ref_j = dataclasses.replace(ref_j, table_sizes=sizes, offsets=offsets)
        ref_t = dataclasses.replace(ref_t, table_sizes=sizes, offsets=offsets)
        assert th.dense_level(spec_t.resolutions[0], sizes[0])
    ref = _ref_table(ref_t, 4)
    want = np.asarray(jh.grid_initialize(spec_j, ref_j, jnp.asarray(ref), num_styles=1))
    got = th.grid_initialize(spec_t, ref_t, torch.from_numpy(ref), num_styles=1).numpy()
    hits = np.zeros(spec_t.total_params, np.int64)
    for lvl in range(spec_t.num_levels):
        side = spec_t.resolutions[lvl] + 1
        pos = th._corner_ids(side - 1, 0, side**3, "cpu")
        rows = th.level_indices(pos, side - 1, spec_t.table_sizes[lvl]) + spec_t.offsets[lvl]
        np.add.at(hits, rows.numpy(), 1)
    single = hits == 1
    assert single.sum() > 0
    np.testing.assert_array_equal(got[single], want[single])
    np.testing.assert_array_equal(got[hits == 0], 0.0)


def test_torch_grid_init_levels_layout():
    spec = th.hashgrid_spec(**GRID_SPECS["tiny"])
    lv = th.grid_init_levels(spec, spec, "cpu")
    assert lv.dtype == torch.int32 and lv.shape == (7, spec.num_levels)
    assert lv[0].tolist() == list(spec.resolutions)
    assert lv[1].tolist() == lv[4].tolist() == list(spec.table_sizes)
    assert lv[2].tolist() == lv[5].tolist() == list(spec.offsets[:-1])
    assert lv[3].tolist() == lv[6].tolist() == [0] * spec.num_levels


# ---------------------------------------------------------------------------
# K5's input padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_dim,padded", [(17, 32), (20, 32), (25, 32), (31, 32), (16, 16),
                                           (32, 32), (7, 16), (40, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_mlp_padding_is_the_same_function(in_dim, padded, dtype):
    """pad_input widens x with zero columns and the first matrix with zero
    rows to K5's next input width (16 or 32; unchanged at 16, 32 and above
    32).  Through K5's plain chain the padded MLP gives the unpadded one's
    outputs and gradients, the padding's weight gradient sliced off by
    autograd: the zero products add +0 to each sum.  Exact, but for the
    CPU GEMM's blocking of the inner dimension, which may differ between
    the two widths: rtol 1e-6 (fp32), and under bf16 one bf16 rounding step
    of a hidden activation, atol 1e-2 of the largest value."""
    rng = np.random.default_rng(in_dim)
    ws = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.3).requires_grad_(True)
          for s in ((in_dim, 64), (64, 64), (64, 3))]
    x = torch.from_numpy(rng.normal(size=(400, in_dim)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(400, 3)).astype(np.float32))
    pw, px = tmlp.pad_input(ws, x)
    assert px.shape == (400, padded) and pw[0].shape == (padded, 64)
    if padded == in_dim:
        assert px is x and pw is ws
        return
    assert not px[:, in_dim:].any() and not pw[0][in_dim:].any()
    want = tmlp.mlp_apply_plain(ws, x, "sigmoid", dtype)
    grads_want = torch.autograd.grad((want * g).sum(), [*ws, x])
    got = tmlp.mlp_apply_plain(pw, px, "sigmoid", dtype)
    grads_got = torch.autograd.grad((got * g).sum(), [*ws, x])
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == torch.float32 else None
    for a, b in zip([got, *grads_got], [want, *grads_want]):
        assert a.shape == b.shape
        if tol:
            torch.testing.assert_close(a, b, **tol)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-2 * float(b.detach().abs().max()))


def test_torch_mlp_pads_only_on_the_kernel_path(monkeypatch):
    """mlp_apply's CUDA branch (K5 faked by the plain chain on the CPU) hands
    K5 the padded input; the CPU branch runs the chain unpadded."""
    seen = []

    def fake_forward(x, weights, sigmoid, bf16):
        seen.append((x.shape[1], weights[0].shape[0]))
        return tmlp.mlp_apply_plain(weights, x, "sigmoid" if sigmoid else None,
                                    torch.bfloat16 if bf16 else torch.float32)

    monkeypatch.setattr(tmlp, "use_kernel", lambda t, plain=False: not plain)
    monkeypatch.setattr(kernels, "mlp_forward", fake_forward)
    rng = np.random.default_rng(5)
    ws = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((31, 64), (64, 3))]
    x = torch.from_numpy(rng.normal(size=(50, 31)).astype(np.float32))
    got = tmlp.mlp_apply(ws, x, "sigmoid")
    assert seen == [(32, 32)]
    want = tmlp.mlp_apply(ws, x, "sigmoid", plain=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert seen == [(32, 32)]
