"""Port parity of ``hashgrid_encode``'s whole surface against the JAX
package on the CPU: the style slot (``style=s``) and the position gradient
(``fast_vjp=False``).

* Encode at s in {0, 1, 63, 511} (511 = MAX_STYLES - 1) on a trilinear and
  a simplex spec, both ``fast_vjp`` settings: within rtol 1e-5 / atol 1e-7
  of JAX's ``hashgrid_encode(style=s)`` (the same products summed in
  another order), zero rows outside [0, 1]^3; a style moves the features.
* The table gradient at both settings against ``jax.grad``: rtol 1e-5,
  atol 1e-6 of the largest entry (JAX's autodiff scatter-add), or with
  ``fast_vjp=True`` 2^-23 * sum|g| of a channel if larger (JAX's fast VJP
  takes a row's sum as the difference of one fp32 running sum, as
  tests/test_torch_hashgrid_grad.py states).
* d/dx with ``fast_vjp=False`` against ``jax.grad`` (autodiff through
  ``corner_indices_weights`` and ``_encode_from_indices``), on points
  that include rows outside [0, 1]^3 (gradient 0), points on cell faces
  and corners (fraction 0 and 1), and planted simplex ties (two and three
  equal fractions, where ``jnp.maximum`` and ``torch.maximum`` both halve
  the gradient in the same nesting): every entry within 2e-6 of the
  largest |d/dx| (measured: at most 1.4e-7; the weights' products are
  rounded and summed in another order).  With ``fast_vjp=True`` JAX's d/dx is zero and the
  port's is zero too (autograd's None).
* The dense branch of the index law never applies to a spec that
  ``hashgrid_spec`` or ``make_grid_spec`` builds, over the configs' space.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_torch.models.fields import make_grid_spec
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_tpu.ops import hashgrid as jh

# Resolutions 8, 16, 32, 64 (powers of two: x = k / 256 is exact at every
# level, so planted fractions are exact); 2^10 rows a level at most.
GRID = dict(num_levels=4, level_dim=2, base_resolution=8, per_level_scale=2.0,
            log2_hashmap_size=10)
STYLES = (0, 1, 63, 511)


def _points(seed: int, n: int = 512) -> np.ndarray:
    """Random points, 10% outside [0, 1]^3, then planted ones: cell faces
    and corners (x = k / 64 at every level: fraction 0; 1.0: fraction 1
    after the clamp), two-way and three-way ties of the fractions at the
    finest level, ties with a face."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, size=(n, 3))
    k = rng.integers(0, 64, size=(64, 3))
    faces = k / 64.0
    faces[::4, 0] = 1.0
    f = rng.integers(1, 4, size=(64, 1)) / 4.0  # fraction 1/4, 1/2 or 3/4 at res 64
    three = (rng.integers(0, 63, size=(64, 3)) + f) / 64.0
    g = rng.integers(1, 4, size=(64, 2)) / 4.0
    two = (rng.integers(0, 63, size=(64, 3)) + g[:, [0, 0, 1]]) / 64.0
    two[1::2] = two[1::2][:, [2, 0, 1]]  # the tied pair on other axes
    face_tie = (rng.integers(0, 63, size=(64, 3)) + np.array([0.0, 0.0, 0.5])) / 64.0
    return np.concatenate([x, faces, three, two, face_tie]).astype(np.float32)


def _inputs(seed: int, simplex_from: int):
    x = _points(seed)
    spec = th.hashgrid_spec(**GRID, simplex_from=simplex_from)
    rng = np.random.default_rng(100 + seed)
    table = rng.uniform(-1, 1, size=(spec.total_params, 2)).astype(np.float32)
    g = rng.normal(size=(x.shape[0], spec.output_dim)).astype(np.float32)
    return spec, x, table, g


@pytest.fixture(scope="module")
def jax_side():
    """JAX's encode, table gradient and d/dx for each (simplex_from, style,
    fast_vjp): every style of one (simplex_from, fast_vjp) in one jit."""
    cache = {}

    def get(simplex_from: int, style: int, fast_vjp: bool):
        key = (simplex_from, fast_vjp)
        if key not in cache:
            _, x, table, g = _inputs(simplex_from + 2, simplex_from)
            spec = jh.hashgrid_spec(**GRID, simplex_from=simplex_from)

            def every_style(emb, pts, cot):
                res = {}
                for st in STYLES:
                    out, vjp = jax.vjp(lambda e, p, st=st: jh.hashgrid_encode(
                        spec, e, p, style=st, fast_vjp=fast_vjp), emb, pts)
                    res[st] = (out, *vjp(cot))
                return res

            res = jax.jit(every_style)(jnp.asarray(table), jnp.asarray(x), jnp.asarray(g))
            cache[key] = {st: tuple(np.asarray(a) for a in v) for st, v in res.items()}
        return cache[key][style]

    return get


@pytest.mark.parametrize("fast_vjp", [True, False])
@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("simplex_from", [-1, 2])
def test_torch_styled_encode_and_grads_match_jax(jax_side, simplex_from, style, fast_vjp):
    spec, x, table, g = _inputs(simplex_from + 2, simplex_from)
    want_out, want_emb, want_x = jax_side(simplex_from, style, fast_vjp)
    tab = torch.from_numpy(table).requires_grad_(True)
    pts = torch.from_numpy(x).requires_grad_(True)
    out = th.hashgrid_encode(spec, tab, pts, style=style, fast_vjp=fast_vjp)
    out.backward(torch.from_numpy(g))
    oob = np.any((x < 0) | (x > 1), axis=-1)
    assert oob.any() and np.all(out.detach().numpy()[oob] == 0.0)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5, atol=1e-7)
    got_emb = tab.grad.numpy()
    atol = 1e-6 * np.abs(want_emb).max()
    if fast_vjp:  # JAX's rows are differences of one fp32 running sum
        atol = max(atol, 2.0**-23 * np.abs(g).reshape(len(g), -1, 2).sum(axis=(0, 1)).max())
    np.testing.assert_allclose(got_emb, want_emb, rtol=1e-5, atol=atol)
    if fast_vjp:
        assert not np.any(want_x) and (pts.grad is None or not pts.grad.any())
        return
    got_x = pts.grad.numpy()
    assert np.all(got_x[oob] == 0.0) and np.all(want_x[oob] == 0.0)
    scale = np.abs(want_x).max()
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=2e-6 * scale)


def test_torch_style_moves_the_rows():
    """Different styles read different rows (the features differ), and style
    0 equals the encode without a style argument."""
    spec, x, table, _ = _inputs(0, -1)
    tab, pts = torch.from_numpy(table), torch.from_numpy(x)
    base = th.hashgrid_encode(spec, tab, pts)
    assert torch.equal(th.hashgrid_encode(spec, tab, pts, style=0), base)
    for s in STYLES[1:]:
        assert not torch.equal(th.hashgrid_encode(spec, tab, pts, style=s), base)
    assert th.style_term(511) == (511 * 3674653429) & 0xFFFFFFFF
    assert th.style_term(1 << 40) == ((1 << 40) * 3674653429) & 0xFFFFFFFF


def test_torch_position_grad_at_a_three_way_tie():
    """One point whose fractions tie on all three axes at one simplex level:
    d/dx is the level's weight derivatives through JAX's nesting, 1/2, 1/4,
    1/4 of d L / d s1 to x, y, z (and of d L / d s3 alike), written out
    (the parametrized test holds planted three-way ties against JAX)."""
    spec = th.hashgrid_spec(num_levels=1, level_dim=1, base_resolution=4, per_level_scale=2.0,
                            log2_hashmap_size=10, simplex_from=0)
    x = torch.tensor([[1.5, 2.5, 3.5]]) / 4.0  # fractions (0.5, 0.5, 0.5) in cell (1, 2, 3)
    table = torch.tensor(np.random.default_rng(0).normal(size=(spec.total_params, 1)),
                         dtype=torch.float32)
    pts = x.clone().requires_grad_(True)
    th.hashgrid_encode(spec, table, pts, fast_vjp=False).sum().backward()
    corners, _ = th._corners(spec, x)
    t = [float(table[rows[0, 0], 0]) for _, _, rows, _ in corners]
    d1, d2, d3 = t[1] - t[0], t[2] - t[1], t[3] - t[2]
    a1, a3 = d1 - d2, d3 - d2  # s2 = fx + fy + fz - s1 - s3
    want = 4.0 * np.array([d2 + a1 / 2 + a3 / 2, d2 + a1 / 4 + a3 / 4, d2 + a1 / 4 + a3 / 4])
    np.testing.assert_allclose(pts.grad.numpy()[0], want, rtol=1e-6, atol=1e-6)


def test_torch_no_spec_of_the_configs_takes_the_dense_law():
    """The dense index law needs (res+1)^3 * 512 <= the level's table size;
    over the configs' space (pos_enc: 1-24 levels, 2^10-2^24 rows, min_res
    2-64, max_res_coeff 16-4096, bounds 1-8) and over random
    hashgrid_spec arguments, no level meets it: K1 and K2 hash every
    level."""
    rng = np.random.default_rng(0)
    specs = [make_grid_spec(int(rng.integers(2, 25)), 2, int(rng.integers(10, 25)),
                            int(rng.integers(2, 65)), float(rng.choice([16, 64, 256, 1024, 4096])),
                            float(rng.choice([1.0, 2.0, 4.0, 8.0]))) for _ in range(300)]
    specs += [th.hashgrid_spec(int(rng.integers(1, 25)), 2, int(rng.integers(1, 65)),
                               float(rng.uniform(1.01, 3.0)), int(rng.integers(3, 25)))
              for _ in range(300)]
    specs.append(make_grid_spec(16, 2, 19, 16, 1024, 4.0))  # the default network, bound 2
    for spec in specs:
        for res, size in zip(spec.resolutions, spec.table_sizes):
            assert not th.dense_level(res, size), (spec, res, size)
            assert (res + 1) ** 3 * th.MAX_STYLES > size


def test_torch_position_grad_remainder_magic():
    """K2x's row index on tables that are not a power of two: the host's
    constant M = ceil(2^64 / size) (``remainder_magic``, rows 4 and 5 of
    ``position_grad_table``) gives ((M * h) mod 2^64 * size) >> 64 = h %
    size for every table size that ``hashgrid_spec`` builds at the default
    network (bounds 1-8), the tests' and the README's small grids and
    random specs, on edge hashes (0, 1, around the size and its last
    multiple below 2^32, around 2^31, 2^32 - 1) and random 32-bit ones, in
    Python integers; a power-of-two size gets 0 (the kernel masks)."""
    rng = np.random.default_rng(5)
    specs = [make_grid_spec(16, 2, 19, 16, 1024, b) for b in (2.0, 4.0, 8.0, 16.0)]
    specs += [make_grid_spec(4, 2, 12, 16, 16, b) for b in (2.0, 4.0)]
    specs += [th.hashgrid_spec(**GRID), th.hashgrid_spec(),
              th.hashgrid_spec(4, 2, 16, 1.5, 10), th.hashgrid_spec(48, 2, 4, 1.1, 10)]
    specs += [th.hashgrid_spec(int(rng.integers(1, 25)), 2, int(rng.integers(1, 65)),
                               float(rng.uniform(1.01, 3.0)), int(rng.integers(3, 25)))
              for _ in range(40)]
    sizes = sorted({s for spec in specs for s in spec.table_sizes})
    odd = [s for s in sizes if s & (s - 1)]
    assert len(odd) > 50 and 13824 in odd  # the default network's level 1 at bound 2
    mask = 2**64 - 1
    for spec in specs[:6]:
        lv = th.position_grad_table(spec, torch.device("cpu")).numpy().astype(np.int64)
        for l, size in enumerate(spec.table_sizes):
            m = (int(lv[4, l]) & 0xFFFFFFFF) | (int(lv[5, l]) & 0xFFFFFFFF) << 32
            assert m == th.remainder_magic(size)
    for size in sizes:
        m = th.remainder_magic(size)
        if not size & (size - 1):
            assert m == 0
            continue
        last = (2**32 - 1) // size * size
        edges = [0, 1, size - 1, size, size + 1, 2 * size - 1, last - 1, last, 2**32 - 1,
                 2**32 - 2, 2**31 - 1, 2**31, 2**31 + 1]
        for h in edges + [int(v) for v in rng.integers(0, 2**32, size=500, dtype=np.uint64)]:
            assert ((m * h & mask) * size) >> 64 == h % size, (size, h)
