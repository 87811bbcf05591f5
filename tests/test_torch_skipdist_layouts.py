"""K6c (the skip distance) on crafted grids, against the JAX package's
iterated dilation (``nerfstyle_tpu.ops.occupancy.skipdist_from_bitfield``):
a numpy emulation of the kernel's algorithm (bits packed a z-line, (x, y)
tiles and their halos, dmax - 1 rounds, a bit-sliced count;
``skipdist_layouts.emulate_tiles``, at the tile side the kernel takes on the
H100 at 128 and sides that clip the halos at 16 and 32) and the port's plain
version, both bit for bit.  The kernel itself meets the same grids in
``tests/test_torch_kernels.py`` on the card.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skipdist_layouts as sl
from nerfstyle_torch.ops import occupancy as to
from nerfstyle_tpu.ops import occupancy as jo

SMALL = [(h, cas, name) for h, cas in itertools.product((16, 32), (1, 2))
         for name in sl.names(h)]
# At 128 cells a side (four words a z-line): a word border and a halo, and
# the far corner of a second cascade; the sparse grid below adds every
# distance up to the cap.
LARGE = [(128, 1, "word border"), (128, 1, "inside a halo"), (128, 2, "far corner")]
# Five more 128-cell grids, several seconds each on the CPU: marked slow, so
# they stay runnable (`-m slow`) and cost the quick tier nothing.
LARGE_SLOW = [pytest.param(128, *case, marks=pytest.mark.slow)
              for case in ((1, "corner"), (2, "centre"), (1, "slab border"),
                           (2, "15 along the diagonal"), (1, "full"))]


def _jax(bits: np.ndarray, h: int) -> np.ndarray:
    return np.asarray(jo.skipdist_from_bitfield(jnp.asarray(bits), h))


# Central tile sides: 16 is the kernel's choice at 128 on 132 SMs.
TILE = {16: 7, 32: 12, 128: 16}


def _check(bits: np.ndarray, h: int) -> None:
    want = _jax(bits, h)
    assert want.dtype == np.uint8
    np.testing.assert_array_equal(sl.emulate_tiles(bits, h, *sl.tiling(h, TILE[h])), want)
    got = to.skipdist_from_bitfield(torch.from_numpy(bits), h)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,cascade,name", SMALL + LARGE + LARGE_SLOW)
def test_torch_skipdist_crafted_grids_match_jax(h, cascade, name):
    _check(sl.grid(name, h, cascade), h)


def test_torch_skipdist_sparse_random_grid_matches_jax():
    """2 x 128^3 cells, 0.02% occupied: distances up to the cap."""
    bits = sl.sparse_random()
    want = _jax(bits, 128)
    assert np.bincount(want, minlength=16)[[0, 14, 15]].min() > 0
    _check(bits, 128)


def test_torch_skipdist_probe_distances():
    """The crafted probes read what they are named: 14 and 15 cells from an
    occupied cell, along each axis and the diagonal."""
    for d in (14, 15):
        for name in ("x", "y", "z", "the diagonal"):
            assert _jax(sl.grid(f"{d} along {name}", 16, 1), 16)[0] == d


def test_torch_skipdist_bit_tricks():
    """The kernel's multiplies: 4 bool bytes -> 4 bits and back, all 16
    patterns."""
    pats = np.array([[(v >> k) & 1 for k in range(4)] for v in range(16)], np.uint8)
    words = pats.copy().view("<u4")[:, 0].astype(np.uint32)
    np.testing.assert_array_equal(sl._nibble(words), np.arange(16))
    np.testing.assert_array_equal(sl._spread(np.arange(16, dtype=np.uint32)), words)
