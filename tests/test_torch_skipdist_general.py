"""K6c at every grid size: ``ops.occupancy.skipdist_from_bitfield`` sends
every size to its one entry (a launch over (x, y) tiles with their halos).
Here, on the CPU: the port's plain version and a numpy emulation of the
kernel's tiles (``skipdist_layouts.emulate_tiles``: tile sides that cut the
grid into clipped and unclipped halos, one tile the whole grid, and z-lines
cut into chunks with a word of halo each side) against the JAX package's
iterated dilation at sizes that are not multiples of 16, and the dispatch
by size with the kernel entry recorded.  The kernel meets the same grids
in ``tests/test_torch_kernels.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skipdist_layouts as sl
from nerfstyle_torch import kernels
from nerfstyle_torch.ops import occupancy as to
from nerfstyle_tpu.ops import occupancy as jo


@pytest.mark.parametrize("h,cascade", [(24, 1), (24, 2), (40, 1), (40, 2)])
def test_torch_skipdist_at_grid_sizes_off_the_tiles_match_jax(h, cascade):
    """A sparse random grid (distances up to the cap) and the crafted grids
    that reach across a cascade's faces and corners: the plain version and
    the emulated tiles (central sides 7 and h; whole lines, and chunks of
    one word with a word of halo each side) equal JAX bit for bit."""
    grids = [np.random.default_rng(h + cascade).random(cascade * h**3) < 3e-4]
    grids += [sl.grid(name, h, cascade) for name in ("corner", "far corner", "full",
                                                     "15 along the diagonal", "inside a halo")]
    for i, bits in enumerate(grids):
        want = np.asarray(jo.skipdist_from_bitfield(jnp.asarray(bits), h))
        if i == 0:
            assert np.bincount(want, minlength=16)[[0, 1, 14, 15]].min() > 0
        for tile, nw, wc in (sl.tiling(h, 7), (h, 3, 1)):
            np.testing.assert_array_equal(sl.emulate_tiles(bits, h, tile, nw, wc), want)
        got = to.skipdist_from_bitfield(torch.from_numpy(bits), h)
        np.testing.assert_array_equal(got.numpy(), want)


def test_torch_skipdist_dispatch_by_grid_size(monkeypatch):
    """With the kernel picked (as for a CUDA tensor), every size -- 16-128
    in steps of 16, 24, 100 and 256 -- goes to K6c's one entry; none goes
    to the plain version."""
    calls = []

    def entry(bits, h, dmax):
        calls.append((h, dmax))
        return torch.zeros_like(bits, dtype=torch.uint8)

    def plain(bits, h):
        raise AssertionError("a kernel-picked call reached the plain version")

    monkeypatch.setattr(to, "use_kernel", lambda t, plain=False: not plain)
    monkeypatch.setattr(to, "skipdist_plain", plain)
    monkeypatch.setattr(kernels, "occupancy_skipdist", entry)
    sizes = list(range(16, 129, 16)) + [24, 100, 256]
    for h in sizes:
        to.skipdist_from_bitfield(torch.zeros(h**3, dtype=torch.bool), h)
    assert calls == [(h, to.SKIP_DMAX) for h in sizes]
    assert not hasattr(kernels, "occupancy_skipdist_general")
    assert kernels.SKIPDIST_LAUNCHES == 1 and kernels.SKIPDIST_MAX_GRID >= 1024
