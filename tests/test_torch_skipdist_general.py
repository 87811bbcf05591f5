"""K6c at every grid size.  The one-launch kernel holds grid sizes that are
multiples of 16 up to 128; ``ops.occupancy.skipdist_from_bitfield`` sends
every other size to the general entry (three axis passes).  Here, on the
CPU: the port's plain version and a numpy emulation of the axis passes
(``skipdist_layouts.emulate_axis_passes``) against the JAX package's
iterated dilation at sizes the one-launch kernel does not take, and the
dispatch by size with the two kernel entries recorded.  The kernels meet
the same grids in ``tests/test_torch_kernels.py`` on the card.
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
    that reach across a cascade's faces and corners: plain and emulated
    axis passes equal JAX bit for bit."""
    grids = [np.random.default_rng(h + cascade).random(cascade * h**3) < 3e-4]
    grids += [sl.grid(name, h, cascade) for name in ("corner", "far corner", "full",
                                                     "15 along the diagonal", "inside a halo")]
    for i, bits in enumerate(grids):
        want = np.asarray(jo.skipdist_from_bitfield(jnp.asarray(bits), h))
        if i == 0:
            assert np.bincount(want, minlength=16)[[0, 1, 14, 15]].min() > 0
        np.testing.assert_array_equal(sl.emulate_axis_passes(bits, h), want)
        got = to.skipdist_from_bitfield(torch.from_numpy(bits), h)
        np.testing.assert_array_equal(got.numpy(), want)


def test_torch_skipdist_dispatch_by_grid_size(monkeypatch):
    """With the kernel picked (as for a CUDA tensor), sizes 16-128 in steps
    of 16 go to the one-launch K6c, and 24, 100 and 256 to the general
    entry; neither goes to the plain version."""
    calls = []

    def record(name):
        def entry(bits, h, dmax):
            calls.append((name, h, dmax))
            return torch.zeros_like(bits, dtype=torch.uint8)
        return entry

    def plain(bits, h):
        raise AssertionError("a kernel-picked call reached the plain version")

    monkeypatch.setattr(to, "use_kernel", lambda t, plain=False: not plain)
    monkeypatch.setattr(to, "skipdist_plain", plain)
    monkeypatch.setattr(kernels, "occupancy_skipdist", record("one launch"))
    monkeypatch.setattr(kernels, "occupancy_skipdist_general", record("general"))
    sizes = list(range(16, 129, 16)) + [24, 100, 256]
    for h in sizes:
        to.skipdist_from_bitfield(torch.zeros(h**3, dtype=torch.bool), h)
    want = [("one launch" if h % 16 == 0 and h <= 128 else "general", h, to.SKIP_DMAX)
            for h in sizes]
    assert calls == want
    assert [kernels.skipdist_one_launch_holds(h) for h in (16, 128, 24, 100, 144, 256)] == [
        True, True, False, False, False, False]
