"""K7b (the backward of the per-ray channel sum) on crafted layouts: a numpy
emulation of the kernel's work split (``segment_layouts``) and the port's
plain version against JAX's VJP of ``jax.ops.segment_sum(w * ch)``: d ch
(one fp32 product) bit for bit, every float written once; d w (C products
summed in order of c, JAX in its own order) within 1e-6 of the largest.
The kernel itself meets the same layouts in ``tests/test_torch_kernels.py``
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import segment_layouts as sg
from nerfstyle_torch.ops import compositing as tc


def _jax_vjp(w, ch, g, offsets):
    rid = np.repeat(np.arange(g.shape[0]), np.diff(offsets))
    _, vjp = jax.vjp(lambda ww, cc: jax.ops.segment_sum(ww[:, None] * cc, jnp.asarray(rid),
                                                        num_segments=g.shape[0]),
                     jnp.asarray(w), jnp.asarray(ch))
    d_w, d_ch = vjp(jnp.asarray(g))
    return np.asarray(d_ch), np.asarray(d_w)


@pytest.mark.parametrize("channels", sg.CHANNELS)
@pytest.mark.parametrize("name", sg.LAYOUTS)
def test_torch_segment_sum_backward_layouts_match_jax(name, channels):
    w, ch, g, offsets = sg.layout(name, channels)
    want_ch, want_w = _jax_vjp(w, ch, g, offsets)
    d_ch, d_w, writes = sg.emulate(w, ch, g, offsets, need_dw=True)
    assert (writes == 1).all()
    np.testing.assert_array_equal(d_ch, want_ch)
    tol = 1e-6 * np.abs(want_w).max()
    np.testing.assert_allclose(d_w, want_w, rtol=0, atol=tol)
    p_ch, p_w = tc.segment_sum_backward_plain(torch.from_numpy(w), torch.from_numpy(ch),
                                              torch.from_numpy(g), torch.from_numpy(offsets),
                                              need_dw=True)
    np.testing.assert_array_equal(p_ch.numpy(), want_ch)
    np.testing.assert_allclose(p_w.numpy(), want_w, rtol=0, atol=tol)
