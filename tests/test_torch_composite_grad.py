"""Port parity: the compositor's gradient (plain K4b: autograd through the
float64 plain forward) vs ``jax.grad`` of the JAX ``composite_rays``, and
the included count ``n_inc`` of K4's forward.  Kernel K4b is held against
the plain version in tests/test_torch_kernels.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstyle_tpu.ops import compositing as jc
from nerfstyle_tpu.ops.marching import SampleBatch
from nerfstyle_torch import kernels
from nerfstyle_torch.ops import compositing as tc

DT = 2.0 * 1.7320508075688772 / 128
T_THRESH = 1e-4
C = 5


def _stream(seed, n=40):
    """Rays of 0..30 faint samples, then three special rays: one that
    crosses t_thresh mid-ray with a zero-density sample in front of its
    cutoff, one whose capped sample (sigma * dt > 100) ends it, and one of
    zero-density samples only."""
    rng = np.random.default_rng(seed)
    counts = list(rng.integers(0, 31, size=n - 3)) + [12, 6, 5]
    m = int(sum(counts))
    sigmas = np.exp(rng.normal(-0.5, 1.0, size=m)).astype(np.float32)
    crossing = m - 23
    sigmas[crossing:crossing + 12] = [20, 0, 30, 35, 40, 38, 36, 33, 31, 40, 45, 50]
    capped = m - 11
    sigmas[capped:capped + 6] = [3.0, 1e5, 2.0, 4.0, 1.0, 0.5]
    sigmas[m - 5:] = 0.0
    tau = rng.uniform(0.0, 3.0, size=m).astype(np.float32)
    ch = rng.normal(size=(m, C)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    ray_id = np.repeat(np.arange(n), counts).astype(np.int32)
    g = [rng.normal(size=s).astype(np.float32) for s in ((n, C), (n,), (n,))]
    return sigmas, tau, ch, offsets, ray_id, g


def _jax_grads(sigmas, tau, ch, ray_id, g, n):
    m = sigmas.shape[0]

    def f(s, c):
        sb = SampleBatch(xyz=jnp.zeros((m, 3)), dirs=jnp.zeros((m, 3)), tau=jnp.asarray(tau),
                         ray_id=jnp.asarray(ray_id), valid=jnp.ones((m,), bool),
                         num_kept=jnp.int32(m), num_cand=jnp.int32(0))
        out = jc.composite_rays(s, c, sb, n, DT, T_THRESH)
        return (jnp.sum(out.image * g[0]) + jnp.sum(out.weights_sum * g[1])
                + jnp.sum(out.depth * g[2]))

    ds, dc = jax.grad(f, argnums=(0, 1))(jnp.asarray(sigmas), jnp.asarray(ch))
    return np.asarray(ds), np.asarray(dc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_composite_grad_matches_jax(seed):
    """d sigmas and d channels against JAX autodiff.  JAX takes T from an
    fp32 flat cumsum (rounding ~1e-7 of the stream's optical depth, ~30
    here); the plain backward sums in float64: rtol 1e-4, atol 1e-6 of the
    largest gradient.  A capped sample's density gradient is 0, as are
    both gradients of every sample past a ray's cutoff."""
    sigmas, tau, ch, offsets, ray_id, g = _stream(seed)
    n = offsets.shape[0] - 1
    want_s, want_c = _jax_grads(sigmas, tau, ch, ray_id, g, n)
    s = torch.from_numpy(sigmas).requires_grad_(True)
    c = torch.from_numpy(ch).requires_grad_(True)
    kernels.reset_launch_counts()
    image, ws, depth, n_inc = tc.composite_rays(s, c, torch.from_numpy(tau),
                                                torch.from_numpy(offsets), DT, T_THRESH)
    torch.autograd.backward((image, ws, depth), [torch.from_numpy(a) for a in g])
    assert all(v == 0 for v in kernels.launch_counts.values())
    got_s, got_c = s.grad.numpy(), c.grad.numpy()
    np.testing.assert_allclose(got_s, want_s, rtol=1e-4, atol=1e-6 * np.abs(want_s).max())
    np.testing.assert_allclose(got_c, want_c, rtol=1e-4, atol=1e-6 * np.abs(want_c).max())

    m = sigmas.shape[0]
    crossing, capped = m - 23, m - 11
    cut = int(n_inc[n - 3])
    assert 2 < cut < 12  # the crossing ray stops mid-ray, behind its zero sample
    assert got_s[crossing + 1] != 0.0  # zero density and weight, nonzero gradient
    assert not np.any(got_s[crossing + cut:crossing + 12])
    assert not np.any(got_c[crossing + cut:crossing + 12])
    assert got_s[capped + 1] == 0.0 and int(n_inc[n - 2]) == 2  # capped, then T = 0
    assert int(n_inc[n - 1]) == 5 and float(ws.detach()[n - 1]) == 0.0


def test_torch_n_inc_counts_the_entering_t_prefix():
    """n_inc is the count of samples with entering T >= t_thresh: the
    prefix the JAX significance mask selects."""
    sigmas, tau, _, offsets, ray_id, _ = _stream(4)
    n = offsets.shape[0] - 1
    inc, _, _ = jc.significance(jnp.asarray(sigmas), jnp.asarray(ray_id),
                                jnp.ones(sigmas.shape, bool), n, DT, T_THRESH)
    want = np.bincount(ray_id[np.asarray(inc)], minlength=n)
    *_, n_inc = tc.sample_weights(torch.from_numpy(sigmas), torch.from_numpy(tau),
                                  torch.from_numpy(offsets), DT, T_THRESH)
    assert n_inc.dtype == torch.int32
    assert n_inc.tolist() == want.tolist()
    assert (n_inc.numpy() < np.diff(offsets)).any()


def test_torch_composite_rays_forward_equals_sample_weights_and_segment_sum():
    sigmas, tau, ch, offsets, _, _ = _stream(3)
    args = [torch.from_numpy(a) for a in (sigmas, tau, offsets)]
    w, ws, depth, n_inc = tc.sample_weights(*args, DT, T_THRESH)
    image, ws2, depth2, n_inc2 = tc.composite_rays(args[0], torch.from_numpy(ch), args[1],
                                                   args[2], DT, T_THRESH)
    assert torch.equal(ws, ws2) and torch.equal(depth, depth2) and torch.equal(n_inc, n_inc2)
    assert torch.equal(image, tc.segment_sum(w, torch.from_numpy(ch), args[2]))
