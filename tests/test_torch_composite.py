"""Port parity: compositing weights (plain K4) and the per-ray channel sum
(plain K7) vs the JAX package.  Kernels K4 and K7 are held against the
plain versions in tests/test_torch_kernels.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from composite_layouts import (DT, LAYOUTS, T_THRESH, edge_rays, emulate_weights, layout,
                               per_ray)
from nerfstyle_tpu.ops import compositing as jc
from nerfstyle_torch.ops import compositing as tc


def _stream(seed, n=48, channels=6):
    """Ray-major stream: per-ray counts 0..40 (some empty rays) of faint
    samples, then two rays that become opaque (early stop), the last one
    ending in an infinite density (the optical-depth cap keeps inf - inf out
    of the cumsum).  The JAX formula's flat fp32 cumsum stays below ~30, so
    its rounding stays below 1e-5 relative on every weight above 0."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 41, size=n)
    counts[:3] = 0
    counts[-2:] = 8
    m = int(counts.sum())
    sigmas = np.exp(rng.normal(-1.0, 1.0, size=m)).astype(np.float32)
    sigmas[m - 16:] = rng.uniform(40.0, 70.0, size=16).astype(np.float32)
    sigmas[m - 1] = np.inf
    tau = rng.uniform(0.0, 3.0, size=m).astype(np.float32)
    ch = rng.normal(size=(m, channels)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    ray_id = np.repeat(np.arange(n), counts).astype(np.int32)
    return sigmas, tau, ch, offsets, ray_id


def _jax_weights(sigmas, tau, offsets, ray_id):
    n = offsets.shape[0] - 1
    rid = jnp.asarray(ray_id)
    w_j, _ = jc.sample_weights(jnp.asarray(sigmas), rid, jnp.ones(rid.shape, bool), n, DT, T_THRESH)
    ws_j = jax.ops.segment_sum(w_j, rid, num_segments=n)
    dep_j = jax.ops.segment_sum(w_j * jnp.asarray(tau), rid, num_segments=n)
    return [np.asarray(a) for a in (w_j, ws_j, dep_j)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_sample_weights_plain_matches_jax(seed):
    """The plain version (float64 sums) against the JAX fp32 flat cumsum, to
    that cumsum's rounding (ulp of the stream's total optical depth)."""
    sigmas, tau, _, offsets, ray_id = _stream(seed)
    want = _jax_weights(sigmas, tau, offsets, ray_id)
    got = tc.sample_weights_plain(
        torch.from_numpy(sigmas), torch.from_numpy(tau), torch.from_numpy(offsets), DT, T_THRESH
    )
    w = got[0].numpy()
    assert np.isfinite(w).all() and w[-1] == 0.0
    assert (w == 0).any() and (w > 0).any()  # early stop happened
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-5, atol=1e-6)


def test_torch_sample_weights_default_sums_in_float64():
    """On fp32 inputs the float64 sums make the weights equal the exact
    float64 evaluation to fp32 rounding."""
    sigmas, tau, _, offsets, _ = _stream(0)
    exact = tc.sample_weights(
        torch.from_numpy(sigmas.astype(np.float64)), torch.from_numpy(tau.astype(np.float64)),
        torch.from_numpy(offsets), DT, T_THRESH,
    )
    got = tc.sample_weights(
        torch.from_numpy(sigmas), torch.from_numpy(tau), torch.from_numpy(offsets), DT, T_THRESH
    )
    for g, e in zip(got, exact):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_weight_cutoffs_match_jax_stop(seed):
    """A ray's cutoff is where the JAX weights stop: the last sample with a
    nonzero weight, which the entering T >= t_thresh prefix ends with."""
    sigmas, tau, _, offsets, ray_id = _stream(seed)
    w_j = _jax_weights(sigmas, tau, offsets, ray_id)[0]
    off = torch.from_numpy(offsets)
    cut = tc.weight_cutoffs(tc.sample_weights(torch.from_numpy(sigmas), torch.from_numpy(tau),
                                              off, DT, T_THRESH)[0], off)
    assert cut.tolist() == tc.weight_cutoffs(torch.from_numpy(w_j.copy()), off).tolist()
    _, trans = tc.entering_transmittance_plain(torch.from_numpy(sigmas), off, DT)
    kept = tc.segment_totals_plain((trans >= T_THRESH).double(), off).long()
    assert cut.tolist() == kept.tolist()
    counts = np.diff(offsets)
    assert (cut.numpy() < counts).any() and (cut.numpy() <= counts).all()


def test_torch_weight_cutoffs_of_a_small_stream():
    offsets = torch.tensor([0, 0, 3, 5, 8])
    w = torch.tensor([0.5, 0.0, 0.0, 0.0, 0.0, 0.2, 0.3, 0.1])
    assert tc.weight_cutoffs(w, offsets).tolist() == [0, 1, 0, 3]


def test_torch_sample_weights_match_composite_rays():
    """The same weights reduce to composite_rays' weights_sum and depth."""
    from nerfstyle_tpu.ops.marching import SampleBatch

    sigmas, tau, ch, offsets, ray_id = _stream(5)
    n, m = offsets.shape[0] - 1, sigmas.shape[0]
    sb = SampleBatch(
        xyz=jnp.zeros((m, 3)), dirs=jnp.zeros((m, 3)), tau=jnp.asarray(tau),
        ray_id=jnp.asarray(ray_id), valid=jnp.ones((m,), bool),
        num_kept=jnp.int32(m), num_cand=jnp.int32(0),
    )
    out = jc.composite_rays(jnp.asarray(sigmas), jnp.asarray(ch), sb, n, DT, T_THRESH)
    w, ws, dep, _ = tc.sample_weights(
        torch.from_numpy(sigmas), torch.from_numpy(tau), torch.from_numpy(offsets), DT, T_THRESH
    )
    img = tc.segment_sum(w, torch.from_numpy(ch), torch.from_numpy(offsets))
    np.testing.assert_allclose(ws.numpy(), np.asarray(out.weights_sum), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dep.numpy(), np.asarray(out.depth), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(img.numpy(), np.asarray(out.image), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("channels", [3, 6])
def test_torch_segment_sum_plain_matches_jax(channels):
    _, _, ch, offsets, ray_id = _stream(9, channels=channels)
    w = np.random.default_rng(9).uniform(0, 1, size=ray_id.shape[0]).astype(np.float32)
    n = offsets.shape[0] - 1
    want = jax.ops.segment_sum(jnp.asarray(w)[:, None] * jnp.asarray(ch), jnp.asarray(ray_id),
                               num_segments=n)
    got = tc.segment_sum(torch.from_numpy(w), torch.from_numpy(ch), torch.from_numpy(offsets))
    assert got.shape == (n, channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_torch_ray_ids_from_offsets():
    offsets = torch.tensor([0, 0, 3, 3, 5])
    assert tc.ray_ids(offsets).tolist() == [1, 1, 1, 3, 3]



# ---------------------------------------------------------------------------
# Crafted layouts (tests/composite_layouts.py): ray lengths 0 to 1000 across
# the 32-sample chunks of the warp-a-ray kernel, cutoffs on a chunk's last
# lane and on the next chunk's first, rays saturated at their first sample,
# infinite densities mid-chunk, zero-density rays.
# ---------------------------------------------------------------------------

def _jax_ray_weights(s, t, valid):
    rid = jnp.where(valid, 0, 1)
    w, _ = jc.sample_weights(s, rid, valid, 1, DT, T_THRESH)
    return (w, jax.ops.segment_sum(w, rid, num_segments=2)[0],
            jax.ops.segment_sum(w * t, rid, num_segments=2)[0])


_jax_rays_weights = jax.jit(jax.vmap(_jax_ray_weights))


@pytest.mark.parametrize("name", LAYOUTS)
def test_torch_sample_weights_plain_matches_jax_on_crafted_layouts(name):
    """Plain K4 against JAX's sample_weights and segment sums.  JAX gets one
    ray a row (vmap over rows padded with invalid samples), so that its
    flat fp32 cumsum holds one ray's optical depth: the file's tolerance
    (rtol 1e-5, atol 1e-6).  No ray lies in the 1e-4 band around t_thresh,
    and every crafted cutoff is where it was put."""
    sigmas, tau, _, offsets, _, want = layout(name, 3)
    off = torch.from_numpy(offsets)
    w, ws, dep, n_inc = tc.sample_weights(torch.from_numpy(sigmas), torch.from_numpy(tau), off,
                                          DT, T_THRESH)
    crafted = want >= 0
    assert n_inc.numpy()[crafted].tolist() == want[crafted].tolist()
    _, trans = tc.entering_transmittance_plain(torch.from_numpy(sigmas).double(), off, DT)
    assert not edge_rays(trans.numpy(), offsets).any()
    valid = per_ray(np.ones(sigmas.shape, bool), offsets, False)
    w_j, ws_j, dep_j = (np.asarray(a) for a in _jax_rays_weights(
        per_ray(sigmas, offsets), per_ray(tau, offsets), valid))
    n = offsets.shape[0] - 1
    np.testing.assert_allclose(w.numpy(), w_j[valid], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ws.numpy(), ws_j[:n], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dep.numpy(), dep_j[:n], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", LAYOUTS)
def test_torch_sample_weights_warp_scan_emulation(name):
    """K4's order of operations (a warp a ray: 32-sample chunks, a warp scan
    of the optical depth on the chunks' carry, butterfly sums), emulated in
    numpy float32, against the plain version on float64 inputs: the card
    test's tolerances for rays outside the t_thresh band (none is in it):
    the same cutoffs, atol 2e-6 on w and weights_sum, 6e-6 on depth."""
    sigmas, tau, _, offsets, _, _ = layout(name, 3)
    w_e, ws_e, dep_e, n_inc_e = emulate_weights(sigmas, tau, offsets)
    w_p, ws_p, dep_p, n_inc_p = tc.sample_weights(
        torch.from_numpy(sigmas).double(), torch.from_numpy(tau).double(),
        torch.from_numpy(offsets), DT, T_THRESH, plain=True)
    assert n_inc_e.tolist() == n_inc_p.tolist()
    np.testing.assert_allclose(w_e, w_p.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ws_e, ws_p.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(dep_e, dep_p.numpy(), rtol=0, atol=6e-6)
