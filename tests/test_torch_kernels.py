"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  Imports no JAX, so on a machine with a GPU and no JAX it runs as

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest`` skips tests/conftest.py, which configures JAX).  Without a
GPU every test here skips: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from nerfstyle_torch import kernels
from nerfstyle_torch.ops import compositing as tc
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_torch.ops import marching as tm
from nerfstyle_torch.ops.aabb import near_far_from_aabb
from nerfstyle_torch.render.renderer import cascade_for_bound

pytestmark = pytest.mark.cuda

TINY = dict(num_levels=4, level_dim=2, base_resolution=16, per_level_scale=1.5,
            log2_hashmap_size=10)
DT = 2.0 * 1.7320508075688772 / 128
T_THRESH = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_torch_encode_kernel_matches_plain(cuda_device, channels):
    """K1 rounds every step as the plain version does: equal bits.  Points
    include rows outside [0, 1]^3 (zero output)."""
    rng = np.random.default_rng(7)
    spec = th.hashgrid_spec(**TINY)
    x = torch.from_numpy(rng.uniform(-0.1, 1.1, size=(4099, 3)).astype(np.float32)).to(cuda_device)
    table = torch.from_numpy(
        rng.uniform(-1, 1, size=(spec.total_params, channels)).astype(np.float32)
    ).to(cuda_device)
    kernels.reset_launch_counts()
    got = th.hashgrid_encode(spec, table, x)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hashgrid_encode"] == 1
    want = th.hashgrid_encode(spec, table, x, plain=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bound,max_steps,density", [(1.0, 128, 0.3), (2.0, 128, 0.4),
                                                     (2.0, 16, 1.0)])
def test_torch_march_kernel_matches_plain(cuda_device, bound, max_steps, density):
    """K3 rounds o + d*t without FMA: identical samples, order and offsets."""
    rng = np.random.default_rng(13)
    grid = 16
    cascade = cascade_for_bound(bound)
    bits = torch.from_numpy(rng.random(cascade * grid**3) < density).to(cuda_device)
    o = rng.uniform(-2.5 * bound, 2.5 * bound, size=(300, 3)).astype(np.float32)
    d = rng.uniform(-0.8 * bound, 0.8 * bound, size=(300, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ot, dt_ = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    plan = tm.MarchPlan(bound=bound, cascade=cascade, grid_size=grid, max_steps=max_steps,
                        min_near=0.05)
    nt, ft = near_far_from_aabb(ot, dt_, plan.aabb(cuda_device), 0.05)
    kernels.reset_launch_counts()
    got = tm.march_rays(plan, bits, ot, dt_, nt, ft)
    torch.cuda.synchronize()
    assert kernels.launch_counts["march_count"] == 1
    assert kernels.launch_counts["march_write"] == 1
    want = tm.march_rays(plan, bits, ot, dt_, nt, ft, plain=True)
    assert got.num_kept == want.num_kept > 300
    for name in ("xyz", "dirs", "tau", "ray_id", "step", "offsets"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=0)


def test_torch_composite_kernels_match_plain(cuda_device):
    """K4 accumulates each ray's optical depth in fp32 front to back; the
    plain version on float64 inputs is the exact reference.  A sample whose
    entering T lies within rounding of t_thresh may be kept by one and not
    the other; its weight is at most t_thresh: atol 1e-4 on w and
    weights_sum, 3e-4 on depth (tau <= 3).  Such a ray has a sample whose
    exact entering T lies within 1e-4 relative of t_thresh (the fp32
    optical depth near the cutoff, ln 1e4 ~ 9.2, rounds by ~5e-7 an
    addition, and T's relative error is the sum's).  Every other ray stops at the
    same sample as the plain version and agrees to fp32 rounding: atol 2e-6
    (6e-6 on depth).  K7 sums in fp32 in stream order against float64 sums:
    rtol 1e-5."""
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 200, size=257)
    counts[:3] = 0
    m = int(counts.sum())
    sigmas = np.exp(rng.normal(1.0, 2.5, size=m)).astype(np.float32)
    sigmas[-1] = np.inf
    tau = rng.uniform(0.0, 3.0, size=m).astype(np.float32)
    ch = rng.normal(size=(m, 7)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    s, t, c, o = (torch.from_numpy(a).to(cuda_device) for a in (sigmas, tau, ch, offsets))
    kernels.reset_launch_counts()
    w, ws, dep = tc.sample_weights(s, t, o, DT, T_THRESH)
    img = tc.segment_sum(w, c, o)
    torch.cuda.synchronize()
    assert kernels.launch_counts["composite_weights"] == 1
    assert kernels.launch_counts["segment_sum"] == 1
    assert bool(torch.isfinite(w).all()) and bool((w == 0).any())
    w_p, ws_p, dep_p = tc.sample_weights(s.double(), t.double(), o, DT, T_THRESH, plain=True)
    torch.testing.assert_close(w.double(), w_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(ws.double(), ws_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(dep.double(), dep_p, rtol=0, atol=3e-4)
    _, trans = tc.entering_transmittance_plain(s.double(), o, DT)
    near = (trans - T_THRESH).abs() <= 1e-4 * T_THRESH
    inner = tc.segment_totals_plain(near.double(), o) == 0
    stopped = tc.weight_cutoffs(w_p, o) < o[1:] - o[:-1]
    assert int((inner & stopped).sum()) > 10
    assert torch.equal(tc.weight_cutoffs(w, o)[inner], tc.weight_cutoffs(w_p, o)[inner])
    on_inner = inner[tc.ray_ids(o)]
    torch.testing.assert_close(w.double()[on_inner], w_p[on_inner], rtol=0, atol=2e-6)
    torch.testing.assert_close(ws.double()[inner], ws_p[inner], rtol=0, atol=2e-6)
    torch.testing.assert_close(dep.double()[inner], dep_p[inner], rtol=0, atol=6e-6)
    torch.testing.assert_close(img, tc.segment_sum(w, c, o, plain=True), rtol=1e-5, atol=1e-6)


def test_torch_kernels_reject_cpu_and_bad_inputs(cuda_device):
    """The wrappers take CUDA tensors of the documented dtype and shape only."""
    spec = th.hashgrid_spec(**TINY)
    table = torch.zeros(spec.total_params, 2, device=cuda_device)
    lv = th.level_table(spec, cuda_device)
    with pytest.raises(ValueError):
        kernels.hashgrid_encode(torch.rand(4, 3), table, lv)  # CPU points
    with pytest.raises(ValueError):
        kernels.hashgrid_encode(torch.rand(4, 2, device=cuda_device), table, lv)
    with pytest.raises(ValueError):
        kernels.hashgrid_encode(torch.rand(4, 3, device=cuda_device).double(), table, lv)
    with pytest.raises(ValueError):
        kernels.segment_sum(torch.rand(4, device=cuda_device), torch.rand(3, 2, device=cuda_device),
                            torch.tensor([0, 4], device=cuda_device))


def test_torch_empty_inputs_launch_nothing(cuda_device):
    spec = th.hashgrid_spec(**TINY)
    kernels.reset_launch_counts()
    out = th.hashgrid_encode(spec, torch.zeros(spec.total_params, 2, device=cuda_device),
                             torch.zeros(0, 3, device=cuda_device))
    assert out.shape == (0, spec.output_dim)
    assert kernels.launch_counts["hashgrid_encode"] == 0
