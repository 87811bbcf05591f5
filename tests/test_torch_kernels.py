"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  Imports no JAX, so on a machine with a GPU and no JAX it runs as

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(``--noconftest`` skips tests/conftest.py, which configures JAX).  Without a
GPU every test here skips: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

import segment_layouts as sg
import skipdist_layouts as sl
from composite_layouts import CHANNELS, LAYOUTS, layout
from nerfstyle_torch import interop, kernels
from nerfstyle_torch.ops import compositing as tc
from nerfstyle_torch.ops import hashgrid as th
from nerfstyle_torch.ops import marching as tm
from nerfstyle_torch.ops import morton as tmorton
from nerfstyle_torch.ops import occupancy as to
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


@pytest.mark.parametrize("bound,max_steps,density,rays", [
    pytest.param(b, s, dn, n, id=f"{b}-{s}-{dn}" + ("" if n == 300 else f"-{n}rays"))
    for b, s, dn, n in [(1.0, 128, 0.3, 300), (2.0, 128, 0.02, 300), (2.0, 16, 1.0, 300),
                        (2.0, 1024, 0.002, 300), (2.0, 13, 0.3, 300), (2.0, 1024, 0.05, 4096)]])
def test_torch_two_stage_march_kernel_matches_plain_and_dense(cuda_device, bound, max_steps,
                                                              density, rays):
    """K3s rounds as K3 does: the plain two-stage march's samples, order,
    offsets and candidate count, and the dense kernel's samples.  The
    max_steps 13 case caps rays inside a window and inside a warp's group of
    four windows; the 4096-ray batch (a late train batch) at max_steps 1024
    has rays of more than 32 windows, so a warp's coarse stage takes more
    than one group."""
    rng = np.random.default_rng(17)
    grid = 16
    cascade = cascade_for_bound(bound)
    bits = torch.from_numpy(rng.random(cascade * grid**3) < density).to(cuda_device)
    occ = tm.OccField(bits, to.skipdist_from_bitfield(bits, grid, plain=True))
    o = rng.uniform(-2.5 * bound, 2.5 * bound, size=(rays, 3)).astype(np.float32)
    d = rng.uniform(-0.8 * bound, 0.8 * bound, size=(rays, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ot, dt_ = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    plan = tm.MarchPlan(bound=bound, cascade=cascade, grid_size=grid, max_steps=max_steps,
                        min_near=0.05)
    nt, ft = near_far_from_aabb(ot, dt_, plan.aabb(cuda_device), 0.05)
    kernels.reset_launch_counts()
    got = tm.march_rays(plan, occ, ot, dt_, nt, ft)
    torch.cuda.synchronize()
    assert kernels.launch_counts["march_skip_count"] == 1
    assert kernels.launch_counts["march_skip_write"] == 1
    assert kernels.launch_counts["march_count"] == 0
    want = tm.march_rays(plan, occ, ot, dt_, nt, ft, plain=True)
    dense = tm.march_rays(plan, bits, ot, dt_, nt, ft)
    assert got.num_kept == want.num_kept == dense.num_kept > 0
    assert got.num_cand == want.num_cand > 0
    for name in ("xyz", "dirs", "tau", "ray_id", "step", "offsets"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=0)
        torch.testing.assert_close(getattr(got, name), getattr(dense, name), rtol=0, atol=0)


@pytest.mark.parametrize("grid,cascade,density", [(16, 1, 0.01), (32, 2, 0.0005), (32, 2, 0.2),
                                                  (16, 2, 0.0)])
def test_torch_skipdist_kernel_matches_plain(cuda_device, grid, cascade, density):
    """K6c (one fused pass over a slab and its halo in shared memory) equals
    the plain iterated dilation bit for bit, in one launch."""
    bits = torch.from_numpy(
        np.random.default_rng(grid + cascade).random(cascade * grid**3) < density).to(cuda_device)
    kernels.reset_launch_counts()
    got = to.skipdist_from_bitfield(bits, grid)
    torch.cuda.synchronize()
    assert kernels.launch_counts["occupancy_skipdist"] == 1
    want = to.skipdist_from_bitfield(bits, grid, plain=True)
    assert got.dtype == torch.uint8 and torch.equal(got, want)


def test_torch_occupancy_restore_and_merge_launch_skipdist(cuda_device):
    """A restore and a merge rebuild the skip distance through K6c."""
    rng = np.random.default_rng(4)
    grid = torch.from_numpy(rng.exponential(1.0, size=(2, 16**3)).astype(np.float32))
    state = to.occupancy_init(2, 16)._replace(density_grid=grid)
    persisted = to.occupancy_persistable(state._replace(bitfield=grid.reshape(-1) > 2.0))
    kernels.reset_launch_counts()
    restored = to.occupancy_restore(persisted, 16, cuda_device)
    merged = to.merge_and_threshold(restored, torch.full_like(restored.density_grid, -1.0),
                                    0.95, 1.0, grid_size=16)
    torch.cuda.synchronize()
    assert kernels.launch_counts["occupancy_skipdist"] == 2
    for s in (restored, merged):
        assert torch.equal(s.skipdist, to.skipdist_from_bitfield(s.bitfield, 16, plain=True))


SKIPDIST_CASES = [(h, cas, name) for h in (16, 32, 128) for cas in (1, 2) for name in sl.names(h)]


def _skipdist_case(bits: np.ndarray, h: int, device) -> None:
    t = torch.from_numpy(bits).to(device)
    kernels.reset_launch_counts()
    got = kernels.occupancy_skipdist(t, h, to.SKIP_DMAX)
    again = kernels.occupancy_skipdist(t, h, to.SKIP_DMAX)
    torch.cuda.synchronize()
    assert kernels.launch_counts["occupancy_skipdist"] == 2 * kernels.SKIPDIST_LAUNCHES == 2
    want = to.skipdist_from_bitfield(t, h, plain=True)
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.parametrize("h,cascade,name", SKIPDIST_CASES)
def test_torch_skipdist_kernel_on_crafted_grids(cuda_device, h, cascade, name):
    """K6c on the crafted grids of tests/skipdist_layouts.py (empty, full,
    single cells at corners, edges and centre, cells 14 and 15 from a probe
    along each axis and the diagonal, on a slab border, in a halo, across a
    z-word border; h = 16, 32, 128; 1 and 2 cascades): equal to the plain
    version bit for bit, two launches equal, one launch a call."""
    _skipdist_case(sl.grid(name, h, cascade), h, cuda_device)


def test_torch_skipdist_kernel_on_a_sparse_random_grid(cuda_device):
    _skipdist_case(sl.sparse_random(), 128, cuda_device)


GENERAL_CASES = [(h, cas, name) for h in (24, 40, 100, 256) for cas in (1, 2)
                 for name in sl.names(h)]


def _skipdist_general_case(bits: np.ndarray, h: int, device) -> None:
    t = torch.from_numpy(bits).to(device)
    kernels.reset_launch_counts()
    got = to.skipdist_from_bitfield(t, h)
    again = to.skipdist_from_bitfield(t, h)
    torch.cuda.synchronize()
    assert kernels.launch_counts["occupancy_skipdist_general"] == (
        2 * kernels.SKIPDIST_GENERAL_LAUNCHES)
    assert kernels.launch_counts["occupancy_skipdist"] == 0
    want = to.skipdist_from_bitfield(t, h, plain=True)
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.parametrize("h,cascade,name", GENERAL_CASES)
def test_torch_skipdist_general_kernel_on_crafted_grids(cuda_device, h, cascade, name):
    """K6c's general entry (three axis passes) at grid sizes the one-launch
    kernel does not take (24, 40, 100: not multiples of 16; 256: above
    128), reached through skipdist_from_bitfield, on the crafted grids of
    tests/skipdist_layouts.py: equal to the plain version bit for bit, two
    calls equal, three launches a call."""
    _skipdist_general_case(sl.grid(name, h, cascade), h, cuda_device)


def test_torch_skipdist_general_kernel_on_a_sparse_random_grid(cuda_device):
    """2 x 256^3 cells, 0.02% occupied: every distance up to the cap."""
    _skipdist_general_case(sl.sparse_random(h=256), 256, cuda_device)


@pytest.mark.parametrize("h", [24, 100, 256])
def test_torch_occupancy_restore_and_merge_at_grid_sizes_off_the_tiles(cuda_device, h):
    """A restore and a merge at such a grid size rebuild the skip distance
    through the general entry: no one-launch K6c, the plain result."""
    rng = np.random.default_rng(h)
    grid = torch.from_numpy(rng.exponential(1.0, size=(2, h**3)).astype(np.float32))
    state = to.occupancy_init(2, h)._replace(density_grid=grid)
    persisted = to.occupancy_persistable(state._replace(bitfield=grid.reshape(-1) > 6.0))
    kernels.reset_launch_counts()
    restored = to.occupancy_restore(persisted, h, cuda_device)
    merged = to.merge_and_threshold(restored, torch.full_like(restored.density_grid, -1.0),
                                    0.95, 1.0, grid_size=h)
    torch.cuda.synchronize()
    assert kernels.launch_counts["occupancy_skipdist_general"] == (
        2 * kernels.SKIPDIST_GENERAL_LAUNCHES)
    assert kernels.launch_counts["occupancy_skipdist"] == 0
    for s in (restored, merged):
        assert torch.equal(s.skipdist, to.skipdist_from_bitfield(s.bitfield, h, plain=True))


@pytest.mark.parametrize("h", [24, 256])
def test_torch_skipdist_kernel_refuses_grids_its_tiles_do_not_hold(cuda_device, h):
    """Grid sizes that are not a multiple of 16, or above 128, raise."""
    bits = torch.zeros(h**3, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 16 up to 128"):
        kernels.occupancy_skipdist(bits, h, to.SKIP_DMAX)


@pytest.mark.parametrize("need_dw", [False, True])
@pytest.mark.parametrize("channels", sg.CHANNELS)
@pytest.mark.parametrize("name", sg.LAYOUTS)
def test_torch_segment_sum_backward_kernel_on_crafted_layouts(cuda_device, name, channels,
                                                              need_dw):
    """K7b on the crafted layouts of tests/segment_layouts.py (runs of
    empty rays, a ray across a tile edge, one ray longer than a tile, a
    style-like stream, a tile spanning more rays than it stages, one
    sample): d ch equal to the plain version's bits, d w within 1e-6 of the
    largest (C products in another order), two launches equal, one launch
    a call."""
    w, ch, g, offsets = (torch.from_numpy(a).to(cuda_device)
                         for a in sg.layout(name, channels))
    kernels.reset_launch_counts()
    d_ch, d_w = kernels.segment_sum_backward(w, ch, g, offsets, need_dw)
    d_ch2, d_w2 = kernels.segment_sum_backward(w, ch, g, offsets, need_dw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["segment_sum_backward"] == 2
    p_ch, p_w = tc.segment_sum_backward_plain(w, ch, g, offsets, need_dw)
    assert torch.equal(d_ch, p_ch) and torch.equal(d_ch, d_ch2)
    if need_dw:
        torch.testing.assert_close(d_w, p_w, rtol=0, atol=1e-6 * float(p_w.abs().max()))
        assert torch.equal(d_w, d_w2)
    else:
        assert d_w is None


@pytest.mark.parametrize("simplex_from", [0, 2])
@pytest.mark.parametrize("channels", [2, 4])
def test_torch_simplex_encode_kernels_match_plain(cuda_device, simplex_from, channels):
    """K1 and K2 on simplex levels: the encode equals the plain version bit
    for bit (same rounding); the table gradient its float64 sums within rtol
    1e-5 and 1e-6 of the largest row (the atomics' order)."""
    rng = np.random.default_rng(simplex_from + channels)
    spec = th.hashgrid_spec(**TINY, simplex_from=simplex_from)
    x = torch.from_numpy(rng.uniform(-0.1, 1.1, size=(5003, 3)).astype(np.float32)).to(cuda_device)
    x[:3] = torch.tensor([[0.5, 0.5, 0.5], [0.25, 0.25, 0.75], [0.3, 0.3, 0.1]])
    table = torch.from_numpy(
        rng.uniform(-1, 1, size=(spec.total_params, channels)).astype(np.float32)
    ).to(cuda_device).requires_grad_(True)
    g = torch.from_numpy(
        rng.normal(size=(5003, spec.num_levels * channels)).astype(np.float32)).to(cuda_device)
    kernels.reset_launch_counts()
    out = th.hashgrid_encode(spec, table, x)
    out.backward(g)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hashgrid_encode"] == 1
    assert kernels.launch_counts["hashgrid_backward"] == 1
    want = th.hashgrid_encode(spec, table.detach(), x, plain=True)
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    want_g = th.hashgrid_backward_plain(spec, x, g.double(), spec.total_params)
    torch.testing.assert_close(table.grad.double(), want_g, rtol=1e-5,
                               atol=1e-6 * float(want_g.abs().max()))


def _ordered_stream(rng, case, res0=16):
    """Points [N, 3] float32 as a path hands them to K1 and K2: ray-major
    and t-ordered, neighbouring rays next to each other (K1 and K2 take 32
    consecutive points a warp).  ``res0`` is the grid's level-0 resolution."""
    if case == "one cell":  # every point in the level-0 cell (3, 4, 5)
        return ((np.array([3, 4, 5]) + rng.uniform(0.1, 0.9, size=(700, 3))) / res0).astype(
            np.float32)
    if case in ("31 points", "32 points", "33 points", "one point"):
        n = 1 if case == "one point" else int(case.split()[0])
        t = np.linspace(0.0, 0.05, n)[:, None]
        return (np.array([0.3, 0.4, 0.5]) + t * np.array([0.6, 0.48, 0.64])).astype(np.float32)
    if case == "cell edges":  # x on edges of level 0, even and odd, 0 and 1.0
        xs = np.concatenate([np.arange(res0 + 1) / res0, [0.0, 1.0, 1.0, 0.0]]).astype(np.float32)
        yz = rng.uniform(0, 1, size=(xs.shape[0], 2)).astype(np.float32)
        pts = np.concatenate([xs[:, None], yz], axis=1)
        return np.concatenate([pts, pts[:, [1, 0, 2]], np.ones((5, 3), np.float32)])
    if case == "outside in a tile":  # rays entering and leaving [0, 1]^3 mid-tile
        o = np.array([[-0.05, 0.5, 0.5], [0.5, -0.02, 0.4], [0.4, 0.6, 1.03]])
        d = np.array([[1.0, 0.1, 0.05], [0.05, 1.0, 0.1], [0.1, 0.05, -1.0]])
        t = np.arange(0.0, 1.2, 0.004)[:, None, None]
        return (o[None] + t * d[None]).transpose(1, 0, 2).reshape(-1, 3).astype(np.float32)
    # "rays": 16 neighbouring rays of 160 samples each, dt ~ 1/500
    o = np.array([0.1, 0.15, 0.2]) + rng.uniform(0, 0.01, size=(16, 1, 3))
    d = np.array([0.5, 0.45, 0.4]) + rng.uniform(0, 0.01, size=(16, 1, 3))
    t = np.arange(160)[None, :, None] * 0.004
    return (o + t * d).reshape(-1, 3).astype(np.float32)


STREAM_CASES = ["rays", "one cell", "31 points", "32 points", "33 points", "one point",
                "cell edges", "outside in a tile", "unaligned table"]


@pytest.mark.parametrize("simplex_from", [-1, 2])
@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("case", STREAM_CASES)
def test_torch_hashgrid_kernels_on_ordered_streams(cuda_device, case, channels, simplex_from):
    """K1 and K2 on ray-ordered streams, where neighbouring lanes share
    cells and rows: K1 equals the plain version bit for bit; K2 the plain
    version's float64 sums within rtol 1e-5 and 1e-6 of the largest row
    (only the order of the fp32 sums differs).  Tiles of 1, 31, 32 and 33
    points; x on cell edges, at 0 and at 1.0; points outside [0, 1]^3 inside
    a tile (they add nothing); a table that is not 16-byte aligned (no pair
    loads).  One launch each."""
    rng = np.random.default_rng(STREAM_CASES.index(case) + 10 * channels)
    spec = th.hashgrid_spec(**TINY, simplex_from=simplex_from)
    x = torch.from_numpy(_ordered_stream(rng, case)).to(cuda_device)
    values = rng.uniform(-1, 1, size=(spec.total_params + 1, channels)).astype(np.float32)
    base = torch.from_numpy(values).to(cuda_device)
    table = base[1:] if case == "unaligned table" else base[:-1]
    assert (table.data_ptr() % 16 != 0) == (case == "unaligned table" and channels < 4)
    g = torch.from_numpy(rng.normal(size=(x.shape[0], spec.num_levels * channels))
                         .astype(np.float32)).to(cuda_device)
    kernels.reset_launch_counts()
    got = kernels.hashgrid_encode(x, table, th.level_table(spec, cuda_device))
    grad = kernels.hashgrid_backward(x, g, th.level_table(spec, cuda_device), spec.total_params)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hashgrid_encode"] == 1
    assert kernels.launch_counts["hashgrid_backward"] == 1
    torch.testing.assert_close(got, th.hashgrid_encode(spec, table, x, plain=True), rtol=0, atol=0)
    want = th.hashgrid_backward_plain(spec, x, g.double(), spec.total_params)
    torch.testing.assert_close(grad.double(), want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    inside = ((x >= 0) & (x <= 1)).all(dim=-1)
    if case == "outside in a tile":
        assert 0 < int((~inside).sum()) < x.shape[0]
        assert not bool(got[~inside].any())


@pytest.mark.parametrize("channels", [2, 4])
def test_torch_hashgrid_kernels_with_many_levels(cuda_device, channels):
    """48 levels: K1's and K2's tiles take more than 48 KB of shared memory a
    CTA (the launch raises the kernel's limit first)."""
    rng = np.random.default_rng(channels)
    spec = th.hashgrid_spec(num_levels=48, level_dim=2, base_resolution=4,
                            per_level_scale=1.1, log2_hashmap_size=10, simplex_from=40)
    x = torch.from_numpy(_ordered_stream(rng, "rays", res0=4)).to(cuda_device)
    table = torch.from_numpy(rng.uniform(-1, 1, size=(spec.total_params, channels))
                             .astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(x.shape[0], 48 * channels)).astype(np.float32)).to(
        cuda_device)
    lv = th.level_table(spec, cuda_device)
    torch.testing.assert_close(kernels.hashgrid_encode(x, table, lv),
                               th.hashgrid_encode(spec, table, x, plain=True), rtol=0, atol=0)
    want = th.hashgrid_backward_plain(spec, x, g.double(), spec.total_params)
    torch.testing.assert_close(kernels.hashgrid_backward(x, g, lv, spec.total_params).double(),
                               want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


def test_torch_interop_kernels_match_plain(cuda_device):
    """K8a (pack, unpack) and K8b (Morton code, inverse) equal their plain
    versions bit for bit, and a grid's round trip through the reference
    layout is the identity."""
    rng = np.random.default_rng(9)
    h = 32
    bits = torch.from_numpy(rng.random(2 * h**3) < 0.3).to(cuda_device)
    coords = torch.from_numpy(rng.integers(0, 1024, size=(10001, 3)).astype(np.int32)).to(
        cuda_device)
    codes = torch.from_numpy(rng.integers(0, 2**30, size=10001).astype(np.int32)).to(cuda_device)
    kernels.reset_launch_counts()
    packed = to.packbits(bits)
    unpacked = to.unpackbits(packed)
    mc = tmorton.morton3d(coords)
    inv = tmorton.morton3d_invert(codes)
    torch.cuda.synchronize()
    for name in ("packbits", "unpackbits", "morton3d", "morton3d_invert"):
        assert kernels.launch_counts[name] == 1, name
    assert torch.equal(packed, to.packbits(bits, plain=True))
    assert torch.equal(unpacked, bits)
    assert torch.equal(mc, tmorton.morton3d(coords, plain=True))
    assert torch.equal(inv, tmorton.morton3d_invert(codes, plain=True))
    grid = torch.from_numpy(rng.normal(size=(2, h**3)).astype(np.float32)).to(cuda_device)
    ref_bits = interop.linear_bitfield_to_reference(bits, h)
    assert torch.equal(ref_bits, interop.linear_bitfield_to_reference(bits, h, plain=True))
    g_lin, b_lin = interop.import_reference_grid_state(
        interop.linear_grid_to_morton(grid, h).cpu().numpy(), ref_bits.cpu().numpy(), h,
        cuda_device)
    assert torch.equal(g_lin, grid) and torch.equal(b_lin, bits)


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
    w, ws, dep, n_inc = tc.sample_weights(s, t, o, DT, T_THRESH)
    img = tc.segment_sum(w, c, o)
    torch.cuda.synchronize()
    assert kernels.launch_counts["composite_weights"] == 1
    assert kernels.launch_counts["segment_sum"] == 1
    assert bool(torch.isfinite(w).all()) and bool((w == 0).any())
    w_p, ws_p, dep_p, n_inc_p = tc.sample_weights(s.double(), t.double(), o, DT, T_THRESH,
                                                  plain=True)
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


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_torch_hashgrid_backward_kernel_matches_plain(cuda_device, channels):
    """K2 adds the same w * g contributions as the plain version, in the
    order its atomics land: against the plain version's float64 sums, rtol
    1e-5 and atol 1e-6 of the largest row (rows whose contributions cancel).
    Points outside [0, 1]^3 add nothing; the autograd path launches K2 once."""
    rng = np.random.default_rng(11)
    spec = th.hashgrid_spec(**TINY)
    x = torch.from_numpy(rng.uniform(-0.1, 1.1, size=(5003, 3)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(
        rng.normal(size=(5003, spec.num_levels * channels)).astype(np.float32)).to(cuda_device)
    table = torch.zeros(spec.total_params, channels, device=cuda_device, requires_grad=True)
    kernels.reset_launch_counts()
    th.hashgrid_encode(spec, table, x).backward(g)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hashgrid_backward"] == 1
    want = th.hashgrid_backward_plain(spec, x, g.double(), spec.total_params)
    torch.testing.assert_close(table.grad.double(), want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    inside = ((x >= 0) & (x <= 1)).all(dim=-1)
    only_out = th.hashgrid_backward_plain(spec, x[~inside], g[~inside], spec.total_params)
    assert not bool(only_out.any())
    assert not bool(kernels.hashgrid_backward(
        x[~inside].contiguous(), g[~inside].contiguous(), th.level_table(spec, cuda_device),
        spec.total_params).any())


def _grad_stream(rng, n=300, c=7):
    """Ray-major samples with long, saturating and zero-density rays and an
    infinite density (capped optical depth)."""
    counts = rng.integers(0, 200, size=n)
    counts[:3] = 0
    m = int(counts.sum())
    sigmas = np.exp(rng.normal(1.0, 2.5, size=m)).astype(np.float32)
    sigmas[rng.random(m) < 0.05] = 0.0
    sigmas[-1] = np.inf
    tau = rng.uniform(0.0, 3.0, size=m).astype(np.float32)
    ch = rng.normal(size=(m, c)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    g = [rng.normal(size=s).astype(np.float32) for s in ((n, c), (n,), (n,))]
    return sigmas, tau, ch, offsets, g


def test_torch_composite_backward_kernel_matches_plain(cuda_device):
    """K4b (one reverse walk a ray, fp32) against the plain backward (autograd
    through the float64 plain forward) on the same inputs.  A ray whose
    entering T comes within 1e-4 relative of t_thresh may include one sample
    more or less in fp32 and is left out of the comparison (as for K4).  On
    the others: d ch = w * gI to fp32 rounding of w (rtol 1e-5, atol 1e-6);
    d sigma = dt (T_{i+1} v_i - suffix) loses digits to the difference:
    rtol 1e-4, atol 1e-5 of the largest.  Samples past the cutoff get 0."""
    rng = np.random.default_rng(5)
    sigmas, tau, ch, offsets, g = _grad_stream(rng)
    s, t, c, o = (torch.from_numpy(a).to(cuda_device) for a in (sigmas, tau, ch, offsets))
    gs = [torch.from_numpy(a).to(cuda_device) for a in g]
    s_k, c_k = s.clone().requires_grad_(True), c.clone().requires_grad_(True)
    kernels.reset_launch_counts()
    image, ws, depth, n_inc = tc.composite_rays(s_k, c_k, t, o, DT, T_THRESH)
    torch.autograd.backward((image, ws, depth), gs)
    torch.cuda.synchronize()
    assert kernels.launch_counts["composite_backward"] == 1
    assert kernels.launch_counts["composite_weights"] == 1
    assert kernels.launch_counts["segment_sum"] == 1
    s_p, c_p = s.double().requires_grad_(True), c.double().requires_grad_(True)
    image_p, ws_p, depth_p, n_inc_p = tc.composite_rays(s_p, c_p, t.double(), o, DT, T_THRESH,
                                                        plain=True)
    torch.autograd.backward((image_p, ws_p, depth_p), [v.double() for v in gs])
    _, trans = tc.entering_transmittance_plain(s.double(), o, DT)
    near = (trans - T_THRESH).abs() <= 1e-4 * T_THRESH
    inner = tc.segment_totals_plain(near.double(), o) == 0
    assert torch.equal(n_inc[inner], n_inc_p[inner])
    assert int((inner & (n_inc < o[1:] - o[:-1])).sum()) > 10  # rays that stop early
    on_inner = inner[tc.ray_ids(o)]
    d_s, d_sp = s_k.grad.double()[on_inner], s_p.grad[on_inner]
    d_c, d_cp = c_k.grad.double()[on_inner], c_p.grad[on_inner]
    assert bool(torch.isfinite(s_k.grad).all()) and bool(torch.isfinite(c_k.grad).all())
    torch.testing.assert_close(d_c, d_cp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(d_s, d_sp, rtol=1e-4, atol=1e-5 * float(d_sp.abs().max()))
    local = torch.arange(s.shape[0], device=cuda_device) - o[:-1][tc.ray_ids(o)]
    past = local >= n_inc.long()[tc.ray_ids(o)]
    assert bool(past.any()) and not bool(s_k.grad[past].any()) and not bool(c_k.grad[past].any())


@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("name", LAYOUTS)
def test_torch_composite_kernels_on_crafted_layouts(cuda_device, name, channels):
    """K4 and K4b (a warp a ray, in 32-sample chunks) on crafted layouts
    (tests/composite_layouts.py: ray lengths 0 to 1000 across the chunks,
    cutoffs on lane 31 and on the next chunk's lane 0, rays saturated at
    their first sample, an infinite density mid-chunk, zero-density rays)
    against their plain versions on float64 inputs, at the two tests'
    tolerances above.  No ray of these layouts lies in the 1e-4 band
    around t_thresh, so every ray is held to the tight ones: the plain
    version's cutoff (n_inc), atol 2e-6 on w and weights_sum, 6e-6 on
    depth; the channel sum rtol 1e-5; d ch rtol 1e-5, atol 1e-6; d sigma
    rtol 1e-4, atol 1e-5 of the largest.  composite_rays launches each
    kernel once, and a second launch of either gives the same bits."""
    sigmas, tau, ch, offsets, g, want = layout(name, channels)
    s, t, c, o = (torch.from_numpy(a).to(cuda_device) for a in (sigmas, tau, ch, offsets))
    gs = [torch.from_numpy(a).to(cuda_device) for a in g]
    s_k, c_k = s.clone().requires_grad_(True), c.clone().requires_grad_(True)
    kernels.reset_launch_counts()
    image, ws, depth, n_inc = tc.composite_rays(s_k, c_k, t, o, DT, T_THRESH)
    torch.autograd.backward((image, ws, depth), gs)
    torch.cuda.synchronize()
    assert kernels.launch_counts["composite_weights"] == 1
    assert kernels.launch_counts["composite_backward"] == 1
    fwd = [kernels.composite_weights(s, t, o, DT, T_THRESH) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*fwd))
    w = fwd[0][0]
    assert torch.equal(fwd[0][1], ws) and torch.equal(fwd[0][2], depth)
    assert torch.equal(fwd[0][3], n_inc)
    bwd = [kernels.composite_backward(s, c, t, w, o, n_inc, *gs, DT) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*bwd))
    assert torch.equal(bwd[0][0], s_k.grad) and torch.equal(bwd[0][1], c_k.grad)

    crafted = torch.from_numpy(want >= 0).to(cuda_device)
    assert n_inc[crafted].tolist() == want[want >= 0].tolist()
    _, trans = tc.entering_transmittance_plain(s.double(), o, DT)
    assert not bool(((trans - T_THRESH).abs() <= 1e-4 * T_THRESH).any())
    s_p, c_p = s.double().requires_grad_(True), c.double().requires_grad_(True)
    image_p, ws_p, depth_p, n_inc_p = tc.composite_rays(s_p, c_p, t.double(), o, DT, T_THRESH,
                                                        plain=True)
    torch.autograd.backward((image_p, ws_p, depth_p), [v.double() for v in gs])
    w_p = tc.sample_weights(s.double(), t.double(), o, DT, T_THRESH, plain=True)[0]
    assert torch.equal(n_inc, n_inc_p)
    torch.testing.assert_close(w.double(), w_p, rtol=0, atol=2e-6)
    torch.testing.assert_close(ws.double(), ws_p, rtol=0, atol=2e-6)
    torch.testing.assert_close(depth.double(), depth_p, rtol=0, atol=6e-6)
    torch.testing.assert_close(image, tc.segment_sum(w, c, o, plain=True), rtol=1e-5, atol=1e-6)
    assert bool(torch.isfinite(s_k.grad).all()) and bool(torch.isfinite(c_k.grad).all())
    torch.testing.assert_close(c_k.grad.double(), c_p.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s_k.grad.double(), s_p.grad, rtol=1e-4,
                               atol=1e-5 * float(s_p.grad.abs().max()))
    local = torch.arange(s.shape[0], device=cuda_device) - o[:-1][tc.ray_ids(o)]
    past = local >= n_inc.long()[tc.ray_ids(o)]
    assert not bool(s_k.grad[past].any()) and not bool(c_k.grad[past].any())
    assert not bool(w[past].any())


def test_torch_occupancy_kernels_match_plain(cuda_device):
    """K6: the scatter-max is exact (a max is order-free, atomicMax on the
    bits of floats >= 0 over a -1 fill); the merge is elementwise and exact;
    the mean sums per-block float64 partials (the plain version: one float64
    sum): rtol 1e-6; so the bitfield is equal."""
    rng = np.random.default_rng(2)
    cascade, n = 2, 32**3
    grid = rng.exponential(1.0, size=cascade * n).astype(np.float32)
    grid[rng.random(grid.shape) < 0.3] = 0.0
    grid[rng.random(grid.shape) < 0.05] = -1.0
    idx = rng.integers(0, cascade * n, size=cascade * n // 2)
    sig = rng.exponential(2.0, size=idx.shape[0]).astype(np.float32)
    sig[:100] = 0.0
    g_d, i_d, s_d = (torch.from_numpy(a).to(cuda_device) for a in (grid, idx, sig))
    kernels.reset_launch_counts()
    tmp = to.scatter_max(torch.full((cascade * n,), -1.0, device=cuda_device), i_d, s_d)
    merged, bits, mean = kernels.occupancy_merge(g_d, tmp, 0.95, 10.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts["occupancy_scatter_max"] == 1
    assert kernels.launch_counts["occupancy_merge"] == 1
    tmp_p = to.scatter_max(torch.full((cascade * n,), -1.0, device=cuda_device), i_d, s_d,
                           plain=True)
    assert torch.equal(tmp, tmp_p)
    merged_p, bits_p, mean_p = to.merge_and_threshold_plain(g_d, tmp_p, 0.95, 10.0)
    assert torch.equal(merged, merged_p)
    torch.testing.assert_close(mean, mean_p, rtol=1e-6, atol=0)
    assert torch.equal(bits, bits_p) and 0 < int(bits.sum()) < bits.numel()


def _merge_inputs(k: int, seed: int):
    rng = np.random.default_rng(seed)
    grid = rng.exponential(1.0, size=k).astype(np.float32)
    grid[rng.random(k) < 0.3] = 0.0
    grid[rng.random(k) < 0.05] = -1.0
    tmp = np.where(rng.random(k) < 0.5, rng.exponential(2.0, size=k), -1.0).astype(np.float32)
    return grid, tmp


@pytest.mark.parametrize("k,offset", [(16**3, 0), (2 * 128**3, 0), (1_000_003, 0),
                                      (2 * 128**3, 1), (777, 3)])
def test_torch_occupancy_merge_kernel_bit_equal_and_deterministic(cuda_device, k, offset):
    """K6m (one cooperative launch): the merged grid and the bitfield equal
    the plain version's bits, the mean within 1e-6 relative (float64 sums
    in another order), and a second launch gives the same bits, mean
    included.  K = 16^3, 2 x 128^3 (every CTA's chunk in shared memory), an
    odd K that no vector width divides (a tail), and inputs offset by
    ``offset`` floats (not 16-byte aligned: the cell-at-a-time walk)."""
    grid, tmp = _merge_inputs(k + offset, k)
    g_d = torch.from_numpy(grid).to(cuda_device)[offset:]
    t_d = torch.from_numpy(tmp).to(cuda_device)[offset:]
    kernels.reset_launch_counts()
    merged, bits, mean = kernels.occupancy_merge(g_d, t_d, 0.95, 10.0)
    merged2, bits2, mean2 = kernels.occupancy_merge(g_d, t_d, 0.95, 10.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts["occupancy_merge"] == 2
    merged_p, bits_p, mean_p = to.merge_and_threshold_plain(g_d, t_d, 0.95, 10.0)
    assert torch.equal(merged, merged_p) and torch.equal(bits, bits_p)
    torch.testing.assert_close(mean, mean_p, rtol=1e-6, atol=0)
    assert torch.equal(merged, merged2) and torch.equal(bits, bits2)
    assert float(mean) == float(mean2)
    assert 0 < int(bits.sum()) < k


@pytest.mark.parametrize("k,offset", [(8, 0), (8 * 1001, 0), (2 * 128**3, 0), (8 * 1001, 8),
                                      (24, 8)])
def test_torch_packbits_kernels_bit_equal_at_any_length(cuda_device, k, offset):
    """K8a both ways at K = 8 (one byte), K = 8008 (an odd byte count: an
    8-cell tail), the 2 x 128^3 grid, and with ``offset`` a bitfield 8- but
    not 16-byte aligned and packed bytes at an odd address (8-cell units
    throughout): equal to the plain versions bit for bit, one launch a
    call."""
    rng = np.random.default_rng(k + offset)
    bits = torch.from_numpy(rng.random(k + offset) < 0.4).to(cuda_device)[offset:]
    packed_p = to.packbits(bits, plain=True)
    src = torch.cat([packed_p[:1], packed_p])[1:] if offset else packed_p
    kernels.reset_launch_counts()
    packed = kernels.packbits(bits)
    unpacked = kernels.unpackbits(src)
    torch.cuda.synchronize()
    assert kernels.launch_counts["packbits"] == 1 and kernels.launch_counts["unpackbits"] == 1
    assert torch.equal(packed, packed_p)
    assert torch.equal(unpacked, bits)
    assert torch.equal(unpacked, to.unpackbits(packed_p, plain=True))


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


# K5's four instantiations (input width, hidden layers) at the out widths of
# the default network config's heads: density_net [32]->64->1, color2_net
# [16]->64->64->3 (sigmoid), class_net [32]->64->K (K = 4 here) and
# color1_net [32]->64->16.
MLP_SHAPES = [(i, h, o, act) for i, h in ((32, 1), (32, 2), (16, 1), (16, 2))
              for o, act in ((1, None), (3, "sigmoid"), (4, None), (16, None))]


def _mlp_case(rng, device, in_dim, n_hidden, out_dim, rows=5000):
    dims = [in_dim] + [64] * n_hidden + [out_dim]
    ws = [torch.from_numpy(rng.uniform(-1, 1, size=(a, b)).astype(np.float32) * (6.0 / a) ** 0.5)
          .to(device) for a, b in zip(dims[:-1], dims[1:])]
    x = torch.from_numpy(rng.normal(size=(rows, in_dim)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.normal(size=(rows, out_dim)).astype(np.float32)).to(device)
    return ws, x, g


def _mlp_tol(ref: torch.Tensor, dtype) -> float:
    """Absolute tolerance of K5 against the matmul chain: fp32 sums in
    another order, 1e-5 of the largest value in fp32; under bf16 a value near
    a rounding step may land on the other side (2^-8 of itself) and carry
    that into what follows: 2^-7 of the largest value."""
    return (1e-5 if dtype == torch.float32 else 2.0**-7) * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dim,n_hidden,out_dim,act", MLP_SHAPES)
def test_torch_mlp_kernel_matches_plain(cuda_device, in_dim, n_hidden, out_dim, act, dtype):
    """K5 forward and backward (d x, then d x and every d W; 5000 rows: a
    ragged last tile) against the torch.matmul chain and its autograd.  The
    scalar kernels run in fp32 and the tensor-core kernels under bf16, whose
    backward's d W takes one more launch (the reduction of the per-CTA
    partial sums).  Under bf16 also at row counts that are no multiple of
    the 64-row tile: one row, one short tile, and one row past a tile for
    every CTA slot of a 132-SM card."""
    rows = (5000, 1, 63, 64 * 132 + 5) if dtype == torch.bfloat16 else (5000,)
    for m in rows:
        ws, x, g = _mlp_case(np.random.default_rng(in_dim + out_dim + n_hidden), cuda_device,
                             in_dim, n_hidden, out_dim, rows=m)
        _mlp_kernel_against_plain(ws, x, g, act, dtype)


def _mlp_kernel_against_plain(ws, x, g, act, dtype, launches=1):
    """``launches``: K5 calls a forward (and a backward) makes: one a
    64-column slice of the last layer."""
    from nerfstyle_torch.ops import mlp as tmlp

    for need_dw in (False, True):
        runs = {}
        for plain in (False, True):
            wr = [w.clone().requires_grad_(need_dw) for w in ws]
            xr = x.clone().requires_grad_(True)
            kernels.reset_launch_counts()
            out = tmlp.mlp_apply(wr, xr, act, dtype, plain=plain)
            grads = torch.autograd.grad(out, [xr] + (wr if need_dw else []), g)
            torch.cuda.synchronize()
            runs[plain] = (out.detach(), grads, dict(kernels.launch_counts))
        (out, grads, counts), (out_p, grads_p, counts_p) = runs[False], runs[True]
        assert counts["mlp_forward"] == launches and counts["mlp_backward"] == launches
        assert counts["mlp_dw_reduce"] == launches * int(need_dw and dtype == torch.bfloat16)
        assert not any(counts_p.values())
        assert len(grads) == len(grads_p) == 1 + need_dw * len(ws)
        for got, want in [(out, out_p)] + list(zip(grads, grads_p)):
            assert got.shape == want.shape
            torch.testing.assert_close(got, want, rtol=0, atol=_mlp_tol(want, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dim,n_hidden", [(32, 1), (16, 2)])
def test_torch_mlp_kernel_with_a_head_wider_than_64(cuda_device, in_dim, n_hidden, dtype):
    """A 70-wide last layer (a 70-class head): K5 twice, on columns 0-63 and
    64-69, the hidden layers computed again; forward, d x and every d W
    against the plain chain at K5's tolerances (the hidden layers' d W sum
    the two calls' d W)."""
    ws, x, g = _mlp_case(np.random.default_rng(70 + in_dim), cuda_device, in_dim, n_hidden, 70)
    _mlp_kernel_against_plain(ws, x, g, None, dtype, launches=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_mlp_kernel_with_an_empty_head(cuda_device, dtype):
    """A last layer of width 0 (no classes): [M, 0] with no launch, zero
    gradients for every weight, as the plain chain gives."""
    from nerfstyle_torch.ops import mlp as tmlp

    ws, x, g = _mlp_case(np.random.default_rng(0), cuda_device, 32, 1, 0)
    runs = {}
    for plain in (False, True):
        wr = [w.clone().requires_grad_(True) for w in ws]
        kernels.reset_launch_counts()
        out = tmlp.mlp_apply(wr, x, None, dtype, plain=plain)
        grads = torch.autograd.grad((out * g).sum(), wr)
        torch.cuda.synchronize()
        runs[plain] = (out, grads, dict(kernels.launch_counts))
    (out, grads, counts), (out_p, grads_p, _) = runs[False], runs[True]
    assert out.shape == out_p.shape == (x.shape[0], 0)
    assert not any(counts.values())
    for a, b in zip(grads, grads_p):
        assert a.shape == b.shape and not bool(a.any()) and not bool(b.any())


def test_torch_segment_sum_kernels_at_73_channels(cuda_device):
    """K7 and K7b at 3 + 70 channels (a 70-class head): one launch a
    64-channel slice.  K7 against the float64 sums: rtol 1e-5, atol 1e-6 of
    the largest; K7b's d ch equal to the plain bits, d w within 1e-6 of the
    largest (C products summed in another order), both equal on a second
    call."""
    w, ch, g, offsets = (torch.from_numpy(a).to(cuda_device)
                         for a in sg.layout("style-like", 73))
    kernels.reset_launch_counts()
    got = kernels.segment_sum(w, ch, offsets)
    d_ch, d_w = kernels.segment_sum_backward(w, ch, g, offsets, True)
    d_ch2, d_w2 = kernels.segment_sum_backward(w, ch, g, offsets, True)
    torch.cuda.synchronize()
    assert kernels.launch_counts["segment_sum"] == 2
    assert kernels.launch_counts["segment_sum_backward"] == 4
    want = tc.segment_sum(w.double(), ch.double(), offsets, plain=True)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    p_ch, p_w = tc.segment_sum_backward_plain(w, ch, g, offsets, True)
    assert torch.equal(d_ch, p_ch) and torch.equal(d_ch, d_ch2) and torch.equal(d_w, d_w2)
    torch.testing.assert_close(d_w, p_w, rtol=0, atol=1e-6 * float(p_w.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_field_apply_at_four_features_a_level(cuda_device, dtype):
    """At 4 features a level (8 levels: 32-wide encodings) field_apply
    encodes the two tables on their own, K1 and K2 once each a table, as
    the fused [T, 8] rows are wider than K1 takes: channels and densities
    within K5's tolerance of the plain field, each gradient leaf within
    5e-3 relative L2 (the train step's tolerance)."""
    from nerfstyle_torch.core.types import BBox
    from nerfstyle_torch.models import fields as tf
    from nerfstyle_torch.training.checkpoint import tree_flatten

    grid = th.hashgrid_spec(num_levels=8, level_dim=4, base_resolution=16, per_level_scale=1.5,
                            log2_hashmap_size=12)
    spec = tf.style_field_spec(grid, class_dim=3)
    base = tf.field_init(spec, torch.Generator().manual_seed(0), cuda_device)
    rng = np.random.default_rng(0)
    for k in ("x_density_embedder", "x_color_embedder"):
        base[k] = torch.from_numpy(rng.uniform(-1, 1, tuple(base[k].shape)).astype(
            np.float32)).to(cuda_device)
    pts = torch.from_numpy(rng.uniform(-1, 1, size=(20000, 3)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(20000, 6)).astype(np.float32)).to(cuda_device)
    runs = {}
    for plain in (False, True):
        params = {k: [w.clone().requires_grad_(True) for w in v] if isinstance(v, list)
                  else v.clone().requires_grad_(True) for k, v in base.items()}
        leaves = tree_flatten(params)
        kernels.reset_launch_counts()
        ch, sig = tf.field_apply(spec, params, BBox.from_radius(1.0, cuda_device), pts, dtype,
                                 plain=plain)
        grads = torch.autograd.grad((ch * g).sum() + sig.sum() * 1e-3, leaves)
        torch.cuda.synchronize()
        runs[plain] = (ch.detach(), sig.detach(), grads, dict(kernels.launch_counts))
    (ch, sig, grads, counts), (ch_p, sig_p, grads_p, _) = runs[False], runs[True]
    assert counts["hashgrid_encode"] == 2 and counts["hashgrid_backward"] == 2
    for got, want in ((ch, ch_p), (sig, sig_p)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=_mlp_tol(want, dtype))
    for a, b in zip(grads, grads_p):
        assert float(torch.linalg.vector_norm(a - b)) <= 5e-3 * float(torch.linalg.vector_norm(b))


def test_torch_train_step_without_classes_against_plain(cuda_device, tmp_path, monkeypatch):
    """A small train run on the card on the synthetic scene with its
    segment channel dropped (class_dim 0, as a dataset without seg maps
    gives), then chip_smoke.py's one step with the kernels against the
    plain step: its losses, gradients, Adam moments and updates within
    that check's tolerances."""
    import sys
    from pathlib import Path

    from nerfstyle_torch import train
    from nerfstyle_torch.data import synthetic

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    init = synthetic.SyntheticDataset.__init__

    def without_segments(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.seg_groups, self.num_classes = None, 0

    monkeypatch.setattr(synthetic.SyntheticDataset, "__init__", without_segments)
    synthetic.generate_scene(tmp_path / "scene", num_train=6, num_test=2, h=48, w=64)
    data = tmp_path / "data.yaml"
    data.write_text(f"root_path: {tmp_path / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    trainer = train.main(["--device", "cuda", "--log-dir", str(tmp_path / "recon"), "--data-cfg",
                          str(data), "--num_iterations", "40", "--num_rays_per_batch", "1024",
                          "--pos_enc.n_lvls", "8", "--pos_enc.hashmap_size", "12",
                          "--pos_enc.max_res_coeff", "16", "--grid_size", "32", "--max_steps",
                          "128", "--intervals.test", "0", "--yes"])
    assert trainer.field_spec.class_dim == 0
    assert [tuple(w.shape) for w in trainer.params["class_net"]][-1] == (64, 0)
    fails = []
    chip_smoke.step_vs_plain(trainer, fails)
    assert not fails, fails


@pytest.mark.parametrize("rows", [4096, 670322])
def test_torch_plain_gemm_sums_in_order_of_k(cuda_device, rows, monkeypatch):
    """K5's bf16 kernels take a ReLU mask that could follow the order of the
    fp32 sums from one FMA at a time in order of k (csrc/mlp.cu), because
    that is the plain chain's order: its fp32 GEMM of bf16-exact operands
    (TF32 off) equals that sequential sum bit for bit at these row counts,
    for each hidden layer's K."""
    rng = np.random.default_rng(5)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for k in (16, 32, 64):
        a = torch.from_numpy(rng.normal(size=(rows, k)).astype(np.float32)).to(cuda_device)
        w = torch.from_numpy(rng.uniform(-1, 1, size=(k, 64)).astype(np.float32)).to(cuda_device)
        a, w = a.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
        acc = torch.zeros((rows, 64), device=cuda_device)
        for i in range(k):
            acc = acc + a[:, i:i + 1] * w[i]  # the product is exact: one rounding a step
        assert torch.equal(torch.matmul(a, w), acc)


@pytest.mark.parametrize("in_dim,n_hidden", [(16, 1), (32, 1), (32, 2)])
def test_torch_mlp_relu_mask_follows_the_plain_sums(cuda_device, in_dim, n_hidden):
    """Under bf16 a hidden pre-activation whose exact value is +-2^-26 from
    terms of +-1 takes its sign from the order of the fp32 sums: 1 + 2^-26 - 1
    is 0 one add at a time and 2^-26 in a wider sum.  K5 must take the plain
    chain's sign, or a cotangent flows through a unit the plain chain has
    shut (d x moves by a whole term).  The last hidden layer's units 0-15
    sum such crafted rows (the first 64 of 4096: enough rows that the fp32
    GEMM sums one FMA at a time in order of k); the rest are random.  With
    two hidden layers the first is [I, -I] (exact) and the second gets the
    crafted sums.  The output layer is the identity, so the forward returns
    h_L itself: its ReLU mask equals the plain chain's everywhere and its
    values equal on the crafted rows; d x within _mlp_tol."""
    from nerfstyle_torch.ops import mlp as tmlp

    rng = np.random.default_rng(17)
    rows, crafted, k = 4096, 64, in_dim if n_hidden == 1 else 64
    x = rng.normal(size=(rows, in_dim)).astype(np.float32)
    x[:crafted] = 0.0
    for r in range(crafted):
        k1, k2, k3 = rng.choice(in_dim, size=3, replace=False)
        s = 1.0 if r % 2 else -1.0
        x[r, k1], x[r, k2], x[r, k3] = s, (1.0 if r % 4 < 2 else -1.0) * 2.0**-26, -s
    dims = [in_dim] + [64] * n_hidden
    ws = [(rng.uniform(-1, 1, size=(a, b)) * (6.0 / a) ** 0.5).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    if n_hidden == 2:
        ws[0] = np.concatenate([np.eye(in_dim), -np.eye(in_dim)], axis=1).astype(np.float32)
    ws[-1][:, :16] = np.concatenate([np.ones(k // 2), (1 if n_hidden == 1 else -1) *
                                     np.ones(k // 2)])[:, None]
    ws.append(np.eye(64, dtype=np.float32))
    ws = [torch.from_numpy(w).to(cuda_device) for w in ws]
    x = torch.from_numpy(x).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(rows, 64)).astype(np.float32)).to(cuda_device)
    outs, dxs = [], []
    for plain in (False, True):
        xr = x.clone().requires_grad_(True)
        h = tmlp.mlp_apply(ws, xr, None, torch.bfloat16, plain=plain)
        outs.append(h.detach())
        dxs.append(torch.autograd.grad(h, xr, g)[0])
    (h, h_p), (dx, dx_p) = outs, dxs
    assert torch.equal(h > 0, h_p > 0)
    assert torch.equal(h[:crafted, :16], h_p[:crafted, :16])
    torch.testing.assert_close(dx, dx_p, rtol=0, atol=_mlp_tol(dx_p, torch.bfloat16))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("in_dim,n_hidden,out_dim,act", [(32, 1, 4, None), (32, 1, 16, None),
                                                         (16, 2, 3, "sigmoid")])
def test_torch_mlp_bf16_dx_at_the_style_stream_size(cuda_device, in_dim, n_hidden, out_dim, act,
                                                    seed):
    """The three color heads' shapes at the style stream's 670,322 rows
    under bf16: among ~4 x 10^7 hidden pre-activations a few lie within the
    fp32 sum-order noise of 0, and each one whose ReLU mask differed from the
    plain chain's would move its row's d x by a whole term.  Output and d x
    (frozen weights) within _mlp_tol on every row."""
    from nerfstyle_torch.ops import mlp as tmlp

    ws, x, g = _mlp_case(np.random.default_rng(100 + seed), cuda_device, in_dim, n_hidden,
                         out_dim, rows=670322)
    if seed % 2:
        x = x * 0.3
    res = []
    for plain in (False, True):
        xr = x.clone().requires_grad_(True)
        out = tmlp.mlp_apply(ws, xr, act, torch.bfloat16, plain=plain)
        res.append((out.detach(), torch.autograd.grad(out, xr, g)[0]))
    for got, want in zip(*res):
        torch.testing.assert_close(got, want, rtol=0, atol=_mlp_tol(want, torch.bfloat16))


def test_torch_mlp_kernel_frozen_weights(cuda_device):
    """Frozen weights (the style stage): the backward gives d x only."""
    from nerfstyle_torch.ops import mlp as tmlp

    ws, x, g = _mlp_case(np.random.default_rng(3), cuda_device, 32, 1, 16, rows=300)
    xr = x.clone().requires_grad_(True)
    (tmlp.mlp_apply(ws, xr, None, torch.bfloat16) * g).sum().backward()
    xp = x.clone().requires_grad_(True)
    (tmlp.mlp_apply(ws, xp, None, torch.bfloat16, plain=True) * g).sum().backward()
    assert all(w.grad is None for w in ws)
    torch.testing.assert_close(xr.grad, xp.grad, rtol=0, atol=_mlp_tol(xp.grad, torch.bfloat16))


def test_torch_segment_sum_backward_kernel_matches_plain(cuda_device):
    """K7b: d ch = w * g[ray], one fp32 product: equal bits; d w (when w
    asks for it) sums C products in another order than the plain version:
    1e-6 of the largest."""
    rng = np.random.default_rng(21)
    counts = rng.integers(0, 9, size=500)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])).to(cuda_device)
    s = int(counts.sum())
    w = torch.from_numpy(rng.uniform(0, 1, size=s).astype(np.float32)).to(cuda_device)
    ch = torch.from_numpy(rng.normal(size=(s, 7)).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(500, 7)).astype(np.float32)).to(cuda_device)
    for need_w in (False, True):
        grads = {}
        for plain in (False, True):
            wr, cr = w.clone().requires_grad_(need_w), ch.clone().requires_grad_(True)
            kernels.reset_launch_counts()
            (tc.segment_sum_grad(wr, cr, offsets, plain=plain) * g).sum().backward()
            torch.cuda.synchronize()
            grads[plain] = (cr.grad, wr.grad, kernels.launch_counts["segment_sum_backward"])
        (d_ch, d_w, n_k), (d_ch_p, d_w_p, n_p) = grads[False], grads[True]
        assert (n_k, n_p) == (1, 0)
        torch.testing.assert_close(d_ch, d_ch_p, rtol=0, atol=0)
        if need_w:
            torch.testing.assert_close(d_w, d_w_p, rtol=0, atol=1e-6 * float(d_w_p.abs().max()))
        else:
            assert d_w is None


@pytest.mark.parametrize("channels", [3, 7, 19, 64])
def test_torch_segment_sum_kernel_ragged_segments(cuda_device, channels):
    """K7 on ragged segments: empty rays, 1-sample rays, runs of short
    rays, one ray longer than a staged tile (1024 samples at most) and the
    stream's channel rows starting off a 16-byte boundary.  The kernel sums
    each ray in fp32 in stream order, against the plain version's float64
    sums: rtol 1e-5, atol 1e-6 of the largest output."""
    rng = np.random.default_rng(channels)
    counts = rng.integers(0, 6, size=3000)
    counts[:7] = 0
    counts[7:20] = 1
    counts[1500] = 5000  # one ray walked in several staged pieces
    counts[-1] = 0
    s = int(counts.sum())
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])).to(cuda_device)
    w = torch.from_numpy(rng.uniform(0, 1, size=s).astype(np.float32)).to(cuda_device)
    big = torch.from_numpy(rng.normal(size=(s + 1, channels)).astype(np.float32)).to(cuda_device)
    for ch in (big[:s], big[1:]):  # the second is not 16-byte aligned
        assert ch.is_contiguous()
        kernels.reset_launch_counts()
        got = tc.segment_sum(w, ch, offsets)
        torch.cuda.synchronize()
        assert kernels.launch_counts["segment_sum"] == 1
        want = tc.segment_sum(w.double(), ch.double(), offsets, plain=True)
        assert not bool(got[:7].any())
        torch.testing.assert_close(got.double(), want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("in_dim,n_hidden,out_dim", [(32, 1, 16), (16, 2, 3)])
def test_torch_mlp_backward_bf16_weight_grad_bit_reproducible(cuda_device, in_dim, n_hidden,
                                                              out_dim):
    """Under bf16 each CTA of the persistent grid sums its tiles' d W on
    chip and the reduction adds the partials in CTA order: two launches on
    the same inputs give the same bits.  2^18 rows: several tiles a CTA,
    held against the matmul chain's autograd too.  At this many rows a
    hidden pre-activation may lie within the fp32 sum-order noise of 0 and
    flip its ReLU mask, moving that row's d x by a whole term: at most 1e-4
    of the rows beyond _mlp_tol; d W (summed over every row) within 5e-3
    relative L2."""
    from nerfstyle_torch.ops import mlp as tmlp

    rows = 1 << 18
    ws, x, g = _mlp_case(np.random.default_rng(9), cuda_device, in_dim, n_hidden, out_dim,
                         rows=rows)
    sigmoid = out_dim == 3
    assert kernels.mlp_backward_grid(rows, in_dim, n_hidden, out_dim) < rows // 64
    first = kernels.mlp_backward(x, ws, g, sigmoid, True, [True] * len(ws))
    second = kernels.mlp_backward(x, ws, g, sigmoid, True, [True] * len(ws))
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    for a, b in zip(first[1], second[1]):
        assert a is not None and bool(a.any()) and torch.equal(a, b)
    wr = [w.clone().requires_grad_(True) for w in ws]
    xr = x.clone().requires_grad_(True)
    out = tmlp.mlp_apply(wr, xr, "sigmoid" if sigmoid else None, torch.bfloat16, plain=True)
    dx_p, *dws_p = torch.autograd.grad(out, [xr] + wr, g)
    far = ((first[0] - dx_p).abs() > _mlp_tol(dx_p, torch.bfloat16)).any(dim=1)
    assert int(far.sum()) <= 1e-4 * rows
    for a, b in zip(first[1], dws_p):
        b = b.to(torch.bfloat16).float()
        assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) <= 5e-3


def test_torch_style_step_pinned_against_plain(cuda_device, tmp_path):
    """chip_smoke.py's style-step check on a small style stage on the card:
    the step with the kernels against the step with every plain version,
    the colour-table gradient within 5e-3 relative L2 with every discrete
    choice (class map, nearest style features, VGG16's ReLU masks and
    max-pool picks) pinned to the plain step's, the flips of each kind
    within their bound, the losses within 1e-5; the pinned plain step
    gives the unpinned plain step's losses."""
    import sys
    from pathlib import Path

    from nerfstyle_torch import train, utils
    from nerfstyle_torch.data.synthetic import generate_scene

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    generate_scene(tmp_path / "scene", num_train=6, num_test=2, h=48, w=64)
    data = tmp_path / "data.yaml"
    data.write_text(f"root_path: {tmp_path / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    small = ["--pos_enc.n_lvls", "8", "--pos_enc.hashmap_size", "12", "--pos_enc.max_res_coeff",
             "16", "--grid_size", "32", "--max_steps", "128", "--intervals.test", "0", "--yes"]
    train.main(["--device", "cuda", "--log-dir", str(tmp_path / "recon"), "--data-cfg",
                str(data), "--num_iterations", "40", "--num_rays_per_batch", "256", *small])
    yy, xx = np.meshgrid(np.linspace(0, 1, 40), np.linspace(0, 1, 56), indexing="ij")
    utils.save_image(np.stack([yy, xx, 1 - yy], -1), tmp_path / "style.png")
    np.savez(tmp_path / "seg.npz", seg_map=(yy > .5).astype(int) * 2 + (xx > .5).astype(int))
    st = train.main(["--device", "cuda", "--ckpt", str(tmp_path / "recon" / "iter_40.ckpt"),
                     "--log-dir", str(tmp_path / "style"), "--style-image",
                     str(tmp_path / "style.png"), "--style_seg_path", str(tmp_path / "seg.npz"),
                     "--num_iterations", "2", *small])
    fails = []
    out = chip_smoke.style_step_vs_plain(st, fails)
    assert not fails, fails
    assert out["pinned"] <= 5e-3
    cache = st.geom_cache(next(iter(st._geom_cache)))
    plain = chip_smoke.style_step_run(st, cache, True)
    pinned = chip_smoke.style_step_run(st, cache, True, pin=plain[2])
    assert all(float(pinned[0][k]) == float(v) for k, v in plain[0].items())
