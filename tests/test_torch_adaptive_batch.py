"""Adaptive ray batching (``--adaptive_batch``: a fixed sample budget a step,
the ray count on a ladder of powers of two) in the port's trainer against
the JAX package's, on the CPU.

* Decision parity: scripted ``(mean_count, last_num_rays, local_step)``
  sequences go through JAX's ``Trainer._retune_adaptive_rays`` and the
  port's; after every retune the count, the device ``mean_count``, its host
  copy, the last ray count and the growth streak are equal, and both warn or
  neither.  The sequences: a monotone decay (growth debounced), a spike
  (shrink at once), a count pinned at the minimum (the warning), and the
  ladder and starting count at 1, 3 and 4 ranks.  The JAX trainers are
  built and never stepped (JAX's own tests/test_adaptive_batch.py steps its
  trainer for minutes and is slow-only).
* A short CPU run of the port's trainer under ``--adaptive_batch`` at the
  sizes of JAX's test: the count keeps 1.25 x the demand within the budget
  above the ladder's minimum, ``rays_trained`` is the sum of the steps'
  counts, the count moves, and the field learns.
* Checkpoints carry ``trainer_static.adaptive_rays`` both ways: a run
  resumes at the largest rung not above the saved count.
"""

import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstyle_tpu.config import BaseConfig as JBaseConfig
from nerfstyle_tpu.data.synthetic import generate_scene
from nerfstyle_tpu.parallel import mesh as jmesh
from nerfstyle_tpu.training import trainer as jtrainer
from nerfstyle_torch.config import BaseConfig
from nerfstyle_torch.training.trainer import Trainer

# JAX's tests/test_adaptive_batch.py trainer, less its ray count and budget.
TINY = [
    "--num_iterations", "60",
    "--pos_enc.n_lvls", "4",
    "--pos_enc.hashmap_size", "12",
    "--pos_enc.max_res_coeff", "16",
    "--grid_size", "32",
    "--max_steps", "128",
    "--update_thres", "4",
    "--update_iter", "4",
    "--max_eval_count", "1",
    "--intervals.print", "0",
    "--intervals.log", "0",
    "--intervals.test", "0",
    "--intervals.ckpt", "0",
    "--enable_amp",
    "--adaptive_batch",
]
# (ranks, num_rays_per_batch, adaptive_batch_max_rays, adaptive_batch_budget)
SMALL = (1, 256, 2048, 65536)
THREE = (3, 768, 32768, 786432)
FOUR = (4, 100, 2048, 0)
# The demand a ray at each retune of a monotone decay, then a spike.
DECAY = (400, 300, 200, 150, 100, 80, 60, 50, 40, 35, 30, 25, 20, 20, 18, 16)
SPIKE = (16, 300, 300, 16)


def _nargs(case):
    _, rays, max_rays, budget = case
    return [*TINY, "--num_rays_per_batch", str(rays), "--adaptive_batch_max_rays",
            str(max_rays), "--adaptive_batch_budget", str(budget)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for the module: beside the other busy test
    workers, its threads contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("adaptive_scene")
    generate_scene(root / "scene", num_train=6, num_test=2, h=48, w=64)
    data_cfg = root / "data.yaml"
    data_cfg.write_text(f"root_path: {root / 'scene'}\ntype: Synthetic\nbound: 2.0\nscale: 1.0\n")
    yield root, data_cfg
    shutil.rmtree(root, ignore_errors=True)


def jax_trainer(log_dir, data_cfg, nargs, ranks: int, ckpt=None):
    """JAX's trainer on a mesh of ``ranks`` of the CPU devices (none at 1)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "device_count", lambda: ranks)
        mp.setattr(jtrainer, "make_mesh", lambda: jmesh.make_mesh(ranks))
        return jtrainer.Trainer(JBaseConfig(log_dir=log_dir, data_cfg=data_cfg, ckpt=ckpt,
                                            yes=True), list(nargs))


def port_trainer(log_dir, data_cfg, nargs, ckpt=None):
    return Trainer(BaseConfig(log_dir=log_dir, data_cfg=data_cfg, ckpt=ckpt, yes=True),
                   list(nargs), "cpu")


@pytest.fixture(scope="module")
def pairs(scene):
    """{case: (JAX trainer, port trainer)} for the 1-, 3- and 4-rank cases;
    the port's controller set up at the case's ranks."""
    root, data_cfg = scene
    out = {}
    for case in (SMALL, THREE, FOUR):
        ranks = case[0]
        jt = jax_trainer(root / f"jax_{ranks}", data_cfg, _nargs(case), ranks)
        pt = port_trainer(root / f"port_{ranks}", data_cfg, _nargs(case))
        pt._init_adaptive_batch(ranks)
        out[case] = (jt, pt)
    return out


def _restart(jt, pt) -> None:
    """Both controllers back at their starting count, no streak, and the
    grid's demand estimate unset."""
    for t in (jt, pt):
        t._adaptive_rays = min(max(t._ray_ladder[0], t.train_cfg.num_rays_per_batch),
                               t._ray_ladder[-1])
        t._ray_grow_streak = t._ray_grow_cand = 0
        t.renderer._mean_count_host = 0


def _state(t) -> dict:
    r = t.renderer
    return {"rays": t._adaptive_rays, "mean_count": int(np.asarray(r.occ_state.mean_count)),
            "host": r._mean_count_host, "last_num_rays": r._last_num_rays,
            "streak": t._ray_grow_streak, "cand": t._ray_grow_cand}


def retune_both(jt, pt, mean_count: int, last_num_rays: int, local_step: int):
    """One retune in each package from the same scripted state (the device
    mean_count, the count it was measured at, the local step); the host copy
    is taken as each package takes it after an occupancy update.  Returns
    (the states after it, each package's warnings)."""
    jr, pr = jt.renderer, pt.renderer
    jr.occ_state = jr.occ_state._replace(mean_count=jnp.asarray(mean_count, jnp.int32))
    jr._mean_count_host = int(jr.occ_state.mean_count)
    pr.occ_state = pr.occ_state._replace(mean_count=torch.tensor(mean_count, dtype=torch.int32))
    pr.sync_demand()
    said = []
    for t in (jt, pt):
        t.renderer._last_num_rays, t.renderer._local_step_host = last_num_rays, local_step
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t._retune_adaptive_rays()
        said.append([str(w.message) for w in caught if "adaptive_batch pinned" in str(w.message)])
    return (_state(jt), _state(pt)), said


def wanted(t, demand: float) -> int:
    """The rung a demand a ray wants: the largest under budget / (1.25 x
    demand), else the smallest."""
    return t._rung_at_most(int(t._adaptive_budget / (1.25 * max(demand, 1.0))))


def run_demands(jt, pt, demands, local_step: int = 100):
    """Retune both at each demand a ray, the mean count measured at the
    current count (odd, so that the float32 rescale rounds); asserts equal
    states after each; returns the counts."""
    counts = []
    for i, d in enumerate(demands):
        cur = pt._adaptive_rays
        assert jt._adaptive_rays == cur
        (js, ps), said = retune_both(jt, pt, int(d * cur) | 1, cur, local_step + i)
        assert ps == js, (i, d)
        assert len(said[0]) == len(said[1])
        counts.append(ps["rays"])
    return counts


@pytest.mark.parametrize("case", [SMALL, THREE, FOUR], ids=["1rank", "3ranks", "4ranks"])
def test_torch_adaptive_ladder_and_start_match_jax(pairs, case):
    """The budget, ladder (rungs rounded up to a multiple of the ranks) and
    starting count (the ray count clamped to the ladder, not snapped)."""
    jt, pt = pairs[case]
    assert pt._adaptive_budget == jt._adaptive_budget
    assert pt._ray_ladder == jt._ray_ladder
    assert pt._adaptive_rays == jt._adaptive_rays
    assert all(v % case[0] == 0 for v in pt._ray_ladder)
    want_start = {SMALL: 256, THREE: 768, FOUR: 256}[case]
    assert pt._adaptive_rays == want_start
    if case is THREE:
        assert pt._ray_ladder[:3] == (258, 513, 1026) and want_start not in pt._ray_ladder


def test_torch_adaptive_budget_must_divide_the_ranks(scene, tmp_path):
    """A budget the ranks do not divide raises in both, with JAX's words."""
    _, data_cfg = scene
    nargs = _nargs((3, 768, 32768, 0))
    with pytest.raises(ValueError) as want:
        jax_trainer(tmp_path / "jax", data_cfg, nargs, 3)
    pt = port_trainer(tmp_path / "port", data_cfg, nargs)
    with pytest.raises(ValueError) as got:
        pt._init_adaptive_batch(3)
    assert str(got.value) == str(want.value)
    assert "1048576" in str(got.value)


@pytest.mark.parametrize("case", [SMALL, THREE], ids=["1rank", "3ranks"])
def test_torch_adaptive_decay_grows_debounced(pairs, case):
    """A monotone decay of the demand: equal states after every retune; the
    count grows, and only on the second retune in a row that wants the same
    rung."""
    jt, pt = pairs[case]
    _restart(jt, pt)
    ladder = pt._ray_ladder
    counts = run_demands(jt, pt, DECAY)
    start = min(max(ladder[0], case[1]), ladder[-1])
    assert counts[-1] > start
    want = [wanted(pt, d) for d in DECAY]
    prev = start
    for i, c in enumerate(counts):
        if c > prev:  # a growth: this retune and the one before wanted it
            assert i > 0 and want[i] == want[i - 1] == c, (i, counts, want)
        prev = c


@pytest.mark.parametrize("case", [SMALL, THREE], ids=["1rank", "3ranks"])
def test_torch_adaptive_flicker_resets_the_streak(pairs, case):
    """A retune that wants the current rung between two that want a larger
    one resets the streak: the count grows only at the second of two in a
    row."""
    jt, pt = pairs[case]
    _restart(jt, pt)
    cur = pt._ray_ladder[1]
    for t in (jt, pt):
        t._adaptive_rays = cur
    same, more = (pt._adaptive_budget / (1.25 * cur * f) for f in (1.2, 2.5))
    assert wanted(pt, same) == cur and wanted(pt, more) == pt._ray_ladder[2]
    counts = run_demands(jt, pt, (more, same, more, more))
    assert counts == [cur, cur, cur, pt._ray_ladder[2]]


@pytest.mark.parametrize("case", [SMALL, THREE], ids=["1rank", "3ranks"])
def test_torch_adaptive_spike_shrinks_at_once(pairs, case):
    """After the decay, a spike to 300 samples a ray: the count falls to
    the rung the spike wants in that one retune, and the demand falling
    back grows it only at the second retune."""
    jt, pt = pairs[case]
    _restart(jt, pt)
    run_demands(jt, pt, DECAY)
    top = pt._adaptive_rays
    low = wanted(pt, 300)
    assert low < top
    counts = run_demands(jt, pt, SPIKE)
    assert counts == [top, low, low, low]
    assert run_demands(jt, pt, [16]) == [top]


def test_torch_adaptive_large_mean_count_rescales_in_float32(pairs):
    """A mean count above 2^24 (not exact in float32), shrunk from the top
    rung: the float32 rescale of the device copy and the float64 one of the
    host copy equal JAX's."""
    jt, pt = pairs[SMALL]
    _restart(jt, pt)
    for t in (jt, pt):
        t._adaptive_rays = 2048
    (js, ps), _ = retune_both(jt, pt, 2**24 + 15, 2048, 100)
    assert ps == js and ps["rays"] == 256
    # float32(2^24 + 15) is 2^24 + 16: the device copy rounds up past the
    # host's (2^24 + 15) / 8.
    assert ps["mean_count"] == 2**21 + 2 and ps["host"] == 2**21 + 1


def test_torch_adaptive_pinned_at_the_minimum_warns(pairs):
    """At the ladder's minimum with demand x 1.25 x count above the budget:
    both warn once the local step is past update_thres, neither before."""
    jt, pt = pairs[SMALL]
    _restart(jt, pt)
    early = pt.renderer.settings.update_thres
    (js, ps), said = retune_both(jt, pt, 300 * 256, 256, early)
    assert ps == js and said == [[], []]
    (js, ps), said = retune_both(jt, pt, 300 * 256, 256, early + 1)
    assert ps == js and ps["rays"] == 256
    assert len(said[0]) == len(said[1]) == 1
    head = said[0][0].split(";")[0]
    assert head.endswith("(96000 > budget 65536)") and said[1][0].startswith(head)


def test_torch_adaptive_short_run_tracks_demand(scene, tmp_path):
    """40 steps of the port's trainer at JAX's test's budget (32768) and
    ceiling (1024): above the ladder's minimum the count keeps 1.25 x the
    demand within the budget (5% slack, as JAX's test), ``rays_trained``
    is the sum of the steps' counts, at least two rungs are seen, and the
    held-out PSNR passes 10 dB."""
    _, data_cfg = scene
    t = port_trainer(tmp_path / "run", data_cfg, _nargs((1, 256, 1024, 32768)))
    seen = set()
    for _ in range(40):
        t.run_iter()
        rays = t.iter_rays[-1]
        seen.add(rays)
        r = t.renderer
        if r._mean_count_host > 0 and t._adaptive_rays > t._ray_ladder[0]:
            demand = r._mean_count_host / max(1, r._last_num_rays)
            assert demand * 1.25 * t._adaptive_rays <= t._adaptive_budget * 1.05
    assert t.rays_trained == sum(t.iter_rays) and len(t.iter_rays) == 40
    assert len(seen) >= 2 and seen <= set(t._ray_ladder), seen  # the start, 256, is a rung
    assert t.test_networks()["psnr"] > 10.0


def test_torch_adaptive_rays_resume_across_packages(pairs, scene, tmp_path):
    """A JAX checkpoint with ``adaptive_rays`` 2048 resumes in the port at
    2048, and 3000 (no rung) at 2048; a port checkpoint at 2048 resumes in
    JAX at 2048; a checkpoint without it starts at the starting count."""
    _, data_cfg = scene
    jt, pt = pairs[SMALL]
    nargs = _nargs(SMALL)
    saved = {}
    for rays in (2048, 3000):
        jt._adaptive_rays = rays
        jt.save_ckpt()
        saved[rays] = tmp_path / f"jax_{rays}.ckpt"
        shutil.copy(next(jt.log_dir.glob("iter_*.ckpt")), saved[rays])
    _restart(jt, pt)
    for rays in (2048, 3000):
        got = port_trainer(tmp_path / f"port_resume_{rays}", data_cfg, nargs, ckpt=saved[rays])
        assert got._adaptive_rays == 2048, rays

    pt._adaptive_rays = 2048
    port_ckpt = pt.save_ckpt()
    _restart(jt, pt)
    back = jax_trainer(tmp_path / "jax_resume", data_cfg, nargs, 1, ckpt=port_ckpt)
    assert back._adaptive_rays == 2048

    fixed = port_trainer(tmp_path / "fixed", data_cfg,
                         [a for a in nargs if a != "--adaptive_batch"])
    assert not fixed.train_cfg.adaptive_batch
    plain_ckpt = fixed.save_ckpt()
    started = port_trainer(tmp_path / "from_fixed", data_cfg, nargs, ckpt=plain_ckpt)
    assert started._adaptive_rays == 256
