"""Port parity of ``nerfstyle_torch/utils.py``'s helpers (the clock, the
exiting logger, chunked execution, byte sizes, the memory line, colour
names, the loader decorator, ``cycle``, ``rmtree``), of
``core.types.LossValue`` and of the trainers' status printers against the
JAX package's on the same inputs."""

import dataclasses
import io
import logging
import time
import types

import matplotlib.colors as mcolors
import numpy as np
import pytest
import torch

import nerfstyle_torch.core as tcore
from nerfstyle_torch import utils as tutils
from nerfstyle_torch.training.trainer import Trainer
from nerfstyle_tpu import utils as jutils
from nerfstyle_tpu.core import LossValue as JLossValue
from nerfstyle_tpu.training.trainer import Trainer as JTrainer


def _ticks(monkeypatch, values):
    it = iter(values)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def test_torch_clock_matches_jax(monkeypatch):
    """The same clicks at the same clock readings: equal summaries and
    reports; ``global_clock`` is a Clock in both."""
    ticks = [0.0, 0.5, 0.75, 2.0, 2.125, 4.0, 4.0625]
    names = [None, "a", "b", "a", None, "b", "c"]
    out = []
    for mod in (jutils, tutils):
        _ticks(monkeypatch, ticks)
        c = mod.Clock()
        for n in names:
            c.click(n)
        out.append((c.summary(), c.report()))
    assert out[0] == out[1] and out[1][0]["a"]["count"] == 2
    assert isinstance(tutils.global_clock, tutils.Clock)


@pytest.mark.parametrize("exit_on_error", [True, False])
def test_torch_logger_exits_on_error_as_jax(capsys, exit_on_error):
    """``create_logger``: the same coloured lines; with ``exit_on_error``
    (JAX's default) ``logger.error`` ends the process with status 1 through
    an ``ExitHandler``, without it the call returns."""
    lines, codes = [], []
    for mod in (jutils, tutils):
        name = f"helpers-{mod.__name__}-{exit_on_error}"
        logger = mod.create_logger(name, exit_on_error=exit_on_error)
        assert isinstance(logger.handlers[0], mod.ExitHandler) == exit_on_error
        logger.info("step %d", 3)
        logger.debug("hidden")
        try:
            logger.error("bad %s", "input")
            codes.append(None)
        except SystemExit as e:
            codes.append(e.code)
        lines.append(capsys.readouterr().out.replace(name, "NAME"))
    assert lines[0] == lines[1] and "[ERROR] NAME: bad input" in lines[1]
    assert codes == ([1, 1] if exit_on_error else [None, None])


def test_torch_batch_exec_matches_jax():
    """Chunked execution into numpy buffers: one and two outputs, a last
    chunk shorter than ``bsize``, tensor and array results."""
    x = np.random.default_rng(0).normal(size=(37, 3)).astype(np.float32)

    def two(a):
        return a * 2.0, a.sum(-1)

    for fn, wrap in ((two, np.asarray), (lambda a: torch.from_numpy(a) + 1.0, np.asarray)):
        outs = []
        for mod in (jutils, tutils):
            if fn is two:
                bufs = (np.zeros((37, 3), np.float32), np.zeros((37,), np.float32))
            else:
                bufs = (np.zeros((37, 3), np.float32),)
            outs.append(mod.batch_exec(fn, *bufs, bsize=8)(wrap(x)))
        a, b = outs
        for u, v in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("n,unit,prec", [(0, "B", 3), (1023, "KB", 2), (5 << 20, "MB", 3),
                                         (3 << 30, "GB", 1), (123456789, "MB", 0)])
def test_torch_format_bytes_matches_jax(n, unit, prec):
    assert tutils.format_bytes(n, unit, prec) == jutils.format_bytes(n, unit, prec)


def test_torch_print_memory_usage_matches_jax(capsys):
    """On the CPU, which keeps no allocator statistics, both print the line
    with zeros."""
    jutils.print_memory_usage("after step", "KB")
    want = capsys.readouterr().out
    tutils.print_memory_usage("after step", "KB")
    assert capsys.readouterr().out == want == "after step: In use - 0.000KB, Peak - 0.000KB\n"


def _names():
    css = sorted(mcolors.CSS4_COLORS)
    return (css + [c.upper() for c in css[:5]] + ["Red", "DarkSlateGray"]
            + list(mcolors.TABLEAU_COLORS) + list(mcolors.BASE_COLORS)
            + ["#abc", "#ABCD", "#a1b2c3", "#A1B2C3D4", "#000000", "#ffffff"]
            + ["0", "0.25", "1.0", ".5"])


def test_torch_color_str2rgb_matches_jax():
    """Every name the port takes (CSS4 in any case, Tableau, the base
    letters, hex strings of 3, 4, 6 and 8 digits, gray levels) gives JAX's
    (matplotlib's) floats exactly; what neither takes raises."""
    for name in _names():
        assert tutils.color_str2rgb(name) == jutils.color_str2rgb(name), name
    for bad in ("notacolor", "#12", "#ggg", "1.5", "-0.1", "tab:nope"):
        with pytest.raises(ValueError):
            jutils.color_str2rgb(bad)
        with pytest.raises(ValueError):
            tutils.color_str2rgb(bad)


def test_torch_loader_matches_jax(tmp_path, capsys):
    """A reader under ``loader``: its value; a missing path and a failing
    read become FileNotFoundError without a logger, an exiting error line
    with one; the same messages in both."""
    good = tmp_path / "a.npy"
    np.save(good, np.arange(4))
    bad = tmp_path / "b.npy"
    bad.write_bytes(b"not numpy")
    seen = []
    for mod in (jutils, tutils):
        read = mod.loader()(np.load)
        np.testing.assert_array_equal(read(good), np.arange(4))
        msgs = []
        for p in (tmp_path / "missing.npy", bad):
            with pytest.raises(FileNotFoundError) as e:
                read(p)
            msgs.append(str(e.value))
        logged = mod.loader(mod.create_logger(f"loader-{mod.__name__}"))(np.load)
        with pytest.raises(SystemExit):
            logged(tmp_path / "missing.npy")
        msgs.append(capsys.readouterr().out.split(": ", 1)[1])
        seen.append(msgs)
    assert seen[0] == seen[1]


def test_torch_cycle_and_rmtree_match_jax(tmp_path):
    it_j, it_t = jutils.cycle([1, 2, 3]), tutils.cycle([1, 2, 3])
    assert [next(it_j) for _ in range(8)] == [next(it_t) for _ in range(8)]
    for mod in (jutils, tutils):
        root = tmp_path / mod.__name__
        (root / "x" / "y").mkdir(parents=True)
        (root / "x" / "y" / "f.txt").write_text("1")
        (root / "g.txt").write_text("2")
        mod.rmtree(root)
        assert not root.exists()
        (tmp_path / "file.txt").write_text("3")
        mod.rmtree(tmp_path / "file.txt")
        assert not (tmp_path / "file.txt").exists()


def test_torch_loss_value_matches_jax():
    """``LossValue``, exported from ``nerfstyle_torch.core`` as from JAX's:
    the same dataclass fields."""
    assert [f.name for f in dataclasses.fields(tcore.LossValue)] == \
        [f.name for f in dataclasses.fields(JLossValue)]
    assert "LossValue" in tcore.__all__
    assert dataclasses.astuple(tcore.LossValue("MSE", "mse_loss", 0.5)) == \
        dataclasses.astuple(JLossValue("MSE", "mse_loss", 0.5))


class _Writer:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), step))


def _printer(cls, name):
    stream = io.StringIO()
    logger = logging.getLogger(name)
    logger.handlers = [logging.StreamHandler(stream)]
    logger.propagate = False
    logger.setLevel(logging.INFO)
    ns = types.SimpleNamespace(_PRINT_NAMES=cls._PRINT_NAMES, logger=logger, iter_ctr=250,
                               writer=_Writer(), time0=1.0, time1=1.25, iter_ms=[250.0])
    return ns, stream


@pytest.mark.parametrize("keys", [("mse", "psnr", "class", "sparsity", "weight_reg", "total"),
                                  ("content", "style", "total"), ("photo", "other")])
def test_torch_status_printers_match_jax(keys):
    """The same losses through each trainer's ``_to_loss_values``,
    ``print_status`` and ``log_status``: equal records, the same status
    line and the same scalars (``misc/iter_time`` aside: each trainer's own
    clock)."""
    assert Trainer._PRINT_NAMES == JTrainer._PRINT_NAMES
    vals = np.random.default_rng(1).random(len(keys)).astype(np.float32)
    out = []
    for cls, losses in ((JTrainer, {k: np.float32(v) for k, v in zip(keys, vals)}),
                        (Trainer, {k: torch.tensor(v) for k, v in zip(keys, vals)})):
        ns, stream = _printer(cls, f"printer-{cls.__module__}-{keys}")
        lv = cls._to_loss_values(ns, losses)
        cls.print_status(ns, lv)
        cls.print_status(ns, lv, phase="TEST")
        cls.log_status(ns, lv)
        rows = [r for r in ns.writer.rows if r[0] != "misc/iter_time"]
        assert len(rows) == len(ns.writer.rows) - 1
        out.append(([(v.print_name, v.log_name, float(v.value)) for v in lv.values()],
                    stream.getvalue(), rows))
    assert out[0] == out[1]
    assert isinstance(next(iter(cls._to_loss_values(ns, {"mse": 1.0}).values())),
                      tcore.LossValue)
