"""CPU tests of the readers of the program's spans (``metrics/*_ms.*.py``):
nothing on a CPU traced run, the median of the last traced pass's roots on
spans with device times, and 0.0 decode ms for calls that ran no decode
step.

    python -m pytest -q bench/tests/test_span_metrics.py
"""

import itertools
import sys
from collections import deque
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import core  # noqa: E402
from bench.tests.test_bench_harness import CELLS, run_tiny  # noqa: E402
from bench.trace import Trace  # noqa: E402
from repro_torch.obs import profile as P  # noqa: E402

READERS = {"forward_ms.train": "train.forward", "backward_ms.train": "train.backward",
           "optimizer_ms.train": "train.optimizer", "decode_ms.serve": "serve.decode_step"}


@pytest.mark.parametrize("cell", CELLS)
def test_readers_find_nothing_on_a_cpu_traced_run(cell):
    result, _, run = run_tiny(cell, trace=True)
    assert run.trace is not None and result["correct"] is True
    for name in READERS:
        assert core.reader(name).read(run) is None, name
        assert name not in result["metrics"]
    # the program did record its spans in the traced passes, without device times
    root = "train.step" if run.entry == "train" else "serve.generate"
    roots = [s for s in P.spans() if s.name == root and s.parent is None]
    assert len(roots) >= 2 * (run.profiled["steps"] if run.entry == "train"
                              else len(run.profiled["lengths"]))
    assert all(s.d0 is None for s in roots)


class Spans:
    """Hand-made finished spans with device intervals, in the order they
    began (ids, host and device times in ns)."""

    def __init__(self):
        self.kept, self.ids, self.t = [], itertools.count(1), 0

    def add(self, name, parent=None, ms=1.0):
        s = P.Span(name)
        s.id = next(self.ids)
        s.parent, s.root = (None, s.id) if parent is None else (parent.id, parent.root)
        s.t0, s.t1 = self.t, self.t + 1000
        s.d0, s.d1 = self.t, self.t + round(ms * 1e6)
        self.t += 10_000_000
        self.kept.append(s)
        return s

    def step(self, fwd, bwd, opt):
        root = self.add("train.step", ms=sum(fwd) + sum(bwd) + opt + 1)
        for f, b in zip(fwd, bwd):
            self.add("train.forward", root, f)
            self.add("train.backward", root, b)
        self.add("train.grad_norm", self.add("train.optimizer", root, opt), 0.5)

    def batch(self, decode_ms):
        root = self.add("serve.generate", ms=100.0)
        self.add("serve.prefill", root, 90.0)
        for ms in decode_ms:
            self.add("serve.decode_step", root, ms)
        self.add("serve.copy_out", root, 0.1)


def _run(entry, **profiled):
    return core.Run(entry=entry, config={}, traffic={}, trace=Trace(), profiled=profiled)


def _read(monkeypatch, spans, name, run):
    monkeypatch.setattr(P, "_buffer", deque(spans.kept))
    return core.reader(name).read(run)


def test_train_readers_take_the_median_of_the_last_pass(monkeypatch):
    s = Spans()
    for _ in range(3):  # the host pass: slower, left out
        s.step([500.0, 500.0], [900.0, 900.0], 800.0)
    s.step([10.0, 12.0], [20.0, 21.0], 30.0)  # two micro-batches a step
    s.step([14.0, 16.0], [26.0, 27.0], 40.0)
    s.step([11.0, 11.0], [30.0, 30.0], 35.0)
    run = _run("train", steps=3)
    assert _read(monkeypatch, s, "forward_ms.train", run) == pytest.approx(22.0)
    assert _read(monkeypatch, s, "backward_ms.train", run) == pytest.approx(53.0)
    assert _read(monkeypatch, s, "optimizer_ms.train", run) == pytest.approx(35.0)
    assert _read(monkeypatch, s, "decode_ms.serve", run) is None  # a train run
    # fewer roots than the pass, or a root without its device interval: nothing
    assert _read(monkeypatch, s, "forward_ms.train", _run("train", steps=7)) is None
    s.kept[-1].d0 = s.kept[-1].d1 = None  # the last step's grad_norm: not a phase read
    assert _read(monkeypatch, s, "optimizer_ms.train", run) == pytest.approx(35.0)
    next(x for x in reversed(s.kept) if x.name == "train.step").d0 = None
    for name in ("forward_ms.train", "backward_ms.train", "optimizer_ms.train"):
        assert _read(monkeypatch, s, name, run) is None


def test_decode_reader_takes_the_median_of_the_last_pass(monkeypatch):
    s = Spans()
    for _ in range(3):  # the host pass
        s.batch([400.0])
    for decode in ([50.0], [61.0, 2.0], [47.0]):
        s.batch(decode)
    run = _run("serve", lengths=[512, 1024, 768], batch=8)
    assert _read(monkeypatch, s, "decode_ms.serve", run) == pytest.approx(50.0)
    assert _read(monkeypatch, s, "forward_ms.train", run) is None  # a serve run
    assert _read(monkeypatch, s, "decode_ms.serve", _run("serve", lengths=[1] * 7)) is None


def test_decode_reader_reads_zero_for_calls_without_a_decode_step(monkeypatch):
    s = Spans()
    s.batch([300.0])
    for _ in range(3):
        s.batch([])
    run = _run("serve", lengths=[512, 1024, 768], batch=8)
    assert _read(monkeypatch, s, "decode_ms.serve", run) == 0.0
    next(x for x in reversed(s.kept) if x.name == "serve.generate").d0 = None
    assert _read(monkeypatch, s, "decode_ms.serve", run) is None  # a call not on a card
