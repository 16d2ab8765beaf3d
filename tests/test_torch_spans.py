"""The model path's spans (``repro_torch.obs.span``) on the CPU, at tiny
sizes: the off path, the spans a train step and a ``generate`` call record,
their place in a ``torch.profiler`` trace (plain host operations, on the
profiler's clock), how a trace's idle gaps are named by them, and their
export."""

import json
import sys
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.models import DecoderLM
from repro_torch.obs import profile as P
from repro_torch.obs import report
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.training import TrainConfig, init_train_state, make_train_step
from repro_torch.tree import flatten_named

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench import trace as bench_trace  # noqa: E402

TRAIN = ("train.step", "train.forward", "train.backward", "train.optimizer", "train.grad_norm")


@pytest.fixture(autouse=True)
def fresh_spans():
    """Every test starts and ends with spans off and none kept."""
    assert not P._spans_on and not P._live
    P._buffer.clear()
    yield
    obs.stop()
    P._buffer.clear()
    assert not P._live


@pytest.fixture(scope="module")
def tiny():
    model = DecoderLM(get_smoke_config("llama3.2-3b", dtype="float32", n_layers=1))
    return model, model.init(torch.Generator().manual_seed(0))


def _train(model, accum: int = 1, steps: int = 1):
    tcfg = TrainConfig(accum_steps=accum)
    state = init_train_state(model, torch.Generator().manual_seed(1), tcfg)
    step = make_train_step(model, tcfg)
    toks = torch.randint(0, 200, (4, 8), generator=torch.Generator().manual_seed(2))
    for _ in range(steps):
        state, m = step(state, {"tokens": toks, "labels": toks})
    return state, m


def _generate(model, params, new: int):
    eng = ServeEngine(model, params, ServeConfig(batch_slots=2, max_new_tokens=new),
                      device="cpu")
    return eng.generate(np.arange(10, dtype=np.int64).reshape(2, 5))


def test_off_path_records_nothing_and_is_the_shared_no_op(tiny, monkeypatch):
    model, params = tiny
    card = torch.device("cuda")
    assert obs.span("train.step") is P._NULL and obs.span("train.step", card) is P._NULL
    assert not obs.span("serve.generate")

    def refuse(*a, **k):
        raise AssertionError("a CUDA call on the off path")

    for name in ("Event", "synchronize", "current_stream", "current_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    _train(model, accum=2)
    _generate(model, params, 2)
    assert not P._buffer and not P.spans()

    def site():
        with obs.span("train.step", card) as sp:
            if sp:
                sp.attrs["step"] = 1

    site()
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        site()
        site()
        site()
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak == before and after == before  # not a block allocated, even for a while


def test_a_train_step_records_its_phases_in_order(tiny):
    model, _ = tiny
    with obs.observe(spans=True) as sess:
        state, _ = _train(model)
        kept = P.spans()
        assert [s.name for s in kept] == list(TRAIN)
        step, fwd, bwd, opt, norm = kept
        assert step.parent is None and step.root == step.id
        assert all(s.root == step.id for s in kept)
        assert fwd.parent == bwd.parent == opt.parent == step.id and norm.parent == opt.id
        assert step.t0 <= fwd.t0 <= fwd.t1 <= bwd.t0 <= bwd.t1 <= opt.t0 <= norm.t0
        assert norm.t1 <= opt.t1 <= step.t1
        assert step.attrs == {"step": 0, "train.tokens": 32} and fwd.attrs == {"micro": 0}
        assert opt.attrs == {"leaves": len(flatten_named(state["params"]))} and not norm.attrs
        assert all(s.d0 is None and s.device_ms is None for s in kept)  # the CPU: no events
        assert sess.counters == {"train.tokens": 32}

        P._buffer.clear()
        _train(model, accum=2)
        names = [s.name for s in P.spans()]
        assert names == ["train.step", "train.forward", "train.backward", "train.forward",
                         "train.backward", "train.optimizer", "train.grad_norm"]
        assert [s.attrs.get("micro") for s in P.spans()[1:5]] == [0, 0, 1, 1]


@pytest.mark.parametrize("new", [1, 3])
def test_generate_counts_its_decode_steps(tiny, new):
    model, params = tiny
    with obs.observe(spans=True) as sess:
        toks, stats = _generate(model, params, new)
        kept = P.spans()
    assert toks.shape == (2, 5 + new) and stats["decode_steps"] == new
    root = kept[0]
    assert [s.name for s in kept] == (["serve.generate", "serve.prefill"]
                                      + ["serve.decode_step"] * new + ["serve.copy_out"])
    assert root.attrs == {"batch": 2, "slots": 2, "prompt_len": 5, "new_tokens": new,
                          "serve.decode_steps": new, "serve.decode_steps_unused": 1}
    steps = [s for s in kept if s.name == "serve.decode_step"]
    assert [(s.attrs["index"], s.attrs["used"]) for s in steps] == \
        [(i, i < new - 1) for i in range(new)]
    assert all(s.parent == root.id for s in kept[1:])
    assert sess.counters == {"serve.decode_steps": new, "serve.decode_steps_unused": 1}


def _profiled(fn, tries: int = 5):
    """(spans, events, the profile's start in ns) of `fn` under a CPU
    torch.profiler, spans off otherwise; taken again, up to `tries` times,
    where a busy host stalled between a span's clock reading and its event
    by more than the enclosure's 100 µs."""
    for _ in range(tries):
        P._buffer.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        kept = P.spans()
        events = [e for e in prof.events() if e.name in {s.name for s in kept}]
        base = prof.profiler.kineto_results.trace_start_ns()
        gaps = []
        for name in {s.name for s in kept}:
            mine = [s for s in kept if s.name == name]
            theirs = sorted((e for e in events if e.name == name), key=lambda e: e.time_range.start)
            assert len(mine) == len(theirs), name
            for s, e in zip(mine, theirs):
                gaps.append((base + e.time_range.start * 1e3 - s.t0,
                             s.t1 - (base + e.time_range.end * 1e3)))
        if all(max(g) <= 100e3 for g in gaps):
            return kept, events, gaps
    return kept, events, gaps


def test_spans_are_plain_host_operations_on_the_profilers_clock(tiny):
    model, params = tiny
    kept, events, gaps = _profiled(lambda: (_train(model), _generate(model, params, 1)))
    assert {s.name for s in kept} == set(TRAIN) | {"serve.generate", "serve.prefill",
                                                   "serve.decode_step", "serve.copy_out"}
    assert not P._spans_on  # recorded because the profiler was
    for e in events:
        assert e.is_user_annotation is False and str(e.device_type).endswith("CPU")
        assert not e.is_async
    # each span's host interval encloses its event, by at most 100 µs each side
    # (the profiler's clock conversion taken as exact to 2 µs)
    for start, end in gaps:
        assert -2e3 <= start <= 100e3 and -2e3 <= end <= 100e3, gaps


def test_the_benchmark_trace_names_a_gap_by_the_span(tiny):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("serve.generate"):
            x = torch.ones(64) + 1
            time.sleep(0.003)
            x = x * 2
    device, host = bench_trace._split(prof.events())
    assert not device and ("serve.generate" in {name for _, name in host})
    add, mul = (next(e for e in prof.events() if e.name == n) for n in ("aten::add", "aten::mul"))
    # the card's work at the two operations' times: its gap lies inside the span alone
    card = [((add.time_range.start, add.time_range.end), "k_add"),
            ((mul.time_range.start, mul.time_range.end), "k_mul")]
    gaps = bench_trace.name_gaps(card, host)
    assert [name for name, _ in gaps] == ["serve.generate"]
    assert gaps[0][1] == pytest.approx((mul.time_range.start - add.time_range.end) * 1e-6)


def test_export_passes_validation(tiny, tmp_path):
    model, params = tiny
    with obs.observe(spans=True) as sess:
        _train(model, accum=2, steps=2)
        _generate(model, params, 3)
        sess.export_spans(str(tmp_path / "spans.json"))
    doc = report.load_trace(str(tmp_path / "spans.json"))
    assert report.validate(doc) == []
    names = report.span_names(doc)
    assert names["train.step"] == 2 and names["train.forward"] == 4
    assert names["serve.decode_step"] == 3
    top = dict((n, c) for n, _, c in report.top_self_time(doc, 20))
    assert top["train.backward"] == 4 and top["serve.generate"] == 1
    assert report.thread_names(doc) == {(4, 1): "model path"}
    root = next(e for e in report.spans(doc) if e["name"] == "serve.generate")
    assert root["args"]["serve.decode_steps"] == 3 and root["args"]["parent"] is None
    json.dumps(doc)
