"""Wall-clock profiling hooks: the simulator's phase accumulators, and spans
on the model path.

``profile(name)`` is sprinkled around the hot harness phases (backend apply,
log decode, wave build).  Disabled — the default — it returns a shared no-op
context manager, so the cost at a call site is one module-global read and
two trivial ``__enter__``/``__exit__`` calls.  Enabled (``--metrics`` runs),
each site accumulates total seconds and call count into a module table that
the metrics export snapshots.

``span(name, device)`` is the timed, nested, device-aware form of the same
hook, at the model path's phase boundaries: the train step's forward,
backward and optimizer, the engine's prefill and decode steps.  Spans
record while an ``obs`` session asks for them (``obs.observe(spans=True)``)
or while a ``torch.profiler`` is recording; otherwise ``span`` returns the
same shared no-op as ``profile``, for one global read and one read of the
profiler's state: no allocation, no CUDA event, no synchronise.

A recorded span holds its name and attributes, its id, its parent's and its
root's (the outermost span open when it began: a train step, a ``generate``
call), and its host start and end from ``time.time_ns()``, the clock that
``torch.profiler`` puts its events on.  While a profiler records, a span
also enters the profiler's host timeline as a plain operation of its name
(``_RecordFunctionFast``; ``record_function`` would add a mirror of the
range on the card's timeline, which reads as card work), so the trace puts
each idle gap of the card that no operation covers down to the innermost
span.  On a CUDA device a span records a timing event at entry and at exit
on the current stream, from a pool.  The events are resolved when the spans
are read (``spans()``), never inside a span, and put on the host clock by
the recording's anchor: a synchronise, an event and a ``time_ns()`` reading
taken when recording starts (and again once the anchor is ``ANCHOR_S``
old), never while spans are off.  A span's device interval is then its
time on the card, on the clock of its host interval and of the profiler's
kernels.

The last ``SPAN_LIMIT`` spans are kept in memory; ``to_tracer`` exports
them through a ``Tracer`` as trace_event "X" events.  Spans nest on one
thread, the model path's.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import torch
import torch.autograd.profiler as _torch_profiler

SPAN_LIMIT = 1 << 14  # spans kept; the oldest go first
ANCHOR_S = 60.0       # seconds an anchor serves before the next span takes another

_enabled = False
_acc: Dict[str, List[float]] = {}  # name -> [seconds, calls]


class _NullCtx:
    __slots__ = ()

    # static, so that a with statement binds no method object: the off
    # path allocates nothing
    @staticmethod
    def __enter__():
        return _NULL

    @staticmethod
    def __exit__(exc_type, exc, tb):
        return False

    def __bool__(self):  # a site sets a span's attrs only where it records
        return False


_NULL = _NullCtx()


class _Timer:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        cell = _acc.get(self.name)
        if cell is None:
            _acc[self.name] = [dt, 1]
        else:
            cell[0] += dt
            cell[1] += 1
        return False


def profile(name: str):
    """Context manager timing the enclosed region under ``name`` when
    profiling is enabled; a shared no-op otherwise."""
    return _Timer(name) if _enabled else _NULL


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    _acc.clear()


def snapshot() -> Dict[str, Dict[str, float]]:
    return {k: {"seconds": v[0], "calls": int(v[1])} for k, v in sorted(_acc.items())}


# ------------------------------------------------------------------ spans
_spans_on = False                 # an obs session asks for spans
_buffer: Deque["Span"] = deque()  # recorded spans, in the order they began
_live: List["Span"] = []          # the open spans, outermost first
_ids = itertools.count(1)
_pool: Dict[int, List[Any]] = {}  # free timing events, by device index
_anchors: Dict[int, "_Anchor"] = {}


class _Anchor:
    """A timing event and the host clock's reading when the card reached it."""
    __slots__ = ("event", "ns", "at")

    def __init__(self, index: int):
        torch.cuda.synchronize(index)
        stream = torch.cuda.current_stream(index)
        best = None
        for _ in range(3):  # the try whose synchronise returned soonest, at its middle
            ev = torch.cuda.Event(enable_timing=True)
            h0 = time.time_ns()
            ev.record(stream)
            ev.synchronize()
            h1 = time.time_ns()
            if best is None or h1 - h0 < best[2]:
                best = (ev, (h0 + h1) // 2, h1 - h0)
        self.event, self.ns, self.at = best[0], best[1], time.monotonic()


class Span:
    """One recorded span.  ``t0``, ``t1``: host ns (``time.time_ns()``);
    ``d0``, ``d1``: the card's start and end on the same clock, None until
    ``spans()`` resolves them or where the span ran on no CUDA device."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "t0", "t1", "d0", "d1",
                 "device", "_index", "_events", "_anchor", "_rf")

    def __init__(self, name: str, device=None):
        if isinstance(device, torch.Tensor):
            device = device.device
        self.name = name
        self.attrs: Dict[str, Any] = {}  # a tensor value is read when the spans are read
        self.device = None if device is None else torch.device(device)
        self.id = self.parent = self.root = None
        self.t0 = self.t1 = self.d0 = self.d1 = None
        self._events = self._anchor = self._rf = None

    @property
    def device_ms(self) -> Optional[float]:
        return None if self.d0 is None else (self.d1 - self.d0) / 1e6

    def __enter__(self):
        parent = _live[-1] if _live else None
        if self.device is None and parent is not None:
            self.device = parent.device
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        cuda = self.device is not None and self.device.type == "cuda"
        if cuda:
            i = self.device.index
            self._index = torch.cuda.current_device() if i is None else i
            a = _anchors.get(self._index)
            if a is None or time.monotonic() - a.at > ANCHOR_S:
                a = _anchors[self._index] = _Anchor(self._index)
            self._anchor = a
        self.t0 = time.time_ns()
        if _torch_profiler._is_profiler_enabled:
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        if cuda:
            free = _pool.setdefault(self._index, [])
            self._events = [free.pop() if free else torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
            self._events[0].record(torch.cuda.current_stream(self._index))
        if len(_buffer) >= SPAN_LIMIT:
            _release(_buffer.popleft())
        _buffer.append(self)
        _live.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._index))
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self.t1 = time.time_ns()
        _live.pop()
        return False


def _release(s: Span) -> None:
    """A finished span's timing events back to the pool."""
    if s._events is not None and s.t1 is not None:
        _pool[s._index].extend(s._events)
        s._events = s._anchor = None


def span(name: str, device=None):
    """A span of the enclosed region, named `name`, where spans record (an
    obs session's ``spans=True`` or a recording ``torch.profiler``); the
    shared no-op otherwise.  `device`: where its work runs, a device or a
    tensor on it (a CUDA device adds the span's device interval); None
    takes the enclosing span's."""
    if _spans_on or _torch_profiler._is_profiler_enabled:
        return Span(name, device)
    return _NULL


def note(name: str, n: float = 1) -> None:
    """Adds `n` to the count `name` of the open root span, if any."""
    if _live:
        attrs = _live[0].attrs
        attrs[name] = attrs.get(name, 0) + n


def spans_on() -> None:
    """Spans record from here on, into an emptied buffer, on a new anchor."""
    global _spans_on
    _buffer.clear()
    _anchors.clear()
    _spans_on = True


def spans_off() -> None:
    global _spans_on
    _spans_on = False


def spans() -> List[Span]:
    """The finished spans kept, in the order they began, with their device
    intervals and tensor attributes resolved (waiting for the card where a
    span's events are still pending).  Read them outside any span."""
    done = [s for s in _buffer if s.t1 is not None]
    for s in done:
        if s._events is not None:
            ev0, ev1 = s._events
            ev1.synchronize()
            s.d0 = s._anchor.ns + round(s._anchor.event.elapsed_time(ev0) * 1e6)
            s.d1 = s.d0 + round(ev0.elapsed_time(ev1) * 1e6)
            _release(s)
        for k, v in s.attrs.items():
            if isinstance(v, torch.Tensor):
                s.attrs[k] = v.item()
    return done


def phase_ms(root: str, name: str, last: int) -> Optional[List[float]]:
    """For each of the last `last` finished root spans named `root`, the
    device ms of its `name` spans, summed (0.0 where it ran none); None
    where fewer such roots were kept or one of them, or of their `name`
    spans, has no device interval."""
    done = spans()
    roots = [s for s in done if s.parent is None and s.name == root][-last:]
    if last < 1 or len(roots) < last or any(r.d0 is None for r in roots):
        return None
    at = {r.id: i for i, r in enumerate(roots)}
    out = [0.0] * len(roots)
    for s in done:
        i = at.get(s.root)
        if i is not None and s.name == name and s.parent is not None:
            if s.d0 is None:
                return None
            out[i] += s.device_ms
    return out


def to_tracer(tracer) -> None:
    """Emits the kept spans into `tracer` as complete events on one
    ``model`` track, host times from the first span's start; each event's
    args hold the span's attributes, its id, parent and root, and, where
    resolved, its device ms and device start (µs on the same axis)."""
    kept = spans()
    if not kept:
        return
    track = tracer.track("model path", kind="model")
    base = kept[0].t0
    for s in kept:
        args = dict(s.attrs, id=s.id, parent=s.parent, root=s.root)
        if s.d0 is not None:
            args.update(device_ms=s.device_ms, device_start_us=(s.d0 - base) / 1e3)
        tracer.span(track, s.name, s.t0 - base, s.t1 - base, args)
