"""Sim-time span tracer with Chrome/Perfetto ``trace_event`` JSON export.

Tracks map to Chrome's (pid, tid) plane: one *process* per track kind
(front-ends, blades/links, cluster control) and one *thread* per simulated
node — so Perfetto renders one lane per front-end, one per blade link, and
one for cluster-level control events.

All spans are emitted as complete events ("ph":"X") at their *end*: the
instrumentation records the start clock, runs the instrumented region, then
emits (t0, t1) in one call.  Simulated time is single-threaded per clock, so
regions on one track strictly nest or are disjoint — there is no begin/end
pairing to get wrong.  Timestamps are sim-time nanoseconds converted to the
microseconds Chrome expects at emission.

Benchmarks that rewind clocks between panels (``clock.now = 0``) call
``rebase()`` first: every later timestamp is shifted past the maximum
already emitted, so reused tracks never travel back in time.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

# process ids per track kind (Chrome groups threads under processes)
_PIDS = {"frontend": 1, "blade": 2, "cluster": 3}
_PID_NAMES = {1: "front-ends", 2: "blades", 3: "cluster"}


class Track:
    """One timeline lane: a (pid, tid) pair plus its display name."""

    __slots__ = ("name", "pid", "tid")

    def __init__(self, name: str, pid: int, tid: int):
        self.name = name
        self.pid = pid
        self.tid = tid


class Tracer:
    def __init__(self) -> None:
        # events are stored raw (ns) and formatted only at export
        self._spans: List[Tuple[Track, str, float, float, Optional[dict]]] = []
        self._instants: List[Tuple[Track, str, float, Optional[dict]]] = []
        self._counters: List[Tuple[Track, str, float, object]] = []
        self._tracks: List[Track] = []
        self._names: Dict[str, int] = {}  # base name -> instances seen
        self._next_tid: Dict[int, int] = {}
        self._offset = 0.0  # ns added to every raw timestamp (see rebase)
        self._max_ts = 0.0  # highest shifted ns emitted so far

    # ------------------------------------------------------------- tracks
    def track(self, name: str, kind: str = "frontend") -> Track:
        """Register a timeline lane.  A name already in use gets a ``~N``
        suffix — fresh FrontEnd instances bound to the same (fe, blade)
        coordinates each get their own lane rather than interleaving."""
        seen = self._names.get(name, 0)
        self._names[name] = seen + 1
        if seen:
            name = f"{name}~{seen + 1}"
        pid = _PIDS.get(kind, _PIDS["cluster"])
        tid = self._next_tid.get(pid, 1)
        self._next_tid[pid] = tid + 1
        t = Track(name, pid, tid)
        self._tracks.append(t)
        return t

    def attach_link(self, link, name: str) -> None:
        """Give a ``Link`` a blade-kind track; its ``transfer()`` then emits
        one utilization counter sample per completed epoch.  Idempotent per
        link object."""
        if getattr(link, "_trace", None) is None:
            link._trace_track = self.track(name, kind="blade")
            link._trace = self

    # ------------------------------------------------------------ emission
    def span(self, track: Track, name: str, t0_ns: float, t1_ns: float,
             args: Optional[dict] = None) -> None:
        t0 = t0_ns + self._offset
        t1 = t1_ns + self._offset
        if t1 > self._max_ts:
            self._max_ts = t1
        self._spans.append((track, name, t0, t1, args))

    def instant(self, track: Track, name: str, ts_ns: Optional[float] = None,
                args: Optional[dict] = None) -> None:
        """Zero-duration marker.  ``ts_ns=None`` stamps it at the trace's
        current high-water mark (for events with no driving sim clock)."""
        ts = self._max_ts if ts_ns is None else ts_ns + self._offset
        if ts > self._max_ts:
            self._max_ts = ts
        self._instants.append((track, name, ts, args))

    def counter(self, track: Track, name: str, ts_ns: float, value) -> None:
        """Counter sample; ``value`` is a number or a {series: number} dict."""
        ts = ts_ns + self._offset
        if ts > self._max_ts:
            self._max_ts = ts
        self._counters.append((track, name, ts, value))

    def rebase(self) -> None:
        """Shift the zero point past everything emitted so far.  Call before
        rewinding sim clocks so reused tracks stay monotonic."""
        self._offset = self._max_ts + 1000.0

    # -------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        ev: List[dict] = []
        pids = set()
        for t in self._tracks:
            pids.add(t.pid)
            ev.append({"ph": "M", "name": "thread_name", "pid": t.pid,
                       "tid": t.tid, "args": {"name": t.name}})
        for pid in sorted(pids):
            ev.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "args": {"name": _PID_NAMES.get(pid, f"pid{pid}")}})
        for tr, name, t0, t1, args in self._spans:
            e = {"ph": "X", "name": name, "pid": tr.pid, "tid": tr.tid,
                 "ts": t0 / 1000.0, "dur": (t1 - t0) / 1000.0}
            if args:
                e["args"] = args
            ev.append(e)
        for tr, name, ts, args in self._instants:
            e = {"ph": "i", "name": name, "pid": tr.pid, "tid": tr.tid,
                 "ts": ts / 1000.0, "s": "t"}
            if args:
                e["args"] = args
            ev.append(e)
        for tr, name, ts, value in self._counters:
            args = value if isinstance(value, dict) else {"value": value}
            ev.append({"ph": "C", "name": name, "pid": tr.pid, "tid": tr.tid,
                       "ts": ts / 1000.0, "args": args})
        return {"traceEvents": ev, "displayTimeUnit": "ns"}

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    @property
    def n_events(self) -> int:
        return len(self._spans) + len(self._instants) + len(self._counters)
