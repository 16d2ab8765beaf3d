"""The traced sub-window: torch.profiler over a few steady steps or
batches after the measured window, reduced in memory to what the
per-layer readers and the result line need (no chrome trace is written).

``busy_s`` is the union of the intervals in which an operation ran on the
card; ``window_s`` the span from the first such operation to the last,
on the same clock.  Each idle gap is put down to the innermost host
operation that was running at its middle (the harness's own
``record_function`` labels included), and the gaps are summed by that
name.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

TOP = 10  # entries of each breakdown list
NAME_CHARS = 160  # a kernel's name is cut to this many characters
LABEL = "bench."  # the harness's own record_function ranges


class Trace:
    """Two passes over the same work: one records the host's operations
    beside the card's, to name the gaps; the other, after it (the
    profiler's start-up then paid), the card's operations alone, for the
    kernels' times, the busy union and the span: recording the host would
    slow it and widen the gaps."""

    def __init__(self):
        self.prof = None
        self.kernel_s: Dict[str, float] = {}
        self.busy_s = 0.0
        self.window_s = 0.0
        self.gaps: List[Tuple[str, float]] = []

    def start(self, torch, host: bool) -> None:
        from torch.profiler import ProfilerActivity, profile

        card = torch.cuda.is_available()
        if card:
            torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] if card else []
        if host or not card:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._host = host

    def stop(self, torch) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        device, host = _split(self.prof.events())
        if self._host:
            self.gaps = name_gaps(device, host)
        else:
            self.reduce(device)
        self.prof = None

    def reduce(self, device: List[Tuple[Tuple[float, float], str]]) -> None:
        """Kernel seconds by name, the busy union and the span from the
        card's events (microseconds)."""
        by_name: Dict[str, float] = defaultdict(float)
        for (a, b), name in device:
            by_name[name] += (b - a) * 1e-6
        self.kernel_s = dict(by_name)
        merged = _merge(device)
        if merged:
            self.busy_s = sum(b - a for a, b in merged) * 1e-6
            self.window_s = (merged[-1][1] - merged[0][0]) * 1e-6

    def seconds_of(self, names: Tuple[str, ...]) -> float:
        """Device seconds of the kernels whose names hold any of `names`."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))

    def breakdown(self) -> Dict[str, List[List]]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps[:TOP]]}


def _split(events: Iterable):
    """(card operations, host operations), each [((start, end), name)]."""
    device, host = [], []
    for e in events:
        if getattr(e, "is_user_annotation", False) and e.name.startswith(LABEL):
            if str(e.device_type).upper().endswith("CPU"):
                host.append(((e.time_range.start, e.time_range.end), e.name))
            continue  # the card's mirror of a host range: no operation
        kind = str(getattr(e, "device_type", "")).upper()
        span = (e.time_range.start, e.time_range.end)
        if kind.endswith("CUDA"):
            device.append((span, e.name[:NAME_CHARS]))
        elif kind.endswith("CPU") and not e.is_async:
            host.append((span, e.name))
    return device, host


def _merge(device) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(s for s, _ in device):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def name_gaps(device, host) -> List[Tuple[str, float]]:
    """The card's idle gaps between its first and last operation, each put
    down to the innermost host operation running at its middle, summed by
    that name, longest first."""
    merged = _merge(device)
    holes = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    host = sorted(host)
    by_host: Dict[str, float] = defaultdict(float)
    live: List[Tuple[float, float, str]] = []  # (-start, end, name) of started host ops
    i = 0
    for a, b in sorted(holes, key=lambda h: h[0] + h[1]):
        mid = (a + b) / 2
        while i < len(host) and host[i][0][0] <= mid:
            (ha, hb), name = host[i]
            heapq.heappush(live, (-ha, hb, name))
            i += 1
        while live and live[0][1] < mid:  # the latest started has ended
            heapq.heappop(live)
        by_host[live[0][2] if live else "no host operation"] += (b - a) * 1e-6
    return sorted(by_host.items(), key=lambda kv: -kv[1])
