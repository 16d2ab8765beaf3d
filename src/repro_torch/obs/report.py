"""Analysis over exported Chrome/Perfetto ``trace_event`` JSON.

Everything here works on the plain dict ``Tracer.to_chrome()`` produces (or
any trace_event document with complete-span "X" events), so the CLI in
``scripts/trace_report.py`` and the schema tests share one implementation:

  * ``validate``   — schema fields + per-track nesting (spans on one
    timeline must nest or be disjoint; an overlap means an instrumentation
    bug, e.g. a missed ``rebase()`` across a clock rewind);
  * ``top_self_time`` — which span types dominate once child time is
    subtracted;
  * ``wave_widths``  — distribution of doorbell read-wave WQE counts and
    write-fence post counts (from the spans' args);
  * ``link_utilization`` — per-blade-link mean/max plus a text heatline
    from the sampled ``link_util`` counter series.
"""

from __future__ import annotations

import json
import re
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

# tolerance for float µs comparisons in the nesting check
EPS = 1e-6

_BLADE_TRACK = re.compile(r"^fe\d+\.b(\d+)")
_LINK_TRACK = re.compile(r"^blade(\d+)(?:\.m\d+)?\.link")


def load_trace(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a trace_event document "
                         "(missing 'traceEvents')")
    return doc


def spans(doc: dict) -> List[dict]:
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


def thread_names(doc: dict) -> Dict[Tuple[int, int], str]:
    return {
        (e["pid"], e["tid"]): e["args"]["name"]
        for e in doc["traceEvents"]
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }


def _by_track(doc: dict) -> Dict[Tuple[int, int], List[dict]]:
    per: Dict[Tuple[int, int], List[dict]] = defaultdict(list)
    for e in spans(doc):
        per[(e["pid"], e["tid"])].append(e)
    for evs in per.values():
        # start ascending; at equal starts the longer span is the parent
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
    return per


def validate(doc: dict) -> List[str]:
    """Schema + nesting check; returns error strings (empty list = valid)."""
    errors: List[str] = []
    for e in spans(doc):
        missing = [f for f in ("name", "ts", "dur", "pid", "tid") if f not in e]
        if missing:
            errors.append(f"span missing {missing}: {e}")
        elif e["dur"] < -EPS:
            errors.append(f"span with negative duration: {e}")
    if errors:
        return errors
    tnames = thread_names(doc)
    for key, evs in _by_track(doc).items():
        label = tnames.get(key, str(key))
        open_ends: List[float] = []  # stack of enclosing spans' end times
        for e in evs:
            t0, t1 = e["ts"], e["ts"] + e["dur"]
            while open_ends and open_ends[-1] <= t0 + EPS:
                open_ends.pop()
            if open_ends and t1 > open_ends[-1] + EPS:
                errors.append(
                    f"overlap on track '{label}': '{e['name']}' "
                    f"[{t0:.3f}, {t1:.3f}]us crosses an enclosing span "
                    f"ending at {open_ends[-1]:.3f}us"
                )
            open_ends.append(t1)
    return errors


def span_names(doc: dict) -> Counter:
    c = Counter(e["name"] for e in spans(doc))
    c.update(e["name"] for e in doc["traceEvents"] if e.get("ph") == "i")
    return c


#: reaction-side events the self-healing front-end path lands on the trace,
#: in cause -> effect order (injection instants are the ``fault:*`` names)
_HEALING_EVENTS = ("nic_stall", "wqe_timeout", "retry_backoff", "breaker_open",
                   "breaker_reset", "fenced", "promotion")


def fault_summary(doc: dict) -> Dict[str, int]:
    """Counts of injected faults (``fault:<kind>`` instants) and of the
    healing events they provoked, so a chaos-run trace can be read as
    cause -> reaction without opening Perfetto."""
    names = span_names(doc)
    out: Dict[str, int] = {n: c for n, c in sorted(names.items())
                           if n.startswith("fault:")}
    for n in _HEALING_EVENTS:
        if n in names:
            out[n] = names[n]
    return out


def blade_tracks(doc: dict) -> List[int]:
    """Blade ids that have at least one span on a front-end track bound to
    them (``feN.bM`` thread names, ``~K`` rebind suffixes included)."""
    tnames = thread_names(doc)
    out = set()
    for key in {(e["pid"], e["tid"]) for e in spans(doc)}:
        m = _BLADE_TRACK.match(tnames.get(key, ""))
        if m:
            out.add(int(m.group(1)))
    return sorted(out)


def top_self_time(doc: dict, k: int = 10) -> List[Tuple[str, float, int]]:
    """[(name, total self-time µs, count)] over all tracks, largest first.
    Self-time is a span's duration minus its direct children's durations."""
    agg: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])

    for evs in _by_track(doc).values():
        stack: List[List] = []  # [event, child_dur_acc]

        def close(upto: float) -> None:
            while stack and stack[-1][0]["ts"] + stack[-1][0]["dur"] <= upto + EPS:
                ev, child = stack.pop()
                a = agg[ev["name"]]
                a[0] += max(0.0, ev["dur"] - child)
                a[1] += 1
                if stack:
                    stack[-1][1] += ev["dur"]

        for e in evs:
            close(e["ts"])
            stack.append([e, 0.0])
        close(float("inf"))

    ranked = sorted(((n, v[0], int(v[1])) for n, v in agg.items()),
                    key=lambda t: -t[1])
    return ranked[:k]


def wave_widths(doc: dict) -> Dict[str, Dict[int, int]]:
    """{width: count} for doorbell read waves (WQEs per wave) and write
    fences (posted writes per fence), straight from the spans' args."""
    reads: Counter = Counter()
    posts: Counter = Counter()
    for e in spans(doc):
        args = e.get("args") or {}
        if e["name"] == "read_wave" and "wqes" in args:
            reads[args["wqes"]] += 1
        elif e["name"] == "wave_fence" and "posts" in args:
            posts[args["posts"]] += 1
    return {"read_wave_wqes": dict(sorted(reads.items())),
            "fence_posts": dict(sorted(posts.items()))}


def link_utilization(doc: dict, buckets: int = 60) -> Dict[str, dict]:
    """Per-link utilization summary from the sampled ``link_util`` counters:
    {track: {n, mean, max, heatline}} with a ``buckets``-char text heatline
    (max utilization per time bucket, ' ' = idle .. '@' = saturated)."""
    tnames = thread_names(doc)
    series: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for e in doc["traceEvents"]:
        if e.get("ph") == "C" and e.get("name") == "link_util":
            val = e["args"].get("value")
            if val is None:
                continue
            series[tnames.get((e["pid"], e["tid"]), "?")].append((e["ts"], val))
    if not series:
        return {}
    t_lo = min(ts for pts in series.values() for ts, _ in pts)
    t_hi = max(ts for pts in series.values() for ts, _ in pts)
    width = max(t_hi - t_lo, 1e-9)
    ramp = " .:-=+*#%@"
    out: Dict[str, dict] = {}
    for name, pts in sorted(series.items()):
        cells = [0.0] * buckets
        for ts, v in pts:
            i = min(buckets - 1, int((ts - t_lo) / width * buckets))
            cells[i] = max(cells[i], v)
        vals = [v for _, v in pts]
        out[name] = {
            "n": len(pts),
            "mean": sum(vals) / len(vals),
            "max": max(vals),
            "heatline": "".join(
                ramp[min(len(ramp) - 1, int(c * (len(ramp) - 1) + 0.5))]
                for c in cells
            ),
        }
    return out


def summarize(doc: dict, top: int = 10) -> str:
    """Human-readable report (the CLI's default output)."""
    lines: List[str] = []
    sp = spans(doc)
    names = span_names(doc)
    lines.append(f"events: {len(doc['traceEvents'])} "
                 f"({len(sp)} spans, {len(names)} distinct names)")
    lines.append(f"tracks: {len(thread_names(doc))} "
                 f"(blade-bound fe tracks: {blade_tracks(doc)})")
    lines.append("")
    lines.append(f"top {top} span types by self-time:")
    for name, self_us, count in top_self_time(doc, top):
        lines.append(f"  {name:<24} {self_us:>12.1f} us  x{count}")
    ww = wave_widths(doc)
    if ww["read_wave_wqes"]:
        total = sum(ww["read_wave_wqes"].values())
        mean = sum(w * c for w, c in ww["read_wave_wqes"].items()) / total
        lines.append("")
        lines.append(f"read waves: {total} (mean width {mean:.1f} WQEs)")
        for w, c in list(ww["read_wave_wqes"].items())[:12]:
            lines.append(f"  width {w:>5}: {c}")
    if ww["fence_posts"]:
        total = sum(ww["fence_posts"].values())
        mean = sum(w * c for w, c in ww["fence_posts"].items()) / total
        lines.append(f"write fences: {total} (mean {mean:.1f} posts)")
    util = link_utilization(doc)
    if util:
        lines.append("")
        lines.append("link utilization (heatline over the whole trace):")
        for name, row in util.items():
            lines.append(f"  {name:<18} mean={row['mean']:.2f} "
                         f"max={row['max']:.2f} |{row['heatline']}|")
    faults = fault_summary(doc)
    if faults:
        lines.append("")
        lines.append("chaos: injected faults and the healing they provoked:")
        for name, count in faults.items():
            lines.append(f"  {name:<24} x{count}")
    return "\n".join(lines)
