"""Metrics registry: counters / gauges / histograms, exported as JSON and
Prometheus text exposition format.

The registry is a passive container — the obs session *builds* one at export
time by scraping live simulation objects (FrontEnd.stats, op-latency
histograms, Link utilization, ShardDirectory load weights) plus counters the
session accumulated while objects came and went.  Histograms export as
Prometheus summaries (quantile series + _sum/_count).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

from .hist import LatencyHistogram

_LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: _LabelKey, extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = key + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_num(v: float) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class MetricsRegistry:
    def __init__(self, prefix: str = "rnvm") -> None:
        self.prefix = prefix
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[_LabelKey, float]] = {}
        self._hists: Dict[str, Dict[_LabelKey, LatencyHistogram]] = {}
        self._help: Dict[str, str] = {}

    # ------------------------------------------------------------ population
    def counter(self, name: str, value: float, help: str = "", **labels) -> None:
        """Add ``value`` to counter ``name{labels}`` (creates at 0)."""
        series = self._counters.setdefault(name, {})
        key = _labelkey(labels)
        series[key] = series.get(key, 0.0) + value
        if help:
            self._help.setdefault(name, help)

    def gauge(self, name: str, value: float, help: str = "", **labels) -> None:
        self._gauges.setdefault(name, {})[_labelkey(labels)] = value
        if help:
            self._help.setdefault(name, help)

    def histogram(self, name: str, hist: LatencyHistogram, help: str = "",
                  **labels) -> None:
        """Merge ``hist`` into the histogram series ``name{labels}``."""
        series = self._hists.setdefault(name, {})
        key = _labelkey(labels)
        if key in series:
            series[key].merge(hist)
        else:
            series[key] = hist.copy()
        if help:
            self._help.setdefault(name, help)

    # --------------------------------------------------------------- export
    def to_json(self) -> dict:
        def expand(series: Dict[str, Dict[_LabelKey, object]], render):
            out: Dict[str, List[dict]] = {}
            for name, by_label in sorted(series.items()):
                rows = []
                for key, v in sorted(by_label.items()):
                    rows.append({"labels": dict(key), **render(v)})
                out[name] = rows
            return out

        return {
            "counters": expand(self._counters, lambda v: {"value": v}),
            "gauges": expand(self._gauges, lambda v: {"value": v}),
            "histograms": expand(
                self._hists, lambda h: {**h.snapshot(), "buckets": h.to_dict()}
            ),
        }

    def to_prometheus(self) -> str:
        lines: List[str] = []
        p = self.prefix

        def emit_scalar(series, kind):
            for name, by_label in sorted(series.items()):
                full = f"{p}_{name}"
                if name in self._help:
                    lines.append(f"# HELP {full} {self._help[name]}")
                lines.append(f"# TYPE {full} {kind}")
                for key, v in sorted(by_label.items()):
                    lines.append(f"{full}{_fmt_labels(key)} {_fmt_num(v)}")

        emit_scalar(self._counters, "counter")
        emit_scalar(self._gauges, "gauge")
        for name, by_label in sorted(self._hists.items()):
            full = f"{p}_{name}"
            if name in self._help:
                lines.append(f"# HELP {full} {self._help[name]}")
            lines.append(f"# TYPE {full} summary")
            for key, h in sorted(by_label.items()):
                for q, pv in zip((0.5, 0.99, 0.999), h.percentiles((50, 99, 99.9))):
                    lines.append(
                        f"{full}{_fmt_labels(key, (('quantile', str(q)),))} "
                        f"{_fmt_num(pv)}"
                    )
                lines.append(f"{full}_sum{_fmt_labels(key)} {_fmt_num(h.total)}")
                lines.append(f"{full}_count{_fmt_labels(key)} {h.count}")
        return "\n".join(lines) + "\n"

    def export(self, prom_path: str, json_extra: dict = None) -> str:
        """Write Prometheus text at ``prom_path`` and the JSON form next to
        it (``.json`` suffix); returns the JSON path."""
        with open(prom_path, "w") as f:
            f.write(self.to_prometheus())
        if prom_path.endswith(".prom"):
            json_path = prom_path[: -len(".prom")] + ".json"
        else:
            json_path = prom_path + ".json"
        doc = self.to_json()
        if json_extra:
            doc.update(json_extra)
        with open(json_path, "w") as f:
            json.dump(doc, f, indent=1)
        return json_path
