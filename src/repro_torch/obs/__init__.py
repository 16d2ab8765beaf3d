"""Observability for the rNVM simulator: sim-time tracing, latency
histograms, metrics export, and wall-clock profiling; spans on the model
path.

Everything hangs off one module-global :class:`ObsSession`:

    from repro_torch import obs
    with obs.observe(trace=True, metrics=True) as sess:
        ...build clusters / front-ends, run a workload...
        sess.export_trace("out.json")          # Chrome/Perfetto trace_event
        sess.export_metrics("out.prom")        # Prometheus text + JSON

Simulation objects check ``obs.session()`` at construction: when a session
is active they register themselves (weak references — a session must never
extend the life of a multi-MB arena) and pick up a tracer track.  When no
session is active the check is one module-global read and everything else
costs nothing — per-op latency histograms are the only always-on piece, and
they live on the front-end objects themselves (``FrontEnd.op_hist``), not in
the session.

The model path (the train step, the serving engine) opens ``obs.span``s at
its phase boundaries and counts at the same boundaries with ``obs.count``.
A session started with ``spans=True`` records them (so does a running
``torch.profiler``, whose trace then shows each span as a host operation)
and writes them out with ``export_spans``:

    with obs.observe(spans=True) as sess:
        ...train steps, generate calls...
        sess.export_spans("spans.json")        # trace_event, device ms in args

Objects that die before export (benchmarks build a fresh cluster per panel)
fold their counters and histograms into session-level accumulators via
``weakref.finalize``, so the final metrics export still sees their traffic.
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from .hist import GROWTH, SUBBUCKETS, LatencyHistogram
from .metrics import MetricsRegistry
from .tracer import Track, Tracer
from . import profile as _profile

__all__ = [
    "GROWTH",
    "SUBBUCKETS",
    "LatencyHistogram",
    "MetricsRegistry",
    "ObsSession",
    "Tracer",
    "Track",
    "count",
    "observe",
    "session",
    "span",
    "start",
    "stop",
]


class ObsSession:
    def __init__(self, trace: bool = False, metrics: bool = False, spans: bool = False):
        self.tracer: Optional[Tracer] = Tracer() if trace else None
        self.metrics = metrics
        self.spans = spans
        #: session-level event counters (migrations, failovers, revocations)
        self.counters: Dict[str, float] = {}
        self._live_fes: List[weakref.ref] = []
        self._live_cfes: List[weakref.ref] = []
        self._live_clusters: List[weakref.ref] = []
        self._live_result_caches: List[weakref.ref] = []
        self._live_open_loops: List[weakref.ref] = []
        # accumulators folded from objects that have been garbage-collected
        self._dead_stats: Dict[str, float] = {}
        self._dead_hists: Dict[str, LatencyHistogram] = {}
        self._dead_cfe_hists: Dict[str, LatencyHistogram] = {}
        self._dead_rc_counters: Dict[str, float] = {}
        self._dead_arrival_hists: Dict[str, LatencyHistogram] = {}
        self._dead_depth: Dict[str, float] = {"max": 0, "sum": 0, "samples": 0}
        self._dead_ol_served = 0
        if metrics:
            _profile.reset()
            _profile.enable()
        if spans:
            _profile.spans_on()

    # -------------------------------------------------------- registration
    def register_frontend(self, fe) -> None:
        self._live_fes.append(weakref.ref(fe))
        weakref.finalize(fe, self._fold_fe, fe.stats, fe.op_hist)

    def register_cluster_frontend(self, cfe) -> None:
        self._live_cfes.append(weakref.ref(cfe))
        weakref.finalize(cfe, self._fold_cfe, cfe.op_hist)

    def register_cluster(self, cluster) -> None:
        self._live_clusters.append(weakref.ref(cluster))

    def register_result_cache(self, rc) -> None:
        """Track a ResultCache; its counters dict (small, owned by the
        cache) survives the cache via finalize-folding, so the export sees
        every cache's traffic, dead or alive."""
        self._live_result_caches.append(weakref.ref(rc))
        weakref.finalize(rc, self._fold_result_cache, rc.counters)

    def register_open_loop(self, engine) -> None:
        """Track an OpenLoopEngine's arrival-latency histograms and queue
        depth aggregates (both small dicts, finalize-folded)."""
        self._live_open_loops.append(weakref.ref(engine))
        weakref.finalize(engine, self._fold_open_loop,
                         engine.arrival_hist, engine.depth)

    def _fold_fe(self, stats, op_hist: Dict[str, LatencyHistogram]) -> None:
        for k, v in stats.snapshot().items():
            self._dead_stats[k] = self._dead_stats.get(k, 0) + v
        for op, h in op_hist.items():
            self._dead_hists.setdefault(op, LatencyHistogram()).merge(h)

    def _fold_cfe(self, op_hist: Dict[str, LatencyHistogram]) -> None:
        for op, h in op_hist.items():
            self._dead_cfe_hists.setdefault(op, LatencyHistogram()).merge(h)

    def _fold_result_cache(self, counters: Dict[str, int]) -> None:
        for k, v in counters.items():
            self._dead_rc_counters[k] = self._dead_rc_counters.get(k, 0) + v

    def _fold_open_loop(self, arrival_hist: Dict[str, LatencyHistogram],
                        depth: Dict[str, float]) -> None:
        for kind, h in arrival_hist.items():
            self._dead_arrival_hists.setdefault(
                kind, LatencyHistogram()).merge(h)
        d = self._dead_depth
        d["max"] = max(d["max"], depth["max"])
        d["sum"] += depth["sum"]
        d["samples"] += depth["samples"]
        self._dead_ol_served += sum(h.count for h in arrival_hist.values())

    # --------------------------------------------------------- aggregation
    @staticmethod
    def _alive(refs: List[weakref.ref]) -> list:
        return [o for o in (r() for r in refs) if o is not None]

    def clusters(self) -> list:
        return self._alive(self._live_clusters)

    def fe_totals(self) -> Tuple[Dict[str, float], Dict[str, LatencyHistogram]]:
        """Summed Stats counters and merged op-latency histograms over every
        front-end the session ever saw (dead accumulators + live scrape)."""
        totals = dict(self._dead_stats)
        hists = {op: h.copy() for op, h in self._dead_hists.items()}
        for fe in self._alive(self._live_fes):
            for k, v in fe.stats.snapshot().items():
                totals[k] = totals.get(k, 0) + v
            for op, h in fe.op_hist.items():
                hists.setdefault(op, LatencyHistogram()).merge(h)
        return totals, hists

    def cfe_hists(self) -> Dict[str, LatencyHistogram]:
        hists = {op: h.copy() for op, h in self._dead_cfe_hists.items()}
        for cfe in self._alive(self._live_cfes):
            for op, h in cfe.op_hist.items():
                hists.setdefault(op, LatencyHistogram()).merge(h)
        return hists

    def result_cache_totals(self) -> Dict[str, float]:
        """Summed ResultCache counters over every cache the session ever
        saw (dead accumulators + live scrape)."""
        totals = dict(self._dead_rc_counters)
        for rc in self._alive(self._live_result_caches):
            for k, v in rc.counters.items():
                totals[k] = totals.get(k, 0) + v
        return totals

    def page_cache_totals(self) -> Dict[str, float]:
        """Summed ``PageCache.stats()`` over the *live* front-ends (page
        caches are multi-MB arenas, so dead ones are never pinned for
        folding — gauges describe the caches currently in memory)."""
        totals: Dict[str, float] = {}
        for fe in self._alive(self._live_fes):
            for k, v in fe.cache.stats().items():
                totals[k] = totals.get(k, 0) + v
        return totals

    def arrival_totals(self) -> Tuple[Dict[str, LatencyHistogram], Dict[str, float], int]:
        """Merged open-loop arrival-latency histograms, queue-depth
        aggregates, and total served ops (dead + live engines)."""
        hists = {k: h.copy() for k, h in self._dead_arrival_hists.items()}
        depth = dict(self._dead_depth)
        served = self._dead_ol_served
        for eng in self._alive(self._live_open_loops):
            for kind, h in eng.arrival_hist.items():
                hists.setdefault(kind, LatencyHistogram()).merge(h)
            depth["max"] = max(depth["max"], eng.depth["max"])
            depth["sum"] += eng.depth["sum"]
            depth["samples"] += eng.depth["samples"]
            served += eng.served
        return hists, depth, served

    def rebase(self) -> None:
        if self.tracer is not None:
            self.tracer.rebase()

    # --------------------------------------------------------------- export
    def build_registry(self) -> MetricsRegistry:
        reg = MetricsRegistry()
        totals, hists = self.fe_totals()
        for k, v in sorted(totals.items()):
            reg.counter(f"fe_{k}", v,
                        help="summed FrontEnd.stats over all front-ends")
        for op, h in sorted(hists.items()):
            reg.histogram("op_latency_ns", h,
                          help="per-op sim-time latency (front-end level)",
                          op=op)
        for op, h in sorted(self.cfe_hists().items()):
            reg.histogram("cluster_op_latency_ns", h,
                          help="per-op sim-time latency (cluster front-end level)",
                          op=op)
        for k, v in sorted(self.page_cache_totals().items()):
            reg.gauge(f"fe_page_cache_{k}", v,
                      help="summed PageCache.stats() over live front-ends")
        rc_totals = self.result_cache_totals()
        for k, v in sorted(rc_totals.items()):
            reg.counter(f"fe_result_cache_{k}", v,
                        help="summed ResultCache counters over all result "
                             "caches (hits/misses/invalidation tiers)")
        arr_hists, depth, served = self.arrival_totals()
        if served:
            for kind, h in sorted(arr_hists.items()):
                reg.histogram("arrival_latency_ns", h,
                              help="open-loop arrival-to-completion latency "
                                   "(queueing + service)", op=kind)
            reg.counter("open_loop_ops_served", served)
            reg.gauge("open_loop_queue_depth_max", depth["max"],
                      help="deepest front-end arrival queue observed")
            reg.gauge("open_loop_queue_depth_mean",
                      depth["sum"] / depth["samples"] if depth["samples"] else 0.0,
                      help="mean arrival-queue depth sampled per dispatch")
        for name, v in sorted(self.counters.items()):
            reg.counter(name, v)
        for ci, cl in enumerate(self.clusters()):
            c = str(ci)
            reg.gauge("directory_epoch", cl.directory.epoch, cluster=c)
            for bid, w in sorted(cl.directory.load_weights().items()):
                reg.gauge("blade_load_weight", w,
                          help="per-blade sum of shard weights "
                               "(ShardDirectory.load_weights)",
                          cluster=c, blade=str(bid))
            for s, n in sorted(cl.directory.op_counts.items()):
                reg.gauge("shard_ops", n,
                          help="data-path ops routed per shard "
                               "(ShardDirectory.record_ops)",
                          cluster=c, shard=str(s))
            for bid, be in sorted(cl.blades.items()):
                reg.gauge("link_busy_ns", be.link.busy_total,
                          help="cumulative service time on the blade NIC",
                          cluster=c, blade=str(bid))
                br = be.link.breaker
                reg.gauge("breaker_state",
                          0 if br is None or br.opened_at is None else 1,
                          help="per-blade link circuit breaker "
                               "(0 closed, 1 open)",
                          cluster=c, blade=str(bid))
        for site, d in _profile.snapshot().items():
            reg.counter("profile_seconds", d["seconds"],
                        help="wall-clock seconds inside obs.profile regions",
                        site=site)
            reg.counter("profile_calls", d["calls"], site=site)
        return reg

    def link_timelines(self) -> Dict[str, dict]:
        """Sampled per-link utilization series (from the tracer's counter
        events): {link track: {n, mean, max, series: [[t_us, util], ...]}}."""
        if self.tracer is None:
            return {}
        out: Dict[str, dict] = {}
        for track, name, ts, value in self.tracer._counters:
            if name != "link_util":
                continue
            util = value if isinstance(value, (int, float)) else value.get("value", 0.0)
            d = out.setdefault(track.name, {"n": 0, "mean": 0.0, "max": 0.0,
                                            "series": []})
            d["n"] += 1
            d["mean"] += util
            d["max"] = max(d["max"], util)
            if len(d["series"]) < 4096:
                d["series"].append([round(ts / 1000.0, 3), round(util, 4)])
        for d in out.values():
            d["mean"] = d["mean"] / d["n"] if d["n"] else 0.0
        return out

    def export_trace(self, path: str) -> None:
        if self.tracer is None:
            raise RuntimeError("session was started without trace=True")
        self.tracer.export_json(path)

    def export_spans(self, path: str) -> None:
        """The model path's spans kept so far, as trace_event JSON (one
        ``model path`` track, host times from the first span's start)."""
        tracer = Tracer()
        _profile.to_tracer(tracer)
        tracer.export_json(path)

    def export_metrics(self, path: str) -> str:
        """Write Prometheus text at ``path`` plus a JSON sibling; returns
        the JSON path."""
        reg = self.build_registry()
        extra = {"profile": _profile.snapshot()}
        timelines = self.link_timelines()
        if timelines:
            extra["link_utilization"] = timelines
        return reg.export(path, json_extra=extra)


_SESSION: Optional[ObsSession] = None


def session() -> Optional[ObsSession]:
    return _SESSION


def start(trace: bool = False, metrics: bool = False, spans: bool = False) -> ObsSession:
    global _SESSION
    _SESSION = ObsSession(trace=trace, metrics=metrics, spans=spans)
    return _SESSION


def stop() -> Optional[ObsSession]:
    global _SESSION
    s = _SESSION
    _SESSION = None
    if s is not None and s.metrics:
        _profile.disable()
    if s is not None and s.spans:
        _profile.spans_off()
    return s


@contextmanager
def observe(trace: bool = False, metrics: bool = False, spans: bool = False):
    s = start(trace=trace, metrics=metrics, spans=spans)
    try:
        yield s
    finally:
        stop()


def count(name: str, n: float = 1) -> None:
    """Bump a session-level event counter, and the open root span's count of
    the same name; free when no session is active and no span is open."""
    s = _SESSION
    if s is not None:
        s.counters[name] = s.counters.get(name, 0) + n
    _profile.note(name, n)


span = _profile.span
