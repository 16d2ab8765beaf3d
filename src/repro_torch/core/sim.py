"""Virtual-time simulation substrate for the rNVM reproduction.

The paper evaluates rNVM on an 8-node InfiniBand cluster with a DRAM-based
NVM emulator (write latency forced to 200 ns).  This container has neither
RDMA nor NVM, so — exactly like the paper emulated NVM with DRAM — we emulate
the *fabric* with a deterministic virtual clock.  Every remote primitive
advances virtual time according to the paper's published constants
(RTT ~2 us, 40 Gb/s links, 200 ns NVM write, DRAM-speed reads), and reported
throughputs are ops / virtual-second.  The model is deterministic, so the
paper's *ratios* (e.g. the 6-22x RCB-vs-naive band) are reproducible bit for
bit on any host.

Concurrency model: each front-end owns a local clock; the back-end NIC is a
serializing resource (``Link``).  A transfer from front-end ``f`` starts at
``max(f.now, link.busy_until)`` and occupies the link for ``bytes / bw``;
this yields natural contention when several front-ends share one blade
(paper Fig. 9/10).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from ..obs.hist import LatencyHistogram


@dataclasses.dataclass
class CostModel:
    """Latency/bandwidth constants; defaults follow the paper's testbed.

    All times are in nanoseconds.
    """

    rtt_ns: float = 2000.0          # one-sided RDMA round-trip ("about 2us")
    bandwidth_gbps: float = 40.0    # ConnectX-3 InfiniBand
    nvm_write_ns: float = 200.0     # emulated NVM write latency
    nvm_read_ns: float = 100.0      # NVM read ~ DRAM read
    dram_ns: float = 60.0           # front-end cache hit
    cpu_op_ns: float = 250.0        # software overhead per data-structure op
    cpu_batch_op_ns: float = 40.0   # per-item software overhead inside a
                                    # vector-op wave: the batch shares one
                                    # dispatch, each item pays only its
                                    # staging work (a few cache-line writes
                                    # in a tight loop).  Also the per-chunk
                                    # share of a wave's batched slab carve.
    issue_ns: float = 450.0         # post a work-queue entry (doorbell etc.)
    doorbell_wqe_ns: float = 120.0  # extra WQE in an already-rung doorbell
                                    # batch (vector ops amortize issue_ns)
    atomic_ns: float = 2200.0       # RDMA atomic verb (slightly > RTT)
    backend_apply_ns_per_byte: float = 0.35   # log replay cost on the blade
    nic_msg_ns: float = 150.0       # blade NIC per-message cost (IOPS cap)
    # ------------------------------------------------ directory lease terms
    # A front-end holding a valid directory lease validates locally (free);
    # the costs move to the edges: acquiring/renewing a lease rides the
    # directory fetch plus a lease-record write, and every reconfiguration
    # (migration, failover, scale-out) pays one invalidation message per
    # outstanding lease BEFORE swapping the mapping — the broadcast that
    # makes it safe for lease holders to skip per-op validation.
    lease_grant_ns: float = 500.0        # lease-record write on top of a fetch
    lease_invalidate_ns: float = 2500.0  # one revocation round per lease holder
    # ------------------------------------------------ fault-handling terms
    # A posted round whose completion never arrives costs the front-end one
    # operation deadline before it declares the WQE lost; each resend backs
    # off exponentially (with deterministic jitter) from the base below.  A
    # link whose consecutive timeouts reach the breaker threshold is treated
    # as unreachable until the cooldown elapses — the front-end fails fast
    # and lets the cluster layer probe/promote instead of burning deadlines.
    op_timeout_ns: float = 25_000.0      # deadline on a posted round (~12 RTT)
    retry_backoff_ns: float = 10_000.0   # base of the exponential backoff
    retry_jitter: float = 0.25           # +-fraction of backoff randomized
    breaker_threshold: int = 3           # consecutive timeouts to trip
    breaker_cooldown_ns: float = 400_000.0  # open-state fail-fast window

    # ---------------------------------------------- wave-width derivations
    # Floor: below this many WQEs per doorbell the issue amortization cannot
    # even halve the per-item post cost, so narrower waves are pointless.
    def wave_floor(self) -> int:
        return max(2, round(self.issue_ns / max(self.doorbell_wqe_ns, 1.0)))

    # Ceiling: one wave must not oversubscribe a Link epoch's message budget
    # (beyond ~3/4 of it the M/M/1 queueing delay and the hard-overflow
    # penalty dominate whatever the doorbell amortizes).
    def wave_ceiling(self, epoch_ns: float) -> int:
        return max(self.wave_floor(), int(0.75 * epoch_ns / self.nic_msg_ns))

    @property
    def bytes_per_ns(self) -> float:
        return self.bandwidth_gbps / 8.0

    def xfer_ns(self, nbytes: int) -> float:
        return nbytes / self.bytes_per_ns


@dataclasses.dataclass
class Stats:
    """Operation counters, kept per front-end and per back-end."""

    rdma_reads: int = 0
    rdma_writes: int = 0
    rdma_atomics: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    oplog_appends: int = 0
    tx_commits: int = 0
    memlogs_flushed: int = 0
    memlogs_coalesced: int = 0
    combined_flushes: int = 0   # oplog+memlog folded into one posted write
    write_waves: int = 0        # closed doorbell write waves (>=1 WQE each)
    wqe_posts: int = 0          # posted-write WQEs that joined a write wave
    writes_combined: int = 0    # adjacent-address writes merged into one WQE
    ops_annulled: int = 0
    reader_retries: int = 0
    replica_reads: int = 0      # remote reads served by a mirror endpoint
    replica_fallbacks: int = 0  # replica-eligible reads pinned back to the
                                # primary (staleness bound exceeded)
    op_timeouts: int = 0        # posted rounds whose completion never arrived
    op_retries: int = 0         # resends after a timeout (backoff charged)
    breaker_trips: int = 0      # circuit breakers opened by this front-end
    degraded_reads: int = 0     # reads routed to a replica because the
                                # primary's circuit breaker was open
    fenced_appends: int = 0     # group commits rejected at the blade because
                                # this front-end's write lease was stolen
                                # (stale epoch); the staged window vanished

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class LinkFaults:
    """Armed fault state for one NIC link (``Link.fault``).

    Normally a link has no fault object at all (``Link.fault is None``), so
    the fault-free hot path pays exactly one attribute check.  The fault
    injector arms faults by mutating these fields; the front-end's fault
    gate consumes them and charges the consequences to its own clock:

      * ``drop_pending``  — the next N posted rounds lose their completion
        (the blade-side effect of the WQE still happens; this is a lost ACK,
        not a lost write — retries are idempotent resends);
      * ``dup_pending``   — the next N rounds are posted twice (the dup
        burns link capacity + issue time but is harmless, one-sided verbs
        being idempotent);
      * ``stall_until``   — NIC stall window: WQEs sit in the send queue
        until this virtual timestamp (pure delay, nothing lost).

    The ``drops``/``dups``/``stalls`` counters record what actually fired.
    """

    __slots__ = ("drop_pending", "dup_pending", "stall_until",
                 "drops", "dups", "stalls")

    def __init__(self) -> None:
        self.drop_pending = 0
        self.dup_pending = 0
        self.stall_until = 0.0
        self.drops = 0
        self.dups = 0
        self.stalls = 0


class Link:
    """The back-end blade's NIC: a shared bandwidth + message-rate resource.

    Contention is modeled with epoch-bucketed capacity accounting (bytes and
    messages per epoch); a transfer landing in an oversubscribed epoch is
    delayed by the overflow.  This is causal and insensitive to the
    interleaving granularity of the simulated front-ends (unlike a naive
    busy-until model, where an entity 'in the past' could be blocked by
    reservations made by entities already ahead in virtual time).
    """

    #: epochs kept behind the latest one seen; older buckets can only be hit
    #: by a front-end lagging that far in virtual time, and a long-gone
    #: epoch re-created empty merely forgets contention that is over anyway.
    HORIZON_EPOCHS = 64

    def __init__(self, cost: CostModel, epoch_ns: float = 50_000.0):
        self.cost = cost
        self.epoch = epoch_ns
        self.bytes_in_epoch: dict = {}
        self.msgs_in_epoch: dict = {}
        self.busy_total: float = 0.0
        self._hi_epoch = -1
        # set by Tracer.attach_link when an obs session is tracing; when
        # attached, crossing into a new epoch samples the completed epoch's
        # utilization onto this link's counter track
        self._trace = None
        self._trace_track = None
        # fault-injection state, both None on a healthy link: `fault` is the
        # armed LinkFaults (set by a fault injector), `breaker` the shared
        # CircuitBreaker front-ends hang here so open/closed state survives
        # a front-end rebind (the endpoint is sick, not the client object)
        self.fault = None
        self.breaker = None

    def inject(self) -> LinkFaults:
        """Return this link's fault carrier, arming an empty one on first use."""
        if self.fault is None:
            self.fault = LinkFaults()
        return self.fault

    def _prune(self, e: int) -> None:
        """Sliding-horizon eviction: once epoch `e` is seen, buckets older
        than ``e - HORIZON_EPOCHS`` are dead weight — without this a
        multi-minute benchmark run accumulates one dict entry per 50us of
        virtual time, forever."""
        self._hi_epoch = e
        floor = e - self.HORIZON_EPOCHS
        if floor <= 0:
            return
        for d in (self.bytes_in_epoch, self.msgs_in_epoch):
            stale = [k for k in d if k < floor]
            for k in stale:
                del d[k]

    def _advance_horizon(self, e: int) -> None:
        """Move the sliding horizon up to epoch `e`, first sampling the
        utilization of the epoch being left behind to the tracer (if one is
        attached)."""
        tr = self._trace
        if tr is not None and self._hi_epoch >= 0:
            t_prev = self._hi_epoch * self.epoch
            tr.counter(self._trace_track, "link_util", t_prev,
                       round(self.utilization(t_prev), 4))
        self._prune(e)

    def utilization(self, t_ns: float) -> float:
        """Fraction of the epoch containing `t_ns` already spoken for (the
        adaptive wave-width controller's congestion signal)."""
        e = int(t_ns // self.epoch)
        if e > self._hi_epoch:
            # pruning used to happen only in transfer(): after a reset()
            # re-use (or a writer lagging below the horizon), a reader
            # probing an epoch never transferred-in could see stale bucket
            # data that a transfer would have evicted.  Prune on read too.
            self._advance_horizon(e)
        cap_bytes = self.cost.bytes_per_ns * self.epoch
        cap_msgs = self.epoch / self.cost.nic_msg_ns
        return max(self.bytes_in_epoch.get(e, 0.0) / cap_bytes,
                   self.msgs_in_epoch.get(e, 0.0) / cap_msgs)

    def transfer(self, start_ns: float, nbytes: int) -> float:
        e = int(start_ns // self.epoch)
        if e > self._hi_epoch:
            self._advance_horizon(e)
        self.bytes_in_epoch[e] = self.bytes_in_epoch.get(e, 0.0) + nbytes
        self.msgs_in_epoch[e] = self.msgs_in_epoch.get(e, 0.0) + 1
        cap_bytes = self.cost.bytes_per_ns * self.epoch
        cap_msgs = self.epoch / self.cost.nic_msg_ns
        # queueing delay rises with epoch utilization (M/M/1-flavoured), plus
        # hard overflow once an epoch is oversubscribed
        util = min(0.95, max(self.bytes_in_epoch[e] / cap_bytes,
                             self.msgs_in_epoch[e] / cap_msgs))
        service = self.cost.xfer_ns(nbytes) + self.cost.nic_msg_ns
        queue_delay = service * util / (1.0 - util)
        over_b = max(0.0, self.bytes_in_epoch[e] - cap_bytes) / self.cost.bytes_per_ns
        over_m = max(0.0, self.msgs_in_epoch[e] - cap_msgs) * self.cost.nic_msg_ns
        self.busy_total += service
        return start_ns + service + queue_delay + max(over_b, over_m)

    def transfer_many(self, start_ns: float, gaps, sizes):
        """Sequential dependent transfers, vectorized per epoch.

        Item ``i`` begins ``gaps[i]`` ns after item ``i-1`` completes (item 0
        after ``start_ns``); returns the array of completion times.  This is
        the doorbell-wave inner loop: all the capacity accounting of calling
        :meth:`transfer` in a Python loop, but the common case — a whole wave
        landing inside one 50µs epoch — is a handful of numpy ops (cumsum of
        bucket fill, vectorized queue/overflow delay, cumsum of completion
        increments).  Chunks that cross an epoch boundary fall back to the
        scalar path for the boundary item, then re-vectorize.
        """
        n = len(sizes)
        if n <= 48:
            # small wave: a fully inlined scalar walk of the same math is
            # ~2x cheaper than the vector path's array temporaries (the
            # numpy setup only pays off once a wave has O(100) chunks)
            cost = self.cost
            bpns = cost.bytes_per_ns
            nic = cost.nic_msg_ns
            epoch = self.epoch
            cap_b = bpns * epoch
            cap_m = epoch / nic
            b_in = self.bytes_in_epoch
            m_in = self.msgs_in_epoch
            if hasattr(gaps, "tolist"):
                gaps = gaps.tolist()
            out = np.empty(n, dtype=np.float64)
            busy = 0.0
            cur = start_ns
            for i in range(n):
                s0 = cur + gaps[i]
                e = int(s0 // epoch)
                if e > self._hi_epoch:
                    self._advance_horizon(e)
                b = b_in.get(e, 0.0) + sizes[i]
                m = m_in.get(e, 0.0) + 1.0
                b_in[e] = b
                m_in[e] = m
                util = b / cap_b
                um = m / cap_m
                if um > util:
                    util = um
                if util > 0.95:
                    util = 0.95
                service = sizes[i] / bpns + nic
                busy += service
                over_b = (b - cap_b) / bpns
                over_m = (m - cap_m) * nic
                over = over_b if over_b > over_m else over_m
                if over < 0.0:
                    over = 0.0
                cur = s0 + service + service * util / (1.0 - util) + over
                out[i] = cur
            self.busy_total += busy
            return out
        gaps = np.asarray(gaps, dtype=np.float64)
        sizes_f = np.asarray(sizes, dtype=np.float64)
        out = np.empty(n, dtype=np.float64)
        cost = self.cost
        bpns = cost.bytes_per_ns
        cap_b = bpns * self.epoch
        cap_m = self.epoch / cost.nic_msg_ns
        cur = start_ns
        i = 0
        while i < n:
            s0 = cur + gaps[i]
            e = int(s0 // self.epoch)
            if e > self._hi_epoch:
                self._advance_horizon(e)
            bs = sizes_f[i:]
            gs = gaps[i:]
            b0 = self.bytes_in_epoch.get(e, 0.0)
            m0 = self.msgs_in_epoch.get(e, 0.0)
            bytes_cum = b0 + np.cumsum(bs)
            msgs_cum = m0 + np.arange(1.0, len(bs) + 1.0)
            util = np.minimum(
                0.95, np.maximum(bytes_cum / cap_b, msgs_cum / cap_m)
            )
            service = bs / bpns + cost.nic_msg_ns
            delay = service * util / (1.0 - util)
            over = np.maximum(
                np.maximum(0.0, bytes_cum - cap_b) / bpns,
                np.maximum(0.0, msgs_cum - cap_m) * cost.nic_msg_ns,
            )
            ends = cur + np.cumsum(gs + service + delay + over)
            starts = ends - (service + delay + over)
            lim = (e + 1) * self.epoch
            if starts[-1] < lim:
                take = len(bs)
            else:
                # starts[0] == s0 < lim by construction of `e`, so take >= 1
                take = max(1, int(np.searchsorted(starts, lim)))
            self.bytes_in_epoch[e] = float(bytes_cum[take - 1])
            self.msgs_in_epoch[e] = m0 + take
            self.busy_total += float(np.sum(service[:take]))
            out[i : i + take] = ends[:take]
            cur = float(ends[take - 1])
            i += take
        return out

    def reset(self) -> None:
        self.bytes_in_epoch.clear()
        self.msgs_in_epoch.clear()
        self.busy_total = 0.0
        self._hi_epoch = -1


class Clock:
    """A monotonically advancing local clock (one per simulated node)."""

    __slots__ = ("now",)

    def __init__(self) -> None:
        self.now: float = 0.0

    def advance(self, ns: float) -> float:
        self.now += ns
        return self.now

    def advance_to(self, t: float) -> float:
        if t > self.now:
            self.now = t
        return self.now


# ===================================================== open-loop traffic engine
#
# Everything above models *service*: how long an op takes once a front-end
# starts it.  Closed-loop benchmarks (each thread issues the next op when the
# last returns) therefore measure service time only — they cannot produce
# queueing or tail latency, because offered load always exactly equals
# capacity.  The engine below adds the missing half: arrivals.  Ops carry an
# arrival timestamp drawn from a seeded Poisson process (or replayed from a
# trace), queue FIFO at their front-end, and are dispatched in batches by a
# deterministic event loop, so the recorded latency is true
# arrival-to-completion time (queueing + service) and offered load is an
# independent knob.  Nothing here runs unless a benchmark builds an engine —
# the closed-loop path stays the default and is byte-identical without it.


def poisson_arrivals(rate_ops_per_s: float, n: int, seed: int = 0,
                     start_ns: float = 0.0) -> np.ndarray:
    """``n`` arrival timestamps (ns, float64, ascending) of a seeded Poisson
    process with the given mean rate.  Deterministic for a fixed seed."""
    if n <= 0:
        return np.empty(0, dtype=np.float64)
    if rate_ops_per_s <= 0.0:
        raise ValueError("rate must be positive")
    rng = np.random.default_rng(seed)
    mean_gap_ns = 1e9 / rate_ops_per_s
    gaps = rng.exponential(mean_gap_ns, size=n)
    return start_ns + np.cumsum(gaps)


def trace_arrivals(timestamps_ns) -> np.ndarray:
    """Validate a replayed arrival trace: float64, sorted, non-negative."""
    ts = np.asarray(timestamps_ns, dtype=np.float64)
    if ts.ndim != 1:
        raise ValueError("trace must be one-dimensional")
    if len(ts) and float(ts[0]) < 0.0:
        raise ValueError("trace timestamps must be non-negative")
    if np.any(np.diff(ts) < 0.0):
        ts = np.sort(ts, kind="stable")
    return ts


def merge_streams(streams: "dict") -> "tuple[np.ndarray, np.ndarray]":
    """Merge per-tenant arrival streams ``{tenant_id: timestamps}`` into one
    timeline.  Returns ``(timestamps, tenant_ids)`` sorted by time; ties
    break by tenant id so the merge is deterministic."""
    if not streams:
        return np.empty(0, dtype=np.float64), np.empty(0, dtype=np.int64)
    parts_ts, parts_tid = [], []
    for tid in sorted(streams):
        ts = np.asarray(streams[tid], dtype=np.float64)
        parts_ts.append(ts)
        parts_tid.append(np.full(len(ts), int(tid), dtype=np.int64))
    all_ts = np.concatenate(parts_ts)
    all_tid = np.concatenate(parts_tid)
    order = np.lexsort((all_tid, all_ts))
    return all_ts[order], all_tid[order]


class OpenLoopOp:
    """One queued operation: an arrival timestamp plus an opaque payload the
    station's executor interprets (op kind, key, value, tenant...)."""

    __slots__ = ("ts", "kind", "key", "value", "tenant")

    def __init__(self, ts: float, kind: str, key=None, value=None, tenant: int = 0):
        self.ts = ts
        self.kind = kind
        self.key = key
        self.value = value
        self.tenant = tenant


class OpenLoopStation:
    """One serving front-end in the open-loop timeline: a clock, a FIFO
    arrival queue, and an executor ``execute(batch)`` that performs the ops
    and advances the clock (any closed-loop code — a ``ShardedHashTable``
    bound to a ``ClusterFrontEnd``, a raw ``FrontEnd`` — works unchanged)."""

    def __init__(self, clock: Clock, execute, station_id: int = 0,
                 max_batch: int = 64):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.clock = clock
        self.execute = execute
        self.station_id = station_id
        self.max_batch = max_batch
        self._ts = np.empty(0, dtype=np.float64)  # arrival times, ascending
        self._ops: "list[OpenLoopOp]" = []
        self._head = 0  # first unserved op
        self.served = 0

    def offer(self, ops: "list[OpenLoopOp]") -> None:
        """Load this station's arrival stream (must be time-sorted)."""
        ts = np.asarray([op.ts for op in ops], dtype=np.float64)
        if np.any(np.diff(ts) < 0.0):
            raise ValueError("arrivals must be time-sorted")
        self._ops = list(ops)
        self._ts = ts
        self._head = 0

    @property
    def pending(self) -> int:
        return len(self._ops) - self._head

    def backlog(self, now: float) -> int:
        """Ops that have arrived by ``now`` but not yet started service."""
        due = int(np.searchsorted(self._ts, now, side="right"))
        return max(0, due - self._head)


class OpenLoopEngine:
    """Deterministic event loop dispatching queued arrivals across stations.

    Each step picks the station whose next feasible dispatch time
    ``max(clock.now, head_arrival)`` is smallest (ties break by station id),
    batches every op that has arrived by then (up to ``max_batch``), runs the
    station's executor, and records per-op **arrival-to-completion** latency
    — queueing delay plus service — into per-kind histograms.  Queue depth is
    sampled after every dispatch.  The loop is causal (a batch never contains
    an op that arrives after its dispatch time) and fully deterministic.

    Registers with an active ``repro_torch.obs`` session so arrival-latency
    histograms and queue-depth gauges ride the normal metrics export.
    """

    def __init__(self, stations: "list[OpenLoopStation]", name: str = "open_loop"):
        self.stations = list(stations)
        self.name = name
        self.arrival_hist: "dict[str, LatencyHistogram]" = {}
        # plain dict so an obs session can fold it after the engine dies
        self.depth = {"max": 0, "sum": 0, "samples": 0}
        self.served = 0
        from .. import obs  # lazy: keep the sim substrate import-light
        sess = obs.session()
        if sess is not None:
            sess.register_open_loop(self)

    def _hist(self, kind: str) -> LatencyHistogram:
        h = self.arrival_hist.get(kind)
        if h is None:
            h = self.arrival_hist[kind] = LatencyHistogram()
        return h

    def run(self) -> "dict":
        """Drain every station's queue; returns a summary dict."""
        heap = []
        for i, st in enumerate(self.stations):
            if st.pending:
                heapq.heappush(
                    heap, (max(st.clock.now, float(st._ts[st._head])), i))
        while heap:
            t, i = heapq.heappop(heap)
            st = self.stations[i]
            if st._head >= len(st._ops):
                continue
            start = max(st.clock.now, float(st._ts[st._head]))
            if start > t:
                # the station's clock moved since this entry was pushed
                # (e.g. another station's recovery touched it) — re-key
                heapq.heappush(heap, (start, i))
                continue
            due = int(np.searchsorted(st._ts, start, side="right"))
            hi = min(due, st._head + st.max_batch)
            if hi <= st._head:  # float slop: serve at least the head op
                hi = st._head + 1
            batch = st._ops[st._head:hi]
            st._head = hi
            st.clock.advance_to(start)
            st.execute(batch)
            now = st.clock.now
            for op in batch:
                self._hist(op.kind).record(now - op.ts)
            n = len(batch)
            st.served += n
            self.served += n
            depth = st.backlog(now)
            d = self.depth
            if depth > d["max"]:
                d["max"] = depth
            d["sum"] += depth
            d["samples"] += 1
            if st._head < len(st._ops):
                heapq.heappush(
                    heap, (max(now, float(st._ts[st._head])), i))
        return self.summary()

    def summary(self) -> "dict":
        makespan = max((st.clock.now for st in self.stations), default=0.0)
        d = self.depth
        return {
            "served": self.served,
            "makespan_ns": makespan,
            "throughput_kops": (
                self.served / makespan * 1e6 if makespan > 0.0 else 0.0),
            "latency": {k: h.snapshot()
                        for k, h in sorted(self.arrival_hist.items())},
            "queue_depth_max": d["max"],
            "queue_depth_mean": d["sum"] / d["samples"] if d["samples"] else 0.0,
        }
