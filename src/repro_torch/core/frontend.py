"""Front-end runtime: the Gather-Apply workflow of paper §5/§7.

One ``FrontEnd`` object = one client machine.  It owns:

  * a local DRAM page cache (``use_cache`` / "C"),
  * a coalescing memory-log write buffer flushed via ``remote_tx_write``
    (``use_batch`` / "B" controls the flush cadence and vector ops),
  * an operation-log channel that records every mutation in remote NVM
    *before* the op returns (``use_oplog`` / "R" — log Reproducing), making
    delayed/batched memory-log flushes crash-safe,
  * a two-tier slab allocator.

Variant matrix (Table 3): naive = R,C,B all off; rNVM-R = R; rNVM-RC = R+C;
rNVM-RCB = R+C+B.  ``symmetric=True`` models the paper's symmetric baseline
(data structure in *local* NVM, logs streamed to a remote mirror
asynchronously); ``sym_batch`` is the Symmetric-B row.

Timing: sync remote rounds charge RTT + transfer against this front-end's
clock; pipelined (async) writes charge only the post overhead plus link
occupancy; group-committed op logs charge one round per group (classic group
commit).  The blade's NIC serializes transfers across front-ends, giving
natural contention for the sharing experiments.

Batch execution path: ``read_many`` / ``prefetch_many`` are doorbell-batched
vector reads (one issue + one RTT per wave, a cheap WQE post per extra
item); ``batch(h)`` / ``execute_batch(h, ops)`` suspend the flush cadence so
a whole group of operations stages its op logs and memory logs together and
lands with one combined flush at the end of the window.

Read target routing: every remote read resolves an (addr, size) request to
a *target blade* — the handle's primary, or one of its mirror endpoints
when a ``ReadPolicy`` is in scope (``replica_reads``).  Mirrors are
separate physical blades with their own NICs, eligible only within the
policy's bounded-staleness contract (replica lag measured against the
mirror's applied ``{name}.seq`` watermark); writes always target the
primary.

The *write* side mirrors it:

  * ``write_wave()`` opens a doorbell write wave: every posted-write round
    issued inside (slab-refill/free RPCs, sync op-log group commits) pays
    ``issue_ns`` for the first WQE and ``doorbell_wqe_ns`` per extra one,
    with the completion (RTT + NVM write) charged once when the wave closes
    — the vector-op analogue of pipelining the batch's allocation RPCs and
    group commits behind the apply compute.  Data-structure ops inside a
    wave charge ``cpu_batch_op_ns`` instead of ``cpu_op_ns`` (one software
    dispatch for the whole batch).  All ``*_many`` entry points run inside
    a wave.
  * ``write_many(h, writes)`` stages a batch of apply-phase writes exactly
    as the serial loop would (same bytes, same order — the arena stays
    byte-identical) but charges the staging cost per *combined WQE*:
    adjacent-address writes merge into one.
  * ``batch_all()`` generalizes ``batch(h)`` across every handle this
    front-end owns: ops touching several structures on one blade stage
    together and drain with ONE combined oplog+memlog posted write for the
    whole blade (op-log bytes first, per handle — see below).
  * the wave *width* (WQEs per doorbell before re-ringing) is adaptive:
    picked from the observed cache miss-ratio and the blade link's epoch
    utilization inside a ``CostModel``-derived floor/ceiling band
    (``wave_floor``/``wave_ceiling``); ``FEConfig.fixed_wave=N`` pins it
    for deterministic tests.

Group/window commit point: every op-log flush writes the entry bytes first
and the persisted ``{name}.seq`` watermark slot *after* them, and recovery
(``unreplayed_oplogs``) replays only entries at or below the watermark — so
a flush torn anywhere before the watermark write makes the whole group
invisible (all-or-none), and entries are never replayed while newer bytes
for the same seq exist later in the log (last-wins dedup).

Combined oplog+memlog flush ordering argument: when a memory-log flush finds
staged op-log entries, both channels go out as ONE posted write whose
payload places the op-log bytes *before* the memory-log transaction.  NVM
persists the write in order, so the op log is durable no later than the data
it covers: if the write tears inside the op-log bytes, the covered memory
logs never landed either (the tx checksum drops them at recovery) and the
surviving op-log prefix replays exactly the surviving ops; if it tears
inside the memory-log bytes, the op log is already whole and replay
regenerates the lost memory logs.  The ordering invariant of the two-round
scheme (op logs durable before or with their data) is preserved while the
separate ``flush_oplog`` round disappears from the batch path.

The front end is the host, and the blade's arena may live on a card
(``repro_torch.core.backend``): a single read is one copy from it, and a
doorbell read wave one gather on the device and one copy back
(``NVMBackend.gather``), split into the wave's requests in order — the
batching the simulator charges for.  The page cache and the links stay on
the host in numpy: the virtual clock's bits depend on numpy's float64 sums
and on the cache's PCG64 draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .allocator import FrontEndAllocator
from .backend import CrashError, LogArea, NVMBackend, StaleWriterError
from .cache import PageCache
from .oplog import (MemLog, OpLog, committed_tail, encode_epoch_mark,
                    encode_oplog, encode_tx)
from .sim import Clock, CostModel, Stats
from .. import obs
from ..obs.hist import LatencyHistogram
from ..obs.profile import profile


class LinkTimeout(CrashError):
    """A posted round's completion never arrived within the operation
    deadline (dropped WQE / unresponsive NIC).  Internal to the front-end's
    retry loop; subclasses CrashError so an escape still heals upstream."""


class EndpointUnreachable(CrashError):
    """Retries exhausted or circuit breaker open for a blade's link: the
    endpoint is declared unreachable.  The cluster layer reacts by probing
    the blade and rebinding, rebooting, or fencing + promoting its mirror."""


def _jitter01(x: int) -> float:
    """Deterministic hash of `x` to [0, 1) — backoff jitter must decorrelate
    retry storms across front-ends without breaking replayability."""
    x = (x * 0x9E3779B97F4A7C15 + 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 29
    return (x >> 11) / float(1 << 53)


class CircuitBreaker:
    """Per-link failure accounting: consecutive timeouts open the breaker,
    making further rounds fail fast (``EndpointUnreachable``) until the
    cooldown elapses; one success closes it.  The breaker object lives ON
    the ``Link`` (see ``Link.breaker``) so its state survives a front-end
    rebind — the endpoint is sick, not the client object.  After the
    cooldown the breaker is implicitly half-open: attempts flow again, a
    failure re-stamps the open window, a success resets everything."""

    __slots__ = ("cost", "failures", "opened_at", "trips")

    def __init__(self, cost: CostModel):
        self.cost = cost
        self.failures = 0
        self.opened_at: Optional[float] = None
        self.trips = 0

    def is_open(self, now: float) -> bool:
        return (self.opened_at is not None
                and now - self.opened_at < self.cost.breaker_cooldown_ns)

    def record_failure(self, now: float) -> bool:
        """Count one timeout; returns True when this failure newly opened
        the breaker (the caller counts the trip and stops retrying)."""
        self.failures += 1
        if self.failures >= self.cost.breaker_threshold:
            newly = self.opened_at is None
            self.opened_at = now
            if newly:
                self.trips += 1
            return newly
        return False

    def record_success(self) -> None:
        self.failures = 0
        self.opened_at = None

    @property
    def state(self) -> str:
        return "closed" if self.opened_at is None else "open"


def combine_runs(reqs: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge (addr, size) requests into contiguous (addr, nbytes) runs —
    the adjacent-address WQE combining shared by read waves and
    ``write_many``.  Duplicate requests collapse (they coalesce in the
    cache / write buffer anyway)."""
    runs: List[Tuple[int, int]] = []
    for addr, size in sorted(set(reqs)):
        if runs and addr == runs[-1][0] + runs[-1][1]:
            runs[-1] = (runs[-1][0], runs[-1][1] + size)
        else:
            runs.append((addr, size))
    return runs


@dataclasses.dataclass
class ReadPolicy:
    """How a front-end resolves the *target blade* for remote reads.

    ``mode``:

      * ``"primary"`` — always the handle's primary blade (the implicit
        policy when none is set);
      * ``"mirror"``  — the primary's mirror ``mirror_idx`` whenever its
        replica lag is within ``max_staleness_ops``, else fall back to the
        primary (counted in ``Stats.replica_fallbacks``);
      * ``"auto"``    — the least-utilized link among the primary and every
        staleness-eligible mirror: read waves spread over all the physical
        blades that hold the bytes, which is where the replica-read
        bandwidth win comes from.

    ``max_staleness_ops`` is the advertised bound of the contract: a replica
    read is only routed to a mirror whose applied watermark is at most that
    many acked ops behind the reader's committed tail.  Replica routing is
    for READ-ONLY operations: traversals that feed a write must see the
    primary (the sharded layer scopes the policy around its get paths via
    ``FrontEnd.replica_reads``).  Read-your-writes is preserved one level
    up: ``ShardedStructure._note_write`` pins every written key at its
    write's op-seq, and its reads stay on the primary until the mirrors'
    applied watermark passes that seq."""

    mode: str = "auto"
    max_staleness_ops: int = 0
    mirror_idx: int = 0


class ReadTarget:
    """A resolved read endpoint: the primary blade or one of its mirrors.

    ``read``/``read_many``/``prefetch_many`` resolve an (addr, size) request
    to a target once per call/wave and then charge the transfer against the
    *target's* link — a mirror is a separate physical blade with its own
    NIC, so replica reads neither queue behind the primary's write traffic
    nor require the primary to be alive."""

    __slots__ = ("backend", "mirror_idx")

    def __init__(self, backend: NVMBackend, mirror_idx: Optional[int] = None):
        self.backend = backend
        self.mirror_idx = mirror_idx

    @property
    def is_replica(self) -> bool:
        return self.mirror_idx is not None

    @property
    def link(self):
        if self.mirror_idx is None:
            return self.backend.link
        return self.backend.mirrors[self.mirror_idx].link

    @property
    def cache_safe(self) -> bool:
        """Whether fetched bytes may enter the front-end page cache: the
        cache outlives the ``replica_reads`` policy scope, so bytes from a
        *lagging* mirror must not be inserted (a later primary-routed read
        would hit them and silently extend the staleness contract past its
        scope).  A synchronous mirror serves byte-identical data — safe."""
        if self.mirror_idx is None:
            return True
        return self.backend.mirrors[self.mirror_idx].synchronous

    def fetch(self, addr: int, size: int) -> bytes:
        if self.mirror_idx is None:
            return self.backend.read(addr, size)
        return self.backend.read_replica(addr, size, self.mirror_idx)


@dataclasses.dataclass
class FEConfig:
    use_oplog: bool = True          # R: operation-log reproducing
    use_cache: bool = True          # C: front-end DRAM cache
    use_batch: bool = True          # B: batching / vector ops
    batch_ops: int = 1024           # memory-log flush cadence (ops)
    oplog_group: int = 64           # op-log group-commit size (B on)
    oplog_pipeline: int = 4         # outstanding op-log writes (B off)
    cache_bytes: int = 6 << 20
    cache_policy: str = "hybrid"
    cpu_node_ns: float = 300.0      # software cost per node visit
    symmetric: bool = False         # paper's symmetric baseline
    sym_batch: bool = False         # Symmetric-B row
    fixed_wave: Optional[int] = None  # pin the doorbell wave width (tests)
    max_retries: int = 3            # resends after a timed-out round before
                                    # the endpoint is declared unreachable
    result_cache_entries: int = 0   # front-end result-cache capacity for
                                    # sharded structures bound to this FE
                                    # (decoded key->value tier above the
                                    # page cache; 0 = off, the default —
                                    # see repro_torch.core.cache.ResultCache)

    @classmethod
    def naive(cls, **kw) -> "FEConfig":
        return cls(use_oplog=False, use_cache=False, use_batch=False, **kw)

    @classmethod
    def r(cls, **kw) -> "FEConfig":
        return cls(use_oplog=True, use_cache=False, use_batch=False, **kw)

    @classmethod
    def rc(cls, **kw) -> "FEConfig":
        return cls(use_oplog=True, use_cache=True, use_batch=False, **kw)

    @classmethod
    def rcb(cls, **kw) -> "FEConfig":
        return cls(use_oplog=True, use_cache=True, use_batch=True, **kw)


class StructHandle:
    """Per-data-structure state on a front-end: log areas + write buffer."""

    def __init__(self, fe: "FrontEnd", name: str, oplog: LogArea, txlog: LogArea):
        self.fe = fe
        self.name = name
        self.oplog_area = oplog
        self.txlog_area = txlog
        self.wbuf: Dict[int, bytes] = {}          # addr -> whole-node bytes
        self.pending_ops = 0                       # ops since last memlog flush
        self.seq = 0                               # operation sequence number
        self.oplog_staged: List[bytes] = []
        self.oplog_staged_ops = 0
        # write-lease fencing (0 = unfenced single-writer legacy path):
        # every flush of this handle carries `writer_epoch` and the blade
        # rejects it if the structure's fence slot has moved past it.  The
        # op stream is stamped with an epoch-marker record once per epoch
        # (`_staged_epoch` tracks what the staged window already carries).
        self.writer_epoch = 0
        self._staged_epoch: Optional[int] = None
        # structures may defer materialization (stack/queue compaction);
        # the hook runs right before a memory-log flush.
        self.pre_flush = None
        self.post_flush = None  # e.g. multi-version root CAS after durability
        self._in_preflush = False
        self._in_batch = False  # inside FrontEnd.batch(): flush cadence off
        self._op_t0 = None      # op span start, set only while tracing

    @property
    def opsn_name(self) -> str:
        return f"{self.name}.opsn"


class WaveSizer:
    """Adaptive doorbell-wave width: how many WQEs ring per doorbell before
    the front-end re-issues (reads) or fences (writes).

    The controller replaces the caller's chunking: a high observed cache
    miss-ratio means waves are doing real remote work, so widening amortizes
    more ``issue_ns``; a hot blade link (epoch utilization) means wide waves
    just queue behind themselves, so the width backs off.  The band is
    derived from the ``CostModel`` (``wave_floor``/``wave_ceiling``), and
    ``FEConfig.fixed_wave=N`` pins the width for deterministic tests.
    """

    def __init__(self, fe: "FrontEnd"):
        self.fe = fe
        cost = fe.cost
        self.floor = cost.wave_floor()
        self.ceiling = cost.wave_ceiling(fe.backend.link.epoch)
        self._width = min(64, self.ceiling)

    @property
    def width(self) -> int:
        fixed = self.fe.cfg.fixed_wave
        if fixed:
            return max(1, fixed)
        return self._width

    def observe(self, local_hits: int, remote: int) -> None:
        """Feed one wave's outcome back into the width."""
        if self.fe.cfg.fixed_wave:
            return
        total = local_hits + remote
        if not total:
            return
        if self.fe.backend.link.utilization(self.fe.clock.now) > 0.85:
            self._width = max(self.floor, self._width // 2)
        elif remote / total > 0.5:
            self._width = min(self.ceiling, self._width * 2)
        elif remote / total < 0.05:
            self._width = max(self.floor, self._width - self.floor)


class FrontEnd:
    def __init__(self, backend: NVMBackend, config: Optional[FEConfig] = None, fe_id: int = 0):
        self.backend = backend
        self.cfg = config or FEConfig()
        self.fe_id = fe_id
        self.cost = backend.cost
        self.clock = Clock()
        self.stats = Stats()
        self.cache = PageCache(self.cfg.cache_bytes, self.cfg.cache_policy, seed=fe_id)
        self.allocator = FrontEndAllocator(self)
        self._oplog_inflight = 0
        self.busy_ns = 0.0  # front-end CPU busy time (utilization bench)
        self.handles: List[StructHandle] = []  # every handle this FE registered
        self.waves = WaveSizer(self)
        # replica read routing: None = primary-only.  Scoped via the
        # `replica_reads` context manager around read-only call sequences.
        self.read_policy: Optional[ReadPolicy] = None
        # per-scope pinned read targets ({handle name -> ReadTarget}):
        # populated by `replica_reads` so one traversal reads one arena
        self._target_pin: Optional[Dict[str, "ReadTarget"]] = None
        # open doorbell write wave; posted-write completions are deferred to
        # the wave close fence.  `_wave_linger` marks a wave the adaptive
        # controller keeps open across consecutive vector-op calls (the
        # controller, not the caller's chunking, picks the effective window:
        # it rolls the wave over at the flush cadence and `drain` fences it).
        self._wave_depth = 0
        self._wave_linger = False
        self._wave_posts = 0
        self._wave_ops = 0
        self._wave_end = 0.0
        # per-op-type sim-latency histograms (always on; see repro_torch.obs.hist)
        self.op_hist: Dict[str, LatencyHistogram] = {}
        # sim-time tracing: None unless an obs session with trace=True was
        # active at construction — every hot-path hook is one attr check
        self.trace = None
        self._tk = None
        sess = obs.session()
        if sess is not None:
            sess.register_frontend(self)
            tr = sess.tracer
            if tr is not None:
                self.trace = tr
                self._tk = tr.track(f"fe{fe_id}.b{backend.blade_id}")
                tr.attach_link(backend.link, f"blade{backend.blade_id}.link")
                for mi, m in enumerate(backend.mirrors):
                    tr.attach_link(m.link, f"blade{backend.blade_id}.m{mi}.link")

    # ========================================================= observability
    def record_op_latency(self, op: str, dur_ns: float, n: int = 1) -> None:
        """Fold ``n`` occurrences of a ``dur_ns`` sim-latency into this
        front-end's per-op-type histogram (batch windows record the window
        latency once per item).

        These are closed-loop **service** times (call to return on this
        front-end's clock), surfaced as ``service_p*`` bench columns — not
        arrival-to-completion latency, which only the open-loop engine
        (``repro_torch.core.sim.OpenLoopEngine``) can measure."""
        h = self.op_hist.get(op)
        if h is None:
            h = self.op_hist[op] = LatencyHistogram()
        h.record(dur_ns, n)

    # ==================================================== read target routing
    @contextlib.contextmanager
    def replica_reads(self, policy: Optional[ReadPolicy]):
        """Scope a ``ReadPolicy`` over a read-only call sequence: remote
        reads inside resolve their target blade through the policy (mirror
        endpoints become eligible); on exit the previous policy is restored.
        Passing None is a no-op scope (primary-only).

        The resolved target is PINNED per handle for the scope's duration:
        a pointer-chasing traversal issues several dependent read waves, and
        letting each wave re-pick its endpoint would walk a *mixed* cut —
        e.g. a bucket head from the primary pointing at node bytes a lagging
        mirror has not applied yet, which makes even staleness-covered keys
        unreachable.  One endpoint per scope means one consistent arena (the
        primary, or a single mirror's prefix cut) for the whole traversal;
        load still spreads across endpoints scope-to-scope."""
        prev = self.read_policy
        prev_pin = self._target_pin
        self.read_policy = policy
        self._target_pin = {} if policy is not None else None
        try:
            yield
        finally:
            self.read_policy = prev
            self._target_pin = prev_pin

    def _read_target(self, h: StructHandle) -> ReadTarget:
        pin = self._target_pin
        if pin is None:
            return self._resolve_read_target(h)
        tgt = pin.get(h.name)
        if tgt is not None:
            return tgt
        tgt = self._resolve_read_target(h)
        # pin only when some mirror actually lags: synchronous mirrors are
        # byte-identical to the primary, so per-wave re-picking (load
        # spreading) cannot mix cuts there.  Lag state cannot change inside
        # a read-only scope (single-writer sim), so deciding once is sound.
        if any(not m.synchronous for m in self.backend.mirrors):
            pin[h.name] = tgt
        return tgt

    def _resolve_read_target(self, h: StructHandle) -> ReadTarget:
        """Resolve where the next remote read (wave) for `h` is served.

        Mirrors are eligible only when their replica lag — this front-end's
        committed tail minus the mirror's applied ``{name}.seq`` watermark,
        both free local/piggybacked knowledge — is within the policy's
        staleness bound; an over-lag mirror falls back to the primary
        (``Stats.replica_fallbacks``).  ``"auto"`` picks the least-utilized
        link among the eligible endpoints, spreading read waves over every
        physical blade that holds the bytes."""
        pol = self.read_policy
        be = self.backend
        now = self.clock.now

        def _tripped(lk) -> bool:
            br = lk.breaker
            return br is not None and br.is_open(now)

        if pol is None or pol.mode == "primary" or not be.mirrors:
            return ReadTarget(be)
        if pol.mode == "mirror":
            idx = pol.mirror_idx % len(be.mirrors)
            if (be.replica_lag_ops(h.name, h.seq, idx) > pol.max_staleness_ops
                    or _tripped(be.mirrors[idx].link)):
                self.stats.replica_fallbacks += 1
                return ReadTarget(be)
            return ReadTarget(be, idx)
        # auto: primary + every staleness-eligible mirror, least-utilized.
        # Endpoints whose circuit breaker is open are excluded: an open
        # primary breaker degrades reads to the replicas (still within the
        # staleness bound — graceful degradation while no writable primary
        # exists); if every endpoint is tripped, the primary is attempted
        # anyway so the failure surfaces and recovery runs.
        candidates: List[Optional[int]] = []
        if not _tripped(be.link):
            candidates.append(None)
        eligible = False
        for idx in range(len(be.mirrors)):
            if be.replica_lag_ops(h.name, h.seq, idx) <= pol.max_staleness_ops:
                eligible = True
                if not _tripped(be.mirrors[idx].link):
                    candidates.append(idx)
        if not eligible:
            self.stats.replica_fallbacks += 1
        if not candidates:
            return ReadTarget(be)
        if candidates[0] is not None:
            self.stats.degraded_reads += 1
            obs.count("degraded_reads")
        best = min(
            candidates,
            key=lambda i: (ReadTarget(be, i).link.utilization(now), -1 if i is None else i),
        )
        return ReadTarget(be, best)

    # ==================================================== deadlines & retries
    def _link_breaker(self, link) -> CircuitBreaker:
        br = link.breaker
        if br is None:
            br = link.breaker = CircuitBreaker(self.cost)
        return br

    def _fault_gate(self, link, br: CircuitBreaker) -> None:
        """Consume armed link faults before a round charges: a stall window
        is pure delay, a duplicated WQE burns capacity + issue time, a
        dropped completion costs one operation deadline and raises
        ``LinkTimeout`` (the blade-side write, if any, already happened —
        the loss is the ACK, so resends are idempotent)."""
        f = link.fault
        if f is None:
            return
        now = self.clock.now
        if f.stall_until > now:
            f.stalls += 1
            if self.trace is not None:
                self.trace.span(self._tk, "nic_stall", now, f.stall_until)
            self.clock.advance_to(f.stall_until)
        if f.dup_pending > 0:
            f.dup_pending -= 1
            f.dups += 1
            link.transfer(self.clock.now, 64)
            self.clock.advance(self.cost.issue_ns)
        if f.drop_pending > 0:
            f.drop_pending -= 1
            f.drops += 1
            self.stats.op_timeouts += 1
            self.clock.advance(self.cost.op_timeout_ns)
            opened = br.record_failure(self.clock.now)
            tr = self.trace
            if tr is not None:
                tr.instant(self._tk, "wqe_timeout", self.clock.now)
                if opened:
                    tr.instant(self._tk, "breaker_open", self.clock.now)
            if opened:
                self.stats.breaker_trips += 1
                obs.count("breaker_trips")
            raise LinkTimeout("posted round timed out (completion dropped)")

    def _with_deadline(self, link, fn):
        """Run a remote round under the operation-deadline discipline:
        bounded resends with exponential backoff + deterministic jitter
        charged to the clock, a per-link circuit breaker fed by consecutive
        timeouts, fail-fast (``EndpointUnreachable``) while the breaker is
        open.  On a healthy link (no armed fault, no breaker object) this
        is a single attribute check around ``fn()`` — the fault-free path
        stays sim-time identical."""
        if link.fault is None and link.breaker is None:
            return fn()
        br = self._link_breaker(link)
        attempt = 0
        while True:
            if br.is_open(self.clock.now):
                raise EndpointUnreachable(
                    f"circuit breaker open for blade {self.backend.blade_id}")
            try:
                self._fault_gate(link, br)
                out = fn()
                br.record_success()
                return out
            except LinkTimeout:
                attempt += 1
                if attempt > self.cfg.max_retries or br.is_open(self.clock.now):
                    raise EndpointUnreachable(
                        f"blade {self.backend.blade_id} unreachable after "
                        f"{attempt - 1} retries") from None
                back = self.cost.retry_backoff_ns * (2 ** (attempt - 1))
                back *= 1.0 + self.cost.retry_jitter * _jitter01(
                    ((self.fe_id + 1) << 20) ^ (attempt << 12)
                    ^ (int(self.clock.now) & 0xFFFFF))
                t0 = self.clock.now
                self.clock.advance(back)
                self.stats.op_retries += 1
                obs.count("retries_total")
                if self.trace is not None:
                    self.trace.span(self._tk, "retry_backoff", t0,
                                    self.clock.now, {"attempt": attempt})

    # ======================================================== network charges
    def _round(self, nbytes: int, *, nvm_write: bool = False, link=None) -> None:
        """A synchronous one-sided round: post, transfer, completion.

        Write-class rounds (``nvm_write=True``: allocation/free RPCs, sync
        op-log group commits) inside an open write wave post into the wave
        instead — their completions are what the wave-close fence waits for.
        Read rounds always complete synchronously (their data is needed
        now), wave or no wave.  ``link`` overrides the transfer resource
        (replica reads charge the mirror blade's NIC)."""
        if nvm_write and self._wave_active():
            self._wave_post(nbytes)
            return
        lk = link or self.backend.link
        if lk.fault is not None or lk.breaker is not None:
            self._guarded_round(lk, nbytes, nvm_write)
            return
        start = self.clock.now + self.cost.issue_ns
        end = lk.transfer(start, nbytes)
        extra = self.cost.nvm_write_ns if nvm_write else self.cost.nvm_read_ns
        self.clock.advance_to(end + self.cost.rtt_ns + extra)

    def _guarded_round(self, lk, nbytes: int, nvm_write: bool) -> None:
        """The ``_round`` charge under the deadline/retry discipline (split
        out so the hot fault-free path allocates no closure)."""
        def once():
            start = self.clock.now + self.cost.issue_ns
            end = lk.transfer(start, nbytes)
            extra = self.cost.nvm_write_ns if nvm_write else self.cost.nvm_read_ns
            self.clock.advance_to(end + self.cost.rtt_ns + extra)
        self._with_deadline(lk, once)

    def _pipelined_write(self, nbytes: int) -> None:
        """Posted write without waiting for the completion (durability comes
        from the op log, so memory-log flushes may overlap computation).
        Inside an open write wave the post rides the rung doorbell: a cheap
        WQE instead of a fresh issue."""
        if self._wave_active() and self._wave_posts:
            self.clock.advance(self.cost.doorbell_wqe_ns)
        else:
            self.clock.advance(self.cost.issue_ns)
        self.backend.link.transfer(self.clock.now, nbytes)

    def _wave_active(self) -> bool:
        return self._wave_depth > 0 or self._wave_linger

    def _wave_post(self, nbytes: int) -> None:
        """Post one write-class WQE into the open wave: first of a doorbell
        pays the full issue, the rest the cheap WQE cost; the wave width
        bounds WQEs per doorbell before re-ringing."""
        first = self._wave_posts % self.waves.width == 0
        self.clock.advance(self.cost.issue_ns if first else self.cost.doorbell_wqe_ns)
        end = self.backend.link.transfer(self.clock.now, nbytes)
        if end > self._wave_end:
            self._wave_end = end
        self._wave_posts += 1
        self.stats.wqe_posts += 1

    def _close_wave(self) -> None:
        """Completion fence: one RTT + NVM write for everything the wave
        posted (the batch's RPC responses / write completions stream back
        while the front-end computes; it blocks once, here)."""
        if self._wave_posts:
            self.stats.write_waves += 1
            tr = self.trace
            t0 = self.clock.now
            posts, ops = self._wave_posts, self._wave_ops
            lk = self.backend.link
            try:
                if lk.fault is None and lk.breaker is None:
                    self.clock.advance_to(
                        self._wave_end + self.cost.rtt_ns + self.cost.nvm_write_ns)
                else:
                    # the fence is the posted writes' deadline point: a lost
                    # fence completion times out and is re-waited; exhausted
                    # retries surface EndpointUnreachable with the wave state
                    # reset (the posts are lost/uncertain — recovery re-runs)
                    self._with_deadline(
                        lk,
                        lambda: self.clock.advance_to(
                            self._wave_end + self.cost.rtt_ns
                            + self.cost.nvm_write_ns))
            finally:
                self._wave_posts = 0
                self._wave_ops = 0
                self._wave_end = 0.0
            if tr is not None:
                tr.span(self._tk, "wave_fence", t0, self.clock.now,
                        {"posts": posts, "ops": ops})
        else:
            self._wave_posts = 0
            self._wave_ops = 0
            self._wave_end = 0.0

    @contextlib.contextmanager
    def write_wave(self, linger: bool = False):
        """A doorbell write wave window — the write-side analogue of
        ``read_many``'s doorbell batch.  Posted-write rounds issued inside
        (slab refills, op-log group commits, memory-log flushes) share
        doorbells and defer their completions to one close fence; structure
        ops charge the vector-op CPU cost.  Nested waves are no-ops; the
        naive/symmetric paths keep their own discipline.

        ``linger=True`` hands the wave to the adaptive controller instead of
        fencing at context exit: consecutive vector-op calls share one wave
        (the effective window is the controller's, not the caller's
        chunking), rolled over at the memory-log flush cadence and fenced
        by ``end_wave`` / ``drain`` — or by the next *serial* ``op_begin``,
        so a lingering wave never leaks its batch cost accounting into
        serial ops.  Ops in a lingering wave are posted but not yet fenced
        — the same bounded-loss window as an op-log group commit, recovered
        all-or-none via the seq watermark."""
        if not self.cfg.use_batch or self.cfg.symmetric:
            yield
            return
        if self._wave_linger and self._wave_depth == 0:
            self._wave_linger = False  # adopt the lingering wave ...
            if self._wave_ops >= self.cfg.batch_ops:
                self._close_wave()     # ... unless its window aged out
        self._wave_depth += 1
        try:
            yield
        finally:
            self._wave_depth -= 1
            if self._wave_depth == 0:
                if linger:
                    self._wave_linger = True
                else:
                    self._close_wave()

    def end_wave(self) -> None:
        """Fence a lingering write wave (commit point for posted vector-op
        windows); no-op when no wave is open."""
        if self._wave_linger and self._wave_depth == 0:
            self._wave_linger = False
            self._close_wave()

    def _atomic(self, addr: int = 0) -> None:
        self.clock.advance(self.cost.atomic_ns)
        end = self.backend.link.transfer(self.clock.now, 8)
        # atomics to the same 8-byte location serialize at the blade NIC
        window = int(self.clock.now // 100_000.0)
        bucket = (addr, window)
        seen = self.backend._atomic_contention
        # bounded state: when this blade's time moves to a new window, drop
        # every bucket from older windows (they can never be hit again except
        # by a front-end still behind in virtual time, whose late buckets are
        # themselves dropped on the next advance) — long runs stay O(live).
        if window > self.backend._atomic_window:
            self.backend._atomic_window = window
            stale = [k for k in seen if k[1] < window]
            for k in stale:
                del seen[k]
        n = seen.get(bucket, 0)
        seen[bucket] = n + 1
        self.clock.advance_to(end + n * 400.0)

    def _charge_node(self) -> None:
        self.clock.advance(self.cfg.cpu_node_ns)
        self.busy_ns += self.cfg.cpu_node_ns

    def _charge_local_alloc(self) -> None:
        # tier-2 slab carve.  Inside a write wave the allocator serves the
        # batch from contiguous chunk runs in one free-list pass, so each
        # item pays only the vector-op per-item share of the carve instead
        # of the full per-call dispatch.
        self.clock.advance(self.cost.cpu_batch_op_ns if self._wave_active() else 100.0)

    # ========================================================== registration
    def register(self, name: str, oplog_blocks: int = 4096, txlog_blocks: int = 4096) -> StructHandle:
        """Create (or re-attach to) a structure's log areas + naming entries."""
        be = self.backend
        opname, txname = f"{name}.oplog", f"{name}.txlog"
        if opname in be._log_areas:
            h = StructHandle(self, name, be.get_log_area(opname), be.get_log_area(txname))
            h.seq = be.get_name(f"{name}.seq")
            self.handles.append(h)
            return h
        op = be.create_log_area(opname, oplog_blocks)
        tx = be.create_log_area(txname, txlog_blocks)
        be.set_name(f"{name}.seq", 0)
        be.set_name(f"{name}.opsn", 0)
        self._round(64)  # registration RPC
        h = StructHandle(self, name, op, tx)
        self.handles.append(h)
        return h

    # ============================================================ allocation
    def _backend_alloc(self, nblocks: int) -> int:
        # RFP-style RPC: request via RDMA_Write, response via RDMA_Read.
        self._round(32, nvm_write=True)
        return self.backend.alloc_blocks(nblocks)

    def _backend_free(self, addr: int, nblocks: int) -> None:
        self._round(32, nvm_write=True)
        self.backend.free_blocks(addr, nblocks)

    def alloc(self, size: int) -> int:
        return self.allocator.alloc(size)

    def free(self, addr: int, size: int = 0) -> None:
        self.allocator.free(addr, size)

    # ================================================================= reads
    def read(self, h: StructHandle, addr: int, size: int, *, cacheable: bool = True) -> bytes:
        """Gather step: write-buffer overlay -> cache -> remote target blade
        (the handle's primary, or a mirror endpoint under a ReadPolicy)."""
        self._charge_node()
        staged = h.wbuf.get(addr)
        if staged is not None and len(staged) >= size:
            return bytes(staged[:size])
        if self.cfg.symmetric:
            self.clock.advance(self.cost.nvm_read_ns)
            return self.backend.read(addr, size)
        if self.cfg.use_cache and cacheable:
            page = self.cache.get(addr)
            if page is not None and len(page) >= size:
                self.stats.cache_hits += 1
                self.clock.advance(self.cost.dram_ns)
                return bytes(page[:size])
            self.stats.cache_misses += 1
        tgt = self._read_target(h)
        data = tgt.fetch(addr, size)
        self.stats.rdma_reads += 1
        self.stats.bytes_read += size
        if tgt.is_replica:
            self.stats.replica_reads += 1
        self._round(size, link=tgt.link)
        if self.cfg.use_cache and cacheable and tgt.cache_safe:
            self.cache.put(addr, data)
        return data

    def _doorbell_wave(self, remote: List[Tuple[int, int, int]], *, cacheable: bool,
                       target: Optional[ReadTarget] = None) -> Dict[int, bytes]:
        """Charge one doorbell-batched read wave and fetch every (i, addr,
        size) request: the first WQE of each doorbell pays the full issue
        cost (ringing it), each further WQE only the cheap post, and the
        whole wave shares a single RTT + NVM read latency.  The adaptive
        wave width bounds WQEs per doorbell — a request past it re-rings
        (fresh issue) but still completes with the shared fence.  Requests
        for adjacent addresses combine into one WQE (a single range read —
        bulk-built nodes are carved from contiguous slabs, so sibling scans
        collapse to a few messages).  The whole wave goes to ONE resolved
        ``target`` endpoint (primary or mirror) and charges that blade's
        link."""
        tgt = target or ReadTarget(self.backend)
        tr = self.trace
        t0 = self.clock.now
        cost = self.cost
        with profile("wave_build"):
            runs = combine_runs([(a, s) for _, a, s in remote])
            width = self.waves.width

            def charge():
                if len(runs) > 1:
                    # vectorized WQE stream: every run's post gap + link
                    # transfer in one epoch-chunked pass (transfer_many)
                    wqe_ns = cost.doorbell_wqe_ns
                    issue_ns = cost.issue_ns
                    gaps = [
                        issue_ns if i % width == 0 else wqe_ns
                        for i in range(len(runs))
                    ]
                    ends = tgt.link.transfer_many(
                        self.clock.now, gaps, [nb for _, nb in runs]
                    )
                    start = float(ends[-1])
                else:
                    start = self.clock.now
                    for i, (_, nbytes) in enumerate(runs):
                        start += cost.issue_ns if i % width == 0 else cost.doorbell_wqe_ns
                        start = tgt.link.transfer(start, nbytes)
                self.clock.advance_to(start + cost.rtt_ns + cost.nvm_read_ns)

            if tgt.link.fault is None and tgt.link.breaker is None:
                charge()
            else:
                # read-wave deadline: a timed-out wave re-charges whole (the
                # doorbell is re-rung; data is fetched only after success)
                self._with_deadline(tgt.link, charge)
        if tr is not None:
            tr.span(self._tk, "read_wave", t0, self.clock.now,
                    {"wqes": len(runs), "items": len(remote),
                     "bytes": sum(n for _, n in runs), "width": width,
                     "replica": tgt.is_replica})
            if self.cfg.use_cache:
                c = self.cache
                tr.counter(self._tk, "cache", self.clock.now,
                           {"hits": c.hits, "misses": c.misses,
                            "evictions": c.evictions})
        out: Dict[int, bytes] = {}
        st = self.stats
        st.rdma_reads += len(remote)
        if tgt.is_replica:
            st.replica_reads += len(remote)
        # the wave's fetch: straight off the resolved arena (primary or
        # synchronous mirror), one aliveness check for the whole wave and
        # one gather (on a card: one device gather, one copy to the host)
        if tgt.mirror_idx is None:
            tgt.backend._check_alive()
            blade = tgt.backend
        else:
            blade = tgt.backend.mirrors[tgt.mirror_idx]
        datas = blade.gather([(addr, size) for _, addr, size in remote])
        nbytes = 0
        if self.cfg.use_cache and cacheable and tgt.cache_safe:
            items = []
            for (i, addr, size), data in zip(remote, datas):
                out[i] = data
                items.append((addr, data))
                nbytes += size
            self.cache.admit_many(items)
        else:
            for (i, addr, size), data in zip(remote, datas):
                out[i] = data
                nbytes += size
        st.bytes_read += nbytes
        return out

    def read_many(self, h: StructHandle, reqs: List[Tuple[int, int]], *, cacheable: bool = True) -> List[bytes]:
        """Doorbell-batched independent reads (vector ops): one issue + one
        RTT for the batch, a cheap WQE post per extra item.  Falls back to
        serial reads when batching is off."""
        if not self.cfg.use_batch or len(reqs) <= 1:
            return [self.read(h, a, s, cacheable=cacheable) for a, s in reqs]
        n = len(reqs)
        # aggregated charges: the per-item CPU visit cost and per-hit DRAM
        # cost are pure clock adds, so summing them once is time-identical
        # to interleaving them with the probes
        cpu = self.cfg.cpu_node_ns * n
        self.clock.advance(cpu)
        self.busy_ns += cpu
        out: List[Optional[bytes]] = [None] * n
        remote: List[Tuple[int, int, int]] = []
        append = remote.append
        wbuf_get = h.wbuf.get
        use_cache = self.cfg.use_cache and cacheable
        hits = 0
        staged_hits = 0
        if use_cache:
            # inlined PageCache.get: same probe/recency/counter semantics,
            # without a method call per request (this loop runs once per
            # key per tree level on the batched read path)
            cache = self.cache
            pages_get = cache.pages.get
            cpos = cache._addr_pos
            cticks = cache._ticks
            ctick = cache.tick
            c_hits = 0
            c_miss = 0
            wbuf_get = wbuf_get if h.wbuf else None  # skip probe when empty
            for i, (addr, size) in enumerate(reqs):
                if wbuf_get is not None:
                    staged = wbuf_get(addr)
                    if staged is not None and len(staged) >= size:
                        out[i] = bytes(staged[:size])
                        staged_hits += 1
                        continue
                ctick += 1
                page = pages_get(addr)
                if page is None:
                    c_miss += 1
                else:
                    c_hits += 1
                    cticks[cpos[addr]] = ctick
                    if len(page) >= size:
                        hits += 1
                        out[i] = bytes(page[:size])
                        continue
                append((i, addr, size))
            cache.tick = ctick
            cache.hits += c_hits
            cache.misses += c_miss
            self.stats.cache_hits += hits
            self.stats.cache_misses += n - staged_hits - hits
            if hits:
                self.clock.advance(self.cost.dram_ns * hits)
        else:
            for i, (addr, size) in enumerate(reqs):
                staged = wbuf_get(addr)
                if staged is not None and len(staged) >= size:
                    out[i] = bytes(staged[:size])
                    staged_hits += 1
                    continue
                append((i, addr, size))
        if remote:
            fetched = self._doorbell_wave(remote, cacheable=cacheable,
                                          target=self._read_target(h))
            for i, data in fetched.items():
                out[i] = data
        self.waves.observe(len(reqs) - len(remote), len(remote))
        return out  # type: ignore[return-value]

    def prefetch_many(self, h: StructHandle, reqs: List[Tuple[int, int]], *, cacheable: bool = True) -> List[bytes]:
        """Warm the cache for a batch: like ``read_many`` but charges NO
        per-node CPU and nothing at all for items already local (write
        buffer / cache) — the logical node visit is paid later when the
        operation itself reads the (now cached) node.  Only cache misses pay
        the doorbell wave.  Returns the bytes so wave walkers can chase
        pointers while they warm."""
        if not self.cfg.use_batch:
            return [self.read(h, a, s, cacheable=cacheable) for a, s in reqs]
        out: List[Optional[bytes]] = [None] * len(reqs)
        remote: List[Tuple[int, int, int]] = []
        append = remote.append
        wbuf_get = h.wbuf.get
        peek = self.cache.pages.get if self.cfg.use_cache else None
        for i, (addr, size) in enumerate(reqs):
            staged = wbuf_get(addr)
            if staged is not None and len(staged) >= size:
                out[i] = bytes(staged[:size])
                continue
            if peek is not None:
                page = peek(addr)
                if page is not None and len(page) >= size:
                    out[i] = bytes(page[:size])
                    continue
            append((i, addr, size))
        if remote:
            fetched = self._doorbell_wave(remote, cacheable=cacheable,
                                          target=self._read_target(h))
            for i, data in fetched.items():
                out[i] = data
        self.waves.observe(len(reqs) - len(remote), len(remote))
        return out  # type: ignore[return-value]

    # ================================================================ writes
    def write(self, h: StructHandle, addr: int, data: bytes) -> None:
        """Apply step: stage a memory log (coalescing by address) and
        write-through into the cache.  Durability order is handled by the
        op log (R) or by the synchronous flush in op_commit (naive)."""
        if self.cfg.symmetric:
            self.clock.advance(self.cost.nvm_write_ns)
            self.backend.write(addr, data)
            h.wbuf[addr] = data  # reuse wbuf as the replication log batch
            return
        if addr in h.wbuf:
            self.stats.memlogs_coalesced += 1
        h.wbuf[addr] = data
        if self.cfg.use_cache:
            self.cache.update_or_put(addr, data)
        self.clock.advance(self.cost.dram_ns)

    def write_many(self, h: StructHandle, writes: Sequence[Tuple[int, bytes]]) -> int:
        """Batched apply-phase writes: stage every (addr, data) exactly as
        the serial ``write`` loop would — same bytes, same order, so the
        arena stays byte-identical to serial execution — but charge the
        staging cost per *combined WQE*: writes to adjacent addresses merge
        into one (one memcpy / one WQE at flush time).  Returns the number
        of combined WQEs."""
        if self.cfg.symmetric or not self.cfg.use_batch or len(writes) <= 1:
            for addr, data in writes:
                self.write(h, addr, data)
            return len(writes)
        for addr, data in writes:
            if addr in h.wbuf:
                self.stats.memlogs_coalesced += 1
            h.wbuf[addr] = data
            if self.cfg.use_cache:
                self.cache.update_or_put(addr, data)
        runs = len(combine_runs([(a, len(d)) for a, d in writes]))
        self.stats.writes_combined += len(writes) - runs
        self.clock.advance(runs * self.cost.dram_ns)
        return runs

    # ========================================================== op lifecycle
    def op_begin(self, h: StructHandle, opcode: int, payload: bytes) -> int:
        if self._wave_linger and self._wave_depth == 0:
            # a serial op is starting outside any wave: fence the lingering
            # vector-op wave first — serial ops pay serial costs and their
            # group commits complete synchronously, so the controller's
            # window must not leak past the vector call sequence
            self.end_wave()
        if self.trace is not None:
            h._op_t0 = self.clock.now
        h.seq += 1
        if self.cfg.symmetric:
            return h.seq
        if self.cfg.use_oplog:
            if h.writer_epoch and h._staged_epoch != h.writer_epoch:
                # first op under a (new) write-lease epoch: stamp the stream
                # so replay can audit epoch monotonicity (markers don't count
                # toward the group-commit cadence)
                h.oplog_staged.append(encode_epoch_mark(h.writer_epoch))
                h._staged_epoch = h.writer_epoch
            entry = encode_oplog(OpLog(opcode, struct.pack("<Q", h.seq) + payload))
            h.oplog_staged.append(entry)
            h.oplog_staged_ops += 1
            self.stats.oplog_appends += 1
            group = self.cfg.oplog_group if self.cfg.use_batch else self.cfg.oplog_pipeline
            if h.oplog_staged_ops >= group and not h._in_batch:
                self.flush_oplog(h)
        return h.seq

    def op_commit(self, h: StructHandle) -> None:
        self._op_commit(h)
        tr = self.trace
        if tr is not None and h._op_t0 is not None:
            tr.span(self._tk, "op", h._op_t0, self.clock.now)
            h._op_t0 = None

    def _op_commit(self, h: StructHandle) -> None:
        # inside a doorbell write wave the batch shares one software
        # dispatch; each item pays only its staging work
        if self._wave_active():
            cpu = self.cost.cpu_batch_op_ns
            self._wave_ops += 1
        else:
            cpu = self.cost.cpu_op_ns
        self.clock.advance(cpu)
        self.busy_ns += cpu
        h.pending_ops += 1
        if self.cfg.symmetric:
            # local data already updated; stream the log to the mirror async
            if not self.cfg.sym_batch or h.pending_ops >= self.cfg.batch_ops:
                nbytes = sum(len(v) + 13 for v in h.wbuf.values()) + 9
                self._pipelined_write(nbytes)
                h.wbuf.clear()
                h.pending_ops = 0
            return
        if not self.cfg.use_oplog:
            # naive: each modified location is its own RDMA_Write; the writes
            # of one op post back-to-back into ONE rung doorbell (first WQE
            # pays the full issue, the rest the cheap WQE post — the same
            # accounting as the RCB write waves, so naive-vs-RCB write
            # comparisons measure the durability discipline, not a handicap
            # on how naive posts its WQEs) and the op waits for the last
            # completion before returning (durability).
            end = self.clock.now
            width = self.waves.width
            for i, (addr, data) in enumerate(h.wbuf.items()):
                self.backend.write(addr, data)
                self.stats.rdma_writes += 1
                self.stats.bytes_written += len(data)
                self.stats.wqe_posts += 1
                self.clock.advance(self.cost.issue_ns if i % width == 0
                                   else self.cost.doorbell_wqe_ns)
                end = self.backend.link.transfer(self.clock.now, len(data))
            if h.wbuf:
                self.stats.write_waves += 1
                self.clock.advance_to(end + self.cost.rtt_ns + self.cost.nvm_write_ns)
            h.wbuf.clear()
            h.pending_ops = 0
            if h.post_flush is not None:
                h.post_flush()
            return
        if h._in_batch:
            return  # the batch window ends with one combined flush
        if self.cfg.use_batch:
            if h.pending_ops >= self.cfg.batch_ops:
                self.flush_memlogs(h)
        else:
            self.flush_memlogs(h)  # per-op, but pipelined (R makes it safe)

    # ================================================================ flushes
    def _fence_of(self, h: StructHandle):
        """(epoch, fence-slot-name) a fenced handle's blade writes must
        carry; (None, None) on the unfenced single-writer legacy path."""
        if h.writer_epoch:
            return h.writer_epoch, f"{h.name}.wep"
        return None, None

    def discard_staged(self, h: StructHandle) -> None:
        """Throw away `h`'s staged-but-unflushed window after the blade
        fenced this writer (lease stolen): none of it was acked, so it must
        vanish — including the page-cache copies of dirty nodes, which now
        diverge from what the new lease holder will write.  The op counter
        rolls back to the durable watermark so a re-acquired lease resumes
        numbering where the committed tail actually ends."""
        for addr in h.wbuf:
            self.cache.invalidate(addr)
        h.wbuf.clear()
        h.pending_ops = 0
        h.oplog_staged.clear()
        h.oplog_staged_ops = 0
        h._staged_epoch = None
        try:
            h.seq = self.backend.get_name(f"{h.name}.seq")
        except CrashError:
            pass  # blade down: recovery re-reads the watermark on re-attach
        self.stats.fenced_appends += 1
        obs.count("fenced_appends")
        if self.trace is not None:
            self.trace.instant(self._tk, "write_fence", self.clock.now,
                               {"struct": h.name, "epoch": h.writer_epoch})

    def flush_oplog(self, h: StructHandle, sync: bool = True) -> None:
        if not h.oplog_staged:
            return
        tr = self.trace
        t0 = self.clock.now
        payload = b"".join(h.oplog_staged)
        epoch, fence = self._fence_of(h)
        try:
            self.backend.tx_append(h.oplog_area, payload, epoch, fence)
            self.backend.set_name_fenced(f"{h.name}.seq", h.seq, epoch, fence)
        except StaleWriterError:
            self.discard_staged(h)
            raise
        self.stats.rdma_writes += 1
        self.stats.bytes_written += len(payload)
        if sync:
            self._round(len(payload), nvm_write=True)
        else:
            self._pipelined_write(len(payload))
        if tr is not None:
            tr.span(self._tk, "oplog_flush", t0, self.clock.now,
                    {"ops": h.oplog_staged_ops, "bytes": len(payload),
                     "sync": sync})
        h.oplog_staged.clear()
        h.oplog_staged_ops = 0

    def flush_memlogs(self, h: StructHandle, sync: bool = False) -> None:
        """remote_tx_write for one handle: see ``flush_combined``."""
        self.flush_combined([h], sync=sync)

    def flush_combined(self, handles: Sequence[StructHandle], sync: bool = False) -> None:
        """remote_tx_write across one or more handles: ONE posted write
        carrying every handle's staged op-log entries followed by every
        handle's memory-log transaction (+ commit flag + checksum each).
        Each transaction also persists its handle's covered op-sequence
        number so recovery knows which op logs are reflected in the data.

        Ordering: within the combined payload each handle's op-log bytes
        precede every memory-log transaction.  NVM persists the write in
        order, so each op log is durable no later than the data it covers
        (the module docstring's ordering argument, unchanged) — the
        separate ``flush_oplog`` round disappears from the batch path, and
        a cross-structure ``batch_all()`` window drains a whole blade's
        worth of structures with a single posted write.

        Crash atomicity per handle: the op-log append lands entry bytes
        first and the ``{name}.seq`` watermark slot after them; recovery
        replays only entries at or below the watermark, so a flush torn
        anywhere inside a handle's segment makes that handle's whole window
        invisible (all-or-none), while handles earlier in the payload —
        whose watermark write already persisted — keep theirs."""
        tr = self.trace
        t0 = self.clock.now
        for h in handles:
            if h.pre_flush is not None and not h._in_preflush:
                h._in_preflush = True
                try:
                    h.pre_flush()
                finally:
                    h._in_preflush = False
        dirty = [h for h in handles if h.wbuf or h.pending_ops or h.oplog_staged]
        if not dirty:
            return
        total = 0
        # op-log bytes first, every handle (durability ordering).  A fenced
        # handle whose lease was stolen raises StaleWriterError here: its
        # staged window is discarded (unacked, so it simply vanishes) and
        # the error propagates — handles already flushed in this loop were
        # committed by their own watermark write and stay committed, the
        # same per-handle all-or-none story as a torn flush.
        for h in dirty:
            if not h.oplog_staged:
                continue
            oplog_payload = b"".join(h.oplog_staged)
            epoch, fence = self._fence_of(h)
            try:
                self.backend.tx_append(h.oplog_area, oplog_payload, epoch, fence)
                self.backend.set_name_fenced(f"{h.name}.seq", h.seq, epoch, fence)
            except StaleWriterError:
                self.discard_staged(h)
                raise
            h.oplog_staged.clear()
            h.oplog_staged_ops = 0
            total += len(oplog_payload)
            if h.wbuf or h.pending_ops:
                self.stats.combined_flushes += 1
        flushed: List[StructHandle] = []
        for h in dirty:
            if not h.wbuf and h.pending_ops == 0:
                continue
            # the opsn watermark trails the data writes it covers: the tx
            # still applies all-or-none on recovery (intra-tx order is free
            # there), but mirrors apply the stream write-by-write, so a
            # mirror's opsn copy must never advance past data it is missing
            # — replica reads gate on it (NVMBackend.replica_whole_seq)
            entries = [MemLog(a, d) for a, d in h.wbuf.items()]
            entries.append(MemLog(self.backend.name_slot_addr(h.opsn_name),
                                  struct.pack("<Q", h.seq)))
            payload = encode_tx(entries)
            epoch, fence = self._fence_of(h)
            try:
                self.backend.tx_append(h.txlog_area, payload, epoch, fence)
            except StaleWriterError:
                self.discard_staged(h)
                raise
            total += len(payload)
            self.stats.memlogs_flushed += len(h.wbuf)
            h.wbuf.clear()
            h.pending_ops = 0
            flushed.append(h)
        self.stats.rdma_writes += 1
        self.stats.bytes_written += total
        if sync:
            self._round(total, nvm_write=True)
        else:
            self._pipelined_write(total)
        for h in flushed:
            # the blade applies committed logs off the front-end's critical path
            self.backend.tx_apply(h.txlog_area)
            # op logs <= h.seq are now reflected in the data area: advance LPN
            h.oplog_area.applied = h.oplog_area.head
            if h.oplog_area.head > h.oplog_area.size // 2:
                h.oplog_area.compact()
            if h.txlog_area.applied > h.txlog_area.size // 2:
                h.txlog_area.compact()
        for h in flushed:
            if h.post_flush is not None and not h._in_preflush:
                h.post_flush()
        if tr is not None:
            tr.span(self._tk, "flush", t0, self.clock.now,
                    {"handles": len(dirty), "bytes": total, "sync": sync})

    def drain(self, h: StructHandle) -> None:
        """Flush everything (end of benchmark / clean shutdown)."""
        self.flush_memlogs(h, sync=True)  # folds any staged op logs in
        self.flush_oplog(h)  # pre_flush may have staged fresh entries
        self.end_wave()  # fence any lingering vector-op wave (durability)

    def drain_all(self) -> None:
        """Drain every structure handle this front-end has registered — the
        per-blade hook the cluster router fans out over its member blades."""
        for h in self.handles:
            self.drain(h)

    # ======================================================= batch execution
    @contextlib.contextmanager
    def batch(self, h: StructHandle):
        """A batch window: operations inside stage their op logs and memory
        logs without tripping the per-op / group flush cadence; the window
        closes with ONE combined oplog+memlog flush (one posted write for
        the whole batch).  Only meaningful with the op log on (R): the naive
        and symmetric paths keep their own durability discipline."""
        if h._in_batch or not self.cfg.use_oplog or self.cfg.symmetric:
            yield h  # nested or non-R: no-op window
            return
        h._in_batch = True
        try:
            yield h
        finally:
            h._in_batch = False
            self.flush_memlogs(h)

    def execute_batch(self, h: StructHandle, ops: Sequence[Callable[[], object]]) -> List[object]:
        """Run a group of thunks (each one structure operation) as a single
        batch window and return their results."""
        with self.batch(h):
            return [op() for op in ops]

    @contextlib.contextmanager
    def batch_all(self, handles: Optional[Sequence[StructHandle]] = None):
        """A cross-structure batch window: operations against EVERY handle
        this front-end owns (or the given explicit subset) stage their op
        logs and memory logs without tripping any per-handle flush cadence,
        and the window closes with ONE combined oplog+memlog posted write
        for the whole blade (``flush_combined``).  The body AND the closing
        flush run inside one doorbell write wave, so allocation RPCs, group
        commits, and the apply phase of any pre-flush materialization batch
        too, fenced once at window exit.  In the default all-handles form,
        handles registered *during* the window are swept into the final
        flush; an explicit ``handles`` subset stays exactly that subset.
        Nested windows are no-ops; only meaningful with the op log on (R),
        as for ``batch(h)``."""
        if not self.cfg.use_oplog or self.cfg.symmetric:
            yield self
            return
        hs = list(self.handles) if handles is None else list(handles)
        opened = [h for h in hs if not h._in_batch]
        for h in opened:
            h._in_batch = True
        with self.write_wave():
            try:
                yield self
            finally:
                for h in opened:
                    h._in_batch = False
                if handles is None:
                    hs = list(self.handles)
                # still-open handles belong to an enclosing window; flush
                # the rest while the wave is open (materialization and its
                # allocation RPCs ride the wave; the fence follows)
                self.flush_combined([h for h in hs if not h._in_batch])

    # ================================================================ atomics
    def atomic_read(self, addr: int) -> int:
        self._atomic(addr)
        self.stats.rdma_atomics += 1
        return self.backend.atomic_read(addr)

    def atomic_add(self, addr: int, delta: int) -> int:
        self._atomic(addr)
        self.stats.rdma_atomics += 1
        return self.backend.atomic_add(addr, delta)

    def atomic_cas(self, addr: int, expected: int, new: int) -> bool:
        self._atomic(addr)
        self.stats.rdma_atomics += 1
        return self.backend.atomic_cas(addr, expected, new)

    # =============================================================== recovery
    def unreplayed_oplogs(self, h: StructHandle) -> List[OpLog]:
        """Op logs recorded in remote NVM whose effects are NOT yet in the
        data area (seq > persisted opsn watermark) — the replay set after a
        front-end crash (paper §7.5).

        Two guards make group/window commits all-or-none:

          * entries above the durable ``{name}.seq`` watermark are ignored —
            every flush lands the entry bytes first and the watermark slot
            after them, so a torn flush leaves its whole group uncommitted
            instead of replaying a partial suffix of unacked ops;
          * entries are deduplicated by seq with the LAST bytes winning — a
            front-end re-attached after a torn flush restarts numbering at
            the watermark, so stale ghost entries from the torn window may
            precede live ones with the same seq in the log."""
        opsn = self.backend.get_name(h.opsn_name)
        durable = self.backend.get_name(f"{h.name}.seq")
        out = committed_tail(h.oplog_area.read_all(), opsn, durable)
        self._round(h.oplog_area.head)
        return out

