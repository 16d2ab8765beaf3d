"""Sharded data structures: one single-blade structure instance per shard,
spread over the cluster by the directory.

The wrappers layer *on top of* the existing ``structures/`` code — the
single-shard logic (node formats, op logs, replay tables, caching
heuristics) is reused untouched; each shard is an ordinary
``RemoteHashTable`` / ``RemoteBPTree`` named ``{name}.s{shard}`` living on
whichever blade the directory assigns.  Because every shard rides its own
``FrontEnd`` channel, the R/C/B optimizations (op-log groups, page cache,
batched memory-log flushes) compose per shard and per blade.

Failure handling is pushed down here so callers never see a dead blade:
an op that hits a crashed blade recovers it through the cluster (reboot or
mirror promotion), rebinds, replays the shard's op-log tail via the
existing ``RemoteStructure.recover`` path, and retries.

Concurrency model (multi-writer): many front-ends may mutate the
same sharded structure concurrently.  Ownership of each shard's op stream
is mediated by the cluster's write leases (``LeaseTable.acquire_write``):
every write entry point ensures the shard's write lease first, and the
lease's fencing epoch is stamped both into the op stream (epoch-marker
records) and into the blade-side fence slot ``{shard-name}.wep`` — so a
writer whose lease was stolen has its next group commit rejected whole at
the blade (``StaleWriterError``), its unacked ops vanishing instead of
interleaving.  A graceful steal drains the victim first and piggybacks its
committed-tail watermark on the lease handoff, letting the new writer
re-attach without replaying the op log.  Shards that ping-pong between
writers flip to *shared* mode: writers share one epoch and serialize
through the per-shard writer mutex (``core.locks``) — or, for
``ShardedMVBPTree``, through MVCC copy-on-write publication — with a
flush-before-unlock discipline that keeps op-sequence numbers disjoint.
"""

from __future__ import annotations

import contextlib
import heapq
from typing import Callable, Dict, List, Optional, Tuple

from ..core.backend import CrashError, StaleWriterError
from ..core.cache import ResultCache
from ..core.frontend import ReadPolicy
from ..core.locks import WriterPreferredLock
from ..core.structures import RemoteBPTree, RemoteHashTable
from ..core.structures.mv_bpt import RemoteMVBPTree
from .. import obs
from .directory import scope_of
from .router import ClusterFrontEnd

MAX_RETRIES = 3

# Shard-sized log areas: a cluster keeps many structure instances per blade,
# so the per-structure areas start far smaller than the single-blade default
# (4096 blocks); log rotation doubles them on demand.
SHARD_LOG_BLOCKS = 128


class _ShardHashTable(RemoteHashTable):
    OPLOG_BLOCKS = SHARD_LOG_BLOCKS
    TXLOG_BLOCKS = SHARD_LOG_BLOCKS


class _ShardBPTree(RemoteBPTree):
    OPLOG_BLOCKS = SHARD_LOG_BLOCKS
    TXLOG_BLOCKS = SHARD_LOG_BLOCKS


class _ShardMVBPTree(RemoteMVBPTree):
    OPLOG_BLOCKS = SHARD_LOG_BLOCKS
    TXLOG_BLOCKS = SHARD_LOG_BLOCKS


class ShardedStructure:
    """Shared routing/failover machinery for the sharded wrappers.

    Replica reads: with a ``read_policy`` set, ``get``/``get_many`` route
    to the shard blade's *mirror* endpoints under the policy's bounded-
    staleness contract.  Read-your-writes is preserved by pinning: every
    key this wrapper writes is recorded with the op-sequence number of its
    write, and its reads stay on the primary until the mirrors' applied
    watermark passes that seq — at which point the mirror provably holds
    the write's effects and the pin is released.  Writes are primary-only
    always.

    Result cache: with ``result_cache`` entries (or
    ``cfe.cfg.result_cache_entries``) > 0, point-lookup results are
    memoized in a :class:`ResultCache` keyed by shard (the invalidation
    group).  A hit is served locally at DRAM cost; writes through this
    wrapper drop their keys (per-key tier); migration/failover/directory
    rebuilds drop the affected groups via the cluster's lease-revocation
    broadcast (``ClusterFrontEnd.register_result_cache``).  Staleness
    safety: a pinned key bypasses the cache entirely (read-your-writes —
    per the contract, until its watermark passes), and results are admitted
    only when provably the freshest committed value — primary-served reads
    always; replica-served reads only while the shard blade's mirrors are
    fully caught up (an admitted bounded-stale value would outlive the
    staleness contract).  Default is off (``result_cache_entries=0``): the
    read/write paths are byte-identical to the uncached ones."""

    #: subclasses that must serialize concurrent writers through the shard
    #: mutex even before the lease table flips the shard to shared mode
    #: (MV structures publish via root CAS — two unserialized writers would
    #: lose updates on the losing CAS).
    FORCE_LOCK = False

    def __init__(self, cfe: ClusterFrontEnd, name: str,
                 read_policy: Optional[ReadPolicy] = None,
                 result_cache: Optional[int] = None):
        self.cfe = cfe
        self.name = name
        self.read_policy = read_policy
        self._shards: Dict[int, object] = {}  # shard -> bound structure
        self._pinned: Dict[int, Tuple[int, int]] = {}  # key -> (shard, seq)
        cap = cfe.cfg.result_cache_entries if result_cache is None else result_cache
        if cap:
            self._result_cache: Optional[ResultCache] = ResultCache(cap)
            cfe.register_result_cache(self)
            sess = obs.session()
            if sess is not None:
                sess.register_result_cache(self._result_cache)
        else:
            self._result_cache = None
        # write-lease bookkeeping: the epoch this wrapper last stamped into
        # each shard's fence slot (a steal bumps the table's epoch, making
        # ours stale — _ensure_write re-stamps on the next write).  Leases
        # are scoped per structure so co-tenant structures on one cluster
        # never contend for the same shard index.
        self._write_epochs: Dict[int, int] = {}
        self._lease_scope = scope_of(name)
        cfe.register_writer(self)

    # ---------------------------------------------------------- observability
    @contextlib.contextmanager
    def _cluster_op(self, op: str, n: int):
        """Time a cluster-level op on the CFE clock: sim-time latency lands
        in ``cfe.op_hist[op]`` (always on) and, when tracing, an ``op:{op}``
        span on the CFE track."""
        cfe = self.cfe
        t0 = cfe.clock.now
        try:
            yield
        finally:
            t1 = cfe.clock.now
            if n > 0:
                cfe.record_op_latency(op, t1 - t0, n)
            tr = cfe.trace
            if tr is not None:
                tr.span(cfe._track, f"op:{op}", t0, t1,
                        {"n": n, "struct": self.name})

    # ------------------------------------------------------- shard resolution
    def _shard_name(self, shard: int) -> str:
        return f"{self.name}.s{shard}"

    def _create(self, fe, name):  # pragma: no cover - overridden
        raise NotImplementedError

    def _attach(self, fe, name):  # pragma: no cover - overridden
        raise NotImplementedError

    def _recover(self, fe, name):  # pragma: no cover - overridden
        raise NotImplementedError

    def _get_shard(self, shard: int, create_if_missing: bool = True):
        """Resolve the structure object for `shard` on its current blade,
        (re)binding and replaying the op-log tail when the blade or the
        assignment changed since the last touch."""
        bid = self.cfe.directory.blade_of(shard)
        fe = self.cfe.fe_for_blade(bid)
        obj = self._shards.get(shard)
        if obj is not None and obj.fe is fe:
            self._resync_external(shard, obj)
            return obj
        fe.clock.advance_to(self.cfe.clock.now)
        try:
            name = self._shard_name(shard)
            if fe.backend.has_name(f"{name}.seq"):
                be = fe.backend
                # committed watermark ahead of the applied watermark means the
                # blade carries an op-log tail whose effects never reached the
                # data area (e.g. it crashed and rebooted since the last
                # writer) — even a FIRST touch must replay it, or this client
                # reads pre-crash state that a later recover would overwrite.
                dirty = be.get_name(f"{name}.seq") > be.get_name(f"{name}.opsn")
                if obj is None and not dirty:
                    obj = self._attach(fe, name)       # first touch: plain attach
                elif (not dirty and self.cfe.cluster.leases.handoff_watermark(
                            shard, scope=self._lease_scope)
                        == be.get_name(f"{name}.seq")):
                    # graceful lease handoff: the previous writer drained and
                    # its committed-tail watermark rode the lease — the op
                    # stream holds nothing unapplied, so re-attach without
                    # the full replay pass.
                    obj = self._attach(fe, name)
                    obs.count("lease_handoff_clean")
                else:
                    obj = self._recover(fe, name)      # rebound: replay the tail
            elif create_if_missing:
                obj = self._create(fe, name)
            else:
                return None
        finally:
            self.cfe.clock.advance_to(fe.clock.now)
        self._shards[shard] = obj
        # (re)binding starts a fresh view of the shard's op stream — after a
        # migration or failover the destination renumbers ops, so pin seqs
        # recorded against the old stream are meaningless there.  Re-pin the
        # shard's keys at the new binding's committed tail: they stay on the
        # primary until the new blade's mirrors have provably applied the
        # whole rebound state (which includes every migrated write).
        if self._pinned:
            for k, entry in self._pinned.items():
                if entry[0] == shard:
                    self._pinned[k] = (shard, obj.h.seq)
        return obj

    def _resync_external(self, shard: int, obj) -> None:
        """Multi-writer freshness check on the cached-shard fast path:
        another front-end may have committed past our view of the shard's
        op stream (only possible after our write lease moved — while we
        hold it, nobody else can commit, and this is a free no-op).  Roll
        the committed-tail view forward and drop caches whose pages the
        other writer's commits may shadow."""
        durable = obj.fe.backend.get_name(f"{obj.name}.seq")
        if durable > obj.h.seq:
            obj.h.seq = durable
            obj.fe.cache.clear()
            refresh = getattr(obj, "refresh_root", None)
            if refresh is not None:
                refresh()
            self._invalidate_groups([shard])

    # --------------------------------------------------- replica read routing
    def _note_write(self, key: int, shard: int, obj) -> None:
        """Pin `key` to the primary for reads: recorded at the op-seq of its
        write, released once every mirror's applied watermark passes it.
        Pins only matter when replica routing can actually happen — without
        a policy, or on a blade with no mirrors, every read goes to the
        primary anyway, so nothing is recorded (and nothing can leak)."""
        if self.read_policy is None or not obj.fe.backend.mirrors:
            return
        self._pinned[key] = (shard, obj.h.seq)

    def _replica_floor(self, obj) -> int:
        """The lowest provably-WHOLE watermark across the shard blade's
        mirrors: pins at or below it are releasable (every replica already
        holds those writes' full effects — ``replica_whole_seq`` discounts a
        watermark whose op may still be partially replicated), and result-
        cache admission compares the committed tail against it.  -1 when the
        blade has no mirrors."""
        be = obj.fe.backend
        if not be.mirrors:
            return -1
        return min(be.replica_whole_seq(obj.name, i)
                   for i in range(len(be.mirrors)))

    # ------------------------------------------------------------ result cache
    def _invalidate_groups(self, shards) -> None:
        """Reconfiguration broadcast hook (see ``NVMCluster.revoke_leases``):
        drop the given invalidation groups — ``None`` means every group."""
        rc = self._result_cache
        if rc is None:
            return
        if shards is None:
            rc.invalidate_all()
        else:
            for s in shards:
                rc.invalidate_group(s)

    def _rc_invalidate(self, key: int) -> None:
        """Per-key write fencing: drop the key's cached result BEFORE the
        write dispatches, so a failed/retried write can never leave a
        pre-write value behind (conservative: the entry just refills on the
        next read).  Local bookkeeping — no sim-time cost."""
        rc = self._result_cache
        if rc is not None:
            rc.invalidate_key(key)

    def _admit_results(self, obj, shard: int, keys: List[int], vals: List) -> None:
        """Admit freshly fetched results, but only when they are provably
        the freshest committed values: primary-served always qualifies;
        replica-served only while every mirror of the shard's blade has
        applied the full committed op stream (otherwise a bounded-stale
        value would be frozen past the staleness contract).  Pinned keys
        never admit — they bypass the cache until their watermark passes."""
        rc = self._result_cache
        if self.read_policy is not None:
            be = obj.fe.backend
            if be.mirrors and self._replica_floor(obj) < obj.h.seq:
                return
        pinned = self._pinned
        for k, v in zip(keys, vals):
            if v is not None and k not in pinned:
                rc.put(k, v, shard)

    def _serve_reads(self, obj, keys: List[int], reader: Callable) -> List:
        """Serve a shard's read sub-batch under the read policy: pinned keys
        (written here, not yet provably on every mirror) go to the primary;
        the rest resolve their target through ``FrontEnd.replica_reads`` —
        mirror endpoints within the staleness bound, with automatic primary
        fallback.  Returns values in input-key order."""
        pol = self.read_policy
        if pol is None:
            return reader(obj, keys)
        floor = self._replica_floor(obj)
        if len(self._pinned) > 1 << 12:
            # oversize sweep: release every pin whose own shard's mirrors
            # already cover it, read or not (keys written once and never
            # read again must not accumulate forever).  Floors are computed
            # per shard from the currently-bound structures.
            floors: Dict[int, Optional[int]] = {}
            for k, (s, q) in list(self._pinned.items()):
                if s not in floors:
                    bound = self._shards.get(s)
                    floors[s] = None if bound is None else self._replica_floor(bound)
                sf = floors[s]
                if sf is not None and q <= sf:
                    del self._pinned[k]
        replica_ok: List[int] = []
        pinned: List[int] = []
        for k in keys:
            entry = self._pinned.get(k)
            if entry is not None and entry[1] <= floor:
                del self._pinned[k]  # mirrors caught up: release the pin
                entry = None
            (pinned if entry is not None else replica_ok).append(k)
        vals: Dict[int, object] = {}
        if replica_ok:
            with obj.fe.replica_reads(pol):
                for k, v in zip(replica_ok, reader(obj, replica_ok)):
                    vals[k] = v
        if pinned:
            for k, v in zip(pinned, reader(obj, pinned)):
                vals[k] = v
        return [vals[k] for k in keys]

    def _serve_scan(self, shard: int, obj, scanner: Callable):
        """Serve a whole-structure scan (``items`` / ``range_items``) under
        the read policy: the shard's entire leaf fan-out routes to a mirror
        endpoint — one read wave against replica arenas instead of the
        primary, so scans stop competing with primary write traffic.  A scan
        touches every key, so it can only leave the primary when NO key of
        this shard is still pinned (a pinned key is a local write not yet
        provably applied on every mirror); releasable pins are dropped on
        the way through, exactly as in ``_serve_reads``."""
        pol = self.read_policy
        if pol is None:
            return scanner(obj)
        floor = self._replica_floor(obj)
        for k, entry in list(self._pinned.items()):
            if entry[0] != shard:
                continue
            if entry[1] <= floor:
                del self._pinned[k]  # mirrors caught up: release the pin
            else:
                return scanner(obj)  # fresh local write: primary only
        with obj.fe.replica_reads(pol):
            return scanner(obj)

    # ------------------------------------------------------------ write leases
    def _lock_mode(self, shard: int) -> bool:
        """True when writers on this shard serialize through the per-shard
        writer mutex instead of exclusive lease ownership: either the lease
        table flipped the shard to shared mode (steal ping-pong) or the
        subclass forces it (MVCC structures)."""
        return (self.FORCE_LOCK or (self._lease_scope, shard)
                in self.cfe.cluster.leases.shared_shards)

    def _ensure_write(self, shard: int, obj) -> None:
        """Hold the shard's write lease and make sure its fencing epoch is
        stamped — into the blade-side fence slot ``{name}.wep`` (checked by
        every group commit) and into the handle (so ``op_begin`` stages an
        epoch marker ahead of this writer's next ops)."""
        epoch = self.cfe.ensure_write_lease(shard, shared=self._lock_mode(shard),
                                            scope=self._lease_scope)
        if self._write_epochs.get(shard) != epoch or obj.h.writer_epoch != epoch:
            fe = obj.fe
            if (obj.h.writer_epoch and obj.h.writer_epoch != epoch
                    and (obj.h.oplog_staged or obj.h.wbuf or obj.h.pending_ops)
                    and fe.backend.get_name(f"{obj.name}.wep")
                    > obj.h.writer_epoch):
                # the blade fence moved past our old epoch: another writer
                # held the shard in between, so our staged window is already
                # condemned — drop it here so its ops can't ride the new
                # epoch.  (An epoch bump with the fence UNMOVED is just a
                # revocation/renewal landing on this same writer: the staged
                # ops were never fenced and simply continue under the new
                # epoch's marker.)
                fe.discard_staged(obj.h)
            # pre-stamp the fence once per grant: epochs only move forward,
            # so re-stamping an already-newer slot is impossible (the newer
            # epoch belongs to us — we just acquired it).
            fe.backend.set_name(f"{obj.name}.wep", epoch)
            # resume from whatever the previous holder committed (graceful
            # handoff watermark or plain committed tail): roll the seq
            # forward and drop pages its writes may shadow.
            durable = fe.backend.get_name(f"{obj.name}.seq")
            if durable > obj.h.seq:
                obj.h.seq = durable
                fe.cache.clear()
                refresh = getattr(obj, "refresh_root", None)
                if refresh is not None:
                    refresh()
            self._write_epochs[shard] = epoch
            obj.h.writer_epoch = epoch

    @contextlib.contextmanager
    def _locked(self, shard: int, obj):
        """Shared-mode write window: take the shard's writer mutex, resync
        to whatever the previous holder committed, run the ops, and flush
        BEFORE unlocking — op-sequence numbers stay disjoint because no two
        holders ever stage against the same committed tail."""
        fe = obj.fe
        lock = WriterPreferredLock(fe, obj.name)
        lock.acquire_writer()
        try:
            durable = fe.backend.get_name(f"{obj.name}.seq")
            if durable > obj.h.seq:
                # another writer committed past our view: roll the seq
                # forward (never back — we may carry staged ops from an
                # exclusive phase) and drop cached pages that its writes
                # may shadow.  MV structures also re-read the published
                # root so the post-flush CAS advances from it.
                obj.h.seq = durable
                fe.cache.clear()
                refresh = getattr(obj, "refresh_root", None)
                if refresh is not None:
                    refresh()
            yield
            fe.drain(obj.h)  # flush-before-unlock
        finally:
            lock.release_writer()

    def _surrender_shard(self, shard: int) -> Optional[int]:
        """Victim side of a graceful lease steal (called by the thief's CFE
        through the writer registry): drain the shard's staged state under
        the OLD epoch — the fence isn't stamped yet, so the flush commits —
        and hand back the committed-tail watermark for the lease handoff."""
        self._write_epochs.pop(shard, None)
        obj = self._shards.get(shard)
        if obj is None:
            return None
        fe = obj.fe
        fe.clock.advance_to(self.cfe.clock.now)
        try:
            fe.drain(obj.h)
        finally:
            self.cfe.clock.advance_to(fe.clock.now)
        obj.h.writer_epoch = 0
        return obj.h.seq

    # ------------------------------------------------------------ op dispatch
    def _on_shard(self, shard: int, fn: Callable, *, create_if_missing: bool = True,
                  default=None, write: bool = False):
        """Run `fn(shard_structure)` with epoch validation, clock threading,
        and recover-and-retry on blade failure.  ``write=True`` additionally
        ensures the shard's write lease (fencing epoch stamped) and, in
        shared mode, runs `fn` inside the writer-mutex window."""
        last: Optional[Exception] = None
        for _ in range(1 + MAX_RETRIES):
            self.cfe.ensure_fresh()
            bid = self.cfe.directory.blade_of(shard)
            try:
                obj = self._get_shard(shard, create_if_missing)
                if obj is None:
                    return default
                fe = obj.fe
                fe.clock.advance_to(self.cfe.clock.now)
                try:
                    if write:
                        self._ensure_write(shard, obj)
                        if self._lock_mode(shard):
                            with self._locked(shard, obj):
                                result = fn(obj)
                        else:
                            result = fn(obj)
                    else:
                        result = fn(obj)
                finally:
                    self.cfe.clock.advance_to(fe.clock.now)
                # load accounting on success only: a failed attempt retries
                # and must not double-count its op into the shard weight
                self.cfe.cluster.directory.record_ops(shard)
                return result
            except StaleWriterError as e:
                # lease stolen between stamp and flush: the staged window is
                # already discarded (frontend fencing) — re-acquire and rerun
                # the (idempotent-upsert) ops under the new epoch.
                last = e
                self._write_epochs.pop(shard, None)
            except CrashError as e:
                last = e
                self.cfe.recover_blade(bid)
        raise last  # unrecoverable (e.g. permanent failure with no mirror)

    def _on_key(self, key: int, fn: Callable, **kw):
        return self._on_shard(self.cfe.directory.shard_of(key), fn, **kw)

    def _on_shards(self, shard_fns: Dict[int, Callable], *,
                   create_if_missing: bool = True, default=None,
                   ops_per_shard: Optional[Dict[int, int]] = None,
                   write: bool = False) -> Dict[int, object]:
        """Batch dispatch: run `shard_fns[shard](shard_structure)` for every
        shard with ONE epoch check per attempt (not per op), sub-batches to
        different blades overlapping in time (same-blade shards serialize on
        their shared front-end), and recover-and-retry per blade on
        failure.  ``ops_per_shard`` feeds the load-weight accounting with
        the real sub-batch sizes (default 1 per shard; pass 0 for non-op
        dispatches like drains).  ``write=True`` ensures each shard's write
        lease during resolution and serializes lock-mode shards through the
        writer mutex.  Returns {shard: result}."""
        out: Dict[int, object] = {}
        remaining = dict(shard_fns)
        last: Optional[Exception] = None
        for _ in range(1 + MAX_RETRIES):
            if not remaining:
                break
            self.cfe.ensure_fresh()
            failed_bids = set()
            by_blade: Dict[int, List[int]] = {}
            objs: Dict[int, object] = {}
            for shard in sorted(remaining):
                bid = self.cfe.directory.blade_of(shard)
                try:
                    obj = self._get_shard(shard, create_if_missing)
                    if obj is not None and write:
                        self._ensure_write(shard, obj)
                except CrashError as e:
                    last = e
                    failed_bids.add(bid)
                    continue
                if obj is None:
                    out[shard] = default
                    remaining.pop(shard)
                    continue
                objs[shard] = obj
                by_blade.setdefault(bid, []).append(shard)
            # fan out through the router's batch dispatcher (one clock model
            # for sub-batch overlap).  Each blade's sub-batch runs inside a
            # cross-structure batch_all() window — every shard on the blade
            # stages into one combined oplog+memlog posted write — and a
            # shard only counts as done once its blade's window CLOSED
            # (combined flush landed).  A blade that dies mid-window gets
            # its WHOLE sub-batch re-run after recovery; the combined flush
            # commits per handle (seq watermark), so a shard whose window
            # segment already committed before the tear re-applies the same
            # ops — safe because every op routed through this dispatcher is
            # an idempotent upsert (put/insert/delete), NOT a general
            # exactly-once guarantee for non-idempotent ops.
            done: List[int] = []
            errs: List[CrashError] = []
            stale: List[StaleWriterError] = []

            def _blade_fn(bid: int, shards: List[int]) -> Callable:
                def run(fe) -> None:
                    ran: List[int] = []
                    try:
                        locked = ([s for s in shards if self._lock_mode(s)]
                                  if write else [])
                        plain = [s for s in shards if s not in locked]
                        if plain:
                            with fe.batch_all():
                                for shard in plain:
                                    out[shard] = remaining[shard](objs[shard])
                                    ran.append(shard)
                        for shard in locked:
                            # lock-mode shards flush inside the mutex window
                            # (flush-before-unlock), so they stay out of the
                            # blade's combined batch_all window
                            with self._locked(shard, objs[shard]):
                                out[shard] = remaining[shard](objs[shard])
                            ran.append(shard)
                    except StaleWriterError as e:
                        # a steal fenced this blade's window mid-flight: the
                        # fenced shard's staged ops are already discarded and
                        # every op here is an idempotent upsert, so rerun the
                        # whole sub-batch under a fresh lease — no blade
                        # recovery involved.
                        stale.append(e)
                        for shard in ran:
                            out.pop(shard, None)
                        for shard in shards:
                            self._write_epochs.pop(shard, None)
                    except CrashError as e:
                        errs.append(e)
                        failed_bids.add(bid)
                        for shard in ran:  # window lost with the blade
                            out.pop(shard, None)
                    else:
                        done.extend(ran)
                return run

            self.cfe.execute_batch(
                {bid: _blade_fn(bid, shards) for bid, shards in by_blade.items()},
                combined=False,
            )
            if errs:
                last = errs[-1]
            elif stale:
                last = stale[-1]
            for shard in done:
                remaining.pop(shard, None)
                n = 1 if ops_per_shard is None else ops_per_shard.get(shard, 1)
                if n:
                    self.cfe.cluster.directory.record_ops(shard, n)
            for bid in failed_bids:
                self.cfe.recover_blade(bid)
        if remaining:
            raise last  # unrecoverable (e.g. permanent failure, no mirror)
        return out

    # ------------------------------------------------------------ vector ops
    def put_many(self, pairs: List[Tuple[int, int]]) -> None:
        """Partition a write batch by shard, fan the sub-batches out to the
        per-blade front-ends (each runs its own wave-batched `put_many`),
        one epoch check for the whole batch.  Shards co-resident on one
        blade share that blade's batch_all() window, so the entire blade
        sub-batch — however many shard structures it spans — drains with a
        single combined oplog+memlog posted write.  Every written key is
        pinned at the batch's closing op-seq (conservative: the whole batch
        must reach the mirrors before any of its keys reads from one)."""
        if self._result_cache is not None:
            for k, _ in pairs:
                self._rc_invalidate(k)
        groups: Dict[int, List[Tuple[int, int]]] = {}
        for k, v in pairs:
            groups.setdefault(self.cfe.directory.shard_of(k), []).append((k, v))

        def mk(shard: int, sub: List[Tuple[int, int]]) -> Callable:
            def run(t):
                t.put_many(sub)
                if self.read_policy is not None and t.fe.backend.mirrors:
                    for k, _ in sub:
                        self._pinned[k] = (shard, t.h.seq)
            return run

        with self._cluster_op("put_many", len(pairs)):
            self._on_shards(
                {s: mk(s, sub) for s, sub in groups.items()},
                ops_per_shard={s: len(sub) for s, sub in groups.items()},
                write=True)

    def get_many(self, keys: List[int]) -> List[Optional[int]]:
        """Partition a read batch by shard, fan out, merge results back into
        input order (missing shards contribute None).  Under a read policy
        each shard sub-batch routes through ``_serve_reads``: unpinned keys
        go to mirror endpoints within the staleness bound, pinned keys to
        the primary.  With a result cache, unpinned keys probe it first —
        hits are served locally at DRAM cost, only misses fan out (and
        cache-safe miss results are admitted on the way back)."""
        rc = self._result_cache
        out: List[Optional[int]] = [None] * len(keys)
        if rc is None:
            with self._cluster_op("get_many", len(keys)):
                self._fetch_into(keys, range(len(keys)), out, admit=False)
            return out
        hits = 0
        miss: List[int] = []
        for i, k in enumerate(keys):
            if k in self._pinned:
                rc.note_bypass()  # read-your-writes: primary until released
                miss.append(i)
                continue
            hit, v = rc.get(k)
            if hit:
                out[i] = v
                hits += 1
            else:
                miss.append(i)
        with self._cluster_op("get_many", len(keys)):
            if hits:
                self.cfe.clock.advance(hits * self.cfe.cost.dram_ns)
            if miss:
                self._fetch_into(keys, miss, out, admit=True)
        return out

    def _fetch_into(self, keys: List[int], idxs, out: List, admit: bool) -> None:
        """Fan the keys at positions ``idxs`` out by shard and merge results
        into ``out`` (the uncached ``get_many`` body; ``admit`` feeds
        cache-safe results to the result cache)."""
        groups: Dict[int, List[int]] = {}
        for i in idxs:
            groups.setdefault(self.cfe.directory.shard_of(keys[i]), []).append(i)

        def mk(shard: int, sub: List[int]) -> Callable:
            def run(t):
                vals = self._serve_reads(
                    t, sub, lambda obj, ks: obj.get_many(ks))
                if admit:
                    self._admit_results(t, shard, sub, vals)
                return vals
            return run

        res = self._on_shards(
            {s: mk(s, [keys[i] for i in pos]) for s, pos in groups.items()},
            create_if_missing=False,
            default=None,
            ops_per_shard={s: len(pos) for s, pos in groups.items()},
        )
        for s, pos in groups.items():
            vals = res.get(s)
            if vals is None:
                continue
            for i, v in zip(pos, vals):
                out[i] = v

    insert_many = put_many
    lookup_many = get_many

    # ------------------------------------------------------------- lifecycle
    def drain(self) -> None:
        """Commit point: flush every touched shard's op-log and memory-log
        channels (only shards this front-end touched can hold staged
        state).  Fanned out through the cluster wave scheduler — shards
        grouped by blade, every blade's combined flush overlapped —
        instead of one serial round per shard."""
        if not self._shards:
            return
        self._on_shards(
            {s: (lambda obj: obj.fe.drain(obj.h)) for s in sorted(self._shards)},
            create_if_missing=False,
            ops_per_shard={s: 0 for s in self._shards},  # drains aren't load
        )

    def shard_objects(self) -> Dict[int, object]:
        return dict(self._shards)


class ShardedHashTable(ShardedStructure):
    """Hash table hash-partitioned over the cluster's blades."""

    def __init__(self, cfe: ClusterFrontEnd, name: str, n_buckets: int = 1 << 12,
                 read_policy: Optional[ReadPolicy] = None,
                 result_cache: Optional[int] = None):
        super().__init__(cfe, name, read_policy=read_policy,
                         result_cache=result_cache)
        # n_buckets is the logical total; each shard gets its slice
        self.buckets_per_shard = max(64, n_buckets // cfe.directory.n_shards)

    def _create(self, fe, name):
        return _ShardHashTable(fe, name, n_buckets=self.buckets_per_shard, create=True)

    def _attach(self, fe, name):
        return _ShardHashTable(fe, name, create=False)

    def _recover(self, fe, name):
        return _ShardHashTable.recover(fe, name)

    # -------------------------------------------------------------------- ops
    def put(self, key: int, value: int) -> None:
        self._rc_invalidate(key)
        shard = self.cfe.directory.shard_of(key)

        def run(t):
            t.put(key, value)
            self._note_write(key, shard, t)

        with self._cluster_op("put", 1):
            self._on_shard(shard, run, write=True)

    def get(self, key: int):
        rc = self._result_cache
        if rc is not None:
            if key in self._pinned:
                rc.note_bypass()  # read-your-writes: primary until released
            else:
                hit, v = rc.get(key)
                if hit:
                    with self._cluster_op("get", 1):
                        self.cfe.clock.advance(self.cfe.cost.dram_ns)
                    return v
        shard = self.cfe.directory.shard_of(key)

        def run(t):
            v = self._serve_reads(t, [key], lambda obj, ks: obj.get_many(ks))[0]
            if rc is not None:
                self._admit_results(t, shard, [key], [v])
            return v

        with self._cluster_op("get", 1):
            return self._on_shard(shard, run, create_if_missing=False)

    def delete(self, key: int) -> bool:
        self._rc_invalidate(key)
        shard = self.cfe.directory.shard_of(key)

        def run(t):
            ok = t.delete(key)
            self._note_write(key, shard, t)  # deletions pin too (no resurrection)
            return ok

        return self._on_shard(shard, run, create_if_missing=False, default=False,
                              write=True)

    def items(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for shard in range(self.cfe.directory.n_shards):
            part = self._on_shard(
                shard,
                lambda t, s=shard: self._serve_scan(s, t, lambda o: o.items()),
                create_if_missing=False,
                default=[],
            )
            out.extend(part)
        return out


class ShardedBPTree(ShardedStructure):
    """B+Tree hash-partitioned over the cluster; range scans fan out to every
    shard's leaf chain and merge the sorted streams."""

    def _create(self, fe, name):
        return _ShardBPTree(fe, name, create=True)

    def _attach(self, fe, name):
        return _ShardBPTree(fe, name, create=False)

    def _recover(self, fe, name):
        return _ShardBPTree.recover(fe, name)

    # -------------------------------------------------------------------- ops
    def insert(self, key: int, value: int) -> None:
        self._rc_invalidate(key)
        shard = self.cfe.directory.shard_of(key)

        def run(t):
            t.insert(key, value)
            self._note_write(key, shard, t)

        with self._cluster_op("put", 1):
            self._on_shard(shard, run, write=True)

    def find(self, key: int):
        rc = self._result_cache
        if rc is not None:
            if key in self._pinned:
                rc.note_bypass()  # read-your-writes: primary until released
            else:
                hit, v = rc.get(key)
                if hit:
                    with self._cluster_op("get", 1):
                        self.cfe.clock.advance(self.cfe.cost.dram_ns)
                    return v
        shard = self.cfe.directory.shard_of(key)

        def run(t):
            v = self._serve_reads(t, [key], lambda obj, ks: obj.lookup_many(ks))[0]
            if rc is not None:
                self._admit_results(t, shard, [key], [v])
            return v

        with self._cluster_op("get", 1):
            return self._on_shard(shard, run, create_if_missing=False)

    def range_scan(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """All (key, value) with lo <= key <= hi, globally sorted: per-shard
        leaf-chain scans merged with a k-way heap merge."""
        streams: List[List[Tuple[int, int]]] = []
        for shard in range(self.cfe.directory.n_shards):
            part = self._on_shard(
                shard,
                lambda t, s=shard: self._serve_scan(
                    s, t, lambda o: o.range_items(lo, hi)
                ),
                create_if_missing=False,
                default=[],
            )
            if part:
                streams.append(part)
        return list(heapq.merge(*streams))

    def items(self) -> List[Tuple[int, int]]:
        streams: List[List[Tuple[int, int]]] = []
        for shard in range(self.cfe.directory.n_shards):
            part = self._on_shard(
                shard,
                lambda t, s=shard: self._serve_scan(s, t, lambda o: o.items()),
                create_if_missing=False,
                default=[],
            )
            if part:
                streams.append(part)
        return list(heapq.merge(*streams))


class ShardedMVBPTree(ShardedStructure):
    """Multi-version B+Tree hash-partitioned over the cluster: the MVCC leg
    of the multi-writer story.  Writers on a shard always serialize through
    the per-shard writer mutex (``FORCE_LOCK``) instead of exclusive lease
    ownership — each window copies-on-write against the last published root,
    flushes, and publishes with a root CAS, so contended writers pay mutex
    handoff instead of lease ping-pong and readers always traverse an
    immutable published version."""

    FORCE_LOCK = True

    def _create(self, fe, name):
        return _ShardMVBPTree(fe, name, create=True)

    def _attach(self, fe, name):
        return _ShardMVBPTree(fe, name, create=False)

    def _recover(self, fe, name):
        return _ShardMVBPTree.recover(fe, name)

    # -------------------------------------------------------------------- ops
    def insert(self, key: int, value: int) -> None:
        self._rc_invalidate(key)
        shard = self.cfe.directory.shard_of(key)

        def run(t):
            t.insert(key, value)
            self._note_write(key, shard, t)

        with self._cluster_op("put", 1):
            self._on_shard(shard, run, write=True)

    def find(self, key: int):
        shard = self.cfe.directory.shard_of(key)

        def run(t):
            return self._serve_reads(
                t, [key], lambda obj, ks: obj.lookup_many(ks))[0]

        with self._cluster_op("get", 1):
            return self._on_shard(shard, run, create_if_missing=False)

    def range_scan(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        streams: List[List[Tuple[int, int]]] = []
        for shard in range(self.cfe.directory.n_shards):
            part = self._on_shard(
                shard,
                lambda t, s=shard: self._serve_scan(
                    s, t, lambda o: o.range_items(lo, hi)
                ),
                create_if_missing=False,
                default=[],
            )
            if part:
                streams.append(part)
        return list(heapq.merge(*streams))

    def items(self) -> List[Tuple[int, int]]:
        return self.range_scan(-(1 << 63), (1 << 63) - 1)
