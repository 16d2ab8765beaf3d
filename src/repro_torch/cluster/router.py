"""Cluster control plane and front-end-side router.

``NVMCluster`` is the pool of passive blades plus the authoritative shard
directory (paper §4.3: blades "can be shared by multiple servers" and
mirrored for availability).  It owns no data path — blades stay passive —
but it is where reconfiguration (failover, scale-out, migration) is
serialized and the directory epoch is bumped.

``ClusterFrontEnd`` is one client machine talking to *many* blades: it owns
one ``FrontEnd`` (cache + write buffer + allocator + log channels) per blade,
so the R/C/B optimizations of the single-blade design compose per shard, and
memory-log / op-log flushes fan out per blade instead of funneling through
one NIC.  A local virtual clock serializes the client's own ops across
blades while leaving different clients free to hit different blades'
links concurrently — which is exactly where the aggregate-bandwidth win of a
multi-blade cluster comes from (fig_cluster_scaling).

Staleness protocol (leases): every data-path entry point calls
``ensure_fresh()``.  A front-end holding a valid directory lease validates
*locally* against its own snapshot — no authoritative check, no cost.  The
snapshot is a real clone (``ShardDirectory.clone``), so stale routing is
physically possible; what makes it safe is the other half of the contract:
every reconfiguration (migration, failover promotion, scale-out, reboot
epoch bump) REVOKES all outstanding leases — paying one invalidation round
per holder (``CostModel.lease_invalidate_ns``) — *before* it swaps the
mapping.  A revoked or expired lease forces the full refresh path: drain
staged state on healthy blades, drop every per-blade front-end (lazily
rebound), re-fetch the directory blob, and acquire a fresh lease
(``lease_grant_ns`` on top of the fetch round).  Lease expiry
(``NVMCluster.lease_ttl_ns``) bounds the stale window if a revocation is
lost in a real deployment; in steady state it shows up as one renewal
fetch per TTL instead of a validation per op.

Replica reads: the sharded layer (which owns the per-structure op streams)
pins keys this front-end wrote until the mirror applied watermark passes
their op-sequence number, preserving read-your-writes when ``get`` /
``get_many`` route to mirror endpoints.

``ClusterWaveScheduler`` is the cluster-level wave scheduler: per-blade
``batch_all()`` windows (and their close fences) overlap — every blade's
sub-batch starts at the same client time and the client resumes at the
*latest* blade completion — instead of draining blades serially.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from ..core.backend import CrashError, NVMBackend
from ..core.frontend import FEConfig, FrontEnd
from ..core.sim import Clock, CostModel
from .. import obs
from ..device import resolve_device
from ..obs.hist import LatencyHistogram
from .directory import LeaseTable, ShardDirectory
from .failover import promote_blade


class NVMCluster:
    """A pool of NVM blades + the authoritative, epoch-versioned directory.

    Every blade's arena, and its mirrors', lives on `device`: the card
    unless ``device="cpu"`` (``repro_torch.device.resolve_device``; raises
    when no card is there).  Blades that join later (``add_blade``) and
    mirrors promoted in a failover stay on the same device, so a cluster
    never mixes devices."""

    def __init__(
        self,
        n_blades: int = 2,
        capacity_per_blade: int = 1 << 26,
        block_size: int = 256,
        cost: Optional[CostModel] = None,
        num_mirrors: int = 1,
        n_shards: int = 16,
        name_slots: int = 1 << 13,
        lease_ttl_ns: float = 2_000_000.0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.cost = cost or CostModel()
        self.capacity_per_blade = capacity_per_blade
        self.block_size = block_size
        self.num_mirrors = num_mirrors
        # cluster blades host many shard-sized structures, each burning a
        # dozen naming slots, so they get a much larger naming table than a
        # standalone blade's 512 slots
        self.name_slots = name_slots
        self.lease_ttl_ns = lease_ttl_ns
        self.blades: Dict[int, NVMBackend] = {
            i: NVMBackend(
                capacity_per_blade,
                block_size,
                self.cost,
                num_mirrors=num_mirrors,
                blade_id=i,
                name_slots=name_slots,
                device=self.device,
            )
            for i in range(n_blades)
        }
        self.directory = ShardDirectory(n_shards, sorted(self.blades))
        self.directory.persist(self.blades)
        self.leases = LeaseTable()
        self.leases.persist(self.blades)
        self.failovers = 0
        self.migrations = 0
        self._frontends: List["weakref.ref[ClusterFrontEnd]"] = []
        # observability: cluster-level control events land on one trace track
        self.trace = None
        self._track = None
        sess = obs.session()
        if sess is not None:
            sess.register_cluster(self)
            if sess.tracer is not None:
                self.trace = sess.tracer
                self._track = self.trace.track("cluster", kind="cluster")

    # ------------------------------------------------------------- front-ends
    def register_frontend(self, cfe: "ClusterFrontEnd") -> None:
        self._frontends.append(weakref.ref(cfe))

    def frontends(self) -> List["ClusterFrontEnd"]:
        live = [r() for r in self._frontends]
        self._frontends = [r for r, c in zip(self._frontends, live) if c is not None]
        return [c for c in live if c is not None]

    def quiesce_blade(self, blade_id: int) -> None:
        """Flush every registered front-end's staged channel to one blade (a
        migration barrier: afterwards the blade's log areas contain every
        acked op, so a log-replay catch-up cannot miss staged writes)."""
        be = self.blades[blade_id]
        for cfe in self.frontends():
            fe = cfe.fes.get(blade_id)
            if fe is None or fe.backend is not be or not be.alive:
                continue
            fe.clock.advance_to(cfe.clock.now)
            fe.drain_all()
            cfe.clock.advance_to(fe.clock.now)

    # ----------------------------------------------------------------- leases
    def revoke_leases(self, clock: Optional[Clock] = None,
                      shards: Optional[Iterable[int]] = None) -> int:
        """Invalidate every outstanding directory lease and re-persist the
        lease table — the mandatory first step of ANY reconfiguration: only
        after the broadcast lands may the mapping swap, so no lease holder
        can keep routing ops at a source that is about to be tombstoned.
        Costs one invalidation round per holder, charged to the initiator's
        `clock` when one is in scope (an external admin action passes
        None).  Returns the number of leases revoked.

        ``shards`` names the invalidation **groups** the reconfiguration
        actually affects: migration passes the moved shard, failover the
        failed blade's shards, and ``None`` means every group (directory
        rebuilt / topology changed).  The set rides the revocation round to
        every registered front-end, which drops exactly those groups from
        its result caches — no extra messages, so no extra sim-time cost
        beyond the per-holder invalidation already charged above."""
        n = self.leases.revoke_all()
        if n and clock is not None:
            clock.advance(n * self.cost.lease_invalidate_ns)
        self.leases.persist(self.blades)
        if n:
            obs.count("lease_revocations", n)
            if self.trace is not None:
                self.trace.instant(self._track, "lease_revoke",
                                   clock.now if clock is not None else None,
                                   {"holders": n})
        groups = None if shards is None else tuple(shards)
        for cfe in self.frontends():
            cfe._on_invalidation(groups)
        return n

    # ------------------------------------------------------------- membership
    def add_blade(self) -> int:
        """Elastic scale-out: a new empty blade joins; shards move to it only
        via explicit rebalance (see rebalance.migrate_shard)."""
        bid = max(self.blades) + 1
        self.blades[bid] = NVMBackend(
            self.capacity_per_blade,
            self.block_size,
            self.cost,
            num_mirrors=self.num_mirrors,
            blade_id=bid,
            name_slots=self.name_slots,
            device=self.device,
        )
        # an empty blade joining moves no data: no result group is affected
        self.revoke_leases(shards=())
        self.directory.add_blade(bid)
        self.directory.bump_epoch()
        self.directory.persist(self.blades)
        obs.count("blades_added")
        if self.trace is not None:
            self.trace.instant(self._track, "add_blade", None, {"blade": bid})
        return bid

    # --------------------------------------------------------------- failures
    def handle_blade_failure(self, blade_id: int, clock: Optional[Clock] = None) -> NVMBackend:
        """Bring blade `blade_id` back: reboot after a transient power loss,
        or promote its mirror after a permanent failure.  Idempotent — the
        first front-end to notice performs the recovery; later callers see an
        alive blade and just rebind."""
        be = self.blades[blade_id]
        if be.alive:
            return be
        if be.permanent_failure:
            if not be.mirrors:
                raise CrashError(
                    f"blade {blade_id} failed permanently with no mirror to promote"
                )
            return promote_blade(self, blade_id, clock=clock)
        be.reboot()
        self.revoke_leases(clock, shards=self.directory.shards_on(blade_id))
        self.directory.bump_epoch()
        self.directory.persist(self.blades)
        obs.count("blade_reboots")
        if self.trace is not None:
            self.trace.instant(self._track, "reboot",
                               clock.now if clock is not None else None,
                               {"blade": blade_id})
        return be

    # ------------------------------------------------------------------ admin
    def bootstrap_directory(self) -> ShardDirectory:
        """Cold start from bytes alone (any surviving blade copy wins).
        Outstanding leases are recovered the same way, then revoked: a
        restarted authority cannot honour promises it no longer remembers
        making, so every holder re-validates."""
        d = ShardDirectory.bootstrap(self.blades)
        if d is None:
            raise CrashError("no live blade holds a valid directory copy")
        self.leases = LeaseTable.bootstrap(self.blades)
        self.revoke_leases()
        self.directory = d
        return d

    def alive_blades(self) -> List[int]:
        return [b for b, be in self.blades.items() if be.alive]


class ClusterWaveScheduler:
    """Cluster-level wave scheduling: fan per-blade work out so every
    blade's sub-batch — including its ``batch_all()`` window and the close
    fence of any doorbell write wave inside — starts at the same client
    time and runs against its own front-end/link, with the client resuming
    at the *latest* blade completion.  Per-op routing (and the previous
    serial drains) needlessly serialized windows that target disjoint
    links; overlapping them is the read-side counterpart of the write-wave
    refactor's aggregate-bandwidth argument."""

    def __init__(self, cfe: "ClusterFrontEnd"):
        self.cfe = cfe

    def run(
        self,
        per_blade: Dict[int, Callable[[FrontEnd], object]],
        *,
        combined: bool = False,
        bind: Optional[Callable[[int], FrontEnd]] = None,
    ) -> Dict[int, object]:
        """Run `per_blade[bid](fe)` for every blade, overlapped.  With
        ``combined`` each blade's thunk runs inside that front-end's
        cross-structure ``batch_all()`` window (ONE combined oplog+memlog
        posted write per blade).  ``bind`` overrides front-end resolution
        (the drain path operates on the already-bound fleet instead of
        rebinding through the directory)."""
        cfe = self.cfe
        resolve = bind or cfe.fe_for_blade
        t0 = cfe.clock.now
        out: Dict[int, object] = {}
        end = t0
        for bid in sorted(per_blade):
            fe = resolve(bid)
            fe.clock.advance_to(t0)
            if combined:
                with fe.batch_all():
                    out[bid] = per_blade[bid](fe)
            else:
                out[bid] = per_blade[bid](fe)
            end = max(end, fe.clock.now)
        cfe.clock.advance_to(end)
        tr = cfe.trace
        if tr is not None:
            tr.span(cfe._track, "cluster_batch", t0, end,
                    {"blades": len(per_blade)})
        return out


class ClusterFrontEnd:
    """One client's view of the cluster: a per-blade FrontEnd fleet, routed
    through a leased directory snapshot, serialized on a single client
    clock."""

    def __init__(self, cluster: NVMCluster, config: Optional[FEConfig] = None, fe_id: int = 0):
        self.cluster = cluster
        self.cfg = config or FEConfig()
        self.fe_id = fe_id
        self.cost = cluster.cost
        self.clock = Clock()
        self.fes: Dict[int, FrontEnd] = {}
        self.directory: Optional[ShardDirectory] = None  # leased snapshot
        self.epoch = -1  # force a fetch (and its cost) on first use
        self.directory_fetches = 0
        self.lease_validations = 0  # ops validated locally under the lease
        self.failovers_initiated = 0  # data-path-triggered fence+promote
        # write-lease cache: (scope, shard) -> fencing epoch this client
        # holds (scope = ``scope_of(structure name)``).  A write validates
        # locally against the authoritative table (free, the same contract
        # as read leases); a miss/steal pays the grant round.
        self._write_epochs: Dict[Tuple[int, int], int] = {}
        self.write_lease_validations = 0
        # writer listeners: sharded structures that own op streams on this
        # client (weakrefs); a steal victim drains/fences through them
        self._writer_listeners: List[weakref.ref] = []
        self.scheduler = ClusterWaveScheduler(self)
        # observability: cluster-level op latencies (whole sharded batches /
        # singles, as seen by this client) + a trace track of its own.
        # Rebinds (epoch bumps, failovers) replace the per-blade FrontEnd
        # objects; their counters/histograms are folded into the _retired_*
        # accumulators first so telemetry survives the rebind.
        self.op_hist: Dict[str, LatencyHistogram] = {}
        self._retired_op_hists: Dict[str, LatencyHistogram] = {}
        self._retired_stats: Dict[str, int] = {}
        self.trace = cluster.trace
        self._track = (self.trace.track(f"cfe{fe_id}")
                       if self.trace is not None else None)
        # result-cache invalidation listeners (sharded structures with a
        # ResultCache attached); weakrefs — a listener must not outlive its
        # structure.  Fed by the cluster's lease-revocation broadcast.
        self._invalidation_listeners: List[weakref.ref] = []
        sess = obs.session()
        if sess is not None:
            sess.register_cluster_frontend(self)
        cluster.register_frontend(self)
        self.ensure_fresh()

    # ------------------------------------------------- result-cache listeners
    def register_result_cache(self, listener) -> None:
        """Register an object with ``_invalidate_groups(shards)`` (a sharded
        structure owning a ResultCache) for reconfiguration broadcasts."""
        self._invalidation_listeners.append(weakref.ref(listener))

    def _on_invalidation(self, shards) -> None:
        """Lease-revocation broadcast hook: drop the affected invalidation
        groups (``None`` = all) from every registered result cache.  Rides
        the already-charged revocation round — no extra sim-time cost."""
        if not self._invalidation_listeners:
            return
        live = [r() for r in self._invalidation_listeners]
        self._invalidation_listeners = [
            r for r, o in zip(self._invalidation_listeners, live) if o is not None]
        for obj in live:
            if obj is not None:
                obj._invalidate_groups(shards)

    # ------------------------------------------------------- epoch validation
    def ensure_fresh(self) -> bool:
        """Validate the cached directory snapshot.

        Inside a valid lease window this is LOCAL: no authoritative check,
        no cost — the revoke-before-swap contract guarantees the snapshot
        cannot be stale while the lease stands.  A revoked/expired lease
        (or a cold start) pays the full path: drain staged state on healthy
        blades and drop every per-blade front-end if the epoch moved, then
        one round to re-fetch the directory blob plus the lease grant.
        Returns True when the epoch (and thus the binding) changed."""
        now = self.clock.now
        if self.directory is not None and self.cluster.leases.valid(self.fe_id, self.epoch, now):
            self.lease_validations += 1
            return False
        tr = self.trace
        t0 = now
        d = self.cluster.directory
        changed = d.epoch != self.epoch or self.directory is None
        if changed:
            for bid, fe in list(self.fes.items()):
                be = self.cluster.blades.get(bid)
                if be is not None and be.alive and fe.backend is be:
                    fe.clock.advance_to(self.clock.now)
                    try:
                        fe.drain_all()
                    except CrashError:
                        pass  # blade died mid-drain: those staged ops are lost
                    self.clock.advance_to(fe.clock.now)
                self._retire_fe(fe)
                del self.fes[bid]
        self.clock.advance(
            self.cost.issue_ns + self.cost.rtt_ns + self.cost.xfer_ns(len(d.encode()))
            + self.cost.lease_grant_ns
        )
        self.directory_fetches += 1
        self.directory = d.clone()
        self.epoch = d.epoch
        if self.cluster.leases.grant(self.fe_id, self.epoch, self.clock.now,
                                     self.cluster.lease_ttl_ns):
            # durable table changed (new holder / new epoch) — a pure
            # expiry renewal skips the per-blade blob rewrite
            self.cluster.leases.persist(self.cluster.blades)
        if tr is not None:
            tr.span(self._track, "lease_refresh", t0, self.clock.now,
                    {"epoch": self.epoch, "rebound": changed})
            tr.instant(self._track, "lease_grant", self.clock.now,
                       {"fe": self.fe_id, "epoch": self.epoch})
        return changed

    # ------------------------------------------------------------ write leases
    def register_writer(self, listener) -> None:
        """Register an object with ``_surrender_shard(shard)`` (a sharded
        structure owning op streams) so a steal can drain/fence this
        client's staged windows for the taken shard."""
        self._writer_listeners.append(weakref.ref(listener))

    def ensure_write_lease(self, shard: int, shared: bool = False,
                           scope: int = 0) -> int:
        """Hold shard ``shard``'s write lease; returns the fencing epoch.

        ``scope`` is the structure's lease scope (``scope_of(name)``) —
        leases are per (structure, shard), so co-tenant structures never
        contend.  Holding an unexpired lease at the cached epoch validates
        locally — free, like read-lease validation.  Otherwise one grant
        round is charged; if a different live holder stands, this is a
        *steal*: the victim is asked to surrender gracefully (drain its
        staged window under its old epoch, piggyback its committed-tail
        watermark on the handoff) and is charged one invalidation round —
        an unreachable victim is simply fenced, its unacked ops left to die
        against the epoch check at the blade.
        """
        now = self.clock.now
        table = self.cluster.leases
        key = (scope, shard)
        cached = self._write_epochs.get(key)
        if cached is not None and table.valid_write(shard, self.fe_id,
                                                    cached, now, scope=scope):
            self.write_lease_validations += 1
            return cached
        tr = self.trace
        t0 = now
        self.clock.advance(self.cost.issue_ns + self.cost.rtt_ns
                           + self.cost.lease_grant_ns)
        holder = table.write_holder(shard, scope=scope)
        victim = None
        if (holder is not None and holder[0] != self.fe_id
                and now < holder[2]
                and not (shared or key in table.shared_shards)):
            for cfe in self.cluster.frontends():
                if cfe.fe_id == holder[0]:
                    victim = cfe
                    break
        was_shared = key in table.shared_shards
        epoch, stolen, prev = table.acquire_write(
            shard, self.fe_id, self.clock.now, self.cluster.lease_ttl_ns,
            shared=shared, scope=scope)
        if not was_shared and key in table.shared_shards:
            # steal ping-pong tripped the limit: writers on this shard now
            # share one epoch and serialize through the writer mutex
            obs.count("shared_mode_flips")
        if stolen:
            self.clock.advance(self.cost.lease_invalidate_ns)
            if victim is not None:
                victim.clock.advance_to(self.clock.now)
                wm = victim._surrender_write_lease(shard, scope=scope)
                self.clock.advance_to(victim.clock.now)
                if wm is not None:
                    table.set_watermark(shard, wm, scope=scope)
            obs.count("write_lease_steals")
            self.record_op_latency("lease_steal", self.clock.now - t0)
            if tr is not None:
                tr.instant(self._track, "lease_steal", self.clock.now,
                           {"shard": shard, "from": prev, "to": self.fe_id,
                            "epoch": epoch})
        if cached != epoch:
            obs.count("write_lease_grants")
            table.persist(self.cluster.blades)
        self._write_epochs[key] = epoch
        if tr is not None:
            tr.span(self._track, "write_lease", t0, self.clock.now,
                    {"shard": shard, "epoch": epoch, "stolen": stolen,
                     "shared": shared or key in table.shared_shards})
        return epoch

    def release_write_lease(self, shard: int,
                            watermark: Optional[int] = None,
                            scope: int = 0) -> None:
        """Hand shard ``shard``'s write lease back voluntarily, piggybacking
        the committed-tail watermark so the next holder can skip replay."""
        if self._write_epochs.pop((scope, shard), None) is None:
            return
        self.cluster.leases.release_write(shard, self.fe_id, watermark,
                                          scope=scope)

    def _surrender_write_lease(self, shard: int,
                               scope: int = 0) -> Optional[int]:
        """Steal-victim hook: drain every staged window for ``shard`` under
        the OLD epoch (the fence slot has not moved yet — the thief stamps
        it after this returns), drop the cached lease, and return the
        highest committed-tail watermark so the handoff can skip replay.
        Only listeners in the thief's lease scope surrender — a steal on
        one structure must not drain (or fence) a co-tenant structure's
        staged windows on the same shard index.  An already-dead blade
        means nothing can drain: return None and let the epoch fence kill
        whatever was in flight."""
        self._write_epochs.pop((scope, shard), None)
        wm: Optional[int] = None
        live = [r() for r in self._writer_listeners]
        self._writer_listeners = [
            r for r, o in zip(self._writer_listeners, live) if o is not None]
        for obj in live:
            if obj is None or getattr(obj, "_lease_scope", scope) != scope:
                continue
            try:
                w = obj._surrender_shard(shard)
            except CrashError:
                continue  # blade down: the fence handles the rest
            if w is not None:
                wm = w if wm is None else max(wm, w)
        return wm

    # --------------------------------------------------------------- binding
    def fe_for_blade(self, blade_id: int) -> FrontEnd:
        fe = self.fes.get(blade_id)
        be = self.cluster.blades[blade_id]
        if fe is None or fe.backend is not be:
            if fe is not None:
                self._retire_fe(fe)
            fe = FrontEnd(be, self.cfg, fe_id=self.fe_id)
            fe.clock.advance_to(self.clock.now)
            self.fes[blade_id] = fe
        return fe

    def run_on(self, blade_id: int, fn: Callable[[FrontEnd], object]):
        """Run `fn(fe)` against one blade with the client clock threaded
        through, so sequential ops across different blades stay causally
        ordered on this client."""
        fe = self.fe_for_blade(blade_id)
        fe.clock.advance_to(self.clock.now)
        try:
            return fn(fe)
        finally:
            self.clock.advance_to(fe.clock.now)

    # --------------------------------------------------------- batch dispatch
    def execute_batch(self, per_blade: Dict[int, Callable[[FrontEnd], object]],
                      combined: bool = True) -> Dict[int, object]:
        """Fan a batch out over blades through the cluster wave scheduler:
        ONE epoch check for the whole batch, per-blade sub-batches (and
        their window fences) overlapped on the fabric.

        With ``combined`` (the default) each blade's sub-batch runs inside
        that front-end's cross-structure ``batch_all()`` window: ops may
        span several handles on the blade and still drain as ONE combined
        oplog+memlog posted write per blade.  Callers that manage their own
        windows (e.g. the sharded batch dispatcher, which needs to observe
        the window close for all-or-none retry accounting) pass
        ``combined=False``.  Returns {blade_id: fn result}."""
        self.ensure_fresh()
        return self.scheduler.run(per_blade, combined=combined)

    def _probe_blade(self, be: NVMBackend) -> bool:
        """One un-retried liveness round against a suspect blade's link: the
        probe honors armed faults (a stall delays it, a pending drop eats it
        and costs the deadline) but never backs off — its whole job is to
        decide quickly whether the breaker opened on a transient blip or a
        genuinely unreachable endpoint."""
        lk = be.link
        f = lk.fault
        now = self.clock.now
        if f is not None and f.stall_until > now:
            self.clock.advance_to(f.stall_until)
            now = self.clock.now
        if f is not None and f.drop_pending > 0:
            f.drop_pending -= 1
            f.drops += 1
            self.clock.advance(self.cost.op_timeout_ns)
            return False
        end = lk.transfer(now + self.cost.issue_ns, 16)
        self.clock.advance_to(end + self.cost.rtt_ns)
        return True

    def recover_blade(self, blade_id: int) -> None:
        """Data-path failure handler: recover the blade (reboot / mirror
        promotion) and force a full rebind via the epoch bump (and lease
        revocation) it caused.

        Self-healing path: when the blade is still *alive* but its link
        breaker is open (consecutive WQE timeouts), probe it once.  A probe
        answer means the fault was transient — reset the breaker and rebind.
        No answer means the endpoint is unreachable for real: fence the
        blade (``fail_permanently``, so a zombie primary can't resurface
        mid-promotion) and let ``handle_blade_failure`` promote its mirror —
        the same revoke-before-swap promotion the tests drive by hand, now
        triggered from the data path."""
        be = self.cluster.blades[blade_id]
        tr = self.trace
        if be.alive:
            br = be.link.breaker
            if br is not None and br.is_open(self.clock.now):
                if self._probe_blade(be):
                    br.record_success()
                    obs.count("breaker_resets")
                    if tr is not None:
                        tr.instant(self._track, "breaker_reset", self.clock.now,
                                   {"blade": blade_id})
                else:
                    be.fail_permanently()
                    obs.count("unreachable_fenced")
                    if tr is not None:
                        tr.instant(self._track, "fenced", self.clock.now,
                                   {"blade": blade_id})
        acted = not be.alive
        self.cluster.handle_blade_failure(blade_id, clock=self.clock)
        if acted:
            self.failovers_initiated += 1
            obs.count("failovers_initiated")
        fe = self.fes.pop(blade_id, None)
        if fe is not None:
            self._retire_fe(fe)
        self.ensure_fresh()

    # ----------------------------------------------------------------- drains
    def drain_all(self) -> None:
        """Fan the per-blade drain hooks out over the fleet (clean shutdown /
        end-of-benchmark barrier), overlapped by the wave scheduler: every
        blade's combined flush and wave fence lands against its own link
        starting from the same client time."""
        if not self.fes:
            return
        self.scheduler.run(
            {bid: (lambda fe: fe.drain_all()) for bid in self.fes},
            bind=self.fes.__getitem__,
        )

    # -------------------------------------------------------------- telemetry
    def _retire_fe(self, fe: FrontEnd) -> None:
        """Fold a discarded per-blade front-end's counters and latency
        histograms into this client's accumulators before the object goes
        away (rebind / failover), so stats()/telemetry() cover the whole
        session, not just the current binding."""
        for k, v in fe.stats.snapshot().items():
            self._retired_stats[k] = self._retired_stats.get(k, 0) + v
        for op, h in fe.op_hist.items():
            self._retired_op_hists.setdefault(op, LatencyHistogram()).merge(h)

    def record_op_latency(self, op: str, dur_ns: float, n: int = 1) -> None:
        """Cluster-level op-latency histogram (whole sharded batches and
        singles, measured on this client's clock)."""
        h = self.op_hist.get(op)
        if h is None:
            h = self.op_hist[op] = LatencyHistogram()
        h.record(dur_ns, n)

    def stats(self) -> Dict[str, object]:
        """Cluster-wide Stats aggregation: summed counters over the bound
        per-blade front-ends plus the per-blade breakdown."""
        per_blade = {bid: fe.stats.snapshot()
                     for bid, fe in sorted(self.fes.items())}
        total: Dict[str, int] = dict(self._retired_stats)
        for snap in per_blade.values():
            for k, v in snap.items():
                total[k] = total.get(k, 0) + v
        return {"total": total, "per_blade": per_blade}

    def telemetry(self) -> Dict[str, object]:
        """Full telemetry snapshot: merged Stats, per-blade breakdown, and
        the op-latency histograms — per-blade histograms merged cluster-wide
        by op type (``op_latency``) plus this client's own batch-level
        histograms (``cluster_op_latency``).

        Both histogram families hold closed-loop **service** times (call to
        return on this client's clock; ``service_p*`` in bench rows).  True
        arrival-to-completion latency, which includes queueing under offered
        load, comes only from the open-loop engine's arrival histograms
        (``repro_torch.core.sim.OpenLoopEngine``, ``latency_p*`` columns)."""
        st = self.stats()
        merged = self.merged_op_hists()
        return {
            "stats": st["total"],
            "per_blade": st["per_blade"],
            "op_latency": {op: h.snapshot() for op, h in sorted(merged.items())},
            "cluster_op_latency": {op: h.snapshot()
                                   for op, h in sorted(self.op_hist.items())},
            "lease_validations": self.lease_validations,
            "write_lease_validations": self.write_lease_validations,
            "directory_fetches": self.directory_fetches,
            "failovers_initiated": self.failovers_initiated,
            "epoch": self.epoch,
        }

    def merged_op_hists(self) -> Dict[str, LatencyHistogram]:
        """Per-blade op-latency histograms merged by op type (live objects,
        for callers that need percentiles beyond the snapshot)."""
        merged: Dict[str, LatencyHistogram] = {
            op: h.copy() for op, h in self._retired_op_hists.items()
        }
        for fe in self.fes.values():
            for op, h in fe.op_hist.items():
                merged.setdefault(op, LatencyHistogram()).merge(h)
        return merged

    # ------------------------------------------------------------------ stats
    def aggregate_stats(self) -> Dict[str, int]:
        total: Dict[str, int] = {}
        for fe in self.fes.values():
            for k, v in fe.stats.snapshot().items():
                total[k] = total.get(k, 0) + v
        return total
