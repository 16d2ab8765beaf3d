"""Arm scheduled faults against a live cluster.

The injector is driven by the workload loop: ``step(i)`` fires every
:class:`FaultSpec` whose ``at_op`` has come due before operation ``i``
runs.  Injections mutate only the existing fault hooks (``Link.inject``,
``NVMBackend.crash``/``fail_permanently``/``schedule_torn_write``,
``Mirror.set_lag``, ``NVMCluster.revoke_leases``) — detection and healing
stay entirely in the production path.  Every injection bumps a
``fault_<kind>`` obs counter and lands a ``fault:<kind>`` instant on the
cluster trace track, so an exported trace shows the injection next to the
reaction spans (``retry_backoff``, ``breaker_open``, ``fenced``,
``promotion``) it provoked.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import obs
from ..cluster.router import NVMCluster
from ..core.sim import Clock
from .plan import FaultPlan, FaultSpec


class FaultInjector:
    """Replays a :class:`FaultPlan` against `cluster` as a workload runs.

    `clock` supplies "now" for stall windows (the driving client's clock);
    `table` and `n_shards` let ``torn_watermark`` faults resolve a real
    structure name on whichever blade currently owns the shard."""

    def __init__(self, plan: FaultPlan, cluster: NVMCluster,
                 clock: Optional[Clock] = None, *,
                 table: Optional[str] = None, n_shards: Optional[int] = None):
        self.plan = plan
        self.cluster = cluster
        self.clock = clock
        self.table = table
        self.n_shards = n_shards if n_shards is not None else cluster.directory.n_shards
        self._ptr = 0
        #: (due_op, blade, mirror_idx) replication queues waiting to drain
        self._stalled: List[Tuple[int, int, int]] = []
        self.injected: Dict[str, int] = {}

    # ------------------------------------------------------------------ drive
    def step(self, op_idx: int) -> None:
        """Fire every fault due at or before `op_idx` (call right before
        the workload issues operation `op_idx`)."""
        for rec in [r for r in self._stalled if r[0] <= op_idx]:
            self._stalled.remove(rec)
            self._drain_mirror(rec[1], rec[2])
        specs = self.plan.specs
        while self._ptr < len(specs) and specs[self._ptr].at_op <= op_idx:
            spec = specs[self._ptr]
            self._ptr += 1
            self._apply(spec, op_idx)

    def finish(self) -> None:
        """Close the chaos window: disarm tears and link faults that never
        fired and drain stalled replication queues.  Breakers and dead
        blades are left alone — healing them is the system's job, and the
        post-run verification must run against whatever it did."""
        while self._stalled:
            _, bid, midx = self._stalled.pop()
            self._drain_mirror(bid, midx)
        for be in self.cluster.blades.values():
            be.cancel_torn_write()
            f = be.link.fault
            if f is not None:
                f.drop_pending = 0
                f.dup_pending = 0
                f.stall_until = 0.0

    # ------------------------------------------------------------- application
    def _note(self, spec: FaultSpec, **extra) -> None:
        self.injected[spec.kind] = self.injected.get(spec.kind, 0) + 1
        obs.count(f"fault_{spec.kind}")
        cl = self.cluster
        if cl.trace is not None:
            args = {"blade": spec.blade, "at_op": spec.at_op}
            args.update(extra)
            cl.trace.instant(cl._track, f"fault:{spec.kind}",
                             self.clock.now if self.clock is not None else None,
                             args)

    def _drain_mirror(self, bid: int, midx: int) -> None:
        be = self.cluster.blades.get(bid)
        if be is not None and midx < len(be.mirrors):
            be.mirrors[midx].set_lag(0)

    def _apply(self, spec: FaultSpec, op_idx: int) -> None:
        cl = self.cluster
        be = cl.blades.get(spec.blade)
        if be is None:
            return
        kind = spec.kind
        if kind == "wqe_drop":
            be.link.inject().drop_pending += spec.a
        elif kind == "wqe_dup":
            be.link.inject().dup_pending += spec.a
        elif kind == "nic_stall":
            f = be.link.inject()
            now = self.clock.now if self.clock is not None else 0.0
            f.stall_until = max(f.stall_until, now + spec.a)
        elif kind == "crash":
            if not be.alive or be.permanent_failure:
                return
            be.crash()
        elif kind == "perm_fail":
            if not be.alive or not be.mirrors:
                return  # unpromotable double-kill would just end the run
            be.fail_permanently()
        elif kind == "nic_dead":
            if not be.alive or not be.mirrors:
                return
            # alive but unreachable: every completion from now on is lost.
            # Retries exhaust, the breaker opens, the probe fails, and the
            # front-end fences + promotes — all from the data path.
            be.link.inject().drop_pending = 1 << 30
        elif kind == "lag_spike":
            if not be.mirrors:
                return
            be.mirrors[spec.b % len(be.mirrors)].set_lag(spec.a)
        elif kind == "repl_stall":
            if not be.mirrors:
                return
            midx = spec.a % len(be.mirrors)
            be.mirrors[midx].set_lag(1 << 20)
            self._stalled.append((op_idx + spec.b, spec.blade, midx))
        elif kind == "lease_expiry":
            cl.revoke_leases(None)
        elif kind == "torn_write":
            if not be.alive:
                return
            be.schedule_torn_write(spec.a, after_writes=spec.b)
        elif kind == "torn_watermark":
            if self.table is None:
                return
            shard = spec.a % self.n_shards
            bid = cl.directory.blade_of(shard)
            tgt = cl.blades[bid]
            name = f"{self.table}.s{shard}.seq"
            if not tgt.alive or not tgt.has_name(name):
                return
            tgt.schedule_torn_write(8 if spec.b else 0, at_name=name)
            self._note(spec, shard=shard, resolved_blade=bid)
            return
        else:  # pragma: no cover - plan generator only emits known kinds
            raise ValueError(f"unknown fault kind {kind!r}")
        self._note(spec)
