"""Chaos harness: random ops vs a random fault schedule, durability-checked.

One ``run_chaos_schedule(seed)`` call is one experiment:

  * a fresh cluster and a sharded hash table under a per-op-durable
    front-end config (sync op-log rounds, tiny cache) — an op that RETURNS
    has its log entry committed on NVM, so "acked" and "durable" coincide;
  * a seeded random op stream (put/get/delete/get_many) interleaved with a
    seeded :class:`FaultPlan` covering every fault class;
  * the durability oracle, tracked as *admissible value sets*: an acked
    write collapses its key to the one written value; a write that raised
    (the fault window outlived the bounded retries) leaves the key's old
    AND new values admissible — a committed-but-unacked op-log tail may
    legally replay later — but nothing else, ever.  Any observed third
    value is torn or resurrected state and fails the run.

Checked at four points: every mid-run read, a drain + read-back on the
writer, a COLD re-attach from a second client (exercising the first-touch
replay of a committed-but-unapplied tail), and a fault-free replay of the
acked prefix on a pristine cluster, which must agree with the survivor on
every key whose admissible set is a singleton.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import torch

from ..cluster import ClusterFrontEnd, NVMCluster, ShardedHashTable
from ..core import CrashError, FEConfig
from ..core.oplog import stale_epoch_entries
from .inject import FaultInjector
from .plan import FaultPlan

#: sentinel for "key absent" inside admissible sets (None is a real value
#: domain member for gets, so absence gets its own marker)
ABSENT = object()

KEYSPACE = 512


@dataclass
class ChaosResult:
    seed: int
    n_ops: int
    acked: int = 0
    failed: int = 0
    violations: List[str] = field(default_factory=list)
    injected: Dict[str, int] = field(default_factory=dict)
    promotions: int = 0
    failovers_initiated: int = 0
    stats: Dict[str, int] = field(default_factory=dict)
    sim_ms: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.violations


def _durable_config() -> FEConfig:
    # sync op-log round per op + deliberately tiny cache: every ack implies
    # the entry bytes and the seq watermark landed on remote NVM first
    return FEConfig.rc(cache_bytes=4096, oplog_pipeline=1)


def _check(violations: List[str], where: str, key: int, got,
           admissible: Set) -> None:
    want = admissible if admissible else {ABSENT}
    norm = ABSENT if got is None else got
    if norm not in want:
        pretty = sorted("<absent>" if v is ABSENT else str(v) for v in want)
        violations.append(
            f"{where}: key {key} -> {got!r}, admissible {{{', '.join(pretty)}}}")


def run_chaos_schedule(
    seed: int,
    *,
    n_ops: int = 120,
    n_blades: int = 3,
    preload: int = 32,
    n_faults: int = 6,
    n_shards: int = 8,
    num_mirrors: int = 1,
    kinds: Optional[Sequence[str]] = None,
    ensure: Sequence[str] = (),
    verify_replay: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> ChaosResult:
    """Run one seeded chaos experiment; see module docstring for the oracle.
    Both clusters, the faulty one and the oracle's clean one, live on
    `device` (the card unless ``device="cpu"``)."""
    res = ChaosResult(seed=seed, n_ops=n_ops)
    cluster = NVMCluster(n_blades=n_blades, capacity_per_blade=1 << 22,
                         n_shards=n_shards, num_mirrors=num_mirrors, device=device)
    cfe = ClusterFrontEnd(cluster, _durable_config(), fe_id=0)
    table = ShardedHashTable(cfe, "chaos", n_buckets=256)
    rng = random.Random(seed)

    # admissible[k]: the set of values a read of k may legally return
    admissible: Dict[int, Set] = {}
    # the acked prefix, replayed fault-free for the byte-level comparison
    acked_ops: List[Tuple[str, int, int]] = []

    for k in rng.sample(range(KEYSPACE), preload):
        table.put(k, k)
        admissible[k] = {k}
        acked_ops.append(("put", k, k))
    table.drain()

    plan = FaultPlan.random(seed ^ 0x5EED, n_ops, n_blades,
                            n_faults=n_faults, kinds=kinds, ensure=ensure)
    inj = FaultInjector(plan, cluster, cfe.clock,
                        table="chaos", n_shards=n_shards)

    for i in range(n_ops):
        inj.step(i)
        r = rng.random()
        k = rng.randrange(KEYSPACE)
        if r < 0.55:
            v = 1_000_000 + i
            try:
                table.put(k, v)
            except CrashError:
                # unacked: the write may have committed (log tail replayed
                # later) or died with the fault — both values stay legal
                admissible.setdefault(k, {ABSENT}).add(v)
                res.failed += 1
            else:
                admissible[k] = {v}
                acked_ops.append(("put", k, v))
                res.acked += 1
        elif r < 0.72:
            try:
                got = table.get(k)
            except CrashError:
                res.failed += 1
            else:
                _check(res.violations, f"read@op{i}", k, got,
                       admissible.get(k, {ABSENT}))
                res.acked += 1
        elif r < 0.83:
            try:
                table.delete(k)
            except CrashError:
                admissible.setdefault(k, {ABSENT}).add(ABSENT)
                res.failed += 1
            else:
                admissible[k] = {ABSENT}
                acked_ops.append(("del", k, 0))
                res.acked += 1
        else:
            ks = [rng.randrange(KEYSPACE) for _ in range(8)]
            try:
                vals = table.get_many(ks)
            except CrashError:
                res.failed += 1
            else:
                for kk, got in zip(ks, vals):
                    _check(res.violations, f"read_many@op{i}", kk, got,
                           admissible.get(kk, {ABSENT}))
                res.acked += 1

    inj.finish()
    try:
        table.drain()
    except CrashError as e:  # the healed cluster must accept a clean drain
        res.violations.append(f"final drain failed: {e}")

    keys = sorted(admissible)
    try:
        for k, got in zip(keys, table.get_many(keys)):
            _check(res.violations, "readback", k, got, admissible[k])
    except CrashError as e:
        res.violations.append(f"writer read-back failed: {e}")

    # cold re-attach from a second client: first touch of every shard must
    # replay any committed-but-unapplied op-log tail before serving
    survivor: Dict[int, int] = {}
    try:
        cfe2 = ClusterFrontEnd(cluster, _durable_config(), fe_id=7)
        table2 = ShardedHashTable(cfe2, "chaos", n_buckets=256)
        for k, got in zip(keys, table2.get_many(keys)):
            _check(res.violations, "cold-attach", k, got, admissible[k])
            if got is not None:
                survivor[k] = got
    except CrashError as e:
        res.violations.append(f"cold re-attach failed: {e}")

    if verify_replay:
        clean = NVMCluster(n_blades=n_blades, capacity_per_blade=1 << 22,
                           n_shards=n_shards, num_mirrors=num_mirrors, device=device)
        cfe3 = ClusterFrontEnd(clean, _durable_config(), fe_id=0)
        table3 = ShardedHashTable(cfe3, "chaos", n_buckets=256)
        for op, k, v in acked_ops:
            if op == "put":
                table3.put(k, v)
            else:
                table3.delete(k)
        table3.drain()
        replay = dict(table3.items())
        for k in keys:
            if len(admissible[k]) != 1:
                continue  # unacked candidates: either outcome is legal
            want = next(iter(admissible[k]))
            have = replay[k] if k in replay else ABSENT
            if (want is ABSENT) != (have is ABSENT) or \
                    (want is not ABSENT and have != want):
                res.violations.append(
                    f"replay divergence: key {k} acked={want!r} replay={have!r}")
            sv = survivor.get(k, ABSENT)
            if sv is not ABSENT and sv != want:
                res.violations.append(
                    f"survivor divergence: key {k} acked={want!r} state={sv!r}")

    res.injected = dict(inj.injected)
    res.promotions = cluster.failovers
    res.failovers_initiated = sum(
        c.failovers_initiated for c in cluster.frontends())
    res.stats = {k: int(v) for k, v in cfe.stats()["total"].items()
                 if k in ("op_timeouts", "op_retries", "breaker_trips",
                          "degraded_reads", "replica_reads")}
    res.sim_ms = cfe.clock.now / 1e6
    return res


def _stale_epoch_total(cluster: NVMCluster) -> int:
    """Scan every blade op-log area for entries shadowed by an out-of-order
    epoch marker — committed bytes a stale (fenced) writer managed to land
    AFTER a newer epoch.  The write fence makes this structurally
    impossible, so any nonzero count is an interleaving violation.  Each
    area is read whole, past its head, in one copy from the blade."""
    total = 0
    for be in cluster.blades.values():
        for name, area in be._log_areas.items():
            if name.endswith(".oplog"):
                total += stale_epoch_entries(be._get(area.addr, area.size))
    return total


def run_steal_schedule(
    seed: int,
    *,
    n_ops: int = 140,
    n_blades: int = 2,
    preload: int = 24,
    n_faults: int = 5,
    n_shards: int = 8,
    num_mirrors: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> ChaosResult:
    """One seeded multi-writer chaos experiment: TWO writer front-ends share
    one sharded table, so every alternation on a shard is a live write-lease
    steal, while ``lease_expiry`` and ``crash`` faults race the handoffs.

    Same per-op-durable config and admissible-set oracle as
    :func:`run_chaos_schedule` (the simulator is serial, so issue order IS
    the serialization order), plus the fencing oracle: after the run, no op
    log on any blade may contain an entry shadowed by an out-of-order epoch
    marker — a stale writer's ops must vanish at the fence, never interleave
    behind a newer epoch.  ``res.stats`` reports the steal/fence activity so
    sweeps can assert the machinery actually fired.  Both clusters live on
    `device`, as in :func:`run_chaos_schedule`."""
    res = ChaosResult(seed=seed, n_ops=n_ops)
    cluster = NVMCluster(n_blades=n_blades, capacity_per_blade=1 << 22,
                         n_shards=n_shards, num_mirrors=num_mirrors, device=device)
    writers = [ClusterFrontEnd(cluster, _durable_config(), fe_id=i)
               for i in (0, 1)]
    tables = [ShardedHashTable(w, "steal", n_buckets=256) for w in writers]
    rng = random.Random(seed)

    admissible: Dict[int, Set] = {}
    acked_ops: List[Tuple[str, int, int]] = []

    for k in rng.sample(range(KEYSPACE), preload):
        tables[0].put(k, k)
        admissible[k] = {k}
        acked_ops.append(("put", k, k))
    tables[0].drain()

    plan = FaultPlan.random(seed ^ 0x57EA1, n_ops, n_blades,
                            n_faults=n_faults,
                            kinds=("lease_expiry", "crash"),
                            ensure=("lease_expiry", "crash"))
    inj = FaultInjector(plan, cluster, writers[0].clock,
                        table="steal", n_shards=n_shards)

    for i in range(n_ops):
        inj.step(i)
        w = rng.randrange(2)
        # both writers live on one global timeline: real time passes for the
        # idle writer too (its leases age toward expiry)
        writers[w].clock.advance_to(max(c.clock.now for c in writers))
        table = tables[w]
        r = rng.random()
        k = rng.randrange(KEYSPACE)
        if r < 0.6:
            v = 1_000_000 * (w + 1) + i
            try:
                table.put(k, v)
            except CrashError:
                admissible.setdefault(k, {ABSENT}).add(v)
                res.failed += 1
            else:
                admissible[k] = {v}
                acked_ops.append(("put", k, v))
                res.acked += 1
        elif r < 0.85:
            try:
                got = table.get(k)
            except CrashError:
                res.failed += 1
            else:
                _check(res.violations, f"read@op{i}.w{w}", k, got,
                       admissible.get(k, {ABSENT}))
                res.acked += 1
        else:
            try:
                table.delete(k)
            except CrashError:
                admissible.setdefault(k, {ABSENT}).add(ABSENT)
                res.failed += 1
            else:
                admissible[k] = {ABSENT}
                acked_ops.append(("del", k, 0))
                res.acked += 1

    inj.finish()
    for w, table in zip(writers, tables):
        try:
            w.clock.advance_to(max(c.clock.now for c in writers))
            table.drain()
        except CrashError as e:
            res.violations.append(f"final drain (writer {w.fe_id}) failed: {e}")

    keys = sorted(admissible)
    for w, table in zip(writers, tables):
        try:
            for k, got in zip(keys, table.get_many(keys)):
                _check(res.violations, f"readback.w{w.fe_id}", k, got,
                       admissible[k])
        except CrashError as e:
            res.violations.append(f"writer {w.fe_id} read-back failed: {e}")

    # cold re-attach: a third client must see the same committed state
    survivor: Dict[int, int] = {}
    try:
        cfe2 = ClusterFrontEnd(cluster, _durable_config(), fe_id=7)
        table2 = ShardedHashTable(cfe2, "steal", n_buckets=256)
        for k, got in zip(keys, table2.get_many(keys)):
            _check(res.violations, "cold-attach", k, got, admissible[k])
            if got is not None:
                survivor[k] = got
    except CrashError as e:
        res.violations.append(f"cold re-attach failed: {e}")

    # fault-free replay of the acked prefix (issue order = serial order)
    clean = NVMCluster(n_blades=n_blades, capacity_per_blade=1 << 22,
                       n_shards=n_shards, num_mirrors=num_mirrors, device=device)
    cfe3 = ClusterFrontEnd(clean, _durable_config(), fe_id=0)
    table3 = ShardedHashTable(cfe3, "steal", n_buckets=256)
    for op, k, v in acked_ops:
        if op == "put":
            table3.put(k, v)
        else:
            table3.delete(k)
    table3.drain()
    replay = dict(table3.items())
    for k in keys:
        if len(admissible[k]) != 1:
            continue
        want = next(iter(admissible[k]))
        have = replay[k] if k in replay else ABSENT
        if (want is ABSENT) != (have is ABSENT) or \
                (want is not ABSENT and have != want):
            res.violations.append(
                f"replay divergence: key {k} acked={want!r} replay={have!r}")
        sv = survivor.get(k, ABSENT)
        if sv is not ABSENT and sv != want:
            res.violations.append(
                f"survivor divergence: key {k} acked={want!r} state={sv!r}")

    stale = _stale_epoch_total(cluster)
    if stale:
        res.violations.append(
            f"{stale} stale-epoch op-log entries survived the fence")

    res.injected = dict(inj.injected)
    res.promotions = cluster.failovers
    res.failovers_initiated = sum(
        c.failovers_initiated for c in cluster.frontends())
    res.stats = {
        "write_lease_steals": cluster.leases.steals,
        "write_epoch": cluster.leases.write_epoch,
        "shared_shards": len(cluster.leases.shared_shards),
        "fenced_appends": sum(
            int(fe.stats.fenced_appends)
            for w in writers for fe in w.fes.values()),
        "stale_epoch_entries": stale,
    }
    res.sim_ms = max(c.clock.now for c in writers) / 1e6
    return res
