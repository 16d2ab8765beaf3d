"""Replica reads, leases and the result cache: the port against the
reference, on the CPU.

The scenarios of ``tests/test_replica_reads.py``, ``tests/test_result_cache.py``
and the lag-spike cases of ``tests/test_chaos.py`` run through both packages
(every blade on the CPU, ``tests/_cluster_driver.py``): ``ReadPolicy``
routing to mirror endpoints, the staleness bound against a lagging mirror,
read-your-writes pins, lease validation, renewal and revoke-before-swap,
the weighted rebalance, scans on mirrors, and the result cache's tiers and
its invalidation by group on migration and failover.  Every op's result,
every arena and mirror, clock, Stats, telemetry and cache counter must be
equal, and each scenario checks in the port what its reference test
asserts.  Blades are 4-16 MB where the reference's are 16-32 MB.
"""

import dataclasses
import random

import pytest

import _cluster_driver as drv

MB = 1 << 20
UNBOUNDED = 1 << 40


def _fe_state(fe) -> dict:
    return {"clock": fe.clock.now, "stats": dataclasses.asdict(fe.stats),
            "cache": (fe.cache.hits, fe.cache.misses)}


def _policy(ns, bound, mode="auto"):
    return ns.cluster.ReadPolicy(mode=mode, max_staleness_ops=bound)


def _freeze(cluster, lag=1 << 30):
    for be in cluster.blades.values():
        for m in be.mirrors:
            m.lag_writes = lag


def _thaw(cluster):
    for be in cluster.blades.values():
        for m in be.mirrors:
            m.lag_writes = 0
            m.sync()


# ------------------------------------------------------------- one blade
def _mirror_identity(ns):
    """Synchronous mirrors hold the primary's bytes; a promoted blade's
    mirrors are re-seeded and serve; a crashed primary's mirror still does."""
    core, st = ns.core, ns.structures
    be = core.NVMBackend(capacity=16 * MB, num_mirrors=2, **ns.kw)
    fe = core.FrontEnd(be, core.FEConfig.rcb(cache_bytes=4096))
    ht = st.RemoteHashTable(fe, "h", n_buckets=256)
    rng = random.Random(3)
    model = {}
    for _ in range(600):
        k = rng.randrange(250)
        if rng.random() < 0.75:
            v = rng.randrange(1 << 30)
            ht.put(k, v)
            model[k] = v
        else:
            ht.delete(k)
            model.pop(k, None)
    fe.drain(ht.h)
    with fe.replica_reads(_policy(ns, 0, "mirror")):
        got = ht.get_many(sorted(model))
    out = {"got": got, "blade": drv.blade_state(be), "fe": _fe_state(fe)}
    ok = got == [model[k] for k in sorted(model)] and fe.stats.replica_reads > 0
    serial = core.FEConfig(use_oplog=True, use_cache=False, use_batch=False)
    be2 = core.NVMBackend(capacity=16 * MB, num_mirrors=1, **ns.kw)
    fe2 = core.FrontEnd(be2, serial)
    h2 = st.RemoteHashTable(fe2, "h", n_buckets=64)
    for k in range(50):
        h2.put(k, k * 2)
    fe2.drain(h2.h)
    promoted = be2.promote_mirror(0)
    fe3 = core.FrontEnd(promoted, serial, fe_id=1)
    h3 = st.RemoteHashTable.recover(fe3, "h")
    h3.put(99, 7)
    fe3.drain(h3.h)
    with fe3.replica_reads(_policy(ns, 0, "mirror")):
        got3 = [h3.get(k) for k in range(50)] + [h3.get(99)]
    promoted.crash()
    with fe3.replica_reads(_policy(ns, 0, "mirror")):
        dead = h3.get(7)
    out.update(got3=got3, dead=dead, promoted=drv.blade_state(promoted), fe3=_fe_state(fe3))
    out["ok"] = ok and got3 == [k * 2 for k in range(50)] + [7] and dead == 14
    return out


def _lagging_bytes_stay_out_of_cache(ns):
    core, st = ns.core, ns.structures
    be = core.NVMBackend(capacity=16 * MB, num_mirrors=1, **ns.kw)
    fe = core.FrontEnd(be, core.FEConfig.rc())
    ht = st.RemoteHashTable(fe, "h", n_buckets=64)
    for k in range(20):
        ht.put(k, k)
    fe.drain(ht.h)
    be.mirrors[0].set_lag(1 << 20)
    for k in range(20):
        ht.put(k, k + 500)
    fe.drain(ht.h)
    fe.cache.clear()
    with fe.replica_reads(_policy(ns, UNBOUNDED, "mirror")):
        stale = [ht.get(k) for k in range(20)]
    fresh = [ht.get(k) for k in range(20)]
    mid = drv.blade_state(be)
    be.mirrors[0].set_lag(0)
    be.mirrors[0].sync()
    return {"stale": stale, "fresh": fresh, "mid": mid, "blade": drv.blade_state(be),
            "fe": _fe_state(fe), "ok": stale == list(range(20))
            and fresh == [k + 500 for k in range(20)]}


def _over_lag_falls_back(ns):
    core, st = ns.core, ns.structures
    be = core.NVMBackend(capacity=4 * MB, num_mirrors=1, **ns.kw)
    be.mirrors[0].lag_writes = 10_000
    fe = core.FrontEnd(be, core.FEConfig(use_oplog=True, use_cache=False, use_batch=False,
                                         oplog_pipeline=1))
    ht = st.RemoteHashTable(fe, "h", n_buckets=64)
    for k in range(40):
        ht.put(k, k + 100)
    with fe.replica_reads(_policy(ns, 3, "mirror")):
        got = [ht.get(k) for k in range(40)]
    return {"got": got, "blade": drv.blade_state(be), "fe": _fe_state(fe),
            "ok": got == [k + 100 for k in range(40)] and fe.stats.replica_reads == 0
            and fe.stats.replica_fallbacks > 0}


def _staleness_bound(lag, bound, seed):
    """tests/test_replica_reads.py's unique-value workload: every value a
    replica serves lies within the bound of the per-key history."""
    def run(ns):
        core, st = ns.core, ns.structures
        be = core.NVMBackend(capacity=4 * MB, num_mirrors=1, **ns.kw)
        be.mirrors[0].lag_writes = lag
        fe = core.FrontEnd(be, core.FEConfig(use_oplog=True, use_cache=False, use_batch=False,
                                             oplog_pipeline=1))
        ht = st.RemoteHashTable(fe, "h", n_buckets=64)
        policy = _policy(ns, bound, "mirror")
        rng = random.Random(seed)
        history, value_seq, served = {}, {}, []
        next_value, violations = 1, []
        for _ in range(120):
            k = rng.randrange(16)
            if rng.random() < 0.6 or k not in history:
                ht.put(k, next_value)
                history.setdefault(k, []).append((ht.h.seq, next_value))
                value_seq[next_value] = ht.h.seq
                next_value += 1
                continue
            committed, applied = ht.h.seq, be.replica_applied_seq("h")
            before = fe.stats.replica_fallbacks
            with fe.replica_reads(policy):
                got = ht.get(k)
            by_replica = fe.stats.replica_fallbacks == before
            served.append((k, got, by_replica, committed, applied))
            if by_replica:
                if committed - applied > bound:
                    violations.append(("bound", k))
                    continue
                floor = [s for s, _ in history[k] if s <= applied - 1]
                ok = (not floor) if got is None else (
                    got in value_seq and value_seq[got] <= applied
                    and (not floor or value_seq[got] >= max(floor)))
                if not ok:
                    violations.append(("value", k, got))
            elif got != history[k][-1][1]:
                violations.append(("primary", k, got))
        return {"served": served, "blade": drv.blade_state(be), "fe": _fe_state(fe),
                "ok": not violations}
    return run


# ---------------------------------------------------------------- cluster
def _ryw_lagging_mirrors(ns):
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, capacity=8 * MB)
    _freeze(cluster)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rcb(cache_bytes=4096), fe_id=0)
    ht = ns.cluster.ShardedHashTable(cfe, "ht", read_policy=_policy(ns, UNBOUNDED))
    rng = random.Random(9)
    model, ok, reads = {}, True, []
    for round_ in range(6):
        pairs = [(rng.randrange(1 << 16), round_ * 1000 + j) for j in range(80)]
        ht.put_many(pairs)
        model.update(pairs)
        keys = [k for k, _ in pairs]
        got = ht.get_many(keys)
        reads.append(got)
        ok &= got == [model[k] for k in keys] and ht.get(keys[0]) == model[keys[0]]
    pinned = all(k in ht._pinned for k in model)
    frozen = drv.cluster_state(cluster, [cfe])
    _thaw(cluster)
    ht.drain()
    keys = sorted(model)
    final = ht.get_many(keys)
    return {"reads": reads, "final": final, "frozen": frozen,
            "state": drv.cluster_state(cluster, [cfe]),
            "ok": ok and pinned and final == [model[k] for k in keys]
            and cfe.aggregate_stats()["replica_reads"] > 0 and not ht._pinned}


def _ryw_across_migration(ns):
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, capacity=8 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(cache_bytes=4096), fe_id=0)
    ht = ns.cluster.ShardedHashTable(cfe, "ht", read_policy=_policy(ns, UNBOUNDED))
    model = {}
    for k in range(600):
        ht.put(k, k + 50)
        model[k] = k + 50
    ht.drain()
    dst = cluster.add_blade()
    for m in cluster.blades[dst].mirrors:
        m.lag_writes = 1 << 30
    stats = ns.cluster.migrate_shard(ht, 0, dst)
    keys = sorted(model)
    got = ([ht.get(k) for k in keys], ht.get_many(keys))
    want = [model[k] for k in keys]
    return {"stats": stats, "got": got, "state": drv.cluster_state(cluster, [cfe]),
            "ok": got == (want, want)}


def _no_mirror_no_pins(ns):
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, num_mirrors=0)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=0)
    ht = ns.cluster.ShardedHashTable(cfe, "ht", read_policy=_policy(ns, 64))
    for k in range(500):
        ht.put(k, k)
    ht.put_many([(k, k) for k in range(500, 700)])
    pins = len(ht._pinned)
    got = ht.get_many(list(range(700)))
    return {"got": got, "state": drv.cluster_state(cluster, [cfe]),
            "ok": pins == 0 and got == list(range(700))}


def _lease_ttl(ns):
    out = {}
    for ttl in (50_000.0, 1e12):
        cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, lease_ttl_ns=ttl)
        cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=0)
        ht = ns.cluster.ShardedHashTable(cfe, "ht")
        for k in range(120):
            ht.put(k, k)
        ht.drain()
        out[ttl] = {"fetches": cfe.directory_fetches, "validations": cfe.lease_validations,
                    "state": drv.cluster_state(cluster, [cfe])}
    out["ok"] = (out[50_000.0]["fetches"] > 1 and out[1e12]["fetches"] == 1
                 and out[1e12]["validations"] > 100)
    return out


def _revoke_before_swap(ns, failover: bool):
    """A lease holder faults and refreshes after a migration, or after a
    promotion it did not make, and reads every committed value."""
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, capacity=8 * MB)
    F = ns.core.FEConfig
    a = ns.cluster.ClusterFrontEnd(cluster, F.rc(), fe_id=0)
    b = ns.cluster.ClusterFrontEnd(cluster, F.rc(), fe_id=1)
    ht_a = ns.cluster.ShardedHashTable(a, "ht")
    ht_b = ns.cluster.ShardedHashTable(b, "ht",
                                       read_policy=_policy(ns, 256) if failover else None)
    model = {}
    n = 240 if failover else 300
    for k in range(n):
        ht_a.put(k, k + 5)
        model[k] = k + 5
    ht_a.drain()
    first = [ht_b.get(k) for k in range(0, n, 17)]
    held = cluster.leases.valid(b.fe_id, b.epoch, b.clock.now)
    fetches = b.directory_fetches
    if failover:
        cluster.blades[1].fail_permanently()
        for k in range(n, n + 80):
            ht_a.put(k, k + 5)
            model[k] = k + 5
        ht_a.drain()
    else:
        ns.cluster.migrate_shard(ht_a, 3, cluster.add_blade())
    revoked = not cluster.leases.valid(b.fe_id, b.epoch, b.clock.now)
    keys = sorted(model)
    got = ht_b.get_many(keys) if failover else [ht_b.get(k) for k in keys]
    return {"first": first, "got": got, "state": drv.cluster_state(cluster, [a, b]),
            "ok": held and revoked and got == [model[k] for k in keys]
            and b.epoch == cluster.directory.epoch and b.directory_fetches > fetches
            and cluster.failovers == int(failover)}


def _weighted_rebalance(ns):
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, capacity=8 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=0)
    ht = ns.cluster.ShardedHashTable(cfe, "ht")
    model = {}
    for k in range(400):
        ht.put(k, k)
        model[k] = k
    ht.drain()
    d = cluster.directory
    hot_shards = d.shards_on(0)[:2]
    hot_keys = [k for k in range(4000) if d.shard_of(k) in hot_shards][:40]
    for _ in range(20):
        for k in hot_keys:
            if k in model:
                ht.get(k)
            else:
                ht.put(k, k)
                model[k] = k
    weights = [d.shard_weight(s) for s in range(8)]
    cluster.add_blade()
    moves = ns.cluster.rebalance(ht)
    items = sorted(ht.items())
    return {"weights": weights, "moves": moves, "loads": d.load_weights(), "items": items,
            "state": drv.cluster_state(cluster, [cfe]),
            "ok": bool(moves) and len({d.blade_of(s) for s in hot_shards}) == 2
            and items == sorted(model.items())}


def _scans_on_mirrors(ns):
    """items() and range_scan() fan their leaf reads out to mirrors under
    the policy; one unreleased pin keeps its shard's scan on the primary."""
    out, ok = {}, True
    for frozen in (False, True):
        cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, capacity=8 * MB)
        if frozen:
            _freeze(cluster)
        cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(cache_bytes=4096), fe_id=0)
        ht = ns.cluster.ShardedHashTable(cfe, "ht", read_policy=_policy(ns, UNBOUNDED))
        model = {k: k * 3 + 1 for k in range(300)}
        ht.put_many(sorted(model.items()))
        if not frozen:
            ht.drain()
        items = sorted(ht.items())
        replica = cfe.aggregate_stats()["replica_reads"]
        ok &= items == sorted(model.items()) and (replica == 0) == frozen
        if frozen:
            _thaw(cluster)
            ht.drain()
            ok &= sorted(ht.items()) == sorted(model.items())
            ok &= cfe.aggregate_stats()["replica_reads"] > 0
        out[frozen] = {"items": items, "state": drv.cluster_state(cluster, [cfe])}
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, capacity=8 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(cache_bytes=4096), fe_id=0)
    bt = ns.cluster.ShardedBPTree(cfe, "bt", read_policy=_policy(ns, UNBOUNDED))
    model = {k: k * 5 for k in range(0, 900, 3)}
    for k, v in model.items():
        bt.insert(k, v)
    bt.drain()
    before = cfe.aggregate_stats()["replica_reads"]
    scan = bt.range_scan(100, 700)
    ok &= scan == sorted((k, v) for k, v in model.items() if 100 <= k <= 700)
    ok &= cfe.aggregate_stats()["replica_reads"] > before and bt.items() == sorted(model.items())
    out.update(scan=scan, tree=drv.cluster_state(cluster, [cfe]), ok=ok)
    return out


def _lag_spike(spike, seed, by_time):
    """tests/test_chaos.py: a mirror lag spike (writes, or sim-ns composed
    with writes) mid-run never breaks read-your-writes."""
    def run(ns):
        cluster = drv.make_cluster(ns, n_blades=2, n_shards=4)
        cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(cache_bytes=4096), fe_id=0)
        t = ns.cluster.ShardedHashTable(cfe, "t", n_buckets=256, read_policy=_policy(ns, 8))
        rng = random.Random(seed)
        model = dict((k, k) for k in range(48))
        t.put_many(sorted(model.items()))
        reads, ok = [], True
        for step in range(12):
            if step == 5:
                for be in cluster.blades.values():
                    (be.mirrors[0].set_lag_ns(float(spike)) if by_time
                     else be.mirrors[0].set_lag(spike))
            if step == 8 and by_time:
                for be in cluster.blades.values():
                    be.mirrors[0].set_lag(3)
            ks = [rng.randrange(64) for _ in range(16)]
            if rng.random() < 0.5:
                t.put_many([(k, 1000 + step * 100 + j) for j, k in enumerate(ks)])
                for j, k in enumerate(ks):
                    model[k] = 1000 + step * 100 + j
            else:
                got = t.get_many(ks)
                reads.append(got)
                ok &= got == [model.get(k) for k in ks]
        spiked = drv.cluster_state(cluster, [cfe])
        for be in cluster.blades.values():
            be.mirrors[0].set_lag_ns(0)
            be.mirrors[0].set_lag(0)
        return {"reads": reads, "spiked": spiked, "state": drv.cluster_state(cluster, [cfe]),
                "ok": ok}
    return run


# ----------------------------------------------------------- result cache
def _rc_table(ns, cluster, entries=512, policy=None):
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig(
        use_oplog=True, use_cache=False, use_batch=True, result_cache_entries=entries), fe_id=0)
    return cfe, ns.cluster.ShardedHashTable(cfe, "ht", read_policy=policy)


def _rc_tiers(ns):
    """The ResultCache's LRU order and its key, group and global tiers."""
    RC = ns.cache.ResultCache
    rc = RC(capacity_entries=3)
    for k in (1, 2, 3):
        rc.put(k, k * 10, group=0)
    trace = [rc.get(1)]
    rc.put(4, 40, group=0)
    trace += [rc.get(k) for k in (2, 1, 3, 4)]
    rc2 = RC(capacity_entries=64)
    for k in range(10):
        rc2.put(k, k, group=k % 3)
    trace += [rc2.invalidate_key(4), rc2.invalidate_key(4), rc2.invalidate_group(0),
              rc2.get(1), rc2.invalidate_all()]
    rc3 = RC(capacity_entries=8)
    rc3.put(7, 70, group=1)
    rc3.put(7, 71, group=2)
    trace += [rc3.invalidate_group(1), rc3.get(7), rc3.invalidate_group(2), rc3.get(7)]
    try:
        RC(capacity_entries=0)
        refused = False
    except ValueError:
        refused = True
    return {"trace": trace, "counters": [dict(r.counters) for r in (rc, rc2, rc3)],
            "stats": [r.stats() for r in (rc, rc2, rc3)],
            "ok": refused and trace[:5] == [(True, 10), (False, None), (True, 10), (True, 30),
                                            (True, 40)] and rc3.stats()["hit_rate"] == 0.5}


def _rc_cluster_path(ns):
    """Hits, write fences and mixed get_many; global revocation; off by default."""
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, num_mirrors=0)
    cfe, ht = _rc_table(ns, cluster)
    rc = ht._result_cache
    ht.put(5, 50)
    trace = [ht.get(5)]
    t0 = cfe.clock.now
    trace.append(ht.get(5))
    local = cfe.clock.now - t0 < cfe.cost.rtt_ns
    ht.put(5, 51)
    trace.append(ht.get(5))
    ht.put_many([(k, k + 100) for k in range(20)])
    trace.append(ht.get_many(list(range(20))))
    ht.put_many([(k, k + 200) for k in range(5)])
    trace.append(ht.get_many(list(range(20))))
    entries = rc.stats()["entries"]
    cluster.revoke_leases()
    counters = dict(rc.counters)
    off = drv.make_cluster(ns, n_blades=2, n_shards=8, num_mirrors=0)
    cfe2 = ns.cluster.ClusterFrontEnd(off, ns.core.FEConfig.rcb(cache_bytes=4096), fe_id=0)
    ht2 = ns.cluster.ShardedHashTable(cfe2, "ht")
    ht2.put(1, 2)
    return {"trace": trace, "entries": entries, "counters": counters,
            "state": drv.cluster_state(cluster, [cfe]), "off": ht2._result_cache is None,
            "ok": trace[:3] == [50, 50, 51] and local and rc.stats()["entries"] == 0
            and trace[4] == [k + 200 for k in range(5)] + [k + 100 for k in range(5, 20)]
            and counters["invalidations_global"] == entries and ht2.get(1) == 2}


def _rc_reconfiguration(ns, failover: bool):
    """A migration drops exactly the moved shard's group; a failover the
    dead blade's shards'."""
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, num_mirrors=int(failover))
    cfe, ht = _rc_table(ns, cluster)
    ht.put_many([(k, k) for k in range(200)])
    if failover:
        ht.drain()
    ht.get_many(list(range(200)))
    rc = ht._result_cache
    before = rc.stats()["entries"]
    d = cluster.directory
    if failover:
        victim = d.blade_of(d.shard_of(0))
        gone = set(d.shards_on(victim))
        cluster.blades[victim].crash()
        ns.failover.promote_blade(cluster, victim, clock=cfe.clock)
    else:
        gone = {2}
        ns.cluster.migrate_shard(ht, 2, cluster.add_blade())
    expect = sum(1 for k in range(200) if d.shard_of(k) in gone)
    counters = dict(rc.counters)
    after = rc.stats()["entries"]
    got = ht.get_many(list(range(200)))
    return {"counters": counters, "entries": (before, after), "got": got,
            "state": drv.cluster_state(cluster, [cfe]),
            "ok": counters["invalidations_group"] == expect and after == before - expect
            and got == list(range(200))}


def _rc_pins(ns):
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8)
    _freeze(cluster)
    _, ht = _rc_table(ns, cluster, policy=_policy(ns, UNBOUNDED))
    rc = ht._result_cache
    ht.put_many([(k, k + 7) for k in range(30)])
    got = [ht.get_many(list(range(30))), [ht.get(k) for k in range(30)]]
    frozen = dict(rc.counters)
    _thaw(cluster)
    ht.drain()
    got += [ht.get_many(list(range(30))), ht.get_many(list(range(30)))]
    want = [k + 7 for k in range(30)]
    return {"got": got, "frozen": frozen, "counters": dict(rc.counters),
            "ok": got == [want] * 4 and frozen["admitted"] == frozen["hits"] == 0
            and frozen["pinned_bypass"] > 0 and rc.counters["hits"] > 0}


def _rc_safety(seed, lag, strict):
    """tests/test_result_cache.py's property: random writes, reads and all
    three invalidation tiers against a per-key history."""
    def run(ns):
        cluster = drv.make_cluster(ns, n_blades=2, n_shards=8)
        for be in cluster.blades.values():
            for m in be.mirrors:
                m.lag_writes = lag
        cfe, ht = _rc_table(ns, cluster, 128, _policy(ns, 0 if strict else UNBOUNDED))
        rc = ht._result_cache
        rng = random.Random(seed)
        history, next_value, reads, ok = {}, 1, [], True
        for _ in range(150):
            r = rng.random()
            k = rng.randrange(40)
            if r < 0.35:
                ht.put(k, next_value)
                history.setdefault(k, []).append(next_value)
                next_value += 1
            elif r < 0.45:
                pairs = [(rng.randrange(40), next_value + j) for j in range(4)]
                next_value += 4
                ht.put_many(pairs)
                for pk, pv in pairs:
                    history.setdefault(pk, []).append(pv)
            elif r < 0.85:
                got = ht.get(k)
                reads.append(got)
                ok &= got == (history[k][-1] if k in history else None)
            elif r < 0.90:
                rc.invalidate_group(rng.randrange(8))
            elif r < 0.95:
                cluster.revoke_leases(cfe.clock, shards=(rng.randrange(8), rng.randrange(8)))
            else:
                cluster.revoke_leases(cfe.clock)
        keys = sorted(history)
        final = [ht.get_many(keys), ht.get_many(keys)]
        ok &= final == [[history[k][-1] for k in keys]] * 2
        return {"reads": reads, "final": final, "counters": dict(rc.counters),
                "state": drv.cluster_state(cluster, [cfe]), "ok": ok}
    return run


def _replica_reads_bench(ns):
    """fig_cluster_scaling.run_replica_reads at 2 blades and one mirror,
    cut to a test's size: primary-only against replica-routed get_many."""
    out = {}
    for mode in ("primary", "replica"):
        policy = _policy(ns, 256) if mode == "replica" else None
        cluster = drv.make_cluster(ns, n_blades=2, n_shards=16, capacity=8 * MB)
        cfg = ns.core.FEConfig(use_oplog=True, use_cache=False, use_batch=True)
        cfes, tables, rngs, pools = [], [], [], []
        for i in range(4):
            cfe = ns.cluster.ClusterFrontEnd(cluster, cfg, fe_id=i)
            t = ns.cluster.ShardedHashTable(cfe, f"t{i}", n_buckets=256, read_policy=policy)
            rng = random.Random(2000 + i)
            pool = rng.sample(range(drv.KEYSPACE), 60)
            t.put_many([(k, k) for k in pool])
            t.drain()
            cfes.append(cfe)
            tables.append(t)
            rngs.append(rng)
            pools.append(pool)
        drv.reset_clocks(cluster, cfes)

        def step(i, done):
            n = min(16, 96 - done)
            rng, pool = rngs[i], pools[i]
            if rng.random() < 0.9:
                tables[i].get_many([rng.choice(pool) for _ in range(n)])
            else:
                tables[i].put_many([(rng.choice(pool), done + j) for j in range(n)])
            return n
        drv.interleave(cfes, 96, step)
        for t in tables:
            t.drain()
        out[mode] = {"kops": sum(96 / c.clock.now * 1e6 for c in cfes),
                     "state": drv.cluster_state(cluster, cfes)}
    out["ok"] = (out["replica"]["kops"] > out["primary"]["kops"]
                 and sum(f["aggregate"]["replica_reads"]
                         for f in out["replica"]["state"]["frontends"]) > 0)
    return out


SCENARIOS = {
    "mirror_identity_and_promotion": _mirror_identity,
    "lagging_bytes_stay_out_of_cache": _lagging_bytes_stay_out_of_cache,
    "over_lag_falls_back": _over_lag_falls_back,
    "ryw_lagging_mirrors": _ryw_lagging_mirrors,
    "ryw_across_migration": _ryw_across_migration,
    "no_mirror_no_pins": _no_mirror_no_pins,
    "lease_ttl": _lease_ttl,
    "revoke_before_migration": lambda ns: _revoke_before_swap(ns, failover=False),
    "revoke_before_failover": lambda ns: _revoke_before_swap(ns, failover=True),
    "weighted_rebalance": _weighted_rebalance,
    "scans_on_mirrors": _scans_on_mirrors,
    "rc_tiers": _rc_tiers,
    "rc_cluster_path": _rc_cluster_path,
    "rc_migration": lambda ns: _rc_reconfiguration(ns, failover=False),
    "rc_failover": lambda ns: _rc_reconfiguration(ns, failover=True),
    "rc_pins": _rc_pins,
    "replica_reads_bench": _replica_reads_bench,
}
for _lag, _bound, _seed in ((0, 0, 1), (7, 3, 11), (40, 30, 5), (25, 0, 999)):
    SCENARIOS[f"staleness_lag{_lag}_bound{_bound}"] = _staleness_bound(_lag, _bound, _seed)
for _spike, _seed, _by_time in ((1, 0, False), (200, 17, False), (5000, 3, True),
                                (1 << 40, 8, True)):
    SCENARIOS[f"lag_spike_{'ns' if _by_time else 'writes'}_{_spike}"] = \
        _lag_spike(_spike, _seed, _by_time)
for _seed, _lag, _strict in ((0, 0, True), (1, 3, False), (2, 1 << 30, False),
                             (3, 3, True), (4, 1 << 30, True)):
    SCENARIOS[f"rc_safety_seed{_seed}_lag{_lag}_{'strict' if _strict else 'pinned'}"] = \
        _rc_safety(_seed, _lag, _strict)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_replica_scenario_matches_reference(name):
    runs = drv.both(SCENARIOS[name])
    assert runs["repro"]["ok"], "the reference's own checks"
    drv.assert_same(runs)
    assert runs["repro_torch"]["ok"]
