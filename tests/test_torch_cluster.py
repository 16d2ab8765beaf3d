"""The port's cluster against the reference, on the CPU.

Each scenario of ``tests/test_cluster.py``, the cluster cases of
``tests/test_mirror_replication.py``, ``tests/test_vector_ops.py``,
``tests/test_chaos.py`` and ``tests/test_obs.py``, and README's cluster
quick start runs through ``repro.cluster`` and ``repro_torch.cluster``
(every blade on the CPU), through ``tests/_cluster_driver.py``.  What each
returns must be equal, bit for bit: every op's result, every blade's arena
and mirrors, the directory's and the lease table's bytes and epochs, every
front end's clock, Stats and telemetry.  Each scenario also checks, in the
port, what its reference test asserts (its ``ok``).  Blades are cut to
4-8 MB where the reference's are 32-64 MB; the op streams are the
reference tests' own.

A cluster written by either package restores in the other
(``repro_torch.core.convert.load_cluster`` / ``cluster_image``), and a
cluster asked for without a device needs a card.
"""

import random

import pytest
import torch

import _cluster_driver as drv
from repro_torch.core import convert

MB = 1 << 20


def _quickstart(ns):
    """README's cluster quick start."""
    cl = drv.make_cluster(ns, n_blades=4, n_shards=16, capacity=8 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cl, ns.core.FEConfig.rc(), fe_id=0)
    ht = ns.cluster.ShardedHashTable(cfe, "users")
    ht.put(42, 1)
    ht.drain()
    cl.blades[2].fail_permanently()
    got = ht.get(42)
    new = cl.add_blade()
    moves = ns.cluster.rebalance(ht)
    after = ht.get(42)
    return {"got": got, "after": after, "new": new, "moves": moves,
            "state": drv.cluster_state(cl, [cfe]), "ok": got == after == 1}


def _directory_and_leases(ns):
    """Encode, decode, torn copies and bootstrap of the directory and the
    lease table (tests/test_cluster.py, tests/test_replica_reads.py)."""
    cl_mod = ns.cluster
    d = cl_mod.ShardDirectory(32, [0, 1, 2])
    d.assign(5, 2)
    d.bump_epoch()
    raw = d.encode()
    torn = []
    for i in range(0, len(raw), 7):  # a flipped bit anywhere invalidates the blob
        broken = bytearray(raw)
        broken[i] ^= 0x40
        torn.append(cl_mod.ShardDirectory.decode(bytes(broken)) is None)
    torn.append(cl_mod.ShardDirectory.decode(raw[:-3]) is None)
    t = cl_mod.LeaseTable()
    t.grant(0, 3, 1000.0, 500.0)
    t.grant(7, 3, 2000.0, 500.0)
    lraw = t.encode()
    lbroken = bytearray(lraw)
    lbroken[5] ^= 0x10
    cluster = drv.make_cluster(ns, n_blades=3, n_shards=16)
    t.persist(cluster.blades)
    cluster.blades[0].crash()
    leases = cl_mod.LeaseTable.bootstrap(cluster.blades).leases
    # bootstrap prefers the highest epoch a survivor holds
    cluster.blades[0].reboot()
    cluster.directory.bump_epoch()
    cluster.directory.persist(cluster.blades)
    cluster.blades[0].crash()
    cluster.directory.bump_epoch()
    cluster.directory.persist(cluster.blades)
    cluster.blades[0].reboot()
    cluster.blades[2].fail_permanently()
    boot = cl_mod.ShardDirectory.bootstrap(cluster.blades)
    d2 = cl_mod.ShardDirectory.decode(raw)
    return {"raw": raw, "torn": torn, "decoded": (d2.epoch, d2.assignment, d2.blades),
            "lease_raw": lraw, "lease_torn": cl_mod.LeaseTable.decode(bytes(lbroken)) is None,
            "leases": leases, "boot": (boot.epoch, boot.encode()),
            "state": drv.cluster_state(cluster),
            "ok": all(torn) and boot.epoch == 2 and leases == t.leases}


def _routing(ns):
    """A sharded hash table over 4 blades against a dict model."""
    cluster = drv.make_cluster(ns, n_blades=4, n_shards=16, capacity=8 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=0)
    ht = ns.cluster.ShardedHashTable(cfe, "ht")
    model, results = {}, []
    rng = random.Random(7)
    for _ in range(1500):
        k = rng.randrange(400)
        r = rng.random()
        if r < 0.6:
            v = rng.randrange(1 << 30)
            ht.put(k, v)
            model[k] = v
        elif r < 0.8:
            results.append(ht.delete(k) == (k in model))
            model.pop(k, None)
        else:
            results.append(ht.get(k) == model.get(k))
    ht.drain()
    items = sorted(ht.items())
    used = {cluster.directory.blade_of(s) for s in range(cluster.directory.n_shards)}
    return {"results": results, "items": items, "state": drv.cluster_state(cluster, [cfe]),
            "ok": all(results) and items == sorted(model.items()) and used == set(cluster.blades)}


def _scans(ns):
    """ShardedBPTree and ShardedMVBPTree: sorted items and merged range scans."""
    cluster = drv.make_cluster(ns, n_blades=4, n_shards=16, capacity=8 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=0)
    bt = ns.cluster.ShardedBPTree(cfe, "bt")
    mv = ns.cluster.ShardedMVBPTree(cfe, "mv")
    rng = random.Random(3)
    kvs = {}
    for k in rng.sample(range(1 << 20), 600):
        kvs[k] = k * 5
        bt.insert(k, k * 5)
        mv.insert(k, k * 7)
    bt.drain()
    mv.drain()
    scans, ok = [], bt.items() == sorted(kvs.items())
    for _ in range(5):
        lo = rng.randrange(1 << 20)
        hi = lo + rng.randrange(1 << 18)
        got = (bt.range_scan(lo, hi), mv.range_scan(lo, hi))
        scans.append(got)
        ok &= got[0] == sorted((k, v) for k, v in kvs.items() if lo <= k <= hi)
        ok &= got[1] == sorted((k, 7 * k) for k in kvs if lo <= k <= hi)
    first = next(iter(kvs))
    finds = (bt.find(first), bt.find(-1), mv.find(first), mv.find(-1))
    return {"scans": scans, "items": (bt.items(), mv.items()), "finds": finds,
            "state": drv.cluster_state(cluster, [cfe]),
            "ok": ok and finds == (first * 5, None, first * 7, None)}


def _kill_mid_workload(ns):
    """A permanent failure mid-workload: the mirror is promoted with no
    committed op lost; the promoted blade fails again and recovers again."""
    cluster = drv.make_cluster(ns, n_blades=4, n_shards=16, capacity=8 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=0)
    ht = ns.cluster.ShardedHashTable(cfe, "ht")
    committed = {}
    for k in range(800):
        ht.put(k, k * 3)
        committed[k] = k * 3
    ht.drain()
    steps = [drv.cluster_state(cluster, [cfe])]
    cluster.blades[2].fail_permanently()
    for k in range(800, 1100):
        ht.put(k, k * 3)
        committed[k] = k * 3
    ht.drain()
    steps.append(drv.cluster_state(cluster, [cfe]))
    once = cluster.failovers
    cluster.blades[2].fail_permanently()
    for k in range(1100, 1200):
        ht.put(k, k * 3)
        committed[k] = k * 3
    ht.drain()
    items = sorted(ht.items())
    steps.append(drv.cluster_state(cluster, [cfe]))
    return {"steps": steps, "items": items,
            "ok": once == 1 and cluster.failovers == 2 and items == sorted(committed.items())}


def _failover_reroutes(ns):
    """A stale front end rebinds after another promoted the mirror."""
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=16, capacity=8 * MB)
    a = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=0)
    b = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=1)
    ht_a, ht_b = ns.cluster.ShardedHashTable(a, "ht"), ns.cluster.ShardedHashTable(b, "ht")
    for k in range(200):
        ht_a.put(k, k)
    ht_a.drain()
    first = ht_b.get(5)
    cluster.blades[1].fail_permanently()
    for k in range(200, 320):
        ht_a.put(k, k)
    ht_a.drain()
    stale = b.epoch < cluster.directory.epoch
    got = [ht_b.get(k) for k in range(150, 250)]
    return {"first": first, "got": got, "state": drv.cluster_state(cluster, [a, b]),
            "ok": stale and got == list(range(150, 250)) and cluster.failovers == 1
            and b.epoch == cluster.directory.epoch}


def _transient_crash(ns):
    """A crash reboots in place (no promotion) and bumps the epoch; a blade
    without a mirror that fails for good raises."""
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=16, capacity=8 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=0)
    ht = ns.cluster.ShardedHashTable(cfe, "ht")
    for k in range(150):
        ht.put(k, k)
    ht.drain()
    epoch0 = cluster.directory.epoch
    cluster.blades[0].crash()
    for k in range(150, 260):
        ht.put(k, k)
    ht.drain()
    items = sorted(ht.items())
    bare = drv.make_cluster(ns, n_blades=2, n_shards=16, num_mirrors=0)
    cfe2 = ns.cluster.ClusterFrontEnd(bare, ns.core.FEConfig.rc(), fe_id=0)
    ht2 = ns.cluster.ShardedHashTable(cfe2, "ht")
    for k in range(100):
        ht2.put(k, k)
    ht2.drain()
    bare.blades[0].fail_permanently()
    raised = None
    try:
        for k in range(300):
            ht2.put(1000 + k, k)
    except ns.core.CrashError as e:
        raised = str(e)
    return {"items": items, "raised": raised,
            "state": drv.cluster_state(cluster, [cfe]), "bare": drv.cluster_state(bare, [cfe2]),
            "ok": cluster.failovers == 0 and cluster.directory.epoch > epoch0
            and items == [(k, k) for k in range(260)] and raised is not None}


def _migrate_concurrent(ns, staged: bool):
    """migrate_shard with a second front end writing in its copy window:
    drained writes (caught up from the op log) or writes still staged in a
    group window (flushed by the quiesce barrier)."""
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, capacity=8 * MB)
    F = ns.core.FEConfig
    cfe = ns.cluster.ClusterFrontEnd(cluster, F.rc(), fe_id=0)
    cfe2 = ns.cluster.ClusterFrontEnd(
        cluster, F.rcb(oplog_group=64, batch_ops=256) if staged else F.rc(), fe_id=1)
    ht, ht2 = ns.cluster.ShardedHashTable(cfe, "ht"), ns.cluster.ShardedHashTable(cfe2, "ht")
    model = {}
    n = 300 if staged else 400
    for k in range(n):
        ht.put(k, k)
        model[k] = k
    ht.drain()
    shard = 1 if staged else 3
    dst = cluster.add_blade()
    racers = [k for k in range(n, 4000) if cluster.directory.shard_of(k) == shard]
    racers = racers[:5] if staged else racers[:20]

    def during_copy():
        for k in racers:
            v = k + 7 if staged else k + 1
            ht2.put(k, v)
            model[k] = v
        if not staged:
            ht2.drain()

    stats = ns.cluster.migrate_shard(ht, shard, dst, during_copy=during_copy)
    items = (sorted(ht.items()), sorted(ht2.items()))
    gets = [(ht.get(k), ht2.get(k)) for k in racers]
    return {"stats": stats, "items": items, "gets": gets,
            "state": drv.cluster_state(cluster, [cfe, cfe2]),
            "ok": stats["caught_up"] == len(racers) and cluster.directory.blade_of(shard) == dst
            and items[0] == sorted(model.items()) and items[1] == sorted(model.items())}


def _rebalance(ns):
    """Scale-out then rebalance evens the load; migration reclaims the
    source's blocks, and a rebooted source does not resurrect them."""
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, capacity=8 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=0)
    ht = ns.cluster.ShardedHashTable(cfe, "ht")
    model = {}
    for k in range(300):
        ht.put(k, k * 2)
        model[k] = k * 2
    ht.drain()
    cluster.add_blade()
    moves = ns.cluster.rebalance(ht)
    counts = cluster.directory.load_counts()
    items = sorted(ht.items())
    out = {"moves": moves, "counts": counts, "items": items,
           "state": drv.cluster_state(cluster, [cfe])}
    ok = bool(moves) and max(counts.values()) - min(counts.values()) <= 1
    ok &= items == sorted(model.items())
    # tests/test_vector_ops.py: test_migration_reclaims_source_blocks
    c2 = drv.make_cluster(ns, n_blades=2, n_shards=4, capacity=8 * MB)
    cfe2 = ns.cluster.ClusterFrontEnd(c2, ns.core.FEConfig.rcb(cache_bytes=1 << 16))
    kv = ns.cluster.ShardedHashTable(cfe2, "kv", n_buckets=1 << 10)
    rng = random.Random(9)
    pairs = [(rng.randrange(1 << 28), i) for i in range(400)]
    kv.put_many(pairs)
    kv.drain()
    src = c2.directory.blade_of(0)
    free_before = len(c2.blades[src]._free)
    stats = ns.cluster.migrate_shard(kv, 0, 1 - src)
    grown = len(c2.blades[src]._free) - free_before
    vals = kv.get_many([k for k, _ in pairs])
    c2.blades[src].crash()
    c2.blades[src].reboot()
    resurrected = c2.blades[src].has_name("kv.s0.seq")
    out.update(reclaim=(stats, grown, vals, resurrected), reclaim_state=drv.cluster_state(c2, [cfe2]))
    expect = dict(pairs)
    out["ok"] = ok and stats["reclaimed_blocks"] > 0 and grown >= stats["reclaimed_blocks"] \
        and all(v == expect[k] for (k, _), v in zip(pairs, vals)) and not resurrected
    return out


def _nic_dead(ns):
    """A blade whose NIC dies (alive, every completion lost) is fenced and
    its mirror promoted from the data path; a breaker opened by a burst of
    drops is probed and reset, with no promotion."""
    out, ok = {}, True
    for drops in (1 << 30, 3):
        cluster = drv.make_cluster(ns, n_blades=2, n_shards=4, capacity=4 * MB)
        cfe = ns.cluster.ClusterFrontEnd(cluster, drv.durable(ns), fe_id=0)
        t = ns.cluster.ShardedHashTable(cfe, "t", n_buckets=256)
        n0 = 60 if drops > 3 else 40
        for k in range(n0):
            t.put(k, k)
        t.drain()
        cluster.blades[1].link.inject().drop_pending = drops
        for k in range(n0, n0 + (30 if drops > 3 else 20)):
            t.put(k, k)
        keys = list(range(n0 + (30 if drops > 3 else 20)))
        got = t.get_many(keys)
        out[drops] = {"got": got, "failovers": cluster.failovers,
                      "initiated": cfe.failovers_initiated,
                      "state": drv.cluster_state(cluster, [cfe])}
        ok &= got == keys
        ok &= (cluster.failovers >= 1 and cfe.failovers_initiated >= 1) if drops > 3 else \
            (cluster.failovers == 0 and cfe.failovers_initiated == 0)
    out["ok"] = ok
    return out


def _reboot_rejoin(ns):
    """A crashed blade rejoins with an epoch bump; a cold client replays a
    committed but unapplied op-log tail on its first touch."""
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=4, capacity=4 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, drv.durable(ns), fe_id=0)
    t = ns.cluster.ShardedHashTable(cfe, "t", n_buckets=256)
    for k in range(40):
        t.put(k, k)
    t.drain()
    epoch0 = cluster.directory.epoch
    cluster.blades[1].crash()
    for k in range(40, 55):
        t.put(k, k)
    rejoined = t.get_many(list(range(55)))
    mid = drv.cluster_state(cluster, [cfe])
    for k in range(40):
        t.put(k, k + 1000)
    del t, cfe  # the writer dies before its applies drain
    for be in cluster.blades.values():
        be.crash()
        be.reboot()
    cold = ns.cluster.ClusterFrontEnd(cluster, drv.durable(ns), fe_id=5)
    t2 = ns.cluster.ShardedHashTable(cold, "t", n_buckets=256)
    got = t2.get_many(list(range(40)))
    return {"rejoined": rejoined, "mid": mid, "got": got,
            "state": drv.cluster_state(cluster, [cold]),
            "ok": rejoined == list(range(55)) and mid["epoch"] > epoch0
            and mid["failovers"] == 0 and got == [k + 1000 for k in range(40)]}


def _fencing(ns):
    """A stale writer's staged group commit is fenced at the blade after
    another writer takes the shard's write lease."""
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=4, capacity=4 * MB)
    F = ns.core.FEConfig
    a = ns.cluster.ClusterFrontEnd(cluster, F.rcb(), fe_id=0)
    b = ns.cluster.ClusterFrontEnd(cluster, F.rcb(), fe_id=1)
    ta = ns.cluster.ShardedHashTable(a, "f", n_buckets=256)
    tb = ns.cluster.ShardedHashTable(b, "f", n_buckets=256)
    for k in range(16):
        ta.put(k, k)
    ta.drain()
    ta.put(3, 111)
    b.clock.advance_to(a.clock.now + cluster.lease_ttl_ns + 1)
    tb.put(3, 222)
    tb.drain()
    fenced0 = sum(fe.stats.fenced_appends for fe in a.fes.values())
    ta.drain()
    fenced1 = sum(fe.stats.fenced_appends for fe in a.fes.values())
    got = (ta.get(3), tb.get(3), ta.get_many([k for k in range(16) if k != 3]))
    stale = ns.harness._stale_epoch_total(cluster)
    # a live steal: two writers alternate on one shard
    for i in range(12):
        (ta if i % 2 else tb).put(5, 500 + i)
    ta.drain()
    tb.drain()
    steal = (ta.get(5), tb.get(5), cluster.leases.steals, cluster.leases.write_epoch)
    return {"fenced": (fenced0, fenced1), "got": got, "stale": stale, "steal": steal,
            "state": drv.cluster_state(cluster, [a, b]),
            "ok": fenced1 > fenced0 and got[:2] == (222, 222) and stale == 0
            and steal[:2] == (511, 511) and steal[2] > 0}


def _waves(ns):
    """put_many / get_many against the serial ops, one combined write per
    blade's sub-batch, and execute_batch's combined window."""
    F = ns.core.FEConfig
    rng = random.Random(17)
    pairs = [(rng.randrange(1 << 28), i) for i in range(300)]
    keys = [k for k, _ in pairs] + [rng.randrange(1 << 28) for _ in range(30)]
    out = {}
    for batched in (False, True):
        cluster = drv.make_cluster(ns, n_blades=3, n_shards=6, capacity=4 * MB)
        cfe = ns.cluster.ClusterFrontEnd(cluster, F.rcb(cache_bytes=1 << 16))
        ht = ns.cluster.ShardedHashTable(cfe, "kv", n_buckets=1 << 10)
        if batched:
            ht.put_many(pairs)
            vals = ht.get_many(keys)
        else:
            for k, v in pairs:
                ht.put(k, v)
            vals = [ht.get(k) for k in keys]
        ht.drain()
        out[batched] = {"vals": vals, "state": drv.cluster_state(cluster, [cfe])}
    ok = out[True]["vals"] == out[False]["vals"]
    ok &= out[True]["state"]["frontends"][0]["clock"] <= out[False]["state"]["frontends"][0]["clock"]
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=4, capacity=16 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, F.rcb(cache_bytes=1 << 16))
    ht = ns.cluster.ShardedHashTable(cfe, "kv", n_buckets=1 << 8)
    rng = random.Random(23)
    sub = [(rng.randrange(1 << 26), i) for i in range(200)]
    ht.put_many(sub)
    agg = cfe.aggregate_stats()
    ok &= 0 < agg["rdma_writes"] <= len(cluster.blades) and agg["combined_flushes"] >= 2
    vals = ht.get_many([k for k, _ in sub])
    ok &= all(v == dict(sub)[k] for (k, _), v in zip(sub, vals))
    objs = {}

    def setup(fe):
        bid = fe.backend.blade_id
        objs[bid] = (ns.structures.RemoteHashTable(fe, f"h{bid}", n_buckets=64),
                     ns.structures.RemoteBST(fe, f"b{bid}"))

    for bid in cluster.blades:
        cfe.run_on(bid, setup)
    w0 = {bid: cfe.fe_for_blade(bid).stats.rdma_writes for bid in cluster.blades}

    def work(fe):
        h, bst = objs[fe.backend.blade_id]
        for k in range(25):
            h.put(k, k * 2)
            bst.insert(k, k * 3)

    cfe.execute_batch({bid: work for bid in cluster.blades})
    one = [cfe.fe_for_blade(bid).stats.rdma_writes - w0[bid] for bid in cluster.blades]
    finds = [(objs[bid][0].get(7), objs[bid][1].find(7)) for bid in sorted(objs)]
    out.update(sub=(agg, vals), one=one, finds=finds, state=drv.cluster_state(cluster, [cfe]))
    out["ok"] = ok and one == [1, 1] and finds == [(14, 21), (14, 21)]
    return out


def _telemetry(ns):
    """Stats and telemetry of a ClusterFrontEnd, across a rebalance's rebinds."""
    cluster = drv.make_cluster(ns, n_blades=2, n_shards=8, capacity=4 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rcb(cache_bytes=4096), fe_id=0)
    t = ns.cluster.ShardedHashTable(cfe, "t", n_buckets=256)
    pairs = [(i, i * 3) for i in range(120)]
    t.put_many(pairs)
    got = t.get_many([k for k, _ in pairs])
    before = cfe.telemetry()
    cluster.add_blade()
    ns.cluster.rebalance(t)
    t.get_many(list(range(120)))
    tel = cfe.telemetry()
    hists = {op: h.snapshot() for op, h in sorted(cfe.merged_op_hists().items())}
    return {"got": got, "before": before, "after": tel, "hists": hists,
            "health": ns.failover.blade_health(cluster),
            "state": drv.cluster_state(cluster, [cfe]),
            "ok": got == [v for _, v in pairs]
            and tel["op_latency"]["put_many"]["count"] == 120
            and before["cluster_op_latency"]["get_many"]["count"] == 120}


def _bootstrap_from_bytes(ns):
    """A cold front end recovers the directory from the blades' bytes alone."""
    cluster = drv.make_cluster(ns, n_blades=3, n_shards=16, capacity=4 * MB)
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=0)
    ht = ns.cluster.ShardedHashTable(cfe, "ht")
    for k in range(300):
        ht.put(k, k * 9)
    ht.drain()
    d = cluster.bootstrap_directory()
    cfe2 = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=5)
    items = sorted(ns.cluster.ShardedHashTable(cfe2, "ht").items())
    return {"boot": d.encode(), "items": items, "state": drv.cluster_state(cluster, [cfe, cfe2]),
            "ok": items == [(k, k * 9) for k in range(300)]}


def _scaling(ns):
    """tests/test_cluster.py's scaling check: 8 front ends, 1, 2 and 4 blades."""
    runs = [drv.run_scaling(ns, nb, 8, 80, 150, capacity=16 * MB // nb) for nb in (1, 2, 4)]
    aggs = [r["aggregate_kops"] for r in runs]
    return {"aggs": aggs, "states": [r["state"] for r in runs],
            "ok": aggs[0] < aggs[1] <= aggs[2] * 1.0001}


SCENARIOS = {
    "quickstart": _quickstart, "directory_and_leases": _directory_and_leases,
    "routing": _routing, "range_scans": _scans, "kill_mid_workload": _kill_mid_workload,
    "failover_reroutes": _failover_reroutes, "transient_crash": _transient_crash,
    "migrate_drained_writes": lambda ns: _migrate_concurrent(ns, staged=False),
    "migrate_staged_writes": lambda ns: _migrate_concurrent(ns, staged=True),
    "rebalance": _rebalance, "nic_dead_and_breaker": _nic_dead,
    "reboot_rejoin": _reboot_rejoin, "write_lease_fencing": _fencing,
    "waves": _waves, "telemetry": _telemetry, "bootstrap_from_bytes": _bootstrap_from_bytes,
    "scaling": _scaling,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cluster_scenario_matches_reference(name):
    runs = drv.both(SCENARIOS[name])
    assert runs["repro"]["ok"], "the reference's own checks"
    drv.assert_same(runs)
    assert runs["repro_torch"]["ok"]


# --------------------------------------------------- images across packages
def _ref_workload(ns, cluster):
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=0)
    ht = ns.cluster.ShardedHashTable(cfe, "img", n_buckets=512)
    bt = ns.cluster.ShardedBPTree(cfe, "tree")
    for k in range(300):
        ht.put(k, k * 11)
        bt.insert(k * 3, k)
    ht.drain()
    bt.drain()
    cluster.blades[1].fail_permanently()
    ht.put(1000, 1)
    ht.drain()
    cluster.add_blade()  # joins empty: no shard of either structure moves
    return cfe


def _read_back(ns, cluster):
    cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rc(), fe_id=9)
    ht = ns.cluster.ShardedHashTable(cfe, "img", n_buckets=512)
    bt = ns.cluster.ShardedBPTree(cfe, "tree")
    return sorted(ht.items()), bt.items(), [ht.get(k) for k in (0, 7, 299, 1000, 5000)]


WANT = ([(k, k * 11) for k in range(300)] + [(1000, 1)], [(k * 3, k) for k in range(300)],
        [0, 77, 299 * 11, 1, None])


def test_reference_cluster_restores_in_the_port():
    ref = drv.pkg("repro")
    cluster = drv.make_cluster(ref, n_blades=3, n_shards=8)
    _ref_workload(ref, cluster)
    images = {bid: (be.arena, [m.arena for m in be.mirrors]) for bid, be in cluster.blades.items()}
    port = convert.load_cluster(images, device="cpu")
    assert port.directory.encode() == ref.cluster.ShardDirectory.bootstrap(cluster.blades).encode()
    assert port.directory.epoch == cluster.directory.epoch > 0
    assert port.leases.write_epoch == cluster.leases.write_epoch
    items, tree, gets = _read_back(drv.pkg("repro_torch"), port)
    assert (sorted(items), tree, gets) == (sorted(WANT[0]), WANT[1], WANT[2])


def test_port_cluster_restores_in_the_reference():
    ns = drv.pkg("repro_torch")
    cluster = drv.make_cluster(ns, n_blades=3, n_shards=8)
    _ref_workload(ns, cluster)
    images = convert.cluster_image(cluster)
    ref = drv.pkg("repro")
    # the reference has no loader: its own cold start, blade by blade
    back = ref.cluster.NVMCluster(n_blades=len(images), n_shards=8, capacity_per_blade=1 << 22)
    for bid, (arena, mirrors) in images.items():
        be = ref.core.NVMBackend(len(arena), back.block_size, back.cost,
                                 num_mirrors=len(mirrors), blade_id=bid,
                                 name_slots=back.name_slots)
        be.arena[:] = arena
        for m, image in zip(be.mirrors, mirrors):
            m.arena[:] = image
        back.blades[bid] = be.reboot()
    back.bootstrap_directory()
    assert back.directory.encode() == cluster.directory.encode()
    assert back.leases.write_epoch == cluster.leases.write_epoch
    items, tree, gets = _read_back(ref, back)
    assert (sorted(items), tree, gets) == (sorted(WANT[0]), WANT[1], WANT[2])
    # the port's own cold start from the same bytes reads the same
    again = convert.load_cluster(images, device="cpu")
    assert _read_back(ns, again) == (items, tree, gets)


# ------------------------------------------------------------ no silent CPU
def test_cluster_without_a_device_needs_a_card(monkeypatch):
    from repro_torch.cluster import NVMCluster
    from repro_torch.faults import run_chaos_schedule, run_steal_schedule

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NVMCluster()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_chaos_schedule(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_steal_schedule(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.load_cluster({0: (bytes(1 << 20), [])})
    assert NVMCluster(n_blades=1, capacity_per_blade=1 << 20, device="cpu").device.type == "cpu"
