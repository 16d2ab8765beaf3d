"""The chaos harness: the port against the reference, on the CPU.

``FaultPlan.random`` must draw the same specs in both packages, a
``FaultInjector`` must arm each fault kind the same way, and
``run_chaos_schedule`` / ``run_steal_schedule`` must return the same
``ChaosResult``, field for field, and leave the same bytes on every blade
of both clusters they build (the faulty one and the oracle's clean one).
The chaos sweep runs ``benchmarks/fig_availability.py``'s round-robin:
schedule ``s`` ensures ``ALL_FAULT_KINDS[s % 11]``, so every kind fires;
the op count is ``BENCH_availability.json``'s 80.  The fence's oracle,
``_stale_epoch_total``, must agree and be 0.
"""

import dataclasses

import pytest

import _cluster_driver as drv
from repro.faults import ALL_FAULT_KINDS


def _captured(ns, monkeypatch):
    """Every NVMCluster the harness builds, in order."""
    built = []
    base = ns.cluster.NVMCluster

    class Captured(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(ns.harness, "NVMCluster", Captured)
    return built


def _run(monkeypatch, fn):
    """{package: (ChaosResult as a dict, [cluster states], [stale totals])}."""
    out = {}
    for p in drv.PACKAGES:
        ns = drv.pkg(p)
        with monkeypatch.context() as m:
            built = _captured(ns, m)
            res = fn(ns)
        out[p] = (dataclasses.asdict(res), [drv.cluster_state(c) for c in built],
                  [ns.harness._stale_epoch_total(c) for c in built])
    return out


@pytest.mark.parametrize("n_blades", [2, 3])
def test_fault_plans_are_the_reference_plans(n_blades):
    ref, port = drv.pkg("repro").faults, drv.pkg("repro_torch").faults
    assert port.ALL_FAULT_KINDS == ref.ALL_FAULT_KINDS
    for seed in range(64):
        for kw in ({}, {"n_faults": 9}, {"kinds": ("crash", "lease_expiry")},
                   {"ensure": (ALL_FAULT_KINDS[seed % 11],)}):
            a = ref.FaultPlan.random(seed ^ 0x5EED, 120, n_blades, **kw)
            b = port.FaultPlan.random(seed ^ 0x5EED, 120, n_blades, **kw)
            assert [dataclasses.astuple(s) for s in b.specs] == \
                [dataclasses.astuple(s) for s in a.specs]
            assert (b.seed, len(b), b.kinds()) == (a.seed, len(a), a.kinds())


@pytest.mark.parametrize("kind", ALL_FAULT_KINDS)
def test_injector_arms_each_kind_as_the_reference(kind):
    def scenario(ns):
        cluster = drv.make_cluster(ns, n_blades=2, n_shards=4)
        cfe = ns.cluster.ClusterFrontEnd(cluster, drv.durable(ns), fe_id=0)
        t = ns.cluster.ShardedHashTable(cfe, "t", n_buckets=256)
        for k in range(20):
            t.put(k, k)
        t.drain()
        plan = ns.faults.FaultPlan.random(5, 50, 2, n_faults=4, kinds=[kind])
        inj = ns.faults.FaultInjector(plan, cluster, cfe.clock, table="t", n_shards=4)
        armed = []
        for i in range(50):
            inj.step(i)
            armed.append([(be.alive, be.permanent_failure, be._torn_write_at,
                           None if be.link.fault is None else
                           (be.link.fault.drop_pending, be.link.fault.dup_pending,
                            be.link.fault.stall_until),
                           [m.lag_writes for m in be.mirrors])
                          for _, be in sorted(cluster.blades.items())])
        inj.finish()
        after = [(be._torn_write_at, None if be.link.fault is None else
                  (be.link.fault.drop_pending, be.link.fault.stall_until))
                 for _, be in sorted(cluster.blades.items())]
        return {"armed": armed, "after": after, "injected": inj.injected,
                "stalled": inj._stalled, "state": drv.cluster_state(cluster, [cfe]),
                "ok": sum(inj.injected.values()) >= 1}
    runs = drv.both(scenario)
    drv.assert_same(runs)
    assert runs["repro_torch"]["ok"], f"{kind} never fired"


SWEEP = 22  # two schedules a kind, each ensuring its kind


@pytest.mark.parametrize("seed", range(SWEEP))
def test_chaos_schedule_matches_reference(seed, monkeypatch):
    kind = ALL_FAULT_KINDS[seed % len(ALL_FAULT_KINDS)]
    runs = _run(monkeypatch, lambda ns: ns.faults.run_chaos_schedule(
        seed, n_ops=80, n_blades=3, n_faults=6, ensure=(kind,), **ns.kw))
    assert runs["repro_torch"] == runs["repro"]
    res, states, stale = runs["repro_torch"]
    assert res["violations"] == [], res["violations"][:3]
    assert res["injected"].get(kind, 0) >= 1
    assert len(states) == 2  # the faulty cluster and the oracle's clean one
    assert stale == [0, 0]


@pytest.mark.parametrize("kind", ALL_FAULT_KINDS)
def test_single_fault_kind_matches_reference(kind, monkeypatch):
    runs = _run(monkeypatch, lambda ns: ns.faults.run_chaos_schedule(
        7, kinds=[kind], n_faults=4, n_ops=60, **ns.kw))
    assert runs["repro_torch"] == runs["repro"]
    assert runs["repro_torch"][0]["violations"] == []


@pytest.mark.parametrize("seed", range(4))
def test_steal_schedule_matches_reference(seed, monkeypatch):
    runs = _run(monkeypatch, lambda ns: ns.faults.run_steal_schedule(seed, **ns.kw))
    assert runs["repro_torch"] == runs["repro"]
    res, _, stale = runs["repro_torch"]
    assert res["violations"] == [], res["violations"][:3]
    assert res["stats"]["write_lease_steals"] > 0
    assert res["stats"]["stale_epoch_entries"] == 0 and stale == [0, 0]
