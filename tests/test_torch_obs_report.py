"""``obs.report`` over a traced cluster run with faults: the port against
the reference, on the CPU.

One failure story runs in both packages under an ``obs`` session with a
tracer (every blade on the CPU): a shard migration with writes in its copy
window, a power loss inside a replay and the reboot the data path makes
(with the front ends' checksum memo cleared, so the blade verifies the
committed bodies), a permanent failure and the promotion, a NIC that dies under a scheduled ``FaultInjector``
(fenced and promoted from the data path, with dropped completions, a
lease expiry and a lag spike around it), then a cold bootstrap of the
directory from the blades' bytes.  Each function of the port's
``obs.report`` on the port's trace must give what ``repro.obs.report``
gives on the reference's trace of the same run, and both reports on one
saved document must agree (the module is pure Python over the tracer's
JSON).
"""

import gc
import json

import pytest

import _cluster_driver as drv

FUNCTIONS = ("spans", "thread_names", "validate", "span_names", "fault_summary",
             "blade_tracks", "top_self_time", "wave_widths", "link_utilization", "summarize")


def failure_story(ns):
    """The traced run: (trace document, injector counts, session counters,
    cluster state, keys read back right)."""
    obs = ns.obs
    F = ns.faults
    try:
        with obs.observe(trace=True, metrics=True) as sess:
            cluster = drv.make_cluster(ns, n_blades=3, n_shards=8, capacity=8 << 20)
            cfe = ns.cluster.ClusterFrontEnd(cluster, drv.durable(ns), fe_id=0)
            cfe2 = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rcb(cache_bytes=4096),
                                              fe_id=1)
            t = ns.cluster.ShardedHashTable(cfe, "t", n_buckets=256)
            t2 = ns.cluster.ShardedHashTable(cfe2, "t", n_buckets=256)
            model = {}
            for k in range(120):
                t.put(k, k)
                model[k] = k
            t.drain()

            def during_copy():
                for k in range(1000, 1040):
                    t2.put(k, k + 1)
                    model[k] = k + 1
                t2.drain()
            ns.cluster.migrate_shard(t, 3, cluster.add_blade(), during_copy=during_copy)
            # a power loss inside the apply of a committed flush, then front
            # ends without their checksum memo: the reboot verifies bodies
            for k in range(20000, 20060):
                t2.put(k, k)
            cluster.blades[0].schedule_torn_write(0, after_writes=4)
            try:
                cfe2.drain_all()
            except ns.core.CrashError:
                pass
            ns.core.oplog._CSUM_CACHE.clear()
            for k in range(400, 480):
                t.put(k, k)
                model[k] = k
            cluster.blades[1].fail_permanently()
            plan = F.FaultPlan(seed=0, specs=[
                F.FaultSpec("wqe_drop", 2, 0, a=2), F.FaultSpec("lease_expiry", 5, 0),
                F.FaultSpec("lag_spike", 8, 3, a=16, b=0), F.FaultSpec("nic_dead", 12, 2)])
            inj = F.FaultInjector(plan, cluster, cfe.clock, table="t", n_shards=8)
            for i in range(60):
                inj.step(i)
                t.put(2000 + i, i)
                model[2000 + i] = i
            inj.finish()
            t.drain()
            cluster.bootstrap_directory()
            cold = ns.cluster.ClusterFrontEnd(cluster, drv.durable(ns), fe_id=5)
            keys = sorted(model)
            got = ns.cluster.ShardedHashTable(cold, "t", n_buckets=256).get_many(keys)
            doc = sess.tracer.to_chrome()
            counters = dict(sess.counters)
            gc.collect()  # retired front ends in reference cycles fold now, in both
            prom = [ln for ln in sess.build_registry().to_prometheus().splitlines()
                    if not ln.startswith("rnvm_profile_seconds")]  # wall clock
            state = drv.cluster_state(cluster, [cfe, cfe2, cold])
    finally:
        obs.stop()
    return {"doc": json.loads(json.dumps(doc)), "injected": dict(inj.injected),
            "counters": counters, "prometheus": prom, "state": state,
            "ok": got == [model[k] for k in keys], "failovers": cluster.failovers}


@pytest.fixture(scope="module")
def runs():
    return drv.both(failure_story)


def test_traced_failure_story_matches_reference(runs):
    drv.assert_same(runs)
    port = runs["repro_torch"]
    assert port["ok"] and port["failovers"] >= 2
    assert port["injected"] == {"wqe_drop": 1, "lease_expiry": 1, "lag_spike": 1, "nic_dead": 1}


@pytest.mark.parametrize("fn", FUNCTIONS)
def test_report_of_the_port_trace_is_the_reference_report(runs, fn):
    ref = drv.pkg("repro").report
    port = drv.pkg("repro_torch").report
    want = getattr(ref, fn)(runs["repro"]["doc"])
    got = getattr(port, fn)(runs["repro_torch"]["doc"])
    assert got == want
    # the pure function on one document: both modules agree
    assert getattr(port, fn)(runs["repro"]["doc"]) == want


def test_report_checks_the_trace(runs, tmp_path):
    port_report = drv.pkg("repro_torch").report
    doc = runs["repro_torch"]["doc"]
    assert port_report.validate(doc) == []
    faults = port_report.fault_summary(doc)
    assert {k[len("fault:"):]: n for k, n in faults.items() if k.startswith("fault:")} == \
        runs["repro_torch"]["injected"]
    assert faults["promotion"] >= 2 and faults["fenced"] >= 1  # the reactions
    names = port_report.span_names(doc)
    for required in ("migration", "flush", "wave_fence", "lease_refresh", "op:put", "reboot",
                     "op:get_many"):
        assert names[required] > 0, required
    assert len(port_report.blade_tracks(doc)) >= 3
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    assert port_report.load_trace(str(path)) == doc
    path.write_text("[]")
    with pytest.raises(ValueError):
        port_report.load_trace(str(path))
    # a span that overlaps its neighbour on one track is reported
    bad = json.loads(json.dumps(doc))
    spans = [e for e in bad["traceEvents"] if e.get("ph") == "X"]
    spans[1].update(pid=spans[0]["pid"], tid=spans[0]["tid"], ts=spans[0]["ts"] + 1e-3,
                    dur=spans[0]["dur"] + 10.0)
    assert port_report.validate(bad) == drv.pkg("repro").report.validate(bad) != []
