"""The open-loop engine and its figures: the port against the reference, bit
for bit, on the CPU.

- Fig 10 v2 (``benchmarks/fig10_multi_frontend.py``): 1 and 2 writers on one
  sharded table of 2 blades of 16 MB, pool 400, 150 ops a writer, under
  ``low`` and ``high`` contention, Poisson arrivals at 0.9 x the probed
  capacity; no committed stale epoch, no read-back mismatch.
- The open-loop sweep (``benchmarks/fig_open_loop.py``): 2 stations, pool
  256, 96 ops a station, loads 0.5, 1, 2, 3 x the probed capacity, the
  result cache off and on (64 entries); no staleness violation; then the
  same under an obs session, whose export folds the dead engines.
- The engine itself on seeded inputs: arrivals, merged streams, summaries,
  FIFO and causal dispatch, backlog, and its refusals.
- One crossing (``repro_torch.core.convert``): Fig 9's multi-version BST
  built on a reference blade, carried into the port, and run there and in
  the reference with its writer and 6 readers.
"""

import numpy as np
import pytest

import _sim_driver as drv
from repro_torch.core import convert

PRELOAD, OPS = drv.SMOKE


def test_fig10_multi_writer_matches_reference():
    port = drv.assert_same(drv.both(drv.fig10, **drv.FIG10))
    summary, cells = port["rows"][0], port["rows"][1:]
    assert summary["committed_stale_epochs"] == 0
    assert summary["read_back_mismatches"] == 0
    assert [(c["mode"], c["writers"]) for c in cells] == [
        ("low", 1), ("low", 2), ("high", 1), ("high", 2)]
    high2 = cells[-1]  # contended writers took each other's leases
    assert high2["write_lease_steals"] > 0


def test_open_loop_sweep_matches_reference():
    port = drv.assert_same(drv.both(drv.open_loop, **drv.OPEN_LOOP))
    summary, points = port["rows"][0], port["rows"][1:]
    assert summary["staleness_violations"] == 0
    assert len(points) == 2 * len(drv.LOADS)
    on = [p for p in points if p["cache"] == "on"]
    assert all(p["result_cache_hit_rate"] > 0 for p in on)
    # latency grows with the offered load, past saturation by a lot
    off = [p["latency_p99_us"] for p in points if p["cache"] == "off"]
    assert off[-1] > off[0]


def test_open_loop_obs_export_folds_dead_engines_as_reference():
    runs = drv.both(drv.observed, drv.open_loop, **drv.OPEN_LOOP)
    port = drv.assert_same(runs)
    doc = dict(port["steps"])["obs export"]
    served = sum(s["summary"]["served"] for name, s in port["steps"] if name.startswith("cache="))
    assert doc["counters"]["open_loop_ops_served"][0]["value"] == served
    assert {h["labels"]["op"] for h in doc["histograms"]["arrival_latency_ns"]} == {"get", "put"}


# ------------------------------------------------------------- the engine
def _arrivals(ns):
    sim = ns.sim
    merged = sim.merge_streams({3: sim.poisson_arrivals(5e5, 40, seed=9),
                                1: sim.poisson_arrivals(2e5, 25, seed=4, start_ns=100.0),
                                2: [50.0, 50.0, 400.0]})
    trace = sim.trace_arrivals([30.0, 10.0, 20.0, 20.0, 0.0])
    return {"poisson": sim.poisson_arrivals(1e6, 64, seed=7).tolist(),
            "empty": sim.poisson_arrivals(1e6, 0).tolist(),
            "merged": (merged[0].tolist(), merged[1].tolist()),
            "trace": trace.tolist(), "trace_dtype": str(trace.dtype)}


def test_arrivals_and_merge_match_reference():
    runs = drv.both(_arrivals)
    assert runs["repro_torch"] == runs["repro"]
    ts, tenants = runs["repro_torch"]["merged"]
    assert ts == sorted(ts) and len(ts) == 68
    assert [d for d, t in zip(tenants, ts) if t == 50.0] == [2, 2]
    assert runs["repro_torch"]["trace"] == [0.0, 10.0, 20.0, 20.0, 30.0]


def _refusals(ns):
    sim, out = ns.sim, []
    for call in (lambda: sim.poisson_arrivals(0.0, 4),
                 lambda: sim.trace_arrivals([[1.0, 2.0]]),
                 lambda: sim.trace_arrivals([-1.0, 2.0]),
                 lambda: sim.OpenLoopStation(sim.Clock(), lambda b: None, max_batch=0),
                 lambda: sim.OpenLoopStation(sim.Clock(), lambda b: None).offer(
                     [sim.OpenLoopOp(2.0, "get"), sim.OpenLoopOp(1.0, "get")])):
        with pytest.raises(ValueError) as err:
            call()
        out.append(str(err.value))
    return out


def test_engine_refusals_match_reference():
    runs = drv.both(_refusals)
    assert runs["repro_torch"] == runs["repro"]


def _engine(ns, max_batch: int, cost_ns: float):
    """Three stations of seeded arrivals (one a merged two-tenant stream, one
    a replayed trace) whose executors advance their clocks by a cost an op
    and log each dispatch."""
    sim = ns.sim
    ts, tid = sim.merge_streams({0: sim.poisson_arrivals(4e6, 60, seed=1),
                                 1: sim.poisson_arrivals(2e6, 30, seed=2)})
    streams = [[sim.OpenLoopOp(float(t), "get" if i % 3 else "put", key=i, tenant=int(d))
                for i, (t, d) in enumerate(zip(ts, tid))],
               [sim.OpenLoopOp(float(t), "put", key=i)
                for i, t in enumerate(sim.poisson_arrivals(1e6, 50, seed=3))],
               [sim.OpenLoopOp(float(t), "get", key=i)
                for i, t in enumerate(sim.trace_arrivals([0.0, 0.0, 5.0, 7e3, 2e4, 2e4]))]]
    stations, logs = [], []
    for i, ops in enumerate(streams):
        clock, log = sim.Clock(), []

        def execute(batch, clock=clock, log=log):
            log.append((clock.now, [(op.ts, op.key, op.kind) for op in batch]))
            clock.advance(cost_ns * len(batch) + 100.0)
        st = sim.OpenLoopStation(clock, execute, station_id=i, max_batch=max_batch)
        st.offer(ops)
        stations.append(st)
        logs.append(log)
    backlog_before = [st.backlog(1e4) for st in stations]
    eng = sim.OpenLoopEngine(stations)
    summary = eng.run()
    return {"summary": summary, "logs": logs, "backlog_before": backlog_before,
            "backlog_after": [st.backlog(st.clock.now) for st in stations],
            "served": [st.served for st in stations], "pending": [st.pending for st in stations],
            "offered": [[(op.ts, op.key, op.kind) for op in ops] for ops in streams],
            "hists": {k: h.to_dict() for k, h in eng.arrival_hist.items()}}


@pytest.mark.parametrize("max_batch,cost_ns", [(1, 300.0), (8, 900.0), (64, 50.0)])
def test_engine_summary_fifo_and_causal_match_reference(max_batch, cost_ns):
    runs = drv.both(_engine, max_batch, cost_ns)
    assert runs["repro_torch"] == runs["repro"]
    run = runs["repro_torch"]
    for log, offered in zip(run["logs"], run["offered"]):
        assert [op for _, batch in log for op in batch] == offered  # FIFO, each op once
        for start, batch in log:
            assert 0 < len(batch) <= max_batch
            assert all(ts <= start for ts, _, _ in batch)  # causal
    assert run["summary"]["served"] == sum(map(len, run["offered"]))
    assert run["pending"] == [0, 0, 0] and run["backlog_after"] == [0, 0, 0]
    assert run["summary"]["queue_depth_max"] > 0  # station 0's arrivals outrun its service


def _frontend_station(ns):
    """A raw FrontEnd as a station's executor: a hash table under rcb, put
    and get batches at Poisson arrivals."""
    core, sim = ns.core, ns.sim
    be = core.NVMBackend(capacity=1 << 24, **ns.kw)
    fe = core.FrontEnd(be, core.FEConfig.rcb(cache_bytes=1 << 16, batch_ops=64))
    ht = ns.structures.RemoteHashTable(fe, "ol", n_buckets=256)
    reads = []

    def execute(batch):
        puts = [(op.key, op.key * 3) for op in batch if op.kind == "put"]
        if puts:
            ht.put_many(puts)
        gets = [op.key for op in batch if op.kind == "get"]
        if gets:
            reads.append(ht.get_many(gets))
    mask = drv.op_mix(200, 0.5, seed=5)
    keys = drv.uniform_keys(200, 64, seed=6)
    ops = [sim.OpenLoopOp(float(t), "get" if r else "put", key=int(k))
           for t, r, k in zip(sim.poisson_arrivals(2e5, 200, seed=8), mask, keys)]
    st = sim.OpenLoopStation(fe.clock, execute, max_batch=16)
    st.offer(ops)
    summary = sim.OpenLoopEngine([st]).run()
    fe.drain(ht.h)
    return {"summary": summary, "reads": reads, "blade": drv.blade_state(ns, be),
            "fe": drv.fe_state(fe)}


def test_engine_over_a_frontend_matches_reference():
    runs = drv.both(_frontend_station)
    assert runs["repro_torch"] == runs["repro"]
    assert runs["repro_torch"]["summary"]["served"] == 200


# ------------------------------------------------------------ the crossing
def test_fig9_mv_bst_crosses_from_a_reference_blade():
    """Fig 9's multi-version BST built and preloaded on a reference blade,
    its image carried into the port (``convert.load_blade``) and into a
    fresh reference blade, both rebooted; then the writer recovers the tree
    and runs with 6 MV readers on each side."""
    ref_ns = drv.pkg("repro")
    be, wfe, tree, keys = drv.fig9_blade(ref_ns, "mv", PRELOAD)
    image = bytes(be.arena)
    mirrors = [bytes(m.arena) for m in be.mirrors]
    del be, wfe, tree
    port_blade = convert.load_blade(image, mirrors, device="cpu")
    ref_blade = ref_ns.core.NVMBackend(capacity=len(image), num_mirrors=len(mirrors))
    ref_blade.arena = bytearray(image)
    for m, a in zip(ref_blade.mirrors, mirrors):
        m.arena = bytearray(a)
    ref_blade.reboot()
    assert drv.blade_state(ref_ns, ref_blade) == drv.blade_state(drv.pkg("repro_torch"),
                                                                 port_blade)
    runs = {"repro": drv.fig9_mv_after_crossing(ref_ns, ref_blade, keys, 6, OPS, OPS),
            "repro_torch": drv.fig9_mv_after_crossing(drv.pkg("repro_torch"), port_blade,
                                                      keys, 6, OPS, OPS)}
    port = drv.assert_same(runs)
    state = port["steps"][0][1]
    assert all(v is not None for r in state["reader_results"] for v in r)
    assert np.isfinite(port["rows"]["reader_kops_avg"])
