"""Crash, recovery, mirrors, blade images and tracing: the port's simulator
against the reference, on the CPU.

Every scenario runs through ``repro.core`` and ``repro_torch.core`` (blades
on the CPU) and must leave the same arena bytes, mirror bytes, clocks and
Stats: the quickstart's crash and recovery (``examples/quickstart.py``
part 1), tears aimed at a watermark slot (keep 0 and 8) and a tear in the
middle of a flush, the replay of a log of more than 256 transactions with
the checksum memo cleared (every body verified by the blade), mirror
promotion after a permanent failure, and a lagging mirror (the serial
apply path).  A blade image written by either package recovers in the
other (``repro_torch.core.convert``), and a traced run exports the same
Chrome trace and histograms.
"""

import dataclasses
import json
import random

import pytest

import _nvm_driver as drv
from repro.core import oplog as ref_oplog
from repro_torch.core import convert
from repro_torch.core import oplog as port_oplog
from repro_torch.kernels import nvm_log

KW = drv.blade_kwargs


def _both(scenario):
    """{package: what `scenario(pkg)` returns}."""
    return {pkg: scenario(pkg) for pkg in drv.PACKAGES}


def _assert_same(runs):
    ref, port = runs["repro"], runs["repro_torch"]
    assert ref.keys() == port.keys()
    for key in ref:
        assert port[key] == ref[key], key


def _quickstart(pkg):
    core, st = drv.core_of(pkg), drv.structures_of(pkg)
    blade = core.NVMBackend(capacity=1 << 24, num_mirrors=1, **KW(pkg))
    fe = core.FrontEnd(blade, core.FEConfig.rcb(batch_ops=256))
    tree = st.RemoteBPTree(fe, "accounts")
    for k in range(1000):
        tree.insert(k, k * k)
    fe.drain(tree.h)
    out = {"before": drv.state(blade, fe), "find": tree.find(77)}
    blade.crash()
    blade.reboot()
    fe2 = core.FrontEnd(blade, core.FEConfig.rcb(), fe_id=1)
    tree2 = st.RemoteBPTree.recover(fe2, "accounts")
    out.update(after=drv.state(blade, fe2), find2=tree2.find(77), items=tree2.items())
    return out


def test_quickstart_crash_and_recovery_matches_reference():
    runs = _both(_quickstart)
    _assert_same(runs)
    assert runs["repro_torch"]["find2"] == 77 * 77


DURABLE = dict(cache_bytes=4096, oplog_pipeline=1)  # tests/test_chaos.py


def _watermark_tear(keep):
    def scenario(pkg):
        core, st = drv.core_of(pkg), drv.structures_of(pkg)
        be = core.NVMBackend(capacity=1 << 22, **KW(pkg))
        fe = core.FrontEnd(be, core.FEConfig.rc(**DURABLE))
        ht = st.RemoteHashTable(fe, "h", n_buckets=64)
        for k in range(10):
            ht.put(k, k)
        fe.drain(ht.h)
        be.schedule_torn_write(keep, at_name="h.seq")
        try:
            ht.put(99, 99)
        except core.CrashError:
            pass
        out = {"torn": drv.state(be, fe)}
        be.reboot()
        fe2 = core.FrontEnd(be, core.FEConfig.rc(**DURABLE))
        ht2 = st.RemoteHashTable.recover(fe2, "h")
        out.update(got=[ht2.get(k) for k in (*range(10), 99)], after=drv.state(be, fe2))
        return out
    return scenario


@pytest.mark.parametrize("keep", [0, 8])
def test_watermark_tear_matches_reference(keep):
    runs = _both(_watermark_tear(keep))
    _assert_same(runs)
    assert not runs["repro_torch"]["torn"]["alive"]
    assert runs["repro_torch"]["got"][-1] == (99 if keep >= 8 else None)


def _flush_tear(pkg):
    """tests/test_core_recovery.py: an untargeted tear in a flush's payload."""
    core, st = drv.core_of(pkg), drv.structures_of(pkg)
    be = core.NVMBackend(capacity=1 << 23, **KW(pkg))
    fe = core.FrontEnd(be, core.FEConfig.rcb(batch_ops=64, oplog_group=16))
    s = st.RemoteStack(fe, "s")
    for i in range(200):
        s.push(i)
    fe.drain(s.h)
    for i in range(200, 230):
        s.push(i)
    be.schedule_torn_write(20)
    crashed = False
    try:
        fe.drain(s.h)
        fe.drain(s.h)
    except core.CrashError:
        crashed = True
    out = {"torn": drv.state(be, fe), "crashed": crashed}
    be.reboot()
    fe3 = core.FrontEnd(be, core.FEConfig.rcb(batch_ops=64, oplog_group=16), fe_id=2)
    s3 = st.RemoteStack.recover(fe3, "s")
    out.update(after=drv.state(be, fe3), vals=drv.contents(s3, "stack", []))
    return out


def test_untargeted_tear_mid_flush_matches_reference():
    runs = _both(_flush_tear)
    _assert_same(runs)
    port = runs["repro_torch"]
    assert port["crashed"] and not port["torn"]["alive"]  # the tear fired in the drains
    vals = port["vals"]
    assert len(vals) >= 200 and vals == sorted(vals, reverse=True)


def _long_log(tear):
    """More than 256 transactions appended to a log area and left unapplied,
    the checksum memo cleared before the reboot: recovery verifies every
    body (on a card, K1) and replays them all (K2), overlapping writes
    included.  With `tear`, the last append is torn mid-body."""
    def scenario(pkg):
        core = drv.core_of(pkg)
        oplog = ref_oplog if pkg == "repro" else port_oplog
        be = core.NVMBackend(capacity=1 << 23, num_mirrors=1, **KW(pkg))
        area = be.create_log_area("x.txlog", 512)
        data = be.alloc_blocks(64)
        rng = random.Random(7)
        for i in range(300):
            entries = [oplog.MemLog(data + 8 * rng.randrange(2000), rng.randbytes(rng.choice(
                [8, 24, 64]))) for _ in range(rng.randrange(1, 6))]
            if tear and i == 299:
                be.schedule_torn_write(40)
            be.tx_append(area, oplog.encode_tx(entries))
        oplog._CSUM_CACHE.clear()
        be.crash()
        out = {"crashed": drv.state(be)}
        be.reboot()
        area2 = be.get_log_area("x.txlog")
        out.update(after=drv.state(be), head=area2.head, applied=area2.applied)
        return out
    return scenario


@pytest.mark.parametrize("tear", [False, True])
def test_long_log_recovery_without_the_memo_matches_reference(tear):
    runs = _both(_long_log(tear))
    _assert_same(runs)
    st = runs["repro_torch"]["after"]
    assert st["blade_stats"]["tx_commits"] == (299 if tear else 300)


def _promotion(pkg):
    core, st = drv.core_of(pkg), drv.structures_of(pkg)
    be = core.NVMBackend(capacity=1 << 23, num_mirrors=2, **KW(pkg))
    fe = core.FrontEnd(be, core.FEConfig.rcb(batch_ops=32, oplog_group=8))
    q = st.RemoteQueue(fe, "q")
    for i in range(150):
        q.enqueue(i)
    fe.drain(q.h)
    be.fail_permanently()
    promoted = be.promote_mirror(1)
    fe2 = core.FrontEnd(promoted, core.FEConfig.rcb(), fe_id=3)
    q2 = st.RemoteQueue.recover(fe2, "q")
    return {"promoted": drv.state(promoted, fe2), "vals": [q2.dequeue() for _ in range(150)],
            "after": drv.state(promoted, fe2)}


def test_mirror_promotion_matches_reference():
    runs = _both(_promotion)
    _assert_same(runs)
    assert runs["repro_torch"]["vals"] == list(range(150))


def _lagging(pkg):
    """A mirror four writes behind: every apply takes the serial path, the
    mirror holds a prefix of the primary's writes until it is synced."""
    core, st = drv.core_of(pkg), drv.structures_of(pkg)
    be = core.NVMBackend(capacity=1 << 23, num_mirrors=1, **KW(pkg))
    be.mirrors[0].set_lag(4)
    fe = core.FrontEnd(be, core.FEConfig.rcb(batch_ops=32, oplog_group=8))
    t = st.RemoteBPTree(fe, "t")
    for k in random.Random(3).sample(range(10 ** 6), 300):
        t.insert(k, k)
    fe.drain(t.h)
    m = be.mirrors[0]
    out = {"lagging": drv.state(be, fe), "pending": m._n_pending,
           "applied": be.replica_applied_seq("t")}
    m.sync()
    out["synced"] = drv.state(be, fe)
    return out


def test_lagging_mirror_matches_reference():
    runs = _both(_lagging)
    _assert_same(runs)
    port = runs["repro_torch"]
    assert port["pending"] > 0 and port["lagging"]["mirrors"][0] != port["lagging"]["arena"]
    assert port["synced"]["mirrors"][0] == port["synced"]["arena"]


FRESH = 10 ** 7  # keys above the preload's


def _image_run(pkg):
    be, fe, obj, keys, _ = drv.run_cell(pkg, "bptree", "rcb", 400, 200, 1.0)
    for k in keys[:150]:  # two op-log groups of 64 land; the data area lags
        obj.insert(k + FRESH, k)
    return be, keys


@pytest.mark.parametrize("writer", drv.PACKAGES)
def test_blade_image_recovers_in_the_other_package(writer):
    """An image written by one package, carried with ``convert``, reboots
    in the other to the same bytes, and the structure recovers there."""
    reader = next(p for p in drv.PACKAGES if p != writer)
    be, keys = _image_run(writer)
    be.crash()
    if writer == "repro":
        image = (bytes(be.arena), [bytes(m.arena) for m in be.mirrors])
        other = convert.load_blade(*image, device="cpu")
    else:
        image = convert.blade_image(be)
        other = drv.core_of(reader).NVMBackend(capacity=len(image[0]),
                                               num_mirrors=len(image[1]))
        other.arena = bytearray(image[0])
        for m, a in zip(other.mirrors, image[1]):
            m.arena = bytearray(a)
        other.reboot()
    be.reboot()  # the writer's own recovery from the same bytes
    assert drv.state(other)["arena"] == drv.state(be)["arena"]
    assert drv.state(other)["mirrors"] == drv.state(be)["mirrors"]
    assert other._names == be._names and other._free == be._free
    found = {}
    for pkg, blade in ((reader, other), (writer, be)):
        core, st = drv.core_of(pkg), drv.structures_of(pkg)
        tree = st.RemoteBPTree.recover(core.FrontEnd(blade, core.FEConfig.rcb(), fe_id=1),
                                       "bptree")
        found[pkg] = [tree.find(k) for k in keys[:100]] + [tree.find(k + FRESH) for k in keys[:150]]
    assert found[reader] == found[writer]
    assert found[reader][:100 + 128] == keys[:100] + keys[:128]  # the replayed groups


def _traced(pkg):
    obs = __import__(f"{pkg}.obs", fromlist=["obs"])
    core, st = drv.core_of(pkg), drv.structures_of(pkg)
    try:
        with obs.observe(trace=True, metrics=True) as sess:
            be = core.NVMBackend(capacity=1 << 23, **KW(pkg))
            fe = core.FrontEnd(be, core.FEConfig.rcb(cache_bytes=1 << 16))
            ht = st.RemoteHashTable(fe, "m", n_buckets=256)
            ht.put_many([(i, i) for i in range(200)])
            ht.get_many(list(range(200)))
            t = st.RemoteBPTree(fe, "t")
            for k in range(300):
                t.insert(k * 7, k)
            fe.drain(ht.h)
            fe.drain(t.h)
            doc = sess.tracer.to_chrome()
            hists = {op: h.to_dict() for op, h in fe.op_hist.items()}
    finally:
        obs.stop()
    return {"trace": json.loads(json.dumps(doc)), "hists": hists,
            "state": drv.state(be, fe)}


def test_traced_run_exports_the_reference_trace_and_histograms():
    runs = _both(_traced)
    _assert_same(runs)
    assert runs["repro_torch"]["trace"]["traceEvents"]
    assert {"put_many", "get_many"} <= set(runs["repro_torch"]["hists"])


def test_blade_counts_its_copies_and_launches_nothing_on_the_cpu():
    be, fe, obj, keys, _ = drv.run_cell("repro_torch", "hashtable", "r", 100, 50, 1.0)
    assert be.d2h > 0 and be.h2d > 0
    assert nvm_log.fletcher64_launches == nvm_log.apply_launches == 0
    assert dataclasses.asdict(be.stats)["tx_commits"] > 0


def _blade_verbs(pkg, lag=0):
    """The verbs no structure of Table 3 reaches: named blobs, tombstoned
    names, atomics, and a log area that outgrows itself (rotation: the live
    suffix moves to a region twice the size, on a card a device copy).
    With `lag`, the mirror runs that many writes behind, so the blocks a
    regrown blob and a rotated area give back are cleared one bit a write."""
    core = drv.core_of(pkg)
    oplog = ref_oplog if pkg == "repro" else port_oplog
    be = core.NVMBackend(capacity=1 << 22, num_mirrors=1, **KW(pkg))
    if lag:
        be.mirrors[0].set_lag(lag)
    out = {}
    be.put_blob("dir", b"x" * 700)
    be.put_blob("dir", b"y" * 100)   # shrinks in place
    be.put_blob("dir", b"z" * 1500)  # regrows: frees all of the old allocation
    out["blob"] = be.get_blob("dir")
    be.set_name("a", 5)
    out["atomics"] = [be.atomic_add(be.name_slot_addr("a"), 3),
                      be.atomic_cas(be.name_slot_addr("a"), 8, 11),
                      be.atomic_cas(be.name_slot_addr("a"), 8, 12), be.get_name("a")]
    out["deleted"] = [be.delete_name("a"), be.has_name("a"), be.delete_name("a")]
    be.set_name("b", 1)  # reuses the tombstone
    area = be.create_log_area("g.txlog", 2)
    rng = random.Random(11)
    for _ in range(40):  # 512 bytes of area, never applied: it must grow
        be.tx_append(area, oplog.encode_tx([oplog.MemLog(be.heap_start + 8 * rng.randrange(50),
                                                         rng.randbytes(16))]))
    out["area"] = (area.addr, area.size, area.head, area.applied)
    out["applied"] = be.tx_apply(area)
    out["state"] = drv.state(be)
    be.crash()
    be.reboot()
    out.update(names=sorted(be._names.items()), free=list(be._free), after=drv.state(be))
    if lag:
        be.mirrors[0].sync()
        out["synced"] = drv.state(be)
    return out


def test_blade_verbs_and_log_rotation_match_reference():
    runs = _both(_blade_verbs)
    _assert_same(runs)
    port = runs["repro_torch"]
    assert port["area"][1] > 512 and port["applied"] == 40
    assert port["deleted"] == [True, False, False]


def _lagging_frees(structure):
    """A stack or queue whose mirror runs four writes behind, at write share
    0.5, then popped empty with its empty slabs handed back: the blocks it
    frees clear their bitmap bits while the mirror lags."""
    def scenario(pkg):
        core = drv.core_of(pkg)
        be = core.NVMBackend(capacity=1 << 23, num_mirrors=1, **KW(pkg))
        be.mirrors[0].set_lag(4)
        fe = core.FrontEnd(be, drv.fe_config(pkg, "rcb", batch=32))
        obj, _ = drv.build(pkg, fe, structure, 600)
        out = {"results": drv.workload(fe, obj, structure, 600, 0.5)}
        out["vals"] = drv.contents(obj, structure, [])
        fe.drain(obj.h)
        out["released"] = fe.allocator.release_empty()
        out["free"] = list(be._free)
        out["lagging"] = drv.state(be, fe)
        be.mirrors[0].sync()
        out["synced"] = drv.state(be, fe)
        return out
    return scenario


@pytest.mark.parametrize("structure", ["stack", "queue"])
def test_lagging_mirror_frees_match_reference(structure):
    runs = _both(_lagging_frees(structure))
    _assert_same(runs)
    port = runs["repro_torch"]
    assert port["released"] > 0 and port["free"]
    assert port["synced"]["mirrors"][0] == port["synced"]["arena"]


def test_lagging_mirror_blade_verbs_match_reference():
    runs = _both(lambda pkg: _blade_verbs(pkg, lag=4))
    _assert_same(runs)
    port = runs["repro_torch"]
    assert port["area"][1] > 512 and port["free"]
    assert port["synced"]["mirrors"][0] == port["synced"]["arena"]
