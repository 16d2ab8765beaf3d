"""The simulator's remaining figures, one driver for both packages.

Each scenario follows one figure script of ``benchmarks/`` by file and
line, written once against :func:`pkg`'s namespace, so it runs through
``repro`` (the JAX package's simulator, the reference) and ``repro_torch``
(the port, its blades on the CPU in the tests, on the card in
``chip_smoke.py``'s ``sim`` phase, which imports this module for the port
alone).  It imports nothing of either package at module level and calls
none of the scripts.

A scenario returns ``{"steps": [(name, state), ...], "rows": ...,
"ops": n}``: every blade's arena and mirror digests, clocks and Stats,
every front end's clock, Stats and cache counts, every op's result, and
the figure's rows without their wall-clock fields.  The vector rows also
return ``"wall"``, each mode's puts' and gets' wall ms an op on the host
clock, which no comparison reads.  Every blade is read once, when its run
ends, so ``ns.copies`` sums each port blade's copies to and from the host
(its mirrors' included) over the scenario.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import hashlib
import importlib
import random
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

PACKAGES = ("repro", "repro_torch")
SMOKE = (400, 120)  # benchmarks/run.py --smoke: preload, ops


def pkg(name: str, device: str = "cpu") -> SimpleNamespace:
    """`name`'s simulator modules; `kw` puts a port blade or cluster on
    `device` (the reference has no device)."""
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        name=name, core=mod("core"), structures=mod("core.structures"), sim=mod("core.sim"),
        oplog=mod("core.oplog"), base=mod("core.structures.base"), cluster=mod("cluster"),
        obs=mod("obs"), kw={"device": device} if name == "repro_torch" else {},
        copies={"d2h": 0, "h2d": 0})


def both(scenario, *args, **kwargs) -> dict:
    """{package: scenario(pkg(package), ...)}, the port's blades on the CPU."""
    return {p: scenario(pkg(p), *args, **kwargs) for p in PACKAGES}


def assert_same(runs: dict) -> dict:
    """Every step's state, the rows and the op count of the reference's run
    equal in the port's; returns the port's run."""
    ref, port = runs["repro"], runs["repro_torch"]
    assert [n for n, _ in port["steps"]] == [n for n, _ in ref["steps"]]
    for (name, want), (_, got) in zip(ref["steps"], port["steps"]):
        assert got.keys() == want.keys(), name
        for key in want:
            assert got[key] == want[key], (name, key)
    assert port["rows"] == ref["rows"]
    assert port["ops"] == ref["ops"]
    return port


# ------------------------------------------------------------------ state
def digest(arena) -> str:
    """sha256 of an arena: the reference's bytearray or the port's tensor."""
    if isinstance(arena, (bytes, bytearray)):
        return hashlib.sha256(arena).hexdigest()
    return hashlib.sha256(arena.cpu().numpy()).hexdigest()


def blade_state(ns, be) -> dict:
    """A blade's digests, clock and Stats, read once when its run ends;
    a port blade's host copies go to ``ns.copies``."""
    if hasattr(be, "d2h"):
        for side in ("d2h", "h2d"):
            ns.copies[side] += getattr(be, side) + sum(getattr(m, side) for m in be.mirrors)
    return {"arena": digest(be.arena), "mirrors": [digest(m.arena) for m in be.mirrors],
            "clock": be.clock.now, "stats": dataclasses.asdict(be.stats), "alive": be.alive}


def fe_state(fe) -> dict:
    return {"clock": fe.clock.now, "stats": dataclasses.asdict(fe.stats),
            "cache": (fe.cache.hits, fe.cache.misses, fe.cache.evictions)}


def cluster_state(ns, cluster, cfes=()) -> dict:
    """Every blade, the directory's and lease table's bytes, and each
    ClusterFrontEnd's clock, Stats, telemetry and per-blade front ends."""
    return {"blades": {bid: blade_state(ns, be) for bid, be in sorted(cluster.blades.items())},
            "directory": cluster.directory.encode(), "epoch": cluster.directory.epoch,
            "leases": cluster.leases.encode(), "failovers": cluster.failovers,
            "frontends": [{"clock": c.clock.now, "stats": c.stats(), "telemetry": c.telemetry(),
                           "fes": {bid: fe_state(fe) for bid, fe in sorted(c.fes.items())}}
                          for c in cfes]}


def log_bytes(be, area) -> bytes:
    """A log area's bytes on the host: one copy from a port blade
    (``_get``, counted in its ``d2h``), a slice of the reference's."""
    if hasattr(be, "_get"):
        return be._get(area.addr, area.size)
    return bytes(be.arena[area.addr:area.addr + area.size])


# ------------------------------------------- benchmarks/common.py, keydist.py
def kops(n_ops: int, ns_: float) -> float:
    return n_ops / ns_ * 1e6 if ns_ > 0 else float("inf")


def cache_bytes_for(structure: str, n: int, frac: float) -> int:
    node = {"bst": 32, "bptree": 256, "skiplist": 136, "mv_bst": 32, "mv_bpt": 256,
            "hashtable": 32}.get(structure, 64)
    return max(4096, int(n * node * frac))


def variant(ns, name: str, **kw):
    """benchmarks/common.py:VARIANTS in `ns`'s FEConfig."""
    F = ns.core.FEConfig
    return {"sym": lambda: F(symmetric=True),
            "symb": lambda: F(symmetric=True, sym_batch=True, batch_ops=kw.get("batch", 1024)),
            "naive": F.naive, "r": F.r,
            "rc": lambda: F.rc(cache_bytes=kw.get("cache_bytes", 6 << 20)),
            "rcb": lambda: F.rcb(batch_ops=kw.get("batch", 1024),
                                 cache_bytes=kw.get("cache_bytes", 6 << 20))}[name]()


def make_fe(ns, name: str, capacity: int = 1 << 26, **kw):
    """benchmarks/common.py:make_fe."""
    be = ns.core.NVMBackend(capacity=capacity, **ns.kw)
    return ns.core.FrontEnd(be, variant(ns, name, **kw))


CLASSES = {"stack": "RemoteStack", "queue": "RemoteQueue", "hashtable": "RemoteHashTable",
           "skiplist": "RemoteSkipList", "bst": "RemoteBST", "bptree": "RemoteBPTree",
           "mv_bst": "RemoteMVBST", "mv_bpt": "RemoteMVBPTree"}


def build_structure(ns, fe, name: str, structure: str, preload: int, seed: int = 0):
    """benchmarks/common.py:build_structure: (structure, preloaded keys)."""
    keys = random.Random(seed).sample(range(preload * 8), preload)
    cls = getattr(ns.structures, CLASSES[structure])
    if structure in ("stack", "queue"):
        obj = cls(fe, name)
        push = obj.push if structure == "stack" else obj.enqueue
        for i in range(preload):
            push(i)
    elif structure == "hashtable":
        obj = cls(fe, name, n_buckets=max(1024, preload // 4))
        for k in keys:
            obj.put(k, k)
    elif structure == "skiplist":
        obj = cls(fe, name)
        for k in sorted(keys):
            obj.insert(k, k)
    elif structure in ("bst", "bptree"):
        obj = cls(fe, name)
        for k in keys:
            obj.insert(k, k)
    else:
        obj = cls(fe, name)
        obj.build_from_sorted(sorted((k, k) for k in keys))
    fe.drain(obj.h)
    return obj, keys


def run_write_workload(fe, obj, structure: str, n_ops: int, write_frac: float = 1.0,
                       seed: int = 1):
    """benchmarks/common.py:run_write_workload: (virtual ns, every result)."""
    rng = random.Random(seed)
    t0, out = fe.clock.now, []
    for _ in range(n_ops):
        k = rng.randrange(1 << 30)
        if rng.random() < write_frac:
            out.append(obj.insert(k, k) if hasattr(obj, "insert") else obj.put(k, k))
        else:
            out.append(obj.find(k) if hasattr(obj, "find") else obj.get(k))
    fe.drain(obj.h)
    return fe.clock.now - t0, out


def percentile_fields(hist, prefix: str) -> Dict[str, float]:
    """benchmarks/common.py:percentile_fields."""
    if hist is None or not hist.count:
        return {}
    p50, p99, p999 = hist.percentiles((50, 99, 99.9))
    return {f"{prefix}_service_p50_us": round(p50 / 1e3, 3),
            f"{prefix}_service_p99_us": round(p99 / 1e3, 3),
            f"{prefix}_service_p999_us": round(p999 / 1e3, 3)}


def obs_rebase(ns) -> None:
    sess = ns.obs.session()
    if sess is not None:
        sess.rebase()


def uniform_keys(n: int, keyspace: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, keyspace, size=n, dtype=np.int64)


def zipf_keys(ns, n: int, keyspace: int, theta: float = 0.99, seed: int = 0) -> np.ndarray:
    """benchmarks/keydist.py:zipf_keys, scrambled by `ns`'s splitmix64."""
    zeta = np.cumsum(np.arange(1, keyspace + 1, dtype=np.float64) ** -theta)
    u = np.random.default_rng(seed).random(n) * zeta[-1]
    ranks = np.searchsorted(zeta, u, side="left").astype(np.int64)
    mixed = ns.base.mix64_np(ranks.astype(np.uint64))
    return (mixed % np.uint64(keyspace)).astype(np.int64)


def op_mix(n: int, read_frac: float, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random(n) < read_frac


# ---------------------------------------------- benchmarks/fig9_scalability.py
FIG9 = (15000, 1500, 1500)   # PRELOAD, WRITER_OPS, READER_OPS (:17-19)
SNAPSHOT_REFRESH = 64
CONSISTENT_READS = 8         # closing reads a lock reader takes by read_consistent


def fig9_blade(ns, mode: str, preload: int):
    """run_mode's set-up (:26-40): a 64 MB blade, the writer's front end and
    the preloaded tree (lock: a BST; mv: a multi-version BST)."""
    be = ns.core.NVMBackend(capacity=1 << 26, **ns.kw)
    wfe = ns.core.FrontEnd(be, ns.core.FEConfig.rcb(
        batch_ops=256, cache_bytes=cache_bytes_for("bst", preload, 0.10)))
    keys = random.Random(0).sample(range(1 << 24), preload)
    if mode == "lock":
        tree = ns.structures.RemoteBST(wfe, "t")
        for k in keys:
            tree.insert(k, k)
        wfe.drain(tree.h)
    else:
        tree = ns.structures.RemoteMVBST(wfe, "t")
        tree.build_from_sorted(sorted((k, k) for k in keys))
    return be, wfe, tree, keys


def fig9_run(ns, mode: str, n_readers: int, be, wfe, tree, keys, writer_ops: int,
             reader_ops: int) -> dict:
    """run_mode's readers and its virtual-time interleaving (:41-150): the
    writer and `n_readers` reader front ends, the smallest clock next; lock
    readers bracket each find with reader_begin / reader_validate and retry
    when a writer's SN bump fell inside it.  Then each lock reader takes
    CONSISTENT_READS reads through read_consistent with the writer done."""
    core, st = ns.core, ns.structures
    preload = len(keys)
    wlock = core.WriterPreferredLock(wfe, "L") if mode == "lock" else None
    readers = []
    for i in range(n_readers):
        rfe = core.FrontEnd(be, core.FEConfig.rc(
            cache_bytes=cache_bytes_for("bst", preload, 0.10)), fe_id=i + 1)
        rfe.clock.now = wfe.clock.now
        if mode == "lock":
            readers.append((rfe, st.RemoteBST(rfe, "t", create=False),
                            core.WriterPreferredLock(rfe, "L"), random.Random(100 + i)))
        else:
            readers.append((rfe, st.RemoteMVBST(rfe, "t", create=False), None,
                            random.Random(100 + i)))
    wrng = random.Random(7)
    w_done, r_done = 0, [0] * n_readers
    r_roots = [None] * n_readers
    retries = 0
    sn_bumps: List[float] = []
    w_out: List = []
    r_out: List[List] = [[] for _ in range(n_readers)]

    def writer_step():
        nonlocal w_done
        k = wrng.randrange(1 << 24)
        if mode == "lock":
            wlock.writer_lock()
            sn_bumps.append(wfe.clock.now)
            w_out.append(tree.insert(k, k))
            wlock.writer_unlock()
            sn_bumps.append(wfe.clock.now)
        else:
            w_out.append(tree.insert(k, k))
        w_done += 1

    def sn_changed_between(t0: float, t1: float) -> bool:
        return bisect.bisect_right(sn_bumps, t1) > bisect.bisect_right(sn_bumps, t0)

    def advance_writer_to(t: float):
        while w_done < writer_ops and wfe.clock.now < t:
            writer_step()

    def reader_step(i):
        nonlocal retries
        rfe, robj, rlock, rng = readers[i]
        key = rng.choice(keys)
        if mode == "lock":
            while True:
                sn = rlock.reader_begin()
                t0 = rfe.clock.now
                got = robj.find(key)
                rlock.reader_validate(sn)
                t1 = rfe.clock.now
                advance_writer_to(t1)
                if not sn_changed_between(t0, t1):
                    break
                retries += 1
        else:
            if r_done[i] % SNAPSHOT_REFRESH == 0 or r_roots[i] is None:
                r_roots[i] = robj.snapshot_root()
            got = robj.find_from(r_roots[i], key)
        r_out[i].append(got)
        r_done[i] += 1

    while w_done < writer_ops or any(r < reader_ops for r in r_done):
        candidates = []
        if w_done < writer_ops:
            candidates.append((wfe.clock.now, "w", 0))
        for i in range(n_readers):
            if r_done[i] < reader_ops:
                candidates.append((readers[i][0].clock.now, "r", i))
        _, kind, idx = min(candidates)
        if kind == "w":
            writer_step()
        else:
            reader_step(idx)
    wfe.drain(tree.h)

    reader_kops = [kops(reader_ops, r[0].clock.now) for r in readers]
    row = {"writer_kops": kops(writer_ops, wfe.clock.now),
           "reader_kops_avg": sum(reader_kops) / max(len(reader_kops), 1) if reader_kops else 0.0,
           "reader_kops_total": sum(reader_kops),
           "retry_frac": retries / max(sum(r_done), 1)}
    consistent = []
    if mode == "lock":
        for rfe, robj, rlock, rng in readers:
            for _ in range(CONSISTENT_READS):
                key = rng.choice(keys)
                consistent.append(rlock.read_consistent(lambda: robj.find(key)))
    state = {"blade": blade_state(ns, be), "writer": fe_state(wfe),
             "readers": [fe_state(r[0]) for r in readers], "writer_results": w_out,
             "reader_results": r_out, "consistent_reads": consistent}
    return {"steps": [(f"{mode} readers={n_readers}", state)], "rows": row,
            "ops": preload + writer_ops + n_readers * reader_ops}


def fig9(ns, mode: str, n_readers: int, preload: int, writer_ops: int, reader_ops: int):
    """fig9_scalability.run_mode(mode, n_readers)."""
    be, wfe, tree, keys = fig9_blade(ns, mode, preload)
    return fig9_run(ns, mode, n_readers, be, wfe, tree, keys, writer_ops, reader_ops)


def fig9_mv_after_crossing(ns, be, keys, n_readers: int, writer_ops: int, reader_ops: int):
    """Fig 9's mv run on a blade rebooted from another package's image: the
    writer recovers the tree on a fresh front end, then the run goes on."""
    wfe = ns.core.FrontEnd(be, ns.core.FEConfig.rcb(
        batch_ops=256, cache_bytes=cache_bytes_for("bst", len(keys), 0.10)))
    tree = ns.structures.RemoteMVBST.recover(wfe, "t")
    return fig9_run(ns, "mv", n_readers, be, wfe, tree, keys, writer_ops, reader_ops)


# ----------------------------------------------- benchmarks/fig_vector_ops.py
VECTOR = (15000, 2560, 64)   # main's preload, n_ops, batch (:193)
VECTOR_STRUCTURES = ("hashtable", "bst", "bptree", "skiplist")
CACHE_FRAC = {"skiplist": 0.20}


def _vector_cache(structure: str, preload: int) -> int:
    return max(16 << 10, cache_bytes_for(structure, preload, CACHE_FRAC.get(structure, 0.05)))


def vector_structure(ns, structure: str, preload: int, n_ops: int, batch: int = 64):
    """bench_structure (:69-109): a serial loop against `*_many` batches on
    a fresh, identically preloaded blade each."""
    rng = random.Random(11)
    fresh_pairs = [(rng.randrange(1 << 30), i) for i in range(n_ops)]
    row: Dict[str, float] = {"batch": batch}
    steps, ops, wall = [], 0, {}
    for mode in ("serial", "batched"):
        be = ns.core.NVMBackend(capacity=1 << 26, **ns.kw)
        fe = ns.core.FrontEnd(be, ns.core.FEConfig.rcb(
            cache_bytes=_vector_cache(structure, preload)))
        obj, keys = build_structure(ns, fe, f"v_{structure}", structure, preload)
        read_keys = rng.sample(keys, min(n_ops, len(keys)))
        t0, w0 = fe.clock.now, time.perf_counter()
        if mode == "serial":
            write = obj.put if hasattr(obj, "put") else obj.insert
            puts = [write(k, v) for k, v in fresh_pairs]
        else:
            write_many = obj.put_many if hasattr(obj, "put") else obj.insert_many
            puts = [write_many(fresh_pairs[i:i + batch]) for i in range(0, n_ops, batch)]
        fe.drain(obj.h)
        row[f"{mode}_put_kops"] = kops(n_ops, fe.clock.now - t0)
        wall[f"{mode}_put"] = (time.perf_counter() - w0) * 1e3 / n_ops
        t0, w0 = fe.clock.now, time.perf_counter()
        if mode == "serial":
            read = obj.get if hasattr(obj, "get") else obj.find
            gets = [read(k) for k in read_keys]
        else:
            read_many = obj.get_many if hasattr(obj, "get") else obj.lookup_many
            gets = [read_many(read_keys[i:i + batch]) for i in range(0, len(read_keys), batch)]
        row[f"{mode}_get_kops"] = kops(len(read_keys), fe.clock.now - t0)
        wall[f"{mode}_get"] = (time.perf_counter() - w0) * 1e3 / len(read_keys)
        if mode == "batched":
            row.update(percentile_fields(fe.op_hist.get("put_many"), "put"))
            row.update(percentile_fields(fe.op_hist.get("get_many"), "get"))
        steps.append((f"{structure} {mode}", {"blade": blade_state(ns, be), "fe": fe_state(fe),
                                              "puts": puts, "gets": gets}))
        ops += preload + n_ops + len(read_keys)
    row["put_speedup"] = row["batched_put_kops"] / row["serial_put_kops"]
    row["get_speedup"] = row["batched_get_kops"] / row["serial_get_kops"]
    return {"steps": steps, "rows": row, "ops": ops, "wall": wall}


def vector_cross_structure(ns, preload: int, n_ops: int, batch: int = 64):
    """bench_cross_structure (:112-149): a hash table and a BST on one blade,
    serial against batch_all() windows that flush both structures' logs in
    one combined posted write."""
    rng = random.Random(19)
    mixed = [(rng.randrange(2), rng.randrange(1 << 30), i) for i in range(n_ops)]
    row: Dict[str, float] = {"batch": batch}
    steps, ops, wall = [], 0, {}
    for mode in ("serial", "batched"):
        be = ns.core.NVMBackend(capacity=1 << 26, **ns.kw)
        fe = ns.core.FrontEnd(be, ns.core.FEConfig.rcb(
            cache_bytes=_vector_cache("hashtable", preload)))
        ht, _ = build_structure(ns, fe, "x_ht", "hashtable", preload, seed=0)
        bst, _ = build_structure(ns, fe, "x_bst", "bst", preload, seed=1)
        t0, w0, out = fe.clock.now, time.perf_counter(), []
        if mode == "serial":
            for which, k, v in mixed:
                out.append((ht.put if which else bst.insert)(k, v))
        else:
            for i in range(0, len(mixed), batch):
                chunk = mixed[i:i + batch]
                ht_part = [(k, v) for which, k, v in chunk if which]
                bst_part = [(k, v) for which, k, v in chunk if not which]
                with fe.batch_all():
                    if ht_part:
                        out.append(ht.put_many(ht_part))
                    if bst_part:
                        out.append(bst.insert_many(bst_part))
        fe.drain(ht.h)
        fe.drain(bst.h)
        row[f"{mode}_put_kops"] = kops(n_ops, fe.clock.now - t0)
        wall[f"{mode}_put"] = (time.perf_counter() - w0) * 1e3 / n_ops
        reads = ht.get_many([k for which, k, _ in mixed if which])
        reads += [bst.find(k) for which, k, _ in mixed if not which]
        steps.append((f"cross_structure {mode}", {"blade": blade_state(ns, be),
                                                  "fe": fe_state(fe), "puts": out,
                                                  "read_back": reads}))
        ops += 2 * preload + 2 * n_ops
    row["put_speedup"] = row["batched_put_kops"] / row["serial_put_kops"]
    return {"steps": steps, "rows": row, "ops": ops, "wall": wall}


def vector_cluster(ns, preload: int, n_ops: int, batch: int = 64, n_blades: int = 4):
    """bench_cluster (:152-185): ShardedHashTable over `n_blades` default
    blades (64 MB, one mirror each), serial routing against put_many."""
    rng = random.Random(13)
    load = [(rng.randrange(1 << 30), i) for i in range(preload)]
    fresh = [(rng.randrange(1 << 30), i) for i in range(n_ops)]
    row: Dict[str, float] = {"batch": batch, "blades": n_blades}
    steps, ops, wall = [], 0, {}
    for mode in ("serial", "batched"):
        cluster = ns.cluster.NVMCluster(n_blades=n_blades, n_shards=4 * n_blades, **ns.kw)
        cfe = ns.cluster.ClusterFrontEnd(cluster, ns.core.FEConfig.rcb(
            cache_bytes=_vector_cache("hashtable", preload)))
        ht = ns.cluster.ShardedHashTable(cfe, "vkv", n_buckets=max(1024, preload // 4))
        ht.put_many(load)
        ht.drain()
        cfe.op_hist.clear()
        t0, w0 = cfe.clock.now, time.perf_counter()
        if mode == "serial":
            out = [ht.put(k, v) for k, v in fresh]
        else:
            out = [ht.put_many(fresh[i:i + batch]) for i in range(0, len(fresh), batch)]
        ht.drain()
        row[f"{mode}_put_kops"] = kops(n_ops, cfe.clock.now - t0)
        wall[f"{mode}_put"] = (time.perf_counter() - w0) * 1e3 / n_ops
        if mode == "batched":
            row.update(percentile_fields(cfe.op_hist.get("put_many"), "put"))
        reads = ht.get_many([k for k, _ in fresh])
        steps.append((f"cluster {mode}", {"cluster": cluster_state(ns, cluster, [cfe]),
                                          "puts": out, "read_back": reads}))
        ops += preload + 2 * n_ops
    row["put_speedup"] = row["batched_put_kops"] / row["serial_put_kops"]
    return {"steps": steps, "rows": row, "ops": ops, "wall": wall}


# --------------------------------------------------- benchmarks/fig_sweeps.py
BATCH_STRUCTS = ["bst", "bptree", "skiplist", "mv_bst", "mv_bpt"]
CACHE_STRUCTS = ["bst", "bptree", "skiplist", "mv_bst", "mv_bpt"]
MIX_STRUCTS = ["bst", "bptree", "mv_bst", "mv_bpt"]
SWEEPS = dict(batches=(1, 1024), fracs=(0.10, 1.0), write_fracs=(1.0, 0.5))  # run.py --smoke


def sweeps(ns, preload: int, n_ops: int, batches=(1, 1024), fracs=(0.10, 1.0),
           write_fracs=(1.0, 0.5), figs=("fig7", "fig8", "fig12")):
    """fig7_batch_sweep, fig8_cache_sweep and fig12_workloads (:12-46), each
    point a fresh rcb front end on a 64 MB blade; `figs` picks the figures."""
    points = ([("fig7", s, b, dict(batch=b, cache_bytes=cache_bytes_for(s, preload, 0.10)), 1.0)
               for s in BATCH_STRUCTS for b in batches]
              + [("fig8", s, f, dict(batch=1024, cache_bytes=cache_bytes_for(s, preload, f)), 1.0)
                 for s in CACHE_STRUCTS for f in fracs]
              + [("fig12", s, wf, dict(batch=1024, cache_bytes=cache_bytes_for(s, preload, 0.10)),
                  wf) for s in MIX_STRUCTS for wf in write_fracs])
    points = [p for p in points if p[0] in figs]
    rows: Dict[str, Dict[str, dict]] = {fig: {} for fig in figs}
    steps = []
    for fig, s, x, kw, wf in points:
        fe = make_fe(ns, "rcb", **kw)
        obj, _ = build_structure(ns, fe, s, s, preload)
        elapsed, out = run_write_workload(fe, obj, s, n_ops, write_frac=wf)
        rows[fig].setdefault(s, {})[x] = kops(n_ops, elapsed)
        steps.append((f"{fig} {s} {x}", {"blade": blade_state(ns, fe.backend), "fe": fe_state(fe),
                                         "results": out}))
    return {"steps": steps, "rows": rows, "ops": len(points) * (preload + n_ops)}


# -------------------------------------------- benchmarks/table2_allocators.py
ALLOC_SIZE = 32
TABLE2_N = 1500  # run.py --smoke


def table2(ns, n: int = TABLE2_N):
    """_two_tier(128), _two_tier(1024) and _rpc (:21-47): MOPS on the fabric
    model, each on a fresh 64 MB blade."""
    rows, steps = {}, []
    for name, slab in (("rpc", 64), ("two-tier-128", 128), ("two-tier-1024", 1024)):
        be = ns.core.NVMBackend(capacity=1 << 26, block_size=slab, **ns.kw)
        fe = ns.core.FrontEnd(be, ns.core.FEConfig.rcb())
        t0 = fe.clock.now
        if name == "rpc":
            addrs = [fe._backend_alloc(1) for _ in range(n)]
        else:
            addrs = [fe.alloc(ALLOC_SIZE) for _ in range(n)]
        t_alloc = fe.clock.now - t0
        t0 = fe.clock.now
        for a in addrs:
            if name == "rpc":
                fe._backend_free(a, 1)
            else:
                fe.free(a)
        t_free = fe.clock.now - t0
        rows[name] = (n / t_alloc * 1e3, n / t_free * 1e3)
        steps.append((name, {"blade": blade_state(ns, be), "fe": fe_state(fe), "addrs": addrs}))
    return {"steps": steps, "rows": rows, "ops": 6 * n}


# ---------------------------------------- benchmarks/fig11_replication_cpu.py
def fe_driven_replication(ns):
    """FEDrivenReplicationFrontEnd (:23-40) over `ns`'s FrontEnd: it streams
    every log append to a second blade itself."""
    class FEDrivenReplicationFrontEnd(ns.core.FrontEnd):
        def flush_oplog(self, h, sync=True):
            staged = list(h.oplog_staged)
            super().flush_oplog(h, sync)
            if staged:
                self._round(sum(len(s) for s in staged), nvm_write=True)

        def flush_memlogs(self, h, sync=False):
            n = sum(len(v) + 13 for v in h.wbuf.values()) + 9 if h.wbuf else 0
            super().flush_memlogs(h, sync)
            if n:
                self._pipelined_write(n)
                self.clock.advance(self.cost.rtt_ns)
    return FEDrivenReplicationFrontEnd


def fig11(ns, preload: int, ops: int):
    """main (:67-76): blade mirrors, no replication, and FE-driven
    replication, each a BST under rcb(256) on a fresh 64 MB blade."""
    out, steps = {}, []
    for name, fe_cls, mirrors in (("blade_rep", ns.core.FrontEnd, 1),
                                  ("no_rep", ns.core.FrontEnd, 0),
                                  ("fe_rep", fe_driven_replication(ns), 0)):
        be = ns.core.NVMBackend(capacity=1 << 26, num_mirrors=mirrors, **ns.kw)
        fe = fe_cls(be, ns.core.FEConfig.rcb(batch_ops=256,
                                             cache_bytes=cache_bytes_for("bst", preload, 0.10)))
        t = ns.structures.RemoteBST(fe, "t")
        for k in random.Random(0).sample(range(1 << 24), preload):
            t.insert(k, k)
        fe.drain(t.h)
        start_fe, start_be = fe.clock.now, be.clock.now
        fe.busy_ns = 0.0
        rng = random.Random(3)
        results = []
        for _ in range(ops):
            k = rng.randrange(1 << 24)
            results.append(t.insert(k, k))
        fe.drain(t.h)
        elapsed = fe.clock.now - start_fe
        out[name] = {"kops": kops(ops, elapsed), "fe_busy": fe.busy_ns / elapsed,
                     "be_busy": (be.clock.now - start_be) / elapsed}
        steps.append((name, {"blade": blade_state(ns, be), "fe": fe_state(fe),
                             "busy_ns": fe.busy_ns, "results": results}))
    out["overhead_blade"] = 1 - out["blade_rep"]["kops"] / out["no_rep"]["kops"]
    out["overhead_fe"] = 1 - out["fe_rep"]["kops"] / out["no_rep"]["kops"]
    return {"steps": steps, "rows": out, "ops": 3 * (preload + ops)}


# ------------------------------------------ benchmarks/fig10_multi_frontend.py
FIG10_SHARDS = 8
ZIPF_THETA = 0.99
FIG10_BATCH = 32
LOAD_FRAC = 0.9
FIG10 = dict(counts=(1, 2), pool=400, ops_per_writer=150)  # run.py --smoke


class _Writer:
    """_Writer (:61-76): one writer front end sharing the table ``mw``."""

    def __init__(self, ns, cluster, idx: int, pool: int):
        cfg = ns.core.FEConfig.rcb(cache_bytes=1 << 16, batch_ops=64, oplog_group=16)
        self.cfe = ns.cluster.ClusterFrontEnd(cluster, cfg, fe_id=idx)
        self.table = ns.cluster.ShardedHashTable(self.cfe, "mw", n_buckets=max(256, pool))
        self.model: Dict[int, int] = {}
        self._next_val = 1 + (idx << 32)

    def execute(self, batch) -> None:
        pairs = []
        for op in batch:
            pairs.append((op.key, self._next_val))
            self._next_val += 1
        self.table.put_many(pairs)
        self.model.update(pairs)


def committed_stale_epochs(ns, cluster) -> int:
    """_committed_stale_epochs (:79-90): stale-epoch entries in every
    blade's op logs, read to the host."""
    total = 0
    for be in cluster.blades.values():
        for name, area in be._log_areas.items():
            if name.endswith(".oplog"):
                total += ns.oplog.stale_epoch_entries(log_bytes(be, area))
    return total


def _fig10_build(ns, n_writers: int, pool: int):
    """_build (:93-108)."""
    cluster = ns.cluster.NVMCluster(n_blades=2, capacity_per_blade=1 << 24,
                                    n_shards=FIG10_SHARDS, num_mirrors=0, **ns.kw)
    writers = [_Writer(ns, cluster, i, pool) for i in range(n_writers)]
    writers[0].table.put_many([(k, k) for k in range(pool)])
    writers[0].table.drain()
    for be in cluster.blades.values():
        be.link.reset()
    for w in writers:
        w.cfe.clock.now = 0.0
        for fe in w.cfe.fes.values():
            fe.clock.now = 0.0
    obs_rebase(ns)
    return cluster, writers


def _fig10_keys(ns, cluster, idx, n_writers, n_ops, pool, mode, seed) -> List[int]:
    """_keys_for (:111-136)."""
    shard_of = cluster.directory.shard_of
    chunk = max(1, cluster.directory.n_shards // n_writers)
    out: List[int] = []
    draw = 0
    while len(out) < n_ops:
        ks = zipf_keys(ns, max(n_ops, 256), pool, theta=ZIPF_THETA, seed=seed + 101 * draw)
        draw += 1
        for k in ks:
            k = int(k)
            if mode == "high" or min(shard_of(k) // chunk, n_writers - 1) == idx:
                out.append(k)
                if len(out) == n_ops:
                    break
    return out


def _fig10_probe(ns, pool: int, n_ops: int):
    """probe_capacity (:139-151): (ops/s, the probe cluster's state)."""
    cluster, writers = _fig10_build(ns, 1, pool)
    w = writers[0]
    keys = _fig10_keys(ns, cluster, 0, 1, n_ops, pool, "high", seed=5)
    t0 = w.cfe.clock.now
    for i in range(0, n_ops, FIG10_BATCH):
        w.execute([ns.sim.OpenLoopOp(0.0, "put", key=k) for k in keys[i:i + FIG10_BATCH]])
    w.table.drain()
    cap = n_ops / ((w.cfe.clock.now - t0) / 1e9)
    return cap, cluster_state(ns, cluster, [w.cfe])


def _fig10_cell(ns, n_writers: int, pool: int, ops_per_writer: int, mode: str, rate: float):
    """run_cell (:154-208): (its row, the cluster's state, the read-back)."""
    cluster, writers = _fig10_build(ns, n_writers, pool)
    stations = []
    for i, w in enumerate(writers):
        keys = _fig10_keys(ns, cluster, i, n_writers, ops_per_writer, pool, mode,
                           seed=7919 * i + (17 if mode == "high" else 23))
        ts = ns.sim.poisson_arrivals(rate, ops_per_writer, seed=31 * i + 7)
        ops = [ns.sim.OpenLoopOp(float(t), "put", key=k, tenant=i) for t, k in zip(ts, keys)]
        st = ns.sim.OpenLoopStation(w.cfe.clock, w.execute, station_id=i,
                                    max_batch=FIG10_BATCH)
        st.offer(ops)
        stations.append(st)
    eng = ns.sim.OpenLoopEngine(stations)
    summary = eng.run()
    for w in writers:
        w.table.drain()
    stale = committed_stale_epochs(ns, cluster)
    owners: Dict[int, set] = {}
    for i, w in enumerate(writers):
        for k in w.model:
            owners.setdefault(k, set()).add(i)
    solo = [k for k, who in owners.items() if len(who) == 1]
    got = writers[0].table.get_many(solo)
    mismatches = sum(v != writers[next(iter(owners[k]))].model[k] for k, v in zip(solo, got))
    steal_hists = [w.cfe.op_hist.get("lease_steal") for w in writers]
    steal_hists = [h for h in steal_hists if h is not None and h.count]
    row = {"mode": mode, "writers": n_writers,
           "aggregate_kops": round(kops(summary["served"], summary["makespan_ns"]), 2),
           "write_lease_steals": cluster.leases.steals,
           "fenced_appends": sum(int(fe.stats.fenced_appends)
                                 for w in writers for fe in w.cfe.fes.values()),
           "shared_mode_shards": len(cluster.leases.shared_shards),
           "steal_p99_us": round(max((h.percentile(99) for h in steal_hists),
                                     default=0.0) / 1e3, 2),
           "committed_stale_epochs": stale, "read_back_mismatches": mismatches}
    state = {"cluster": cluster_state(ns, cluster, [w.cfe for w in writers]),
             "summary": summary, "read_back": got}
    return row, state


def fig10(ns, counts=(1, 2), pool: int = 400, ops_per_writer: int = 150):
    """main (:211-270) without its wall clock: the probe, then each
    (contention mode, writer count) cell at LOAD_FRAC of the probed rate."""
    cap, probe = _fig10_probe(ns, pool, min(ops_per_writer, 512))
    rate = LOAD_FRAC * cap
    steps = [("probe", probe)]
    by_mode: Dict[str, List[Dict]] = {"low": [], "high": []}
    for mode in ("low", "high"):
        for n in counts:
            row, state = _fig10_cell(ns, n, pool, ops_per_writer, mode, rate)
            by_mode[mode].append(row)
            steps.append((f"{mode} writers={n}", state))
    lo = by_mode["low"]
    rows = [{"name": "multi_writer_sweep", "probed_ops_per_s": cap,
             "speedup": round(lo[-1]["aggregate_kops"] / lo[0]["aggregate_kops"], 2)
             if lo[0]["aggregate_kops"] else 0.0,
             "committed_stale_epochs": sum(p["committed_stale_epochs"]
                                           for pts in by_mode.values() for p in pts),
             "read_back_mismatches": sum(p["read_back_mismatches"]
                                         for pts in by_mode.values() for p in pts)}]
    rows += [{"name": f"multi_writer_{m}_{p['writers']}w", **p}
             for m in ("low", "high") for p in by_mode[m]]
    n_ops = (2 * len(counts) + 1) * pool + min(ops_per_writer, 512) \
        + 2 * sum(counts) * ops_per_writer
    return {"steps": steps, "rows": rows, "ops": n_ops}


# ------------------------------------------------ benchmarks/fig_open_loop.py
OL_SHARDS = 8
READ_FRAC = 0.95
OL_BATCH = 64
LOADS = (0.5, 1.0, 2.0, 3.0)
REF_LOAD = 1.0
P99_CEILING_MULT = 4.0
PROBE_OPS = 512  # probe_capacity's ops_per_station
OPEN_LOOP = dict(n_stations=2, pool=256, ops_per_station=96, rc_entries=64)


class _Station:
    """_Station (:61-94): a front end, its own sharded table and a model
    dict that every read is checked against."""

    def __init__(self, ns, cluster, idx: int, pool: int, rc_entries: int):
        cfg = ns.core.FEConfig(use_oplog=True, use_cache=False, use_batch=True,
                               result_cache_entries=rc_entries)
        self.cfe = ns.cluster.ClusterFrontEnd(cluster, cfg, fe_id=idx)
        self.table = ns.cluster.ShardedHashTable(self.cfe, f"t{idx}", n_buckets=max(256, pool))
        self.model: Dict[int, int] = {}
        self.violations = 0
        self._next_val = 1
        self.reads: List = []

    def preload(self, pool: int) -> None:
        pairs = [(k, k) for k in range(pool)]
        self.table.put_many(pairs)
        self.model.update(pairs)
        self.table.drain()

    def execute(self, batch) -> None:
        writes = [(op.key, 0) for op in batch if op.kind == "put"]
        if writes:
            writes = [(k, self._next_val + i) for i, (k, _) in enumerate(writes)]
            self._next_val += len(writes)
            self.table.put_many(writes)
            self.model.update(writes)
        reads = [op.key for op in batch if op.kind == "get"]
        if reads:
            vals = self.table.get_many(reads)
            self.reads.append(vals)
            for k, v in zip(reads, vals):
                if v != self.model.get(k):
                    self.violations += 1


def _ol_fleet(ns, n_stations: int, pool: int, rc_entries: int):
    """_build_fleet (:97-125): (cluster, stations)."""
    cluster = ns.cluster.NVMCluster(n_blades=2, capacity_per_blade=1 << 24,
                                    n_shards=OL_SHARDS, num_mirrors=0, **ns.kw)
    fleet = [_Station(ns, cluster, i, pool, rc_entries) for i in range(n_stations)]
    for st in fleet:
        st.preload(pool)
        if rc_entries:
            st.table.get_many(list(range(pool)))
            for k in st.table._result_cache.counters:
                st.table._result_cache.counters[k] = 0
    for be in cluster.blades.values():
        be.link.reset()
        for m in be.mirrors:
            m.link.reset()
    for st in fleet:
        st.cfe.clock.now = 0.0
        for fe in st.cfe.fes.values():
            fe.clock.now = 0.0
    obs_rebase(ns)
    return cluster, fleet


def _ol_ops(ns, station_idx: int, point_idx: int, n_ops: int, pool: int, rate: float):
    """_ops_for (:128-155)."""
    seed = 7919 * point_idx + station_idx
    half = n_ops // 2
    ts, tenants = ns.sim.merge_streams({
        0: ns.sim.poisson_arrivals(rate / 2.0, half, seed=seed * 2),
        1: ns.sim.poisson_arrivals(rate / 2.0, n_ops - half, seed=seed * 2 + 1)})
    rkeys = zipf_keys(ns, n_ops, pool, theta=ZIPF_THETA, seed=seed + 17)
    wkeys = uniform_keys(n_ops, pool, seed=seed + 23)
    reads = op_mix(n_ops, READ_FRAC, seed=seed + 29)
    return [ns.sim.OpenLoopOp(float(t), "get" if r else "put", key=int(rk if r else wk),
                              tenant=int(tid))
            for t, tid, rk, wk, r in zip(ts, tenants, rkeys, wkeys, reads)]


def observed(ns, scenario, *args, **kwargs):
    """`scenario(ns, ...)` under an obs session, with the session's metrics
    export (its wall-clock ``profile_*`` counters left out) as a last step,
    built once every object of the run is gone: dead engines, front ends
    and result caches reach it through their ``weakref.finalize`` folds.
    The collector runs only at the end, so objects that die in reference
    cycles fold in the same order in either package (a histogram's float
    total depends on that order), not whenever an allocation triggers it."""
    gc.collect()
    gc.disable()
    try:
        with ns.obs.observe() as sess:
            out = scenario(ns, *args, **kwargs)
            gc.collect()
            doc = sess.build_registry().to_json()
    finally:
        gc.enable()
    doc["counters"] = {k: v for k, v in doc["counters"].items() if not k.startswith("profile_")}
    out["steps"].append(("obs export", doc))
    return out


def fleet_state(ns, cluster, fleet) -> dict:
    return {"cluster": cluster_state(ns, cluster, [st.cfe for st in fleet]),
            "reads": [st.reads for st in fleet], "violations": [st.violations for st in fleet]}


def _ol_probe(ns, n_stations: int, pool: int, ops_per_station: int = PROBE_OPS):
    """probe_capacity (:158-188): (ops/s a station, the fleet's state)."""
    cluster, fleet = _ol_fleet(ns, n_stations, pool, rc_entries=0)
    streams = []
    for i in range(n_stations):
        rkeys = zipf_keys(ns, ops_per_station, pool, theta=ZIPF_THETA, seed=101 + i)
        wkeys = uniform_keys(ops_per_station, pool, seed=301 + i)
        reads = op_mix(ops_per_station, READ_FRAC, seed=103 + i)
        streams.append([ns.sim.OpenLoopOp(0.0, "get" if r else "put", key=int(rk if r else wk))
                        for rk, wk, r in zip(rkeys, wkeys, reads)])
    heads = [0] * n_stations
    while True:
        cand = [i for i in range(n_stations) if heads[i] < ops_per_station]
        if not cand:
            break
        i = min(cand, key=lambda j: (fleet[j].cfe.clock.now, j))
        fleet[i].execute(streams[i][heads[i]:heads[i] + OL_BATCH])
        heads[i] += OL_BATCH
    makespan = max(st.cfe.clock.now for st in fleet)
    return ops_per_station / (makespan / 1e9), fleet_state(ns, cluster, fleet)


def _ol_point(ns, point_idx, load_mult, base_rate, n_stations, pool, ops_per_station,
              rc_entries):
    """run_point (:191-232): (its row, the fleet's state, the engine's summary)."""
    cluster, fleet = _ol_fleet(ns, n_stations, pool, rc_entries)
    rate = load_mult * base_rate
    stations = []
    for i, st in enumerate(fleet):
        sim_st = ns.sim.OpenLoopStation(st.cfe.clock, st.execute, station_id=i,
                                        max_batch=OL_BATCH)
        sim_st.offer(_ol_ops(ns, i, point_idx, ops_per_station, pool, rate))
        stations.append(sim_st)
    eng = ns.sim.OpenLoopEngine(stations)
    summary = eng.run()
    lat = eng.arrival_hist.get("get")
    p50, p99, p999 = lat.percentiles((50, 99, 99.9)) if lat is not None else (0.0,) * 3
    hit_rate = 0.0
    if rc_entries:
        stats = [st.table._result_cache.stats() for st in fleet]
        looks = sum(s["hits"] + s["misses"] for s in stats)
        hit_rate = sum(s["hits"] for s in stats) / looks if looks else 0.0
    row = {"load_mult": load_mult, "offered_kops": round(rate * n_stations / 1e3, 2),
           "achieved_kops": round(kops(summary["served"], summary["makespan_ns"]), 2),
           "latency_p50_us": round(p50 / 1e3, 2), "latency_p99_us": round(p99 / 1e3, 2),
           "latency_p999_us": round(p999 / 1e3, 2),
           "queue_depth_max": summary["queue_depth_max"],
           "queue_depth_mean": round(summary["queue_depth_mean"], 2),
           "result_cache_hit_rate": round(hit_rate, 4),
           "staleness_violations": sum(st.violations for st in fleet)}
    return row, dict(fleet_state(ns, cluster, fleet), summary=summary)


def open_loop(ns, n_stations: int = 2, pool: int = 256, ops_per_station: int = 96,
              rc_entries: int = 64):
    """main (:243-289) without its wall clock: the probe, then every load
    point with the result cache off and on, and the sweep's summary row."""
    base_rate, probe = _ol_probe(ns, n_stations, pool)
    steps = [("probe", probe)]
    by_mode: Dict[str, List[Dict]] = {"off": [], "on": []}
    for mode, entries in (("off", 0), ("on", rc_entries)):
        for pi, m in enumerate(LOADS):
            row, state = _ol_point(ns, pi, m, base_rate, n_stations, pool, ops_per_station,
                                   entries)
            row["cache"] = mode
            by_mode[mode].append(row)
            steps.append((f"cache={mode} load={m}", state))
    ceiling = P99_CEILING_MULT * by_mode["off"][0]["latency_p99_us"]

    def sustained(points):
        ok = [p["achieved_kops"] for p in points if p["latency_p99_us"] <= ceiling]
        return max(ok) if ok else 0.0
    sus_off, sus_on = sustained(by_mode["off"]), sustained(by_mode["on"])
    ref_on = by_mode["on"][LOADS.index(REF_LOAD)]
    rows = [{"name": "open_loop_sweep", "probed_ops_per_s": base_rate,
             "staleness_violations": sum(p["staleness_violations"]
                                         for pts in by_mode.values() for p in pts),
             "p99_ceiling_us": round(ceiling, 2), "sustained_off_kops": sus_off,
             "sustained_on_kops": sus_on,
             "cache_speedup_at_p99": round(sus_on / sus_off, 2) if sus_off else float("inf"),
             "hit_rate_at_ref": ref_on["result_cache_hit_rate"],
             "p99_at_ref_us": ref_on["latency_p99_us"]}]
    rows += [{"name": f"open_loop_{m}_{p['load_mult']}x", **p}
             for m in ("off", "on") for p in by_mode[m]]
    n_ops = n_stations * ((1 + 3 * len(LOADS)) * pool + PROBE_OPS
                          + 2 * len(LOADS) * ops_per_station)
    return {"steps": steps, "rows": rows, "ops": n_ops}
