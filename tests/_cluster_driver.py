"""One driver of the rNVM cluster for both packages.

The port's cluster tests run the same seeded fleets and op streams through
``repro.cluster`` (the JAX package's, the reference) and
``repro_torch.cluster`` (the port, every blade on the CPU) and compare what
each leaves behind: every blade's arena and mirrors, the directory's and
the lease table's bytes, every clock, Stats and telemetry.  Scenarios are
functions of the package name, written once against :func:`pkg`'s
namespace, as ``tests/_nvm_driver.py`` does for one blade.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import random
from types import SimpleNamespace

PACKAGES = ("repro", "repro_torch")
KEYSPACE = 1 << 22  # benchmarks/fig_cluster_scaling.py


def pkg(name: str) -> SimpleNamespace:
    """`name`'s cluster, core, structures, faults and obs modules, and the
    keywords that put a blade or a cluster on the CPU (the reference has
    no device)."""
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        name=name, cluster=mod("cluster"), core=mod("core"), structures=mod("core.structures"),
        faults=mod("faults"), obs=mod("obs"), report=mod("obs.report"),
        apps=mod("core.apps"), cache=mod("core.cache"), failover=mod("cluster.failover"),
        harness=mod("faults.harness"),
        kw={"device": "cpu"} if name == "repro_torch" else {})


def both(scenario) -> dict:
    """{package: scenario(pkg(package))}."""
    return {p: scenario(pkg(p)) for p in PACKAGES}


def assert_same(runs: dict) -> None:
    """Every key of the reference's result equal in the port's."""
    ref, port = runs["repro"], runs["repro_torch"]
    assert ref.keys() == port.keys()
    for key in ref:
        assert port[key] == ref[key], key


def make_cluster(ns, n_blades=2, n_shards=8, capacity=1 << 22, **kw):
    return ns.cluster.NVMCluster(n_blades=n_blades, n_shards=n_shards,
                                 capacity_per_blade=capacity, **kw, **ns.kw)


def digest(arena) -> str:
    """sha256 of an arena: the reference's bytearray or the port's tensor."""
    if isinstance(arena, (bytes, bytearray)):
        return hashlib.sha256(arena).hexdigest()
    return hashlib.sha256(arena.cpu().numpy()).hexdigest()


def blade_state(be) -> dict:
    return {"arena": digest(be.arena), "mirrors": [digest(m.arena) for m in be.mirrors],
            "alive": be.alive, "permanent": be.permanent_failure, "clock": be.clock.now,
            "stats": dataclasses.asdict(be.stats)}


def frontend_state(cfe) -> dict:
    """A ClusterFrontEnd's clock, epoch, Stats, telemetry (histograms
    included) and each per-blade front end's clock and cache counts."""
    return {"clock": cfe.clock.now, "epoch": cfe.epoch, "stats": cfe.stats(),
            "telemetry": cfe.telemetry(), "aggregate": cfe.aggregate_stats(),
            "fes": {bid: (fe.clock.now, fe.cache.hits, fe.cache.misses)
                    for bid, fe in sorted(cfe.fes.items())}}


def cluster_state(cluster, cfes=()) -> dict:
    """Everything a cluster run leaves that must agree between the packages."""
    return {"blades": {bid: blade_state(be) for bid, be in sorted(cluster.blades.items())},
            "directory": cluster.directory.encode(), "epoch": cluster.directory.epoch,
            "assignment": list(cluster.directory.assignment),
            "leases": cluster.leases.encode(), "failovers": cluster.failovers,
            "migrations": cluster.migrations,
            "frontends": [frontend_state(c) for c in cfes]}


def durable(ns):
    """The per-op durable config of the chaos harness and the scaling figure."""
    return ns.core.FEConfig.rc(cache_bytes=4096, oplog_pipeline=1)


def fleet(ns, cluster, n_frontends: int, n_buckets: int):
    """``benchmarks/fig_cluster_scaling.py``'s ``_make_fleet``: a
    ClusterFrontEnd, a table and a seeded rng per front end."""
    cfes, tables, rngs = [], [], []
    for i in range(n_frontends):
        cfe = ns.cluster.ClusterFrontEnd(cluster, durable(ns), fe_id=i)
        tables.append(ns.cluster.ShardedHashTable(cfe, f"t{i}", n_buckets=n_buckets))
        cfes.append(cfe)
        rngs.append(random.Random(1000 + i))
    return cfes, tables, rngs


def reset_clocks(cluster, cfes) -> None:
    """``fig_cluster_scaling._reset_clocks``: the preload / measurement
    barrier (links, clocks and latency histograms start fresh)."""
    for be in cluster.blades.values():
        be.link.reset()
        for m in be.mirrors:
            m.link.reset()
    for cfe in cfes:
        cfe.clock.now = 0.0
        cfe.op_hist.clear()
        cfe._retired_op_hists.clear()
        for fe in cfe.fes.values():
            fe.clock.now = 0.0
            fe.op_hist.clear()


def interleave(cfes, ops: int, step) -> None:
    """Run `ops` steps per front end in virtual-time order (the smallest
    clock goes next), as the scaling figure does; `step(i, done)` runs
    front end i's next batch and returns its size."""
    done = [0] * len(cfes)
    while any(d < ops for d in done):
        i = min((cfes[i].clock.now, i) for i in range(len(cfes)) if done[i] < ops)[1]
        done[i] += step(i, done[i])


def run_scaling(ns, n_blades: int, n_frontends: int, preload: int, ops: int,
                capacity: int = 1 << 22) -> dict:
    """``fig_cluster_scaling.run_scaling`` at a test's size: its numbers and
    the cluster's state."""
    cluster = make_cluster(ns, n_blades, 16, capacity)
    cfes, tables, rngs = fleet(ns, cluster, n_frontends, max(256, preload // 2))
    for t, rng in zip(tables, rngs):
        for k in rng.sample(range(KEYSPACE), preload):
            t.put(k, k)
        t.drain()
    reset_clocks(cluster, cfes)

    def step(i, _):
        k = rngs[i].randrange(KEYSPACE)
        tables[i].put(k, k)
        return 1
    interleave(cfes, ops, step)
    for t in tables:
        t.drain()
    kops = [ops / c.clock.now * 1e6 for c in cfes]
    return {"aggregate_kops": sum(kops), "state": cluster_state(cluster, cfes)}
