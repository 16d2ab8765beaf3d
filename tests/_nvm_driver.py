"""One driver of the rNVM simulator for both packages.

The port's tests run the same seeded preload and op stream through
``repro.core`` (the JAX package's simulator, the reference) and
``repro_torch.core`` (the port, its blades on the CPU) and compare what
each leaves behind.  The driver follows ``benchmarks/common.py``'s
``build_structure`` and ``run_write_workload`` (Table 3's harness), cut
to a test's size, and takes the package as an argument.
"""

from __future__ import annotations

import dataclasses
import importlib
import random

from benchmarks.common import cache_bytes_for
from benchmarks.table3_throughput import SKIP, STRUCTURES, VARIANTS

CLASSES = {"stack": "RemoteStack", "queue": "RemoteQueue", "hashtable": "RemoteHashTable",
           "skiplist": "RemoteSkipList", "bst": "RemoteBST", "bptree": "RemoteBPTree",
           "mv_bst": "RemoteMVBST", "mv_bpt": "RemoteMVBPTree"}
# Table 3's cells: the eight structures under the six variants, less its SKIP
CELLS = [(s, v) for s in STRUCTURES for v in VARIANTS if (s, v) not in SKIP]
PACKAGES = ("repro", "repro_torch")


def core_of(pkg: str):
    return importlib.import_module(f"{pkg}.core")


def structures_of(pkg: str):
    return importlib.import_module(f"{pkg}.core.structures")


def blade_kwargs(pkg: str) -> dict:
    """The port's blades run on the CPU here; the reference has no device."""
    return {"device": "cpu"} if pkg == "repro_torch" else {}


def fe_config(pkg: str, variant: str, cache_bytes: int = 6 << 20, batch: int = 1024):
    """``benchmarks.common.VARIANTS`` in `pkg`'s FEConfig."""
    F = core_of(pkg).FEConfig
    return {"sym": lambda: F(symmetric=True),
            "symb": lambda: F(symmetric=True, sym_batch=True, batch_ops=batch),
            "naive": F.naive, "r": F.r,
            "rc": lambda: F.rc(cache_bytes=cache_bytes),
            "rcb": lambda: F.rcb(batch_ops=batch, cache_bytes=cache_bytes)}[variant]()


def build(pkg: str, fe, structure: str, preload: int, seed: int = 0):
    """``benchmarks.common.build_structure``: (structure, preloaded keys)."""
    cls = getattr(structures_of(pkg), CLASSES[structure])
    keys = random.Random(seed).sample(range(preload * 8), preload)
    if structure in ("stack", "queue"):
        obj = cls(fe, structure)
        push = obj.push if structure == "stack" else obj.enqueue
        for i in range(preload):
            push(i)
    elif structure == "hashtable":
        obj = cls(fe, structure, n_buckets=max(1024, preload // 4))
        for k in keys:
            obj.put(k, k)
    elif structure == "skiplist":
        obj = cls(fe, structure)
        for k in sorted(keys):
            obj.insert(k, k)
    elif structure in ("bst", "bptree"):
        obj = cls(fe, structure)
        for k in keys:
            obj.insert(k, k)
    else:
        obj = cls(fe, structure)
        obj.build_from_sorted(sorted((k, k) for k in keys))
    fe.drain(obj.h)
    return obj, keys


def workload(fe, obj, structure: str, n_ops: int, write_frac: float, seed: int = 1):
    """``benchmarks.common.run_write_workload``; returns every op's result."""
    rng = random.Random(seed)
    out = []
    if structure in ("stack", "queue"):
        push = obj.push if structure == "stack" else obj.enqueue
        pop = obj.pop if structure == "stack" else obj.dequeue
        for i in range(n_ops):
            out.append(push(i) if rng.random() < write_frac else pop())
    else:
        write = obj.insert if hasattr(obj, "insert") else obj.put
        read = obj.find if hasattr(obj, "find") else obj.get
        for _ in range(n_ops):
            k = rng.randrange(1 << 30)
            out.append(write(k, k) if rng.random() < write_frac else read(k))
    fe.drain(obj.h)
    return out


def run_cell(pkg: str, structure: str, variant: str, preload: int, n_ops: int,
             write_frac: float, capacity: int = 1 << 22):
    """One Table 3 cell, cut to size: (blade, front end, structure, keys,
    results)."""
    core = core_of(pkg)
    be = core.NVMBackend(capacity=capacity, **blade_kwargs(pkg))
    fe = core.FrontEnd(be, fe_config(pkg, variant, cache_bytes_for(structure, preload, 0.10)))
    obj, keys = build(pkg, fe, structure, preload)
    results = workload(fe, obj, structure, n_ops, write_frac)
    return be, fe, obj, keys, results


def arena_bytes(arena) -> bytes:
    """A blade's arena as bytes: the reference's bytearray, the port's tensor."""
    if isinstance(arena, (bytes, bytearray)):
        return bytes(arena)
    return arena.cpu().numpy().tobytes()


def state(be, fe=None) -> dict:
    """Everything a run leaves that must agree between the packages: the
    arena and every mirror's, both clocks, both Stats, the cache's counts."""
    out = {"arena": arena_bytes(be.arena),
           "mirrors": [arena_bytes(m.arena) for m in be.mirrors],
           "blade_clock": be.clock.now, "blade_stats": dataclasses.asdict(be.stats),
           "alive": be.alive}
    if fe is not None:
        out.update(fe_clock=fe.clock.now, fe_stats=dataclasses.asdict(fe.stats),
                   cache=(fe.cache.hits, fe.cache.misses, fe.cache.evictions))
    return out


def contents(obj, structure: str, keys) -> list:
    """The structure's contents, read through its own API (pops a stack or
    queue empty)."""
    if structure in ("stack", "queue"):
        take = obj.pop if structure == "stack" else obj.dequeue
        vals = []
        while (v := take()) is not None:
            vals.append(v)
        return vals
    if hasattr(obj, "items"):
        return list(obj.items())
    return [obj.find(k) for k in sorted(keys)]
