"""Cost of a traced call: per-device FLOPs, bytes and collectives, and the
roofline terms.  The port of ``repro.launch.analysis``.

The JAX package reads its costs from a compiled module (XLA's
``cost_analysis`` and the collectives parsed from its HLO text).  The port
has no compiled module: it traces the call once, usually on the ``meta``
device over a fake process group (``launch/dryrun.py``), under a dispatch
mode of its own (``CostMode``) that sees every op each rank runs on its
local shards, after DTensor has turned the sharded program into local ops
and collectives:

  * FLOPs: torch.utils.flop_counter's formulas (the ones FlopCounterMode
    uses) on each local op, so they are per device;
  * bytes: each op's input plus output bytes (views and allocations move
    none).  This is the port's own definition: no fusion is modelled, so it
    is an upper bound on HBM traffic, not XLA's "bytes accessed";
  * collectives: a count, by kind (all-reduce, all-gather, reduce-scatter,
    all-to-all, collective-permute for send/recv, broadcast), of the
    collectives the call issues, with their result bytes per device and the
    ring estimate of their wire bytes (all-reduce 2x, the others 1x), the
    JAX package's estimate.

FLOPs/bytes for deep models come from two small depths that differ by one
repeating block (``diff_cost``, ``combine_linear``), as in the JAX package.

Hardware model (H100 SXM, per card): 989e12 bf16 FLOP/s dense, 3.35e12 B/s
HBM, 450e9 B/s NVLink a direction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ------------------------------------------------------------------ hardware
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card (dense)
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s NVLink per card, one direction

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
         "broadcast")
_KIND_OF = {  # op name (namespace stripped, overload dropped) -> kind
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided")


def _kind(func) -> Optional[str]:
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    return _KIND_OF.get(func._schema.name.split("::")[-1])


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class CostMode(TorchDispatchMode):
    """Counts the FLOPs, bytes and collectives of every local op run inside
    it (DTensor ops pass through to the local ops and collectives they
    issue; the fake tensors of DTensor's shape inference are not counted)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        kind = _kind(func)
        if kind is not None:
            nbytes = _nbytes(_tensors(args[0]) if func.namespace == "c10d" else _tensors(out))
            rec = self.collectives.setdefault(kind, {"count": 0, "result_bytes": 0.0,
                                                     "wire_bytes": 0.0})
            rec["count"] += 1
            rec["result_bytes"] += nbytes
            rec["wire_bytes"] += nbytes * (2.0 if kind == "all-reduce" else 1.0)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        aliases = any(r.alias_info is not None for r in func._schema.returns)
        if not aliases and func._schema.name.split("::")[-1] not in _NO_TRAFFIC:
            self.bytes += _nbytes(_tensors(list(args) + list(kwargs.values()))) \
                + _nbytes(_tensors(out))
        return out


def parse_collectives(fn: Callable[[], Any]) -> Dict[str, Dict[str, float]]:
    """Per collective kind: the count and the result bytes (per device) of
    the collectives `fn()` issues, plus the ring estimate of their wire
    bytes."""
    with CostMode() as mode:
        fn()
    return mode.collectives


def total_wire_bytes(colls: Dict[str, Dict[str, float]]) -> float:
    return sum(v["wire_bytes"] for v in colls.values())


@dataclasses.dataclass
class CellCost:
    flops: float                 # per device
    hbm_bytes: float             # per device: op inputs + outputs (see module doc)
    wire_bytes: float            # per device, ring-estimated
    collectives: Dict[str, Dict[str, float]]
    peak_memory: Optional[float] = None
    compile_seconds: Optional[float] = None   # the trace's seconds

    def roofline(self) -> Dict[str, float]:
        t_c = self.flops / PEAK_FLOPS
        t_m = self.hbm_bytes / HBM_BW
        t_n = self.wire_bytes / LINK_BW
        dom = max(("compute", t_c), ("memory", t_m), ("collective", t_n),
                  key=lambda kv: kv[1])[0]
        total = max(t_c, t_m, t_n)
        return {
            "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
            "bottleneck": dom,
            "bound_s": total,
            "compute_fraction": t_c / total if total else 0.0,
        }


_ZERO = {"count": 0, "result_bytes": 0, "wire_bytes": 0}


def combine_linear(base: CellCost, block: CellCost, n_blocks: float) -> CellCost:
    """total = base + block * n_blocks  (see module docstring)."""
    colls: Dict[str, Dict[str, float]] = {}
    for kind in set(base.collectives) | set(block.collectives):
        b = base.collectives.get(kind, _ZERO)
        d = block.collectives.get(kind, _ZERO)
        colls[kind] = {k: b[k] + d[k] * n_blocks for k in ("count", "result_bytes", "wire_bytes")}
    return CellCost(
        flops=base.flops + block.flops * n_blocks,
        hbm_bytes=base.hbm_bytes + block.hbm_bytes * n_blocks,
        wire_bytes=base.wire_bytes + block.wire_bytes * n_blocks,
        collectives=colls,
    )


def diff_cost(c1: CellCost, c2: CellCost) -> CellCost:
    """c2 - c1 = the cost of the extra blocks in c2."""
    colls: Dict[str, Dict[str, float]] = {}
    for kind in set(c1.collectives) | set(c2.collectives):
        a = c1.collectives.get(kind, _ZERO)
        b = c2.collectives.get(kind, _ZERO)
        colls[kind] = {k: max(0.0, b[k] - a[k]) for k in ("count", "result_bytes", "wire_bytes")}
    return CellCost(
        flops=max(0.0, c2.flops - c1.flops),
        hbm_bytes=max(0.0, c2.hbm_bytes - c1.hbm_bytes),
        wire_bytes=max(0.0, c2.wire_bytes - c1.wire_bytes),
        collectives=colls,
    )


def cost_of(fn: Callable[[], Any]) -> CellCost:
    """The counterpart of ``cost_from_compiled``: `fn()` traced once under
    ``CostMode``."""
    import time

    t0 = time.perf_counter()
    with CostMode() as mode:
        fn()
    return CellCost(flops=float(mode.flops), hbm_bytes=float(mode.bytes),
                    wire_bytes=total_wire_bytes(mode.collectives),
                    collectives=mode.collectives, compile_seconds=time.perf_counter() - t0)


def per_device_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor of a tree (DTensors by
    their local shape)."""
    from torch.distributed.tensor import DTensor

    from ..tree import flatten_named

    total = 0
    for _, t in flatten_named(tree):
        local = t.to_local() if isinstance(t, DTensor) else t
        total += math.prod(local.shape) * local.element_size()
    return total
