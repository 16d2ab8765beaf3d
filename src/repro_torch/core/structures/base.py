"""Shared machinery for remote persistent data structures.

Vector-op support: every structure exposes ``*_many`` batch entry points
(``get_many``/``put_many`` on maps, ``insert_many``/``lookup_many`` on
trees/lists — the base class aliases one family to the other).  The base
implementations fall back to the serial loop; subclasses override them with
wave-batched traversals built on ``FrontEnd.read_many`` /
``prefetch_many`` (one doorbell round per wave of independent node reads)
so a batch shares traversal prefixes and pays one RTT per frontier level
instead of one per node.  ``wave_prefetch`` is the shared pointer-chasing
helper: it advances a cursor per batch item, deduplicates the addresses each
wave, and fetches them with a single doorbell batch while the per-item
``advance`` callbacks chase the returned bytes.
"""

from __future__ import annotations

import contextlib
import struct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..frontend import FrontEnd, StructHandle
from ..oplog import OpLog


def wave_prefetch(
    fe: FrontEnd,
    h: StructHandle,
    cursors: Dict[int, Tuple[int, int]],
    advance: Callable[[int, bytes], Optional[Tuple[int, int]]],
    *,
    cacheable: bool = True,
) -> None:
    """Drive many pointer chases with doorbell-batched read waves.

    ``cursors`` maps item id -> (addr, size) of the node it needs next;
    ``advance(item, raw)`` consumes the node bytes and returns the next
    (addr, size) — or None when that item's traversal is done.  Each wave
    deduplicates the outstanding addresses, fetches them with ONE
    ``prefetch_many`` doorbell batch (cache misses only), then advances
    every item.  Items whose next node was fetched by the same wave simply
    hit the warmed cache on the following wave for free.
    """
    while cursors:
        reqs = sorted({req for req in cursors.values()})
        fetched = dict(zip(reqs, fe.prefetch_many(h, list(reqs), cacheable=cacheable)))
        nxt: Dict[int, Tuple[int, int]] = {}
        for item, req in cursors.items():
            cur: Optional[Tuple[int, int]] = req
            # advance may hop several already-fetched nodes in one wave
            while cur is not None and cur in fetched:
                cur = advance(item, fetched[cur])
            if cur is not None:
                nxt[item] = cur
        cursors = nxt


def mix64(x: int) -> int:
    """splitmix64 finalizer — the hash used by the hash table."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def mix64_np(x: "np.ndarray") -> "np.ndarray":
    """Vectorized splitmix64 over a uint64 column — bit-identical to
    :func:`mix64` per element (numpy uint64 arithmetic wraps mod 2**64
    exactly like the Python version's masking)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class RemoteStructure:
    """Base class: owns a StructHandle, a locally-known root register, and
    the op-log replay protocol used for front-end crash recovery."""

    #: subclasses: {opcode: method name}
    REPLAY = {}

    #: log-area sizes in blocks; shard-sized subclasses override these so a
    #: cluster of many small shards doesn't exhaust a blade's heap.
    OPLOG_BLOCKS = 4096
    TXLOG_BLOCKS = 4096

    def __init__(self, fe: FrontEnd, name: str):
        self.fe = fe
        self.name = name
        self.h: StructHandle = fe.register(name, self.OPLOG_BLOCKS, self.TXLOG_BLOCKS)

    # root pointer ----------------------------------------------------------
    @property
    def root_addr(self) -> int:
        return self.fe.backend.name_slot_addr(f"{self.name}.root")

    def read_root(self) -> int:
        raw = self.fe.read(self.h, self.root_addr, 8, cacheable=False)
        return struct.unpack("<Q", raw)[0]

    def write_root(self, value: int) -> None:
        self.fe.write(self.h, self.root_addr, struct.pack("<Q", value))

    # observability ----------------------------------------------------------
    @contextlib.contextmanager
    def op_window(self, op: str, n: int):
        """Measure one vector-op call against the front-end's sim clock:
        the window's latency lands in ``fe.op_hist[op]`` once per item (a
        batch of 64 gets records 64 samples of the shared window latency),
        and — when tracing — the window becomes an ``op:<name>`` span
        enclosing the waves/fences it issued."""
        fe = self.fe
        t0 = fe.clock.now
        try:
            yield
        finally:
            t1 = fe.clock.now
            if n > 0:
                fe.record_op_latency(op, t1 - t0, n)
            tr = fe.trace
            if tr is not None:
                tr.span(fe._tk, f"op:{op}", t0, t1,
                        {"n": n, "struct": self.name})

    # vector ops -------------------------------------------------------------
    # Serial fallbacks; subclasses override with wave-batched traversals.
    # Maps speak get/put, trees and lists speak lookup/insert — the aliases
    # below make both families available on every structure.
    def put_many(self, pairs: List[tuple]) -> None:
        """Vector write: the serial apply loop IS the source of truth for
        what bytes land (the arena stays byte-identical to per-op calls);
        the surrounding doorbell write wave batches the costs — allocation
        RPCs and op-log group commits post into shared doorbells with one
        completion fence, and each op charges the vector-op CPU cost."""
        write = getattr(self, "put", None) or self.insert  # type: ignore[attr-defined]
        with self.op_window("put_many", len(pairs)):
            with self.fe.write_wave(linger=True):
                for k, v in pairs:
                    write(k, v)

    def get_many(self, keys: List[int]) -> List[Optional[int]]:
        read = getattr(self, "get", None) or self.find  # type: ignore[attr-defined]
        with self.op_window("get_many", len(keys)):
            return [read(k) for k in keys]

    def insert_many(self, pairs: List[tuple]) -> None:
        self.put_many(pairs)

    def lookup_many(self, keys: List[int]) -> List[Optional[int]]:
        return self.get_many(keys)

    # space reclaim ----------------------------------------------------------
    def _free_storage(self) -> None:
        """Subclass hook: free the structure's own data blocks (nodes,
        bucket arrays, ...) through the front-end allocator."""

    def destroy_storage(self) -> None:
        """Release every NVM block this structure owns back to the blade:
        data nodes (via ``_free_storage``), both log areas, and the naming
        slots (tombstoned so the linear probe stays sound).  Used by shard
        migration to reclaim the tombstoned source copy — afterwards the
        blocks are on the blade's free list and the structure must never be
        touched again through this object."""
        be = self.fe.backend
        self._free_storage()
        self.fe.allocator.release_empty()
        for area in (self.h.oplog_area, self.h.txlog_area):
            be.free_blocks(area.addr, area.size // be.block_size)
            be._log_areas.pop(area.name, None)
            for suffix in ("addr", "size", "head", "applied"):
                be.delete_name(f"{area.name}.{suffix}")
        for n in (f"{self.name}.seq", f"{self.name}.opsn", f"{self.name}.root"):
            be.delete_name(n)
        # a destroyed handle must not be drained again
        if self.h in self.fe.handles:
            self.fe.handles.remove(self.h)
        self.h.wbuf.clear()
        self.h.oplog_staged.clear()
        self.h.oplog_staged_ops = 0
        self.h.pending_ops = 0

    # recovery ---------------------------------------------------------------
    def replay(self, entries: List[OpLog]) -> int:
        """Re-execute operations whose memory logs never committed."""
        n = 0
        for e in entries:
            fn = getattr(self, self.REPLAY[e.op])
            fn(*self.decode_args(e.op, e.payload))
            n += 1
        return n

    @classmethod
    def recover(cls, fe: FrontEnd, name: str, **kw) -> "RemoteStructure":
        """Attach a fresh front-end to an existing structure and replay the
        un-executed op-log tail (paper §7.5: front-end failure)."""
        obj = cls(fe, name, create=False, **kw)  # type: ignore[call-arg]
        pending = fe.unreplayed_oplogs(obj.h)
        obj.replay(pending)
        fe.drain(obj.h)
        return obj

    # helpers -----------------------------------------------------------------
    @staticmethod
    def decode_args(op: int, payload: bytes) -> tuple:
        n = len(payload) // 8
        return struct.unpack(f"<{n}q", payload)

    @staticmethod
    def encode_args(*args: int) -> bytes:
        return struct.pack(f"<{len(args)}q", *args)
