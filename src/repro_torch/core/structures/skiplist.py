"""Remote persistent skip-list (paper §8.2 / §9.1).

Fixed-height nodes (simplifies remote IO to one read per node).  Structure-
specific optimizations:

  * degree-based caching — only nodes whose tower height is >= an adaptive
    threshold are cached (the paper's "higher degree nodes will be cached"),
    with the miss-ratio feedback rule (alpha > 50% -> cache fewer levels,
    alpha < 25% -> cache more);
  * naturally lock-free publication — a new node's own pointers are written
    first, then predecessors are relinked bottom-to-top, so concurrent
    readers always traverse a consistent list (Fig. 6).
"""

from __future__ import annotations

import random
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..frontend import FrontEnd
from .base import RemoteStructure

OP_INSERT = 1

MAX_LEVEL = 14
HDR = struct.Struct("<qqQ")  # key, value, height
NODE_SIZE = HDR.size + 8 * MAX_LEVEL
NEG_INF = -(1 << 62)


class _Node:
    __slots__ = ("key", "value", "height", "nexts")

    @classmethod
    def decode(cls, raw: bytes) -> "_Node":
        n = cls()
        n.key, n.value, n.height = HDR.unpack_from(raw, 0)
        n.nexts = list(struct.unpack_from(f"<{MAX_LEVEL}Q", raw, HDR.size))
        return n

    def encode(self) -> bytes:
        return HDR.pack(self.key, self.value, self.height) + struct.pack(
            f"<{MAX_LEVEL}Q", *self.nexts
        )


class RemoteSkipList(RemoteStructure):
    REPLAY = {OP_INSERT: "_replay_insert"}

    def __init__(self, fe: FrontEnd, name: str, create: bool = True, seed: int = 7):
        super().__init__(fe, name)
        self._rng = random.Random(seed)
        self.cache_level_thr = 4      # cache nodes with height >= thr
        self._window_ops = 0
        self._window_miss0 = (0, 0)
        if create:
            head = _Node()
            head.key, head.value, head.height = NEG_INF, 0, MAX_LEVEL
            head.nexts = [0] * MAX_LEVEL
            self.head_addr = fe.alloc(NODE_SIZE)
            fe.write(self.h, self.head_addr, head.encode())
            fe.backend.set_name(f"{name}.root", self.head_addr)
            fe.flush_memlogs(self.h, sync=True)
        else:
            self.head_addr = fe.backend.get_name(f"{name}.root")

    # ------------------------------------------------------------------ util
    def _read_node(self, addr: int, height_hint: int = MAX_LEVEL) -> _Node:
        cacheable = height_hint >= self.cache_level_thr
        return _Node.decode(self.fe.read(self.h, addr, NODE_SIZE, cacheable=cacheable))

    def _rand_height(self) -> int:
        height = 1
        while height < MAX_LEVEL and self._rng.random() < 0.5:
            height += 1
        return height

    def _adapt(self) -> None:
        """Miss-ratio feedback on the caching threshold (paper §8.2)."""
        self._window_ops += 1
        if self._window_ops < 512:
            return
        c = self.fe.cache
        h0, m0 = self._window_miss0
        dh, dm = c.hits - h0, c.misses - m0
        alpha = dm / (dh + dm) if (dh + dm) else 0.0
        if alpha > 0.50 and self.cache_level_thr < MAX_LEVEL:
            self.cache_level_thr += 1  # thrashing: keep only taller towers
        elif alpha < 0.25 and self.cache_level_thr > 1:
            self.cache_level_thr -= 1  # room to cache more
        self._window_ops = 0
        self._window_miss0 = (c.hits, c.misses)

    # ------------------------------------------------------------------- ops
    def insert(self, key: int, value: int) -> None:
        self.fe.op_begin(self.h, OP_INSERT, self.encode_args(key, value))
        self._insert_base(key, value)
        self.fe.op_commit(self.h)
        self._adapt()

    def find(self, key: int):
        x_addr = self.head_addr
        x = self._read_node(x_addr)
        for lvl in range(MAX_LEVEL - 1, -1, -1):
            while x.nexts[lvl]:
                nxt = self._read_node(x.nexts[lvl], lvl + 1)
                if nxt.key < key:
                    x_addr, x = x.nexts[lvl], nxt
                else:
                    break
        if x.nexts[0]:
            cand = self._read_node(x.nexts[0], 1)
            if cand.key == key:
                return cand.value
        self._adapt()
        return None

    # ------------------------------------------------------------ vector ops
    def _walk_many(self, keys: List[int], *, prefetch: bool) -> List[Optional[int]]:
        """Run every key's top-down predecessor search concurrently: each
        step, the next node of every in-flight key goes out in ONE doorbell
        wave (shared towers deduplicated across keys), and a key whose next
        hop was fetched by the same wave advances for free.

        ``prefetch=True`` warms the cache for a following serial apply pass
        (full descent, no network charge for local hits, no per-node CPU);
        ``prefetch=False`` is the lookup itself — reads charge normally via
        ``read_many`` and a key stops as soon as its node is found.
        Returns the found values (all-None in prefetch mode)."""
        fe, h = self.fe, self.h
        reader = fe.prefetch_many if prefetch else fe.read_many
        # columnar node rows: [key, value, height, next_0 .. next_13] — one
        # np.frombuffer per wave replaces a struct.unpack per node visit
        # (each fetched node is decoded once, however many keys hop it)
        _row_w = 3 + MAX_LEVEL
        head_row = np.frombuffer(
            reader(h, [(self.head_addr, NODE_SIZE)])[0], dtype="<i8"
        ).tolist()
        out: List[Optional[int]] = [None] * len(keys)
        # per-key walk state: current node's decoded row + level
        state: Dict[int, List] = {
            i: [head_row, MAX_LEVEL - 1] for i in range(len(keys))
        }

        def next_req(i: int) -> Optional[int]:
            row, lvl = state[i]
            while lvl >= 0:
                nxt = row[3 + lvl]
                if nxt:
                    return nxt
                lvl -= 1
                state[i][1] = lvl
            return None

        cursors: Dict[int, int] = {}
        for i in range(len(keys)):
            req = next_req(i)
            if req is not None:
                cursors[i] = req
        while cursors:
            addrs = sorted(set(cursors.values()))
            raws = reader(h, [(a, NODE_SIZE) for a in addrs])
            rows = np.frombuffer(b"".join(raws), dtype="<i8").reshape(
                -1, _row_w
            ).tolist()
            fetched = dict(zip(addrs, rows))
            nxt_cursors: Dict[int, int] = {}
            for i, addr in cursors.items():
                req: Optional[int] = addr
                ki = keys[i]
                # hop through every node this wave already fetched
                while req is not None and req in fetched:
                    row = fetched[req]
                    rk = row[0]
                    if not prefetch and rk == ki:
                        out[i] = row[1]
                        req = None
                        break
                    if rk < ki:
                        state[i][0] = row              # move right
                    else:
                        state[i][1] -= 1               # descend
                    req = next_req(i)
                if req is not None:
                    nxt_cursors[i] = req
            cursors = nxt_cursors
        return out

    def put_many(self, kvs) -> None:
        """Vector insert (aliased as ``insert_many``): sorted batch, one
        doorbell wave per predecessor-search step to warm the cache, then
        the exact serial insert per pair — predecessor towers are read over
        the fabric once per batch instead of once per key.  The caching
        threshold is dropped for the window so the warmed nodes are actually
        served from cache regardless of tower height."""
        cfg = self.fe.cfg
        kvs = sorted(kvs)
        with self.op_window("put_many", len(kvs)):
            if not (cfg.use_batch and cfg.use_cache) or len(kvs) <= 1:
                for k, v in kvs:
                    self.insert(k, v)
                return
            thr0, self.cache_level_thr = self.cache_level_thr, 1
            try:
                with self.fe.write_wave(linger=True):
                    self._walk_many([k for k, _ in kvs], prefetch=True)
                    for k, v in kvs:
                        self.insert(k, v)
            finally:
                self.cache_level_thr = min(thr0, self.cache_level_thr)

    def get_many(self, keys: List[int]):
        """Vector lookup: the whole batch's predecessor walks advance in
        doorbell waves; values are taken straight from the walked nodes (no
        second pass, so the result does not depend on cache retention)."""
        with self.op_window("get_many", len(keys)):
            if not self.fe.cfg.use_batch or len(keys) <= 1:
                return [self.find(k) for k in keys]
            vals = self._walk_many(keys, prefetch=False)
            for _ in keys:
                self._adapt()
            return vals

    # ------------------------------------------------------------ primitives
    def _insert_base(self, key: int, value: int) -> None:
        update_addrs = [0] * MAX_LEVEL
        update_nodes: dict[int, _Node] = {}
        x_addr = self.head_addr
        x = self._read_node(x_addr)
        for lvl in range(MAX_LEVEL - 1, -1, -1):
            while x.nexts[lvl]:
                nxt = self._read_node(x.nexts[lvl], lvl + 1)
                if nxt.key < key:
                    x_addr, x = x.nexts[lvl], nxt
                else:
                    break
            update_addrs[lvl] = x_addr
            update_nodes[x_addr] = x
        # existing key: in-place value update
        if x.nexts[0]:
            cand = self._read_node(x.nexts[0], 1)
            if cand.key == key:
                cand.value = value
                self.fe.write(self.h, x.nexts[0], cand.encode())
                return
        height = self._rand_height()
        addr = self.fe.alloc(NODE_SIZE)
        node = _Node()
        node.key, node.value, node.height = key, value, height
        node.nexts = [0] * MAX_LEVEL
        for lvl in range(height):
            node.nexts[lvl] = update_nodes[update_addrs[lvl]].nexts[lvl]
        # publication order: the new node first ...
        self.fe.write(self.h, addr, node.encode())
        # ... then predecessors bottom-to-top (lock-free for readers)
        for lvl in range(height):
            pred = update_nodes[update_addrs[lvl]]
            pred.nexts[lvl] = addr
        for paddr in dict.fromkeys(update_addrs[:height]):
            self.fe.write(self.h, paddr, update_nodes[paddr].encode())

    # ---------------------------------------------------------------- replay
    def _replay_insert(self, key: int, value: int) -> None:
        self._insert_base(key, value)
