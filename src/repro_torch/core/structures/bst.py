"""Remote persistent binary search tree (paper §8.2, Algorithm 1).

Structure-specific optimizations:

  * level-threshold caching — nodes at depth <= N are cached; N adapts by
    the miss-ratio rule (alpha > 50% -> N-1, alpha < 25% -> N+1);
  * vector operations — a sorted batch of inserts descends the tree once as
    key segments (BFS over [begin,end) ranges); each frontier level's node
    reads go out as one doorbell-batched RDMA round, and bulk attachment of
    a whole segment builds a balanced subtree locally (create_sub_tree).
"""

from __future__ import annotations

import struct
from bisect import bisect_left, insort
from typing import List, Optional, Tuple

import numpy as np

from ..frontend import FrontEnd
from .base import RemoteStructure

OP_INSERT = 1

NODE = struct.Struct("<qqQQ")  # key, value, left, right
NODE_SIZE = NODE.size


class RemoteBST(RemoteStructure):
    REPLAY = {OP_INSERT: "_replay_insert"}

    def __init__(self, fe: FrontEnd, name: str, create: bool = True):
        super().__init__(fe, name)
        if create:
            fe.backend.set_name(f"{name}.root", 0)
            self._root = 0
        else:
            self._root = fe.backend.get_name(f"{name}.root")
        self.cache_level_thr = 14
        self._window_ops = 0
        self._window_miss0 = (0, 0)
        self._vecbuf: List[Tuple[int, int]] = []       # sorted (key, value)
        if fe.cfg.use_batch:
            self.h.pre_flush = self._materialize

    # ------------------------------------------------------------------ util
    def _read(self, addr: int, depth: int):
        cacheable = depth <= self.cache_level_thr
        return NODE.unpack(self.fe.read(self.h, addr, NODE_SIZE, cacheable=cacheable))

    def _adapt(self) -> None:
        self._window_ops += 1
        if self._window_ops < 512:
            return
        c = self.fe.cache
        h0, m0 = self._window_miss0
        dh, dm = c.hits - h0, c.misses - m0
        alpha = dm / (dh + dm) if (dh + dm) else 0.0
        if alpha > 0.50 and self.cache_level_thr > 1:
            self.cache_level_thr -= 1
        elif alpha < 0.25 and self.cache_level_thr < 48:
            self.cache_level_thr += 1
        self._window_ops = 0
        self._window_miss0 = (c.hits, c.misses)

    # ------------------------------------------------------------------- ops
    def insert(self, key: int, value: int) -> None:
        self.fe.op_begin(self.h, OP_INSERT, self.encode_args(key, value))
        if self.fe.cfg.use_batch:
            i = bisect_left(self._vecbuf, (key,))
            if i < len(self._vecbuf) and self._vecbuf[i][0] == key:
                self._vecbuf[i] = (key, value)
            else:
                self._vecbuf.insert(i, (key, value))
        else:
            self._insert_base(key, value)
        self.fe.op_commit(self.h)
        self._adapt()

    def find(self, key: int):
        i = bisect_left(self._vecbuf, (key,))
        if i < len(self._vecbuf) and self._vecbuf[i][0] == key:
            return self._vecbuf[i][1]
        addr, depth = self._root, 0
        while addr:
            k, v, l, r = self._read(addr, depth)
            if key == k:
                self._adapt()
                return v
            addr = l if key < k else r
            depth += 1
        self._adapt()
        return None

    # ------------------------------------------------------------ vector ops
    def get_many(self, keys: List[int]) -> List[Optional[int]]:
        """Vector lookup (aliased as ``lookup_many``): the sorted batch
        descends once as key segments — BFS over [begin, end) ranges, one
        doorbell-batched read wave per frontier level (the read pattern of
        Algorithm 1's vector insert, applied to lookups)."""
        if not self.fe.cfg.use_batch or len(keys) <= 1 or not self._root:
            with self.op_window("get_many", len(keys)):
                return [self.find(k) for k in keys]
        with self.op_window("get_many", len(keys)):
            return self._get_many_batched(keys)

    def _get_many_batched(self, keys: List[int]) -> List[Optional[int]]:
        out: List[Optional[int]] = [None] * len(keys)
        rem: List[int] = []
        for i, k in enumerate(keys):
            j = bisect_left(self._vecbuf, (k,))
            if j < len(self._vecbuf) and self._vecbuf[j][0] == k:
                out[i] = self._vecbuf[j][1]
            else:
                rem.append(i)
        if not rem:
            return out
        rem.sort(key=lambda i: keys[i])
        skeys = [keys[i] for i in rem]
        frontier: List[Tuple[int, int, int, int]] = [(0, len(rem), self._root, 0)]
        while frontier:
            depth = frontier[0][3]  # BFS: one level per wave
            reads = self.fe.read_many(
                self.h,
                [(addr, NODE_SIZE) for _, _, addr, _ in frontier],
                cacheable=depth <= self.cache_level_thr,
            )
            # one columnar decode for the whole level: every node is the
            # same 4x int64 record, so a single frombuffer view replaces a
            # struct.unpack per node (addresses fit in int64)
            cols = np.frombuffer(b"".join(reads), dtype="<i8").reshape(-1, 4)
            ks = cols[:, 0].tolist()
            vs = cols[:, 1].tolist()
            ls = cols[:, 2].tolist()
            rs = cols[:, 3].tolist()
            nxt: List[Tuple[int, int, int, int]] = []
            for j, (b, e, _, depth) in enumerate(frontier):
                k, v, l, r = ks[j], vs[j], ls[j], rs[j]
                mid_lo = bisect_left(skeys, k, b, e)
                mid_hi = mid_lo
                while mid_hi < e and skeys[mid_hi] == k:
                    out[rem[mid_hi]] = v
                    mid_hi += 1
                if b < mid_lo and l:
                    nxt.append((b, mid_lo, l, depth + 1))
                if mid_hi < e and r:
                    nxt.append((mid_hi, e, r, depth + 1))
            frontier = nxt
        for _ in keys:
            self._adapt()
        return out

    # ------------------------------------------------------------ primitives
    def _insert_base(self, key: int, value: int) -> None:
        if not self._root:
            self._root = self._new_node(key, value)
            self.write_root(self._root)
            return
        addr, depth = self._root, 0
        while True:
            k, v, l, r = self._read(addr, depth)
            if key == k:
                self.fe.write(self.h, addr, NODE.pack(k, value, l, r))
                return
            child = l if key < k else r
            if not child:
                new = self._new_node(key, value)
                if key < k:
                    self.fe.write(self.h, addr, NODE.pack(k, v, new, r))
                else:
                    self.fe.write(self.h, addr, NODE.pack(k, v, l, new))
                return
            addr, depth = child, depth + 1

    def _new_node(self, key: int, value: int, left: int = 0, right: int = 0) -> int:
        addr = self.fe.alloc(NODE_SIZE)
        self.fe.write(self.h, addr, NODE.pack(key, value, left, right))
        return addr

    def _create_sub_tree(self, kvs: List[Tuple[int, int]]) -> int:
        """Balanced subtree from a sorted segment, built locally and staged
        through one ``write_many`` batch (Algorithm 1's create_sub_tree).
        Allocation and staging order match the node-at-a-time recursion
        exactly (post-order), so the arena is byte-identical to it; only
        the write accounting batches — freshly carved chunks are adjacent,
        so most of the subtree combines into a few WQEs."""
        if not kvs:
            return 0
        writes: List[Tuple[int, bytes]] = []

        def build(lo: int, hi: int) -> int:
            if lo >= hi:
                return 0
            mid = (lo + hi) // 2
            left = build(lo, mid)
            right = build(mid + 1, hi)
            addr = self.fe.alloc(NODE_SIZE)
            writes.append((addr, NODE.pack(kvs[mid][0], kvs[mid][1], left, right)))
            return addr

        root = build(0, len(kvs))
        self.fe.write_many(self.h, writes)
        return root

    # ------------------------------------------------- vector insert (Alg. 1)
    def _materialize(self) -> None:
        if not self._vecbuf:
            return
        kvs = self._vecbuf
        self._vecbuf = []
        if not self._root:
            self._root = self._create_sub_tree(kvs)
            self.write_root(self._root)
            return
        # BFS over (begin, end, node) segments; one doorbell-batched read
        # round per frontier level.
        frontier: List[Tuple[int, int, int, int]] = [(0, len(kvs), self._root, 0)]
        while frontier:
            depth = frontier[0][3]  # BFS: one level per wave
            reads = self.fe.read_many(
                self.h,
                [(addr, NODE_SIZE) for _, _, addr, _ in frontier],
                cacheable=depth <= self.cache_level_thr,  # paper §8.2
            )
            nxt: List[Tuple[int, int, int, int]] = []
            for (begin, end, addr, depth), raw in zip(frontier, reads):
                if begin >= end:
                    continue
                k, v, l, r = NODE.unpack(raw)
                mid_lo = bisect_left(kvs, (k,), begin, end)
                mid_hi = mid_lo
                newv, newl, newr = v, l, r
                if mid_lo < end and kvs[mid_lo][0] == k:
                    newv = kvs[mid_lo][1]
                    mid_hi = mid_lo + 1
                if begin < mid_lo:
                    if l:
                        nxt.append((begin, mid_lo, l, depth + 1))
                    else:
                        newl = self._create_sub_tree(kvs[begin:mid_lo])
                if mid_hi < end:
                    if r:
                        nxt.append((mid_hi, end, r, depth + 1))
                    else:
                        newr = self._create_sub_tree(kvs[mid_hi:end])
                if (newv, newl, newr) != (v, l, r):
                    self.fe.write(self.h, addr, NODE.pack(k, newv, newl, newr))
            frontier = nxt

    # ---------------------------------------------------------------- replay
    def _replay_insert(self, key: int, value: int) -> None:
        self._insert_base(key, value)

    # ------------------------------------------------------------- traversal
    def items(self) -> List[Tuple[int, int]]:
        """In-order traversal (testing/verification)."""
        out: List[Tuple[int, int]] = []
        overlay = dict(self._vecbuf)

        def walk(addr: int, depth: int) -> None:
            if not addr:
                return
            k, v, l, r = self._read(addr, depth)
            walk(l, depth + 1)
            out.append((k, overlay.pop(k, v)))
            walk(r, depth + 1)

        walk(self._root, 0)
        for k in sorted(overlay):
            insort(out, (k, overlay[k]))
        return out
