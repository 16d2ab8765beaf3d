"""Remote persistent B+Tree.

256-byte nodes, fanout 14 (keys) / 15 (children) — one cache line of keys
plus pointers, a single remote read per node.  Leaves are chained for range
scans.  Level-threshold caching + sorted vector inserts as for the BST.
"""

from __future__ import annotations

import struct
from bisect import bisect_left, bisect_right, insort
from typing import Dict, List, Optional, Tuple

from ..frontend import FrontEnd
from .base import RemoteStructure

WAVE = 2048  # max independent reads rung with one doorbell


def _balanced_chunks(items: list, cap: int) -> List[list]:
    """Split `items` into the fewest chunks of at most `cap`, sizes as even
    as possible (earlier chunks take the remainder)."""
    j = -(-len(items) // cap)
    base, extra = divmod(len(items), j)
    out: List[list] = []
    off = 0
    for i in range(j):
        sz = base + (1 if i < extra else 0)
        out.append(items[off:off + sz])
        off += sz
    return out

OP_INSERT = 1

FANOUT = 14  # max keys per node
_FMT = struct.Struct("<BB6x14q15Q")
NODE_SIZE = _FMT.size  # 240
LEAF, INTERNAL = 1, 0


class BNode:
    __slots__ = ("kind", "keys", "ptrs")

    def __init__(self, kind: int, keys: Optional[List[int]] = None, ptrs: Optional[List[int]] = None):
        self.kind = kind
        self.keys: List[int] = keys or []
        # leaf: ptrs[i] = value_i (two's complement u64), plus next-leaf link
        # internal: ptrs has len(keys)+1 children
        self.ptrs: List[int] = ptrs or []

    @property
    def next_leaf(self) -> int:
        return self.ptrs[-1] if self.kind == LEAF else 0

    @classmethod
    def decode(cls, raw: bytes) -> "BNode":
        vals = _FMT.unpack(raw)
        kind, n = vals[0], vals[1]
        keys = list(vals[2 : 2 + n])
        raw_ptrs = list(vals[16:])
        if kind == LEAF:
            ptrs = [_u2i(p) for p in raw_ptrs[:n]] + [raw_ptrs[14]]
        else:
            ptrs = raw_ptrs[: n + 1]
        return cls(kind, keys, ptrs)

    def encode(self) -> bytes:
        n = len(self.keys)
        keys = self.keys + [0] * (14 - n)
        if self.kind == LEAF:
            ptrs = [_i2u(v) for v in self.ptrs[:n]] + [0] * (14 - n) + [self.ptrs[-1]]
        else:
            ptrs = self.ptrs + [0] * (15 - len(self.ptrs))
        return _FMT.pack(self.kind, n, *keys, *ptrs)


def _i2u(v: int) -> int:
    return v & 0xFFFFFFFFFFFFFFFF


def _u2i(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


class RemoteBPTree(RemoteStructure):
    REPLAY = {OP_INSERT: "_replay_insert"}

    def __init__(self, fe: FrontEnd, name: str, create: bool = True):
        super().__init__(fe, name)
        if create:
            fe.backend.set_name(f"{name}.root", 0)
            self._root = 0
        else:
            self._root = fe.backend.get_name(f"{name}.root")
        self.cache_level_thr = 3
        self._window_ops = 0
        self._window_miss0 = (0, 0)
        self._vecbuf: List[Tuple[int, int]] = []
        if fe.cfg.use_batch:
            self.h.pre_flush = self._materialize

    # ------------------------------------------------------------------ util
    def _read(self, addr: int, depth: int) -> BNode:
        cacheable = depth <= self.cache_level_thr
        return BNode.decode(self.fe.read(self.h, addr, NODE_SIZE, cacheable=cacheable))

    def _write(self, addr: int, node: BNode) -> None:
        self.fe.write(self.h, addr, node.encode())

    def _new(self, node: BNode) -> int:
        addr = self.fe.alloc(NODE_SIZE)
        self._write(addr, node)
        return addr

    def _adapt(self) -> None:
        self._window_ops += 1
        if self._window_ops < 512:
            return
        c = self.fe.cache
        h0, m0 = self._window_miss0
        dh, dm = c.hits - h0, c.misses - m0
        alpha = dm / (dh + dm) if (dh + dm) else 0.0
        if alpha > 0.50 and self.cache_level_thr > 0:
            self.cache_level_thr -= 1
        elif alpha < 0.25 and self.cache_level_thr < 12:
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
        if not self._root:
            return None
        addr, depth = self._root, 0
        node = self._read(addr, depth)
        while node.kind == INTERNAL:
            idx = bisect_right(node.keys, key)
            addr, depth = node.ptrs[idx], depth + 1
            node = self._read(addr, depth)
        i = bisect_left(node.keys, key)
        self._adapt()
        if i < len(node.keys) and node.keys[i] == key:
            return node.ptrs[i]
        return None

    # ------------------------------------------------------------ vector ops
    def get_many(self, keys: List[int]) -> List[Optional[int]]:
        """Vector lookup (aliased as ``lookup_many``): the sorted batch
        descends as key *segments* — every frontier level is one
        doorbell-batched read wave, so a batch of B lookups costs one RTT
        per tree level instead of B of them."""
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
        frontier: List[Tuple[int, int, int]] = [(0, len(rem), self._root)]
        depth = 0
        while frontier:
            reads = self.fe.read_many(
                self.h,
                [(addr, NODE_SIZE) for _, _, addr in frontier],
                cacheable=depth <= self.cache_level_thr,
            )
            nxt: List[Tuple[int, int, int]] = []
            for (b, e, _), raw in zip(frontier, reads):
                node = BNode.decode(raw)
                if node.kind == LEAF:
                    for idx in range(b, e):
                        j = bisect_left(node.keys, skeys[idx])
                        if j < len(node.keys) and node.keys[j] == skeys[idx]:
                            out[rem[idx]] = node.ptrs[j]
                else:
                    i = b
                    while i < e:
                        child = bisect_right(node.keys, skeys[i])
                        # extent of the segment routed to this child: keys
                        # strictly beyond the child's separator leave it
                        hi = (bisect_left(skeys, node.keys[child], i, e)
                              if child < len(node.keys) else e)
                        hi = max(hi, i + 1)
                        nxt.append((i, hi, node.ptrs[child]))
                        i = hi
            frontier = nxt
            depth += 1
        for _ in keys:
            self._adapt()
        return out

    # ------------------------------------------------------------ primitives
    def _insert_base(self, key: int, value: int) -> None:
        if not self._root:
            self._root = self._new(BNode(LEAF, [key], [value, 0]))
            self.write_root(self._root)
            return
        # descend, remembering the path
        path: List[Tuple[int, BNode, int]] = []
        addr, depth = self._root, 0
        node = self._read(addr, depth)
        while node.kind == INTERNAL:
            idx = bisect_right(node.keys, key)
            path.append((addr, node, idx))
            addr, depth = node.ptrs[idx], depth + 1
            node = self._read(addr, depth)
        i = bisect_left(node.keys, key)
        if i < len(node.keys) and node.keys[i] == key:
            node.ptrs[i] = value
            self._write(addr, node)
            return
        node.keys.insert(i, key)
        node.ptrs.insert(i, value)
        if len(node.keys) <= FANOUT:
            self._write(addr, node)
            return
        # leaf split
        mid = (FANOUT + 1) // 2
        right = BNode(LEAF, node.keys[mid:], node.ptrs[mid:-1] + [node.next_leaf])
        raddr = self._new(right)
        left = BNode(LEAF, node.keys[:mid], node.ptrs[:mid] + [raddr])
        self._write(addr, left)
        self._promote(path, right.keys[0], raddr)

    def _promote(self, path: List[Tuple[int, BNode, int]], key: int, child: int) -> None:
        while path:
            addr, node, idx = path.pop()
            node.keys.insert(idx, key)
            node.ptrs.insert(idx + 1, child)
            if len(node.keys) <= FANOUT:
                self._write(addr, node)
                return
            mid = FANOUT // 2
            upkey = node.keys[mid]
            right = BNode(INTERNAL, node.keys[mid + 1 :], node.ptrs[mid + 1 :])
            raddr = self._new(right)
            left = BNode(INTERNAL, node.keys[:mid], node.ptrs[: mid + 1])
            self._write(addr, left)
            key, child = upkey, raddr
        new_root = self._new(BNode(INTERNAL, [key], [self._root, child]))
        self._root = new_root
        self.write_root(new_root)

    def _materialize(self) -> None:
        """Vector insert (Algorithm 1 applied to the B+Tree): the sorted
        batch descends once as key *segments* — one doorbell-batched read
        wave per frontier level, each touched node read and visited ONCE for
        the whole batch instead of once per pair — then every leaf absorbs
        its whole segment at once, splits bubbling up level by level
        (deepest parents first, so a child's promotions land before its
        parent's own split).  All rewrites stage through one ``write_many``
        batch.  Leaf depth stays uniform, so ``range_items``'s level-order
        fan-out remains valid."""
        kvs, self._vecbuf = self._vecbuf, []
        if not kvs:
            return
        if not self._root:
            self._bulk_build(kvs)
            return
        fe, h = self.fe, self.h
        nodes: Dict[int, BNode] = {}           # addr -> decoded node
        parent: Dict[int, Optional[int]] = {self._root: None}
        level_of: Dict[int, int] = {self._root: 0}
        leaf_segs: List[Tuple[int, int, int]] = []   # (addr, begin, end)
        frontier: List[Tuple[int, int, int]] = [(0, len(kvs), self._root)]
        depth = 0
        while frontier:
            need = list(dict.fromkeys(
                addr for _, _, addr in frontier if addr not in nodes))
            raws = fe.read_many(h, [(a, NODE_SIZE) for a in need],
                                cacheable=depth <= self.cache_level_thr)
            for a, raw in zip(need, raws):
                nodes[a] = BNode.decode(raw)
            nxt: List[Tuple[int, int, int]] = []
            for b, e, addr in frontier:
                node = nodes[addr]
                if node.kind == LEAF:
                    leaf_segs.append((addr, b, e))
                    continue
                i = b
                while i < e:
                    child = bisect_right(node.keys, kvs[i][0])
                    hi = (bisect_left(kvs, (node.keys[child],), i, e)
                          if child < len(node.keys) else e)
                    hi = max(hi, i + 1)
                    caddr = node.ptrs[child]
                    parent[caddr] = addr
                    level_of[caddr] = depth + 1
                    nxt.append((i, hi, caddr))
                    i = hi
            frontier = nxt
            depth += 1
        dirty: Dict[int, BNode] = {}
        # parent addr (None = above the root) -> [(separator key, new child)]
        promos: Dict[Optional[int], List[Tuple[int, int]]] = {}
        for addr, b, e in leaf_segs:
            node = nodes[addr]
            merged = dict(zip(node.keys, node.ptrs[:-1]))
            merged.update(kvs[b:e])
            skeys = sorted(merged)
            if len(skeys) <= FANOUT:
                node.keys = skeys
                node.ptrs = [merged[k] for k in skeys] + [node.next_leaf]
                dirty[addr] = node
                continue
            next0 = node.next_leaf
            chunks = _balanced_chunks(skeys, FANOUT)
            addrs = [addr] + [fe.alloc(NODE_SIZE) for _ in chunks[1:]]
            for i, chunk in enumerate(chunks):
                nxt_leaf = addrs[i + 1] if i + 1 < len(addrs) else next0
                piece = BNode(LEAF, chunk, [merged[k] for k in chunk] + [nxt_leaf])
                dirty[addrs[i]] = piece
                nodes[addrs[i]] = piece
            promos.setdefault(parent.get(addr), []).extend(
                (chunk[0], addrs[i]) for i, chunk in enumerate(chunks) if i)
        # bubble splits up, deepest parents first
        while True:
            real = [a for a in promos if a is not None]
            if not real:
                break
            deepest = max(level_of[a] for a in real)
            for a in [a for a in real if level_of[a] == deepest]:
                lst = promos.pop(a)
                node = nodes[a]
                for key, child in sorted(lst):
                    idx = bisect_right(node.keys, key)
                    node.keys.insert(idx, key)
                    node.ptrs.insert(idx + 1, child)
                if len(node.keys) <= FANOUT:
                    dirty[a] = node
                    continue
                pieces, seps = self._split_internal(node)
                addrs = [a] + [fe.alloc(NODE_SIZE) for _ in pieces[1:]]
                for paddr, piece in zip(addrs, pieces):
                    dirty[paddr] = piece
                    nodes[paddr] = piece
                promos.setdefault(parent.get(a), []).extend(
                    (k, addrs[i + 1]) for i, k in enumerate(seps))
        root_promos = promos.pop(None, None)
        if root_promos:
            root_promos.sort()
            node = BNode(INTERNAL,
                         [k for k, _ in root_promos],
                         [self._root] + [c for _, c in root_promos])
            while len(node.keys) > FANOUT:
                pieces, seps = self._split_internal(node)
                addrs = [fe.alloc(NODE_SIZE) for _ in pieces]
                for paddr, piece in zip(addrs, pieces):
                    dirty[paddr] = piece
                node = BNode(INTERNAL, seps, addrs)
            raddr = fe.alloc(NODE_SIZE)
            dirty[raddr] = node
            self._root = raddr
        fe.write_many(h, [(a, n.encode()) for a, n in dirty.items()])
        if root_promos:
            self.write_root(self._root)

    @staticmethod
    def _split_internal(node: BNode) -> Tuple[List[BNode], List[int]]:
        """Split an overfull internal node into balanced pieces; returns
        (pieces, promoted separator keys) — piece i+1 follows separator i."""
        ptr_chunks = _balanced_chunks(node.ptrs, FANOUT + 1)
        pieces: List[BNode] = []
        seps: List[int] = []
        off = 0
        for i, pc in enumerate(ptr_chunks):
            pieces.append(BNode(INTERNAL, node.keys[off:off + len(pc) - 1], pc))
            if i + 1 < len(ptr_chunks):
                seps.append(node.keys[off + len(pc) - 1])
            off += len(pc)
        return pieces, seps

    def _bulk_build(self, kvs: List[Tuple[int, int]]) -> None:
        """Bottom-up bulk load of an empty tree: balanced chained leaves,
        then internal levels until a single root (separator = first key of
        the right child, matching the descent's ``bisect_right`` routing)."""
        fe = self.fe
        writes: List[Tuple[int, bytes]] = []
        chunks = _balanced_chunks(kvs, FANOUT)
        addrs = [fe.alloc(NODE_SIZE) for _ in chunks]
        firsts = [chunk[0][0] for chunk in chunks]
        for i, chunk in enumerate(chunks):
            nxt = addrs[i + 1] if i + 1 < len(addrs) else 0
            writes.append((addrs[i], BNode(
                LEAF, [k for k, _ in chunk], [v for _, v in chunk] + [nxt]
            ).encode()))
        while len(addrs) > 1:
            a_chunks = _balanced_chunks(addrs, FANOUT + 1)
            f_chunks = _balanced_chunks(firsts, FANOUT + 1)
            addrs, firsts = [], []
            for ca, cf in zip(a_chunks, f_chunks):
                a = fe.alloc(NODE_SIZE)
                addrs.append(a)
                firsts.append(cf[0])
                writes.append((a, BNode(INTERNAL, cf[1:], ca).encode()))
        fe.write_many(self.h, writes)
        self._root = addrs[0]
        self.write_root(self._root)

    # ---------------------------------------------------------------- replay
    def _replay_insert(self, key: int, value: int) -> None:
        self._insert_base(key, value)

    # ------------------------------------------------------------- traversal
    def items(self) -> List[Tuple[int, int]]:
        return self.range_items(-(1 << 63), (1 << 63) - 1)

    def range_items(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """All (key, value) with lo <= key <= hi.  The unmaterialized
        vector-insert overlay is merged in, so results match a full scan
        restricted to the range.

        With batching on, the scan fans out down the subtree covering
        [lo, hi]: each level's covered children are read with one doorbell
        wave (chunked at WAVE), so the leaf level — the bulk of the reads,
        and previously a strictly serial ``next_leaf`` pointer chase — costs
        one RTT instead of one per leaf."""
        out: List[Tuple[int, int]] = []
        if self._root and self.fe.cfg.use_batch:
            level: List[int] = [self._root]
            depth = 0
            while level:
                nodes: List[BNode] = []
                for c in range(0, len(level), WAVE):
                    raws = self.fe.read_many(
                        self.h,
                        [(a, NODE_SIZE) for a in level[c : c + WAVE]],
                        cacheable=depth <= self.cache_level_thr,
                    )
                    nodes.extend(BNode.decode(r) for r in raws)
                if nodes[0].kind == LEAF:
                    for node in nodes:
                        for k, v in zip(node.keys, node.ptrs[:-1]):
                            if lo <= k <= hi:
                                out.append((k, v))
                    break
                nxt: List[int] = []
                last = len(nodes) - 1
                for m, node in enumerate(nodes):
                    jlo = bisect_right(node.keys, lo) if m == 0 else 0
                    jhi = (bisect_right(node.keys, hi)
                           if m == last else len(node.ptrs) - 1)
                    nxt.extend(node.ptrs[jlo : jhi + 1])
                level = nxt
                depth += 1
        elif self._root:
            addr, depth = self._root, 0
            node = self._read(addr, depth)
            while node.kind == INTERNAL:
                idx = bisect_right(node.keys, lo)
                addr, depth = node.ptrs[idx], depth + 1
                node = self._read(addr, depth)
            while True:
                for k, v in zip(node.keys, node.ptrs[:-1]):
                    if k > hi:
                        break
                    if k >= lo:
                        out.append((k, v))
                if not node.next_leaf or (node.keys and node.keys[-1] > hi):
                    break
                node = self._read(node.next_leaf, depth)
        merged = dict(out)
        for k, v in self._vecbuf:
            if lo <= k <= hi:
                merged[k] = v
        return sorted(merged.items())

    # ---------------------------------------------------------- space reclaim
    def _free_storage(self) -> None:
        """Free every node level by level (shard migration reclaim).  Nodes
        carved by an earlier front-end incarnation are leaked rather than
        guessed at (see free_chunk_if_known)."""
        level = [self._root] if self._root else []
        while level:
            raws = self.fe.read_many(self.h, [(a, NODE_SIZE) for a in level])
            nxt: List[int] = []
            for addr, raw in zip(level, raws):
                node = BNode.decode(raw)
                if node.kind == INTERNAL:
                    nxt.extend(node.ptrs)
                self.fe.allocator.free_chunk_if_known(addr)
            level = nxt
        self._root = 0
