"""Multi-version remote B+Tree (paper §9.1) — path-copying over B+ nodes.

Same protocol as the MV-BST: copy-on-write for published nodes, in-place
for nodes created since the last publish, root swap via remote atomic CAS
after the memory logs are durable.  Splits simply mint more epoch nodes.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import List, Optional, Tuple

from ..frontend import FrontEnd
from .base import RemoteStructure
from .bptree import FANOUT, INTERNAL, LEAF, NODE_SIZE, BNode

OP_INSERT = 1


class RemoteMVBPTree(RemoteStructure):
    REPLAY = {OP_INSERT: "_replay_insert"}

    def __init__(self, fe: FrontEnd, name: str, create: bool = True):
        super().__init__(fe, name)
        if create:
            fe.backend.set_name(f"{name}.root", 0)
            self._published = 0
        else:
            self._published = fe.backend.get_name(f"{name}.root")
        self._working = self._published
        self._epoch: set[int] = set()
        self.h.post_flush = self._publish

    # ------------------------------------------------------------------- ops
    def insert(self, key: int, value: int) -> None:
        self.fe.op_begin(self.h, OP_INSERT, self.encode_args(key, value))
        self._insert_cow(key, value)
        self.fe.op_commit(self.h)

    def find(self, key: int):
        return self.find_from(self._working, key)

    def find_from(self, root: int, key: int):
        addr = root
        while addr:
            node = self._read(addr)
            if node.kind == LEAF:
                i = bisect_left(node.keys, key)
                if i < len(node.keys) and node.keys[i] == key:
                    return node.ptrs[i]
                return None
            addr = node.ptrs[bisect_right(node.keys, key)]
        return None

    def snapshot_root(self) -> int:
        return self.fe.atomic_read(self.root_addr)

    def refresh_root(self) -> None:
        """Re-sync to the currently published root: another front-end may
        have advanced it (writers serialized by the shard writer mutex), in
        which case our remembered ``_published`` would make the next publish
        CAS fail.  Any unpublished local working state is abandoned — the
        caller resyncs only at window boundaries, when the op log already
        re-covers it."""
        self._published = self.fe.atomic_read(self.root_addr)
        self._working = self._published
        self._epoch.clear()

    # ---------------------------------------------------------------- scans
    def range_items(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """All (key, value) with lo <= key <= hi, sorted.  Descends from the
        working root instead of chasing the leaf chain: copy-on-write splits
        leave old leaves' next pointers aimed at pre-copy siblings, so the
        chain can cross into a stale snapshot — the root-down walk cannot."""
        out: List[Tuple[int, int]] = []
        self._collect(self._working, lo, hi, out)
        return out

    def items(self) -> List[Tuple[int, int]]:
        return self.range_items(-(1 << 63), (1 << 63) - 1)

    def _collect(self, addr: int, lo: int, hi: int,
                 out: List[Tuple[int, int]]) -> None:
        if not addr:
            return
        node = self._read(addr)
        if node.kind == LEAF:
            for i, k in enumerate(node.keys):
                if lo <= k <= hi:
                    out.append((k, node.ptrs[i]))
            return
        i0 = bisect_left(node.keys, lo)
        i1 = bisect_right(node.keys, hi)
        for p in node.ptrs[i0:i1 + 1]:
            self._collect(p, lo, hi, out)

    # ------------------------------------------------------------ primitives
    def _read(self, addr: int) -> BNode:
        return BNode.decode(self.fe.read(self.h, addr, NODE_SIZE))

    def _new(self, node: BNode) -> int:
        addr = self.fe.alloc(NODE_SIZE)
        self.fe.write(self.h, addr, node.encode())
        self._epoch.add(addr)
        return addr

    def _put(self, addr: int, node: BNode) -> int:
        """In place if unpublished, else copy-on-write."""
        if addr in self._epoch:
            self.fe.write(self.h, addr, node.encode())
            return addr
        return self._new(node)

    def _insert_cow(self, key: int, value: int) -> None:
        if not self._working:
            self._working = self._new(BNode(LEAF, [key], [value, 0]))
            return
        new_root, split = self._descend(self._working, key, value)
        if split is not None:
            sep, raddr = split
            new_root = self._new(BNode(INTERNAL, [sep], [new_root, raddr]))
        self._working = new_root

    def _descend(self, addr: int, key: int, value: int) -> Tuple[int, Optional[Tuple[int, int]]]:
        """Returns (replacement_addr, optional (sep_key, right_sibling))."""
        node = self._read(addr)
        if node.kind == LEAF:
            keys, ptrs = list(node.keys), list(node.ptrs)
            i = bisect_left(keys, key)
            if i < len(keys) and keys[i] == key:
                ptrs[i] = value
                return self._put(addr, BNode(LEAF, keys, ptrs)), None
            keys.insert(i, key)
            ptrs.insert(i, value)
            if len(keys) <= FANOUT:
                return self._put(addr, BNode(LEAF, keys, ptrs)), None
            mid = (FANOUT + 1) // 2
            raddr = self._new(BNode(LEAF, keys[mid:], ptrs[mid:-1] + [ptrs[-1]]))
            laddr = self._put(addr, BNode(LEAF, keys[:mid], ptrs[:mid] + [raddr]))
            return laddr, (keys[mid], raddr)
        idx = bisect_right(node.keys, key)
        child_new, split = self._descend(node.ptrs[idx], key, value)
        keys, ptrs = list(node.keys), list(node.ptrs)
        ptrs[idx] = child_new
        if split is None:
            if child_new == node.ptrs[idx]:
                return addr, None  # nothing changed below
            return self._put(addr, BNode(INTERNAL, keys, ptrs)), None
        sep, raddr = split
        keys.insert(idx, sep)
        ptrs.insert(idx + 1, raddr)
        if len(keys) <= FANOUT:
            return self._put(addr, BNode(INTERNAL, keys, ptrs)), None
        mid = FANOUT // 2
        upkey = keys[mid]
        new_raddr = self._new(BNode(INTERNAL, keys[mid + 1 :], ptrs[mid + 1 :]))
        laddr = self._put(addr, BNode(INTERNAL, keys[:mid], ptrs[: mid + 1]))
        return laddr, (upkey, new_raddr)

    def _publish(self) -> None:
        if self._working == self._published:
            return
        ok = self.fe.atomic_cas(self.root_addr, self._published, self._working)
        if not ok:
            raise RuntimeError("MV root CAS failed: concurrent writer?")
        self._published = self._working
        self._epoch.clear()

    # -------------------------------------------------------------- bulk load
    def build_from_sorted(self, kvs: List[Tuple[int, int]]) -> None:
        if not kvs:
            return
        half = FANOUT // 2 + 1
        leaves: List[Tuple[int, int]] = []  # (first_key, addr)
        chunks = [kvs[i : i + half] for i in range(0, len(kvs), half)]
        addrs = [self.fe.alloc(NODE_SIZE) for _ in chunks]
        for i, chunk in enumerate(chunks):
            nxt = addrs[i + 1] if i + 1 < len(addrs) else 0
            node = BNode(LEAF, [k for k, _ in chunk], [v for _, v in chunk] + [nxt])
            self.fe.write(self.h, addrs[i], node.encode())
            self._epoch.add(addrs[i])
            leaves.append((chunk[0][0], addrs[i]))
        level = leaves
        while len(level) > 1:
            nxt_level: List[Tuple[int, int]] = []
            for i in range(0, len(level), half):
                grp = level[i : i + half]
                node = BNode(INTERNAL, [k for k, _ in grp[1:]], [a for _, a in grp])
                nxt_level.append((grp[0][0], self._new(node)))
            level = nxt_level
        self._working = level[0][1]
        self.fe.flush_memlogs(self.h, sync=True)

    # ---------------------------------------------------------------- replay
    def _replay_insert(self, key: int, value: int) -> None:
        self._insert_cow(key, value)
