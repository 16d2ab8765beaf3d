"""Multi-version remote BST (paper §9.1, Fig. 5).

Writers never mutate a *published* node: the affected root-to-leaf path is
copied (path copying), the new version is made durable, and then the root
pointer is swapped with one remote atomic CAS — readers always traverse a
consistent, immutable version without any lock.

Batch optimization: nodes created since the last publish ("epoch nodes")
are not yet visible to any reader, so they may be updated in place; a batch
of inserts therefore copies each shared path node at most once, which is
exactly why Fig. 7 shows the largest batch gains on the MV structures.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from ..frontend import FrontEnd
from .base import RemoteStructure
from .bst import NODE, NODE_SIZE

OP_INSERT = 1


class RemoteMVBST(RemoteStructure):
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
            k, v, l, r = NODE.unpack(self.fe.read(self.h, addr, NODE_SIZE))
            if key == k:
                return v
            addr = l if key < k else r
        return None

    def snapshot_root(self) -> int:
        """Reader entry point: the latest *published* version."""
        return self.fe.atomic_read(self.root_addr)

    def refresh_root(self) -> None:
        """Re-sync to the currently published root: another front-end may
        have advanced it (writers serialized by the shard writer mutex), in
        which case our remembered ``_published`` would make the next publish
        CAS fail.  Unpublished local working state is abandoned — callers
        resync only at window boundaries, when the op log re-covers it."""
        self._published = self.fe.atomic_read(self.root_addr)
        self._working = self._published
        self._epoch.clear()

    # ------------------------------------------------------------ primitives
    def _new_node(self, key: int, value: int, left: int = 0, right: int = 0) -> int:
        addr = self.fe.alloc(NODE_SIZE)
        self.fe.write(self.h, addr, NODE.pack(key, value, left, right))
        self._epoch.add(addr)
        return addr

    def _insert_cow(self, key: int, value: int) -> None:
        if not self._working:
            self._working = self._new_node(key, value)
            return
        path: List[Tuple[int, Tuple[int, int, int, int]]] = []
        addr = self._working
        while addr:
            node = NODE.unpack(self.fe.read(self.h, addr, NODE_SIZE))
            path.append((addr, node))
            k = node[0]
            if key == k:
                break
            addr = node[2] if key < k else node[3]
        # replacement for the deepest touched node
        laddr, (k, v, l, r) = path[-1]
        if key == k:
            repl = (k, value, l, r)
        elif key < k:
            repl = (k, v, self._new_node(key, value), r)
        else:
            repl = (k, v, l, self._new_node(key, value))
        cur = self._apply_cow(laddr, repl)
        if cur == laddr:
            return  # in-place update: ancestors already point here
        # propagate the copy upward until an epoch (unpublished) node absorbs it
        for paddr, (pk, pv, pl, pr) in reversed(path[:-1]):
            new = (pk, pv, cur, pr) if key < pk else (pk, pv, pl, cur)
            cur = self._apply_cow(paddr, new)
            if cur == paddr:
                return  # ancestor updated in place: links above are already right
        self._working = cur

    def _apply_cow(self, addr: int, fields: Tuple[int, int, int, int]) -> int:
        """Update in place if `addr` is unpublished, else path-copy."""
        if addr in self._epoch:
            self.fe.write(self.h, addr, NODE.pack(*fields))
            return addr
        return self._new_node(*fields)

    def _publish(self) -> None:
        """Root swap: one remote atomic CAS after the version is durable."""
        if self._working == self._published:
            return
        ok = self.fe.atomic_cas(self.root_addr, self._published, self._working)
        if not ok:  # single-writer invariant violated
            raise RuntimeError("MV root CAS failed: concurrent writer?")
        self._published = self._working
        self._epoch.clear()

    # -------------------------------------------------------------- bulk load
    def build_from_sorted(self, kvs: List[Tuple[int, int]]) -> None:
        """Balanced bulk build (preload): one write per node, one publish."""

        def build(lo: int, hi: int) -> int:
            if lo >= hi:
                return 0
            mid = (lo + hi) // 2
            l = build(lo, mid)
            r = build(mid + 1, hi)
            return self._new_node(kvs[mid][0], kvs[mid][1], l, r)

        self._working = build(0, len(kvs))
        self.fe.flush_memlogs(self.h, sync=True)

    # ---------------------------------------------------------------- replay
    def _replay_insert(self, key: int, value: int) -> None:
        self._insert_cow(key, value)
