"""Two-tier slab allocator (paper §5.4 / Table 2).

Tier 1 (back-end): fixed-size blocks ("slabs") handed out by the blade's
persistent-bitmap allocator — one RPC round per slab.

Tier 2 (front-end): each slab is carved into power-of-two chunks; slabs are
kept on full / partial / empty lists per size class and chunks are served
best-fit (smallest class that fits) with zero network traffic.  Empty slabs
beyond ``reclaim_threshold`` are returned to the blade periodically.
Requests larger than a slab fall through to the back-end directly.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List

if TYPE_CHECKING:  # pragma: no cover
    from .frontend import FrontEnd

MIN_CHUNK = 16


class _Slab:
    __slots__ = ("addr", "chunk", "free", "total")

    def __init__(self, addr: int, slab_bytes: int, chunk: int):
        self.addr = addr
        self.chunk = chunk
        self.total = slab_bytes // chunk
        self.free: List[int] = [addr + i * chunk for i in range(self.total - 1, -1, -1)]


class FrontEndAllocator:
    def __init__(self, fe: "FrontEnd", reclaim_threshold: int = 4):
        self.fe = fe
        self.slab_bytes = fe.backend.block_size
        self.reclaim_threshold = reclaim_threshold
        # per size class: partial slabs (have free chunks) and empty slabs
        self.partial: Dict[int, List[_Slab]] = {}
        self.empty: Dict[int, List[_Slab]] = {}
        self.chunk_of: Dict[int, _Slab] = {}  # chunk addr -> slab
        self.allocs = 0
        self.frees = 0
        self.slab_fetches = 0
        self.foreign_leaks = 0  # unknown sub-slab chunks left unreclaimed

    # ------------------------------------------------------------------- api
    def alloc(self, size: int) -> int:
        self.allocs += 1
        if size > self.slab_bytes:
            # large allocation: go straight to the blade (contiguous blocks)
            nblocks = -(-size // self.slab_bytes)
            return self.fe._backend_alloc(nblocks)
        cls = self._size_class(size)
        slabs = self.partial.setdefault(cls, [])
        if not slabs:
            reuse = self.empty.get(cls)
            if reuse:
                slabs.append(reuse.pop())
            else:
                addr = self.fe._backend_alloc(1)
                self.slab_fetches += 1
                slab = _Slab(addr, self.slab_bytes, cls)
                for i in range(slab.total):
                    self.chunk_of[addr + i * cls] = slab
                slabs.append(slab)
        slab = slabs[-1]
        chunk = slab.free.pop()
        if not slab.free:
            slabs.pop()  # now full; tracked only via chunk_of
        self.fe._charge_local_alloc()
        return chunk

    def free(self, addr: int, size: int = 0) -> None:
        self.frees += 1
        slab = self.chunk_of.get(addr)
        if slab is None:
            if size <= self.slab_bytes:
                # a sub-slab chunk this allocator never carved: some other
                # (pre-rebind / pre-failover) front-end's slab owns it, and
                # that slab may hold live chunks of unrelated structures.
                # Freeing the containing block would hand those bytes back
                # to the blade for reallocation — the double-alloc corrupts
                # whoever wrote there first.  Leak the chunk instead; the
                # slab is reclaimed only when a bulk destroy frees its
                # whole block explicitly.
                self.foreign_leaks += 1
                self.fe._charge_local_alloc()
                return
            nblocks = -(-size // self.slab_bytes)
            self.fe._backend_free(addr, nblocks)
            return
        was_full = not slab.free
        slab.free.append(addr)
        cls = slab.chunk
        if was_full:
            self.partial.setdefault(cls, []).append(slab)
        if len(slab.free) == slab.total:
            # slab fully free: move partial -> empty, maybe reclaim
            part = self.partial.get(cls, [])
            if slab in part:
                part.remove(slab)
            empties = self.empty.setdefault(cls, [])
            empties.append(slab)
            if len(empties) > self.reclaim_threshold:
                victim = empties.pop(0)
                for i in range(victim.total):
                    self.chunk_of.pop(victim.addr + i * cls, None)
                self.fe._backend_free(victim.addr, 1)
        self.fe._charge_local_alloc()

    def free_chunk_if_known(self, addr: int) -> bool:
        """Free a slab chunk only if THIS allocator carved it (bulk reclaim
        of structures whose nodes may predate this front-end).  An unknown
        chunk is leaked rather than guessed at: falling through to a block
        free would release the containing slab, which can hold other
        structures' live chunks."""
        if addr in self.chunk_of:
            self.free(addr)
            return True
        return False

    def release_empty(self) -> int:
        """Return every fully-free slab to the blade immediately (space
        reclaim after bulk frees, e.g. destroying a migrated shard's source
        copy).  Returns the number of slabs released."""
        released = 0
        for cls, empties in self.empty.items():
            while empties:
                victim = empties.pop()
                for i in range(victim.total):
                    self.chunk_of.pop(victim.addr + i * cls, None)
                self.fe._backend_free(victim.addr, 1)
                released += 1
        return released

    # ------------------------------------------------------------------ util
    @staticmethod
    def _size_class(size: int) -> int:
        c = MIN_CHUNK
        while c < size:
            c <<= 1
        return c
