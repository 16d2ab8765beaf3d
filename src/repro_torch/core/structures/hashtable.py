"""Remote persistent chained hash table.

Bucket array is one contiguous NVM region (allocated at creation, address in
the naming region); chains are 24-byte nodes.  Per-op batching does not
apply (an O(1) op has nothing to overlap with itself — Table 3 leaves those
cells empty) but *vector ops* do: a batch of independent keys walks all its
chains in doorbell-batched waves (`_lookup`), so `get_many`/`put_many` pay
one RTT per chain *level* instead of one per node — the batching win the
paper reserves for pointer structures applies here across keys.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..frontend import FrontEnd
from .base import RemoteStructure, mix64, mix64_np

OP_PUT = 1
OP_DEL = 2

NODE = struct.Struct("<qqQ")  # key, value, next
NODE_SIZE = NODE.size

#: columnar view of a wave of chain nodes (one np.frombuffer over the
#: concatenated node bytes instead of one struct.unpack per node)
NODE_DT = np.dtype([("k", "<i8"), ("v", "<i8"), ("n", "<u8")])

_PTR = struct.Struct("<Q")

WAVE = 2048  # max independent reads rung with one doorbell


class RemoteHashTable(RemoteStructure):
    REPLAY = {OP_PUT: "_replay_put", OP_DEL: "_replay_del"}

    def __init__(self, fe: FrontEnd, name: str, n_buckets: int = 1 << 14, create: bool = True):
        super().__init__(fe, name)
        be = fe.backend
        if create:
            self.n_buckets = n_buckets
            self.base = fe.alloc(n_buckets * 8)
            be.set_name(f"{name}.base", self.base)
            be.set_name(f"{name}.nbuckets", n_buckets)
        else:
            self.base = be.get_name(f"{name}.base")
            self.n_buckets = be.get_name(f"{name}.nbuckets")

    def _bucket_addr(self, key: int) -> int:
        return self.base + (mix64(key & 0xFFFFFFFFFFFFFFFF) % self.n_buckets) * 8

    def _bucket_addrs(self, keys: List[int]) -> List[int]:
        """Vectorized ``_bucket_addr`` for a whole batch (one numpy pass)."""
        ks = np.array([k & 0xFFFFFFFFFFFFFFFF for k in keys], dtype=np.uint64)
        addrs = self.base + (mix64_np(ks) % np.uint64(self.n_buckets)) * np.uint64(8)
        return addrs.tolist()

    def _read_ptr(self, addr: int) -> int:
        return struct.unpack("<Q", self.fe.read(self.h, addr, 8))[0]

    # ------------------------------------------------------------------- ops
    def put(self, key: int, value: int) -> None:
        self.fe.op_begin(self.h, OP_PUT, self.encode_args(key, value))
        self._put_base(key, value)
        self.fe.op_commit(self.h)

    def get(self, key: int):
        # tight serial pointer chase: the batch machinery of _lookup would
        # charge identically but cost real wall-clock on the hottest path
        cur = self._read_ptr(self._bucket_addr(key))
        while cur:
            k, v, nxt = NODE.unpack(self.fe.read(self.h, cur, NODE_SIZE))
            if k == key:
                return v
            cur = nxt
        return None

    # ------------------------------------------------------------ vector ops
    def _lookup(self, keys: List[int]) -> List[Optional[int]]:
        """Chain walk for a batch of independent keys: the bucket heads go
        out as one doorbell wave, then each chain level is one more wave
        (``read_many`` deduplicates shared buckets/nodes).  A single key
        degrades to the exact serial pointer chase."""
        out: List[Optional[int]] = [None] * len(keys)
        key_baddrs = self._bucket_addrs(keys)
        baddrs = sorted(set(key_baddrs))
        raws = self.fe.read_many(self.h, [(a, 8) for a in baddrs])
        ptrs = np.frombuffer(b"".join(raws), dtype="<u8").tolist()
        heads = dict(zip(baddrs, ptrs))
        cursors: Dict[int, int] = {}
        for i, a in enumerate(key_baddrs):
            ptr = heads[a]
            if ptr:
                cursors[i] = ptr
        while cursors:
            addrs = sorted(set(cursors.values()))
            raws = self.fe.read_many(self.h, [(a, NODE_SIZE) for a in addrs])
            rec = np.frombuffer(b"".join(raws), dtype=NODE_DT)
            nodes = dict(zip(addrs, zip(rec["k"].tolist(), rec["v"].tolist(),
                                        rec["n"].tolist())))
            nxt_cursors: Dict[int, int] = {}
            for i, addr in cursors.items():
                k, v, nxt = nodes[addr]
                if k == keys[i]:
                    out[i] = v
                elif nxt:
                    nxt_cursors[i] = nxt
            cursors = nxt_cursors
        return out

    def get_many(self, keys: List[int]) -> List[Optional[int]]:
        with self.op_window("get_many", len(keys)):
            if not self.fe.cfg.use_batch or len(keys) <= 1:
                return [self.get(k) for k in keys]
            return self._lookup(keys)

    def _stage_chains(self, keys: List[int], key_baddrs: List[int]):
        """Warm the cache with every bucket head and chain node the batch's
        apply phase will read — stopping each chain as soon as all of its
        interested keys are resolved (so no more bytes are prefetched than
        the serial loop would have read) — and materialize the fetched
        nodes as a local decoded view (addr -> (key, value, next), one
        ``np.frombuffer`` per wave) for the vectorized apply pass."""
        fe, h = self.fe, self.h
        pending: Dict[int, set] = {}
        for k, a in zip(keys, key_baddrs):
            pending.setdefault(a, set()).add(k)
        baddrs = sorted(pending)
        raws = fe.prefetch_many(h, [(a, 8) for a in baddrs])
        ptrs = np.frombuffer(b"".join(raws), dtype="<u8").tolist()
        heads: Dict[int, int] = dict(zip(baddrs, ptrs))
        cursors: Dict[int, int] = {a: p for a, p in heads.items() if p}
        view: Dict[int, Tuple[int, int, int]] = {}
        while cursors:
            addrs = sorted(set(cursors.values()))
            raws = fe.prefetch_many(h, [(a, NODE_SIZE) for a in addrs])
            rec = np.frombuffer(b"".join(raws), dtype=NODE_DT)
            view.update(zip(addrs, zip(rec["k"].tolist(), rec["v"].tolist(),
                                       rec["n"].tolist())))
            nxt: Dict[int, int] = {}
            for bucket, cur in cursors.items():
                want = pending[bucket]
                while cur and want:
                    node = view.get(cur)
                    if node is None:
                        nxt[bucket] = cur  # next wave fetches it
                        break
                    want.discard(node[0])
                    cur = node[2]
            cursors = nxt
        return heads, view

    def _apply_puts(self, pairs, key_baddrs, heads, view) -> None:
        """Apply a put batch against the staged local view: the chain walk
        reads decoded columns instead of calling ``fe.read`` per node, while
        every simulated charge, cache/recency mutation, stat, op-log entry,
        and staged write byte matches the serial ``_put_base`` loop exactly
        (the arena stays byte-identical; see tests/test_vectorized_apply)."""
        fe, h = self.fe, self.h
        cfg, cost, st = fe.cfg, fe.cost, fe.stats
        cache = fe.cache
        cache_get = cache.get
        upd = cache.update_or_put
        wbuf = h.wbuf
        clock = fe.clock
        cpu_node = cfg.cpu_node_ns
        dram = cost.dram_ns
        pack = NODE.pack
        pack_ptr = _PTR.pack
        enc = self.encode_args
        op_begin, op_commit = fe.op_begin, fe.op_commit
        # deferred clock charges: pure adds, flushed before any call that
        # posts a transfer (alloc RPC, cache-miss round, op cadence flush)
        acc = 0.0
        busy = 0.0

        def charge_read(addr: int, size: int) -> None:
            # the charge-side mirror of fe.read: write buffer -> cache ->
            # remote round; the *value* comes from the local view
            nonlocal acc, busy
            busy += cpu_node
            if addr in wbuf:
                acc += cpu_node
                return
            page = cache_get(addr)
            if page is not None and len(page) >= size:
                st.cache_hits += 1
                acc += cpu_node + dram
                return
            st.cache_misses += 1
            clock.advance(acc + cpu_node)
            fe.busy_ns += busy
            acc = 0.0
            busy = 0.0
            tgt = fe._read_target(h)
            data = tgt.fetch(addr, size)
            st.rdma_reads += 1
            st.bytes_read += size
            if tgt.is_replica:
                st.replica_reads += 1
            fe._round(size, link=tgt.link)
            if tgt.cache_safe:
                cache.put(addr, data)

        for i, (key, value) in enumerate(pairs):
            op_begin(h, OP_PUT, enc(key, value))
            baddr = key_baddrs[i]
            charge_read(baddr, 8)
            head = heads[baddr]
            cur = head
            found = False
            while cur:
                charge_read(cur, NODE_SIZE)
                node = view.get(cur)
                if node is None:
                    # defensive: resolve from the live overlay (charges for
                    # this visit are already accounted above)
                    raw = wbuf.get(cur) or cache.peek(cur)
                    if raw is None:
                        raw = fe.backend.read(cur, NODE_SIZE)
                    node = NODE.unpack(bytes(raw[:NODE_SIZE]))
                    view[cur] = node
                nk, _, nn = node
                if nk == key:
                    data = pack(key, value, nn)
                    if cur in wbuf:
                        st.memlogs_coalesced += 1
                    wbuf[cur] = data
                    upd(cur, data)
                    acc += dram
                    view[cur] = (key, value, nn)
                    found = True
                    break
                cur = nn
            if not found:
                clock.advance(acc)
                fe.busy_ns += busy
                acc = 0.0
                busy = 0.0
                addr = fe.alloc(NODE_SIZE)
                data = pack(key, value, head)
                if addr in wbuf:
                    st.memlogs_coalesced += 1
                wbuf[addr] = data
                upd(addr, data)
                hb = pack_ptr(addr)
                if baddr in wbuf:
                    st.memlogs_coalesced += 1
                wbuf[baddr] = hb
                upd(baddr, hb)
                acc += dram + dram
                view[addr] = (key, value, head)
                heads[baddr] = addr
            if acc:
                clock.advance(acc)
                fe.busy_ns += busy
                acc = 0.0
                busy = 0.0
            op_commit(h)

    def put_many(self, pairs: List[Tuple[int, int]]) -> None:
        """Vector put: one doorbell wave per chain level stages the touched
        chains as a local decoded view, then the apply pass walks/updates
        that view in one pass — the structure state (and the whole back-end
        arena) is byte-identical to the serial loop while the network
        charges are batched.  The write wave batches the apply phase's
        posted writes too: node-slab refill RPCs and op-log group commits
        post into shared doorbells with one completion fence."""
        cfg = self.fe.cfg
        with self.op_window("put_many", len(pairs)):
            if not (cfg.use_batch and cfg.use_cache) or len(pairs) <= 1:
                for k, v in pairs:
                    self.put(k, v)
                return
            with self.fe.write_wave(linger=True):
                keys = [k for k, _ in pairs]
                key_baddrs = self._bucket_addrs(keys)
                heads, view = self._stage_chains(keys, key_baddrs)
                self._apply_puts(pairs, key_baddrs, heads, view)

    def delete(self, key: int) -> bool:
        self.fe.op_begin(self.h, OP_DEL, self.encode_args(key))
        ok = self._del_base(key)
        self.fe.op_commit(self.h)
        return ok

    # ------------------------------------------------------------ primitives
    def _put_base(self, key: int, value: int) -> None:
        baddr = self._bucket_addr(key)
        head = self._read_ptr(baddr)
        cur = head
        while cur:
            k, _, nxt = NODE.unpack(self.fe.read(self.h, cur, NODE_SIZE))
            if k == key:
                self.fe.write(self.h, cur, NODE.pack(key, value, nxt))
                return
            cur = nxt
        addr = self.fe.alloc(NODE_SIZE)
        self.fe.write(self.h, addr, NODE.pack(key, value, head))
        self.fe.write(self.h, baddr, struct.pack("<Q", addr))

    def _del_base(self, key: int) -> bool:
        baddr = self._bucket_addr(key)
        prev = None
        cur = self._read_ptr(baddr)
        while cur:
            k, v, nxt = NODE.unpack(self.fe.read(self.h, cur, NODE_SIZE))
            if k == key:
                if prev is None:
                    self.fe.write(self.h, baddr, struct.pack("<Q", nxt))
                else:
                    pk, pv, _ = NODE.unpack(self.fe.read(self.h, prev, NODE_SIZE))
                    self.fe.write(self.h, prev, NODE.pack(pk, pv, nxt))
                self.fe.free(cur, NODE_SIZE)
                return True
            prev, cur = cur, nxt
        return False

    # ------------------------------------------------------------- traversal
    def items(self):
        """Full scan: every (key, value) pair, bucket by bucket.  Used by the
        cluster rebalancer to snapshot a shard for migration.  With batching
        on, the bucket array and each chain level go out as doorbell waves
        (chunked at WAVE reads) instead of one round per pointer."""
        if not self.fe.cfg.use_batch:
            out = []
            for b in range(self.n_buckets):
                cur = self._read_ptr(self.base + b * 8)
                while cur:
                    k, v, nxt = NODE.unpack(self.fe.read(self.h, cur, NODE_SIZE))
                    out.append((k, v))
                    cur = nxt
            return out
        chains: Dict[int, List[Tuple[int, int]]] = {}
        cursors: Dict[int, int] = {}
        for lo in range(0, self.n_buckets, WAVE):
            baddrs = [self.base + b * 8
                      for b in range(lo, min(lo + WAVE, self.n_buckets))]
            for b, raw in zip(range(lo, lo + len(baddrs)),
                              self.fe.read_many(self.h, [(a, 8) for a in baddrs])):
                (ptr,) = struct.unpack("<Q", raw)
                if ptr:
                    cursors[b] = ptr
                    chains[b] = []
        while cursors:
            active = sorted(cursors)
            nxt_cursors: Dict[int, int] = {}
            for lo in range(0, len(active), WAVE):
                part = active[lo : lo + WAVE]
                raws = self.fe.read_many(
                    self.h, [(cursors[b], NODE_SIZE) for b in part]
                )
                for b, raw in zip(part, raws):
                    k, v, nxt = NODE.unpack(raw)
                    chains[b].append((k, v))
                    if nxt:
                        nxt_cursors[b] = nxt
            cursors = nxt_cursors
        out: List[Tuple[int, int]] = []
        for b in sorted(chains):
            out.extend(chains[b])
        return out

    # ---------------------------------------------------------- space reclaim
    def _free_storage(self) -> None:
        """Free every chain node, then the bucket array (shard migration
        reclaim).  Chunks carved by an earlier front-end incarnation are
        leaked rather than guessed at (see free_chunk_if_known)."""
        fe = self.fe
        for b in range(self.n_buckets):
            cur = self._read_ptr(self.base + b * 8)
            while cur:
                nxt = NODE.unpack(fe.read(self.h, cur, NODE_SIZE))[2]
                fe.allocator.free_chunk_if_known(cur)
                cur = nxt
        if self.n_buckets * 8 > fe.allocator.slab_bytes:
            fe.free(self.base, self.n_buckets * 8)  # direct block allocation
        else:
            fe.allocator.free_chunk_if_known(self.base)
        fe.backend.delete_name(f"{self.name}.base")
        fe.backend.delete_name(f"{self.name}.nbuckets")

    # ---------------------------------------------------------------- replay
    def _replay_put(self, key: int, value: int) -> None:
        self._put_base(key, value)

    def _replay_del(self, key: int) -> None:
        self._del_base(key)
