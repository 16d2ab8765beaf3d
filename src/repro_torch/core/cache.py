"""Front-end DRAM page cache (paper §7.2).

A hash map translates NVM addresses to cached local pages.  Three eviction
policies are provided, matching the paper's micro-benchmark:

  * ``lru``    — exact LRU (highest hit rate, most bookkeeping),
  * ``rr``     — random replacement (cheapest, worst hit rate),
  * ``hybrid`` — the paper's policy: draw a random candidate set of
                 ``rr_set_size`` pages, evict the least-recently-used page
                 *of that set* (LRU quality at RR cost).

Eviction never writes back: the write workflow has already staged memory
logs to the back-end, so cached pages are clean by construction.

Recency is kept in a dense numpy tick array parallel to the candidate list,
so a hybrid eviction is one buffered random draw + one gather + one argmin —
the per-candidate ``randrange`` + dict-probe loop this replaces dominated
the simulator's wall-clock under eviction pressure (32 draws per admitted
page once the cache is full).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

# uniform draws come from a pre-generated buffer: one numpy call refills
# thousands of candidate draws
_RAND_BUF = 1 << 15

# recency sentinel for a slot whose page was already handed out mid-wave
# (never the LRU of any candidate set)
_TICK_DEAD = (1 << 62)


class PageCache:
    def __init__(
        self,
        capacity_bytes: int,
        policy: str = "hybrid",
        rr_set_size: int = 32,
        seed: int = 0,
    ):
        assert policy in ("lru", "rr", "hybrid")
        self.capacity = capacity_bytes
        self.policy = policy
        self.rr_set_size = rr_set_size
        self.pages: Dict[int, bytearray] = {}
        # O(1) random candidate draws for rr/hybrid eviction: a dense list
        # of cached addrs + each addr's position (swap-pop on removal), with
        # the page's last-touched tick at the same position in `_ticks`
        self._addrs: list = []
        self._addr_pos: Dict[int, int] = {}
        self._ticks: "np.ndarray" = np.zeros(1024, dtype=np.int64)
        self.used_bytes = 0
        self.tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._rng = np.random.default_rng(seed)
        # 63-bit uniform ints: candidate indices are `draw % n` (bias is
        # negligible at 2**63), so one buffered slice + one vector modulo
        # yields a whole eviction round's candidate set
        self._rand: "np.ndarray" = self._rng.integers(
            0, 1 << 62, _RAND_BUF, dtype=np.int64
        )
        self._rand_pos = 0

    def _draws(self, k: int) -> "np.ndarray":
        """`k` uniform 62-bit ints from the buffered stream."""
        pos = self._rand_pos
        if pos + k > _RAND_BUF:
            self._rand = self._rng.integers(0, 1 << 62, _RAND_BUF, dtype=np.int64)
            pos = 0
        self._rand_pos = pos + k
        return self._rand[pos : pos + k]

    # ------------------------------------------------------------------- api
    def get(self, addr: int) -> Optional[bytearray]:
        self.tick += 1
        page = self.pages.get(addr)
        if page is None:
            self.misses += 1
            return None
        self.hits += 1
        self._ticks[self._addr_pos[addr]] = self.tick
        return page

    def peek(self, addr: int) -> Optional[bytearray]:
        """Probe without touching hit/miss stats or recency (used by batch
        prefetch so warming a wave doesn't skew the adaptive thresholds)."""
        return self.pages.get(addr)

    def touch(self, addr: int) -> None:
        """Refresh a cached page's recency without stats (write-through)."""
        pos = self._addr_pos.get(addr)
        if pos is not None:
            self._ticks[pos] = self.tick

    def put(self, addr: int, data: bytes) -> None:
        self.tick += 1
        # fully remove any old page first: if it merely kept a decremented
        # counter, the make-room loop below could evict the same addr and
        # decrement used_bytes twice (driving it negative = over-admission)
        old = self.pages.pop(addr, None)
        if old is not None:
            self.used_bytes -= len(old)
            self._drop_addr(addr)
        page = bytearray(data)
        while self.used_bytes + len(page) > self.capacity and self.pages:
            self._evict_one()
        if self.used_bytes + len(page) > self.capacity:
            return  # page larger than the whole cache: bypass
        pos = self._addr_pos.get(addr)
        if pos is None:
            pos = self._addr_pos[addr] = len(self._addrs)
            self._addrs.append(addr)
            if pos >= len(self._ticks):
                self._ticks = np.concatenate(
                    [self._ticks, np.zeros(len(self._ticks), dtype=np.int64)]
                )
        self._ticks[pos] = self.tick
        self.pages[addr] = page
        self.used_bytes += len(page)

    def update_or_put(self, addr: int, data: bytes) -> None:
        """Write-through of a whole node: replace a cached page of the same
        length in place (refreshing its recency), else admit it."""
        page = self.pages.get(addr)
        if page is not None and len(page) == len(data):
            self.pages[addr] = bytearray(data)
            self.touch(addr)
        else:
            self.put(addr, data)

    def update(self, addr: int, offset: int, data: bytes) -> None:
        """Write-through into a cached page, if present."""
        page = self.pages.get(addr)
        if page is not None:
            page[offset : offset + len(data)] = data

    def _drop_addr(self, addr: int) -> None:
        pos = self._addr_pos.pop(addr, None)
        if pos is None:
            return
        last = self._addrs.pop()
        if last != addr:
            self._addrs[pos] = last
            self._addr_pos[last] = pos
            self._ticks[pos] = self._ticks[len(self._addrs)]

    def invalidate(self, addr: int) -> None:
        page = self.pages.pop(addr, None)
        if page is not None:
            self.used_bytes -= len(page)
            self._drop_addr(addr)

    def clear(self) -> None:
        self.pages.clear()
        self._addrs.clear()
        self._addr_pos.clear()
        self.used_bytes = 0

    @property
    def miss_ratio(self) -> float:
        total = self.hits + self.misses
        return self.misses / total if total else 0.0

    def stats(self) -> dict:
        """Counter snapshot for telemetry export (fills = cold admissions,
        i.e. misses that later entered the cache via ``put``)."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "pages": len(self.pages),
            "used_bytes": self.used_bytes,
            "capacity_bytes": self.capacity,
        }

    def admit_many(self, items) -> None:
        """Bulk admission for a wave of fetched pages.

        Policy-equivalent to calling ``put`` per item, but the eviction
        candidate draws for the whole wave come from one random slice and
        one row-wise argmin over the tick matrix instead of one draw +
        gather per evicted page.  Victim *identity* differs from the
        sequential stream (same distribution), so simulated hit ratios are
        statistically identical while wall-clock cost is ~an order lower.
        """
        if not items:
            return
        if len(items) > 1:
            # duplicate addrs in one wave collapse last-wins (the serial
            # put stream would end in the same state); without the dedup the
            # admission loop below would double-count used_bytes
            dedup = dict(items)
            if len(dedup) != len(items):
                items = list(dedup.items())
        pages = self.pages
        cap = self.capacity
        incoming = 0
        for _, data in items:
            incoming += len(data)
        # wave items are cache misses by construction, so the re-admission
        # pre-pop pass almost never fires: one C-level disjointness probe
        # replaces n dict pops
        if pages and not pages.keys().isdisjoint([a for a, _ in items]):
            for addr, _ in items:
                old = pages.pop(addr, None)
                if old is not None:
                    self.used_bytes -= len(old)
                    self._drop_addr(addr)
        if incoming > cap:
            # some page may exceed the whole cache: per-item puts keep the
            # exact serial bypass semantics for this rare shape
            while self.used_bytes + incoming > cap and pages:
                self._evict_one()
            for addr, data in items:
                self.put(addr, data)
            return
        need = self.used_bytes + incoming - cap
        vacated: list = []
        if need > 0 and pages:
            if self.policy != "hybrid":
                self._evict_bulk(need)
                while self.used_bytes + incoming > cap and pages:
                    self._evict_one()
            else:
                # fused evict+admit: victims' slots are handed straight to
                # the incoming pages (replace-in-place), so the steady-state
                # miss path does one dict pop + one dict set per page
                # instead of pop + swap-pop + append.  Victim selection is
                # the same consistent-snapshot candidate-set LRU as
                # _evict_bulk, and because no swap-pop happens mid-round,
                # rows can be consumed in any order.
                addrs = self._addrs
                pos = self._addr_pos
                ticks = self._ticks
                evicted = 0
                while need > 0 and pages:
                    n = len(addrs)
                    k = min(self.rr_set_size, n)
                    mean = max(1, self.used_bytes // n)
                    # overdraw 50%: duplicate rows and small victims make a
                    # mean-sized estimate undershoot, and a second selection
                    # round costs more than the extra candidate gathers
                    # (rows past the need are never evicted)
                    m = min(max(1, (-(-need // mean) * 3 + 1) // 2),
                            _RAND_BUF // k)
                    idx = (self._draws(m * k) % n).reshape(m, k)
                    rows = idx[np.arange(m), ticks[idx].argmin(axis=1)]
                    freed = 0
                    for v in set(rows.tolist()):
                        if need <= 0:
                            break
                        victim = addrs[v]
                        page = pages.pop(victim, None)
                        if page is None:
                            continue  # slot vacated by an earlier round
                        del pos[victim]
                        # dead slots must stop winning argmin: they keep
                        # the oldest ticks, so without the sentinel every
                        # later round would re-select them and spin
                        ticks[v] = _TICK_DEAD
                        vacated.append(v)
                        nb = len(page)
                        freed += nb
                        evicted += 1
                        need -= nb
                    self.used_bytes -= freed
                self.evictions += evicted
        # place items: vacated slots first (no list surgery), then append
        m = len(items)
        addrs = self._addrs
        pos = self._addr_pos
        pages_set = pages.__setitem__
        fill = min(len(vacated), m)
        base = self.tick
        self.tick = base + m
        if fill:
            for j in range(fill):
                a, d = items[j]
                v = vacated[j]
                addrs[v] = a
                pos[a] = v
                pages_set(a, bytearray(d))
            self._ticks[np.fromiter(vacated[:fill], np.int64, fill)] = (
                base + 1 + np.arange(fill, dtype=np.int64)
            )
        if len(vacated) > fill:
            # more victims than incoming pages: compact the spare vacant
            # slots out of the dense list.  Descending order means any slot
            # above the one being compacted is already gone, so the list's
            # current tail is either this very slot or a live entry.
            ticks = self._ticks
            for v in sorted(vacated[fill:], reverse=True):
                li = len(addrs) - 1
                last = addrs.pop()
                if li != v:
                    addrs[v] = last
                    pos[last] = v
                    ticks[v] = ticks[li]
        elif fill < m:
            rest = items[fill:]
            r = m - fill
            start = len(addrs)
            cap_t = len(self._ticks)
            if start + r > cap_t:
                while cap_t < start + r:
                    cap_t *= 2
                grown = np.zeros(cap_t, dtype=np.int64)
                grown[: len(self._ticks)] = self._ticks
                self._ticks = grown
            self._ticks[start : start + r] = base + 1 + fill + np.arange(
                r, dtype=np.int64
            )
            addr_list = [a for a, _ in rest]
            addrs.extend(addr_list)
            pos.update(zip(addr_list, range(start, start + r)))
            pages.update((a, bytearray(d)) for a, d in rest)
        self.used_bytes += incoming

    # -------------------------------------------------------------- eviction
    def _evict_one(self) -> None:
        n = len(self._addrs)
        if self.policy == "lru":
            victim = self._addrs[int(self._ticks[:n].argmin())]
        elif self.policy == "rr":
            victim = self._addrs[int(self._draws(1)[0] % n)]
        else:
            # hybrid: random candidate set (drawn with replacement — O(1)
            # per draw instead of an O(n) key-list copy), evict its LRU
            # member; one buffered draw + one gather + one argmin
            k = min(self.rr_set_size, n)
            idx = self._draws(k) % n
            victim = self._addrs[idx[int(self._ticks[idx].argmin())]]
        page = self.pages.pop(victim)
        self._drop_addr(victim)
        self.used_bytes -= len(page)
        self.evictions += 1

    def _evict_bulk(self, need_bytes: int) -> None:
        """Evict until ``need_bytes`` is freed, drawing all candidate sets
        up front.  Every row's argmin runs against the SAME live tick state
        (no swap-pop happens between draw and selection), so each victim is
        a true candidate-set LRU — the policy's hot-page protection is
        intact.  Duplicate rows collapse; any shortfall (duplicates, stale
        mean-size estimate) is covered by the next round's redraw."""
        if self.policy != "hybrid":
            while need_bytes > 0 and self.pages:
                before = self.used_bytes
                self._evict_one()
                need_bytes -= before - self.used_bytes
            return
        addrs = self._addrs
        pages = self.pages
        pos = self._addr_pos
        ticks = self._ticks
        evicted = 0
        freed = 0
        while need_bytes > 0 and pages:
            n = len(addrs)
            k = min(self.rr_set_size, n)
            # estimate rows from the mean live page size; any shortfall is
            # covered by the next loop iteration
            mean = max(1, self.used_bytes // n)
            m = min(max(1, -(-need_bytes // mean)), _RAND_BUF // k)
            idx = (self._draws(m * k) % n).reshape(m, k)
            rows = idx[np.arange(m), ticks[idx].argmin(axis=1)]
            # descending slot order keeps every remaining victim index
            # valid across the eviction swap-pops (a pop only moves the
            # current last element, which is never a smaller victim index)
            for v in sorted(set(rows.tolist()), reverse=True):
                if need_bytes <= 0:
                    break
                victim = addrs[v]
                nb = len(pages.pop(victim))
                last = addrs.pop()  # inline swap-pop (hot: once per miss)
                if last != victim:
                    addrs[v] = last
                    pos[last] = v
                    ticks[v] = ticks[len(addrs)]
                del pos[victim]
                freed += nb
                evicted += 1
                need_bytes -= nb
            self.used_bytes -= freed
            freed = 0
        self.evictions += evicted


class ResultCache:
    """Front-end **result** cache: decoded key -> value results, one tier
    above the byte-level :class:`PageCache`.

    The page cache holds remote NVM pages; a hit still pays node decode and
    structure traversal.  The result cache memoizes the *answer* of a point
    lookup, so a hit costs one local DRAM reference.  Every entry is tagged
    with an **invalidation group** (its shard id in the cluster), giving
    three invalidation tiers:

      * per-key    — write fencing: a local write overwrites/removes exactly
                     that key's entry,
      * per-group  — a shard migrated or failed over: drop that shard's
                     entries, keep the rest,
      * global     — directory rebuilt / topology changed: drop everything.

    The cluster wires the group/global tiers into the lease-revocation
    broadcast (`NVMCluster.revoke_leases`), so reconfigurations invalidate
    exactly the affected groups.  Admission and bypass policy (bounded
    staleness, read-your-writes pins) live in the caller — this class is a
    bounded LRU map with group indexing and counters.

    ``counters`` is a plain dict so an observability session can keep
    folding it after the owning structure dies (see ``repro_torch.obs``).
    """

    def __init__(self, capacity_entries: int = 4096):
        if capacity_entries < 1:
            raise ValueError("capacity_entries must be >= 1")
        self.capacity = capacity_entries
        self._entries: "OrderedDict" = OrderedDict()  # key -> value (LRU order)
        self._group_of: Dict[object, object] = {}     # key -> group tag
        self._groups: Dict[object, set] = {}          # group tag -> {keys}
        self.counters: Dict[str, int] = {
            "hits": 0,
            "misses": 0,
            "admitted": 0,
            "evictions": 0,
            "invalidations_key": 0,
            "invalidations_group": 0,
            "invalidations_global": 0,
            "pinned_bypass": 0,
        }

    def __len__(self) -> int:
        return len(self._entries)

    # --------------------------------------------------------------- lookups
    def get(self, key):
        """Probe: ``(hit, value)``.  A hit refreshes LRU recency."""
        ent = self._entries
        if key in ent:
            ent.move_to_end(key)
            self.counters["hits"] += 1
            return True, ent[key]
        self.counters["misses"] += 1
        return False, None

    def note_bypass(self) -> None:
        """Count a read that skipped the cache entirely (pinned key)."""
        self.counters["pinned_bypass"] += 1

    # ------------------------------------------------------------- admission
    def put(self, key, value, group) -> None:
        """Admit (or refresh) a result under an invalidation group."""
        ent = self._entries
        if key in ent:
            old_group = self._group_of[key]
            if old_group != group:
                self._groups[old_group].discard(key)
                if not self._groups[old_group]:
                    del self._groups[old_group]
            ent.move_to_end(key)
        elif len(ent) >= self.capacity:
            victim, _ = ent.popitem(last=False)
            g = self._group_of.pop(victim)
            members = self._groups[g]
            members.discard(victim)
            if not members:
                del self._groups[g]
            self.counters["evictions"] += 1
        ent[key] = value
        self._group_of[key] = group
        self._groups.setdefault(group, set()).add(key)
        self.counters["admitted"] += 1

    # ---------------------------------------------------- invalidation tiers
    def invalidate_key(self, key) -> bool:
        """Per-key tier (write fencing).  Returns True if an entry dropped."""
        if key not in self._entries:
            return False
        del self._entries[key]
        g = self._group_of.pop(key)
        members = self._groups[g]
        members.discard(key)
        if not members:
            del self._groups[g]
        self.counters["invalidations_key"] += 1
        return True

    def invalidate_group(self, group) -> int:
        """Per-group tier (shard migration/failover).  Returns entries dropped.

        Counters record entries dropped (like the per-key tier), not
        broadcasts received, so the three tiers sum to total evicted-by-
        invalidation work."""
        keys = self._groups.pop(group, None)
        if not keys:
            return 0
        for k in keys:
            del self._entries[k]
            del self._group_of[k]
        self.counters["invalidations_group"] += len(keys)
        return len(keys)

    def invalidate_all(self) -> int:
        """Global tier (directory rebuilt).  Returns entries dropped."""
        n = len(self._entries)
        self._entries.clear()
        self._group_of.clear()
        self._groups.clear()
        self.counters["invalidations_global"] += n
        return n

    # --------------------------------------------------------------- metrics
    def stats(self) -> Dict[str, float]:
        c = self.counters
        looks = c["hits"] + c["misses"]
        out = dict(c)
        out["entries"] = len(self._entries)
        out["capacity_entries"] = self.capacity
        out["hit_rate"] = c["hits"] / looks if looks else 0.0
        return out
