"""The cluster shard directory: an epoch-versioned, hash-partitioned
key -> shard -> blade map.

The directory is tiny control-plane state, but it must survive any single
blade failure and be discoverable by a front-end that knows nothing except
the blade addresses.  So every mutation is re-persisted — as one checksummed
blob under the well-known name ``cluster.directory`` — to *every* live
blade's naming/heap area, and bootstrap reads all blades and keeps the
highest valid epoch (a newly promoted mirror carries the epoch that was
current when it was last replicated to, so the maximum wins).

Epochs order reconfigurations: failover promotions and shard migrations bump
the epoch, and every front-end validates its cached epoch before routing an
op (the simulator's stand-in for an epoch-in-every-RPC scheme a la Tsai &
Zhang's disaggregated-PM stores).

Leases replace the per-op validation against the authoritative copy:
a front-end that fetches the directory is granted a lease — (epoch, expiry
in sim-ns) recorded in the cluster ``LeaseTable``, persisted like the
directory itself — and validates *locally* for the lease window.  The
authority in exchange promises to revoke every outstanding lease (paying an
invalidation-broadcast cost) BEFORE any reconfiguration swaps the mapping,
so a lease holder can never route to a tombstoned source.  Expiry bounds
the damage of a lost revocation in a real deployment; here it forces a
periodic renewal fetch, which is the whole steady-state cost of staying
fresh.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

from ..core.backend import CrashError, NVMBackend
from ..core.oplog import fletcher64
from ..core.structures.base import mix64

DIRECTORY_NAME = "cluster.directory"
LEASES_NAME = "cluster.leases"
_MAGIC = 0x52444952  # "RDIR"
_HEADER = struct.Struct("<IQII")  # magic, epoch, n_shards, n_blades
_LEASE_MAGIC = 0x5341454C   # "LEAS" (v1: read leases only)
_LEASE_MAGIC2 = 0x3253454C  # "LES2" (v2: + write leases)
_LEASE_MAGIC3 = 0x3353454C  # "LES3" (v3: write leases scoped per structure)
_LEASE_HEADER = struct.Struct("<II")   # magic, n_entries
_LEASE_ENTRY = struct.Struct("<IQd")   # fe_id, epoch, expiry_ns
# v3 trailer: write_epoch counter, n_write_leases, n_shared_shards, then
# per-write-lease records and the shared-mode (scope, shard) list
_WLEASE_HEADER = struct.Struct("<QII")
_WLEASE_ENTRY = struct.Struct("<IIIQdQ")  # scope, shard, fe_id, epoch, expiry, watermark


def scope_of(name: str) -> int:
    """Stable 32-bit lease scope of a structure name.

    Write leases are per (structure, shard): two structures sharing a
    cluster have independent op streams and independent blade fence slots
    (``{name}.wep``), so their writers must never fence each other — keying
    the lease table by bare shard index would false-share it across every
    structure on the cluster (each one's writer stealing the others' leases
    on the same shard index every batch).  CRC32 keeps the key compact and
    deterministic; a collision merely merges two structures' lease domains
    (spurious steals — conservative, never unsafe)."""
    return zlib.crc32(name.encode())

# a shard whose write lease changes hands this many times (without the same
# holder renewing in between) flips to "shared" mode: further ping-pong
# would cost a grant+invalidate round per flip, so contended writers
# serialize through the per-shard writer mutex / MVCC instead
STEAL_PINGPONG_LIMIT = 3


class ShardDirectory:
    """Hash-partitioned shard map with epoch versioning."""

    def __init__(self, n_shards: int, blades: List[int],
                 assignment: Optional[Dict[int, int]] = None, epoch: int = 0):
        self.n_shards = n_shards
        self.blades = list(blades)            # blade ids participating
        self.epoch = epoch
        if assignment is None:
            # round-robin initial placement over the member blades
            assignment = {s: blades[s % len(blades)] for s in range(n_shards)}
        self.assignment = dict(assignment)     # shard -> blade id
        # soft load statistics: data-path ops routed per shard since the
        # directory was created.  Volatile by design (not encoded): a clone
        # or a bootstrap starts counting afresh; placement decisions read
        # the *authoritative* copy, which sees every front-end's traffic.
        self.op_counts: Dict[int, int] = {}

    # ------------------------------------------------------------- routing
    def shard_of(self, key: int) -> int:
        return mix64(key & 0xFFFFFFFFFFFFFFFF) % self.n_shards

    def blade_of(self, shard: int) -> int:
        return self.assignment[shard]

    def blade_for_key(self, key: int) -> int:
        return self.assignment[self.shard_of(key)]

    def shards_on(self, blade_id: int) -> List[int]:
        return [s for s, b in self.assignment.items() if b == blade_id]

    # ---------------------------------------------------- invalidation groups
    def group_of(self, key: int) -> int:
        """Result-cache invalidation group of a key: its shard.  The
        directory is the single authority for the key->group mapping, so a
        reconfiguration that moves shard ``s`` invalidates exactly the
        cached results tagged ``s`` (see ``NVMCluster.revoke_leases``);
        callers with a key range enumerate the groups of its members."""
        return self.shard_of(key)

    # ------------------------------------------------------- reconfiguration
    def bump_epoch(self) -> int:
        self.epoch += 1
        return self.epoch

    def assign(self, shard: int, blade_id: int) -> None:
        if blade_id not in self.blades:
            raise ValueError(f"blade {blade_id} is not a cluster member")
        self.assignment[shard] = blade_id

    def add_blade(self, blade_id: int) -> None:
        if blade_id not in self.blades:
            self.blades.append(blade_id)

    def load_counts(self) -> Dict[int, int]:
        counts = {b: 0 for b in self.blades}
        for b in self.assignment.values():
            counts[b] = counts.get(b, 0) + 1
        return counts

    # -------------------------------------------------------- load statistics
    def record_ops(self, shard: int, n: int = 1) -> None:
        """Count `n` data-path ops routed at `shard` (soft state feeding the
        weighted rebalancer)."""
        self.op_counts[shard] = self.op_counts.get(shard, 0) + n

    def shard_weight(self, shard: int) -> int:
        """Placement weight of one shard: 1 (its existence — a proxy for its
        resident size, every item having arrived through an op) + the ops
        routed at it."""
        return 1 + self.op_counts.get(shard, 0)

    def load_weights(self) -> Dict[int, int]:
        """Per-blade sum of shard weights — what the weighted rebalancer
        evens out, instead of the raw shard counts of ``load_counts``."""
        weights = {b: 0 for b in self.blades}
        for s, b in self.assignment.items():
            weights[b] = weights.get(b, 0) + self.shard_weight(s)
        return weights

    # ------------------------------------------------------------------ clone
    def clone(self) -> "ShardDirectory":
        """A routing snapshot for one front-end: same mapping and epoch,
        independent storage — so a lease holder genuinely routes on its
        cached copy and reconfigurations CANNOT leak through object
        aliasing (stale routing is observable, which is exactly what the
        revoke-before-swap protocol must prevent)."""
        return ShardDirectory(self.n_shards, self.blades,
                              dict(self.assignment), self.epoch)

    # ----------------------------------------------------------- wire format
    def encode(self) -> bytes:
        body = _HEADER.pack(_MAGIC, self.epoch, self.n_shards, len(self.blades))
        body += struct.pack(f"<{len(self.blades)}I", *self.blades)
        ids = [self.assignment[s] for s in range(self.n_shards)]
        body += struct.pack(f"<{self.n_shards}I", *ids)
        return body + struct.pack("<Q", fletcher64(body))

    @classmethod
    def decode(cls, raw: bytes) -> Optional["ShardDirectory"]:
        if len(raw) < _HEADER.size + 8:
            return None
        body, (csum,) = raw[:-8], struct.unpack("<Q", raw[-8:])
        if fletcher64(body) != csum:
            return None  # torn directory write: caller falls back to peers
        magic, epoch, n_shards, n_blades = _HEADER.unpack_from(body, 0)
        if magic != _MAGIC:
            return None
        off = _HEADER.size
        blades = list(struct.unpack_from(f"<{n_blades}I", body, off))
        off += 4 * n_blades
        ids = struct.unpack_from(f"<{n_shards}I", body, off)
        assignment = {s: ids[s] for s in range(n_shards)}
        return cls(n_shards, blades, assignment, epoch)

    # ------------------------------------------------------------ persistence
    def persist(self, blades: Dict[int, NVMBackend]) -> int:
        """Write the directory blob to every live blade; returns how many
        copies landed (quorum-free: any one surviving copy bootstraps)."""
        raw = self.encode()
        landed = 0
        for be in blades.values():
            if not be.alive:
                continue
            try:
                be.put_blob(DIRECTORY_NAME, raw)
            except CrashError:
                # the blade died mid-write (e.g. a power loss tearing the
                # blob): its partial copy fails the checksum at bootstrap,
                # and any one surviving whole copy is enough
                continue
            landed += 1
        return landed

    @classmethod
    def bootstrap(cls, blades: Dict[int, NVMBackend]) -> Optional["ShardDirectory"]:
        """Recover the directory from bytes alone: read every reachable
        blade's copy, keep the highest valid epoch."""
        best: Optional[ShardDirectory] = None
        for be in blades.values():
            if not be.alive:
                continue
            raw = be.get_blob(DIRECTORY_NAME)
            if raw is None:
                continue
            d = cls.decode(raw)
            if d is not None and (best is None or d.epoch > best.epoch):
                best = d
        return best


class LeaseTable:
    """Per-front-end directory leases: fe_id -> (epoch, expiry sim-ns).

    A valid lease lets ``ClusterFrontEnd.ensure_fresh`` validate its cached
    directory locally — no authoritative check, no cost — for the lease
    window.  The table is the authority's revocation handle: every
    reconfiguration calls ``revoke_all`` (and pays the invalidation
    broadcast) BEFORE swapping the mapping, so no holder can keep routing
    to a tombstoned source.  Persisted as a checksummed blob on every live
    blade (like the directory): a restarted authority recovers which leases
    are outstanding and must be waited out / revoked, instead of silently
    breaking the holders' contract.

    Write leases extend the same table from read routing to write
    *fencing*: a front-end must hold shard ``s``'s write lease before
    appending to any of ``s``'s op logs.  Each grant/steal carries an epoch
    from one global monotone counter (``write_epoch``) that is never reused
    — it is the fencing token stamped into every blade-side fence slot, so
    a stolen-from writer's later group commit compares stale at the blade
    and vanishes instead of interleaving.  A lease release/handoff records
    the holder's committed-tail ``watermark`` so the next writer can skip
    replay when the durable tail already matches.  Shards that ping-pong
    between writers flip to *shared* mode: every writer gets the same
    epoch and serializes through the per-shard writer mutex
    (``core.locks.WriterPreferredLock.acquire_writer``) or MVCC instead of
    stealing the lease back and forth."""

    def __init__(self) -> None:
        self.leases: Dict[int, Tuple[int, float]] = {}
        self.revocations = 0  # total leases revoked (observability)
        # (scope, shard) -> (holder fe_id, epoch, expiry sim-ns); scope is
        # ``scope_of(structure name)`` so structures sharing a cluster never
        # false-share their writers' leases (independent op streams)
        self.write_leases: Dict[Tuple[int, int], Tuple[int, int, float]] = {}
        # the global fencing-epoch counter: bumped on every exclusive
        # grant/steal, NEVER reused (monotonicity is what makes a stale
        # epoch detectable forever)
        self.write_epoch = 0
        self.steals = 0  # write leases taken from a live distinct holder
        # (scope, shard) -> committed-tail watermark at release/handoff
        self.watermarks: Dict[Tuple[int, int], int] = {}
        # (scope, shard) -> consecutive distinct-holder handoffs (ping-pong
        # score); resets when a holder renews, flips the shard to shared
        # mode at STEAL_PINGPONG_LIMIT
        self._flips: Dict[Tuple[int, int], int] = {}
        self.shared_shards: set = set()  # of (scope, shard)

    # ------------------------------------------------------- write fencing
    def acquire_write(self, shard: int, fe_id: int, now_ns: float,
                      ttl_ns: float, shared: bool = False, scope: int = 0
                      ) -> Tuple[int, bool, Optional[int]]:
        """Grant / renew / steal shard ``shard``'s write lease for ``fe_id``.

        Returns ``(epoch, stolen, prev_holder)``.  Renewal by the current
        holder keeps its epoch (no fence churn) and resets the ping-pong
        score.  Taking the lease from a different unexpired holder is a
        *steal*: the epoch counter bumps so the old holder's appends fence,
        and the ping-pong score may flip the shard to shared mode.  In
        shared mode every caller receives the shard's current epoch —
        writers fence only against a future exclusive steal, and serialize
        among themselves through the writer mutex.
        """
        key = (scope, shard)
        shared = shared or key in self.shared_shards
        cur = self.write_leases.get(key)
        if cur is not None and cur[0] == fe_id:
            if not shared:
                self._flips[key] = 0
            self.write_leases[key] = (fe_id, cur[1], now_ns + ttl_ns)
            return cur[1], False, None
        if shared and cur is not None:
            # join the current epoch; the mutex serializes the holders
            self.write_leases[key] = (fe_id, cur[1], now_ns + ttl_ns)
            return cur[1], False, cur[0]
        stolen = cur is not None and now_ns < cur[2]
        prev = cur[0] if cur is not None else None
        self.write_epoch += 1
        self.write_leases[key] = (fe_id, self.write_epoch, now_ns + ttl_ns)
        if stolen:
            self.steals += 1
            self._flips[key] = self._flips.get(key, 0) + 1
            if self._flips[key] >= STEAL_PINGPONG_LIMIT:
                self.shared_shards.add(key)
        return self.write_epoch, stolen, prev

    def write_holder(self, shard: int, scope: int = 0
                     ) -> Optional[Tuple[int, int, float]]:
        return self.write_leases.get((scope, shard))

    def valid_write(self, shard: int, fe_id: int, epoch: int,
                    now_ns: float, scope: int = 0) -> bool:
        cur = self.write_leases.get((scope, shard))
        return (cur is not None and cur[0] == fe_id and cur[1] == epoch
                and now_ns < cur[2])

    def release_write(self, shard: int, fe_id: int,
                      watermark: Optional[int] = None,
                      scope: int = 0) -> bool:
        key = (scope, shard)
        cur = self.write_leases.get(key)
        if cur is None or cur[0] != fe_id:
            return False
        del self.write_leases[key]
        if watermark is not None:
            self.watermarks[key] = watermark
        return True

    def set_watermark(self, shard: int, watermark: int,
                      scope: int = 0) -> None:
        """Record a (stolen-from or draining) holder's committed tail so
        the next writer's attach can skip replay (lease-handoff piggyback)."""
        self.watermarks[(scope, shard)] = watermark

    def handoff_watermark(self, shard: int, scope: int = 0) -> Optional[int]:
        return self.watermarks.get((scope, shard))

    # -------------------------------------------------------------- protocol
    def grant(self, fe_id: int, epoch: int, now_ns: float, ttl_ns: float) -> bool:
        """Grant/renew a lease.  Returns True when the durable table changed
        materially — a new holder or a new epoch.  A pure expiry extension
        returns False so callers can skip re-persisting on every renewal
        (the persisted table records WHO holds leases at WHICH epoch; the
        expiry only bounds how long a lost revocation can stay stale)."""
        prev = self.leases.get(fe_id)
        self.leases[fe_id] = (epoch, now_ns + ttl_ns)
        return prev is None or prev[0] != epoch

    def valid(self, fe_id: int, epoch: int, now_ns: float) -> bool:
        entry = self.leases.get(fe_id)
        return entry is not None and entry[0] == epoch and now_ns < entry[1]

    def revoke(self, fe_id: int) -> bool:
        if fe_id in self.leases:
            del self.leases[fe_id]
            self.revocations += 1
            return True
        return False

    def revoke_all(self) -> int:
        """Invalidate every outstanding lease; returns how many holders the
        invalidation broadcast must reach (its cost scales with this).

        Write leases are revoked too: a reconfiguration (or lease-expiry
        fault) must fence every in-flight writer — each will re-acquire
        with a fresh, higher epoch, so blade fence slots only ever move
        forward and any pre-revocation append compares stale."""
        n = len(self.leases) + len(self.write_leases)
        self.leases.clear()
        self.write_leases.clear()
        self.revocations += n
        return n

    # ----------------------------------------------------------- wire format
    def encode(self) -> bytes:
        body = _LEASE_HEADER.pack(_LEASE_MAGIC3, len(self.leases))
        for fe_id in sorted(self.leases):
            epoch, expiry = self.leases[fe_id]
            body += _LEASE_ENTRY.pack(fe_id, epoch, expiry)
        shared = sorted(self.shared_shards)
        body += _WLEASE_HEADER.pack(self.write_epoch,
                                    len(self.write_leases), len(shared))
        for key in sorted(self.write_leases):
            fe_id, epoch, expiry = self.write_leases[key]
            body += _WLEASE_ENTRY.pack(key[0], key[1], fe_id, epoch, expiry,
                                       self.watermarks.get(key, 0))
        for scope, shard in shared:
            body += struct.pack("<II", scope, shard)
        return body + struct.pack("<Q", fletcher64(body))

    @classmethod
    def decode(cls, raw: bytes) -> Optional["LeaseTable"]:
        if len(raw) < _LEASE_HEADER.size + 8:
            return None
        body, (csum,) = raw[:-8], struct.unpack("<Q", raw[-8:])
        if fletcher64(body) != csum:
            return None
        magic, n = _LEASE_HEADER.unpack_from(body, 0)
        if magic not in (_LEASE_MAGIC, _LEASE_MAGIC2, _LEASE_MAGIC3):
            return None
        t = cls()
        off = _LEASE_HEADER.size
        for _ in range(n):
            fe_id, epoch, expiry = _LEASE_ENTRY.unpack_from(body, off)
            off += _LEASE_ENTRY.size
            t.leases[fe_id] = (epoch, expiry)
        if magic == _LEASE_MAGIC:
            return t  # v1 blob: read leases only, no writers outstanding
        we, nw, ns = _WLEASE_HEADER.unpack_from(body, off)
        off += _WLEASE_HEADER.size
        t.write_epoch = we
        if magic == _LEASE_MAGIC2:  # v2 blob: unscoped write leases
            v2_entry = struct.Struct("<IIQdQ")
            for _ in range(nw):
                shard, fe_id, epoch, expiry, wm = v2_entry.unpack_from(body, off)
                off += v2_entry.size
                t.write_leases[(0, shard)] = (fe_id, epoch, expiry)
                if wm:
                    t.watermarks[(0, shard)] = wm
            if ns:
                t.shared_shards = {
                    (0, s) for s in struct.unpack_from(f"<{ns}I", body, off)}
            return t
        for _ in range(nw):
            scope, shard, fe_id, epoch, expiry, wm = \
                _WLEASE_ENTRY.unpack_from(body, off)
            off += _WLEASE_ENTRY.size
            t.write_leases[(scope, shard)] = (fe_id, epoch, expiry)
            if wm:
                t.watermarks[(scope, shard)] = wm
        for _ in range(ns):
            scope, shard = struct.unpack_from("<II", body, off)
            off += 8
            t.shared_shards.add((scope, shard))
        return t

    # ------------------------------------------------------------ persistence
    def persist(self, blades: Dict[int, NVMBackend]) -> int:
        raw = self.encode()
        landed = 0
        for be in blades.values():
            if not be.alive:
                continue
            try:
                be.put_blob(LEASES_NAME, raw)
            except CrashError:
                continue  # died mid-write; torn copy fails the checksum
            landed += 1
        return landed

    @classmethod
    def bootstrap(cls, blades: Dict[int, NVMBackend]) -> "LeaseTable":
        """Recover outstanding leases from any live blade's copy (an absent
        or torn blob means no leases are outstanding)."""
        for be in blades.values():
            if not be.alive:
                continue
            raw = be.get_blob(LEASES_NAME)
            if raw is None:
                continue
            t = cls.decode(raw)
            if t is not None:
                return t
        return cls()
