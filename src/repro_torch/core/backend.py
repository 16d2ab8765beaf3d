"""The back-end NVM blade.

Passive by design (paper §3.1): it never initiates communication; it exposes
only the small fixed API set — one-sided read/write, ``remote_tx_write``
(append memory logs + commit + checksum), slab alloc/free over a persistent
bitmap, and 64-bit atomics — so the whole blade could be an ASIC/FPGA.

Layout of the NVM arena::

    [0,            NAMING_END)   global-naming region: fixed 8-byte slots at
                                 well-known offsets (root pointers, log heads,
                                 LPNs, allocation metadata)
    [NAMING_END,   BITMAP_END)   persistent allocation bitmap (1 bit / block)
    [BITMAP_END,   capacity)     block heap: data areas + log areas

Everything needed for recovery lives in the arena itself; ``recover()``
rebuilds all volatile state (free lists, log-head caches) from bytes, and
``decode_txs`` drops torn tails by checksum, per paper §4.2/§7.5.

The arena, and each mirror's, is a ``torch.uint8`` tensor on the blade's
device: the card unless ``device="cpu"`` is asked for.  The front end (the
host) reaches it as the paper's front ends reach remote memory: PCIe plays
the part of RDMA.  Every verb is one copy between the host and the device,
whatever its size (``_get`` / ``_put``, counted in ``d2h`` / ``h2d``); a
read wave is one gather and one copy (``gather``); scans that the
reference makes slot by slot or bit by bit (the naming region, the
allocation bitmap) read their region once.  The work the paper puts on the
blade runs on the device: the replay of committed memory logs
(``tx_apply``: ``kernels.nvm_log.apply_runs``), the checksum verify of the
bodies the front end's memo does not hold (``kernels.nvm_log.
fletcher64_segments``, in ``tx_apply`` and ``reboot``), log moves and
mirror promotion (device copies).  The virtual clock charges exactly what
the reference's charges: where the bytes live changes no simulated cost.
"""

from __future__ import annotations

import collections
import struct
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import nvm_log
from .oplog import (
    MemLog,
    decode_oplogs,
    decode_txs,
    decode_txs_columnar,
    encode_oplog,
    encode_tx,
)
from .sim import Clock, CostModel, Link, Stats
from ..obs.profile import profile

# what a physical write carries: host bytes, or a uint8 tensor on the arena's
# device (a log move or scrub that never leaves the device)
Data = Union[bytes, bytearray, memoryview, torch.Tensor]

NAME_SLOT = 40  # 32B name + 8B value
NUM_NAME_SLOTS = 512
NAMING_END = NUM_NAME_SLOTS * NAME_SLOT

# a deleted naming slot: keeps the linear probe sound (an all-zero slot
# terminates probing, so freed slots cannot simply be zeroed) and is skipped
# by reboot(); 0xFF never appears in an encoded name
NAME_TOMBSTONE = b"\xff" * 32


class CrashError(RuntimeError):
    """Raised when the blade is down (transient or permanent failure)."""


class StaleWriterError(RuntimeError):
    """A fenced append carried a writer epoch below the blade's fence slot.

    Raised by ``tx_append``/``set_name_fenced`` when the caller's write
    lease was stolen: the new holder stamped a higher epoch into the
    structure's fence slot, so the old writer's group commit is rejected
    whole — its unacked ops vanish instead of interleaving.  Deliberately
    NOT a ``CrashError``: the blade is healthy, so the self-healing
    retry/recovery path must not fire; the caller re-acquires the lease
    and replays its intent instead.
    """


def _host_bytes(data: Data) -> bytes:
    if isinstance(data, torch.Tensor):
        return data.cpu().numpy().tobytes()
    return bytes(data)


class _Arena:
    """A blade's NVM arena: a ``torch.uint8`` tensor on a device, reached
    from the host one copy a verb.  A CPU arena takes the same path as a
    card's (there the copies are memcpys); ``d2h`` and ``h2d`` count the
    copies either way (a tensor written from the same device counts in
    neither)."""

    def __init__(self, capacity: int, device: torch.device):
        self.d2h = 0
        self.h2d = 0
        self.arena = torch.zeros(capacity, dtype=torch.uint8, device=device)

    @property
    def arena(self) -> torch.Tensor:
        return self._arena

    @arena.setter
    def arena(self, t: torch.Tensor) -> None:
        if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("an arena is a contiguous 1-D uint8 tensor")
        self._arena = t

    def _get(self, addr: int, size: int) -> bytes:
        self.d2h += 1
        return self._arena[addr : addr + size].cpu().numpy().tobytes()

    def _word(self, addr: int) -> int:
        return struct.unpack("<Q", self._get(addr, 8))[0]

    def _put(self, addr: int, data: Data) -> None:
        n = len(data)
        if n == 0:
            return
        if isinstance(data, torch.Tensor):
            if data.device != self._arena.device:
                self.h2d += 1
            self._arena[addr : addr + n].copy_(data)
            return
        self.h2d += 1
        self._arena[addr : addr + n].copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))

    def gather(self, reqs: Sequence[Tuple[int, int]]) -> List[bytes]:
        """The bytes of each (addr, size) request, in order: one read wave.
        On a card, one gather on the device and one copy to the host."""
        if not reqs:
            return []
        pairs = np.array(reqs, dtype=np.int64).reshape(-1, 2)
        sizes = pairs[:, 1]
        ends = np.cumsum(sizes)
        total = int(ends[-1])
        dev = self._arena.device
        tab = torch.from_numpy(np.ascontiguousarray(pairs.T))
        tab = (tab.pin_memory() if dev.type == "cuda" else tab).to(dev, non_blocking=True)
        addr_d, size_d = tab[0], tab[1]
        # byte k of request i sits at addr_i + (k - first byte of i in the wave)
        shift = addr_d - (torch.cumsum(size_d, 0) - size_d)
        idx = torch.repeat_interleave(shift, size_d, output_size=total)
        idx += torch.arange(total, device=dev)
        self.d2h += 1
        flat = self._arena[idx].cpu().numpy().tobytes()
        starts = (ends - sizes).tolist()
        return [flat[o : o + s] for o, s in zip(starts, sizes.tolist())]


class Mirror(_Arena):
    """A read-only mirror blade: receives the replicated log channel.

    The primary replicates every arena mutation (memory/operation logs,
    naming updates, atomics) before commit; on permanent primary failure the
    mirror's arena *is* a byte-exact replacement (paper §4.3).

    The mirror is also a *readable endpoint*: it is a separate
    physical blade with its own NIC (``link``), so replica-routed reads
    transfer against the mirror's capacity instead of contending with the
    primary's write traffic.  By default replication stays byte-synchronous
    (``lag_writes == 0``) and the mirror arena is identical to the primary
    at every instant — the invariant the failover tests pin down.  Setting
    ``lag_writes = N`` models an asynchronous replication channel that runs
    N physical writes behind: replicated bytes queue in arrival order and
    apply as newer writes push them through, so the mirror arena is always
    a *consistent prefix* of the primary's write stream.  The per-structure
    applied watermark (the mirror's copy of the ``{name}.seq`` slot) then
    genuinely lags the primary's committed tail, which is what the bounded-
    staleness read contract measures against.

    Channel v2 adds sim-*time* lag: ``set_lag_ns(d)`` stamps every queued
    unit with its arrival sim-time and holds it until ``now >= stamp + d``
    — the replication delay a real one-sided channel exhibits, independent
    of how bursty the write stream is.  Depth (``lag_writes``, kept as the
    compat alias/knob) and delay compose: a unit applies only when BOTH
    constraints release it.  Time-held units also drain on reads, so the
    mirror catches up as sim time advances even with no new writes.

    Prefix consistency alone is not enough for replica READS: a flush
    window's memory logs are write-merged (last value per address), so no
    intra-transaction write order keeps every pointer-before-payload
    dependency — a cut inside a transaction can expose a bucket pointer
    whose target bytes have not landed, making even *old*, watermark-
    covered keys unreachable mid-chain.  The channel therefore applies
    transactionally: writes tagged with a tx group queue as one unit and
    land all-or-none, exactly like ``tx_apply`` on recovery.  Lagging
    cuts land only on transaction boundaries, where the arena is the
    end-of-window state the ``{name}.opsn`` watermark describes.
    """

    def __init__(self, capacity: int, cost: Optional[CostModel] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(capacity, resolve_device(device))
        self.bytes_replicated = 0
        self.link = Link(cost or CostModel())
        self.lag_writes = 0   # replication-channel depth (0 = synchronous)
        self.lag_ns = 0.0     # apply-at delay in sim-time (0 = immediate)
        self.clock: Optional[Clock] = None  # attached by the owning backend
        # units of [arrival_stamp, [(addr, bytes), ...]]: a standalone
        # write, or a whole tx group (stamp = latest arrival in the group)
        self._pending: Deque[List] = collections.deque()
        self._n_pending = 0          # queued physical writes across all units
        self._open_group: Optional[int] = None  # tx id still streaming in

    @property
    def synchronous(self) -> bool:
        """True iff the channel applies writes at the instant they arrive —
        no depth, no delay, nothing queued.  The gate every staleness-
        sensitive fast path checks (caching, pins, columnar apply)."""
        return self.lag_writes <= 0 and self.lag_ns <= 0 and not self._pending

    def _now(self) -> float:
        return self.clock.now if self.clock is not None else 0.0

    def set_lag(self, n: int) -> None:
        """Re-depth the replication channel mid-run (lag-spike / stall
        injection): lowering the depth drains the excess immediately;
        raising it lets the queue deepen as subsequent writes arrive."""
        self.lag_writes = max(0, n)
        self._drain()

    def set_lag_ns(self, d: float) -> None:
        """Set the channel's apply-at delay in sim-time nanoseconds: a unit
        arriving at time t becomes applicable at t + d.  Lowering the delay
        releases newly-eligible units immediately."""
        self.lag_ns = max(0.0, d)
        self._drain()

    def apply(self, addr: int, data: Data, group: Optional[int] = None) -> None:
        if self.synchronous:
            self._apply_now(addr, data)
            return
        data = _host_bytes(data)
        now = self._now()
        if group is not None and group == self._open_group:
            unit = self._pending[-1]
            unit[0] = now  # whole group becomes eligible at its last arrival
            unit[1].append((addr, data))
        else:
            self._pending.append([now, [(addr, data)]])
            self._open_group = group
        self._n_pending += 1
        self._drain()

    def seal(self) -> None:
        """Close the open tx group: its unit is complete and may now apply
        (as a whole) when the channel depth pushes it through."""
        self._open_group = None
        self._drain()

    def _drain(self) -> None:
        now = self._now()
        while self._pending and self._n_pending > self.lag_writes:
            if len(self._pending) == 1 and self._open_group is not None:
                break  # the head unit is a tx still streaming: never split it
            stamp, unit = self._pending[0]
            if self.lag_ns > 0 and now < stamp + self.lag_ns:
                break  # head not yet eligible; later units are even younger
            self._pending.popleft()
            for a, d in unit:
                self._apply_now(a, d)
            self._n_pending -= len(unit)

    def _apply_now(self, addr: int, data: Data) -> None:
        self._put(addr, data)
        self.bytes_replicated += len(data)

    def sync(self) -> None:
        """Drain the replication channel (promotion barrier: everything the
        primary sent before dying has arrived by the time the mirror is
        promoted — in-flight bytes were sent, only unsent ones are lost,
        and a dead primary sends nothing)."""
        while self._pending:
            for a, d in self._pending.popleft()[1]:
                self._apply_now(a, d)
        self._n_pending = 0
        self._open_group = None

    def read(self, addr: int, size: int) -> bytes:
        if self.lag_ns > 0 and self._pending:
            self._drain()  # time-held units apply as sim time advances
        return self._get(addr, size)

    def word(self, addr: int) -> int:
        if self.lag_ns > 0 and self._pending:
            self._drain()
        return self._word(addr)


class NVMBackend(_Arena):
    """One NVM blade: arena + fixed API + replication + crash/recovery.

    The arena and the mirrors' live on `device`: the card unless
    ``device="cpu"`` (``repro_torch.device.resolve_device``; raises when no
    card is there)."""

    def __init__(
        self,
        capacity: int = 1 << 26,
        block_size: int = 256,
        cost: Optional[CostModel] = None,
        num_mirrors: int = 1,
        blade_id: int = 0,
        name_slots: int = NUM_NAME_SLOTS,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.cost = cost or CostModel()
        self.capacity = capacity
        self.block_size = block_size
        self.blade_id = blade_id
        self.num_name_slots = name_slots
        self.naming_end = name_slots * NAME_SLOT
        super().__init__(capacity, self.device)
        self.link = Link(self.cost)
        self.clock = Clock()
        self.stats = Stats()
        self.mirrors: List[Mirror] = [Mirror(capacity, self.cost, self.device)
                                      for _ in range(num_mirrors)]
        for m in self.mirrors:
            m.clock = self.clock  # time-lagged units drain against blade time
        self.alive = True
        self.permanent_failure = False
        # fail the next physical write after `fail_after` bytes (test hook);
        # when _torn_write_addr is set the tear waits for the write that
        # lands exactly on that arena address (watermark-slot targeting)
        self._torn_write_at: Optional[int] = None
        self._torn_write_after = 0
        self._torn_write_addr: Optional[int] = None
        # per-(address, window) atomic-op counts (same-address serialization);
        # windows older than _atomic_window are evicted as time advances
        self._atomic_contention: Dict = {}
        self._atomic_window = -1

        n_blocks = capacity // block_size
        self.bitmap_start = self.naming_end
        self.bitmap_len = (n_blocks + 7) // 8
        self.heap_start = _align(self.bitmap_start + self.bitmap_len, block_size)
        self.n_blocks = (capacity - self.heap_start) // block_size
        self._free: List[int] = []      # recycled single blocks
        self._next_fresh = 0            # bump pointer into never-used blocks
        self._names: Dict[str, int] = {}  # name -> slot index (cache of arena)
        self._log_areas: Dict[str, "LogArea"] = {}
        # tx group tag for the replication channel: writes inside one
        # tx_apply transaction share an id so lagging mirrors land the
        # whole tx or none of it (see Mirror)
        self._mirror_group: Optional[int] = None
        self._next_mirror_group = 0

    # ------------------------------------------------------------------ util
    def _check_alive(self) -> None:
        if not self.alive:
            raise CrashError("back-end blade is down")

    def _phys_write(self, addr: int, data: Data, replicate: bool = True) -> None:
        """The single choke point for arena mutation (torn-write fault hook).

        A dead blade accepts no writes: once a torn write (or crash) downs
        the blade, later writes raise instead of silently mutating the arena
        and the mirror — the mirror must stay at the last commit point.
        """
        if not self.alive:
            raise CrashError("back-end blade is down")
        if self._torn_write_at is not None:
            targeted = self._torn_write_addr
            if targeted is not None:
                if addr == targeted:
                    cut = self._torn_write_at
                    self._torn_write_at = None
                    self._torn_write_addr = None
                    # Targeted tears are aimed at a specific slot — usually a
                    # seq-watermark commit point — so both sides of the commit
                    # are expressible: word writes are persist-atomic on PM
                    # hardware, meaning the word lands whole (keep covers it)
                    # or not at all (the power loss preceded the persist);
                    # it is never torn mid-word.  Larger targeted writes tear
                    # at `cut` like the untargeted hook.  Either way the
                    # mirror is NOT updated: replication of this last write
                    # never left the dying blade.
                    if len(data) <= 8:
                        if cut >= len(data):
                            self._put(addr, data)
                        self.alive = False
                        return
                    self._put(addr, data[:cut])
                    self.alive = False
                    return
                # not the targeted slot: this write goes through untouched
            elif self._torn_write_after > 0:
                self._torn_write_after -= 1
            else:
                cut = self._torn_write_at
                self._torn_write_at = None
                if len(data) <= 8:
                    # 8-byte (word) writes are persist-atomic on PM hardware
                    # — commit-point slots (log heads, seq watermarks) land
                    # whole; the power loss follows the word.  The mirror is
                    # NOT updated: replication of this last word never left
                    # the dying blade, so the mirror stays at the previous
                    # commit point (each copy recovers consistently).
                    self._put(addr, data)
                    self.alive = False
                    return
                data = data[:cut]
                self._put(addr, data)
                self.alive = False  # power loss mid-write
                return
        self._put(addr, data)
        if replicate:
            for m in self.mirrors:
                m.apply(addr, data, self._mirror_group)
        self.clock.advance(self.cost.nvm_write_ns)

    # ------------------------------------------------------- one-sided verbs
    def read(self, addr: int, size: int) -> bytes:
        self._check_alive()
        return self._get(addr, size)

    def write(self, addr: int, data: bytes) -> None:
        self._check_alive()
        self._phys_write(addr, data)

    def atomic_read(self, addr: int) -> int:
        self._check_alive()
        return self._word(addr)

    def atomic_add(self, addr: int, delta: int) -> int:
        self._check_alive()
        old = self.atomic_read(addr)
        self._phys_write(addr, struct.pack("<Q", (old + delta) % (1 << 64)))
        return old

    def atomic_cas(self, addr: int, expected: int, new: int) -> bool:
        self._check_alive()
        old = self.atomic_read(addr)
        if old != expected:
            return False
        self._phys_write(addr, struct.pack("<Q", new))
        return True

    # --------------------------------------------------------- global naming
    def name_slot_addr(self, name: str) -> int:
        """Address of the 8-byte value slot for `name` (well-known location)."""
        if name in self._names:
            return self._names[name] * NAME_SLOT + 32
        key = name.encode()[:32].ljust(32, b"\x00")
        # linear probe over the fixed table; persist the key bytes.
        # Tombstoned slots are skipped while probing but remembered: a new
        # name reuses the first tombstone rather than growing the table.
        tomb: Optional[int] = None
        region = self._get(0, self.naming_end)  # the whole table: one copy
        for slot in range(self.num_name_slots):
            base = slot * NAME_SLOT
            cur = region[base : base + 32]
            if cur == key:
                self._names[name] = slot
                return base + 32
            if cur == NAME_TOMBSTONE:
                if tomb is None:
                    tomb = slot
                continue
            if cur == b"\x00" * 32:
                if tomb is not None:
                    slot, base = tomb, tomb * NAME_SLOT
                self._phys_write(base, key)
                self._names[name] = slot
                return base + 32
        if tomb is not None:
            self._phys_write(tomb * NAME_SLOT, key)
            self._names[name] = tomb
            return tomb * NAME_SLOT + 32
        raise RuntimeError("naming region full")

    def delete_name(self, name: str) -> bool:
        """Tombstone a naming slot (space reclaim of per-structure names
        after shard migration).  Returns False when the name is absent."""
        if not self.has_name(name):
            return False
        slot = self._names[name]
        base = slot * NAME_SLOT
        self._phys_write(base, NAME_TOMBSTONE + b"\x00" * 8)
        del self._names[name]
        return True

    def get_name(self, name: str) -> int:
        return self.atomic_read(self.name_slot_addr(name))

    def set_name(self, name: str, value: int) -> None:
        self._phys_write(self.name_slot_addr(name), struct.pack("<Q", value))

    def set_name_fenced(self, name: str, value: int,
                        epoch: Optional[int], fence: Optional[str]) -> None:
        """``set_name`` guarded by the write-lease fence: a stale writer
        must not advance a commit watermark (``{name}.seq``) after losing
        its lease — the watermark is what commits entry bytes, so fencing
        it closes the ack path even if log bytes already landed."""
        self._check_alive()
        self.check_fence(epoch, fence)
        self.set_name(name, value)

    def has_name(self, name: str) -> bool:
        """True iff `name` already occupies a naming slot (no allocation)."""
        if name in self._names:
            return True
        key = name.encode()[:32].ljust(32, b"\x00")
        region = self._get(0, self.naming_end)
        for slot in range(self.num_name_slots):
            base = slot * NAME_SLOT
            cur = region[base : base + 32]
            if cur == key:
                self._names[name] = slot
                return True
            if cur == b"\x00" * 32:
                return False
        return False

    # ------------------------------------------------------- replica endpoints
    # Mirror arenas as readable endpoints: a mirror is a separate
    # physical blade, so replica-routed reads neither require the primary to
    # be alive nor contend with its NIC.  The watermark helpers express the
    # bounded-staleness contract: the data a mirror serves reflects exactly
    # the ops at or below its copy of the ``{name}.seq`` slot (replication
    # preserves write order, and the primary writes that slot only after the
    # entry bytes it covers).
    def read_replica(self, addr: int, size: int, mirror_idx: int = 0) -> bytes:
        return self.mirrors[mirror_idx].read(addr, size)

    def replica_applied_seq(self, name: str, mirror_idx: int = 0) -> int:
        """The mirror's applied op-sequence watermark for structure `name`:
        its (possibly lagging) copy of the durable ``{name}.seq`` slot."""
        if not self.has_name(f"{name}.seq"):
            return 0
        return self.mirrors[mirror_idx].word(self.name_slot_addr(f"{name}.seq"))

    def replica_lag_ops(self, name: str, committed_seq: int, mirror_idx: int = 0) -> int:
        """Replica lag in acked ops: the caller's committed tail (its local
        op-sequence counter — the front-end owns the op stream, so this is
        free local knowledge) minus the mirror's applied watermark."""
        return max(0, committed_seq - self.replica_applied_seq(name, mirror_idx))

    def replica_whole_seq(self, name: str, mirror_idx: int = 0) -> int:
        """The highest op watermark whose DATA-AREA effects the mirror
        provably reflects: its (possibly lagging) copy of the
        ``{name}.opsn`` slot.  The combined flush orders each transaction's
        opsn write AFTER the data writes it covers, and replication
        preserves write order, so an opsn copy reading S means every
        in-place effect of ops <= S has applied on the mirror.  The
        ``{name}.seq`` watermark (``replica_applied_seq``) tracks commit
        durability — the op LOG replicated — which runs ahead of in-place
        application under batched flushes; replica reads serve from the
        data area, so read-your-writes pins and result-cache admission
        gate on this slot instead."""
        if not self.has_name(f"{name}.opsn"):
            return 0
        return self.mirrors[mirror_idx].word(self.name_slot_addr(f"{name}.opsn"))

    # ------------------------------------------------------------ named blobs
    # Variable-length persistent values (e.g. the cluster shard directory).
    # Stored in heap blocks; the naming region holds {addr, len}.  The slot
    # names avoid the ".addr" suffix so reboot() does not mistake a blob for
    # a log area.
    def put_blob(self, name: str, data: bytes) -> None:
        self._check_alive()
        nblocks = max(1, -(-len(data) // self.block_size))
        if self.has_name(f"{name}.blobaddr"):
            addr = self.get_name(f"{name}.blobaddr")
            # capacity is tracked separately from length: a shrunken blob
            # keeps its allocation, so regrowing must free ALL of it
            cap = self.get_name(f"{name}.blobcap")
            if nblocks > cap:
                self.free_blocks(addr, cap)
                addr = self.alloc_blocks(nblocks)
                self.set_name(f"{name}.blobcap", nblocks)
        else:
            addr = self.alloc_blocks(nblocks)
            self.set_name(f"{name}.blobcap", nblocks)
        self._phys_write(addr, data)
        self.set_name(f"{name}.blobaddr", addr)
        self.set_name(f"{name}.bloblen", len(data))

    def get_blob(self, name: str) -> Optional[bytes]:
        self._check_alive()
        if not self.has_name(f"{name}.blobaddr"):
            return None
        addr = self.get_name(f"{name}.blobaddr")
        length = self.get_name(f"{name}.bloblen")
        return self._get(addr, length)

    # ----------------------------------------------------- block allocation
    def alloc_blocks(self, n: int = 1) -> int:
        """Allocate `n` contiguous blocks; returns the arena address.

        The persistent bitmap is updated in the arena so allocation status
        survives a crash (paper §4.4: "persistent bitmap ... fast recovery").
        """
        self._check_alive()
        if n == 1 and self._free:
            b = self._free.pop()
            self._set_bits(b, 1, True)
            return self.heap_start + b * self.block_size
        # bump-allocate a (contiguous) run from never-used blocks
        if self._next_fresh + n > self.n_blocks:
            raise MemoryError(f"NVM blade out of blocks (need {n} contiguous)")
        lo = self._next_fresh
        self._next_fresh += n
        self._set_bits(lo, n, True)
        return self.heap_start + lo * self.block_size

    def free_blocks(self, addr: int, n: int = 1) -> None:
        self._check_alive()
        b0 = (addr - self.heap_start) // self.block_size
        self._set_bits(b0, n, False)
        self._free.extend(range(b0, b0 + n))

    def _set_bits(self, b0: int, n: int, val: bool) -> None:
        """Set or clear the bitmap bits of blocks b0 .. b0+n-1.

        The reference sets them one at a time, each a read-modify-write of
        its byte that it replicates as a 1-byte write.  Here the bytes that
        hold the run are read once and written once, and synchronous
        mirrors take them in one write with the reference's byte count;
        a lagging mirror queues the reference's 1-byte writes, one a bit,
        since its channel counts writes."""
        if n <= 0:
            return
        lo = self.bitmap_start + b0 // 8
        hi = self.bitmap_start + (b0 + n - 1) // 8 + 1
        cur = np.frombuffer(self._get(lo, hi - lo), dtype=np.uint8).copy()
        bits = np.unpackbits(cur, bitorder="little")
        first = b0 % 8
        bits[first : first + n] = 1 if val else 0
        new = np.packbits(bits, bitorder="little")
        self._put(lo, new.tobytes())
        if all(m.synchronous for m in self.mirrors):
            for m in self.mirrors:
                m._put(lo, new.tobytes())
                m.bytes_replicated += n
            return
        # one 1-byte write a bit: the byte as it stood after that bit's update
        for k in range(n):
            byte = (first + k) // 8
            mask = 1 << ((first + k) % 8)
            cur[byte] = (int(cur[byte]) | mask) if val else (int(cur[byte]) & (0xFF ^ mask))
            for m in self.mirrors:
                m.apply(lo + byte, bytes([cur[byte]]))

    # -------------------------------------------------------------- log areas
    def create_log_area(self, name: str, size_blocks: int) -> "LogArea":
        addr = self.alloc_blocks(size_blocks)
        area = LogArea(self, name, addr, size_blocks * self.block_size)
        # recycled blocks may hold stale bytes from a reclaimed area; log
        # decode relies on zeros terminating the scan, so scrub on create
        self._phys_write(addr, torch.zeros(area.size, dtype=torch.uint8, device=self.device))
        self._log_areas[name] = area
        self.set_name(f"{name}.addr", addr)
        self.set_name(f"{name}.size", area.size)
        self.set_name(f"{name}.head", 0)
        self.set_name(f"{name}.applied", 0)
        return area

    def get_log_area(self, name: str) -> "LogArea":
        return self._log_areas[name]

    # ------------------------------------------------- transactional interface
    def check_fence(self, epoch: Optional[int], fence: Optional[str]) -> None:
        """Reject a stale writer's append before any byte lands.

        `fence` names the structure's write-epoch slot (``{name}.wep``),
        stamped by the lease layer at every write-lease grant/steal; a
        caller whose `epoch` is below the slot lost its lease to a newer
        writer and its whole group commit must vanish — the asymmetric
        analogue of checking ownership metadata co-located with the data.
        The slot is pre-stamped at acquisition, so ``get_name`` here is a
        cached dict probe, not a naming-table scan.
        """
        if epoch is not None and fence is not None:
            if self.get_name(fence) > epoch:
                raise StaleWriterError(
                    f"write fenced: epoch {epoch} < {fence}={self.get_name(fence)}"
                )

    def tx_append(self, area: "LogArea", payload: bytes,
                  epoch: Optional[int] = None,
                  fence: Optional[str] = None) -> int:
        """Land a pre-encoded transaction (or op-log batch) in a log area.

        This is what a one-sided RDMA_Write into the log region does; the
        head pointer (LPN) bump is part of the same write on real hardware
        (the commit flag delimits entries), here modeled by the head slot.

        With `epoch`/`fence` the append is write-lease fenced: the blade
        compares the caller's writer epoch against the structure's fence
        slot and raises ``StaleWriterError`` instead of landing a stale
        writer's bytes (see ``check_fence``).
        """
        self._check_alive()
        self.check_fence(epoch, fence)
        if area.head + len(payload) > area.size:
            area.compact()
        while area.head + len(payload) > area.size:
            self._grow_area(area)  # log rotation onto a larger region
        off = area.head
        self._phys_write(area.addr + off, payload)
        if not self.alive:  # torn write tripped mid-append
            return off
        area.head = off + len(payload)
        self.set_name(f"{area.name}.head", area.head)
        return off

    def _grow_area(self, area: "LogArea") -> None:
        """Double a log area: allocate a fresh region, move the live suffix,
        update the global-naming pointers (log rotation)."""
        new_blocks = 2 * (area.size // self.block_size)
        new_addr = self.alloc_blocks(new_blocks)
        live = self.arena[area.addr + area.applied : area.addr + area.head]
        new_size = new_blocks * self.block_size
        # scrub before moving the live suffix in (recycled blocks may hold
        # stale log bytes that would decode as ghost records); the move is a
        # copy on the device
        moved = torch.zeros(new_size, dtype=torch.uint8, device=self.device)
        moved[: live.numel()] = live
        self._phys_write(new_addr, moved)
        self.free_blocks(area.addr, area.size // self.block_size)
        area.addr = new_addr
        area.size = new_blocks * self.block_size
        area.head = len(live)
        area.applied = 0
        self.set_name(f"{area.name}.addr", new_addr)
        self.set_name(f"{area.name}.size", area.size)
        self.set_name(f"{area.name}.head", area.head)
        self.set_name(f"{area.name}.applied", 0)

    def tx_apply(self, area: "LogArea") -> int:
        """Replay committed-but-unapplied memory logs into the data area.

        Runs on the blade (paper workflow step 6); front-ends never wait on
        it.  Returns the number of transactions applied.
        """
        self._check_alive()
        lo = area.addr + area.applied
        buf = self._get(lo, area.head - area.applied)
        # Columnar fast path: decode the host copy to (addr, offset, length)
        # arrays, verify the bodies the memo misses where they lie in the
        # arena (K1), and replay every run into the arena and the mirrors in
        # one launch (K2).  Only when the apply can't fault mid-stream (no
        # armed torn write) and every mirror is synchronous — then it is
        # byte- and clock-identical to the per-entry ``_phys_write`` loop,
        # which remains the fault-injection path.
        if self._torn_write_at is None and all(
            m.synchronous for m in self.mirrors
        ):
            with profile("log_decode"):
                addrs, offs, lens, n_txs, consumed = decode_txs_columnar(
                    buf, self._checksum_at(lo))
            with profile("apply_phase"):
                nvm_log.apply_runs([self.arena] + [m.arena for m in self.mirrors],
                                   self.arena[lo : lo + len(buf)], addrs, offs, lens)
                nbytes = int(lens.sum())
                for m in self.mirrors:
                    m.bytes_replicated += nbytes
            self.clock.advance(self.cost.nvm_write_ns * len(addrs))
        else:
            with profile("log_decode"):
                txs, consumed = decode_txs(buf, self._checksum_at(lo))
            n_txs = len(txs)
            nbytes = 0
            with profile("apply_phase"):
                try:
                    for tx in txs:
                        self._mirror_group = self._next_mirror_group
                        self._next_mirror_group += 1
                        for entry in tx:
                            self._phys_write(entry.addr, entry.data)
                            nbytes += len(entry.data)
                        for m in self.mirrors:
                            m.seal()
                finally:
                    self._mirror_group = None
        area.applied += consumed
        self.set_name(f"{area.name}.applied", area.applied)
        self.clock.advance(nbytes * self.cost.backend_apply_ns_per_byte)
        self.stats.tx_commits += n_txs
        return n_txs

    def _checksum_at(self, lo: int):
        """The ``decode_txs`` checksum hook for a buffer copied from arena
        offset `lo`: the bodies' Fletcher-64 from the arena itself (K1)."""
        def checksum(starts: np.ndarray, lens: np.ndarray) -> List[int]:
            return nvm_log.fletcher64_segments(self.arena, starts + lo, lens).tolist()
        return checksum

    # ------------------------------------------------------ crash / recovery
    def crash(self) -> None:
        """Transient power failure: volatile state is lost, the arena persists."""
        self.alive = False

    def fail_permanently(self) -> None:
        """Permanent blade failure (paper §4.3): the arena is gone; only a
        mirror promotion can bring the data back."""
        self.alive = False
        self.permanent_failure = True

    def schedule_torn_write(self, keep_bytes: int, after_writes: int = 0,
                            *, at_name: Optional[str] = None) -> None:
        """Fault hook: arm a torn write + power loss (paper §4.2).

        Counter form (default): after letting `after_writes` further physical
        writes through, the next one persists only its first `keep_bytes`
        bytes and the blade dies.  Landing on an 8-byte write it lands whole
        (word persist-atomicity), which makes the commit point itself
        untargetable — the write count to reach it depends on flush layout.

        Targeted form (``at_name``): the tear waits for the write that lands
        on `at_name`'s naming-slot value — e.g. ``"{s}.seq"``, the watermark
        slot a flush writes *after* its entry bytes — however many writes
        precede it.  For the 8-byte watermark, ``keep_bytes >= 8`` means the
        commit record persists before the power loss (group committed),
        ``keep_bytes < 8`` means it never lands (group must disappear on
        recovery); there is no torn middle ground.
        """
        if at_name is not None:
            self._torn_write_addr = self.name_slot_addr(at_name)
        else:
            self._torn_write_addr = None
        self._torn_write_at = keep_bytes
        self._torn_write_after = after_writes

    def cancel_torn_write(self) -> None:
        """Disarm a scheduled tear that never fired (end of a chaos window)."""
        self._torn_write_at = None
        self._torn_write_after = 0
        self._torn_write_addr = None

    def reboot(self) -> "NVMBackend":
        """Restart after a transient failure.

        Rebuild all volatile state from the arena: naming cache, free lists
        from the persistent bitmap, log-area heads; validate each log area's
        tail transaction by checksum and truncate torn appends; then replay
        any committed-but-unapplied memory logs (paper §7.5).
        """
        self.alive = True
        self._torn_write_at = None
        self._torn_write_after = 0
        self._torn_write_addr = None
        # naming cache
        self._names.clear()
        names: Dict[str, int] = {}
        region = self._get(0, self.naming_end)  # the whole table: one copy
        for slot in range(self.num_name_slots):
            base = slot * NAME_SLOT
            raw = region[base : base + 32]
            if raw == NAME_TOMBSTONE:
                continue  # deleted slot (reusable, not a live name)
            raw = raw.rstrip(b"\x00")
            if raw:
                names[raw.decode()] = slot
        self._names = names
        # allocation state from the persistent bitmap, read in one copy
        bitmap = np.frombuffer(self._get(self.bitmap_start, self.bitmap_len), dtype=np.uint8)
        bits = np.unpackbits(bitmap, bitorder="little")[: self.n_blocks]
        used = np.flatnonzero(bits)
        self._next_fresh = int(used[-1]) + 1 if used.size else 0
        self._free = np.flatnonzero(bits[: self._next_fresh] == 0).tolist()
        # log areas: validate tails, truncate torn bytes, replay
        areas = sorted({n.rsplit(".", 1)[0] for n in names if n.endswith(".addr")})
        self._log_areas = {}
        for name in areas:
            addr = self.get_name(f"{name}.addr")
            size = self.get_name(f"{name}.size")
            head = self.get_name(f"{name}.head")
            applied = self.get_name(f"{name}.applied")
            area = LogArea(self, name, addr, size)
            area.applied = applied
            if name.endswith(".oplog"):
                # op logs are replayed by the *front-end*; just trust head.
                area.head = head
            else:
                # a torn append may have landed bytes past the recorded head,
                # or head may have been bumped for a torn tx: scan + validate.
                buf = self._get(addr + applied, size - applied)
                _, consumed = decode_txs(buf, self._checksum_at(addr + applied))
                area.head = applied + consumed
                self.set_name(f"{name}.head", area.head)
            self._log_areas[name] = area
            if not name.endswith(".oplog"):
                self.tx_apply(area)
        return self

    def promote_mirror(self, idx: int = 0) -> "NVMBackend":
        """Permanent primary failure: build a fresh blade from a mirror."""
        # drain the replication channel first: bytes the primary sent before
        # dying are considered delivered (an async channel loses only what
        # was never sent — and _phys_write stops sending at death)
        self.mirrors[idx].sync()
        fresh = NVMBackend(
            self.capacity,
            self.block_size,
            self.cost,
            num_mirrors=len(self.mirrors),
            blade_id=self.blade_id,
            name_slots=self.num_name_slots,
            device=self.device,
        )
        fresh.arena.copy_(self.mirrors[idx].arena)  # arena to arena, on the device
        # the promoted primary's OWN mirror set must be re-seeded with the
        # full arena before it serves: replication only ships deltas, so a
        # fresh empty mirror that receives the first post-promotion seq-slot
        # write would advertise lag 0 while holding none of the data —
        # replica reads against it would return garbage
        for m in fresh.mirrors:
            m.arena.copy_(fresh.arena)
        return fresh.reboot()


class LogArea:
    """An append-only log region inside a blade's arena."""

    def __init__(self, backend: NVMBackend, name: str, addr: int, size: int):
        self.backend = backend
        self.name = name
        self.addr = addr
        self.size = size
        self.head = 0      # append offset
        self.applied = 0   # replay watermark (LPN)

    def compact(self) -> None:
        """Drop fully-applied prefix (checkpointing the log).

        Only the previously-written extent ([0, old head)) needs rewriting:
        the live suffix slides to the front and the rest of that extent is
        zeroed so recovery's scan still terminates; bytes past the old head
        were never written (areas are scrubbed at create/grow) and stay
        zero — avoiding a full-area rewrite on every checkpoint is a large
        wall-clock win for long runs with big log areas."""
        extent = min(self.head, self.size)
        be = self.backend
        live = be.arena[self.addr + self.applied : self.addr + self.head]
        moved = torch.zeros(extent, dtype=torch.uint8, device=be.device)
        moved[: live.numel()] = live  # the slide is a copy on the device
        be._phys_write(self.addr, moved)
        self.head -= self.applied
        self.applied = 0
        self.backend.set_name(f"{self.name}.head", self.head)
        self.backend.set_name(f"{self.name}.applied", 0)

    def read_unapplied(self) -> bytes:
        return self.backend._get(self.addr + self.applied, self.head - self.applied)

    def read_all(self) -> bytes:
        return self.backend._get(self.addr, self.head)


def _align(x: int, a: int) -> int:
    return (x + a - 1) // a * a
