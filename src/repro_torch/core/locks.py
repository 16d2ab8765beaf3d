"""Writer-preferred sequence lock (paper §9.2, Algorithm 3).

An 8-byte sequence number (SN) lives at a well-known naming slot on the
blade.  The (single) writer increments it with an atomic on lock *and*
unlock, so SN is odd exactly while a write is in flight.  Readers spin until
SN is even, remember it, and validate after reading: a changed SN means the
snapshot may be torn and the read must retry.  The writer is never blocked
(writer-preferred); readers pay retries under write pressure — the effect
measured in paper Fig. 9a.

Multi-writer extension (``acquire_writer``/``release_writer``): when a shard
runs in *shared* write-lease mode (contended range, lease ping-pong would
thrash), concurrent writer front-ends serialize through a CAS mutex on a
second well-known slot (``{name}.wlk``, 0 = free, else holder token).  The
blade's same-address atomic serialization prices the contention (CAS storms
cost sim-time); the seqlock keeps doing reader-side consistency.
"""

from __future__ import annotations

from .frontend import FrontEnd


class WriterPreferredLock:
    def __init__(self, fe: FrontEnd, name: str):
        self.fe = fe
        self.addr = fe.backend.name_slot_addr(f"{name}.sn")
        self.lock_addr = fe.backend.name_slot_addr(f"{name}.wlk")

    # writer side ----------------------------------------------------------
    def writer_lock(self) -> None:
        self.fe.atomic_add(self.addr, 1)

    def writer_unlock(self) -> None:
        self.fe.atomic_add(self.addr, 1)

    # writer-writer mutual exclusion ---------------------------------------
    def acquire_writer(self, max_spins: int = 64) -> None:
        """Take the writer mutex with a one-sided CAS (0 -> holder token).

        Callers hold the mutex only across one op window (ops + drain), so
        a failed CAS means another front-end is mid-window; spin with the
        op-timeout backoff charged to the clock.  Exhausting the spins
        means a holder died without unlocking — the write-lease layer above
        recovers that by fencing, so surface it loudly here.
        """
        fe = self.fe
        token = fe.fe_id + 1  # nonzero holder id
        for _ in range(max_spins):
            if fe.atomic_cas(self.lock_addr, 0, token):
                return
            fe.clock.advance(fe.cost.op_timeout_ns)
        raise RuntimeError(f"writer mutex: holder never released {fe.fe_id}")

    def release_writer(self) -> None:
        fe = self.fe
        fe.atomic_cas(self.lock_addr, fe.fe_id + 1, 0)

    # reader side ----------------------------------------------------------
    def reader_begin(self) -> int:
        while True:
            sn = self.fe.atomic_read(self.addr)
            if sn % 2 == 0:
                return sn
            self.fe.stats.reader_retries += 1

    def reader_validate(self, start_sn: int) -> bool:
        return self.fe.atomic_read(self.addr) == start_sn

    def read_consistent(self, fn, max_retries: int = 64):
        """Run `fn()` under the seqlock until a consistent snapshot lands."""
        for _ in range(max_retries):
            sn = self.reader_begin()
            out = fn()
            if self.reader_validate(sn):
                return out
            self.fe.stats.reader_retries += 1
        raise RuntimeError("seqlock: too many retries")
