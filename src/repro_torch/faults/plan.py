"""Seeded fault schedules.

A :class:`FaultPlan` is a list of :class:`FaultSpec` events sorted by the
operation index at which they fire.  Plans are pure data — building one
touches no simulator state — so a schedule can be printed, persisted next
to a failing seed, and replayed exactly.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

#: every fault class the injector knows how to arm.
ALL_FAULT_KINDS: Tuple[str, ...] = (
    "wqe_drop",        # completion(s) lost on a blade link -> timeout+resend
    "wqe_dup",         # duplicated WQE burns link capacity + issue time
    "nic_stall",       # blade NIC unresponsive for a sim-time window
    "crash",           # transient power loss: volatile state gone, arena kept
    "perm_fail",       # permanent blade failure: only a mirror can recover
    "nic_dead",        # blade alive but unreachable: every completion dropped
    "lag_spike",       # mirror replication lag jumps to a deep queue
    "repl_stall",      # replication queue stalls, drains after a window
    "lease_expiry",    # directory leases revoked mid-traffic (reconfig race)
    "torn_write",      # power loss mid-flush at an arbitrary byte offset
    "torn_watermark",  # tear targeted at a structure's seq-watermark slot
)


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire `kind` just before operation `at_op`.

    `blade` picks the victim blade (or, for mirror/torn-watermark faults,
    the shard whose blade is resolved at fire time); `a` and `b` are
    kind-specific magnitudes drawn by the plan generator so the spec stays
    a flat, printable record."""

    kind: str
    at_op: int
    blade: int = 0
    a: int = 0
    b: int = 0


@dataclass
class FaultPlan:
    """An ordered fault schedule plus the seed that produced it."""

    seed: int
    specs: List[FaultSpec] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.specs.sort(key=lambda s: (s.at_op, s.kind, s.blade))

    def __len__(self) -> int:
        return len(self.specs)

    def kinds(self) -> List[str]:
        return sorted({s.kind for s in self.specs})

    @classmethod
    def random(
        cls,
        seed: int,
        n_ops: int,
        n_blades: int,
        *,
        n_faults: int = 6,
        kinds: Optional[Sequence[str]] = None,
        ensure: Sequence[str] = (),
    ) -> "FaultPlan":
        """Draw a schedule: `n_faults` events over `n_ops` operations and
        `n_blades` victim blades.  `kinds` restricts the pool; `ensure`
        forces at least one event of each listed kind (placed in the first
        half of the run so its reaction — e.g. an auto-promotion — has
        operations left to complete against)."""
        rng = random.Random(seed)
        pool = list(kinds if kinds is not None else ALL_FAULT_KINDS)
        specs: List[FaultSpec] = []
        for kind in ensure:
            specs.append(cls._draw(rng, kind, n_blades,
                                   rng.randrange(1, max(2, n_ops // 2))))
        for _ in range(max(0, n_faults - len(specs))):
            specs.append(cls._draw(rng, rng.choice(pool), n_blades,
                                   rng.randrange(n_ops)))
        return cls(seed=seed, specs=specs)

    @staticmethod
    def _draw(rng: random.Random, kind: str, n_blades: int, at_op: int) -> FaultSpec:
        blade = rng.randrange(n_blades)
        if kind == "wqe_drop":
            return FaultSpec(kind, at_op, blade, a=rng.randrange(1, 3))
        if kind == "wqe_dup":
            return FaultSpec(kind, at_op, blade, a=rng.randrange(1, 4))
        if kind == "nic_stall":
            return FaultSpec(kind, at_op, blade, a=rng.randrange(50_000, 400_000))
        if kind == "lag_spike":
            return FaultSpec(kind, at_op, blade,
                             a=rng.randrange(4, 64), b=rng.randrange(8))
        if kind == "repl_stall":
            # b = window, in ops, after which the queue drains
            return FaultSpec(kind, at_op, blade,
                             a=rng.randrange(8), b=rng.randrange(4, 20))
        if kind == "torn_write":
            return FaultSpec(kind, at_op, blade,
                             a=rng.randrange(25), b=rng.randrange(4))
        if kind == "torn_watermark":
            # a picks the shard, b picks which side of the commit point the
            # tear lands on (0 -> watermark never persists, 1 -> it does)
            return FaultSpec(kind, at_op, blade,
                             a=rng.randrange(1 << 16), b=rng.randrange(2))
        # crash / perm_fail / nic_dead / lease_expiry carry no magnitudes
        return FaultSpec(kind, at_op, blade)
