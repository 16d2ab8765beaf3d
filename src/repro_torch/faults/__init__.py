"""Deterministic fault injection for the rNVM simulator.

The framework turns the fault hooks scattered through the stack —
``Link.inject()`` (WQE drops/dups, NIC stalls), ``NVMBackend.crash`` /
``fail_permanently`` / ``schedule_torn_write``, ``Mirror.set_lag``,
``NVMCluster.revoke_leases`` — into *schedules*: a seeded
:class:`FaultPlan` decides up front which faults fire before which
operation, and a :class:`FaultInjector` arms them as the workload runs,
recording every injection as an obs counter and a trace instant on the
cluster track.  The same seed always produces the same schedule against
the same workload, so any chaos failure replays exactly.

``harness.run_chaos_schedule`` is the capstone: a random op sequence
against a random fault schedule, checked against the durability oracle
(every acknowledged op survives recovery and re-attach; unacknowledged
ops may land or vanish but never tear; the surviving state equals a
fault-free replay of the acked prefix).
"""

from .plan import ALL_FAULT_KINDS, FaultPlan, FaultSpec
from .inject import FaultInjector
from .harness import ChaosResult, run_chaos_schedule, run_steal_schedule

__all__ = [
    "ALL_FAULT_KINDS",
    "FaultPlan",
    "FaultSpec",
    "FaultInjector",
    "ChaosResult",
    "run_chaos_schedule",
    "run_steal_schedule",
]
