"""Permanent-failure handling: promote a blade's mirror to primary.

The paper's availability story (§4.3): the primary replicates every arena
mutation to its mirror(s) before commit, so on a permanent primary failure
the mirror's arena is a byte-exact replacement.  Promotion reuses the
single-blade machinery end to end:

  1. ``NVMBackend.promote_mirror`` clones the mirror arena into a fresh
     blade object and runs ``reboot()`` — which rebuilds the naming cache
     and allocator from persistent bytes, truncates torn log tails by
     checksum (``decode_txs``), and replays committed-but-unapplied memory
     logs.
  2. The cluster swaps the fresh blade in under the same blade id and bumps
     the directory epoch; the new directory is re-persisted to every live
     blade.
  3. Every ``ClusterFrontEnd`` notices the epoch bump on its next op,
     rebinds its per-blade front-ends, and the sharded structures replay the
     op-log tail (ops whose memory logs never committed) through the
     existing ``RemoteStructure.recover`` path — so no *committed* op is
     lost, exactly as in the single-blade crash tests.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from ..core.backend import NVMBackend
from ..core.sim import Clock
from .. import obs

if TYPE_CHECKING:  # pragma: no cover
    from .router import NVMCluster


def promote_blade(cluster: "NVMCluster", blade_id: int, mirror_idx: int = 0,
                  clock: Optional[Clock] = None) -> NVMBackend:
    """Swap blade `blade_id`'s mirror in as the new primary.

    Lease protocol: every outstanding directory lease is revoked (and the
    invalidation broadcast paid) BEFORE the fresh blade is swapped in and
    the epoch bumped — a lease holder skipping per-op validation must never
    route another op at the dead primary's binding.  The failed blade's
    shard set rides the broadcast as the invalidation groups, so result
    caches drop exactly the entries whose home just changed hands."""
    cluster.revoke_leases(clock,
                          shards=cluster.directory.shards_on(blade_id))
    old = cluster.blades[blade_id]
    # promote_mirror re-seeds the fresh blade's own mirror set with the full
    # arena, so replication fan-in (and replica reads) continue correctly
    fresh = old.promote_mirror(mirror_idx)
    cluster.blades[blade_id] = fresh
    cluster.failovers += 1
    cluster.directory.bump_epoch()
    cluster.directory.persist(cluster.blades)
    obs.count("failovers")
    if cluster.trace is not None:
        cluster.trace.instant(cluster._track, "promotion",
                              clock.now if clock is not None else None,
                              {"blade": blade_id, "mirror": mirror_idx})
    return fresh


def blade_health(cluster: "NVMCluster") -> dict:
    """Snapshot used by the availability benchmark trace."""
    return {
        bid: ("up" if be.alive else ("failed" if be.permanent_failure else "down"))
        for bid, be in cluster.blades.items()
    }
