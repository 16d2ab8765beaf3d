"""Online shard migration: copy + op-log catch-up + epoch swap.

Elastic scale-out (ROADMAP: "grow capacity by adding blades") moves shards
onto new blades *while writes keep landing*:

  1. **Snapshot copy** — drain the source shard (its data area now reflects
     every acked op, watermarked by the shard's op-sequence number), then
     bulk-copy its items into a same-named structure on the destination
     blade.
  2. **Log-replay catch-up** — ops that raced with the copy are sitting in
     the source's op-log area with sequence numbers above the snapshot
     watermark; replay just that tail onto the destination through the
     structure's own REPLAY table (the same machinery front-end crash
     recovery uses).
  3. **Epoch swap** — flip the directory assignment, bump the epoch, and
     re-persist the directory to every blade.  Every front-end's next op
     sees the stale epoch, rebinds, and routes to the destination.
  4. **Space reclaim** — once no front-end can route to the source (the
     epoch swap is done), the tombstoned source copy's blocks — data nodes,
     bucket array, both log areas — are freed back to the source blade's
     allocator and its naming slots are tombstoned; only the ``*.moved_to``
     marker stays behind.

The catch-up window is observable in tests via the ``during_copy`` hook,
which runs after the snapshot and before catch-up — the simulator's stand-in
for concurrent front-ends writing mid-migration.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..core.backend import CrashError
from ..core.oplog import committed_tail
from .. import obs
from .sharded import ShardedStructure


def _copy_op(obj) -> Callable[[int, int], None]:
    return obj.put if hasattr(obj, "put") else obj.insert


def migrate_shard(
    sharded: ShardedStructure,
    shard: int,
    dst_blade: int,
    during_copy: Optional[Callable[[], None]] = None,
) -> Dict[str, int]:
    """Move one shard of `sharded` to `dst_blade`; returns migration stats."""
    cfe = sharded.cfe
    cluster = cfe.cluster
    directory = cluster.directory
    if dst_blade not in cluster.blades or not cluster.blades[dst_blade].alive:
        raise CrashError(f"destination blade {dst_blade} unavailable")
    tr = cfe.trace
    t0 = cfe.clock.now
    cfe.ensure_fresh()
    src_blade = directory.blade_of(shard)
    stats = {"shard": shard, "src": src_blade, "dst": dst_blade,
             "copied": 0, "caught_up": 0, "reclaimed_blocks": 0}
    if src_blade == dst_blade:
        return stats

    src_obj = sharded._get_shard(shard, create_if_missing=False)
    if src_obj is not None:
        # -- 1. snapshot copy --------------------------------------------
        src_fe = src_obj.fe
        src_fe.clock.advance_to(cfe.clock.now)
        src_fe.drain(src_obj.h)
        snapshot_seq = src_obj.h.seq
        items = src_obj.items()
        cfe.clock.advance_to(src_fe.clock.now)

        dst_fe = cfe.fe_for_blade(dst_blade)
        dst_fe.clock.advance_to(cfe.clock.now)
        dst_obj = sharded._create(dst_fe, sharded._shard_name(shard))
        copy = _copy_op(dst_obj)
        for k, v in items:
            copy(k, v)
        dst_fe.drain(dst_obj.h)
        cfe.clock.advance_to(dst_fe.clock.now)
        stats["copied"] = len(items)

        # -- simulated concurrent writes during the copy window ----------
        if during_copy is not None:
            during_copy()

        # -- 2. op-log catch-up ------------------------------------------
        # quiesce barrier: force every registered front-end to flush its
        # staged channel to the source blade, so acked-but-unflushed writes
        # (e.g. ops sitting inside an op-log group window) reach the source
        # op log before we read the catch-up tail — otherwise they would be
        # silently drained to the tombstoned source after the epoch swap
        cluster.quiesce_blade(src_blade)
        # re-read the source op log: entries past the snapshot watermark
        # arrived mid-copy (from any front-end sharing this shard).
        # committed_tail applies the same commit guards as crash recovery:
        # capped at the durable {name}.seq watermark (torn-window ghost
        # entries the source's own recovery would discard are not replayed
        # onto the destination) and deduplicated by seq last-wins.
        src_fe.clock.advance_to(cfe.clock.now)
        durable = cluster.blades[src_blade].get_name(f"{src_obj.name}.seq")
        tail = committed_tail(src_obj.h.oplog_area.read_all(), snapshot_seq, durable)
        cfe.clock.advance_to(src_fe.clock.now)
        if tail:
            dst_fe.clock.advance_to(cfe.clock.now)
            dst_obj.replay(tail)
            dst_fe.drain(dst_obj.h)
            cfe.clock.advance_to(dst_fe.clock.now)
        stats["caught_up"] = len(tail)

        # tombstone the source copy until the epoch swap below makes it
        # unroutable, then reclaim its blocks (step 4)
        cluster.blades[src_blade].set_name(
            f"{sharded._shard_name(shard)}.moved_to", dst_blade
        )
        sharded._shards.pop(shard, None)
    elif during_copy is not None:
        during_copy()

    # -- 3. epoch swap ----------------------------------------------------
    # revoke-before-swap: every outstanding directory lease is invalidated
    # (broadcast cost on this front-end's clock) BEFORE the assignment
    # flips, so no lease holder validating locally can route another op at
    # the source copy we are about to tombstone and reclaim.  The moved
    # shard rides the broadcast as the invalidation group: result caches
    # drop exactly this shard's entries, nothing else.
    cluster.revoke_leases(cfe.clock, shards=(shard,))
    directory.assign(shard, dst_blade)
    directory.bump_epoch()
    directory.persist(cluster.blades)
    cluster.migrations += 1

    # -- 4. space reclaim --------------------------------------------------
    if src_obj is not None:
        src_be = cluster.blades[src_blade]
        free_before = len(src_be._free)
        try:
            src_fe.clock.advance_to(cfe.clock.now)
            src_obj.destroy_storage()
            cfe.clock.advance_to(src_fe.clock.now)
            stats["reclaimed_blocks"] = len(src_be._free) - free_before
        except CrashError:
            pass  # source blade died mid-reclaim: nothing left to free

    obs.count("migrations")
    if tr is not None:
        tr.span(cfe._track, "migration", t0, cfe.clock.now,
                {"shard": shard, "src": src_blade, "dst": dst_blade,
                 "copied": stats["copied"], "caught_up": stats["caught_up"]})
        tr.instant(cluster._track, "migration", cfe.clock.now,
                   {"shard": shard, "src": src_blade, "dst": dst_blade})
    return stats


def rebalance(sharded: ShardedStructure) -> Dict[int, int]:
    """Even out shard placement across live blades (used after add_blade),
    weighted by observed load: each shard weighs 1 + the data-path ops the
    authoritative directory has seen routed at it
    (``ShardDirectory.record_ops``), so a blade hosting two hot shards
    sheds one to a blade hosting ten cold ones — instead of evening raw
    shard counts and calling an obviously skewed placement balanced.

    Greedy: repeatedly move the heaviest shard that still *strictly
    reduces* the load variance (a shard of weight w moves from the
    heaviest to the lightest blade only when ``w < heaviest - lightest``,
    which is exactly the sum-of-squares descent condition, so the loop
    terminates).  With uniform weights (no recorded traffic) this
    degenerates to the old count-evening behaviour.  Returns
    {shard: dst_blade} for every move."""
    cfe = sharded.cfe
    cluster = cfe.cluster
    directory = cluster.directory
    moves: Dict[int, int] = {}
    tr = cfe.trace
    t0 = cfe.clock.now
    while True:
        weights = {
            b: w for b, w in directory.load_weights().items()
            if cluster.blades[b].alive
        }
        hi = max(weights, key=lambda b: (weights[b], b))
        lo = min(weights, key=lambda b: (weights[b], b))
        gap = weights[hi] - weights[lo]
        movable = [
            (directory.shard_weight(s), -s, s)
            for s in directory.shards_on(hi)
            if directory.shard_weight(s) < gap
        ]
        if not movable:
            if tr is not None and moves:
                tr.span(cfe._track, "rebalance", t0, cfe.clock.now,
                        {"moves": len(moves)})
            return moves
        shard = max(movable)[2]  # heaviest improving shard (ties: lowest id)
        migrate_shard(sharded, shard, lo)
        moves[shard] = lo
