"""repro_torch.cluster: a multi-blade sharded NVM cluster.

Turns the single-blade asymmetric-NVM simulator into a pooled deployment
(paper §4.3): an epoch-versioned shard directory persisted on every blade,
a front-end-side router owning one FrontEnd per blade, sharded structure
wrappers over the existing single-shard structures, permanent-failure
handling via mirror promotion + log replay, and online shard migration for
elastic scale-out.
"""

from ..core.frontend import ReadPolicy
from .directory import DIRECTORY_NAME, LEASES_NAME, LeaseTable, ShardDirectory
from .failover import blade_health, promote_blade
from .rebalance import migrate_shard, rebalance
from .router import ClusterFrontEnd, ClusterWaveScheduler, NVMCluster
from .sharded import (ShardedBPTree, ShardedHashTable, ShardedMVBPTree,
                      ShardedStructure)

__all__ = [
    "ShardDirectory",
    "DIRECTORY_NAME",
    "LeaseTable",
    "LEASES_NAME",
    "ReadPolicy",
    "NVMCluster",
    "ClusterFrontEnd",
    "ClusterWaveScheduler",
    "ShardedStructure",
    "ShardedHashTable",
    "ShardedBPTree",
    "ShardedMVBPTree",
    "promote_blade",
    "blade_health",
    "migrate_shard",
    "rebalance",
]
