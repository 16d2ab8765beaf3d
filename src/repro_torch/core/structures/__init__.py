"""The paper's eight remote persistent data structures."""

from .base import RemoteStructure, mix64
from .bptree import RemoteBPTree
from .bst import RemoteBST
from .hashtable import RemoteHashTable
from .mv_bpt import RemoteMVBPTree
from .mv_bst import RemoteMVBST
from .queue import RemoteQueue
from .skiplist import RemoteSkipList
from .stack import RemoteStack

ALL_STRUCTURES = {
    "stack": RemoteStack,
    "queue": RemoteQueue,
    "hashtable": RemoteHashTable,
    "skiplist": RemoteSkipList,
    "bst": RemoteBST,
    "bptree": RemoteBPTree,
    "mv_bst": RemoteMVBST,
    "mv_bpt": RemoteMVBPTree,
}

__all__ = [
    "RemoteStructure",
    "RemoteStack",
    "RemoteQueue",
    "RemoteHashTable",
    "RemoteSkipList",
    "RemoteBST",
    "RemoteBPTree",
    "RemoteMVBST",
    "RemoteMVBPTree",
    "ALL_STRUCTURES",
    "mix64",
]
