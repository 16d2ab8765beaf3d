"""Asymmetric persistent state store: the paper's architecture over
training/serving state, with the JAX package's on-disk format."""

from ..tree import flatten_named
from .blade import Blade, FileBlade, MemoryBlade, fletcher32_padded
from .checkpoint import CheckpointManager
from .store import AsymStore

__all__ = ["Blade", "FileBlade", "MemoryBlade", "AsymStore",
           "CheckpointManager", "flatten_named", "fletcher32_padded"]
