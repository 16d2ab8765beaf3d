"""rNVM core: asymmetric NVM architecture, reproduced faithfully.

Back-end blades (`NVMBackend`) hold all persistent state and expose only the
paper's fixed API; front-ends (`FrontEnd`) run the Gather-Apply workflow with
operation-log Reproducing (R), Caching (C) and Batching (B).
"""

from .allocator import FrontEndAllocator
from .backend import CrashError, LogArea, Mirror, NVMBackend
from .cache import PageCache
from .frontend import (CircuitBreaker, EndpointUnreachable, FEConfig, FrontEnd,
                       LinkTimeout, ReadPolicy, ReadTarget, StructHandle)
from .locks import WriterPreferredLock
from .oplog import MemLog, OpLog, decode_oplogs, decode_txs, encode_oplog, encode_tx, fletcher64
from .sim import Clock, CostModel, Link, Stats

__all__ = [
    "NVMBackend",
    "Mirror",
    "LogArea",
    "CrashError",
    "FrontEnd",
    "FEConfig",
    "CircuitBreaker",
    "LinkTimeout",
    "EndpointUnreachable",
    "ReadPolicy",
    "ReadTarget",
    "StructHandle",
    "FrontEndAllocator",
    "PageCache",
    "WriterPreferredLock",
    "CostModel",
    "Clock",
    "Link",
    "Stats",
    "MemLog",
    "OpLog",
    "fletcher64",
    "encode_tx",
    "decode_txs",
    "encode_oplog",
    "decode_oplogs",
]
