"""Remote persistent FIFO queue (paper §8.1).

Linked list with head (dequeue end) and tail (enqueue end) pointers in
naming slots.  With batching, pending enqueues stay local until the flush
boundary; a dequeue that reaches the pending window annihilates the oldest
pending enqueue.  Materialization links the whole pending chain with one
write per node plus a single rewrite of the old tail.
"""

from __future__ import annotations

import struct

from ..frontend import FrontEnd
from .base import RemoteStructure

OP_ENQ = 1
OP_DEQ = 2

NODE = struct.Struct("<qQ")  # value, next
NODE_SIZE = NODE.size


class RemoteQueue(RemoteStructure):
    REPLAY = {OP_ENQ: "_replay_enq", OP_DEQ: "_replay_deq"}

    def __init__(self, fe: FrontEnd, name: str, create: bool = True):
        super().__init__(fe, name)
        be = fe.backend
        self._head_slot = be.name_slot_addr(f"{name}.head")
        self._tail_slot = be.name_slot_addr(f"{name}.tail")
        if create:
            be.set_name(f"{name}.head", 0)
            be.set_name(f"{name}.tail", 0)
            self._head = self._tail = 0
        else:
            self._head = be.get_name(f"{name}.head")
            self._tail = be.get_name(f"{name}.tail")
        self._pending: list[int] = []
        if fe.cfg.use_batch:
            self.h.pre_flush = self._materialize

    # ------------------------------------------------------------------- ops
    def enqueue(self, value: int) -> None:
        self.fe.op_begin(self.h, OP_ENQ, self.encode_args(value))
        if self.fe.cfg.use_batch:
            self._pending.append(value)
        else:
            self._enq_base(value)
        self.fe.op_commit(self.h)

    def dequeue(self):
        self.fe.op_begin(self.h, OP_DEQ, b"")
        if self._head:
            value = self._deq_base()
        elif self._pending:
            value = self._pending.pop(0)  # annihilates a pending enqueue
            self.fe.stats.ops_annulled += 2
        else:
            value = None
        self.fe.op_commit(self.h)
        return value

    # ------------------------------------------------------------ primitives
    def _enq_base(self, value: int) -> None:
        addr = self.fe.alloc(NODE_SIZE)
        self.fe.write(self.h, addr, NODE.pack(value, 0))
        if self._tail:
            tval, _ = NODE.unpack(self.fe.read(self.h, self._tail, NODE_SIZE))
            self.fe.write(self.h, self._tail, NODE.pack(tval, addr))
        else:
            self._head = addr
            self.fe.write(self.h, self._head_slot, struct.pack("<Q", addr))
        self._tail = addr
        self.fe.write(self.h, self._tail_slot, struct.pack("<Q", addr))

    def _deq_base(self):
        if not self._head:
            return None
        value, nxt = NODE.unpack(self.fe.read(self.h, self._head, NODE_SIZE))
        self.fe.free(self._head, NODE_SIZE)
        self._head = nxt
        self.fe.write(self.h, self._head_slot, struct.pack("<Q", nxt))
        if not nxt:
            self._tail = 0
            self.fe.write(self.h, self._tail_slot, struct.pack("<Q", 0))
        return value

    def _materialize(self) -> None:
        if not self._pending:
            return
        addrs = [self.fe.alloc(NODE_SIZE) for _ in self._pending]
        for i, (addr, v) in enumerate(zip(addrs, self._pending)):
            nxt = addrs[i + 1] if i + 1 < len(addrs) else 0
            self.fe.write(self.h, addr, NODE.pack(v, nxt))
        if self._tail:
            tval, _ = NODE.unpack(self.fe.read(self.h, self._tail, NODE_SIZE))
            self.fe.write(self.h, self._tail, NODE.pack(tval, addrs[0]))
        else:
            self._head = addrs[0]
            self.fe.write(self.h, self._head_slot, struct.pack("<Q", addrs[0]))
        self._tail = addrs[-1]
        self.fe.write(self.h, self._tail_slot, struct.pack("<Q", addrs[-1]))
        self._pending.clear()

    # ---------------------------------------------------------------- replay
    def _replay_enq(self, value: int) -> None:
        self._enq_base(value)

    def _replay_deq(self) -> None:
        self._deq_base()
