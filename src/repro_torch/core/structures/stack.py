"""Remote persistent stack (paper §8.1).

Linked list with the head pointer at a well-known naming slot.  Structure-
specific optimizations: the head node is the only hot node (the read path
caches it automatically), and with batching the pending pushes are held
locally so push/pop pairs *annihilate* before any memory log is generated —
the compaction leaves only effective logs.  Op logs still record every
logical operation (a push/pop pair replays to a no-op, so recovery stays
correct).
"""

from __future__ import annotations

import struct

from ..frontend import FrontEnd
from .base import RemoteStructure

OP_PUSH = 1
OP_POP = 2

NODE = struct.Struct("<qQ")  # value, next
NODE_SIZE = NODE.size


class RemoteStack(RemoteStructure):
    REPLAY = {OP_PUSH: "_replay_push", OP_POP: "_replay_pop"}

    def __init__(self, fe: FrontEnd, name: str, create: bool = True):
        super().__init__(fe, name)
        if create:
            self.fe.backend.set_name(f"{name}.root", 0)
            self._head = 0
        else:
            self._head = self.read_root()
        self._pending: list[int] = []
        if fe.cfg.use_batch:
            self.h.pre_flush = self._materialize

    def __len__(self) -> int:
        n, cur = len(self._pending), self._head
        while cur:
            _, cur = NODE.unpack(self.fe.read(self.h, cur, NODE_SIZE))
            n += 1
        return n

    # ------------------------------------------------------------------- ops
    def push(self, value: int) -> None:
        self.fe.op_begin(self.h, OP_PUSH, self.encode_args(value))
        if self.fe.cfg.use_batch:
            self._pending.append(value)
        else:
            self._push_base(value)
        self.fe.op_commit(self.h)

    def pop(self):
        self.fe.op_begin(self.h, OP_POP, b"")
        if self._pending:
            value = self._pending.pop()  # annihilates a pending push
            self.fe.stats.ops_annulled += 2
        else:
            value = self._pop_base()
        self.fe.op_commit(self.h)
        return value

    def peek(self):
        if self._pending:
            return self._pending[-1]
        if not self._head:
            return None
        value, _ = NODE.unpack(self.fe.read(self.h, self._head, NODE_SIZE))
        return value

    # ------------------------------------------------------------ primitives
    def _push_base(self, value: int) -> None:
        addr = self.fe.alloc(NODE_SIZE)
        self.fe.write(self.h, addr, NODE.pack(value, self._head))
        self._head = addr
        self.write_root(addr)

    def _pop_base(self):
        if not self._head:
            return None
        value, nxt = NODE.unpack(self.fe.read(self.h, self._head, NODE_SIZE))
        self.fe.free(self._head, NODE_SIZE)
        self._head = nxt
        self.write_root(nxt)
        return value

    def _materialize(self) -> None:
        for v in self._pending:
            self._push_base(v)  # head-slot writes coalesce in the tx buffer
        self._pending.clear()

    # ---------------------------------------------------------------- replay
    def _replay_push(self, value: int) -> None:
        self._push_base(value)

    def _replay_pop(self) -> None:
        self._pop_base()
