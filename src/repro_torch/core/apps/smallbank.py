"""SmallBank over rNVM.

Accounts live in a direct-indexed NVM region (16 B/account: checking,
savings).  Every transaction appends ONE operation log (all-or-nothing unit
for recovery) and stages its memory logs through the normal workflow.
O(1) transactions — batching does not apply (Table 3 leaves the cell empty).
"""

from __future__ import annotations

import random
import struct

from ..frontend import FrontEnd
from ..structures.base import RemoteStructure

TX_BALANCE = 1
TX_DEPOSIT_CHECKING = 2
TX_TRANSACT_SAVINGS = 3
TX_AMALGAMATE = 4
TX_WRITE_CHECK = 5
TX_SEND_PAYMENT = 6

ACCT = struct.Struct("<qq")  # checking, savings


class SmallBank(RemoteStructure):
    REPLAY = {
        TX_DEPOSIT_CHECKING: "_replay_deposit",
        TX_TRANSACT_SAVINGS: "_replay_savings",
        TX_AMALGAMATE: "_replay_amalgamate",
        TX_WRITE_CHECK: "_replay_write_check",
        TX_SEND_PAYMENT: "_replay_send_payment",
    }

    def __init__(self, fe: FrontEnd, name: str, n_accounts: int = 100_000, create: bool = True):
        super().__init__(fe, name)
        be = fe.backend
        if create:
            self.n_accounts = n_accounts
            self.base = fe.alloc(n_accounts * ACCT.size)
            be.set_name(f"{name}.base", self.base)
            be.set_name(f"{name}.naccts", n_accounts)
        else:
            self.base = be.get_name(f"{name}.base")
            self.n_accounts = be.get_name(f"{name}.naccts")

    def _addr(self, acct: int) -> int:
        return self.base + acct * ACCT.size

    def _read_acct(self, acct: int) -> tuple[int, int]:
        return ACCT.unpack(self.fe.read(self.h, self._addr(acct), ACCT.size))

    def _write_acct(self, acct: int, checking: int, savings: int) -> None:
        self.fe.write(self.h, self._addr(acct), ACCT.pack(checking, savings))

    # ------------------------------------------------------------------ txns
    def balance(self, acct: int) -> int:
        c, s = self._read_acct(acct)
        return c + s

    def deposit_checking(self, acct: int, amount: int) -> None:
        self.fe.op_begin(self.h, TX_DEPOSIT_CHECKING, self.encode_args(acct, amount))
        self._replay_deposit(acct, amount)
        self.fe.op_commit(self.h)

    def transact_savings(self, acct: int, amount: int) -> None:
        self.fe.op_begin(self.h, TX_TRANSACT_SAVINGS, self.encode_args(acct, amount))
        self._replay_savings(acct, amount)
        self.fe.op_commit(self.h)

    def amalgamate(self, a0: int, a1: int) -> None:
        self.fe.op_begin(self.h, TX_AMALGAMATE, self.encode_args(a0, a1))
        self._replay_amalgamate(a0, a1)
        self.fe.op_commit(self.h)

    def write_check(self, acct: int, amount: int) -> None:
        self.fe.op_begin(self.h, TX_WRITE_CHECK, self.encode_args(acct, amount))
        self._replay_write_check(acct, amount)
        self.fe.op_commit(self.h)

    def send_payment(self, a0: int, a1: int, amount: int) -> None:
        self.fe.op_begin(self.h, TX_SEND_PAYMENT, self.encode_args(a0, a1, amount))
        self._replay_send_payment(a0, a1, amount)
        self.fe.op_commit(self.h)

    # ---------------------------------------------------------------- replay
    def _replay_deposit(self, acct: int, amount: int) -> None:
        c, s = self._read_acct(acct)
        self._write_acct(acct, c + amount, s)

    def _replay_savings(self, acct: int, amount: int) -> None:
        c, s = self._read_acct(acct)
        self._write_acct(acct, c, s + amount)

    def _replay_amalgamate(self, a0: int, a1: int) -> None:
        c0, s0 = self._read_acct(a0)
        c1, s1 = self._read_acct(a1)
        self._write_acct(a0, 0, 0)
        self._write_acct(a1, c1 + c0 + s0, s1)

    def _replay_write_check(self, acct: int, amount: int) -> None:
        c, s = self._read_acct(acct)
        penalty = 1 if amount > c + s else 0
        self._write_acct(acct, c - amount - penalty, s)

    def _replay_send_payment(self, a0: int, a1: int, amount: int) -> None:
        c0, s0 = self._read_acct(a0)
        c1, s1 = self._read_acct(a1)
        self._write_acct(a0, c0 - amount, s0)
        self._write_acct(a1, c1 + amount, s1)

    # -------------------------------------------------------------- workload
    def run_mix(self, n_txns: int, write_frac: float = 1.0, seed: int = 0) -> None:
        rng = random.Random(seed)
        writes = (
            self.deposit_checking,
            self.transact_savings,
            self.write_check,
        )
        for _ in range(n_txns):
            a = rng.randrange(self.n_accounts)
            if rng.random() < write_frac:
                which = rng.randrange(5)
                if which < 3:
                    writes[which](a, rng.randrange(1, 100))
                elif which == 3:
                    self.amalgamate(a, rng.randrange(self.n_accounts))
                else:
                    self.send_payment(a, rng.randrange(self.n_accounts), 5)
            else:
                self.balance(a)
