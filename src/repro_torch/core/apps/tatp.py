"""TATP (Telecom Application Transaction Processing) over rNVM.

Subscriber / access-info / special-facility records are indexed by remote
B+Trees; call-forwarding rows live in a remote hash table keyed by
(s_id, sf_type, start_time).  Each TATP transaction is one operation-log
unit.  The Table-3 experiment drives 100% write transactions
(update_location / update_subscriber / insert_call_forwarding); Fig. 12
style mixes add the classic read transactions.
"""

from __future__ import annotations

import random

from ..frontend import FrontEnd
from ..structures.bptree import RemoteBPTree
from ..structures.hashtable import RemoteHashTable

TX_UPD_LOCATION = 1
TX_UPD_SUBSCRIBER = 2
TX_INS_CALL_FWD = 3
TX_DEL_CALL_FWD = 4


class TATP:
    def __init__(self, fe: FrontEnd, name: str, n_subscribers: int = 100_000, create: bool = True):
        self.fe = fe
        self.n_subscribers = n_subscribers
        self.subscriber = RemoteBPTree(fe, f"{name}.sub", create=create)
        self.access_info = RemoteBPTree(fe, f"{name}.ai", create=create)
        self.special_facility = RemoteBPTree(fe, f"{name}.sf", create=create)
        self.call_fwd = RemoteHashTable(fe, f"{name}.cf", create=create)

    # ---------------------------------------------------------------- loader
    def populate(self, n: int | None = None) -> None:
        n = n or self.n_subscribers
        for s in range(n):
            self.subscriber.insert(s, (s * 2654435761) % (1 << 31))
            self.access_info.insert(s, s % 4)
            self.special_facility.insert(s, s % 2)
        self.fe.drain(self.subscriber.h)
        self.fe.drain(self.access_info.h)
        self.fe.drain(self.special_facility.h)

    # ------------------------------------------------------------------ txns
    def get_subscriber_data(self, s_id: int):
        return self.subscriber.find(s_id)

    def get_access_data(self, s_id: int):
        return self.access_info.find(s_id)

    def get_new_destination(self, s_id: int, sf_type: int, start_time: int):
        if self.special_facility.find(s_id) is None:
            return None
        return self.call_fwd.get(self._cf_key(s_id, sf_type, start_time))

    def update_location(self, s_id: int, vlr: int) -> None:
        self.subscriber.insert(s_id, vlr)  # one op log + in-place leaf update

    def update_subscriber_data(self, s_id: int, bit: int, data_a: int) -> None:
        self.subscriber.insert(s_id, bit)
        self.special_facility.insert(s_id, data_a)

    def insert_call_forwarding(self, s_id: int, sf_type: int, start_time: int, number: int) -> None:
        if self.special_facility.find(s_id) is None:
            return
        self.call_fwd.put(self._cf_key(s_id, sf_type, start_time), number)

    def delete_call_forwarding(self, s_id: int, sf_type: int, start_time: int) -> None:
        self.call_fwd.delete(self._cf_key(s_id, sf_type, start_time))

    @staticmethod
    def _cf_key(s_id: int, sf_type: int, start_time: int) -> int:
        return (s_id << 8) | (sf_type << 5) | start_time

    # -------------------------------------------------------------- workload
    def run_mix(self, n_txns: int, write_frac: float = 1.0, seed: int = 0) -> None:
        rng = random.Random(seed)
        for _ in range(n_txns):
            s = rng.randrange(self.n_subscribers)
            if rng.random() < write_frac:
                w = rng.random()
                if w < 0.70:
                    self.update_location(s, rng.randrange(1 << 31))
                elif w < 0.84:
                    self.update_subscriber_data(s, rng.randrange(2), rng.randrange(256))
                elif w < 0.95:
                    self.insert_call_forwarding(s, rng.randrange(4), rng.randrange(24), s)
                else:
                    self.delete_call_forwarding(s, rng.randrange(4), rng.randrange(24))
            else:
                r = rng.random()
                if r < 0.5:
                    self.get_subscriber_data(s)
                elif r < 0.9:
                    self.get_access_data(s)
                else:
                    self.get_new_destination(s, rng.randrange(4), rng.randrange(24))

    def drain(self) -> None:
        for t in (self.subscriber, self.access_info, self.special_facility, self.call_fwd):
            self.fe.drain(t.h)
