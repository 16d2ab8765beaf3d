"""Persistence blades for the asymmetric state store.

The same blades, API and on-disk bytes as ``repro.statestore.blade``:

    append(log_record)        one-sided log append (checksummed)
    put(name, bytes[, csum])  data-area write (csum: the bytes' checksum,
                              when the caller computed it, e.g. on the card)
    get(name) / exists(name)  data-area read
    set_root(value)/get_root  8-byte atomic root pointer (version swap)
    delete(name)              GC

  * ``FileBlade`` — a directory: `data/` objects, `log/` append-only record
    file, `ROOT` updated via atomic rename, optional mirror blades that
    receive every mutation before the primary acks (paper §4.3).
  * ``MemoryBlade`` — dict-backed, for fast unit tests.

Every log record and object carries a Fletcher-32 checksum; a torn or
corrupt log tail is dropped on recovery (paper §4.2).  ``get`` verifies an
object's checksum on the host whoever computed it, so a wrong checksum from
the card fails loudly on the first read.  ``FileBlade`` adds up the seconds
its durable writes spend writing and in ``fsync`` (``io_totals``).
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_REC_HDR = struct.Struct("<IIQ")  # length, fletcher32, sequence

FLETCHER_MOD = 65535
_BLOCK_WORDS = 1024     # the stream is zero-padded to a multiple of this
_CHUNK_WORDS = 1 << 20  # words per vectorised step (bounds the int64 sums)


def fletcher32_padded(data: bytes) -> int:
    """Fletcher-32 over little-endian 16-bit words, zero-padded to a
    multiple of 1024 words; returns ``(s2 << 16) | s1``.

    The value of ``repro.kernels.log_checksum.fletcher32_padded_np``,
    computed in closed form instead of a loop over 128-word rows: over the
    padded stream of N words, ``s1 = sum(w_t)`` and
    ``s2 = sum((N - t) * w_t)``, both mod 65535.  The sums run in int64
    over chunks of 2^20 words (each partial sum stays below 2^56).
    """
    n_bytes = len(data)
    if n_bytes == 0:
        return 0
    n_words = (n_bytes + 1) // 2
    n_pad = -(-n_words // _BLOCK_WORDS) * _BLOCK_WORDS
    raw = np.frombuffer(data, dtype=np.uint8)
    idx = np.arange(min(_CHUNK_WORDS, n_words), dtype=np.int64)
    s1 = s2 = 0
    for lo in range(0, n_words, _CHUNK_WORDS):
        hi = min(lo + _CHUNK_WORDS, n_words)
        chunk = raw[2 * lo: 2 * hi]
        if chunk.size % 2:  # odd length: the last word's high byte is zero
            chunk = np.concatenate([chunk, np.zeros(1, np.uint8)])
        w = chunk.view("<u2").astype(np.int64)
        c1 = int(w.sum())
        # sum over the chunk of (N - t) w_t = (N - lo) * c1 - sum (t - lo) w_t
        s1 = (s1 + c1) % FLETCHER_MOD
        s2 = (s2 + (n_pad - lo) * c1 - int(idx[: hi - lo] @ w)) % FLETCHER_MOD
    return (s2 << 16) | s1


def fletcher32_join(prefix: bytes, n_body: int, body_checksum: int) -> int:
    """``fletcher32_padded(prefix + body)`` from the prefix's bytes, the
    body's length and the body's own ``fletcher32_padded``: how a tensor
    checksummed on the card gets the checksum of its ``.npy`` object.

    The prefix must have an even length (an ``.npy`` header is a multiple of
    64 bytes), so the body's words keep their alignment.  With the prefix's
    h words p_t, the body's words b_u, and N the padded length of the whole:
    s1 = sum p + sum b, and s2 = sum (N - t) p_t + (N - h) sum b - sum u b_u,
    where the body's checksum gives sum u b_u = N_b sum b - s2_b (N_b the
    body's own padded length), all mod 65535.
    """
    if len(prefix) % 2:
        raise ValueError("fletcher32_join: the prefix must have an even length")
    m = FLETCHER_MOD
    h = len(prefix) // 2
    n_body_words = (n_body + 1) // 2
    n_pad = -(-(h + n_body_words) // _BLOCK_WORDS) * _BLOCK_WORDS
    nb_pad = max(1, -(-n_body_words // _BLOCK_WORDS)) * _BLOCK_WORDS
    b1, b2 = body_checksum & 0xFFFF, body_checksum >> 16
    sum_ub = (nb_pad * b1 - b2) % m
    p = np.frombuffer(prefix, dtype="<u2").astype(np.int64)
    p1 = int(p.sum()) % m
    p2 = int(((n_pad - np.arange(h, dtype=np.int64)) % m) @ p) % m
    s1 = (p1 + b1) % m
    s2 = (p2 + (n_pad - h) * b1 - sum_ub) % m
    return (s2 << 16) | s1


def _checksum(data: bytes) -> int:
    return fletcher32_padded(data)


class Blade:
    """Interface; see module docstring."""

    def append(self, payload: bytes) -> int: ...
    def scan_log(self) -> Iterator[Tuple[int, bytes]]: ...
    def truncate_log(self, upto_seq: int) -> None: ...
    def put(self, name: str, data: bytes, checksum: Optional[int] = None) -> None: ...
    def get(self, name: str) -> bytes: ...
    def exists(self, name: str) -> bool: ...
    def delete(self, name: str) -> None: ...
    def list(self, prefix: str = "") -> List[str]: ...
    def set_root(self, value: int) -> None: ...
    def get_root(self) -> int: ...

    def io_totals(self) -> Dict[str, float]:
        """Seconds spent writing and in fsync (none for a blade in memory)."""
        return {"write_s": 0.0, "fsync_s": 0.0}


class MemoryBlade(Blade):
    def __init__(self, mirrors: int = 0):
        self.objects: Dict[str, bytes] = {}
        self.log: List[Tuple[int, bytes]] = []
        self.root = 0
        self._seq = 0
        self.mirrors = [MemoryBlade(0) for _ in range(mirrors)]

    def append(self, payload: bytes) -> int:
        self._seq += 1
        for m in self.mirrors:
            m.log.append((self._seq, payload))
        self.log.append((self._seq, payload))
        return self._seq

    def scan_log(self):
        yield from self.log

    def truncate_log(self, upto_seq: int) -> None:
        self.log = [(s, p) for s, p in self.log if s > upto_seq]

    def put(self, name: str, data: bytes, checksum: Optional[int] = None) -> None:
        """Keeps no checksum: `checksum` is accepted and unused."""
        for m in self.mirrors:
            m.objects[name] = data
        self.objects[name] = data

    def get(self, name: str) -> bytes:
        return self.objects[name]

    def exists(self, name: str) -> bool:
        return name in self.objects

    def delete(self, name: str) -> None:
        self.objects.pop(name, None)
        for m in self.mirrors:
            m.objects.pop(name, None)

    def list(self, prefix: str = "") -> List[str]:
        return sorted(k for k in self.objects if k.startswith(prefix))

    def set_root(self, value: int) -> None:
        for m in self.mirrors:
            m.root = value
        self.root = value

    def get_root(self) -> int:
        return self.root


class FileBlade(Blade):
    """Directory-backed blade with checksummed log records and atomic root."""

    def __init__(self, path: str, mirrors: Optional[List[str]] = None):
        self.path = path
        os.makedirs(os.path.join(path, "data"), exist_ok=True)
        os.makedirs(os.path.join(path, "log"), exist_ok=True)
        self._logf = os.path.join(path, "log", "oplog.bin")
        self._seq = self._recover_seq()
        self.mirrors = [FileBlade(p) for p in (mirrors or [])]
        self.io = {"write_s": 0.0, "fsync_s": 0.0}  # this blade's durable writes

    def io_totals(self) -> Dict[str, float]:
        """Seconds spent writing and in fsync, by this blade and its mirrors."""
        return {k: v + sum(m.io_totals()[k] for m in self.mirrors) for k, v in self.io.items()}

    def _durable_write(self, path: str, data: bytes, mode: str = "wb") -> None:
        t0 = time.perf_counter()
        with open(path, mode) as f:
            f.write(data)
            f.flush()
            t1 = time.perf_counter()
            os.fsync(f.fileno())
        self.io["write_s"] += t1 - t0
        self.io["fsync_s"] += time.perf_counter() - t1

    # ------------------------------------------------------------------ log
    def _recover_seq(self) -> int:
        last = 0
        for seq, _ in self.scan_log():
            last = seq
        return last

    def append(self, payload: bytes) -> int:
        self._seq += 1
        rec = _REC_HDR.pack(len(payload), _checksum(payload), self._seq) + payload
        for m in self.mirrors:  # replicate BEFORE primary commit (paper §4.3)
            m._append_raw(rec, self._seq)
        self._append_raw(rec, self._seq)
        return self._seq

    def _append_raw(self, rec: bytes, seq: int) -> None:
        with open(self._logf, "ab") as f:
            f.write(rec)
            f.flush()
            os.fsync(f.fileno())
        self._seq = max(self._seq, seq)

    def scan_log(self):
        """Yields (seq, payload); stops at the first torn/corrupt record."""
        if not os.path.exists(self._logf):
            return
        with open(self._logf, "rb") as f:
            buf = f.read()
        i = 0
        while i + _REC_HDR.size <= len(buf):
            length, csum, seq = _REC_HDR.unpack_from(buf, i)
            j = i + _REC_HDR.size
            if j + length > len(buf):
                break  # torn tail
            payload = buf[j: j + length]
            if _checksum(payload) != csum:
                break  # corrupt tail
            yield seq, payload
            i = j + length

    def truncate_log(self, upto_seq: int) -> None:
        keep = [(s, p) for s, p in self.scan_log() if s > upto_seq]
        tmp = self._logf + ".tmp"
        with open(tmp, "wb") as f:
            for s, p in keep:
                f.write(_REC_HDR.pack(len(p), _checksum(p), s) + p)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._logf)
        for m in self.mirrors:
            m.truncate_log(upto_seq)

    # ----------------------------------------------------------------- data
    def _obj_path(self, name: str) -> str:
        return os.path.join(self.path, "data", name.replace("/", "__"))

    def put(self, name: str, data: bytes, checksum: Optional[int] = None) -> None:
        """Writes the object with `checksum`, or with the checksum computed
        here when none is given; every mirror gets the same one."""
        csum = _checksum(data) if checksum is None else int(checksum)
        for m in self.mirrors:
            m.put(name, data, csum)
        tmp = self._obj_path(name) + ".tmp"
        self._durable_write(tmp, struct.pack("<I", csum) + data)
        os.replace(tmp, self._obj_path(name))

    def get(self, name: str) -> bytes:
        with open(self._obj_path(name), "rb") as f:
            raw = f.read()
        (csum,) = struct.unpack_from("<I", raw)
        data = raw[4:]
        if _checksum(data) != csum:
            raise IOError(f"checksum mismatch for object {name}")
        return data

    def exists(self, name: str) -> bool:
        return os.path.exists(self._obj_path(name))

    def delete(self, name: str) -> None:
        try:
            os.remove(self._obj_path(name))
        except FileNotFoundError:
            pass
        for m in self.mirrors:
            m.delete(name)

    def list(self, prefix: str = "") -> List[str]:
        pfx = prefix.replace("/", "__")
        out = []
        for fn in os.listdir(os.path.join(self.path, "data")):
            if fn.endswith(".tmp"):
                continue
            if fn.startswith(pfx):
                out.append(fn.replace("__", "/"))
        return sorted(out)

    # ----------------------------------------------------------------- root
    def set_root(self, value: int) -> None:
        for m in self.mirrors:
            m.set_root(value)
        tmp = os.path.join(self.path, "ROOT.tmp")
        self._durable_write(tmp, str(int(value)).encode())
        os.replace(tmp, os.path.join(self.path, "ROOT"))

    def get_root(self) -> int:
        p = os.path.join(self.path, "ROOT")
        if not os.path.exists(p):
            return 0
        with open(p) as f:
            return int(f.read().strip() or 0)
