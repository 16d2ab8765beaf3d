"""Log-entry formats: memory logs, operation logs, commit records, checksums.

Follows the paper's Figure 2:

  memory log entry :=  FLAG_MEM(1B) | address(8B) | length(4B) | data(length)
  transaction      :=  mem-log*     | FLAG_COMMIT(1B) | checksum(8B)
  operation log    :=  FLAG_OP(1B)  | op(1B) | length(4B) | payload(length)
  epoch marker     :=  operation-log record with op=OP_EPOCH_MARK(0xFF) and
                       an 8-byte writer-epoch payload (write-lease fencing)

The checksum is a Fletcher-64 over little-endian 32-bit words (each body
zero-padded to whole words), ``(s2 << 32) | s1`` mod ``0xFFFFFFFF``.  It is
not the Fletcher-32 over 16-bit words of the model-state store
(``repro_torch.kernels.log_checksum``).  The host computes it here for the
bodies a front-end encodes (``fletcher64``) and for host byte strings
(``fletcher64_segments``); a blade whose arena lives on the card verifies
the bodies of a log span where they lie, with the CUDA kernel
``repro_torch.kernels.nvm_log.fletcher64_segments`` (the ``checksum`` hook
of ``decode_txs`` / ``decode_txs_columnar``).

Wall-clock fast paths (the simulator itself must keep up with full-size
figure runs):

  * ``decode_txs`` / ``decode_oplogs`` scan record headers with numpy run
    detection — a run of same-length records (the common case: one flush is
    mostly same-sized node writes) is validated with one vectorized
    flag/length compare over a strided offset vector instead of a Python
    ``struct.unpack_from`` per record;
  * a small bounded cache remembers the Fletcher-64 of recently *encoded*
    transaction bodies, so ``tx_apply``/recovery decoding a transaction this
    process just appended validates it with a dict probe instead of
    re-checksumming the whole body.
"""

from __future__ import annotations

import struct
from collections import OrderedDict
from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

from ..obs.profile import profile

FLAG_MEM = 0x01
FLAG_COMMIT = 0x02
FLAG_OP = 0x03

# Reserved opcode: a writer-epoch marker in an op-log stream.  A front-end
# holding a shard's WRITE lease stamps its fencing epoch into the stream
# (once per epoch, before the first op it covers); replay treats epochs as
# monotone — an entry under a marker LOWER than one already seen is a stale
# writer's append that slipped in out of order and is dropped rather than
# interleaved (see ``committed_tail``).  Structure opcodes are small ints;
# 0xFF can never collide.
OP_EPOCH_MARK = 0xFF

_MOD = np.uint64(0xFFFFFFFF)

# bounded body -> Fletcher-64 memo, fed by encode_tx, probed by decode_txs
_CSUM_CACHE: "OrderedDict[bytes, int]" = OrderedDict()
_CSUM_CACHE_MAX = 256


def _csum_remember(body: bytes, csum: int) -> None:
    _CSUM_CACHE[body] = csum
    if len(_CSUM_CACHE) > _CSUM_CACHE_MAX:
        _CSUM_CACHE.popitem(last=False)


def fletcher64(data: bytes) -> int:
    """Fletcher-64 over little-endian uint32 words (zero padded)."""
    pad = (-len(data)) % 4
    if pad:
        data = data + b"\x00" * pad
    words = np.frombuffer(data, dtype="<u4").astype(np.uint64)
    # Blocked to keep the running sums below 2**64 without per-word modulo.
    s1 = np.uint64(0)
    s2 = np.uint64(0)
    block = 1 << 12  # keeps the blocked running sums < 2**56 (no u64 overflow)
    for i in range(0, len(words), block):
        chunk = words[i : i + block]
        c1 = np.cumsum(chunk, dtype=np.uint64) + s1
        s2 = (s2 + np.sum(c1, dtype=np.uint64)) % _MOD
        s1 = c1[-1] % _MOD if len(c1) else s1
    return int((s2 << np.uint64(32)) | s1)


def fletcher64_segments(bodies: List[bytes]) -> List[int]:
    """Fletcher-64 of many byte strings in ONE vectorized pass.

    Each body is zero-padded to whole 32-bit words and concatenated; two
    mod-M prefix sums over the shared word stream then yield every
    segment's sums by gather-subtract:

        s1[a:b) = (C1[b] - C1[a]) mod M
        s2[a:b) = (b * s1[a:b) - (Ciw[b] - Ciw[a])) mod M

    with Ciw = cumsum(i * w_i mod M) over *global* word indices i — the
    Fletcher weight of word i inside segment [a, b) is b - i, so the
    weighted sum telescopes to b * sum(w) - sum(i * w).  All intermediates
    stay exact in uint64 (words < 2**32, each i*w term reduced mod M before
    the cumsum).  Bit-identical to :func:`fletcher64` per body; this is the
    wave-batched checksum path of ``decode_txs`` — one pass per log scan
    instead of one Python-level checksum per transaction.
    """
    if not bodies:
        return []
    padded = [b + b"\x00" * ((-len(b)) % 4) for b in bodies]
    lens = np.array([len(p) >> 2 for p in padded], dtype=np.int64)
    words = np.frombuffer(b"".join(padded), dtype="<u4").astype(np.uint64)
    ends = np.cumsum(lens)
    starts = ends - lens
    c1 = np.zeros(len(words) + 1, dtype=np.uint64)
    np.cumsum(words, out=c1[1:])
    idx = np.arange(len(words), dtype=np.uint64)
    ciw = np.zeros(len(words) + 1, dtype=np.uint64)
    np.cumsum((idx % _MOD) * (words % _MOD) % _MOD, out=ciw[1:])
    s1 = (c1[ends] - c1[starts]) % _MOD
    t2 = (ciw[ends] - ciw[starts]) % _MOD
    s2 = ((ends.astype(np.uint64) % _MOD) * s1 + _MOD - t2) % _MOD
    return ((s2 << np.uint64(32)) | s1).tolist()


# a checksum hook: (body starts, body lengths) as byte offsets into the
# scanned buffer -> the Fletcher-64 of each body
Checksum = Callable[["np.ndarray", "np.ndarray"], List[int]]


def _good_tx_prefix(buf, marks, checksum: Optional[Checksum] = None) -> int:
    """How many leading transactions of a scanned log verify?

    ``marks`` holds one ``(body_start, commit_off, csum)`` per commit record
    in log order.  Bodies this process just encoded resolve by dict probe
    (``_CSUM_CACHE``); the rest are checksummed together in one pass — the
    scan never checksums transaction-by-transaction.  That pass is
    :func:`fletcher64_segments` over the host bytes, or `checksum` over the
    bodies' offsets in `buf` (a card blade's kernel, which reads the bodies
    where they lie in its arena).
    """
    sums: List[Optional[int]] = [None] * len(marks)
    need_j: List[int] = []
    need_b: List[bytes] = []
    for j, (a, b, _) in enumerate(marks):
        body = bytes(buf[a:b])
        got = _CSUM_CACHE.get(body)
        if got is None:
            need_j.append(j)
            need_b.append(body)
        else:
            sums[j] = got
    if need_b:
        if checksum is None:
            got_sums = fletcher64_segments(need_b)
        else:
            starts = np.array([marks[j][0] for j in need_j], dtype=np.int64)
            lens = np.array([len(b) for b in need_b], dtype=np.int64)
            got_sums = checksum(starts, lens)
        for j, s in zip(need_j, got_sums):
            sums[j] = s
    good = 0
    for (_, _, csum), got in zip(marks, sums):
        if got != csum:
            break  # torn / corrupt tail: discard from here on
        good += 1
    return good


class MemLog(NamedTuple):
    """A single {address, value} pair of a transaction."""

    addr: int
    data: bytes


class OpLog(NamedTuple):
    """A logical operation record: enough to replay the operation."""

    op: int
    payload: bytes


def committed_tail(buf: bytes, lo_seq: int, hi_seq: int) -> List[OpLog]:
    """Decode the op-log entries with ``lo_seq < seq <= hi_seq`` and strip
    the seq prefix from their payloads — the shared commit-guard filter of
    crash recovery (``FrontEnd.unreplayed_oplogs``) and migration catch-up
    (``rebalance.migrate_shard``).

    ``hi_seq`` is the durable ``{name}.seq`` watermark: every flush writes
    the entry bytes first and the watermark slot after them, so entries
    above it belong to a torn (uncommitted) group/window and must not
    replay.  Entries are deduplicated by seq with the LAST bytes winning —
    a front-end re-attached after a torn flush restarts numbering at the
    watermark, so stale ghost entries from the torn window may precede live
    ones with the same seq.  Returned in seq order.

    Epoch fencing: ``OP_EPOCH_MARK`` entries stamp the writer epoch of the
    entries that follow.  Epochs must be monotone in log order — every
    landed entry passed the blade-side fence (``tx_append`` epoch check) at
    append time, so a marker LOWER than one already seen means a stale
    writer's append slipped past the fence out of order; entries under it
    are skipped until a marker at or above the high-water epoch restores
    monotonicity.  Logs without markers (single-writer / legacy) are
    accepted unfiltered.
    """
    by_seq: dict = {}
    with profile("log_decode"):
        entries = decode_oplogs(buf)
    max_epoch = 0
    stale = False
    for e in entries:
        if e.op == OP_EPOCH_MARK:
            ep = struct.unpack_from("<Q", e.payload, 0)[0]
            stale = ep < max_epoch
            max_epoch = max(max_epoch, ep)
            continue
        if stale:
            continue
        seq = entry_seq(e)
        if lo_seq < seq <= hi_seq:
            by_seq[seq] = OpLog(e.op, e.payload[8:])
    return [by_seq[s] for s in sorted(by_seq)]


def encode_epoch_mark(epoch: int) -> bytes:
    """Encoded op-log record stamping the writer epoch of what follows."""
    return encode_oplog(OpLog(OP_EPOCH_MARK, struct.pack("<Q", epoch)))


def stale_epoch_entries(buf: bytes) -> int:
    """Count op-log entries shadowed by a non-monotone epoch marker.

    A landed entry under a marker lower than the log's high-water epoch is
    a stale writer's append that survived past a fence bump — the bench and
    chaos oracles assert this is always zero (the blade-side ``tx_append``
    fence rejects such groups before they land).
    """
    max_epoch = 0
    stale = False
    n = 0
    for e in decode_oplogs(buf):
        if e.op == OP_EPOCH_MARK:
            ep = struct.unpack_from("<Q", e.payload, 0)[0]
            stale = ep < max_epoch
            max_epoch = max(max_epoch, ep)
        elif stale:
            n += 1
    return n


def entry_seq(e: OpLog) -> int:
    """Operation sequence number of a structure-level op-log entry.

    The front-end prefixes every op-log payload with the 8-byte op sequence
    number (``op_begin``); the persisted ``{name}.seq`` naming slot — written
    *after* the entry bytes in every flush — is the durable watermark that
    commits entries up to it.  Recovery and migration catch-up both filter
    entries by this seq.
    """
    return struct.unpack_from("<Q", e.payload, 0)[0]


def encode_memlog(entry: MemLog) -> bytes:
    return struct.pack("<BQI", FLAG_MEM, entry.addr, len(entry.data)) + entry.data


def encode_tx(entries: Iterable[MemLog]) -> bytes:
    body = b"".join(encode_memlog(e) for e in entries)
    csum = fletcher64(body)
    _csum_remember(body, csum)
    return body + struct.pack("<BQ", FLAG_COMMIT, csum)


def _uniform_run(arr: "np.ndarray", n: int, i: int, stride: int,
                 flag: int, len_off: int, length: int) -> int:
    """How many consecutive records starting at `i` share `length`?

    Records are contiguous, so record k's header sits exactly at
    ``i + k*stride`` — one vectorized flag + length-field compare over the
    strided offsets replaces a Python unpack per record.  Validity is
    inductive: offset k is only trusted when every offset before it matched,
    which the prefix-of-True consumption guarantees.

    Cost discipline: a cheap scalar probe of the *next* header gates the
    vector compare, so a non-uniform stream (alternating record sizes) pays
    two array indexings per record, never a vector op; and the probe window
    is capped so one call never scans an unbounded tail — long uniform
    streams consume run after run across calls, staying linear.
    """
    kmax = (n - i) // stride
    if kmax < 8:
        return 1  # short runs: numpy setup costs more than the scalar loop
    j = i + stride
    if arr[j] != flag or (
        int(arr[j + len_off])
        | (int(arr[j + len_off + 1]) << 8)
        | (int(arr[j + len_off + 2]) << 16)
        | (int(arr[j + len_off + 3]) << 24)
    ) != length:
        return 1  # next record already differs: skip the vector setup
    kmax = min(kmax, 1 << 14)
    offs = i + stride * np.arange(kmax, dtype=np.intp)
    ok = arr[offs] == flag
    for b, byte in enumerate(length.to_bytes(4, "little")):
        ok &= arr[offs + len_off + b] == byte
    if ok.all():
        return kmax
    return max(1, int(np.argmin(ok)))


def _pattern_run2(arr: "np.ndarray", n: int, i: int, flag: int,
                  hdr: int, len_off: int, lA: int) -> Tuple[int, int]:
    """How many consecutive (lenA, lenB) record *pairs* start at `i`?

    The uniform-run detector stalls on the hash/tree write streams, which
    strictly alternate node writes with 8-byte head/pointer writes (run
    length ~1).  A period-2 pattern covers those: probe record B right
    after A, then validate whole pairs with strided compares at period
    sA + sB.  Returns ``(pairs, lenB)`` — 0 pairs when no alternating
    pattern is present or the vector setup wouldn't pay for itself.
    """
    sA = hdr + lA
    j = i + sA
    if j + hdr > n or arr[j] != flag:
        return 0, 0
    lB = (
        int(arr[j + len_off])
        | (int(arr[j + len_off + 1]) << 8)
        | (int(arr[j + len_off + 2]) << 16)
        | (int(arr[j + len_off + 3]) << 24)
    )
    p = sA + hdr + lB
    kmax = (n - i) // p
    if kmax < 8:
        return 0, 0
    kmax = min(kmax, 1 << 14)
    offs = i + p * np.arange(kmax, dtype=np.intp)
    ok = (arr[offs] == flag) & (arr[offs + sA] == flag)
    for b, byte in enumerate(lA.to_bytes(4, "little")):
        ok &= arr[offs + len_off + b] == byte
    for b, byte in enumerate(lB.to_bytes(4, "little")):
        ok &= arr[offs + sA + len_off + b] == byte
    if ok.all():
        return kmax, lB
    return int(np.argmin(ok)), lB


def decode_txs(buf: bytes, checksum: Optional[Checksum] = None
               ) -> tuple[List[List[MemLog]], int]:
    """Decode a log area into committed transactions.

    Returns (transactions, consumed_bytes).  A torn tail (no commit flag or a
    checksum mismatch — e.g. the blade crashed mid-append) is dropped, exactly
    as the paper's recovery protocol validates the last transaction's
    checksum after restart.  `checksum` verifies the bodies that miss the
    memo (see ``_good_tx_prefix``).
    """
    pend: List[List[MemLog]] = []
    marks: List[Tuple[int, int, int]] = []
    ends: List[int] = []
    i = 0
    cur: List[MemLog] = []
    tx_start = 0
    n = len(buf)
    arr = np.frombuffer(buf, dtype=np.uint8) if n >= 64 else None
    while i < n:
        flag = buf[i]
        if flag == FLAG_MEM:
            if i + 13 > n:
                break
            _, addr, length = struct.unpack_from("<BQI", buf, i)
            if i + 13 + length > n:
                break
            stride = 13 + length
            run = 1
            if arr is not None:
                run = _uniform_run(arr, n, i, stride, FLAG_MEM, 9, length)
            if run > 1:
                end = i + run * stride
                cur.extend(
                    MemLog(int.from_bytes(buf[o + 1 : o + 9], "little"),
                           bytes(buf[o + 13 : o + stride]))
                    for o in range(i, end, stride)
                )
                i = end
            else:
                cur.append(MemLog(addr, bytes(buf[i + 13 : i + stride])))
                i += stride
        elif flag == FLAG_COMMIT:
            if i + 9 > n:
                break
            (csum,) = struct.unpack_from("<Q", buf, i + 1)
            i += 9
            pend.append(cur)
            marks.append((tx_start, i - 9, csum))
            ends.append(i)
            cur = []
            tx_start = i
        else:
            break  # unwritten region (zeros) — end of log
    # checksums are validated after the scan, in one batched pass — a bad
    # commit truncates the result exactly where the per-tx check would have
    good = _good_tx_prefix(buf, marks, checksum)
    return pend[:good], (ends[good - 1] if good else 0)


def decode_txs_columnar(
    buf: bytes, checksum: Optional[Checksum] = None,
) -> tuple["np.ndarray", "np.ndarray", "np.ndarray", int, int]:
    """Columnar ``decode_txs`` for the backend apply path.

    Returns ``(addrs, offs, lens, n_txs, consumed)``: one int64 column each
    of entry address, data offset *into buf*, and data length — no per-entry
    ``MemLog`` objects, so a flush of thousands of same-sized node writes
    decodes as a handful of reshapes.  Checksums are validated in one
    batched :func:`fletcher64_segments` pass; entries past the first bad
    commit are dropped, matching :func:`decode_txs` exactly; `checksum` as
    there.
    """
    n = len(buf)
    arr = np.frombuffer(buf, dtype=np.uint8)
    parts: List[Tuple["np.ndarray", "np.ndarray", "np.ndarray"]] = []
    sa: List[int] = []  # pending scalar records, flushed around vector runs
    so: List[int] = []
    sl: List[int] = []

    def flush_scalars() -> None:
        if sa:
            parts.append((np.array(sa, dtype=np.int64),
                          np.array(so, dtype=np.int64),
                          np.array(sl, dtype=np.int64)))
            sa.clear()
            so.clear()
            sl.clear()

    marks: List[Tuple[int, int, int]] = []
    counts: List[int] = []  # entries decoded up to each commit
    ends: List[int] = []
    total = 0
    i = 0
    tx_start = 0
    while i < n:
        flag = buf[i]
        if flag == FLAG_MEM:
            if i + 13 > n:
                break
            _, addr, length = struct.unpack_from("<BQI", buf, i)
            if i + 13 + length > n:
                break
            stride = 13 + length
            run = 1
            if n >= 64:
                run = _uniform_run(arr, n, i, stride, FLAG_MEM, 9, length)
            if run > 1:
                flush_scalars()
                rec = arr[i : i + run * stride].reshape(run, stride)
                parts.append((
                    rec[:, 1:9].copy().view("<u8")[:, 0].astype(np.int64),
                    i + 13 + stride * np.arange(run, dtype=np.int64),
                    np.full(run, length, dtype=np.int64),
                ))
                total += run
                i += run * stride
                continue
            pairs, len_b = (_pattern_run2(arr, n, i, FLAG_MEM, 13, 9, length)
                            if n >= 64 else (0, 0))
            if pairs > 1:
                flush_scalars()
                stride_b = 13 + len_b
                period = stride + stride_b
                offs = i + period * np.arange(pairs, dtype=np.int64)
                byte8 = np.arange(1, 9, dtype=np.int64)
                addr_a = arr[offs[:, None] + byte8].view("<u8")[:, 0]
                addr_b = arr[(offs + stride)[:, None] + byte8].view("<u8")[:, 0]
                addrs2 = np.empty(2 * pairs, dtype=np.int64)
                addrs2[0::2] = addr_a
                addrs2[1::2] = addr_b
                offs2 = np.empty(2 * pairs, dtype=np.int64)
                offs2[0::2] = offs + 13
                offs2[1::2] = offs + stride + 13
                lens2 = np.empty(2 * pairs, dtype=np.int64)
                lens2[0::2] = length
                lens2[1::2] = len_b
                parts.append((addrs2, offs2, lens2))
                total += 2 * pairs
                i += pairs * period
            else:
                sa.append(addr)
                so.append(i + 13)
                sl.append(length)
                total += 1
                i += stride
        elif flag == FLAG_COMMIT:
            if i + 9 > n:
                break
            (csum,) = struct.unpack_from("<Q", buf, i + 1)
            i += 9
            marks.append((tx_start, i - 9, csum))
            counts.append(total)
            ends.append(i)
            tx_start = i
        else:
            break  # unwritten region (zeros) — end of log
    flush_scalars()
    good = _good_tx_prefix(buf, marks, checksum)
    keep = counts[good - 1] if good else 0
    if parts:
        addrs = np.concatenate([p[0] for p in parts])[:keep]
        offs = np.concatenate([p[1] for p in parts])[:keep]
        lens = np.concatenate([p[2] for p in parts])[:keep]
    else:
        addrs = offs = lens = np.empty(0, dtype=np.int64)
    return addrs, offs, lens, good, (ends[good - 1] if good else 0)


def encode_oplog(entry: OpLog) -> bytes:
    return struct.pack("<BBI", FLAG_OP, entry.op, len(entry.payload)) + entry.payload


def decode_oplogs(buf: bytes) -> List[OpLog]:
    out: List[OpLog] = []
    i = 0
    n = len(buf)
    arr = np.frombuffer(buf, dtype=np.uint8) if n >= 64 else None
    while i < n:
        if buf[i] != FLAG_OP or i + 6 > n:
            break
        _, op, length = struct.unpack_from("<BBI", buf, i)
        if i + 6 + length > n:
            break
        stride = 6 + length
        run = 1
        if arr is not None:
            run = _uniform_run(arr, n, i, stride, FLAG_OP, 2, length)
        if run > 1:
            end = i + run * stride
            out.extend(
                OpLog(buf[o + 1], bytes(buf[o + 6 : o + stride]))
                for o in range(i, end, stride)
            )
            i = end
        else:
            out.append(OpLog(op, bytes(buf[i + 6 : i + stride])))
            i += stride
    return out
