"""The port's log formats and the blade's two kernels' plain versions,
against the reference (``repro.core.oplog``) and the serial loop.

Checksums are held bit for bit: the port's host ``fletcher64`` and
``fletcher64_segments``, the plain version of K1
(``ref.fletcher64_segments_reference``, through ``nvm_log`` on a CPU
arena) and the reference's, on seeded bodies of 0-7 bytes, of more than
4096 words, all-0xFF bodies and word sums equal to the modulus.  Decoding
(``decode_txs``, ``decode_txs_columnar``, ``committed_tail``) must give
the reference's answer on clean logs and on torn or corrupted tails, with
the memo and without it, and through the arena checksum hook.  The plain
version of K2 (``ref.apply_runs_reference``) must equal the serial slice
loop on overlapping runs.
"""

import random
import struct

import numpy as np
import pytest
import torch

from repro.core import oplog as ref_oplog
from repro_torch.core import oplog
from repro_torch.kernels import nvm_log, ref

M = 0xFFFFFFFF


def _bodies(seed):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in range(8)]
    out += [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (4 * 4096 + 5, 4 * 5000, 4 * 4097 - 1)]
    out += [b"\xff" * n for n in (1, 3, 4, 7, 8, 4 * 4096, 4 * 4096 + 3, 30001)]
    # word sums of exactly M, 2M and M + 1: the reduction's edge
    out += [struct.pack("<I", M), struct.pack("<II", 1, M - 1), struct.pack("<III", M, M, 1),
            struct.pack("<II", M, 0) + b"\x01"]
    out += [rng.integers(0, 256, int(rng.integers(0, 700)), dtype=np.uint8).tobytes()
            for _ in range(40)]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fletcher64_host_matches_reference(seed):
    bodies = _bodies(seed)
    want = [ref_oplog.fletcher64(b) for b in bodies]
    assert [oplog.fletcher64(b) for b in bodies] == want
    assert oplog.fletcher64_segments(bodies) == ref_oplog.fletcher64_segments(bodies) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fletcher64_plain_kernel_over_an_arena_matches_reference(seed):
    """K1's plain version reads each body where it lies in an arena, at any
    byte offset, with arbitrary bytes after it (the zero padding is the
    body's own, not the arena's next bytes)."""
    bodies = _bodies(seed)
    rng = random.Random(seed)
    arena = bytearray(rng.randbytes(sum(len(b) for b in bodies) + 8 * len(bodies) + 64))
    starts, pos = [], 3
    for b in bodies:
        pos += rng.randrange(0, 7)
        arena[pos : pos + len(b)] = b
        starts.append(pos)
        pos += len(b)
    t = torch.frombuffer(arena, dtype=torch.uint8)
    lens = [len(b) for b in bodies]
    got = nvm_log.fletcher64_segments(t, starts, lens)
    assert got.dtype == torch.uint64
    assert got.tolist() == [ref_oplog.fletcher64(b) for b in bodies]
    # the plain version itself, on int64 offsets
    got2 = ref.fletcher64_segments_reference(t, torch.tensor(starts), torch.tensor(lens))
    assert got2.tolist() == got.tolist()
    assert nvm_log.fletcher64_segments(t, [], []).numel() == 0
    # the CPU takes the plain version
    assert nvm_log.fletcher64_launches == nvm_log.apply_launches == 0
    with pytest.raises(ValueError):
        nvm_log.fletcher64_segments(t, [len(arena) - 2], [3])


def _log(seed, n_tx=30, memo=True):
    """A log of `n_tx` transactions encoded by the reference, and its txs."""
    rng = random.Random(seed)
    txs = []
    for _ in range(n_tx):
        n = rng.choice([1, 2, 3, 8, 20])
        size = rng.choice([8, 32, 256])
        entries = [ref_oplog.MemLog(rng.randrange(1 << 20) * 8, rng.randbytes(size))
                   for _ in range(n)]
        if rng.random() < 0.3:  # alternating node / pointer writes
            entries = [e for pair in zip(entries, [ref_oplog.MemLog(e.addr + 4096, b"\x01" * 8)
                                                   for e in entries]) for e in pair]
        txs.append(entries)
    buf = b"".join(ref_oplog.encode_tx(t) for t in txs)
    if not memo:
        ref_oplog._CSUM_CACHE.clear()
    return buf, txs


def _cuts(buf, seed):
    rng = random.Random(seed)
    out = [buf, buf + b"\x00" * 40]
    out += [buf[: rng.randrange(len(buf))] for _ in range(6)]
    for _ in range(4):  # a flipped byte inside some transaction
        b = bytearray(buf)
        b[rng.randrange(len(b))] ^= 0x5A
        out.append(bytes(b))
    return out


def _columnar(x):
    addrs, offs, lens, n, consumed = x
    return addrs.tolist(), offs.tolist(), lens.tolist(), n, consumed


@pytest.mark.parametrize("memo", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decode_txs_matches_reference(seed, memo):
    buf, _ = _log(seed, memo=memo)
    for cut in _cuts(buf, seed):
        oplog._CSUM_CACHE.clear()
        if memo:  # the port's memo holds what the port encoded
            for t in _log(seed)[1]:
                oplog.encode_tx([oplog.MemLog(e.addr, e.data) for e in t])
        want = ref_oplog.decode_txs(cut)
        got = oplog.decode_txs(cut)
        assert [[tuple(e) for e in t] for t in got[0]] == [[tuple(e) for e in t] for t in want[0]]
        assert got[1] == want[1]
        assert _columnar(oplog.decode_txs_columnar(cut)) == _columnar(
            ref_oplog.decode_txs_columnar(cut))
        # the checksum hook over an arena holding the buffer at an odd offset
        arena = torch.zeros(len(cut) + 9, dtype=torch.uint8)
        arena[5 : 5 + len(cut)] = torch.frombuffer(bytearray(cut), dtype=torch.uint8)
        hook = lambda s, n: nvm_log.fletcher64_segments(arena, s + 5, n).tolist()  # noqa: E731
        assert _columnar(oplog.decode_txs_columnar(cut, hook)) == _columnar(
            ref_oplog.decode_txs_columnar(cut))
        assert oplog.decode_txs(cut, hook)[1] == want[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_committed_tail_matches_reference(seed):
    rng = random.Random(seed)
    entries = []
    seq = 0
    for step in range(120):
        if step % 37 == 0:  # epoch marks, one out of order
            ep = 5 if step != 74 else 3
            entries.append(ref_oplog.encode_epoch_mark(ep))
        seq += 1 if rng.random() < 0.9 else -2  # ghost entries reuse a seq
        payload = struct.pack("<Q", max(seq, 1)) + rng.randbytes(rng.choice([8, 16]))
        entries.append(ref_oplog.encode_oplog(ref_oplog.OpLog(rng.randrange(1, 6), payload)))
    buf = b"".join(entries)
    for cut in (buf, buf[: len(buf) // 2], buf[: len(buf) - 3]):
        for lo, hi in ((0, 10 ** 6), (10, 60), (40, 41)):
            want = ref_oplog.committed_tail(cut, lo, hi)
            got = oplog.committed_tail(cut, lo, hi)
            assert [tuple(e) for e in got] == [tuple(e) for e in want]
        assert oplog.stale_epoch_entries(cut) == ref_oplog.stale_epoch_entries(cut)
        assert [tuple(e) for e in oplog.decode_oplogs(cut)] == \
            [tuple(e) for e in ref_oplog.decode_oplogs(cut)]


def _serial(dst, src, addrs, offs, lens):
    for a, o, n in zip(addrs, offs, lens):
        dst[a : a + n] = src[o : o + n]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_apply_runs_plain_matches_serial_loop(seed):
    """Overlapping runs (whole duplicates, partial overlaps, a run inside
    another, touching neighbours, empty runs): the last writer wins."""
    rng = np.random.default_rng(seed)
    size = 4096
    src = torch.from_numpy(rng.integers(0, 256, 8192, dtype=np.uint8))
    n = 400
    addrs = rng.integers(0, size - 300, n)
    addrs[n // 3 : n // 2] = addrs[: n // 2 - n // 3]              # whole duplicates
    addrs[n // 2 : 2 * n // 3] = addrs[: 2 * n // 3 - n // 2] + 7  # partial overlaps
    lens = rng.integers(0, 257, n)
    lens[::17] = 0
    offs = rng.integers(0, 8192 - 300, n)
    base = rng.integers(0, 256, size, dtype=np.uint8)
    dsts = [torch.from_numpy(base.copy()), torch.from_numpy(base.copy())]
    nvm_log.apply_runs(dsts, src, addrs, offs, lens)
    want = bytearray(base.tobytes())
    _serial(want, src.numpy().tobytes(), addrs.tolist(), offs.tolist(), lens.tolist())
    for d in dsts:
        assert d.numpy().tobytes() == bytes(want)
    assert nvm_log.fletcher64_launches == nvm_log.apply_launches == 0


def test_apply_runs_shared_bytes_plan():
    """The kernel's plan (``_shared_bytes``): lone runs get -1; runs that
    share a merged interval get offsets into one compact numbering."""
    addrs = np.array([100, 0, 50, 60, 10, 200], dtype=np.int64)
    lens = np.array([10, 10, 20, 5, 0, 8], dtype=np.int64)
    comp, count = nvm_log._shared_bytes(addrs, lens)
    # [0, 10) touches nothing; [50, 70) holds runs 2 and 3; [10, 10) is empty
    assert comp.tolist() == [-1, -1, 0, 10, -1, -1]
    assert count == 20


def test_apply_runs_from_the_arena_and_its_refusals():
    """The blade's form: the source span lies in the destination arena."""
    arena = torch.arange(256, dtype=torch.int64).to(torch.uint8)
    want = bytearray(arena.numpy().tobytes())
    span = arena[200:240]
    _serial(want, bytes(want[200:240]), [0, 4, 0], [0, 10, 30], [16, 8, 4])
    nvm_log.apply_runs([arena], span, [0, 4, 0], [0, 10, 30], [16, 8, 4])
    assert arena.numpy().tobytes() == bytes(want)
    with pytest.raises(ValueError, match="over the source"):
        nvm_log.apply_runs([arena], arena[200:240], [190], [0], [16])
    with pytest.raises(ValueError, match="outside"):
        nvm_log.apply_runs([arena], arena[200:240], [250], [0], [16])
    with pytest.raises(ValueError, match="outside the source"):
        nvm_log.apply_runs([arena], arena[200:240], [0], [30], [16])
