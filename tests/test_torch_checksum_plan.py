"""K1's (``kernels/nvm_log.fletcher64_segments``) host side and a plain model
of its kernel, on the CPU.

The card's kernel cannot run here, so what surrounds it is held here: the
route the wrapper takes by the segment table's size (at the largest table
the launch's parameters hold and one segment past it), the small route's
packed table (round trip, refusals), the launch the wrapper hands the
library on each route, and a failed launch.  The kernel's arithmetic is
held by a numpy model written from ``csrc/nvm_log.cu`` as the kernel reads
the arena: a segment split into contiguous runs of ``per`` words a lane,
read as 16-byte aligned chunks, four unaligned words built from five
aligned ones by selects and a funnel shift, the ragged end masked; each
run's ``S = sum w`` and ``T = sum i w`` in uint64 with no modulo, folded
once as ``((L - b) S - T) mod M``, the lanes' folds then added.  The model
is held bitwise to the JAX package's ``repro.core.oplog.fletcher64`` at
every group width the kernel uses.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from repro.core import oplog as ref_oplog
from repro_torch.kernels import nvm_log

M = 0xFFFFFFFF
WIDTHS = (4, 8, 16, 32, 256)  # a group of lanes a short segment; a block a long one


RESIDENT = 132 * 4  # an H100's blocks of 256 threads at once, at the kernel's 64 registers


def _group_lanes(nshort: int, resident: int = RESIDENT) -> int:
    """csrc/nvm_log.cu's segment_grid: 32 lanes a short segment while they
    fit the threads the card holds at once, else 8."""
    return 32 if 32 * nshort <= resident * 256 else 8


def _chunks(mem: np.ndarray, a: int, n: int) -> np.ndarray:
    """uint32 [n + 1, 4]: the aligned 16-byte chunks from address `a` (the
    memory's offset), the n-th and later read as zeros (the kernel's
    chunk_at)."""
    out = np.zeros((n + 1, 4), dtype=np.uint32)
    raw = mem[a:a + 16 * n]
    raw = np.concatenate([raw, np.zeros(16 * n - raw.size, dtype=np.uint8)])
    out[:n] = raw.view("<u4").reshape(n, 4)
    return out


def _lane_sums(chunks: np.ndarray, p: int, length: int, t: int, nt: int):
    """The kernel's segment_sums: lane `t` of `nt` on the segment of `length`
    bytes at address `p`, whose aligned chunks are `chunks`: (sum w mod M,
    sum (L - j) w mod M), as the kernel computes them."""
    L, full = (length + 3) >> 2, length >> 2
    if L == 0:
        return 0, 0
    r = p & 15
    q, sh = r >> 2, 8 * (r & 3)
    per = min(((L + nt - 1) // nt + 3) & ~3, nvm_log.RUN_WORDS)
    assert per * per // 2 * M < 1 << 64  # T of a whole run stays below 2^64
    tail = (1 << 8 * (length & 3)) - 1 if length & 3 else M
    a1 = a2 = 0
    for b in range(per * t, L, per * nt):
        e = min(b + per, L)
        groups = (e - b + 3) >> 2
        c0 = b >> 2
        u = np.concatenate([chunks[c0:c0 + groups], chunks[c0 + 1:c0 + groups + 1]], axis=1)
        v = u[:, 2:8] if q & 2 else u[:, 0:6]  # the kernel's two select steps
        s = v[:, 1:6] if q & 1 else v[:, 0:5]
        pair = (s[:, 1:5].astype(np.uint64) << np.uint64(32)) | s[:, 0:4].astype(np.uint64)
        w = ((pair >> np.uint64(sh)) & np.uint64(M)).reshape(-1)
        j = b + np.arange(w.size)
        w = np.where(j >= e, np.uint64(0), np.where(j == full, w & np.uint64(tail), w))
        idx = np.arange(w.size, dtype=np.uint64)
        S = int(np.sum(w, dtype=np.uint64))
        T = int(np.sum(idx * w, dtype=np.uint64))
        a1 += S % M
        a2 = (a2 + ((L - b) % M) * (S % M) % M + (M - T % M)) % M
    return a1 % M, a2


def _kernel_model(mem: np.ndarray, p: int, length: int, nt: int) -> int:
    """One segment's output word from `nt` lanes: the lanes' folded sums
    added (group_add, or the block's shared sums), reduced once."""
    chunks = _chunks(mem, p & ~15, (p + length - (p & ~15) + 15) >> 4)
    s1 = s2 = 0
    for t in range(nt):
        x, y = _lane_sums(chunks, p, length, t, nt)
        s1 += x
        s2 += y
    assert s1 < 1 << 64 and s2 < 1 << 64
    return ((s2 % M) << 32) | (s1 % M)


def _dispatch(lens) -> list:
    """The lanes the kernel gives each segment: a block of 256 above
    LONG_SEGMENT, else the launch's group width."""
    short = np.asarray(lens) <= nvm_log.LONG_SEGMENT
    g = _group_lanes(int(short.sum()))
    return [g if s else 256 for s in short]


def _segments(seed):
    """(memory, starts, lens): bodies of 0-3 bytes, odd starts, all-0xFF
    words (2^32 - 1 is 0 mod M), LONG_SEGMENT - 1, LONG_SEGMENT and
    LONG_SEGMENT + 1 bytes, and one of 1 MB, at every start mod 16."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 2, 3, 0, 1, 2, 3, 5, 17, 64, 333, 1440, 4096, 4097]
    lens += [nvm_log.LONG_SEGMENT - 1, nvm_log.LONG_SEGMENT, nvm_log.LONG_SEGMENT + 1]
    lens += [int(x) for x in rng.integers(0, 2000, 12)] + [7, 8, 61, 4000, 1 << 20]
    mem = rng.integers(0, 256, sum(lens) + 48 * len(lens) + 64, dtype=np.uint8)
    starts, pos = [], 0
    for k, n in enumerate(lens):
        pos += 32 - pos % 16 + k % 16  # every start mod 16, odd ones among them
        starts.append(pos)
        pos += n
    for k in (-5, -4, -3, -2):  # all 0xFF: words of 2^32 - 1, and of 0xFF.. ragged
        mem[starts[k]:starts[k] + lens[k]] = 0xFF
    assert starts[-1] + lens[-1] <= mem.size
    return mem, starts, lens


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_model_matches_the_jax_fletcher64(seed):
    """The kernel's lane split and combine, at the width the launch gives
    each segment and at every other width, bitwise the JAX package's
    Fletcher-64 of each body."""
    mem, starts, lens = _segments(seed)
    assert {s % 16 for s in starts} == set(range(16))
    assert any(s % 2 for s in starts)
    for p, n, nt in zip(starts, lens, _dispatch(lens)):
        want = ref_oplog.fletcher64(mem[p:p + n].tobytes())
        widths = (nt,) if n > 1 << 16 else WIDTHS
        for w in widths:
            assert _kernel_model(mem, p, n, w) == want, (p, n, w)
    big = lens.index(1 << 20)  # and at 4 lanes: 4 runs of RUN_WORDS words a lane
    want = ref_oplog.fletcher64(mem[starts[big]:starts[big] + lens[big]].tobytes())
    assert _kernel_model(mem, starts[big], lens[big], 4) == want


def test_group_width_follows_the_table():
    """32 lanes a segment while the short segments fill at most one wave of
    the card at that width (every small table, the reboot's), 8 past it (1e5
    segments); long segments take a block and count for nothing."""
    assert _dispatch([21] * 400) == [32] * 400
    assert _dispatch([480]) == [32]
    assert _dispatch([8] * nvm_log.SMALL_SEGMENTS) == [32] * nvm_log.SMALL_SEGMENTS
    wave = RESIDENT * 256 // 32
    assert _dispatch([4096] * wave)[0] == 32 and _dispatch([4096] * (wave + 1))[0] == 8
    assert _dispatch([2048] * 3 + [1 << 20]) == [32, 32, 32, 256]
    assert _dispatch([100] * 100_000)[0] == 8


@pytest.mark.parametrize("n,lanes,blocks", [(1, 32, 1), (400, 32, 50), (4075, 32, 510),
                                             (100_000, 8, 528), (6000, 32, 528), (7, 8, 1)])
def test_group_walk_takes_every_segment_once(n, lanes, blocks):
    """The kernel's split of the table over its groups (blocks of 256
    threads, `lanes` lanes a group, each group walking `each` consecutive
    segments) takes every segment once."""
    groups = blocks * (256 // lanes)
    each = (n + groups - 1) // groups
    taken = np.zeros(n, dtype=int)
    for group in range(groups):
        taken[group * each:min((group + 1) * each, n)] += 1
    assert (taken == 1).all()


def test_route_at_the_largest_small_table_and_one_past():
    n = nvm_log.SMALL_SEGMENTS
    z = np.zeros(n + 1, dtype=np.int64)
    assert nvm_log.checksum_route(z[:n], z[:n] + 480) == "small"
    assert nvm_log.checksum_route(z, z + 480) == "large"
    assert nvm_log.checksum_route(z[:1], z[:1] + 480) == "small"  # the power-loss reboot
    assert nvm_log.checksum_route(z[:400], z[:400] + 1440) == "small"  # the 400-tx log
    assert nvm_log.checksum_route(z[:0], z[:0]) == "large"
    # SMALL_LONG long segments fit; one more does not
    lens = np.full(200, 100)
    lens[:nvm_log.SMALL_LONG] = nvm_log.LONG_SEGMENT + 1
    assert nvm_log.checksum_route(z[:200], lens) == "small"
    lens[nvm_log.SMALL_LONG] = nvm_log.LONG_SEGMENT + 1
    assert nvm_log.checksum_route(z[:200], lens) == "large"
    # an end 2^32 bytes past the lowest start does not fit its 32 bits
    assert nvm_log.checksum_route(np.array([5, 5 + (1 << 32) - 9]), np.array([1, 8])) == "small"
    assert nvm_log.checksum_route(np.array([5, 5 + (1 << 32) - 8]), np.array([1, 8])) == "large"
    assert 32 + 2 * nvm_log.SMALL_LONG + 8 * nvm_log.SMALL_SEGMENTS <= nvm_log.PARAM_BYTES
    assert 32 + 2 * nvm_log.SMALL_LONG + 8 * (nvm_log.SMALL_SEGMENTS + 1) > nvm_log.PARAM_BYTES


@pytest.mark.parametrize("n", [1, nvm_log._FEW, nvm_log._FEW + 1, 400, nvm_log.SMALL_SEGMENTS])
def test_segment_table_round_trip(n):
    """The packed table (on Python ints up to ``_FEW`` segments, numpy past
    it) gives back every start and length."""
    rng = np.random.default_rng(n)
    starts = rng.integers(1 << 20, 1 << 31, n)
    lens = rng.integers(0, nvm_log.LONG_SEGMENT + 1, n)
    lens[:nvm_log.SMALL_LONG] = 1 << 24  # as many long segments as the table holds
    starts[0] = (1 << 20) + 3
    lo, table = nvm_log._pack(starts, lens)
    assert lo == int(starts.min()) and table.dtype == np.uint64 and table.size == n
    assert np.array_equal((table & M).astype(np.int64) + lo, starts)
    assert np.array_equal((table >> 32).astype(np.int64), lens)


@pytest.mark.parametrize("few", [True, False])
def test_segment_table_refusals(few):
    """The table that does not fit, or holds a value that does not fit its
    32 bits, is refused with its reason, and takes the large route."""
    n = nvm_log.SMALL_SEGMENTS
    z = np.zeros(n + 1, dtype=np.int64)
    k = 3 if few else nvm_log._FEW + 5
    lens = np.full(100, nvm_log.LONG_SEGMENT + 1)
    far, neg = np.zeros(k, dtype=np.int64), np.full(k, 4)
    far[1], neg[1] = 1 << 32, -1
    for starts, lens_, why in ((z, z + 8, f"{n + 1} segments; .* 1 to {n}"),
                               (z[:100], lens, f"over {nvm_log.SMALL_LONG}"),
                               (far, np.full(k, 4), "2\\^32"), (np.arange(k) * 8, neg, "negative")):
        lo, reason = nvm_log._pack(starts, lens_)
        assert lo is None and re.search(why, reason), (why, reason)
        assert nvm_log.checksum_route(starts, lens_) == "large"


class _FakeLib:
    """The library's K1 entries, run on the CPU through the kernel's model:
    each reads the table as the kernel does and writes `out` by pointer."""

    def __init__(self, mem: np.ndarray, base: int, by_ptr: dict):
        self.mem, self.base, self.by_ptr, self.calls = mem, base, by_ptr, []

    def _run(self, starts, lens, base, out_ptr, lanes):
        out = self.by_ptr[out_ptr]
        for k, (s, n) in enumerate(zip(starts, lens)):
            nt = lanes if n <= nvm_log.LONG_SEGMENT else 256
            out[k] = _kernel_model(self.mem, base - self.base + int(s), int(n), nt)

    def repro_fletcher64_small(self, table_ptr, n, base, out_ptr, device, stream):
        table = np.ctypeslib.as_array((ctypes.c_uint64 * n).from_address(table_ptr)).copy()
        lens = table >> 32
        self.calls.append(("small", n, base))
        self._run(table & M, lens, base, out_ptr,
                  _group_lanes(int((lens <= nvm_log.LONG_SEGMENT).sum())))
        return 0

    def repro_fletcher64_large(self, tab_ptr, n, nlong, base, out_ptr, device, stream):
        tab = np.ctypeslib.as_array((ctypes.c_int64 * (2 * n + nlong)).from_address(tab_ptr))
        self.calls.append(("large", n, nlong, [int(x) for x in tab[2 * n:]]))
        self._run(tab[:n], tab[n:2 * n], base, out_ptr, _group_lanes(n - nlong))
        return 0


class _Event:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


class _Stream:
    cuda_stream = 0

    def wait_event(self, event):
        pass


def _fake_staging(monkeypatch):
    """`_staged` with host buffers (the card's table a CPU tensor) and
    counted calls."""
    staged = []

    def staged_(staging, dev, words):
        st = staging.get(dev)
        if st is None:
            st = staging[dev] = type("St", (), {})()
            st.host = torch.empty(0, dtype=torch.int64)
            st.copied, st.done = _Event(), _Event()
        if st.host.numel() < words:
            st.host = torch.empty(words, dtype=torch.int64)
            st.table = torch.empty(words, dtype=torch.int64)
        staged.append(words)
        return st, _Stream()
    monkeypatch.setattr(nvm_log, "_staged", staged_)
    monkeypatch.setattr(nvm_log, "_K1_STAGING", {})
    return staged


@pytest.mark.parametrize("case", ["reboot", "one_body", "one_past", "many_long"])
def test_wrapper_takes_the_route_of_its_table_size(monkeypatch, case):
    """The launcher takes the small route (no staging, no pinned memory) or
    the large one by the table, hands the library the table the kernel
    reads, and gives every segment's Fletcher-64; a call counts once, by
    route."""
    rng = np.random.default_rng(7)
    n = {"reboot": 400, "one_body": 1, "one_past": nvm_log.SMALL_SEGMENTS + 1,
         "many_long": 80}[case]
    if case == "many_long":  # more long segments than the small table holds
        lens = np.full(n, nvm_log.LONG_SEGMENT + 3)
        lens[::16] = 100
    else:
        lens = rng.integers(21, 1441, n) if n > 1 else np.array([480])
    if case == "one_past":
        lens = rng.integers(0, 9, n)
    starts = np.cumsum(lens + rng.integers(0, 40, n)) - lens + 53248
    mem = rng.integers(0, 256, int((starts + lens).max()) + 64, dtype=np.uint8)
    arena = torch.from_numpy(mem)
    out = torch.zeros(n, dtype=torch.int64)  # the kernel's uint64 words
    got = out.numpy().view(np.uint64)
    lib = _FakeLib(mem, arena.data_ptr(), {out.data_ptr(): got})
    monkeypatch.setattr(nvm_log, "_lib", lambda: lib)
    monkeypatch.setattr(nvm_log, "_stream", lambda dev: 0)
    monkeypatch.setattr(nvm_log, "fletcher64_launches", 0)
    monkeypatch.setattr(nvm_log, "fletcher64_launches_by_route", dict.fromkeys(nvm_log.ROUTES, 0))
    staged = _fake_staging(monkeypatch)

    def no_pinning(*args, **kwargs):
        raise AssertionError("the small route pinned host memory")
    route = nvm_log.checksum_route(starts, lens)
    if route == "small":
        monkeypatch.setattr(torch.Tensor, "pin_memory", no_pinning)
    nvm_log._fletcher64_launcher(arena, starts, lens, out)()
    want = [ref_oplog.fletcher64(mem[s:s + k].tobytes()) for s, k in zip(starts, lens)]
    assert got.tolist() == want
    assert nvm_log.fletcher64_launches == 1
    assert nvm_log.fletcher64_launches_by_route == {r: int(r == route) for r in nvm_log.ROUTES}
    if case in ("reboot", "one_body"):
        assert route == "small" and staged == [] and lib.calls == [
            ("small", n, arena.data_ptr() + int(starts.min()))]
    else:
        nlong = int((lens > nvm_log.LONG_SEGMENT).sum())
        assert route == "large" and staged == [2 * n + nlong]
        assert lib.calls[0][:3] == ("large", n, nlong)
        assert lib.calls[0][3] == np.flatnonzero(lens > nvm_log.LONG_SEGMENT).tolist()


@pytest.mark.parametrize("route", nvm_log.ROUTES)
def test_a_failed_launch_raises(monkeypatch, route):
    class FakeLib:
        def repro_fletcher64_small(self, *args):
            return 1  # cudaErrorInvalidValue

        repro_fletcher64_large = repro_fletcher64_small
    monkeypatch.setattr(nvm_log, "_lib", FakeLib)
    monkeypatch.setattr(nvm_log, "_stream", lambda dev: 0)
    monkeypatch.setattr(nvm_log, "fletcher64_launches", 0)
    _fake_staging(monkeypatch)
    n = 1 if route == "small" else nvm_log.SMALL_SEGMENTS + 1
    arena = torch.zeros(1 << 16, dtype=torch.uint8)
    launch = nvm_log._fletcher64_launcher(arena, np.arange(n), np.full(n, 4),
                                          torch.empty(n, dtype=torch.uint64))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        launch()
    assert nvm_log.fletcher64_launches == 0
