"""K2's (``kernels/nvm_log.apply_runs``) host plan and a plain model of its
kernels, on the CPU.

The card's kernel cannot run here, so what surrounds it is held here: the
route the wrapper takes by the run table's size (at the largest table the
launch's parameters hold and one run past it), the packed table of the
small route (round trip, size, refusal), and a model of each route's
kernel written from the table as the kernel reads it: 16-byte chunks
aligned in the first destination's address space, a chunk's bytes those no
later run covers (small route) or those the run owns (large route, the
``_shared_bytes`` plan).  Each model is held bitwise to the serial loop,
and writes every byte from one run only.  The refusals hold on Python ints
(a few runs) and on numpy arrays (many).
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import nvm_log


def _serial(dst: bytearray, src: bytes, addrs, offs, lens) -> None:
    for a, o, n in zip(addrs, offs, lens):
        dst[a:a + n] = src[o:o + n]


def _runs(seed, n=400, size=4096):
    """test_torch_nvm_oplog.py's overlapping runs: whole duplicates, partial
    overlaps, a run inside another, touching neighbours, empty runs."""
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, size - 300, n)
    addrs[n // 3: n // 2] = addrs[: n // 2 - n // 3]
    addrs[n // 2: 2 * n // 3] = addrs[: 2 * n // 3 - n // 2] + 7
    lens = rng.integers(0, 257, n)
    lens[::17] = 0
    offs = rng.integers(0, 8192 - 300, n)
    src = rng.integers(0, 256, 8192, dtype=np.uint8)
    base = rng.integers(0, 256, size, dtype=np.uint8)
    return addrs, offs, lens, src, base


def _range_mask(lo, hi):
    """The kernel's range_mask: bits [lo, hi) of a 16-bit mask, clamped."""
    lo, hi = np.clip(lo, 0, 16), np.clip(hi, 0, 16)
    return np.where(hi > lo, ((1 << hi) - 1) ^ ((1 << lo) - 1), 0)


def _copy_runs(table, ndst, n, src, dsts, live):
    """The kernels' copy_run over the `n` runs of `table` (small_table's
    layout, or the large route's with comp after lens): for each run its 16-byte
    chunks aligned in the first destination's address space (its pointer in
    the table), each chunk's bytes those `live(i, x, mask)` keeps, written
    to every destination.  Asserts no byte is written by two runs."""
    ptrs = table[:ndst]
    addrs, offs, lens = (table[ndst + k * n: ndst + (k + 1) * n] for k in range(3))
    writer = np.full(dsts[0].size, -1)
    for i in range(n):
        a, o, ln = int(addrs[i]), int(offs[i]), int(lens[i])
        if ln <= 0:
            continue
        first = a - (int(ptrs[0]) + a) % 16
        for x in range(first, a + ln, 16):
            mask = live(i, x, int(_range_mask(a - x, a + ln - x)))
            for b in range(16):
                if mask >> b & 1:
                    assert writer[x + b] == -1, f"byte {x + b} written by runs {writer[x + b]}, {i}"
                    writer[x + b] = i
                    for d in dsts:
                        d[x + b] = src[o + x + b - a]


def _small_model(table, ndst, src, dsts):
    """The small kernel: a byte of run i is written where no later run covers it."""
    _, addrs, _, lens = nvm_log.read_table(table, ndst)

    def later(i, x, mask):
        cover = _range_mask(addrs[i + 1:] - x, addrs[i + 1:] + lens[i + 1:] - x)
        return mask & ~int(np.bitwise_or.reduce(cover, initial=0))
    _copy_runs(table, ndst, addrs.size, src, dsts, later)


def _large_model(table, ndst, count, src, dsts):
    """The large kernels: apply_claim's atomicMax of the run index into an
    owner a shared byte (`count` of them), then apply_copy from each byte's
    owner."""
    n = (table.size - ndst) // 4
    addrs, lens, comp = (table[ndst + k * n: ndst + (k + 1) * n] for k in (0, 2, 3))
    owner = np.full(count, -1)
    for i in np.flatnonzero(comp >= 0):
        assert comp[i] + lens[i] <= count  # the scratch holds every shared byte
        span = owner[comp[i]: comp[i] + lens[i]]
        np.maximum(span, i, out=span)

    def owned(i, x, mask):
        if comp[i] < 0:
            return mask
        for b in range(16):
            if mask >> b & 1 and owner[comp[i] + x + b - addrs[i]] != i:
                mask &= ~(1 << b)
        return mask
    _copy_runs(table, ndst, n, src, dsts, owned)


@pytest.mark.parametrize("ndst", [1, 2, 3, 5])
def test_route_at_the_largest_small_table_and_one_past(ndst):
    limit = (nvm_log.SMALL_WORDS - ndst) // 3
    assert nvm_log.route(ndst, limit) == "small"
    assert nvm_log.route(ndst, limit + 1) == "large"
    assert nvm_log.table_bytes(ndst, limit) <= nvm_log.PARAM_BYTES
    assert nvm_log.table_bytes(ndst, limit + 1) > nvm_log.PARAM_BYTES
    assert nvm_log.route(ndst, 3) == "small"  # a hashtable put
    assert nvm_log.route(ndst, 2003) == "large"  # a queue x symb window


@pytest.mark.parametrize("mirrors", [0, 2])
def test_wrapper_takes_the_route_of_its_table_size(monkeypatch, mirrors):
    """``_apply_launcher`` plans on the route of the table's size: the small
    launcher with the packed table at the limit, the large one a run past."""
    taken = []
    monkeypatch.setattr(nvm_log, "_small_launcher",
                        lambda src, table, ndst: taken.append(("small", table.size, ndst)))
    monkeypatch.setattr(nvm_log, "_large_launcher",
                        lambda ptrs, src, a, o, n: taken.append(("large", a.size, len(ptrs))))
    ndst = 1 + mirrors
    dsts = [torch.zeros(1 << 16, dtype=torch.uint8) for _ in range(ndst)]
    src = torch.zeros(1 << 12, dtype=torch.uint8)
    limit = (nvm_log.SMALL_WORDS - ndst) // 3
    for n in (limit, limit + 1):
        z = np.zeros(n, dtype=np.int64)
        nvm_log._apply_launcher(dsts, src, z + 64, z, z + 8)
    assert taken == [("small", ndst + 3 * limit, ndst), ("large", limit + 1, ndst)]


@pytest.mark.parametrize("ndst", [1, 2, 3])
def test_small_table_round_trip_size_and_refusal(ndst):
    rng = np.random.default_rng(ndst)
    limit = (nvm_log.SMALL_WORDS - ndst) // 3
    for n in (1, 3, 190, limit):
        ptrs = rng.integers(1 << 40, 1 << 47, ndst)
        addrs, offs, lens = (rng.integers(0, 1 << 26, n) for _ in range(3))
        table = nvm_log.small_table(ptrs, addrs, offs, lens)
        assert table.dtype == np.int64 and table.size == ndst + 3 * n
        assert 16 + 8 * table.size == nvm_log.table_bytes(ndst, n) <= nvm_log.PARAM_BYTES
        back = nvm_log.read_table(table, ndst)
        for got, want in zip(back, (ptrs, addrs, offs, lens)):
            assert np.array_equal(got, want)
    z = np.zeros(limit + 1, dtype=np.int64)
    with pytest.raises(ValueError, match=f"over {nvm_log.PARAM_BYTES}"):
        nvm_log.small_table(np.ones(ndst, dtype=np.int64), z, z, z)
    with pytest.raises(ValueError, match="differ in length"):
        nvm_log.small_table([1], [0, 1], [0], [0])
    with pytest.raises(ValueError, match="no table"):
        nvm_log.read_table(np.zeros(ndst + 4, dtype=np.int64), ndst)


@pytest.mark.parametrize("align", [0, 5, 12])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_small_kernel_model_matches_serial_loop(seed, align):
    """The small route's last-writer rule, on the packed table, bitwise the
    serial loop; the first destination's pointer `align` bytes past a
    16-byte boundary moves every chunk's edges."""
    addrs, offs, lens, src, base = _runs(seed)
    assert nvm_log.route(2, addrs.size) == "small"
    table = nvm_log.small_table([(1 << 40) + align, (1 << 41) + 3], addrs, offs, lens)
    dsts = [base.copy(), base.copy()]
    _small_model(table, 2, src, dsts)
    want = bytearray(base.tobytes())
    _serial(want, src.tobytes(), addrs.tolist(), offs.tolist(), lens.tolist())
    for d in dsts:
        assert d.tobytes() == bytes(want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_large_kernel_model_matches_serial_loop(seed):
    """The large route's owners (``_shared_bytes``, then the atomicMax of
    the run index), on its table, bitwise the serial loop."""
    addrs, offs, lens, src, base = _runs(seed)
    comp, count = nvm_log._shared_bytes(addrs, lens)
    table = np.concatenate(([1 << 40], addrs, offs, lens, comp)).astype(np.int64)
    dst = base.copy()
    _large_model(table, 1, count, src, [dst])
    want = bytearray(base.tobytes())
    _serial(want, src.tobytes(), addrs.tolist(), offs.tolist(), lens.tolist())
    assert dst.tobytes() == bytes(want)


def test_small_launch_passes_the_packed_table(monkeypatch):
    """The small launcher hands the C entry the packed table, its counts and
    the source pointer; the model run on what it was handed gives the serial
    loop's bytes in every destination, and the call counts once, by route."""
    addrs, offs, lens, src, base = _runs(5, n=60)
    dsts = [torch.from_numpy(base.copy()) for _ in range(2)]
    src_t = torch.from_numpy(src.copy())
    by_ptr = {d.data_ptr(): d.numpy() for d in dsts}
    calls = []

    class FakeLib:
        def repro_apply_small(self, table_ptr, ndst, n, src_ptr, device, stream):
            words = np.ctypeslib.as_array((ctypes.c_int64 * (ndst + 3 * n))
                                          .from_address(table_ptr)).copy()
            calls.append((ndst, n, src_ptr == src_t.data_ptr()))
            _small_model(words, ndst, src, [by_ptr[int(p)] for p in words[:ndst]])
            return 0
    monkeypatch.setattr(nvm_log, "_lib", FakeLib)
    monkeypatch.setattr(nvm_log, "_stream", lambda dev: 0)
    monkeypatch.setattr(nvm_log, "apply_launches", 0)
    monkeypatch.setattr(nvm_log, "apply_launches_by_route", dict.fromkeys(nvm_log.ROUTES, 0))
    nvm_log._apply_launcher(dsts, src_t, addrs, offs, lens)()
    assert calls == [(2, 60, True)]
    assert nvm_log.apply_launches == 1 and nvm_log.apply_launches_by_route == {"small": 1,
                                                                              "large": 0}
    want = bytearray(base.tobytes())
    _serial(want, src.tobytes(), addrs.tolist(), offs.tolist(), lens.tolist())
    for d in dsts:
        assert d.numpy().tobytes() == bytes(want)


def test_a_failed_small_launch_raises(monkeypatch):
    class FakeLib:
        def repro_apply_small(self, *args):
            return 1  # cudaErrorInvalidValue
    monkeypatch.setattr(nvm_log, "_lib", FakeLib)
    monkeypatch.setattr(nvm_log, "_stream", lambda dev: 0)
    monkeypatch.setattr(nvm_log, "apply_launches", 0)
    d = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        nvm_log._apply_launcher([d], torch.zeros(8, dtype=torch.uint8), np.array([0]),
                                np.array([0]), np.array([8]))()
    assert nvm_log.apply_launches == 0


@pytest.mark.parametrize("n", [3, nvm_log._FEW, nvm_log._FEW + 1, 300])
def test_refusals_on_few_and_many_runs(n):
    """The same refusals, with the same messages, whether the checks run on
    Python ints (up to ``_FEW`` runs) or numpy arrays; the first run over
    the source is named."""
    arena = torch.zeros(4096, dtype=torch.uint8)
    span = arena[3000:3400]
    addrs, offs, lens = np.arange(n) * 8 % 2900, np.arange(n) % 300, np.full(n, 8)
    nvm_log.apply_runs([arena], span, addrs, offs, lens)  # a clean table passes
    for k, (a, o, ln), msg in ((0, (0, 395, 8), "outside the source"),
                               (1, (4090, 0, 8), "writes outside a destination"),
                               (2, (0, 0, -1), "outside the source"),
                               (3, (2996, 0, 8), f"run {n - 1} writes over the source")):
        bad = [x.copy() for x in (addrs, offs, lens)]
        for x, v in zip(bad, (a, o, ln)):
            x[n - 1] = v
        with pytest.raises(ValueError, match=msg):
            nvm_log.apply_runs([arena], span, *bad)
    mirror = torch.zeros(2048, dtype=torch.uint8)
    with pytest.raises(ValueError, match="writes outside a destination"):
        nvm_log.apply_runs([arena, mirror], span, addrs + 2048, offs, lens)
