"""The NVM blade's log work on the card: checksum verify and log replay.

No TPU kernel stands behind these: the JAX package's simulator keeps a
blade's arena in a host ``bytearray`` (``repro/core/backend.py``).  The
port keeps the arena on the card (``repro_torch.core.backend``), so the work
the paper puts on the blade runs there as two kernels of
``csrc/nvm_log.cu``:

* ``fletcher64_segments`` (K1) verifies the bodies of a log span where they
  lie in the arena: ``tx_apply`` and ``reboot`` call it for every body that
  misses the front end's checksum memo.  Its plain version is
  ``ref.fletcher64_segments_reference``; both equal
  ``repro_torch.core.oplog.fletcher64`` of each body, bit for bit.
* ``apply_runs`` (K2) replays a span's memory logs into the arena and its
  synchronous mirrors, last writer winning where runs overlap, as the serial
  loop.  Its plain version is ``ref.apply_runs_reference``.

What bounds them on the H100.  Both are bound by bytes only at a scale the
blade never gives them (1e5 segments or runs, at 3.35 TB/s).  A reboot
hands K1 the bodies its memo misses: 400 of 21-1440 bytes after a
400-transaction log, one of 480 after a power loss mid-replay; a replaying
op hands K2 2-9 runs of 8-240 bytes (a batched window up to ~2,000).  Their
bytes take nanoseconds, so their bound is one launch, and their call was the
host's planning, allocation and copies around it.  Each kernel therefore
takes one of two routes by the size of its table (``checksum_route``,
``route``):

* ``small``: a table that fits the kernel's parameter space (``PARAM_BYTES``)
  is passed by value with the launch: K1's ``_pack`` packs up to
  ``SMALL_SEGMENTS`` segments (at most ``SMALL_LONG`` of them longer than
  ``LONG_SEGMENT``) as a start relative to the span's lowest and a length,
  two uint32 a word; K2's ``small_table`` up to ``SMALL_WORDS`` int64 words.
  The call is the refusals' checks, the packing and one launch: no
  host-to-device copy, no pinned or device allocation but K1's output, no
  plan.  K2's kernel finds each byte's last writer itself: a byte of run i
  is written only where no later run covers it.
* ``large``: a longer table is staged in a pinned buffer kept per device and
  kernel (``_Staging``) and copied to the card.  K1's is int64 starts,
  lengths and the long segments' indices; K2's is planned on the host
  (``_shared_bytes``: which bytes several runs share), where two passes
  settle each shared byte's owner (``atomicMax`` of the run index) and copy.
  The staging buffers and the owner scratch are kept and grown, not
  allocated a call.

K1 is one launch on either route: its first blocks take the segments of up
to ``LONG_SEGMENT`` bytes, a group of lanes each (32 while the table fits
one wave of the card at that width, else 8), each group walking consecutive
segments; the last blocks one longer segment each.  A lane reads a contiguous run of words in 16-byte aligned
chunks, builds the unaligned words from registers by funnel shifts, and
sums ``w`` and ``i * w`` with no modulo; each run is folded mod 2^32 - 1
once (``RUN_WORDS``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises: nothing falls back.  ``fletcher64_launches`` and ``apply_launches``
count the calls of each wrapper that launched its kernel (one a call,
whatever the launches inside), ``fletcher64_launches_by_route`` and
``apply_launches_by_route`` the calls by route; the plain path never adds
to them.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .ref import apply_runs_reference, fletcher64_segments_reference

# segments longer than this take a block each instead of a group of lanes
LONG_SEGMENT = 16 << 10

# the small routes: the kernel's parameters hold 32,764 bytes (CUDA >= 12.1
# on Volta and later).  K2's: the source pointer and the two int32 counts,
# then the run table in int64 words.  K1's: the span's and the output's
# pointers, four int32, the long segments' uint16 indices, then a word a
# segment
PARAM_BYTES = 32764
SMALL_WORDS = (PARAM_BYTES - 16) // 8
SMALL_LONG = 64
SMALL_SEGMENTS = (PARAM_BYTES - 32 - 2 * SMALL_LONG) // 8
# the most words a lane of K1 sums before it folds them mod 2^32 - 1
RUN_WORDS = 1 << 14
ROUTES = ("small", "large")
# up to this many runs (K2) or segments (K1) the checks run on Python ints
_FEW = 64

fletcher64_launches = 0
fletcher64_launches_by_route = dict.fromkeys(ROUTES, 0)
apply_launches = 0
apply_launches_by_route = dict.fromkeys(ROUTES, 0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("nvm_log")
    if lib.repro_apply_runs.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_fletcher64_small.argtypes = [p, i, p, p, i, p]
        lib.repro_fletcher64_small.restype = i
        lib.repro_fletcher64_large.argtypes = [p, ll, i, p, p, i, p]
        lib.repro_fletcher64_large.restype = i
        lib.repro_fletcher64_layout.argtypes = [p]
        lib.repro_fletcher64_layout.restype = None
        layout = (ctypes.c_longlong * 4)()
        lib.repro_fletcher64_layout(layout)
        if tuple(layout) != (SMALL_SEGMENTS, SMALL_LONG, LONG_SEGMENT, RUN_WORDS):
            raise RuntimeError(f"nvm_log: the kernel's K1 layout is {tuple(layout)}, the "
                               f"wrapper's {(SMALL_SEGMENTS, SMALL_LONG, LONG_SEGMENT, RUN_WORDS)}")
        lib.repro_apply_small.argtypes = [p, i, i, p, i, p]
        lib.repro_apply_small.restype = i
        lib.repro_apply_floor.argtypes = [i, p]
        lib.repro_apply_floor.restype = i
        lib.repro_apply_small_words.argtypes = []
        lib.repro_apply_small_words.restype = i
        if lib.repro_apply_small_words() != SMALL_WORDS:
            raise RuntimeError(f"nvm_log: the kernel's small table holds "
                               f"{lib.repro_apply_small_words()} words, the wrapper's "
                               f"{SMALL_WORDS}")
        lib.repro_apply_runs.argtypes = [p, i, i, p, p, ll, i, p]
        lib.repro_apply_runs.restype = i
    return lib


def _stream(dev: torch.device) -> int:
    """The current stream of `dev`, as the handle the C entries take
    (without building a ``torch.cuda.Stream``: a few microseconds a call)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _int64(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int64).reshape(-1)


def _check_arena(arena: torch.Tensor, name: str) -> None:
    if arena.dtype != torch.uint8 or arena.dim() != 1 or not arena.is_contiguous():
        raise ValueError(f"{name}: arenas must be contiguous 1-D uint8 tensors; got "
                         f"{arena.dtype} {tuple(arena.shape)}")


def fletcher64_segments(arena: torch.Tensor, starts, lens) -> torch.Tensor:
    """[n] uint64 on the arena's device: the Fletcher-64 of each segment
    ``arena[starts[i] : starts[i] + lens[i]]`` (byte offsets, host arrays)."""
    _check_arena(arena, "fletcher64_segments")
    starts, lens = _int64(starts), _int64(lens)
    if starts.shape != lens.shape:
        raise ValueError("fletcher64_segments: starts and lens differ in length")
    n = starts.size
    span = _span(starts, lens) if n else None
    if n and (span[2] < 0 or span[0] < 0 or span[1] > arena.numel()):
        raise ValueError("fletcher64_segments: a segment lies outside the arena")
    dev = arena.device
    if dev.type == "cpu":
        return fletcher64_segments_reference(arena, torch.from_numpy(starts),
                                             torch.from_numpy(lens))
    if dev.type != "cuda":
        raise ValueError(f"fletcher64_segments: unsupported device {dev}")
    out = torch.empty(n, dtype=torch.uint64, device=dev)
    if n:
        _fletcher64_launcher(arena, starts, lens, out, span)()
    return out


def _span(starts: np.ndarray, lens: np.ndarray) -> Tuple[int, int, int]:
    """(lowest start, highest end, shortest length) of a non-empty table; on
    Python ints for a few segments, on numpy arrays for more."""
    if starts.size <= _FEW:
        s, n = starts.tolist(), lens.tolist()
        return min(s), max([a + b for a, b in zip(s, n)]), min(n)
    return int(starts.min()), int((starts + lens).max()), int(lens.min())


def _pack(starts: np.ndarray, lens: np.ndarray, span=None):
    """(lo, table): the small route's segment table, uint64 [n], segment k's
    start less ``lo`` (the lowest start) in the low 32 bits and its length
    in the high 32; or (None, why the table does not fit the launch's
    parameters or a value its 32 bits).  `span`: ``_span``'s, where the
    caller has it."""
    n = starts.size
    if not 0 < n <= SMALL_SEGMENTS:
        return None, f"{n} segments; the launch's parameters hold 1 to {SMALL_SEGMENTS}"
    lo, hi, shortest = span or _span(starts, lens)
    if shortest < 0 or hi - lo >= 1 << 32:
        return None, ("a length is negative, or an end lies 2^32 bytes or more past the "
                      "lowest start")
    if n <= _FEW:
        s, ln = starts.tolist(), lens.tolist()
        nlong = sum([x > LONG_SEGMENT for x in ln])
    else:
        nlong = int(np.count_nonzero(lens > LONG_SEGMENT))
    if nlong > SMALL_LONG:
        return None, f"{nlong} segments longer than {LONG_SEGMENT} bytes, over {SMALL_LONG}"
    if n <= _FEW:
        return lo, np.array([a - lo | b << 32 for a, b in zip(s, ln)], dtype=np.uint64)
    table = np.empty((n, 2), dtype=np.uint32)
    table[:, 0] = starts - lo
    table[:, 1] = lens
    return lo, table.view(np.uint64).reshape(n)


def checksum_route(starts: np.ndarray, lens: np.ndarray) -> str:
    """K1's route for a segment table: "small" where ``_pack`` packs it into
    the launch's parameters (1 to ``SMALL_SEGMENTS`` segments, at
    most ``SMALL_LONG`` of them longer than ``LONG_SEGMENT``, every end less
    than 2^32 bytes past the lowest start), else "large"."""
    return "large" if _pack(_int64(starts), _int64(lens))[0] is None else "small"


def _k1_launched(route_: str, err: int) -> None:
    if err:
        raise RuntimeError(f"fletcher64_segments: kernel launch failed with cudaError {err}")
    global fletcher64_launches
    fletcher64_launches += 1
    fletcher64_launches_by_route[route_] += 1


def _fletcher64_launcher(arena: torch.Tensor, starts: np.ndarray, lens: np.ndarray,
                         out: torch.Tensor, span=None) -> Callable[[], None]:
    """The host's part of K1 on the route of the table's size, and a call
    that launches the kernel on it (so a timer can take the launch alone)."""
    dev, base = arena.device, arena.data_ptr()
    lo, table = _pack(starts, lens, span)
    if lo is not None:
        def launch() -> None:
            _k1_launched("small", _lib().repro_fletcher64_small(
                table.ctypes.data, table.size, base + lo, out.data_ptr(), dev.index,
                _stream(dev)))
        return launch
    n = starts.size
    long_ = lens > LONG_SEGMENT
    nlong = int(np.count_nonzero(long_))
    st, stream = _staged(_K1_STAGING, dev, 2 * n + nlong)
    host = st.host.numpy()
    host[:n] = starts
    host[n:2 * n] = lens
    if nlong:
        host[2 * n:2 * n + nlong] = np.flatnonzero(long_)
    st.table[:2 * n + nlong].copy_(st.host[:2 * n + nlong], non_blocking=True)
    st.copied.record(stream)
    table = st.table

    def launch() -> None:
        _k1_launched("large", _lib().repro_fletcher64_large(
            table.data_ptr(), n, nlong, base, out.data_ptr(), dev.index, stream.cuda_stream))
        st.done.record(stream)
    return launch


def _shared_bytes(addrs: np.ndarray, lens: np.ndarray):
    """(comp, count): for each run, where its bytes start in a compact
    numbering of the bytes of the merged intervals that hold several runs,
    or -1 for a run alone in its interval; and the count of those bytes."""
    order = np.argsort(addrs)  # ties in any order: only the intervals matter
    a = addrs[order]
    e = a + lens[order]
    reach = np.maximum.accumulate(e)
    first = np.ones(a.size, dtype=bool)
    first[1:] = a[1:] >= reach[:-1]  # touching intervals do not overlap
    heads = np.flatnonzero(first)
    seg = np.cumsum(first) - 1
    seg_lo = a[heads]
    seg_len = np.maximum.reduceat(e, heads) - seg_lo
    shared = np.diff(np.append(heads, a.size)) > 1
    base = np.cumsum(np.where(shared, seg_len, 0)) - np.where(shared, seg_len, 0)
    comp = np.full(a.size, -1, dtype=np.int64)
    comp[order] = np.where(shared[seg], base[seg] + (a - seg_lo[seg]), -1)
    return comp, int(seg_len[shared].sum())


def table_bytes(ndst: int, n: int) -> int:
    """The bytes of the small route's launch parameters for `n` runs into
    `ndst` destinations: the source pointer, two int32 counts, the table."""
    return 16 + 8 * (ndst + 3 * n)


def route(ndst: int, n: int) -> str:
    """K2's route for `n` runs into `ndst` destinations: "small" where the
    run table fits the launch's parameters (``PARAM_BYTES``), else "large"."""
    return "small" if table_bytes(ndst, n) <= PARAM_BYTES else "large"


def small_table(ptrs, addrs, offs, lens) -> np.ndarray:
    """The small route's run table, int64 [ndst + 3n]: the destination
    pointers, then addrs, offs and lens.  Raises where it does not fit the
    launch's parameters."""
    ndst, n = len(ptrs), len(addrs)
    if not n == len(offs) == len(lens):
        raise ValueError("small_table: addrs, offs and lens differ in length")
    if route(ndst, n) != "small":
        raise ValueError(f"small_table: {n} runs into {ndst} destinations take "
                         f"{table_bytes(ndst, n)} bytes of parameters, over {PARAM_BYTES}")
    table = np.empty(ndst + 3 * n, dtype=np.int64)
    table[:ndst] = ptrs
    table[ndst:ndst + n] = addrs
    table[ndst + n:ndst + 2 * n] = offs
    table[ndst + 2 * n:] = lens
    return table


def read_table(table: np.ndarray, ndst: int) -> Tuple[np.ndarray, ...]:
    """(ptrs, addrs, offs, lens) of a table ``small_table`` packed."""
    n = (table.size - ndst) // 3
    if ndst < 1 or table.size != ndst + 3 * n:
        raise ValueError(f"read_table: {table.size} words are no table of {ndst} destinations")
    return table[:ndst], *(table[ndst + k * n: ndst + (k + 1) * n] for k in range(3))


def _check_runs(dsts: List[torch.Tensor], src: torch.Tensor, addrs: np.ndarray,
                offs: np.ndarray, lens: np.ndarray) -> None:
    """The refusals: a run that reads outside the source, writes outside a
    destination, or writes over the source in a destination's memory.  On
    Python ints for a few runs, on numpy arrays for more."""
    nsrc, ndst = src.numel(), min(d.numel() for d in dsts)
    few = addrs.size <= _FEW
    if few:
        a, o, n = addrs.tolist(), offs.tolist(), lens.tolist()
        if min(n) < 0 or min(o) < 0 or max([x + k for x, k in zip(o, n)]) > nsrc:
            raise ValueError("apply_runs: a run reads outside the source")
        if min(a) < 0 or max([x + k for x, k in zip(a, n)]) > ndst:
            raise ValueError("apply_runs: a run writes outside a destination")
    else:
        if lens.min() < 0 or offs.min() < 0 or (offs + lens).max() > nsrc:
            raise ValueError("apply_runs: a run reads outside the source")
        if addrs.min() < 0 or (addrs + lens).max() > ndst:
            raise ValueError("apply_runs: a run writes outside a destination")
    for d in dsts:
        if d.untyped_storage().data_ptr() != src.untyped_storage().data_ptr():
            continue
        lo = (src.data_ptr() - d.data_ptr())
        if few:
            hit = next((i for i, (x, k) in enumerate(zip(a, n))
                        if x < lo + nsrc and x + k > lo and k > 0), None)
        else:
            hits = (addrs < lo + nsrc) & (addrs + lens > lo) & (lens > 0)
            hit = int(np.argmax(hits)) if hits.any() else None
        if hit is not None:
            raise ValueError(f"apply_runs: run {hit} writes over the source")


def apply_runs(dsts: Sequence[torch.Tensor], src: torch.Tensor, addrs, offs, lens) -> None:
    """For each run i in order, ``dst[addrs[i] : addrs[i] + lens[i]] =
    src[offs[i] : offs[i] + lens[i]]`` for every ``dst`` of `dsts` (the
    blade's arena and its synchronous mirrors; contiguous 1-D uint8 on one
    device, as `src`).  Overlapping runs leave the last writer's bytes.
    Raises when a run's destination overlaps `src` in a destination's
    memory, or lies outside it."""
    dsts = list(dsts)
    if not dsts:
        raise ValueError("apply_runs: no destination")
    for d in (*dsts, src):
        _check_arena(d, "apply_runs")
        if d.device != src.device:
            raise ValueError(f"apply_runs: tensors on {d.device} and {src.device}")
    addrs, offs, lens = _int64(addrs), _int64(offs), _int64(lens)
    if not addrs.shape == offs.shape == lens.shape:
        raise ValueError("apply_runs: addrs, offs and lens differ in length")
    n = addrs.size
    if n == 0:
        return
    _check_runs(dsts, src, addrs, offs, lens)
    dev = src.device
    if dev.type == "cpu":
        apply_runs_reference(dsts, src, *(torch.from_numpy(x) for x in (addrs, offs, lens)))
        return
    if dev.type != "cuda":
        raise ValueError(f"apply_runs: unsupported device {dev}")
    if n >= 1 << 31:
        raise ValueError("apply_runs: too many runs for one launch")
    _apply_launcher(dsts, src, addrs, offs, lens)()


def _apply_launcher(dsts: List[torch.Tensor], src: torch.Tensor, addrs: np.ndarray,
                    offs: np.ndarray, lens: np.ndarray) -> Callable[[], None]:
    """The host's part of K2 on the route of the table's size, and a call
    that launches the kernel on it (so a timer can take the launch alone)."""
    ptrs = [d.data_ptr() for d in dsts]
    if route(len(ptrs), addrs.size) == "small":
        return _small_launcher(src, small_table(ptrs, addrs, offs, lens), len(ptrs))
    return _large_launcher(ptrs, src, addrs, offs, lens)


def _launched(route_: str, err: int) -> None:
    if err:
        raise RuntimeError(f"apply_runs: kernel launch failed with cudaError {err}")
    global apply_launches
    apply_launches += 1
    apply_launches_by_route[route_] += 1


def _small_launcher(src: torch.Tensor, table: np.ndarray, ndst: int) -> Callable[[], None]:
    """One launch with `table` (``small_table``'s) in its parameters; the C
    entry copies the table into them, so nothing outlives the call."""
    dev, n, sp = src.device, (table.size - ndst) // 3, src.data_ptr()

    def launch() -> None:
        _launched("small", _lib().repro_apply_small(table.ctypes.data, ndst, n, sp, dev.index,
                                                    _stream(dev)))
    return launch


class _Staging:
    """A large route's buffers on one device, kept and grown (one set for
    each kernel): the pinned host copy of the table, the table on the card,
    K2's owner scratch.  The host copy is rewritten only once the copy out of
    it has run (`copied`); the card's buffers are used in stream order, a
    call on another stream first waiting for the last launch (`done`)."""

    def __init__(self, dev: torch.device):
        self.host = torch.empty(0, dtype=torch.int64)
        self.table = torch.empty(0, dtype=torch.int64, device=dev)
        self.owner = torch.empty(0, dtype=torch.int32, device=dev)
        self.copied = torch.cuda.Event()
        self.done = torch.cuda.Event()


_STAGING: Dict[torch.device, _Staging] = {}
_K1_STAGING: Dict[torch.device, _Staging] = {}


def _staged(staging: Dict[torch.device, _Staging], dev: torch.device, words: int):
    """(`dev`'s buffers of `staging`, holding at least `words` int64 words and
    free to rewrite, and the current stream, which has waited for their last
    launch)."""
    st = staging.get(dev)
    if st is None:
        st = staging[dev] = _Staging(dev)
    stream = torch.cuda.current_stream(dev)
    st.copied.synchronize()
    stream.wait_event(st.done)
    if st.host.numel() < words:
        size = 1 << (words - 1).bit_length()
        st.host = torch.empty(size, dtype=torch.int64, pin_memory=True)
        st.table = torch.empty(size, dtype=torch.int64, device=dev)
    return st, stream


def _large_launcher(ptrs: List[int], src: torch.Tensor, addrs: np.ndarray, offs: np.ndarray,
                    lens: np.ndarray) -> Callable[[], None]:
    """The plan of shared bytes, the table staged and copied to the card,
    and a launch of the two passes on it (on the table staged last)."""
    dev, n, ndst = src.device, addrs.size, len(ptrs)
    comp, count = _shared_bytes(addrs, lens)
    words = ndst + 4 * n
    st, stream = _staged(_STAGING, dev, words)
    if st.owner.numel() < count:
        st.owner = torch.empty(1 << (count - 1).bit_length(), dtype=torch.int32, device=dev)
    np.concatenate((ptrs, addrs, offs, lens, comp), out=st.host.numpy()[:words])
    st.table[:words].copy_(st.host[:words], non_blocking=True)
    st.copied.record(stream)
    table, owner = st.table, st.owner

    def launch() -> None:
        _launched("large", _lib().repro_apply_runs(table.data_ptr(), ndst, n, src.data_ptr(),
                                                   owner.data_ptr(), count, dev.index,
                                                   stream.cuda_stream))
        st.done.record(stream)
    return launch


def floor_launch(dev: torch.device) -> None:
    """An empty kernel's launch on `dev`'s current stream: the floor under a
    small-route call's time."""
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    err = _lib().repro_apply_floor(dev.index, _stream(dev))
    if err:
        raise RuntimeError(f"floor_launch: kernel launch failed with cudaError {err}")
