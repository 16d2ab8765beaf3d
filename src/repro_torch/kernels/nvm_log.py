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
  synchronous mirrors in one launch, last writer winning where runs
  overlap, as the serial loop.  Its plain version is
  ``ref.apply_runs_reference``.

What bounds them on the H100: bytes (K1 reads each body once; K2 reads each
run once and writes it once to each destination), at 3.35 TB/s.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises: nothing falls back.  ``fletcher64_launches`` and ``apply_launches``
count the calls of each wrapper that launched its kernel (one a call,
whatever the launches inside); the plain path never adds to them.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Sequence

import numpy as np
import torch

from . import _build
from .ref import apply_runs_reference, fletcher64_segments_reference

# segments longer than this take a block each instead of a warp
LONG_SEGMENT = 16 << 10

fletcher64_launches = 0
apply_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("nvm_log")
    if lib.repro_apply_runs.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_fletcher64_segments.argtypes = [p, ll, p, p, p, i, p, i, p, p]
        lib.repro_fletcher64_segments.restype = i
        lib.repro_apply_runs.argtypes = [p, i, i, p, p, ll, p]
        lib.repro_apply_runs.restype = i
    return lib


def _int64(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int64).reshape(-1)


def _to(dev: torch.device, *arrays: np.ndarray) -> torch.Tensor:
    """The arrays as one int64 tensor on `dev`, end to end: one copy."""
    host = torch.from_numpy(np.concatenate(arrays) if len(arrays) > 1 else arrays[0])
    return host.to(dev) if dev.type == "cpu" else host.pin_memory().to(dev, non_blocking=True)


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
    if n and (lens.min() < 0 or starts.min() < 0 or (starts + lens).max() > arena.numel()):
        raise ValueError("fletcher64_segments: a segment lies outside the arena")
    dev = arena.device
    if dev.type == "cpu":
        return fletcher64_segments_reference(arena, torch.from_numpy(starts),
                                             torch.from_numpy(lens))
    if dev.type != "cuda":
        raise ValueError(f"fletcher64_segments: unsupported device {dev}")
    out = torch.empty(n, dtype=torch.uint64, device=dev)
    if n == 0:
        return out
    if arena.data_ptr() % 4:
        raise ValueError("fletcher64_segments: the arena must be 4-byte aligned")
    _fletcher64_launcher(arena, starts, lens, out)()
    return out


def _fletcher64_launcher(arena: torch.Tensor, starts: np.ndarray, lens: np.ndarray,
                         out: torch.Tensor) -> Callable[[], None]:
    """The host's part of K1 (the segment table on the card), and a call
    that launches the kernel on it (so a timer can take the launch alone)."""
    dev, n = arena.device, starts.size
    long_ = lens > LONG_SEGMENT
    widx = np.flatnonzero(~long_)
    bidx = np.flatnonzero(long_)
    table = _to(dev, starts, lens, widx, bidx)

    def launch() -> None:
        base = table.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib().repro_fletcher64_segments(
                arena.data_ptr(), arena.numel(), base, base + 8 * n, base + 16 * n, widx.size,
                base + 8 * (2 * n + widx.size), bidx.size, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"fletcher64_segments: kernel launch failed with cudaError {err}")
        global fletcher64_launches
        fletcher64_launches += 1
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
    if lens.min() < 0 or offs.min() < 0 or (offs + lens).max() > src.numel():
        raise ValueError("apply_runs: a run reads outside the source")
    if addrs.min() < 0 or (addrs + lens).max() > min(d.numel() for d in dsts):
        raise ValueError("apply_runs: a run writes outside a destination")
    for d in dsts:
        if d.untyped_storage().data_ptr() != src.untyped_storage().data_ptr():
            continue
        lo = (src.data_ptr() - d.data_ptr())
        hit = (addrs < lo + src.numel()) & (addrs + lens > lo) & (lens > 0)
        if hit.any():
            raise ValueError(f"apply_runs: run {int(np.argmax(hit))} writes over the source")
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
    """The host's part of K2 (the plan of shared bytes, the run table on the
    card, the owner scratch), and a call that launches the kernel on it."""
    dev, n = src.device, addrs.size
    comp, count = _shared_bytes(addrs, lens)
    ptrs = np.array([d.data_ptr() for d in dsts], dtype=np.int64)
    table = _to(dev, ptrs, addrs, offs, lens, comp)
    owner = torch.empty(max(count, 1), dtype=torch.int32, device=dev)

    def launch() -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib().repro_apply_runs(table.data_ptr(), len(dsts), n, src.data_ptr(),
                                          owner.data_ptr(), count, stream)
        if err:
            raise RuntimeError(f"apply_runs: kernel launch failed with cudaError {err}")
        global apply_launches
        apply_launches += 1
    return launch
