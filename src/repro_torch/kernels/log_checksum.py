"""Fletcher-32 checksums: the hand-written CUDA kernel and its plain version.

Replaces ``repro/kernels/log_checksum.py:fletcher32`` and
``:fletcher32_wave``, the Pallas TPU kernels (Fletcher-32 over
little-endian 16-bit words, each stream zero-padded to a multiple of 1024
words, ``(s2 << 16) | s1``; the wave form checksums many byte strings in one
launch).  ``fletcher32`` is the wave with one segment.  The value is the
blade's ``fletcher32_padded``: a version's tensor objects are checksummed on
the card, in one wave, before they are copied to the host, and
``FileBlade.get`` verifies them on the host.  The kernel is
``csrc/log_checksum.cu``; its plain PyTorch versions are
``ref.fletcher32_reference`` and ``ref.fletcher32_wave_reference``.

What bounds it on the H100: bytes, each read once (1 GiB in 0.32 ms at 3.35
TB/s).  The design needs no sequential carry: per-tile integer sums, then
a per-segment combine, exact and the same on every run.

``launches`` counts kernel launches of either form (one wave is one
launch); the plain path never adds to it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from . import _build
from .ref import fletcher32_reference, fletcher32_wave_reference

TILE_BYTES = 2048  # 1024 words, the padding unit

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("log_checksum")
    fn = lib.repro_fletcher32_wave
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, ctypes.c_longlong, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a 1-D uint8 view (no copy)."""
    if not t.is_contiguous():
        raise ValueError("as_bytes: the tensor must be contiguous")
    t = t.reshape(-1)
    return t if t.dtype == torch.uint8 else t.view(torch.uint8)


def fletcher32_wave(chunks: Sequence[torch.Tensor]) -> torch.Tensor:
    """[len(chunks)] int64 on the chunks' device: the checksum of each chunk,
    a 1-D uint8 tensor (`as_bytes` of a tensor), as its own zero-padded
    stream.

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    chunks = list(chunks)
    if not chunks:
        raise ValueError("fletcher32_wave: no chunks")
    dev = chunks[0].device
    if dev.type == "cpu":
        return fletcher32_wave_reference(chunks)
    if dev.type != "cuda":
        raise ValueError(f"fletcher32_wave: unsupported device {dev}")
    for c in chunks:
        if c.device != dev or c.dtype != torch.uint8 or c.dim() != 1 or not c.is_contiguous():
            raise ValueError("fletcher32_wave: chunks must be contiguous 1-D uint8 tensors on "
                             f"{dev}; got {c.dtype} {tuple(c.shape)} on {c.device}")
    nseg = len(chunks)
    table = np.empty((3, nseg), dtype=np.int64)
    table[0] = [c.data_ptr() for c in chunks]
    table[1] = [c.numel() for c in chunks]
    tiles = np.maximum(1, -(-table[1] // TILE_BYTES))
    table[2, 0] = 0
    np.cumsum(tiles[:-1], out=table[2, 1:])
    ntiles = int(tiles.sum())
    # pinned, so the copy is queued on the stream instead of waiting for it
    table_d = torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)
    part = torch.empty((ntiles, 2), dtype=torch.int64, device=dev)
    out = torch.empty(nseg, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().repro_fletcher32_wave(table_d.data_ptr(), nseg, ntiles, part.data_ptr(),
                                           out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fletcher32_wave: kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    return out


def fletcher32(x: torch.Tensor) -> torch.Tensor:
    """0-d int64: the checksum of one stream, a uint8 tensor of bytes or an
    integer tensor of 16-bit words (values < 2^16, the Pallas kernel's
    contract), as a one-segment wave."""
    if x.device.type == "cpu":
        return fletcher32_reference(x)
    if x.dtype != torch.uint8:
        x = x.reshape(-1).to(torch.int16)  # the low 16 bits of each word, little-endian
    return fletcher32_wave([as_bytes(x)])[0]
