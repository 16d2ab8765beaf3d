"""RG-LRU linear recurrence: the hand-written CUDA kernel and its plain version.

Replaces ``repro/kernels/rglru_scan.py:rglru_scan``, the Pallas TPU kernel
(chunked associative scan of ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t
x_t)``, ``a_t = exp(c r_t log_a)``, fp32 carry; returns ``y`` in x's dtype
and ``hT`` fp32).  The kernel is ``csrc/rglru_scan.cu``; its plain PyTorch
version is ``ref.rglru_reference``.

What bounds it on the H100: bytes (three [B, S, D] reads and one write
against ~10 operations an element).  At recurrentgemma-9b's prefill (B=4,
S=3072, D=4096, bf16) that is 403 MB, 0.12 ms at 3.35 TB/s.  The design:
one thread per (row, channel) walks the sequence with the carry in a
register, loading 16 steps ahead of the recurrence; see the note in the
source for what limits it (PERF.md has its times).

``launches`` counts kernel launches; the plain path never adds to it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .ref import rglru_reference

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    fn = lib.repro_rglru_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"rglru_scan: {name} on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"rglru_scan: {name} is {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"rglru_scan: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"rglru_scan: {name} must be contiguous")


def rglru_scan(
    x: torch.Tensor,      # [B, S, D]
    r: torch.Tensor,      # [B, S, D] recurrence gate
    i: torch.Tensor,      # [B, S, D] input gate
    log_a: torch.Tensor,  # [D] fp32
    h0: Optional[torch.Tensor] = None,  # [B, D] fp32
    *,
    c: float = 8.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B, S, D] in x's dtype, hT [B, D] fp32).

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    if x.device.type == "cpu":
        return rglru_reference(x, r, i, log_a, h0, c=c)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"rglru_scan: x must be [B, S, D] float32 or bfloat16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, s, d = x.shape
    for name, t in (("x", x), ("r", r), ("i", i)):
        _check(name, t, x.device, x.dtype, (b, s, d))
    _check("log_a", log_a, x.device, torch.float32, (d,))
    if h0 is not None:
        _check("h0", h0, x.device, torch.float32, (b, d))
    if s == 0:
        raise ValueError("rglru_scan: empty sequence")
    y = torch.empty_like(x)
    hT = torch.empty((b, d), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, hT
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_rglru_scan(
            x.data_ptr(), r.data_ptr(), i.data_ptr(), log_a.data_ptr(),
            h0.data_ptr() if h0 is not None else None, y.data_ptr(), hT.data_ptr(),
            _DTYPE_CODES[x.dtype], b, s, d, float(c), stream)
    if err:
        raise RuntimeError(f"rglru_scan: kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    return y, hT
