"""Mamba-1 selective scan: the hand-written CUDA kernel and its plain version.

Replaces ``repro/kernels/mamba_scan.py:mamba_scan``, the Pallas TPU kernel
(chunked associative scan of ``h_t = exp(delta_t A) h_{t-1} + delta_t x_t
B_t`` over a ``[Din, N]`` state, ``y_t = C_t . h_t + D x_t``, fp32 carry;
returns ``y`` in x's dtype and ``hT`` fp32).  The kernel is
``csrc/mamba_scan.cu``; its plain PyTorch version is
``ref.mamba_scan_reference``.

What bounds it on the H100: at falcon-mamba-7b's prefill (B=4, S=1024,
Din=8192, N=16, bf16 x/B/C, fp32 delta) it moves 269 MB (0.080 ms at 3.35
TB/s) and takes 537 M exponentials, which the special-function units finish
no sooner than ~0.128 ms: that is its floor.  The design: four lanes per
(row, channel) each hold N / 4 of the channel's states in registers and walk
the sequence in tiles that arrive in shared memory by ``cp.async`` a tile
ahead; y_t's sum over states is a tree within a lane, then a reduce-scatter
across the four lanes every 16 steps.  One exponential per (b, t, d, n); see
the note in the source (PERF.md has its times).

``launches`` counts kernel launches; the plain path never adds to it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .ref import mamba_scan_reference

STATE_DIMS = (8, 16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba_scan")
    fn = lib.repro_mamba_scan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"mamba_scan: {name} on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"mamba_scan: {name} is {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"mamba_scan: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"mamba_scan: {name} must be contiguous")


def mamba_scan(
    x: torch.Tensor,      # [B, S, Din]
    delta: torch.Tensor,  # [B, S, Din] fp32, post-softplus
    A: torch.Tensor,      # [Din, N] fp32
    Bm: torch.Tensor,     # [B, S, N]
    Cm: torch.Tensor,     # [B, S, N]
    D: torch.Tensor,      # [Din] fp32
    h0: Optional[torch.Tensor] = None,  # [B, Din, N] fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [B, S, Din] in x's dtype, hT [B, Din, N] fp32).

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    if x.device.type == "cpu":
        return mamba_scan_reference(x, delta, A, Bm, Cm, D, h0)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"mamba_scan: x must be [B, S, Din] float32 or bfloat16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, s, din = x.shape
    if A.dim() != 2 or A.shape[1] not in STATE_DIMS:
        raise ValueError(f"mamba_scan: A must be [Din, N] with N in {STATE_DIMS}, got "
                         f"{tuple(A.shape)}")
    n = A.shape[1]
    _check("x", x, x.device, x.dtype, (b, s, din))
    _check("delta", delta, x.device, torch.float32, (b, s, din))
    _check("A", A, x.device, torch.float32, (din, n))
    _check("Bm", Bm, x.device, x.dtype, (b, s, n))
    _check("Cm", Cm, x.device, x.dtype, (b, s, n))
    _check("D", D, x.device, torch.float32, (din,))
    if h0 is not None:
        _check("h0", h0, x.device, torch.float32, (b, din, n))
    for name, t in (("x", x), ("delta", delta), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16:  # the kernel copies their rows with cp.async
            raise ValueError(f"mamba_scan: {name} must be 16-byte aligned")
    if s == 0:
        raise ValueError("mamba_scan: empty sequence")
    y = torch.empty_like(x)
    hT = torch.empty((b, din, n), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, hT
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_mamba_scan(
            x.data_ptr(), delta.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            D.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
            hT.data_ptr(), _DTYPE_CODES[x.dtype], b, s, din, n, stream)
    if err:
        raise RuntimeError(f"mamba_scan: kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    return y, hT
