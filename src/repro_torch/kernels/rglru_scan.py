"""RG-LRU linear recurrence: the hand-written CUDA kernel and its plain version.

Replaces ``repro/kernels/rglru_scan.py:rglru_scan``, the Pallas TPU kernel
(chunked associative scan of ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t
x_t)``, ``a_t = exp(c r_t log_a)``, fp32 carry; returns ``y`` in x's dtype
and ``hT`` fp32).  The kernel is ``csrc/rglru_scan.cu``; its plain PyTorch
version is ``ref.rglru_reference``.

What bounds it on the H100: bytes (three [B, S, D] reads and one write
against ~10 operations an element).  At recurrentgemma-9b's prefill (B=4,
S=3072, D=4096, bf16) that is 403 MB, 0.12 ms at 3.35 TB/s.  The design:
a block per (row, 32 channels), a lane a channel, whose warps split the
sequence into spans of ``CHUNK`` steps a warp: each warp summarises its
steps, the summaries are folded in warp order into each warp's carry in,
and each warp runs its steps from it, the next span's inputs loading
meanwhile; the carry between spans stays in registers (see the source;
PERF.md has its times).

Training differentiates through ``RGLRUScan``, a ``torch.autograd.Function``
whose forward also writes the fp32 carry entering every ``CHUNK`` steps and
whose backward is the hand-written reverse scan ``rglru_scan_backward``
(``repro_rglru_scan_bwd`` in the same source; the JAX package has no
backward kernel: it differentiates its XLA reference).  Its plain version is
``ref.rglru_backward_reference``, the same formulas.  The reverse scan
splits the sequence into chunks of ``BWD_CHUNK`` steps that run in
parallel: a first pass writes each chunk's summary (the a g it reaches from
a zero carry, and the product of its decays), a second folds the summaries
to its right into the chunk's true carry and walks it again, writing the
gradients (see the source).

``launches`` counts forward kernel launches, ``bwd_launches`` backward calls
(one per call: the C entry point issues the two passes and the fixed-order
sum of dlog_a over rows and chunks); the plain path never adds to either.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .ref import rglru_backward_reference, rglru_reference

CHUNK = 16  # steps between the forward's checkpoints: a warp's steps of a span
# steps of the reverse scan's chunks, a multiple of CHUNK: recurrentgemma-9b's
# training shape (B=2, S=1024, D=4096) gets 16 chunks a row, a thread a
# channel, 131072 threads (~31 warps an SM, 16 of them resident at once).
# The kernel's own constant (BWD_L in the source); the wrapper sizes its
# scratch from this one, and the library is refused if the two differ
BWD_CHUNK = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    if lib.repro_rglru_scan_bwd.argtypes is None:
        if lib.repro_rglru_scan_bwd_chunk() != BWD_CHUNK:
            raise RuntimeError(f"rglru_scan: the library's backward chunk is "
                               f"{lib.repro_rglru_scan_bwd_chunk()}, BWD_CHUNK {BWD_CHUNK}")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn, types in ((lib.repro_rglru_scan, [p] * 8 + [i] * 4 + [f, p]),
                          (lib.repro_rglru_scan_bwd, [p] * 13 + [i] * 4 + [f, p])):
            fn.argtypes = types
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


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def bwd_scratch_numel(b: int, s: int, d: int) -> int:
    """fp32 elements of the reverse scan's scratch: the dlog_a partials and
    the two summaries of every (row, chunk), [3, B, ceil(S / BWD_CHUNK), D]."""
    return 3 * b * -(-s // BWD_CHUNK) * d


def _check_inputs(x, r, i, log_a, h0):
    """(B, S, D) of inputs the kernels take; raises on any other."""
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
    return b, s, d


def rglru_scan(
    x: torch.Tensor,      # [B, S, D]
    r: torch.Tensor,      # [B, S, D] recurrence gate
    i: torch.Tensor,      # [B, S, D] input gate
    log_a: torch.Tensor,  # [D] fp32
    h0: Optional[torch.Tensor] = None,  # [B, D] fp32
    *,
    c: float = 8.0,
    checkpoints: bool = False,
):
    """(y [B, S, D] in x's dtype, hT [B, D] fp32, ckpt).  With
    `checkpoints`, ckpt is the fp32 carry entering every CHUNK steps,
    [B, ceil(S / CHUNK), D]: what ``rglru_scan_backward`` starts from.  It
    is None without `checkpoints`, and on the CPU, whose plain backward
    recomputes the states.

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    if x.device.type == "cpu":
        return (*rglru_reference(x, r, i, log_a, h0, c=c), None)
    b, s, d = _check_inputs(x, r, i, log_a, h0)
    y = torch.empty_like(x)
    hT = torch.empty((b, d), dtype=torch.float32, device=x.device)
    ckpt = (torch.empty((b, -(-s // CHUNK), d), dtype=torch.float32, device=x.device)
            if checkpoints else None)
    if x.numel() == 0:
        return y, hT, ckpt
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_rglru_scan(
            x.data_ptr(), r.data_ptr(), i.data_ptr(), log_a.data_ptr(), _ptr(h0),
            y.data_ptr(), hT.data_ptr(), _ptr(ckpt), _DTYPE_CODES[x.dtype], b, s, d, float(c),
            stream)
    if err:
        raise RuntimeError(f"rglru_scan: kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    return y, hT, ckpt


def rglru_scan_backward(
    x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, log_a: torch.Tensor,
    h0: Optional[torch.Tensor],
    dy: torch.Tensor,                     # [B, S, D] in x's dtype
    dhT: Optional[torch.Tensor] = None,   # [B, D] fp32
    ckpt: Optional[torch.Tensor] = None,  # the forward's checkpoints
    *,
    c: float = 8.0,
) -> Tuple[torch.Tensor, ...]:
    """(dx, dr, di, dlog_a, dh0), each in its input's dtype (dh0 fp32), from
    the forward's inputs and its checkpoints.

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.  Two calls
    give the same bits: the chunks' carries fold in a fixed order, and
    dlog_a's sum is per-(row, chunk) partials summed in a fixed order, with
    no atomics.
    """
    if x.device.type == "cpu":
        return rglru_backward_reference(x, r, i, log_a, h0, dy, dhT, c=c)
    b, s, d = _check_inputs(x, r, i, log_a, h0)
    _check("dy", dy, x.device, x.dtype, (b, s, d))
    if dhT is not None:
        _check("dhT", dhT, x.device, torch.float32, (b, d))
    if ckpt is None:
        raise ValueError("rglru_scan_backward: a CUDA backward needs the forward's checkpoints")
    _check("ckpt", ckpt, x.device, torch.float32, (b, -(-s // CHUNK), d))
    dx, dr, di = torch.empty_like(x), torch.empty_like(r), torch.empty_like(i)
    dla = torch.empty_like(log_a)
    dh0 = torch.empty((b, d), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, dr, di, dla, dh0
    scratch = torch.empty(bwd_scratch_numel(b, s, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_rglru_scan_bwd(
            *(t.data_ptr() for t in (x, r, i, log_a, dy)), _ptr(dhT), ckpt.data_ptr(),
            *(t.data_ptr() for t in (dx, dr, di, dla, dh0, scratch)), _DTYPE_CODES[x.dtype], b,
            s, d, float(c), stream)
    if err:
        raise RuntimeError(f"rglru_scan_backward: kernel launch failed with cudaError {err}")
    global bwd_launches
    bwd_launches += 1
    return dx, dr, di, dla, dh0


class RGLRUScan(torch.autograd.Function):
    """Differentiable RG-LRU scan, called as ``RGLRUScan.apply(x, r, i,
    log_a, h0, c, use_kernels)`` -> (y, hT).  `use_kernels` picks the CUDA
    kernels (forward with checkpoints, and the reverse scan) or the plain
    versions of both (``ref.py``), which are the same formulas."""

    @staticmethod
    def forward(ctx, x, r, i, log_a, h0, c, use_kernels):
        ctx.set_materialize_grads(False)
        if use_kernels:
            y, hT, ckpt = rglru_scan(x, r, i, log_a, h0, c=c, checkpoints=True)
        else:
            (y, hT), ckpt = rglru_reference(x, r, i, log_a, h0, c=c), None
        ctx.save_for_backward(x, r, i, log_a, h0, ckpt)
        ctx.c, ctx.use_kernels = c, use_kernels
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, r, i, log_a, h0, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dhT = None if dhT is None else dhT.contiguous()
        if ctx.use_kernels:
            grads = rglru_scan_backward(x, r, i, log_a, h0, dy, dhT, ckpt, c=ctx.c)
        else:
            grads = rglru_backward_reference(x, r, i, log_a, h0, dy, dhT, c=ctx.c)
        dh0 = grads[-1] if h0 is not None else None
        return (*grads[:-1], dh0, None, None)

