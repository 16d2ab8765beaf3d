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

Training differentiates through ``MambaScan``, a ``torch.autograd.Function``
whose forward also writes the fp32 state entering every ``CHUNK`` steps and
whose backward is the hand-written reverse scan ``mamba_scan_backward``
(``repro_mamba_scan_bwd`` in the same source; the JAX package has no
backward kernel: it differentiates its XLA reference).  Its plain version is
``ref.mamba_scan_backward_reference``, the same formulas.  The reverse scan
splits the sequence into chunks of ``bwd_chunk`` steps that run in
parallel: a first pass writes the summary of every ``SUMMARY_CHUNK`` steps
right of the first chunk (the a g it reaches from a zero carry, and the
product of its decays), a second folds the summaries to its right into each
chunk's true carry and walks the chunk again from the forward's
checkpoints (see the source).

``launches`` counts forward kernel launches, ``bwd_launches`` backward calls
(one per call: the C entry point issues the two passes and the fixed-order
sums of the partials); the plain path never adds to either.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .flash_attention_bwd import _sm_count
from .ref import mamba_scan_backward_reference, mamba_scan_reference

STATE_DIMS = (8, 16)
# The backward's layout, the kernel's own constants (checked against the
# library at load); the wrapper sizes the scratch from these, and the kernel
# refuses scratch sized for another layout
CHUNK = 16           # steps between the forward's checkpoints: a group of the backward
CHANNELS = 64        # channels a block: the backward's partial sums of dBm, dCm
SUMMARY_CHUNK = 64   # steps of a chunk of the backward's first pass
BWD_BLOCKS_PER_SM = 2  # blocks of the backward's second pass an SM holds (its launch bounds)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba_scan")
    if lib.repro_mamba_scan_bwd.argtypes is None:
        layout = tuple(lib.repro_mamba_scan_bwd_layout(k) for k in range(3))
        if layout != (CHANNELS, CHUNK, SUMMARY_CHUNK):
            raise RuntimeError(f"mamba_scan: the library's backward layout is {layout}, the "
                               f"wrapper's {(CHANNELS, CHUNK, SUMMARY_CHUNK)}")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, types in ((lib.repro_mamba_scan, [p] * 10 + [i] * 5 + [p]),
                          (lib.repro_mamba_scan_bwd,
                           [p] * 16 + [ctypes.c_longlong] + [i] * 6 + [p])):
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def bwd_chunk(b: int, s: int, din: int, sms: int) -> int:
    """Steps of a chunk of the reverse scan's second pass: a multiple of
    SUMMARY_CHUNK, as few chunks as give about BWD_BLOCKS_PER_SM blocks an SM
    (never more than that many, so the blocks run in one wave), one chunk
    where the rows and channel blocks alone fill the card."""
    blocks = b * -(-din // CHANNELS)
    n_sum = -(-s // SUMMARY_CHUNK)
    chunks = max(1, min(n_sum, BWD_BLOCKS_PER_SM * sms // blocks))
    return -(-n_sum // chunks) * SUMMARY_CHUNK


def bwd_scratch_numel(b: int, s: int, din: int, n: int, chunk: int) -> int:
    """fp32 elements of the reverse scan's scratch with chunks of `chunk`
    steps: the dBm/dCm partials of every block [ceil(Din / CHANNELS), 2, B,
    S, N], the dA and dD partials of every (row, chunk) [B, nC, Din, N + 1],
    and the two summaries of every SUMMARY_CHUNK steps [2, B, ceil(S /
    SUMMARY_CHUNK), Din, N]."""
    n_chunks, n_sum = -(-s // chunk), -(-s // SUMMARY_CHUNK)
    return (-(-din // CHANNELS) * 2 * b * s * n + b * n_chunks * din * (n + 1)
            + 2 * b * n_sum * din * n)


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
    *,
    checkpoints: bool = False,
):
    """(y [B, S, Din] in x's dtype, hT [B, Din, N] fp32, ckpt).  With
    `checkpoints`, ckpt is the fp32 state entering every CHUNK steps,
    [B, ceil(S / CHUNK), Din, N]: what ``mamba_scan_backward`` starts from.
    It is None without `checkpoints`, and on the CPU, whose plain backward
    recomputes the states.

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    if x.device.type == "cpu":
        return (*mamba_scan_reference(x, delta, A, Bm, Cm, D, h0), None)
    b, s, din, n = _check_inputs(x, delta, A, Bm, Cm, D, h0)
    y = torch.empty_like(x)
    hT = torch.empty((b, din, n), dtype=torch.float32, device=x.device)
    ckpt = (torch.empty((b, -(-s // CHUNK), din, n), dtype=torch.float32, device=x.device)
            if checkpoints else None)
    if x.numel() == 0:
        return y, hT, ckpt
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_mamba_scan(
            x.data_ptr(), delta.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            D.data_ptr(), _ptr(h0), y.data_ptr(), hT.data_ptr(), _ptr(ckpt),
            _DTYPE_CODES[x.dtype], b, s, din, n, stream)
    if err:
        raise RuntimeError(f"mamba_scan: kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    return y, hT, ckpt


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _check_inputs(x, delta, A, Bm, Cm, D, h0):
    """(B, S, Din, N) of inputs the kernels take; raises on any other."""
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
    return b, s, din, n


def mamba_scan_backward(
    x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, D: torch.Tensor, h0: Optional[torch.Tensor],
    dy: torch.Tensor,                    # [B, S, Din] in x's dtype
    dhT: Optional[torch.Tensor] = None,  # [B, Din, N] fp32
    ckpt: Optional[torch.Tensor] = None,  # the forward's checkpoints
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddelta, dA, dBm, dCm, dD, dh0), each in its input's dtype (dh0
    fp32), from the forward's inputs and its checkpoints.

    CPU tensors take the plain version (which recomputes the checkpoints
    from h0).  CUDA tensors launch the kernel, or raise when the kernel does
    not take them: nothing falls back.  Two calls give the same bits: the
    chunks' carries fold in a fixed order, and the sums over channels of dBm
    and dCm, and over rows and chunks of dA and dD, are partials summed in a
    fixed order, with no atomics.
    """
    if x.device.type == "cpu":
        return mamba_scan_backward_reference(x, delta, A, Bm, Cm, D, h0, dy, dhT,
                                             chunk=CHUNK)
    b, s, din, n = _check_inputs(x, delta, A, Bm, Cm, D, h0)
    _check("dy", dy, x.device, x.dtype, (b, s, din))
    if dy.data_ptr() % 16:
        raise ValueError("mamba_scan: dy must be 16-byte aligned")
    if dhT is not None:
        _check("dhT", dhT, x.device, torch.float32, (b, din, n))
    if ckpt is None:
        raise ValueError("mamba_scan_backward: a CUDA backward needs the forward's checkpoints")
    _check("ckpt", ckpt, x.device, torch.float32, (b, -(-s // CHUNK), din, n))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dd = torch.empty_like(x), torch.empty_like(delta)
    dA, dD, dh0 = torch.empty_like(A), torch.empty_like(D), torch.empty((b, din, n), **f32)
    dbc = torch.empty((2, b, s, n), dtype=x.dtype, device=x.device)  # dBm, dCm
    if x.numel() == 0:
        return dx, dd, dA, dbc[0], dbc[1], dD, dh0
    chunk = bwd_chunk(b, s, din, _sm_count(x.device.index))
    scratch = torch.empty(bwd_scratch_numel(b, s, din, n, chunk), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_mamba_scan_bwd(
            *(t.data_ptr() for t in (x, delta, A, Bm, Cm, D, dy)), _ptr(dhT), ckpt.data_ptr(),
            *(t.data_ptr() for t in (dx, dd, dA, dbc, dD, dh0, scratch)), scratch.numel(),
            _DTYPE_CODES[x.dtype], b, s, din, n, chunk, stream)
    if err:
        raise RuntimeError(f"mamba_scan_backward: kernel launch failed with cudaError {err}")
    global bwd_launches
    bwd_launches += 1
    return dx, dd, dA, dbc[0], dbc[1], dD, dh0


class MambaScan(torch.autograd.Function):
    """Differentiable selective scan, called as ``MambaScan.apply(x, delta,
    A, Bm, Cm, D, h0, use_kernels)`` -> (y, hT).  `use_kernels` picks the
    CUDA kernels (forward with checkpoints, and the reverse scan) or the
    plain versions of both (``ref.py``), which are the same formulas."""

    @staticmethod
    def forward(ctx, x, delta, A, Bm, Cm, D, h0, use_kernels):
        ctx.set_materialize_grads(False)
        if use_kernels:
            y, hT, ckpt = mamba_scan(x, delta, A, Bm, Cm, D, h0, checkpoints=True)
        else:
            (y, hT), ckpt = mamba_scan_reference(x, delta, A, Bm, Cm, D, h0), None
        ctx.save_for_backward(x, delta, A, Bm, Cm, D, h0, ckpt)
        ctx.use_kernels = use_kernels
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, delta, A, Bm, Cm, D, h0, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dhT = None if dhT is None else dhT.contiguous()
        if ctx.use_kernels:
            grads = mamba_scan_backward(x, delta, A, Bm, Cm, D, h0, dy, dhT, ckpt)
        else:
            grads = mamba_scan_backward_reference(x, delta, A, Bm, Cm, D, h0, dy, dhT,
                                                  chunk=CHUNK)
        dh0 = grads[-1] if h0 is not None else None
        return (*grads[:-1], dh0, None)

