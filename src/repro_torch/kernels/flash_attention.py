"""Flash attention: the hand-written CUDA forward, its gradient, and their
plain versions.

Replaces ``repro/kernels/flash_attention.py:flash_attention``, the Pallas
TPU kernel (FlashAttention-2 forward with causal, local-window and
``q_offset`` masking, GQA via KV head ``h // group``, fp32 softmax state).
The kernel is ``csrc/flash_attention.cu``; its plain PyTorch version is
``ref.flash_attention_reference``.

What bounds it on the H100: at the serving prefill shape (llama3.2-3b,
B=4, S=1024, causal, bf16) one launch does 25.8 GFLOP on 67 MB, so the
bound is the tensor cores' 989 TFLOP/s (about 26 us), not the 3.35 TB/s of
device memory (about 20 us).  The design: one block per 64 query rows,
K/V tiles in shared memory, loop bounds taken from the masks so masked
tiles are never read, register-tiled products on CUDA cores.  It runs well
above the bound; ``wgmma``/TMA are later work (see PERF.md for its times).

Training differentiates through ``FlashAttention``, a ``torch.autograd.Function``
whose forward also writes each row's log-sum-exp and whose backward is the
hand-written kernel of ``flash_attention_bwd`` (the JAX package has no
backward kernel; it differentiates its XLA reference).

``launches`` counts forward kernel launches; the plain path never adds to it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from . import flash_attention_bwd as _bwd
from .ref import flash_attention_backward_reference, flash_attention_reference

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Attention of q over k/v; output [B, Hq, Sq, D] in q's dtype, and with
    `return_lse` also each row's log-sum-exp [B, Hq, Sq] fp32.

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window,
                                         sm_scale=sm_scale, q_offset=q_offset,
                                         return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, hq, sq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads are not a multiple of {hkv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "float32 or bfloat16, all the same")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if sk == 0:
        raise ValueError("flash_attention: empty key sequence")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, _DTYPE_CODES[q.dtype],
            b, hq, hkv, sq, sk, d, scale, int(bool(causal)), int(window or 0), int(q_offset),
            stream)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    return (out, lse) if return_lse else out


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention.  The forward saves q, k, v, the output
    and the row log-sum-exp; the backward recomputes the probabilities from
    them.  `use_kernels` picks the CUDA kernels (forward and backward) or the
    plain versions of both (``ref.py``), which are the same formulas."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, q_offset, block_k, use_kernels):
        if use_kernels:
            out, lse = flash_attention(q, k, v, causal=causal, window=window, sm_scale=sm_scale,
                                       q_offset=q_offset, return_lse=True)
        else:
            out, lse = flash_attention_reference(q, k, v, causal=causal, window=window,
                                                 sm_scale=sm_scale, q_offset=q_offset,
                                                 block_k=block_k, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, sm_scale=sm_scale, q_offset=q_offset)
        ctx.use_kernels = use_kernels
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = _bwd.flash_attention_backward if ctx.use_kernels else \
            flash_attention_backward_reference
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_trainable(q, k, v, *, causal=True, window=None, sm_scale=None, q_offset=0,
                              block_k=512, use_kernels=None):
    """`flash_attention` with a gradient: the kernels on CUDA tensors, the
    plain forward and backward on CPU tensors (or with use_kernels=False)."""
    if use_kernels is None:
        use_kernels = q.is_cuda
    return FlashAttention.apply(q, k, v, causal, window, sm_scale, q_offset, block_k,
                                use_kernels)
