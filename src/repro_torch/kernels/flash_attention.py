"""Flash attention forward: the hand-written CUDA kernel and its plain version.

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

``launches`` counts kernel launches; the plain path never adds to it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import flash_attention_reference

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, i, i, p]
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
) -> torch.Tensor:
    """Attention of q over k/v; output [B, Hq, Sq, D] in q's dtype.

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window,
                                         sm_scale=sm_scale, q_offset=q_offset)
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
    if q.numel() == 0:
        return out
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
            b, hq, hkv, sq, sk, d, scale, int(bool(causal)), int(window or 0), int(q_offset),
            stream)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    return out
