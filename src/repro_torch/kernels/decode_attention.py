"""Single-token decode attention: the hand-written CUDA kernel and its plain version.

Replaces ``repro/kernels/decode_attention.py:decode_attention``, the Pallas
TPU kernel (one query per head over a KV cache with a per-sequence valid
``length``, online softmax over key blocks, GQA via KV head ``h // group``).
The kernel is ``csrc/decode_attention.cu``; its plain PyTorch version is
``ref.decode_attention_reference``.

What bounds it on the H100: bytes.  At the serving decode shape
(llama3.2-3b, B=4, 8 KV heads, length ~1024-1056, D=128, bf16) one launch
reads ~17 MB of live K/V, about 5 us at 3.35 TB/s, and does ~1 FLOP per
byte.  The design: a split pass with one block per (256-key chunk, KV
head, batch) that serves the whole query-head group, so each K/V row is
read once and enough blocks are in flight to pull the bandwidth; chunks
past ``length`` return at once, so the cache tail is never read (the
Pallas grid visits every block of the cache); a combine pass merges the
chunks.  One call is two kernel launches and counts as one.

``launches`` counts kernel launches; the plain path never adds to it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import decode_attention_reference

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.repro_decode_chunk.argtypes = []
        lib.repro_decode_chunk.restype = ctypes.c_int
    return lib


def decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,  # [B, Hkv, S, D]
    *,
    length: Optional[torch.Tensor] = None,  # [B] int32 valid lengths
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """One query per head over the first `length[b]` keys; output [B, Hq, D].

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, sm_scale=sm_scale, length=length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    hkv, s = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"decode_attention: {hq} query heads are not a multiple of {hkv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "float32 or bfloat16, all the same")
    if length is None:
        length = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if length.dtype != torch.int32 or tuple(length.shape) != (b,):
        raise ValueError(f"decode_attention: length must be int32 [{b}], got "
                         f"{length.dtype} {tuple(length.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("length", length)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous and 16-byte aligned")
    if s == 0:
        raise ValueError("decode_attention: empty KV cache")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        lib = _lib()
        n_chunks = -(-s // lib.repro_decode_chunk())
        part_ml = torch.empty((b, hq, n_chunks, 2), dtype=torch.float32, device=q.device)
        part_acc = torch.empty((b, hq, n_chunks, d), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(), out.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(), _DTYPE_CODES[q.dtype],
            b, hq, hkv, s, d, n_chunks, scale, stream)
    if err:
        raise RuntimeError(f"decode_attention: kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    return out
