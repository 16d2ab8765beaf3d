"""Flash attention backward: the hand-written CUDA kernels and their plain version.

The JAX package has no backward kernel for ``repro/kernels/flash_attention.py:
flash_attention``: it differentiates its XLA reference.  On the card the
port's forward is a kernel, so its gradient is one too, a FlashAttention-2
backward in three launches (a pre-pass for ``D = rowsum(dO * O)``, one block
per KV tile for dK/dV, one per q tile for dQ, no atomics, so two runs give
the same bits).  Its plain PyTorch version is
``ref.flash_attention_backward_reference``, the same formulas.  Two kernels
take the work, by dtype alone (``_route``):

  * bf16 -> ``"wgmma"``, ``csrc/flash_attention_bwd_sm90.cu``: all five
    products on the tensor cores (``wgmma``), tiles by TMA, P and dS
    rounded to bf16 before their products;
  * fp32 -> ``"cuda_core"``, ``csrc/flash_attention_bwd.cu``: register-tiled
    products on CUDA cores in full fp32.

Nothing falls back from one route to the other.

What bounds it on the H100: the tensor cores.  At llama3.2-3b's training
shape (B=4, S=1024, causal, bf16) it does 2.5x the forward's 25.8 GFLOP,
about 65 us at 989 TFLOP/s (see the sources and PERF.md).  Head dims 32, 64,
112, 128, 160 and 256 on both routes; at 160 (stablelm-12b) and 256
(recurrentgemma-9b) the wgmma route splits D between its two consumer
warpgroups, and at 256 they also split the recomputed products S^T and dP^T
between them.  Where a KV head's blocks are too few to fill the card (MQA at
a small batch), the wgmma route's dK/dV kernel splits each KV group's query
heads over ``head_splits`` blocks, whose fp32 partials a fourth kernel sums
in a fixed order.

``launches`` counts backward calls (one per backward: the C entry point
issues the three kernels, four with head splits), ``launches_by_route`` the
same calls by route; the plain path never adds to either.
``last_head_splits`` is the HS of the last wgmma call.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from .ref import flash_attention_backward_reference

HEAD_DIMS = (32, 64, 112, 128, 160, 256)
ROUTES = ("wgmma", "cuda_core")
SQ_PAD = 128  # the wgmma route's scratch pads each head's rows to a multiple of this

launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)
last_head_splits = None


def dkdv_keys(head_dim: int) -> int:
    """Keys a block of the wgmma route's dK/dV kernel takes: 64 where its
    warpgroups split D (head dims past 128), 128 otherwise.  The same rule
    as ``DkDv<D>::KEYS`` in ``csrc/flash_attention_bwd_sm90.cu``, which
    points back here: the two change together.  Only the planner reads it,
    so a mismatch would change HS, never the scratch the kernel writes."""
    return 64 if head_dim > 128 else 128


def head_splits(b: int, hq: int, hkv: int, sk: int, head_dim: int, sms: int) -> int:
    """HS: the runs of query heads into which the wgmma route's dK/dV kernel
    splits each KV group, one block each.  The smallest divisor of the group
    size G = hq / hkv that gives the grid (b * hkv * HS blocks by key tiles)
    at least one block per SM; 1 where the grid already has that many, G
    where no divisor reaches it.  It follows from the shape and the card's
    SM count alone, never from the data or a timing, so a shape's bits do
    not change from call to call.  With HS > 1 the kernel takes fp32 scratch
    of 2 * HS * b * hkv * sk * head_dim floats (``partials_numel``)."""
    g = hq // hkv
    blocks = b * hkv * -(-sk // dkdv_keys(head_dim))
    return next((hs for hs in range(1, g + 1) if g % hs == 0 and blocks * hs >= sms), g)


def partials_numel(hs: int, b: int, hkv: int, sk: int, head_dim: int) -> int:
    """fp32 elements of the head splits' dK and dV partials, [2, HS, B, Hkv,
    Sk, D]; 0 where HS = 1 (the kernel then writes bf16 directly)."""
    return 2 * hs * b * hkv * sk * head_dim if hs > 1 else 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes (dtype, head_dim): "wgmma" for bf16, "cuda_core"
    for fp32; raises for anything else."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention_backward: head_dim {head_dim} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"flash_attention_backward: dtype {dtype}; float32 or bfloat16")


def _fn(route: str):
    """The C entry point of `route`'s library, its argument types set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if route == "wgmma":
        fn = _build.load("flash_attention_bwd_sm90").repro_flash_attention_bwd_sm90
        types = [p] * 11 + [i] * 7 + [ctypes.c_float, i, i, i, p]
    else:
        fn = _build.load("flash_attention_bwd").repro_flash_attention_bwd
        types = [p] * 10 + [i] * 7 + [ctypes.c_float, i, i, i, p]
    if fn.argtypes is None:
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return fn


def flash_attention_backward(
    q: torch.Tensor,    # [B, Hq, Sq, D]
    k: torch.Tensor,    # [B, Hkv, Sk, D]
    v: torch.Tensor,    # [B, Hkv, Sk, D]
    o: torch.Tensor,    # [B, Hq, Sq, D]
    lse: torch.Tensor,  # [B, Hq, Sq] fp32
    do: torch.Tensor,   # [B, Hq, Sq, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the types of q, k, v.

    CPU tensors take the plain version.  CUDA tensors launch the kernel, or
    raise when the kernel does not take them: nothing falls back.
    """
    kw = dict(causal=causal, window=window, sm_scale=sm_scale, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: unsupported device {q.device}")
    b, hq, sq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention_backward: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"flash_attention_backward: {hq} query heads are not a multiple of "
                         f"{hkv} KV heads")
    route = _route(q.dtype, d)
    if any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise ValueError("flash_attention_backward: q, k, v, o, do must share one dtype, "
                         f"float32 or bfloat16; got {[t.dtype for t in (q, k, v, o, do)]}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"flash_attention_backward: lse must be float32 {(b, hq, sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_backward: {name} on {t.device}, q on {q.device}")
        # TMA (the wgmma route) also needs the rows of q, k, v, o and dO
        # strided in multiples of 16 bytes: d * 2 bytes is, for every head dim
        row_bytes = d * t.element_size() if t.dim() == 4 else 16
        if not t.is_contiguous() or t.data_ptr() % 16 or row_bytes % 16:
            raise ValueError(f"flash_attention_backward: {name} must be contiguous and "
                             "16-byte aligned")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"flash_attention_backward: {name} has shape {tuple(t.shape)}, "
                             f"q {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_backward: window {window} < 1")
    if sk == 0:
        raise ValueError("flash_attention_backward: empty key sequence")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    outs, dims = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr()), (b, hq, hkv, sq, sk, d)
    if route == "wgmma":  # (lse * log2 e, D) of each row, the rows padded
        scratch = torch.empty(2 * b * hq * (-(-sq // SQ_PAD) * SQ_PAD), dtype=torch.float32,
                              device=q.device)
        hs = head_splits(b, hq, hkv, sk, d, _sm_count(q.device.index))
        n = partials_numel(hs, b, hkv, sk, d)
        part = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
        args = (scratch.data_ptr(), part.data_ptr() if n else None, *outs, *dims, hs)
    else:  # D of each row; the CUDA-core kernel's dtype code 0 = float32
        scratch = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        args = (scratch.data_ptr(), *outs, 0, *dims)
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(route)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), *args, scale, int(bool(causal)), int(window or 0), int(q_offset),
            stream)
    if err:
        raise RuntimeError(f"flash_attention_backward: {route} kernel launch failed with "
                           f"cudaError {err}")
    global launches, last_head_splits
    launches += 1
    launches_by_route[route] += 1
    if route == "wgmma":
        last_head_splits = hs
    return dq, dk, dv
