"""Flash attention: the hand-written CUDA forward kernels, the gradient, and
their plain versions.

Replaces ``repro/kernels/flash_attention.py:flash_attention``, the Pallas
TPU kernel (FlashAttention-2 forward with causal, local-window and
``q_offset`` masking, GQA via KV head ``h // group``, fp32 softmax state).
Its plain PyTorch version is ``ref.flash_attention_reference``.  Two
kernels take the work, by dtype alone (``_route``):

  * bf16 -> ``"wgmma"``, ``csrc/flash_attention_sm90.cu``: products on the
    tensor cores (``wgmma``), Q and K/V tiles by TMA into shared memory (K
    and V on barriers of their own, two to four stages), each consumer
    warpgroup's softmax of one tile under its P V of the tile before, P
    rounded to bf16 before P V, as FlashAttention-2/3 do; a persistent grid
    of ``min(tiles, SMs)`` blocks walks the work tiles longest first
    (``work_tiles``, ``block_walk``);
  * fp32 -> ``"cuda_core"``, ``csrc/flash_attention.cu``: register-tiled
    products on CUDA cores in full fp32 (``wgmma`` on fp32 is TF32, about
    three decimal digits, which the fp32 tolerance of 2e-5 rules out).

Nothing falls back from one route to the other.

What bounds it on the H100: at the serving prefill shape (llama3.2-3b,
B=4, S=1024, causal, bf16) one launch does 25.8 GFLOP on 67 MB, so the
bound is the tensor cores' 989 TFLOP/s (about 26 us), not the 3.35 TB/s of
device memory (about 20 us).  Both kernels walk only the KV tiles the masks
leave visible.  PERF.md has their times.

Training differentiates through ``FlashAttention``, a ``torch.autograd.Function``
whose forward also writes each row's log-sum-exp and whose backward is the
hand-written kernel of ``flash_attention_bwd`` (the JAX package has no
backward kernel; it differentiates its XLA reference).

``launches`` counts forward kernel launches, ``launches_by_route`` the same
launches by route; the plain path never adds to either.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from . import flash_attention_bwd as _bwd
from .ref import flash_attention_backward_reference, flash_attention_reference

HEAD_DIMS = (32, 64, 112, 128, 160, 256)
ROUTES = ("wgmma", "cuda_core")

launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)


def _route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes (dtype, head_dim): "wgmma" for bf16, "cuda_core"
    for fp32; raises for anything else."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {head_dim} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"flash_attention: dtype {dtype}; float32 or bfloat16")


def work_tiles(b: int, hq: int, hkv: int, sq: int, causal: bool):
    """The wgmma forward's work tiles, (batch, first query head, first row),
    in the order its blocks take them.  A tile is 128 rows of one head, or,
    when the group size hq / hkv is even, the same 64 rows of two heads of one
    KV group; causal tiles come last rows first, so the longest come first.
    The kernel computes the same order (``work_tile`` in the source)."""
    hpb, span, gx, gy = _tile_grid(b, hq, hkv, sq)
    tiles = []
    for w in range(gx * gy):
        x, y = w % gx, w // gx
        tiles.append((x // (hq // hpb), (x % (hq // hpb)) * hpb,
                      (gy - 1 - y if causal else y) * span))
    return tiles


def _tile_grid(b: int, hq: int, hkv: int, sq: int):
    """(heads a tile, rows a tile, tiles across heads, tiles down the rows)."""
    hpb, span = (2, 64) if (hq // hkv) % 2 == 0 else (1, 128)
    return hpb, span, b * hq // hpb, -(-sq // span)


def block_walk(b: int, hq: int, hkv: int, sq: int, causal: bool, sms: int):
    """The tiles of `work_tiles` that each block of the persistent grid
    takes, in its order: min(tiles, sms) blocks, block p taking tiles p,
    p + blocks, p + 2 blocks, ...  It follows from the shape and the SM count
    alone; which block computes a row never changes its bits."""
    tiles = work_tiles(b, hq, hkv, sq, causal)
    n = min(len(tiles), sms)
    return [tiles[p::n] for p in range(n)]


def _fn(route: str):
    """The C entry point of `route`'s library, its argument types set."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if route == "wgmma":
        fn = _build.load("flash_attention_sm90").repro_flash_attention_sm90
        types = [p] * 5 + [i] * 6 + [f, i, i, i, i, p]
    else:
        fn = _build.load("flash_attention").repro_flash_attention
        types = [p] * 5 + [i] * 7 + [f, i, i, i, p]
    if fn.argtypes is None:
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return fn


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
    route = _route(q.dtype, d)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "float32 or bfloat16, all the same")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        # TMA (the wgmma route) also needs a 16-byte aligned base and row
        # strides in multiples of 16 bytes: d * 2 bytes is, for every head dim
        if not t.is_contiguous() or t.data_ptr() % 16 or (d * t.element_size()) % 16:
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
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if return_lse else None)
        if route == "wgmma":  # the persistent grid: a block an SM, or a tile each
            _, _, gx, gy = _tile_grid(b, hq, hkv, sq)
            args = (b, hq, hkv, sq, sk, d, scale, int(bool(causal)), int(window or 0),
                    int(q_offset), min(gx * gy, _bwd._sm_count(q.device.index)))
        else:  # the CUDA-core kernel: 0 = float32
            args = (0, b, hq, hkv, sq, sk, d, scale, int(bool(causal)), int(window or 0),
                    int(q_offset))
        err = _fn(route)(*ptrs, *args, stream)
    if err:
        raise RuntimeError(f"flash_attention: {route} kernel launch failed with cudaError {err}")
    global launches
    launches += 1
    launches_by_route[route] += 1
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
