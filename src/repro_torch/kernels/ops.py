"""Public kernel entry points with backend dispatch.

Models call these; the implementation is selected by `impl`:

  * "cuda"  — the hand-written CUDA kernels (raises on a CPU tensor);
  * "torch" — the plain PyTorch versions (``ref.py``), on any device;
  * "auto"  — "cuda" for CUDA tensors, "torch" for CPU tensors.
"""

from __future__ import annotations

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import log_checksum as _checksum
from . import mamba_scan as _mamba
from . import ref
from . import rglru_scan as _rglru
from . import topk_compress as _topk

IMPLS = ("auto", "cuda", "torch")


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got a tensor on {x.device}")
    return impl


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal=True, window=None, sm_scale=None,
                    q_offset=0, impl="auto", block_k=512):
    """Tensors that need a gradient go through the differentiable
    ``FlashAttention``: the forward and backward kernels for "cuda", their
    plain versions for "torch"."""
    resolved = _resolve(impl, q)
    if _needs_grad(q, k, v):
        return _flash.flash_attention_trainable(
            q, k, v, causal=causal, window=window, sm_scale=sm_scale, q_offset=q_offset,
            block_k=block_k, use_kernels=resolved == "cuda")
    if resolved == "torch":
        return ref.flash_attention_reference(
            q, k, v, causal=causal, window=window, sm_scale=sm_scale,
            q_offset=q_offset, block_k=block_k)
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  sm_scale=sm_scale, q_offset=q_offset)


def decode_attention(q, k, v, *, length=None, sm_scale=None, impl="auto", return_lse=False):
    """With `return_lse`, (out, lse [B, Hq] fp32): what merging attention
    over chunks of a cache by their log-sum-exp needs."""
    if _resolve(impl, q) == "torch":
        return ref.decode_attention_reference(q, k, v, sm_scale=sm_scale, length=length,
                                              return_lse=return_lse)
    return _decode.decode_attention(q, k, v, length=length, sm_scale=sm_scale,
                                    return_lse=return_lse)


def rglru_scan(x, r, i, log_a, h0=None, *, c=8.0, impl="auto", scan_dtype=None):
    """Tensors that need a gradient go through the differentiable
    ``RGLRUScan``: the forward and reverse-scan kernels for "cuda", their
    plain versions for "torch".

    ``scan_dtype`` (bf16 rounding of the recurrence) reaches only the plain
    version, as the JAX package passes it only to its XLA reference; the
    CUDA kernels, like the Pallas kernel, keep the carry in fp32.  Under a
    gradient with ``scan_dtype`` set, the plain route is torch's autograd of
    the plain forward, whose roundings the plain backward does not repeat."""
    resolved = _resolve(impl, x)
    if _needs_grad(x, r, i, log_a, h0) and not (resolved == "torch" and scan_dtype is not None):
        return _rglru.RGLRUScan.apply(x, r, i, log_a, h0, c, resolved == "cuda")
    if resolved == "torch":
        return ref.rglru_reference(x, r, i, log_a, h0, c=c, scan_dtype=scan_dtype)
    return _rglru.rglru_scan(x, r, i, log_a, h0, c=c)[:2]


def mamba_scan(x, delta, A, B, C, D, h0=None, *, impl="auto", scan_dtype=None):
    """Tensors that need a gradient go through the differentiable
    ``MambaScan`` (see ``rglru_scan``, also for ``scan_dtype``)."""
    resolved = _resolve(impl, x)
    if (_needs_grad(x, delta, A, B, C, D, h0)
            and not (resolved == "torch" and scan_dtype is not None)):
        return _mamba.MambaScan.apply(x, delta, A, B, C, D, h0, resolved == "cuda")
    if resolved == "torch":
        return ref.mamba_scan_reference(x, delta, A, B, C, D, h0, scan_dtype=scan_dtype)
    return _mamba.mamba_scan(x, delta, A, B, C, D, h0)[:2]


def topk_compress(x, k, *, block=1024, impl="auto"):
    """(vals [nb, k] fp32, idx [nb, k] int32, residual [n]) of a 1-D tensor."""
    if _resolve(impl, x) == "torch":
        return ref.topk_compress_reference(x, k, block=block)
    return _topk.topk_compress(x, k, block=block)


def topk_decompress(vals, idx, n, *, block=1024):
    """[n]: each block's vals at idx, zeros elsewhere (plain PyTorch, as the
    JAX package has no kernel for it)."""
    return ref.topk_decompress_reference(vals, idx, n, block=block)


def fletcher32(x, *, impl="auto"):
    """0-d int64 Fletcher-32 of a uint8 byte tensor or of int words < 2^16."""
    if _resolve(impl, x) == "torch":
        return ref.fletcher32_reference(x)
    return _checksum.fletcher32(x)


def fletcher32_wave(chunks, *, impl="auto"):
    """[len(chunks)] int64: the Fletcher-32 of each uint8 chunk, one launch."""
    if not chunks:
        raise ValueError("fletcher32_wave: no chunks")
    if _resolve(impl, chunks[0]) == "torch":
        return ref.fletcher32_wave_reference(chunks)
    return _checksum.fletcher32_wave(chunks)
