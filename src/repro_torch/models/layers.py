"""Decoder building blocks: RMSNorm, RoPE, GQA attention (global/local) and
the SwiGLU FFN.  The RG-LRU and Mamba mixers are not ported yet.

Every mixer exposes ``<kind>_specs(cfg)`` -> {name: ParamSpec} and
``<kind>_apply(params, x, cfg, mode, cache)`` -> (y, cache) where mode is
"train" | "prefill" | "decode".  Unlike the JAX package, which returns new
cache arrays, the port writes the KV cache in place and returns the dict it
was given; its layout is the JAX one, ``[B, Hkv, L, hd]`` per layer.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .params import ParamSpec

Params = Dict[str, Any]


# ------------------------------------------------------------------ norms
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Scales by ``1 + w`` (the norms are zero-initialised), in fp32."""
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf * scale) * (1.0 + w.float())).to(x.dtype)


def norm_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), ("embed",), torch.float32, init="zeros")


# ------------------------------------------------------------------- rope
@functools.lru_cache(maxsize=None)
def _rope_freqs(d: int, theta: float, device: torch.device) -> torch.Tensor:
    # numpy float32 exactly as the JAX package computes them (layers.py:41);
    # `theta ** x` in torch can differ in the last ulp.  Cached per device so
    # the host-to-device copy happens once, not on every layer.
    half = d // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(freqs, dtype=np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, H, S, D]; positions: [S] or [B, S].  Half-split layout:
    the first and second halves of each head are the rotated pairs."""
    d = x.shape[-1]
    half = d // 2
    freqs = _rope_freqs(d, float(theta), x.device)
    if positions.dim() == 1:
        ang = (positions[:, None].float() * freqs[None, :])[None, None]      # [1,1,S,half]
    else:
        ang = (positions[:, :, None].float() * freqs[None, None, :])[:, None]  # [B,1,S,half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# -------------------------------------------------------------- attention
def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads_eff, cfg.n_kv_heads, cfg.hd
    dt = cfg.torch_dtype
    specs = {
        "norm": norm_spec(cfg),
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), dt, "scaled"),
        "wk": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), dt, "scaled"),
        "wv": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), dt, "scaled"),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"), dt, "scaled"),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), dt, "zeros")
        specs["bk"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"), dt, "zeros")
        specs["bv"] = ParamSpec((hkv, hd), ("kv_heads", "head_dim"), dt, "zeros")
    return specs


def _heads(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bhsk") as one matrix product."""
    B, S, d = h.shape
    _, H, K = w.shape
    return (h.reshape(B * S, d) @ w.reshape(d, H * K)).view(B, S, H, K).permute(0, 2, 1, 3)


def prefill_max_len(cfg: ModelConfig, seq: int, window: Optional[int]) -> int:
    """The max_len prefill sizes a layer's cache with (see attn_cache_shape):
    max(cfg.max_cache_len, seq) slots, or a local window's min(window,
    cfg.max_cache_len)."""
    return cfg.max_cache_len if window is not None else max(cfg.max_cache_len, seq)


def attn_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, mode: str,
    cache: Optional[Dict] = None, pos: Optional[int] = None,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Attention block with residual.  `pos` (decode) is the position of the
    token, one Python int for the whole batch (prompts are equal-length).

    prefill fills `cache` ({"k", "v"}: [B, Hkv, L, hd], sized by
    attn_cache_shape with prefill_max_len) in place: keys at positions < L
    in slots 0..S-1 and zeros after, or, for a local window W, the last W
    keys in ring order (position p in slot p % W).  decode writes slot
    `pos` (`pos % W` for a ring) in place and attends over the first
    min(pos + 1, L) slots.
    """
    B, S, _ = x.shape
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v = _heads(h, p["wq"]), _heads(h, p["wk"]), _heads(h, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and a position")
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        ck, cv = cache["k"], cache["v"]
        L = ck.shape[2]
        slot = pos % window if (window is not None and L == window) else pos
        slot = min(slot, L - 1)  # as jax.lax.dynamic_update_slice clamps
        ck[:, :, slot] = k[:, :, 0].to(ck.dtype)
        cv[:, :, slot] = v[:, :, 0].to(cv.dtype)
        length = torch.full((B,), min(pos + 1, L), dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q[:, :, 0].contiguous(), ck, cv, length=length,
                                   impl=cfg.attn_impl)[:, :, None, :]
        new_cache = cache
    else:
        positions = torch.arange(S, device=x.device)
        q = rope(q, positions, cfg.rope_theta).contiguous()
        k = rope(k, positions, cfg.rope_theta).contiguous()
        out = ops.flash_attention(q, k, v.contiguous(), causal=True, window=window,
                                  impl=cfg.attn_impl, block_k=cfg.attn_block_k)
        new_cache = None
        if mode == "prefill":
            if cache is None:
                raise ValueError("prefill needs the cache to fill")
            for name, src in (("k", k), ("v", v)):
                dst = cache[name]
                L = dst.shape[2]
                if window is not None:
                    tail = src[:, :, -L:]
                    n = tail.shape[2]
                    if n < L:
                        dst[:, :, :n] = tail
                        dst[:, :, n:] = 0
                    else:  # ring layout: key at absolute pos p lives in slot p % L
                        dst.copy_(torch.roll(tail, S % L, dims=2))
                else:
                    n = min(S, L)
                    dst[:, :, :n] = src[:, :, :n]
                    dst[:, :, n:] = 0
            new_cache = cache
    y = out.to(x.dtype).permute(0, 2, 1, 3).reshape(B * S, -1) @ p["wo"].reshape(-1, x.shape[-1])
    return x + y.view(B, S, -1), new_cache


def attn_cache_shape(cfg: ModelConfig, batch: int, max_len: int, window: Optional[int]):
    """{"k", "v"} -> (shape, dtype) of one layer's decode cache."""
    L = min(window, max_len) if window is not None else max_len
    shape = (batch, cfg.n_kv_heads, L, cfg.hd)
    return {"k": (shape, cfg.torch_dtype), "v": (shape, cfg.torch_dtype)}


# ------------------------------------------------------------------- FFN
def ffn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    return {
        "norm": norm_spec(cfg),
        "w_gate": ParamSpec((d, f), ("embed", "mlp"), dt, "scaled"),
        "w_up": ParamSpec((d, f), ("embed", "mlp"), dt, "scaled"),
        "w_down": ParamSpec((f, d), ("mlp", "embed"), dt, "scaled"),
    }


def ffn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    y = (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]
    return x + y


# ------------------------------------------------------ recurrent mixers
_RECURRENT = ("the {} mixer is not ported yet: ROADMAP.md queue 1 item 8 "
              "(recurrent mixers)")


def rglru_specs(cfg: ModelConfig):
    raise NotImplementedError(_RECURRENT.format("rglru"))


def rglru_apply(*args, **kwargs):
    raise NotImplementedError(_RECURRENT.format("rglru"))


def mamba_specs(cfg: ModelConfig):
    raise NotImplementedError(_RECURRENT.format("mamba"))


def mamba_apply(*args, **kwargs):
    raise NotImplementedError(_RECURRENT.format("mamba"))
