"""Decoder building blocks: RMSNorm, RoPE, GQA attention (global/local),
the SwiGLU FFN, the RG-LRU recurrent block and the Mamba-1 block.

Every mixer exposes ``<kind>_specs(cfg)`` -> {name: ParamSpec} and
``<kind>_apply(params, x, cfg, mode, cache)`` -> (y, cache) where mode is
"train" | "prefill" | "decode".  Unlike the JAX package, which returns new
cache arrays, the port writes its caches in place and returns the dict it
was given.  Their layout is the JAX one: ``{"k", "v"}`` ``[B, Hkv, L, hd]``
per attention layer, ``{"h", "conv"}`` per recurrent layer (``h`` fp32,
``conv`` the last inputs of the causal conv, in the model dtype).

Where JAX's defaults differ from torch's, the port matches JAX by hand:
``jax.nn.gelu`` is the tanh approximation, and ``jax.nn.softplus`` is
``logaddexp(x, 0)`` with no linear cut-off.
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


# ---------------------------------------------------------------- RG-LRU
def rglru_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    dr = d                      # lru width = d_model
    nb = cfg.n_heads            # block-diagonal gate heads
    bs = dr // nb
    dc = 4
    dt = cfg.torch_dtype
    return {
        "norm": norm_spec(cfg),
        "w_x": ParamSpec((d, dr), ("embed", "mlp"), dt, "scaled"),
        "w_gate": ParamSpec((d, dr), ("embed", "mlp"), dt, "scaled"),
        "conv_w": ParamSpec((dc, dr), ("conv", "mlp"), dt, "scaled"),
        "w_r": ParamSpec((nb, bs, bs), ("heads", None, None), dt, "scaled"),
        "w_i": ParamSpec((nb, bs, bs), ("heads", None, None), dt, "scaled"),
        "log_a": ParamSpec((dr,), ("mlp",), torch.float32, "zeros"),
        "w_out": ParamSpec((dr, d), ("mlp", "embed"), dt, "scaled"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv (kernel K) via shifts.  x: [B,S,D]; w: [K,D];
    state: [B,K-1,D] previous inputs (decode).  The K shifted products are
    summed in x's dtype, in the JAX package's order."""
    K = w.shape[0]
    if state is not None:
        full = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        full = F.pad(x, (0, 0, K - 1, 0))
    S = x.shape[1]
    y = sum(full[:, i : i + S, :] * w[i][None, None, :] for i in range(K))
    new_state = full[:, -(K - 1) :, :] if K > 1 else None
    return y, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), which torch's softplus is not
    above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _neg_log_a(p_log_a: torch.Tensor) -> torch.Tensor:
    # learned parameter is unconstrained; effective log_a = -softplus(param)
    return -_softplus(p_log_a + 5.0) * 0.1


def _left_pad_tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last `n` steps of x [B,S,D], zero-padded on the left when S < n."""
    return x[:, -n:, :] if x.shape[1] >= n else F.pad(x, (0, 0, n - x.shape[1], 0))


def rglru_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, mode: str,
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """RG-LRU block with residual.  prefill fills `cache` ({"h": [B, dr]
    fp32, "conv": [B, 3, dr]}) in place; decode reads and updates it in
    place with the closed-form single step.  In train mode the scan is
    differentiable: ``ops.rglru_scan`` takes the forward and reverse-scan
    kernels on the card, their plain versions on the CPU."""
    B, S, _ = x.shape
    nb = p["w_r"].shape[0]
    dr = p["w_x"].shape[1]
    bs = dr // nb
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    xb = h @ p["w_x"]
    gb = h @ p["w_gate"]
    conv_state = cache["conv"] if (cache is not None and mode == "decode") else None
    xc, new_conv = _causal_conv(xb, p["conv_w"], conv_state)
    xh = xc.reshape(B, S, nb, bs)  # the gates are block-diagonal: one product per head
    r = torch.sigmoid(torch.einsum("bshe,hef->bshf", xh, p["w_r"]).reshape(B, S, dr))
    gi = torch.sigmoid(torch.einsum("bshe,hef->bshf", xh, p["w_i"]).reshape(B, S, dr))
    log_a = _neg_log_a(p["log_a"])
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        # closed-form single step (no scan)
        log_at = 8.0 * r[:, 0] * log_a[None]
        a = torch.exp(log_at)
        b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), min=1e-12)) * (gi[:, 0] * xc[:, 0])
        hT = a * cache["h"] + b
        states = hT[:, None, :]
    else:
        states, hT = ops.rglru_scan(
            xc, r, gi, log_a, None, impl=cfg.attn_impl,
            scan_dtype=torch.bfloat16 if cfg.scan_bf16 else None)
    y = F.gelu(gb, approximate="tanh") * states.to(x.dtype)
    y = y @ p["w_out"]
    if mode == "train":
        return x + y, None
    if cache is None:
        raise ValueError("prefill needs the cache to fill")
    if mode == "prefill":
        new_conv = _left_pad_tail(xb, 3)
    cache["h"].copy_(hT)
    cache["conv"].copy_(new_conv)
    return x + y, cache


def rglru_cache_shape(cfg: ModelConfig, batch: int):
    """{"h", "conv"} -> (shape, dtype) of one layer's recurrent cache."""
    dr = cfg.d_model
    return {"h": ((batch, dr), torch.float32), "conv": ((batch, 3, dr), cfg.torch_dtype)}


# ----------------------------------------------------------------- Mamba
def mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    if cfg.ssm is None:
        raise ValueError(f"{cfg.name}: a mamba layer needs cfg.ssm")
    d = cfg.d_model
    di = cfg.ssm.expand * d
    N = cfg.ssm.d_state
    dc = cfg.ssm.d_conv
    dtr = cfg.ssm.dt_rank or -(-d // 16)
    dt = cfg.torch_dtype
    return {
        "norm": norm_spec(cfg),
        "w_in": ParamSpec((d, 2 * di), ("embed", "mlp"), dt, "scaled"),
        "conv_w": ParamSpec((dc, di), ("conv", "mlp"), dt, "scaled"),
        "conv_b": ParamSpec((di,), ("mlp",), dt, "zeros"),
        "w_xproj": ParamSpec((di, dtr + 2 * N), ("mlp", None), dt, "scaled"),
        "w_dt": ParamSpec((dtr, di), (None, "mlp"), dt, "scaled"),
        "b_dt": ParamSpec((di,), ("mlp",), torch.float32, "ones"),
        "A_log": ParamSpec((di, N), ("mlp", "state"), torch.float32, "zeros"),
        "D": ParamSpec((di,), ("mlp",), torch.float32, "ones"),
        "w_out": ParamSpec((di, d), ("mlp", "embed"), dt, "scaled"),
    }


def mamba_apply(
    p: Params, x: torch.Tensor, cfg: ModelConfig, mode: str,
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba-1 block with residual.  prefill fills `cache` ({"h": [B, di, N]
    fp32, "conv": [B, K-1, di]}) in place; decode reads and updates it in
    place with the closed-form single step.  In train mode the scan is
    differentiable: ``ops.mamba_scan`` takes the forward and reverse-scan
    kernels on the card, their plain versions on the CPU."""
    N = cfg.ssm.d_state
    di = p["w_in"].shape[1] // 2
    dtr = p["w_dt"].shape[0]
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    xz = h @ p["w_in"]
    xs, z = xz[..., :di], xz[..., di:]
    conv_state = cache["conv"] if (cache is not None and mode == "decode") else None
    xc, new_conv = _causal_conv(xs, p["conv_w"], conv_state)
    xc = F.silu(xc + p["conv_b"][None, None, :])
    proj = xc @ p["w_xproj"]
    dt_in, Bm, Cm = proj[..., :dtr], proj[..., dtr : dtr + N], proj[..., dtr + N :]
    delta = _softplus((dt_in @ p["w_dt"]).float() + p["b_dt"][None, None, :])
    A = -torch.exp(p["A_log"])
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        a = torch.exp(delta[:, 0, :, None] * A[None])                      # [B,di,N]
        b = (delta[:, 0] * xc[:, 0].float())[:, :, None] * Bm[:, 0, None, :].float()
        hT = a * cache["h"] + b
        y = torch.einsum("bdn,bn->bd", hT, Cm[:, 0].float()) + xc[:, 0].float() * p["D"][None]
        y = y[:, None, :]
    else:
        y, hT = ops.mamba_scan(
            xc, delta, A, Bm.contiguous(), Cm.contiguous(), p["D"], None, impl=cfg.attn_impl,
            scan_dtype=torch.bfloat16 if cfg.scan_bf16 else None)
    y = y.to(x.dtype) * F.silu(z)
    y = y @ p["w_out"]
    if mode == "train":
        return x + y, None
    if cache is None:
        raise ValueError("prefill needs the cache to fill")
    if mode == "prefill":
        new_conv = _left_pad_tail(xs, p["conv_w"].shape[0] - 1)
    cache["h"].copy_(hT)
    cache["conv"].copy_(new_conv)
    return x + y, cache


def mamba_cache_shape(cfg: ModelConfig, batch: int):
    """{"h", "conv"} -> (shape, dtype) of one layer's recurrent cache."""
    di = cfg.ssm.expand * cfg.d_model
    K = cfg.ssm.d_conv
    return {"h": ((batch, di, cfg.ssm.d_state), torch.float32),
            "conv": ((batch, K - 1, di), cfg.torch_dtype)}
