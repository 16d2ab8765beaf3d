"""Decoder building blocks: RMSNorm, RoPE, GQA attention (global/local),
the SwiGLU FFN, the RG-LRU recurrent block and the Mamba-1 block.

Every mixer exposes ``<kind>_specs(cfg)`` -> {name: ParamSpec} and
``<kind>_apply(params, x, cfg, mode, cache, rules=...)`` -> (y, cache) where
mode is "train" | "prefill" | "decode".  Unlike the JAX package, which
returns new cache arrays, the port writes its caches in place and returns
the dict it was given.  Their layout is the JAX one: ``{"k", "v"}`` ``[B,
Hkv, L, hd]`` per attention layer, ``{"h", "conv"}`` per recurrent layer
(``h`` fp32, ``conv`` the last inputs of the causal conv, in the model
dtype).

On a device mesh the activations and weights are DTensors: each product
runs on the shards (``mm``, ``spmd.linear``), the elementwise ops as
DTensor operations, ``constrain`` puts the activations on the placements of
their logical axes at the JAX package's points, and the kernels run on each
rank's shards (``_attn_mesh``): attention on its own heads, or on its own
query rows against the gathered keys and values (sequence-parallel), and
decode over its own chunk of a length-sharded cache, the chunks merged by
their log-sum-exp.  The recurrent mixers run on their channel shards
over "model" where it divides them, else data-parallel (``_mixer_mesh``).
A plain tensor takes the code it took before meshes existed.

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

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels import ops
from . import spmd
from .config import ModelConfig
from .params import ParamSpec, constrain, placements_of

Params = Dict[str, Any]


# ------------------------------------------------------------------ norms
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Scales by ``1 + w`` (the norms are zero-initialised), in fp32."""
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf * scale) * (1.0 + w.float())).to(x.dtype)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for x [..., k] and w [k, n]; on a mesh ``spmd.linear``, the
    same product on each rank's shards."""
    return spmd.linear(x, w) if isinstance(x, DTensor) else x @ w


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
    window: Optional[int] = None, rules: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Attention block with residual.  `pos` (decode) is the position of the
    token, one Python int for the whole batch (prompts are equal-length).

    prefill fills `cache` ({"k", "v"}: [B, Hkv, L, hd], sized by
    attn_cache_shape with prefill_max_len) in place: keys at positions < L
    in slots 0..S-1 and zeros after, or, for a local window W, the last W
    keys in ring order (position p in slot p % W).  decode writes slot
    `pos` (`pos % W` for a ring) in place and attends over the first
    min(pos + 1, L) slots.

    On a mesh (`x` a DTensor), `rules` places q, k, v, the cache and the
    output (see ``_attn_mesh``).
    """
    if isinstance(x, DTensor):
        return _attn_mesh(p, x, cfg, rules or {}, mode, cache, pos, window)
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


def _kv_for_heads(kv: torch.Tensor, kv_off: int, q_off: int, hq: int, group: int
                  ) -> torch.Tensor:
    """The KV heads of query heads [q_off, q_off + hq) (GQA: head h reads
    KV head h // group), out of `kv` [B, Hkv_local, S, D] whose first head
    is KV head `kv_off`, laid out so the kernels' own mapping (local query
    head i -> KV head i // (hq / heads)) finds them."""
    lo, hi = q_off // group, (q_off + hq - 1) // group + 1
    a, b = lo - kv_off, hi - kv_off
    if a < 0 or b > kv.shape[1]:
        raise ValueError(f"query heads [{q_off}, {q_off + hq}) need KV heads [{lo}, {hi}), "
                         f"this rank holds [{kv_off}, {kv_off + kv.shape[1]})")
    if (q_off % group == 0 and hq % group == 0) or b - a == 1:
        return kv if (a, b) == (0, kv.shape[1]) else kv[:, a:b].contiguous()
    idx = torch.tensor([(q_off + i) // group - kv_off for i in range(hq)], device=kv.device)
    return kv.index_select(1, idx)


def _heads_mesh(h: DTensor, w: DTensor, rules: Dict, heads_axis: str) -> DTensor:
    """``_heads`` on a mesh: the product [B, S, H * hd] placed on whole heads
    (its batch, sequence and heads by their activation rules) before it is
    viewed as [B, S, H, hd], so no rank holds a slice of a head."""
    B, S, _ = h.shape
    _, H, K = w.shape
    # the rows each rank projects: its batch, and its sequence under act_seq
    h = constrain(h, rules, "act_batch", "act_seq")
    pl = placements_of((B, S, H, K), ("act_batch", "act_seq", heads_axis), h.device_mesh, rules)
    y = spmd.linear(h, spmd.flatten(w, 1, 2), want=pl)
    return spmd.to_placements(y, pl).view(B, S, H, K).permute(0, 2, 1, 3)


def _seq_replicated(t: DTensor) -> DTensor:
    """`t` [B, H, S, D] with its sequence dim gathered on every rank."""
    return spmd.to_placements(t, [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
                                  for p in t.placements])


def _flash_mesh(q: DTensor, k: DTensor, v: DTensor, cfg: ModelConfig, window):
    """The flash kernel on this rank's batch rows and query heads, or its
    query rows (q sharded on S: sequence-parallel) against all keys at
    `q_offset` = its first row.  Returns this rank's output [B, H, S, D]
    shard, and its roped keys and values over every position (for the
    prefill cache)."""
    split = spmd.split_dims(q)
    ql = spmd.local_part(q, split)
    kg, vg = _seq_replicated(k), _seq_replicated(v)
    kl, vl = spmd.local_part(kg, split), spmd.local_part(vg, split)
    q0 = spmd.shard_offset(q, 2)
    ql = rope(ql, torch.arange(q0, q0 + ql.shape[2], device=ql.device), cfg.rope_theta)
    kl = rope(kl, torch.arange(kl.shape[2], device=kl.device), cfg.rope_theta)
    group = q.shape[1] // k.shape[1]
    heads = (spmd.shard_offset(kg, 1), spmd.shard_offset(q, 1), ql.shape[1], group)
    out = ops.flash_attention(ql.contiguous(), _kv_for_heads(kl.contiguous(), *heads),
                              _kv_for_heads(vl.contiguous(), *heads), causal=True,
                              window=window, q_offset=q0, impl=cfg.attn_impl,
                              block_k=cfg.attn_block_k)
    return out, kl, vl


def _fill_cache_mesh(cache: Dict, kl: torch.Tensor, vl: torch.Tensor, S: int, window) -> None:
    """Prefill's cache writes on this rank's shard of each cache DTensor (its
    batch rows and KV heads are those of `kl`; its slots may be a chunk of
    the length): the same slots as the plain path's."""
    for name, src in (("k", kl), ("v", vl)):
        dst = cache[name]
        dl = dst.to_local()
        if dl.shape[:2] != src.shape[:2]:
            raise ValueError(f"cache {name} shard {tuple(dl.shape)} does not hold the rows and "
                             f"heads of the keys {tuple(src.shape)}")
        L, l0, n_loc = dst.shape[2], spmd.shard_offset(dst, 2), dl.shape[2]
        if window is not None:
            tail = src[:, :, -L:]
            n = tail.shape[2]
            full = F.pad(tail, (0, 0, 0, L - n)) if n < L else torch.roll(tail, S % L, dims=2)
            dl.copy_(full[:, :, l0:l0 + n_loc])
        else:
            n = max(0, min(min(S, L) - l0, n_loc))
            dl[:, :, :n] = src[:, :, l0:l0 + n]
            dl[:, :, n:] = 0


def _decode_mesh(q: DTensor, k: DTensor, v: DTensor, cfg: ModelConfig, cache: Dict,
                 pos: int, window) -> DTensor:
    """One decode step on this rank's shard of the cache: the rank that holds
    slot `pos` writes the new key and value; each rank attends over its own
    slots with its own query heads; where the cache is sharded on its length,
    the ranks' outputs merge by their log-sum-exp (``spmd.merge_by_lse``).
    Returns this rank's output [B, H, 1, D] shard."""
    mesh = q.device_mesh
    ck, cv = cache["k"], cache["v"]
    kv_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 2 else p
                  for p in ck.placements)
    k, v = (spmd.to_placements(t, kv_pl) for t in (k, v))
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    positions = torch.full((ql.shape[0], 1), pos, dtype=torch.int64, device=ql.device)
    ql = rope(ql, positions, cfg.rope_theta)
    kl = rope(kl, positions, cfg.rope_theta)
    ckl, cvl = ck.to_local(), cv.to_local()
    L, l0, n_loc = ck.shape[2], spmd.shard_offset(ck, 2), ckl.shape[2]
    slot = pos % window if (window is not None and L == window) else pos
    slot = min(slot, L - 1)  # as jax.lax.dynamic_update_slice clamps
    if l0 <= slot < l0 + n_loc:
        ckl[:, :, slot - l0] = kl[:, :, 0].to(ckl.dtype)
        cvl[:, :, slot - l0] = vl[:, :, 0].to(cvl.dtype)
    n_live = max(0, min(min(pos + 1, L) - l0, n_loc))
    length = torch.full((ql.shape[0],), n_live, dtype=torch.int32, device=ql.device)
    heads = (spmd.shard_offset(ck, 1), spmd.shard_offset(q, 1), ql.shape[1],
             q.shape[1] // ck.shape[1])
    kk, vv = _kv_for_heads(ckl, *heads), _kv_for_heads(cvl, *heads)
    qd = ql[:, :, 0].contiguous()
    len_dims = spmd.dims_sharding(ck, 2)
    if len_dims:
        o, lse = ops.decode_attention(qd, kk, vv, length=length, impl=cfg.attn_impl,
                                      return_lse=True)
        o = spmd.merge_by_lse(o, lse, length > 0, mesh, len_dims)
    else:
        o = ops.decode_attention(qd, kk, vv, length=length, impl=cfg.attn_impl)
    return o[:, :, None, :]


def _attn_mesh(p: Params, x: DTensor, cfg: ModelConfig, rules: Dict, mode: str,
               cache: Optional[Dict], pos: Optional[int], window: Optional[int]):
    """attn_apply on a mesh: the products as DTensor operations, q, k, v and
    the output constrained as in the JAX package, the kernels on shards."""
    B, S, d = x.shape
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = _heads_mesh(h, p["wq"], rules, "act_heads")
    k = _heads_mesh(h, p["wk"], rules, "act_kv_heads")
    v = _heads_mesh(h, p["wv"], rules, "act_kv_heads")
    if cfg.qkv_bias:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    # TP over heads when divisible, else sequence-parallel attention
    # (rules map act_heads/act_seq per arch x mesh; see launch.mesh.rules_for)
    q = constrain(q, rules, "act_batch", "act_heads", "act_seq")
    k = constrain(k, rules, "act_batch", "act_kv_heads", "act_seq")
    v = constrain(v, rules, "act_batch", "act_kv_heads", "act_seq")
    new_cache = None
    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and a position")
        out = _decode_mesh(q, k, v, cfg, cache, pos, window)
        new_cache = cache
    else:
        out, kl, vl = _flash_mesh(q, k, v, cfg, window)
        if mode == "prefill":
            if cache is None:
                raise ValueError("prefill needs the cache to fill")
            _fill_cache_mesh(cache, kl, vl, S, window)
            new_cache = cache
    # [B, S, H * D] from the shards, so no rank views a slice of a head
    o = out.to(x.dtype).permute(0, 2, 1, 3).reshape(out.shape[0], out.shape[2], -1)
    pl = [Shard({0: 0, 1: 2, 2: 1}[p.dim]) if isinstance(p, Shard) else p for p in q.placements]
    o = spmd.from_shards(o, q.device_mesh, pl, (B, S, q.shape[1] * q.shape[3]))
    y = mm(o, spmd.flatten(p["wo"], 0, 1))
    return x + constrain(y, rules, "act_batch"), new_cache


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


def ffn_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, rules: Optional[Dict] = None
              ) -> torch.Tensor:
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    y = mm(F.silu(mm(h, p["w_gate"])) * mm(h, p["w_up"]), p["w_down"])
    return x + constrain(y, rules or {}, "act_batch")


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
    if isinstance(x, DTensor):
        return _mixer_mesh("rglru", p, x, cfg, mode, cache)
    y = _rglru_mix(p, rmsnorm(x, p["norm"], cfg.norm_eps), cfg, mode, cache)
    return x + y, (None if mode == "train" else cache)


def _rglru_mix(p: Params, h: torch.Tensor, cfg: ModelConfig, mode: str,
               cache: Optional[Dict]) -> torch.Tensor:
    """The RG-LRU branch of the normed input `h`, up to its ``w_out``
    product, writing `cache` in prefill and decode.  Its channels are
    those of the weights: all of them, or on a mesh a rank's shard (whole
    gate blocks), the output then its partial sum."""
    B, S, _ = h.shape
    nb = p["w_r"].shape[0]
    dr = p["w_x"].shape[1]
    bs = dr // nb
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
    y = F.gelu(gb, approximate="tanh") * states.to(h.dtype)
    y = y @ p["w_out"]
    if mode == "train":
        return y
    if cache is None:
        raise ValueError("prefill needs the cache to fill")
    if mode == "prefill":
        new_conv = _left_pad_tail(xb, 3)
    cache["h"].copy_(hT)
    cache["conv"].copy_(new_conv)
    return y


# a recurrent mixer's weights: the dim of each that holds its channels (None:
# no channel dim); the gate blocks of RG-LRU's w_r and w_i are whole channels
_CHANNEL_DIM = {
    "mamba": {"norm": None, "w_in": 1, "conv_w": 1, "conv_b": 0, "w_xproj": 0, "w_dt": 1,
              "b_dt": 0, "A_log": 0, "D": 0, "w_out": 0},
    "rglru": {"norm": None, "w_x": 1, "w_gate": 1, "conv_w": 1, "w_r": 0, "w_i": 0,
              "log_a": 0, "w_out": 0},
}
_CACHE_CHANNEL_DIM = {"h": 1, "conv": 2}   # {"h": [B, C(, N)], "conv": [B, K-1, C]}


def _regroup(xz: torch.Tensor, ax: spmd.ModelAxis) -> torch.Tensor:
    """``w_in``'s column-parallel product [..., 2c] holds this rank's
    columns of [x | z], chunks 2i and 2i + 1 of their 2m chunks of c
    columns; returns chunks i and m + i, this rank's x and z channels, by
    one all_to_all (chunk k goes to rank k % m)."""
    m, i = ax.size, ax.index
    if m == 1:
        return xz
    c = xz.shape[-1] // 2
    rows = xz.numel() // (2 * c)
    chunks = xz.reshape(rows, 2, c).transpose(0, 1)            # chunks 2i, 2i + 1
    dest = [(2 * i) % m, (2 * i + 1) % m]
    if dest[0] > dest[1]:
        chunks, dest = chunks.flip(0), dest[::-1]
    src = [k // 2 for k in (i, m + i)]                         # ascending for m > 1
    got = ax.all_to_all(chunks.reshape(2 * rows, c),
                        [rows if r in src else 0 for r in range(m)],
                        [rows if r in dest else 0 for r in range(m)])
    return got.reshape(2, rows, c).transpose(0, 1).reshape(*xz.shape[:-1], 2 * c)


def channel_route(kind: str, p: Params, x: DTensor, cache: Optional[Dict] = None) -> bool:
    """Whether a recurrent mixer on a mesh runs on channel shards: the mesh
    has a "model" dim that leaves x's batch rows alone and divides the
    channels (and, for RG-LRU, its gate blocks), and every cache leaf lies
    on x's batch rows and this rank's channels."""
    mesh = x.device_mesh
    if "model" not in mesh.mesh_dim_names:
        return False
    mdim = mesh.mesh_dim_names.index("model")
    m = mesh.size(mdim)
    if isinstance(x.placements[mdim], Shard) and x.placements[mdim].dim == 0:
        return False
    if kind == "mamba":
        ok = (p["w_in"].shape[1] // 2) % m == 0
    else:
        ok = p["w_x"].shape[1] % m == 0 and p["w_r"].shape[0] % m == 0
    if ok and cache is not None:
        rows = _rows(x)
        for k, c in cache.items():
            want = list(rows)
            want[mdim] = Shard(_CACHE_CHANNEL_DIM[k])
            if any(a != b for a, b, n in zip(c.placements, want, mesh.shape) if n > 1):
                return False
    return ok


def _rows(x: DTensor) -> Tuple[Any, ...]:
    """x's placements on its batch rows only (Shard(0) kept, else replicated)."""
    return tuple(q if isinstance(q, Shard) and q.dim == 0 else Replicate() for q in x.placements)


def _mixer_mesh(kind: str, p: Params, x: DTensor, cfg: ModelConfig, mode: str,
                cache: Optional[Dict]):
    """A recurrent mixer on a mesh.  Where ``channel_route`` holds, on
    channel shards over "model", as GSPMD partitions the JAX package's
    mixers by their weights' specs: each rank runs the mixer's code on its
    batch rows and its channels (the in-projections column-parallel, the
    conv, gates and scan on the shard, the caches' shards written in place,
    ``w_out`` row-parallel), Mamba's ``x_proj`` partial sums summed over
    "model", and the output's partial sums reduced to x's rows.  Otherwise
    data-parallel (``_mixer_rows``)."""
    if not channel_route(kind, p, x, cache):
        return _mixer_rows(kind, p, x, cfg, mode, cache)
    mesh = x.device_mesh
    mdim = mesh.mesh_dim_names.index("model")
    m = mesh.size(mdim)
    rows = _rows(x)
    xr = spmd.to_placements(x, rows)
    split = sorted(set(spmd.split_dims(xr)) | ({mdim} if m > 1 else set()))
    pl = {}
    for k, w in p.items():
        d = _CHANNEL_DIM[kind][k]
        want = tuple(Shard(d) if i == mdim and d is not None and m > 1 else Replicate()
                     for i in range(mesh.ndim))
        pl[k] = spmd.local_part(spmd.to_placements(w, want), split)
    cl = None if cache is None else {k: c.to_local() for k, c in cache.items()}
    h = rmsnorm(spmd.local_part(xr, split), pl["norm"], cfg.norm_eps)
    if kind == "mamba":
        y = _mamba_mix(pl, h, cfg, mode, cl, spmd.ModelAxis(mesh))
    else:
        y = _rglru_mix(pl, h, cfg, mode, cl)
    part = tuple(Partial() if i == mdim and m > 1 else q for i, q in enumerate(rows))
    y = spmd.to_placements(spmd.from_shards(y, mesh, part, x.shape), rows)
    return xr + y, (None if mode == "train" else cache)


def _mixer_rows(kind: str, p: Params, x: DTensor, cfg: ModelConfig, mode: str,
                cache: Optional[Dict]):
    """A recurrent mixer on a mesh, data-parallel only: each rank runs the
    plain mixer (its code and kernels) on its batch rows with the weights
    gathered whole, so the ranks along every other mesh dim repeat the same
    work.  The cache leaves (placed by name, channels over "model") are
    gathered the same way for the step and each rank's shard written back.
    The route of a mixer whose channels "model" does not divide."""
    apply = mamba_apply if kind == "mamba" else rglru_apply
    mesh = x.device_mesh
    rows = _rows(x)
    xr = x if tuple(x.placements) == rows else x.redistribute(mesh, rows)
    split = spmd.split_dims(xr)
    whole = (Replicate(),) * mesh.ndim
    pl = {k: spmd.local_part(w if tuple(w.placements) == whole else w.redistribute(mesh, whole),
                             split) for k, w in p.items()}
    cl = None
    if cache is not None:
        cl = {k: (c if tuple(c.placements) == rows else c.redistribute(mesh, rows)).to_local()
              for k, c in cache.items()}
    y, _ = apply(pl, spmd.local_part(xr, split), cfg, mode, cache=cl)
    if cache is not None:
        for k, c in cache.items():
            mine = c.to_local()
            if mine.data_ptr() != cl[k].data_ptr():
                src = cl[k]
                for d in range(1, c.dim()):
                    n0 = spmd.shard_offset(c, d)
                    src = src.narrow(d, n0, mine.shape[d])
                mine.copy_(src)
    return spmd.from_shards(y, mesh, rows, x.shape), cache


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
    if isinstance(x, DTensor):
        return _mixer_mesh("mamba", p, x, cfg, mode, cache)
    y = _mamba_mix(p, rmsnorm(x, p["norm"], cfg.norm_eps), cfg, mode, cache)
    return x + y, (None if mode == "train" else cache)


def _mamba_mix(p: Params, h: torch.Tensor, cfg: ModelConfig, mode: str,
               cache: Optional[Dict], chan: Optional[spmd.ModelAxis] = None) -> torch.Tensor:
    """The Mamba branch of the normed input `h`, up to its ``w_out``
    product, writing `cache` in prefill and decode.  With `chan` (a mesh's
    model dim) the weights are a rank's channel shards: ``w_in``'s columns
    come back as this rank's x and z channels (``_regroup``), ``x_proj``'s
    partial sums are summed over the ranks (``chan.sum``), and the output is
    the rank's partial sum."""
    N = cfg.ssm.d_state
    di = p["w_in"].shape[1] // 2
    dtr = p["w_dt"].shape[0]
    xz = h @ p["w_in"]
    if chan is not None:
        xz = _regroup(xz, chan)
    xs, z = xz[..., :di], xz[..., di:]
    conv_state = cache["conv"] if (cache is not None and mode == "decode") else None
    xc, new_conv = _causal_conv(xs, p["conv_w"], conv_state)
    xc = F.silu(xc + p["conv_b"][None, None, :])
    proj = xc @ p["w_xproj"]
    if chan is not None:
        proj = chan.sum(proj)
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
    y = y.to(h.dtype) * F.silu(z)
    y = y @ p["w_out"]
    if mode == "train":
        return y
    if cache is None:
        raise ValueError("prefill needs the cache to fill")
    if mode == "prefill":
        new_conv = _left_pad_tail(xs, p["conv_w"].shape[0] - 1)
    cache["h"].copy_(hT)
    cache["conv"].copy_(new_conv)
    return y


def mamba_cache_shape(cfg: ModelConfig, batch: int):
    """{"h", "conv"} -> (shape, dtype) of one layer's recurrent cache."""
    di = cfg.ssm.expand * cfg.d_model
    K = cfg.ssm.d_conv
    return {"h": ((batch, di, cfg.ssm.d_state), torch.float32),
            "conv": ((batch, K - 1, di), cfg.torch_dtype)}
