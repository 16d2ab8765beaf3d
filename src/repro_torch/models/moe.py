"""Mixture-of-Experts FFN: ``repro.models.moe`` in PyTorch.

One param layout, three ways to run it, as in the JAX package:

  * ``dense`` - every expert processes every token, masked combine.  Exact
    and simple; the only one that runs on one device.
  * ``ep_a2a`` - expert parallelism: tokens routed into per-expert capacity
    slots, exchanged with an all_to_all, run through the local experts as one
    batched product, returned and combined at the origin.
  * ``tp_sort`` - tensor-parallel MoE for fewer experts than devices: tokens
    grouped by expert, each device computes its slice of every expert's
    width, and a psum completes the down projection.

The port has no device mesh yet (the distribution layer, ROADMAP M2), so
``moe_apply`` resolves ``ep_a2a`` and ``tp_sort`` to ``dense``, as the
reference does without a mesh.  ``_ep_a2a_local`` and ``_tp_sort_local`` are
the per-device bodies at world size 1 (``WORLD``), where their collectives
(``_all_to_all``, ``_all_gather``, ``_psum``) are the identity; the tests
hold them to ``dense`` at capacity factor 8, where no token is dropped.

Two choices differ from the JAX code in form, not in value:

  * ``torch.topk`` promises no order among equal values, so the router takes
    the first k of a stable descending sort: ties go to the lower expert
    index, as ``jax.lax.top_k`` sends them, on the CPU and on the card.
  * ``_dense_moe`` materialises ``[T, E, d_expert]`` three times and
    ``[T, E, d]`` twice (the second in fp32): at kimi-k2's 384 experts that
    is ~21 MB a token.  The port runs it in chunks of tokens, each chunk's
    intermediates at most ``DENSE_CHUNK_ELEMENTS`` elements; a token's sum
    over experts does not depend on the other tokens, so the chunks give the
    same values and only the peak memory changes.

The expert products are batched matrix products (``torch.bmm``), the JAX
package's einsums, outside any kernel.  The combine stays in fp32 before the
cast back to the model dtype, as in JAX.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import norm_spec, rmsnorm
from .params import ParamSpec

Params = Dict[str, Any]

# the dense path's token chunk: its [E, chunk, max(d, d_expert)] products
# stay under this many elements (kimi-k2: 195 tokens a chunk)
DENSE_CHUNK_ELEMENTS = 1 << 29


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    assert cfg.moe is not None
    d, m = cfg.d_model, cfg.moe
    dt = cfg.torch_dtype
    specs = {
        "norm": norm_spec(cfg),
        "w_router": ParamSpec((d, m.num_experts), ("embed", "expert"), torch.float32, "scaled"),
        "w_gate": ParamSpec((m.num_experts, d, m.d_expert), ("expert", "embed", "expert_mlp"),
                            dt, "scaled"),
        "w_up": ParamSpec((m.num_experts, d, m.d_expert), ("expert", "embed", "expert_mlp"),
                          dt, "scaled"),
        "w_down": ParamSpec((m.num_experts, m.d_expert, d), ("expert", "expert_mlp", "embed"),
                            dt, "scaled"),
    }
    if m.num_shared:
        f = m.d_expert * m.num_shared
        specs["ws_gate"] = ParamSpec((d, f), ("embed", "mlp"), dt, "scaled")
        specs["ws_up"] = ParamSpec((d, f), ("embed", "mlp"), dt, "scaled")
        specs["ws_down"] = ParamSpec((f, d), ("mlp", "embed"), dt, "scaled")
    return specs


def _route(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """Returns (weights [T, k] fp32, expert ids [T, k] int64): the k most
    probable experts, ties to the lower index, weights renormalised."""
    probs = torch.softmax(x.float() @ w_router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return vals, idx


def _expert_ffn(xe: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """xe: [E, C, d] -> [E, C, d] (batched per-expert SwiGLU)."""
    return torch.bmm(F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up), w_down)


def _dense_chunk(p, xt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    m = cfg.moe
    T = xt.shape[0]
    w, idx = _route(xt, p["w_router"], m.top_k)
    combine = torch.zeros((T, m.num_experts), dtype=torch.float32, device=xt.device)
    combine.scatter_add_(1, idx, w)
    h = _expert_ffn(xt.unsqueeze(0).expand(m.num_experts, -1, -1), p["w_gate"], p["w_up"],
                    p["w_down"])                                         # [E, T, d]
    # sum over experts in fp32: [T, 1, E] @ [T, E, d]
    y = torch.bmm(combine.unsqueeze(1), h.float().transpose(0, 1))[:, 0]
    return y.to(xt.dtype)


def _dense_moe(p, xt: torch.Tensor, cfg: ModelConfig,
               chunk: Optional[int] = None) -> torch.Tensor:
    """Every expert on every token, in chunks of at most `chunk` tokens (by
    default as many as DENSE_CHUNK_ELEMENTS allows)."""
    m = cfg.moe
    if chunk is None:
        widest = m.num_experts * max(cfg.d_model, m.d_expert)
        chunk = max(1, DENSE_CHUNK_ELEMENTS // widest)
    T = xt.shape[0]
    n = -(-T // chunk)  # chunks of even size, so no chunk is a lone token's
    if n <= 1:
        return _dense_chunk(p, xt, cfg)
    return torch.cat([_dense_chunk(p, xt[T * i // n:T * (i + 1) // n], cfg) for i in range(n)])


def _ranks_within_expert(fe: torch.Tensor, num_experts: int):
    """Stable order + per-expert rank for flat expert assignments [A]."""
    A = fe.shape[0]
    order = torch.sort(fe, stable=True).indices
    se = fe[order]
    starts = torch.searchsorted(se, torch.arange(num_experts, dtype=se.dtype, device=se.device))
    rank = torch.arange(A, dtype=torch.int64, device=fe.device) - starts[se]
    return order, se, rank


# The collectives of the expert-parallel bodies over the model axis.  The
# port runs one device (world size 1, index 0) until the distribution layer
# (ROADMAP M2) gives it torch.distributed; there each is the identity.
WORLD, INDEX = 1, 0


def _all_to_all(x: torch.Tensor) -> torch.Tensor:
    return x


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    return x


def _psum(x: torch.Tensor) -> torch.Tensor:
    return x


def _dispatch(xt: torch.Tensor, w_router: torch.Tensor, cfg: ModelConfig):
    """Routes `xt` into per-expert capacity slots: (buffer [E * cap, d], cap,
    and each assignment's slot, token and weight, 0 where it was dropped,
    in the stable order by expert)."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    t = xt.shape[0]
    w, idx = _route(xt, w_router, k)
    fe, fw = idx.reshape(-1), w.reshape(-1)
    ft = torch.arange(t, device=xt.device).repeat_interleave(k)
    cap = max(1, math.ceil(t * k / E * m.capacity_factor))
    order, se, rank = _ranks_within_expert(fe, E)
    keep = rank < cap
    slot = se * cap + rank.clamp(0, cap - 1)
    sx = torch.where(keep[:, None], xt[ft[order]], torch.zeros((), dtype=xt.dtype,
                                                               device=xt.device))
    buf = torch.zeros((E * cap, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, slot, sx)
    return buf, cap, slot, ft[order], fw[order] * keep


def _combine(ret: torch.Tensor, slot, tok, weight, t: int, dtype) -> torch.Tensor:
    """Each kept assignment's expert output, weighted, added at its token."""
    yflat = ret[slot] * weight.to(ret.dtype)[:, None]
    y = torch.zeros((t, ret.shape[1]), dtype=dtype, device=ret.device)
    return y.index_add_(0, tok, yflat.to(dtype))


def _ep_a2a_local(xt, w_router, w_gate, w_up, w_down, *, cfg: ModelConfig):
    """One device's body of expert parallelism: xt [t, d] local tokens,
    the experts sharded over WORLD devices, this one INDEX."""
    E = cfg.moe.num_experts
    e_loc = E // WORLD
    t = xt.shape[0]
    # each device routes a distinct 1/WORLD token slice when the count divides
    slice_tokens = t >= WORLD and t % WORLD == 0
    tj = t // WORLD if slice_tokens else t
    xj = xt[INDEX * tj:(INDEX + 1) * tj] if slice_tokens else xt
    send, cap, slot, tok, weight = _dispatch(xj, w_router, cfg)
    send = send.reshape(WORLD, e_loc * cap, xt.shape[1])
    recv = _all_to_all(send)  # [WORLD, e_loc * cap, d]: each peer's slots for my experts
    xe = recv.reshape(WORLD, e_loc, cap, -1).transpose(0, 1).reshape(e_loc, WORLD * cap, -1)
    ye = _expert_ffn(xe, w_gate, w_up, w_down)
    back = ye.reshape(e_loc, WORLD, cap, -1).transpose(0, 1).reshape(WORLD, e_loc * cap, -1)
    ret = _all_to_all(back).reshape(E * cap, -1)
    yj = _combine(ret, slot, tok, weight, tj, xt.dtype)
    return _all_gather(yj) if slice_tokens else yj


def _tp_sort_local(xt, w_router, w_gate, w_up, w_down, *, cfg: ModelConfig):
    """One device's body of TP-MoE: every expert's width sharded over
    WORLD devices (w_gate, w_up [E, d, f / WORLD], w_down [E, f / WORLD, d])."""
    E = cfg.moe.num_experts
    buf, cap, slot, tok, weight = _dispatch(xt, w_router, cfg)
    ye = _psum(_expert_ffn(buf.reshape(E, cap, -1), w_gate, w_up, w_down))
    return _combine(ye.reshape(E * cap, -1), slot, tok, weight, xt.shape[0], xt.dtype)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MoE block with residual: x [B, S, d] -> [B, S, d]."""
    m = cfg.moe
    B, S, d = x.shape
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    xt = h.reshape(B * S, d)
    # ep_a2a and tp_sort need a mesh's model axis; without one the
    # reference, and so the port, runs dense
    y = _dense_moe(p, xt, cfg).reshape(B, S, d)
    if m.num_shared:
        y = y + (F.silu(h @ p["ws_gate"]) * (h @ p["ws_up"])) @ p["ws_down"]
    return x + y
