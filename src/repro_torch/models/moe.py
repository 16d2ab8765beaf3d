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

``moe_apply`` chooses among them as the reference does: ``dense`` without
a mesh or without a ``"model"`` mesh dim, ``tp_sort`` when the experts do
not divide the model dim.  ``_ep_a2a_local`` and ``_tp_sort_local`` are
the per-rank bodies of the reference's ``shard_map``s, over the model
dim's process group (``spmd.ModelAxis``): the token exchange is ``all_to_all_single`` of
``torch.distributed.nn.functional`` (its gradient is the exchange back),
and the gather of the routed slices and the psum of the width slices are
DTensor redistributions (Shard -> Replicate, Partial -> Replicate), whose
gradients follow the model's convention that a replicated activation's
gradient is whole on every rank.  With no group (a single device) the
bodies run at world size 1, where each collective is the identity; the
tests hold them to ``dense`` at capacity factor 8, where no token is
dropped.

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
from torch.distributed.tensor import DTensor, Replicate, Shard

from . import spmd
from .config import ModelConfig
from .layers import mm, norm_spec, rmsnorm
from .params import ParamSpec, constrain

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


def _ep_a2a_local(xt, w_router, w_gate, w_up, w_down, *, cfg: ModelConfig,
                  axis: Optional[spmd.ModelAxis] = None):
    """One rank's body of expert parallelism: xt [t, d] local tokens
    (replicated over the model axis), the experts sharded over it."""
    ax = axis or spmd.ModelAxis()
    E = cfg.moe.num_experts
    e_loc = E // ax.size
    t = xt.shape[0]
    # Each model-rank routes a distinct 1/size token slice when the local
    # token count divides; tiny decode batches fall back to replicated
    # routing (every rank dispatches all local tokens; correct, redundant).
    slice_tokens = t >= ax.size and t % ax.size == 0
    tj = t // ax.size if slice_tokens else t
    xj = xt[ax.index * tj:(ax.index + 1) * tj] if slice_tokens else xt
    send, cap, slot, tok, weight = _dispatch(xj, w_router, cfg)
    send = send.reshape(ax.size, e_loc * cap, xt.shape[1])
    recv = ax.all_to_all(send)  # [size, e_loc * cap, d]: each peer's slots for my experts
    xe = recv.reshape(ax.size, e_loc, cap, -1).transpose(0, 1).reshape(e_loc, ax.size * cap, -1)
    ye = _expert_ffn(xe, w_gate, w_up, w_down)
    back = ye.reshape(e_loc, ax.size, cap, -1).transpose(0, 1).reshape(ax.size, e_loc * cap, -1)
    ret = ax.all_to_all(back).reshape(E * cap, -1)
    yj = _combine(ret, slot, tok, weight, tj, xt.dtype)
    if slice_tokens:
        return ax.all_gather(yj)
    if ax.size > 1 and yj.requires_grad:
        # replicated routing: each rank's output holds every token, and its
        # gradient is whole on every rank; one copy of each token carries
        # it (token i's on rank i % size), so no expert, router or token
        # gradient counts the ranks' copies more than once
        mine = (torch.arange(t, device=yj.device) % ax.size == ax.index)[:, None]
        yj = torch.where(mine, yj, yj.detach())
    return yj


def _tp_sort_local(xt, w_router, w_gate, w_up, w_down, *, cfg: ModelConfig,
                   axis: Optional[spmd.ModelAxis] = None):
    """One rank's body of TP-MoE: every expert's width sharded over the
    model axis (w_gate, w_up [E, d, f / size], w_down [E, f / size, d])."""
    ax = axis or spmd.ModelAxis()
    E = cfg.moe.num_experts
    buf, cap, slot, tok, weight = _dispatch(xt, w_router, cfg)
    ye = ax.psum(_expert_ffn(buf.reshape(E, cap, -1), w_gate, w_up, w_down))
    return _combine(ye.reshape(E * cap, -1), slot, tok, weight, xt.shape[0], xt.dtype)


def _impl(cfg: ModelConfig, mesh) -> str:
    impl = cfg.moe.impl
    if impl in ("ep_a2a", "tp_sort") and (mesh is None or "model" not in mesh.mesh_dim_names):
        impl = "dense"
    if impl == "ep_a2a" and cfg.moe.num_experts % mesh.size(
            mesh.mesh_dim_names.index("model")) != 0:
        impl = "tp_sort"  # too few experts for EP: fall back to TP-MoE
    return impl


def _moe_mesh(p: Params, xt: DTensor, cfg: ModelConfig, mesh, impl: str) -> DTensor:
    """The routed experts on a mesh, as the reference's shard_map: tokens
    sharded over every mesh dim but "model" and replicated over it; the
    router replicated; the experts (ep_a2a) or their width (tp_sort) sharded
    over "model", or everything replicated (dense)."""
    dim = mesh.mesh_dim_names.index("model") if "model" in mesh.mesh_dim_names else None
    tok_pl = [Shard(0) if i != dim and xt.shape[0] % mesh.size(i) == 0 else Replicate()
              for i in range(mesh.ndim)]
    if dim is not None:
        tok_pl[dim] = Replicate()
    rep = [Replicate()] * mesh.ndim

    def on(pl_dim, t):  # t placed on `pl_dim` over model (None: replicated)
        pl = list(rep)
        if pl_dim is not None:
            pl[dim] = Shard(pl_dim)
        return t.redistribute(mesh, pl)

    x = xt.redistribute(mesh, tok_pl)
    w_by = {"ep_a2a": (None, 0, 0, 0), "tp_sort": (None, 2, 2, 1),
            "dense": (None, None, None, None)}[impl]
    names = ("w_router", "w_gate", "w_up", "w_down")
    ws = [on(d, p[n]) for d, n in zip(w_by, names)]
    split = spmd.split_dims(x, *ws) + ([dim] if impl == "ep_a2a" and mesh.size(dim) > 1 else [])
    xl = spmd.local_part(x, split)
    wl = [spmd.local_part(w, split) for w in ws]
    if impl == "dense":
        y = _dense_moe(dict(zip(names, wl)), xl, cfg)
    else:
        body = _ep_a2a_local if impl == "ep_a2a" else _tp_sort_local
        y = body(xl, *wl, cfg=cfg, axis=spmd.ModelAxis(mesh, tok_pl))
    return DTensor.from_local(y, mesh, tok_pl, run_check=False, shape=xt.shape,
                              stride=xt.stride())


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, rules: Optional[Dict] = None,
              mesh=None) -> torch.Tensor:
    """The MoE block with residual: x [B, S, d] -> [B, S, d].  Without a
    mesh (a plain `x`) every impl runs dense, as in the reference."""
    m = cfg.moe
    B, S, d = x.shape
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    xt = h.reshape(B * S, d)
    if isinstance(x, DTensor):
        y = _moe_mesh(p, xt, cfg, x.device_mesh, _impl(cfg, mesh)).reshape(B, S, d)
    else:
        # ep_a2a and tp_sort need a mesh's model axis; without one the
        # reference, and so the port, runs dense
        y = _dense_moe(p, xt, cfg).reshape(B, S, d)
    if m.num_shared:
        y = y + mm(F.silu(mm(h, p["ws_gate"])) * mm(h, p["ws_up"]), p["ws_down"])
    return x + constrain(y, rules or {}, "act_batch")
