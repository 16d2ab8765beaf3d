"""Plain reference of the dense GQA decoder as its configuration states it
(the port's block, whose departures from the published model the
configuration lists under ``assumed``).

A layer: x + Wo attn(rope(Wq h), rope(Wk h), Wv h) with h = rmsnorm(x),
causal softmax attention scaled by 1/sqrt(head_dim), each group of
n_heads / n_kv_heads query heads reading one key-value head; then
x + W_down (silu(W_gate h) * W_up h) with h = rmsnorm(x).  Rotary
embedding on every dimension, half-split: the first and second halves of
a head are the rotated pairs, frequencies theta^(-i / (hd / 2)).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..weights import Leaf
from .common import Products, rmsnorm


def layout(mc: Dict) -> List[Leaf]:
    """(name, shape, dtype, init, std) of every weight, in the program's
    parameter layout: a group of `n_layers` stacked layers."""
    d, L, V, f = mc["d_model"], mc["n_layers"], mc["vocab_size"], mc["d_ff"]
    h, hkv = mc["n_heads"], mc["n_kv_heads"]
    hd = mc.get("head_dim") or d // h
    dt = mc["dtype"]
    if L < 2:
        raise ValueError("the layout stacks the layers: n_layers >= 2")
    b = "blocks/0/l0/"
    return [
        ("embed", (V, d), dt, "normal", 1.0),
        (b + "ffn/norm", (L, d), "float32", "normal", 0.1),
        (b + "ffn/w_down", (L, f, d), dt, "normal", f ** -0.5),
        (b + "ffn/w_gate", (L, d, f), dt, "normal", d ** -0.5),
        (b + "ffn/w_up", (L, d, f), dt, "normal", d ** -0.5),
        (b + "mixer/norm", (L, d), "float32", "normal", 0.1),
        (b + "mixer/wk", (L, d, hkv, hd), dt, "normal", d ** -0.5),
        (b + "mixer/wo", (L, h, hd, d), dt, "normal", (h * hd) ** -0.5),
        (b + "mixer/wq", (L, d, h, hd), dt, "normal", d ** -0.5),
        (b + "mixer/wv", (L, d, hkv, hd), dt, "normal", d ** -0.5),
        ("final_norm", (d,), "float32", "normal", 0.1),
        ("lm_head", (d, V), dt, "normal", d ** -0.5),
    ]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, H, S, D] rotated by position 0..S-1, half-split pairs."""
    S, D = x.shape[2], x.shape[3]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(w: Dict[str, torch.Tensor], x: torch.Tensor, mc: Dict, prod: Products
          ) -> torch.Tensor:
    B, S, d = x.shape
    h_, hkv = mc["n_heads"], mc["n_kv_heads"]
    hd = mc.get("head_dim") or d // h_
    eps, theta = mc["norm_eps"], mc.get("rope_theta", 10000.0)
    h = rmsnorm(x, w["mixer/norm"], eps)

    def heads(wt, n):
        return prod.mm(h, wt.reshape(d, n * hd)).view(B, S, n, hd).transpose(1, 2)

    q = rope(heads(w["mixer/wq"], h_), theta)
    k = rope(heads(w["mixer/wk"], hkv), theta).repeat_interleave(h_ // hkv, dim=1)
    v = heads(w["mixer/wv"], hkv).repeat_interleave(h_ // hkv, dim=1)
    scores = prod.mm(q, k.transpose(-1, -2)) / hd ** 0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).triu_(1)
    p = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    del scores
    o = prod.mm(p, v).transpose(1, 2).reshape(B, S, h_ * hd)
    x = x + prod.mm(o, w["mixer/wo"].reshape(h_ * hd, d))
    h = rmsnorm(x, w["ffn/norm"], eps)
    return x + prod.mm(F.silu(prod.mm(h, w["ffn/w_gate"])) * prod.mm(h, w["ffn/w_up"]),
                       w["ffn/w_down"])
