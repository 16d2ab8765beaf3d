"""Plain PyTorch versions of the attention and linear-scan kernels.

The torch twins of ``repro.kernels.ref``'s attention and scan oracles.  They
are the CPU path of the port, the oracle its CUDA kernels are held against
on the card, and the path ``attn_impl="torch"`` takes on any device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _scale(sm_scale: Optional[float], d: int) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)


def mha_reference(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Naive O(S^2) attention with GQA, causal and local-window masking.

    `q_offset` is the absolute position of q[0] (decode: offset = cache len).
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = _scale(sm_scale, d)
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vv).to(q.dtype)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
    block_k: int = 512,
) -> torch.Tensor:
    """Blocked online-softmax attention over KV blocks of `block_k` keys.

    The same algorithm as the kernels: fp32 running max, denominator and
    accumulator; masked logits are NEG_INF; the ragged tail is zero-padded.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = _scale(sm_scale, d)
    pad = (-sk) % block_k
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    nk = k.shape[2] // block_k
    qf = q.float()
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    for ib in range(nk):
        sl = slice(ib * block_k, (ib + 1) * block_k)
        kblk = k[:, :, sl].repeat_interleave(group, dim=1).float()
        vblk = v[:, :, sl].repeat_interleave(group, dim=1).float()
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, kblk) * scale
        kpos = ib * block_k + torch.arange(block_k, device=q.device)[None, :]
        mask = kpos < sk
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        logits = torch.where(mask[None, None], logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vblk)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def decode_attention_reference(
    q: torch.Tensor,  # [B, Hq, D] single query
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    length: Optional[torch.Tensor] = None,  # [B] valid KV lengths
) -> torch.Tensor:
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = _scale(sm_scale, d)
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), kk) * scale
    if length is not None:
        mask = torch.arange(s, device=q.device)[None, None, :] < length.to(q.device)[:, None, None]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", probs, vv).to(q.dtype)


# ============================================================== linear scans
def linear_scan_reference(
    a: torch.Tensor,  # [B, S, ...] decay
    b: torch.Tensor,  # [B, S, ...] input term
    h0: Optional[torch.Tensor] = None,  # [B, ...] initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t, one step at a time: returns (all states
    [B, S, ...], final state [B, ...]).  The carry is in a's dtype, promoted
    with h0's where one is given (as the JAX scan's carry is)."""
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0.to(torch.promote_types(a.dtype, h0.dtype))
    states = torch.empty(a.shape, dtype=h.dtype, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        states[:, t] = h
    return states, h


def mamba_scan_reference(
    x: torch.Tensor,      # [B, S, Din]
    delta: torch.Tensor,  # [B, S, Din]  (post-softplus)
    A: torch.Tensor,      # [Din, N] (negative)
    Bm: torch.Tensor,     # [B, S, N]
    Cm: torch.Tensor,     # [B, S, N]
    D: torch.Tensor,      # [Din]
    h0: Optional[torch.Tensor] = None,  # [B, Din, N]
    *,
    scan_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan: returns (y [B, S, Din] in x's dtype, h_final
    [B, Din, N] fp32).  a_t = exp(delta_t A), b_t = delta_t x_t B_t, and
    y_t = C_t . h_t + D x_t, all in fp32.  It steps over the sequence and
    never holds a [B, S, Din, N] tensor.  `scan_dtype` rounds a, b and the
    carry to that type, as the JAX oracle does."""
    b_, s, din = x.shape
    xf, dt = x.float(), delta.float()
    dx = dt * xf
    Af, Bf, Cf = A.float(), Bm.float(), Cm.float()
    sd = scan_dtype or torch.float32
    h = (torch.zeros((b_, din, A.shape[1]), dtype=sd, device=x.device) if h0 is None
         else h0.to(sd))
    ys = torch.empty((b_, s, din), dtype=torch.float32, device=x.device)
    for t in range(s):
        a = torch.exp(dt[:, t, :, None] * Af[None])
        b = dx[:, t, :, None] * Bf[:, t, None, :]
        h = a.to(sd) * h + b.to(sd)
        ys[:, t] = torch.einsum("bdn,bn->bd", h.float(), Cf[:, t])
    y = ys + xf * D.float()[None, None]
    return y.to(x.dtype), h.float()


def rglru_reference(
    x: torch.Tensor,      # [B, S, D]
    r: torch.Tensor,      # [B, S, D] recurrence gate in (0,1)
    i: torch.Tensor,      # [B, S, D] input gate in (0,1)
    log_a: torch.Tensor,  # [D] learned log decay (negative)
    h0: Optional[torch.Tensor] = None,  # [B, D]
    *,
    c: float = 8.0,
    scan_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU (RecurrentGemma): h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t),
    a_t = exp(c r_t log_a).  Returns (states [B, S, D] in x's dtype, h_final
    [B, D] fp32).  The arithmetic and its types follow the JAX oracle: the
    gate product i_t x_t is taken in x's dtype, the rest in fp32."""
    log_at = c * r * log_a[None, None]
    a = torch.exp(log_at)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), min=1e-12)) * (i * x)
    sd = scan_dtype or torch.float32
    states, hT = linear_scan_reference(a.to(sd), b.to(sd), h0)
    return states.to(x.dtype), hT.float()
