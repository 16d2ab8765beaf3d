"""Plain PyTorch versions of the attention kernels.

The torch twins of ``repro.kernels.ref``'s attention oracles.  They are the
CPU path of the port, the oracle its CUDA kernels are held against on the
card, and the path ``attn_impl="torch"`` takes on any device.
"""

from __future__ import annotations

import math
from typing import Optional

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
