"""Plain PyTorch versions of every kernel of the port.

The torch twins of ``repro.kernels.ref``'s attention, scan, top-k and
checksum oracles, and the attention backward the JAX package leaves to
autodiff.  They are the CPU path of the port, the oracle its CUDA kernels
are held against on the card, and the path ``impl="torch"`` takes on any
device.
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
    return_lse: bool = False,
):
    """Blocked online-softmax attention over KV blocks of `block_k` keys.

    The same algorithm as the kernels: fp32 running max, denominator and
    accumulator; masked logits are NEG_INF; the ragged tail is zero-padded.
    With `return_lse`, returns (out, lse) where lse [B, Hq, Sq] fp32 is each
    row's log-sum-exp of its scaled logits, ``m + log(l)``: what the
    backward needs to rebuild the probabilities.
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
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l)
    return out


def _visible(sq: int, sk: int, causal: bool, window: Optional[int], q_offset: int,
             device) -> torch.Tensor:
    """[Sq, Sk] bool: key j is visible to query row i (at i + q_offset)."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_backward_reference(
    q: torch.Tensor,    # [B, Hq, Sq, D]
    k: torch.Tensor,    # [B, Hkv, Sk, D]
    v: torch.Tensor,    # [B, Hkv, Sk, D]
    o: torch.Tensor,    # [B, Hq, Sq, D] the forward's output
    lse: torch.Tensor,  # [B, Hq, Sq] fp32 the forward's row log-sum-exp
    do: torch.Tensor,   # [B, Hq, Sq, D] gradient of the output
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the types of q, k, v, by the formulas the backward
    kernel implements, in fp32:

        P  = exp(S - lse) on visible pairs, 0 elsewhere   (S = scale q k^T)
        dV = P^T dO
        D  = rowsum(dO * O)
        dS = P * (dO V^T - D)
        dQ = scale dS K,   dK = scale dS^T Q

    GQA: dK and dV of a KV head sum over the query heads of its group.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = _scale(sm_scale, d)
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = _visible(sq, sk, causal, window, q_offset, q.device)
    p = torch.where(mask[None, None], torch.exp(s - lse.float()[..., None]),
                    torch.zeros((), device=q.device))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    delta = (dof * of).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.view(b, hkv, group, sk, d).sum(dim=2)
    dv = dv.view(b, hkv, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_reference(
    q: torch.Tensor,  # [B, Hq, D] single query
    k: torch.Tensor,  # [B, Hkv, S, D]
    v: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    length: Optional[torch.Tensor] = None,  # [B] valid KV lengths
    return_lse: bool = False,
):
    """With `return_lse`, returns (out, lse [B, Hq] fp32): each row's
    log-sum-exp of its scaled live logits, what merging attention over
    chunks of the cache needs."""
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
    out = torch.einsum("bhk,bhkd->bhd", probs, vv).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


# ============================================================== linear scans
def _acc(x: torch.Tensor) -> torch.dtype:
    """The scans' arithmetic type: fp32, or fp64 for fp64 inputs (gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


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
    ct = _acc(x)
    xf, dt = x.to(ct), delta.to(ct)
    dx = dt * xf
    Af, Bf, Cf = A.to(ct), Bm.to(ct), Cm.to(ct)
    sd = scan_dtype or ct
    h = (torch.zeros((b_, din, A.shape[1]), dtype=sd, device=x.device) if h0 is None
         else h0.to(sd))
    ys = torch.empty((b_, s, din), dtype=ct, device=x.device)
    for t in range(s):
        a = torch.exp(dt[:, t, :, None] * Af[None])
        b = dx[:, t, :, None] * Bf[:, t, None, :]
        h = a.to(sd) * h + b.to(sd)
        ys[:, t] = torch.einsum("bdn,bn->bd", h.to(ct), Cf[:, t])
    y = ys + xf * D.to(ct)[None, None]
    return y.to(x.dtype), h.to(ct)


def mamba_scan_backward_reference(
    x: torch.Tensor,      # [B, S, Din]
    delta: torch.Tensor,  # [B, S, Din]
    A: torch.Tensor,      # [Din, N]
    Bm: torch.Tensor,     # [B, S, N]
    Cm: torch.Tensor,     # [B, S, N]
    D: torch.Tensor,      # [Din]
    h0: Optional[torch.Tensor],   # [B, Din, N]
    dy: torch.Tensor,     # [B, S, Din] gradient of y
    dhT: Optional[torch.Tensor] = None,  # [B, Din, N] gradient of h_final
    *,
    chunk: int = 32,
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddelta, dA, dBm, dCm, dD, dh0) of ``mamba_scan_reference``, each
    in its input's dtype (dh0 fp32), by the reverse scan the backward kernel
    runs, in fp32.  With a_t = exp(delta_t A) and g_t the gradient of h_t:

        g_t   = C_t dy_t + a_{t+1} g_{t+1}     (g_{S-1} also takes dhT)
        dx_t  = delta_t sum_n g_t B_t + D dy_t
        ddelta_t = sum_n g_t (x_t B_t + A a_t h_{t-1})
        dA    = sum_{b,t} g_t delta_t a_t h_{t-1}
        dBm_t = sum_d g_t delta_t x_t,   dCm_t = sum_d dy_t h_t
        dD    = sum_{b,t} dy_t x_t,      dh0 = a_0 g_0

    h_{t-1} is recomputed forward from the state entering each chunk of
    `chunk` steps (the forward kernel's checkpoints); nothing divides by a
    decay, which underflows to 0 over long spans.
    """
    b_, s, din = x.shape
    ct = _acc(x)
    xf, dt, Af, Bf, Cf, gy = (t.to(ct) for t in (x, delta, A, Bm, Cm, dy))
    dtx = dt * xf

    def step(h, t):
        return torch.exp(dt[:, t, :, None] * Af) * h + dtx[:, t, :, None] * Bf[:, t, None, :]

    h = (torch.zeros((b_, din, A.shape[1]), dtype=ct, device=x.device) if h0 is None
         else h0.to(ct))
    ckpts = []
    for t in range(s):
        if t % chunk == 0:
            ckpts.append(h)
        h = step(h, t)
    ga = torch.zeros_like(h) if dhT is None else dhT.to(ct)   # a_{t+1} g_{t+1}
    gx = torch.empty((b_, s, din), dtype=ct, device=x.device)
    gd = torch.empty_like(gx)
    gB = torch.empty((b_, s, A.shape[1]), dtype=ct, device=x.device)
    gC = torch.empty_like(gB)
    gA = torch.zeros_like(Af)
    for c in reversed(range(len(ckpts))):
        t0 = c * chunk
        hs = [ckpts[c]]
        for t in range(t0, min(t0 + chunk, s)):
            hs.append(step(hs[-1], t))
        for t in reversed(range(t0, min(t0 + chunk, s))):
            a = torch.exp(dt[:, t, :, None] * Af)
            g = ga + gy[:, t, :, None] * Cf[:, t, None, :]
            ah = a * hs[t - t0]
            g_b = torch.einsum("bdn,bn->bd", g, Bf[:, t])
            gx[:, t] = dt[:, t] * g_b
            gd[:, t] = xf[:, t] * g_b + (g * ah * Af).sum(-1)
            gB[:, t] = torch.einsum("bdn,bd->bn", g, dtx[:, t])
            gC[:, t] = torch.einsum("bdn,bd->bn", hs[t - t0 + 1], gy[:, t])
            gA += (g * ah * dt[:, t, :, None]).sum(0)
            ga = a * g
    gx += gy * D.to(ct)
    gD = (gy * xf).sum((0, 1))
    return (gx.to(x.dtype), gd.to(delta.dtype), gA.to(A.dtype), gB.to(Bm.dtype),
            gC.to(Cm.dtype), gD.to(D.dtype), ga)


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
    sd = scan_dtype or _acc(x)
    states, hT = linear_scan_reference(a.to(sd), b.to(sd), h0)
    return states.to(x.dtype), hT.to(_acc(x))


def rglru_backward_reference(
    x: torch.Tensor,      # [B, S, D]
    r: torch.Tensor,      # [B, S, D]
    i: torch.Tensor,      # [B, S, D]
    log_a: torch.Tensor,  # [D]
    h0: Optional[torch.Tensor],   # [B, D]
    dy: torch.Tensor,     # [B, S, D] gradient of the states
    dhT: Optional[torch.Tensor] = None,  # [B, D] gradient of h_final
    *,
    c: float = 8.0,
) -> Tuple[torch.Tensor, ...]:
    """(dx, dr, di, dlog_a, dh0) of ``rglru_reference``, each in its input's
    dtype (dh0 fp32), by the reverse scan the backward kernel runs, in fp32.
    With l_t = c r_t log_a, a_t = exp(l_t), m_t = sqrt(max(1 - a_t^2, 1e-12))
    and u_t = i_t x_t (taken in x's dtype, as the forward takes it; its
    rounding passes the gradient straight through):

        g_t  = dy_t + a_{t+1} g_{t+1}          (g_{S-1} also takes dhT)
        dx_t = g_t m_t i_t,   di_t = g_t m_t x_t
        dl_t = g_t a_t h_{t-1} - g_t u_t a_t^2 / m_t where the clamp does not
               hold, and g_t a_t h_{t-1} where it does (JAX's derivative of
               the clamp, ``repro/kernels/ref.py:rglru_reference``, is 0 there)
        dr_t = c log_a dl_t,  dlog_a = sum_{b,t} c r_t dl_t,  dh0 = a_0 g_0

    h_{t-1} comes from the forward recurrence run again from h0: nothing
    divides by a decay.  g is the same recurrence run backwards."""
    ct = _acc(x)
    xf, rf, i_f, la, gy = (t.to(ct) for t in (x, r, i, log_a, dy))
    b_, s, d = x.shape
    log_at = c * rf * la
    a = torch.exp(log_at)
    a2 = torch.exp(2.0 * log_at)
    q = 1.0 - a2
    m = torch.sqrt(torch.clamp(q, min=1e-12))
    u = (i * x).to(ct)
    h_init = (torch.zeros((b_, d), dtype=ct, device=x.device) if h0 is None
              else h0.to(ct))
    states, _ = linear_scan_reference(a, m * u, h_init)
    h_prev = torch.cat([h_init[:, None], states[:, :-1]], dim=1)
    # g backwards: G_k = g_{S-1-k} = a_{S-k} G_{k-1} + dy_{S-1-k}, G_{-1} = dhT
    a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    g_rev, _ = linear_scan_reference(a_next.flip(1), gy.flip(1),
                                     None if dhT is None else dhT.to(ct))
    g = g_rev.flip(1)
    du = g * m
    dl = g * h_prev * a - torch.where(q > 1e-12, g * u * a2 / m, torch.zeros((), device=x.device))
    return ((du * i_f).to(x.dtype), (dl * (c * la)).to(r.dtype), (du * xf).to(i.dtype),
            (dl * c * rf).sum((0, 1)).to(log_a.dtype), a[:, 0] * g[:, 0])


# ============================================================ delta compression
def topk_compress_reference(
    x: torch.Tensor, k: int, block: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block magnitude top-k of a 1-D tensor: (vals [nb, k] fp32,
    idx [nb, k] int32, residual [n] in x's dtype).  The tail block is
    zero-padded; each block keeps its k largest |x| in descending order,
    ties to the lowest index (as ``lax.top_k`` and the Pallas kernel's
    argmax-and-clear do; a stable sort of -|x| gives that order, while
    ``torch.topk``'s order of ties is unspecified).  The residual is x with
    the kept entries set to +0."""
    n = x.shape[0]
    xb = torch.nn.functional.pad(x, (0, (-n) % block)).view(-1, block)
    idx = torch.sort(-xb.float().abs(), dim=1, stable=True).indices[:, :k]
    vals = torch.gather(xb.float(), 1, idx)
    residual = xb.scatter(1, idx, torch.zeros((), dtype=x.dtype, device=x.device)
                          .expand(idx.shape))
    return vals, idx.to(torch.int32), residual.reshape(-1)[:n]


def topk_decompress_reference(vals: torch.Tensor, idx: torch.Tensor, n: int,
                              block: int = 1024) -> torch.Tensor:
    """[n]: each block's `vals` at `idx`, zeros elsewhere."""
    out = torch.zeros((vals.shape[0], block), dtype=vals.dtype, device=vals.device)
    return out.scatter(1, idx.long(), vals).reshape(-1)[:n]


# =================================================================== checksums
FLETCHER_MOD = 65535
FLETCHER_BLOCK_WORDS = 1024  # a stream is zero-padded to a multiple of this


def _words(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Words lo..hi-1 of `x` as int64: little-endian 16-bit words of a
    uint8 tensor (an odd tail's high byte zero), or the values of an
    integer tensor of words < 2^16."""
    if x.dtype != torch.uint8:
        return x[lo:hi].to(torch.int64) & 0xFFFF
    b = x[2 * lo: 2 * hi].to(torch.int64)
    if b.numel() % 2:
        b = torch.nn.functional.pad(b, (0, 1))
    return b[0::2] | (b[1::2] << 8)


def fletcher32_reference(x: torch.Tensor, chunk_words: int = 1 << 22) -> torch.Tensor:
    """Fletcher-32 of a stream of 16-bit words zero-padded to a multiple of
    1024 words, as a 0-d int64 tensor ``(s2 << 16) | s1``: the value of
    ``fletcher32_padded`` (``statestore/blade.py``) and of the JAX
    package's ``fletcher32_padded_np``.

    `x` is a uint8 tensor of bytes or an integer tensor of words < 2^16 (the
    Pallas kernel's contract).  Closed form over the padded length N:
    ``s1 = sum(w_t)``, ``s2 = sum((N - t) w_t)``, mod 65535, summed in int64
    over chunks of `chunk_words` words (each term is below 2^32 once
    ``N - t`` is reduced).
    """
    x = x.reshape(-1)
    n = (x.numel() + 1) // 2 if x.dtype == torch.uint8 else x.numel()
    n_pad = -(-n // FLETCHER_BLOCK_WORDS) * FLETCHER_BLOCK_WORDS
    s1 = torch.zeros((), dtype=torch.int64, device=x.device)
    s2 = torch.zeros((), dtype=torch.int64, device=x.device)
    for lo in range(0, n, chunk_words):
        hi = min(lo + chunk_words, n)
        w = _words(x, lo, hi)
        t = torch.arange(lo, hi, dtype=torch.int64, device=x.device)
        s1 = (s1 + w.sum()) % FLETCHER_MOD
        s2 = (s2 + (((n_pad - t) % FLETCHER_MOD) * w).sum()) % FLETCHER_MOD
    return (s2 << 16) | s1


def fletcher32_wave_reference(chunks) -> torch.Tensor:
    """[len(chunks)] int64: `fletcher32_reference` of each chunk (uint8
    tensors, each its own zero-padded stream)."""
    if not chunks:
        return torch.empty(0, dtype=torch.int64)
    return torch.stack([fletcher32_reference(c) for c in chunks])
