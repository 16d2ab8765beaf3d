"""The plans of the two training kernels redesigned for the H100, checked on
the CPU where the kernels themselves cannot run:

* the flash attention backward's head-split planner
  (``flash_attention_bwd.head_splits``): how many blocks share a KV group's
  query heads in the wgmma route's dK/dV kernel, and the scratch their fp32
  partials take;
* the RG-LRU reverse scan's chunked decomposition: a plain PyTorch model of
  the kernel's two passes (chunk summaries from a zero carry, then each
  chunk's true carry folded from the summaries to its right and the chunk
  walked again from the forward's checkpoints), written here and not in the
  package, held to ``ref.rglru_backward_reference`` and to ``jax.vjp`` of the
  JAX package's XLA reference on the same numpy inputs.

Tolerance of the RG-LRU gradients: each within 5e-4 of its largest entry
plus 1e-3 of itself (the scans' fp32 tolerance of tests/test_kernels.py:79-80,
relative to each gradient's scale, as tests/test_torch_scan_grads.py takes
it).  The card tests of both kernels are in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import ref as TR
from repro_torch.kernels import rglru_scan as trglru

ATOL, RTOL = 5e-4, 1e-3


# (B, Hq, Hkv, Sk, D, SMs, the HS the rule gives)
@pytest.mark.parametrize("b,hq,hkv,sk,d,sms,want", [
    (2, 16, 1, 1024, 256, 132, 8),   # recurrentgemma-9b's training: 32 blocks, 4 would give 128
    (4, 16, 1, 3072, 256, 132, 1),   # its S=3072: 192 blocks already
    (4, 24, 8, 1024, 128, 132, 1),   # llama3.2-3b's training: 256 blocks
    (2, 32, 8, 1024, 160, 132, 1),   # stablelm-12b's: 64-key blocks, 256
    (2, 64, 8, 256, 112, 132, 8),    # kimi-k2's train parity: 32 blocks, a group of 8
    (1, 16, 1, 300, 256, 132, 16),   # 5 blocks: no divisor reaches, so all of G
    (1, 6, 2, 100, 128, 132, 3),     # a group of 3: 2 blocks
    (2, 16, 1, 1024, 256, 114, 4),   # a card of 114 SMs: 128 blocks are enough there
    (2, 8, 8, 1280, 64, 132, 1),     # MHA: a group of one head is never split
])
def test_head_split_planner(b, hq, hkv, sk, d, sms, want):
    hs = fb.head_splits(b, hq, hkv, sk, d, sms)
    g = hq // hkv
    assert hs == want and g % hs == 0
    blocks = b * hkv * -(-sk // fb.dkdv_keys(d))
    assert fb.dkdv_keys(d) == (64 if d > 128 else 128)
    if blocks >= sms:
        assert hs == 1
    elif blocks * g >= sms:  # the grid reaches the SM count with the smallest such divisor
        assert blocks * hs >= sms
        assert all(blocks * h < sms for h in range(1, hs) if g % h == 0)
    else:
        assert hs == g
    # the partials: fp32 dK and dV of every split, none where HS = 1
    n = fb.partials_numel(hs, b, hkv, sk, d)
    assert n == (2 * hs * b * hkv * sk * d if hs > 1 else 0)


def _chunked_rglru_backward(x, r, i, log_a, h0, dy, dhT, *, c, chunk, every=trglru.CHUNK):
    """The reverse scan as the two passes of csrc/rglru_scan.cu compute it, in
    fp32 (one channel a lane of a [B, D] tensor): the forward's checkpoints
    every `every` steps, pass 1's summaries of each `chunk` steps, pass 2's
    carries folded right to left and its walk back group by group from the
    checkpoints, the dlog_a partials summed over (row, chunk) in order."""
    B, S, D = x.shape
    f = torch.float32
    xf, rf, i_f, gy = (t.to(f) for t in (x, r, i, dy))
    la = log_a.to(f)
    u = (i * x).to(f)  # the gate product in x's type, widened

    # a_t, a_t^2 and the forward's multiplier, by its arithmetic, for every step
    log_at = (c * rf) * la
    a_all, a2_all = torch.exp(log_at), torch.exp(2.0 * log_at)
    m_all = torch.sqrt(torch.clamp(1.0 - a2_all, min=1e-12))

    def step(t):
        return a_all[:, t], a2_all[:, t], m_all[:, t]

    h = torch.zeros((B, D), dtype=f) if h0 is None else h0.to(f).clone()
    ckpt = []
    for t in range(S):
        if t % every == 0:
            ckpt.append(h)
        a, _, m = step(t)
        h = a * h + m * u[:, t]

    n_chunks = -(-S // chunk)
    bounds = [(k * chunk, min(S, (k + 1) * chunk)) for k in range(n_chunks)]
    summary = []  # pass 1: (a g at the chunk's first step from a zero carry, prod of a_t)
    for t_begin, t_end in bounds:
        ga, prod = torch.zeros((B, D), dtype=f), torch.ones((B, D), dtype=f)
        for t in reversed(range(t_begin, t_end)):
            a = step(t)[0]
            ga = a * (gy[:, t] + ga)
            prod = prod * a
        summary.append((ga, prod))

    dx, dr, di = (torch.empty((B, S, D), dtype=f) for _ in range(3))
    parts, dh0 = [], None
    for k, (t_begin, t_end) in enumerate(bounds):  # pass 2
        ga = torch.zeros((B, D), dtype=f) if dhT is None else dhT.to(f).clone()
        for j in range(n_chunks - 1, k, -1):
            ga = summary[j][1] * ga + summary[j][0]
        dla = torch.zeros((B, D), dtype=f)
        for t0 in range((t_end - 1) // every * every, t_begin - 1, -every):
            hs, h = {}, ckpt[t0 // every]
            for t in range(t0, min(t0 + every, t_end)):
                a, _, m = step(t)
                hs[t - 1], h = h, a * h + m * u[:, t]
            for t in reversed(range(t0, min(t0 + every, t_end))):
                a, a2, m = step(t)
                q = 1.0 - a2
                g = gy[:, t] + ga
                du = g * m
                dl = g * hs[t - 1] * a - torch.where(q > 1e-12, g * u[:, t] * a2 / m,
                                                     torch.zeros(()))
                dx[:, t], di[:, t], dr[:, t] = du * i_f[:, t], du * xf[:, t], dl * c * la
                dla = dla + dl * c * rf[:, t]
                ga = a * g
        parts.append(dla)
        if k == 0:
            dh0 = ga
    dlog_a = torch.zeros(D, dtype=f)
    for b in range(B):  # sum_rows_kernel's order: rows b, then chunks
        for p in parts:
            dlog_a = dlog_a + p[b]
    return dx, dr, di, dlog_a, dh0


def _rglru_inputs(seed, B, S, D, decay):
    """x, r, i, log_a, h0, dy, dhT as numpy float32: log_a as in
    tests/test_kernels.py with every third channel at -1e-9 ("mixed": the
    clamp of 1 - a^2 holds there), or near -1e-3 ("slow": the gradient
    crosses many chunks, so the folded carries matter)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sig = lambda z: (1.0 / (1.0 + np.exp(-z))).astype(np.float32)  # noqa: E731
    log_a = (-np.exp(n(D) * 0.3) * 0.1).astype(np.float32)
    if decay == "slow":
        log_a = log_a * 1e-2
    else:
        log_a[::3] = -1e-9
    return (n(B, S, D), sig(n(B, S, D)), sig(n(B, S, D)), log_a, n(B, D), n(B, S, D), n(B, D))


def _close(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.all(np.abs(got - want) <= ATOL * scale + RTOL * np.abs(want))


# chunks of one checkpoint group (16) and of the kernel's 64; S of one step,
# under a group (15), one 64-step chunk, and ragged across many (777)
@pytest.mark.parametrize("chunk", [16, trglru.BWD_CHUNK])
@pytest.mark.parametrize("S", [1, 15, 64, 777])
@pytest.mark.parametrize("decay", ["mixed", "slow"])
def test_chunked_rglru_backward_matches_reference_and_jax_vjp(chunk, S, decay):
    x, r, i, log_a, h0, dy, dhT = _rglru_inputs(S * 7 + chunk, 2, S, 12, decay)
    t = [torch.from_numpy(a) for a in (x, r, i, log_a, h0, dy, dhT)]
    got = _chunked_rglru_backward(*t, c=8.0, chunk=chunk)
    want_ref = TR.rglru_backward_reference(*t, c=8.0)
    _, vjp = jax.vjp(lambda *a: JR.rglru_reference(*a, c=8.0),
                     *(jnp.asarray(a) for a in (x, r, i, log_a, h0)))
    want_jax = vjp((jnp.asarray(dy), jnp.asarray(dhT)))
    for want in (want_ref, want_jax):
        assert len(want) == len(got)
        for g, w in zip(got, want):
            _close(g, w)
