"""The plans of the two recurrent scans redesigned for the H100, checked on the
CPU where the kernels themselves cannot run: a plain PyTorch model of each
kernel's decomposition, written here and not in the package, held to the
port's plain version (``ref.py``) and to the JAX package on the same numpy
inputs.

* The RG-LRU forward (``csrc/rglru_scan.cu``): a block's warps split the
  sequence into spans of W x 16 steps; each warp summarises its 16 steps
  from a zero carry (the product of its decays, and the h it reaches), the
  summaries fold in warp order into each warp's carry in, and each warp runs
  its steps from that carry, which is also its checkpoint.  Held to
  ``ref.rglru_reference`` and to the Pallas kernel in interpret mode.
* The Mamba reverse scan (``csrc/mamba_scan.cu``): summaries of every 64
  steps right of the first chunk from a zero carry (pass 1), then each
  chunk's true carry folded from the summaries to its right, last first, and
  the chunk walked back 16 steps at a time from the forward's checkpoints
  (pass 2); dBm and dCm summed over a warp's 8 channels (a tree of
  shuffles), then 8 warps, then blocks of 64 channels, dA and dD over (row,
  chunk), each in a fixed order.  Held to
  ``ref.mamba_scan_backward_reference`` and to ``jax.vjp`` of the JAX
  package's XLA reference.

Tolerance: the scans' fp32 tolerance of tests/test_kernels.py:79-80 (atol
5e-4, rtol 1e-3), for the gradients relative to each gradient's largest
entry, as tests/test_torch_scan_grads.py takes it.  The card tests of both
kernels are in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru_scan
from repro_torch.kernels import mamba_scan as tmamba
from repro_torch.kernels import ref as TR
from repro_torch.kernels import rglru_scan as trglru

ATOL, RTOL = 5e-4, 1e-3
F32 = torch.float32


def _close(got, want, relative=True):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() if relative else 1.0
    assert np.all(np.abs(got - want) <= ATOL * scale + RTOL * np.abs(want))


# ----------------------------------------------------------------- RG-LRU forward
def _rglru_terms(x, r, i, log_a, c):
    """a_t and b_t = sqrt(max(1 - a_t^2, 1e-12)) (i_t x_t), the gate product in
    x's type, by the kernel's arithmetic (decay_input)."""
    log_at = (c * r.to(F32)) * log_a.to(F32)
    a = torch.exp(log_at)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), min=1e-12))
    return a, mult * (i * x).to(F32)


def _span_rglru_forward(x, r, i, log_a, h0, *, c, warps, every=trglru.CHUNK):
    """y (fp32), hT and the checkpoints [B, ceil(S / every), D] as the
    forward kernel computes them, with `warps` warps a span."""
    B, S, D = x.shape
    a, b = _rglru_terms(x, r, i, log_a, c)
    carry = torch.zeros((B, D), dtype=F32) if h0 is None else h0.to(F32).clone()
    y = torch.empty((B, S, D), dtype=F32)
    ckpt = []
    for s0 in range(0, S, warps * every):
        groups = [(t0, min(S, t0 + every)) for t0 in range(s0, min(S, s0 + warps * every), every)]
        sums = []
        for t0, t1 in groups:  # step 1: each warp's summary from a zero carry
            P, H = torch.ones((B, D), dtype=F32), torch.zeros((B, D), dtype=F32)
            for t in range(t0, t1):
                H = a[:, t] * H + b[:, t]
                P = P * a[:, t]
            sums.append((P, H))
        h_in = []
        for P, H in sums:  # step 2: the summaries in warp order
            h_in.append(carry)
            carry = P * carry + H
        for (t0, t1), h in zip(groups, h_in):  # step 3: each warp from its carry in
            ckpt.append(h)
            for t in range(t0, t1):
                h = a[:, t] * h + b[:, t]
                y[:, t] = h
    return y, y[:, -1].clone(), torch.stack(ckpt, dim=1)


def _rglru_inputs(seed, B, S, D, decay, dtype=np.float32):
    """x, r, i, log_a, h0 as numpy: log_a as in tests/test_kernels.py, or
    near 0 (the decays vanish: a = exp(c r log_a) underflows towards 0), or
    near 1 (log_a -1e-9: the clamp of 1 - a^2 holds and the carry crosses
    every span)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sig = lambda z: (1.0 / (1.0 + np.exp(-z))).astype(np.float32)  # noqa: E731
    log_a = (-np.exp(n(D) * 0.3) * 0.1).astype(np.float32)
    if decay == "near0":
        log_a = log_a * 300.0
    elif decay == "near1":
        log_a[:] = -1e-9
    return n(B, S, D).astype(dtype), sig(n(B, S, D)).astype(dtype), \
        sig(n(B, S, D)).astype(dtype), log_a, n(B, D)


# the kernel's 8 warps a span, and 4 (the fold is the same for any count); S
# of one step, under a warp's 16 (15), one span of 4 warps (64), and ragged
# across many spans (100, 777)
@pytest.mark.parametrize("warps", [8, 4])
@pytest.mark.parametrize("S", [1, 15, 64, 100, 777])
@pytest.mark.parametrize("decay", ["mixed", "near0", "near1"])
@pytest.mark.parametrize("with_h0", [True, False])
def test_span_rglru_forward_matches_reference_and_pallas(warps, S, decay, with_h0):
    x, r, i, log_a, h0 = _rglru_inputs(S * 3 + warps, 2, S, 24, decay)
    t = [torch.from_numpy(v) for v in (x, r, i, log_a, h0)]
    h0_t = t[4] if with_h0 else None
    y, hT, ckpt = _span_rglru_forward(*t[:4], h0_t, c=8.0, warps=warps)
    assert ckpt.shape == (2, -(-S // trglru.CHUNK), 24)

    want_y, want_h = TR.rglru_reference(*t[:4], h0_t, c=8.0)
    _close(y, want_y, relative=False)
    _close(hT, want_h, relative=False)
    jy, jh = pallas_rglru_scan(*(jnp.asarray(v) for v in (x, r, i, log_a)),
                               jnp.asarray(h0) if with_h0 else None, c=8.0,
                               chunk=min(64, S), block_d=24, interpret=True)
    _close(y, jy, relative=False)
    _close(hT, jh, relative=False)

    # each group of 16 steps run again from its checkpoint, one step at a
    # time (what the reverse scan does), gives y's own bits
    a, b = _rglru_terms(*t[:4], 8.0)
    for g in range(ckpt.shape[1]):
        h = ckpt[:, g]
        for s in range(g * trglru.CHUNK, min(S, (g + 1) * trglru.CHUNK)):
            h = a[:, s] * h + b[:, s]
            assert torch.equal(h, y[:, s])


@pytest.mark.parametrize("warps", [4, 8])
def test_span_rglru_forward_bf16_matches_reference(warps):
    """bf16 inputs: the gate product rounded to bf16 as the kernel and the
    plain version take it; y within the scans' bf16 tolerance."""
    x, r, i, log_a, h0 = _rglru_inputs(5, 2, 300, 24, "mixed")
    t = [torch.from_numpy(v) for v in (x, r, i)]
    t = [v.to(torch.bfloat16) for v in t] + [torch.from_numpy(log_a), torch.from_numpy(h0)]
    y, hT, _ = _span_rglru_forward(*t, c=8.0, warps=warps)
    want_y, want_h = TR.rglru_reference(*t, c=8.0)
    torch.testing.assert_close(y.to(torch.bfloat16).float(), want_y.float(), atol=2e-2,
                               rtol=1e-2)
    torch.testing.assert_close(hT, want_h, atol=2e-2, rtol=1e-2)


# ----------------------------------------------------------- Mamba reverse scan
def _ordered_sum(v, dim):
    """v summed along `dim` one entry at a time, first to last."""
    parts = v.unbind(dim)
    out = parts[0].clone()
    for p in parts[1:]:
        out = out + p
    return out


def _channel_sum(v, channels=tmamba.CHANNELS, warp_channels=8):
    """[B, S, Din, N] summed over Din as the kernel sums dBm and dCm: the 8
    channels of a warp by its reduce-scatter of shuffles (channels c and c + 4,
    then c and c + 2, then c and c + 1), then a block's warps in order, then
    the blocks of `channels` in order (sum_rows); channels past Din are
    zeros."""
    B, S, Din, N = v.shape
    pad = -Din % channels
    v = torch.cat([v, v.new_zeros((B, S, pad, N))], dim=2)
    w = v.reshape(B, S, -1, channels // warp_channels, warp_channels, N)
    w = w[..., :4, :] + w[..., 4:, :]
    w = w[..., :2, :] + w[..., 2:, :]
    w = w[..., 0, :] + w[..., 1, :]
    return _ordered_sum(_ordered_sum(w, 3), 2)


def _chunked_mamba_backward(x, delta, A, Bm, Cm, D, h0, dy, dhT, *, chunk,
                            fine=tmamba.SUMMARY_CHUNK, every=tmamba.CHUNK):
    """(dx, ddelta, dA, dBm, dCm, dD, dh0) as the two passes of the kernel
    compute them, in fp32, with chunks of `chunk` steps in the second pass
    and summaries of every `fine` steps in the first."""
    B, S, Din = x.shape
    N = A.shape[1]
    xf, dt, Af, Bf, Cf, gy = (t.to(F32) for t in (x, delta, A, Bm, Cm, dy))
    dtx = dt * xf
    a_all = torch.exp(dt[..., None] * Af)  # [B, S, Din, N]

    h = torch.zeros((B, Din, N), dtype=F32) if h0 is None else h0.to(F32).clone()
    ckpt = []  # the forward's checkpoints every `every` steps
    for t in range(S):
        if t % every == 0:
            ckpt.append(h)
        h = a_all[:, t] * h + dtx[:, t, :, None] * Bf[:, t, None, :]

    n_fine, first = -(-S // fine), chunk // fine
    summary = {}  # pass 1: the chunks right of the first, from a zero carry
    for f in range(first, n_fine):
        ga, prod = torch.zeros((B, Din, N), dtype=F32), torch.ones((B, Din, N), dtype=F32)
        for t in reversed(range(f * fine, min(S, (f + 1) * fine))):
            ga = a_all[:, t] * (Cf[:, t, None, :] * gy[:, t, :, None] + ga)
            prod = prod * a_all[:, t]
        summary[f] = (ga, prod)

    gx, gd = torch.empty((B, S, Din), dtype=F32), torch.empty((B, S, Din), dtype=F32)
    vB, vC = torch.empty((B, S, Din, N), dtype=F32), torch.empty((B, S, Din, N), dtype=F32)
    part_a, part_d, dh0 = [], [], None
    for k in range(-(-S // chunk)):  # pass 2
        ga = torch.zeros((B, Din, N), dtype=F32) if dhT is None else dhT.to(F32).clone()
        for f in range(n_fine - 1, (k + 1) * chunk // fine - 1, -1):
            ga = summary[f][1] * ga + summary[f][0]
        da, dd = torch.zeros((B, Din, N), dtype=F32), torch.zeros((B, Din), dtype=F32)
        t_begin, t_end = k * chunk, min(S, (k + 1) * chunk)
        for q in reversed(range(t_begin // every, -(-t_end // every))):
            t0, t1 = q * every, min(S, (q + 1) * every)
            hs = [ckpt[q]]
            for t in range(t0, t1):
                hs.append(a_all[:, t] * hs[-1] + dtx[:, t, :, None] * Bf[:, t, None, :])
            for t in reversed(range(t0, t1)):
                g = Cf[:, t, None, :] * gy[:, t, :, None] + ga
                p = g * (a_all[:, t] * hs[t - t0])
                sx = (g * Bf[:, t, None, :]).sum(-1)
                gx[:, t] = dt[:, t] * sx + D.to(F32) * gy[:, t]
                gd[:, t] = xf[:, t] * sx + (p * Af).sum(-1)
                da = da + p * dt[:, t, :, None]
                vB[:, t] = g * dtx[:, t, :, None]
                vC[:, t] = gy[:, t, :, None] * hs[t - t0 + 1]
                dd = dd + gy[:, t] * xf[:, t]
                ga = a_all[:, t] * g
        part_a.append(da)
        part_d.append(dd)
        if k == 0:
            dh0 = ga
    # dA and dD over (row, chunk), rows first, in order
    dA = _ordered_sum(torch.stack([p[b] for b in range(B) for p in part_a]), 0)
    dD = _ordered_sum(torch.stack([p[b] for b in range(B) for p in part_d]), 0)
    return gx, gd, dA, _channel_sum(vB), _channel_sum(vC), dD, dh0


def _mamba_inputs(seed, B, S, Din, N, decay):
    """x, delta, A, Bm, Cm, D, h0, dy, dhT as numpy float32: A as in
    tests/test_kernels.py, or near 0 decays (A -30: exp(delta A) underflows
    to 0 within a few steps) or near 1 (A -1e-3: the gradient crosses every
    chunk, so the folded carries matter)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    delta = np.log1p(np.exp(n(B, S, Din))).astype(np.float32)
    A = (-np.exp(n(Din, N) * 0.5)).astype(np.float32)
    if decay == "near0":
        A = (A * 30.0).astype(np.float32)
    elif decay == "near1":
        A = (A * 1e-3).astype(np.float32)
    return (n(B, S, Din), delta, A, n(B, S, N), n(B, S, N), n(Din), n(B, Din, N),
            n(B, S, Din), n(B, Din, N))


# chunks of one summary (64) and of two (128, so pass 1 covers summaries a
# chunk folds that start inside the next); S of one step, under a group
# (15), one summary (64) and ragged across several chunks (333); Din 72: a
# whole block of 64 channels and a ragged one
@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("S", [1, 15, 64, 333])
@pytest.mark.parametrize("decay", ["mixed", "near0", "near1"])
@pytest.mark.parametrize("with_h0", [True, False])
def test_chunked_mamba_backward_matches_reference_and_jax_vjp(chunk, S, decay, with_h0):
    x, delta, A, Bm, Cm, D, h0, dy, dhT = _mamba_inputs(S * 5 + chunk, 2, S, 72, 8, decay)
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, delta=delta, A=A, Bm=Bm, Cm=Cm, D=D, h0=h0, dy=dy, dhT=dhT).items()}
    h0_t, dhT_t = (t["h0"], t["dhT"]) if with_h0 else (None, None)
    args = (t["x"], t["delta"], t["A"], t["Bm"], t["Cm"], t["D"], h0_t)
    got = _chunked_mamba_backward(*args, t["dy"], dhT_t, chunk=chunk)
    want_ref = TR.mamba_scan_backward_reference(*args, t["dy"], dhT_t, chunk=tmamba.CHUNK)
    jh0 = jnp.asarray(h0) if with_h0 else jnp.zeros((2, 72, 8), jnp.float32)
    _, vjp = jax.vjp(lambda *a: JR.mamba_scan_reference(*a),
                     *(jnp.asarray(v) for v in (x, delta, A, Bm, Cm, D)), jh0)
    want_jax = vjp((jnp.asarray(dy), jnp.asarray(dhT) if with_h0 else jnp.zeros_like(jh0)))
    for want in (want_ref, want_jax):
        assert len(want) == len(got)
        for name, g, w in zip(("dx", "ddelta", "dA", "dBm", "dCm", "dD", "dh0"), got, want):
            if name == "dh0" and not with_h0:
                continue  # without h0 the reference's dh0 is the zero carry's, unused
            _close(g, w)


# (B, S, Din, SMs, the chunk the planner gives)
@pytest.mark.parametrize("b,s,din,sms,want", [
    (1, 1024, 8192, 132, 512),   # falcon-mamba-7b's training: 2 chunks, 256 blocks
    (4, 1024, 8192, 132, 1024),  # its serve batch: 512 blocks already, one chunk
    (2, 1024, 8192, 132, 1024),  # 256 blocks: one chunk
    (1, 1000, 8192, 132, 512),   # a ragged S: 16 summaries in 2 chunks
    (1, 1024, 128, 132, 64),     # 2 blocks: a chunk a summary
    (1, 1024, 8192, 114, 1024),  # a card of 114 SMs: 128 blocks are enough there
    (3, 1, 100, 132, 64),        # one step
])
def test_mamba_backward_chunk_planner(b, s, din, sms, want):
    chunk = tmamba.bwd_chunk(b, s, din, sms)
    assert chunk == want and chunk % tmamba.SUMMARY_CHUNK == 0
    blocks = b * -(-din // tmamba.CHANNELS)
    n_chunks = -(-s // chunk)
    # never more blocks than the card holds at once, unless one chunk already is
    assert n_chunks == 1 or blocks * n_chunks <= tmamba.BWD_BLOCKS_PER_SM * sms
    n_sum = -(-s // tmamba.SUMMARY_CHUNK)
    assert tmamba.bwd_scratch_numel(b, s, din, 16, chunk) == (
        -(-din // 64) * 2 * b * s * 16 + b * n_chunks * din * 17 + 2 * b * n_sum * din * 16)
