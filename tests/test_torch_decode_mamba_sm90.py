"""The bf16 decode-attention kernel on the tensor cores
(csrc/decode_attention_sm90.cu) and the lane-split Mamba scan
(csrc/mamba_scan.cu), checked where no card is needed.

The kernels run only on the card (tests/test_torch_cuda.py).  Here: which
decode kernel each (dtype, head_dim) goes to, and that each kernel's order of
operations fits its tolerance, in plain PyTorch emulations held against the
JAX package's oracles and its Pallas kernels in interpret mode, on the same
numpy inputs.

``_mma_decode`` repeats the decode kernel's arithmetic: fp32 logits of bf16
Q and K (each product exact in fp32), scaled by scale * log2 e, an online
softmax in exp2 over each warp's 16-key tiles of each split's even share of
the live keys, P rounded to bf16 before P V (l sums P unrounded), the warps
merged within a split and the splits merged after.  It is held to the bf16
tolerance of tests/test_kernels.py:19-20 (atol 2e-2, rtol 1e-2): the oracle
computes in fp32 from the same bf16 values, so what it checks is the
rounding of P and of the output, and the merges.  A row of length 0 gives
0, as the Pallas kernel does; the oracle's softmax over a fully masked row
averages the whole cache instead, so that row is held to the Pallas kernel.

``_lane_split_scan`` repeats the scan's order: exp2(delta * (A log2 e)) per
state, h = a h + (delta x) Bm, y_t's sum over states as a tree in each of
four lanes of N / 4 states (pairs of states, then the pairs), the lanes
added in pairs, (0 + 1) + (2 + 3), then x D.  It is held to the scan tolerances of tests/test_kernels.py:79-80 (fp32
atol 5e-4, rtol 1e-3; bf16 atol 2e-2, rtol 1e-2) over 1024 steps with decays
near 0 (a single step forgets the state) and near 1 (the state sums ~1024
inputs, so y is large and the order of the sums matters most).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import mamba_scan as ms

NEG_INF = -1e30
LOG2E = 1.4426950408889634
BF16 = dict(atol=2e-2, rtol=1e-2)
F32 = dict(atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_route_of_every_config_head_dim(arch):
    """Every config's head dim goes to the mma kernel in bf16 and the
    CUDA-core one in fp32; any other dtype, or a head dim no config has,
    raises."""
    cfg = get_config(arch)
    if not any(m in ("attn", "local_attn") for m, _ in cfg.layer_kinds()):
        assert cfg.head_dim == 0  # falcon-mamba-7b: no attention layer
        return
    d = cfg.hd
    assert d in da.HEAD_DIMS
    assert da._route(torch.bfloat16, d) == "mma"
    assert da._route(torch.float32, d) == "cuda_core"
    with pytest.raises(ValueError, match="dtype"):
        da._route(torch.float16, d)
    with pytest.raises(ValueError, match="head_dim"):
        da._route(torch.bfloat16, 96)


def test_plain_decode_counts_no_route():
    q = torch.zeros(2, 4, 64, dtype=torch.bfloat16)
    kv = torch.zeros(2, 2, 16, 64, dtype=torch.bfloat16)
    before = (da.launches, dict(da.launches_by_route), ms.launches)
    da.decode_attention(q, kv, kv, length=torch.tensor([3, 16], dtype=torch.int32))
    x = torch.zeros(1, 5, 8)
    ms.mamba_scan(x, x, torch.zeros(8, 16), torch.zeros(1, 5, 16), torch.zeros(1, 5, 16),
                  torch.zeros(8))
    assert (da.launches, da.launches_by_route, ms.launches) == before
    assert set(da.launches_by_route) == {"mma", "cuda_core"}


def _merge(parts):
    """(m, l, acc) of several partial softmaxes in the log2 domain, merged."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for pm, pl, pa in parts:
        f = torch.exp2(pm - m)
        l = l + pl * f
        acc = acc + pa * f[:, None]
    return m, l, acc


def _mma_decode(q, k, v, length, n_split):
    """[B, Hq, D] bf16 by the bf16 decode kernel's rounding points."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    tk = 32 if d > 128 else 64  # keys a stage; warps take 16 each
    c = LOG2E / math.sqrt(d)
    qf = q.float()
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    out = torch.zeros((b, hq, d))
    for bi in range(b):
        n = min(int(length[bi]), s)
        splits = []
        for sp in range(n_split):
            start, end = n * sp // n_split, n * (sp + 1) // n_split
            if start >= end:
                continue
            warps = []
            for w in range(tk // 16):
                m, l = torch.full((hq,), NEG_INF), torch.zeros(hq)
                acc = torch.zeros((hq, d))
                for k0 in range(start + 16 * w, end, tk):
                    k1 = min(k0 + 16, end)
                    sc = torch.einsum("hd,hkd->hk", qf[bi], kf[bi, :, k0:k1]) * c
                    m_new = torch.maximum(m, sc.amax(dim=-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(sc - m_new[:, None])
                    l = l * alpha + p.sum(dim=-1)
                    p16 = p.bfloat16().float()  # P in bf16: mma's A operand
                    acc = acc * alpha[:, None] + torch.einsum("hk,hkd->hd", p16,
                                                              vf[bi, :, k0:k1])
                    m = m_new
                warps.append((m, l, acc))
            splits.append(_merge(warps))
        if splits:
            _, l, acc = _merge(splits)
            out[bi] = acc / l[:, None]
    return out.bfloat16()


def _decode_inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d))]
    th = [torch.from_numpy(a).bfloat16() for a in arrs]
    # both oracles see the same bf16 values, widened to fp32
    return [jnp.asarray(t.float().numpy()) for t in th], th


# recurrentgemma-9b (G=16, D=256) and llama3.2-3b (G=3, D=128), with the
# n_split the card picks for them at B=4 (66 and 8) and others; lengths 0, 1,
# on a split's edge (a multiple of n_split) and off it; kimi-k2's head_dim 112
# (a group of 8) and stablelm-12b's 160
@pytest.mark.parametrize("b,hq,hkv,s,d,n_split,lengths", [
    (4, 16, 1, 700, 256, 66, (0, 1, 660, 700)),
    (2, 16, 1, 300, 256, 7, (299, 35)),
    (4, 24, 8, 1100, 128, 8, (1025, 1056, 0, 1)),
    (2, 6, 2, 400, 128, 5, (400, 131)),
    (2, 4, 4, 200, 64, 3, (64, 199)),
    (1, 2, 1, 100, 32, 2, (97,)),
    (2, 8, 1, 300, 112, 5, (0, 260)),
    (2, 4, 1, 300, 160, 4, (299, 1)),
])
def test_decode_rounding_points_hold_against_jax(b, hq, hkv, s, d, n_split, lengths):
    (jq, jk, jv), (q, k, v) = _decode_inputs(s + d + n_split, b, hq, hkv, s, d)
    length = torch.tensor(lengths, dtype=torch.int32)
    got = _mma_decode(q, k, v, length, n_split).float().numpy()
    jlen = jnp.asarray(np.array(lengths, np.int32))
    live = np.array(lengths) > 0
    want = np.asarray(JR.decode_attention_reference(jq, jk, jv, length=jlen), np.float32)
    np.testing.assert_allclose(got[live], want[live], **BF16)
    pallas = np.asarray(pallas_decode(jq, jk, jv, length=jlen, interpret=True, block_k=128),
                        np.float32)
    np.testing.assert_allclose(got, pallas, **BF16)
    assert not got[~live].any()  # length 0 gives 0, as the Pallas kernel


def _lane_split_scan(x, delta, A, Bm, Cm, D, h0=None):
    """(y in x's dtype, hT fp32) by the scan kernel's order of operations."""
    b, s, din = x.shape
    n = A.shape[1]
    xf, dt = x.float(), delta.float()
    a2 = A.float() * LOG2E
    bf, cf = Bm.float(), Cm.float()
    h = torch.zeros((b, din, n)) if h0 is None else h0.float().clone()
    ys = torch.empty((b, s, din))
    for t in range(s):
        h = torch.exp2(dt[:, t, :, None] * a2[None]) * h + \
            (dt[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        p = (h * cf[:, t, None, :]).view(b, din, 4, n // 4)
        while p.shape[-1] > 1:  # a lane's states, as a tree
            p = p[..., 0::2] + p[..., 1::2]
        lanes = p[..., 0]  # [b, din, 4]
        acc = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])
        ys[:, t] = acc + xf[:, t] * D.float()
    return ys.to(x.dtype), h


def _mamba_inputs(seed, b, s, din, n, decay):
    rng = np.random.default_rng(seed)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    scale = {"near 0": 50.0, "near 1": 1e-3, "mixed": 1.0}[decay]
    a = (-np.exp(r(din, n) * 0.5) * scale).astype(np.float32)
    return (r(b, s, din), np.logaddexp(r(b, s, din), 0.0).astype(np.float32), a,
            r(b, s, n), r(b, s, n), r(din), r(b, din, n))


@pytest.mark.parametrize("b,s,din,n,decay,with_h0", [
    (2, 1024, 128, 16, "near 0", False),
    (2, 1024, 128, 16, "near 1", True),
    (1, 77, 128, 8, "mixed", True),
    (2, 200, 256, 16, "mixed", False),
    (1, 1, 64, 8, "mixed", True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_order_holds_against_jax(b, s, din, n, decay, with_h0, dtype):
    arrs = list(_mamba_inputs(s + din + n, b, s, din, n, decay))
    if not with_h0:
        arrs[6] = None
    tdt = getattr(torch, dtype)
    # x, Bm and Cm in the working type; delta, A, D and h0 fp32; the oracles
    # see the same values, widened
    th = [None if a is None else torch.from_numpy(a).to(tdt if i in (0, 3, 4) else torch.float32)
          for i, a in enumerate(arrs)]
    jx = [None if t is None else jnp.asarray(t.float().numpy()) for t in th]
    y, hT = _lane_split_scan(*th)
    assert y.dtype == tdt and hT.dtype == torch.float32
    tol = BF16 if dtype == "bfloat16" else F32
    jy, jh = JR.mamba_scan_reference(*jx)
    py, ph = pallas_mamba(*jx, chunk=min(128, s), block_d=min(128, din), interpret=True)
    for want_y, want_h in ((jy, jh), (py, ph)):
        want_y = torch.from_numpy(np.array(want_y, np.float32)).to(tdt).float().numpy()
        np.testing.assert_allclose(y.float().numpy(), want_y, **tol)
        np.testing.assert_allclose(hT.numpy(), np.asarray(want_h, np.float32), **F32)
