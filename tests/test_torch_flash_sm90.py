"""The bf16 flash-attention kernels on wgmma (csrc/flash_attention_sm90.cu,
csrc/flash_attention_bwd_sm90.cu), checked where no card is needed.

The kernels run only on the card (tests/test_torch_cuda.py).  Here: which
kernel each (dtype, head_dim) goes to, that every CUDA source is built, and
that the kernels' rounding points fit the bf16 tolerance.  ``_wgmma_forward``
and ``_wgmma_backward`` repeat the kernels' arithmetic in plain PyTorch: fp32
logits of bf16 inputs, the forward's online softmax over the kernel's key
tiles with P rounded to bf16 before P V, the backward's P and dS rounded to
bf16 before their products, every sum in fp32.  Their outputs and gradients
are held against the JAX package's ``mha_reference`` and its ``jax.vjp``
within the bf16 tolerance of tests/test_kernels.py:19-20 (atol 2e-2, rtol
1e-2), at the card tests' shapes.  The gradients' oracle is the vjp taken in
float32 on the same bf16 values: taken in bf16, JAX rounds each query head's
dK and dV to bf16 and sums a KV group's heads in bf16 (the transpose of
``jnp.repeat`` after the cast), an error of its own that takes most of the
tolerance at these shapes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb

NEG_INF = -1e30
ATOL, RTOL = 2e-2, 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_route_of_every_config_head_dim(arch):
    """Every config's head dim (kimi-k2's 112 and stablelm-12b's 160
    included) goes to the wgmma kernels in bf16 and the CUDA-core ones in
    fp32, forward and backward; any other dtype raises."""
    cfg = get_config(arch)
    if not any(m in ("attn", "local_attn") for m, _ in cfg.layer_kinds()):
        assert cfg.head_dim == 0  # falcon-mamba-7b: no attention layer
        return
    d = cfg.hd
    for mod in (fa, fb):
        assert d in mod.HEAD_DIMS
        assert mod._route(torch.bfloat16, d) == "wgmma"
        assert mod._route(torch.float32, d) == "cuda_core"
        with pytest.raises(ValueError, match="dtype"):
            mod._route(torch.float16, d)
    for dtype in (torch.bfloat16, torch.float32):  # a head dim no config has
        with pytest.raises(ValueError, match="head_dim"):
            fa._route(dtype, 96)


def test_build_sources_cover_every_cuda_file():
    on_disk = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCES) == on_disk
    assert {"flash_attention_sm90", "flash_attention_bwd_sm90"} <= set(_build.SOURCES)


def test_plain_path_counts_no_route():
    q = torch.zeros(1, 2, 8, 32, dtype=torch.bfloat16)
    before = (dict(fa.launches_by_route), dict(fb.launches_by_route))
    o, lse = fa.flash_attention(q, q, q, return_lse=True)
    fb.flash_attention_backward(q, q, q, o, lse, q)
    assert (fa.launches_by_route, fb.launches_by_route) == before
    assert set(fa.launches_by_route) == set(fb.launches_by_route) == {"wgmma", "cuda_core"}


def _visible(sq, sk, causal, window, q_offset):
    qpos = torch.arange(sq)[:, None] + q_offset
    kpos = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _wgmma_forward(q, k, v, *, causal, window, q_offset):
    """(out bf16, lse fp32) by the forward kernel's rounding points."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    bn = 64 if d > 128 else 128  # the kernel's key tile
    scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    mask = _visible(sq, sk, causal, window, q_offset)
    m = torch.full((b, hq, sq), NEG_INF)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, sk, bn):
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf[:, :, k0:k0 + bn]) * scale
        s = torch.where(mask[:, k0:k0 + bn], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        p16 = p.bfloat16().float()  # P in bf16: wgmma's A operand from registers
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p16, vf[:, :, k0:k0 + bn])
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l[..., None]).bfloat16(), m + torch.log(l)


def _wgmma_backward(q, k, v, o, lse, do, *, causal, window, q_offset):
    """(dq, dk, dv) in bf16 by the backward kernels' rounding points."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = _visible(sq, sk, causal, window, q_offset)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros(()))
    delta = (dof * o.float()).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None])).bfloat16().float()  # dS in bf16
    p = p.bfloat16().float()                                # P in bf16
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof).view(b, hkv, g, sk, d).sum(dim=2)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf).view(b, hkv, g, sk, d).sum(dim=2) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _inputs(seed, *shapes):
    """bf16 values for both frameworks, from one numpy seed."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, dtype=jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).bfloat16() for a in arrs])


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


# the forward shapes of tests/test_torch_cuda.py: GQA, MQA with Sk > Sq, MHA
# off the tile, ragged, a group of 3, recurrentgemma-9b's D=256 MQA, and
# kimi-k2's head_dim 112 and stablelm-12b's 160 with Sk > Sq
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (2, 4, 2, 256, 256, 64),
    (1, 8, 1, 128, 384, 64),
    (2, 4, 4, 192, 192, 128),
    (1, 2, 2, 100, 333, 32),
    (1, 6, 2, 64, 64, 128),
    (1, 16, 1, 300, 300, 256),
    (2, 8, 1, 100, 133, 112),
    (1, 4, 1, 100, 133, 160),
])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 17)])
def test_forward_rounding_points_hold_against_jax(b, hq, hkv, sq, sk, d, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(sq * sk + d, (b, hq, sq, d), (b, hkv, sk, d),
                                      (b, hkv, sk, d))
    kw = dict(causal=causal, window=window, q_offset=sk - sq)
    out, _ = _wgmma_forward(q, k, v, **kw)
    _close(out, JR.mha_reference(jq, jk, jv, **kw))


# the backward shapes of tests/test_torch_cuda.py, recurrentgemma-9b's D=256
# MQA (16/1 heads), which the wgmma route splits between warpgroups, and the
# head dims 112 and 160 (160 split too), ragged with Sk > Sq
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (2, 4, 2, 130, 130, 64),
    (1, 8, 1, 50, 200, 128),
    (1, 6, 2, 100, 100, 128),
    (1, 2, 2, 70, 70, 32),
    (1, 16, 1, 90, 90, 256),
    (1, 8, 1, 70, 90, 112),
    (1, 4, 1, 70, 90, 160),
])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 17)])
def test_backward_rounding_points_hold_against_jax_vjp(b, hq, hkv, sq, sk, d, causal, window):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(sq * sk + d + 1, (b, hq, sq, d), (b, hkv, sk, d),
                                               (b, hkv, sk, d), (b, hq, sq, d))
    kw = dict(causal=causal, window=window, q_offset=sk - sq)
    o, lse = _wgmma_forward(q, k, v, **kw)
    got = _wgmma_backward(q, k, v, o, lse, do, **kw)
    _close(o, JR.mha_reference(jq, jk, jv, **kw))
    f32 = [x.astype(jnp.float32) for x in (jq, jk, jv, jdo)]
    _, vjp = jax.vjp(lambda a, b_, c: JR.mha_reference(a, b_, c, **kw), *f32[:3])
    for g, w in zip(got, vjp(f32[3])):
        _close(g, w)
