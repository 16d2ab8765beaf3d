"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips, from inside a fixture, where
no CUDA device is available.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels.py:19-20 (attention, forward
and backward) and :79-80,93-94 (the scans in fp32; in bf16 they take the
attention's).  The attention wrappers route by dtype: bf16 to the wgmma
kernels, fp32 to the CUDA-core ones; ROUTE says which, and the tests hold
each launch to it through ``launches_by_route``.  Top-k and the checksums
are exact, and so are two runs of the attention backward and a replayed
train step.  This file imports no JAX: the machine with the card has none.
"""

import dataclasses
import hashlib
import os

import numpy as np

import pytest
import torch

import _topk_cases as topk_cases

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import log_checksum as lc
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import topk_compress as tk
from repro_torch.models import DecoderLM, init_params, moe
from repro_torch.statestore import AsymStore, CheckpointManager, FileBlade, fletcher32_padded
from repro_torch.training import (OptConfig, TrainConfig, Trainer, TrainerConfig,
                                  init_train_state, make_train_step)
from repro_torch.training.trainer import deterministic_cuda
from repro_torch.tree import flatten_named, tree_map_named

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ROUTE = {torch.float32: "cuda_core", torch.bfloat16: "wgmma"}
SCAN_TOL = {torch.float32: dict(atol=5e-4, rtol=1e-3), torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # cuBLAS reads this when it starts, which is inside the first test that
    # gets here; the deterministic train steps need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (2, 4, 2, 256, 256, 64),      # GQA
    (1, 8, 1, 128, 384, 64),      # MQA, Sk > Sq
    (2, 4, 4, 192, 192, 128),     # MHA, not a multiple of the tile
    (1, 2, 2, 100, 333, 32),      # ragged both ways
    (1, 6, 2, 64, 64, 128),       # group of 3
    (1, 16, 1, 300, 300, 256),    # recurrentgemma-9b: MQA, head_dim 256
    (1, 16, 1, 77, 200, 128),     # group of 16, ragged, Sk > Sq
    (2, 8, 1, 200, 333, 112),     # kimi-k2's head_dim 112: a group of 8, ragged, Sk > Sq
    (1, 4, 2, 300, 300, 112),     # head_dim 112, GQA, off the tile
    (2, 4, 1, 200, 333, 160),     # stablelm-12b's head_dim 160: MQA, ragged, Sk > Sq
    (1, 8, 2, 130, 130, 160),     # head_dim 160, a group of 4, off the tile
    # the edges of the bf16 forward's persistent walk and overlapped schedule
    (1, 8, 1, 100, 100, 112),     # one key tile (128 keys at D=112)
    (1, 4, 1, 60, 60, 160),       # one key tile (64 keys at D=160)
    (1, 3, 1, 300, 300, 112),     # a group of 3: unpaired heads, 128 rows a tile
    (2, 6, 2, 257, 257, 160),     # a group of 3, ragged
    (1, 4, 2, 256, 256, 112),     # 8 work tiles: fewer than the SMs
    (1, 2, 1, 128, 160, 160),     # 2 work tiles, Sk > Sq
    (4, 64, 8, 256, 256, 112),    # kimi-k2's prompt: 512 work tiles, ~4 a block
    (4, 32, 8, 512, 512, 160),    # 512 work tiles at D=160
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 128), (True, 17)])
def test_flash_kernel_matches_plain(cuda, b, hq, hkv, sq, sk, d, dtype, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(sq * sk + d)
    q = _randn(gen, (b, hq, sq, d), dtype)
    k = _randn(gen, (b, hkv, sk, d), dtype)
    v = _randn(gen, (b, hkv, sk, d), dtype)
    kw = dict(causal=causal, window=window, q_offset=sk - sq)
    n, by_route = fa.launches, fa.launches_by_route[ROUTE[dtype]]
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == n + 1 and out.dtype == dtype
    assert fa.launches_by_route[ROUTE[dtype]] == by_route + 1
    want = ref.mha_reference(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=1e-2)
    # the row log-sum-exp too, and a second call bit for bit
    again, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    _, want_lse = ref.flash_attention_reference(q, k, v, return_lse=True, **kw)
    assert torch.equal(again, out)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,hq,hkv,s,d,lengths", [
    (2, 4, 2, 1024, 64, (512, 1000)),
    (1, 8, 8, 300, 128, (300,)),
    (4, 24, 8, 2048, 128, (1025, 1056, 1, 2048)),
    (2, 16, 1, 700, 32, (257, 700)),
    (2, 16, 1, 2048, 256, (2048, 1000)),  # recurrentgemma-9b: MQA, head_dim 256
    (4, 24, 8, 32768, 128, (1025, 1056, 1040, 1031)),  # llama3.2-3b's cache, ~1056 live
    (4, 16, 1, 2048, 256, (0, 1, 2048, 33)),  # a row with no key, and one with one
    (4, 24, 8, 4096, 128, "edges"),
    (4, 16, 1, 2048, 256, "edges"),
    (2, 40, 2, 300, 64, (300, 77)),  # a group of 20 query heads: two row groups
    (4, 64, 8, 2048, 112, (260, 0, 1, 2048)),  # kimi-k2: head_dim 112, a group of 8
    (4, 32, 8, 2048, 160, (1040, 0, 1, 2048)),  # stablelm-12b: head_dim 160, a group of 4
    (4, 64, 8, 4096, 112, "edges"),
    (4, 32, 8, 4096, 160, "edges"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, b, hq, hkv, s, d, lengths, dtype):
    if lengths == "edges":  # on and off the edges of the bf16 kernel's splits
        ns = da.n_split(b, hq, hkv, d, cuda)
        lengths = (ns * 16, ns * 16 + 1, ns * 31 - 1, ns)
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = _randn(gen, (b, hq, d), dtype)
    k = _randn(gen, (b, hkv, s, d), dtype)
    v = _randn(gen, (b, hkv, s, d), dtype)
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    route = "mma" if dtype == torch.bfloat16 else "cuda_core"
    n, by_route = da.launches, da.launches_by_route[route]
    out = da.decode_attention(q, k, v, length=length)
    assert da.launches == n + 1 and out.dtype == dtype
    assert da.launches_by_route[route] == by_route + 1
    want = ref.decode_attention_reference(q, k, v, length=length)
    # a row with no visible key gives 0, as the Pallas kernel; the plain
    # version's softmax over a fully masked row averages the cache instead
    live = length > 0
    assert not out[~live].any()
    torch.testing.assert_close(out[live].float(), want[live].float(), atol=TOL[dtype], rtol=1e-2)


@pytest.mark.parametrize("b,hq,hkv,s,d,lengths", [
    (4, 24, 8, 2048, 128, (2048, 1500, 1, 0)),
    (4, 16, 1, 2048, 256, (0, 1, 2048, 33)),
    (4, 64, 8, 4096, 112, (260, 0, 1, 4096)),
    (4, 32, 8, 4096, 160, "edges"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_log_sum_exp_matches_plain(cuda, b, hq, hkv, s, d, lengths, dtype):
    """With return_lse the kernel's output is unchanged and its row
    log-sum-exp (folded from its splits' maxima and sums) is the plain
    version's within 1e-3; a row with no visible key gives -inf."""
    if lengths == "edges":
        ns = da.n_split(b, hq, hkv, d, cuda)
        lengths = (ns * 16, ns * 16 + 1, ns * 31 - 1, ns)
    gen = torch.Generator(device=cuda).manual_seed(s + d + 1)
    q = _randn(gen, (b, hq, d), dtype)
    k = _randn(gen, (b, hkv, s, d), dtype)
    v = _randn(gen, (b, hkv, s, d), dtype)
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    out, lse = da.decode_attention(q, k, v, length=length, return_lse=True)
    assert torch.equal(out, da.decode_attention(q, k, v, length=length))
    _, want = ref.decode_attention_reference(q, k, v, length=length, return_lse=True)
    live = length > 0
    assert lse.dtype == torch.float32 and lse.shape == (b, hq)
    assert torch.isinf(lse[~live]).all() and (lse[~live] < 0).all()
    torch.testing.assert_close(lse[live], want[live], atol=1e-3, rtol=0)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 8, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, device=cuda)
    kv = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, kv, kv, length=torch.ones(1, dtype=torch.int64, device=cuda))
    x = torch.zeros(1, 8, 32, device=cuda)
    a = torch.zeros(32, 12, device=cuda)
    bc = torch.zeros(1, 8, 12, device=cuda)
    d = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError, match="N in"):
        ms.mamba_scan(x, x, a, bc, bc, d)
    a, bc = a[:, :8].contiguous(), bc[..., :8].contiguous()
    with pytest.raises(ValueError, match="delta"):
        ms.mamba_scan(x.bfloat16(), x.bfloat16(), a, bc.bfloat16(), bc.bfloat16(), d)
    with pytest.raises(ValueError, match="contiguous"):
        rs.rglru_scan(x, x.transpose(1, 2).contiguous().transpose(1, 2), x, d)
    with pytest.raises(ValueError, match="log_a"):
        rs.rglru_scan(x, x, x, d.bfloat16())
    # a CUDA backward starts from the forward's checkpoints, or raises
    with pytest.raises(ValueError, match="checkpoints"):
        ms.mamba_scan_backward(x, x, a, bc, bc, d, None, x)
    with pytest.raises(ValueError, match="checkpoints"):
        rs.rglru_scan_backward(x, x, x, d, None, x)
    with pytest.raises(ValueError, match="ckpt"):
        rs.rglru_scan_backward(x, x, x, d, None, x, ckpt=torch.zeros(1, 8, 32, device=cuda))


@pytest.mark.parametrize("layout", ["channels", "summary", "chunk"])
def test_mamba_backward_refuses_scratch_sized_for_another_block(cuda, monkeypatch, layout):
    """The scratch (the dBm/dCm partials of every block of ``CHANNELS``, the
    dA/dD partials of every chunk, the summaries of every ``SUMMARY_CHUNK``
    steps) is sized by the wrapper; scratch sized for another layout, or a
    chunk that is not a whole number of summaries, is refused before
    anything launches."""
    x = torch.zeros(1, 200, 128, device=cuda)
    a, bc, d = (torch.zeros(*s, device=cuda) for s in ((128, 8), (1, 200, 8), (128,)))
    ckpt = ms.mamba_scan(x, x, a, bc, bc, d, checkpoints=True)[2]
    ms.mamba_scan_backward(x, x, a, bc, bc, d, None, x, None, ckpt)  # the library is loaded
    k = ms.bwd_launches
    if layout == "channels":
        monkeypatch.setattr(ms, "CHANNELS", ms.CHANNELS // 2)
    elif layout == "summary":
        monkeypatch.setattr(ms, "SUMMARY_CHUNK", ms.SUMMARY_CHUNK * 2)
    else:
        monkeypatch.setattr(ms, "bwd_chunk", lambda *shape: ms.SUMMARY_CHUNK + ms.CHUNK)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        ms.mamba_scan_backward(x, x, a, bc, bc, d, None, x, None, ckpt)
    assert ms.bwd_launches == k


# S off a warp's 16 steps and a span of 128 (777, 1000, 5, 100, 1, 64); D off
# the 32-channel block (70, 33); B=1; recurrentgemma-9b's training shape (2 x
# 1024) and prefill (4 x 3072)
@pytest.mark.parametrize("b,s,d", [(2, 777, 512), (1, 64, 128), (4, 1000, 4096), (3, 5, 70),
                                   (1, 100, 33), (2, 1024, 4096), (4, 3072, 4096), (2, 1, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_kernel_matches_plain(cuda, b, s, d, dtype, with_h0):
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    x = _randn(gen, (b, s, d), dtype)
    r = torch.sigmoid(_randn(gen, (b, s, d), torch.float32)).to(dtype)
    i = torch.sigmoid(_randn(gen, (b, s, d), torch.float32)).to(dtype)
    log_a = -torch.exp(_randn(gen, (d,), torch.float32) * 0.3) * 0.1
    h0 = _randn(gen, (b, d), torch.float32) if with_h0 else None
    n = rs.launches
    y, hT, ckpt = rs.rglru_scan(x, r, i, log_a, h0)
    assert rs.launches == n + 1 and y.dtype == dtype and hT.dtype == torch.float32
    assert ckpt is None
    wy, wh = ref.rglru_reference(x, r, i, log_a, h0)
    torch.testing.assert_close(y.float(), wy.float(), **SCAN_TOL[dtype])
    torch.testing.assert_close(hT, wh, **SCAN_TOL[dtype])
    again = rs.rglru_scan(x, r, i, log_a, h0)  # the warps' carries fold in a fixed order
    assert torch.equal(again[0], y) and torch.equal(again[1], hT)


@pytest.mark.parametrize("b,s,d", [(2, 777, 512), (4, 1000, 4096), (1, 100, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_forward_checkpoints_reproduce_its_y(cuda, b, s, d, dtype):
    """Each group of CHUNK steps run again from the forward's checkpoint, one
    step at a time, gives the forward's own y: the checkpoints are the carries
    its steps used.  With r = 0 every decay is 1 and every operation of a step
    is exact or correctly rounded in both (a h + b is h + b), so the plain
    steps on the card give y bit for bit; with gates drawn at random, torch's
    exp and unfused a h + b stay within 1e-6 of it over a group."""
    gen = torch.Generator(device=cuda).manual_seed(s + d + 2)
    x = _randn(gen, (b, s, d), dtype)
    i = torch.sigmoid(_randn(gen, (b, s, d), torch.float32)).to(dtype)
    log_a = -torch.exp(_randn(gen, (d,), torch.float32) * 0.3) * 0.1
    h0 = _randn(gen, (b, d), torch.float32)
    for r, exact in ((torch.zeros_like(x), True),
                     (torch.sigmoid(_randn(gen, (b, s, d), torch.float32)).to(dtype), False)):
        y, hT, ckpt = rs.rglru_scan(x, r, i, log_a, h0, checkpoints=True)
        assert torch.equal(y, rs.rglru_scan(x, r, i, log_a, h0)[0])
        log_at = (8.0 * r.float()) * log_a
        a = torch.exp(log_at)
        bt = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_at), min=1e-12)) * (i * x).float()
        y_again = torch.empty((b, s, d), dtype=torch.float32, device=cuda)
        for g in range(ckpt.shape[1]):
            h = ckpt[:, g]
            for t in range(g * rs.CHUNK, min(s, (g + 1) * rs.CHUNK)):
                h = a[:, t] * h + bt[:, t]
                y_again[:, t] = h
        if exact:
            assert torch.equal(y_again.to(dtype), y)
            assert torch.equal(y_again[:, -1], hT)
        else:
            torch.testing.assert_close(y_again.to(dtype).float(), y.float(),
                                       atol=1e-6,
                                       rtol=1e-5 if dtype == torch.float32 else 1e-2)


# S off the 32-step tile (1000, 200, 33, 1); Din off the 64-channel block
# (200, 100) and, for bf16, off the 16-byte vector (100)
@pytest.mark.parametrize("b,s,din,n", [(2, 512, 256, 16), (1, 200, 128, 8), (2, 1000, 1024, 16),
                                       (1, 33, 200, 8), (4, 1000, 8192, 16), (2, 31, 100, 16),
                                       (3, 1, 64, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [True, False])
def test_mamba_kernel_matches_plain(cuda, b, s, din, n, dtype, with_h0):
    gen = torch.Generator(device=cuda).manual_seed(s + din + n)
    x = _randn(gen, (b, s, din), dtype)
    delta = torch.nn.functional.softplus(_randn(gen, (b, s, din), torch.float32))
    A = -torch.exp(_randn(gen, (din, n), torch.float32) * 0.5)
    Bm = _randn(gen, (b, s, n), dtype)
    Cm = _randn(gen, (b, s, n), dtype)
    D = _randn(gen, (din,), torch.float32)
    h0 = _randn(gen, (b, din, n), torch.float32) if with_h0 else None
    k = ms.launches
    y, hT, ckpt = ms.mamba_scan(x, delta, A, Bm, Cm, D, h0)
    assert ms.launches == k + 1 and y.dtype == dtype and hT.dtype == torch.float32
    assert ckpt is None
    wy, wh = ref.mamba_scan_reference(x, delta, A, Bm, Cm, D, h0)
    torch.testing.assert_close(y.float(), wy.float(), **SCAN_TOL[dtype])
    torch.testing.assert_close(hT, wh, **SCAN_TOL[dtype])


def _grads_close(got, want, atol, rtol):
    """Each gradient within atol of its largest entry plus rtol of itself."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = w.float().abs().max()
        assert bool(((g.float() - w.float()).abs() <= atol * scale + rtol * w.float().abs()).all())


# S off the 16-step group and the 64-step summary (1000, 33, 7, 300); Din off
# the 64-channel block (200, 100, 136); falcon-mamba-7b's Din 8192 at S 1024,
# at B=4 (one chunk) and B=1 (two chunks of 512 and the first pass), and at a
# ragged S (1000: chunks of 512 and 488); chunks of 64 steps where the grid is
# small (300, 136: five chunks, the last ragged; S 7 and 33 under one chunk)
@pytest.mark.parametrize("b,s,din,n", [(2, 512, 256, 16), (1, 200, 128, 8), (2, 1000, 1024, 16),
                                       (1, 33, 200, 8), (4, 1024, 8192, 16), (2, 7, 100, 16),
                                       (1, 1024, 8192, 16), (1, 1000, 8192, 16),
                                       (1, 300, 136, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [True, False])
def test_mamba_backward_kernel_matches_plain_and_repeats_bitwise(cuda, b, s, din, n, dtype,
                                                                 with_h0):
    gen = torch.Generator(device=cuda).manual_seed(s + din + n + 1)
    x = _randn(gen, (b, s, din), dtype)
    delta = torch.nn.functional.softplus(_randn(gen, (b, s, din), torch.float32))
    A = -torch.exp(_randn(gen, (din, n), torch.float32) * 0.5)
    Bm, Cm = _randn(gen, (b, s, n), dtype), _randn(gen, (b, s, n), dtype)
    D = _randn(gen, (din,), torch.float32)
    h0 = _randn(gen, (b, din, n), torch.float32) if with_h0 else None
    dy = _randn(gen, (b, s, din), dtype)
    dhT = _randn(gen, (b, din, n), torch.float32) if with_h0 else None
    args = (x, delta, A, Bm, Cm, D, h0)
    y, hT, ckpt = ms.mamba_scan(*args, checkpoints=True)
    torch.testing.assert_close(y, ms.mamba_scan(*args)[0], atol=0, rtol=0)
    k = ms.bwd_launches
    got = ms.mamba_scan_backward(*args, dy, dhT, ckpt)
    again = ms.mamba_scan_backward(*args, dy, dhT, ckpt)
    assert ms.bwd_launches == k + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = ref.mamba_scan_backward_reference(*args, dy, dhT, chunk=ms.CHUNK)
    _grads_close(got, want, **SCAN_TOL[dtype])


# S off the reverse scan's 64-step chunk (777, 5, 40, 1, 45) and on it (64,
# 1024, 3072); recurrentgemma-9b's training shape (2, 1024, 4096); D off the
# 64-thread block (70, 33)
@pytest.mark.parametrize("b,s,d", [(2, 777, 512), (1, 64, 128), (4, 3072, 4096), (3, 5, 70),
                                   (2, 1024, 4096), (1, 40, 256), (2, 1, 64), (2, 45, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_backward_kernel_matches_plain_and_repeats_bitwise(cuda, b, s, d, dtype, with_h0):
    gen = torch.Generator(device=cuda).manual_seed(s + d + 1)
    x = _randn(gen, (b, s, d), dtype)
    r = torch.sigmoid(_randn(gen, (b, s, d), torch.float32)).to(dtype)
    i = torch.sigmoid(_randn(gen, (b, s, d), torch.float32)).to(dtype)
    log_a = -torch.exp(_randn(gen, (d,), torch.float32) * 0.3) * 0.1
    h0 = _randn(gen, (b, d), torch.float32) if with_h0 else None
    dy = _randn(gen, (b, s, d), dtype)
    dhT = _randn(gen, (b, d), torch.float32) if with_h0 else None
    y, hT, ckpt = rs.rglru_scan(x, r, i, log_a, h0, checkpoints=True)
    torch.testing.assert_close(y, rs.rglru_scan(x, r, i, log_a, h0)[0], atol=0, rtol=0)
    k = rs.bwd_launches
    got = rs.rglru_scan_backward(x, r, i, log_a, h0, dy, dhT, ckpt)
    again = rs.rglru_scan_backward(x, r, i, log_a, h0, dy, dhT, ckpt)
    assert rs.bwd_launches == k + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = ref.rglru_backward_reference(x, r, i, log_a, h0, dy, dhT)
    _grads_close(got, want, **SCAN_TOL[dtype])


def test_scans_under_grad_run_both_kernels(cuda):
    """ops routes CUDA tensors that need a gradient through the autograd
    Functions: one forward and one backward launch each, and the same
    gradients as the plain route."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=cuda).manual_seed(3)
    x, dt = _randn(gen, (2, 70, 128), torch.float32), _randn(gen, (2, 70, 128), torch.float32)
    A = -torch.exp(_randn(gen, (128, 16), torch.float32) * 0.5)
    bc = [_randn(gen, (2, 70, 16), torch.float32) for _ in range(2)]
    D = _randn(gen, (128,), torch.float32)
    m_in = [x, torch.nn.functional.softplus(dt), A, *bc, D]
    r_in = [x, torch.sigmoid(dt), torch.sigmoid(x * 0.5), -torch.exp(D * 0.3) * 0.1]
    for fn, inputs, mod in ((ops.mamba_scan, m_in, ms), (ops.rglru_scan, r_in, rs)):
        grads = {}
        for impl in ("cuda", "torch"):
            leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
            before = (mod.launches, mod.bwd_launches)
            y, _ = fn(*leaves, impl=impl)
            y.square().sum().backward()
            n = int(impl == "cuda")
            assert (mod.launches - before[0], mod.bwd_launches - before[1]) == (n, n)
            grads[impl] = [t.grad for t in leaves]
        _grads_close(grads["cuda"], grads["torch"], **SCAN_TOL[torch.float32])


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "grok-1-314b"])
def test_moe_on_the_card_matches_the_cpu(cuda, arch):
    """moe_apply on the card against the same weights and input on the CPU,
    in fp32 (cuBLAS and the CPU's BLAS sum in other orders: atol 2e-4, rtol
    1e-3, the bound of the CPU tests against JAX), also under PyTorch's
    deterministic mode, which the trainer's steps turn on; the dense
    path's chunks, forced small, give the same values."""
    cfg = dataclasses.replace(get_smoke_config(arch, dtype="float32"), d_model=256)
    params = init_params(moe.moe_specs(cfg), torch.Generator().manual_seed(0))
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want = moe.moe_apply(params, x, cfg)
    on_card = {k: v.to(cuda) for k, v in params.items()}
    got = moe.moe_apply(on_card, x.to(cuda), cfg)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=1e-3)
    torch.use_deterministic_algorithms(True)
    try:
        again = moe.moe_apply(on_card, x.to(cuda), cfg)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.testing.assert_close(again.cpu(), want, atol=2e-4, rtol=1e-3)
    xt = x.to(cuda).reshape(-1, cfg.d_model)
    torch.testing.assert_close(moe._dense_moe(on_card, xt, cfg, chunk=7),
                               moe._dense_moe(on_card, xt, cfg), atol=1e-6, rtol=1e-6)


def test_moe_router_ties_go_to_the_lower_expert_on_the_card(cuda):
    """Equal probabilities pick the lower expert index on the card too, as
    jax.lax.top_k does (torch.topk promises no order among ties)."""
    x = torch.rand((64, 16), device=cuda)
    w = torch.zeros((16, 384), device=cuda)
    _, idx = moe._route(x, w, 8)
    assert idx.tolist() == [list(range(8))] * 64
    w[:, 300] = w[:, 200] = 1.0  # two tied leaders, then ties among the rest
    _, idx = moe._route(x.bfloat16(), w, 8)
    assert idx.tolist() == [[200, 300, 0, 1, 2, 3, 4, 5]] * 64


@pytest.mark.parametrize("arch,counts", [("falcon-mamba-7b", {"mamba": 2}),
                                         ("recurrentgemma-9b", {"rglru": 4, "flash": 2})])
def test_recurrent_train_step_gradients_match_plain_path(cuda, arch, counts):
    """Every parameter's gradient of a smoke train step, kernel path against
    plain path, in fp32 (within 2e-3 of each gradient's largest entry, the
    bound of chip_smoke.py's train_parity), and every one nonzero: a CUDA
    scan that passed no gradient would leave everything upstream of it at
    zero."""
    cfg = get_smoke_config(arch, dtype="float32")
    params = DecoderLM(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=2, seq_len=80)).batch_at(0).items()}
    mods = {"mamba": ms, "rglru": rs, "flash": fa}
    fwd_bwd = {"mamba": (ms, "bwd_launches"), "rglru": (rs, "bwd_launches"),
               "flash": (fb, "launches")}

    def loss_and_grads(impl):
        model = DecoderLM(dataclasses.replace(cfg, attn_impl=impl))
        leaves = {n: p.detach().requires_grad_(True) for n, p in flatten_named(params)}
        loss = model.loss(tree_map_named(lambda n, _: leaves[n], params), batch)
        return float(loss), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    before = {k: (m.launches, getattr(*fwd_bwd[k])) for k, m in mods.items()}
    loss_k, grads_k = loss_and_grads("cuda")
    launched = {k: (m.launches - before[k][0], getattr(*fwd_bwd[k]) - before[k][1])
                for k, m in mods.items()}
    assert launched == {k: (counts.get(k, 0),) * 2 for k in mods}
    loss_p, grads_p = loss_and_grads("torch")
    assert abs(loss_k - loss_p) <= 1e-4
    for name, g in grads_p.items():
        assert bool(torch.isfinite(grads_k[name]).all()) and grads_k[name].abs().max() > 0, name
        scale = g.abs().max()
        assert float((grads_k[name] - g).abs().max()) <= 2e-3 * float(scale), name


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen1.5-0.5b", "kimi-k2-1t-a32b",
                                  "grok-1-314b"])
def test_model_kernel_path_matches_plain_path(cuda, arch):
    cfg = get_smoke_config(arch, dtype="float32")
    params = DecoderLM(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))

    def run(impl):
        model = DecoderLM(dataclasses.replace(cfg, attn_impl=impl))
        with torch.inference_mode():
            logits, cache = model.prefill(params, {"tokens": toks[:, :16]})
            outs = [logits]
            for t in range(16, 20):
                logits, cache = model.decode_step(params, cache, toks[:, t])
                outs.append(logits)
        return torch.stack(outs)

    f0, d0 = fa.launches, da.launches
    got = run("cuda")
    assert (fa.launches - f0, da.launches - d0) == (cfg.n_layers, 4 * cfg.n_layers)
    torch.testing.assert_close(got, run("torch"), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,prompt,counts", [
    ("falcon-mamba-7b", 20, {"mamba": 2}),
    # 70 > the smoke window 64: prefill rolls the ring, decode wraps it
    ("recurrentgemma-9b", 70, {"rglru": 4, "flash": 2, "decode": 8}),
])
def test_recurrent_model_kernel_path_matches_plain_path(cuda, arch, prompt, counts):
    cfg = get_smoke_config(arch, dtype="float32")
    params = DecoderLM(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, prompt + 4), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    mods = {"mamba": ms, "rglru": rs, "flash": fa, "decode": da}

    def run(impl):
        model = DecoderLM(dataclasses.replace(cfg, attn_impl=impl))
        with torch.inference_mode():
            logits, cache = model.prefill(params, {"tokens": toks[:, :prompt]})
            outs = [logits]
            for t in range(prompt, prompt + 4):
                logits, cache = model.decode_step(params, cache, toks[:, t])
                outs.append(logits)
        return torch.stack(outs)

    before = {k: m.launches for k, m in mods.items()}
    got = run("cuda")
    launched = {k: m.launches - before[k] for k, m in mods.items()}
    assert launched == {k: counts.get(k, 0) for k in mods}
    # the parity bound of chip_smoke.py: the random model's attention logits
    # are large (see tests/test_torch_models.py), so hold the logits, not ulps
    torch.testing.assert_close(got, run("torch"), atol=2e-3, rtol=0)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (2, 4, 2, 130, 130, 64),      # GQA, not a multiple of the tile
    (1, 8, 1, 50, 200, 128),      # MQA, Sk > Sq
    (1, 6, 2, 100, 100, 128),     # group of 3
    (1, 2, 2, 70, 70, 32),        # MHA, head_dim 32
    (2, 16, 1, 90, 90, 64),       # group of 16
    (1, 3, 1, 257, 300, 128),     # ragged past both routes' tiles, Sk > Sq
    (1, 16, 1, 300, 300, 256),    # recurrentgemma-9b's MQA at D=256, ragged
    (2, 16, 1, 130, 200, 256),    # D=256, Sk > Sq
    (2, 8, 1, 130, 200, 112),     # kimi-k2's head_dim 112, a group of 8, Sk > Sq
    (1, 4, 2, 257, 257, 112),     # head_dim 112, ragged past the tiles
    (2, 4, 1, 130, 200, 160),     # stablelm-12b's head_dim 160, split by warpgroup, Sk > Sq
    (1, 8, 2, 257, 257, 160),     # head_dim 160, ragged past the tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 17), (True, 128)])
def test_flash_backward_kernel_matches_plain_and_repeats_bitwise(cuda, b, hq, hkv, sq, sk, d,
                                                                 dtype, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(sq * sk + d)
    q = _randn(gen, (b, hq, sq, d), dtype)
    k = _randn(gen, (b, hkv, sk, d), dtype)
    v = _randn(gen, (b, hkv, sk, d), dtype)
    do = _randn(gen, (b, hq, sq, d), dtype)
    kw = dict(causal=causal, window=window, q_offset=sk - sq)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    _, want_lse = ref.flash_attention_reference(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    n, by_route = fb.launches, fb.launches_by_route[ROUTE[dtype]]
    got = fb.flash_attention_backward(q, k, v, o, lse, do, **kw)
    again = fb.flash_attention_backward(q, k, v, o, lse, do, **kw)
    assert fb.launches == n + 2 and fb.launches_by_route[ROUTE[dtype]] == by_route + 2
    want = ref.flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, a)
        torch.testing.assert_close(g.float(), w.float(), atol=TOL[dtype], rtol=1e-2)


# recurrentgemma-9b's MQA (16/1 heads) at D=256 where the dK/dV kernel splits
# the group's heads over blocks: its training shape (HS = 8 on 132 SMs), with
# and without its window; ragged S; Sk > Sq with a window; a short window
@pytest.mark.parametrize("b,sq,sk,window", [(2, 1024, 1024, None), (2, 1024, 1024, 2048),
                                            (1, 300, 300, None), (2, 130, 400, 128),
                                            (1, 300, 300, 17)])
def test_flash_backward_d256_head_splits_match_plain_and_repeat_bitwise(cuda, b, sq, sk, window):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hs = fb.head_splits(b, 16, 1, sk, 256, sms)
    assert hs > 1
    gen = torch.Generator(device=cuda).manual_seed(sq * sk + 256)
    q, do = (_randn(gen, (b, 16, sq, 256), torch.bfloat16) for _ in range(2))
    k, v = (_randn(gen, (b, 1, sk, 256), torch.bfloat16) for _ in range(2))
    kw = dict(causal=True, window=window, q_offset=sk - sq)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    got = fb.flash_attention_backward(q, k, v, o, lse, do, **kw)
    again = fb.flash_attention_backward(q, k, v, o, lse, do, **kw)
    assert fb.last_head_splits == hs  # the split the planner chose is the one launched
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = ref.flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    _grads_close(got, want, **SCAN_TOL[torch.bfloat16])  # 2e-2 of each gradient's scale


def _bwd_digest(b, hq, hkv, s, d, window):
    """sha256 of the bf16 (dq, dk, dv) bytes of the wgmma backward on inputs
    made by numpy from a seed (causal, Sq = Sk = s), through the forward's o
    and lse."""
    rng = np.random.default_rng(b * hq * s + d)
    t = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", torch.bfloat16)
         for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d))]
    q, k, v, do = t
    kw = dict(causal=True, window=window)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    grads = fb.flash_attention_backward(q, k, v, o, lse, do, **kw)
    h = hashlib.sha256()
    for g in grads:
        h.update(g.view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()


# Where the planner gives HS = 1 (the grid already fills 132 SMs) the dK/dV
# kernel keeps the arithmetic of the design without head splits, whose
# outputs on these inputs hashed to these digests on an NVIDIA H100 80GB
# HBM3: llama3.2-3b's (D=128) and stablelm-12b's (D=160) training shapes,
# and MHA at D=64 with a window
BITS_AT_ONE_SPLIT = {
    (4, 24, 8, 1024, 128, None): "588927578f8858f40d842c434d20e85095e74ce05a528304a90d2b27154f688c",
    (2, 32, 8, 1024, 160, None): "0a436227f5912649016ea39031783cd236575e09efaf120dbbd6bd898ecc7334",
    (2, 8, 8, 1280, 64, 200): "3f3f8e6bcacb8716f5f4e1892aaa354f6a5a8ff522f76da9846101b7b0e10240",
}


@pytest.mark.parametrize("shape", list(BITS_AT_ONE_SPLIT))
def test_flash_backward_bits_unchanged_at_one_head_split(cuda, shape):
    b, hq, hkv, s, d, _ = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sms != 132:
        pytest.skip(f"the digests are an H100 SXM's (132 SMs); this card has {sms}")
    assert fb.head_splits(b, hq, hkv, s, d, sms) == 1
    assert _bwd_digest(*shape) == BITS_AT_ONE_SPLIT[shape]
    assert fb.last_head_splits == 1


def _fwd_digest(b, hq, hkv, sq, sk, d, window):
    """sha256 of the bf16 o and fp32 lse bytes of the wgmma forward on inputs
    made by numpy from a seed (causal, q_offset = sk - sq)."""
    rng = np.random.default_rng(b * hq * sq + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda",
                                                                                 torch.bfloat16)
               for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    o, lse = fa.flash_attention(q, k, v, causal=True, window=window, q_offset=sk - sq,
                                return_lse=True)
    h = hashlib.sha256()
    h.update(o.view(torch.int16).cpu().numpy().tobytes())
    h.update(lse.cpu().numpy().tobytes())
    return h.hexdigest()


# The wgmma forward's outputs and lse on these inputs, as the design before
# the forward's overlapped schedule computed them on an NVIDIA H100 80GB HBM3:
# a schedule reorders no arithmetic, so every head dim keeps these bits.
# kimi-k2's (D=112, 64/8 heads), llama3.2-3b's (D=128), stablelm-12b's
# (D=160, 32/8) and recurrentgemma-9b's (D=256, 16/1, window 2048) prefill
# shapes; MHA at D=64 with a window; and ragged groups of 3 with q_offset
FWD_BITS = {
    (4, 64, 8, 1024, 1024, 112, None):
        "c18ad6dcca59598403054df5af7aad108e90bbe7d1c4316f29f3c428b565253c",
    (4, 24, 8, 1024, 1024, 128, None):
        "e76a228814c963faecf6ca50743ab898f466d47f3cabe98ac4b9c13956d6363c",
    (4, 32, 8, 1024, 1024, 160, None):
        "e23ab5b720a92f40e4239717f3dba213e82dfa5d61f6dcf7ea35aa3f1149e77a",
    (1, 16, 1, 3072, 3072, 256, 2048):
        "feb0f0a08f2ca09c6a32f53527076ceacdfcc5aa5a28e4a52004db278abc6c9d",
    (2, 16, 16, 1024, 1024, 64, 200):
        "d7d3958180dccdfc5b0954ba4845611c6b6da4c75897abdc375d98d5f8284526",
    (1, 6, 2, 300, 777, 32, None):
        "3f33656252d81ce2d6f2698ef56a55d684c6c798e235bcb791067a8020114314",
    (1, 3, 1, 200, 500, 112, 64):
        "ecc002f1239a578d022ea8bcb1d57605497fd22e07b09f73f23121477cef784a",
    (2, 12, 4, 333, 333, 160, None):
        "ebbc7606c9ff71ac3b1c68154a08fb5f363f170e8ebeaead133f0b9fec508cc6",
}


@pytest.mark.parametrize("shape", list(FWD_BITS))
def test_flash_forward_bits_unchanged(cuda, shape):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sms != 132:
        pytest.skip(f"the digests are an H100 SXM's (132 SMs); this card has {sms}")
    assert _fwd_digest(*shape) == FWD_BITS[shape]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_routes_by_dtype(cuda, dtype):
    """bf16 takes the wgmma kernels and fp32 the CUDA-core ones, forward and
    backward, and the other route is not touched."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do = (_randn(gen, s, dtype) for s in ((1, 4, 96, 128), (1, 2, 96, 128),
                                                   (1, 2, 96, 128), (1, 4, 96, 128)))
    before = dict(fa.launches_by_route), dict(fb.launches_by_route)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    fb.flash_attention_backward(q, k, v, o, lse, do)
    for mod, was in zip((fa, fb), before):
        assert {r: mod.launches_by_route[r] - was[r] for r in mod.ROUTES} == {
            r: int(r == ROUTE[dtype]) for r in mod.ROUTES}


def test_flash_autograd_in_bf16_runs_both_wgmma_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(6)
    leaves = [_randn(gen, s, torch.bfloat16).requires_grad_(True)
              for s in ((2, 6, 150, 128), (2, 2, 150, 128), (2, 2, 150, 128))]
    f0, b0 = fa.launches_by_route["wgmma"], fb.launches_by_route["wgmma"]
    out = fa.flash_attention_trainable(*leaves, causal=True, window=64)
    out.backward(torch.ones_like(out))
    assert (fa.launches_by_route["wgmma"] - f0, fb.launches_by_route["wgmma"] - b0) == (1, 1)
    plain = [t.detach().clone().requires_grad_(True) for t in leaves]
    ref_out = fa.flash_attention_trainable(*plain, causal=True, window=64, use_kernels=False)
    ref_out.backward(torch.ones_like(ref_out))
    torch.testing.assert_close(out.float(), ref_out.float(), atol=TOL[torch.bfloat16], rtol=1e-2)
    for a, p in zip(leaves, plain):
        torch.testing.assert_close(a.grad.float(), p.grad.float(), atol=TOL[torch.bfloat16],
                                   rtol=1e-2)


def test_flash_autograd_on_the_card_runs_both_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    leaves = [_randn(gen, s, torch.float32).requires_grad_(True)
              for s in ((1, 4, 96, 64), (1, 2, 96, 64), (1, 2, 96, 64))]
    f0, b0 = fa.launches, fb.launches
    out = fa.flash_attention_trainable(*leaves, causal=True)
    out.backward(torch.ones_like(out))
    assert (fa.launches - f0, fb.launches - b0) == (1, 1)
    plain = [t.detach().clone().requires_grad_(True) for t in leaves]
    ref_out = fa.flash_attention_trainable(*plain, causal=True, use_kernels=False)
    ref_out.backward(torch.ones_like(ref_out))
    for a, p in zip(leaves, plain):
        torch.testing.assert_close(a.grad, p.grad, atol=TOL[torch.float32], rtol=1e-2)


def _bits(t):
    """A tensor's bits: floats as integers of their width, so -0.0 != +0.0."""
    if t.is_floating_point():
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return t


def _planted(n, dtype, gen):
    x = _randn(gen, (n,), dtype)
    x[3:40] = 0
    x[100::97] = 2.5
    x[150::193] = -2.5
    return x


# the planted inputs at (n, k), then every case of tests/_topk_cases.py at each k
TOPK_CASES = ([("planted", n, k) for n, k in [(5000, 10), (1 << 20, 10), (3000, 37),
                                              (2049, 1024), (100, 1)]]
              + [(case, None, k) for case in sorted(topk_cases.CASES) for k in topk_cases.KS])


@pytest.mark.parametrize("case,n,k", TOPK_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_kernel_equals_plain(cuda, case, n, k, dtype):
    """Bit for bit against the plain version, twice (a bitwise repeat), and on
    the input shifted by one element (not 16-byte aligned: the kernel's
    scalar loads and stores); a third call records each block's path, which
    is the plain model's (``fallback_blocks``), with the same bits."""
    if case == "planted":
        x = _planted(n, dtype, torch.Generator(device=cuda).manual_seed(n + k))
    else:
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        x = torch.from_numpy(topk_cases.make(case, name)).to(cuda).to(dtype)
    for inp in (x, x[1:]):
        c = tk.launches
        got = tk.topk_compress(inp, k)
        again = tk.topk_compress(inp, k)
        *third, path = tk.topk_compress(inp, k, paths=True)
        assert tk.launches == c + 3
        for g, a, t, w in zip(got, again, third, ref.topk_compress_reference(inp, k)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(_bits(g), _bits(w)) and torch.equal(_bits(a), _bits(g))
            assert torch.equal(_bits(t), _bits(g))
        assert torch.equal(path, tk.fallback_blocks(inp, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_kernel_returns_on_nan(cuda, dtype):
    """NaN is outside the contract (deltas of finite state): the kernel must
    still return, with k distinct positions inside each block, and the
    finite entries it did not keep unchanged in the residual."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = _randn(gen, (3 * 1024 + 5,), dtype)
    x[::50] = float("nan")
    x[1024:2048] = float("nan")
    for k in (10, 64):
        vals, idx, res = tk.topk_compress(x, k)
        torch.cuda.synchronize()
        assert idx.shape == (4, k) and bool(((idx >= 0) & (idx < 1024)).all())
        assert all(len(set(row)) == k for row in idx.tolist())
        xb = torch.nn.functional.pad(x, (0, 1024 - 5)).view(4, 1024)
        kept = torch.zeros_like(xb, dtype=torch.bool).scatter(1, idx.long(), True)
        same = (~kept).reshape(-1)[:x.numel()] & ~torch.isnan(x)
        assert torch.equal(_bits(res[same]), _bits(x[same]))


@pytest.mark.parametrize("nbytes", [0, 1, 3, 2047, 2048, 2049, 4096 + 7, (1 << 22) + 1])
def test_fletcher32_kernel_equals_host_checksum(cuda, nbytes):
    gen = torch.Generator(device=cuda).manual_seed(nbytes)
    data = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=cuda, generator=gen)
    c = lc.launches
    got = int(lc.fletcher32(data))
    assert lc.launches == c + 1
    assert got == fletcher32_padded(data.cpu().numpy().tobytes()) == int(
        ref.fletcher32_reference(data))


def test_fletcher32_wave_kernel_equals_host_checksums(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    chunks = [torch.randint(0, 256, (n,), dtype=torch.uint8, device=cuda, generator=gen)
              for n in (5, 0, 2048, 7001, 65536, 3, 1 << 20)]
    chunks.append(chunks[3][1:])                    # not 16-byte aligned
    chunks.append(lc.as_bytes(torch.ones(33, 7, dtype=torch.bfloat16, device=cuda)))
    c = lc.launches
    got = lc.fletcher32_wave(chunks)
    assert lc.launches == c + 1
    assert got.tolist() == [fletcher32_padded(t.cpu().numpy().tobytes()) for t in chunks]


def test_train_step_replays_bitwise(cuda):
    """The same state and batch give the same bits twice: the attention
    kernels use no atomics, and the rest runs under deterministic mode."""
    with deterministic_cuda():
        _replay_train_step(cuda)


def _replay_train_step(cuda):
    cfg = get_smoke_config("llama3.2-3b")
    model = DecoderLM(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3))
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in SyntheticPipeline(
        DataConfig(vocab_size=cfg.vocab_size, global_batch=4, seq_len=64)).batch_at(0).items()}
    step = make_train_step(model, tcfg)
    outs = []
    for _ in range(2):
        state = init_train_state(model, torch.Generator(device=cuda).manual_seed(0), tcfg)
        f0, b0 = fa.launches, fb.launches
        state, metrics = step(state, batch)
        assert (fa.launches - f0, fb.launches - b0) == (cfg.n_layers, cfg.n_layers)
        outs.append([t.cpu() for _, t in flatten_named(state)] + [metrics["loss"].cpu()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b", "llama3.2-3b"])
def test_remat_gradients_are_bitwise_none(cuda, arch):
    """ModelConfig.remat on the kernel path (bf16 smoke widths, deterministic
    mode): "dots", "save_dots" and "full" give the gradients of "none" bit
    for bit; the recomputed superblocks launch each forward kernel again,
    and each backward kernel runs once."""
    cfg = get_smoke_config(arch)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in SyntheticPipeline(
        DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=64)).batch_at(0).items()}
    params = DecoderLM(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    counts = {"fwd": [(ms, "launches"), (rs, "launches"), (fa, "launches")],
              "bwd": [(ms, "bwd_launches"), (rs, "bwd_launches"), (fb, "launches")]}
    outs = {}
    for mode in ("none", "dots", "save_dots", "full"):
        model = DecoderLM(dataclasses.replace(cfg, remat=mode))
        before = {k: [getattr(m, a) for m, a in v] for k, v in counts.items()}
        with deterministic_cuda(), torch.enable_grad():
            live = {n: p.detach().requires_grad_(True) for n, p in flatten_named(params)}
            loss = model.loss(tree_map_named(lambda n, _: live[n], params), batch)
            grads = torch.autograd.grad(loss, list(live.values()))
        ran = {k: [getattr(m, a) - b for (m, a), b in zip(v, before[k])]
               for k, v in counts.items()}
        outs[mode] = [g.view(torch.uint8) for g in grads], ran
    grads0, ran0 = outs["none"]
    assert sum(ran0["fwd"]) > 0 and ran0["fwd"] == ran0["bwd"]
    for mode, (grads, ran) in outs.items():
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0)), mode
        again = 1 if mode == "none" else 2
        assert ran == {"fwd": [n * again for n in ran0["fwd"]], "bwd": ran0["bwd"]}, mode


def test_device_checksums_are_accepted_by_the_blade(cuda, tmp_path):
    """A commit of state on the card: one fletcher32_wave launch checksums
    its objects there, and FileBlade.get verifies them on the host, on the
    primary and the mirror."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    state = {"w": _randn(gen, (300, 7), torch.bfloat16), "b": _randn(gen, (1001,), torch.float32),
             "step": torch.tensor(3, dtype=torch.int32, device=cuda)}
    ckpt = CheckpointManager(AsymStore(FileBlade(str(tmp_path / "b"),
                                                 mirrors=[str(tmp_path / "m")])),
                             delta_every=2, delta_topk_frac=0.01)
    c, t = lc.launches, tk.launches
    ckpt.save_full(1, state)
    state["b"].add_(1.0)
    ckpt.save_delta(2, state)
    assert (lc.launches - c, tk.launches - t) == (2, 2)
    for path in ("b", "m"):
        store = AsymStore(FileBlade(str(tmp_path / path)))
        assert torch.equal(store.read_tensor(1, "w")[0], state["w"].cpu())
        assert torch.equal(store.read_tensor(2, "b")[0], ckpt._recon["b"])
    assert all(v.device.type == "cpu" for v in ckpt._recon.values())  # the view is on the host


def test_trainer_runs_deterministic_steps_and_gives_the_mode_back(cuda):
    """Trainer.run turns deterministic algorithms on for its steps only: the
    process's setting is the same before and after."""
    cfg = get_smoke_config("llama3.2-3b")
    before = torch.are_deterministic_algorithms_enabled()
    tr = Trainer(DecoderLM(cfg), TrainConfig(opt=OptConfig(lr=1e-3)),
                 DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=32), device=cuda)
    assert torch.are_deterministic_algorithms_enabled() == before
    tr.init()
    out = tr.run(TrainerConfig(total_steps=2))
    assert out["final_step"] == 2 and torch.are_deterministic_algorithms_enabled() == before


# ------------------------------------------------ the NVM blade's kernels
def _fletcher64_host(data: bytes) -> int:
    """Fletcher-64 over little-endian 32-bit words, zero-padded: the
    definition, in Python integers."""
    data = data + b"\x00" * (-len(data) % 4)
    words = np.frombuffer(data, dtype="<u4").tolist()
    n = len(words)
    s1 = sum(words) % 0xFFFFFFFF
    s2 = sum((n - j) * w for j, w in enumerate(words)) % 0xFFFFFFFF
    return (s2 << 32) | s1


def _log_bodies(rng, n, sizes, at):
    """(starts, lens) of `n` transaction bodies laid out as the blade's log
    writes them from offset `at`: a 13-byte header before each body, a
    9-byte commit record after it; each body 13 bytes a write of `sizes`."""
    starts, lens, pos = [], [], at
    for _ in range(n):
        body = sum(13 + int(rng.choice(sizes)) for _ in range(int(rng.integers(1, 9))))
        starts.append(pos + 13)
        lens.append(body)
        pos += 13 + body + 9
    return np.array(starts), np.array(lens)


def test_fletcher64_segments_kernel_matches_plain(cuda):
    """K1 at unaligned starts, empty and short segments, long ones (a block
    each) in the same launch, all-0xFF bodies and a segment ending at the
    arena's last byte; on both routes (a table past SMALL_SEGMENTS, and one
    with more than SMALL_LONG long segments, take the large one); and at the
    reboot's shapes (400 bodies of a log, one body of 480 bytes) on the small
    route.  Every call is one launch, bitwise the plain version and a second
    call."""
    from repro_torch.kernels import nvm_log

    gen = torch.Generator(device=cuda).manual_seed(5)
    arena = torch.randint(0, 256, (1 << 20,), dtype=torch.uint8, device=cuda, generator=gen)
    arena[4096:4096 + 70001] = 0xFF
    rng = np.random.default_rng(5)
    starts = [0, 1, 2, 3, 5, 4096, 4097, 100003, (1 << 20) - 7, (1 << 20) - 1, 7, 999]
    lens = [0, 1, 2, 3, 7, 70001, 70000, 40000, 7, 1, 0, 4]
    starts += rng.integers(0, (1 << 20) - 5000, 500).tolist()
    lens += rng.integers(0, 4097, 500).tolist()
    many = rng.integers(0, (1 << 20) - 20000, 90)
    log_starts, log_lens = _log_bodies(rng, 400, [8, 24, 64, 256], 53248)
    cases = {"mixed": (starts, lens, "small"),
             "past SMALL_SEGMENTS": (rng.integers(0, (1 << 20) - 5000, 6000),
                                     rng.integers(0, 4097, 6000), "large"),
             "past SMALL_LONG": (many, np.where(np.arange(90) % 9, 16385 + many % 3000, 33),
                                 "large"),
             "reboot: 400-tx log": (log_starts, log_lens, "small"),
             "reboot: power loss": ([398353], [480], "small")}
    host = arena.cpu().numpy().tobytes()
    for name, (s, n, route) in cases.items():
        c, by = nvm_log.fletcher64_launches, dict(nvm_log.fletcher64_launches_by_route)
        got = nvm_log.fletcher64_segments(arena, s, n)
        assert nvm_log.fletcher64_launches == c + 1, name
        assert {r: nvm_log.fletcher64_launches_by_route[r] - by[r] for r in nvm_log.ROUTES} == {
            r: int(r == route) for r in nvm_log.ROUTES}, name
        want = ref.fletcher64_segments_reference(arena, torch.tensor(s, device=cuda),
                                                 torch.tensor(n, device=cuda))
        assert got.tolist() == want.tolist(), name
        k = min(12, len(s))
        assert got.tolist()[:k] == [_fletcher64_host(host[a:a + m])
                                    for a, m in zip(list(s)[:k], list(n)[:k])], name
        assert nvm_log.fletcher64_segments(arena, s, n).tolist() == got.tolist(), name
    # a view at an odd address: the kernel aligns its chunks in the address space
    view = arena[3:]
    got = nvm_log.fletcher64_segments(view, starts[:8], lens[:8])
    assert got.tolist() == [_fletcher64_host(host[3 + a:3 + a + m])
                            for a, m in zip(starts[:8], lens[:8])]


@pytest.mark.parametrize("mirrors", [0, 2])
def test_apply_runs_kernel_matches_serial_loop(cuda, mirrors):
    """K2 on overlapping runs (duplicates, partial overlaps, empty runs),
    from a source span inside the arena, to the arena and its mirrors."""
    from repro_torch.kernels import nvm_log

    rng = np.random.default_rng(mirrors)
    size = 1 << 20
    base = rng.integers(0, 256, size, dtype=np.uint8)
    n = 3000
    addrs = rng.integers(0, size // 2, n)
    addrs[n // 3: n // 2] = addrs[: n // 2 - n // 3]
    addrs[n // 2: 2 * n // 3] = addrs[: 2 * n // 3 - n // 2] + 5
    lens = rng.integers(0, 600, n)
    lens[::11] = 0
    lo = size // 2 + 1000
    offs = rng.integers(0, 100000, n)
    dsts = [torch.from_numpy(base.copy()).to(cuda) for _ in range(1 + mirrors)]
    want = bytearray(base.tobytes())
    src = bytes(want[lo:lo + 101000])
    for a, o, ln in zip(addrs.tolist(), offs.tolist(), lens.tolist()):
        want[a:a + ln] = src[o:o + ln]
    plain = [d.clone() for d in dsts]
    c = nvm_log.apply_launches
    nvm_log.apply_runs(dsts, dsts[0][lo:lo + 101000], addrs, offs, lens)
    assert nvm_log.apply_launches == c + 1
    ref.apply_runs_reference(plain, plain[0][lo:lo + 101000].clone(),
                             *(torch.from_numpy(x).to(cuda) for x in (addrs, offs, lens)))
    for d, p in zip(dsts, plain):
        assert d.cpu().numpy().tobytes() == bytes(want)
        assert torch.equal(d, p)


def _apply_both(cuda, dsts, src_of, addrs, offs, lens):
    """K2 through the wrapper on `dsts`, the plain version on copies, and the
    serial loop on the host: all three bitwise equal.  `src_of(dsts)` is the
    source tensor of a destination list.  Returns the wrapper's routes."""
    from repro_torch.kernels import nvm_log

    plain = [d.clone() for d in dsts]
    want = [bytearray(d.cpu().numpy().tobytes()) for d in dsts]
    src = bytes(src_of(dsts).cpu().numpy().tobytes())
    for w in want:
        for a, o, ln in zip(addrs.tolist(), offs.tolist(), lens.tolist()):
            w[a:a + ln] = src[o:o + ln]
    before = dict(nvm_log.apply_launches_by_route)
    nvm_log.apply_runs(dsts, src_of(dsts), addrs, offs, lens)
    ref.apply_runs_reference(plain, src_of(plain).clone(),
                             *(torch.from_numpy(x).to(cuda) for x in (addrs, offs, lens)))
    for d, p, w in zip(dsts, plain, want):
        assert d.cpu().numpy().tobytes() == bytes(w)
        assert torch.equal(d, p)
    return {r: nvm_log.apply_launches_by_route[r] - before[r] for r in nvm_log.ROUTES}


@pytest.mark.parametrize("mirrors", [0, 2])
def test_apply_runs_small_route_every_alignment(cuda, mirrors):
    """The small route on overlapping runs for every pair of (src + off) mod
    16 and (dst + addr) mod 16, runs of 0, 1, 15, 16, 17 and 240 bytes, each
    with a whole, a partial and a nested overlap in shuffled order; with 2
    mirrors one of them starts 5 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(160 + mirrors)
    size, slot = 1 << 19, 1024
    base = rng.integers(0, 256, size, dtype=np.uint8)
    dsts = [torch.from_numpy(base.copy()).to(cuda)]
    if mirrors:
        dsts.append(torch.from_numpy(base.copy()).to(cuda))
        odd = torch.empty(size + 16, dtype=torch.uint8, device=cuda)[5:5 + size]
        odd.copy_(dsts[0])
        dsts.append(odd)
    src = torch.from_numpy(rng.integers(0, 256, 1 << 16, dtype=np.uint8)).to(cuda)
    assert src.data_ptr() % 16 == 0 == dsts[0].data_ptr() % 16
    lengths = (0, 1, 15, 16, 17, 240)
    for s in range(16):
        addrs, offs, lens = [], [], []
        for d in range(16):
            for k, ln in enumerate(lengths):
                at = (d * len(lengths) + k) * slot + 64 + d
                off = 16 * int(rng.integers(0, (1 << 12) - 32)) + s
                # the run, a whole copy of it, a partial overlap, a nested run
                addrs += [at, at, at + ln // 2, at + ln // 4]
                offs += [off, off + 7, off + 3, off + 1]
                lens += [ln, ln, ln, ln // 2]
        order = rng.permutation(len(addrs))
        addrs, offs, lens = (np.array(x, dtype=np.int64)[order] for x in (addrs, offs, lens))
        routes = _apply_both(cuda, dsts, lambda ds: src, addrs, offs, lens)
        assert routes == {"small": 1, "large": 0}


@pytest.mark.parametrize("mirrors", [0, 2])
def test_apply_runs_route_boundary(cuda, mirrors):
    """At the small route's largest table it takes one launch with the table
    in its parameters; one run more takes the large route.  Both from a log
    span inside the arena, on overlapping runs."""
    from repro_torch.kernels import nvm_log

    rng = np.random.default_rng(7 + mirrors)
    size = 1 << 20
    base = rng.integers(0, 256, size, dtype=np.uint8)
    lo = size // 2
    ndst = 1 + mirrors
    limit = (nvm_log.SMALL_WORDS - ndst) // 3
    assert nvm_log.route(ndst, limit) == "small" and nvm_log.route(ndst, limit + 1) == "large"
    for n, want in ((limit, "small"), (limit + 1, "large")):
        dsts = [torch.from_numpy(base.copy()).to(cuda) for _ in range(ndst)]
        addrs = rng.integers(0, lo - 300, n)
        addrs[n // 2:] = addrs[: n - n // 2] + rng.integers(-20, 21, n - n // 2)
        addrs = addrs.clip(0)
        lens = rng.integers(0, 257, n)
        offs = rng.integers(0, size - lo - 300, n)
        routes = _apply_both(cuda, dsts, lambda ds: ds[0][lo:], addrs, offs, lens)
        assert routes == {r: int(r == want) for r in nvm_log.ROUTES}


def test_apply_runs_small_call_is_one_launch(cuda, monkeypatch):
    """A small-route call, a hashtable put's 3 runs into an arena and a
    mirror: one kernel on the card, no host-to-device copy, no aten op on
    the host (no allocation, pinned or not) and no host plan."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import nvm_log

    dsts = [torch.zeros(1 << 20, dtype=torch.uint8, device=cuda) for _ in range(2)]
    dsts[0][1 << 19:] = 7
    src = dsts[0][1 << 19:]
    args = ([4096, 8192, 12288 + 3], [13, 34, 55], [8, 8, 24])
    nvm_log.apply_runs(dsts, src, *args)  # loads the library
    torch.cuda.synchronize()

    def no_plan(*_):
        raise AssertionError("a small-route call planned on the host")
    monkeypatch.setattr(nvm_log, "_shared_bytes", no_plan)
    for _ in range(3):  # the profiler at times loses a kernel
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            nvm_log.apply_runs(dsts, src, *args)
            torch.cuda.synchronize()
        device = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
        if device:
            break
    assert [n for n in device if "apply_small" in n] == device and len(device) == 1
    assert not [e.name for e in prof.events() if e.name.startswith("aten::")]
    assert all(bool((d[4096:4104] == 7).all()) and bool((d[12291:12315] == 7).all())
               for d in dsts)


def test_apply_runs_floor_launch(cuda):
    """The empty kernel the smoke times as a small call's floor launches."""
    from repro_torch.kernels import nvm_log

    nvm_log.floor_launch(torch.device(cuda))
    torch.cuda.synchronize()


def test_hashtable_on_a_card_blade_equals_the_cpu_blade(cuda):
    """The same RemoteHashTable run on a blade on the card and on the CPU:
    the same arena and mirror digests, clocks and Stats, and the card's
    blade replayed its logs with K2."""
    import dataclasses as dc

    from repro_torch.core import FEConfig, FrontEnd, NVMBackend
    from repro_torch.core.structures import RemoteHashTable
    from repro_torch.kernels import nvm_log

    def run(device):
        be = NVMBackend(capacity=1 << 23, num_mirrors=1, device=device)
        fe = FrontEnd(be, FEConfig.r())
        ht = RemoteHashTable(fe, "h", n_buckets=256)
        for k in range(300):
            ht.put(k * 7919 % 100003, k)
        ht.put_many([(k, -k) for k in range(50)])
        fe.drain(ht.h)
        got = [ht.get(k) for k in range(60)]
        digest = [hashlib.sha256(a.cpu().numpy().tobytes()).hexdigest()
                  for a in (be.arena, *(m.arena for m in be.mirrors))]
        return digest, fe.clock.now, be.clock.now, dc.asdict(fe.stats), dc.asdict(be.stats), got

    c = nvm_log.apply_launches
    on_card = run(cuda)
    assert nvm_log.apply_launches > c
    assert on_card == run("cpu")


def _two_blade_cluster(device):
    """A two-blade cluster through a migration with writes in its copy
    window, a power loss inside a replay (the front ends' checksum memo
    cleared, so the reboot verifies the committed bodies on the blade) and a
    promotion the data path makes: what must agree between the card and the
    CPU, and what was read back."""
    import dataclasses as dc

    from repro_torch.cluster import ClusterFrontEnd, NVMCluster, ShardedHashTable, migrate_shard
    from repro_torch.core import CrashError, FEConfig, oplog

    cluster = NVMCluster(n_blades=2, capacity_per_blade=1 << 23, n_shards=8, device=device)
    a = ClusterFrontEnd(cluster, FEConfig.rc(cache_bytes=4096, oplog_pipeline=1), fe_id=0)
    b = ClusterFrontEnd(cluster, FEConfig.rcb(cache_bytes=4096), fe_id=1)
    ta, tb = ShardedHashTable(a, "t", n_buckets=256), ShardedHashTable(b, "t", n_buckets=256)
    for k in range(200):
        ta.put(k, k)
    ta.drain()

    def during_copy():
        for k in range(500, 540):
            tb.put(k, k + 1)
        tb.drain()
    migrate_shard(ta, 3, cluster.add_blade(), during_copy=during_copy)
    for k in range(20000, 20060):
        tb.put(k, k)
    cluster.blades[0].schedule_torn_write(0, after_writes=4)
    try:
        b.drain_all()
    except CrashError:
        pass
    oplog._CSUM_CACHE.clear()
    cluster.blades[1].fail_permanently()
    for k in range(200, 260):
        ta.put(k, k)
    ta.drain()
    got = ta.get_many(list(range(260)) + list(range(500, 540)))
    blades = [([hashlib.sha256(x.cpu().numpy()).hexdigest()
                for x in (be.arena, *(m.arena for m in be.mirrors))],
               be.clock.now, dc.asdict(be.stats), be.device.type)
              for _, be in sorted(cluster.blades.items())]
    return (blades, cluster.directory.encode(), cluster.leases.encode(), cluster.failovers,
            [(c.clock.now, c.stats(), c.telemetry()) for c in (a, b)], got)


def test_two_blade_cluster_on_the_card_equals_the_cpu_cluster(cuda):
    """The same cluster story on the card and on the CPU: every blade's
    arena and mirror digests, the directory's and the lease table's bytes,
    the clocks, Stats and telemetry are equal, and the card's blades
    replayed their logs with K2 and verified bodies with K1."""
    from repro_torch.kernels import nvm_log

    k1, k2 = nvm_log.fletcher64_launches, nvm_log.apply_launches
    on_card = _two_blade_cluster(cuda)
    assert nvm_log.apply_launches > k2 and nvm_log.fletcher64_launches > k1
    assert {t for *_, t in on_card[0]} == {"cuda"}
    on_cpu = _two_blade_cluster("cpu")
    assert [b[:3] for b in on_card[0]] == [b[:3] for b in on_cpu[0]]
    assert on_card[1:] == on_cpu[1:]
    assert on_card[3] == 1 and on_card[-1] == list(range(260)) + list(range(501, 541))


@pytest.mark.parametrize("step", ["fig9 lock readers=6", "cross_structure batch_all"])
def test_sim_step_on_a_card_blade_equals_the_cpu_blade(cuda, step):
    """tests/_sim_driver.py's Fig 9 step (the seqlock's readers, 6 of them)
    and its cross-structure batch_all window (one combined flush) at
    benchmarks/run.py --smoke sizes, on a card blade and on a CPU blade:
    every step's digests, clocks, Stats, cache counts, results and the
    rows are equal, and the card's blade replayed its logs with K2."""
    import _sim_driver as drv
    from repro_torch.kernels import nvm_log

    preload, ops = drv.SMOKE

    def run(device):
        ns = drv.pkg("repro_torch", device)
        if step.startswith("fig9"):
            out = drv.fig9(ns, "lock", 6, preload, ops, ops)
        else:
            out = drv.vector_cross_structure(ns, preload, max(ops, 128))
        return out["steps"], out["rows"], ns.copies

    k2 = nvm_log.apply_launches
    on_card = run(cuda)
    assert nvm_log.apply_launches > k2
    assert on_card[2]["d2h"] > 0
    on_cpu = run("cpu")
    assert on_card[:2] == on_cpu[:2]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "llama3.2-3b"])
@pytest.mark.parametrize("remat", ["none", "dots"])
def test_stacked_gradients_are_the_indexed_routes_bits_on_the_card(cuda, monkeypatch, arch,
                                                                  remat):
    """A stacked group's gradient written a layer's slot at a time
    (models.model._layers) against indexing the stack once a layer (bf16
    smoke widths at 4 layers, deterministic mode): the same bits."""
    from repro_torch.models import model as model_mod

    cfg = get_smoke_config(arch, n_layers=4, remat=remat)
    model = DecoderLM(cfg)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in SyntheticPipeline(
        DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=64)).batch_at(0).items()}
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    outs = []
    for old in (False, True):
        if old:
            monkeypatch.setattr(model_mod, "_layers",
                                lambda tree, n: [model_mod._index(tree, r) for r in range(n)])
        with deterministic_cuda(), torch.enable_grad():
            live = {n: p.detach().requires_grad_(True) for n, p in flatten_named(params)}
            loss = model.loss(tree_map_named(lambda n, _: live[n], params), batch)
            grads = torch.autograd.grad(loss, list(live.values()))
        outs.append([t.reshape(-1).view(torch.uint8) for t in [loss.detach(), *grads]])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_channel_route_on_a_one_by_one_card_mesh_is_bitwise(cuda, tmp_path, arch):
    """The recurrent mixers' channel route (layers._mixer_mesh) on a 1 x 1
    mesh of the card (a one-rank NCCL group): step-0 gradients, two
    Adafactor steps and every greedy decode step's logits of the bf16 smoke
    model give the mesh-less path's bits, with the same scan launches."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, rules_for
    from repro_torch.models import layers
    from repro_torch.models.params import place, placements_of, shard
    from repro_torch.serving.engine import _whole
    from repro_torch.training.train_step import state_shardings

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = get_smoke_config(arch)
        model = DecoderLM(cfg)
        tcfg = TrainConfig(opt=OptConfig(kind="adafactor", lr=1e-3, momentum_dtype="bfloat16"))
        rules = rules_for(cfg, mesh, kind="train")
        batch = {k: torch.from_numpy(v).to(cuda) for k, v in SyntheticPipeline(
            DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=64)).batch_at(0).items()}
        toks = batch["tokens"][:, :16].long()
        counters = [(ms, "launches"), (ms, "bwd_launches"), (rs, "launches"), (rs, "bwd_launches")]
        runs = []
        for on_mesh in (False, True):
            before = [getattr(m, a) for m, a in counters]
            state = init_train_state(model, torch.Generator(device=cuda).manual_seed(0), tcfg)
            kw, b = {}, batch
            if on_mesh:
                state = place(state, state_shardings(model, tcfg, rules, mesh), mesh)
                kw = dict(rules=rules, mesh=mesh)
                b = {k: shard(v, placements_of(v.shape, ("act_batch",), mesh, rules), mesh)
                     for k, v in batch.items()}
            local = lambda t: t.to_local() if hasattr(t, "to_local") else t  # noqa: E731
            out = []
            with deterministic_cuda(), torch.enable_grad():
                live = {n: p.detach().requires_grad_(True)
                        for n, p in flatten_named(state["params"])}
                loss = model.loss(tree_map_named(lambda n, _: live[n], state["params"]), b, **kw)
                out += [local(g) for g in torch.autograd.grad(loss, list(live.values()))]
            step = make_train_step(model, tcfg, **kw)
            with deterministic_cuda():
                for _ in range(2):
                    state, metrics = step(state, b)
                    out += [local(metrics["loss"]), local(metrics["grad_norm"])]
            out += [local(t) for _, t in flatten_named(state)]
            drules = rules_for(cfg, mesh, kind="decode")
            params = state["params"]
            if on_mesh:
                params = place(params, _shardings(model.param_specs(), mesh, drules), mesh)
                t_in = shard(toks, placements_of(toks.shape, ("act_batch",), mesh, drules), mesh)
            else:
                t_in = toks
            with torch.inference_mode():
                logits, cache = model.prefill(params, {"tokens": t_in}, **(
                    dict(rules=drules, mesh=mesh) if on_mesh else {}))
                for _ in range(8):
                    logits = _whole(logits)
                    out.append(logits.clone())
                    nxt = torch.argmax(logits, -1)
                    if on_mesh:
                        nxt = shard(nxt, placements_of(nxt.shape, ("act_batch",), mesh, drules),
                                    mesh)
                    logits, cache = model.decode_step(params, cache, nxt, **(
                        dict(rules=drules, mesh=mesh) if on_mesh else {}))
            runs.append(([t.reshape(-1).view(torch.uint8) for t in out],
                         [getattr(m, a) - n for (m, a), n in zip(counters, before)]))
        (a, ran_a), (b_, ran_b) = runs
        assert len(a) == len(b_) and all(torch.equal(x, y) for x, y in zip(a, b_))
        assert ran_a == ran_b and sum(ran_a) > 0
        x = shard(torch.zeros((2, 4, cfg.d_model), device=cuda),
                  placements_of((2, 4, cfg.d_model), ("act_batch",), mesh, rules), mesh)
        kind = cfg.block_pattern[0][0]
        specs = layers.mamba_specs(cfg) if kind == "mamba" else layers.rglru_specs(cfg)
        p = place(init_params(specs, torch.Generator(device=cuda).manual_seed(1)),
                  _shardings(specs, mesh, rules), mesh)
        assert layers.channel_route(kind, p, x)
    finally:
        dist.destroy_process_group()


def _shardings(specs, mesh, rules):
    from repro_torch.models.params import make_shardings

    return make_shardings(specs, mesh, rules)


def test_optimizer_span_encloses_its_kernels_on_the_profilers_clock(cuda):
    """One Adafactor ``apply_opt`` (falcon-mamba-7b's settings) on two of
    its stacked leaves, cut to 2 layers, and a norm, under a torch.profiler
    that records the card alone, as a traced pass does: the spans record
    there, and ``train.optimizer``'s device interval, put on the host clock
    by the recording's anchor, encloses the kernels the profiler saw, all
    launched inside the span, to within 50 µs."""
    import torch.autograd.profiler as torch_profiler
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import profile as spans
    from repro_torch.training.optimizer import apply_opt, init_opt_state

    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {"in_proj": _randn(gen, (2, 4096, 16384), torch.bfloat16),
              "norm": _randn(gen, (4096,), torch.bfloat16),
              "out_proj": _randn(gen, (2, 8192, 4096), torch.bfloat16)}
    cfg = OptConfig(kind="adafactor", lr=1e-3, b2=0.95, momentum_dtype="bfloat16")
    state = init_opt_state(params, cfg)
    step = torch.zeros((), dtype=torch.int32, device=cuda)

    def grads():
        return [_randn(gen, p.shape, torch.bfloat16) for _, p in flatten_named(params)]

    apply_opt(params, grads(), state, cfg, step)  # warm: the allocator's blocks
    g = grads()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        on = torch_profiler._is_profiler_enabled
        apply_opt(params, g, state, cfg, step)
        torch.cuda.synchronize()
    assert on
    opt = [s for s in spans.spans() if s.name == "train.optimizer"][-1]
    norm = [s for s in spans.spans() if s.name == "train.grad_norm"][-1]
    assert opt.parent is None and norm.parent == opt.id and opt.attrs == {"leaves": 3}
    base = prof.profiler.kineto_results.trace_start_ns()
    kernels = [(base + e.time_range.start * 1e3, base + e.time_range.end * 1e3)
               for e in prof.events() if str(e.device_type).endswith("CUDA")]
    assert len(kernels) > 20
    first, last = min(a for a, _ in kernels), max(b for _, b in kernels)
    assert opt.d0 <= first + 50e3 and opt.d1 >= last - 50e3, (
        (first - opt.d0) / 1e3, (opt.d1 - last) / 1e3)
    assert opt.d0 - 1e3 <= norm.d0 <= norm.d1 <= opt.d1 + 1e3  # nested on the card too
    assert opt.t0 <= opt.d0 + 50e3  # the card begins the span's work after the host does
