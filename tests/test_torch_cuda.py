"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips, from inside a fixture, where
no CUDA device is available.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels.py:19-20.  This file imports no
JAX: the machine with the card has none.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import DecoderLM

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 128)])
def test_flash_kernel_matches_plain(cuda, b, hq, hkv, sq, sk, d, dtype, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(sq * sk + d)
    q = _randn(gen, (b, hq, sq, d), dtype)
    k = _randn(gen, (b, hkv, sk, d), dtype)
    v = _randn(gen, (b, hkv, sk, d), dtype)
    kw = dict(causal=causal, window=window, q_offset=sk - sq)
    n = fa.launches
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == n + 1 and out.dtype == dtype
    want = ref.mha_reference(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=1e-2)


@pytest.mark.parametrize("b,hq,hkv,s,d,lengths", [
    (2, 4, 2, 1024, 64, (512, 1000)),
    (1, 8, 8, 300, 128, (300,)),
    (4, 24, 8, 2048, 128, (1025, 1056, 1, 2048)),
    (2, 16, 1, 700, 32, (257, 700)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda, b, hq, hkv, s, d, lengths, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = _randn(gen, (b, hq, d), dtype)
    k = _randn(gen, (b, hkv, s, d), dtype)
    v = _randn(gen, (b, hkv, s, d), dtype)
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n = da.launches
    out = da.decode_attention(q, k, v, length=length)
    assert da.launches == n + 1 and out.dtype == dtype
    want = ref.decode_attention_reference(q, k, v, length=length)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=1e-2)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 256, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 8, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 64, device=cuda)
    kv = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, kv, kv, length=torch.ones(1, dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen1.5-0.5b"])
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
