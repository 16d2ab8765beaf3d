"""The port's attention kernels' plain versions and dispatch, held against
the JAX package's oracles and its Pallas kernels (interpret mode).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref as TR


def _tol(dtype):  # tests/test_kernels.py:19-20
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(seed, dtype, *shapes):
    """The same values for both frameworks: numpy float32, rounded to bf16
    by each framework (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, th


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# shapes of tests/test_kernels.py:23-28: GQA, MQA with Sk > Sq, MHA ragged
FLASH_CASES = [
    (2, 4, 2, 256, 256, 64),
    (1, 8, 1, 128, 384, 64),
    (2, 4, 4, 192, 192, 128),
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 128)])
def test_plain_flash_matches_jax_oracles(b, hq, hkv, sq, sk, d, dtype, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(sq + sk + d, dtype, (b, hq, sq, d), (b, hkv, sk, d),
                                      (b, hkv, sk, d))
    kw = dict(causal=causal, window=window, q_offset=sk - sq)
    want = _np(JR.mha_reference(jq, jk, jv, **kw))
    for got in (TR.mha_reference(q, k, v, **kw),
                TR.flash_attention_reference(q, k, v, block_k=128, **kw)):
        assert got.dtype == q.dtype
        np.testing.assert_allclose(_np(got), want, atol=_tol(dtype), rtol=1e-2)
    np.testing.assert_allclose(
        _np(TR.flash_attention_reference(q, k, v, block_k=128, **kw)),
        _np(JR.flash_attention_reference(jq, jk, jv, block_k=128, **kw)),
        atol=_tol(dtype), rtol=1e-2)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,window", [
    (1, 4, 2, 128, 200, 32, None),   # ragged Sk, q_offset = Sk - Sq
    (1, 6, 2, 128, 128, 64, 48),     # GQA group 3, local window
])
def test_plain_flash_matches_pallas_interpret(b, hq, hkv, sq, sk, d, window):
    (jq, jk, jv), (q, k, v) = _inputs(7, "float32", (b, hq, sq, d), (b, hkv, sk, d),
                                      (b, hkv, sk, d))
    kw = dict(causal=True, window=window, q_offset=sk - sq)
    want = _np(pallas_flash(jq, jk, jv, interpret=True, block_q=64, block_k=64, **kw))
    got = _np(TR.flash_attention_reference(q, k, v, block_k=64, **kw))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-2)


@pytest.mark.parametrize("b,hq,hkv,s,d", [(2, 4, 2, 1024, 64), (1, 8, 8, 300, 128),
                                          (2, 6, 2, 500, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_matches_jax_oracle(b, hq, hkv, s, d, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(s + d, dtype, (b, hq, d), (b, hkv, s, d), (b, hkv, s, d))
    lengths = np.array([s // 2 + 7 * i for i in range(b)], np.int32)
    want = _np(JR.decode_attention_reference(jq, jk, jv, length=jnp.asarray(lengths)))
    got = TR.decode_attention_reference(q, k, v, length=torch.from_numpy(lengths))
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), want, atol=_tol(dtype), rtol=1e-2)


def test_plain_decode_matches_pallas_interpret():
    (jq, jk, jv), (q, k, v) = _inputs(3, "float32", (2, 6, 64), (2, 2, 384, 64),
                                      (2, 2, 384, 64))
    lengths = np.array([100, 383], np.int32)
    want = _np(pallas_decode(jq, jk, jv, length=jnp.asarray(lengths), interpret=True,
                             block_k=128))
    got = _np(TR.decode_attention_reference(q, k, v, length=torch.from_numpy(lengths)))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-2)


def test_gqa_maps_query_head_to_kv_head_h_div_group():
    # one-hot values per KV head: the output reveals which KV head each
    # query head read (h // group, not h % hkv)
    b, hq, hkv, s, d = 1, 6, 2, 4, 32
    q = torch.zeros(b, hq, 1, d)
    k = torch.zeros(b, hkv, s, d)
    v = torch.stack([torch.full((s, d), float(j)) for j in range(hkv)])[None]
    out = TR.flash_attention_reference(q, k, v, causal=False)
    assert out[0, :, 0, 0].tolist() == [0, 0, 0, 1, 1, 1]
    dec = TR.decode_attention_reference(q[:, :, 0], k, v)
    assert dec[0, :, 0].tolist() == [0, 0, 0, 1, 1, 1]


def test_ops_dispatch_and_cpu_wrappers():
    _, (q, k, v) = _inputs(1, "float32", (1, 4, 16, 32), (1, 2, 16, 32), (1, 2, 16, 32))
    f0, d0 = tflash.launches, tdecode.launches
    want = TR.flash_attention_reference(q, k, v)
    for impl in ("auto", "torch"):
        torch.testing.assert_close(ops.flash_attention(q, k, v, impl=impl), want)
    torch.testing.assert_close(tflash.flash_attention(q, k, v), want)
    qd = q[:, :, 0].contiguous()
    torch.testing.assert_close(ops.decode_attention(qd, k, v),
                               TR.decode_attention_reference(qd, k, v))
    torch.testing.assert_close(tdecode.decode_attention(qd, k, v),
                               TR.decode_attention_reference(qd, k, v))
    with pytest.raises(ValueError, match="cuda"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ops.decode_attention(qd, k, v, impl="cuda")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, impl="pallas")
    assert (tflash.launches, tdecode.launches) == (f0, d0)  # the plain path counts nothing


def test_kernel_libraries_are_named_by_source_hash():
    for name in _build.SOURCES:
        path = _build.lib_path(name)
        assert path.parent == _build.BUILD_DIR
        assert (_build.CSRC / f"{name}.cu").exists()
        stem, digest, ext = path.name.split(".")
        assert (stem, ext, len(digest)) == (name, "so", 16)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
