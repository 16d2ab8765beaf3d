"""Head dims 112 (kimi-k2) and 160 (stablelm-12b): the attention kernels'
plain versions against the JAX package's oracles and its Pallas kernels
(interpret mode), and a stablelm-12b smoke model at head_dim 160 against the
JAX package's DecoderLM.

The CUDA kernels at these dims run only on the card (tests/test_torch_cuda.py);
their bf16 rounding points are held here by the emulations of
tests/test_torch_flash_sm90.py and tests/test_torch_decode_mamba_sm90.py.
Tolerances are those of tests/test_kernels.py:19-20: fp32 2e-5; bf16 2e-2
with rtol 1e-2.  Shapes stay small (S <= 128, few heads) so interpret mode is
cheap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.kernels import ref as JR
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import DecoderLM as JDecoderLM
from repro.statestore.checkpoint import flatten_named as j_flatten_named
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import flash_attention_bwd as tbwd
from repro_torch.kernels import ref as TR
from repro_torch.models import DecoderLM
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import flatten_named

DIMS = (112, 160)
TOL = {"float32": dict(atol=2e-5, rtol=1e-2), "bfloat16": dict(atol=2e-2, rtol=1e-2)}


def _inputs(seed, dtype, *shapes):
    """The same values for both frameworks: numpy float32, rounded to bf16
    by each framework (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 40)])
def test_plain_flash_matches_jax_oracle(d, dtype, causal, window):
    b, hq, hkv, sq, sk = 2, 4, 1, 96, 128  # MQA, Sk > Sq (q_offset 32)
    (jq, jk, jv), (q, k, v) = _inputs(d + sq, dtype, (b, hq, sq, d), (b, hkv, sk, d),
                                      (b, hkv, sk, d))
    kw = dict(causal=causal, window=window, q_offset=sk - sq)
    want = _np(JR.mha_reference(jq, jk, jv, **kw))
    for got in (TR.mha_reference(q, k, v, **kw),
                TR.flash_attention_reference(q, k, v, block_k=32, **kw),
                tflash.flash_attention(q, k, v, **kw)):  # a CPU tensor takes the plain version
        assert got.dtype == q.dtype and got.shape == q.shape
        np.testing.assert_allclose(_np(got), want, **TOL[dtype])


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("window", [None, 48])
def test_plain_flash_matches_pallas_interpret(d, window):
    b, hq, hkv, sq, sk = 1, 4, 2, 64, 128
    (jq, jk, jv), (q, k, v) = _inputs(d + 1, "float32", (b, hq, sq, d), (b, hkv, sk, d),
                                      (b, hkv, sk, d))
    kw = dict(causal=True, window=window, q_offset=sk - sq)
    want = _np(pallas_flash(jq, jk, jv, interpret=True, block_q=64, block_k=64, **kw))
    got = _np(TR.flash_attention_reference(q, k, v, block_k=64, **kw))
    np.testing.assert_allclose(got, want, **TOL["float32"])


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 24)])
def test_plain_backward_matches_jax_vjp(d, causal, window):
    """dq, dk, dv of the plain backward (the CUDA kernels' plain version),
    from the plain forward's output and log-sum-exp, against jax.vjp of the
    JAX oracle, in fp32: within 2e-5 of each gradient's largest entry."""
    b, hq, hkv, sq, sk = 1, 4, 2, 70, 90
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(d + 2, "float32", (b, hq, sq, d),
                                               (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d))
    kw = dict(causal=causal, window=window, q_offset=sk - sq)
    jo, vjp = jax.vjp(lambda a, b_, c: JR.mha_reference(a, b_, c, **kw), jq, jk, jv)
    out, lse = TR.flash_attention_reference(q, k, v, block_k=32, return_lse=True, **kw)
    np.testing.assert_allclose(_np(out), _np(jo), **TOL["float32"])
    got = tbwd.flash_attention_backward(q, k, v, out, lse, do, **kw)  # CPU: the plain version
    for g, w in zip(got, vjp(jdo)):
        w = _np(w)
        assert g.shape == w.shape
        assert np.abs(_np(g) - w).max() <= 2e-5 * np.abs(w).max()


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_matches_jax_oracle_and_pallas_interpret(d, dtype):
    b, hq, hkv, s = 3, 8, 2, 128
    lengths = np.array([128, 77, 1], np.int32)
    (jq, jk, jv), (q, k, v) = _inputs(d + 3, dtype, (b, hq, d), (b, hkv, s, d), (b, hkv, s, d))
    jlen = jnp.asarray(lengths)
    tlen = torch.from_numpy(lengths)
    got = _np(tdecode.decode_attention(q, k, v, length=tlen))  # CPU: the plain version
    np.testing.assert_allclose(got, _np(JR.decode_attention_reference(jq, jk, jv, length=jlen)),
                               **TOL[dtype])
    pallas = _np(pallas_decode(jq, jk, jv, length=jlen, interpret=True, block_k=64))
    np.testing.assert_allclose(got, pallas, **TOL[dtype])


def test_stablelm_smoke_at_head_dim_160_matches_jax_f32():
    """A stablelm-12b smoke config at its published head_dim (the smoke
    reduction sets 32): forward logits, the prefill cache and three decode
    steps against the JAX package's DecoderLM on carried weights."""
    jm = JDecoderLM(j_get_smoke_config("stablelm-12b", dtype="float32", head_dim=160))
    jp = jm.init(jax.random.PRNGKey(1))
    model = DecoderLM(get_smoke_config("stablelm-12b", dtype="float32", head_dim=160))
    params = params_from_numpy({n: np.asarray(a) for n, a in j_flatten_named(jp)}, model, "cpu")
    assert params["blocks"][0]["l0"]["mixer"]["wq"].shape[-1] == 160
    toks = np.random.default_rng(2).integers(0, 512, (2, 16)).astype(np.int32)
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        _close_to_scale(model.forward(params, {"tokens": tt}),
                        jm.forward(jp, {"tokens": jnp.asarray(toks)}))
        logits, cache = model.prefill(params, {"tokens": tt[:, :12]})
        jlogits, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :12])})
        _close_to_scale(logits, jlogits)
        for t in range(12, 15):
            logits, cache = model.decode_step(params, cache, tt[:, t])
            jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t]))
            _close_to_scale(logits, jlogits)
        ours = dict(flatten_named(cache["groups"]))
        for name, jarr in j_flatten_named(jcache["groups"]):
            assert ours[name].shape[-1] == 160
            _close_to_scale(ours[name], jarr)


def _close_to_scale(got, want):
    """|got - want| <= 1e-4 + 1e-4 * max|want|: tests/test_torch_models.py's
    bound for its caches and for recurrentgemma-9b's logits.  At head_dim 160
    the JAX fan-in rule (wq scaled by 1/sqrt(heads), wk by 1/sqrt(kv heads))
    puts the smoke model's first-layer attention logits at a std of ~46 (max
    ~180), so a few ulps of q and k move an output logit by ~1e-4 (measured:
    1.1e-4 at 2 of 16384 output logits, whose largest is ~4.3)."""
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= 1e-4 + 1e-4 * np.abs(want).max()
