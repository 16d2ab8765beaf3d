"""The port's linear-scan kernels' plain versions and dispatch, held against
the JAX package's oracles and its Pallas kernels (interpret mode).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py.
Tolerances are those of tests/test_kernels.py:79-80,93-94 (fp32: 5e-4
absolute, 1e-3 relative) and :19-20 (bf16: 2e-2, 1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru
from repro_torch.kernels import mamba_scan as tmamba
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels import rglru_scan as trglru

F32 = dict(atol=5e-4, rtol=1e-3)
BF16 = dict(atol=2e-2, rtol=1e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


def _mamba_inputs(seed, B, S, Din, N):
    """x, delta, A, Bm, Cm, D, h0 as numpy float32, the distributions of
    tests/test_kernels.py:test_mamba_scan_sweep."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (n(B, S, Din), _softplus(n(B, S, Din)), -np.exp(n(Din, N) * 0.5).astype(np.float32),
            n(B, S, N), n(B, S, N), n(Din), n(B, Din, N))


def _rglru_inputs(seed, B, S, D):
    """x, r, i, log_a, h0 as in tests/test_kernels.py:test_rglru_scan_sweep."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (n(B, S, D), _sigmoid(n(B, S, D)), _sigmoid(n(B, S, D)),
            (-np.exp(n(D) * 0.3) * 0.1).astype(np.float32), n(B, D))


def _t(arrs, dtype=torch.float32, keep_f32=()):
    return [None if a is None else
            torch.from_numpy(a).to(torch.float32 if i in keep_f32 else dtype)
            for i, a in enumerate(arrs)]


def _j(arrs, dtype=jnp.float32, keep_f32=()):
    return [None if a is None else
            jnp.asarray(a, dtype=jnp.float32 if i in keep_f32 else dtype)
            for i, a in enumerate(arrs)]


# shapes of tests/test_kernels.py:67 (S 200 is not a multiple of the chunk)
@pytest.mark.parametrize("B,S,Din,N,chunk", [(2, 512, 256, 16, 128), (1, 200, 128, 8, 64)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_plain_mamba_matches_jax_oracle_and_pallas_interpret(B, S, Din, N, chunk, with_h0):
    arrs = list(_mamba_inputs(S + Din, B, S, Din, N))
    if not with_h0:
        arrs[6] = None
    y, hT = TR.mamba_scan_reference(*_t(arrs))
    assert y.dtype == torch.float32 and hT.dtype == torch.float32
    assert tuple(y.shape) == (B, S, Din) and tuple(hT.shape) == (B, Din, N)
    jy, jh = JR.mamba_scan_reference(*_j(arrs))
    np.testing.assert_allclose(_np(y), _np(jy), **F32)
    np.testing.assert_allclose(_np(hT), _np(jh), **F32)
    py, ph = pallas_mamba(*_j(arrs), chunk=chunk, block_d=128, interpret=True)
    np.testing.assert_allclose(_np(y), _np(py), **F32)
    np.testing.assert_allclose(_np(hT), _np(ph), **F32)


# shapes of tests/test_kernels.py:83 (S 777 is not a multiple of the chunk)
@pytest.mark.parametrize("B,S,D,chunk,bd", [(2, 777, 512, 256, 256), (1, 64, 128, 64, 128)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_plain_rglru_matches_jax_oracle_and_pallas_interpret(B, S, D, chunk, bd, with_h0):
    arrs = list(_rglru_inputs(S + D, B, S, D))
    if not with_h0:
        arrs[4] = None
    y, hT = TR.rglru_reference(*_t(arrs))
    assert y.dtype == torch.float32 and tuple(hT.shape) == (B, D)
    jy, jh = JR.rglru_reference(*_j(arrs))
    np.testing.assert_allclose(_np(y), _np(jy), **F32)
    np.testing.assert_allclose(_np(hT), _np(jh), **F32)
    py, ph = pallas_rglru(*_j(arrs), chunk=chunk, block_d=bd, interpret=True)
    np.testing.assert_allclose(_np(y), _np(py), **F32)
    np.testing.assert_allclose(_np(hT), _np(ph), **F32)


def test_plain_scans_in_bf16_match_jax_oracles():
    """bf16 operands as the models pass them: x/Bm/Cm (mamba) and x/r/i
    (rglru) in bf16, delta, A, D, log_a and h0 in fp32."""
    arrs = _mamba_inputs(5, 2, 96, 64, 16)
    keep = (1, 2, 5, 6)
    y, hT = TR.mamba_scan_reference(*_t(arrs, torch.bfloat16, keep))
    jy, jh = JR.mamba_scan_reference(*_j(arrs, jnp.bfloat16, keep))
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), **BF16)
    np.testing.assert_allclose(_np(hT), _np(jh), **F32)
    arrs = _rglru_inputs(6, 2, 96, 128)
    keep = (3, 4)
    y, hT = TR.rglru_reference(*_t(arrs, torch.bfloat16, keep))
    jy, jh = JR.rglru_reference(*_j(arrs, jnp.bfloat16, keep))
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), **BF16)
    np.testing.assert_allclose(_np(hT), _np(jh), **F32)


def _close_to_scale(got, want):
    """|got - want| <= 2e-2 + 1e-2 * max|want|: a carry rounded to bf16 at
    every step (the port) and one rounded along JAX's chunked associative
    scan differ by a few bf16 ulps of the largest state, and y = C . h can
    cancel to near zero on top of that."""
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= BF16["atol"] + BF16["rtol"] * np.abs(want).max()


def test_scan_dtype_rounds_the_recurrence_as_jax_does():
    arrs = _mamba_inputs(7, 1, 48, 32, 8)[:6]
    y, hT = TR.mamba_scan_reference(*_t(arrs), scan_dtype=torch.bfloat16)
    jy, jh = JR.mamba_scan_reference(*_j(arrs), scan_dtype=jnp.bfloat16)
    _close_to_scale(y, jy)
    _close_to_scale(hT, jh)
    exact, _ = TR.mamba_scan_reference(*_t(arrs))
    assert float((exact - y).abs().max()) > 0  # the rounding does act
    arrs = _rglru_inputs(8, 1, 48, 64)[:4]
    y, hT = TR.rglru_reference(*_t(arrs), scan_dtype=torch.bfloat16)
    jy, jh = JR.rglru_reference(*_j(arrs), scan_dtype=jnp.bfloat16)
    _close_to_scale(y, jy)
    _close_to_scale(hT, jh)


def test_linear_scan_matches_jax_chunked_scan():
    rng = np.random.default_rng(9)
    a = rng.uniform(0.5, 1.0, (2, 300, 3, 5)).astype(np.float32)
    b = rng.standard_normal((2, 300, 3, 5)).astype(np.float32)
    h0 = rng.standard_normal((2, 3, 5)).astype(np.float32)
    states, hT = TR.linear_scan_reference(*_t([a, b, h0]))
    jstates, jh = JR.linear_scan_reference(*_j([a, b, h0]), chunk=64)
    np.testing.assert_allclose(_np(states), _np(jstates), **F32)
    np.testing.assert_allclose(_np(hT), _np(jh), **F32)


def test_scan_ops_dispatch_and_cpu_wrappers():
    m = _t(_mamba_inputs(10, 1, 20, 32, 4))
    r = _t(_rglru_inputs(11, 1, 20, 32))
    m0, r0 = tmamba.launches, trglru.launches
    want_m = TR.mamba_scan_reference(*m)
    want_r = TR.rglru_reference(*r)
    for impl in ("auto", "torch"):
        torch.testing.assert_close(ops.mamba_scan(*m, impl=impl), want_m)
        torch.testing.assert_close(ops.rglru_scan(*r, impl=impl), want_r)
    torch.testing.assert_close(tmamba.mamba_scan(*m), (*want_m, None))
    torch.testing.assert_close(trglru.rglru_scan(*r), (*want_r, None))
    with pytest.raises(ValueError, match="cuda"):
        ops.mamba_scan(*m, impl="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ops.rglru_scan(*r, impl="cuda")
    with pytest.raises(ValueError):
        ops.rglru_scan(*r, impl="pallas")
    assert (tmamba.launches, trglru.launches) == (m0, r0)  # the plain path counts nothing
