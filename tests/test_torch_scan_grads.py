"""The scans' gradients: the plain reverse-scan references (the formulas the
CUDA backward kernels compute) against torch's autograd of the plain
forwards and against ``jax.vjp`` of the JAX package's XLA references, the
autograd Functions by float64 gradcheck, and the routing of ``ops`` under a
gradient.  The kernels themselves run only on the card:
tests/test_torch_cuda.py.

Tolerance: each gradient within 5e-4 of its largest entry plus 1e-3 of
itself (the scans' fp32 tolerance of tests/test_kernels.py:79-80, taken
relative to the gradient's scale, since dA and dlog_a sum over every row
and step).  Decays near 0 underflow inside a checkpoint chunk; decays near 1
carry the gradient over the whole sequence; RG-LRU's clamp of 1 - a^2 at
1e-12 holds exactly where log_a is ~1e-9 (fp32 exp(2 l) == 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro_torch.kernels import mamba_scan as tmamba
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels import rglru_scan as trglru

ATOL, RTOL = 5e-4, 1e-3


def _close(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.all(np.abs(got - want) <= ATOL * scale + RTOL * np.abs(want))


def _mamba_inputs(seed, B, S, Din, N, decay):
    """x, delta, A, Bm, Cm, D, h0, dy, dhT as numpy float32: decays exp(delta
    A) near 0 ("fast": delta ~ 6, A ~ -3), near 1 ("slow": delta ~ 1e-3) or
    spread as in tests/test_kernels.py ("mixed")."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    delta = np.logaddexp(n(B, S, Din), 0.0).astype(np.float32)
    A = -np.exp(n(Din, N) * 0.5).astype(np.float32)
    if decay == "fast":
        delta, A = delta + 5.0, A - 2.0
    elif decay == "slow":
        delta, A = delta * 1e-3, A * 0.1
    return (n(B, S, Din), delta, A, n(B, S, N), n(B, S, N), n(Din), n(B, Din, N),
            n(B, S, Din), n(B, Din, N))


def _rglru_inputs(seed, B, S, D, decay):
    """x, r, i, log_a, h0, dy, dhT as numpy float32: log_a near -5 ("fast":
    a_t = exp(8 r log_a) underflows), near -1e-3 ("slow"), or as in
    tests/test_kernels.py with every third channel at -1e-9 ("mixed": the
    clamp holds there)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sig = lambda z: (1.0 / (1.0 + np.exp(-z))).astype(np.float32)  # noqa: E731
    log_a = (-np.exp(n(D) * 0.3) * 0.1).astype(np.float32)
    if decay == "fast":
        log_a = log_a * 50.0
    elif decay == "slow":
        log_a = log_a * 1e-2
    else:
        log_a[::3] = -1e-9
    return (n(B, S, D), sig(n(B, S, D)), sig(n(B, S, D)), log_a, n(B, D), n(B, S, D), n(B, D))


def _jax_vjp(fn, args, cotangents):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return vjp(tuple(jnp.asarray(c) for c in cotangents))


def _autograd(fn, args, cotangents):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = fn(*leaves)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cotangents])
    return [t.grad for t in leaves]


# S off the 32-step checkpoint chunk (45) and on two of them (64)
@pytest.mark.parametrize("S", [45, 64])
@pytest.mark.parametrize("decay", ["mixed", "fast", "slow"])
@pytest.mark.parametrize("with_h0", [True, False])
def test_mamba_backward_reference_matches_autograd_and_jax_vjp(S, decay, with_h0):
    x, delta, A, Bm, Cm, D, h0, dy, dhT = _mamba_inputs(S + len(decay), 2, S, 6, 8, decay)
    if not with_h0:
        h0, dhT = None, np.zeros_like(dhT)
    inputs = [x, delta, A, Bm, Cm, D] + ([h0] if with_h0 else [])
    got = TR.mamba_scan_backward_reference(
        *(torch.from_numpy(a) for a in (x, delta, A, Bm, Cm, D)),
        None if h0 is None else torch.from_numpy(h0), torch.from_numpy(dy),
        torch.from_numpy(dhT) if with_h0 else None, chunk=tmamba.CHUNK)
    got = list(got[:6]) + ([got[6]] if with_h0 else [])

    def jfn(*a):
        return JR.mamba_scan_reference(*a[:6], a[6] if with_h0 else None)

    def tfn(*a):
        return TR.mamba_scan_reference(*a[:6], a[6] if with_h0 else None)

    for want in (_jax_vjp(jfn, inputs, (dy, dhT)), _autograd(tfn, inputs, (dy, dhT))):
        assert len(want) == len(got)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("S", [45, 64])
@pytest.mark.parametrize("decay", ["mixed", "fast", "slow"])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_backward_reference_matches_autograd_and_jax_vjp(S, decay, with_h0):
    x, r, i, log_a, h0, dy, dhT = _rglru_inputs(S + len(decay), 2, S, 12, decay)
    if not with_h0:
        h0, dhT = None, np.zeros_like(dhT)
    inputs = [x, r, i, log_a] + ([h0] if with_h0 else [])
    got = TR.rglru_backward_reference(
        *(torch.from_numpy(a) for a in (x, r, i, log_a)),
        None if h0 is None else torch.from_numpy(h0), torch.from_numpy(dy),
        torch.from_numpy(dhT) if with_h0 else None)
    got = list(got[:4]) + ([got[4]] if with_h0 else [])

    def jfn(*a):
        return JR.rglru_reference(*a[:4], a[4] if with_h0 else None)

    def tfn(*a):
        return TR.rglru_reference(*a[:4], a[4] if with_h0 else None)

    for want in (_jax_vjp(jfn, inputs, (dy, dhT)), _autograd(tfn, inputs, (dy, dhT))):
        assert len(want) == len(got)
        for g, w in zip(got, want):
            _close(g, w)


def test_rglru_clamp_has_zero_derivative():
    """Where 1 - a^2 is clamped to 1e-12, the square root adds nothing to
    dlog_a: JAX's derivative of max, not torch's of sqrt at the clamp."""
    x, r, i, log_a, h0, dy, dhT = _rglru_inputs(5, 1, 20, 6, "mixed")
    log_a[:] = -1e-9
    t = [torch.from_numpy(a) for a in (x, r, i, log_a)]
    _, _, _, dla, _ = TR.rglru_backward_reference(*t, None, torch.from_numpy(dy))
    want = _jax_vjp(lambda *a: JR.rglru_reference(*a), (x, r, i, log_a),
                    (dy, np.zeros((1, 6), np.float32)))[3]
    assert np.all(np.isfinite(np.asarray(want))) and np.abs(np.asarray(want)).max() < 1e3
    _close(dla, want)


def _f64(gen, *shape):
    return torch.randn(shape, generator=gen, dtype=torch.float64)


@pytest.mark.parametrize("S", [5, 37])
def test_mamba_scan_function_gradcheck(S):
    """MambaScan's plain route: its backward (the reverse-scan reference)
    against finite differences of its forward, in float64."""
    gen = torch.Generator().manual_seed(S)
    x, dt = _f64(gen, 1, S, 3), torch.nn.functional.softplus(_f64(gen, 1, S, 3))
    A = -torch.exp(_f64(gen, 3, 2) * 0.5)
    ins = [t.requires_grad_(True) for t in (x, dt, A, _f64(gen, 1, S, 2), _f64(gen, 1, S, 2),
                                            _f64(gen, 3), _f64(gen, 1, 3, 2))]
    assert torch.autograd.gradcheck(lambda *a: tmamba.MambaScan.apply(*a, False), ins)


@pytest.mark.parametrize("S", [5, 37])
def test_rglru_scan_function_gradcheck(S):
    gen = torch.Generator().manual_seed(S)
    r, i = torch.sigmoid(_f64(gen, 1, S, 4)), torch.sigmoid(_f64(gen, 1, S, 4))
    log_a = -torch.exp(_f64(gen, 4) * 0.3) * 0.1
    ins = [t.requires_grad_(True) for t in (_f64(gen, 1, S, 4), r, i, log_a, _f64(gen, 1, 4))]
    assert torch.autograd.gradcheck(lambda *a: trglru.RGLRUScan.apply(*a, 8.0, False), ins)


def test_ops_scans_under_grad_take_the_autograd_functions():
    """Under a gradient, ops routes the scans through the Functions (a
    grad_fn of theirs, no kernel launch on the CPU); without one, or with
    scan_dtype on the plain route, through the plain forward."""
    x, delta, A, Bm, Cm, D, h0, _, _ = (torch.from_numpy(a) for a in
                                        _mamba_inputs(1, 1, 10, 4, 8, "mixed"))
    xr, r, i, log_a, h0r, _, _ = (torch.from_numpy(a) for a in _rglru_inputs(1, 1, 10, 4, "mixed"))
    n = (tmamba.launches, tmamba.bwd_launches, trglru.launches, trglru.bwd_launches)
    y, hT = ops.mamba_scan(x.requires_grad_(True), delta, A, Bm, Cm, D)
    assert type(y.grad_fn).__name__ == "MambaScanBackward" and hT.grad_fn is y.grad_fn
    y.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    y, _ = ops.rglru_scan(xr, r.requires_grad_(True), i, log_a)
    assert type(y.grad_fn).__name__ == "RGLRUScanBackward"
    y.sum().backward()
    assert r.grad is not None and bool(torch.isfinite(r.grad).all())
    y, _ = ops.rglru_scan(xr, r, i, log_a, scan_dtype=torch.bfloat16)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ != "RGLRUScanBackward"
    with torch.no_grad():
        assert ops.mamba_scan(x, delta, A, Bm, Cm, D)[0].grad_fn is None
    assert (tmamba.launches, tmamba.bwd_launches, trglru.launches, trglru.bwd_launches) == n


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the kernel wrappers, forward with checkpoints and
    backward, are the plain versions (no checkpoints: the plain backward
    recomputes the states from h0)."""
    x, delta, A, Bm, Cm, D, h0, dy, dhT = (torch.from_numpy(a) for a in
                                           _mamba_inputs(2, 1, 40, 4, 8, "mixed"))
    y, hT, ckpt = tmamba.mamba_scan(x, delta, A, Bm, Cm, D, h0, checkpoints=True)
    assert ckpt is None
    want = TR.mamba_scan_reference(x, delta, A, Bm, Cm, D, h0)
    assert torch.equal(y, want[0]) and torch.equal(hT, want[1])
    got = tmamba.mamba_scan_backward(x, delta, A, Bm, Cm, D, h0, dy, dhT)
    for g, w in zip(got, TR.mamba_scan_backward_reference(x, delta, A, Bm, Cm, D, h0, dy, dhT)):
        assert torch.equal(g, w)
    x, r, i, log_a, h0, dy, dhT = (torch.from_numpy(a) for a in _rglru_inputs(2, 1, 40, 4, "slow"))
    assert trglru.rglru_scan(x, r, i, log_a, h0, checkpoints=True)[2] is None
    got = trglru.rglru_scan_backward(x, r, i, log_a, h0, dy, dhT)
    for g, w in zip(got, TR.rglru_backward_reference(x, r, i, log_a, h0, dy, dhT)):
        assert torch.equal(g, w)
