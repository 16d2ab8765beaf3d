"""The plan of ``topk_compress`` redesigned for the H100, checked on the CPU
where the kernel itself cannot run: ``select_plan`` (here) builds each
block's result from what the kernel keeps of it (tau from the lane maxes of
the kernel's layout, the entries above tau, the lowest-index ties at tau),
and must give the plain version's bits (``ref.topk_compress_reference``) and
the Pallas kernel's in interpret mode.  The warp sort networks of
``csrc/topk_compress.cu`` are emulated lane by lane.

Tolerance: none.  Values, indices and residual are compared bit for bit;
against the Pallas kernel a kept -0.0 is compared as +0.0, the sign that
kernel returns (ROADMAP's divergences), and the subnormal case is left out:
XLA on the CPU flushes subnormal magnitudes to zero, so the Pallas kernel in
interpret mode ranks them as zeros, where the port (both versions) ranks
them by value.  The card tests of the kernel are
``tests/test_torch_cuda.py::test_topk_kernel_equals_plain``, on the inputs
of ``tests/_topk_cases.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _topk_cases as cases
from repro.kernels.topk_compress import topk_compress as j_topk_compress
from repro_torch.kernels import ref as TR
from repro_torch.kernels import topk_compress as ttopk
from repro_torch.tree import to_numpy

DTYPES = ("float32", "bfloat16")


def select_plan(x, k, block=ttopk.BLOCK):
    """The kernel's selection in plain PyTorch: (vals, idx, residual) as
    ``topk_compress`` gives them, and ``fallback_blocks``.  A fallback block
    takes the plain version (the rounds compute the same function); every
    other block's result is built from what the kernel keeps of it alone:
    the entries above tau sorted by (|x| descending, index ascending), then
    the lowest-index entries equal to tau."""
    vals, idx, res = TR.topk_compress_reference(x, k, block=block)
    fallback = ttopk.fallback_blocks(x, k, block=block)
    if k > ttopk.FAST_K:
        return vals, idx, res, fallback
    n = x.shape[0]
    xb, mag, tau = ttopk._tau(x, k, block)
    pos = torch.arange(block, device=x.device)
    above = mag > tau
    n_above = above.sum(1, keepdim=True)
    # the candidates, by (|x| descending, index ascending); the others last
    key = torch.where(above, mag.long() * block + (block - 1 - pos), -1)
    cand = (block - 1) - key.sort(dim=1, descending=True).values[:, :k] % block
    # the entries equal to tau, in index order
    ties = torch.sort((mag != tau).to(torch.int8), dim=1, stable=True).indices[:, :k]
    i = torch.arange(k, device=x.device)[None, :]
    took = torch.where(i < n_above, cand, torch.gather(ties, 1, (i - n_above).clamp(min=0)))
    fast = ~fallback
    idx[fast] = took[fast].to(torch.int32)
    vals[fast] = torch.gather(xb.float(), 1, took)[fast]
    kept = xb.scatter(1, took, torch.zeros((), dtype=x.dtype, device=x.device)
                      .expand(took.shape))
    res = torch.where(fast[:, None], kept,
                      torch.nn.functional.pad(res, (0, (-n) % block)).view(xb.shape))
    return vals, idx, res.reshape(-1)[:n], fallback


def _inputs(case, dtype):
    x = cases.make(case, dtype)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))


def _bits(a):
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("k", cases.KS)
@pytest.mark.parametrize("case", sorted(cases.CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_equals_plain_version(dtype, case, k):
    x, _ = _inputs(case, dtype)
    got = select_plan(x, k)
    want = TR.topk_compress_reference(x, k)
    for g, w in zip(got[:3], want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("k", (10, 37))
@pytest.mark.parametrize("case", sorted(set(cases.CASES) - {"subnormals"}))
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_equals_pallas_kernel(dtype, case, k):
    x, jx = _inputs(case, dtype)
    vals, idx, res, _ = select_plan(x, k)
    jvals, jidx, jres = j_topk_compress(jx, k, interpret=True)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(_bits(res), _bits(jres))
    assert np.array_equal((vals + 0.0).numpy().view(np.uint32),  # -0.0 as +0.0
                          np.asarray(jvals, np.float32).view(np.uint32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_fallback_takes_what_the_buffer_cannot_hold(dtype):
    """Which blocks take the rounds: none of the random deltas at k = 10;
    both blocks with 96 large entries in three lanes; every block for
    k > FAST_K.  A block of few nonzeros fills from the zeros on the fast
    path."""
    x, _ = _inputs("random", dtype)
    assert not ttopk.fallback_blocks(x, 10).any()
    assert ttopk.fallback_blocks(x, ttopk.FAST_K + 1).all()
    x, _ = _inputs("three_lanes", dtype)
    assert ttopk.fallback_blocks(x, 10).all()
    x, _ = _inputs("one_lane", dtype)
    assert not ttopk.fallback_blocks(x, 10).any()
    x, _ = _inputs("two_lanes", dtype)  # a full buffer: the sort of 64 keys
    for k in (10, 20, 32):
        _, mag, tau = ttopk._tau(x, k, ttopk.BLOCK)
        assert (mag > tau).sum(1).tolist() == [64, 40]
        assert not ttopk.fallback_blocks(x, k).any()
    x, _ = _inputs("few_nonzeros", dtype)
    assert not ttopk.fallback_blocks(x, 10).any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_paths_on_the_cpu_are_the_plain_model(dtype):
    """``topk_compress(..., paths=True)`` on a CPU tensor: the plain version
    and ``fallback_blocks``, the decision the card's kernel records."""
    for case, k in (("three_lanes", 10), ("two_lanes", 10), ("random", 37)):
        x, _ = _inputs(case, dtype)
        *got, path = ttopk.topk_compress(x, k, paths=True)
        for g, w in zip(got, TR.topk_compress_reference(x, k)):
            assert np.array_equal(_bits(g), _bits(w))
        assert torch.equal(path, ttopk.fallback_blocks(x, k))


def test_tau_bounds_the_kept_magnitudes_from_below():
    """At least k entries of every block reach tau, so the k kept ones do."""
    for case in cases.CASES:
        for dtype in DTYPES:
            x, _ = _inputs(case, dtype)
            for k in (1, 10, 31, 32):
                _, mag, tau = ttopk._tau(x, k, ttopk.BLOCK)
                assert ((mag >= tau).sum(1) >= k).all()
                vals = TR.topk_compress_reference(x, k)[0]
                kept = (vals.view(torch.int32) & 0x7FFFFFFF)
                assert (kept >= tau).all()


def _sort32(keys):
    """sort32_desc of the kernel: keys[lane], one a lane, shuffles by xor."""
    keys = np.array(keys, dtype=object)
    lane = np.arange(32)
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            other = keys[lane ^ stride]
            take_max = ((lane & stride) == 0) == ((lane & size) == 0)
            keys = np.where(take_max, np.maximum(keys, other), np.minimum(keys, other))
            stride //= 2
        size *= 2
    return list(keys)


def _sort64(k0, k1):
    """sort64_desc of the kernel: indices lane (k0) and lane + 32 (k1)."""
    k0, k1 = np.array(k0, dtype=object), np.array(k1, dtype=object)
    lane = np.arange(32)
    size = 2
    while size <= 64:
        stride = size // 2
        while stride:
            if stride == 32:
                k0, k1 = np.maximum(k0, k1), np.minimum(k0, k1)
            else:
                o0, o1 = k0[lane ^ stride], k1[lane ^ stride]
                lower = (lane & stride) == 0
                max0 = lower == ((lane & size) == 0)
                max1 = lower == (((lane + 32) & size) == 0)
                k0 = np.where(max0, np.maximum(k0, o0), np.minimum(k0, o0))
                k1 = np.where(max1, np.maximum(k1, o1), np.minimum(k1, o1))
            stride //= 2
        size *= 2
    return list(k0) + list(k1)


@pytest.mark.parametrize("seed", range(8))
def test_warp_sort_networks_sort_descending(seed):
    rng = np.random.default_rng(seed)
    for hi in (4, 1 << 40):  # many ties, and 64-bit keys of (magnitude, position)
        keys = [int(v) for v in rng.integers(0, hi, 64)]
        assert _sort32(keys[:32]) == sorted(keys[:32], reverse=True)
        assert _sort64(keys[:32], keys[32:]) == sorted(keys, reverse=True)
