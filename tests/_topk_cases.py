"""Inputs of the top-k cases shared by tests/test_torch_topk_plan.py (the CPU,
against JAX) and tests/test_torch_cuda.py (the card): numpy float32 arrays
made from a seed, each aimed at one part of the kernel's selection
(``repro_torch/kernels/csrc/topk_compress.cu``).  ``lanes`` place values by
the kernel's layout, where lane ``(p // vec) % 32`` holds element p of a
1024-element block and ``vec`` is 4 for fp32, 8 for bf16."""

import numpy as np

BLOCK = 1024
KS = (1, 10, 20, 32, 37, 64, 65, 1024)


def _lane_of(vec):
    return (np.arange(BLOCK) // vec) % 32


def random(rng, vec):
    """Normal deltas over four whole blocks and a ragged tail."""
    return rng.standard_normal(4 * BLOCK + 904).astype(np.float32) * 1e-3


def all_zero(rng, vec):
    return np.zeros(3 * BLOCK, np.float32)


def few_nonzeros(rng, vec):
    """Blocks with 0, 1, 3, 9, 20 and 40 nonzeros: fewer than k fills with
    the lowest-index zeros (tau = 0)."""
    x = np.zeros(6 * BLOCK, np.float32)
    for b, r in enumerate((0, 1, 3, 9, 20, 40)):
        at = rng.choice(BLOCK, r, replace=False)
        x[b * BLOCK + at] = rng.standard_normal(r) * 1e-2
    return x


def ties_at_tau(rng, vec):
    """Most magnitudes 1.0 of both signs, a few 2.0 above and the rest
    smaller: tau lands on a run of ties."""
    x = rng.choice(np.array([1.0, -1.0, 0.5, 0.25], np.float32), 3 * BLOCK)
    x[rng.choice(3 * BLOCK, 12, replace=False)] = 2.0
    x[5:9] = -2.0
    return x


def one_lane(rng, vec):
    """Every large value in one lane of each block (32 of them): one lane
    above tau, up to 32 candidates."""
    x = rng.standard_normal(2 * BLOCK).astype(np.float32) * 1e-3
    big = np.tile(_lane_of(vec) == 5, 2)
    x[big] = rng.standard_normal(big.sum()) + 10.0
    return x


def two_lanes(rng, vec):
    """Large values, rounded so that many tie, in two whole lanes of the
    first block (64 entries above tau: the whole candidate buffer) and in one
    lane and 8 slots of another in the second (40), the rest zero: for
    2 <= k <= 32 the fast path sorts them 64 keys at a time."""
    x = np.zeros(2 * BLOCK, np.float32)
    lane = np.tile(_lane_of(vec), 2)
    first = np.arange(2 * BLOCK) < BLOCK
    big = first & np.isin(lane, (3, 20))
    big[~first & (lane == 9)] = True
    big[np.flatnonzero(~first & (lane == 26))[:8]] = True
    signs = np.where(rng.random(big.sum()) < 0.5, -1.0, 1.0)
    x[big] = np.round(rng.standard_normal(big.sum()) + 10.0, 1) * signs
    return x


def three_lanes(rng, vec):
    """Large values in three lanes: 96 entries above tau for k <= 28, more
    than the candidate buffer holds, so the block takes the rounds."""
    x = rng.standard_normal(2 * BLOCK).astype(np.float32) * 1e-3
    big = np.tile(np.isin(_lane_of(vec), (2, 17, 30)), 2)
    x[big] = rng.standard_normal(big.sum()) + 10.0
    return x


def infinities(rng, vec):
    x = rng.standard_normal(3 * BLOCK).astype(np.float32)
    x[rng.choice(3 * BLOCK, 9, replace=False)] = np.inf
    x[rng.choice(3 * BLOCK, 9, replace=False)] = -np.inf
    return x


def signed_zeros(rng, vec):
    """+0.0 and -0.0 mixed with a few nonzeros: the kept -0.0 stays -0.0 in
    vals, and becomes +0.0 in the residual."""
    x = np.where(rng.random(3 * BLOCK) < 0.5, np.float32(-0.0), np.float32(0.0))
    x[rng.choice(3 * BLOCK, 7, replace=False)] = 1.5
    return x.astype(np.float32)


def subnormals(rng, vec):
    """Subnormal magnitudes (fp32 and bf16 alike) among zeros and ties."""
    x = np.zeros(2 * BLOCK, np.float32)
    at = rng.choice(2 * BLOCK, 300, replace=False)
    x[at] = rng.choice(np.array([1e-40, -1e-40, 3e-39, 5e-45], np.float32), 300)
    return x


def ragged_tail(rng, vec):
    """Three blocks and 17 elements: the last block zero-padded."""
    return rng.standard_normal(3 * BLOCK + 17).astype(np.float32)


CASES = {f.__name__: f for f in (random, all_zero, few_nonzeros, ties_at_tau, one_lane,
                                 two_lanes, three_lanes, infinities, signed_zeros, subnormals,
                                 ragged_tail)}


def make(case, dtype_name, seed=0):
    """The case's input as float32 numpy, for x of `dtype_name`."""
    vec = 8 if dtype_name == "bfloat16" else 4
    return CASES[case](np.random.default_rng(seed), vec)
