"""The port's MoE FFN (repro_torch/models/moe.py) against the JAX package's.

Weights and inputs are made with numpy from a seed and handed to both
packages; everything runs in float32 on the CPU, where the two differ by
summation order only: atol 2e-4, rtol 1e-3, the bound tests/test_models.py
holds the JAX package's own dispatch forms to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import moe as jmoe
from repro.models.params import init_params as j_init_params
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe
from repro_torch.models.layers import rmsnorm

MOE_ARCHS = ("kimi-k2-1t-a32b", "grok-1-314b")
TOL = dict(atol=2e-4, rtol=1e-3)


def _cfgs(arch, **moe_over):
    cfg = get_smoke_config(arch, dtype="float32")
    jcfg = j_get_smoke_config(arch, dtype="float32")
    if moe_over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_over))
    return cfg, jcfg


def _params(jcfg, seed):
    """JAX-initialised MoE weights, with numpy noise on the (zero) norm, as
    {name: float32 numpy array}."""
    jp = j_init_params(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed))
    named = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    named["norm"] = (0.1 * np.random.default_rng(seed).standard_normal(
        named["norm"].shape)).astype(np.float32)
    return named


def _both(named):
    return ({k: torch.from_numpy(v) for k, v in named.items()},
            {k: jnp.asarray(v) for k, v in named.items()})


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_moe_specs_match_jax_and_the_router_is_fp32_in_a_bf16_model():
    for arch in MOE_ARCHS:
        cfg, jcfg = get_smoke_config(arch), j_get_smoke_config(arch)
        ours = {k: (s.shape, str(s.dtype).replace("torch.", ""), s.logical_axes, s.init)
                for k, s in moe.moe_specs(cfg).items()}
        theirs = {k: (s.shape, str(np.dtype(s.dtype)), s.logical_axes, s.init)
                  for k, s in jmoe.moe_specs(jcfg).items()}
        assert ours == theirs
        assert ours["w_router"][1] == "float32" and ours["w_gate"][1] == "bfloat16"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch):
    cfg, jcfg = _cfgs(arch)
    p, jp = _both(_params(jcfg, 1))
    x = _x(2, 2, 8, cfg.d_model)
    got = moe.moe_apply(p, torch.from_numpy(x), cfg)
    want = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, {}, mesh=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch,impl", [("kimi-k2-1t-a32b", "ep_a2a"), ("grok-1-314b", "tp_sort")])
def test_dispatch_forms_at_world_size_1_equal_dense(arch, impl):
    """The expert-parallel bodies with identity collectives, at capacity
    factor 8 (no token dropped), against the port's dense path and the JAX
    package's; the published impl of both archs runs dense in moe_apply."""
    cfg, jcfg = _cfgs(arch, capacity_factor=8.0)
    assert get_smoke_config(arch).moe.impl == "dense" and cfg.moe.impl == "dense"
    named = _params(jcfg, 3)
    p, jp = _both(named)
    xt = _x(4, 16, cfg.d_model)
    body = moe._ep_a2a_local if impl == "ep_a2a" else moe._tp_sort_local
    got = body(torch.from_numpy(xt), p["w_router"], p["w_gate"], p["w_up"], p["w_down"], cfg=cfg)
    dense = moe._dense_moe(p, torch.from_numpy(xt), cfg)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jmoe._dense_moe(jp, jnp.asarray(xt), jcfg)),
                               **TOL)
    # the full block with either impl named in the config is the dense block
    x = torch.from_numpy(_x(5, 2, 8, cfg.d_model))
    cfg_impl = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=impl))
    assert torch.equal(moe.moe_apply(p, x, cfg_impl), moe.moe_apply(p, x, cfg))


def test_dispatch_at_capacity_drops_as_jax_does():
    """At capacity factor 1.0 tokens beyond an expert's slots are dropped, by
    the same stable rank as the JAX package: the port's tp_sort body against
    the JAX package's moe_apply with impl tp_sort over a unit mesh."""
    cfg, jcfg = _cfgs("grok-1-314b", capacity_factor=1.0, impl="tp_sort")
    p, jp = _both(_params(jcfg, 6))
    x = _x(7, 1, 24, cfg.d_model)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, {}, mesh=mesh)
    tx = torch.from_numpy(x)
    h = rmsnorm(tx, p["norm"], cfg.norm_eps)[0]
    y = moe._tp_sort_local(h, p["w_router"], p["w_gate"], p["w_up"], p["w_down"], cfg=cfg)
    np.testing.assert_allclose((tx[0] + y).numpy(), np.asarray(want)[0], **TOL)
    dense = moe._dense_moe(p, h, cfg)
    assert not np.allclose(y.numpy(), dense.numpy(), **TOL)  # some token was dropped


def test_router_ties_go_to_the_lower_expert_index():
    """Equal router columns give equal probabilities: lax.top_k picks the
    lower expert index, and so does the port, on the CPU and in bf16."""
    d, E, k = 16, 8, 2
    rng = np.random.default_rng(8)
    w = np.tile(rng.standard_normal((d, 1)).astype(np.float32), (1, E))  # all columns equal
    w[:, 5] += 1.0  # expert 5 first, then the tie among the other seven
    w[:, 6] = w[:, 5]  # a tie for first place: 5 before 6
    x = np.abs(rng.standard_normal((6, d)).astype(np.float32))
    jw, jidx = jmoe._route(jnp.asarray(x), jnp.asarray(w), k)
    for dtype in (torch.float32, torch.bfloat16):
        tw, tidx = moe._route(torch.from_numpy(x).to(dtype), torch.from_numpy(w), k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)
    assert np.asarray(jidx).tolist() == [[5, 6]] * 6
    w_all = np.zeros((d, E), np.float32)  # every expert tied: the first k
    _, tidx = moe._route(torch.from_numpy(x), torch.from_numpy(w_all), k)
    assert tidx.tolist() == [[0, 1]] * 6 == np.asarray(jmoe._route(
        jnp.asarray(x), jnp.asarray(w_all), k)[1]).tolist()


@pytest.mark.parametrize("chunk", [1, 3, 7, 19])
def test_dense_chunks_equal_one_pass(chunk):
    """Chunks of several tokens give the one pass's bits.  A chunk of one
    token is a matrix-vector product, which the CPU's BLAS sums in another
    order: within 1e-6 of the largest entry.  The chunks are of even size
    (19 makes two of 10), so a long input never leaves a lone token."""
    cfg, jcfg = _cfgs("kimi-k2-1t-a32b")
    p, _ = _both(_params(jcfg, 9))
    xt = torch.from_numpy(_x(10, 20, cfg.d_model))
    whole = moe._dense_moe(p, xt, cfg, chunk=10 ** 6)
    got = moe._dense_moe(p, xt, cfg, chunk=chunk)
    if chunk == 1:
        assert float((got - whole).abs().max()) <= 1e-6 * float(whole.abs().max())
    else:
        assert torch.equal(got, whole)
    assert torch.equal(moe._dense_moe(p, xt, cfg), whole)  # the default: one chunk here


def test_moe_gradients_match_jax():
    """The block's gradients with respect to every weight and the input."""
    cfg, jcfg = _cfgs("kimi-k2-1t-a32b")
    named = _params(jcfg, 11)
    x = _x(12, 2, 6, cfg.d_model)
    g_out = _x(13, 2, 6, cfg.d_model)
    jp = {k: jnp.asarray(v) for k, v in named.items()}
    _, vjp = jax.vjp(lambda p_, x_: jmoe.moe_apply(p_, x_, jcfg, {}, mesh=None), jp,
                     jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g_out))
    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in named.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    moe.moe_apply(leaves, tx, cfg).backward(torch.from_numpy(g_out))
    for k, t in leaves.items():
        want = np.asarray(jgp[k])
        assert np.abs(t.grad.numpy() - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0), k
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
