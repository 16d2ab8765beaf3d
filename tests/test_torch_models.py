"""The port's configs, params and dense decoder against the JAX package.

JAX-initialised weights are carried across (``models.convert``), so both
packages run the same numbers; in float32 they differ by summation order
only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import DecoderLM as JDecoderLM
from repro.models import layers as jlayers
from repro.models import param_count as j_param_count
from repro.models.params import init_params as j_init_params
from repro.statestore.checkpoint import flatten_named as j_flatten_named
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models import DecoderLM, ParamSpec, init_params, layers, param_count
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.tree import flatten_named

DENSE = ("qwen1.5-0.5b", "llama3.2-3b", "deepseek-7b", "stablelm-12b",
         "musicgen-large", "llava-next-34b")
RECURRENT = ("recurrentgemma-9b", "falcon-mamba-7b")
MOE = ("kimi-k2-1t-a32b", "grok-1-314b")
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_to_scale(got, want):
    """|got - want| <= 1e-4 + 1e-4 * max|want|.  For the KV caches: the JAX
    fan-in rule scales wk/wv by 1/sqrt(Hkv), so keys reach ~15 and an
    element near zero carries the rounding of its large neighbours."""
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= TOL["atol"] + TOL["rtol"] * np.abs(want).max()


def _carry(jmodel, jparams, model):
    named = {n: np.asarray(a) for n, a in j_flatten_named(jparams)}
    return params_from_numpy(named, model, "cpu")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", J_ARCHS)
def test_configs_match_field_for_field(arch, smoke):
    assert ARCHS == J_ARCHS
    ours = get_smoke_config(arch) if smoke else get_config(arch)
    theirs = j_get_smoke_config(arch) if smoke else j_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.hd == theirs.hd and ours.layer_kinds() == theirs.layer_kinds()
    assert str(ours.torch_dtype) == f"torch.{theirs.jnp_dtype}"


@pytest.mark.parametrize("arch", DENSE + RECURRENT + MOE)
def test_param_names_shapes_and_count_match(arch):
    cfg = get_config(arch)
    specs = DecoderLM(cfg).param_specs()
    ours = {n: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
            for n, s in flatten_named(specs, is_leaf=lambda x: isinstance(x, ParamSpec))}
    jm = JDecoderLM(j_get_config(arch))
    theirs = {n: (tuple(a.shape), str(a.dtype)) for n, a in j_flatten_named(jm.abstract())}
    assert ours == theirs
    assert param_count(specs) == j_param_count(jm.param_specs())


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 8, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    np.testing.assert_allclose(
        _np(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)),
        _np(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)), atol=1e-5, rtol=1e-5)
    pos1 = np.arange(8) + 1000
    pos2 = np.stack([pos1, pos1 + 17])
    for pos in (pos1, pos2):
        np.testing.assert_allclose(
            _np(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)),
            _np(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)), atol=2e-5, rtol=1e-5)


def test_rope_is_half_split_and_rmsnorm_scales_by_one_plus_w():
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0  # first element of the first half
    y = layers.rope(x, torch.tensor([1]), 10000.0)
    # pairs (i, i + half): element 0 rotates into element 2, not element 1
    assert abs(float(y[..., 2]) - float(np.sin(1.0))) < 1e-6 and float(y[..., 1]) == 0.0
    ones = torch.ones(1, 4)
    torch.testing.assert_close(layers.rmsnorm(ones, torch.zeros(4), 0.0), ones)


def test_init_params_scaled_fan_in_is_shape_minus_two():
    # wq (d, h, hd): the fan-in is h, as the JAX package computes it
    spec = {"wq": ParamSpec((256, 4, 64), ("embed", "heads", "head_dim"), torch.float32,
                            "scaled")}
    w = init_params(spec, torch.Generator().manual_seed(0))["wq"]
    assert abs(float(w.std()) - 0.5) < 0.01


def test_params_carry_across_bit_exact_bf16_included():
    jm = JDecoderLM(j_get_smoke_config("qwen1.5-0.5b"))
    jp = jm.init(jax.random.PRNGKey(0))
    model = DecoderLM(get_smoke_config("qwen1.5-0.5b"))
    params = _carry(jm, jp, model)
    assert params["blocks"][0]["l0"]["mixer"]["wq"].dtype == torch.bfloat16
    back = params_to_numpy(params)
    for name, arr in j_flatten_named(jp):
        a = np.asarray(arr)
        assert back[name].tobytes() == a.tobytes(), name


def test_moe_params_carry_across_bit_exact():
    """A MoE model's weights by spec name: the fp32 router beside the bf16
    experts and the shared expert, bit for bit both ways."""
    jm = JDecoderLM(j_get_smoke_config("kimi-k2-1t-a32b"))
    jp = jm.init(jax.random.PRNGKey(0))
    model = DecoderLM(get_smoke_config("kimi-k2-1t-a32b"))
    params = _carry(jm, jp, model)
    ffn = params["blocks"][1]["l0"]["ffn"]
    assert ffn["w_router"].dtype == torch.float32 and ffn["w_gate"].dtype == torch.bfloat16
    assert {"ws_gate", "ws_up", "ws_down"} <= set(ffn)
    back = params_to_numpy(params)
    for name, arr in j_flatten_named(jp):
        a = np.asarray(arr)
        assert back[name].tobytes() == a.tobytes(), name


def _elementwise(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _check_forward_prefill_and_decode_against_jax(arch, close=_elementwise, **over):
    """`close(got, want)` holds the logits; the caches are held against
    their scale."""
    jm = JDecoderLM(j_get_smoke_config(arch, dtype="float32", **over))
    jp = jm.init(jax.random.PRNGKey(1))
    model = DecoderLM(get_smoke_config(arch, dtype="float32", **over))
    params = _carry(jm, jp, model)
    toks = np.random.default_rng(2).integers(0, 512, (2, 16)).astype(np.int32)
    tt = torch.from_numpy(toks)

    with torch.inference_mode():
        close(model.forward(params, {"tokens": tt}), jm.forward(jp, {"tokens": jnp.asarray(toks)}))
        S0 = 12
        logits, cache = model.prefill(params, {"tokens": tt[:, :S0]})
        jlogits, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S0])})
        close(logits, jlogits)
        assert cache["pos"] == int(jcache["pos"]) == S0
        for name, jarr in j_flatten_named(jcache["groups"]):
            got = dict(flatten_named(cache["groups"]))[name]
            assert tuple(got.shape) == tuple(jarr.shape), name
            _close_to_scale(got, jarr)
        for t in range(S0, S0 + 3):
            logits, cache = model.decode_step(params, cache, tt[:, t])
            jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t]))
            close(logits, jlogits)
        for name, jarr in j_flatten_named(jcache["groups"]):
            _close_to_scale(dict(flatten_named(cache["groups"]))[name], jarr)


# recurrentgemma's logits are held against their scale, as the caches are.
# Its one KV head gets fan-in 1 under the JAX init rule (wk, wv unscaled), so
# the attention logits reach a std of ~67 and a max of ~250 at smoke widths.
# The two frameworks compute q and k a few ulps apart (matmul and rope order,
# ~1e-5 at magnitudes ~20), and those logits amplify that to ~4e-4 in the
# attention output at magnitude ~40; given the same q, k and v the port's
# attention agrees with JAX's to ~4e-6.  The final logits then differ by up
# to ~3e-4 at a max of ~5.
LOGITS_CLOSE = {"recurrentgemma-9b": _close_to_scale}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen1.5-0.5b", *RECURRENT, *MOE])
def test_forward_prefill_and_decode_match_jax_f32(arch):
    _check_forward_prefill_and_decode_against_jax(arch, LOGITS_CLOSE.get(arch, _elementwise))


def test_recurrentgemma_head_dim_256_matches_jax_f32():
    # recurrentgemma-9b's published head_dim, on the smoke widths
    _check_forward_prefill_and_decode_against_jax("recurrentgemma-9b", _close_to_scale,
                                                  head_dim=256)


def test_local_window_ring_cache_matches_jax_f32():
    """Local attention past the window: prefill's ring layout and decode's
    slot pos % window, held against the JAX package."""
    over = dict(dtype="float32", block_pattern=(("local_attn", "dense"),), window=16)
    jm = JDecoderLM(j_get_smoke_config("llama3.2-3b", **over))
    jp = jm.init(jax.random.PRNGKey(3))
    model = DecoderLM(get_smoke_config("llama3.2-3b", **over))
    params = _carry(jm, jp, model)
    toks = np.random.default_rng(4).integers(0, 512, (1, 30)).astype(np.int32)
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": tt[:, :21]})
        jlogits, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :21])})
        k = cache["groups"][0]["l0"]["mixer"]["k"]
        assert tuple(k.shape) == (2, 1, 2, 16, 32)
        _close_to_scale(k, jcache["groups"][0]["l0"]["mixer"]["k"])
        for t in range(21, 29):
            logits, cache = model.decode_step(params, cache, tt[:, t])
            jlogits, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t]))
            np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen1.5-0.5b", *RECURRENT, *MOE])
def test_decode_matches_forward_f32(arch):
    # the port's own check, as tests/test_models.py:33-50
    model = DecoderLM(get_smoke_config(arch, dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0))
    full = model.sample_inputs(2, 16)
    with torch.inference_mode():
        ref = model.forward(params, full)
        S0 = 12
        logits, cache = model.prefill(params, {"tokens": full["tokens"][:, :S0]})
        errs = [float((logits - ref[:, S0 - 1]).abs().max())]
        for t in range(S0, 15):
            logits, cache = model.decode_step(params, cache, full["tokens"][:, t])
            errs.append(float((logits - ref[:, t]).abs().max()))
    assert max(errs) < 2e-3, errs


def test_init_cache_matches_jax_layout():
    over = dict(block_pattern=(("attn", "dense"), ("local_attn", "dense")), window=16)
    cache = DecoderLM(get_smoke_config("llama3.2-3b", **over)).init_cache(3, 40, device="cpu")
    jcache = JDecoderLM(j_get_smoke_config("llama3.2-3b", **over)).init_cache(3, 40)
    assert cache["pos"] == int(jcache["pos"]) == 39 and cache["max_len"] == 40
    ours = {n: (tuple(t.shape), str(t.dtype)) for n, t in flatten_named(cache["groups"])}
    theirs = {n: (tuple(a.shape), f"torch.{a.dtype}") for n, a in j_flatten_named(jcache["groups"])}
    assert ours == theirs
    assert all(float(t.abs().max()) == 0 for _, t in flatten_named(cache["groups"]))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_init_cache_matches_jax_layout(arch, full):
    """{"h", "conv"} per recurrent layer (h fp32, conv in the model dtype),
    with the group's leading repeats axis, at smoke and at published widths."""
    ours_cfg = get_config(arch) if full else get_smoke_config(arch)
    theirs_cfg = j_get_config(arch) if full else j_get_smoke_config(arch)
    cache = DecoderLM(ours_cfg).init_cache(1, 64, device="cpu")
    jcache = jax.eval_shape(lambda: JDecoderLM(theirs_cfg).init_cache(1, 64))
    ours = {n: (tuple(t.shape), str(t.dtype)) for n, t in flatten_named(cache["groups"])}
    theirs = {n: (tuple(a.shape), f"torch.{a.dtype}") for n, a in j_flatten_named(jcache["groups"])}
    assert ours == theirs
    assert any(n.endswith("/h") for n in ours) and any(n.endswith("/conv") for n in ours)
    assert all(float(t.abs().max()) == 0 for _, t in flatten_named(cache["groups"]))


def _layer_params(jspecs, seed):
    """JAX-initialised layer weights with numpy noise added to every leaf
    (the zero/one inits of log_a, A_log, D, b_dt, conv_b and the norm would
    hide their arithmetic), as numpy float32 arrays keyed by name."""
    jp = j_init_params(jspecs, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v, np.float32) + 0.1 * rng.standard_normal(np.shape(v)))
            .astype(np.float32) for k, v in jp.items()}


@pytest.mark.parametrize("mixer", ["rglru", "mamba"])
def test_recurrent_layers_match_jax_in_every_mode(mixer):
    """train, prefill (the cache it fills) and three decode steps (the cache
    they update in place), on carried weights, against repro.models.layers."""
    arch = "recurrentgemma-9b" if mixer == "rglru" else "falcon-mamba-7b"
    cfg = get_smoke_config(arch, dtype="float32")
    jcfg = j_get_smoke_config(arch, dtype="float32")
    specs = getattr(jlayers, f"{mixer}_specs")(jcfg)
    named = _layer_params(specs, 5)
    jp = {k: jnp.asarray(v) for k, v in named.items()}
    p = {k: torch.from_numpy(v) for k, v in named.items()}
    japply = getattr(jlayers, f"{mixer}_apply")
    apply = getattr(layers, f"{mixer}_apply")
    shapes = getattr(layers, f"{mixer}_cache_shape")(cfg, 2)
    x = np.random.default_rng(6).standard_normal((2, 15, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        y, none = apply(p, xt, cfg, "train")
        jy, _ = japply(jp, jnp.asarray(x), jcfg, {}, "train")
        assert none is None
        np.testing.assert_allclose(_np(y), _np(jy), **TOL)
        cache = {k: torch.full(s, 7.0, dtype=dt) for k, (s, dt) in shapes.items()}
        y, same = apply(p, xt[:, :12], cfg, "prefill", cache=cache)
        jy, jcache = japply(jp, jnp.asarray(x[:, :12]), jcfg, {}, "prefill")
        assert same is cache
        np.testing.assert_allclose(_np(y), _np(jy), **TOL)
        for t in range(12, 15):
            for k in ("h", "conv"):
                assert cache[k].dtype == torch.float32 and tuple(cache[k].shape) == jcache[k].shape
                _close_to_scale(cache[k], jcache[k])
            y, _ = apply(p, xt[:, t : t + 1], cfg, "decode", cache=cache)
            jy, jcache = japply(jp, jnp.asarray(x[:, t : t + 1]), jcfg, {}, "decode", cache=jcache)
            np.testing.assert_allclose(_np(y), _np(jy), **TOL)
        for k in ("h", "conv"):
            _close_to_scale(cache[k], jcache[k])


def test_recurrent_conv_cache_pads_short_prompts_on_the_left():
    cfg = get_smoke_config("falcon-mamba-7b", dtype="float32")
    jcfg = j_get_smoke_config("falcon-mamba-7b", dtype="float32")
    named = _layer_params(jlayers.mamba_specs(jcfg), 7)
    p = {k: torch.from_numpy(v) for k, v in named.items()}
    x = np.random.default_rng(8).standard_normal((1, 2, cfg.d_model)).astype(np.float32)
    cache = {k: torch.empty(s, dtype=dt)
             for k, (s, dt) in layers.mamba_cache_shape(cfg, 1).items()}
    layers.mamba_apply(p, torch.from_numpy(x), cfg, "prefill", cache=cache)
    _, jcache = jlayers.mamba_apply({k: jnp.asarray(v) for k, v in named.items()},
                                    jnp.asarray(x), jcfg, {}, "prefill")
    assert float(cache["conv"][:, 0].abs().max()) == 0  # K-1 = 3 slots, 2 steps
    _close_to_scale(cache["conv"], jcache["conv"])


def test_softplus_and_gelu_follow_jax_not_torch_defaults():
    v = np.array([-30.0, -1.0, 0.0, 3.0, 25.0, 60.0], np.float32)
    np.testing.assert_allclose(_np(layers._softplus(torch.from_numpy(v))),
                               _np(jax.nn.softplus(jnp.asarray(v))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(layers._neg_log_a(torch.from_numpy(v))),
                               _np(jlayers._neg_log_a(jnp.asarray(v))), rtol=1e-6)
    g = np.linspace(-4, 4, 33).astype(np.float32)
    np.testing.assert_allclose(
        _np(torch.nn.functional.gelu(torch.from_numpy(g), approximate="tanh")),
        _np(jax.nn.gelu(jnp.asarray(g))), atol=1e-6)
