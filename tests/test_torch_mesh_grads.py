"""Gradients and channel shards on a 2 x 4 gloo world against the JAX
package on an 8-device CPU mesh (a subprocess with fake host devices, as
tests/test_torch_mesh.py's jax_mesh fixture runs it; the JAX models with
``attn_impl="xla"``), on the same numpy inputs, JAX-initialised:

  * the recurrent mixers on their channel shards over "model"
    (``layers._mixer_mesh``): falcon-mamba-7b and recurrentgemma-9b smoke
    configs at 2 layers, one train step's loss (1e-5) and every gradient
    leaf (1e-4 of the leaf's scale for falcon-mamba-7b, 3e-3 for
    recurrentgemma-9b: the bounds of tests/test_torch_training.py) against
    JAX's mesh and the port without one; the local shapes of the weights,
    the scans' inputs and states and the caches against JAX's shardings;
    the mixer's FLOPs on a rank, the mesh-less ones over data x model;
    greedy serving (a prefill and 8 decode steps) with the mesh-less
    port's tokens, the prefill's logits against JAX's (1e-4 + 1e-4 of
    their scale).  A config whose channels "model" does not divide takes
    the data-parallel route and matches the same way;
  * ``pipeline_apply`` over 4 stages: the output and the gradients of the
    stage weights and of x against ``jax.grad`` of the reference (1e-5);
  * ``ep_a2a`` with 3 local tokens over a model dim of 4 (replicated
    routing): the gradients of x and of every weight against ``jax.grad`` of
    the JAX MoE with ``ep_a2a`` and the port's ``dense`` without a mesh,
    within test_torch_mesh.py's MoE bound (2e-4) of each one's scale.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import REPO, run_ranks
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import DecoderLM as JDecoderLM
from repro.models import moe as jmoe
from repro.models.params import init_params as j_init_params
from repro.statestore.checkpoint import flatten_named as j_flatten_named

ARCHS = {"fm": ("falcon-mamba-7b", {}), "rg": ("recurrentgemma-9b", {}),
         "fm_odd": ("falcon-mamba-7b", {"d_model": 90})}
EXPAND = {"fm_odd": 3}       # 270 Mamba channels: a model dim of 4 does not divide them
GRAD_TOL = {"fm": 1e-4, "rg": 3e-3, "fm_odd": 1e-4}
MOE_TOL = 2e-4

JAX_SCRIPT = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.launch.dryrun import _cache_shardings
    from repro.launch.mesh import rules_for
    from repro.models import DecoderLM, make_shardings
    from repro.models import moe as jmoe
    from repro.models.params import logical_to_spec
    from repro.statestore.checkpoint import flatten_named
    from repro.training.pipeline import pipeline_apply
    d = sys.argv[1]
    ARCHS = eval(sys.argv[2])
    inp = dict(np.load(os.path.join(d, "grads8.in.npz")))
    devs = np.array(jax.devices())[:8]
    mesh = Mesh(devs.reshape(2, 4), ("data", "model"))
    out = {}

    def unflat(model, prefix):
        named = {k[len(prefix):]: jnp.asarray(v) for k, v in inp.items() if k.startswith(prefix)}
        specs = model.param_specs()
        leaves, tdef = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: hasattr(x, "logical_axes"))
        names = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                 for path, _ in leaves]
        return jax.tree_util.tree_unflatten(tdef, [named[n] for n in names])

    for tag, (arch, over) in ARCHS.items():
        cfg = get_smoke_config(arch, dtype="float32", n_layers=2, attn_impl="xla", **over)
        if tag + "/ssm_expand" in inp:
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, expand=int(inp[tag + "/ssm_expand"])))
        model = DecoderLM(cfg)
        p = unflat(model, tag + "/p/")
        batch = {k: jnp.asarray(inp[tag + "/" + k]) for k in ("tokens", "labels")}
        rules = rules_for(cfg, mesh, kind="train")
        sh = make_shardings(model.param_specs(), mesh, rules)
        with jax.set_mesh(mesh):
            pp = jax.device_put(p, sh)
            bb = jax.device_put(batch, NamedSharding(mesh, P("data")))
            loss, g = jax.jit(jax.value_and_grad(
                lambda p_, b_: model.loss(p_, b_, rules, mesh)))(pp, bb)
        rec = {"loss": float(loss), "grads": {n: np.asarray(a) for n, a in flatten_named(g)}}
        leaves = jax.tree_util.tree_leaves(sh)
        rec["local"] = {n: list(s_.shard_shape(a.shape)) for (n, a), s_ in
                        zip(flatten_named(p), leaves)}
        drules = rules_for(cfg, mesh, kind="decode")
        prompts = inp[tag + "/tokens"][:, :12]
        cache = jax.eval_shape(lambda: model.init_cache(4, cfg.max_cache_len)["groups"])
        csh = _cache_shardings(cache, mesh, drules, 4)
        rec["cache_local"] = {n: list(s_.shard_shape(a.shape)) for (n, a), s_ in
                              zip(flatten_named(cache), jax.tree_util.tree_leaves(csh))}
        kind = cfg.block_pattern[0][0]
        di = cfg.ssm.expand * cfg.d_model if kind == "mamba" else cfg.d_model

        def local(axes, shape):  # the spec's mesh axes that divide their dims
            size = lambda a: int(np.prod([mesh.shape[n] for n in (
                (a,) if isinstance(a, str) else a)]))
            fit = P(*[a if a is not None and n % size(a) == 0 else None
                      for a, n in zip(logical_to_spec(axes, rules), shape)])
            return list(NamedSharding(mesh, fit).shard_shape(shape))

        hax = ("act_batch", "mlp", "state") if kind == "mamba" else ("act_batch", "mlp")
        hshape = (4, di, cfg.ssm.d_state) if kind == "mamba" else (4, di)
        rec["scan_local"] = {k: [local(("act_batch", None, "mlp"), (4, S, di)), local(hax, hshape)]
                             for k, S in (("train", 32), ("serve", 12))}
        logits = jax.jit(lambda p_, t_: model.prefill(p_, {"tokens": t_})[0])(
            p, jnp.asarray(prompts))
        rec["prefill"] = np.asarray(logits)
        out[tag] = rec

    cfg = get_smoke_config("kimi-k2-1t-a32b", dtype="float32")
    m = dataclasses.replace(cfg.moe, capacity_factor=8.0, impl="ep_a2a")
    cfg_a2a = dataclasses.replace(cfg, moe=m)
    p = {k[len("epg/p/"):]: jnp.asarray(v) for k, v in inp.items() if k.startswith("epg/p/")}
    r = jnp.asarray(inp["epg/r"])
    with jax.set_mesh(mesh):
        gx, gp = jax.jit(jax.grad(lambda x_, p_: (jmoe.moe_apply(p_, x_, cfg_a2a, {}, mesh=mesh)
                                                  * r).sum(), argnums=(0, 1)))(
            jnp.asarray(inp["epg/x"]), p)
    out["epg"] = {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in gp.items()}}

    smesh = Mesh(devs[:4], ("stage",))  # the reference shards x over any other mesh axis
    w, x, r = (jnp.asarray(inp["pipe/" + k]) for k in ("w", "x", "r"))
    fn = lambda w_, x_: pipeline_apply(lambda p_, h: jnp.tanh(h @ p_), w_, x_, smesh,
                                       axis="stage", n_micro=4)
    with jax.set_mesh(smesh):
        y = jax.jit(fn)(w, x)
        gw, gx = jax.jit(jax.grad(lambda w_, x_: (fn(w_, x_) * r).sum(), argnums=(0, 1)))(w, x)
    out["pipe"] = {"y": np.asarray(y), "w": np.asarray(gw), "x": np.asarray(gx)}
    pickle.dump(out, open(os.path.join(d, "jax.pkl"), "wb"))
    print("OK")
""")


def _j_cfg(tag):
    arch, over = ARCHS[tag]
    cfg = j_get_smoke_config(arch, dtype="float32", n_layers=2, **over)
    if tag in EXPAND:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, expand=EXPAND[tag]))
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The numpy inputs (JAX-initialised weights, seeded batches), then the
    JAX references and the 2 x 4 port world, side by side."""
    import pickle

    d = tmp_path_factory.mktemp("grads")
    rng = np.random.default_rng(0)
    arrays = {}
    for i, tag in enumerate(ARCHS):
        cfg = _j_cfg(tag)
        params = JDecoderLM(cfg).init(jax.random.PRNGKey(10 + i))
        arrays.update({f"{tag}/p/{n}": np.asarray(a, np.float32)
                       for n, a in j_flatten_named(params)})
        for k in ("tokens", "labels"):
            arrays[f"{tag}/{k}"] = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        if tag in EXPAND:
            arrays[f"{tag}/ssm_expand"] = np.array(EXPAND[tag])
    mcfg = j_get_smoke_config("kimi-k2-1t-a32b", dtype="float32")
    mcfg = dataclasses.replace(mcfg, moe=dataclasses.replace(mcfg.moe, capacity_factor=8.0))
    p = j_init_params(jmoe.moe_specs(mcfg), jax.random.PRNGKey(3))
    arrays.update({f"epg/p/{k}": np.asarray(v, np.float32) for k, v in p.items()})
    for k in ("x", "r"):
        arrays[f"epg/{k}"] = rng.standard_normal((2, 3, mcfg.d_model)).astype(np.float32)
    arrays["pipe/w"] = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    arrays["pipe/x"] = rng.standard_normal((8, 16)).astype(np.float32)
    arrays["pipe/r"] = rng.standard_normal((8, 16)).astype(np.float32)
    np.savez(d / "grads8.in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    ref = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(d), repr(ARCHS)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run_ranks("grads8", 8, d, timeout=400)
    finally:
        _, err = ref.communicate(timeout=400)
    assert ref.returncode == 0, err[-4000:]
    return (torch.load(d / "grads8.out.pt", weights_only=False),
            pickle.load(open(d / "jax.pkl", "rb")))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= 1e-7 + tol * scale, (err, scale)


# ------------------------------------------------------------- route B
@pytest.mark.parametrize("tag", list(ARCHS))
def test_mixer_train_step_matches_jax_and_the_meshless_port(world, tag):
    out, ref = world
    loss0, loss1 = out[f"{tag}/loss"]
    assert abs(loss1 - ref[tag]["loss"]) <= 1e-5
    assert abs(loss1 - loss0) <= 1e-5
    grads, grads0, jgrads = out[f"{tag}/grads"], out[f"{tag}/grads0"], ref[tag]["grads"]
    assert sorted(grads) == sorted(jgrads) == sorted(grads0)
    for name, g in grads.items():
        _close(g, jgrads[name], GRAD_TOL[tag])
        _close(g, grads0[name], GRAD_TOL[tag])


@pytest.mark.parametrize("tag", ["fm", "rg"])
def test_mixers_run_on_channel_shards_as_jax_shards_them(world, tag):
    """Each rank's weights, caches and the scans' inputs and final states
    have the local shapes of JAX's shardings: channels over "model"."""
    out, ref = world
    assert out[f"{tag}/local"] == ref[tag]["local"]
    assert out[f"{tag}/cache_local"] == ref[tag]["cache_local"]
    scan = "mamba_scan" if tag == "fm" else "rglru_scan"
    assert out[f"{tag}/train_seen"] == {scan: ref[tag]["scan_local"]["train"]}
    assert out[f"{tag}/serve_seen"] == {scan: ref[tag]["scan_local"]["serve"]}
    assert out[f"{tag}/train_rows"] == out[f"{tag}/serve_rows"] == 0


def test_undivided_channels_take_the_data_parallel_route(world):
    """270 Mamba channels over a model dim of 4: each rank runs the whole
    mixer on its batch rows (its scans on every channel)."""
    out, ref = world
    assert out["fm_odd/train_rows"] > 0 and out["fm_odd/serve_rows"] > 0
    assert out["fm_odd/train_seen"]["mamba_scan"] == [[2, 32, 270], [2, 270, 8]]
    assert out["fm_odd/local"] == ref["fm_odd"]["local"]


@pytest.mark.parametrize("tag", list(ARCHS))
def test_mixer_flops_divide_over_the_ranks(world, tag):
    """A mixer's forward and backward FLOPs on one rank: the mesh-less ones
    over data x model on channel shards, over data alone when
    data-parallel."""
    plain, mesh = world[0][f"{tag}/flops"]
    assert plain > 0
    assert mesh * (2 if tag == "fm_odd" else 8) == plain


@pytest.mark.parametrize("tag", list(ARCHS))
def test_mixer_serving_on_2x4(world, tag):
    out, ref = world
    want, got = out[f"{tag}/tokens"]
    assert np.array_equal(want, got)
    logits, jlogits = out[f"{tag}/prefill"], ref[tag]["prefill"]
    assert logits.shape == jlogits.shape
    assert np.abs(logits - jlogits).max() <= 1e-4 + 1e-4 * np.abs(jlogits).max()


# ------------------------------------------------------------- route C
@pytest.mark.parametrize("form", ["plain", "dtensor"])
def test_pipeline_gradients_match_jax(world, form):
    out, ref = world
    for key in ("y", "w", "x"):
        got, want = out[f"pipe/{form}"][key], ref["pipe"][key]
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-5, key


# ------------------------------------------------------------- route D
def test_ep_a2a_replicated_routing_gradients_match_jax_and_dense(world):
    out, ref = world
    assert out["epg/impl"] == "ep_a2a" and out["epg/local_tokens"] == 3
    got, dense, jax_g = out["epg/ep_a2a"], out["epg/dense"], ref["epg"]
    assert sorted(got) == sorted(dense) and set(jax_g) <= set(got)
    for name, g in got.items():
        _close(g, dense[name], MOE_TOL)
        if name in jax_g:
            _close(g, jax_g[name], MOE_TOL)


# ------------------------------------------------------------- 1 x 1 mesh
def test_one_by_one_mesh_channel_route_is_bitwise(tmp_path):
    """The channel route on a 1 x 1 mesh (as the card runs it): step-0
    gradients, two Adafactor steps and greedy serving of falcon-mamba-7b and
    recurrentgemma-9b give the mesh-less path's bits, no mixer on the
    data-parallel route."""
    run_ranks("mesh1rec", 1, tmp_path, timeout=200)
    out = torch.load(tmp_path / "mesh1rec.out.pt", weights_only=False)
    assert out == {"one_rec/falcon-mamba-7b": True, "one_rec/recurrentgemma-9b": True}
