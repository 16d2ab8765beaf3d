"""The port's distribution layer (repro_torch.launch.mesh, models.params'
sharding, the mesh paths of the model, trainer, engine and MoE) against the
JAX package's, on the CPU.

Multi-rank cases run on gloo ranks, one process each, over a file:// store
(tests/_torch_ranks.py runs tests/_torch_mesh_worker.py); the JAX package's
multi-device references run in a subprocess with fake host devices, so
neither process group nor device flag reaches other tests.  The same numpy
inputs, from a seed, go to both packages.  Tolerances:

  * rules, specs, shard shapes, parameter counts: equal;
  * a mesh train step against the JAX package's mesh-less step on the same
    weights and batch: tests/test_torch_training.py's
    test_one_train_step_matches_jax (loss 1e-5; grad_norm 1e-4 of itself;
    the moments as gradients, 1e-3 of each tensor's scale);
  * the sequence-parallel loss: 1e-5; prefill and decode logits with the
    cache sharded on its length: 1e-4 + 1e-4 of their scale (the float32
    bound of tests/test_torch_models.py);
  * MoE dispatch forms against dense and JAX: err < 2e-4, the bound of
    tests/test_sharding_dryrun.py::test_mini_mesh_moe_ep_a2a_runs;
  * a 1 x 1 mesh and a store version written from a mesh: bitwise.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import REPO, run_ranks
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.launch.mesh import rules_for as j_rules_for
from repro.models import DecoderLM as JDecoderLM
from repro.models import moe as jmoe
from repro.models import param_count as j_param_count
from repro.models.params import init_params as j_init_params
from repro.models.params import logical_to_spec as j_logical_to_spec
from repro.statestore import AsymStore as JAsymStore
from repro.statestore import CheckpointManager as JCheckpointManager
from repro.statestore.blade import FileBlade as JFileBlade
from repro.statestore.checkpoint import flatten_named as j_flatten_named
from repro.training import OptConfig as JOptConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_train_state as j_init_train_state
from repro.training import make_train_step as j_make_train_step
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_mesh, rules_for
from repro_torch.models import DecoderLM, param_count
from repro_torch.models.params import ParamSpec, local_shape, logical_to_spec, placements_of
from repro_torch.statestore import AsymStore, CheckpointManager
from repro_torch.statestore.blade import FileBlade
from repro_torch.training import OptConfig, TrainConfig, Trainer
from repro_torch.tree import flatten_named

MESHES = {"2x4": ((2, 4), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("train", "prefill", "decode")
SEQ_CFG = dict(n_heads=3, n_kv_heads=3, head_dim=32, d_model=96, d_ff=128, dtype="float32")
MOE_TOL = 2e-4


class StandIn:
    """A mesh as rules_for reads it (JAX: shape dict and axis_names; the
    port: mesh_dim_names and shape) and as local_shape does, no devices."""

    def __init__(self, shape, names):
        self.mesh_dim_names = self.axis_names = names
        self.dims = tuple(shape)
        self.ndim = len(shape)

    @property
    def shape(self):  # the port reads a tuple, JAX a dict: both via mesh_shape()
        return self.dims


class JStandIn:
    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _norm(spec):
    """PartitionSpec entries as JAX prints them: a one-axis tuple is its axis."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in spec)


def _at(tree, name):
    """The leaf of a nested dict/list at a flatten_named path."""
    for key in name.split("/"):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


def _specs(model, spec_cls):
    return [(n, s) for n, s in flatten_named(model.param_specs(),
                                             is_leaf=lambda x: isinstance(x, spec_cls))]


# ------------------------------------------------------------------- rules
@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_specs_match_jax(arch, kind, mesh_id):
    shape, names = MESHES[mesh_id]
    for fsdp in (False, True):
        cfg, jcfg = get_config(arch, fsdp=fsdp), j_get_config(arch, fsdp=fsdp)
        rules = rules_for(cfg, StandIn(shape, names), kind=kind)
        jrules = j_rules_for(jcfg, JStandIn(shape, names), kind=kind)
        assert rules == jrules
        jspecs = JDecoderLM(jcfg).param_specs()
        for name, s in _specs(DecoderLM(cfg), ParamSpec):
            jspec = _at(jspecs, name)
            assert jspec.shape == s.shape
            assert _norm(logical_to_spec(s.logical_axes, rules)) == \
                _norm(j_logical_to_spec(jspec.logical_axes, jrules)), name


# ----------------------------------------------------------- JAX references
JAX_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import dataclasses, jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import ARCHS, get_config, get_smoke_config
    from repro.models import DecoderLM, make_shardings
    from repro.models import moe as jmoe
    from repro.models.params import ParamSpec
    from repro.launch.mesh import rules_for
    from repro.statestore.checkpoint import flatten_named
    out_dir = sys.argv[1]
    devs = np.array(jax.devices())
    shapes = {}
    for mesh_id, shape, names in (("16x16", (16, 16), ("data", "model")),
                                  ("2x16x16", (2, 16, 16), ("pod", "data", "model"))):
        mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), names)
        for arch in ARCHS:
            for fsdp in (False, True):
                cfg = get_config(arch, fsdp=fsdp)
                specs = DecoderLM(cfg).param_specs()
                sh = make_shardings(specs, mesh, rules_for(cfg, mesh, kind="train"))
                leaves, _ = jax.tree_util.tree_flatten_with_path(
                    specs, is_leaf=lambda x: isinstance(x, ParamSpec))
                shs = jax.tree_util.tree_leaves(sh)
                shapes[f"{mesh_id}/{arch}/{fsdp}"] = {
                    "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                    list(s_.shard_shape(spec.shape)) for (path, spec), s_ in zip(leaves, shs)}
    json.dump(shapes, open(os.path.join(out_dir, "shard_shapes.json"), "w"))
    inp = dict(np.load(os.path.join(out_dir, "mesh8.in.npz")))
    cfg = get_smoke_config("kimi-k2-1t-a32b", dtype="float32")
    m = dataclasses.replace(cfg.moe, impl="ep_a2a", capacity_factor=8.0)
    cfg_a2a = dataclasses.replace(cfg, moe=m)
    p = {k[len("ep/p/"):]: jnp.asarray(v) for k, v in inp.items() if k.startswith("ep/p/")}
    mesh = Mesh(devs[:8].reshape(2, 4), ("data", "model"))
    with jax.set_mesh(mesh):
        y = jax.jit(lambda p, x: jmoe.moe_apply(p, x, cfg_a2a, {}, mesh=mesh))(
            p, jnp.asarray(inp["ep/x"]))
    np.save(os.path.join(out_dir, "ep_jax.npy"), np.asarray(y))
    print("OK")
""")


def _named_jax(params):
    return {n: np.asarray(a, np.float32) for n, a in j_flatten_named(params)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded numpy inputs for the 2 x 4 and 2 x 3 worlds, JAX-initialised
    weights; and the JAX package's mesh-less references."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    arrays, ref = {}, {}
    # train: llama smoke (fsdp), one AdamW and one Adafactor step
    jcfg = j_get_smoke_config("llama3.2-3b", dtype="float32", fsdp=True)
    jm = JDecoderLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    for n, a in _named_jax(jp).items():
        arrays[f"train/p/{n}"] = a
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (4, 12)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (4, 12)).astype(np.int32)}
    arrays.update({f"train/{k}": v for k, v in batch.items()})
    for opt in ("adamw", "adafactor"):
        jt = JTrainConfig(opt=JOptConfig(kind=opt, lr=1e-3))
        js = j_init_train_state(jm, jax.random.PRNGKey(0), jt)
        js["params"] = jp
        jnew, jmet = j_make_train_step(jm, jt)(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ref[f"train_{opt}"] = (float(jmet["loss"]), float(jmet["grad_norm"]),
                               {n: np.asarray(a, np.float32) for n, a in j_flatten_named(jnew)})
    # sequence-parallel attention: the 3-head config
    scfg = j_get_smoke_config("llama3.2-3b", **SEQ_CFG)
    sm = JDecoderLM(scfg)
    sp = sm.init(jax.random.PRNGKey(1))
    for n, a in _named_jax(sp).items():
        arrays[f"seq/p/{n}"] = a
    toks = rng.integers(0, scfg.vocab_size, (4, 32)).astype(np.int32)
    labels = rng.integers(0, scfg.vocab_size, (4, 32)).astype(np.int32)
    arrays.update({"seq/tokens": toks, "seq/labels": labels})
    ref["seq/loss"] = float(sm.loss(sp, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)}))
    logits, cache = sm.prefill(sp, {"tokens": jnp.asarray(toks[:, :16])})
    ref["seq/prefill"] = np.asarray(logits)
    ref["seq/decode"] = np.asarray(sm.decode_step(sp, cache, jnp.asarray(toks[:, 16]))[0])
    # MoE: kimi-k2 (8 experts over model 4: ep_a2a) and grok-1 at d_expert 96
    for tag, arch, over, seed in (("ep", "kimi-k2-1t-a32b", {}, 1), ("tp", "grok-1-314b",
                                                                   {"d_expert": 96}, 2)):
        mcfg = j_get_smoke_config(arch, dtype="float32")
        mcfg = dataclasses.replace(mcfg, moe=dataclasses.replace(mcfg.moe, capacity_factor=8.0,
                                                                 **over))
        p = j_init_params(jmoe.moe_specs(mcfg), jax.random.PRNGKey(seed))
        x = rng.standard_normal((8, 16, mcfg.d_model)).astype(np.float32)
        arrays.update({f"{tag}/p/{k}": np.asarray(v, np.float32) for k, v in p.items()})
        arrays[f"{tag}/x"] = x
        ref[f"{tag}/dense_jax"] = np.asarray(jmoe.moe_apply(p, jnp.asarray(x), mcfg, {}, None))
    np.savez(d / "mesh8.in.npz", **{k: v for k, v in arrays.items() if not k.startswith("tp/")})
    np.savez(d / "mesh6.in.npz", **{k: v for k, v in arrays.items() if k.startswith("tp/")})
    return d, ref


@pytest.fixture(scope="module")
def jax_mesh(inputs):
    """The JAX package on 512 fake host devices: shard shapes on the
    production meshes and ep_a2a on a 2 x 4 mesh."""
    d, _ = inputs
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(d)], capture_output=True,
                         text=True, env=env, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.load(open(d / "shard_shapes.json")), np.load(d / "ep_jax.npy")


@pytest.fixture(scope="module")
def mesh8(inputs):
    d, _ = inputs
    run_ranks("mesh8", 8, d, timeout=400)
    return torch.load(d / "mesh8.out.pt", weights_only=False)


@pytest.fixture(scope="module")
def mesh6(inputs):
    d, _ = inputs
    run_ranks("mesh6", 6, d, timeout=300)
    return torch.load(d / "mesh6.out.pt", weights_only=False)


# ------------------------------------------------------------- shard shapes
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shapes_on_the_production_meshes_match_jax(jax_mesh, arch):
    shapes, _ = jax_mesh
    for mesh_id in ("16x16", "2x16x16"):
        shape, names = MESHES[mesh_id]
        mesh = StandIn(shape, names)
        for fsdp in (False, True):
            cfg = get_config(arch, fsdp=fsdp)
            rules = rules_for(cfg, mesh, kind="train")
            want = shapes[f"{mesh_id}/{arch}/{fsdp}"]
            got = {n: list(local_shape(s.shape, placements_of(s.shape, s.logical_axes, mesh,
                                                              rules), mesh))
                   for n, s in _specs(DecoderLM(cfg), ParamSpec)}
            assert got == want, (mesh_id, fsdp)


def test_param_counts_match_jax_and_the_published_table():
    published = {  # tests/test_models.py:53-62
        "qwen1.5-0.5b": 0.62, "llama3.2-3b": 3.6, "deepseek-7b": 6.9,
        "stablelm-12b": 12.1, "recurrentgemma-9b": 9.6, "musicgen-large": 3.2,
        "falcon-mamba-7b": 7.3, "kimi-k2-1t-a32b": 1027.0,
        "grok-1-314b": 316.0, "llava-next-34b": 33.9,
    }
    assert sorted(ARCHS) == sorted(J_ARCHS) == sorted(published)
    for arch, billions in published.items():
        n = param_count(DecoderLM(get_config(arch)).param_specs())
        assert n == j_param_count(JDecoderLM(j_get_config(arch)).param_specs()), arch
        assert abs(n / 1e9 - billions) / billions < 0.06, arch


# ---------------------------------------------------------------- meshes
def test_make_mesh_needs_a_process_group_and_the_card():
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh((1, 1), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="mesh device"):
        make_mesh((1, 1), ("data", "model"), "tpu")


def test_one_by_one_mesh_is_bitwise_the_plain_path(tmp_path):
    """Train steps (AdamW, Adafactor) and greedy serving through a 1 x 1
    mesh give the mesh-less path's bits."""
    run_ranks("mesh1", 1, tmp_path, timeout=200)
    out = torch.load(tmp_path / "mesh1.out.pt", weights_only=False)
    assert out == {"one/train_adamw": True, "one/train_adafactor": True, "one/serve": True}


# ----------------------------------------------------------- train on 2x4
def _grad_close(got, want, tol=1e-3):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-7 + tol * np.abs(want).max()


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_train_step_on_2x4_matches_jax(inputs, mesh8, opt):
    _, ref = inputs
    jloss, jgnorm, jstate = ref[f"train_{opt}"]
    assert abs(mesh8[f"train_{opt}/loss"] - jloss) <= 1e-5
    assert abs(mesh8[f"train_{opt}/grad_norm"] - jgnorm) <= 1e-4 * jgnorm
    got = {k[len(f"train_{opt}/state/"):]: v for k, v in mesh8.items()
           if k.startswith(f"train_{opt}/state/")}
    assert sorted(got) == sorted(jstate)
    held = 0
    for name, t in got.items():
        last = name.rsplit("/", 1)[-1]
        if name.startswith("opt/") and (last in ("vr", "vc", "v") or
                                        (opt == "adamw" and last == "m")):
            _grad_close(t, jstate[name])
            held += 1
    assert held >= sum(1 for n in got if n.startswith("params/"))
    # the data-parallel and FSDP reductions are collectives of the step
    colls = mesh8[f"train_{opt}/colls"]
    assert colls.get("all-reduce", 0) + colls.get("reduce-scatter", 0) > 0, colls
    assert colls.get("all-gather", 0) > 0, colls


# ------------------------------------------------- sequence-parallel attention
def test_sequence_parallel_loss_on_2x4_matches_jax(inputs, mesh8):
    _, ref = inputs
    assert abs(mesh8["seq/loss"] - ref["seq/loss"]) <= 1e-5


def test_cache_length_sharded_decode_on_2x4_matches_jax(inputs, mesh8):
    _, ref = inputs
    assert mesh8["seq/cache_len_sharded"]
    for key in ("seq/prefill", "seq/decode"):
        got, want = mesh8[key], ref[key]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 + 1e-4 * np.abs(want).max(), key


# ------------------------------------------------------------------- MoE
def test_ep_a2a_on_2x4_matches_jax_and_dense(inputs, jax_mesh, mesh8):
    _, ref = inputs
    _, y_jax = jax_mesh
    assert mesh8["ep/impl"] == "ep_a2a" and mesh8["ep/colls"].get("all-to-all", 0) >= 2
    y = mesh8["ep/y"]
    assert np.abs(y - y_jax).max() < MOE_TOL
    assert np.abs(y - mesh8["ep/y_dense"]).max() < MOE_TOL
    assert np.abs(y - ref["ep/dense_jax"]).max() < MOE_TOL


def test_tp_sort_on_2x3_matches_dense(inputs, mesh6):
    """8 experts do not divide a model axis of 3: ep_a2a falls back to
    tp_sort, the experts' width sharded 3 ways."""
    _, ref = inputs
    assert mesh6["tp/impl"] == "tp_sort" and mesh6["tp/colls"].get("all-reduce", 0) >= 1
    y = mesh6["tp/y"]
    assert np.abs(y - mesh6["tp/y_dense"]).max() < MOE_TOL
    assert np.abs(y - ref["tp/dense_jax"]).max() < MOE_TOL


# ----------------------------------------------------------------- store
def test_version_from_a_2x4_trainer_restores_bitwise_without_a_mesh(inputs, mesh8):
    """The 2 x 4 trainer's full commit at step 2 holds rank 0's gathered
    state: a mesh-less port trainer resumes from it, and the JAX package's
    CheckpointManager restores it, with the same bits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig

    d, _ = inputs
    assert mesh8["store/host"] == (2, 0)
    assert len(mesh8["store/losses"]) == 3 and np.all(np.isfinite(mesh8["store/losses"]))
    want = {k[len("store/at2/"):]: v for k, v in mesh8.items() if k.startswith("store/at2/")}
    cfg = get_smoke_config("llama3.2-3b", fsdp=True)
    blade = str(d / "blade")
    tr = Trainer(DecoderLM(cfg), TrainConfig(opt=OptConfig(lr=1e-3)),
                 DataConfig(vocab_size=cfg.vocab_size, global_batch=4, seq_len=16, seed=5),
                 ckpt=CheckpointManager(AsymStore(FileBlade(blade)), full_every=2), seed=3,
                 device="cpu")
    assert tr.resume() == 2
    got = dict(flatten_named(tr.state))
    assert sorted(got) == sorted(want)
    for n, t in got.items():
        arr = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert np.array_equal(arr, want[n]), n
    jcfg = j_get_smoke_config("llama3.2-3b", fsdp=True)
    jt = JTrainConfig(opt=JOptConfig(lr=1e-3))
    template = j_init_train_state(JDecoderLM(jcfg), jax.random.PRNGKey(0), jt)
    v, jstate = JCheckpointManager(JAsymStore(JFileBlade(blade))).restore(template, version=2)
    assert v == 2
    for n, a in j_flatten_named(jstate):
        a = np.asarray(a)
        a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        assert np.array_equal(a, want[n]), n


# ------------------------------------------------------------- recurrent
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_recurrent_mixers_train_and_serve_on_2x4(mesh8, arch):
    """The recurrent mixers run on their channel shards over "model" (the
    smoke widths divide by 4; tests/test_torch_mesh_grads.py holds the
    shards and the gradients to JAX): a train step's loss and grad norm
    against the port without a mesh (the gradients' bound of
    tests/test_torch_training.py: recurrentgemma-9b's 3e-3 of scale), and
    the same greedy tokens."""
    loss0, loss1, g0, g1 = mesh8[f"rec/{arch}/train"]
    assert abs(loss1 - loss0) <= 1e-5
    assert abs(g1 - g0) <= (3e-3 if arch == "recurrentgemma-9b" else 1e-4) * g0
    assert mesh8[f"rec/{arch}/serve"]
