"""The port's state store against the JAX package: the same checksum, the
same on-blade bytes, and versions that restore across the two packages."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.kernels.log_checksum import fletcher32_padded_np
from repro.models import DecoderLM as JDecoderLM
from repro.statestore import AsymStore as JAsymStore
from repro.statestore import CheckpointManager as JCheckpointManager
from repro.statestore import FileBlade as JFileBlade
from repro.statestore.checkpoint import flatten_named as j_flatten_named
from repro_torch.configs import get_smoke_config
from repro_torch.models import DecoderLM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.statestore import (AsymStore, CheckpointManager, FileBlade, MemoryBlade,
                                    fletcher32_padded)
from repro_torch.tree import flatten_named


@pytest.mark.parametrize("nbytes", [0, 1, 2, 3, 2047, 2048, 2049, 4096 + 7])
def test_fletcher32_matches_jax_on_edge_lengths(nbytes):
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    assert fletcher32_padded(data) == fletcher32_padded_np(data)


def test_fletcher32_matches_jax_across_chunks_and_extreme_words():
    # more than one 2^20-word chunk, an odd tail, and all-0xFFFF words
    rng = np.random.default_rng(1)
    for data in (rng.integers(0, 256, 2 * (1 << 20) + 4099, dtype=np.uint8).tobytes(),
                 b"\xff" * 5001):
        assert fletcher32_padded(data) == fletcher32_padded_np(data)
    base = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    flipped = bytes([base[0] ^ 1]) + base[1:]
    assert fletcher32_padded(flipped) != fletcher32_padded(base)


def _jax_state():
    rng = np.random.default_rng(0)
    return {"w": jnp.asarray(rng.standard_normal(3000).astype(np.float32)),
            "b": jnp.asarray(rng.standard_normal((4, 16)), jnp.bfloat16),
            "step": jnp.array(7, jnp.int32)}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a).tobytes()


def test_jax_versions_restore_in_the_port_bit_exact(tmp_path):
    jblade = JFileBlade(str(tmp_path / "b"), mirrors=[str(tmp_path / "m")])
    jmgr = JCheckpointManager(JAsymStore(jblade), delta_topk_frac=0.05)
    state = _jax_state()
    jmgr.save_full(1, state)
    moved = {"w": state["w"].at[::50].add(1.5), "b": state["b"] * 2, "step": state["step"]}
    jmgr.save_delta(2, moved)  # "w" and "b" as top-k deltas against version 1

    store = AsymStore(FileBlade(str(tmp_path / "b")))
    jstore = JAsymStore(JFileBlade(str(tmp_path / "b")))
    assert store.committed_versions() == [1, 2] and store.latest_version() == 2
    for v in (1, 2):
        for name in state:
            got = store.read_tensor(v, name)[0]
            want = jstore.read_tensor(v, name)[0]
            assert str(got.dtype) == f"torch.{np.asarray(want).dtype.name}"
            assert _bits(got) == _bits(want), (v, name)
    template = {k: torch.empty(tuple(np.shape(a)), dtype=t, device="meta")
                for (k, a), t in zip(state.items(), (torch.float32, torch.bfloat16, torch.int32))}
    v, restored = CheckpointManager(store).restore(template, version=2, device="cpu")
    assert v == 2 and restored["b"].dtype == torch.bfloat16
    assert _bits(restored["w"]) == _bits(jstore.read_tensor(2, "w")[0])
    # the same bytes through the mirror
    mstore = AsymStore(FileBlade(str(tmp_path / "m")))
    assert _bits(mstore.read_tensor(2, "b")[0]) == _bits(jstore.read_tensor(2, "b")[0])


def test_port_versions_restore_in_jax_bit_exact(tmp_path):
    rng = np.random.default_rng(2)
    state = {"params": {"w": torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32)),
                        "b": torch.from_numpy(rng.standard_normal(33).astype(np.float32))
                        .to(torch.bfloat16)},
             "step": torch.tensor(3, dtype=torch.int32)}
    mgr = CheckpointManager(AsymStore(FileBlade(str(tmp_path / "b"))))
    mgr.log_step(3)
    mgr.save_full(3, state)

    jmgr = JCheckpointManager(JAsymStore(JFileBlade(str(tmp_path / "b"))))
    template = {"params": {"w": jnp.zeros((8, 5), jnp.float32), "b": jnp.zeros(33, jnp.bfloat16)},
                "step": jnp.array(0, jnp.int32)}
    v, got = jmgr.restore(template)
    assert v == 3
    assert np.asarray(got["params"]["b"]).dtype == ml_dtypes.bfloat16
    for a, b in ((got["params"]["w"], state["params"]["w"]),
                 (got["params"]["b"], state["params"]["b"]), (got["step"], state["step"])):
        assert _bits(a) == _bits(b)
    assert jmgr.resume_plan() == mgr.resume_plan() == (3, [])


def test_falcon_mamba_versions_cross_the_packages_both_ways(tmp_path):
    """JAX commits falcon-mamba-7b smoke weights (bf16 matrices beside the
    mixer's fp32 A_log, D and b_dt) to a mirrored FileBlade; the port
    restores every leaf bit-exact from the primary and the mirror, serves
    the tokens that the weights held in memory serve, and commits a version
    that JAX restores bit-exact."""
    jm = JDecoderLM(j_get_smoke_config("falcon-mamba-7b"))
    rng = np.random.default_rng(4)
    # noise on every leaf, so the zero/one inits of A_log, D and b_dt carry real bits
    jp = jax.tree.map(lambda a: (a.astype(jnp.float32) + 0.1 * rng.standard_normal(a.shape))
                      .astype(a.dtype), jm.init(jax.random.PRNGKey(4)))
    JCheckpointManager(JAsymStore(JFileBlade(str(tmp_path / "b"), mirrors=[str(tmp_path / "m")]))
                       ).save_full(1, {"params": jp})
    want = {f"params/{n}": a for n, a in j_flatten_named(jp)}
    dtypes = {np.asarray(a).dtype.name for a in want.values()}
    assert dtypes == {"bfloat16", "float32"}

    model = DecoderLM(get_smoke_config("falcon-mamba-7b"))
    for blade in ("b", "m"):
        ckpt = CheckpointManager(AsymStore(FileBlade(str(tmp_path / blade))))
        v, state = ckpt.restore({"params": model.abstract()}, device="cpu")
        got = dict(flatten_named(state))
        assert v == 1 and sorted(got) == sorted(want)
        for name, arr in want.items():
            assert str(got[name].dtype) == f"torch.{np.asarray(arr).dtype.name}", name
            assert _bits(got[name]) == _bits(arr), (blade, name)

    scfg = ServeConfig(batch_slots=2, max_new_tokens=5)
    prompts = np.random.default_rng(5).integers(0, 512, (2, 7)).astype(np.int32)
    held = params_from_numpy({n: np.asarray(a) for n, a in j_flatten_named(jp)}, model, "cpu")
    expect, _ = ServeEngine(model, held, scfg, device="cpu").generate(prompts)
    ckpt = CheckpointManager(AsymStore(FileBlade(str(tmp_path / "b"))))
    got_toks, stats = ServeEngine.load_from_store(model, ckpt, scfg, device="cpu").generate(prompts)
    assert stats["version"] == 1 and stats["logits_finite"]
    np.testing.assert_array_equal(got_toks, expect)

    CheckpointManager(AsymStore(FileBlade(str(tmp_path / "p")))).save_full(2, state)
    template = {"params": jax.tree.map(jnp.zeros_like, jp)}
    jv, back = JCheckpointManager(JAsymStore(JFileBlade(str(tmp_path / "p")))).restore(template)
    assert jv == 2
    for name, arr in j_flatten_named(back):
        assert _bits(arr) == _bits(want[name]), name


@pytest.fixture(params=["memory", "file"])
def blade(request, tmp_path):
    if request.param == "memory":
        return MemoryBlade(mirrors=1)
    return FileBlade(str(tmp_path / "b0"), mirrors=[str(tmp_path / "m0")])


def test_mirror_has_everything(blade):
    mgr = CheckpointManager(AsymStore(blade))
    mgr.save_full(3, {"w": torch.arange(100.0)})
    mgr.log_step(3)
    mgr.log_step(4)
    mirror = blade.mirrors[0]
    assert sorted(mirror.list()) == sorted(blade.list())
    mstore = AsymStore(mirror)
    assert mstore.latest_version() == 3
    torch.testing.assert_close(mstore.read_tensor(3, "w")[0], torch.arange(100.0))
    assert [s for s, _ in mirror.scan_log()] == [1, 2]
    assert [p["step"] for p in mstore.pending_step_logs(3)] == [4]


def test_gc_keeps_root_and_latest(blade):
    store = AsymStore(blade)
    mgr = CheckpointManager(store, keep=1)
    for step in (1, 2, 3):
        mgr.save_full(step, {"w": torch.full((4,), float(step))})
    assert store.committed_versions() == [3]
    assert blade.mirrors[0].list() == blade.list()


def test_file_blade_torn_log_and_corrupt_object(tmp_path):
    b = FileBlade(str(tmp_path / "b"))
    b.append(b"one")
    b.append(b"two")
    with open(os.path.join(str(tmp_path / "b"), "log", "oplog.bin"), "ab") as f:
        f.write(b"\xff\xff\xff\xffgarbage")
    b2 = FileBlade(str(tmp_path / "b"))
    assert [p for _, p in b2.scan_log()] == [b"one", b"two"]
    assert b2.append(b"three") == 3
    b2.put("obj", b"payload")
    path = b2._obj_path("obj")
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        b2.get("obj")
