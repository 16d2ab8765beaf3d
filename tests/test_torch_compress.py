"""The port's delta compression and checksums against the JAX package, on
the CPU: ``topk_compress`` and the Fletcher-32 forms (plain versions, the
code the CUDA kernels are held to on the card) against the Pallas kernels
in interpret mode and JAX's references, and delta versions that restore
across the two packages.

Tolerances: none.  Top-k (values, indices, residual) and every checksum
are compared exactly; a restored delta version bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.log_checksum import fletcher32 as j_fletcher32
from repro.kernels.log_checksum import fletcher32_padded_np
from repro.kernels.log_checksum import fletcher32_wave as j_fletcher32_wave
from repro.kernels.topk_compress import topk_compress as j_topk_compress
from repro.statestore import AsymStore as JAsymStore
from repro.statestore import CheckpointManager as JCheckpointManager
from repro.statestore import FileBlade as JFileBlade
from repro_torch.kernels import log_checksum, ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels import topk_compress as ttopk
from repro_torch.statestore import (AsymStore, CheckpointManager, FileBlade, MemoryBlade,
                                    fletcher32_padded)
from repro_torch.statestore.blade import fletcher32_join
from repro_torch.tree import to_numpy

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # fall back to the seeded-random shim
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from _hypothesis_shim import given, settings, st


def _x(n, dtype, seed):
    """Normal values with planted ties: a run of zeros, equal magnitudes of
    both signs, and a repeated value."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[3:40] = 0.0
    x[100:n:97] = 2.5
    x[150:n:193] = -2.5
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx


def _same(t, a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return to_numpy(t).tobytes() == a.view(np.uint16).tobytes()
    return t.dtype == torch.from_numpy(a.copy()).dtype and t.numpy().tobytes() == a.tobytes()


# ---------------------------------------------------------------- top-k
@pytest.mark.parametrize("n,k", [(5000, 10), (1024, 1), (3000, 37), (700, 20), (2049, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_plain_equals_pallas_kernel_and_jax_reference(n, k, dtype):
    jx, tx = _x(n, dtype, n + k)
    got = TR.topk_compress_reference(tx, k)
    kern = j_topk_compress(jx, k, interpret=True)
    refr = JR.topk_compress_reference(jx, k)
    for g, a, b in zip(got, kern, refr):
        b = np.asarray(b)
        if g.dtype == torch.float32 and b.dtype.name == "bfloat16":
            b = b.astype(np.float32)  # the reference keeps x's dtype for vals, exactly
        assert _same(g, a) and _same(g, b)


def test_topk_ties_go_to_the_lowest_index():
    x = torch.tensor([1.0, -3.0, 3.0, 0.5, -3.0, 2.0] + [0.0] * 10)
    vals, idx, res = TR.topk_compress_reference(x, 5, block=8)
    assert idx.tolist() == [[1, 2, 4, 5, 0], [0, 1, 2, 3, 4]]
    assert vals.tolist() == [[-3.0, 3.0, -3.0, 2.0, 1.0], [0.0] * 5]
    assert res.tolist() == [0.0] * 3 + [0.5] + [0.0] * 12


@pytest.mark.parametrize("n,k", [(5000, 10), (100, 8)])
def test_topk_decompress_and_dispatch(n, k):
    jx, tx = _x(n, "float32", 3)
    vals, idx, res = ops.topk_compress(tx, k)
    assert ttopk.launches == 0  # CPU tensors take the plain version
    dec = ops.topk_decompress(vals, idx, n)
    want = JR.topk_decompress_reference(jnp.asarray(vals.numpy()), jnp.asarray(idx.numpy()), n)
    assert _same(dec, want)
    torch.testing.assert_close(dec + res, tx, atol=0, rtol=0)
    forced = ops.topk_compress(tx, k, impl="torch")
    assert all(torch.equal(a, b) for a, b in zip(forced, (vals, idx, res)))


# ------------------------------------------------------------ checksums
def _bytes_tensor(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else \
        torch.empty(0, dtype=torch.uint8)


@pytest.mark.parametrize("nbytes", [0, 1, 2, 3, 2047, 2048, 2049, 4096 + 7, 3 * 2048 + 1])
def test_fletcher32_plain_equals_numpy_mirror_and_pallas_kernel(nbytes):
    data = np.random.default_rng(nbytes).integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    want = fletcher32_padded_np(data)
    assert int(TR.fletcher32_reference(_bytes_tensor(data))) == want
    assert int(log_checksum.fletcher32(_bytes_tensor(data))) == want
    assert int(ops.fletcher32(_bytes_tensor(data))) == want
    if nbytes:
        padded = data + b"\x00" * (nbytes % 2)
        words = np.frombuffer(padded, dtype="<u2").astype(np.int32)
        assert int(TR.fletcher32_reference(torch.from_numpy(words))) == want
        assert int(j_fletcher32(jnp.asarray(words), interpret=True)) == want


def test_fletcher32_plain_across_chunks_and_extreme_words():
    """More than one of the plain version's chunks, and all-0xFFFF words."""
    for data in (np.random.default_rng(5).integers(0, 256, 70001, dtype=np.uint8).tobytes(),
                 b"\xff" * 9001):
        assert int(TR.fletcher32_reference(_bytes_tensor(data), chunk_words=4096)) == \
            fletcher32_padded_np(data)


@settings(max_examples=12, deadline=None)
@given(st.binary(min_size=0, max_size=6000))
def test_fletcher32_plain_matches_numpy_mirror_on_any_bytes(data):
    assert int(TR.fletcher32_reference(_bytes_tensor(data))) == fletcher32_padded_np(data)


def test_fletcher32_wave_plain_equals_pallas_wave_kernel():
    rng = np.random.default_rng(9)
    chunks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (5, 0, 2048, 2049, 7001, 1, 4096)]
    want = j_fletcher32_wave(chunks, interpret=True)
    got = log_checksum.fletcher32_wave([_bytes_tensor(c) for c in chunks])
    assert got.dtype == torch.int64 and got.tolist() == [int(w) for w in want]
    assert got.tolist() == [fletcher32_padded_np(c) for c in chunks]
    assert ops.fletcher32_wave([_bytes_tensor(c) for c in chunks]).tolist() == got.tolist()
    assert log_checksum.launches == 0


@pytest.mark.parametrize("body_bytes", [0, 1, 2, 2047, 2048, 4000, 9001])
@pytest.mark.parametrize("prefix_bytes", [0, 2, 128, 2048, 2050])
def test_fletcher32_join_is_the_checksum_of_the_concatenation(prefix_bytes, body_bytes):
    rng = np.random.default_rng(prefix_bytes * 31 + body_bytes)
    prefix = rng.integers(0, 256, prefix_bytes, dtype=np.uint8).tobytes()
    body = rng.integers(0, 256, body_bytes, dtype=np.uint8).tobytes()
    assert fletcher32_join(prefix, len(body), fletcher32_padded(body)) == \
        fletcher32_padded_np(prefix + body)


def test_as_bytes_views_every_dtype_without_a_copy():
    for t in (torch.arange(10, dtype=torch.float32), torch.ones(3, 4, dtype=torch.bfloat16),
              torch.tensor(7, dtype=torch.int32)):
        b = log_checksum.as_bytes(t)
        assert b.dtype == torch.uint8 and b.numel() == t.numel() * t.element_size()
        assert b.data_ptr() == t.data_ptr()
    with pytest.raises(ValueError, match="contiguous"):
        log_checksum.as_bytes(torch.zeros(4, 4).t())


# --------------------------------------------------------------- deltas
def _state(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(3000).astype(np.float32),
            "b": rng.standard_normal((4, 300)).astype(np.float32),
            "step": np.array(7, np.int32)}


def _moved(state, seed):
    rng = np.random.default_rng(seed)
    return {"w": state["w"] + rng.standard_normal(3000).astype(np.float32) * 0.01,
            "b": state["b"] + rng.standard_normal((4, 300)).astype(np.float32),
            "step": np.array(8, np.int32)}


def _jstate(s, bf16=False):
    return {k: jnp.asarray(v, jnp.bfloat16 if (bf16 and k == "b") else None)
            for k, v in s.items()}


def _tstate(s, bf16=False):
    return {k: torch.from_numpy(v).to(torch.bfloat16) if (bf16 and k == "b")
            else torch.from_numpy(v.copy()) for k, v in s.items()}


def _bits(x):
    a = to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a).tobytes()


@pytest.mark.parametrize("bf16", [False, True])
def test_delta_versions_cross_the_packages_both_ways(tmp_path, bf16):
    """Each package writes a full version and then two delta versions (a
    delta on a delta); the other package restores every version bit for bit
    as the writer does.  The two writers' delta versions agree bit for bit
    (the planted deltas have no ties at the k-th magnitude, so both select
    the same entries whatever their order), and so do their views of the
    state (base + applied) afterwards: the residual of the error feedback."""
    s1 = _state(0)
    s2 = _moved(s1, 1)
    s3 = _moved(s2, 2)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jmgr = JCheckpointManager(JAsymStore(JFileBlade(jdir)), delta_topk_frac=0.02, keep=5)
    tmgr = CheckpointManager(AsymStore(FileBlade(tdir)), delta_every=1, delta_topk_frac=0.02,
                             keep=5)
    jmgr.save_full(1, _jstate(s1, bf16))
    tmgr.save_full(1, _tstate(s1, bf16))
    for v, s in ((2, s2), (3, s3)):
        jmgr.save_delta(v, _jstate(s, bf16))
        tmgr.save_delta(v, _tstate(s, bf16))
        for name in ("w", "b"):
            assert tmgr._recon[name].numpy().tobytes() == jmgr._recon[name].tobytes(), (v, name)

    stores = {"j": (JAsymStore(JFileBlade(jdir)), AsymStore(FileBlade(jdir))),
              "t": (JAsymStore(JFileBlade(tdir)), AsymStore(FileBlade(tdir)))}
    for v in (1, 2, 3):
        for name in ("w", "b", "step"):
            outs = [_bits(st.read_tensor(v, name)[0]) for pair in stores.values() for st in pair]
            assert len(set(outs)) == 1, (v, name)
    man = stores["t"][1].manifest(3)
    assert man["base"] == 2 and man["tensors"]["w"]["kind"] == "delta"
    assert man["tensors"]["step"]["kind"] == "full"
    assert man["tensors"]["b"]["dtype"] == ("bfloat16" if bf16 else "float32")
    assert jmgr.resume_plan()[0] == tmgr.resume_plan()[0] == 1


def test_delta_view_advances_by_the_applied_entries_only():
    """The view after a delta is base + applied (not state - residual); the
    untransmitted remainder is retried by the next delta.  Without delta
    commits no view is kept, and a delta falls back to a full version."""
    off = CheckpointManager(AsymStore(MemoryBlade()))
    off.save_full(1, {"w": torch.zeros(8)})
    off.save_delta(2, {"w": torch.ones(8)})
    assert off._recon is None and [c["kind"] for c in off.commits] == ["full", "full"]
    mgr = CheckpointManager(AsymStore(MemoryBlade()), delta_every=1, delta_topk_frac=0.001)
    base = torch.zeros(2048)
    mgr.save_full(1, {"w": base})
    moved = torch.linspace(-1, 1, 2048)
    mgr.save_delta(2, {"w": moved})
    view = mgr._recon["w"]
    d = moved - base
    vals, idx, _ = TR.topk_compress_reference(d, 1)
    want = base + TR.topk_decompress_reference(vals, idx, 2048)
    assert torch.equal(view, want) and int((view != 0).sum()) == 2
    mgr.save_delta(3, {"w": moved})
    assert int((mgr._recon["w"] != 0).sum()) == 4
    assert "view_s" in mgr.commits[0] and "compress_s" in mgr.commits[-1]
    got = mgr.store.read_tensor(3, "w")[0]
    assert torch.equal(got, mgr._recon["w"])
