"""The port's serving engine and CLI: the same greedy tokens as the JAX
engine from one store version, hot reload, the CPU entry point, and an
import graph free of JAX."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import DecoderLM as JDecoderLM
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServeEngine as JServeEngine
from repro.statestore import AsymStore as JAsymStore
from repro.statestore import CheckpointManager as JCheckpointManager
from repro.statestore import FileBlade as JFileBlade
from repro.statestore.checkpoint import flatten_named as j_flatten_named
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import DecoderLM
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.models.convert import params_from_numpy
from repro_torch.statestore import AsymStore, CheckpointManager, FileBlade, MemoryBlade

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _commit_two_versions(path):
    """JAX commits versions 5 and 10 of llama3.2-3b smoke weights (float32)."""
    jm = JDecoderLM(j_get_smoke_config("llama3.2-3b", dtype="float32"))
    jmgr = JCheckpointManager(JAsymStore(JFileBlade(str(path))))
    for step, seed in ((5, 0), (10, 1)):
        jmgr.save_full(step, {"params": jm.init(jax.random.PRNGKey(seed))})
    return jm, jmgr


def test_jax_and_port_engines_serve_the_same_greedy_tokens(tmp_path):
    jm, jmgr = _commit_two_versions(tmp_path / "blade")
    prompts = np.random.default_rng(0).integers(0, 512, (3, 8)).astype(np.int32)
    jeng = JServeEngine.load_from_store(jm, jmgr, JServeConfig(batch_slots=4, max_new_tokens=6),
                                        version=5)
    want, _ = jeng.generate(prompts)

    model = DecoderLM(get_smoke_config("llama3.2-3b", dtype="float32"))
    ckpt = CheckpointManager(AsymStore(FileBlade(str(tmp_path / "blade"))))
    eng = ServeEngine.load_from_store(model, ckpt, ServeConfig(batch_slots=4, max_new_tokens=6),
                                      version=5, device="cpu")
    got, stats = eng.generate(prompts)
    assert eng.version == stats["version"] == 5
    assert got.shape == (3, 14) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["decode_steps"] == 6


def test_reload_moves_to_the_newer_version(tmp_path):
    jm, jmgr = _commit_two_versions(tmp_path / "blade")
    prompts = np.random.default_rng(1).integers(0, 512, (2, 8)).astype(np.int32)
    model = DecoderLM(get_smoke_config("llama3.2-3b", dtype="float32"))
    ckpt = CheckpointManager(AsymStore(FileBlade(str(tmp_path / "blade"))))
    eng = ServeEngine.load_from_store(model, ckpt, ServeConfig(batch_slots=2, max_new_tokens=4),
                                      version=5, device="cpu")
    assert eng.reload(ckpt) == 10
    got, stats = eng.generate(prompts)
    assert stats["version"] == 10
    jeng = JServeEngine.load_from_store(jm, jmgr, JServeConfig(batch_slots=2, max_new_tokens=4))
    np.testing.assert_array_equal(got, np.asarray(jeng.generate(prompts)[0]))


def test_sampling_and_eos_on_the_cpu():
    model = DecoderLM(get_smoke_config("qwen1.5-0.5b", dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(2).integers(0, 512, (2, 5)).astype(np.int32)
    eng = ServeEngine(model, params, ServeConfig(batch_slots=2, max_new_tokens=5, greedy=False),
                      device="cpu")
    a, _ = eng.generate(prompts, torch.Generator().manual_seed(7))
    b, _ = eng.generate(prompts, torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(a, b)  # the generator fixes the draws
    assert a.shape == (2, 10) and ((a >= 0) & (a < 512)).all()
    greedy = ServeEngine(model, params, ServeConfig(batch_slots=2, max_new_tokens=5),
                         device="cpu").generate(prompts)[0]
    # EOS = row 0's first greedy token: row 0 emits it, then only repeats it
    eos = ServeEngine(model, params, ServeConfig(batch_slots=2, max_new_tokens=5,
                                                 eos_id=int(greedy[0, 5])), device="cpu")
    toks, stats = eos.generate(prompts)
    assert toks[0, 5] == greedy[0, 5]
    assert stats["decode_steps"] <= 5 and (toks[0, 5:] == greedy[0, 5]).all()


def test_launch_serve_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen1.5-0.5b",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--max-new", "3",
         "--requests", "2"],
        env=ENV, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[serve] 12 tokens in" in out.stdout and "on cpu" in out.stdout


def test_launch_serve_from_a_store_on_the_cpu(tmp_path):
    _commit_two_versions(tmp_path / "blade")
    stats = serve.main(["--arch", "llama3.2-3b", "--store", str(tmp_path / "blade"),
                        "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                        "--max-new", "2", "--requests", "1"])
    assert stats["tokens"] == 4 and stats["decode_steps"] == [2]


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    model = DecoderLM(get_smoke_config("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, {}, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "llama3.2-3b", "--requests", "1"])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_jax_and_port_engines_serve_the_recurrent_models_alike(arch):
    """Greedy tokens of the fp32 smoke models, the weights carried across;
    the prompt outruns recurrentgemma's smoke window (64), so prefill rolls
    the ring and decode wraps it."""
    jm = JDecoderLM(j_get_smoke_config(arch, dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(3))
    model = DecoderLM(get_smoke_config(arch, dtype="float32"))
    params = params_from_numpy({n: np.asarray(a) for n, a in j_flatten_named(jp)}, model, "cpu")
    prompts = np.random.default_rng(4).integers(0, 512, (2, 70)).astype(np.int32)
    want, _ = JServeEngine(jm, jp, JServeConfig(batch_slots=2, max_new_tokens=6)).generate(prompts)
    got, stats = ServeEngine(model, params, ServeConfig(batch_slots=2, max_new_tokens=6),
                             device="cpu").generate(prompts)
    assert stats["logits_finite"]
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_launch_serve_runs_the_recurrent_models_on_the_cpu(arch):
    stats = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                        "--max-new", "3", "--requests", "2"])
    assert stats["tokens"] == 12 and stats["decode_steps"] == [3, 3] and stats["logits_finite"]


def test_init_cache_and_restore_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults land on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecoderLM(get_smoke_config("falcon-mamba-7b")).init_cache(1, 4)
    mgr = CheckpointManager(AsymStore(MemoryBlade()))
    mgr.save_full(1, {"w": torch.arange(3.0)})
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore({"w": torch.empty(3, device="meta")})
    _, state = mgr.restore({"w": torch.empty(3, device="meta")}, device="cpu")
    assert state["w"].device.type == "cpu"
    _, state = mgr.restore({"w": torch.empty(3)})  # a CPU template stays on the CPU
    assert state["w"].device.type == "cpu" and state["w"].tolist() == [0.0, 1.0, 2.0]


def test_port_imports_no_jax_and_nothing_of_repro():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    assert {"repro_torch.kernels.flash_attention", "repro_torch.kernels.mamba_scan",
            "repro_torch.kernels.rglru_scan", "repro_torch.serving.engine",
            "repro_torch.launch.serve", "repro_torch.cluster.router",
            "repro_torch.cluster.sharded", "repro_torch.faults.harness",
            "repro_torch.core.apps.tatp", "repro_torch.obs.report"} <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes', 'repro') "
            "or m.startswith(('jax.', 'ml_dtypes.', 'repro.')))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    # the card's smoke script too: no import of jax, ml_dtypes or repro
    for path in [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "ml_dtypes", "repro"), (path, line)
