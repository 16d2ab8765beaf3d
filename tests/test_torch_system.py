"""The port's whole lifecycle on the CPU, as tests/test_system.py runs the
JAX package's: train -> commit -> crash -> serve a committed version ->
bitwise resume from the primary -> mirror takeover; and train states that
cross the two packages.

Tolerances: resume is held bit for bit (both packages promise it).  A
train state committed by JAX and resumed by the port is restored bit for
bit; the next step's loss, computed by each package from that state on the
same batch in float32, agrees within 1e-5 (a mean of ~6; summation order).
"""

import jax  # noqa: F401  (the JAX package runs on the CPU beside the port)
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import DataConfig as JDataConfig
from repro.models import DecoderLM as JDecoderLM
from repro.statestore import AsymStore as JAsymStore
from repro.statestore import CheckpointManager as JCheckpointManager
from repro.statestore import FileBlade as JFileBlade
from repro.statestore.checkpoint import flatten_named as j_flatten_named
from repro.training import OptConfig as JOptConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import Trainer as JTrainer
from repro.training import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig
from repro_torch.kernels import log_checksum
from repro_torch.models import DecoderLM
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.statestore import AsymStore, CheckpointManager, FileBlade, MemoryBlade
from repro_torch.training import OptConfig, TrainConfig, Trainer, TrainerConfig
from repro_torch.tree import flatten_named, to_numpy, tree_map_named


def _bits(tree):
    return [(n, to_numpy(t).tobytes()) for n, t in flatten_named(tree)]


@pytest.mark.parametrize("opt,momentum,delta_every", [
    ("adamw", "float32", 0),        # tests/test_system.py::test_full_lifecycle
    ("adafactor", "bfloat16", 3),   # the chip's lifecycle: deltas between full versions
])
def test_full_lifecycle(tmp_path, opt, momentum, delta_every):
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = DecoderLM(cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=4, seq_len=24)
    tcfg = TrainConfig(opt=OptConfig(kind=opt, lr=1e-3, momentum_dtype=momentum))
    primary, mirror = str(tmp_path / "blade"), str(tmp_path / "mirror")

    def mgr(path, mirrors=None):
        return CheckpointManager(AsymStore(FileBlade(path, mirrors=mirrors)), full_every=4,
                                 delta_every=delta_every)

    # --- phase 1: train, then "crash" (drop the trainer object)
    ckpt = mgr(primary, [mirror])
    tr = Trainer(model, tcfg, dcfg, ckpt=ckpt, seed=9, device="cpu")
    tr.init()
    tr.run(TrainerConfig(total_steps=8))
    at_8 = {n: t.clone() for n, t in flatten_named(tr.state["params"])}
    tr.run(TrainerConfig(total_steps=10))
    want = _bits(tr.state)
    kinds = [c["kind"] for c in ckpt.commits]
    # a delta before any full version is a full one, as in the JAX package
    assert kinds == (["full"] * 2 if not delta_every else ["full", "full", "delta", "full", "delta"])
    assert all(c["checksum_s"] >= 0 and c["write_s"] > 0 and c["fsync_s"] > 0
               for c in ckpt.commits)
    del tr

    # --- phase 2: serving reads a committed version while training is down
    scfg = ServeConfig(batch_slots=2, max_new_tokens=4)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    eng = ServeEngine.load_from_store(model, mgr(primary), scfg, device="cpu")
    toks, stats = eng.generate(prompts)
    latest = 9 if delta_every else 8
    assert toks.shape == (2, 10) and stats["version"] == latest and stats["logits_finite"]
    eng8 = ServeEngine.load_from_store(model, mgr(primary), scfg, version=8, device="cpu")
    assert all(torch.equal(t, at_8[n]) for n, t in flatten_named(eng8.params))
    held = ServeEngine(model, tree_map_named(lambda n, _: at_8[n], model.abstract()), scfg,
                       device="cpu").generate(prompts)[0]
    np.testing.assert_array_equal(eng8.generate(prompts)[0], held)

    # --- phase 3: replacement front-end resumes; end state bitwise equal
    tr2 = Trainer(model, tcfg, dcfg, ckpt=mgr(primary), seed=9, device="cpu")
    start = tr2.resume()
    assert start == 8
    tr2.run(TrainerConfig(total_steps=10), start_step=start)
    assert _bits(tr2.state) == want

    # --- phase 4: permanent blade loss -> promote the mirror
    tr3 = Trainer(model, tcfg, dcfg, ckpt=mgr(mirror), seed=9, device="cpu")
    start3 = tr3.resume()
    assert start3 >= 8
    tr3.run(TrainerConfig(total_steps=10), start_step=start3)
    assert _bits(tr3.state) == want


def test_jax_train_state_resumes_in_the_port(tmp_path):
    """JAX trains 4 steps and commits its whole train state (params, AdamW
    moments, step); the port's trainer resumes it bit for bit, and its next
    step's loss matches JAX's on the same state and batch."""
    jcfg = j_get_smoke_config("llama3.2-3b", dtype="float32")
    cfg = get_smoke_config("llama3.2-3b", dtype="float32")
    dkw = dict(vocab_size=cfg.vocab_size, global_batch=4, seq_len=16)
    blade = str(tmp_path / "b")
    jtr = JTrainer(JDecoderLM(jcfg), JTrainConfig(opt=JOptConfig(lr=1e-3)), JDataConfig(**dkw),
                   ckpt=JCheckpointManager(JAsymStore(JFileBlade(blade)), full_every=4), seed=3)
    jtr.init()
    jtr.run(JTrainerConfig(total_steps=4))
    jwant = {n: np.array(a) for n, a in j_flatten_named(jtr.state)}  # the step donates them
    jtr.run(JTrainerConfig(total_steps=5))
    jloss = jtr.metrics_log[-1]["loss"]

    tr = Trainer(DecoderLM(cfg), TrainConfig(opt=OptConfig(lr=1e-3)), DataConfig(**dkw),
                 ckpt=CheckpointManager(AsymStore(FileBlade(blade)), full_every=4), seed=3,
                 device="cpu")
    assert tr.resume() == 4
    got = dict(flatten_named(tr.state))
    assert sorted(got) == sorted(jwant)
    for name, arr in jwant.items():
        assert to_numpy(got[name]).tobytes() == np.asarray(arr).tobytes(), name
    out = tr.run(TrainerConfig(total_steps=5))
    assert out["final_step"] == 5
    assert abs(out["metrics"][-1]["loss"] - jloss) <= 1e-5


def test_commit_snapshots_before_returning_and_records_its_split(tmp_path):
    """PyTorch updates the state in place, so an async commit must copy (and
    checksum) before it returns: a write after save_full does not reach the
    version.  Each commit records checksum, copy, write and fsync seconds."""
    ckpt = CheckpointManager(AsymStore(FileBlade(str(tmp_path / "b"))), async_commit=True)
    w = torch.arange(5000, dtype=torch.float32)
    ckpt.save_full(1, {"w": w})
    w.add_(1.0)  # the optimizer's in-place update of the next step
    ckpt.wait()
    assert torch.equal(ckpt.store.read_tensor(1, "w")[0], torch.arange(5000, dtype=torch.float32))
    rec = ckpt.commits[0]
    assert rec["kind"] == "full" and rec["bytes"] == 20000
    assert {"checksum_s", "d2h_s", "write_s", "fsync_s", "commit_s"} <= set(rec)
    ckpt.close()


def test_device_checksums_are_verified_on_read(tmp_path):
    """A commit may bring its objects' checksums (the card's fletcher32_wave);
    the blade stores them as given and get() verifies on the host, so a wrong
    one fails on the first read."""
    t = torch.arange(100, dtype=torch.float32)
    good = int(log_checksum.fletcher32_wave([log_checksum.as_bytes(t)])[0])
    store = AsymStore(FileBlade(str(tmp_path / "b"), mirrors=[str(tmp_path / "m")]))
    store.commit_version(1, {"w": [t]}, checksums={"w": [good]})
    store.commit_version(2, {"w": [t]}, checksums={"w": [good ^ 1]})
    for path in ("b", "m"):
        again = AsymStore(FileBlade(str(tmp_path / path)))
        assert torch.equal(again.read_tensor(1, "w")[0], t)
        with pytest.raises(IOError):
            again.read_tensor(2, "w")
    mem = AsymStore(MemoryBlade())
    mem.commit_version(1, {"w": [t]}, checksums={"w": [good]})
    assert torch.equal(mem.read_tensor(1, "w")[0], t)


def test_train_cli_commits_and_resumes_on_cpu(tmp_path):
    from repro_torch.launch import train

    args = ["--device", "cpu", "--arch", "llama3.2-3b", "--seq-len", "16",
            "--store", str(tmp_path / "b"), "--mirror", str(tmp_path / "m"),
            "--full-every", "2", "--delta-every", "3"]
    first = train.main(args + ["--steps", "4"])
    assert first["final_step"] == 4 and first["all_finite"]
    again = train.main(args + ["--steps", "6", "--resume"])
    assert again["final_step"] == 6 and len(again["losses"]) == 2
    store = AsymStore(FileBlade(str(tmp_path / "m")))
    assert store.latest_version() == 6
