"""Training loop: deterministic steps + asymmetric-store fault tolerance.

The port of ``repro.training.trainer``.  Per step: (1) append the step log
(the op-log-first rule), (2) run the train step, (3) read its metrics on the
host (a device sync, as JAX's ``float(v)``), (4) feed the straggler
watchdog, (5) let the checkpoint manager apply its full/delta cadence.

Resume: `Trainer.resume()` reads the store's resume plan — last exact
version + the step logs after it — restores, and the caller re-executes
those steps; the stateless pipeline makes the replay bitwise identical to
the lost run.  On the card that needs deterministic kernels: the port's
attention kernels use no atomics, and `Trainer.run` runs its steps under
``torch.use_deterministic_algorithms`` (the embedding and cross-entropy
backward) and puts the process's setting back when it returns.  cuBLAS
also needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which it reads when it
first starts: that is the entry point's to set, before its first CUDA work
(``launch/train.py`` does); without it PyTorch refuses the step's products
in deterministic mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..data.pipeline import DataConfig, SyntheticPipeline
from ..device import resolve_device
from ..models.model import DecoderLM
from ..statestore import CheckpointManager
from .train_step import TrainConfig, abstract_train_state, init_train_state, make_train_step

CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic_cuda() -> Iterator[None]:
    """Deterministic algorithms for every CUDA op inside the block, and the
    caller's settings back after it.  Our kernels write every element they
    allocate, so uninitialised memory is not filled (the fill would add a
    pass over each new tensor)."""
    det = torch.utils.deterministic
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(), det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        det.fill_uninitialized_memory = saved[2]


class StragglerWatchdog:
    """Flags steps slower than `tolerance` x the rolling median.

    On a real fleet this feeds the controller that triggers hot-spares /
    shard migration; here it records the events (and the trainer exposes
    them) so the policy is testable.
    """

    def __init__(self, tolerance: float = 3.0, window: int = 32):
        self.tolerance = tolerance
        self.durations: List[float] = []
        self.window = window
        self.events: List[Dict[str, Any]] = []

    def observe(self, step: int, seconds: float) -> bool:
        hist = self.durations[-self.window:]
        slow = False
        if len(hist) >= 8:
            med = float(np.median(hist))
            if seconds > self.tolerance * med:
                slow = True
                self.events.append({"step": step, "seconds": seconds, "median": med})
        self.durations.append(seconds)
        return slow


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100


class Trainer:
    def __init__(
        self,
        model: DecoderLM,
        tcfg: TrainConfig,
        data_cfg: DataConfig,
        ckpt: Optional[CheckpointManager] = None,
        seed: int = 0,
        device=None,
    ):
        self.model = model
        self.tcfg = tcfg
        self.pipeline = SyntheticPipeline(data_cfg)
        self.ckpt = ckpt
        self.seed = seed
        self.device = resolve_device(device)
        self.watchdog = StragglerWatchdog()
        self._step_fn = make_train_step(model, tcfg)
        self.state: Optional[Dict[str, Any]] = None
        self.metrics_log: List[Dict[str, float]] = []
        self._preempted = False

    # ----------------------------------------------------------------- setup
    def init(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.state = init_train_state(self.model, gen, self.tcfg)

    def install_preemption_handler(self, sig=signal.SIGTERM) -> None:
        """SIGTERM -> finish the current step, commit, exit cleanly."""

        def handler(signum, frame):
            self._preempted = True

        signal.signal(sig, handler)

    # ------------------------------------------------------------------ run
    def run(self, cfg: TrainerConfig, start_step: Optional[int] = None) -> Dict[str, Any]:
        if self.state is None:
            raise RuntimeError("call init() or resume() first")
        start = int(start_step if start_step is not None else self.state["step"])
        with deterministic_cuda() if self.device.type == "cuda" else contextlib.nullcontext():
            self._steps(start, cfg.total_steps)
        return {"final_step": int(self.state["step"]), "metrics": self.metrics_log,
                "straggler_events": self.watchdog.events}

    def _steps(self, start: int, stop: int) -> None:
        for step in range(start, stop):
            if self.ckpt:
                self.ckpt.log_step(step, {"seed": self.seed})
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.batch_at(step).items()}
            t0 = time.monotonic()
            self.state, metrics = self._step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self.watchdog.observe(step, dt)
            self.metrics_log.append({"step": step, **metrics, "seconds": dt})
            if self.ckpt:
                self.ckpt.maybe_save(step + 1, self.state,
                                     {"seed": self.seed, "kind": "train_state"})
            if self._preempted:
                if self.ckpt:
                    self.ckpt.save_full(step + 1, self.state, {"seed": self.seed,
                                                               "preempted": True})
                    self.ckpt.wait()
                break
        if self.ckpt:
            self.ckpt.wait()

    # --------------------------------------------------------------- resume
    def resume(self) -> int:
        """Restore the last exact version and return the step to continue
        from; the caller re-runs from there (replay == continue, because the
        pipeline and train_step are deterministic in `step`)."""
        if self.ckpt is None:
            raise RuntimeError("resume needs a checkpoint manager")
        full_v, _ = self.ckpt.resume_plan()
        template = abstract_train_state(self.model, self.tcfg)
        _, self.state = self.ckpt.restore(template, version=full_v, device=self.device)
        return int(self.state["step"])
