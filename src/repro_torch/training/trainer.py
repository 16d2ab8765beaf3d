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

On a mesh (``Trainer(..., rules, mesh)``) every rank runs the same loop: the
state is placed on the mesh at `init` and at `resume` (``models.params
.place``), each rank of the batch axes draws its own slice of the global
batch (``n_hosts`` = their size, ``host_id`` = its index), and the commits
write the full tensors from one writer, rank 0, after every rank has
gathered them: the store holds the bytes a mesh-less commit would, so a
version restores in a reader with or without a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..data.pipeline import DataConfig, SyntheticPipeline
from ..device import mesh_device, resolve_device
from ..models.model import DecoderLM
from ..models.params import logical_to_spec, place
from ..statestore import CheckpointManager
from ..tree import tree_map
from .train_step import (TrainConfig, abstract_train_state, init_train_state, make_train_step,
                         state_shardings)

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
        rules: Optional[Dict] = None,
        mesh=None,
        seed: int = 0,
        device=None,
    ):
        self.model = model
        self.tcfg = tcfg
        self.ckpt = ckpt
        self.rules = rules or {}
        self.mesh = mesh
        self.seed = seed
        if mesh is None:
            self.device = resolve_device(device)
            self._batch_dims: List[int] = []
        else:
            self.device = mesh_device(mesh)
            part = (logical_to_spec(("act_batch",), self.rules) or (None,))[0]
            axes = (part,) if isinstance(part, str) else tuple(part or ())
            self._batch_dims = [mesh.mesh_dim_names.index(a) for a in axes
                                if a in mesh.mesh_dim_names]
            n_hosts, host_id = 1, 0
            for i in self._batch_dims:  # major first, as DTensor splits a dim
                n_hosts *= mesh.size(i)
                host_id = host_id * mesh.size(i) + mesh.get_coordinate()[i]
            if data_cfg.global_batch % n_hosts:
                raise ValueError(f"global batch {data_cfg.global_batch} is not a multiple of "
                                 f"the {n_hosts} ranks of the batch axes {axes}")
            data_cfg = dataclasses.replace(data_cfg, n_hosts=n_hosts, host_id=host_id)
        self.pipeline = SyntheticPipeline(data_cfg)
        self.watchdog = StragglerWatchdog()
        self._step_fn = make_train_step(model, tcfg, self.rules, mesh)
        self.state: Optional[Dict[str, Any]] = None
        self.metrics_log: List[Dict[str, float]] = []
        self._preempted = False

    # ----------------------------------------------------------------- setup
    def init(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.state = self._place(init_train_state(self.model, gen, self.tcfg))

    def _place(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The state on the mesh (every rank holds it whole; each keeps its
        shards), or as it is without one."""
        if self.mesh is None:
            return state
        return place(state, state_shardings(self.model, self.tcfg, self.rules, self.mesh),
                     self.mesh)

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        """This rank's slice of the global batch of `step` (the whole batch
        without a mesh), as DTensors sharded on the batch axes on a mesh."""
        local = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.pipeline.batch_at(step).items()}
        if self.mesh is None:
            return local
        pl = [Shard(0) if i in self._batch_dims else Replicate() for i in range(self.mesh.ndim)]
        return {k: DTensor.from_local(v, self.mesh, pl, run_check=False) for k, v in local.items()}

    def _writer(self) -> bool:
        """Whether this rank writes the store: the only rank without a mesh,
        rank 0 with one (SWMR)."""
        return self.mesh is None or dist.get_rank() == 0

    def _full(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The state with every DTensor gathered whole (every rank takes
        part; only the writer uses it)."""
        if self.mesh is None:
            return state
        return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, state)

    def install_preemption_handler(self, sig=signal.SIGTERM) -> None:
        """SIGTERM -> finish the current step, commit, exit cleanly."""

        def handler(signum, frame):
            self._preempted = True

        signal.signal(sig, handler)

    # ------------------------------------------------------------------ run
    def run(self, cfg: TrainerConfig, start_step: Optional[int] = None) -> Dict[str, Any]:
        if self.state is None:
            raise RuntimeError("call init() or resume() first")
        start = int(start_step if start_step is not None else self._step())
        with deterministic_cuda() if self.device.type == "cuda" else contextlib.nullcontext():
            self._steps(start, cfg.total_steps)
        return {"final_step": self._step(), "metrics": self.metrics_log,
                "straggler_events": self.watchdog.events}

    def _steps(self, start: int, stop: int) -> None:
        for step in range(start, stop):
            if self.ckpt and self._writer():
                self.ckpt.log_step(step, {"seed": self.seed})
            batch = self._batch(step)
            t0 = time.monotonic()
            self.state, metrics = self._step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self.watchdog.observe(step, dt)
            self.metrics_log.append({"step": step, **metrics, "seconds": dt})
            if self.ckpt and self.ckpt.due(step + 1):
                full = self._full(self.state)
                if self._writer():
                    self.ckpt.maybe_save(step + 1, full,
                                         {"seed": self.seed, "kind": "train_state"})
                del full
            if self._preempted:
                if self.ckpt:
                    full = self._full(self.state)
                    if self._writer():
                        self.ckpt.save_full(step + 1, full, {"seed": self.seed,
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
        _, state = self.ckpt.restore(template, version=full_v, device=self.device)
        self.state = self._place(state)
        return self._step()

    def _step(self) -> int:
        step = self.state["step"]
        return int(step.to_local() if isinstance(step, DTensor) else step)
