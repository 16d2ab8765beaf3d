"""Checkpoint manager: the front-end side of the asymmetric state store.

The port of ``repro.statestore.checkpoint``.  Recovery contract (the
paper's op-log/memory-log split):

  * every training step appends a tiny **step log** (step, rng seed, data
    cursor) BEFORE the step result is considered durable — the paper's
    "operation log first";
  * every `full_every` steps the full state is committed as a new immutable
    **version** (the batched memory-log flush);
  * optional **delta commits** between full versions store top-k compressed
    deltas against the store's view of the state — cheap, frequent,
    *approximate* snapshots for serving freshness (exact resume never reads
    them);
  * exact resume = latest full version + deterministic re-execution of the
    steps named by the pending step logs.

State is a nested dict/list of tensors; names are the JAX pytree paths, so
a version committed by either package restores in the other.

Where the work runs: the state lives on the card.  A commit checksums its
objects there, in one ``fletcher32_wave`` launch over the tensors' bytes,
and a delta commit compresses ``state - view`` there with ``topk_compress``;
then the objects are copied to the host.  Only the writes (objects,
MANIFEST, ROOT swap) may run on the worker thread of ``async_commit``.
PyTorch updates the state in place (``training/optimizer.py``), so
``save_full`` and ``save_delta`` take their snapshot, checksums included,
before they return.  The delta base view (fp32, as in the JAX package) is
kept on the host, and only when delta commits are on (``delta_every > 0``;
the JAX package keeps it always): without it, ``save_delta`` commits a full
version, as both packages do before their first full commit.  It costs 4
bytes a floating element of the state, which the card could not spare for
the published llama3.2-3b under AdamW (~38 GB beside a ~64 GB step), so a
delta commit copies one leaf's view at a time to the state's device,
compresses there and copies the advanced view back.  ``commits`` records
each commit's seconds: checksum (on the device, synchronised),
device-to-host copy, write and fsync; with delta commits on, the view's
making (``view_s``, a full commit) or its round trip with the compression
(``compress_s``, a delta).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..kernels.log_checksum import as_bytes
from ..tree import dtype_name, flatten_named, tree_map_named
from .store import AsymStore

Tree = Any
DELTA_BLOCK = 1024


def _tensor(leaf: Any) -> torch.Tensor:
    return leaf.detach() if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))


class CheckpointManager:
    def __init__(
        self,
        store: AsymStore,
        *,
        full_every: int = 100,
        delta_every: int = 0,
        delta_topk_frac: float = 0.01,
        keep: int = 2,
        async_commit: bool = False,
    ):
        self.store = store
        self.full_every = full_every
        self.delta_every = delta_every
        self.delta_topk_frac = delta_topk_frac
        self.keep = keep
        self.async_commit = async_commit
        self._recon: Optional[Dict[str, torch.Tensor]] = None  # delta base view
        self._view_version: Optional[int] = None  # the version the view equals
        self.commits: List[Dict[str, Any]] = []
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        if async_commit:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ---------------------------------------------------------------- async
    def _drain(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            job()

    def _submit(self, job: Callable[[], None]):
        if self.async_commit:
            self._q.put(job)
        else:
            job()

    def wait(self):
        """Barrier: all queued commits durable."""
        if self.async_commit and self._worker:
            done = threading.Event()
            self._q.put(done.set)
            done.wait()

    def close(self):
        if self.async_commit and self._worker:
            self._q.put(None)
            self._worker.join()
            self._worker = None

    # ------------------------------------------------------------- step log
    def log_step(self, step: int, meta: Optional[Dict[str, Any]] = None) -> None:
        rec = {"step": int(step)}
        rec.update(meta or {})
        self.store.append_step_log(rec)

    # ----------------------------------------------------------------- save
    def due(self, step: int) -> Optional[str]:
        """The commit the cadence makes at `step`: "full", "delta" or None."""
        if self.full_every and step % self.full_every == 0 and step > 0:
            return "full"
        if self.delta_every and step % self.delta_every == 0 and step > 0:
            return "delta"
        return None

    def maybe_save(self, step: int, state: Tree, meta=None) -> Optional[str]:
        """Policy entry point: full/delta cadence."""
        kind = self.due(step)
        if kind == "full":
            self.save_full(step, state, meta)
        elif kind == "delta":
            self.save_delta(step, state, meta)
        return kind

    def _snapshot(self, objects: List[Tuple[str, torch.Tensor]], rec: Dict[str, Any]
                  ) -> Tuple[Dict[str, int], Dict[str, torch.Tensor]]:
        """Checksums of the objects' bytes, in one wave on their device, then
        their host copies (new memory: the state may change after this
        returns)."""
        t0 = time.perf_counter()
        tensors = [t.contiguous() for _, t in objects]
        csums = ops.fletcher32_wave([as_bytes(t) for t in tensors]).tolist()  # synchronises
        t1 = time.perf_counter()
        host = {name: t.to("cpu", copy=True) for (name, _), t in zip(objects, tensors)}
        rec["checksum_s"], rec["d2h_s"] = t1 - t0, time.perf_counter() - t1
        rec["bytes"] = sum(t.numel() * t.element_size() for t in tensors)
        return dict(zip((name for name, _ in objects), csums)), host

    def _commit(self, rec: Dict[str, Any], commit: Callable[[], None]) -> None:
        """Runs `commit` (now, or on the worker) and records its write and
        fsync seconds in `rec`."""
        self.commits.append(rec)

        def job():
            before = self.store.blade.io_totals()
            t0 = time.perf_counter()
            commit()
            after = self.store.blade.io_totals()
            rec["commit_s"] = time.perf_counter() - t0
            rec.update({k: after[k] - before[k] for k in after})

        self._submit(job)

    def save_full(self, step: int, state: Tree, meta=None) -> None:
        """Snapshot every tensor (checksums on its device, then the copy to
        the host) and commit a full version (the writes may be async)."""
        named = [(name, _tensor(leaf)) for name, leaf in flatten_named(state)]
        rec: Dict[str, Any] = {"version": int(step), "kind": "full"}
        csums, host = self._snapshot(named, rec)
        m = dict(meta or {})
        m["shard_meta"] = {name: {"global_shape": list(t.shape), "sharding": ""}
                           for name, t in named}
        m["step"] = int(step)
        if self.delta_every:  # the view, on the host: 4 bytes a floating element
            t0 = time.perf_counter()
            self._recon = {name: host[name].to(torch.float32, copy=True) for name, t in named
                           if t.is_floating_point()}
            rec["view_s"] = time.perf_counter() - t0
        self._view_version = int(step)
        tensors = {name: [t] for name, t in host.items()}
        checksums = {name: [c] for name, c in csums.items()}

        def commit():
            self.store.commit_version(step, tensors, meta=m, checksums=checksums)
            self.store.gc(keep=self.keep)

        self._commit(rec, commit)

    def save_delta(self, step: int, state: Tree, meta=None) -> None:
        """Top-k compressed delta against the store's view of the state, with
        error feedback: only the sent entries advance the view (``view +
        applied``, as the JAX package), so the un-sent remainder is retried
        next time.  `topk_compress` runs on the state's device, one leaf at a
        time, with that leaf's view copied there and back."""
        if self._recon is None:
            self.save_full(step, state, meta)
            return
        base_version = self._view_version
        k = max(1, int(DELTA_BLOCK * self.delta_topk_frac))
        deltas: Dict[str, Dict[str, Any]] = {}
        objects: List[Tuple[str, torch.Tensor]] = []
        t0 = time.perf_counter()
        for name, leaf in flatten_named(state):
            t = _tensor(leaf)
            base = self._recon.get(name)
            if base is None or not t.is_floating_point():
                objects.append((name, t))
                continue
            flat = base.reshape(-1).to(t.device)
            d = t.float().reshape(-1) - flat
            vals, idx, res = ops.topk_compress(d, k, block=DELTA_BLOCK)
            applied = ops.topk_decompress(vals, idx, t.numel(), block=DELTA_BLOCK)
            self._recon[name] = (flat + applied).view(base.shape).to("cpu")
            del flat, d, res, applied  # one leaf's work on the device at a time
            deltas[name] = {"vals": vals, "idx": idx, "n": t.numel(), "block": DELTA_BLOCK,
                            "dtype": dtype_name(t)}
            objects.append((name, torch.cat([vals.reshape(-1),
                                             idx.view(torch.float32).reshape(-1)])))
        rec: Dict[str, Any] = {"version": int(step), "kind": "delta",
                               "compress_s": time.perf_counter() - t0}
        csums, host = self._snapshot(objects, rec)
        passthrough = {name: [host[name]] for name, _ in objects if name not in deltas}
        for name, d in deltas.items():
            words = host[name]
            nbk = d["vals"].numel()
            d["vals"] = words[:nbk].view(d["vals"].shape)
            d["idx"] = words[nbk:].view(torch.int32).view(d["idx"].shape)
        m = dict(meta or {})
        m["step"] = int(step)
        self._view_version = int(step)
        checksums = {name: [c] for name, c in csums.items()}

        def commit():
            self.store.commit_version(step, passthrough, meta=m, base_version=base_version,
                                      deltas=deltas, checksums=checksums)

        self._commit(rec, commit)

    # -------------------------------------------------------------- restore
    def restore(self, template: Tree, version: Optional[int] = None,
                device: Optional[torch.device] = None) -> Tuple[int, Tree]:
        """Restore state onto the structure and dtypes of `template` (tensors,
        ``meta`` tensors included), on `device` (default: each template
        tensor's own device; a ``meta`` tensor's goes to the card, as every
        entry point does unless it is given the CPU)."""
        self.wait()
        v = version if version is not None else self.store.latest_version()
        if v == 0:
            raise FileNotFoundError("no committed version in store")

        def one(name: str, leaf: torch.Tensor) -> torch.Tensor:
            shards = self.store.read_tensor(v, name)
            t = shards[0] if len(shards) == 1 else torch.cat(shards)
            dev = device if device is not None else (
                resolve_device(None) if leaf.device.type == "meta" else leaf.device)
            return t.to(dev).to(leaf.dtype)  # cast on the target device

        return v, tree_map_named(one, template)

    def resume_plan(self) -> Tuple[int, List[Dict[str, Any]]]:
        """(last committed full version, step logs recorded after it) — the
        trainer re-executes those steps deterministically."""
        self.wait()
        full_v = 0
        for cand in reversed(self.store.committed_versions()):
            kinds = {e["kind"] for e in self.store.manifest(cand)["tensors"].values()}
            if "delta" not in kinds:
                full_v = cand
                break
        return full_v, self.store.pending_step_logs(full_v)
