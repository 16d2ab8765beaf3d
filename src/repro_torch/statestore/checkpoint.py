"""Checkpoint manager: the front-end side of the asymmetric state store.

The reader's side of ``repro.statestore.checkpoint`` and its full commits:

  * every training step appends a tiny **step log** (step, rng seed, data
    cursor) before the step result is considered durable;
  * ``save_full`` commits the full state as a new immutable **version**;
  * ``restore`` reads a version (full, or a delta applied to its base)
    onto the names, dtypes and device of a template;
  * exact resume = latest full version + the step logs recorded after it.

State is a nested dict/list of tensors; names are the JAX pytree paths, so
a version committed by either package restores in the other.  Delta
commits (``save_delta``) are the training side's and are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..tree import flatten_named, tree_map_named
from .store import AsymStore

Tree = Any


class CheckpointManager:
    def __init__(self, store: AsymStore, *, keep: int = 2):
        self.store = store
        self.keep = keep

    # ------------------------------------------------------------- step log
    def log_step(self, step: int, meta: Optional[Dict[str, Any]] = None) -> None:
        rec = {"step": int(step)}
        rec.update(meta or {})
        self.store.append_step_log(rec)

    # ----------------------------------------------------------------- save
    def save_full(self, step: int, state: Tree, meta=None) -> None:
        """Copy every tensor to the host and commit a full version."""
        tensors: Dict[str, List[torch.Tensor]] = {}
        shard_meta: Dict[str, Any] = {}
        for name, leaf in flatten_named(state):
            t = leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            tensors[name] = [t]
            shard_meta[name] = {"global_shape": list(t.shape), "sharding": ""}
        m = dict(meta or {})
        m["shard_meta"] = shard_meta
        m["step"] = int(step)
        self.store.commit_version(step, tensors, meta=m)
        self.store.gc(keep=self.keep)

    # -------------------------------------------------------------- restore
    def restore(self, template: Tree, version: Optional[int] = None,
                device: Optional[torch.device] = None) -> Tuple[int, Tree]:
        """Restore state onto the structure and dtypes of `template` (tensors,
        ``meta`` tensors included), on `device` (default: each template
        tensor's own device; a ``meta`` tensor's goes to the card, as every
        entry point does unless it is given the CPU)."""
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
        full_v = 0
        for cand in reversed(self.store.committed_versions()):
            kinds = {e["kind"] for e in self.store.manifest(cand)["tensors"].values()}
            if "delta" not in kinds:
                full_v = cand
                break
        return full_v, self.store.pending_step_logs(full_v)
