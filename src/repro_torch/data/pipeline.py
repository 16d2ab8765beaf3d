"""Deterministic, stateless synthetic data pipeline.

The port's own copy of ``repro.data.pipeline``: `batch_at(step)` is a pure
function of (seed, step, host) built on numpy's Philox counter-based
generator, so batches are byte-identical to the JAX package's for every
(seed, step, host, embed_dim), and

  * resume/replay is bitwise identical (the statestore's step-log recovery
    re-executes steps without any pipeline state to restore);
  * hosts shard the global batch without coordination;
  * a straggler or restarted host can fast-forward to any step in O(1).

Batches are numpy arrays on the host; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    embed_dim: int = 0       # >0: emit stub embeddings instead of tokens


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} is not a multiple of "
                             f"{cfg.n_hosts} hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.Generator(
            np.random.Philox(key=c.seed, counter=(step << 16) | c.host_id)
        )
        labels = rng.integers(0, c.vocab_size, (self.local_batch, c.seq_len), dtype=np.int32)
        if c.embed_dim:
            emb = rng.standard_normal((self.local_batch, c.seq_len, c.embed_dim), dtype=np.float32)
            return {"embeds": emb, "labels": labels}
        tokens = rng.integers(0, c.vocab_size, (self.local_batch, c.seq_len), dtype=np.int32)
        return {"tokens": tokens, "labels": labels}
