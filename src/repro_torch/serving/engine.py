"""Serving engine: batched prefill + decode with slot-based batching.

Readers of the asymmetric store: the engine pins a committed version
(`load_from_store`) while training keeps committing new ones — the SWMR
pattern of paper §9 — and can hot-reload to a newer version between
generations.

Batching model: fixed decode slots; a `generate` call admits up to
`batch_slots` equal-length prompts, prefill fills the cache, then all
slots decode in lock-step with per-sequence EOS masking.  The engine runs
on the card unless it is given ``device="cpu"``.

Each ``generate`` call is an ``obs`` span, ``serve.generate`` (attributes:
batch, slots, prompt length, new tokens; counts ``serve.decode_steps``, the
``decode_step`` calls, and ``serve.decode_steps_unused``, those whose logits
no token is taken from), around ``serve.prefill``, one
``serve.decode_step`` a call (its index; ``used``) and ``serve.copy_out``.

On a mesh (``ServeEngine(model, params, cfg, rules, mesh)``) the params are
placed by ``rules``, the prompts and each step's tokens are sharded on the
batch axes, the caches are DTensors placed by leaf name, and every rank
runs the same loop; each step's logits are gathered whole, so every rank
picks the same tokens.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import obs
from ..device import mesh_device, resolve_device
from ..models.model import DecoderLM
from ..models.params import make_shardings, place, placements_of, shard
from ..statestore import CheckpointManager
from ..tree import tree_map


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_new_tokens: int = 32
    eos_id: int = -1            # <0: never stop early
    greedy: bool = True
    temperature: float = 1.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


class ServeEngine:
    def __init__(self, model: DecoderLM, params, cfg: ServeConfig, rules=None, mesh=None,
                 device=None):
        self.model = model
        self.cfg = cfg
        self.rules = rules or {}
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh_device(mesh)
        self.params = self._place(params)
        self.version: Optional[int] = None

    def _place(self, params):
        params = tree_map(lambda t: t.to(self.device), params)
        if self.mesh is None:
            return params
        return place(params, make_shardings(self.model.param_specs(), self.mesh, self.rules),
                     self.mesh)

    def _tokens(self, toks: torch.Tensor) -> torch.Tensor:
        """[B, ...] tokens, on a mesh sharded on the batch axes."""
        if self.mesh is None:
            return toks
        return shard(toks, placements_of(toks.shape, ("act_batch",), self.mesh, self.rules),
                     self.mesh)

    # ----------------------------------------------------------- store reads
    @classmethod
    def load_from_store(cls, model: DecoderLM, ckpt: CheckpointManager,
                        cfg: ServeConfig, version: Optional[int] = None,
                        rules=None, mesh=None, device=None) -> "ServeEngine":
        """Pin a committed version (params only) — a multi-version reader."""
        device = resolve_device(device) if mesh is None else mesh_device(mesh)
        v, state = ckpt.restore({"params": model.abstract()}, version=version, device=device)
        eng = cls(model, state["params"], cfg, rules, mesh, device)
        eng.version = v
        return eng

    def reload(self, ckpt: CheckpointManager, version: Optional[int] = None) -> int:
        v, state = ckpt.restore({"params": self.model.abstract()}, version=version,
                                device=self.device)
        self.params, self.version = self._place(state["params"]), v
        return v

    # -------------------------------------------------------------- generate
    def generate(self, prompts: np.ndarray, generator: Optional[torch.Generator] = None
                 ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """prompts: [B, S0] int (equal lengths; B <= batch_slots).
        Returns (tokens [B, S0+max_new] int32, stats).  Greedy decoding takes
        the first index of the largest logit; sampling draws from
        `generator` (default: seed 0 on the engine's device).  stats holds
        the host-clock seconds of prefill and of the decode loop, each
        ending in a device synchronise, and whether every logit of the run
        was finite."""
        cfg = self.cfg
        B, S0 = prompts.shape
        if B > cfg.batch_slots:
            raise ValueError(f"{B} prompts > {cfg.batch_slots} batch slots")
        pad = cfg.batch_slots - B
        if pad:
            prompts = np.concatenate([prompts, np.zeros((pad, S0), prompts.dtype)], 0)
        if not cfg.greedy and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        with torch.inference_mode(), obs.span("serve.generate", self.device) as sp:
            if sp:
                sp.attrs.update(batch=B, slots=cfg.batch_slots, prompt_len=S0,
                                new_tokens=cfg.max_new_tokens)
            toks = torch.as_tensor(np.asarray(prompts, np.int64), device=self.device)
            with obs.span("serve.prefill"):
                t0 = time.perf_counter()
                logits, cache = self.model.prefill(self.params, {"tokens": self._tokens(toks)},
                                                   self.rules, self.mesh)
                logits = _whole(logits)
                finite = torch.isfinite(logits).all()
                _sync(self.device)
                t1 = time.perf_counter()
            out = [toks]
            done = torch.zeros((cfg.batch_slots,), dtype=torch.bool, device=self.device)
            steps = 0
            for i in range(cfg.max_new_tokens):
                if cfg.greedy:
                    nxt = torch.argmax(logits, dim=-1)
                else:
                    probs = torch.softmax(logits.float() / cfg.temperature, dim=-1)
                    nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
                if cfg.eos_id >= 0:
                    nxt = torch.where(done, torch.full_like(nxt, cfg.eos_id), nxt)
                    done = done | (nxt == cfg.eos_id)
                out.append(nxt[:, None])
                steps += 1
                if cfg.eos_id >= 0 and bool(done.all()):
                    break
                used = i + 1 < cfg.max_new_tokens  # a later token is taken from its logits
                with obs.span("serve.decode_step") as dsp:
                    if dsp:
                        dsp.attrs.update(index=i, used=used)
                    logits, cache = self.model.decode_step(self.params, cache,
                                                           self._tokens(nxt), self.rules,
                                                           self.mesh)
                    logits = _whole(logits)
                obs.count("serve.decode_steps")
                if not used:
                    obs.count("serve.decode_steps_unused")
                finite &= torch.isfinite(logits).all()
            _sync(self.device)
            t2 = time.perf_counter()
            with obs.span("serve.copy_out"):
                tokens = torch.cat(out, dim=1)[:B].to(torch.int32).cpu().numpy()
        return tokens, {"decode_steps": steps, "version": self.version,
                        "prefill_s": t1 - t0, "decode_s": t2 - t1,
                        "logits_finite": bool(finite)}
