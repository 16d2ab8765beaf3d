"""DecoderLM: the decoder of the JAX package, in PyTorch (dense, MoE and
recurrent layers).

Layers are grouped as in ``repro.models.model``: identical repeating
(mixer, ffn) patterns form a group whose params carry a leading
``repeats`` axis (``blocks/0/l0/mixer/wq`` is ``[28, 3072, 24, 128]`` for
llama3.2-3b).  JAX scans over that axis; the port loops over its slices
in Python.  Entry points:

  loss(params, batch)                 - training forward + cross-entropy loss
  forward(params, batch)              - full-sequence logits
  prefill(params, batch)              - full-sequence forward, returns cache
  decode_step(params, cache, tokens)  - one token with the KV cache

Params are nested dicts/lists of tensors named as the JAX pytree.  The
cache layout is the JAX one (``groups[g]["l0"]["mixer"]["k"]``:
``[repeats, B, Hkv, L, hd]``; a recurrent layer's ``"h"`` and ``"conv"``
carry the same leading ``repeats`` axis), but ``prefill`` and
``decode_step`` write it in place: the cache ``decode_step`` returns
shares its buffers with the one it was given.  ``pos`` is a Python int.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from . import layers, moe, remat
from .config import ModelConfig
from .params import ParamSpec, abstract_params, init_params

Params = Any


@dataclasses.dataclass(frozen=True)
class Group:
    pattern: Tuple[Tuple[str, str], ...]
    repeats: int


def _groups(cfg: ModelConfig) -> List[Group]:
    groups: List[Group] = []
    if cfg.first_k_dense:
        groups.append(Group((("attn", "dense"),), cfg.first_k_dense))
    rest = cfg.n_layers - cfg.first_k_dense
    plen = len(cfg.block_pattern)
    full, tail = divmod(rest, plen)
    if full:
        groups.append(Group(cfg.block_pattern, full))
    if tail:
        groups.append(Group(cfg.block_pattern[:tail], 1))
    return groups


def _mixer_specs(cfg: ModelConfig, mixer: str):
    if mixer in ("attn", "local_attn"):
        return layers.attn_specs(cfg)
    if mixer == "rglru":
        return layers.rglru_specs(cfg)
    if mixer == "mamba":
        return layers.mamba_specs(cfg)
    raise ValueError(mixer)


def _ffn_specs(cfg: ModelConfig, ffn: str):
    if ffn == "dense":
        return layers.ffn_specs(cfg)
    if ffn == "moe":
        return moe.moe_specs(cfg)
    if ffn == "none":
        return None
    raise ValueError(ffn)


def _stack_specs(specs, repeats: int):
    if repeats == 1:
        return specs
    if isinstance(specs, dict):
        return {k: _stack_specs(v, repeats) for k, v in specs.items()}
    return ParamSpec((repeats,) + specs.shape, ("layers",) + specs.logical_axes,
                     specs.dtype, specs.init, specs.init_scale)


def _index(tree, r: int):
    """Slice `r` of every tensor of a stacked group (a view, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.groups = _groups(cfg)

    # ------------------------------------------------------------- params
    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        dt = cfg.torch_dtype
        specs: Dict[str, Any] = {}
        if cfg.embed_inputs:
            specs["embed"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                                       ("vocab", "embed"), dt, "normal", 0.02)
        blocks = []
        for g in self.groups:
            gspecs = {}
            for i, (mixer, ffn) in enumerate(g.pattern):
                lspec: Dict[str, Any] = {"mixer": _mixer_specs(cfg, mixer)}
                fs = _ffn_specs(cfg, ffn)
                if fs is not None:
                    lspec["ffn"] = fs
                gspecs[f"l{i}"] = lspec
            blocks.append(_stack_specs(gspecs, g.repeats))
        specs["blocks"] = blocks
        specs["final_norm"] = layers.norm_spec(cfg)
        if not cfg.tie_embeddings:
            specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                         ("embed", "vocab"), dt, "scaled")
        return specs

    def init(self, generator: torch.Generator) -> Params:
        """Fresh weights, drawn on the generator's device."""
        return init_params(self.param_specs(), generator)

    def abstract(self) -> Params:
        return abstract_params(self.param_specs())

    # ------------------------------------------------------------ forward
    def _apply_layer(self, kind, p, x, mode, cache, pos):
        mixer, ffn = kind
        cfg = self.cfg
        mcache = cache.get("mixer") if cache else None
        if mixer in ("attn", "local_attn"):
            window = cfg.window if mixer == "local_attn" else None
            x, nc = layers.attn_apply(p["mixer"], x, cfg, mode, cache=mcache, pos=pos,
                                      window=window)
        elif mixer == "rglru":
            x, nc = layers.rglru_apply(p["mixer"], x, cfg, mode, cache=mcache)
        elif mixer == "mamba":
            x, nc = layers.mamba_apply(p["mixer"], x, cfg, mode, cache=mcache)
        else:
            raise ValueError(mixer)
        if ffn == "dense":
            x = layers.ffn_apply(p["ffn"], x, cfg)
        elif ffn == "moe":
            x = moe.moe_apply(p["ffn"], x, cfg)
        return x

    def _superblock(self, pattern, p, cache, mode, pos, x):
        """One repeat of a group's layer pattern."""
        for i, kind in enumerate(pattern):
            c = cache.get(f"l{i}") if cache else None
            x = self._apply_layer(kind, p[f"l{i}"], x, mode, c, pos)
        return x

    def _run_blocks(self, params, x, mode, caches, pos):
        """caches: one stacked cache per group, filled (prefill) or read and
        updated (decode) in place; None in train mode.  A train-mode forward
        that records a gradient runs each superblock under ``cfg.remat``
        (``remat.run``), as the JAX package's ``_remat`` wraps it."""
        remat_on = self.cfg.remat != "none" and mode == "train" and torch.is_grad_enabled()
        for gi, g in enumerate(self.groups):
            gp = params["blocks"][gi]
            gcache = caches[gi] if caches is not None else None
            for r in range(g.repeats):
                gp_r = gp if g.repeats == 1 else _index(gp, r)
                c_r = None
                if gcache is not None:
                    c_r = gcache if g.repeats == 1 else _index(gcache, r)
                if remat_on:
                    x = remat.run(self.cfg.remat, functools.partial(
                        self._superblock, g.pattern, gp_r, None, mode, pos), x)
                else:
                    x = self._superblock(g.pattern, gp_r, c_r, mode, pos, x)
        return x

    def _embed(self, params, batch):
        cfg = self.cfg
        if cfg.embed_inputs:
            return params["embed"][batch["tokens"].long()].to(cfg.torch_dtype)
        return batch["embeds"].to(cfg.torch_dtype)

    def _head(self, params, x):
        cfg = self.cfg
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            return x @ params["embed"].t()
        return x @ params["lm_head"]

    # ------------------------------------------------------------- losses
    def loss(self, params, batch):
        """Mean next-token cross-entropy: fp32 logits from the model-dtype
        head, then ``mean(logsumexp - picked logit)``, as the JAX package.
        Differentiable: with grad enabled, attention runs the differentiable
        flash route (``kernels/ops.py``)."""
        x = self._embed(params, batch)
        x = self._run_blocks(params, x, "train", None, None)
        logits = self._head(params, x).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
        return torch.mean(lse - ll)

    def forward(self, params, batch):
        x = self._embed(params, batch)
        x = self._run_blocks(params, x, "train", None, None)
        return self._head(params, x)

    # ------------------------------------------------------------ serving
    def _alloc_cache(self, batch: int, max_len_of, device, make):
        """One stacked cache per group, in the JAX layout: {"k", "v"} for an
        attention layer, sized with the max_len `max_len_of(window)`;
        {"h", "conv"} for a recurrent one."""
        cfg = self.cfg
        groups = []
        for g in self.groups:
            gc: Dict[str, Any] = {}
            for i, (mixer, _) in enumerate(g.pattern):
                if mixer in ("attn", "local_attn"):
                    window = cfg.window if mixer == "local_attn" else None
                    shp = layers.attn_cache_shape(cfg, batch, max_len_of(window), window)
                elif mixer == "rglru":
                    shp = layers.rglru_cache_shape(cfg, batch)
                else:
                    shp = layers.mamba_cache_shape(cfg, batch)
                lead = (g.repeats,) if g.repeats > 1 else ()
                gc[f"l{i}"] = {"mixer": {k: make(lead + s, dtype=dt, device=device)
                                         for k, (s, dt) in shp.items()}}
            groups.append(gc)
        return groups

    def prefill(self, params, batch):
        """Returns (last-position logits [B, V], cache).  The cache holds
        L = max(cfg.max_cache_len, S) slots; a local-attention layer holds
        min(window, cfg.max_cache_len)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        B, S = x.shape[0], x.shape[1]
        caches = self._alloc_cache(B, lambda w: layers.prefill_max_len(cfg, S, w),
                                   x.device, torch.empty)
        x = self._run_blocks(params, x, "prefill", caches, None)
        logits = self._head(params, x[:, -1:, :])
        return logits[:, 0], {"pos": S, "groups": caches, "max_len": cfg.max_cache_len}

    def init_cache(self, batch: int, max_len: int, device=None):
        """Zero-initialized decode cache (for decode-only runs: a cache
        'already containing' max_len tokens), on the card unless `device`
        says otherwise."""
        device = resolve_device(device)
        groups = self._alloc_cache(batch, lambda w: max_len, device, torch.zeros)
        return {"pos": max_len - 1, "groups": groups, "max_len": max_len}

    def decode_step(self, params, cache, tokens):
        """tokens: [B] int (or embeds [B, 1, d]); returns (logits [B, V], cache)."""
        cfg = self.cfg
        if cfg.embed_inputs:
            x = params["embed"][tokens.long()[:, None]].to(cfg.torch_dtype)
        else:
            x = tokens.to(cfg.torch_dtype)
        pos = int(cache["pos"])
        x = self._run_blocks(params, x, "decode", cache["groups"], pos)
        logits = self._head(params, x)
        return logits[:, 0], {"pos": pos + 1, "groups": cache["groups"],
                              "max_len": cache["max_len"]}

    def sample_inputs(self, batch: int, seq: int,
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Random inputs for smoke tests, on the generator's device."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(generator=generator, device=generator.device)
        out: Dict[str, torch.Tensor] = {}
        if cfg.embed_inputs:
            out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, seq), dtype=torch.int32, **kw)
        else:
            out["embeds"] = torch.randn((batch, seq, cfg.d_model), dtype=torch.float32, **kw)
        out["labels"] = torch.randint(0, cfg.vocab_size, (batch, seq), dtype=torch.int32, **kw)
        return out
