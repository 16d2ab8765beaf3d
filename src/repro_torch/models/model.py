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

Every entry point takes ``rules, mesh`` as the JAX package's do.  With a
mesh, the params and the batch are DTensors (``params.place``), the layers
constrain their activations by ``rules``, the caches are DTensors placed by
leaf name (``params.cache_placements``) and MoE layers choose their
dispatch from the mesh.  With ``mesh=None`` and no rules every entry point
runs the code it ran before meshes existed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..device import mesh_device, resolve_device
from . import layers, moe, remat, spmd
from .config import ModelConfig
from .params import (ParamSpec, abstract_params, cache_placements, constrain, init_params,
                     local_shape)

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


def _xent_mesh(logits: DTensor, labels: DTensor) -> DTensor:
    """mean(logsumexp - picked logit) of logits [B, S, V] on a mesh, on each
    rank's rows: the plain path's ops on the shard where the vocab is whole
    on it (the ranks' means averaged); where the vocab is sharded, each
    rank's max (all-reduced), sum of exponentials and picked logit of its
    own columns, the last two summed over the vocab's mesh dims as Partial
    -> Replicate redistributions (whose gradient is the whole one on every
    rank)."""
    mesh = logits.device_mesh
    vdims = spmd.dims_sharding(logits, -1)
    local = spmd.local_part(logits, spmd.split_dims(logits))
    row = [Replicate() if i in vdims else p for i, p in enumerate(logits.placements)]
    lab = labels.redistribute(mesh, row).to_local().long()
    if not vdims:
        lse = torch.logsumexp(local, dim=-1)
        ll = torch.gather(local, -1, lab[..., None])[..., 0]
        rows = spmd.split_dims(logits)
        loss = spmd.from_shards(torch.mean(lse - ll), mesh,
                                [Partial("avg") if i in rows else Replicate()
                                 for i in range(mesh.ndim)], ())
        return loss.redistribute(mesh, [Replicate()] * mesh.ndim)
    v0, nv = spmd.shard_offset(logits, 2), local.shape[-1]
    part = [Partial() if i in vdims else p for i, p in enumerate(logits.placements)]
    mx = local.detach().amax(dim=-1)
    for i in vdims:
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    se = torch.exp(local - mx[..., None]).sum(dim=-1)
    mine = (lab >= v0) & (lab < v0 + nv)
    picked = torch.gather(local, -1, (lab - v0).clamp(0, nv - 1)[..., None])[..., 0]
    picked = torch.where(mine, picked, torch.zeros((), dtype=picked.dtype,
                                                   device=picked.device))

    def whole(t):  # a partial sum over the vocab's ranks, reduced
        return DTensor.from_local(t, mesh, part, run_check=False).redistribute(mesh, row)

    mx = DTensor.from_local(mx, mesh, row, run_check=False)
    return torch.mean(torch.log(whole(se)) + mx - whole(picked))


def _embed_mesh(table: DTensor, tokens: DTensor) -> DTensor:
    """table[tokens] on a mesh, on each rank's token rows: the table whole
    on the rank (gathered over the data axes an fsdp rule shards it on),
    then the plain lookup where the vocab is whole; where the vocab is
    sharded, each rank looks up its own rows (zeros for the others' tokens)
    and the lookups sum over the vocab's mesh dims.  Indexing a DTensor
    directly reaches DTensor's index_put rule in the backward, which some
    torch releases reject."""
    mesh = table.device_mesh
    vdims = spmd.dims_sharding(table, 0)
    keep = tuple(p if i in vdims else Replicate() for i, p in enumerate(table.placements))
    tab = table if tuple(table.placements) == keep else table.redistribute(mesh, keep)
    rows = tuple(p if isinstance(p, Shard) else Replicate() for p in tokens.placements)
    split = spmd.split_dims(tokens, tab)
    tl, el = tokens.to_local().long(), spmd.local_part(tab, split)
    shape = tuple(tokens.shape) + (table.shape[1],)
    if not vdims:
        return spmd.from_shards(el[tl], mesh, rows, shape)
    v0, nv = spmd.shard_offset(tab, 0), el.shape[0]
    mine = (tl >= v0) & (tl < v0 + nv)
    out = el[(tl - v0).clamp(0, nv - 1)] * mine[..., None].to(el.dtype)
    part = [Partial() if i in vdims else p for i, p in enumerate(rows)]
    return spmd.from_shards(out, mesh, part, shape).redistribute(mesh, rows)


def _index(tree, r: int):
    """Slice `r` of every tensor of a stacked group (a view, no copy).  A
    DTensor's slice is taken on its shard (its layers axis is replicated):
    a view of the shard, which the in-place cache writes reach, and which
    inference tensors allow."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        views = getattr(tree, "_layer_views", None)
        if views is not None and r in views:
            return views[r]
        view = _layer_of(tree, tree.to_local()[r])
        if not tree.requires_grad:
            # kept on the stack while it lives, so serving pays DTensor's
            # from_local (host time) once a layer, not once a layer a step
            if views is None:
                views = tree._layer_views = {}
            views[r] = view
        return view
    return tree[r]


def _layer_of(stack: DTensor, local: torch.Tensor) -> DTensor:
    """A layer of a stacked DTensor from `local`, the slice of its shard (its
    layers axis is replicated): the stack's placements less that axis."""
    if any(isinstance(p, Shard) and p.dim == 0 for p in stack.placements):
        raise ValueError("a stacked tensor sharded on its layers axis")
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in stack.placements]
    return DTensor.from_local(local, stack.device_mesh, pl, run_check=False,
                              shape=stack.shape[1:], stride=stack.stride()[1:])


class _StackGrad:
    """The gradient of one stacked tensor, written a layer's slot at a time
    into one buffer as each layer's gradient arrives (``_LayerSlot``)."""

    def __init__(self, stack: torch.Tensor):
        self.shape, self.dtype, self.device = stack.shape, stack.dtype, stack.device
        self.left, self.buf = stack.shape[0], None

    def put(self, r: int, g: torch.Tensor) -> Optional[torch.Tensor]:
        """Writes layer `r`'s gradient into its slot; returns the whole
        buffer with the last layer's, None before it.  ``g + 0.0`` turns a
        -0.0 into +0.0: slicing by ``t[r]`` summed every layer's gradient,
        zero outside its slot, into the stack's, so no -0.0 survived it, and
        the bits stay the ones that route gave."""
        if self.buf is None:
            self.buf = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        torch.add(g, 0.0, out=self.buf[r])
        self.left -= 1
        if self.left:
            return None
        buf, self.buf, self.left = self.buf, None, self.shape[0]
        return buf


class _LayerSlot(torch.autograd.Function):
    """``stack[r]`` (a view) whose backward writes the slice's gradient into
    slot `r` of the stack's gradient (``_StackGrad``) instead of a zero
    tensor of the whole stack's size: a group of depth L writes its
    gradient once, where indexing wrote L whole-stack tensors and summed
    them."""

    @staticmethod
    def forward(ctx, stack, r, grad):
        ctx.r, ctx.grad = r, grad
        return stack[r]

    @staticmethod
    def backward(ctx, g):
        return ctx.grad.put(ctx.r, g), None, None


def _layers(tree, n: int) -> List[Any]:
    """The `n` per-layer slices of a stacked group, taken once for a forward
    that records a gradient.  A tensor that needs one is sliced by
    ``_LayerSlot``; a DTensor on its shard (its placements kept), the
    gradient going back through one ``to_local``.  Others take ``_index``'s
    views."""
    if isinstance(tree, dict):
        per = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[r] for k, v in per.items()} for r in range(n)]
    if not tree.requires_grad:
        return [_index(tree, r) for r in range(n)]
    if isinstance(tree, DTensor):
        return [_layer_of(tree, t) for t in _layers(tree.to_local(), n)]
    grad = _StackGrad(tree)
    return [_LayerSlot.apply(tree, r, grad) for r in range(n)]


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
    def _apply_layer(self, kind, p, x, mode, cache, pos, rules=None, mesh=None):
        mixer, ffn = kind
        cfg = self.cfg
        mcache = cache.get("mixer") if cache else None
        if mixer in ("attn", "local_attn"):
            window = cfg.window if mixer == "local_attn" else None
            x, nc = layers.attn_apply(p["mixer"], x, cfg, mode, cache=mcache, pos=pos,
                                      window=window, rules=rules)
        elif mixer == "rglru":
            x, nc = layers.rglru_apply(p["mixer"], x, cfg, mode, cache=mcache)
        elif mixer == "mamba":
            x, nc = layers.mamba_apply(p["mixer"], x, cfg, mode, cache=mcache)
        else:
            raise ValueError(mixer)
        if ffn == "dense":
            x = layers.ffn_apply(p["ffn"], x, cfg, rules)
        elif ffn == "moe":
            x = moe.moe_apply(p["ffn"], x, cfg, rules, mesh)
        return x

    def _superblock(self, pattern, p, cache, mode, pos, x, rules=None, mesh=None):
        """One repeat of a group's layer pattern."""
        for i, kind in enumerate(pattern):
            c = cache.get(f"l{i}") if cache else None
            x = self._apply_layer(kind, p[f"l{i}"], x, mode, c, pos, rules, mesh)
        return x

    def _run_blocks(self, params, x, mode, caches, pos, rules=None, mesh=None):
        """caches: one stacked cache per group, filled (prefill) or read and
        updated (decode) in place; None in train mode.  A train-mode forward
        that records a gradient takes each group's layers once (``_layers``,
        outside remat, so the recomputation does not slice again) and runs
        each superblock under ``cfg.remat`` (``remat.run``), as the JAX
        package's ``_remat`` wraps it."""
        grad_on = mode == "train" and torch.is_grad_enabled()
        remat_on = self.cfg.remat != "none" and grad_on
        for gi, g in enumerate(self.groups):
            gp = params["blocks"][gi]
            gcache = caches[gi] if caches is not None else None
            per_layer = _layers(gp, g.repeats) if grad_on and g.repeats > 1 else None
            for r in range(g.repeats):
                gp_r = gp if g.repeats == 1 else per_layer[r] if per_layer else _index(gp, r)
                c_r = None
                if gcache is not None:
                    c_r = gcache if g.repeats == 1 else _index(gcache, r)
                if remat_on:
                    x = remat.run(self.cfg.remat, functools.partial(
                        self._superblock, g.pattern, gp_r, None, mode, pos, rules=rules,
                        mesh=mesh), x)
                else:
                    x = self._superblock(g.pattern, gp_r, c_r, mode, pos, x, rules, mesh)
        return x

    def _embed(self, params, batch):
        cfg = self.cfg
        if cfg.embed_inputs:
            if isinstance(batch["tokens"], DTensor):
                return _embed_mesh(params["embed"], batch["tokens"]).to(cfg.torch_dtype)
            return params["embed"][batch["tokens"].long()].to(cfg.torch_dtype)
        return batch["embeds"].to(cfg.torch_dtype)

    def _head(self, params, x):
        cfg = self.cfg
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            return layers.mm(x, params["embed"].t())
        return layers.mm(x, params["lm_head"])

    # ------------------------------------------------------------- losses
    def loss(self, params, batch, rules=None, mesh=None):
        """Mean next-token cross-entropy: fp32 logits from the model-dtype
        head, then ``mean(logsumexp - picked logit)``, as the JAX package.
        Differentiable: with grad enabled, attention runs the differentiable
        flash route (``kernels/ops.py``)."""
        x = self._embed(params, batch)
        x = self._run_blocks(params, x, "train", None, None, rules, mesh)
        logits = self._head(params, x).float()
        if isinstance(logits, DTensor):
            logits = constrain(logits, rules or {}, "act_batch", None, "act_vocab")
            return _xent_mesh(logits, batch["labels"])
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
        return torch.mean(lse - ll)

    def forward(self, params, batch, rules=None, mesh=None):
        x = self._embed(params, batch)
        x = self._run_blocks(params, x, "train", None, None, rules, mesh)
        return self._head(params, x)

    # ------------------------------------------------------------ serving
    def _alloc_cache(self, batch: int, max_len_of, device, make, rules=None, mesh=None):
        """One stacked cache per group, in the JAX layout: {"k", "v"} for an
        attention layer, sized with the max_len `max_len_of(window)`;
        {"h", "conv"} for a recurrent one.  With a mesh, each is a DTensor
        placed by its leaf name (``params.cache_placements``)."""
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
                if mesh is None:
                    gc[f"l{i}"] = {"mixer": {k: make(lead + s, dtype=dt, device=device)
                                             for k, (s, dt) in shp.items()}}
                else:
                    pls = {k: cache_placements(k, lead + s, mesh, rules or {}, len(lead))
                           for k, (s, _) in shp.items()}
                    gc[f"l{i}"] = {"mixer": {k: spmd.from_shards(
                        make(local_shape(lead + s, pls[k], mesh), dtype=dt, device=device),
                        mesh, pls[k], lead + s) for k, (s, dt) in shp.items()}}
            groups.append(gc)
        return groups

    def prefill(self, params, batch, rules=None, mesh=None):
        """Returns (last-position logits [B, V], cache).  The cache holds
        L = max(cfg.max_cache_len, S) slots; a local-attention layer holds
        min(window, cfg.max_cache_len)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        B, S = x.shape[0], x.shape[1]
        caches = self._alloc_cache(B, lambda w: layers.prefill_max_len(cfg, S, w),
                                   x.device, torch.empty, rules, mesh)
        x = self._run_blocks(params, x, "prefill", caches, None, rules, mesh)
        logits = self._head(params, x[:, -1:, :])
        return logits[:, 0], {"pos": S, "groups": caches, "max_len": cfg.max_cache_len}

    def init_cache(self, batch: int, max_len: int, device=None, rules=None, mesh=None):
        """Zero-initialized decode cache (for decode-only runs: a cache
        'already containing' max_len tokens), on the card unless `device`
        says otherwise; with a mesh, DTensors whose shards lie on the mesh's
        device (or on `device` "meta", for a dry run)."""
        if mesh is None:
            device = resolve_device(device)
        elif str(device) != "meta":
            device = mesh_device(mesh)
        groups = self._alloc_cache(batch, lambda w: max_len, device, torch.zeros, rules, mesh)
        return {"pos": max_len - 1, "groups": groups, "max_len": max_len}

    def decode_step(self, params, cache, tokens, rules=None, mesh=None):
        """tokens: [B] int (or embeds [B, 1, d]); returns (logits [B, V], cache)."""
        cfg = self.cfg
        if cfg.embed_inputs and isinstance(tokens, DTensor):
            x = _embed_mesh(params["embed"], tokens.long()[:, None]).to(cfg.torch_dtype)
        elif cfg.embed_inputs:
            x = params["embed"][tokens.long()[:, None]].to(cfg.torch_dtype)
        else:
            x = tokens.to(cfg.torch_dtype)
        pos = int(cache["pos"])
        x = self._run_blocks(params, x, "decode", cache["groups"], pos, rules, mesh)
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
