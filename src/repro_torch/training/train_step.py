"""train_step factory: loss -> grads (with microbatch accumulation) ->
optional top-k gradient sparsification (error feedback) -> clipped update.

The port of ``repro.training.train_step``.  TrainState is a plain dict
(``params``, ``opt``, ``step`` and, with gradient sparsification,
``residual``), so its names in the store are the JAX package's pytree paths
and a state committed by either package resumes in the other.  The step
updates the state in place and returns it (see ``optimizer.py``): the
caller's state is the new one.

``make_train_step(model, tcfg, rules, mesh)``: with a mesh, the state and
the batch are DTensors (``models.params.place``; the Trainer places them),
the loss runs through the mesh, the gradients come back as DTensors and the
optimizer updates the shards (``optimizer.py``); the metrics are plain
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor

from .. import obs
from ..models.model import DecoderLM
from ..models.params import ParamSpec, make_shardings, placements_of
from ..tree import flatten_named, tree_map, tree_map_named
from .optimizer import OptConfig, apply_opt, init_opt_state, opt_state_shapes

Tree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum_steps: int = 1              # microbatch gradient accumulation
    grad_topk_frac: float = 0.0       # >0: sparsify grads (error feedback)


def _state_of(params: Tree, tcfg: TrainConfig, device) -> Dict[str, Any]:
    state = {
        "params": params,
        "opt": init_opt_state(params, tcfg.opt),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if tcfg.grad_topk_frac > 0:
        state["residual"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device), params)
    return state


def init_train_state(model: DecoderLM, generator: torch.Generator,
                     tcfg: TrainConfig) -> Dict[str, Any]:
    """Fresh weights (drawn on the generator's device) and zero optimizer state."""
    return _state_of(model.init(generator), tcfg, generator.device)


def abstract_train_state(model: DecoderLM, tcfg: TrainConfig) -> Dict[str, Any]:
    """The train state's names, shapes and dtypes, as ``meta`` tensors: the
    template ``CheckpointManager.restore`` fills."""
    return _state_of(model.abstract(), tcfg, "meta")


def zero_rules(rules: Dict) -> Dict:
    """The optimizer state's rules (ZeRO): the weights' embed axis sharded
    over the batch axes, as ``sharding_rules(fsdp=True)`` gives it."""
    return dict(rules, embed=rules.get("act_batch")) if rules else {}


def state_shardings(model: DecoderLM, tcfg: TrainConfig, rules: Dict, mesh) -> Dict[str, Any]:
    """The train state's placements on `mesh`: the params by `rules`, the
    optimizer state by ``zero_rules(rules)`` (each moment by the logical
    axes of the parameter dims it keeps), the residual as the params; the
    step is replicated."""
    specs = model.param_specs()
    params = make_shardings(specs, mesh, rules)
    orules = zero_rules(rules)

    def moments(s: ParamSpec):
        return {k: placements_of(shape, [s.logical_axes[i] for i in keep], mesh, orules)
                for k, (shape, _, keep) in opt_state_shapes(s.shape, tcfg.opt).items()}

    out = {"params": params, "opt": tree_map(moments, specs,
                                             is_leaf=lambda x: isinstance(x, ParamSpec))}
    if tcfg.grad_topk_frac > 0:
        out["residual"] = params
    return out


def _sparsify(grads: List[torch.Tensor], residual: List[torch.Tensor], frac: float
              ) -> List[torch.Tensor]:
    """Per-tensor magnitude top-k with error feedback: the un-transmitted
    remainder is carried to the next step (Lin et al., deep gradient
    compression), written into `residual` in place.  The threshold is the
    k-th largest magnitude (``torch.topk`` here, ``lax.top_k`` in the JAX
    package, neither a kernel); every entry at or above it is sent."""
    sent = []
    for g, r in zip(grads, residual):
        if isinstance(r, DTensor):  # on shards; the threshold from the full tensor
            g = g if tuple(g.placements) == tuple(r.placements) else \
                g.redistribute(r.device_mesh, r.placements)
            gf = g.float() + r
            k = max(1, int(gf.numel() * frac))
            thresh = torch.topk(gf.full_tensor().reshape(-1).abs(), k).values[-1]
            flat = gf.to_local().reshape(-1)
            s = torch.where(flat.abs() >= thresh, flat, torch.zeros((), device=flat.device))
            r.to_local().copy_((flat - s).view(r.to_local().shape))
            sent.append(DTensor.from_local(s.view(r.to_local().shape), r.device_mesh,
                                           r.placements, run_check=False))
            continue
        flat = (g.float() + r).reshape(-1)
        k = max(1, int(flat.numel() * frac))
        thresh = torch.topk(flat.abs(), k).values[-1]
        s = torch.where(flat.abs() >= thresh, flat, torch.zeros((), device=flat.device))
        r.copy_((flat - s).view(r.shape))
        sent.append(s.view(g.shape))
    return sent


def make_train_step(model: DecoderLM, tcfg: TrainConfig, rules: Dict = None, mesh=None
                    ) -> Callable[[Dict[str, Any], Dict[str, torch.Tensor]],
                                  Tuple[Dict[str, Any], Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    ``loss`` and ``grad_norm`` are 0-d tensors on the state's device."""

    def value_and_grad(leaves: List[Tuple[str, torch.Tensor]], params: Tree, batch,
                       micro: int = 0) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        with torch.enable_grad():
            live = {name: p.detach().requires_grad_(True) for name, p in leaves}
            with obs.span("train.forward") as sp:
                if sp:
                    sp.attrs["micro"] = micro
                loss = model.loss(tree_map_named(lambda name, _: live[name], params), batch,
                                  rules, mesh)
            with obs.span("train.backward") as sp:
                if sp:
                    sp.attrs["micro"] = micro
                grads = torch.autograd.grad(loss, list(live.values()))
        loss = loss.detach()
        return (loss.full_tensor() if isinstance(loss, DTensor) else loss), list(grads)

    def train_step(state, batch):
        step = state["step"]
        step = step.to_local() if isinstance(step, DTensor) else step
        with obs.span("train.step", step) as sp:
            if sp:
                sp.attrs["step"] = step
            obs.count("train.tokens", batch["tokens"].numel())
            return _step(state, batch)

    def _step(state, batch):
        params = state["params"]
        leaves = flatten_named(params)
        if tcfg.accum_steps > 1:
            n = tcfg.accum_steps
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0][1].to_local().device
                               if mesh is not None else state["step"].device)
            grads = [torch.zeros_like(p, dtype=torch.float32) if isinstance(p, DTensor) else
                     torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for _, p in leaves]
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l_i, g_i = value_and_grad(leaves, params, mb, i)
                loss = loss + l_i / n
                grads = [a + g.float() / n for a, g in zip(grads, g_i)]
                del g_i
        else:
            loss, grads = value_and_grad(leaves, params, batch)

        if tcfg.grad_topk_frac > 0:
            res = [r for _, r in flatten_named(state["residual"])]
            with obs.span("train.sparsify"):
                grads = _sparsify(grads, res, tcfg.grad_topk_frac)
        gnorm = apply_opt(params, grads, state["opt"], tcfg.opt, state["step"])
        state["step"] = state["step"] + 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step
