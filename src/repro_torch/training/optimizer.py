"""Optimizers over nested dicts of tensors: AdamW and Adafactor.

The port of ``repro.training.optimizer``.  Adafactor keeps a factored second
moment (row and column means for tensors of rank >= 2) and may keep its
momentum in bf16, so the optimizer state of a large model fits beside its
weights.  The arithmetic follows the JAX package's, operation by
operation, in fp32.

Unlike the JAX package, which returns new arrays (and donates the old
ones), ``apply_opt`` updates the parameters and the optimizer state in
place, one tensor at a time, and a tensor of rank >= 3 (a stacked model's
layers) in chunks of whole slices of its first axis, at most PIECE elements
a chunk: the fp32 temporaries of one chunk are alive at once, never a
second copy of the state (a whole stack's would be 16 GiB each for
falcon-mamba-7b's w_in).  Each in-place step is the same elementwise
operation as JAX's, and Adafactor's means run over the last two axes, inside
a chunk, so the values are those of the functional form.

On a mesh the parameters and the moments are DTensors.  The moments may be
sharded further than their parameter (ZeRO: the dry run gives them the fsdp
rules), so each update runs on the moments' placements: the gradient is
redistributed to them (a reduce-scatter or all-reduce of its partial sums),
the parameter too where it differs, and the elementwise arithmetic runs on
the local shards, the same operations as without a mesh.  What is not
elementwise reaches across the shards: the global norm is each rank's sum of
squares, all-reduced over the mesh dims that shard each tensor; Adafactor's
row and column means are local sums all-reduced over the mesh dims that
shard the reduced dim, divided by its full size.  The updated parameter goes
back to its own placements.  On a mesh whose dims are all of size 1 every
step is the plain path's, bit for bit.

``apply_opt`` is the ``obs`` span ``train.optimizer`` (attribute: the leaves
updated), the global norm inside it ``train.grad_norm``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import obs
from ..models.spmd import split_dims
from ..tree import flatten_named, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    momentum_dtype: str = "float32"  # adafactor may use bfloat16


def opt_state_shapes(shape, cfg: OptConfig) -> dict:
    """{moment: (shape, dtype, which of the parameter's dims it keeps)}."""
    n = len(shape)
    if cfg.kind == "adamw":
        return {"m": (tuple(shape), torch.float32, tuple(range(n))),
                "v": (tuple(shape), torch.float32, tuple(range(n)))}
    if cfg.kind != "adafactor":
        raise ValueError(f"optimizer kind {cfg.kind!r}: adamw or adafactor")
    st = {"m": (tuple(shape), getattr(torch, cfg.momentum_dtype), tuple(range(n)))}
    if n >= 2:  # factored for rank >= 2, full for vectors
        st["vr"] = (tuple(shape[:-1]), torch.float32, tuple(range(n - 1)))
        st["vc"] = (tuple(shape[:-2]) + tuple(shape[-1:]), torch.float32,
                    tuple(range(n - 2)) + (n - 1,))
    else:
        st["v"] = (tuple(shape), torch.float32, (0,))
    return st


def _opt_state_of(p: torch.Tensor, cfg: OptConfig, make) -> dict:
    return {k: make(s, dtype=dt, device=p.device)
            for k, (s, dt, _) in opt_state_shapes(p.shape, cfg).items()}


def init_opt_state(params: Tree, cfg: OptConfig) -> Tree:
    """Zero moments beside each parameter, on its device (``meta``
    parameters give ``meta`` state: a template for restore)."""
    return tree_map(lambda p: _opt_state_of(p, cfg, torch.zeros), params)


def _is_moments(x: Any) -> bool:
    """A parameter's optimizer state: {"m", "v"} or {"m", "vr", "vc"}."""
    return isinstance(x, dict) and "m" in x and set(x) <= {"m", "v", "vr", "vc"}


PIECE = 1 << 28  # elements the optimizer takes at once: 1 GiB a fp32 temporary


def _split(t: torch.Tensor, like: torch.Tensor) -> List[torch.Tensor]:
    """`t` (a parameter, its gradient or one of its moments) as views of
    whole slices of the first axis of its parameter `like`, at most PIECE
    elements of `like` a view, when `like` has rank >= 3; else [t]."""
    if like.dim() < 3 or like.shape[0] == 0:
        return [t]
    return list(t.split(max(1, PIECE // max(1, like[0].numel()))))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors (by piece) of the sum of squares, in fp32.
    A DTensor sharded over the mesh adds its shard's sum all-reduced over the
    mesh dims that shard it (one partial sum, all-reduced); otherwise its
    local pieces add one by one, as a plain tensor's."""
    sq = 0
    for g in tensors:
        local = g.to_local() if isinstance(g, DTensor) else g
        dims = split_dims(g) if isinstance(g, DTensor) else []
        if dims:
            part = sum(torch.sum(torch.square(x.float())) for x in _split(local, local))
            sq = sq + DTensor.from_local(
                part, g.device_mesh, [Partial() if i in dims else Replicate()
                                      for i in range(g.device_mesh.ndim)],
                run_check=False).full_tensor()
        else:
            for x in _split(local, local):
                sq = sq + torch.sum(torch.square(x.float()))
    return torch.sqrt(sq)


def _mesh_mean(placements, mesh, full: List[int]
               ) -> Callable[[torch.Tensor, int, int], torch.Tensor]:
    """mean(x, dim, param_dim): the mean over dim `dim` of a local shard `x`
    whose dim holds parameter dim `param_dim` (of full size `full`), summed
    over the mesh dims that shard it."""
    def mean(x: torch.Tensor, dim: int, param_dim: int) -> torch.Tensor:
        mdims = [i for i, p in enumerate(placements) if isinstance(p, Shard)
                 and p.dim % len(full) == param_dim % len(full) and mesh.size(i) > 1]
        if not mdims:
            return x.mean(dim=dim)
        total = x.sum(dim=dim)
        for i in mdims:
            dist.all_reduce(total, group=mesh.get_group(i))
        return total / full[param_dim]
    return mean


def _adamw(p, g, s, cfg: OptConfig, scale, bc1, bc2) -> None:
    g = g.float() * scale
    m, v = s["m"], s["v"]
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))               # b1 m + (1 - b1) g
    v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))     # b2 v + (1 - b2) g g
    del g
    upd = m / bc1                                       # mhat
    upd.div_((v / bc2).sqrt_().add_(cfg.eps))           # mhat / (sqrt(vhat) + eps)
    pf = p.float()
    upd.add_(pf * cfg.weight_decay)                     # + wd p
    p.copy_(pf.sub_(upd.mul_(cfg.lr)))                  # p - lr upd (an fp32 p is pf)


def _adafactor(p, g, s, cfg: OptConfig, scale, mean=None) -> None:
    """`mean(x, dim, param_dim)` reduces over a dim of the full parameter
    (a mesh-aware mean on shards); by default ``x.mean(dim)``."""
    g = g.float() * scale
    g2 = (g * g).add_(1e-30)
    if p.dim() >= 2:
        vr, vc = s["vr"], s["vc"]
        if mean is None:
            row, col = g2.mean(dim=-1), g2.mean(dim=-2)
        else:
            row, col = mean(g2, -1, -1), mean(g2, -2, -2)
        vr.mul_(cfg.b2).add_(row * (1 - cfg.b2))
        vc.mul_(cfg.b2).add_(col * (1 - cfg.b2))
        del g2, row, col
        vr_mean = vr.mean(dim=-1, keepdim=True) if mean is None else \
            mean(vr, -1, -2).unsqueeze(-1)
        denom = torch.clamp(vr_mean, min=1e-30)
        v = (vr[..., None] * vc[..., None, :]).div_(denom[..., None])
    else:
        v = s["v"]
        v.mul_(cfg.b2).add_(g2.mul_(1 - cfg.b2))
        del g2
    upd = g.div_(torch.sqrt(v).add_(cfg.eps))           # g / (sqrt(v) + eps)
    del v
    m = (s["m"].float() * cfg.b1).add_(upd.mul_(1 - cfg.b1))
    s["m"].copy_(m)                                     # stored in the momentum dtype
    pf = p.float()
    m.add_(pf * cfg.weight_decay)                       # fp32 m + wd p
    p.copy_(pf.sub_(m.mul_(cfg.lr)))                    # (an fp32 p is pf itself)


def apply_opt(params: Tree, grads: List[torch.Tensor], state: Tree, cfg: OptConfig,
              step: torch.Tensor) -> torch.Tensor:
    """Updates `params` and `state` in place from `grads` (one per parameter,
    in ``flatten_named`` order; the list is emptied as it is consumed) and
    returns the global gradient norm, before clipping, as a 0-d tensor."""
    flat_p = [p for _, p in flatten_named(params)]
    flat_s = [s for _, s in flatten_named(state, is_leaf=_is_moments)]
    if not (len(flat_p) == len(grads) == len(flat_s)):
        raise ValueError(f"{len(flat_p)} params, {len(grads)} grads, {len(flat_s)} states")
    with obs.span("train.optimizer", flat_p[0] if flat_p else None) as sp:
        if sp:
            sp.attrs["leaves"] = len(flat_p)
        return _apply(flat_p, grads, flat_s, cfg, step)


def _apply(flat_p: List[torch.Tensor], grads: List[torch.Tensor], flat_s: List[dict],
           cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        for i, (g, s) in enumerate(zip(grads, flat_s)):
            if isinstance(g, DTensor):  # each gradient on its moments' placements
                pl = s["m"].placements
                grads[i] = g if tuple(g.placements) == tuple(pl) else \
                    g.redistribute(g.device_mesh, pl)
    with obs.span("train.grad_norm"):
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = step.to_local() if isinstance(step, DTensor) else step
    t = step.float() + 1.0
    bc1, bc2 = 1 - torch.pow(cfg.b1, t), 1 - torch.pow(cfg.b2, t)
    with torch.no_grad():
        for i, (p, s) in enumerate(zip(flat_p, flat_s)):
            g, grads[i] = grads[i], None  # let each gradient go once it is applied
            if isinstance(p, DTensor):
                _update_shards(p, g, s, cfg, scale, bc1, bc2)
            else:
                _update(p, g, s, cfg, scale, bc1, bc2)
            del g
    grads.clear()
    return gnorm


def _update(p, g, s, cfg: OptConfig, scale, bc1, bc2, mean=None) -> None:
    """One parameter's update, in pieces of whole first-axis slices."""
    states = [dict(zip(s, vs)) for vs in zip(*(_split(v, p) for v in s.values()))]
    for pl, gl, sl in zip(_split(p, p), _split(g, p), states):
        if cfg.kind == "adamw":
            _adamw(pl, gl, sl, cfg, scale, bc1, bc2)
        else:
            _adafactor(pl, gl, sl, cfg, scale, mean)


def _update_shards(p: DTensor, g: DTensor, s: dict, cfg: OptConfig, scale, bc1, bc2) -> None:
    """A DTensor parameter's update on its moments' placements (`g` is on
    them already): the local shards through `_update`, then the parameter
    back on its own placements."""
    mesh, pl = p.device_mesh, s["m"].placements
    pz = p if tuple(p.placements) == tuple(pl) else p.redistribute(mesh, pl)
    mean = None
    if cfg.kind == "adafactor" and p.dim() >= 2:
        mean = _mesh_mean(pl, mesh, list(p.shape))
    local = pz.to_local()
    _update(local, g.to_local(), {k: v.to_local() for k, v in s.items()}, cfg, scale, bc1, bc2,
            mean)
    if pz is not p:
        p.to_local().copy_(pz.redistribute(mesh, p.placements).to_local())
