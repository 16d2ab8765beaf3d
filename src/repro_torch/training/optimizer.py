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
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import torch

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


def _opt_state_of(p: torch.Tensor, cfg: OptConfig, make) -> dict:
    if cfg.kind == "adamw":
        return {"m": make(p.shape, dtype=torch.float32, device=p.device),
                "v": make(p.shape, dtype=torch.float32, device=p.device)}
    if cfg.kind != "adafactor":
        raise ValueError(f"optimizer kind {cfg.kind!r}: adamw or adafactor")
    st = {"m": make(p.shape, dtype=getattr(torch, cfg.momentum_dtype), device=p.device)}
    if p.dim() >= 2:  # factored for rank >= 2, full for vectors
        st["vr"] = make(p.shape[:-1], dtype=torch.float32, device=p.device)
        st["vc"] = make(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device)
    else:
        st["v"] = make(p.shape, dtype=torch.float32, device=p.device)
    return st


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
    """sqrt of the sum over tensors (by piece) of the sum of squares, in fp32."""
    sq = sum(torch.sum(torch.square(x.float())) for g in tensors for x in _split(g, g))
    return torch.sqrt(sq)


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


def _adafactor(p, g, s, cfg: OptConfig, scale) -> None:
    g = g.float() * scale
    g2 = (g * g).add_(1e-30)
    if p.dim() >= 2:
        vr, vc = s["vr"], s["vc"]
        vr.mul_(cfg.b2).add_(g2.mean(dim=-1) * (1 - cfg.b2))
        vc.mul_(cfg.b2).add_(g2.mean(dim=-2) * (1 - cfg.b2))
        del g2
        denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
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
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    t = step.float() + 1.0
    bc1, bc2 = 1 - torch.pow(cfg.b1, t), 1 - torch.pow(cfg.b2, t)
    with torch.no_grad():
        for i, (p, s) in enumerate(zip(flat_p, flat_s)):
            g, grads[i] = grads[i], None  # let each gradient go once it is applied
            states = [dict(zip(s, vs)) for vs in zip(*(_split(v, p) for v in s.values()))]
            for pl, gl, sl in zip(_split(p, p), _split(g, p), states):
                if cfg.kind == "adamw":
                    _adamw(pl, gl, sl, cfg, scale, bc1, bc2)
                else:
                    _adafactor(pl, gl, sl, cfg, scale)
            del g
    grads.clear()
    return gnorm
