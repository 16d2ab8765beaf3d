"""Plain PyTorch pieces shared by the benchmark's references.

A reference follows the program's model as its configuration states it,
from the benchmark's own weights and inputs, with plain tensor operations:
no kernel, no cache, no batching across requests, and nothing imported
from the program.  It computes in float32 with TF32 off.  Its control is
the same code computed in fp8 (e4m3, one scale a tensor) where the
program computes in the bf16 the configurations state: every product's
operands and the residual stream between layers.

Training runs layer by layer: the forward keeps only each layer's input,
and the backward runs each layer again under autograd from that input,
so one layer's activations are alive at a time.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

PRECISIONS = ("float32", "float8")
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def set_float32_exact() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to e4m3 with one scale for the tensor (its largest
    magnitude at 448), back in float32.  Its gradient passes through as if
    the rounding were not there."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (rounded - t).detach()


class Products:
    """The reference's arithmetic in `precision`: "float32", or its control
    "float8": each product's operands, and the residual stream between
    layers, rounded by ``fp8``, where the program holds them in bf16."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return fp8(t) if self.precision == "float8" else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., k] @ w [k, n]."""
        return self._in(x) @ self._in(w)

    def held(self, x: torch.Tensor) -> torch.Tensor:
        """An activation the program holds in its stated dtype between
        layers (the residual stream), as this precision holds it."""
        return fp8(x) if self.precision == "float8" else x


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) scaled by 1 + w, as the configurations state their norms."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over positions of logsumexp(logits) - the label's logit."""
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - ll)


Layer = Callable[[Dict[str, torch.Tensor], torch.Tensor, Dict, Products], torch.Tensor]


def _layer_weights(W: Dict[str, torch.Tensor], stacked: List[str], l: int, grad: bool
                   ) -> Dict[str, torch.Tensor]:
    return {k.split("/", 3)[3]: W[k][l].detach().float().requires_grad_(grad) for k in stacked}


def _stacked(W: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in W if k.startswith("blocks/")]


def last_logits(layer: Layer, W: Dict[str, torch.Tensor], tokens: torch.Tensor, mc: Dict,
                prod: Products) -> torch.Tensor:
    """float32 logits [B, V] at the last position of `tokens` [B, S]."""
    stacked = _stacked(W)
    with torch.no_grad():
        x = W["embed"][tokens.long()].float()
        for l in range(mc["n_layers"]):
            x = prod.held(layer(_layer_weights(W, stacked, l, False), x, mc, prod))
        h = rmsnorm(x[:, -1], W["final_norm"].float(), mc["norm_eps"])
        return prod.mm(h, W["lm_head"])


def loss_and_grads(layer: Layer, W: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   labels: torch.Tensor, mc: Dict, prod: Products):
    """(loss, {name: float32 gradient}) of the mean next-token cross-entropy."""
    stacked = _stacked(W)
    L = mc["n_layers"]
    with torch.no_grad():
        xs = [W["embed"][tokens.long()].float()]
        for l in range(L):
            xs.append(prod.held(layer(_layer_weights(W, stacked, l, False), xs[-1], mc, prod)))
    grads: Dict[str, torch.Tensor] = {}
    x = xs.pop().requires_grad_(True)
    fn = W["final_norm"].detach().float().requires_grad_(True)
    head = W["lm_head"].detach().float().requires_grad_(True)
    loss = xent(prod.mm(rmsnorm(x, fn, mc["norm_eps"]), head), labels)
    loss.backward()
    grads["final_norm"], grads["lm_head"] = fn.grad, head.grad
    dx = x.grad
    del x, fn, head
    for k in stacked:
        grads[k] = torch.empty(W[k].shape, dtype=torch.float32, device=W[k].device)
    for l in reversed(range(L)):
        w = _layer_weights(W, stacked, l, True)
        x = xs.pop().requires_grad_(True)
        prod.held(layer(w, x, mc, prod)).backward(dx)
        dx = x.grad
        for k in stacked:
            grads[k][l] = w[k.split("/", 3)[3]].grad
        del w, x
    emb = W["embed"]
    grads["embed"] = torch.zeros(emb.shape, dtype=torch.float32, device=emb.device).index_add_(
        0, tokens.reshape(-1).long(), dx.reshape(-1, emb.shape[1]))
    return float(loss.detach()), grads


class Adafactor:
    """The configurations' optimizer, from its stated formulas: the
    gradient clipped by its global norm; a factored second moment (row and
    column means over the last two axes) for tensors of rank >= 2, a full
    one for vectors; the update g / (sqrt(v) + eps) into a momentum kept in
    `momentum_dtype`; decoupled weight decay.  The weights stay in their
    stored dtype; the arithmetic is float32, one slice of the first axis at
    a time for tensors of rank >= 3."""

    def __init__(self, W: Dict[str, torch.Tensor], opt: Dict):
        if opt["kind"] != "adafactor":
            raise ValueError(f"the reference has Adafactor only, not {opt['kind']!r}")
        self.opt = opt
        mdt = getattr(torch, opt["momentum_dtype"])
        self.m = {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in W.items()}
        self.v = {}
        for k, p in W.items():
            z = dict(dtype=torch.float32, device=p.device)
            self.v[k] = ((torch.zeros(p.shape[:-1], **z),
                          torch.zeros(p.shape[:-2] + p.shape[-1:], **z)) if p.dim() >= 2
                         else (torch.zeros(p.shape, **z),))

    def step(self, W: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> float:
        """Updates `W` in place; returns the global gradient norm."""
        o = self.opt
        gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2 for g in grads.values()))
        scale = min(1.0, o["clip_norm"] / (gnorm + 1e-9))
        for k, p in W.items():
            g, m, v = grads[k], self.m[k], self.v[k]
            if p.dim() >= 3:
                for l in range(p.shape[0]):
                    self._one(p[l], g[l], m[l], tuple(t[l] for t in v), scale)
            else:
                self._one(p, g, m, v, scale)
        return gnorm

    def _one(self, p, g, m, v, scale) -> None:
        o = self.opt
        g = g.float() * scale
        g2 = g * g + 1e-30
        if p.dim() >= 2:
            vr, vc = v
            vr.mul_(o["b2"]).add_(g2.mean(dim=-1) * (1 - o["b2"]))
            vc.mul_(o["b2"]).add_(g2.mean(dim=-2) * (1 - o["b2"]))
            denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
            second = vr[..., None] * vc[..., None, :] / denom[..., None]
        else:
            (second,) = v
            second.mul_(o["b2"]).add_(g2 * (1 - o["b2"]))
        mf = m.float() * o["b1"] + (g / (torch.sqrt(second) + o["eps"])) * (1 - o["b1"])
        m.copy_(mf)
        pf = p.float()
        p.copy_(pf - o["lr"] * (mf + o["weight_decay"] * pf))


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in tensors.items()}


def gaps(prog: Dict[str, float], ref: Dict[str, float], keep: Optional[List[str]] = None
         ) -> List[float]:
    """Each leaf's |program's norm - reference's norm|, over the larger of
    the reference's norm of that leaf and the median leaf's, ascending."""
    keys = keep if keep is not None else list(ref)
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return sorted(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)
