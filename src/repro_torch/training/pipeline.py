"""GPipe-style pipeline parallelism over a mesh dim, with point-to-point
sends between the stages' ranks.  The port of ``repro.training.pipeline``.

Feature-flagged building block (not wired into the default sharding
policy, which favours FSDP+TP+EP on a single pod): stages live on a
dedicated mesh dim; microbatches stream through `n_micro + n_stages - 1`
ticks; each tick every stage computes its slice and sends its activations
to its successor (``batch_isend_irecv`` around the ring, as the
reference's ``ppermute``).  Bubble fraction = (S-1)/(M+S-1), the classic
GPipe schedule.  At the end the last stage's outputs are broadcast to every
stage.

    y = pipeline_apply(stage_fn, stage_params, x, mesh, axis="stage",
                       n_micro=M)

`stage_params` is a tree whose tensors have a leading stage axis: plain
tensors (every rank holds all stages and takes its own) or DTensors sharded
on it over `axis`.  `stage_fn(params, h)` must preserve the activation
shape (a transformer block stack does).  `x` is the global input, a plain
tensor every rank holds.

The schedule is differentiable, as ``jax.grad`` differentiates the
reference's: where a gradient is recorded, each tick's stage call keeps its
graph, and the backward runs the ticks in reverse, each stage sending the
gradient of what it received back to the stage that sent it (``_Pipeline``).
Each stage's parameters get their gradient from its own ticks; `x` gets
stage 0's, broadcast to every stage (it is replicated over them).  The
outputs are replicated over the stages, so their gradient is whole on
every rank, as a replicated DTensor's: the last stage's is the one used.
Without a gradient the schedule runs as a plain loop.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..tree import tree_map


def _stage_slice(t: torch.Tensor, stage: int) -> torch.Tensor:
    if isinstance(t, DTensor):
        return t.to_local()[0]
    return t[stage]


class _Ring:
    """This rank's place on the stage dim: its stage, the stage count, the
    dim's process group and its neighbours' global ranks."""

    def __init__(self, mesh, axis: str):
        dim = mesh.mesh_dim_names.index(axis)
        self.n = mesh.size(dim)
        self.stage = mesh.get_coordinate()[dim]
        self.group = mesh.get_group(dim)
        self.nxt = dist.get_global_rank(self.group, (self.stage + 1) % self.n)
        self.prv = dist.get_global_rank(self.group, (self.stage - 1) % self.n)

    def shift(self, send: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        """Sends `send` to global rank `to` and returns what `frm` sent."""
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send.contiguous(), to, self.group),
               dist.P2POp(dist.irecv, recv, frm, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def from_stage(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        """`t` of stage `stage`, on every stage (in place)."""
        dist.broadcast(t, src=dist.get_global_rank(self.group, stage), group=self.group)
        return t


def _schedule(stage_fn, params, xs: torch.Tensor, ring: _Ring,
              ticks: Optional[List] = None) -> torch.Tensor:
    """The GPipe ticks on this rank: returns the last stage's outputs [M, mb,
    ...] (zeros on other stages).  With `ticks`, each tick's stage call runs
    on an input of its own that records a gradient, and (input, output) is
    appended to it."""
    n_micro, s, n = xs.shape[0], ring.stage, ring.n
    cur = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(n_micro + n - 1):
        if s == 0 and t < n_micro:  # stage 0 ingests microbatch t
            cur = xs[t]
        if ticks is not None:
            cur = cur.detach().requires_grad_(True)
        y = stage_fn(params, cur)
        if ticks is not None:
            ticks.append((cur, y))
            y = y.detach()
        done = t - (n - 1)  # the last stage banks its finished microbatch
        if done >= 0 and s == n - 1:
            outs[done] = y
        if n == 1:
            cur = y
            continue
        cur = ring.shift(y, ring.nxt, ring.prv)
    return outs


class _Pipeline(torch.autograd.Function):
    """The schedule with its backward: the forward keeps each tick's graph
    (over the stage's parameters taken as leaves of its own); the backward
    walks the ticks in reverse.  On stage s, tick t holds microbatch t - s
    where 0 <= t - s < M (the others carry nothing the outputs read: no
    backward); tick t's output gradient is what the next stage sends back
    for it plus, on the last stage, the banked output's."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        stage_fn, treedef, ring, n_micro = run
        live = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        params = tree_unflatten(treedef, live)
        xs = x.detach().reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
        ticks: List = []
        with torch.enable_grad():
            outs = _schedule(stage_fn, params, xs, ring, ticks)
        if ring.n > 1:  # every stage gets the last stage's outputs
            ring.from_stage(outs, ring.n - 1)
        ctx.run, ctx.ticks, ctx.live, ctx.x_shape = run, ticks, live, x.shape
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        _, _, ring, n_micro = ctx.run
        s, n = ring.stage, ring.n
        gouts = g.reshape((n_micro, g.shape[0] // n_micro) + tuple(g.shape[1:]))
        want = [p for p in ctx.live if p.requires_grad]
        acc: List[Optional[torch.Tensor]] = [None] * len(want)
        gx = torch.zeros_like(gouts)
        g_next = torch.zeros_like(gouts[0])  # the gradient of tick t + 1's input
        for t in reversed(range(len(ctx.ticks))):
            cur, y = ctx.ticks[t]
            fed = s == 0 and t + 1 < n_micro   # tick t + 1's input was not tick t's receipt
            back = torch.zeros_like(g_next) if fed or t + 1 == len(ctx.ticks) else g_next
            gy = ring.shift(back, ring.prv, ring.nxt) if n > 1 else back
            done = t - (n - 1)
            if done >= 0 and s == n - 1:
                gy = gy + gouts[done]
            if not 0 <= t - s < n_micro:
                g_next = torch.zeros_like(g_next)
                continue
            got = torch.autograd.grad(y, [cur] + want, gy, allow_unused=True)
            g_next = got[0]
            for i, gp in enumerate(got[1:]):
                if gp is not None:
                    acc[i] = gp if acc[i] is None else acc[i] + gp
            if s == 0:
                gx[t] = g_next
        if n > 1 and ctx.needs_input_grad[1]:  # x is replicated: stage 0's gradient on each
            ring.from_stage(gx, 0)
        grads = iter(acc)
        out = []
        for p in ctx.live:
            gp = next(grads) if p.requires_grad else None
            out.append(torch.zeros_like(p) if p.requires_grad and gp is None else gp)
        ctx.ticks = ctx.live = None
        return (None, gx.reshape(ctx.x_shape) if ctx.needs_input_grad[1] else None, *out)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,        # tree, tensors [n_stages, ...]
    x: torch.Tensor,          # [batch, ...] global input
    mesh,
    *,
    axis: str = "stage",
    n_micro: int = 4,
) -> torch.Tensor:
    ring = _Ring(mesh, axis)
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of {n_micro} microbatches")
    params = tree_map(lambda t: _stage_slice(t, ring.stage), stage_params)
    leaves, treedef = tree_flatten(params)
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in leaves)):
        return _Pipeline.apply((stage_fn, treedef, ring, n_micro), x, *leaves)
    xs = x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
    outs = _schedule(stage_fn, params, xs, ring)
    if ring.n > 1:  # every stage gets the last stage's outputs
        ring.from_stage(outs, ring.n - 1)
    return outs.reshape(x.shape)
