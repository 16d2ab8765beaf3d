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
tensor every rank holds.  The schedule is a forward: the sends carry no
gradient.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..tree import tree_map


def _stage_slice(t: torch.Tensor, stage: int) -> torch.Tensor:
    if isinstance(t, DTensor):
        return t.to_local()[0]
    return t[stage]


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,        # tree, tensors [n_stages, ...]
    x: torch.Tensor,          # [batch, ...] global input
    mesh,
    *,
    axis: str = "stage",
    n_micro: int = 4,
) -> torch.Tensor:
    dim = mesh.mesh_dim_names.index(axis)
    n_stages = mesh.size(dim)
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of {n_micro} microbatches")
    sidx = mesh.get_coordinate()[dim]
    group = mesh.get_group(dim)
    nxt = dist.get_global_rank(group, (sidx + 1) % n_stages)
    prv = dist.get_global_rank(group, (sidx - 1) % n_stages)
    params = tree_map(lambda t: _stage_slice(t, sidx), stage_params)
    xs = x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))
    cur = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(n_micro + n_stages - 1):
        if sidx == 0 and t < n_micro:  # stage 0 ingests microbatch t
            cur = xs[t]
        y = stage_fn(params, cur)
        done = t - (n_stages - 1)  # the last stage banks its finished microbatch
        if done >= 0 and sidx == n_stages - 1:
            outs[done] = y
        if n_stages == 1:
            cur = y
            continue
        recv = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        cur = recv
    if n_stages > 1:  # every stage gets the last stage's outputs
        dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1), group=group)
    return outs.reshape(x.shape)
