"""Local work on DTensor shards: what ``jax.shard_map`` bodies do in the
JAX package, for the parts of the model that run on each rank's own shard
(the attention kernels, the scans, the MoE bodies).

A DTensor's ``to_local`` gives this rank's shard; the gradient that comes
back to it is, on each mesh dim, of the DTensor's own placement, except on
a mesh dim where the DTensor is replicated but the work is split (the
ranks along it compute different parts of the result): there each rank's
gradient is only its part's, so it is ``Partial`` (``local_part``).
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def split_dims(*tensors: DTensor) -> List[int]:
    """Mesh dims (of size > 1) on which any of `tensors` is sharded: the
    dims along which the ranks' local work differs."""
    mesh = tensors[0].device_mesh
    return sorted({i for t in tensors for i, (p, n) in enumerate(zip(t.placements, mesh.shape))
                   if isinstance(p, Shard) and n > 1})


def local_part(t: DTensor, split: Sequence[int]) -> torch.Tensor:
    """`t`'s local shard; its gradient is partial on the mesh dims in `split`
    on which `t` is replicated."""
    grad = tuple(Partial() if isinstance(p, Replicate) and i in split else p
                 for i, p in enumerate(t.placements))
    return t.to_local(grad_placements=grad)


def from_shards(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A DTensor of global `shape` (contiguous) from this rank's `local`
    shard, without a collective to find the shape."""
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def shard_offset(t: DTensor, dim: int) -> int:
    """The first index along tensor dim `dim` of this rank's shard of `t`
    (mesh dims sharding one tensor dim split it major first)."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    size, off = t.shape[dim], 0
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim % t.dim() == dim % t.dim():
            size //= mesh.size(i)
            off += coord[i] * size
    return off


def dims_sharding(t: DTensor, dim: int) -> List[int]:
    """Mesh dims (of size > 1) that shard tensor dim `dim` of `t`."""
    mesh = t.device_mesh
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim % t.dim() == dim % t.dim() and mesh.size(i) > 1]


def gather(x: torch.Tensor, mesh, mesh_dims: Sequence[int]) -> torch.Tensor:
    """[n, *x.shape]: `x` of every rank along `mesh_dims` (no gradient), in
    the order of their coordinates, major first."""
    parts = [x]
    for i in mesh_dims:
        group = mesh.get_group(i)
        out = []
        for p in parts:
            bufs = [torch.empty_like(p) for _ in range(mesh.size(i))]
            dist.all_gather(bufs, p.contiguous(), group=group)
            out.extend(bufs)
        parts = out
    return torch.stack(parts)


def merge_by_lse(out: torch.Tensor, lse: torch.Tensor, live: torch.Tensor, mesh,
                 mesh_dims: Sequence[int]) -> torch.Tensor:
    """Attention over the chunks of a cache that the ranks along `mesh_dims`
    hold, from each chunk's output `out` [B, H, D] and log-sum-exp `lse`
    [B, H] (`live` [B]: whether the chunk holds a visible key for the row):
    sum_r exp(lse_r - max) out_r / sum_r exp(lse_r - max), in fp32."""
    lse = torch.where(live[:, None], lse.float(), torch.full_like(lse, float("-inf"),
                                                                  dtype=torch.float32))
    outs, lses = gather(out.float(), mesh, mesh_dims), gather(lse, mesh, mesh_dims)
    mx = lses.amax(dim=0)
    w = torch.exp(lses - torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx)))
    num = (outs * w[..., None]).sum(0)
    den = w.sum(0)[..., None]
    return torch.where(den > 0, num / den.clamp_min(1e-30), torch.zeros_like(num)).to(out.dtype)


def flatten(t: DTensor, start: int, end: int) -> DTensor:
    """`t` with dims start..end (inclusive) merged, shard by shard: only
    `start` of them may be sharded (it stays the outer part), so each rank's
    shard is its slice of the merged dim and the gradient comes back on the
    same placements (a DTensor view might choose others and then fail to
    view them back)."""
    n = t.dim()
    pl = []
    for p in t.placements:
        if isinstance(p, Shard):
            d = p.dim % n
            if start < d <= end:
                raise ValueError(f"flatten({start}, {end}) of a tensor sharded on dim {d}")
            p = Shard(d - (end - start) if d > end else d)
        pl.append(p)
    local = t.to_local()
    shape = list(t.shape)
    shape[start:end + 1] = [math.prod(shape[start:end + 1])]
    lshape = list(local.shape)
    lshape[start:end + 1] = [math.prod(lshape[start:end + 1])]
    return from_shards(local.reshape(lshape), t.device_mesh, pl, shape)


def to_placements(t: DTensor, placements) -> DTensor:
    """`t` on `placements`: where they differ only on mesh dims of size 1
    (where every placement holds the same local data), the shard relabelled
    with no redistribution; otherwise ``t.redistribute``."""
    placements = tuple(placements)
    if tuple(t.placements) == placements:
        return t
    mesh = t.device_mesh
    if all(mesh.size(i) == 1 for i, (a, b) in enumerate(zip(t.placements, placements))
           if a != b):
        return DTensor.from_local(t.to_local(), mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return t.redistribute(mesh, placements)


@functools.lru_cache(maxsize=None)
def _linear_plan(xpl, wpl, ndim: int, sizes, want):
    """`linear`'s placements for x, w and the output (see there), from
    their placements, x's rank, the mesh's sizes and `want`."""
    last = ndim - 1
    xpl, wpl, out = list(xpl), list(wpl), []
    for i, size in enumerate(sizes):
        if size == 1:
            out.append(Replicate())
            continue
        px, pw = xpl[i], wpl[i]
        k_shard = isinstance(px, Shard) and px.dim % ndim == last
        if (px.is_partial() and not isinstance(pw, Replicate)) or (k_shard and pw != Shard(0)):
            px = xpl[i] = Replicate()
            k_shard = False
        if px.is_partial():
            out.append(px)
        elif isinstance(px, Shard) and not k_shard:      # rows of x
            wpl[i] = Replicate()
            out.append(Shard(px.dim % ndim))
        elif k_shard:                                    # x's K against w's rows
            out.append(Partial())
        elif pw == Shard(1):                             # column parallel
            out.append(Shard(last))
        elif pw == Shard(0):                             # row parallel
            xpl[i] = Shard(last)
            out.append(Partial())
        elif want is not None and isinstance(want[i], Shard):  # a free slice
            d = want[i].dim % ndim
            if d == last:
                wpl[i] = Shard(1)
            else:
                xpl[i] = Shard(d)
            out.append(Shard(d))
        else:
            out.append(Replicate())
    return tuple(xpl), tuple(wpl), tuple(out)


def linear(x: DTensor, w: DTensor, want=None) -> DTensor:
    """x @ w for x [..., K] and w [K, N] on a mesh, as one local product on
    each rank's shards (Megatron-style) with the placements chosen here, not
    by DTensor's matmul rule (which may replicate the work, and re-infers
    its shapes on every call in some torch releases).  On each mesh dim of
    size > 1: x sharded on a leading dim keeps it and takes w whole on that
    dim (an FSDP gather); x replicated takes w's column shards (column
    parallel) or slices its own K to w's row shards (row parallel: the
    output Partial); x sharded on K meets w's row shards (Partial) or is
    gathered; a Partial x stays so only against a replicated w.  Where x and
    w are both whole on a mesh dim, `want` (the placements the caller will
    put the output on) may split the work by a free slice: its rows, or w's
    columns."""
    mesh = x.device_mesh
    xpl, wpl, out = _linear_plan(tuple(x.placements), tuple(w.placements), x.dim(),
                                 tuple(mesh.shape), None if want is None else tuple(want))
    xr, wr = to_placements(x, xpl), to_placements(w, wpl)
    split = [i for i in range(mesh.ndim) if not isinstance(out[i], Replicate)]
    xl, wl = local_part(xr, split), local_part(wr, split)
    yl = (xl.reshape(-1, xl.shape[-1]) @ wl).view(*xl.shape[:-1], wl.shape[-1])
    return from_shards(yl, mesh, out, tuple(x.shape[:-1]) + (w.shape[1],))


class ModelAxis:
    """The "model" mesh dim as a rank's body sees it (the MoE bodies, the
    channel-sharded mixers): its size, this rank's index and its
    collectives.  ``ModelAxis()`` is a single device (size 1, index 0),
    where every collective is the identity.  The exchanges and ``sum`` are
    ``torch.distributed.nn.functional``'s, whose gradients are the exchange
    back and the sum of the ranks' gradients; ``all_gather`` and ``psum``
    are DTensor redistributions, whose gradients follow the model's
    convention that a replicated activation's gradient is whole on every
    rank."""

    def __init__(self, mesh=None, token_placements=None):
        self.mesh = mesh
        if mesh is None:
            self.size, self.index, self.dim = 1, 0, None
            return
        self.dim = mesh.mesh_dim_names.index("model")
        self.size = mesh.size(self.dim)
        self.index = mesh.get_coordinate()[self.dim]
        self.group = mesh.get_group(self.dim)
        self.tokens = token_placements  # the local token block's placements

    def all_to_all(self, x: torch.Tensor, out_rows=None, in_rows=None) -> torch.Tensor:
        """Without row splits, x [size, ...]: row j goes to rank j; returns
        what each rank sent this one, by sender.  With them, x [n, ...]
        sends in_rows[j] rows to rank j and receives out_rows[j] from it."""
        if self.size == 1:
            return x
        from torch.distributed.nn.functional import all_to_all_single

        out = (torch.empty_like(x) if out_rows is None
               else x.new_empty((sum(out_rows),) + tuple(x.shape[1:])))
        return all_to_all_single(out, x.contiguous(), out_rows, in_rows, group=self.group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `t`, where each rank reads the sum for
        its own part of the work: its gradient is the sum of the ranks'."""
        if self.size == 1:
            return t
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t, group=self.group)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x [t, d], concatenated in rank order."""
        if self.size == 1:
            return x
        pl = list(self.tokens)
        pl[self.dim] = Shard(0)
        full = DTensor.from_local(x, self.mesh, pl, run_check=False)
        pl[self.dim] = Replicate()
        return full.redistribute(self.mesh, pl).to_local()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x, read alike by every rank."""
        if self.size == 1:
            return x
        pl = [Replicate()] * self.mesh.ndim
        pl[self.dim] = Partial()
        full = DTensor.from_local(x, self.mesh, pl, run_check=False)
        pl[self.dim] = Replicate()
        return full.redistribute(self.mesh, pl).to_local()
