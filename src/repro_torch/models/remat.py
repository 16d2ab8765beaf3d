"""Rematerialisation of the superblocks in training (``ModelConfig.remat``),
as ``repro.models.model._remat`` applies it to each superblock (one repeat of
a group's layer pattern) in train mode:

  "none"       every activation kept;
  "dots"       ``checkpoint_dots_with_no_batch_dims``: the outputs of the
               products that have no batch dimension in the reference are
               saved, everything else is recomputed in the backward;
  "save_dots"  ``checkpoint_dots``: every product's output saved;
  any other    full recompute (``jax.checkpoint`` with no policy).

The port runs a superblock under ``torch.utils.checkpoint`` (non-reentrant),
"dots" and "save_dots" with a selective checkpoint of its own (``_Products``,
a dispatch mode passed as the checkpoint's ``context_fn``), which sees aten
ops rather than JAX's ``dot_general``s.  What the reference's dots become:

* ``aten.mm`` / ``addmm``, the projections ``x.reshape(-1, d) @ w``: dots with
  no batch dimension;
* ``aten.bmm`` / ``baddbmm``: dots with batch dimensions (RG-LRU's
  block-diagonal gates ``bshe,hef->bshf``; the MoE's down product
  ``tef,efd->ted`` and its combine ``ted,te->td``), except where one operand
  is broadcast over the batch (stride 0): there the batch index is a free
  dimension of the other operand in the reference, as in the dense MoE's gate
  and up products ``td,edf->tef``, which run as a bmm over experts of the
  tokens expanded.  A bmm of batch 1 counts as batched: the port writes no
  product without batch dimensions as one.

Only the model's own products are saved.  A kernel's ``autograd.Function``
(flash attention, the scans) runs its forward with grad disabled; its insides
stand for the Pallas call, whose outputs JAX does not save by these policies
either, and are run again with the rest of the superblock.

JAX saves less than its policy allows: partial evaluation keeps only what
the backward reads.  The last product a superblock runs closes its last
residual branch (``x + y @ w``): its output is read by nothing but that sum,
the superblock's output, which the next superblock keeps as its input.  So
``run`` drops it once the forward is done.  (Under "save_dots" a MoE layer
closes its branch with two or more products, the combine of each chunk of
tokens and the shared experts' down product; only the last is dropped, so
the port keeps the others, which the reference does not.  "dots" saves none
of the combines.)  Torch's own selective checkpoint decides each op as it
runs and cannot take a saved output back, hence the mode here.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

_aten = torch.ops.aten
_PRODUCTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default}


def _no_batch_dims(func, args) -> bool:
    """Whether the product `func(*args)` has no batch dimension in the
    reference: a 2-D product, or a batched one with an operand broadcast
    over the batch."""
    if func in (_aten.mm.default, _aten.addmm.default):
        return True
    a, b = args[-2], args[-1]
    return a.shape[0] > 1 and (a.stride(0) == 0 or b.stride(0) == 0)


class _Products(TorchDispatchMode):
    """The model's products in a superblock, in the order they run (outside
    a kernel's Function, where grad is on): the forward appends each one's
    output to `saved` where the policy keeps it (None where not); the
    recomputation (`replay`) takes the kept ones back in the same order and
    runs the others."""

    def __init__(self, saved: List[Optional[torch.Tensor]], save_batched: bool,
                 replay: bool) -> None:
        super().__init__()
        self.saved, self.save_batched, self.replay, self.at = saved, save_batched, replay, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _PRODUCTS or not torch.is_grad_enabled():
            return func(*args, **kwargs)
        if self.replay:
            out, self.saved[self.at] = self.saved[self.at], None
            self.at += 1
            return func(*args, **kwargs) if out is None else out
        out = func(*args, **kwargs)
        keep = self.save_batched or _no_batch_dims(func, args)
        self.saved.append(out.detach() if keep else None)
        return out


def _contexts(saved: List[Optional[torch.Tensor]], save_batched: bool):
    """The checkpoint's `context_fn`: the forward's mode and the
    recomputation's, sharing `saved`."""
    return _Products(saved, save_batched, False), _Products(saved, save_batched, True)


def run(mode: str, fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """`fn(x)`, one superblock, under the rematerialisation of `mode` (not
    "none").  The superblocks draw no random numbers, so no RNG state is kept
    for the recomputation."""
    if mode not in ("dots", "save_dots"):
        return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)
    saved: List[Optional[torch.Tensor]] = []
    y = checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False,
                   context_fn=functools.partial(_contexts, saved, mode == "save_dots"))
    if saved:
        saved[-1] = None  # the product closing the last branch
    return y
