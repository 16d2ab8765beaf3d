"""Parameter metadata and initialisation.

Every parameter carries *logical* axis names, as in the JAX package; the
sharding rules that map them onto a device mesh are not ported yet
(ROADMAP queue 1 item 10), so here they are metadata only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..tree import flatten_named, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones | scaled
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} and axes {self.logical_axes} differ in rank")


def _is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def init_params(specs: Tree, generator: torch.Generator) -> Tree:
    """Draws every parameter on the generator's device.

    The same distributions as the JAX package: ``"scaled"`` divides by the
    square root of the fan-in ``shape[-2]`` (for ``wq`` ``(d, h, hd)`` that
    is ``h``), as ``repro.models.params.init_params`` does.  The bits differ
    (``torch.Generator`` against ``jax.random``); tests carry weights across
    with ``models.convert`` instead.
    """
    device = generator.device

    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        scale = s.init_scale
        if s.init == "scaled":  # fan-in scaled
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            scale = s.init_scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(scale).to(s.dtype)

    return tree_map(one, specs, is_leaf=_is_spec)


def abstract_params(specs: Tree) -> Tree:
    """Shape-and-dtype stand-ins (tensors on the ``meta`` device)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    specs, is_leaf=_is_spec)


def param_count(specs: Tree) -> int:
    return sum(math.prod(s.shape) for _, s in flatten_named(specs, is_leaf=_is_spec))
