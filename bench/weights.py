"""The benchmark's weights: drawn from the seed, on the device, one call a
stacked tensor, in the dtype they are served and trained in.

Each tensor has a generator of its own, seeded from (seed, its name), so one
tensor can be drawn again alone: the reference redraws the weights after the
program's state is freed, and the check redraws the starting weights one at
a time to measure how far training moved them.  The layout (names, shapes,
dtypes, scales) is the reference's (``reference/<family>.py:layout``);
``check_layout`` holds it to the program's parameter specs.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

Leaf = Tuple[str, Tuple[int, ...], str, str, float]


def leaf_seed(seed: int, name: str) -> int:
    """A 64-bit seed for one tensor, from the run's seed and its name."""
    ss = np.random.SeedSequence([seed % (1 << 64), zlib.crc32(name.encode())])
    return int(ss.generate_state(1, np.uint64)[0])


def draw(leaf: Leaf, seed: int, device) -> torch.Tensor:
    name, shape, dtype, init, std = leaf
    dt = getattr(torch, dtype)
    g = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
    if init == "normal":
        return torch.randn(shape, generator=g, dtype=dt, device=device).mul_(std)
    if init == "one_plus":
        return torch.randn(shape, generator=g, dtype=dt, device=device).mul_(std).add_(1.0)
    if init == "a_log":  # log(1..N) on every channel
        n = shape[-1]
        row = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
        return row.expand(shape).to(dt).contiguous()
    if init == "dt_bias":  # softplus(b) log-uniform on [1e-3, 1e-1]
        u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
        dt_ = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        return (dt_ + torch.log(-torch.expm1(-dt_))).to(dt)
    raise ValueError(f"{name}: unknown init {init!r}")


def make(layout: Iterable[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} of every weight of `layout`."""
    return {leaf[0]: draw(leaf, seed, device) for leaf in layout}


def nest(flat: Dict[str, torch.Tensor]):
    """The program's nested dicts and lists from names such as
    ``blocks/0/l0/mixer/wq`` (a dict whose keys are all numbers is a list)."""
    root: Dict = {}
    for name, t in flat.items():
        *path, last = name.split("/")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[last] = t
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def check_layout(layout: Iterable[Leaf], specs: Dict[str, Tuple[Tuple[int, ...], str]]) -> None:
    """Raises unless `layout` names exactly the program's parameters
    (`specs`: {name: (shape, dtype)}), with the same shapes and dtypes."""
    mine = {leaf[0]: (tuple(leaf[1]), leaf[2]) for leaf in layout}
    if mine != specs:
        diff = sorted(set(mine.items()) ^ set(specs.items()))
        raise ValueError(f"the benchmark's weight layout differs from the program's: {diff}")
