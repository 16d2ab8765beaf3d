"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and makes every input from the run's seed.

Training (``"entry": "train"``): step i's batch is `batch` rows of `seq`
tokens and their next tokens, uniform over the vocabulary, drawn on the
device from (seed, i), so every row of every step differs.

Serving (``"entry": "serve"``): batches of `batch` prompts of one length
(the engine takes equal-length prompts).  The lengths form a deck of
`deck` values spread evenly over the stated distribution's quantiles, its
ends included, rounded to `step`, dealt in one fixed order that spreads
each stretch over the deck (``order``), and again when it runs out: every
seed sends the same lengths, so a seed changes the tokens and the weights
and not the work.  The prompts' tokens come from (seed, batch index).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np

from .weights import leaf_seed

HERE = Path(__file__).resolve().parent


def load(name: str) -> Dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def train_batch(traffic: Dict, vocab: int, seed: int, i: int, device) -> Dict:
    import torch

    g = torch.Generator(device=device).manual_seed(leaf_seed(seed, f"train_batch/{i}"))
    t = torch.randint(0, vocab, (traffic["batch"], traffic["seq"] + 1), generator=g,
                      dtype=torch.int32, device=device)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def deck(traffic: Dict) -> List[int]:
    """The deck's lengths, in ascending order: the same for every seed."""
    ln = traffic["lengths"]
    if ln["dist"] != "loguniform":
        raise ValueError(f"length distribution {ln['dist']!r}: loguniform only")
    lo, hi, step, n = ln["min"], ln["max"], ln["step"], traffic["deck"]
    out = []
    for j in range(n):
        x = math.exp(math.log(lo) + j / max(1, n - 1) * (math.log(hi) - math.log(lo)))
        out.append(int(min(hi, max(lo, step * round(x / step)))))
    return out


def _radical_inverse(i: int) -> float:
    """i's binary digits mirrored about the point (van der Corput)."""
    x, f = 0.0, 0.5
    while i:
        x, i, f = x + f * (i & 1), i >> 1, f / 2
    return x


def order(n: int) -> List[int]:
    """The deal: position i takes the rank of the i-th van der Corput point
    among the first n, so every stretch of the deal spreads evenly over the
    deck's quantiles, and a window that ends a few batches earlier or later
    holds nearly the same lengths."""
    pts = [_radical_inverse(i) for i in range(n)]
    rank = {p: r for r, p in enumerate(sorted(pts))}
    return [rank[p] for p in pts]


def lengths(traffic: Dict, count: int) -> List[int]:
    """The first `count` batches' prompt lengths: the deck in the fixed
    order of ``order``, again and again.  The same for every seed."""
    d = deck(traffic)
    o = order(len(d))
    return [d[o[i % len(d)]] for i in range(count)]


def prompts(traffic: Dict, vocab: int, seed: int, i: int, length: int) -> np.ndarray:
    """Batch i's prompts, [batch, length] int64."""
    rng = np.random.default_rng([seed % (1 << 64), 2, i])
    return rng.integers(0, vocab, (traffic["batch"], length), dtype=np.int64)
