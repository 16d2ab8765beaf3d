"""Wall-clock profiling hooks for the simulator's own Python overhead.

``profile(name)`` is sprinkled around the hot harness phases (backend apply,
log decode, wave build).  Disabled — the default — it returns a shared no-op
context manager, so the cost at a call site is one module-global read and
two trivial ``__enter__``/``__exit__`` calls.  Enabled (``--metrics`` runs),
each site accumulates total seconds and call count into a module table that
the metrics export snapshots.
"""

from __future__ import annotations

import time
from typing import Dict, List

_enabled = False
_acc: Dict[str, List[float]] = {}  # name -> [seconds, calls]


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _Timer:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        cell = _acc.get(self.name)
        if cell is None:
            _acc[self.name] = [dt, 1]
        else:
            cell[0] += dt
            cell[1] += 1
        return False


def profile(name: str):
    """Context manager timing the enclosed region under ``name`` when
    profiling is enabled; a shared no-op otherwise."""
    return _Timer(name) if _enabled else _NULL


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    _acc.clear()


def snapshot() -> Dict[str, Dict[str, float]]:
    return {k: {"seconds": v[0], "calls": int(v[1])} for k, v in sorted(_acc.items())}
