"""Log-bucketed latency histograms (HDR-style, mergeable).

Values (sim-time nanoseconds, but the class is unit-agnostic) land in
logarithmic buckets with ``SUBBUCKETS`` sub-buckets per octave: bucket index
``round(SUBBUCKETS * log2(v))``, representative value ``2**(idx/SUBBUCKETS)``.
With 8 sub-buckets per octave the bucket growth factor is 2**(1/8) ~ 1.090,
so any recorded value is reproduced within ~4.4% (half a bucket) and any
exact-rank percentile within one bucket's relative error.

Percentiles use the exact-rank definition (rank = ceil(p/100 * n), 1-based)
over the sorted buckets, so ``merge`` of two histograms reports the same
percentiles as one histogram fed both streams — the property the cluster
telemetry aggregation relies on.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

SUBBUCKETS = 8
GROWTH = 2.0 ** (1.0 / SUBBUCKETS)  # max ratio between bucket representatives
_LOG2_SCALE = SUBBUCKETS / math.log(2.0)


class LatencyHistogram:
    """Sparse log-bucketed histogram with exact count/sum/min/max sidecars."""

    __slots__ = ("counts", "zeros", "count", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.counts: Dict[int, int] = {}
        self.zeros = 0  # non-positive values get their own bucket (rep 0.0)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0

    # ------------------------------------------------------------- recording
    @staticmethod
    def bucket_index(value: float) -> int:
        return int(round(math.log(value) * _LOG2_SCALE))

    @staticmethod
    def bucket_value(idx: int) -> float:
        return 2.0 ** (idx / SUBBUCKETS)

    def record(self, value: float, n: int = 1) -> None:
        """Record ``n`` occurrences of ``value`` (batch windows record the
        window latency once per item)."""
        if n <= 0:
            return
        if value <= 0.0:
            self.zeros += n
            self.count += n
            self.vmin = min(self.vmin, 0.0)
            return
        idx = int(round(math.log(value) * _LOG2_SCALE))
        self.counts[idx] = self.counts.get(idx, 0) + n
        self.count += n
        self.total += value * n
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value

    # --------------------------------------------------------------- merging
    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into self (in place); returns self for chaining."""
        for idx, c in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + c
        self.zeros += other.zeros
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    @classmethod
    def merged(cls, hists: Iterable["LatencyHistogram"]) -> "LatencyHistogram":
        out = cls()
        for h in hists:
            out.merge(h)
        return out

    def copy(self) -> "LatencyHistogram":
        return LatencyHistogram().merge(self)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, LatencyHistogram):
            return NotImplemented
        return (
            self.counts == other.counts
            and self.zeros == other.zeros
            and self.count == other.count
            and abs(self.total - other.total) <= 1e-6 * max(1.0, abs(self.total))
            and self.vmin == other.vmin
            and self.vmax == other.vmax
        )

    __hash__ = None  # mutable

    # ------------------------------------------------------------ percentiles
    def percentile(self, p: float) -> float:
        """Exact-rank percentile: the representative value of the bucket
        holding the rank-``ceil(p/100*n)`` sample (1-based)."""
        if self.count == 0:
            return 0.0
        rank = max(1, min(self.count, math.ceil(p / 100.0 * self.count)))
        if rank <= self.zeros:
            return 0.0
        cum = self.zeros
        for idx in sorted(self.counts):
            cum += self.counts[idx]
            if cum >= rank:
                return self.bucket_value(idx)
        return self.bucket_value(max(self.counts))  # float-slop fallback

    def percentiles(self, ps: Sequence[float]) -> Tuple[float, ...]:
        return tuple(self.percentile(p) for p in ps)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    # ----------------------------------------------------------- persistence
    def snapshot(self) -> Dict[str, float]:
        p50, p99, p999 = self.percentiles((50.0, 99.0, 99.9))
        return {
            "count": self.count,
            "mean": self.mean,
            "min": 0.0 if self.count == 0 else self.vmin,
            "max": self.vmax,
            "p50": p50,
            "p99": p99,
            "p999": p999,
        }

    def to_dict(self) -> Dict[str, object]:
        return {
            "subbuckets": SUBBUCKETS,
            "counts": {str(i): c for i, c in sorted(self.counts.items())},
            "zeros": self.zeros,
            "count": self.count,
            "total": self.total,
            "min": None if self.count == 0 else self.vmin,
            "max": self.vmax,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "LatencyHistogram":
        h = cls()
        h.counts = {int(i): int(c) for i, c in d.get("counts", {}).items()}
        h.zeros = int(d.get("zeros", 0))
        h.count = int(d.get("count", 0))
        h.total = float(d.get("total", 0.0))
        vmin: Optional[float] = d.get("min")  # type: ignore[assignment]
        h.vmin = math.inf if vmin is None else float(vmin)
        h.vmax = float(d.get("max", 0.0))
        return h
