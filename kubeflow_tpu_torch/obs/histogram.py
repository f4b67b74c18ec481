"""Log-bucketed Prometheus histograms — bounded-memory latency
distributions.

Why log buckets: request latencies span ~5 orders of magnitude (a 1 ms
cache-hit TTFT to a 60 s cold recovery), so exponentially-spaced bounds
give constant RELATIVE resolution (one factor-of-2 bucket) everywhere on
that range with a couple dozen counters. Percentiles read from buckets
are conservative (the bucket's upper bound — never an understatement),
which is exactly the bias an SLO gate wants.

Memory is O(buckets) forever — the fix for the CanaryGate's unbounded
``_latencies`` list, and the reason bench percentile math shares this
type instead of sorting raw sample lists.
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional, Sequence


def log_buckets(lo: float = 0.001, hi: float = 64.0,
                factor: float = 2.0) -> tuple[float, ...]:
    """Exponential bucket upper bounds from ``lo`` up to >= ``hi``."""
    if lo <= 0 or factor <= 1:
        raise ValueError("need lo > 0 and factor > 1")
    out = [float(lo)]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


# 1 ms .. ~65 s in factor-2 steps: 17 buckets covers every latency this
# system reports (TTFT, inter-token, e2e, recovery phases)
DEFAULT_BUCKETS = log_buckets()


class Histogram:
    """Thread-safe counting histogram with Prometheus semantics:
    ``observe`` increments the first bucket whose upper bound >= value
    (plus an implicit +Inf bucket), and the text exposition renders
    cumulative ``_bucket{le=...}`` lines + ``_sum`` + ``_count``."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("need at least one bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0

    # -------------------------------------------------------- writing --

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram's counts in (multi-replica/process
        aggregation). Bucket bounds must match."""
        if other.bounds != self.bounds:
            raise ValueError("bucket bounds differ; cannot merge")
        with other._lock:
            counts, s, n = list(other._counts), other._sum, other._count
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += s
            self._count += n

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0

    # -------------------------------------------------------- reading --

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile observation —
        conservative (>= the true percentile) by construction; 0.0 when
        empty. A quantile landing in the overflow (+Inf) bucket returns
        ``inf``: the histogram cannot bound those values, and reporting
        the largest finite bound instead would UNDERSTATE them — an SLO
        gate comparing p95 against a threshold above the last bound
        could then never trip."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q={q} not in [0, 1]")
        with self._lock:
            n = self._count
            counts = list(self._counts)
        if n == 0:
            return 0.0
        # rank int(q*n)+1 (capped): matches the sorted-list convention
        # xs[int(q*len(xs))] the raw-sample implementations used, so the
        # bucket answer is always >= the list answer it replaced
        target = min(n, int(q * n) + 1)
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                return (self.bounds[i] if i < len(self.bounds)
                        else float("inf"))
        return float("inf")

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def snapshot(self) -> dict:
        """JSON view: cumulative bucket counts keyed by upper bound,
        plus sum/count and the standard percentile trio. Percentiles in
        the overflow bucket clamp to the largest finite bound here —
        strict-JSON consumers can't carry Infinity — with the clamp made
        visible via ``overflow`` (the +Inf bucket's own count)."""
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        cum, buckets = 0, {}
        for bound, c in zip(self.bounds, counts):
            cum += c
            buckets[repr(bound)] = cum
        snap = {"buckets": buckets, "sum": round(s, 6), "count": n,
                "overflow": counts[-1]}
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            p = self.percentile(q)
            snap[key] = p if p != float("inf") else self.bounds[-1]
        return snap

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Histogram":
        bounds = sorted(float(b) for b in snap.get("buckets", {}))
        h = cls(buckets=bounds or DEFAULT_BUCKETS)
        prev = 0
        for i, b in enumerate(h.bounds):
            cum = int(snap["buckets"].get(repr(b), prev))
            h._counts[i] = cum - prev
            prev = cum
        h._count = int(snap.get("count", 0))
        h._counts[-1] = max(0, h._count - prev)       # +Inf remainder
        h._sum = float(snap.get("sum", 0.0))
        return h

    def render_lines(self, name: str,
                     labels: Optional[str] = None) -> list[str]:
        """Prometheus exposition sample lines for this histogram (no
        HELP/TYPE — the shared exposition helper owns those). ``labels``
        is a pre-rendered inner label string (``model="m"``) or None."""
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        inner = (labels + ",") if labels else ""
        lines = []
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            lines.append(f'{name}_bucket{{{inner}le="{bound}"}} {cum}')
        lines.append(f'{name}_bucket{{{inner}le="+Inf"}} {n}')
        tail = f"{{{labels}}}" if labels else ""
        lines.append(f"{name}_sum{tail} {s}")
        lines.append(f"{name}_count{tail} {n}")
        return lines
