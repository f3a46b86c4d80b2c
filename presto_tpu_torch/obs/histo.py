"""Latency histograms with Prometheus exposition.

Port of presto_tpu/obs/histo.py (pure Python, copied; its one user is
the HTTP server's /metrics).

Reference: airlift's TimeStat/Distribution behind the JMX beans
presto-jmx exposes; ours is a fixed log-bucketed histogram rendered in
the Prometheus text format (cumulative `_bucket{le=...}` lines plus
`_sum`/`_count`), the shape every Prometheus/Grafana p50/p95/p99 query
expects.

Buckets are static (no per-observation allocation) and span 1 ms to
10 min geometrically: sub-bucket precision is irrelevant at the tails
and the fixed bounds make histograms from different processes
mergeable by simple addition.
"""

from __future__ import annotations

import bisect
from typing import List, Sequence

from presto_tpu_torch.obs.sanitizer import make_lock, register_owner

# seconds; geometric ~2.5x ladder from 1ms to 600s
DEFAULT_BOUNDS: Sequence[float] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 120.0, 300.0, 600.0,
)


class Histogram:
    """Thread-safe fixed-bucket histogram of seconds."""

    # lock discipline: observation state
    # shared between completion paths and /metrics scrapes
    _shared_attrs = ("counts", "total", "sum")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS):
        self.bounds: List[float] = sorted(float(b) for b in bounds)
        # counts[i] = observations <= bounds[i] exclusive-bucket form;
        # counts[-1] = the +Inf overflow bucket
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0
        self._lock = make_lock("obs.histo.Histogram._lock")
        register_owner(self)

    def observe(self, seconds: float) -> None:
        v = max(float(seconds), 0.0)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.total += 1
            self.sum += v

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (p50/p95/p99). Exact
        enough for dashboards: the answer lands inside the right
        bucket and interpolates linearly within it."""
        with self._lock:
            total = self.total
            counts = list(self.counts)
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0
        for i, c in enumerate(counts):
            if seen + c >= rank and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.bounds[-1])
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.bounds[-1]

    def prom_lines(self, name: str) -> List[str]:
        """Prometheus histogram exposition: cumulative buckets + sum +
        count (the registry-driven /metrics block appends these)."""
        with self._lock:
            counts = list(self.counts)
            total = self.total
            s = self.sum
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            le = f"{bound:g}"
            lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {total}')
        lines.append(f"{name}_sum {s:.6f}")
        lines.append(f"{name}_count {total}")
        return lines
