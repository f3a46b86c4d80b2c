"""Device-resident table cache over any connector.

Port of presto_tpu/connectors/cached.py. Reference: presto-memory
MemoryPagesStore — pages held resident on the worker so a scan is a
memory read, not a recomputation. The port keeps
the materialized page list on the device: the first scan of a (table,
columns, page-size, constraint, snapshot) combination streams and
retains the pages; every later scan re-yields them. Used by the bench
harness to separate "generate the data" from "run the query" (the
reference's benchmarks scan stored tables; our generator connectors
otherwise fuse dbgen-style generation into every scan),
and usable as a session-level table cache for any repeated-scan
workload.

Key discipline: constraints are keyed by their
CANONICAL structural encoding (`obs/profile.structural_encode` — the
same identity-free walker the plan fingerprint and result-cache keys
use), never `repr()` — a constraint carrying any non-literal object
would leak object identity/ordering into the key, splitting the cache
on repeats and (worse) colliding across distinct constraints whose
reprs merely match. The inner connector's `snapshot_version` also
rides in the key, so wrapping a WRITABLE connector is safe: a write
moves the token and the stale page list becomes unreachable.
`invalidate(table)` / `drop_cache()` reclaim those bytes eagerly — the
runner's DML path calls them through the result-cache invalidation
hook (runner._invalidate_caches).
"""

from __future__ import annotations

from typing import Optional, Sequence


class CachingConnector:
    """Wraps a connector; delegates everything except pages()."""

    def __init__(self, inner):
        self._inner = inner
        self._page_cache = {}

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _key(self, table, columns, target_rows, constraint):
        """Canonical cache key, or None when the inner connector has
        no snapshot token — the SPI contract (None = staleness cannot
        be proven = never cache) applies to this page cache exactly
        like it applies to the result cache."""
        from presto_tpu_torch.cache.rules import snapshot_of
        from presto_tpu_torch.obs.profile import structural_encode

        snap = snapshot_of(self._inner, table)
        if snap is None:
            return None
        return (
            table,
            tuple(columns) if columns is not None else None,
            target_rows,
            structural_encode(constraint) if constraint else None,
            snap,
        )

    def pages(
        self,
        table: str,
        columns: Optional[Sequence[str]] = None,
        target_rows: int = 1 << 20,
        constraint=None,
    ):
        key = self._key(table, columns, target_rows, constraint)
        if key is None:  # snapshot-less inner: stream through
            return self._inner.pages(table, columns, target_rows,
                                     constraint)
        if key not in self._page_cache:
            self._page_cache[key] = list(
                self._inner.pages(table, columns, target_rows, constraint)
            )
        return iter(self._page_cache[key])

    def gen_body(self, table, n, names):
        """No generation to capture: this connector's whole point is
        that a scan is a device-memory read of retained pages.
        Returning None keeps the executor's whole-pipeline fusion
        (which would regenerate inside the fused program and bypass the
        cache) off this path; generated joins (gen_at/key_inverse)
        still delegate — they are lookups, not scans."""
        return None

    def invalidate(self, table: str) -> int:
        """Drop one table's cached page lists (the result-cache
        invalidation path calls this after a write through the
        wrapper; snapshot-keyed entries were already unreachable —
        this frees the device memory now). Returns entries dropped."""
        doomed = [k for k in self._page_cache if k[0] == table]
        for k in doomed:
            del self._page_cache[k]
        return len(doomed)

    def drop_cache(self) -> None:
        self._page_cache.clear()

    @property
    def cached_page_count(self) -> int:
        return sum(len(v) for v in self._page_cache.values())
