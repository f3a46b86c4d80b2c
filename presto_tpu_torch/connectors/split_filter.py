"""Split-range filtering for multi-process (DCN) scans.

Port of presto_tpu/connectors/split_filter.py (SplitFilterConnector;
reference: SOURCE_DISTRIBUTION split assignment — presto-main
execution/scheduler/SourcePartitionedScheduler.java streams each split
to exactly one task). A stage-DAG leaf task's designated table yields
only its round-robin share of splits; every other table scans whole.
Generator connectors make a task's scan of its splits free of other
tasks' data by construction (scan == generate).
"""

from __future__ import annotations

from typing import Optional, Sequence

from presto_tpu_torch.connectors.base import Split


class SplitFilterConnector:
    """Wraps a connector; task ``index`` of ``count`` sees only its
    round-robin share of ``table``'s splits."""

    # pages() below IS the base per-split generation loop over this
    # wrapper's own splits(), so the executor's whole-pipeline fusion
    # (which drives splits() and gen_body directly) may fuse a task's
    # leaf fragment exactly as it fuses the local path
    fused_scan_ok = True

    def __init__(self, inner, table: str, index: int, count: int):
        self._inner = inner
        self._table = table
        self._index = index
        self._count = count

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def splits(self, table: str, target_rows: int):
        splits = self._inner.splits(table, target_rows)
        if table != self._table:
            return splits
        mine = splits[self._index::self._count]
        return mine or [Split(table, 0, 0)]

    def pages(self, table: str, columns: Optional[Sequence[str]] = None,
              target_rows: int = 1 << 20, constraint=None):
        # re-implemented, not delegated: the inner pages() would call
        # the inner splits() and bypass the filter
        splits = self.splits(table, target_rows)
        if constraint:
            splits = self._inner.prune_splits(table, splits, constraint)
        for split in splits:
            if split.row_count:
                yield self._inner.page_for_split(split, columns)
