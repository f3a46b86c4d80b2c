"""Split-range filtering for multi-process (DCN) scans.

Port of presto_tpu/connectors/split_filter.py (SplitFilterConnector;
reference: SOURCE_DISTRIBUTION split assignment — presto-main
execution/scheduler/SourcePartitionedScheduler.java streams each split
to exactly one task). A stage-DAG leaf task's designated table yields
only its round-robin share of splits; every other table scans whole.
Generator connectors make a task's scan of its splits free of other
tasks' data by construction (scan == generate). HashSplitConnector is
the legacy hash fan-out's scan (dist/dcn.py): a worker keeps the rows
of each co-partitioned table whose partition column hashes to it.
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

    def snapshot_version(self, table: str):
        """The split share is part of this wrapper's content: two tasks
        of one fragment on different shares never address one
        result-cache entry, so the filtered table's token carries
        (index, count) on top of the inner connector's version."""
        from presto_tpu_torch.cache.rules import snapshot_of

        inner = snapshot_of(self._inner, table)
        if inner is None or table != self._table:
            return inner
        return f"{inner}/split{self._index}.{self._count}"

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


class HashSplitConnector:
    """Hash-repartitioned scans: worker ``index`` of ``count`` sees only
    the rows of each partitioned table whose PARTITION COLUMN hashes to
    it — the legacy cuts' realization of the reference's
    hash-repartition exchange (``ExchangeNode(REPARTITION)`` →
    ``PartitionedOutputOperator`` routing rows by hash(key) % n).

    Instead of routing pages between workers, each worker re-scans and
    masks: for the generator connectors a scan IS a compute (scan ==
    generate), so "receiving my partition" and "generating my
    partition" are the same device work. Tables co-partitioned on their
    join keys make every partition-local join a partition of the global
    join. The assignment is the reference's bit for bit:
    ``hash_columns(equality_encoding(key)) % count`` over the u64 hash,
    null keys on worker 0. ``pages()`` masks rows after generation, so
    this wrapper does not declare ``fused_scan_ok``."""

    def __init__(self, inner, partition_cols, index: int, count: int):
        self._inner = inner
        self._partition_cols = dict(partition_cols)  # table -> column
        self._index = index
        self._count = count

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def snapshot_version(self, table: str):
        """SplitFilterConnector's rule: a hash-partitioned scan's content
        is (inner content, partition column, index/count), and its
        result-cache token says so."""
        from presto_tpu_torch.cache.rules import snapshot_of

        inner = snapshot_of(self._inner, table)
        col = self._partition_cols.get(table)
        if inner is None or col is None:
            return inner
        return f"{inner}/hash.{col}.{self._index}.{self._count}"

    def _mask_page(self, page, table: str, columns):
        from presto_tpu_torch.ops import hashing as H
        from presto_tpu_torch.ops import keys as K
        from presto_tpu_torch.ops import u64

        blk = page.block(list(columns).index(self._partition_cols[table]))
        cols = K.equality_encoding(blk)
        h = H.hash_columns(cols, [None] * len(cols))
        mine = u64.umod(h, self._count) == self._index
        if blk.nulls is not None:
            # null keys go to worker 0, so every row lands exactly once
            mine = (mine | blk.nulls) if self._index == 0 \
                else (mine & ~blk.nulls)
        return page.with_valid(page.valid & mine)

    def pages(self, table: str, columns: Optional[Sequence[str]] = None,
              target_rows: int = 1 << 20, constraint=None):
        part_col = self._partition_cols.get(table)
        if columns is None:
            columns = list(self._inner.table_schema(table).column_names())
        scan_cols = list(columns)
        added = part_col is not None and part_col not in scan_cols
        if added:
            scan_cols.append(part_col)
        splits = self._inner.splits(table, target_rows)
        if constraint:
            splits = self._inner.prune_splits(table, splits, constraint)
        for split in splits:
            if not split.row_count:
                continue
            page = self._inner.page_for_split(split, scan_cols)
            if part_col is not None:
                page = self._mask_page(page, table, scan_cols)
                if added:
                    page = page.select_channels(range(len(scan_cols) - 1))
            yield page
