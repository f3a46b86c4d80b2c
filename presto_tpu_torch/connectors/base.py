"""Connector SPI.

Port of presto_tpu/connectors/base.py (the parts the slice uses):
describe tables, enumerate row-range splits, and produce columnar Pages
for a range. Generator connectors compute every column on the device
from the global row index — "scan" is "generate".

Reference: presto-spi spi/connector/* — ConnectorMetadata,
ConnectorSplitManager, ConnectorPageSourceProvider.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.exec import shapes as SH
from presto_tpu_torch.page import Block, Page


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    name: str
    type: T.SqlType


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    columns: Tuple[ColumnSchema, ...]

    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def column_index(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(f"no column {name!r} in table {self.name!r}")

    def column_type(self, name: str) -> T.SqlType:
        return self.columns[self.column_index(name)].type


@dataclasses.dataclass(frozen=True)
class Split:
    """A row range of a table (reference: spi/ConnectorSplit)."""

    table: str
    start_row: int
    row_count: int


class GeneratorConnector:
    """Mixin for on-device deterministic generators: column-pruned chunk
    generation from the global row index. Subclasses provide
    ``_schemas``, ``_dicts`` (table -> column -> Dictionary), ``device``,
    and per table either ``_gen_<table>_at(idx)`` (elementwise in the
    row index) or ``_gen_<table>(start, n)``, returning a _Lazy whose
    columns are flat over the rows ``start + arange(n)`` (``start`` may
    be a column of B starts, for B chunks at once)."""

    def page_for_split(self, split: "Split",
                       columns: Optional[Sequence[str]] = None) -> Page:
        """Generate one split over the CANONICAL (ladder-bucketed,
        exec/shapes.py) chunk shape, as the reference does: rows past
        the split's real count are generated and masked out of valid."""
        schema = self.table_schema(split.table)
        names = tuple(columns) if columns is not None else tuple(
            schema.column_names()
        )
        n_pad = SH.bucket(split.row_count)
        datas, valid = self.gen_body(split.table, n_pad, names)(
            split.start_row)
        in_range = torch.arange(n_pad, device=self.device) < split.row_count
        dicts = self._dicts.get(split.table, {})
        blocks = tuple(
            Block(data=d, type=schema.column_type(nm), nulls=None,
                  dictionary=dicts.get(nm))
            for nm, d in zip(names, datas)
        )
        return Page(blocks=blocks, valid=valid & in_range)

    def _lazy_rows(self, table: str, start, n: int):
        """The table's _Lazy over rows ``start + arange(n)``, flattened
        (``start`` an int, a 0-d or a [B, 1] int64 tensor)."""
        at = getattr(self, f"_gen_{table}_at", None)
        if at is not None:
            return at((start + torch.arange(n, dtype=torch.int64,
                                            device=self.device)
                       ).reshape(-1))
        return getattr(self, f"_gen_{table}")(start, n)

    def gen_body(self, table: str, n: int, names: Tuple[str, ...]):
        """Connector.gen_body: ``start -> (column tensors, valid)`` over
        rows [start, start + n). ``start`` is a 0-d int64 tensor on the
        device (a graph replays it with the start written in place) or,
        for an eager page, an int."""

        def fn(start):
            lazy = self._lazy_rows(table, start, n)
            return tuple(lazy.get(nm) for nm in names), lazy.get("__valid__")

        return fn

    def gen_batch(self, table: str, n: int, names: Tuple[str, ...]):
        """Connector.gen_batch in one pass over all B chunks: the columns
        come flat, chunk b at rows [b * n, (b + 1) * n)."""

        def fn(starts):
            lazy = self._lazy_rows(table, starts.reshape(-1, 1), n)
            return tuple(lazy.get(nm) for nm in names), lazy.get("__valid__")

        return fn

    def gen_at(self, table: str, names: Tuple[str, ...]):
        """Connector.gen_at for tables whose columns are elementwise in
        the row index (``_gen_<table>_at``); None otherwise."""
        at = getattr(self, f"_gen_{table}_at", None)
        if at is None:
            return None

        def fn(idx):
            lazy = at(idx)
            return tuple(lazy.get(nm) for nm in names), lazy.get("__valid__")

        return fn

    def prune_splits(self, table: str, splits: List[Split], constraint):
        """Drop splits whose rows provably miss a pushed key range, for
        columns with a monotonic_row_bound."""
        out = splits
        for col, lo, hi in constraint:
            f = self.monotonic_row_bound(table, col)
            if f is None:
                continue
            row_lo = max(f(lo), 0) if lo is not None else 0
            row_hi = max(f(hi + 1), 0) if hi is not None else None
            out = [
                s for s in out
                if s.start_row + s.row_count > row_lo
                and (row_hi is None or s.start_row < row_hi)
            ]
        return out

    def host_rows(self, table: str, target_rows: int = 1 << 20):
        """Materialize a table as Python row tuples (oracle loading)."""
        out = []
        for page in self.pages(table, target_rows=target_rows):
            out.extend(page.to_pylist())
        return out


class Connector:
    """Reference: spi/connector/Connector + ConnectorMetadata."""

    name: str = "connector"

    def tables(self) -> List[str]:
        raise NotImplementedError

    def table_schema(self, table: str) -> TableSchema:
        raise NotImplementedError

    def row_count(self, table: str) -> int:
        raise NotImplementedError

    def unique_columns(self, table: str) -> frozenset:
        """Columns whose values are unique across the table (primary
        keys) — the unique-key join fast path consults them."""
        return frozenset()

    def snapshot_version(self, table: str) -> Optional[str]:
        """Opaque token that changes whenever the table's CONTENT may
        have changed: the result cache (presto_tpu_torch/cache/) folds
        it into every key, so a write makes stale entries structurally
        unreachable (reference analog: connector-provided table
        versions consulted for materialized-view staleness).

        Default: the row count, exact for the immutable deterministic
        generators (content is a pure function of schema and scale, and
        scale moves the count). A writable connector overrides it with
        a token that also moves on writes that keep the cardinality
        (UPDATE): the memory connector bumps a write counter. None =
        staleness cannot be proven, and the table's scans never
        cache."""
        try:
            return f"rows:{self.row_count(table)}"
        except Exception:  # noqa: BLE001 - a connector without counts
            return None    # is simply uncacheable, never a query error

    def splits(self, table: str, target_rows: int) -> List[Split]:
        """Chop the table into row-range splits of ~target_rows each."""
        total = self.row_count(table)
        out = []
        start = 0
        while start < total:
            n = min(target_rows, total - start)
            out.append(Split(table, start, n))
            start += n
        return out or [Split(table, 0, 0)]

    def page_for_split(
        self, split: Split, columns: Optional[Sequence[str]] = None
    ) -> Page:
        raise NotImplementedError

    def prune_splits(self, table: str, splits: List[Split],
                     constraint) -> List[Split]:
        """Drop splits that provably hold no row of the pushed constraint
        ((column, lo, hi) closed integer ranges). Advisory: the engine
        applies the full predicate to what survives."""
        return splits

    def monotonic_row_bound(self, table: str, column: str):
        """For a column non-decreasing in the row index: f(v) = the
        smallest row index whose value >= v; None if not monotonic."""
        return None

    def gen_body(self, table: str, n: int, names: Tuple[str, ...]):
        """Optional chunk generator: ``start -> (column tensors, valid)``
        over rows [start, start + n), ``start`` a 0-d int64 device
        tensor. It launches work only — no host reads, no control flow
        on ``start`` — so the executor can capture it into a CUDA graph
        and replay it per split (exec/executor._fused_stream). None when
        the connector only produces pages."""
        return None

    def gen_batch(self, table: str, n: int, names: Tuple[str, ...]):
        """Optional batched generator: ``starts[B] -> (column tensors,
        valid)`` with the B chunks flat, chunk b at rows [b * n,
        (b + 1) * n) — the generation half of split-batched execution.
        Derived from gen_body by default."""
        body = self.gen_body(table, n, names)
        if body is None:
            return None

        def fn(starts):
            chunks = [body(starts[b]) for b in range(starts.shape[0])]
            datas = tuple(torch.cat(cols) for cols in
                          zip(*(c[0] for c in chunks)))
            return datas, torch.cat([c[1] for c in chunks])

        return fn

    def gen_at(self, table: str, names: Tuple[str, ...]):
        """Optional random-access generator: ``row_idx -> (column
        tensors, valid)`` at arbitrary int64 row indices (clipped to the
        table by the caller). With key_inverse it makes a join against
        the table build-free. None when the table cannot be generated at
        scattered indices."""
        return None

    def key_inverse(self, table: str, column: str):
        """Optional closed-form inverse of a unique key column: ``vals ->
        (row_idx, found)``; for every value present, row_idx is the row
        holding it and found is true; for any other value found is false
        (row_idx may be anything — callers clip before generating). None
        when no closed form exists."""
        return None

    def key_window_inverse(self, table: str, column: str):
        """Optional windowed inverse ``(fn, L)``: ``fn(vals) -> (base_idx,
        found)`` with every row holding v in [base_idx, base_idx + L).
        None when the column has no window structure."""
        return None

    def pages(
        self,
        table: str,
        columns: Optional[Sequence[str]] = None,
        target_rows: int = 1 << 20,
        constraint=None,
    ) -> Iterator[Page]:
        splits = self.splits(table, target_rows)
        if constraint:
            splits = self.prune_splits(table, splits, constraint)
        for split in splits:
            if split.row_count:
                yield self.page_for_split(split, columns)
