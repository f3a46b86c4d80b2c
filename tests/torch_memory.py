"""In-memory connector for the port's tests: tables held in host RAM,
staged to the executor's device per split.

A test-side counterpart of the read half of
presto_tpu/connectors/memory.py, with ``create_table`` to hold data:
the skewed and NULL-bearing tables the partitioned joins and late
materialization are checked on, which no generator produces. The port
itself has no memory connector yet (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from presto_tpu_torch import resolve_device
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.base import (
    ColumnSchema,
    Connector,
    Split,
    TableSchema,
)
from presto_tpu_torch.page import Dictionary, Page


class _StoredTable:
    """Host-RAM column store: Python columns plus one dictionary per
    string column, built once at write time."""

    def __init__(self, schema: TableSchema, rows: List[tuple]):
        self.schema = schema
        self.rows = rows
        cols = list(zip(*rows)) if rows else [[] for _ in schema.columns]
        self.columns = [list(c) for c in cols]
        self.dictionaries: Dict[str, Optional[Dictionary]] = {}
        # integer columns as arrays, for split min/max pruning
        self.int_cols: Dict[str, tuple] = {}
        for col, cs in zip(self.columns, schema.columns):
            t = cs.type
            self.dictionaries[cs.name] = (
                Dictionary(sorted({v for v in col if v is not None}))
                if t.is_dictionary_encoded else None)
            if T.is_string(t) or T.is_floating(t):
                continue
            try:
                vals = np.array([0 if v is None else int(v) for v in col],
                                dtype=np.int64)
            except (TypeError, ValueError, OverflowError):
                continue
            nulls = np.array([v is None for v in col], dtype=bool)
            self.int_cols[cs.name] = (vals, nulls)


class MemoryConnector(Connector):
    """``device=None`` stages pages on the card (and raises without
    one); the tests pass ``device="cpu"``."""

    name = "memory"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._tables: Dict[str, _StoredTable] = {}

    def create_table(self, name: str, column_names: Sequence[str],
                     column_types: Sequence[T.SqlType], rows: List[tuple],
                     *, replace: bool = False) -> int:
        if name in self._tables and not replace:
            raise ValueError(f"table already exists: {name}")
        schema = TableSchema(name, tuple(
            ColumnSchema(n, t) for n, t in zip(column_names, column_types)))
        self._tables[name] = _StoredTable(schema, list(rows))
        return len(rows)

    def tables(self) -> List[str]:
        return sorted(self._tables)

    def table_schema(self, table: str) -> TableSchema:
        t = self._tables.get(table)
        if t is None:
            raise KeyError(f"no table {table!r}")
        return t.schema

    def row_count(self, table: str) -> int:
        return len(self._tables[table].rows)

    def prune_splits(self, table, splits, constraint):
        """Per-split min/max pruning over the stored integer columns (a
        split all-null in a constrained column never matches)."""
        t = self._tables.get(table)
        if t is None:
            return splits
        out = []
        for s in splits:
            keep = True
            for col, lo, hi in constraint:
                stats = t.int_cols.get(col)
                if stats is None:
                    continue
                vals, nulls = stats
                seg = vals[s.start_row:s.start_row + s.row_count]
                ok = ~nulls[s.start_row:s.start_row + s.row_count]
                if not ok.any():
                    keep = False
                    break
                smin, smax = seg[ok].min(), seg[ok].max()
                if ((lo is not None and smax < lo)
                        or (hi is not None and smin > hi)):
                    keep = False
                    break
            if keep:
                out.append(s)
        return out

    def page_for_split(self, split: Split,
                       columns: Optional[Sequence[str]] = None) -> Page:
        t = self._tables[split.table]
        names = (tuple(columns) if columns is not None
                 else tuple(t.schema.column_names()))
        lo, hi = split.start_row, split.start_row + split.row_count
        cols, types, dicts = [], [], []
        for nm in names:
            idx = t.schema.column_index(nm)
            cols.append(t.columns[idx][lo:hi])
            types.append(t.schema.columns[idx].type)
            dicts.append(t.dictionaries.get(nm))
        return Page.from_arrays(cols, types, dictionaries=dicts,
                                device=self.device)
