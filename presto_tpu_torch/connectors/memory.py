"""In-memory connector: CREATE TABLE AS / INSERT store tables in host
RAM; scans stage them to the executor's device, one split at a time
(the host->device path, unlike the generators, which compute rows on
the device).

Port of presto_tpu/connectors/memory.py (reference: presto-memory's
MemoryConnector, MemoryPagesStore, MemoryPageSinkProvider — named in
BASELINE config 1). Each column is kept as ONE host array in its page
representation, built at write time: the physical values (zero at a
NULL), the NULL mask, and for a dictionary type the codes into one
sorted dictionary of the column's distinct non-null values. A split's
page is then a slice of each array and one host->device copy, and it
equals the reference's page for the same rows: the same codes, the same
dictionaries and the same NULL masks.

Writes arrive as Python rows (the reference's interface) or, from the
runner, as the executor's result pages (``create_table_pages`` /
``insert_pages``), which skip the per-value Python round trip.

One divergence: a table written from result pages may declare unique
columns (``unique=``), which ``unique_columns`` reports; the runner
passes the output columns the plan proves unique (a source's declared
key carried through filters and identity projections), so CREATE TABLE
AS copies of TPC-H keep their primary keys and a DELETE or UPDATE keeps
the keys it does not assign. An INSERT drops them. The reference's
connector declares none. The planner orders joins by them: without
them, TPC-H Q5 over memory copies joins customer on c_nationkey before
orders and fans out (at SF 0.01 the plan needs a capacity-boost retry;
at SF 0.05 it did not finish in ten minutes), and with them the
executor's unique-key join path (K2) applies. A table written from rows
declares none, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch import resolve_device
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.base import (
    ColumnSchema,
    Connector,
    Split,
    TableSchema,
)
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.page import Block, Dictionary, Page, _decode_block

_M64 = (1 << 64) - 1


def _round_up(n: int, multiple: int = 8) -> int:
    return ((max(n, 1) + multiple - 1) // multiple) * multiple


def _is_long_decimal(t: T.SqlType) -> bool:
    return isinstance(t, T.DecimalType) and not t.is_short


class _Column:
    """One stored column: ``data`` (a numpy array, or an (hi, lo) pair
    of int64 arrays for a long decimal), ``nulls`` (bool array) and the
    dictionary of a dictionary-encoded type."""

    __slots__ = ("data", "nulls", "dictionary")

    def __init__(self, data, nulls: np.ndarray,
                 dictionary: Optional[Dictionary] = None):
        self.data = data
        self.nulls = nulls
        self.dictionary = dictionary

    def __len__(self) -> int:
        return len(self.nulls)


def _sorted_dictionary(values, isnull: np.ndarray):
    """(codes, Dictionary) of host values over ONE sorted dictionary of
    the distinct non-null values (the reference's write-time encoding)."""
    d = Dictionary(sorted({v for v, nl in zip(values, isnull) if not nl}))
    index = d._index
    codes = np.fromiter((0 if nl else index[v]
                         for v, nl in zip(values, isnull)),
                        np.int32, len(values))
    return codes, d


def _column_from_values(values: Sequence, t: T.SqlType) -> _Column:
    """Python values (None = NULL) -> a stored column."""
    values = list(values)
    n = len(values)
    isnull = np.fromiter((v is None for v in values), bool, n)
    if t.is_dictionary_encoded:
        codes, d = _sorted_dictionary(values, isnull)
        return _Column(codes, isnull, d)
    if _is_long_decimal(t):
        hi = np.zeros(n, np.int64)
        lo = np.zeros(n, np.int64)
        for i, v in enumerate(values):
            if v is None:
                continue
            u = int(v) & _M64
            lo[i] = u - (1 << 64) if u >> 63 else u
            hi[i] = int(v) >> 64
        return _Column((hi, lo), isnull)
    arr = np.zeros(n, dtype=t.numpy_dtype)
    for i, v in enumerate(values):
        if v is not None:
            arr[i] = v
    return _Column(arr, isnull)


def _column_from_blocks(blocks: List[Block], rows_idx: List[np.ndarray],
                        t: T.SqlType) -> _Column:
    """The selected rows of one channel across result pages -> a stored
    column, without a Python value per row (except for collect results,
    whose nested slots decode through the page module)."""
    def host(x):
        return XF.np_host(x, label="table-write")

    if not blocks:
        return _column_from_values([], t)
    nulls = np.concatenate(
        [host(b.nulls)[idx] if b.nulls is not None
         else np.zeros(len(idx), bool) for b, idx in zip(blocks, rows_idx)])
    if any(isinstance(b.data, tuple) for b in blocks) and not \
            _is_long_decimal(t):
        # collect results (array_agg / map_agg state): Python values
        values = []
        for b, idx in zip(blocks, rows_idx):
            values.extend(_decode_block(b, idx))
        return _column_from_values(values, t)
    if t.is_dictionary_encoded:
        # one sorted dictionary of the values the rows use: remap each
        # page's codes through a table over its used codes
        parts, universe = [], set()
        for b, idx in zip(blocks, rows_idx):
            codes = host(b.data)[idx].astype(np.int64)
            nl = host(b.nulls)[idx] if b.nulls is not None else None
            live = codes if nl is None else codes[~nl]
            used = np.unique(live)
            vals = b.dictionary.values[used] if len(used) else []
            universe.update(vals)
            parts.append((codes, nl, used, vals))
        d = Dictionary(sorted(universe))
        out = []
        for codes, nl, used, vals in parts:
            if not len(used):
                out.append(np.zeros(len(codes), np.int32))
                continue
            lut = np.fromiter((d._index[v] for v in vals), np.int32,
                              len(used))
            pos = np.clip(np.searchsorted(used, codes), 0, len(used) - 1)
            new = lut[pos]
            if nl is not None:
                new[nl] = 0
            out.append(new)
        return _Column(np.concatenate(out).astype(np.int32), nulls, d)
    if _is_long_decimal(t):
        hi = np.concatenate([host(b.data[0])[idx]
                             for b, idx in zip(blocks, rows_idx)])
        lo = np.concatenate([host(b.data[1])[idx]
                             for b, idx in zip(blocks, rows_idx)])
        hi[nulls] = 0
        lo[nulls] = 0
        return _Column((hi, lo), nulls)
    data = np.concatenate([host(b.data)[idx]
                           for b, idx in zip(blocks, rows_idx)])
    data = data.astype(t.numpy_dtype, copy=False)
    data[nulls] = 0
    return _Column(data, nulls)


def _concat_columns(a: _Column, b: _Column, t: T.SqlType) -> _Column:
    """Rows of ``a`` then ``b`` (an INSERT): a dictionary column gets the
    sorted union of both dictionaries, and both code arrays remap."""
    nulls = np.concatenate([a.nulls, b.nulls])
    if t.is_dictionary_encoded:
        d = Dictionary(sorted(set(a.dictionary.values)
                              | set(b.dictionary.values)))
        parts = []
        for c in (a, b):
            lut = np.fromiter((d._index[v] for v in c.dictionary.values),
                              np.int32, len(c.dictionary))
            new = lut[c.data] if len(lut) else np.zeros(len(c), np.int32)
            new[c.nulls] = 0
            parts.append(new)
        return _Column(np.concatenate(parts).astype(np.int32), nulls, d)
    if isinstance(a.data, tuple):
        return _Column(tuple(np.concatenate([x, y])
                             for x, y in zip(a.data, b.data)), nulls)
    return _Column(np.concatenate([a.data, b.data]), nulls)


class _StoredTable:
    """Host-RAM column store (MemoryPagesStore analog)."""

    def __init__(self, schema: TableSchema, columns: List[_Column],
                 unique: frozenset = frozenset()):
        self.schema = schema
        self.columns = columns
        self.row_count = len(columns[0]) if columns else 0
        self.unique = unique
        # integer column arrays for split min/max pruning (the memory
        # connector's TupleDomain stats): every type whose values are
        # integers (the reference skips strings, floats, and the values
        # int() rejects: arrays, maps, rows, varbinary)
        self.int_cols: Dict[str, tuple] = {}
        for col, cs in zip(columns, schema.columns):
            t = cs.type
            if t.is_dictionary_encoded or T.is_floating(t):
                continue
            if isinstance(col.data, tuple):
                hi, lo = col.data
                if not np.array_equal(hi, lo >> 63):
                    continue  # a value past int64: the reference skips
                vals = lo
            else:
                vals = col.data.astype(np.int64)
            self.int_cols[cs.name] = (vals, col.nulls)


class MemoryConnector(Connector):
    """``device=None`` stages pages on the card (and raises without
    one); the tests pass ``device="cpu"``."""

    name = "memory"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._tables: Dict[str, _StoredTable] = {}
        # per-table write counter: every mutation path bumps it, so
        # snapshot_version moves even when the row count does not
        # (UPDATE rewrites through create_table(replace=True) with the
        # same cardinality)
        self._write_versions: Dict[str, int] = {}

    def _bump(self, name: str) -> None:
        self._write_versions[name] = self._write_versions.get(name, 0) + 1

    def snapshot_version(self, table: str) -> str:
        t = self._tables.get(table)
        return (f"w{self._write_versions.get(table, 0)}"
                f":r{t.row_count if t is not None else 0}")

    # ------------------------------------------------------------- write
    def _store(self, name: str, column_names, column_types, columns,
               replace: bool, unique=()) -> int:
        if name in self._tables and not replace:
            raise ValueError(f"table already exists: {name}")
        schema = TableSchema(name, tuple(
            ColumnSchema(n, t) for n, t in zip(column_names, column_types)))
        table = _StoredTable(schema, columns, frozenset(unique))
        self._tables[name] = table
        self._bump(name)
        return table.row_count

    def create_table(self, name: str, column_names: Sequence[str],
                     column_types: Sequence[T.SqlType], rows: List[tuple],
                     *, replace: bool = False) -> int:
        cols = list(zip(*rows)) if rows else [[] for _ in column_types]
        return self._store(name, column_names, column_types, [
            _column_from_values(c, t) for c, t in zip(cols, column_types)],
            replace)

    def create_table_pages(self, name: str, column_names: Sequence[str],
                           column_types: Sequence[T.SqlType],
                           pages: List[Page], *, replace: bool = False,
                           unique: Sequence[str] = ()) -> int:
        """create_table from result pages: their selected rows, in page
        order (what ``Executor.execute`` would return as rows), with the
        columns ``unique`` names declared unique."""
        return self._store(name, column_names, column_types,
                           _columns_of_pages(pages, column_types), replace,
                           unique)

    def insert(self, name: str, rows: List[tuple]) -> int:
        t = self._table(name)
        cols = list(zip(*rows)) if rows else [[] for _ in t.schema.columns]
        return self._append(name, t, [
            _column_from_values(c, cs.type)
            for c, cs in zip(cols, t.schema.columns)])

    def insert_pages(self, name: str, pages: List[Page]) -> int:
        t = self._table(name)
        return self._append(name, t, _columns_of_pages(
            pages, [cs.type for cs in t.schema.columns]))

    def _append(self, name: str, t: _StoredTable, new: List[_Column]) -> int:
        n = len(new[0]) if new else 0
        self._tables[name] = _StoredTable(t.schema, [
            _concat_columns(a, b, cs.type)
            for a, b, cs in zip(t.columns, new, t.schema.columns)])
        self._bump(name)
        return n

    def drop_table(self, name: str) -> None:
        self._table(name)
        del self._tables[name]
        self._bump(name)

    # -------------------------------------------------------------- read
    def _table(self, name: str) -> _StoredTable:
        t = self._tables.get(name)
        if t is None:
            raise KeyError(f"no table {name!r}")
        return t

    def tables(self) -> List[str]:
        return sorted(self._tables)

    def table_schema(self, table: str) -> TableSchema:
        return self._table(table).schema

    def row_count(self, table: str) -> int:
        return self._tables[table].row_count

    def unique_columns(self, table: str) -> frozenset:
        t = self._tables.get(table)
        return frozenset() if t is None else t.unique

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
                    keep = False  # all-null: no comparison can pass
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
        """Rows [start, start + n) as a page of capacity n rounded up to
        8: each column's slice padded with zeros (NULL in the mask, which
        a block carries only when one of its rows is NULL), one copy to
        the device per array."""
        t = self._tables[split.table]
        names = (tuple(columns) if columns is not None
                 else tuple(t.schema.column_names()))
        lo, n = split.start_row, split.row_count
        cap = _round_up(n)
        dev = self.device

        def staged(arr: np.ndarray, fill=0) -> torch.Tensor:
            out = np.full(cap, fill, dtype=arr.dtype)
            out[:n] = arr[lo:lo + n]
            return XF.to_device(out, dev, label="page-build")

        blocks = []
        for nm in names:
            idx = t.schema.column_index(nm)
            col = t.columns[idx]
            typ = t.schema.columns[idx].type
            nulls = (staged(col.nulls, True)
                     if col.nulls[lo:lo + n].any() else None)
            data = (tuple(staged(x) for x in col.data)
                    if isinstance(col.data, tuple) else staged(col.data))
            blocks.append(Block(data=data, type=typ, nulls=nulls,
                                dictionary=col.dictionary))
        valid = np.zeros(cap, dtype=bool)
        valid[:n] = True
        return Page(blocks=tuple(blocks),
                    valid=XF.to_device(valid, dev, label="page-build"))


def _columns_of_pages(pages: List[Page], types) -> List[_Column]:
    rows_idx = [np.nonzero(XF.np_host(p.valid, label="table-write"))[0]
                for p in pages]
    return [_column_from_blocks([p.blocks[c] for p in pages], rows_idx, t)
            for c, t in enumerate(types)]
