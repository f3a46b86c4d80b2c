"""Append-log stream connector: the engine's streaming-source column.

Port of presto_tpu/connectors/stream.py (reference: PAPER.md §1 lists
streaming sources, Kafka, among the original's connectors). The port
keeps what matters to the engine — an APPEND-ONLY log whose read
position is a monotone offset — and drops the broker: rows append to a
host-RAM column log, the log's ``snapshot_version`` IS its offset, and
readers choose between three views of the same data:

  - a FULL scan (``pages``/``splits``): the log looks like any other
    table, so every operator, cache path and oracle harness composes;
  - a DELTA scan (``scan_from(offset)``): only the pages appended since
    ``offset`` — the O(new rows) input of an incremental view refresh
    (streaming/ivm.py);
  - a PINNED window (``StreamWindowConnector``): a fixed ``[lo, hi)``
    row range presented AS the table, whose snapshot token carries the
    PINNED offset instead of the live head, so a result-cache entry
    built at offset N keeps hitting for a reader pinned at N while the
    log grows (cache/rules.stream_watermark, store.advance_tables).

Offsets are row counts: an append extends the log under the
connector's condition and wakes every ``wait_for_offset`` long-poller
(the tailing /v1/statement cursors). Appends never rewrite existing
rows, and dictionary codes are assigned in FIRST-SEEN order and only
ever appended, so the encoded prefix of the log is immutable and a
pinned-offset replay is byte-stable.

Storage differs from the reference's Python value lists: each append
is one chunk of host arrays in page representation (the memory
connector's: physical values, zero at a NULL, a NULL mask; codes into
the log's first-seen dictionary for a dictionary type), so a split's
page is a copy of chunk slices and one host->device copy per array. It
equals the reference's page for the same rows: the same codes, the
same first-seen dictionary, the same NULL masks.

Writes come as Python rows (the reference's ``create_table`` /
``insert`` / ``append``) or, from the port's runner, as result pages
(``create_table_pages`` / ``insert_pages``): each page's codes remap
into the log's dictionary in the rows' first-seen order, as the row
path would assign them. ``device=None`` stages pages on the card (and
raises without one); the tests pass ``device="cpu"``.
"""

from __future__ import annotations

import bisect
import time
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
from presto_tpu_torch.connectors.memory import (
    _column_from_blocks,
    _column_from_values,
    _Column,
    _is_long_decimal,
    _round_up,
)
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.obs.sanitizer import make_condition, register_owner
from presto_tpu_torch.page import Block, Dictionary, Page, _decode_block


class _Codes:
    """One dictionary column's first-seen dictionary: the values in
    code order and their index. Only ever extended, under the
    connector's condition."""

    __slots__ = ("values", "index", "_cached")

    def __init__(self):
        self.values: list = []
        self.index: Dict = {}
        self._cached: Optional[Dictionary] = None

    def dictionary(self, n: int) -> Dictionary:
        """The Dictionary of the first ``n`` values: append-only, so it
        never changes once built (one object per length, reused by
        every page read at that length)."""
        d = self._cached
        if d is None or len(d) != n:
            d = Dictionary(self.values[:n])
            self._cached = d
        return d


class _Pending:
    """Values first seen by one batch, before the batch commits: codes
    continue the dictionary, nothing is written to it until then."""

    __slots__ = ("codes", "fresh", "fresh_index")

    def __init__(self, codes: _Codes):
        self.codes = codes
        self.fresh: list = []
        self.fresh_index: Dict = {}

    def code(self, v) -> int:
        c = self.codes.index.get(v)
        if c is None:
            c = self.fresh_index.get(v)
            if c is None:
                c = len(self.codes.values) + len(self.fresh)
                self.fresh.append(v)
                self.fresh_index[v] = c
        return c

    def commit(self) -> None:
        base = len(self.codes.values)
        self.codes.values.extend(self.fresh)
        for i, v in enumerate(self.fresh):
            self.codes.index[v] = base + i


def _encode_values(values: Sequence, t: T.SqlType,
                   pending: Optional[_Pending]) -> _Column:
    """Python values (None = NULL) -> one chunk column; a dictionary
    type takes first-seen codes through ``pending``."""
    if pending is None:
        return _column_from_values(values, t)
    n = len(values)
    nulls = np.fromiter((v is None for v in values), bool, n)
    codes = np.fromiter((0 if v is None else pending.code(v)
                         for v in values), np.int32, n)
    return _Column(codes, nulls)


def _first_seen(codes: np.ndarray, wanted) -> list:
    """``wanted`` codes in the order of their first occurrence in
    ``codes``, found over chunks that grow 4x (a first occurrence is
    almost always early, so a page rarely pays more than one small
    ``np.unique``)."""
    left = set(int(c) for c in wanted)
    found = []
    start, step = 0, 1 << 16
    while left and start < len(codes):
        u, first = np.unique(codes[start:start + step], return_index=True)
        for c, f in zip(u.tolist(), first.tolist()):
            if c in left:
                found.append((start + f, c))
                left.discard(c)
        start += step
        step *= 4
    return [c for _pos, c in sorted(found)]


def _encode_blocks(blocks: List[Block], rows_idx: List[np.ndarray],
                   t: T.SqlType, pending: Optional[_Pending]) -> _Column:
    """The selected rows of one channel across result pages -> one
    chunk column. A dictionary channel's codes remap into the log's
    dictionary; values the log has not seen take codes in the order of
    their first row, page by page."""
    if pending is None:
        return _column_from_blocks(blocks, rows_idx, t)
    if any(isinstance(b.data, tuple) for b in blocks):
        values = []
        for b, idx in zip(blocks, rows_idx):
            values.extend(_decode_block(b, idx))
        return _encode_values(values, t, pending)
    out, out_nulls = [], []
    for b, idx in zip(blocks, rows_idx):
        codes = XF.np_host(b.data, label="table-write")[idx].astype(
            np.int64)
        nl = (XF.np_host(b.nulls, label="table-write")[idx]
              if b.nulls is not None else np.zeros(len(idx), bool))
        live = codes[~nl]
        vals = b.dictionary.values
        lut = np.zeros(max(len(vals), 1), np.int32)
        if len(live):
            used = np.nonzero(np.bincount(live, minlength=len(vals)))[0]
            unknown = []
            for c in used:
                known = pending.codes.index.get(vals[c])
                if known is None:
                    known = pending.fresh_index.get(vals[c])
                if known is None:
                    unknown.append(c)
                else:
                    lut[c] = known
            # the new values take codes in the order of their first row
            for c in _first_seen(live, unknown):
                lut[c] = pending.code(vals[c])
        new = lut[np.clip(codes, 0, len(lut) - 1)]
        new[nl] = 0
        out.append(new.astype(np.int32, copy=False))
        out_nulls.append(nl)
    if not out:
        return _Column(np.zeros(0, np.int32), np.zeros(0, bool))
    return _Column(np.concatenate(out), np.concatenate(out_nulls))


class _StreamTable:
    """One append-only log: a chunk of columns per append, each in page
    representation, plus a first-seen dictionary per dictionary column.
    Mutated only under the owning connector's condition; chunks below
    the published offset are immutable."""

    def __init__(self, schema: TableSchema):
        self.schema = schema
        self.chunks: List[List[_Column]] = []
        self.starts: List[int] = []  # first row of each chunk
        self.codes: Dict[str, _Codes] = {
            c.name: _Codes() for c in schema.columns
            if c.type.is_dictionary_encoded}
        self.offset = 0  # rows appended so far == snapshot offset
        self.appends = 0

    def _pending(self) -> Dict[str, _Pending]:
        return {name: _Pending(c) for name, c in self.codes.items()}

    def encode_rows(self, rows: Sequence[tuple]):
        """Validate the WHOLE batch, then encode it (nothing mutates:
        a mid-batch failure never leaves orphan rows or codes below
        the published offset)."""
        ncols = len(self.schema.columns)
        for r in rows:
            if len(r) != ncols:
                raise ValueError(
                    f"row arity {len(r)} != schema arity {ncols} for "
                    f"stream {self.schema.name!r}")
        pend = self._pending()
        cols = list(zip(*rows)) if rows else [()] * ncols
        chunk = [_encode_values(list(v), cs.type, pend.get(cs.name))
                 for v, cs in zip(cols, self.schema.columns)]
        return chunk, pend

    def encode_pages(self, pages: List[Page]):
        if pages and len(pages[0].blocks) != len(self.schema.columns):
            raise ValueError(
                f"page arity {len(pages[0].blocks)} != schema arity "
                f"{len(self.schema.columns)} for stream "
                f"{self.schema.name!r}")
        rows_idx = [np.nonzero(XF.np_host(p.valid, label="table-write"))[0]
                    for p in pages]
        pend = self._pending()
        chunk = [_encode_blocks([p.blocks[c] for p in pages], rows_idx,
                                cs.type, pend.get(cs.name))
                 for c, cs in enumerate(self.schema.columns)]
        return chunk, pend

    def extend(self, chunk: List[_Column], pend: Dict[str, _Pending]):
        """Publish one encoded batch: its first-seen values join the
        dictionaries, its rows the log, and the offset advances."""
        for p in pend.values():
            p.commit()
        n = len(chunk[0]) if chunk else 0
        if n:
            self.chunks.append(chunk)
            self.starts.append(self.offset)
        self.offset += n
        self.appends += 1

    def pieces(self, lo: int, hi: int):
        """[(chunk, start within it, stop within it)] covering rows
        [lo, hi) in order."""
        out = []
        i = max(bisect.bisect_right(self.starts, lo) - 1, 0)
        while i < len(self.chunks) and lo < hi:
            start = self.starts[i]
            stop = start + len(self.chunks[i][0])
            if stop > lo:
                out.append((self.chunks[i], lo - start,
                            min(hi, stop) - start))
                lo = min(hi, stop)
            i += 1
        return out


def _gather(pieces, c: int, cap: int, fill, dtype, pick):
    """Column ``c`` over ``pieces`` into a fresh ``dtype`` array of
    ``cap`` slots (``fill`` past the rows); ``pick`` selects the array
    of a chunk column."""
    out = np.full(cap, fill, dtype=dtype)
    at = 0
    for chunk, a, b in pieces:
        out[at:at + b - a] = pick(chunk[c])[a:b]
        at += b - a
    return out


def _host_column(pieces, c: int, typ: T.SqlType, cap: int):
    """(nulls, data) of column ``c`` over ``pieces`` in page
    representation: ``cap`` slots, NULL past the rows; a long decimal's
    data is its (hi, lo) pair."""
    nulls = _gather(pieces, c, cap, True, bool, lambda col: col.nulls)
    if _is_long_decimal(typ):
        return nulls, tuple(
            _gather(pieces, c, cap, 0, np.int64, lambda col, k=k: col.data[k])
            for k in range(2))
    dtype = np.int32 if typ.is_dictionary_encoded else typ.numpy_dtype
    return nulls, _gather(pieces, c, cap, 0, dtype, lambda col: col.data)


class StreamConnector(Connector):
    """See the module docstring. ``append_only`` marks the connector for
    the cache plane (the runner's write path advances instead of
    discarding) and the tailing-cursor statement path."""

    name = "stream"
    append_only = True

    # lock discipline: the table map is shared between appender
    # threads, scan readers and tail pollers
    _shared_attrs = ("_tables",)

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._tables: Dict[str, _StreamTable] = {}
        # one condition for the whole connector: appends notify every
        # tailing long-poller (per-table conditions would make the lock
        # registry grow per CREATE, for no contention win at this
        # fan-in)
        self._cv = make_condition(
            "connectors.stream.StreamConnector._cv")
        register_owner(self, lock_attrs=("_cv",))

    # ------------------------------------------------------------ write
    def _new_table(self, name, column_names, column_types) -> _StreamTable:
        return _StreamTable(TableSchema(name, tuple(
            ColumnSchema(n, t) for n, t in zip(column_names, column_types))))

    def _publish(self, name: str, t: _StreamTable, chunk, pend,
                 replace: bool) -> None:
        with self._cv:
            if name in self._tables and not replace:
                raise ValueError(f"stream already exists: {name}")
            t.extend(chunk, pend)
            self._tables[name] = t
            self._cv.notify_all()

    def create_table(self, name: str, column_names: Sequence[str],
                     column_types: Sequence[T.SqlType], rows: List[tuple],
                     *, replace: bool = False) -> int:
        """CTAS from rows: a new log seeded with ``rows`` at offset
        len(rows). ``replace`` restarts the log — offsets restart too,
        so a replace is a DDL event, not an append (the runner's write
        path invalidates pinned readers of the old log, as for DROP)."""
        t = self._new_table(name, column_names, column_types)
        chunk, pend = t.encode_rows(list(rows))
        self._publish(name, t, chunk, pend, replace)
        return len(rows)

    def create_table_pages(self, name: str, column_names: Sequence[str],
                           column_types: Sequence[T.SqlType],
                           pages: List[Page], *, replace: bool = False,
                           unique: Sequence[str] = ()) -> int:
        """create_table from result pages (the port's runner): their
        selected rows in page order. A log declares no unique columns
        (appends may repeat any key), so ``unique`` is dropped."""
        t = self._new_table(name, column_names, column_types)
        chunk, pend = t.encode_pages(pages)
        self._publish(name, t, chunk, pend, replace)
        return t.offset

    def insert(self, name: str, rows: List[tuple]) -> int:
        """INSERT INTO == append (the reference runner's write path)."""
        self.append(name, rows)
        return len(rows)

    def insert_pages(self, name: str, pages: List[Page]) -> int:
        """INSERT INTO from result pages == append (the port's runner)."""
        before, after = self._append(name, lambda t: t.encode_pages(pages))
        return after - before

    def append(self, table: str, rows: Sequence[tuple]) -> int:
        """THE log write: extend the columns, advance the offset, wake
        every tailing long-poller. Returns the new offset."""
        rows = list(rows)
        return self._append(table, lambda t: t.encode_rows(rows))[1]

    def _append(self, table: str, encode):
        """Encode and publish one batch under the condition: appends
        serialize, so first-seen codes follow the publication order."""
        with self._cv:
            t = self._tables.get(table)
            if t is None:
                raise KeyError(f"no stream {table!r}")
            chunk, pend = encode(t)
            before = t.offset
            t.extend(chunk, pend)
            self._cv.notify_all()
            return before, t.offset

    def drop_table(self, name: str) -> None:
        with self._cv:
            if name not in self._tables:
                raise KeyError(f"no stream {name!r}")
            del self._tables[name]
            self._cv.notify_all()

    # ------------------------------------------------------------- read
    def tables(self) -> List[str]:
        with self._cv:
            return sorted(self._tables)

    def table_schema(self, table: str) -> TableSchema:
        t = self._tables.get(table)
        if t is None:
            raise KeyError(f"no stream {table!r}")
        return t.schema

    def row_count(self, table: str) -> int:
        return self.offset(table)

    def offset(self, table: str) -> int:
        """The log's current offset (== rows appended): THE monotone
        value snapshot_version, delta scans, IVM watermarks and tail
        cursors all key on."""
        with self._cv:
            t = self._tables.get(table)
            return t.offset if t is not None else 0

    def appends_seen(self, table: str) -> int:
        with self._cv:
            t = self._tables.get(table)
            return t.appends if t is not None else 0

    def snapshot_version(self, table: str) -> Optional[str]:
        """``off:<offset>`` — monotone by construction. A write moves it
        forward, never sideways, which is what lets the cache plane
        ADVANCE entries over this connector instead of discarding them
        (cache/store.advance_tables)."""
        with self._cv:
            t = self._tables.get(table)
            return None if t is None else f"off:{t.offset}"

    def pinned_offset(self, table: str) -> Optional[int]:
        """None: a bare scan reads the LIVE log head (its cache entries
        key to the moving offset token and are reclaimed on append).
        StreamWindowConnector overrides it with its pinned upper bound
        — the cache/rules.stream_watermark probe."""
        return None

    def wait_for_offset(self, table: str, min_offset: int,
                        timeout_s: float) -> int:
        """Long-poll until the log advances PAST ``min_offset`` or the
        timeout lapses; returns the current offset either way. The
        tailing-cursor poll primitive — the wait releases the
        connector's lock, so appenders are never blocked by pollers."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        with self._cv:
            while True:
                t = self._tables.get(table)
                cur = t.offset if t is not None else 0
                if cur > min_offset:
                    return cur
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return cur
                self._cv.wait(remaining)

    # ------------------------------------------------------ page plane
    def _snapshot(self, table: str, lo: int, hi: int,
                  columns: Optional[Sequence[str]]):
        """(names, types, dictionaries, chunk pieces) for rows [lo, hi),
        taken under the condition so an append can never tear a read
        (the chunks themselves are immutable once published)."""
        with self._cv:
            t = self._tables.get(table)
            if t is None:
                raise KeyError(f"no stream {table!r}")
            names = (tuple(columns) if columns is not None
                     else tuple(t.schema.column_names()))
            idx = [t.schema.column_index(nm) for nm in names]
            types = [t.schema.columns[i].type for i in idx]
            dicts = [t.codes[nm].dictionary(len(t.codes[nm].values))
                     if nm in t.codes else None for nm in names]
            return idx, types, dicts, t.pieces(lo, hi)

    def page_for_split(self, split: Split,
                       columns: Optional[Sequence[str]] = None) -> Page:
        """Rows [start, start + n) as a page of capacity n rounded up to
        8, one copy to the device per array (the reference's
        ``Page.from_arrays`` over the same rows)."""
        lo, n = split.start_row, split.row_count
        idx, types, dicts, pieces = self._snapshot(
            split.table, lo, lo + n, columns)
        cap = _round_up(n)
        dev = self.device

        def staged(arr: np.ndarray):
            return XF.to_device(arr, dev, label="page-build")

        blocks = []
        for c, typ, dic in zip(idx, types, dicts):
            nulls, data = _host_column(pieces, c, typ, cap)
            blocks.append(Block(
                data=(tuple(staged(d) for d in data)
                      if isinstance(data, tuple) else staged(data)),
                type=typ, nulls=staged(nulls) if nulls[:n].any() else None,
                dictionary=dic))
        valid = np.zeros(cap, dtype=bool)
        valid[:n] = True
        return Page(blocks=tuple(blocks), valid=staged(valid))

    def scan_from(self, table: str, offset: int,
                  columns: Optional[Sequence[str]] = None,
                  target_rows: int = 1 << 20):
        """Delta pages: only the rows appended since ``offset``, up to
        the offset observed at call time (appends racing the scan show
        up in the NEXT delta). The incremental-refresh input plane."""
        hi = self.offset(table)
        start = min(max(int(offset), 0), hi)
        while start < hi:
            n = min(target_rows, hi - start)
            yield self.page_for_split(Split(table, start, n), columns)
            start += n

    def host_rows(self, table: str, target_rows: int = 1 << 20):
        """Row tuples for the sqlite oracle (tests/oracle.py)."""
        hi = self.offset(table)
        idx, types, dicts, pieces = self._snapshot(table, 0, hi, None)
        if not hi:
            return []
        cols = []
        for c, typ, dic in zip(idx, types, dicts):
            nulls, data = _host_column(pieces, c, typ, hi)
            blk = Block(data=data, type=typ,
                        nulls=nulls if nulls.any() else None,
                        dictionary=dic)
            cols.append(_decode_block(blk, np.arange(hi)))
        return list(zip(*cols))


class StreamWindowConnector:
    """A PINNED ``[lo, hi)`` row window of one stream table, presented
    AS the table: splits, pages and row_count cover exactly the window,
    and the snapshot token carries the pinned range instead of the live
    offset — two readers pinned at the same range share cache entries
    however far the log has advanced. ``set_range`` moves the window,
    so one wrapper (and the one executor whose catalogs hold it) serves
    every refresh of a view: delta refreshes pin [watermark, head),
    full recomputes [0, head).

    Other tables delegate to the inner connector. The executor's fusion
    gate sees this class's own ``pages`` (not ``Connector.pages``), and
    the generator hooks it forwards (``gen_body``, ``gen_at``) are the
    stream connector's, which return None: a windowed scan stays a
    host-staged page stream and never fuses."""

    append_only = True

    def __init__(self, inner, table: str, lo: int = 0,
                 hi: Optional[int] = None):
        self._inner = inner
        self._table = table
        self._lo = int(lo)
        self._hi = int(hi if hi is not None
                       else inner.offset(table) if table in inner.tables()
                       else 0)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def set_range(self, lo: int, hi: int) -> None:
        self._lo, self._hi = int(lo), int(hi)

    def snapshot_version(self, table: str) -> Optional[str]:
        if table != self._table:
            return self._inner.snapshot_version(table)
        # the PINNED token: stable while the log advances — monotone
        # offsets make "the prefix I asked for" a permanent identity
        return f"off:{self._hi}@{self._lo}"

    def pinned_offset(self, table: str) -> Optional[int]:
        if table != self._table:
            inner = getattr(self._inner, "pinned_offset", None)
            return inner(table) if inner is not None else None
        return self._hi

    def row_count(self, table: str) -> int:
        if table != self._table:
            return self._inner.row_count(table)
        return max(self._hi - self._lo, 0)

    def offset(self, table: str) -> int:
        if table != self._table:
            return self._inner.offset(table)
        return self._hi

    def splits(self, table: str, target_rows: int) -> List[Split]:
        if table != self._table:
            return self._inner.splits(table, target_rows)
        # the base chopper over THIS wrapper's windowed row_count
        # (page_for_split shifts the ranges into the pinned window)
        return Connector.splits(self, table, target_rows)

    def page_for_split(self, split: Split,
                       columns: Optional[Sequence[str]] = None) -> Page:
        if split.table != self._table:
            return self._inner.page_for_split(split, columns)
        return self._inner.page_for_split(
            Split(split.table, split.start_row + self._lo,
                  split.row_count), columns)

    def prune_splits(self, table, splits, constraint):
        if table != self._table:
            return self._inner.prune_splits(table, splits, constraint)
        return splits  # advisory; the residual Filter re-applies

    def pages(self, table: str, columns: Optional[Sequence[str]] = None,
              target_rows: int = 1 << 20, constraint=None):
        # re-implemented, not delegated: the inner pages() would use the
        # inner splits() and bypass the window
        splits = self.splits(table, target_rows)
        if constraint:
            splits = self.prune_splits(table, splits, constraint)
        for split in splits:
            if split.row_count:
                yield self.page_for_split(split, columns)

    def host_rows(self, table: str, target_rows: int = 1 << 20):
        if table != self._table:
            return self._inner.host_rows(table, target_rows)
        return self._inner.host_rows(table, target_rows)[self._lo:self._hi]
