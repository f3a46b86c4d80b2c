"""System catalog: live engine state queryable as SQL tables.

Port of presto_tpu/connectors/system.py. Reference: presto-main's
SystemConnector (system.runtime.queries, system.runtime.nodes), the
information_schema metadata tables, and the presto-jmx connector's "SQL
over the engine's own metrics". Tables materialize from registered
provider callables at split planning, so every query sees current
state; pages stage host->device like the memory connector's.

Built-in tables (providers wired by LocalRunner / PrestoTpuServer):
  catalogs            catalog_name, connector_name
  tables              table_catalog, table_name
  columns             table_catalog, table_name, column_name,
                      data_type, ordinal_position
  session_properties  name, value, default_value, type, description
  functions           function_name
  runtime_queries     query_id, state, user, query, elapsed_ms,
                      result_rows        (server only)
  runtime_tasks       query_id, stage_id, task_id, state, uri, wall_ms,
                      rows, retries      (server only)
  nodes               uri, state, is_coordinator (server only)
  metrics             name, value        (server counters)

A system table has no snapshot version, so no scan of it ever enters
the result cache (cache/rules.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from presto_tpu_torch import resolve_device
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.base import (
    ColumnSchema,
    Connector,
    Split,
    TableSchema,
)
from presto_tpu_torch.page import Dictionary, Page


@dataclasses.dataclass(frozen=True)
class _SystemSplit(Split):
    """A split carrying the row snapshot taken at planning time, so every
    scan of one query sees one consistent row set of a live table
    whichever thread runs it (reference: SystemTable cursors materialize
    per query, not per page)."""

    rows: tuple = ()


class SystemConnector(Connector):
    """``device=None`` stages pages onto the card; the tests pass
    ``device="cpu"``."""

    name = "system"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._schemas: Dict[str, TableSchema] = {}
        self._providers: Dict[str, Callable[[], List[tuple]]] = {}

    def snapshot_version(self, table: str) -> None:
        """Live provider tables have no staleness token: their content
        changes with no change of cardinality (a query's state column),
        so system scans never result-cache."""
        return None

    def register(self, table: str, columns: Sequence,
                 provider: Callable[[], List[tuple]]) -> None:
        """columns: (name, SqlType) pairs; provider returns the current
        rows (reference: SystemTable.cursor building rows per query)."""
        self._schemas[table] = TableSchema(
            table, tuple(ColumnSchema(n, t) for n, t in columns))
        self._providers[table] = provider

    # ---------------------------------------------------------- metadata
    def tables(self) -> List[str]:
        return list(self._schemas)

    def table_schema(self, table: str) -> TableSchema:
        try:
            return self._schemas[table]
        except KeyError:
            raise KeyError(f"system has no table {table!r}")

    def row_count(self, table: str) -> int:
        return max(len(self._providers[table]()), 1)

    def splits(self, table: str, target_rows: int) -> List[Split]:
        """Snapshot the provider ONCE at split planning; the snapshot
        rides on the splits, so all page scans of this query agree."""
        rows = tuple(self._providers[table]())
        total = max(len(rows), 1)
        out: List[Split] = []
        start = 0
        while start < total:
            n = min(target_rows, total - start)
            out.append(_SystemSplit(table, start, n, rows=rows))
            start += n
        return out

    # -------------------------------------------------------------- scan
    def page_for_split(self, split: Split,
                       columns: Optional[Sequence[str]] = None) -> Page:
        schema = self._schemas[split.table]
        if isinstance(split, _SystemSplit):
            rows = split.rows
        else:  # direct page_for_split callers (tests, tools)
            rows = self._providers[split.table]()
        names = (tuple(columns) if columns is not None
                 else tuple(schema.column_names()))
        lo, hi = split.start_row, split.start_row + split.row_count
        rows = rows[lo:hi]
        cols, types, dicts = [], [], []
        for nm in names:
            idx = schema.column_index(nm)
            col = [r[idx] for r in rows]
            t = schema.columns[idx].type
            cols.append(col)
            types.append(t)
            dicts.append(Dictionary(sorted({v for v in col if v is not None}))
                         if t.is_dictionary_encoded else None)
        # the one split of an empty table is a page of no rows
        return Page.from_arrays(cols, types, dictionaries=dicts,
                                capacity=None if rows else 8,
                                device=self.device)


def install_standard_tables(sys_conn: SystemConnector, runner) -> None:
    """The metadata tables every engine entry point gets (reference:
    information_schema + the SHOW commands' backing tables)."""
    V, B = T.VARCHAR, T.BIGINT

    def catalogs():
        return sorted((name, type(conn).__name__)
                      for name, conn in runner.catalogs.items())

    def _visible(cat: str, table: str) -> bool:
        """Listings hide the tables the user cannot select (reference:
        AccessControl.filterTables/filterColumns over
        information_schema)."""
        from presto_tpu_torch.runner import current_session
        from presto_tpu_torch.security import AccessDeniedError

        session = current_session()
        user = session.user if session else runner.session.user
        try:
            runner.access_control.check_can_select(user, cat, table, ())
        except AccessDeniedError:
            return False
        return True

    def tables():
        out = []
        for cat, conn in sorted(runner.catalogs.items()):
            try:
                for t in conn.tables():
                    if _visible(cat, t):
                        out.append((cat, t))
            except Exception:  # noqa: BLE001 - catalog listings omit
                continue      # broken connectors instead of failing
        return out

    def columns():
        out = []
        for cat, conn in sorted(runner.catalogs.items()):
            try:
                names = conn.tables()
            except Exception:  # noqa: BLE001 - catalog listings omit
                continue      # broken connectors instead of failing
            for t in names:
                if not _visible(cat, t):
                    continue
                schema = conn.table_schema(t)
                for i, c in enumerate(schema.columns):
                    out.append((cat, t, c.name, str(c.type), i + 1))
        return out

    def session_properties():
        # the QUERYING runner's session, not the bootstrap runner's: the
        # server's concurrent path builds a runner per query but shares
        # this connector
        from presto_tpu_torch.runner import current_session

        session = current_session() or runner.session
        return session.rows()

    def functions():
        from presto_tpu_torch.expr import functions as F

        return sorted((n,) for n in F.registered_names())

    sys_conn.register(
        "catalogs", [("catalog_name", V), ("connector_name", V)], catalogs)
    sys_conn.register(
        "tables", [("table_catalog", V), ("table_name", V)], tables)
    sys_conn.register(
        "columns",
        [("table_catalog", V), ("table_name", V), ("column_name", V),
         ("data_type", V), ("ordinal_position", B)],
        columns)
    sys_conn.register(
        "session_properties",
        [("name", V), ("value", V), ("default_value", V), ("type", V),
         ("description", V)],
        session_properties)
    sys_conn.register("functions", [("function_name", V)], functions)
