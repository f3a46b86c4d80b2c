"""Blackhole connector: accepts any write and discards it; reads return
empty tables.

Port of presto_tpu/connectors/blackhole.py. Reference: presto-blackhole
(BlackHoleConnector) — the null sink/source used by perf tests and as a
fixture double. It holds no data, so it has no device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from presto_tpu_torch.connectors.base import (
    ColumnSchema,
    Connector,
    Split,
    TableSchema,
)
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.page import Page


class BlackholeConnector(Connector):
    name = "blackhole"

    def __init__(self):
        self._schemas: Dict[str, TableSchema] = {}

    def create_table(self, name, column_names, column_types, rows,
                     *, replace: bool = False) -> int:
        self._schemas[name] = TableSchema(name, tuple(
            ColumnSchema(n, t) for n, t in zip(column_names, column_types)))
        return len(rows)  # acknowledged, discarded

    def create_table_pages(self, name, column_names, column_types,
                           pages: List[Page], *, replace: bool = False,
                           unique=()) -> int:
        """CREATE TABLE AS: the schema is kept, the rows acknowledged
        (counted off each page's validity mask) and discarded."""
        self.create_table(name, column_names, column_types, [])
        return self._count(pages)

    def insert(self, name, rows) -> int:
        return len(rows)

    def insert_pages(self, name, pages: List[Page]) -> int:
        return self._count(pages)

    @staticmethod
    def _count(pages: List[Page]) -> int:
        return sum(int(XF.np_host(p.valid, label="table-write").sum())
                   for p in pages)

    def drop_table(self, name) -> None:
        self._schemas.pop(name, None)

    def tables(self) -> List[str]:
        return sorted(self._schemas)

    def table_schema(self, table: str) -> TableSchema:
        if table not in self._schemas:
            raise KeyError(f"no table {table!r}")
        return self._schemas[table]

    def row_count(self, table: str) -> int:
        return 0

    def page_for_split(
        self, split: Split, columns: Optional[Sequence[str]] = None
    ) -> Page:  # pragma: no cover - a 0-row split is never read
        raise AssertionError("blackhole tables have no rows")
