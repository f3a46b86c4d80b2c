"""A connector wrapper that misstates its tables' row counts.

Port of the reference's test corpus wrapper (tests/test_adaptive.py
``Misestimate``): the planner's static estimates read the claimed
counts while every scan reads the real rows, so a plan built from the
claims is the misestimated plan that adaptive re-planning corrects at
runtime (adaptive/). The data stays honest: an oracle loads the real
rows.
"""

from __future__ import annotations

from typing import Dict


class Misestimate:
    """Wraps ``inner``; ``row_count`` answers ``claims[table]`` where a
    claim exists, everything else is the inner connector's."""

    def __init__(self, inner, claims: Dict[str, int]):
        self._inner = inner
        self._claims = dict(claims)

    def row_count(self, table: str) -> int:
        if table in self._claims:
            return self._claims[table]
        return self._inner.row_count(table)

    def __getattr__(self, name):
        return getattr(self._inner, name)
