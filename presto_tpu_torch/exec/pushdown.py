"""Scan-range predicate pushdown — the TupleDomain analog.

Port of presto_tpu/exec/pushdown.py: a post-plan pass matches
Filter(TableScan), derives closed integer ranges for scan columns from
the predicate's conjuncts, and attaches them to the TableScan as
advisory split-pruning hints. The Filter stays in place (pruning never
changes results); generator connectors invert monotonic columns to row
ranges and drop whole splits (connectors/base.GeneratorConnector.
prune_splits), so a date_dim or inventory scan filtered to a few weeks
reads a split or two.

Reference: presto-spi spi/predicate/TupleDomain and
ConnectorSplitManager.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.expr import ir

_Range = Tuple[Optional[int], Optional[int]]


def _int_domain(t: T.SqlType) -> bool:
    """Types whose engine encoding is a plain integer (bigint/int/date/
    short decimal): range arithmetic on constants is exact for these."""
    if T.is_string(t) or T.is_floating(t):
        return False
    if isinstance(t, T.DecimalType):
        return t.is_short
    try:
        return np.issubdtype(np.dtype(t.numpy_dtype), np.integer)
    except (TypeError, AttributeError, KeyError):  # dict-coded/state types
        return False


def _unit_tag(t: T.SqlType):
    """Encoding unit of an integer-domain type. Pushed constants carry
    the LITERAL'S units while stored stats carry the COLUMN'S (runtime
    comparisons rescale, split pruning cannot), so a range is only
    extractable when both sides use the same unit — e.g. decimal(10,2)
    vs a bare bigint literal is skipped rather than pruned wrongly."""
    if isinstance(t, T.DecimalType):
        return ("dec", t.scale)
    name = type(t).__name__
    if "Date" in name:
        return "date"
    if "Timestamp" in name or "Time" in name:
        return ("time", name)
    return "int"


def _conjuncts(e: ir.RowExpression) -> List[ir.RowExpression]:
    if isinstance(e, ir.SpecialForm) and e.form == ir.AND:
        out: List[ir.RowExpression] = []
        for a in e.args:
            out.extend(_conjuncts(a))
        return out
    return [e]


def _merge(ranges: Dict[int, _Range], ch: int, lo, hi) -> None:
    old_lo, old_hi = ranges.get(ch, (None, None))
    if lo is not None:
        old_lo = lo if old_lo is None else max(old_lo, lo)
    if hi is not None:
        old_hi = hi if old_hi is None else min(old_hi, hi)
    ranges[ch] = (old_lo, old_hi)


def _ref_const(a, b):
    """(InputRef, int Constant) from either argument order; None if the
    pair doesn't match or the domain isn't integral."""
    if isinstance(a, ir.Constant):
        a, b, flipped = b, a, True
    else:
        flipped = False
    if not (isinstance(a, ir.InputRef) and isinstance(b, ir.Constant)):
        return None
    if b.value is None or not isinstance(b.value, int) or isinstance(
        b.value, bool
    ):
        return None
    if not (_int_domain(a.type) and _int_domain(b.type)):
        return None
    if _unit_tag(a.type) != _unit_tag(b.type):
        return None
    return a, b.value, flipped


def extract_ranges(
    predicate: ir.RowExpression, n_channels: int
) -> Dict[int, _Range]:
    """Conjunctive integer ranges per input channel; ignores anything it
    cannot prove (other conjuncts simply contribute no constraint)."""
    ranges: Dict[int, _Range] = {}
    _FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}
    for c in _conjuncts(predicate):
        if isinstance(c, ir.SpecialForm) and c.form == ir.BETWEEN:
            v, lo, hi = c.args
            got = _ref_const(v, lo)
            got2 = _ref_const(v, hi)
            if got and got2 and not got[2] and not got2[2]:
                _merge(ranges, got[0].channel, got[1], got2[1])
            continue
        if isinstance(c, ir.SpecialForm) and c.form == ir.IN:
            vals = []
            ref = c.args[0]
            ok = isinstance(ref, ir.InputRef) and _int_domain(ref.type)
            for cand in c.args[1:]:
                got = _ref_const(ref, cand)
                if not got:
                    ok = False
                    break
                vals.append(got[1])
            if ok and vals:
                _merge(ranges, ref.channel, min(vals), max(vals))
            continue
        if not isinstance(c, ir.Call) or len(c.args) != 2:
            continue
        name = c.name
        if name not in ("eq", "lt", "le", "gt", "ge"):
            continue
        got = _ref_const(c.args[0], c.args[1])
        if got is None:
            continue
        ref, v, flipped = got
        if flipped:
            name = _FLIP[name]
        if name == "eq":
            _merge(ranges, ref.channel, v, v)
        elif name == "le":
            _merge(ranges, ref.channel, None, v)
        elif name == "lt":
            _merge(ranges, ref.channel, None, v - 1)
        elif name == "ge":
            _merge(ranges, ref.channel, v, None)
        elif name == "gt":
            _merge(ranges, ref.channel, v + 1, None)
    return {
        ch: r for ch, r in ranges.items()
        if ch < n_channels and r != (None, None)
    }


def push_scan_constraints(node: P.PhysicalNode) -> P.PhysicalNode:
    """Rewrite Filter(TableScan) so the scan carries the extracted column
    ranges (reference: PickTableLayout/AddExchanges consulting
    TupleDomain during planning)."""
    if isinstance(node, P.Filter) and isinstance(node.source, P.TableScan):
        scan = node.source
        ranges = extract_ranges(node.predicate, len(scan.columns))
        if ranges:
            cons = tuple(
                (scan.columns[ch], lo, hi)
                for ch, (lo, hi) in sorted(ranges.items())
            )
            scan = dataclasses.replace(scan, constraint=cons)
            return P.Filter(scan, node.predicate)
        return node
    kids = node.children()
    if not kids:
        return node
    new_kids = tuple(push_scan_constraints(k) for k in kids)
    if new_kids == kids:
        return node
    updates: Dict[str, object] = {}
    names = [f.name for f in dataclasses.fields(node)]
    if "source" in names and len(new_kids) == 1:
        updates["source"] = new_kids[0]
    elif "left" in names and "right" in names and len(new_kids) == 2:
        updates["left"], updates["right"] = new_kids
    elif "sources" in names:
        updates["sources"] = new_kids
    else:  # pragma: no cover - no known multi-child shapes beyond these
        return node
    return dataclasses.replace(node, **updates)
