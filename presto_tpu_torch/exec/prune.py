"""Column pruning over physical plans.

Reference: presto-main sql/planner/optimizations/PruneUnreferencedOutputs
(plus the Prune*Columns iterative rules). Walks the plan top-down with the
set of channels the parent needs, narrows every node to just those, and
remaps channel references. The big win is at TableScan: unreferenced
columns are never generated/read at all (the TPC-H connector prunes
generation per column, so this feeds straight through to device work).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.expr import ir


def _expr_refs(e: ir.RowExpression, out: Set[int]):
    if isinstance(e, ir.InputRef):
        out.add(e.channel)
    for c in e.children():
        _expr_refs(c, out)


def _remap(e: ir.RowExpression, m: Dict[int, int]) -> ir.RowExpression:
    if isinstance(e, ir.InputRef):
        return ir.InputRef(m[e.channel], e.type)
    if isinstance(e, ir.Call):
        return ir.Call(e.name, tuple(_remap(a, m) for a in e.args), e.type)
    if isinstance(e, ir.SpecialForm):
        return ir.SpecialForm(
            e.form, tuple(_remap(a, m) for a in e.args), e.type
        )
    return e


def expr_channels(e: ir.RowExpression) -> Set[int]:
    """Input channels an expression reads — the per-consumer column
    LIVENESS set. presto_tpu's late materialization (exec/executor.py
    ``_lazy_filter`` / ``_join_pass``) uses it to lift exactly the
    deferred channels a filter predicate or downstream join key
    actually needs as VALUES, leaving everything else as a row-id
    indirection until the chain boundary (exec/latemat.py)."""
    out: Set[int] = set()
    _expr_refs(e, out)
    return out


def remap_expr(e: ir.RowExpression, m: Dict[int, int]) -> ir.RowExpression:
    """Rewrite an expression's InputRefs through a logical->physical
    channel mapping (the lazy reduced-page layout, or any pruned
    layout). Shared by _prune above and the lazy filter."""
    return _remap(e, m)


def _channel_count(node: P.PhysicalNode, counts: Dict) -> int:
    """Output channel count without connector metadata."""
    if node in counts:
        return counts[node]
    if isinstance(node, P.TableScan):
        n = len(node.columns)
    elif isinstance(node, P.Values):
        n = len(node.types)
    elif isinstance(node, P.Project):
        n = len(node.exprs)
    elif isinstance(node, P.Aggregation):
        n = len(node.group_channels) + len(node.aggregates)
    elif isinstance(node, P.HashJoin):
        if node.join_type in ("semi", "anti"):
            n = _channel_count(node.left, counts) + 1
        else:
            n = _channel_count(node.left, counts) + _channel_count(
                node.right, counts)
    elif isinstance(node, P.CrossJoin):
        n = _channel_count(node.left, counts) + _channel_count(
            node.right, counts)
    elif isinstance(node, (P.UniqueId, P.GroupId)):
        n = _channel_count(node.source, counts) + 1
    elif isinstance(node, P.Unnest):
        n = _channel_count(node.source, counts) + 1 + int(
            node.with_ordinality)
    elif isinstance(node, P.Union):
        n = _channel_count(node.sources[0], counts)
    elif isinstance(node, P.Window):
        n = _channel_count(node.source, counts) + len(node.functions)
    elif isinstance(node, P.MarkDistinct):
        n = _channel_count(node.source, counts) + len(
            node.mark_channel_sets)
    elif isinstance(node, (P.Filter, P.Sort, P.TopN, P.Limit, P.Output)):
        n = _channel_count(node.children()[0], counts)
    else:
        raise TypeError(f"unknown node: {node!r}")
    counts[node] = n
    return n


def output_types(node: P.PhysicalNode, catalogs: Dict) -> List[T.SqlType]:
    """Channel types without an Executor (needed for type-correct
    alignment projections during pruning)."""
    if isinstance(node, P.TableScan):
        schema = catalogs[node.catalog].table_schema(node.table)
        return [schema.column_type(c) for c in node.columns]
    if isinstance(node, P.Values):
        return list(node.types)
    if isinstance(node, P.Project):
        return [e.type for e in node.exprs]
    if isinstance(node, P.Aggregation):
        from presto_tpu_torch.exec import agg_states as AS

        src = output_types(node.source, catalogs)
        out = [src[c] for c in node.group_channels]
        for spec in node.aggregates:
            in_t = None if spec.channel is None else src[spec.channel]
            out.append(AS.result_type(spec.function, in_t))
        return out
    if isinstance(node, P.HashJoin):
        left = output_types(node.left, catalogs)
        if node.join_type in ("semi", "anti"):
            return left + [T.BOOLEAN]
        return left + output_types(node.right, catalogs)
    if isinstance(node, P.CrossJoin):
        return output_types(node.left, catalogs) + output_types(
            node.right, catalogs)
    if isinstance(node, (P.UniqueId, P.GroupId)):
        return output_types(node.source, catalogs) + [T.BIGINT]
    if isinstance(node, P.Unnest):
        out = output_types(node.source, catalogs) + [node.element_type]
        if node.with_ordinality:
            out.append(T.BIGINT)
        return out
    if isinstance(node, P.Union):
        return output_types(node.sources[0], catalogs)
    if isinstance(node, P.Window):
        from presto_tpu_torch.ops import window as W

        src = output_types(node.source, catalogs)
        out = list(src)
        for fn in node.functions:
            in_t = None if fn.arg_channel is None else src[fn.arg_channel]
            out.append(W.result_type(fn, in_t))
        return out
    if isinstance(node, P.MarkDistinct):
        return output_types(node.source, catalogs) + [
            T.BOOLEAN for _ in node.mark_channel_sets
        ]
    if isinstance(node, (P.Filter, P.Sort, P.TopN, P.Limit, P.Output)):
        return output_types(node.children()[0], catalogs)
    raise TypeError(f"unknown node: {node!r}")


def prune_plan(node: P.Output, catalogs: Dict) -> P.Output:
    counts: Dict = {}
    ctx = {"counts": counts, "catalogs": catalogs}
    nch = _channel_count(node.source, counts)
    source, mapping = _prune(node.source, set(range(nch)), ctx)
    # Output needs every channel in original order
    assert all(c in mapping for c in range(nch))
    if any(mapping[c] != c for c in range(nch)):
        # restore order via projection (cannot happen today — kept as a
        # safety net for future node kinds)
        raise AssertionError("output channel order changed by pruning")
    return P.Output(source, node.names)


def _prune(node: P.PhysicalNode, needed: Set[int], ctx: Dict):
    """Returns (new_node, mapping old_channel -> new_channel) covering at
    least `needed`."""
    counts = ctx["counts"]
    if isinstance(node, P.TableScan):
        keep = sorted(needed or {0})  # a Page needs >= 1 column
        cols = tuple(node.columns[c] for c in keep)
        return (
            P.TableScan(node.catalog, node.table, cols),
            {c: i for i, c in enumerate(keep)},
        )
    if isinstance(node, P.Values):
        keep = sorted(needed or {0})
        types = tuple(node.types[c] for c in keep)
        rows = tuple(tuple(r[c] for c in keep) for r in node.rows)
        return P.Values(types, rows), {c: i for i, c in enumerate(keep)}
    if isinstance(node, P.Project):
        keep = sorted(needed)
        child_needed: Set[int] = set()
        for c in keep:
            _expr_refs(node.exprs[c], child_needed)
        src, m = _prune(node.source, child_needed, ctx)
        exprs = tuple(_remap(node.exprs[c], m) for c in keep)
        return P.Project(src, exprs), {c: i for i, c in enumerate(keep)}
    if isinstance(node, P.Filter):
        child_needed = set(needed)
        _expr_refs(node.predicate, child_needed)
        src, m = _prune(node.source, child_needed, ctx)
        return P.Filter(src, _remap(node.predicate, m)), m
    if isinstance(node, P.Aggregation):
        nkeys = len(node.group_channels)
        # all group keys stay (they define grouping); agg outputs prune
        keep_aggs = sorted(
            i for i in range(len(node.aggregates))
            if (nkeys + i) in needed
        )
        child_needed = set(node.group_channels)
        for i in keep_aggs:
            ch = node.aggregates[i].channel
            if ch is not None:
                child_needed.add(ch)
            if node.aggregates[i].mask is not None:
                child_needed.add(node.aggregates[i].mask)
            child_needed.update(node.aggregates[i].extra_channels)
        src, m = _prune(node.source, child_needed, ctx)
        groups = tuple(m[c] for c in node.group_channels)
        aggs = tuple(
            P.AggSpec(
                node.aggregates[i].function,
                None if node.aggregates[i].channel is None
                else m[node.aggregates[i].channel],
                None if node.aggregates[i].mask is None
                else m[node.aggregates[i].mask],
                extra_channels=tuple(
                    m[c] for c in node.aggregates[i].extra_channels
                ),
                params=node.aggregates[i].params,
            )
            for i in keep_aggs
        )
        mapping = {c: i for i, c in enumerate(range(nkeys))}
        for out_pos, i in enumerate(keep_aggs):
            mapping[nkeys + i] = nkeys + out_pos
        return (
            P.Aggregation(src, groups, aggs, node.capacity),
            mapping,
        )
    if isinstance(node, P.HashJoin):
        nleft = _channel_count(node.left, counts)
        if node.join_type in ("semi", "anti"):
            left_needed = {c for c in needed if c < nleft}
            left_needed.update(node.left_keys)
            right_needed = set(node.right_keys)
            lsrc, lm = _prune(node.left, left_needed, ctx)
            rsrc, rm = _prune(node.right, right_needed, ctx)
            new_nleft = len(lm)
            join = P.HashJoin(
                lsrc, rsrc,
                tuple(lm[c] for c in node.left_keys),
                tuple(rm[c] for c in node.right_keys),
                node.join_type,
            )
            mapping = dict(lm)
            mapping[nleft] = new_nleft  # match channel
            return join, mapping
        left_needed = {c for c in needed if c < nleft}
        left_needed.update(node.left_keys)
        right_needed = {c - nleft for c in needed if c >= nleft}
        right_needed.update(node.right_keys)
        lsrc, lm = _prune(node.left, left_needed, ctx)
        rsrc, rm = _prune(node.right, right_needed, ctx)
        new_nleft = len(lm)
        join = P.HashJoin(
            lsrc, rsrc,
            tuple(lm[c] for c in node.left_keys),
            tuple(rm[c] for c in node.right_keys),
            node.join_type,
        )
        mapping = dict(lm)
        for c, nc in rm.items():
            mapping[nleft + c] = new_nleft + nc
        return join, mapping
    if isinstance(node, P.CrossJoin):
        nleft = _channel_count(node.left, counts)
        left_needed = {c for c in needed if c < nleft} or {0}
        right_needed = {c - nleft for c in needed if c >= nleft} or {0}
        lsrc, lm = _prune(node.left, left_needed, ctx)
        rsrc, rm = _prune(node.right, right_needed, ctx)
        new_nleft = len(lm)
        mapping = dict(lm)
        for c, nc in rm.items():
            mapping[nleft + c] = new_nleft + nc
        return P.CrossJoin(lsrc, rsrc), mapping
    if isinstance(node, P.UniqueId):
        nsrc = _channel_count(node.source, counts)
        child_needed = {c for c in needed if c < nsrc}
        src, m = _prune(node.source, child_needed, ctx)
        mapping = dict(m)
        mapping[nsrc] = len(m)  # id channel
        return P.UniqueId(src), mapping
    if isinstance(node, P.GroupId):
        nsrc = _channel_count(node.source, counts)
        child_needed = (
            {c for c in needed if c < nsrc} | set(node.key_channels)
        )
        src, m = _prune(node.source, child_needed, ctx)
        mapping = dict(m)
        mapping[nsrc] = len(m)  # gid channel
        return (
            P.GroupId(src, tuple(m[c] for c in node.key_channels),
                      node.set_masks),
            mapping,
        )
    if isinstance(node, P.Unnest):
        nsrc = _channel_count(node.source, counts)
        child_needed = (
            {c for c in needed if c < nsrc} | {node.array_channel}
        )
        src, m = _prune(node.source, child_needed, ctx)
        mapping = dict(m)
        mapping[nsrc] = len(m)  # element channel
        if node.with_ordinality:
            mapping[nsrc + 1] = len(m) + 1
        return (
            P.Unnest(src, m[node.array_channel], node.element_type,
                     node.with_ordinality),
            mapping,
        )
    if isinstance(node, P.Union):
        keep = sorted(needed)
        new_sources = []
        for child in node.sources:
            child_types = output_types(child, ctx["catalogs"])
            src, m = _prune(child, set(keep), ctx)
            # children may retain different extra channels (join/sort keys
            # in their own subtrees) — align every child to exactly `keep`
            if sorted(m) != keep or [m[c] for c in keep] != list(
                    range(len(keep))):
                exprs = tuple(
                    ir.InputRef(m[c], child_types[c]) for c in keep
                )
                src = P.Project(src, exprs)
            new_sources.append(src)
        return (
            P.Union(tuple(new_sources)),
            {c: i for i, c in enumerate(keep)},
        )
    if isinstance(node, (P.Sort, P.TopN)):
        child_needed = set(needed)
        for k in node.keys:
            child_needed.add(k.channel)
        src, m = _prune(node.source, child_needed, ctx)
        from presto_tpu_torch.ops.sort import SortKey

        keys = tuple(
            SortKey(m[k.channel], k.ascending, k.nulls_first)
            for k in node.keys
        )
        if isinstance(node, P.TopN):
            return P.TopN(src, keys, node.limit), m
        return P.Sort(src, keys), m
    if isinstance(node, P.Limit):
        src, m = _prune(node.source, needed, ctx)
        return P.Limit(src, node.count, node.offset), m
    if isinstance(node, P.Window):
        import dataclasses as _dc

        from presto_tpu_torch.ops.sort import SortKey

        nsrc = _channel_count(node.source, counts)
        keep_fns = sorted(
            i for i in range(len(node.functions))
            if (nsrc + i) in needed
        )
        child_needed = {c for c in needed if c < nsrc}
        child_needed.update(node.partition_channels)
        child_needed.update(k.channel for k in node.order_keys)
        for i in keep_fns:
            ch = node.functions[i].arg_channel
            if ch is not None:
                child_needed.add(ch)
        src, m = _prune(node.source, child_needed, ctx)
        fns = tuple(
            _dc.replace(
                node.functions[i],
                arg_channel=(
                    None if node.functions[i].arg_channel is None
                    else m[node.functions[i].arg_channel]
                ),
            )
            for i in keep_fns
        )
        new_node = P.Window(
            src,
            tuple(m[c] for c in node.partition_channels),
            tuple(
                SortKey(m[k.channel], k.ascending, k.nulls_first)
                for k in node.order_keys
            ),
            fns,
        )
        new_nsrc = len(m)
        mapping = dict(m)
        for out_pos, i in enumerate(keep_fns):
            mapping[nsrc + i] = new_nsrc + out_pos
        return new_node, mapping
    if isinstance(node, P.MarkDistinct):
        nsrc = _channel_count(node.source, counts)
        keep_marks = sorted(
            i for i in range(len(node.mark_channel_sets))
            if (nsrc + i) in needed
        )
        child_needed = {c for c in needed if c < nsrc}
        for i in keep_marks:
            child_needed.update(node.mark_channel_sets[i])
        src, m = _prune(node.source, child_needed, ctx)
        new_node = P.MarkDistinct(
            src,
            tuple(
                tuple(m[c] for c in node.mark_channel_sets[i])
                for i in keep_marks
            ),
        )
        new_nsrc = len(m)
        mapping = dict(m)
        for out_pos, i in enumerate(keep_marks):
            mapping[nsrc + i] = new_nsrc + out_pos
        return new_node, mapping
    raise TypeError(f"unknown node: {node!r}")
