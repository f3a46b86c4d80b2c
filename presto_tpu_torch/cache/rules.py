"""Cacheability rules + cache-point selection for the result cache.

Port of presto_tpu/cache/rules.py (host logic over plan trees).
Reference: presto-main's materialized-view/result-set staleness model —
a cached result is servable exactly when (a) the computation is
deterministic and (b) the data it read is provably unchanged. Ours
expresses (a) as a structural walk over the physical plan (no system-
catalog scans, no volatile expressions, no remote sources, no
query-unique row ids) and (b) as the connector-SPI ``snapshot_version``
token folded into every cache key — a write to any scanned table moves
the token, so stale entries become structurally unreachable rather
than needing a coordinated flush (the memory connector bumps an
explicit write counter; read-only generator connectors derive a
row-count token for free).

Key material is built on the same identity-free structural walker the
observed-stats profile store uses (`obs/profile.structural_encode`),
so two processes — or two per-query runners inside one server — key
the same plan identically.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional, Set, Tuple

from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.expr.ir import (
    AND,
    BETWEEN,
    IN,
    Call,
    Constant,
    InputRef,
    RowExpression,
    SpecialForm,
)
from presto_tpu_torch.obs.profile import (
    plan_fingerprint,
    structural_fingerprint,
)

# SQL functions whose value depends on when/where they run, not on
# their inputs — a plan containing one can never be cached. The
# current registry implements none of these; the gate exists so adding
# one later cannot silently poison the cache.
VOLATILE_FUNCTIONS: FrozenSet[str] = frozenset({
    "random", "rand", "shuffle", "uuid",
    "now", "current_timestamp", "current_time", "current_date",
    "localtime", "localtimestamp",
})

# session properties whose value can change a successful query's
# RESULT (not just its speed): they ride in every full-statement cache
# key. array_agg_max_elements bounds collect-state aggregates;
# page_rows moves split boundaries and therefore unordered row order.
RESULT_AFFECTING_PROPS: Tuple[str, ...] = (
    "array_agg_max_elements", "page_rows",
)

# subtree roots worth caching: operators that materialize/recompute
# state (a bare scan replays as cheaply as its cache entry would —
# scan == generate for the generator connectors, and the caching
# CONNECTOR already covers host-page scans)
_WORTH_CACHING = (
    P.Aggregation, P.HashJoin, P.CrossJoin, P.Sort, P.TopN,
    P.Window, P.MarkDistinct, P.GroupId, P.Unnest,
)


def _volatile_call(x) -> Optional[str]:
    """First volatile function name reachable from any RowExpression
    field of a plan node (walked structurally, like the encoder)."""
    if isinstance(x, RowExpression):
        if isinstance(x, Call) and x.name in VOLATILE_FUNCTIONS:
            return x.name
        for c in x.children():
            hit = _volatile_call(c)
            if hit:
                return hit
        return None
    if isinstance(x, (tuple, list)):
        for v in x:
            hit = _volatile_call(v)
            if hit:
                return hit
        return None
    if dataclasses.is_dataclass(x) and not isinstance(x, type) and \
            not isinstance(x, P.PhysicalNode):
        for f in dataclasses.fields(x):
            hit = _volatile_call(getattr(x, f.name))
            if hit:
                return hit
    return None


def scan_tables(node: P.PhysicalNode) -> Set[Tuple[str, str]]:
    """Every (catalog, table) the subtree scans."""
    out: Set[Tuple[str, str]] = set()

    def walk(n):
        if isinstance(n, P.TableScan):
            out.add((n.catalog, n.table))
        for c in n.children():
            walk(c)

    walk(node)
    return out


def uncacheable_reason(node: P.PhysicalNode,
                       catalogs) -> Optional[str]:
    """None when the subtree is deterministic and snapshot-keyable;
    otherwise a short human-readable reason (surfaced by tests and
    tools, never raised)."""
    if isinstance(node, P.RemoteSource):
        return "remote source (pages come from runtime task state)"
    if isinstance(node, P.UniqueId):
        return "query-unique row ids"
    if isinstance(node, P.TableScan):
        if node.catalog == "system":
            return "system-catalog scan (live engine state)"
        conn = catalogs.get(node.catalog)
        if conn is None:
            return f"unknown catalog {node.catalog!r}"
        if snapshot_of(conn, node.table) is None:
            return (f"{node.catalog}.{node.table} has no snapshot "
                    f"version (connector cannot prove staleness)")
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, P.PhysicalNode):
                continue  # children walk below
            hit = _volatile_call(v)
            if hit:
                return f"volatile function {hit}()"
    for c in node.children():
        reason = uncacheable_reason(c, catalogs)
        if reason:
            return reason
    return None


def cacheable(node: P.PhysicalNode, catalogs) -> bool:
    return uncacheable_reason(node, catalogs) is None


def snapshot_of(conn, table: str) -> Optional[str]:
    """The connector's snapshot token for one table, None when the
    connector cannot provide one (-> uncacheable). Tolerates legacy
    connectors without the SPI method."""
    fn = getattr(conn, "snapshot_version", None)
    if fn is None:
        return None
    try:
        v = fn(table)
    except Exception:  # noqa: BLE001 - a failing snapshot probe means
        return None    # "cannot prove staleness", never a query error
    return None if v is None else str(v)


def stream_watermark(tables, catalogs) -> Optional[int]:
    """Offset watermark for a cache entry whose scans include append-
    only stream tables (connectors/stream.py): the max PINNED offset
    when every stream scan is offset-pinned (a StreamWindowConnector
    reader), None otherwise — None for non-stream entries AND for
    live-head stream scans, whose keys embed the MOVING offset token
    and are reclaimed by the store's append-path advance
    (store.advance_tables). A watermark on the entry is what lets a
    reader pinned at offset N keep hitting its prefix entry while the
    log grows past N — the monotone-offset-token fix: the token
    identifies the prefix, the append only extends the suffix."""
    marks = []
    for catalog, table in tables:
        conn = catalogs.get(catalog)
        if conn is None or not getattr(conn, "append_only", False):
            continue
        pin = getattr(conn, "pinned_offset", None)
        off = pin(table) if pin is not None else None
        if off is None:
            return None  # live-head scan: offset-keyed, reclaimable
        marks.append(int(off))
    return max(marks) if marks else None


def append_only_tables(tables, catalogs) -> FrozenSet[Tuple[str, str]]:
    """The subset of (catalog, table) pairs whose connector is an
    append-only stream — the tables whose writes ADVANCE cache
    entries (store.advance_tables) instead of discarding them."""
    return frozenset(
        (c, t) for c, t in tables
        if getattr(catalogs.get(c), "append_only", False)
    )


def snapshot_tokens(tables, catalogs) -> Optional[Tuple]:
    """Sorted ((catalog, table, version), ...) for a table set; None
    when any table has no snapshot (the whole key is then unbuildable
    and the caller skips caching)."""
    out = []
    for catalog, table in sorted(tables):
        conn = catalogs.get(catalog)
        v = snapshot_of(conn, table) if conn is not None else None
        if v is None:
            return None
        out.append((catalog, table, v))
    return tuple(out)


def subtree_key(node: P.PhysicalNode, catalogs):
    """(cache key, scanned tables) for one cacheable subtree, or None.
    The key folds the canonical plan fingerprint (which already embeds
    per-scan row-count tokens) with every scanned table's
    snapshot_version — a write to any input moves the key, so a stale
    entry can never be addressed again."""
    tables = frozenset(scan_tables(node))
    snap = snapshot_tokens(tables, catalogs)
    if snap is None:
        return None
    fp = plan_fingerprint(node, catalogs)
    return (f"frag:{fp}:{structural_fingerprint(snap)}", tables)


def _worth_caching(node: P.PhysicalNode) -> bool:
    if isinstance(node, _WORTH_CACHING):
        return True
    return any(_worth_caching(c) for c in node.children())


# ---------------------------------------------------------------------
# Overlapping subsumption: containment over single-column
# range/IN predicates. A cached `WHERE d < 10` fragment answers
# `WHERE d < 5` by replaying its pages through the narrower predicate
# (the residual re-filter) — the materialized-view-rewrite direction's
# row-expression domain machinery, restricted to the shapes the
# containment test can PROVE: one column, closed-form range or IN list,
# over the same scan + projection chain. Anything else stays
# exact-match.

_CMP_OPS = frozenset({"lt", "le", "gt", "ge", "eq"})


def _scalar_const(x) -> Optional[tuple]:
    """("v", value) for an orderable literal, None otherwise. Bools
    are excluded (True < 10 is well-defined in Python but nonsense as
    a range bound); the wrapper keeps a literal None distinguishable
    from "not a constant"."""
    if isinstance(x, Constant) and not isinstance(x.value, bool) \
            and isinstance(x.value, (int, float, str)):
        return ("v", x.value)
    return None


def _range_desc(channel: int, lo=None, hi=None, lo_strict=False,
                hi_strict=False) -> Dict:
    return {"channel": channel, "lo": lo, "hi": hi,
            "lo_strict": lo_strict, "hi_strict": hi_strict}


def _merge_ranges(a: Dict, b: Dict) -> Optional[Dict]:
    """Conjunction of two range descriptors on the SAME channel —
    the tighter bound on each side wins."""
    if a["channel"] != b["channel"]:
        return None
    if "in" in a or "in" in b:
        return None  # AND over IN lists stays exact-match
    out = dict(a)
    try:
        for side, strict, keep in (("lo", "lo_strict", max),
                                   ("hi", "hi_strict", min)):
            av, bv = a[side], b[side]
            if bv is None:
                continue
            if av is None or \
                    (keep(av[1], bv[1]) == bv[1] and av != bv):
                out[side], out[strict] = bv, b[strict]
            elif av[1] == bv[1]:
                out[strict] = a[strict] or b[strict]
    except TypeError:
        return None  # incomparable literal types (d < 1 AND d < 'x')
    return out


def filter_descriptor(pred: RowExpression) -> Optional[Dict]:
    """Canonical containment descriptor for a predicate, or None when
    it is not a single-column range/IN shape. Ranges carry optional
    ("v", value) bounds with strictness; IN lists carry the literal
    set. Comparable literal types only (int/float/str)."""
    if isinstance(pred, Call) and pred.name in _CMP_OPS \
            and len(pred.args) == 2:
        a, b = pred.args
        op = pred.name
        if isinstance(b, InputRef) and isinstance(a, Constant):
            # 10 > d  ==  d < 10: flip operand order
            a, b = b, a
            op = {"lt": "gt", "le": "ge", "gt": "lt",
                  "ge": "le", "eq": "eq"}[op]
        if not isinstance(a, InputRef):
            return None
        v = _scalar_const(b)
        if v is None:
            return None
        c = a.channel
        if op == "lt":
            return _range_desc(c, hi=v, hi_strict=True)
        if op == "le":
            return _range_desc(c, hi=v)
        if op == "gt":
            return _range_desc(c, lo=v, lo_strict=True)
        if op == "ge":
            return _range_desc(c, lo=v)
        return _range_desc(c, lo=v, hi=v)  # eq
    if isinstance(pred, SpecialForm):
        if pred.form == AND:
            descs = [filter_descriptor(a) for a in pred.args]
            if any(d is None for d in descs):
                return None
            out = descs[0]
            for d in descs[1:]:
                out = _merge_ranges(out, d)
                if out is None:
                    return None
            return out
        if pred.form == BETWEEN and len(pred.args) == 3:
            v, lo, hi = pred.args
            lov, hiv = _scalar_const(lo), _scalar_const(hi)
            if isinstance(v, InputRef) and lov is not None \
                    and hiv is not None:
                return _range_desc(v.channel, lo=lov, hi=hiv)
            return None
        if pred.form == IN and len(pred.args) >= 2:
            v, cands = pred.args[0], pred.args[1:]
            vals = [_scalar_const(c) for c in cands]
            if isinstance(v, InputRef) and all(x is not None
                                               for x in vals):
                return {"channel": v.channel,
                        "in": sorted({x[1] for x in vals}, key=repr)}
            return None
    return None


def _bound_covers_lo(cached: Dict, wanted: Dict) -> bool:
    cl = cached["lo"]
    if cl is None:
        return True
    wl = wanted["lo"]
    if wl is None:
        return False
    try:
        if cl[1] < wl[1]:
            return True
        if cl[1] > wl[1]:
            return False
    except TypeError:
        return False  # incomparable literal types
    # equal bound: a strict cached bound excludes the endpoint a
    # non-strict wanted bound includes
    return not (cached["lo_strict"] and not wanted["lo_strict"])


def _bound_covers_hi(cached: Dict, wanted: Dict) -> bool:
    ch = cached["hi"]
    if ch is None:
        return True
    wh = wanted["hi"]
    if wh is None:
        return False
    try:
        if ch[1] > wh[1]:
            return True
        if ch[1] < wh[1]:
            return False
    except TypeError:
        return False
    return not (cached["hi_strict"] and not wanted["hi_strict"])


def _in_range(v, desc: Dict) -> bool:
    try:
        if desc["lo"] is not None:
            if v < desc["lo"][1]:
                return False
            if v == desc["lo"][1] and desc["lo_strict"]:
                return False
        if desc["hi"] is not None:
            if v > desc["hi"][1]:
                return False
            if v == desc["hi"][1] and desc["hi_strict"]:
                return False
    except TypeError:
        return False
    return True


def descriptor_contains(cached: Dict, wanted: Dict) -> bool:
    """Whether every row the WANTED predicate keeps is provably kept
    by the CACHED predicate too — the condition under which replaying
    the cached pages through the wanted predicate yields exactly the
    wanted fragment. False on any doubt."""
    if cached is None or wanted is None:
        return False
    if cached["channel"] != wanted["channel"]:
        return False
    if "in" in cached:
        if "in" in wanted:
            return set(wanted["in"]) <= set(cached["in"])
        # a range only fits an IN list when it degenerates to equality
        lo, hi = wanted["lo"], wanted["hi"]
        return (lo is not None and hi is not None and lo == hi
                and not wanted["lo_strict"] and not wanted["hi_strict"]
                and lo[1] in set(cached["in"]))
    if "in" in wanted:
        return all(_in_range(v, cached) for v in wanted["in"])
    return _bound_covers_lo(cached, wanted) and \
        _bound_covers_hi(cached, wanted)


_FAM_CHAIN = (P.Project,)  # interior ops allowed under a family filter


def family_key(node: P.PhysicalNode, catalogs) -> Optional[tuple]:
    """(family key, descriptor, tables) for a Filter whose predicate
    parses to a containment descriptor over a bare scan + projection
    chain, else None. The family key is the subtree's canonical
    fingerprint with the predicate MASKED to a sentinel constant —
    every member of one family differs ONLY in its predicate (the
    descriptor carries the channel, so one family can hold entries
    over different columns without ambiguity), and the snapshot tokens
    still ride in the key so a write retires the whole family."""
    if not isinstance(node, P.Filter):
        return None
    desc = filter_descriptor(node.predicate)
    if desc is None:
        return None
    below = node.source
    while isinstance(below, _FAM_CHAIN):
        below = below.source
    if not isinstance(below, P.TableScan):
        return None
    if uncacheable_reason(node, catalogs) is not None:
        return None
    tables = frozenset(scan_tables(node))
    snap = snapshot_tokens(tables, catalogs)
    if snap is None:
        return None
    masked = dataclasses.replace(node, predicate=Constant("__fam__"))
    fp = plan_fingerprint(masked, catalogs)
    return (f"fam:{fp}:{structural_fingerprint(snap)}", desc, tables)


def select_cache_points(root: P.PhysicalNode, catalogs, *,
                        allow=None,
                        subsumable: bool = False) -> Dict[int, tuple]:
    """Choose the subtrees whose page streams this query caches:
    the MAXIMAL cacheable subtrees that contain at least one
    materializing operator. A fully cacheable plan gets exactly one
    point (its root); a plan with one volatile/system branch still
    caches every clean expensive branch under it. Returns
    {id(subnode): (key, subnode, tables, snap, fam)} — node references
    are held in the values so ids stay stable for the query's
    lifetime; ``snap`` is the snapshot-token tuple the key was built
    from (persistence validates it at warm load), and ``fam`` is
    (family key, descriptor) for subsumable Filter points, None
    otherwise.

    ``allow`` (optional predicate) gates which subtrees may become
    points at all — the distributed executor passes its distribution
    test so only REPLICATED subtrees cache (their pages are ordinary
    single-stream Pages a host replay can reproduce; mesh-SHARDED
    mid-plan pages could not — the mesh-path residency rule).

    ``subsumable`` additionally selects every qualifying
    single-predicate Filter-over-scan node (see family_key) as a
    point, INSIDE already-selected subtrees too — those points are
    what the overlapping-subsumption rewrite probes on an exact
    miss."""
    points: Dict[int, tuple] = {}

    def consider(node) -> bool:
        """True when ``node`` was made a cache point (callers then
        skip its subtree)."""
        if not _worth_caching(node):
            return False
        if allow is not None and not allow(node):
            return False
        if uncacheable_reason(node, catalogs) is None:
            keyed = subtree_key(node, catalogs)
            if keyed is not None:
                key, tables = keyed
                snap = snapshot_tokens(tables, catalogs)
                points[id(node)] = (key, node, tables, snap, None)
                return True
        return False

    def descend(node):
        for c in node.children():
            if not consider(c):
                descend(c)

    if not consider(root):
        descend(root)

    if subsumable:
        def families(node):
            if id(node) not in points and \
                    (allow is None or allow(node)):
                fam = family_key(node, catalogs)
                if fam is not None:
                    fkey, desc, tables = fam
                    keyed = subtree_key(node, catalogs)
                    if keyed is not None:
                        key, _ = keyed
                        snap = snapshot_tokens(tables, catalogs)
                        points[id(node)] = (key, node, tables, snap,
                                            (fkey, desc))
            for c in node.children():
                families(c)

        families(root)

    return points
