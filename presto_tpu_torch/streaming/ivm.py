"""Incremental view maintenance (IVM) over append-log streams.

Port of presto_tpu/streaming/ivm.py (reference: the materialized-view
refresh direction of the original — a registered aggregate over
changing data is maintained, not recomputed). The engine's
partial-aggregation machinery (``_partial_agg_page`` /
``_merge_partials_page`` / ``_final_agg_page``, exec/executor.py) is
already a delta fold: a settled partial-state page plus the partial
states of new rows merges to exactly the state of the whole input. So
for an IVM-SAFE view over an append-only stream, a refresh:

  1. scans ONLY the delta rows ``[watermark, head)`` through a pinned
     StreamWindowConnector and folds them through the partial step
     (Executor.ivm_delta_states: the same scan→filter→project→partial
     aggregation a cold run executes, K1 included, under the same
     overflow ladder);
  2. merges the delta states into the persisted settled state and
     finalizes (Executor.ivm_fold_finalize);
  3. replays the plan's post-aggregation chain (ORDER BY, projection,
     LIMIT) over the finalized page through a RemoteSource supplier.

Cost: O(new rows) + O(groups) per refresh instead of a full recompute.
The view's result-cache entry carries its offset WATERMARK and is
replaced in place by a refresh; the store's append-path reclaim keeps
watermarked entries alive (cache/store.advance_tables).

IVM-SAFE (decided statically at registration): one single-step GROUPED
aggregation whose functions all have mergeable partial states (collect
states are excluded: array_agg order does not decompose over appends),
a deterministic Filter/Project chain between scan and aggregation,
exactly one scan, of an append-only connector. Everything else still
registers but refreshes by FULL recompute, counted on
ivm_full_recomputes — degraded, never silently wrong.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from presto_tpu_torch.cache.rules import scan_tables, uncacheable_reason
from presto_tpu_torch.exec import agg_states as S
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec.executor import resolve_row_counts
from presto_tpu_torch.obs.profile import structural_fingerprint
from presto_tpu_torch.obs.sanitizer import (
    make_condition,
    make_lock,
    register_owner,
)

# plan shapes allowed ABOVE the aggregation (replayed over the
# finalized page per refresh: O(groups), all deterministic) and BELOW
# it (folded into the delta partial step)
_ABOVE_OK = (P.Output, P.Sort, P.TopN, P.Limit, P.Project, P.Filter)
_BELOW_OK = (P.Filter, P.Project, P.Exchange)


def _aggregations(node: P.PhysicalNode) -> List[P.Aggregation]:
    out: List[P.Aggregation] = []

    def walk(n):
        if isinstance(n, P.Aggregation):
            out.append(n)
        for c in n.children():
            walk(c)

    walk(node)
    return out


def ivm_unsafe_reason(plan: P.PhysicalNode, catalogs) -> Optional[str]:
    """None when ``plan`` can refresh incrementally; otherwise a short
    human-readable reason (surfaced by the registry and the tests,
    never raised: unsafe views fall back to counted full recomputes)."""
    r = uncacheable_reason(plan, catalogs)
    if r is not None:
        return r  # non-deterministic or snapshot-less: not even safely
        # recomputable into a watermarked entry
    aggs = _aggregations(plan)
    if len(aggs) != 1:
        return (f"{len(aggs)} aggregations (IVM maintains exactly one "
                f"fold point)")
    agg = aggs[0]
    if agg.step != "single":
        return f"aggregation step {agg.step!r} (already fragmented)"
    if not agg.group_channels:
        return ("global aggregation (no group keys — the merge kernel "
                "plane is grouped; falls back to full recompute)")
    for spec in agg.aggregates:
        if spec.function in S.COLLECT_FNS:
            return (f"collect-state aggregate {spec.function}() "
                    f"(element order is not append-decomposable)")
    # the chain ABOVE the aggregation reaches it through single-source
    # deterministic operators only
    node = plan
    while node is not agg:
        if not isinstance(node, _ABOVE_OK):
            return (f"{type(node).__name__} above the aggregation "
                    f"(only sort/project/filter/limit replay over the "
                    f"finalized state)")
        node = node.source
    # the chain BELOW is a pure per-row pipeline over ONE scan
    cur = agg.source
    while isinstance(cur, _BELOW_OK):
        cur = cur.source
    if not isinstance(cur, P.TableScan):
        return (f"{type(cur).__name__} between aggregation and scan "
                f"(delta rows must fold through a per-row pipeline)")
    conn = catalogs.get(cur.catalog)
    if not getattr(conn, "append_only", False):
        return (f"{cur.catalog}.{cur.table} is not an append-only "
                f"stream (writes may rewrite history)")
    if not hasattr(conn, "offset"):
        return f"{cur.catalog} connector exposes no offset"
    return None


def _rewrite(node, fn):
    """``node`` with every child rewritten by ``fn`` (dataclass fields
    holding a plan node or a tuple of them), then ``fn`` applied to
    the rebuilt node."""
    if not isinstance(node, P.PhysicalNode):
        return node
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, P.PhysicalNode):
            nv = _rewrite(v, fn)
        elif isinstance(v, tuple) and v and any(
                isinstance(x, P.PhysicalNode) for x in v):
            nv = tuple(_rewrite(x, fn) for x in v)
        else:
            nv = v
        if nv is not v:
            changes[f.name] = nv
    return fn(dataclasses.replace(node, **changes) if changes else node)


def _normalized(plan):
    """Plan copy with the planner's aggregation capacities masked: they
    derive from connector row counts, so a growing log would move a
    view's structural identity between registration and later
    statements of the same SQL. Shape matching is offset-free."""
    return _rewrite(plan, lambda n: dataclasses.replace(n, capacity=0)
                    if isinstance(n, P.Aggregation) else n)


def view_shape_fingerprint(plan: P.PhysicalNode) -> str:
    """Offset- and capacity-independent structural identity of a
    statement's plan: how tailing cursors recognize "this statement IS
    registered view X" across re-plans of a growing log."""
    return structural_fingerprint(_normalized(plan))


def _replace_node(root, target, repl):
    """``root`` with the node ``target`` (by identity) replaced by
    ``repl``."""
    return _rewrite(root, lambda n: repl if n is target else n)


def windowed_executor(catalogs, catalog: str, table: str, like=None):
    """(executor, window): a fresh Executor whose scans of
    ``catalog.table`` read through a mutable pinned offset window
    (connectors/stream.StreamWindowConnector) — the refresh and tail
    engine. It runs on ``like``'s device with its page size, kernel
    switch and capacity settings; without ``like``, on the stream
    connector's device."""
    from presto_tpu_torch.connectors.stream import StreamWindowConnector
    from presto_tpu_torch.exec.executor import Executor

    window = StreamWindowConnector(catalogs[catalog], table)
    cats = dict(catalogs)
    cats[catalog] = window
    if like is None:
        return Executor(cats, page_rows=1 << 18,
                        device=getattr(catalogs[catalog], "device",
                                       None)), window
    ex = Executor(cats, page_rows=like.page_rows, device=like.device,
                  kernels=like.kernels)
    for knob in ("collect_k", "agg_optimistic_rows", "max_memory_bytes"):
        setattr(ex, knob, getattr(like, knob))
    return ex, window


class MaterializedView:
    """One registered materialized aggregate over a stream scan.

    State (mutated under ``_cv``; the refresh itself runs OUTSIDE it,
    serialized by the ``_refreshing`` flag, so concurrent tailers
    coalesce onto one fold instead of racing the window):

      ``state_pages``  the settled partial-state page(s), HOST pages —
                       the persisted state a refresh folds delta
                       states into;
      ``watermark``    the log offset the last result covers;
      ``last_*``       the last finalized result (names, rows, types).
    """

    # lock discipline: refresh publication vs concurrent tailing readers
    _shared_attrs = ("state_pages", "state_offset", "watermark",
                     "last_names", "last_rows", "last_types",
                     "last_delta_rows", "refreshes",
                     "full_recomputes", "_refreshing")

    def __init__(self, name: str, sql: str, plan, catalogs, runner):
        self.name = name
        self.sql = sql
        self.plan = plan
        self.names = list(getattr(plan, "names", ()) or ())
        reason = ivm_unsafe_reason(plan, catalogs)
        self.ivm_safe = reason is None
        self.unsafe_reason = reason
        self.shape_fp = view_shape_fingerprint(plan)
        self.final_key = f"ivm:{name}"
        self.cache_key = f"ivm:{name}"
        # the stream scan (an unsafe view may scan anything: the first
        # scanned stream keeps the watermark)
        streams = [(c, t) for c, t in sorted(scan_tables(plan))
                   if getattr(catalogs.get(c), "append_only", False)]
        if not streams:
            raise ValueError(
                f"view {name!r} scans no append-only stream table")
        self.catalog, self.table = streams[0]
        self.source_conn = catalogs[self.catalog]
        self.executor, self.window = windowed_executor(
            catalogs, self.catalog, self.table,
            like=runner.executor if runner is not None else None)
        self.result_cache = (getattr(runner.executor, "result_cache", None)
                             if runner is not None else None)
        self.agg = None
        self.partial = None
        self.above_plan = None
        self.scan = None
        if self.ivm_safe:
            self.agg = _aggregations(plan)[0]
            self.partial = dataclasses.replace(self.agg, step="partial")
            cur = self.agg.source
            while isinstance(cur, _BELOW_OK):
                cur = cur.source
            self.scan = cur
            final_types = tuple(self.executor.output_types(self.agg))
            self.above_plan = _replace_node(
                plan, self.agg,
                P.RemoteSource(types=final_types, key=self.final_key))
        # watermark = the offset the LAST RESULT covers (drives tail
        # pollers and the settled early return); state_offset = the
        # offset the persisted PARTIAL STATE covers (a full recompute
        # leaves no state, so the two diverge until the next fold
        # re-folds from 0)
        self.state_pages: List = []
        self.state_offset = 0
        self.watermark = 0
        self.last_names: Optional[List[str]] = None
        self.last_rows: List[tuple] = []
        self.last_types: List[str] = []
        self.last_delta_rows = 0
        self.refreshes = 0
        self.full_recomputes = 0
        self._refreshing = False
        self._cv = make_condition(
            "streaming.ivm.MaterializedView._cv")
        register_owner(self, lock_attrs=("_cv",))

    def settled_offset(self) -> int:
        with self._cv:
            return self.watermark

    def snapshot_result(self):
        with self._cv:
            if self.last_names is None:
                return None
            return (list(self.last_names), list(self.last_rows),
                    list(self.last_types))


def _delta_fold(view: MaterializedView, lo: int, hi: int):
    """(delta state pages, rows scanned) of the log rows [lo, hi)."""
    ex = view.executor
    view.window.set_range(lo, hi)
    own_stats = ex._collect_stats is None
    if own_stats:
        ex._collect_stats = {}
    try:
        states = ex.ivm_delta_states(view.partial)
        resolve_row_counts(ex._collect_stats)
        st = ex._collect_stats.get(id(view.scan))
        return states, (st.rows if st is not None else hi - lo)
    finally:
        if own_stats:
            ex._collect_stats = None


def refresh(view: MaterializedView, session=None, sink=None):
    """Refresh ``view`` to the log's current offset and return
    ``(names, rows, types)``.

    An IVM-safe view folds ONLY the pages appended since the watermark
    into the persisted settled state; a disabled (``ivm_enabled=false``)
    or statically unsafe view recomputes in full over the pinned
    ``[0, head)`` window, counted on ``ivm_full_recomputes``. ``sink``
    (an Executor) receives the registry counters (``ivm_refreshes``,
    ``ivm_full_recomputes``, ``delta_pages_folded``), so EXPLAIN
    ANALYZE, /metrics and system.metrics surface refresh activity."""
    use_ivm = view.ivm_safe and (
        session is None or bool(session.get("ivm_enabled")))
    hi = view.source_conn.offset(view.table)
    with view._cv:
        while view._refreshing:
            view._cv.wait(0.05)
        if (use_ivm and view.last_names is not None
                and view.watermark >= hi):
            # settled: a concurrent tailer already folded this offset
            return (list(view.last_names), list(view.last_rows),
                    list(view.last_types))
        view._refreshing = True
        # re-read the head AFTER winning the flag: a refresher that
        # waited must fold to at least the offset the winner published,
        # or a slow loser could re-publish an OLDER snapshot (and
        # regress the watermark) over a newer one
        hi = max(hi, view.source_conn.offset(view.table), view.watermark)
        if (use_ivm and view.last_names is not None
                and view.watermark >= hi):
            view._refreshing = False
            view._cv.notify_all()
            return (list(view.last_names), list(view.last_rows),
                    list(view.last_types))
        lo = view.state_offset
        state = list(view.state_pages)
    try:
        ex = view.executor
        if not use_ivm:
            view.window.set_range(0, hi)
            names, rows = ex.execute(view.plan)
            types = [str(t) for t in ex.output_types(view.plan)]
            new_state: List = []  # the full state lives in the result
            scanned = hi
            if sink is not None:
                sink.count_ivm_refresh(full=True)
            full = True
        else:
            delta_states: List = []
            scanned = 0
            if hi > lo:
                delta_states, scanned = _delta_fold(view, lo, hi)
                if sink is not None:
                    sink.count_delta_pages(len(delta_states))
            prior = state
            state = state + delta_states
            if not state:
                names = list(view.names)
                rows = []
                types = [str(t) for t in ex.output_types(view.plan)]
                new_state = []
            else:
                # the observed group count (valid rows of the settled
                # state: host numpy, free to read) sizes the fold — the
                # planner's estimate follows the whole LOG's row count
                hint = sum(int(p.valid.sum()) for p in prior) or None
                settled, final_page = ex.ivm_fold_finalize(
                    view.partial, state, cap_hint=hint)
                new_state = [settled]
                ex.remote_sources[view.final_key] = (
                    lambda: iter([final_page]))
                try:
                    names, rows = ex.execute(view.above_plan)
                finally:
                    ex.remote_sources.pop(view.final_key, None)
                types = [str(t) for t in ex.output_types(view.above_plan)]
            if sink is not None:
                sink.count_ivm_refresh(full=False)
            full = False
        cache = view.result_cache
        if cache is not None:
            # ADVANCE the view's cache entry in place: the offset
            # watermark rides on the entry, so the append path's reclaim
            # (store.advance_tables) keeps it alive
            cache.put_rows(view.cache_key, list(names or []), rows, types,
                           {(view.catalog, view.table)}, watermark=hi)
        with view._cv:
            view.state_pages = new_state
            # a full recompute leaves no partial state: the next
            # incremental fold re-folds from offset 0
            view.state_offset = hi if (not full and new_state) else 0
            view.watermark = hi
            view.last_names = list(names or [])
            view.last_rows = rows
            view.last_types = types
            view.last_delta_rows = int(scanned)
            view.refreshes += 1
            if full:
                view.full_recomputes += 1
    finally:
        with view._cv:
            view._refreshing = False
            view._cv.notify_all()
    return list(names or []), rows, types


class IvmRegistry:
    """Registered materialized views, keyed by name AND by structural
    shape fingerprint (the tailing-cursor lookup)."""

    # lock discipline: registration from setup threads vs shape lookups
    # from protocol handler threads
    _shared_attrs = ("_views", "_by_shape")

    def __init__(self):
        self._views: Dict[str, MaterializedView] = {}
        self._by_shape: Dict[str, MaterializedView] = {}
        self._lock = make_lock("streaming.ivm.IvmRegistry._lock")
        register_owner(self)

    def register(self, runner, name: str, sql: str) -> MaterializedView:
        """Plan ``sql`` on ``runner`` and register it as a maintained
        view. Planning runs outside the registry lock (it may execute
        plan-time scalar subqueries)."""
        plan = runner.plan(sql)
        view = MaterializedView(name, sql, plan, runner.catalogs, runner)
        with self._lock:
            old = self._views.get(name)
            if old is not None:
                self._by_shape.pop(old.shape_fp, None)
            self._views[name] = view
            self._by_shape[view.shape_fp] = view
        return view

    def get(self, name: str) -> Optional[MaterializedView]:
        with self._lock:
            return self._views.get(name)

    def views(self) -> List[MaterializedView]:
        with self._lock:
            return list(self._views.values())

    def match(self, plan: P.PhysicalNode) -> Optional[MaterializedView]:
        """The registered view whose shape this plan IS, or None: how a
        tailing /v1/statement cursor decides to ride the IVM path
        instead of re-executing per poll."""
        fp = view_shape_fingerprint(plan)
        with self._lock:
            return self._by_shape.get(fp)

    def unregister(self, name: str) -> bool:
        with self._lock:
            view = self._views.pop(name, None)
            if view is not None:
                self._by_shape.pop(view.shape_fp, None)
            return view is not None


# ------------------------------------------------- the shared instance
_shared_lock = make_lock("streaming.ivm._shared_lock")
_shared: Optional[IvmRegistry] = None


def shared_registry() -> IvmRegistry:
    """THE process-shared registry (cache/store.shared_cache's pattern):
    the HTTP server's tail cursors and library users see one view set."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = IvmRegistry()
        return _shared


def shared_registry_if_exists() -> Optional[IvmRegistry]:
    return _shared
