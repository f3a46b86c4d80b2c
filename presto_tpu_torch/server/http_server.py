"""Coordinator HTTP service speaking the Presto client protocol.

Port of presto_tpu/server/http_server.py, its serving part. Reference:
presto-main server/protocol/StatementResource.java (the /v1/statement
paged REST protocol: POST the SQL, follow nextUri until it disappears,
token-addressed result pages, DELETE to cancel) plus
server/PrestoServer bootstrap. Sessions are client-carried exactly like
the reference: X-Presto-Session request headers hold property
overrides, SET SESSION responds with X-Presto-Set-Session and the
client echoes it back on later requests — the server itself stays
stateless per query.

The engine is the port's LocalRunner on the server's device (the card
unless ``device="cpu"``). Without ``memory_budget_bytes`` queries run
one at a time on one bootstrap runner (the serial path; with
``worker_uris`` plain queries dispatch through the DcnRunner).
With it, each query runs on its own runner and executor, admitted by
resource group and by estimated device footprint (MemoryArbiter), and
their single-split fused launches gang through one shared
LaunchBatcher. Captured programs are process-wide (exec/graphs.py), so
every per-query executor replays the same captures; every query thread
issues on its own current stream, the legacy default stream, so a
replay's output clone and the next replay stay ordered.

Coordinator HA: with ``checkpoint_dir`` (or the checkpoint_dir session
property) each query's admission, its stage-DAG barriers, its result
and every client-protocol page handed out are journaled
(dist/checkpoint.py). A server booted on the same directory re-attaches
every journaled query under its original id: the spooled fast path
resumes from the surviving producer spools (dead ones re-dispatched),
else the statement re-runs, else the query fails with
CoordinatorRestarted; the client's stream resumes at its token once
the delivered pages' digests verify.

``mesh=make_mesh(D)`` (dist/executor.py) runs every statement on a
DistExecutor over the mesh's shards, serial and concurrent paths alike.

The result cache: the concurrent path defaults ``result_cache_enabled``
on (an explicit client or deployment off wins), so its per-query
runners share the process store; a statement the store would answer
whole (``LocalRunner.statement_cache_probe``) runs at once, outside the
resource-group line and the arbiter (``cache_admission_bypasses``), and
the arbiter's estimate discounts resident cached fragments. /metrics
and system.metrics overlay the store's process totals.

``plugins=`` installs plugins on the bootstrap runner (plugin.py): their
catalogs, functions and types serve every query, their event listeners
join the server's, and a contributed AccessControl guards every
statement, every scan and every X-Presto-Session property; a denial is
a FAILED query (``AccessDeniedError``; ``PERMISSION_DENIED`` with HTTP
403 when a header property is denied at submission). The system
catalog gains the server's runtime tables: runtime_queries,
runtime_tasks, nodes and metrics.

Tailing cursors: under ``stream_tail_enabled`` (a header flag or SET
SESSION) a plain query over an append-only stream table
(connectors/stream.py) becomes a never-finishing cursor (TailCursor):
its nextUri persists, each fresh token long-polls the log for
``stream_poll_ms`` and serves only the rows derived from new offsets —
through the registered materialized view the statement matches
(streaming/ivm.py), through the pinned delta window for a per-row
pipeline, else by a re-run and a multiset diff. DELETE ends it.
Tailing statements pass the resource-group gate; a mesh server tails
nothing (the cursors ride the local executor), as in the reference.
"""

from __future__ import annotations

import datetime
import json
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import urlparse

from presto_tpu_torch.obs.sanitizer import (
    make_condition,
    make_lock,
    register_owner,
)
from presto_tpu_torch.session import SYSTEM_SESSION_PROPERTIES, Session

_PAGE_ROWS = 4096  # rows per protocol fetch (client paging granularity)
# tailing cursors retain only this many recent token spans' rows — the
# retry horizon; a never-finishing cursor must not hold every row it
# ever emitted (clients only ever re-fetch their latest token)
_TAIL_RETAIN_SPANS = 8


class _Query:
    """Reference: server/protocol/Query.java — one statement's life."""

    def __init__(self, qid: str, sql: str, session: Session):
        self.id = qid
        self.sql = sql
        self.session = session
        self.state = "QUEUED"
        self.columns: Optional[List[Dict]] = None
        self.rows: List[list] = []
        self.error: Optional[Dict] = None
        self.update_type: Optional[str] = None
        self.set_session: Dict[str, str] = {}
        # ONE wall anchor (display/correlation); every elapsed-time
        # computation runs on the monotonic clock
        self.created = time.time()
        self.created_mono = time.monotonic()
        self.finished_at: Optional[float] = None
        self.finished_mono: Optional[float] = None
        self.cancelled = False
        self.done = threading.Event()
        # lifecycle trace (obs.QueryTrace), captured from the runner
        # when the query completes; while RUNNING the live trace is
        # read off the runner's executor (QueryManager.query_info)
        self.trace = None
        self.runner = None
        self.resource_group = None
        self.in_admission = False
        # the durable journal handle (dist/checkpoint.QueryCheckpoint):
        # non-None means this query's lifecycle and protocol-token
        # advances are journaled for crash re-attach
        self.checkpoint = None
        # a tailing cursor: non-None turns this query into a
        # never-finishing stream cursor served by _tail_results
        self.tail: Optional["TailCursor"] = None

    def _finish_clock(self) -> None:
        if self.finished_at is None:
            self.finished_at = time.time()
            self.finished_mono = time.monotonic()

    def info(self) -> Dict:
        end_mono = (self.finished_mono if self.finished_mono
                    is not None else time.monotonic())
        return {
            "queryId": self.id,
            "state": self.state,
            "query": self.sql,
            "createTime": self.created,
            "elapsedTimeMillis": int((end_mono - self.created_mono) * 1000),
            "error": self.error,
            "rowCount": len(self.rows),
        }


class TailCursor:
    """One tailing /v1/statement cursor over an append-only stream: the
    statement's nextUri never terminates — each poll long-polls the log
    (StreamConnector.wait_for_offset) and emits ONLY rows derived from
    new offsets. Three poll strategies, chosen once from the planned
    statement:

      view       the statement IS a registered materialized view (shape
                 fingerprint match, streaming/ivm.py): polls ride the
                 incremental refresh — an O(new rows) fold — and emit
                 the multiset delta of the refreshed result against the
                 previously emitted one (changed or new aggregate rows);
      delta      a pure per-row pipeline (Output → Filter/Project* →
                 stream scan): polls execute the plan over the pinned
                 [last, head) window only — exactly the new rows;
      recompute  anything else over a stream: polls re-execute the
                 statement and emit the multiset delta — O(full) per
                 poll, never wrong.

    Concurrency: protocol GETs may race on one cursor. State mutates
    only under ``_cv``; a poll's query execution runs OUTSIDE it behind
    the ``_polling`` flag (concurrent pollers wait, then read the fresh
    span), so no engine work runs under a lock. Token paging is
    span-addressed: token t re-serves its recorded row span verbatim
    (retry-safe), the first fresh token takes everything new."""

    # lock discipline
    _shared_attrs = ("columns", "types", "rows", "error", "closed",
                     "_polling", "_spans", "last_rows", "last_offset",
                     "_base", "_span_base", "resource_group")

    def __init__(self, runner, plan, streams, sink):
        from presto_tpu_torch.streaming import ivm as IVM

        self.runner = runner
        self.plan = plan
        # every append-only table the statement scans: polls wake on ANY
        # of them advancing (view and delta modes have exactly one;
        # recompute mode may join several streams)
        self.streams = list(streams)
        self.catalog, self.table = self.streams[0]
        self.conn = runner.catalogs[self.catalog]
        self.sink = sink  # the bootstrap executor: registry counters
        self.poll_ms = int(runner.session.get("stream_poll_ms"))
        reg = IVM.shared_registry_if_exists()
        self.view = reg.match(plan) if reg is not None else None
        self.window = None
        self.executor = None
        if self.view is not None:
            self.mode = "view"
        elif self._delta_shape(plan):
            self.mode = "delta"
            self.executor, self.window = IVM.windowed_executor(
                runner.catalogs, self.catalog, self.table,
                like=runner.executor)
        else:
            self.mode = "recompute"
        self.columns: Optional[List[Dict]] = None
        self.types: List[str] = []
        # emitted rows, trimmed to the retry horizon: _base is the
        # ABSOLUTE index of rows[0]
        self.rows: List[tuple] = []
        self._base = 0
        # recent token spans only (ABSOLUTE (lo, hi) row indices);
        # _span_base counts the spans trimmed off the front — an idle
        # cursor heartbeats one span per poll forever, so the span list
        # is bounded like the rows it addresses
        self._spans: List[tuple] = []
        self._span_base = 0
        self.last_rows: List[tuple] = []  # the last full result (diff)
        # the SUM of the offsets of every scanned stream
        self.last_offset = 0
        self.error: Optional[Dict] = None
        self.closed = False
        self._polling = False
        # the resource-group admission slot (start_tail admits a tailing
        # statement through submit()'s gate; close releases it)
        self.resource_group = None
        self._rg_manager = None
        self._cv = make_condition(
            "server.http_server.TailCursor._cv")
        register_owner(self, lock_attrs=("_cv",))

    def _delta_shape(self, plan) -> bool:
        """True for Output → (Filter|Project)* → TableScan of THE stream
        table: the shape whose delta-window execution equals the delta
        of its results."""
        from presto_tpu_torch.exec import plan as P

        if not isinstance(plan, P.Output):
            return False
        node = plan.source
        while isinstance(node, (P.Filter, P.Project)):
            node = node.source
        return (isinstance(node, P.TableScan)
                and node.catalog == self.catalog
                and node.table == self.table)

    # ------------------------------------------------------- polling
    def _offsets_total(self) -> int:
        return sum(self.runner.catalogs[c].offset(t)
                   for c, t in self.streams)

    def _wait_any(self, timeout_s: float) -> int:
        """Long-poll until ANY scanned stream advances past the last
        observed offsets, or the timeout lapses; returns the summed
        offset. A single-stream cursor waits on the connector's
        condition; a multi-stream one polls in slices (an append to
        EITHER side of a stream join must produce rows)."""
        base = self.last_offset
        if len(self.streams) == 1:
            c, t = self.streams[0]
            self.runner.catalogs[c].wait_for_offset(t, base, timeout_s)
            return self._offsets_total()
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while True:
            total = self._offsets_total()
            remaining = deadline - time.monotonic()
            if total > base or remaining <= 0:
                return total
            time.sleep(min(0.05, remaining))

    def poll(self, timeout_s: float) -> None:
        """Advance the cursor: wait for new offsets (up to
        ``timeout_s``), compute the delta-derived rows, append them. A
        failure closes the cursor with an error body (the protocol's
        FAILED contract, never a dropped connection)."""
        with self._cv:
            while self._polling and not self.closed:
                self._cv.wait(0.05)
            if self.closed:
                return
            self._polling = True
        new_rows: List[tuple] = []
        full = cols = types = offset = err = None
        try:
            new_rows, full, cols, types, offset = self._compute(timeout_s)
        except Exception as e:  # noqa: BLE001 - the protocol surfaces
            # every tail failure as an error body on the cursor
            err = {"message": str(e)[:2000], "errorName": type(e).__name__}
        with self._cv:
            self._polling = False
            if err is not None:
                self.error = err
                self.closed = True
            else:
                if cols is not None and self.columns is None:
                    self.columns = cols
                    self.types = types or []
                if full is not None:
                    self.last_rows = full
                if offset is not None:
                    self.last_offset = offset
                self.rows.extend(new_rows)
            self._cv.notify_all()

    def _compute(self, timeout_s: float):
        """(delta rows, full result or None, columns or None, types,
        new offset). Runs OUTSIDE the lock (see the class docstring)."""
        from presto_tpu_torch.streaming import ivm as IVM

        initial = self.columns is None
        hi = self._offsets_total() if initial else self._wait_any(timeout_s)
        self.sink.count_cursor_poll()
        if not initial and hi <= self.last_offset:
            return [], None, None, None, None  # a quiet poll
        if not initial:
            # the log moved under a tailing cursor: one observed batch
            self.sink.count_stream_append()
        if self.mode == "view":
            names, rows, types = IVM.refresh(
                self.view, session=self.runner.session, sink=self.sink)
            delta = rows if initial else _multiset_delta(rows,
                                                         self.last_rows)
            cols = [{"name": n, "type": t} for n, t in zip(names, types)]
            return delta, list(rows), cols, types, hi
        if self.mode == "delta":
            ex = self.executor
            self.window.set_range(0 if initial else self.last_offset, hi)
            names, rows = ex.execute(self.plan)
            types = [str(t) for t in ex.output_types(self.plan)]
            cols = [{"name": n, "type": t}
                    for n, t in zip(names or [], types)]
            return rows, None, cols, types, hi
        # recompute: the statement re-executes and its multiset diff is
        # emitted — every poll is a real run, never a wrong one
        ex = self.runner.executor
        names, rows = ex.execute(self.plan)
        types = [str(t) for t in ex.output_types(self.plan)]
        cols = [{"name": n, "type": t} for n, t in zip(names or [], types)]
        delta = rows if initial else _multiset_delta(rows, self.last_rows)
        return delta, list(rows), cols, types, hi

    # ------------------------------------------------- token paging
    def take_span(self, token: int):
        """JSON rows for ``token``: a RECENT token re-serves its exact
        recorded span (retry-safe); the next fresh token takes every row
        emitted since the previous span. None for tokens further ahead
        or already trimmed past the retry horizon."""
        with self._cv:
            idx = token - self._span_base
            if idx < 0:
                return None  # trimmed: beyond the retry horizon
            if idx < len(self._spans):
                lo, hi = self._spans[idx]
            elif idx == len(self._spans):
                lo = self._spans[-1][1] if self._spans else self._base
                hi = self._base + len(self.rows)
                self._spans.append((lo, hi))
                # bound the cursor's memory: spans AND the rows they
                # address drop past the retry horizon
                if len(self._spans) > _TAIL_RETAIN_SPANS:
                    drop = len(self._spans) - _TAIL_RETAIN_SPANS
                    floor = self._spans[drop][0]
                    del self._spans[:drop]
                    self._span_base += drop
                    if floor > self._base:
                        del self.rows[:floor - self._base]
                        self._base = floor
            else:
                return None
            types = self.types
            return [_json_row(r, types)
                    for r in self.rows[lo - self._base:hi - self._base]]

    def spans_served(self) -> int:
        with self._cv:
            return self._span_base + len(self._spans)

    def close(self) -> None:
        """Stop the cursor and RELEASE its engine state (the dedicated
        runner and executor, the delta window, the diff snapshot) and its
        resource-group slot. The already-emitted rows stay servable for
        the final page. Waits out an in-flight poll (bounded by the poll
        timeout) so the engine refs are never dropped under a running
        query."""
        with self._cv:
            self.closed = True
            self._cv.notify_all()
            while self._polling:
                self._cv.wait(0.05)
            self.last_rows = []
            group, self.resource_group = self.resource_group, None
        if group is not None and self._rg_manager is not None:
            self._rg_manager.cancel_queued(group)
        self.runner = None
        self.executor = None
        self.window = None
        self.view = None


def _multiset_delta(new_rows, old_rows):
    """Rows of ``new_rows`` not covered by ``old_rows`` as a multiset
    (repr-keyed: rows may carry unhashable nested values) — the changed
    or new rows a dashboard diff emits per refresh."""
    import collections

    old = collections.Counter(map(repr, old_rows))
    out = []
    for r in new_rows:
        k = repr(r)
        if old[k] > 0:
            old[k] -= 1
        else:
            out.append(r)
    return out


class MemoryArbiter:
    """Admission by estimated device footprint (reference:
    memory/ClusterMemoryManager + query.max-memory): queries reserve
    their estimate and block until it fits the budget. A query larger
    than the whole budget is admitted only when it would run alone —
    progress is guaranteed, concurrency degrades to serial exactly
    when memory demands it."""

    # lock discipline: the reservation tallies every query's admission
    # thread contends on
    _shared_attrs = ("used", "active")

    def __init__(self, total_bytes: int):
        self.total = int(total_bytes)
        self.used = 0
        self.active = 0
        self._cv = make_condition(
            "server.http_server.MemoryArbiter._cv")
        register_owner(self, lock_attrs=("_cv",))

    def acquire(self, est: int, should_abort=None) -> bool:
        with self._cv:
            while True:
                if should_abort is not None and should_abort():
                    return False
                if self.used + est <= self.total or self.active == 0:
                    self.used += est
                    self.active += 1
                    return True
                self._cv.wait(timeout=0.1)

    def release(self, est: int) -> None:
        with self._cv:
            self.used -= est
            self.active -= 1
            self._cv.notify_all()


def _result_cache_totals() -> Dict[str, int]:
    """Process-total result-cache tallies under the registry counter
    names (zeros when no session ever created the shared store: a
    metrics scrape never allocates one)."""
    from presto_tpu_torch.cache import shared_cache_if_exists

    rc = shared_cache_if_exists()
    if rc is None:
        return {name: 0 for name in (
            "result_cache_hits", "result_cache_misses",
            "result_cache_evictions", "result_cache_invalidations",
            "cache_warm_loads", "cache_remote_hits",
            "cache_subsumed_hits", "cache_manifest_drops")}
    return rc.counters()


def _overlay_totals() -> Dict[str, float]:
    """Process totals the /metrics scrape overlays on the bootstrap
    executor's counters: the transfer ledger (exec/xfer.py) and the
    exchange wire and connection-reuse tallies (dist/serde.py,
    dist/connpool.py). Per-query executors come and go on the
    concurrent path, and worker task executors never surface here, so
    the process accumulation is the truth. The result cache's totals
    come from the process-shared store the queries actually shared."""
    from presto_tpu_torch.dist import connpool as CONNPOOL
    from presto_tpu_torch.dist import serde as SERDE
    from presto_tpu_torch.exec import xfer as XF

    out = dict(XF.process_totals())
    out.update(SERDE.wire_totals())
    out.update(CONNPOOL.pool_totals())
    out.update(_result_cache_totals())
    return out


class QueryManager:
    """Reference: execution/SqlQueryManager.java — registry + lifecycle
    (QUEUED -> RUNNING -> FINISHED/FAILED/CANCELED)."""

    # lock discipline: attributes touched from both HTTP handler
    # threads and query-execution threads — written ONLY under
    # self._lock outside __init__
    _shared_attrs = ("_queries", "_seq", "completed_by_state",
                     "rows_returned_total", "query_wall_ms_total",
                     "cache_admission_bypasses",
                     "exec_counter_totals", "queued_now", "peak_queued",
                     "journal")

    # launch/batch counters accumulated across the concurrent path's
    # per-query executors at completion: those executors are discarded
    # per query, so the PROCESS aggregate lives here and overlays the
    # registry snapshot on /metrics
    # (split_batch_fallbacks too, beyond the reference's list: a failed
    # shared launch must show on /metrics)
    _EXEC_TOTAL_SUMS = (
        "program_launches", "splits_scanned", "cross_query_batches",
        "cross_query_batched_queries", "batch_gather_wait_ms",
        "split_batch_fallbacks",
    )
    _EXEC_TOTAL_MAX = ("queries_per_launch",)

    def __init__(self, runner_factory, listeners=(),
                 resource_groups=None, memory_arbiter=None,
                 listener_error_counter=None, journal=None,
                 counter_executor=None, dcn=None):
        from presto_tpu_torch.obs.histo import Histogram

        self._runner_factory = runner_factory
        # the durable coordinator journal: the server's (checkpoint.dir
        # etc key / constructor), or one bound lazily from the
        # checkpoint_dir session property at the first enabled submit
        self.journal = journal
        self._counter_ex = counter_executor
        # the DCN dispatch plane whose scheduler barriers the query's
        # checkpoint handle is attached to
        self._dcn = dcn
        self._queries: Dict[str, _Query] = {}
        self._seq = 0
        self._lock = make_lock("server.http_server.QueryManager._lock")
        # the serial path when no arbiter is configured
        self._exec_lock = make_lock(
            "server.http_server.QueryManager._exec_lock")
        self.memory = memory_arbiter
        self.listeners = list(listeners)
        # swallowed-listener-exception sink (events.dispatch on_error ->
        # the bootstrap executor's listener_errors registry counter)
        self._listener_error = listener_error_counter
        # admission control (reference: resourceGroups/*; None = admit
        # everything)
        self.resource_groups = resource_groups
        # /metrics tallies (reference: airlift stats -> JMX; here a
        # Prometheus text endpoint)
        self.completed_by_state: Dict[str, int] = {}
        self.rows_returned_total = 0
        self.query_wall_ms_total = 0
        # statements served whole from the result cache without taking
        # a resource-group slot or an arbiter reservation
        self.cache_admission_bypasses = 0
        self.exec_counter_totals: Dict[str, int] = {}
        # admission queue depth: queries waiting for a resource-group
        # slot, a memory reservation or the serial exec lock, and the
        # lifetime peak
        self.queued_now = 0
        self.peak_queued = 0
        # latency histograms (obs/histo.py): query wall and per-stage
        # wall for p50/p95/p99, scraped by /metrics
        self.latency_histo = Histogram()
        self.stage_histo = Histogram()
        register_owner(self)

    def _journal_for(self, session: Session):
        """The journal this query's barriers record to, or None
        (checkpoint_enabled false, or no directory anywhere)."""
        if not bool(session.get("checkpoint_enabled")):
            return None
        if self.journal is not None:
            return self.journal
        d = session.get("checkpoint_dir")
        if not d:
            return None
        from presto_tpu_torch.dist.checkpoint import CheckpointJournal

        j = CheckpointJournal(d, counter_ex=self._counter_ex)
        with self._lock:
            if self.journal is None:
                self.journal = j
            return self.journal

    def _next_id(self) -> str:
        with self._lock:
            self._seq += 1
            seq = self._seq
        return (time.strftime("%Y%m%d_%H%M%S")
                + f"_{seq:05d}_{uuid.uuid4().hex[:5]}")

    def submit(self, sql: str, session: Session) -> _Query:
        from presto_tpu_torch import events as E

        group = None
        if self.resource_groups is not None:
            # raises QueryQueueFullError before the query exists
            # (reference: admission happens ahead of planning)
            group = self.resource_groups.admit(session.user)
        q = _Query(self._next_id(), sql, session)
        q.resource_group = group
        with self._lock:
            self._queries[q.id] = q
        j = self._journal_for(session)
        if j is not None:
            # the admission barrier: statement, session and group land
            # durably before the execution thread exists
            q.checkpoint = j.admit(
                q.id, sql, _session_snapshot(session),
                str(group.paths[-1]) if group is not None else None)
        E.dispatch(self.listeners, "query_created", E.QueryCreatedEvent(
            query_id=q.id, sql=sql, user=session.user,
            create_time=q.created,
        ), on_error=self._listener_error)
        threading.Thread(target=self._run, args=(q,), daemon=True).start()
        return q

    def get(self, qid: str) -> Optional[_Query]:
        return self._queries.get(qid)

    def register_tail(self, sql: str, session: Session,
                      cursor: TailCursor) -> _Query:
        """Register a tailing cursor as a RUNNING query: it appears in
        /v1/query and system.runtime_queries like any statement, but no
        execution thread is spawned — polls ride the protocol GET
        handlers (TailCursor.poll serializes them)."""
        q = _Query(self._next_id(), sql, session)
        q.tail = cursor
        q.state = "RUNNING"
        with self._lock:
            self._queries[q.id] = q
        return q

    def queries(self) -> List[_Query]:
        with self._lock:
            return list(self._queries.values())

    def cancel(self, qid: str) -> bool:
        q = self._queries.get(qid)
        if q is None:
            return False
        q.cancelled = True
        if not q.done.is_set():
            q.state = "CANCELED"
            q._finish_clock()
            q.done.set()
        return True

    def query_info(self, qid: str) -> Optional[Dict]:
        """The QueryInfo/StageInfo/TaskInfo tree for one query
        (reference: /v1/query/{id}), served LIVE: a RUNNING query's
        tree comes off its runner's active trace."""
        q = self._queries.get(qid)
        if q is None:
            return None
        info = q.info()
        tr = q.trace
        if tr is None and not q.done.is_set():
            r = q.runner
            tr = getattr(r.executor, "trace", None) if r is not None \
                else None
        if tr is not None:
            tree = tr.to_info()
            info["stages"] = tree["stages"]
            info["spanCount"] = tree["spanCount"]
        else:
            info["stages"] = []
            info["spanCount"] = 0
        return info

    def _run(self, q: _Query) -> None:
        group = q.resource_group
        runner = None
        if self.memory is not None and not q.cancelled:
            # cache-aware admission: a statement the result cache would
            # serve whole costs near nothing, so it takes no
            # resource-group slot and no arbiter reservation (host work
            # only: parse, plan, a tally-free peek). Advisory: an
            # eviction racing in between runs the query for real
            runner = self._runner_factory(q.session)
            if runner.statement_cache_probe(q.sql):
                if group is not None:
                    self.resource_groups.cancel_queued(group)
                with self._lock:
                    self.cache_admission_bypasses += 1
                self._execute(q, runner)
                return
        self._queue_enter(q)
        if group is not None:
            if q.cancelled:
                self.resource_groups.cancel_queued(group)
                self._record_completion(q)
                return
            if not self.resource_groups.acquire(
                    group, should_abort=lambda: q.cancelled):
                # canceled while queued: acquire released the queue slot
                self._record_completion(q)
                return
        try:
            self._run_admitted(q, runner)
        finally:
            if group is not None:
                self.resource_groups.release(group)

    def _queue_enter(self, q: _Query) -> None:
        """Mark q as waiting for admission; paired with _queue_exit
        through a consumed-once flag, so abort paths and the execute
        path can both exit without double counting."""
        q.in_admission = True
        with self._lock:
            self.queued_now += 1
            self.peak_queued = max(self.peak_queued, self.queued_now)

    def _queue_exit(self, q: _Query) -> None:
        if q.in_admission:
            q.in_admission = False
            with self._lock:
                self.queued_now -= 1

    def _run_admitted(self, q: _Query, runner=None) -> None:
        if self.memory is None:
            with self._exec_lock:
                # concheck: blocking-ok - the serial path: one query at a time on the bootstrap runner is this lock's purpose
                self._execute(q)
            return
        # concurrent path: admission by estimated footprint replaces the
        # global lock; each query runs on its own runner/executor
        # (captured programs are process-wide), so small queries
        # interleave while the arbiter keeps the sum under budget
        if runner is None:
            runner = self._runner_factory(q.session)
        est = runner.estimate_memory(q.sql)
        group = q.resource_group
        if group is not None:
            # the group's memory_share becomes THIS query's governed
            # device budget (exec/membudget.py), so N concurrent queries
            # split the card by policy instead of colliding into the OOM
            # ladder; an explicit session device_memory_budget wins
            share = self.resource_groups.memory_share_for(group)
            if share > 0 and not q.session.is_set("device_memory_budget"):
                from presto_tpu_torch.exec import membudget as MB

                q.session.set("device_memory_budget", MB.group_share_bytes(
                    share, device=runner.executor.device))
            # per-group memory quotas gate before the global arbiter
            # (reference: soft_memory_limit per resource group)
            if not self.resource_groups.reserve_memory(
                    group, est, should_abort=lambda: q.cancelled):
                self._record_completion(q)
                return
        try:
            if not self.memory.acquire(est,
                                       should_abort=lambda: q.cancelled):
                self._record_completion(q)
                return
            try:
                self._execute(q, runner)
            finally:
                self.memory.release(est)
        finally:
            if group is not None:
                self.resource_groups.release_memory(group, est)

    def _execute(self, q: _Query, runner=None) -> None:
        self._queue_exit(q)
        ckpt = q.checkpoint
        if q.cancelled:
            # canceled while queued: still record completion so event
            # listeners and /metrics see every created query finish
            self._record_completion(q)
            if ckpt is not None:
                ckpt.delivered()  # nothing left to recover
            return
        q.state = "RUNNING"
        if ckpt is not None:
            ckpt.running()
            # the stage barriers ride the DCN scheduler, which reads
            # this handle; serial path only, so one query owns it
            if self._dcn is not None:
                self._dcn.checkpoint_handle = ckpt
        prev_trace = None
        try:
            if runner is None:
                runner = self._runner_factory(q.session)
            q.runner = runner  # live-trace handle for query_info
            prev_trace = getattr(runner, "last_trace", None)
            result = runner.execute(q.sql)
            types = result.column_types or [
                "unknown" for _ in result.column_names]
            q.columns = [{"name": n, "type": t}
                         for n, t in zip(result.column_names, types)]
            q.rows = [_json_row(r, types) for r in result.rows]
            q.update_type = result.update_type
            if result.update_type == "SET SESSION":
                # surface the new value so clients echo it back
                # (X-Presto-Set-Session round trip)
                from presto_tpu_torch.sql import ast_nodes as N
                from presto_tpu_torch.sql.parser import parse

                stmt = parse(q.sql)
                if isinstance(stmt, N.SetSession):
                    q.set_session[stmt.name] = str(stmt.value)
            if not q.cancelled:
                q.state = "FINISHED"
                if ckpt is not None:
                    # the rows exist but the client has not drained
                    # them: the record stays (with columns and row
                    # count) until the stream completes
                    ckpt.finished(q.columns or [], len(q.rows))
        except Exception as e:  # noqa: BLE001 - the protocol surfaces
            # EVERY query failure as a FAILED state with an error body
            # (reference: QueryResults.error), never as a dropped
            # HTTP connection
            if not q.cancelled:
                q.error = {"message": str(e)[:2000],
                           "errorName": type(e).__name__}
                q.state = "FAILED"
                if ckpt is not None:
                    ckpt.failed(str(e), type(e).__name__)
        finally:
            if ckpt is not None and self._dcn is not None:
                self._dcn.checkpoint_handle = None
            q._finish_clock()
            if runner is not None:
                # snapshot the finished trace before the serial runner
                # moves on; a control statement keeps the runner's
                # previous trace, and only a NEW trace is this query's
                lt = getattr(runner, "last_trace", None)
                q.trace = lt if lt is not prev_trace else None
            q.done.set()
            self._record_completion(q)
            self._accumulate_exec_totals(runner)

    def _accumulate_exec_totals(self, runner) -> None:
        """Fold one finished query's launch/batch counters into the
        process aggregate (concurrent path only: the serial path's
        bootstrap executor already IS the process surface)."""
        if self.memory is None or runner is None:
            return
        ex = runner.executor
        with self._lock:
            t = dict(self.exec_counter_totals)
            for name in self._EXEC_TOTAL_SUMS:
                t[name] = t.get(name, 0) + int(getattr(ex, name, 0))
            for name in self._EXEC_TOTAL_MAX:
                t[name] = max(t.get(name, 0), int(getattr(ex, name, 0)))
            self.exec_counter_totals = t

    def _record_completion(self, q: _Query) -> None:
        from presto_tpu_torch import events as E

        self._queue_exit(q)
        wall_ms = q.info()["elapsedTimeMillis"]
        with self._lock:
            by_state = dict(self.completed_by_state)
            by_state[q.state] = by_state.get(q.state, 0) + 1
            self.completed_by_state = by_state
            self.rows_returned_total += len(q.rows)
            self.query_wall_ms_total += wall_ms
        self.latency_histo.observe(wall_ms / 1000.0)
        query_info = None
        if q.trace is not None:
            query_info = q.trace.to_info()
            for stage in query_info["stages"]:
                self.stage_histo.observe(stage["wallMs"] / 1000.0)
        err = q.error or {}
        E.dispatch(
            self.listeners, "query_completed", E.QueryCompletedEvent(
                query_id=q.id, sql=q.sql, user=q.session.user,
                state=q.state, create_time=q.created,
                end_time=q.finished_at or time.time(),
                wall_ms=wall_ms, row_count=len(q.rows),
                error_name=err.get("errorName"),
                error_message=err.get("message"),
                query_info=query_info,
            ),
            on_error=self._listener_error,
        )

    def metrics_text(self, uptime: float, executor=None) -> str:
        """Prometheus text exposition (reference role: JMX beans +
        presto-jmx; a /metrics scrape replaces the MBean server)."""
        from presto_tpu_torch.exec import counters as CTRS

        lines = [
            "# TYPE presto_tpu_uptime_seconds gauge",
            f"presto_tpu_uptime_seconds {uptime:.3f}",
            "# TYPE presto_tpu_queries_total counter",
        ]
        with self._lock:
            for state, n in sorted(self.completed_by_state.items()):
                lines.append(
                    f'presto_tpu_queries_total{{state="{state}"}} {n}')
            running = sum(1 for q in self._queries.values()
                          if not q.done.is_set())
            lines += [
                "# TYPE presto_tpu_queries_running gauge",
                f"presto_tpu_queries_running {running}",
                "# TYPE presto_tpu_rows_returned_total counter",
                f"presto_tpu_rows_returned_total {self.rows_returned_total}",
                "# TYPE presto_tpu_query_wall_ms_total counter",
                f"presto_tpu_query_wall_ms_total {self.query_wall_ms_total}",
            ]
            peak_q = self.peak_queued
        lines += self.latency_histo.prom_lines(
            "presto_tpu_query_latency_seconds")
        lines += self.stage_histo.prom_lines("presto_tpu_stage_wall_seconds")
        if executor is not None:
            # device-memory governor (exec/membudget.py): the resolved
            # budget plus the last attempt's peak
            lines += [
                "# TYPE presto_tpu_device_memory_budget_bytes gauge",
                f"presto_tpu_device_memory_budget_bytes "
                f"{executor._budget()}",
                "# TYPE presto_tpu_peak_device_bytes gauge",
                f"presto_tpu_peak_device_bytes "
                f"{executor.peak_memory_bytes}",
            ]
            # the registry IS the exposition list, so a counter added
            # to the engine cannot miss this surface; lifetime counters
            # keep their _total suffix. The process totals overlay the
            # bootstrap executor's: the transfer and wire tallies, and
            # the launch/batch sums (added) and widths (max) of the
            # concurrent path's discarded executors
            overlay = _overlay_totals()
            snap = CTRS.snapshot(executor)
            snap.update({k: int(v) for k, v in overlay.items()
                         if k in CTRS.QUERY_COUNTERS})
            with self._lock:
                totals = dict(self.exec_counter_totals)
            for name in self._EXEC_TOTAL_SUMS:
                snap[name] += totals.get(name, 0)
            for name in self._EXEC_TOTAL_MAX:
                snap[name] = max(snap[name], totals.get(name, 0))
            for name, (kind, _help) in CTRS.QUERY_COUNTERS.items():
                suffix = "_total" if kind == "counter" else ""
                lines += [f"# TYPE presto_tpu_{name}{suffix} {kind}",
                          f"presto_tpu_{name}{suffix} {snap[name]}"]
            lines += [
                "# TYPE presto_tpu_transfer_wall_seconds gauge",
                f"presto_tpu_transfer_wall_seconds "
                f"{overlay['transfer_wall_s']}",
            ]
        with self._lock:
            bypasses = self.cache_admission_bypasses
        lines += [
            "# TYPE presto_tpu_admission_cache_bypasses_total counter",
            f"presto_tpu_admission_cache_bypasses_total {bypasses}",
            "# TYPE presto_tpu_peak_queued gauge",
            f"presto_tpu_peak_queued {peak_q}"]
        return "\n".join(lines) + "\n"


_DECIMAL_RE = re.compile(r"decimal\((\d+),\s*(\d+)\)")


def _render_decimal(unscaled: int, scale: int) -> str:
    """Engine-internal unscaled int -> SQL decimal text (reference:
    server/protocol renders decimals scaled: 1529698.00, never the raw
    152969800)."""
    if scale == 0:
        return str(int(unscaled))
    u = int(unscaled)
    sign = "-" if u < 0 else ""
    u = abs(u)
    return f"{sign}{u // 10**scale}.{u % 10**scale:0{scale}d}"


def _json_row(row: tuple, types=None) -> list:
    """One result row as protocol JSON values: decimals as scaled text,
    dates and timestamps as ISO text, maps as objects, NULL as None."""
    out = []
    for j, v in enumerate(row):
        t = types[j] if types and j < len(types) else ""
        if v is None:
            out.append(None)
        elif isinstance(v, int) and not isinstance(v, bool) and t:
            m = _DECIMAL_RE.match(t)
            if m:
                out.append(_render_decimal(v, int(m.group(2))))
            elif t == "date":
                out.append(str(datetime.date(1970, 1, 1)
                               + datetime.timedelta(days=v)))
            elif t == "timestamp":
                out.append((datetime.datetime(1970, 1, 1)
                            + datetime.timedelta(microseconds=v)
                            ).isoformat(sep=" "))
            else:
                out.append(v)
        elif isinstance(v, (bool, int, float, str)):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            if t.startswith("map("):
                # maps serialize as JSON objects (reference: the
                # protocol renders MAP as {key: value})
                out.append({str(k): mv for k, mv in v})
            else:
                out.append(_json_value(v))
        else:
            out.append(str(v))
    return out


def _json_value(v):
    if isinstance(v, (tuple, list)):
        return [_json_value(x) for x in v]
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


def _session_snapshot(session: Session) -> Dict:
    """JSON-safe session state: user/catalog/schema plus the EXPLICITLY
    set properties — enough to reconstruct an equivalent Session."""
    return {
        "user": session.user,
        "catalog": session.catalog,
        "schema": session.schema,
        "values": {k: v for k, v in session._values.items()
                   if v is None or isinstance(v, (bool, int, float, str))},
    }


class _DcnServerRunner:
    """The serial path's runner when a worker fleet is configured:
    plain queries dispatch through the DcnRunner (the legacy cuts, the
    stage DAG, or a local run of a plan neither distributes), everything
    else — SET, DDL,
    SHOW, EXPLAIN, prepared statements — runs on the local engine. The
    DCN coordinator's root fragment executes on the SAME bootstrap
    runner, so sessions, traces and counters are one surface either
    way. Rows come back untyped (column types "unknown"), as in the
    reference: decimals stay unscaled integers on the wire."""

    def __init__(self, dcn, local):
        self._dcn = dcn
        self._local = local

    @property
    def session(self):
        return self._local.session

    @property
    def executor(self):
        return self._local.executor

    @property
    def last_trace(self):
        return self._local.last_trace

    def execute(self, sql: str):
        from presto_tpu_torch.runner import QueryResult
        from presto_tpu_torch.sql import ast_nodes as N
        from presto_tpu_torch.sql.parser import parse

        try:
            stmt = parse(sql)
        except Exception:  # noqa: BLE001 - not dispatchable: the local
            stmt = None    # path raises the proper error body
        if isinstance(stmt, N.Query):
            rows = self._dcn.execute(sql)
            return QueryResult(
                column_names=self._dcn.last_output_names or [], rows=rows)
        return self._local.execute(sql)


class _Handler(BaseHTTPRequestHandler):
    server_version = "presto-tpu/0.2"
    protocol_version = "HTTP/1.1"
    # no Nagle: a kept-alive client would wait out its delayed ACK
    # between a response's headers and its body (server/worker.py)
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # noqa: A003 - silence stderr
        pass

    @property
    def app(self) -> "PrestoTpuServer":
        return self.server.app  # type: ignore[attr-defined]

    def _send_json(self, obj, status=200, headers=None):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _session_from_headers(self) -> Session:
        """X-Presto-User / -Catalog / -Schema / -Session. A header key
        that names no property of the port is ignored, as the
        reference ignores unknown keys; a known property whose value is
        invalid raises here."""
        props = {}
        user = self.headers.get("X-Presto-User", "presto")
        access = self.app._runner.access_control
        for part in self.headers.get("X-Presto-Session", "").split(","):
            part = part.strip()
            if part and "=" in part:
                k, v = part.split("=", 1)
                if k.strip() in SYSTEM_SESSION_PROPERTIES:
                    # a header-carried property passes the choke point
                    # SET SESSION does (reference:
                    # checkCanSetSystemSessionProperty)
                    access.check_can_set_session(user, k.strip())
                    props[k.strip()] = v.strip()
        return Session(
            catalog=self.headers.get("X-Presto-Catalog"),
            properties=props,
            user=user,
            schema=self.headers.get("X-Presto-Schema", "default"),
        )

    def _maybe_task_plane(self, method: str) -> bool:
        """Serve /v1/task* from the embedded task runtime (coordinator
        and worker in one process). True when the request was handled."""
        rt = self.app.task_runtime
        if rt is None:
            return False
        split = urlparse(self.path)
        if not split.path.startswith("/v1/task"):
            return False
        from presto_tpu_torch.server import worker as W

        if method == "POST":
            n = int(self.headers.get("Content-Length", "0"))
            resp = W.route_task_post(rt, split.path,
                                     self.rfile.read(n) or b"{}")
        elif method == "GET":
            resp = W.route_task_get(rt, split.path, split.query)
        else:
            resp = W.route_task_delete(rt, split.path)
        if resp is None:
            return False
        W.write_task_response(self, resp)
        return True

    def _failed(self, e: BaseException, name: str, status: int) -> None:
        self._send_json({
            "error": {"message": str(e)[:2000], "errorName": name},
            "stats": {"state": "FAILED"},
        }, status)

    def do_POST(self):
        path = urlparse(self.path).path
        if self._maybe_task_plane("POST"):
            return
        if path != "/v1/statement":
            self._send_json({"error": "not found"}, 404)
            return
        length = int(self.headers.get("Content-Length", 0))
        sql = self.rfile.read(length).decode()
        from presto_tpu_torch.security import AccessDeniedError
        from presto_tpu_torch.server.resource_groups import (
            QueryQueueFullError,
        )

        try:
            session = self._session_from_headers()
        except AccessDeniedError as e:
            self._failed(e, "PERMISSION_DENIED", 403)
            return
        except ValueError as e:
            # a header property value the port rejects: a FAILED query
            # with an error body, never a dropped connection
            self._failed(e, type(e).__name__, 400)
            return
        try:
            # the tailing-cursor mode: stream_tail_enabled (a header
            # flag or SET SESSION) turns a query over an append-only
            # stream into a never-finishing cursor; a statement that
            # cannot tail falls through to the normal submit path
            if bool(session.get("stream_tail_enabled")):
                q = self.app.start_tail(sql, session)
                if q is not None:
                    self._send_json(self._tail_results(q, 0))
                    return
            q = self.app.manager.submit(sql, session)
        except QueryQueueFullError as e:
            self._failed(e, "QUERY_QUEUE_FULL", 429)
            return
        # brief wait so fast statements (SET SESSION, DDL) answer in one
        # round trip with their headers (reference: ~100ms initial wait)
        q.done.wait(timeout=0.5)
        self._send_json(self._results(q, 0), headers=self._set_headers(q))

    @staticmethod
    def _set_headers(q: _Query) -> Dict[str, str]:
        return {"X-Presto-Set-Session": f"{k}={v}"
                for k, v in q.set_session.items()}

    def do_GET(self):
        path = urlparse(self.path).path
        if self._maybe_task_plane("GET"):
            return
        parts = [p for p in path.split("/") if p]
        mgr = self.app.manager
        if parts[:2] == ["v1", "statement"] and len(parts) == 4:
            q = mgr.get(parts[2])
            if q is None:
                self._send_json({"error": "no such query"}, 404)
                return
            if q.tail is not None:
                # a tailing cursor: the poll IS the long-poll (it waits
                # on the append log, not on query completion)
                self._send_json(self._tail_results(q, int(parts[3])))
                return
            # long-poll up to ~1s for progress (reference client)
            q.done.wait(timeout=1.0)
            self._send_json(self._results(q, int(parts[3])),
                            headers=self._set_headers(q))
            return
        if parts == ["v1", "query"]:
            # every tracked query's BasicQueryInfo (live + finished)
            self._send_json([q.info() for q in sorted(
                mgr.queries(), key=lambda x: x.id)])
            return
        if parts[:2] == ["v1", "query"] and len(parts) == 3:
            # the QueryInfo/StageInfo/TaskInfo tree, served LIVE
            info = mgr.query_info(parts[2])
            if info is None:
                self._send_json({"error": "no such query"}, 404)
                return
            self._send_json(info)
            return
        if parts in (["v1", "info"], ["v1", "status"]):
            from presto_tpu_torch.obs import sanitizer as SAN

            info = {
                "nodeId": "presto-tpu-coordinator",
                "coordinator": True,
                "uptime": time.time() - self.app.started,
                "backend": self.app.backend_name,
                "device": self.app.device_name,
            }
            if SAN.is_armed():
                info["sanitizerViolations"] = SAN.violation_count()
            self._send_json(info)
            return
        if parts == ["v1", "resourceGroup"]:
            rg = mgr.resource_groups
            self._send_json(rg.snapshot() if rg else [])
            return
        if parts == ["v1", "node"]:
            # cluster members with health (reference: the
            # HeartbeatFailureDetector view)
            det = self.app.failure_detector
            self._send_json(det.snapshot() if det else [])
            return
        if parts == ["metrics"]:
            body = mgr.metrics_text(
                time.time() - self.app.started,
                executor=self.app._runner.executor).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self._send_json({"error": "not found"}, 404)

    def do_DELETE(self):
        if self._maybe_task_plane("DELETE"):
            return
        parts = [p for p in urlparse(self.path).path.split("/") if p]
        if parts[:2] == ["v1", "statement"] and len(parts) >= 3:
            q = self.app.manager.get(parts[2])
            ok = self.app.manager.cancel(parts[2])
            if q is not None and q.tail is not None:
                # stop tailing: wake blocked pollers; the final GET
                # serves the remaining rows with no nextUri
                q.tail.close()
            self._send_json({"cancelled": ok})
            return
        self._send_json({"error": "not found"}, 404)

    def _tail_results(self, q: _Query, token: int) -> Dict:
        """Protocol page of a tailing cursor: a fresh token first POLLS
        (long-polling the append log up to stream_poll_ms), then serves
        the rows the poll derived from new offsets; a known token
        re-serves its recorded span. nextUri persists until the cursor
        is cancelled or closed — an empty page with a fresh nextUri is
        the idle tail's heartbeat."""
        cur = q.tail
        base = f"http://{self.headers.get('Host', 'localhost')}"
        out: Dict = {
            "id": q.id,
            "infoUri": f"{base}/v1/query/{q.id}",
            "stats": {
                "state": q.state,
                "queued": False,
                "elapsedTimeMillis": q.info()["elapsedTimeMillis"],
                "tail": True,
            },
        }
        if token >= cur.spans_served() and not q.cancelled \
                and not cur.closed:
            cur.poll(cur.poll_ms / 1000.0)
        if cur.error is not None:
            q.error = cur.error
            q.state = "FAILED"
            q._finish_clock()
            q.done.set()
            out["stats"]["state"] = "FAILED"
            out["error"] = cur.error
            return out
        chunk = cur.take_span(token)
        if chunk is None:
            out["error"] = {"message": f"unknown result token {token}",
                            "errorName": "INVALID_TOKEN"}
            return out
        if cur.columns is not None:
            out["columns"] = cur.columns
        if chunk:
            out["data"] = chunk
        if (q.cancelled or cur.closed) and token + 1 >= cur.spans_served():
            out["stats"]["state"] = q.state
        else:
            out["nextUri"] = f"{base}/v1/statement/{q.id}/{token + 1}"
        return out

    def _results(self, q: _Query, token: int) -> Dict:
        base = f"http://{self.headers.get('Host', 'localhost')}"
        out: Dict = {
            "id": q.id,
            "infoUri": f"{base}/v1/query/{q.id}",
            "stats": {
                "state": q.state,
                "queued": q.state == "QUEUED",
                "elapsedTimeMillis": q.info()["elapsedTimeMillis"],
            },
        }
        if q.error is not None:
            out["error"] = q.error
            return out
        if not q.done.is_set():
            # still running: the client polls the same token
            out["nextUri"] = f"{base}/v1/statement/{q.id}/{token}"
            return out
        if q.columns is not None:
            out["columns"] = q.columns
        if q.update_type:
            out["updateType"] = q.update_type
        lo = token * _PAGE_ROWS
        hi = lo + _PAGE_ROWS
        chunk = q.rows[lo:hi]
        if chunk:
            out["data"] = chunk
        ckpt = q.checkpoint
        if hi < len(q.rows):
            out["nextUri"] = f"{base}/v1/statement/{q.id}/{token + 1}"
            if ckpt is not None:
                # the protocol-token barrier: this page is now in the
                # client's hands, so a restarted coordinator resumes AT
                # token + 1 after checking this page's digest
                from presto_tpu_torch.dist.checkpoint import page_digest

                ckpt.note_client_token(token + 1, page_digest(chunk))
        elif ckpt is not None:
            ckpt.delivered()  # the whole stream went out
        return out


class PrestoTpuServer:
    """Reference: server/PrestoServer.java + StatementResource wiring.
    ``device=None`` serves on the card and raises without one."""

    def __init__(
        self,
        catalogs,
        default_catalog: str = "tpch",
        port: int = 8080,
        mesh=None,
        page_rows: int = 1 << 18,
        event_listeners=(),
        peer_uris=(),
        plugins=(),
        resource_groups=None,
        memory_budget_bytes: Optional[int] = None,
        session_defaults=None,
        worker_tasks: bool = False,
        worker_uris=(),
        checkpoint_dir: str = "",
        device=None,
    ):
        import torch

        from presto_tpu_torch import resolve_device
        from presto_tpu_torch.runner import LocalRunner

        event_listeners = list(event_listeners)
        for p in plugins:
            event_listeners.extend(p.event_listeners())
        self.device = resolve_device(device)
        self.catalogs = dict(catalogs)
        self.port = port
        self.started = time.time()
        # /v1/info's backend: the executor's torch device
        self.backend_name = self.device.type
        self.device_name = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        # peer health monitoring (reference: HeartbeatFailureDetector
        # over discovered nodes; here the configured peers)
        self.failure_detector = None
        if peer_uris:
            from presto_tpu_torch.server.heartbeat import (
                HeartbeatFailureDetector,
            )

            self.failure_detector = HeartbeatFailureDetector(
                list(peer_uris))
        # the bootstrap runner serves the serial (no-arbiter) path,
        # installs the plugins into the catalogs and registries, and
        # carries the server-wide views, prepared statements and access
        # control
        self._runner = LocalRunner(self.catalogs, default_catalog,
                                   device=self.device, page_rows=page_rows,
                                   mesh=mesh, plugins=plugins)
        self.catalogs = self._runner.catalogs  # plugin catalogs, system
        self._page_rows = page_rows
        # a mesh makes every runner of this server a distributed one
        self._mesh = mesh
        self._default_catalog = default_catalog
        # a configured worker fleet makes this server a DCN coordinator:
        # plain queries on the serial path run through the stage DAG,
        # its root fragment on THE bootstrap runner
        self._dcn = None
        if worker_uris:
            from presto_tpu_torch.dist.dcn import DcnRunner

            self._dcn = DcnRunner(self.catalogs, list(worker_uris),
                                  default_catalog=default_catalog,
                                  session_props={"page_rows": page_rows},
                                  device=self.device)
            self._dcn.runner = self._runner
        # the durable coordinator journal: the checkpoint.dir etc key or
        # this argument (a bare checkpoint_dir session property binds
        # lazily in the manager at the first enabled submit)
        self._journal = None
        if checkpoint_dir:
            from presto_tpu_torch.dist.checkpoint import CheckpointJournal

            self._journal = CheckpointJournal(
                checkpoint_dir, counter_ex=self._runner.executor)
        memory_arbiter = None
        # cross-query launch batching: ONE shared batch point for the
        # concurrent path's per-query executors — attachment is what
        # "auto" resolves against, so the serial path never batches
        self._launch_batcher = None
        if memory_budget_bytes:
            from presto_tpu_torch.server.launch_batcher import LaunchBatcher

            memory_arbiter = MemoryArbiter(memory_budget_bytes)
            self._launch_batcher = LaunchBatcher()
        # fail-fast validation: a bad deployment default (unknown name,
        # rejected value) aborts startup instead of failing every query
        self.session_defaults = dict(session_defaults or {})
        Session(properties=self.session_defaults)

        def runner_factory(session: Session):
            # deployment-tier session defaults seed what the client did
            # not set (an explicit header or SET SESSION wins)
            for k, v in self.session_defaults.items():
                if not session.is_set(k):
                    session.set(k, v)
            # the server traces queries by default: /v1/query/{id} and
            # the stage-wall histogram read the lifecycle trace
            if not session.is_set("query_trace_enabled"):
                session.set("query_trace_enabled", True)
            if memory_arbiter is None:
                # serial path: one engine, re-sessioned per query
                self._runner.session = session
                if self._dcn is not None:
                    return _DcnServerRunner(self._dcn, self._runner)
                return self._runner
            # the concurrent path defaults the result cache ON: the
            # process-shared store is what collapses repeated statements
            # across per-query runners, and cache-aware admission needs
            # hits to bypass the queue. An explicit off wins
            if not session.is_set("result_cache_enabled"):
                session.set("result_cache_enabled", True)
            # concurrent path: a runner/executor per query, so query
            # state (overflow flags, capacity boosts, stream caches)
            # never crosses queries; views, prepared statements and
            # access control are server-wide (the prepared registry is
            # keyed per user)
            r = LocalRunner(self.catalogs, self._default_catalog,
                            device=self.device, page_rows=self._page_rows,
                            mesh=self._mesh)
            r.session = session
            r.executor.launch_batcher = self._launch_batcher
            r.views = self._runner.views
            r.prepared = self._runner.prepared
            r.access_control = self._runner.access_control
            r.apply_session()
            return r

        self.manager = QueryManager(
            runner_factory,
            listeners=event_listeners,
            resource_groups=resource_groups,
            memory_arbiter=memory_arbiter,
            listener_error_counter=self._runner.executor.count_listener_error,
            journal=self._journal,
            counter_executor=self._runner.executor,
            dcn=self._dcn,
        )
        if self._launch_batcher is not None:
            # gather only when there is someone to gang with: a lone
            # client on the concurrent path never pays the window
            mgr = self.manager

            def _running_queries() -> int:
                return sum(1 for q in mgr.queries() if q.state == "RUNNING")

            self._launch_batcher.concurrency_probe = _running_queries
        # coordinator and worker in one process: an embedded task
        # runtime serves the /v1/task control and fetch planes
        # (server/worker.route_task_*), so a stage-DAG scheduler can pool
        # this server like any worker
        self.task_runtime = None
        if worker_tasks:
            from presto_tpu_torch.server.worker import TaskRuntime

            self.task_runtime = TaskRuntime(
                self.catalogs, node_id="coordinator-worker",
                default_catalog=default_catalog, page_rows=page_rows,
                device=self.device)
        self._install_runtime_tables()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # crash re-attach: pick up every query a previous coordinator
        # journaled but never delivered, once per journal and process
        if self._journal is not None and self._journal.claim_reattach():
            self._reattach_pending()

    def _reattach_pending(self) -> None:
        """Register a _Query under its ORIGINAL id (the client's
        persisted nextUri names it) for every journaled in-flight query
        and recover each on a daemon thread (_reattach_run)."""
        from presto_tpu_torch.dist.checkpoint import QueryCheckpoint

        pending = self._journal.pending()
        mgr = self.manager
        for qid in sorted(pending):
            rec = pending[qid]
            sess = rec.get("session") or {}
            try:
                session = Session(
                    user=sess.get("user", "presto"),
                    catalog=sess.get("catalog") or self._default_catalog,
                    schema=sess.get("schema", "default"),
                    properties=sess.get("values") or None)
            except Exception:  # noqa: BLE001 - a persisted property the
                # port no longer accepts must not kill the pass: the
                # query recovers under a default session
                session = Session(catalog=self._default_catalog)
            q = _Query(qid, rec.get("sql") or "", session)
            q.state = "RUNNING"
            q.checkpoint = QueryCheckpoint(self._journal, qid)
            with mgr._lock:
                mgr._queries[qid] = q
            threading.Thread(target=self._reattach_run, args=(q, rec),
                             daemon=True).start()

    def _reattach_run(self, q: _Query, rec: Dict) -> None:
        """Recover one journaled query (dist/checkpoint.reattach_query)
        and verify every page the old process already handed the client
        against the regenerated rows. Any failure becomes a FAILED query
        at the client's nextUri (CoordinatorRestarted when the state
        was not recoverable), never a hang."""
        from presto_tpu_torch.dist import checkpoint as CKPT

        ckpt = q.checkpoint
        try:
            if rec.get("state") == "failed":
                # the query had already failed: the SAME error body at
                # the client's persisted nextUri
                q.error = rec.get("error") or {
                    "message": "query failed before the restart",
                    "errorName": "QueryFailed"}
                q.state = "FAILED"
                return
            # the recovery re-executes on the shared serial engine
            with self.manager._exec_lock:
                self._runner.session = q.session
                res = CKPT.reattach_query(rec, self._dcn,
                                          self._runner.executor)
            cols = rec.get("columns") or [
                {"name": n, "type": "unknown"} for n in res.column_names]
            types = [c["type"] for c in cols]
            rows = [_json_row(r, types) for r in res.rows]
            page_sha = rec.get("page_sha") or {}
            for i in range(int(rec.get("token") or 0)):
                want = page_sha.get(str(i))
                got = CKPT.page_digest(
                    rows[i * _PAGE_ROWS:(i + 1) * _PAGE_ROWS])
                if want is not None and got != want:
                    raise CKPT.CoordinatorRestarted(
                        f"resumed result stream diverges at page {i} "
                        "(digest mismatch with the delivered prefix)")
            q.columns = cols
            q.rows = rows
            q.state = "FINISHED"
            if ckpt is not None:
                ckpt.finished(cols, len(rows))
        except Exception as e:  # noqa: BLE001 - the loud-fail leg
            q.error = {
                "message": str(e)[:2000],
                "errorName": ("CoordinatorRestarted"
                              if isinstance(e, CKPT.CoordinatorRestarted)
                              else type(e).__name__)}
            q.state = "FAILED"
            if ckpt is not None:
                ckpt.failed(str(e), q.error["errorName"])
        finally:
            q._finish_clock()
            q.done.set()
            self.manager._record_completion(q)

    def _install_runtime_tables(self) -> None:
        """system.runtime_queries / runtime_tasks / nodes / metrics over
        live server state (reference: the system.runtime.* tables and
        the jmx connector's SQL over metrics)."""
        from presto_tpu_torch import types as T

        sys_conn = self.catalogs.get("system")
        if sys_conn is None or not hasattr(sys_conn, "register"):
            return
        V, B = T.VARCHAR, T.BIGINT
        mgr = self.manager

        def runtime_queries():
            out = []
            for q in mgr.queries():
                info = q.info()
                out.append((q.id, q.state, q.session.user, q.sql,
                            info["elapsedTimeMillis"], len(q.rows)))
            return sorted(out)

        def nodes():
            me = (f"http://127.0.0.1:{self.port}", "active", 1)
            peers = []
            fd = self.failure_detector
            if fd is not None:
                for info in fd.snapshot():
                    # the coordinator row's vocabulary: active / failed
                    alive = info.get("state") == "ALIVE"
                    peers.append((info.get("uri"),
                                  "active" if alive else "failed", 0))
            return [me] + sorted(peers)

        def metrics():
            from presto_tpu_torch.exec import counters as CTRS

            with mgr._lock:
                out = [("rows_returned_total", mgr.rows_returned_total),
                       ("query_wall_ms_total", mgr.query_wall_ms_total)]
                by_state = dict(mgr.completed_by_state)
                totals = dict(mgr.exec_counter_totals)
                bypasses = mgr.cache_admission_bypasses
                peak_q = mgr.peak_queued
            for state, n in sorted(by_state.items()):
                out.append((f"queries_completed_{state.lower()}", n))
            ex = self._runner.executor
            out.append(("device_memory_budget_bytes", ex._budget()))
            out.append(("peak_device_bytes", ex.peak_memory_bytes))
            # every registry counter, with /metrics' process overlay, so
            # the two surfaces cannot drift
            overlay = _overlay_totals()
            snap = CTRS.snapshot(ex)
            snap.update({k: int(v) for k, v in overlay.items()
                         if k in CTRS.QUERY_COUNTERS})
            for name in mgr._EXEC_TOTAL_SUMS:
                snap[name] += totals.get(name, 0)
            for name in mgr._EXEC_TOTAL_MAX:
                snap[name] = max(snap[name], totals.get(name, 0))
            out.extend(sorted(snap.items()))
            # system.metrics values are BIGINT: the crossing wall rides
            # as integer milliseconds
            out.append(("transfer_wall_ms",
                        int(overlay["transfer_wall_s"] * 1000)))
            out.append(("admission_cache_bypasses", bypasses))
            out.append(("peak_queued", peak_q))
            return out

        def runtime_tasks():
            # one row per stage task from the QueryInfo tree
            # /v1/query/{id} serves, so the two surfaces agree
            out = []
            for q in mgr.queries():
                info = mgr.query_info(q.id)
                if not info:
                    continue
                for stage in info.get("stages", ()):
                    for t in stage["tasks"]:
                        out.append((
                            q.id, str(stage["stageId"]), t["taskId"],
                            t["state"], t.get("uri") or "",
                            int(t["wallMs"]), int(t.get("rows") or 0),
                            int(t.get("retries") or 0)))
            return sorted(out)

        sys_conn.register(
            "runtime_queries",
            [("query_id", V), ("state", V), ("user", V), ("query", V),
             ("elapsed_ms", B), ("result_rows", B)], runtime_queries)
        sys_conn.register(
            "runtime_tasks",
            [("query_id", V), ("stage_id", V), ("task_id", V),
             ("state", V), ("uri", V), ("wall_ms", B), ("rows", B),
             ("retries", B)], runtime_tasks)
        sys_conn.register(
            "nodes", [("uri", V), ("state", V), ("is_coordinator", B)],
            nodes)
        sys_conn.register("metrics", [("name", V), ("value", B)], metrics)

    def start_tail(self, sql: str, session: Session) -> Optional[_Query]:
        """Register a tailing cursor for ``sql`` when it can tail: a
        plain query, on the local engine, scanning at least one
        append-only stream table. None otherwise — the statement then
        runs the normal protocol path (which also surfaces its parse,
        plan and access errors with the ordinary error body). A tailing
        statement passes the SAME resource-group gate as a submitted one
        (QueryQueueFullError is a 429); the slot releases when the
        cursor closes."""
        rg = self.manager.resource_groups
        group = rg.admit(session.user) if rg is not None else None
        cursor = self.make_tail_cursor(sql, session)
        if cursor is None:
            if group is not None:
                rg.cancel_queued(group)
            return None
        with cursor._cv:
            cursor.resource_group = group
        cursor._rg_manager = rg
        return self.manager.register_tail(sql, session, cursor)

    def make_tail_cursor(self, sql: str,
                         session: Session) -> Optional[TailCursor]:
        if self._mesh is not None:
            return None  # tail cursors ride the local executor
        # a cheap check before any planning: a deployment with no
        # append-only catalog never tails, so a session that left
        # stream_tail_enabled on pays no throwaway runner and no second
        # planning pass per ordinary statement
        if not any(getattr(c, "append_only", False)
                   for c in self.catalogs.values()):
            return None
        from presto_tpu_torch.cache.rules import scan_tables
        from presto_tpu_torch.runner import LocalRunner
        from presto_tpu_torch.sql import ast_nodes as N
        from presto_tpu_torch.sql.parser import parse

        try:
            stmt = parse(sql)
        except Exception:  # noqa: BLE001 - not tailable; the normal
            return None    # path surfaces the parse error properly
        if not isinstance(stmt, N.Query):
            return None  # DDL, SET, EXPLAIN, ... never tail
        # a dedicated runner (the concurrent path's shape): cursor polls
        # run on protocol handler threads and must never race the serial
        # bootstrap runner's queries
        r = LocalRunner(self.catalogs, self._default_catalog,
                        device=self.device, page_rows=self._page_rows)
        r.session = session
        r.views = self._runner.views
        r.prepared = self._runner.prepared
        r.access_control = self._runner.access_control
        try:
            r.access_control.check_can_execute_query(session.user, sql)
            r.apply_session()
            plan = r._plan_query(stmt)
        except Exception:  # noqa: BLE001 - not tailable; the normal
            return None    # path surfaces plan/access errors properly
        streams = [(c, t) for c, t in sorted(scan_tables(plan))
                   if getattr(r.catalogs.get(c), "append_only", False)]
        if not streams:
            return None  # nothing appends: a plain finite statement
        return TailCursor(r, plan, streams, sink=self._runner.executor)

    def start(self) -> int:
        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port),
                                          _Handler)
        self._httpd.app = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        if self.failure_detector:
            self.failure_detector.start()
        if self.task_runtime is not None:
            # same-process consumers take the embedded runtime's spooled
            # pages directly (server/worker's local registry)
            from presto_tpu_torch.server.worker import (
                register_local_runtime,
            )

            register_local_runtime(f"http://127.0.0.1:{self.port}",
                                   self.task_runtime)
        return self.port

    def stop(self) -> None:
        if self.task_runtime is not None:
            from presto_tpu_torch.server.worker import (
                unregister_local_runtime,
            )

            unregister_local_runtime(f"http://127.0.0.1:{self.port}")
            self.task_runtime.free_all()
        if self.failure_detector:
            self.failure_detector.stop()
        if self._dcn is not None:
            self._dcn.close()  # its heartbeat detector's thread
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()

    def serve_forever(self) -> None:  # pragma: no cover - CLI entry
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.stop()


def main(argv=None) -> int:  # pragma: no cover - subprocess entry
    """Coordinator process entry: boots a PrestoTpuServer (over a worker
    fleet when --workers is given, with a durable journal when
    --checkpoint-dir is given: a successor booted on the same directory
    re-attaches the queries this process left), prints its port as one
    JSON line, then serves until interrupted."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--suite", default="tpch")
    parser.add_argument("--scale", type=float, default=0.01)
    parser.add_argument("--page-rows", type=int, default=1 << 16)
    parser.add_argument("--workers", default="",
                        help="comma-separated worker base uris")
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    if args.suite == "tpch":
        from presto_tpu_torch.connectors.tpch import TpchConnector as cls
    else:
        from presto_tpu_torch.connectors.tpcds import TpcdsConnector as cls
    srv = PrestoTpuServer(
        {args.suite: cls(args.scale, device=args.device)}, port=args.port,
        default_catalog=args.suite, page_rows=args.page_rows,
        worker_uris=[u for u in args.workers.split(",") if u],
        checkpoint_dir=args.checkpoint_dir, device=args.device,
    )
    if srv.device.type == "cuda":
        from presto_tpu_torch import cuda

        cuda.load_all()
    port = srv.start()
    print(json.dumps({"port": port}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
