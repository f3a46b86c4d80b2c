"""The query-lifecycle observability package.

Port of presto_tpu/obs/ (reference: presto-main's stats plane — the
QueryInfo/StageInfo/TaskInfo trees, OperatorStats feeding them, and the
QueryMonitor building EventListener payloads):

  trace.py      the span recorder: query -> stage -> task -> attempt ->
                operator spans on ONE monotonic clock with ONE wall
                anchor per query, exported as a QueryInfo tree, a
                Chrome-trace (Perfetto-loadable) JSON file, and a
                critical-path summary.
  profile.py    the persisted observed-stats profile store keyed by
                (canonical plan fingerprint, connector snapshot): the
                settled capacity bucket and observed cardinalities.
  sanitizer.py  the runtime lock sanitizer and the port's concurrency
                registry.

SPAN_KINDS is the span analog of exec/counters.QUERY_COUNTERS: every
span kind the port emits is declared here, and
tests/test_torch_obs.py fails when an emission site uses an undeclared
kind or a declared kind has no emission site.

Tracing stays off the device path: spans are recorded at page, attempt
and stage boundaries by host control code only, never inside a captured
CUDA graph, and with tracing off the only cost is one ``is None`` check
per page loop (the ``trace_spans`` counter pins that at zero).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from presto_tpu_torch.obs.trace import QueryTrace, critical_path  # noqa: F401

# span kind -> help text (the declaration is the contract the tests
# enforce, like QUERY_COUNTERS' help column)
SPAN_KINDS: Dict[str, str] = {
    "query": "the whole query: wall anchor + every child span",
    "execute": "one local executor run of a plan (the overflow "
               "ladder's loop; the coordinator's root fragment and every "
               "LocalRunner query get one)",
    "attempt": "one overflow-ladder attempt (attrs: capacity boost; "
               "a query with N-1 boosted retries has N of these)",
    "operator": "per-plan-node wall/rows/pages from the EXPLAIN "
                "ANALYZE accounting, anchored at its attempt's start",
    "stage": "one stage-DAG wave dispatched by dist/scheduler.py",
    "task": "one logical task of a stage (coordinator view; attrs: "
            "uri, pages; worker-side spans nest inside)",
    "dispatch": "one task-submit POST to a worker",
    "queue": "worker-side: task created -> fragment execution started",
    "run": "worker-side: fragment execution (attrs: pages, spooled)",
    "fetch": "coordinator-side page drain of one task's results",
    "retry": "one task re-dispatch (attrs: to uri, attempt, cause, "
             "replay) — the fault-tolerance paths' trace annotation",
    "speculate": "one straggler-speculation copy dispatched (attrs: "
                 "uri); win/loss lands on the task span",
    "replan": "one adaptive re-plan evaluated at a stage boundary "
              "(adaptive/): attrs carry the flip/seed/skew-hint "
              "counts, or rejected=true with the verify_dag reason "
              "when the mutation rolled back",
    "cache": "one result-cache point served (presto_tpu_torch/cache/): "
             "hit:<Node> replays stored pages (attrs: pages, key) in "
             "the span's interval, with no capture and no launch; "
             "miss:<Node> marks the lookup, the real execution follows "
             "as ordinary attempt/operator spans; subsume:<Node> a "
             "residual filter over a wider cached sibling; "
             "remote-hit:<task> a leaf task a worker's cache served",
    "checkpoint": "one durable coordinator-journal publish "
                  "(dist/checkpoint.py): attrs carry the record state "
                  "and serialized bytes, the barrier-write cost beside "
                  "the stage wall it rides on",
    "xfer": "one metered host<->device crossing (exec/xfer.py choke "
            "points): d2h:<label> pulls pages/arrays to host (spill, "
            "exchange serialization, result decode), h2d:<label> "
            "stages host arrays onto the device (page build, "
            "restream, remote-source ingest); attrs carry bytes, and "
            "the summed span wall equals the query's transfer_wall_s "
            "counter",
}


def maybe_trace(session, query_id: Optional[str] = None,
                sql: Optional[str] = None) -> Optional[QueryTrace]:
    """A QueryTrace when the session enables tracing, else None (the
    near-zero-cost off switch: every recording site guards on the
    executor's ``trace is None``)."""
    if not (bool(session.get("query_trace_enabled"))
            or session.get("query_trace_dir")):
        return None
    if query_id is None:
        import uuid

        query_id = f"q-{uuid.uuid4().hex[:12]}"
    return QueryTrace(query_id, sql=sql)


def attach(executor, trace: QueryTrace) -> None:
    """Hand a trace to an executor for the next query; resets the
    per-query ``trace_spans`` counter."""
    executor.trace = trace
    executor.trace_spans = 0


def finalize(executor, trace: QueryTrace,
             trace_dir: Optional[str] = None) -> None:
    """End the root span, write the Chrome-trace file when a directory
    is configured (session property ``query_trace_dir``), detach, and
    settle the span-count counter. The file write degrades gracefully:
    finalize runs inside callers' finally blocks, so an unwritable trace
    directory must neither fail a successful query nor mask an error in
    flight."""
    trace.finish()
    executor.trace = None
    executor.trace_spans = trace.span_count
    if trace_dir:
        try:
            os.makedirs(trace_dir, exist_ok=True)
            trace.write_chrome(
                os.path.join(trace_dir, f"{trace.query_id}.trace.json"))
        except OSError:
            pass  # observability must never fail the query
