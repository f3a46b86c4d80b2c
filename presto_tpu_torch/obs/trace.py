"""Span recorder for one query's lifecycle.

Port of presto_tpu/obs/trace.py (reference: presto-main's
QueryInfo/StageInfo/TaskInfo tree, assembled live by the query and
stage state machines, and the QueryMonitor that flattens it).

Timing model: every span interval is measured on ``time.monotonic()``
as an offset from the trace's creation instant, and the trace carries
exactly ONE wall-clock anchor (``anchor_wall``, taken once at
creation). Cross-node ingestion never subtracts two machines' wall
clocks: worker spans arrive as offsets from the worker's own
task-creation instant and are re-based into the coordinator's task-span
window, clamped to it, so clock skew can shift a remote span inside its
parent but never make a duration negative or a child escape its parent.

The recorder is deliberately dumb: an append-only span list, explicit
parent links, one lock. All structure (QueryInfo tree, Chrome trace,
critical path) is derived at read time, so recording at page, attempt
and stage boundaries stays O(1). Nothing here runs inside a captured
CUDA graph: spans are recorded by host code between programs only.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional

from presto_tpu_torch.obs.sanitizer import make_lock, register_owner


@dataclasses.dataclass
class Span:
    """One interval. t0/t1 are seconds since the trace's monotonic
    anchor; t1 is None while the span is open."""

    span_id: int
    parent_id: Optional[int]
    kind: str
    name: str
    t0: float
    t1: Optional[float] = None
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    def dur(self, now: float = 0.0) -> float:
        end = self.t1 if self.t1 is not None else now
        return max(end - self.t0, 0.0)


class QueryTrace:
    """One query's span tree. Thread-safe (worker status polls and the
    scheduler's dispatch loop record concurrently); reads snapshot."""

    # lock discipline: the span list and its sequence counter are the
    # shared recording surface
    _shared_attrs = ("_spans", "_seq")

    def __init__(self, query_id: str, sql: Optional[str] = None,
                 anchor_mono: Optional[float] = None,
                 anchor_wall: Optional[float] = None):
        self.query_id = query_id
        # THE one wall-clock read per query (display/correlation only;
        # never used in interval arithmetic)
        self.anchor_wall = (time.time() if anchor_wall is None
                            else anchor_wall)
        self._anchor_mono = (time.monotonic() if anchor_mono is None
                             else anchor_mono)
        self._lock = make_lock("obs.trace.QueryTrace._lock")
        self._spans: List[Span] = []
        self._seq = 0
        # host seconds write_chrome took (after the root span's end)
        self.write_s = 0.0
        attrs = {"sql": sql} if sql else {}
        self.root = self._new("query", query_id, None, 0.0, None, attrs)
        register_owner(self)

    # ------------------------------------------------------- recording
    def now(self) -> float:
        return time.monotonic() - self._anchor_mono

    def _new(self, kind, name, parent, t0, t1, attrs) -> Span:
        with self._lock:
            self._seq += 1
            sp = Span(self._seq, parent, kind, name, t0, t1,
                      dict(attrs))
            self._spans.append(sp)
            return sp

    def begin(self, kind: str, name: str,
              parent: Optional[Span] = None, **attrs) -> Span:
        pid = (parent or self.root).span_id
        return self._new(kind, name, pid, self.now(), None, attrs)

    def end(self, span: Span, **attrs) -> Span:
        with self._lock:
            if span.t1 is None:
                span.t1 = time.monotonic() - self._anchor_mono
            span.attrs.update(attrs)
        return span

    def complete(self, kind: str, name: str, t0: float, t1: float,
                 parent: Optional[Span] = None, **attrs) -> Span:
        return self._new(kind, name, (parent or self.root).span_id,
                         t0, max(t1, t0), attrs)

    def ingest(self, remote: List[dict], parent: Span,
               lo: float, hi: float) -> int:
        """Nest worker-shipped spans (offsets from the worker's task
        creation) under a coordinator span, re-based at `lo` and
        CLAMPED to [lo, hi] — the skew guard: a remote interval can
        never go negative or escape its coordinator-side window."""
        n = 0
        for d in remote:
            try:
                t0 = min(max(lo + float(d["t0"]), lo), hi)
                t1 = min(max(lo + float(d["t1"]), t0), hi)
                self._new(str(d["kind"]), str(d.get("name", "")),
                          parent.span_id, t0, t1,
                          dict(d.get("attrs") or {}))
                n += 1
            except (KeyError, TypeError, ValueError):
                continue  # a malformed remote span is dropped, not fatal
        return n

    def finish(self) -> None:
        self.end(self.root)
        # close any straggler open spans at the root's end (a failed
        # query abandons its in-flight task spans)
        with self._lock:
            for sp in self._spans:
                if sp.t1 is None:
                    sp.t1 = self.root.t1

    # ----------------------------------------------------------- reads
    @property
    def span_count(self) -> int:
        with self._lock:
            return len(self._spans)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def export(self) -> List[dict]:
        """Wire form for shipping to a coordinator (worker status
        plane): non-root spans as plain dicts of anchored offsets."""
        out = []
        now = self.now()
        for sp in self.spans():
            if sp.span_id == self.root.span_id:
                continue
            out.append({
                "kind": sp.kind, "name": sp.name, "t0": sp.t0,
                "t1": sp.t1 if sp.t1 is not None else now,
                "attrs": sp.attrs,
            })
        return out

    # ------------------------------------------------- QueryInfo tree
    def to_info(self) -> dict:
        """The QueryInfo/StageInfo/TaskInfo tree (reference:
        /v1/query/{id}'s JSON). Stage-DAG queries render their real
        stages; local executions synthesize one stage ("local") whose
        single task holds the attempt/operator spans — every query
        shape serves the same tree."""
        spans = self.spans()
        now = self.now()
        children: Dict[int, List[Span]] = {}
        for sp in spans:
            if sp.parent_id is not None:
                children.setdefault(sp.parent_id, []).append(sp)

        def ms(t: float) -> int:
            return int(round(t * 1000))

        def descend(sp: Span) -> List[dict]:
            out = []
            for c in sorted(children.get(sp.span_id, ()),
                            key=lambda s: (s.t0, s.span_id)):
                out.append({
                    "kind": c.kind, "name": c.name,
                    "startMs": ms(c.t0),
                    "endMs": ms(c.t1 if c.t1 is not None else now),
                    "attrs": c.attrs,
                })
                out.extend(descend(c))
            return out

        def task_info(sp: Span, task_id: str) -> dict:
            return {
                "taskId": task_id,
                "uri": sp.attrs.get("uri"),
                "state": ("RUNNING" if sp.t1 is None else
                          str(sp.attrs.get("state", "FINISHED"))),
                "startMs": ms(sp.t0),
                "endMs": ms(sp.t1 if sp.t1 is not None else now),
                "wallMs": ms(sp.dur(now)),
                "rows": sp.attrs.get("rows"),
                "pages": sp.attrs.get("pages"),
                "retries": sp.attrs.get("retries", 0),
                "spans": descend(sp),
            }

        stages = []
        for sp in sorted((s for s in spans if s.kind == "stage"),
                         key=lambda s: (s.t0, s.span_id)):
            tasks = [task_info(c, c.name)
                     for c in children.get(sp.span_id, ())
                     if c.kind == "task"]
            stages.append({
                "stageId": sp.name,
                "state": "RUNNING" if sp.t1 is None else "FINISHED",
                "startMs": ms(sp.t0),
                "endMs": ms(sp.t1 if sp.t1 is not None else now),
                "wallMs": ms(sp.dur(now)),
                "tasks": tasks,
            })
        if not stages:
            # local execution: one synthetic stage per executor run
            execs = [s for s in spans if s.kind == "execute"]
            tasks = [task_info(sp, f"local.{i}")
                     for i, sp in enumerate(execs)]
            if tasks:
                stages = [{
                    "stageId": "local",
                    "state": ("RUNNING" if any(s.t1 is None
                                               for s in execs)
                              else "FINISHED"),
                    "startMs": ms(min(s.t0 for s in execs)),
                    "endMs": ms(max(s.t1 if s.t1 is not None else now
                                    for s in execs)),
                    "wallMs": ms(max(s.dur(now) for s in execs)),
                    "tasks": tasks,
                }]
        return {
            "queryId": self.query_id,
            "createTime": self.anchor_wall,
            "elapsedMs": ms(self.root.dur(now)),
            "spanCount": len(spans),
            "stages": stages,
        }

    # ------------------------------------------------- Chrome export
    def to_chrome(self) -> dict:
        """Chrome-trace (Perfetto-loadable) JSON: complete (`X`)
        events in microseconds since the query's wall anchor, sorted
        by ts, one tid lane per stage/task/execute container."""
        spans = self.spans()
        now = self.now()
        lane_of: Dict[int, int] = {self.root.span_id: 0}
        by_id = {sp.span_id: sp for sp in spans}
        next_lane = [0]

        def lane(sp: Span) -> int:
            if sp.span_id in lane_of:
                return lane_of[sp.span_id]
            if sp.kind in ("stage", "task", "execute"):
                next_lane[0] += 1
                lane_of[sp.span_id] = next_lane[0]
                return next_lane[0]
            parent = by_id.get(sp.parent_id)
            lane_of[sp.span_id] = lane(parent) if parent else 0
            return lane_of[sp.span_id]

        events = []
        for sp in spans:
            end = sp.t1 if sp.t1 is not None else now
            args = {k: v for k, v in sp.attrs.items() if v is not None}
            events.append({
                "name": f"{sp.kind}:{sp.name}",
                "cat": sp.kind,
                "ph": "X",
                "ts": int(round(sp.t0 * 1e6)),
                "dur": int(round(max(end - sp.t0, 0.0) * 1e6)),
                "pid": 1,
                "tid": lane(sp),
                "args": args,
            })
        events.sort(key=lambda e: (e["ts"], e["tid"]))
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "queryId": self.query_id,
                "wallAnchorUnixS": self.anchor_wall,
            },
        }

    def write_chrome(self, path: str) -> str:
        t0 = time.monotonic()
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1, default=str)
        self.write_s = time.monotonic() - t0
        return path


def critical_path(trace: QueryTrace) -> dict:
    """The slowest chain through the span tree plus a per-kind wall
    split (queue-vs-run-vs-fetch for distributed queries; attempt/
    operator locally) — the summary chip_smoke.py prints."""
    spans = trace.spans()
    now = trace.now()
    children: Dict[int, List[Span]] = {}
    for sp in spans:
        if sp.parent_id is not None:
            children.setdefault(sp.parent_id, []).append(sp)
    chain, cur = [], trace.root
    while True:
        kids = children.get(cur.span_id)
        if not kids:
            break
        cur = max(kids, key=lambda s: s.dur(now))
        chain.append({
            "kind": cur.kind, "name": cur.name,
            "ms": int(round(cur.dur(now) * 1000)),
        })
    by_kind: Dict[str, float] = {}
    for sp in spans:
        if sp.span_id == trace.root.span_id:
            continue
        by_kind[sp.kind] = by_kind.get(sp.kind, 0.0) + sp.dur(now)
    return {
        "chain": chain,
        "by_kind_ms": {k: int(round(v * 1000))
                       for k, v in sorted(by_kind.items())},
    }
