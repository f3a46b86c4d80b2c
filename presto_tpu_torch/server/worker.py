"""Worker: the /v1/task control plane + the spooled-exchange data plane.

Port of presto_tpu/server/worker.py (reference: presto-main
server/TaskResource.java — task create/status/cancel —,
execution/SqlTaskManager.java — task registry + execution — and
execution/buffer/OutputBuffer consumed by HttpPageBufferClient with
at-least-once + token-dedupe semantics), with the cut analysis of the
legacy distributed shapes (find_partial_cut, find_union_cut,
hash_fanout_plan, hash_fanout_source) that dist/dcn.py runs.

A task carries a SERIALIZED physical-plan fragment (dist/plan_serde.py)
plus either a split assignment (a leaf fragment scans its round-robin
share of ``splitTable``, or with ``splitMode: "hash"`` the rows of each
table in ``partitionColumns`` whose key hashes to it —
HashSplitConnector) or ``sources`` (RemoteSource suppliers reading
upstream tasks' spools), or both. A legacy cut's task (no
``outputPartitions``) buffers its output as serialized host pages in a
token-acked list. A stage-DAG task's output is partitioned by
hash(``outputKeys``) % ``outputPartitions`` and SPOOLED (_TaskSpool):

  - the device tier (``device_exchange_enabled``, on by default on the
    card) partitions on the device (dist/spool.device_partition_pages)
    and spools the partition Pages themselves; wire bytes serialize
    lazily, only when an HTTP fetch asks for them;
  - the host tier partitions a host copy and spools serialized blobs;
  - under ``meshExchange`` (the ICI plane, dist/scheduler.py) the task
    spools its RAW pages to one partition, and the coordinator's
    all_to_all partitions them after the stage barrier into a
    synthetic finished task (``TaskRuntime.register_finished_task``).

Both tiers share one resident-byte budget per task
(``spool_exchange_bytes``): past it, pages serialize into disk-tier
PageStore files. Either output is published only after the fragment's
attempt completes overflow-free (Executor.stream_fragment: an
overflow re-runs the fragment boosted, a persistent one fails the task
loudly), and is freed on DELETE and on task expiry.

Routes: ``POST /v1/task`` (create), ``GET /v1/task/{id}`` (status:
state, the spool's per-partition rows, bytes and wire bytes, the
task's boost retries and pre-engaged skew passes), ``GET
/v1/task/{id}/results/{token}?part=p&max=N`` (token-indexed long-poll
fetch of one partition, consecutive frames packed up to N bytes),
``DELETE /v1/task/{id}/spool/{p}`` (ack one partition), ``DELETE
/v1/task/{id}`` (release the task), ``POST /v1/fault`` (the runtime
fault overlay) and ``GET /v1/info`` (the heartbeat's ping).

Fault injection at the page proxy: FAULT_DELAY_MS delays every results
fetch; FAULT_DROP_EVERY=n answers HTTP 500 on every nth fetch;
FAULT_KILL_AFTER_FETCHES=n kills the worker once n result fetches have
been served (a TaskRuntime serving its own process, as the HTTP
server's embedded one does, hard-exits; a WorkerServer, which shares its
process with others, stops); FAULT_SUBMIT_DROP_EVERY=n
answers HTTP 500 on every nth task submit; FAULT_TASK_EXEC_DELAY_MS
stalls task EXECUTION (a deterministic straggler for speculation);
FAULT_SPOOL_CORRUPT_EVERY=n flips one byte inside every nth served page
body. Each knob reads the config posted to ``POST /v1/fault`` as an
OVERLAY on the environment: posted keys win (an explicit 0 disables an
environment fault), absent keys fall back to the environment, and
``{}`` restores the environment's rule. A task whose upstream fetch
failed fails with a ``[source-lost <uri> <task>]`` marker
(dist/spool.SourceLost) that the scheduler reads to replay the
upstream placements first.

Threads and the card: each task runs in its own thread and HTTP handler
threads serve fetches; every tensor op stays on the default stream, so
a spooled Page handed to a consumer in another thread (the mesh-local
read, dist/spool.local_source_pages) is ordered after the work that
produced it.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch import obs as OBS
from presto_tpu_torch import resolve_device
from presto_tpu_torch.connectors.split_filter import (
    HashSplitConnector,
    SplitFilterConnector,
)
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec import shapes as SH
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.exec.pagestore import PageStore, page_bytes
from presto_tpu_torch.obs.sanitizer import make_lock
from presto_tpu_torch.page import Page


class _PartitionSpool:
    """One partition's spooled output: host-tier PageStore blobs while
    the task's resident budget lasts, a disk-tier PageStore past it,
    and — on the device tier — lazy entries holding the partition Page
    itself. Entries are (store, index) for blobs and ("page", Page) for
    lazy ones."""

    def __init__(self, spill_dir: Optional[str] = None):
        self._host = PageStore(tier="host")
        self._disk: Optional[PageStore] = None
        self._spill_dir = spill_dir
        self.entries: List = []
        self.released = False
        # the spool-stats plane: exact rows, bytes and wire bytes
        # published into this partition, accumulated at put time and
        # kept past release, so the coordinator's re-planner reads
        # stable numbers and a replayed task re-accumulates identical
        # ones. Lazy device pages count their footprint as wire bytes
        # (an upper bound: freight costing never under-counts)
        self.stat_rows = 0
        self.stat_bytes = 0
        self.stat_wire_bytes = 0

    def put(self, blob: bytes, to_disk: bool, rows: int = 0) -> None:
        if to_disk:
            if self._disk is None:
                self._disk = PageStore(tier="disk",
                                       spill_dir=self._spill_dir)
            store = self._disk
        else:
            store = self._host
        store.put_bytes(blob)
        self.entries.append((store, store.page_count - 1))
        self.stat_rows += int(rows)
        self.stat_bytes += len(blob)
        self.stat_wire_bytes += len(blob)

    def put_page(self, page, est_bytes: int, rows: int = 0) -> None:
        """Spool one partition Page WITHOUT serializing (device tier);
        ``est_bytes`` is its footprint."""
        self.entries.append(("page", page))
        self.stat_rows += int(rows)
        self.stat_bytes += int(est_bytes)
        self.stat_wire_bytes += int(est_bytes)

    @property
    def count(self) -> int:
        return len(self.entries)

    def close(self) -> None:
        self._host.close()
        if self._disk is not None:
            self._disk.close()
        self.entries = []  # drops lazy Page refs -> frees device memory
        self.released = True


class _TaskSpool:
    """A task's partitioned output spool: P token-indexed partition
    buffers sharing one resident-byte budget (spool_exchange_bytes;
    0 = unbounded) — pages past it go to the disk tier."""

    def __init__(self, nparts: int, host_budget: int,
                 spill_dir: Optional[str] = None):
        self.parts = [_PartitionSpool(spill_dir)
                      for _ in range(max(nparts, 1))]
        self.host_budget = host_budget
        self.host_bytes = 0

    def _over_budget(self, nbytes: int) -> bool:
        return self.host_budget > 0 and \
            self.host_bytes + nbytes > self.host_budget

    def put(self, p: int, blob: bytes, rows: int = 0) -> None:
        to_disk = self._over_budget(len(blob))
        if not to_disk:
            self.host_bytes += len(blob)
        self.parts[p].put(blob, to_disk, rows=rows)

    def put_page(self, p: int, page, rows: int = 0) -> None:
        """Device tier: spool the partition Page itself, unless the
        resident budget is spent — then it serializes now and rides the
        blob tiers (to disk)."""
        est = page_bytes(page)
        if self._over_budget(est):
            from presto_tpu_torch.dist import spool as SPOOL

            self.put(p, SPOOL.spool_blob(page), rows=rows)
            return
        self.host_bytes += est
        self.parts[p].put_page(page, est, rows=rows)

    @property
    def page_count(self) -> int:
        return sum(p.count for p in self.parts)

    def part_stats(self) -> Tuple[List[int], List[int], List[int]]:
        """(rows, bytes, wire bytes) per partition: the stage-boundary
        statistics the adaptive re-planner sums on the coordinator.
        Exact and monotone, stable across release, identical after a
        deterministic replay."""
        return ([p.stat_rows for p in self.parts],
                [p.stat_bytes for p in self.parts],
                [p.stat_wire_bytes for p in self.parts])

    def release(self, p: int) -> bool:
        if 0 <= p < len(self.parts):
            self.parts[p].close()
            return True
        return False

    def close(self) -> None:
        for p in self.parts:
            p.close()


# --------------------------------------------------------------------
# Same-process placement registry: uri -> TaskRuntime for every worker
# served from THIS process. The mesh-local exchange path (dist/spool.
# local_source_pages, the scheduler's root drain) looks placements up
# here and takes spooled Pages directly; a placement missing from it
# falls back to HTTP.
_runtimes_lock = make_lock("server.worker._runtimes_lock")
_LOCAL_RUNTIMES: Dict[str, "TaskRuntime"] = {}


def register_local_runtime(uri: str, rt: "TaskRuntime") -> None:
    with _runtimes_lock:
        _LOCAL_RUNTIMES[uri] = rt


def unregister_local_runtime(uri: str) -> None:
    with _runtimes_lock:
        _LOCAL_RUNTIMES.pop(uri, None)


def local_runtime(uri: str) -> Optional["TaskRuntime"]:
    with _runtimes_lock:
        return _LOCAL_RUNTIMES.get(uri)


class _Task:
    """One task's lifecycle flags and spool, shared between its
    execution thread and the fetch/status/cancel handlers under
    ``lock``."""

    def __init__(self, task_id: str):
        self.task_id = task_id
        # a legacy-cut task's output: serialized host pages, published
        # at once after an overflow-free attempt (partition 0 only)
        self.pages: List[bytes] = []
        self.spool: Optional[_TaskSpool] = None
        self.done = False
        self.error: Optional[str] = None
        self.cancelled = False
        # executor outcomes shipped on the status plane: overflow-ladder
        # re-entries and passes started in the skew rebalance
        self.boost_retries = 0
        self.skew_preempted = 0
        self.lock = make_lock("server.worker._Task.lock")
        # the worker-side trace's anchors (task creation) and its
        # exported spans, shipped to a tracing coordinator on the
        # status plane
        self.created_mono = time.monotonic()
        self.created_wall = time.time()
        self.spans: Optional[List[Dict]] = None

    def part_count(self, part: int) -> int:
        if self.spool is None:
            return len(self.pages) if part == 0 else 0
        if part >= len(self.spool.parts):
            return 0
        return self.spool.parts[part].count

    def part_entry(self, part: int, token: int):
        """Spool entry ``token`` of partition ``part`` (a legacy task's
        buffered blob is its own entry)."""
        if self.spool is None:
            return ("blob", self.pages[token])
        return self.spool.parts[part].entries[token]

    def part_released(self, part: int) -> bool:
        return (self.spool is not None
                and 0 <= part < len(self.spool.parts)
                and self.spool.parts[part].released)

    def free(self) -> None:
        self.pages.clear()
        if self.spool is not None:
            self.spool.close()


# ---------------------------------------------------------------------
# Cut analysis of the legacy distributed shapes (dist/dcn.py execute):
# pure plan walks, the reference's rules.

def find_partial_cut(plan: P.PhysicalNode) -> Optional[P.Aggregation]:
    """The topmost single-step aggregation — the PARTIAL/FINAL split
    point for the DCN boundary (reference: AddExchanges splitting
    AggregationNode into PARTIAL below / FINAL above the exchange)."""
    if isinstance(plan, P.Aggregation) and plan.step == "single":
        return plan
    for c in plan.children():
        hit = find_partial_cut(c)
        if hit is not None:
            return hit
    return None


def row_local_scan_count(node: P.PhysicalNode,
                         split_table: str) -> Optional[int]:
    """How many times ``split_table`` is scanned under ``node``, or None
    when the subtree is not ROW-LOCAL — when the multiset of its output
    rows is NOT the disjoint union of the outputs over a row-partition
    of split_table (all other tables replicated).

    Row-local shapes: Filter / Project / Exchange / TableScan / INNER
    hash joins. Inner joins distribute over a partition of any single
    table (each result row maps to exactly one row of it); outer, semi,
    anti and cross joins, aggregations, sorts, limits, windows and
    MarkDistinct do not (a MarkDistinct would mark first occurrences
    per worker and double-count values spanning workers)."""
    if isinstance(node, P.TableScan):
        return 1 if node.table == split_table else 0
    if isinstance(node, (P.Filter, P.Project, P.Exchange)):
        return row_local_scan_count(node.source, split_table)
    if isinstance(node, P.HashJoin):
        if node.join_type != "inner":
            return None
        left = row_local_scan_count(node.left, split_table)
        right = row_local_scan_count(node.right, split_table)
        if left is None or right is None:
            return None
        return left + right
    return None


def fanout_safe(cut: P.Aggregation, split_table: str) -> bool:
    """Whether the PARTIAL subtree distributes over a round-robin
    partition of split_table's rows: decomposable aggregates with no
    DISTINCT masks, and a row-local source with exactly ONE scan of the
    split table. Other shapes take the union cut or run locally."""
    if any(s.mask is not None for s in cut.aggregates):
        return False
    return row_local_scan_count(cut.source, split_table) == 1


def find_union_cut(plan: P.PhysicalNode,
                   split_table: str) -> Optional[P.PhysicalNode]:
    """The TOPMOST row-local subtree scanning split_table exactly once —
    the distribution shape for plans with no decomposable aggregation
    cut (reference: a SOURCE_DISTRIBUTION leaf fragment under a GATHER
    exchange). Workers execute the subtree over their split share; the
    coordinator replaces it with a RemoteSource and runs everything
    above (sort / topN / window / non-decomposable aggregation) over the
    unioned pages. None when no useful cut exists: a bare scan or a pure
    projection of one is not worth shipping (generation is cheaper than
    the wire), so the cut must contain a join or a filter."""

    def has_work(n) -> bool:
        if isinstance(n, (P.HashJoin, P.Filter)):
            return True
        return any(has_work(c) for c in n.children())

    if row_local_scan_count(plan, split_table) == 1 and has_work(plan):
        return plan
    for c in plan.children():
        hit = find_union_cut(c, split_table)
        if hit is not None:
            return hit
    return None


def hash_fanout_plan(cut: P.Aggregation, catalogs,
                     partition_threshold: int = 1 << 17):
    """Co-partitioning spec for a PARTITIONED JOIN fan-out below an
    aggregation cut; the aggregates decompose by fanout_safe's rule (no
    DISTINCT masks). See hash_fanout_source."""
    if any(s.mask is not None for s in cut.aggregates):
        return None
    return hash_fanout_source(cut.source, catalogs, partition_threshold)


def big_tables_under(node: P.PhysicalNode, catalogs,
                     partition_threshold: int) -> set:
    """Names of the scanned tables under ``node`` with at least
    ``partition_threshold`` rows: the tables a fan-out must
    co-partition (smaller ones replicate)."""
    out = set()

    def walk(x):
        if isinstance(x, P.TableScan):
            if catalogs[x.catalog].row_count(x.table) >= \
                    partition_threshold:
                out.add(x.table)
            return
        for c in x.children():
            walk(c)

    walk(node)
    return out


def hash_fanout_source(root: P.PhysicalNode, catalogs,
                       partition_threshold: int = 1 << 17):
    """Co-partitioning spec for a PARTITIONED JOIN fan-out (the legacy
    hash-repartition exchange; reference: AddExchanges choosing
    REPARTITION with hash exchanges on both join sides).

    Returns {"catalog.table": partition_column} covering every BIG
    scanned table (row_count >= partition_threshold), or None when the
    shape does not co-partition. The shape under ``root``: Filter /
    Project / Exchange / TableScan / INNER hash joins; every join with
    big tables on BOTH sides must equi-join on a first key that is
    provably a column of each side's one big table
    (exec/plan.scan_column_of), not string- or dictionary-typed
    (dictionary codes are table-local, so equal values would hash to
    different workers), and each big table takes exactly ONE partition
    column; small tables replicate."""
    from presto_tpu_torch import types as T

    parts: dict = {}
    state = {"ok": True}

    def assign(table: str, column: str):
        if parts.get(table, column) != column:
            state["ok"] = False  # conflicting partition keys
        parts[table] = column

    def walk(n):
        if not state["ok"]:
            return
        if isinstance(n, (P.Filter, P.Project, P.Exchange, P.TableScan)):
            for c in n.children():
                walk(c)
            return
        if not isinstance(n, P.HashJoin) or n.join_type != "inner":
            state["ok"] = False
            return
        left_big = big_tables_under(n.left, catalogs, partition_threshold)
        right_big = big_tables_under(n.right, catalogs,
                                     partition_threshold)
        if left_big and right_big:
            # partitioned join: both sides keyed by their own table
            # columns, co-partitioned on this equi-key
            if len(n.left_keys) < 1:
                state["ok"] = False
                return
            lsrc = P.scan_column_of(n.left, n.left_keys[0])
            rsrc = P.scan_column_of(n.right, n.right_keys[0])
            if lsrc is None or rsrc is None:
                state["ok"] = False
                return
            for cat, table, col in (lsrc, rsrc):
                t = catalogs[cat].table_schema(table).column_type(col)
                if T.is_string(t) or t.is_dictionary_encoded:
                    state["ok"] = False
                    return
            # the key must constrain EVERY big table on its side: a
            # second big table not keyed by this join cannot
            # co-partition
            if left_big != {lsrc[1]} or right_big != {rsrc[1]}:
                state["ok"] = False
                return
            assign(f"{lsrc[0]}.{lsrc[1]}", lsrc[2])
            assign(f"{rsrc[0]}.{rsrc[1]}", rsrc[2])
        walk(n.left)
        walk(n.right)

    walk(root)
    if not state["ok"] or len(parts) < 2:
        return None
    return parts


def largest_table(node: P.PhysicalNode, catalogs) -> Optional[str]:
    """The table to split across tasks: the scanned table with the most
    rows under this subtree (SOURCE_DISTRIBUTION pick)."""
    tables = []

    def scans(n):
        if isinstance(n, P.TableScan):
            tables.append((n.catalog, n.table))
        for ch in n.children():
            scans(ch)

    scans(node)
    if not tables:
        return None
    return max(tables,
               key=lambda ct: catalogs[ct[0]].row_count(ct[1]))[1]


# ---------------------------------------------------------------------
# Task-plane routing. A response is (status, headers_list, content_type,
# body_bytes); None means "not a task-plane path".

_JSON_CT = "application/json"
_PAGES_CT = "application/x-presto-pages"
_RELEASED = "spool partition {} released (already acked)"


def _jresp(obj, status=200, headers=()):
    return (status, list(headers), _JSON_CT, json.dumps(obj).encode())


def write_task_response(handler, resp) -> None:
    status, headers, ctype, body = resp
    handler.send_response(status)
    handler.send_header("Content-Type", ctype)
    if status != 204:
        handler.send_header("Content-Length", str(len(body)))
    for k, v in headers:
        handler.send_header(k, v)
    handler.end_headers()
    if status != 204 and body:
        handler.wfile.write(body)


def route_task_post(app, path: str, body: bytes):
    if path.startswith("/v1/fault"):
        # runtime fault reconfiguration: the posted overlay replaces the
        # previous one; {} restores the environment's rule
        app.set_fault_config({
            k: int(v) for k, v in json.loads(body or b"{}").items()})
        return _jresp({"ok": True, "fault": app.fault_config})
    if path.startswith("/v1/cache/task"):
        # the fleet cache probe (dist/cacheprobe.py): serve one fragment
        # key from THIS process's result cache by parking its host pages
        # in a pre-finished task spool; the consumer fetches them over
        # the ordinary spool-fetch plane, as from an executed task
        req = json.loads(body)
        return _jresp(app.serve_cached_fragment(
            str(req.get("taskId") or ""), str(req.get("key") or "")))
    if not path.startswith("/v1/task"):
        return None
    if app.maybe_inject_submit_fault():
        return _jresp({"error": "injected submit fault"}, 500)
    task = app.create_task(json.loads(body))
    return _jresp({"taskId": task.task_id, "state": "RUNNING"})


def _entry_blob(entry) -> bytes:
    """Wire bytes of one spool entry: lazy Pages serialize here, outside
    the task lock (a device->host copy + serialize under it would stall
    every other consumer)."""
    if entry[0] == "page":
        from presto_tpu_torch.dist import spool as SPOOL

        return SPOOL.spool_blob(entry[1])
    if entry[0] == "blob":
        return entry[1]
    store, i = entry
    return store.blob_at(i)


def _results(app, task: _Task, part: int, token: int, max_bytes: int):
    """GET .../results/{token}?part=p&max=N: bounded long-poll until the
    page at `token` exists or the task finishes, then the frames from
    `token` on, packed up to max_bytes (at least one)."""
    from presto_tpu_torch.dist import spool as SPOOL

    if app.maybe_inject_fault():
        return _jresp({"error": "injected fault"}, 500)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        entry = None
        with task.lock:
            if task.error:
                # X-Task-Error marks a DETERMINISTIC task failure:
                # consumers surface the message instead of retrying
                return _jresp({"error": task.error}, 500,
                              headers=(("X-Task-Error", "1"),))
            if task.part_released(part):
                return _jresp({"error": _RELEASED.format(part)}, 410)
            if token < task.part_count(part):
                entry = task.part_entry(part, token)
            elif task.done:
                return (204, [("X-Done", "1")], _JSON_CT, b"")
        if entry is None:
            time.sleep(0.02)
            continue
        frames: List[bytes] = []
        total = 0
        while entry is not None:
            try:
                blob = _entry_blob(entry)
            except (OSError, IndexError):
                if not frames:  # raced a concurrent release
                    return _jresp({"error": _RELEASED.format(part)}, 410)
                break
            # the corruption lands INSIDE one page body (framing
            # intact), so the consumer's decode catches it
            frames.append(app.maybe_corrupt_blob(blob))
            total += 8 + len(blob)
            entry = None
            if total >= max_bytes:
                break
            nxt = token + len(frames)
            with task.lock:
                if not (task.error or task.part_released(part)) and \
                        nxt < task.part_count(part):
                    entry = task.part_entry(part, nxt)
        return (200, [("X-Next-Token", str(token + len(frames))),
                      ("X-Done", "0"), ("X-Frames", str(len(frames)))],
                _PAGES_CT, SPOOL.pack_frames(frames))
    return (204, [("X-Done", "0")], _JSON_CT, b"")


def route_task_get(app, path: str, query: str):
    from urllib.parse import parse_qs

    parts = [p for p in path.split("/") if p]
    if len(parts) == 5 and parts[:2] == ["v1", "task"] \
            and parts[3] == "results":
        task = app.get_task(parts[2])
        if task is None:
            return _jresp({"error": "no such task"}, 404)
        qs = parse_qs(query or "")
        return _results(app, task, int(qs.get("part", ["0"])[0]),
                        int(parts[4]), int(qs.get("max", ["0"])[0]))
    if len(parts) == 3 and parts[:2] == ["v1", "task"]:
        task = app.get_task(parts[2])
        if task is None:
            return _jresp({"error": "no such task"}, 404)
        with task.lock:
            spool = task.spool
            body = {
                "taskId": task.task_id,
                "state": ("FAILED" if task.error else
                          "FINISHED" if task.done else "RUNNING"),
                "spooledPages": spool.page_count if spool else 0,
                "partitions": len(spool.parts) if spool else 1,
                "error": task.error,
                # the spool-stats plane: exact per-partition rows,
                # bytes and wire bytes plus the executor's outcomes,
                # summed on the coordinator at the stage boundary
                "boostRetries": task.boost_retries,
                "skewPreempted": task.skew_preempted,
            }
            if spool is not None:
                rows, nbytes, wire = spool.part_stats()
                body["spoolRows"] = rows
                body["spoolBytes"] = nbytes
                body["spoolWireBytes"] = wire
            if task.spans is not None:
                # worker-side spans for the coordinator's cross-node
                # timeline: offsets from this task's creation
                body["spans"] = task.spans
                body["wallAnchor"] = task.created_wall
        return _jresp(body)
    return None


def route_task_delete(app, path: str):
    parts = [p for p in path.split("/") if p]
    # /v1/task/{id}/spool/{part}: ack (release) one consumed partition
    if len(parts) == 5 and parts[:2] == ["v1", "task"] \
            and parts[3] == "spool":
        task = app.get_task(parts[2])
        if task is None:
            return _jresp({"error": "no such task"}, 404)
        with task.lock:
            ok = task.spool is not None and task.spool.release(
                int(parts[4]))
        if ok:
            return _jresp({"taskId": task.task_id,
                           "partition": int(parts[4]),
                           "state": "RELEASED"})
        return _jresp({"error": "no such spool partition"}, 404)
    if len(parts) == 3 and parts[:2] == ["v1", "task"]:
        task = app.pop_task(parts[2])
        if task is not None:
            with task.lock:
                task.cancelled = True
                task.free()
            return _jresp({"taskId": task.task_id, "state": "CANCELED"})
    return None


class _WorkerHandler(BaseHTTPRequestHandler):
    server_version = "presto-tpu-torch-worker/0.1"
    # HTTP/1.1 so the pooled clients (dist/connpool.py) keep connections
    # alive; every response sends Content-Length (204s ship no body)
    protocol_version = "HTTP/1.1"
    timeout = 120
    # TCP_NODELAY: a response goes out as two writes (the headers, then
    # the body); with Nagle on, the body waits for the client's delayed
    # ACK of the headers, about 40 ms on a kept-alive connection, which
    # every status poll, ack and small fetch of a query would pay
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # noqa: A003
        pass

    @property
    def app(self) -> "TaskRuntime":
        return self.server.app  # type: ignore[attr-defined]

    def _write(self, resp) -> None:
        write_task_response(self, resp if resp is not None
                            else _jresp({"error": "not found"}, 404))

    def do_POST(self):
        n = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(n) or b"{}"
        self._write(route_task_post(self.app, self.path, body))

    def do_GET(self):
        from urllib.parse import urlsplit

        split = urlsplit(self.path)
        if split.path.startswith("/v1/info"):
            info = {"nodeId": self.app.node_id, "state": "ACTIVE",
                    "tasks": self.app.task_count()}
            # the fleet-cache advertisement: a bloom summary of this
            # process's cached fragment keys rides every heartbeat poll,
            # so the coordinator's RemoteCacheIndex stays fresh with no
            # plane of its own; absent while the store holds nothing
            from presto_tpu_torch.cache import shared_cache_if_exists

            rc = shared_cache_if_exists()
            keys = rc.pages_keys() if rc is not None else []
            if keys:
                from presto_tpu_torch.dist.cacheprobe import bloom_summary

                info["cacheSummary"] = bloom_summary(keys)
            self._write(_jresp(info))
            return
        self._write(route_task_get(self.app, split.path, split.query))

    def do_DELETE(self):
        self._write(route_task_delete(self.app, self.path))


class TaskRuntime:
    """A process's task runtime (SqlTaskManager analog): task registry,
    fragment execution, spooled output buffers — no HTTP server of its
    own. ``device=None`` runs tasks on the card."""

    # finished tasks kept before the oldest expire (reference:
    # SqlTaskManager task expiry); the scheduler releases its tasks
    # explicitly at query end, so expiry only bounds leaks. Spooled
    # tasks expire far later: their partitions are replay inputs of
    # downstream tasks, and evicting one mid-query would turn a healthy
    # worker into a [source-lost] node
    MAX_RETAINED_TASKS = 32
    MAX_RETAINED_SPOOLED = 256

    def __init__(self, catalogs, *, node_id: str = "w0",
                 default_catalog: Optional[str] = None,
                 page_rows: int = 1 << 16, device=None):
        self.catalogs = catalogs
        self.node_id = node_id
        self.default_catalog = default_catalog or next(iter(catalogs))
        self.page_rows = page_rows
        self.device = resolve_device(device)
        self.tasks: Dict[str, _Task] = {}
        self._tasks_lock = make_lock("server.worker.TaskRuntime._tasks_lock")
        # the runtime fault overlay (POST /v1/fault) and its call
        # counters, under _fault_lock
        self._fault_lock = make_lock("server.worker.TaskRuntime._fault_lock")
        self.fault_config: Dict[str, int] = {}
        self._results_calls = 0
        self._submit_calls = 0
        self._corrupt_calls = 0

    def get_task(self, task_id: str) -> Optional[_Task]:
        with self._tasks_lock:
            return self.tasks.get(task_id)

    def pop_task(self, task_id: str) -> Optional[_Task]:
        with self._tasks_lock:
            return self.tasks.pop(task_id, None)

    def register_finished_task(self, task_id: str,
                               spool: "_TaskSpool") -> None:
        """Register an already-FINISHED task whose output is a prebuilt
        spool: the ICI exchange plane's landing surface. The coordinator
        runs the all_to_all partitioning after the stage barrier and
        parks the partition pages here, so consumers read them through
        the one spool data plane (local fast path or HTTP, re-fetch,
        ack, release)."""
        t = _Task(task_id)
        with t.lock:
            t.spool = spool
            t.done = True
        with self._tasks_lock:
            self.tasks[task_id] = t

    def serve_cached_fragment(self, task_id: str, key: str) -> Dict:
        """The fleet cache probe's target: if this process's result
        cache holds ``key``, park its host pages in a pre-finished
        single-partition task spool (register_finished_task) and report
        the hit; the prober reads the pages over the spool-fetch plane.
        A miss is one dictionary probe."""
        from presto_tpu_torch.cache import shared_cache_if_exists

        rc = shared_cache_if_exists()
        if rc is None or not task_id or not key:
            return {"hit": False}
        pages = rc.get_pages(key)
        if pages is None:
            return {"hit": False}
        spool = _TaskSpool(1, 0)
        for page in pages:
            spool.put_page(0, page, rows=int(XF.np_host(
                page.valid, label="cache-remote-serve").sum()))
        self.register_finished_task(task_id, spool)
        rc.count_remote()
        return {"hit": True, "taskId": task_id, "pages": len(pages)}

    def task_count(self) -> int:
        with self._tasks_lock:
            return len(self.tasks)

    def free_all(self) -> None:
        """Release every task's spool (shutdown)."""
        with self._tasks_lock:
            doomed = list(self.tasks.values())
            self.tasks.clear()
        for t in doomed:
            with t.lock:
                t.cancelled = True
                t.free()

    # ------------------------------------------------- fault injection
    def set_fault_config(self, cfg: Dict[str, int]) -> None:
        """Install a runtime fault overlay and reset the call counters:
        "drop every nth" and "kill after n" count from the post."""
        with self._fault_lock:
            self.fault_config = cfg
            self._results_calls = 0
            self._submit_calls = 0
            self._corrupt_calls = 0

    def _fault(self, name: str) -> int:
        if name in self.fault_config:
            return int(self.fault_config[name])
        return int(os.environ.get(name, "0") or 0)

    def _kill(self) -> None:
        """FAULT_KILL_AFTER_FETCHES: a worker in its own process
        hard-exits, bypassing every finally and atexit, like an OOM
        kill or the loss of its host."""
        os._exit(137)

    def maybe_inject_fault(self) -> bool:
        """Faults at the page proxy (delay, drop, kill) on one results
        fetch; True = answer this fetch with HTTP 500. Token-indexed
        re-fetch makes drops recoverable; a kill only the scheduler's
        re-dispatch recovers."""
        delay = self._fault("FAULT_DELAY_MS")
        if delay:
            time.sleep(delay / 1000.0)
        with self._fault_lock:
            self._results_calls += 1
            calls = self._results_calls
        kill_after = self._fault("FAULT_KILL_AFTER_FETCHES")
        if kill_after and calls > kill_after:
            self._kill()
            return True
        drop = self._fault("FAULT_DROP_EVERY")
        return bool(drop and calls % drop == 0)

    def maybe_corrupt_blob(self, blob: bytes) -> bytes:
        """FAULT_SPOOL_CORRUPT_EVERY=n: flip one byte of every nth
        served page body. The consumer's decode rejects the frame
        before its token advances (dist/serde.PageWireError), retries
        the token, then replays or fails the query: never garbage
        rows."""
        every = self._fault("FAULT_SPOOL_CORRUPT_EVERY")
        if not every or not blob:
            return blob
        with self._fault_lock:
            self._corrupt_calls += 1
            if self._corrupt_calls % every:
                return blob
        flipped = bytearray(blob)
        flipped[len(flipped) // 2] ^= 0x01
        return bytes(flipped)

    def maybe_inject_submit_fault(self) -> bool:
        """HTTP 500 on every nth task submit: the coordinator's submit
        retry re-dispatches to another worker."""
        drop = self._fault("FAULT_SUBMIT_DROP_EVERY")
        if drop:
            with self._fault_lock:
                self._submit_calls += 1
                return self._submit_calls % drop == 0
        return False

    # ------------------------------------------------------------ tasks
    def create_task(self, req: Dict) -> _Task:
        doomed: List[_Task] = []
        with self._tasks_lock:
            for pool, cap in (
                    ([tid for tid, t in self.tasks.items()
                      if t.done and t.spool is None],
                     self.MAX_RETAINED_TASKS),
                    ([tid for tid, t in self.tasks.items()
                      if t.done and t.spool is not None],
                     self.MAX_RETAINED_SPOOLED)):
                while len(pool) > cap:
                    old = self.tasks.pop(pool.pop(0), None)
                    if old is not None:
                        doomed.append(old)
            task = _Task(req.get("taskId") or f"t{len(self.tasks)}")
            self.tasks[task.task_id] = task
        for old in doomed:  # frees outside the registry lock
            with old.lock:
                old.free()
        threading.Thread(target=self._run_task, args=(task, req),
                         daemon=True).start()
        return task

    def _run_task(self, task: _Task, req: Dict) -> None:
        from presto_tpu_torch.dist import plan_serde, serde
        from presto_tpu_torch.dist import spool as SPOOL
        from presto_tpu_torch.runner import LocalRunner

        # worker-side lifecycle tracing: when the coordinator traces the
        # query, the payload carries trace=true and this task records
        # queue/run spans (and its executor's attempt and xfer spans),
        # anchored at task creation, shipped back on the status plane
        wtr = None
        if req.get("trace"):
            wtr = OBS.QueryTrace(task.task_id,
                                 anchor_mono=task.created_mono,
                                 anchor_wall=task.created_wall)
            wtr.complete("queue", task.task_id, 0.0, wtr.now())
        run_t0 = wtr.now() if wtr is not None else 0.0
        try:
            # FAULT_TASK_EXEC_DELAY_MS: stall task EXECUTION (not the
            # fetch path), a deterministic straggler
            exec_delay = self._fault("FAULT_TASK_EXEC_DELAY_MS")
            if exec_delay:
                time.sleep(exec_delay / 1000.0)
            index, count = int(req["splitIndex"]), int(req["splitCount"])
            sources = req.get("sources") or {}
            if req.get("splitMode") == "hash":
                # the legacy hash fan-out: co-partitioned scans; the
                # spec is keyed "catalog.table", so a same-named table
                # of another catalog replicates untouched
                part_cols = req["partitionColumns"]
                catalogs = {
                    name: HashSplitConnector(
                        conn, {t.split(".", 1)[1]: c
                               for t, c in part_cols.items()
                               if t.split(".", 1)[0] == name},
                        index, count)
                    for name, conn in self.catalogs.items()
                }
            elif req.get("splitTable"):
                catalogs = {
                    name: SplitFilterConnector(conn, req["splitTable"],
                                               index, count)
                    for name, conn in self.catalogs.items()
                }
            elif sources:
                # non-leaf fragment: inputs arrive through the sources
                catalogs = dict(self.catalogs)
            else:
                # unsplit leaf execution would have every task scan the
                # full table: refuse loudly
                raise ValueError(
                    "task payload carries neither a split assignment "
                    "(splitTable/splitMode) nor spooled-exchange sources "
                    "— refusing to run the fragment unsplit")
            session = {"page_rows": self.page_rows,
                       **(req.get("session") or {})}
            runner = LocalRunner(catalogs, self.default_catalog,
                                 session=session, device=self.device)
            fragment = plan_serde.loads(req["fragment"])
            ex = runner.executor
            if wtr is not None:
                OBS.attach(ex, wtr)
            backoff = int(runner.session.get("retry_backoff_ms")) / 1000.0
            for key, spec in sources.items():
                ex.remote_sources[key] = (
                    lambda spec=spec: SPOOL.iter_source_pages(
                        spec, retries=3, backoff_s=backoff,
                        deadline=ex.query_deadline,
                        on_local=ex.count_mesh_local))
            # overflow discipline (Executor.stream_fragment, the
            # query-scope ladder): output publishes only after the
            # fragment's attempt completes with its overflow flags
            # clear, so a truncated page set never reaches the
            # coordinator; an overflow re-runs the fragment at boosted
            # capacities, and a persistent one fails the task loudly
            if not (sources or req.get("outputPartitions")):
                # a legacy cut's task: host pages serialized into a
                # token-acked list, published whole after the attempt.
                # Every page crosses the wire, so only its valid rows
                # ship, compacted on the host: a filtered or joined
                # page's live prefix is most of its capacity
                def emit_blob(page) -> bytes:
                    host = XF.to_host(page, label="task-emit")
                    idx = np.nonzero(XF.np_host(host.valid))[0]
                    return serde.serialize_page(
                        SPOOL.take_rows_host(host, idx))

                blobs = ex.stream_fragment(
                    fragment, emit_blob, cancelled=lambda: task.cancelled)
                if wtr is not None:
                    wtr.complete("run", task.task_id, run_t0, wtr.now(),
                                 pages=len(blobs))
                with task.lock:
                    if wtr is not None:
                        task.spans = wtr.export()
                    if not task.cancelled:
                        task.pages.extend(blobs)
                    task.boost_retries = ex.capacity_boost_retries
                    task.done = True
                return
            nparts = max(int(req.get("outputPartitions") or 1), 1)
            out_keys = tuple(req.get("outputKeys") or ())
            budget = int(runner.session.get("spool_exchange_bytes"))
            state = {"spool": None}

            def on_attempt() -> None:
                # a boosted retry starts from an empty spool
                if state["spool"] is not None:
                    state["spool"].close()
                state["spool"] = _TaskSpool(nparts, budget)

            if req.get("meshExchange"):
                def emit(page) -> int:
                    # the ICI plane: spool the RAW page to partition 0
                    # untouched; the coordinator's post-barrier
                    # all_to_all partitions it, so no hashing, no P-way
                    # compaction and no spool-stats pull happen here
                    state["spool"].put_page(0, page, rows=0)
                    return 1
            elif ex._device_exchange_on():
                def emit(page) -> int:
                    pp, counts = SPOOL.device_partition_pages(
                        ex, page, out_keys, nparts, with_counts=True)
                    for p, part_page in pp:
                        rows = int(counts[p])
                        if rows and nparts > 1:
                            part_page = SPOOL.trim_partition_page(
                                part_page, rows)
                        if rows:
                            state["spool"].put_page(p, part_page,
                                                    rows=rows)
                    return len(pp)
            else:
                def emit(page) -> int:
                    # the fragment output leaves the device exactly
                    # once, here
                    host = XF.to_host(page, label="task-emit")
                    pp = SPOOL.partition_host_page(host, out_keys, nparts)
                    for p, part_page in pp:
                        state["spool"].put(
                            p, serde.serialize_page(part_page),
                            rows=int(part_page.valid.sum()))
                    return len(pp)

            # the re-planner's skew hint: grace joins start in the
            # position-chunked rebalance on the first attempt
            ex.skew_preengaged = bool(req.get("skewHint"))
            ex.stream_fragment(fragment, emit,
                               cancelled=lambda: task.cancelled,
                               on_attempt=on_attempt)
            if wtr is not None:
                wtr.complete("run", task.task_id, run_t0, wtr.now(),
                             spooled=state["spool"].page_count)
            with task.lock:
                if wtr is not None:
                    task.spans = wtr.export()
                if task.cancelled:
                    state["spool"].close()  # released while running
                else:
                    task.spool = state["spool"]
                task.boost_retries = ex.capacity_boost_retries
                task.skew_preempted = ex.skew_preempted
                task.done = True
        except Exception as e:  # noqa: BLE001 - a task failure reaches
            # the coordinator as FAILED status / X-Task-Error, never as
            # a hung task
            if wtr is not None:
                wtr.complete("run", task.task_id, run_t0, wtr.now(),
                             error=repr(e)[:200])
            with task.lock:
                if wtr is not None:
                    task.spans = wtr.export()
                task.error = repr(e)[:400]
                task.done = True


class _TrackingHTTPServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer that knows its open connections, so a
    stopped worker drops its keep-alive sockets too: a pooled client
    then sees the node gone instead of a handler thread that still
    answers. The listening socket reuses its address, so a worker
    restarted on the same port binds at once, and its accept queue is
    deeper than socketserver's 5: a burst of connects (every consumer's
    fetches, the coordinators' heartbeats) arrives while the accept
    loop waits for the GIL, and a connect the queue drops waits out SYN
    retransmits of 1, 3, 7 ... s."""

    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128

    def __init__(self, *a, **kw):
        self._conns: set = set()
        self._conns_lock = make_lock(
            "server.worker._TrackingHTTPServer._conns_lock")
        super().__init__(*a, **kw)

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def drop_connections(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class WorkerServer(TaskRuntime):
    """One task runtime behind its own HTTP server on 127.0.0.1, in the
    process that starts it.

    ``port`` 0 picks a free port; a stopped worker can be restarted on
    its uri by constructing another with that port. Unregistered from
    the same-process placement registry (unregister_local_runtime), a
    started worker serves its spools only over HTTP, as a worker in
    another process does."""

    def __init__(self, catalogs, *, port: int = 0, node_id: str = "w0",
                 default_catalog: Optional[str] = None,
                 page_rows: int = 1 << 16, device=None):
        super().__init__(catalogs, node_id=node_id,
                         default_catalog=default_catalog,
                         page_rows=page_rows, device=device)
        self._httpd = _TrackingHTTPServer(("127.0.0.1", port),
                                          _WorkerHandler)
        self._httpd.app = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self.uri = f"http://127.0.0.1:{self.port}"
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        # set once a stop() has finished: a second stop() (a restart on
        # the same port racing a kill fault's stop thread) waits for it,
        # so the port is free when it returns
        self._stop_done = threading.Event()
        # True when this worker is its process's only tenant (main()):
        # FAULT_KILL_AFTER_FETCHES then hard-exits the process
        self.owns_process = False

    def start(self) -> int:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        register_local_runtime(self.uri, self)
        return self.port

    def _kill(self) -> None:
        if self.owns_process:
            super()._kill()
        # a worker sharing its process with others dies by its stop(),
        # not os._exit; off the handler thread, which stop() would
        # otherwise wait on
        threading.Thread(target=self.stop, daemon=True).start()

    def stop(self) -> None:
        """The worker's death: unregister FIRST (a stopped worker must
        look remote-and-dead to local consumers, never serve stale
        spools), stop serving, drop open connections and free every
        task's spool. Idempotent: a stop() racing another returns once
        that one has finished."""
        if self._stopped:
            self._stop_done.wait(60)
            return
        self._stopped = True
        if local_runtime(self.uri) is self:
            unregister_local_runtime(self.uri)
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd.drop_connections()
        self.free_all()
        self._stop_done.set()


def main(argv=None) -> int:  # pragma: no cover - subprocess entry
    """Worker process entry: serves one generated catalog on the card
    (or ``--device cpu``), prints its port as one JSON line, then serves
    until interrupted. FAULT_* environment knobs apply; a kill fault
    hard-exits the process."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--suite", default="tpch")
    parser.add_argument("--scale", type=float, default=0.01)
    parser.add_argument("--node-id", default="w0")
    parser.add_argument("--page-rows", type=int, default=1 << 16)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    if args.suite == "tpch":
        from presto_tpu_torch.connectors.tpch import TpchConnector as cls
    else:
        from presto_tpu_torch.connectors.tpcds import TpcdsConnector as cls
    srv = WorkerServer({args.suite: cls(args.scale, device=args.device)},
                       port=args.port, node_id=args.node_id,
                       default_catalog=args.suite,
                       page_rows=args.page_rows, device=args.device)
    srv.owns_process = True
    port = srv.start()
    print(json.dumps({"port": port, "nodeId": args.node_id}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
