"""DCN coordinator: multi-worker query execution over HTTP workers.

Port of presto_tpu/dist/dcn.py (reference: the coordinator half of
distributed execution — server/remotetask/HttpRemoteTask.java for task
create/status and operator/ExchangeClient.java +
HttpPageBufferClient.java for the token-acked page fetch with retries).

``DcnRunner.execute(sql)`` plans the query and ships fragments to the
configured workers (server/worker.WorkerServer) at one of the
reference's boundaries, chosen by ``stage_scheduler``:

  - "auto" (the default): the legacy cuts first —
      PARTIAL/FINAL aggregation cut (tiny state pages; preferred):
        worker w: scan(its split share of the fact table) -> ... ->
        partial agg; coordinator: RemoteSource(all workers) -> final
        agg -> rest. The fact table splits round-robin
        ("roundrobin") or, where both big join sides co-partition on
        the join key, by key hash ("hash"; HashSplitConnector).
      UNION cut (a row-local subtree with no decomposable
      aggregation: multi-join pipelines):
        worker w: row-local subtree over its split share -> result
        pages; coordinator: RemoteSource union -> sort / topN /
        window / agg -> rest ("union-roundrobin" / "union-hash").
    and the stage DAG (dist/fragmenter.fragment_dag: gather /
    broadcast / hash-repartition exchanges, run by
    dist/scheduler.StageScheduler) only where none applies;
  - "true": the stage DAG first, the legacy cuts where it refuses;
  - "false": the legacy cuts only.

A plan no path distributes runs locally. Every task payload carries the
SERIALIZED fragment (dist/plan_serde.py) and the session; a legacy
task's pages publish only after its fragment ran overflow-free
(Executor.stream_fragment on the worker), so a union cut never ships
truncated rows. ``last_distribution`` names the path taken.

Under ``plan_check`` every task payload is checked before its POST
(check_task_payload) and the DAG verifies before any task dispatches
(exec/plan_check.verify_dag). Under ``query_trace_enabled`` or
``query_trace_dir`` one trace covers the distributed run (stage, task,
dispatch and fetch spans, the workers' queue and run spans ingested
under their task or the root) and the coordinator's final fragment.

Failure model: fault-tolerant task retry (reference: Project
Tardigrade's task-level retry), made cheap by deterministic fragments.
``task_retry_attempts`` > 0: a lost task re-dispatches to a surviving
ALIVE worker — on the legacy cuts ``_recover_task`` re-runs only the
lost split share, on the DAG the scheduler replays leaf and non-leaf
tasks — and pages the coordinator already consumed dedupe by fetch
token once the new placement's prefix is VERIFIED byte-identical (a
rolling sha256 of the consumed frames, `_prefix_matches`), so a
non-deterministic replay fails loudly instead of skipping or
duplicating rows. The pool is heartbeat-gated: a started
HeartbeatFailureDetector (server/heartbeat.py) pings every configured
worker on a daemon thread, nodes it marks FAILED are never picked,
excluded nodes are re-probed at most once per heartbeat interval and
rejoin when a probe succeeds. ``task_retry_attempts=0`` pins the
classic model end to end: every configured worker is used and the
first failure fails the query with DcnQueryFailed. Recovery is counted
on the coordinator executor (``task_retries``, ``workers_excluded``,
``nonleaf_replays``) and announced as TaskRetryEvent to the
``listeners``. ``checkpoint_handle`` (dist/checkpoint.QueryCheckpoint,
set by the server per query) journals the DAG's stage, root and drain
barriers. ``close()`` stops the detector's thread.

The fleet cache probe (dist/cacheprobe.py): every heartbeat poll feeds
the workers' bloom summaries of their cached fragment keys into
``cache_index``. Under ``result_cache_enabled`` and
``result_cache_remote_probe`` (default true) a legacy round-robin task
whose fragment some worker's bloom may hold is first offered to that
worker (``POST /v1/cache/task``); on a hit the worker parks the cached
pages as a finished task and no task is dispatched
(``cache_remote_hits``). The stage DAG's leaf tasks probe the same way
(dist/scheduler.py). The common miss costs no round trip.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
import time
import urllib.error
import uuid
from typing import Dict, List, Optional

from presto_tpu_torch.dist import connpool as CONNPOOL
from presto_tpu_torch.dist import plan_serde, serde
from presto_tpu_torch.dist import spool as SPOOL
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec.executor import check_deadline
from presto_tpu_torch.server.heartbeat import HeartbeatFailureDetector
from presto_tpu_torch.server.worker import (
    fanout_safe,
    find_partial_cut,
    find_union_cut,
    hash_fanout_plan,
    hash_fanout_source,
    largest_table,
)


class DcnQueryFailed(RuntimeError):
    """Query-level failure: task retries exhausted or no survivors
    left, or — with task_retry_attempts=0 — the first task failure or
    worker loss."""


class _TaskLost(RuntimeError):
    """Internal: one task placement is gone (exhausted fetch retries,
    or — task_error=True — a worker-side task failure); the recovery
    path decides whether to re-dispatch or fail the query."""

    def __init__(self, msg: str, task_error: bool = False):
        super().__init__(msg)
        # True when the TASK failed on a healthy worker (X-Task-Error):
        # re-dispatch is still tried, but the node is not excluded
        self.task_error = task_error


@dataclasses.dataclass
class _TaskState:
    """One logical task (one split share of a fragment) and its current
    placement. `next_token` is the count of pages consumed so far and
    `hasher` a rolling sha256 of their serialized bytes: a replayed
    placement resumes at next_token only after its regenerated prefix
    hashes equal. `payload` is what a re-dispatch re-POSTs (the legacy
    cuts and the re-attach path), `retries_used` counts its placements
    after the first."""

    uri: str
    task_id: str
    payload: Optional[Dict] = None
    next_token: int = 0
    retries_used: int = 0
    trace_t0: float = 0.0  # dispatch instant on the trace clock
    hasher: "hashlib._Hash" = dataclasses.field(
        default_factory=hashlib.sha256)


def _replace_node(root, target, repl):
    """Structural replace of one subtree in a frozen plan tree."""
    if root is target:
        return repl
    changes = {}
    for f in dataclasses.fields(root):
        v = getattr(root, f.name)
        if isinstance(v, P.PhysicalNode):
            nv = _replace_node(v, target, repl)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and v and isinstance(
                v[0], P.PhysicalNode):
            nv = tuple(_replace_node(x, target, repl) for x in v)
            if any(a is not b for a, b in zip(nv, v)):
                changes[f.name] = nv
    return dataclasses.replace(root, **changes) if changes else root


class DcnRunner:
    """Coordinator over N workers. execute(sql) returns the row list;
    the last run's column names are in ``last_output_names``.
    ``device=None`` runs the coordinator's root fragment on the card."""

    def __init__(self, catalogs, worker_uris: List[str], *,
                 default_catalog: Optional[str] = None,
                 fetch_retries: int = 3,
                 session_props: Optional[Dict] = None,
                 partition_threshold: int = 1 << 17,
                 listeners=(),
                 device=None):
        from presto_tpu_torch.runner import LocalRunner

        self.worker_uris = list(worker_uris)
        self.fetch_retries = fetch_retries
        # row count from which a scanned table co-partitions in a hash
        # fan-out (hash_fanout_source); smaller tables replicate
        self.partition_threshold = partition_threshold
        # introspection: "hash" | "roundrobin" | "union-hash" |
        # "union-roundrobin" | "stage-dag" | "local", the last
        # scheduler (its per-stage pools and placements) and the
        # heartbeat-gated pool the last query started on
        self.last_distribution = "local"
        self.last_scheduler = None
        self.last_pool: List[str] = []
        self.last_output_names: Optional[List[str]] = None
        # test and fault-injection hooks: called with the fragment id
        # after each completed stage, and with the scheduler between
        # the last stage barrier and the root fragment's drain
        self._stage_hook = None
        self._root_hook = None
        # the active query's checkpoint handle
        # (dist/checkpoint.QueryCheckpoint): the stage scheduler
        # journals placements, the root and drain progress through it;
        # None = checkpointing off
        self.checkpoint_handle = None
        self.session_props = dict(session_props or {})
        self.listeners = list(listeners)
        # nodes excluded after a mid-query failure; re-admitted only
        # on a fresh successful probe (a worker restarted on the same
        # uri rejoins at the next stage or query)
        self._excluded: set = set()
        self._rng = random.Random()
        self.runner = LocalRunner(
            catalogs, default_catalog or next(iter(catalogs)),
            session=self.session_props, device=device)
        # the background detector pays dead-node connect timeouts on
        # its daemon thread, never on the query path: the submit gate
        # reads its CACHED state
        self.heartbeat = HeartbeatFailureDetector(list(self.worker_uris))
        # the fleet-cache index: per-worker bloom summaries of cached
        # fragment keys, refreshed by every heartbeat ping, so the
        # pre-dispatch probe's common miss never touches the wire
        from presto_tpu_torch.dist.cacheprobe import RemoteCacheIndex

        self.cache_index = RemoteCacheIndex()
        self.heartbeat.on_info = self.cache_index.update_from_info
        self.heartbeat.start()
        # per-node time of the last re-admission probe of an excluded
        # node (a still-dead node costs its connect timeout at most
        # once per heartbeat interval)
        self._probe_at: Dict[str, float] = {}

    def close(self) -> None:
        """Stop the background heartbeat thread (the runner owns it)."""
        self.heartbeat.stop()

    # ------------------------------------------------ session knobs
    def _retry_attempts(self) -> int:
        return int(self.runner.session.get("task_retry_attempts"))

    def _backoff_ms(self) -> int:
        return int(self.runner.session.get("retry_backoff_ms"))

    # --------------------------------------------------------- protocol
    def _task_spans(self, st: _TaskState) -> List[Dict]:
        """One best-effort status poll for a task's worker-side spans
        (queue / run / attempt, shipped on the status plane). A
        transport error returns []: the timeline loses the worker
        detail, the query loses nothing."""
        try:
            with CONNPOOL.request(f"{st.uri}/v1/task/{st.task_id}",
                                  timeout=5) as r:
                return json.loads(r.read().decode()).get("spans") or []
        except (urllib.error.URLError, ConnectionError, OSError,
                ValueError):
            return []

    def _post_task(self, uri: str, payload: Dict) -> Dict:
        # connpool never replays a POST on a reused socket — a task
        # submit reaches the worker at most once
        with CONNPOOL.request(
            f"{uri}/v1/task", method="POST",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, timeout=30,
        ) as resp:
            return json.loads(resp.read().decode())

    def _probe_budget(self, ex) -> Optional[float]:
        """The remote-cache probe's timeout: at most 5 s and a quarter of
        the query's remaining query_max_run_time, or None (counted on
        probe_deadline_skips) when the deadline cannot afford a probe —
        the caller then dispatches as usual."""
        deadline = ex.query_deadline
        if deadline is None:
            return 5.0
        remaining = deadline - time.monotonic()
        if remaining < 2.0:
            ex.probe_deadline_skips += 1
            return None
        return min(5.0, 0.25 * remaining)

    def _probe_cached_task(self, partial, split_table: str, index: int,
                           count: int, task_id: str,
                           pool) -> Optional[str]:
        """The fleet cache probe of the legacy dispatch: the key this
        split share's task would store on a worker, offered to the pool
        (_probe_pool). Round-robin splits only: the hash split mode
        wraps the connectors otherwise on the worker, so its keys are
        not what this mirror computes."""
        from presto_tpu_torch.dist.cacheprobe import fragment_cache_key

        ex = self.runner.executor
        try:
            key = fragment_cache_key(
                partial, self.runner.catalogs, split_table=split_table,
                split_index=index, split_count=count,
                collect_k=ex.collect_k, page_rows=ex.page_rows)
        except Exception:  # noqa: BLE001 - an advisory probe
            return None
        if key is None:
            return None
        return self._probe_pool(key, task_id, pool)

    def _probe_pool(self, key: str, task_id: str, pool) -> Optional[str]:
        """Ask the live pool members whose bloom summary may hold
        ``key`` to serve it from their result cache (``POST
        /v1/cache/task``). Returns the uri that parked the pages as the
        finished task ``task_id`` (the ordinary spool-fetch plane reads
        them), or None: every failure here is advisory and reads as a
        miss. The legacy dispatch and the stage scheduler share it."""
        timeout = self._probe_budget(self.runner.executor)
        if timeout is None:
            return None
        for uri in pool:
            if uri in self._excluded or \
                    not self.cache_index.might_contain(uri, key):
                continue
            try:
                with CONNPOOL.request(
                        f"{uri}/v1/cache/task", method="POST",
                        data=json.dumps(
                            {"taskId": task_id, "key": key}).encode(),
                        headers={"Content-Type": "application/json"},
                        timeout=timeout) as r:
                    out = json.loads(r.read().decode())
            except (urllib.error.URLError, ConnectionError, OSError,
                    ValueError):
                continue  # a bloom false positive or a slow peer
            if out.get("hit"):
                return uri
        return None

    @staticmethod
    def _raise_if_task_error(e: BaseException, uri: str,
                             task_id: str) -> None:
        """X-Task-Error on a results response marks a task failure on a
        healthy worker: surface its text at once."""
        if isinstance(e, urllib.error.HTTPError) and \
                e.headers.get("X-Task-Error"):
            try:
                msg = json.loads(e.read().decode()).get("error", "")
            except (ValueError, OSError):
                msg = ""
            raise _TaskLost(f"task {task_id} FAILED on worker {uri}: "
                            f"{msg or e}", task_error=True) from e

    def _sleep_backoff(self, attempt: int,
                       deadline: Optional[float]) -> None:
        """Exponential backoff with jitter between retries, never past
        the query deadline."""
        base = self._backoff_ms() / 1000.0
        delay = min(base * (2 ** max(attempt - 1, 0)), 5.0)
        delay *= 0.5 + self._rng.random()
        if deadline is not None:
            delay = min(delay, max(deadline - time.monotonic(), 0.0))
        if delay > 0:
            time.sleep(delay)

    @staticmethod
    def _deadline_timeout(deadline: Optional[float],
                          cap: float = 60.0) -> float:
        """Per-request timeout bounded by the query's remaining
        deadline: a fetch against a dying worker never blocks past
        query_max_run_time."""
        if deadline is None:
            return cap
        return max(1.0, min(cap, deadline - time.monotonic()))

    def _fetch_pages(self, st: _TaskState, deadline: Optional[float]):
        """Token-acked page fetch of partition 0 with bounded, backed-
        off retries (at-least-once + dedupe by token), starting at
        st.next_token. Frames decode one at a time; the token, the
        prefix hash and the yield advance per frame, so a retry — or a
        replayed placement — resumes at the first unconsumed page.
        Raises _TaskLost when the placement is unreachable, a frame
        stays corrupt, or the task failed."""
        while True:
            attempt = 0
            while True:
                check_deadline(deadline, "in the DCN fetch loop")
                try:
                    with CONNPOOL.request(
                        f"{st.uri}/v1/task/{st.task_id}/results/"
                        f"{st.next_token}?max={SPOOL.FETCH_WINDOW_BYTES}",
                        timeout=self._deadline_timeout(deadline),
                    ) as r:
                        if r.status == 204:
                            if r.headers.get("X-Done") == "1":
                                return
                            break  # long-poll timeout; re-ask
                        for body in SPOOL.iter_response_frames(r):
                            page = serde.deserialize_page(body)
                            st.hasher.update(body)
                            st.next_token += 1
                            # the retries bound one token's failures,
                            # not the stream's: a frame decoded, so the
                            # next token starts with all of them
                            attempt = 0
                            yield page
                        break
                except serde.PageWireError as e:
                    attempt += 1
                    if attempt > self.fetch_retries:
                        raise _TaskLost(
                            f"worker {st.uri} task {st.task_id}: corrupt "
                            f"page frame at token {st.next_token}: "
                            f"{e}") from e
                    self._sleep_backoff(attempt, deadline)
                except (urllib.error.URLError, ConnectionError,
                        OSError) as e:
                    self._raise_if_task_error(e, st.uri, st.task_id)
                    attempt += 1
                    if attempt > self.fetch_retries:
                        raise _TaskLost(
                            f"worker {st.uri} task {st.task_id}: page "
                            f"fetch failed after {self.fetch_retries} "
                            f"retries: {e}") from e
                    self._sleep_backoff(attempt, deadline)

    def _prefix_matches(self, uri: str, task_id: str, st: _TaskState,
                        deadline: Optional[float]) -> bool:
        """Whether a replayed placement regenerated the already-consumed
        page prefix byte for byte: dedupe by token is sound only for
        identical sequences. Deterministic fragments make a match the
        common case; the prefix re-fetch is cheap (spools keep every
        page). Raises _TaskLost(task_error=True) when the new task
        failed, and lets transport errors through after bounded
        retries so the recovery loop excludes this placement too."""
        h = hashlib.sha256()
        token = 0
        attempt = 0
        while token < st.next_token:
            check_deadline(deadline, "in the DCN prefix check")
            try:
                with CONNPOOL.request(
                    f"{uri}/v1/task/{task_id}/results/{token}"
                    f"?max={SPOOL.FETCH_WINDOW_BYTES}", timeout=60,
                ) as r:
                    if r.status == 204:
                        if r.headers.get("X-Done") == "1":
                            return False  # fewer pages than consumed
                        continue  # long-poll timeout; re-ask
                    for body in SPOOL.iter_response_frames(r):
                        h.update(body)
                        token += 1
                        if token >= st.next_token:
                            # frames past the consumed prefix are not
                            # part of the hash; closing the response
                            # discards them
                            break
                    attempt = 0
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                self._raise_if_task_error(e, uri, task_id)
                attempt += 1
                if attempt > self.fetch_retries:
                    raise
                self._sleep_backoff(attempt, deadline)
        return h.hexdigest() == st.hasher.hexdigest()

    def _release_task(self, uri: str, task_id: str) -> None:
        """DELETE one worker task's spools (reference: task expiry).
        A dead worker has nothing to free: counted, not raised."""
        try:
            with CONNPOOL.request(f"{uri}/v1/task/{task_id}",
                                  method="DELETE", timeout=5) as r:
                r.read()
        except (urllib.error.URLError, OSError, TimeoutError):
            self.runner.executor.release_skips += 1

    # ------------------------------------------------------ fault model
    def _exclude(self, uri: str) -> None:
        if uri not in self._excluded:
            self._excluded.add(uri)
            self.runner.executor.workers_excluded += 1

    def _alive_for_submit(self) -> List[str]:
        """The heartbeat-gated worker pool: nodes the detector marks
        FAILED are never picked (reference: NodeScheduler consulting the
        failure detector). State comes from the background detector's
        cache; the only pings on the query path are re-admission probes
        of excluded nodes, rate-limited per node to one per heartbeat
        interval. A node that died since the last tick is caught by the
        submit-failure recovery."""
        pool = []
        now = time.monotonic()
        for u in self.worker_uris:
            if u in self._excluded:
                # probed whatever the cached state says: a worker lost
                # mid-query is usually FAILED in the cache too, and one
                # restarted on the same uri must rejoin before the
                # background loop's next tick
                last = self._probe_at.get(u)
                if last is not None and \
                        now - last < self.heartbeat.interval_s:
                    continue  # probed recently and still excluded
                self._probe_at[u] = now
                if not self.heartbeat.probe(u):
                    continue
                self._excluded.discard(u)
                self._probe_at.pop(u, None)
            elif not self.heartbeat.is_alive(u):
                continue
            pool.append(u)
        return pool

    def _recover_task(self, st: _TaskState, pool: List[str],
                      retry_attempts: int, deadline: Optional[float],
                      cause: BaseException) -> None:
        """Re-dispatch one lost legacy task to a surviving ALIVE worker:
        the same fragment and split assignment (splitIndex/splitCount),
        a new taskId. The survivor re-generates the split share, and
        the fetch resumes at st.next_token once the new placement's
        prefix hashes equal. Raises DcnQueryFailed when retries are
        exhausted (or pinned off), no survivor remains, or the replayed
        prefix differs."""
        from presto_tpu_torch import events as E

        if not getattr(cause, "task_error", False):
            # node loss. A task failure on a healthy worker does not
            # exclude the node: re-dispatch is still tried, in case the
            # fault was environmental (device pressure)
            self._exclude(st.uri)
        while True:
            if st.retries_used >= retry_attempts:
                raise DcnQueryFailed(
                    f"worker {st.uri} task {st.task_id}: {cause} "
                    f"(task retries exhausted: "
                    f"task_retry_attempts={retry_attempts})") from cause
            # prefer a DIFFERENT worker: the failed placement's node
            # sorts last (it stays in the pool only for task_error)
            survivors = sorted((u for u in pool if u not in self._excluded),
                               key=lambda u: u == st.uri)
            if not survivors:
                raise DcnQueryFailed(
                    f"task {st.task_id}: no surviving workers to "
                    f"re-dispatch to (pool {pool}, all excluded)"
                ) from cause
            st.retries_used += 1
            self._sleep_backoff(st.retries_used, deadline)
            check_deadline(deadline, "in the DCN fetch loop")
            target = survivors[(st.retries_used - 1) % len(survivors)]
            base_id = st.payload["taskId"].split(".r", 1)[0]
            new_id = f"{base_id}.r{st.retries_used}"
            payload = dict(st.payload, taskId=new_id)
            from_uri = st.uri
            try:
                self._post_task(target, payload)
                prefix_ok = st.next_token == 0 or self._prefix_matches(
                    target, new_id, st, deadline)
            except (urllib.error.URLError, OSError) as e:
                # the survivor failed too: exclude it and go on (each
                # failed placement uses one retry)
                self._exclude(target)
                st.uri, cause = target, e
                continue
            except _TaskLost as e:
                # the re-dispatched task itself failed during the prefix
                # check
                st.uri, cause = target, e
                continue
            if not prefix_ok:
                raise DcnQueryFailed(
                    f"task {new_id}: the re-dispatched placement "
                    f"regenerated a DIFFERENT page sequence for the "
                    f"already-consumed prefix ({st.next_token} pages) — "
                    f"non-deterministic task output; failing loudly "
                    f"instead of silently skipping or duplicating rows"
                ) from cause
            st.uri, st.task_id, st.payload = target, new_id, payload
            ex = self.runner.executor
            ex.task_retries += 1
            tr = ex.trace
            if tr is not None:
                tr.complete("retry", new_id, tr.now(), tr.now(),
                            to=target, attempt=st.retries_used,
                            cause=str(cause)[:120])
                ex.trace_spans += 1
            E.dispatch(
                self.listeners, "task_retried", E.TaskRetryEvent(
                    query_id=base_id.split(".", 1)[0], task_id=new_id,
                    from_uri=from_uri, to_uri=target,
                    attempt=st.retries_used, cause=str(cause)[:400]),
                on_error=ex.count_listener_error)
            return

    # ----------------------------------------------------- stage DAG
    def _try_stage_dag(self, plan):
        """The plan cut into a stage DAG, or None when it is not worth
        or not safe to distribute."""
        from presto_tpu_torch.dist.fragmenter import fragment_dag

        return fragment_dag(self.runner.executor, plan,
                            self.runner.catalogs,
                            **self.runner.session_dist_options())

    def _execute_dag(self, dag):
        from presto_tpu_torch import obs as OBS
        from presto_tpu_torch.dist.scheduler import StageScheduler

        self.last_distribution = "stage-dag"
        ex = self.runner.executor
        if ex._plan_check_on():
            from presto_tpu_torch.exec import plan_check as PC

            PC.verify_dag(ex, dag)
        qid = uuid.uuid4().hex[:12]
        # lifecycle tracing: attach BEFORE constructing the scheduler
        # (it snapshots ex.trace); the root fragment's execute() records
        # into the same trace, so one timeline covers stages and drain
        trace = OBS.maybe_trace(self.runner.session, query_id=qid)
        if trace is not None:
            OBS.attach(ex, trace)
        sched = StageScheduler(self, dag, qid,
                               stage_hook=self._stage_hook)
        self.last_scheduler = sched
        try:
            rows = sched.run()
            self.last_output_names = sched.root_names
            return rows
        finally:
            if trace is not None:
                OBS.finalize(ex, trace,
                             self.runner.session.get("query_trace_dir"))
            self.runner.last_trace = trace

    # ---------------------------------------------------------- execute
    def execute(self, sql: str):
        plan = self.runner.plan(sql)
        ex = self.runner.executor
        retry_attempts = self._retry_attempts()
        # "true" forces the DAG for every plan it cuts; "auto" keeps
        # the legacy shapes first and engages the DAG only where they
        # would fall back to one process; "false" never uses it
        stage_mode = self.runner.session.get("stage_scheduler")
        if stage_mode == "true":
            dag = self._try_stage_dag(plan)
            if dag is not None:
                self.runner.apply_session()
                return self._execute_dag(dag)
        cut = find_partial_cut(plan)
        partial = partition_cols = split_table = None
        if cut is not None:
            # the PARTIAL/FINAL aggregation split: workers ship small
            # accumulator-state pages. The partitioned join first (both
            # big join sides co-partitioned by key hash), else the
            # round-robin split of the fact table (replicated builds)
            partition_cols = hash_fanout_plan(
                cut, self.runner.catalogs,
                partition_threshold=self.partition_threshold)
            split_table = largest_table(cut.source, self.runner.catalogs)
            if partition_cols is not None or (
                    split_table is not None
                    and fanout_safe(cut, split_table)):
                self.last_distribution = (
                    "hash" if partition_cols is not None
                    else "roundrobin")
                partial = dataclasses.replace(cut, step="partial")
        if partial is None:
            # the UNION cut: workers run the topmost row-local subtree
            # (multi-join pipelines, no aggregation needed) over their
            # split share; the coordinator unions the pages and runs
            # everything above (reference: a leaf-stage fragment under a
            # GATHER exchange)
            split_table = largest_table(plan, self.runner.catalogs)
            ucut = (find_union_cut(plan, split_table)
                    if split_table is not None else None)
            if ucut is None:
                if stage_mode == "auto":
                    # no legacy shape applies: the gap the stage DAG
                    # closes. With no ALIVE worker such a query still
                    # runs locally, as before the DAG existed
                    dag = self._try_stage_dag(plan)
                    if dag is not None and (
                            self._alive_for_submit()
                            if retry_attempts > 0 else self.worker_uris):
                        self.runner.apply_session()
                        return self._execute_dag(dag)
                # nothing distributable: run locally rather than wrong
                # (no pool computed: local queries never pay dead-node
                # probes)
                self.last_distribution = "local"
                self.last_pool = []
                res = self.runner.execute(sql)
                self.last_output_names = list(res.column_names)
                return res.rows
            partition_cols = hash_fanout_source(
                ucut, self.runner.catalogs,
                partition_threshold=self.partition_threshold)
            self.last_distribution = (
                "union-hash" if partition_cols is not None
                else "union-roundrobin")
            cut, partial = ucut, ucut
        # the coordinator's final stage honors the session the workers
        # were sent, and the query deadline starts here
        self.runner.apply_session()
        return self._execute_cut(sql, plan, cut, partial, split_table,
                                 partition_cols, retry_attempts)

    def _execute_cut(self, sql, plan, cut, partial, split_table,
                     partition_cols, retry_attempts):
        """Run one legacy cut: a task per pooled worker over its split
        share, then the coordinator's plan over a RemoteSource of their
        pages (FINAL over the state pages for an aggregation cut, the
        union as-is for a union cut)."""
        from presto_tpu_torch import obs as OBS

        ex = self.runner.executor
        deadline = ex.query_deadline
        # the plan IS distributable from here on, so workers are
        # mandatory. task_retry_attempts=0 pins the classic model:
        # every configured worker, the first failure fails the query
        pool = (self._alive_for_submit() if retry_attempts > 0
                else list(self.worker_uris))
        self.last_pool = list(pool)
        if not pool:
            raise DcnQueryFailed(f"no ALIVE workers among {self.worker_uris}")
        # the task body carries the SERIALIZED fragment (reference:
        # TaskUpdateRequest.fragment), not SQL to replay
        fragment = plan_serde.dumps(partial)
        qid = uuid.uuid4().hex[:12]
        trace = OBS.maybe_trace(self.runner.session, query_id=qid, sql=sql)
        if trace is not None:
            OBS.attach(ex, trace)
        tasks: List[_TaskState] = []
        key = f"dcn-{qid}"
        check_payloads = ex._plan_check_on()
        # the fleet cache probe, gated so the common miss is free (the
        # bloom summaries answer "definitely not cached" locally);
        # round-robin splits only
        sess = self.runner.session
        probe_on = (partition_cols is None and split_table is not None
                    and self.cache_index.known()
                    and bool(sess.get("result_cache_enabled"))
                    and bool(sess.get("result_cache_remote_probe")))
        try:
            for w, uri in enumerate(pool):
                payload = {
                    "taskId": f"{qid}.{w}",
                    "fragment": fragment,
                    "splitTable": split_table,
                    "splitIndex": w,
                    "splitCount": len(pool),
                    "session": self.session_props,
                }
                if trace is not None:
                    payload["trace"] = True
                if partition_cols is not None:
                    payload["splitMode"] = "hash"
                    payload["partitionColumns"] = partition_cols
                if check_payloads:
                    # a re-dispatch re-generates exactly this
                    # (splitIndex, splitCount) share on a survivor
                    from presto_tpu_torch.exec import plan_check as PC

                    PC.check_task_payload(payload)
                st = _TaskState(uri=uri, task_id=payload["taskId"],
                                payload=payload)
                d0 = trace.now() if trace is not None else 0.0
                hit_uri = (self._probe_cached_task(
                    partial, split_table, w, len(pool), st.task_id, pool)
                    if probe_on else None)
                if hit_uri is not None:
                    # a fleet member holds this split share's pages: no
                    # dispatch; the supplier fetches the parked finished
                    # task over the ordinary plane (a loss mid-fetch
                    # still recovers: the payload carries the fragment)
                    st.uri = hit_uri
                    ex.cache_remote_hits += 1
                    if trace is not None:
                        now = trace.now()
                        trace.complete("cache",
                                       f"remote-hit:{st.task_id}", now,
                                       now, uri=hit_uri)
                        ex.trace_spans += 1
                else:
                    try:
                        self._post_task(uri, payload)
                    except (urllib.error.URLError, OSError) as e:
                        if retry_attempts <= 0:
                            raise DcnQueryFailed(
                                f"worker {uri}: task submit failed: {e}"
                            ) from e
                        # submit retry: this split share goes to another
                        # ALIVE worker (which then runs two tasks)
                        self._recover_task(st, pool, retry_attempts,
                                           deadline, e)
                if trace is not None:
                    st.trace_t0 = d0
                    trace.complete("dispatch", st.task_id, d0,
                                   trace.now(), uri=st.uri)
                    ex.trace_spans += 1
                tasks.append(st)

            # the coordinator's plan: shipped subtree -> RemoteSource
            remote = P.RemoteSource(types=tuple(ex.output_types(partial)),
                                    key=key, origin=partial)
            if partial is cut:  # union cut: consume the union as-is
                coord_plan = _replace_node(plan, cut, remote)
            else:  # aggregation cut: FINAL over the state pages
                coord_plan = _replace_node(plan, cut, dataclasses.replace(
                    cut, step="final", source=remote))

            def supplier():
                for st in tasks:
                    # a fresh supplier call (the coordinator's boosted
                    # retry re-pulling the source) refetches from token
                    # 0, the workers keep every page; within ONE call
                    # next_token advances, so a re-dispatched task
                    # resumes at the consumed token
                    st.next_token = 0
                    st.hasher = hashlib.sha256()
                    f0 = trace.now() if trace is not None else 0.0
                    while True:
                        try:
                            yield from self._fetch_pages(st, deadline)
                            break
                        except _TaskLost as e:
                            if retry_attempts <= 0:
                                raise DcnQueryFailed(str(e)) from e
                            # worker death mid-query: exclude the node
                            # and re-run ONLY the lost split share on a
                            # survivor, resuming at the consumed token
                            self._recover_task(st, pool, retry_attempts,
                                               deadline, e)
                    if trace is not None:
                        trace.complete("fetch", st.task_id, f0,
                                       trace.now(), uri=st.uri,
                                       pages=st.next_token)
                        ex.trace_spans += 1
                        # one status poll per drained task ingests the
                        # worker's queue/run/attempt spans
                        ex.trace_spans += trace.ingest(
                            self._task_spans(st), trace.root,
                            st.trace_t0, trace.now())

            ex.remote_sources[key] = supplier
            names, rows = ex.execute(coord_plan)
            self.last_output_names = list(names)
            return rows
        finally:
            ex.remote_sources.pop(key, None)
            # release the workers' page buffers (task expiry)
            for st in tasks:
                self._release_task(st.uri, st.task_id)
            if trace is not None:
                OBS.finalize(ex, trace,
                             self.runner.session.get("query_trace_dir"))
            self.runner.last_trace = trace
