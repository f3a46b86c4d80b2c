"""DCN coordinator: multi-worker query execution over HTTP workers.

Port of presto_tpu/dist/dcn.py for its stage-DAG branch (reference: the
coordinator half of distributed execution —
server/remotetask/HttpRemoteTask.java for task create/status and
operator/ExchangeClient.java + HttpPageBufferClient.java for the
token-acked page fetch with retries).

``DcnRunner.execute(sql)`` plans the query, cuts it into a stage DAG
(dist/fragmenter.fragment_dag: gather / broadcast / hash-repartition
exchanges) and runs it through dist/scheduler.StageScheduler over the
configured workers (server/worker.WorkerServer). Every task payload
carries the SERIALIZED fragment (dist/plan_serde.py) and the session,
so all producers of one exchange route rows alike. A plan the DAG
refuses (nothing worth shipping, or not DAG-safe) runs locally.

Under ``plan_check`` the DAG verifies before any task dispatches
(exec/plan_check.verify_dag) and every task payload before its POST
(check_task_payload). Under ``query_trace_enabled`` or
``query_trace_dir`` one trace covers the stage DAG (stage, task,
dispatch and fetch spans, the workers' queue and run spans ingested
under their task) and the coordinator's root fragment.

Failure model: fault-tolerant task retry (reference: Project
Tardigrade's task-level retry), made cheap by deterministic fragments.
``task_retry_attempts`` > 0: a lost task re-dispatches to a surviving
ALIVE worker (dist/scheduler.py: a leaf re-generates its split share, a
non-leaf task re-reads the surviving upstream spools), and pages the
coordinator already consumed dedupe by fetch token once the new
placement's prefix is VERIFIED byte-identical (a rolling sha256 of the
consumed frames, `_prefix_matches`), so a non-deterministic replay
fails loudly instead of skipping or duplicating rows. The pool is
heartbeat-gated: a started HeartbeatFailureDetector
(server/heartbeat.py) pings every configured worker on a daemon thread,
nodes it marks FAILED are never picked, excluded nodes are re-probed at
most once per heartbeat interval and rejoin when a probe succeeds.
``task_retry_attempts=0`` pins the classic model end to end: every
configured worker is used and the first failure fails the query with
DcnQueryFailed. Recovery is counted on the coordinator executor
(``task_retries``, ``workers_excluded``, ``nonleaf_replays``) and
announced as TaskRetryEvent to the ``listeners``. ``close()`` stops the
detector's thread. The legacy agg/union/hash-fanout cuts are not
ported: the stage DAG is the only distributed plane.
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
from presto_tpu_torch.dist import serde
from presto_tpu_torch.dist import spool as SPOOL
from presto_tpu_torch.exec.executor import check_deadline
from presto_tpu_torch.server.heartbeat import HeartbeatFailureDetector


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
    """One task placement being drained. `next_token` is the count of
    pages consumed so far and `hasher` a rolling sha256 of their
    serialized bytes: a replayed placement resumes at next_token only
    after its regenerated prefix hashes equal."""

    uri: str
    task_id: str
    next_token: int = 0
    hasher: "hashlib._Hash" = dataclasses.field(
        default_factory=hashlib.sha256)


class DcnRunner:
    """Coordinator over N workers. execute(sql) returns the row list;
    the last run's column names are in ``last_output_names``.
    ``device=None`` runs the coordinator's root fragment on the card."""

    def __init__(self, catalogs, worker_uris: List[str], *,
                 default_catalog: Optional[str] = None,
                 fetch_retries: int = 3,
                 session_props: Optional[Dict] = None,
                 listeners=(),
                 device=None):
        from presto_tpu_torch.runner import LocalRunner

        self.worker_uris = list(worker_uris)
        self.fetch_retries = fetch_retries
        # introspection: "stage-dag" | "local", the last scheduler (its
        # per-stage pools and placements) and the heartbeat-gated pool
        # the last query started on
        self.last_distribution = "local"
        self.last_scheduler = None
        self.last_pool: List[str] = []
        self.last_output_names: Optional[List[str]] = None
        # test and fault-injection hooks: called with the fragment id
        # after each completed stage, and with the scheduler between
        # the last stage barrier and the root fragment's drain
        self._stage_hook = None
        self._root_hook = None
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
    def _post_task(self, uri: str, payload: Dict) -> Dict:
        # connpool never replays a POST on a reused socket — a task
        # submit reaches the worker at most once
        with CONNPOOL.request(
            f"{uri}/v1/task", method="POST",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, timeout=30,
        ) as resp:
            return json.loads(resp.read().decode())

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
        dag = self._try_stage_dag(plan)
        if dag is None:
            # nothing distributable: run locally rather than wrong
            self.last_distribution = "local"
            res = self.runner.execute(sql)
            self.last_output_names = list(res.column_names)
            return res.rows
        # anchors the query deadline (query_max_run_time) at the start
        self.runner.apply_session()
        return self._execute_dag(dag)
