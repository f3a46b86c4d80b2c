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

Failure model: the reference's ``task_retry_attempts=0`` — all
configured workers, and the first task failure fails the query cleanly
with DcnQueryFailed, whatever the property says (task replay, the
heartbeat detector and the legacy agg/union/hash-fanout cuts are not
ported; ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
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


class DcnQueryFailed(RuntimeError):
    """Query-level failure: a task failed, a worker was lost, or no
    worker was configured."""


class _TaskLost(RuntimeError):
    """Internal: one task placement is gone (exhausted fetch retries,
    or — task_error=True — a worker-side task failure)."""

    def __init__(self, msg: str, task_error: bool = False):
        super().__init__(msg)
        self.task_error = task_error


@dataclasses.dataclass
class _TaskState:
    """One task placement being drained; `next_token` is the count of
    pages consumed so far."""

    uri: str
    task_id: str
    next_token: int = 0


class DcnRunner:
    """Coordinator over N workers. execute(sql) returns the row list;
    the last run's column names are in ``last_output_names``.
    ``device=None`` runs the coordinator's root fragment on the card."""

    def __init__(self, catalogs, worker_uris: List[str], *,
                 default_catalog: Optional[str] = None,
                 fetch_retries: int = 3,
                 session_props: Optional[Dict] = None,
                 device=None):
        from presto_tpu_torch.runner import LocalRunner

        self.worker_uris = list(worker_uris)
        self.fetch_retries = fetch_retries
        # introspection: "stage-dag" | "local" and the last scheduler
        self.last_distribution = "local"
        self.last_scheduler = None
        self.last_output_names: Optional[List[str]] = None
        self.session_props = dict(session_props or {})
        self._rng = random.Random()
        self.runner = LocalRunner(
            catalogs, default_catalog or next(iter(catalogs)),
            session=self.session_props, device=device)

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
        base = int(self.runner.session.get("retry_backoff_ms")) / 1000.0
        delay = min(base * (2 ** max(attempt - 1, 0)), 5.0)
        delay *= 0.5 + self._rng.random()
        if deadline is not None:
            delay = min(delay, max(deadline - time.monotonic(), 0.0))
        if delay > 0:
            time.sleep(delay)

    def _fetch_pages(self, st: _TaskState, deadline: Optional[float]):
        """Token-acked page fetch of partition 0 with bounded, backed-
        off retries (at-least-once + dedupe by token). Frames decode
        one at a time and the token advances per frame, so a retry
        resumes at the first unconsumed page. Raises _TaskLost when the
        placement is unreachable, a frame stays corrupt, or the task
        failed."""
        while True:
            attempt = 0
            while True:
                check_deadline(deadline, "in the DCN fetch loop")
                try:
                    with CONNPOOL.request(
                        f"{st.uri}/v1/task/{st.task_id}/results/"
                        f"{st.next_token}?max={SPOOL.FETCH_WINDOW_BYTES}",
                        timeout=60,
                    ) as r:
                        if r.status == 204:
                            if r.headers.get("X-Done") == "1":
                                return
                            break  # long-poll timeout; re-ask
                        for body in SPOOL.iter_response_frames(r):
                            page = serde.deserialize_page(body)
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

    def _release_task(self, uri: str, task_id: str) -> None:
        """DELETE one worker task's spools (reference: task expiry).
        A dead worker has nothing to free: counted, not raised."""
        try:
            with CONNPOOL.request(f"{uri}/v1/task/{task_id}",
                                  method="DELETE", timeout=5) as r:
                r.read()
        except (urllib.error.URLError, OSError, TimeoutError):
            self.runner.executor.release_skips += 1

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
        sched = StageScheduler(self, dag, qid)
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
