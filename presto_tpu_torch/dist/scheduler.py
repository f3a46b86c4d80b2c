"""Stage-DAG scheduler: walk a fragmented plan DAG in dependency order
and dispatch it task-by-task across the DCN worker pool, with every
inter-stage exchange SPOOLED on the producing worker.

Port of presto_tpu/dist/scheduler.py (reference: presto-main
execution/scheduler/SqlQueryScheduler.java — stage-by-stage scheduling
over PlanFragment DAGs). Each stage runs to completion (a barrier)
before its consumers dispatch; a consumer task fetches its input
partitions worker-to-worker from the upstream spools (or, for a
same-process producer, takes the spooled Pages directly); the
coordinator executes the DAG's root fragment over the final stages.

Tracing: when the coordinator's executor carries a trace, each stage
is a ``stage`` span, each task a ``task`` span with its ``dispatch``
POST inside and the worker's ``queue``/``run``/``attempt`` spans
ingested under it (clamped to its window), and each root-stage drain a
``fetch`` span. Under ``plan_check`` every payload is checked before
its POST.

Failure model: the reference's ``task_retry_attempts=0`` one — all
configured workers, the first task failure fails the query cleanly
with DcnQueryFailed, whatever the property says. Replay of lost tasks
from surviving spools, straggler speculation, adaptive re-planning,
the mesh plane, the fleet cache probe and checkpoints are not ported
(ROADMAP queue 1). Consumed input partitions are acked (released) as
soon as their consumer stage completes.
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.error
from typing import Dict, List, Optional

from presto_tpu_torch.dist import connpool as CONNPOOL
from presto_tpu_torch.dist import plan_serde
from presto_tpu_torch.dist import spool as SPOOL
from presto_tpu_torch.dist.fragmenter import (
    StageDag,
    clip_for_shipping,
    stage_key,
)
from presto_tpu_torch.exec.executor import check_deadline

_NO_REPLAY = ("the replay plane (re-dispatch of lost tasks from "
              "surviving spools) is not ported")


@dataclasses.dataclass
class _Placement:
    uri: str
    task_id: str


@dataclasses.dataclass
class _SchedTask:
    """One logical task of one stage and its placement."""

    fid: int
    index: int
    base_id: str                      # qid.f<fid>.t<index>
    placement: Optional[_Placement] = None
    done: bool = False
    span: object = None  # the trace span of this task


class StageScheduler:
    """Schedules one StageDag over a DcnRunner's worker pool."""

    def __init__(self, coord, dag: StageDag, qid: str):
        self.coord = coord
        self.dag = dag
        self.qid = qid
        self.ex = coord.runner.executor
        # the DcnRunner attaches the trace to the coordinator executor
        # BEFORE constructing the scheduler; None = tracing off
        self.trace = self.ex.trace
        # shipped blobs carry only the origin chains type resolution
        # needs (clip_for_shipping)
        self._frag_blob: Dict[int, str] = {
            f.fid: plan_serde.dumps(clip_for_shipping(f.root))
            for f in dag.fragments
        }
        self.tasks: Dict[int, List[_SchedTask]] = {}
        self._ntasks: Dict[int, int] = {}
        self.root_names: Optional[List[str]] = None

    def _fail(self, what: str, cause: Optional[BaseException] = None):
        from presto_tpu_torch.dist.dcn import DcnQueryFailed

        raise DcnQueryFailed(f"{what} ({_NO_REPLAY})") from cause

    def _pool(self) -> List[str]:
        pool = list(self.coord.worker_uris)
        if not pool:
            self._fail("no workers configured (stage-DAG scheduler)")
        return pool

    def _consumer_tasks(self, fid: int) -> int:
        """Spool partition count of a repartition edge = the consumer
        stage's task count (consumer task t reads partition t)."""
        for f in self.dag.fragments:
            if fid in f.inputs:
                return self._ntasks[f.fid]
        return 1  # the root consumer (always a gather)

    def _payload_for(self, t: _SchedTask, task_id: str) -> Dict:
        frag = self.dag.fragment(t.fid)
        payload: Dict = {
            "taskId": task_id,
            "fragment": self._frag_blob[t.fid],
            "splitIndex": t.index,
            "splitCount": self._ntasks[t.fid],
            "session": self.coord.session_props,
        }
        if frag.split_table is not None:
            payload["splitTable"] = frag.split_table
        if self.trace is not None:
            # workers record queue/run/attempt spans and ship them on
            # the status plane for the cross-node timeline
            payload["trace"] = True
        if frag.output_kind == "repartition":
            payload["outputPartitions"] = self._consumer_tasks(t.fid)
            payload["outputKeys"] = list(frag.output_keys)
        else:
            # gather / broadcast: ONE spool partition per task
            payload["outputPartitions"] = 1
        if frag.inputs:
            payload["sources"] = {}
            for u in frag.inputs:
                spec: Dict = {"tasks": [
                    {"uri": ut.placement.uri,
                     "taskId": ut.placement.task_id}
                    for ut in self.tasks[u]]}
                up_kind = self.dag.fragment(u).output_kind
                spec["partition"] = t.index if up_kind == "repartition" \
                    else 0
                payload["sources"][stage_key(u)] = spec
        return payload

    def _post(self, uri: str, payload: Dict) -> None:
        if self.ex._plan_check_on():
            from presto_tpu_torch.exec import plan_check as PC

            PC.check_task_payload(payload)
        self.coord._post_task(uri, payload)

    def _status(self, pl: _Placement) -> Dict:
        last: Optional[BaseException] = None
        for _ in range(2):
            try:
                with CONNPOOL.request(f"{pl.uri}/v1/task/{pl.task_id}",
                                      timeout=5) as r:
                    return json.loads(r.read().decode())
            except (urllib.error.URLError, ConnectionError,
                    OSError) as e:
                last = e
                time.sleep(0.05)
        self._fail(f"worker {pl.uri} lost while running task "
                   f"{pl.task_id}: {last}", last)

    def _delete(self, pl: _Placement) -> None:
        self.coord._release_task(pl.uri, pl.task_id)

    # -------------------------------------------------- run the DAG
    def run(self) -> list:
        """Execute the DAG; returns the materialized row list."""
        dag, ex = self.dag, self.ex
        pool = self._pool()
        for f in dag.fragments:
            self._ntasks[f.fid] = len(pool) if f.sharded else 1
            self.tasks[f.fid] = [
                _SchedTask(fid=f.fid, index=i,
                           base_id=f"{self.qid}.f{f.fid}.t{i}")
                for i in range(self._ntasks[f.fid])
            ]
        try:
            for f in dag.fragments:
                self._run_stage(f.fid, pool)
            # coordinator-side root fragment over the final stages
            for fid in dag.root_inputs:
                ex.remote_sources[stage_key(fid)] = \
                    self._root_supplier(fid)
            names, rows = ex.execute(dag.root)
            self.root_names = list(names or [])
            return rows
        finally:
            for fid in dag.root_inputs:
                ex.remote_sources.pop(stage_key(fid), None)
            # release worker-side spools (task expiry)
            for ts in self.tasks.values():
                for t in ts:
                    if t.placement is not None:
                        self._delete(t.placement)

    def _run_stage(self, fid: int, pool: List[str]) -> None:
        stage = self.tasks[fid]
        tr = self.trace
        sspan = None
        if tr is not None:
            sspan = tr.begin("stage", f"stage{fid}", tasks=len(stage),
                             pool=len(pool))
            self.ex.trace_spans += 1
        for t in stage:
            target = pool[t.index % len(pool)]
            payload = self._payload_for(t, t.base_id)
            if tr is not None:
                t.span = tr.begin("task", t.base_id, parent=sspan,
                                  uri=target)
                self.ex.trace_spans += 1
            d0 = tr.now() if tr is not None else 0.0
            try:
                self._post(target, payload)
            except (urllib.error.URLError, OSError) as e:
                self._fail(f"worker {target}: task submit failed: {e}", e)
            t.placement = _Placement(target, t.base_id)
            if tr is not None:
                tr.complete("dispatch", t.base_id, d0, tr.now(),
                            parent=t.span, uri=target)
                self.ex.trace_spans += 1
        self.ex.stages_scheduled += 1
        self._wait(stage)
        if tr is not None:
            tr.end(sspan)
        self._ack_inputs(fid)

    def _wait(self, stage: List[_SchedTask]) -> None:
        # status polls back off geometrically (20 ms -> 250 ms cap)
        delay = 0.02
        while True:
            check_deadline(self.ex.query_deadline, "at a stage barrier")
            progressed = False
            for t in stage:
                if not t.done:
                    self._poll_task(t)
                    progressed = progressed or t.done
            if all(t.done for t in stage):
                return
            delay = 0.02 if progressed else min(delay * 1.5, 0.25)
            time.sleep(delay)

    def _poll_task(self, t: _SchedTask) -> None:
        st = self._status(t.placement)
        if st["state"] == "FINISHED":
            t.done = True
            self.ex.spooled_exchange_pages += int(
                st.get("spooledPages") or 0)
            self.ex.spooled_exchange_rows += sum(st.get("spoolRows") or [])
            tr = self.trace
            if tr is not None and t.span is not None:
                # the worker's spans (offsets from ITS task creation)
                # nest into this task's window, clamped so clock or
                # queue skew never yields a negative interval
                remote = st.get("spans") or []
                if remote:
                    self.ex.trace_spans += tr.ingest(
                        remote, t.span, t.span.t0, tr.now())
                tr.end(t.span, spooled=int(st.get("spooledPages") or 0),
                       uri=t.placement.uri)
        elif st["state"] == "FAILED":
            self._fail(f"stage task {t.placement.task_id} on "
                       f"{t.placement.uri} FAILED: {st.get('error')}")

    def _ack_inputs(self, fid: int) -> None:
        """The consumer stage is done: release the input partitions it
        read (nothing replays them)."""
        for u in self.dag.fragment(fid).inputs:
            parts = range(self._consumer_tasks(u)
                          if self.dag.fragment(u).output_kind
                          == "repartition" else 1)
            for ut in self.tasks[u]:
                for part in parts:
                    SPOOL.ack_spool(ut.placement.uri,
                                    ut.placement.task_id, part)

    # --------------------------------------------- root-stage drain
    def _root_supplier(self, fid: int):
        from presto_tpu_torch.dist.dcn import _TaskLost, _TaskState

        stage = self.tasks[fid]

        def supplier():
            tr = self.trace
            for t in stage:
                f0 = tr.now() if tr is not None else 0.0
                # mesh-local fast path: a same-process placement's
                # spool serves its Pages directly
                local = SPOOL.local_source_pages(
                    t.placement.uri, t.placement.task_id, 0)
                if local is not None:
                    self.ex.count_mesh_local()
                    npages = 0
                    for page in local:
                        npages += 1
                        yield page
                    if tr is not None:
                        tr.complete("fetch", t.placement.task_id, f0,
                                    tr.now(), pages=npages,
                                    uri=t.placement.uri, local=True)
                        self.ex.trace_spans += 1
                    continue
                st = _TaskState(uri=t.placement.uri,
                                task_id=t.placement.task_id)
                try:
                    yield from self.coord._fetch_pages(
                        st, self.ex.query_deadline)
                except _TaskLost as e:
                    self._fail(str(e), e)
                if tr is not None:
                    # root-parented: the drain runs after the task span
                    # closed, so a fetch child would escape its parent
                    tr.complete("fetch", t.placement.task_id, f0,
                                tr.now(), pages=st.next_token,
                                uri=t.placement.uri)
                    self.ex.trace_spans += 1

        return supplier
