"""Stage-DAG scheduler: walk a fragmented plan DAG in dependency order
and dispatch it task-by-task across the DCN worker pool, with every
inter-stage exchange SPOOLED on the producing worker.

Port of presto_tpu/dist/scheduler.py (reference: presto-main
execution/scheduler/SqlQueryScheduler.java — stage-by-stage scheduling
over PlanFragment DAGs — crossed with Project Tardigrade's
fault-tolerant execution). Stages run to completion (a barrier) and
publish their output into spools on the producing workers
(server/worker._TaskSpool), so recovery is a SCHEDULER POLICY:

  - a lost LEAF task re-generates its split share on a survivor;
  - a lost NON-LEAF task replays on a survivor by re-reading its input
    partitions from the surviving upstream spools (`nonleaf_replays`);
  - a dead node also invalidates the spools it hosted: every task it
    ran whose output is still NEEDED (by an unfinished consumer stage,
    or by the coordinator until the query ends) replays in topological
    order, and consumers long-poll the replacement spools;
  - straggler SPECULATION (`speculation_enabled`) races a copy of a
    stage's last running task on another worker and keeps whichever
    placement finishes first (`speculative_tasks_won/lost`): fragments
    are deterministic, so both copies spool the same pages and the
    loser is cancelled;
  - the pool is recomputed per STAGE (DcnRunner._alive_for_submit), so
    an excluded node whose heartbeat recovers rejoins at the next stage
    boundary of the same query.

The coordinator executes the DAG's root fragment over the final stages:
a same-process placement's spool serves its Pages directly, any other
is drained by the token-dedupe fetch (dcn._fetch_pages) whose replay
resumes after a sha256-verified prefix, so a node lost during the final
drain recovers the same way. With ``task_retry_attempts=0`` all
configured workers are used, the first failure fails the query, and
consumed input partitions are acked (released) as soon as their
consumer stage completes; otherwise spools live until the query ends,
as replay inputs.

Adaptive execution (``adaptive_execution``, adaptive/): after each
stage barrier the completed stage's exact spool statistics (the
workers' status bodies) feed the Replanner, which may mutate the
not-yet-dispatched fragments and the root; a mutated fragment is
serialized again before it ships.

Tracing: when the coordinator's executor carries a trace, each stage
is a ``stage`` span, each task a ``task`` span with its ``dispatch``
POST inside, the workers' ``queue``/``run``/``attempt`` spans ingested
under it (clamped to its window), recovery as ``retry`` and
``speculate`` spans, each re-plan a ``replan`` span and each root-stage
drain a ``fetch`` span. Under ``plan_check`` every payload is checked
before its POST.

Checkpoints: with a ``checkpoint_handle`` on the coordinator
(dist/checkpoint.QueryCheckpoint), each stage barrier journals its
placements and re-dispatchable payloads, the root's registration its
fragment and input stages, and each HTTP-drained root input its
consumed token and prefix digest; a failed barrier write is counted in
``checkpoint_drops`` and the query runs on.

The fleet cache probe (dist/cacheprobe.py): before a leaf task of a
split fragment whose output is not repartitioned is dispatched, the
worker whose bloom summary may hold its fragment key is asked to serve
it from its result cache; on a hit the task is placed and done with no
dispatch (``cache_remote_hits``).

The ICI exchange plane (``mesh_exchange_mode``, auto by default): a
repartition edge whose whole dispatch pool runs in this process, with a
power-of-two consumer task count a process mesh can hold, is decided
mesh-eligible before its stage dispatches. Its producers spool their
RAW pages to one partition (the ``meshExchange`` payload flag); after
the stage barrier the coordinator runs dist/executor.ici_exchange_pages
over them and parks the partition pages in one synthetic finished task
that every consumer reads over the unchanged spool data plane
(``ici_exchanges``, ``ici_bytes``). Any failure falls back LOUDLY —
counted in ``mesh_exchange_fallbacks`` and logged — to the spool
partitioner with the same routing function, so the fallback's
partitions equal the collective's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import urllib.error
from typing import Dict, List, Optional

from presto_tpu_torch import events as E
from presto_tpu_torch.dist import connpool as CONNPOOL
from presto_tpu_torch.dist import plan_serde
from presto_tpu_torch.dist import spool as SPOOL
from presto_tpu_torch.dist.fragmenter import (
    StageDag,
    clip_for_shipping,
    stage_key,
)
from presto_tpu_torch.exec.executor import check_deadline


@dataclasses.dataclass
class _Placement:
    uri: str
    task_id: str


@dataclasses.dataclass
class _SchedTask:
    """One logical task of one stage and its current placement."""

    fid: int
    index: int
    base_id: str                      # qid.f<fid>.t<index>
    placement: Optional[_Placement] = None
    done: bool = False
    # spooled pages counted once per LOGICAL task: a replay republishes
    # the same spool, not new volume
    counted: bool = False
    retries: int = 0
    dispatched_at: float = 0.0
    wall: float = 0.0
    spec: Optional[_Placement] = None  # speculation copy in flight
    spec_count: int = 0
    span: object = None  # the trace span of this logical task
    # the last status body (the spool-stats plane the re-planner sums)
    status: Optional[Dict] = None


class _NodeDown(RuntimeError):
    pass


def _source_lost_uri(msg: str) -> Optional[str]:
    """The upstream uri of a ``[source-lost <uri> <task>]`` marker
    (dist/spool.SourceLost), or None."""
    if "[source-lost " not in msg:
        return None
    return msg.split("[source-lost ", 1)[1].split()[0] or None


class StageScheduler:
    """Schedules one StageDag over a DcnRunner's worker pool."""

    def __init__(self, coord, dag: StageDag, qid: str, stage_hook=None):
        self.coord = coord
        self.dag = dag
        self.qid = qid
        self.ex = coord.runner.executor
        # the DcnRunner attaches the trace to the coordinator executor
        # BEFORE constructing the scheduler; None = tracing off
        self.trace = self.ex.trace
        # called with the fragment id after each completed stage
        # (deterministic mid-query fault injection)
        self.stage_hook = stage_hook
        # the pool each stage dispatched over
        self.stage_pools: List[List[str]] = []
        # shipped blobs carry only the origin chains type resolution
        # needs (clip_for_shipping)
        self._frag_blob: Dict[int, str] = {
            f.fid: plan_serde.dumps(clip_for_shipping(f.root))
            for f in dag.fragments
        }
        self.tasks: Dict[int, List[_SchedTask]] = {}
        self._ntasks: Dict[int, int] = {}
        self._root_done = False
        self.root_names: Optional[List[str]] = None
        # the partition count each dispatched producer spooled (a
        # broadcast read of a flipped edge names every one), and the
        # workers' boost and skew tallies, settled onto the coordinator
        # counters AFTER the root execute (which resets per-query
        # gauges)
        self._spooled_parts: Dict[int, int] = {}
        self._worker_tally = {"boostRetries": 0, "skewPreempted": 0}
        self.replanner = None  # set by run() when adaptive is on
        # the ICI exchange plane: producer fids whose repartition edge
        # lowers to the mesh all_to_all, the synthetic finished-task
        # placement holding each one's partition pages, and the
        # coordinator-built stage stats the re-planner reads in place
        # of the (raw, unpartitioned) worker spool stats
        self._mesh_fids: set = set()
        self._mesh_placement: Dict[int, _Placement] = {}
        self._mesh_stats: Dict[int, object] = {}
        # the fleet cache probe: deserialized fragment roots for the
        # coordinator-side key, one loads() per fragment, not per task
        self._probe_roots: Dict[int, object] = {}

    # ------------------------------------------------------ plumbing
    def _retry_attempts(self) -> int:
        return self.coord._retry_attempts()

    def _deadline(self) -> Optional[float]:
        return self.ex.query_deadline

    def _check_deadline(self) -> None:
        check_deadline(self._deadline(), "at a stage barrier")

    def _pool(self) -> List[str]:
        from presto_tpu_torch.dist.dcn import DcnQueryFailed

        # task_retry_attempts=0 pins the classic model: every
        # configured worker, no heartbeat gate
        pool = (self.coord._alive_for_submit()
                if self._retry_attempts() > 0
                else list(self.coord.worker_uris))
        if not pool:
            raise DcnQueryFailed(
                f"no ALIVE workers among {self.coord.worker_uris} "
                f"(stage-DAG scheduler)")
        return pool

    def _consumer_tasks(self, fid: int) -> int:
        """Spool partition count of a repartition edge = the consumer
        stage's task count (consumer task t reads partition t)."""
        for f in self.dag.fragments:
            if fid in f.inputs:
                return self._ntasks[f.fid]
        return 1  # the root consumer (always a gather)

    # ------------------------------------------- ICI exchange plane
    def _mesh_eligible(self, fid: int, pool: List[str]) -> bool:
        """Whether this stage's repartition edge lowers to the ICI
        all_to_all plane: auto/true = only when the whole dispatch pool
        runs in THIS process (the coordinator's collective reads the
        spools in place and the consumers read its output in place) and
        the consumer task count maps onto a process mesh. Any miss is a
        shape, not an error: the stage keeps the spooled plane."""
        from presto_tpu_torch.dist import executor as DX
        from presto_tpu_torch.server import worker as W

        if self.coord.runner.session.get("mesh_exchange_mode") == "false":
            return False
        frag = self.dag.fragment(fid)
        if frag.output_kind != "repartition" or not frag.output_keys:
            return False
        if not frag.sharded:
            return False
        # the partition count's half of the exchange's shape gate (the
        # pages' half waits for the pages, after the barrier)
        if not DX.ici_exchange_supported(self._consumer_tasks(fid), ()):
            return False
        return all(W.local_runtime(uri) is not None for uri in pool)

    def _run_mesh_exchange(self, fid: int) -> None:
        """After the stage barrier: collect the producers' RAW pages
        straight out of their same-process spools, run the all_to_all
        partitioning, and park the partition pages in ONE synthetic
        finished task on the first producer's runtime — consumers read
        partition t.index from it over the unchanged spool data plane.
        A failure falls back LOUDLY (counted, logged) to the spool
        partitioner with the same routing function."""
        from presto_tpu_torch.adaptive import StageStats
        from presto_tpu_torch.dist import executor as DX
        from presto_tpu_torch.exec.pagestore import page_bytes
        from presto_tpu_torch.server import worker as W

        ex = self.ex
        keys = tuple(self.dag.fragment(fid).output_keys)
        nparts = self._consumer_tasks(fid)
        pages, owner = [], []
        for ti, t in enumerate(self.tasks[fid]):
            it = SPOOL.local_source_pages(t.placement.uri,
                                          t.placement.task_id, 0)
            if it is None:
                # eligibility pinned every pool member local and a
                # replay lands back on the same pool: a missing local
                # spool is a hard error, not a fallback
                raise RuntimeError(
                    f"mesh exchange: producer spool for stage {fid} not "
                    f"local at {t.placement.uri}")
            for page in it:
                pages.append(page)
                owner.append(ti)
        total_bytes = sum(page_bytes(p) for p in pages)
        ici = False
        try:
            landed, nbytes, counts = DX.ici_exchange_pages(ex, pages, keys,
                                                           nparts)
            ex.ici_exchanges += 1
            ex.ici_bytes += nbytes
            ici = True
            # partition p's pages are the non-empty landings, page order
            parts = [list(zip(landed[p], [int(c[p]) for c in counts
                                          if c[p]]))
                     for p in range(nparts)]
        except Exception as e:  # noqa: BLE001 - the loud fallback below
            ex.mesh_exchange_fallbacks += 1
            logging.getLogger("presto_tpu_torch.dist").warning(
                "mesh exchange for stage %d fell back to the spool "
                "partitioner: %r", fid, e)
            parts, counts = self._spool_partition(pages, keys, nparts)
        # host budget 0 = never demote: the landing capacities already
        # bound residency, and a demotion would serialize behind the
        # plane's zero-crossing contract
        spool = W._TaskSpool(nparts, 0)
        for p in range(nparts):
            for page, rows in parts[p]:
                spool.put_page(p, page, rows=rows)
        uri = self.tasks[fid][0].placement.uri
        task_id = f"{self.qid}.f{fid}.mesh"
        W.local_runtime(uri).register_finished_task(task_id, spool)
        self._mesh_placement[fid] = _Placement(uri, task_id)
        # stage stats for the re-planner, the spool plane's for the same
        # stage: exact rows from the settled counts, the trimmed
        # partition pages' bytes; ici_bytes > 0 marks the freight as
        # mesh-resident for the broadcast-flip cost model
        # (adaptive/replanner.py)
        rows, part_bytes, wire = spool.part_stats()
        task_rows = [0] * len(self.tasks[fid])
        for ti, c in zip(owner, counts):
            task_rows[ti] += int(c.sum())
        self._mesh_stats[fid] = StageStats(
            fid=fid, rows=sum(rows), bytes=sum(part_bytes),
            part_rows=tuple(rows), part_bytes=tuple(part_bytes),
            task_rows=tuple(task_rows), wire_bytes=sum(wire),
            ici_bytes=total_bytes if ici else 0)

    def _spool_partition(self, pages, keys, nparts):
        """The mesh exchange's fallback: the spool partitioner over the
        raw pages, with the routing function the ICI plane would use.
        The coordinator owns this exchange, so the partitioner's
        deferred overflow flags settle HERE: each overflowing round
        re-partitions everything one ladder rung up. Returns the
        partition pages as ``parts[p] = [(page, rows), ...]`` and the
        [pages, nparts] row counts."""
        from presto_tpu_torch.dist import executor as DX
        from presto_tpu_torch.exec import shapes as SH

        ex = self.ex
        k4 = DX.ici_routes_with_k4(ex)
        boost0 = ex._capacity_boost
        try:
            while True:
                n0 = len(ex._pending_overflow)
                parts = [[] for _ in range(nparts)]
                counts = []
                for page in pages:
                    pp, c = SPOOL.device_partition_pages(
                        ex, page, keys, nparts, with_counts=True, k4=k4)
                    counts.append(c)
                    for p, part_page in pp:
                        rows = int(c[p])
                        if rows:
                            parts[p].append((SPOOL.trim_partition_page(
                                part_page, rows), rows))
                flags = ex._pending_overflow[n0:]
                del ex._pending_overflow[n0:]
                if not any(bool(f) for f in flags):
                    return parts, counts
                ex._capacity_boost = SH.next_boost(ex._capacity_boost)
                ex.capacity_boost_retries += 1
                if ex._capacity_boost > SH.DEVICE_FAULT_ROWS:
                    raise RuntimeError(
                        "mesh-exchange fallback overflow did not settle "
                        "on the boost ladder")
        finally:
            ex._capacity_boost = boost0

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
        if t.fid in self._mesh_fids:
            # the ICI plane: the producer spools its RAW pages to ONE
            # partition and the coordinator partitions them after the
            # stage barrier — no hashing, no P-way compaction and no
            # spool-stats pull on the worker
            payload["outputPartitions"] = 1
            payload["meshExchange"] = True
        elif frag.output_kind == "repartition":
            payload["outputPartitions"] = self._consumer_tasks(t.fid)
            payload["outputKeys"] = list(frag.output_keys)
        else:
            # gather / broadcast / adaptive passthrough: ONE spool
            # partition per task
            payload["outputPartitions"] = 1
        self._spooled_parts.setdefault(
            t.fid, int(payload["outputPartitions"]))
        if self.dag.hints.get(t.fid, {}).get("skew"):
            # the upstream spool histogram showed a hot partition: the
            # worker's joins start in the position-chunked rebalance
            payload["skewHint"] = True
        if frag.inputs:
            # sources rebuilt from CURRENT placements at every
            # (re)dispatch: a replayed consumer reads the replacement
            # spools, not the dead node's
            payload["sources"] = {}
            for u in frag.inputs:
                read = self.dag.read_kind(t.fid, u)
                tasks = [{"uri": ut.placement.uri,
                          "taskId": ut.placement.task_id}
                         for ut in self.tasks[u]]
                spec: Dict = {"tasks": tasks}
                up_kind = self.dag.fragment(u).output_kind
                if (u in self._mesh_placement and up_kind == "repartition"
                        and read == "repartition"):
                    # a mesh-lowered producer: every consumer task reads
                    # its partition from the ONE synthetic task the
                    # all_to_all landed
                    mp = self._mesh_placement[u]
                    spec["tasks"] = [{"uri": mp.uri,
                                      "taskId": mp.task_id}]
                    spec["partition"] = t.index
                elif up_kind == "repartition" and read == "broadcast":
                    # adaptive flip: draining every spooled partition of
                    # every producer task reads the whole build
                    spec["partitions"] = list(range(
                        self._spooled_parts.get(u) or 1))
                elif up_kind == "passthrough":
                    # consumer task t reads producer task t only (both
                    # stages shard over the same pool)
                    spec["partition"] = 0
                    spec["tasks"] = [tasks[t.index]]
                elif up_kind == "repartition":
                    spec["partition"] = t.index
                else:
                    spec["partition"] = 0
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
        raise _NodeDown(f"{pl.uri}: {last}")

    def _delete(self, pl: _Placement) -> None:
        self.coord._release_task(pl.uri, pl.task_id)

    # ----------------------------------------------------- adaptive
    def _adaptive_on(self) -> bool:
        """auto = on under the stage scheduler (the stage barrier is
        where re-planning costs least); false = off; true = auto."""
        return self.coord.runner.session.get("adaptive_execution") \
            != "false"

    def _make_replanner(self):
        from presto_tpu_torch.adaptive import Replanner

        opts = self.coord.runner.session_dist_options()
        return Replanner(
            self.ex, self.dag,
            broadcast_rows=opts.get("broadcast_rows"),
            broadcast_bytes=opts.get("broadcast_bytes"),
            max_replans=int(self.coord.runner.session.get(
                "adaptive_max_replans")))

    def _stage_stats(self, fid: int):
        from presto_tpu_torch.adaptive import stats_from_statuses

        if fid in self._mesh_stats:
            # a mesh-lowered stage: the workers spooled RAW pages with
            # no per-partition stats; the exchange's settled counts,
            # read on the coordinator, stand in
            return self._mesh_stats[fid]
        bodies = [t.status for t in self.tasks[fid]
                  if t.status is not None]
        if len(bodies) != len(self.tasks[fid]):
            return None
        return stats_from_statuses(fid, bodies)

    def _maybe_replan(self, fid: int, dispatched) -> None:
        """The stage-boundary barrier: the just-completed stage's exact
        spool stats feed the re-planner, which may mutate the
        not-yet-dispatched DAG suffix (re-verified, or rolled back and
        counted). Mutated fragments serialize again, so every later
        dispatch ships the re-planned tree."""
        rp = self.replanner
        st = self._stage_stats(fid)
        if st is not None:
            rp.observe(st)
        tr = self.trace
        t0 = tr.now() if tr is not None else 0.0
        outcome = rp.replan(dispatched)
        if outcome is None:
            return
        if outcome.rejected:
            self.ex.adaptive_replan_rejected += 1
        else:
            self.ex.adaptive_replans += 1
            self.ex.adaptive_dist_flips += outcome.dist_flips
            self.ex.adaptive_capacity_seeds += outcome.capacity_seeds
            for mfid in outcome.mutated_fids:
                self._frag_blob[mfid] = plan_serde.dumps(
                    clip_for_shipping(self.dag.fragment(mfid).root))
        if tr is not None:
            tr.complete("replan", f"stage{fid}", t0, tr.now(),
                        rejected=outcome.rejected,
                        flips=outcome.dist_flips,
                        seeds=outcome.capacity_seeds,
                        skew_hints=outcome.skew_hints,
                        reason=outcome.reason[:120])
            self.ex.trace_spans += 1

    # -------------------------------------------------- run the DAG
    def run(self) -> list:
        """Execute the DAG; returns the materialized row list."""
        dag, ex = self.dag, self.ex
        pool0 = self._pool()
        self.coord.last_pool = list(pool0)
        for f in dag.fragments:
            self._ntasks[f.fid] = len(pool0) if f.sharded else 1
            self.tasks[f.fid] = [
                _SchedTask(fid=f.fid, index=i,
                           base_id=f"{self.qid}.f{f.fid}.t{i}")
                for i in range(self._ntasks[f.fid])
            ]
        if self._adaptive_on():
            self.replanner = self._make_replanner()
        dispatched: set = set()
        ckpt = self.coord.checkpoint_handle
        try:
            for f in dag.fragments:
                self._run_stage(f.fid)
                dispatched.add(f.fid)
                if self.stage_hook is not None:
                    self.stage_hook(f.fid)
                if self.replanner is not None:
                    self._maybe_replan(f.fid, dispatched)
                if ckpt is not None:
                    # the spooled-stage barrier: placements and their
                    # re-dispatchable payloads, rebuilt from CURRENT
                    # placements, so a restarted coordinator re-POSTs
                    # exactly what a live replay would
                    self._checkpoint_stage(ckpt, f.fid)
            if ckpt is not None:
                self._checkpoint_root(ckpt)
            self._pre_root_hook()
            # coordinator-side root fragment over the final stages
            for fid in dag.root_inputs:
                ex.remote_sources[stage_key(fid)] = \
                    self._root_supplier(fid)
            names, rows = ex.execute(dag.root)
            self.root_names = list(names or [])
            self._root_done = True
            # worker-side ladder outcomes, settled AFTER execute()
            # (which resets the gauges): the query's total
            ex.capacity_boost_retries += self._worker_tally["boostRetries"]
            ex.skew_preempted += self._worker_tally["skewPreempted"]
            return rows
        finally:
            for fid in dag.root_inputs:
                ex.remote_sources.pop(stage_key(fid), None)
            # release worker-side spools (task expiry); skips on dead
            # workers are counted
            for ts in self.tasks.values():
                for t in ts:
                    if t.placement is not None:
                        self._delete(t.placement)
                    if t.spec is not None:
                        self._delete(t.spec)
            # synthetic mesh-exchange tasks release like any placement
            for pl in self._mesh_placement.values():
                self._delete(pl)

    # ------------------------------------------- checkpoint barriers
    def _checkpoint_stage(self, ckpt, fid: int) -> None:
        """Journal one completed stage: every live placement and its
        full re-dispatchable payload. Best-effort: a failed write drops
        THIS barrier, counted and logged, and the query runs on
        (recovery then falls back to re-running the statement)."""
        try:
            tasks = [{"uri": t.placement.uri,
                      "task_id": t.placement.task_id,
                      "payload": self._payload_for(t, t.placement.task_id)}
                     for t in self.tasks[fid] if t.placement is not None]
            ckpt.record_stage(fid, key=stage_key(fid),
                              parts=self._spooled_parts.get(fid, 1),
                              tasks=tasks,
                              replan_gen=self.ex.adaptive_replans)
        except Exception as e:  # noqa: BLE001 - a barrier never fails
            # the query: the drop is counted and logged
            self.ex.checkpoint_drops += 1
            logging.getLogger("presto_tpu_torch.dist").warning(
                "stage %d checkpoint dropped: %r", fid, e)

    def _checkpoint_root(self, ckpt) -> None:
        """The final-stage registration barrier: the coordinator's root
        fragment and the stages that feed it."""
        try:
            blob = plan_serde.dumps(clip_for_shipping(self.dag.root))
        except Exception as e:  # noqa: BLE001 - as _checkpoint_stage
            blob = None
            self.ex.checkpoint_drops += 1
            logging.getLogger("presto_tpu_torch.dist").warning(
                "root checkpoint blob dropped: %r", e)
        ckpt.record_root(blob, list(self.dag.root_inputs))

    def _pre_root_hook(self) -> None:
        """The window between the last stage barrier and the root's
        drain, every producer spool live: FAULT_COORD_STALL_MS parks
        the coordinator here (the chaos harness SIGKILLs it mid-stall),
        and a test-installed coord._root_hook can park or kill
        synchronously."""
        stall = os.environ.get("FAULT_COORD_STALL_MS")
        if stall:
            time.sleep(int(stall) / 1000.0)
        if self.coord._root_hook is not None:
            self.coord._root_hook(self)

    # ------------------------------------------------------- stages
    def _probe_key(self, t: _SchedTask, frag) -> Optional[str]:
        """The fragment-cache key THIS task's execution would compute on
        a worker (dist/cacheprobe.fragment_cache_key mirrors the
        worker's split wrap and salt over the shipped blob), or None
        when the fragment's root is no cache point. Advisory: any
        failure reads as a miss."""
        from presto_tpu_torch.dist.cacheprobe import fragment_cache_key

        root = self._probe_roots.get(t.fid)
        if root is None:
            try:
                root = plan_serde.loads(self._frag_blob[t.fid])
            except Exception:  # noqa: BLE001 - an advisory probe
                return None
            self._probe_roots[t.fid] = root
        try:
            return fragment_cache_key(
                root, self.coord.runner.catalogs,
                split_table=frag.split_table, split_index=t.index,
                split_count=self._ntasks[t.fid],
                collect_k=self.ex.collect_k, page_rows=self.ex.page_rows)
        except Exception:  # noqa: BLE001 - an advisory probe
            return None

    def _probe_cache(self, t: _SchedTask, pool) -> bool:
        """The pre-dispatch fleet cache probe: True iff some fleet member
        served this leaf task's fragment from its result cache (the task
        is then placed and done). The common miss is free: the bloom
        summaries refreshed on heartbeats answer "definitely not cached"
        with no round trip. Leaf split fragments with one-partition
        output only: a repartition producer's P-way spool and the mesh
        plane's raw-page contract are not what the cache holds."""
        coord = self.coord
        if not coord.cache_index.known():
            return False
        sess = coord.runner.session
        if not (bool(sess.get("result_cache_enabled"))
                and bool(sess.get("result_cache_remote_probe"))):
            return False
        frag = self.dag.fragment(t.fid)
        if frag.inputs or frag.split_table is None \
                or t.fid in self._mesh_fids \
                or frag.output_kind == "repartition":
            return False
        key = self._probe_key(t, frag)
        if key is None:
            return False
        uri = coord._probe_pool(key, t.base_id, pool)
        if uri is None:
            return False
        t.placement = _Placement(uri, t.base_id)
        t.dispatched_at = time.monotonic()
        t.done = True
        t.counted = True
        self.ex.cache_remote_hits += 1
        tr = self.trace
        if tr is not None:
            now = tr.now()
            tr.complete("cache", f"remote-hit:{t.base_id}", now, now,
                        uri=uri, key=key)
            self.ex.trace_spans += 1
        return True

    def _run_stage(self, fid: int) -> None:
        # pool recomputed per stage: an excluded node whose heartbeat
        # recovered rejoins HERE, mid-query
        pool = self._pool()
        self.stage_pools.append(list(pool))
        if self._mesh_eligible(fid, pool):
            # decided BEFORE dispatch: every task payload of this stage
            # carries the meshExchange contract
            self._mesh_fids.add(fid)
        stage = self.tasks[fid]
        tr = self.trace
        sspan = None
        s_start = time.monotonic()
        spooled0 = self.ex.spooled_exchange_pages
        if tr is not None:
            sspan = tr.begin("stage", f"stage{fid}", tasks=len(stage),
                             pool=len(pool))
            self.ex.trace_spans += 1
        for t in stage:
            if self._probe_cache(t, pool):
                # a fleet member holds this split fragment's pages: the
                # task is DONE without dispatch, and its consumers read
                # the parked spool over the ordinary fetch plane
                continue
            if pool[t.index % len(pool)] in self.coord._excluded:
                # an earlier submit of this wave excluded a node:
                # refresh the pool so the remaining tasks neither burn
                # retries nor pay connect timeouts against it
                pool = self._pool()
                self.stage_pools[-1] = list(pool)
            target = pool[t.index % len(pool)]
            if tr is not None:
                t.span = tr.begin("task", t.base_id, parent=sspan,
                                  uri=target)
                self.ex.trace_spans += 1
            try:
                d0 = tr.now() if tr is not None else 0.0
                self._post(target, self._payload_for(t, t.base_id))
                t.placement = _Placement(target, t.base_id)
                t.dispatched_at = time.monotonic()
                if tr is not None:
                    tr.complete("dispatch", t.base_id, d0, tr.now(),
                                parent=t.span, uri=target)
                    self.ex.trace_spans += 1
            except (urllib.error.URLError, OSError) as e:
                # submit failure: exclude and re-dispatch to a survivor
                # — not a spool replay, the task never ran
                self.coord._exclude(target)
                t.placement = _Placement(target, t.base_id)
                self._redispatch(t, cause=e, replay=False)
        self.ex.stages_scheduled += 1
        self._wait(stage)
        if fid in self._mesh_fids:
            # stage barrier passed: the all_to_all over the producers'
            # raw spools runs before any consumer dispatches
            self._run_mesh_exchange(fid)
        if tr is not None:
            tr.end(sspan)
        E.dispatch(
            self.coord.listeners, "stage_completed",
            E.StageCompletedEvent(
                query_id=self.qid, stage_id=f"stage{fid}",
                task_count=len(stage),
                wall_ms=int((time.monotonic() - s_start) * 1000),
                retries=sum(t.retries for t in stage),
                # per-STAGE delta of the coordinator-lifetime counter
                spooled_pages=self.ex.spooled_exchange_pages - spooled0),
            on_error=self.ex.count_listener_error)
        if self._retry_attempts() <= 0:
            # pinned classic mode: nothing replays, so consumed input
            # partitions are released as soon as this stage is done
            self._ack_inputs(fid)

    def _wait(self, stage: List[_SchedTask]) -> None:
        # status polls back off geometrically (20 ms -> 250 ms cap)
        delay = 0.02
        while True:
            self._check_deadline()
            if all(t.done for t in stage):
                return
            # replayed earlier-stage tasks ride in the poll set: their
            # completion unblocks this stage's long-polling consumers,
            # and a FAILED replay must surface
            pending = [t for ts in self.tasks.values() for t in ts
                       if t.placement is not None and not t.done]
            progressed = False
            for t in pending:
                self._poll_task(t)
                progressed = progressed or t.done
            if progressed and all(t.done for t in stage):
                return  # no sleep at the barrier once the stage is done
            self._maybe_speculate(stage)
            delay = 0.02 if progressed else min(delay * 1.5, 0.25)
            time.sleep(delay)

    def _poll_task(self, t: _SchedTask) -> None:
        # the speculation copy first: a finished copy wins at once
        if t.spec is not None:
            try:
                st = self._status(t.spec)
                if st["state"] == "FINISHED":
                    self.ex.speculative_tasks_won += 1
                    loser = t.placement
                    t.placement, t.spec = t.spec, None
                    self._complete(t, st)
                    if loser is not None:
                        self._delete(loser)
                    return
                if st["state"] == "FAILED":
                    t.spec = None  # the copy died; the original runs on
            except _NodeDown:
                t.spec = None
        try:
            st = self._status(t.placement)
        except _NodeDown:
            self._node_lost(t.placement.uri)
            return
        if st["state"] == "FINISHED":
            if t.spec is not None:
                self.ex.speculative_tasks_lost += 1
                self._delete(t.spec)
                t.spec = None
            self._complete(t, st)
        elif st["state"] == "FAILED":
            msg = str(st.get("error") or "task failed")
            src_uri = _source_lost_uri(msg)
            if src_uri:
                # the task died because an UPSTREAM spool vanished:
                # replay that node's placements first, then this task
                # with rebuilt sources
                self._node_lost(src_uri)
            self._redispatch(t, cause=RuntimeError(msg))

    def _complete(self, t: _SchedTask, st: Dict) -> None:
        t.done = True
        t.wall = time.monotonic() - t.dispatched_at
        # the LAST status body wins (a replay republishes the same
        # deterministic stats)
        t.status = st
        if not t.counted:
            t.counted = True
            self.ex.spooled_exchange_pages += int(
                st.get("spooledPages") or 0)
            self.ex.spooled_exchange_rows += sum(st.get("spoolRows") or [])
            for k in self._worker_tally:
                self._worker_tally[k] += int(st.get(k) or 0)
        tr = self.trace
        queue_ms = run_ms = 0
        remote = st.get("spans") or []
        for d in remote:
            try:
                ms = int((float(d["t1"]) - float(d["t0"])) * 1000)
            except (KeyError, TypeError, ValueError):
                continue
            if d.get("kind") == "queue":
                queue_ms += max(ms, 0)
            elif d.get("kind") == "run":
                run_ms += max(ms, 0)
        if tr is not None and t.span is not None:
            # the worker's spans (offsets from ITS task creation) nest
            # into this task's window, clamped so clock or queue skew
            # never yields a negative interval
            if remote:
                self.ex.trace_spans += tr.ingest(
                    remote, t.span, t.span.t0, tr.now())
            tr.end(t.span, spooled=int(st.get("spooledPages") or 0),
                   retries=t.retries, uri=t.placement.uri)
        E.dispatch(
            self.coord.listeners, "task_completed",
            E.TaskCompletedEvent(
                query_id=self.qid, task_id=t.placement.task_id,
                stage_id=f"stage{t.fid}", uri=t.placement.uri,
                state="FINISHED", wall_ms=int(t.wall * 1000),
                queue_ms=queue_ms, run_ms=run_ms,
                pages=int(st.get("spooledPages") or 0),
                retries=t.retries, speculative=t.spec_count > 0),
            on_error=self.ex.count_listener_error)

    # ----------------------------------------------------- recovery
    def _stage_done(self, fid: int) -> bool:
        return all(t.done for t in self.tasks[fid])

    def _still_needed(self, fid: int) -> bool:
        """Whether a stage's spools can still be consumed: by an
        unfinished consumer stage, or by the root until the query
        completes."""
        if fid in self.dag.root_inputs and not self._root_done:
            return True
        return any(not self._stage_done(c)
                   for c in self.dag.consumers(fid))

    def _node_lost(self, uri: str) -> None:
        """A node died: exclude it and replay, in topological order,
        every task it hosted whose output is still needed — leaf tasks
        re-generate their split share, non-leaf tasks re-read the
        surviving upstream spools; consumers long-poll the
        replacements.

        Neededness is judged with EVERY hosted task first marked
        un-done: a dead node's stage-k spool is needed whenever its
        stage-k+1 consumer (maybe on the same node) must replay, even
        if stage k+1 had finished; judging by the old flags would skip
        the upstream spool and doom the consumer's replay to a
        [source-lost] failure."""
        self.coord._exclude(uri)
        cand = [t for ts in self.tasks.values() for t in ts
                if t.placement is not None and t.placement.uri == uri]
        was_done = [(t, t.done) for t in cand]
        for t in cand:
            t.done = False
        lost = [t for t, done in was_done
                if not done or self._still_needed(t.fid)]
        for t, done in was_done:
            if done and t not in lost:
                t.done = True  # nothing consumes it any more
        for t in sorted(lost, key=lambda x: x.fid):
            self._redispatch(t, cause=_NodeDown(uri))

    def _redispatch(self, t: _SchedTask, cause: BaseException,
                    replay: bool = True) -> None:
        """Re-dispatch one task to a survivor. replay=False marks an
        initial-submit failure (the task never ran, nothing replays
        from a spool), so nonleaf_replays counts spooled replays
        only."""
        from presto_tpu_torch.dist.dcn import DcnQueryFailed

        retry_attempts = self._retry_attempts()
        deadline = self._deadline()
        while True:
            if retry_attempts <= 0 or t.retries >= retry_attempts:
                raise DcnQueryFailed(
                    f"stage task {t.base_id}: {cause} (task retries "
                    f"exhausted: task_retry_attempts={retry_attempts})"
                ) from cause
            t.retries += 1
            self.coord._sleep_backoff(t.retries, deadline)
            self._check_deadline()
            pool = self._pool()
            old_uri = t.placement.uri if t.placement else None
            # prefer a DIFFERENT worker: the old placement's sorts last
            survivors = sorted(pool, key=lambda u: u == old_uri)
            target = survivors[(t.retries - 1) % len(survivors)]
            new_id = f"{t.base_id}.r{t.retries}"
            try:
                self._post(target, self._payload_for(t, new_id))
            except (urllib.error.URLError, OSError) as e:
                self.coord._exclude(target)
                cause = e
                continue
            if t.spec is not None:
                # cancel an in-flight speculation copy of the OLD
                # placement, or its spool leaks until task expiry
                self._delete(t.spec)
            tr = self.trace
            if tr is not None and t.span is not None:
                now = tr.now()
                tr.complete("retry", new_id, now, now, parent=t.span,
                            attempt=t.retries, to=target,
                            cause=str(cause)[:120], replay=bool(replay))
                self.ex.trace_spans += 1
            t.placement = _Placement(target, new_id)
            t.done = False
            t.spec = None
            t.dispatched_at = time.monotonic()
            self.ex.task_retries += 1
            if replay and self.dag.fragment(t.fid).inputs:
                # a NON-LEAF task replaying from spooled upstream pages
                self.ex.nonleaf_replays += 1
            E.dispatch(
                self.coord.listeners, "task_retried",
                E.TaskRetryEvent(
                    query_id=self.qid, task_id=new_id,
                    from_uri=old_uri or "?", to_uri=target,
                    attempt=t.retries, cause=str(cause)[:400]),
                on_error=self.ex.count_listener_error)
            return

    # -------------------------------------------------- speculation
    def _maybe_speculate(self, stage: List[_SchedTask]) -> None:
        """Race a copy of a stage's LAST running task on another live
        worker once it has run past max(0.25 s, 2 x the median wall
        of its finished siblings); at most two copies per task."""
        if not bool(self.coord.runner.session.get(
                "speculation_enabled")):
            return
        running = [t for t in stage if not t.done]
        if len(running) != 1:
            return
        t = running[0]
        if t.spec is not None or t.spec_count >= 2 or \
                t.placement is None:
            return
        walls = sorted(x.wall for x in stage if x.done)
        if not walls:
            return
        median = walls[len(walls) // 2]
        if time.monotonic() - t.dispatched_at < max(0.25, 2 * median):
            return
        others = [u for u in self.coord._alive_for_submit()
                  if u != t.placement.uri]
        if not others:
            return
        t.spec_count += 1
        sid = f"{t.base_id}.s{t.spec_count}"
        try:
            self._post(others[0], self._payload_for(t, sid))
            t.spec = _Placement(others[0], sid)
            tr = self.trace
            if tr is not None and t.span is not None:
                now = tr.now()
                tr.complete("speculate", sid, now, now, parent=t.span,
                            uri=others[0])
                self.ex.trace_spans += 1
        except (urllib.error.URLError, OSError):
            pass  # best-effort: the original runs on

    # --------------------------------------------------------- acks
    def _ack_inputs(self, fid: int) -> None:
        """The consumer stage is done: release every partition its
        producers spooled (recorded at dispatch; right for repartition,
        gather and the adaptive passthrough and broadcast reads)."""
        for u in self.dag.fragment(fid).inputs:
            parts = range(self._spooled_parts.get(u) or 1)
            for ut in self.tasks[u]:
                if ut.placement is None:
                    continue
                for part in parts:
                    SPOOL.ack_spool(ut.placement.uri,
                                    ut.placement.task_id, part)

    # --------------------------------------------- root-stage drain
    def _root_supplier(self, fid: int):
        from presto_tpu_torch.dist.dcn import (
            DcnQueryFailed,
            _TaskLost,
            _TaskState,
        )

        stage = self.tasks[fid]
        ckpt = self.coord.checkpoint_handle

        def supplier():
            tr = self.trace
            for t in stage:
                f0 = tr.now() if tr is not None else 0.0
                # mesh-local fast path: a same-process placement's spool
                # serves its Pages directly (no HTTP, no serde, no
                # prefix to verify); a stopped runtime falls through to
                # HTTP, whose _TaskLost handling replays
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
                # fresh state per supplier call: a coordinator boosted
                # retry re-pulls from token 0 (spools keep every page);
                # within ONE call a replayed task resumes at the
                # consumed token after the prefix check
                st = _TaskState(uri=t.placement.uri,
                                task_id=t.placement.task_id)
                while True:
                    try:
                        yield from self.coord._fetch_pages(
                            st, self._deadline())
                        break
                    except _TaskLost as e:
                        if self._retry_attempts() <= 0:
                            raise DcnQueryFailed(str(e)) from e
                        self._recover_root_fetch(t, st, e)
                if ckpt is not None:
                    # the final-drain barrier: this task's consumed
                    # token and the rolling digest of its prefix
                    ckpt.record_drain(fid, t.index, st.next_token,
                                      st.hasher.hexdigest())
                if tr is not None:
                    # root-parented: the drain runs after the task span
                    # closed, so a fetch child would escape its parent
                    tr.complete("fetch", t.placement.task_id, f0,
                                tr.now(), pages=st.next_token,
                                uri=t.placement.uri)
                    self.ex.trace_spans += 1

        return supplier

    def _recover_root_fetch(self, t: _SchedTask, st, cause) -> None:
        from presto_tpu_torch.dist.dcn import DcnQueryFailed

        if getattr(cause, "task_error", False):
            # a [source-lost] failure replays the upstream node's
            # placements first, or every re-dispatch of this task would
            # name the same dead node
            src_uri = _source_lost_uri(str(cause))
            if src_uri:
                self._node_lost(src_uri)
            self._redispatch(t, cause=cause)
        else:
            # node death during the final drain: the dead node's
            # still-needed tasks (this one included) replay in topo
            # order
            self._node_lost(st.uri)
            if t.placement.uri == st.uri:
                self._redispatch(t, cause=cause)
        if st.next_token and not self.coord._prefix_matches(
                t.placement.uri, t.placement.task_id, st,
                self._deadline()):
            raise DcnQueryFailed(
                f"task {t.placement.task_id}: the replayed placement "
                f"regenerated a DIFFERENT page sequence for the "
                f"already-consumed prefix ({st.next_token} pages) — "
                f"non-deterministic fragment output; failing loudly "
                f"instead of silently skipping or duplicating rows"
            ) from cause
        st.uri = t.placement.uri
        st.task_id = t.placement.task_id
