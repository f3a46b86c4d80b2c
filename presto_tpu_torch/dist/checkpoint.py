"""Durable coordinator query-state journal and crash re-attach.

Port of presto_tpu/dist/checkpoint.py. Reference: Project Tardigrade's
fault-tolerant execution keeps intermediate exchange data in a spool so
a failed node's work is recoverable; for the loss of the COORDINATOR
the missing piece is a durable record of what each in-flight query had
already done. Worker spools already outlive the coordinator (they hold
every completed stage's pages until the query releases them), so
coordinator HA reduces to journaling, at barriers the engine already
has:

  admission        statement, session, resource group, query id
  stage barrier    task placements with their re-dispatchable payloads
                   (the serialized fragment), spool partition counts,
                   re-plan generation
  root             the coordinator's root fragment and its input stages
  final drain      per-task consumed spool tokens + sha256 prefix
                   digests; the client-protocol token and the digest of
                   every page already handed to the client

The journal rides cache/persist.ManifestStore: one record per query,
O(1) appends at each barrier, threshold compaction, loud-drop recovery.
All file I/O happens outside the registered locks.

On restart, ``PrestoTpuServer(checkpoint_dir=...)`` replays the journal
(``reattach_query``): a query whose producer spools still answer
re-registers its final-stage suppliers from the persisted placements
and the client's ``nextUri`` stream resumes at the persisted token
after the delivered pages' digests verify; dead placements re-dispatch
from the persisted payloads (``.ra`` task ids) through the replay
ladder; anything non-recoverable re-runs from the persisted SQL, or
surfaces FAILED with ``CoordinatorRestarted`` — loudly, never a hang,
never duplicate or missing rows.
"""

from __future__ import annotations

import hashlib
import json
import logging
import urllib.error
from typing import Dict, List, Optional

from presto_tpu_torch.cache.persist import ManifestStore
from presto_tpu_torch.obs.sanitizer import make_lock, register_owner

log = logging.getLogger("presto_tpu_torch.dist")

CHECKPOINT_VERSION = 1
_STEM = "journal"


class CoordinatorRestarted(RuntimeError):
    """A query could not be carried across a coordinator restart: its
    spools are gone AND its statement was not re-runnable (or the
    resumed stream failed digest verification). Clients see a FAILED
    query with errorName CoordinatorRestarted."""


def _serde_check(header: Dict) -> Optional[str]:
    from presto_tpu_torch.dist.serde import wire_fingerprint

    if header.get("serde") != wire_fingerprint():
        return (f"serde fingerprint {header.get('serde')!r} != "
                f"{wire_fingerprint()!r}")
    return None


def page_digest(chunk: List) -> str:
    """Digest of ONE client-protocol page (a slice of the query's
    JSON-shaped rows). The restart path regenerates the rows and checks
    every already-delivered page against these digests before the
    client's stream continues; json.dumps over JSON-shaped rows is
    deterministic."""
    return hashlib.sha256(
        json.dumps(chunk, separators=(",", ":")).encode()).hexdigest()


class CheckpointJournal:
    """One coordinator's durable query journal: a ManifestStore of
    qid -> record, plus the in-memory mirror the barriers mutate.
    Mutations happen under this journal's lock; the durable publish
    runs OUTSIDE it on the store's own drain loop."""

    _shared_attrs = ("_records",)

    def __init__(self, directory: str, counter_ex=None):
        from presto_tpu_torch.dist.serde import wire_fingerprint

        self.directory = directory
        self._lock = make_lock("dist.checkpoint.CheckpointJournal._lock")
        self._store = ManifestStore(
            directory, stem=_STEM, version=CHECKPOINT_VERSION,
            header_extra={"serde": wire_fingerprint()},
            header_check=_serde_check)
        self._records: Dict[str, Dict] = dict(
            self._store.entries_snapshot())
        self.counter_ex = counter_ex
        if counter_ex is not None and self._store.broken_count:
            counter_ex.checkpoint_drops += self._store.broken_count
        for why in self._store.broken_reasons:
            log.warning("checkpoint journal %s: %s", directory, why)
        register_owner(self)

    # ------------------------------------------------------ lifecycle
    def admit(self, qid: str, sql: str, session_props: Dict,
              group: Optional[str]) -> "QueryCheckpoint":
        rec = {"state": "admitted", "sql": sql,
               "session": dict(session_props or {}), "group": group,
               "token": 0, "page_sha": {}, "stages": {}, "drain": {}}
        with self._lock:
            self._records[qid] = rec
            snap = json.loads(json.dumps(rec))
        self._publish_rec(qid, snap)
        return QueryCheckpoint(self, qid)

    def pending(self) -> Dict[str, Dict]:
        """Every journaled query a restarted coordinator must pick up
        (a delivered query's record is removed at stream completion)."""
        with self._lock:
            return {q: dict(r) for q, r in self._records.items()}

    def claim_reattach(self) -> bool:
        """True exactly once per journal directory and process: the
        re-attach pass must not run twice on one boot."""
        return self._store.claim_once("reattach")

    # ------------------------------------------------------ internals
    def _mutate(self, qid: str, fn) -> Optional[Dict]:
        """Apply ``fn(record)`` under the lock; a JSON-safe deep copy
        for publishing, or None when the query is unknown."""
        with self._lock:
            rec = self._records.get(qid)
            if rec is None:
                return None
            fn(rec)  # a small dict update: no I/O, no device work
            return json.loads(json.dumps(rec))

    def _publish_rec(self, qid: str, snapshot: Dict) -> None:
        self._store.publish(qid, snapshot)
        ex = self.counter_ex
        if ex is not None:
            ex.checkpoints_written += 1
            tr = getattr(ex, "trace", None)
            if tr is not None:
                now = tr.now()
                tr.complete("checkpoint", qid, now, now,
                            state=snapshot.get("state"),
                            bytes=len(json.dumps(snapshot)))
                ex.trace_spans += 1

    def _remove(self, qid: str) -> None:
        with self._lock:
            self._records.pop(qid, None)
        self._store.remove([qid])


class QueryCheckpoint:
    """The per-query handle the server and scheduler barriers write
    through. ``detach()`` voids it, so a superseded coordinator's
    parked threads can never write the journal a successor owns."""

    def __init__(self, journal: CheckpointJournal, qid: str):
        self.journal: Optional[CheckpointJournal] = journal
        self.qid = qid

    def detach(self) -> None:
        self.journal = None

    def _apply(self, fn) -> None:
        j = self.journal
        if j is None:
            return
        snap = j._mutate(self.qid, fn)
        if snap is not None:
            j._publish_rec(self.qid, snap)

    # ----------------------------------------------------- barriers
    def running(self) -> None:
        self._apply(lambda r: r.__setitem__("state", "running"))

    def record_stage(self, fid: int, key: str, parts: int,
                     tasks: List[Dict], replan_gen: int) -> None:
        """One spooled-stage boundary: every task's placement and its
        full re-dispatchable payload (the fragment blob included, so the
        restart path can re-POST it verbatim)."""
        def mut(r):
            r["stages"][str(fid)] = {"key": key, "parts": int(parts),
                                     "replan_gen": int(replan_gen),
                                     "tasks": tasks}
        self._apply(mut)

    def record_root(self, root_blob: Optional[str],
                    root_inputs: List[int]) -> None:
        """Final-stage registration: the coordinator's root fragment
        (plan_serde blob) and the stages that feed it."""
        def mut(r):
            if root_blob is not None:
                r["root"] = root_blob
            r["root_inputs"] = [int(f) for f in root_inputs]
        self._apply(mut)

    def record_drain(self, fid: int, index: int, next_token: int,
                     sha: str) -> None:
        """Consumed-spool progress of one final-stage task: its token
        and the rolling sha256 of the consumed prefix (diagnostics;
        resume correctness rides the client-page digests)."""
        def mut(r):
            r["drain"].setdefault(str(fid), {})[str(index)] = {
                "next_token": int(next_token), "sha": sha}
        self._apply(mut)

    def note_client_token(self, token: int, sha: str) -> None:
        """The client consumed protocol page ``token - 1`` (its next
        fetch names ``token``): the restart path resumes the stream
        here after checking each delivered page's digest."""
        def mut(r):
            r["token"] = int(token)
            r["page_sha"][str(token - 1)] = sha
        self._apply(mut)

    def finished(self, columns: List[Dict], nrows: int) -> None:
        def mut(r):
            r["state"] = "finished"
            r["columns"] = columns
            r["nrows"] = int(nrows)
        self._apply(mut)

    def failed(self, message: str, error_name: str = "") -> None:
        def mut(r):
            r["state"] = "failed"
            r["error"] = {"message": str(message)[:2000],
                          "errorName": error_name or "QueryFailed"}
        self._apply(mut)

    def delivered(self) -> None:
        """The client drained the whole stream: nothing is left to
        recover, so the record goes (journal size governance)."""
        j = self.journal
        if j is not None:
            j._remove(self.qid)


# ---------------------------------------------------------------------
# restart-side recovery


class ReattachResult:
    def __init__(self, column_names, rows, resumed: bool,
                 redispatches: int):
        self.column_names = list(column_names or [])
        self.rows = rows
        # True when the spooled fast path served (no producer re-launch
        # beyond the counted re-dispatches); False when the statement
        # re-ran from SQL
        self.resumed = resumed
        self.redispatches = redispatches


def _spool_alive(uri: str, task_id: str) -> bool:
    """Does this persisted placement's spool still answer? FINISHED is
    the only state a checkpointed producer can be in; anything else
    (FAILED, released, unreachable, a restarted worker that forgot the
    task) reads as dead."""
    from presto_tpu_torch.dist import connpool as CONNPOOL

    try:
        with CONNPOOL.request(f"{uri}/v1/task/{task_id}", timeout=5) as r:
            return json.loads(r.read().decode()).get("state") == "FINISHED"
    except (urllib.error.URLError, ConnectionError, OSError, ValueError):
        return False


def _redispatch_dead(rec: Dict, dcn, ex) -> int:
    """Probe every final-stage placement; re-POST the persisted payload
    of each dead one onto the live pool under a new ``.ra<n>`` task id
    (the worker regenerates the fragment deterministically). Mutates
    rec's task dicts in place, so the suppliers read the replacement
    placements. Raises on an unrecoverable pool."""
    from presto_tpu_torch.dist.dcn import DcnQueryFailed

    pool = dcn._alive_for_submit()
    if not pool:
        raise DcnQueryFailed(
            f"re-attach: no ALIVE workers among {dcn.worker_uris}")
    n = 0
    for fid in rec.get("root_inputs", []):
        stage = rec["stages"].get(str(fid))
        if stage is None:
            raise DcnQueryFailed(f"re-attach: stage {fid} never checkpointed")
        for t in stage["tasks"]:
            if _spool_alive(t["uri"], t["task_id"]):
                continue
            n += 1
            base = t["task_id"].split(".r", 1)[0].split(".ra", 1)[0]
            new_id = f"{base}.ra{n}"
            payload = dict(t["payload"], taskId=new_id)
            target = pool[n % len(pool)]
            dcn._post_task(target, payload)
            t["uri"], t["task_id"], t["payload"] = target, new_id, payload
            ex.count_reattach_redispatch()
    return n


def _persisted_supplier(stage: Dict, dcn, deadline, retry_attempts, pool):
    """A final-stage supplier built from PERSISTED placements: the
    restart-side twin of StageScheduler._root_supplier, on the same
    token-acked fetch and replay ladder (_fetch_pages /
    _recover_task)."""
    from presto_tpu_torch.dist.dcn import (
        DcnQueryFailed,
        _TaskLost,
        _TaskState,
    )

    def supplier():
        for t in stage["tasks"]:
            st = _TaskState(uri=t["uri"], task_id=t["task_id"],
                            payload=t["payload"])
            while True:
                try:
                    yield from dcn._fetch_pages(st, deadline)
                    break
                except _TaskLost as e:
                    if retry_attempts <= 0:
                        raise DcnQueryFailed(str(e)) from e
                    dcn._recover_task(st, pool, retry_attempts, deadline, e)

    return supplier


def reattach_query(rec: Dict, dcn, ex) -> ReattachResult:
    """Recover one journaled query on a restarted coordinator.

    The ladder: (1) the spooled fast path — the persisted root fragment
    re-executes over suppliers reading the SURVIVING producer spools
    (dead placements re-dispatched from persisted payloads, counted);
    (2) a full re-run of the persisted SQL through the normal dispatch
    planes; (3) CoordinatorRestarted, loudly. A recovery by either path
    counts ``coordinator_reattaches``."""
    from presto_tpu_torch.dist import plan_serde
    from presto_tpu_torch.dist.fragmenter import stage_key

    root_blob = rec.get("root")
    root_inputs = rec.get("root_inputs") or []
    redis = 0
    if (dcn is not None and root_blob and root_inputs
            and all(str(f) in rec.get("stages", {}) for f in root_inputs)):
        keys: List[str] = []
        try:
            root = plan_serde.loads(root_blob)
            redis = _redispatch_dead(rec, dcn, ex)
            dcn.runner.apply_session()
            deadline = ex.query_deadline
            retry_attempts = dcn._retry_attempts()
            pool = dcn._alive_for_submit() or list(dcn.worker_uris)
            try:
                for fid in root_inputs:
                    k = stage_key(fid)
                    keys.append(k)
                    ex.remote_sources[k] = _persisted_supplier(
                        rec["stages"][str(fid)], dcn, deadline,
                        retry_attempts, pool)
                names, rows = ex.execute(root)
                ex.count_reattach()
                return ReattachResult(names, rows, True, redis)
            finally:
                for k in keys:
                    ex.remote_sources.pop(k, None)
                # the spools die with the query, as the scheduler's own
                # finally would have released them
                for stage in rec.get("stages", {}).values():
                    for t in stage["tasks"]:
                        dcn._release_task(t["uri"], t["task_id"])
        except Exception as e:  # noqa: BLE001 - the recovery ladder:
            # the fast path's failure is logged, then the statement
            # re-runs from SQL (rung 2)
            log.warning("re-attach fast path failed (%r) — re-running "
                        "statement", e)
    sql = rec.get("sql")
    if sql:
        if dcn is None:
            raise CoordinatorRestarted(
                "re-attach: no dispatch plane to re-run on")
        rows = dcn.execute(sql)
        ex.count_reattach()
        return ReattachResult(dcn.last_output_names, rows, False, redis)
    raise CoordinatorRestarted(
        "query state was not recoverable after a coordinator restart: "
        "producer spools gone and no re-runnable statement in the "
        "journal")
