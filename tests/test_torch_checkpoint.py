"""Coordinator checkpoints and re-attach of presto_tpu_torch on the CPU.

The 12 cases of tests/test_checkpoint.py against the port's journal
(dist/checkpoint.py over cache/persist.ManifestStore), server and
``reattach_query``:

  - the journal round trip (admission, stage, root, drain and token
    barriers, the delivered record's removal, a reload into a fresh
    journal), a detached handle that never writes, and a corrupt
    record, a truncated tail and a version skew, each dropped loudly
    (``checkpoint_drops``);
  - concurrent barrier writers under the armed lock sanitizer;
  - a three-stage spooled query parked at the root's drain survives
    its coordinator's replacement: the client's nextUri stream resumes
    with rows equal to presto_tpu's single process,
    ``coordinator_reattaches`` 1 and no producer task relaunched; with
    one root-input spool deleted only ``.ra`` tasks re-dispatch;
  - a finished but undelivered stream resumes at the client's token
    after the delivered pages' digests verify;
  - a record with neither spools nor statement surfaces FAILED
    (CoordinatorRestarted), and ``reattach_query`` without a dispatch
    plane raises;
  - FAULT_SPOOL_CORRUPT_EVERY: sparse corruption re-fetches, total
    corruption fails the query loudly.

One case drives a re-attach on the card and skips without one.
"""

import json
import threading
import time
import urllib.request

import pytest
import torch

from presto_tpu_torch.cache.persist import (
    manifest_files,
    read_manifest_doc,
    rewrite_manifest_doc,
)
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.checkpoint import (
    CheckpointJournal,
    CoordinatorRestarted,
    page_digest,
    reattach_query,
)
from presto_tpu_torch.server import PrestoTpuServer
from presto_tpu_torch.server.worker import WorkerServer

SF = 0.01
PAGE_ROWS = 1 << 13

# the 3-stage shape of tests/test_checkpoint.py: every producer stage
# spools, the root aggregation drains stage 2
DAG_QUERY = (
    "select n_name, count(*), sum(top.c_count) from nation join ("
    "  select c_nationkey nk, c_custkey ck, count(o_orderkey) c_count"
    "  from customer left join orders on c_custkey = o_custkey"
    "  group by c_nationkey, c_custkey) top on n_nationkey = top.nk "
    "group by n_name order by n_name"
)
STREAM_QUERY = ("select l_orderkey, l_linenumber, l_quantity from lineitem "
                "order by l_orderkey, l_linenumber")
HDRS = {"X-Presto-Session": "stage_scheduler=true",
        "Content-Type": "text/plain"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ helpers
def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read().decode())


def _post_statement(port, sql):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/statement",
                                 data=sql.encode(), headers=HDRS)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read().decode())


def _drain(doc):
    """Follow nextUri to the end; all rows."""
    rows = []
    while True:
        if doc.get("error"):
            raise RuntimeError(str(doc["error"]))
        rows.extend(doc.get("data") or [])
        nxt = doc.get("nextUri")
        if not nxt:
            return rows
        time.sleep(0.01)
        doc = _get(nxt)


def _sorted(rows):
    return sorted(tuple(r) for r in rows)


def _post_fault(uri, **cfg):
    req = urllib.request.Request(
        f"{uri}/v1/fault", data=json.dumps(cfg).encode(),
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=5).close()


class _CreateCounter:
    """Every task the workers are asked to create while armed: the
    producer-relaunch count."""

    def __init__(self, workers):
        self.created = []
        self._saved = []
        for w in workers:
            orig = w.create_task
            self._saved.append((w, orig))

            def counting(req, _orig=orig):
                self.created.append(req.get("taskId"))
                return _orig(req)

            w.create_task = counting

    def restore(self):
        for w, orig in self._saved:
            w.create_task = orig


class _Ctr:
    def __init__(self):
        self.checkpoint_drops = 0
        self.checkpoints_written = 0


# ------------------------------------------------------------ fixtures
def _workers(dev="cpu"):
    ws = [WorkerServer({"tpch": TpchConnector(SF, device=dev)},
                       node_id=f"w{i}", default_catalog="tpch",
                       page_rows=PAGE_ROWS, device=dev) for i in range(2)]
    for w in ws:
        w.start()
    return ws


@pytest.fixture(scope="module")
def workers():
    ws = _workers()
    yield ws
    for w in ws:
        w.stop()


@pytest.fixture(scope="module")
def oracle():
    """presto_tpu's single process: the rows a re-attached query must
    return."""
    from presto_tpu.connectors.tpch import TpchConnector as R
    from presto_tpu.runner import LocalRunner as RefRunner

    r = RefRunner({"tpch": R(SF)}, page_rows=PAGE_ROWS)
    return {q: _sorted(r.execute(q).rows) for q in (DAG_QUERY, STREAM_QUERY)}


def _server(workers, ckdir, dev="cpu"):
    srv = PrestoTpuServer({"tpch": TpchConnector(SF, device=dev)}, port=0,
                          page_rows=PAGE_ROWS,
                          worker_uris=[w.uri for w in workers],
                          checkpoint_dir=str(ckdir), device=dev)
    srv.start()
    return srv


def _park_query_at_root(srv, sql=DAG_QUERY, timeout=90):
    """Submit ``sql`` and park its scheduler just before the root's
    drain (every producer stage spooled, nothing consumed). The hook
    RAISES once released, so the superseded coordinator's thread dies
    instead of draining spools its successor owns. (qid, journal
    record, release event)."""
    park = threading.Event()

    def hook(sched):
        park.wait(timeout)
        raise RuntimeError("superseded coordinator: parked root drain "
                           "aborted by the test")

    srv._dcn._root_hook = hook
    qid = _post_statement(srv.port, sql)["id"]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rec = srv._journal.pending().get(qid)
        if rec and rec.get("root") and rec.get("root_inputs") and all(
                str(f) in rec["stages"] for f in rec["root_inputs"]):
            return qid, rec, park
        time.sleep(0.05)
    raise AssertionError("the stage and root barriers never reached the "
                         "journal")


def _kill(srv, qid):
    """The crash: void the parked thread's journal handle (a dead
    process cannot write) and take the server down."""
    q = srv.manager.get(qid)
    if q is not None and q.checkpoint is not None:
        q.checkpoint.detach()
    srv.stop()


# ------------------------------------------------- journal round trip
def test_journal_roundtrip_and_reload(tmp_path):
    j = CheckpointJournal(str(tmp_path))
    h = j.admit("q1", "select 1", {"user": "alice"}, "global")
    h.running()
    h.record_stage(0, key="stage0", parts=2, tasks=[
        {"uri": "http://w", "task_id": "q.f0.t0", "payload": {"a": 1}}],
        replan_gen=0)
    h.record_root("BLOB", [0])
    h.record_drain(0, 0, 3, "abc")
    h.note_client_token(1, page_digest([[1]]))
    h.finished([{"name": "x", "type": "bigint"}], 1)

    j2 = CheckpointJournal(str(tmp_path))  # a fresh process
    rec = j2.pending()["q1"]
    assert rec["state"] == "finished"
    assert rec["sql"] == "select 1"
    assert rec["session"] == {"user": "alice"}
    assert rec["stages"]["0"]["tasks"][0]["task_id"] == "q.f0.t0"
    assert rec["root"] == "BLOB" and rec["root_inputs"] == [0]
    assert rec["drain"]["0"]["0"] == {"next_token": 3, "sha": "abc"}
    assert rec["token"] == 1
    assert rec["page_sha"]["0"] == page_digest([[1]])
    # the re-attach pass runs exactly once per boot
    assert j2.claim_reattach()
    assert not j2.claim_reattach()
    h.delivered()
    assert "q1" not in CheckpointJournal(str(tmp_path)).pending()
    # the digest and the record format are the reference's
    from presto_tpu.dist.checkpoint import page_digest as ref_digest

    assert page_digest([[1, "a", None]]) == ref_digest([[1, "a", None]])


def test_detached_handle_never_writes(tmp_path):
    j = CheckpointJournal(str(tmp_path))
    h = j.admit("q1", "select 1", {}, None)
    h.detach()
    h.note_client_token(5, "x")  # a no-op, not a crash
    h.failed("boom")
    assert CheckpointJournal(str(tmp_path)).pending()["q1"]["token"] == 0


def test_journal_corrupt_record_drops_loudly(tmp_path):
    j = CheckpointJournal(str(tmp_path))
    j.admit("q1", "select 1", {}, None)
    j.admit("q2", "select 2", {}, None)
    _, path = manifest_files(str(tmp_path), stem="journal")[0]
    lines = open(path).read().splitlines()
    # bit rot in q2's line: recovery keeps the intact prefix (header +
    # q1) and drops from the first unparseable line on
    garbled = [ln[: len(ln) // 2] + "#GARBAGE#" if '"q2"' in ln else ln
               for ln in lines]
    open(path, "w").write("\n".join(garbled) + "\n")
    ctr = _Ctr()
    j2 = CheckpointJournal(str(tmp_path), counter_ex=ctr)
    assert "q1" in j2.pending() and "q2" not in j2.pending()
    assert ctr.checkpoint_drops >= 1


def test_journal_truncated_tail_drops_loudly(tmp_path):
    j = CheckpointJournal(str(tmp_path))
    j.admit("q1", "select 1", {}, None)
    j.admit("q2", "select 2", {}, None)
    _, path = manifest_files(str(tmp_path), stem="journal")[0]
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) - 7])  # a torn final record
    ctr = _Ctr()
    j2 = CheckpointJournal(str(tmp_path), counter_ex=ctr)
    assert "q1" in j2.pending()
    assert ctr.checkpoint_drops >= 1
    # the journal keeps working after the recovery
    j2.admit("q3", "select 3", {}, None)
    assert "q3" in CheckpointJournal(str(tmp_path)).pending()


def test_journal_version_skew_drops_loudly(tmp_path):
    j = CheckpointJournal(str(tmp_path))
    j.admit("q1", "select 1", {}, None)
    doc = read_manifest_doc(str(tmp_path), stem="journal")
    doc["version"] = 99
    rewrite_manifest_doc(str(tmp_path), doc, stem="journal")
    ctr = _Ctr()
    j2 = CheckpointJournal(str(tmp_path), counter_ex=ctr)
    assert j2.pending() == {}
    assert ctr.checkpoint_drops >= 1


def test_concurrent_checkpoint_writers(tmp_path):
    from presto_tpu_torch.obs import sanitizer as SAN

    was = SAN.is_armed()
    SAN.arm()
    before = len(SAN.violations())
    try:
        j = CheckpointJournal(str(tmp_path))

        def write(i):
            for n in range(20):
                h = j.admit(f"q{i}_{n}", f"select {n}", {}, None)
                h.running()
                h.note_client_token(1, "sha")
                if n % 3 == 0:
                    h.delivered()
                else:
                    h.finished([], 0)

        threads = [threading.Thread(target=write, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(SAN.violations()) == before
        reloaded = CheckpointJournal(str(tmp_path))
        # n in {0, 3, ..., 18} delivered per writer: 7 of 20 gone
        assert len(reloaded.pending()) == 6 * (20 - 7)
        assert reloaded._store.broken_count == 0
    finally:
        if not was:
            SAN.disarm()


# ------------------------------------------------- crash re-attach
def test_reattach_identical_rows_zero_relaunches(workers, oracle,
                                                 tmp_path):
    """The coordinator replaced mid-query (every producer stage spooled,
    the root's drain not started): the client's nextUri stream resumes
    with the reference's rows, coordinator_reattaches 1, and the resumed
    suffix launches no producer task."""
    srv = _server(workers, tmp_path)
    park = ctr = srv2 = None
    try:
        qid, rec, park = _park_query_at_root(srv)
        assert srv._runner.executor.checkpoints_written >= 5
        _kill(srv, qid)
        ctr = _CreateCounter(workers)
        srv2 = _server(workers, tmp_path)
        got = _drain(_get(f"http://127.0.0.1:{srv2.port}"
                          f"/v1/statement/{qid}/0"))
        assert _sorted(got) == oracle[DAG_QUERY]
        ex = srv2._runner.executor
        assert ex.coordinator_reattaches == 1
        assert ex.reattach_redispatches == 0
        assert ctr.created == []  # every stage served from its spools
        # the delivered stream's record is gone (journal governance)
        assert qid not in srv2._journal.pending()
    finally:
        if ctr is not None:
            ctr.restore()
        if park is not None:
            park.set()
        if srv2 is not None:
            srv2.stop()


def test_reattach_redispatches_dead_spool(workers, oracle, tmp_path):
    """One root-input spool deleted between the crash and the restart:
    ONLY that task re-dispatches (a .ra id from its persisted payload);
    the rows stay the reference's."""
    srv = _server(workers, tmp_path)
    park = ctr = srv2 = None
    try:
        qid, rec, park = _park_query_at_root(srv)
        _kill(srv, qid)
        victim = rec["stages"][str(rec["root_inputs"][0])]["tasks"][0]
        urllib.request.urlopen(urllib.request.Request(
            f"{victim['uri']}/v1/task/{victim['task_id']}",
            method="DELETE"), timeout=5).close()
        ctr = _CreateCounter(workers)
        srv2 = _server(workers, tmp_path)
        got = _drain(_get(f"http://127.0.0.1:{srv2.port}"
                          f"/v1/statement/{qid}/0"))
        assert _sorted(got) == oracle[DAG_QUERY]
        ex = srv2._runner.executor
        assert ex.coordinator_reattaches == 1
        assert ex.reattach_redispatches >= 1
        assert ctr.created and all(".ra" in t for t in ctr.created)
    finally:
        if ctr is not None:
            ctr.restore()
        if park is not None:
            park.set()
        if srv2 is not None:
            srv2.stop()


def test_mid_stream_restart_resumes_at_token(workers, oracle, tmp_path):
    """FINISHED but not fully delivered: the restarted coordinator
    regenerates the rows, checks the delivered prefix against the
    persisted page digests, and the client resumes AT its token — no
    duplicate and no missing row."""
    srv = _server(workers, tmp_path)
    srv2 = None
    try:
        doc = _post_statement(srv.port, STREAM_QUERY)
        qid = doc["id"]
        rows, nxt = [], None
        while True:  # consume exactly one data page
            if doc.get("error"):
                raise RuntimeError(str(doc["error"]))
            chunk = doc.get("data") or []
            rows.extend(chunk)
            nxt = doc.get("nextUri")
            if chunk or not nxt:
                break
            time.sleep(0.01)
            doc = _get(nxt)
        assert rows and nxt, "needs a multi-page stream"
        token = int(nxt.rstrip("/").rsplit("/", 1)[1])
        srv.stop()
        srv2 = _server(workers, tmp_path)
        got = rows + _drain(_get(f"http://127.0.0.1:{srv2.port}"
                                 f"/v1/statement/{qid}/{token}"))
        assert len(got) == len(oracle[STREAM_QUERY])
        assert _sorted(got) == oracle[STREAM_QUERY]
        assert srv2._runner.executor.coordinator_reattaches == 1
        assert qid not in srv2._journal.pending()
    finally:
        if srv2 is not None:
            srv2.stop()


def test_nonrecoverable_surfaces_failed(tmp_path):
    """A journaled query with no spools and no re-runnable statement
    becomes FAILED / CoordinatorRestarted — loudly, never a hang."""
    j = CheckpointJournal(str(tmp_path))
    j.admit("deadq", "", {}, None)
    del j
    srv = PrestoTpuServer({"tpch": TpchConnector(SF, device="cpu")},
                          port=0, page_rows=PAGE_ROWS,
                          checkpoint_dir=str(tmp_path), device="cpu")
    try:
        q = srv.manager.get("deadq")
        assert q is not None
        assert q.done.wait(30), "re-attach hung instead of failing"
        assert q.state == "FAILED"
        assert q.error["errorName"] == "CoordinatorRestarted"
        # the journal remembers the failure for the next boot
        rec = CheckpointJournal(str(tmp_path)).pending()["deadq"]
        assert rec["state"] == "failed"
    finally:
        srv.stop()


def test_reattach_query_no_plane_raises():
    class _Ex:
        coordinator_reattaches = 0

        def count_reattach(self):
            self.coordinator_reattaches += 1

    with pytest.raises(CoordinatorRestarted):
        reattach_query({"sql": "select 1"}, None, _Ex())


# ------------------------------------------- spool-corruption fault
def test_spool_corrupt_fault_recovers_and_fails_loudly(oracle):
    """FAULT_SPOOL_CORRUPT_EVERY over real HTTP (the same-process fast
    path has no wire to corrupt): sparse corruption re-fetches the same
    token; total corruption climbs the replay ladder and fails the query
    loudly — never garbage rows."""
    from presto_tpu_torch.dist.dcn import DcnQueryFailed, DcnRunner
    from presto_tpu_torch.server.worker import unregister_local_runtime

    ws = _workers()
    uris = [w.uri for w in ws]
    for u in uris:
        unregister_local_runtime(u)
    coord = DcnRunner({"tpch": TpchConnector(SF, device="cpu")}, uris,
                      default_catalog="tpch", device="cpu",
                      session_props={"stage_scheduler": "true",
                                     "page_rows": PAGE_ROWS,
                                     "retry_backoff_ms": 20})
    try:
        for u in uris:
            _post_fault(u, FAULT_SPOOL_CORRUPT_EVERY=7)
        assert _sorted(coord.execute(DAG_QUERY)) == oracle[DAG_QUERY]
        for u in uris:
            _post_fault(u, FAULT_SPOOL_CORRUPT_EVERY=1)
        with pytest.raises(DcnQueryFailed, match="PageWireError|corrupt"):
            coord.execute(DAG_QUERY)
    finally:
        coord.close()
        for w in ws:
            w.stop()


@pytest.mark.cuda
def test_reattach_on_the_card(tmp_path):
    """The zero-relaunch re-attach with the workers and both
    coordinators on the card; the rows equal the port's single process
    on the CPU (held to presto_tpu's by the cases above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from presto_tpu_torch.runner import LocalRunner

    want = _sorted(LocalRunner({"tpch": TpchConnector(SF, device="cpu")},
                               session={"page_rows": PAGE_ROWS},
                               device="cpu").execute(DAG_QUERY).rows)
    ws = _workers("cuda")
    srv = _server(ws, tmp_path, "cuda")
    park = ctr = srv2 = None
    try:
        qid, _rec, park = _park_query_at_root(srv)
        _kill(srv, qid)
        ctr = _CreateCounter(ws)
        srv2 = _server(ws, tmp_path, "cuda")
        got = _drain(_get(f"http://127.0.0.1:{srv2.port}"
                          f"/v1/statement/{qid}/0"))
        assert _sorted(got) == want
        assert srv2._runner.executor.coordinator_reattaches == 1
        assert ctr.created == []
    finally:
        if ctr is not None:
            ctr.restore()
        if park is not None:
            park.set()
        if srv2 is not None:
            srv2.stop()
        for w in ws:
            w.stop()
