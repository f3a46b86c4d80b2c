"""Fault-tolerant stage scheduling of presto_tpu_torch on the CPU.

Two in-process WorkerServers per engine (SF 0.01, page_rows 2^13) that
serve only over HTTP, as workers in other processes would: every
exchange and the root's drain cross the wire, and a worker's death is
its stop() (its socket closed, its spools freed). The same scenarios
run against presto_tpu's DcnRunner over presto_tpu's workers — its
rows and its recovery counters (task_retries, nonleaf_replays,
workers_excluded, speculative_tasks_won/lost) are the yardstick — and
against sqlite:

  - a worker stopped after the first stage (leaf replay, [source-lost]
    consumer replays), restarted on its uri and rejoining the next
    query's pool; with task_retry_attempts=0 a dead worker fails the
    query;
  - a worker stopped after the non-leaf stage, lost during the root's
    drain (non-leaf replay from the surviving spools);
  - injected submit and fetch drops (POST /v1/fault);
  - a straggler (FAULT_TASK_EXEC_DELAY_MS) raced by speculation.

Port counterparts of tests/test_dcn.py and tests/test_stagedag.py
cases: the heartbeat gate, the query deadline, the fault overlay, the
TaskRetryEvent, mid-query re-admission; and a replayed task's pages
hash equal to the original's, while a replay whose prefix differs
fails the query loudly. The parity coordinators get a 60 s heartbeat
interval, so no background ping or re-admission probe lands inside a
scenario and the counters are a function of the scenario alone.
"""

import collections
import hashlib
import json
import time
import urllib.request

import pytest
import torch

from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist import spool as SPOOL
from presto_tpu_torch.dist.dcn import DcnQueryFailed, DcnRunner, _TaskState
from presto_tpu_torch.exec.executor import QueryDeadlineExceeded
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server.worker import (
    WorkerServer,
    unregister_local_runtime,
)

SF = 0.01
PAGE_ROWS = 1 << 13
Q3_FAMILY = (
    "select o_orderkey, count(*) c, sum(l_quantity) q from lineitem "
    "join orders on l_orderkey = o_orderkey "
    "where o_orderkey < 1000 group by o_orderkey order by o_orderkey"
)
Q_AGG = ("select l_returnflag, count(*), sum(l_quantity) "
         "from lineitem group by l_returnflag")
SESSION = {"join_distribution_type": "partitioned",
           "device_exchange_enabled": "true",
           "generated_join_enabled": "false", "stage_scheduler": "true",
           "page_rows": PAGE_ROWS, "retry_backoff_ms": 20}
RECOVERY = ("task_retries", "nonleaf_replays", "workers_excluded",
            "speculative_tasks_won", "speculative_tasks_lost")
# the straggler's original is abandoned once its copy wins, so its
# delay never lengthens the wall; a long one keeps the race one-sided
# on a loaded machine
STRAGGLER_MS = 10000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _multiset(rows):
    return collections.Counter(map(repr, rows))


def post_fault(uri, **cfg):
    req = urllib.request.Request(
        f"{uri}/v1/fault", data=json.dumps(cfg).encode(),
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=5).close()


class Cluster:
    """In-process workers of one engine serving over HTTP only, each
    stoppable (its death) and restartable on its uri, and the
    coordinators over them (all closed at teardown)."""

    def __init__(self, engine: str, n: int = 2, conn=None):
        self.engine = engine
        if engine == "port":
            self.cat = {"tpch": conn or TpchConnector(SF, device="cpu")}
        else:
            from presto_tpu.connectors.tpch import TpchConnector as R

            self.cat = {"tpch": R(SF)}
        self.workers = [self._boot(0, i) for i in range(n)]
        self.uris = [self.uri(i) for i in range(n)]
        self.coords = []

    def uri(self, i):
        return f"http://127.0.0.1:{self.workers[i].port}"

    def _boot(self, port, i):
        if self.engine == "port":
            w = WorkerServer(self.cat, port=port, node_id=f"w{i}",
                             default_catalog="tpch", page_rows=PAGE_ROWS,
                             device="cpu")
            w.start()
            unregister_local_runtime(w.uri)
            return w
        from presto_tpu.server import worker as RW

        w = RW.WorkerServer(self.cat, port=port, node_id=f"w{i}",
                            default_catalog="tpch", page_rows=PAGE_ROWS)
        # its open connections, so stop() can drop them as the port's
        # worker does (a dead node answers nothing)
        conns = set()
        w._conns = conns
        orig = w._httpd.process_request

        def track(request, addr, _orig=orig, _conns=conns):
            _conns.add(request)
            _orig(request, addr)

        w._httpd.process_request = track
        w._httpd.daemon_threads = True
        w.start()
        RW.unregister_local_runtime(f"http://127.0.0.1:{w.port}")
        return w

    def stop(self, i):
        w = self.workers[i]
        if self.engine == "port":
            w.stop()
            return
        import socket

        w.stop()
        w._httpd.server_close()
        for c in list(w._conns):
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        with w._tasks_lock:
            w.tasks.clear()

    def restart(self, i):
        self.workers[i] = self._boot(self.workers[i].port, i)

    def is_up(self, i):
        try:
            urllib.request.urlopen(f"{self.uri(i)}/v1/info",
                                   timeout=2).close()
            return True
        except OSError:
            return False

    def heal(self):
        """Every worker up with no fault configured."""
        for i in range(len(self.workers)):
            if not self.is_up(i):
                self.restart(i)
            post_fault(self.uri(i))

    def coord(self, uris=None, parity=True, listeners=(), **props):
        session = {**SESSION, **props}
        uris = list(uris or self.uris)
        if self.engine == "port":
            c = DcnRunner(self.cat, uris, default_catalog="tpch",
                          session_props=session, listeners=listeners,
                          device="cpu")
        else:
            from presto_tpu.dist.dcn import DcnRunner as RefRunner

            c = RefRunner(self.cat, uris, default_catalog="tpch",
                          page_rows=PAGE_ROWS, listeners=listeners,
                          session_props={**session,
                                         "stage_scheduler": "true"})
        if parity:
            c.heartbeat.interval_s = 60.0
        self.coords.append(c)
        return c

    def close(self):
        for c in self.coords:
            c.close()
        for i in range(len(self.workers)):
            self.stop(i)


@pytest.fixture(scope="module")
def port():
    c = Cluster("port")
    yield c
    c.close()


@pytest.fixture(scope="module")
def ref():
    c = Cluster("ref")
    yield c
    c.close()


@pytest.fixture(scope="module")
def db():
    from presto_tpu.connectors.tpch import TpchConnector as R
    from tests.oracle import load_sqlite

    return load_sqlite(R(SF), ["lineitem", "orders"])


@pytest.fixture(scope="module")
def want(db):
    return {q: db.execute(q).fetchall() for q in (Q3_FAMILY, Q_AGG)}


def _same(rows, want_rows):
    """Rows equal the sqlite oracle's as a multiset (the oracle holds
    decimals as the engines' scaled integers)."""
    return _multiset(map(tuple, rows)) == _multiset(map(tuple, want_rows))


def run(cluster, sql=Q3_FAMILY, *, stage_hook=None, root_hook=None,
        faults=None, **props):
    """One scenario on one engine: (rows, recovery counters, wall,
    coordinator). `stage_hook(cluster, fid)` and `root_hook(cluster,
    scheduler)` inject the fault; `faults` maps worker index -> the
    POST /v1/fault config."""
    cluster.heal()
    for i, cfg in (faults or {}).items():
        post_fault(cluster.uri(i), **cfg)
    coord = cluster.coord(**props)
    if stage_hook is not None:
        coord._stage_hook = lambda fid: stage_hook(cluster, fid)
    if root_hook is not None:
        coord._root_hook = lambda sched: root_hook(cluster, sched)
    try:
        t0 = time.monotonic()
        rows = coord.execute(sql)
        wall = time.monotonic() - t0
    finally:
        coord.close()
        cluster.heal()
    ex = coord.runner.executor
    return rows, {k: getattr(ex, k) for k in RECOVERY}, wall, coord


def both(port, ref, want, sql=Q3_FAMILY, **kw):
    """The scenario on both engines: equal rows (== sqlite) and equal
    recovery counters. Returns the port's counters and coordinator."""
    rows, ctr, _wall, coord = run(port, sql, **kw)
    rrows, rctr, _rwall, _ = run(ref, sql, **kw)
    assert _multiset(rows) == _multiset(rrows)
    assert _same(rows, want[sql])
    assert ctr == rctr
    return ctr, coord


def _stop_after(fid):
    def hook(cluster, f):
        if f == fid:
            cluster.stop(1)
    return hook


# --------------------------------------------------- node loss
def test_worker_stopped_after_the_first_stage(port, ref, want):
    """Counterpart of test_dcn.py::test_two_real_processes_and_kill:
    the worker dies after stage 0; its leaf task replays, the next
    stage's submit to it fails over, and the consumers that lost its
    spool fail with [source-lost] and replay."""
    ctr, coord = both(port, ref, want, stage_hook=_stop_after(0))
    assert ctr["task_retries"] >= 1
    assert ctr["nonleaf_replays"] >= 1
    assert ctr["workers_excluded"] == 1
    # the dead node served no later stage
    dead = port.uri(1)
    assert all(dead not in p for p in coord.last_scheduler.stage_pools[2:])


def test_worker_lost_during_the_root_drain(port, ref, want):
    """Counterpart of test_stagedag.py::
    test_nonleaf_kill_recovers_via_spool_replay: the worker hosting a
    finished NON-LEAF task dies before the root drains it; the task and
    the upstream spools it read replay on the survivor."""
    from presto_tpu_torch.exec.counters import snapshot

    ctr, coord = both(port, ref, want, stage_hook=_stop_after(2))
    assert ctr["nonleaf_replays"] >= 1
    assert ctr["workers_excluded"] == 1
    assert snapshot(coord.runner.executor)["nonleaf_replays"] >= 1


def test_stopped_worker_rejoins_and_retries_zero_fails(port, want):
    """A worker restarted on the same uri rejoins the next query's pool;
    task_retry_attempts=0 fails a query over a dead worker cleanly."""
    coord = port.coord(parity=False)
    coord._stage_hook = lambda fid: fid == 0 and port.stop(1)
    try:
        assert _same(coord.execute(Q3_FAMILY), want[Q3_FAMILY])
        assert port.uri(1) in coord._excluded
        # the survivor alone, then the restarted worker again
        assert _same(coord.execute(Q3_FAMILY), want[Q3_FAMILY])
        coord._stage_hook = None
        port.restart(1)
        time.sleep(coord.heartbeat.interval_s)  # the probe's rate limit
        assert _same(coord.execute(Q3_FAMILY), want[Q3_FAMILY])
        assert coord.last_pool == port.uris
        assert port.uri(1) not in coord._excluded
        port.stop(1)
        coord0 = port.coord(parity=False, task_retry_attempts=0)
        with pytest.raises(DcnQueryFailed):
            coord0.execute(Q3_FAMILY)
        assert coord0.runner.executor.task_retries == 0
    finally:
        coord.close()
        port.heal()


# --------------------------------------------------- injected faults
def test_submit_and_fetch_drops_recovered(port, ref, want):
    """Counterpart of test_dcn.py::test_fault_delay_and_drop_recovered
    and ::test_submit_drop_recovers_to_other_worker: one worker refuses
    every task submit, the other drops every 3rd results fetch and
    delays each by 20 ms. On the aggregation the root alone fetches from
    the dropping worker, one request at a time, so every drop recovers
    on its first retry (concurrent fetchers could land one fetcher's
    four attempts on four drops, a lost node)."""
    ctr, _ = both(port, ref, want, sql=Q_AGG, faults={
        0: {"FAULT_DROP_EVERY": 3, "FAULT_DELAY_MS": 20},
        1: {"FAULT_SUBMIT_DROP_EVERY": 1}})
    assert ctr["task_retries"] >= 1
    assert ctr["workers_excluded"] >= 1
    assert ctr["nonleaf_replays"] == 0  # submit failures replay nothing


def test_straggler_raced_by_speculation(port, ref, want):
    """Counterpart of test_stagedag.py::test_speculation_dedupe: every
    task on one worker stalls; each stage's copy on the other worker
    wins and no row is duplicated."""
    ctr, coord = both(port, ref, want, speculation_enabled=True, faults={
        1: {"FAULT_TASK_EXEC_DELAY_MS": STRAGGLER_MS}})
    assert ctr["speculative_tasks_won"] >= 1
    assert ctr["task_retries"] == 0


def test_spool_corruption_refetched_or_fails_loudly(port, ref, want):
    """Counterpart of test_checkpoint.py::
    test_spool_corrupt_fault_recovers_and_fails_loudly:
    FAULT_SPOOL_CORRUPT_EVERY flips a byte inside served page bodies.
    Sparse corruption (every 7th body of each worker) is caught by the
    consumers' decode and fetched again at the same token: rows equal
    sqlite, no task retried. Total corruption (every body) retries the
    consuming tasks until their attempts run out, then fails the query
    loudly with the corrupt frame's cause, in both engines: never
    garbage rows."""
    rows, ctr, _wall, _ = run(port, faults={
        0: {"FAULT_SPOOL_CORRUPT_EVERY": 7},
        1: {"FAULT_SPOOL_CORRUPT_EVERY": 7}})
    assert _same(rows, want[Q3_FAMILY])
    assert ctr["task_retries"] == 0
    from presto_tpu.dist.dcn import DcnQueryFailed as RefQueryFailed

    retries = {}
    for name, cluster, failed in (("port", port, DcnQueryFailed),
                                  ("ref", ref, RefQueryFailed)):
        with pytest.raises(failed, match="PageWireError|corrupt") as err:
            run(cluster, faults={0: {"FAULT_SPOOL_CORRUPT_EVERY": 1},
                                 1: {"FAULT_SPOOL_CORRUPT_EVERY": 1}})
        assert "retries exhausted" in str(err.value)
        retries[name] = cluster.coords[-1].runner.executor.task_retries
    assert retries["port"] >= 1 and retries["ref"] >= 1


# --------------------------------------------------- the pool
def test_heartbeat_failed_node_never_picked(port, want):
    dead_uri = "http://127.0.0.1:1"  # nothing listens there
    coord = port.coord(port.uris + [dead_uri], parity=False)
    for _ in range(3):  # fail_after: 3 consecutive misses
        coord.heartbeat.check_once()
    assert not coord.heartbeat.is_alive(dead_uri)
    assert _same(coord.execute(Q_AGG), want[Q_AGG])
    assert coord.last_pool == port.uris
    assert coord.runner.executor.task_retries == 0
    assert coord.runner.executor.workers_excluded == 0


def test_midquery_worker_readmission(port, want):
    """An excluded worker whose probe succeeds rejoins at the NEXT
    STAGE of the same query."""
    coord = port.coord(parity=False)
    excluded_at = {}

    def hook(fid):
        if not excluded_at:
            coord._excluded.add(port.uri(1))  # a healthy worker
            excluded_at["fid"] = fid

    coord._stage_hook = hook
    assert _same(coord.execute(Q3_FAMILY), want[Q3_FAMILY])
    pools = coord.last_scheduler.stage_pools
    assert len(pools) == 3
    assert port.uri(1) in pools[-1]
    assert port.uri(1) not in coord._excluded


def test_dcn_query_deadline_expires(port):
    """query_max_run_time is a real deadline: a per-fetch delay longer
    than it surfaces QueryDeadlineExceeded instead of hanging."""
    port.heal()
    post_fault(port.uri(0), FAULT_DELAY_MS=600)
    try:
        coord = port.coord(parity=False, query_max_run_time=400)
        with pytest.raises(QueryDeadlineExceeded):
            coord.execute(Q3_FAMILY)
    finally:
        port.heal()


def test_runtime_fault_config_overlays_env(monkeypatch):
    """The /v1/fault config is an OVERLAY: posted keys win (an explicit
    0 disables an environment fault), absent keys fall back to the
    environment, {} restores it."""
    ws = WorkerServer.__new__(WorkerServer)
    ws.fault_config = {}
    monkeypatch.setenv("FAULT_DELAY_MS", "500")
    assert ws._fault("FAULT_DELAY_MS") == 500
    ws.fault_config = {"FAULT_DELAY_MS": 0}
    assert ws._fault("FAULT_DELAY_MS") == 0
    ws.fault_config = {"FAULT_DELAY_MS": 7}
    assert ws._fault("FAULT_DELAY_MS") == 7
    ws.fault_config = {}
    assert ws._fault("FAULT_DELAY_MS") == 500


def test_task_retry_event_dispatched(port, want):
    from presto_tpu_torch import events as E

    seen = []

    class Listener(E.EventListener):
        def task_retried(self, event):
            seen.append(event)

    port.heal()
    post_fault(port.uri(0), FAULT_SUBMIT_DROP_EVERY=1)
    try:
        coord = port.coord(parity=False, listeners=[Listener()])
        assert _same(coord.execute(Q_AGG), want[Q_AGG])
    finally:
        port.heal()
    assert seen, "no TaskRetryEvent dispatched"
    ev = seen[0]
    assert ev.from_uri == port.uri(0)
    assert ev.to_uri in port.uris
    assert ev.attempt == 1


# --------------------------------------------------- the replay prefix
class _Shifted:
    """A connector whose lineitem quantities are shifted: a replay on
    its worker regenerates DIFFERENT pages."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def gen_body(self, table, n, names):
        return None  # no fused generation: every scan reads the pages

    def page_for_split(self, split, columns=None):
        from presto_tpu_torch.page import Block, Page

        page = self._inner.page_for_split(split, columns)
        if split.table != "lineitem":
            return page
        names = columns or [c.name for c in
                            self._inner.table_schema("lineitem").columns]
        blocks = list(page.blocks)
        i = list(names).index("l_quantity")
        b = blocks[i]
        blocks[i] = Block(data=b.data + 100, type=b.type, nulls=b.nulls,
                          dictionary=b.dictionary)
        return Page(blocks=tuple(blocks), valid=page.valid)


def _kill_root_input_after_one_fetch(cluster, sched):
    """Between the last stage barrier and the root's drain: the worker
    of the first root-input task dies on its second results fetch, so
    the root has consumed its first window of frames."""
    t = sched.tasks[sched.dag.root_inputs[0]][0]
    post_fault(t.placement.uri, FAULT_KILL_AFTER_FETCHES=1)


@pytest.mark.parametrize("shifted", [False, True])
def test_replayed_prefix_hashes_equal_or_fails_loudly(port, want, shifted):
    """The root drains a task, its worker dies after the first fetch,
    and the task replays on the other worker: with the same data its
    regenerated pages hash equal to the consumed prefix (rows equal);
    with different data the query fails loudly."""
    conn = TpchConnector(SF, device="cpu")
    other = Cluster("port", n=1,
                    conn=_Shifted(conn) if shifted else conn)
    try:
        cluster = port
        coord = cluster.coord([port.uri(0), other.uri(0)], parity=False)
        coord._root_hook = lambda sched: _kill_root_input_after_one_fetch(
            cluster, sched)
        port.heal()
        # the leaf stage's tasks ran on both workers; the root drains
        # task 0 (port.uri(0)) first
        if shifted:
            with pytest.raises(DcnQueryFailed, match="DIFFERENT page"):
                coord.execute(Q_AGG)
        else:
            rows = coord.execute(Q_AGG)
            assert _same(rows, want[Q_AGG])
            assert coord.runner.executor.task_retries == 1
    finally:
        port.heal()
        other.close()


def test_replayed_task_pages_hash_equal(port):
    """The same task payload run twice, on two workers, spools pages
    whose frames hash equal; the coordinator's prefix check accepts the
    replay's prefix and rejects a different one."""
    port.heal()
    r = LocalRunner(port.cat, device="cpu")
    from presto_tpu_torch.dist import plan_serde
    from presto_tpu_torch.dist.fragmenter import clip_for_shipping

    plan = r.plan("select l_orderkey, l_quantity from lineitem "
                  "where l_orderkey < 3000")
    payload = {"splitTable": "lineitem", "splitIndex": 0,
               "splitCount": 2, "outputPartitions": 1,
               "session": dict(SESSION),
               "fragment": plan_serde.dumps(clip_for_shipping(plan))}
    digests = []
    for i in range(2):
        req = urllib.request.Request(
            f"{port.uri(i)}/v1/task",
            data=json.dumps({**payload, "taskId": f"hash.t{i}"}).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=10).close()
        h = hashlib.sha256()
        n = 0
        for blob in SPOOL.fetch_spool_blobs(port.uri(i), f"hash.t{i}", 0):
            h.update(blob)
            n += 1
        digests.append(h.hexdigest())
    assert n >= 1 and digests[0] == digests[1]
    coord = port.coord(parity=False)
    st = _TaskState(uri=port.uri(0), task_id="hash.t0")
    pages = list(coord._fetch_pages(st, None))
    assert st.next_token == len(pages) == n
    assert coord._prefix_matches(port.uri(1), "hash.t1", st, None)
    st.hasher.update(b"x")
    assert not coord._prefix_matches(port.uri(1), "hash.t1", st, None)


def test_card_float_segment_sums_are_ordered():
    """The card's float segment sums (ops/agg.segment_sum_ordered: rows
    sorted stably by segment, no atomics; and the sorted grouping's
    span reduction) equal index_add_'s sums to 9 digits and repeat bit
    for bit, which a replayed task's prefix check needs; integer sums
    keep index_add_."""
    import numpy as np

    from presto_tpu_torch.ops import agg

    rng = np.random.default_rng(20261018)
    ids = torch.from_numpy(rng.integers(0, 97, 5000))
    data = torch.from_numpy(rng.standard_normal(5000) * 1e6)
    want = torch.zeros(98, dtype=torch.float64).index_add_(0, ids, data)
    got = agg.segment_sum_ordered(data, ids, 98)
    assert torch.allclose(got, want, rtol=1e-9, atol=1e-6)
    again = agg.segment_sum_ordered(data, ids, 98)
    assert torch.equal(got.view(torch.int64), again.view(torch.int64))
    # empty segments sum to 0
    assert float(got[97]) == 0.0
    # the sorted grouping's route (the card's float SUM there): each
    # group's span of the group-sorted rows reduced in order, nulls and
    # invalid rows left out, empty groups flagged
    valid = torch.from_numpy(rng.random(5000) >= 0.1)
    nulls = torch.from_numpy(rng.random(5000) < 0.05)
    groups = agg.compute_groups_sorted([ids], [None], valid, 128)
    sums, empty = agg._sorted_aggregate(groups, agg.SUM, 128, data, nulls)
    live = valid & ~nulls
    want = torch.zeros(129, dtype=torch.float64).index_add_(
        0, torch.where(live, ids, 128), data)
    counts = torch.zeros(129, dtype=torch.int64).index_add_(
        0, torch.where(live, ids, 128), torch.ones_like(ids))
    # group g of the sorted route is the g-th smallest key present
    keys = torch.unique(ids[valid])
    assert torch.allclose(sums[:len(keys)], want[keys], rtol=1e-9,
                          atol=1e-6)
    assert torch.equal(empty[:len(keys)], counts[keys] == 0)
    assert bool(empty[len(keys):].all())
