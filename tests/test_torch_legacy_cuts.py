"""The legacy distributed cuts of presto_tpu_torch on the CPU.

Counterparts of tests/test_dcn.py: the port's DcnRunner at its default
session (``stage_scheduler`` auto) over two in-process port workers
takes the partial-aggregation cut ("roundrobin", or "hash" where both
big join sides co-partition), the union cut ("union-roundrobin" /
"union-hash") or the local fallback, exactly where presto_tpu's
DcnRunner does over two presto_tpu workers with the same session and
``partition_threshold``: ``last_distribution`` is the same string, and
the rows equal the reference's, the single-process run's and sqlite's
(integers and decimals exactly, doubles to 9 digits). Also: the cut
analysis returns the reference's cuts and specs on the same plans,
HashSplitConnector assigns every row to the reference's worker, a
shipped fragment runs verbatim, submit drops, fetch drops and a worker
stopped mid-fetch recover through ``_recover_task``, all three
``stage_scheduler`` modes run, and a union cut whose fragment overflows
its capacities returns every row after the worker's boosted retry — or,
with the retries cut to one attempt, fails the query loudly — never a
truncated result.
"""

import collections
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.dcn import DcnQueryFailed, DcnRunner
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server import worker as W
from presto_tpu_torch.server.worker import WorkerServer
from tests.test_sql_tpch import ENGINE_SQL, ORACLE, compare

SF = 0.01
PAGE_ROWS = 1 << 13
SESSION = {"page_rows": PAGE_ROWS, "retry_backoff_ms": 10}

UNION_MULTIJOIN = (
    "select c_name, o_orderkey, l_quantity from customer "
    "join orders on c_custkey = o_custkey "
    "join lineitem on l_orderkey = o_orderkey "
    "where l_quantity > 45")
UNION_TOPN = (
    "select o_orderkey, l_extendedprice from orders "
    "join lineitem on l_orderkey = o_orderkey "
    "order by l_extendedprice desc, o_orderkey limit 7")
UNION_HASH = (
    "select o_orderpriority, l_shipmode from orders "
    "join lineitem on l_orderkey = o_orderkey "
    "where l_quantity > 49")
APPROX = ("select o_orderpriority, approx_distinct(o_custkey), "
          "sum(o_totalprice) from orders group by o_orderpriority")
Q_AGG = ("select l_returnflag, count(*), sum(l_quantity) "
         "from lineitem group by l_returnflag")
NULL_KEYS = ("select o_orderpriority, count(*), sum(l_quantity) "
             "from orders, lineitem where o_orderkey = l_orderkey "
             "group by o_orderpriority")
# a non-unique build (4 partsupp rows per part): each probe page's
# matches outgrow the join's first output capacity, so every worker's
# fragment overflows on its first attempt
OVERFLOW = ("select l_orderkey, l_linenumber, ps_suppkey from lineitem "
            "join partsupp on l_partkey = ps_partkey "
            "where l_orderkey < 3000")
UNSAFE = [
    # DISTINCT masks: MarkDistinct below the cut would double-count
    "select count(distinct o_custkey) from orders",
    # outer join below the cut: null extension is not split-safe
    "select count(*) from customer left join orders "
    "on c_custkey = o_custkey",
    # NOT IN (anti join) below the cut
    "select count(*) from customer where c_custkey not in "
    "(select o_custkey from orders)",
]
SELF_JOIN = ("select count(*) from orders o1, orders o2 "
             "where o1.o_orderkey = o2.o_orderkey")
# sqlite texts of the plain-row queries (decimals as the engines' scaled
# integers)
SQLITE = {
    UNION_MULTIJOIN: UNION_MULTIJOIN.replace("> 45", "> 4500"),
    UNION_TOPN: UNION_TOPN,
    UNION_HASH: UNION_HASH.replace("> 49", "> 4900"),
    Q_AGG: Q_AGG,
    NULL_KEYS: NULL_KEYS,
    OVERFLOW: OVERFLOW,
    SELF_JOIN: SELF_JOIN,
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _multiset(rows):
    return collections.Counter(map(repr, map(tuple, rows)))


def _nine(rows):
    """Rows with doubles cut to 9 significant digits (the port-vs-
    reference rule), as a multiset."""
    def cell(v):
        return float(f"{v:.9g}") if isinstance(v, float) else v
    return collections.Counter(repr(tuple(map(cell, r))) for r in rows)


def _post_fault(uri, **cfg):
    req = urllib.request.Request(
        f"{uri}/v1/fault", data=json.dumps(cfg).encode(),
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=5).close()


class Cluster:
    """Two in-process workers of one engine and the coordinators built
    over them (closed at teardown)."""

    def __init__(self, engine):
        self.engine = engine
        if engine == "port":
            self.cat = {"tpch": TpchConnector(SF, device="cpu")}
            self.workers = [WorkerServer(self.cat, node_id=f"w{i}",
                                         default_catalog="tpch",
                                         page_rows=PAGE_ROWS, device="cpu")
                            for i in range(2)]
        else:
            from presto_tpu.connectors.tpch import TpchConnector as R
            from presto_tpu.server.worker import WorkerServer as RW

            self.cat = {"tpch": R(SF)}
            self.workers = [RW(self.cat, node_id=f"w{i}",
                               default_catalog="tpch", page_rows=PAGE_ROWS)
                            for i in range(2)]
        self.uris = [f"http://127.0.0.1:{w.start()}" for w in self.workers]
        self.coords = []

    def coord(self, uris=None, **kw):
        kw.setdefault("session_props", dict(SESSION))
        if self.engine == "port":
            c = DcnRunner(self.cat, list(uris or self.uris),
                          default_catalog="tpch", device="cpu", **kw)
        else:
            from presto_tpu.dist.dcn import DcnRunner as RefRunner

            c = RefRunner(self.cat, list(uris or self.uris),
                          default_catalog="tpch", page_rows=PAGE_ROWS, **kw)
        self.coords.append(c)
        return c

    def close(self):
        for c in self.coords:
            c.close()
        for w in self.workers:
            w.stop()


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
def coord(port):
    return port.coord()


@pytest.fixture(scope="module")
def ref_coord(ref):
    return ref.coord()


@pytest.fixture(scope="module")
def single():
    return LocalRunner({"tpch": TpchConnector(SF, device="cpu")},
                       session={"page_rows": PAGE_ROWS}, device="cpu")


@pytest.fixture(scope="module")
def db():
    from presto_tpu.connectors.tpch import TpchConnector as R
    from tests.oracle import load_sqlite

    return load_sqlite(R(SF), R(SF).tables())


def _both(port_coord, ref_coord, sql):
    """The query on both engines at the same session: equal rows and
    the same distribution string. Returns the port's rows."""
    got = port_coord.execute(sql)
    want = ref_coord.execute(sql)
    assert port_coord.last_distribution == ref_coord.last_distribution
    assert _nine(got) == _nine(want)
    return got


# ------------------------------------------------ the cuts, row parity
@pytest.mark.parametrize("qid", [1, 6, 3])
def test_dcn_matches_single(qid, coord, ref_coord, single, db):
    got = _both(coord, ref_coord, ENGINE_SQL[qid])
    assert coord.last_distribution == "roundrobin"
    assert _multiset(got) == _multiset(single.execute(ENGINE_SQL[qid]).rows)
    oracle_sql, modes = ORACLE[qid]
    compare(qid, got, db.execute(oracle_sql).fetchall(), modes)


def test_dcn_approx_distinct(coord, ref_coord, single):
    got = _both(coord, ref_coord, APPROX)
    assert _multiset(got) == _multiset(single.execute(APPROX).rows)


def test_bare_scan_query_falls_back_local(coord, single):
    # a bare scan has no useful union cut: generation beats the wire
    q = "select r_regionkey, r_name from region order by r_regionkey"
    assert coord.execute(q) == single.execute(q).rows
    assert coord.last_distribution == "local"


def test_nondistributable_runs_locally_with_all_workers_down(port, ref,
                                                             single):
    """An empty ALIVE pool fails only queries that NEED workers: a bare
    scan still runs locally (under auto the DAG is not tried without a
    live worker); a distributable aggregation fails loudly, in both
    engines."""
    from presto_tpu.dist.dcn import DcnQueryFailed as RefFailed

    dead = ["http://127.0.0.1:1", "http://127.0.0.1:2"]
    for cluster, failed in ((port, DcnQueryFailed), (ref, RefFailed)):
        c = cluster.coord(uris=dead)
        for _ in range(3):  # fail_after: 3 consecutive misses
            c.heartbeat.check_once()
        q = "select r_name from region"
        assert _multiset(c.execute(q)) == _multiset(single.execute(q).rows)
        assert c.last_distribution == "local"
        with pytest.raises(failed, match="no ALIVE workers"):
            c.execute("select count(*) from region")


@pytest.mark.parametrize("sql", [UNION_MULTIJOIN, UNION_TOPN],
                         ids=["multijoin", "topn"])
def test_union_cut(sql, coord, ref_coord, single, db):
    """A multi-join with no aggregation distributes by the union cut
    (workers run the row-local join subtree over their split share; the
    coordinator unions the pages and runs the top-N above)."""
    got = _both(coord, ref_coord, sql)
    assert coord.last_distribution == "union-roundrobin"
    want = single.execute(sql).rows
    if sql == UNION_TOPN:
        assert got == want  # the coordinator's top-N orders the union
    assert _multiset(got) == _multiset(want)
    assert _multiset(got) == _multiset(db.execute(SQLITE[sql]).fetchall())


def test_union_cut_hash_partitioned(port, ref, single, db):
    """Both big join sides co-partition (union-hash): worker build state
    is 1/N with no aggregation in the plan."""
    c = port.coord(partition_threshold=10_000)
    r = ref.coord(partition_threshold=10_000)
    got = _both(c, r, UNION_HASH)
    assert c.last_distribution == "union-hash"
    assert _multiset(got) == _multiset(single.execute(UNION_HASH).rows)
    assert _multiset(got) == _multiset(
        db.execute(SQLITE[UNION_HASH]).fetchall())


def test_shipped_fragment_is_executed_verbatim(port, single):
    """Plan SHIPPING, not replay: a hand-edited fragment no SQL plans is
    executed exactly, its pages buffered for the token-acked fetch."""
    from presto_tpu_torch.dist import plan_serde, serde
    from presto_tpu_torch.exec import plan as P
    from presto_tpu_torch.expr import ir as E

    plan = single.plan("select o_orderkey from orders")
    scan = plan
    while not isinstance(scan, P.TableScan):
        scan = scan.children()[0]
    t0 = single.executor.output_types(scan)[0]
    fragment = P.Filter(
        source=P.Project(source=scan, exprs=(E.input_ref(0, t0),)),
        predicate=E.call("lt", E.input_ref(0, t0), E.const(100, t0)))
    payload = {"taskId": "ship-test.0",
               "fragment": plan_serde.dumps(fragment),
               "splitTable": "orders", "splitIndex": 0, "splitCount": 1,
               "session": {}}
    uri = port.uris[0]
    req = urllib.request.Request(
        f"{uri}/v1/task", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=30).close()
    from presto_tpu_torch.dist import spool as SPOOL

    rows, token = [], 0
    deadline = time.time() + 60
    while time.time() < deadline:
        r = urllib.request.urlopen(
            f"{uri}/v1/task/ship-test.0/results/{token}", timeout=30)
        if r.status == 204:
            if r.headers.get("X-Done") == "1":
                break
            continue
        for body in SPOOL.iter_response_frames(r):
            rows.extend(serde.deserialize_page(body).to_pylist())
            token += 1
    want = [r for r in single.execute("select o_orderkey from orders").rows
            if r[0] < 100]
    assert _multiset(rows) == _multiset(want)
    urllib.request.urlopen(urllib.request.Request(
        f"{uri}/v1/task/ship-test.0", method="DELETE"), timeout=5).close()


@pytest.mark.parametrize("sql", UNSAFE + [SELF_JOIN],
                         ids=["distinct", "left-join", "anti-join",
                              "self-join"])
def test_unsafe_shapes_fall_back(sql, coord, ref_coord, single):
    """DISTINCT masks, outer and anti joins below the cut and a
    self-join of the fact table are not split-safe: no legacy cut takes
    them (the stage DAG or a local run does), and the rows stay
    right."""
    got = _both(coord, ref_coord, sql)
    assert coord.last_distribution in ("stage-dag", "local")
    assert _multiset(got) == _multiset(single.execute(sql).rows)


def test_session_props_reach_both_halves(port, ref, single):
    props = {**SESSION, "spill_threshold_bytes": 1 << 15}
    c = port.coord(session_props=props)
    r = ref.coord(session_props=props)
    q = ("select o_custkey, count(*) from orders group by o_custkey "
         "order by 2 desc, 1 limit 5")
    got = _both(c, r, q)
    assert got == single.execute(q).rows
    # the coordinator's final stage honored the session too
    assert c.runner.executor.spill_bytes == 1 << 15


@pytest.mark.parametrize("sql", [ENGINE_SQL[3], NULL_KEYS],
                         ids=["q3", "null-keys"])
def test_partitioned_join_across_workers(sql, port, ref, single):
    """The hash fan-out: orders and lineitem co-partition on orderkey
    (threshold between customer's 1.5k and orders' 15k rows), customer
    replicates; a NULL partition key lands on exactly one worker."""
    c = port.coord(partition_threshold=10_000)
    r = ref.coord(partition_threshold=10_000)
    got = _both(c, r, sql)
    assert c.last_distribution == "hash"
    assert _multiset(got) == _multiset(single.execute(sql).rows)


# ------------------------------------------------- the cut analysis
CUT_PLANS = [ENGINE_SQL[1], ENGINE_SQL[3], ENGINE_SQL[5], ENGINE_SQL[6],
             UNION_MULTIJOIN, UNION_TOPN, UNION_HASH, APPROX, NULL_KEYS,
             SELF_JOIN] + UNSAFE


def test_hash_fanout_shape_analysis(single):
    """The reference's cuts and co-partitioning specs on the same
    plans, at the thresholds the tests use and at 1 (every table big:
    orders would need both o_custkey and o_orderkey, so Q3 is refused).
    """
    from presto_tpu.connectors.tpch import TpchConnector as R
    from presto_tpu.runner import LocalRunner as RefRunner
    from presto_tpu.server import worker as RW

    rsingle = RefRunner({"tpch": R(SF)}, page_rows=PAGE_ROWS)

    def shape(mod, plan, catalogs, thr):
        cut = mod.find_partial_cut(plan)
        split = mod.largest_table(plan, catalogs)
        out = {"split": split, "cut": type(cut).__name__}
        if cut is not None:
            cut_split = mod.largest_table(cut.source, catalogs)
            out["agg"] = (mod.hash_fanout_plan(cut, catalogs, thr),
                          cut_split,
                          cut_split is not None
                          and mod.fanout_safe(cut, cut_split))
        ucut = mod.find_union_cut(plan, split) if split else None
        out["union"] = None if ucut is None else (
            type(ucut).__name__,
            mod.row_local_scan_count(ucut, split),
            mod.hash_fanout_source(ucut, catalogs, thr))
        return out

    for sql in CUT_PLANS:
        for thr in (1, 10_000, 1 << 17):
            got = shape(W, single.plan(sql), single.catalogs, thr)
            want = shape(RW, rsingle.plan(sql), rsingle.catalogs, thr)
            assert got == want, (sql, thr)
    cut = W.find_partial_cut(single.plan(ENGINE_SQL[3]))
    assert W.hash_fanout_plan(cut, single.catalogs,
                              partition_threshold=1) is None
    assert W.hash_fanout_plan(cut, single.catalogs,
                              partition_threshold=10_000) == {
        "tpch.orders": "o_orderkey", "tpch.lineitem": "l_orderkey"}


def test_hash_split_assignment_equals_reference():
    """HashSplitConnector's row-to-worker assignment is the reference's
    bit for bit; the masks of all workers cover every row once, NULL
    keys on worker 0."""
    import jax.numpy as jnp

    from presto_tpu import types as RT
    from presto_tpu.connectors.split_filter import (
        HashSplitConnector as RefHash,
    )
    from presto_tpu.page import Block as RBlock
    from presto_tpu.page import Page as RPage
    from presto_tpu_torch import types as T
    from presto_tpu_torch.connectors.split_filter import HashSplitConnector
    from presto_tpu_torch.page import Block, Page

    rng = np.random.default_rng(7)
    n = 4096
    keys = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    nulls = rng.random(n) < 0.05
    valid = rng.random(n) < 0.9
    count = 3
    covered = np.zeros(n, dtype=np.int64)
    for index in range(count):
        port_page = Page(blocks=(Block(
            torch.from_numpy(keys.copy()), T.BIGINT,
            torch.from_numpy(nulls.copy())),),
            valid=torch.from_numpy(valid.copy()))
        ref_page = RPage(blocks=(RBlock(
            jnp.asarray(keys), RT.BIGINT, jnp.asarray(nulls)),),
            valid=jnp.asarray(valid))
        mine = HashSplitConnector(None, {"t": "k"}, index, count) \
            ._mask_page(port_page, "t", ["k"]).valid.numpy()
        theirs = np.asarray(RefHash(None, {"t": "k"}, index, count)
                            ._mask_page(ref_page, "t", ["k"]).valid)
        assert (mine == theirs).all(), index
        covered += mine
        if index:
            assert not (mine & nulls).any()
    assert (covered == valid).all()
    assert (covered[nulls & valid] == 1).all()


def test_hash_split_scans_equal_reference_pages():
    """Scans through HashSplitConnector over the same generated table
    keep the same rows on each worker in both engines, and the worker
    shares partition the table."""
    from presto_tpu.connectors.split_filter import (
        HashSplitConnector as RefHash,
    )
    from presto_tpu.connectors.tpch import TpchConnector as R
    from presto_tpu_torch.connectors.split_filter import HashSplitConnector

    cols = ["o_orderkey", "o_custkey"]  # the partition column added
    port_conn, ref_conn = TpchConnector(SF, device="cpu"), R(SF)
    seen = []
    for index in range(2):
        mine = [r for p in HashSplitConnector(
                    port_conn, {"orders": "o_orderkey"}, index, 2)
                .pages("orders", ["o_custkey"], PAGE_ROWS)
                for r in p.to_pylist()]
        theirs = [r for p in RefHash(
                      ref_conn, {"orders": "o_orderkey"}, index, 2)
                  .pages("orders", ["o_custkey"], PAGE_ROWS)
                  for r in p.to_pylist()]
        assert mine == theirs and mine
        seen.extend(mine)
    whole = [r[1:] for p in port_conn.pages("orders", cols, PAGE_ROWS)
             for r in p.to_pylist()]
    assert _multiset(seen) == _multiset(whole)


# --------------------------------------------------- stage_scheduler
@pytest.mark.parametrize("mode,want", [
    ("auto", "roundrobin"), ("false", "roundrobin"), ("true", "stage-dag")])
def test_stage_scheduler_modes_run(mode, want, port, ref, single):
    """All three modes run: auto and false take the aggregation cut,
    true forces the DAG; the rows equal the reference's under the same
    mode."""
    props = {**SESSION, "stage_scheduler": mode}
    c = port.coord(session_props=props)
    r = ref.coord(session_props=props)
    got = _both(c, r, Q_AGG)
    assert c.last_distribution == want
    assert _multiset(got) == _multiset(single.execute(Q_AGG).rows)


def test_false_mode_never_uses_the_dag(port, single):
    """stage_scheduler=false: a plan no legacy cut takes runs locally,
    where auto hands it to the DAG."""
    got = port.coord(session_props={**SESSION, "stage_scheduler": "false"}
                     ).execute(SELF_JOIN)
    assert port.coords[-1].last_distribution == "local"
    assert got == single.execute(SELF_JOIN).rows


# ------------------------------------------------------- recovery
def test_submit_drop_recovers_to_other_worker(port, single, db):
    """Every task submit to one worker answers HTTP 500: the submit
    retry re-dispatches that split share to the other ALIVE worker."""
    from presto_tpu_torch import events as E

    seen = []

    class Listener(E.EventListener):
        def task_retried(self, event):
            seen.append(event)

    c = port.coord(listeners=[Listener()])
    _post_fault(port.uris[1], FAULT_SUBMIT_DROP_EVERY=1)
    try:
        got = c.execute(Q_AGG)
    finally:
        _post_fault(port.uris[1])
    assert _multiset(got) == _multiset(db.execute(Q_AGG).fetchall())
    ex = c.runner.executor
    assert ex.task_retries >= 1 and ex.workers_excluded >= 1
    assert seen and seen[0].from_uri == port.uris[1]
    assert seen[0].to_uri == port.uris[0] and seen[0].attempt == 1


def test_fault_delay_and_drop_recovered(port, db):
    """Page-proxy faults (a delay and an HTTP 500 on every third fetch)
    are absorbed by the token-acked fetch: same rows, no task retry."""
    c = port.coord()
    for u in port.uris:
        _post_fault(u, FAULT_DELAY_MS=20, FAULT_DROP_EVERY=3)
    try:
        got = c.execute(UNION_MULTIJOIN)
    finally:
        for u in port.uris:
            _post_fault(u)
    assert c.last_distribution == "union-roundrobin"
    assert _multiset(got) == _multiset(
        db.execute(SQLITE[UNION_MULTIJOIN]).fetchall())
    assert c.runner.executor.task_retries == 0


def test_worker_lost_mid_fetch_recovers(single, db):
    """A worker stopped after serving its first results fetch: the lost
    split share re-runs on the survivor (_recover_task), the fetch
    resumes at the consumed token after the prefix check, and the rows
    equal sqlite's; with task_retry_attempts=0 the loss fails the
    query."""
    cat = {"tpch": TpchConnector(SF, device="cpu")}

    def pair():
        ws = [WorkerServer(cat, node_id=f"k{i}", default_catalog="tpch",
                           page_rows=PAGE_ROWS, device="cpu")
              for i in range(2)]
        for w in ws:
            w.start()
        return ws

    for attempts in (3, 0):
        ws = pair()
        c = DcnRunner(cat, [w.uri for w in ws], default_catalog="tpch",
                      device="cpu", session_props={
                          **SESSION, "task_retry_attempts": attempts})
        try:
            _post_fault(ws[1].uri, FAULT_KILL_AFTER_FETCHES=1)
            if attempts:
                got = c.execute(UNION_MULTIJOIN)
                assert _multiset(got) == _multiset(
                    db.execute(SQLITE[UNION_MULTIJOIN]).fetchall())
                ex = c.runner.executor
                assert ex.task_retries >= 1 and ex.workers_excluded >= 1
            else:
                with pytest.raises(DcnQueryFailed):
                    c.execute(UNION_MULTIJOIN)
        finally:
            c.close()
            for w in ws:
                w.stop()


# -------------------------------------------------- overflow discipline
def test_union_cut_overflow_retries_or_fails_loudly(port, single, db,
                                                    monkeypatch):
    """Each worker's union-cut fragment overflows its join's output
    capacity on the first attempt: its pages publish only after the
    boosted retry ran clean, so the rows are all there. With the ladder
    cut to one attempt the task fails, its re-dispatches fail alike, and
    the query fails loudly — never a truncated result."""
    from presto_tpu_torch.exec import executor as EX

    boosts = []
    orig = EX.Executor.stream_fragment

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        boosts.append(self.capacity_boost_retries)
        return out

    monkeypatch.setattr(EX.Executor, "stream_fragment", spy)
    c = port.coord()
    got = c.execute(OVERFLOW)
    assert c.last_distribution == "union-roundrobin"
    assert len(boosts) == 2 and min(boosts) >= 1
    want = db.execute(SQLITE[OVERFLOW]).fetchall()
    assert len(got) == len(want)
    assert _multiset(got) == _multiset(want)

    monkeypatch.setattr(EX, "_MAX_ATTEMPTS", 1)
    with pytest.raises(DcnQueryFailed, match="capacity overflow persisted"):
        port.coord().execute(OVERFLOW)


def _boot_subprocess_worker(extra_env=None):
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    for k in ("FAULT_DELAY_MS", "FAULT_DROP_EVERY",
              "FAULT_KILL_AFTER_FETCHES", "FAULT_SUBMIT_DROP_EVERY"):
        env.pop(k, None)
    env.update(extra_env or {})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "presto_tpu_torch.server.worker",
         "--port", "0", "--suite", "tpch", "--scale", str(SF),
         "--page-rows", str(PAGE_ROWS), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env,
        cwd=root, text=True)
    info = json.loads(proc.stdout.readline())
    return proc, f"http://127.0.0.1:{info['port']}"


def test_two_real_processes_and_kill(single):
    """Q3 across two worker PROCESSES: one hard-exits after serving one
    results fetch (worker death in the middle of the fetch loop); the
    lost split share re-runs on the survivor and the rows equal the
    single process, task_retries >= 1; the killed worker stays excluded
    and a second query runs on the survivor alone; with
    task_retry_attempts=0 a dead worker fails the query cleanly."""
    p1, u1 = _boot_subprocess_worker()
    p2, u2 = _boot_subprocess_worker({"FAULT_KILL_AFTER_FETCHES": "1"})
    cat = {"tpch": TpchConnector(SF, device="cpu")}
    coords = []
    try:
        c = DcnRunner(cat, [u1, u2], default_catalog="tpch",
                      fetch_retries=2, device="cpu",
                      session_props={**SESSION, "retry_backoff_ms": 20})
        coords.append(c)
        want = single.execute(ENGINE_SQL[3]).rows
        assert _multiset(c.execute(ENGINE_SQL[3])) == _multiset(want)
        ex = c.runner.executor
        assert ex.task_retries >= 1 and ex.workers_excluded >= 1
        p2.wait(timeout=10)  # the fault really killed the process
        assert p2.poll() is not None
        assert _multiset(c.execute(ENGINE_SQL[3])) == _multiset(want)
        c0 = DcnRunner(cat, [u1, u2], default_catalog="tpch",
                       fetch_retries=2, device="cpu",
                       session_props={**SESSION, "task_retry_attempts": 0})
        coords.append(c0)
        with pytest.raises(DcnQueryFailed):
            c0.execute(ENGINE_SQL[3])
    finally:
        for c in coords:
            c.close()
        for p in (p1, p2):
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
