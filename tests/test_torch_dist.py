"""The stage-DAG distributed path of presto_tpu_torch on the CPU.

Two port WorkerServers (module fixture, SF 0.01, page_rows 2^13) and a
port DcnRunner: TPC-H Q1, Q3, Q5 and a forced-partitioned Q3-family
(tests/test_device_exchange.py's) equal the port's LocalRunner (held to
presto_tpu by tests/test_torch_sql_tpch.py) and the sqlite oracle, with
the kernel dispatch points on and off and the generated join off (the
materialized joins this path holds); the DAG is engaged, the
exchanges spooled and, with kernels on, K4's twin partitions them. The
default session (generated joins, and the workers' leaf fragments fused
with split batching forced) gives the same rows. Also:
the device spool's HTTP fetch equals its local read and re-fetches
byte-identically, the spool_exchange_bytes budget spills to disk, a
failed task fails the query with DcnQueryFailed under
task_retry_attempts=0 and re-dispatches to the healthy worker under the
default, and the planes once left out (the mesh exchange, the fleet
cache probe) run with the local runner's rows. Every coordinator is
closed (its heartbeat thread) when the module's workers stop."""

import collections
import json
import time
import urllib.request

import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu_torch import cuda
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist import plan_serde
from presto_tpu_torch.dist import serde as SERDE
from presto_tpu_torch.dist import spool as SPOOL
from presto_tpu_torch.dist.dcn import DcnQueryFailed, DcnRunner
from presto_tpu_torch.dist.fragmenter import clip_for_shipping
from presto_tpu_torch.exec import graphs
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server.worker import WorkerServer, local_runtime
from tests.oracle import load_sqlite
from tests.test_sql_tpch import ENGINE_SQL, ORACLE, compare


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once, and torch's default of one thread per core spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SF = 0.01
PAGE_ROWS = 1 << 13
Q3_FAMILY = (
    "select o_orderkey, count(*) c from lineitem "
    "join orders on l_orderkey = o_orderkey "
    "where o_orderkey < 1000 group by o_orderkey order by o_orderkey"
)
QUERIES = {1: ENGINE_SQL[1], 3: ENGINE_SQL[3], 5: ENGINE_SQL[5],
           "q3_family": Q3_FAMILY}


def _multiset(rows):
    return collections.Counter(map(repr, rows))


def _worker(node_id, conn=None):
    w = WorkerServer({"tpch": conn or TpchConnector(SF, device="cpu")},
                     node_id=node_id, default_catalog="tpch",
                     page_rows=PAGE_ROWS, device="cpu")
    w.start()
    return w


_COORDS = []


@pytest.fixture(scope="module")
def workers():
    ws = [_worker("w1"), _worker("w2")]
    yield [w.uri for w in ws]
    for c in _COORDS:
        c.close()
    _COORDS.clear()
    for w in ws:
        w.stop()


@pytest.fixture(scope="module")
def local_rows():
    r = LocalRunner({"tpch": TpchConnector(SF, device="cpu")},
                    session={"page_rows": PAGE_ROWS,
                             "generated_join_enabled": "false"},
                    device="cpu")
    return {q: r.execute(sql).rows for q, sql in QUERIES.items()}


@pytest.fixture(scope="module")
def db():
    return load_sqlite(RefConnector(SF), RefConnector(SF).tables())


def _coord(workers, **props):
    session = {"join_distribution_type": "partitioned",
               "device_exchange_enabled": "true",
               "generated_join_enabled": "false",
               "stage_scheduler": "true",
               "page_rows": PAGE_ROWS, "retry_backoff_ms": 20}
    session.update(props)
    coord = DcnRunner({"tpch": TpchConnector(SF, device="cpu")}, workers,
                      default_catalog="tpch", session_props=session,
                      device="cpu")
    _COORDS.append(coord)
    return coord


@pytest.mark.parametrize("kernels", ["true", "false"])
@pytest.mark.parametrize("q", list(QUERIES))
def test_dcn_equals_local_runner_and_sqlite(q, kernels, workers,
                                            local_rows, db):
    coord = _coord(workers, pallas_join_enabled=kernels)
    cuda.reset_counts()
    rows = coord.execute(QUERIES[q])
    assert coord.last_distribution == "stage-dag"
    assert coord.runner.executor.spooled_exchange_pages > 0
    assert coord.runner.executor.stages_scheduled == len(
        coord.last_scheduler.dag.fragments)
    assert _multiset(rows) == _multiset(local_rows[q])
    if q == "q3_family":
        assert _multiset(rows) == _multiset(db.execute(Q3_FAMILY)
                                            .fetchall())
    else:
        oracle_sql, modes = ORACLE[q]
        compare(q, rows, db.execute(oracle_sql).fetchall(), modes)
    if q != 1:  # Q1 has no repartition edge: 4 groups gather
        assert (cuda.plain_calls["part_ids"] > 0) == (kernels == "true")
    assert not cuda.launches  # no kernel runs on the CPU
    # the coordinator drained same-process spools without HTTP
    assert coord.runner.executor.mesh_local_exchanges > 0


@pytest.mark.parametrize("props", [
    {"device_exchange_enabled": "false"},
    {"device_exchange_enabled": "auto"},
    {"spool_exchange_bytes": 1},
    {"join_distribution_type": "auto"},
])
def test_exchange_tiers_give_the_same_rows(props, workers, local_rows):
    # the spool tiers are what this case is about: the mesh plane off
    coord = _coord(workers, mesh_exchange_mode="false", **props)
    cuda.reset_counts()
    rows = coord.execute(Q3_FAMILY)
    assert _multiset(rows) == _multiset(local_rows["q3_family"])
    assert coord.runner.executor.ici_exchanges == 0
    if props.get("device_exchange_enabled") in ("false", "auto"):
        # auto is off on a CPU executor: the host splitmix64 tier
        assert not cuda.plain_calls["part_ids"]


def _post_task(uri, payload):
    req = urllib.request.Request(
        f"{uri}/v1/task", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=10).close()


def _wait_task(uri, task_id):
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        with urllib.request.urlopen(f"{uri}/v1/task/{task_id}",
                                    timeout=5) as resp:
            st = json.loads(resp.read().decode())
        if st["state"] != "RUNNING":
            return st
        time.sleep(0.05)
    raise AssertionError("task did not finish")


@pytest.mark.parametrize("budget", [1 << 30, 1])
def test_spool_http_fetch_equals_local_read(budget, workers):
    """A device-tier spool serves its Pages to a same-process reader and
    serializes them lazily for HTTP; re-fetches are byte-identical. A
    1-byte budget sends every page to the disk tier instead."""
    uri = workers[0]
    task_id = f"lazy{budget}.f0.t0"
    r = LocalRunner({"tpch": TpchConnector(SF, device="cpu")},
                    device="cpu")
    sql = "select o_orderkey, o_custkey from orders where o_orderkey < 500"
    plan = r.plan(sql)
    _post_task(uri, {
        "taskId": task_id, "splitTable": "orders", "splitIndex": 0,
        "splitCount": 1, "outputPartitions": 3, "outputKeys": [0],
        "session": {"device_exchange_enabled": "true",
                    "spool_exchange_bytes": budget},
        "fragment": plan_serde.dumps(clip_for_shipping(plan)),
    })
    st = _wait_task(uri, task_id)
    assert st["state"] == "FINISHED", st.get("error")
    task = local_runtime(uri).get_task(task_id)
    kinds = {e[0] == "page" for p in task.spool.parts for e in p.entries}
    assert kinds == {budget > 1}
    direct, fetched = [], []
    for p in range(3):
        for page in SPOOL.local_source_pages(uri, task_id, p):
            direct.extend(page.to_pylist())
        blobs = list(SPOOL.fetch_spool_blobs(uri, task_id, p))
        for blob in blobs:
            fetched.extend(SERDE.deserialize_page(blob).to_pylist())
        assert list(SPOOL.fetch_spool_blobs(uri, task_id, p)) == blobs
    assert sorted(direct) == sorted(fetched)
    assert sorted(direct) == sorted(r.execute(sql).rows)
    assert len(direct) == sum(st["spoolRows"])
    # ack one partition: a later fetch of it fails loudly (410)
    assert SPOOL.ack_spool(uri, task_id, 0)
    with pytest.raises(SPOOL.SourceTaskFailed, match="released"):
        list(SPOOL.fetch_spool_blobs(uri, task_id, 0))
    urllib.request.urlopen(urllib.request.Request(
        f"{uri}/v1/task/{task_id}", method="DELETE"), timeout=5).close()
    assert local_runtime(uri).get_task(task_id) is None


class _Broken:
    """A connector whose scans fail (a deterministic task failure)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def page_for_split(self, split, columns=None):
        raise RuntimeError("injected scan failure")

    def gen_body(self, table, n, names):
        # the fused scan generates through gen_body, not page_for_split
        raise RuntimeError("injected scan failure")


def test_failed_task_fails_the_query(workers):
    """task_retry_attempts=0: the first task failure fails the query
    cleanly, every task released."""
    bad = _worker("bad", _Broken(TpchConnector(SF, device="cpu")))
    try:
        coord = _coord([workers[0], bad.uri], task_retry_attempts=0)
        t0 = time.monotonic()
        with pytest.raises(DcnQueryFailed, match="injected scan failure"):
            coord.execute(Q3_FAMILY)
        assert time.monotonic() - t0 < 60
        # every task of the failed query was released
        assert local_runtime(workers[0]).task_count() == 0
        assert coord.runner.executor.task_retries == 0
    finally:
        bad.stop()


def test_failed_task_redispatches_to_the_healthy_worker(workers,
                                                        local_rows):
    """The default task_retry_attempts re-dispatches each failed scan
    task to the healthy worker: the rows equal, the failing worker (a
    task error, not a lost node) is not excluded."""
    bad = _worker("bad", _Broken(TpchConnector(SF, device="cpu")))
    try:
        coord = _coord([workers[0], bad.uri])
        rows = coord.execute(Q3_FAMILY)
        assert _multiset(rows) == _multiset(local_rows["q3_family"])
        ex = coord.runner.executor
        # one scan task per leaf stage landed on the bad worker
        assert ex.task_retries == 2
        assert ex.workers_excluded == 0
        assert local_runtime(workers[0]).task_count() == 0
    finally:
        bad.stop()


def test_unsplittable_plan_runs_locally(workers):
    coord = _coord(workers)
    # a bare scan is not worth a task: generation beats the wire
    rows = coord.execute("select n_nationkey from nation")
    assert coord.last_distribution == "local"
    assert sorted(rows) == [(k,) for k in range(25)]


@pytest.mark.parametrize("prop,value", [
    ("mesh_exchange_mode", "true"),
    ("mesh_exchange_mode", "auto"),
    ("result_cache_remote_probe", "true"),
    ("hash_partition_count", 4),
])
def test_left_out_planes_raise(prop, value, workers, local_rows):
    """The planes once left out are ported. The fleet cache probe is
    the default (true) and, with the result cache off, probes nothing.
    Under mesh_exchange_mode true/auto (and at the default session with
    hash_partition_count set) the DAG over these in-process workers
    lowers its repartition edges to the mesh all_to_all, with no
    fallback, and gives the local runner's rows."""
    coord = _coord(workers, **{prop: value})
    rows = coord.execute(Q3_FAMILY)
    assert _multiset(rows) == _multiset(local_rows["q3_family"])
    ex = coord.runner.executor
    assert ex.ici_exchanges >= 1 and ex.ici_bytes > 0
    assert ex.mesh_exchange_fallbacks == 0


@pytest.mark.parametrize("q", [1, 3, 5])
def test_default_session_fuses_on_the_workers(q, workers, local_rows, db):
    """The reference's default TPC-H path over the stage DAG: generated
    joins where a build side scans a generator, and each task's leaf
    fragment fused into one program per batch of its splits."""
    coord = _coord(workers, generated_join_enabled="true",
                   fused_partial_agg_enabled="true", split_batch_size="64")
    graphs.clear()
    rows = coord.execute(QUERIES[q])
    assert coord.last_distribution == "stage-dag"
    # a task's share of the lineitem splits ran as one batched program
    # (Q5's lineitem leaf is a bare scan, which is no pipeline)
    assert any(prog.batch > 1 for _key, prog in graphs.cached()) == (q != 5)
    assert _multiset(rows) == _multiset(local_rows[q])
    oracle_sql, modes = ORACLE[q]
    compare(q, rows, db.execute(oracle_sql).fetchall(), modes)
