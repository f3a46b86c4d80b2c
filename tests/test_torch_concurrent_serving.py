"""The port's concurrent serving path (memory arbiter on: a runner and
executor per query, resource groups, the shared LaunchBatcher) raced by
protocol clients under the armed lock sanitizer: the counterparts of
tests/test_concurrent_serving.py and of
``tests/test_views_prepared.py::test_views_persist_on_concurrent_server``.

The reference's two wall-clock races are not copied. Overlap is shown
by a listener that parks the first query, its admission still held,
until a second query is RUNNING (impossible on the serial path); the
priority order is read from the resource-group manager's admission
order, with every waiter queued before the slot frees. The result cache
is not ported, so every statement executes."""

import re
import threading
import time
import urllib.request

import pytest
import torch

from presto_tpu_torch.client import StatementClient
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.obs import sanitizer as SAN
from presto_tpu_torch.server import PrestoTpuServer
from presto_tpu_torch.server.resource_groups import (
    ResourceGroupManager,
    ResourceGroupSpec,
)

CLIENTS = 8
ROUNDS = 3
STATEMENTS = (
    "select count(*), sum(n_nationkey) from nation",
    "select r_name, count(*) from region group by r_name "
    "order by r_name",
    "select n_regionkey, count(*), max(n_name) from nation "
    "group by n_regionkey order by n_regionkey",
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def conn():
    return TpchConnector(0.01, device="cpu")


@pytest.fixture(scope="module")
def server_url(conn):
    srv = PrestoTpuServer({"tpch": conn}, port=0, device="cpu",
                          memory_budget_bytes=1 << 32)
    yield f"http://127.0.0.1:{srv.start()}"
    srv.stop()


def _race(server_url, batching: str):
    """CLIENTS x ROUNDS x STATEMENTS at once with cross_query_batching
    pinned: ({sql: {rows variant}}, errors)."""
    results = [[] for _ in range(CLIENTS)]
    errors = []

    def client(idx: int) -> None:
        cl = StatementClient(server_url, user=f"xq{idx}", catalog="tpch")
        cl.session_properties["cross_query_batching"] = batching
        # a wide window makes the 8-thread overlap near certain on a
        # loaded box; correctness must hold at any window
        cl.session_properties["cross_query_batch_wait_ms"] = "50"
        for _ in range(ROUNDS):
            for sql in STATEMENTS:
                try:
                    res = cl.execute(sql)
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(repr(e))
                    continue
                if res.error is not None:
                    errors.append(str(res.error))
                else:
                    results[idx].append((sql, tuple(map(tuple, res.rows))))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "client hung"
    for idx in range(CLIENTS):
        assert len(results[idx]) + len(errors) >= ROUNDS * len(STATEMENTS)
    by_sql = {}
    for idx in range(CLIENTS):
        for sql, rows in results[idx]:
            by_sql.setdefault(sql, set()).add(rows)
    return by_sql, errors


def _scrape(server_url: str, name: str) -> int:
    with urllib.request.urlopen(server_url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    m = re.search(rf"^{re.escape(name)} (\d+)", text, re.M)
    return int(m.group(1)) if m else 0


def test_batched_vs_solo_row_parity_and_width(server_url, conn):
    """Under 8 concurrent clients the batched path returns rows equal to
    the solo path and to sqlite, while riding shared launches
    (queries_per_launch > 1), with the sanitizer silent."""
    from presto_tpu_torch import queries as PQ
    from tests.oracle import rows_match

    if SAN.is_armed():
        SAN.reset()
    solo, errs_solo = _race(server_url, "false")
    batched, errs_b = _race(server_url, "true")
    assert not errs_solo, errs_solo[:5]
    assert not errs_b, errs_b[:5]
    for sql in STATEMENTS:
        assert len(solo[sql]) == 1, f"solo divergence for {sql!r}"
        assert len(batched[sql]) == 1, f"batched divergence for {sql!r}"
        assert solo[sql] == batched[sql], sql
    db = PQ.load_sqlite(conn, ["nation", "region"])
    for sql in STATEMENTS:
        engine_rows = [tuple(r) for r in next(iter(batched[sql]))]
        rows_match(engine_rows, [tuple(r) for r in
                                 db.execute(sql).fetchall()])
    width = _scrape(server_url, "presto_tpu_queries_per_launch")
    assert width > 1, f"queries_per_launch={width}: nothing shared"
    assert _scrape(server_url, "presto_tpu_cross_query_batches_total") > 0
    assert _scrape(server_url,
                   "presto_tpu_split_batch_fallbacks_total") == 0
    if SAN.is_armed():
        assert SAN.violation_count() == 0, SAN.report()


def test_concurrent_queries_overlap():
    """The memory budget replaces the serial lock: the first query to
    complete parks in its completion listener, its resource-group slot
    and memory reservation still held, until another query is RUNNING."""
    srv = None
    overlapped = []

    class Park:
        def query_created(self, e):
            pass

        def query_completed(self, e):
            if overlapped:
                return
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                others = [q for q in srv.manager.queries()
                          if q.id != e.query_id and q.state == "RUNNING"]
                if others:
                    overlapped.append((e.query_id, others[0].id))
                    return
                time.sleep(0.005)
            overlapped.append(None)

    rg = ResourceGroupManager([ResourceGroupSpec(
        "global", ".*", hard_concurrency=4, max_queued=16)])
    srv = PrestoTpuServer({"tpch": TpchConnector(0.01, device="cpu")},
                          port=0, device="cpu", resource_groups=rg,
                          memory_budget_bytes=1 << 32,
                          event_listeners=[Park()])
    base = f"http://127.0.0.1:{srv.start()}"
    rows = {}
    try:
        def run(i, sql):
            rows[i] = StatementClient(base).execute(sql).rows

        sqls = ("select count(*), sum(o_totalprice) from orders",
                "select o_orderpriority, count(*) from orders group by "
                "o_orderpriority order by o_orderpriority",
                "select count(*) from lineitem where l_quantity < 25")
        threads = [threading.Thread(target=run, args=(i, s))
                   for i, s in enumerate(sqls)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        srv.stop()
    assert overlapped and overlapped[0] is not None, "never overlapped"
    serial = PrestoTpuServer({"tpch": TpchConnector(0.01, device="cpu")},
                             port=0, device="cpu")
    c = StatementClient(f"http://127.0.0.1:{serial.start()}")
    try:
        for i, s in enumerate(sqls):
            assert rows[i] == c.execute(s).rows
    finally:
        serial.stop()


def test_priority_scheduling_by_admission_order():
    """One global slot held by a parked query; three batch queries, then
    an interactive one, queue behind it. When the slot frees, the
    interactive query is admitted first; every scan still completes."""
    rg = ResourceGroupManager([ResourceGroupSpec(
        "global", ".*", hard_concurrency=1, max_queued=64, sub_groups=(
            ResourceGroupSpec("inter", "inter.*", hard_concurrency=1,
                              max_queued=64, priority=100),
            ResourceGroupSpec("batch", "batch.*", hard_concurrency=1,
                              max_queued=64)))])
    order = []
    acquire = rg.acquire

    def recording_acquire(sel, should_abort=None):
        ok = acquire(sel, should_abort)
        if ok:
            order.append(sel.name)
        return ok

    rg.acquire = recording_acquire
    release = threading.Event()

    class Park:
        def query_created(self, e):
            pass

        def query_completed(self, e):
            if e.user == "batch_hold":
                release.wait(60)

    srv = PrestoTpuServer({"tpch": TpchConnector(0.003, device="cpu")},
                          port=0, device="cpu", resource_groups=rg,
                          memory_budget_bytes=1 << 32,
                          event_listeners=[Park()])
    base = f"http://127.0.0.1:{srv.start()}"
    scan = "select count(*) from lineitem where l_quantity < 30"
    results = {}
    try:
        def run(user, sql):
            res = StatementClient(base, user=user, catalog="tpch").execute(
                sql)
            results[user] = res.error

        threads = [threading.Thread(target=run, args=("batch_hold", scan))]
        threads[0].start()
        deadline = time.monotonic() + 60
        while order != ["global.batch"]:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        for user, sql in (("batch0", scan), ("batch1", scan),
                          ("batch2", scan),
                          ("inter0", "select count(*) from nation")):
            t = threading.Thread(target=run, args=(user, sql))
            t.start()
            threads.append(t)
            while rg.snapshot()[0]["queued"] < len(threads) - 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        # every waiter in the fair-scheduling line before the slot frees
        while len(rg._waiters) < len(threads) - 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        release.set()
        for t in threads:
            t.join(timeout=120)
    finally:
        release.set()
        srv.stop()
    assert all(err is None for err in results.values()), results
    assert len(results) == 5
    assert order[:2] == ["global.batch", "global.inter"], order
    if SAN.is_armed():
        assert SAN.violation_count() == 0, SAN.report()


def test_group_memory_share_governs_peak():
    """A query admitted through a group with a tiny memory_share runs
    with its device budget seeded from membudget.group_share_bytes, and
    EXPLAIN ANALYZE's peak_device_bytes stays under that share."""
    from presto_tpu_torch.exec import membudget as MB

    share = 2.0 ** -12
    budget = MB.group_share_bytes(share)
    assert budget == 1 << 24
    rg = ResourceGroupManager([ResourceGroupSpec(
        "global", ".*", hard_concurrency=4, max_queued=64, sub_groups=(
            ResourceGroupSpec("small", "small.*", hard_concurrency=2,
                              max_queued=64, memory_share=share),
            ResourceGroupSpec("rest", ".*", hard_concurrency=2,
                              max_queued=64)))])
    srv = PrestoTpuServer({"tpch": TpchConnector(0.01, device="cpu")},
                          port=0, device="cpu", resource_groups=rg,
                          memory_budget_bytes=1 << 32)
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        res = StatementClient(base, user="small0", catalog="tpch").execute(
            "explain analyze select l_returnflag, count(*), "
            "sum(l_extendedprice) from lineitem group by l_returnflag "
            "order by l_returnflag")
        assert res.error is None, res.error
        text = "\n".join(str(r[0]) for r in res.rows)
        m = re.search(r"peak_device_bytes=(\d+)", text)
        assert m is not None, text
        assert 0 < int(m.group(1)) <= budget
        q = [q for q in srv.manager.queries()][-1]
        assert q.session.get("device_memory_budget") == budget
    finally:
        srv.stop()


def test_views_persist_on_concurrent_server():
    """The arbiter path builds a fresh runner per query: the view and
    prepared-statement registries are server-wide (the reference's
    tests/test_views_prepared.py case)."""
    srv = PrestoTpuServer({"tpch": TpchConnector(0.01, device="cpu")},
                          port=0, page_rows=1 << 13, device="cpu",
                          memory_budget_bytes=1 << 32)
    srv.start()
    try:
        c = StatementClient(server=f"http://127.0.0.1:{srv.port}")
        c.execute("create view sv as select count(*) c from nation")
        assert int(c.execute("select c from sv").rows[0][0]) == 25
        c.execute("prepare sp from select ? * 2")
        assert int(c.execute("execute sp using 21").rows[0][0]) == 42
    finally:
        srv.stop()


def test_concurrent_metrics_overlay_the_per_query_executors(server_url):
    """The concurrent path's executors are discarded per query: their
    launches accumulate into the process totals /metrics reads."""
    before = _scrape(server_url, "presto_tpu_program_launches")
    c = StatementClient(server_url, catalog="tpch")
    for sql in STATEMENTS:
        assert c.execute(sql).error is None
    assert _scrape(server_url, "presto_tpu_program_launches") >= \
        before + len(STATEMENTS)
    assert _scrape(server_url, "presto_tpu_peak_queued") >= 1


@pytest.mark.cuda
def test_batched_vs_solo_on_the_card():
    """The concurrent server on the card: 8 clients with batching off,
    then on (warmed first, so the timed race replays captured batched
    programs): equal rows, shared launches, no failed shared launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    srv = PrestoTpuServer({"tpch": TpchConnector(0.01, device="cuda")},
                          port=0, memory_budget_bytes=1 << 34)
    url = f"http://127.0.0.1:{srv.start()}"
    try:
        solo, errs = _race(url, "false")
        _race(url, "true")
        batched, errs_b = _race(url, "true")
        assert not errs and not errs_b, (errs + errs_b)[:5]
        for sql in STATEMENTS:
            assert len(solo[sql]) == 1 and batched[sql] == solo[sql], sql
        assert _scrape(url, "presto_tpu_queries_per_launch") > 1
        assert _scrape(url, "presto_tpu_cross_query_batches_total") > 0
        assert _scrape(url, "presto_tpu_split_batch_fallbacks_total") == 0
    finally:
        srv.stop()
