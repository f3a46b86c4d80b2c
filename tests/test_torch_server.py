"""The coordinator's /v1/statement protocol (presto_tpu_torch/server/)
against presto_tpu's server, and the port's counterparts of
tests/test_server.py and of ``test_dml_over_the_wire``.

Protocol parity: one reference server and one port server over the same
catalogs (TPC-H SF 0.001, memory, blackhole); each statement goes to both
as raw protocol requests, following nextUri, and every document's
``columns``, ``data`` (and its page sizes), ``updateType``, ``error``
(errorName and message), final state and ``X-Presto-Set-Session``
headers must be equal, integers, decimals and dates exactly and doubles
to 9 significant digits. Ids, URIs, walls and /v1/info's backend are
masked. The reference server runs with ``result_cache_enabled=false``
and the port's serial path defaults it off, so neither side caches."""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from presto_tpu.connectors.blackhole import BlackholeConnector as RefHole
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.server import PrestoTpuServer as RefServer
from presto_tpu_torch.client import StatementClient
from presto_tpu_torch.connectors.blackhole import BlackholeConnector
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.executor import DistExecutor, make_mesh
from presto_tpu_torch.server import PrestoTpuServer

SF = 0.001
PAGE_ROWS = 1 << 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_server(**kw):
    return PrestoTpuServer(
        {"tpch": TpchConnector(SF, device="cpu"),
         "memory": MemoryConnector(device="cpu"),
         "blackhole": BlackholeConnector()},
        port=0, page_rows=PAGE_ROWS, device="cpu", **kw)


@pytest.fixture(scope="module")
def server():
    srv = _port_server()
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def ref_server():
    srv = RefServer(
        {"tpch": RefTpch(scale=SF), "memory": RefMemory(),
         "blackhole": RefHole()},
        port=0, page_rows=PAGE_ROWS,
        session_defaults={"result_cache_enabled": "false"})
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def client(server):
    return StatementClient(server=f"http://127.0.0.1:{server.port}")


# ------------------------------------------------------- protocol parity

def _open(req):
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read()), resp.headers, resp.status
    except urllib.error.HTTPError as e:
        return json.loads(e.read()), e.headers, e.code


def _documents(port: int, sql: str, headers: dict):
    """Every protocol document of one statement, following nextUri."""
    hdrs = {"X-Presto-User": "presto", "Content-Type": "text/plain",
            **headers}
    body, resp_headers, status = _open(urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/statement", data=sql.encode(),
        headers=hdrs, method="POST"))
    docs, sets = [body], [resp_headers.get("X-Presto-Set-Session")]
    while body.get("nextUri") and not body.get("error"):
        body, resp_headers, status = _open(urllib.request.Request(
            body["nextUri"], headers=hdrs))
        docs.append(body)
        sets.append(resp_headers.get("X-Presto-Set-Session"))
    return docs, sets, status


def _view(docs, sets, status):
    """What a client sees of one statement, ids, URIs and walls
    masked."""
    err = next((d["error"] for d in docs if d.get("error")), None)
    return {
        "columns": next((d["columns"] for d in docs if d.get("columns")),
                        None),
        "data": [r for d in docs for r in d.get("data", [])],
        "pages": [len(d["data"]) for d in docs if "data" in d],
        "updateType": next((d["updateType"] for d in docs
                            if d.get("updateType")), None),
        "error": None if err is None else (err["errorName"],
                                           err["message"]),
        "state": docs[-1]["stats"]["state"],
        "setSession": sorted({s for s in sets if s}),
        "status": status,
    }


def _same(a, b) -> bool:
    """Equal, doubles to 9 significant digits."""
    if isinstance(a, float) and isinstance(b, float):
        if a != a or b != b:
            return a != a and b != b
        return a == b or abs(a - b) <= 1e-9 * max(abs(a), abs(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


PARITY = {
    "simple": ["select 1 + 1 as two"],
    "scan_aggregate": ["select count(*), sum(n_nationkey) from nation"],
    "paged": ["select l_orderkey, l_linenumber, l_extendedprice, "
              "l_shipdate from lineitem order by l_orderkey, "
              "l_linenumber"],
    "decimals_dates": ["select o_orderkey, o_totalprice, o_orderdate, "
                       "o_orderstatus from orders where o_orderkey < 300 "
                       "order by o_orderkey"],
    "aggregates": ["select l_returnflag, sum(l_extendedprice), "
                   "avg(l_discount), min(l_shipdate), count(*) from "
                   "lineitem group by l_returnflag order by l_returnflag"],
    "join": ["select n_name, r_name from nation, region where "
             "n_regionkey = r_regionkey order by n_name"],
    "literals": ["select cast(null as bigint) as n, 2.5e0 * 2 as d, "
                 "date '1995-03-15' as dt, cast(1.25 as decimal(10,2)) as "
                 "dec, 'x' as s, true as b"],
    "ddl": ["create table memory.p1 as select n_name, n_regionkey from "
            "nation",
            "select count(*) from memory.p1",
            "show tables from memory",
            "insert into memory.p1 select n_name, n_regionkey from nation "
            "where n_regionkey = 1",
            "select n_regionkey, count(*) from memory.p1 group by "
            "n_regionkey order by n_regionkey",
            "drop table memory.p1",
            "show tables from memory"],
    "set_session": ["set session join_distribution_type = 'partitioned'",
                    "select count(*) from region"],
    "explain": ["explain select count(*) from nation where "
                "n_regionkey = 1"],
    "error": ["select bogus_column from nation"],
    "syntax_error": ["selec 1"],
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_protocol_parity_with_the_reference_server(case, server,
                                                   ref_server):
    hdrs = {"port": {}, "ref": {}}
    for sql in PARITY[case]:
        views = {}
        for name, srv in (("port", server), ("ref", ref_server)):
            h = dict(hdrs[name])
            views[name] = _view(*_documents(srv.port, sql, h))
            # the client echoes X-Presto-Set-Session on later requests
            for s in views[name]["setSession"]:
                props = [p for p in h.get("X-Presto-Session", "").split(",")
                         if p]
                hdrs[name]["X-Presto-Session"] = ",".join(props + [s])
        assert _same(views["port"], views["ref"]), (sql, views)
        if case in ("error", "syntax_error"):
            assert views["port"]["state"] == "FAILED"
        elif case == "paged":
            assert len(views["port"]["pages"]) > 1


def test_unknown_header_properties_are_ignored_as_in_the_reference(
        server, ref_server):
    # nosuch is unknown to both engines; result_cache_enabled is known
    h = {"X-Presto-Session": "result_cache_enabled=false, nosuch=1, "
                             "page_rows=2048"}
    views = [_view(*_documents(s.port, "select count(*) from nation", h))
             for s in (server, ref_server)]
    assert views[0] == views[1] and views[0]["data"] == [[25]]


def test_info_equals_the_reference_but_the_backend(server, ref_server):
    infos = []
    for srv in (server, ref_server):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/v1/info") as r:
            info = json.loads(r.read())
        infos.append({k: v for k, v in info.items()
                      if k not in ("uptime", "backend", "device")})
    assert infos[0] == infos[1]


# ------------------------------------- counterparts of test_server.py

def test_simple_query(client):
    res = client.execute("select 1 + 1 as two")
    assert res.error is None
    assert [c["name"] for c in res.columns] == ["two"]
    assert res.rows == [[2]] and res.state == "FINISHED"


def test_scan_aggregate(client):
    res = client.execute("select count(*), sum(n_nationkey) from nation")
    assert res.error is None and res.rows == [[25, 300]]
    assert res.columns[0]["type"] == "bigint"


def test_paged_results(client):
    res = client.execute("select l_orderkey from lineitem")
    assert res.error is None and len(res.rows) > 4096


def test_ddl_roundtrip(client):
    res = client.execute(
        "create table memory.n2 as select n_name, n_regionkey from nation")
    assert res.update_type == "CREATE TABLE AS"
    assert client.execute("select count(*) from memory.n2").rows == [[25]]
    assert ["n2"] in client.execute("show tables from memory").rows
    client.execute("drop table memory.n2")
    assert ["n2"] not in client.execute("show tables from memory").rows


def test_set_session_roundtrip(client):
    res = client.execute("set session tpu_offload_enabled = false")
    assert res.update_type == "SET SESSION"
    assert client.session_properties["tpu_offload_enabled"] == "false"
    assert client.execute("select count(*) from region").rows == [[5]]
    client.execute("set session tpu_offload_enabled = true")
    assert client.session_properties["tpu_offload_enabled"] == "true"


def test_show_session(client):
    names = [r[0] for r in client.execute("show session").rows]
    assert "tpu_offload_enabled" in names
    assert "cross_query_batching" in names


def test_session_catalog(server):
    c = StatementClient(server=f"http://127.0.0.1:{server.port}",
                        catalog="memory")
    res = c.execute("create table t3 as select 42 as x")
    assert res.error is None and res.update_type == "CREATE TABLE AS"
    assert c.execute("select x from t3").rows == [[42]]
    assert ["t3"] in c.execute("show tables").rows
    c.execute("drop table t3")


def test_blackhole_acknowledges_and_discards(client):
    res = client.execute("create table blackhole.b as select * from nation")
    assert res.rows == [[25]]
    assert client.execute("select count(*) from blackhole.b").rows == [[0]]
    client.execute("drop table blackhole.b")


def test_error_surface(client):
    res = client.execute("select bogus_column from nation")
    assert res.error is not None and res.state == "FAILED"
    assert "bogus_column" in res.error["message"]


def test_syntax_error(client):
    assert client.execute("selec 1").error is not None


def test_unported_plane_fails_the_query_with_an_error_body(server):
    """The tailing flag on a statement over no stream is ignored, as a
    header and through SET SESSION: the query runs to FINISHED. A
    property value the port rejects, as a header, is a FAILED document
    (HTTP 400) with a ValueError body, not a dropped connection."""
    c = StatementClient(server=f"http://127.0.0.1:{server.port}")
    c.session_properties["stream_tail_enabled"] = "true"
    res = c.execute("select 1")
    assert res.state == "FINISHED" and res.error is None
    assert res.rows == [[1]]
    c.session_properties.clear()
    c.session_properties["page_rows"] = "lots"
    res = c.execute("select 1")
    assert res.state == "FAILED" and res.error["errorName"] == "ValueError"
    c.session_properties.clear()
    res = c.execute("set session stream_tail_enabled = true")
    assert res.state == "FINISHED" and res.error is None
    assert c.execute("select count(*) from nation").rows == [[25]]
    c.session_properties.clear()


def test_info_endpoints(server, client):
    base = f"http://127.0.0.1:{server.port}"
    with urllib.request.urlopen(f"{base}/v1/info") as r:
        info = json.loads(r.read())
    assert info["coordinator"] is True and info["backend"] == "cpu"
    res = client.execute("select 1 as x")
    with urllib.request.urlopen(f"{base}/v1/query/{res.query_id}") as r:
        qinfo = json.loads(r.read())
    assert qinfo["state"] == "FINISHED" and qinfo["rowCount"] == 1
    res = client.execute("select count(*) from nation")
    with urllib.request.urlopen(f"{base}/v1/query/{res.query_id}") as r:
        qinfo = json.loads(r.read())
    # the server traces by default: the local stage of the tree
    assert qinfo["stages"] and qinfo["spanCount"] > 1
    with urllib.request.urlopen(f"{base}/v1/query") as r:
        ids = [q["queryId"] for q in json.loads(r.read())]
    assert res.query_id in ids
    for path in ("/v1/query/nosuch", "/v1/statement/nosuch/0", "/nope"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + path)
        assert e.value.code == 404
    with urllib.request.urlopen(f"{base}/v1/resourceGroup") as r:
        assert json.loads(r.read()) == []
    with urllib.request.urlopen(f"{base}/v1/node") as r:
        assert json.loads(r.read()) == []


def test_cancel(server):
    base = f"http://127.0.0.1:{server.port}"
    from presto_tpu_torch.session import Session

    q = server.manager.submit("select count(*) from lineitem", Session())
    req = urllib.request.Request(f"{base}/v1/statement/{q.id}",
                                 method="DELETE")
    with urllib.request.urlopen(req) as r:
        assert json.loads(r.read()) == {"cancelled": True}
    q.done.wait(30)
    assert q.state in ("CANCELED", "FINISHED")
    req = urllib.request.Request(f"{base}/v1/statement/nosuch",
                                 method="DELETE")
    with urllib.request.urlopen(req) as r:
        assert json.loads(r.read()) == {"cancelled": False}


def test_cli_execute(server, capsys):
    from presto_tpu_torch.cli import main

    rc = main(["--server", f"http://127.0.0.1:{server.port}", "--execute",
               "select r_name from region order by r_name limit 2"])
    out = capsys.readouterr().out
    assert rc == 0 and "r_name" in out and "(2 rows)" in out
    rc = main(["--server", f"http://127.0.0.1:{server.port}", "--execute",
               "selec 1"])
    assert rc == 1


def test_metrics_endpoint(server, client):
    client.execute("select 1")
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics") as resp:
        assert resp.status == 200
        assert "text/plain" in resp.headers["Content-Type"]
        body = resp.read().decode()
    for name in ("presto_tpu_uptime_seconds",
                 'presto_tpu_queries_total{state="FINISHED"}',
                 "presto_tpu_rows_returned_total",
                 'presto_tpu_query_latency_seconds_bucket{le="+Inf"}',
                 "presto_tpu_stage_wall_seconds_count",
                 "presto_tpu_device_memory_budget_bytes",
                 "presto_tpu_cross_query_batches_total",
                 "presto_tpu_queries_per_launch",
                 "presto_tpu_exchange_wire_bytes_total",
                 "presto_tpu_listener_errors_total",
                 "presto_tpu_transfer_wall_seconds",
                 "presto_tpu_peak_queued"):
        assert name in body, name


def test_event_listener_spi():
    from presto_tpu_torch.events import EventListener

    seen = {"created": [], "completed": []}

    class Recorder(EventListener):
        def query_created(self, e):
            seen["created"].append(e)

        def query_completed(self, e):
            seen["completed"].append(e)

    class Thrower(EventListener):
        def query_created(self, e):
            raise RuntimeError("listener bug")

    srv = PrestoTpuServer({"tpch": TpchConnector(SF, device="cpu")},
                          port=0, event_listeners=[Thrower(), Recorder()],
                          device="cpu")
    srv.start()
    try:
        c = StatementClient(server=f"http://127.0.0.1:{srv.port}")
        assert c.execute("select count(*) from nation").error is None
        assert c.execute("select nope from nowhere").error is not None
    finally:
        srv.stop()
    assert len(seen["created"]) == 2
    assert sorted(e.state for e in seen["completed"]) == ["FAILED",
                                                          "FINISHED"]
    done = [e for e in seen["completed"] if e.state == "FINISHED"][0]
    assert done.row_count == 1 and done.wall_ms >= 0
    assert done.query_info and done.query_info["stages"]
    failed = [e for e in seen["completed"] if e.state == "FAILED"][0]
    assert failed.error_name
    # the swallowed listener exceptions, counted
    assert srv._runner.executor.listener_errors == 2


def test_heartbeat_failure_detector():
    from presto_tpu_torch.server.heartbeat import HeartbeatFailureDetector

    peer = _port_server()
    peer.start()
    uri = f"http://127.0.0.1:{peer.port}"
    det = HeartbeatFailureDetector([uri], fail_after=2, timeout_s=0.5)
    det.check_once()
    assert det.is_alive(uri) and det.snapshot()[0]["state"] == "ALIVE"
    peer.stop()
    det.check_once()
    assert det.is_alive(uri)
    det.check_once()
    assert not det.is_alive(uri)
    assert det.snapshot()[0]["state"] == "FAILED"
    peer2 = PrestoTpuServer({"tpch": TpchConnector(SF, device="cpu")},
                            port=peer.port, device="cpu")
    try:
        peer2.start()
        det.check_once()
        assert det.is_alive(uri)
    finally:
        peer2.stop()


def test_monitored_server_exposes_node_view():
    peer = _port_server()
    peer.start()
    mon = PrestoTpuServer({"tpch": TpchConnector(SF, device="cpu")},
                          port=0, device="cpu",
                          peer_uris=[f"http://127.0.0.1:{peer.port}"])
    mon.start()
    try:
        mon.failure_detector.check_once()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{mon.port}/v1/node") as resp:
            nodes = json.loads(resp.read())
        assert len(nodes) == 1 and nodes[0]["state"] == "ALIVE"
    finally:
        mon.stop()
        peer.stop()


def test_resource_group_admission():
    """Queue-full rejection (429 / QUERY_QUEUE_FULL) and the per-group
    accounting, made deterministic: a listener parks the first query's
    submission (its queue slot held) until a second submission has been
    refused."""
    from presto_tpu_torch.server.resource_groups import (
        ResourceGroupManager,
        ResourceGroupSpec,
    )

    refused = threading.Event()

    class Park:
        def query_created(self, e):
            if e.sql.endswith("/*first*/"):
                refused.wait(30)

        def query_completed(self, e):
            pass

    rg = ResourceGroupManager([
        ResourceGroupSpec("tiny", ".*", hard_concurrency=1, max_queued=1)])
    srv = PrestoTpuServer({"tpch": TpchConnector(SF, device="cpu")},
                          port=0, resource_groups=rg, device="cpu",
                          event_listeners=[Park()])
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        first = []
        t = threading.Thread(target=lambda: first.append(
            StatementClient(server=base).execute(
                "select count(*) from lineitem /*first*/")))
        t.start()
        deadline = threading.Event()
        while rg.snapshot()[0]["queued"] < 1 and not deadline.wait(0.01):
            pass
        second = StatementClient(server=base).execute("select 1")
        refused.set()
        t.join(timeout=60)
        assert second.error["errorName"] == "QUERY_QUEUE_FULL"
        assert first[0].error is None and first[0].rows[0][0] > 0
        with urllib.request.urlopen(base + "/v1/resourceGroup") as resp:
            snap = json.loads(resp.read())
        assert snap[0]["name"] == "tiny"
        assert snap[0]["running"] == 0 and snap[0]["queued"] == 0
    finally:
        refused.set()
        srv.stop()


def test_memory_arbiter_serializes_oversized():
    srv = PrestoTpuServer({"tpch": TpchConnector(0.01, device="cpu")},
                          port=0, page_rows=1 << 13, device="cpu",
                          memory_budget_bytes=1 << 16)
    srv.start()
    try:
        c = StatementClient(server=f"http://127.0.0.1:{srv.port}")
        rows = c.execute("select count(*) from orders, lineitem "
                         "where o_orderkey = l_orderkey").rows
        assert rows[0][0] > 0
    finally:
        srv.stop()


def test_dml_over_the_wire():
    """DELETE/UPDATE through the coordinator protocol (the reference's
    tests/test_dml.py case)."""
    from presto_tpu_torch import types as T

    mem = MemoryConnector(device="cpu")
    mem.create_table("w", ["k"], [T.BIGINT], [(i,) for i in range(10)])
    srv = PrestoTpuServer({"memory": mem}, default_catalog="memory",
                          port=0, device="cpu")
    srv.start()
    try:
        c = StatementClient(server=f"http://127.0.0.1:{srv.port}")
        res = c.execute("delete from w where k >= 5")
        assert res.update_type == "DELETE" and res.rows == [[5]]
        assert c.execute("select count(*) from w").rows == [[5]]
        res = c.execute("update w set k = k + 100 where k < 2")
        assert res.update_type == "UPDATE" and res.rows == [[2]]
        assert c.execute("select sum(k) from w").rows == [[
            100 + 101 + 2 + 3 + 4]]
    finally:
        srv.stop()


def test_the_server_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrestoTpuServer({"tpch": TpchConnector(SF, device="cpu")}, port=0)


@pytest.mark.parametrize("kw,match", [
    ({"plugins": [object()]}, "plugins"),
    ({"mesh": make_mesh(4, device="cpu")}, "mesh"),
])
def test_unported_server_options_raise(kw, match, client):
    """Both options once left out are ported. A plugin object must be a
    Plugin (this one is not, and install() says so); the mesh runs the
    server's statements on a DistExecutor and answers them as the
    server without a mesh does."""
    if "plugins" in kw:
        with pytest.raises(AttributeError, match="event_listeners"):
            PrestoTpuServer({"tpch": TpchConnector(SF, device="cpu")},
                            port=0, device="cpu", **kw)
        return
    srv = PrestoTpuServer({"tpch": TpchConnector(SF, device="cpu")},
                          port=0, device="cpu", page_rows=PAGE_ROWS, **kw)
    srv.start()
    try:
        assert isinstance(srv._runner.executor, DistExecutor)
        sql = ("select o_orderpriority, count(*), sum(o_totalprice) "
               "from orders join customer on o_custkey = c_custkey "
               "group by o_orderpriority order by o_orderpriority")
        got = StatementClient(server=f"http://127.0.0.1:{srv.port}") \
            .execute(sql)
        want = client.execute(sql)
        assert got.error is None and want.error is None
        assert got.rows == want.rows and len(got.rows) == 5
    finally:
        srv.stop()


def test_start_tail_is_not_ported(server):
    """start_tail is ported: with no append-only catalog nothing can
    tail, so it returns None (the statement takes the normal path) and
    registers no query — the reference's answer."""
    n = len(server.manager.queries())
    assert server.start_tail("select 1", server._runner.session) is None
    assert server.start_tail("select count(*) from nation",
                             server._runner.session) is None
    assert server.make_tail_cursor("set session page_rows = 8",
                                   server._runner.session) is None
    assert len(server.manager.queries()) == n


def test_embedded_task_plane_serves_a_stage_dag():
    """worker_tasks: the coordinator is also a worker; a DcnRunner pools
    it like any worker, and a server with worker_uris routes plain
    queries through the stage DAG (rows untyped, as in the reference)."""
    from presto_tpu_torch.runner import LocalRunner

    conn = TpchConnector(0.01, device="cpu")
    peer = PrestoTpuServer({"tpch": conn}, port=0, device="cpu",
                           worker_tasks=True, page_rows=1 << 13)
    peer.start()
    coord = PrestoTpuServer({"tpch": conn}, port=0, device="cpu",
                            page_rows=1 << 13,
                            worker_uris=[f"http://127.0.0.1:{peer.port}"])
    coord.start()
    try:
        c = StatementClient(server=f"http://127.0.0.1:{coord.port}")
        c.session_properties["join_distribution_type"] = "partitioned"
        c.session_properties["stage_scheduler"] = "true"
        text = ("select n_name, count(*) from customer, nation where "
                "c_nationkey = n_nationkey group by n_name order by n_name")
        res = c.execute(text)
        assert res.error is None, res.error
        assert coord._dcn.last_distribution == "stage-dag"
        want = LocalRunner({"tpch": conn}, device="cpu").execute(text).rows
        assert res.rows == [list(r) for r in want]
        assert [col["type"] for col in res.columns] == ["unknown"] * 2
        # control statements stay on the local engine
        assert c.execute("show tables").rows
    finally:
        coord.stop()
        peer.stop()
