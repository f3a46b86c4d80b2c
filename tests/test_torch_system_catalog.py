"""The system catalog: presto_tpu_torch against presto_tpu.

The counterparts of the 5 cases of tests/test_system_catalog.py: the
metadata tables (catalogs, tables, columns), session_properties and
functions, joins and aggregation over system pages, the session table
tracking the querying client's session on the concurrent server, and
the server's runtime tables (runtime_queries, nodes, metrics). Rows are
held to the reference's where both engines list the same things; the
session and function registries are each engine's own (the port lists
the properties and functions it has), so those cases compare the rows
the two share.
"""

import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch.client import StatementClient
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server.http_server import PrestoTpuServer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return (LocalRunner({"tpch": TpchConnector(0.01, device="cpu")},
                        device="cpu", session={"page_rows": 1 << 13}),
            RefRunner({"tpch": RefTpch(0.01)}, page_rows=1 << 13))


def _same(pair, sql):
    got, want = (r.execute(sql).rows for r in pair)
    assert got == want, sql
    return got


def test_metadata_tables(pair):
    cats = _same(pair, "select catalog_name from system.catalogs "
                       "order by 1")
    assert [c[0] for c in cats] == ["system", "tpch"]
    assert _same(pair, "select count(*) from system.tables "
                       "where table_catalog = 'tpch'") == [(8,)]
    cols = _same(pair, "select column_name, ordinal_position, data_type "
                       "from system.columns where table_name = 'region' "
                       "order by 2")
    assert [c[0] for c in cols] == ["r_regionkey", "r_name", "r_comment"]
    assert _same(pair, "show tables from system") == [
        ("catalogs",), ("tables",), ("columns",), ("session_properties",),
        ("functions",)]


def test_session_and_functions_tables(pair):
    assert _same(pair, "select value from system.session_properties "
                       "where name = 'tpu_offload_enabled'") == [("true",)]
    # the properties and functions the port has are the reference's
    sql_p = "select name, default_value, type from system.session_properties"
    port_p, ref_p = (set(r.execute(sql_p).rows) for r in pair)
    assert port_p - ref_p <= {
        ("pallas_join_enabled", "true", "str"),
        ("fused_partial_agg_enabled", "auto", "str"),
        ("split_batch_size", "auto", "str"),
        ("late_materialization_enabled", "auto", "str")}, port_p - ref_p
    assert ("result_cache_enabled", "false", "bool") in port_p
    sql_f = "select function_name from system.functions"
    port_f, ref_f = (set(r.execute(sql_f).rows) for r in pair)
    assert len(port_f) >= 90 and port_f <= ref_f, port_f - ref_f


def test_joins_and_aggregation_over_system(pair):
    got = _same(pair, "select t.table_name, count(*) c from system.tables "
                      "t, system.columns c where t.table_name = "
                      "c.table_name and t.table_catalog = 'tpch' and "
                      "c.table_catalog = 'tpch' group by 1 "
                      "order by 2 desc, 1 limit 2")
    assert got[0] == ("lineitem", 16)


def test_session_properties_track_client_session():
    """The concurrent path builds a runner per query but shares the
    system connector: the table shows the QUERYING client's session."""
    srv = PrestoTpuServer({"tpch": TpchConnector(0.01, device="cpu")},
                          port=0, device="cpu", page_rows=1 << 13,
                          memory_budget_bytes=1 << 32)
    srv.start()
    try:
        c = StatementClient(server=f"http://127.0.0.1:{srv.port}")
        c.session_properties["spill_threshold_bytes"] = "12345"
        got = c.execute("select value from system.session_properties "
                        "where name = 'spill_threshold_bytes'").rows
        assert got == [["12345"]], got
    finally:
        srv.stop()


def test_server_runtime_tables():
    from presto_tpu.client import StatementClient as RefClient
    from presto_tpu.server.http_server import PrestoTpuServer as RefServer

    out = []
    for srv in (PrestoTpuServer({"tpch": TpchConnector(0.01, device="cpu")},
                                port=0, device="cpu", page_rows=1 << 13),
                RefServer({"tpch": RefTpch(0.01)}, port=0,
                          page_rows=1 << 13)):
        srv.start()
        try:
            cls = StatementClient if isinstance(srv, PrestoTpuServer) \
                else RefClient
            c = cls(server=f"http://127.0.0.1:{srv.port}")
            c.execute("select 1")
            states = {r[0] for r in c.execute(
                "select state, count(*) from system.runtime_queries "
                "group by 1 order by 1").rows}
            nodes = c.execute("select uri, is_coordinator "
                              "from system.nodes").rows
            m = c.execute("select value from system.metrics "
                          "where name = 'rows_returned_total'").rows
            names = {r[0] for r in c.execute(
                "select name from system.metrics").rows}
            out.append((states, [int(n[1]) for n in nodes],
                        int(m[0][0]) >= 1, names))
        finally:
            srv.stop()
    (states, nodes, rows_ok, names), ref = out
    assert states == ref[0] and "FINISHED" in states
    assert nodes == ref[1] == [1] and rows_ok and ref[2]
    assert {"result_cache_hits", "cache_remote_hits", "transfer_wall_ms",
            "admission_cache_bypasses", "h2d_bytes"} <= names
    assert names <= ref[3], names - ref[3]
