"""GROUPING SETS / ROLLUP / CUBE through GroupId: presto_tpu_torch
against presto_tpu.

The counterparts of tests/test_grouping_sets.py at its scale (TPC-H SF
0.01): each query's rows equal the reference engine's and the
equivalent UNION ALL of plain GROUP BYs; a real NULL key stays apart
from a rolled-up one (the gid channel); the spill path's partition
count and the fused path's counters (fused_partial_aggs,
program_launches, splits_scanned) equal the reference's on the same
session; the grouped aggregation over (keys..., gid) reaches K1's
dispatch point; and the stage-DAG path (two in-process workers)
gives the single-process rows."""

import collections

import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu.sql.planner import PlanningError as RefPlanningError
from presto_tpu_torch import cuda
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.dcn import DcnRunner
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server.worker import WorkerServer
from presto_tpu_torch.sql.planner import PlanningError
from tests.torch_memory import MemoryConnector

SF = 0.01
PAGE_ROWS = 1 << 13


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows_eq(a, b):
    return collections.Counter(map(repr, a)) == collections.Counter(
        map(repr, b))


@pytest.fixture(scope="module")
def conn():
    return TpchConnector(SF, device="cpu")


@pytest.fixture(scope="module")
def ref_conn():
    return RefConnector(SF)


@pytest.fixture(scope="module")
def port(conn):
    return LocalRunner({"tpch": conn}, session={"page_rows": PAGE_ROWS},
                       device="cpu")


@pytest.fixture(scope="module")
def reference(ref_conn):
    return RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS)


CASES = {
    "rollup": (
        "select n_regionkey, n_nationkey, count(*), sum(n_nationkey) "
        "from nation group by rollup(n_regionkey, n_nationkey)",
        "select n_regionkey, n_nationkey, count(*), sum(n_nationkey) "
        "from nation group by n_regionkey, n_nationkey "
        "union all select n_regionkey, null, count(*), sum(n_nationkey) "
        "from nation group by n_regionkey "
        "union all select null, null, count(*), sum(n_nationkey) "
        "from nation"),
    "cube": (
        "select o_orderpriority, o_orderstatus, count(*) from orders "
        "group by cube(o_orderpriority, o_orderstatus)",
        "select o_orderpriority, o_orderstatus, count(*) from orders "
        "group by o_orderpriority, o_orderstatus "
        "union all select o_orderpriority, null, count(*) from orders "
        "group by o_orderpriority "
        "union all select null, o_orderstatus, count(*) from orders "
        "group by o_orderstatus "
        "union all select null, null, count(*) from orders"),
    "grouping_sets": (
        "select o_orderstatus, o_orderpriority, count(*) from orders "
        "group by grouping sets ((o_orderstatus), (o_orderpriority), ())",
        "select o_orderstatus, null, count(*) from orders "
        "group by o_orderstatus "
        "union all select null, o_orderpriority, count(*) from orders "
        "group by o_orderpriority "
        "union all select null, null, count(*) from orders"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_grouping_sets_match_reference_and_union(name, port, reference):
    sql, union_sql = CASES[name]
    got = port.execute(sql).rows
    assert rows_eq(got, reference.execute(sql).rows)
    assert rows_eq(got, port.execute(union_sql).rows)
    if name == "rollup":
        assert len(got) == 31


def test_rollup_aggregation_reaches_k1(port):
    cuda.reset_counts()
    port.execute(CASES["rollup"][0])
    assert cuda.plain_calls["segsum"] > 0
    assert not cuda.launches


def test_rollup_distinguishes_real_nulls_by_gid():
    rows = [(1, 10), (1, 20), (None, 5), (None, 7)]
    mem = MemoryConnector(device="cpu")
    mem.create_table("t", ["k", "v"], [T.BIGINT, T.BIGINT], rows)
    ref_mem = RefMemory()
    ref_mem.create_table("t", ["k", "v"], [RT.BIGINT, RT.BIGINT], rows)
    sql = "select k, count(*), sum(v) from t group by rollup(k)"
    got = LocalRunner({"memory": mem}, default_catalog="memory",
                      device="cpu").execute(sql).rows
    want = RefRunner({"memory": ref_mem},
                     default_catalog="memory").execute(sql).rows
    assert collections.Counter(got) == collections.Counter(
        [(1, 2, 30), (None, 2, 12), (None, 4, 42)])
    assert collections.Counter(got) == collections.Counter(want)


def test_rollup_with_spill(conn, ref_conn, port):
    q = ("select o_custkey, count(*) from orders "
         "group by rollup(o_custkey) order by 2 desc, 1 limit 5")
    sp = LocalRunner({"tpch": conn}, session={
        "page_rows": PAGE_ROWS, "spill_threshold_bytes": 1 << 15},
        device="cpu")
    ref = RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS)
    ref.session.set("spill_threshold_bytes", 1 << 15)
    got = sp.execute(q).rows
    assert got == ref.execute(q).rows
    assert rows_eq(got, port.execute(q).rows)
    assert sp.executor.spill_partitions_used > 1
    assert (sp.executor.spill_partitions_used
            == ref.executor.spill_partitions_used)


FUSED = {"fused_partial_agg_enabled": "true", "split_batch_size": "64"}
COUNTERS = ("fused_partial_aggs", "program_launches", "splits_scanned")


@pytest.mark.parametrize("name", ["rollup", "grouping_sets"])
def test_fused_session_decisions_match_reference(name, conn, ref_conn,
                                                 reference):
    sql = CASES[name][0]
    port = LocalRunner({"tpch": conn},
                       session={"page_rows": PAGE_ROWS, **FUSED},
                       device="cpu")
    ref = RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS)
    for k, v in FUSED.items():
        ref.session.set(k, v)
    got = port.execute(sql).rows
    assert rows_eq(got, ref.execute(sql).rows)
    assert rows_eq(got, reference.execute(sql).rows)
    for c in COUNTERS:
        assert getattr(port.executor, c) == getattr(ref.executor, c), c
    # GroupId ends the fused chain below the aggregation: the scan and
    # project fuse into per-batch programs, the aggregation does not
    assert port.executor.program_launches > 0
    assert port.executor.fused_partial_aggs == 0


@pytest.fixture(scope="module")
def workers():
    ws = [WorkerServer({"tpch": TpchConnector(SF, device="cpu")},
                       node_id=f"g{i}", default_catalog="tpch",
                       page_rows=PAGE_ROWS, device="cpu")
          for i in range(2)]
    for w in ws:
        w.start()
    yield [w.uri for w in ws]
    for w in ws:
        w.stop()


@pytest.mark.parametrize("distribution", ["auto", "partitioned"])
def test_rollup_distributed_matches_single(distribution, workers, port):
    q = ("select o_orderpriority, o_orderstatus, count(*), "
         "sum(o_totalprice) from orders "
         "group by rollup(o_orderpriority, o_orderstatus)")
    coord = DcnRunner({"tpch": TpchConnector(SF, device="cpu")}, workers,
                      default_catalog="tpch", session_props={
                          "page_rows": PAGE_ROWS,
                          "join_distribution_type": distribution,
                          "device_exchange_enabled": "true",
                          "stage_scheduler": "true"},
                      device="cpu")
    assert rows_eq(coord.execute(q), port.execute(q).rows)
    assert coord.last_distribution == "stage-dag"


def test_distinct_aggs_with_grouping_sets_rejected(port, reference):
    sql = ("select count(distinct o_custkey) from orders "
           "group by rollup(o_orderstatus)")
    with pytest.raises(RefPlanningError):
        reference.execute(sql)
    with pytest.raises(PlanningError):
        port.execute(sql)
