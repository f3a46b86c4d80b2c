"""The mesh (presto_tpu_torch/dist/executor.py) against presto_tpu's
DistExecutor: LocalRunner(mesh=make_mesh(8, device="cpu")) beside the
reference's LocalRunner(mesh=make_mesh(8)) on the 8 virtual CPU devices
the conftest forces, TPC-H SF 0.005, page_rows 2^13.

The counterparts of tests/test_dist.py's default-threshold cases: the 12
query families at the default thresholds (small builds broadcast, small
group-bys gather) equal the reference mesh's rows and the port's
single-process rows, the fragmenter's EXPLAIN texts equal the
reference's, and a fragmented plan on the single-device executor runs
its exchanges as pass-throughs. Also the reference's other mesh cases:
the mesh budget (test_membudget.py), ROLLUP (test_grouping_sets.py),
approx_distinct (test_hll.py) and UNNEST (test_complex_types.py) over
the mesh with forced repartitions.

Tolerances: integers, decimals and strings compare exactly; doubles to
9 significant digits (tests/test_dist.py's _canon_row: the mesh sums in
a different order than one stream)."""

import collections

import jax
import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.dist.executor import make_mesh as ref_make_mesh
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu.runner import explain_text as ref_explain_text
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.executor import DistExecutor, make_mesh
from presto_tpu_torch.dist.fragmenter import add_exchanges
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.runner import LocalRunner, explain_text
from tests.test_sql_tpch import ENGINE_SQL
from tests.tpch_queries import QUERIES

SF = 0.005
PAGE_ROWS = 1 << 13
D = 8
REPART = dict(broadcast_rows=64, gather_capacity=16)

# every query family: scan/agg (1, 6), joins (3, 5, 10), semi/anti (4,
# 21, 22), correlated decorrelation (2, 17, 20), outer joins (13)
DEFAULT_QUERIES = [1, 2, 3, 4, 5, 6, 10, 13, 17, 20, 21, 22]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def canon_row(row):
    """Doubles to 9 significant digits, everything else exactly."""
    return tuple(f"{v:.9e}" if isinstance(v, float) else repr(v)
                 for v in row)


def rows_equal(a, b):
    return collections.Counter(map(canon_row, a)) == \
        collections.Counter(map(canon_row, b))


@pytest.fixture(scope="module")
def conn():
    return TpchConnector(SF, device="cpu")


@pytest.fixture(scope="module")
def ref_conn():
    return RefConnector(SF)


@pytest.fixture(scope="module")
def single(conn):
    return LocalRunner({"tpch": conn}, session={"page_rows": PAGE_ROWS},
                       device="cpu")


@pytest.fixture(scope="module")
def dist(conn):
    return LocalRunner({"tpch": conn}, session={"page_rows": PAGE_ROWS},
                       mesh=make_mesh(D, device="cpu"))


@pytest.fixture(scope="module")
def dist_repart(conn):
    return LocalRunner({"tpch": conn}, session={"page_rows": PAGE_ROWS},
                       mesh=make_mesh(D, device="cpu"), dist_options=REPART)


@pytest.fixture(scope="module")
def ref_dist(ref_conn):
    assert len(jax.devices()) >= D, "conftest must force 8 cpu devices"
    return RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS,
                     mesh=ref_make_mesh(D))


@pytest.fixture(scope="module")
def ref_dist_repart(ref_conn):
    return RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS,
                     mesh=ref_make_mesh(D), dist_options=REPART)


def test_make_mesh_places_shards_round_robin():
    mesh = make_mesh(D, device="cpu")
    assert mesh.size == D
    assert mesh.devices == (torch.device("cpu"),) * D
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(D)


@pytest.mark.parametrize("qnum", DEFAULT_QUERIES)
def test_mesh_matches_reference_and_single(qnum, single, dist, ref_dist):
    want = ref_dist.execute(ENGINE_SQL[qnum]).rows
    got = dist.execute(ENGINE_SQL[qnum]).rows
    assert rows_equal(got, want), (
        f"Q{qnum} mesh != reference mesh\nport: {got[:3]}\nref: {want[:3]}")
    assert rows_equal(got, single.execute(ENGINE_SQL[qnum]).rows)
    assert isinstance(dist.executor, DistExecutor)


def test_fragmenter_inserts_expected_exchanges(dist_repart,
                                               ref_dist_repart):
    txt = explain_text(dist_repart.plan(ENGINE_SQL[3]))
    assert txt == ref_explain_text(ref_dist_repart.plan(ENGINE_SQL[3]))
    assert "Exchange[repartition" in txt and "Exchange[gather]" in txt
    assert "step=partial" in txt and "step=final" in txt


def test_fragmenter_broadcast_small_build(dist, ref_dist):
    txt = explain_text(dist.plan(QUERIES[5]))
    assert txt == ref_explain_text(ref_dist.plan(QUERIES[5]))
    assert "Exchange[broadcast]" in txt


def test_exchange_noop_single_device(single):
    """A fragmented plan runs on the single-device executor too: every
    exchange is a pass-through."""
    plan = single.plan(ENGINE_SQL[6])
    frag, _ = add_exchanges(plan, single.catalogs)
    _names, rows = single.executor.execute(frag)
    assert rows_equal(rows, single.execute(ENGINE_SQL[6]).rows)


def test_dist_budget_is_mesh_share(conn):
    """On the CPU the mesh budget is the per-device budget times the
    shard count (the reference's rule for virtual devices); the runner's
    broadcast share is one device's."""
    ex = DistExecutor({"tpch": conn}, make_mesh(2, device="cpu"))
    ex.device_memory_budget = 1 << 30
    solo = Executor({"tpch": conn}, device="cpu")
    solo.device_memory_budget = 1 << 30
    assert ex._budget() == 2 * solo._budget()
    r = LocalRunner({"tpch": conn}, mesh=make_mesh(2, device="cpu"),
                    session={"device_memory_budget": 1 << 30})
    r.apply_session()
    opts = r.session_dist_options()
    assert opts["broadcast_bytes"] == \
        LocalRunner({"tpch": conn}, device="cpu", session={
            "device_memory_budget": 1 << 30}).session_dist_options()[
            "broadcast_bytes"]


@pytest.mark.parametrize("q", [
    # test_grouping_sets.py::test_rollup_distributed_matches_single
    "select o_orderpriority, o_orderstatus, count(*), sum(o_totalprice) "
    "from orders group by rollup(o_orderpriority, o_orderstatus)",
    # test_hll.py::test_sql_distributed
    "select o_orderpriority, approx_distinct(o_custkey) from orders "
    "group by o_orderpriority",
    "select approx_distinct(o_custkey) from orders",
    # test_complex_types.py::test_unnest_distributed
    "select n_regionkey, sum(x) from nation cross join "
    "unnest(array[1,2,3]) as t(x) group by n_regionkey",
], ids=["rollup", "hll_grouped", "hll_global", "unnest"])
def test_surface_over_the_forced_mesh(q, single, dist_repart,
                                      ref_dist_repart):
    got = dist_repart.execute(q).rows
    assert rows_equal(got, single.execute(q).rows)
    assert rows_equal(got, ref_dist_repart.execute(q).rows)


def test_etc_keys_reach_the_mesh_runner(tmp_path):
    """The etc keys hash-partition-count and mesh-exchange.mode seed
    the server's session defaults, and a served query applies them to
    the mesh executor."""
    from presto_tpu_torch import config as CONF
    from presto_tpu_torch.client import StatementClient

    (tmp_path / "catalog").mkdir()
    (tmp_path / "config.properties").write_text(
        "http-server.http.port=0\nhash-partition-count=2\n"
        "mesh-exchange.mode=false\n")
    (tmp_path / "catalog" / "tpch.properties").write_text(
        "connector.name=tpch\ntpch.scale-factor=0.001\n")
    srv = CONF.server_from_etc(str(tmp_path), device="cpu",
                               mesh=make_mesh(4, device="cpu"))
    assert srv.session_defaults["hash_partition_count"] == "2"
    assert srv.session_defaults["mesh_exchange_mode"] == "false"
    srv.start()
    try:
        res = StatementClient(server=f"http://127.0.0.1:{srv.port}") \
            .execute("select count(*) from orders")
        assert res.error is None and res.rows == [[1500]]
        ex = srv._runner.executor
        assert isinstance(ex, DistExecutor) and ex.hash_partitions == 2
        assert ex._route_devices() == 2
        assert srv._runner.session.get("mesh_exchange_mode") == "false"
    finally:
        srv.stop()
