"""The slice as a whole: presto_tpu_torch's LocalRunner on the CPU runs
TPC-H Q1, Q3, Q5, Q6, Q10, Q12 and Q17 at SF 0.005 and returns the sqlite
oracle's rows (tests/test_sql_tpch.py's ENGINE_SQL/ORACLE/compare) and
presto_tpu's rows, twice: with the generated join off
(pallas_join_enabled=true, generated_join_enabled=false — the setup of
tests/test_pallas_join_exec.py, which holds the kernel dispatch points:
K1 on Q1 and Q6, the dim and radix probes on Q5, reached on the plain
path), and under each engine's default session (the generated join on,
its counter moving as presto_tpu's does). Floats agree to 9 significant
digits; everything else exactly."""

import dataclasses
import math

import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import cuda
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.runner import LocalRunner
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


SF = 0.005
QUERIES = (1, 3, 5, 6, 10, 12, 17)
PAGE_ROWS = 1 << 15
# the materialized joins: the kernel dispatch points this file holds
GJ_OFF = {"generated_join_enabled": "false"}


@pytest.fixture(scope="module")
def ref_conn():
    return RefConnector(SF)


@pytest.fixture(scope="module")
def db(ref_conn):
    return load_sqlite(ref_conn, ref_conn.tables())


@pytest.fixture(scope="module")
def conn():
    return TpchConnector(SF, device="cpu")


def _run_port(conn, session=GJ_OFF):
    runner = LocalRunner({"tpch": conn},
                         session={"page_rows": PAGE_ROWS, **session},
                         device="cpu")
    out = {}
    for q in QUERIES:
        cuda.reset_counts()
        gen0 = runner.executor.generated_joins_used
        res = runner.execute(ENGINE_SQL[q])
        ex = runner.executor
        out[q] = (res, dict(cuda.plain_calls),
                  ex.generated_joins_used - gen0,
                  (ex.program_launches, ex.splits_scanned))
    return out


@pytest.fixture(scope="module")
def port(conn):
    return _run_port(conn)


@pytest.fixture(scope="module")
def port_default(conn):
    return _run_port(conn, session={})


def _run_reference(runner):
    out = {}
    for q in QUERIES:
        gen0 = runner.executor.generated_joins_used
        res = runner.execute(ENGINE_SQL[q])
        ex = runner.executor
        out[q] = (res, ex.generated_joins_used - gen0,
                  (ex.program_launches, ex.splits_scanned))
    return out


@pytest.fixture(scope="module")
def reference(ref_conn):
    r = RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS)
    r.session.set("pallas_join_enabled", "true")
    r.session.set("generated_join_enabled", False)
    return _run_reference(r)


@pytest.fixture(scope="module")
def reference_default(ref_conn):
    return _run_reference(RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS))


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert math.isclose(a, b, rel_tol=1e-9), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


@pytest.mark.parametrize("q", QUERIES)
def test_port_matches_sqlite_oracle(q, port, db):
    oracle_sql, modes = ORACLE[q]
    compare(q, port[q][0].rows, db.execute(oracle_sql).fetchall(), modes)


@pytest.mark.parametrize("q", QUERIES)
def test_port_matches_reference_engine(q, port, reference):
    got, want = port[q][0], reference[q][0]
    _same_rows(got.rows, want.rows)
    assert got.column_names == want.column_names
    assert got.column_types == want.column_types


@pytest.mark.parametrize("q", QUERIES)
def test_default_session_matches_reference_and_sqlite(q, port_default,
                                                      reference_default, db):
    """No session overrides on either engine: the reference's default
    TPC-H path — generated joins, and one fused program per split of
    each fused chain (the last query attempt's launches and splits)."""
    (got, _plain, gen_used, launches), (want, ref_gen_used, ref_launches) \
        = port_default[q], reference_default[q]
    _same_rows(got.rows, want.rows)
    assert got.column_names == want.column_names
    assert gen_used == ref_gen_used
    assert launches == ref_launches
    oracle_sql, modes = ORACLE[q]
    compare(q, got.rows, db.execute(oracle_sql).fetchall(), modes)


def test_default_session_uses_the_generated_join(port_default, port):
    assert all(port_default[q][2] > 0 for q in (3, 5, 10, 12, 17))
    assert not any(port[q][2] for q in QUERIES)


def test_kernel_dispatch_points_reached_on_the_plain_path(port):
    assert port[1][1].get("segsum", 0) > 0
    assert port[6][1].get("segsum", 0) > 0
    assert port[5][1].get("probe_dim", 0) > 0
    assert port[5][1].get("probe_radix", 0) > 0
    assert port[3][1].get("probe_dim", 0) + port[3][1].get(
        "probe_radix", 0) > 0
    assert not any(cuda.launches.values())  # no kernel runs on the CPU


def test_kernels_off_runs_the_segment_ops_and_sort_join(conn, port):
    off = _run_port(conn, session={"pallas_join_enabled": "false", **GJ_OFF})
    for q in QUERIES:
        _same_rows(off[q][0].rows, port[q][0].rows)
        assert not off[q][1], off[q][1]


def test_capacity_boost_retry_gives_the_same_rows(conn, port):
    runner = LocalRunner({"tpch": conn},
                         session={"page_rows": PAGE_ROWS, **GJ_OFF},
                         device="cpu")
    runner.executor.agg_optimistic_rows = 16  # far below Q3's groups
    res = runner.execute(ENGINE_SQL[3])
    assert runner.executor.capacity_boost_retries >= 1
    _same_rows(res.rows, port[3][0].rows)


# plans beyond the four queries, against the same oracle: non-unique
# builds (match expansion), LEFT and RIGHT joins, string keys, LIMIT
EXTRA = {
    "fanout": (
        "select count(*), sum(ps_availqty) from lineitem, partsupp "
        "where l_partkey = ps_partkey and l_orderkey < 2000",
        "SELECT COUNT(*), SUM(ps_availqty) FROM lineitem, partsupp "
        "WHERE l_partkey = ps_partkey AND l_orderkey < 2000"),
    "left": (
        "select count(*), count(o_orderkey) from customer left join "
        "orders on c_custkey = o_custkey and o_orderdate < date "
        "'1993-01-01'",
        "SELECT COUNT(*), COUNT(o_orderkey) FROM customer LEFT JOIN orders "
        "ON c_custkey = o_custkey AND o_orderdate < 8401"),
    "right": (
        "select count(*), count(o_orderkey) from orders right join "
        "customer on o_custkey = c_custkey",
        "SELECT COUNT(*), COUNT(o_orderkey) FROM orders RIGHT JOIN "
        "customer ON o_custkey = c_custkey"),
    "limit": (
        "select count(*) from (select l_orderkey from lineitem limit 17)",
        "SELECT COUNT(*) FROM (SELECT l_orderkey FROM lineitem LIMIT 17)"),
    "grouped_by_string": (
        "select n_name, count(*) from supplier, nation "
        "where s_nationkey = n_nationkey group by n_name order by n_name",
        "SELECT n_name, COUNT(*) FROM supplier, nation "
        "WHERE s_nationkey = n_nationkey GROUP BY n_name ORDER BY n_name"),
}


@pytest.mark.parametrize("kernels", ["true", "false"])
@pytest.mark.parametrize("name", sorted(EXTRA))
def test_more_joins_match_sqlite(name, kernels, conn, db):
    sql, oracle_sql = EXTRA[name]
    runner = LocalRunner({"tpch": conn}, device="cpu",
                         session={"page_rows": PAGE_ROWS,
                                  "pallas_join_enabled": kernels, **GJ_OFF})
    got = runner.execute(sql).rows
    want = [tuple(r) for r in db.execute(oracle_sql).fetchall()]
    assert sorted(got) == sorted(want)


def test_generated_join_is_a_later_slice(conn):
    """Both forms of the generated join are ported; the windowed one
    serves slot-structured fact tables (TPC-DS ticket and order numbers,
    tests/test_torch_sql_tpcds*.py). No TPC-H column offers a windowed
    inverse, so on TPC-H the closed form serves every generated join."""
    runner = LocalRunner({"tpch": conn}, device="cpu",
                         session={"generated_join_enabled": "true"})
    assert runner.executor.generated_join
    for table in conn.tables():
        for col in conn.table_schema(table).column_names():
            assert conn.key_window_inverse(table, col) is None


def test_runner_defaults_to_the_card(conn):
    if torch.cuda.is_available():
        assert LocalRunner({"tpch": conn}).executor.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LocalRunner({"tpch": conn})


def _split_aggregations(node):
    """Each single-step aggregation as partial -> gather -> final, the
    shape the distributed fragmenter gives it."""
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, P.PhysicalNode):
            changes[f.name] = _split_aggregations(v)
    node = dataclasses.replace(node, **changes) if changes else node
    if isinstance(node, P.Aggregation) and node.step == "single":
        partial = dataclasses.replace(node, step="partial")
        return dataclasses.replace(
            node, source=P.Exchange(source=partial, kind="gather"),
            step="final",
            group_channels=tuple(range(len(node.group_channels))))
    return node


@pytest.mark.parametrize("q", QUERIES)
def test_partial_final_split_gives_the_single_step_rows(q, conn, port):
    runner = LocalRunner({"tpch": conn},
                         session={"page_rows": PAGE_ROWS, **GJ_OFF},
                         device="cpu")
    plan = _split_aggregations(runner.plan(ENGINE_SQL[q]))
    assert runner.executor.output_types(plan) == \
        runner.executor.output_types(runner.plan(ENGINE_SQL[q]))
    _names, rows = runner.executor.execute(plan)
    _same_rows(rows, port[q][0].rows)
