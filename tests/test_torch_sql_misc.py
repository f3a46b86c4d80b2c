"""Set operations, VALUES, cross joins and MarkDistinct-backed DISTINCT
aggregates: presto_tpu_torch against presto_tpu.

The counterparts of tests/test_sql_misc.py's TestSetOps and
TestDistinctAggregates at its scale (TPC-H SF 0.002), each query's rows
equal to the reference engine's and, where sqlite can express the
query, to sqlite's; likewise every relational case the chip check runs
(presto_tpu_torch/queries.py SURFACE_SQL). Beside them:
``_mark_distinct_page`` bit for bit against the reference's on seeded
key sets (NULL keys, dictionary and integer keys, several sets at
once); a cross join whose build outgrows its first capacity, which
takes the boosted retry in both engines; and an ungrouped SUM over
32-bit integers, which widens to int64 as the reference's does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.exec import executor as RE
from presto_tpu.page import Page as RPage
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import queries as PQ
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import executor as E
from presto_tpu_torch.page import Page
from presto_tpu_torch.runner import LocalRunner
from tests.oracle import load_sqlite

SF = 0.002
PAGE_ROWS = 1 << 14


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_conn():
    return RefConnector(SF)


@pytest.fixture(scope="module")
def port():
    return LocalRunner({"tpch": TpchConnector(SF, device="cpu")},
                       session={"page_rows": PAGE_ROWS}, device="cpu")


@pytest.fixture(scope="module")
def reference(ref_conn):
    return RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS)


@pytest.fixture(scope="module")
def db(ref_conn):
    return load_sqlite(ref_conn, ["nation", "orders", "lineitem",
                                  "region"])


# ---------------------------------------------------------------- set ops
def test_union_order_limit_applies_to_whole_union(port, reference, db):
    sql = ("select o_orderkey from orders union all "
           "select o_orderkey from orders order by o_orderkey limit 3")
    got = port.execute(sql).rows
    assert got == reference.execute(sql).rows
    assert got == [tuple(r) for r in db.execute(sql).fetchall()]
    assert len(got) == 3 and got[0][0] == got[1][0]


def test_union_coerces_types(port, reference):
    # common type decimal(scale 1): unscaled ints at the Python boundary
    sql = "select 1 as x union all select 2.5"
    got = port.execute(sql).rows
    assert sorted(got) == sorted(reference.execute(sql).rows)
    assert sorted(int(r[0]) for r in got) == [10, 25]


@pytest.mark.parametrize("sql", [
    "select 1 as x union select 1 union select 2",
    "select n_regionkey from nation union select r_regionkey from region",
    "select n_regionkey, n_name from nation where n_nationkey < 5 "
    "union all select r_regionkey, r_name from region",
    "select o_orderstatus from orders union select o_orderpriority "
    "from orders",
])
def test_union_matches_reference_and_sqlite(sql, port, reference, db):
    got = sorted(port.execute(sql).rows)
    assert got == sorted(reference.execute(sql).rows)
    assert got == sorted(tuple(r) for r in db.execute(sql).fetchall())


@pytest.mark.parametrize("sql", [
    "select 1, 'a'",
    "select 1 as x, 'a' as y union all select 2, null",
    "select r_name, n from region cross join "
    "(select 1 as n union all select 2) t order by r_name, n",
    "select count(*), sum(n_nationkey + r_regionkey) from nation "
    "cross join region",
    "select n_name, r_name from nation, region "
    "where n_nationkey < 2 order by 1, 2",
])
def test_values_and_cross_join(sql, port, reference):
    assert sorted(port.execute(sql).rows, key=repr) == sorted(
        reference.execute(sql).rows, key=repr)


def test_cross_join_build_overflow_retries(port, reference, db):
    """The lineitem build (12,000 rows at SF 0.002) outgrows the first
    4096-slot build capacity: the deferred overflow flag re-runs the
    query with a boosted one, in both engines."""
    sql = ("select count(*), sum(l_orderkey) from region cross join "
           "lineitem")
    got = port.execute(sql).rows
    assert got == reference.execute(sql).rows
    assert got == [tuple(r) for r in db.execute(sql).fetchall()]
    assert port.executor.capacity_boost_retries > 0
    assert port.executor._capacity_boost == \
        reference.executor._capacity_boost


# --------------------------------------------------- DISTINCT aggregates
def test_multiple_distinct_columns(port, reference):
    sql = ("select count(distinct n_regionkey), count(distinct n_name) "
           "from nation")
    got = port.execute(sql).rows
    assert got == reference.execute(sql).rows == [(5, 25)]


def test_mixed_distinct_and_plain(port, reference, db):
    sql = ("select count(distinct o_custkey), count(*), "
           "sum(o_totalprice) from orders")
    got = port.execute(sql).rows
    assert got == reference.execute(sql).rows
    assert got == [tuple(r) for r in db.execute(sql).fetchall()]


def test_grouped_mixed_vs_manual(port, reference, db):
    sql = ("select l_returnflag, count(distinct l_suppkey), "
           "count(distinct l_partkey), sum(l_quantity) "
           "from lineitem group by l_returnflag order by 1")
    got = port.execute(sql).rows
    assert got == reference.execute(sql).rows
    assert got == [tuple(r) for r in db.execute(sql).fetchall()]


def test_sum_distinct(port, reference):
    sql = "select sum(distinct n_regionkey), count(*) from nation"
    got = port.execute(sql).rows
    assert got == reference.execute(sql).rows == [(10, 25)]


def test_distinct_beside_plain_grouped_by_priority(port, reference, db):
    sql = ("select o_orderpriority, count(distinct o_custkey), count(*), "
           "sum(o_totalprice) from orders group by o_orderpriority "
           "order by 1")
    got = port.execute(sql).rows
    assert got == reference.execute(sql).rows
    assert got == [tuple(r) for r in db.execute(sql).fetchall()]


@pytest.mark.parametrize("sets", [((0,),), ((1,),), ((0, 1),),
                                  ((0,), (2,), (1, 2))])
def test_mark_distinct_page_matches_reference(sets):
    rng = np.random.default_rng(len(sets) * 10 + sets[0][0])
    n = 300
    a = [None if rng.random() < 0.1 else int(v)
         for v in rng.integers(0, 20, n)]
    b = [["x", "y", "z", "w"][v] for v in rng.integers(0, 4, n)]
    c = [int(v) for v in rng.integers(-5, 5, n)]
    types = ["bigint", "varchar", "integer"]
    rpage = RPage.from_arrays([a, b, c], [RT.parse_type(t) for t in types])
    ppage = Page.from_arrays([a, b, c], [T.parse_type(t) for t in types],
                             device="cpu")
    mask = np.zeros(rpage.capacity, bool)
    mask[:n] = rng.random(n) < 0.9
    rpage = RPage(blocks=rpage.blocks, valid=jnp.asarray(mask))
    ppage = Page(blocks=ppage.blocks, valid=torch.from_numpy(mask))
    cap = 512
    rout, rovf = RE._mark_distinct_page(sets, rpage, cap, 64)
    pout, povf = E._mark_distinct_page(sets, ppage, cap, 64)
    assert bool(povf) == bool(rovf) is False
    for i in range(len(sets)):
        np.testing.assert_array_equal(
            pout.block(3 + i).data.numpy()[mask],
            np.asarray(rout.block(3 + i).data)[mask])


@pytest.mark.parametrize("name", sorted(PQ.SURFACE_SQL))
def test_chip_surface_queries(name, port, reference, db):
    """Every relational case chip_smoke.py runs on the card
    (presto_tpu_torch/queries.py SURFACE_SQL): the port's rows equal the
    reference engine's and, where the case names one, sqlite's."""
    sql, oracle = PQ.SURFACE_SQL[name]
    got = sorted(port.execute(sql).rows, key=repr)
    assert got == sorted(reference.execute(sql).rows, key=repr)
    if oracle is not None:
        want = db.execute(sql if oracle is True else oracle).fetchall()
        assert got == sorted((tuple(r) for r in want), key=repr)


@pytest.mark.parametrize("kernels", ["true", "false"])
def test_ungrouped_sum_of_32_bit_integers_widens(kernels):
    """An ungrouped SUM over INTEGER and DATE columns accumulates in
    int64, as the reference's ``jnp.sum`` does (a window over a DATE
    column summed past 2^31 found it); the grouped form keeps the input
    width in both engines."""
    from presto_tpu.connectors.memory import MemoryConnector as RefMemory
    from tests.torch_memory import MemoryConnector

    rows = [(1, 2_000_000_000, 20000), (1, 2_000_000_000, 20000),
            (2, 5, 1)]
    mem = MemoryConnector(device="cpu")
    mem.create_table("t", ["g", "x", "d"], [T.BIGINT, T.INTEGER, T.DATE],
                     rows)
    ref_mem = RefMemory()
    ref_mem.create_table("t", ["g", "x", "d"],
                         [RT.BIGINT, RT.INTEGER, RT.DATE], rows)
    port = LocalRunner({"m": mem}, default_catalog="m",
                       session={"pallas_join_enabled": kernels},
                       device="cpu")
    ref = RefRunner({"m": ref_mem}, default_catalog="m")
    for sql in ("select sum(x), sum(d) from t",
                "select g, sum(x), sum(d) from t group by g",
                "select sum(mn) from (select min(d) over (partition by g) "
                "mn from t) s"):
        assert sorted(port.execute(sql).rows) == sorted(
            ref.execute(sql).rows), sql
    assert port.execute("select sum(x), sum(d) from t").rows == [
        (4_000_000_005, 40_001)]
