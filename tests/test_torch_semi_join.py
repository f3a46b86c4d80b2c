"""Semi/anti joins and UniqueId: presto_tpu_torch against presto_tpu.

``semi_join_mask`` on the same seeded key columns, bit for bit: NULLs on
either side (SQL three-valued IN), multi-column keys, and more than 4
build rows sharing one hash (the verify window's fallback). The
executor's semi/anti joins and UniqueId through plans and SQL, against
the reference executor and sqlite, with row ids that carry across
pages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.exec import plan as RP
from presto_tpu.exec.executor import Executor as RefExecutor
from presto_tpu.ops import join as RJ
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.executor import make_mesh
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.ops import join as J
from presto_tpu_torch.runner import LocalRunner
from tests.oracle import load_sqlite

SF = 0.002


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test files at once, one per worker process:
    one intra-op thread per process keeps the port's CPU runs from
    oversubscribing the cores (measured: 10-40x slower with 6 workers at
    the default thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(rng, n, ncols, span, null_rate):
    cols = [rng.integers(0, span, n).astype(np.int64) for _ in range(ncols)]
    nulls = [rng.random(n) < null_rate if null_rate else None
             for _ in range(ncols)]
    return cols, nulls


CASES = {
    # name: (build rows, probe rows, key columns, span, build nulls,
    #        probe nulls, duplicate runs)
    "one_key": (64, 200, 1, 100, 0.0, 0.0, 0),
    "probe_nulls": (64, 200, 1, 100, 0.0, 0.2, 0),
    "build_nulls": (64, 200, 1, 100, 0.1, 0.0, 0),
    "both_nulls": (64, 200, 2, 12, 0.05, 0.1, 0),
    "two_keys": (128, 300, 2, 9, 0.0, 0.0, 0),
    "three_keys": (128, 300, 3, 5, 0.02, 0.02, 0),
    "fallback_window": (96, 200, 1, 20, 0.0, 0.0, 9),
    "fallback_nulls": (96, 200, 2, 6, 0.05, 0.05, 7),
}


def _case(name):
    nb, npb, ncols, span, bnull, pnull, dup = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    bcols, bnulls = _keys(rng, nb, ncols, span, bnull)
    if dup:
        # one key repeated `dup` times: > 4 equal hashes in the build
        for c in bcols:
            c[:dup] = c[0]
        for nl in bnulls:
            if nl is not None:
                nl[:dup] = False
    pcols, pnulls = _keys(rng, npb, ncols, span, pnull)
    bvalid = rng.random(nb) < 0.9
    pvalid = rng.random(npb) < 0.9
    return bcols, bnulls, bvalid, pcols, pnulls, pvalid


@pytest.mark.parametrize("name", sorted(CASES))
def test_semi_join_mask_matches_reference(name):
    bcols, bnulls, bvalid, pcols, pnulls, pvalid = _case(name)

    def ref(a):
        return None if a is None else jnp.asarray(a)

    def port(a):
        return None if a is None else torch.from_numpy(np.array(a))

    want = RJ.semi_join_mask(
        [ref(c).astype(jnp.uint64) for c in bcols],
        [ref(n) for n in bnulls], ref(bvalid),
        [ref(c).astype(jnp.uint64) for c in pcols],
        [ref(n) for n in pnulls], ref(pvalid))
    got = J.semi_join_mask(
        [port(c) for c in bcols], [port(n) for n in bnulls], port(bvalid),
        [port(c) for c in pcols], [port(n) for n in pnulls], port(pvalid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    has_match, null_result = got
    assert not (has_match & null_result).any()
    if CASES[name][6]:
        dup_key = [c[0] for c in bcols]
        hit = np.all([c == k for c, k in zip(pcols, dup_key)], axis=0)
        hit &= pvalid
        for nl in pnulls:
            if nl is not None:
                hit &= ~nl
        assert hit.any() and has_match.numpy()[hit].all()


@pytest.fixture(scope="module")
def conns():
    return RefConnector(SF), TpchConnector(SF, device="cpu")


@pytest.mark.parametrize("page_rows", [1 << 9, 1 << 10])
def test_unique_id_matches_reference_across_pages(conns, page_rows):
    ref_conn, conn = conns
    cols = ("o_orderkey", "o_custkey")

    def plan(Pm):
        return Pm.UniqueId(Pm.TableScan("tpch", "orders", cols))

    _n, want = RefExecutor({"tpch": ref_conn}, page_rows=page_rows,
                           use_jit=False).execute(plan(RP))
    ex = Executor({"tpch": conn}, page_rows=page_rows, device="cpu")
    assert str(ex.output_types(plan(P))[-1]) == "bigint"
    _n, got = ex.execute(plan(P))
    assert got == want
    ids = [r[-1] for r in got]
    assert len(set(ids)) == len(ids)
    assert max(ids) >= page_rows  # offsets carried past the first page


@pytest.mark.parametrize("join_type", ["semi", "anti"])
def test_semi_join_node_matches_reference(conns, join_type):
    ref_conn, conn = conns

    def plan(Pm):
        left = Pm.TableScan("tpch", "customer", ("c_custkey", "c_nationkey"))
        right = Pm.TableScan("tpch", "orders", ("o_custkey", "o_totalprice"))
        return Pm.HashJoin(left, right, (0,), (0,), join_type=join_type)

    _n, want = RefExecutor({"tpch": ref_conn}, page_rows=1 << 10,
                           use_jit=False).execute(plan(RP))
    ex = Executor({"tpch": conn}, page_rows=1 << 10, device="cpu")
    assert [str(t) for t in ex.output_types(plan(P))] == [
        "bigint", "bigint", "boolean"]
    _n, got = ex.execute(plan(P))
    assert got == want
    assert {r[-1] for r in got} == {True, False}


# IN / NOT IN / EXISTS / NOT EXISTS with NULLs on either side
SQL = {
    "in_build_null": (
        "select count(*) from nation where n_nationkey in (select case "
        "when r_regionkey = 1 then null else r_regionkey end from region)",
        "SELECT COUNT(*) FROM nation WHERE n_nationkey IN (SELECT CASE "
        "WHEN r_regionkey = 1 THEN NULL ELSE r_regionkey END FROM region)"),
    "not_in_build_null": (
        "select count(*) from nation where n_nationkey not in (select "
        "case when r_regionkey = 1 then null else r_regionkey end "
        "from region)",
        "SELECT COUNT(*) FROM nation WHERE n_nationkey NOT IN (SELECT CASE "
        "WHEN r_regionkey = 1 THEN NULL ELSE r_regionkey END FROM region)"),
    "not_in_probe_null": (
        "select count(*) from nation where (case when n_nationkey = 3 "
        "then null else n_nationkey end) not in (select r_regionkey "
        "from region)",
        "SELECT COUNT(*) FROM nation WHERE (CASE WHEN n_nationkey = 3 "
        "THEN NULL ELSE n_nationkey END) NOT IN (SELECT r_regionkey "
        "FROM region)"),
    "exists": (
        "select count(*) from customer where exists (select * from orders "
        "where o_custkey = c_custkey and o_totalprice > 200000)",
        "SELECT COUNT(*) FROM customer WHERE EXISTS (SELECT * FROM orders "
        "WHERE o_custkey = c_custkey AND o_totalprice > 20000000)"),
    "not_exists": (
        "select count(*) from customer where not exists (select * from "
        "orders where o_custkey = c_custkey)",
        "SELECT COUNT(*) FROM customer WHERE NOT EXISTS (SELECT * FROM "
        "orders WHERE o_custkey = c_custkey)"),
    "two_key_exists": (
        "select count(*) from lineitem where exists (select * from "
        "partsupp where ps_partkey = l_partkey and ps_suppkey = l_suppkey "
        "and ps_availqty < 3000)",
        "SELECT COUNT(*) FROM lineitem WHERE EXISTS (SELECT 1 FROM "
        "partsupp WHERE ps_partkey = l_partkey AND ps_suppkey = l_suppkey "
        "AND ps_availqty < 3000)"),
}


@pytest.fixture(scope="module")
def db(conns):
    ref_conn, _ = conns
    return load_sqlite(ref_conn, ref_conn.tables())


@pytest.mark.parametrize("name", sorted(SQL))
def test_semi_anti_sql_matches_sqlite_and_reference(name, conns, db):
    ref_conn, conn = conns
    sql, oracle = SQL[name]
    got = LocalRunner({"tpch": conn}, device="cpu",
                      session={"page_rows": 1 << 12}).execute(sql).rows
    assert got == [tuple(r) for r in db.execute(oracle).fetchall()]
    want = RefRunner({"tpch": ref_conn}, page_rows=1 << 12).execute(sql).rows
    assert got == want


def test_semi_build_half_runs_once_per_pass(conns, monkeypatch):
    """A semi join's build half (hash and sort of the whole build) is
    made once per pass and probed page by page, not once per probe
    page, on one device and on each shard of a mesh; the rows equal a
    one-page run's and the reference's."""
    from tests.tpch_queries import QUERIES

    ref_conn, conn = conns
    builds = []
    real = J.semi_join_build
    monkeypatch.setattr(J, "semi_join_build",
                        lambda *a: builds.append(1) or real(*a))
    sql = QUERIES[4]  # EXISTS over lineitem: one semi join
    many = LocalRunner({"tpch": conn}, page_rows=1 << 9,
                       device="cpu").execute(sql).rows
    probe_pages = len(builds)
    builds.clear()
    one = LocalRunner({"tpch": conn}, page_rows=1 << 16,
                      device="cpu").execute(sql).rows
    assert probe_pages == len(builds) == 1
    # the mesh path: one build half per shard per pass, whatever the
    # number of probe pages
    D = 2
    builds.clear()
    mesh_many = LocalRunner({"tpch": conn}, page_rows=1 << 9, device="cpu",
                            mesh=make_mesh(D, device="cpu")).execute(
        sql).rows
    assert len(builds) == D
    builds.clear()
    mesh_one = LocalRunner({"tpch": conn}, page_rows=1 << 16, device="cpu",
                           mesh=make_mesh(D, device="cpu")).execute(sql).rows
    assert len(builds) == D
    want = RefRunner({"tpch": ref_conn}, page_rows=1 << 16).execute(
        sql).rows
    assert many == one == mesh_many == mesh_one == want
