"""The rest of TPC-H through presto_tpu_torch's LocalRunner on the CPU:
the 15 queries tests/test_torch_sql_tpch.py does not hold (Q2, Q4, Q7,
Q8, Q9, Q11, Q13, Q14, Q15, Q16, Q18, Q19, Q20, Q21, Q22), which need
LIKE, substr, year, semi and anti joins and UniqueId. At SF 0.005 each
returns the sqlite oracle's rows (tests/test_sql_tpch.py's
ENGINE_SQL/ORACLE/compare) and presto_tpu's rows, twice: with the
generated join off, and under each engine's default session with
``generated_joins_used`` and ``(program_launches, splits_scanned)``
equal to presto_tpu's. Floats agree to 9 significant digits; everything
else exactly.

The queries are split over this file and test_torch_sql_tpch22_{b,c}.py
(``suite``), so no file holds more than five queries' reference
compiles."""

import math

import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import queries as PQ
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.runner import LocalRunner
from tests.oracle import load_sqlite
from tests.test_sql_tpch import ENGINE_SQL, ORACLE, compare

SF = 0.005
PAGE_ROWS = 1 << 15
GJ_OFF = {"generated_join_enabled": "false"}


def same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert math.isclose(a, b, rel_tol=1e-9), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


def suite(queries):
    """Module fixtures and tests over ``queries``, for
    ``globals().update(suite(...))``."""

    @pytest.fixture(scope="module", autouse=True)
    def one_torch_thread():
        """The suite runs several test files at once, one per worker
        process: one intra-op thread per process keeps the port's CPU
        runs from oversubscribing the cores (measured: 10-40x slower
        with 6 workers at the default thread count)."""
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)

    @pytest.fixture(scope="module")
    def ref_conn():
        return RefConnector(SF)

    @pytest.fixture(scope="module")
    def db(ref_conn):
        return load_sqlite(ref_conn, ref_conn.tables())

    @pytest.fixture(scope="module")
    def oracle(db):
        """sqlite's rows per query, each computed once (Q21's correlated
        subqueries take sqlite seconds)."""
        memo = {}

        def rows(q):
            if q not in memo:
                memo[q] = db.execute(ORACLE[q][0]).fetchall()
            return memo[q]

        return rows

    @pytest.fixture(scope="module")
    def conn():
        return TpchConnector(SF, device="cpu")

    def run_port(conn, session):
        runner = LocalRunner({"tpch": conn},
                             session={"page_rows": PAGE_ROWS, **session},
                             device="cpu")
        out = {}
        for q in queries:
            gen0 = runner.executor.generated_joins_used
            res = runner.execute(ENGINE_SQL[q])
            ex = runner.executor
            out[q] = (res, ex.generated_joins_used - gen0,
                      (ex.program_launches, ex.splits_scanned))
        return out

    def run_reference(runner):
        out = {}
        for q in queries:
            gen0 = runner.executor.generated_joins_used
            res = runner.execute(ENGINE_SQL[q])
            ex = runner.executor
            out[q] = (res, ex.generated_joins_used - gen0,
                      (ex.program_launches, ex.splits_scanned))
        return out

    @pytest.fixture(scope="module")
    def port(conn):
        return run_port(conn, GJ_OFF)

    @pytest.fixture(scope="module")
    def port_default(conn):
        return run_port(conn, {})

    @pytest.fixture(scope="module")
    def reference(ref_conn):
        # the reference's Pallas joins stay at their CPU default (off):
        # interpreted, they multiply its compile time, and the rows and
        # counters compared here do not depend on them
        r = RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS)
        r.session.set("generated_join_enabled", False)
        return run_reference(r)

    @pytest.fixture(scope="module")
    def reference_default(ref_conn):
        return run_reference(RefRunner({"tpch": ref_conn},
                                       page_rows=PAGE_ROWS))

    @pytest.mark.parametrize("q", queries)
    def test_port_matches_sqlite_oracle(q, port, oracle):
        compare(q, port[q][0].rows, oracle(q), ORACLE[q][1])

    @pytest.mark.parametrize("q", queries)
    def test_port_matches_reference_engine(q, port, reference):
        got, want = port[q][0], reference[q][0]
        same_rows(got.rows, want.rows)
        assert got.column_names == want.column_names
        assert got.column_types == want.column_types

    @pytest.mark.parametrize("q", queries)
    def test_default_session_matches_reference_and_sqlite(
            q, port_default, reference_default, oracle):
        (got, gen_used, launches) = port_default[q]
        (want, ref_gen_used, ref_launches) = reference_default[q]
        same_rows(got.rows, want.rows)
        assert got.column_names == want.column_names
        assert gen_used == ref_gen_used
        assert launches == ref_launches
        compare(q, got.rows, oracle(q), ORACLE[q][1])

    return {name: obj for name, obj in locals().items()
            if name not in ("queries", "run_port", "run_reference")}


QUERIES = (2, 4, 7, 8, 9)
globals().update(suite(QUERIES))


def test_every_query_is_held_once():
    """This file and its two siblings hold the 15 queries that
    tests/test_torch_sql_tpch.py does not, each once."""
    from tests import test_torch_sql_tpch as first
    from tests import test_torch_sql_tpch22_b as b
    from tests import test_torch_sql_tpch22_c as c

    held = list(first.QUERIES) + list(QUERIES) + list(b.QUERIES) \
        + list(c.QUERIES)
    assert sorted(held) == sorted(ENGINE_SQL) == list(range(1, 23))


def test_port_query_module_equals_the_oracle():
    """presto_tpu_torch/queries.py (chip_smoke.py's copy) holds the same
    engine and oracle SQL and modes as the test suite."""

    def norm(s):
        return " ".join(s.split())

    assert sorted(PQ.TPCH_SQL) == sorted(ENGINE_SQL)
    for q in ENGINE_SQL:
        assert norm(PQ.TPCH_SQL[q]) == norm(ENGINE_SQL[q]), q
        assert norm(PQ.TPCH_ORACLE[q][0]) == norm(ORACLE[q][0]), q
        assert PQ.TPCH_ORACLE[q][1] == ORACLE[q][1], q


def test_semi_joins_and_unique_ids_are_on_these_plans(conn):
    """Q4/Q21/Q22 plan semi or anti joins, Q21 UniqueIds: the plan node
    types these queries bring to the port."""
    from presto_tpu_torch.exec import plan as P

    runner = LocalRunner({"tpch": conn}, device="cpu")

    def kinds(node, acc):
        if isinstance(node, P.HashJoin):
            acc.add(node.join_type)
        if isinstance(node, P.UniqueId):
            acc.add("unique_id")
        for ch in node.children():
            kinds(ch, acc)
        return acc

    assert "semi" in kinds(runner.plan(ENGINE_SQL[4]), set())
    q21 = kinds(runner.plan(ENGINE_SQL[21]), set())
    assert "unique_id" in q21 and q21 & {"semi", "anti"}
    assert kinds(runner.plan(ENGINE_SQL[22]), set()) & {"semi", "anti"}
