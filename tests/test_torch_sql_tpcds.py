"""TPC-DS through presto_tpu_torch's LocalRunner on the CPU: the 16
queries of tests/tpcds_queries.py at SF 0.01 return the sqlite oracle's
rows (tests/test_sql_tpcds.py's oracles and comparison) under the
default session and with the generated join off, and presto_tpu's rows
under the default session, with ``generated_joins_used`` (the windowed
generated join's fact-to-fact joins included) and ``(program_launches,
splits_scanned)`` equal to presto_tpu's. Q64, whose 18-table plan takes
presto_tpu many minutes of XLA compile on a CPU, is held against sqlite
only (the reference suite runs it opt-in too); at SF 0.025, where its
chain is longer, tests/test_torch_sql_tpcds_q64.py holds it.

The queries are split over this file and test_torch_sql_tpcds_b.py
(``suite``) to bound each file's reference compiles."""

import math

import pytest
import torch

from presto_tpu.connectors.tpcds import TpcdsConnector as RefConnector
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import queries as PQ
from presto_tpu_torch.connectors.tpcds import TpcdsConnector
from presto_tpu_torch.runner import LocalRunner
from tests.oracle import load_sqlite
from tests.test_sql_tpcds import _DS_ORACLE, _ORACLE_TABLES, _StddevSamp
from tests.test_sql_tpcds import _compare
from tests.tpcds_queries import QUERIES as SQL

SF = 0.01
PAGE_ROWS = 1 << 16
GJ_OFF = {"generated_join_enabled": "false"}
# the reference's CPU compile of Q64's plan takes many minutes
NOT_ON_THE_REFERENCE = (64,)


def same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert math.isclose(a, b, rel_tol=1e-9), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


def oracle_check(q, rows, db):
    sql, float_cols, round_cols = _DS_ORACLE[q]
    want = db.execute(sql).fetchall()
    assert want, f"Q{q}: the oracle returned no rows"
    _compare(rows, want, float_cols, f"Q{q}", round_cols)


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

    on_reference = tuple(q for q in queries if q not in NOT_ON_THE_REFERENCE)

    @pytest.fixture(scope="module")
    def ref_conn():
        return RefConnector(SF)

    @pytest.fixture(scope="module")
    def db(ref_conn):
        tables = ref_conn.tables() if 64 in queries else _ORACLE_TABLES
        d = load_sqlite(ref_conn, tables)
        d.create_aggregate("stddev_samp", 1, _StddevSamp)
        return d

    @pytest.fixture(scope="module")
    def conn():
        return TpcdsConnector(SF, device="cpu")

    def run_port(conn, session):
        runner = LocalRunner({"tpcds": conn}, default_catalog="tpcds",
                             session={"page_rows": PAGE_ROWS, **session},
                             device="cpu")
        out = {}
        for q in queries:
            gen0 = runner.executor.generated_joins_used
            res = runner.execute(SQL[q])
            ex = runner.executor
            out[q] = (res, ex.generated_joins_used - gen0,
                      (ex.program_launches, ex.splits_scanned))
        return out

    @pytest.fixture(scope="module")
    def port_default(conn):
        return run_port(conn, {})

    @pytest.fixture(scope="module")
    def port_off(conn):
        return run_port(conn, GJ_OFF)

    @pytest.fixture(scope="module")
    def reference_default(ref_conn):
        runner = RefRunner({"tpcds": ref_conn}, default_catalog="tpcds",
                           page_rows=PAGE_ROWS)
        out = {}
        for q in on_reference:
            gen0 = runner.executor.generated_joins_used
            res = runner.execute(SQL[q])
            ex = runner.executor
            out[q] = (res, ex.generated_joins_used - gen0,
                      (ex.program_launches, ex.splits_scanned))
        return out

    @pytest.mark.parametrize("q", queries)
    def test_default_session_matches_sqlite(q, port_default, db):
        oracle_check(q, port_default[q][0].rows, db)

    @pytest.mark.parametrize("q", queries)
    def test_generated_join_off_matches_sqlite(q, port_off, port_default,
                                               db):
        assert port_off[q][1] == 0
        oracle_check(q, port_off[q][0].rows, db)
        same_rows(port_off[q][0].rows, port_default[q][0].rows)

    @pytest.mark.parametrize("q", on_reference)
    def test_default_session_matches_reference(q, port_default,
                                               reference_default):
        got, gen_used, launches = port_default[q]
        want, ref_gen_used, ref_launches = reference_default[q]
        same_rows(got.rows, want.rows)
        assert got.column_names == want.column_names
        assert got.column_types == want.column_types
        assert gen_used == ref_gen_used
        assert launches == ref_launches

    return {name: obj for name, obj in locals().items()
            if name not in ("queries", "on_reference", "run_port")}


QUERIES = (3, 7, 17, 19, 25, 26, 29, 37)
globals().update(suite(QUERIES))


def test_every_query_is_held_once():
    from tests import test_torch_sql_tpcds_b as b

    assert sorted(QUERIES + b.QUERIES) == sorted(_DS_ORACLE)
    assert len(_DS_ORACLE) == 16


def test_port_query_module_equals_the_oracle():
    """presto_tpu_torch/queries.py (chip_smoke.py's copy) holds the same
    TPC-DS engine and oracle SQL and column modes as the test suite."""

    def norm(s):
        return " ".join(s.split())

    assert sorted(PQ.TPCDS_SQL) == sorted(_DS_ORACLE)
    for q, (sql, float_cols, round_cols) in _DS_ORACLE.items():
        assert norm(PQ.TPCDS_SQL[q]) == norm(SQL[q]), q
        assert norm(PQ.TPCDS_ORACLE[q][0]) == norm(sql), q
        assert PQ.TPCDS_ORACLE[q][1:] == (float_cols, round_cols), q


def test_q17_uses_the_windowed_generated_join(port_default):
    """Q17 joins store_sales to store_returns on ticket and item: on the
    default session the windowed inverse of sr_ticket_number makes it a
    generated join, as in presto_tpu (6 generated joins)."""
    assert port_default[17][1] == 6
