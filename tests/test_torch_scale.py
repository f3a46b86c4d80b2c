"""Scale validation of the port: checksum-verified parity at SF 0.1, 20x
the toy suite's scale, through presto_tpu_torch's LocalRunner on the CPU.

The counterpart of tests/test_scale.py, case for case: the verifier's
checksum properties; Q1, Q3 and Q6 against sqlite over the same
generated rows; Q1, Q6 and Q4 at page_rows 2^10 (multi-page streams,
partial-aggregation capacity clipping, the boost retry) against 2^15;
Q1, Q6 and Q12 single-process against the 8-shard mesh. Q4's and Q12's
2^15 rows are held to sqlite too, so each self-comparison has an
anchor that shares no fault with it. The queries and the sqlite oracle
are presto_tpu_torch/queries.py's.
"""

import pytest
import torch

from presto_tpu_torch import queries as PQ
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.verifier import assert_same_results, checksum_rows

SF = 0.1  # 20x the toy suite; ~600k lineitem slots


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
    return TpchConnector(SF, device="cpu")


@pytest.fixture(scope="module")
def db(conn):
    """sqlite over the connector's own rows, loaded once."""
    return PQ.load_sqlite(conn, ["customer", "orders", "lineitem"])


def check_sqlite(qid, got, db):
    sql, modes = PQ.TPCH_ORACLE[qid]
    PQ.compare_tpch(qid, got, db.execute(sql).fetchall(), modes)


@pytest.fixture(scope="module")
def runner(conn):
    return LocalRunner({"tpch": conn}, page_rows=1 << 15, device="cpu")


def test_checksum_utility_properties():
    rows = [(1, "a", 2.5), (2, "b", None), (3, "a", 0.0)]
    base = checksum_rows(rows)
    # order-insensitive
    assert checksum_rows(list(reversed(rows))) == base
    # value-sensitive
    assert checksum_rows([(1, "a", 2.5), (2, "b", None),
                          (3, "a", 1.0)]) != base
    # count-sensitive
    assert checksum_rows(rows[:2])["count"] == 2


@pytest.mark.parametrize("qid", [1, 3, 6])
def test_sf01_engine_vs_sqlite(qid, runner, db):
    check_sqlite(qid, runner.execute(PQ.TPCH_SQL[qid]).rows, db)


def test_small_pages_force_capacity_paths(conn, db):
    """Tiny page_rows force multi-page streams, partial-agg capacity
    clipping and the query-level boost retry; the results must equal
    the comfortable configuration's (checksum compare), and Q4's those
    of sqlite (Q1 and Q6 meet it in test_sf01_engine_vs_sqlite)."""
    wide = LocalRunner({"tpch": conn}, page_rows=1 << 15, device="cpu")
    tight = LocalRunner({"tpch": conn}, page_rows=1 << 10, device="cpu")
    for qid in (1, 6, 4):
        a = wide.execute(PQ.TPCH_SQL[qid]).rows
        b = tight.execute(PQ.TPCH_SQL[qid]).rows
        assert_same_results(a, b, label=f"Q{qid} page_rows 32k vs 1k")
    check_sqlite(4, a, db)


def test_single_vs_distributed_checksum(conn, db):
    """The 8-shard mesh's rows equal the single device's, and Q12's
    those of sqlite (Q1 and Q6 meet it in test_sf01_engine_vs_sqlite)."""
    from presto_tpu_torch.dist.executor import make_mesh

    single = LocalRunner({"tpch": conn}, page_rows=1 << 15, device="cpu")
    dist = LocalRunner({"tpch": conn}, page_rows=1 << 15, device="cpu",
                       mesh=make_mesh(8, device="cpu"))
    for qid in (1, 6, 12):
        a = single.execute(PQ.TPCH_SQL[qid]).rows
        b = dist.execute(PQ.TPCH_SQL[qid]).rows
        assert_same_results(a, b, label=f"Q{qid} single vs dist @ SF{SF}")
    check_sqlite(12, a, db)
