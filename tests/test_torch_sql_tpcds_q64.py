"""TPC-DS Q64 at SF 0.025, where its cross-channel chain is longer than
at SF 0.01 (tests/test_sql_tpcds.py's scale for it), through
presto_tpu_torch's LocalRunner on the CPU against sqlite: under the
default session (34 windowed and closed-form generated joins a pass)
and with the generated join off."""

import pytest
import torch

from presto_tpu.connectors.tpcds import TpcdsConnector as RefConnector
from presto_tpu_torch.connectors.tpcds import TpcdsConnector
from presto_tpu_torch.runner import LocalRunner
from tests.oracle import load_sqlite
from tests.test_sql_tpcds import ORACLE_64, Q64_SF, _compare, _StddevSamp
from tests.tpcds_queries import QUERIES


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


@pytest.fixture(scope="module")
def db():
    ref = RefConnector(Q64_SF)
    d = load_sqlite(ref, ref.tables())
    d.create_aggregate("stddev_samp", 1, _StddevSamp)
    return d


@pytest.fixture(scope="module")
def conn():
    return TpcdsConnector(Q64_SF, device="cpu")


@pytest.mark.parametrize("session", [{}, {"generated_join_enabled": "false"}],
                         ids=["default", "generated_join_off"])
def test_q64_matches_sqlite(session, conn, db):
    runner = LocalRunner({"tpcds": conn}, default_catalog="tpcds",
                         device="cpu",
                         session={"page_rows": 1 << 17, **session})
    got = runner.execute(QUERIES[64]).rows
    want = db.execute(ORACLE_64).fetchall()
    assert len(want) > 0, "oracle returned no rows"
    _compare(got, want, set(), "Q64")
    if not session:
        assert runner.executor.generated_joins_used > 0
