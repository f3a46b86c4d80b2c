"""The scale paths' session properties forced small, second half of the
cases (test_torch_governed_sql.py has the first and the shared check)."""

import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from tests.oracle import load_sqlite
from tests.test_torch_governed_sql import SECOND, SF, check_forced


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def conns():
    return RefConnector(SF), TpchConnector(SF, device="cpu")


@pytest.fixture(scope="module")
def db(conns):
    return load_sqlite(conns[0], conns[0].tables())


@pytest.mark.parametrize("prop,q", SECOND)
def test_forced_property_matches_reference_and_sqlite(conns, db, prop, q,
                                                      tmp_path):
    check_forced(conns, db, prop, q, tmp_path)
