"""TPC-DS Q42, Q52, Q55, Q62, Q64, Q82, Q93 and Q96 at SF 0.01 through
presto_tpu_torch's LocalRunner on the CPU against sqlite and (all but
Q64) presto_tpu (tests/test_torch_sql_tpcds.py ``suite``)."""

from tests.test_torch_sql_tpcds import suite

QUERIES = (42, 52, 55, 62, 64, 82, 93, 96)
globals().update(suite(QUERIES))
