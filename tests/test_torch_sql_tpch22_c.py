"""TPC-H Q18, Q19, Q20, Q21 and Q22 through presto_tpu_torch's
LocalRunner on the CPU against sqlite and presto_tpu, with the generated
join off and under the default session (tests/test_torch_sql_tpch22.py
``suite``)."""

from tests.test_torch_sql_tpch22 import suite

QUERIES = (18, 19, 20, 21, 22)
globals().update(suite(QUERIES))
