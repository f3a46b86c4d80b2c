"""TPC-H Q11, Q13, Q14, Q15 and Q16 through presto_tpu_torch's
LocalRunner on the CPU against sqlite and presto_tpu, with the generated
join off and under the default session (tests/test_torch_sql_tpch22.py
``suite``)."""

from tests.test_torch_sql_tpch22 import suite

QUERIES = (11, 13, 14, 15, 16)
globals().update(suite(QUERIES))
