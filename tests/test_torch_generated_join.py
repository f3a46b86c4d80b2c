"""Build-free generated joins in presto_tpu_torch (Connector.key_inverse
+ gen_at; exec/executor._generated_join_page) on the CPU, at SF 0.01.

Counterparts of tests/test_generated_join.py: each query's rows with the
generated join on equal the port's materialized joins
(generated_join_enabled=false), presto_tpu's generated join, and the
sqlite oracle. Also: the port's closed-form key inverses are
bit-identical to the reference's on every TPC-H key column, over keys
the table holds and keys it does not.
"""

import numpy as np
import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.runner import LocalRunner
from tests.oracle import load_sqlite


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once, and torch's default of one thread per core spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SF = 0.01


@pytest.fixture(scope="module")
def rig():
    runner = LocalRunner({"tpch": TpchConnector(SF, device="cpu")},
                         device="cpu")
    ref = RefRunner({"tpch": RefConnector(SF)})
    db = load_sqlite(RefConnector(SF), ["lineitem", "orders", "customer",
                                        "nation", "supplier", "region"])
    return runner, ref, db


def _run(runner, sql, generated=True):
    runner.session.set("generated_join_enabled", generated)
    try:
        before = runner.executor.generated_joins_used
        rows = sorted(runner.execute(sql).rows)
        return rows, runner.executor.generated_joins_used - before
    finally:
        runner.session.unset("generated_join_enabled")


def _check(rig, sql, oracle_sql=None):
    """Port generated == port materialized == presto_tpu generated (==
    sqlite when given); returns the port's rows. The generated join must
    engage on both engines, the same number of times."""
    runner, ref, db = rig
    got, used = _run(runner, sql)
    base, used_off = _run(runner, sql, generated=False)
    want, ref_used = _run(ref, sql)
    assert used > 0 and used_off == 0
    assert used == ref_used
    assert got == base == want
    if oracle_sql is not None:
        assert got == sorted(tuple(r) for r in db.execute(oracle_sql))
    return got


def test_inner_fk_join_matches_materialized_and_oracle(rig):
    got = _check(rig, (
        "select o_orderdate, count(*), sum(l_extendedprice) "
        "from lineitem join orders on l_orderkey = o_orderkey "
        "where o_orderdate < date '1995-03-15' "
        "group by o_orderdate order by 1 limit 50"))
    _, _, db = rig
    want = db.execute(
        "select o_orderdate, count(*), sum(l_extendedprice) "
        "from lineitem join orders on l_orderkey = o_orderkey "
        "where o_orderdate < 9204 group by o_orderdate order by 1 limit 50"
    ).fetchall()
    assert got == sorted(tuple(r) for r in want)


def test_left_join_unmatched_probe_rows_null_build_side(rig):
    # +1 lands on a hole of the sparse orderkey pattern for 7 of every
    # 8 keys, so most probe rows are unmatched
    got = _check(rig, (
        "select count(*), count(o_orderkey) from ("
        "  select l_orderkey + 1 as k from lineitem"
        ") left join orders on k = o_orderkey"), (
        "select count(*), count(o_orderkey) from ("
        "  select l_orderkey + 1 as k from lineitem"
        ") left join orders on k = o_orderkey"))
    total, matched = got[0]
    assert total > matched  # unmatched probe rows kept, build side null


def test_null_probe_keys_never_match(rig):
    sql = (
        "select count(*), count(o_orderkey) from ("
        "  select case when l_linenumber = 1 then null "
        "         else l_orderkey end as k from lineitem"
        ") left join orders on k = o_orderkey")
    _check(rig, sql, sql)


def test_multi_key_join_extra_equality(rig):
    # n_nationkey inverts; the second key pair (c_nationkey =
    # s_nationkey via the shared nation row) takes the non-pivot
    # equality path
    _check(rig, (
        "select n_name, count(*) from supplier, customer, nation "
        "where s_nationkey = n_nationkey and c_nationkey = n_nationkey "
        "group by n_name order by 2 desc, 1 limit 5"))


def test_build_side_filter_replayed(rig):
    _check(rig, (
        "select count(*) from lineitem join orders "
        "on l_orderkey = o_orderkey where o_orderdate >= date '1997-01-01'"
    ), (
        "select count(*) from lineitem join orders "
        "on l_orderkey = o_orderkey where o_orderdate >= 9862"))


def test_disabled_falls_back_to_materialized(rig):
    runner, _, db = rig
    sql = ("select count(*) from lineitem join orders "
           "on l_orderkey = o_orderkey")
    rows, used = _run(runner, sql, generated=False)
    assert used == 0
    assert rows == [tuple(r) for r in db.execute(sql)]


KEY_COLUMNS = [
    ("region", "r_regionkey"), ("nation", "n_nationkey"),
    ("part", "p_partkey"), ("supplier", "s_suppkey"),
    ("customer", "c_custkey"), ("orders", "o_orderkey")]


def _probe_keys(n: int) -> np.ndarray:
    """Keys around and inside the table's key range (present keys,
    holes of the sparse order keys, keys past both ends) and the int64
    extremes."""
    edge = np.array([-(1 << 63), -(1 << 62), -1, 0, 1, (1 << 62),
                     (1 << 63) - 1], dtype=np.int64)
    return np.concatenate([np.arange(-40, 4 * n + 64, dtype=np.int64),
                           edge])


@pytest.mark.parametrize("table,column", KEY_COLUMNS)
def test_key_inverse_matches_reference(table, column):
    import jax.numpy as jnp
    import torch

    port = TpchConnector(SF, device="cpu")
    ref = RefConnector(SF)
    vals = _probe_keys(port.row_count(table))
    ridx, found = port.key_inverse(table, column)(torch.from_numpy(vals))
    want_idx, want_found = ref.key_inverse(table, column)(jnp.asarray(vals))
    assert np.array_equal(ridx.numpy(), np.asarray(want_idx))
    assert np.array_equal(found.numpy(), np.asarray(want_found))
    assert found.any() and not found.all()
    # every key the table holds inverts to its row
    idx = torch.arange(port.row_count(table), dtype=torch.int64)
    (keys,), _ = port.gen_at(table, (column,))(idx)
    back, hit = port.key_inverse(table, column)(keys)
    assert hit.all() and torch.equal(back, idx)


def test_only_key_columns_invert_or_bound_rows():
    port = TpchConnector(SF, device="cpu")
    ref = RefConnector(SF)
    for table in port.tables():
        for column in port.table_schema(table).column_names():
            assert (port.key_inverse(table, column) is None) == (
                ref.key_inverse(table, column) is None), (table, column)
            bound = port.monotonic_row_bound(table, column)
            want = ref.monotonic_row_bound(table, column)
            assert (bound is None) == (want is None), (table, column)
            if bound is not None:
                assert [bound(v) for v in range(-5, 300)] == \
                    [want(v) for v in range(-5, 300)]


def test_prune_splits_matches_reference():
    """A pushed key range drops the same generator splits."""
    port = TpchConnector(SF, device="cpu")
    ref = RefConnector(SF)
    pruned = 0
    for table, column in (("lineitem", "l_orderkey"),
                          ("orders", "o_orderkey"),
                          ("customer", "c_custkey")):
        every = port.splits(table, 512)
        for lo, hi in ((None, 100), (100, 5000), (30000, None)):
            constraint = ((column, lo, hi),)
            got = port.prune_splits(table, every, constraint)
            want = ref.prune_splits(table, ref.splits(table, 512),
                                    constraint)
            assert [(s.start_row, s.row_count) for s in got] == \
                [(s.start_row, s.row_count) for s in want]
            pruned += len(got) < len(every)
    assert pruned >= 5
