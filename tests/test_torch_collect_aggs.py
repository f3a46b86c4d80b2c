"""array_agg / map_agg / approx_percentile: presto_tpu_torch against
presto_tpu.

Module level: ``ops/collect`` insert, merge and percentile_select on
the same seeded group ids, values and slot counts (numpy) in both
engines, with groups past the slot bound (the overflow flag); the
order-preserving float slot encoding within a few code steps of the
reference's words (the reference scales by XLA's inexact exp2), for
zeros, negatives, NaN, tiny and huge magnitudes; the port's device
decode exact.

Query level: the counterparts of tests/test_collect_aggs.py on the same
memory tables, 16-row pages (multi-page partial -> merge -> final
folding): rows equal the reference engine's and the reference test's
expected values, NULL semantics included; a group past
``array_agg_max_elements`` takes the boosted retry in both engines;
and TPC-H SF 0.01 collect queries equal the reference's."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.exec import executor as RE
from presto_tpu.ops import collect as RC
from presto_tpu.page import Block as RBlock
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import executor as E
from presto_tpu_torch.ops import collect as C
from presto_tpu_torch.page import Block
from presto_tpu_torch.runner import LocalRunner
from tests.torch_memory import MemoryConnector

ROWS_T = [(1, 10, "a", 1.5), (1, 20, "b", 2.5), (2, 30, "c", 3.5),
          (2, None, "d", 4.5), (1, 40, "a", 0.5), (3, None, None, None)]
ROWS_BIG = [(i % 3, i) for i in range(40)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ module level
@pytest.mark.parametrize("n,groups,K", [(50, 4, 32), (600, 9, 64),
                                        (300, 3, 64), (200, 40, 4)])
def test_insert_merge_percentile_match_reference(n, groups, K):
    rng = np.random.default_rng(n * K + groups)
    gid = rng.integers(0, groups, n)
    contributing = rng.random(n) < 0.85
    vals = rng.integers(-10 ** 9, 10 ** 9, n)
    rs, rovf = RC.insert(jnp.asarray(gid), jnp.asarray(contributing),
                         groups, jnp.asarray(vals), K)
    ps, povf = C.insert(torch.from_numpy(gid),
                        torch.from_numpy(contributing), groups,
                        torch.from_numpy(vals), K)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    assert bool(povf) == bool(rovf)
    counts = np.minimum(np.bincount(gid[contributing], minlength=groups),
                        K)
    # merge: two partial state rows per group in shuffled row order
    mg = rng.permutation(np.concatenate([np.arange(groups)] * 2))
    state = np.concatenate([np.asarray(rs), np.asarray(rs)])[mg]
    cnt = np.concatenate([counts, counts])[mg]
    live = rng.random(2 * groups) < 0.9
    rm, rmo = RC.merge(jnp.asarray(mg % groups), jnp.asarray(live), groups,
                       jnp.asarray(state), jnp.asarray(cnt), K)
    pm, pmo = C.merge(torch.from_numpy(mg % groups), torch.from_numpy(live),
                      groups, torch.from_numpy(state),
                      torch.from_numpy(cnt), K)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))
    assert bool(pmo) == bool(rmo)
    for frac in (0.0, 0.25, 0.5, 0.99, 1.0):
        np.testing.assert_array_equal(
            C.percentile_select(ps, torch.from_numpy(counts), frac,
                                K).numpy(),
            np.asarray(RC.percentile_select(rs, jnp.asarray(counts), frac,
                                            K)))


def test_float_slot_encoding_matches_reference():
    """The reference's sign/exponent/mantissa pack. The reference
    scales the mantissa by ``jnp.exp2``, which XLA's CPU backend
    computes as exp(x ln 2), a few ulp off for most integer exponents
    (a mantissa just below 1 then lands one exponent lower, at the
    field's top: the adjacent word); the port scales by the exact power
    of two. So the words agree within a few steps of the (order-
    preserving) code, the port's round trip is exact, and the decoded
    values agree far inside the round's 9 significant digits."""
    rng = np.random.default_rng(11)
    x = np.concatenate([
        rng.normal(0, 1e3, 200), rng.normal(0, 1e-6, 50),
        [0.0, -0.0, 1.0, -1.0, 0.5, 2.0 ** 52, -(2.0 ** -30), 1e200,
         -1e-300, 3.0, np.nan, 0.1, 1 / 3, -11.375, -14.625]])
    got = E._collect_encode(Block(data=torch.from_numpy(x),
                                  type=T.DOUBLE)).numpy()
    want = np.asarray(RE._collect_encode(RBlock(data=jnp.asarray(x),
                                                type=RT.DOUBLE)))
    # 2^12 steps of a 2^52-step mantissa field: 1e-12 relative
    assert (np.abs(got - want) <= 1 << 12).all()
    finite = ~np.isnan(x)
    order = np.argsort(x[finite], kind="stable")
    assert (np.diff(got[finite][order]) >= 0).all()  # order-preserving
    back = E._collect_float_decode_device(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back[finite], np.where(
        x[finite] == 0, 0.0, x[finite]))
    ref_back = np.asarray(RE._collect_float_decode_device(
        jnp.asarray(want)))
    np.testing.assert_allclose(back[finite], ref_back[finite], rtol=1e-12)


def test_integer_and_code_slots_match_reference():
    rng = np.random.default_rng(12)
    vals = rng.integers(-10 ** 12, 10 ** 12, 64)
    got = E._collect_encode(Block(data=torch.from_numpy(vals),
                                  type=T.BIGINT))
    want = RE._collect_encode(RBlock(data=jnp.asarray(vals),
                                     type=RT.BIGINT))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- query level
@pytest.fixture(scope="module")
def port():
    conn = MemoryConnector(device="cpu")
    conn.create_table("t", ["g", "x", "s", "d"],
                      [T.BIGINT, T.BIGINT, T.VARCHAR, T.DOUBLE], ROWS_T)
    conn.create_table("big", ["g", "x"], [T.BIGINT, T.BIGINT], ROWS_BIG)
    return LocalRunner({"mem": conn}, default_catalog="mem",
                       session={"page_rows": 1 << 4}, device="cpu")


@pytest.fixture(scope="module")
def reference():
    conn = RefMemory()
    conn.create_table("t", ["g", "x", "s", "d"],
                      [RT.BIGINT, RT.BIGINT, RT.VARCHAR, RT.DOUBLE], ROWS_T)
    conn.create_table("big", ["g", "x"], [RT.BIGINT, RT.BIGINT], ROWS_BIG)
    return LocalRunner_ref(conn)


def LocalRunner_ref(conn):
    return RefRunner({"mem": conn}, default_catalog="mem",
                     page_rows=1 << 4)


# sql -> the reference test's expected sorted rows (None: compare with
# the reference engine only)
CASES = {
    "select g, array_agg(x) from t group by g":
        [(1, (10, 20, 40)), (2, (30, None)), (3, (None,))],
    "select array_agg(x) from t":
        [((10, 20, 30, None, 40, None),)],
    "select g, array_agg(s) from t group by g":
        [(1, ("a", "b", "a")), (2, ("c", "d")), (3, (None,))],
    "select array_agg(d) from t where g = 1": [((1.5, 2.5, 0.5),)],
    "select array_agg(d * -3.25) from t where g = 2":
        [((-11.375, -14.625),)],
    "select array_agg(distinct s) from t where g = 1": None,
    "select g, array_agg(x) from big group by g": [
        (0, tuple(range(0, 40, 3))), (1, tuple(range(1, 40, 3))),
        (2, tuple(range(2, 40, 3)))],
    "select g, map_agg(s, x) from t where s is not null "
    "and x is not null group by g":
        [(1, (("a", 10), ("b", 20), ("a", 40))), (2, (("c", 30),))],
    "select g, map_agg(s, x) from t group by g": [
        (1, (("a", 10), ("b", 20), ("a", 40))),
        (2, (("c", 30), ("d", None))), (3, None)],
    "select g, approx_percentile(x, 0.5) from t group by g":
        [(1, 20), (2, 30), (3, None)],
    "select approx_percentile(x, 0.99) from t": [(40,)],
    "select approx_percentile(d, 0.5) from t": [(2.5,)],
    "select g, count(*), array_agg(x), sum(x) from big group by g": None,
}


def _close(a, b):
    """Equal, doubles to 9 significant digits (collected doubles ride
    the float slot pack; see the encoding test above)."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=1e-9)
    return a == b


@pytest.mark.parametrize("sql", sorted(CASES))
def test_collect_matches_reference(sql, port, reference):
    got = sorted(port.execute(sql).rows, key=repr)
    assert _close(tuple(got),
                  tuple(sorted(reference.execute(sql).rows, key=repr)))
    want = CASES[sql]
    if want is not None:
        assert got == sorted(want, key=repr)
    if "distinct" in sql:
        assert sorted(got[0][0]) == ["a", "b"]


def test_collect_k_overflow_retries():
    conn = MemoryConnector(device="cpu")
    conn.create_table("big", ["g", "x"], [T.BIGINT, T.BIGINT], ROWS_BIG)
    port = LocalRunner({"mem": conn}, default_catalog="mem", session={
        "page_rows": 1 << 4, "array_agg_max_elements": 4}, device="cpu")
    ref_conn = RefMemory()
    ref_conn.create_table("big", ["g", "x"], [RT.BIGINT, RT.BIGINT],
                          ROWS_BIG)
    ref = LocalRunner_ref(ref_conn)
    ref.session.set("array_agg_max_elements", 4)
    sql = "select g, array_agg(x) from big group by g"
    got = sorted(port.execute(sql).rows)
    assert got == sorted(ref.execute(sql).rows)
    assert got[0] == (0, tuple(range(0, 40, 3)))
    assert port.executor.collect_k == 4
    assert port.executor._capacity_boost > 1
    assert port.executor._capacity_boost == ref.executor._capacity_boost


TPCH = [
    "select o_orderpriority, approx_percentile(o_totalprice, 0.5), "
    "approx_percentile(o_orderdate, 0.9), count(*) from orders "
    "group by o_orderpriority",
    "select n_regionkey, array_agg(n_name), map_agg(n_nationkey, "
    "n_regionkey) from nation group by n_regionkey",
]


@pytest.mark.parametrize("sql", TPCH)
def test_collect_tpch_matches_reference(sql):
    port = LocalRunner({"tpch": TpchConnector(0.01, device="cpu")},
                       session={"page_rows": 1 << 13}, device="cpu")
    ref = RefRunner({"tpch": RefConnector(0.01)}, page_rows=1 << 13)
    assert _close(tuple(sorted(port.execute(sql).rows)),
                  tuple(sorted(ref.execute(sql).rows)))
