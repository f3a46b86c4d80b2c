"""ARRAY / MAP / ROW values and UNNEST: presto_tpu_torch against
presto_tpu.

The counterparts of tests/test_complex_types.py on the same memory
tables (an ARRAY(VARCHAR) column with empty and NULL arrays, an
ARRAY(BIGINT) column) and TPC-H SF 0.001: the complex-type functions
(cardinality, element_at, contains, array_min/array_max, map,
map_keys/map_values, row), UNNEST of literals and columns, WITH
ORDINALITY, CROSS JOIN UNNEST and grouping by an array column; each
result equals the reference engine's rows and the reference test's
expected values. ``_unnest_page`` equals the reference's page for page
on a seeded array column, and the stage-DAG path (two in-process
workers) gives the single-process rows."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.exec import executor as RE
from presto_tpu.page import Page as RPage
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.dcn import DcnRunner
from presto_tpu_torch.exec import executor as E
from presto_tpu_torch.page import Page
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server.worker import WorkerServer
from tests.torch_memory import MemoryConnector

DOCS = [(1, ("red", "blue")), (2, ("green",)), (3, ()), (4, None),
        (5, ("red",))]
NUMS = [(1, (10, 20, 30)), (2, (5,)), (3, (7, 7))]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    mem = MemoryConnector(device="cpu")
    mem.create_table("docs", ["id", "tags"],
                     [T.BIGINT, T.ArrayType(T.VARCHAR)], DOCS)
    mem.create_table("nums", ["id", "xs"],
                     [T.BIGINT, T.ArrayType(T.BIGINT)], NUMS)
    return LocalRunner({"memory": mem,
                        "tpch": TpchConnector(0.001, device="cpu")},
                       default_catalog="memory", device="cpu")


@pytest.fixture(scope="module")
def reference():
    mem = RefMemory()
    mem.create_table("docs", ["id", "tags"],
                     [RT.BIGINT, RT.ArrayType(RT.VARCHAR)], DOCS)
    mem.create_table("nums", ["id", "xs"],
                     [RT.BIGINT, RT.ArrayType(RT.BIGINT)], NUMS)
    return RefRunner({"memory": mem, "tpch": RefConnector(0.001)},
                     default_catalog="memory")


def _one(expr):
    return f"select {expr} from tpch.region limit 1"


# sql -> the reference test's expected rows
CASES = {
    _one("cardinality(array[1,2,3])"): [(3,)],
    _one("element_at(array[10,20,30], 2)"): [(20,)],
    _one("element_at(array[10], 5)"): [(None,)],
    _one("contains(array[1,2,3], 2)"): [(True,)],
    _one("contains(array[1,2,3], 9)"): [(False,)],
    _one("array_min(array[3,1,2]), array_max(array[3,1,2])"): [(1, 3)],
    _one("cardinality(array[])"): [(0,)],
    _one("element_at(map(array['a','b'], array[1,2]), 'b')"): [(2,)],
    _one("element_at(map(array['a'], array[1]), 'zz')"): [(None,)],
    _one("cardinality(map(array['a','b'], array[1,2]))"): [(2,)],
    _one("map_keys(map(array['a','b'], array[1,2]))"): [(("a", "b"),)],
    _one("map_values(map(array['a','b'], array[1,2]))"): [((1, 2),)],
    _one("element_at(row(7, 'x'), 1)"): [(7,)],
    _one("element_at(row(7, 'x'), 2)"): [("x",)],
    "select x from unnest(array[5,6,7]) as t(x)": [(5,), (6,), (7,)],
    "select x, o from unnest(array['a','b']) with ordinality as t(x, o)":
        [("a", 1), ("b", 2)],
    "select sum(x) from unnest(array[1,2,3,4]) as t(x)": [(10,)],
    "select r_name, x from tpch.region cross join unnest(array[1,2]) "
    "as t(x) order by r_name, x limit 4":
        [("AFRICA", 1), ("AFRICA", 2), ("AMERICA", 1), ("AMERICA", 2)],
    "select id, t from docs cross join unnest(tags) as u(t) "
    "order by id, t":
        [(1, "blue"), (1, "red"), (2, "green"), (5, "red")],
    "select t, count(*) from docs cross join unnest(tags) as u(t) "
    "group by t order by t": [("blue", 1), ("green", 1), ("red", 2)],
    "select id, cardinality(tags) from docs order by id":
        [(1, 2), (2, 1), (3, 0), (4, None), (5, 1)],
    "select id, sum(x) from nums cross join unnest(xs) as u(x) "
    "group by id order by id": [(1, 60), (2, 5), (3, 14)],
    "select id, x, n from nums cross join unnest(xs) with ordinality "
    "as u(x, n) order by id, n":
        [(1, 10, 1), (1, 20, 2), (1, 30, 3), (2, 5, 1), (3, 7, 1),
         (3, 7, 2)],
    "select id, element_at(xs, 2), contains(xs, 7), array_max(xs) "
    "from nums order by id":
        [(1, 20, False, 30), (2, None, False, 5), (3, 7, True, 7)],
}


@pytest.mark.parametrize("sql", list(CASES))
def test_complex_types_match_reference(sql, port, reference):
    got = port.execute(sql).rows
    assert got == reference.execute(sql).rows
    assert got == CASES[sql]


def test_group_by_array_column(port, reference):
    sql = ("select tags, count(*) from docs where tags is not null "
           "group by tags order by 2 desc limit 2")
    got = port.execute(sql).rows
    assert got[0][1] == 1  # all distinct arrays here
    assert len(got) == len(reference.execute(sql).rows) == 2
    full = "select tags, count(*) from docs group by tags"
    assert collections.Counter(port.execute(full).rows) == \
        collections.Counter(reference.execute(full).rows)


@pytest.mark.parametrize("ordinality", [False, True])
def test_unnest_page_matches_reference(ordinality):
    rng = np.random.default_rng(5 + ordinality)
    pool = [tuple(int(v) for v in rng.integers(0, 50, rng.integers(0, 5)))
            for _ in range(7)] + [(1, None, 3)]
    arrays = [None if rng.random() < 0.15 else pool[i]
              for i in rng.integers(0, len(pool), 40)]
    ids = list(range(40))
    at = RT.ArrayType(RT.BIGINT)
    rpage = RPage.from_arrays([ids, arrays], [RT.BIGINT, at])
    ppage = Page.from_arrays([ids, arrays], [T.BIGINT, T.ArrayType(
        T.BIGINT)], device="cpu")
    mask = np.zeros(rpage.capacity, bool)
    mask[:40] = rng.random(40) < 0.9
    rpage = RPage(blocks=rpage.blocks, valid=jnp.asarray(mask))
    ppage = Page(blocks=ppage.blocks, valid=torch.from_numpy(mask))
    rout = RE._unnest_page(1, RT.BIGINT, ordinality, rpage)
    pout = E._unnest_page(1, T.BIGINT, ordinality, ppage)
    np.testing.assert_array_equal(pout.valid.numpy(), np.asarray(rout.valid))
    assert pout.to_pylist() == rout.to_pylist()


@pytest.fixture(scope="module")
def workers():
    ws = [WorkerServer({"tpch": TpchConnector(0.005, device="cpu")},
                       node_id=f"u{i}", default_catalog="tpch",
                       page_rows=1 << 13, device="cpu")
          for i in range(2)]
    for w in ws:
        w.start()
    yield [w.uri for w in ws]
    for w in ws:
        w.stop()


def test_unnest_distributed(workers):
    q = ("select n_regionkey, sum(x) from nation cross join "
         "unnest(array[1,2,3]) as t(x) group by n_regionkey")
    single = LocalRunner({"tpch": TpchConnector(0.005, device="cpu")},
                         session={"page_rows": 1 << 13}, device="cpu")
    coord = DcnRunner({"tpch": TpchConnector(0.005, device="cpu")},
                      workers, default_catalog="tpch",
                      session_props={"page_rows": 1 << 13,
                                     "stage_scheduler": "true"},
                      device="cpu")
    got = coord.execute(q)
    assert coord.last_distribution == "stage-dag"
    assert collections.Counter(got) == collections.Counter(
        single.execute(q).rows)
    assert sorted(got) == [(r, 6 * 5) for r in range(5)]
