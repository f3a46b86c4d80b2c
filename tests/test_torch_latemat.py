"""Late materialization for join chains (exec/latemat.py):
presto_tpu_torch against presto_tpu.

Counterparts of tests/test_latemat.py's join-chain tests: hand-built
plans over memory-connector tables pin join order, build sides and
channel sets, and the same plan runs in both engines — rows equal, and
the gather counters (gathers_deferred, gathers_materialized) equal the
reference's and the exact values it asserts. Then the Q5-shaped SQL
chain through the general join path, against the eager run, the
reference and sqlite."""

import collections

import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.exec import plan as RP
from presto_tpu.exec.executor import Executor as RefExecutor
from presto_tpu.expr import ir as RIR
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.expr import ir as IR
from presto_tpu_torch.runner import LocalRunner
from tests.torch_memory import MemoryConnector
from tests.oracle import load_sqlite


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows_equal(a, b):
    return collections.Counter(map(repr, a)) == collections.Counter(
        map(repr, b))


def mem_pair(tables):
    """A memory connector per engine holding ``tables`` ({name: (columns,
    rows)}, every column BIGINT)."""
    port, ref = MemoryConnector(device="cpu"), RefMemory()
    for name, (cols, rows) in tables.items():
        port.create_table(name, cols, [T.BIGINT] * len(cols), rows)
        ref.create_table(name, cols, [RT.BIGINT] * len(cols), rows)
    return port, ref


def run_plan(tables, build, late_mat=True):
    """``build(P) -> plan`` run by both engines' raw Executors: rows
    (equal) and the port's executor, whose gather counters equal the
    reference's."""
    port_mem, ref_mem = mem_pair(tables)
    ex = Executor({"mem": port_mem}, device="cpu")
    ref = RefExecutor({"mem": ref_mem})
    ex.late_mat = ref.late_mat = late_mat
    _n, rows = ex.execute(build(P))
    _n, want = ref.execute(build(RP))
    assert rows_equal(rows, want)
    assert ex.gathers_deferred == ref.gathers_deferred
    assert ex.gathers_materialized == ref.gathers_materialized
    return rows, ex


CHAIN = {
    "t1": (["k1", "a"], [(i, i * 10) for i in range(100)]),
    "t2": (["k2", "b", "c"], [(i, i + 1, i + 2) for i in range(100)]),
    "t3": (["k3", "d"], [(i, -i) for i in range(100)]),
}


def chain_j1(Pm):
    return Pm.HashJoin(Pm.TableScan("mem", "t1", ("k1", "a")),
                       Pm.TableScan("mem", "t2", ("k2", "b", "c")),
                       (0,), (0,), "inner")


def chain(Pm):
    """t1 ⋈ t2 ⋈ t3 on a shared key — the Q5-shaped probe spine."""
    return Pm.HashJoin(chain_j1(Pm), Pm.TableScan("mem", "t3", ("k3", "d")),
                       (0,), (0,), "inner")


def test_chain_single_gather_per_carried_build_column():
    """Every carried build column is VALUE-gathered exactly once (at the
    chain boundary), however many joins it rides through."""
    rows, ex = run_plan(CHAIN, chain)
    assert rows_equal(rows, [(i, i * 10, i, i + 1, i + 2, i, -i)
                             for i in range(100)])
    # join1 defers t2's 3 columns; join2 defers t3's 2 and carries t2's 3
    assert ex.gathers_materialized == 5
    assert ex.gathers_deferred == 8


def test_chain_disabled_matches_and_defers_nothing():
    on, _ = run_plan(CHAIN, chain)
    off, ex = run_plan(CHAIN, chain, late_mat=False)
    assert rows_equal(on, off)
    assert ex.gathers_deferred == 0
    assert ex.gathers_materialized == 0


def test_left_join_null_build_side_survives_deferral():
    """LEFT-join pad rows stay NULL through the indirection and through
    a downstream join's composition."""
    tables = {
        "p": (["k", "a"], [(i, i) for i in range(20)]),
        "b": (["bk", "v"], [(i, 100 + i) for i in range(0, 20, 2)]),
        "t3": (["k3", "d"], [(i, -i) for i in range(20)]),
    }

    def plan(Pm):
        left = Pm.HashJoin(Pm.TableScan("mem", "p", ("k", "a")),
                           Pm.TableScan("mem", "b", ("bk", "v")),
                           (0,), (0,), "left")
        return Pm.HashJoin(left, Pm.TableScan("mem", "t3", ("k3", "d")),
                           (0,), (0,), "inner")

    rows, ex = run_plan(tables, plan)
    assert rows_equal(rows, [
        (i, i, i, 100 + i, i, -i) if i % 2 == 0
        else (i, i, None, None, i, -i) for i in range(20)])
    assert ex.gathers_materialized == 4
    assert ex.gathers_deferred == 6


def test_single_boundary_join_stays_eager():
    """A lone join's consumer materializes at once: the boundary join
    runs the eager path and the counters stay zero."""
    tables = {"p": (["k", "a"], [(i, i) for i in range(10)]),
              "b": (["bk", "v"], [(i, 100 + i) for i in range(10)])}

    def plan(Pm):
        return Pm.HashJoin(Pm.TableScan("mem", "p", ("k", "a")),
                           Pm.TableScan("mem", "b", ("bk", "v")),
                           (0,), (0,), "inner")

    rows, ex = run_plan(tables, plan)
    assert rows_equal(rows, [(i, i, i, 100 + i) for i in range(10)])
    assert ex.gathers_deferred == 0
    assert ex.gathers_materialized == 0


def test_lazy_filter_lifts_only_referenced_channels():
    """A filter between chained joins lifts exactly the deferred
    channels its predicate reads; the rest stay deferred."""

    def plan(Pm):
        ir = IR if Pm is P else RIR
        typ = T.BIGINT if Pm is P else RT.BIGINT
        boolean = T.BOOLEAN if Pm is P else RT.BOOLEAN
        pred = ir.Call("gt", (ir.InputRef(3, typ), ir.Constant(10, typ)),
                       boolean)
        return Pm.HashJoin(Pm.Filter(chain_j1(Pm), pred),
                           Pm.TableScan("mem", "t3", ("k3", "d")),
                           (0,), (0,), "inner")

    rows, ex = run_plan(CHAIN, plan)
    assert rows_equal(rows, [(i, i * 10, i, i + 1, i + 2, i, -i)
                             for i in range(100) if i + 1 > 10])
    # lift of `b` (1) + boundary gathers of k2, c, k3, d (4)
    assert ex.gathers_materialized == 5


Q5ISH = (
    "select n_name, sum(l_extendedprice * (1 - l_discount)) as rev "
    "from customer, orders, lineitem, supplier, nation "
    "where c_custkey = o_custkey and l_orderkey = o_orderkey "
    "and l_suppkey = s_suppkey and c_nationkey = s_nationkey "
    "and s_nationkey = n_nationkey "
    "group by n_name order by rev desc"
)


@pytest.fixture(scope="module")
def tpch():
    return RefConnector(0.01), TpchConnector(0.01, device="cpu")


def _q5ish(tpch, late_mat: str):
    ref_conn, conn = tpch
    session = {"generated_join_enabled": "false",
               "late_materialization_enabled": late_mat}
    # the kernels off, as the reference's CPU default has them: the
    # unique-key kernel path yields pages and defers nothing, in both
    port = LocalRunner({"tpch": conn},
                       session={"page_rows": 1 << 13,
                                "pallas_join_enabled": "false", **session},
                       device="cpu")
    ref = RefRunner({"tpch": ref_conn}, page_rows=1 << 13)
    for k, v in session.items():
        ref.session.set(k, v)
    got = port.execute(Q5ISH).rows
    assert got == ref.execute(Q5ISH).rows
    for c in ("gathers_deferred", "gathers_materialized"):
        assert getattr(port.executor, c) == getattr(ref.executor, c), c
    return got, port.executor


def test_q5_shaped_sql_parity_general_join_path(tpch):
    """The Q5-shaped chain through the general (materialized-build)
    path: late materialization forced on (auto is on only on a CUDA
    executor) against forced off."""
    on, ex = _q5ish(tpch, "true")
    assert ex.gathers_deferred > 0 and ex.gathers_materialized > 0
    # the chain composes: fewer value gathers than the eager engine's
    # per-join gathers of the same carried columns
    assert ex.gathers_materialized < ex.gathers_deferred
    off, ex_off = _q5ish(tpch, "false")
    assert ex_off.gathers_deferred == 0
    assert on == off


def test_q5ish_oracle_parity(tpch):
    got, _ = _q5ish(tpch, "true")
    db = load_sqlite(tpch[0], ["customer", "orders", "lineitem",
                               "supplier", "nation"])
    want = db.execute(
        "select n_name, sum(l_extendedprice * (100 - l_discount)) "
        "from customer, orders, lineitem, supplier, nation "
        "where c_custkey = o_custkey and l_orderkey = o_orderkey "
        "and l_suppkey = s_suppkey and c_nationkey = s_nationkey "
        "and s_nationkey = n_nationkey "
        "group by n_name order by 2 desc").fetchall()
    assert [(g[0], int(g[1])) for g in got] == [
        (w[0], int(w[1])) for w in want]


def test_late_mat_auto_resolves_per_device():
    """"auto" is on for a CUDA executor only (where the reference says
    on TPU); a raw Executor defaults to on, as the reference's does."""
    conn = TpchConnector(0.001, device="cpu")
    r = LocalRunner({"tpch": conn}, device="cpu")
    assert r.executor.late_mat == "auto"
    assert not r.executor._late_mat_on()
    ex = Executor({}, device="cpu")
    assert ex.late_mat is True and ex._late_mat_on()
    ex.late_mat = "auto"
    ex.device = torch.device("cuda")  # resolution only; nothing runs
    assert ex._late_mat_on()
