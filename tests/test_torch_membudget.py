"""Device-memory governor (exec/membudget.py): presto_tpu_torch against
presto_tpu.

Counterparts of tests/test_membudget.py's model, forced-rewrite and
EXPLAIN ANALYZE tests (its mesh and etc tests wait for planes the port
does not have, and its forced TPU fault line, which no device of the
port has): tiny budgets at SF 0.01 force the chunked rewrites on the
CPU, and the rows must equal the reference's,
the default budget's and sqlite's, with the governor's counter
(memory_chunked_pipelines) equal to the reference's. The sizing model
itself — rows_cap, parts_for, the budget resolution and the static
audit — is held equal to the reference's on the same inputs."""

import collections
import itertools

import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.exec import membudget as RMB
from presto_tpu.exec import shapes as RSH
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import membudget as MB
from presto_tpu_torch.exec import shapes as SH
from presto_tpu_torch.runner import LocalRunner
from tests.oracle import load_sqlite

SF = 0.01
PAGE_ROWS = 1 << 13
GJ_OFF = {"generated_join_enabled": "false"}

JOIN_Q = (
    "select o_orderkey, sum(l_extendedprice), count(*) "
    "from orders, lineitem where o_orderkey = l_orderkey "
    "group by o_orderkey order by 2 desc, 1 limit 7"
)
SCAN_AGG_Q = (
    "select l_returnflag, l_linestatus, sum(l_quantity), "
    "sum(l_extendedprice), count(*) from lineitem "
    "where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus order by 1, 2"
)


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
def base(conns):
    """The default budget's rows of both queries (port)."""
    r = LocalRunner({"tpch": conns[1]}, session={"page_rows": PAGE_ROWS},
                    device="cpu")
    return {q: r.execute(q).rows for q in (JOIN_Q, SCAN_AGG_Q)}


def rows_equal(a, b):
    return collections.Counter(map(repr, a)) == collections.Counter(
        map(repr, b))


def pair(conns, session):
    """The port's and the reference's runner on one session."""
    ref_conn, conn = conns
    port = LocalRunner({"tpch": conn},
                       session={"page_rows": PAGE_ROWS, **session},
                       device="cpu")
    ref = RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS)
    for k, v in session.items():
        ref.session.set(k, v)
    return port, ref


def run_both(port, ref, sql):
    got = port.execute(sql).rows
    want = ref.execute(sql).rows
    assert rows_equal(got, want), (got[:3], want[:3])
    assert port.executor.memory_chunked_pipelines == \
        ref.executor.memory_chunked_pipelines
    assert port.executor.spill_partitions_used == \
        ref.executor.spill_partitions_used
    return got


# ------------------------------------------------------------- model
def test_resolve_budget_cpu_is_generous():
    assert MB.resolve_budget(0, "cpu") == MB.CPU_BUDGET == \
        RMB.resolve_budget(0, "cpu")
    assert MB.resolve_budget(12345, "cpu") == 12345
    assert MB.resolve_budget(12345, "cuda") == 12345 == \
        RMB.resolve_budget(12345, "tpu")
    assert MB.resolve_budget(0, torch.device("cpu")) == MB.CPU_BUDGET
    for name in ("HEADROOM_DIV", "CPU_BUDGET", "BUILD_SHARE_DIV",
                 "PAGE_SHARE_DIV", "SCAN_SHARE_DIV", "STORE_SHARE_DIV"):
        assert getattr(MB, name) == getattr(RMB, name), name


ROW_BYTES = (1, 7, 30, 100, 1024)
BUDGETS = (0, 1 << 20, 1 << 21, 123_456_789, 1 << 34)
DIVS = (2, 4, 8)


def test_rows_cap_matches_reference():
    """The reference's rows_cap with no fault line (none applies off a
    TPU)."""
    for rb, b, d in itertools.product(ROW_BYTES, BUDGETS, DIVS):
        got = MB.rows_cap(rb, b, d)
        assert got == RMB.rows_cap(rb, b, None, d), (rb, b, d)
        if got is not None:
            assert got & (got - 1) == 0  # on the ladder, rounded down
            assert got <= max(b // d // rb if b else got, SH.LADDER_MIN)


def test_rows_cap_on_ladder():
    cap = MB.rows_cap(100, 1 << 20, 4)  # 256 KiB share / 100 B
    assert cap & (cap - 1) == 0
    assert cap * 100 <= (1 << 20) // 4
    assert MB.rows_cap(100, 0, 4) is None


def test_parts_for_matches_reference():
    assert SH.parts_for(60_000_000, 32, rows_cap=1 << 21,
                        bytes_cap=None) == 32
    assert SH.parts_for(1 << 20, 1024, rows_cap=1 << 21,
                        bytes_cap=1 << 22) == 256
    assert SH.parts_for(100, 8, rows_cap=None, bytes_cap=None) == 1
    for rows, rb, rc, bc in itertools.product(
            (100, 15_000, 6_001_215, 1 << 30), (8, 32, 1024),
            (None, 8, 4096, 1 << 21), (None, 8, 1 << 22, 1 << 30)):
        assert SH.parts_for(rows, rb, rc, bc) == \
            RSH.parts_for(rows, rb, rc, bc), (rows, rb, rc, bc)
    assert SH.LADDER_MIN == RSH.LADDER_MIN
    assert SH.chunk_bucket(12345, 8) == RSH.chunk_bucket(12345, 8)


def test_buffer_bytes_is_the_allocation():
    assert SH.buffer_bytes(1000, 10) == 1024 * 10 == \
        RSH.buffer_bytes(1000, 10)


# ------------------------------------- forced chunked rewrites (CPU)
def test_tiny_budget_chunks_join_oracle_exact(conns, base):
    """A budget too small for the join's build in one pass: the governor
    grace-partitions it, probe pages position-chunk, rows unchanged."""
    port, ref = pair(conns, {"device_memory_budget": 1 << 21, **GJ_OFF})
    got = run_both(port, ref, JOIN_Q)
    assert port.executor.memory_chunked_pipelines > 0
    assert rows_equal(base[JOIN_Q], got)


def test_tiny_budget_chunks_scan_agg_oracle_exact(conns, base):
    """Generation-chunked scan: the page shrinks to fit the budget share
    and the Q1-shaped pipeline streams through smaller buffers."""
    port, ref = pair(conns, {"device_memory_budget": 1 << 20})
    got = run_both(port, ref, SCAN_AGG_Q)
    ex = port.executor
    assert ex.memory_chunked_pipelines > 0
    schema = conns[1].table_schema("lineitem")
    types = [schema.column_type(c) for c in schema.column_names()]
    target = ex._governed_target_rows(types, count=False)
    assert target < PAGE_ROWS
    ref_schema = conns[0].table_schema("lineitem")
    assert target == ref.executor._governed_target_rows(
        [ref_schema.column_type(c) for c in ref_schema.column_names()],
        count=False)
    assert rows_equal(base[SCAN_AGG_Q], got)


def test_sqlite_oracle_parity_under_tiny_budget(conns):
    port, ref = pair(conns, {"device_memory_budget": 1 << 21, **GJ_OFF})
    got = run_both(port, ref, JOIN_Q)
    assert port.executor.memory_chunked_pipelines > 0
    db = load_sqlite(conns[0], ["orders", "lineitem"])
    want = db.execute(
        "select o_orderkey, sum(l_extendedprice), count(*) "
        "from orders join lineitem on o_orderkey = l_orderkey "
        "group by o_orderkey order by 2 desc, 1 limit 7").fetchall()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2] == w[2]
        assert abs(g[1] - w[1]) < 1e-4 * max(abs(w[1]), 1)


AUDIT_CASES = {
    "join_tiny_budget": (JOIN_Q, {"device_memory_budget": 1 << 21,
                                  **GJ_OFF}),
    "scan_agg_tiny_budget": (SCAN_AGG_Q, {"device_memory_budget": 1 << 20}),
    "genjoin_default": (JOIN_Q, {"device_memory_budget": 1 << 22}),
    "auto_budget": (JOIN_Q, GJ_OFF),
}


@pytest.mark.parametrize("name", sorted(AUDIT_CASES))
def test_static_audit_matches_reference(conns, name):
    """membudget.audit predicts the reference's buffers from the plan
    alone: the same labels, ladder rows, row widths and rewrites."""
    sql, session = AUDIT_CASES[name]
    port, ref = pair(conns, session)
    port.apply_session()
    ref.apply_session()
    got = MB.audit(port.executor, port.plan(sql))
    want = RMB.audit(ref.executor, ref.plan(sql))
    assert got.budget == want.budget
    assert want.fault_rows is None
    assert [(b.label, b.rows, b.row_bytes, b.chunked)
            for b in got.buffers] == [
        (b.label, b.rows, b.row_bytes, b.chunked) for b in want.buffers]
    assert got.peak_bytes == want.peak_bytes
    assert got.chunked_count == want.chunked_count
    assert got.ok == want.ok
    # the reference's header also names its fault line (none here)
    assert MB.render(got) == RMB.render(want).replace(
        ", fault line — rows", "")
    if "tiny" in name:
        assert got.chunked_count > 0


# --------------------------------------------------- observability
def test_explain_analyze_exposes_governor_counters(conns):
    """The governor's counters reach EXPLAIN ANALYZE (the counter
    registry), equal to the reference's on the same session."""
    port, ref = pair(conns, {"device_memory_budget": 1 << 20})
    port.apply_session()
    ref.apply_session()
    _n, _r, stats = port.executor.execute_with_stats(
        port.plan(SCAN_AGG_Q))
    _n, _r, ref_stats = ref.executor.execute_with_stats(
        ref.plan(SCAN_AGG_Q))
    ctr = stats["counters"]
    assert ctr["peak_device_bytes"] > 0
    assert ctr["memory_chunked_pipelines"] > 0
    assert ctr["memory_chunked_pipelines"] == \
        ref_stats["counters"]["memory_chunked_pipelines"]
    text = "\n".join(r[0] for r in port.execute(
        "explain analyze " + SCAN_AGG_Q).rows)
    assert "peak_device_bytes" in text
    assert "memory_chunked_pipelines" in text
