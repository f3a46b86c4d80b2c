"""The port's other statements and its memory connector: presto_tpu_torch
against presto_tpu.

SET / SHOW SESSION, SHOW TABLES, CREATE TABLE AS, INSERT, DROP TABLE
and EXPLAIN on both engines; the memory connector's pages and split
pruning equal the reference connector's for the same rows (every
column type the connector stores, NULLs, several splits, INSERT's
dictionary merge, and the result-page write path); CREATE TABLE AS of
TPC-H SF 0.01 then Q1 and Q3 over the copies against sqlite; the keys
CREATE TABLE AS carries, which let Q5 over the copies plan as over
tpch; and SHOW TABLES FROM system, once left out, lists the reference's
system tables."""

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.base import Split as RSplit
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu.runner import explain_text as ref_explain_text
from presto_tpu_torch import queries as PQ
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.base import Split
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.runner import LocalRunner


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tpch():
    return (TpchConnector(0.01, device="cpu"), RefTpch(0.01))


@pytest.fixture()
def pair(tpch):
    port = LocalRunner({"tpch": tpch[0],
                        "memory": MemoryConnector(device="cpu")},
                       session={"page_rows": 1 << 13}, device="cpu")
    ref = RefRunner({"tpch": tpch[1], "memory": RefMemory()},
                    page_rows=1 << 13)
    return port, ref


def run(pair, sql):
    got, want = (r.execute(sql) for r in pair)
    assert (got.rows, got.update_type) == (want.rows, want.update_type), sql
    return got


def test_show_session_lists_the_ported_properties(pair):
    port, _ = pair
    rows = port.execute("show session").rows
    names = [r[0] for r in rows]
    assert names == sorted(names) and "page_rows" in names
    row = dict((r[0], r) for r in rows)["page_rows"]
    assert row[1:4] == (str(1 << 13), str(1 << 18), "int")
    assert port.execute("set session page_rows = 4096").update_type == \
        "SET SESSION"
    assert port.session.is_set("page_rows")
    assert port.executor.page_rows == 1 << 13  # applied per statement
    port.execute("select 1")
    assert port.executor.page_rows == 4096
    row = dict((r[0], r) for r in port.execute("show session").rows)
    assert row["page_rows"][1] == "4096"
    assert row["generated_join_enabled"][1:3] == ("true", "true")


def test_set_session_refuses_unported_planes(pair):
    port, _ = pair
    # the mesh plane is ported: SET SESSION takes it
    assert port.session.get("mesh_exchange_mode") == "auto"
    assert port.execute("set session mesh_exchange_mode = 'true'") \
        .update_type == "SET SESSION"
    assert port.session.get("mesh_exchange_mode") == "true"
    port.session.unset("mesh_exchange_mode")
    # the tailing cursor is not: asking for it raises, session unchanged
    with pytest.raises(NotImplementedError, match="stream_tail_enabled"):
        port.execute("set session stream_tail_enabled = true")
    assert port.session.get("stream_tail_enabled") is False
    with pytest.raises(KeyError):
        port.execute("set session no_such_property = 1")


def test_ctas_insert_show_drop(pair):
    res = run(pair, "create table memory.r as select * from tpch.region")
    assert res.rows == [(5,)] and res.update_type == "CREATE TABLE AS"
    res = run(pair, "insert into memory.r select * from tpch.region")
    assert res.rows == [(5,)] and res.update_type == "INSERT"
    assert run(pair, "select count(*), count(distinct r_name) "
                     "from memory.r").rows == [(10, 5)]
    assert run(pair, "show tables from memory").rows == [("r",)]
    with pytest.raises(ValueError):
        pair[0].execute("create table memory.r as select 1 x")
    run(pair, "drop table memory.r")
    assert run(pair, "show tables from memory").rows == []
    with pytest.raises(KeyError):
        pair[0].execute("drop table memory.r")
    with pytest.raises(ValueError, match="does not support writes"):
        pair[0].execute("create table tpch.x as select 1 y")


@pytest.mark.parametrize("q", [1, 3, 5, 18])
def test_explain_text_equals_the_reference(pair, q):
    port, ref = pair
    sql = PQ.TPCH_SQL[q]
    got = [r[0] for r in port.execute("explain " + sql).rows]
    assert "\n".join(got) == ref_explain_text(ref.plan(sql))


def test_unported_statements_raise(pair):
    # every statement is ported now: EXPLAIN ANALYZE is held against the
    # reference in tests/test_torch_explain_analyze.py, and the system
    # catalog here (and in tests/test_torch_system_catalog.py)
    assert run(pair, "show tables from system").rows == [
        ("catalogs",), ("tables",), ("columns",), ("session_properties",),
        ("functions",)]


ROWS = [(i, None if i % 4 == 0 else i * 7 - 50, f"s{i % 9}"
         if i % 6 else None, i % 3 == 0, 1.5 * i, 12345 * i - 100,
         (1 << 70) + i if i % 5 else None, 19000 + i,
         (i, i + 1) if i % 2 else ()) for i in range(70)]
COLS = ["k", "v", "s", "b", "f", "d", "ld", "dt", "arr"]


def _types(TT):
    return [TT.BIGINT, TT.INTEGER, TT.VARCHAR, TT.BOOLEAN, TT.DOUBLE,
            TT.DecimalType(12, 2), TT.DecimalType(30, 2), TT.DATE,
            TT.ArrayType(TT.BIGINT)]


def _same_page(got, want):
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    for g, w in zip(got.blocks, want.blocks):
        gd = g.data if isinstance(g.data, tuple) else (g.data,)
        wd = w.data if isinstance(w.data, tuple) else (w.data,)
        assert len(gd) == len(wd)
        for a, b in zip(gd, wd):
            assert a.numpy().dtype == np.asarray(b).dtype
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert (g.nulls is None) == (w.nulls is None)
        if g.nulls is not None:
            assert np.array_equal(g.nulls.numpy(), np.asarray(w.nulls))
        assert (g.dictionary is None) == (w.dictionary is None)
        if g.dictionary is not None:
            assert list(g.dictionary.values) == list(w.dictionary.values)


@pytest.mark.parametrize("path", ["rows", "pages"])
def test_memory_pages_and_pruning_equal_the_reference(path):
    mem, ref = MemoryConnector(device="cpu"), RefMemory()
    ref.create_table("m", COLS, _types(RT), ROWS)
    if path == "rows":
        mem.create_table("m", COLS, _types(T), ROWS[:40])
        mem.insert("m", ROWS[40:])
    else:
        # the result-page write path: the rows as pages of another table
        src = MemoryConnector(device="cpu")
        src.create_table("src", COLS, _types(T), ROWS)
        pages = [src.page_for_split(Split("src", s, 16))
                 for s in range(0, 64, 16)] + [
            src.page_for_split(Split("src", 64, 6))]
        mem.create_table_pages("m", COLS, _types(T), pages[:2])
        mem.insert_pages("m", pages[2:])
    assert mem.row_count("m") == ref.row_count("m") == 70
    for start, n in [(0, 70), (0, 13), (13, 20), (33, 37), (68, 2)]:
        _same_page(mem.page_for_split(Split("m", start, n)),
                   ref.page_for_split(RSplit("m", start, n)))
        _same_page(mem.page_for_split(Split("m", start, n), ["s", "k"]),
                   ref.page_for_split(RSplit("m", start, n), ["s", "k"]))
    splits = [(s, min(10, 70 - s)) for s in range(0, 70, 10)]
    for constraint in ([("k", 25, 31)], [("v", None, -40)],
                       [("dt", 19065, None)], [("d", 0, 100000)],
                       [("ld", 0, 10)], [("k", 0, 5), ("v", 100, None)]):
        got = mem.prune_splits("m", [Split("m", *s) for s in splits],
                               constraint)
        want = ref.prune_splits("m", [RSplit("m", *s) for s in splits],
                                constraint)
        assert [(s.start_row, s.row_count) for s in got] == \
            [(s.start_row, s.row_count) for s in want], constraint


def test_memory_connector_needs_a_device_or_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MemoryConnector()


def test_ctas_then_tpch_q1_q3_against_sqlite(tpch):
    """CREATE TABLE AS copies of TPC-H SF 0.01, then Q1 and Q3 over the
    copies: equal to sqlite over the generator's rows, and to the same
    queries over the generator."""
    conn = tpch[0]
    mem = MemoryConnector(device="cpu")
    r = LocalRunner({"tpch": conn, "memory": mem}, "memory",
                    session={"page_rows": 1 << 13}, device="cpu")
    for t in ("lineitem", "orders", "customer"):
        n = r.execute(f"create table {t} as select * from tpch.{t}").rows
        assert n == r.execute(f"select count(*) from tpch.{t}").rows
    db = PQ.load_sqlite(conn, ["lineitem", "orders", "customer"])
    on_tpch = LocalRunner({"tpch": conn}, session={"page_rows": 1 << 13},
                          device="cpu")
    for q in (1, 3):
        got = r.execute(PQ.TPCH_SQL[q]).rows
        oracle_sql, modes = PQ.TPCH_ORACLE[q]
        PQ.compare_tpch(q, got, db.execute(oracle_sql).fetchall(), modes)
        assert got == on_tpch.execute(PQ.TPCH_SQL[q]).rows


def test_ctas_carries_keys_and_q5_plans_as_over_tpch(tpch):
    """CREATE TABLE AS keeps the source's declared keys (DELETE keeps
    them, UPDATE of the key and INSERT drop them), so TPC-H Q5 over the
    memory copies plans as over tpch: without them it joins customer on
    c_nationkey before orders and fans out."""
    conn = tpch[0]
    mem = MemoryConnector(device="cpu")
    r = LocalRunner({"tpch": conn, "memory": mem}, "memory",
                    session={"page_rows": 1 << 13,
                             "generated_join_enabled": "false"},
                    device="cpu")
    for t in ("lineitem", "orders", "customer", "supplier", "nation",
              "region"):
        r.execute(f"create table {t} as select * from tpch.{t}")
        assert mem.unique_columns(t) == conn.unique_columns(t)
    on_tpch = LocalRunner({"tpch": conn}, session={"page_rows": 1 << 13,
                          "generated_join_enabled": "false"}, device="cpu")
    sql = PQ.TPCH_SQL[5]
    plan = [x for (x,) in r.execute("explain " + sql).rows]
    want = [x for (x,) in on_tpch.execute("explain " + sql).rows]
    assert plan == [x.replace("tpch.", "memory.") for x in want]
    assert r.execute(sql).rows == on_tpch.execute(sql).rows
    assert r.executor.capacity_boost_retries == 0
    r.execute("delete from orders where o_orderdate < date '1993-01-01'")
    assert mem.unique_columns("orders") == {"o_orderkey"}
    r.execute("update orders set o_orderkey = o_orderkey + 1 "
              "where o_custkey = 1")
    assert mem.unique_columns("orders") == frozenset()
    r.execute("insert into customer select * from tpch.customer "
              "where c_custkey = 1")
    assert mem.unique_columns("customer") == frozenset()
    # a table written from rows declares none, as in the reference
    mem.create_table("k", ["x"], [T.BIGINT], [(1,), (2,)])
    assert mem.unique_columns("k") == RefMemory().unique_columns("k")
