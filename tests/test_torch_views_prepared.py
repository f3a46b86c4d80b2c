"""Views and prepared statements on the port's runner: presto_tpu_torch
against presto_tpu.

Every in-process case of tests/test_views_prepared.py runs on both
engines over TPC-H SF 0.01 and a memory connector: CREATE / DROP VIEW
with analysis-time expansion (views see inserted rows), OR REPLACE,
duplicate and invalid definitions, PREPARE / EXECUTE / DEALLOCATE with
? parameters (queries and DML), per-user scoping and the errors; rows
equal the reference engine's. The reference's
``test_views_persist_on_concurrent_server`` needs the HTTP coordinator,
which the port does not have (ROADMAP queue 4)."""

import pytest
import torch

from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.runner import LocalRunner as RefRunner
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


class Pair:
    def __init__(self, tpch):
        self.port = LocalRunner(
            {"tpch": tpch[0], "memory": MemoryConnector(device="cpu")},
            session={"page_rows": 1 << 13}, device="cpu")
        self.ref = RefRunner({"tpch": tpch[1], "memory": RefMemory()},
                             page_rows=1 << 13)

    def run(self, sql):
        got = self.port.execute(sql)
        want = self.ref.execute(sql)
        assert (got.rows, got.update_type) == (want.rows, want.update_type), \
            sql
        return got.rows

    def raises(self, sql):
        with pytest.raises(Exception):
            self.ref.execute(sql)
        with pytest.raises(Exception):
            self.port.execute(sql)

    def user(self, name):
        self.port.session.user = name
        self.ref.session.user = name


@pytest.fixture()
def pair(tpch):
    return Pair(tpch)


def test_create_query_drop_view(pair):
    pair.run("create view big_nations as "
             "select n_regionkey, count(*) cnt from nation group by 1")
    got = pair.run("select * from big_nations order by n_regionkey")
    assert got == pair.run("select n_regionkey, count(*) from nation "
                           "group by 1 order by 1")
    assert len(pair.run("select r_name, cnt from region, big_nations "
                        "where r_regionkey = n_regionkey order by 1")) == 5
    pair.run("drop view big_nations")
    pair.raises("select * from big_nations")
    pair.raises("drop view big_nations")


def test_view_reflects_current_data(pair):
    pair.run("create table memory.t as select 1 as x union all select 2")
    pair.run("create view memory.v as select sum(x) s from memory.t")
    assert pair.run("select s from memory.v") == [(3,)]
    pair.run("insert into memory.t select 10")
    assert pair.run("select s from memory.v") == [(13,)]


def test_view_replace_duplicate_and_cycle(pair):
    pair.run("create view v1 as select 1 as x")
    pair.raises("create view v1 as select 2 as x")
    pair.run("create or replace view v1 as select 2 as x")
    assert pair.run("select x from v1") == [(2,)]
    pair.raises("create view bad as select no_such_col from nation")


def test_prepare_execute_deallocate(pair):
    pair.run("prepare q1 from select count(*), sum(o_totalprice) from "
             "orders where o_custkey < ? and o_orderpriority = ?")
    got = pair.run("execute q1 using 500, '1-URGENT'")
    assert got == pair.run(
        "select count(*), sum(o_totalprice) from orders "
        "where o_custkey < 500 and o_orderpriority = '1-URGENT'")
    got2 = pair.run("execute q1 using 100, '5-LOW'")
    assert got2 == pair.run(
        "select count(*), sum(o_totalprice) from orders "
        "where o_custkey < 100 and o_orderpriority = '5-LOW'")
    pair.run("deallocate prepare q1")
    pair.raises("execute q1 using 1, 'x'")


def test_execute_missing_or_unbound(pair):
    pair.raises("execute nope using 1")
    pair.run("prepare p2 from select ? + 1")
    pair.raises("execute p2")
    assert pair.run("execute p2 using 41") == [(42,)]


def test_prepared_statements_scoped_per_user(pair):
    pair.user("alice")
    pair.run("prepare mine from select 1")
    pair.user("bob")
    pair.raises("execute mine")
    pair.raises("deallocate prepare mine")
    pair.run("prepare mine from select 2")
    assert pair.run("execute mine") == [(2,)]
    pair.user("alice")
    assert pair.run("execute mine") == [(1,)]


def test_prepare_validates_statement(pair):
    pair.raises("prepare bad from select from from")


def test_prepared_dml_parameters(pair):
    pair.run("create table memory.pt as select 1 a, 'x' b "
             "union all select 2, 'y' union all select 3, 'z'")
    pair.run("prepare pd from delete from memory.pt where a = ?")
    pair.run("execute pd using 2")
    assert pair.run("select a, b from memory.pt order by 1") == \
        [(1, "x"), (3, "z")]
    pair.run("prepare pu from update memory.pt set b = ? where a = ?")
    pair.run("execute pu using 'it''s', 3")
    assert pair.run("select a, b from memory.pt order by 1") == \
        [(1, "x"), (3, "it's")]
    pair.raises("execute pd using 1, 2")
    pair.run("prepare pq from delete from memory.pt where b = '?'")
    pair.run("execute pq")
    assert len(pair.run("select a from memory.pt")) == 2


def test_projected_string_constants_decode(pair):
    assert pair.run("select 'x'") == [("x",)]
    assert sorted(pair.run("select 'x' union all select 'y'")) == \
        [("x",), ("y",)]
    assert pair.run("select cast('q' as varchar)") == [("q",)]
    pair.run("create table memory.sc as select 1 a, 'w' b")
    assert pair.run("select b from memory.sc") == [("w",)]


def test_prepared_query_over_a_view(pair):
    pair.run("create view cheap as select o_orderkey, o_totalprice "
             "from orders where o_totalprice < 2000")
    pair.run("prepare pv from select count(*) from cheap "
             "where o_orderkey < ?")
    assert pair.run("execute pv using 30000") == pair.run(
        "select count(*) from orders where o_totalprice < 2000 "
        "and o_orderkey < 30000")
