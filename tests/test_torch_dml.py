"""DELETE / UPDATE over the port's memory connector: presto_tpu_torch
against presto_tpu.

Every in-process case of tests/test_dml.py runs on both engines from
the same tables: the statement results, the rows after and the errors
equal the reference engine's and the reference test's expected values.
Also: the stored tables' pages equal the reference's page for page
after each DML (codes, dictionaries, NULL masks), and snapshot_version
moves on an UPDATE that keeps the row count. The reference's
``test_dml_over_the_wire`` needs the HTTP coordinator, which the port
does not have (ROADMAP queue 4)."""

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.base import Split as RSplit
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.base import Split
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.runner import LocalRunner

T_ROWS = [(i, i * 100, 19000 + i) for i in range(100)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """One port runner and one reference runner over equal tables."""

    def __init__(self):
        self.mem = MemoryConnector(device="cpu")
        self.ref_mem = RefMemory()
        self.port = LocalRunner({"memory": self.mem}, "memory",
                                session={"page_rows": 1 << 8}, device="cpu")
        self.ref = RefRunner({"memory": self.ref_mem},
                             default_catalog="memory", page_rows=1 << 8)

    def table(self, name, cols, types, rows):
        self.mem.create_table(name, cols, [getattr(T, t) if isinstance(
            t, str) else t[0] for t in types], rows)
        self.ref_mem.create_table(name, cols, [getattr(RT, t) if isinstance(
            t, str) else t[1] for t in types], rows)

    def run(self, sql):
        got = self.port.execute(sql)
        want = self.ref.execute(sql)
        assert (got.rows, got.update_type) == (want.rows, want.update_type), \
            sql
        return got

    def raises(self, sql, exc=ValueError):
        with pytest.raises(exc):
            self.ref.execute(sql)
        with pytest.raises(exc):
            self.port.execute(sql)

    def same_pages(self, table):
        """The stored table's pages equal the reference's, split by split."""
        n = self.mem.row_count(table)
        assert n == self.ref_mem.row_count(table)
        for start in range(0, max(n, 1), 37):
            cnt = min(37, n - start)
            got = self.mem.page_for_split(Split(table, start, cnt))
            want = self.ref_mem.page_for_split(RSplit(table, start, cnt))
            assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
            for g, w in zip(got.blocks, want.blocks):
                gd = g.data if isinstance(g.data, tuple) else (g.data,)
                wd = w.data if isinstance(w.data, tuple) else (w.data,)
                for a, b in zip(gd, wd):
                    assert np.array_equal(a.numpy(), np.asarray(b))
                assert (g.nulls is None) == (w.nulls is None)
                if g.nulls is not None:
                    assert np.array_equal(g.nulls.numpy(),
                                          np.asarray(w.nulls))
                assert (g.dictionary is None) == (w.dictionary is None)
                if g.dictionary is not None:
                    assert list(g.dictionary.values) == \
                        list(w.dictionary.values)


@pytest.fixture()
def pair():
    p = Pair()
    p.table("t", ["k", "v", "d"],
            ["BIGINT", (T.DecimalType(10, 2), RT.DecimalType(10, 2)),
             "DATE"], T_ROWS)
    return p


def test_delete_where(pair):
    res = pair.run("delete from t where k >= 90")
    assert res.update_type == "DELETE" and res.rows == [(10,)]
    assert pair.run("select count(*) from t").rows == [(90,)]
    assert pair.run("select sum(v) from t where k < 2").rows == [(100,)]
    pair.same_pages("t")


def test_delete_null_predicate_keeps_row(pair):
    pair.table("n", ["x"], ["BIGINT"], [(1,), (None,), (3,)])
    res = pair.run("delete from n where x > 1")
    assert res.rows == [(1,)]
    got = sorted(r[0] for r in pair.run("select x from n").rows
                 if r[0] is not None)
    assert got == [1]
    assert pair.run("select count(*) from n").rows == [(2,)]
    pair.same_pages("n")


def test_update_guarded_and_cast(pair):
    res = pair.run("update t set v = v * 2 where k < 10")
    assert res.update_type == "UPDATE" and res.rows == [(10,)]
    exp = sum(i * 100 for i in range(100)) + sum(i * 100 for i in range(10))
    assert pair.run("select sum(v) from t").rows[0][0] == exp
    pair.run("update t set v = 7 where k = 3")
    assert pair.run("select v from t where k = 3").rows == [(700,)]
    pair.same_pages("t")


def test_update_all_rows_and_date(pair):
    assert pair.run("update t set d = date '2020-01-01'").rows == [(100,)]
    assert pair.run("select min(d), max(d) from t").rows == \
        [(18262, 18262)]


def test_update_unknown_column(pair):
    pair.raises("update t set nope = 1")


def test_delete_all(pair):
    assert pair.run("delete from t").rows == [(100,)]
    assert pair.run("select count(*) from t").rows == [(0,)]


def test_quoted_mixed_case_identifiers():
    p = Pair()
    p.table("T", ["Col"], ["BIGINT"], [(i,) for i in range(4)])
    p.table("t", ["x"], ["BIGINT"], [(9,)] * 7)
    assert p.run('delete from memory."T" where "Col" >= 2').rows == [(2,)]
    assert p.run('select count(*) from "T"').rows == [(2,)]
    assert p.run("select count(*) from t").rows == [(7,)]
    assert p.run('update "T" set "Col" = 100').rows == [(2,)]
    assert sorted(x[0] for x in p.run('select "Col" from "T"').rows) == \
        [100, 100]


def test_subquery_predicate_rejected_clearly(pair):
    pair.raises("delete from t where k in (select k from t where k < 3)")


def test_missing_table_and_duplicate_assignment(pair):
    pair.raises("delete from nosuch")
    pair.raises("update t set v = 1, v = 2")


def test_update_same_cardinality_moves_snapshot(pair):
    before = pair.mem.snapshot_version("t")
    pair.run("update t set v = v + 1 where k = 5")
    after = pair.mem.snapshot_version("t")
    assert before != after
    assert before.split(":")[1] == after.split(":")[1]  # same row count
    assert (before, after) == (pair.ref_mem.snapshot_version("t")
                               .replace("w2", "w1"),
                               pair.ref_mem.snapshot_version("t"))


def test_update_strings_and_nulls():
    """A dictionary column through UPDATE: the rewritten table's sorted
    dictionary, codes and NULL mask equal the reference's."""
    p = Pair()
    rows = [(i, None if i % 5 == 0 else f"s{i % 7}") for i in range(60)]
    p.table("s", ["k", "v"], ["BIGINT", "VARCHAR"], rows)
    assert p.run("update s set v = 'zz' where k % 3 = 0").rows == [(20,)]
    assert p.run("delete from s where v = 's2'").rows == [(6,)]
    p.same_pages("s")
    assert p.run("select v, count(*) from s group by v order by v").rows
