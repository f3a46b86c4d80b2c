"""The presto_tpu_torch TPC-H generator against presto_tpu's: every column
of all 8 tables bit-identical at SF 0.005 (so one sqlite oracle serves
both engines), plus the cardinality and consistency invariants of
tests/test_tpch_gen.py on the port's own pages."""

import numpy as np
import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu_torch.connectors.tpch import (
    CURRENTDATE,
    MAX_LINES_PER_ORDER,
    ORDERDATE_MAX,
    STARTDATE,
    TpchConnector,
)
from presto_tpu_torch.ops.compact import concat_all


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once, and torch's default of one thread per core spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SF = 0.005
TABLES = ("region", "nation", "part", "supplier", "partsupp", "customer",
          "orders", "lineitem")


@pytest.fixture(scope="module")
def conn():
    return TpchConnector(SF, device="cpu")


@pytest.fixture(scope="module")
def ref():
    return RefConnector(SF)


def _host(conn, table, cols=None, target_rows=1 << 20):
    pages = list(conn.pages(table, columns=cols, target_rows=target_rows))
    page = concat_all(pages)
    valid = page.valid.numpy()
    names = cols or conn.table_schema(table).column_names()
    return {name: blk.data.numpy()[valid]
            for name, blk in zip(names, page.blocks)}


@pytest.mark.parametrize("table", TABLES)
def test_columns_bit_identical_to_reference(conn, ref, table):
    assert conn.row_count(table) == ref.row_count(table)
    assert [str(c.type) for c in conn.table_schema(table).columns] == \
        [str(c.type) for c in ref.table_schema(table).columns]
    # a split size that is neither a power of two nor 7-aligned exercises
    # ladder padding and chunk boundaries
    pages = list(conn.pages(table, target_rows=5000))
    rpages = list(ref.pages(table, target_rows=5000))
    assert len(pages) == len(rpages)
    for p, r in zip(pages, rpages):
        np.testing.assert_array_equal(p.valid.numpy(), np.asarray(r.valid))
        for name, pb, rb in zip(conn.table_schema(table).column_names(),
                                p.blocks, r.blocks):
            np.testing.assert_array_equal(
                pb.data.numpy(), np.asarray(rb.data), err_msg=name)
            assert pb.data.numpy().dtype == np.asarray(rb.data).dtype, name
            assert (pb.dictionary is None) == (rb.dictionary is None)
            if pb.dictionary is not None:
                assert len(pb.dictionary) == len(rb.dictionary)
                codes = np.arange(min(len(pb.dictionary), 64))
                assert list(pb.dictionary.decode(codes)) == \
                    list(rb.dictionary.decode(codes)), name


def test_decoded_rows_equal_reference(conn, ref):
    for table in ("nation", "supplier", "orders"):
        assert conn.host_rows(table) == ref.host_rows(table), table


def test_cardinalities(conn):
    assert conn.n_customer == 750
    assert conn.n_orders == 7500
    assert conn.row_count("lineitem") == 7500 * MAX_LINES_PER_ORDER


def test_orderkeys_sparse_and_unique(conn):
    ok = _host(conn, "orders", ["o_orderkey"])["o_orderkey"]
    assert len(np.unique(ok)) == len(ok) == 7500
    assert np.all((ok - 1) % 32 < 8)


def test_custkey_skips_multiples_of_three(conn):
    ck = _host(conn, "orders", ["o_custkey"])["o_custkey"]
    assert np.all(ck % 3 != 0)
    assert ck.min() >= 1 and ck.max() <= conn.n_customer


def test_lineitem_count_and_dates(conn):
    li = _host(conn, "lineitem", ["l_orderkey", "l_linenumber",
                                  "l_shipdate", "l_receiptdate"])
    n = len(li["l_orderkey"])
    assert 7500 <= n <= 7500 * MAX_LINES_PER_ORDER
    assert np.all(li["l_receiptdate"] > li["l_shipdate"])
    assert li["l_linenumber"].min() == 1
    assert li["l_linenumber"].max() <= MAX_LINES_PER_ORDER


def test_orderdate_window(conn):
    od = _host(conn, "orders", ["o_orderdate"])["o_orderdate"]
    assert od.min() >= STARTDATE and od.max() <= ORDERDATE_MAX


def test_chunking_invariance(conn):
    a = _host(conn, "orders", ["o_orderkey", "o_totalprice"])
    b = _host(conn, "orders", ["o_orderkey", "o_totalprice"],
              target_rows=997)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_totalprice_consistent_with_lineitems(conn):
    li = _host(conn, "lineitem",
               ["l_orderkey", "l_extendedprice", "l_discount", "l_tax"])
    o = _host(conn, "orders", ["o_orderkey", "o_totalprice"])
    charge = (li["l_extendedprice"].astype(object)
              * (100 - li["l_discount"]) * (100 + li["l_tax"])
              + 5000) // 10000
    sums = {}
    for k, c in zip(li["l_orderkey"], charge):
        sums[k] = sums.get(k, 0) + c
    expect = np.array([sums[k] for k in o["o_orderkey"]], dtype=np.int64)
    np.testing.assert_array_equal(o["o_totalprice"], expect)


def test_retailprice_and_returnflag_rules(conn):
    p = _host(conn, "part", ["p_partkey", "p_retailprice"])
    pk = p["p_partkey"]
    np.testing.assert_array_equal(
        p["p_retailprice"], 90000 + (pk // 10) % 20001 + 100 * (pk % 1000))
    pages = list(conn.pages("lineitem", ["l_returnflag", "l_linestatus",
                                         "l_shipdate", "l_receiptdate"]))
    for rf, ls, ship, receipt in concat_all(pages).to_pylist()[:5000]:
        assert rf in (("A", "R") if receipt <= CURRENTDATE else ("N",))
        assert ls == ("O" if ship > CURRENTDATE else "F")


def test_nation_region_fixed(conn):
    n = list(conn.pages("nation"))[0].to_pylist()
    assert len(n) == 25
    assert n[0][1] == "ALGERIA" and n[24][1] == "UNITED STATES"
    r = list(conn.pages("region"))[0].to_pylist()
    assert [row[1] for row in r] == [
        "AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]


def test_device_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        assert TpchConnector(0.001).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TpchConnector(0.001)
