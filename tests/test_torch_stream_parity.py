"""The streaming plane, part 3: page-level parity with presto_tpu and
TPC-H Q1 as a maintained view.

  - ``scan_from`` and a pinned window's pages equal the reference's for
    the same rows: codes, first-seen dictionaries, NULL masks, the
    validity mask and the capacity;
  - the port's runner writes a stream from result pages (CTAS, INSERT);
    the log it builds equals the one the reference's runner builds from
    Python rows, dictionaries included;
  - TPC-H Q1 over a lineitem SF 0.01 stream (90% seeded, then three 1%
    appends) registered as a view: after each append the refreshed rows
    and the five streaming counters equal the reference's, the rows
    scanned equal the rows appended, and the rows equal a cold
    recompute; the delta fold's partial step reaches K1 (its plain twin
    here) and, with the kernels off, does not;
  - a pinned window never looks like a generator to the fusion gate: a
    refresh under forced fusion launches no program.

Doubles compare to 9 significant digits (tests/test_dist.py's rule),
everything else exactly.
"""

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.stream import StreamConnector as RefStream
from presto_tpu.connectors.stream import (
    StreamWindowConnector as RefWindow,
)
from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu.streaming import ivm as RIVM
from presto_tpu_torch import cuda
from presto_tpu_torch import queries as PQ
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.stream import (
    StreamConnector,
    StreamWindowConnector,
)
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.streaming import ivm as IVM

SF = 0.01
PAGE_ROWS = 1 << 13
COUNTERS = ("ivm_refreshes", "ivm_full_recomputes", "delta_pages_folded",
            "cursor_polls", "stream_appends_seen")
COLUMNS = ("l_orderkey, l_linenumber, l_quantity, l_extendedprice, "
           "l_discount, l_tax, l_returnflag, l_linestatus, l_shipdate")
# SF 0.01's order keys run to 60,000: 90% seeded, then 1% per append
SEED_KEY = 54_000
STEP = 600
APPENDS = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _same_page(got, want):
    """Block by block: data, NULL mask, dictionary; then validity."""
    assert got.capacity == want.capacity
    assert np.array_equal(_host(got.valid), _host(want.valid))
    assert len(got.blocks) == len(want.blocks)
    for g, w in zip(got.blocks, want.blocks):
        if isinstance(w.data, tuple):
            assert all(np.array_equal(_host(a), _host(b))
                       for a, b in zip(g.data, w.data))
        else:
            assert np.array_equal(_host(g.data), _host(w.data))
        assert (g.nulls is None) == (w.nulls is None)
        if w.nulls is not None:
            assert np.array_equal(_host(g.nulls), _host(w.nulls))
        assert (g.dictionary is None) == (w.dictionary is None)
        if w.dictionary is not None:
            assert list(g.dictionary.values) == list(w.dictionary.values)


def _rows_close(a, b, rel=1e-9):
    assert len(a) == len(b), f"{len(a)} vs {len(b)} rows"
    for ra, rb in zip(a, b):
        for va, vb in zip(ra, rb):
            if isinstance(va, float) or isinstance(vb, float):
                assert abs(float(va) - float(vb)) <= rel * max(
                    1.0, abs(float(vb))), (va, vb)
            else:
                assert va == vb, (va, vb)


WIDE = (("k", T.BIGINT, RT.BIGINT), ("s", T.VARCHAR, RT.VARCHAR),
        ("d", T.DecimalType(12, 2), RT.DecimalType(12, 2)),
        ("big", T.DecimalType(30, 2), RT.DecimalType(30, 2)),
        ("day", T.DATE, RT.DATE), ("b", T.BOOLEAN, RT.BOOLEAN),
        ("x", T.DOUBLE, RT.DOUBLE))


def _wide_rows(start, n):
    """Seeded rows with NULLs in every column, strings first seen out
    of sorted order, and decimals past 64 bits."""
    rng = np.random.default_rng(start)
    out = []
    for i in range(start, start + n):
        r = (int(rng.integers(-50, 50)), f"s{int(rng.integers(0, 9))}",
             int(rng.integers(-10 ** 9, 10 ** 9)),
             int(rng.integers(-10 ** 9, 10 ** 9)) * 10 ** 18,
             int(rng.integers(0, 20000)), bool(rng.integers(0, 2)),
             float(rng.normal()))
        out.append(tuple(None if (i + j) % 7 == 0 else v
                         for j, v in enumerate(r)))
    return out


def test_delta_and_window_pages_equal_the_reference():
    port = StreamConnector(device="cpu")
    ref = RefStream()
    names = [c[0] for c in WIDE]
    port.create_table("w", names, [c[1] for c in WIDE], _wide_rows(0, 37))
    ref.create_table("w", names, [c[2] for c in WIDE], _wide_rows(0, 37))
    for start, n in ((37, 20), (57, 1), (58, 45)):
        assert port.append("w", _wide_rows(start, n)) == \
            ref.append("w", _wide_rows(start, n))
    for offset, cols, target in ((37, None, 1 << 20), (10, ("s", "big"), 16),
                                 (0, ("x", "k", "day"), 8), (103, None, 8)):
        got = list(port.scan_from("w", offset, cols, target))
        want = list(ref.scan_from("w", offset, cols, target))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_page(g, w)
    assert port.host_rows("w") == ref.host_rows("w")
    wins = (StreamWindowConnector(port, "w", 20, 90),
            RefWindow(ref, "w", 20, 90))
    port.append("w", _wide_rows(103, 5))
    ref.append("w", _wide_rows(103, 5))
    got = list(wins[0].pages("w", ("s", "d", "b"), target_rows=32))
    want = list(wins[1].pages("w", ("s", "d", "b"), target_rows=32))
    assert [p.capacity for p in got] == [32, 32, 8]
    for g, w in zip(got, want):
        _same_page(g, w)
    assert wins[0].host_rows("w") == wins[1].host_rows("w")


@pytest.fixture(scope="module")
def q1_pair():
    """Both engines' runners over tpch SF 0.01 and a stream catalog,
    the stream seeded with lineitem's first 90% by CREATE TABLE AS."""
    port = LocalRunner({"tpch": TpchConnector(SF, device="cpu"),
                        "stream": StreamConnector(device="cpu")},
                       default_catalog="stream",
                       session={"page_rows": PAGE_ROWS}, device="cpu")
    ref = RefRunner({"tpch": RefTpch(SF), "stream": RefStream()},
                    default_catalog="stream", page_rows=PAGE_ROWS)
    ref.session.set("pallas_join_enabled", "false")
    ctas = (f"create table stream.lineitem as select {COLUMNS} from "
            f"tpch.lineitem where l_orderkey <= {SEED_KEY}")
    assert port.execute(ctas).rows == ref.execute(ctas).rows
    return port, ref


def _insert(runner, i):
    lo = SEED_KEY + STEP * i
    return runner.execute(
        f"insert into stream.lineitem select {COLUMNS} from tpch.lineitem "
        f"where l_orderkey > {lo} and l_orderkey <= {lo + STEP}"
    ).rows[0][0]


def test_q1_view_refreshes_equal_the_reference(q1_pair):
    port, ref = q1_pair
    sql = PQ.TPCH_SQL[1]
    views = (IVM.IvmRegistry().register(port, "q1", sql),
             RIVM.IvmRegistry().register(ref, "q1", sql))
    assert views[0].ivm_safe and views[1].ivm_safe
    for i in range(APPENDS + 1):
        appended = None
        if i:
            appended = _insert(port, i - 1)
            assert _insert(ref, i - 1) == appended > 0
        cuda.reset_counts()
        got = IVM.refresh(views[0], session=port.session,
                          sink=port.executor)
        k1 = cuda.plain_calls["segsum"]
        want = RIVM.refresh(views[1], session=ref.session,
                            sink=ref.executor)
        assert got[0] == want[0] and got[2] == want[2]
        _rows_close(got[1], want[1])
        assert {n: getattr(port.executor, n) for n in COUNTERS} == \
            {n: getattr(ref.executor, n) for n in COUNTERS}
        assert views[0].last_delta_rows == views[1].last_delta_rows
        if appended is not None:
            assert views[0].last_delta_rows == appended
        assert k1 > 0  # the delta fold's partial step reaches K1
        cold = port.execute(sql).rows
        assert cold == got[1]  # integers and decimals: bit for bit
    assert port.executor.ivm_refreshes == APPENDS + 1
    assert port.executor.stream_appends_seen == APPENDS
    # the log the page writes built equals the reference's row-built log
    pconn, rconn = port.catalogs["stream"], ref.catalogs["stream"]
    assert pconn.offset("lineitem") == rconn.offset("lineitem")
    for g, w in zip(pconn.scan_from("lineitem", 0, None, 1 << 14),
                    rconn.scan_from("lineitem", 0, None, 1 << 14)):
        _same_page(g, w)
    # ivm_enabled off: the view recomputes in full, counted loudly
    port.session.set("ivm_enabled", False)
    try:
        full = IVM.refresh(views[0], session=port.session,
                           sink=port.executor)
    finally:
        port.session.unset("ivm_enabled")
    assert port.executor.ivm_full_recomputes == 1
    assert full[1] == got[1]


def test_window_never_fuses_and_kernels_off_reach_no_k1(q1_pair):
    port, _ref = q1_pair
    sql = ("select l_returnflag, count(*), sum(l_quantity) from lineitem "
           "group by l_returnflag order by l_returnflag")
    view = IVM.IvmRegistry().register(port, "fusion", sql)
    ex = view.executor
    # forced fusion and split batching on the view's executor: the
    # pinned window is a staged page stream, never a generator
    ex.agg_fusion, ex.split_batch, ex.kernels = "true", 64, False
    assert ex._fused_stream(view.agg.source) is None
    assert view.window.gen_body("lineitem", 8, ("l_returnflag",)) is None
    cuda.reset_counts()
    _n, rows, _t = IVM.refresh(view, session=port.session,
                               sink=port.executor)
    assert ex.program_launches == 0 and ex.fused_partial_aggs == 0
    assert cuda.plain_calls["segsum"] == 0  # kernels off: no K1
    assert rows == port.execute(sql).rows
