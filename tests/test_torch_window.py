"""Window functions: presto_tpu_torch against presto_tpu.

Module level: ``ops/window.window_page`` of both engines on the same
seeded pages (numpy), with NULL partition keys, NULL order keys and
NULL arguments, ties, invalid rows, partitions whose arguments are all
NULL, and every frame kind the planner admits (the SQL defaults with and
without ORDER BY, ROWS frames with each bound kind, RANGE frames);
integer results equal, doubles to 9 significant digits. The torch
scans that replace ``lax.associative_scan`` (the segmented doubling
scan, the sparse table) are held against a direct per-row loop on
random segments.

Query level: the counterparts of tests/test_window.py at its scale
(TPC-H SF 0.005), against the reference engine and sqlite."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.ops import window as RW
from presto_tpu.ops.sort import SortKey as RSortKey
from presto_tpu.page import Page as RPage
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import queries as PQ
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.ops import window as W
from presto_tpu_torch.ops.sort import SortKey
from presto_tpu_torch.page import Page
from presto_tpu_torch.runner import LocalRunner
from tests.oracle import load_sqlite
from tests.test_window import CASES

SF = 0.005
PAGE_ROWS = 1 << 13


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ module level
def _columns(rng, n):
    """Partition key (BIGINT, NULLs), order key (INTEGER, ties, NULLs),
    then the argument columns: BIGINT, DOUBLE, VARCHAR, DECIMAL(12,2),
    with NULLs; partition 3's BIGINT and DOUBLE arguments are all NULL."""
    part = rng.integers(0, 6, n)
    part_l = [None if rng.random() < 0.08 else int(v) for v in part]
    order = [None if rng.random() < 0.1 else int(v)
             for v in rng.integers(0, 9, n)]
    big = [None if (rng.random() < 0.15 or p == 3) else int(v)
           for v, p in zip(rng.integers(-50, 50, n), part_l)]
    dbl = [None if (rng.random() < 0.15 or p == 3) else float(v)
           for v, p in zip(rng.normal(0, 100, n), part_l)]
    words = ["ash", "birch", "cedar", "elm", "fir", "oak", "yew"]
    txt = [None if rng.random() < 0.1 else words[v]
           for v in rng.integers(0, len(words), n)]
    dec = [None if rng.random() < 0.1 else int(v)
           for v in rng.integers(-10 ** 6, 10 ** 6, n)]
    cols = [part_l, order, big, dbl, txt, dec]
    types = ["bigint", "integer", "bigint", "double", "varchar",
             "decimal(12,2)"]
    return cols, types


def _pages(seed, n):
    rng = np.random.default_rng(seed)
    cols, names = _columns(rng, n)
    valid = rng.random(n) < 0.85
    ref = RPage.from_arrays(cols, [RT.parse_type(t) for t in names])
    port = Page.from_arrays(cols, [T.parse_type(t) for t in names],
                            device="cpu")
    cap = port.capacity
    mask = np.zeros(cap, bool)
    mask[:n] = valid
    return (RPage(blocks=ref.blocks, valid=jnp.asarray(mask)),
            Page(blocks=port.blocks, valid=torch.from_numpy(mask)), mask)


ROWS = "rows"
FRAMES = {
    "default": None,
    "rows_2p_cur": (ROWS, ("preceding", 2), ("current", None)),
    "rows_1p_1f": (ROWS, ("preceding", 1), ("following", 1)),
    "rows_3p_1p": (ROWS, ("preceding", 3), ("preceding", 1)),
    "rows_cur_uf": (ROWS, ("current", None), ("unbounded_following", None)),
    "rows_up_uf": (ROWS, ("unbounded_preceding", None),
                   ("unbounded_following", None)),
    "rows_1f_3f": (ROWS, ("following", 1), ("following", 3)),
    "range_up_cur": ("range", ("unbounded_preceding", None),
                     ("current", None)),
    "range_cur_uf": ("range", ("current", None),
                     ("unbounded_following", None)),
    "range_up_uf": ("range", ("unbounded_preceding", None),
                    ("unbounded_following", None)),
}

# (function, argument channel, offset)
RANKING = [("row_number", None, 1), ("rank", None, 1),
           ("dense_rank", None, 1), ("ntile", None, 3), ("ntile", None, 7),
           ("percent_rank", None, 1), ("cume_dist", None, 1)]
FRAMED = [("sum", 2, 1), ("sum", 3, 1), ("sum", 5, 1), ("avg", 2, 1),
          ("avg", 3, 1), ("avg", 5, 1), ("count", 3, 1),
          ("count_star", None, 1), ("min", 2, 1), ("max", 3, 1),
          ("min", 4, 1), ("max", 4, 1), ("max", 5, 1),
          ("first_value", 4, 1), ("last_value", 3, 1),
          ("nth_value", 2, 2), ("nth_value", 5, 3)]
NAV = [("lag", 2, 1), ("lead", 3, 2), ("lag", 4, 3), ("lead", 5, 1)]

# (partition channels, order keys as (channel, ascending, nulls_first))
OVER = {
    "part_order": ((0,), ((1, True, None),)),
    "part_order_desc": ((0,), ((1, False, True), (2, True, None))),
    "part_only": ((0,), ()),
    "order_only": ((), ((1, True, False),)),
    "two_part_keys": ((0, 4), ((1, True, None),)),
}


def _functions(frame_name):
    frame = FRAMES[frame_name]
    fns = [(f, ch, off, frame) for f, ch, off in FRAMED]
    if frame_name == "default":
        fns += [(f, ch, off, None) for f, ch, off in RANKING + NAV]
    return fns


def _assert_blocks_equal(rb, pb, mask, what):
    rnull = (np.zeros(mask.shape, bool) if rb.nulls is None
             else np.asarray(rb.nulls))
    pnull = (np.zeros(mask.shape, bool) if pb.nulls is None
             else pb.nulls.numpy())
    np.testing.assert_array_equal(rnull[mask], pnull[mask], err_msg=what)
    live = mask & ~rnull
    rd = np.asarray(rb.data)[live]
    pd = pb.data.numpy()[live]
    if rb.dictionary is not None:
        rd = rb.dictionary.decode(rd)
        pd = pb.dictionary.decode(pd)
        assert list(rd) == list(pd), what
    elif np.issubdtype(rd.dtype, np.floating):
        np.testing.assert_allclose(pd, rd, rtol=1e-9, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(pd.astype(np.int64),
                                      rd.astype(np.int64), err_msg=what)


# explicit frames need an ORDER BY (the planner's rule)
WINDOW_PAGE_CASES = [(o, f) for o in sorted(OVER) for f in sorted(FRAMES)
                     if OVER[o][1] or f == "default"]


@pytest.mark.parametrize("over,frame_name", WINDOW_PAGE_CASES)
def test_window_page_matches_reference(over, frame_name):
    parts, okeys = OVER[over]
    seed = sum(map(ord, over + frame_name))
    ref_page, page, mask = _pages(seed, 181)
    fns = _functions(frame_name)
    src_r = [ref_page.block(c).type for c in range(6)]
    src_p = [page.block(c).type for c in range(6)]
    rfns = tuple(RW.WindowFunc(f, ch, off, frame=fr)
                 for f, ch, off, fr in fns)
    pfns = tuple(W.WindowFunc(f, ch, off, frame=fr)
                 for f, ch, off, fr in fns)
    rtypes = tuple(RW.result_type(fn, None if fn.arg_channel is None
                                  else src_r[fn.arg_channel])
                   for fn in rfns)
    ptypes = tuple(W.result_type(fn, None if fn.arg_channel is None
                                 else src_p[fn.arg_channel])
                   for fn in pfns)
    assert [t.display() for t in rtypes] == [t.display() for t in ptypes]
    rkeys = tuple(RSortKey(c, a, nf) for c, a, nf in okeys)
    pkeys = tuple(SortKey(c, a, nf) for c, a, nf in okeys)
    rout = RW.window_page(parts, rkeys, rfns, rtypes, ref_page)
    pout = W.window_page(parts, pkeys, pfns, ptypes, page)
    assert len(pout.blocks) == len(rout.blocks) == 6 + len(fns)
    for i, fn in enumerate(fns):
        _assert_blocks_equal(rout.block(6 + i), pout.block(6 + i), mask,
                             f"{over}/{frame_name}/{fn}")


@pytest.mark.parametrize("seed", range(4))
def test_torch_scans_match_a_direct_loop(seed):
    """The segmented doubling scan (prefix MIN/MAX) and the sparse table
    (sliding MIN/MAX) against a per-row loop on random segments."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    starts = np.sort(rng.choice(n, size=int(rng.integers(1, n + 1)),
                                replace=False))
    starts[0] = 0
    seg_start = np.zeros(n, np.int64)
    for s in starts:
        seg_start[s:] = s
    vals = rng.integers(-1000, 1000, n)
    got = W._segmented_scan(torch.minimum, torch.from_numpy(vals),
                            torch.from_numpy(seg_start)).numpy()
    want = [vals[seg_start[i]:i + 1].min() for i in range(n)]
    np.testing.assert_array_equal(got, want)
    fs = rng.integers(0, n, n)
    fe = np.minimum(fs + rng.integers(0, 40, n), n - 1)
    got = W._range_query(torch.maximum, torch.from_numpy(vals),
                         torch.from_numpy(fs), torch.from_numpy(fe),
                         torch.iinfo(torch.int64).min).numpy()
    want = [vals[a:b + 1].max() for a, b in zip(fs, fe)]
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- query level
@pytest.fixture(scope="module")
def ref_conn():
    return RefConnector(SF)


@pytest.fixture(scope="module")
def db(ref_conn):
    return load_sqlite(ref_conn, ["nation", "orders", "customer"])


@pytest.fixture(scope="module")
def port():
    return LocalRunner({"tpch": TpchConnector(SF, device="cpu")},
                       session={"page_rows": PAGE_ROWS}, device="cpu")


@pytest.fixture(scope="module")
def reference(ref_conn):
    return RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS)


def _same_rows(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert math.isclose(a, b, rel_tol=1e-9), (i, g, w)
            else:
                assert a == b, (i, g, w)


def test_chip_query_texts_are_the_suites():
    """chip_smoke.py runs presto_tpu_torch/queries.py's copy of the
    window cases (it may not import the test suite)."""
    assert PQ.WINDOW_SQL[:len(CASES)] == tuple(CASES)
    assert len(PQ.WINDOW_SQL) == len(CASES) + 2


@pytest.mark.parametrize("case", range(len(CASES)))
def test_window_vs_reference_and_sqlite(case, port, reference, db):
    sql = CASES[case]
    got = port.execute(sql).rows
    _same_rows(got, [tuple(r) for r in db.execute(sql).fetchall()])
    _same_rows(got, reference.execute(sql).rows)


@pytest.mark.parametrize("sql", PQ.WINDOW_SQL[len(CASES):])
def test_window_subqueries(sql, port, reference, db):
    """A filter over a window, and a window over an aggregate."""
    got = port.execute(sql).rows
    assert got == [tuple(r) for r in db.execute(sql).fetchall()]
    assert got == reference.execute(sql).rows


def test_window_with_aggregate_same_block_raises(port):
    with pytest.raises(Exception):
        port.execute("select rank() over (order by sum(n_nationkey)) "
                     "from nation group by n_regionkey")
