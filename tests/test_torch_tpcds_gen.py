"""The presto_tpu_torch TPC-DS generator against presto_tpu's: every
column of all 24 tables bit-identical at SF 0.01 over several splits (so
one sqlite oracle serves both engines); the closed-form key inverses,
the windowed inverses of the slot-structured fact tables and the
monotonic row bounds equal the reference's; ``gen_at`` at scattered rows
equals the scanned rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.connectors.tpcds import TpcdsConnector as RefConnector
from presto_tpu_torch.connectors.tpcds import MAX_LINES, TpcdsConnector

SF = 0.01
# neither a power of two nor 11-aligned: ladder padding, ticket-aligned
# split rounding and chunk boundaries all move
TARGET_ROWS = 20_000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test files at once, one per worker process:
    one intra-op thread per process keeps the port's CPU runs from
    oversubscribing the cores (measured: 10-40x slower with 6 workers at
    the default thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def conn():
    return TpcdsConnector(SF, device="cpu")


@pytest.fixture(scope="module")
def ref():
    return RefConnector(SF)


TABLES = sorted(RefConnector(SF).tables())


def test_all_24_tables(conn, ref):
    assert len(TABLES) == 24
    assert sorted(conn.tables()) == TABLES


@pytest.mark.parametrize("table", TABLES)
def test_columns_bit_identical_to_reference(conn, ref, table):
    assert conn.row_count(table) == ref.row_count(table)
    assert [(c.name, str(c.type)) for c in conn.table_schema(table).columns] \
        == [(c.name, str(c.type)) for c in ref.table_schema(table).columns]
    assert conn.unique_columns(table) == ref.unique_columns(table)
    splits = conn.splits(table, TARGET_ROWS)
    assert [(s.start_row, s.row_count) for s in splits] == [
        (s.start_row, s.row_count) for s in ref.splits(table, TARGET_ROWS)]
    names = conn.table_schema(table).column_names()
    for split in splits:
        p, r = conn.page_for_split(split), ref.page_for_split(split)
        np.testing.assert_array_equal(p.valid.numpy(), np.asarray(r.valid))
        for name, pb, rb in zip(names, p.blocks, r.blocks):
            want = np.asarray(rb.data)
            np.testing.assert_array_equal(pb.data.numpy(), want,
                                          err_msg=name)
            assert pb.data.numpy().dtype == want.dtype, name
            assert (pb.dictionary is None) == (rb.dictionary is None), name
            if pb.dictionary is not None:
                assert len(pb.dictionary) == len(rb.dictionary), name
                codes = np.unique(np.clip(want, 0, len(rb.dictionary) - 1))
                assert list(pb.dictionary.decode(codes)) == \
                    list(rb.dictionary.decode(codes)), name


def _probe_values(conn, table):
    n = conn.row_count(table)
    rng = np.random.default_rng(len(table))
    return np.concatenate([
        np.array([-1, 0, 1, 2, n - 1, n, n + 1, 2415021, 2415022,
                  2415022 + 73048, 2415022 + 73049]),
        rng.integers(-5, n + 2_500_000, 300)]).astype(np.int64)


@pytest.mark.parametrize("table", TABLES)
def test_key_inverses_match_reference(conn, ref, table):
    for col in ref.table_schema(table).column_names():
        vals = _probe_values(conn, table)
        rinv, pinv = ref.key_inverse(table, col), conn.key_inverse(table, col)
        assert (rinv is None) == (pinv is None), col
        if rinv is not None:
            for g, w in zip(pinv(torch.from_numpy(vals)),
                            rinv(jnp.asarray(vals))):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        rw = ref.key_window_inverse(table, col)
        pw = conn.key_window_inverse(table, col)
        assert (rw is None) == (pw is None), col
        if rw is not None:
            assert pw[1] == rw[1] == MAX_LINES
            for g, w in zip(pw[0](torch.from_numpy(vals)),
                            rw[0](jnp.asarray(vals))):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        rb = ref.monotonic_row_bound(table, col)
        pb = conn.monotonic_row_bound(table, col)
        assert (rb is None) == (pb is None), col
        if rb is not None:
            assert [pb(int(v)) for v in vals] == [rb(int(v)) for v in vals]


@pytest.mark.parametrize("table", TABLES)
def test_gen_at_scattered_rows_equals_scan(conn, ref, table):
    names = tuple(conn.table_schema(table).column_names())
    n = conn.row_count(table)
    rng = np.random.default_rng(7 + len(table))
    idx = np.unique(rng.integers(0, n, min(n, 200)))
    idx_t = torch.from_numpy(idx)
    datas, valid = conn.gen_at(table, names)(idx_t)
    rdatas, rvalid = ref.gen_at(table, names)(jnp.asarray(idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    for name, d, rd in zip(names, datas, rdatas):
        np.testing.assert_array_equal(d.numpy(), np.asarray(rd),
                                      err_msg=name)
    # the same rows through the scan path
    for split in conn.splits(table, TARGET_ROWS):
        sel = (idx >= split.start_row) & (
            idx < split.start_row + split.row_count)
        if not sel.any():
            continue
        page = conn.page_for_split(split, names)
        off = idx[sel] - split.start_row
        np.testing.assert_array_equal(page.valid.numpy()[off],
                                      valid.numpy()[sel])
        for name, blk, d in zip(names, page.blocks, datas):
            np.testing.assert_array_equal(blk.data.numpy()[off],
                                          d.numpy()[sel], err_msg=name)


def test_window_holds_every_row_of_its_ticket(conn):
    """Each live store_returns row sits in the 11-slot window its ticket
    number pins, and (ticket, item) picks exactly one live slot there."""
    names = ("sr_ticket_number", "sr_item_sk")
    page = conn.page_for_split(conn.splits("store_returns", 1 << 20)[0],
                               names)
    valid = page.valid.numpy()
    tickets = page.blocks[0].data.numpy()[valid]
    items = page.blocks[1].data.numpy()[valid]
    inv, window = conn.key_window_inverse("store_returns",
                                          "sr_ticket_number")
    base, found = inv(torch.from_numpy(tickets))
    assert found.all()
    slots = np.flatnonzero(valid)
    assert ((slots >= base.numpy()) & (slots < base.numpy() + window)).all()
    gen = conn.gen_at("store_returns", ("sr_item_sk",))
    hits = np.zeros(len(tickets), np.int64)
    for k in range(window):
        (it,), ok = gen(base + k)
        hits += (ok.numpy() & (it.numpy() == items)).astype(np.int64)
    assert (hits == 1).all()


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert TpcdsConnector(0.001).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TpcdsConnector(0.001)
