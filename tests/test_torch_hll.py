"""approx_distinct (HyperLogLog): presto_tpu_torch against presto_tpu.

Module level: ``ops/hll`` insert, merge, estimate and the global forms
on the same seeded hashes and group ids (numpy) in both engines; the
packed register words equal bit for bit, and so do the estimates. The
hashes include the edges of ``_reg_rank``: the sign bit set (a logical
shift keeps it out of the rank), all 56 rank bits zero (rank 57) and
all ones.

Query level: the counterparts of tests/test_hll.py at its scale (TPC-H
SF 0.01): global, grouped, string input and empty input equal the
reference engine's rows, and the grouped estimates stay within 4
standard errors of the exact count; the spill path's partition count
equals the reference's; the stage-DAG path (two in-process workers)
carries the HLL state words through the exchange serde and gives the
single-process rows; the words keep their bits through every PageStore
tier and the wire format, and count in the page footprint."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.ops import hashing as RH
from presto_tpu.ops import hll as RHLL
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.dcn import DcnRunner
from presto_tpu_torch.ops import hashing as H
from presto_tpu_torch.ops import hll as HLL
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server.worker import WorkerServer

SF = 0.01
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
EDGE_HASHES = np.array([
    0, 1, 255, 256, 0x8000000000000000, 0x80000000000000FF,
    0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFF00, 0x0100000000000000,
    0x00000000000001AB, 0x7FFFFFFFFFFFFFFF,
], dtype=np.uint64)


def _hashes(rng, n, span):
    vals = rng.integers(0, span, n).astype(np.uint64)
    rh = np.asarray(RH.hash_columns([jnp.asarray(vals)], [None]))
    ph = H.hash_columns([torch.from_numpy(vals.view(np.int64))], [None])
    np.testing.assert_array_equal(ph.numpy().view(np.uint64), rh)
    return np.concatenate([rh, EDGE_HASHES])


def _words_equal(rw, pw):
    assert len(rw) == len(pw) == HLL.WORDS
    for a, b in zip(rw, pw):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("n,groups,span", [
    (40, 1, 30), (700, 5, 300), (5000, 17, 100000), (3000, 64, 50)])
def test_insert_merge_estimate_bit_for_bit(n, groups, span):
    rng = np.random.default_rng(n + groups)
    h = _hashes(rng, n, span)
    m = h.shape[0]
    gid = rng.integers(0, groups, m)
    contributing = rng.random(m) < 0.9
    rh, ph = jnp.asarray(h), torch.from_numpy(h.view(np.int64))
    rg, pg = jnp.asarray(gid), torch.from_numpy(gid)
    rc, pc = jnp.asarray(contributing), torch.from_numpy(contributing)
    reg_r, rank_r = RHLL._reg_rank(rh)
    reg_p, rank_p = HLL._reg_rank(ph)
    np.testing.assert_array_equal(reg_p.numpy(), np.asarray(reg_r))
    np.testing.assert_array_equal(rank_p.numpy(), np.asarray(rank_r))
    rw = RHLL.insert(rg, rc, groups, rh)
    pw = HLL.insert(pg, pc, groups, ph)
    _words_equal(rw, pw)
    np.testing.assert_array_equal(HLL.estimate(pw).numpy(),
                                  np.asarray(RHLL.estimate(rw)))
    # two partial states per group, merged by group
    half = rng.random(m) < 0.5
    parts_r = [RHLL.insert(rg, rc & jnp.asarray(s), groups, rh)
               for s in (half, ~half)]
    parts_p = [HLL.insert(pg, pc & torch.from_numpy(s), groups, ph)
               for s in (half, ~half)]
    stack_r = tuple(jnp.concatenate([a, b]) for a, b in zip(*parts_r))
    stack_p = tuple(torch.cat([a, b]) for a, b in zip(*parts_p))
    mg = np.concatenate([np.arange(groups), np.arange(groups)])
    live = rng.random(2 * groups) < 0.8
    mr = RHLL.merge(jnp.asarray(mg), jnp.asarray(live), groups, stack_r)
    mp = HLL.merge(torch.from_numpy(mg), torch.from_numpy(live), groups,
                   stack_p)
    _words_equal(mr, mp)
    np.testing.assert_array_equal(HLL.estimate(mp).numpy(),
                                  np.asarray(RHLL.estimate(mr)))
    # the global forms
    gr = RHLL.global_insert(rc, rh)
    gp = HLL.global_insert(pc, ph)
    _words_equal(gr, gp)
    ones = np.ones(2, bool)
    _words_equal(
        RHLL.global_merge(jnp.asarray(ones), tuple(
            jnp.concatenate([a, a]) for a in gr)),
        HLL.global_merge(torch.from_numpy(ones), tuple(
            torch.cat([a, a]) for a in gp)))


def test_estimate_regimes_match_reference():
    """Register words chosen for each regime: empty, linear counting,
    raw, and high registers (rank 57 in the top byte)."""
    rng = np.random.default_rng(7)
    regs = np.zeros((6, HLL.M_REGS), np.int64)
    regs[1, :3] = 1
    regs[2, :200] = rng.integers(1, 4, 200)
    regs[3] = rng.integers(1, 12, HLL.M_REGS)
    regs[4] = rng.integers(8, 58, HLL.M_REGS)
    regs[5] = 57
    pw = HLL._pack(torch.from_numpy(regs))
    rw = RHLL._pack(jnp.asarray(regs))
    _words_equal(rw, pw)
    np.testing.assert_array_equal(HLL._unpack(pw).numpy(), regs)
    np.testing.assert_array_equal(HLL.estimate(pw).numpy(),
                                  np.asarray(RHLL.estimate(rw)))


@pytest.mark.parametrize("n", [10, 500, 20_000])
def test_estimate_accuracy(n):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 1 << 60, size=n * 2) % n
    h = H.hash_columns([torch.from_numpy(vals.astype(np.int64))], [None])
    words = HLL.global_insert(torch.ones(n * 2, dtype=torch.bool), h)
    est = int(HLL.estimate(words)[0])
    exact = len(np.unique(vals))
    assert abs(est - exact) / exact < 0.26, (n, est, exact)


# ------------------------------------------------------------- query level
@pytest.fixture(scope="module")
def conn():
    return TpchConnector(SF, device="cpu")


@pytest.fixture(scope="module")
def ref_conn():
    return RefConnector(SF)


@pytest.fixture(scope="module")
def port(conn):
    return LocalRunner({"tpch": conn}, session={"page_rows": PAGE_ROWS},
                       device="cpu")


@pytest.fixture(scope="module")
def reference(ref_conn):
    return RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS)


QUERIES = {
    "global": "select approx_distinct(o_custkey), count(distinct o_custkey) "
              "from orders",
    "grouped": "select o_orderpriority, approx_distinct(o_custkey), "
               "count(distinct o_custkey) from orders "
               "group by o_orderpriority",
    "string": "select approx_distinct(c_mktsegment) from customer",
    "empty": "select approx_distinct(o_custkey) from orders "
             "where o_orderkey < 0",
    "beside_sum": "select l_returnflag, approx_distinct(l_partkey), "
                  "sum(l_quantity), count(*) from lineitem "
                  "group by l_returnflag",
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_sql_matches_reference(name, port, reference):
    sql = QUERIES[name]
    got = port.execute(sql).rows
    assert collections.Counter(got) == collections.Counter(
        reference.execute(sql).rows)
    if name in ("global", "grouped"):
        for row in got:
            est, exact = row[-2], row[-1]
            assert abs(est - exact) / max(exact, 1) < 0.26, row
    if name == "string":
        assert got == [(5,)]
    if name == "empty":
        assert got == [(0,)]
    if name == "grouped":
        assert len(got) == 5


def test_sql_spill_partitioned(conn, ref_conn, port):
    q = ("select o_custkey, approx_distinct(o_orderkey), "
         "count(distinct o_orderkey) from orders group by o_custkey "
         "order by 1 limit 20")
    sp = LocalRunner({"tpch": conn}, session={
        "page_rows": PAGE_ROWS, "spill_threshold_bytes": 1 << 15},
        device="cpu")
    ref = RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS)
    ref.session.set("spill_threshold_bytes", 1 << 15)
    got = sp.execute(q).rows
    assert got == port.execute(q).rows
    assert got == ref.execute(q).rows
    assert sp.executor.spill_partitions_used > 1
    assert (sp.executor.spill_partitions_used
            == ref.executor.spill_partitions_used)


@pytest.fixture(scope="module")
def workers():
    ws = [WorkerServer({"tpch": TpchConnector(SF, device="cpu")},
                       node_id=f"h{i}", default_catalog="tpch",
                       page_rows=PAGE_ROWS, device="cpu")
          for i in range(2)]
    for w in ws:
        w.start()
    yield [w.uri for w in ws]
    for w in ws:
        w.stop()


@pytest.mark.parametrize("sql", [
    "select o_orderpriority, approx_distinct(o_custkey) "
    "from orders group by o_orderpriority",
    "select approx_distinct(o_custkey) from orders",
    "select o_custkey % 7, approx_distinct(o_orderkey) from orders "
    "group by o_custkey % 7",
])
def test_sql_distributed(sql, workers, port):
    coord = DcnRunner({"tpch": TpchConnector(SF, device="cpu")}, workers,
                      default_catalog="tpch", session_props={
                          "page_rows": PAGE_ROWS,
                          "join_distribution_type": "partitioned",
                          "device_exchange_enabled": "true",
                          "stage_scheduler": "true"},
                      device="cpu")
    got = coord.execute(sql)
    assert coord.last_distribution == "stage-dag"
    assert coord.runner.executor.spooled_exchange_pages > 0
    assert collections.Counter(got) == collections.Counter(
        port.execute(sql).rows)


@pytest.mark.parametrize("tier", ["device", "host", "disk", "wire"])
def test_state_words_travel_through_stores_and_serde(tier, tmp_path):
    """An HLL state page keeps its 32 words through each PageStore tier
    and the exchange serde; its footprint counts them."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.dist import serde as SERDE
    from presto_tpu_torch.exec import xfer as XF
    from presto_tpu_torch.exec.executor import _row_bytes
    from presto_tpu_torch.exec.pagestore import PageStore, page_bytes
    from presto_tpu_torch.page import Block, Page

    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, 500,
                                      dtype=np.int64))
    gid = torch.from_numpy(rng.integers(0, 8, 500))
    words = HLL.insert(gid, torch.ones(500, dtype=torch.bool), 8, h)
    page = Page(blocks=(Block(data=torch.arange(8), type=T.BIGINT),
                        Block(data=words, type=T.HLL_STATE)),
                valid=torch.ones(8, dtype=torch.bool))
    assert _row_bytes([T.BIGINT, T.HLL_STATE]) == 2 + 8 + 8 * HLL.WORDS
    assert page_bytes(page) == 8 + 8 * 8 + 8 * 8 * HLL.WORDS
    if tier == "wire":
        # a decoded page is a host page: the consumer stages it
        back = XF.to_device(
            SERDE.deserialize_page(SERDE.serialize_page(page)), "cpu")
    else:
        store = PageStore(tier, spill_dir=str(tmp_path), device="cpu")
        store.put(page)
        (back,) = list(store.stream())
        store.close()
    assert back.block(1).type == T.HLL_STATE
    _words_equal(words, back.block(1).data)
    np.testing.assert_array_equal(HLL.estimate(back.block(1).data).numpy(),
                                  HLL.estimate(words).numpy())
