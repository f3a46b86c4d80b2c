"""Partitioned (grace-style) execution and the spill tiers:
presto_tpu_torch against presto_tpu.

Counterparts of tests/test_spill.py, each run through both engines on
the same data and session (TPC-H SF 0.01, or memory-connector tables):
rows equal the reference's and the single-pass run's, and the
partitioning counters (spill_partitions_used, skew_chunks_used, the
host and disk tiers' page counts) equal the reference's. Beside them,
the partition filter's masks bit for bit against the reference's
(null keys included), and the PageStore tiers' round trip."""

import collections
import gc
import math
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.exec.executor import Executor as RefExecutor
from presto_tpu.exec.executor import MemoryBudgetExceeded as RefExceeded
from presto_tpu.page import Block as RBlock
from presto_tpu.page import Page as RPage
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import pagestore as PS
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.exec.executor import Executor, MemoryBudgetExceeded
from presto_tpu_torch.page import Block, Dictionary, Page
from presto_tpu_torch.runner import LocalRunner
from tests.torch_memory import MemoryConnector

SF = 0.01
PAGE_ROWS = 1 << 13
# the multi-pass tests run at a smaller scale: every pass re-runs a join
# or re-streams a scan on the CPU, in both engines
SMALL_SF = 0.002
SMALL_PAGE_ROWS = 1 << 12
COUNTERS = ("spill_partitions_used", "host_spill_pages", "disk_spill_pages",
            "skew_chunks_used", "memory_chunked_pipelines")


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
def small():
    return RefConnector(SMALL_SF), TpchConnector(SMALL_SF, device="cpu")


def _norm(v):
    return float(f"{v:.9g}") if isinstance(v, float) else v


def rows_equal(a, b) -> bool:
    """Equal as multisets; doubles to 9 significant digits."""
    return (collections.Counter(repr(tuple(map(_norm, r))) for r in a)
            == collections.Counter(repr(tuple(map(_norm, r))) for r in b))


def runners(port_cats, ref_cats, session, page_rows=PAGE_ROWS,
            catalog="tpch"):
    """The port's and the reference's LocalRunner on one session."""
    port = LocalRunner(port_cats, catalog,
                       session={"page_rows": page_rows, **session},
                       device="cpu")
    ref = RefRunner(ref_cats, default_catalog=catalog, page_rows=page_rows)
    for k, v in session.items():
        ref.session.set(k, v)
    return port, ref


def run_both(port, ref, sql):
    """Rows of both engines (equal) and the counters (equal)."""
    got = port.execute(sql).rows
    want = ref.execute(sql).rows
    assert rows_equal(got, want), (got[:3], want[:3])
    for c in COUNTERS:
        assert getattr(port.executor, c) == getattr(ref.executor, c), c
    return got


def tpch_pair(conns, session, page_rows=PAGE_ROWS):
    ref_conn, conn = conns
    return runners({"tpch": conn}, {"tpch": ref_conn}, session, page_rows)


QUERIES = [
    # fact-fact join + high-cardinality group-by
    "select o_orderkey, sum(l_extendedprice), count(*) "
    "from orders, lineitem where o_orderkey = l_orderkey "
    "group by o_orderkey order by 2 desc limit 7",
    # high-cardinality aggregation alone
    "select l_orderkey, count(*) from lineitem group by l_orderkey "
    "order by 2 desc, 1 limit 5",
    # anti join (null-key semantics must survive partitioning)
    "select c_custkey, c_acctbal from customer where c_custkey not in "
    "(select o_custkey from orders) order by c_custkey limit 5",
    # outer join: null-extension exactly once per unmatched probe row
    "select count(*) from customer left join orders "
    "on c_custkey = o_custkey",
]


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_partitioned_matches_single_pass(conns, qi):
    port, ref = tpch_pair(conns, {"spill_threshold_bytes": 1 << 17})
    single, _ = tpch_pair(conns, {})
    got = run_both(port, ref, QUERIES[qi])
    assert port.executor.spill_partitions_used > 1
    assert rows_equal(got, single.execute(QUERIES[qi]).rows)


def test_right_join_unmatched_build_rows_once_per_partition(conns):
    port, ref = tpch_pair(conns, {"spill_threshold_bytes": 1 << 13})
    q = ("select count(*) from orders right join customer "
         "on o_custkey = c_custkey")
    got = run_both(port, ref, q)
    single, _ = tpch_pair(conns, {})
    assert port.executor.spill_partitions_used > 1
    assert got == single.execute(q).rows


def test_string_keys_fall_back_to_single_pass(conns):
    port, ref = tpch_pair(conns, {"spill_threshold_bytes": 1 << 17})
    rows = run_both(port, ref, "select c_mktsegment, count(*) from "
                               "customer group by c_mktsegment")
    assert port.executor.spill_partitions_used == 0
    assert sum(r[1] for r in rows) == 1500


def test_spill_respects_memory_budget(conns):
    """A query that busts the page budget single-pass completes under
    the same budget with partitioning on — in both engines."""
    q = ("select o_orderkey, count(*) from orders, lineitem "
         "where o_orderkey = l_orderkey group by o_orderkey "
         "order by 2 desc limit 3")
    port, ref = tpch_pair(conns, {"query_max_memory_bytes": 1 << 19},
                          page_rows=1 << 12)
    with pytest.raises(MemoryBudgetExceeded):
        port.execute(q)
    with pytest.raises(RefExceeded):
        ref.execute(q)
    port, ref = tpch_pair(conns, {"query_max_memory_bytes": 1 << 19,
                                  "spill_threshold_bytes": 1 << 15},
                          page_rows=1 << 12)
    assert len(run_both(port, ref, q)) == 3


def _mem_pair(tables, session, page_rows=PAGE_ROWS, conns=None):
    """Memory-connector catalogs holding ``tables`` ({name: (columns,
    (port types, reference types), rows)}) in both engines."""
    port_mem, ref_mem = MemoryConnector(device="cpu"), RefMemory()
    for name, (cols, (pt, rt), rows) in tables.items():
        port_mem.create_table(name, cols, pt, rows)
        ref_mem.create_table(name, cols, rt, rows)
    if conns is None:
        return runners({"mem": port_mem}, {"mem": ref_mem}, session,
                       page_rows, catalog="mem")
    ref_conn, conn = conns
    return runners({"tpch": conn, "memory": port_mem},
                   {"tpch": ref_conn, "memory": ref_mem}, session,
                   page_rows)


BIGINT1 = ([T.BIGINT], [RT.BIGINT])
BIGINT2 = ([T.BIGINT, T.BIGINT], [RT.BIGINT, RT.BIGINT])


def test_not_in_null_build_partitioned(conns):
    """NOT IN three-valued logic survives partitioning: a NULL in the
    build side suppresses every unmatched probe row in EVERY pass."""
    keys = [(i,) for i in range(100_000, 105_000)]
    port, ref = _mem_pair({"u": (["y"], BIGINT1, keys + [(None,)]),
                           "u2": (["y"], BIGINT1, keys)},
                          {"spill_threshold_bytes": 1 << 13}, conns=conns)
    rows = run_both(port, ref, "select count(*) from orders where "
                               "o_custkey not in (select y from memory.u)")
    assert port.executor.spill_partitions_used > 1
    assert rows == [(0,)]
    rows2 = run_both(port, ref, "select count(*) from orders where "
                                "o_custkey not in (select y from memory.u2)")
    assert rows2[0][0] > 0


def _counting(conn, tables):
    """Count conn.pages calls per table (an instance attribute, which
    also keeps the scan out of fused streams in both engines)."""
    calls = {t: 0 for t in tables}
    orig = conn.pages

    def counting(table, *a, **k):
        if table in calls:
            calls[table] += 1
        return orig(table, *a, **k)

    conn.pages = counting
    return calls


def test_partition_fold_single_source_pass():
    """parts <= 32 takes the single-pass fold: the source streams once,
    not once per partition."""
    conns = (RefConnector(SF), TpchConnector(SF, device="cpu"))
    calls = _counting(conns[1], ["lineitem"])
    ref_calls = _counting(conns[0], ["lineitem"])
    port, ref = tpch_pair(conns, {"spill_threshold_bytes": 1 << 17})
    rows = run_both(port, ref, "select l_orderkey, count(*) from lineitem "
                               "group by l_orderkey order by 2 desc, 1 "
                               "limit 3")
    assert 1 < port.executor.spill_partitions_used <= 32
    assert calls["lineitem"] == ref_calls["lineitem"] == 1
    assert len(rows) == 3


Q_3WAY = ("select count(*), sum(l_extendedprice) from lineitem, orders, "
          "customer where l_orderkey = o_orderkey and o_custkey = c_custkey")
# both joins of Q_3WAY partition: orders' 3,000 rows in 16 passes, the
# outer join's 300 customers in 2, so the outer join's probe side (the
# inner join) materializes in a PageStore
THREE_WAY = {"max_join_build_rows": 250, "generated_join_enabled": "false"}


def test_partitioned_join_restreams_from_store(small):
    """A partitioned join over another join materializes that subtree
    ONCE (PageStore) and restreams it per pass: scan counts stay at the
    inner join's pass count, not inner x outer."""
    fresh = (RefConnector(SMALL_SF), TpchConnector(SMALL_SF, device="cpu"))
    calls = _counting(fresh[1], ["orders", "lineitem"])
    ref_calls = _counting(fresh[0], ["orders", "lineitem"])
    port, ref = tpch_pair(fresh, THREE_WAY, SMALL_PAGE_ROWS)
    got = run_both(port, ref, Q_3WAY)
    parts = port.executor.spill_partitions_used
    assert parts > 1
    assert 1 < calls["lineitem"] <= parts
    assert 1 < calls["orders"] <= parts
    assert calls == ref_calls
    single, _ = tpch_pair(small, {}, SMALL_PAGE_ROWS)
    assert rows_equal(got, single.execute(Q_3WAY).rows)


def test_max_join_build_rows_partitions_without_byte_threshold(conns):
    port, ref = tpch_pair(conns, {"max_join_build_rows": 2000,
                                  "generated_join_enabled": "false"})
    q = ("select count(*), sum(l_extendedprice) from lineitem, orders "
         "where l_orderkey = o_orderkey")
    got = run_both(port, ref, q)
    assert port.executor.spill_partitions_used == 8  # pow2(15000/2000)
    single, _ = tpch_pair(conns, {})
    assert rows_equal(got, single.execute(q).rows)


def test_host_spill_tier_restages(small):
    """host_spill_bytes low: the materialized inner join stages to host
    RAM and restages per pass — same rows, host counters advance."""
    port, ref = tpch_pair(small, {**THREE_WAY, "host_spill_bytes": 1},
                          SMALL_PAGE_ROWS)
    got = run_both(port, ref, Q_3WAY)
    ex = port.executor
    assert ex.spill_partitions_used > 1
    assert ex.host_spill_pages > 0
    assert ex.host_spill_bytes_used > 0
    single, _ = tpch_pair(small, {}, SMALL_PAGE_ROWS)
    assert rows_equal(got, single.execute(Q_3WAY).rows)


def test_multipass_beyond_32_partitions(small):
    """parts > 32 re-streams the source once per partition."""
    port, ref = tpch_pair(small, {"spill_threshold_bytes": 1 << 14},
                          SMALL_PAGE_ROWS)
    q = ("select l_orderkey, count(*), sum(l_extendedprice) "
         "from lineitem group by l_orderkey order by 3 desc, 1 limit 5")
    got = run_both(port, ref, q)
    assert port.executor.spill_partitions_used > 32
    single, _ = tpch_pair(small, {}, SMALL_PAGE_ROWS)
    assert rows_equal(got, single.execute(q).rows)


def test_disk_spill_tier_restages(small, tmp_path):
    """disk_spill_bytes low: intermediates write to files under
    spill_path and restream from disk per pass; the files go when the
    query ends."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    port, ref = tpch_pair(small, {**THREE_WAY, "disk_spill_bytes": 1,
                                  "spill_path": str(port_dir)},
                          SMALL_PAGE_ROWS)
    ref.session.set("spill_path", str(ref_dir))
    got = run_both(port, ref, Q_3WAY)
    assert port.executor.spill_partitions_used > 1
    assert port.executor.disk_spill_pages > 0
    gc.collect()
    assert os.listdir(port_dir) == []
    single, _ = tpch_pair(small, {}, SMALL_PAGE_ROWS)
    assert rows_equal(got, single.execute(Q_3WAY).rows)


SKEW_TABLES = {
    # 85% of the build rows share key 7; the probe is the bigger side,
    # so the planner keeps the hot table as the build
    "probe": (["pk", "pv"], BIGINT2, [(i % 50, i) for i in range(4000)]),
    "build": (["bk", "bv"], BIGINT2,
              [(7 if i % 100 < 85 else i % 50, i) for i in range(2000)]),
}
Q_SKEW = "select count(*), sum(pv), sum(bv) from probe, build where pk = bk"


@pytest.mark.parametrize("rebalance", [True, False])
def test_skew_rebalance(rebalance):
    """A hot join key cannot be split by hash: on the boosted retry the
    hot partition's build rows chunk by POSITION (skew_chunks_used
    advances) — or, with join_skew_rebalance off, the buffers grow —
    and the inner join still matches the single-pass engine."""
    single, _ = _mem_pair(SKEW_TABLES, {}, page_rows=1 << 9)
    want = single.execute(Q_SKEW).rows
    port, ref = _mem_pair(SKEW_TABLES, {
        "spill_threshold_bytes": 1 << 12,
        "generated_join_enabled": "false",
        "join_skew_rebalance": "true" if rebalance else "false",
    }, page_rows=1 << 9)
    got = run_both(port, ref, Q_SKEW)
    assert port.executor.spill_partitions_used > 1
    if rebalance:
        assert port.executor.skew_chunks_used > 1
    else:
        assert port.executor.skew_chunks_used == 0
    assert port.executor.capacity_boost_retries == \
        ref.executor.capacity_boost_retries
    assert rows_equal(got, want)


# ------------------------------------------------ partition filter masks
MASK_CASES = {
    # name: (key types, null rate, parts, keep_nulls)
    "bigint_2": ((RT.BIGINT,), 0.0, 2, False),
    "bigint_8_nulls": ((RT.BIGINT,), 0.1, 8, False),
    "bigint_8_keep_nulls": ((RT.BIGINT,), 0.1, 8, True),
    "int_double_64": ((RT.INTEGER, RT.DOUBLE), 0.05, 64, False),
    "two_keys_keep_nulls": ((RT.BIGINT, RT.DATE), 0.05, 32, True),
    "many_parts": ((RT.BIGINT,), 0.0, 256, False),
}
PORT_TYPES = {"bigint": T.BIGINT, "integer": T.INTEGER, "double": T.DOUBLE,
              "date": T.DATE}


@pytest.mark.parametrize("name", sorted(MASK_CASES))
def test_partition_filter_masks_match_reference(name):
    """_partition_filter keeps, bit for bit, the reference's rows in
    every pass: the high 32 bits of the key hash, null keys routed to
    every pass under keep_nulls."""
    types, null_rate, parts, keep_nulls = MASK_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 4096
    datas, nulls = [], []
    for t in types:
        if str(t) == "double":
            d = rng.normal(size=n) * 1e3
            d[:4] = [0.0, -0.0, np.nan, np.inf]
        else:
            d = rng.integers(-(1 << 30), 1 << 30, n)
            d = d.astype(np.int32 if str(t) in ("integer", "date")
                         else np.int64)
        datas.append(d)
        nulls.append(rng.random(n) < null_rate if null_rate else None)
    valid = rng.random(n) < 0.9

    ref_page = RPage(blocks=tuple(
        RBlock(data=jnp.asarray(d), type=t,
               nulls=None if m is None else jnp.asarray(m))
        for d, t, m in zip(datas, types, nulls)), valid=jnp.asarray(valid))
    port_page = Page(blocks=tuple(
        Block(data=torch.from_numpy(d), type=PORT_TYPES[str(t)],
              nulls=None if m is None else torch.from_numpy(m))
        for d, t, m in zip(datas, types, nulls)),
        valid=torch.from_numpy(valid))
    keys = tuple(range(len(types)))
    ref_fn = RefExecutor({})._partition_filter(keys, parts, keep_nulls)
    port_fn = Executor({}, device="cpu")._partition_filter(keys, parts,
                                                           keep_nulls)
    covered = np.zeros(n, dtype=np.int64)
    for p in range(parts):
        want = np.asarray(ref_fn(ref_page, jnp.uint64(p)).valid)
        got = port_fn(port_page, p).valid.numpy()
        np.testing.assert_array_equal(got, want)
        covered += got
    # every valid row lands in exactly one pass, a null key (keep_nulls)
    # in all of them
    any_null = np.zeros(n, dtype=bool)
    for m in nulls:
        if m is not None:
            any_null |= m
    expect = np.where(any_null & keep_nulls, parts, 1) * valid
    np.testing.assert_array_equal(covered, expect)


# ------------------------------------------------------ PageStore tiers
def _sample_page() -> Page:
    dic = Dictionary(["a", "bb", "ccc"])
    return Page(blocks=(
        Block(data=torch.arange(10, dtype=torch.int64), type=T.BIGINT,
              nulls=torch.arange(10) % 3 == 0),
        Block(data=torch.tensor([0, 1, 2, 1, 0, 2, 2, 1, 0, 0],
                                dtype=torch.int32),
              type=T.VarcharType(8), dictionary=dic),
        Block(data=(torch.arange(10, dtype=torch.int64) - 5,
                    torch.arange(10, dtype=torch.int64) * 7),
              type=T.DecimalType(30, 2)),
        Block(data=torch.linspace(-1, 1, 10, dtype=torch.float64),
              type=T.DOUBLE),
    ), valid=torch.arange(10) % 4 != 1)


@pytest.mark.parametrize("tier", ["device", "host", "disk"])
def test_pagestore_tiers_round_trip(tier, tmp_path):
    page = _sample_page()
    store = PS.PageStore(tier, spill_dir=str(tmp_path), device="cpu")
    store.put(page)
    store.put(page)
    assert store.page_count == 2
    assert store.bytes == 2 * PS.page_bytes(page)
    for _round in range(2):  # restreamable
        got = list(store.stream())
        assert len(got) == 2
        for g in got:
            assert g.to_pylist() == page.to_pylist()
            assert g.block(1).dictionary == page.block(1).dictionary
    if tier == "disk":
        assert len(os.listdir(tmp_path)) == 1
    store.close()
    assert os.listdir(tmp_path) == []


def test_pagestore_put_host_and_blobs(tmp_path):
    store = PS.PageStore("disk", spill_dir=str(tmp_path))
    store.put_host(XF.to_host(_sample_page()))
    assert [p.to_pylist() for p in store.stream()] == \
        [_sample_page().to_pylist()]
    blobs = PS.PageStore("disk", spill_dir=str(tmp_path))
    blobs.put_bytes(b"xyz")
    blobs.put_bytes(b"")
    assert blobs.blob_at(0) == b"xyz" and blobs.blob_at(1) == b""
    store.close()
    blobs.close()
    assert os.listdir(tmp_path) == []


def test_sweep_stale_spill_dirs(tmp_path):
    """A dead process's spill dir goes; a live one's and ours stay."""
    dead = _dead_pid()
    stale = tmp_path / f"presto_tpu_torch_spill_{dead}_x"
    mine = tmp_path / f"presto_tpu_torch_spill_{os.getpid()}_y"
    other = tmp_path / "unrelated"
    for d in (stale, mine, other):
        d.mkdir()
    assert PS.sweep_stale_spill_dirs(str(tmp_path)) == 1
    assert sorted(os.listdir(tmp_path)) == sorted([mine.name, other.name])


def _dead_pid() -> int:
    """The pid of a process that has exited."""
    proc = subprocess.Popen(["true"])
    proc.wait()
    return proc.pid


def test_memory_connector_matches_reference():
    """The port's memory connector returns the reference's pages for the
    same table, NULLs and strings included."""
    rows = [(i, None if i % 5 == 0 else f"s{i % 3}", i * 0.5)
            for i in range(37)]
    cols = ["k", "s", "d"]
    port, ref = _mem_pair({"t": (cols, ([T.BIGINT, T.VarcharType(8),
                                         T.DOUBLE],
                                        [RT.BIGINT, RT.VarcharType(8),
                                         RT.DOUBLE]), rows)}, {},
                          page_rows=8)
    q = "select k, s, d from t where k > 3"
    got = run_both(port, ref, q)
    assert rows_equal(got, [r for r in rows if r[0] > 3])
    assert math.isclose(sum(r[2] for r in got),
                        sum(r[2] for r in rows if r[0] > 3))
