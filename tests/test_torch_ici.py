"""The ICI exchange plane (presto_tpu_torch/dist/executor.
ici_exchange_pages and dist/scheduler.py's mesh-exchange stage) against
presto_tpu's, on the CPU.

The counterparts of tests/test_device_exchange.py's ICI cases:

  - partition parity per key family (int, double with -0.0/NaN,
    boolean, dictionary varchar, short and long decimal, all six, at 4
    partitions and int at 2), partition by partition against the
    reference's ``ici_exchange_pages`` with the kernels off (both route
    with splitmix64), and against the port's own spool partitioner
    with the kernels on (both route with K4's twin: the K4 twin case);
  - a skewed key overflows the landing capacity, the boost ladder
    settles it, and no row is lost;
  - the ledger pin: a stage DAG over two in-process workers takes the
    plane at the default mesh_exchange_mode, its exchange phase crosses
    zero bytes either way and serializes zero spool blobs, and its rows
    equal the spool plane's, the local runner's and sqlite's;
  - a failing exchange falls back LOUDLY to the spool partitioner with
    the same rows.

Tolerances: partition contents and row counts compare exactly."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.dist import executor as RDX
from presto_tpu.exec.executor import Executor as RefExecutor
from presto_tpu.page import Page as RefPage
from presto_tpu_torch import cuda, interop
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist import executor as DX
from presto_tpu_torch.dist import spool as SPOOL
from presto_tpu_torch.dist.dcn import DcnRunner
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server.worker import WorkerServer
from tests.oracle import load_sqlite

SF = 0.01
PAGE_ROWS = 1 << 13
Q3_FAMILY = (
    "select o_orderkey, count(*) c from lineitem "
    "join orders on l_orderkey = o_orderkey "
    "where o_orderkey < 1000 group by o_orderkey order by o_orderkey"
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows_equal(a, b):
    return collections.Counter(map(repr, a)) == collections.Counter(
        map(repr, b))


def _ref_key_page():
    """tests/test_device_exchange.py's page: every partitionable key
    family with NULLs."""
    return RefPage.from_arrays(
        [
            [1, -7, None, 4, 0, 2**40, -1, 5],
            [1.5, -0.0, 0.0, None, float("nan"), 2.5, -3.5, 1e300],
            [True, False, None, True, False, True, False, True],
            ["a", "b", "a", None, "c", "b", "zz", "a"],
            [105, None, -205, 305, 0, 105, 42, 7],       # decimal(9,2)
            [10**20, -(10**20), None, 7, 0, 10**20, 1, 2],  # p>18
        ],
        [RT.BIGINT, RT.DOUBLE, RT.BOOLEAN, RT.VARCHAR,
         RT.DecimalType(9, 2), RT.DecimalType(30, 2)],
    )


def _parts(parts):
    """Per partition, the repr of its rows in page order."""
    return [[repr(r) for pg in plist for r in pg.to_pylist()]
            for plist in parts]


def _spool_parts(pairs, nparts):
    out = [[] for _ in range(nparts)]
    for p, pg in pairs:
        out[p].extend(repr(r) for r in pg.to_pylist())
    return out


def _executor(kernels: bool):
    ex = Executor({"tpch": TpchConnector(SF, device="cpu")}, device="cpu",
                  kernels=kernels)
    ex.device_exchange = "true"
    return ex


KEY_CASES = [((0,), 4), ((0,), 2), ((1,), 4), ((3,), 4), ((4,), 4),
             ((5,), 4), ((0, 1, 2, 3, 4, 5), 4)]


@pytest.mark.parametrize("keys,nparts", KEY_CASES)
def test_ici_vs_spool_partition_parity_per_key_type(keys, nparts):
    """Kernels off: the port's all_to_all puts every row in the same
    partition, in the same order, as the reference's, and as the port's
    spool partitioner."""
    ref_page = _ref_key_page()
    page = interop.page_from_numpy(**interop.page_arrays(ref_page))
    rex = RefExecutor({"tpch": RefConnector(SF)})
    rex.device_exchange = "true"
    want, _ = RDX.ici_exchange_pages(rex, [ref_page], keys, nparts)
    ex = _executor(kernels=False)
    parts, nbytes, counts = DX.ici_exchange_pages(ex, [page], keys, nparts)
    got = _parts(parts)
    assert got == _parts(want), f"keys={keys} nparts={nparts}"
    assert counts.tolist() == [[len(p) for p in got]]
    spool = _spool_parts(
        SPOOL.device_partition_pages(ex, page, keys, nparts), nparts)
    assert [sorted(p) for p in got] == [sorted(p) for p in spool]
    assert sum(len(p) for p in got) == len(page.to_pylist())
    assert nbytes > 0


@pytest.mark.parametrize("keys,nparts", KEY_CASES)
def test_ici_equals_the_k4_spool_partitioner(keys, nparts):
    """Kernels on: the plane routes with K4 (its plain twin here), the
    function the spool partitioner uses at that session, so a fallback
    or a co-partitioned side left on the spools agrees row by row."""
    page = interop.page_from_numpy(**interop.page_arrays(_ref_key_page()))
    ex = _executor(kernels=True)
    assert DX.ici_routes_with_k4(ex)
    cuda.reset_counts()
    parts, _, _ = DX.ici_exchange_pages(ex, [page], keys, nparts)
    assert cuda.plain_calls["part_ids"] == nparts  # one per shard
    spool = _spool_parts(
        SPOOL.device_partition_pages(ex, page, keys, nparts), nparts)
    assert [sorted(p) for p in _parts(parts)] == [sorted(p) for p in spool]


def test_ici_skew_overflow_boosts_and_preserves_rows():
    n = 1 << 14
    page = interop.page_from_numpy(
        columns=[np.full(n, 7, np.int64)], valid=np.ones(n, bool),
        nulls=[None], dictionaries=[None], types=["bigint"])
    ex = _executor(kernels=False)
    r0 = ex.capacity_boost_retries
    parts, _, counts = DX.ici_exchange_pages(ex, [page], (0,), 4)
    assert ex.capacity_boost_retries - r0 >= 1
    assert sorted(counts[0].tolist()) == [0, 0, 0, n]  # settled, exact
    rows = [r for plist in parts for pg in plist for r in pg.to_pylist()]
    assert len(rows) == n
    nonempty = [p for p, plist in enumerate(parts)
                if any(int(pg.num_rows()) for pg in plist)]
    assert len(nonempty) == 1  # the skewed key routes to ONE shard


def test_unsupported_shapes_stay_on_the_spools():
    page = interop.page_from_numpy(
        columns=[np.arange(8, dtype=np.int64)], valid=np.ones(8, bool),
        nulls=[None], dictionaries=[None], types=["bigint"])
    assert DX.ici_exchange_supported(4, [page])
    assert not DX.ici_exchange_supported(3, [page])   # not a power of 2
    assert not DX.ici_exchange_supported(16, [page])  # past the mesh
    assert not DX.ici_exchange_supported(1, [page])
    with pytest.raises(ValueError, match="unsupported"):
        DX.ici_exchange_pages(_executor(False), [page], (0,), 3)


# ------------------------------------------------ the stage-DAG plane
@pytest.fixture(scope="module")
def workers():
    ws = [WorkerServer({"tpch": TpchConnector(SF, device="cpu")},
                       node_id=f"w{i}", default_catalog="tpch",
                       page_rows=PAGE_ROWS, device="cpu")
          for i in range(2)]
    uris = [f"http://127.0.0.1:{w.start()}" for w in ws]
    coords = []
    yield uris, coords
    for c in coords:
        c.close()
    for w in ws:
        w.stop()


@pytest.fixture(scope="module")
def base():
    single = LocalRunner({"tpch": TpchConnector(SF, device="cpu")},
                         session={"page_rows": PAGE_ROWS}, device="cpu")
    return single.execute(Q3_FAMILY).rows


def _coord(workers, **props):
    uris, coords = workers
    session = {"stage_scheduler": "true",
               "join_distribution_type": "partitioned",
               "device_exchange_enabled": "true",
               "page_rows": PAGE_ROWS, "retry_backoff_ms": 20}
    session.update(props)
    coord = DcnRunner({"tpch": TpchConnector(SF, device="cpu")}, uris,
                      default_catalog="tpch", session_props=session,
                      device="cpu")
    coords.append(coord)
    return coord


def test_ici_exchange_ledger_pin(workers, base, monkeypatch):
    """The exchange phase of the q3 family over in-process workers, at
    the default mesh_exchange_mode, stages zero bytes, pulls back only
    the landing pages' row counts (8 bytes per raw page and partition
    per round) and serializes zero spool blobs; the whole query stages
    nothing; rows equal the spool plane's, the local runner's and
    sqlite's."""
    blobs = {"n": 0}
    real = SPOOL.spool_blob

    def counting_blob(page):
        blobs["n"] += 1
        return real(page)

    counts = {"bytes": 0}
    real_ici = DX.ici_exchange_pages

    def counting_ici(ex, pages, keys, nparts):
        r0 = ex.capacity_boost_retries
        out = real_ici(ex, pages, keys, nparts)
        rounds = 1 + ex.capacity_boost_retries - r0
        counts["bytes"] += 8 * len(pages) * nparts * rounds
        return out

    monkeypatch.setattr(SPOOL, "spool_blob", counting_blob)
    monkeypatch.setattr(DX, "ici_exchange_pages", counting_ici)
    coord = _coord(workers)
    snaps = []
    coord._stage_hook = lambda fid: snaps.append(XF.process_totals())
    t0 = XF.process_totals()
    try:
        rows = coord.execute(Q3_FAMILY)
    finally:
        coord._stage_hook = None
    t1 = XF.process_totals()
    ex = coord.runner.executor
    assert coord.last_distribution == "stage-dag"
    assert ex.ici_exchanges >= 1 and ex.ici_bytes > 0
    assert ex.mesh_exchange_fallbacks == 0
    # the second-to-last stage boundary closes the exchange phase (the
    # last is the root's gather stage)
    assert len(snaps) >= 2
    assert snaps[-2]["h2d_bytes"] - t0["h2d_bytes"] == 0
    assert snaps[-2]["d2h_bytes"] - t0["d2h_bytes"] == counts["bytes"] > 0
    assert blobs["n"] == 0
    assert t1["h2d_bytes"] - t0["h2d_bytes"] == 0
    assert t1["d2h_bytes"] - t0["d2h_bytes"] > 0  # result decode
    monkeypatch.setattr(SPOOL, "spool_blob", real)
    spool_rows = _coord(workers, mesh_exchange_mode="false").execute(
        Q3_FAMILY)
    assert rows_equal(rows, spool_rows)
    assert rows_equal(rows, base)
    db = load_sqlite(RefConnector(SF), ["lineitem", "orders"])
    assert rows_equal(rows, db.execute(Q3_FAMILY).fetchall())


def test_ici_trace_failure_falls_back_to_spool(workers, base, monkeypatch):
    def boom(ex, pages, keys, nparts):
        raise RuntimeError("forced exchange failure")

    monkeypatch.setattr(DX, "ici_exchange_pages", boom)
    coord = _coord(workers)
    rows = coord.execute(Q3_FAMILY)
    ex = coord.runner.executor
    assert ex.mesh_exchange_fallbacks >= 1
    assert ex.ici_exchanges == 0
    assert rows_equal(rows, base)


def _observed_stats(coord, monkeypatch):
    """The StageStats the re-planner observes in one query, by fid."""
    from presto_tpu_torch.adaptive import Replanner

    seen = {}
    real = Replanner.observe

    def observe(self, st):
        seen[st.fid] = st
        return real(self, st)

    monkeypatch.setattr(Replanner, "observe", observe)
    rows = coord.execute(Q3_FAMILY)
    monkeypatch.setattr(Replanner, "observe", real)
    return rows, seen


@pytest.mark.parametrize("plane", ["ici", "fallback"])
def test_mesh_stage_stats_equal_the_spool_planes(workers, base,
                                                 monkeypatch, plane):
    """A stage whose exchange rode the mesh (or its loud fallback)
    reports the statistics the spool plane's tasks report for the same
    stage: exact rows per partition and per producer task and the
    trimmed partition pages' bytes, so the re-planner decides the same
    under mesh_exchange_mode auto and false. Only ici_bytes differs.
    Compared exactly."""
    want_rows, want = _observed_stats(
        _coord(workers, mesh_exchange_mode="false"), monkeypatch)
    if plane == "fallback":
        def boom(ex, pages, keys, nparts):
            raise RuntimeError("forced exchange failure")

        monkeypatch.setattr(DX, "ici_exchange_pages", boom)
    coord = _coord(workers)
    rows, got = _observed_stats(coord, monkeypatch)
    ex = coord.runner.executor
    assert (ex.ici_exchanges >= 1) == (plane == "ici")
    assert (ex.mesh_exchange_fallbacks >= 1) == (plane == "fallback")
    assert rows_equal(rows, want_rows) and rows_equal(rows, base)
    meshed = [f for f, st in got.items() if st.ici_bytes > 0]
    assert bool(meshed) == (plane == "ici")
    assert sorted(got) == sorted(want) and got
    for fid, st in got.items():
        assert dataclasses.replace(st, ici_bytes=0) == want[fid], fid


@pytest.mark.parametrize("ici_bytes,fits", [(0, True), (8_000, False)])
def test_mesh_freight_handicaps_a_broadcast_flip(ici_bytes, fits):
    """A stage whose exchange rode the mesh (StageStats.ici_bytes > 0)
    must fit the broadcast share shrunk by ICI_WIRE_RATIO before the
    re-planner flips it to broadcast: the flip would move its freight
    back onto the spools and the wire."""
    from presto_tpu_torch.adaptive import Replanner, StageStats
    from presto_tpu_torch.adaptive.replanner import ICI_WIRE_RATIO

    rp = Replanner(None, None, broadcast_bytes=8_000 * ICI_WIRE_RATIO // 2)
    st = StageStats(fid=0, rows=500, bytes=8_000, part_rows=(250, 250),
                    part_bytes=(4_000, 4_000), task_rows=(250, 250),
                    ici_bytes=ici_bytes)
    assert rp._fits_broadcast(st) == fits
