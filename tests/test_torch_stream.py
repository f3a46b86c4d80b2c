"""The streaming plane, part 1: the append log (presto_tpu_torch/
connectors/stream.py) and incremental view maintenance
(presto_tpu_torch/streaming/ivm.py), against presto_tpu.

The counterparts of the first 13 cases of tests/test_streaming.py plus
its failed-append, watermark-race and append-writers cases. Each case
builds the same log in both engines from the same seeded rows (each
engine's own row API), runs the same sequence, and holds the port's
rows (integers bit for bit, doubles to 9 significant digits) and its
streaming counters (``ivm_refreshes``, ``ivm_full_recomputes``,
``delta_pages_folded``, ``stream_appends_seen``) and rows scanned per
refresh to the reference's; the acceptance case checks sqlite too. The
append-writers case drives tools/loadbench.py's writers × readers load
through a harness of its own (the tool belongs to the reference).
Tailing cursors and the cache plane: tests/test_torch_stream_tail.py;
page-level parity and the Q1 view: tests/test_torch_stream_parity.py.
"""

import random
import sqlite3
import threading
import time

import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.stream import StreamConnector as RefStream
from presto_tpu.connectors.stream import (
    StreamWindowConnector as RefWindow,
)
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu.streaming import ivm as RIVM
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.stream import (
    StreamConnector,
    StreamWindowConnector,
)
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.streaming import ivm as IVM

PAGE_ROWS = 1 << 11
VIEW_SQL = ("select k, count(*), sum(v), max(v) from events "
            "group by k order by k")
COUNTERS = ("ivm_refreshes", "ivm_full_recomputes", "delta_pages_folded",
            "stream_appends_seen")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_shared_state():
    """Both engines' shared IVM registries are process-wide by design:
    no case leaks views into another."""
    for mod in (IVM, RIVM):
        reg = mod.shared_registry_if_exists()
        if reg is not None:
            for v in reg.views():
                reg.unregister(v.name)
    yield


def _seed_rows(n_rows: int, seed: int = 0, groups: int = 8):
    rng = random.Random(seed)
    return [(rng.randrange(groups), rng.random() * 100.0)
            for _ in range(n_rows)], rng


def _batch(rng, m: int, groups: int = 8):
    return [(rng.randrange(groups), rng.random() * 100.0)
            for _ in range(m)]


def _pair(n_rows: int, seed: int = 0, groups: int = 8):
    """(port connector, reference connector, rng) over the same log."""
    rows, rng = _seed_rows(n_rows, seed, groups)
    port = StreamConnector(device="cpu")
    port.create_table("events", ["k", "v"], [T.BIGINT, T.DOUBLE], rows)
    ref = RefStream()
    ref.create_table("events", ["k", "v"], [RT.BIGINT, RT.DOUBLE], rows)
    return port, ref, rng


def _runners(port, ref):
    return (LocalRunner({"stream": port}, default_catalog="stream",
                        page_rows=PAGE_ROWS, device="cpu"),
            RefRunner({"stream": ref}, default_catalog="stream",
                      page_rows=PAGE_ROWS))


def _append(conns, batch):
    return [c.append("events", batch) for c in conns]


def _rows_close(a, b, rel=1e-9):
    assert len(a) == len(b), f"{len(a)} vs {len(b)} rows"
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for va, vb in zip(ra, rb):
            if isinstance(va, float) or isinstance(vb, float):
                assert abs(float(va) - float(vb)) <= rel * max(
                    1.0, abs(float(vb))), (va, vb)
            else:
                assert va == vb, (va, vb)


def _counters(ex):
    return {n: getattr(ex, n) for n in COUNTERS}


def _sqlite(conn, sql):
    db = sqlite3.connect(":memory:")
    db.execute("create table events (k integer, v real)")
    db.executemany("insert into events values (?, ?)",
                   conn.host_rows("events"))
    return [tuple(r) for r in db.execute(sql).fetchall()]


def _register(runners, name, sql):
    port, ref = runners
    return (IVM.IvmRegistry().register(port, name, sql),
            RIVM.IvmRegistry().register(ref, name, sql))


def _refresh_both(views, runners):
    """Refresh the view in both engines; the port's rows, rows scanned
    and counters must equal the reference's."""
    got = IVM.refresh(views[0], session=runners[0].session,
                      sink=runners[0].executor)
    want = RIVM.refresh(views[1], session=runners[1].session,
                        sink=runners[1].executor)
    assert got[0] == want[0] and got[2] == want[2]
    _rows_close(got[1], want[1])
    assert views[0].last_delta_rows == views[1].last_delta_rows
    assert _counters(runners[0].executor) == _counters(runners[1].executor)
    return got[1]


# ------------------------------------------------- append-log connector
def test_append_advances_offset_and_token():
    port, ref, rng = _pair(100)
    for c in (port, ref):
        assert c.offset("events") == 100
        assert c.snapshot_version("events") == "off:100"
    batch = _batch(rng, 7)
    assert _append((port, ref), batch) == [107, 107]
    for c in (port, ref):
        assert c.snapshot_version("events") == "off:107"
        assert c.pinned_offset("events") is None
    assert port.appends_seen("events") == ref.appends_seen("events") == 2
    # the card by default: without one, the connector raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamConnector()


def test_delta_scan_emits_only_new_rows():
    port, ref, rng = _pair(500)
    base = port.offset("events")
    batch = _batch(rng, 23)
    _append((port, ref), batch)
    got = [r for p in port.scan_from("events", base) for r in p.to_pylist()]
    want = [r for p in ref.scan_from("events", base) for r in p.to_pylist()]
    assert got == want == batch
    # a delta scan from the head, or past it, is empty
    for c in (port, ref):
        assert list(c.scan_from("events", c.offset("events"))) == []
        assert list(c.scan_from("events", 10 ** 9)) == []


def test_full_scan_composes_with_engine_and_oracle():
    port, ref, _rng = _pair(1200)
    runners = _runners(port, ref)
    got = runners[0].execute(VIEW_SQL).rows
    _rows_close(got, runners[1].execute(VIEW_SQL).rows)
    _rows_close(got, _sqlite(port, VIEW_SQL))


def test_window_connector_pins_range():
    port, ref, rng = _pair(300)
    wins = (StreamWindowConnector(port, "events", 0, 300),
            RefWindow(ref, "events", 0, 300))
    for w in wins:
        assert w.row_count("events") == 300
        assert w.snapshot_version("events") == "off:300@0"
        assert w.pinned_offset("events") == 300
    _append((port, ref), _batch(rng, 50))
    for w in wins:
        # the pin holds while the log advances
        assert w.row_count("events") == 300
        assert w.snapshot_version("events") == "off:300@0"
        w.set_range(300, 350)
    got = [r for p in wins[0].pages("events") for r in p.to_pylist()]
    want = [r for p in wins[1].pages("events") for r in p.to_pylist()]
    assert got == want and len(got) == 50
    assert wins[0].host_rows("events") == want


def test_wait_for_offset_wakes_on_append():
    port, _ref, rng = _pair(10)
    got = {}

    def waiter():
        got["off"] = port.wait_for_offset("events", 10, 10.0)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    port.append("events", _batch(rng, 3))
    t.join(timeout=10)
    assert not t.is_alive()
    assert got["off"] == 13
    # the timeout path: no append, the current offset comes back
    t0 = time.monotonic()
    assert port.wait_for_offset("events", 13, 0.05) == 13
    assert time.monotonic() - t0 < 5


# ----------------------------------------------------- IVM: acceptance
def test_ivm_acceptance_pin():
    """Initial refresh over N rows, append M << N, refresh folds ONLY
    the delta: delta_pages_folded >= 1, ivm_full_recomputes == 0,
    scanned rows == M; the rows equal a cold recompute, sqlite and the
    reference, and so do the counters."""
    N, M = 4000, 64
    port, ref, rng = _pair(N)
    runners = _runners(port, ref)
    views = _register(runners, "dash", VIEW_SQL)
    assert views[0].ivm_safe, views[0].unsafe_reason
    rows1 = _refresh_both(views, runners)
    sink = runners[0].executor
    assert (sink.ivm_refreshes, sink.ivm_full_recomputes) == (1, 0)
    assert views[0].last_delta_rows == N

    _append((port, ref), _batch(rng, M))
    folded_before = sink.delta_pages_folded
    rows2 = _refresh_both(views, runners)
    assert sink.delta_pages_folded - folded_before >= 1
    assert (sink.ivm_refreshes, sink.ivm_full_recomputes) == (2, 0)
    assert views[0].last_delta_rows == M
    _rows_close(rows2, runners[0].execute(VIEW_SQL).rows)
    _rows_close(rows2, _sqlite(port, VIEW_SQL))
    assert rows1 != rows2  # the delta really changed the aggregates


def test_ivm_chain_append_refresh_repeatedly():
    port, ref, rng = _pair(1500)
    runners = _runners(port, ref)
    views = _register(runners, "chain", VIEW_SQL)
    _refresh_both(views, runners)  # the initial fold
    for i in range(4):
        _append((port, ref), _batch(rng, 37 + i))
        rows = _refresh_both(views, runners)
        _rows_close(rows, runners[0].execute(VIEW_SQL).rows)
        assert views[0].last_delta_rows == 37 + i
    sink = runners[0].executor
    assert (sink.ivm_refreshes, sink.ivm_full_recomputes) == (5, 0)


def test_refresh_without_new_data_serves_settled_result():
    port, ref, _rng = _pair(800)
    runners = _runners(port, ref)
    views = _register(runners, "idle", VIEW_SQL)
    rows1 = _refresh_both(views, runners)
    folded = runners[0].executor.delta_pages_folded
    rows2 = _refresh_both(views, runners)
    assert rows1 == rows2
    assert runners[0].executor.delta_pages_folded == folded  # no fold


# ------------------------------------------- IVM: counted fallback paths
def test_non_ivm_safe_global_agg_falls_back_loudly():
    port, ref, rng = _pair(600)
    runners = _runners(port, ref)
    sql = "select count(*), sum(v) from events"
    views = _register(runners, "glob", sql)
    assert not views[0].ivm_safe
    assert views[0].unsafe_reason == views[1].unsafe_reason
    assert "global aggregation" in views[0].unsafe_reason
    rows = _refresh_both(views, runners)
    sink = runners[0].executor
    assert (sink.ivm_full_recomputes, sink.ivm_refreshes) == (1, 0)
    _rows_close(rows, runners[0].execute(sql).rows)
    _append((port, ref), _batch(rng, 10))
    rows = _refresh_both(views, runners)
    assert sink.ivm_full_recomputes == 2
    _rows_close(rows, runners[0].execute(sql).rows)


def test_non_ivm_safe_join_falls_back_loudly():
    port, ref, _rng = _pair(300)
    runners = _runners(port, ref)
    sql = ("select a.k, count(*) from events a join events b "
           "on a.k = b.k group by a.k order by a.k")
    views = _register(runners, "joined", sql)
    assert not views[0].ivm_safe
    rows = _refresh_both(views, runners)
    assert runners[0].executor.ivm_full_recomputes == 1
    _rows_close(rows, runners[0].execute(sql).rows)


def test_ivm_disabled_forces_full_recompute():
    port, ref, rng = _pair(700)
    runners = _runners(port, ref)
    views = _register(runners, "gated", VIEW_SQL)
    assert views[0].ivm_safe
    for r in runners:
        r.session.set("ivm_enabled", False)
    rows = _refresh_both(views, runners)
    sink = runners[0].executor
    assert (sink.ivm_full_recomputes, sink.ivm_refreshes) == (1, 0)
    _rows_close(rows, runners[0].execute(VIEW_SQL).rows)
    # re-enabled, the view folds incrementally again (from offset 0)
    for r in runners:
        r.session.set("ivm_enabled", True)
    _append((port, ref), _batch(rng, 20))
    rows = _refresh_both(views, runners)
    assert sink.ivm_refreshes == 1
    assert views[0].last_delta_rows == 720
    _rows_close(rows, runners[0].execute(VIEW_SQL).rows)


def test_unsafe_reasons_are_specific():
    from presto_tpu.connectors.tpch import TpchConnector as RefTpch
    from presto_tpu_torch.connectors.tpch import TpchConnector

    port, ref, _rng = _pair(50)
    runners = _runners(port, ref)
    mods = (IVM, RIVM)
    for r, mod in zip(runners, mods):
        assert mod.ivm_unsafe_reason(r.plan(VIEW_SQL), r.catalogs) is None
    texts = [mod.ivm_unsafe_reason(
        r.plan("select array_agg(v) from events group by k"), r.catalogs)
        for r, mod in zip(runners, mods)]
    assert texts[0] == texts[1] and "array_agg" in texts[0]
    # non-stream tables never maintain incrementally
    q = ("select l_linestatus, count(*) from lineitem "
         "group by l_linestatus")
    tp = LocalRunner({"tpch": TpchConnector(0.01, device="cpu")},
                     page_rows=PAGE_ROWS, device="cpu")
    tr = RefRunner({"tpch": RefTpch(0.01)}, page_rows=PAGE_ROWS)
    texts = [mod.ivm_unsafe_reason(r.plan(q), r.catalogs)
             for r, mod in zip((tp, tr), mods)]
    assert texts[0] == texts[1] and "append-only" in texts[0]


def test_view_shape_match_is_offset_independent():
    port, ref, rng = _pair(400)
    runners = _runners(port, ref)
    regs = (IVM.IvmRegistry(), RIVM.IvmRegistry())
    views = [reg.register(r, "shape", VIEW_SQL)
             for reg, r in zip(regs, runners)]
    _append((port, ref), _batch(rng, 900))  # moves counts, capacities
    for reg, r, view in zip(regs, runners, views):
        assert reg.match(r.plan(VIEW_SQL)) is view
        assert reg.match(
            r.plan("select k, count(*) from events group by k")) is None
    for reg in regs:
        assert reg.unregister("shape") and reg.get("shape") is None
    # the fingerprint is the reference's: the same planned shape
    assert views[0].shape_fp == views[1].shape_fp


# ------------------------------------------------ hardened contracts
def test_failed_append_leaves_log_untouched():
    """A mid-batch arity error orphans no row below the offset: the
    whole batch validates before anything mutates."""
    port, ref, _rng = _pair(5)
    for c in (port, ref):
        with pytest.raises(ValueError):
            c.append("events", [(1, 2.0), (3,)])  # bad arity mid-batch
        assert c.offset("events") == 5
        assert len(c.host_rows("events")) == 5
        c.append("events", [(9, 9.0)])
        assert c.offset("events") == 6
        assert c.host_rows("events")[-1] == (9, 9.0)
    assert port.host_rows("events") == ref.host_rows("events")


def test_concurrent_full_refresh_never_regresses_watermark():
    """The losing concurrent refresher re-reads the log head after
    winning the _refreshing flag, so a full-recompute view never
    publishes an older snapshot over a newer one."""
    port, _ref, rng = _pair(300)
    r = LocalRunner({"stream": port}, default_catalog="stream",
                    page_rows=PAGE_ROWS, device="cpu")
    sql = "select count(*), sum(v) from events"  # unsafe: always full
    view = IVM.IvmRegistry().register(r, "race", sql)
    errors = []

    def refresher():
        try:
            for _ in range(5):
                IVM.refresh(view, session=r.session, sink=r.executor)
        except Exception as e:  # noqa: BLE001 - surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=refresher, daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
    for _ in range(6):
        port.append("events", _batch(rng, 11))
    for t in threads:
        t.join(timeout=60)
    assert not errors
    # the settled result covers the final offset exactly
    assert view.settled_offset() == port.offset("events")
    _n, rows, _t = IVM.refresh(view, session=r.session, sink=r.executor)
    _rows_close(rows, r.execute(sql).rows)
    assert r.executor.ivm_full_recomputes == 16


def _append_load(writers: int, readers: int, duration_s: float,
                 rows_per_append: int, seed: int = 0) -> dict:
    """tools/loadbench.run_append_load's mixed streaming mode on the
    port: ``writers`` threads advance a stream while ``readers``
    threads refresh a registered view through the IVM path; the
    registry counters come off the shared sink executor."""
    rng = random.Random(seed)
    conn = StreamConnector(device="cpu")
    conn.create_table("events", ["k", "v"], [T.BIGINT, T.DOUBLE],
                      [(rng.randrange(64), rng.random() * 100.0)
                       for _ in range(4 * rows_per_append)])
    runner = LocalRunner({"stream": conn}, default_catalog="stream",
                         page_rows=1 << 13, device="cpu")
    view = IVM.IvmRegistry().register(
        runner, "dash",
        "select k, count(*), sum(v) from events group by k order by k")
    sink = runner.executor
    IVM.refresh(view, session=runner.session, sink=sink)  # settle
    stop_at = time.time() + duration_s
    lock = threading.Lock()
    tally = {"appends": 0, "rows_appended": 0, "refreshes": 0,
             "errors": 0}

    def writer(idx: int) -> None:
        wrng = random.Random(seed * 1000 + idx)
        while time.time() < stop_at:
            batch = [(wrng.randrange(64), wrng.random() * 100.0)
                     for _ in range(rows_per_append)]
            try:
                conn.append("events", batch)
            except Exception:  # noqa: BLE001 - a load generator counts
                with lock:     # failures, it never crashes
                    tally["errors"] += 1
                continue
            sink.count_stream_append()
            with lock:
                tally["appends"] += 1
                tally["rows_appended"] += len(batch)
            time.sleep(0.01)  # leave the readers CPU to fold

    def reader(idx: int) -> None:
        while time.time() < stop_at:
            conn.wait_for_offset("events", view.settled_offset(), 0.2)
            try:
                IVM.refresh(view, session=runner.session, sink=sink)
            except Exception:  # noqa: BLE001 - a load generator counts
                with lock:     # failures, it never crashes
                    tally["errors"] += 1
                continue
            with lock:
                tally["refreshes"] += 1

    threads = ([threading.Thread(target=writer, args=(i,), daemon=True)
                for i in range(writers)]
               + [threading.Thread(target=reader, args=(i,), daemon=True)
                  for i in range(readers)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s * 4 + 60)
    # the last refresh covers every append: the rows equal a cold run
    _n, rows, _t = IVM.refresh(view, session=runner.session, sink=sink)
    cold = runner.execute(view.sql).rows
    return dict(tally, rows_match=len(rows) == len(cold) and all(
        a[:2] == b[:2] and abs(a[2] - b[2]) <= 1e-9 * max(1.0, abs(b[2]))
        for a, b in zip(rows, cold)),
        **{n: getattr(sink, n) for n in COUNTERS})


def test_loadbench_append_writers_smoke():
    out = _append_load(writers=1, readers=1, duration_s=1.2,
                       rows_per_append=64, seed=0)
    assert out["errors"] == 0
    assert out["appends"] >= 1
    assert out["ivm_refreshes"] >= 1
    assert out["ivm_full_recomputes"] == 0
    assert out["stream_appends_seen"] == out["appends"]
    assert out["rows_match"]
