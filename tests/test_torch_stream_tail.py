"""The streaming plane, part 2: monotone offset tokens in the result
cache and tailing /v1/statement cursors (presto_tpu_torch/server/
http_server.py TailCursor), against presto_tpu.

The counterparts of tests/test_streaming.py's cache cases (a pinned
entry hits while the log grows, an INSERT reclaims only live-head
entries, a view's entry advances in place) and its tailing-cursor
cases (exactly the delta per poll, the IVM path for a registered view,
a non-stream statement that ignores the flag, one appender racing four
tailers at zero sanitizer violations, the counters on every surface,
recompute mode over two streams, the retry horizon), plus the
counterpart of tests/test_cache_persist.py's watermark round trip,
one tail sequence sent to both engines' servers, which must deliver
equal rows, a tail's resource-group slot, and a mesh server, which
tails nothing. The servers are module-scoped (one port, one reference)
with ``stream_poll_ms`` at most 400; each case tails tables of its own.
"""

import collections
import itertools
import json
import random
import threading
import urllib.request

import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.cache import shared_cache_if_exists as ref_shared
from presto_tpu.connectors.stream import StreamConnector as RefStream
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu.streaming import ivm as RIVM
from presto_tpu_torch import types as T
from presto_tpu_torch.cache import ResultCache
from presto_tpu_torch.cache import shared_cache_if_exists
from presto_tpu_torch.connectors.stream import StreamConnector
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.streaming import ivm as IVM

PAGE_ROWS = 1 << 11
VIEW_SQL = ("select k, count(*), sum(v), max(v) from events "
            "group by k order by k")
_names = itertools.count()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clear():
    for rc in (shared_cache_if_exists(), ref_shared()):
        if rc is not None:
            rc.clear()
    for mod in (IVM, RIVM):
        reg = mod.shared_registry_if_exists()
        if reg is not None:
            for v in reg.views():
                reg.unregister(v.name)


@pytest.fixture(autouse=True)
def _clean_shared_state():
    """The result caches and IVM registries are process-shared by
    design: no case leaks entries or views into another."""
    _clear()
    yield
    _clear()


def _rows(n_rows, seed=0, groups=8):
    rng = random.Random(seed)
    return [(rng.randrange(groups), rng.random() * 100.0)
            for _ in range(n_rows)], rng


def _batch(rng, m, groups=8):
    return [(rng.randrange(groups), rng.random() * 100.0)
            for _ in range(m)]


def _pair(n_rows, seed=0):
    rows, rng = _rows(n_rows, seed)
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


def _rows_close(a, b, rel=1e-9):
    assert len(a) == len(b), f"{len(a)} vs {len(b)} rows"
    for ra, rb in zip(a, b):
        for va, vb in zip(ra, rb):
            if isinstance(va, float) or isinstance(vb, float):
                assert abs(float(va) - float(vb)) <= rel * max(
                    1.0, abs(float(vb))), (va, vb)
            else:
                assert va == vb, (va, vb)


# ------------------------------------- monotone offset tokens (cache)
def test_pinned_offset_entry_hits_while_log_advances():
    """A stream-scan fragment entry at offset N still HITS for a reader
    pinned at N after the log advanced: the append path reclaims only
    live-head entries."""
    from presto_tpu.cache import ResultCache as RefCache

    port, ref, _rng = _pair(1000)
    N = port.offset("events")
    got = []
    for conn, mod, cache, runner in zip(
            (port, ref), (IVM, RIVM), (ResultCache, RefCache),
            _runners(port, ref)):
        ex, window = mod.windowed_executor(
            {"stream": conn}, "stream", "events", like=None)
        window.set_range(0, N)
        ex.result_cache = cache()
        plan = runner.plan(VIEW_SQL)
        _n, rows1 = ex.execute(plan)
        assert ex.result_cache_misses >= 1
        key = next(iter(ex.result_cache._entries))
        assert ex.result_cache.entry_watermark(key) == N
        # the log advances: only live-head entries reclaim
        assert ex.result_cache.advance_tables({("stream", "events")}) == 0
        conn.append("events", [(1, 5.0)])
        _n, rows2 = ex.execute(plan)  # still pinned at N
        assert ex.result_cache_hits >= 1
        assert rows1 == rows2
        got.append((rows2, ex.result_cache_hits, ex.result_cache_misses))
    _rows_close(got[0][0], got[1][0])
    assert got[0][1:] == got[1][1:]


def test_live_head_entry_reclaimed_on_insert_advance():
    port, ref, _rng = _pair(400)
    out = []
    for r in _runners(port, ref):
        r.session.set("result_cache_enabled", True)
        r.apply_session()
        rc = r.executor.result_cache
        r.execute(VIEW_SQL)  # live-head entries (no watermark)
        assert rc.entry_count >= 1
        assert all(rc.entry_watermark(k) is None for k in list(rc._entries))
        before = r.executor.stream_appends_seen
        r.execute("insert into events select 3, 7.5")
        # the advance reclaimed the unreachable live-head entries and
        # counted the observed append batch
        assert rc.entry_count == 0
        assert r.executor.stream_appends_seen == before + 1
        out.append((r.execute(VIEW_SQL).rows, rc.invalidations,
                    r.executor.result_cache_invalidations))
    _rows_close(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]
    assert port.host_rows("events")[-1] == ref.host_rows("events")[-1]


def test_view_cache_entry_advances_in_place():
    port, ref, rng = _pair(500)
    batch = _batch(rng, 25)
    marks = []
    for r, conn, mod in zip(_runners(port, ref), (port, ref), (IVM, RIVM)):
        r.session.set("result_cache_enabled", True)
        r.apply_session()
        rc = r.executor.result_cache
        view = mod.IvmRegistry().register(r, "cached", VIEW_SQL)
        mod.refresh(view, session=r.session, sink=r.executor)
        assert rc.entry_watermark(view.cache_key) == 500
        inv_before = rc.invalidations
        conn.append("events", batch)
        r._invalidate_caches("stream", "events", append=True)
        # the watermarked view entry SURVIVED the append ...
        assert rc.entry_watermark(view.cache_key) == 500
        _n, rows, _t = mod.refresh(view, session=r.session,
                                   sink=r.executor)
        # ... and the refresh ADVANCED it in place, not by invalidation
        assert rc.entry_watermark(view.cache_key) == 525
        assert rc.invalidations == inv_before
        assert rc.get_rows(view.cache_key)[1] == rows
        marks.append((rows, r.executor.stream_appends_seen))
    _rows_close(marks[0][0], marks[1][0])
    assert marks[0][1] == marks[1][1] == 1


def test_stream_watermark_survives_roundtrip(tmp_path):
    """Watermarks ride the manifest: a pinned-prefix entry re-admits
    with its append-log offset intact (tests/test_cache_persist.py's
    case)."""
    from presto_tpu_torch.cache.rules import snapshot_of
    from presto_tpu_torch.connectors.tpch import TpchConnector

    conn = TpchConnector(0.01, device="cpu")
    d = str(tmp_path / "rc")
    rc1 = ResultCache()
    rc1.configure(persist_dir=d)
    r = LocalRunner({"tpch": conn}, page_rows=PAGE_ROWS, device="cpu")
    plan = r.plan("select l_returnflag from lineitem where l_quantity < 1")
    pages = list(r.executor.pages(plan))
    snap = (("tpch", "lineitem", snapshot_of(conn, "lineitem")),)
    rc1.put_pages("frag:wmtest:k1.p1", pages,
                  frozenset({("tpch", "lineitem")}), watermark=4096,
                  snap=snap)
    assert rc1.entry_count == 1
    rc2 = ResultCache()
    rc2.configure(persist_dir=d)
    assert rc2.warm_load({"tpch": conn}) == (1, 0)
    with rc2._lock:
        e = rc2._entries["frag:wmtest:k1.p1"]
        assert e.watermark == 4096
        assert e.snap == snap
    rc1.configure(persist_dir="")
    rc2.configure(persist_dir="")


# --------------------------------------------------- tailing cursors
def _req(url, data=None, method="GET", tail=True, poll_ms=400):
    h = {"X-Presto-User": "tailer", "X-Presto-Catalog": "stream"}
    if tail:
        h["X-Presto-Session"] = (
            f"stream_tail_enabled=true,stream_poll_ms={poll_ms}")
    req = urllib.request.Request(url, data=data, headers=h, method=method)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())


@pytest.fixture(scope="module")
def servers():
    """One port server and one reference server, each over a stream
    connector of its own; every case creates its own tables."""
    from presto_tpu.server.http_server import PrestoTpuServer as RefServer
    from presto_tpu_torch.server.http_server import PrestoTpuServer

    port_conn = StreamConnector(device="cpu")
    ref_conn = RefStream()
    port_conn.create_table("seed", ["x"], [T.BIGINT], [(1,)])
    ref_conn.create_table("seed", ["x"], [RT.BIGINT], [(1,)])
    srv = PrestoTpuServer({"stream": port_conn}, default_catalog="stream",
                          port=0, device="cpu")
    ref = RefServer({"stream": ref_conn}, default_catalog="stream",
                    port=0)
    srv.start()
    ref.start()
    try:
        yield ((srv, port_conn, f"http://127.0.0.1:{srv.port}"),
               (ref, ref_conn, f"http://127.0.0.1:{ref.port}"))
    finally:
        srv.stop()
        ref.stop()


def _table(conn, n_rows=60, groups=4, seed=0, types=(T.BIGINT, T.DOUBLE)):
    """A fresh stream table of ``n_rows`` seeded rows: (name, rng)."""
    name = f"events{next(_names)}"
    rows, rng = _rows(n_rows, seed, groups)
    conn.create_table(name, ["k", "v"], list(types), rows)
    return name, rng


def test_tail_cursor_delivers_exactly_the_delta(servers):
    (srv, conn, base), _ref = servers
    t, _rng = _table(conn)
    b = _req(f"{base}/v1/statement",
             f"select k, v from {t} where k = 1".encode(), "POST")
    assert b["stats"]["state"] == "RUNNING" and "nextUri" in b
    initial = b.get("data", [])
    assert initial and all(row[0] == 1 for row in initial)
    # an idle poll: an empty page with a fresh nextUri (the heartbeat)
    b2 = _req(b["nextUri"], poll_ms=100)
    assert "data" not in b2 and "nextUri" in b2
    conn.append(t, [(1, 999.5), (2, 1.0), (1, 123.25)])
    before = srv._runner.executor.stream_appends_seen
    b3 = _req(b2["nextUri"])
    assert b3.get("data") == [[1, 999.5], [1, 123.25]]
    assert srv._runner.executor.stream_appends_seen > before
    # a retried token re-serves its span verbatim
    assert _req(b2["nextUri"]).get("data") == b3["data"]
    # DELETE ends the cursor: no nextUri on the next page
    _req(f"{base}/v1/statement/{b['id']}", method="DELETE", tail=False)
    b4 = _req(b3["nextUri"])
    assert "nextUri" not in b4 and b4["stats"]["state"] == "CANCELED"


def test_tail_cursor_rides_ivm_for_registered_view(servers):
    (srv, conn, base), _ref = servers
    t, _rng = _table(conn)
    sql = f"select k, count(*), sum(v) from {t} group by k order by k"
    IVM.shared_registry().register(srv._runner, "live", sql)
    ex = srv._runner.executor
    c0 = {n: getattr(ex, n) for n in ("ivm_refreshes", "delta_pages_folded",
                                      "ivm_full_recomputes",
                                      "cursor_polls")}
    b = _req(f"{base}/v1/statement", sql.encode(), "POST")
    assert len(b["data"]) == 4  # the whole initial snapshot
    assert ex.ivm_refreshes > c0["ivm_refreshes"]
    conn.append(t, [(0, 10.0), (0, 20.0)])
    b2 = _req(b["nextUri"])
    # only the CHANGED aggregate row arrives, computed incrementally
    assert len(b2["data"]) == 1 and b2["data"][0][0] == 0
    assert ex.delta_pages_folded > c0["delta_pages_folded"]
    assert ex.ivm_full_recomputes == c0["ivm_full_recomputes"]
    assert ex.cursor_polls >= c0["cursor_polls"] + 2
    _req(f"{base}/v1/statement/{b['id']}", method="DELETE", tail=False)


def test_non_stream_statement_ignores_tail_flag(servers):
    (_srv, _conn, base), _ref = servers
    b = _req(f"{base}/v1/statement", b"select 1", "POST")
    # falls through to the normal protocol: the query FINISHES
    for _ in range(50):
        if "nextUri" not in b:
            break
        b = _req(b["nextUri"])
    assert b["stats"]["state"] == "FINISHED" and b["data"] == [[1]]


def test_concurrent_appender_and_four_tailers(servers):
    """One appender races 4 tailing protocol clients: every client
    receives every log row exactly once (initial snapshot + deltas) and
    the armed lock sanitizer records ZERO violations."""
    from presto_tpu_torch.obs import sanitizer as san

    (srv, conn, base), _ref = servers
    t, rng = _table(conn)
    violations_before = san.violation_count()
    polls_before = srv._runner.executor.cursor_polls
    seed_rows = conn.host_rows(t)
    batches = [[(rng.randrange(4), 1000.0 + i * 100 + j)
                for j in range(25)] for i in range(8)]
    total = len(seed_rows) + sum(len(b) for b in batches)
    results = {}

    def tailer(idx):
        got = []
        b = _req(f"{base}/v1/statement", f"select k, v from {t}".encode(),
                 "POST", poll_ms=250)
        got.extend(b.get("data", []))
        while len(got) < total and "nextUri" in b:
            b = _req(b["nextUri"], poll_ms=250)
            got.extend(b.get("data", []))
        results[idx] = (got, b["id"])

    threads = [threading.Thread(target=tailer, args=(i,), daemon=True)
               for i in range(4)]
    for th in threads:
        th.start()

    def appender():
        for batch in batches:
            conn.append(t, batch)

    a = threading.Thread(target=appender, daemon=True)
    a.start()
    a.join(timeout=30)
    for th in threads:
        th.join(timeout=60)
    assert all(not th.is_alive() for th in threads)
    want = collections.Counter(
        (int(k), float(v))
        for k, v in seed_rows + [r for b in batches for r in b])
    for idx, (got, qid) in results.items():
        assert collections.Counter(
            (int(k), float(v)) for k, v in got) == want, (
            f"tailer {idx} row multiset diverged")
        _req(f"{base}/v1/statement/{qid}", method="DELETE", tail=False)
    assert san.violation_count() == violations_before
    assert srv._runner.executor.cursor_polls >= polls_before + 4


def test_counters_registered_and_surfaced(servers):
    from presto_tpu.exec import counters as RCTRS
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.exec import counters as CTRS

    names = ("delta_pages_folded", "ivm_refreshes", "ivm_full_recomputes",
             "cursor_polls", "stream_appends_seen")
    for name in names:
        assert CTRS.QUERY_COUNTERS[name] == RCTRS.QUERY_COUNTERS[name]
    (srv, _conn, base), _ref = servers
    snap = CTRS.snapshot(srv._runner.executor)
    assert all(n in snap for n in names)
    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
        text = r.read().decode()
    for name in names:
        assert f"presto_tpu_{name}_total" in text
    rows = StatementClient(base, catalog="stream").execute(
        "select name from system.metrics").rows
    assert {n for n in names} <= {r[0] for r in rows}
    line = StatementClient(base, catalog="stream").execute(
        "explain analyze select count(*) from seed").rows[-1][0]
    assert all(f"{n}=" in line for n in names)


def test_tail_recompute_watches_every_scanned_stream(servers):
    """A cursor over a statement scanning TWO streams delivers rows
    when EITHER advances (the recompute mode's multi-stream poll)."""
    (_srv, conn, base), _ref = servers
    t, _rng = _table(conn)
    d = f"dims{next(_names)}"
    conn.create_table(d, ["k", "name"], [T.BIGINT, T.VARCHAR],
                      [(i, f"g{i}") for i in range(4)])
    sql = (f"select d.name, count(*) from {t} e join {d} d "
           f"on e.k = d.k group by d.name order by d.name")
    b = _req(f"{base}/v1/statement", sql.encode(), "POST")
    assert "nextUri" in b and b.get("data")
    # an append to the SECOND stream (the dimension): g3b duplicates
    # k = 3, a fifth group
    conn.append(d, [(3, "g3b")])
    b2 = _req(b["nextUri"])
    assert b2.get("data"), "an append to the non-primary stream was lost"
    assert any(row[0] == "g3b" for row in b2["data"])
    _req(f"{base}/v1/statement/{b['id']}", method="DELETE", tail=False)


def test_tail_cursor_memory_stays_bounded(servers):
    """The never-finishing cursor trims rows past the retry horizon
    instead of retaining everything it ever emitted."""
    from presto_tpu_torch.server.http_server import _TAIL_RETAIN_SPANS

    (srv, conn, base), _ref = servers
    t, rng = _table(conn)
    b = _req(f"{base}/v1/statement", f"select k, v from {t}".encode(),
             "POST", poll_ms=100)
    qid = b["id"]
    q = srv.manager.get(qid)
    total = len(b.get("data", []))
    for _ in range(_TAIL_RETAIN_SPANS + 6):
        conn.append(t, _batch(rng, 30, groups=4))
        b = _req(b["nextUri"], poll_ms=400)
        total += len(b.get("data", []))
    # every appended row was delivered exactly once ...
    assert total == conn.offset(t)
    # ... but the cursor retains only the retry horizon
    assert len(q.tail.rows) < total
    assert q.tail.spans_served() == _TAIL_RETAIN_SPANS + 7
    _req(f"{base}/v1/statement/{qid}", method="DELETE", tail=False)


def test_tail_sequence_equals_the_reference(servers):
    """One tail sequence — a delta cursor, a view cursor over a view
    registered in each engine's shared registry, three appends of the
    same rows — sent to both servers delivers equal rows per page."""
    pages = []
    for (srv, conn, base), mod in zip(servers, (IVM, RIVM)):
        t = "paritytail"
        rows, rng = _rows(200, seed=7, groups=5)
        conn.create_table(t, ["k", "v"], [T.BIGINT, T.DOUBLE]
                          if mod is IVM else [RT.BIGINT, RT.DOUBLE], rows)
        view_sql = (f"select k, count(*), sum(v), max(v) from {t} "
                    f"group by k order by k")
        mod.shared_registry().register(srv._runner, "parity", view_sql)
        got = []
        cursors = [_req(f"{base}/v1/statement",
                        f"select k, v from {t} where k < 2".encode(),
                        "POST"),
                   _req(f"{base}/v1/statement", view_sql.encode(), "POST")]
        got.append([c.get("data", []) for c in cursors])
        for i in range(3):
            conn.append(t, _batch(rng, 17 + i, groups=5))
            cursors = [_req(c["nextUri"]) for c in cursors]
            got.append([c.get("data", []) for c in cursors])
        for c in cursors:
            _req(f"{base}/v1/statement/{c['id']}", method="DELETE",
                 tail=False)
        conn.drop_table(t)
        pages.append(got)
    port, ref = pages
    assert len(port) == len(ref) == 4
    for p_step, r_step in zip(port, ref):
        for p_rows, r_rows in zip(p_step, r_step):
            _rows_close([tuple(r) for r in p_rows],
                        [tuple(r) for r in r_rows])
    assert all(step[0] for step in port[1:])  # each append reached both


def test_tail_admission_holds_a_resource_group_slot():
    """A tailing statement passes the resource-group gate: it holds a
    queue slot until DELETE closes it, so a full queue refuses the next
    tail with QUERY_QUEUE_FULL (HTTP 429)."""
    import urllib.error

    from presto_tpu_torch.server.http_server import PrestoTpuServer
    from presto_tpu_torch.server.resource_groups import (
        ResourceGroupManager,
        ResourceGroupSpec,
    )

    conn = StreamConnector(device="cpu")
    t, _rng = _table(conn)
    rg = ResourceGroupManager([ResourceGroupSpec("global", ".*",
                                                 max_queued=1)])
    srv = PrestoTpuServer({"stream": conn}, default_catalog="stream",
                          port=0, device="cpu", resource_groups=rg)
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        sql = f"select k, v from {t}".encode()
        first = _req(f"{base}/v1/statement", sql, "POST")
        assert "nextUri" in first
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(f"{base}/v1/statement", sql, "POST")
        assert e.value.code == 429
        assert json.loads(e.value.read())["error"]["errorName"] == \
            "QUERY_QUEUE_FULL"
        _req(f"{base}/v1/statement/{first['id']}", method="DELETE",
             tail=False)
        again = _req(f"{base}/v1/statement", sql, "POST")
        assert "nextUri" in again and again["data"]
        _req(f"{base}/v1/statement/{again['id']}", method="DELETE",
             tail=False)
    finally:
        srv.stop()


def test_mesh_server_tails_nothing():
    """The cursors ride the local executor: a mesh server tails nothing,
    and a statement over a stream runs to FINISHED there (the
    reference's answer)."""
    from presto_tpu_torch.dist.executor import make_mesh
    from presto_tpu_torch.server.http_server import PrestoTpuServer

    conn = StreamConnector(device="cpu")
    t, _rng = _table(conn, n_rows=20)
    srv = PrestoTpuServer({"stream": conn}, default_catalog="stream",
                          port=0, device="cpu",
                          mesh=make_mesh(2, device="cpu"))
    session = srv._runner.session
    assert srv.make_tail_cursor(f"select k from {t}", session) is None
    assert srv.start_tail(f"select k from {t}", session) is None
    base = f"http://127.0.0.1:{srv.start()}"
    try:
        b = _req(f"{base}/v1/statement", f"select count(*) from {t}"
                 .encode(), "POST")
        for _ in range(50):
            if "nextUri" not in b:
                break
            b = _req(b["nextUri"])
        assert b["stats"]["state"] == "FINISHED" and b["data"] == [[20]]
    finally:
        srv.stop()
