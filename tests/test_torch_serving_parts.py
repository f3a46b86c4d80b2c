"""The serving plane's pure-Python parts against presto_tpu's classes, on
the same inputs: resource-group selection, queue-full, fair scheduling
with aging and memory shares; the latency histogram and its /metrics
text; the event SPI's dispatch with a raising listener, counted as
``listener_errors``; the heartbeat detector against a stub endpoint;
the etc/ config (``parse_properties``, ``load_catalogs``,
``server_from_etc``); the protocol's row rendering (``_json_row``,
``_render_decimal``); the group memory share; and the exchange wire and
connection-reuse totals the server's /metrics overlays."""

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from presto_tpu import events as REV
from presto_tpu.exec import membudget as RMB
from presto_tpu.obs import histo as RHISTO
from presto_tpu.server import heartbeat as RHB
from presto_tpu.server import http_server as RHTTP
from presto_tpu.server import resource_groups as RRG
from presto_tpu_torch import events as EV
from presto_tpu_torch.exec import membudget as MB
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.obs import histo as HISTO
from presto_tpu_torch.server import heartbeat as HB
from presto_tpu_torch.server import http_server as HTTP
from presto_tpu_torch.server import resource_groups as RG
from presto_tpu_torch.session import Session

ENGINES = {"port": (RG, HISTO, EV, HB), "ref": (RRG, RHISTO, REV, RHB)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------- resource groups

def _tree(mod):
    S = mod.ResourceGroupSpec
    return [S("global", ".*", hard_concurrency=2, max_queued=3,
              max_memory_bytes=1000, sub_groups=(
                  S("inter", "inter.*", hard_concurrency=1, max_queued=2,
                    priority=100, memory_share=0.25),
                  S("batch", "batch.*", hard_concurrency=1, max_queued=2),
                  S("adhoc", "(inter|adhoc).*", hard_concurrency=1,
                    max_queued=2, memory_share=0.5),
              )),
            S("fallback", "x.*", hard_concurrency=1, max_queued=1)]


USERS = ("inter0", "batch7", "adhoc", "interx", "x1", "nobody", "")


def _selections(mod):
    mgr = mod.ResourceGroupManager(_tree(mod))
    out = []
    for user in USERS:
        try:
            sel = mgr.select(user)
            out.append((sel.paths, sel.leaf.name,
                        mgr.memory_share_for(sel)))
        except mod.QueryQueueFullError as e:
            out.append(("error", str(e)))
    return out


def test_resource_group_selection_equals_reference():
    assert _selections(RG) == _selections(RRG)
    assert RG.ResourceGroupManager.AGING_PRIORITY_PER_S == \
        RRG.ResourceGroupManager.AGING_PRIORITY_PER_S


def _queue_fill(mod):
    """Admissions until each level's queue refuses, then the snapshot."""
    mgr = mod.ResourceGroupManager(_tree(mod))
    log = []
    for user in ("batch0", "batch1", "batch2", "inter0", "inter1",
                 "inter2", "x0", "x1"):
        try:
            mgr.admit(user)
            log.append((user, "ok"))
        except mod.QueryQueueFullError as e:
            log.append((user, str(e)))
    return log, mgr.snapshot()


def test_queue_full_equals_reference():
    got, want = _queue_fill(RG), _queue_fill(RRG)
    assert got == want
    assert any(r != "ok" for _u, r in got[0])


def _slots_and_memory(mod):
    mgr = mod.ResourceGroupManager(_tree(mod))
    a = mgr.admit("inter0")
    b = mgr.admit("batch0")
    c = mgr.admit("adhoc0")
    out = [mgr.acquire(a), mgr.acquire(b)]
    # the global level's concurrency (2) is now full: c cannot run
    out.append(mgr.acquire(c, should_abort=lambda: True))
    out.append(mgr.reserve_memory(a, 600))
    # 600 + 600 > the global quota (1000) with memory held: refused
    out.append(mgr.reserve_memory(b, 600, should_abort=lambda: True))
    out.append(mgr.snapshot())
    mgr.release_memory(a, 600)
    out.append(mgr.reserve_memory(b, 1500))  # alone: admitted
    mgr.release(a)
    mgr.release(b)
    mgr.release_memory(b, 1500)
    out.append(mgr.snapshot())
    return out


def test_slots_and_memory_quotas_equal_reference():
    assert _slots_and_memory(RG) == _slots_and_memory(RRG)


def _aging_front(mod):
    """Who is first in line: a fresh priority-100 waiter against a batch
    waiter queued long enough to have aged past it, and without aging."""
    mgr = mod.ResourceGroupManager(_tree(mod))
    inter, batch = mgr.select("inter0"), mgr.select("batch0")
    now = time.monotonic()
    out = []
    for age in (1000.0, 10.0):
        old = [batch, now - age, 1]
        new = [inter, now, 2]
        with mgr._lock:
            mgr._waiters[:] = [old, new]
            out.append((mgr._front_of_line_locked(old),
                        mgr._front_of_line_locked(new)))
            mgr._waiters[:] = []
    return out


def test_aging_order_equals_reference():
    got = _aging_front(RG)
    assert got == _aging_front(RRG)
    # aged 1000 s the batch waiter outranks priority 100; aged 10 s not
    assert got == [(True, False), (False, True)]


def _admission_order(mod):
    """One global slot held; batch0, batch1, then inter0 queue; the
    order in which the released slot passes on."""
    S = mod.ResourceGroupSpec
    mgr = mod.ResourceGroupManager([S("global", ".*", hard_concurrency=1,
                                      max_queued=8, sub_groups=(
        S("inter", "inter.*", hard_concurrency=1, max_queued=8,
          priority=100),
        S("batch", ".*", hard_concurrency=1, max_queued=8)))])
    holder = mgr.admit("batch_hold")
    assert mgr.acquire(holder)
    order = []
    lock = threading.Lock()

    def wait(user):
        sel = mgr.admit(user)
        assert mgr.acquire(sel)
        with lock:
            order.append(user)
        mgr.release(sel)

    threads = []
    for user in ("batch0", "batch1", "inter0"):
        t = threading.Thread(target=wait, args=(user,))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 30
        while len(mgr._waiters) < len(threads):
            assert time.monotonic() < deadline
            time.sleep(0.005)
    mgr.release(holder)
    for t in threads:
        t.join(timeout=30)
    return order


def test_priority_admission_order_equals_reference():
    got = _admission_order(RG)
    assert got == _admission_order(RRG)
    assert got[0] == "inter0"


def test_group_share_bytes_equals_reference():
    for share in (0.0, 2.0 ** -12, 0.25, 1.0):
        for setting in (0, 1 << 30):
            assert MB.group_share_bytes(share, setting, "cpu") == \
                RMB.group_share_bytes(share, setting, backend="cpu")
    assert MB.group_share_bytes(2.0 ** -12) == 1 << 24


# ---------------------------------------------------------- histogram

SAMPLES = (0.0, 0.0004, 0.001, 0.0011, 0.003, 0.02, 0.02, 0.3, 0.7, 1.5,
           4.0, 42.0, 700.0, -1.0)


@pytest.mark.parametrize("bounds", [None, (0.5, 0.01, 2.0)])
def test_histogram_equals_reference(bounds):
    kw = {} if bounds is None else {"bounds": bounds}
    got, want = HISTO.Histogram(**kw), RHISTO.Histogram(**kw)
    assert got.quantile(0.5) == want.quantile(0.5) == 0.0
    for v in SAMPLES:
        got.observe(v)
        want.observe(v)
    assert got.counts == want.counts and got.total == want.total
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q)
    assert got.prom_lines("presto_tpu_x") == want.prom_lines("presto_tpu_x")


# ------------------------------------------------------------- events

class _Recorder:
    def __init__(self):
        self.seen = []

    def query_created(self, e):
        self.seen.append(e)

    def query_completed(self, e):
        self.seen.append(e)


class _Thrower:
    def query_created(self, e):
        raise RuntimeError("listener bug")

    def query_completed(self, e):
        raise ValueError("listener bug")


@pytest.mark.parametrize("engine", ["port", "ref"])
def test_dispatch_swallows_and_counts_listener_errors(engine):
    ev = ENGINES[engine][2]
    errors = []
    rec = _Recorder()
    created = ev.QueryCreatedEvent("q1", "select 1", "u", 1.0)
    done = ev.QueryCompletedEvent("q1", "select 1", "u", "FINISHED", 1.0,
                                  2.0, 1000, 1)
    ev.dispatch([_Thrower(), rec], "query_created", created,
                on_error=lambda: errors.append(1))
    ev.dispatch([rec, _Thrower()], "query_completed", done,
                on_error=lambda: errors.append(1))
    # a sink that raises never fails the dispatch either
    ev.dispatch([_Thrower()], "query_created", created,
                on_error=lambda: 1 / 0)
    assert rec.seen == [created, done] and len(errors) == 2
    # the base listener's hooks are no-ops
    ev.dispatch([ev.EventListener()], "task_retried", None)


def test_event_records_equal_reference_fields():
    import dataclasses

    for name in ("QueryCreatedEvent", "QueryCompletedEvent",
                 "StageCompletedEvent", "TaskCompletedEvent",
                 "TaskRetryEvent"):
        got = [(f.name, f.default) for f in
               dataclasses.fields(getattr(EV, name))]
        want = [(f.name, f.default) for f in
                dataclasses.fields(getattr(REV, name))]
        assert got == want, name


def test_listener_errors_counter_on_the_executor():
    ex = Executor({}, device="cpu")
    EV.dispatch([_Thrower(), _Thrower()], "query_created",
                EV.QueryCreatedEvent("q", "s", "u", 0.0),
                on_error=ex.count_listener_error)
    assert ex.listener_errors == 2


# ---------------------------------------------------------- heartbeat

class _InfoHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive: the pool reuses sockets

    def log_message(self, *a):  # noqa: A003 - silence stderr
        pass

    def do_GET(self):
        ok = self.path == "/v1/info"
        body = json.dumps({"nodeId": "stub"}).encode()
        self.send_response(200 if ok else 404)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _stub(port=0):
    srv = ThreadingHTTPServer(("127.0.0.1", port), _InfoHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _states(det):
    return [(n["state"], n["consecutiveFailures"], n["successRate"])
            for n in det.snapshot()]


def test_heartbeat_state_changes_equal_reference():
    stub = _stub()
    uri = f"http://127.0.0.1:{stub.server_address[1]}"
    dets = [mod.HeartbeatFailureDetector([uri], fail_after=2,
                                         timeout_s=0.5)
            for mod in (HB, RHB)]
    seen = []
    dets[0].on_info = lambda u, info: seen.append((u, info))
    trail = []

    def step():
        for d in dets:
            d.check_once()
        trail.append([_states(d) for d in dets])

    step()
    assert seen == [(uri, {"nodeId": "stub"})]
    stub.shutdown()
    stub.server_close()
    step()  # one miss is not a failure
    step()
    revived = _stub(int(uri.rsplit(":", 1)[1]))
    try:
        step()
    finally:
        revived.shutdown()
        revived.server_close()
    for got, want in trail:
        assert got == want
    states = [t[0][0][0] for t in trail]
    assert states == ["ALIVE", "ALIVE", "FAILED", "ALIVE"]
    assert dets[0].snapshot()[0]["lastError"] is None
    dets[0].add_node("http://127.0.0.1:9")
    assert dets[0].alive_nodes() == [uri, "http://127.0.0.1:9"]
    assert dets[0].probe("http://127.0.0.1:9") is False
    assert dets[0].is_alive(uri)


# -------------------------------------------------------- row rendering

ROWS = [
    ((152969800, -5, 0, -123456789012345678901234567890, 7),
     ["decimal(12,2)", "decimal(12,2)", "decimal(12,2)", "decimal(38,4)",
      "decimal(10,0)"]),
    ((0, -1, 9131, -719162, 1234567890123), ["date", "date", "date", "date",
                                             "timestamp"]),
    ((None, None, None), ["bigint", "decimal(12,2)", "date"]),
    ((float("nan"), -0.0, 0.0, float("inf"), -1.5e300, 2.5),
     ["double"] * 6),
    ((True, False, 3, "x", "é"), ["boolean", "boolean", "bigint", "varchar",
                                  "varchar"]),
    (((1, None, 3), ((1, "a"), (2, "b")), ((1, (2, 3)), None)),
     ["array(bigint)", "map(bigint,varchar)", "array(array(bigint))"]),
    ((5, 1.0, b"\x01", None), None),
    ((7, 8), ["bigint"]),
]


@pytest.mark.parametrize("row,types", ROWS)
def test_json_row_equals_reference(row, types):
    got = HTTP._json_row(row, types)
    want = RHTTP._json_row(row, types)
    # NaN != NaN: compare the JSON text the protocol sends
    assert json.dumps(got) == json.dumps(want)


def test_render_decimal_equals_reference():
    for u in (0, 1, -1, 5, -5, 99, -100, 123456789, -(10 ** 30) - 7):
        for scale in (0, 1, 2, 4, 10):
            assert HTTP._render_decimal(u, scale) == \
                RHTTP._render_decimal(u, scale)
    assert HTTP._render_decimal(-5, 2) == "-0.05"
    assert math.isnan(HTTP._json_row((float("nan"),), ["double"])[0])


def test_session_snapshot_and_schema():
    s = Session("tpch", {"page_rows": 4096, "spill_path": "/x"},
                user="amy", schema="s1")
    snap = HTTP._session_snapshot(s)
    assert snap == {"user": "amy", "catalog": "tpch", "schema": "s1",
                    "values": {"page_rows": 4096, "spill_path": "/x"}}
    from presto_tpu.session import Session as RefSession

    ref = RefSession(user="amy", catalog="tpch", schema="s1",
                     properties={"page_rows": 4096, "spill_path": "/x"})
    assert snap == RHTTP._session_snapshot(ref)


def test_batching_properties_equal_reference():
    from presto_tpu.session import SYSTEM_SESSION_PROPERTIES as RP
    from presto_tpu_torch.session import SYSTEM_SESSION_PROPERTIES as PP

    for name in ("cross_query_batching", "cross_query_batch_wait_ms",
                 "stream_tail_enabled"):
        assert (PP[name].type, PP[name].default) == \
            (RP[name].type, RP[name].default), name
    s = Session(properties={"cross_query_batching": "TRUE",
                            "cross_query_batch_wait_ms": "50"})
    assert s.get("cross_query_batching") == "true"
    assert s.get("cross_query_batch_wait_ms") == 50
    with pytest.raises(ValueError):
        s.set("cross_query_batching", "sometimes")
    with pytest.raises(NotImplementedError, match="queue 5"):
        s.set("stream_tail_enabled", "true")


# ---------------------------------------------------- wire and pool totals

def test_wire_totals_equal_reference_and_meter_the_sink():
    import numpy as np

    from presto_tpu import types as RT
    from presto_tpu.dist import serde as RSERDE
    from presto_tpu.page import Page as RefPage
    from presto_tpu_torch import types as T
    from presto_tpu_torch.dist import serde as SERDE
    from presto_tpu_torch.exec import xfer as XF
    from presto_tpu_torch.page import Page

    cols = [list(range(300)), [None if i % 5 == 0 else f"s{i % 7}"
                               for i in range(300)]]
    port = Page.from_arrays(cols, [T.BIGINT, T.VARCHAR], capacity=512,
                            device="cpu")
    ref = RefPage.from_arrays(cols, [RT.BIGINT, RT.VARCHAR], capacity=512)
    ex = Executor({}, device="cpu")
    got0, want0 = SERDE.wire_totals(), RSERDE.wire_totals()
    prev = XF.swap_sink(ex)
    try:
        blob = SERDE.serialize_page(port)
    finally:
        XF.swap_sink(prev)
    assert blob == RSERDE.serialize_page(ref)
    got, want = SERDE.wire_totals(), RSERDE.wire_totals()
    delta = {k: got[k] - got0[k] for k in got}
    assert delta == {k: want[k] - want0[k] for k in want}
    assert delta["exchange_wire_bytes"] == len(blob)
    assert delta["exchange_raw_bytes"] == int(
        sum(np.asarray(a).nbytes for a in (
            port.blocks[0].data, port.blocks[1].data,
            port.blocks[1].nulls, port.valid)))
    assert (ex.exchange_wire_bytes, ex.exchange_raw_bytes) == (
        delta["exchange_wire_bytes"], delta["exchange_raw_bytes"])


def test_pool_totals_count_reused_connections():
    from presto_tpu.dist import connpool as RPOOL
    from presto_tpu_torch.dist import connpool as POOL
    from presto_tpu_torch.exec import xfer as XF

    stub = _stub()
    url = f"http://127.0.0.1:{stub.server_address[1]}/v1/info"
    ex = Executor({}, device="cpu")
    deltas = []
    try:
        for mod, sink in ((POOL, ex), (RPOOL, None)):
            before = mod.pool_totals()
            prev = XF.swap_sink(sink) if sink is not None else None
            try:
                for _ in range(3):
                    with mod.request(url) as resp:
                        assert resp.status == 200
                        resp.read()
            finally:
                if sink is not None:
                    XF.swap_sink(prev)
            after = mod.pool_totals()
            deltas.append({k: after[k] - before[k] for k in after})
    finally:
        stub.shutdown()
        stub.server_close()
    assert deltas[0] == deltas[1]
    assert deltas[0]["exchange_fetch_reused_conns"] == 2
    assert ex.exchange_fetch_reused_conns == 2


# ------------------------------------------------------------- config

def _etc(tmp_path, conf, catalogs):
    (tmp_path / "catalog").mkdir()
    (tmp_path / "config.properties").write_text(conf)
    for name, text in catalogs.items():
        (tmp_path / "catalog" / f"{name}.properties").write_text(text)
    return str(tmp_path)


CONF = """# coordinator
http-server.http.port=0
! a bang comment
query.max-memory-bytes = 268435456
page-rows=4096
split-batch.size=64
cross-query-batching=false
task-retry.attempts=0
result-cache.enabled=true
"""
CATALOGS = {
    "tpch": "connector.name=tpch\ntpch.scale-factor=0.001\n",
    "mem": "connector.name=memory\n",
    "sink": "connector.name=blackhole\n",
}


def test_parse_properties_and_catalogs_equal_reference(tmp_path):
    from presto_tpu import config as RCONF
    from presto_tpu_torch import config as CONF_

    etc = _etc(tmp_path, CONF, CATALOGS)
    path = f"{etc}/config.properties"
    assert CONF_.parse_properties(path) == RCONF.parse_properties(path)
    assert CONF_.load_node_config(etc) == RCONF.load_node_config(etc)
    got = CONF_.load_catalogs(etc, device="cpu")
    want = RCONF.load_catalogs(etc)
    assert {k: type(v).__name__ for k, v in got.items()} == \
        {k: type(v).__name__ for k, v in want.items()}
    assert got["tpch"].scale == want["tpch"].scale == 0.001
    (tmp_path / "bad.properties").write_text("no equals sign\n")
    for mod in (CONF_, RCONF):
        with pytest.raises(ValueError, match="expected key=value"):
            mod.parse_properties(str(tmp_path / "bad.properties"))


def test_etc_keys_are_the_references_for_the_ported_properties():
    from presto_tpu import config as RCONF
    from presto_tpu_torch import config as CONF_
    from presto_tpu_torch.session import SYSTEM_SESSION_PROPERTIES

    assert set(CONF_.ETC_SESSION_KEYS.values()) == \
        set(SYSTEM_SESSION_PROPERTIES)
    for key, prop in CONF_.ETC_SESSION_KEYS.items():
        assert RCONF.ETC_SESSION_KEYS[key] == prop


def test_server_from_etc_equals_reference(tmp_path):
    from presto_tpu import config as RCONF
    from presto_tpu_torch import config as CONF_
    from presto_tpu_torch.session import SYSTEM_SESSION_PROPERTIES

    etc = _etc(tmp_path, CONF, CATALOGS)
    got = CONF_.server_from_etc(etc, device="cpu")
    want = RCONF.server_from_etc(etc)
    # the reference also seeds properties the port does not have
    assert got.session_defaults == {
        k: v for k, v in want.session_defaults.items()
        if k in SYSTEM_SESSION_PROPERTIES}
    assert got.session_defaults["split_batch_size"] == "64"
    assert (got.port, got._page_rows, got._default_catalog) == \
        (want.port, want._page_rows, want._default_catalog)
    assert got.manager.memory.total == want.manager.memory.total
    # the card by default: no card here, so it raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CONF_.server_from_etc(etc)


@pytest.mark.parametrize("conf,catalogs,match", [
    ("compile-cache.dir=/tmp/c\n", CATALOGS, "compile"),
    ("", {"s": "connector.name=stream\n"}, "queue 5"),
])
def test_etc_unported_planes_raise(tmp_path, conf, catalogs, match):
    from presto_tpu_torch import config as CONF_

    etc = _etc(tmp_path, conf, catalogs)
    with pytest.raises(NotImplementedError, match=match):
        CONF_.server_from_etc(etc, device="cpu")


def test_etc_unknown_connector_and_missing_catalogs(tmp_path):
    from presto_tpu_torch import config as CONF_

    etc = _etc(tmp_path, "", {"z": "connector.name=nosuch\n"})
    with pytest.raises(ValueError, match="unknown connector.name"):
        CONF_.load_catalogs(etc, device="cpu")
    with pytest.raises(ValueError, match="no catalogs"):
        CONF_.server_from_etc(str(tmp_path / "nowhere"), device="cpu")


# ------------------------------------------------- the arbiter's estimate

@pytest.fixture(scope="module")
def estimators():
    """Planning-only runners at SF 1 (estimate_memory plans and never
    executes these queries)."""
    from presto_tpu.connectors.tpch import TpchConnector as RefTpch
    from presto_tpu.runner import LocalRunner as RefRunner
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.runner import LocalRunner

    return (LocalRunner({"tpch": TpchConnector(1.0, device="cpu")},
                        device="cpu", page_rows=1 << 20),
            RefRunner({"tpch": RefTpch(1.0)}, page_rows=1 << 20))


@pytest.mark.parametrize("q", [1, 3, 5, 6, 9, 18, 21])
def test_estimate_memory_equals_reference(q, estimators):
    from presto_tpu_torch import queries as PQ

    port, ref = estimators
    assert port.estimate_memory(PQ.TPCH_SQL[q]) == \
        ref.estimate_memory(PQ.TPCH_SQL[q])


def test_estimate_memory_floor_for_statements(estimators):
    port, ref = estimators
    for text in ("set session page_rows = 4096", "selec 1",
                 "show tables"):
        assert port.estimate_memory(text) == ref.estimate_memory(text) \
            == 1 << 24
