"""Query tracing and the observed-stats profile store (presto_tpu_torch/
obs/): the port against presto_tpu.

Tracing, on TPC-H SF 0.01 with the kernel dispatch points off and
nothing fused (``tpu_offload_enabled=false``, so neither engine stages
split descriptors):

  - the span tree of a local query equals the reference's in kinds,
    names and nesting;
  - with tracing off, no spans are recorded (``trace_spans`` 0);
  - a ``query_trace_dir`` run writes a valid Chrome-trace file whose
    span kinds are all declared in SPAN_KINDS;
  - control statements write no trace, and an unwritable directory
    never fails the query;
  - a three-stage DcnRunner DAG traces stage, task, dispatch and fetch
    spans with the workers' queue and run spans ingested under their
    task;
  - ``ingest`` clamps clock skew;
  - every span kind the port emits is declared and every declared kind
    has an emission site (an AST sweep).

The profile store: it round-trips; a query that took a boost retry
starts its repeat from its profile with 0 retries and equal rows; and
``plan_fingerprint`` equals the reference's for the 21 TPC-H plans
other than Q11.
"""

import ast
import collections
import json
import os

import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.obs import profile as RPROF
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import obs as OBS
from presto_tpu_torch import queries as PQ
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.dcn import DcnRunner
from presto_tpu_torch.obs import profile as PROF
from presto_tpu_torch.obs.trace import QueryTrace, critical_path
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server.worker import WorkerServer

SF = 0.01
PAGE_ROWS = 1 << 13
SESSION = {"page_rows": PAGE_ROWS, "pallas_join_enabled": "false",
           "tpu_offload_enabled": "false"}
PKG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "presto_tpu_torch")


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
    return TpchConnector(SF, device="cpu"), RefConnector(SF)


def runners(conns, extra=None):
    session = {**SESSION, **(extra or {})}
    port = LocalRunner({"tpch": conns[0]}, session=session, device="cpu")
    ref = RefRunner({"tpch": conns[1]}, page_rows=PAGE_ROWS)
    for k, v in session.items():
        if k != "page_rows":
            ref.session.set(k, v)
    return port, ref


def span_tree(trace):
    """The multiset of (kind, name) paths from the root: kinds, names
    and nesting, independent of timing and sibling order."""
    spans = trace.spans()
    by_id = {s.span_id: s for s in spans}

    def path(s):
        out = []
        while s is not None:
            out.append((s.kind, s.name if s.kind != "query" else ""))
            s = by_id.get(s.parent_id)
        return tuple(reversed(out))

    return collections.Counter(path(s) for s in spans)


# ------------------------------------------------------------ tracing
@pytest.mark.parametrize("sql", [
    "select n_regionkey, count(*) from nation group by 1",
    PQ.TPCH_SQL[3],
])
def test_span_tree_equals_the_reference(conns, sql):
    port, ref = runners(conns, {"query_trace_enabled": "true"})
    got = port.execute(sql)
    want = ref.execute(sql)
    assert got.rows == want.rows
    assert span_tree(port.last_trace) == span_tree(ref.last_trace)
    kinds = {s.kind for s in port.last_trace.spans()}
    assert {"query", "execute", "attempt", "operator", "xfer"} <= kinds
    assert port.executor.trace_spans == port.last_trace.span_count
    cp = critical_path(port.last_trace)
    assert cp["chain"][0]["kind"] == "execute"
    assert set(cp["by_kind_ms"]) <= set(OBS.SPAN_KINDS)


def test_tracing_off_records_nothing(conns):
    port, _ref = runners(conns)
    port.execute("select count(*) from nation")
    assert port.last_trace is None
    assert port.executor.trace is None
    assert port.executor.trace_spans == 0


def test_chrome_file_is_written_and_valid(conns, tmp_path):
    port, _ref = runners(conns, {"query_trace_dir": str(tmp_path)})
    port.execute("select n_regionkey, count(*) from nation group by 1")
    files = os.listdir(tmp_path)
    assert files == [f"{port.last_trace.query_id}.trace.json"]
    doc = json.loads((tmp_path / files[0]).read_text())
    events = doc["traceEvents"]
    assert events and all(e["ph"] == "X" and e["dur"] >= 0
                          for e in events)
    assert {e["cat"] for e in events} <= set(OBS.SPAN_KINDS)
    assert doc["otherData"]["queryId"] == port.last_trace.query_id
    info = port.last_trace.to_info()
    assert info["stages"][0]["stageId"] == "local"


def test_control_statements_write_no_trace(conns, tmp_path):
    port, _ref = runners(conns, {"query_trace_dir": str(tmp_path)})
    port.execute("select count(*) from nation")
    first = port.last_trace
    port.execute("set session page_rows = 4096")
    port.execute("prepare p from select 1")
    assert port.last_trace is first
    assert len(os.listdir(tmp_path)) == 1
    assert port.executor.trace is None


def test_unwritable_trace_dir_never_fails_the_query(conns, tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    port, _ref = runners(conns, {"query_trace_dir": str(blocker)})
    res = port.execute("select count(*) from nation")
    assert res.rows == [(25,)]
    assert port.last_trace is not None


def test_ingest_clamps_clock_skew():
    tr = QueryTrace("q")
    parent = tr.begin("task", "t0")
    remote = [
        {"kind": "queue", "name": "a", "t0": -5.0, "t1": 0.5},
        {"kind": "run", "name": "b", "t0": 0.2, "t1": 99.0},
        {"kind": "run", "name": "c", "t0": 3.0, "t1": 1.0},
        {"kind": "run"},  # malformed: dropped
    ]
    assert tr.ingest(remote, parent, 1.0, 2.0) == 3
    got = {s.name: (s.t0, s.t1) for s in tr.spans() if s.kind != "task"
           and s.kind != "query"}
    for t0, t1 in got.values():
        assert 1.0 <= t0 <= t1 <= 2.0
    assert got["a"] == (1.0, 1.5)
    assert got["b"] == (1.2, 2.0)
    assert got["c"] == (2.0, 2.0)


def _emitted_kinds():
    """Span kinds passed as literals to begin()/complete() anywhere in
    the port, plus the root's."""
    kinds = {"query"}
    for dp, _dn, fns in os.walk(PKG_ROOT):
        for fn in fns:
            if not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dp, fn)).read())
            for n in ast.walk(tree):
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr in ("begin", "complete")
                        and n.args and isinstance(n.args[0], ast.Constant)
                        and isinstance(n.args[0].value, str)):
                    kinds.add(n.args[0].value)
    return kinds


def test_span_kinds_declared_and_emitted():
    from presto_tpu.obs import SPAN_KINDS as REF_KINDS

    assert _emitted_kinds() == set(OBS.SPAN_KINDS)
    assert set(OBS.SPAN_KINDS) <= set(REF_KINDS)


@pytest.fixture(scope="module")
def workers():
    ws = []
    for i in range(2):
        w = WorkerServer({"tpch": TpchConnector(SF, device="cpu")},
                         node_id=f"w{i}", default_catalog="tpch",
                         page_rows=PAGE_ROWS, device="cpu")
        w.start()
        ws.append(w)
    yield [w.uri for w in ws]
    for w in ws:
        w.stop()


def test_dcn_dag_traces_stages_tasks_and_worker_spans(workers, tmp_path):
    sql = ("select o_orderkey, count(*) c from lineitem "
           "join orders on l_orderkey = o_orderkey "
           "where o_orderkey < 1000 group by o_orderkey "
           "order by o_orderkey")
    coord = DcnRunner(
        {"tpch": TpchConnector(SF, device="cpu")}, workers,
        default_catalog="tpch",
        session_props={"join_distribution_type": "partitioned",
                       "device_exchange_enabled": "true",
                       "generated_join_enabled": "false",
                       "page_rows": PAGE_ROWS, "retry_backoff_ms": 20,
                       "stage_scheduler": "true",
                       "query_trace_dir": str(tmp_path)},
        device="cpu")
    rows = coord.execute(sql)
    assert coord.last_distribution == "stage-dag"
    assert rows
    nstages = len(coord.last_scheduler.dag.fragments)
    assert nstages >= 3
    tr = coord.runner.last_trace
    spans = tr.spans()
    by_id = {s.span_id: s for s in spans}
    kinds = collections.Counter(s.kind for s in spans)
    assert kinds["stage"] == nstages
    ntasks = sum(len(ts) for ts in coord.last_scheduler.tasks.values())
    assert kinds["task"] == kinds["dispatch"] == ntasks
    assert kinds["queue"] == kinds["run"] == ntasks
    assert kinds["fetch"] >= 1 and kinds["execute"] == 1
    for s in spans:
        if s.kind in ("queue", "run"):
            parent = by_id[s.parent_id]
            assert parent.kind == "task"
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
        if s.kind == "task":
            assert by_id[s.parent_id].kind == "stage"
    assert coord.runner.executor.trace_spans == len(spans)
    files = os.listdir(tmp_path)
    assert files == [f"{tr.query_id}.trace.json"]
    cats = {e["cat"] for e in json.loads(
        (tmp_path / files[0]).read_text())["traceEvents"]}
    assert {"stage", "task", "dispatch", "queue", "run", "fetch"} <= cats


# ------------------------------------------------------ profile store
def test_profile_store_round_trips(tmp_path):
    store = PROF.ProfileStore.at(str(tmp_path))
    assert PROF.ProfileStore.at(str(tmp_path)) is store
    store.record("k1", {"capacity_boost": 4, "rows_out": 7})
    assert store.lookup("k1") == {"capacity_boost": 4, "rows_out": 7}
    assert store.lookup("missing") is None
    fresh = PROF.ProfileStore(str(tmp_path))  # no in-memory cache
    assert fresh.lookup("k1") == {"capacity_boost": 4, "rows_out": 7}
    assert os.listdir(tmp_path) == ["profile_k1.json"]


def test_repeat_query_starts_from_its_profile(conns, tmp_path):
    """A grouped aggregation whose optimistic capacity (8 groups) is
    too small climbs one boost rung; its repeat, with the profile,
    starts on that rung: 0 retries, one profile hit, equal rows."""
    sql = "select n_name, count(*) from nation group by 1"
    seen = []
    for _ in range(2):
        port, _ref = runners(conns, {"stats_profile_dir": str(tmp_path)})
        port.executor.agg_optimistic_rows = 8
        rows = port.execute(sql).rows
        ex = port.executor
        seen.append((sorted(rows), ex.capacity_boost_retries,
                     ex.profile_store_hits))
    (rows1, retries1, hits1), (rows2, retries2, hits2) = seen
    assert (retries1, hits1) == (1, 0)
    assert (retries2, hits2) == (0, 1)
    assert rows1 == rows2 and len(rows1) == 25
    prof = json.loads((tmp_path / os.listdir(tmp_path)[0]).read_text())
    assert prof["capacity_boost"] > 1 and prof["rows_out"] == 25


# Q11's plan folds its scalar subquery at plan time:
#   sum(ps_supplycost * ps_availqty) * 0.0001
# over the unscaled decimal sum (scale 2) x = 65783221959 at SF 0.01.
# The port computes x / 100 * 0.0001 in plain IEEE order and folds
# 65783.221959; the reference's XLA reassociates it to
# x * (0.01 * 0.0001), which gives 65783.22195900002. Both are within
# the 9-digit rule; the one folded double differs, so Q11's structural
# fingerprint does too. An observation about the reference, not a fault
# of the port.
Q11_FOLDED_PORT = 65783.221959
Q11_FOLDED_REF = 65783.22195900002


@pytest.mark.parametrize("q", range(1, 23))
def test_plan_fingerprint_equals_the_reference(conns, q):
    port, ref = runners(conns)
    got = PROF.plan_fingerprint(port.plan(PQ.TPCH_SQL[q]), port.catalogs)
    want = RPROF.plan_fingerprint(ref.plan(PQ.TPCH_SQL[q]), ref.catalogs)
    if q != 11:
        assert got == want
        return
    assert got != want
    x = 65783221959
    assert x / 100 * 0.0001 == Q11_FOLDED_PORT
    assert x * (0.01 * 0.0001) == Q11_FOLDED_REF
    enc = repr(PROF.structural_encode(port.plan(PQ.TPCH_SQL[q])))
    renc = repr(RPROF.structural_encode(ref.plan(PQ.TPCH_SQL[q])))
    assert repr(Q11_FOLDED_PORT) in enc and repr(Q11_FOLDED_REF) in renc
    assert enc.replace(repr(Q11_FOLDED_PORT), "?") == \
        renc.replace(repr(Q11_FOLDED_REF), "?")
