"""The host<->device transfer ledger (presto_tpu_torch/exec/xfer.py):
the registry, the static sweep, the choke points, and per-label parity
with presto_tpu.

The static sweep reads every module of presto_tpu_torch/ and finds the
transfer primitives ``.cpu()``, ``.numpy()``, ``torch.from_numpy``,
``torch.as_tensor``, ``torch.tensor`` and ``.to(<device>)`` (a string
"cpu"/"cuda", a ``torch.device(...)``, or a name or attribute naming a
device), plus the choke-point calls ``XF.to_host``/``to_device``/
``np_host``/``stage_into``. Each site (``module[.Class].function``, nested defs
attributed to their enclosing top-level function) must be declared in
TRANSFER_REGISTRY with a direction that covers what it does; no row may
be stale; ``data`` rows live in DATA_PLANE_MODULES; and a raw primitive
in a data-plane module must route through a choke point or carry a
``# xfercheck: raw-ok - <why>`` escape.

Implicit forms the sweep does NOT see, covered only dynamically where
the code routes through the choke points: ``bool()``/``int()``/
``float()`` of a tensor (the deferred overflow flags' one read per
attempt), ``Tensor.item()`` and ``.tolist()``, ``np.asarray``/
``np.array`` of a tensor (its ``__array__``), printing or formatting a
tensor, and a tensor in an ``if``.

Per-label parity (memory-connector Q1 and Q6, and an aggregation over a
join in more than 32 grace passes, whose input restreams from the host
spill tier, SF 0.01, the kernel dispatch points off): each label's
crossing count and bytes equal the reference's, read off the two
engines' traced ``xfer`` spans. A label one engine meters and the other
does not is named below with its cause.

The result cache's ledger: the transfer counters on /metrics and
system.metrics, and a cache replay crossing nothing at the host sink
and staging its stored pages once below a device consumer, as the
reference's does.
"""

import ast
import collections
import os
import re

import numpy as np
import pytest
import torch

from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import queries as PQ
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.runner import LocalRunner

SF = 0.01
PAGE_ROWS = 1 << 13
SESSION = {"page_rows": PAGE_ROWS, "pallas_join_enabled": "false"}
PKG = "presto_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RAW_OK = re.compile(r"#\s*xfercheck:\s*raw-ok\s*-\s*\S")
_CHOKE = {"to_host": "d2h", "to_device": "h2d", "np_host": "d2h",
          "stage_into": "h2d"}
# labels one engine meters and the other does not, with the cause
ONLY_PORT = {
    # the port stages each fused launch's split start and count as
    # tensors (a captured graph's static inputs); the reference passes
    # a per-split launch's start as a scalar program argument and
    # meters only batched launches
    "h2d:batch-starts",
}
ONLY_REF: set = set()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the sweep
def _device_like(n):
    if isinstance(n, ast.Constant) and isinstance(n.value, str):
        return "d2h" if n.value == "cpu" else "h2d"
    if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "device"):
        return "h2d"
    name = (n.attr if isinstance(n, ast.Attribute)
            else n.id if isinstance(n, ast.Name) else None)
    if name and not name.endswith("dtype") and (
            "device" in name or name == "dev"):
        return "h2d"
    return None


def _classify(call):
    """(direction, routed) of a primitive call, or None."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if (f.attr in _CHOKE and isinstance(f.value, ast.Name)
            and f.value.id in ("XF", "xfer")):
        return _CHOKE[f.attr], True
    if f.attr in ("cpu", "numpy"):
        return "d2h", False
    if (isinstance(f.value, ast.Name) and f.value.id == "torch"
            and f.attr in ("from_numpy", "as_tensor", "tensor")):
        return "h2d", False
    if f.attr == "to":
        cands = list(call.args[:1]) + [
            k.value for k in call.keywords if k.arg == "device"]
        for c in cands:
            d = _device_like(c)
            if d:
                return d, False
    return None


def sweep(root=os.path.join(REPO, PKG)):
    """site -> {"dirs": directions seen, "raw": unescaped raw-primitive
    lines, "mod": module} over every module under ``root``."""
    sites = {}
    for dp, _dn, fns in os.walk(root):
        for fn in sorted(fns):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dp, fn)
            mod = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            if mod.endswith("__init__"):
                mod = mod[:-len(".__init__")] or "__init__"
            src = open(path).read()
            lines = src.splitlines()

            def record(owner, call):
                kind = _classify(call)
                if kind is None:
                    return
                direction, routed = kind
                esc = any(_RAW_OK.search(lines[i])
                          for i in (call.lineno - 1, call.lineno - 2)
                          if 0 <= i < len(lines))
                s = sites.setdefault(f"{mod}.{owner}", {
                    "dirs": set(), "raw": set(), "mod": mod})
                s["dirs"].add(direction)
                if not routed and not esc:
                    s["raw"].add(call.lineno)

            def visit(node, owner):
                for child in ast.iter_child_nodes(node):
                    if owner is None and isinstance(child, ast.ClassDef):
                        for item in child.body:
                            if isinstance(item, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef)):
                                visit(item, f"{child.name}.{item.name}")
                            else:
                                visit(item, child.name)
                        continue
                    o = owner
                    if owner is None and isinstance(
                            child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        o = child.name
                    if isinstance(child, ast.Call):
                        record(o or "<module>", child)
                    visit(child, o)

            visit(ast.parse(src), None)
    return sites


def findings(sites, registry=None, data_modules=None):
    registry = XF.TRANSFER_REGISTRY if registry is None else registry
    data_modules = (XF.DATA_PLANE_MODULES if data_modules is None
                    else data_modules)
    out = []
    for site, s in sorted(sites.items()):
        row = registry.get(site)
        if row is None:
            out.append(f"undeclared crossing site {site}")
            continue
        covered = set(row[0].split("+"))
        if not s["dirs"] <= covered:
            out.append(f"{site}: declared {row[0]}, does {s['dirs']}")
        if (s["mod"] in data_modules and s["mod"] != "exec.xfer"
                and s["raw"]):
            out.append(f"{site}: raw primitive at lines "
                       f"{sorted(s['raw'])} in a "
                       f"data-plane module (route it through xfer)")
    for site in sorted(set(registry) - set(sites)):
        out.append(f"stale registry row {site}")
    return out


def test_registry_rows_are_well_formed():
    for site, (direction, plane, why) in XF.TRANSFER_REGISTRY.items():
        assert direction in ("h2d", "d2h", "h2d+d2h"), site
        assert plane in ("data", "control"), site
        assert why.strip(), site
        if plane == "data":
            assert any(site.startswith(m + ".")
                       for m in XF.DATA_PLANE_MODULES), site


def test_sweep_finds_no_undeclared_or_stale_site():
    assert findings(sweep()) == []


def test_sweep_catches_undeclared_stale_and_raw(tmp_path):
    (tmp_path / "exec").mkdir()
    (tmp_path / "exec" / "executor.py").write_text(
        "import torch\n"
        "class Executor:\n"
        "    def pull(self, t):\n"
        "        return t.cpu()\n"
        "    def ok(self, t):\n"
        "        # xfercheck: raw-ok - a view\n"
        "        return t.numpy()\n"
        "def stage(a, device):\n"
        "    def inner():\n"
        "        return torch.from_numpy(a).to(device)\n"
        "    return inner()\n")
    sites = sweep(str(tmp_path))
    assert set(sites) == {"exec.executor.Executor.pull",
                          "exec.executor.Executor.ok",
                          "exec.executor.stage"}
    registry = {
        "exec.executor.Executor.ok": ("d2h", "data", "a view"),
        "exec.executor.stage": ("d2h", "data", "wrong direction"),
        "exec.executor.gone": ("h2d", "data", "stale"),
    }
    got = findings(sites, registry, {"exec.executor"})
    assert got == [
        "undeclared crossing site exec.executor.Executor.pull",
        "exec.executor.stage: declared d2h, does {'h2d'}",
        "exec.executor.stage: raw primitive at lines [10] in a "
        "data-plane module (route it through xfer)",
        "stale registry row exec.executor.gone",
    ]


# ------------------------------------------------------- choke points
class _Sink:
    trace = None
    trace_spans = 0

    def __init__(self):
        self.calls = []

    def count_transfer(self, direction, nbytes, wall):
        self.calls.append((direction, nbytes))


def test_choke_points_meter_only_real_crossings():
    sink = _Sink()
    prev = XF.swap_sink(sink)
    try:
        host = np.arange(10, dtype=np.int64)
        t = XF.to_device(host, "cpu", label="t")
        assert isinstance(t, torch.Tensor) and t.tolist() == list(range(10))
        assert sink.calls == [("h2d", 80)]
        # a tensor already on the target crosses nothing
        assert XF.to_device(t, "cpu", label="t") is not None
        assert sink.calls == [("h2d", 80)]
        # numpy in: no crossing; tensor out: d2h
        assert XF.np_host(host) is not None and len(sink.calls) == 1
        assert XF.np_host(t).tolist() == list(range(10))
        assert sink.calls[-1] == ("d2h", 80)
        # a host tree passes to_host untouched
        assert XF.to_host((host, None))[0] is host
        assert len(sink.calls) == 2
        out = XF.to_host((t, t[:2]))
        assert isinstance(out[0], np.ndarray)
        assert sink.calls[-1] == ("d2h", 96)
        # in place into an existing tensor: h2d, the same storage
        ptr = t.data_ptr()
        XF.stage_into(t, host[::-1].copy(), "t")
        assert t.data_ptr() == ptr and t.tolist() == list(range(9, -1, -1))
        assert sink.calls[-1] == ("h2d", 80) and len(sink.calls) == 4
    finally:
        XF.swap_sink(prev)
    assert XF.current_sink() is prev


def test_totals_grow_with_every_crossing():
    before = XF.process_totals()
    XF.np_host(torch.zeros(4, dtype=torch.int32))
    after = XF.process_totals()
    assert after["d2h_transfers"] == before["d2h_transfers"] + 1
    assert after["d2h_bytes"] == before["d2h_bytes"] + 16


# ------------------------------------------------------------ queries
@pytest.fixture(scope="module")
def pair():
    """Port and reference runners with lineitem copied into their memory
    connectors (BASELINE config 1's table)."""
    port = LocalRunner({"tpch": TpchConnector(SF, device="cpu"),
                        "memory": MemoryConnector(device="cpu")},
                       session=SESSION, device="cpu")
    ref = RefRunner({"tpch": RefConnector(SF), "memory": RefMemory()},
                    page_rows=PAGE_ROWS)
    ref.session.set("pallas_join_enabled", "false")
    for r in (port, ref):
        r.execute("create table memory.lineitem as "
                  "select * from tpch.lineitem")
    return port, ref


def _labels(trace):
    out = collections.defaultdict(lambda: [0, 0])
    for s in trace.spans():
        if s.kind == "xfer":
            out[s.name][0] += 1
            out[s.name][1] += int(s.attrs.get("bytes", 0))
    return {k: tuple(v) for k, v in out.items()}


def _traced(runner, sql, extra=()):
    for k, v in (("query_trace_enabled", "true"), *extra):
        runner.session.set(k, v)
    try:
        res = runner.execute(sql)
    finally:
        for k, _v in (("query_trace_enabled", None), *extra):
            runner.session.unset(k)
    return res, runner.last_trace


# more than 32 grace passes over a join: the join's output materializes
# once in the host tier and restreams per pass (both engines)
SPILL = (("spill_threshold_bytes", 1 << 12), ("host_spill_bytes", 1),
         ("generated_join_enabled", "false"))
LEDGER_CASES = {
    "memory_q1": (PQ.TPCH_SQL[1].replace("lineitem", "memory.lineitem"),
                  ()),
    "memory_q6": (PQ.TPCH_SQL[6].replace("lineitem", "memory.lineitem"),
                  ()),
    "spilled_agg": ("select o_custkey, sum(o_totalprice), count(*) "
                    "from orders, customer where o_custkey = c_custkey "
                    "group by o_custkey", SPILL),
}


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_per_label_counts_and_bytes_equal_the_reference(pair, case):
    sql, extra = LEDGER_CASES[case]
    port, ref = pair
    got, gtr = _traced(port, sql, extra)
    want, wtr = _traced(ref, sql, extra)
    assert sorted(got.rows) == sorted(want.rows)
    glab, wlab = _labels(gtr), _labels(wtr)
    assert set(glab) - set(wlab) <= ONLY_PORT
    assert set(wlab) - set(glab) <= ONLY_REF
    shared = set(glab) & set(wlab)
    assert {k: glab[k] for k in shared} == {k: wlab[k] for k in shared}
    if case.startswith("memory"):
        assert glab["h2d:page-build"][0] > 0
    else:
        assert glab["d2h:spill-host"][0] > 0
        assert glab["h2d:restream"][0] > 0
    # the registry gauges are the spans' totals
    ex = port.executor
    assert ex.h2d_transfers == sum(v[0] for k, v in glab.items()
                                   if k.startswith("h2d:"))
    assert ex.d2h_bytes == sum(v[1] for k, v in glab.items()
                               if k.startswith("d2h:"))


def test_xfer_spans_sum_to_transfer_wall(pair):
    port, _ref = pair
    _res, tr = _traced(port, LEDGER_CASES["memory_q6"][0])
    wall = sum(s.dur() for s in tr.spans() if s.kind == "xfer")
    assert wall == pytest.approx(port.executor.transfer_wall_s, abs=1e-6)
    assert port.executor.transfer_wall_s > 0
    # untraced: the gauges still count, and there are no spans
    port.execute(LEDGER_CASES["memory_q6"][0])
    assert port.last_trace is None and port.executor.trace_spans == 0
    assert port.executor.h2d_transfers > 0


def test_gauges_are_per_query(pair):
    port, _ref = pair
    port.execute(LEDGER_CASES["memory_q1"][0])
    big = port.executor.h2d_bytes
    port.execute("select count(*) from tpch.nation")
    small = port.executor.h2d_bytes
    assert 0 <= small < big
    ex = Executor({}, device="cpu")
    assert (ex.h2d_bytes, ex.d2h_bytes, ex.h2d_transfers,
            ex.d2h_transfers, ex.transfer_wall_s) == (0, 0, 0, 0, 0.0)


# -------------------------------------------------- the cache's ledger
def test_transfer_counters_reach_metrics_and_system_metrics():
    """The server surfaces: /metrics carries the byte and count gauges
    and the transfer_wall_seconds gauge, system.metrics the same names
    plus transfer_wall_ms — overlaid with the process totals like the
    result-cache counters (the reference's case of this name)."""
    import urllib.request

    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.server import PrestoTpuServer

    srv = PrestoTpuServer({"tpch": TpchConnector(0.001, device="cpu")},
                          port=0, device="cpu", page_rows=1 << 12)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        c = StatementClient(server=base)
        assert c.execute("select count(*) from nation").error is None
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            text = r.read().decode()
        for name in ("presto_tpu_h2d_bytes", "presto_tpu_d2h_bytes",
                     "presto_tpu_h2d_transfers", "presto_tpu_d2h_transfers",
                     "presto_tpu_transfer_wall_seconds",
                     "presto_tpu_result_cache_hits_total"):
            assert re.search(rf"^{name} ", text, re.M), name
        # the query above decoded rows: the process total is live
        assert int(re.search(r"^presto_tpu_d2h_bytes (\d+)", text,
                             re.M).group(1)) > 0
        res = c.execute("select * from system.metrics")
        assert res.error is None
        names = {row[0] for row in res.rows}
        assert {"h2d_bytes", "d2h_bytes", "h2d_transfers",
                "d2h_transfers", "transfer_wall_ms",
                "result_cache_hits"} <= names
    finally:
        srv.stop()


def test_cache_replay_meters_only_real_crossings(pair):
    """The cache-replay half of the reference's
    test_to_host_and_np_host_meter_only_real_crossings: a fragment hit
    at the host sink crosses nothing, and a hit below a device consumer
    stages its stored host pages once (h2d:cache-replay), with the
    reference's per-label counts and bytes."""
    from presto_tpu.cache import ResultCache as RefCache
    from presto_tpu.exec import plan as RP
    from presto_tpu.exec import xfer as RXF
    from presto_tpu_torch.cache import ResultCache
    from presto_tpu_torch.exec import plan as P

    sql = ("select l_returnflag, count(*), sum(l_quantity) "
           "from tpch.lineitem group by l_returnflag")
    out = []
    for r, cache, plan_mod, xf in ((pair[0], ResultCache, P, XF),
                                   (pair[1], RefCache, RP, RXF)):
        r.apply_session()
        ex = r.executor
        ex.result_cache = cache()
        try:
            root = r.plan(sql)
            ex.execute(root)
            base = xf.process_totals()
            _n, rows = ex.execute(root)  # a root hit: host pages served
            after = xf.process_totals()
            root_hit = (ex.result_cache_hits, ex.h2d_bytes, ex.d2h_bytes,
                        after["h2d_bytes"] - base["h2d_bytes"],
                        after["d2h_bytes"] - base["d2h_bytes"])
            # UniqueId above the aggregation: the hit stages for it
            above = plan_mod.Output(
                source=plan_mod.UniqueId(source=root.source),
                names=("f", "c", "q", "uid"))
            ex.execute(above)
            hits0 = ex.result_cache_hits
            ex.execute(above)
            out.append((sorted(rows), root_hit,
                        ex.result_cache_hits - hits0, ex.h2d_transfers,
                        ex.h2d_bytes))
        finally:
            ex.result_cache = None
    got, want = out
    assert got == want
    assert got[1][0] == 1 and got[1][1:] == (0, 0, 0, 0)
    assert got[2] == 1 and got[3] >= 1 and got[4] > 0
