"""EXPLAIN ANALYZE and the counter registry: presto_tpu_torch against
presto_tpu.

On the same inputs and session (TPC-H SF 0.01, 8192-row pages, the
kernel dispatch points off: ``pallas_join_enabled=false``, the
reference's CPU default):

  - the per-node rows and pages of ``execute_with_stats`` equal the
    reference's for TPC-H Q1, Q3, Q5 and Q6 and for a grace-spilled
    aggregation, node by node in plan order;
  - the deterministic counters equal the reference's (gathers, fusion,
    splits, generated joins, spill, boost retries, governed rewrites);
  - with the wall figures masked, ``explain_text(..., stats=)`` equals
    the reference's text line for line, and the Counters line carries
    only reference counter names;
  - every port registry name is a reference registry name of the same
    kind, every registry counter is an int on a bare Executor and
    reaches the Counters line, and every ``+=`` counter of the
    executor family is declared (an AST sweep);
  - ``explain analyze`` runs through LocalRunner (the positive half of
    what tests/test_torch_statements.py used to hold as unported).

The reference engine is imported inside the fixtures, so the card test
at the bottom (``-m cuda``, stats_drain on Q1) runs where jax is not
installed (``--noconftest``).
"""

import ast
import os
import re

import pytest
import torch

from presto_tpu_torch import queries as PQ
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import counters as CTRS
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec.executor import Executor, NodeStats
from presto_tpu_torch.runner import LocalRunner, explain_text

SF = 0.01
PAGE_ROWS = 1 << 13
SESSION = {"page_rows": PAGE_ROWS, "pallas_join_enabled": "false"}
# forces grace passes on a grouped aggregation (both engines)
SPILL = {"spill_threshold_bytes": 1 << 12}
SPILL_AGG = ("select l_orderkey, sum(l_quantity), count(*) from lineitem "
             "group by l_orderkey")

DETERMINISTIC = (
    "gathers_deferred", "gathers_materialized", "fused_partial_aggs",
    "program_launches", "splits_scanned", "split_batch_fallbacks",
    "splits_per_launch", "generated_joins_used", "spill_partitions_used",
    "host_spill_pages", "disk_spill_pages", "skew_chunks_used",
    "capacity_boost_retries", "memory_chunked_pipelines",
    "device_oom_retries", "profile_store_hits", "trace_spans",
)

# executor attributes that look like counters but are deliberately not
# in the registry, with the reason (the reference's exemptions plus the
# port's own)
COUNTER_EXEMPT = {
    "host_spill_bytes_used": "byte volume, reported via host_spill_pages",
    "_capacity_boost": "retry-ladder state, not a counter",
    "_oom_divisor": "retry-ladder state, not a counter",
    "peak_memory_bytes": "high-water gauge surfaced as peak_device_bytes",
    "compile_wall_s": "float wall surfaced as a computed entry",
    "transfer_wall_s": "float wall surfaced as a computed entry",
    "spooled_exchange_rows": "the spool's row volume, a reading of the "
                             "chip check (chip_smoke.py dist phase), "
                             "not a registry counter",
}
COUNTER_CLASSES = ("Executor", "DcnRunner", "StageScheduler")


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
    from presto_tpu.connectors.tpch import TpchConnector as RefConnector

    return TpchConnector(SF, device="cpu"), RefConnector(SF)


def runners(conns, extra=None):
    from presto_tpu.runner import LocalRunner as RefRunner

    session = {**SESSION, **(extra or {})}
    port = LocalRunner({"tpch": conns[0]}, session=session, device="cpu")
    ref = RefRunner({"tpch": conns[1]}, page_rows=PAGE_ROWS)
    for k, v in session.items():
        if k != "page_rows":
            ref.session.set(k, v)
    return port, ref


def analyzed(runner, sql):
    runner.apply_session()
    plan = runner.plan(sql)
    _names, rows, stats = runner.executor.execute_with_stats(plan)
    return plan, rows, stats


def node_stats(plan, stats):
    """(label, pages, rows) per plan node in pre-order (None where the
    node ran inside a fused program or not at all)."""
    out = []

    def walk(n):
        st = stats.get(id(n))
        out.append((type(n).__name__, None if st is None
                    else (st.label, st.pages, st.rows)))
        for c in n.children():
            walk(c)

    walk(plan)
    return out


def mask_walls(text: str) -> str:
    return re.sub(r"wall [0-9.]+ms", "wall ?ms", text)


CASES = {
    "q1": (PQ.TPCH_SQL[1], None),
    "q3": (PQ.TPCH_SQL[3], None),
    "q5": (PQ.TPCH_SQL[5], None),
    "q6": (PQ.TPCH_SQL[6], None),
    "spilled_agg": (SPILL_AGG, SPILL),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_per_node_stats_and_counters_equal_the_reference(conns, case):
    sql, extra = CASES[case]
    port, ref = runners(conns, extra)
    plan, rows, stats = analyzed(port, sql)
    rplan, rrows, rstats = analyzed(ref, sql)
    assert len(rows) == len(rrows)
    got, want = node_stats(plan, stats), node_stats(rplan, rstats)
    assert got == want
    # the top node's rows are the query's rows
    assert stats[id(plan)].rows == len(rows)
    ctr, rctr = stats["counters"], rstats["counters"]
    for k in DETERMINISTIC:
        assert ctr[k] == rctr[k], k
    if case == "spilled_agg":
        assert ctr["spill_partitions_used"] > 1


@pytest.mark.parametrize("q", [1, 3])
def test_text_equals_the_reference_with_walls_masked(conns, q):
    from presto_tpu.runner import explain_text as ref_explain_text

    port, ref = runners(conns)
    plan, _rows, stats = analyzed(port, PQ.TPCH_SQL[q])
    rplan, _rrows, rstats = analyzed(ref, PQ.TPCH_SQL[q])
    got = mask_walls(explain_text(plan, stats=stats)).splitlines()
    want = mask_walls(ref_explain_text(rplan, stats=rstats)).splitlines()
    assert got[:-1] == want[:-1]
    assert got[-1].startswith("Counters: ")
    keys = [kv.split("=")[0] for kv in got[-1][10:].split(", ")]
    rkeys = {kv.split("=")[0] for kv in want[-1][10:].split(", ")}
    assert keys == sorted(keys) and set(keys) <= rkeys
    # through the runner: the same text, as EXPLAIN ANALYZE rows
    res = port.execute("explain analyze " + PQ.TPCH_SQL[q])
    assert res.column_names == ["Query Plan"]
    text = [r[0] for r in res.rows]
    assert mask_walls("\n".join(text[:-1])).splitlines() == got[:-1]


def test_registry_is_a_subset_of_the_references():
    from presto_tpu.exec import counters as RCTRS

    for name, (kind, help_text) in CTRS.QUERY_COUNTERS.items():
        assert name in RCTRS.QUERY_COUNTERS, name
        assert kind == RCTRS.QUERY_COUNTERS[name][0], name
        assert help_text
    assert set(CTRS.COMPUTED_COUNTERS) <= set(RCTRS.COMPUTED_COUNTERS)
    assert not set(CTRS.QUERY_COUNTERS) & set(CTRS.COMPUTED_COUNTERS)


def test_every_registry_counter_reaches_the_counters_line(conns):
    ex = Executor({"tpch": conns[0]}, device="cpu")
    for name in CTRS.QUERY_COUNTERS:
        assert isinstance(getattr(ex, name), int), name
    snap = CTRS.snapshot(ex)
    assert set(snap) == set(CTRS.QUERY_COUNTERS)
    port, _ref = runners(conns)
    text = "\n".join(r[0] for r in port.execute(
        "explain analyze select count(*) from nation").rows)
    line = text.splitlines()[-1]
    for name in list(CTRS.QUERY_COUNTERS) + list(CTRS.COMPUTED_COUNTERS):
        assert f"{name}=" in line, name


PKG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "presto_tpu_torch")


def _counter_sweep(root=PKG_ROOT):
    """(zero-initialized executor-family attributes, attributes
    incremented with += anywhere in exec/ and dist/)."""
    zero_init, incremented = {}, {}
    for sub in ("exec", "dist"):
        for dp, _dn, fns in os.walk(os.path.join(root, sub)):
            for fn in fns:
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dp, fn)
                tree = ast.parse(open(path).read())
                for cls in ast.walk(tree):
                    if not isinstance(cls, ast.ClassDef):
                        continue
                    for meth in (n for n in cls.body
                                 if isinstance(n, ast.FunctionDef)):
                        for node in ast.walk(meth):
                            if (cls.name in COUNTER_CLASSES
                                    and meth.name == "__init__"
                                    and isinstance(node, ast.Assign)
                                    and len(node.targets) == 1
                                    and isinstance(node.targets[0],
                                                   ast.Attribute)
                                    and isinstance(node.value,
                                                   ast.Constant)
                                    and node.value.value == 0
                                    and not isinstance(node.value.value,
                                                       bool)):
                                zero_init.setdefault(
                                    node.targets[0].attr,
                                    (path, node.lineno))
                            if (isinstance(node, ast.AugAssign)
                                    and isinstance(node.op, ast.Add)
                                    and isinstance(node.target,
                                                   ast.Attribute)):
                                incremented.setdefault(
                                    node.target.attr, (path, node.lineno))
    return zero_init, incremented


def test_every_incremented_counter_is_declared():
    zero_init, incremented = _counter_sweep()
    undeclared = sorted(
        (name, incremented[name]) for name in set(zero_init)
        & set(incremented)
        if name not in CTRS.QUERY_COUNTERS and name not in COUNTER_EXEMPT)
    assert undeclared == []
    # and no stale row: every declared counter is an executor-family
    # attribute initialized to 0
    assert [n for n in CTRS.QUERY_COUNTERS if n not in zero_init] == []


def test_sweep_catches_an_undeclared_counter(tmp_path):
    """The sweep sees a new `self.x += 1` counter of an executor-family
    class, and ignores one of another class."""
    (tmp_path / "exec").mkdir()
    (tmp_path / "exec" / "x.py").write_text(
        "class Executor:\n"
        "    def __init__(self):\n"
        "        self.fresh_counter = 0\n"
        "    def run(self):\n"
        "        self.fresh_counter += 1\n"
        "class Other:\n"
        "    def __init__(self):\n"
        "        self.tally = 0\n")
    zero_init, incremented = _counter_sweep(str(tmp_path))
    assert set(zero_init) == {"fresh_counter"}
    assert set(incremented) == {"fresh_counter"}


def test_compile_counters_in_explain_analyze(conns):
    """programs_compiled (graph captures, 0 on the CPU) and
    compile_wall_s ride the Counters line (tests/test_shapes.py's
    counterpart)."""
    port, _ref = runners(conns)
    text = "\n".join(r[0] for r in port.execute(
        "explain analyze select count(*) from lineitem").rows)
    assert "programs_compiled=0" in text
    assert "compile_wall_s=" in text and "program_cache_hits=" in text


def test_stats_drain_keeps_the_rows(conns):
    """stats_drain changes what a wall means, never a count."""
    port, _ref = runners(conns)
    _plan, rows, stats = analyzed(port, PQ.TPCH_SQL[6])
    port.executor.stats_drain = True
    try:
        _plan2, rows2, stats2 = analyzed(port, PQ.TPCH_SQL[6])
    finally:
        port.executor.stats_drain = False
    assert rows == rows2
    assert sorted((s.label, s.pages, s.rows) for s in stats.values()
                  if isinstance(s, NodeStats)) == \
        sorted((s.label, s.pages, s.rows) for s in stats2.values()
               if isinstance(s, NodeStats))


def test_untraced_plain_query_collects_nothing(conns):
    port, _ref = runners(conns)
    port.execute("select count(*) from nation")
    assert port.executor._collect_stats is None
    assert port.executor.trace_spans == 0


@pytest.mark.cuda
def test_explain_analyze_on_the_card_with_drain():
    """On the card: EXPLAIN ANALYZE of Q1 with stats_drain, the top
    node's rows equal the query's, every wall is set, and the Counters
    line carries the kernel, graph and ledger counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    r = LocalRunner({"tpch": TpchConnector(SF)},
                    session={"page_rows": PAGE_ROWS})
    r.executor.stats_drain = True
    plan = r.plan(PQ.TPCH_SQL[1])
    _names, rows, stats = r.executor.execute_with_stats(plan)
    assert stats[id(plan)].rows == len(rows) == 4
    assert all(s.wall_s > 0 for s in stats.values()
               if isinstance(s, NodeStats))
    text = explain_text(plan, stats=stats)
    for name in ("pallas_kernels_used", "program_launches",
                 "programs_compiled", "h2d_bytes", "d2h_bytes",
                 "transfer_wall_s"):
        assert f"{name}=" in text
    assert isinstance(plan, P.Output)
