"""Split-batched execution in presto_tpu_torch on the CPU
(exec/executor._fused_stream, split_batch_size, exec/graphs.py).

Counterparts of tests/test_split_scan.py, on its rig: SF 0.01 with
8192-row pages, so lineitem is 13 live splits and one 16-split batch
pads 3 tail slots. Fusion through partial aggregation and split
batching are "auto" = on a CUDA device, so every test forces them on
the CPU (fused_partial_agg_enabled=true, split_batch_size=64). Each
batched program shape is held to the per-split loop and sqlite:

  - grouped scan-agg (Q1 shape): the splits fold their partial states
    inside one program;
  - global scan-agg (Q6 shape): one state row per split, stacked;
  - page-emitting chains: the batch generated flat and emitted as one
    page.

program_launches, splits_scanned and fused_partial_aggs equal
presto_tpu's for the same session and split layout.
"""

import dataclasses

import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist import plan_serde
from presto_tpu_torch.exec import graphs
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server.worker import WorkerServer, local_runtime
from tests.oracle import load_sqlite
from tests.test_torch_dist import _post_task, _wait_task


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once, and torch's default of one thread per core spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SF = 0.01
PAGE_ROWS = 1 << 13

Q1ISH = (
    "select l_returnflag, l_linestatus, sum(l_quantity), count(*) "
    "from lineitem where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus order by 1, 2"
)
Q6ISH = (
    "select sum(l_extendedprice * l_discount) from lineitem "
    "where l_discount between 0.05 and 0.07 and l_quantity < 24"
)


@pytest.fixture(scope="module")
def rig():
    runner = LocalRunner({"tpch": TpchConnector(SF, device="cpu")},
                         device="cpu",
                         session={"page_rows": PAGE_ROWS,
                                  "fused_partial_agg_enabled": "true"})
    ref = RefRunner({"tpch": RefConnector(SF)}, page_rows=PAGE_ROWS)
    ref.session.set("fused_partial_agg_enabled", "true")
    return runner, ref


@pytest.fixture(scope="module")
def db():
    return load_sqlite(RefConnector(SF), ["lineitem"])


def _run(runner, sql, batch):
    runner.session.set("split_batch_size", batch)
    try:
        rows = runner.execute(sql).rows
        ex = runner.executor
        return rows, {
            "launches": ex.program_launches,
            "splits": ex.splits_scanned,
            "fused": ex.fused_partial_aggs,
            "fallbacks": ex.split_batch_fallbacks,
        }
    finally:
        runner.session.unset("split_batch_size")


def _both(rig, sql, batch):
    """The port's rows and counters, checked equal to presto_tpu's."""
    runner, ref = rig
    rows, counters = _run(runner, sql, batch)
    ref_rows, ref_counters = _run(ref, sql, batch)
    assert counters == ref_counters
    assert rows == ref_rows
    return rows, counters


def test_q1_grouped_scan_fold_parity_and_launches(rig, db):
    """Q1 shape: the 13-split scan phase is ONE program folding the
    partial-aggregation states — exact against the per-split loop and
    sqlite."""
    on, c_on = _both(rig, Q1ISH, "64")
    off, c_off = _both(rig, Q1ISH, "false")
    assert c_on["fused"] >= 1 and c_on["fallbacks"] == 0
    assert c_on["launches"] == 1 and c_on["splits"] == 13
    assert c_off["launches"] == c_off["splits"] == 13
    assert on == off
    want = db.execute(
        "select l_returnflag, l_linestatus, sum(l_quantity), count(*) "
        "from lineitem where l_shipdate <= 10471 "
        "group by l_returnflag, l_linestatus order by 1, 2").fetchall()
    assert on == [tuple(w) for w in want]


def test_q6_global_scan_stack_parity_and_launches(rig, db):
    """Q6 shape: the global partial states stack inside one program;
    decimal sums are exact integers, so batched == per split == sqlite
    with no tolerance."""
    on, c_on = _both(rig, Q6ISH, "64")
    off, c_off = _both(rig, Q6ISH, "false")
    assert c_on["launches"] == 1 and c_on["fallbacks"] == 0
    assert c_off["launches"] == c_off["splits"]
    assert on == off
    # engine decimals are unscaled ints: discount 0.05 -> 5
    want = db.execute(
        "select sum(l_extendedprice * l_discount) from lineitem "
        "where l_discount between 5 and 7 and l_quantity < 2400"
    ).fetchone()
    assert on[0][0] == want[0]


def test_page_emitting_flat_batch_parity(rig):
    """A fused filter -> project chain with no aggregation tail: the
    splits of a batch generate flat into one page, and what follows
    sees exactly the per-split pages' rows."""
    sql = ("select l_orderkey, l_extendedprice from lineitem "
           "where l_quantity < 3 order by 1, 2")
    on, c_on = _both(rig, sql, "64")
    off, c_off = _both(rig, sql, "false")
    assert c_on["launches"] < c_off["launches"]
    assert c_on["launches"] == 1 and c_on["fallbacks"] == 0
    assert on == off


def test_tail_batch_padding_masks_rows(rig):
    """A batch size of 4 makes ceil(13/4) = 4 launches whose tail (one
    split) takes the per-split program; 8 leaves a 5-split tail padded
    to its own 8-batch. Padding is pure masking: parity is exact."""
    base, _ = _both(rig, Q1ISH, "false")
    for b in ("4", "8"):
        rows, c = _both(rig, Q1ISH, b)
        assert rows == base, f"batch={b}"
        assert c["splits"] == 13
        assert c["launches"] == -(-13 // int(b))


def test_overflow_retry_reenters_ladder(rig):
    """A batched program whose partial-aggregation capacity overflows
    ORs the flag across the batch into the deferred ladder: the same
    final boost as the per-split loop, and the same rows."""
    runner, ref = rig
    sql = ("select l_quantity, count(*) from lineitem "
           "group by l_quantity order by 1")
    ex = runner.executor
    ex.agg_optimistic_rows = 8  # 50 groups overflow 8
    ref.session.set("agg_optimistic_rows", 8)
    try:
        on, _ = _both(rig, sql, "64")
        boost_on = ex._capacity_boost
        off, _ = _both(rig, sql, "false")
        boost_off = ex._capacity_boost
    finally:
        ex.agg_optimistic_rows = 1 << 18
        ref.session.unset("agg_optimistic_rows")
    assert boost_on > 1 and boost_on == boost_off
    assert on == off and len(on) == 50


def _partial_cut(plan):
    """The plan's aggregation as its partial step (a worker's leaf
    fragment)."""
    node = plan
    while not isinstance(node, P.Aggregation):
        node = node.source
    return dataclasses.replace(node, step="partial")


def test_worker_fragment_batches(rig):
    """The shipped-plan worker path (SplitFilterConnector declares
    fused_scan_ok): a task's round-robin share of the splits (7 of 13)
    folds into one launch too, as in presto_tpu."""
    runner, ref = rig
    fragment = _partial_cut(runner.plan(Q1ISH))
    conn = TpchConnector(SF, device="cpu")
    worker = WorkerServer({"tpch": conn}, node_id="split-scan",
                          default_catalog="tpch", page_rows=PAGE_ROWS,
                          device="cpu")
    worker.start()
    try:
        graphs.clear()
        _post_task(worker.uri, {
            "taskId": "batched.f0.t0", "splitTable": "lineitem",
            "splitIndex": 0, "splitCount": 2, "outputPartitions": 1,
            "session": {"fused_partial_agg_enabled": "true",
                        "split_batch_size": "64"},
            "fragment": plan_serde.dumps(fragment),
        })
        st = _wait_task(worker.uri, "batched.f0.t0")
        assert st["state"] == "FINISHED", st.get("error")
        assert local_runtime(worker.uri).get_task("batched.f0.t0").spool
        ((key, prog),) = graphs.cached()
        launches, splits = prog.calls, sum(
            c > 0 for c in prog.last_call[1])
    finally:
        worker.stop()
    assert key[0] == "fused_batch" and key[2][0] == "partial"
    # presto_tpu on the same split share
    from presto_tpu.connectors.split_filter import SplitFilterConnector \
        as RefSplitFilter
    from presto_tpu.dist import plan_serde as ref_serde
    from presto_tpu.server.worker import find_partial_cut

    ref_fragment = ref_serde.loads(ref_serde.dumps(dataclasses.replace(
        find_partial_cut(ref.plan(Q1ISH)), step="partial")))
    worker_ref = RefRunner(
        {"tpch": RefSplitFilter(ref.catalogs["tpch"], "lineitem", 0, 2)},
        page_rows=PAGE_ROWS)
    worker_ref.session.set("fused_partial_agg_enabled", "true")
    worker_ref.session.set("split_batch_size", "64")
    worker_ref.apply_session()
    rex = worker_ref.executor
    assert rex.stream_fragment(ref_fragment, lambda p: p)
    assert (launches, splits) == (rex.program_launches,
                                  rex.splits_scanned) == (1, 7)


def test_counters_in_explain_analyze(rig):
    """program_launches and splits_per_launch ride EXPLAIN ANALYZE's
    counters line, equal to presto_tpu's for the same session."""
    stats = []
    for r in rig:
        r.session.set("split_batch_size", "64")
        try:
            r.apply_session()
            plan = r.plan(Q6ISH)
            stats.append(r.executor.execute_with_stats(plan)[2])
        finally:
            r.session.unset("split_batch_size")
    ctr, ref_ctr = (s["counters"] for s in stats)
    assert ctr["program_launches"] >= 1
    assert ctr["splits_per_launch"] > 1
    for k in ("program_launches", "splits_scanned", "splits_per_launch",
              "fused_partial_aggs", "split_batch_fallbacks"):
        assert ctr[k] == ref_ctr[k], k
    rig[0].session.set("split_batch_size", "64")
    try:
        text = "\n".join(r[0] for r in rig[0].execute(
            "explain analyze " + Q6ISH).rows)
    finally:
        rig[0].session.unset("split_batch_size")
    assert "program_launches" in text and "splits_per_launch" in text


def test_auto_is_on_only_on_a_cuda_device(rig):
    """auto = on a CUDA device (where presto_tpu says TPU): on the CPU
    the resolved max batch is 0 and nothing fuses through partial
    aggregation; an executor on a CUDA device resolves it on (its
    sizing needs no card). An explicit int engages anywhere, floored to
    a power of two."""
    runner, _ = rig
    runner.apply_session()  # default: auto
    ex = runner.executor
    assert ex.split_batch == "auto"
    assert ex._split_batch_max(8192, scanned=True) == 0
    assert ex._split_batch_max(8192, scanned=False) == 0
    on_card = Executor({}, device="cuda")
    assert on_card.split_batch == on_card.agg_fusion == "auto"
    assert on_card._split_batch_max(8192, scanned=True) == 64
    ex.split_batch = 48
    assert ex._split_batch_max(8192, scanned=True) == 32
    # page-emitting batches bound B * n_pad
    ex.split_batch = 64
    assert ex._split_batch_max(1 << 20, scanned=False) == 4
    ex.split_batch = "auto"
    runner.session.set("fused_partial_agg_enabled", "auto")
    try:
        rows, c = _run(runner, Q6ISH, "auto")
    finally:
        runner.session.set("fused_partial_agg_enabled", "true")
    # filter/project chains still run one program per split
    assert c["fused"] == 0 and c["launches"] == c["splits"] == 13


def test_batch_buckets_share_programs(rig):
    """Nearby split counts land on the same batch bucket: re-running
    with the same shapes makes no new program."""
    _both(rig, Q6ISH, "64")
    keys = [k for k, _ in graphs.cached()]
    _, c = _both(rig, Q6ISH, "64")
    assert [k for k, _ in graphs.cached()] == keys
    assert c["launches"] == 1
