"""The device-OOM ladder (Executor.stream_fragment, exec/faults.py):
presto_tpu_torch against presto_tpu.

The classifier: it accepts the card's own allocator failure
(``torch.cuda.OutOfMemoryError``, a RuntimeError subclass the
reference's exact-type gate would reject) and otherwise classifies
every exception as the reference's does — control-flow exceptions and
non-memory errors (a kernel wrapper's launch failure included) are
never absorbed. The ladder: an injected device fault re-enters the
query under a halved budget with the reference's device_oom_retries
and rows; task_retry_attempts bounds it; the fault frees that query's
captured programs and no other query's. A card-only case runs a real
out-of-memory during a CUDA graph capture and checks that the stream
leaves capture mode."""

import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.exec import faults as RFAULTS
from presto_tpu.exec.executor import MemoryBudgetExceeded as RefExceeded
from presto_tpu.exec.executor import QueryDeadlineExceeded as RefDeadline
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import faults as FAULTS
from presto_tpu_torch.exec import graphs
from presto_tpu_torch.exec import membudget as MB
from presto_tpu_torch.exec.executor import (MemoryBudgetExceeded,
                                            QueryDeadlineExceeded)
from presto_tpu_torch.runner import LocalRunner

SF = 0.01
PAGE_ROWS = 1 << 13
JOIN_SQL = (
    "select o_orderpriority, count(*), sum(l_quantity) "
    "from orders join lineitem on o_orderkey = l_orderkey "
    "group by o_orderpriority"
)


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
def oracle_rows(conns):
    r = LocalRunner({"tpch": conns[1]}, session={"page_rows": PAGE_ROWS},
                    device="cpu")
    return sorted(r.execute(JOIN_SQL).rows)


def pair(conns, session=None):
    ref_conn, conn = conns
    session = session or {}
    port = LocalRunner({"tpch": conn},
                       session={"page_rows": PAGE_ROWS, **session},
                       device="cpu")
    ref = RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS)
    for k, v in session.items():
        ref.session.set(k, v)
    return port, ref


# ------------------------------------------------------- the classifier
SAME_AS_REFERENCE = [
    (ValueError("bad plan"), False),
    (RuntimeError("capacity overflow"), False),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), True),
    (RuntimeError("Failed to allocate 123 bytes"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: injected device OOM (fault hook)"),
     True),
    # a kernel wrapper's launch failure: no memory marker
    (RuntimeError("CUDA kernel segsum_i64 failed to launch: cudaError 9"),
     False),
    # a subclass quoting device-fault text is control flow, not a fault
    (type("DcnQueryFailed", (RuntimeError,), {})(
        "worker x: RESOURCE_EXHAUSTED: out of memory"), False),
]


@pytest.mark.parametrize("i", range(len(SAME_AS_REFERENCE)))
def test_classifier_matches_reference(i):
    exc, want = SAME_AS_REFERENCE[i]
    assert FAULTS.is_device_fault(exc) is want
    assert RFAULTS.is_device_fault(exc) is want
    assert FAULTS.DEVICE_FAULT_MARKERS == RFAULTS.DEVICE_FAULT_MARKERS


def test_classifier_accepts_the_cards_oom():
    """torch.cuda.OutOfMemoryError is a RuntimeError subclass: the
    reference's exact-type gate rejects it, the port accepts it."""
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")
    assert isinstance(oom, RuntimeError)
    assert FAULTS.is_device_fault(oom)
    assert not RFAULTS.is_device_fault(oom)


def test_classifier_rejects_control_flow():
    for port_exc, ref_exc in (
            (MemoryBudgetExceeded("RESOURCE_EXHAUSTED: out of memory"),
             RefExceeded("RESOURCE_EXHAUSTED: out of memory")),
            (QueryDeadlineExceeded("out of memory"),
             RefDeadline("out of memory"))):
        assert not FAULTS.is_device_fault(port_exc)
        assert not RFAULTS.is_device_fault(ref_exc)


# ------------------------------------------------------------ the ladder
def test_injected_oom_retries_and_matches(conns, oracle_rows):
    """A device fault on the first attempt re-enters under a halved
    budget and returns the rows, with the reference's retry count."""
    port, ref = pair(conns)
    port.executor.inject_device_oom = ref.executor.inject_device_oom = 1
    rows = port.execute(JOIN_SQL).rows
    assert sorted(rows) == oracle_rows == sorted(ref.execute(JOIN_SQL).rows)
    for ex in (port.executor, ref.executor):
        assert ex.device_oom_retries == 1
        assert ex.inject_device_oom == 0
        assert ex._oom_divisor == 2


def test_oom_with_forced_tiny_budget_stays_correct(conns, oracle_rows):
    """A forced tiny budget and a forced device fault on a join: the
    retry runs under the tightened budget (the governor re-plans
    chunked) and the rows stay right; the counters equal the
    reference's."""
    port, ref = pair(conns, {"device_memory_budget": 1 << 22})
    port.executor.inject_device_oom = ref.executor.inject_device_oom = 1
    assert sorted(port.execute(JOIN_SQL).rows) == oracle_rows
    ref.execute(JOIN_SQL)
    ex = port.executor
    assert ex.device_oom_retries == ref.executor.device_oom_retries >= 1
    assert ex._budget() == ref.executor._budget() <= (1 << 22) // 2
    assert ex.memory_chunked_pipelines == \
        ref.executor.memory_chunked_pipelines


def test_pinned_mode_raises_through(conns):
    """task_retry_attempts=0: the device fault surfaces."""
    port, ref = pair(conns, {"task_retry_attempts": 0})
    for r in (port, ref):
        r.executor.inject_device_oom = 1
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            r.execute(JOIN_SQL)


def test_oom_budget_exhausted_raises(conns):
    """More faults than attempts: the ladder gives up loudly."""
    port, ref = pair(conns, {"task_retry_attempts": 2})
    for r in (port, ref):
        r.executor.inject_device_oom = 3
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            r.execute(JOIN_SQL)
        assert r.executor.device_oom_retries == 2


def test_oom_counters_reset_per_query(conns):
    port, _ = pair(conns)
    ex = port.executor
    ex.inject_device_oom = 1
    port.execute(JOIN_SQL)
    assert ex.device_oom_retries == 1
    assert ex.device_oom_faults == [RuntimeError]
    port.execute("select count(*) from region")
    assert ex.device_oom_retries == 0
    assert ex.device_oom_faults == []
    assert ex._oom_divisor == 1


def test_cards_oom_absorbed_mid_stream(conns, oracle_rows, monkeypatch):
    """A torch.cuda.OutOfMemoryError raised part-way through an attempt
    (here by the first partial aggregation, after the join has streamed
    into its input) re-enters the
    ladder like the reference's RESOURCE_EXHAUSTED, and the retry
    returns the rows."""
    from presto_tpu_torch.exec import executor as E

    calls = {"n": 0}
    orig = E._partial_agg_page

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 1.00 GiB")
        return orig(*a, **k)

    monkeypatch.setattr(E, "_partial_agg_page", flaky)
    port, _ = pair(conns)
    rows = port.execute(JOIN_SQL).rows
    assert sorted(rows) == oracle_rows
    assert port.executor.device_oom_retries == 1
    assert port.executor.device_oom_faults == [torch.cuda.OutOfMemoryError]
    assert calls["n"] >= 2


def test_apply_session_wires_the_governor(conns):
    port, _ = pair(conns, {
        "task_retry_attempts": 4, "device_memory_budget": 1 << 25,
        "query_max_memory_bytes": 1 << 30, "spill_threshold_bytes": 77,
        "max_join_build_rows": 5, "host_spill_bytes": 0,
        "disk_spill_bytes": 9, "spill_path": "/x",
        "join_skew_rebalance": "false",
        "late_materialization_enabled": "true"})
    port.apply_session()
    ex = port.executor
    assert ex.device_oom_attempts == 4
    assert ex._budget() == 1 << 25
    assert (ex.max_memory_bytes, ex.spill_bytes, ex.max_build_rows,
            ex.host_spill_bytes, ex.disk_spill_bytes, ex.spill_path) == (
        1 << 30, 77, 5, None, 9, "/x")
    assert ex.join_skew_rebalance is False and ex.late_mat == "true"


def test_session_defaults_are_the_reference_s():
    from presto_tpu.session import SYSTEM_SESSION_PROPERTIES as REF
    from presto_tpu_torch.session import SYSTEM_SESSION_PROPERTIES as OURS

    for name in ("query_max_memory_bytes", "spill_threshold_bytes",
                 "max_join_build_rows", "host_spill_bytes",
                 "disk_spill_bytes", "spill_path",
                 "late_materialization_enabled", "device_memory_budget",
                 "join_skew_rebalance", "task_retry_attempts"):
        assert OURS[name].type is REF[name].type, name
        assert OURS[name].default == REF[name].default, name


# ------------------------------------------ the programs a fault frees
FUSED = {"page_rows": PAGE_ROWS, "fused_partial_agg_enabled": "true",
         "split_batch_size": "64"}
OTHER_SQL = ("select count(*), sum(l_quantity) from lineitem "
             "where l_quantity < 25")
FAULTING_SQL = ("select l_returnflag, sum(l_extendedprice) from lineitem "
                "group by l_returnflag")


def test_device_fault_releases_only_the_faulting_querys_programs(conns):
    """One query's device fault frees that query's captured programs, not
    every query's (the reference's fault gate keeps every compiled
    program): the executor's programs_released seam records the keys,
    another query's programs stay cached, and the retried rows equal
    the unfaulted run — for a fault injected at the attempt's start
    (inject_device_oom: nothing of this query was touched yet, nothing
    goes) and for one raised after the query's programs ran."""
    other = LocalRunner({"tpch": conns[1]}, session=FUSED, device="cpu")
    other.execute(OTHER_SQL)
    other_keys = set(other.executor._query_programs)
    faulting = LocalRunner({"tpch": conns[1]}, session=FUSED, device="cpu")
    want = sorted(faulting.execute(FAULTING_SQL).rows)
    mine = set(faulting.executor._query_programs)
    assert other_keys and mine and not other_keys & mine
    ex = faulting.executor

    # injected at the attempt's start
    ex.inject_device_oom = 1
    assert sorted(faulting.execute(FAULTING_SQL).rows) == want
    assert ex.device_oom_retries == 1 and ex.programs_released == []
    assert other_keys | mine <= {k for k, _p in graphs.cached()}

    # raised by the consumer after the first page: the query's programs
    # ran, and only they are released
    faulting.apply_session()
    plan = faulting.plan(FAULTING_SQL)
    calls = []

    def emit(page):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("RESOURCE_EXHAUSTED: a device fault after "
                               "the query's programs ran")
        return page.to_pylist()

    rows = sorted(r for page in ex.stream_fragment(plan, emit) for r in page)
    assert rows == want and ex.device_oom_retries == 1
    released = set(ex.programs_released)
    assert released and released <= mine
    cached = {k for k, _p in graphs.cached()}
    assert other_keys <= cached, "another query's programs were dropped"
    # the retry recreated what the fault released
    assert released <= cached


# ------------------------------------------------------------- the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a real device OOM")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_real_oom_during_capture_leaves_capture_mode(dev):
    """The card's allocator fails INSIDE a graph capture: the Program
    raises torch.cuda.OutOfMemoryError, the classifier takes it, and
    neither the caller's stream nor the capture stream is left
    capturing; the card keeps working afterwards."""
    graphs.clear()
    torch.cuda.empty_cache()
    total = MB.device_hbm_bytes(dev)
    big = 1 << 30  # the capture asks for 1 GiB

    def fn(starts, counts):
        # the op-by-op warm-up allocates little; the capture then asks
        # for more than the fraction below leaves
        n = 1024 if not torch.cuda.is_current_stream_capturing() else big
        return (torch.ones(n, dtype=torch.int8, device=dev).sum()
                + starts.sum() + counts.sum(),)

    prog = graphs.Program(fn, 1, dev)
    torch.cuda.set_per_process_memory_fraction(
        min(0.5, (torch.cuda.memory_reserved(dev) + (256 << 20)) / total),
        dev)
    try:
        with pytest.raises(torch.cuda.OutOfMemoryError) as info:
            prog([0], [1])
        assert FAULTS.is_device_fault(info.value)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    assert not torch.cuda.is_current_stream_capturing()
    with torch.cuda.stream(graphs._side_stream(dev)):
        assert not torch.cuda.is_current_stream_capturing()
    x = torch.arange(1 << 20, device=dev)
    assert int(x.sum()) == (1 << 20) * ((1 << 20) - 1) // 2
    torch.cuda.synchronize(dev)
    graphs.clear()
    torch.cuda.empty_cache()
