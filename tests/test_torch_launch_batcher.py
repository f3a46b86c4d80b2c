"""Cross-query launch batching (presto_tpu_torch/server/launch_batcher.py
and the executor's cross-query branch of ``_fused_stream``).

The gather protocol runs on the port's LaunchBatcher and on presto_tpu's,
driven by a fake ``make_batched``: leader and followers, the bounded
window, the width cap, the dispatch-width ladder, a lone leader and a
failed dispatch resolving to ``None`` (the participant's solo launch),
and continuous batching behind an in-flight same-key step. Then the
executor: two executors sharing one batcher gang a fused scan whose
per-slot pages equal the solo pages, page for page, with the counters
the reference keeps. On the card, a replayed cross-query program equals
its op-by-op run."""

import threading
import time

import pytest
import torch

from presto_tpu_torch.server import launch_batcher as LB


def _module(engine):
    """The port's batcher module or presto_tpu's (imported here, so the
    card-only case runs where jax is not installed)."""
    if engine == "port":
        return LB
    from presto_tpu.server import launch_batcher as RLB

    return RLB


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake(calls, fail=False):
    def make_batched(entries):
        calls.append(list(entries))
        if fail:
            raise RuntimeError("dispatch failed")
        return [(("page", s, c), ("flag", s)) for s, c in entries]

    return make_batched


def _gang(mod, n, cap, wait_ms, fail=False, key="k", stagger=0.0):
    """n threads offer (start=i, count=10+i) under one key; returns the
    per-thread results and the make_batched calls."""
    b = mod.LaunchBatcher()
    calls, out = [], [None] * n
    go = threading.Barrier(n)

    def offer(i):
        go.wait()
        time.sleep(stagger * i)
        out[i] = b.submit(key, i, 10 + i, cap, wait_ms,
                          _fake(calls, fail))

    threads = [threading.Thread(target=offer, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert b.pending_groups() == 0
    return out, calls


@pytest.mark.parametrize("engine", ["port", "ref"])
def test_lone_leader_and_small_cap_run_solo(engine):
    mod = _module(engine)
    b = mod.LaunchBatcher()
    calls = []
    t0 = time.monotonic()
    assert b.submit("k", 0, 5, 8, 30, _fake(calls)) is None
    assert time.monotonic() - t0 >= 0.025  # the window was paid
    assert b.submit("k", 0, 5, 1, 5000, _fake(calls)) is None  # cap < 2
    b.concurrency_probe = lambda: 1  # nobody to gang with: no window
    t0 = time.monotonic()
    assert b.submit("k", 0, 5, 8, 5000, _fake(calls)) is None
    assert time.monotonic() - t0 < 1.0
    assert calls == []


@pytest.mark.parametrize("engine", ["port", "ref"])
def test_leader_and_followers_share_one_dispatch(engine):
    # the group fills its cap long before the 20 s window closes
    t0 = time.monotonic()
    out, calls = _gang(_module(engine), 3, cap=3, wait_ms=20000)
    assert time.monotonic() - t0 < 10
    assert len(calls) == 1 and sorted(calls[0]) == [
        (0, 10), (1, 11), (2, 12)]
    leaders = [r[4] for r in out]
    assert leaders.count(True) == 1
    for i, (page, flags, width, waited_ms, _lead) in enumerate(out):
        # each participant gets exactly its own slot
        assert page == ("page", i, 10 + i) and flags == ("flag", i)
        assert width == 3 and waited_ms >= 0


@pytest.mark.parametrize("engine", ["port", "ref"])
def test_width_cap_and_dispatch_ladder(engine):
    mod = _module(engine)
    # 5 under a cap of 4: one full group of 4, the fifth runs solo
    out, calls = _gang(mod, 5, cap=4, wait_ms=400)
    assert sorted(len(c) for c in calls) == [4]
    assert sum(r is None for r in out) == 1
    assert all(r[2] == 4 for r in out if r is not None)
    # 5 gathered under a cap of 8: the ladder dispatches 4 (no rung of
    # 5), the surplus slot re-offers and, alone, runs solo
    out, calls = _gang(mod, 5, cap=8, wait_ms=400)
    assert max(mod.DISPATCH_WIDTHS[:3]) == 4 and 5 not in \
        mod.DISPATCH_WIDTHS
    assert [len(c) for c in calls] == [4]
    assert sum(r is None for r in out) == 1


@pytest.mark.parametrize("engine", ["port", "ref"])
def test_dispatch_error_sends_everyone_solo(engine):
    out, calls = _gang(_module(engine), 3, cap=3, wait_ms=20000,
                       fail=True)
    assert len(calls) == 1 and out == [None, None, None]


@pytest.mark.parametrize("engine", ["port", "ref"])
def test_keys_do_not_mix(engine):
    mod = _module(engine)
    b = mod.LaunchBatcher()
    calls, out = [], {}

    def offer(key, i):
        out[(key, i)] = b.submit(key, i, 1, 2, 300, _fake(calls))

    threads = [threading.Thread(target=offer, args=(k, i))
               for k in ("a", "b") for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert sorted(len(c) for c in calls) == [2, 2]
    for (key, i), r in out.items():
        assert r is not None and r[0] == ("page", i, 1)


@pytest.mark.parametrize("engine", ["port", "ref"])
def test_continuous_batching_behind_an_inflight_step(engine):
    """While a same-key step is in flight, a leader's window stretches
    past wait_ms, so a late arrival still joins its group."""
    mod = _module(engine)
    b = mod.LaunchBatcher()
    calls, out = [], [None, None]
    release = threading.Event()

    def solo():
        with b.solo_inflight("k"):
            release.wait(30)

    def offer(i):
        out[i] = b.submit("k", i, 1, 4, 20, _fake(calls))

    holder = threading.Thread(target=solo)
    holder.start()
    time.sleep(0.05)
    first = threading.Thread(target=offer, args=(0,))
    first.start()
    time.sleep(0.3)  # far past the 20 ms window
    second = threading.Thread(target=offer, args=(1,))
    second.start()
    time.sleep(0.1)
    release.set()
    for t in (holder, first, second):
        t.join(timeout=60)
    assert calls == [[(0, 1), (1, 1)]]
    assert out[0][2] == out[1][2] == 2


def test_stress_every_slot_gets_its_own_result():
    """More threads than cores offering under two keys, round after
    round, with a short interpreter switch interval: every participant
    gets its own slot's result or runs solo, every dispatch carries
    distinct slots of one key, and no group is left pending."""
    import sys

    b = LB.LaunchBatcher()
    calls, lock, wrong = [], threading.Lock(), []

    def make_batched(entries):
        with lock:
            calls.append(list(entries))
        return [(("page", s, c), ()) for s, c in entries]

    def offer(i):
        for r in range(6):
            start, count = i * 100 + r, i
            res = b.submit(("k", i % 2), start, count, 8, 5, make_batched)
            if res is not None and res[0] != ("page", start, count):
                with lock:
                    wrong.append((i, r, res[0]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=offer, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not wrong, wrong[:3]
    assert b.pending_groups() == 0 and calls
    for entries in calls:
        assert len(set(entries)) == len(entries) >= 2
        assert len({c % 2 for _s, c in entries}) == 1  # one key a call


# ------------------------------------------------------- the executor

NATION = ("select n_nationkey, n_name, n_regionkey from nation "
          "where n_regionkey > 1")
GROUPED = ("select n_regionkey, count(*), max(n_name), sum(n_nationkey) "
           "from nation group by n_regionkey order by n_regionkey")


def _runner(conn, session=None, device="cpu"):
    from presto_tpu_torch.runner import LocalRunner

    return LocalRunner({"tpch": conn}, "tpch", device=device,
                       session={"page_rows": 1 << 12, **(session or {})})


def _pages(runner, text):
    runner.apply_session()
    plan = runner.plan(text)
    names, pages = runner.executor.execute_pages(plan)
    return [(p.capacity, p.valid.tolist(), p.to_pylist()) for p in pages]


def _ganged(conn, text, session, device="cpu"):
    """Two runners sharing one batcher run ``text`` at once; returns
    their pages and executors."""
    batcher = LB.LaunchBatcher()
    runners = [_runner(conn, session, device) for _ in range(2)]
    for r in runners:
        r.executor.launch_batcher = batcher
        # a wide window: both threads reach the batch point within it
        r.session.set("cross_query_batch_wait_ms", 1000)
    out = [None, None]
    go = threading.Barrier(2)

    def run(i):
        go.wait()
        out[i] = _pages(runners[i], text)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out, [r.executor for r in runners]


@pytest.mark.parametrize("text,session", [
    (NATION, {}),
    (GROUPED, {"fused_partial_agg_enabled": "true"}),
])
def test_cross_query_pages_equal_solo_pages(text, session):
    from presto_tpu_torch.connectors.tpch import TpchConnector

    conn = TpchConnector(0.01, device="cpu")
    solo = _pages(_runner(conn, session), text)
    pages, exs = _ganged(conn, text, session)
    assert pages[0] == solo and pages[1] == solo
    assert sum(ex.cross_query_batches for ex in exs) == 1
    assert [ex.cross_query_batched_queries for ex in exs] == [1, 1]
    assert [ex.queries_per_launch for ex in exs] == [2, 2]
    assert sum(ex.program_launches for ex in exs) == 1
    assert all(ex.split_batch_fallbacks == 0 for ex in exs)


def test_batching_off_and_unattached_launch_solo():
    from presto_tpu_torch.connectors.tpch import TpchConnector

    conn = TpchConnector(0.01, device="cpu")
    r = _runner(conn, {"cross_query_batching": "false"})
    r.executor.launch_batcher = LB.LaunchBatcher()
    _pages(r, NATION)
    plain = _runner(conn)
    _pages(plain, NATION)
    for ex in (r.executor, plain.executor):
        assert ex.cross_query_batched_queries == 0
        assert ex.program_launches == 1


@pytest.mark.cuda
def test_replayed_cross_query_program_equals_its_op_by_op_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.exec import graphs

    conn = TpchConnector(0.01, device="cuda")
    for text in (NATION, GROUPED):
        solo = _pages(_runner(conn, device="cuda"), text)
        pages, exs = _ganged(conn, text, {}, device="cuda")
        assert pages[0] == solo and pages[1] == solo
        assert sum(ex.cross_query_batches for ex in exs) == 1
    progs = [p for key, p in graphs.cached() if key[0] == "xq_batch"]
    assert progs
    for prog in progs:
        starts, counts = prog.last_call
        replay = graphs.leaves_of(prog(starts, counts))
        eager = graphs.leaves_of(prog.eager(starts, counts))
        assert len(replay) == len(eager)
        for a, b in zip(replay, eager):
            assert torch.equal(a, b)
