"""Adaptive re-planning at stage boundaries of presto_tpu_torch on the
CPU (presto_tpu_torch/adaptive/), the counterparts of
tests/test_adaptive.py's cases.

The reference's misestimated join corpus, built from one seeded row
list into the port's MemoryConnector and the reference's, both wrapped
in Misestimate (the claimed row counts mislead the static plan, the
data stays honest; connectors/misestimate.py). Two in-process workers
per engine; presto_tpu's DcnRunner on the same corpus is the yardstick
of the re-planner's counters, the static plan and sqlite of the rows.
No wall clock is asserted: the CPU suite runs files side by side.

  - the spool-stats plane: spoolRows exact against the fetched pages
    on the host, disk and device tiers, identical after a replay;
  - the Replanner alone: the reads-only flip, skew hints, rollback,
    observe-only mode, a seeded-misestimate sweep under strict checks;
  - skew pre-engagement on a worker (skew_preempted, no boost);
  - the corpus: capacity re-seeding (zero boost retries on re-planned
    stages where the static plan climbs the ladder) and the
    distribution flip (a broadcast read, a passthrough producer).
"""

import collections
import json
import random
import sqlite3
import time
import urllib.request

import pytest
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.misestimate import Misestimate
from presto_tpu_torch.dist.dcn import DcnRunner
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server.worker import WorkerServer

PAGE_ROWS = 1 << 13
CLAIMS = {
    "fact": 5_000,      # 22x under-estimate
    "bulk": 300_000,    # 333x over-estimate (the flip's probe side)
    "small": 20_000,
}
Q_SEED = ("select g, count(*) c, sum(v + w) s from fact "
          "join dim on fact.k = dim.k group by g "
          "order by s desc, g limit 100")
Q_FLIP = ("select w, count(*) c from bulk join small "
          "on bulk.k = small.k group by w")
Q_SKEW = "select sfact.k, v, w from sfact join sdim on sfact.k = sdim.k"
# the reference's CPU session: its kernels off (the port's K2-K4 twins
# neither position-chunk nor defer, so the counters differ with them on)
SESSION = {"retry_backoff_ms": 20, "agg_gather_capacity": 64,
           "pallas_join_enabled": "false", "stage_scheduler": "true"}
ADAPTIVE = ("adaptive_replans", "adaptive_dist_flips",
            "adaptive_capacity_seeds", "adaptive_replan_rejected")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus_rows():
    """The reference's corpus (tests/test_adaptive.py::_corpus): fact/dim
    the under-estimate rung, bulk/small the flip rung, sfact/sdim the
    skew rung (70%+ of sdim's build rows on one key)."""
    rnd = random.Random(7)
    n_fact, groups = 110_000, 76_000
    tables = {}
    tables["fact"] = (["k", "g", "v"], [
        (rnd.randrange(50), i % groups, rnd.randrange(1000))
        for i in range(n_fact)])
    tables["dim"] = (["k", "w"], [(k, k * 10) for k in range(50)])
    tables["bulk"] = (["k", "v"], [(k % 900, k % 7) for k in range(900)])
    tables["small"] = (["k", "w"], [
        (rnd.randrange(900), rnd.randrange(100)) for _ in range(40_000)])
    tables["sfact"] = (["k", "v"], [
        (4 + rnd.randrange(800), rnd.randrange(100))
        for _ in range(12_000)])
    sdim = [(3, i) for i in range(6_500)]
    sdim += [(4 + i % 500, i) for i in range(2_500)]
    tables["sdim"] = (["k", "w"], sdim)
    return tables


@pytest.fixture(scope="module")
def rows():
    return _corpus_rows()


@pytest.fixture(scope="module")
def cat(rows):
    mem = MemoryConnector(device="cpu")
    for name, (cols, data) in rows.items():
        mem.create_table(name, cols, [T.BIGINT] * len(cols), data)
    return Misestimate(mem, CLAIMS)


@pytest.fixture(scope="module")
def ref_cat(rows):
    from presto_tpu import types as RT
    from presto_tpu.connectors.memory import MemoryConnector as RefMemory

    mem = RefMemory()
    for name, (cols, data) in rows.items():
        mem.create_table(name, cols, [RT.BIGINT] * len(cols), data)
    return Misestimate(mem, CLAIMS)


@pytest.fixture(scope="module")
def oracle(rows):
    db = sqlite3.connect(":memory:")
    for name, (cols, data) in rows.items():
        db.execute(f"create table {name} ({', '.join(cols)})")
        db.executemany(f"insert into {name} values "
                       f"({', '.join('?' for _ in cols)})", data)
    return db


@pytest.fixture(scope="module")
def workers(cat):
    ws = [WorkerServer({"mem": cat}, node_id=f"w{i}",
                       default_catalog="mem", page_rows=PAGE_ROWS,
                       device="cpu") for i in range(2)]
    for w in ws:
        w.start()
    yield [w.uri for w in ws]
    for w in ws:
        w.stop()


@pytest.fixture(scope="module")
def ref_workers(ref_cat):
    from presto_tpu.server.worker import WorkerServer as RefWorker

    ws = [RefWorker({"mem": ref_cat}, node_id=f"w{i}",
                    default_catalog="mem", page_rows=PAGE_ROWS)
          for i in range(2)]
    uris = [f"http://127.0.0.1:{w.start()}" for w in ws]
    yield uris
    for w in ws:
        w.stop()


@pytest.fixture(scope="module")
def single(cat):
    return LocalRunner({"mem": cat}, "mem",
                       session={"page_rows": PAGE_ROWS, **SESSION},
                       device="cpu")


def _multiset(rows):
    return collections.Counter(map(repr, map(tuple, rows)))


def _run(cat, workers, sql, adaptive=True, ref=False, **props):
    """One DcnRunner query: (rows, coordinator executor, scheduler,
    boost retries per stage). The coordinator is closed."""
    session = {**SESSION, "adaptive_execution":
               "auto" if adaptive else "false", **props}
    if ref:
        from presto_tpu.dist.dcn import DcnRunner as RefRunner

        coord = RefRunner({"mem": cat}, workers, default_catalog="mem",
                          page_rows=PAGE_ROWS,
                          session_props={**session,
                                         "stage_scheduler": "true"})
    else:
        coord = DcnRunner({"mem": cat}, workers, default_catalog="mem",
                          session_props={"page_rows": PAGE_ROWS,
                                         **session},
                          device="cpu")
    try:
        out = coord.execute(sql)
    finally:
        coord.close()
    sched = coord.last_scheduler
    boosts = {fid: sum(int((t.status or {}).get("boostRetries") or 0)
                       for t in ts)
              for fid, ts in sched.tasks.items()}
    return out, coord.runner.executor, sched, boosts


def _adaptive_counters(ex):
    return {k: getattr(ex, k) for k in ADAPTIVE}


# ------------------------------------------------------- the corpus
def test_adaptive_reseeds_the_misestimated_join(cat, ref_cat, workers,
                                               ref_workers, oracle):
    """fact's estimate is 22x low: the adaptive run re-plans the
    consumer stages from exact spool stats — re-plans applied, zero
    boost retries on the re-planned stages where the static plan climbs
    the overflow ladder, no split-batch fallback — and its rows equal
    the static plan's and sqlite's. Its re-plan counters equal
    presto_tpu's on the same corpus."""
    want = oracle.execute(Q_SEED).fetchall()
    rows_s, ex_s, _sched_s, boosts_s = _run(cat, workers, Q_SEED,
                                            adaptive=False)
    rows_a, ex_a, sched_a, boosts_a = _run(cat, workers, Q_SEED)
    _r, ex_r, _sr, boosts_r = _run(ref_cat, ref_workers, Q_SEED, ref=True)
    assert ex_a.adaptive_replans >= 1
    assert ex_s.adaptive_replans == 0
    assert ex_a.adaptive_replan_rejected == 0
    assert ex_a.adaptive_capacity_seeds >= 1
    replanned = [f.fid for f in sched_a.dag.fragments if f.inputs]
    assert replanned
    assert sum(boosts_s[f] for f in replanned) >= 1, boosts_s
    assert all(boosts_a[f] == 0 for f in replanned), boosts_a
    assert ex_a.capacity_boost_retries == 0
    assert ex_a.split_batch_fallbacks == 0
    assert ex_s.split_batch_fallbacks == 0
    assert [tuple(r) for r in rows_a] == [tuple(r) for r in rows_s]
    assert [tuple(r) for r in rows_a] == [tuple(r) for r in want]
    assert _adaptive_counters(ex_a) == _adaptive_counters(ex_r)
    assert boosts_a == boosts_r


def test_dist_flip_broadcast_read_and_passthrough(cat, ref_cat, workers,
                                                  ref_workers, oracle):
    """bulk (the probe, claimed 300k) is observed at 900 rows at its
    stage boundary, BEFORE the build's producer dispatched: the sides
    swap, the spooled partitions are read broadcast-style and the
    pending producer degrades to a passthrough edge. Rows equal the
    static plan's and sqlite's; the counters equal presto_tpu's."""
    want = oracle.execute(Q_FLIP).fetchall()
    rows_s, _ex_s, sched_s, _ = _run(cat, workers, Q_FLIP, adaptive=False,
                                     broadcast_join_rows=4096)
    assert all(f.output_kind != "passthrough"
               for f in sched_s.dag.fragments)
    rows_a, ex_a, sched_a, _ = _run(cat, workers, Q_FLIP,
                                    broadcast_join_rows=4096)
    _r, ex_r, sched_r, _ = _run(ref_cat, ref_workers, Q_FLIP, ref=True,
                                broadcast_join_rows=4096)
    assert ex_a.adaptive_dist_flips >= 1
    assert ex_a.adaptive_replans >= 1
    assert "broadcast" in sched_a.dag.reads.values()
    kinds = [f.output_kind for f in sched_a.dag.fragments]
    assert "passthrough" in kinds, kinds
    assert kinds == [f.output_kind for f in sched_r.dag.fragments]
    assert _multiset(rows_a) == _multiset(rows_s)
    assert _multiset(rows_a) == _multiset(want)
    assert _adaptive_counters(ex_a) == _adaptive_counters(ex_r)


def test_adaptive_execution_false_pins_static(cat, workers):
    _rows, ex, sched, _ = _run(cat, workers, Q_FLIP, adaptive=False)
    assert ex.adaptive_replans == 0
    assert ex.adaptive_dist_flips == 0
    assert sched.replanner is None


def test_observe_only_mode(cat, workers):
    """adaptive_max_replans=0: the re-planner observes stats but never
    mutates the DAG."""
    _rows, ex, sched, _ = _run(cat, workers, Q_FLIP,
                               adaptive_max_replans=0)
    assert sched.replanner is not None
    assert sched.replanner.stats
    assert ex.adaptive_replans == 0
    assert ex.adaptive_dist_flips == 0
    assert not sched.dag.reads


def test_rejected_replan_rolls_back(cat, workers, monkeypatch):
    """A mutated DAG that fails verify_dag rolls back COMPLETELY: the
    static plan runs, counted on adaptive_replan_rejected."""
    from presto_tpu_torch.exec import plan_check as PC

    def failing(ex, dag, strict=False):
        raise PC.PlanCheckError(["seeded verify failure"])

    rows_s, _ex, _sched, _ = _run(cat, workers, Q_FLIP, adaptive=False)
    monkeypatch.setattr(PC, "verify_dag", failing)
    # plan_check off: the coordinator's own pre-dispatch verification
    # stays out of it, the re-planner's runs whatever the session says
    rows, ex, sched, _ = _run(cat, workers, Q_FLIP, plan_check="false")
    assert ex.adaptive_replans == 0
    assert ex.adaptive_replan_rejected >= 1
    assert not sched.dag.reads
    assert not sched.dag.hints
    assert all(f.output_kind != "passthrough"
               for f in sched.dag.fragments)
    assert _multiset(rows) == _multiset(rows_s)


# ------------------------------------------------ the Replanner alone
def _build_side_fid(dag):
    from presto_tpu_torch.exec import plan as P

    found = []

    def find(n):
        if isinstance(n, P.HashJoin) and \
                isinstance(n.right, P.RemoteSource):
            found.append(int(n.right.key[len("stage"):]))
        for c in n.children():
            find(c)

    for f in dag.fragments:
        find(f.root)
    return found[0] if found else None


def test_reads_only_flip_counts_and_verifies(single, monkeypatch):
    """A flip that only mutates dag.reads (no tree rewrite) still
    reports an outcome, runs verification and respects the bound."""
    from presto_tpu_torch.adaptive import Replanner, StageStats
    from presto_tpu_torch.dist.fragmenter import fragment_dag

    plan = single.plan(Q_FLIP)
    dag = fragment_dag(single.executor, plan, single.catalogs,
                       broadcast_rows=4096)
    assert dag is not None
    rf = _build_side_fid(dag)
    assert rf is not None
    assert dag.fragment(rf).output_kind == "repartition"
    rp = Replanner(single.executor, dag, broadcast_rows=1 << 20,
                   max_replans=4)
    monkeypatch.setattr(rp, "_reseed", lambda root, fid, out: root)
    rp.observe(StageStats(
        fid=rf, rows=500, bytes=8_000, part_rows=(250, 250),
        part_bytes=(4_000, 4_000), task_rows=(250, 250)))
    dispatched = {f.fid for f in dag.fragments}
    dispatched.discard(dag.consumers(rf)[0])
    out = rp.replan(dispatched)
    assert out is not None
    assert not out.rejected
    assert out.dist_flips >= 1
    assert any(v == "broadcast" for v in dag.reads.values())
    rp.replans_applied = rp.max_replans
    dag.reads.clear()
    out2 = rp.replan(dispatched)
    assert out2 is not None and out2.rejected
    assert not dag.reads


def test_replanner_skew_hint_unit(single):
    """A synthetic skewed histogram gives the consumer the skew hint."""
    from presto_tpu_torch.adaptive import Replanner, StageStats
    from presto_tpu_torch.dist.fragmenter import fragment_dag

    plan = single.plan(Q_FLIP)
    dag = fragment_dag(single.executor, plan, single.catalogs,
                       **single.session_dist_options())
    assert dag is not None
    rp = Replanner(single.executor, dag, broadcast_rows=1, max_replans=4)
    # 4 partitions: max/mean = 3.2 crosses the 3.0 threshold
    rp.observe(StageStats(
        fid=0, rows=10_000, bytes=160_000,
        part_rows=(8_000, 700, 700, 600),
        part_bytes=(128_000, 11_200, 11_200, 9_600),
        task_rows=(5_000, 5_000)))
    out = rp.replan({0})
    assert out is not None and not out.rejected
    assert out.skew_hints >= 1
    assert any(dag.hints.get(c, {}).get("skew")
               for c in dag.consumers(0))


def test_seeded_misestimate_sweep_clean(single):
    """Synthetic 10x-off observations (alternately over and under, with
    an 80/20 partition histogram and wire bytes 8x under raw) at every
    stage boundary of a corpus DAG: the live DAG passes STRICT
    verification after each re-plan, applied or rolled back."""
    from presto_tpu_torch.adaptive import Replanner, StageStats
    from presto_tpu_torch.dist.fragmenter import fragment_dag
    from presto_tpu_torch.exec import plan_check as PC

    ex = single.executor
    dag = fragment_dag(ex, single.plan(Q_SEED), single.catalogs,
                       **single.session_dist_options())
    assert dag is not None
    rp = Replanner(ex, dag, broadcast_rows=1 << 21, max_replans=16,
                   strict=True)
    dispatched = set()
    for frag in dag.fragments:
        dispatched.add(frag.fid)
        est = max(int(ex.estimate_rows(frag.root)), 2)
        obs = est * 10 if frag.fid % 2 else max(est // 10, 1)
        hot = max(int(obs * 0.8), 1)
        rp.observe(StageStats(
            fid=frag.fid, rows=obs, bytes=obs * 16,
            part_rows=(hot, max(obs - hot, 0)),
            part_bytes=(hot * 16, max(obs - hot, 0) * 16),
            task_rows=(obs // 2, obs - obs // 2), wire_bytes=obs * 2))
        rp.replan(set(dispatched))
        PC.verify_dag(ex, dag, strict=True)


# ------------------------------------------- skew pre-engagement
def _post_task(uri, payload):
    req = urllib.request.Request(
        f"{uri}/v1/task", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=30).close()


def _wait_status(uri, task_id, timeout_s=120):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with urllib.request.urlopen(f"{uri}/v1/task/{task_id}",
                                    timeout=10) as r:
            st = json.loads(r.read().decode())
        if st["state"] != "RUNNING":
            assert st["state"] == "FINISHED", st.get("error")
            return st
        time.sleep(0.05)
    raise AssertionError("task did not finish")


def _fetch_rows(uri, task_id, part=0):
    from presto_tpu_torch.dist import serde
    from presto_tpu_torch.dist import spool as SPOOL

    out, nbytes = [], 0
    for blob in SPOOL.fetch_spool_blobs(uri, task_id, part):
        nbytes += len(blob)
        out.extend(serde.deserialize_page(blob).to_pylist())
    return out, nbytes


def _release(uri, task_id):
    urllib.request.urlopen(urllib.request.Request(
        f"{uri}/v1/task/{task_id}", method="DELETE"), timeout=5).close()


def _leaf_payload(single, sql, task_id, table, **extra):
    from presto_tpu_torch.dist import plan_serde

    return {"taskId": task_id,
            "fragment": plan_serde.dumps(single.plan(sql)),
            "splitTable": table, "splitIndex": 0, "splitCount": 1,
            "outputPartitions": 1, **extra}


def test_skew_preengagement_on_worker(single, workers):
    """sdim piles 6.5k build rows on one key: the grace-partitioned
    join's hot partition overflows on the first attempt — unless the
    payload carries the re-planner's skewHint, and the position-chunked
    rebalance engages at once (skewPreempted >= 1, no boost retry).
    Both spool the join's rows."""
    uri = workers[0]
    session = {"spill_threshold_bytes": 1 << 15, **SESSION}
    _post_task(uri, _leaf_payload(single, Q_SKEW, "skew-static.0",
                                  "sfact", session=session))
    st_static = _wait_status(uri, "skew-static.0")
    _post_task(uri, _leaf_payload(single, Q_SKEW, "skew-hint.0", "sfact",
                                  session=session, skewHint=True))
    st_hint = _wait_status(uri, "skew-hint.0")
    assert st_static["boostRetries"] >= 1
    assert st_static["skewPreempted"] == 0
    assert st_hint["skewPreempted"] >= 1
    assert st_hint["boostRetries"] == 0, st_hint
    want = _multiset(single.execute(Q_SKEW).rows)
    for tid in ("skew-static.0", "skew-hint.0"):
        assert _multiset(_fetch_rows(uri, tid)[0]) == want
        _release(uri, tid)


# ------------------------------------------------- spool-stats plane
def _stats_payload(single, task_id, session):
    return _leaf_payload(single, "select k, g from fact", task_id, "fact",
                         outputPartitions=3, outputKeys=[1],
                         session=dict(session))


@pytest.mark.parametrize("tier,session", [
    ("host", {"device_exchange_enabled": "false"}),
    # a 1-byte resident budget demotes every page to the disk tier
    ("disk", {"device_exchange_enabled": "false",
              "spool_exchange_bytes": 1}),
    ("device", {"device_exchange_enabled": "true"}),
])
def test_spool_stats_exact_per_tier(single, workers, tier, session):
    """spoolRows is EXACT against the fetched pages of each partition on
    every tier; spoolBytes equals the wire bytes on the blob tiers (the
    device tier reports the resident page footprint)."""
    uri = workers[1]
    task_id = f"stats-{tier}.0"
    _post_task(uri, _stats_payload(single, task_id, session))
    st = _wait_status(uri, task_id)
    assert len(st["spoolRows"]) == 3 and len(st["spoolBytes"]) == 3
    total = 0
    for p in range(3):
        got, nbytes = _fetch_rows(uri, task_id, part=p)
        assert st["spoolRows"][p] == len(got)
        if tier != "device":
            assert st["spoolBytes"][p] == nbytes
            assert st["spoolWireBytes"][p] == nbytes
        else:
            assert st["spoolBytes"][p] > 0
        total += len(got)
    # the wrapper CLAIMS 5k; the stats plane reports the real 110k
    assert total == 110_000
    _release(uri, task_id)


def test_spool_stats_identical_after_replay(single, workers):
    """A replayed task (same fragment and split share, new taskId)
    reports IDENTICAL spool stats."""
    uri = workers[1]
    _post_task(uri, _stats_payload(single, "replay-a.0", {}))
    a = _wait_status(uri, "replay-a.0")
    _post_task(uri, _stats_payload(single, "replay-a.0.r1", {}))
    b = _wait_status(uri, "replay-a.0.r1")
    assert a["spoolRows"] == b["spoolRows"]
    assert a["spoolBytes"] == b["spoolBytes"]
    _release(uri, "replay-a.0")
    _release(uri, "replay-a.0.r1")


# --------------------------------------------------- registry rings
def test_counters_registered(cat, workers):
    from presto_tpu_torch.exec.counters import QUERY_COUNTERS, snapshot

    _rows, ex, _sched, _ = _run(cat, workers, Q_FLIP)
    snap = snapshot(ex)
    for name in ADAPTIVE + ("skew_preempted",):
        assert name in QUERY_COUNTERS
        assert name in snap
    assert snap["adaptive_replans"] >= 1


def test_replan_span_kind_declared():
    from presto_tpu_torch import obs as OBS

    assert "replan" in OBS.SPAN_KINDS
