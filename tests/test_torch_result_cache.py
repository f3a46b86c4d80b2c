"""The two-level result cache (presto_tpu_torch/cache/): presto_tpu_torch
against presto_tpu.

The counterparts of the 28 cases of tests/test_result_cache.py. Each
case runs the same statement sequence on both engines and holds the
port's rows and its ``result_cache_*`` counters (and launches, spills,
crossings where the case reads them) to the reference's:

  - a repeated cacheable plan replays from the fragment cache with no
    launch (the split-batched fused path forced on both engines, so a
    miss launches programs and a hit launches none), and a re-planned
    statement lands on the same key;
  - the statement cache answers without executing, with zero
    host<->device crossings; a fragment hit at the host sink serves
    host pages with zero crossings;
  - the counters reach EXPLAIN ANALYZE; LRU eviction, demotion to the
    disk tier, oversized entries and TTL expiry;
  - sqlite parity of replayed rows; snapshot invalidation through the
    memory connector (INSERT, UPDATE of the same cardinality, DELETE,
    CREATE OR REPLACE VIEW), key salting by collect_k and page_rows,
    the memory limit on a replay;
  - the cacheability rules (system scans, volatile calls, remote
    sources, snapshot-less connectors) and the split wrappers' tokens;
  - eight concurrent protocol clients share one execution;
  - the CachingConnector's canonical key, snapshot token and the
    runner's invalidation through it;
  - the mesh: a root hit with zero crossings, and a replicated interior
    cached under an uncacheable root.

Both engines' process-shared stores are emptied around every case.
"""

import collections
import re
import threading
import time
import types
import urllib.request

import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.cache import ResultCache as RefCache
from presto_tpu.cache import shared_cache_if_exists as ref_shared
from presto_tpu.cache import uncacheable_reason as ref_uncacheable
from presto_tpu.connectors.cached import CachingConnector as RefCaching
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.exec import plan as RP
from presto_tpu.exec import xfer as RXF
from presto_tpu.expr.ir import Call as RCall
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.cache import ResultCache
from presto_tpu_torch.cache import shared_cache_if_exists
from presto_tpu_torch.cache import uncacheable_reason
from presto_tpu_torch.connectors.cached import CachingConnector
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.expr.ir import Call
from presto_tpu_torch.runner import LocalRunner

SF = 0.01
PAGE_ROWS = 1 << 13

AGG_Q = ("select l_returnflag, l_linestatus, count(*), "
         "sum(l_quantity), sum(l_extendedprice) from lineitem "
         "group by l_returnflag, l_linestatus "
         "order by l_returnflag, l_linestatus")
JOIN_Q = ("select o_orderpriority, count(*) c from orders join "
          "lineitem on o_orderkey = l_orderkey where l_quantity < 10 "
          "group by o_orderpriority order by o_orderpriority")
# the split-batched fused path on both engines: a miss launches
# programs, so "a hit launches none" is a real check on the CPU
FUSED = {"fused_partial_agg_enabled": "true", "split_batch_size": "64"}

COUNTERS = ("result_cache_hits", "result_cache_misses",
            "result_cache_evictions", "result_cache_invalidations")


def _rows_equal(a, b):
    return collections.Counter(map(repr, a)) == collections.Counter(
        map(repr, b))


def _counters(ex, names=COUNTERS):
    return {n: getattr(ex, n) for n in names}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clear_stores():
    for rc in (shared_cache_if_exists(), ref_shared()):
        if rc is not None:
            rc.clear()


@pytest.fixture(autouse=True)
def _clean_shared_caches():
    """Both stores are process-shared by design: no case leaks entries
    (or tallies another case reads deltas of) into the next."""
    _clear_stores()
    yield
    _clear_stores()


@pytest.fixture(scope="module")
def engines():
    """The two engines behind one interface; the reference runners
    share one program cache, so each reference plan compiles once per
    module."""
    jit = {}

    def ref_runner(session=None, **kw):
        r = RefRunner({"tpch": rconn}, page_rows=PAGE_ROWS, **kw)
        r.executor._jit_cache = jit
        for k, v in (session or {}).items():
            r.session.set(k, v)
        return r

    def port_runner(session=None, **kw):
        return LocalRunner({"tpch": pconn}, device="cpu",
                           session={"page_rows": PAGE_ROWS,
                                    **(session or {})}, **kw)

    pconn, rconn = TpchConnector(SF, device="cpu"), RefTpch(SF)
    port = types.SimpleNamespace(
        name="port", runner=port_runner, conn=pconn, Cache=ResultCache,
        XF=XF, P=P, Call=Call, T=T, uncacheable=uncacheable_reason,
        shared=shared_cache_if_exists, Memory=lambda: MemoryConnector(
            device="cpu"), Tpch=lambda: TpchConnector(SF, device="cpu"),
        Caching=CachingConnector,
        mem_runner=lambda cats, **kw: LocalRunner(
            cats, default_catalog="mem", device="cpu", **kw))
    ref = types.SimpleNamespace(
        name="ref", runner=ref_runner, conn=rconn, Cache=RefCache,
        XF=RXF, P=RP, Call=RCall, T=RT, uncacheable=ref_uncacheable,
        shared=ref_shared, Memory=RefMemory, Tpch=lambda: RefTpch(SF),
        Caching=RefCaching,
        mem_runner=lambda cats, **kw: RefRunner(
            cats, default_catalog="mem", **kw))
    return port, ref


def both(engines, scenario):
    """Run ``scenario(E)`` on each engine; (port result, ref result)."""
    out = []
    for E in engines:
        _clear_stores()
        out.append(scenario(E))
    return tuple(out)


# ----------------------------------------------------- acceptance pin
def test_second_run_hits_and_launches_zero(engines):
    def sc(E):
        r = E.runner(FUSED)
        r.apply_session()
        ex = r.executor
        ex.result_cache = E.Cache()
        plan = r.plan(AGG_Q)
        _n, rows1 = ex.execute(plan)
        first = (_counters(ex), ex.program_launches)
        _n, rows2 = ex.execute(plan)
        return rows1, rows2, first, _counters(ex), ex.program_launches

    port, ref = both(engines, sc)
    assert port == ref
    rows1, rows2, first, ctr, launches = port
    assert rows1 == rows2
    assert first[0]["result_cache_misses"] >= 1 and first[1] > 0
    assert ctr["result_cache_hits"] >= 1
    assert launches == 0, "a cache hit must launch no program"


def test_replan_same_sql_still_hits(engines):
    def sc(E):
        r = E.runner()
        ex = r.executor
        ex.result_cache = E.Cache()
        _1, rows1 = ex.execute(r.plan(AGG_Q))
        _2, rows2 = ex.execute(r.plan(AGG_Q))
        return rows1, rows2, _counters(ex)

    port, ref = both(engines, sc)
    assert port == ref
    assert port[0] == port[1] and port[2]["result_cache_hits"] >= 1


def test_statement_cache_skips_executor(engines):
    def sc(E):
        r = E.runner()
        r.session.set("result_cache_enabled", True)
        res1 = r.execute(AGG_Q)
        hits_before = r.executor.result_cache_hits
        res2 = r.execute(AGG_Q)
        ex = r.executor
        return ((res1.rows, res1.column_names, res1.column_types),
                (res2.rows, res2.column_names, res2.column_types),
                ex.result_cache_hits - hits_before, ex.program_launches,
                _counters(ex))

    port, ref = both(engines, sc)
    assert port == ref
    assert port[0] == port[1] and port[2] == 1 and port[3] == 0


def test_statement_cache_hit_zero_transfers(engines):
    """A statement-cache hit crosses host<->device ZERO times: the
    per-query gauges read 0 and the process totals do not move."""
    def sc(E):
        r = E.runner()
        r.session.set("result_cache_enabled", True)
        r.execute(AGG_Q)
        ex = r.executor
        hits0 = ex.result_cache_hits
        base = E.XF.process_totals()
        rows = r.execute(AGG_Q).rows
        after = E.XF.process_totals()
        return (rows, ex.result_cache_hits - hits0,
                (ex.h2d_bytes, ex.d2h_bytes, ex.h2d_transfers,
                 ex.d2h_transfers, ex.transfer_wall_s),
                {k: after[k] - base[k] for k in (
                    "h2d_bytes", "d2h_bytes", "h2d_transfers",
                    "d2h_transfers")})

    port, ref = both(engines, sc)
    assert port == ref
    assert port[1] == 1 and port[2] == (0, 0, 0, 0, 0)
    assert set(port[3].values()) == {0}


def test_fragment_hit_serves_host_pages_zero_transfers(engines):
    def sc(E):
        r = E.runner()
        ex = r.executor
        ex.result_cache = E.Cache()
        plan = r.plan(AGG_Q)
        _n, rows1 = ex.execute(plan)
        base = E.XF.process_totals()
        _n, rows2 = ex.execute(plan)
        after = E.XF.process_totals()
        return (rows1, rows2, _counters(ex), ex.h2d_bytes, ex.d2h_bytes,
                after["h2d_bytes"] - base["h2d_bytes"],
                after["d2h_bytes"] - base["d2h_bytes"])

    port, ref = both(engines, sc)
    assert port == ref
    assert port[0] == port[1] and port[2]["result_cache_hits"] >= 1
    assert port[3:] == (0, 0, 0, 0)


# ------------------------------------------------- counter contracts
def test_hit_miss_counters_explain_analyze(engines):
    def sc(E):
        r = E.runner()
        ex = r.executor
        ex.result_cache = E.Cache()
        plan = r.plan(AGG_Q)
        _n, _r, stats1 = ex.execute_with_stats(plan)
        _n, _r, stats2 = ex.execute_with_stats(plan)
        return ({n: stats1["counters"][n] for n in COUNTERS},
                {n: stats2["counters"][n] for n in COUNTERS})

    port, ref = both(engines, sc)
    assert port == ref
    assert port[0]["result_cache_misses"] >= 1
    assert port[1]["result_cache_hits"] >= 1


def test_store_eviction_under_budget(engines):
    """LRU eviction of row entries past the resident budget, oldest
    first, counted."""
    def sc(E):
        rc = E.Cache(budget_bytes=1 << 14)
        big = [("x" * 64, i) for i in range(20)]
        ev = sum(rc.put_rows(f"k{i}", ["a", "b"], big,
                             ["varchar", "bigint"], {("m", "t")})
                 for i in range(8))
        return (ev, rc.evictions, rc.resident_bytes() <= 1 << 14,
                rc.get_rows("k7") is not None, rc.get_rows("k0") is None)

    port, ref = both(engines, sc)
    assert port == ref
    assert port[0] > 0 and port[0] == port[1] and all(port[2:])


def test_pages_demote_to_disk_still_hit(engines):
    """Host budget pressure demotes LRU page entries to the disk-tier
    PageStore; a demoted entry still serves exact hits."""
    def sc(E):
        r = E.runner()
        ex = r.executor
        ex.result_cache = E.Cache()
        p1, p2 = r.plan(AGG_Q), r.plan(JOIN_Q)
        ex.execute(p1)
        ex.execute(p2)
        rc = ex.result_cache
        count, total = rc.entry_count, rc.total_bytes()
        rc.configure(budget_bytes=max(total // 2, 1024))
        demoted = (rc.resident_bytes() <= rc.budget_bytes,
                   rc.total_bytes() == total)
        _n, rows1 = ex.execute(p1)
        return count, demoted, ex.result_cache_hits, rows1

    port, ref = both(engines, sc)
    assert port[0] >= 2 and port[1] == (True, True)
    assert (port[0], port[1], port[2]) == (ref[0], ref[1], ref[2])
    assert port[2] >= 1
    assert port[3] == ref[3]
    fresh = engines[1].runner().execute(AGG_Q).rows
    assert _rows_equal(port[3], fresh)


def test_oversized_entry_never_admitted(engines):
    def sc(E):
        r = E.runner()
        ex = r.executor
        ex.result_cache = E.Cache(budget_bytes=64)
        ex.execute(r.plan(AGG_Q))
        return ex.result_cache.entry_count, _counters(ex)

    port, ref = both(engines, sc)
    assert port == ref
    assert port[0] == 0 and port[1]["result_cache_misses"] >= 1


def test_ttl_expiry(engines):
    """An entry older than result_cache_ttl_ms reads as a miss and is
    reclaimed (counted as an eviction)."""
    def sc(E):
        r = E.runner()
        ex = r.executor
        ex.result_cache = E.Cache(ttl_ms=80)
        plan = r.plan(AGG_Q)
        ex.execute(plan)
        ex.execute(plan)
        inside = ex.result_cache_hits
        time.sleep(0.12)
        ex.execute(plan)
        return (inside, ex.result_cache_hits, ex.result_cache_misses,
                ex.result_cache.evictions)

    port, ref = both(engines, sc)
    assert port == ref
    assert port[:2] == (1, 1) and port[2] >= 2 and port[3] >= 1


# ------------------------------------------------------ oracle parity
def test_oracle_parity_on_hits(engines):
    from tests.oracle import load_sqlite

    def sc(E):
        r = E.runner()
        ex = r.executor
        ex.result_cache = E.Cache()
        plan = r.plan(JOIN_Q)
        ex.execute(plan)
        _n, got = ex.execute(plan)
        return got, ex.result_cache_hits

    port, ref = both(engines, sc)
    assert port == ref and port[1] >= 1
    db = load_sqlite(engines[1].conn, ["orders", "lineitem"])
    # l_quantity is decimal(12,2): unscaled integers in sqlite
    want = db.execute(
        "select o_orderpriority, count(*) from orders join lineitem "
        "on o_orderkey = l_orderkey where l_quantity < 1000 "
        "group by o_orderpriority order by o_orderpriority").fetchall()
    assert [tuple(r) for r in want] == [tuple(r) for r in port[0]]


# ------------------------------------------- snapshot invalidation
def _mem_runner(E):
    r = E.mem_runner({"mem": E.Memory(), "tpch": E.conn})
    r.session.set("result_cache_enabled", True)
    return r


def test_memory_dml_bumps_snapshot_and_misses(engines):
    def sc(E):
        r = _mem_runner(E)
        r.execute("create table t as select 1 x, 10 y")
        r.execute("insert into t select 2, 20")
        conn = r.catalogs["mem"]
        v0 = conn.snapshot_version("t")
        q = "select count(*), sum(y) from t"
        out = [r.execute(q).rows]
        ex = r.executor
        hits0 = ex.result_cache_hits
        out.append(r.execute(q).rows)
        out.append(ex.result_cache_hits - hits0)
        r.execute("insert into t select 3, 300")
        out.append(conn.snapshot_version("t") != v0)
        out.append(ex.result_cache_invalidations >= 1)
        hits1 = ex.result_cache_hits
        out.append(r.execute(q).rows)
        out.append(ex.result_cache_hits - hits1)
        out.append(_counters(ex))
        return out

    port, ref = both(engines, sc)
    assert port == ref
    assert port[:7] == [[(2, 30)], [(2, 30)], 1, True, True, [(3, 330)], 0]


def test_update_same_cardinality_invalidates(engines):
    """UPDATE keeps the row count, so only the write counter can move
    the token: the repeated sum must come back fresh."""
    def sc(E):
        r = _mem_runner(E)
        r.execute("create table u as select 1 k, 100 v")
        r.execute("insert into u select 2, 200")
        q = "select sum(v) from u"
        out = [r.execute(q).rows, r.execute(q).rows]
        conn = r.catalogs["mem"]
        rc0, v0 = conn.row_count("u"), conn.snapshot_version("u")
        r.execute("update u set v = 999 where k = 2")
        out += [conn.row_count("u") == rc0,
                conn.snapshot_version("u") != v0, r.execute(q).rows,
                _counters(r.executor)]
        return out

    port, ref = both(engines, sc)
    assert port == ref
    assert port[:5] == [[(300,)], [(300,)], True, True, [(1099,)]]


def test_view_replacement_moves_statement_key(engines):
    def sc(E):
        r = _mem_runner(E)
        r.execute("create table base as select 1 a, 2 b")
        r.execute("create view v as select a from base")
        out = [r.execute("select * from v").rows,
               r.execute("select * from v").rows]
        r.execute("create or replace view v as select b from base")
        out.append(r.execute("select * from v").rows)
        out.append(_counters(r.executor))
        return out

    port, ref = both(engines, sc)
    assert port == ref
    assert port[:3] == [[(1,)], [(1,)], [(2,)]], \
        "stale pre-replacement view rows served from the cache"


def test_fragment_key_salted_by_session_config(engines):
    """Two sessions with other collect_k / page_rows never address one
    fragment entry (the store is process-shared)."""
    def sc(E):
        r = E.runner()
        ex = r.executor
        ex.result_cache = E.Cache()
        plan = r.plan(AGG_Q)
        keys = []
        for change in (None, "collect_k", "page_rows"):
            if change is not None:
                setattr(ex, change, getattr(ex, change) * 2)
            ex._select_cache_points(plan)
            keys.append({e[0].rsplit(":", 1)[1]
                         for e in ex._cache_points.values()})
        ex._cache_points = {}
        return keys

    port, ref = both(engines, sc)
    assert port == ref
    k1, k2, k3 = port
    assert k1 and k1.isdisjoint(k2) and k2.isdisjoint(k3)


def test_memory_limit_enforced_on_replay(engines):
    """A replayed page still passes the per-query memory accounting."""
    from presto_tpu.exec.executor import MemoryBudgetExceeded as RefMBE
    from presto_tpu_torch.exec.executor import MemoryBudgetExceeded

    for E, exc in zip(engines, (MemoryBudgetExceeded, RefMBE)):
        _clear_stores()
        r = E.runner()
        ex = r.executor
        ex.result_cache = E.Cache()
        plan = r.plan(AGG_Q)
        ex.execute(plan)
        ex.max_memory_bytes = 8
        try:
            with pytest.raises(exc):
                ex.execute(plan)
        finally:
            ex.max_memory_bytes = None
        assert ex.result_cache_hits == 1, E.name


def test_delete_and_drop_invalidate(engines):
    def sc(E):
        r = _mem_runner(E)
        r.execute("create table d as select 1 a union all select 2 a")
        q = "select count(*) from d"
        out = [r.execute(q).rows, r.execute(q).rows]
        r.execute("delete from d where a = 2")
        out.append(r.execute(q).rows)
        r.execute("drop table d")
        r.execute("create table d as select 7 a")
        out.append(r.execute(q).rows)
        out.append(_counters(r.executor))
        return out

    port, ref = both(engines, sc)
    assert port == ref
    assert port[:4] == [[(2,)], [(2,)], [(1,)], [(1,)]]


# --------------------------------------------------- cacheability rules
def test_system_scans_never_cache(engines):
    def sc(E):
        r = E.runner()
        return E.uncacheable(r.plan("select * from system.catalogs"),
                             r.catalogs)

    port, ref = both(engines, sc)
    assert port == ref and "system" in port


def test_volatile_function_never_caches(engines):
    def sc(E):
        r = E.runner()
        scan = E.P.TableScan("tpch", "nation", ("n_nationkey",))
        vol = E.P.Project(scan, (E.Call("random", (), E.T.DOUBLE),))
        return E.uncacheable(E.P.Output(vol, ("r",)), r.catalogs)

    port, ref = both(engines, sc)
    assert port == ref and "random" in port


def test_remote_source_never_caches(engines):
    def sc(E):
        rs = E.P.RemoteSource((E.T.BIGINT,), key="stage1")
        return E.uncacheable(E.P.Output(rs, ("x",)), E.runner().catalogs)

    port, ref = both(engines, sc)
    assert port == ref and port is not None


def test_snapshotless_connector_never_caches(engines):
    from presto_tpu.connectors.base import Connector as RefConnector
    from presto_tpu_torch.connectors.base import Connector

    def sc(E, base):
        class NoSnap(base):
            pass  # row_count raises: no snapshot token

        cats = dict(E.runner().catalogs)
        cats["weird"] = NoSnap()
        plan = E.P.Output(E.P.Aggregation(
            E.P.TableScan("weird", "t", ("a",)), (), ()), ("c",))
        return E.uncacheable(plan, cats)

    port, ref = (sc(engines[0], Connector), sc(engines[1], RefConnector))
    assert port == ref and port is not None


def test_split_filter_token_carries_split_identity(engines):
    """Two tasks of one fragment on different split shares never share
    a key: the wrappers' tokens carry (index, count) for the filtered
    table only — the reference's tokens, string for string."""
    from presto_tpu.connectors import split_filter as RSF
    from presto_tpu_torch.connectors import split_filter as SF_

    def tokens(E, mod):
        conn = E.conn
        w = [mod.SplitFilterConnector(conn, "lineitem", i, 2)
             for i in range(2)]
        h = [mod.HashSplitConnector(conn, {"lineitem": "l_orderkey"}, i, 2)
             for i in range(2)]
        return [x.snapshot_version(t) for x in w + h
                for t in ("lineitem", "orders", "nation")] + [
            conn.snapshot_version("orders")]

    port, ref = tokens(engines[0], SF_), tokens(engines[1], RSF)
    assert port == ref
    assert port[0] != port[3]          # split shares of lineitem differ
    assert port[1] == port[4] == port[-1]  # whole-table scans share
    assert port[6] != port[9] and port[8] == ref[8]


# ------------------------------------------------ concurrent clients
def test_concurrent_clients_share_one_execution(engines):
    """The same statement from 8 concurrent protocol clients: >= 1 real
    execution, the rest hit the process-shared store, every client the
    same rows — the reference runner's rows."""
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.server import PrestoTpuServer

    srv = PrestoTpuServer({"tpch": engines[0].conn}, port=0,
                          device="cpu", page_rows=PAGE_ROWS)
    port = srv.start()
    try:
        results, errors = [None] * 8, []

        def go(i):
            try:
                cl = StatementClient(f"http://127.0.0.1:{port}",
                                     user=f"u{i}", catalog="tpch")
                cl.session_properties["result_cache_enabled"] = "true"
                res = cl.execute(AGG_Q)
                assert res.error is None, res.error
                results[i] = res.rows
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert all(r == results[0] for r in results)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as f:
            metrics = f.read().decode()

        def metric(name):
            m = re.search(rf"^{name} (\d+)", metrics, re.M)
            return int(m.group(1)) if m else 0

        assert metric("presto_tpu_result_cache_misses_total") >= 1
        assert metric("presto_tpu_result_cache_hits_total") >= 7
    finally:
        srv.stop()
    want = engines[1].runner().execute(AGG_Q).rows
    # protocol rows: decimals as text, the reference runner's unscaled
    got = [tuple(r) for r in results[0]]
    assert [g[:3] for g in got] == [tuple(w[:3]) for w in want]


# ------------------------------------------- CachingConnector key fix
def _counting(E):
    class Counting(type(E.Memory())):
        pages_calls = 0

        def pages(self, table, columns=None, target_rows=1 << 20,
                  constraint=None):
            self.pages_calls += 1
            return super().pages(table, columns, target_rows, constraint)

    inner = Counting(device="cpu") if E.name == "port" else Counting()
    return inner


def _create(E, inner, name, cols, rows):
    typ = E.T.BIGINT
    inner.create_table(name, cols, [typ] * len(cols), rows)


def test_caching_connector_canonical_constraint_key(engines):
    """Structurally equal constraints built as distinct objects share
    one cache entry (canonical structural encoding, not repr())."""
    def sc(E):
        inner = _counting(E)
        _create(E, inner, "t", ["a", "b"], [(i, i * 2) for i in range(10)])
        cc = E.Caching(inner)
        r1 = list(cc.pages("t", constraint=(("a", 2, None),)))
        calls1 = inner.pages_calls
        r2 = list(cc.pages("t", constraint=tuple([("a", 2, None)])))
        return calls1, inner.pages_calls, len(r1) == len(r2)

    port, ref = both(engines, sc)
    assert port == ref == (1, 1, True)


def test_caching_connector_snapshot_and_invalidate(engines):
    def sc(E):
        inner = _counting(E)
        _create(E, inner, "t", ["a"], [(1,), (2,)])
        cc = E.Caching(inner)
        n1 = sum(len(p.to_pylist()) for p in cc.pages("t"))
        inner.insert("t", [(3,)])
        n2 = sum(len(p.to_pylist()) for p in cc.pages("t"))
        cached = cc.cached_page_count > 0
        dropped = cc.invalidate("t")
        return (n1, n2, inner.pages_calls, cached, dropped > 0,
                cc.cached_page_count)

    port, ref = both(engines, sc)
    assert port == ref == (2, 3, 2, True, True, 0)


def test_runner_invalidation_reaches_wrapped_connector(engines):
    def sc(E):
        r = E.mem_runner({"mem": E.Caching(E.Memory())})
        r.execute("create table t as select 1 x")
        out = [r.execute("select * from t").rows]
        r.execute("insert into t select 2")
        out.append(sorted(r.execute("select * from t").rows))
        return out

    port, ref = both(engines, sc)
    assert port == ref == [[(1,)], [(1,), (2,)]]


# ---------------------------------------------- mesh-path residency
def _mesh_runner(E):
    if E.name == "port":
        from presto_tpu_torch.dist.executor import make_mesh

        return LocalRunner({"tpch": E.conn}, device="cpu",
                           mesh=make_mesh(2, device="cpu"),
                           session={"page_rows": PAGE_ROWS,
                                    "result_cache_enabled": True})
    from presto_tpu.dist.executor import make_mesh as ref_mesh
    from presto_tpu.session import Session

    return RefRunner({"tpch": E.conn}, page_rows=PAGE_ROWS,
                     mesh=ref_mesh(2),
                     session=Session(catalog="tpch", properties={
                         "result_cache_enabled": True}))


def test_mesh_root_hit_zero_crossings(engines):
    """A fragment hit at the mesh root serves host pages through the
    extended sink chain: zero crossings on the replay."""
    def sc(E):
        r = _mesh_runner(E)
        r.apply_session()
        ex = r.executor
        plan = r.plan(AGG_Q)
        _, rows1 = ex.execute(plan)
        hits0 = ex.result_cache_hits
        base = E.XF.process_totals()
        _, rows2 = ex.execute(plan)
        now = E.XF.process_totals()
        return (rows1, rows2, hits0, ex.result_cache_hits, ex.h2d_bytes,
                ex.d2h_bytes, now["h2d_bytes"] - base["h2d_bytes"],
                now["d2h_bytes"] - base["d2h_bytes"])

    port, ref = both(engines, sc)
    assert port == ref
    assert port[0] == port[1] and port[2] == 0 and port[3] >= 1
    assert port[4:] == (0, 0, 0, 0)


def test_mesh_midplan_replicated_point_hits(engines):
    """A mesh query whose ROOT is uncacheable still caches its
    REPLICATED interior, and the hit skips the subtree's collectives."""
    def sc(E):
        r = _mesh_runner(E)
        r.apply_session()
        ex = r.executor
        base = r.plan("select l_returnflag rf, sum(l_quantity) s "
                      "from lineitem group by l_returnflag")
        plan = E.P.Output(source=E.P.UniqueId(source=base.source),
                          names=("rf", "s", "uid"))
        _, rows1 = ex.execute(plan)
        misses = ex.result_cache_misses
        m0 = ex.mesh_local_exchanges
        _, rows2 = ex.execute(plan)
        return (sorted(r[:2] for r in rows1), sorted(r[:2] for r in rows2),
                misses, ex.result_cache_hits, ex.mesh_local_exchanges - m0)

    port, ref = both(engines, sc)
    assert port == ref
    assert port[0] == port[1] and port[2] >= 1 and port[3] >= 1
    assert port[4] == 0
