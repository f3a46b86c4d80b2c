"""The result cache's warm-start tier and overlapping subsumption:
presto_tpu_torch against presto_tpu.

The counterparts of the 17 cases of tests/test_cache_persist.py that
need no stream connector. Each case runs the same sequence on both
engines and holds the port's rows and counters (cache_warm_loads,
cache_manifest_drops, result_cache_hits, cache_subsumed_hits) to the
reference's: a process restart (the shared store torn down, the persist
directory kept) warm-loads and hits, once per persister; DML between
runs and an out-of-band snapshot bump force misses with fresh rows; a
truncated manifest, a missing payload file, a wire-serde fingerprint
skew and a version skew load nothing, count their drops and recompute;
the generation manifest appends, compacts, falls back past a broken
generation and takes concurrent publishers; a cached WHERE d < 10
answers WHERE d < 5 by a residual filter, a non-contained predicate
misses, the narrow answer republishes under its exact key, the
arbiter's estimate discounts resident fragments, and subsumption is
off by default. Persisted entries are never read across engines: each
engine writes its own directory.
"""

import collections
import os
import threading
import types

import pytest
import torch

from presto_tpu.cache import shared_cache_if_exists as ref_shared
from presto_tpu.cache import store as ref_store
from presto_tpu.cache import persist as ref_persist
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch.cache import persist
from presto_tpu_torch.cache import shared_cache_if_exists
from presto_tpu_torch.cache import store
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.runner import LocalRunner

SF = 0.01
PAGE_ROWS = 1 << 13

AGG_Q = ("select l_returnflag, l_linestatus, count(*) c, "
         "sum(l_quantity) q from lineitem "
         "group by l_returnflag, l_linestatus "
         "order by l_returnflag, l_linestatus")
NARROW_Q = ("select l_orderkey, l_quantity from lineitem "
            "where l_quantity < 5 order by l_orderkey, l_quantity")
WIDE_Q = ("select l_orderkey, l_quantity from lineitem "
          "where l_quantity < 10 order by l_orderkey, l_quantity")
DISJOINT_Q = ("select l_orderkey, l_quantity from lineitem "
              "where l_quantity < 20 order by l_orderkey, l_quantity")
COUNTERS = ("cache_warm_loads", "cache_manifest_drops",
            "result_cache_hits", "result_cache_misses",
            "cache_subsumed_hits", "program_launches")


def _rows_equal(a, b):
    return collections.Counter(map(repr, a)) == collections.Counter(
        map(repr, b))


def _counters(ex):
    return {n: getattr(ex, n) for n in COUNTERS}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _restart():
    """A process death: both shared stores (their in-memory entries)
    vanish; the manifests and payload files on disk survive."""
    for mod, shared in ((store, shared_cache_if_exists),
                        (ref_store, ref_shared)):
        rc = shared()
        if rc is not None:
            rc.configure(persist_dir="")
            rc.clear()
        mod._shared = None


@pytest.fixture(autouse=True)
def _clean_shared_caches():
    """Restarts tear the stores down; leave none behind (nor a
    persister bound to a deleted directory)."""
    _restart()
    yield
    _restart()


@pytest.fixture(scope="module")
def engines():
    jit = {}

    def ref_runner(cats=None, catalog="tpch", **props):
        r = RefRunner(cats or {"tpch": rconn}, default_catalog=catalog,
                      page_rows=PAGE_ROWS)
        if cats is None:
            r.executor._jit_cache = jit
        for k, v in props.items():
            r.session.set(k, v)
        return r

    def port_runner(cats=None, catalog="tpch", **props):
        return LocalRunner(cats or {"tpch": pconn},
                           default_catalog=catalog, device="cpu",
                           session={"page_rows": PAGE_ROWS, **props})

    pconn, rconn = TpchConnector(SF, device="cpu"), RefTpch(SF)
    port = types.SimpleNamespace(
        name="port", runner=port_runner, conn=pconn, persist=persist,
        shared=shared_cache_if_exists,
        Memory=lambda: MemoryConnector(device="cpu"))
    ref = types.SimpleNamespace(
        name="ref", runner=ref_runner, conn=rconn, persist=ref_persist,
        shared=ref_shared, Memory=RefMemory)
    return port, ref


def both(engines, tmp_path, scenario):
    """``scenario(E, directory)`` on each engine, each with its own
    persist directory; (port result, ref result)."""
    out = []
    for E in engines:
        _restart()
        d = tmp_path / E.name
        d.mkdir()
        out.append(scenario(E, d))
    return tuple(out)


def _persist(E, d, **extra):
    return E.runner(result_cache_enabled=True,
                    result_cache_persist_dir=str(d), **extra)


# ----------------------------------------------------- warm-start pin
def test_warm_start_pin(engines, tmp_path):
    """The restart contract, and sqlite parity of the warm-served
    rows."""
    from tests.oracle import load_sqlite

    def sc(E, d):
        cold = _persist(E, d).execute(AGG_Q).rows
        made = bool(E.persist.manifest_files(str(d)))
        _restart()
        r2 = _persist(E, d)
        warm = r2.execute(AGG_Q).rows
        return cold, warm, made, _counters(r2.executor)

    port, ref = both(engines, tmp_path, sc)
    assert port == ref
    cold, warm, made, ctr = port
    assert made and warm == cold
    assert ctr["cache_warm_loads"] >= 1 and ctr["result_cache_hits"] >= 1
    assert ctr["program_launches"] == 0
    db = load_sqlite(engines[1].conn, ["lineitem"])
    want = db.execute(
        "select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
        "from lineitem group by l_returnflag, l_linestatus "
        "order by l_returnflag, l_linestatus").fetchall()
    assert [tuple(x) for x in want] == [tuple(x) for x in warm]


def test_warm_load_runs_once_per_persister(engines, tmp_path):
    def sc(E, d):
        _persist(E, d).execute(AGG_Q)
        _restart()
        r2 = _persist(E, d)
        r2.execute(AGG_Q)
        loads0 = r2.executor.cache_warm_loads
        r2.execute(AGG_Q)
        return loads0, r2.executor.cache_warm_loads, E.shared().warm_loads

    port, ref = both(engines, tmp_path, sc)
    assert port == ref
    assert port[0] >= 1 and port[0] == port[1] == port[2]


# -------------------------------------------------- DML interactions
def _mem(E, d, mem):
    return E.runner({"mem": mem}, "mem", result_cache_enabled=True,
                    result_cache_persist_dir=str(d))


def test_dml_between_runs_forces_miss(engines, tmp_path):
    def sc(E, d):
        mem = E.Memory()
        r1 = _mem(E, d, mem)
        r1.execute("create table t as select 1 x, 10 y")
        q = "select count(*) c, sum(y) s from t"
        out = [r1.execute(q).rows]
        _restart()
        r2 = _mem(E, d, mem)
        # the INSERT's session warm-loads the entry, then the write
        # invalidates it: a live entry's lifecycle
        r2.execute("insert into t select 2, 20")
        hits0 = r2.executor.result_cache_hits
        out += [r2.execute(q).rows, r2.executor.result_cache_hits - hits0,
                _counters(r2.executor)]
        return out

    port, ref = both(engines, tmp_path, sc)
    assert port == ref
    assert port[:3] == [[(1, 10)], [(2, 30)], 0]


def test_out_of_band_snapshot_bump_drops_on_warm_load(engines, tmp_path):
    """The token moved while no cache-enabled session watched: the warm
    load proves the mismatch against the live connector and drops the
    entry loudly."""
    def sc(E, d):
        mem = E.Memory()
        r1 = _mem(E, d, mem)
        r1.execute("create table t as select 1 x, 10 y")
        q = "select count(*) c, sum(y) s from t"
        out = [r1.execute(q).rows]
        _restart()
        E.runner({"mem": mem}, "mem").execute("insert into t select 2, 20")
        r2 = _mem(E, d, mem)
        out += [r2.execute(q).rows, _counters(r2.executor)]
        return out

    port, ref = both(engines, tmp_path, sc)
    assert port == ref
    assert port[:2] == [[(1, 10)], [(2, 30)]]
    assert port[2]["cache_manifest_drops"] >= 1
    assert port[2]["result_cache_hits"] == 0


# ---------------------------------------------- manifest corruption
def _seeded(E, d):
    cold = _persist(E, d).execute(AGG_Q).rows
    assert E.persist.manifest_files(str(d))
    _restart()
    return cold


def test_truncated_manifest_loads_zero_loudly(engines, tmp_path):
    """A torn trailing record inside the FIRST record line: zero entries
    survive, the drop is counted, the query recomputes."""
    def sc(E, d):
        cold = _seeded(E, d)
        _, path = E.persist.manifest_files(str(d))[0]
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[:blob.index(b"\n") + 1 + 10])
        r = _persist(E, d)
        return r.execute(AGG_Q).rows == cold, _counters(r.executor)

    port, ref = both(engines, tmp_path, sc)
    assert port == ref
    assert port[0] and port[1]["cache_warm_loads"] == 0
    assert port[1]["cache_manifest_drops"] >= 1


def test_missing_entry_file_drops_that_entry(engines, tmp_path):
    def sc(E, d):
        cold = _seeded(E, d)
        doc = E.persist.read_manifest_doc(str(d))
        n = len(doc["entries"])
        for meta in doc["entries"].values():
            os.unlink(d / meta["file"])
        r = _persist(E, d)
        ok = r.execute(AGG_Q).rows == cold
        # the dead records were pruned and the recompute re-published:
        # every record's payload file exists again
        doc2 = E.persist.read_manifest_doc(str(d))
        back = all(os.path.exists(d / m["file"])
                   for m in doc2["entries"].values())
        return n, ok, back, _counters(r.executor)

    port, ref = both(engines, tmp_path, sc)
    assert port == ref
    n, ok, back, ctr = port
    assert n >= 1 and ok and back
    assert ctr["cache_warm_loads"] == 0 and ctr["cache_manifest_drops"] >= n


@pytest.mark.parametrize("field,value", [("serde", "XXX0"),
                                         ("version", 99)],
                         ids=["serde", "version"])
def test_manifest_header_skew_drops(engines, tmp_path, field, value):
    """A wire-serde fingerprint skew (the counterpart of
    test_serde_fingerprint_mismatch_drops_all) and a manifest version
    skew (test_manifest_version_skew_drops_loudly) load nothing and
    count every drop."""
    def sc(E, d):
        cold = _seeded(E, d)
        doc = E.persist.read_manifest_doc(str(d))
        n = len(doc["entries"])
        doc[field] = value
        E.persist.rewrite_manifest_doc(str(d), doc)
        r = _persist(E, d)
        return n, r.execute(AGG_Q).rows == cold, _counters(r.executor)

    port, ref = both(engines, tmp_path, sc)
    assert port == ref
    n, ok, ctr = port
    assert n >= 1 and ok and ctr["cache_warm_loads"] == 0
    assert ctr["cache_manifest_drops"] >= (n if field == "serde" else 1)


# ---------------------------------------------- generation manifest
def test_manifest_publish_appends_single_generation(engines, tmp_path):
    """Below the threshold every publish is an O(1) append to ONE
    generation file; removals are tombstone records."""
    def sc(E, d):
        st = E.persist.ManifestStore(str(d), compact_threshold=1000)
        for i in range(20):
            st.publish(f"k{i}", {"v": i})
        files = E.persist.manifest_files(str(d))
        n = len(E.persist.read_manifest_doc(str(d))["entries"])
        st.remove(["k0", "k1"])
        snap = E.persist.ManifestStore(
            str(d), compact_threshold=1000).entries_snapshot()
        return ([g for g, _ in files], n,
                len(E.persist.manifest_files(str(d))), snap)

    port, ref = both(engines, tmp_path, sc)
    assert port == ref
    assert port[:3] == ([0], 20, 1) and len(port[3]) == 18


def test_manifest_compacts_past_threshold(engines, tmp_path):
    def sc(E, d):
        st = E.persist.ManifestStore(str(d), compact_threshold=8)
        for i in range(30):
            st.publish(f"k{i % 5}", {"v": i})
        files = E.persist.manifest_files(str(d))
        st2 = E.persist.ManifestStore(str(d), compact_threshold=8)
        return ([g for g, _ in files],
                len(E.persist.read_manifest_doc(str(d))["entries"]),
                st2.entries_snapshot() == st.entries_snapshot(),
                st2.broken_count)

    port, ref = both(engines, tmp_path, sc)
    assert port == ref
    gens, n, same, broken = port
    assert len(gens) == 1 and gens[0] >= 1 and n == 5 and same
    assert broken == 0


def test_partial_compaction_falls_back_a_generation(engines, tmp_path):
    def sc(E, d):
        st = E.persist.ManifestStore(str(d), compact_threshold=1000)
        for i in range(4):
            st.publish(f"k{i}", {"v": i})
        gen, _ = E.persist.manifest_files(str(d))[0]
        with open(os.path.join(str(d), f"manifest.g{gen + 1:06d}.jsonl"),
                  "wb") as f:
            f.write(b"\x00garbage{{{not json\n")
        st2 = E.persist.ManifestStore(str(d), compact_threshold=1000)
        out = (len(st2.entries_snapshot()), st2.broken_count >= 1,
               any("garbage" in r or "g%06d" % (gen + 1) in r
                   for r in st2.broken_reasons))
        st2.publish("k9", {"v": 9})
        st3 = E.persist.ManifestStore(str(d), compact_threshold=1000)
        return out + ("k9" in st3.entries_snapshot(),)

    port, ref = both(engines, tmp_path, sc)
    assert port == ref == (4, True, True, True)


def test_manifest_concurrent_publishers(engines, tmp_path):
    """Racing publishers all land (graded under the armed lock
    sanitizer)."""
    def sc(E, d):
        st = E.persist.ManifestStore(str(d), compact_threshold=64)

        def worker(tid):
            for i in range(40):
                st.publish(f"t{tid}.k{i}", {"v": i})

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st2 = E.persist.ManifestStore(str(d), compact_threshold=64)
        return (len(st.entries_snapshot()), len(st2.entries_snapshot()),
                st2.broken_count)

    port, ref = both(engines, tmp_path, sc)
    assert port == ref == (240, 240, 0)


# --------------------------------------------------- subsumption
def test_subsumption_pin(engines, tmp_path):
    """A cached WHERE d < 10 serves WHERE d < 5 by a residual filter,
    with the sqlite oracle's rows."""
    from tests.oracle import load_sqlite

    def sc(E, _d):
        r = E.runner(result_cache_enabled=True,
                     result_cache_subsumption=True)
        wide = r.execute(WIDE_Q).rows
        sub0 = r.executor.cache_subsumed_hits
        narrow = r.execute(NARROW_Q).rows
        return wide, narrow, sub0, _counters(r.executor)

    port, ref = both(engines, tmp_path, sc)
    assert port == ref
    wide, narrow, sub0, ctr = port
    assert sub0 == 0 and ctr["cache_subsumed_hits"] >= 1
    assert ctr["result_cache_hits"] >= 1
    db = load_sqlite(engines[1].conn, ["lineitem"])
    for rows, bound in ((narrow, 500), (wide, 1000)):
        want = db.execute(
            "select l_orderkey, l_quantity from lineitem where "
            f"l_quantity < {bound} order by l_orderkey, l_quantity"
        ).fetchall()
        assert [tuple(x) for x in want] == [tuple(x) for x in rows]


def test_subsumption_noncontained_misses(engines, tmp_path):
    def sc(E, _d):
        r = E.runner(result_cache_enabled=True,
                     result_cache_subsumption=True)
        r.execute(WIDE_Q)
        sub0 = r.executor.cache_subsumed_hits
        got = r.execute(DISJOINT_Q).rows
        return got, r.executor.cache_subsumed_hits - sub0

    port, ref = both(engines, tmp_path, sc)
    assert port == ref and port[1] == 0
    assert _rows_equal(port[0], engines[1].runner().execute(
        DISJOINT_Q).rows)


def test_subsumed_result_republishes_exact_key(engines, tmp_path):
    def sc(E, _d):
        r = E.runner(result_cache_enabled=True,
                     result_cache_subsumption=True)
        r.execute(WIDE_Q)
        r.execute(NARROW_Q)
        sub0 = r.executor.cache_subsumed_hits
        hits0 = r.executor.result_cache_hits
        rows = r.execute(NARROW_Q).rows
        return (rows, r.executor.cache_subsumed_hits - sub0,
                r.executor.result_cache_hits - hits0,
                rows == r.execute(NARROW_Q).rows)

    port, ref = both(engines, tmp_path, sc)
    assert port == ref
    assert port[1] == 0 and port[2] >= 1 and port[3]


def test_estimate_memory_discounts_cached_fragments(engines, tmp_path):
    """A plan whose fragments are RESIDENT in the cache replays host
    pages: the arbiter's estimate drops, and clearing the cache restores
    it."""
    q = ("select * from orders join lineitem "
         "on o_orderkey = l_orderkey order by o_totalprice")

    def sc(E, _d):
        r = E.runner(result_cache_enabled=True)
        cold = r.estimate_memory(q)
        r.execute(q)
        warm = r.estimate_memory(q)
        E.shared().clear()
        return cold, warm, r.estimate_memory(q)

    port, ref = both(engines, tmp_path, sc)
    cold, warm, again = port
    assert warm < cold and again == cold
    # the port's page shapes differ from the reference's, so only the
    # shape of the discount is compared
    assert (ref[1] < ref[0]) and ref[2] == ref[0]


def test_subsumption_off_by_default(engines, tmp_path):
    def sc(E, _d):
        r = E.runner(result_cache_enabled=True)
        r.execute(WIDE_Q)
        r.execute(NARROW_Q)
        return r.executor.cache_subsumed_hits

    port, ref = both(engines, tmp_path, sc)
    assert port == ref == 0
