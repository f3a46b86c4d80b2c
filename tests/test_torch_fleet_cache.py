"""The fleet half of the result cache (dist/cacheprobe.py): presto_tpu_torch
against presto_tpu.

The counterparts of the 6 default cases of tests/test_fleet_cache.py:
the bloom index's contract (a summary's keys answer "maybe", an unknown
peer and a garbage summary fail closed) and its free common miss; the
coordinator-side key mirror computing exactly the keys the workers'
executions stored; the probe short-circuiting dispatch on the second
run over the legacy cut and over the forced stage DAG
(cache_remote_hits, the workers' serve tally, rows equal); and the
session property turning the probe off. Each fleet case runs on two
port workers and on two reference workers with the same statements,
and holds the port's rows and counters to the reference's. The
cross-process pin (marked slow in the reference) has no counterpart.
"""

import collections
import types

import pytest
import torch

from presto_tpu.cache import shared_cache_if_exists as ref_shared
from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.dist import cacheprobe as RCP
from presto_tpu.dist import fragmenter as RFR
from presto_tpu.dist.dcn import DcnRunner as RefDcn
from presto_tpu.server.worker import WorkerServer as RefWorker
from presto_tpu_torch.cache import shared_cache_if_exists
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist import cacheprobe as CP
from presto_tpu_torch.dist import fragmenter as FR
from presto_tpu_torch.dist.dcn import DcnRunner
from presto_tpu_torch.server.worker import WorkerServer

SF = 0.01
PAGE_ROWS = 1 << 13

AGG_Q = ("select l_returnflag, count(*) c, sum(l_quantity) q "
         "from lineitem group by l_returnflag")


def rows_equal(a, b):
    return collections.Counter(map(repr, a)) == collections.Counter(
        map(repr, b))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clear():
    for rc in (shared_cache_if_exists(), ref_shared()):
        if rc is not None:
            rc.configure(persist_dir="")
            rc.clear()


@pytest.fixture(autouse=True)
def _clean_shared_caches():
    _clear()
    yield
    _clear()


PORT = types.SimpleNamespace(
    name="port", CP=CP, FR=FR, shared=shared_cache_if_exists,
    worker=lambda node: WorkerServer(
        {"tpch": TpchConnector(SF, device="cpu")}, node_id=node,
        default_catalog="tpch", page_rows=PAGE_ROWS, device="cpu"),
    coord=lambda uris, props: DcnRunner(
        {"tpch": TpchConnector(SF, device="cpu")}, uris,
        default_catalog="tpch", device="cpu",
        session_props={"page_rows": PAGE_ROWS, **props}))
REF = types.SimpleNamespace(
    name="ref", CP=RCP, FR=RFR, shared=ref_shared,
    worker=lambda node: RefWorker({"tpch": RefTpch(SF)}, node_id=node,
                                  default_catalog="tpch",
                                  page_rows=PAGE_ROWS),
    coord=lambda uris, props: RefDcn(
        {"tpch": RefTpch(SF)}, uris, default_catalog="tpch",
        page_rows=PAGE_ROWS, session_props=props))


# ------------------------------------------------------- bloom index
def test_bloom_index_contract():
    keys = [f"frag:abc:{i}:k1.p1" for i in range(8)]
    assert CP.bloom_summary(keys) == RCP.bloom_summary(keys)
    idx = CP.RemoteCacheIndex()
    idx.update("http://a", CP.bloom_summary(keys))
    assert all(idx.might_contain("http://a", k) for k in keys)
    # no summary for an unknown peer: FAIL CLOSED (no probe traffic)
    assert not idx.might_contain("http://b", keys[0])
    assert idx.known()
    # a garbage summary un-registers the peer rather than crash
    idx.update("http://a", "not base64!!")
    assert not idx.might_contain("http://a", keys[0])


def test_bloom_negative_is_free():
    out = []
    for cp in (CP, RCP):
        idx = cp.RemoteCacheIndex()
        idx.update("http://a", cp.bloom_summary(["frag:only:1:k1.p1"]))
        out.append(sum(idx.might_contain("http://a",
                                         f"frag:other:{i}:k1.p1")
                       for i in range(64)))
    assert out[0] == out[1] <= 2


# -------------------------------------------------- key mirror + e2e
def _fleet(E, props, scenario):
    ws = [E.worker("w1"), E.worker("w2")]
    uris = [f"http://127.0.0.1:{w.start()}" for w in ws]
    coord = E.coord(uris, props)
    try:
        return scenario(E, coord)
    finally:
        coord.close()
        for w in ws:
            w.stop()


def _both(props, scenario):
    out = []
    for E in (PORT, REF):
        _clear()
        out.append(_fleet(E, props, scenario))
    return tuple(out)


def test_probe_key_mirror_matches_worker_keys():
    """fragment_cache_key (coordinator side, no dispatch) computes the
    exact keys the workers' executions stored."""
    def sc(E, coord):
        coord.execute(AGG_Q)
        stored = set(E.shared().pages_keys())
        run = coord.runner
        dag = E.FR.fragment_dag(run.executor, run.plan(AGG_Q),
                                run.catalogs)
        mirrored = set()
        for frag in dag.fragments:
            if frag.split_table and not frag.inputs:
                for i in range(2):
                    mirrored.add(E.CP.fragment_cache_key(
                        frag.root, run.catalogs,
                        split_table=frag.split_table, split_index=i,
                        split_count=2, collect_k=run.executor.collect_k,
                        page_rows=run.executor.page_rows))
        return len(stored), stored == mirrored, None in mirrored

    port, ref = _both({"result_cache_enabled": "true"}, sc)
    assert port == ref == (2, True, False)


@pytest.mark.parametrize("props", [
    {"result_cache_enabled": "true"},                       # legacy cut
    {"result_cache_enabled": "true", "stage_scheduler": "true"},  # DAG
], ids=["classic", "dag"])
def test_fleet_hit_short_circuits_dispatch(props):
    def sc(E, coord):
        r1 = coord.execute(AGG_Q)
        hits0 = coord.runner.executor.cache_remote_hits
        coord.heartbeat.check_once()      # pull the cacheSummary blooms
        r2 = coord.execute(AGG_Q)
        return (sorted(r1), sorted(r2), coord.last_distribution, hits0,
                coord.runner.executor.cache_remote_hits,
                E.shared().remote_hits)

    port, ref = _both(props, sc)
    assert port == ref
    r1, r2, dist, hits0, hits, served = port
    assert rows_equal(r1, r2) and hits0 == 0 and hits >= 1 and served >= 1


def test_probe_disabled_by_session_prop():
    def sc(E, coord):
        r1 = coord.execute(AGG_Q)
        coord.heartbeat.check_once()
        r2 = coord.execute(AGG_Q)
        return sorted(r1), sorted(r2), coord.runner.executor.cache_remote_hits

    port, ref = _both({"result_cache_enabled": "true",
                       "result_cache_remote_probe": "false"}, sc)
    assert port == ref
    assert port[0] == port[1] and port[2] == 0
