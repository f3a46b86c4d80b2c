"""The runtime lock sanitizer (presto_tpu_torch/obs/sanitizer.py): the
counterparts of tests/test_sanitizer.py's tests on the port's
primitives, the port's concurrency registry against its source, and a
distributed query through in-process workers that ends with no
violation.

Each capability is pinned by a deliberately misbehaving synthetic
owner: ordering inversions, re-entrant acquisition, unlocked
shared-attr writes, Condition integration, and the zero-cost off path.
The conftest arms the sanitizer suite-wide (PRESTO_TPU_LOCK_SANITIZER);
these tests manage the armed state explicitly so they pass standalone
too.
"""

import ast
import os
import threading

import pytest
import torch

from presto_tpu_torch.obs import sanitizer as SAN

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


@pytest.fixture
def armed():
    """Armed sanitizer with clean state; restores prior arming."""
    was = SAN.is_armed()
    SAN.arm()
    SAN.reset()
    yield SAN
    SAN.reset()
    if not was:
        SAN.disarm()


# ----------------------------------------------------------- off path
def test_disarmed_returns_plain_primitives():
    was = SAN.is_armed()
    SAN.disarm()
    try:
        lk = SAN.make_lock("x.y.z")
        assert isinstance(lk, type(threading.Lock()))
        cv = SAN.make_condition("x.y.cv")
        assert isinstance(cv, threading.Condition)

        class Plain:
            _shared_attrs = ("n",)

            def __init__(self):
                self._lock = SAN.make_lock("x.Plain._lock")
                self.n = 0
                SAN.register_owner(self)

        p = Plain()
        assert type(p) is Plain  # no class swap when off
        p.n = 5  # unchecked when off
        assert SAN.violation_count() == 0
    finally:
        if was:
            SAN.arm()


# ------------------------------------------------------ held/ordering
def test_ordering_recorded_and_inversion_detected(armed):
    a = SAN.make_lock("t.A")
    b = SAN.make_lock("t.B")
    with a:
        with b:
            pass
    assert ("t.A", "t.B") in SAN.order_edges()
    assert SAN.violation_count() == 0
    with b:
        with a:  # the opposite order: the two-thread deadlock shape
            pass
    v = SAN.violations()
    assert len(v) == 1 and "lock-order inversion" in v[0]
    assert "t.A" in v[0] and "t.B" in v[0]
    assert "test_torch_sanitizer.py" in v[0]  # both sites named


def test_consistent_order_is_silent(armed):
    a = SAN.make_lock("t.A")
    b = SAN.make_lock("t.B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert SAN.violation_count() == 0


def test_reentrant_acquire_raises_instead_of_deadlocking(armed):
    a = SAN.make_lock("t.R")
    with a:
        with pytest.raises(RuntimeError, match="re-entrant"):
            a.acquire()
    assert any("re-entrant" in v for v in SAN.violations())
    with a:  # the lock recovered
        pass


def test_release_clears_held_set(armed):
    a = SAN.make_lock("t.H")
    with a:
        assert a.held_by_me()
    assert not a.held_by_me()


# ------------------------------------------------- shared-attr checks
class _Owner:
    _shared_attrs = ("n",)

    def __init__(self):
        self._lock = SAN.make_lock("t.Owner._lock")
        self.n = 0
        SAN.register_owner(self)

    def bump_locked(self):
        with self._lock:
            self.n += 1

    def bump_racy(self):
        self.n += 1


def test_unlocked_shared_write_detected(armed):
    o = _Owner()
    o.bump_locked()
    assert SAN.violation_count() == 0
    o.bump_racy()
    v = SAN.violations()
    assert len(v) == 1 and "unlocked shared-attr write" in v[0]
    assert ".n" in v[0] and "t.Owner._lock" in v[0]
    assert o.n == 2  # the write itself still lands


def test_instrumented_class_keeps_name_and_isinstance(armed):
    o = _Owner()
    assert type(o).__name__ == "_Owner"
    assert isinstance(o, _Owner)


def test_unshared_attrs_are_not_checked(armed):
    o = _Owner()
    o.other = 7
    assert SAN.violation_count() == 0


def test_multi_lock_owner_any_lock_satisfies(armed):
    class Two:
        _shared_attrs = ("x",)

        def __init__(self):
            self._a_lock = SAN.make_lock("t.Two._a_lock")
            self._b_lock = SAN.make_lock("t.Two._b_lock")
            self.x = 0
            SAN.register_owner(self, lock_attrs=("_a_lock", "_b_lock"))

    t = Two()
    with t._b_lock:
        t.x = 1
    assert SAN.violation_count() == 0
    t.x = 2
    assert SAN.violation_count() == 1


# -------------------------------------------------------- Conditions
def test_condition_fronts_sanitized_lock(armed):
    class Arbiter:
        _shared_attrs = ("used",)

        def __init__(self):
            self._cv = SAN.make_condition("t.Arbiter._cv")
            self.used = 0
            SAN.register_owner(self, lock_attrs=("_cv",))

    a = Arbiter()
    with a._cv:
        a.used += 1
        a._cv.wait(0.01)  # releases + reacquires through the wrapper
        a.used += 1
        a._cv.notify_all()
    assert SAN.violation_count() == 0
    a.used = 0
    assert SAN.violation_count() == 1


def test_condition_alias_unifies_held_set(armed):
    lk = SAN.make_lock("t.Alias._lock")
    cv = SAN.make_condition(lock=lk)
    with cv:
        assert lk.held_by_me()
    assert not lk.held_by_me()


# ------------------------------------------------ cross-thread races
def test_real_two_thread_race_is_caught(armed):
    o = _Owner()
    stop = threading.Event()

    def racer():
        while not stop.is_set():
            o.bump_racy()

    t = threading.Thread(target=racer, daemon=True)
    t.start()
    for _ in range(50):
        o.bump_locked()
    stop.set()
    t.join(timeout=5)
    assert SAN.violation_count() > 0


def test_profile_store_instance_map_race_single_winner(tmp_path):
    """ProfileStore.at builds outside the instance-map lock, and racing
    lookups still converge on ONE shared instance."""
    from presto_tpu_torch.obs.profile import ProfileStore

    d = str(tmp_path / "profiles")
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        ProfileStore.at(d))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(got) == 8 and all(s is got[0] for s in got)


def test_engine_locks_are_instrumented_under_pytest(tmp_path):
    """The conftest's arming reached the port: its module-level locks
    (created at import) and fresh owners carry sanitized locks, and
    the owners' classes are instrumented."""
    if not SAN.is_armed():
        pytest.skip("sanitizer disarmed via PRESTO_TPU_LOCK_SANITIZER")
    from presto_tpu_torch import cuda
    from presto_tpu_torch.dist import connpool
    from presto_tpu_torch.exec import graphs
    from presto_tpu_torch.obs.profile import ProfileStore
    from presto_tpu_torch.obs.trace import QueryTrace
    from presto_tpu_torch.ops import consts
    from presto_tpu_torch.server import worker

    for lk in (graphs._stats_lock, graphs._programs_lock, consts._lock,
               cuda._lock, cuda._count_lock, worker._runtimes_lock,
               connpool.ConnectionPool()._lock):
        assert isinstance(lk, SAN._SanitizedLock)
        assert lk.name in SAN.LOCK_REGISTRY
    tr = QueryTrace("q")
    store = ProfileStore(str(tmp_path))
    for owner in (tr, store):
        assert isinstance(owner._lock, SAN._SanitizedLock)
        assert getattr(type(owner), "_san_instrumented", False)


def test_result_cache_locks_are_instrumented_under_pytest():
    """The counterpart of the reference's ResultCache case: a store
    built after arming carries a sanitized lock, its class keeps its
    name and is instrumented (so the cache-on serving race really runs
    under the sanitizer); so do the shared-store lock and the fleet
    index."""
    if not SAN.is_armed():
        pytest.skip("sanitizer disarmed via PRESTO_TPU_LOCK_SANITIZER")
    from presto_tpu_torch.cache import store
    from presto_tpu_torch.cache.store import ResultCache
    from presto_tpu_torch.dist.cacheprobe import RemoteCacheIndex

    rc = ResultCache(budget_bytes=1 << 20)
    assert isinstance(rc._lock, SAN._SanitizedLock)
    assert type(rc).__name__ == "ResultCache"
    assert getattr(type(rc), "_san_instrumented", False)
    idx = RemoteCacheIndex()
    for lk in (rc._lock, store._shared_lock, idx._lock):
        assert isinstance(lk, SAN._SanitizedLock)
        assert lk.name in SAN.LOCK_REGISTRY
    # a shared-attr write under the lock is silent, one outside is not
    before = SAN.violation_count()
    rc.put_rows("k", ["a"], [(1,)], ["bigint"], {("m", "t")})
    assert rc.get_rows("k") == (["a"], [(1,)], ["bigint"])
    assert SAN.violation_count() == before


# --------------------------------------------------- the registries
def _sites():
    """(make_lock names, threading.Lock/RLock/Condition creations
    outside the sanitizer, thread targets) over the port's source."""
    names, raw, targets = set(), [], set()
    for dp, _dn, fns in os.walk(PKG_ROOT):
        for fn in fns:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dp, fn)
            mod = os.path.relpath(path, PKG_ROOT)[:-3].replace(os.sep, ".")
            for n in ast.walk(ast.parse(open(path).read())):
                if not isinstance(n, ast.Call):
                    continue
                f = n.func
                fname = (f.attr if isinstance(f, ast.Attribute)
                         else f.id if isinstance(f, ast.Name) else "")
                if (fname == "make_lock" and n.args
                        and isinstance(n.args[0], ast.Constant)):
                    names.add(n.args[0].value)
                if (isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "threading"
                        and f.attr in ("Lock", "RLock", "Condition")
                        and mod != "obs.sanitizer"):
                    raw.append((mod, n.lineno))
                if (isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "threading"
                        and f.attr == "Thread"):
                    for kw in n.keywords:
                        if kw.arg == "target":
                            targets.add(f"{mod}:{ast.unparse(kw.value)}")
    return names, raw, targets


def test_lock_and_thread_registries_match_the_source():
    names, raw, targets = _sites()
    assert raw == []  # every lock goes through make_lock
    assert names == set(SAN.LOCK_REGISTRY)
    assert targets == set(SAN.THREAD_REGISTRY)
    for help_text in list(SAN.LOCK_REGISTRY.values()) + list(
            SAN.THREAD_REGISTRY.values()):
        assert help_text.strip()


def test_distributed_query_ends_without_violations():
    """A DcnRunner query through two in-process workers (task threads,
    HTTP handler threads, the coordinator's drain) under the armed
    sanitizer records no violation."""
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.dist.dcn import DcnRunner
    from presto_tpu_torch.server.worker import WorkerServer

    was = SAN.is_armed()
    SAN.arm()
    SAN.reset()
    ws = []
    try:
        for i in range(2):
            w = WorkerServer({"tpch": TpchConnector(0.01, device="cpu")},
                             node_id=f"w{i}", default_catalog="tpch",
                             page_rows=1 << 13, device="cpu")
            w.start()
            ws.append(w)
        assert isinstance(ws[0]._tasks_lock, SAN._SanitizedLock)
        coord = DcnRunner(
            {"tpch": TpchConnector(0.01, device="cpu")},
            [w.uri for w in ws], default_catalog="tpch",
            session_props={"join_distribution_type": "partitioned",
                           "device_exchange_enabled": "false",
                           "generated_join_enabled": "false",
                           "query_trace_enabled": "true",
                           "stage_scheduler": "true",
                           "page_rows": 1 << 13},
            device="cpu")
        rows = coord.execute(
            "select o_orderpriority, count(*) from orders join lineitem "
            "on o_orderkey = l_orderkey group by 1 order by 1")
        assert coord.last_distribution == "stage-dag"
        assert len(rows) == 5
        assert SAN.violations() == [], SAN.report()
    finally:
        for w in ws:
            w.stop()
        SAN.reset()
        if not was:
            SAN.disarm()
