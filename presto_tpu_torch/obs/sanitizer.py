"""Runtime lock sanitizer and the port's concurrency registry.

Port of presto_tpu/obs/sanitizer.py (reference: the concurrency tooling
the Java original leans on — ``@GuardedBy`` annotations and
ThreadSanitizer-style CI jobs). An opt-in instrumented lock records what
actually happens at runtime:

  - per-thread held-lock sets and every observed acquisition ordering
    (lock A held while acquiring lock B);
  - lock-order INVERSIONS observed live (A-then-B somewhere, B-then-A
    somewhere else — the two-thread deadlock shape), with both sites;
  - re-entrant acquisition of a non-reentrant lock (a guaranteed
    self-deadlock: the sanitizer raises instead of hanging);
  - writes to a class's declared ``_shared_attrs`` without any of the
    object's registered locks held.

Zero cost when off: ``make_lock``/``make_condition`` return plain
``threading`` primitives and ``register_owner`` is one boolean check.
Armed (environment ``PRESTO_TPU_LOCK_SANITIZER=1``, which the test
suite's conftest sets before any import), every lock the port creates
through ``make_lock`` is a ``_SanitizedLock`` and every registered
owner's class is swapped for an instrumented subclass whose
``__setattr__`` checks the lock contract. Violations accumulate in a
process-wide list (they never raise except for the guaranteed-deadlock
case): harnesses assert ``violations()`` is empty after racing the
engine. The environment is read once, when this module is imported, so
the locks modules create at import time are already instrumented.

Granularity, as in the reference: ordering is tracked by lock NAME (two
instances of one lock rank are not ordered against each other), and
``__setattr__`` instrumentation sees attribute rebinds only.

The two registries declare every lock the port creates and every thread
target it spawns, under canonical site names (the dotted module path
under presto_tpu_torch/ plus the owning class and attribute — the
literal each ``make_lock`` call passes); tests/test_torch_sanitizer.py
cross-checks them against the source.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------
# THE concurrency registry (site name -> what the lock guards).

LOCK_REGISTRY: Dict[str, str] = {
    "cache.persist.ManifestStore._lock":
        "one manifest's entry map, pending-append queue and claim "
        "flags (every append and compaction runs OUTSIDE it)",
    "cache.store.ResultCache._lock":
        "the result cache's entry map, byte accounting, family index "
        "and tallies (per-query runners and workers share one store; "
        "page payloads are immutable once published, and persistence "
        "file I/O runs OUTSIDE it)",
    "cache.store._shared_lock":
        "creation of the process-shared ResultCache",
    "connectors.stream.StreamConnector._cv":
        "the append log's table map and offsets (appends, scan "
        "snapshots, tail pollers; fronted by a Condition whose "
        "notify_all wakes every wait_for_offset long-poller — page "
        "copies run OUTSIDE it over immutable chunks)",
    "cuda._lock":
        "kernel library builds and loads (one nvcc per source, once)",
    "cuda._count_lock":
        "the kernel launch and plain-twin call counters",
    "dist.checkpoint.CheckpointJournal._lock":
        "the journal's in-memory query records (barrier mutations; the "
        "durable publish runs OUTSIDE it)",
    "dist.cacheprobe.RemoteCacheIndex._lock":
        "the coordinator's per-worker bloom summaries (heartbeat threads "
        "write them, dispatch threads read them)",
    "dist.connpool.ConnectionPool._lock":
        "the per-destination keep-alive connection free-lists (take/put "
        "are pure list ops — every connect, send and read happens "
        "OUTSIDE the lock)",
    "exec.graphs._stats_lock":
        "the process totals of graph captures, capture seconds and "
        "replays",
    "exec.graphs.Program._lock":
        "one fused program: its capture and every replay run one call "
        "at a time (the static input buffers and outputs are shared)",
    "exec.graphs._programs_lock":
        "the process-wide LRU map of captured programs",
    "expr.functions._dict_lock":
        "the per-dictionary host-result cache of the string functions",
    "expr.functions_more._pair_lock":
        "the pair-universe cache of two-dictionary functions",
    "obs.histo.Histogram._lock":
        "one latency histogram's buckets (completion paths observe, "
        "/metrics scrapes)",
    "obs.profile.ProfileStore._instances_lock":
        "the per-directory ProfileStore instance map (class-level)",
    "obs.profile.ProfileStore._lock":
        "one profile store's in-memory profile cache",
    "obs.trace.QueryTrace._lock":
        "one query's span list (the scheduler's dispatch loop and the "
        "root fragment's executor record concurrently)",
    "ops.consts._lock":
        "the staged host-constant cache (one device tensor per content)",
    "server.heartbeat.HeartbeatFailureDetector._lock":
        "the peer health map (the ping loop vs /v1/node readers)",
    "server.http_server.MemoryArbiter._cv":
        "the arbiter's reserved bytes and active count (every admitted "
        "query's thread; fronted by a Condition)",
    "server.http_server.QueryManager._exec_lock":
        "the serial path: one query on the bootstrap runner at a time",
    "server.http_server.QueryManager._lock":
        "the query registry and the /metrics tallies (HTTP handler "
        "threads vs query threads)",
    "server.http_server.TailCursor._cv":
        "one tailing cursor's emitted rows, token spans and poll "
        "serialization flag (concurrent protocol GETs on one cursor; "
        "fronted by a Condition); the poll's query execution runs "
        "OUTSIDE it behind the _polling flag",
    "server.launch_batcher.LaunchBatcher._cv":
        "the pending gather groups and per-key in-flight counts of the "
        "cross-query batch point (fronted by a Condition; the shared "
        "launch runs OUTSIDE it)",
    "server.resource_groups.ResourceGroupManager._lock":
        "the per-group running/queued/memory tallies and the fair-"
        "scheduling waiter line (fronted by a Condition)",
    "server.worker._runtimes_lock":
        "the same-process placement registry (uri -> TaskRuntime) the "
        "mesh-local exchange fast path reads",
    "server.worker.TaskRuntime._tasks_lock":
        "the task registry (create/expire/cancel vs data-plane lookups)",
    "server.worker.TaskRuntime._fault_lock":
        "the runtime fault overlay and its call counters (POST "
        "/v1/fault vs the fetch and submit handlers)",
    "server.worker._TrackingHTTPServer._conns_lock":
        "a worker's set of open connections (handler threads vs "
        "stop(), which drops them)",
    "server.worker._Task.lock":
        "one task's spool and lifecycle flags (its execution thread vs "
        "the fetch/status/cancel handlers)",
    "streaming.ivm.IvmRegistry._lock":
        "the materialized-view registry (register and lookup by name "
        "and by statement shape fingerprint)",
    "streaming.ivm.MaterializedView._cv":
        "one view's persisted state, watermark and last-result "
        "publication plus the refresh serialization flag (fronted by "
        "a Condition); the refresh itself (delta scan, fold, "
        "finalize) runs OUTSIDE it behind _refreshing, so concurrent "
        "tailers coalesce onto one fold",
    "streaming.ivm._shared_lock":
        "creation of the process-shared IvmRegistry",
}

THREAD_REGISTRY: Dict[str, str] = {
    "server.heartbeat:self._loop":
        "the heartbeat detector's ping loop",
    "server.http_server:self._run":
        "one thread per submitted statement: admission, then execution",
    "server.http_server:self._reattach_run":
        "one journaled query's recovery on a restarted coordinator "
        "(dist/checkpoint.reattach_query, under the serial exec lock)",
    "server.http_server:self._httpd.serve_forever":
        "the coordinator's HTTP accept loop",
    "server.worker:self._run_task":
        "one thread per task: fragment execution into the spool",
    "server.worker:self._httpd.serve_forever":
        "the worker's HTTP accept loop",
    "server.worker:self.stop":
        "an in-process worker's death under FAULT_KILL_AFTER_FETCHES, "
        "off the handler thread that stop() waits on",
}

# ---------------------------------------------------------------------
# arming

_armed = os.environ.get("PRESTO_TPU_LOCK_SANITIZER", "") in (
    "1", "true", "on")
_THIS_FILE = os.path.abspath(__file__)
_THREADING_FILE = os.path.abspath(threading.__file__)

_tls = threading.local()
_meta = threading.Lock()  # raw on purpose: the instrumentation's own
_order: Dict[Tuple[str, str], str] = {}     # (held, acquired) -> site
_violations: List[str] = []
_subclasses: Dict[type, type] = {}


def arm() -> None:
    """Instrument locks created FROM NOW ON (creation-time choice:
    already-created plain locks stay plain)."""
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def is_armed() -> bool:
    return _armed


def reset() -> None:
    """Clear recorded violations and orderings (test isolation)."""
    with _meta:
        _violations.clear()
        _order.clear()


def violations() -> List[str]:
    with _meta:
        return list(_violations)


def violation_count() -> int:
    with _meta:
        return len(_violations)


def order_edges() -> Dict[Tuple[str, str], str]:
    """Observed (held, acquired) orderings with their first site."""
    with _meta:
        return dict(_order)


def report() -> str:
    """Human-readable violation dump (harness failure output)."""
    v = violations()
    if not v:
        return "# lock sanitizer: 0 violations"
    return "# lock sanitizer: {} violation(s)\n".format(len(v)) + \
        "\n".join(f"  - {x}" for x in v)


# ---------------------------------------------------------------------
# internals

def _held() -> List["_SanitizedLock"]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _site() -> str:
    """First caller frame outside this module and threading.py (the
    Condition wrapper calls acquire/release from threading.py)."""
    f = sys._getframe(1)
    for _ in range(12):
        if f is None:
            break
        fn = f.f_code.co_filename
        if fn not in (_THIS_FILE, _THREADING_FILE):
            return f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _violation(msg: str) -> None:
    with _meta:
        _violations.append(msg)


class _SanitizedLock:
    """Duck-typed non-reentrant lock recording held-sets/orderings.
    Works as a `threading.Condition` backing lock: Condition lifts
    acquire/release/_is_owned, so wait() keeps the held-set honest."""

    __slots__ = ("name", "_raw")

    def __init__(self, name: str):
        self.name = name
        self._raw = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        held = _held()
        for h in held:
            if h is self:
                msg = (f"re-entrant acquire of non-reentrant lock "
                       f"{self.name} at {_site()} — guaranteed "
                       f"self-deadlock")
                _violation(msg)
                raise RuntimeError(msg)
        if timeout == -1:
            got = self._raw.acquire(blocking)
        else:
            got = self._raw.acquire(blocking, timeout)
        if got:
            if held:
                site = _site()
                with _meta:
                    for h in held:
                        if h.name == self.name:
                            continue
                        pair = (h.name, self.name)
                        inverse = (self.name, h.name)
                        if inverse in _order and pair not in _order:
                            _violations.append(
                                f"lock-order inversion: {self.name} "
                                f"acquired while holding {h.name} at "
                                f"{site}, but the opposite order was "
                                f"observed at {_order[inverse]}")
                        _order.setdefault(pair, site)
            held.append(self)
        return got

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._raw.release()

    def __enter__(self) -> "_SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def _is_owned(self) -> bool:
        # lifted by threading.Condition (beats its acquire(0) probe)
        return any(h is self for h in _held())

    held_by_me = _is_owned


# ---------------------------------------------------------------------
# the factory surface engine modules create their locks through

def make_lock(name: str):
    """A lock for the canonical site ``name`` (a LOCK_REGISTRY key —
    tests/test_torch_sanitizer.py cross-checks the literal against
    the site)."""
    if _armed:
        return _SanitizedLock(name)
    return threading.Lock()


def make_condition(name: Optional[str] = None, lock=None):
    """A Condition; pass ``lock=`` to front an existing engine lock
    (the ResourceGroupManager shape — holding the Condition IS holding
    the lock, so the held-set stays unified), else a dedicated backing
    lock is created under ``name``."""
    if lock is None:
        assert name is not None, "make_condition needs a name or a lock"
        lock = make_lock(name)
    return threading.Condition(lock)


def _resolve_lock(obj, attr: str) -> Optional[_SanitizedLock]:
    x = getattr(obj, attr, None)
    if isinstance(x, _SanitizedLock):
        return x
    if isinstance(x, threading.Condition) and \
            isinstance(x._lock, _SanitizedLock):
        return x._lock
    return None


def _subclass_for(cls: type, lock_attrs: Tuple[str, ...]) -> type:
    sub = _subclasses.get(cls)
    if sub is not None:
        return sub
    shared = frozenset(getattr(cls, "_shared_attrs", ()) or ())

    def __setattr__(self, name, value):
        if name in shared:
            locks = [_resolve_lock(self, a) for a in lock_attrs]
            locks = [lk for lk in locks if lk is not None]
            if locks and not any(lk._is_owned() for lk in locks):
                _violation(
                    f"unlocked shared-attr write: "
                    f"{cls.__module__}.{cls.__name__}.{name} written "
                    f"without {'/'.join(lk.name for lk in locks)} "
                    f"held at {_site()}")
        object.__setattr__(self, name, value)

    sub = type(cls.__name__, (cls,), {
        "__setattr__": __setattr__,
        "_san_instrumented": True,
        "__module__": cls.__module__,
    })
    _subclasses[cls] = sub
    return sub


def register_owner(obj, lock_attrs=("_lock",)):
    """Called at the end of a lock-owning __init__: when armed, swap
    the instance's class for an instrumented subclass that checks every
    `_shared_attrs` rebind happens under one of ``lock_attrs``. No-op
    (one bool check) when off."""
    if not _armed:
        return obj
    cls = type(obj)
    if getattr(cls, "_san_instrumented", False):
        return obj
    if not getattr(cls, "_shared_attrs", None):
        return obj
    if not any(_resolve_lock(obj, a) for a in lock_attrs):
        return obj  # plain locks (created before arming): uncheckable
    try:
        obj.__class__ = _subclass_for(cls, tuple(lock_attrs))
    except TypeError:
        pass  # __slots__/extension classes cannot be swapped; skip
    return obj
