"""Cross-query launch batching: amortize the per-program launch cost
across CONCURRENT queries.

Port of presto_tpu/server/launch_batcher.py (pure Python, copied).
The shape a batching inference server uses: requests that arrive
within a short gather window and want the SAME program run as ONE
stacked device step with per-request demux. Split batching does this
within a query; this module does it across queries: the concurrent
server path hands every per-query executor one shared
``LaunchBatcher``, and compatible fused-pipeline launches (same
program-key family, same ``exec/shapes.py`` ladder bucket) gang into
one batched program whose results demux in-program (the batched
program returns one (page, flags) per slot, so each query walks away
with exactly the page its solo launch would have produced;
exec/executor.py builds it, a captured CUDA graph on the card).

Protocol (one Condition, no nesting):

  - the FIRST submitter for a key becomes the group LEADER and waits
    up to ``wait_ms`` (bounded gather window: a lone query never
    stalls longer than that) for peers, or until the group hits its
    width cap;
  - later submitters for the same key become FOLLOWERS: they park on
    the Condition until the leader publishes per-slot results;
  - at the window's close the leader dispatches the shared program
    OUTSIDE the lock (no device work under an engine lock) via the
    ``make_batched`` callback its executor passed in, then publishes;
  - CONTINUOUS BATCHING: while a same-key batch is already executing
    on the device, the next leader's window extends until that batch
    publishes (bounded by FOLLOW_TIMEOUT_S) — arrivals during an
    in-flight step are free width, because the device queue was
    already charging them the predecessor's wall. Batch trains form
    back-to-back per key under sustained load, so steady-state width
    tracks per-key concurrency instead of the (deliberately tiny)
    gather window;
  - a lone leader (width 1), or any dispatch error, resolves to
    ``None`` for every participant — that participant's own solo
    launch (the same query's normal path) runs instead.

Counter discipline: this module writes NO registry counters — every
``cross_query_*`` / ``queries_per_launch`` attribution happens in
``exec/executor.py`` on the submitting query's executor, from the
(width, waited_ms, leader) facts submit() returns.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

from presto_tpu_torch.obs.sanitizer import make_condition, register_owner

# hard ceiling on how long a follower waits for its leader to publish
# before giving up and running solo (the leader may be wedged in a
# pathological capture; duplicated work is correct work)
FOLLOW_TIMEOUT_S = 60.0

# dispatch-width ladder: a gang dispatches at the largest rung <= its
# gathered width; surplus slots ride the next train. Dense enough that
# truncation wastes < 1/3 of a gang, sparse enough that the captured
# batch-program set per key family stays a handful of programs
DISPATCH_WIDTHS = (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


class _Group:
    """One gathering batch: the entries list is slot-ordered, results
    (when published) are slot-parallel. States: gather -> run ->
    done | fail."""

    __slots__ = ("key", "cap", "entries", "state", "results")

    def __init__(self, key, cap: int):
        self.key = key
        self.cap = cap
        self.entries: List[Tuple[int, int]] = []  # (start, count)/slot
        self.state = "gather"
        self.results: Optional[List] = None


class LaunchBatcher:
    """THE process-shared cross-query batch point. One instance per
    PrestoTpuServer (concurrent path), attached to every per-query
    executor by the runner factory."""

    # lock discipline: the pending-group map
    # and the per-key in-flight dispatch counts are shared across
    # every submitting query thread
    _shared_attrs = ("_pending", "_inflight")

    def __init__(self, wait_ms: int = 25):
        self.wait_ms = wait_ms
        self._cv = make_condition(
            "server.launch_batcher.LaunchBatcher._cv")
        self._pending: Dict = {}
        self._inflight: Dict = {}  # key -> executing batch count
        # optional server-wide active-query count (set once at server
        # startup, before serving): when it reports < 2 running
        # queries there is nobody to gang with, so submit() returns
        # immediately — a lone client NEVER pays the gather window
        self.concurrency_probe = None
        register_owner(self, lock_attrs=("_cv",))

    def submit(self, key, start: int, count: int, cap: int,
               wait_ms: Optional[int], make_batched):
        """Offer one pending launch for cross-query batching.

        ``key`` is the host-hashable compatibility key (plan node +
        program-key salt + table + ladder bucket); ``cap`` bounds the
        group width (the caller computes it from the shapes.py fault
        line); ``make_batched(entries)`` — called on the LEADER's
        thread, outside the lock — runs the shared program over the
        slot-ordered (start, count) entries and returns one
        (page, flags) per slot.

        Returns ``(page, flags, width, waited_ms, is_leader)`` or
        ``None`` when the caller should run its solo path (lone
        leader, dispatch failure, or follower timeout)."""
        if cap < 2:
            return None
        probe = self.concurrency_probe
        if probe is not None:
            try:
                if probe() < 2:
                    return None  # nobody to gang with: solo, no wait
            except Exception:  # noqa: BLE001 - a perf hint, never load
                pass           # bearing: a broken probe means "gather"
        window_s = (self.wait_ms if wait_ms is None else wait_ms) / 1e3
        t0 = time.monotonic()
        retries = 0
        while True:
            with self._cv:
                g = self._pending.get(key)
                if g is not None and (
                    g.state != "gather" or len(g.entries) >= g.cap
                ):
                    g = None  # closed or full: start a fresh group
                leader = g is None
                if leader:
                    g = _Group(key, cap)
                    self._pending[key] = g
                slot = len(g.entries)
                g.entries.append((start, count))
                if len(g.entries) >= g.cap:
                    self._cv.notify_all()  # wake the leader early
                if not leader:
                    deadline = t0 + FOLLOW_TIMEOUT_S
                    while g.state not in ("done", "fail"):
                        left = deadline - time.monotonic()
                        if left <= 0 or not self._cv.wait(timeout=left):
                            if g.state in ("done", "fail"):
                                break
                            # leader wedged: run solo (duplicate work
                            # is still correct work); the published
                            # result for this slot, if any, goes unread
                            return None
                    if g.state == "fail":
                        return None
                    if slot >= len(g.results):
                        # surplus past the quantized dispatch width:
                        # re-offer — the next train is already
                        # gathering behind the step that just landed
                        retries += 1
                        if retries > 3:
                            return None
                        continue
                    waited_ms = (time.monotonic() - t0) * 1e3
                    page, flags = g.results[slot]
                    return (page, flags, len(g.results), waited_ms,
                            False)
                # leader: bounded gather window — EXTENDED while a
                # same-key batch is still executing (continuous
                # batching: the device queue was already charging
                # those arrivals the predecessor's wall, so lingering
                # adds width, not latency)
                deadline = t0 + window_s
                hard = t0 + FOLLOW_TIMEOUT_S
                while g.state == "gather" and len(g.entries) < g.cap:
                    now = time.monotonic()
                    limit = (hard if self._inflight.get(key)
                             else deadline)
                    left = limit - now
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                g.state = "run"
                if self._pending.get(key) is g:
                    del self._pending[key]
                # quantize the dispatch width DOWN the ladder: bounds
                # the captured batch-program set to the ladder rungs
                # per key family (no mid-run capture storm at every
                # distinct gang size) and never pads a dead lane (a
                # rounded-up lane is n_pad rows of dead compute);
                # surplus slots re-offer into the next train
                width = min(len(g.entries), g.cap)
                dispatch_n = max(
                    (n for n in DISPATCH_WIDTHS if n <= width),
                    default=1)
                entries = list(g.entries[:dispatch_n])
                waited_ms = (time.monotonic() - t0) * 1e3
                ganged = len(entries) >= 2
                if ganged:
                    self._inflight[key] = (
                        self._inflight.get(key, 0) + 1)
            # ---- leader, OUTSIDE the lock: dispatch the shared step
            if not ganged:
                self._publish(g, None, "fail")
                return None  # lone query: solo is strictly better
            try:
                results = make_batched(entries)
            except Exception:  # noqa: BLE001 - trace/dispatch failure
                # demotes every participant to the solo path; the
                # executor side counts the fallback
                # (split_batch_fallbacks)
                self._publish(g, None, "fail", dec=key)
                return None
            self._publish(g, results, "done", dec=key)
            page, flags = results[slot]
            return page, flags, len(entries), waited_ms, True

    def _publish(self, g: _Group, results, state: str,
                 dec=None) -> None:
        with self._cv:
            if dec is not None:
                n = self._inflight.get(dec, 0) - 1
                if n > 0:
                    self._inflight[dec] = n
                else:
                    self._inflight.pop(dec, None)
            g.results = results
            g.state = state
            self._cv.notify_all()

    # ------------------------------------------------------ solo chaining
    @contextlib.contextmanager
    def solo_inflight(self, key):
        """Mark a SOLO fallthrough execution as in flight for ``key``,
        so same-key arrivals linger behind it exactly as they would
        behind a batched step — lone launches seed trains instead of
        breaking them (a solo step is just a width-1 train car)."""
        with self._cv:
            self._inflight[key] = self._inflight.get(key, 0) + 1
        try:
            yield
        finally:
            self._publish_none(key)

    def _publish_none(self, key) -> None:
        with self._cv:
            n = self._inflight.get(key, 0) - 1
            if n > 0:
                self._inflight[key] = n
            else:
                self._inflight.pop(key, None)
            self._cv.notify_all()

    # ------------------------------------------------------- introspection
    def pending_groups(self) -> int:
        with self._cv:
            return len(self._pending)
