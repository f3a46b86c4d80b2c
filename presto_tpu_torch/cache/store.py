"""The process-shared, byte-budgeted result-cache store.

Port of presto_tpu/cache/store.py. Reference: presto-main's
coordinator-side result reuse direction (compiled-artifact reuse
extended to RESULTS) and presto-memory's
MemoryPagesStore (a scan of unchanged data is a memory read, not a
recomputation). One lock-disciplined store per process holds two entry
kinds under ONE LRU/byte budget:

  - fragment entries: the host pages (numpy leaves) of one cacheable
    plan subtree, held in a PageStore (host tier while the resident
    budget allows; demoted entry-by-entry to the DISK tier — the same spill
    files and pid-tagged dir lifecycle every other engine
    materialization uses — when the host budget is exceeded);
  - statement entries: the finished (names, rows, types) of one full
    statement, host-RAM only (row tuples have no useful disk form at
    this scale; under pressure they simply evict).

Governance: ``result_cache_bytes`` is the HOST-resident budget; disk-
demoted bytes are bounded at ``_DISK_BUDGET_FACTOR`` x that budget,
past which LRU entries evict outright. ``result_cache_ttl_ms`` > 0
ages entries out on access. Every key embeds connector snapshot
versions (cache/rules.py), so invalidation-by-write needs no flush —
``invalidate_tables`` exists to reclaim memory eagerly on the writable
connectors' DML path and to serve wrapped page caches
(connectors/cached.py ``drop_cache``).

Concurrency: the QueryManager's per-query runners share one instance
(``shared_cache()``); all map/byte-accounting mutations happen under
``self._lock``. Page payloads are immutable after publication (readers
take a list snapshot under the lock; host pages are never mutated),
so replay needs no lock. An entry that alone exceeds the budget is not
admitted (one oversized result must not flush the whole working set).
"""

from __future__ import annotations

import sys
import time
from collections import OrderedDict
from typing import Dict, FrozenSet, List, Optional, Tuple

from presto_tpu_torch.obs.sanitizer import make_lock, register_owner

DEFAULT_BUDGET_BYTES = 1 << 28  # 256 MiB host-resident
_DISK_BUDGET_FACTOR = 4


class _Entry:
    __slots__ = ("key", "kind", "nbytes", "tables", "created",
                 "store", "payload", "watermark", "snap", "family")

    def __init__(self, key: str, kind: str, nbytes: int,
                 tables: FrozenSet[Tuple[str, str]], created: float,
                 store=None, payload=None, watermark=None,
                 snap=None, family=None):
        self.key = key
        self.kind = kind          # "pages" | "rows"
        self.nbytes = nbytes
        self.tables = tables
        self.created = created
        self.store = store        # PageStore (pages kind)
        self.payload = payload    # (names, rows, types) (rows kind)
        # append-log offset this entry's content covers (the stream
        # connector's):
        # None for ordinary entries AND for live-head stream scans
        # (offset-keyed, reclaimed by advance_tables); an int for
        # PINNED-prefix readers and IVM view results, which a stream
        # append extends rather than invalidates
        self.watermark = watermark
        # (catalog, table, version) snapshot tokens the key embeds —
        # carried explicitly so the persistent manifest can
        # re-validate the entry against LIVE connectors at warm load
        self.snap = snap
        # (family_key, filter_descriptor) for subsumable Filter
        # fragments (cache/rules.family_key), else None
        self.family = family

    @property
    def on_disk(self) -> bool:
        return self.store is not None and self.store.tier == "disk"


def _rows_bytes(names, rows, types) -> int:
    """Cheap, stable size estimate for a statement entry: sampled
    per-row getsizeof (tuple + cells) extrapolated over the row count.
    An estimate is fine — the budget is a governor, not an allocator."""
    base = 256 + 64 * (len(names) + len(types))
    if not rows:
        return base
    sample = rows[:64]
    per_row = sum(
        sys.getsizeof(r) + sum(sys.getsizeof(v) for v in r)
        for r in sample
    ) / len(sample)
    return base + int(per_row * len(rows))


class ResultCache:
    """Two-level result cache; see module docstring. All four
    observability tallies mirror the executor-family registry counters
    (exec/counters.QUERY_COUNTERS) as PROCESS totals — the /metrics
    and system.metrics surfaces render these, while EXPLAIN ANALYZE
    renders the querying executor's own counts."""

    # lock discipline (tools/lint `locks` rule): everything the
    # concurrent per-query runners mutate through one shared instance
    _shared_attrs = ("_entries", "budget_bytes", "ttl_ms", "spill_dir",
                     "hits", "misses", "evictions", "invalidations",
                     "warm_loads", "remote_hits", "subsumed_hits",
                     "manifest_drops", "_families", "_persister")

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 ttl_ms: int = 0, spill_dir: Optional[str] = None):
        self._lock = make_lock("cache.store.ResultCache._lock")
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self.budget_bytes = int(budget_bytes) or DEFAULT_BUDGET_BYTES
        self.ttl_ms = int(ttl_ms)
        self.spill_dir = spill_dir
        # process-total tallies (see class docstring)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        # fleet tallies
        self.warm_loads = 0
        self.remote_hits = 0
        self.subsumed_hits = 0
        self.manifest_drops = 0
        # family_key -> {entry_key: filter_descriptor} for the
        # subsumption probe (cache/rules.descriptor_contains)
        self._families: Dict[str, Dict[str, dict]] = {}
        # cache/persist.CachePersister when a session configured
        # result_cache_persist_dir; None = memory only
        self._persister = None
        register_owner(self)

    # ------------------------------------------------------ configure
    def configure(self, budget_bytes: Optional[int] = None,
                  ttl_ms: Optional[int] = None,
                  spill_dir: Optional[str] = None,
                  persist_dir: Optional[str] = None) -> None:
        """Re-apply session-level governance (last writer wins — the
        store is process-shared, so the newest session's budget/TTL
        governs; shrinking the budget evicts immediately).
        ``persist_dir``: None = no change, "" = detach persistence, a
        path = (re)bind a CachePersister on that directory."""
        persister = None
        if persist_dir:
            cur = self._persister
            if cur is not None and cur.directory == persist_dir:
                persister = cur
            else:
                # construct OUTSIDE the lock: the persister reads the
                # manifest file at init (no file I/O under a registered
                # lock)
                from presto_tpu_torch.cache.persist import CachePersister

                persister = CachePersister(persist_dir)
        with self._lock:
            if budget_bytes is not None and int(budget_bytes) > 0:
                self.budget_bytes = int(budget_bytes)
            if ttl_ms is not None:
                self.ttl_ms = int(ttl_ms)
            if spill_dir is not None:
                self.spill_dir = spill_dir or None
            if persist_dir is not None:
                self._persister = persister
            self._maintain_locked()

    # ----------------------------------------------------- inspection
    def counters(self) -> Dict[str, int]:
        """Process-total tallies under the registry counter names."""
        return {
            "result_cache_hits": self.hits,
            "result_cache_misses": self.misses,
            "result_cache_evictions": self.evictions,
            "result_cache_invalidations": self.invalidations,
            "cache_warm_loads": self.warm_loads,
            "cache_remote_hits": self.remote_hits,
            "cache_subsumed_hits": self.subsumed_hits,
            "cache_manifest_drops": self.manifest_drops,
        }

    @property
    def entry_count(self) -> int:
        return len(self._entries)

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values()
                       if not e.on_disk)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    # ----------------------------------------------------- pages kind
    def get_pages(self, key: str) -> Optional[List]:
        """The host pages of a fragment key, or None. The
        returned list is a safe snapshot: host entries hand back their
        (immutable, GC-protected) page list; disk entries load their
        spill files under the lock so eviction can never race a
        reader's file access."""
        with self._lock:
            e = self._expire_locked(key)
            if e is None or e.kind != "pages":
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return list(e.store.host_pages())

    def put_pages(self, key: str, pages, tables,
                  watermark: Optional[int] = None,
                  snap=None, family=None, persist: bool = True) -> int:
        """Publish one fragment's completed page stream. ``pages`` may
        be device or host pages (PageStore.put stages host-side either
        way — callers publish AFTER the attempt completes, so the d2h
        read happens off the deferred-sync hot path).
        ``watermark`` marks a pinned-prefix stream entry (see _Entry);
        ``snap`` carries the key's snapshot tokens for the persistent
        manifest; ``family`` is the (family_key, descriptor) pair for
        subsumable Filter fragments; ``persist=False`` is the warm-load
        re-admission path (the entry is ALREADY on disk). Returns the
        number of entries evicted to admit it."""
        from presto_tpu_torch.exec.pagestore import PageStore

        store = PageStore(tier="host")
        for p in pages:
            store.put(p)
        # host-materialize BEFORE the lock: the persister serializes
        # these same pages off-lock after publication
        host_pages = list(store.host_pages())
        with self._lock:
            persister = self._persister
            if store.bytes > self.budget_bytes:
                store.close()  # oversized: never admitted (see above)
                return 0
            self._drop_locked(key)
            self._entries[key] = _Entry(
                key, "pages", store.bytes, frozenset(tables),
                time.monotonic(), store=store, watermark=watermark,
                snap=snap, family=family,
            )
            if family is not None:
                self._families.setdefault(
                    family[0], {})[key] = family[1]
            evicted = self._maintain_locked()
        if persist and persister is not None and snap is not None:
            persister.persist(key, host_pages, tables, snap,
                              watermark, family)
        return evicted

    def peek_pages(self, key: str) -> bool:
        """Tally-free presence probe for a fragment key — the remote
        cache probe (dist/cacheprobe.py) and fragment-level admission
        discounts ask "would this hit?" without distorting the
        hit/miss tallies or LRU order (same contract as peek_rows)."""
        with self._lock:
            e = self._expire_locked(key)
            return e is not None and e.kind == "pages"

    def pages_keys(self) -> List[str]:
        """Every live fragment key (tally-free) — feeds the worker's
        bloom-style cache summary shipped on /v1/info heartbeats."""
        with self._lock:
            return [k for k, e in self._entries.items()
                    if e.kind == "pages"]

    def probe_family(self, family_key: str, wanted) -> Optional[
            Tuple[str, dict]]:
        """Subsumption probe: the first cached sibling in ``family_key``
        whose filter descriptor CONTAINS ``wanted`` (cache/rules.
        descriptor_contains — pure dict comparison, fine under the
        lock). Returns (entry_key, cached_descriptor) or None."""
        from presto_tpu_torch.cache.rules import descriptor_contains

        with self._lock:
            sibs = self._families.get(family_key)
            if not sibs:
                return None
            for ekey, desc in sibs.items():
                if ekey in self._entries and \
                        descriptor_contains(desc, wanted):
                    return (ekey, desc)
            return None

    # ------------------------------------------------- fleet tallies
    def count_remote(self, n: int = 1) -> None:
        with self._lock:
            self.remote_hits += n

    def count_subsumed(self, n: int = 1) -> None:
        with self._lock:
            self.subsumed_hits += n

    def note_warm(self, loaded: int, drops: int) -> None:
        with self._lock:
            self.warm_loads += loaded
            self.manifest_drops += drops

    def warm_load(self, catalogs) -> Tuple[int, int]:
        """One-shot warm-start pass: re-admit every still-
        valid persisted entry against the LIVE connector snapshots.
        The persister itself guards the once-per-instance semantics;
        returns (loaded, dropped) and folds both into the tallies."""
        persister = self._persister
        if persister is None:
            return (0, 0)
        loaded, drops = persister.warm_load(self, catalogs)
        if loaded or drops:
            self.note_warm(loaded, drops)
        return (loaded, drops)

    def peek_rows(self, key: str) -> bool:
        """Tally-free presence probe for a statement key — the
        server's cache-aware admission asks "would this
        statement hit?" before spending a resource-group slot on it,
        and an advisory peek must not distort the hit/miss tallies or
        the LRU order the real serving path maintains."""
        with self._lock:
            e = self._expire_locked(key)
            return e is not None and e.kind == "rows"

    # ------------------------------------------------------ rows kind
    def get_rows(self, key: str):
        """(names, rows, types) for a statement key, or None. Lists
        are copied so callers can own their QueryResult."""
        with self._lock:
            e = self._expire_locked(key)
            if e is None or e.kind != "rows":
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            names, rows, types = e.payload
            return list(names), list(rows), list(types)

    def put_rows(self, key: str, names, rows, types, tables,
                 watermark: Optional[int] = None) -> int:
        """Publish (or ADVANCE — re-putting a watermarked key replaces
        payload and watermark in place, the IVM refresh contract) one
        statement/view row set."""
        nbytes = _rows_bytes(names, rows, types)
        with self._lock:
            if nbytes > self.budget_bytes:
                return 0
            self._drop_locked(key)
            self._entries[key] = _Entry(
                key, "rows", nbytes, frozenset(tables),
                time.monotonic(),
                payload=(list(names), list(rows), list(types)),
                watermark=watermark,
            )
            return self._maintain_locked()

    def entry_watermark(self, key: str) -> Optional[int]:
        """The offset watermark riding on one entry (None when the
        entry is absent or unwatermarked) — introspection for the
        advance-on-write contract."""
        with self._lock:
            e = self._entries.get(key)
            return None if e is None else e.watermark

    def advance_tables(self, tables) -> int:
        """Append-path reclaim for append-only stream tables ("advance
        on write"): entries keyed to the LIVE log head became
        structurally unreachable the moment the offset moved, so drop
        them now (counted as invalidations, the eager reclaim of
        invalidate_tables); entries carrying an offset WATERMARK
        (pinned-prefix readers, IVM view results) still describe
        exactly the prefix they were built from — an append only
        extends the suffix — and are KEPT. Returns the dropped
        count."""
        tset = set(tables)
        with self._lock:
            doomed = [k for k, e in self._entries.items()
                      if e.tables & tset and e.watermark is None]
            for k in doomed:
                self._drop_locked(k)
            self.invalidations += len(doomed)
            persister = self._persister
        if doomed and persister is not None:
            persister.forget(doomed)  # file I/O outside the lock
        return len(doomed)

    # --------------------------------------------------- invalidation
    def invalidate_tables(self, tables) -> int:
        """Drop every entry that read any of the given (catalog,
        table) pairs — the eager-reclaim path the runner drives after
        DML/CTAS writes (snapshot-keyed entries were already
        unreachable; this frees their bytes now). Returns the count."""
        tset = set(tables)
        with self._lock:
            doomed = [k for k, e in self._entries.items()
                      if e.tables & tset]
            for k in doomed:
                self._drop_locked(k)
            self.invalidations += len(doomed)
            persister = self._persister
        if doomed and persister is not None:
            persister.forget(doomed)  # file I/O outside the lock
        return len(doomed)

    def clear(self) -> int:
        """Drop every IN-MEMORY entry. Persisted files are deliberately
        kept: clear models a process going away (its memory vanishes,
        its manifest survives for the next boot's warm load)."""
        with self._lock:
            n = len(self._entries)
            for k in list(self._entries):
                self._drop_locked(k)
            return n

    # ------------------------------------------------- internals
    def _drop_locked(self, key: str) -> None:
        e = self._entries.pop(key, None)
        if e is not None and e.store is not None:
            e.store.close()
        if e is not None and e.family is not None:
            sibs = self._families.get(e.family[0])
            if sibs is not None:
                sibs.pop(key, None)
                if not sibs:
                    self._families.pop(e.family[0], None)

    def _expire_locked(self, key: str) -> Optional[_Entry]:
        """TTL-aware lookup (caller holds the lock): an entry older
        than result_cache_ttl_ms drops and reads as a miss — counted
        as an eviction (age-based reclaim, not a write invalidation)."""
        e = self._entries.get(key)
        if e is None:
            return None
        if self.ttl_ms > 0 and \
                (time.monotonic() - e.created) * 1000.0 > self.ttl_ms:
            self._drop_locked(key)
            self.evictions += 1
            return None
        return e

    def _maintain_locked(self) -> int:
        """Enforce the budgets (caller holds the lock): demote LRU
        host-resident page entries to the disk tier past the resident
        budget, evict LRU entries outright past the disk factor.
        Returns the number of evictions."""
        resident = sum(e.nbytes for e in self._entries.values()
                       if not e.on_disk)
        if resident > self.budget_bytes:
            from presto_tpu_torch.exec.pagestore import PageStore

            for k in list(self._entries):
                if resident <= self.budget_bytes:
                    break
                e = self._entries[k]
                if e.kind != "pages" or e.on_disk:
                    continue  # rows entries evict below, never demote
                disk = PageStore(tier="disk", spill_dir=self.spill_dir)
                # put_host, not put: the pages are already host pages
                # and this runs under self._lock — a device read here
                # would serialize every cache reader behind a device
                # sync
                for p in e.store.host_pages():
                    disk.put_host(p)
                e.store.close()
                e.store = disk
                resident -= e.nbytes
        evicted = 0
        total = sum(e.nbytes for e in self._entries.values())
        cap = self.budget_bytes * _DISK_BUDGET_FACTOR
        resident = sum(e.nbytes for e in self._entries.values()
                       if not e.on_disk)
        for k in list(self._entries):
            if total <= cap and resident <= self.budget_bytes:
                break
            e = self._entries[k]
            total -= e.nbytes
            if not e.on_disk:
                resident -= e.nbytes
            self._drop_locked(k)
            evicted += 1
        self.evictions += evicted
        return evicted


# ------------------------------------------------- the shared instance
_shared_lock = make_lock("cache.store._shared_lock")
_shared: Optional[ResultCache] = None


def shared_cache() -> ResultCache:
    """THE process-shared store (one per server process, like the
    captured-program cache): every per-query runner the QueryManager
    spins up sees the same entries, which is what makes dashboard-
    style repeated traffic collapse across concurrent clients."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = ResultCache()
        return _shared


def shared_cache_if_exists() -> Optional[ResultCache]:
    """The shared store iff some session already created it — metric
    surfaces use this so scraping /metrics never allocates a cache."""
    return _shared
