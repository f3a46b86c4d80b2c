"""Persisted observed-stats profiles: what a query's execution actually
measured, keyed so the NEXT run of the same shape can start there.

Port of presto_tpu/obs/profile.py (reference: history-based
optimization — per-(canonical plan, connector snapshot) records of
observed cardinalities and the settled capacity bucket). The consumer
is capacity seeding: a repeated query starts at its settled
``capacity_boost`` instead of climbing the overflow-retry ladder again
(``capacity_boost_retries`` is 0 on the second run, and
``profile_store_hits`` 1).

Keying: a structural fingerprint of the physical plan (a dataclass
walk, no object identities — the same SQL over the same catalogs hashes
identically across processes, and across the two engines, whose plan
classes share names and fields) combined with a connector-snapshot
token (per-scanned-table row counts — a rewritten memory-connector
table or another scale factor changes the key, so a stale profile is
never applied to other data). One small JSON file per key under the
``stats_profile_dir`` session property; writes are atomic (tmp +
rename) so concurrent queries can share a directory.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Optional

from presto_tpu_torch.obs.sanitizer import make_lock, register_owner


def structural_encode(x, scan_token=None):
    """THE identity-free structural walker: dataclasses encode as
    (classname, field values), containers recurse, anything exotic
    degrades to its type name — so two structurally identical objects
    built in different processes encode byte-identically (no id(), no
    dict ordering, no repr of opaque objects). Shared by the profile
    fingerprint below (the reference also keys its result cache and
    caching connector with it).

    ``scan_token(scan) -> value``, when given, appends a per-TableScan
    token (the profile store passes the table's current row count —
    its connector-snapshot component)."""
    from presto_tpu_torch.exec import plan as P

    def enc(x):
        if scan_token is not None and isinstance(x, P.TableScan):
            return ("TableScan", x.catalog, x.table,
                    tuple(x.columns), scan_token(x),
                    tuple(sorted((f.name, enc(getattr(x, f.name)))
                                 for f in dataclasses.fields(x)
                                 if f.name not in ("catalog", "table",
                                                   "columns"))))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return (type(x).__name__,
                    tuple((f.name, enc(getattr(x, f.name)))
                          for f in dataclasses.fields(x)))
        if isinstance(x, (tuple, list)):
            return tuple(enc(v) for v in x)
        if isinstance(x, dict):
            return tuple(sorted((str(k), enc(v)) for k, v in x.items()))
        if isinstance(x, (str, int, float, bool)) or x is None:
            return x
        return type(x).__name__  # callables/arrays: structure only
    return enc(x)


def structural_fingerprint(x, scan_token=None) -> str:
    """sha256 of the structural encoding, truncated like
    plan_fingerprint (the shared key-material hash)."""
    blob = repr(structural_encode(x, scan_token=scan_token)).encode()
    return hashlib.sha256(blob).hexdigest()[:24]


def plan_fingerprint(plan, catalogs) -> str:
    """Stable structural hash of a physical plan + the snapshot token
    of every table it scans. Deliberately identity-free: dataclasses
    encode as (classname, field values), scans append their current
    row_count, anything exotic degrades to its type name."""

    def rc_token(scan):
        try:
            return catalogs[scan.catalog].row_count(scan.table)
        except Exception:  # noqa: BLE001 - a connector without
            return -1  # counts still fingerprints structurally

    return structural_fingerprint(plan, scan_token=rc_token)


class ProfileStore:
    """Directory-backed profile store with a small in-memory cache.
    `ProfileStore.at(dir)` shares one instance per directory per
    process so concurrent per-query runners reuse the cache."""

    # lock discipline: the in-memory profile cache is shared across the
    # concurrent per-query runners
    _shared_attrs = ("_cache",)

    _instances: Dict[str, "ProfileStore"] = {}
    _instances_lock = make_lock(
        "obs.profile.ProfileStore._instances_lock")

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._cache: Dict[str, dict] = {}
        self._lock = make_lock("obs.profile.ProfileStore._lock")
        register_owner(self)

    @classmethod
    def at(cls, directory: str) -> "ProfileStore":
        directory = os.path.abspath(directory)
        with cls._instances_lock:
            store = cls._instances.get(directory)
        if store is not None:
            return store
        # construct OUTSIDE the instance-map lock: __init__ touches the
        # filesystem (makedirs), which must not stall every other
        # directory's lookup behind one slow mount. Racing creators
        # both build; the map insert below picks one winner.
        store = cls(directory)
        with cls._instances_lock:
            return cls._instances.setdefault(directory, store)

    def key(self, plan, catalogs) -> str:
        return plan_fingerprint(plan, catalogs)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"profile_{key}.json")

    def lookup(self, key: str) -> Optional[dict]:
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        try:
            with open(self._path(key)) as f:
                prof = json.load(f)
        except (OSError, ValueError):
            return None
        with self._lock:
            self._cache[key] = prof
        return prof

    def record(self, key: str, profile: dict) -> None:
        """Atomic write (tmp + rename): concurrent recorders of the
        same key race benignly — last writer wins with a complete
        file, never a torn one."""
        with self._lock:
            self._cache[key] = dict(profile)
        tmp = self._path(key) + f".tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(profile, f, sort_keys=True)
            os.replace(tmp, self._path(key))
        except OSError:
            # a read-only/absent dir degrades to in-memory profiles
            try:
                os.unlink(tmp)
            except OSError:
                pass
