"""Persistent warm-start tier of the result cache (CachePersister) and
the generation-numbered manifest layer it shares with the coordinator
journal (ManifestStore).

Port of presto_tpu/cache/persist.py. A persisted fragment entry is one
payload file (the spool wire format: dist/serde frames under
dist/spool length-prefix framing — the bytes the exchange plane ships)
plus one manifest record (entry key, snapshot tokens, stream watermark,
byte size); the manifest header carries the wire-serde fingerprint, so
a payload written by another serde version is dropped, never decoded.
The first enabled session of a process warm-loads every entry whose
snapshot tokens still match the live connectors (``warm_load``).

A manifest is a set of generation-numbered JSON-lines files:

    <stem>.g000001.jsonl
        {"version": V, "gen": 1, ...extra header fields}
        {"k": "<key>", "v": {...meta...}}     one line per publish
        {"k": "<key>", "v": null}             one line per removal

A publish APPENDS one line (O(1)); when a generation accumulates more
than ``compact_threshold`` record lines the store compacts: the live
entry map is written as the next generation (tmp + atomic rename) and
older generations are unlinked. Recovery is loud at every seam: a torn
trailing line (an append cut by a crash) drops that line and keeps the
prefix; an unreadable newest generation falls back to the previous one;
a version or fingerprint skew drops every record — each counted
(``broken_count``, weighted by ``_drop_weight``) and logged, none able
to crash the boot or serve stale state. The coordinator checkpoint
journal (dist/checkpoint.py) rides this store.

Concurrency: the store lock guards only the in-memory entry map and the
pending-append queue. ALL file I/O happens outside the lock on a drain
loop: take the pending batch under the lock (marking the writer busy),
append or compact outside it, re-check for records that arrived while
writing — a racing publish simply extends the drain.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import struct
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

from presto_tpu_torch.obs.sanitizer import make_lock, register_owner

log = logging.getLogger("presto_tpu_torch.cache")

MANIFEST_VERSION = 2
# record lines per generation before the store compacts into a fresh
# generation snapshot (size governance for long-lived persist dirs)
COMPACT_THRESHOLD = 256

_GEN_RE = re.compile(r"\.g(\d{6,})\.jsonl$")


def _entry_file(key: str) -> str:
    return hashlib.sha256(key.encode()).hexdigest()[:24] + ".pages"


def _unpack_frames(blob: bytes) -> List[bytes]:
    """Inverse of dist/spool.pack_frames over an in-memory payload
    file; raises ValueError on any truncation/corruption (the caller
    counts the drop)."""
    out: List[bytes] = []
    off = 0
    n = len(blob)
    while off < n:
        if off + 8 > n:
            raise ValueError("truncated frame header")
        (ln,) = struct.unpack_from("<q", blob, off)
        off += 8
        if ln < 0 or off + ln > n:
            raise ValueError(f"corrupt frame length {ln}")
        out.append(blob[off:off + ln])
        off += ln
    return out


def manifest_files(directory: str, stem: str = "manifest"):
    """(gen, path) pairs for every generation file of ``stem`` in
    ``directory``, newest first. Shared with tests/tools so nothing
    re-derives the file-name convention."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        if not name.startswith(stem + ".g"):
            continue
        m = _GEN_RE.search(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def read_manifest_doc(directory: str,
                      stem: str = "manifest") -> Optional[Dict]:
    """Parse the newest generation file into the classic whole-doc
    shape ({header fields..., "entries": {...}}) for tests and
    tooling. Returns None when no generation file exists; raises
    ValueError on a file this engine cannot parse at all."""
    files = manifest_files(directory, stem)
    if not files:
        return None
    gen, path = files[0]
    with open(path, "rb") as f:
        lines = f.read().decode("utf-8").splitlines()
    if not lines:
        raise ValueError(f"empty manifest generation file {path}")
    doc = json.loads(lines[0])
    entries: Dict[str, Dict] = {}
    for line in lines[1:]:
        if not line.strip():
            continue
        rec = json.loads(line)
        if rec.get("v") is None:
            entries.pop(rec["k"], None)
        else:
            entries[rec["k"]] = rec["v"]
    doc["entries"] = entries
    doc["path"] = path
    return doc


def rewrite_manifest_doc(directory: str, doc: Dict,
                         stem: str = "manifest") -> None:
    """Write ``doc`` (the read_manifest_doc shape) back as the newest
    generation's content — the corruption-injection hook the manifest
    tests use to skew version/fingerprint headers in place."""
    files = manifest_files(directory, stem)
    if not files:
        raise ValueError(f"no manifest generation under {directory}")
    _, path = files[0]
    header = {k: v for k, v in doc.items()
              if k not in ("entries", "path")}
    lines = [json.dumps(header)]
    lines.extend(json.dumps({"k": k, "v": v})
                 for k, v in doc.get("entries", {}).items())
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("utf-8"))


class ManifestStore:
    """One generation-numbered manifest: in-memory entry map + durable
    JSON-lines journal with threshold compaction. The coordinator
    checkpoint journal (dist/checkpoint.CheckpointJournal) and the
    result cache's warm tier (CachePersister) ride it."""

    # lock discipline: the entry map and the pending-append queue are
    # mutated by concurrent publishers, the drain loop, and
    # once-per-process claim flags
    _shared_attrs = ("_entries", "_pending", "_io_busy", "_gen",
                     "_gen_records", "_claimed")

    def __init__(self, directory: str, *, stem: str = "manifest",
                 version: int = MANIFEST_VERSION,
                 header_extra: Optional[Dict] = None,
                 header_check: Optional[Callable[[Dict],
                                                 Optional[str]]] = None,
                 compact_threshold: int = COMPACT_THRESHOLD):
        self.directory = directory
        self.stem = stem
        self.version = version
        self._header_extra = dict(header_extra or {})
        self._header_check = header_check
        self.compact_threshold = int(compact_threshold)
        self._lock = make_lock("cache.persist.ManifestStore._lock")
        self._entries: Dict[str, Dict] = {}
        self._pending: List[Dict] = []
        self._io_busy = False
        self._gen = 0
        self._gen_records = 0
        self._claimed: set = set()
        # load outcome, settled at construction (single-threaded: the
        # instance is not shared until the constructor returns); the
        # owning plane reports these as loud drops
        self.broken_reasons: List[str] = []
        self.broken_count = 0
        os.makedirs(directory, exist_ok=True)
        self._load()
        register_owner(self)

    # ------------------------------------------------------------ load
    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.directory,
                            f"{self.stem}.g{gen:06d}.jsonl")

    def _parse_gen(self, path: str) -> Tuple[Dict[str, Dict], int, int]:
        """(entries, record_lines, torn_tail_drops) for one generation
        file. Raises ValueError/OSError when the file is unusable as a
        whole (missing/corrupt header, version or fingerprint skew) —
        the caller falls back to an older generation, loudly."""
        with open(path, "rb") as f:
            blob = f.read()
        lines = blob.decode("utf-8", errors="replace").splitlines()
        if not lines or not lines[0].strip():
            raise ValueError("empty generation file")
        header = json.loads(lines[0])
        if int(header.get("version", -1)) != self.version:
            raise ValueError(
                f"manifest version {header.get('version')!r} "
                f"(this engine writes {self.version})")
        if self._header_check is not None:
            why = self._header_check(header)
            if why:
                # undecodable records behind a skewed header: count
                # every record line so the drop is sized honestly
                nrec = sum(1 for ln in lines[1:] if ln.strip())
                raise ValueError(f"{why}: {nrec} records dropped")
        entries: Dict[str, Dict] = {}
        nrec = 0
        torn = 0
        for ln in lines[1:]:
            if not ln.strip():
                continue
            try:
                rec = json.loads(ln)
                key = rec["k"]
            except (ValueError, KeyError, TypeError):
                # torn trailing append (crash mid-write): keep the
                # parsed prefix, drop the tail loudly
                torn += 1
                break
            nrec += 1
            if rec.get("v") is None:
                entries.pop(key, None)
            else:
                entries[key] = rec["v"]
        return entries, nrec, torn

    def _load(self) -> None:
        files = manifest_files(self.directory, self.stem)
        for gen, path in files:
            try:
                entries, nrec, torn = self._parse_gen(path)
            except (OSError, ValueError, KeyError, TypeError) as e:
                # unreadable generation (partial compaction / skew):
                # record the loud drop and fall back one generation
                self.broken_reasons.append(
                    f"{os.path.basename(path)}: {e}")
                self.broken_count += self._drop_weight(e)
                continue
            self._entries = entries
            self._gen = gen
            self._gen_records = nrec
            if torn:
                self.broken_reasons.append(
                    f"{os.path.basename(path)}: torn trailing "
                    f"record dropped")
                self.broken_count += torn
                # the file ends mid-record with no newline: appending
                # would concatenate onto the torn bytes and the new
                # record would be lost on the NEXT load — force the
                # first flush to compact into a fresh generation
                # (atomic tmp+rename) instead of appending
                self._gen_records = self.compact_threshold
            return
        if files:
            # every generation was unreadable: start a fresh one ABOVE
            # the corpses so their stale content can never win a
            # newest-generation race later
            self._gen = files[0][0] + 1

    @staticmethod
    def _drop_weight(e: BaseException) -> int:
        """Honest drop sizing: a skew message carrying 'N records
        dropped' counts N; anything else counts 1."""
        m = re.search(r"(\d+) records dropped", str(e))
        return int(m.group(1)) if m else 1

    # --------------------------------------------------------- publish
    def publish(self, key: str, meta: Dict) -> None:
        """Upsert one entry: O(1) append to the current generation
        (compaction amortizes the rewrite)."""
        with self._lock:
            self._entries[key] = meta
            self._pending.append({"k": key, "v": meta})
        self._flush()

    def remove(self, keys) -> Dict[str, Dict]:
        """Drop entries; returns the removed key -> meta map so the
        owner can delete payload files outside any lock."""
        removed: Dict[str, Dict] = {}
        with self._lock:
            for k in keys:
                meta = self._entries.pop(k, None)
                if meta is not None:
                    removed[k] = meta
                    self._pending.append({"k": k, "v": None})
        if removed:
            self._flush()
        return removed

    def entries_snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return dict(self._entries)

    def claim_once(self, tag: str) -> bool:
        """True exactly once per (store, tag) — the warm-load /
        re-attach single-shot gate."""
        with self._lock:
            if tag in self._claimed:
                return False
            self._claimed.add(tag)
            return True

    def _header_line(self, gen: int) -> bytes:
        doc = {"version": self.version, "gen": gen}
        doc.update(self._header_extra)
        return (json.dumps(doc) + "\n").encode("utf-8")

    def _flush(self) -> None:
        """Drain pending records to disk — append lines, or compact
        into the next generation past the threshold. See module
        docstring for the lock discipline."""
        while True:
            with self._lock:
                if self._io_busy or not self._pending:
                    return
                batch = self._pending
                self._pending = []
                self._io_busy = True
                self._gen_records += len(batch)
                compact = self._gen_records >= self.compact_threshold
                snapshot = dict(self._entries) if compact else None
                gen = self._gen
            try:
                if compact:
                    self._compact(gen, snapshot)
                else:
                    self._append(gen, batch)
            finally:
                with self._lock:
                    self._io_busy = False

    def _append(self, gen: int, batch: List[Dict]) -> None:
        path = self._gen_path(gen)
        payload = b"".join(
            (json.dumps(rec) + "\n").encode("utf-8") for rec in batch)
        try:
            if not os.path.exists(path):
                # first record of a fresh store: seed the header with
                # the same tmp+rename publish compaction uses, then
                # append — a crash between the two leaves a valid
                # empty generation
                fd, tmp = tempfile.mkstemp(
                    prefix=self.stem + ".tmp", dir=self.directory)
                with os.fdopen(fd, "wb") as f:
                    f.write(self._header_line(gen))
                os.replace(tmp, path)
            # one O_APPEND write per drain: complete lines, so a
            # concurrent reader (or a crash) sees a parseable prefix
            # plus at most one torn tail the loader drops loudly
            fd = os.open(path, os.O_WRONLY | os.O_APPEND)
            try:
                os.write(fd, payload)
            finally:
                os.close(fd)
        except OSError as e:
            log.warning("manifest append failed in %s: %r",
                        self.directory, e)

    def _compact(self, gen: int, snapshot: Dict[str, Dict]) -> None:
        """Write the live map as generation gen+1 (tmp + atomic
        rename), then unlink older generations. A crash anywhere
        leaves either the old generation intact or both — the loader's
        newest-readable-wins scan recovers either way."""
        new_gen = gen + 1
        path = self._gen_path(new_gen)
        fd, tmp = tempfile.mkstemp(prefix=self.stem + ".tmp",
                                   dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(self._header_line(new_gen))
                for k, v in snapshot.items():
                    f.write(
                        (json.dumps({"k": k, "v": v}) + "\n")
                        .encode("utf-8"))
            os.replace(tmp, path)
        except OSError as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            log.warning("manifest compaction failed in %s: %r",
                        self.directory, e)
            return  # disk trouble: persistence is best-effort
        with self._lock:
            self._gen = new_gen
            self._gen_records = len(snapshot)
        for old_gen, old_path in manifest_files(self.directory,
                                                self.stem):
            if old_gen < new_gen:
                try:
                    os.unlink(old_path)
                except OSError:
                    pass


def _serde_header_check(header: Dict) -> Optional[str]:
    from presto_tpu_torch.dist.serde import wire_fingerprint

    if header.get("serde") != wire_fingerprint():
        return (f"serde fingerprint {header.get('serde')!r} != "
                f"{wire_fingerprint()!r}")
    return None


class CachePersister:
    """Manifest + payload-file lifecycle for one persist directory.
    One instance per configured directory, owned by the ResultCache
    (store.configure re-binds on a directory change, the same
    last-writer-wins governance every other store knob follows).
    All shared state lives in the ManifestStore; this class only
    composes payload-file I/O around it."""

    def __init__(self, directory: str,
                 compact_threshold: int = COMPACT_THRESHOLD):
        from presto_tpu_torch.dist.serde import wire_fingerprint

        self.directory = directory
        self._store = ManifestStore(
            directory, stem="manifest", version=MANIFEST_VERSION,
            header_extra={"serde": wire_fingerprint()},
            header_check=_serde_header_check,
            compact_threshold=compact_threshold,
        )

    # -------------------------------------------------------- publish
    def persist(self, key: str, host_pages, tables, snap,
                watermark: Optional[int],
                family: Optional[tuple]) -> None:
        """Write one entry's payload file + manifest record. Called by
        the store AFTER it released its own lock (file I/O and the
        per-page serialization never run under the store lock)."""
        from presto_tpu_torch.dist.serde import serialize_page
        from presto_tpu_torch.dist.spool import pack_frames

        try:
            blob = pack_frames([serialize_page(p) for p in host_pages])
        except Exception as e:  # noqa: BLE001 - best-effort tier:
            # an unserializable page type stays memory-only
            log.warning("result-cache persist skipped for %s: %r",
                        key, e)
            return
        fname = _entry_file(key)
        fd, tmp = tempfile.mkstemp(prefix=fname + ".tmp",
                                   dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, os.path.join(self.directory, fname))
        except OSError as e:
            log.warning("result-cache persist failed for %s: %r",
                        key, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self._store.publish(key, {
            "file": fname,
            "nbytes": len(blob),
            "tables": sorted(list(t) for t in tables),
            "snap": [list(s) for s in snap],
            "watermark": watermark,
            "family": ([family[0], family[1]]
                       if family is not None else None),
        })

    def forget(self, keys) -> None:
        """Drop entries from the manifest (DML invalidation / stream
        advance made them stale-by-construction) and delete their
        payload files; called outside the store lock."""
        removed = self._store.remove(keys)
        for meta in removed.values():
            try:
                os.unlink(os.path.join(self.directory, meta["file"]))
            except OSError:
                pass

    # ------------------------------------------------------ warm load
    def warm_load(self, cache, catalogs) -> Tuple[int, int]:
        """Re-admit every still-valid manifest entry into ``cache``;
        returns (entries loaded, entries dropped). Runs at most once
        per persister instance — store.configure() re-binds a fresh
        persister on a directory change, which is what a restarted
        process's first enabled session does."""
        from presto_tpu_torch.cache.rules import snapshot_of
        from presto_tpu_torch.dist.serde import PageWireError, \
            deserialize_page

        if not self._store.claim_once("warm_load"):
            return (0, 0)
        snapshot = self._store.entries_snapshot()
        loaded = 0
        drops = 0
        if self._store.broken_count:
            drops += self._store.broken_count
            for why in self._store.broken_reasons:
                log.warning("result-cache warm load: %s", why)
        dead: List[Tuple[str, bool]] = []  # (key, delete_file)
        for key, meta in snapshot.items():
            try:
                tables = frozenset(
                    (c, t) for c, t in meta["tables"])
                snap = tuple(
                    (c, t, v) for c, t, v in meta["snap"])
                watermark = meta["watermark"]
                family = (tuple(meta["family"])
                          if meta.get("family") else None)
                fname = meta["file"]
            except (KeyError, TypeError, ValueError):
                drops += 1
                dead.append((key, False))
                log.warning("result-cache warm load: malformed "
                            "manifest row for %s dropped", key)
                continue
            stale = None
            proven = False
            for c, t, ver in snap:
                cur = snapshot_of(catalogs.get(c), t)
                if cur is None:
                    stale = (f"{c}.{t} has no live snapshot "
                             f"(connector absent or versionless)")
                    break
                if cur != ver:
                    stale = (f"{c}.{t} snapshot moved "
                             f"{ver!r} -> {cur!r}")
                    proven = True
                    break
            if stale is not None:
                drops += 1
                dead.append((key, proven))
                log.warning("result-cache warm load: %s dropped "
                            "(%s)", key, stale)
                continue
            path = os.path.join(self.directory, fname)
            try:
                with open(path, "rb") as f:
                    blob = f.read()
                pages = [deserialize_page(b)
                         for b in _unpack_frames(blob)]
            except (OSError, ValueError, PageWireError) as e:
                drops += 1
                dead.append((key, True))
                log.warning("result-cache warm load: payload for %s "
                            "unreadable (%r) — dropped", key, e)
                continue
            cache.put_pages(key, pages, tables, watermark=watermark,
                            snap=snap, family=family, persist=False)
            loaded += 1
        if dead:
            self._store.remove(k for k, _ in dead)
            for key, delete in dead:
                if delete:
                    try:
                        os.unlink(os.path.join(
                            self.directory, _entry_file(key)))
                    except OSError:
                        pass
        if loaded or drops:
            log.info("result-cache warm load from %s: %d entries "
                     "loaded, %d dropped", self.directory, loaded,
                     drops)
        return (loaded, drops)
