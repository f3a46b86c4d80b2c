"""Serialized-page stores: the host and disk tiers of the spooled
exchange.

Port of the byte plane of presto_tpu/exec/pagestore.py (reference:
presto-main spiller/FileSingleStreamSpiller.java — serialized pages
staged out of memory and read back). A worker task's partition spool
(server/worker._PartitionSpool) keeps wire blobs in a host-tier store
until the task's resident budget (the ``spool_exchange_bytes`` session
property) is spent, and in a disk-tier store past it: one file per
blob in a per-store temporary directory, deleted on close() and, as a
backstop, at interpreter exit. Random access by index serves the
token-indexed fetch protocol (a consumer may re-read any token).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import List, Optional, Set

# spill directories of this process still open; removed at exit as a
# backstop for stores that never reach close()
_LIVE_DIRS: Set[str] = set()


@atexit.register
def _exit_sweep() -> None:  # pragma: no cover - interpreter teardown
    for d in list(_LIVE_DIRS):
        shutil.rmtree(d, ignore_errors=True)
    _LIVE_DIRS.clear()


class PageStore:
    """Append-once, read-many store of serialized pages."""

    def __init__(self, tier: str = "host",
                 spill_dir: Optional[str] = None):
        if tier not in ("host", "disk"):
            raise ValueError(f"unknown page-store tier {tier!r}")
        self.tier = tier
        self._blobs: List = []  # bytes (host) | file path (disk)
        self.bytes = 0
        self.page_count = 0
        self._dir: Optional[str] = None
        if tier == "disk":
            self._dir = tempfile.mkdtemp(
                prefix=f"presto_tpu_torch_spill_{os.getpid()}_",
                dir=spill_dir)
            _LIVE_DIRS.add(self._dir)

    def put_bytes(self, blob: bytes) -> None:
        self.bytes += len(blob)
        self.page_count += 1
        if self.tier == "disk":
            path = os.path.join(self._dir, f"b{self.page_count}.bin")
            with open(path, "wb") as f:
                f.write(blob)
            self._blobs.append(path)
        else:
            self._blobs.append(blob)

    def blob_at(self, i: int) -> bytes:
        entry = self._blobs[i]
        if isinstance(entry, str):
            with open(entry, "rb") as f:
                return f.read()
        return entry

    def close(self) -> None:
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            _LIVE_DIRS.discard(self._dir)
            self._dir = None
        self._blobs = []
