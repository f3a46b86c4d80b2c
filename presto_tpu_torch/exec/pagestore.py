"""Materialized, restreamable intermediate pages, and the spooled
exchange's serialized pages.

Port of presto_tpu/exec/pagestore.py (reference: presto-main
operator/PagesIndex.java, an append-only page store shared across
probe passes, and spiller/FileSingleStreamSpiller.java, serialized
pages staged out of memory and read back per merge pass).

The Page plane has three tiers:

- tier="device": the page list stays resident on the executor's
  device. Restreaming is free.
- tier="host": each page is pulled to host RAM as numpy arrays (one
  metered device-to-host crossing per page, exec/xfer.to_host) and
  staged back onto the executor's device on each ``stream()`` (a
  metered h2d ``restream``): the device-memory-to-host spill. This is
  what lets a partitioned operator consume an intermediate larger than
  device memory without recomputing the subplan that produced it.
- tier="disk": each page's arrays write to one file in a per-store
  temporary directory, in the port's own format (the raw bytes of
  each tensor, one after another); the page's skeleton — types,
  dictionaries, null-mask presence — and each tensor's dtype and shape
  stay in host RAM. ``stream()`` reads the file back and copies it to
  the device. Files are deleted on close() and, as a backstop, at
  interpreter exit.

The byte plane (``put_bytes``/``blob_at``) serves the worker's
spooled exchange (server/worker._PartitionSpool): wire blobs resident
in host RAM, or one file per blob in the disk tier. A store holds
pages OR blobs, never both.

Stores are owned by the Executor per query attempt (capacity-boost
retries invalidate them). Stores preserve page shapes exactly across
tiers, so a restreamed page feeds the same programs as its first pass.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Iterator, List, Optional, Set

import numpy as np
import torch

from presto_tpu_torch.exec import graphs
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.page import Page

_PREFIX = "presto_tpu_torch_spill_"

# Spill directories created by THIS process, removed on close() and — as
# a backstop for stores that never reach close() — at process exit. Dir
# names embed the owning pid, so sweep_stale_spill_dirs can reclaim the
# leftovers of DEAD processes without touching a live one's spill.
_LIVE_DIRS: Set[str] = set()
_SWEPT_ROOTS: Set[str] = set()


@atexit.register
def _exit_sweep() -> None:  # pragma: no cover - interpreter teardown
    for d in list(_LIVE_DIRS):
        shutil.rmtree(d, ignore_errors=True)
    _LIVE_DIRS.clear()


def sweep_stale_spill_dirs(root: Optional[str] = None) -> int:
    """Remove spill dirs under ``root`` (default: the system temp dir)
    whose embedded owner pid is no longer alive — leftovers of crashed
    or killed engine processes. Returns the number removed. Live
    processes' dirs (ours included) are never touched."""
    root = root or tempfile.gettempdir()
    removed = 0
    try:
        entries = os.listdir(root)
    except OSError:
        return 0
    for name in entries:
        if not name.startswith(_PREFIX):
            continue
        pid_part = name[len(_PREFIX):].split("_", 1)[0]
        if not pid_part.isdigit():
            continue
        pid = int(pid_part)
        if pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)
            continue  # owner alive
        except ProcessLookupError:
            pass
        except OSError:
            continue  # owned by another user / undeterminable
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        removed += 1
    return removed


def page_bytes(page: Page) -> int:
    """Static page footprint from shapes and dtypes (no device reads),
    of a device page or a host page alike."""
    total = page.valid.nbytes
    for b in page.blocks:
        for t in (b.data if isinstance(b.data, tuple) else (b.data,)):
            total += t.nbytes
        if b.nulls is not None:
            total += b.nulls.nbytes
    return total


def _write_leaves(path: str, leaves) -> list:
    """Write host numpy arrays' raw bytes one after another; returns
    each one's (dtype, shape) for the read."""
    meta = []
    with open(path, "wb") as f:
        for a in leaves:
            a = np.ascontiguousarray(a)
            f.write(a.tobytes())
            meta.append((a.dtype, a.shape))
    return meta


def _read_leaves(path: str, meta) -> List[np.ndarray]:
    raw = np.fromfile(path, dtype=np.uint8)
    out, off = [], 0
    for dtype, shape in meta:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out.append(raw[off:off + n].view(dtype).reshape(shape).copy())
        off += n
    return out


class PageStore:
    """Append-once, stream-many page (or blob) materialization.
    ``device`` is where ``stream()`` delivers pages of the host and
    disk tiers."""

    def __init__(self, tier: str = "device",
                 spill_dir: Optional[str] = None, device="cpu"):
        if tier not in ("device", "host", "disk"):
            raise ValueError(f"unknown page-store tier {tier!r}")
        self.tier = tier
        self.device = torch.device(device)
        self._pages: List = []
        self.bytes = 0
        self.page_count = 0
        self._dir: Optional[str] = None
        if tier == "disk":
            # opportunistic stale-dir sweep, once per root per process
            key = spill_dir or tempfile.gettempdir()
            if key not in _SWEPT_ROOTS:
                _SWEPT_ROOTS.add(key)
                sweep_stale_spill_dirs(key)
            self._dir = tempfile.mkdtemp(
                prefix=f"{_PREFIX}{os.getpid()}_", dir=spill_dir or None)
            _LIVE_DIRS.add(self._dir)

    # ---------------------------------------------------- page plane
    def put(self, page: Page) -> None:
        """Append one page: kept as is (device tier), copied to host
        RAM (host tier), or written to a spill file (disk tier)."""
        if self.tier == "device":
            self.bytes += page_bytes(page)
            self.page_count += 1
            self._pages.append(page)
            return
        self.put_host(XF.to_host(
            page, label="spill-disk" if self.tier == "disk"
            else "spill-host"))

    def put_host(self, host_page: Page) -> None:
        """Append a host page (numpy leaves, as exec/xfer.to_host makes
        them): no crossing on the way in."""
        self.bytes += page_bytes(host_page)
        self.page_count += 1
        if self.tier == "disk":
            leaves: List[np.ndarray] = []
            spec = graphs.flatten(host_page, leaves)
            path = os.path.join(self._dir, f"p{self.page_count}.bin")
            self._pages.append((path, spec, _write_leaves(path, leaves)))
        else:
            self._pages.append(host_page)

    @staticmethod
    def _load(entry) -> Page:
        """A disk-tier page read back as a host page (numpy leaves)."""
        path, spec, meta = entry
        return graphs.unflatten(spec, iter(_read_leaves(path, meta)))

    def host_pages(self) -> List:
        """The stored pages as host pages, with no device staging — the
        result cache's replay and demotion plane (cache/store.py): a
        host-tier store hands back its retained pages, a disk-tier one
        reads its spill files, a device-tier one its device pages."""
        if self.tier == "disk":
            return [self._load(e) for e in self._pages]
        return list(self._pages)

    def stream(self) -> Iterator[Page]:
        """The stored pages in order, on the store's device."""
        if self.tier == "device":
            yield from self._pages
        elif self.tier == "host":
            for p in self._pages:
                yield XF.to_device(p, self.device, label="restream")
        else:
            for e in self._pages:
                yield XF.to_device(self._load(e), self.device,
                                   label="restream")

    # ---------------------------------------------------- byte plane
    def put_bytes(self, blob: bytes) -> None:
        self.bytes += len(blob)
        self.page_count += 1
        if self.tier == "disk":
            path = os.path.join(self._dir, f"b{self.page_count}.bin")
            with open(path, "wb") as f:
                f.write(blob)
            self._pages.append(path)
        else:  # resident bytes (there is no device blob)
            self._pages.append(blob)

    def blob_at(self, i: int) -> bytes:
        """Random access for the token-indexed spool fetch (a consumer
        may re-read any token)."""
        entry = self._pages[i]
        if isinstance(entry, str):
            with open(entry, "rb") as f:
                return f.read()
        return entry

    def close(self) -> None:
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            _LIVE_DIRS.discard(self._dir)
            self._dir = None
        self._pages = []
