"""Fleet-shared fragment-cache lookup.

Port of presto_tpu/dist/cacheprobe.py. Reference: the exchange-client
direction — a stage's input does not care WHERE its pages come from,
only that they arrive over the one spool data plane. This module lets
the DCN coordinator discover that some fleet member already HOLDS a
leaf fragment's result pages and short-circuit the task: instead of
dispatching the fragment for execution, it posts one
``/v1/cache/task`` probe and, on a hit, the worker parks the cached
pages in a pre-finished task spool
(``TaskRuntime.register_finished_task``, the ICI exchange plane's
landing surface), so the gather/consumer path replays them through the
EXISTING pooled spool-fetch plane with no new protocol.

Two pieces:

- ``fragment_cache_key``: the coordinator-side mirror of the key a
  worker's executor computes for a split leaf fragment — same
  SplitFilterConnector wrap (split identity IS part of the snapshot
  token), same cache/rules selection, same collect_k/page_rows salt.
  Any drift between this and the worker's ``_select_cache_points``
  shows up as a probe miss, never a wrong answer (the worker serves
  only what its OWN store holds under the exact key).

- ``RemoteCacheIndex``: per-worker bloom-style summaries of cached
  fragment keys, refreshed on the heartbeat plane (``/v1/info`` ships
  ``cacheSummary``; server/heartbeat.py feeds ``update_from_info``).
  A probe goes on the wire only when the bloom says "maybe" — the
  common miss costs ZERO round trips; a bloom false positive costs
  one pooled POST.
"""

from __future__ import annotations

import base64
import hashlib
from typing import Dict, Iterable, Optional

from presto_tpu_torch.obs.sanitizer import make_lock, register_owner

# 1024 bits / 4 hashes: ~2% false-positive rate at 100 cached
# fragments per worker, 128 bytes per heartbeat — noise on the wire
_BLOOM_BITS = 1024
_BLOOM_HASHES = 4


def _bit_positions(key: str):
    h = hashlib.sha256(key.encode()).digest()
    for i in range(_BLOOM_HASHES):
        yield int.from_bytes(h[4 * i:4 * i + 4], "little") % _BLOOM_BITS


def bloom_summary(keys: Iterable[str]) -> str:
    """Base64 bloom filter over a worker's cached fragment keys — the
    ``cacheSummary`` field on /v1/info."""
    bits = bytearray(_BLOOM_BITS // 8)
    for k in keys:
        for pos in _bit_positions(k):
            bits[pos // 8] |= 1 << (pos % 8)
    return base64.b64encode(bytes(bits)).decode("ascii")


def _bloom_contains(bits: bytes, key: str) -> bool:
    return all(bits[pos // 8] & (1 << (pos % 8))
               for pos in _bit_positions(key))


def fragment_cache_key(root, catalogs, *, split_table: str,
                       split_index: int, split_count: int,
                       collect_k: int,
                       page_rows: int) -> Optional[str]:
    """The exact fragment-cache key a worker executing this leaf
    fragment's split would compute, or None when the fragment's ROOT
    is not itself a cache point (an interior-only point cannot
    short-circuit the whole task). Mirrors server/worker._run_task's
    catalog wrap + runner salt — see module docstring."""
    from presto_tpu_torch.cache.rules import select_cache_points
    from presto_tpu_torch.connectors.split_filter import SplitFilterConnector

    wrapped = {
        name: SplitFilterConnector(conn, split_table,
                                   split_index, split_count)
        for name, conn in catalogs.items()
    }
    for key, node, _tables, _snap, _fam in select_cache_points(
            root, wrapped).values():
        if node is root:
            return f"{key}:k{collect_k}.p{page_rows}"
    return None


class RemoteCacheIndex:
    """Coordinator-held map of worker uri -> bloom summary of that
    worker's cached fragment keys, refreshed by the heartbeat
    detector's /v1/info polls. No summary for a worker means "probe
    nothing there" — absence fails CLOSED to keep misses free."""

    # lock discipline (tools/lint `locks` rule): heartbeat threads
    # write summaries while scheduler dispatch threads read them
    _shared_attrs = ("_blooms",)

    def __init__(self):
        self._lock = make_lock("dist.cacheprobe.RemoteCacheIndex._lock")
        self._blooms: Dict[str, bytes] = {}
        register_owner(self)

    def update(self, uri: str, summary_b64: Optional[str]) -> None:
        try:
            bits = base64.b64decode(summary_b64) if summary_b64 else b""
        except (ValueError, TypeError):
            bits = b""
        with self._lock:
            if len(bits) == _BLOOM_BITS // 8:
                self._blooms[uri] = bits
            else:
                # a worker that stopped advertising (restarted with an
                # empty cache) must stop attracting probes
                self._blooms.pop(uri, None)

    def update_from_info(self, uri: str, info) -> None:
        """Heartbeat callback (server/heartbeat.py on_info): a peer
        whose /v1/info has no cacheSummary attracts no probe."""
        summary = None
        if isinstance(info, dict):
            summary = info.get("cacheSummary")
        self.update(uri, summary)

    def might_contain(self, uri: str, key: str) -> bool:
        with self._lock:
            bits = self._blooms.get(uri)
        return bits is not None and _bloom_contains(bits, key)

    def known(self) -> bool:
        with self._lock:
            return bool(self._blooms)
