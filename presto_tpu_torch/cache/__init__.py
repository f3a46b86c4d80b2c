"""presto_tpu_torch/cache — the two-level result cache and its
persistence planes.

Port of presto_tpu/cache/. Reference: the reuse ladder presto built one
rung at a time — compiled expressions, compiled artifacts, and the
result-set reuse that dashboard traffic needs. This package is the
RESULT rung:

  level 1 — fragment-result cache (exec/executor.py cache points):
      cacheable plan subtrees (cache/rules.py: deterministic,
      snapshot-keyable) are keyed by (canonical plan fingerprint,
      connector snapshot versions, the executor's collect_k and
      page_rows) and their page streams stored as host pages in the
      byte-budgeted store below; a hit replays the pages and captures
      or replays no program (``program_launches`` stays 0).
  level 2 — full-statement cache (runner.py): an identical (planned
      statement fingerprint, catalog/schema, result-affecting session
      properties, snapshot versions) statement returns the finished
      row set without executing.

Invalidation is structural: the Connector SPI's ``snapshot_version``
(connectors/base.py; the writable memory connector bumps a write
counter) rides in every key, so a write makes stale entries
unreachable; ``invalidate_tables`` reclaims their bytes eagerly on the
runner's write path. Governed by the session properties
``result_cache_enabled`` / ``_bytes`` / ``_ttl_ms`` / ``_persist_dir``
/ ``_remote_probe`` / ``_subsumption``; observable through the
``result_cache_*`` and ``cache_*`` registry counters
(exec/counters.py) and ``cache`` spans in the trace plane (obs/).

persist.py holds the warm-start tier (CachePersister) and the
generation-numbered ManifestStore the coordinator journal
(dist/checkpoint.py) also rides. The store's stream paths
(``advance_tables``, entry watermarks) serve the stream connector,
which the port does not have yet.
"""

from presto_tpu_torch.cache.rules import (  # noqa: F401
    RESULT_AFFECTING_PROPS,
    VOLATILE_FUNCTIONS,
    append_only_tables,
    cacheable,
    descriptor_contains,
    family_key,
    filter_descriptor,
    scan_tables,
    select_cache_points,
    snapshot_tokens,
    stream_watermark,
    subtree_key,
    uncacheable_reason,
)
from presto_tpu_torch.cache.store import (  # noqa: F401
    ResultCache,
    shared_cache,
    shared_cache_if_exists,
)
