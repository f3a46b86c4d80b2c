"""Deployment config: the reference's ``etc/`` layout.

Port of presto_tpu/config.py. Reference: presto-server's config tiers —
``etc/config.properties`` (node/service keys, airlift @Config binding)
and ``etc/catalog/<name>.properties`` (one file per catalog; the
``connector.name`` key selects a ConnectorFactory, remaining keys are
connector-specific). A reference-style deployment directory drives the
port's server unchanged:

    etc/config.properties        http-server.http.port=8080
                                 query.max-memory-bytes=268435456
    etc/catalog/tpch.properties  connector.name=tpch
                                 tpch.scale-factor=1.0

Unknown connector names or malformed files raise at load. The factories
are those of the ported connectors (tpch, tpcds, memory, blackhole,
stream); the structural key of the one unported plane,
``compile-cache.dir`` (the port adopts no torch.compile), raises
NotImplementedError.
``checkpoint.dir`` binds the server's durable coordinator journal.
The server built here runs on the card unless the
caller passes ``device="cpu"``; the connectors follow it.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional


def parse_properties(path: str) -> Dict[str, str]:
    """Java-style .properties subset: key=value lines, #/! comments,
    whitespace trimmed (reference: airlift loads these via
    java.util.Properties)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith(("#", "!")):
                continue
            if "=" not in line:
                raise ValueError(
                    f"{path}:{lineno}: expected key=value, got {line!r}"
                )
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


# connector.name -> factory(props, device) -> Connector (reference:
# the ConnectorFactory registry in ConnectorManager; callers extend it
# via register_connector_factory)
_FACTORIES: Dict[str, Callable] = {}


def register_connector_factory(name: str, factory: Callable) -> None:
    _FACTORIES[name] = factory


def _builtin_factories() -> Dict[str, Callable]:
    def tpch(props, device):
        from presto_tpu_torch.connectors.tpch import TpchConnector

        return TpchConnector(
            float(props.get("tpch.scale-factor", "0.01")), device=device)

    def tpcds(props, device):
        from presto_tpu_torch.connectors.tpcds import TpcdsConnector

        return TpcdsConnector(
            float(props.get("tpcds.scale-factor", "0.01")), device=device)

    def memory(props, device):
        from presto_tpu_torch.connectors.memory import MemoryConnector

        return MemoryConnector(device=device)

    def blackhole(props, device):
        from presto_tpu_torch.connectors.blackhole import (
            BlackholeConnector,
        )

        return BlackholeConnector()

    def stream(props, device):
        from presto_tpu_torch.connectors.stream import StreamConnector

        return StreamConnector(device=device)

    return {"tpch": tpch, "tpcds": tpcds, "memory": memory,
            "blackhole": blackhole, "stream": stream}


def load_catalogs(etc_dir: str, device=None) -> Dict[str, object]:
    """Build the catalog map from etc/catalog/*.properties (reference:
    StaticCatalogStore scanning the catalog config dir); the connectors
    live on ``device`` (None = the card)."""
    catalog_dir = os.path.join(etc_dir, "catalog")
    factories = dict(_builtin_factories())
    factories.update(_FACTORIES)
    catalogs: Dict[str, object] = {}
    if not os.path.isdir(catalog_dir):
        return catalogs
    for fname in sorted(os.listdir(catalog_dir)):
        if not fname.endswith(".properties"):
            continue
        name = fname[: -len(".properties")]
        props = parse_properties(os.path.join(catalog_dir, fname))
        cname = props.get("connector.name")
        if not cname:
            raise ValueError(
                f"{fname}: missing required key connector.name"
            )
        factory = factories.get(cname)
        if factory is None:
            raise ValueError(
                f"{fname}: unknown connector.name {cname!r} "
                f"(known: {sorted(factories)})"
            )
        catalogs[name] = factory(props, device)
    return catalogs


# THE etc-key <-> session-property registry (reference: airlift @Config
# bindings — a session property has a config-file counterpart so a
# deployment can pin fleet-wide defaults without SET SESSION): the
# reference's mapping for every property the port declares. Keys in
# _ETC_STRUCTURAL_KEYS are consumed by the server wiring itself
# (constructor arguments) rather than seeded as session defaults.
ETC_SESSION_KEYS: Dict[str, str] = {
    "tpu-offload.enabled": "tpu_offload_enabled",
    "join-distribution-type": "join_distribution_type",
    "broadcast-join.rows": "broadcast_join_rows",
    "agg-gather.capacity": "agg_gather_capacity",
    "page-rows": "page_rows",
    "array-agg.max-elements": "array_agg_max_elements",
    "query.max-memory-bytes": "query_max_memory_bytes",
    "hash-partition-count": "hash_partition_count",
    "pallas-join.enabled": "pallas_join_enabled",
    "mesh-exchange.mode": "mesh_exchange_mode",
    "spill.threshold-bytes": "spill_threshold_bytes",
    "generated-join.enabled": "generated_join_enabled",
    "join.max-build-rows": "max_join_build_rows",
    "spill.host-bytes": "host_spill_bytes",
    "spill.disk-bytes": "disk_spill_bytes",
    "spill.path": "spill_path",
    "late-materialization.enabled": "late_materialization_enabled",
    "fused-partial-agg.enabled": "fused_partial_agg_enabled",
    "split-batch.size": "split_batch_size",
    "device-memory.budget": "device_memory_budget",
    "plan-check.enabled": "plan_check",
    "task-retry.attempts": "task_retry_attempts",
    "task-retry.backoff-ms": "retry_backoff_ms",
    "query.max-run-time-ms": "query_max_run_time",
    "join-skew.rebalance": "join_skew_rebalance",
    "adaptive-execution": "adaptive_execution",
    "adaptive.max-replans": "adaptive_max_replans",
    "stage-scheduler": "stage_scheduler",
    "speculation.enabled": "speculation_enabled",
    "spool-exchange.bytes": "spool_exchange_bytes",
    "device-exchange.enabled": "device_exchange_enabled",
    "query-trace.enabled": "query_trace_enabled",
    "query-trace.dir": "query_trace_dir",
    "stats-profile.dir": "stats_profile_dir",
    "result-cache.enabled": "result_cache_enabled",
    "result-cache.bytes": "result_cache_bytes",
    "result-cache.ttl-ms": "result_cache_ttl_ms",
    "result-cache.persist-dir": "result_cache_persist_dir",
    "result-cache.remote-probe": "result_cache_remote_probe",
    "result-cache.subsumption": "result_cache_subsumption",
    "ivm.enabled": "ivm_enabled",
    "stream-tail.enabled": "stream_tail_enabled",
    "stream-poll.ms": "stream_poll_ms",
    "cross-query-batching": "cross_query_batching",
    "cross-query-batch.wait-ms": "cross_query_batch_wait_ms",
    "checkpoint.enabled": "checkpoint_enabled",
    "checkpoint.dir": "checkpoint_dir",
}

# consumed structurally by server_from_etc, never seeded as session
# defaults — a session default for page_rows would OVERRIDE the
# constructor value per query (session.is_set wins)
_ETC_STRUCTURAL_KEYS = frozenset({
    "page-rows", "query.max-memory-bytes", "checkpoint.dir",
})

# structural keys of planes the port lacks: a deployment that sets one
# fails at startup instead of silently running without it
_NOT_PORTED_KEYS = {
    "compile-cache.dir": "the persistent compile cache (the port "
                         "adopts no torch.compile)",
}


def load_node_config(etc_dir: str) -> Dict[str, str]:
    """etc/config.properties, empty when absent (reference: the node/
    service tier; keys consumed by server_from_etc below)."""
    path = os.path.join(etc_dir, "config.properties")
    if not os.path.exists(path):
        return {}
    return parse_properties(path)


def server_from_etc(etc_dir: str, port: Optional[int] = None,
                    device=None, **kw):
    """A PrestoTpuServer wired entirely from an etc/ directory — the
    reference's deployment story (bin/launcher reads etc/)."""
    from presto_tpu_torch.server.http_server import PrestoTpuServer

    conf = load_node_config(etc_dir)
    for key, what in _NOT_PORTED_KEYS.items():
        if conf.get(key):
            raise NotImplementedError(
                f"{key}: {what} is not ported to presto_tpu_torch")
    catalogs = load_catalogs(etc_dir, device=device)
    if not catalogs:
        raise ValueError(
            f"no catalogs found under {etc_dir}/catalog/*.properties"
        )
    if port is None:
        port = int(conf.get("http-server.http.port", "8080"))
    mem = int(conf.get("query.max-memory-bytes", "0")) or None
    default_catalog = conf.get("default-catalog", sorted(catalogs)[0])
    page_rows = int(conf.get("page-rows", str(1 << 18)))
    # deployment-tier session defaults: EVERY ported session property
    # is seedable from its registered etc key (e.g. split-batch.size=64
    # forces split batching fleet-wide); structural keys are consumed
    # by the constructor wiring above
    session_defaults = dict(kw.pop("session_defaults", None) or {})
    for etc_key, prop in ETC_SESSION_KEYS.items():
        if etc_key in _ETC_STRUCTURAL_KEYS:
            continue
        if conf.get(etc_key):
            session_defaults.setdefault(prop, conf[etc_key])
    # the durable coordinator journal's directory (structural: bound
    # once to the server process; the checkpoint_dir session property
    # covers the per-session path)
    ckpt_dir = conf.get("checkpoint.dir", "")
    if ckpt_dir:
        kw.setdefault("checkpoint_dir", ckpt_dir)
    return PrestoTpuServer(
        catalogs, port=port, default_catalog=default_catalog,
        memory_budget_bytes=mem, page_rows=page_rows,
        session_defaults=session_defaults or None, device=device, **kw,
    )
