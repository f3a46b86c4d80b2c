"""Typed session properties.

Port of presto_tpu/session.py (reference: presto-main
SystemSessionProperties.java + Session.java) for the properties the
port reads: the single-process runner's, the stage-DAG distributed
path's and the HTTP server's. Names, types and validators are the
reference's; defaults are the reference's except where the port runs a
different mode by design:

  - ``pallas_join_enabled`` defaults to "true" (the reference's forced
    mode): the CUDA kernels engage on the card and their plain twins on
    the CPU, so the distributed path routes exchanges through K4;
  - ``fused_partial_agg_enabled``, ``split_batch_size`` and
    ``late_materialization_enabled`` resolve "auto" to on when the
    executor runs on a CUDA device (the reference: on TPU), where each
    fused program is a replayed CUDA graph and join chains are gather
    bound;
  - ``device_memory_budget``'s auto is the card's memory minus 1/8 on a
    CUDA executor (the reference: the TPU's HBM), and
    ``task_retry_attempts`` bounds only the executor's device-OOM
    ladder (DCN task re-dispatch is not ported);
  - ``stage_scheduler`` defaults to "true": the stage DAG is the only
    distributed plane ported;
  - ``mesh_exchange_mode``, ``adaptive_execution`` default to "false".

A plane that is not ported defaults to off, and asking for it raises
NotImplementedError naming its ROADMAP item (``Session.set``, at
construction and on SET SESSION).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class PropertyMetadata:
    """Reference: spi/session/PropertyMetadata.java."""

    name: str
    description: str
    type: type  # bool | int | str
    default: Any
    validate: Optional[Callable[[Any], bool]] = None


def _parse_value(prop: PropertyMetadata, value: Any) -> Any:
    if prop.type is str:
        # tri-state and enum properties: accept python bools and any
        # casing ("SET SESSION x = TRUE" arrives as a string either way)
        if isinstance(value, bool):
            return "true" if value else "false"
        value = str(value).strip()
        return value.lower() if prop.validate is not None else value
    if isinstance(value, str) and prop.type is bool:
        low = value.strip().lower()
        if low in ("true", "1", "on"):
            return True
        if low in ("false", "0", "off"):
            return False
        raise ValueError(f"{prop.name}: expected boolean, got {value!r}")
    if isinstance(value, str) and prop.type is int:
        return int(value)
    if not isinstance(value, prop.type):
        try:
            return prop.type(value)
        except (TypeError, ValueError):
            raise ValueError(
                f"{prop.name}: expected {prop.type.__name__}, "
                f"got {value!r}")
    return value


def _tristate(v) -> bool:
    return v in ("auto", "true", "false")


SYSTEM_SESSION_PROPERTIES: Dict[str, PropertyMetadata] = {
    p.name: p
    for p in [
        PropertyMetadata(
            "tpu_offload_enabled",
            "run fused per-split pipelines (one program per split, a "
            "captured CUDA graph on the card); false runs every operator "
            "of every page op by op and nothing fuses",
            bool, True,
        ),
        PropertyMetadata(
            "join_distribution_type",
            "auto | broadcast | partitioned (reference: "
            "join_distribution_type)",
            str, "auto",
            validate=lambda v: v in ("auto", "broadcast", "partitioned"),
        ),
        PropertyMetadata(
            "broadcast_join_rows",
            "build sides up to this many estimated rows replicate to "
            "every task instead of repartitioning (join_distribution_"
            "type=auto)",
            int, 1 << 21,
        ),
        PropertyMetadata(
            "agg_gather_capacity",
            "grouped aggregations up to this capacity gather partial "
            "states to one stream; larger ones repartition by group key",
            int, 1 << 17,
        ),
        PropertyMetadata(
            "page_rows",
            "target rows per page (split granularity)",
            int, 1 << 18,
        ),
        PropertyMetadata(
            "array_agg_max_elements",
            "per-group value-slot bound for array_agg/map_agg/"
            "approx_percentile collect state; a group past it re-runs "
            "the query with the bound scaled up the capacity-boost "
            "ladder",
            int, 1024,
        ),
        PropertyMetadata(
            "hash_partition_count",
            "devices used for repartitioned stages (0 = whole mesh); "
            "only 0 is ported (the mesh plane is not)",
            int, 0,
        ),
        PropertyMetadata(
            "pallas_join_enabled",
            "true engages the CUDA kernels (K1 aggregation, K2/K3 join "
            "probes, K4 exchange partition ids) at the reference's "
            "Pallas dispatch points; false keeps every aggregate, join "
            "and exchange on the plain torch paths. Session-"
            "distributed, so every producer of one exchange routes "
            "rows the same way",
            str, "true",
            validate=lambda v: v in ("true", "false"),
        ),
        PropertyMetadata(
            "mesh_exchange_mode",
            "lower a repartition exchange to an in-program collective; "
            "not ported (false = always the spooled plane)",
            str, "false",
            validate=_tristate,
        ),
        PropertyMetadata(
            "generated_join_enabled",
            "allow the build-free generated join (closed-form key "
            "inverse + generate-at-index) for eligible joins over "
            "generator-connector tables; off forces the materialized "
            "build paths (the sort join and the K2/K3 probe kernels)",
            bool, True,
        ),
        PropertyMetadata(
            "fused_partial_agg_enabled",
            "fuse scan->filter->project->partial-aggregation chains into "
            "ONE program per split (fused_partial_aggs counter). auto = "
            "on when the executor runs on a CUDA device, where the win "
            "is the per-launch host cost a graph replay removes; off on "
            "the CPU",
            str, "auto",
            validate=_tristate,
        ),
        PropertyMetadata(
            "split_batch_size",
            "fold up to this many splits of a fused scan pipeline into "
            "ONE program launch (partial-aggregation chains fold their "
            "states inside the program; page-emitting chains emit the "
            "batch as one page). auto = on a CUDA device with the "
            "default max batch, false = per-split launches "
            "(program_launches / splits_scanned counters)",
            str, "auto",
            validate=lambda v: v in ("auto", "false", "off") or v.isdigit(),
        ),
        PropertyMetadata(
            "task_retry_attempts",
            "bounds the executor's device-OOM re-entries, each under a "
            "halved device-memory budget (0 = a device fault raises "
            "through). Re-dispatch of a lost DCN task is not ported: "
            "there the first task failure fails the query whatever the "
            "value",
            int, 2,
        ),
        PropertyMetadata(
            "query_max_memory_bytes",
            "fail queries whose largest page footprint exceeds this many "
            "bytes (0 = unlimited; reference: query.max-memory)",
            int, 0,
        ),
        PropertyMetadata(
            "spill_threshold_bytes",
            "joins/aggregations whose state estimate exceeds this many "
            "bytes run in hash-partition passes (grace-style spill; 0 = "
            "disabled; reference: spill-enabled + revocable memory)",
            int, 0,
        ),
        PropertyMetadata(
            "max_join_build_rows",
            "partition a join whenever the build-side row estimate "
            "exceeds this many rows, regardless of the byte threshold "
            "(0 = disabled)",
            int, 0,
        ),
        PropertyMetadata(
            "host_spill_bytes",
            "materialized intermediates (multi-pass operator sources) "
            "estimated above this many bytes stage to host RAM instead "
            "of staying device-resident (0 = always device-resident; "
            "reference: spiller/FileSingleStreamSpiller)",
            int, 1 << 32,
        ),
        PropertyMetadata(
            "disk_spill_bytes",
            "materialized intermediates estimated above this many bytes "
            "stage to DISK files instead of host RAM (0 = disabled; the "
            "third spill tier)",
            int, 1 << 36,
        ),
        PropertyMetadata(
            "spill_path",
            "directory for disk-spill files (empty = the system temp "
            "dir; reference: spiller-spill-path config)",
            str, "",
        ),
        PropertyMetadata(
            "late_materialization_enabled",
            "join chains defer carried build columns as row-id "
            "indirections and gather values ONCE at the first consumer "
            "that needs them (reference: DictionaryBlock outputs of "
            "LookupJoinOperator); off gathers every carried column at "
            "every join. auto = on when the executor runs on a CUDA "
            "device, where the win is gather bandwidth; off on the CPU "
            "(gathers_deferred / gathers_materialized counters)",
            str, "auto",
            validate=_tristate,
        ),
        PropertyMetadata(
            "device_memory_budget",
            "device-memory budget in bytes for the governor "
            "(exec/membudget.py): pipelines whose planned footprint "
            "exceeds their budget share rewrite into chunked form "
            "(grace-partition join passes, probe-side position "
            "chunking, generation-chunked scans, partitioned "
            "aggregation, PageStore host/disk overflow) before anything "
            "launches. 0 = auto: the card's memory minus 1/8 headroom "
            "on a CUDA device, a generous cap on the CPU "
            "(memory_chunked_pipelines / peak_memory_bytes counters)",
            int, 0,
        ),
        PropertyMetadata(
            "join_skew_rebalance",
            "on boosted retries, rebalance hot grace-join partitions by "
            "chunking build rows by position (buffers stay at the "
            "unboosted size; one probe pass per chunk) instead of "
            "growing every buffer",
            bool, True,
        ),
        PropertyMetadata(
            "retry_backoff_ms",
            "base delay for the exponential-backoff-with-jitter ladder "
            "between DCN fetch retries (reference: "
            "HttpPageBufferClient backoff)",
            int, 100,
        ),
        PropertyMetadata(
            "query_max_run_time",
            "wall-clock deadline in milliseconds for a query "
            "(0 = unlimited; reference: query.max-run-time), enforced "
            "at executor page boundaries and in the DCN fetch and "
            "status loops",
            int, 0,
        ),
        PropertyMetadata(
            "stage_scheduler",
            "general fragment-DAG scheduling for DCN queries "
            "(dist/scheduler.py); true is the only ported mode (the "
            "legacy agg/union/hash-fanout cuts are not ported)",
            str, "true",
            validate=_tristate,
        ),
        PropertyMetadata(
            "speculation_enabled",
            "straggler speculation; not ported (false)",
            bool, False,
        ),
        PropertyMetadata(
            "spool_exchange_bytes",
            "per-task resident-byte budget for spooled-exchange "
            "partitions on a worker: pages past it serialize and spill "
            "to disk-tier PageStore files (0 = never spill). On the "
            "device tier the same budget bounds device-RESIDENT spool "
            "bytes",
            int, 1 << 30,
        ),
        PropertyMetadata(
            "device_exchange_enabled",
            "partition spooled-exchange pages ON DEVICE "
            "(dist/spool.device_partition_pages) and spool device "
            "Pages that serialize lazily; auto = on when the executor "
            "runs on a CUDA device, off on the CPU",
            str, "auto",
            validate=_tristate,
        ),
        PropertyMetadata(
            "plan_check",
            "pre-launch plan verification (exec/plan_check.py): "
            "schema-consistent operator/fragment edges, ladder-"
            "quantized capacities under the device-memory budget, "
            "canonical program-key material, deterministic split "
            "assignment fields. auto = on under pytest (or when "
            "PRESTO_TPU_PLAN_CHECK opts in), off on the serving path; "
            "true/false force. Violations fail the query BEFORE "
            "anything runs with a pointed PlanCheckError",
            str, "auto",
            validate=lambda v: v in ("auto", "true", "false"),
        ),
        PropertyMetadata(
            "query_trace_enabled",
            "record a query-lifecycle span trace (presto_tpu_torch/"
            "obs/): query -> stage -> task -> attempt -> operator "
            "spans on one monotonic clock with one wall anchor. Off = "
            "zero recording cost (trace_spans counter pins 0)",
            bool, False,
        ),
        PropertyMetadata(
            "query_trace_dir",
            "directory for per-query Chrome-trace (Perfetto-loadable) "
            "JSON exports; setting it also enables tracing (empty = "
            "no files). Each query writes <query-id>.trace.json on "
            "completion",
            str, "",
        ),
        PropertyMetadata(
            "stats_profile_dir",
            "directory for persisted observed-stats profiles "
            "(presto_tpu_torch/obs/profile.py), keyed by (canonical "
            "plan fingerprint, connector snapshot): settled capacity "
            "bucket + observed cardinalities. Repeated queries seed "
            "their starting capacity from the profile and skip the "
            "overflow-retry ladder (capacity_boost_retries -> 0); "
            "empty = disabled",
            str, "",
        ),
        PropertyMetadata(
            "adaptive_execution",
            "runtime re-planning at stage boundaries; not ported "
            "(false)",
            str, "false",
            validate=_tristate,
        ),
        PropertyMetadata(
            "result_cache_remote_probe",
            "the fleet cache probe before leaf dispatch; not ported "
            "(false)",
            bool, False,
        ),
        PropertyMetadata(
            "cross_query_batching",
            "gang compatible fused-pipeline launches from CONCURRENT "
            "queries into one shared batched program with in-program "
            "per-query demux (server/launch_batcher.py; a captured "
            "CUDA graph on the card). auto = on under the concurrent "
            "server path only (raw Executors and the serial path "
            "never batch); false forces solo launches. Counters: "
            "cross_query_batches / cross_query_batched_queries / "
            "batch_gather_wait_ms / queries_per_launch",
            str, "auto",
            validate=lambda v: v in ("auto", "true", "false"),
        ),
        PropertyMetadata(
            "cross_query_batch_wait_ms",
            "bounded gather window in milliseconds for cross-query "
            "launch batching: the first compatible launch (the group "
            "leader) waits at most this long for peers before "
            "dispatching (extended while a same-key step is already "
            "executing — continuous batching), so a lone query never "
            "stalls past the window; the window is only ever paid "
            "when >= 2 queries are running server-wide; 0 batches "
            "only launches already pending at submit time",
            int, 25,
        ),
        PropertyMetadata(
            "stream_tail_enabled",
            "turn a /v1/statement query over an append-only stream "
            "into a never-finishing tailing cursor; not ported (false)",
            bool, False,
        ),
        PropertyMetadata(
            "checkpoint_dir",
            "coordinator query-state journal directory; not ported "
            "(empty = off)",
            str, "",
        ),
    ]
}

# property -> (predicate over its value that asks for a plane the port
# lacks, what to say). ROADMAP queue 1 lists each plane.
_NOT_PORTED = {
    "mesh_exchange_mode": (
        lambda v: v != "false",
        "mesh_exchange_mode: the ICI mesh exchange plane is not ported "
        "(ROADMAP queue 1: torch.distributed over 4 cards)"),
    "adaptive_execution": (
        lambda v: v != "false",
        "adaptive_execution: runtime re-planning is not ported "
        "(ROADMAP queue 1)"),
    "speculation_enabled": (
        lambda v: v is True,
        "speculation_enabled: straggler speculation is not ported "
        "(ROADMAP queue 1)"),
    "result_cache_remote_probe": (
        lambda v: v is True,
        "result_cache_remote_probe: the fleet cache probe is not "
        "ported (ROADMAP queue 1)"),
    "stream_tail_enabled": (
        lambda v: v is True,
        "stream_tail_enabled: the tailing cursor and IVM are not ported "
        "(ROADMAP queue 5)"),
    "checkpoint_dir": (
        lambda v: v != "",
        "checkpoint_dir: coordinator checkpointing is not ported "
        "(ROADMAP queue 1)"),
    "stage_scheduler": (
        lambda v: v != "true",
        "stage_scheduler: only the stage-DAG plane (true) is ported; "
        "the legacy agg/union/hash-fanout cuts are not (ROADMAP queue "
        "1)"),
    "hash_partition_count": (
        lambda v: v != 0,
        "hash_partition_count: the mesh plane it sizes is not ported "
        "(ROADMAP queue 1)"),
}


class Session:
    """Reference: Session.java — user + catalog + property overrides."""

    def __init__(self, catalog: Optional[str] = None,
                 properties: Optional[Dict[str, Any]] = None,
                 user: str = "presto", schema: str = "default"):
        self.user = user
        self.catalog = catalog
        self.schema = schema
        self._values: Dict[str, Any] = {}
        for k, v in (properties or {}).items():
            self.set(k, v)

    def set(self, name: str, value: Any) -> None:
        """Override a property (construction, SET SESSION). A value that
        asks for a plane the port lacks raises NotImplementedError and
        leaves the session as it was."""
        prop = SYSTEM_SESSION_PROPERTIES.get(name)
        if prop is None:
            raise KeyError(f"unknown session property: {name}")
        parsed = _parse_value(prop, value)
        if prop.validate and not prop.validate(parsed):
            raise ValueError(f"invalid value for {name}: {value!r}")
        asks, why = _NOT_PORTED.get(name, (lambda v: False, ""))
        if asks(parsed):
            raise NotImplementedError(why)
        self._values[name] = parsed

    def is_set(self, name: str) -> bool:
        """True when the property was explicitly set rather than
        defaulting."""
        return name in self._values

    def rows(self) -> List[tuple]:
        """SHOW SESSION rows: (name, value, default, type, description)
        of every ported property."""
        def text(p, v):
            return str(v).lower() if p.type is bool else str(v)

        return [(name, text(p, self._values.get(name, p.default)),
                 text(p, p.default), p.type.__name__, p.description)
                for name, p in sorted(SYSTEM_SESSION_PROPERTIES.items())]

    def unset(self, name: str) -> None:
        """Back to the property's default."""
        self._values.pop(name, None)

    def get(self, name: str) -> Any:
        prop = SYSTEM_SESSION_PROPERTIES.get(name)
        if prop is None:
            raise KeyError(f"unknown session property: {name}")
        return self._values.get(name, prop.default)
