"""THE execution-counter registry.

Port of presto_tpu/exec/counters.py (reference: presto-main
OperatorStats/QueryStats — every runtime counter the engine maintains is
declared once and every surfacing layer renders the same declared set).
``Executor.execute_with_stats`` builds its EXPLAIN ANALYZE counter dict
FROM this registry (plus the computed entries of COMPUTED_COUNTERS), so
every declared counter reaches the ``Counters:`` line with no wiring of
its own; tests/test_torch_explain_analyze.py fails when a ``self.x +=``
counter of the executor family is missing here.

Only the counters the port maintains are declared, each under the
reference's name and kind. The reference's counters of planes the port
lacks (result cache, IVM, the mesh exchange, ...) are
listed in ROADMAP.md beside the plane that brings each one.

Adding a counter = initialize it to 0 in Executor.__init__, increment
it, and add one row here.
"""

from __future__ import annotations

from typing import Dict

# attr name on Executor -> (prometheus kind, help text).
# "counter" = monotonically increasing over the executor's lifetime or
# per query; "gauge" = per-attempt/per-query level.
QUERY_COUNTERS: Dict[str, tuple] = {
    "gathers_deferred": (
        "gauge", "per-page column gathers skipped at join-output time "
        "(late materialization; per-attempt)"),
    "gathers_materialized": (
        "gauge", "per-page column value gathers actually performed "
        "(late-materialization lift + chain-boundary finish)"),
    "fused_partial_aggs": (
        "gauge", "scan→filter→project→partial-agg chains run as one "
        "program per split (a captured CUDA graph on the card) this "
        "attempt"),
    "program_launches": (
        "gauge", "fused-scan program launches this attempt (graph "
        "replays on the card; split-batched execution)"),
    "splits_scanned": (
        "gauge", "real (unpadded) splits covered by this attempt's "
        "fused-scan launches — splits_per_launch is the ratio"),
    "split_batch_fallbacks": (
        "counter", "cross-query batches whose shared launch failed, "
        "so every participant ran its solo launch (the port's "
        "split-batched streams never fall back to the per-split "
        "loop)"),
    "generated_joins_used": (
        "counter", "build-free generated joins taken (lifetime; "
        "EXPLAIN ANALYZE reports the per-query delta)"),
    "pallas_joins_used": (
        "counter", "Hopper join-probe kernel engagements (K2/K3, "
        "csrc/hash_probe.cu, at the reference's Pallas join dispatch "
        "points; lifetime; EXPLAIN ANALYZE reports the per-query "
        "delta)"),
    "pallas_kernels_used": (
        "counter", "Hopper kernel engagements of ANY kind — join "
        "probes (K2/K3), segmented-reduction aggregations (K1), "
        "partition-id exchange hashing (K4) (lifetime; the kernel "
        "tier's overall engagement gauge)"),
    "ici_exchanges": (
        "counter", "repartition exchanges lowered to the mesh "
        "all_to_all over co-resident stages instead of the spool plane "
        "(dist/scheduler.py mesh-exchange plane; coordinator "
        "lifetime)"),
    "ici_bytes": (
        "counter", "bytes routed through mesh all_to_all exchanges "
        "(the settled attempt's staged page footprint — interconnect "
        "or on-card traffic, never a host crossing; coordinator "
        "lifetime)"),
    "mesh_exchange_fallbacks": (
        "counter", "mesh-lowered exchanges that fell back LOUDLY to "
        "the authoritative spool plane (an exchange failure or an "
        "unsettled overflow ladder) — counted, never a silent wrong "
        "answer"),
    "programs_compiled": (
        "gauge", "CUDA graphs captured for this query (exec/graphs.py; "
        "the port's counterpart of a real XLA compile)"),
    "program_cache_hits": (
        "gauge", "fused-program calls this query served by an already "
        "captured graph from exec/graphs.py's process cache"),
    "spill_partitions_used": (
        "gauge", "grace-partition passes taken by joins/aggregations "
        "this query (spill_threshold_bytes / governed sizing)"),
    "host_spill_pages": (
        "gauge", "intermediate pages staged to host RAM this query "
        "(PageStore host tier)"),
    "disk_spill_pages": (
        "gauge", "intermediate pages written to disk spill files this "
        "query (PageStore disk tier)"),
    "skew_chunks_used": (
        "gauge", "hot grace-join partitions rebalanced by position "
        "chunking on boosted retries"),
    "memory_chunked_pipelines": (
        "gauge", "pipelines the device-memory governor rewrote into "
        "chunked/streaming form this attempt (exec/membudget.py)"),
    "device_oom_retries": (
        "gauge", "device-OOM re-entries this query, each under a "
        "halved device-memory budget"),
    "task_retries": (
        "counter", "DCN fragments re-dispatched to a surviving worker "
        "(coordinator lifetime)"),
    "workers_excluded": (
        "counter", "DCN nodes dropped from the dispatch pool after a "
        "mid-query failure (coordinator lifetime)"),
    "release_skips": (
        "counter", "worker page-buffer DELETE releases skipped because "
        "the worker was unreachable (dead-worker cleanup, counted not "
        "swallowed; the DCN coordinator's)"),
    "stages_scheduled": (
        "counter", "stage-DAG fragments dispatched as worker task "
        "waves by the scheduler (dist/scheduler.py; coordinator "
        "lifetime)"),
    "spooled_exchange_pages": (
        "counter", "pages published into worker-side spooled-exchange "
        "partitions (coordinator lifetime)"),
    "nonleaf_replays": (
        "counter", "lost NON-LEAF stage-DAG tasks re-dispatched to "
        "replay from spooled upstream pages instead of failing the "
        "query (coordinator lifetime)"),
    "checkpoints_written": (
        "counter", "durable coordinator checkpoint records published "
        "to the query journal (dist/checkpoint.py): admission, stage "
        "barriers, root registration, drain progress, client-token "
        "advances (coordinator lifetime)"),
    "coordinator_reattaches": (
        "counter", "journaled queries a RESTARTED coordinator "
        "recovered — final-stage suppliers re-registered from "
        "persisted placements (spool resume) or the statement re-run "
        "from the journal (coordinator lifetime)"),
    "reattach_redispatches": (
        "counter", "dead final-stage placements re-dispatched from "
        "persisted payloads during coordinator re-attach (the lost "
        "suffix, through the normal replay ladder; coordinator "
        "lifetime)"),
    "checkpoint_drops": (
        "counter", "checkpoint records dropped LOUDLY: journal "
        "generations unreadable at boot (version/fingerprint skew, "
        "torn appends, partial compaction) or barrier writes that "
        "failed to serialize — recovery degrades to the re-run rung, "
        "never a crash, never stale state served"),
    "speculative_tasks_won": (
        "counter", "straggler speculation races where the "
        "re-dispatched copy finished first and became the task's "
        "placement"),
    "speculative_tasks_lost": (
        "counter", "straggler speculation races the original "
        "placement won (the speculated copy was cancelled)"),
    "capacity_boost_retries": (
        "gauge", "overflow-ladder boosted re-entries this query "
        "(0 on a profile-seeded repeat run — the observed-stats "
        "profile contract, obs/profile.py)"),
    "profile_store_hits": (
        "gauge", "runs whose starting capacity bucket was seeded "
        "from a persisted observed-stats profile (obs/profile.py; "
        "per query)"),
    "result_cache_hits": (
        "counter", "result-cache hits: fragment page replays + full-"
        "statement row replays (presto_tpu_torch/cache/; executor "
        "lifetime — /metrics and system.metrics overlay the "
        "process-shared store's totals)"),
    "result_cache_misses": (
        "counter", "result-cache lookups that executed for real (the "
        "entry is published when the attempt completes overflow-free)"),
    "result_cache_evictions": (
        "counter", "result-cache entries dropped by the byte-budget "
        "LRU or TTL aging (result_cache_bytes / result_cache_ttl_ms)"),
    "result_cache_invalidations": (
        "counter", "result-cache entries reclaimed by the write-path "
        "invalidation hook after DML/CTAS to their scanned tables "
        "(staleness itself is structural: snapshot_version rides in "
        "every key)"),
    "cache_warm_loads": (
        "counter", "persisted result-cache entries re-admitted at the "
        "warm-start pass (cache/persist.py manifest load): snapshot "
        "tokens re-validated against live connectors, pages decoded "
        "from the wire-serde payload files"),
    "cache_manifest_drops": (
        "counter", "persisted result-cache entries dropped LOUDLY at "
        "warm load: snapshot token moved, payload file missing or "
        "corrupt, manifest truncated, or wire-serde fingerprint "
        "mismatch — never served, never a crash"),
    "cache_remote_hits": (
        "counter", "leaf tasks short-circuited by a FLEET member's "
        "fragment cache: the coordinator's pre-dispatch probe "
        "(dist/cacheprobe.py) found the fragment's pages on a worker "
        "and fetched them over the spool plane instead of executing "
        "the task"),
    "cache_subsumed_hits": (
        "counter", "fragments served by CONTAINMENT rewrite "
        "(cache/rules.py): a cached sibling with a wider single-"
        "column range/IN filter replayed through this fragment's own "
        "predicate as a residual filter"),
    "probe_deadline_skips": (
        "counter", "remote-cache probes skipped because the query's "
        "remaining query_max_run_time could not afford the probe "
        "wall (the task dispatched normally instead)"),
    "h2d_bytes": (
        "gauge", "bytes staged host->device through the exec/xfer.py "
        "choke points this query"),
    "d2h_bytes": (
        "gauge", "bytes pulled device->host through the exec/xfer.py "
        "choke points this query (spill, exchange serialization, "
        "result decode)"),
    "h2d_transfers": (
        "gauge", "host->device crossings this query (exec/xfer.py; "
        "transfer_wall_s carries their summed wall as a computed "
        "entry)"),
    "d2h_transfers": (
        "gauge", "device->host crossings this query (exec/xfer.py)"),
    "mesh_local_exchanges": (
        "counter", "exchanges that never left the process: spooled "
        "edges served Pages directly between same-process placements "
        "(dist/spool.local_source_pages — no HTTP, no serde; executor "
        "lifetime)"),
    "adaptive_replans": (
        "counter", "stage-boundary re-plans applied by the adaptive "
        "executor (adaptive/): the not-yet-dispatched suffix of a "
        "stage DAG was re-optimized from exact spool stats and "
        "re-verified before dispatch (coordinator lifetime)"),
    "adaptive_dist_flips": (
        "counter", "join distributions flipped at runtime by the "
        "adaptive re-planner (partitioned -> broadcast reads of a "
        "small observed build, repartition producers degraded to "
        "passthrough, build re-orders)"),
    "adaptive_capacity_seeds": (
        "counter", "downstream fragment capacities re-bucketed onto "
        "the shapes.py ladder from observed exchange cardinality "
        "(aggregation capacities, RemoteSource est_rows stamps)"),
    "adaptive_replan_rejected": (
        "counter", "adaptive re-plans DISCARDED because the mutated "
        "DAG failed plan_check.verify_dag (or the per-query "
        "adaptive_max_replans bound was hit): the static plan runs, "
        "counted loudly"),
    "skew_preempted": (
        "counter", "grace-join passes that started in the skew-"
        "rebalanced position chunking on their FIRST attempt because "
        "the adaptive re-planner saw a hot partition in the upstream "
        "spool histogram (worker counts mirror onto the "
        "coordinator)"),
    "trace_spans": (
        "gauge", "spans recorded into this query's lifecycle trace "
        "(obs/trace.py; pinned 0 when tracing is off)"),
    "exchange_wire_bytes": (
        "counter", "exchange-page bytes actually shipped on the wire "
        "by dist/serde.serialize_page (post-codec blob size; "
        "executor lifetime — exchange_raw_bytes / exchange_wire_bytes "
        "is the wire compression ratio)"),
    "exchange_raw_bytes": (
        "counter", "pre-codec array bytes behind the serialized "
        "exchange pages (what a raw wire would have shipped; "
        "executor lifetime)"),
    "exchange_fetch_reused_conns": (
        "counter", "shuffle-plane HTTP requests served on a reused "
        "keep-alive connection from dist/connpool.py instead of a "
        "fresh TCP connect (executor lifetime)"),
    "listener_errors": (
        "counter", "EventListener exceptions swallowed by the "
        "events.dispatch choke point — counted here instead of lost "
        "silently (executor lifetime)"),
    "cross_query_batches": (
        "counter", "shared cross-query device steps dispatched by "
        "this executor as a gather-group LEADER "
        "(server/launch_batcher.py; executor lifetime — the leader's "
        "one launch covers every ganged query)"),
    "cross_query_batched_queries": (
        "counter", "launches this executor served FROM a shared "
        "cross-query batch instead of a solo program (leader and "
        "follower slots both count; executor lifetime)"),
    "batch_gather_wait_ms": (
        "counter", "milliseconds this executor's launches spent in "
        "the cross-query gather window (bounded by "
        "cross_query_batch_wait_ms per launch; executor lifetime)"),
    "queries_per_launch": (
        "gauge", "widest cross-query batch this executor rode (slots "
        "per shared launch; 0 = every launch ran solo)"),
}

# stats-dict entries COMPUTED in execute_with_stats rather than read off
# an executor attribute (the counter sweep does not look for
# `self.<name> +=` sites for these).
COMPUTED_COUNTERS = (
    "splits_per_launch",     # splits_scanned / program_launches
    "compile_wall_s",        # float wall of this query's graph captures
    "transfer_wall_s",       # float wall of metered crossings (xfer)
    "peak_device_bytes",     # high-water gauge (max, not +=)
    "deadline_ms_remaining",  # derived from query_deadline
)


def snapshot(ex) -> Dict[str, int]:
    """Registry-driven counter snapshot of one executor (missing
    attributes read 0, so a bare Executor and a DCN coordinator render
    the same rows)."""
    return {name: int(getattr(ex, name, 0)) for name in QUERY_COUNTERS}
