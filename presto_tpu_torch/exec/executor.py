"""Plan interpreter: runs each plan node as page-at-a-time tensor programs
on one device, with host-side control (capacity retries, build sizing,
limit accounting) between them.

Port of the core of presto_tpu/exec/executor.py: scan, filter, project,
grouped and global aggregation (single, partial and final steps), the
equi-join (the unique-key kernel fast path, the radix/dim kernel range
finder, and the sort join), sort, top-N, limit and output decode, with
the reference's deferred overflow flags and capacity-boost retry. The
kernels of ops/cuda_agg.py (K1) and ops/cuda_join.py (K2/K3) engage the
way presto_tpu engages its Pallas kernels under
``pallas_join_enabled=force`` (``kernels=True``, the default).

The stage-DAG distributed path adds the executor's DCN half: the
``remote_sources`` registry that RemoteSource leaves read (a worker
task's spooled-exchange inputs, or the coordinator's drain of the final
stages), ``stream_fragment`` (a shipped fragment's pages through an
emit callback under the same overflow ladder, for the worker's spooled
emit), the exchange-tier switches and the exchange counters.

The reference's default TPC-H path: the build-free generated join
(closed-form key inverse + generate-at-index, ``_generated_join_page``)
and whole-pipeline fusion (``_fused_stream``): a scan -> filter ->
project -> generated join -> partial aggregation chain runs per split
(or per batch of splits) as ONE program, which exec/graphs.py captures
into a CUDA graph on the card and replays.

Semi and anti joins emit each probe page with a BOOLEAN match column
(``_semi_join_page``), UniqueId numbers the stream's slots, and the
windowed generated join (``_generated_join_window_page``) resolves
fact-to-fact joins on slot-structured tables (TPC-DS ticket and order
numbers) by generating the other keys at each candidate slot.

The scale paths: the device-memory governor (exec/membudget.py) sizes
scan pages, fused chains, join outputs, join builds and aggregation
state to shares of a byte budget; over their share, joins and grouped
aggregations run in grace (hash-partition) passes, whose re-streamed
intermediates live in exec/pagestore.py's device, host or disk tier;
a hot join partition chunks by position on a boosted retry (skew
rebalance). A device memory fault (exec/faults.py) re-enters the query
under a halved budget (the device-OOM ladder of stream_fragment). Join
chains may defer carried build columns as row-id indirections (late
materialization, exec/latemat.py).

The relational surface: Values, Union, CrossJoin (a capped build with
the deferred overflow flag), MarkDistinct (count(DISTINCT a) beside
plain aggregates), GroupId (one replica per grouping set, aggregated
over (keys..., gid) through the grouped path), Window (ops/window.py),
Unnest over dictionary-coded arrays, approx_distinct (ops/hll.py) and
the collect aggregates array_agg, map_agg and approx_percentile
(ops/collect.py).

The stats plane: ``execute_with_stats`` (EXPLAIN ANALYZE) collects each
node's wall, pages and rows in ``pages()`` (with ``stats_drain`` every
``next()`` ends in a device synchronize), and reads the query's counters
off the registry (exec/counters.py). A traced query records execute,
attempt and operator spans (obs/); every host<->device crossing meters
onto the running executor (exec/xfer.py); a profile store seeds the
capacity boost (obs/profile.py); ``plan_check`` verifies a plan before
anything runs (exec/plan_check.py).

Left for later slices (ROADMAP): the cross-query launch batcher and the
result cache.

Deferred-sync discipline, as in the reference: overflow flags stay
device scalars and are read ONCE per attempt; on overflow the whole
query re-runs with capacities boosted up the shared ladder
(exec/shapes.py).

Reference: presto-main operator/Driver.java moving Pages through
operator chains.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch import devsync
from presto_tpu_torch import resolve_device
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.base import Connector
from presto_tpu_torch.exec import agg_states as S
from presto_tpu_torch.exec import counters as CTRS
from presto_tpu_torch.exec import faults as FAULTS
from presto_tpu_torch.exec import graphs
from presto_tpu_torch.exec import latemat as LM
from presto_tpu_torch.exec import membudget as MB
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec import prune as PR
from presto_tpu_torch.exec import shapes as SH
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.exec.pagestore import PageStore, page_bytes
from presto_tpu_torch.expr.eval import evaluate, evaluate_filter
from presto_tpu_torch.expr.ir import InputRef
from presto_tpu_torch.ops import agg as A
from presto_tpu_torch.ops import collect as CL
from presto_tpu_torch.ops import consts
from presto_tpu_torch.ops import cuda_agg as CA
from presto_tpu_torch.ops import cuda_join as CJ
from presto_tpu_torch.ops import hashing as H
from presto_tpu_torch.ops import hll as HLL
from presto_tpu_torch.ops import join as J
from presto_tpu_torch.ops import keys as K
from presto_tpu_torch.ops import u64
from presto_tpu_torch.ops import window as W
from presto_tpu_torch.ops.compact import (compact_page, concat_all,
                                          gather_rows, slice_page)
from presto_tpu_torch.ops.sort import sort_page
from presto_tpu_torch.page import Block, Dictionary, Page

_next_pow2 = SH.bucket

_MAX_ATTEMPTS = 6


class MemoryBudgetExceeded(RuntimeError):
    """Reference: ExceededMemoryLimitException — a page footprint past
    query_max_memory_bytes fails the query rather than thrash."""


class QueryDeadlineExceeded(RuntimeError):
    """The query ran past query_max_run_time (raised at page
    boundaries and in the DCN fetch/status loops)."""


def check_deadline(deadline: Optional[float], where: str) -> None:
    """Raise QueryDeadlineExceeded once time.monotonic() passes
    ``deadline`` (None = no deadline)."""
    if deadline is not None and time.monotonic() > deadline:
        raise QueryDeadlineExceeded(
            f"query exceeded query_max_run_time {where}")


def _row_bytes(types) -> int:
    """Static per-row footprint of a channel list (the planner's join
    ordering weighs builds by it)."""
    total = 2  # valid bit + null mask, bytewise
    for t in types:
        if isinstance(t, T.DecimalType) and not t.is_short:
            total += 16
        elif isinstance(t, T.HllStateType):
            total += 8 * HLL.WORDS  # packed register words
        elif T.is_string(t):
            total += 4  # dictionary codes
        else:
            try:
                total += np.dtype(t.numpy_dtype).itemsize
            except (TypeError, AttributeError, KeyError):
                total += 8
    return total


def _canonical_join_cols(left_blocks: List[Block],
                         right_blocks: List[Block]):
    """Equality-encoded u64 key columns for a join, canonicalizing
    dictionary-coded pairs through a merged host universe so equal
    strings compare equal across differing dictionaries."""
    lcols, rcols, lnulls, rnulls = [], [], [], []
    for lb, rb in zip(left_blocks, right_blocks):
        if lb.dictionary is not None or rb.dictionary is not None:
            ld, rd = lb.dictionary, rb.dictionary
            if ld == rd and not (ld is not None
                                 and ld.has_duplicate_values()):
                lcols.append(lb.data.to(torch.int64))
                rcols.append(rb.data.to(torch.int64))
            else:
                universe = {}
                for d in (ld, rd):
                    for v in (d.values if d is not None else []):
                        universe.setdefault(v, len(universe))

                def canon(b, d):
                    if d is None or len(d) == 0:
                        return torch.zeros(b.data.shape, dtype=torch.int64,
                                           device=b.device)
                    lut = np.array([universe[v] for v in d.values],
                                   np.int64)
                    codes = b.data.clamp(0, len(d) - 1).to(torch.int64)
                    return consts.lut(lut, b.device)[codes]

                lcols.append(canon(lb, ld))
                rcols.append(canon(rb, rd))
            lnulls.append(lb.nulls)
            rnulls.append(rb.nulls)
        else:
            lc = K.equality_encoding(lb)
            rc = K.equality_encoding(rb)
            lcols.extend(lc)
            rcols.extend(rc)
            lnulls.extend([lb.nulls] * len(lc))
            rnulls.extend([rb.nulls] * len(rc))
    return lcols, lnulls, rcols, rnulls


@dataclasses.dataclass
class NodeStats:
    """Per-plan-node execution stats (reference: OperatorStats). Row
    counts stay device scalars during the run (one per page) and
    resolve in one pass after it (resolve_row_counts)."""

    label: str
    wall_s: float = 0.0
    pages: int = 0
    row_counts: list = dataclasses.field(default_factory=list)

    @property
    def rows(self) -> int:
        return sum(int(c) for c in self.row_counts)


def resolve_row_counts(stats) -> None:
    """Replace every NodeStats' deferred device row counts by host
    ints with ONE device read for the whole run (a per-page ``int()``
    would sync the card on every page and change the walls it
    measures). Diagnostics, not query data: not a metered crossing."""
    pending = [(st, i, c) for st in stats.values()
               if isinstance(st, NodeStats)
               for i, c in enumerate(st.row_counts)
               if isinstance(c, torch.Tensor)]
    if not pending:
        return
    # one executor's pages all lie on its device
    vals = torch.stack([c.reshape(()) for _st, _i, c in pending])
    for (st, i, _c), v in zip(pending, vals.tolist()):
        st.row_counts[i] = int(v)


class _FoldBuffer:
    """Bounded incremental merge of partial-state pages: buffered pages
    flush into one accumulator through a merge-only group-by whenever
    flush_slots accumulate. Shared by the single-pass aggregation, the
    multi-pass partitioned aggregation and the per-partition fold
    accumulators (reference: InMemoryHashAggregationBuilder flushing
    under memory pressure)."""

    def __init__(self, ex, merge_fn, pcap, max_iters, flush_slots):
        self.ex = ex
        self.merge_fn = merge_fn
        self.pcap = pcap
        self.max_iters = max_iters
        self.flush_slots = flush_slots
        self.acc = None
        self.buf: list = []
        self.slots = 0
        self.saw_input = False

    def add(self, page) -> None:
        self.saw_input = True
        if self.buf and self.slots + page.capacity > self.flush_slots:
            # pre-flush: the merge concat stays bounded by acc +
            # flush_slots + one page (the governor's fold bound)
            self.flush()
        self.buf.append(page)
        self.slots += page.capacity
        if self.slots >= self.flush_slots:
            self.flush()

    def _merged(self):
        pages = ([self.acc] if self.acc is not None else []) + self.buf
        if not pages:
            return None
        merged = concat_all(pages) if len(pages) > 1 else pages[0]
        self.ex._account_page(merged)
        return merged

    def flush(self) -> None:
        merged = self._merged()
        if merged is None:
            return
        out, overflow = self.merge_fn(merged, self.pcap, self.max_iters)
        self.ex._pending_overflow.append(overflow)
        self.acc, self.buf, self.slots = out, [], 0

    def final_merged(self):
        """All remaining state as one page (None if nothing was added)."""
        return self._merged()


class Executor:
    """Reference: LocalQueryRunner's local execution half — interpret a
    physical plan against in-process connectors on one device."""

    def __init__(self, catalogs, *, page_rows: int = 1 << 18,
                 device=None, kernels: bool = True):
        self.catalogs = catalogs
        self.page_rows = page_rows
        self.device = resolve_device(device)
        # the K1/K2/K3 dispatch points (presto_tpu's
        # pallas_join_enabled=force); False runs every aggregate and join
        # on its plain torch path
        self.kernels = kernels
        # optimistic group-capacity clamp (presto_tpu's session default
        # agg_optimistic_rows)
        self.agg_optimistic_rows = 1 << 18
        # collect-state slots per group (array_agg_max_elements), scaled
        # by the capacity boost on a retry (_collect_k_eff)
        self.collect_k = 1024
        self._pending_overflow: List[torch.Tensor] = []
        self._capacity_boost = 1
        self.capacity_boost_retries = 0
        # DCN ingest registry: RemoteSource.key -> callable yielding the
        # edge's pages (a worker task's spool sources, or the
        # coordinator's drain of the final stages)
        self.remote_sources: Dict[str, Callable[[], Iterator[Page]]] = {}
        # device_exchange_enabled: "true" | "false" | "auto" (= on a
        # CUDA executor)
        self.device_exchange = "auto"
        # wall-clock deadline (time.monotonic) from query_max_run_time
        self.query_deadline: Optional[float] = None
        # the reference's default TPC-H path (session properties of the
        # same names): tpu_offload_enabled (off = nothing fuses),
        # generated_join_enabled, fused_partial_agg_enabled ("auto" |
        # "true" | "false") and split_batch_size ("auto" | 0 | an int).
        # "auto" is on when the executor runs on a CUDA device, where
        # the reference says "on TPU": the win is the per-launch host
        # cost a graph replay removes, which the CPU does not pay
        self.offload = True
        self.generated_join = True
        self.agg_fusion = "auto"
        self.split_batch = "auto"
        # fusion counters under the reference's names: generated joins
        # built (cumulative), fused streams with a partial-aggregation
        # tail, program launches (graph replays on the card) and the
        # real splits they covered, this attempt — splits_per_launch is
        # their ratio. split_batch_fallbacks stays 0: the port never
        # falls back from a batched program to the per-split loop
        self.generated_joins_used = 0
        self.fused_partial_aggs = 0
        self.program_launches = 0
        self.splits_scanned = 0
        self.split_batch_fallbacks = 0
        # exchange counters (reference: exec/counters.py rows of the
        # same names)
        self.spooled_exchange_pages = 0
        self.spooled_exchange_rows = 0
        self.mesh_local_exchanges = 0
        self.stages_scheduled = 0
        self.release_skips = 0
        # the ICI exchange plane (dist/scheduler.py; the coordinator's,
        # lifetime counters): repartition edges lowered to the mesh
        # all_to_all, their bytes, and loud fallbacks to the spools
        self.ici_exchanges = 0
        self.ici_bytes = 0
        self.mesh_exchange_fallbacks = 0
        # fault-tolerant stage scheduling (dist/dcn.py,
        # dist/scheduler.py; the coordinator's, lifetime counters)
        self.task_retries = 0
        self.workers_excluded = 0
        self.nonleaf_replays = 0
        self.speculative_tasks_won = 0
        self.speculative_tasks_lost = 0
        # coordinator HA (dist/checkpoint.py; the coordinator's,
        # lifetime counters): journal records published, queries
        # recovered across a restart, dead placements re-dispatched
        # during re-attach, checkpoint records dropped loudly
        self.checkpoints_written = 0
        self.coordinator_reattaches = 0
        self.reattach_redispatches = 0
        self.checkpoint_drops = 0
        # adaptive re-planning at stage boundaries (adaptive/; the
        # coordinator's)
        self.adaptive_replans = 0
        self.adaptive_dist_flips = 0
        self.adaptive_capacity_seeds = 0
        self.adaptive_replan_rejected = 0
        # ---- memory governor, spill and the device-OOM ladder (the
        # reference's session properties of the same names; runner.
        # apply_session wires them). Page footprints are computed from
        # static shapes (host arithmetic, never a device read): their
        # high-water mark is peak_memory_bytes, and one past
        # max_memory_bytes fails the query (MemoryBudgetExceeded)
        self.max_memory_bytes: Optional[int] = None
        self.peak_memory_bytes = 0
        # grace partitioning: join builds / aggregation states whose
        # estimate exceeds spill_bytes run in hash-partition passes;
        # max_build_rows partitions joins on the build's row estimate
        self.spill_bytes: Optional[int] = None
        self.max_build_rows: Optional[int] = None
        self.spill_partitions_used = 0
        # restreamable intermediates of multi-pass operators
        # (_source_stream): above host_spill_bytes they stage to host
        # RAM, above disk_spill_bytes to files under spill_path
        self.host_spill_bytes: Optional[int] = None
        self.disk_spill_bytes: Optional[int] = None
        self.spill_path: Optional[str] = None
        self._stream_cache: Dict = {}
        self.host_spill_pages = 0
        self.host_spill_bytes_used = 0
        self.disk_spill_pages = 0
        # on boosted retries, inner grace-join partitions chunk their
        # build rows by position (skew_chunks_used: most chunks of one
        # partition)
        self.join_skew_rebalance = True
        self.skew_chunks_used = 0
        # the re-planner's skew hint (a worker task's payload): inner
        # grace joins start in the rebalance on the FIRST attempt, each
        # such engagement counted on skew_preempted
        self.skew_preengaged = False
        self.skew_preempted = 0
        # device-memory budget in bytes (0 = auto, exec/membudget.py);
        # memory_chunked_pipelines: governed rewrites this attempt
        self.device_memory_budget = 0
        self._budget_resolved: Optional[Tuple] = None
        self.memory_chunked_pipelines = 0
        # device-OOM ladder: a device memory fault re-enters the query
        # under a halved budget, up to device_oom_attempts times;
        # inject_device_oom raises a synthetic fault on the next N
        # attempts (tests and the chip check set it; FAULT_DEVICE_OOM
        # seeds it in worker and coordinator processes)
        self.device_oom_attempts = 2
        self.device_oom_retries = 0
        # the type of each fault the ladder absorbed, in order
        self.device_oom_faults: List[type] = []
        self._oom_divisor = 1
        self.inject_device_oom = int(
            os.environ.get("FAULT_DEVICE_OOM", "0") or 0)
        # late materialization (late_materialization_enabled): "auto"
        # is on a CUDA executor; a raw Executor defaults to on, as the
        # reference's does. gathers_deferred: per-page column gathers
        # skipped at join output; gathers_materialized: per-page column
        # gathers performed (lift + chain-boundary finish)
        self.late_mat = True
        self.gathers_deferred = 0
        self.gathers_materialized = 0
        # ---- the stats plane. _collect_stats: id(node) -> NodeStats
        # while EXPLAIN ANALYZE (execute_with_stats) or a trace runs;
        # stats_drain makes every node's next() end in a device
        # synchronize, so its wall is device time, not enqueue time
        self._collect_stats: Optional[Dict] = None
        self.stats_drain = False
        # kernel engagements at the reference's Pallas dispatch points
        # (lifetime): pallas_joins_used the K2/K3 probes,
        # pallas_kernels_used every K1/K2/K3/K4 engagement
        self.pallas_joins_used = 0
        self.pallas_kernels_used = 0
        # the compile counters count CUDA graphs (exec/graphs.py):
        # captures this query, their seconds, and the fused-program
        # calls a captured graph served
        self.programs_compiled = 0
        self.program_cache_hits = 0
        self.compile_wall_s = 0.0
        # plan_check (exec/plan_check.py): "auto" = on under pytest or
        # when PRESTO_TPU_PLAN_CHECK opts in, off on the serving path
        self.plan_check = "auto"
        # query-lifecycle tracing (obs/): the active QueryTrace, attached
        # per query by the runner; None = tracing off, and every
        # recording site guards on that one check. trace_spans: spans
        # this executor recorded into it (pinned 0 when off)
        self.trace = None
        self.trace_spans = 0
        # observed-stats profiles (obs/profile.py): with a store wired
        # (stats_profile_dir), a query starts at the capacity boost a
        # previous run of the same plan settled on
        self.profile_store = None
        self.profile_store_hits = 0
        # transfer ledger (exec/xfer.py): this query's metered
        # host<->device crossings while the executor is the thread's
        # sink; transfer_wall_s is their summed wall
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.h2d_transfers = 0
        self.d2h_transfers = 0
        self.transfer_wall_s = 0.0
        # listener_errors: EventListener exceptions swallowed by
        # events.dispatch, counted through count_listener_error
        # (executor lifetime)
        self.listener_errors = 0
        # the exchange wire plane (dist/serde.py, dist/connpool.py),
        # metered through the thread-bound transfer sink:
        # exchange_wire_bytes = post-codec blob bytes serialize_page
        # shipped, exchange_raw_bytes = the array bytes behind them,
        # exchange_fetch_reused_conns = requests served on a reused
        # keep-alive connection (executor lifetime)
        self.exchange_wire_bytes = 0
        self.exchange_raw_bytes = 0
        self.exchange_fetch_reused_conns = 0
        # cross-query launch batching (server/launch_batcher.py): the
        # concurrent server attaches ONE process-shared LaunchBatcher
        # to every per-query executor, and a single-split fused launch
        # offers itself to it; compatible launches of other queries
        # gang into one batched program with a per-slot output.
        # cross_query_batching is the tri-state session knob ("auto" =
        # on whenever a batcher is attached); wait_ms bounds the gather
        # window. cross_query_batches = shared launches this executor
        # made as leader; cross_query_batched_queries = launches it
        # served from a shared batch (leader or follower);
        # batch_gather_wait_ms = summed window wait; queries_per_launch
        # = widest batch ridden (per attempt)
        self.launch_batcher = None
        self.cross_query_batching = "auto"
        self.cross_query_batch_wait_ms = 25
        # ---- the streaming plane (connectors/stream.py, streaming/,
        # the server's tailing cursors): lifetime counters, so every
        # surface (EXPLAIN ANALYZE, /metrics, system.metrics) renders
        # refresh activity. delta_pages_folded = delta partial-state
        # pages an IVM refresh folded into persisted view state;
        # ivm_refreshes = incremental refreshes completed;
        # ivm_full_recomputes = refreshes that fell back to a full
        # recompute (a non-IVM-safe plan or ivm_enabled=false, counted,
        # never silent); cursor_polls = tailing /v1/statement polls
        # served; stream_appends_seen = append batches seen on
        # append-only connectors (the runner's INSERT path and tail
        # polls that saw the offset move)
        self.delta_pages_folded = 0
        self.ivm_refreshes = 0
        self.ivm_full_recomputes = 0
        self.cursor_polls = 0
        self.stream_appends_seen = 0
        self.cross_query_batches = 0
        self.cross_query_batched_queries = 0
        self.batch_gather_wait_ms = 0
        self.queries_per_launch = 0
        # ---- the result cache (presto_tpu_torch/cache/): with a
        # ResultCache wired (result_cache_enabled -> runner.
        # apply_session, or set directly), execute()/stream_fragment()
        # select the plan's maximal cacheable subtrees as CACHE POINTS
        # (cache/rules.py) and pages() serves them from the store: a hit
        # replays stored host pages and captures or replays no program
        # (program_launches stays 0); a miss streams normally while
        # collecting, and publishes ONLY after the attempt completes
        # overflow-free (a truncated page set is never cached). The
        # counters are executor-lifetime, like the join counters;
        # /metrics and system.metrics overlay the process-shared store's
        # totals so concurrent per-query executors add up
        self.result_cache = None
        self.result_cache_hits = 0
        self.result_cache_misses = 0
        self.result_cache_evictions = 0
        self.result_cache_invalidations = 0
        # the fleet tallies: warm-start loads and drops (the runner's
        # boot pass), coordinator-probed remote hits (dist/dcn.py,
        # dist/scheduler.py), containment-rewrite hits, and remote
        # probes the query deadline could not afford
        self.cache_warm_loads = 0
        self.cache_manifest_drops = 0
        self.cache_remote_hits = 0
        self.cache_subsumed_hits = 0
        self.probe_deadline_skips = 0
        # serve contained filters from wider cached siblings
        # (result_cache_subsumption)
        self.cache_subsumption = False
        # per-query cache-point state: id(subtree) -> (key, node,
        # tables, watermark, snap, family), node refs held so the ids
        # stay stable; inflight guards the miss path's re-entrant
        # pages() call; pending holds completed-but-unpublished streams
        # until the attempt succeeds
        self._cache_points: Dict[int, tuple] = {}
        self._cache_inflight: set = set()
        self._cache_pending: List = []
        # host-serve sink: ids of the plan nodes whose pages feed ONLY
        # result decode or a task's serialization (the root and its
        # pass-through chain): a cache replay there serves its host
        # pages as they are, zero h2d and zero d2h
        self._host_sink_ids: frozenset = frozenset()
        # the captured programs this query's fused streams used (keys
        # of exec/graphs.py's cache): a device fault releases these,
        # not every query's (_release_device_memory); the releases'
        # keys are recorded in programs_released, in order
        self._query_programs: set = set()
        self.programs_released: List[tuple] = []
        # counter baselines of the query in flight (_begin_query)
        self._joins_counter_base = (0, 0)
        self._graph_base = graphs.snapshot()

    # --------------------------------------------------------------- types
    def output_types(self, node: P.PhysicalNode) -> List[T.SqlType]:
        """Static output channel types."""
        if isinstance(node, P.TableScan):
            schema = self.catalogs[node.catalog].table_schema(node.table)
            return [schema.column_type(c) for c in node.columns]
        if isinstance(node, (P.Filter, P.Limit, P.Sort, P.TopN, P.Output,
                             P.Exchange)):
            return self.output_types(node.source)
        if isinstance(node, P.Project):
            return [e.type for e in node.exprs]
        if isinstance(node, P.Aggregation):
            if node.step == "partial":
                src = self.output_types(node.source)
                out = [src[c] for c in node.group_channels]
                for spec, in_t in zip(node.aggregates,
                                      self._agg_in_types(node)):
                    out.extend(st.type for st in
                               S.state_layout(spec.function, in_t))
                return out
            if node.step == "final":
                src = self.output_types(self._partial_origin(node).source)
                out = self.output_types(node.source)[
                    :len(node.group_channels)]
            else:
                src = self.output_types(node.source)
                out = [src[c] for c in node.group_channels]
            for spec in node.aggregates:
                in_t = None if spec.channel is None else src[spec.channel]
                out.append(S.result_type(
                    spec.function, in_t,
                    tuple(src[c] for c in spec.extra_channels)))
            return out
        if isinstance(node, P.HashJoin):
            left = self.output_types(node.left)
            if node.join_type in ("semi", "anti"):
                # the probe page plus the match column the planner filters
                return left + [T.BOOLEAN]
            return left + self.output_types(node.right)
        if isinstance(node, P.CrossJoin):
            return self.output_types(node.left) + self.output_types(
                node.right)
        if isinstance(node, (P.UniqueId, P.GroupId)):
            return self.output_types(node.source) + [T.BIGINT]
        if isinstance(node, (P.RemoteSource, P.Values)):
            return list(node.types)
        if isinstance(node, P.MarkDistinct):
            return self.output_types(node.source) + [
                T.BOOLEAN for _ in node.mark_channel_sets]
        if isinstance(node, P.Window):
            src = self.output_types(node.source)
            return src + [
                W.result_type(fn, None if fn.arg_channel is None
                              else src[fn.arg_channel])
                for fn in node.functions]
        if isinstance(node, P.Unnest):
            out = self.output_types(node.source) + [node.element_type]
            if node.with_ordinality:
                out.append(T.BIGINT)
            return out
        if isinstance(node, P.Union):
            return self.output_types(node.sources[0])
        raise TypeError(f"unknown node: {node!r}")

    # ------------------------------------------------------------- execute
    def pages(self, node: P.PhysicalNode) -> Iterator[Page]:
        """Stream the pages of a node, each accounted against the query's
        memory limit (_account_page), collecting per-node stats when an
        EXPLAIN ANALYZE run or a trace enabled them (reference:
        OperatorContext wall/row accounting feeding PlanPrinter). A
        node's wall is the time spent in its next() calls, its inputs'
        included; a chain fused into one program per split reports on
        its top node only, since no host code runs inside the program.

        A result-cache point (cache/rules.py) serves from or populates
        the shared store (_cached_pages); the inflight guard lets the
        miss path re-enter this method for the real stream."""
        if self._cache_points:
            entry = self._cache_points.get(id(node))
            if entry is not None and id(node) not in self._cache_inflight:
                yield from self._cached_pages(node, entry)
                return
        impl = self._pages_impl(node)
        if self._collect_stats is None:
            for page in impl:
                self._account_page(page)
                yield page
            return
        st = self._collect_stats.setdefault(
            id(node), NodeStats(type(node).__name__))
        while True:
            t0 = time.perf_counter()
            try:
                page = next(impl)
                if self.stats_drain:
                    # every next() ends with the device idle, so the
                    # wall is device time, not enqueue time
                    devsync.drain(self.device)
            except StopIteration:
                st.wall_s += time.perf_counter() - t0
                break
            st.wall_s += time.perf_counter() - t0
            st.pages += 1
            # a device scalar, resolved after the run (resolve_row_counts)
            st.row_counts.append(page.num_rows())
            self._account_page(page)
            yield page

    def _pages_impl(self, node: P.PhysicalNode) -> Iterator[Page]:
        if isinstance(node, (P.Filter, P.Project, P.HashJoin)):
            fused = self._fused_stream(node)
            if fused is not None:
                yield from fused
                return
        if isinstance(node, P.TableScan):
            # generation-chunked scan (membudget.py): the page shrinks
            # so one generated buffer fits its budget share
            yield from self.catalogs[node.catalog].pages(
                node.table, node.columns,
                target_rows=self._governed_target_rows(
                    self.output_types(node)),
                constraint=node.constraint)
            return
        if isinstance(node, P.Filter):
            for page in self.pages(node.source):
                yield evaluate_filter(node.predicate, page)
            return
        if isinstance(node, P.Project):
            for page in self.pages(node.source):
                yield _project_page(node.exprs, page)
            return
        if isinstance(node, P.Aggregation):
            yield from self._exec_aggregation(node)
            return
        if isinstance(node, P.HashJoin):
            yield from self._exec_join(node)
            return
        if isinstance(node, P.TopN):
            # streaming top-N: per page the local top-N, merged with the
            # running candidate set (reference: TopNOperator)
            running = None
            for page in self.pages(node.source):
                local = sort_page(page, sort_keys=node.keys,
                                  limit=node.limit)
                running = local if running is None else _topn_merge(
                    node.keys, node.limit, running, local)
            if running is not None:
                yield running
            return
        if isinstance(node, P.Sort):
            pages = list(self.pages(node.source))
            if pages:
                yield sort_page(concat_all(pages), sort_keys=node.keys)
            return
        if isinstance(node, P.Limit):
            # the running row count stays a device scalar
            consumed = torch.zeros((), dtype=torch.int64,
                                   device=self.device)
            for page in self.pages(node.source):
                out, consumed = _limit_with_count(node.count, node.offset,
                                                  page, consumed)
                yield out
            return
        if isinstance(node, (P.Output, P.Exchange)):
            # single-device execution: an exchange is a pass-through
            yield from self.pages(node.source)
            return
        if isinstance(node, P.UniqueId):
            # a row id unique across the stream: slot position plus the
            # slots of the pages before (a host int: no device read)
            offset = 0
            for page in self.pages(node.source):
                ids = Block(data=torch.arange(
                    offset, offset + page.capacity, dtype=torch.int64,
                    device=page.device), type=T.BIGINT)
                offset += page.capacity
                yield Page(blocks=page.blocks + (ids,), valid=page.valid)
            return
        if isinstance(node, P.RemoteSource):
            # DCN ingest (reference: ExchangeOperator): the registered
            # supplier yields spooled Pages (already on the card when a
            # same-process producer hands them over) or deserialized
            # host pages (numpy), staged onto this executor's device. An
            # edge delivers one small page per producer page and
            # partition, so pages coalesce up to page_rows slots (no
            # host sync)
            buf, slots = [], 0
            for page in self.remote_sources[node.key]():
                buf.append(XF.to_device(page, self.device,
                                        label="remote-source"))
                slots += page.capacity
                if slots >= self.page_rows:
                    yield concat_all(buf)
                    buf, slots = [], 0
            if buf:
                yield concat_all(buf)
            return
        if isinstance(node, P.Values):
            cols = (list(zip(*node.rows)) if node.rows
                    else [[] for _ in node.types])
            yield Page.from_arrays([list(c) for c in cols],
                                   list(node.types), device=self.device)
            return
        if isinstance(node, P.Union):
            for src in node.sources:
                yield from self.pages(src)
            return
        if isinstance(node, P.CrossJoin):
            right_pages = list(self.pages(node.right))
            if not right_pages:
                return
            build_all = concat_all(right_pages)
            # a modest static build capacity (the output is probe_cap x
            # build_cap); dropped rows raise the deferred overflow flag
            # and the query re-runs with a boosted capacity
            bcap = min(_next_pow2(build_all.capacity),
                       _next_pow2(4096 * self._capacity_boost))
            self._pending_overflow.append(build_all.num_rows() > bcap)
            build = compact_page(build_all, bcap)
            for page in self.pages(node.left):
                yield _cross_join_page(page, build)
            return
        if isinstance(node, P.Unnest):
            for page in self.pages(node.source):
                yield _unnest_page(node.array_channel, node.element_type,
                                   node.with_ordinality, page)
            return
        if isinstance(node, P.GroupId):
            # one replica per grouping set: absent keys nulled, the gid
            # channel appended (reference: GroupIdOperator)
            for page in self.pages(node.source):
                for si, mask in enumerate(node.set_masks):
                    yield _group_id_page(node.key_channels, mask, si, page)
            return
        if isinstance(node, P.MarkDistinct):
            pages = list(self.pages(node.source))
            if not pages:
                return
            merged = concat_all(pages)
            self._account_page(merged)
            # the boost deepens the probe budget on a retry
            out, overflow = _mark_distinct_page(
                node.mark_channel_sets, merged,
                _next_pow2(merged.capacity), 64 * self._capacity_boost)
            self._pending_overflow.append(overflow)
            yield out
            return
        if isinstance(node, P.Window):
            pages = list(self.pages(node.source))
            if not pages:
                return
            merged = concat_all(pages)
            out_types = tuple(self.output_types(node)[
                len(merged.blocks):])
            yield W.window_page(node.partition_channels, node.order_keys,
                                node.functions, out_types, merged)
            return
        raise TypeError(f"unknown node: {node!r}")

    def execute(self, node: P.PhysicalNode):
        """Materialize results: (column_names, list of row tuples).

        Runs the plan with no host synchronization, then reads the
        accumulated capacity-overflow flags once; on overflow the query
        re-runs with boosted capacities (the query-scope analog of the
        reference engine's per-operator retry), and on a device memory
        fault under a halved memory budget (stream_fragment's ladder).
        The governor's and spill's counters describe this query."""
        return self._execute(node, decode=True)

    def execute_pages(self, node: P.PhysicalNode):
        """execute() without the row decode: (column_names, the result
        pages of the last attempt), whose selected rows in page order
        are execute()'s rows. Table writes store from these."""
        return self._execute(node, decode=False)

    def _execute(self, node: P.PhysicalNode, decode: bool):
        names = list(node.names) if isinstance(node, P.Output) else None
        self.peak_memory_bytes = 0
        self.spill_partitions_used = 0
        self.host_spill_pages = 0
        self.host_spill_bytes_used = 0
        self.disk_spill_pages = 0
        self.skew_chunks_used = 0
        # pages written to a table (decode=False) go on to device code,
        # so only a decoding run serves cache hits as host pages
        prof_key = self._begin_query(node, host_sink=decode)
        # lifecycle tracing borrows the EXPLAIN ANALYZE accounting for
        # its operator spans: per page two perf_counter calls and one
        # deferred row-count scalar, no device read until after the run
        tr = self.trace
        own_stats = tr is not None and self._collect_stats is None
        if own_stats:
            self._collect_stats = {}
        exec_span = None
        if tr is not None:
            exec_span = tr.begin("execute", type(node).__name__)
            self.trace_spans += 1
        prev_sink = XF.swap_sink(self)
        try:
            pages = self._ladder(node, lambda page: page,
                                 parent_span=exec_span, trace_ops=True)
            if not decode:
                if prof_key is not None:
                    self._record_profile(prof_key, None,
                                         pages_out=len(pages))
                return names, pages
            rows: List[tuple] = []
            for page in pages:
                rows.extend(page.to_pylist())
            if prof_key is not None:
                self._record_profile(prof_key, len(rows))
            return names, rows
        finally:
            XF.swap_sink(prev_sink)
            self._end_query()
            if tr is not None:
                tr.end(exec_span, boost=self._capacity_boost)
            if own_stats:
                self._collect_stats = None

    def execute_with_stats(self, node: P.PhysicalNode):
        """EXPLAIN ANALYZE support: run the query collecting per-node
        wall time, page count and output rows. Row counts stay on the
        device during the run and resolve here, in one read."""
        self._collect_stats = {}
        try:
            names, rows = self.execute(node)
            stats = dict(self._collect_stats)
        finally:
            self._collect_stats = None
        resolve_row_counts(stats)
        # registry-driven (exec/counters.py): every declared counter
        # reaches the Counters line; the lifetime join counters report
        # THIS query's delta over the snapshot execute() took
        base_gen, base_pal = self._joins_counter_base
        ctr = CTRS.snapshot(self)
        ctr["generated_joins_used"] = self.generated_joins_used - base_gen
        ctr["pallas_joins_used"] = self.pallas_joins_used - base_pal
        # computed entries (counters.COMPUTED_COUNTERS)
        ctr["splits_per_launch"] = (
            round(self.splits_scanned / self.program_launches, 1)
            if self.program_launches else 0.0)
        ctr["compile_wall_s"] = round(self.compile_wall_s, 6)
        ctr["transfer_wall_s"] = round(self.transfer_wall_s, 6)
        ctr["peak_device_bytes"] = self.peak_memory_bytes
        ctr["deadline_ms_remaining"] = (
            int((self.query_deadline - time.monotonic()) * 1000)
            if self.query_deadline is not None else -1)
        stats["counters"] = ctr
        return names, rows, stats

    # ------------------------------------------------- per-query plumbing
    def _begin_query(self, node: P.PhysicalNode,
                     host_sink: bool = True) -> Optional[str]:
        """Per-query setup shared by execute() and stream_fragment():
        the ladder's and the gauges' resets, the plan check, the
        counter baselines, the result-cache points and the profile
        seed. ``host_sink``: the root's pages feed only row decode or a
        task's serialization, so a cache hit there serves host pages.
        Returns the profile key to record under, or None."""
        self._capacity_boost = 1
        self.capacity_boost_retries = 0
        self.profile_store_hits = 0
        self.device_oom_retries = 0
        self.device_oom_faults = []
        self._oom_divisor = 1
        if self.trace is None:
            # untraced queries pin the span counter at 0; traced ones
            # reset at obs.attach (the DCN coordinator's stage spans
            # precede its root fragment's execute and must survive it)
            self.trace_spans = 0
        self._joins_counter_base = (self.generated_joins_used,
                                    self.pallas_joins_used)
        self._graph_base = graphs.snapshot()
        self._reset_transfer_gauges()
        self._query_programs = set()
        # pre-launch plan verification (exec/plan_check.py)
        self._verify_plan(node)
        # result-cache points: pages() serves the selected subtrees from
        # the shared store; a whole-plan hit replays with no capture and
        # no launch
        self._select_cache_points(node)
        self._host_sink_ids = (self._sink_chain_ids(node) if host_sink
                               else frozenset())
        return self._seed_profile(node)

    def _end_query(self) -> None:
        """This query's graph captures, their seconds, and the calls a
        captured graph served (process-wide totals: concurrent queries
        share attribution, as in the reference)."""
        d = graphs.delta(self._graph_base)
        self.programs_compiled = int(d["captures"])
        self.compile_wall_s = d["capture_s"]
        self.program_cache_hits = int(d["replays"])
        self._cache_points = {}
        self._cache_pending = []

    def count_transfer(self, direction: str, nbytes: int,
                       wall_s: float) -> None:
        """THE sink exec/xfer.py meters crossings to while this executor
        is the thread-bound transfer sink."""
        if direction == "h2d":
            self.h2d_transfers += 1
            self.h2d_bytes += nbytes
        else:
            self.d2h_transfers += 1
            self.d2h_bytes += nbytes
        self.transfer_wall_s += wall_s

    def count_wire(self, wire: int, raw: int) -> None:
        """The sink dist/serde.serialize_page meters exchange wire bytes
        to while this executor is the thread-bound sink."""
        self.exchange_wire_bytes += wire
        self.exchange_raw_bytes += raw

    def count_reused_conn(self) -> None:
        """The sink dist/connpool.py meters one request served on a
        reused keep-alive connection to."""
        self.exchange_fetch_reused_conns += 1

    def count_listener_error(self) -> None:
        """The sink events.dispatch reports a swallowed listener
        exception to (the ``listener_errors`` registry counter)."""
        self.listener_errors += 1

    def _reset_transfer_gauges(self) -> None:
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.h2d_transfers = 0
        self.d2h_transfers = 0
        self.transfer_wall_s = 0.0

    def _trace_operators(self, tr, att_span) -> None:
        """Per-plan-node operator spans from the successful attempt's
        accounting, anchored at the attempt start — operator walls are
        per-node totals, so the spans overlap rather than partition the
        attempt. Runs once, after the run: its row counts resolve in
        one device read."""
        stats = self._collect_stats
        if not stats:
            return
        resolve_row_counts(stats)
        for st in stats.values():
            if not isinstance(st, NodeStats):
                continue
            tr.complete("operator", st.label, att_span.t0,
                        att_span.t0 + st.wall_s, parent=att_span,
                        rows=st.rows, pages=st.pages)
            self.trace_spans += 1

    def _seed_profile(self, node) -> Optional[str]:
        """Observed-stats profile seeding (obs/profile.py): start the
        overflow ladder at the SETTLED capacity bucket a previous run of
        this (plan fingerprint, connector snapshot) recorded, so the
        repeated query skips the boost climb. Returns the profile key
        for recording, or None when no store is wired."""
        if self.profile_store is None:
            return None
        key = self.profile_store.key(node, self.catalogs)
        prof = self.profile_store.lookup(key)
        if prof and int(prof.get("capacity_boost", 1)) > 1:
            self._capacity_boost = int(prof["capacity_boost"])
            self.profile_store_hits += 1
        return key

    def _record_profile(self, key: str, rows_out: Optional[int],
                        pages_out: Optional[int] = None) -> None:
        """Persist this run's observed stats: the settled capacity
        bucket, plus per-operator output cardinalities when the stats
        accounting ran (tracing or EXPLAIN ANALYZE)."""
        prof: Dict = {"capacity_boost": self._capacity_boost}
        if rows_out is not None:
            prof["rows_out"] = int(rows_out)
        if pages_out is not None:
            prof["pages_out"] = int(pages_out)
        stats = self._collect_stats
        if stats:
            resolve_row_counts(stats)
            ops: Dict[str, int] = {}
            for st in stats.values():
                if isinstance(st, NodeStats):
                    ops[st.label] = ops.get(st.label, 0) + st.rows
            prof["operator_rows"] = ops
        self.profile_store.record(key, prof)

    def _plan_check_on(self) -> bool:
        pc = self.plan_check
        if pc in (True, "true", "on"):
            return True
        if pc in (False, "false", "off", 0):
            return False
        env = os.environ.get("PRESTO_TPU_PLAN_CHECK", "").lower()
        if env in ("0", "false", "off"):
            return False  # explicit operator opt-out wins over auto
        # only an explicit opt-IN enables outside pytest: a mistyped
        # value must not force the verifier onto the serving path
        return bool(os.environ.get("PYTEST_CURRENT_TEST")
                    or env in ("1", "true", "on"))

    def _verify_plan(self, node: P.PhysicalNode) -> None:
        """Run the pre-launch plan verifier when enabled. A clean
        verdict is memoized per (plan object, sizing knobs): retry
        ladders and repeated executions of one plan re-verify nothing;
        the held references keep id() stable."""
        if not self._plan_check_on():
            return
        key = (id(node), self.device_memory_budget, self.page_rows)
        cache = getattr(self, "_plan_check_memo", None)
        if cache is None:
            cache = self._plan_check_memo = {}
        if key in cache:
            return
        from presto_tpu_torch.exec import plan_check as PC

        PC.verify(self, node)
        if len(cache) >= 16:
            cache.clear()
        cache[key] = node  # keep the ref so id() cannot be reused

    def _overflow_flagged(self) -> bool:
        """OR-reduce the attempt's deferred overflow flags — the ONE
        host sync of the deferred-sync discipline."""
        if not self._pending_overflow:
            return False
        return bool(torch.stack(
            [f.reshape(()) for f in self._pending_overflow]).any())

    def _begin_attempt(self) -> None:
        """Per-attempt reset shared by every attempt of the ladder:
        deferred flags, materialized intermediates (they may embed an
        overflow-truncated result), the unpublished result-cache streams
        (they may embed the overflow that forced this retry) and the
        per-attempt counters."""
        self._pending_overflow = []
        self._release_stream_cache()
        self._cache_pending = []
        self._cache_inflight = set()
        self.gathers_deferred = 0
        self.gathers_materialized = 0
        self.fused_partial_aggs = 0
        self.program_launches = 0
        self.splits_scanned = 0
        self.queries_per_launch = 0
        self.memory_chunked_pipelines = 0

    def stream_fragment(self, node: P.PhysicalNode, emit,
                        cancelled=lambda: False,
                        on_attempt=None) -> List:
        """Stream a plan's pages through ``emit`` under the query-scope
        ladder that execute() runs too — the worker task runtime spools
        results instead of materializing rows. Returns the emit()
        results of the last (overflow-free) attempt; a truncated page
        set never escapes because results publish only per completed
        attempt. ``on_attempt`` runs at the start of EVERY attempt, so a
        caller whose emit writes to a spool resets it there and a retry
        never double-publishes. The per-query setup is execute()'s:
        plan check, profile seed, transfer sink and gauges."""
        prof_key = self._begin_query(node)
        prev_sink = XF.swap_sink(self)
        try:
            out = self._ladder(node, emit, cancelled, on_attempt)
            if prof_key is not None:
                self._record_profile(prof_key, None, pages_out=len(out))
            return out
        finally:
            XF.swap_sink(prev_sink)
            self._end_query()

    def _ladder(self, node: P.PhysicalNode, emit,
                cancelled=lambda: False, on_attempt=None,
                parent_span=None, trace_ops: bool = False) -> List:
        """The overflow and device-OOM ladder of execute() and
        stream_fragment().

        Two kinds of retry: a capacity overflow re-runs at the next
        boost rung (at most _MAX_ATTEMPTS attempts); a device memory
        fault (exec/faults.py) re-runs under a halved device-memory
        budget, so the governor re-plans the attempt chunked, up to
        device_oom_attempts times. Before such a retry the failed
        attempt's memory goes back to the card: its pages, the program
        cache's captured graphs (their private pools) and the caching
        allocator's free blocks. Each attempt is an ``attempt`` span
        when traced."""
        oom_left = self.device_oom_attempts
        tr = self.trace
        try:
            attempts = 0
            while attempts < _MAX_ATTEMPTS:
                self._begin_attempt()
                if on_attempt is not None:
                    on_attempt()
                if self._collect_stats is not None:
                    self._collect_stats.clear()  # failed attempts' stats
                att_span = None
                if tr is not None:
                    att_span = tr.begin("attempt", f"a{attempts}",
                                        parent=parent_span,
                                        boost=self._capacity_boost)
                    self.trace_spans += 1
                faulted = False
                try:
                    out, done = self._run_attempt(node, emit, cancelled)
                except QueryDeadlineExceeded:
                    if tr is not None:
                        tr.end(att_span, outcome="deadline")
                    raise
                except Exception as e:  # noqa: BLE001 - the ladder gate
                    if tr is not None:
                        tr.end(att_span, outcome="device-fault")
                    oom_left = self._absorb_device_fault(e, oom_left)
                    faulted = True
                if faulted:
                    # outside the handler: the exception's frames (and
                    # the pages they hold) are gone by now
                    self._release_device_memory()
                    continue
                if done:
                    if tr is not None:
                        if trace_ops:
                            self._trace_operators(tr, att_span)
                        tr.end(att_span, outcome="ok", pages=len(out))
                    if not cancelled():
                        # only a completed overflow-free attempt's
                        # streams enter the result cache
                        self._publish_cache_pending()
                    return out
                if tr is not None:
                    tr.end(att_span, outcome="overflow")
                self._capacity_boost = SH.next_boost(self._capacity_boost)
                self.capacity_boost_retries += 1
                attempts += 1
            raise RuntimeError(
                f"capacity overflow persisted after {_MAX_ATTEMPTS} "
                "attempts")
        finally:
            self._release_stream_cache()

    def _run_attempt(self, node, emit, cancelled):
        """One attempt of the ladder: (emit results, finished) —
        finished is False when a deferred overflow flag tripped."""
        self._maybe_inject_oom()
        out: List = []
        for page in self.pages(node):
            if cancelled():
                return out, True
            check_deadline(self.query_deadline, "in execution")
            out.append(emit(page))
        return out, not self._overflow_flagged()

    # ------------------------------------------- device-memory governor
    # floor for OOM-tightened budgets: the sizing math stays sane however
    # often the ladder halves; capped at the resolved budget, so an
    # explicit tiny budget is never raised
    _OOM_BUDGET_FLOOR = 1 << 20

    def _budget(self) -> int:
        """Resolved device-memory budget in bytes (membudget.py): an
        explicit device_memory_budget wins; auto = the card's memory
        minus headroom on CUDA, a generous cap on the CPU; a device-OOM
        retry halves it. Cached per (setting, tightening)."""
        key = (self.device_memory_budget, self._oom_divisor)
        if self._budget_resolved is None or self._budget_resolved[0] != key:
            resolved = MB.resolve_budget(self.device_memory_budget,
                                         self.device)
            floor = min(resolved, self._OOM_BUDGET_FLOOR)
            self._budget_resolved = (
                key, max(resolved // self._oom_divisor, floor))
        return self._budget_resolved[1]

    def _tighten_budget(self) -> None:
        """Halve the resolved budget for the next attempt (the device
        itself just proved the model optimistic)."""
        self._oom_divisor = min(self._oom_divisor * 2, 1 << 10)

    def _absorb_device_fault(self, e: BaseException, oom_left: int) -> int:
        """The ladder's gate: absorb a device memory fault by tightening
        the budget and return the decremented retry budget; re-raise
        anything else, or anything once the budget is spent."""
        if oom_left <= 0 or not FAULTS.is_device_fault(e):
            raise e
        self.device_oom_retries += 1
        self.device_oom_faults.append(type(e))
        self._tighten_budget()
        return oom_left - 1

    def _release_device_memory(self) -> None:
        """Return a failed attempt's memory before the retry. On CUDA the
        caching allocator keeps freed blocks and each captured graph
        keeps a private pool, and both outlive the attempt: without this
        the retry at a halved budget meets the same full card.

        Only this query's captured programs go (the reference's fault
        gate tightens the budget and keeps every compiled program);
        other queries' programs survive one query's fault. Then, on
        CUDA, while the card's free memory is still short of the
        retry's budget, the least recently used programs of the cache
        go one at a time. Every released key is appended to
        ``programs_released``."""
        gc.collect()
        released = graphs.release(self._query_programs)
        self._query_programs = set()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            need = self._budget()
            while torch.cuda.mem_get_info(self.device)[0] < need:
                key = graphs.release_lru()
                if key is None:
                    break
                released.append(key)
                torch.cuda.empty_cache()
        self.programs_released.extend(released)

    def _maybe_inject_oom(self) -> None:
        """Fault-injection hook: the device allocator's failure mode, so
        the ladder runs where no card runs out of memory."""
        if self.inject_device_oom > 0:
            self.inject_device_oom -= 1
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: injected device OOM (fault hook)")

    def _governed_target_rows(self, types, count: bool = True,
                              row_bytes: Optional[int] = None) -> int:
        """Generation chunk (page) size for a scan of ``types``-typed
        columns: page_rows, shrunk so ONE page buffer fits its budget
        share. count=False lets the static audit ask without bumping the
        rewrite counter; row_bytes overrides the width (fused chains
        govern by their WIDEST row)."""
        cap = MB.rows_cap(row_bytes or _row_bytes(types), self._budget(),
                          MB.SCAN_SHARE_DIV)
        if cap is None or self.page_rows <= cap:
            return self.page_rows
        if count:
            self.memory_chunked_pipelines += 1
        return max(cap, SH.LADDER_MIN)

    def _join_parts(self, node: P.HashJoin, left_types, right_types,
                    est_build: Optional[int] = None,
                    row_b: Optional[int] = None):
        """Grace-partition pass count for a materialized join build: the
        session thresholds (spill_bytes, max_join_build_rows) and the
        governor's sizing — one pass's build must fit its budget
        share. Returns (parts, governed):
        governed means the MODEL forced more passes than the thresholds.
        Shared with the static audit (membudget.audit)."""
        if not (self._keys_partitionable(right_types, node.right_keys)
                and self._keys_partitionable(left_types, node.left_keys)):
            return 1, False
        if est_build is None:
            est_build = self.estimate_rows(node.right)
        if row_b is None:
            row_b = _row_bytes(right_types)
        parts = 1
        if self.spill_bytes is not None:
            parts = self._spill_partitions(est_build * row_b)
        if self.max_build_rows:
            parts = max(parts,
                        _next_pow2(-(-est_build // self.max_build_rows)))
        budget = self._budget()
        # est_build * 2: a grace pass sizes its build chunks with 2x
        # slack over the expected 1/parts occupancy, so the governed
        # caps must hold for the slacked buffer
        gparts = SH.parts_for(
            est_build * 2, row_b, rows_cap=None,
            bytes_cap=budget // MB.BUILD_SHARE_DIV if budget else None)
        return max(parts, gparts), gparts > parts

    def _account_page(self, page: Page) -> None:
        """Track the largest page footprint; past max_memory_bytes the
        query fails (reference: query.max-memory)."""
        size = page_bytes(page)
        self.peak_memory_bytes = max(self.peak_memory_bytes, size)
        if (self.max_memory_bytes is not None
                and size > self.max_memory_bytes):
            raise MemoryBudgetExceeded(
                f"page footprint {size} bytes exceeds query memory limit "
                f"{self.max_memory_bytes} (reference: "
                f"ExceededMemoryLimitException)")

    # ---------------------------------------------------------- exchange
    def _device_exchange_on(self) -> bool:
        """device_exchange_enabled: spooled-exchange pages partition on
        the device and spool as device Pages (dist/spool.
        device_partition_pages); auto = on a CUDA executor — the
        reference's "auto = on the accelerator"."""
        mode = self.device_exchange
        if mode in ("true", "false"):
            return mode == "true"
        return self.device.type == "cuda"

    def _pallas_exchange_on(self) -> bool:
        """K4, the partition-id kernel, behind pallas_join_enabled (the
        kernels switch): its hash is not splitmix64-compatible, and the
        session reaches every task payload, so every producer of one
        exchange resolves it alike."""
        return self.kernels

    def count_mesh_local(self) -> None:
        """One exchange edge task served from a same-process spool."""
        self.mesh_local_exchanges += 1

    def count_reattach(self) -> None:
        """One query carried across a coordinator restart
        (dist/checkpoint.reattach_query): the spooled fast path or the
        re-run-from-SQL rung."""
        self.coordinator_reattaches += 1

    def count_reattach_redispatch(self) -> None:
        """One dead persisted placement re-dispatched from its persisted
        payload during re-attach (dist/checkpoint._redispatch_dead)."""
        self.reattach_redispatches += 1

    def count_cache_invalidations(self, n: int) -> None:
        """The runner's write-path result-cache reclaim
        (runner._invalidate_caches) counts here, so every counter
        surface renders it."""
        self.result_cache_invalidations += n

    def count_warm_load(self, loaded: int, drops: int) -> None:
        """One warm-start pass's outcome (runner.apply_session drives
        it; the counters live here for EXPLAIN ANALYZE and /metrics)."""
        self.cache_warm_loads += loaded
        self.cache_manifest_drops += drops

    # the streaming plane's sinks: plain GIL-guarded adds, so a lost
    # increment under contention is a metric error, never a correctness
    # one (exec/xfer.py's stance)
    def count_ivm_refresh(self, full: bool = False) -> None:
        """streaming/ivm.refresh: one incremental refresh completed, or
        — ``full`` — one full-recompute fallback (a non-IVM-safe plan,
        or ivm_enabled off)."""
        if full:
            self.ivm_full_recomputes += 1
        else:
            self.ivm_refreshes += 1

    def count_delta_pages(self, n: int) -> None:
        """``n`` delta partial-state pages folded into persisted view
        state by one refresh (streaming/ivm.refresh)."""
        self.delta_pages_folded += n

    def count_cursor_poll(self) -> None:
        """One tailing /v1/statement cursor poll
        (server/http_server.TailCursor.poll)."""
        self.cursor_polls += 1

    def count_stream_append(self) -> None:
        """One append batch seen on an append-only stream connector:
        the runner's INSERT advance path and tail polls that saw the
        offset move."""
        self.stream_appends_seen += 1

    # --------------------------------------------------------- result cache
    def _select_cache_points(self, node: P.PhysicalNode) -> None:
        """Per-query cache-point selection (cache/rules.py): the maximal
        cacheable subtrees holding a materializing operator, gated by
        _cache_subtree_ok (the mesh allows only replicated subtrees).

        Keys are salted with the executor settings that change a
        successful subtree's output without appearing in the plan:
        collect_k bounds the collect aggregates and page_rows shapes the
        replayed page stream. The store is process-shared, so two
        sessions with different settings never address one entry. The
        kernel switch, fusion and batching knobs change no result and
        stay out of the key: a hit made with the kernels serves a run
        without them."""
        self._cache_points = {}
        if self.result_cache is None:
            return
        from presto_tpu_torch.cache.rules import (
            select_cache_points,
            stream_watermark,
        )

        salt = f"k{self.collect_k}.p{self.page_rows}"
        self._cache_points = {
            i: (f"{key}:{salt}", n, tables,
                stream_watermark(tables, self.catalogs), snap,
                # family keys carry the entry keys' salt: siblings under
                # other settings never answer each other
                (f"{fam[0]}:{salt}", fam[1]) if fam is not None else None)
            for i, (key, n, tables, snap, fam) in select_cache_points(
                node, self.catalogs, allow=self._cache_subtree_ok,
                subsumable=self.cache_subsumption).items()
        }

    def _cache_subtree_ok(self, node: P.PhysicalNode) -> bool:
        """Whether a subtree's page stream may become a cache point: the
        single-stream executor's pages are ordinary Pages, so every one
        may (the DistExecutor narrows to replicated subtrees)."""
        return True

    @staticmethod
    def _sink_chain_ids(node) -> frozenset:
        """ids of the nodes whose page streams reach result decode or
        emit untouched: the root plus its Output pass-through chain —
        where a host page can be served with no device consumer."""
        ids = {id(node)}
        while isinstance(node, P.Output):
            node = node.source
            ids.add(id(node))
        return frozenset(ids)

    def _cached_pages(self, node: P.PhysicalNode, entry) -> Iterator[Page]:
        """Serve one cache point: on a hit replay the stored host pages
        (no capture, no launch; one staging copy per page for a device
        consumer, none at the host sink); on a miss stream the real
        subtree (re-entering pages() through the inflight guard) while
        collecting, and stage the completed stream for publication once
        the attempt proves overflow-free. A stream abandoned downstream
        (a Limit stopped consuming) never reaches the staging append,
        so a partial page set is never published."""
        key, _node_ref, tables, watermark, snap, family = entry
        tr = self.trace
        t0 = tr.now() if tr is not None else 0.0
        host_pages = self.result_cache.get_pages(key)
        label = type(node).__name__
        if host_pages is not None:
            self.result_cache_hits += 1
            # replayed pages still pass the per-query accounting (the
            # memory limit holds whether a page came off the device or
            # out of the cache), and EXPLAIN ANALYZE shows the replay's
            # pages and rows on this node
            st = None
            if self._collect_stats is not None:
                st = self._collect_stats.setdefault(
                    id(node), NodeStats(label))
            serve_host = id(node) in self._host_sink_ids
            for hp in host_pages:
                dp = hp if serve_host else self._stage_replay(hp)
                self._account_page(dp)
                if st is not None:
                    st.pages += 1
                    st.row_counts.append(
                        int(XF.np_host(dp.valid, label="cache-replay")
                            .sum()) if serve_host else dp.num_rows())
                yield dp
            if tr is not None:
                tr.complete("cache", f"hit:{label}", t0, tr.now(),
                            pages=len(host_pages), key=key)
                self.trace_spans += 1
            return
        if family is not None:
            # subsumption rewrite: a cached SIBLING whose filter
            # descriptor CONTAINS this one answers by replaying its
            # (wider) pages through this node's own predicate — a
            # residual filter over cached pages instead of a rescan
            sib = self.result_cache.probe_family(family[0], family[1])
            wider = (self.result_cache.get_pages(sib[0])
                     if sib is not None else None)
            if wider is not None:
                self.result_cache_hits += 1
                self.cache_subsumed_hits += 1
                self.result_cache.count_subsumed()
                if tr is not None:
                    tr.complete("cache", f"subsume:{label}", t0,
                                tr.now(), key=key, wider=sib[0])
                    self.trace_spans += 1
                # the wider pages enter UNDER this Filter through the
                # RemoteSource supplier path (the exchange plane's
                # ingest), and the node's own predicate runs over them
                skey = f"subsume:{id(node)}"
                rs = P.RemoteSource(
                    types=tuple(self.output_types(node.source)),
                    key=skey, origin=node.source)
                synthetic = dataclasses.replace(node, source=rs)
                self.remote_sources[skey] = (
                    lambda pages=wider: iter(pages))
                collected: List = []
                try:
                    for page in self.pages(synthetic):
                        collected.append(page)
                        yield page
                finally:
                    self.remote_sources.pop(skey, None)
                # the narrow result publishes under its EXACT key, so the
                # next identical query hits without the rewrite
                self._cache_pending.append(
                    (key, collected, tables, watermark, snap, family))
                return
        self.result_cache_misses += 1
        if tr is not None:
            tr.complete("cache", f"miss:{label}", t0, tr.now(), key=key)
            self.trace_spans += 1
        self._cache_inflight.add(id(node))
        try:
            collected = []
            for page in self.pages(node):
                collected.append(page)
                yield page
        finally:
            self._cache_inflight.discard(id(node))
        self._cache_pending.append(
            (key, collected, tables, watermark, snap, family))

    def _stage_replay(self, page: Page) -> Page:
        """Stage one replayed host page for a device consumer."""
        return XF.to_device(page, self.device, label="cache-replay")

    def _publish_cache_pending(self) -> None:
        """Publish the attempt's completed cache streams — once per
        SUCCESSFUL (overflow-free) attempt, where the engine syncs
        anyway, so the store's per-page d2h reads stay off the
        deferred-sync hot path."""
        pending, self._cache_pending = self._cache_pending, []
        cache = self.result_cache
        if cache is None:
            return
        for key, pages, tables, watermark, snap, family in pending:
            self.result_cache_evictions += cache.put_pages(
                key, pages, tables, watermark=watermark, snap=snap,
                family=family)

    # ------------------------------------------------------ fused pipelines
    def _scan_chain(self, node: P.PhysicalNode, *, through_joins: bool):
        """Walk a Filter/Project/Exchange chain (and, when through_joins,
        generated-join-eligible HashJoins) down to its TableScan: the one
        chain walker of the generated-join check and _fused_stream.
        Returns (scan, chain top-down) with HashJoins as (node,
        info) pairs, or None when a node breaks the chain."""
        chain: List = []
        cur = node
        while True:
            if isinstance(cur, (P.Filter, P.Exchange, P.Project)):
                chain.append(cur)
                cur = cur.source
            elif through_joins and isinstance(cur, P.HashJoin):
                info = self._generated_join_info(
                    cur, self.output_types(cur.left))
                if info is None:
                    return None
                chain.append((cur, info))
                cur = cur.left
            elif isinstance(cur, P.TableScan):
                return cur, chain
            else:
                return None

    def _generators(self, node: P.PhysicalNode) -> tuple:
        """The object behind the generator of every scan under ``node``:
        a captured program embeds their constants (scale, row counts),
        so they are part of its key. A connector wrapper (a task's split
        filter) resolves to the generator it wraps, so every task of a
        fragment shares one program."""
        out = []
        todo = [node]
        while todo:
            n = todo.pop()
            if isinstance(n, P.TableScan):
                conn = self.catalogs[n.catalog]
                out.append(getattr(conn.gen_body, "__self__", conn))
            todo.extend(n.children())
        return tuple(out)

    def _fused_stream(self, node: P.PhysicalNode, agg_tail=None,
                      key_extra=None) -> Optional[Iterator[Page]]:
        """Whole-pipeline fusion: when ``node`` is a chain of Filter /
        Project / Exchange / build-free generated joins over a TableScan
        of an on-device generator, run the ENTIRE per-split pipeline —
        generation included — as ONE program per split (exec/graphs.py:
        a captured CUDA graph on the card) and stream its outputs. None
        when the subtree has a node that does not fuse.

        ``agg_tail`` extends the fusion through partial aggregation
        (_fused_partial_tail): a ("map", fn, None) tail appends a page
        transform (global partial states), an ("aggflag", fn, merge) tail
        a grouped partial step whose overflow flag joins the deferred
        ladder; ``merge`` folds states inside a batched program.
        ``key_extra`` adds the caller's boost-dependent parameters to
        the program key.

        Split batching (split_batch_size) runs batches of B splits as
        one program: a page-emitting chain generates the B splits flat
        ([B * n_pad] rows, chunk b at [b * n_pad, (b + 1) * n_pad) —
        the reference's vmapped stack, already merged) and emits them as
        one page; an aggregation tail runs the splits one after another
        inside the program and folds their states, as the reference's
        lax.scan does. Tail batches pad with zero row counts.

        A single-split launch offers itself to the concurrent server's
        cross-query LaunchBatcher first (server/launch_batcher.py).

        A chain member that is a live result-cache point stays a
        pages() boundary: fusing through it would bypass the cache (no
        hit, no population), and the put's host read may not run inside
        a captured program. An INFLIGHT point is its own miss-path
        collection, where fusion is what we want.

        Reference: presto_tpu/exec/executor.py _fused_stream;
        operator/ScanFilterAndProjectOperator.java fuses scan, filter
        and project for the same reason."""
        if not self.offload:
            return None
        walked = self._scan_chain(node, through_joins=True)
        if walked is None:
            return None
        cur, chain = walked
        if self._cache_points:
            for link in chain + [cur]:
                n = link[0] if isinstance(link, tuple) else link
                if id(n) in self._cache_points and \
                        id(n) not in self._cache_inflight:
                    return None
        if not chain and agg_tail is None:
            return None  # a bare scan is no pipeline
        conn = self.catalogs[cur.catalog]
        # fuse only where pages() is exactly the base per-split
        # generation loop (or a wrapper declares its own is)
        base_pages = (
            getattr(type(conn), "pages", None) is Connector.pages
            or getattr(type(conn), "fused_scan_ok", False)
        )
        if not base_pages or "pages" in vars(conn):
            return None
        names = tuple(cur.columns)
        if conn.gen_body(cur.table, 8, names) is None:
            return None
        schema = conn.table_schema(cur.table)
        scan_types = tuple(schema.column_type(c) for c in names)
        dicts = getattr(conn, "_dicts", {}).get(cur.table, {})
        scan_dicts = tuple(dicts.get(c) for c in names)
        # generation-chunked splits (membudget.py): one split's padded
        # buffer fits its budget share AT THE CHAIN'S WIDEST ROW — a
        # generated-join chain emits left+right columns per slot
        chain_row_b = max(_row_bytes(scan_types),
                          _row_bytes(self.output_types(node)))
        splits = conn.splits(
            cur.table,
            self._governed_target_rows(scan_types, row_bytes=chain_row_b))
        if cur.constraint:
            splits = conn.prune_splits(cur.table, splits, cur.constraint)

        # bottom-up list of page transforms (top-down in ``chain``)
        steps: List = []
        for nd in reversed(chain):
            if isinstance(nd, tuple):
                jnode, info = nd
                kern, windowed = self.generated_join_kernel(jnode, info)
                # a windowed join's multi-match flag joins the deferred
                # overflow ladder like an aggregation tail's
                steps.append(("flag" if windowed else "map", kern))
                self.generated_joins_used += 1
            else:
                fn = _node_replay_fn(nd)
                if fn is not None:
                    steps.append(("map", fn))
        batch_merge = None
        if agg_tail is not None:
            kind, fn, batch_merge = agg_tail
            steps.append((kind, fn))
            self.fused_partial_aggs += 1

        def make_page(datas, valid, n_pad, counts):
            # canonical split shape: generation pads to the ladder bucket
            # and rows past each split's real count mask out here
            rows = torch.arange(n_pad, dtype=torch.int64, device=valid.device)
            in_range = (rows[None, :] < counts[:, None]).reshape(-1)
            return Page(blocks=tuple(
                Block(data=d, type=t, nulls=None, dictionary=dic)
                for d, t, dic in zip(datas, scan_types, scan_dicts)
            ), valid=valid & in_range)

        def apply_steps(page, use_steps):
            flags = []
            for kind, fn in use_steps:
                if kind in ("flag", "aggflag"):
                    page, flag = fn(page)
                    flags.append(flag)
                else:
                    page = fn(page)
            return page, tuple(flags)

        def run_split(gen_fn, n_pad, start, count, use_steps):
            datas, valid = gen_fn(start)
            return apply_steps(make_page(datas, valid, n_pad, count),
                               use_steps)

        def or_flags(flags):
            out = torch.zeros((), dtype=torch.bool, device=self.device)
            for f in flags:
                out = out | f
            return out

        programs: Dict = {}

        def program(kind, n_pad, batch, build):
            key = (kind, n_pad, batch)
            if key not in programs:
                gkey = (kind, node, key_extra, cur.table, n_pad, batch,
                        self.device, self.kernels, self._generators(node))
                self._query_programs.add(gkey)
                programs[key] = graphs.program(gkey, build, batch,
                                               self.device)
            return programs[key]

        # cross-query launch batching: with a LaunchBatcher attached
        # (the concurrent server) and the session not forcing it off, a
        # single-split launch first offers itself to the shared batch
        # point, where compatible launches of OTHER queries (equal plan
        # nodes hash equal, so one statement from many clients shares a
        # key) gang into one batched program
        xq_on = (self.launch_batcher is not None
                 and self.cross_query_batching != "false")

        def xq_key(n_pad):
            return ("xq", node, key_extra, cur.table, n_pad, self.device,
                    self.kernels, self._generators(node))

        def build_xq(n_pad, width):
            # the shared batched program: the slots generate flat (slot b
            # at rows [b * n_pad, (b + 1) * n_pad)), then the chain runs
            # per slot and the program returns one (page, flags) per
            # slot, so each query gets exactly the page its solo launch
            # makes
            def build():
                gen_b = conn.gen_batch(cur.table, n_pad, names)

                def run_xq(starts, counts):
                    datas, valid = gen_b(starts)
                    outs = []
                    for b in range(width):
                        rows = slice(b * n_pad, (b + 1) * n_pad)
                        outs.append(apply_steps(make_page(
                            tuple(d[rows] for d in datas), valid[rows],
                            n_pad, counts[b:b + 1]), steps))
                    return tuple(outs)

                return run_xq

            return build

        def launch_xq(split):
            """Offer one split to the cross-query batch point; the page,
            or None when this query's solo launch should run (a lone
            leader, an oversized bucket, or a failed shared launch)."""
            n_pad = SH.bucket(split.row_count)
            cap = min(SH.SPLIT_BATCH_MAX,
                      SH.SPLIT_BATCH_ROWS_MAX // max(n_pad, 1))
            if cap < 2:
                return None

            def make_batched(entries):
                # keyed by the exact width (the batcher quantizes it down
                # its DISPATCH_WIDTHS ladder), so no lane is dead work
                width = len(entries)
                try:
                    out = program("xq_batch", n_pad, width,
                                  build_xq(n_pad, width))(
                        [e[0] for e in entries], [e[1] for e in entries])
                except Exception:
                    # every participant runs its solo launch instead
                    self.split_batch_fallbacks += 1
                    raise
                return list(out)

            res = self.launch_batcher.submit(
                xq_key(n_pad), split.start_row, split.row_count, cap,
                self.cross_query_batch_wait_ms, make_batched)
            if res is None:
                return None
            page, flags, width, waited_ms, leader = res
            if leader:
                # one launch covers every ganged query: only the leader
                # counts it, so summed program_launches are real launches
                self.program_launches += 1
                self.cross_query_batches += 1
            self.cross_query_batched_queries += 1
            self.queries_per_launch = max(self.queries_per_launch, width)
            self.batch_gather_wait_ms += int(waited_ms)
            self.splits_scanned += 1
            # this query's slot of the batched generation
            self.peak_memory_bytes = max(self.peak_memory_bytes,
                                         n_pad * chain_row_b)
            self._pending_overflow.extend(flags)
            return page

        def launch_one(split):
            n_pad = SH.bucket(split.row_count)
            solo = contextlib.nullcontext()
            if xq_on:
                page = launch_xq(split)
                if page is not None:
                    return page
                # a solo launch still seeds the train: same-key arrivals
                # linger behind it as behind a batched step
                solo = self.launch_batcher.solo_inflight(xq_key(n_pad))

            def build():
                gen_fn = conn.gen_body(cur.table, n_pad, names)
                return lambda starts, counts: run_split(
                    gen_fn, n_pad, starts[0], counts[:1], steps)

            with solo:
                page, flags = program("fused", n_pad, 1, build)(
                    [split.start_row], [split.row_count])
            # the generation buffer lives inside the program and never
            # passes _account_page: account it here
            self.peak_memory_bytes = max(self.peak_memory_bytes,
                                         n_pad * chain_row_b)
            self.program_launches += 1
            self.splits_scanned += 1
            self._pending_overflow.extend(flags)
            return page

        live = [s for s in splits if s.row_count]

        def stream_single():
            for split in live:
                yield launch_one(split)

        bmax = 0
        if len(live) > 1:
            n_pad_all = max(SH.bucket(s.row_count) for s in live)
            bmax = self._split_batch_max(n_pad_all,
                                         scanned=agg_tail is not None,
                                         row_bytes=chain_row_b)
        if bmax < 2:
            return stream_single()

        def build_batch():
            if agg_tail is None:
                # page-emitting chain: every step is row-wise, so the
                # chain over the flat batch IS the concat of the
                # per-split pages
                gen_b = conn.gen_batch(cur.table, n_pad_all, names)

                def run_batch(starts, counts):
                    datas, valid = gen_b(starts)
                    return apply_steps(
                        make_page(datas, valid, n_pad_all, counts), steps)

                return run_batch
            gen_fn = conn.gen_body(cur.table, n_pad_all, names)
            if steps[-1][0] == "map":
                # global partial-agg tail: one state row per split,
                # stacked — exactly the per-split states' concat; a
                # windowed join's flags OR into one per batch
                def run_batch(starts, counts):
                    outs = [
                        run_split(gen_fn, n_pad_all, starts[b],
                                  counts[b:b + 1], steps)
                        for b in range(starts.shape[0])]
                    flags = [f for _st, fl in outs for f in fl]
                    states = concat_all([st for st, _fl in outs])
                    return states, (or_flags(flags),) if flags else ()

                return run_batch
            # grouped partial-agg tail: the splits run in turn and fold
            # into one merge-capacity state page (the host _FoldBuffer's
            # merge, inside the program); every overflow ORs into one
            # deferred flag per batch
            pre, tail_fn = steps[:-1], steps[-1][1]

            def one_state(start, count):
                page, flags = run_split(gen_fn, n_pad_all, start, count,
                                        pre)
                st, ovf = tail_fn(page)
                return st, or_flags(flags) | ovf

            def run_batch(starts, counts):
                # split 0 seeds the fold (merged alone into the merge
                # capacity, so every step sees one state shape)
                st, ovf = one_state(starts[0], counts[:1])
                acc, m = batch_merge(st)
                ovf = ovf | m
                for b in range(1, starts.shape[0]):
                    st, f = one_state(starts[b], counts[b:b + 1])
                    acc, m = batch_merge(concat_all([acc, st]))
                    ovf = ovf | f | m
                return acc, (ovf,)

            return run_batch

        def stream_batched():
            i = 0
            while i < len(live):
                chunk = live[i:i + bmax]
                if len(chunk) == 1:
                    # a lone tail split reuses the per-split program
                    # instead of padding a 2-batch
                    yield launch_one(chunk[0])
                    i += 1
                    continue
                B = SH.split_batch_bucket(len(chunk))
                pad = [0] * (B - len(chunk))
                page, flags = program("fused_batch", n_pad_all, B,
                                      build_batch)(
                    [s.start_row for s in chunk] + pad,
                    [s.row_count for s in chunk] + pad)
                self.program_launches += 1
                self.splits_scanned += len(chunk)
                self._pending_overflow.extend(flags)
                # a page-emitting batch generates B splits at once; an
                # aggregation tail one split at a time
                live_rows = (n_pad_all if agg_tail is not None
                             else B * n_pad_all)
                self.peak_memory_bytes = max(self.peak_memory_bytes,
                                             live_rows * chain_row_b)
                yield page
                i += len(chunk)

        return stream_batched()

    def _fused_partial_tail(self, node: P.Aggregation, layouts,
                            cap: Optional[int], max_iters: Optional[int]):
        """The partial-aggregation tail step for _fused_stream — a
        (kind, fn, batch_merge) triple — or None when the shape should
        not fuse. Global aggregations always qualify; grouped ones
        unless a big group capacity meets a join in the chain (there the
        join-output compaction stream, _agg_source_pages, wins). The
        fused tail does exactly the per-page work of the unfused loop;
        ``batch_merge`` is the state merge a batched program folds
        with."""
        mode = self.agg_fusion
        if not self.offload or mode == "false":
            return None
        if mode == "auto" and self.device.type != "cuda":
            return None
        layouts_t = tuple(tuple(lay) for lay in layouts)
        if not node.group_channels:
            self._count_agg_kernel()
            return ("map", functools.partial(
                _partial_global_agg, node.aggregates, layouts_t,
                kernels=self.kernels), None)
        if cap is None:
            return None
        if (node.capacity > A.MATMUL_AGG_MAX_GROUPS
                and _subtree_has_join(node.source)):
            return None
        self._count_agg_kernel()
        raw = functools.partial(_partial_agg_page, node.group_channels,
                                node.aggregates, layouts_t,
                                kernels=self.kernels,
                                collect_k=self._collect_k_eff)
        merge_raw = functools.partial(_merge_partials_page, node.aggregates,
                                      layouts_t, len(node.group_channels),
                                      collect_k=self._collect_k_eff)
        return (
            "aggflag",
            functools.partial(_fused_agg_step, raw, cap, max_iters),
            functools.partial(_fused_merge_step, merge_raw, cap, max_iters),
        )

    def _split_batch_max(self, n_pad: int, scanned: bool,
                         row_bytes: int = 0) -> int:
        """Max splits per batched launch of one fused stream, or 0 when
        split batching is off. "auto" is on when the executor runs on a
        CUDA device; an int forces that max on any device. A page-
        emitting batch (scanned=False) materializes B * n_pad rows at
        once and keeps them under SPLIT_BATCH_ROWS_MAX and, governed, its
        [B * n_pad] buffer within the scan budget share; an aggregation
        tail runs one split at a time and is exempt. Floored to a power
        of two, so full batches share one program and only the tail
        batch pads."""
        mode = self.split_batch
        if mode in (0, "false", None) or not self.offload:
            return 0
        if mode == "auto":
            if self.device.type != "cuda":
                return 0
            cap = SH.SPLIT_BATCH_MAX
        else:
            cap = int(mode)
        if not scanned and n_pad > 0:
            cap = min(cap, SH.SPLIT_BATCH_ROWS_MAX // n_pad)
            budget = self._budget()
            if budget and row_bytes:
                cap = min(cap, max((budget // MB.SCAN_SHARE_DIV)
                                   // (n_pad * row_bytes), 1))
        if cap < 2:
            return 0
        return 1 << (cap.bit_length() - 1)

    # --------------------------------------------------------- aggregation
    def _agg_in_types(self, node: P.Aggregation) -> List[Optional[T.SqlType]]:
        src = self.output_types(node.source)
        return [None if s.channel is None else src[s.channel]
                for s in node.aggregates]

    def _partial_origin(self, node: P.Aggregation) -> P.Aggregation:
        """The partial-step aggregation feeding a final-step one."""
        src = node.source
        while isinstance(src, P.Exchange):
            src = src.source
        if isinstance(src, P.RemoteSource) and src.origin is not None:
            src = src.origin
        if not (isinstance(src, P.Aggregation) and src.step == "partial"):
            raise TypeError(
                "final-step aggregation must consume a partial-step one")
        return src

    @property
    def _collect_k_eff(self) -> int:
        """Collect-state slots per group this attempt: the session bound
        scaled by the capacity boost, so a group past
        array_agg_max_elements takes the same boosted-retry ladder as
        every other capacity."""
        return self.collect_k * self._capacity_boost

    def _agg_extra_types(self, node: P.Aggregation):
        """Per-aggregate extra input types (map_agg's value column)."""
        src = self.output_types(node.source)
        return tuple(tuple(src[c] for c in spec.extra_channels)
                     for spec in node.aggregates)

    def _layouts(self, node: P.Aggregation, in_types):
        return tuple(
            tuple(S.state_layout(s.function, t))
            for s, t in zip(node.aggregates, in_types)
        )

    def _exec_aggregation(self, node: P.Aggregation) -> Iterator[Page]:
        if node.step == "final":
            yield from self._exec_agg_final(node)
            return
        in_types = self._agg_in_types(node)
        layouts = self._layouts(node, in_types)
        if node.step == "partial":
            # a shipped worker fragment's leaf: generation through the
            # partial step as one program per split when the source fuses
            pcap = _next_pow2(node.capacity * self._capacity_boost)
            tail = self._fused_partial_tail(node, layouts, pcap,
                                            64 * self._capacity_boost)
            fused = None if tail is None else self._fused_stream(
                node.source, agg_tail=tail,
                key_extra=("partial", node.group_channels, node.aggregates,
                           pcap, 64 * self._capacity_boost,
                           self._collect_k_eff))
            if fused is not None:
                yield from fused
                return
        if not node.group_channels:
            tail = (None if node.step == "partial" else
                    self._fused_partial_tail(node, layouts, None, None))
            fused = None if tail is None else self._fused_stream(
                node.source, agg_tail=tail,
                key_extra=("global", node.aggregates, layouts))
            if fused is None:
                self._count_agg_kernel()
            partials = list(fused) if fused is not None else [
                _partial_global_agg(node.aggregates, layouts, p,
                                    kernels=self.kernels)
                for p in self.pages(node.source)
            ]
            if node.step == "partial":
                yield from partials
                return
            merged = (concat_all(partials) if partials
                      else _empty_state_page(node.aggregates, layouts,
                                             self.device,
                                             self._collect_k_eff))
            yield _final_global_agg(node.aggregates, layouts, in_types,
                                    merged)
            return

        can_partition = node.step == "single" and self._keys_partitionable(
            self.output_types(node.source), node.group_channels)
        if can_partition:
            parts = self._agg_parts(node, in_types)
            if parts > 1:
                yield from self._exec_agg_partitioned(node, parts, in_types,
                                                      layouts)
                return

        cap = _next_pow2(node.capacity * self._capacity_boost)
        # optimistic clamp: the planner's capacity estimate has no
        # selectivity model; start tight and let the boost ladder grow it
        if self.agg_optimistic_rows and node.step == "single":
            cap = min(cap, _next_pow2(
                self.agg_optimistic_rows * self._capacity_boost))
        # boosted retries also deepen the hash-probe iteration budget
        max_iters = 64 * self._capacity_boost

        partial_fn, merge_fn, final_fn = self._agg_fns(node, layouts,
                                                       in_types)

        def partial(page):
            # distinct groups <= rows: clip the capacity to the page
            out, overflow = partial_fn(
                page, min(cap, _next_pow2(page.capacity)), max_iters)
            self._pending_overflow.append(overflow)
            return out

        if node.step == "partial":
            for page in self.pages(node.source):
                yield partial(page)
            return

        # incremental fold: partial pages merge into one bounded state
        # page instead of one giant concat
        fold_cap = min(cap, _next_pow2((1 << 20) * self._capacity_boost))
        fold = _FoldBuffer(self, merge_fn, fold_cap, max_iters,
                           2 * fold_cap)
        # scan -> filter -> project -> partial agg as ONE program per
        # split when the source chain fuses; its state pages feed the
        # same fold
        tail = self._fused_partial_tail(node, layouts, cap, max_iters)
        fused = None if tail is None else self._fused_stream(
            node.source, agg_tail=tail,
            key_extra=("single", node.group_channels, node.aggregates, cap,
                       max_iters, self._collect_k_eff))
        if fused is not None:
            for out in fused:
                fold.add(out)
        else:
            for page in self._agg_source_pages(node):
                fold.add(partial(page))
        merged = fold.final_merged()
        if merged is None:
            return
        fcap = min(_next_pow2(node.capacity * self._capacity_boost),
                   _next_pow2(merged.capacity))
        out, overflow = final_fn(merged, fcap, max_iters)
        self._pending_overflow.append(overflow)
        yield out

    # ------------------------------------------------ the IVM plane
    def ivm_delta_states(self, partial_node: P.Aggregation) -> List:
        """Run a view's partial-step aggregation over the delta window
        (this executor's catalogs hold the pinned StreamWindowConnector)
        and return HOST copies of its partial-state pages: the O(new
        rows) half of an incremental refresh (streaming/ivm.py). It
        rides stream_fragment's overflow and device-OOM ladder, and its
        partial step reaches K1 (_partial_agg_page with the kernels on)
        as a cold run's does."""
        return self.stream_fragment(
            partial_node, emit=lambda p: XF.to_host(p, label="ivm-delta"))

    def ivm_fold_finalize(self, node: P.Aggregation, state_pages,
                          cap_hint: Optional[int] = None):
        """Merge partial-state pages (host pages: the persisted settled
        state plus this refresh's delta states) into ONE settled state
        and finalize it — the other half of a refresh. The merge and
        final steps are the single-step aggregation's
        (_merge_partials_page, _final_agg_page) under a local boost
        ladder: an overflow re-stages and retries at the next rung.
        Returns ``(settled host state page, final host page)``; the
        settled state is pulled to the host before the final step, the
        reference's order (its final step donates the buffer; torch
        donates nothing, and the order costs nothing).

        ``cap_hint`` (the view's OBSERVED group count) sizes the state:
        the planner's capacity follows the LOG's row count and would
        pin an ever-growing state page, so the state compacts to the
        observed cardinality and real growth overflows onto the ladder."""
        if not state_pages:
            raise ValueError("ivm_fold_finalize needs >=1 state page")
        in_types = self._agg_in_types(node)
        layouts = self._layouts(node, in_types)
        nkeys = len(node.group_channels)
        boost = 1
        for _ in range(6):
            max_iters = 64 * boost
            collect_k = self.collect_k * boost
            staged = [XF.to_device(p, self.device, label="ivm-state")
                      for p in state_pages]
            merged = concat_all(staged) if len(staged) > 1 else staged[0]
            self._account_page(merged)
            cap = _next_pow2(max(cap_hint or node.capacity, 8) * boost)
            settled, ovf = _merge_partials_page(
                node.aggregates, layouts, nkeys, merged,
                min(cap, _next_pow2(merged.capacity)), max_iters,
                collect_k=collect_k)
            if bool(ovf):
                boost = SH.next_boost(boost)
                continue
            settled_host = XF.to_host(settled, label="ivm-state")
            final, ovf = _final_agg_page(
                node.group_channels, node.aggregates, layouts, in_types,
                settled, min(cap, _next_pow2(settled.capacity)),
                max_iters, collect_k=collect_k,
                extra_types=self._agg_extra_types(node))
            if bool(ovf):
                boost = SH.next_boost(boost)
                continue
            return settled_host, XF.to_host(final, label="ivm-final")
        raise RuntimeError(
            "IVM state fold overflow persisted after 6 boosted retries")

    def _agg_parts(self, node: P.Aggregation, in_types) -> int:
        """Hash-partition pass count of a grouped single-step
        aggregation: the spill threshold's, or the governor's when the
        merged state cannot fit its budget share."""
        src_types = self.output_types(node.source)
        est_rows = self.estimate_rows(node.source)
        # boost-scaled: a fold-overflow retry must eventually cross into
        # the partitioned path, the single path's only escape
        cap_est = _next_pow2(max(node.capacity, 8) * self._capacity_boost)
        n_pages = max(-(-est_rows // max(self.page_rows, 1)), 1)
        state_types = [src_types[c] for c in node.group_channels]
        for spec, in_t in zip(node.aggregates, in_types):
            state_types.extend(
                st.type for st in S.state_layout(spec.function, in_t))
        merged_slots = min(est_rows, n_pages * cap_est)
        if self._capacity_boost > 1:
            # a boosted retry is evidence the estimates are low: stop an
            # under-estimated est_rows from capping the decision
            merged_slots = max(merged_slots, cap_est)
        state_row_b = _row_bytes(state_types)
        parts = 1
        if self.spill_bytes is not None:
            parts = self._spill_partitions(merged_slots * state_row_b)
        budget = self._budget()
        gparts = SH.parts_for(
            merged_slots, state_row_b, rows_cap=None,
            bytes_cap=budget // MB.BUILD_SHARE_DIV if budget else None)
        if gparts > parts:
            parts = gparts
            self.memory_chunked_pipelines += 1
        return parts

    def _agg_fns(self, node: P.Aggregation, layouts, in_types):
        """The (partial, merge, final) page functions of a grouped
        aggregation, each ``fn(page, cap, max_iters) -> (page, flag)``."""
        k = self._collect_k_eff
        self._count_agg_kernel()
        partial = functools.partial(
            _partial_agg_page, node.group_channels, node.aggregates, layouts,
            kernels=self.kernels, collect_k=k)
        merge = functools.partial(
            _merge_partials_page, node.aggregates, layouts,
            len(node.group_channels), collect_k=k)
        final = functools.partial(
            _final_agg_page, node.group_channels, node.aggregates, layouts,
            in_types, collect_k=k,
            extra_types=self._agg_extra_types(node))
        return partial, merge, final

    def _exec_agg_partitioned(self, node: P.Aggregation, parts: int,
                              in_types, layouts) -> Iterator[Page]:
        """Partition-wise grouped aggregation (the spill analog): group-
        key hash partitions keep per-partition state ~1/P of the one-shot
        size; partitions are disjoint, so the union of outputs is exact.
        Up to 32 partitions: ONE source pass folding into P accumulators
        (_exec_agg_partition_fold), unless that resident set exceeds the
        query memory limit; beyond, one pass per partition re-streaming
        the source (_source_stream) with an O(1/P) working set
        (reference: SpillableHashAggregationBuilder)."""
        if parts <= 32:
            cap_est = _next_pow2(node.capacity * self._capacity_boost)
            pcap_est = _next_pow2(max(cap_est // parts * 2, 1024))
            src_types = self.output_types(node.source)
            state_types = [src_types[c] for c in node.group_channels]
            for layout in layouts:
                state_types.extend(st.type for st in layout)
            resident = 3 * parts * pcap_est * _row_bytes(state_types)
            if (self.max_memory_bytes is None
                    or resident <= self.max_memory_bytes):
                yield from self._exec_agg_partition_fold(
                    node, parts, in_types, layouts)
                return
        self.spill_partitions_used = max(self.spill_partitions_used, parts)
        pfilter = self._partition_filter(node.group_channels, parts)
        cap = _next_pow2(node.capacity * self._capacity_boost)
        pcap = SH.chunk_bucket(cap, parts)
        max_iters = 64 * self._capacity_boost
        partial_fn, merge_fn, final_fn = self._agg_fns(node, layouts,
                                                       in_types)
        src_stream = self._source_stream(node.source)
        for p in range(parts):
            # per-pass memory is O(pcap): partial pages fold into one
            # pcap-sized state page whenever they pile up
            fold = _FoldBuffer(self, merge_fn, pcap, max_iters, 4 * pcap)
            for page in src_stream():
                f = pfilter(page, p)
                out, overflow = partial_fn(
                    f, min(pcap, _next_pow2(page.capacity)), max_iters)
                self._pending_overflow.append(overflow)
                fold.add(out)
            if not fold.saw_input:
                return
            merged = fold.final_merged()
            fcap = min(pcap, _next_pow2(merged.capacity))
            out, overflow = final_fn(merged, fcap, max_iters)
            self._pending_overflow.append(overflow)
            yield out

    def _exec_agg_partition_fold(self, node: P.Aggregation, parts: int,
                                 in_types, layouts) -> Iterator[Page]:
        """Single-pass partitioned aggregation: every source page is
        partial-aggregated, split into P partitions by group-key hash of
        the PARTIAL page's keys, compacted, and folded into
        per-partition accumulators. Memory is O(P * pcap) with every
        buffer ~3 * pcap, while the source (often a join) streams once."""
        self.spill_partitions_used = max(self.spill_partitions_used, parts)
        nkeys = len(node.group_channels)
        # partial output pages carry the keys at channels 0..nkeys-1
        pfilter = self._partition_filter(tuple(range(nkeys)), parts)
        cap = _next_pow2(node.capacity * self._capacity_boost)
        pcap = SH.chunk_bucket(cap, parts)
        max_iters = 64 * self._capacity_boost
        partial_fn, merge_fn, final_fn = self._agg_fns(node, layouts,
                                                       in_types)
        folds = [_FoldBuffer(self, merge_fn, pcap, max_iters, 2 * pcap)
                 for _ in range(parts)]
        for page in self._agg_source_pages(node):
            out, overflow = partial_fn(
                page, min(cap, _next_pow2(page.capacity)), max_iters)
            self._pending_overflow.append(overflow)
            piece_cap = min(
                _next_pow2(max(out.capacity // parts * 2, 256)
                           * self._capacity_boost),
                _next_pow2(out.capacity))
            for p in range(parts):
                f = pfilter(out, p)
                self._pending_overflow.append(f.num_rows() > piece_cap)
                folds[p].add(compact_page(f, piece_cap))
        for fold in folds:
            merged = fold.final_merged()
            if merged is None:
                continue
            fcap = min(pcap, _next_pow2(merged.capacity))
            out, overflow = final_fn(merged, fcap, max_iters)
            self._pending_overflow.append(overflow)
            yield out

    def _exec_agg_final(self, node: P.Aggregation) -> Iterator[Page]:
        """Final step: merge partial-state pages."""
        origin = self._partial_origin(node)
        in_types = self._agg_in_types(origin)
        layouts = self._layouts(node, in_types)
        pages = list(self.pages(node.source))
        if not node.group_channels:
            merged = (concat_all(pages) if pages
                      else _empty_state_page(node.aggregates, layouts,
                                             self.device,
                                             self._collect_k_eff))
            yield _final_global_agg(node.aggregates, layouts, in_types,
                                    merged)
            return
        if not pages:
            return
        merged = concat_all(pages)
        fcap = min(_next_pow2(node.capacity * self._capacity_boost),
                   _next_pow2(merged.capacity))
        out, overflow = _final_agg_page(
            node.group_channels, node.aggregates, layouts, in_types, merged,
            fcap, 64 * self._capacity_boost,
            collect_k=self._collect_k_eff,
            extra_types=self._agg_extra_types(origin))
        self._pending_overflow.append(overflow)
        yield out

    def _agg_source_pages(self, node: P.Aggregation) -> Iterator[Page]:
        """Aggregation input, densified through a rolling compaction
        buffer when the source contains a join: join output pages keep
        probe capacity but are mostly invalid, and every sort/scatter of
        the blocking aggregation scales with slots, not valid rows. Rows
        beyond the accumulator flag overflow."""
        if (node.capacity <= A.MATMUL_AGG_MAX_GROUPS
                or not _subtree_has_join(node.source)):
            yield from self.pages(node.source)
            return
        # the group-count estimate is a lower bound on the stream's valid
        # rows: size the accumulator to cover it
        est = _next_pow2(max(node.capacity, 8))
        C = _next_pow2(max(self.agg_optimistic_rows or (1 << 18), est, 8192)
                       * self._capacity_boost)
        if C > (1 << 21):
            yield from self.pages(node.source)
            return
        acc = None
        for page in self.pages(node.source):
            if acc is None:
                acc, overflow = _compact_with_flag(page, C)
            else:
                acc, overflow = _merge_compact_flag(acc, page, C)
            self._pending_overflow.append(overflow)
        if acc is not None:
            yield acc

    # ------------------------------------------------ spill / partitions
    def estimate_rows(self, node: P.PhysicalNode) -> int:
        """Static (host-only) row-count estimate for spill planning, from
        connector row counts (no selectivity model, conservative)."""
        if isinstance(node, P.TableScan):
            return self.catalogs[node.catalog].row_count(node.table)
        if isinstance(node, P.Values):
            return len(node.rows)
        if isinstance(node, P.Limit):
            return min(node.count + node.offset,
                       self.estimate_rows(node.source))
        if isinstance(node, P.TopN):
            return min(node.limit, self.estimate_rows(node.source))
        if isinstance(node, P.Aggregation):
            if not node.group_channels:
                return 1
            return min(node.capacity, self.estimate_rows(node.source))
        if isinstance(node, P.HashJoin):
            left = self.estimate_rows(node.left)
            if node.join_type in ("semi", "anti"):
                return left
            return max(left, self.estimate_rows(node.right))
        if isinstance(node, P.CrossJoin):
            return self.estimate_rows(node.left) * max(
                self.estimate_rows(node.right), 1)
        if isinstance(node, P.Union):
            return sum(self.estimate_rows(s) for s in node.sources)
        if isinstance(node, P.GroupId):
            return self.estimate_rows(node.source) * len(node.set_masks)
        if isinstance(node, P.Unnest):
            return self.estimate_rows(node.source) * 4
        if isinstance(node, P.RemoteSource):
            # an observed exchange row count beats any static estimate;
            # else the producer's root, when it rides along
            if node.est_rows is not None:
                return max(int(node.est_rows), 1)
            if node.origin is not None:
                return self.estimate_rows(node.origin)
            return 1
        kids = node.children()
        return self.estimate_rows(kids[0]) if kids else 1

    def _partition_filter(self, keys, parts: int,
                          keep_nulls: bool = False):
        """Page transform keeping the rows whose key hash lands in
        partition p: ``fn(page, p)``. It partitions on the HIGH 32 bits
        of the 64-bit hash, because the group-by and join hash tables
        bucket on the low bits: low-bit partitions would cluster every
        pass's keys into cap/parts slots. keep_nulls routes null-key rows
        into EVERY pass: a semi/anti join needs the global "the build
        side holds a NULL" fact in each pass for NOT IN's three-valued
        logic."""

        def fn(page: Page, p: int) -> Page:
            blocks = [page.block(c) for c in keys]
            cols, nulls = K.block_key_columns(blocks)
            h = H.hash_columns(cols, nulls)
            keep = (u64.srl(h, 32) % parts) == p
            if keep_nulls:
                for b in blocks:
                    if b.nulls is not None:
                        keep = keep | b.nulls
            return Page(blocks=page.blocks, valid=page.valid & keep)

        return fn

    def _spill_partitions(self, est_bytes: int) -> int:
        if self.spill_bytes is None or est_bytes <= self.spill_bytes:
            return 1
        return min(_next_pow2(-(-est_bytes // self.spill_bytes)), 256)

    def _keys_partitionable(self, types, keys) -> bool:
        """Partition hashing is value-consistent only for non-dictionary
        columns (dictionary codes are page-local): string keys keep the
        operator single-pass."""
        return not any(T.is_string(types[c]) for c in keys)

    def _cheap_to_recompute(self, node: P.PhysicalNode) -> bool:
        """Whether re-executing this subtree per pass is acceptable: pure
        scan pipelines regenerate pages from row indices."""
        if isinstance(node, (P.TableScan, P.Values)):
            return True
        if isinstance(node, (P.Filter, P.Project, P.Exchange, P.Limit,
                             P.Output)):
            return self._cheap_to_recompute(node.source)
        if isinstance(node, P.Union):
            return all(self._cheap_to_recompute(s) for s in node.sources)
        return False

    def _source_stream(self, node: P.PhysicalNode):
        """A callable yielding a fresh page stream of ``node``, for
        operators that read a source once per partition pass. An
        expensive subtree materializes ONCE into a PageStore and
        restreams from it (reference: PagesIndex /
        FileSingleStreamSpiller): device-resident; in host RAM above
        host_spill_bytes; on disk above disk_spill_bytes; and, with no
        threshold crossed, governed — past half the budget to host RAM,
        past several budgets' worth to disk."""
        if self._cheap_to_recompute(node):
            return lambda: self.pages(node)
        # keyed by the (frozen, hashable) plan node: identical subtrees
        # share one materialization
        if node not in self._stream_cache:
            # estimate_rows is a heuristic: a wrong device-tier pick
            # costs device memory headroom, never correctness
            est = self.estimate_rows(node) * _row_bytes(
                self.output_types(node))
            budget = self._budget()
            store_share = budget // MB.STORE_SHARE_DIV if budget else None
            if (self.disk_spill_bytes is not None
                    and est > self.disk_spill_bytes):
                tier = "disk"
            elif (self.host_spill_bytes is not None
                    and est > self.host_spill_bytes):
                tier = "host"
            elif store_share is not None and est > store_share:
                tier = ("disk" if est > max(budget * 4, MB.CPU_BUDGET)
                        else "host")
                self.memory_chunked_pipelines += 1
            else:
                tier = "device"
            store = PageStore(tier, spill_dir=self.spill_path,
                              device=self.device)
            for page in self.pages(node):
                store.put(page)
            if tier == "host":
                self.host_spill_pages += store.page_count
                self.host_spill_bytes_used += store.bytes
            elif tier == "disk":
                self.disk_spill_pages += store.page_count
            self._stream_cache[node] = store
        return self._stream_cache[node].stream

    def _release_stream_cache(self) -> None:
        """Close every materialized intermediate (a disk-tier store's
        files go with it)."""
        for store in self._stream_cache.values():
            store.close()
        self._stream_cache = {}

    # ---------------------------------------------------------------- join
    def _exec_join(self, node: P.HashJoin) -> Iterator[Page]:
        """Page-level join execution: lazy (late-materialization) items
        produced along the probe spine materialize HERE, at the chain
        boundary — every deferred build column pays its one gather."""
        for item in self._exec_join_items(node):
            yield self._materialize_lazy(item)

    def _exec_join_items(self, node: P.HashJoin, want_lazy: bool = False):
        """Pages or latemat.LazyPage items of a join node. The
        single-pass sort-join paths defer build sides (inner/left joins)
        and consume the probe side through _lazy_pages, so chained joins
        compose row-id indirections; every other path (generated, the
        unique-key kernel, partitioned, semi/anti, right/full) yields
        Pages. want_lazy: the consumer is a lazy-aware parent join, so
        defer unconditionally; otherwise (the chain boundary) defer only
        when the probe items are lazy themselves."""
        left_types = self.output_types(node.left)
        right_types = self.output_types(node.right)
        gj = self._generated_join_info(node, left_types)
        if gj is not None:
            yield from self._exec_join_generated(node, gj)
            return
        # <=1 match per probe row when ANY build key scans a connector-
        # declared unique column: output capacities stay exact
        unique_build = any(
            P.scan_column_unique(node.right, k, self.catalogs)
            for k in node.right_keys
        )
        parts, governed = self._join_parts(node, left_types, right_types)
        if parts > 1:
            if governed:
                # the governor, not a session threshold, rewrote this
                # join into grace passes sized to fit
                self.memory_chunked_pipelines += 1
            yield from self._exec_join_partitioned(
                node, parts, left_types, right_types, unique_build)
            return
        build_pages = list(self.pages(node.right))
        if not build_pages:
            build_pages = [_empty_page(right_types, self.device)]
        build_all = concat_all(build_pages)
        # capacity-based sizing, not row count: no host read mid-query
        build = compact_page(build_all, _next_pow2(build_all.capacity))
        self._account_page(build)  # the query's largest materialization
        if self._unique_kernel_eligible(node, build, left_types,
                                        right_types):
            yield from self._unique_kernel_pass(node, build)
            return
        allow = self._late_mat_on() and node.join_type in ("inner", "left")
        probe_src = (self._lazy_pages(node.left) if allow
                     else self.pages(node.left))
        defer = "never"
        if allow:
            defer = "always" if want_lazy else "chain"
        yield from self._join_pass(node, build, probe_src, left_types,
                                   unique_build=unique_build, defer=defer)

    def _exec_join_partitioned(self, node: P.HashJoin, parts: int,
                               left_types, right_types,
                               unique_build: bool = False
                               ) -> Iterator[Page]:
        """Grace partition-wise join: P passes, each streaming both sides
        filtered to partition p of the key hash, so a pass's build is
        ~1/P of the single-pass one (and a build past the K3 range can
        fall back within it). A skewed partition raises the deferred
        overflow flag; on the boosted retry an inner join takes the
        rebalancing path instead of growing buffers: a hot key cannot be
        split by hash, so the hot partition's build rows chunk by
        POSITION into unboosted-size passes, each probed by the whole
        partition probe stream (every build row lives in exactly one
        chunk, so the output is the disjoint union)."""
        self.spill_partitions_used = max(self.spill_partitions_used, parts)
        semi = node.join_type in ("semi", "anti")
        bfilter = self._partition_filter(node.right_keys, parts,
                                         keep_nulls=semi)
        pfilter = self._partition_filter(node.left_keys, parts)
        right_stream = self._source_stream(node.right)
        left_stream = self._source_stream(node.left)
        rebalance = (self.join_skew_rebalance
                     and (self._capacity_boost > 1 or self.skew_preengaged)
                     and node.join_type == "inner")
        if rebalance and self._capacity_boost == 1:
            # adaptive pre-engagement: the upstream spool histogram
            # showed a hot partition, so the rebalanced chunking starts
            # now instead of being discovered by an overflow
            self.skew_preempted += 1
        for p in range(parts):
            if rebalance:
                yield from self._join_partition_rebalanced(
                    node, p, parts, bfilter, pfilter, right_stream,
                    left_stream, left_types, unique_build)
                continue
            build_pages = []
            for pg in right_stream():
                f = bfilter(pg, p)
                # compact each filtered build page to ~pg/parts before
                # the concat: this is where the memory shrinks
                pc = min(_next_pow2(max(pg.capacity // parts * 2, 1024)
                                    * self._capacity_boost),
                         _next_pow2(pg.capacity))
                self._pending_overflow.append(f.num_rows() > pc)
                build_pages.append(compact_page(f, pc))
            if not build_pages:
                build_pages = [_empty_page(right_types, self.device)]
            build_all = concat_all(build_pages)
            build = compact_page(build_all, _next_pow2(build_all.capacity))
            self._account_page(build)
            probe_pages = (pfilter(pg, p) for pg in left_stream())
            # partition-filtered probe pages are ~1/parts dense: output
            # capacities scale down with them (density)
            yield from self._join_pass(node, build, probe_pages,
                                       left_types,
                                       unique_build=unique_build,
                                       density=parts)

    def _join_partition_rebalanced(self, node: P.HashJoin, p: int,
                                   parts: int, bfilter, pfilter,
                                   right_stream, left_stream, left_types,
                                   unique_build: bool) -> Iterator[Page]:
        """One skew-rebalanced partition pass: exact per-page build counts
        (host reads, admissible on a retry), pieces packed greedily into
        chunks of at most the UNBOOSTED partition cap, oversized pieces
        split by position, one probe pass per chunk."""
        chunk_cap = 1024
        pieces: List[Page] = []
        for pg in right_stream():
            chunk_cap = max(chunk_cap,
                            min(SH.chunk_bucket(pg.capacity, parts),
                                _next_pow2(pg.capacity)))
            f = bfilter(pg, p)
            n = int(XF.np_host(f.num_rows(), label="skew-count"))
            if n:
                pieces.append(compact_page(f, _next_pow2(max(n, 256))))
        chunks: List[List[Page]] = [[]]
        room = chunk_cap
        for piece in pieces:
            rows = piece.capacity  # compacted: capacity ~ rows
            if rows > chunk_cap:
                for off in range(0, rows, chunk_cap):
                    chunks.append([slice_page(piece, off, chunk_cap)])
                # the split chunks are full: later pieces start afresh
                chunks.append([])
                room = chunk_cap
                continue
            if rows > room:
                chunks.append([])
                room = chunk_cap
            chunks[-1].append(piece)
            room -= rows
        chunks = [c for c in chunks if c]
        if not chunks:
            return  # an empty inner partition: no output
        self.skew_chunks_used = max(self.skew_chunks_used, len(chunks))
        for chunk in chunks:
            build_all = concat_all(chunk)
            build = compact_page(build_all, _next_pow2(build_all.capacity))
            self._account_page(build)
            probe_pages = (pfilter(pg, p) for pg in left_stream())
            yield from self._join_pass(node, build, probe_pages,
                                       left_types,
                                       unique_build=unique_build,
                                       density=parts)

    # ----------------------------------------------- late materialization
    def _late_mat_on(self) -> bool:
        """late_materialization_enabled: "auto" is on a CUDA executor
        (where the reference says "on TPU": gather bandwidth is the win);
        "true"/"false" (or True/False) are explicit."""
        mode = self.late_mat
        if mode in (False, None, "false", "off"):
            return False
        if mode == "auto":
            return self.device.type == "cuda"
        return True

    def _lazy_pages(self, node: P.PhysicalNode):
        """A join's probe-side stream: latemat.LazyPage items when the
        subtree is an eligible join-chain segment, Pages otherwise. A
        fused chain (generated joins) wins over laziness — it has no
        gathers to defer. Items bypass pages(), so each is accounted
        here."""
        if isinstance(node, P.HashJoin) and self._late_mat_on():
            fused = self._fused_stream(node)
            if fused is not None:
                for page in fused:
                    self._account_page(page)
                    yield page
                return
            for item in self._exec_join_items(node, want_lazy=True):
                self._account_page(item.reduced
                                   if isinstance(item, LM.LazyPage)
                                   else item)
                yield item
            return
        if (isinstance(node, P.Filter) and self._late_mat_on()
                and _filter_chain_has_join(node)):
            fused = self._fused_stream(node)
            if fused is not None:
                for page in fused:
                    self._account_page(page)
                    yield page
                return
            yield from self._lazy_filter(node)
            return
        yield from self.pages(node)

    def _lazy_filter(self, node: P.Filter):
        """Filter over a lazy join chain: lift exactly the deferred
        channels the predicate reads, remap the predicate onto the
        reduced layout, and flip validity bits without materializing
        anything else."""
        refs = tuple(sorted(PR.expr_channels(node.predicate)))
        for item in self._lazy_pages(node.source):
            if isinstance(item, Page):
                yield _replay_filter(node.predicate, item)
                continue
            lz = self._lazy_lift(item, refs)
            pred = PR.remap_expr(node.predicate,
                                 {c: lz.phys(c) for c in refs})
            yield dataclasses.replace(
                lz, reduced=_replay_filter(pred, lz.reduced))

    def _lazy_lift(self, lz: LM.LazyPage, channels) -> LM.LazyPage:
        """Materialize the named logical channels of a lazy page (one
        gather each): downstream join keys and filter references."""
        need = tuple(sorted(set(channels) - set(lz.mat)))
        if not need:
            return lz
        self.gathers_materialized += len(need)
        maps = tuple(s.channel_map for s in lz.sides)
        reduced = LM.lift_page(lz.mat, maps, need, lz.reduced,
                               *[s.build for s in lz.sides])
        _, new_mat, new_maps, keep = LM.lift_layout(lz.mat, maps, need)
        return LM.LazyPage(
            reduced=reduced, width=lz.width, mat=new_mat,
            sides=tuple(LM.LazySide(lz.sides[i].build, new_maps[i])
                        for i in keep))

    def _materialize_lazy(self, item):
        """Chain-boundary materialization: every still-deferred column
        gathers exactly once through its side's composed row ids."""
        if isinstance(item, Page):
            return item
        if not item.sides:
            return item.reduced  # mat covers every channel, in order
        self.gathers_materialized += sum(len(s.channel_map)
                                         for s in item.sides)
        maps = tuple(s.channel_map for s in item.sides)
        return LM.finish_page(item.mat, maps, item.width, item.reduced,
                              *[s.build for s in item.sides])

    def _generated_join_info(self, node: P.HashJoin, left_types):
        """Eligibility for the build-free GENERATED join: the build side
        is a Filter/Project/Exchange chain over a TableScan of a
        connector that inverts the join-key column in closed form
        (Connector.key_inverse) and generates its columns at arbitrary
        row indices (Connector.gen_at). Probe keys then map to build
        table rows arithmetically and the carried columns are GENERATED
        at those rows: no hash table, no searchsorted, no gathers, no
        capacity overflow — the collapse of HashBuilderOperator +
        LookupJoinOperator for deterministic generator tables."""
        if not self.generated_join:
            return None
        if node.join_type not in ("inner", "left"):
            return None
        walked = self._scan_chain(node.right, through_joins=False)
        if walked is None:
            return None
        cur, chain = walked

        def plain_int(t) -> bool:
            return not (
                T.is_string(t) or t.is_dictionary_encoded
                or T.is_floating(t)
                or (isinstance(t, T.DecimalType) and not t.is_short)
            )

        if not all(plain_int(left_types[c]) for c in node.left_keys):
            return None

        def resolve(ch: int) -> Optional[int]:
            # build-root channel -> scan channel through the projects
            for nd in chain:
                if isinstance(nd, P.Project):
                    e = nd.exprs[ch]
                    if not isinstance(e, InputRef):
                        return None
                    ch = e.channel
            return ch

        conn = self.catalogs[cur.catalog]
        n_rows = conn.row_count(cur.table)
        gen = conn.gen_at(cur.table, cur.columns)
        if gen is None or n_rows <= 0:
            return None
        # ONE key must invert in closed form; the remaining key pairs
        # become equality checks against the generated build columns
        inv, pivot, window, gen_keys = None, None, 1, None
        for j, rk in enumerate(node.right_keys):
            sc = resolve(rk)
            if sc is None:
                continue
            inv = conn.key_inverse(cur.table, cur.columns[sc])
            if inv is not None:
                pivot = j
                break
        if inv is None and self._capacity_boost == 1:
            # windowed inverse (slot-structured fact tables): the pivot
            # key pins an L-slot candidate window and the other keys,
            # generated per candidate, pick the row. A probe row matching
            # > 1 candidates raises the deferred flag and the boosted
            # retry takes the general join (windowed is off at boost > 1)
            for j, rk in enumerate(node.right_keys):
                sc = resolve(rk)
                if sc is None:
                    continue
                wi = conn.key_window_inverse(cur.table, cur.columns[sc])
                if wi is None:
                    continue
                extra_sc = [resolve(rkk)
                            for jj, rkk in enumerate(node.right_keys)
                            if jj != j]
                if not extra_sc or any(c is None for c in extra_sc):
                    continue
                inv, window = wi
                pivot = j
                gen_keys = conn.gen_at(
                    cur.table, tuple(cur.columns[c] for c in extra_sc))
                break
        if inv is None or (window > 1 and gen_keys is None):
            return None
        extra_pairs = tuple(
            (lk, rk)
            for j, (lk, rk) in enumerate(zip(node.left_keys,
                                             node.right_keys))
            if j != pivot
        )
        schema = conn.table_schema(cur.table)
        scan_types = tuple(schema.column_type(c) for c in cur.columns)
        dicts = getattr(conn, "_dicts", {}).get(cur.table, {})
        scan_dicts = tuple(dicts.get(c) for c in cur.columns)
        # the build chain replays bottom-up over the generated pages
        chain_fns = tuple(
            fn for fn in (_node_replay_fn(nd) for nd in reversed(chain))
            if fn is not None
        )
        return (node.left_keys[pivot], extra_pairs, inv, window, gen_keys,
                gen, scan_types, scan_dicts, chain_fns, n_rows)

    @staticmethod
    def generated_join_kernel(node: P.HashJoin, info):
        """The ONE place the _generated_join_info tuple meets the page
        functions, shared by the per-page join and _fused_stream:
        returns (page_fn, windowed). Plain: page -> page. Windowed:
        page -> (page, multi_flag), the flag a device scalar the caller
        defers to the overflow ladder."""
        (pivot_ch, extra_pairs, inv, window, gen_keys, gen, scan_types,
         scan_dicts, chain_fns, n_rows) = info
        if window == 1:
            return functools.partial(
                _generated_join_page, pivot_ch, extra_pairs, node.join_type,
                inv, gen, scan_types, scan_dicts, chain_fns, n_rows), False
        return functools.partial(
            _generated_join_window_page, pivot_ch, extra_pairs,
            node.join_type, inv, window, gen_keys, gen, scan_types,
            scan_dicts, chain_fns, n_rows), True

    def _exec_join_generated(self, node: P.HashJoin, info
                             ) -> Iterator[Page]:
        self.generated_joins_used += 1
        kern, windowed = self.generated_join_kernel(node, info)
        for page in self.pages(node.left):
            if not windowed:
                yield kern(page)
                continue
            out, multi = kern(page)
            # > 1 in-window matches for some probe row: the key set is
            # not unique in the data, and the retry takes the general join
            self._pending_overflow.append(multi)
            yield out

    def _kernels_allowed(self) -> bool:
        """Kernel joins engage on the first attempt only: a boosted
        retry may come from a hash-table build overflow and falls back
        to the sort join, as in the reference."""
        return self.kernels and self._capacity_boost == 1

    def _unique_kernel_eligible(self, node, build: Page, left_types,
                                right_types) -> bool:
        """Unique-key fast path: inner/left joins on ONE u64-encodable
        key whose build side scans a connector-declared UNIQUE column."""
        if not self._kernels_allowed():
            return False
        if node.join_type not in ("inner", "left"):
            return False
        if len(node.left_keys) != 1 or len(node.right_keys) != 1:
            return False
        for t in (left_types[node.left_keys[0]],
                  right_types[node.right_keys[0]]):
            if T.is_string(t) or t.is_dictionary_encoded:
                return False
            if isinstance(t, T.DecimalType) and not t.is_short:
                return False
        if build.capacity > CJ.RADIX_MAX_BUILD:
            return False
        return P.scan_column_unique(node.right, node.right_keys[0],
                                    self.catalogs)

    def _radix_join_eligible(self, node, build: Page) -> bool:
        """The hash-table range finder for any key count/types and
        duplicate build keys, up to RADIX_MAX_BUILD build rows."""
        return (self._kernels_allowed()
                and node.join_type in ("inner", "left", "right", "full")
                and build.capacity <= CJ.RADIX_MAX_BUILD)

    def _count_agg_kernel(self) -> None:
        """One K1 engagement: an aggregation operator whose partial
        step runs the segmented-reduction kernel."""
        if self.kernels:
            self.pallas_kernels_used += 1

    def _count_join_kernel(self) -> None:
        """One K2/K3 engagement: a join pass probing through the
        hash-probe kernel."""
        self.pallas_joins_used += 1
        self.pallas_kernels_used += 1

    def _unique_kernel_pass(self, node, build: Page) -> Iterator[Page]:
        self._count_join_kernel()
        layout = CJ.plan_layout(build.capacity)
        index, build_ovf = _unique_kernel_build(node.right_keys[0], layout,
                                                build)
        self._pending_overflow.append(build_ovf)
        for page in self.pages(node.left):
            yield _unique_kernel_probe_page(node.left_keys[0],
                                            node.join_type, layout, page,
                                            build, index)

    def _join_pass(self, node: P.HashJoin, build: Page, probe_pages,
                   left_types, *, unique_build: bool = False,
                   density: int = 1, defer: str = "never"):
        """One build+probe pass (the whole join unless partitioned).

        unique_build: <=1 match per probe row — output sized to the probe
        page exactly. density: probe pages carry ~1/density real rows
        (partition-filtered passes), so output capacity shrinks to match,
        the deferred overflow flag and the boosted retry guarding skew.
        defer: "always" emits the build side as a row-id indirection
        (latemat.LazyPage) instead of gathering its columns; "chain"
        defers only when the probe item is itself lazy; "never" is the
        eager path. Lazy probe items' deferred keys lift here. A probe
        page whose output would pass its budget share (membudget.py) is
        probed in position slices. Semi and anti joins emit each probe
        page with its match column (_semi_join_page)."""
        if node.join_type in ("semi", "anti"):
            built: Dict = {}  # the build half, made once per pass
            for page in probe_pages:
                yield _semi_join_page(node.left_keys, node.right_keys, page,
                                      build, built)
            return
        use_radix = self._radix_join_eligible(node, build)
        if use_radix:
            self._count_join_kernel()
        layout = CJ.plan_layout(build.capacity) if use_radix else None
        use_unique = (not use_radix and unique_build
                      and node.join_type in ("inner", "left")
                      and self._capacity_boost == 1)
        defer_allowed = (defer != "never"
                         and node.join_type in ("inner", "left"))
        build_matched = torch.zeros(build.capacity, dtype=torch.bool,
                                    device=build.device)
        n_right = len(build.blocks)
        # governed output-capacity ceiling: a join output page claims at
        # most its budget share
        out_row_b = _row_bytes(left_types) + _row_bytes(
            [b.type for b in build.blocks])
        oc_cap = MB.rows_cap(out_row_b, self._budget(), MB.PAGE_SHARE_DIV)
        chunk_counted = False
        # canonical key encodings depend on the probe page's
        # dictionaries: one index per (key channels, dictionaries)
        indexes: Dict = {}
        for item in probe_pages:
            if isinstance(item, LM.LazyPage):
                # downstream-join-key liveness: lift exactly the key
                # channels this probe needs as values
                lz = self._lazy_lift(item, node.left_keys)
                page = lz.reduced
                pkeys = tuple(lz.phys(c) for c in node.left_keys)
            else:
                lz = None
                page = item
                pkeys = tuple(node.left_keys)
            sig = (pkeys, tuple(page.block(c).dictionary for c in pkeys))
            if sig not in indexes:
                if use_radix:
                    index, b_ovf = _build_radix_join_index(
                        pkeys, node.right_keys, layout, page, build)
                    self._pending_overflow.append(b_ovf)
                else:
                    index = _build_join_index(pkeys, node.right_keys, page,
                                              build)
                indexes[sig] = index
            index = indexes[sig]
            if unique_build:
                oc = page.capacity  # output rows <= probe rows
            else:
                oc = page.capacity * 2
                if page.capacity <= 1 << 16:
                    oc = max(oc, build.capacity)
            oc = min(oc, max(4 * self.page_rows, 1 << 19))
            if density > 1:
                # 2x slack over the expected 1/density occupancy
                oc = max(oc * 2 // density, 8192)
            oc = _next_pow2(max(oc, 8192) * self._capacity_boost)
            slices = 1
            if oc_cap is not None and oc > oc_cap:
                # probe-side POSITION chunking (the governed rewrite):
                # each slice keeps the full per-probe-row output
                # allowance inside a cap-sized buffer; both factors are
                # powers of two, so slice shapes stay on the ladder
                slices = min(oc // oc_cap,
                             max(page.capacity // SH.LADDER_MIN, 1))
                oc = max(oc // slices, oc_cap)
                if slices > 1 and not chunk_counted:
                    self.memory_chunked_pipelines += 1
                    chunk_counted = True
            defer_item = defer_allowed and (defer == "always"
                                            or lz is not None)
            # ceil-divide: a concat-produced probe page's capacity need
            # not be a multiple of the slice count
            ccap = -(-page.capacity // max(slices, 1))
            n_slices = -(-page.capacity // max(ccap, 1))
            for si in range(n_slices):
                chunk = (page if n_slices == 1
                         else slice_page(page, si * ccap, ccap))
                if use_radix:
                    out, matched, overflow = _probe_radix_join_page(
                        pkeys, node.right_keys, node.join_type, layout,
                        defer_item, chunk, build, index, oc)
                elif use_unique:
                    out, matched, overflow = _probe_join_page_unique(
                        pkeys, node.right_keys, node.join_type, defer_item,
                        chunk, build, index)
                else:
                    out, matched, overflow = _probe_join_page(
                        pkeys, node.right_keys, node.join_type, defer_item,
                        chunk, build, index, oc)
                self._pending_overflow.append(overflow)
                build_matched = build_matched | matched
                if not defer_item:
                    yield out
                    continue
                width_l = lz.width if lz is not None else page.channel_count
                mat = lz.mat if lz is not None else tuple(
                    range(page.channel_count))
                sides = (lz.sides if lz is not None else ()) + (
                    LM.LazySide(build, tuple((width_l + j, j)
                                             for j in range(n_right))),)
                self.gathers_deferred += sum(len(sd.channel_map)
                                             for sd in sides)
                yield LM.LazyPage(reduced=out, width=width_l + n_right,
                                  mat=mat, sides=sides)
        if node.join_type in ("right", "full"):
            # unmatched build rows with a null left side (reference:
            # LookupOuterOperator)
            null_left = _null_blocks(left_types, build.capacity,
                                     build.device)
            yield Page(blocks=tuple(null_left) + build.blocks,
                       valid=build.valid & ~build_matched)


# ---------------------------------------------------------------- kernels
# Module-level page functions, one per reference kernel.


def _unique_kernel_build(key_ch, layout, build: Page):
    """Unique-key hash-table index over the IDENTITY u64 key encoding:
    in-kernel (lo, hi) equality IS key equality, so probe hits extend
    rows without re-verification."""
    blk = build.block(key_ch)
    bkeys = K.equality_encoding(blk)[0]
    bvalid = build.valid
    if blk.nulls is not None:
        bvalid = bvalid & ~blk.nulls
    tables, perm, ovf = CJ.build_index(bkeys, bvalid, layout)
    return (CJ.pack_tables(tables), perm), ovf


def _unique_kernel_probe_page(key_ch, join_type, layout, page: Page,
                              build: Page, index) -> Page:
    """Probe one page through the hash-table kernel: unique build keys
    mean <=1 match per probe row, so the output page is the probe page
    extended with gathered build columns."""
    packed, perm = index
    blk = page.block(key_ch)
    pkeys = K.equality_encoding(blk)[0]
    valid_key = page.valid
    if blk.nulls is not None:
        valid_key = valid_key & ~blk.nulls
    start, cnt = CJ.probe_index(pkeys, packed, layout)
    hit = valid_key & (cnt > 0)
    rid = torch.where(hit, perm[start.clamp(min=0).to(torch.int64)], -1)
    matched = rid >= 0
    safe = rid.clamp(0, build.capacity - 1)
    right_blocks = []
    for b in build.blocks:
        taken = b.take(safe)
        nulls = taken.nulls
        if join_type == "left":
            nulls = ~matched if nulls is None else (nulls | ~matched)
        right_blocks.append(taken.with_data(taken.data, nulls=nulls))
    out_valid = page.valid & matched if join_type == "inner" else page.valid
    return Page(blocks=page.blocks + tuple(right_blocks), valid=out_valid)


def _replay_filter(predicate, page: Page) -> Page:
    return evaluate_filter(predicate, page)


def _node_replay_fn(nd):
    """Per-node page -> page transform for chain replay over generated
    pages (None for pass-through nodes such as a local Exchange) — the
    ONE place chain-replay semantics live."""
    if isinstance(nd, P.Filter):
        return functools.partial(_replay_filter, nd.predicate)
    if isinstance(nd, P.Project):
        return functools.partial(_project_page, nd.exprs)
    return None


def _fused_agg_step(raw, cap, max_iters, page: Page):
    """Partial-agg tail of a fused pipeline: distinct groups <= rows,
    so the group capacity clips to the page as in the unfused loop."""
    return raw(page, min(cap, _next_pow2(page.capacity)), max_iters)


def _fused_merge_step(merge_raw, cap, max_iters, page: Page):
    """State merge of a batched program: fold the carried state plus one
    split's partial states back into the merge capacity. The output
    capacity depends on (cap, key structure) only, never on the input
    page's, so the fold keeps one state shape."""
    return merge_raw(page, cap, max_iters)


def _compact_with_flag(page: Page, cap: int):
    """compact_page plus the dropped-rows overflow flag."""
    return compact_page(page, cap), page.num_rows() > cap


def _merge_compact_flag(acc: Page, page: Page, cap: int):
    """Fold one more page into the rolling dense accumulator: concat and
    stable compaction back to cap, flagging dropped rows."""
    both = concat_all([acc, page])
    return compact_page(both, cap), both.num_rows() > cap


def _generated_join_page(left_key_ch, extra_pairs, join_type, inv, gen,
                         scan_types, scan_dicts, chain_fns, n_rows,
                         page: Page) -> Page:
    """Build-free generated join: probe keys -> build table rows via the
    connector's closed-form inverse; the carried build columns GENERATED
    at those rows; the build side's Filter/Project chain replayed over
    the generated blocks. Elementwise throughout — the output page is
    the probe page extended in place (<= 1 match per probe row by the
    key_inverse uniqueness contract), so capacities are exact and there
    is no overflow flag."""
    kblk = page.block(left_key_ch)
    ridx, found = inv(kblk.data.to(torch.int64))
    if kblk.nulls is not None:
        found = found & ~kblk.nulls
    datas, gvalid = gen(ridx.clamp(0, max(n_rows - 1, 0)))
    bpage = Page(blocks=tuple(
        Block(data=d, type=t, nulls=None, dictionary=dic)
        for d, t, dic in zip(datas, scan_types, scan_dicts)
    ), valid=found & gvalid)
    for fn in chain_fns:
        bpage = fn(bpage)
    matched = bpage.valid
    # non-pivot key pairs: equality against the generated build columns
    # (SQL semantics: NULL on either side never matches)
    for lk, rk in extra_pairs:
        lblk, rblk = page.block(lk), bpage.block(rk)
        eq = lblk.data.to(torch.int64) == rblk.data.to(torch.int64)
        if lblk.nulls is not None:
            eq = eq & ~lblk.nulls
        if rblk.nulls is not None:
            eq = eq & ~rblk.nulls
        matched = matched & eq
    return _extend_with_build(join_type, page, bpage, matched)


def _extend_with_build(join_type, page: Page, bpage: Page,
                       matched: torch.Tensor) -> Page:
    """A generated join's output: the probe page extended in place with
    the generated build columns (<= 1 match per probe row); a left join
    keeps unmatched probe rows with NULL build columns."""
    if join_type == "left":
        right_blocks = tuple(
            b.with_data(b.data, nulls=(~matched if b.nulls is None
                                       else (b.nulls | ~matched)))
            for b in bpage.blocks)
        return Page(blocks=page.blocks + right_blocks, valid=page.valid)
    return Page(blocks=page.blocks + bpage.blocks,
                valid=page.valid & matched)


def _generated_join_window_page(left_key_ch, extra_pairs, join_type, inv,
                                window, gen_keys, gen, scan_types,
                                scan_dicts, chain_fns, n_rows,
                                page: Page):
    """Windowed generated join: the pivot key pins an L-slot candidate
    window of the slot-structured build table; the other key columns are
    GENERATED at each candidate to resolve the unique matching row, then
    the carried columns generate at the resolved rows — fact-to-fact
    joins (store_sales to store_returns on ticket and item) with no build
    state. Returns (page, multi_flag): the flag (a device scalar) trips
    when some probe row matched > 1 candidates, i.e. the key set is not
    unique in the data; the caller defers it to the overflow ladder."""
    kblk = page.block(left_key_ch)
    vals = kblk.data.to(torch.int64)
    base, found = inv(vals)
    if kblk.nulls is not None:
        found = found & ~kblk.nulls
    probe_extras = []
    for lk, _rk in extra_pairs:
        b = page.block(lk)
        if b.nulls is not None:
            found = found & ~b.nulls
        probe_extras.append(b.data.to(torch.int64))
    resolved = torch.zeros_like(vals)
    any_match = torch.zeros_like(found)
    multi = torch.zeros_like(found)
    for k in range(window):
        cand = (base + k).clamp(0, max(n_rows - 1, 0))
        in_range = (base + k >= 0) & (base + k < n_rows)
        kdatas, kvalid = gen_keys(cand)
        mk = found & kvalid & in_range
        for pv, kd in zip(probe_extras, kdatas):
            mk = mk & (pv == kd.to(torch.int64))
        multi = multi | (mk & any_match)
        resolved = torch.where(mk & ~any_match, cand, resolved)
        any_match = any_match | mk
    datas, gvalid = gen(resolved)
    bpage = Page(blocks=tuple(
        Block(data=d, type=t, nulls=None, dictionary=dic)
        for d, t, dic in zip(datas, scan_types, scan_dicts)
    ), valid=any_match & gvalid)
    for fn in chain_fns:
        bpage = fn(bpage)
    return (_extend_with_build(join_type, page, bpage, bpage.valid),
            multi.any())


def _semi_join_page(left_keys, right_keys, page: Page, build: Page,
                    built: Dict) -> Page:
    """Semi/anti join page: the probe page plus a BOOLEAN match column
    whose NULLs carry SQL three-valued IN semantics; the planner's
    filter above keeps (semi) or drops (anti) the matched rows.
    ``built`` (a dict a pass keeps across its probe pages) holds the
    build half (J.semi_join_build) for the probe keys' dictionaries it
    was made under: the build's canonical keys depend on them, and pages
    of one scan share them, so the build's hash and sort run once per
    pass, not once per probe page."""
    lblocks = [page.block(c) for c in left_keys]
    lcols, lnulls, rcols, rnulls = _canonical_join_cols(
        lblocks, [build.block(c) for c in right_keys])
    dicts = [b.dictionary for b in lblocks]
    made = built.get("dicts")
    if made is None or any(a is not b and a != b
                           for a, b in zip(made, dicts)):
        built["dicts"] = dicts
        built["half"] = J.semi_join_build(rcols, rnulls, build.valid)
    has_match, null_result = J.semi_join_probe(
        built["half"], lcols, lnulls, page.valid)
    match = Block(data=has_match, type=T.BOOLEAN, nulls=null_result)
    return Page(blocks=page.blocks + (match,), valid=page.valid)


def _project_page(exprs, page: Page) -> Page:
    blocks = []
    for e in exprs:
        v = evaluate(e, page)
        data = v.data
        if isinstance(data, tuple):
            data = tuple(d.expand(page.capacity) if d.dim() == 0 else d
                         for d in data)
        elif data.dim() == 0:
            data = data.expand(page.capacity)
        nulls = v.nulls
        if nulls is not None and nulls.dim() == 0:
            nulls = nulls.expand(page.capacity)
        dic = v.dictionary
        if (dic is None and T.is_string(e.type) and v.is_const
                and v.py_value is not None):
            # a PROJECTED string constant needs its own one-entry
            # dictionary, or it would decode as the bare code 0
            dic = Dictionary([v.py_value])
        blocks.append(Block(data=data, type=e.type, nulls=nulls,
                            dictionary=dic))
    return Page(blocks=tuple(blocks), valid=page.valid)


def _group_ids(group_channels, page: Page, cap: int, max_iters: int = 64):
    key_blocks = [page.block(c) for c in group_channels]
    # dense fast path: all keys dictionary-coded (unique values, no
    # nulls) or boolean and the combined code space fits the capacity —
    # the group id is computed arithmetically (Q1: 2 flag columns)
    sizes = []
    for b in key_blocks:
        if (b.dictionary is not None and len(b.dictionary)
                and not b.dictionary.has_duplicate_values()
                and b.nulls is None):
            sizes.append(len(b.dictionary))
        elif isinstance(b.type, T.BooleanType) and b.nulls is None:
            sizes.append(2)
        else:
            sizes = None
            break
    if sizes is not None:
        space = 1
        for s in sizes:
            space *= s
        if space <= cap:
            gid = torch.zeros(page.capacity, dtype=torch.int64,
                              device=page.device)
            for b, s in zip(key_blocks, sizes):
                gid = gid * s + b.data.to(torch.int64).clamp(0, s - 1)
            return A.compute_groups_dense(
                gid, page.valid, space, out_capacity=_next_pow2(space),
                sizes=tuple(sizes))
    key_cols, key_nulls = K.block_key_columns(key_blocks)
    if cap > A.MATMUL_AGG_MAX_GROUPS or page.capacity >= (1 << 22):
        return A.compute_groups_sorted(key_cols, key_nulls, page.valid, cap)
    return A.compute_groups_hashed(key_cols, key_nulls, page.valid, cap,
                                   max_iters=max_iters)


def _state_reduce(st, blk, kind, apply_pre, reducer):
    """Run one primitive reduction with value-domain transforms:
    dictionary-coded MIN/MAX inputs reduce over Dictionary.sort_rank and
    map back, and the dictionary rides along so decode stays correct.
    reducer(data, nulls) -> (vals, out_nulls)."""
    if blk is None:
        return (*reducer(None, None), None)
    if isinstance(blk.data, tuple):
        raise NotImplementedError(
            "aggregation over long-decimal (p>18) input columns is not "
            "supported (decimal sums produce long-decimal outputs from "
            "short inputs)")
    dic = blk.dictionary
    if dic is not None and kind in (A.MIN, A.MAX) and len(dic):
        rank_np = dic.sort_rank().astype(np.int64)
        rank = consts.lut(rank_np, blk.device)
        inv = consts.lut(np.argsort(rank_np), blk.device)
        data = rank[blk.data.clamp(0, len(dic) - 1).to(torch.int64)]
        vals, out_nulls = reducer(data, blk.nulls)
        vals = inv[vals.clamp(0, len(dic) - 1)].to(blk.data.dtype)
        return vals, out_nulls, dic
    data = S.pre_transform(st.pre, blk.data) if apply_pre else blk.data
    vals, out_nulls = reducer(data, blk.nulls)
    return vals, out_nulls, dic


def _attach_dictionary(block: Block, dic) -> Block:
    if dic is None or block.dictionary is not None:
        return block
    if not block.type.is_dictionary_encoded:
        return block
    return Block(data=block.data, type=block.type, nulls=block.nulls,
                 dictionary=dic)


def _apply_agg_mask(spec, page: Page, blk: Optional[Block]):
    """Per-aggregate mask: unmarked rows contribute nothing — expressed
    as null inputs, which every accumulator skips."""
    if spec.mask is None or blk is None:
        return blk
    inv = ~page.block(spec.mask).data
    nulls = inv if blk.nulls is None else (blk.nulls | inv)
    return Block(data=blk.data, type=blk.type, nulls=nulls,
                 dictionary=blk.dictionary)


def _mark_distinct_page(mark_channel_sets, page: Page, cap, max_iters):
    """Append first-occurrence marks per key set (MarkDistinctOperator):
    group ids over the key set, then True at each group's
    representative row."""
    blocks: List[Block] = []
    overflow = torch.zeros((), dtype=torch.bool, device=page.device)
    for chans in mark_channel_sets:
        groups = _group_ids(chans, page, cap, max_iters)
        rep = groups.rep_index
        if rep is None:
            # the dense path keeps no representative rows (its keys come
            # from the group id): each group's first valid row
            out_cap = groups.group_valid.shape[0]
            rep = A._scatter_min(
                out_cap + 1, page.capacity,
                torch.where(groups.row_valid, groups.group_ids, out_cap),
                torch.arange(page.capacity, dtype=torch.int64,
                             device=page.device))[:out_cap]
        mark = torch.zeros(page.capacity + 1, dtype=torch.bool,
                           device=page.device)
        mark[torch.where(groups.group_valid, rep, page.capacity)] = True
        blocks.append(Block(data=mark[:page.capacity], type=T.BOOLEAN))
        overflow = overflow | groups.overflow
    return (Page(blocks=page.blocks + tuple(blocks), valid=page.valid),
            overflow)


def _hll_hashes(blk: Block) -> torch.Tensor:
    """One u64 hash per row over the block's equality encoding (SQL-equal
    values hash equal, dictionary canonicalization included)."""
    cols = K.equality_encoding(blk)
    return H.hash_columns(cols, [None] * len(cols))


def _hll_contributing(groups, blk: Optional[Block]):
    contributing = groups.row_valid
    if blk is not None and blk.nulls is not None:
        contributing = contributing & ~blk.nulls
    return contributing


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2.0 ** k for integer-valued float64 k in [-2044, 2046], as the
    product of two powers built from their exponent bits: exact on
    every device, where a library exp2 may be an ulp off."""
    k = k.to(torch.int64)
    half = torch.div(k, 2, rounding_mode="floor")

    def bits(j):
        return ((j.clamp(-1022, 1023) + 1023) << 52).view(torch.float64)

    return bits(half) * bits(k - half)


def _collect_encode(blk: Block) -> torch.Tensor:
    """A block's values as int64 collect slots: integers, dates,
    booleans and short decimals directly, dictionary codes as they are
    (the dictionary rides the state Block).

    Floats take the reference's arithmetic sign/exponent/mantissa pack
    (log2/floor, two correction steps), not a bit view: the pack is
    ORDER-PRESERVING (int64 order == float order), so approx_percentile
    needs no float case. NaN encodes as the largest int64. The
    mantissa scales by an exact power of two (_pow2), where the
    reference's XLA exp2 is a few ulp off, so the port's round trip is
    exact and its words sit within a few code steps of the
    reference's."""
    data = blk.data
    if isinstance(data, tuple):
        raise NotImplementedError(
            "array_agg/map_agg over long-decimal (p>18) inputs is not "
            "supported")
    if not data.is_floating_point():
        return data.to(torch.int64)
    x = data.to(torch.float64)
    ax = x.abs()
    safe = torch.where(ax > 0, ax, 1.0)
    e = torch.floor(torch.log2(safe))
    # power-of-two scaling is exact; two correction steps absorb any
    # log2 boundary imprecision
    m = safe * _pow2(-e - 1.0)
    for _ in range(2):
        hi = m >= 1.0
        lo = m < 0.5
        e = e + hi.to(torch.float64) - lo.to(torch.float64)
        m = torch.where(hi, m * 0.5, torch.where(lo, m * 2.0, m))
    frac = ((m - 0.5) * float(2 ** 53)).to(torch.int64).clamp(
        0, (1 << 52) - 1)
    mag = ((e.to(torch.int64) + 1100).clamp(0, 2047) << 52) | frac
    enc = torch.where(ax == 0, 0, torch.where(x < 0, -mag, mag))
    return torch.where(torch.isnan(x), torch.iinfo(torch.int64).max, enc)


def _collect_float_decode_device(enc: torch.Tensor) -> torch.Tensor:
    """Inverse of the float pack: value = sign * 2^(e+1) * (0.5 + frac *
    2^-53)."""
    mag = enc.abs()
    e = ((mag >> 52) - 1100).to(torch.float64)
    frac = (mag & ((1 << 52) - 1)).to(torch.float64)
    val = (0.5 + frac * float(2.0 ** -53)) * _pow2(e + 1.0)
    val = torch.where(enc < 0, -val, val)
    return torch.where(enc == 0, 0.0, val)


def _collect_partial_blocks(spec, layout, page, groups, out_cap,
                            collect_k):
    """Partial-step collect state, with the reference's null semantics:
    array_agg INCLUDES null elements (a parallel null-flag matrix rides
    the state); map_agg skips null KEYS but keeps null values;
    approx_percentile ignores nulls. A DISTINCT mask always excludes
    unmarked rows."""
    blk = page.block(spec.channel)
    contributing = groups.row_valid
    if spec.mask is not None:
        contributing = contributing & page.block(spec.mask).data
    fn = spec.function
    if fn == "map_agg":
        if blk.nulls is not None:  # null keys are skipped
            contributing = contributing & ~blk.nulls
        vblk = page.block(spec.extra_channels[0])
        if vblk.dictionary is not None:
            raise NotImplementedError(
                "map_agg with dictionary-coded (varchar/complex) VALUE "
                "columns is not supported; keys may be any type")
        sources = [(blk, None), (vblk, None), (None, vblk.nulls)]
    elif fn == "approx_percentile":
        if blk.nulls is not None:  # percentile ignores nulls
            contributing = contributing & ~blk.nulls
        sources = [(blk, None)]
    else:  # array_agg: null elements included
        sources = [(blk, None), (None, blk.nulls)]
    blocks: List[Block] = []
    overflow = torch.zeros((), dtype=torch.bool, device=page.device)
    for (vb, null_src), st in zip(sources, layout):
        if vb is not None:
            enc, dic = _collect_encode(vb), vb.dictionary
        else:
            enc = (null_src.to(torch.int64) if null_src is not None
                   else torch.zeros(page.capacity, dtype=torch.int64,
                                    device=page.device))
            dic = None
        vals, ovf = CL.insert(groups.group_ids, contributing, out_cap, enc,
                              collect_k)
        overflow = overflow | ovf
        blocks.append(Block(data=vals, type=st.type, dictionary=dic))
    cnt, _ = A.aggregate(
        groups, A.COUNT, out_cap,
        torch.zeros(page.capacity, dtype=torch.int64, device=page.device),
        ~contributing)
    blocks.append(Block(data=cnt, type=T.BIGINT))
    return blocks, overflow


def _collect_merge_blocks(layout, merged, groups, out_cap, ch, collect_k):
    """Merge partial collect states grouped by output key: per collected
    column, member rows' slot vectors concatenate in row order; the
    count column sums."""
    n_collect = len(layout) - 1
    counts = merged.block(ch + n_collect).data
    blocks: List[Block] = []
    overflow = torch.zeros((), dtype=torch.bool, device=merged.device)
    for i in range(n_collect):
        blk = merged.block(ch + i)
        vals, ovf = CL.merge(groups.group_ids, groups.row_valid, out_cap,
                             blk.data, counts, collect_k)
        overflow = overflow | ovf
        blocks.append(Block(data=vals, type=layout[i].type,
                            dictionary=blk.dictionary))
    ncnt, _ = A.aggregate(groups, A.SUM, out_cap, counts, None)
    blocks.append(Block(data=ncnt, type=T.BIGINT))
    return blocks, overflow


def _collect_finalize_block(spec, in_t, extra_t, state_blocks) -> Block:
    """Merged collect state -> the SQL result Block. Arrays and maps
    carry TUPLE data ((vals2d, nulls2d, counts) for arrays; (k2d, v2d,
    vnulls2d, counts) for maps), decoded on the host at the client
    boundary (page.to_pylist): as in the reference, a collect result
    feeds no further device expression."""
    if spec.function == "approx_percentile":
        vals_blk, cnt_blk = state_blocks
        frac = float(spec.params[0]) if spec.params else 0.5
        picked = CL.percentile_select(vals_blk.data, cnt_blk.data, frac,
                                      vals_blk.data.shape[1])
        if T.is_floating(in_t):
            picked = _collect_float_decode_device(picked)
        return Block(data=picked.to(in_t.device_dtype), type=in_t,
                     nulls=cnt_blk.data == 0)
    if spec.function == "map_agg":
        # value columns are non-dictionary (checked at partial), so the
        # Block's one dictionary slot carries the keys'
        k_blk, v_blk, vn_blk, cnt_blk = state_blocks
        return Block(
            data=(k_blk.data, v_blk.data, vn_blk.data, cnt_blk.data),
            type=T.MapType(in_t, extra_t[0] if extra_t else T.UNKNOWN),
            nulls=cnt_blk.data == 0, dictionary=k_blk.dictionary)
    vals_blk, vn_blk, cnt_blk = state_blocks
    return Block(data=(vals_blk.data, vn_blk.data, cnt_blk.data),
                 type=T.ArrayType(in_t), nulls=cnt_blk.data == 0,
                 dictionary=vals_blk.dictionary)


def _agg_keys_page(src: Page, group_channels, groups) -> Page:
    if groups.dense_sizes is not None:
        # synthesize key columns from the mixed-radix group id
        gid = torch.arange(groups.group_valid.shape[0], dtype=torch.int64,
                           device=src.device)
        codes = []
        for s in reversed(groups.dense_sizes):
            codes.append(gid % s)
            gid = gid // s
        codes.reverse()
        blocks = []
        for c, code in zip(group_channels, codes):
            b = src.block(c)
            blocks.append(Block(data=code.to(b.data.dtype), type=b.type,
                                nulls=None, dictionary=b.dictionary))
        return Page(blocks=tuple(blocks), valid=groups.group_valid)
    return gather_rows(src.select_channels(group_channels),
                       groups.rep_index, groups.group_valid)


def _partial_agg_page(group_channels, aggregates, layouts, page: Page,
                      cap: int, max_iters: int = 64,
                      kernels: bool = False, collect_k: int = 1024):
    """Partial step over one page. With kernels on, the supported
    aggregates go to K1 (ops/cuda_agg); the others delegate back to
    ops/agg inside CA.aggregate, so one dispatch covers the layout.
    Collect and HLL states take their own branches (ops/collect.py,
    ops/hll.py)."""
    agg_fn = CA.aggregate if kernels else A.aggregate
    groups = _group_ids(group_channels, page, cap, max_iters)
    out_cap = groups.group_valid.shape[0]
    keys_page = _agg_keys_page(page, group_channels, groups)
    state_blocks: List[Block] = []
    for spec, layout in zip(aggregates, layouts):
        if spec.function in S.COLLECT_FNS:
            blocks, c_ovf = _collect_partial_blocks(
                spec, layout, page, groups, out_cap, collect_k)
            state_blocks.extend(blocks)
            groups.overflow = groups.overflow | c_ovf
            continue
        blk = None if spec.channel is None else page.block(spec.channel)
        blk = _apply_agg_mask(spec, page, blk)
        if spec.function == "approx_distinct":
            words = HLL.insert(groups.group_ids,
                               _hll_contributing(groups, blk), out_cap,
                               _hll_hashes(blk))
            state_blocks.append(Block(data=words, type=T.HLL_STATE))
            continue
        for st in layout:
            vals, out_nulls, dic = _state_reduce(
                st, blk, st.input_kind, True,
                lambda data, nulls, k=st.input_kind: agg_fn(
                    groups, k, out_cap, data, nulls))
            state_blocks.append(Block(data=vals, type=st.type,
                                      nulls=out_nulls, dictionary=dic))
    out = Page(blocks=keys_page.blocks + tuple(state_blocks),
               valid=groups.group_valid)
    return out, groups.overflow


def _merge_partials_page(aggregates, layouts, nkeys, merged: Page,
                         cap: int, max_iters: int = 64,
                         collect_k: int = 1024):
    """Merge partial-state pages into one partial-state page (group by
    keys, merge_kind reductions, no finalize)."""
    key_channels = tuple(range(nkeys))
    groups = _group_ids(key_channels, merged, cap, max_iters)
    out_cap = groups.group_valid.shape[0]
    keys_page = _agg_keys_page(merged, key_channels, groups)
    out_blocks: List[Block] = []
    ch = nkeys
    for spec, layout in zip(aggregates, layouts):
        if spec.function in S.COLLECT_FNS:
            blocks, c_ovf = _collect_merge_blocks(
                layout, merged, groups, out_cap, ch, collect_k)
            out_blocks.extend(blocks)
            groups.overflow = groups.overflow | c_ovf
            ch += len(layout)
            continue
        if spec.function == "approx_distinct":
            words = HLL.merge(groups.group_ids, groups.row_valid, out_cap,
                              merged.block(ch).data)
            ch += 1
            out_blocks.append(Block(data=words, type=T.HLL_STATE))
            continue
        for st in layout:
            blk = merged.block(ch)
            ch += 1
            vals, out_nulls, dic = _state_reduce(
                st, blk, st.merge_kind, False,
                lambda data, nulls, k=st.merge_kind: A.aggregate(
                    groups, k, out_cap, data, nulls))
            out_blocks.append(Block(data=vals, type=st.type,
                                    nulls=out_nulls, dictionary=dic))
    out = Page(blocks=keys_page.blocks + tuple(out_blocks),
               valid=groups.group_valid)
    return out, groups.overflow


def _final_agg_page(group_channels, aggregates, layouts, in_types,
                    merged: Page, cap: int, max_iters: int = 64,
                    collect_k: int = 1024, extra_types=()):
    nkeys = len(group_channels)
    key_channels = tuple(range(nkeys))
    groups = _group_ids(key_channels, merged, cap, max_iters)
    out_cap = groups.group_valid.shape[0]
    keys_page = _agg_keys_page(merged, key_channels, groups)
    out_blocks: List[Block] = []
    ch = nkeys
    for idx, (spec, layout, in_t) in enumerate(
            zip(aggregates, layouts, in_types)):
        if spec.function in S.COLLECT_FNS:
            blocks, c_ovf = _collect_merge_blocks(
                layout, merged, groups, out_cap, ch, collect_k)
            groups.overflow = groups.overflow | c_ovf
            ch += len(layout)
            ext = extra_types[idx] if idx < len(extra_types) else ()
            out_blocks.append(_collect_finalize_block(spec, in_t, ext,
                                                      blocks))
            continue
        if spec.function == "approx_distinct":
            words = HLL.merge(groups.group_ids, groups.row_valid, out_cap,
                              merged.block(ch).data)
            ch += 1
            out_blocks.append(Block(data=HLL.estimate(words),
                                    type=T.BIGINT))
            continue
        states = []
        state_dic = None
        for st in layout:
            blk = merged.block(ch)
            ch += 1
            vals, out_nulls, dic = _state_reduce(
                st, blk, st.merge_kind, False,
                lambda data, nulls, k=st.merge_kind: A.aggregate(
                    groups, k, out_cap, data, nulls))
            state_dic = state_dic or dic
            states.append((vals, out_nulls))
        out_t = S.result_type(spec.function, in_t)
        out_blocks.append(_attach_dictionary(
            S.finalize(spec.function, in_t, out_t, states), state_dic))
    out = Page(blocks=keys_page.blocks + tuple(out_blocks),
               valid=groups.group_valid)
    return out, groups.overflow


def _partial_global_agg(aggregates, layouts, page: Page,
                        kernels: bool = False) -> Page:
    """Partial ungrouped aggregation over one page: one state row. With
    kernels on, the supported states go to K1 as a single group."""
    agg_fn = CA.global_aggregate if kernels else A.global_aggregate
    blocks = []
    for spec, layout in zip(aggregates, layouts):
        blk = None if spec.channel is None else page.block(spec.channel)
        blk = _apply_agg_mask(spec, page, blk)
        if spec.function == "approx_distinct":
            contributing = page.valid
            if blk.nulls is not None:
                contributing = contributing & ~blk.nulls
            blocks.append(Block(
                data=HLL.global_insert(contributing, _hll_hashes(blk)),
                type=T.HLL_STATE))
            continue
        for st in layout:
            vals, is_null, dic = _state_reduce(
                st, blk, st.input_kind, True,
                lambda data, nulls, k=st.input_kind: agg_fn(
                    k, page.valid, data, nulls))
            blocks.append(Block(data=vals[None].to(st.type.device_dtype),
                                type=st.type, nulls=is_null[None],
                                dictionary=dic))
    return Page(blocks=tuple(blocks),
                valid=torch.ones(1, dtype=torch.bool, device=page.device))


def _final_global_agg(aggregates, layouts, in_types, merged: Page) -> Page:
    out_blocks = []
    ch = 0
    for spec, layout, in_t in zip(aggregates, layouts, in_types):
        if spec.function == "approx_distinct":
            words = HLL.global_merge(merged.valid, merged.block(ch).data)
            ch += 1
            out_blocks.append(Block(data=HLL.estimate(words),
                                    type=T.BIGINT))
            continue
        states = []
        state_dic = None
        for st in layout:
            blk = merged.block(ch)
            ch += 1
            vals, is_null, dic = _state_reduce(
                st, blk, st.merge_kind, False,
                lambda data, nulls, k=st.merge_kind: A.global_aggregate(
                    k, merged.valid, data, nulls))
            state_dic = state_dic or dic
            states.append((vals[None], is_null[None]))
        out_t = S.result_type(spec.function, in_t)
        out_blocks.append(_attach_dictionary(
            S.finalize(spec.function, in_t, out_t, states), state_dic))
    return Page(blocks=tuple(out_blocks),
                valid=torch.ones(1, dtype=torch.bool, device=merged.device))


def _empty_state_page(aggregates, layouts, device,
                      collect_k: int = 1024) -> Page:
    blocks = []
    for layout in layouts:
        for st in layout:
            if isinstance(st.type, T.CollectStateType):
                blocks.append(Block(data=torch.zeros(
                    (1, collect_k), dtype=torch.int64, device=device),
                    type=st.type))
            elif isinstance(st.type, T.HllStateType):
                blocks.append(Block(data=tuple(
                    torch.zeros(1, dtype=torch.int64, device=device)
                    for _ in range(HLL.WORDS)), type=st.type))
            else:
                blocks.append(Block(
                    data=torch.zeros(1, dtype=st.type.device_dtype,
                                     device=device),
                    type=st.type,
                    nulls=torch.ones(1, dtype=torch.bool, device=device)))
    return Page(blocks=tuple(blocks),
                valid=torch.zeros(1, dtype=torch.bool, device=device))


def _empty_page(types: List[T.SqlType], device, cap: int = 8) -> Page:
    blocks = []
    for t in types:
        if isinstance(t, T.DecimalType) and not t.is_short:
            data = (torch.zeros(cap, dtype=torch.int64, device=device),
                    torch.zeros(cap, dtype=torch.int64, device=device))
        else:
            data = torch.zeros(cap, dtype=t.device_dtype, device=device)
        dic = Dictionary([]) if t.is_dictionary_encoded else None
        blocks.append(Block(data=data, type=t, nulls=None, dictionary=dic))
    return Page(blocks=tuple(blocks),
                valid=torch.zeros(cap, dtype=torch.bool, device=device))


def _null_blocks(types: List[T.SqlType], cap: int, device) -> List[Block]:
    ones = torch.ones(cap, dtype=torch.bool, device=device)
    return [Block(data=b.data, type=b.type, nulls=ones,
                  dictionary=b.dictionary)
            for b in _empty_page(types, device, cap).blocks]


def _subtree_has_join(node: P.PhysicalNode) -> bool:
    if isinstance(node, (P.HashJoin, P.CrossJoin)):
        return True
    return any(_subtree_has_join(c) for c in node.children())


def _filter_chain_has_join(node: P.PhysicalNode) -> bool:
    """Whether a Filter(-over-Filter...) chain sits directly on a
    HashJoin — the shape _lazy_filter streams without
    materializing."""
    cur = node
    while isinstance(cur, P.Filter):
        cur = cur.source
    return isinstance(cur, P.HashJoin)


def _build_join_index(left_keys, right_keys, page: Page, build: Page):
    """One-shot sort-join build index. The probe page supplies the
    dictionary context for canonical key encodings."""
    lblocks = [page.block(c) for c in left_keys]
    rblocks = [build.block(c) for c in right_keys]
    _lcols, _lnulls, rcols, rnulls = _canonical_join_cols(lblocks, rblocks)
    return J.build_join_index(rcols, rnulls, build.valid)


def _probe_join_page(left_keys, right_keys, join_type, defer, page: Page,
                     build: Page, index, out_cap: int):
    lblocks = [page.block(c) for c in left_keys]
    rblocks = [build.block(c) for c in right_keys]
    lcols, lnulls, _rcols, _rnulls = _canonical_join_cols(lblocks, rblocks)
    m = J.hash_join_match(None, None, None, lcols, lnulls, page.valid,
                          out_cap, index=index)
    return _assemble_join_output(join_type, page, build, m, defer=defer)


def _probe_join_page_unique(left_keys, right_keys, join_type, defer,
                            page: Page, build: Page, index):
    """FK-join (unique build keys) sort-join probe: no match expansion —
    the output page IS the probe page plus gathered build columns; a u64
    hash collision between distinct keys flags overflow. defer: the
    build side rides as ONE int64 row-id column instead (late
    materialization); the probe page's own indirections pass through."""
    lblocks = [page.block(c) for c in left_keys]
    rblocks = [build.block(c) for c in right_keys]
    lcols, lnulls, _rcols, _rnulls = _canonical_join_cols(lblocks, rblocks)
    bcols, bvalid, sorted_hash, perm = index
    pcols, p_null = J._fold_nulls(lcols, lnulls, False)
    pvalid = page.valid & ~p_null
    phash = H.hash_columns(pcols, [None] * len(pcols))
    lo = J.searchsorted_u64(sorted_hash, phash, "left")
    hi = J.searchsorted_u64(sorted_hash, phash, "right")
    bid, found, collision = J.unique_join_lookup(bcols, bvalid, perm, pcols,
                                                 pvalid, lo, hi)
    # build_matched feeds only RIGHT/FULL emission, never served here
    matched = torch.zeros(build.capacity, dtype=torch.bool,
                          device=build.device)
    if defer:
        id_block = Block(data=bid, type=T.BIGINT,
                         nulls=~found if join_type == "left" else None)
        out_valid = page.valid if join_type == "left" else (
            page.valid & found)
        return (Page(blocks=page.blocks + (id_block,), valid=out_valid),
                matched, collision)
    right_out = gather_rows(build, bid, found)
    if join_type == "left":
        right_blocks = tuple(
            b.with_data(b.data, nulls=(~found if b.nulls is None
                                       else (b.nulls | ~found)))
            for b in right_out.blocks)
        out_valid = page.valid
    else:
        right_blocks = right_out.blocks
        out_valid = page.valid & found
    return (Page(blocks=page.blocks + right_blocks, valid=out_valid),
            matched, collision)


def _build_radix_join_index(left_keys, right_keys, layout, page: Page,
                            build: Page):
    """Hash-table join index: hash-sorted build order + the layout's
    per-unique-hash (start, count) table, packed for the probe kernel."""
    lblocks = [page.block(c) for c in left_keys]
    rblocks = [build.block(c) for c in right_keys]
    _lcols, _lnulls, rcols, rnulls = _canonical_join_cols(lblocks, rblocks)
    bcols, b_null = J._fold_nulls(rcols, rnulls, False)
    bvalid = build.valid & ~b_null
    bhash = H.hash_columns(bcols, [None] * len(bcols))
    tables, perm, overflow = CJ.build_index(bhash, bvalid, layout)
    return (tuple(bcols), bvalid, perm, CJ.pack_tables(tables)), overflow


def _probe_radix_join_page(left_keys, right_keys, join_type, layout,
                           defer, page: Page, build: Page, index,
                           out_cap: int):
    """Probe one page through the hash-table kernel, then the shared
    verified expansion (J.expand_matches) — the same output contract as
    _probe_join_page; only the range finder differs."""
    lblocks = [page.block(c) for c in left_keys]
    rblocks = [build.block(c) for c in right_keys]
    lcols, lnulls, _rcols, _rnulls = _canonical_join_cols(lblocks, rblocks)
    bcols, bvalid, perm, packed = index
    pcols, p_null = J._fold_nulls(lcols, lnulls, False)
    pvalid = page.valid & ~p_null
    phash = H.hash_columns(pcols, [None] * len(pcols))
    start, cnt = CJ.probe_index(phash, packed, layout)
    m = J.expand_matches(bcols, bvalid, perm, pcols, pvalid,
                         start.clamp(min=0), cnt, out_cap)
    return _assemble_join_output(join_type, page, build, m, defer=defer)


def _assemble_join_output(join_type, page: Page, build: Page,
                          m: J.JoinMatches, defer: bool = False):
    """Expand matches into the output page; LEFT/FULL append the
    unmatched probe rows with a null build side. defer (inner/left
    only): ONE int64 build row-id column instead of the gathered build
    blocks — the probe columns, row-id indirections included, gather
    through probe_idx, which composes the indirections (latemat.py)."""
    out_valid = m.match
    left_out = gather_rows(page, m.probe_idx, out_valid)
    if defer:
        right_blocks = (Block(data=m.build_idx.to(torch.int64),
                              type=T.BIGINT),)
    else:
        right_blocks = gather_rows(build, m.build_idx, out_valid).blocks
    out = Page(blocks=left_out.blocks + right_blocks, valid=out_valid)
    if join_type in ("left", "full"):
        unmatched_valid = page.valid & (m.probe_match_count == 0)
        ones = torch.ones(page.capacity, dtype=torch.bool,
                          device=page.device)
        zeros = torch.zeros(page.capacity, dtype=torch.int64,
                            device=page.device)
        if defer:
            null_right = [Block(data=zeros, type=T.BIGINT, nulls=ones)]
        else:
            null_right = [
                b.with_data(b.data, nulls=ones)
                for b in gather_rows(build, zeros, unmatched_valid).blocks
            ]
        pad = Page(blocks=page.blocks + tuple(null_right),
                   valid=unmatched_valid)
        out = concat_all([out, pad])
    return out, m.build_matched, m.overflow


def _topn_merge(sort_keys, limit, running: Page, local: Page) -> Page:
    return sort_page(concat_all([running, local]), sort_keys=sort_keys,
                     limit=limit)


def _limit_with_count(count, offset, page: Page, consumed):
    """LIMIT across pages with the running total carried as a device
    scalar (reference: LimitOperator's remaining counter)."""
    rank = torch.cumsum(page.valid.to(torch.int64), 0) - 1 + consumed
    keep = page.valid & (rank >= offset) & (rank < offset + count)
    return page.with_valid(keep), consumed + page.num_rows()


def _unnest_page(array_channel, elem_type, with_ordinality,
                 page: Page) -> Page:
    """Static-shape UNNEST: output capacity = input capacity x L, L the
    longest array in the channel's dictionary. Element values gather
    from a flat host lut per dictionary (ops/consts.lut); shorter arrays
    mask out their padding (reference: UnnestOperator's per-row element
    loop, vectorized)."""
    blk = page.block(array_channel)
    dic = blk.dictionary
    vals = [tuple(v) for v in (dic.values if dic is not None else [])]
    n = max(len(vals), 1)
    L = max((len(v) for v in vals), default=0) or 1
    lens = np.zeros(n, np.int64)
    string_elem = elem_type.is_dictionary_encoded
    if string_elem:
        uniq: dict = {}
        for v in vals:
            for x in v:
                if x is not None:
                    uniq.setdefault(x, len(uniq))
        edic = Dictionary(list(uniq))
        flat = np.zeros((n, L), np.int32)
    else:
        edic = None
        flat = np.zeros((n, L), np.dtype(elem_type.numpy_dtype))
    enull = np.ones((n, L), bool)
    for vi, v in enumerate(vals):
        lens[vi] = len(v)
        for k, x in enumerate(v):
            if x is None:
                continue
            enull[vi, k] = False
            flat[vi, k] = uniq[x] if string_elem else x
    dev = page.device
    idx = torch.arange(page.capacity * L, dtype=torch.int64, device=dev)
    i, k = idx // L, idx % L
    codes = blk.data.to(torch.int64).clamp(0, n - 1)[i]
    valid = page.valid[i] & (k < consts.lut(lens, dev)[codes])
    if blk.nulls is not None:
        valid = valid & ~blk.nulls[i]
    src = gather_rows(page, i, valid)
    pos = codes * L + k
    eblock = Block(data=consts.lut(flat.reshape(-1), dev)[pos],
                   type=elem_type,
                   nulls=consts.lut(enull.reshape(-1), dev)[pos],
                   dictionary=edic)
    blocks = src.blocks + (eblock,)
    if with_ordinality:
        blocks += (Block(data=k + 1, type=T.BIGINT),)
    return Page(blocks=blocks, valid=valid)


def _group_id_page(key_channels, mask, set_index, page: Page) -> Page:
    """One grouping-set replica: keys absent from the set nulled, the
    constant gid channel appended."""
    blocks = list(page.blocks)
    ones = torch.ones(page.capacity, dtype=torch.bool, device=page.device)
    for kc, keep in zip(key_channels, mask):
        if not keep:
            b = blocks[kc]
            blocks[kc] = Block(data=b.data, type=b.type, nulls=ones,
                               dictionary=b.dictionary)
    gid = Block(data=torch.full((page.capacity,), set_index,
                                dtype=torch.int64, device=page.device),
                type=T.BIGINT)
    return Page(blocks=tuple(blocks) + (gid,), valid=page.valid)


def _cross_join_page(page: Page, build: Page) -> Page:
    nb = build.capacity
    idx = torch.arange(page.capacity * nb, dtype=torch.int64,
                       device=page.device)
    li, ri = idx // nb, idx % nb
    valid = page.valid[li] & build.valid[ri]
    left = gather_rows(page, li, valid)
    right = gather_rows(build, ri, valid)
    return Page(blocks=left.blocks + right.blocks, valid=valid)
