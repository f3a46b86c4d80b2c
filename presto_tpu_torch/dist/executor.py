"""DistExecutor: interpret a fragmented plan over a mesh of shards.

Port of presto_tpu/dist/executor.py (reference: the worker-side
execution of exchanges — operator/PartitionedOutputOperator.java and
operator/ExchangeOperator.java — plus LocalExecutionPlanner wiring).

The reference's mesh is ONE process driving D devices: a page is one
global array per column, sharded row-wise, each sharded operator a
``shard_map`` body and each exchange a collective inside that program.
The port keeps that shape — one process, one executor, D shards:

  - ``make_mesh(n)`` places shard i on device i % k of the k visible
    devices of the executor's device type. One H100 holds every shard
    (k = 1), the way the reference's tests put 8 shards on one host's
    CPU; a box with more cards puts one shard per card;
  - a SHARDED page is a ``ShardedPage``: D per-shard Pages of equal
    capacity, shard i on its shard's device (the reference's global
    array, row range i); a REPLICATED page is a plain Page on the
    executor's device, copied to each other mesh device a shard there
    reads it on (``_replicas``);
  - a ``shard_map`` body is a loop of the same page function over the
    shards, each launching its kernels on its shard's device;
  - the collectives are plain torch over shard lists: all_to_all
    (``_all_to_all``: shards on different cards build each sender's
    [D, R] send layout, receiver j taking the j-th slice of every
    sender over a peer copy; shards that share a card land through one
    stable sort of the concatenated senders, which orders their rows
    the same way), all_gather(tiled) (concatenation onto the
    executor's device), and psum of an overflow flag (an OR over the
    shards, deferred to the executor's overflow ladder like every
    other flag: no host read per page). A loop in one thread has no
    rendezvous to misorder, so the reference's ``_fenced`` (collectives
    serialized against XLA's CPU runtime) has no counterpart.

Shard-local operators reuse the single-device page functions unchanged.
Replicated subtrees run the inherited single-stream code. The mesh runs
op by op: it captures no CUDA graph (_fused_stream is off), as the
reference's sharded operators bypass its fused path.

Result-cache residency: only REPLICATED subtrees become cache points
(``_cache_subtree_ok``): their pages are plain Pages a host replay
reproduces, where a sharded subtree's ShardedPage layout is not. A hit
stages its host pages onto the executor's device (the inherited
``_stage_replay``), which IS the replicated representation: _replicas
copies it to each other mesh device where a shard reads it. At the
root, the host sink reaches through Output and gather/broadcast
exchanges over a replicated source (``_sink_chain_ids``), so a root
hit crosses nothing.

The ICI exchange plane (``ici_exchange_pages``) lowers a spooled
repartition edge of the stage DAG to the same all_to_all when the
producer stage's spools and the consumer stage's readers live in this
process (dist/scheduler.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch import resolve_device
from presto_tpu_torch import types as T
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec import shapes as SH
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.exec.executor import (
    Executor,
    MemoryBudgetExceeded,
    _build_join_index,
    _cross_join_page,
    _empty_page,
    _final_agg_page,
    _group_id_page,
    _next_pow2,
    _null_blocks,
    _partial_agg_page,
    _partial_global_agg,
    _probe_join_page,
    _project_page,
    _semi_join_page,
    _unnest_page,
)
from presto_tpu_torch.exec.pagestore import page_bytes
from presto_tpu_torch.expr.eval import evaluate_filter
from presto_tpu_torch.ops import hashing as H
from presto_tpu_torch.ops import keys as K
from presto_tpu_torch.ops import u64
from presto_tpu_torch.ops.compact import compact_page, concat_all, slice_page
from presto_tpu_torch.page import Block, Page

SHARDED = "sharded"
REPLICATED = "replicated"

# the most shards a process mesh holds on one device type: the
# reference's test mesh (8 virtual CPU devices). The ICI plane's
# eligibility reads it where the reference reads len(jax.devices()),
# so one card still takes the plane (ROADMAP: observations)
MESH_MAX_SHARDS = 8


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh's shard placement: ``devices[i]`` holds shard i."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards over the visible devices of the
    executor's device type (default: one shard per visible device).
    Shard i goes to device i % k. ``device=None`` means the card and
    raises without one, like every other entry point."""
    base = resolve_device(device)
    k = torch.cuda.device_count() if base.type == "cuda" else 1
    n = n_devices or k
    if k <= 1:
        return Mesh(tuple(base for _ in range(n)))
    return Mesh(tuple(torch.device(base.type, i % k) for i in range(n)))


@dataclasses.dataclass
class ShardedPage:
    """A page sharded row-wise over the mesh: shard i is rows
    [i * R, (i + 1) * R) of the reference's global array, R the
    per-shard capacity."""

    shards: Tuple[Page, ...]

    @property
    def capacity(self) -> int:
        """The global capacity (the reference's page.capacity)."""
        return sum(s.capacity for s in self.shards)

    @property
    def local_capacity(self) -> int:
        return self.shards[0].capacity

    def num_rows(self) -> torch.Tensor:
        """Selected rows over every shard, a device scalar on shard 0's
        device (no host sync)."""
        dev = self.shards[0].device
        return torch.stack([_to_dev(s.num_rows(), dev)
                            for s in self.shards]).sum()


# ---------------------------------------------------------------- moves
def _to_dev(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One tensor onto another mesh device: a peer copy between cards,
    the tensor itself on its own device."""
    if t.device == device:
        return t
    # xfercheck: raw-ok - device-to-device peer copy between mesh devices
    return t.to(device, non_blocking=True)


def _move(page: Page, device: torch.device) -> Page:
    """A page onto another mesh device (the all_to_all's per-receiver
    hop; one card: the page itself)."""
    if page.device == device:
        return page

    def mv(b: Block) -> Block:
        data = (tuple(_to_dev(d, device) for d in b.data)
                if isinstance(b.data, tuple) else _to_dev(b.data, device))
        nulls = _to_dev(b.nulls, device) if b.nulls is not None else None
        return b.with_data(data, nulls=nulls)

    return Page(blocks=tuple(mv(b) for b in page.blocks),
                valid=_to_dev(page.valid, device))


def _any(flags: Sequence[torch.Tensor], device) -> torch.Tensor:
    """psum(flag) > 0 over shards: an OR of device scalars, on
    ``device``."""
    return torch.stack([_to_dev(f.reshape(()), device)
                        for f in flags]).any()


def _all_to_all(senders: Sequence[Page], tgts: Sequence[torch.Tensor],
                devices: Sequence[torch.device], out_cap: int):
    """The all_to_all of a hash repartition. ``tgts[i]`` is sender i's
    per-row destination in [0, D), D for rows that drop (invalid). Each
    receiver j lands the rows routed to it in (sender, row) order — the
    reference's [D, R] send layout, all_to_all and stable compaction —
    and keeps the first ``out_cap``. Returns (D receiver pages of
    ``out_cap`` rows, shard j on devices[j]; the [D] rows routed to each
    receiver, on devices[0] — more than out_cap is an overflow).

    Shards that share one device skip the send layout: ONE stable sort
    of the concatenated senders by destination orders every receiver's
    rows exactly as the landing zones would, in a fifth of the send
    layout's time or less on one card (chip_a2a.py; PERF.md)."""
    D = len(devices)
    dev0 = devices[0]
    if all(d == dev0 for d in devices):
        glob = concat_all(list(senders))
        key = torch.cat([t.to(torch.int64) for t in tgts])
        order = torch.argsort(key, stable=True)
        nums = torch.bincount(key, minlength=D + 1)[:D]
        starts = torch.cumsum(nums, 0) - nums
        slot = torch.arange(out_cap, dtype=torch.int64, device=dev0)
        outs = []
        for j in range(D):
            src = order[(starts[j] + slot).clamp(max=glob.capacity - 1)]
            outs.append(Page(blocks=tuple(b.take(src) for b in glob.blocks),
                             valid=slot < nums[j]))
        return outs, nums
    sends: List[List[Page]] = []
    for pg, t in zip(senders, tgts):
        r = pg.capacity
        t = t.to(torch.int64)
        order = torch.argsort(t, stable=True)
        nums = torch.bincount(t, minlength=D + 1)[:D]
        starts = torch.cumsum(nums, 0) - nums
        slot = torch.arange(r, dtype=torch.int64, device=pg.device)
        row = []
        for j in range(D):
            src = order[(starts[j] + slot).clamp(max=r - 1)]
            row.append(Page(blocks=tuple(b.take(src) for b in pg.blocks),
                            valid=slot < nums[j]))
        sends.append(row)
    outs, nums = [], []
    for j in range(D):
        landing = concat_all([_move(sends[i][j], devices[j])
                              for i in range(D)])
        nums.append(_to_dev(landing.num_rows(), dev0))
        outs.append(compact_page(landing, out_cap))
    return outs, torch.stack(nums)


def _key_hash(page: Page, keys: Tuple[int, ...]) -> torch.Tensor:
    """The repartition routing hash: the executor's equality-encoded
    key hash (splitmix64 fold, ops/hashing.py), bit for bit the
    reference's ``H.hash_columns``."""
    cols, nulls = K.block_key_columns([page.block(c) for c in keys])
    return H.hash_columns(cols, nulls)


class DistExecutor(Executor):
    """Executes plans produced by dist.fragmenter.add_exchanges over a
    Mesh. Page distribution is tracked statically per node ("sharded"
    over the mesh vs "replicated"); replicated subtrees run the
    inherited single-stream code paths, sharded nodes run their page
    functions once per shard."""

    def __init__(self, catalogs, mesh: Mesh, **kw):
        kw.setdefault("device", mesh.devices[0])
        super().__init__(catalogs, **kw)
        self.mesh = mesh
        self.D = mesh.size
        self._dist_cache: Dict[int, tuple] = {}
        # hash_partition_count session property: devices that RECEIVE
        # repartitioned rows (0 = whole mesh). Routing and residue
        # filters share _route_devices so both sides of a partitioned
        # stage agree on the partition function
        self.hash_partitions = 0

    def _route_devices(self) -> int:
        """Shards used for repartitioned stages (hash_partition_count):
        hash routing targets shards 0..P-1; the whole mesh still runs
        every page function."""
        hp = int(self.hash_partitions or 0)
        return min(hp, self.D) if hp > 0 else self.D

    # ------------------------------------------------- memory governor
    def _budget(self) -> int:
        """Mesh-wide device-memory budget: the per-device share (the
        inherited resolution) times the number of devices the mesh
        occupies. The dominant governed buffers — partitioned join
        builds, repartitioned aggregation state — are sharded row-wise,
        so the mesh holds that many devices' shares. On CUDA that is
        the number of distinct cards: 4 shards on one H100 share its
        80 GB, and a budget of 4 cards would promise memory that does
        not exist. On the CPU it is the shard count, the reference's
        rule for its virtual devices."""
        if self.device.type == "cuda":
            n = len(self.mesh.distinct_devices())
        else:
            n = self.D
        return self.device_budget() * n

    def device_budget(self) -> int:
        """One device's budget (the inherited resolution): the share a
        replicated (broadcast) build must fit, since every shard on a
        device reads the one copy there."""
        return super()._budget()

    def _account_page(self, page) -> None:
        """A sharded page counts its global footprint, every shard (the
        reference's global array)."""
        if not isinstance(page, ShardedPage):
            super()._account_page(page)
            return
        size = sum(page_bytes(s) for s in page.shards)
        self.peak_memory_bytes = max(self.peak_memory_bytes, size)
        if (self.max_memory_bytes is not None
                and size > self.max_memory_bytes):
            raise MemoryBudgetExceeded(
                f"page footprint {size} bytes exceeds query memory limit "
                f"{self.max_memory_bytes} (reference: "
                f"ExceededMemoryLimitException)")

    # ---------------------------------------------------------- dist tags
    def dist(self, node: P.PhysicalNode) -> str:
        # keyed by id() with the node itself retained: a bare id key goes
        # stale when a collected plan node's address is reused
        key = id(node)
        hit = self._dist_cache.get(key)
        if hit is None or hit[0] is not node:
            self._dist_cache[key] = (node, self._compute_dist(node))
        return self._dist_cache[key][1]

    def _compute_dist(self, node) -> str:
        if isinstance(node, P.TableScan):
            return SHARDED
        if isinstance(node, P.Values):
            return REPLICATED
        if isinstance(node, P.Exchange):
            return SHARDED if node.kind == "repartition" else REPLICATED
        if isinstance(node, (P.HashJoin, P.CrossJoin)):
            return self.dist(node.left)
        if isinstance(node, P.Union):
            return self.dist(node.sources[0])
        children = node.children()
        return self.dist(children[0]) if children else REPLICATED

    # ------------------------------------------------ cache residency
    def _cache_subtree_ok(self, node: P.PhysicalNode) -> bool:
        """Only REPLICATED subtrees may become result-cache points: their
        pages are plain Pages a host replay reproduces, so a mesh query
        with an uncacheable root still caches its gathered interior.
        A sharded subtree's ShardedPages carry a per-shard layout a
        replay could not rebuild."""
        return self.dist(node) == REPLICATED

    def _sink_chain_ids(self, node) -> frozenset:
        """The mesh's host-sink chain: besides the Output pass-through, a
        gather/broadcast Exchange over an already-REPLICATED source
        yields its source's pages unchanged (_exec_exchange), so a cache
        point below it serves host pages straight to result decode —
        zero h2d and d2h on the hit."""
        ids = {id(node)}
        while True:
            if isinstance(node, P.Output):
                node = node.source
            elif (isinstance(node, P.Exchange)
                    and node.kind in ("gather", "broadcast")
                    and self.dist(node.source) == REPLICATED):
                node = node.source
            else:
                break
            ids.add(id(node))
        return frozenset(ids)

    def _replicated_subtree(self, node: P.PhysicalNode) -> bool:
        return self.dist(node) == REPLICATED and all(
            self.dist(c) == REPLICATED for c in node.children())

    # ------------------------------------------------------------- pages
    def _pages_impl(self, node: P.PhysicalNode) -> Iterator:
        if isinstance(node, P.Exchange):
            yield from self._exec_exchange(node)
            return
        if self._replicated_subtree(node):
            yield from super()._pages_impl(node)
            return
        if isinstance(node, P.TableScan):
            yield from self._scan_sharded(node)
            return
        if isinstance(node, P.Filter):
            fn = self._shard_page_kernel(
                functools.partial(evaluate_filter, node.predicate))
            for page in self.pages(node.source):
                yield fn(page)
            return
        if isinstance(node, P.Project):
            fn = self._shard_page_kernel(
                functools.partial(_project_page, node.exprs))
            for page in self.pages(node.source):
                yield fn(page)
            return
        if isinstance(node, P.Aggregation):
            yield from self._dist_aggregation(node)
            return
        if isinstance(node, P.HashJoin):
            yield from self._dist_join(node)
            return
        if isinstance(node, P.CrossJoin):
            yield from self._dist_cross_join(node)
            return
        if isinstance(node, P.UniqueId):
            yield from self._dist_unique_id(node)
            return
        if isinstance(node, P.Unnest):
            fn = self._shard_page_kernel(functools.partial(
                _unnest_page, node.array_channel, node.element_type,
                node.with_ordinality))
            for page in self.pages(node.source):
                yield fn(page)
            return
        if isinstance(node, P.GroupId):
            fns = [self._shard_page_kernel(functools.partial(
                _group_id_page, node.key_channels, mask, si))
                for si, mask in enumerate(node.set_masks)]
            for page in self.pages(node.source):
                for fn in fns:
                    yield fn(page)
            return
        if isinstance(node, P.Union):
            for src in node.sources:
                yield from self.pages(src)
            return
        if isinstance(node, P.Output):
            yield from self.pages(node.source)
            return
        raise TypeError(
            f"DistExecutor: node {type(node).__name__} requires a "
            f"replicated input (fragmenter should have inserted a gather)")

    def _run_attempt(self, node, emit, cancelled):
        """A plan whose root stays sharded gathers at the output, as the
        reference's host read of a sharded global array does."""
        return super()._run_attempt(
            node, lambda page: emit(self._replicated(page)), cancelled)

    # ----------------------------------------------------------- helpers
    def _fused_stream(self, node, agg_tail=None, key_extra=None):
        """No whole-pipeline fusion on the mesh: its sharded operators run
        op by op per shard, as the reference's bypass its fused path."""
        return None

    def _lazy_probe_ok(self, node: P.PhysicalNode) -> bool:
        """Late materialization only along fully-replicated probe
        spines: sharded subtrees speak materialized ShardedPages."""
        return self._late_mat_on() and self._replicated_subtree(node)

    def _lazy_pages(self, node: P.PhysicalNode):
        if self._lazy_probe_ok(node):
            yield from super()._lazy_pages(node)
            return
        yield from self.pages(node)

    def _shard_page_kernel(self, fn):
        """A pure page -> page function as a shard-local map over a
        ShardedPage (the reference's shard_map wrapper)."""

        def mapped(page: ShardedPage) -> ShardedPage:
            return ShardedPage(tuple(fn(s) for s in page.shards))

        return mapped

    def _replicas(self, page: Page) -> List[Page]:
        """Per shard, its device's copy of a replicated page (one copy
        per distinct device; one card: the page itself)."""
        by_dev = {d: _move(page, d) for d in self.mesh.distinct_devices()}
        return [by_dev[d] for d in self.mesh.devices]

    def _replicated(self, page):
        """all_gather(tiled): a ShardedPage concatenated onto the
        executor's device; a replicated page passes."""
        if not isinstance(page, ShardedPage):
            return page
        return concat_all([_move(s, self.device) for s in page.shards])

    # -------------------------------------------------------------- scan
    def _scan_sharded(self, node: P.TableScan) -> Iterator[ShardedPage]:
        """One round of D splits per sharded page: shard i generates
        split r * D + i; the tail round pads with starts past the table,
        whose rows the range mask drops."""
        conn = self.catalogs[node.catalog]
        schema = conn.table_schema(node.table)
        names = tuple(node.columns)
        splits = conn.splits(node.table, target_rows=self.page_rows)
        n = splits[0].row_count
        total = splits[-1].start_row + splits[-1].row_count
        if total == 0:
            return
        body = conn.gen_body(node.table, n, names)
        if body is None:
            yield from self._scan_staged(node, conn, names)
            return
        dicts = getattr(conn, "_dicts", {}).get(node.table, {})
        types = [schema.column_type(nm) for nm in names]
        starts = [s.start_row for s in splits]
        for r in range(0, len(starts), self.D):
            chunk = starts[r:r + self.D]
            real = len(chunk)
            chunk = chunk + [total] * (self.D - real)
            shards = []
            for start, dev in zip(chunk, self.mesh.devices):
                datas, valid = body(start)
                in_range = (start + torch.arange(
                    n, dtype=torch.int64, device=valid.device)) < total
                page = Page(blocks=tuple(
                    Block(data=d, type=t, nulls=None,
                          dictionary=dicts.get(nm))
                    for nm, t, d in zip(names, types, datas)),
                    valid=valid & in_range)
                shards.append(_move(page, dev))
            # a mesh round is one launch covering D splits, the
            # accounting the split-batched local scan reports
            self.program_launches += 1
            self.splits_scanned += real
            yield ShardedPage(tuple(shards))

    def _scan_staged(self, node, conn, names) -> Iterator[ShardedPage]:
        """Page connectors (the memory connector): each round of D
        pages becomes one sharded page, padded to one capacity."""
        pages = list(conn.pages(node.table, names,
                                target_rows=self.page_rows))
        if not pages:
            return
        cap = max(p.capacity for p in pages)
        for r in range(0, len(pages), self.D):
            yield _stack_to_mesh(pages[r:r + self.D], cap, self.mesh)

    # --------------------------------------------------------- exchanges
    def _exec_exchange(self, node: P.Exchange) -> Iterator:
        src_dist = self.dist(node.source)
        if node.kind in ("gather", "broadcast"):
            if src_dist == REPLICATED:
                yield from self.pages(node.source)
                return
            # the collective never leaves the device: the zero-crossing
            # contract the spooled mesh-local fast path counts
            self.count_mesh_local()
            for page in self.pages(node.source):
                yield self._replicated(page)
            return
        if node.kind == "repartition":
            self.count_mesh_local()
            if src_dist == REPLICATED:
                # replicated -> sharded: each shard keeps its hash
                # residues (a disjoint split, no data movement)
                fn = self._residue_fn(node.keys)
            else:
                fn = self._repartition_fn(node.keys)
            for page in self.pages(node.source):
                out, overflow = fn(page)
                if overflow is not None:
                    self._pending_overflow.append(overflow)
                yield out
            return
        raise ValueError(f"unknown exchange kind {node.kind!r}")

    def _repartition_fn(self, keys: Tuple[int, ...]):
        """hash(keys) % P routing through the all_to_all — the
        PartitionedOutputOperator -> ExchangeOperator data plane. The
        landing capacity rides the boosted-retry ladder: a skewed key
        routing most rows to one shard overflows the 2R default and the
        query retries with the landing capacity boosted."""
        D = self.D
        nparts = self._route_devices()  # hash_partition_count (<= D)
        boost = self._capacity_boost
        devices = self.mesh.devices

        def fn(page: ShardedPage):
            R = page.local_capacity
            tgts = []
            for s in page.shards:
                tgt = u64.umod(_key_hash(s, keys), nparts)
                tgts.append(torch.where(s.valid, tgt, D))
            out_cap = min(D * R, _next_pow2(2 * R * boost))
            outs, nums = _all_to_all(page.shards, tgts, devices, out_cap)
            return ShardedPage(tuple(outs)), (nums > out_cap).any()

        return fn

    def _residue_fn(self, keys: Tuple[int, ...]):
        """Replicated -> sharded: shard i keeps the rows with
        hash(keys) % P == i (no data movement: the replica is local)."""
        nparts = self._route_devices()  # must agree with _repartition_fn

        def fn(page: Page):
            h = u64.umod(_key_hash(page, keys), nparts)
            shards = []
            for me, rep in enumerate(self._replicas(page)):
                mine = _to_dev(h, rep.device) == me
                shards.append(rep.with_valid(rep.valid & mine))
            return ShardedPage(tuple(shards)), None

        return fn

    # ------------------------------------------------------- aggregation
    def _dist_aggregation(self, node: P.Aggregation) -> Iterator:
        src_dist = self.dist(node.source)
        if node.step == "partial" and src_dist == SHARDED:
            in_types = self._agg_in_types(node)
            layouts = self._layouts(node, in_types)
            # K1 runs per shard on the card, as on the single device
            self._count_agg_kernel()
            if not node.group_channels:
                fn = self._shard_page_kernel(functools.partial(
                    _partial_global_agg, node.aggregates, layouts,
                    kernels=self.kernels))
                for page in self.pages(node.source):
                    yield fn(page)
                return
            cap = _next_pow2(node.capacity * self._capacity_boost)
            max_iters = 64 * self._capacity_boost
            for page in self.pages(node.source):
                local_cap = min(cap, _next_pow2(page.local_capacity))
                outs, flags = [], []
                for s in page.shards:
                    out, ovf = _partial_agg_page(
                        node.group_channels, node.aggregates, layouts, s,
                        local_cap, max_iters, kernels=self.kernels,
                        collect_k=self._collect_k_eff)
                    outs.append(out)
                    flags.append(ovf)
                self._pending_overflow.append(_any(flags, self.device))
                yield ShardedPage(tuple(outs))
            return
        if node.step == "final" and src_dist == SHARDED:
            # repartitioned state pages: keys are co-located per shard,
            # the final step runs shard-locally
            origin = self._partial_origin(node)
            in_types = self._agg_in_types(origin)
            layouts = self._layouts(node, in_types)
            pages = list(self.pages(node.source))
            if not pages:
                return
            local_caps = tuple(p.local_capacity for p in pages)
            fcap = min(_next_pow2(node.capacity * self._capacity_boost),
                       _next_pow2(sum(local_caps)))
            max_iters = 64 * self._capacity_boost
            outs, flags = [], []
            for j in range(self.D):
                shard_pages = [p.shards[j] for p in pages]
                merged = (concat_all(shard_pages) if len(shard_pages) > 1
                          else shard_pages[0])
                out, ovf = _final_agg_page(
                    node.group_channels, node.aggregates, layouts,
                    in_types, merged, fcap, max_iters,
                    collect_k=self._collect_k_eff,
                    extra_types=self._agg_extra_types(origin))
                outs.append(out)
                flags.append(ovf)
            self._pending_overflow.append(_any(flags, self.device))
            yield ShardedPage(tuple(outs))
            return
        # replicated input: the inherited single-stream paths
        yield from super()._exec_aggregation(node)

    # -------------------------------------------------------------- join
    def _dist_join(self, node: P.HashJoin) -> Iterator:
        dl, dr = self.dist(node.left), self.dist(node.right)
        gj = self._generated_join_info(node, self.output_types(node.left))
        if gj is not None:
            # the build-free generated join is shard-local: each shard
            # inverts its probe keys and GENERATES the carried build
            # columns — no broadcast, no repartition, no build
            yield from self._dist_join_generated(node, gj, dl)
            return
        if dl == REPLICATED and dr == REPLICATED:
            yield from super()._exec_join(node)
            return
        yield from self._dist_join_materialized(node, dl, dr)

    def _dist_join_generated(self, node: P.HashJoin, info, dl
                             ) -> Iterator:
        self.generated_joins_used += 1
        kern, windowed = self.generated_join_kernel(node, info)
        for page in self.pages(node.left):
            shards = page.shards if dl == SHARDED else (page,)
            if not windowed:
                outs = tuple(kern(s) for s in shards)
            else:
                res = [kern(s) for s in shards]
                outs = tuple(o for o, _m in res)
                # > 1 in-window matches on any shard: the retry takes
                # the general join
                self._pending_overflow.append(
                    _any([m for _o, m in res], self.device))
            yield ShardedPage(outs) if dl == SHARDED else outs[0]

    def _dist_join_materialized(self, node: P.HashJoin, dl, dr
                                ) -> Iterator[ShardedPage]:
        if dl == REPLICATED:
            raise TypeError(
                "DistExecutor: a replicated probe over a sharded build "
                "(fragmenter should have gathered the build)")
        # build side: replicated (broadcast) or sharded (partitioned)
        build_pages = list(self.pages(node.right))
        right_types = self.output_types(node.right)
        left_types = self.output_types(node.left)
        if dr == REPLICATED:
            if not build_pages:
                build_pages = [_empty_page(right_types, self.device,
                                           cap=self.D * 8)]
            build_all = concat_all(build_pages)
            builds = self._replicas(build_all)
            local_build_cap = build_all.capacity
        else:
            if not build_pages:
                build_pages = [ShardedPage(tuple(
                    _empty_page(right_types, d, cap=8)
                    for d in self.mesh.devices))]
            builds = [concat_all([p.shards[j] for p in build_pages])
                      for j in range(self.D)]
            local_build_cap = builds[0].capacity

        if node.join_type in ("semi", "anti"):
            built = [{} for _ in builds]  # each shard's build half, once
            for page in self.pages(node.left):
                yield ShardedPage(tuple(
                    _semi_join_page(node.left_keys, node.right_keys, s, b,
                                    h)
                    for s, b, h in zip(page.shards, builds, built)))
            return

        matched_acc = None
        for page in self.pages(node.left):
            # the reference's per-shard output capacity, under the
            # single-device join's ceiling (Executor._join_pass): join
            # outputs feed the next exchange, whose landing capacity
            # scales with them, so an unbounded 2x per join compounds
            # down a chain of partitioned joins
            oc = min(max(page.local_capacity, local_build_cap) * 2,
                     max(4 * self.page_rows, 1 << 19))
            oc = _next_pow2(oc * self._capacity_boost)
            outs, flags, matched = [], [], []
            for s, b in zip(page.shards, builds):
                index = _build_join_index(node.left_keys, node.right_keys,
                                          s, b)
                out, m, ovf = _probe_join_page(
                    node.left_keys, node.right_keys, node.join_type, False,
                    s, b, index, oc)
                outs.append(out)
                flags.append(ovf)
                matched.append(m)
            self._pending_overflow.append(_any(flags, self.device))
            if dr == REPLICATED:
                # matched refers to replicated build rows: OR the shards'
                # views so outer emission sees every match
                matched = _any_rows(matched, self.device)
                matched_acc = (matched if matched_acc is None
                               else matched_acc | matched)
            else:
                matched_acc = (matched if matched_acc is None
                               else [a | m for a, m in zip(matched_acc,
                                                           matched)])
            yield ShardedPage(tuple(outs))
        if node.join_type in ("right", "full"):
            if matched_acc is None:  # no probe page at all
                matched_acc = (
                    torch.zeros(local_build_cap, dtype=torch.bool,
                                device=self.device)
                    if dr == REPLICATED else
                    [torch.zeros(b.capacity, dtype=torch.bool,
                                 device=b.device) for b in builds])
            yield self._outer_build_rows(builds, matched_acc, left_types, dr)

    def _outer_build_rows(self, builds, matched, left_types, dr
                          ) -> ShardedPage:
        """Unmatched build rows with a null probe side. A replicated
        build is emitted once per hash residue of its row index, so the
        sharded stream holds each row exactly once."""
        shards = []
        for me, b in enumerate(builds):
            if dr == REPLICATED:
                m = _to_dev(matched, b.device)
                idx = torch.arange(b.capacity, dtype=torch.int64,
                                   device=b.device)
                unmatched = b.valid & ~m & ((idx % self.D) == me)
            else:
                unmatched = b.valid & ~matched[me]
            nulls = _null_blocks(left_types, b.capacity, b.device)
            shards.append(Page(blocks=tuple(nulls) + b.blocks,
                               valid=unmatched))
        return ShardedPage(tuple(shards))

    def _dist_cross_join(self, node: P.CrossJoin) -> Iterator[ShardedPage]:
        # the fragmenter guarantees the right side is replicated
        right_pages = list(self.pages(node.right))
        if not right_pages:
            return
        build_all = concat_all(right_pages)
        bcap = min(_next_pow2(build_all.capacity),
                   _next_pow2(4096 * self._capacity_boost))
        self._pending_overflow.append(build_all.num_rows() > bcap)
        builds = self._replicas(compact_page(build_all, bcap))
        for page in self.pages(node.left):
            yield ShardedPage(tuple(
                _cross_join_page(s, b)
                for s, b in zip(page.shards, builds)))

    def _dist_unique_id(self, node: P.UniqueId) -> Iterator[ShardedPage]:
        """A globally unique bigint per row: the shard index in the high
        bits, the global slot offset plus the local slot below."""
        offset = 0
        for page in self.pages(node.source):
            shards = []
            for me, s in enumerate(page.shards):
                ids = ((me << 40) + offset + torch.arange(
                    s.capacity, dtype=torch.int64, device=s.device))
                shards.append(Page(
                    blocks=s.blocks + (Block(data=ids, type=T.BIGINT),),
                    valid=s.valid))
            yield ShardedPage(tuple(shards))
            offset += page.capacity


def _any_rows(masks: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Row-wise OR of per-shard bool masks over one replicated page
    (psum(matched) > 0), on ``device``."""
    out = _to_dev(masks[0], device)
    for m in masks[1:]:
        out = out | _to_dev(m, device)
    return out


def _pad_page(page: Page, cap: int) -> Page:
    """A page padded with masked-off rows to ``cap`` slots."""
    extra = cap - page.capacity
    if extra <= 0:
        return page

    def pad(t, fill=0):
        return torch.cat([t, torch.full((extra,), fill, dtype=t.dtype,
                                        device=t.device)])

    blocks = []
    for b in page.blocks:
        data = (tuple(pad(d) for d in b.data) if isinstance(b.data, tuple)
                else pad(b.data))
        nulls = pad(b.nulls, False) if b.nulls is not None else None
        blocks.append(b.with_data(data, nulls=nulls))
    return Page(blocks=tuple(blocks), valid=pad(page.valid, False))


def _stack_to_mesh(pages: List[Page], cap: int, mesh: Mesh) -> ShardedPage:
    """Up to D connector pages as one sharded page: page i becomes shard
    i on its device, every shard padded to ``cap``; missing shards are
    empty."""
    first = pages[0]
    shards = []
    for i, dev in enumerate(mesh.devices):
        if i < len(pages):
            shards.append(_pad_page(_move(pages[i], dev), cap))
            continue
        blank = Page(blocks=tuple(
            b.with_data(
                tuple(torch.zeros(cap, dtype=d.dtype, device=dev)
                      for d in b.data) if isinstance(b.data, tuple)
                else torch.zeros(cap, dtype=b.data.dtype, device=dev),
                nulls=None)
            for b in first.blocks),
            valid=torch.zeros(cap, dtype=torch.bool, device=dev))
        shards.append(blank)
    return ShardedPage(tuple(shards))


# ---------------------------------------------------------------------
# ICI exchange plane: lower a spooled repartition edge to the in-process
# all_to_all when the producer stage's spools and the consumer stage's
# readers are co-resident on ONE process mesh. The spool plane stays
# authoritative for remote consumers and for replay/fault recovery; this
# plane only replaces the partition -> spool -> read hop with one
# collective over the mesh (on one card, a routed on-device copy).


def ici_exchange_supported(nparts: int, pages) -> bool:
    """Static shape gate for ``ici_exchange_pages``: partition p maps to
    mesh shard p, so the partition count must be a power of two a
    process mesh can hold (MESH_MAX_SHARDS), and every page's capacity
    must shard evenly across it. Anything else stays on the spool plane
    — a shape, never an error."""
    if nparts < 2 or (nparts & (nparts - 1)) != 0:
        return False
    if nparts > MESH_MAX_SHARDS:
        return False
    return all(p.capacity % nparts == 0 for p in pages)


_ICI_MESHES: Dict[tuple, Mesh] = {}


def _ici_mesh(d: int, device: torch.device) -> Mesh:
    """One mesh per (shard count, device type): a benign-race cache
    (a lost write builds an equal mesh)."""
    key = (d, device.type)
    if key not in _ICI_MESHES:
        _ICI_MESHES[key] = make_mesh(d, device=device.type)
    return _ICI_MESHES[key]


def ici_routes_with_k4(ex) -> bool:
    """The partition function the spool plane would use for this
    executor's session: K4 (ops/cuda_part.py) when the kernels are on
    and the spool partitions on the device, splitmix64 otherwise. The
    ICI plane routes with it, so a mid-query fallback, or one side of a
    co-partitioned join left on the spools, lands every row in the same
    partition."""
    return ex._pallas_exchange_on() and ex._device_exchange_on()


def _ici_program(ex, mesh: Mesh, page: Page, keys: Tuple[int, ...],
                 k4: bool, out_cap: int):
    """The per-page exchange: the page sharded row-wise over the mesh,
    shard-local partition ids (K4 or splitmix64, ``ici_routes_with_k4``)
    + all_to_all + compaction to ``out_cap``, the spool partitioner's
    landing capacity. The reference caches a compiled program per
    exchange geometry; nothing compiles here. Returns (the nparts
    partition pages, the [nparts] rows routed to each)."""
    from presto_tpu_torch.dist import spool as SPOOL
    from presto_tpu_torch.ops import cuda_part as CP

    d = mesh.size
    r = page.capacity // d
    shards, tgts = [], []
    luts_by_dev: Dict[torch.device, tuple] = {}
    for i, dev in enumerate(mesh.devices):
        s = _move(slice_page(page, i * r, r), dev)
        if dev not in luts_by_dev:
            luts_by_dev[dev] = SPOOL._dict_luts(s, keys)
        luts = luts_by_dev[dev]
        if k4:
            ex.pallas_kernels_used += 1
            part = CP.part_ids(SPOOL.part_id_encodings(s, keys, luts), d)
        else:
            part = u64.umod(SPOOL.device_row_hash_u64(s, keys, luts), d)
        shards.append(s)
        tgts.append(torch.where(s.valid, part.to(torch.int64), d))
    return _all_to_all(shards, tgts, mesh.devices, out_cap)


def ici_exchange_pages(ex, pages, keys: Tuple[int, ...], nparts: int):
    """Exchange spooled raw producer pages into ``nparts`` partition
    page lists over the mesh — one all_to_all per raw page, no
    serialization and no host hop for page data (device-resident inputs
    stage with zero metered bytes; a host-resident input pays its h2d
    once).

    Returns ``(parts, ici_bytes, counts)``: ``parts[p]`` is the list
    of partition pages consumer task p reads, ``ici_bytes`` the byte
    footprint routed through the exchange and ``counts`` the settled
    [pages, nparts] row counts (host int64): input page i sent
    ``counts[i, p]`` rows to partition p, the exact statistics the
    spool plane's tasks report.

    Overflow settles HERE (the coordinator owns this exchange; there is
    no worker attempt loop to defer into): an overflowing round re-runs
    EVERY page at the next ladder rung, counting
    ``capacity_boost_retries``. The round's one host read is the row
    count of every landing page (``ici-counts``, 8 bytes per page and
    partition, the spool plane's stats pull): it settles the overflow
    and trims each landing page to the ladder bucket of its rows,
    dropping empty ones, as the device-tier spool does. Untrimmed
    landing pages would carry the 2x landing slack into the next stage,
    compounding down a chain of repartitioned joins."""
    from presto_tpu_torch.dist import spool as SPOOL

    pages = list(pages)
    if not ici_exchange_supported(nparts, pages):
        raise ValueError(
            f"ici exchange unsupported: nparts={nparts} over a mesh of "
            f"at most {MESH_MAX_SHARDS} shards, caps="
            f"{[p.capacity for p in pages]}")
    mesh = _ici_mesh(nparts, ex.device)
    k4 = ici_routes_with_k4(ex)
    staged = [XF.to_device(p, mesh.devices[0], label="ici-exchange-stage")
              for p in pages]
    ici_bytes = sum(page_bytes(p) for p in staged)
    if not staged:
        return ([[] for _ in range(nparts)], 0,
                np.zeros((0, nparts), dtype=np.int64))
    boost = ex._capacity_boost
    while True:
        outs, nums, caps = [], [], []
        for pg in staged:
            out_cap = SH.exchange_partition_cap(pg.capacity, nparts, boost)
            parts_i, nums_i = _ici_program(ex, mesh, pg, keys, k4, out_cap)
            outs.append(parts_i)
            nums.append(nums_i)
            caps.append(out_cap)
        counts = XF.np_host(torch.stack(nums), label="ici-counts")
        if all((c <= cap).all() for c, cap in zip(counts, caps)):
            break
        boost = SH.next_boost(boost)
        ex.capacity_boost_retries += 1
        if boost > SH.DEVICE_FAULT_ROWS:
            raise RuntimeError(
                "ici exchange overflow did not settle on the boost ladder")
    parts: List[List[Page]] = [[] for _ in range(nparts)]
    for parts_i, counts_i in zip(outs, counts):
        # shard p of the exchanged page IS partition p
        for p in range(nparts):
            rows = int(counts_i[p])
            if rows:
                parts[p].append(SPOOL.trim_partition_page(parts_i[p], rows))
    return parts, ici_bytes, np.asarray(counts, dtype=np.int64)
