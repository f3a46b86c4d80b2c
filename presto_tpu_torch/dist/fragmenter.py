"""Exchange insertion and stage-DAG fragmentation.

Port of presto_tpu/dist/fragmenter.py (reference: presto-main
sql/planner/optimizations/AddExchanges.java — the partitioned-vs-
broadcast join decision, SINGLE gathers before final stages — and
PlanFragmenter.java). `add_exchanges` places Exchange nodes at the
distribution boundaries; `fragment_dag` cuts the exchanged tree at
every Exchange into an explicit DAG of plan fragments (stages) joined
by gather / broadcast / hash-repartition edges, which
dist/scheduler.py walks in dependency order.

Distributions (PartitioningHandle analogs):
  "sharded"    — rows split across tasks (FIXED/SOURCE distribution)
  "replicated" — every task holds all rows
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.exec import plan as P

SHARDED = "sharded"
REPLICATED = "replicated"

# build sides up to this many estimated rows replicate to every task
# (reference: join-distribution-type=broadcast + small-table heuristic)
BROADCAST_ROWS = 1 << 21
# grouped aggregations up to this capacity gather partials to one stream;
# larger ones repartition by group key
GATHER_CAPACITY = 1 << 17


def est_rows(node: P.PhysicalNode, catalogs) -> int:
    """Crude static cardinality estimate (reference: the pre-CBO era's
    source-size heuristics in DetermineJoinDistributionType)."""
    if isinstance(node, P.TableScan):
        return catalogs[node.catalog].row_count(node.table)
    if isinstance(node, P.Values):
        return len(node.rows)
    if isinstance(node, (P.Filter, P.Project, P.UniqueId, P.Exchange)):
        return est_rows(node.source, catalogs)
    if isinstance(node, P.Aggregation):
        base = est_rows(node.source, catalogs)
        return 1 if not node.group_channels else min(base, node.capacity)
    if isinstance(node, P.HashJoin):
        left = est_rows(node.left, catalogs)
        if node.join_type in ("semi", "anti", "left"):
            return left
        return max(left, est_rows(node.right, catalogs))
    if isinstance(node, P.CrossJoin):
        return est_rows(node.left, catalogs) * max(
            est_rows(node.right, catalogs), 1
        )
    if isinstance(node, P.Union):
        return sum(est_rows(s, catalogs) for s in node.sources)
    if isinstance(node, (P.Sort, P.Output, P.Window, P.MarkDistinct)):
        return est_rows(node.source, catalogs)
    if isinstance(node, P.GroupId):
        return est_rows(node.source, catalogs) * len(node.set_masks)
    if isinstance(node, P.Unnest):
        return est_rows(node.source, catalogs) * 4
    if isinstance(node, P.TopN):
        return min(est_rows(node.source, catalogs), node.limit)
    if isinstance(node, P.Limit):
        return min(est_rows(node.source, catalogs),
                   node.count + node.offset)
    return 1 << 30


def _gather(node):
    return P.Exchange(source=node, kind="gather")


def add_exchanges(
    node: P.PhysicalNode,
    catalogs,
    *,
    broadcast_rows: int = BROADCAST_ROWS,
    gather_capacity: int = GATHER_CAPACITY,
    broadcast_bytes: Optional[int] = None,
    row_bytes_of: Optional[Callable[[P.PhysicalNode], int]] = None,
) -> Tuple[P.PhysicalNode, str]:
    """Rewrite a single-stream physical plan into a distributed one.
    Returns (plan', distribution of its output).

    Broadcast-vs-partitioned: with ``broadcast_bytes`` and
    ``row_bytes_of`` (the runner wires them from the connectors' row
    counts and the memory governor's per-device share), a build side
    replicates only when its estimated bytes fit that share and its
    rows stay under the per-buffer ceiling; otherwise when its
    estimated rows fit ``broadcast_rows`` (the reference's row-count
    fallback)."""

    def build_broadcasts(n_right) -> bool:
        rows = est_rows(n_right, catalogs)
        if broadcast_bytes is not None and row_bytes_of is not None:
            from presto_tpu_torch.exec import shapes as SH

            return (rows <= SH.SAFE_BUFFER_ROWS
                    and rows * row_bytes_of(n_right) <= broadcast_bytes)
        return rows <= broadcast_rows

    def rewrite(n) -> Tuple[P.PhysicalNode, str]:
        if isinstance(n, P.TableScan):
            return n, SHARDED
        if isinstance(n, P.Values):
            return n, REPLICATED
        if isinstance(
            n, (P.Filter, P.Project, P.UniqueId, P.GroupId, P.Unnest)
        ):
            # row-local transforms keep their source's distribution
            src, d = rewrite(n.source)
            return dataclasses.replace(n, source=src), d
        if isinstance(n, P.Union):
            parts = [rewrite(s) for s in n.sources]
            if all(d == REPLICATED for _, d in parts):
                return P.Union(tuple(s for s, _ in parts)), REPLICATED
            # a replicated branch concatenated into a sharded stream
            # would duplicate rows per task — gather the sharded ones
            srcs = tuple(
                s if d == REPLICATED else _gather(s) for s, d in parts
            )
            return P.Union(srcs), REPLICATED
        if isinstance(n, P.Aggregation):
            src, d = rewrite(n.source)
            if d == REPLICATED:
                return dataclasses.replace(n, source=src), REPLICATED
            partial = dataclasses.replace(n, source=src, step="partial")
            nkeys = len(n.group_channels)
            if not nkeys or n.capacity <= gather_capacity:
                ex = _gather(partial)
                out_d = REPLICATED
            else:
                ex = P.Exchange(
                    source=partial, kind="repartition",
                    keys=tuple(range(nkeys)),
                )
                out_d = SHARDED
            final = dataclasses.replace(
                n, source=ex, step="final",
                group_channels=tuple(range(nkeys)),
            )
            return final, out_d
        if isinstance(n, P.HashJoin):
            left, dl = rewrite(n.left)
            right, dr = rewrite(n.right)
            if dl == REPLICATED and dr == REPLICATED:
                return dataclasses.replace(
                    n, left=left, right=right), REPLICATED
            if dr == SHARDED:
                if build_broadcasts(n.right):
                    right = P.Exchange(source=right, kind="broadcast")
                    dr = REPLICATED
                elif dl == REPLICATED:
                    right = _gather(right)
                    dr = REPLICATED
                else:
                    # partitioned join: both sides repartition on the
                    # equi-join keys so matching rows co-locate
                    left = P.Exchange(source=left, kind="repartition",
                                      keys=n.left_keys)
                    right = P.Exchange(source=right, kind="repartition",
                                       keys=n.right_keys)
                    return dataclasses.replace(
                        n, left=left, right=right), SHARDED
            # dr now REPLICATED; output follows probe side
            return dataclasses.replace(n, left=left, right=right), dl
        if isinstance(n, P.CrossJoin):
            left, dl = rewrite(n.left)
            right, dr = rewrite(n.right)
            if dl == SHARDED and est_rows(n.left, catalogs) > 0:
                if dr == SHARDED:
                    right = P.Exchange(source=right, kind="broadcast")
                return P.CrossJoin(left, right), SHARDED
            if dr == SHARDED:
                right = _gather(right)
            return P.CrossJoin(left, right), dl
        if isinstance(n, (P.Sort, P.TopN, P.Limit, P.Output, P.Window,
                          P.MarkDistinct)):
            src, d = rewrite(n.source)
            if d == SHARDED:
                src = _gather(src)
            return dataclasses.replace(n, source=src), REPLICATED
        raise TypeError(f"add_exchanges: unknown node {n!r}")

    return rewrite(node)


# ---------------------------------------------------------------------
# Stage-DAG fragmentation (the DCN half of PlanFragmenter.java)

@dataclasses.dataclass(frozen=True)
class Fragment:
    """One stage of a DCN stage DAG.

    root: the fragment's plan subtree; its RemoteSource leaves
        (key="stage<fid>") reference upstream fragments and carry the
        producer root as `origin`.
    inputs: upstream fragment ids this fragment consumes.
    output_kind: "gather"/"broadcast" consumers read every producer
        task's whole spool; "repartition" producers spool P hash
        partitions and consumer task t reads partition t of every
        producer task; "passthrough" (written only by adaptive/, the
        degrade of a repartition producer under a broadcast-flipped
        join) spools ONE partition per task and consumer task t reads
        producer task t's whole spool.
    output_keys: partition channels for a repartition edge.
    sharded: run one task per pooled worker (leaf scans split
        round-robin on split_table; repartition consumers read their
        partition); un-sharded fragments run as ONE task.
    split_table: the table split across a sharded leaf fragment's tasks
        (largest scanned table, SOURCE_DISTRIBUTION pick).
    """

    fid: int
    root: P.PhysicalNode
    inputs: Tuple[int, ...]
    output_kind: str
    output_keys: Tuple[int, ...] = ()
    sharded: bool = True
    split_table: Optional[str] = None


@dataclasses.dataclass
class StageDag:
    """Topologically ordered fragments plus the coordinator-side root
    plan (RemoteSource leaves referencing the final fragments).

    Two fields start empty and are written only by adaptive/ between
    stage dispatches:

    reads: (consumer_fid, producer_fid) -> "broadcast" overrides how a
        consumer ingests an edge whose producer already spooled: a
        repartition spool read broadcast-style drains every partition
        of every producer task (their union is the full output). -1 as
        consumer_fid addresses the coordinator's root fragment.
    hints: fid -> payload hints for not-yet-dispatched fragments
        ({"skew": True} starts the consumer's joins in the
        position-chunked rebalance).
    """

    fragments: List[Fragment]
    root: P.PhysicalNode
    root_inputs: Tuple[int, ...]
    reads: Dict[Tuple[int, int], str] = dataclasses.field(
        default_factory=dict)
    hints: Dict[int, Dict] = dataclasses.field(default_factory=dict)

    def fragment(self, fid: int) -> Fragment:
        return self.fragments[fid]

    def consumers(self, fid: int) -> List[int]:
        return [f.fid for f in self.fragments if fid in f.inputs]

    def read_kind(self, consumer_fid: int, producer_fid: int) -> str:
        """Effective ingest mode of one edge: the producer's spooled
        output_kind unless an adaptive read override redirects it."""
        override = self.reads.get((consumer_fid, producer_fid))
        return override or self.fragments[producer_fid].output_kind


def stage_key(fid: int) -> str:
    """The RemoteSource registry key of fragment fid."""
    return f"stage{fid}"


def _map_children(n: P.PhysicalNode, fn) -> P.PhysicalNode:
    """Rebuild one node with ``fn`` applied to every child field
    (direct PhysicalNode fields and tuples of them)."""
    changes: Dict = {}
    for f in dataclasses.fields(n):
        v = getattr(n, f.name)
        if isinstance(v, P.PhysicalNode):
            nv = fn(v)
            if nv is not v:
                changes[f.name] = nv
        elif isinstance(v, tuple) and v and isinstance(
            v[0], P.PhysicalNode
        ):
            nv = tuple(fn(x) for x in v)
            if any(a is not b for a, b in zip(nv, v)):
                changes[f.name] = nv
    return dataclasses.replace(n, **changes) if changes else n


def clip_for_shipping(n: P.PhysicalNode) -> P.PhysicalNode:
    """Bound a shipped fragment's payload: keep RemoteSource.origin only
    where type resolution needs it (a final-step Aggregation recovers
    its partial's input types through its source's origin), clipped
    recursively, and drop the rest."""
    if isinstance(n, P.Aggregation) and n.step == "final" and \
            isinstance(n.source, P.RemoteSource) and \
            n.source.origin is not None:
        return dataclasses.replace(n, source=dataclasses.replace(
            n.source, origin=clip_for_shipping(n.source.origin)))
    if isinstance(n, P.RemoteSource):
        if n.origin is None:
            return n
        return dataclasses.replace(n, origin=None)
    return _map_children(n, clip_for_shipping)


def _keys_repartitionable(types, keys) -> bool:
    """Dictionary codes are table-local (two producer tasks encode the
    same string with different codes), so string/dictionary keys cannot
    hash-repartition consistently across tasks."""
    for k in keys:
        t = types[k]
        if T.is_string(t) or t.is_dictionary_encoded:
            return False
    return True


def _has_scan(n: P.PhysicalNode) -> bool:
    if isinstance(n, P.TableScan):
        return True
    return any(_has_scan(c) for c in n.children())


def _has_work(n: P.PhysicalNode) -> bool:
    """Worth shipping: a fragment must filter, join, or aggregate to be
    worth a task (generation alone is cheaper than the wire)."""
    if isinstance(n, (P.HashJoin, P.CrossJoin, P.Filter, P.Aggregation,
                      P.Window, P.Sort, P.TopN, P.MarkDistinct)):
        return True
    return any(_has_work(c) for c in n.children())


def _dag_safe(n: P.PhysicalNode) -> bool:
    """Shapes the stage DAG must refuse: right/full outer joins whose
    build side REPLICATES while the probe side is sharded (every task
    would emit the globally unmatched build rows), and UniqueId under a
    sharded subtree (colliding ids across tasks)."""
    if isinstance(n, P.UniqueId):
        return False
    if isinstance(n, P.HashJoin) and n.join_type in ("right", "full"):
        right_broadcast = (
            isinstance(n.right, P.Exchange)
            and n.right.kind == "broadcast"
        ) or not _has_scan_or_repart(n.right)
        if right_broadcast and _has_scan_or_repart(n.left):
            return False
    return all(_dag_safe(c) for c in n.children())


def _has_scan_or_repart(n: P.PhysicalNode) -> bool:
    """Whether a subtree of the EXCHANGED plan is sharded."""
    if isinstance(n, P.TableScan):
        return True
    if isinstance(n, P.Exchange):
        return n.kind == "repartition"
    if isinstance(n, P.RemoteSource):
        return False
    return any(_has_scan_or_repart(c) for c in n.children())


def fragment_dag(
    ex,
    plan: P.PhysicalNode,
    catalogs,
    *,
    broadcast_rows: int = BROADCAST_ROWS,
    gather_capacity: int = GATHER_CAPACITY,
    broadcast_bytes: Optional[int] = None,
    row_bytes_of: Optional[Callable[[P.PhysicalNode], int]] = None,
) -> Optional[StageDag]:
    """Cut ANY single-stream physical plan into a stage DAG.

    Runs add_exchanges, then cuts the tree at every Exchange: the
    subtree below becomes a Fragment and the consumer sees a
    RemoteSource whose declared types are the producer's output schema
    and whose `origin` carries the producer root. Returns None when the
    plan is not worth distributing or not DAG-safe. `ex` is an Executor
    used only for schema resolution (ex.output_types)."""
    from presto_tpu_torch.server.worker import largest_table

    exd, _dist = add_exchanges(plan, catalogs,
                               broadcast_rows=broadcast_rows,
                               gather_capacity=gather_capacity,
                               broadcast_bytes=broadcast_bytes,
                               row_bytes_of=row_bytes_of)
    if not _dag_safe(exd):
        return None
    frags: List[Fragment] = []

    def collect_inputs(n) -> Tuple[int, ...]:
        out: List[int] = []

        def walk(x):
            if isinstance(x, P.RemoteSource):
                if x.key.startswith("stage"):
                    out.append(int(x.key[len("stage"):]))
                return  # origins are metadata, not edges
            for c in x.children():
                walk(c)

        walk(n)
        return tuple(dict.fromkeys(out))

    def cut(n: P.PhysicalNode) -> P.PhysicalNode:
        if isinstance(n, P.Exchange):
            src = cut(n.source)
            kind, keys = n.kind, tuple(n.keys)
            if kind == "repartition" and not _keys_repartitionable(
                ex.output_types(src), keys
            ):
                # dictionary-coded partition keys degrade the edge to a
                # gather (both join sides alike: their key types agree)
                kind, keys = "gather", ()
            inputs = collect_inputs(src)
            sharded = _has_scan(src) or any(
                frags[i].output_kind == "repartition" for i in inputs
            )
            split_table = (
                largest_table(src, catalogs) if _has_scan(src) else None
            )
            fid = len(frags)
            frags.append(Fragment(
                fid=fid, root=src, inputs=inputs, output_kind=kind,
                output_keys=keys, sharded=sharded,
                split_table=split_table,
            ))
            return P.RemoteSource(
                types=tuple(ex.output_types(src)), key=stage_key(fid),
                origin=src,
            )
        return _map_children(n, cut)

    root = cut(exd)
    if not frags:
        return None
    if not any(_has_work(f.root) for f in frags):
        return None  # bare scans: generation is cheaper than the wire

    # post-cut re-check: the dictionary-key degrade above can turn a
    # repartition edge into a gather AFTER _dag_safe ran — refuse a
    # replicated-build right/full join inside a SHARDED fragment
    def _side_sharded(n) -> bool:
        if isinstance(n, P.TableScan):
            return True
        if isinstance(n, P.RemoteSource) and n.key.startswith("stage"):
            fid = int(n.key[len("stage"):])
            return frags[fid].output_kind == "repartition"
        return any(_side_sharded(c) for c in n.children())

    def _cut_safe(n) -> bool:
        if isinstance(n, P.HashJoin) and \
                n.join_type in ("right", "full") and \
                _side_sharded(n.left) and not _side_sharded(n.right):
            return False
        return all(_cut_safe(c) for c in n.children())

    if not all(_cut_safe(f.root) for f in frags if f.sharded):
        return None
    return StageDag(fragments=frags, root=root,
                    root_inputs=collect_inputs(root))
