"""The stage-boundary re-planner (see the package docstring).

Port of presto_tpu/adaptive/replanner.py. Pure DAG surgery: the
Replanner holds the live StageDag, accumulates StageStats observations
as stages complete, and `replan()` mutates the not-yet-dispatched
suffix in place — distribution flips, join re-orders, capacity
re-buckets, skew hints — then re-verifies the whole mutated DAG
through plan_check.verify_dag and ROLLS BACK on any violation. The
scheduler (dist/scheduler.py) is a thin driver. Host-only: nothing
here touches a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

from presto_tpu_torch.adaptive.stats import StageStats
from presto_tpu_torch.dist import fragmenter as F
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec import shapes as SH

# a partition histogram whose max exceeds this multiple of the mean
# marks the exchange skewed — consumers pre-engage the position-
# chunked rebalance instead of discovering the hot key via overflow.
# The histogram is only as fine as the consumer task count, so a hot
# key's measurable ratio is bounded by nparts: 3x is already deep
# skew on small pools while staying far above hash fluctuation
SKEW_RATIO = 3.0

# re-bucket an Aggregation capacity DOWN only for >=4x over-estimates
# (a tightened capacity saves sort/scatter work that scales with
# slots; below 4x the ladder bucket often coincides anyway)
TIGHTEN_FACTOR = 4

# build sides bigger than this multiple of the probe swap sides on an
# inner join (2x: swapping costs a channel-restoring Project, so only
# clear wins re-order)
SWAP_RATIO = 2

# mesh-vs-wire handicap for broadcast flips: a stage whose exchange
# lowered to the mesh all_to_all (StageStats.ici_bytes > 0) would move
# the same bytes back onto the spool serde and the wire if its edge
# flipped to broadcast. The reference's value; the port has not
# measured the ratio on its own planes
ICI_WIRE_RATIO = 16


@dataclasses.dataclass
class ReplanOutcome:
    """What one replan() call did (or why it was rejected)."""

    mutated_fids: List[int]
    dist_flips: int = 0
    capacity_seeds: int = 0
    skew_hints: int = 0
    root_mutated: bool = False
    rejected: bool = False
    reason: str = ""


class Replanner:
    """Re-optimizes a StageDag's not-yet-dispatched suffix from
    observed exchange stats. One instance per query (the
    adaptive_max_replans bound is per query)."""

    def __init__(self, ex, dag, *, broadcast_rows=None,
                 broadcast_bytes=None, max_replans: int = 4,
                 skew_ratio: float = SKEW_RATIO, strict: bool = False):
        self.ex = ex
        self.dag = dag
        self.broadcast_rows = broadcast_rows
        self.broadcast_bytes = broadcast_bytes
        self.max_replans = int(max_replans)
        self.skew_ratio = float(skew_ratio)
        self.strict = strict
        self.stats: Dict[int, StageStats] = {}
        self.replans_applied = 0
        self._dispatched: Set[int] = set()

    # ------------------------------------------------------ observe
    def observe(self, st: StageStats) -> None:
        self.stats[st.fid] = st

    # ------------------------------------------------------ helpers
    @staticmethod
    def _fid_of(n) -> Optional[int]:
        if isinstance(n, P.RemoteSource) and n.key.startswith("stage"):
            try:
                return int(n.key[len("stage"):])
            except ValueError:
                return None
        return None

    def _fits_broadcast(self, st: StageStats) -> bool:
        """The stats-driven broadcast test re-run on MEASURED numbers:
        the whole observed build must fit one device's broadcast byte
        share (or the row threshold when no byte share was wired) and
        stay under the per-buffer row ceiling. The byte test charges
        freight_bytes: broadcast ships the spool once per consumer,
        and the wire bytes after the per-column codecs run under the
        raw bytes the static planner had to assume."""
        if st.rows > SH.SAFE_BUFFER_ROWS:
            return False
        if self.broadcast_bytes is not None:
            budget = int(self.broadcast_bytes)
            if st.ici_bytes > 0:
                # the observed exchange rode the mesh all_to_all: a
                # broadcast flip would ADD spool serde and wire traffic
                # the current plan does not pay, so it must fit a budget
                # shrunk by the reference's handicap
                budget //= ICI_WIRE_RATIO
            return st.freight_bytes <= budget
        if self.broadcast_rows is not None:
            return st.rows <= int(self.broadcast_rows)
        return False

    def _read_kind(self, consumer_fid: int, fid: int) -> str:
        return self.dag.read_kind(consumer_fid, fid)

    # ---------------------------------------------- (a)+(b): joins
    def _try_flip(self, join: P.HashJoin, consumer_fid: int,
                  out: ReplanOutcome) -> Optional[P.PhysicalNode]:
        """One join's runtime distribution decision. Returns a
        replacement node (possibly Project-wrapped after a side
        swap) or None when nothing changed."""
        changed = False
        lf, rf = self._fid_of(join.left), self._fid_of(join.right)
        lst = self.stats.get(lf) if lf is not None else None
        rst = self.stats.get(rf) if rf is not None else None
        wrap = None
        # (b) join re-order, two triggers (inner joins only — swapping
        # an outer join changes which side's rows are preserved):
        #   - both sides observed and the current build is the
        #     clearly-bigger one;
        #   - the PROBE completed tiny (fits a broadcast) while the
        #     build-side producer has not even dispatched — stages run
        #     in topo order and the probe's fragment cuts first, so
        #     this is the window where the flip can still spare the
        #     pending producer its whole repartition pass.
        swap = False
        if join.join_type == "inner" and lst is not None:
            if rst is not None:
                swap = rst.rows > SWAP_RATIO * max(lst.rows, 1)
            else:
                swap = (rf is not None
                        and rf not in self._dispatched
                        and self._fits_broadcast(lst)
                        and self.dag.fragment(lf).output_kind
                        == "repartition"
                        and self._read_kind(consumer_fid, lf)
                        == "repartition")
        if swap:
            # Channel order is part of the join's contract (left
            # channels then right), so the swapped join hides behind
            # a restoring Project.
            lt = self.ex.output_types(join.left)
            rt = self.ex.output_types(join.right)
            join = dataclasses.replace(
                join, left=join.right, right=join.left,
                left_keys=join.right_keys, right_keys=join.left_keys,
            )
            from presto_tpu_torch.expr.ir import InputRef

            exprs = tuple(
                InputRef(len(rt) + i, t) for i, t in enumerate(lt)
            ) + tuple(InputRef(i, t) for i, t in enumerate(rt))

            def wrap(j, _exprs=exprs):
                return P.Project(j, _exprs)

            lf, rf = rf, lf
            lst, rst = rst, lst
            out.dist_flips += 1
            changed = True
        if (rst is not None and rf is not None
                and join.join_type in ("inner", "left", "semi", "anti")
                and self.dag.fragment(rf).output_kind == "repartition"
                and self._read_kind(consumer_fid, rf) == "repartition"
                and self._fits_broadcast(rst)):
            # (a) partitioned -> broadcast: the observed build fits
            # one device's share, so the consumer drains EVERY partition
            # of the already-spooled build (union = full build) and
            # the join stops depending on co-location. right/full
            # joins are excluded — a replicated build would emit its
            # globally-unmatched rows once per task (_dag_safe's
            # rule). The not-yet-dispatched probe-side repartition
            # producer then degrades to a passthrough edge: with a
            # replicated build, ANY disjoint probe split joins
            # correctly, so the producer skips per-page hashing and
            # P-way compaction entirely.
            self.dag.reads[(consumer_fid, rf)] = "broadcast"
            out.dist_flips += 1
            changed = True
            if (lf is not None and lf not in self._dispatched
                    and lf not in self.stats
                    and self.dag.fragment(lf).output_kind
                    == "repartition"
                    and self.dag.fragment(lf).sharded
                    and consumer_fid >= 0
                    and self.dag.fragment(consumer_fid).sharded
                    and self.dag.consumers(lf) == [consumer_fid]):
                self.dag.fragments[lf] = dataclasses.replace(
                    self.dag.fragment(lf),
                    output_kind="passthrough", output_keys=(),
                )
                out.mutated_fids.append(lf)
        if not changed:
            return None
        return wrap(join) if wrap is not None else join

    # ------------------------------------------------ (c): reseeds
    def _observed_input(self, n: P.PhysicalNode,
                        consumer_fid: int) -> Optional[int]:
        """Exact upper bound on ONE consumer task's rows flowing out
        of this subtree, known only when every leaf is an observed
        exchange (or literal rows) under row-bounded operators."""
        fid = self._fid_of(n)
        if fid is not None:
            st = self.stats.get(fid)
            if st is None:
                return None
            return st.observed_rows(self._read_kind(consumer_fid, fid))
        if isinstance(n, P.Values):
            return len(n.rows)
        if isinstance(n, (P.Filter, P.Project)):
            return self._observed_input(n.source, consumer_fid)
        if isinstance(n, P.Limit):
            src = self._observed_input(n.source, consumer_fid)
            return None if src is None else min(
                src, n.count + n.offset)
        if isinstance(n, P.Union):
            parts = [self._observed_input(s, consumer_fid)
                     for s in n.sources]
            if any(p is None for p in parts):
                return None
            return sum(parts)
        return None

    def _reseed(self, root: P.PhysicalNode, consumer_fid: int,
                out: ReplanOutcome) -> P.PhysicalNode:
        """Stamp observed est_rows onto completed RemoteSource edges
        and re-bucket Aggregation capacities whose input cardinality
        is now measured — both quantized onto the shapes.py ladder,
        so mutated fragments share the existing program cache."""

        def walk(n):
            if isinstance(n, P.RemoteSource):
                # stamp the edge node itself; NEVER descend into
                # .origin — origins are verification metadata carrying
                # whole producer subtrees (their interior joins belong
                # to OTHER fragments and must not be flipped/stamped
                # through this consumer's walk)
                fid = self._fid_of(n)
                st = self.stats.get(fid) if fid is not None else None
                if st is not None:
                    est = st.observed_rows(
                        self._read_kind(consumer_fid, fid))
                    if n.est_rows != est:
                        out.capacity_seeds += 1
                        return dataclasses.replace(n, est_rows=est)
                return n
            n2 = F._map_children(n, walk)
            if isinstance(n2, P.Aggregation) and n2.group_channels:
                obs = self._observed_input(n2.source, consumer_fid)
                if obs is not None:
                    # groups <= input rows, so bucket(observed input)
                    # can never overflow — raising kills the boost
                    # ladder on under-estimates, tightening (>=4x
                    # over-estimates only) trims slot-scaled work.
                    # Clamped under the governed buffer ceiling; a
                    # genuinely huge state still takes the governor's
                    # partitioned passes, exactly as a static plan
                    # with honest estimates would.
                    newcap = min(SH.bucket(obs), SH.SAFE_BUFFER_ROWS)
                    oldcap = SH.bucket(n2.capacity)
                    if (newcap > oldcap
                            or newcap * TIGHTEN_FACTOR <= oldcap):
                        out.capacity_seeds += 1
                        return dataclasses.replace(
                            n2, capacity=newcap)
            return n2

        return walk(root)

    # ------------------------------------------------------ replan
    def replan(self, dispatched: Set[int]) -> Optional[ReplanOutcome]:
        """Re-optimize every not-yet-dispatched fragment plus the
        coordinator root from the accumulated stats. Mutates the DAG
        in place and returns the outcome; None = no change. A mutated
        DAG that fails verify_dag (or exceeds adaptive_max_replans)
        rolls back completely — the static plan runs (rejected=True,
        counted loudly by the caller)."""
        if not self.stats or self.max_replans <= 0:
            # max_replans=0 pins observe-only mode: stats accumulate
            # (and surface on the status plane) but the DAG never
            # mutates — a diagnostic setting, not a rejection
            return None
        dag = self.dag
        self._dispatched = set(dispatched)
        snapshot = (list(dag.fragments), dag.root, dict(dag.reads),
                    {k: dict(v) for k, v in dag.hints.items()})
        out = ReplanOutcome(mutated_fids=[])
        changed: Set[int] = set(out.mutated_fids)

        pending = [f.fid for f in dag.fragments
                   if f.fid not in dispatched]

        # (a)+(b): flips and re-orders inside pending fragments
        for fid in pending:
            frag = dag.fragment(fid)

            def walk(n, _fid=fid):
                if isinstance(n, P.RemoteSource):
                    return n  # origins are metadata, not this
                    # fragment's operators (see _reseed)
                n2 = F._map_children(n, walk)
                if isinstance(n2, P.HashJoin):
                    repl = self._try_flip(n2, _fid, out)
                    if repl is not None:
                        return repl
                return n2

            new_root = walk(frag.root)
            if new_root is not frag.root:
                dag.fragments[fid] = dataclasses.replace(
                    dag.fragment(fid), root=new_root)
                changed.add(fid)

        # (c): est stamps + capacity re-buckets (pending + root)
        for fid in pending:
            frag = dag.fragment(fid)
            new_root = self._reseed(frag.root, fid, out)
            if new_root is not frag.root:
                dag.fragments[fid] = dataclasses.replace(
                    frag, root=new_root)
                changed.add(fid)
        new_croot = self._reseed(dag.root, -1, out)
        if new_croot is not dag.root:
            dag.root = new_croot
            out.root_mutated = True

        # (d): skew pre-engagement hints on pending consumers
        for st in self.stats.values():
            if len(st.part_rows) <= 1 or \
                    st.skew_ratio() < self.skew_ratio:
                continue
            for c in dag.consumers(st.fid):
                if c not in dispatched and \
                        not dag.hints.get(c, {}).get("skew"):
                    dag.hints.setdefault(c, {})["skew"] = True
                    out.skew_hints += 1

        changed.update(out.mutated_fids)
        if not changed and not out.root_mutated \
                and not out.skew_hints and not out.dist_flips \
                and not out.capacity_seeds:
            # a reads-only flip (dag.reads mutated, trees untouched)
            # still counts as a mutation: it must verify, respect the
            # replan bound, and report — only a genuinely untouched
            # DAG short-circuits here
            return None

        def rollback():
            dag.fragments[:] = snapshot[0]
            dag.root = snapshot[1]
            dag.reads.clear()
            dag.reads.update(snapshot[2])
            dag.hints.clear()
            dag.hints.update(snapshot[3])

        if self.replans_applied >= self.max_replans:
            rollback()
            return ReplanOutcome(
                mutated_fids=[], rejected=True,
                reason=f"adaptive_max_replans={self.max_replans} "
                       f"reached")
        from presto_tpu_torch.exec import plan_check as PC

        try:
            PC.verify_dag(self.ex, dag, strict=self.strict)
        except PC.PlanCheckError as e:
            # a re-plan the verifier cannot prove rolls back to the
            # static plan, loudly
            rollback()
            return ReplanOutcome(
                mutated_fids=[], rejected=True,
                reason=str(e)[:400])
        self.replans_applied += 1
        out.mutated_fids = sorted(changed)
        return out
