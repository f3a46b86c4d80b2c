"""Pre-launch plan verifier: machine-check the engine's plan invariants
before anything runs on the device.

Port of presto_tpu/exec/plan_check.py (reference: presto-main's
sql/planner/sanity/PlanSanityChecker — a validation pass over every
finished plan that runs in tests and can be enabled in production,
catching planner drift at plan time instead of as a wrong answer three
operators later):

  1. SCHEMA-CONSISTENT EDGES — every operator edge and inter-fragment
     exchange agrees on channel count and type family; expression
     channel references resolve inside their input's width; exchange
     partition symbols agree on both sides of a co-partitioned join.
  2. LADDER-QUANTIZED CAPACITIES — every buffer the executor will
     allocate (membudget.audit shares the executor's sizing verbatim)
     lands ON the shapes.py bucket ladder and under the device-memory
     governor's budget. The reference's device fault-line check has no
     counterpart: the port has no fault line.
  3. CANONICAL PROGRAM-KEY MATERIAL — plan content that feeds program
     cache keys (exec/graphs.py keys its captured graphs by plan nodes)
     is identity-free and order-free, and re-keying the same plan twice
     is byte-identical (plan_serde roundtrip).
  4. DETERMINISTIC SPLIT ASSIGNMENT — every distributable task payload
     carries the (splitIndex, splitCount) fields a re-dispatched task
     re-generates its splits from; hash-mode payloads name real
     partition columns.

Wiring: ``Executor._verify_plan`` runs ``verify`` when the
``plan_check`` session property enables it — "auto" is ON under pytest
(or when PRESTO_TPU_PLAN_CHECK opts in) and OFF on the serving path;
the DCN scheduler checks every dispatched payload and the stage DAG the
same way. Violations raise PlanCheckError with pointed messages: which
node, which invariant, what to fix.
"""

from __future__ import annotations

import decimal
import math
from typing import List, Optional

from presto_tpu_torch import types as T
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec import shapes as SH
from presto_tpu_torch.expr.ir import InputRef, RowExpression


class PlanCheckError(ValueError):
    """One or more plan invariants failed pre-compile. `violations`
    holds every finding (the verifier does not stop at the first)."""

    def __init__(self, violations: List[str]):
        self.violations = list(violations)
        lines = "\n  - ".join(self.violations)
        super().__init__(
            f"plan verification failed ({len(self.violations)} "
            f"violation{'s' if len(self.violations) != 1 else ''}):"
            f"\n  - {lines}"
        )


_JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti")
_EXCHANGE_KINDS = ("repartition", "broadcast", "gather")
_AGG_STEPS = ("single", "partial", "final")

# canonical scalar atoms allowed in plan (= jit-key) material; dicts
# are rejected for ordering-dependence, arbitrary objects because
# their identity/repr leaks id() into keys
_CANONICAL_ATOMS = (type(None), bool, int, float, str, bytes,
                    decimal.Decimal)


def _family(t) -> str:
    """Coarse type family for edge-compatibility checks. Deliberately
    lenient — numeric/temporal types inter-operate throughout the
    engine (dates are day counts, decimals are unscaled ints), so only
    unambiguous mismatches (string vs numeric, boolean vs anything,
    mismatched complex types) flag."""
    if isinstance(t, T.UnknownType):
        return "any"
    if isinstance(t, T.BooleanType):
        return "boolean"
    if T.is_string(t):
        return "string"
    if isinstance(t, (T.VarbinaryType,)):
        return "varbinary"
    if isinstance(t, (T.ArrayType, T.MapType, T.RowType,
                      T.HllStateType, T.CollectStateType)):
        return type(t).__name__
    return "scalar"


def _compatible(a, b) -> bool:
    fa, fb = _family(a), _family(b)
    return fa == "any" or fb == "any" or fa == fb


def _label(node) -> str:
    return type(node).__name__


class _Verifier:
    def __init__(self, ex, plan, strict: bool = False):
        self.ex = ex
        self.plan = plan
        self.strict = strict
        self.violations: List[str] = []
        self._types = {}  # id(node) -> output types (memo)

    def add(self, node, msg: str) -> None:
        self.violations.append(f"{_label(node)}: {msg}")

    def types_of(self, node) -> Optional[list]:
        key = id(node)
        if key not in self._types:
            try:
                self._types[key] = self.ex.output_types(node)
            except Exception as e:  # noqa: BLE001 - converted to finding
                self._types[key] = None
                self.add(node, f"output schema is unresolvable: {e} "
                               f"(fix the plan edge or the catalog "
                               f"binding before execution)")
        return self._types[key]

    def width_of(self, node) -> Optional[int]:
        t = self.types_of(node)
        return None if t is None else len(t)

    # ------------------------------------------------- expression edges
    def check_expr(self, node, expr: RowExpression, src_types,
                   what: str) -> None:
        if isinstance(expr, InputRef):
            if not (0 <= expr.channel < len(src_types)):
                self.add(node, f"{what} references channel "
                               f"#{expr.channel} but the input has "
                               f"only {len(src_types)} channels "
                               f"(0..{len(src_types) - 1}) — a stale "
                               f"channel mapping from a rewrite")
            elif not _compatible(expr.type, src_types[expr.channel]):
                self.add(node, f"{what} reads channel #{expr.channel} "
                               f"as {expr.type} but the input edge "
                               f"carries {src_types[expr.channel]} — "
                               f"schema-inconsistent edge")
        for child in expr.children():
            self.check_expr(node, child, src_types, what)

    def _check_channels(self, node, channels, width, what) -> None:
        for ch in channels:
            if not (0 <= ch < width):
                self.add(node, f"{what} channel #{ch} out of range "
                               f"for a {width}-channel input "
                               f"(0..{width - 1})")

    # ----------------------------------------------------- node checks
    def check_node(self, node) -> None:
        if isinstance(node, P.TableScan):
            self._check_scan(node)
        elif isinstance(node, P.Values):
            for i, row in enumerate(node.rows):
                if len(row) != len(node.types):
                    self.add(node, f"row {i} has {len(row)} values "
                                   f"for {len(node.types)} declared "
                                   f"types")
        elif isinstance(node, P.Filter):
            src = self.types_of(node.source)
            if src is not None:
                self.check_expr(node, node.predicate, src, "predicate")
                if _family(node.predicate.type) not in ("boolean",
                                                        "any"):
                    self.add(node, f"predicate type is "
                                   f"{node.predicate.type}, expected "
                                   f"boolean")
        elif isinstance(node, P.Project):
            src = self.types_of(node.source)
            if src is not None:
                for i, e in enumerate(node.exprs):
                    self.check_expr(node, e, src, f"expr #{i}")
        elif isinstance(node, P.Aggregation):
            self._check_agg(node)
        elif isinstance(node, P.HashJoin):
            self._check_join(node)
        elif isinstance(node, P.Union):
            self._check_union(node)
        elif isinstance(node, P.Exchange):
            self._check_exchange(node)
        elif isinstance(node, P.Output):
            w = self.width_of(node.source)
            if w is not None and len(node.names) != w:
                self.add(node, f"{len(node.names)} output names for "
                               f"{w} channels")
        elif isinstance(node, P.RemoteSource):
            self._check_remote(node)
        elif isinstance(node, P.Sort):
            w = self.width_of(node.source)
            if w is not None:
                self._check_channels(
                    node, (k.channel for k in node.keys), w, "sort key")
        elif isinstance(node, P.TopN):
            w = self.width_of(node.source)
            if w is not None:
                self._check_channels(
                    node, (k.channel for k in node.keys), w, "sort key")
            if node.limit < 0:
                self.add(node, f"negative limit {node.limit}")
        elif isinstance(node, P.Limit):
            if node.count < 0 or node.offset < 0:
                self.add(node, f"negative count/offset "
                               f"({node.count}, {node.offset})")
        elif isinstance(node, P.Window):
            self._check_window(node)
        elif isinstance(node, P.MarkDistinct):
            w = self.width_of(node.source)
            if w is not None:
                for ks in node.mark_channel_sets:
                    self._check_channels(node, ks, w, "mark key")
        elif isinstance(node, P.GroupId):
            w = self.width_of(node.source)
            if w is not None:
                self._check_channels(node, node.key_channels, w,
                                     "grouping key")
            for i, m in enumerate(node.set_masks):
                if len(m) != len(node.key_channels):
                    self.add(node, f"set_masks[{i}] has {len(m)} "
                                   f"entries for "
                                   f"{len(node.key_channels)} keys")
        elif isinstance(node, P.Unnest):
            src = self.types_of(node.source)
            if src is not None:
                self._check_channels(node, (node.array_channel,),
                                     len(src), "array")

    def _check_scan(self, node: P.TableScan) -> None:
        conn = self.ex.catalogs.get(node.catalog)
        if conn is None:
            self.add(node, f"unknown catalog {node.catalog!r} "
                           f"(known: {sorted(self.ex.catalogs)})")
            return
        try:
            schema = conn.table_schema(node.table)
            known = set(schema.column_names())
        except Exception as e:  # noqa: BLE001 - converted to finding
            self.add(node, f"table {node.catalog}.{node.table} is "
                           f"unresolvable: {e}")
            return
        for c in node.columns:
            if c not in known:
                self.add(node, f"column {c!r} not in "
                               f"{node.catalog}.{node.table} "
                               f"(known: {sorted(known)})")
        for entry in node.constraint or ():
            if len(entry) != 3 or not isinstance(entry[0], str):
                self.add(node, f"malformed constraint entry "
                               f"{entry!r} (want (column, lo, hi))")
            elif entry[0] not in known:
                self.add(node, f"constraint column {entry[0]!r} not "
                               f"in {node.catalog}.{node.table}")

    def _check_agg(self, node: P.Aggregation) -> None:
        if node.step not in _AGG_STEPS:
            self.add(node, f"unknown step {node.step!r} "
                           f"(want one of {_AGG_STEPS})")
        if node.capacity < 0:
            self.add(node, f"negative group capacity {node.capacity}")
        src = self.types_of(node.source)
        if src is None:
            return
        self._check_channels(node, node.group_channels, len(src),
                             "group")
        if node.step == "final":
            # a final step's aggregate channels index the PARTIAL's
            # original input (recovered via origin), not the state
            # page — range checks happen on the partial fragment
            return
        for i, spec in enumerate(node.aggregates):
            chans = [c for c in (spec.channel, spec.mask) if c is not None]
            chans += list(spec.extra_channels)
            self._check_channels(node, chans, len(src),
                                 f"aggregate #{i} ({spec.function})")
            if spec.mask is not None and 0 <= spec.mask < len(src) \
                    and _family(src[spec.mask]) not in ("boolean",
                                                        "any"):
                self.add(node, f"aggregate #{i} mask channel "
                               f"#{spec.mask} is {src[spec.mask]}, "
                               f"expected boolean")

    def _check_join(self, node: P.HashJoin) -> None:
        if node.join_type not in _JOIN_TYPES:
            self.add(node, f"unknown join_type {node.join_type!r}")
        if len(node.left_keys) != len(node.right_keys):
            self.add(node, f"key arity mismatch: {len(node.left_keys)} "
                           f"left vs {len(node.right_keys)} right "
                           f"equi-join keys")
        if not node.left_keys:
            self.add(node, "equi-join with no keys (use CrossJoin for "
                           "a join without equality conditions)")
        lt, rt = self.types_of(node.left), self.types_of(node.right)
        if lt is not None:
            self._check_channels(node, node.left_keys, len(lt),
                                 "left key")
        if rt is not None:
            self._check_channels(node, node.right_keys, len(rt),
                                 "right key")
        if lt is not None and rt is not None:
            for lk, rk in zip(node.left_keys, node.right_keys):
                if 0 <= lk < len(lt) and 0 <= rk < len(rt) and \
                        not _compatible(lt[lk], rt[rk]):
                    self.add(node, f"key type mismatch: left #{lk} "
                                   f"({lt[lk]}) vs right #{rk} "
                                   f"({rt[rk]}) — rows can never "
                                   f"match across this edge")
        # inter-fragment exchange agreement: a co-partitioned join's
        # repartition exchanges must hash on exactly the join keys on
        # BOTH sides, or matching rows land on different shards
        left_ex = node.left if isinstance(node.left, P.Exchange) else None
        right_ex = (node.right if isinstance(node.right, P.Exchange)
                    else None)
        if left_ex is not None and right_ex is not None and \
                left_ex.kind == "repartition" and \
                right_ex.kind == "repartition":
            if tuple(left_ex.keys) != tuple(node.left_keys) or \
                    tuple(right_ex.keys) != tuple(node.right_keys):
                self.add(node, f"exchange partitioning disagrees with "
                               f"the join keys: left repartitions on "
                               f"{tuple(left_ex.keys)} vs join keys "
                               f"{tuple(node.left_keys)}, right on "
                               f"{tuple(right_ex.keys)} vs "
                               f"{tuple(node.right_keys)} — "
                               f"co-partitioned rows would not "
                               f"co-locate")

    def _check_union(self, node: P.Union) -> None:
        if not node.sources:
            self.add(node, "union of zero sources")
            return
        first = self.types_of(node.sources[0])
        if first is None:
            return
        for i, s in enumerate(node.sources[1:], 1):
            ts = self.types_of(s)
            if ts is None:
                continue
            if len(ts) != len(first):
                self.add(node, f"source #{i} emits {len(ts)} channels "
                               f"vs source #0's {len(first)}")
                continue
            for ch, (a, b) in enumerate(zip(first, ts)):
                if not _compatible(a, b):
                    self.add(node, f"source #{i} channel #{ch} is "
                                   f"{b}, source #0 carries {a} — "
                                   f"union branches disagree")

    def _check_exchange(self, node: P.Exchange) -> None:
        if node.kind not in _EXCHANGE_KINDS:
            self.add(node, f"unknown kind {node.kind!r} "
                           f"(want one of {_EXCHANGE_KINDS})")
        w = self.width_of(node.source)
        if node.kind == "repartition":
            if not node.keys:
                self.add(node, "repartition exchange with no "
                               "partition keys")
            elif w is not None:
                self._check_channels(node, node.keys, w, "partition")
        elif node.keys:
            self.add(node, f"{node.kind} exchange carries partition "
                           f"keys {tuple(node.keys)} — only "
                           f"repartition partitions by key")

    def _check_remote(self, node: P.RemoteSource) -> None:
        if not node.types:
            self.add(node, "no declared channel types for the "
                           "fragment edge")
        if node.origin is not None:
            ot = self.types_of(node.origin)
            if ot is None:
                return
            if len(ot) != len(node.types):
                self.add(node, f"declares {len(node.types)} channels "
                               f"but the remote fragment emits "
                               f"{len(ot)} — schema-inconsistent "
                               f"fragment edge")
            else:
                for ch, (a, b) in enumerate(zip(node.types, ot)):
                    if not _compatible(a, b):
                        self.add(node, f"channel #{ch} declared {a} "
                                       f"but the remote fragment "
                                       f"emits {b}")

    def _check_window(self, node: P.Window) -> None:
        src = self.types_of(node.source)
        if src is None:
            return
        self._check_channels(node, node.partition_channels, len(src),
                             "partition")
        self._check_channels(node, (k.channel for k in node.order_keys),
                             len(src), "order key")
        for i, fn in enumerate(node.functions):
            ch = getattr(fn, "arg_channel", None)
            if ch is not None:
                self._check_channels(node, (ch,), len(src),
                                     f"window fn #{i} arg")

    # -------------------------------------------- capacity / ladder
    def check_capacities(self) -> None:
        """Every buffer the executor WILL allocate (the membudget
        audit shares the executor's sizing verbatim) must sit ON the
        shapes.py ladder and under the governor's budget."""
        from presto_tpu_torch.exec import membudget as MB

        try:
            report = MB.audit(self.ex, self.plan)
        except Exception as e:  # noqa: BLE001 - converted to finding
            self.violations.append(
                f"membudget audit failed: {e} (the plan cannot be "
                f"sized statically — fix the schema findings first)")
            return
        check_buffers(report, self.violations, strict=self.strict)

    # --------------------------------------------- jit-key canonical
    def check_canonical_keys(self) -> None:
        check_canonical_key_material(self.plan, self.violations)

    # ---------------------------------------------------------- run
    def run(self) -> None:
        seen = set()

        def walk(n):
            if id(n) in seen:  # shared subtrees verify once
                return
            seen.add(id(n))
            self.check_node(n)
            if isinstance(n, P.RemoteSource) and n.origin is not None:
                walk(n.origin)
            for c in n.children():
                walk(c)

        walk(self.plan)
        # schema findings first: capacity/key passes consume
        # output_types and serde, which presuppose resolvable edges
        if not self.violations:
            self.check_capacities()
            self.check_canonical_keys()


def check_buffers(report, violations: List[str],
                  strict: bool = False) -> None:
    """Ladder and budget checks over one membudget AuditReport
    (factored out so the mutation tests can drive it directly).

    strict=False (the per-query auto gate) exempts blocking
    whole-input merges (sort/window/markdistinct — '... merge'
    labels): they have NO chunked rewrite yet, the audit deliberately
    over-estimates them, and a test-forced tiny budget must not fail a
    query the engine executes correctly. strict=True enforces every
    buffer."""
    for b in report.buffers:
        if b.rows != SH.bucket(b.rows):
            violations.append(
                f"buffer '{b.label}' capacity {b.rows} is OFF the "
                f"shapes.py bucket ladder (nearest rungs "
                f"{SH.bucket(b.rows) >> 1}/{SH.bucket(b.rows)}) — a "
                f"sizing path bypassed SH.bucket and will mint a "
                f"fresh program shape")
    no_rewrite = (lambda b: not strict and b.label.endswith(" merge"))
    for b in report.over_budget():
        if no_rewrite(b):
            continue
        violations.append(
            f"buffer '{b.label}' plans {b.bytes} bytes, past the "
            f"device-memory budget ({report.budget} bytes) — the "
            f"governed sizing paths should have clamped this buffer "
            f"to its budget share")


def check_canonical_key_material(plan, violations: List[str]) -> None:
    """Program-cache keys are built from plan content (exec/graphs.py
    keys captured graphs by plan nodes): that content must be
    identity-free and order-free, and re-keying the same plan twice
    must be byte-identical."""
    from presto_tpu_torch.dist import plan_serde

    bad = []

    def walk(x, path):
        if isinstance(x, _CANONICAL_ATOMS):
            if isinstance(x, float) and not math.isfinite(x):
                return  # serde tags non-finite floats canonically
            return
        if isinstance(x, tuple):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
            return
        if isinstance(x, dict):
            bad.append(f"{path}: dict (iteration-order-dependent — "
                       f"use a sorted tuple of pairs)")
            return
        if isinstance(x, (list, set, frozenset, bytearray)):
            bad.append(f"{path}: {type(x).__name__} (mutable/"
                       f"unordered — use a tuple)")
            return
        import dataclasses as _dc

        if _dc.is_dataclass(x) and not isinstance(x, type):
            for f in _dc.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}")
            return
        bad.append(f"{path}: {type(x).__name__} object (its repr/"
                   f"hash depends on object identity — id() leaks "
                   f"into the program cache key)")

    walk(plan, _label(plan))
    for b in bad[:8]:
        violations.append(f"non-canonical jit-key material at {b}")
    if bad:
        return
    try:
        b1 = plan_serde.dumps(plan)
        b2 = plan_serde.dumps(plan_serde.loads(b1))
    except Exception as e:  # noqa: BLE001 - converted to finding
        violations.append(
            f"plan is not canonically serializable: {e} — program "
            f"cache keys derived from it cannot be stable")
        return
    if b1 != b2:
        violations.append(
            "re-keying the same plan produced DIFFERENT bytes across "
            "a serde roundtrip — some field depends on object "
            "identity or other non-canonical state")


def verify(ex, plan, strict: bool = False) -> None:
    """Verify one physical plan against an executor's catalogs and
    sizing knobs. Raises PlanCheckError listing EVERY violation with a
    pointed message; returns None on a clean plan. strict=True
    additionally enforces the budget on blocking merges (see
    check_buffers)."""
    v = _Verifier(ex, plan, strict=strict)
    v.run()
    if v.violations:
        raise PlanCheckError(v.violations)


# --------------------------------------------------- task payloads
_PAYLOAD_REQUIRED = ("taskId", "splitIndex", "splitCount")


def check_task_payload(payload: dict) -> None:
    """Verify a DCN task payload carries the deterministic split
    assignment a re-dispatched task depends on: it re-generates EXACTLY
    splitIndex/splitCount's share at the scan, so these fields (not
    worker identity) must define the split set.
    Stage-DAG payloads may instead (or additionally) carry `sources`
    — spooled-exchange input edges a replayed task re-reads — each
    naming concrete producer placements."""
    bad: List[str] = []
    for k in _PAYLOAD_REQUIRED:
        if payload.get(k) is None:
            bad.append(f"task payload missing {k!r} — a retried task "
                       f"could not re-generate its split share "
                       f"deterministically")
    if not bad:
        idx, cnt = int(payload["splitIndex"]), int(payload["splitCount"])
        if not (0 <= idx < cnt):
            bad.append(f"splitIndex {idx} outside [0, splitCount="
                       f"{cnt}) — the split share is undefined")
    sources = payload.get("sources") or {}
    for key, spec in sources.items():
        tasks = (spec or {}).get("tasks")
        if not tasks or not all(
            isinstance(t, dict) and t.get("uri") and t.get("taskId")
            for t in tasks
        ):
            bad.append(f"source {key!r} lacks concrete producer "
                       f"placements (uri + taskId per task) — a "
                       f"replayed consumer could not re-read its "
                       f"spooled inputs")
        if int((spec or {}).get("partition", 0)) < 0:
            bad.append(f"source {key!r} names a negative spool "
                       f"partition")
        plist = (spec or {}).get("partitions")
        if plist is not None and (
            not plist or any(int(p) < 0 for p in plist)
        ):
            bad.append(f"source {key!r} carries an empty/negative "
                       f"adaptive partition list — a broadcast read "
                       f"must name every spooled partition")
    if payload.get("splitMode") == "hash":
        cols = payload.get("partitionColumns")
        if not cols or not isinstance(cols, dict) or not all(
            isinstance(k, str) and "." in k and isinstance(v, str)
            for k, v in cols.items()
        ):
            bad.append("hash splitMode without a catalog.table -> "
                       "column partitionColumns map — co-partitioned "
                       "scans cannot agree on the hash symbol")
    elif not payload.get("splitTable") and not sources:
        bad.append("round-robin task payload missing splitTable — "
                   "workers cannot derive disjoint split shares "
                   "(non-leaf stage-DAG tasks must carry sources "
                   "instead)")
    if payload.get("fragment") is None and not payload.get("sql"):
        bad.append("task payload carries neither a serialized "
                   "fragment nor legacy sql")
    if payload.get("outputPartitions") is not None:
        p = int(payload["outputPartitions"])
        if p < 1:
            bad.append(f"outputPartitions {p} < 1 — the spool would "
                       f"have no buffers")
        if p > 1 and not payload.get("outputKeys"):
            bad.append("repartitioned output (outputPartitions > 1) "
                       "without outputKeys — producers cannot agree "
                       "on the hash symbol")
    if bad:
        raise PlanCheckError(bad)


# ----------------------------------------------------- stage DAGs
def verify_dag(ex, dag, strict: bool = False) -> None:
    """Verify a fragmented stage DAG (dist/fragmenter.fragment_dag):
    every fragment root passes the full single-plan verifier (its
    RemoteSource leaves carry producer origins, so schema agreement is
    checked across EVERY exchange hop), plus the DAG-level invariants
    no single tree can express:

      - every RemoteSource edge resolves to a producer fragment whose
        declared output types it matches;
      - repartition output keys index real producer channels and are
        hash-partitionable across tasks (no dictionary-coded keys —
        codes are producer-local);
      - a join whose BOTH children arrive via repartition edges must
        be co-partitioned on exactly its join keys, or matching rows
        land in different partitions (the fragment-edge analog of the
        in-plan exchange-partitioning check) — unless an adaptive
        read override (dag.reads) drains one side broadcast-style,
        in which case co-location is no longer load-bearing;
      - a "passthrough" edge (the adaptive degrade of a repartition
        producer under a broadcast-flipped join) requires BOTH ends
        sharded: consumer task t reads producer task t's whole
        spool, which is a disjoint split only when task counts agree
        (the scheduler shards both over the same pool).
    """
    from presto_tpu_torch.dist.fragmenter import stage_key

    read_kind = getattr(dag, "read_kind",
                        lambda c, p: dag.fragments[p].output_kind)
    violations: List[str] = []
    by_key = {stage_key(f.fid): f for f in dag.fragments}
    for frag in dag.fragments:
        try:
            verify(ex, frag.root, strict=strict)
        except PlanCheckError as e:
            violations.extend(
                f"stage {frag.fid}: {v}" for v in e.violations
            )
            continue
        if frag.output_kind == "passthrough":
            if not frag.sharded:
                violations.append(
                    f"stage {frag.fid}: passthrough output on an "
                    f"un-sharded fragment — a single producer task "
                    f"cannot feed every consumer task its own "
                    f"disjoint share")
            for c in dag.consumers(frag.fid):
                if not dag.fragments[c].sharded:
                    violations.append(
                        f"stage {frag.fid}: passthrough edge into "
                        f"un-sharded consumer stage {c} — task "
                        f"counts cannot agree")
        if frag.output_kind == "repartition":
            try:
                out = ex.output_types(frag.root)
            except Exception:  # noqa: BLE001 - verified above
                out = None
            if out is not None:
                for k in frag.output_keys:
                    if not (0 <= k < len(out)):
                        violations.append(
                            f"stage {frag.fid}: repartition key "
                            f"#{k} out of range for the fragment's "
                            f"{len(out)}-channel output")
                from presto_tpu_torch.dist.fragmenter import (
                    _keys_repartitionable,
                )

                if all(0 <= k < len(out)
                       for k in frag.output_keys) and \
                        not _keys_repartitionable(out,
                                                  frag.output_keys):
                    violations.append(
                        f"stage {frag.fid}: repartition keys "
                        f"{tuple(frag.output_keys)} include a "
                        f"dictionary-coded channel — codes are "
                        f"producer-local, rows would not co-locate")

    def check_edges(plan, where, consumer_fid):
        def walk(n):
            if isinstance(n, P.RemoteSource) and \
                    n.key.startswith("stage"):
                frag = by_key.get(n.key)
                if frag is None:
                    violations.append(
                        f"{where}: RemoteSource {n.key!r} names no "
                        f"fragment in this DAG")
                else:
                    try:
                        ot = tuple(ex.output_types(frag.root))
                    except Exception:  # noqa: BLE001 - above
                        ot = None
                    # family agreement per channel is the single-plan
                    # verifier's job (via origin); the DAG edge check
                    # pins the arity against the LIVE fragment table
                    if ot is not None and len(n.types) != len(ot):
                        violations.append(
                            f"{where}: RemoteSource {n.key!r} "
                            f"declares {len(n.types)} channels but "
                            f"stage {frag.fid} emits {len(ot)}")
                return
            if isinstance(n, P.HashJoin):
                lsrc = n.left if isinstance(
                    n.left, P.RemoteSource) else None
                rsrc = n.right if isinstance(
                    n.right, P.RemoteSource) else None
                lf = by_key.get(lsrc.key) if lsrc is not None else None
                rf = by_key.get(rsrc.key) if rsrc is not None else None
                if lf is not None and rf is not None and \
                        read_kind(consumer_fid, lf.fid) \
                        == "repartition" and \
                        read_kind(consumer_fid, rf.fid) \
                        == "repartition":
                    if tuple(lf.output_keys) != tuple(n.left_keys) or \
                            tuple(rf.output_keys) != tuple(
                                n.right_keys):
                        violations.append(
                            f"{where}: join consumes repartitioned "
                            f"stages {lf.fid}/{rf.fid} but their "
                            f"partition keys "
                            f"{tuple(lf.output_keys)}/"
                            f"{tuple(rf.output_keys)} disagree with "
                            f"the join keys {tuple(n.left_keys)}/"
                            f"{tuple(n.right_keys)} — co-partitioned "
                            f"rows would not co-locate")
            for c in n.children():
                walk(c)

        walk(plan)

    for frag in dag.fragments:
        check_edges(frag.root, f"stage {frag.fid}", frag.fid)
    check_edges(dag.root, "coordinator fragment", -1)
    if violations:
        raise PlanCheckError(violations)
