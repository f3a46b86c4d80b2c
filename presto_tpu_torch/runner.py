"""LocalRunner: the full parse -> plan -> prune -> execute pipeline in one
process, on one device or over a mesh of shards.

Port of presto_tpu/runner.py. ``execute`` runs queries and the
reference runner's other statements: EXPLAIN and EXPLAIN ANALYZE (the
plan with each node's wall, pages and rows, and a ``Counters:`` line
from the counter registry, exec/counters.py), CREATE / DROP VIEW
(stored as SQL text, expanded at analysis), PREPARE / EXECUTE /
DEALLOCATE (per user), SET / SHOW SESSION, SHOW TABLES, and CREATE
TABLE AS, INSERT, DELETE, UPDATE (a rewrite through SELECT plus a table
replace) and DROP TABLE on a connector that stores tables (the memory
connector).

Every runner holds the system catalog (connectors/system.py: catalogs,
tables, columns, session_properties, functions; the server adds its
runtime tables and metrics). ``plugins=`` installs plugins (plugin.py):
their connectors join the catalogs, their functions and types the
registries, and at most one contributes the AccessControl
(security.py) the runner consults at statement admission, on every
planned scan (plan-time scalar subqueries included) and on each write,
view, and SET SESSION.

The result cache (presto_tpu_torch/cache/): under
``result_cache_enabled`` the runner binds the process-shared store to
its executor (which serves cacheable subtrees from it, the fragment
level), answers an identical statement from the store's row entries
without executing (the statement level, ``statement_cache_probe`` for
the server's admission), and on every write reclaims the entries that
read the written table. ``result_cache_persist_dir`` adds the
warm-start tier: the first enabled session of a process re-admits the
persisted entries whose snapshot tokens still hold.

A statement that reaches the executor under ``query_trace_enabled`` or
``query_trace_dir`` records a lifecycle trace (presto_tpu_torch/obs/),
kept as ``last_trace`` and written as a Chrome trace to the directory;
control statements record none.

Session properties come as a plain dict (or SET SESSION), validated
through the port's property registry (session.py); a property that asks
for a plane the port lacks raises NotImplementedError. The runner
honours:

  - ``page_rows``: target rows per generated page (split granularity);
  - ``array_agg_max_elements``: the collect aggregates' slots per
    group (the executor's ``collect_k``);
  - ``pallas_join_enabled``: "true" (default) engages the CUDA
    kernels (K1 aggregation, K2/K3 join probes, K4 exchange partition
    ids) at the reference's Pallas dispatch points, "false" keeps every
    aggregate, join and exchange on the torch segment-op, sort-join and
    splitmix64 paths;
  - the reference's default TPC-H path: ``generated_join_enabled``
    (default true), ``fused_partial_agg_enabled`` and
    ``split_batch_size`` ("auto" = on a CUDA device; an integer batch
    forces split batching on any device) and ``tpu_offload_enabled``
    (false = nothing fuses);
  - ``device_exchange_enabled``, ``query_max_run_time`` and the
    distribution knobs the stage-DAG path reads (dist/dcn.py);
  - the memory governor and spill: ``device_memory_budget``,
    ``query_max_memory_bytes``, ``spill_threshold_bytes``,
    ``max_join_build_rows``, ``host_spill_bytes``, ``disk_spill_bytes``,
    ``spill_path``, ``join_skew_rebalance``, and
    ``task_retry_attempts`` as the device-OOM retry budget;
  - ``late_materialization_enabled`` ("auto" = on a CUDA device);
  - the guard and stats planes: ``plan_check`` (the pre-launch plan
    verifier), ``query_trace_enabled``/``query_trace_dir`` and
    ``stats_profile_dir`` (the observed-stats profile store);
  - the HTTP server's: ``cross_query_batching`` and
    ``cross_query_batch_wait_ms`` (the executor's launch batcher), and
    ``estimate_memory``, which sizes the memory arbiter's admission;
  - the result cache's: ``result_cache_enabled``, ``_bytes``,
    ``_ttl_ms``, ``_persist_dir`` and ``_subsumption`` (the DcnRunner
    reads ``_remote_probe``).

With ``mesh=make_mesh(D)`` (dist/executor.py) the runner fragments
every plan with exchanges (dist/fragmenter.add_exchanges, plan-time
scalar subqueries included) and runs it on a DistExecutor over the D
shards; ``dist_options`` pins the fragmenter's knobs
(``broadcast_rows``, ``gather_capacity``), and ``hash_partition_count``
sets how many shards receive repartitioned rows.

Reference: presto-main testing/LocalQueryRunner.java (and, with a
mesh, DistributedQueryRunner: the same engine, with real exchanges).
"""

from __future__ import annotations

import contextvars
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from presto_tpu_torch import obs as OBS
from presto_tpu_torch.exec import membudget as MB
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec.executor import Executor, _row_bytes
from presto_tpu_torch.exec.prune import prune_plan
from presto_tpu_torch.exec.pushdown import push_scan_constraints
from presto_tpu_torch.session import Session
from presto_tpu_torch.sql import ast_nodes as N
from presto_tpu_torch.sql.parser import parse
from presto_tpu_torch.sql.planner import Planner


@dataclasses.dataclass
class QueryResult:
    column_names: List[str]
    rows: List[tuple]
    update_type: Optional[str] = None
    column_types: Optional[List[str]] = None


class LocalRunner:
    """``device=None`` runs on the card and raises without one; the
    tests pass ``device="cpu"``. A ``mesh`` (dist/executor.make_mesh)
    makes this the distributed runner; its shards' devices win over
    ``device``."""

    def __init__(self, catalogs: Dict, default_catalog: str = "tpch",
                 session: Optional[Dict[str, object]] = None,
                 device=None, page_rows: Optional[int] = None,
                 mesh=None, dist_options: Optional[Dict] = None,
                 plugins=()):
        self.catalogs = dict(catalogs)
        from presto_tpu_torch.security import ALLOW_ALL

        self.access_control = ALLOW_ALL
        if plugins:
            from presto_tpu_torch.plugin import install

            for p in plugins:
                install(p, self.catalogs, allow_access_control=True)
                ac = p.access_control()
                if ac is not None:
                    if self.access_control is not ALLOW_ALL:
                        raise ValueError(
                            "multiple plugins contribute access control")
                    self.access_control = ac
        self.default_catalog = default_catalog
        self.session = Session(default_catalog, session)
        # the constructor's page_rows (the server's) applies unless the
        # session sets the property; None = the property's default
        self._ctor_page_rows = page_rows
        self.mesh = mesh
        self.dist_options = dict(dist_options or {})
        if mesh is None:
            self.executor = Executor(self.catalogs, device=device)
        else:
            from presto_tpu_torch.dist.executor import DistExecutor

            self.executor = DistExecutor(self.catalogs, mesh)
        if "system" not in self.catalogs:
            # live engine state as SQL (reference: SystemConnector +
            # information_schema); the executor holds the same dict
            from presto_tpu_torch.connectors.system import (
                SystemConnector,
                install_standard_tables,
            )

            sys_conn = SystemConnector(device=self.executor.device)
            install_standard_tables(sys_conn, self)
            self.catalogs["system"] = sys_conn
        # (catalog, name) -> view SQL text, expanded at analysis
        self.views: Dict[tuple, str] = {}
        # prepared statements keyed by user: one user can neither
        # EXECUTE nor DEALLOCATE another's
        self.prepared: Dict[str, Dict[str, str]] = {}
        # the finished trace of the last traced statement (obs/)
        self.last_trace = None
        # plan-time scalar-subquery plans of the statement being
        # planned: their scans run during planning and fold into the
        # plan as literals, so the statement cache's key folds in their
        # snapshot versions too (reset per plan pass)
        self._scalar_subplans: List = []
        self.apply_session()

    def apply_session(self) -> None:
        """Push the session's executor knobs onto the executor; anchors
        the query deadline (query_max_run_time) at the call."""
        s, ex = self.session, self.executor
        # an EXPLICIT session page_rows wins over the constructor's (the
        # server re-sessions one runner per query, and a previous
        # session's override must not leak)
        ex.page_rows = int(s.get("page_rows")) if (
            s.is_set("page_rows") or self._ctor_page_rows is None
        ) else self._ctor_page_rows
        ex.collect_k = int(s.get("array_agg_max_elements"))
        ex.kernels = s.get("pallas_join_enabled") == "true"
        ex.device_exchange = s.get("device_exchange_enabled")
        ex.offload = bool(s.get("tpu_offload_enabled"))
        ex.generated_join = bool(s.get("generated_join_enabled"))
        ex.agg_fusion = s.get("fused_partial_agg_enabled")
        sb = s.get("split_batch_size")
        # "auto" resolves per device inside the executor; a number
        # forces that max batch
        ex.split_batch = int(sb) if sb.isdigit() else (
            "auto" if sb == "auto" else 0)
        # memory governor, spill tiers and the device-OOM ladder, wired
        # as presto_tpu/runner.py wires them (0 = off / auto)
        ex.max_memory_bytes = int(s.get("query_max_memory_bytes")) or None
        ex.spill_bytes = int(s.get("spill_threshold_bytes")) or None
        ex.host_spill_bytes = int(s.get("host_spill_bytes")) or None
        ex.disk_spill_bytes = int(s.get("disk_spill_bytes")) or None
        ex.spill_path = s.get("spill_path") or None
        ex.join_skew_rebalance = bool(s.get("join_skew_rebalance"))
        ex.max_build_rows = int(s.get("max_join_build_rows")) or None
        ex.device_memory_budget = int(s.get("device_memory_budget"))
        # shards receiving repartitioned rows (0 = the whole mesh), read
        # by DistExecutor._route_devices; no effect on one device
        ex.hash_partitions = int(s.get("hash_partition_count"))
        ex.late_mat = s.get("late_materialization_enabled")
        # the executor's device-OOM re-entries share the task retry
        # budget (the same retry discipline extended inward)
        ex.device_oom_attempts = int(s.get("task_retry_attempts"))
        ms = int(s.get("query_max_run_time"))
        ex.query_deadline = (time.monotonic() + ms / 1000.0) if ms > 0 \
            else None
        # pre-launch plan verification (exec/plan_check.py): "auto"
        # resolves inside the executor (on under pytest)
        ex.plan_check = s.get("plan_check")
        # cross-query launch batching: "auto" engages whenever the
        # concurrent server attached a LaunchBatcher, so raw runners
        # and the serial server path launch solo with no check
        ex.cross_query_batching = s.get("cross_query_batching")
        ex.cross_query_batch_wait_ms = int(
            s.get("cross_query_batch_wait_ms"))
        # observed-stats profile store (obs/profile.py): repeated
        # queries seed their starting capacity bucket from persisted
        # profiles instead of climbing the overflow-retry ladder
        profile_dir = s.get("stats_profile_dir")
        if profile_dir:
            from presto_tpu_torch.obs.profile import ProfileStore

            ex.profile_store = ProfileStore.at(profile_dir)
        else:
            ex.profile_store = None
        # the result cache: ONE process-shared store behind every
        # enabled session, which is what collapses repeated statements
        # across the server's concurrent per-query runners. Budget and
        # TTL are session-governed, last writer wins (shrinking the
        # budget evicts at once)
        if bool(s.get("result_cache_enabled")):
            from presto_tpu_torch.cache import shared_cache

            rc = shared_cache()
            rc.configure(
                budget_bytes=int(s.get("result_cache_bytes")),
                ttl_ms=int(s.get("result_cache_ttl_ms")),
                spill_dir=s.get("spill_path") or None,
                persist_dir=s.get("result_cache_persist_dir"))
            # the warm-start pass: once per persister binding, re-admit
            # the persisted entries whose snapshot tokens still match
            # the live connectors (the persister's guard makes repeat
            # sessions free)
            if s.get("result_cache_persist_dir"):
                loaded, drops = rc.warm_load(self.catalogs)
                ex.count_warm_load(loaded, drops)
            ex.result_cache = rc
        else:
            ex.result_cache = None
        ex.cache_subsumption = bool(s.get("result_cache_subsumption"))

    def session_dist_options(self) -> Dict:
        """The fragmenter's distribution knobs: the constructor's
        ``dist_options`` first, then the session — the
        join_distribution_type override, else (unless the session pins
        ``broadcast_join_rows``) the stats-driven byte share: a build
        replicates only when its estimated bytes fit ONE device's
        broadcast share of the memory governor's budget (on a mesh,
        one device's budget; // PAGE_SHARE_DIV), with the row
        threshold kept as the fallback. The adaptive re-planner reads
        the same share."""
        opts: Dict = dict(self.dist_options)
        jd = self.session.get("join_distribution_type")
        if "broadcast_rows" not in opts:
            if jd == "broadcast":
                opts["broadcast_rows"] = 1 << 62
            elif jd == "partitioned":
                opts["broadcast_rows"] = 0
            else:
                opts["broadcast_rows"] = int(self.session.get(
                    "broadcast_join_rows"))
                if not self.session.is_set("broadcast_join_rows"):
                    ex = self.executor
                    per_device = (ex._budget() if self.mesh is None
                                  else ex.device_budget())
                    opts["broadcast_bytes"] = (per_device
                                               // MB.PAGE_SHARE_DIV)
                    opts["row_bytes_of"] = lambda n: _row_bytes(
                        ex.output_types(n))
        if "gather_capacity" not in opts:
            opts["gather_capacity"] = int(self.session.get(
                "agg_gather_capacity"))
        return opts

    def _fragment(self, plan: P.PhysicalNode) -> P.PhysicalNode:
        """Exchange insertion for a mesh runner (identity without one)."""
        if self.mesh is None:
            return plan
        from presto_tpu_torch.dist.fragmenter import add_exchanges

        return add_exchanges(plan, self.catalogs,
                             **self.session_dist_options())[0]

    def estimate_memory(self, sql: str) -> int:
        """Peak device-memory estimate for the server's admission
        (reference: the coordinator-side accounting ClusterMemoryManager
        consults): join builds, aggregation states and sort/window
        buffers plus one streamed page per scan. A statement that does
        not plan as a query (DDL, SET, ...) gets a 16 MiB floor."""
        floor = 1 << 24
        try:
            plan = self.plan(sql)
        except Exception:  # noqa: BLE001 - not a query: the floor
            return floor
        ex = self.executor
        total = 0
        # a subtree whose fragment-cache entry is resident replays host
        # pages and materializes no build, state or sort buffer, so the
        # arbiter reserves one streamed page for it. Advisory like
        # statement_cache_probe: the peek takes no tally, and a racing
        # eviction just runs (and sizes) the query under its own budget
        hit_roots = set()
        if bool(self.session.get("result_cache_enabled")):
            from presto_tpu_torch.cache import shared_cache_if_exists
            from presto_tpu_torch.cache.rules import select_cache_points

            rc = shared_cache_if_exists()
            if rc is not None:
                salt = f"k{ex.collect_k}.p{ex.page_rows}"
                for key, node, _t, _s, _f in select_cache_points(
                        plan, self.catalogs).values():
                    if rc.peek_pages(f"{key}:{salt}"):
                        hit_roots.add(id(node))

        def walk(n):
            nonlocal total
            if id(n) in hit_roots:
                total += min(ex.estimate_rows(n), ex.page_rows) * \
                    _row_bytes(ex.output_types(n))
                return
            if isinstance(n, P.HashJoin):
                total += ex.estimate_rows(n.right) * _row_bytes(
                    ex.output_types(n.right))
            if isinstance(n, P.Aggregation) and n.group_channels:
                total += min(ex.estimate_rows(n), n.capacity) * \
                    _row_bytes(ex.output_types(n))
            if isinstance(n, (P.Sort, P.Window, P.MarkDistinct)):
                total += ex.estimate_rows(n) * _row_bytes(
                    ex.output_types(n))
            if isinstance(n, P.TableScan):
                total += min(ex.estimate_rows(n), ex.page_rows) * \
                    _row_bytes(ex.output_types(n))
            for c in n.children():
                walk(c)

        walk(plan)
        return max(total, floor)

    def statement_cache_probe(self, sql: str) -> bool:
        """Whether this statement would be served whole from the
        statement cache RIGHT NOW — host work only (parse, plan, a key
        peek), for the server's cache-aware admission: a near-free hit
        should take no resource-group slot and reserve no device memory.
        Advisory: the admitted execute re-probes, so an eviction racing
        in between just runs the query for real."""
        try:
            stmt = parse(sql)
            if not isinstance(stmt, N.Query):
                return False
            self.apply_session()
            if self.executor.result_cache is None:
                return False
            keyed = self._statement_cache_key(self._plan_query(stmt))
            if keyed is None:
                return False
            # tally-free: the probe must not move the hit/miss counters
            return self.executor.result_cache.peek_rows(keyed[0])
        except Exception:  # noqa: BLE001 - an advisory probe: anything
            return False   # unplannable fails on the execute path

    def _planner(self) -> Planner:
        def scalar_exec(node):
            # plan-time scalar subqueries execute during planning: they
            # get their own access check, their plans join the statement
            # cache's key material, and they are fragmented before they
            # reach a mesh
            self._check_plan_access(node)
            self._scalar_subplans.append(node)
            return self.executor.execute(self._fragment(node))[1]

        return Planner(self.catalogs, self._current_catalog(),
                       scalar_executor=scalar_exec, views=self.views)

    def _current_catalog(self) -> str:
        cat = self.session.catalog
        return cat if cat in self.catalogs else self.default_catalog

    def plan(self, sql: str) -> P.Output:
        stmt = parse(sql)
        if isinstance(stmt, (N.Explain, N.CreateTableAs)):
            stmt = stmt.query
        return self._plan_query(stmt)

    def _plan_query(self, stmt) -> P.Output:
        if not isinstance(stmt, N.Query):
            raise ValueError(f"{type(stmt).__name__} is not a query")
        # a fresh scalar-subquery record per plan pass (the statement
        # cache reads it right after the outermost statement plans)
        self._scalar_subplans = []
        out = self._planner().plan_statement(stmt)
        self._check_plan_access(out)
        return self._fragment(push_scan_constraints(prune_plan(
            out, self.catalogs)))

    def _check_plan_access(self, plan) -> None:
        """checkCanSelect over every scanned table (reference:
        AccessControlManager consulted by the analyzer; here the planned
        scans, the set the query reads after view expansion)."""
        ac, user = self.access_control, self.session.user

        def walk(n):
            if isinstance(n, P.TableScan):
                ac.check_can_select(user, n.catalog, n.table, n.columns)
            for c in n.children():
                walk(c)

        walk(plan)

    def _resolve_catalog(self, parts) -> Tuple[str, str]:
        """(catalog, object name) of a possibly qualified name: the one
        resolution rule of writes and views."""
        if len(parts) >= 2 and parts[0] in self.catalogs:
            return parts[0], parts[-1]
        return self._current_catalog(), parts[-1]

    def _resolve_write_target(self, parts):
        catalog, table = self._resolve_catalog(parts)
        conn = self.catalogs.get(catalog)
        if conn is None or not hasattr(conn, "create_table_pages"):
            raise ValueError(f"catalog {catalog!r} does not support writes")
        return conn, catalog, table

    def execute(self, sql: str) -> QueryResult:
        stmt = parse(sql)
        self.apply_session()
        self.access_control.check_can_execute_query(self.session.user, sql)
        # query-lifecycle tracing (obs/): one trace per statement when
        # enabled; the executor records execute/attempt/operator/xfer
        # spans into it
        trace = OBS.maybe_trace(self.session, sql=sql)
        if trace is not None:
            OBS.attach(self.executor, trace)
        token = _ACTIVE_SESSION.set(self.session)
        try:
            return self._execute_stmt(stmt)
        finally:
            _ACTIVE_SESSION.reset(token)
            if trace is not None:
                if trace.span_count > 1:
                    OBS.finalize(self.executor, trace,
                                 self.session.get("query_trace_dir"))
                    self.last_trace = trace
                else:
                    # a control statement (SET SESSION, PREPARE, ...)
                    # never reached the executor: no file, and
                    # last_trace keeps the previous real query's
                    self.executor.trace = None
            else:
                self.last_trace = None

    def _execute_stmt(self, stmt: N.Node) -> QueryResult:
        ac, user = self.access_control, self.session.user
        if isinstance(stmt, N.CreateView):
            key = self._resolve_catalog(stmt.parts)
            ac.check_can_create_view(user, *key)
            if key in self.views and not stmt.replace:
                raise ValueError(f"view already exists: {key[1]}")
            # validate now, like the reference's analyzer; planning alone
            # has no side effects
            self._planner().plan_statement(parse(stmt.query_sql))
            self.views[key] = stmt.query_sql
            return QueryResult([], [], update_type="CREATE VIEW")
        if isinstance(stmt, N.DropView):
            key = self._resolve_catalog(stmt.parts)
            ac.check_can_drop_view(user, *key)
            if self.views.pop(key, None) is None:
                raise ValueError(f"view not found: {key[1]}")
            return QueryResult([], [], update_type="DROP VIEW")
        if isinstance(stmt, N.Prepare):
            # validate now, so a bad statement fails at PREPARE
            parse(stmt.statement_sql)
            mine = self.prepared.setdefault(self.session.user, {})
            mine[stmt.name] = stmt.statement_sql
            return QueryResult([], [], update_type="PREPARE")
        if isinstance(stmt, N.Deallocate):
            mine = self.prepared.get(self.session.user, {})
            if mine.pop(stmt.name, None) is None:
                raise ValueError(
                    f"prepared statement not found: {stmt.name}")
            return QueryResult([], [], update_type="DEALLOCATE")
        if isinstance(stmt, N.ExecutePrepared):
            return self._execute_prepared(stmt)
        if isinstance(stmt, N.SetSession):
            ac.check_can_set_session(user, stmt.name)
            self.session.set(stmt.name, stmt.value)
            return QueryResult([], [], update_type="SET SESSION")
        if isinstance(stmt, N.ShowSession):
            return QueryResult(
                ["name", "value", "default", "type", "description"],
                self.session.rows())
        if isinstance(stmt, N.ShowTables):
            cat = stmt.catalog or self._current_catalog()
            conn = self.catalogs.get(cat)
            if conn is None:
                raise ValueError(f"unknown catalog: {cat}")
            return QueryResult(["table"], [(t,) for t in conn.tables()])
        if isinstance(stmt, N.DropTable):
            conn, cat, table = self._resolve_write_target(stmt.parts)
            ac.check_can_drop_table(user, cat, table)
            conn.drop_table(table)
            self._invalidate_caches(cat, table)
            return QueryResult([], [], update_type="DROP TABLE")
        if isinstance(stmt, (N.Delete, N.Update)):
            _conn, cat, table = self._resolve_write_target(stmt.parts)
            (ac.check_can_delete if isinstance(stmt, N.Delete)
             else ac.check_can_update)(user, cat, table)
            return self._execute_dml(stmt)
        if isinstance(stmt, (N.CreateTableAs, N.InsertInto)):
            conn, cat, table = self._resolve_write_target(stmt.parts)
            (ac.check_can_create_table
             if isinstance(stmt, N.CreateTableAs)
             else ac.check_can_insert)(user, cat, table)
            inner = self._plan_query(stmt.query)
            types = self.executor.output_types(inner)
            names, pages = self.executor.execute_pages(inner)
            if isinstance(stmt, N.CreateTableAs):
                n = conn.create_table_pages(
                    table, names or [], types, pages,
                    unique=self._unique_outputs(inner, names))
                kind = "CREATE TABLE AS"
            else:
                n = conn.insert_pages(table, pages)
                kind = "INSERT"
            self._invalidate_caches(cat, table)
            return QueryResult(["rows"], [(n,)], update_type=kind,
                               column_types=["bigint"])
        if isinstance(stmt, N.Explain):
            out = self._plan_query(stmt.query)
            if stmt.analyze:
                _names, _rows, stats = self.executor.execute_with_stats(
                    out)
                text = explain_text(out, stats=stats)
            else:
                text = explain_text(out)
            return QueryResult(["Query Plan"],
                               [(line,) for line in text.splitlines()])
        # a plain query: the statement cache answers an identical
        # (planned fingerprint, catalog/schema, result-affecting
        # properties, snapshot versions) repeat without executing; the
        # fragment cache engages inside execute()
        out = self._plan_query(stmt)
        keyed = self._statement_cache_key(out)
        ex = self.executor
        if keyed is not None:
            hit = ex.result_cache.get_rows(keyed[0])
            if hit is not None:
                names, rows, types = hit
                ex.result_cache_hits += 1
                # the executor never ran: every per-query gauge describes
                # THIS statement (no launch, no spill, no crossing), not
                # whatever ran last on this runner
                ex._begin_attempt()
                for gauge in ("peak_memory_bytes", "spill_partitions_used",
                              "host_spill_pages", "disk_spill_pages",
                              "skew_chunks_used", "device_oom_retries",
                              "capacity_boost_retries",
                              "profile_store_hits", "programs_compiled",
                              "program_cache_hits"):
                    setattr(ex, gauge, 0)
                ex.compile_wall_s = 0.0
                ex._reset_transfer_gauges()
                return QueryResult(names, rows, column_types=types)
        names, rows = ex.execute(out)
        types = [str(t) for t in ex.output_types(out)]
        if keyed is not None:
            key, tables = keyed
            ex.result_cache_evictions += ex.result_cache.put_rows(
                key, list(names or []), rows, types, tables)
        return QueryResult(list(names or []), rows, column_types=types)

    def _statement_cache_key(self, plan):
        """(key, scanned tables) for the statement cache, or None when
        the statement cannot cache: no store wired, a non-deterministic
        or snapshot-less plan, or a plan-time scalar subquery that was
        itself uncacheable (its value is baked into the plan). Key
        material: the canonical fingerprint of the PLANNED statement
        (after view expansion and parameter binding, so whitespace and
        case still hit while CREATE OR REPLACE VIEW moves the key), the
        resolved catalog and schema, the result-affecting session
        properties, and every scanned table's snapshot version (main
        plan and scalar subplans)."""
        from presto_tpu_torch.cache import (
            RESULT_AFFECTING_PROPS,
            cacheable,
            scan_tables,
            snapshot_tokens,
        )
        from presto_tpu_torch.obs.profile import (
            plan_fingerprint,
            structural_fingerprint,
        )

        if self.executor.result_cache is None:
            return None
        if not cacheable(plan, self.catalogs):
            return None
        tables = scan_tables(plan)
        for sub in self._scalar_subplans:
            if not cacheable(sub, self.catalogs):
                return None
            tables |= scan_tables(sub)
        snap = snapshot_tokens(tables, self.catalogs)
        if snap is None:
            return None
        props = tuple((p, str(self.session.get(p)))
                      for p in RESULT_AFFECTING_PROPS)
        fp = structural_fingerprint((
            plan_fingerprint(plan, self.catalogs),
            self._current_catalog(), self.session.schema, props, snap))
        return f"stmt:{fp}", frozenset(tables)

    def _unique_outputs(self, plan: P.Output, names) -> List[str]:
        """The output columns the plan proves unique: a source's declared
        key carried through filters and identity projections."""
        return [nm for ch, nm in enumerate(names or [])
                if P.scan_column_unique(plan.source, ch, self.catalogs)]

    def _execute_prepared(self, stmt) -> QueryResult:
        text = self.prepared.get(self.session.user, {}).get(stmt.name)
        if text is None:
            raise ValueError(f"prepared statement not found: {stmt.name}")
        inner = parse(text)
        if isinstance(inner, (N.Delete, N.Update)):
            # DML predicates and assignments ride as raw SQL slices:
            # substitute the arguments' source text positionally
            inner, used = _bind_dml_parameters(inner, stmt.arg_sqls)
            if used != len(stmt.args):
                raise ValueError(
                    f"incorrect number of parameters: statement expects "
                    f"{used}, EXECUTE supplies {len(stmt.args)}")
            return self._execute_stmt(inner)
        want = _count_parameters(inner)
        if len(stmt.args) != want:
            raise ValueError(
                f"incorrect number of parameters: statement expects "
                f"{want}, EXECUTE supplies {len(stmt.args)}")
        return self._execute_stmt(_bind_parameters(inner, stmt.args))

    def _invalidate_caches(self, catalog: str, table: str) -> None:
        """THE write-path invalidation hub: after any DML/CTAS/DROP
        through this runner, (a) reclaim the result-cache entries that
        read the written table (their keys are already unreachable —
        snapshot_version moved — this frees the bytes now), and (b)
        drop a wrapping page cache's stale lists (connectors/cached.py's
        invalidate / drop_cache). Counted on result_cache_invalidations."""
        from presto_tpu_torch.cache import shared_cache_if_exists

        n = 0
        rc = shared_cache_if_exists()
        if rc is not None:
            n += rc.invalidate_tables({(catalog, table)})
        conn = self.catalogs.get(catalog)
        inv = getattr(conn, "invalidate", None)
        if inv is not None:
            n += int(inv(table) or 0)
        elif hasattr(conn, "drop_cache"):
            conn.drop_cache()
        if n:
            self.executor.count_cache_invalidations(n)

    def _execute_dml(self, stmt) -> QueryResult:
        """DELETE/UPDATE as a rewrite through SELECT plus a table replace
        (reference: DeleteNode/TableWriter; a columnar store rewrites
        rather than mutates)."""

        def q(ident: str) -> str:
            # regenerated SQL must survive re-tokenizing: quote every
            # identifier (unquoted names lowercase on re-parse)
            return '"' + ident.replace('"', '""') + '"'

        conn, catalog, table = self._resolve_write_target(stmt.parts)
        try:
            schema = conn.table_schema(table)
        except KeyError:
            raise ValueError(f"table not found: {table}")
        cols = schema.column_names()
        w = stmt.where_sql
        if w is not None and _sql_has_subquery(w):
            # the guarded rewrite buries the predicate where the
            # planner's subquery decorrelation cannot reach it
            raise ValueError(
                "DELETE/UPDATE predicates with subqueries are not "
                "supported yet; stage keys via CREATE TABLE AS first")
        tref = f"{q(catalog)}.{q(table)}"
        # coalesce((w), false): a row whose predicate is NULL is not
        # matched. The newline ends any trailing line comment riding in
        # the raw source slice.
        guarded = f"coalesce(({w}\n), false)" if w else "true"
        n_before = conn.row_count(table)
        if isinstance(stmt, N.Delete):
            plan = self._plan_query(parse(
                f"select * from {tref} where not {guarded}"))
            types = self.executor.output_types(plan)
            _names, pages = self.executor.execute_pages(plan)
            kept = conn.create_table_pages(
                table, cols, types, pages, replace=True,
                unique=self._unique_outputs(plan, cols))
            self._invalidate_caches(catalog, table)
            return QueryResult(["rows"], [(n_before - kept,)],
                               update_type="DELETE", column_types=["bigint"])
        # UPDATE: assigned columns become guarded CASE projections cast
        # back to the declared type; the guard rides as one extra
        # boolean column, so the matched count comes from the same scan
        sets = dict(stmt.assignments)
        if len(sets) != len(stmt.assignments):
            raise ValueError("UPDATE assigns the same column more than once")
        unknown = set(sets) - set(cols)
        if unknown:
            raise ValueError(
                f"no such column(s) in {table!r}: {sorted(unknown)}")
        sel = []
        for c in cols:
            if c in sets:
                t = schema.column_type(c)
                sel.append(f"case when {guarded} then "
                           f"cast(({sets[c]}\n) as {t}) else {q(c)} end "
                           f"as {q(c)}")
            else:
                sel.append(q(c))
        sel.append(f'{guarded} as "__upd_matched__"')
        plan = self._plan_query(parse(
            f"select {', '.join(sel)} from {tref}"))
        _names, pages = self.executor.execute_pages(plan)
        matched = sum(int((p.valid & p.blocks[-1].data.to(torch.bool)).sum())
                      for p in pages)
        pages = [p.select_channels(range(len(cols))) for p in pages]
        conn.create_table_pages(
            table, cols, [schema.column_type(c) for c in cols], pages,
            replace=True, unique=self._unique_outputs(plan, cols))
        self._invalidate_caches(catalog, table)
        return QueryResult(["rows"], [(matched,)], update_type="UPDATE",
                           column_types=["bigint"])


# the session of the statement executing in this thread/context: the
# system catalog's shared providers resolve through it, so they see the
# querying session, not the runner they were registered on
_ACTIVE_SESSION: contextvars.ContextVar = contextvars.ContextVar(
    "presto_tpu_torch_active_session", default=None)


def current_session():
    return _ACTIVE_SESSION.get()


def _sql_has_subquery(expr_sql: str) -> bool:
    """True when a raw expression fragment contains a subquery (walks
    the parsed AST for nested Query nodes)."""
    from presto_tpu_torch.sql.parser import Parser, tokenize

    node = Parser(tokenize(expr_sql), source=expr_sql).parse_expr()

    def walk(x) -> bool:
        if isinstance(x, N.Query):
            return True
        if isinstance(x, (list, tuple)):
            return any(walk(i) for i in x)  # nested tuples (CASE whens)
        if dataclasses.is_dataclass(x) and isinstance(x, N.Node):
            return any(walk(getattr(x, f.name))
                       for f in dataclasses.fields(x))
        return False

    return walk(node)


def explain_text(node: P.PhysicalNode, indent: int = 0,
                 stats=None) -> str:
    """Plan rendering (reference: sql/planner/planPrinter/PlanPrinter;
    presto_tpu.runner.explain_text); with stats (EXPLAIN ANALYZE) each
    line carries the node's wall time, page count and output rows from
    the run, and a trailing Counters line the query's counters."""
    pad = "    " * indent
    if isinstance(node, P.Output):
        line = f"{pad}Output[{', '.join(node.names)}]"
    elif isinstance(node, P.TableScan):
        line = (f"{pad}TableScan[{node.catalog}.{node.table} "
                f"cols={list(node.columns)}]")
    elif isinstance(node, P.Filter):
        line = f"{pad}Filter[{node.predicate!r}]"
    elif isinstance(node, P.Project):
        line = f"{pad}Project[{len(node.exprs)} cols]"
    elif isinstance(node, P.Aggregation):
        fns = ", ".join(
            f"{s.function}({'' if s.channel is None else '#%d' % s.channel})"
            for s in node.aggregates)
        step = "" if node.step == "single" else f" step={node.step}"
        line = (f"{pad}Aggregate[keys={list(node.group_channels)} "
                f"aggs=[{fns}]{step}]")
    elif isinstance(node, P.Window):
        fns = ", ".join(f.function for f in node.functions)
        line = (f"{pad}Window[partition={list(node.partition_channels)} "
                f"fns=[{fns}]]")
    elif isinstance(node, P.Exchange):
        keys = f" keys={list(node.keys)}" if node.keys else ""
        line = f"{pad}Exchange[{node.kind}{keys}]"
    elif isinstance(node, P.HashJoin):
        line = (f"{pad}{node.join_type.capitalize()}Join"
                f"[probe={list(node.left_keys)} "
                f"build={list(node.right_keys)}]")
    elif isinstance(node, P.CrossJoin):
        line = f"{pad}CrossJoin"
    elif isinstance(node, P.MarkDistinct):
        line = (f"{pad}MarkDistinct"
                f"[{[list(s) for s in node.mark_channel_sets]}]")
    elif isinstance(node, P.TopN):
        line = f"{pad}TopN[{node.limit} by {list(node.keys)}]"
    elif isinstance(node, P.Sort):
        line = f"{pad}Sort[{list(node.keys)}]"
    elif isinstance(node, P.Limit):
        line = f"{pad}Limit[{node.count}]"
    elif isinstance(node, P.UniqueId):
        line = f"{pad}AssignUniqueId"
    elif isinstance(node, P.Union):
        line = f"{pad}Union"
    elif isinstance(node, P.Values):
        line = f"{pad}Values[{len(node.rows)} rows]"
    else:
        line = f"{pad}{type(node).__name__}"
    if stats is not None:
        st = stats.get(id(node))
        if st is not None:
            line += (f"   [wall {st.wall_s*1e3:.1f}ms, {st.pages} pages, "
                     f"{st.rows:,} rows]")
    parts = [line]
    for child in node.children():
        parts.append(explain_text(child, indent + 1, stats=stats))
    if indent == 0 and stats is not None and stats.get("counters"):
        ctr = stats["counters"]
        parts.append("Counters: " + ", ".join(
            f"{k}={ctr[k]}" for k in sorted(ctr)))
    return "\n".join(parts)


def _subst_sql_params(sql: str, args, pos: int):
    """Replace top-level ? placeholders in a raw SQL slice with the
    argument texts starting at args[pos]. A '?' inside a single-quoted
    string literal, a double-quoted identifier, or a -- or /* */
    comment is data, as the tokenizer reads it. Returns (new_sql,
    next_pos)."""

    def quoted_span(i: int, quote: str) -> int:
        # end (exclusive) of a quoted span starting at i; doubled
        # quotes escape
        j = i + 1
        while j < len(sql):
            if sql[j] == quote:
                if j + 1 < len(sql) and sql[j + 1] == quote:
                    j += 2
                    continue
                return j + 1
            j += 1
        return j

    out = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch in ("'", '"'):
            j = quoted_span(i, ch)
            out.append(sql[i:j])
            i = j
            continue
        if ch == "-" and sql[i:i + 2] == "--":
            j = sql.find("\n", i)
            j = n if j < 0 else j + 1
            out.append(sql[i:j])
            i = j
            continue
        if ch == "/" and sql[i:i + 2] == "/*":
            j = sql.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(sql[i:j])
            i = j
            continue
        if ch == "?":
            if pos >= len(args):
                raise ValueError(f"query needs {pos + 1}+ parameters, "
                                 f"EXECUTE supplies {len(args)}")
            out.append("(" + args[pos] + ")")
            pos += 1
            i += 1
            continue
        out.append(ch)
        i += 1
    return "".join(out), pos


def _bind_dml_parameters(stmt, arg_sqls):
    """Positional ? substitution across a Delete/Update statement's raw
    SQL slices (assignments left to right, then WHERE: source order).
    Returns (bound statement, parameters consumed)."""
    pos = 0
    if isinstance(stmt, N.Update):
        assigns = []
        for col, expr_sql in stmt.assignments:
            bound, pos = _subst_sql_params(expr_sql, arg_sqls, pos)
            assigns.append((col, bound))
        where = stmt.where_sql
        if where is not None:
            where, pos = _subst_sql_params(where, arg_sqls, pos)
        return N.Update(stmt.parts, tuple(assigns), where), pos
    where = stmt.where_sql
    if where is not None:
        where, pos = _subst_sql_params(where, arg_sqls, pos)
    return N.Delete(stmt.parts, where), pos


def _count_parameters(node) -> int:
    """Number of ? placeholders in a statement AST."""
    if isinstance(node, N.Parameter):
        return 1
    if isinstance(node, tuple):
        return sum(_count_parameters(x) for x in node)
    if dataclasses.is_dataclass(node) and isinstance(node, N.Node):
        return sum(_count_parameters(getattr(node, f.name))
                   for f in dataclasses.fields(node))
    return 0


def _bind_parameters(node, args):
    """Substitute EXECUTE ... USING argument ASTs for ? placeholders
    (reference: sql/analyzer ParameterRewriter), a structural rewrite of
    the frozen AST."""
    if isinstance(node, N.Parameter):
        if node.index >= len(args):
            raise ValueError(f"query needs {node.index + 1}+ parameters, "
                             f"{len(args)} given")
        return args[node.index]
    if isinstance(node, tuple):
        new = tuple(_bind_parameters(x, args) for x in node)
        return new if any(a is not b for a, b in zip(new, node)) else node
    if dataclasses.is_dataclass(node) and isinstance(node, N.Node):
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = _bind_parameters(v, args)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(node, **changes) if changes else node
    return node
