"""LocalRunner: the full parse -> plan -> prune -> execute pipeline in one
process, on one device.

Port of presto_tpu/runner.py for SELECT statements. Session properties
come as a plain dict, validated through the port's property registry
(session.py); a property that asks for a plane the port lacks raises
NotImplementedError. The runner honours:

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
  - ``late_materialization_enabled`` ("auto" = on a CUDA device).

Reference: presto-main testing/LocalQueryRunner.java.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec.executor import Executor
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
    column_types: Optional[List[str]] = None


class LocalRunner:
    """``device=None`` runs on the card and raises without one; the
    tests pass ``device="cpu"``."""

    def __init__(self, catalogs: Dict, default_catalog: str = "tpch",
                 session: Optional[Dict[str, object]] = None,
                 device=None):
        self.catalogs = dict(catalogs)
        self.default_catalog = default_catalog
        self.session = Session(default_catalog, session)
        self.session.check_ported()
        self.executor = Executor(self.catalogs, device=device)
        self.apply_session()

    def apply_session(self) -> None:
        """Push the session's executor knobs onto the executor; anchors
        the query deadline (query_max_run_time) at the call."""
        s, ex = self.session, self.executor
        ex.page_rows = int(s.get("page_rows"))
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
        ex.late_mat = s.get("late_materialization_enabled")
        # the executor's device-OOM re-entries share the task retry
        # budget (the same retry discipline extended inward)
        ex.device_oom_attempts = int(s.get("task_retry_attempts"))
        ms = int(s.get("query_max_run_time"))
        ex.query_deadline = (time.monotonic() + ms / 1000.0) if ms > 0 \
            else None

    def session_dist_options(self) -> Dict:
        """fragment_dag's distribution knobs from the session: the
        join_distribution_type override, else the broadcast row
        threshold (the reference's row-count fallback; its stats-driven
        byte share needs the memory governor, not ported)."""
        jd = self.session.get("join_distribution_type")
        if jd == "broadcast":
            rows = 1 << 62
        elif jd == "partitioned":
            rows = 0
        else:
            rows = int(self.session.get("broadcast_join_rows"))
        return {"broadcast_rows": rows,
                "gather_capacity": int(self.session.get(
                    "agg_gather_capacity"))}

    def _planner(self) -> Planner:
        def scalar_exec(node):
            # plan-time scalar subqueries execute during planning
            return self.executor.execute(node)[1]

        return Planner(self.catalogs, self.default_catalog,
                       scalar_executor=scalar_exec)

    def plan(self, sql: str) -> P.Output:
        stmt = parse(sql)
        if isinstance(stmt, N.Explain):
            stmt = stmt.query
        return self._plan_query(stmt)

    def _plan_query(self, stmt) -> P.Output:
        if not isinstance(stmt, N.Query):
            raise NotImplementedError(
                f"{type(stmt).__name__} statements are not ported to "
                "presto_tpu_torch yet; the slice runs SELECT queries")
        return push_scan_constraints(prune_plan(
            self._planner().plan_statement(stmt), self.catalogs))

    def execute(self, sql: str) -> QueryResult:
        out = self._plan_query(parse(sql))
        self.apply_session()
        names, rows = self.executor.execute(out)
        types = [str(t) for t in self.executor.output_types(out)]
        return QueryResult(list(names or []), rows, column_types=types)

