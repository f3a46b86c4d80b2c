"""Adaptive execution: runtime re-planning at spooled-exchange stage
boundaries.

Port of presto_tpu/adaptive/ (reference direction: adaptive query
execution over Presto's plan-once model, where AddExchanges and
DetermineJoinDistributionType decide from connector estimates and every
misestimate is paid at runtime as overflow-ladder re-runs, capacity
boosts and skew found by failed attempts). The spooled stage DAG is the
barrier such an engine exploits: every upstream stage's output is fully
spooled on its workers BEFORE the consumer stage dispatches, so at each
stage boundary the coordinator holds EXACT per-partition row and byte
counts (the spool-stats plane, server/worker._TaskSpool.part_stats) and
the not-yet-dispatched suffix of the DAG is still data.

The Replanner re-optimizes that suffix:

  (a) DISTRIBUTION FLIPS — a repartitioned build side whose observed
      bytes fit one device's broadcast share is read broadcast-style
      (every partition of every producer task: their union is the full
      build), and the sibling not-yet-dispatched repartition producer
      degrades to a passthrough edge, skipping its partitioning;
  (b) JOIN RE-ORDER — when both sides of a downstream join are
      observed, the smaller side becomes the build (inner joins swap
      sides behind a channel-restoring Project);
  (c) CAPACITY RE-SEEDING — downstream Aggregation capacities
      re-bucket onto the shapes.py ladder from observed input
      cardinality, and RemoteSource leaves carry est_rows, so first
      runs start at the settled bucket instead of climbing the boost
      ladder;
  (d) SKEW PRE-ENGAGEMENT — a hot partition in the spool histogram
      starts the consumer's joins in the position-chunked rebalance
      (skew_preempted) instead of discovering the hot key by overflow.

Every mutated DAG re-verifies through plan_check.verify_dag before
anything dispatches; a failed re-verify rolls the mutation back and the
static plan runs (adaptive_replan_rejected). Re-plans are bounded per
query by ``adaptive_max_replans``, and the path is gated by the
``adaptive_execution`` session property (auto = on under the stage
scheduler). Mutated capacities are ladder values, so re-planned
fragments share the existing program caches.
"""

from presto_tpu_torch.adaptive.replanner import (  # noqa: F401
    ReplanOutcome,
    Replanner,
)
from presto_tpu_torch.adaptive.stats import (  # noqa: F401
    StageStats,
    stats_from_statuses,
)
