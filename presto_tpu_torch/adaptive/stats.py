"""Stage-boundary exchange statistics (the spool-stats plane).

Port of presto_tpu/adaptive/stats.py. One StageStats summarizes a
COMPLETED stage's spooled output across all of its tasks: exact row
and byte totals, the per-partition histogram (partition p sums every
producer task's partition p — consumer task p's actual input), and
per-task totals (a passthrough consumer reads exactly one producer
task's spool). Workers publish the per-partition counts on the task
status plane (server/worker.route_task_get: spoolRows, spoolBytes,
spoolWireBytes), accumulated at spool-publish time, so they are exact,
monotone, stable across release and identical after a deterministic
replay.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StageStats:
    """Observed output of one completed stage."""

    fid: int
    rows: int
    bytes: int
    # partition p summed across producer tasks (repartition edges:
    # consumer task p's exact input)
    part_rows: Tuple[int, ...]
    part_bytes: Tuple[int, ...]
    # per producer task (passthrough edges: consumer task t's input)
    task_rows: Tuple[int, ...]
    # the spool's post-codec wire bytes: what the exchange ships after
    # the per-column page codecs (dist/serde.py). Device-resident spool
    # entries that never serialized report their footprint, so this is
    # an upper bound on the freight. 0 = not reported (use `bytes`)
    wire_bytes: int = 0
    # bytes the stage's exchange routed through the mesh all_to_all
    # (dist/scheduler.py's ICI plane); 0 = the exchange rode the spools
    ici_bytes: int = 0

    @property
    def row_bytes(self) -> int:
        """Observed average spool bytes per row (>=1)."""
        return max(self.bytes // max(self.rows, 1), 1)

    @property
    def freight_bytes(self) -> int:
        """The byte count broadcast-vs-partitioned costing charges: the
        measured wire bytes when reported, else the raw spool bytes
        (the codecs ship under raw, so raw bytes over-price
        broadcast)."""
        return self.wire_bytes if self.wire_bytes > 0 else self.bytes

    @property
    def max_part_rows(self) -> int:
        return max(self.part_rows) if self.part_rows else 0

    @property
    def max_task_rows(self) -> int:
        return max(self.task_rows) if self.task_rows else 0

    def skew_ratio(self) -> float:
        """max/mean over the partition histogram (1.0 = balanced;
        meaningful only for multi-partition repartition spools)."""
        if len(self.part_rows) <= 1 or self.rows <= 0:
            return 1.0
        mean = self.rows / len(self.part_rows)
        return self.max_part_rows / max(mean, 1e-9)

    def observed_rows(self, read_kind: str) -> int:
        """Upper bound on ONE consumer task's input rows under the
        given edge read kind — the value stamped into RemoteSource
        est_rows (one fragment blob serves every task, so the stamp is
        the per-task maximum)."""
        if read_kind == "repartition":
            return max(self.max_part_rows, 1)
        if read_kind == "passthrough":
            return max(self.max_task_rows, 1)
        # gather / broadcast / adaptive broadcast-read: the full set
        return max(self.rows, 1)


def stats_from_statuses(fid: int,
                        statuses: List[Dict]) -> Optional[StageStats]:
    """Sum per-task status bodies (route_task_get) into one StageStats.
    None when a task reported no spool stats: the re-planner then has
    no observation for this stage."""
    per_task: List[Tuple[List[int], List[int]]] = []
    wire_total = 0
    for st in statuses:
        rows = st.get("spoolRows")
        if rows is None:
            return None
        nbytes = list(st.get("spoolBytes") or [0] * len(rows))
        per_task.append((list(rows), nbytes))
        # a task missing the wire field charges its raw spool bytes, so
        # the freight never under-counts
        wire = st.get("spoolWireBytes")
        wire_total += (sum(wire) if wire is not None else sum(nbytes))
    if not per_task:
        return None
    nparts = max(len(r) for r, _ in per_task)
    part_rows = [0] * nparts
    part_bytes = [0] * nparts
    task_rows = []
    for rows, nbytes in per_task:
        task_rows.append(sum(rows))
        for p, n in enumerate(rows):
            part_rows[p] += int(n)
        for p, n in enumerate(nbytes):
            part_bytes[p] += int(n)
    return StageStats(
        fid=fid,
        rows=sum(task_rows),
        bytes=sum(part_bytes),
        part_rows=tuple(part_rows),
        part_bytes=tuple(part_bytes),
        task_rows=tuple(task_rows),
        wire_bytes=wire_total,
    )
