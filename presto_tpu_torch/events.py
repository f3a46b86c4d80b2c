"""Event listener SPI.

Port of presto_tpu/events.py (pure Python, copied). Reference:
presto-spi spi/eventlistener/EventListener.java — plugins receive
QueryCreatedEvent / QueryCompletedEvent built by presto-main
event/QueryMonitor.java; the hook for warehouse-side query logging.
Listeners are registered on the server (or QueryManager) and receive
immutable event records; listener failures are swallowed so they can
never fail a query (reference behavior), and counted.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QueryCreatedEvent:
    query_id: str
    sql: str
    user: str
    create_time: float  # unix seconds


@dataclasses.dataclass(frozen=True)
class QueryCompletedEvent:
    query_id: str
    sql: str
    user: str
    state: str  # FINISHED | FAILED | CANCELED
    create_time: float
    end_time: float
    wall_ms: int
    row_count: int
    error_name: Optional[str] = None
    error_message: Optional[str] = None
    # the full QueryInfo/StageInfo/TaskInfo tree (obs/trace.to_info)
    # when the query was traced — the reference QueryCompletedEvent
    # carries QueryStats/StageStats the same way; None when tracing
    # was off for this query
    query_info: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class StageCompletedEvent:
    """One stage-DAG wave finished (dist/scheduler.py). wall_ms spans
    first dispatch to last task completion on the coordinator's
    monotonic clock (obs/trace.py timing rules)."""

    query_id: str
    stage_id: str
    task_count: int
    wall_ms: int
    retries: int
    spooled_pages: int


@dataclasses.dataclass(frozen=True)
class TaskCompletedEvent:
    """One logical task of a stage completed on its final placement.
    queue/run walls come from the worker's shipped spans (zero when
    the worker did not trace)."""

    query_id: str
    task_id: str
    stage_id: str
    uri: str
    state: str  # FINISHED | FAILED
    wall_ms: int
    queue_ms: int
    run_ms: int
    pages: int
    retries: int
    speculative: bool


@dataclasses.dataclass(frozen=True)
class TaskRetryEvent:
    """One fault-tolerant task re-dispatch (dist/dcn.py): the fragment
    placed on `from_uri` was lost (worker death / submit failure /
    exhausted fetch retries) and re-ran on `to_uri` with the same split
    assignment. Reference analog: Project Tardigrade's task-retry
    events in QueryMonitor."""

    query_id: str
    task_id: str
    from_uri: str
    to_uri: str
    attempt: int
    cause: str


class EventListener:
    """Subclass and override; register via PrestoTpuServer(
    event_listeners=[...]), QueryManager(listeners=[...]), or
    DcnRunner(listeners=[...])."""

    def query_created(self, event: QueryCreatedEvent) -> None:
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:
        pass

    def task_retried(self, event: TaskRetryEvent) -> None:
        pass

    def stage_completed(self, event: StageCompletedEvent) -> None:
        pass

    def task_completed(self, event: TaskCompletedEvent) -> None:
        pass


def dispatch(listeners, method: str, event, on_error=None) -> None:
    """Deliver an event to every listener, swallowing listener errors
    (a misbehaving listener must never fail the query) — but COUNTING
    them: callers pass the owning executor's count_listener_error so
    every swallowed exception lands on the `listener_errors` registry
    counter (exec/counters.py) instead of vanishing."""
    for lst in listeners:
        try:
            getattr(lst, method)(event)
        except Exception:  # noqa: BLE001 - reference behavior, counted
            if on_error is not None:
                try:
                    on_error()
                except Exception:  # noqa: BLE001 - the counter sink
                    pass           # must never fail the query either
