"""Hierarchical resource groups: admission control for inter-query
concurrency, queueing, and memory.

Port of presto_tpu/server/resource_groups.py (pure Python, copied).
Reference: presto-main resourceGroups/* (InternalResourceGroupManager,
InternalResourceGroup, ResourceGroupSpec) — a TREE of groups, each with
hard_concurrency_limit, max_queued, and soft_memory_limit; selectors
pick a LEAF group per query (user regex here), and a query consumes a
queue slot, then a concurrency slot, then memory, at EVERY level of its
group path — a burst in one subgroup cannot starve its siblings beyond
the parent's quota. Queries beyond a queue limit are rejected with
QUERY_QUEUE_FULL.

hard_concurrency bounds how many queries may be in flight (RUNNING or
waiting on the memory arbiter); queries admitted together share the
card.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

from presto_tpu_torch.obs.sanitizer import (
    make_condition,
    make_lock,
    register_owner,
)


@dataclasses.dataclass(frozen=True)
class ResourceGroupSpec:
    """One group node (reference: ResourceGroupSpec in the resource-
    group JSON config). ``sub_groups`` makes it a tree; a query selects
    the first matching LEAF depth-first. max_memory_bytes = 0 means no
    memory quota at this level."""

    name: str
    user_pattern: str = ".*"
    hard_concurrency: int = 1
    max_queued: int = 100
    max_memory_bytes: int = 0
    sub_groups: Tuple["ResourceGroupSpec", ...] = ()
    # scheduling policy: higher-priority
    # waiters claim freed concurrency slots first, and every waiter
    # AGES — effective priority grows with time queued
    # (AGING_PRIORITY_PER_S) — so a long-scan group can never starve
    # an interactive group, and vice versa
    priority: int = 0
    # fraction of the resolved device budget (exec/membudget.py)
    # queries admitted through this group may each govern to;
    # 0.0 = no share configured (the session/default budget applies)
    memory_share: float = 0.0


@dataclasses.dataclass(frozen=True)
class GroupSelection:
    """A query's admitted path: root-to-leaf chain of specs plus the
    dotted path names (reference: ResourceGroupId)."""

    specs: Tuple[ResourceGroupSpec, ...]
    paths: Tuple[str, ...]

    @property
    def leaf(self) -> ResourceGroupSpec:
        return self.specs[-1]

    @property
    def name(self) -> str:
        return self.paths[-1]


class QueryQueueFullError(RuntimeError):
    """Reference: QUERY_QUEUE_FULL error code."""


class ResourceGroupManager:
    """Admission: select the first matching leaf (depth-first); a query
    holds a queue slot, then a concurrency slot, then (optionally)
    reserved memory at EVERY level of its path."""

    # lock discipline: the per-path slot/
    # queue/memory tallies plus the fair-scheduling waiter line are
    # shared across every query's admission thread
    _shared_attrs = ("_running", "_queued", "_memory", "_waiters",
                     "_ticket")

    # aging rate for fair scheduling: one effective-priority point per
    # this many seconds queued, so a low-priority waiter overtakes a
    # priority-P stream of arrivals after P * this many seconds —
    # bounded starvation by construction
    AGING_PRIORITY_PER_S = 2.0

    def __init__(self, groups: Optional[List[ResourceGroupSpec]] = None):
        self.groups = list(groups or [ResourceGroupSpec("global")])
        self._lock = make_lock(
            "server.resource_groups.ResourceGroupManager._lock")
        self._cv = make_condition(lock=self._lock)
        self._running: Dict[str, int] = {}
        self._queued: Dict[str, int] = {}
        self._memory: Dict[str, int] = {}
        # fair scheduling: the live waiter line —
        # [selection, arrival time, ticket] per blocked acquire —
        # ranked by (effective priority desc, ticket asc)
        self._waiters: List[list] = []
        self._ticket = 0
        self._all_paths: List[Tuple[str, ResourceGroupSpec]] = []

        def walk(g: ResourceGroupSpec, prefix: str):
            path = f"{prefix}.{g.name}" if prefix else g.name
            self._running[path] = 0
            self._queued[path] = 0
            self._memory[path] = 0
            self._all_paths.append((path, g))
            for s in g.sub_groups:
                walk(s, path)

        for g in self.groups:
            walk(g, "")
        register_owner(self)

    # ---------------------------------------------------------- selection
    def select(self, user: str) -> GroupSelection:
        def descend(g: ResourceGroupSpec, prefix: str):
            if not re.fullmatch(g.user_pattern, user or ""):
                return None
            path = f"{prefix}.{g.name}" if prefix else g.name
            if not g.sub_groups:
                return ((g,), (path,))
            for s in g.sub_groups:
                found = descend(s, path)
                if found is not None:
                    return ((g,) + found[0], (path,) + found[1])
            return None  # parent matched but no leaf did

        for g in self.groups:
            found = descend(g, "")
            if found is not None:
                return GroupSelection(found[0], found[1])
        raise QueryQueueFullError(
            f"no resource group matches user {user!r}"
        )

    # ---------------------------------------------------------- admission
    def admit(self, user: str) -> GroupSelection:
        """Queue-slot check at submit time, at every level (reference:
        the coordinator rejects before planning)."""
        sel = self.select(user)
        with self._lock:
            for spec, path in zip(sel.specs, sel.paths):
                if self._queued[path] >= spec.max_queued:
                    raise QueryQueueFullError(
                        f"resource group {path!r} queue is full "
                        f"({spec.max_queued})"
                    )
            for path in sel.paths:
                self._queued[path] += 1
        return sel

    def _slots_free_locked(self, sel: GroupSelection) -> bool:
        return all(
            self._running[path] < spec.hard_concurrency
            for spec, path in zip(sel.specs, sel.paths)
        )

    def _front_of_line_locked(self, entry: list) -> bool:
        """Fair scheduling: ``entry`` may claim its slots
        only when it ranks first — by (effective priority desc,
        arrival ticket asc) — among the waiters whose OWN groups have
        capacity right now. Effective priority = the leaf's configured
        priority plus time queued over AGING_PRIORITY_PER_S, so a
        short interactive query jumps a saturated line immediately
        while a long-scan waiter ages its way up instead of starving.
        A high-priority waiter whose group is itself full never blocks
        an admissible one (eligibility is capacity-filtered)."""
        now = time.monotonic()

        def rank(e):
            sel, arrival, ticket = e
            eff = sel.leaf.priority + (
                (now - arrival) / self.AGING_PRIORITY_PER_S
            )
            return (-eff, ticket)

        best = None
        for e in self._waiters:
            if not self._slots_free_locked(e[0]):
                continue
            if best is None or rank(e) < rank(best):
                best = e
        return best is entry

    def acquire(self, sel: GroupSelection, should_abort=None) -> bool:
        """Block until every level of the path has a concurrency slot
        (QUEUED -> RUNNING) AND this waiter is first in the fair-
        scheduling line for those slots. Returns False when aborted
        (queue slots already released)."""
        with self._cv:
            self._ticket += 1
            entry = [sel, time.monotonic(), self._ticket]
            self._waiters.append(entry)
            try:
                while True:
                    if (self._slots_free_locked(sel)
                            and self._front_of_line_locked(entry)):
                        for path in sel.paths:
                            self._queued[path] -= 1
                            self._running[path] += 1
                        return True
                    if should_abort is not None and should_abort():
                        for path in sel.paths:
                            self._queued[path] -= 1
                        return False
                    self._cv.wait(timeout=0.05)
            finally:
                self._waiters.remove(entry)
                # the line changed: the next-ranked waiter must
                # re-evaluate _front_of_line_locked
                self._cv.notify_all()

    def release(self, sel: GroupSelection) -> None:
        with self._cv:
            for path in sel.paths:
                self._running[path] -= 1
            self._cv.notify_all()

    def cancel_queued(self, sel: GroupSelection) -> None:
        """A query canceled before acquire gives its queue slots back."""
        with self._lock:
            for path in sel.paths:
                self._queued[path] -= 1

    # ------------------------------------------------------------- memory
    def reserve_memory(self, sel: GroupSelection, nbytes: int,
                       should_abort=None) -> bool:
        """Block until the estimate fits under every level's memory
        quota (reference: soft_memory_limit gating eligibility). A
        query larger than a quota alone is admitted only when that
        group holds no other memory, mirroring the MemoryArbiter's
        stance. Returns False when aborted."""
        with self._cv:
            while True:
                blocked = False
                for spec, path in zip(sel.specs, sel.paths):
                    limit = spec.max_memory_bytes
                    if not limit:
                        continue
                    used = self._memory[path]
                    if used + nbytes > limit and used > 0:
                        blocked = True
                        break
                if not blocked:
                    for path in sel.paths:
                        self._memory[path] += nbytes
                    return True
                if should_abort is not None and should_abort():
                    return False
                self._cv.wait(timeout=0.05)

    def release_memory(self, sel: GroupSelection, nbytes: int) -> None:
        with self._cv:
            for path in sel.paths:
                self._memory[path] -= nbytes
            self._cv.notify_all()

    def memory_share_for(self, sel: GroupSelection) -> float:
        """The device-memory share governing queries admitted through this
        selection: the most specific (deepest) nonzero ``memory_share``
        along the path wins; 0.0 = no share configured. The server
        resolves it against the device budget via
        exec/membudget.group_share_bytes and seeds each admitted
        query's device_memory_budget, so N concurrent queries split
        the device by policy instead of colliding into the OOM
        ladder."""
        for spec in reversed(sel.specs):
            if spec.memory_share > 0:
                return spec.memory_share
        return 0.0

    # ----------------------------------------------------------- introspection
    def snapshot(self) -> List[dict]:
        with self._lock:
            return [
                {
                    "name": path,
                    "userPattern": g.user_pattern,
                    "hardConcurrency": g.hard_concurrency,
                    "maxQueued": g.max_queued,
                    "maxMemoryBytes": g.max_memory_bytes,
                    "priority": g.priority,
                    "memoryShare": g.memory_share,
                    "running": self._running[path],
                    "queued": self._queued[path],
                    "reservedMemoryBytes": self._memory[path],
                }
                for path, g in self._all_paths
            ]
