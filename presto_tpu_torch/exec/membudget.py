"""Device-memory governor: plan-time device-memory budget accounting.

Port of presto_tpu/exec/membudget.py (reference: presto-main's
memory/MemoryPool + LocalMemoryContext hierarchy and the spill
decisions made under memory pressure). Every buffer capacity the
executor allocates quantizes onto the exec/shapes.py ladder, so a
pipeline's peak live device bytes is a static function of the plan,
checkable and fixable (by chunked rewrites) before anything launches.

The model:

    bytes(buffer)   = bucket(rows) * row_bytes        (the allocation)
    bytes(pipeline) = sum of concurrently-live buffer footprints
    chunks          = ceil(peak / budget-share)

Governed decisions, each a chunked rewrite of the pipeline rather than
a failure:

  - join builds:   grace-partition passes sized to fit (parts_for)
  - join outputs:  probe pages position-chunked so output capacity
                   stays under its share
  - scans:         generation chunk (page) size shrunk to fit
  - aggregations:  hash-partition passes when state exceeds its share
  - intermediates: PageStore host/disk tiers engage when a
                   materialization exceeds its share

The budget itself: session property ``device_memory_budget`` (bytes;
0 = auto). Auto resolves, for the executor's own device, to the card's
memory minus 1/8 headroom on CUDA (where the reference says "on TPU")
and to the generous CPU_BUDGET on the CPU, so the CPU tests see no
change unless they force a tiny budget.

The static audit mirrors the reference's without its buffer-donation
term: the port has no donated programs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from presto_tpu_torch.exec import shapes as SH

# Fraction of device memory held back from the governor: the CUDA
# context, the caching allocator's fragmentation, captured graphs'
# private pools. budget = memory * 7/8.
HEADROOM_DIV = 8

# CPU "budget": effectively unbounded at test scale, small enough that
# an absurd plan still trips the audit. 16 GiB.
CPU_BUDGET = 1 << 34

# Budget shares (divisors of the resolved budget):
#   join build materialization / aggregation state / sort-window merge
BUILD_SHARE_DIV = 4
#   a single join-output or landing page
PAGE_SHARE_DIV = 8
#   one scan generation buffer (many are live across a fused batch)
SCAN_SHARE_DIV = 8
#   a restreamable intermediate staying device-resident (PageStore)
STORE_SHARE_DIV = 2


def device_hbm_bytes(device) -> int:
    """Total memory of a CUDA device, from the CUDA runtime
    (``torch.cuda.mem_get_info``)."""
    return int(torch.cuda.mem_get_info(torch.device(device))[1])


def resolve_budget(setting: int, device="cpu") -> int:
    """device_memory_budget resolution for an executor on ``device`` (a
    torch.device or its type name): an explicit positive setting wins;
    0 (auto) = the card's memory minus headroom on CUDA, the generous
    CPU_BUDGET elsewhere."""
    if setting and int(setting) > 0:
        return int(setting)
    if torch.device(device).type != "cuda":
        return CPU_BUDGET
    hbm = device_hbm_bytes(device)
    return hbm - hbm // HEADROOM_DIV


def group_share_bytes(share: float, setting: int = 0,
                      device="cpu") -> int:
    """A resource group's fractional ``memory_share``
    (server/resource_groups.py) as the device_memory_budget of ONE
    admitted query: the share of the resolved whole-device budget,
    floored at 16 MiB so a tiny share still leaves the governor a
    workable chunk size (it rewrites pipelines to fit rather than
    failing them). 0 when no share is configured — the session or
    default budget applies unchanged."""
    if share <= 0:
        return 0
    total = resolve_budget(setting, device)
    return max(int(total * share), 1 << 24)


def rows_cap(row_bytes: int, budget: int,
             share_div: int) -> Optional[int]:
    """Largest governed buffer capacity (in rows, on the ladder) for a
    buffer of ``row_bytes``-wide rows claiming budget/share_div bytes.
    None = unconstrained (no budget). The reference also takes the
    TPU runtime's row fault line here, which no device of the port
    has."""
    if not budget:
        return None
    cap = max(budget // share_div // max(int(row_bytes), 1),
              SH.LADDER_MIN)
    # round DOWN to the ladder (bucket rounds up; a cap must not)
    b = SH.bucket(cap)
    return b if b <= cap else b >> 1


# ------------------------------------------------------------- audit
@dataclasses.dataclass
class BufferPlan:
    """One planned device buffer: what the executor will allocate for
    this node under the current session, per the shared sizing model."""

    label: str
    rows: int          # ladder-bucketed capacity
    row_bytes: int
    chunked: bool = False   # a governed rewrite resized/partitioned it

    @property
    def bytes(self) -> int:
        return self.rows * self.row_bytes


@dataclasses.dataclass
class AuditReport:
    budget: int
    buffers: List[BufferPlan]

    @property
    def peak_bytes(self) -> int:
        """Model pipeline peak: the sum of the two largest concurrent
        buffers plus half the third — a deliberate over- rather than
        under-estimate (streaming keeps most buffers dead)."""
        sizes = sorted((b.bytes for b in self.buffers), reverse=True)
        return sum(sizes[:2]) + (sizes[2] if len(sizes) > 2 else 0) // 2

    @property
    def max_buffer_bytes(self) -> int:
        return max((b.bytes for b in self.buffers), default=0)

    def over_budget(self) -> List[BufferPlan]:
        return [b for b in self.buffers if b.bytes > self.budget]

    @property
    def ok(self) -> bool:
        return not self.over_budget()

    @property
    def chunked_count(self) -> int:
        return sum(1 for b in self.buffers if b.chunked)


def audit(ex, node) -> AuditReport:
    """Static per-plan footprint prediction: walk the physical plan
    recording every device buffer the executor WILL allocate under its
    current knobs — the same sizing functions the streaming paths call,
    so the prediction and the execution cannot drift apart. No pages
    are generated and nothing touches the device."""
    from presto_tpu_torch.exec import plan as P
    from presto_tpu_torch.exec.executor import _row_bytes

    budget = ex._budget()
    buffers: List[BufferPlan] = []

    def add(label, rows, row_b, chunked=False):
        buffers.append(BufferPlan(label, SH.bucket(rows), max(row_b, 1),
                                  chunked=chunked))

    def emit_cap(n) -> Optional[int]:
        """Upper bound on the page capacity a subtree can EMIT — the
        executor's own clamps, which a raw cardinality estimate does
        not know about."""
        if isinstance(n, (P.Filter, P.Project, P.Exchange, P.Limit,
                          P.Output)):
            src = emit_cap(n.source)
            if isinstance(n, P.Limit):
                lim = SH.bucket(max(n.count + n.offset, 8))
                return lim if src is None else min(src, lim)
            return src
        if isinstance(n, P.Aggregation):
            if not n.group_channels:
                return SH.LADDER_MIN
            cap = SH.bucket(max(n.capacity, 8))
            if ex.agg_optimistic_rows:
                cap = min(cap, SH.bucket(ex.agg_optimistic_rows))
            return cap
        if isinstance(n, P.TopN):
            return SH.bucket(max(n.limit, 8))
        return None

    def walk(n):
        if isinstance(n, P.TableScan):
            types = ex.output_types(n)
            row_b = _row_bytes(types)
            target = ex._governed_target_rows(types, count=False)
            add(f"scan {n.table} page", target, row_b,
                chunked=target < ex.page_rows)
            return
        if isinstance(n, P.HashJoin):
            left_types = ex.output_types(n.left)
            right_types = ex.output_types(n.right)
            gj = ex._generated_join_info(n, left_types)
            if gj is not None:
                # build-free: zero join state, but the fused chain's
                # page carries left+right columns per slot, and the
                # governor chunks generation by that WIDEST width
                out_types = ex.output_types(n)
                out_row_b = _row_bytes(out_types)
                target = ex._governed_target_rows(
                    out_types, count=False, row_bytes=out_row_b)
                add(f"genjoin chain page ({n.join_type})", target,
                    out_row_b, chunked=target < ex.page_rows)
                walk(n.left)
                return
            row_b = _row_bytes(right_types)
            est_build = ex.estimate_rows(n.right)
            parts, governed = ex._join_parts(
                n, left_types, right_types, est_build, row_b)
            if parts == 1:
                per_pass = SH.bucket(est_build)
            else:
                # per-pass chunks carry 2x slack over 1/parts occupancy
                # (the same factor _join_parts governs for)
                per_pass = -(-SH.bucket(est_build) * 2 // parts)
            add(f"join build {n.join_type} (1/{parts} pass)",
                per_pass, row_b, chunked=governed)
            out_row_b = row_b + _row_bytes(left_types)
            oc_cap = rows_cap(out_row_b, budget, PAGE_SHARE_DIV)
            probe_rows = min(ex.page_rows,
                             SH.bucket(ex.estimate_rows(n.left)))
            oc = SH.bucket(min(max(probe_rows * 2, 8192),
                               max(4 * ex.page_rows, 1 << 19)))
            add(f"join output {n.join_type}",
                min(oc, oc_cap) if oc_cap else oc, out_row_b,
                chunked=bool(oc_cap and oc > oc_cap))
            walk(n.left)
            walk(n.right)
            return
        if isinstance(n, P.Aggregation):
            types = ex.output_types(n)
            row_b = _row_bytes(types)
            if not n.group_channels:
                add("global agg state", SH.LADDER_MIN, row_b)
            else:
                cap = SH.bucket(max(n.capacity, 8))
                if ex.agg_optimistic_rows:
                    cap = min(cap, SH.bucket(ex.agg_optimistic_rows))
                state_cap = rows_cap(row_b, budget, BUILD_SHARE_DIV)
                add("agg state", min(cap, state_cap) if state_cap
                    else cap, row_b,
                    chunked=bool(state_cap and cap > state_cap))
            walk(n.source)
            return
        if isinstance(n, (P.Sort, P.Window, P.MarkDistinct)):
            # blocking whole-input merge: no chunked rewrite exists for
            # these — the audit REPORTS them so an over-line plan fails
            # loudly before the device faults
            types = ex.output_types(n)
            est = ex.estimate_rows(n)
            cap = emit_cap(n.source)
            if cap is not None:
                est = min(est, cap)
            add(f"{type(n).__name__.lower()} merge", est,
                _row_bytes(types))
            walk(n.source)
            return
        if isinstance(n, P.CrossJoin):
            add("cross build", 4096,
                _row_bytes(ex.output_types(n.right)))
            walk(n.left)
            walk(n.right)
            return
        for c in n.children():
            walk(c)

    walk(node)
    return AuditReport(budget=budget, buffers=buffers)


def render(report: AuditReport) -> str:
    lines = [
        f"budget {report.budget / 1e6:.1f} MB; model peak "
        f"{report.peak_bytes / 1e6:.2f} MB; "
        f"{report.chunked_count} governed rewrites"
    ]
    for b in sorted(report.buffers, key=lambda x: -x.bytes):
        flag = ""
        if b.bytes > report.budget:
            flag = "  ** OVER BUDGET **"
        elif b.chunked:
            flag = "  [chunked]"
        lines.append(
            f"  {b.label:<38} {b.rows:>10} rows x {b.row_bytes:>4} B "
            f"= {b.bytes / 1e6:>10.2f} MB{flag}"
        )
    return "\n".join(lines)
