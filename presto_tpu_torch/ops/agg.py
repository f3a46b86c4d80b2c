"""Group-by as segmented reduction.

Port of presto_tpu/ops/agg.py:
  - **sorted path** (general): sort rows by null-aware key encodings,
    mark group boundaries, group id = prefix sum of boundaries; integer
    SUM/COUNT then run scatter-free over [start, end) cumsum
    differences.
  - **dense path** (small key spaces, e.g. dictionary-coded flags):
    group id computed arithmetically from codes (the Q1 fast path).
  - **hashed path** (small capacities): a lock-step linear-probing hash
    table built by scatter-min rounds.

Output is fixed-capacity with a group validity mask plus an ``overflow``
flag (true if the real group count exceeded capacity); the executor
retries with a larger capacity. The reference's MXU one-hot matmul tier
is TPU-only; on the card its role goes to the K1 kernel in
ops/cuda_agg.py, which the executor dispatches per aggregate.

Reference: presto-main operator/HashAggregationOperator.java and
GroupByHash.java, re-expressed as vectorized reductions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

# Primitive accumulator kinds. Compound SQL aggregates decompose into
# these (avg -> sum + count with a finalize divide).
SUM = "sum"
COUNT = "count"  # counts non-null inputs
COUNT_STAR = "count_star"
MIN = "min"
MAX = "max"
ANY = "any"  # arbitrary non-null value (grouped key passthrough)
BOOL_OR = "bool_or"
BOOL_AND = "bool_and"
# HyperLogLog kinds: tuple-data states, handled by the executor against
# ops/hll.py (never by aggregate() below)
HLL_INSERT = "hll_insert"
HLL_MERGE = "hll_merge"

# group capacity below which the reference aggregates on its MXU tier
# and the port on the K1 kernel; the executor sizes its paths by it
MATMUL_AGG_MAX_GROUPS = 4096

# hash-table probing rounds between host checks for convergence (a
# round after convergence changes nothing, so checking every few rounds
# keeps the results identical to checking every round; a CUDA graph
# capture may not read the device, so it records every round)
_CHECK_EVERY = 8

_BIG = (1 << 62)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _is_integer(t: torch.Tensor) -> bool:
    return not t.dtype.is_floating_point and t.dtype != torch.bool


@dataclasses.dataclass
class GroupbyResult:
    group_ids: torch.Tensor  # int64[cap_in] group id per input row (clipped)
    row_valid: torch.Tensor  # contributing rows (input valid)
    # int64[out_cap] representative input row; None on the dense path
    # with dense_sizes, whose key columns come from the group id
    rep_index: Optional[torch.Tensor]
    group_valid: torch.Tensor  # bool[out_cap]
    num_groups: torch.Tensor  # device scalar
    overflow: torch.Tensor  # device bool
    # dense path only: per-key code-space sizes (group id is the
    # mixed-radix encoding of the key codes)
    dense_sizes: Optional[Tuple[int, ...]] = None
    # int64[out_cap] valid rows per group: filled by the dense path,
    # which counts them anyway, or on first use by ops/cuda_agg, so every
    # state without nulls shares one count per grouping
    valid_counts: Optional[torch.Tensor] = None
    # sorted path only: the group-sort permutation, the per-SORTED-row
    # group id (invalid rows = out_cap), and each group's sorted span
    sort_perm: Optional[torch.Tensor] = None
    gid_sorted: Optional[torch.Tensor] = None
    seg_start: Optional[torch.Tensor] = None
    seg_end: Optional[torch.Tensor] = None


def _scatter_min(size: int, fill: int, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """out = full(size, fill); out[index] = min(out[index], src) — the
    reference's ``.at[index].min(src)`` with every index in range."""
    out = torch.full((size,), fill, dtype=src.dtype, device=src.device)
    return out.scatter_reduce_(0, index, src, "amin", include_self=True)


def _segment_sum(data: torch.Tensor, ids: torch.Tensor,
                 nseg: int) -> torch.Tensor:
    if data.is_floating_point() and data.is_cuda:
        return segment_sum_ordered(data, ids, nseg)
    out = torch.zeros(nseg, dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)


def segment_sum_ordered(data: torch.Tensor, ids: torch.Tensor,
                        nseg: int) -> torch.Tensor:
    """Float segment sums without atomics: rows sorted stably by
    segment, each segment reduced in a fixed order. On the card,
    ``index_add_`` on floats adds in whatever order its atomics land,
    so two runs of one task could spool different bits — and a replayed
    task must regenerate the consumed pages byte for byte (the stage
    scheduler's prefix check, dist/dcn._prefix_matches). Capturable in
    a CUDA graph: no host sync."""
    order = torch.argsort(ids, stable=True)
    lengths = torch.zeros(nseg, dtype=torch.int64,
                          device=ids.device).index_add_(
        0, ids, torch.ones_like(ids, dtype=torch.int64))
    return torch.segment_reduce(data[order], "sum", lengths=lengths,
                                unsafe=True, initial=0)


def compute_groups_sorted(
    key_cols: Sequence[torch.Tensor],
    key_nulls: Sequence[Optional[torch.Tensor]],
    valid: torch.Tensor,
    out_capacity: int,
) -> GroupbyResult:
    """Assign group ids via sort; no aggregation yet (reference analog:
    GroupByHash.getGroupIds)."""
    from presto_tpu_torch.ops import keys as K
    from presto_tpu_torch.ops.sort import packed_argsort

    parts = [((~valid).to(torch.int64), 1)]
    cmp_words: List[torch.Tensor] = []
    for col, null in zip(key_cols, key_nulls):
        if null is not None:
            nw = null.to(torch.int64)
            parts.append((nw, 1))
            cmp_words.append(nw)
            col = torch.where(null, 0, col)
        parts.append((col, 64))
        cmp_words.append(col)
    n = valid.shape[0]
    dev = valid.device
    perm = packed_argsort(K.pack_sort_keys(parts), n)
    svalid = valid[perm]

    # row 0 starts a group; every later row where a key word changes
    # (no scalar writes: a CUDA graph capture may not copy from the host)
    diff = _arange(n, dev) == 0
    for k in cmp_words:
        sk = k[perm]
        diff[1:] |= sk[1:] != sk[:-1]
    boundary = svalid & diff
    gid_sorted = torch.cumsum(boundary.to(torch.int64), 0) - 1
    num_groups = boundary.sum(dtype=torch.int64)
    overflow = num_groups > out_capacity

    # scatter sorted-order group ids back to input order
    gids = torch.zeros(n, dtype=torch.int64, device=dev)
    gids[perm] = gid_sorted.clamp(0, out_capacity - 1)

    # group g occupies sorted positions [start[g], end[g]); ids from the
    # sort are consecutive, so end[g] = start[g + 1]
    gid_x = torch.where(svalid, gid_sorted, out_capacity)
    idxs = _arange(n, dev)
    n_valid = svalid.sum(dtype=torch.int64)
    start = _scatter_min(
        out_capacity + 1, n,
        torch.where(boundary & (gid_sorted < out_capacity), gid_sorted,
                    out_capacity),
        idxs,
    )
    start = torch.minimum(start, n_valid)
    seg_start = start[:out_capacity]
    seg_end = torch.cat([start[1:out_capacity], n_valid[None]])
    seg_end = torch.maximum(seg_start, seg_end)
    rep = perm[seg_start.clamp(0, n - 1)]
    group_valid = _arange(out_capacity, dev) < num_groups
    return GroupbyResult(
        group_ids=gids,
        row_valid=valid,
        rep_index=rep,
        group_valid=group_valid,
        num_groups=num_groups,
        overflow=overflow,
        sort_perm=perm,
        gid_sorted=gid_x,
        seg_start=seg_start,
        seg_end=seg_end,
    )


def compute_groups_dense(
    group_ids: torch.Tensor,
    valid: torch.Tensor,
    num_groups: int,
    out_capacity: Optional[int] = None,
    sizes: Optional[Tuple[int, ...]] = None,
) -> GroupbyResult:
    """Group ids already computed arithmetically (gid = code_a * |dict_b|
    + code_b): static group count, no sort, no hash table. Outputs pad
    to out_capacity (>= num_groups). With ``sizes`` the caller rebuilds
    the key columns from the group id, so no representative rows are
    computed (the reference's jit drops them as dead code; eager torch
    would scatter them on every page)."""
    cap = out_capacity or num_groups
    assert cap >= num_groups
    dev = valid.device
    ids = torch.where(valid, group_ids.to(torch.int64), num_groups)
    counts = _segment_sum(torch.ones_like(ids), ids, num_groups + 1)
    pad = cap - num_groups
    counts = torch.nn.functional.pad(counts[:num_groups], (0, pad))
    group_valid = counts > 0
    rep = None
    if sizes is None:
        # representative row per group: min input index holding that gid
        idx = _arange(valid.shape[0], dev)
        rep = _scatter_min(num_groups + 1, torch.iinfo(torch.int64).max,
                           ids, torch.where(valid, idx, _BIG))[:num_groups]
        rep = torch.nn.functional.pad(rep.clamp(0, valid.shape[0] - 1),
                                      (0, pad))
    return GroupbyResult(
        group_ids=ids.clamp(0, cap - 1),
        row_valid=valid,
        rep_index=rep,
        group_valid=group_valid,
        num_groups=group_valid.sum(dtype=torch.int64),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        dense_sizes=sizes,
        valid_counts=counts,
    )


def compute_groups_hashed(
    key_cols: Sequence[torch.Tensor],
    key_nulls: Sequence[Optional[torch.Tensor]],
    valid: torch.Tensor,
    out_capacity: int,
    max_iters: int = 64,
) -> GroupbyResult:
    """Group assignment via a vectorized linear-probing hash table. Each
    round, every unsettled row claims its current slot with a
    scatter-min of its row index, then checks whether the slot's owner
    carries an equal key; matching rows settle, losers probe the next
    slot. Deterministic (scatter-min commutes). Unresolved rows after
    max_iters, or more groups than out_capacity, set the overflow flag."""
    from presto_tpu_torch.ops import hashing as H

    n = valid.shape[0]
    dev = valid.device
    cols: List[torch.Tensor] = []
    for c, nl in zip(key_cols, key_nulls):
        if nl is None:
            cols.append(c.to(torch.int64))
        else:
            # fold the null flag in as its own word: NULL groups with NULL
            cols.append(torch.where(nl, 0, c.to(torch.int64)))
            cols.append(nl.to(torch.int64))
    h = H.hash_columns(cols, [None] * len(cols))

    cap = max(2 * out_capacity, 16)
    cap = 1 << (cap - 1).bit_length()  # pow2 for mask probing
    mask = cap - 1
    row_idx = _arange(n, dev)
    slot = h & mask

    def key_eq_owner(owner, slot):
        """settled mask: does the row's slot owner carry an equal key?"""
        win = owner[slot]
        winc = win.clamp(0, n - 1)
        ok = win < n
        for c in cols:
            ok = ok & (c[winc] == c)
        return valid & ok

    owner = torch.full((cap,), n, dtype=torch.int64, device=dev)
    capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and not capturing and not bool(
                (valid & ~key_eq_owner(owner, slot)).any()):
            break
        settled = key_eq_owner(owner, slot)
        claim = torch.where(settled | ~valid, n, row_idx)
        owner.scatter_reduce_(0, slot, claim, "amin", include_self=True)
        settled2 = key_eq_owner(owner, slot)
        slot = torch.where(settled2 | ~valid, slot, (slot + 1) & mask)

    settled = key_eq_owner(owner, slot)
    unresolved = (valid & ~settled).any()
    # occupied slots = slots some row actually settled in
    used = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    used.index_fill_(0, torch.where(settled, slot, cap), True)
    used = used[:cap]
    gid_slot = torch.cumsum(used.to(torch.int64), 0) - 1
    num_groups = used.sum(dtype=torch.int64)
    overflow = unresolved | (num_groups > out_capacity)

    gids = gid_slot[slot].clamp(0, out_capacity - 1)
    rep = _scatter_min(out_capacity + 1, _BIG,
                       torch.where(settled, gids, out_capacity),
                       row_idx)[:out_capacity]
    rep = rep.clamp(0, n - 1)
    group_valid = _arange(out_capacity, dev) < num_groups
    return GroupbyResult(
        group_ids=gids,
        row_valid=valid & settled,
        rep_index=rep,
        group_valid=group_valid,
        num_groups=num_groups,
        overflow=overflow,
    )


def _minmax_identity(dtype, is_min: bool):
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    if dtype == torch.bool:
        return is_min
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _sorted_aggregate(
    groups: GroupbyResult,
    kind: str,
    out_capacity: int,
    data: Optional[torch.Tensor],
    nulls: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scatter-free segmented reduction over the sorted group layout:
    gather rows into group order, one cumulative sum, difference at group
    boundaries. Exact for integers. A float SUM (on the card only)
    reduces each group's span instead, in a fixed order: the rows are
    already in group order, so no second sort (segment_sum_ordered)."""
    perm, gidx = groups.sort_perm, groups.gid_sorted
    contributing_sorted = gidx < out_capacity
    if nulls is not None:
        contributing_sorted = contributing_sorted & ~nulls[perm]

    if kind == SUM:
        x = torch.where(contributing_sorted, data[perm], 0)
    elif kind in (BOOL_OR, BOOL_AND):
        x = (contributing_sorted & data[perm].to(torch.bool)).to(torch.int64)
    else:  # COUNT / COUNT_STAR
        x = contributing_sorted.to(torch.int64)

    zero = x.new_zeros(1)
    start, end = groups.seg_start, groups.seg_end
    if x.is_floating_point():
        # valid rows sort first and group g spans [start[g], end[g]),
        # so the spans tile the valid prefix in order
        totals = torch.segment_reduce(x, "sum", lengths=end - start,
                                      unsafe=True, initial=0)
    else:
        pcs = torch.cat([zero, torch.cumsum(x, 0, dtype=x.dtype)])
        totals = pcs[end] - pcs[start]

    if kind == COUNT_STAR:
        return totals, None
    ncontrib = end - start
    if nulls is not None:
        pcn = torch.cat([
            zero.to(torch.int64),
            torch.cumsum(contributing_sorted.to(torch.int64), 0),
        ])
        ncontrib = pcn[end] - pcn[start]
    empty = ncontrib == 0
    if kind == COUNT:
        return ncontrib, None
    if kind == BOOL_OR:
        return totals > 0, empty
    if kind == BOOL_AND:
        return (totals == ncontrib) & ~empty, empty
    return totals, empty  # SUM


def aggregate(
    groups: GroupbyResult,
    kind: str,
    out_capacity: int,
    data: Optional[torch.Tensor] = None,
    nulls: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One primitive aggregation over assigned group ids.

    Returns (values[out_capacity], null_mask or None). SQL semantics: SUM
    / MIN / MAX / ANY over zero non-null inputs yield NULL; COUNT yields
    0."""
    ids = torch.where(groups.row_valid, groups.group_ids, out_capacity)
    nseg = out_capacity + 1
    if (groups.sort_perm is not None
            and kind in (SUM, COUNT, COUNT_STAR, BOOL_OR, BOOL_AND)
            and (data is None or not isinstance(data, tuple))
            and (kind != SUM or _is_integer(data) or data.is_cuda)):
        return _sorted_aggregate(groups, kind, out_capacity, data, nulls)

    if kind == COUNT_STAR:
        return _segment_sum(torch.ones_like(ids), ids, nseg)[
            :out_capacity], None

    assert data is not None
    contributing = groups.row_valid
    if nulls is not None:
        contributing = contributing & ~nulls
    cids = torch.where(contributing, groups.group_ids, out_capacity)
    ncontrib = _segment_sum(torch.ones_like(cids), cids, nseg)[:out_capacity]
    empty = ncontrib == 0

    if kind == COUNT:
        return ncontrib, None
    if kind == SUM:
        out = _segment_sum(torch.where(contributing, data, 0).to(data.dtype),
                           cids, nseg)[:out_capacity]
        return out, empty
    if kind in (MIN, MAX):
        ident = _minmax_identity(data.dtype, kind == MIN)
        filled = torch.where(contributing, data,
                             torch.full_like(data, ident))
        out = torch.full((nseg,), ident, dtype=data.dtype,
                         device=data.device)
        out.scatter_reduce_(0, cids, filled, "amin" if kind == MIN
                            else "amax", include_self=True)
        out = torch.where(empty, torch.zeros((), dtype=data.dtype,
                                             device=data.device),
                          out[:out_capacity])
        return out, empty
    if kind == ANY:
        # value at min contributing row index
        idx = _arange(data.shape[0], data.device)
        first = _scatter_min(nseg, torch.iinfo(torch.int64).max, cids,
                             torch.where(contributing, idx, _BIG))
        first = first[:out_capacity].clamp(0, data.shape[0] - 1)
        return data[first], empty
    if kind in (BOOL_OR, BOOL_AND):
        # empty groups keep the reduction's identity, as jax's segment
        # max/min do (masked by the null flag either way)
        is_or = kind == BOOL_OR
        x = torch.where(contributing, data.to(torch.int32), 0 if is_or
                        else 1)
        out = torch.full((nseg,), _minmax_identity(torch.int32, not is_or),
                         dtype=torch.int32, device=data.device)
        out.scatter_reduce_(0, cids, x, "amax" if is_or else "amin",
                            include_self=True)
        return out[:out_capacity].to(torch.bool), empty
    raise ValueError(f"unknown aggregation kind: {kind}")


def global_sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of an ungrouped SUM: the reference's ``jnp.sum`` widens
    narrower integers to int64 (numpy's rule) and keeps float dtypes.
    Grouped sums keep the input dtype in both engines."""
    if dtype.is_floating_point or dtype == torch.bool:
        return dtype
    return torch.int64


def global_aggregate(
    kind: str,
    valid: torch.Tensor,
    data: Optional[torch.Tensor] = None,
    nulls: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ungrouped aggregation (reference: operator/AggregationOperator).
    Returns (scalar value, scalar is_null): COUNT of empty input is 0,
    SUM is NULL — global aggregates always produce exactly one row."""
    false = torch.zeros((), dtype=torch.bool, device=valid.device)
    if kind == COUNT_STAR:
        return valid.sum(dtype=torch.int64), false
    assert data is not None
    contributing = valid
    if nulls is not None:
        contributing = contributing & ~nulls
    n = contributing.sum(dtype=torch.int64)
    empty = n == 0
    if kind == COUNT:
        return n, false
    if kind == SUM:
        return (torch.where(contributing, data, 0).sum(
            dtype=global_sum_dtype(data.dtype)), empty)
    if kind in (MIN, MAX):
        ident = _minmax_identity(data.dtype, kind == MIN)
        filled = torch.where(contributing, data,
                             torch.full_like(data, ident))
        val = filled.min() if kind == MIN else filled.max()
        return torch.where(empty, torch.zeros_like(val), val), empty
    if kind == ANY:
        idx = _arange(data.shape[0], data.device)
        first = torch.where(contributing, idx, _BIG).min()
        return data[first.clamp(0, data.shape[0] - 1)], empty
    if kind == BOOL_OR:
        return (contributing & data.to(torch.bool)).any(), empty
    if kind == BOOL_AND:
        return (torch.where(contributing, data.to(torch.bool), True).all()
                & ~empty), empty
    raise ValueError(f"unknown aggregation kind: {kind}")


MERGE_KIND = {
    SUM: SUM,
    COUNT: SUM,
    COUNT_STAR: SUM,
    MIN: MIN,
    MAX: MAX,
    ANY: ANY,
    BOOL_OR: BOOL_OR,
    BOOL_AND: BOOL_AND,
}
