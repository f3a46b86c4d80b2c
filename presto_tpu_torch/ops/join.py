"""Equi-join: sort-searchsorted hash join with fixed-capacity match
expansion.

Port of presto_tpu/ops/join.py:
  build:  hash build keys -> sort build rows by hash
  probe:  searchsorted(left/right) gives each probe row a candidate
          range [lo, hi)
  expand: fixed-capacity output; slot j belongs to probe row
          searchsorted(cumsum(counts), j) at offset j - prefix
  verify: gathered candidate keys compared for true equality, so 64-bit
          hash collisions cost only wasted slots, never wrong results
The hash-table kernels of ops/cuda_join.py replace the searchsorted
range finder; expand_matches is shared.

Hashes are u64 bit-views (ops/u64.py): sorting and searchsorted run on
their sign-flipped signed order.

Reference: presto-main operator/HashBuilderOperator.java and
LookupJoinOperator.java.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from presto_tpu_torch.ops import hashing as H
from presto_tpu_torch.ops import u64


@dataclasses.dataclass
class JoinMatches:
    probe_idx: torch.Tensor  # int64[out_cap] probe row per slot
    build_idx: torch.Tensor  # int64[out_cap] build row per slot
    match: torch.Tensor  # bool[out_cap] verified match
    probe_match_count: torch.Tensor  # int64[probe_cap]
    build_matched: torch.Tensor  # bool[build_cap]
    total_candidates: torch.Tensor  # device scalar (pre-verification)
    overflow: torch.Tensor  # device bool


def _fold_nulls(
    cols: Sequence[torch.Tensor],
    nulls: Sequence[Optional[torch.Tensor]],
    null_equals_null: bool,
) -> tuple[List[torch.Tensor], torch.Tensor]:
    """Returns (normalized key cols, any_null_disqualifies mask). A NULL
    key never matches unless null_equals_null (IS NOT DISTINCT FROM)."""
    n = cols[0].shape[0]
    dev = cols[0].device
    any_null = torch.zeros(n, dtype=torch.bool, device=dev)
    out_cols: List[torch.Tensor] = []
    for c, nl in zip(cols, nulls):
        if nl is None:
            out_cols.append(c)
            if null_equals_null:
                out_cols.append(torch.zeros(n, dtype=torch.int64, device=dev))
            continue
        out_cols.append(torch.where(nl, 0, c))
        if null_equals_null:
            out_cols.append(nl.to(torch.int64))
        else:
            any_null = any_null | nl
    return out_cols, any_null


def searchsorted_u64(sorted_hash: torch.Tensor, values: torch.Tensor,
                     side: str) -> torch.Tensor:
    """searchsorted over u64 bit-views (both in unsigned order)."""
    return torch.searchsorted(u64.order(sorted_hash), u64.order(values),
                              side=side)


def build_join_index(
    build_cols: Sequence[torch.Tensor],
    build_nulls: Sequence[Optional[torch.Tensor]],
    build_valid: torch.Tensor,
    *,
    null_equals_null: bool = False,
):
    """Build-side index, computed once per join and reused by every
    probe page: (folded key cols, validity, hash-sorted array, sort
    permutation). Invalid rows poison to the max hash and sort last."""
    bcols, b_null_out = _fold_nulls(build_cols, build_nulls,
                                    null_equals_null)
    bvalid = build_valid & ~b_null_out
    bhash = H.hash_columns(bcols, [None] * len(bcols))
    poisoned = torch.where(bvalid, bhash, u64.POISON)
    perm = torch.argsort(u64.order(poisoned), stable=True)
    return (tuple(bcols), bvalid, poisoned[perm], perm)


def hash_join_match(
    build_cols, build_nulls, build_valid,
    probe_cols: Sequence[torch.Tensor],
    probe_nulls: Sequence[Optional[torch.Tensor]],
    probe_valid: torch.Tensor,
    out_capacity: int,
    *,
    null_equals_null: bool = False,
    index=None,
) -> JoinMatches:
    """Match probe rows against build rows on equality-encoded u64 keys.
    Pass a prebuilt ``index`` (build_join_index) to skip the build sort."""
    if index is None:
        index = build_join_index(build_cols, build_nulls, build_valid,
                                 null_equals_null=null_equals_null)
    bcols, bvalid, sorted_hash, perm = index
    pcols, p_null_out = _fold_nulls(probe_cols, probe_nulls,
                                    null_equals_null)
    pvalid = probe_valid & ~p_null_out
    phash = H.hash_columns(pcols, [None] * len(pcols))
    lo = searchsorted_u64(sorted_hash, phash, "left")
    hi = searchsorted_u64(sorted_hash, phash, "right")
    return expand_matches(bcols, bvalid, perm, pcols, pvalid, lo, hi - lo,
                          out_capacity)


def expand_matches(
    bcols,
    bvalid: torch.Tensor,
    perm: torch.Tensor,
    pcols,
    pvalid: torch.Tensor,
    lo: torch.Tensor,
    counts: torch.Tensor,
    out_capacity: int,
) -> JoinMatches:
    """Flatten per-probe-row candidate ranges [lo, lo+counts) over the
    hash-sorted build order ``perm`` into a fixed-capacity match list,
    verifying true key equality per slot. Shared by the sort join and
    the hash-table kernels — only the range finder differs."""
    build_cap = bvalid.shape[0]
    probe_cap = pvalid.shape[0]
    dev = pvalid.device
    counts = torch.where(pvalid, counts.to(torch.int64), 0)

    cum = torch.cumsum(counts, 0)
    total = cum[-1] if counts.shape[0] else torch.zeros(
        (), dtype=torch.int64, device=dev)
    overflow = total > out_capacity

    slots = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    pid = torch.searchsorted(cum, slots, side="right")
    pid_c = pid.clamp(0, probe_cap - 1)
    prev = torch.cat([cum.new_zeros(1), cum[:-1]])
    off = slots - prev[pid_c]
    sorted_pos = (lo[pid_c].to(torch.int64) + off).clamp(0, build_cap - 1)
    bid = perm[sorted_pos].to(torch.int64)

    in_range = slots < total
    match = in_range & pvalid[pid_c] & bvalid[bid]
    for bc, pc in zip(bcols, pcols):
        match = match & (bc[bid] == pc[pid_c])

    probe_match_count = torch.zeros(
        probe_cap + 1, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(match, pid_c, probe_cap),
        torch.ones_like(pid_c))[:probe_cap]
    build_matched = torch.zeros(build_cap + 1, dtype=torch.bool, device=dev)
    build_matched.index_fill_(0, torch.where(match, bid, build_cap), True)

    return JoinMatches(
        probe_idx=pid_c,
        build_idx=bid,
        match=match,
        probe_match_count=probe_match_count,
        build_matched=build_matched[:build_cap],
        total_candidates=total,
        overflow=overflow,
    )


def unique_join_lookup(
    bcols,
    bvalid: torch.Tensor,
    perm: torch.Tensor,
    pcols,
    pvalid: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
):
    """FK-join fast path: build keys are unique, so every probe row has
    <= 1 true match and the output is the probe page plus gathered build
    columns. Only the FIRST candidate is checked; a range wider than 1
    means distinct keys collided in the u64 hash, and ``collision``
    flags it for the boosted retry.

    Returns (build_idx[int64, probe_cap], found[bool], collision)."""
    build_cap = bvalid.shape[0]
    pos = lo.to(torch.int64).clamp(0, build_cap - 1)
    bid = perm[pos].to(torch.int64)
    found = ((hi - lo) >= 1) & pvalid & bvalid[bid]
    for bc, pc in zip(bcols, pcols):
        found = found & (bc[bid] == pc)
    collision = (pvalid & ((hi - lo) > 1)).any()
    return bid, found, collision


SEMI_WINDOW = 4


def semi_join_mask(
    build_cols: Sequence[torch.Tensor],
    build_nulls: Sequence[Optional[torch.Tensor]],
    build_valid: torch.Tensor,
    probe_cols: Sequence[torch.Tensor],
    probe_nulls: Sequence[Optional[torch.Tensor]],
    probe_valid: torch.Tensor,
) -> tuple:
    """Per-probe-row (has_match, null_result) for IN / semi-join
    predicates. null_result marks SQL three-valued unknown: the probe key
    is NULL, or there is no match while the build set holds a NULL
    (x IN (..., NULL) is NULL, not false).

    The build hashes sort with invalid rows poisoned to the largest u64
    (last in unsigned order); each probe row verifies the first
    SEMI_WINDOW candidates of its hash range, and a range wider than the
    window counts as a match on the hash alone (collision odds 2^-64).

    Reference: presto_tpu/ops/join.py semi_join_mask;
    operator/HashSemiJoinOperator.java + SetBuilderOperator."""
    bcols, b_null = _fold_nulls(build_cols, build_nulls, False)
    pcols, p_null = _fold_nulls(probe_cols, probe_nulls, False)
    bvalid = build_valid & ~b_null
    build_has_null = (build_valid & b_null).any()

    none_nulls = [None] * len(bcols)
    bhash = H.hash_columns(bcols, none_nulls)
    phash = H.hash_columns(pcols, none_nulls)
    poisoned = torch.where(bvalid, bhash, u64.POISON)
    perm = torch.argsort(u64.order(poisoned), stable=True)
    sorted_hash = poisoned[perm]
    lo = searchsorted_u64(sorted_hash, phash, "left")
    hi = searchsorted_u64(sorted_hash, phash, "right")

    has_match = torch.zeros_like(probe_valid)
    build_cap = bvalid.shape[0]
    for w in range(SEMI_WINDOW):
        bid = perm[(lo + w).clamp(0, build_cap - 1)]
        ok = (lo + w < hi) & bvalid[bid]
        for bc, pc in zip(bcols, pcols):
            ok = ok & (bc[bid] == pc)
        has_match = has_match | ok
    has_match = has_match | ((hi - lo) > SEMI_WINDOW)

    null_result = probe_valid & (p_null | (~has_match & build_has_null))
    return probe_valid & has_match & ~p_null, null_result
