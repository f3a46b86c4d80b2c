"""Bounded per-group value collection: the state behind array_agg,
map_agg and approx_percentile.

Port of presto_tpu/ops/collect.py (reference: presto-main
operator/aggregation/ArrayAggregationFunction, MapAggregationFunction
and ApproximatePercentileAggregations). Every group owns K slots of a
[cap, K] int64 state matrix (K = the ``array_agg_max_elements`` session
property); a group past K raises the overflow flag, and the query
re-runs with K scaled by the capacity boost. Values encode into int64
(exec/executor._collect_encode: integers, dates, booleans and short
decimals directly, dictionary-coded types by code, floats through an
order-preserving sign/exponent/mantissa pack). approx_percentile sorts
each group's slots and selects: exact within the K bound.

Null semantics (the reference's): array_agg INCLUDES null elements (a
parallel null-flag matrix rides the state); map_agg skips null keys but
keeps null values; approx_percentile ignores nulls. Row order within a
group follows input order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _group_ranks(ids: torch.Tensor):
    """Stable group sort of ``ids`` (invalid rows carry the largest id,
    so they sort last): (perm, sorted ids, rank of each sorted row
    within its group)."""
    n = ids.shape[0]
    perm = torch.argsort(ids, stable=True)
    sid = ids[perm]
    idxs = torch.arange(n, dtype=torch.int64, device=ids.device)
    boundary = torch.ones(n, dtype=torch.bool, device=ids.device)
    boundary[1:] = sid[1:] != sid[:-1]
    run_start = torch.cummax(torch.where(boundary, idxs, 0), 0).values
    return perm, sid, idxs - run_start


def _scatter(flat: torch.Tensor, vals: torch.Tensor, out_cap: int,
             K: int) -> torch.Tensor:
    """[out_cap, K] state from (flat slot, value) pairs; flat ==
    out_cap * K is the drop slot."""
    state = torch.zeros(out_cap * K + 1, dtype=torch.int64,
                        device=vals.device)
    state[flat] = vals
    return state[:out_cap * K].reshape(out_cap, K)


def insert(
    group_ids: torch.Tensor,
    contributing: torch.Tensor,
    out_cap: int,
    vals_i64: torch.Tensor,
    K: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collect contributing rows' values into [out_cap, K] group slots
    (input order). Returns (state, overflow: any group exceeded K)."""
    ids = torch.where(contributing, group_ids.to(torch.int64), out_cap)
    perm, sid, rank = _group_ranks(ids)
    member = sid < out_cap
    flat = torch.where(member & (rank < K), sid * K + rank, out_cap * K)
    state = _scatter(flat, vals_i64[perm], out_cap, K)
    return state, (member & (rank >= K)).any()


def merge(
    group_ids: torch.Tensor,
    row_valid: torch.Tensor,
    out_cap: int,
    state: torch.Tensor,
    counts: torch.Tensor,
    K: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge partial collect states: each input row carries a [K] slot
    vector holding ``counts`` values; they concatenate per output group
    in row order. Returns (merged [out_cap, K], overflow)."""
    counts = torch.where(row_valid, counts.to(torch.int64), 0)
    ids = torch.where(row_valid, group_ids.to(torch.int64), out_cap)
    perm, sid, _rank = _group_ranks(ids)
    csort = counts[perm]
    # each input row's base offset inside its output group: the
    # segmented exclusive prefix sum of earlier member rows' counts
    n = ids.shape[0]
    boundary = torch.ones(n, dtype=torch.bool, device=ids.device)
    boundary[1:] = sid[1:] != sid[:-1]
    excl = torch.cumsum(csort, 0) - csort
    base = excl - torch.cummax(torch.where(boundary, excl, 0), 0).values
    k_idx = torch.arange(K, dtype=torch.int64, device=ids.device)[None, :]
    tgt_rank = base[:, None] + k_idx  # [n, K]
    live = (k_idx < csort[:, None]) & (sid[:, None] < out_cap)
    flat = torch.where(live & (tgt_rank < K), sid[:, None] * K + tgt_rank,
                       out_cap * K)
    merged = _scatter(flat.reshape(-1), state[perm].reshape(-1), out_cap, K)
    return merged, (live & (tgt_rank >= K)).any()


def percentile_select(
    state: torch.Tensor,
    counts: torch.Tensor,
    fraction: float,
    K: int,
) -> torch.Tensor:
    """Per-group percentile over collected values: mask-pad, sort each
    row, select index ceil(p * count) - 1 (the lower-interpolation
    percentile of the value multiset). The float slot encoding is
    order-preserving, so int64 order serves every element type."""
    k_idx = torch.arange(K, dtype=torch.int64, device=state.device)[None, :]
    padded = torch.where(k_idx < counts[:, None], state,
                         torch.iinfo(torch.int64).max)
    s = torch.sort(padded, dim=-1).values
    want = torch.ceil(fraction * counts.to(torch.float64)).to(torch.int64)
    pick = torch.minimum(torch.maximum(want - 1, torch.zeros_like(want)),
                         (counts - 1).clamp(min=0))
    # a count past K belongs to an overflowed attempt, which re-runs:
    # keep its gather in bounds
    return torch.gather(s, 1, pick.clamp(max=K - 1)[:, None])[:, 0]
