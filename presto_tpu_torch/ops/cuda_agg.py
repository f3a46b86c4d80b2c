"""K1: the segmented-sum aggregation kernel and its plain twin.

Port of presto_tpu/ops/pallas_agg.py. The contract is the reference's:
exact wrapping int64 per-group sums and counts over group ids, rows
whose id lies outside [0, G) dropping out; ``aggregate`` is a drop-in
for ops/agg.aggregate over the supported kinds (SUM on integers, COUNT,
COUNT(*), BOOL_OR, BOOL_AND) with G <= 4096 groups, and delegates every
other kind and shape back to it, exactly as ``supported()`` routes them
in the reference. ``global_aggregate`` is the same dispatch for
ungrouped aggregates (one group).

On a CUDA tensor the wrapper launches csrc/segsum.cu (or raises); on a
CPU tensor it runs the plain version, an int64 ``index_add_``. Both
wrap modulo 2^64, so they agree bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from presto_tpu_torch import cuda
from presto_tpu_torch.ops import agg as A

# group capacity ceiling: the shared-memory accumulator is 8 B x G
MAX_GROUPS = A.MATMUL_AGG_MAX_GROUPS

KERNEL = "segsum"

# kinds the kernel computes; everything else falls back to ops/agg
# (float SUM keeps its own accumulation order, MIN/MAX/ANY are
# gather-shaped)
SUPPORTED_KINDS = (A.SUM, A.COUNT, A.COUNT_STAR, A.BOOL_OR, A.BOOL_AND)


def segsum_plain(ids: torch.Tensor, values: Optional[torch.Tensor],
                 num_groups: int) -> torch.Tensor:
    """The plain version: int64[G] sums of ``values`` (counts when None)
    over ids in [0, G)."""
    keep = (ids >= 0) & (ids < num_groups)
    idx = torch.where(keep, ids.to(torch.int64), num_groups)
    src = (torch.ones_like(idx) if values is None
           else values.to(torch.int64))
    out = torch.zeros(num_groups + 1, dtype=torch.int64, device=ids.device)
    return out.index_add_(0, idx, src)[:num_groups]


def segsum_cuda(ids: torch.Tensor, values: Optional[torch.Tensor],
                num_groups: int) -> torch.Tensor:
    """The kernel: same function as segsum_plain, on the card."""
    dev = ids.device
    cuda.check_tensor(ids, "ids", torch.int32, dev)
    if values is not None:
        cuda.check_tensor(values, "values", torch.int64, dev)
        if values.shape != ids.shape:
            raise ValueError("values and ids differ in length")
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"num_groups {num_groups} outside [1, {MAX_GROUPS}]")
    out = torch.empty(num_groups, dtype=torch.int64, device=dev)
    cuda.call("segsum", "presto_segsum_i64", dev, ids.data_ptr(),
              values.data_ptr() if values is not None else None,
              ids.shape[0], num_groups, out.data_ptr())
    cuda.count(cuda.launches, KERNEL)
    return out


def segsum(ids: torch.Tensor, values: Optional[torch.Tensor],
           num_groups: int) -> torch.Tensor:
    """Dispatch on where the tensors lie: the kernel on the card, the
    plain version on the CPU."""
    if ids.is_cuda:
        return segsum_cuda(ids.to(torch.int32).contiguous(),
                           None if values is None
                           else values.to(torch.int64).contiguous(),
                           num_groups)
    cuda.count(cuda.plain_calls, KERNEL)
    return segsum_plain(ids, values, num_groups)


def segmented_sum_i64(values: torch.Tensor, ids: torch.Tensor,
                      num_groups: int) -> torch.Tensor:
    """Exact int64 per-group sum of ``values`` (any integer dtype); rows
    with id outside [0, num_groups) contribute 0."""
    return segsum(ids, values, num_groups)


def segmented_count(ids: torch.Tensor, num_groups: int) -> torch.Tensor:
    """int64 per-group row count (ids outside [0, num_groups) drop)."""
    return segsum(ids, None, num_groups)


def supported(kind: str, num_groups: int, data) -> bool:
    """Whether this (kind, shape) runs on the kernel; callers fall back
    to ops/agg otherwise."""
    if kind not in SUPPORTED_KINDS or num_groups > MAX_GROUPS:
        return False
    if isinstance(data, tuple):  # long-decimal limb pairs
        return False
    if kind == A.SUM:
        return data is not None and not data.dtype.is_floating_point \
            and data.dtype != torch.bool
    return True


def _bool_result(kind, trues, ncontrib, empty):
    if kind == A.BOOL_OR:
        return trues > 0, empty
    return (trues == ncontrib) & ~empty, empty


def _valid_counts(groups: A.GroupbyResult, out_capacity: int):
    """Valid rows per group, counted once per grouping (or taken from
    the dense path, which counted them already) and shared by every
    state whose input has no nulls."""
    if groups.valid_counts is None:
        ids = torch.where(groups.row_valid, groups.group_ids, out_capacity)
        groups.valid_counts = segmented_count(ids, out_capacity)
    return groups.valid_counts


def aggregate(
    groups: A.GroupbyResult,
    kind: str,
    out_capacity: int,
    data: Optional[torch.Tensor] = None,
    nulls: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Drop-in for ops/agg.aggregate: same SQL semantics (SUM over zero
    non-null inputs is NULL, COUNT is 0), same (values[out_capacity],
    null_mask) shape, group totals from the kernel."""
    if not supported(kind, out_capacity, data):
        return A.aggregate(groups, kind, out_capacity, data, nulls)
    if kind == A.COUNT_STAR:
        return _valid_counts(groups, out_capacity), None
    contributing = groups.row_valid
    if nulls is not None:
        contributing = contributing & ~nulls
    cids = torch.where(contributing, groups.group_ids, out_capacity)
    ncontrib = (_valid_counts(groups, out_capacity) if nulls is None
                else segmented_count(cids, out_capacity))
    empty = ncontrib == 0
    if kind == A.COUNT:
        return ncontrib, None
    if kind == A.SUM:
        totals = segmented_sum_i64(data, cids, out_capacity)
        return totals.to(data.dtype), empty
    trues = segmented_count(
        torch.where(data.to(torch.bool), cids, out_capacity), out_capacity)
    return _bool_result(kind, trues, ncontrib, empty)


def global_aggregate(
    kind: str,
    valid: torch.Tensor,
    data: Optional[torch.Tensor] = None,
    nulls: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ops/agg.global_aggregate: the ungrouped aggregate as
    one group (id 0; non-contributing rows get id 1 and drop)."""
    if not supported(kind, 1, data):
        return A.global_aggregate(kind, valid, data, nulls)
    false = torch.zeros((), dtype=torch.bool, device=valid.device)
    if kind == A.COUNT_STAR:
        return segmented_count((~valid).to(torch.int32), 1)[0], false
    contributing = valid
    if nulls is not None:
        contributing = contributing & ~nulls
    ids = (~contributing).to(torch.int32)
    n = segmented_count(ids, 1)[0]
    empty = n == 0
    if kind == A.COUNT:
        return n, false
    if kind == A.SUM:
        return segmented_sum_i64(data, ids, 1)[0].to(data.dtype), empty
    trues = segmented_count(
        torch.where(data.to(torch.bool), ids, 1), 1)[0]
    return _bool_result(kind, trues, n, empty)
