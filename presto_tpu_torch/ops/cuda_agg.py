"""K1: the segmented-sum aggregation kernel and its plain twin.

Port of presto_tpu/ops/pallas_agg.py. The contract is the reference's:
exact wrapping int64 per-group sums and counts over group ids, rows
whose id lies outside [0, G) dropping out; ``aggregate`` is a drop-in
for ops/agg.aggregate over the supported kinds (SUM on integers, COUNT,
COUNT(*), BOOL_OR, BOOL_AND) with G <= 4096 groups, and delegates every
other kind and shape back to it, exactly as ``supported()`` routes them
in the reference. ``global_aggregate`` is the same dispatch for
ungrouped aggregates (one group).

The kernel's function takes the group ids as they are (int64 or int32;
none for the ungrouped aggregate) and a row mask, and returns per-group
sums and counts of the contributing rows from one pass, so each
aggregate state is one kernel call. On a CUDA tensor the wrapper
launches csrc/segsum.cu (or raises); on a CPU tensor it runs the plain
version, an int64 ``index_add_``. Both wrap modulo 2^64, so they agree
bit for bit.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from presto_tpu_torch import cuda
from presto_tpu_torch.ops import agg as A

# group capacity ceiling: the kernel's shared accumulators are 12 B x G
MAX_GROUPS = A.MATMUL_AGG_MAX_GROUPS

KERNEL = "segsum"

# kinds the kernel computes; everything else falls back to ops/agg
# (float SUM keeps its own accumulation order, MIN/MAX/ANY are
# gather-shaped)
SUPPORTED_KINDS = (A.SUM, A.COUNT, A.COUNT_STAR, A.BOOL_OR, A.BOOL_AND)


def _rows(ids, values, mask) -> torch.Tensor:
    """The first given input (ids, mask or values): its length and device
    are the call's."""
    for t in (ids, mask, values):
        if t is not None:
            return t
    raise ValueError("segsum needs ids, a mask or values")


@functools.lru_cache(maxsize=None)
def _scratch_bytes(device: int, num_groups: int) -> int:
    """The scratch the kernel needs for its per-block partials (0: none);
    csrc/segsum.cu decides when it keeps partials and how many."""
    return cuda.function("segsum", "presto_segsum_scratch_bytes")(
        device, num_groups)


def segsum_plain(ids: Optional[torch.Tensor],
                 values: Optional[torch.Tensor],
                 mask: Optional[torch.Tensor], num_groups: int,
                 counts: bool = True):
    """The plain version: (int64[G] sums of ``values`` or None when no
    values are given, int64[G] counts or None when ``counts`` is False)
    over the rows whose ``mask`` is set (all when None) and whose id lies
    in [0, G) (group 0 for every row when ``ids`` is None)."""
    ref = _rows(ids, values, mask)
    dev = ref.device
    keep = (torch.ones(ref.shape[0], dtype=torch.bool, device=dev)
            if mask is None else mask.to(torch.bool))
    if ids is None:
        idx = torch.where(keep, 0, num_groups)
    else:
        keep = keep & (ids >= 0) & (ids < num_groups)
        idx = torch.where(keep, ids.to(torch.int64), num_groups)

    def total(src):
        out = torch.zeros(num_groups + 1, dtype=torch.int64, device=dev)
        return out.index_add_(0, idx, src)[:num_groups]

    sums = None if values is None else total(values.to(torch.int64))
    cnts = total(torch.ones_like(idx)) if counts else None
    return sums, cnts


def segsum_cuda(ids: Optional[torch.Tensor], values: Optional[torch.Tensor],
                mask: Optional[torch.Tensor], num_groups: int,
                counts: bool = True):
    """The kernel: same function as segsum_plain, on the card, from one
    pass over the rows. One call is one ``launches`` count: a memset and
    one kernel, or two kernels above 64 groups (per-block partials, then
    their sum)."""
    ref = _rows(ids, values, mask)
    dev, n = ref.device, ref.shape[0]
    if ids is not None:
        cuda.check_tensor(ids, "ids", ids.dtype, dev)
        if ids.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"ids has dtype {ids.dtype}, expected int32 "
                            f"or int64")
    elif num_groups != 1:
        raise ValueError("ids may be None only for one group")
    if mask is not None:
        cuda.check_tensor(mask, "mask", torch.bool, dev)
    if values is not None:
        cuda.check_tensor(values, "values", torch.int64, dev)
    for name, t in (("ids", ids), ("mask", mask), ("values", values)):
        if t is not None and t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {n}")
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"num_groups {num_groups} outside [1, {MAX_GROUPS}]")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: the kernel takes fewer than 2^31")
    with_sum = values is not None
    if not (with_sum or counts):
        raise ValueError("segsum_cuda computes nothing without values or "
                         "counts")
    out = torch.empty((int(with_sum) + int(counts)) * num_groups,
                      dtype=torch.int64, device=dev)
    nbytes = _scratch_bytes(cuda.device_index(dev), num_groups)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    cuda.call("segsum", "presto_segsum_i64", dev,
              None if ids is None else ids.data_ptr(),
              0 if ids is None else ids.element_size(),
              None if mask is None else mask.data_ptr(),
              None if values is None else values.data_ptr(),
              n, num_groups, int(with_sum), int(counts), out.data_ptr(),
              None if scratch is None else scratch.data_ptr())
    cuda.count(cuda.launches, KERNEL)
    return (out[:num_groups] if with_sum else None,
            out[-num_groups:] if counts else None)


def segsum(ids: Optional[torch.Tensor], values: Optional[torch.Tensor],
           mask: Optional[torch.Tensor], num_groups: int,
           counts: bool = True):
    """Per-group (sums, counts) of the contributing rows; dispatch on
    where the tensors lie: the kernel on the card, the plain version on
    the CPU."""
    if _rows(ids, values, mask).is_cuda:
        if ids is not None and ids.dtype not in (torch.int32, torch.int64):
            ids = ids.to(torch.int64)
        return segsum_cuda(
            None if ids is None else ids.contiguous(),
            None if values is None
            else values.to(torch.int64).contiguous(),
            None if mask is None else mask.contiguous(),
            num_groups, counts)
    cuda.count(cuda.plain_calls, KERNEL)
    return segsum_plain(ids, values, mask, num_groups, counts)


def segmented_sum_i64(values: torch.Tensor, ids: torch.Tensor,
                      num_groups: int) -> torch.Tensor:
    """Exact int64 per-group sum of ``values`` (any integer dtype); rows
    with id outside [0, num_groups) contribute 0."""
    return segsum(ids, values, None, num_groups, counts=False)[0]


def segmented_count(ids: torch.Tensor, num_groups: int) -> torch.Tensor:
    """int64 per-group row count (ids outside [0, num_groups) drop)."""
    return segsum(ids, None, None, num_groups)[1]


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


def _sums_and_counts(groups: A.GroupbyResult, out_capacity: int,
                     values: Optional[torch.Tensor],
                     nulls: Optional[torch.Tensor]):
    """Per-group sums of ``values`` (None: no sums) and counts of the
    contributing rows (valid and not null), from one kernel pass. Valid
    rows per group are counted once per grouping (or taken from the dense
    path, which counted them already) and shared by every state whose
    input has no nulls."""
    if nulls is None:
        known = groups.valid_counts
        if values is None and known is not None:
            return None, known
        sums, counts = segsum(groups.group_ids, values, groups.row_valid,
                              out_capacity, counts=known is None)
        if known is None:
            groups.valid_counts = counts
        return sums, groups.valid_counts
    return segsum(groups.group_ids, values, groups.row_valid & ~nulls,
                  out_capacity)


def aggregate(
    groups: A.GroupbyResult,
    kind: str,
    out_capacity: int,
    data: Optional[torch.Tensor] = None,
    nulls: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Drop-in for ops/agg.aggregate: same SQL semantics (SUM over zero
    non-null inputs is NULL, COUNT is 0), same (values[out_capacity],
    null_mask) shape, group totals from the kernel: one pass per state."""
    if not supported(kind, out_capacity, data):
        return A.aggregate(groups, kind, out_capacity, data, nulls)
    if kind in (A.COUNT_STAR, A.COUNT):
        return _sums_and_counts(groups, out_capacity, None,
                                None if kind == A.COUNT_STAR else nulls
                                )[1], None
    if kind == A.SUM:
        totals, ncontrib = _sums_and_counts(groups, out_capacity, data, nulls)
        return totals.to(data.dtype), ncontrib == 0
    trues, ncontrib = _sums_and_counts(
        groups, out_capacity, data.to(torch.bool).to(torch.int64), nulls)
    return _bool_result(kind, trues, ncontrib, ncontrib == 0)


def global_aggregate(
    kind: str,
    valid: torch.Tensor,
    data: Optional[torch.Tensor] = None,
    nulls: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ops/agg.global_aggregate: the ungrouped aggregate as
    one group (no ids), one kernel pass per state."""
    if not supported(kind, 1, data):
        return A.global_aggregate(kind, valid, data, nulls)
    false = torch.zeros((), dtype=torch.bool, device=valid.device)
    contributing = valid
    if nulls is not None and kind != A.COUNT_STAR:
        contributing = valid & ~nulls
    if kind in (A.COUNT_STAR, A.COUNT):
        return segsum(None, None, contributing, 1)[1][0], false
    values = data if kind == A.SUM else data.to(torch.bool).to(torch.int64)
    sums, counts = segsum(None, values, contributing, 1)
    empty = counts[0] == 0
    if kind == A.SUM:
        return sums[0].to(A.global_sum_dtype(data.dtype)), empty
    return _bool_result(kind, sums[0], counts[0], empty)
