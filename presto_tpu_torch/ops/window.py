"""Window functions: segmented scans over a partition-sorted permutation.

Port of presto_tpu/ops/window.py (reference: presto-main
operator/WindowOperator.java + operator/window/*):

  1. one stable sort by (validity, partition equality words, order
     words), bit-packed into few u64 words (ops/keys.pack_sort_keys);
  2. partition/peer boundaries by adjacent-word comparison;
  3. rank/row_number from boundary positions, running aggregates from
     prefix sums re-based at segment starts, min/max over prefix frames
     by a segmented doubling scan and over sliding frames by a sparse
     table, lag/lead/first/last as bounded gathers;
  4. scatter results back to input row order.

torch has no ``lax.associative_scan``. The reference's three scans
become: ``_scan_max`` of boundary positions, which only grow, is
``torch.cummax``; ``_suffix_min`` is a flip, ``cummin`` and a flip; and
``_segmented_scan`` of values is a log2(n)-step doubling scan whose
reach stops at each row's segment start (min and max are idempotent,
so the overlapping windows of the doubling steps are harmless).

Default SQL frames are honored: with ORDER BY the frame is RANGE
UNBOUNDED PRECEDING..CURRENT ROW (peer-extended running values), without
ORDER BY it is the whole partition.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.ops import consts
from presto_tpu_torch.ops import keys as K
from presto_tpu_torch.ops.sort import SortKey, packed_argsort
from presto_tpu_torch.page import Block, Page

# functions producing BIGINT positions
RANKING = ("row_number", "rank", "dense_rank", "ntile")
# distribution functions producing DOUBLE
DISTRIBUTION = ("percent_rank", "cume_dist")
# running/frame aggregates
AGGREGATES = ("sum", "count", "count_star", "avg", "min", "max")
# offset/navigation functions
NAVIGATION = ("lag", "lead", "first_value", "last_value", "nth_value")


@dataclasses.dataclass(frozen=True)
class WindowFunc:
    function: str
    arg_channel: Optional[int] = None
    offset: int = 1  # lag/lead offset, ntile bucket count, nth_value n
    default_null: bool = True  # lag/lead default is NULL
    # explicit frame (unit, (start_kind, n), (end_kind, n)) per
    # sql/tree/WindowFrame; None = SQL default (RANGE UNBOUNDED
    # PRECEDING..CURRENT ROW with ORDER BY, whole partition without)
    frame: Optional[Tuple] = None


def result_type(fn: WindowFunc, in_type: Optional[T.SqlType]) -> T.SqlType:
    from presto_tpu_torch.exec import agg_states as S

    if fn.function in RANKING or fn.function in ("count", "count_star"):
        return T.BIGINT
    if fn.function in DISTRIBUTION:
        return T.DOUBLE
    if fn.function in ("sum", "avg", "min", "max"):
        rt = S.result_type(fn.function, in_type)
        if isinstance(rt, T.DecimalType) and not rt.is_short:
            # frames are per-partition prefixes: their sums stay within
            # i64, so the short representation is kept
            return T.DecimalType(18, rt.scale)
        return rt
    return in_type  # lag/lead/first_value/last_value/nth_value


def _scan_max(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(0), 0).values.flip(0)


def _segmented_scan(op, values: torch.Tensor,
                    seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive per-segment scan of an idempotent op (min/max): after
    the step of stride s each row holds op over its last 2s rows,
    clipped at its segment start."""
    n = values.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=values.device)
    out = values
    step = 1
    while step < n:
        src = iota - step
        prev = out[src.clamp(min=0)]
        out = torch.where(src >= seg_start, op(out, prev), out)
        step <<= 1
    return out


def _changed(words, perm, n, device) -> torch.Tensor:
    ch = torch.zeros(n, dtype=torch.bool, device=device)
    ch[0] = True
    for w in words:
        sw = w[perm]
        ch[1:] |= sw[1:] != sw[:-1]
    return ch


def window_page(
    partition_channels: Tuple[int, ...],
    order_keys: Tuple[SortKey, ...],
    functions: Tuple[WindowFunc, ...],
    out_types: Tuple[T.SqlType, ...],
    page: Page,
) -> Page:
    """Compute all window functions sharing one OVER clause; returns the
    input page with one appended Block per function."""
    n = page.capacity
    dev = page.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)

    # ---- 1. sort permutation: valid, partition words, order words ----
    parts: List = [((~page.valid).to(torch.int64), 1)]
    part_cols, part_nulls = K.block_key_columns(
        [page.block(c) for c in partition_channels])
    # partition words: null flags + null-masked equality encodings
    pw: List[torch.Tensor] = []
    for col, null in zip(part_cols, part_nulls):
        if null is not None:
            col = torch.where(null, 0, col)
            parts.append((null.to(torch.int64), 1))
            pw.append(null.to(torch.int64))
        parts.append((col, 64))
        pw.append(col)
    order_words: List[torch.Tensor] = []
    for sk in order_keys:
        enc = K.order_encoding_parts(
            page.block(sk.channel), ascending=sk.ascending,
            nulls_first=sk.resolved_nulls_first())
        parts.extend(enc)
        order_words.extend(w for w, _bits in enc)
    perm = packed_argsort(K.pack_sort_keys(parts), n)
    inv = torch.empty_like(perm)
    inv[perm] = iota
    svalid = page.valid[perm]

    # ---- 2. boundaries in sorted order ----
    part_boundary = _changed(pw, perm, n, dev) | ~svalid  # invalid: own
    peer_boundary = part_boundary | (
        _changed(order_words, perm, n, dev) if order_words
        else part_boundary)
    has_order = bool(order_keys)

    seg_start = _scan_max(torch.where(part_boundary, iota, 0))
    peer_start = _scan_max(torch.where(peer_boundary, iota, 0))
    # segment/peer end: next boundary - 1 (suffix-min of boundary starts)
    last = torch.ones(1, dtype=torch.bool, device=dev)
    seg_end = _suffix_min(torch.where(
        torch.cat([part_boundary[1:], last]), iota, n - 1))
    peer_end = _suffix_min(torch.where(
        torch.cat([peer_boundary[1:], last]), iota, n - 1))
    cum_peer = torch.cumsum(peer_boundary.to(torch.int64), 0)

    out_blocks: List[Block] = []
    for fn, out_t in zip(functions, out_types):
        blk = page.block(fn.arg_channel) if fn.arg_channel is not None \
            else None
        res_data, res_nulls, dic = _one_function(
            fn, blk, perm, inv, svalid, iota, n, seg_start, seg_end,
            peer_end, peer_start, cum_peer, has_order, out_t)
        out_blocks.append(Block(data=res_data, type=out_t, nulls=res_nulls,
                                dictionary=dic))
    return Page(blocks=page.blocks + tuple(out_blocks), valid=page.valid)


def _frame_bounds(fn, iota, seg_start, seg_end, peer_start, peer_end,
                  has_order):
    """Per-row frame [fs, fe] in sorted coordinates (fe < fs = empty).

    Reference: operator/window/FramedWindowFunction + WindowFrame."""
    if fn.frame is None:
        return seg_start, (peer_end if has_order else seg_end)
    unit, (sk, sn), (ek, en) = fn.frame

    def bound(kind, nn):
        if kind == "unbounded_preceding":
            return seg_start
        if kind == "unbounded_following":
            return seg_end
        if unit == "range":
            # the planner admits only UNBOUNDED/CURRENT for RANGE frames
            return peer_start if kind == "current" else peer_end
        if kind == "current":
            return iota
        if kind == "preceding":
            return iota - int(nn)
        return iota + int(nn)  # following

    fs = bound(sk, sn)
    fe = bound(ek, en) if unit == "rows" else bound_end_range(
        ek, peer_end, seg_start, seg_end)
    fs = torch.minimum(torch.maximum(fs, seg_start), seg_end + 1)
    fe = torch.minimum(torch.maximum(fe, seg_start - 1), seg_end)
    return fs, fe


def bound_end_range(kind, peer_end, seg_start, seg_end):
    if kind == "unbounded_following":
        return seg_end
    if kind == "unbounded_preceding":
        return seg_start
    return peer_end  # current row extends to its peers


def _one_function(fn, blk, perm, inv, svalid, iota, n, seg_start, seg_end,
                  peer_end, peer_start, cum_peer, has_order, out_t):
    """Result tensors in INPUT row order for one window function."""
    if fn.function == "row_number":
        return (iota - seg_start + 1)[inv], None, None
    if fn.function == "rank":
        return (peer_start - seg_start + 1)[inv], None, None
    if fn.function == "dense_rank":
        res = cum_peer - cum_peer[seg_start.clamp(0, n - 1)] + 1
        return res[inv], None, None
    if fn.function == "ntile":
        # SQL ntile(b): the first (size % b) buckets get ceil(size/b) rows
        size = seg_end - seg_start + 1
        k = iota - seg_start  # 0-based row number
        b = max(fn.offset, 1)
        q = size // b
        r = size % b
        big = r * (q + 1)
        res = torch.where(k < big, k // (q + 1).clamp(min=1),
                          r + (k - big) // q.clamp(min=1)) + 1
        return res[inv], None, None
    if fn.function == "percent_rank":
        size = seg_end - seg_start + 1
        rank = peer_start - seg_start
        res = torch.where(
            size > 1,
            rank.to(torch.float64) / (size - 1).clamp(min=1).to(
                torch.float64),
            0.0)
        return res[inv], None, None
    if fn.function == "cume_dist":
        size = seg_end - seg_start + 1
        res = ((peer_end - seg_start + 1).to(torch.float64)
               / size.to(torch.float64))
        return res[inv], None, None

    fs, fe = _frame_bounds(fn, iota, seg_start, seg_end, peer_start,
                           peer_end, has_order)

    if fn.function in NAVIGATION:
        if fn.function == "lag":
            src = iota - fn.offset
            ok = src >= seg_start
        elif fn.function == "lead":
            src = iota + fn.offset
            ok = src <= seg_end
        elif fn.function == "first_value":
            src = fs
            ok = fe >= fs
        elif fn.function == "nth_value":
            src = fs + fn.offset - 1
            ok = (src <= fe) & (fe >= fs)
        else:  # last_value = frame end
            src = fe
            ok = fe >= fs
        # one composed gather: input row of sorted position src, then
        # back to input order
        rows = perm[src.clamp(0, n - 1)][inv]
        data = blk.data
        out = (tuple(d[rows] for d in data) if isinstance(data, tuple)
               else data[rows])
        nulls = ~ok[inv]
        if blk.nulls is not None:
            nulls = nulls | blk.nulls[rows]
        return out, nulls, blk.dictionary

    # ---- frame aggregates: per-row [fs, fe] in sorted coordinates ----
    contributing = svalid
    if blk is not None and blk.nulls is not None:
        contributing = contributing & ~blk.nulls[perm]

    def ranged(cum):
        """cum[fe] - cum[fs-1] over per-row frames, 0 when empty."""
        base = torch.where(fs > 0, cum[(fs - 1).clamp(0, n - 1)],
                           torch.zeros((), dtype=cum.dtype,
                                       device=cum.device))
        out = cum[fe.clamp(0, n - 1)] - base
        return torch.where(fe >= fs, out, torch.zeros(
            (), dtype=cum.dtype, device=cum.device))

    frame_count = ranged(torch.cumsum(contributing.to(torch.int64), 0))

    if fn.function in ("count", "count_star"):
        if fn.arg_channel is None:
            res = ranged(torch.cumsum(svalid.to(torch.int64), 0))
        else:
            res = frame_count
        return res[inv], None, None

    data = blk.data
    if isinstance(data, tuple):
        raise NotImplementedError(
            "window aggregates over long decimals are not supported")
    dic = blk.dictionary
    inv_rank = None
    if dic is not None and fn.function in ("min", "max") and len(dic):
        rank_np = dic.sort_rank().astype(np.int64)
        rank = consts.lut(rank_np, data.device)
        inv_rank = consts.lut(np.argsort(rank_np).astype(np.int64),
                              data.device)
        data = rank[data.clamp(0, len(dic) - 1).to(torch.int64)]

    sdata = data[perm]
    empty = frame_count == 0
    floating = sdata.is_floating_point()

    if fn.function in ("sum", "avg"):
        acc = torch.where(contributing, sdata, 0).to(
            torch.float64 if floating else torch.int64)
        total = ranged(torch.cumsum(acc, 0))
        if fn.function == "sum":
            return total.to(out_t.device_dtype)[inv], empty[inv], None
        cnt = frame_count.clamp(min=1)
        if T.is_floating(out_t):
            res = total.to(torch.float64) / cnt.to(torch.float64)
        else:
            # integer/decimal: round half up, as the aggregation path
            tot = total.to(torch.int64)
            sign = torch.where(tot < 0, -1, 1)
            res = sign * ((tot.abs() + cnt // 2) // cnt)
        return res.to(out_t.device_dtype)[inv], empty[inv], None

    if fn.function in ("min", "max"):
        op = torch.minimum if fn.function == "min" else torch.maximum
        if floating:
            ident = float("inf") if fn.function == "min" else float("-inf")
        else:
            info = torch.iinfo(sdata.dtype)
            ident = info.max if fn.function == "min" else info.min
        filled = torch.where(contributing, sdata, torch.full(
            (), ident, dtype=sdata.dtype, device=sdata.device))
        if fn.frame is None or fn.frame[1][0] == "unbounded_preceding":
            # prefix frames: the running value at the frame end
            run = _segmented_scan(op, filled, seg_start)
            res = run[fe.clamp(0, n - 1)]
        else:
            # sliding frames: sparse-table range query (O(n log n)
            # build, O(1) per row)
            res = _range_query(op, filled, fs, fe, ident)
        if inv_rank is not None:
            res = inv_rank[res.clamp(0, inv_rank.shape[0] - 1)].to(
                data.dtype)
        res = torch.where(empty, torch.zeros((), dtype=res.dtype,
                                             device=res.device), res)
        return res[inv], empty[inv], dic
    raise ValueError(f"unknown window function {fn.function!r}")


def _range_query(op, filled, fs, fe, ident):
    """Sparse-table RMQ: per-row op-reduction over [fs, fe] (callers
    handle empty frames). Level k holds op over filled[i : i+2^k);
    query = op(L[k][fs], L[k][fe-2^k+1]) with k = floor(log2(len))."""
    n = filled.shape[0]
    levels = [filled]
    k = 0
    while (1 << (k + 1)) <= n:
        cur = levels[-1]
        step = 1 << k
        shifted = torch.cat([cur[step:], torch.full(
            (step,), ident, dtype=cur.dtype, device=cur.device)])
        levels.append(op(cur, shifted))
        k += 1
    table = torch.stack(levels).reshape(-1)  # (K * n)
    length = (fe - fs + 1).clamp(min=1)
    # floor(log2(length)), branch-free
    kk = torch.zeros_like(length)
    for b in range(1, len(levels)):
        kk = torch.where(length >= (1 << b), b, kk)
    a = table[kk * n + fs.clamp(0, n - 1)]
    b_idx = (fe - (torch.ones_like(kk) << kk) + 1).clamp(0, n - 1)
    return op(a, table[kk * n + b_idx])
