"""Aggregate state layouts: decompose SQL aggregates into the primitive
segmented reductions of presto_tpu_torch.ops.agg, with exact wide-decimal
sums.

Port of presto_tpu/exec/agg_states.py: count, count(*), sum, avg, min,
max, any, bool_or/bool_and, the variance family, approx_distinct's HLL
words and the collect states of array_agg, map_agg and
approx_percentile, and the registry of plugin aggregates
(AggregateFunctionSpec, plugin.py's aggregate_functions). 128-bit decimal
sums split each unscaled i64 into (v >> 32, v & 0xFFFFFFFF) and sum the
halves separately; hi*2^32 + lo reconstructs the exact total as a
long-decimal limb Block.

Reference: presto-main operator/aggregation/* (DecimalSumAggregation +
UnscaledDecimal128Arithmetic for the 128-bit state).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.ops import agg as A
from presto_tpu_torch.ops import u64
from presto_tpu_torch.page import Block


@dataclasses.dataclass(frozen=True)
class StateCol:
    """One physical state column: which primitive reduction builds it
    from raw input, and which merges two partial states of it."""

    suffix: str
    input_kind: str  # ops.agg kind applied to raw input
    merge_kind: str  # ops.agg kind applied when combining partials
    type: T.SqlType
    # transform applied to the raw input column before reduction:
    # None | 'hi32' | 'lo32' | 'sq', or a plugin aggregate's named
    # module-level callable over the input tensor
    pre: object = None


# collect-state aggregate markers (handled by the executor's collect
# branches against ops/collect.py, never by ops/agg.aggregate)
COLLECT = "collect"
COLLECT_FNS = frozenset({"array_agg", "map_agg", "approx_percentile"})

VARIANCE_FNS = frozenset(
    {"var_samp", "var_pop", "stddev_samp", "stddev_pop"}
)


def state_layout(function: str,
                 in_type: Optional[T.SqlType]) -> List[StateCol]:
    """State columns for an aggregate over an input type."""
    if function == "count_star":
        return [StateCol("count", A.COUNT_STAR, A.SUM, T.BIGINT)]
    if function == "count":
        return [StateCol("count", A.COUNT, A.SUM, T.BIGINT)]
    if function in ("min", "max"):
        kind = A.MIN if function == "min" else A.MAX
        return [StateCol("value", kind, kind, in_type)]
    if function == "any":
        return [StateCol("value", A.ANY, A.ANY, in_type)]
    if function == "bool_or":
        return [StateCol("value", A.BOOL_OR, A.BOOL_OR, T.BOOLEAN)]
    if function == "bool_and":
        return [StateCol("value", A.BOOL_AND, A.BOOL_AND, T.BOOLEAN)]
    if function == "sum":
        if isinstance(in_type, T.DecimalType):
            return [
                StateCol("hi", A.SUM, A.SUM, T.BIGINT, pre="hi32"),
                StateCol("lo", A.SUM, A.SUM, T.BIGINT, pre="lo32"),
            ]
        if T.is_floating(in_type):
            return [StateCol("sum", A.SUM, A.SUM, T.DOUBLE)]
        return [StateCol("sum", A.SUM, A.SUM, T.BIGINT)]
    if function == "avg":
        return state_layout("sum", in_type) + state_layout("count", in_type)
    if function in VARIANCE_FNS:
        # (count, sum, sum-of-squares) double state; m2 recovered at
        # finalize (the planner casts the input to DOUBLE first)
        return [
            StateCol("count", A.COUNT, A.SUM, T.BIGINT),
            StateCol("sum", A.SUM, A.SUM, T.DOUBLE),
            StateCol("sumsq", A.SUM, A.SUM, T.DOUBLE, pre="sq"),
        ]
    if function == "approx_distinct":
        # one tuple-data state column of packed HLL register words
        # (ops/hll.py; the executor special-cases insert/merge/estimate)
        return [StateCol("hll", A.HLL_INSERT, A.HLL_MERGE, T.HLL_STATE)]
    elem = in_type if in_type is not None else T.UNKNOWN
    if function == "approx_percentile":
        # [cap, K] collected-value matrix + used-slot count (exact
        # within the array_agg_max_elements bound)
        return [
            StateCol("vals", COLLECT, COLLECT, T.CollectStateType(elem)),
            StateCol("count", A.COUNT, A.SUM, T.BIGINT),
        ]
    if function == "array_agg":
        # value matrix + element-null-flag matrix + used-slot count
        return [
            StateCol("vals", COLLECT, COLLECT, T.CollectStateType(elem)),
            StateCol("vnulls", COLLECT, COLLECT,
                     T.CollectStateType(T.UNKNOWN)),
            StateCol("count", A.COUNT, A.SUM, T.BIGINT),
        ]
    if function == "map_agg":
        # collected keys + values + value-null flags + count
        return [
            StateCol("kvals", COLLECT, COLLECT, T.CollectStateType(elem)),
            StateCol("vvals", COLLECT, COLLECT,
                     T.CollectStateType(T.UNKNOWN)),
            StateCol("vnulls", COLLECT, COLLECT,
                     T.CollectStateType(T.UNKNOWN)),
            StateCol("count", A.COUNT, A.SUM, T.BIGINT),
        ]
    if function in _PLUGIN_AGGS:
        return list(_PLUGIN_AGGS[function].state)
    raise ValueError(f"unknown aggregate function: {function}")


@dataclasses.dataclass(frozen=True)
class AggregateFunctionSpec:
    """Plugin aggregate (reference: @AggregationFunction state/input/
    combine/output; spi/Plugin.getFunctions). ``state`` columns are
    built from the primitive segmented-reduction kinds of ops/agg
    (input_kind on raw input, merge_kind on partial states — so
    partial/final splits, spill partitions and mesh repartition work
    unchanged), and ``finalize(torch, states)`` combines the merged
    (data, nulls) state pairs into ``(data, nulls or None)``.

    ``StateCol.pre`` may be a module-level callable over the raw input
    tensor; a lambda would give every plan a new program-cache key, so
    use named functions."""

    name: str
    state: Tuple[StateCol, ...]
    result: object  # SqlType, or callable(in_type) -> SqlType
    finalize: object  # fn(torch, states) -> (data, nulls or None)


_PLUGIN_AGGS: dict = {}


def register_aggregate(spec: AggregateFunctionSpec) -> None:
    _PLUGIN_AGGS[spec.name] = spec


def is_plugin_aggregate(name: str) -> bool:
    return name in _PLUGIN_AGGS


def result_type(
    function: str,
    in_type: Optional[T.SqlType],
    extra: tuple = (),
) -> T.SqlType:
    """Reference: FunctionRegistry aggregate signatures — sum(bigint) ->
    bigint, sum(decimal(p,s)) -> decimal(38,s), avg(decimal(p,s)) ->
    decimal(p,s), count -> bigint. ``extra`` carries additional input
    types (map_agg's value column)."""
    if function in ("count", "count_star", "approx_distinct"):
        return T.BIGINT
    if function == "array_agg":
        return T.ArrayType(in_type if in_type is not None else T.UNKNOWN)
    if function == "map_agg":
        return T.MapType(in_type if in_type is not None else T.UNKNOWN,
                         extra[0] if extra else T.UNKNOWN)
    if function == "approx_percentile":
        return in_type
    if function in ("min", "max", "any"):
        return in_type
    if function in ("bool_or", "bool_and"):
        return T.BOOLEAN
    if function == "sum":
        if isinstance(in_type, T.DecimalType):
            return T.DecimalType(38, in_type.scale)
        if T.is_floating(in_type):
            return T.DOUBLE
        return T.BIGINT
    if function == "avg":
        if isinstance(in_type, T.DecimalType):
            return in_type
        return T.DOUBLE
    if function in VARIANCE_FNS:
        return T.DOUBLE
    if function in _PLUGIN_AGGS:
        r = _PLUGIN_AGGS[function].result
        return r(in_type) if callable(r) else r
    raise ValueError(f"unknown aggregate function: {function}")


def pre_transform(pre, data: torch.Tensor) -> torch.Tensor:
    if pre is None:
        return data
    if callable(pre):  # a plugin aggregate's named transform
        return pre(data)
    if pre == "hi32":
        return data.to(torch.int64) >> 32  # arithmetic: floor(v / 2^32)
    if pre == "lo32":
        return data.to(torch.int64) & u64.MASK32
    if pre == "sq":
        d = data.to(torch.float64)
        return d * d
    raise ValueError(pre)


def split32_to_limbs(hi: torch.Tensor, lo: torch.Tensor):
    """(sum of v>>32, sum of v&0xFFFFFFFF) -> base-2^64 two's-complement
    limbs of the exact 128-bit value hi*2^32 + lo."""
    u_shift = hi << 32
    lo64 = u_shift + lo
    # unsigned carry out of the low limb: lo64 < u_shift as u64
    carry = (u64.order(lo64) < u64.order(u_shift)).to(torch.int64)
    hi64 = (hi >> 32) + carry
    return hi64, lo64


def finalize(
    function: str,
    in_type: Optional[T.SqlType],
    out_type: T.SqlType,
    states: List[Tuple[torch.Tensor, Optional[torch.Tensor]]],
) -> Block:
    """Combine merged state columns into the SQL result Block."""
    if function in ("count", "count_star"):
        data, _ = states[0]
        return Block(data=data, type=T.BIGINT, nulls=None)
    if function in ("min", "max", "any", "bool_or", "bool_and"):
        data, nulls = states[0]
        return Block(data=data, type=out_type, nulls=nulls)
    if function == "sum":
        if isinstance(in_type, T.DecimalType):
            (hi, hn), (lo, _) = states
            hi64, lo64 = split32_to_limbs(hi, lo)
            return Block(data=(hi64, lo64), type=out_type, nulls=hn)
        data, nulls = states[0]
        return Block(data=data, type=out_type, nulls=nulls)
    if function == "avg":
        if isinstance(in_type, T.DecimalType):
            (hi, hn), (lo, _), (count, _) = states
            cnt = count.clamp(min=1)
            # exact two-step 128/64 divide with round-half-up (the
            # reference's derivation: fold lo's high half into the
            # 2^32-weighted dividend first)
            hi2 = hi + (lo >> 32)
            lo_low = lo & u64.MASK32
            qh = torch.div(hi2, cnt, rounding_mode="floor")
            rh = hi2 - qh * cnt
            rest = (rh << 32) + lo_low
            q2 = torch.div(rest + cnt // 2, cnt, rounding_mode="floor")
            return Block(data=(qh << 32) + q2, type=out_type, nulls=hn)
        (s, sn), (count, _) = states
        cnt = count.clamp(min=1).to(torch.float64)
        return Block(data=s.to(torch.float64) / cnt, type=T.DOUBLE,
                     nulls=sn)
    if function in VARIANCE_FNS:
        (count, _), (s, _), (sq, _) = states
        n = count.to(torch.float64)
        safe_n = n.clamp(min=1.0)
        s = s.to(torch.float64)
        # m2 = sumsq - sum^2/n, clamped so rounding never goes negative
        m2 = (sq.to(torch.float64) - s * s / safe_n).clamp(min=0.0)
        if function.endswith("_pop"):
            var = m2 / safe_n
            nulls = count == 0
        else:
            var = m2 / (n - 1.0).clamp(min=1.0)
            nulls = count < 2
        if function.startswith("stddev"):
            var = torch.sqrt(var)
        return Block(data=var, type=T.DOUBLE, nulls=nulls)
    if function in _PLUGIN_AGGS:
        data, nulls = _PLUGIN_AGGS[function].finalize(torch, states)
        return Block(data=data, type=out_type, nulls=nulls)
    raise ValueError(f"unknown aggregate function: {function}")
