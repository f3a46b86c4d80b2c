"""Function registry: scalar builtins resolved by name.

Port of presto_tpu/expr/functions.py for the functions the slice's
queries (TPC-H Q1, Q3, Q5, Q6) call: arithmetic (including decimal and
date/interval arithmetic), comparisons (including string equality over
dictionary codes), NOT, NEGATE and CAST. Each entry is (type resolution,
tensor implementation); the evaluator applies generic null propagation
unless the function opts out. Value-dependent errors (division by zero)
follow the reference's masked-eval policy: the offending positions
produce NULL.

The rest of the reference registry (string, regexp, math, temporal part
functions, complex types, functions_ext/functions_more) waits for the
next slices; an unported name raises a KeyError that says so.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.ops import consts
from presto_tpu_torch.expr.values import (
    Val,
    add_months_to_days,
    broadcast_val,
    cast_data,
    div_round_half_up,
    rescale_decimal,
    union_nulls,
)

_US_PER_DAY = 86_400_000_000


@dataclasses.dataclass
class Ctx:
    device: torch.device
    capacity: int


@dataclasses.dataclass
class FunctionDef:
    name: str
    resolve: Callable[[List[T.SqlType]], T.SqlType]
    impl: Callable  # impl(ctx, result_type, vals) -> Val
    propagate_nulls: bool = True


_REGISTRY: dict = {}


def register(name: str, resolve, impl, propagate_nulls: bool = True):
    _REGISTRY[name] = FunctionDef(name, resolve, impl, propagate_nulls)


def lookup(name: str) -> FunctionDef:
    fn = _REGISTRY.get(name)
    if fn is None:
        raise KeyError(
            f"unknown function: {name} (not ported to presto_tpu_torch "
            "yet; ROADMAP queue 1, slice B)"
        )
    return fn


def resolve_type(name: str, arg_types: Sequence[T.SqlType]) -> T.SqlType:
    return lookup(name).resolve(list(arg_types))


def eval_call(ctx: Ctx, name: str, result_type: T.SqlType, vals: List[Val]):
    fn = lookup(name)
    vals = [broadcast_val(v, ctx.capacity) for v in vals]
    out = fn.impl(ctx, result_type, vals)
    if fn.propagate_nulls:
        extra = union_nulls(*(v.nulls for v in vals))
        out = Val(out.data, union_nulls(out.nulls, extra), out.type,
                  out.dictionary, py_value=out.py_value)
    return out


# ------------------------------------------------------------ type helpers

_INT_RANK = {T.TinyintType: 0, T.SmallintType: 1, T.IntegerType: 2,
             T.BigintType: 3}


def _short_decimal(p: int, s: int) -> T.DecimalType:
    """Computed decimals are physically scaled i64, precision capped at
    18 (presto_tpu's design: arithmetic never widens to limbs; only
    aggregate sums produce long-decimal limb blocks)."""
    if s > 18:
        raise TypeError(f"decimal scale {s} beyond i64 arithmetic range")
    return T.DecimalType(max(min(p, 18), s, 1), s)


def _numeric_result(a: T.SqlType, b: T.SqlType, op: str) -> T.SqlType:
    if isinstance(a, T.DoubleType) or isinstance(b, T.DoubleType):
        return T.DOUBLE
    if isinstance(a, T.RealType) or isinstance(b, T.RealType):
        return T.REAL
    if isinstance(a, T.DecimalType) or isinstance(b, T.DecimalType):
        da, db = T._to_decimal(a), T._to_decimal(b)
        # Reference: spi/type/DecimalType + DecimalOperators result rules,
        # with precision capped to the i64 physical representation
        if op in ("add", "subtract"):
            s = max(da.scale, db.scale)
            p = max(da.precision - da.scale, db.precision - db.scale) + s + 1
            return _short_decimal(p, s)
        if op == "multiply":
            return _short_decimal(da.precision + db.precision,
                                  da.scale + db.scale)
        if op == "divide":
            s = max(da.scale, db.scale)
            p = da.precision + db.scale + max(0, db.scale - da.scale)
            return _short_decimal(max(p, s + 1), s)
        if op == "modulus":
            s = max(da.scale, db.scale)
            p = min(da.precision - da.scale, db.precision - db.scale) + s
            return _short_decimal(max(p, s + 1), s)
    if type(a) in _INT_RANK and type(b) in _INT_RANK:
        return a if _INT_RANK[type(a)] >= _INT_RANK[type(b)] else b
    raise TypeError(f"no numeric result for {a} {op} {b}")


_INTERVALS = (T.IntervalDayTimeType, T.IntervalYearMonthType)
_TEMPORAL = (T.DateType, T.TimestampType)


def _arith_resolve(op: str):
    def resolve(args: List[T.SqlType]) -> T.SqlType:
        a, b = args
        if isinstance(a, _TEMPORAL) and isinstance(b, _INTERVALS):
            if op in ("add", "subtract"):
                return a
        if isinstance(b, _TEMPORAL) and isinstance(a, _INTERVALS):
            if op == "add":
                return b
        if isinstance(a, T.DateType) and isinstance(b, T.DateType):
            if op == "subtract":  # date - date -> days (bigint)
                return T.BIGINT
        if isinstance(a, T.IntervalDayTimeType) and isinstance(
            b, T.IntervalDayTimeType
        ):
            return a
        if isinstance(a, T.IntervalYearMonthType) and isinstance(
            b, T.IntervalYearMonthType
        ):
            return a
        return _numeric_result(a, b, op)

    return resolve


def _to_common(val: Val, target: T.SqlType, cap: int) -> Val:
    data, nulls = cast_data(val, target, cap)
    return Val(data, nulls, target, val.dictionary, val.py_value)


def _decimal_scale(t: T.SqlType) -> int:
    return t.scale if isinstance(t, T.DecimalType) else 0


def _sql_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SQL mod keeps the dividend's sign (fmod), unlike floor-mod."""
    q = a.abs() % b.abs()
    return torch.where(a >= 0, q, -q)


def _temporal_arith(op: str, rt: T.SqlType, a: Val, b: Val) -> Val:
    """date/timestamp +- interval (a is the temporal operand)."""
    amt = b.data.to(torch.int64)
    if op == "subtract":
        amt = -amt
    if isinstance(b.type, T.IntervalYearMonthType):
        if isinstance(a.type, T.DateType):
            out = add_months_to_days(a.data, amt)
        else:
            days = (a.data // _US_PER_DAY).to(torch.int32)
            rem = a.data % _US_PER_DAY
            nd = add_months_to_days(days, amt)
            out = nd.to(torch.int64) * _US_PER_DAY + rem
    elif isinstance(a.type, T.DateType):
        out = (a.data.to(torch.int64) + amt // _US_PER_DAY).to(torch.int32)
    else:
        out = a.data + amt
    return Val(out, None, rt)


def _impl_arith(op: str):
    def impl(ctx: Ctx, rt: T.SqlType, vals: List[Val]) -> Val:
        cap = ctx.capacity
        a, b = vals
        ta, tb = a.type, b.type

        # ---- temporal arithmetic
        if isinstance(ta, _INTERVALS) and isinstance(rt, _TEMPORAL):
            a, b = b, a  # normalize: temporal op interval
            ta, tb = a.type, b.type
        if isinstance(ta, _TEMPORAL) and isinstance(tb, _INTERVALS):
            return _temporal_arith(op, rt, a, b)
        if isinstance(ta, T.DateType) and isinstance(tb, T.DateType) \
                and op == "subtract":
            return Val(a.data.to(torch.int64) - b.data.to(torch.int64),
                       None, rt)
        if isinstance(ta, _INTERVALS):
            x = a.data.to(torch.int64)
            y = b.data.to(torch.int64)
            out = x + y if op == "add" else x - y
            return Val(out.to(rt.device_dtype), None, rt)

        # ---- numeric
        if isinstance(rt, T.DecimalType):
            sa, sb = _decimal_scale(ta), _decimal_scale(tb)
            xa = _to_common(a, T.DecimalType(38, sa), cap).data
            xb = _to_common(b, T.DecimalType(38, sb), cap).data
            if op in ("add", "subtract"):
                xa = rescale_decimal(xa, sa, rt.scale)
                xb = rescale_decimal(xb, sb, rt.scale)
                return Val(xa + xb if op == "add" else xa - xb, None, rt)
            if op == "multiply":
                return Val(rescale_decimal(xa * xb, sa + sb, rt.scale),
                           None, rt)
            zero = xb == 0
            if op == "divide":
                safe = torch.where(zero, 1, xb)
                # scale the numerator so the quotient lands on rt.scale
                k = rt.scale - sa + sb
                num = xa * (10 ** k) if k >= 0 else rescale_decimal(
                    xa, -k, 0)
                q = div_round_half_up(num, safe)
                return Val(torch.where(zero, 0, q), zero, rt)
            if op == "modulus":
                ra = rescale_decimal(xa, sa, rt.scale)
                rb = rescale_decimal(xb, sb, rt.scale)
                out = _sql_mod(ra, torch.where(zero, 1, rb))
                return Val(torch.where(zero, 0, out), zero, rt)
        xa = _to_common(a, rt, cap).data
        xb = _to_common(b, rt, cap).data
        if op == "add":
            return Val(xa + xb, None, rt)
        if op == "subtract":
            return Val(xa - xb, None, rt)
        if op == "multiply":
            return Val(xa * xb, None, rt)
        zero = xb == 0
        safe = torch.where(zero, torch.ones_like(xb), xb)
        if op == "divide":
            if T.is_floating(rt):
                q = xa / safe
            else:
                # SQL integer division truncates toward zero
                q = xa.abs() // safe.abs()
                q = torch.where((xa >= 0) == (safe >= 0), q, -q)
            return Val(torch.where(zero, torch.zeros_like(xa), q), zero, rt)
        if op == "modulus":
            out = _sql_mod(xa, safe)
            return Val(torch.where(zero, torch.zeros_like(xa), out), zero,
                       rt)
        raise ValueError(op)

    return impl


for _op in ("add", "subtract", "multiply", "divide", "modulus"):
    register(_op, _arith_resolve(_op), _impl_arith(_op))


register("negate", lambda a: a[0],
         lambda ctx, rt, vals: Val(-vals[0].data, None, rt))


# ------------------------------------------------------------- comparisons

def _cmp_resolve(args: List[T.SqlType]) -> T.SqlType:
    a, b = args
    if T.common_super_type(a, b) is None:
        raise TypeError(f"cannot compare {a} and {b}")
    return T.BOOLEAN


def _string_codes_for_compare(ctx: Ctx, a: Val, b: Val):
    """Map two string Vals onto integer tensors whose = and < agree with
    SQL string semantics: both remap through one merged distinct SORTED
    value universe built on the host (a lut gather on the device)."""

    def col_values(v: Val):
        if v.is_const:
            return {v.py_value}
        if v.dictionary is None:
            raise TypeError("string comparison requires dictionary coding")
        return set(v.dictionary.values)

    universe = sorted(col_values(a) | col_values(b))
    pos = {v: i for i, v in enumerate(universe)}

    def canon(v: Val):
        if v.is_const:
            return torch.full((ctx.capacity,), pos[v.py_value],
                              dtype=torch.int64, device=ctx.device)
        lut = np.array([pos[x] for x in v.dictionary.values] or [0],
                       np.int64)
        codes = v.data.clamp(0, max(len(v.dictionary) - 1, 0))
        return consts.lut(lut, ctx.device)[codes.to(torch.int64)]

    return canon(a), canon(b)


_CMP = {
    "eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
    "le": torch.le, "gt": torch.gt, "ge": torch.ge,
}


def _impl_cmp(op: str):
    def impl(ctx: Ctx, rt: T.SqlType, vals: List[Val]) -> Val:
        a, b = vals
        if T.is_string(a.type) or T.is_string(b.type):
            xa, xb = _string_codes_for_compare(ctx, a, b)
        else:
            ct = T.common_super_type(a.type, b.type)
            if isinstance(ct, T.DecimalType):
                # compare at a common scale without precision loss
                s = max(_decimal_scale(a.type), _decimal_scale(b.type))
                ct = T.DecimalType(38, s)
            xa = _to_common(a, ct, ctx.capacity).data
            xb = _to_common(b, ct, ctx.capacity).data
        return Val(_CMP[op](xa, xb), None, T.BOOLEAN)

    return impl


for _op in _CMP:
    register(_op, _cmp_resolve, _impl_cmp(_op))


register("not", lambda a: T.BOOLEAN,
         lambda ctx, rt, vals: Val(~vals[0].data.to(torch.bool), None,
                                   T.BOOLEAN))


# ------------------------------------------------------------------- casts

def _impl_cast(ctx: Ctx, rt: T.SqlType, vals: List[Val]) -> Val:
    v = vals[0]
    data, nulls = cast_data(v, rt, ctx.capacity)
    if T.is_string(rt) and T.is_string(v.type):
        # varchar(n) <-> varchar keeps the dictionary codes
        return Val(data, nulls, rt, v.dictionary, py_value=v.py_value)
    return Val(data, nulls, rt)


register("cast", lambda a: a[0], _impl_cast)
