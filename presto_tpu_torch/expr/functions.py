"""Function registry: scalar builtins resolved by name.

Port of presto_tpu/expr/functions.py's scalar registry: arithmetic
(including decimal and date/interval arithmetic), comparisons (including
string comparisons over dictionary codes), NOT, NEGATE, CAST, abs, the
date parts, the dictionary string and regexp functions, the math
functions and the temporal functions. Each entry is (type resolution,
tensor implementation); the evaluator applies generic null propagation
unless the function opts out. Value-dependent errors (division by zero)
follow the reference's masked-eval policy: the offending positions
produce NULL.

String functions work on dictionary codes: the value-level work runs
once per distinct dictionary entry on the host, then one gather applies
it to every row. The host result is cached per (dictionary, function,
constants), so a pattern runs over a dictionary once per process, and
its table reaches the device through ``ops/consts.lut`` (a CUDA graph
capture may not copy from host memory).

The complex-type functions (cardinality, element_at, contains,
array_min/array_max, map_keys/map_values, map, row) work the same way:
ARRAY/MAP/ROW values are dictionary-coded host tuples.

The extended families (JSON, TRY/TRY_CAST, bitwise, URL, array/map
utilities, lambdas, varbinary codecs and hashes, regexp and string
distances) live in functions_ext.py and functions_more.py, imported at
the end of this module: they register themselves on import, so the
registry holds the reference's names.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.obs.sanitizer import make_lock
from presto_tpu_torch.ops import consts
from presto_tpu_torch.page import Dictionary
from presto_tpu_torch.expr.values import (
    Val,
    add_months_to_days,
    broadcast_val,
    cast_data,
    civil_from_days,
    days_from_civil,
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


def registered_names() -> list:
    """All installed scalar functions (reference: FunctionRegistry.list())."""
    return list(_REGISTRY)


def lookup(name: str) -> FunctionDef:
    fn = _REGISTRY.get(name)
    if fn is None:
        raise KeyError(f"unknown function: {name}")
    return fn


def resolve_type(name: str, arg_types: Sequence[T.SqlType]) -> T.SqlType:
    return lookup(name).resolve(list(arg_types))


def eval_call(ctx: Ctx, name: str, result_type: T.SqlType, vals: List[Val]):
    fn = lookup(name)
    # non-Val arguments are ir.Lambda nodes, passed as they are
    vals = [broadcast_val(v, ctx.capacity) if isinstance(v, Val) else v
            for v in vals]
    out = fn.impl(ctx, result_type, vals)
    if fn.propagate_nulls:
        extra = union_nulls(*(v.nulls for v in vals if isinstance(v, Val)))
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
register("abs", lambda a: a[0],
         lambda ctx, rt, vals: Val(vals[0].data.abs(), None, rt))


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


# ----------------------------------------------------------------- temporal

def _as_days(v: Val) -> torch.Tensor:
    """Days since 1970 of a DATE or TIMESTAMP value (floor division, so
    instants before 1970 land on their own day)."""
    if isinstance(v.type, T.TimestampType):
        return (v.data // _US_PER_DAY).to(torch.int64)
    return v.data.to(torch.int64)


def _impl_date_part(part: str):
    def impl(ctx: Ctx, rt: T.SqlType, vals: List[Val]) -> Val:
        days = _as_days(vals[0])
        y, m, d = civil_from_days(days)
        if part == "year":
            out = y
        elif part == "month":
            out = m
        elif part == "day":
            out = d
        elif part == "quarter":
            out = (m - 1) // 3 + 1
        elif part == "week":
            # ISO week: the week of the Thursday of the same ISO week
            thursday = days + (3 - (days + 3) % 7)
            ty, _, _ = civil_from_days(thursday)
            jan1 = days_from_civil(ty, torch.ones_like(ty), torch.ones_like(ty))
            out = (thursday - jan1) // 7 + 1
        elif part == "day_of_week":
            out = (days + 3) % 7 + 1
        elif part == "day_of_year":
            out = days - days_from_civil(y, torch.ones_like(y), torch.ones_like(y)) + 1
        else:
            raise ValueError(part)
        return Val(out.to(torch.int64), None, T.BIGINT)

    return impl


def _temporal_resolve(args):
    if not isinstance(args[0], _TEMPORAL):
        raise TypeError(f"temporal function over {args[0]}")
    return T.BIGINT


for _part in ("year", "month", "day", "quarter", "week", "day_of_week",
              "day_of_year"):
    register(_part, _temporal_resolve, _impl_date_part(_part))


# --------------------------------------------------------- string functions
# Host work per distinct dictionary value, cached per (dictionary,
# function, constants): the dictionary object itself is held by the
# entry, so its id stays unique while the entry lives.

_DICT_CACHE: dict = {}
_DICT_CACHE_MAX = 4096
_dict_lock = make_lock("expr.functions._dict_lock")


def _dict_cached(d: Dictionary, key: tuple, build):
    k = (id(d), key)
    hit = _DICT_CACHE.get(k)
    if hit is not None and hit[0] is d:
        return hit[1]
    out = build()
    with _dict_lock:
        if len(_DICT_CACHE) >= _DICT_CACHE_MAX:
            _DICT_CACHE.clear()
        _DICT_CACHE[k] = (d, out)
    return out


def _dict_of(val: Val) -> Dictionary:
    if val.dictionary is None:
        raise TypeError("string function requires a dictionary-coded value")
    return val.dictionary


def _dict_gather(ctx: Ctx, val: Val, table: np.ndarray) -> torch.Tensor:
    n = len(val.dictionary)
    codes = val.data.clamp(0, max(n - 1, 0)).to(torch.int64)
    return consts.lut(table, ctx.device)[codes]


def _dict_map(ctx: Ctx, val: Val, key: tuple, fn, rt: T.SqlType) -> Val:
    """Apply a per-value host transform over the dictionary once; codes
    are unchanged. The new dictionary may hold duplicate values —
    harmless for projection; comparisons and joins re-canonicalize."""
    d = _dict_of(val)
    new = _dict_cached(d, ("map",) + key,
                       lambda: Dictionary([fn(v) for v in d.values]))
    return Val(val.data, val.nulls, rt, new)


def _dict_predicate(ctx: Ctx, val: Val, key: tuple, pred) -> Val:
    d = _dict_of(val)
    table = _dict_cached(d, ("pred",) + key, lambda: np.array(
        [bool(pred(v)) for v in d.values] or [False], bool))
    return Val(_dict_gather(ctx, val, table), None, T.BOOLEAN)


def _dict_int(ctx: Ctx, val: Val, key: tuple, fn) -> Val:
    d = _dict_of(val)
    table = _dict_cached(d, ("int",) + key, lambda: np.array(
        [int(fn(v)) for v in d.values] or [0], np.int64))
    return Val(_dict_gather(ctx, val, table), None, T.BIGINT)


def _dict_map_nullable(ctx: Ctx, val: Val, key: tuple, fn,
                       rt: T.SqlType) -> Val:
    """_dict_map where fn may return None (SQL NULL): the per-value null
    flags gather into a row null mask."""
    d = _dict_of(val)

    def build():
        results = [fn(v) for v in d.values]
        return (Dictionary(["" if r is None else r for r in results]),
                np.array([r is None for r in results] or [False], bool))

    new, isnull = _dict_cached(d, ("nullable",) + key, build)
    nulls = _dict_gather(ctx, val, isnull)
    return Val(val.data, union_nulls(val.nulls, nulls), rt, new)


def _const(vals: List[Val], idx: int, what: str):
    v = vals[idx]
    if not v.is_const:
        raise TypeError(f"{what} must be a constant")
    return v.py_value


def like_pattern_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    """Translate a SQL LIKE pattern to an anchored Python regex
    (reference: LikeFunctions.likePattern)."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


def _impl_like(ctx: Ctx, rt, vals: List[Val]) -> Val:
    pat = _const(vals, 1, "LIKE pattern")
    esc = _const(vals, 2, "LIKE escape") if len(vals) == 3 else None
    rx = re.compile(like_pattern_to_regex(pat, esc), re.DOTALL)
    return _dict_predicate(ctx, vals[0], ("like", pat, esc),
                           lambda v: rx.match(str(v)) is not None)


register("like", lambda a: T.BOOLEAN, _impl_like)


def _substr(value: str, start: int, length: Optional[int] = None) -> str:
    # SQL substr is 1-based; a negative start counts from the end
    s = str(value)
    if start > 0:
        begin = start - 1
    elif start < 0:
        begin = max(len(s) + start, 0)
    else:
        return ""
    end = len(s) if length is None else min(begin + max(length, 0), len(s))
    return s[begin:end]


def _impl_substr(ctx: Ctx, rt, vals: List[Val]) -> Val:
    start = int(_const(vals, 1, "substr start"))
    length = int(_const(vals, 2, "substr length")) if len(vals) == 3 \
        else None
    return _dict_map(ctx, vals[0], ("substr", start, length),
                     lambda v: _substr(v, start, length), rt)


register("substr", lambda a: T.VARCHAR, _impl_substr)
register("substring", lambda a: T.VARCHAR, _impl_substr)


def _impl_strfn(name, fn):
    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        return _dict_map(ctx, vals[0], (name,), fn, rt)

    return impl


register("lower", lambda a: a[0],
         _impl_strfn("lower", lambda v: str(v).lower()))
register("upper", lambda a: a[0],
         _impl_strfn("upper", lambda v: str(v).upper()))
register("trim", lambda a: a[0],
         _impl_strfn("trim", lambda v: str(v).strip()))
register("ltrim", lambda a: a[0],
         _impl_strfn("ltrim", lambda v: str(v).lstrip()))
register("rtrim", lambda a: a[0],
         _impl_strfn("rtrim", lambda v: str(v).rstrip()))
register("reverse", lambda a: T.VARCHAR,
         _impl_strfn("reverse", lambda v: str(v)[::-1]))


def _impl_concat(ctx: Ctx, rt, vals: List[Val]) -> Val:
    # one column with constants; column || column needs the cross
    # dictionary product, which no workload asks for
    cols = [v for v in vals if not v.is_const]
    if len(cols) != 1:
        raise TypeError("concat supports one column plus constants (v1)")
    parts = tuple(None if not v.is_const else str(v.py_value)
                  for v in vals)

    def fn(value):
        return "".join(p if p is not None else str(value) for p in parts)

    return _dict_map(ctx, cols[0], ("concat", parts), fn, rt)


register("concat", lambda a: T.VARCHAR, _impl_concat)
register("length", lambda a: T.BIGINT,
         lambda ctx, rt, vals: _dict_int(ctx, vals[0], ("length",),
                                         lambda v: len(str(v))))
register("codepoint", lambda a: T.BIGINT,
         lambda ctx, rt, vals: _dict_int(
             ctx, vals[0], ("codepoint",),
             lambda v: ord(str(v)[0]) if str(v) else 0))


def _impl_strpos(ctx: Ctx, rt, vals: List[Val]) -> Val:
    sub = str(_const(vals, 1, "strpos substring"))
    return _dict_int(ctx, vals[0], ("strpos", sub),
                     lambda v: str(v).find(sub) + 1)


register("strpos", lambda a: T.BIGINT, _impl_strpos)
register("position", lambda a: T.BIGINT, _impl_strpos)


def _impl_replace(ctx: Ctx, rt, vals: List[Val]) -> Val:
    find = str(_const(vals, 1, "replace search"))
    repl = str(_const(vals, 2, "replace replacement")) if len(vals) > 2 \
        else ""
    return _dict_map(ctx, vals[0], ("replace", find, repl),
                     lambda v: str(v).replace(find, repl), T.VARCHAR)


register("replace", lambda a: T.VARCHAR, _impl_replace)


def _impl_pad(side):
    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        n = int(_const(vals, 1, "lpad/rpad size"))
        pad = str(_const(vals, 2, "lpad/rpad padstring")) or " "

        def do(v):
            s = str(v)
            if len(s) >= n:
                return s[:n]
            fill = (pad * n)[: n - len(s)]
            return fill + s if side == "l" else s + fill

        return _dict_map(ctx, vals[0], ("pad", side, n, pad), do, T.VARCHAR)

    return impl


register("lpad", lambda a: T.VARCHAR, _impl_pad("l"))
register("rpad", lambda a: T.VARCHAR, _impl_pad("r"))


def _impl_split_part(ctx: Ctx, rt, vals: List[Val]) -> Val:
    delim = str(_const(vals, 1, "split_part delimiter"))
    idx = int(_const(vals, 2, "split_part index"))

    def do(v):
        parts = str(v).split(delim)
        return parts[idx - 1] if 1 <= idx <= len(parts) else ""

    return _dict_map(ctx, vals[0], ("split_part", delim, idx), do,
                     T.VARCHAR)


register("split_part", lambda a: T.VARCHAR, _impl_split_part)


# ----------------------------------------------------------------- regexp

def _impl_regexp_like(ctx: Ctx, rt, vals: List[Val]) -> Val:
    pat = str(_const(vals, 1, "regexp pattern"))
    rx = re.compile(pat)
    return _dict_predicate(ctx, vals[0], ("regexp_like", pat),
                           lambda v: rx.search(str(v)) is not None)


register("regexp_like", lambda a: T.BOOLEAN, _impl_regexp_like)


def _impl_regexp_extract(ctx: Ctx, rt, vals: List[Val]) -> Val:
    pat = str(_const(vals, 1, "regexp pattern"))
    rx = re.compile(pat)
    group = int(vals[2].py_value) if len(vals) > 2 else 0

    def ext(v):
        m = rx.search(str(v))
        return m.group(group) if m else None  # no match -> NULL

    return _dict_map_nullable(ctx, vals[0], ("regexp_extract", pat, group),
                              ext, T.VARCHAR)


register("regexp_extract", lambda a: T.VARCHAR, _impl_regexp_extract)


def _impl_regexp_replace(ctx: Ctx, rt, vals: List[Val]) -> Val:
    pat = str(_const(vals, 1, "regexp pattern"))
    rx = re.compile(pat)
    repl = ""
    if len(vals) > 2:
        # Presto writes group references as $1, Python as \1
        repl = re.sub(r"\$(\d+)", r"\\\1",
                      str(_const(vals, 2, "regexp replacement")))
    return _dict_map(ctx, vals[0], ("regexp_replace", pat, repl),
                     lambda v: rx.sub(repl, str(v)), T.VARCHAR)


register("regexp_replace", lambda a: T.VARCHAR, _impl_regexp_replace)


# --------------------------------------------------------------------- math

def _as_double(ctx: Ctx, v: Val) -> torch.Tensor:
    return _to_common(v, T.DOUBLE, ctx.capacity).data


def _impl_round(ctx: Ctx, rt, vals: List[Val]) -> Val:
    """Half away from zero, as the reference writes it (torch.round
    rounds half to even)."""
    v = vals[0]
    n = int(vals[1].py_value) if len(vals) == 2 else 0
    if isinstance(v.type, T.DecimalType):
        s = v.type.scale
        out = rescale_decimal(v.data, s, min(n, s))
        return Val(rescale_decimal(out, min(n, s), rt.scale), None, rt)
    x = v.data if v.data.is_floating_point() else v.data.to(torch.float64)
    scale = float(10 ** n)
    x = x * scale
    r = torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))
    return Val((r / scale).to(v.data.dtype), None, rt)


register("round", lambda a: a[0], _impl_round)


def _impl_floorceil(which):
    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        v = vals[0]
        if isinstance(v.type, T.DecimalType):
            s = 10 ** v.type.scale
            data = v.data.to(torch.int64)
            out = data // s if which == "floor" else -((-data) // s)
            if isinstance(rt, T.DecimalType):
                out = out * (10 ** rt.scale)
            return Val(out, None, rt)
        if not v.data.is_floating_point():
            return Val(v.data, None, rt)
        f = torch.floor if which == "floor" else torch.ceil
        return Val(f(v.data), None, rt)

    return impl


def _floorceil_resolve(args):
    t = args[0]
    if isinstance(t, T.DecimalType):
        return T.DecimalType(min(38, t.precision - t.scale + 1), 0)
    return t


register("floor", _floorceil_resolve, _impl_floorceil("floor"))
register("ceil", _floorceil_resolve, _impl_floorceil("ceil"))
register("ceiling", _floorceil_resolve, _impl_floorceil("ceil"))

_NAN = float("nan")


def _impl_simple_double(fn):
    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        return Val(fn(_as_double(ctx, vals[0])), None, T.DOUBLE)

    return impl


def _nan_unless_positive(x):
    return torch.where(x <= 0, _NAN, x)


for _name, _fn in [
    ("sqrt", lambda x: torch.where(x < 0, _NAN,
                                   torch.sqrt(torch.where(x < 0, 0.0, x)))),
    ("ln", lambda x: torch.where(x <= 0, _NAN,
                                 torch.log(torch.where(x <= 0, 1.0, x)))),
    ("exp", torch.exp),
    ("log2", lambda x: torch.log2(_nan_unless_positive(x))),
    ("log10", lambda x: torch.log10(_nan_unless_positive(x))),
    ("cbrt", lambda x: torch.sign(x) * torch.pow(x.abs(), 1.0 / 3.0)),
    ("sin", torch.sin),
    ("cos", torch.cos),
    ("tan", torch.tan),
    ("asin", torch.asin),
    ("acos", torch.acos),
    ("atan", torch.atan),
    ("sinh", torch.sinh),
    ("cosh", torch.cosh),
    ("tanh", torch.tanh),
    ("degrees", lambda x: x * (180.0 / np.pi)),
    ("radians", lambda x: x * (np.pi / 180.0)),
    ("truncate", torch.trunc),
]:
    register(_name, lambda a: T.DOUBLE, _impl_simple_double(_fn))


def _impl_power(ctx: Ctx, rt, vals: List[Val]) -> Val:
    x = _as_double(ctx, vals[0])
    y = _as_double(ctx, vals[1])
    out = torch.pow(x.abs(), y) * torch.where((x < 0) & (y % 2 == 1),
                                              -1.0, 1.0)
    # Java Math.pow: a FINITE negative base with a non-integer exponent
    # is NaN (pow(-inf, 0.5) = +inf, pow(-inf, -0.5) = +0.0 stay)
    out = torch.where((x < 0) & torch.isfinite(x) & (y != torch.floor(y)),
                      _NAN, out)
    return Val(out, None, T.DOUBLE)


register("power", lambda a: T.DOUBLE, _impl_power)
register("pow", lambda a: T.DOUBLE, _impl_power)


def _var_numeric_resolve(args):
    t = args[0]
    for a in args[1:]:
        nxt = T.common_super_type(t, a)
        if nxt is None:
            raise TypeError(f"incompatible args: {t} vs {a}")
        t = nxt
    return t


def _impl_greatest_least(which):
    pick = torch.maximum if which == "greatest" else torch.minimum

    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        acc = _to_common(vals[0], rt, ctx.capacity).data
        for v in vals[1:]:
            acc = pick(acc, _to_common(v, rt, ctx.capacity).data)
        return Val(acc, None, rt)

    return impl


register("greatest", _var_numeric_resolve, _impl_greatest_least("greatest"))
register("least", _var_numeric_resolve, _impl_greatest_least("least"))


def _impl_atan2(ctx: Ctx, rt, vals: List[Val]) -> Val:
    return Val(torch.atan2(_as_double(ctx, vals[0]),
                           _as_double(ctx, vals[1])), None, T.DOUBLE)


register("atan2", lambda a: T.DOUBLE, _impl_atan2)


def _impl_log_base(ctx: Ctx, rt, vals: List[Val]) -> Val:
    """log(b, x) = ln(x) / ln(b) (reference: MathFunctions.log)."""
    b = _as_double(ctx, vals[0])
    x = _as_double(ctx, vals[1])
    return Val(torch.log(_nan_unless_positive(x))
               / torch.log(_nan_unless_positive(b)), None, T.DOUBLE)


register("log", lambda a: T.DOUBLE, _impl_log_base)


def _impl_mod(ctx: Ctx, rt, vals: List[Val]) -> Val:
    """mod(a, b) with Java remainder semantics (the sign follows the
    dividend); b == 0 -> NULL (masked-eval policy)."""
    ct = _var_numeric_resolve([vals[0].type, vals[1].type])
    a = _to_common(vals[0], ct, ctx.capacity).data
    b = _to_common(vals[1], ct, ctx.capacity).data
    zero = b == 0
    safe = torch.where(zero, torch.ones_like(b), b)
    if T.is_floating(ct):
        out = a - torch.trunc(a / safe) * safe
    else:
        # truncation remainder a - trunc(a / b) * b, via the abs quotient
        q = a.abs() // safe.abs()
        out = a - torch.sign(a) * q * safe.abs()
    return Val(torch.where(zero, torch.zeros_like(out), out), zero, ct)


register("mod", _var_numeric_resolve, _impl_mod)
register("sign", lambda a: a[0],
         lambda ctx, rt, vals: Val(torch.sign(vals[0].data).to(
             vals[0].data.dtype), None, vals[0].type))


def _impl_zero_arg(value):
    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        return Val(torch.full((), value, dtype=torch.float64,
                              device=ctx.device), None, T.DOUBLE)

    return impl


register("pi", lambda a: T.DOUBLE, _impl_zero_arg(np.pi))
register("e", lambda a: T.DOUBLE, _impl_zero_arg(np.e))
register("infinity", lambda a: T.DOUBLE, _impl_zero_arg(np.inf))
register("nan", lambda a: T.DOUBLE, _impl_zero_arg(np.nan))


def _impl_float_pred(fn):
    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        return Val(fn(_as_double(ctx, vals[0])), None, T.BOOLEAN)

    return impl


register("is_nan", lambda a: T.BOOLEAN, _impl_float_pred(torch.isnan))
register("is_finite", lambda a: T.BOOLEAN, _impl_float_pred(torch.isfinite))
register("is_infinite", lambda a: T.BOOLEAN, _impl_float_pred(torch.isinf))


def _impl_width_bucket(ctx: Ctx, rt, vals: List[Val]) -> Val:
    """width_bucket(x, lo, hi, n) (reference: MathFunctions)."""
    x, lo, hi = (_as_double(ctx, v) for v in vals[:3])
    n = _to_common(vals[3], T.BIGINT, ctx.capacity).data
    width = (hi - lo) / n.clamp(min=1).to(torch.float64)
    raw = torch.floor((x - lo) / torch.where(width == 0, 1.0, width)) + 1
    out = torch.minimum(raw.clamp(min=0), (n + 1).to(torch.float64))
    return Val(out.to(torch.int64), None, T.BIGINT)


register("width_bucket", lambda a: T.BIGINT, _impl_width_bucket)


def _impl_nullif(ctx: Ctx, rt, vals: List[Val]) -> Val:
    """NULLIF(a, b): NULL where a = b, else a. A NULL a stays NULL; a
    NULL b keeps a. The comparison is `=`'s, coercions included."""
    a, b = vals
    is_eq = _impl_cmp("eq")(ctx, T.BOOLEAN, [a, b]).data
    if b.nulls is not None:
        is_eq = is_eq & ~b.nulls
    return Val(a.data, union_nulls(a.nulls, is_eq), a.type, a.dictionary)


register("nullif", lambda a: a[0], _impl_nullif, propagate_nulls=False)


# ------------------------------------------------------ temporal functions

_US = 1_000_000
_US_OF_UNIT = {"hour": 3_600_000_000, "minute": 60_000_000, "second": _US,
               "millisecond": 1000}


def _days_and_us(v: Val):
    """(days, intraday microseconds, is_timestamp) from a date/ts Val."""
    if isinstance(v.type, T.TimestampType):
        days = v.data // _US_PER_DAY
        return days, v.data - days * _US_PER_DAY, True
    return v.data.to(torch.int64), None, False


def _impl_date_trunc(ctx: Ctx, rt, vals: List[Val]) -> Val:
    unit = str(_const(vals, 0, "date_trunc unit")).lower()
    v = vals[1]
    days, _us, is_ts = _days_and_us(v)
    if unit in _US_OF_UNIT:
        if not is_ts:
            return Val(v.data, None, v.type, v.dictionary)
        q = _US_OF_UNIT[unit]
        return Val(v.data - v.data % q, None, v.type)
    y, m, _d = civil_from_days(days)
    one = torch.ones_like(y)
    if unit == "day":
        out_days = days
    elif unit == "week":
        out_days = days - (days + 3) % 7
    elif unit == "month":
        out_days = days_from_civil(y, m, one)
    elif unit == "quarter":
        out_days = days_from_civil(y, (m - 1) // 3 * 3 + 1, one)
    elif unit == "year":
        out_days = days_from_civil(y, one, one)
    else:
        raise ValueError(f"date_trunc unit {unit!r}")
    if is_ts:
        return Val(out_days * _US_PER_DAY, None, v.type)
    return Val(out_days.to(v.data.dtype), None, v.type)


register("date_trunc", lambda a: a[1], _impl_date_trunc)


def _impl_date_add(ctx: Ctx, rt, vals: List[Val]) -> Val:
    unit = str(_const(vals, 0, "date_add unit")).lower()
    n = _to_common(vals[1], T.BIGINT, ctx.capacity).data
    v = vals[2]
    days, us, is_ts = _days_and_us(v)
    if unit in _US_OF_UNIT:
        if not is_ts:
            raise TypeError(f"date_add({unit}) over DATE")
        return Val(v.data + n * _US_OF_UNIT[unit], None, v.type)
    if unit in ("day", "week"):
        out_days = days + n * (7 if unit == "week" else 1)
    elif unit in ("month", "quarter", "year"):
        k = {"month": 1, "quarter": 3, "year": 12}[unit]
        out_days = add_months_to_days(days, n * k).to(torch.int64)
    else:
        raise ValueError(f"date_add unit {unit!r}")
    if is_ts:
        return Val(out_days * _US_PER_DAY + us, None, v.type)
    return Val(out_days.to(v.data.dtype), None, v.type)


register("date_add", lambda a: a[2], _impl_date_add)


def _impl_date_diff(ctx: Ctx, rt, vals: List[Val]) -> Val:
    """date_diff(unit, a, b) = complete units from a to b (reference:
    DateTimeFunctions over Joda *.between, counting whole periods)."""
    unit = str(_const(vals, 0, "date_diff unit")).lower()
    da, ua, _ = _days_and_us(vals[1])
    db, ub, _ = _days_and_us(vals[2])
    if unit in _US_OF_UNIT or unit in ("day", "week"):
        # complete elapsed units truncated toward zero: day and week over
        # timestamps count whole 24 h / 168 h periods
        q = _US_OF_UNIT.get(unit) or (
            _US_PER_DAY * (7 if unit == "week" else 1))
        usa = da * _US_PER_DAY + (ua if ua is not None else 0)
        usb = db * _US_PER_DAY + (ub if ub is not None else 0)
        delta = usb - usa
        return Val(torch.sign(delta) * (delta.abs() // q), None, T.BIGINT)
    if unit in ("month", "quarter", "year"):
        ya, ma, dda = civil_from_days(da)
        yb, mb, ddb = civil_from_days(db)
        months = (yb - ya) * 12 + (mb - ma)
        # an incomplete final month does not count (Joda monthsBetween)
        incomplete = torch.where(
            months > 0, ddb < dda,
            torch.where(months < 0, ddb > dda, torch.zeros_like(ddb < dda)))
        months = months - torch.where(incomplete, torch.sign(months), 0)
        k = {"month": 1, "quarter": 3, "year": 12}[unit]
        out = months if k == 1 else torch.sign(months) * (months.abs() // k)
        return Val(out, None, T.BIGINT)
    raise ValueError(f"date_diff unit {unit!r}")


register("date_diff", lambda a: T.BIGINT, _impl_date_diff)
register("from_unixtime", lambda a: T.TIMESTAMP,
         lambda ctx, rt, vals: Val(
             (_as_double(ctx, vals[0]) * 1e6).to(torch.int64), None,
             T.TIMESTAMP))
register("to_unixtime", lambda a: T.DOUBLE,
         lambda ctx, rt, vals: Val(vals[0].data.to(torch.float64) / 1e6,
                                   None, T.DOUBLE))

_TS_PART = {"hour": (3_600_000_000, 24), "minute": (60_000_000, 60),
            "second": (_US, 60), "millisecond": (1000, 1000)}


def _impl_ts_part(part: str):
    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        v = vals[0]
        if not isinstance(v.type, T.TimestampType):
            raise TypeError(f"{part}() over {v.type}")
        q, m = _TS_PART[part]
        return Val((v.data // q) % m, None, T.BIGINT)

    return impl


for _part in _TS_PART:
    register(_part, lambda a: T.BIGINT, _impl_ts_part(_part))


# ------------------------------------------------------------ complex types
# ARRAY/MAP/ROW values are dictionary-coded (host tuples, int32 codes):
# per-distinct-value work on the host, one gather per row, as for
# strings (reference: spi/block/{Array,Map,Row}Block +
# operator/scalar/{Array,Map}Functions).


def _cardinality_resolve(args):
    if not isinstance(args[0], (T.ArrayType, T.MapType)):
        raise TypeError(f"cardinality over {args[0]}")
    return T.BIGINT


register("cardinality", _cardinality_resolve,
         lambda ctx, rt, vals: _dict_int(ctx, vals[0], ("cardinality",),
                                         len))


def _elem_result_val(ctx: Ctx, col: Val, key: tuple, fn,
                     elem_t: T.SqlType) -> Val:
    """``fn`` over each distinct value (None = NULL) -> a typed Val:
    dictionary-coded element types get a new dictionary; the others
    gather from a typed lut."""
    d = _dict_of(col)

    def build():
        results = [fn(v) for v in d.values]
        isnull = np.array([r is None for r in results] or [True], bool)
        if elem_t.is_dictionary_encoded:
            return isnull, Dictionary(
                ["" if r is None else r for r in results])
        lut = np.zeros(max(len(results), 1), np.dtype(elem_t.numpy_dtype))
        for i, r in enumerate(results):
            if r is not None:
                lut[i] = r
        return isnull, lut

    isnull, table = _dict_cached(d, ("elem",) + key, build)
    nulls = union_nulls(col.nulls, _dict_gather(ctx, col, isnull))
    if elem_t.is_dictionary_encoded:
        return Val(col.data, nulls, elem_t, table)
    return Val(_dict_gather(ctx, col, table), nulls, elem_t)


def _impl_element_at(ctx: Ctx, rt, vals: List[Val]) -> Val:
    """element_at(array, index) / element_at(map, key) / element_at(row,
    ordinal). Array/row indices are 1-based; out-of-range indices and
    missing map keys yield NULL (reference: MapFunctions.elementAt /
    ArrayFunctions)."""
    col = vals[0]
    k = _const(vals, 1, "element_at key/index")
    t = col.type
    if isinstance(t, T.MapType):
        def get(v):
            for mk, mv in v:
                if mk == k:
                    return mv
            return None

        return _elem_result_val(ctx, col, ("element_at", k), get, t.value)
    idx = int(k)  # array / row: 1-based ordinal
    elem_t = (t.element if isinstance(t, T.ArrayType)
              else (t.fields[idx - 1] if isinstance(t, T.RowType)
                    and 1 <= idx <= len(t.fields) else T.UNKNOWN))
    return _elem_result_val(
        ctx, col, ("element_at", idx),
        lambda v: v[idx - 1] if 1 <= idx <= len(v) else None, elem_t)


def _element_at_resolve(args):
    t = args[0]
    if isinstance(t, T.ArrayType):
        return t.element
    if isinstance(t, T.MapType):
        return t.value
    if isinstance(t, T.RowType):
        return T.UNKNOWN  # refined at eval; constants resolve later
    raise TypeError(f"element_at over {t}")


register("element_at", _element_at_resolve, _impl_element_at)


def _impl_contains(ctx: Ctx, rt, vals: List[Val]) -> Val:
    k = _const(vals, 1, "contains() value")
    return _dict_predicate(ctx, vals[0], ("contains", k), lambda v: k in v)


register("contains", lambda a: T.BOOLEAN, _impl_contains)


def _impl_array_minmax(which):
    f = min if which == "min" else max

    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        col = vals[0]

        def get(v):
            xs = [x for x in v if x is not None]
            return f(xs) if xs else None

        return _elem_result_val(ctx, col, ("array_" + which,), get,
                                col.type.element)

    return impl


def _array_elem_resolve(args):
    if not isinstance(args[0], T.ArrayType):
        raise TypeError(f"array function over {args[0]}")
    return args[0].element


register("array_min", _array_elem_resolve, _impl_array_minmax("min"))
register("array_max", _array_elem_resolve, _impl_array_minmax("max"))


def _impl_map_keys_values(which):
    i = 0 if which == "keys" else 1

    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        col = vals[0]
        t = col.type
        elem = t.key if which == "keys" else t.value
        return _dict_map(ctx, col, ("map_" + which,),
                         lambda v: tuple(pair[i] for pair in v),
                         T.ArrayType(elem))

    return impl


def _map_arr_resolve(which):
    def resolve(args):
        t = args[0]
        if not isinstance(t, T.MapType):
            raise TypeError(f"map function over {t}")
        return T.ArrayType(t.key if which == "keys" else t.value)

    return resolve


register("map_keys", _map_arr_resolve("keys"),
         _impl_map_keys_values("keys"))
register("map_values", _map_arr_resolve("values"),
         _impl_map_keys_values("values"))


def _complex_const(ctx: Ctx, t: T.SqlType, value) -> Val:
    """A complex constant as a one-entry dictionary value."""
    return Val(torch.zeros((), dtype=torch.int32, device=ctx.device), None,
               t, Dictionary([value]), py_value=value)


def _impl_map_ctor(ctx: Ctx, rt, vals: List[Val]) -> Val:
    """map(key_array, value_array) over constant arrays."""
    ka, va = vals[0], vals[1]
    if not (ka.is_const and va.is_const):
        raise TypeError("map() arguments must be constant arrays")
    return _complex_const(ctx, T.MapType(ka.type.element, va.type.element),
                          tuple(zip(ka.py_value, va.py_value)))


def _map_ctor_resolve(args):
    if len(args) != 2 or not all(isinstance(a, T.ArrayType) for a in args):
        raise TypeError("map() takes two array arguments")
    return T.MapType(args[0].element, args[1].element)


register("map", _map_ctor_resolve, _impl_map_ctor)


def _impl_row_ctor(ctx: Ctx, rt, vals: List[Val]) -> Val:
    if not all(v.is_const for v in vals):
        raise TypeError("row() arguments must be constants")
    return _complex_const(ctx, T.RowType(tuple(v.type for v in vals)),
                          tuple(v.py_value for v in vals))


register("row", lambda a: T.RowType(tuple(a)), _impl_row_ctor)


# the extended builtin families register themselves on import
from presto_tpu_torch.expr import functions_ext  # noqa: E402,F401  isort:skip
from presto_tpu_torch.expr import functions_more  # noqa: E402,F401  isort:skip
