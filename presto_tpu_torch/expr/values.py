"""Evaluated-value representation and tensor helpers.

Port of presto_tpu/expr/values.py. The reference writes these against an
array namespace ``xp`` (jax.numpy or numpy); the port writes them once,
against torch. One difference to keep in mind: a Python int scalar does
not widen a torch int32 tensor the way a numpy int64 scalar widens a
numpy int32 array, so every decimal/date computation here converts to
int64 explicitly first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.ops import consts
from presto_tpu_torch.page import Dictionary

NOT_CONST = object()

_US_PER_DAY = 86_400_000_000


@dataclasses.dataclass
class Val:
    """A vectorized value: one tensor (or limb pair) per page position.

    nulls is None (no nulls) or a bool tensor, True = SQL NULL.
    dictionary carries the host-side Dictionary for string-typed values.
    py_value is the Python literal when this Val came from a Constant —
    string literals resolve to dictionary codes where they are used.
    """

    data: Any
    nulls: Any
    type: T.SqlType
    dictionary: Optional[Dictionary] = None
    py_value: Any = NOT_CONST

    @property
    def is_const(self) -> bool:
        return self.py_value is not NOT_CONST


def union_nulls(*nulls):
    out = None
    for n in nulls:
        if n is None:
            continue
        out = n if out is None else (out | n)
    return out


def broadcast_arr(arr: torch.Tensor, cap: int) -> torch.Tensor:
    if arr.dim() == 0:
        return arr.expand(cap)
    return arr


def broadcast_val(val: Val, cap: int) -> Val:
    data = val.data
    if isinstance(data, tuple):
        data = tuple(broadcast_arr(d, cap) for d in data)
    else:
        data = broadcast_arr(data, cap)
    nulls = None if val.nulls is None else broadcast_arr(val.nulls, cap)
    return Val(data, nulls, val.type, val.dictionary, val.py_value)


# ------------------------------------------------------------------ casting


def rescale_decimal(data: torch.Tensor, from_scale: int, to_scale: int):
    """Exact rescale of unscaled i64 decimal values; scale-down rounds
    half-up away from zero (reference: spi/type/Decimals rescale)."""
    if to_scale == from_scale:
        return data
    data = data.to(torch.int64)
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    return _div_round_half_up(data, 10 ** (from_scale - to_scale))


def _div_round_half_up(num: torch.Tensor, den: int) -> torch.Tensor:
    """Sign-aware round-half-up integer division by a positive constant."""
    q = (num.abs() + den // 2) // den
    return torch.where(num >= 0, q, -q)


def div_round_half_up(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Round-half-up division handling signs on both operands; den must
    be nonzero (the caller masks zeros)."""
    q = (num.abs() + den.abs() // 2) // den.abs()
    return torch.where((num >= 0) == (den >= 0), q, -q)


def cast_data(val: Val, to: T.SqlType, cap: int):
    """Cast a Val's data/nulls to another type. Returns (data, nulls).

    Reference: presto-main operator cast functions. Value-dependent
    failures follow the masked-eval policy: values wrap, no runtime
    errors (as in presto_tpu)."""
    src = val.type
    data = val.data
    nulls = val.nulls
    if src == to:
        return data, nulls
    if isinstance(src, T.UnknownType):  # typed NULL literal
        dev = data.device
        return (torch.zeros(cap, dtype=to.device_dtype, device=dev),
                torch.ones(cap, dtype=torch.bool, device=dev))
    if isinstance(data, tuple):
        # long-decimal limbs (base-2^64 two's complement): lossless into
        # double below 2^53 of unscaled magnitude
        hi, lo = data
        if T.is_floating(to):
            lo_f = lo.to(torch.float64)
            f = hi.to(torch.float64) * float(2 ** 64) + torch.where(
                lo >= 0, lo_f, lo_f + float(2 ** 64))
            if isinstance(src, T.DecimalType):
                f = f / float(10 ** src.scale)
            return f.to(to.device_dtype), nulls
        raise TypeError(f"unsupported cast from long decimal to {to}")

    if isinstance(to, T.DecimalType):
        if isinstance(src, T.DecimalType):
            return rescale_decimal(data, src.scale, to.scale), nulls
        if T.is_integral(src):
            return data.to(torch.int64) * (10 ** to.scale), nulls
        if T.is_floating(src):
            scaled = data.to(torch.float64) * float(10 ** to.scale)
            rounded = torch.where(scaled >= 0.0, torch.floor(scaled + 0.5),
                                  torch.ceil(scaled - 0.5))
            return rounded.to(torch.int64), nulls
    if isinstance(src, T.DecimalType):
        if T.is_floating(to):
            out = data.to(torch.float64) / float(10 ** src.scale)
            return out.to(to.device_dtype), nulls
        if T.is_integral(to):
            return rescale_decimal(data, src.scale, 0).to(
                to.device_dtype), nulls
        if isinstance(to, T.BooleanType):
            return data != 0, nulls
    if T.is_integral(src) or isinstance(src, T.BooleanType):
        if T.is_integral(to) or T.is_floating(to):
            return data.to(to.device_dtype), nulls
        if isinstance(to, T.BooleanType):
            return data != 0, nulls
    if T.is_floating(src):
        if T.is_floating(to):
            return data.to(to.device_dtype), nulls
        if T.is_integral(to):
            # SQL cast rounds half up (reference: DoubleOperators.castToLong)
            r = torch.where(data >= 0, torch.floor(data + 0.5),
                            torch.ceil(data - 0.5))
            return r.to(to.device_dtype), nulls
        if isinstance(to, T.BooleanType):
            return data != 0.0, nulls
    if isinstance(src, T.DateType) and isinstance(to, T.TimestampType):
        return data.to(torch.int64) * _US_PER_DAY, nulls
    if isinstance(src, T.TimestampType) and isinstance(to, T.DateType):
        return (data // _US_PER_DAY).to(torch.int32), nulls
    raise TypeError(f"unsupported cast: {src} -> {to}")


# ----------------------------------------------------- civil date arithmetic
# Branch-free Gregorian conversions (Howard Hinnant's chrono date
# algorithms) with floor-division semantics.


def civil_from_days(z: torch.Tensor):
    """days-since-1970 -> (year, month, day) int64 tensors."""
    z = z.to(torch.int64) + 719_468
    era = z // 146_097
    doe = z - era * 146_097
    yoe = (doe - doe // 1460 + doe // 36_524 - doe // 146_096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """(year, month, day) -> days-since-1970, int64."""
    y = y.to(torch.int64)
    m = m.to(torch.int64)
    d = d.to(torch.int64)
    yadj = torch.where(m <= 2, y - 1, y)
    era = yadj // 400
    yoe = yadj - era * 400
    mp = (m + 9) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = 365 * yoe + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


def days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    lengths = consts.lut([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                         m.device, np.int64)
    base = lengths[m - 1]
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    return torch.where((m == 2) & leap, 29, base)


def add_months_to_days(days: torch.Tensor, months: torch.Tensor):
    """date + INTERVAL YEAR TO MONTH with end-of-month clamping
    (Jan 31 + 1 month = Feb 28)."""
    y, m, d = civil_from_days(days)
    m0 = m - 1 + months.to(torch.int64)
    y2 = y + m0 // 12
    m2 = m0 % 12 + 1
    d2 = torch.minimum(d, days_in_month(y2, m2))
    return days_from_civil(y2, m2, d2).to(torch.int32)
