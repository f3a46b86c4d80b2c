"""Extended scalar builtins: JSON, TRY/TRY_CAST, bitwise, URL, array/map
utilities, misc string/date functions and the lambda higher-order
functions.

Port of presto_tpu/expr/functions_ext.py (reference: presto-main
operator/scalar/* — JsonFunctions + JsonExtract, TryCastFunction / the
TRY special form, BitwiseFunctions, UrlFunctions, ArrayFunctions,
MapFunctions). Same evaluation model as functions.py: value-level work
runs once per distinct dictionary entry on the host, cached per
(dictionary, function, constants), and its table reaches the device
through ``ops/consts.lut``, so one gather applies it to every row and a
captured CUDA graph copies nothing from the host.

A lambda body runs on the host: each distinct collection value becomes
a CPU page of its elements, the port's evaluator runs the body over it,
and the per-element results fold back into the per-distinct table.

Divergences (the reference's, kept):
- JSON is canonicalized varchar, not a distinct type.
- TRY is an identity pass-through: value-dependent errors already give
  NULL (masked-eval policy), so TRY(x) == x.
- CAST from varchar parses per distinct value; unparsable values yield
  NULL under both cast and try_cast (the reference engine raises for
  cast).
"""

from __future__ import annotations

import datetime
import json
import re
import urllib.parse
from typing import List

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.expr import functions as F
from presto_tpu_torch.expr.functions import Ctx, lookup, register
from presto_tpu_torch.expr.values import (
    Val,
    cast_data,
    civil_from_days,
    days_from_civil,
    days_in_month,
)
from presto_tpu_torch.page import Block, Dictionary, Page

_CONST_DICTS: dict = {}


def _const_dict(value) -> Dictionary:
    """One-entry dictionary of a constant, the same object for the same
    value (so the per-dictionary caches hit across pages)."""
    key = (type(value), value)
    d = _CONST_DICTS.get(key)
    if d is None:
        if len(_CONST_DICTS) >= 4096:
            _CONST_DICTS.clear()
        d = _CONST_DICTS.setdefault(key, Dictionary([value]))
    return d


def _strcol(val: Val) -> Val:
    """A string (or varbinary/complex) constant as a one-entry
    dictionary column: its broadcast code 0 indexes the entry."""
    if (val.dictionary is None and val.is_const
            and val.py_value is not None):
        return Val(val.data, val.nulls, val.type,
                   _const_dict(val.py_value), py_value=val.py_value)
    return val


def _dict_of(val: Val) -> Dictionary:
    """Like functions._dict_of, but accepts string constants too."""
    return F._dict_of(_strcol(val))


def _elem_result_val(ctx: Ctx, col: Val, key: tuple, fn, rt) -> Val:
    """``fn`` over each distinct value of ``col`` (None = NULL) -> a Val
    of type ``rt`` (functions._elem_result_val, constants accepted)."""
    return F._elem_result_val(ctx, _strcol(col), key + (rt,), fn, rt)


def _varchar_results(ctx: Ctx, col: Val, key: tuple, fn,
                     rt=T.VARCHAR) -> Val:
    """Per-distinct string-or-None results -> a varchar Val."""
    return _elem_result_val(ctx, col, key, fn, rt)


def _require_const(val: Val, what: str):
    if not val.is_const:
        raise TypeError(f"{what} must be a constant")
    return val.py_value


def _const_fill(ctx: Ctx, value, t: T.SqlType) -> Val:
    """A dictionary-coded constant result (sequence, repeat, typeof,
    chr): a one-entry dictionary and zero codes."""
    return Val(torch.zeros(ctx.capacity, dtype=torch.int32,
                           device=ctx.device),
               None, t, _const_dict(value), py_value=value)


# ------------------------------------------------------------------ JSON

def _json_canon(v) -> str:
    return json.dumps(v, separators=(",", ":"), ensure_ascii=False)


_JSON_BAD = object()


def _parse_json(s):
    try:
        return json.loads(s)
    except Exception:  # noqa: BLE001 - malformed JSON is a value
        return _JSON_BAD  # (SQL json functions return NULL), not an error


_JSON_PATH_RE = re.compile(
    r"""\.(?P<key>[A-Za-z_][A-Za-z0-9_]*)  # .key
      | \[\s*(?P<index>\d+)\s*\]           # [0]
      | \[\s*"(?P<qkey>[^"]*)"\s*\]        # ["key"]
      | \[\s*'(?P<sqkey>[^']*)'\s*\]       # ['key']
    """,
    re.VERBOSE,
)


def _json_path_steps(path: str):
    """Parse the $.a[0].b JSONPath subset (reference: JsonExtract's
    non-script paths). Returns None for unsupported paths."""
    if not path.startswith("$"):
        return None
    pos, steps = 1, []
    while pos < len(path):
        m = _JSON_PATH_RE.match(path, pos)
        if m is None:
            return None
        if m.group("key") is not None:
            steps.append(m.group("key"))
        elif m.group("index") is not None:
            steps.append(int(m.group("index")))
        else:
            steps.append(m.group("qkey") or m.group("sqkey") or "")
        pos = m.end()
    return steps


def _json_walk(doc, steps):
    cur = doc
    for s in steps:
        if isinstance(s, int):
            if not isinstance(cur, list) or s >= len(cur):
                return _JSON_BAD
            cur = cur[s]
        else:
            if not isinstance(cur, dict) or s not in cur:
                return _JSON_BAD
            cur = cur[s]
    return cur


def _json_extract_impl(scalar_only: bool):
    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        path = str(_require_const(vals[1], "json path"))
        steps = _json_path_steps(path)

        def one(v):
            if steps is None:
                return None
            doc = _parse_json(str(v))
            if doc is _JSON_BAD:
                return None
            out = _json_walk(doc, steps)
            if out is _JSON_BAD:
                return None
            if scalar_only:
                if isinstance(out, (dict, list)) or out is None:
                    return None
                if isinstance(out, bool):
                    return "true" if out else "false"
                return str(out)
            return _json_canon(out)

        return _varchar_results(
            ctx, vals[0], ("json_extract", scalar_only, path), one)

    return impl


def _str_resolve(args):
    if not T.is_string(args[0]):
        raise TypeError(f"expected varchar, got {args[0]}")
    return T.VARCHAR


register("json_extract", _str_resolve, _json_extract_impl(False))
register("json_extract_scalar", _str_resolve, _json_extract_impl(True))


def _json_parse_one(v):
    doc = _parse_json(str(v))
    return None if doc is _JSON_BAD else _json_canon(doc)


register("json_parse", _str_resolve,
         lambda ctx, rt, vals: _varchar_results(
             ctx, vals[0], ("json_parse",), _json_parse_one))
# json_format(json) renders the canonical text: identity over the
# canonicalized-varchar JSON representation
register("json_format", _str_resolve, lambda ctx, rt, vals: vals[0])


def _json_array_length_one(v):
    doc = _parse_json(str(v))
    return len(doc) if isinstance(doc, list) else None


register("json_array_length", lambda a: T.BIGINT,
         lambda ctx, rt, vals: _elem_result_val(
             ctx, vals[0], ("json_array_length",), _json_array_length_one,
             T.BIGINT))


def _impl_json_size(ctx: Ctx, rt, vals: List[Val]) -> Val:
    path = str(_require_const(vals[1], "json path"))
    steps = _json_path_steps(path)

    def one(v):
        if steps is None:
            return None
        doc = _parse_json(str(v))
        if doc is _JSON_BAD:
            return None
        out = _json_walk(doc, steps)
        if out is _JSON_BAD:
            return None
        return len(out) if isinstance(out, (dict, list)) else 0

    return _elem_result_val(ctx, vals[0], ("json_size", path), one, T.BIGINT)


register("json_size", lambda a: T.BIGINT, _impl_json_size)


def _impl_json_array_contains(ctx: Ctx, rt, vals: List[Val]) -> Val:
    want = _require_const(vals[1], "json_array_contains value")

    def one(v):
        doc = _parse_json(str(v))
        if not isinstance(doc, list):
            return None
        if isinstance(want, bool) or not isinstance(want, (int, float)):
            return any(type(x) is type(want) and x == want for x in doc)
        return any(
            isinstance(x, (int, float)) and not isinstance(x, bool)
            and float(x) == float(want)
            for x in doc
        )

    return _elem_result_val(ctx, vals[0],
                            ("json_array_contains", type(want), want), one,
                            T.BOOLEAN)


register("json_array_contains", lambda a: T.BOOLEAN,
         _impl_json_array_contains)


# ----------------------------------------------------------- TRY / casts

# TRY(x) == x under the masked-eval policy (module docstring)
register("try", lambda a: a[0], lambda ctx, rt, vals: vals[0],
         propagate_nulls=False)


def _parse_scalar(s: str, to: T.SqlType):
    s = s.strip()
    if T.is_integral(to):
        return int(s)
    if T.is_floating(to):
        return float(s)
    if isinstance(to, T.BooleanType):
        low = s.lower()
        if low in ("true", "t", "1"):
            return True
        if low in ("false", "f", "0"):
            return False
        raise ValueError(s)
    if isinstance(to, T.DecimalType):
        from decimal import Decimal

        q = Decimal(s).scaleb(to.scale)
        return int(q.to_integral_value(rounding="ROUND_HALF_UP"))
    if isinstance(to, T.DateType):
        return (datetime.date.fromisoformat(s)
                - datetime.date(1970, 1, 1)).days
    if isinstance(to, T.TimestampType):
        dt = datetime.datetime.fromisoformat(s)
        epoch = datetime.datetime(1970, 1, 1)
        return int((dt - epoch).total_seconds() * 1_000_000)
    raise TypeError(f"cannot parse varchar as {to}")


def _try_parse(v, to: T.SqlType):
    try:
        return _parse_scalar(str(v), to)
    except Exception:  # noqa: BLE001 - SQL CAST yields NULL on
        return None    # unparseable input, not a query failure


def _null_val(ctx: Ctx, t: T.SqlType) -> Val:
    return Val(torch.zeros(ctx.capacity, dtype=t.device_dtype,
                           device=ctx.device),
               torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device),
               t)


def _string_cast_val(ctx: Ctx, col: Val, to: T.SqlType) -> Val:
    if col.dictionary is None and col.is_const:
        # string literal: parse once on the host; a fill, not a copy
        r = _try_parse(col.py_value, to)
        if r is None:
            return _null_val(ctx, to)
        return Val(torch.full((), r, dtype=to.device_dtype,
                              device=ctx.device), None, to, py_value=r)
    return _elem_result_val(ctx, col, ("cast_from_varchar",),
                            lambda v: _try_parse(v, to), to)


def _impl_try_cast(ctx: Ctx, rt: T.SqlType, vals: List[Val]) -> Val:
    v = vals[0]
    if T.is_string(v.type) and not T.is_string(rt):
        return _string_cast_val(ctx, v, rt)
    try:
        data, nulls = cast_data(v, rt, ctx.capacity)
        return Val(data, nulls, rt,
                   v.dictionary if T.is_string(rt) else None)
    except TypeError:
        return _null_val(ctx, rt)


register("try_cast", lambda a: a[0], _impl_try_cast)


def _install_string_source_cast() -> None:
    """Teach plain CAST to parse varchar sources (per distinct value;
    unparsable -> NULL, the masked-eval divergence)."""
    base = lookup("cast")
    base_impl = base.impl

    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        v = vals[0]
        if T.is_string(v.type) and not T.is_string(rt):
            return _string_cast_val(ctx, v, rt)
        return base_impl(ctx, rt, vals)

    register("cast", base.resolve, impl, base.propagate_nulls)


_install_string_source_cast()


# ---------------------------------------------------------------- bitwise

def _bitwise_resolve(args):
    for a in args:
        if not T.is_integral(a):
            raise TypeError(f"bitwise function over {a}")
    return T.BIGINT


def _impl_bitwise(op):
    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        a = vals[0].data.to(torch.int64)
        if op == "not":
            return Val(~a, None, T.BIGINT)
        b = vals[1].data.to(torch.int64)
        if op == "and":
            return Val(a & b, None, T.BIGINT)
        if op == "or":
            return Val(a | b, None, T.BIGINT)
        return Val(a ^ b, None, T.BIGINT)

    return impl


register("bitwise_and", _bitwise_resolve, _impl_bitwise("and"))
register("bitwise_or", _bitwise_resolve, _impl_bitwise("or"))
register("bitwise_xor", _bitwise_resolve, _impl_bitwise("xor"))
register("bitwise_not", _bitwise_resolve, _impl_bitwise("not"))


def _impl_bit_count(ctx: Ctx, rt, vals: List[Val]) -> Val:
    """SWAR popcount over int64 (torch has no int64 popcount). Every
    shifted term is masked below bit 63, so the arithmetic ``>>`` gives
    the logical shift's bits."""
    bits = 64
    if len(vals) > 1:
        bits = int(_require_const(vals[1], "bit_count bits"))
    u = vals[0].data.to(torch.int64)
    if bits < 64:
        u = u & ((1 << bits) - 1)
    x = u - ((u >> 1) & 0x5555555555555555)
    x = ((x >> 2) & 0x3333333333333333) + (x & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    c = torch.zeros_like(u)
    for k in range(8):
        c = c + ((x >> (8 * k)) & 0xFF)
    return Val(c, None, T.BIGINT)


register("bit_count", lambda a: T.BIGINT, _impl_bit_count)


# -------------------------------------------------------------------- URL

def _url_part(part: str):
    def one(v):
        try:
            u = urllib.parse.urlsplit(str(v))
        except Exception:  # noqa: BLE001 - url functions yield NULL
            return None    # on malformed input (reference semantics)
        if part == "protocol":
            return u.scheme or None
        if part == "host":
            return u.hostname or None
        if part == "port":
            return u.port
        if part == "path":
            return u.path
        if part == "query":
            return u.query
        if part == "fragment":
            return u.fragment
        raise ValueError(part)

    return one


for _p in ("protocol", "host", "path", "query", "fragment"):
    register(
        f"url_extract_{_p}", _str_resolve,
        (lambda p: lambda ctx, rt, vals: _varchar_results(
            ctx, vals[0], ("url_split", p), _url_part(p)))(_p),
    )
register(
    "url_extract_port", lambda a: T.BIGINT,
    lambda ctx, rt, vals: _elem_result_val(
        ctx, vals[0], ("url_split", "port"), _url_part("port"), T.BIGINT),
)


def _impl_url_extract_parameter(ctx: Ctx, rt, vals: List[Val]) -> Val:
    name = str(_require_const(vals[1], "parameter name"))

    def one(v):
        try:
            q = urllib.parse.urlsplit(str(v)).query
            params = urllib.parse.parse_qs(q, keep_blank_values=True)
        except Exception:  # noqa: BLE001 - url functions yield NULL
            return None    # on malformed input (reference semantics)
        vs = params.get(name)
        return vs[0] if vs else None

    return _varchar_results(ctx, vals[0], ("url_extract_parameter", name),
                            one)


register("url_extract_parameter", _str_resolve,
         _impl_url_extract_parameter)
register("url_encode", _str_resolve,
         lambda ctx, rt, vals: _varchar_results(
             ctx, vals[0], ("url_encode",),
             lambda v: urllib.parse.quote(str(v), safe="")))
register("url_decode", _str_resolve,
         lambda ctx, rt, vals: _varchar_results(
             ctx, vals[0], ("url_decode",),
             lambda v: urllib.parse.unquote(str(v))))


# ----------------------------------------------------------- array / map

def _array_resolve_same(args):
    if not isinstance(args[0], T.ArrayType):
        raise TypeError(f"expected array, got {args[0]}")
    return args[0]


def _array_map(ctx: Ctx, col: Val, key: tuple, fn, rt) -> Val:
    return _elem_result_val(ctx, col, key, lambda v: fn(tuple(v)), rt)


register("array_distinct", _array_resolve_same,
         lambda ctx, rt, vals: _array_map(
             ctx, vals[0], ("array_distinct",),
             lambda v: tuple(dict.fromkeys(v)), rt))


def _sort_key(x):
    return (x is None, x)


register("array_sort", _array_resolve_same,
         lambda ctx, rt, vals: _array_map(
             ctx, vals[0], ("array_sort",),
             lambda v: tuple(sorted(v, key=_sort_key)), rt))


def _impl_array_join(ctx: Ctx, rt, vals: List[Val]) -> Val:
    delim = str(_require_const(vals[1], "array_join delimiter"))
    null_rep = None
    if len(vals) > 2:
        null_rep = str(_require_const(vals[2], "null replacement"))

    def one(v):
        parts = []
        for x in v:
            if x is None:
                if null_rep is None:
                    continue
                parts.append(null_rep)
            elif isinstance(x, bool):
                parts.append("true" if x else "false")
            else:
                parts.append(str(x))
        return delim.join(parts)

    return _varchar_results(ctx, vals[0], ("array_join", delim, null_rep),
                            lambda v: one(tuple(v)))


register("array_join", lambda a: T.VARCHAR, _impl_array_join)


def _impl_array_position(ctx: Ctx, rt, vals: List[Val]) -> Val:
    want = _require_const(vals[1], "array_position value")

    def one(v):
        for i, x in enumerate(v):
            if x == want:
                return i + 1
        return 0

    return _elem_result_val(ctx, vals[0],
                            ("array_position", type(want), want),
                            lambda v: one(tuple(v)), T.BIGINT)


register("array_position", lambda a: T.BIGINT, _impl_array_position)


def _impl_array_remove(ctx: Ctx, rt, vals: List[Val]) -> Val:
    want = _require_const(vals[1], "array_remove value")
    return _array_map(ctx, vals[0], ("array_remove", type(want), want),
                      lambda v: tuple(x for x in v if x != want), rt)


register("array_remove", _array_resolve_same, _impl_array_remove)


def _impl_slice(ctx: Ctx, rt, vals: List[Val]) -> Val:
    start = int(_require_const(vals[1], "slice start"))
    length = int(_require_const(vals[2], "slice length"))

    def one(v):
        if start > 0:
            i = start - 1
        elif start < 0:
            i = max(len(v) + start, 0)
        else:
            return None  # slice(x, 0, n) is an error in the reference
        return tuple(v[i:i + max(length, 0)])

    return _array_map(ctx, vals[0], ("slice", start, length), one, rt)


register("slice", _array_resolve_same, _impl_slice)


def _flatten_one(v):
    out = []
    for x in v:
        if x is not None:
            out.extend(x)
    return tuple(out)


def _flatten_resolve(args):
    t = args[0]
    if not (isinstance(t, T.ArrayType)
            and isinstance(t.element, T.ArrayType)):
        raise TypeError(f"flatten over {t}")
    return t.element


register("flatten", _flatten_resolve,
         lambda ctx, rt, vals: _array_map(ctx, vals[0], ("flatten",),
                                          _flatten_one, rt))


def _impl_sequence(ctx: Ctx, rt, vals: List[Val]) -> Val:
    a = int(_require_const(vals[0], "sequence start"))
    b = int(_require_const(vals[1], "sequence stop"))
    step = (int(_require_const(vals[2], "sequence step"))
            if len(vals) > 2 else (1 if b >= a else -1))
    if step == 0:
        raise ValueError("sequence step cannot be zero")
    val = tuple(range(a, b + (1 if step > 0 else -1), step))
    return _const_fill(ctx, val, T.ArrayType(T.BIGINT))


register("sequence", lambda a: T.ArrayType(T.BIGINT), _impl_sequence)


def _impl_repeat(ctx: Ctx, rt, vals: List[Val]) -> Val:
    n = int(_require_const(vals[1], "repeat count"))
    el = vals[0]
    if not el.is_const:
        raise TypeError("repeat element must be a constant")
    return _const_fill(ctx, tuple([el.py_value] * max(n, 0)),
                       T.ArrayType(el.type))


register("repeat", lambda a: T.ArrayType(a[0]), _impl_repeat)


def _install_reverse_for_arrays() -> None:
    base = lookup("reverse")
    base_impl = base.impl

    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        if isinstance(vals[0].type, T.ArrayType):
            return _array_map(ctx, vals[0], ("reverse",),
                              lambda v: tuple(reversed(v)), vals[0].type)
        return base_impl(ctx, rt, vals)

    def resolve(args):
        if isinstance(args[0], T.ArrayType):
            return args[0]
        return base.resolve(args)

    register("reverse", resolve, impl, base.propagate_nulls)


_install_reverse_for_arrays()


def _impl_split(ctx: Ctx, rt, vals: List[Val]) -> Val:
    delim = str(_require_const(vals[1], "split delimiter"))
    limit = (int(_require_const(vals[2], "split limit"))
             if len(vals) > 2 else None)

    def one(v):
        s = str(v)
        return tuple(s.split(delim, limit - 1) if limit is not None
                     else s.split(delim))

    return _elem_result_val(ctx, vals[0], ("split", delim, limit), one,
                            T.ArrayType(T.VARCHAR))


register("split", lambda a: T.ArrayType(T.VARCHAR), _impl_split)


def _impl_map_entries(ctx: Ctx, rt, vals: List[Val]) -> Val:
    t = vals[0].type
    return _elem_result_val(
        ctx, vals[0], ("map_entries",),
        lambda v: tuple(tuple(kv) for kv in v),
        T.ArrayType(T.RowType((t.key, t.value))))


register(
    "map_entries",
    lambda a: T.ArrayType(T.RowType((a[0].key, a[0].value)))
    if isinstance(a[0], T.MapType) else T.UNKNOWN,
    _impl_map_entries,
)


register("typeof", lambda a: T.VARCHAR,
         lambda ctx, rt, vals: _const_fill(ctx, str(vals[0].type),
                                           T.VARCHAR),
         propagate_nulls=False)


# ------------------------------------------------------------------ misc

def _impl_chr(ctx: Ctx, rt, vals: List[Val]) -> Val:
    n = _require_const(vals[0], "chr codepoint")
    return _const_fill(ctx, chr(int(n)), T.VARCHAR)


register("chr", lambda a: T.VARCHAR, _impl_chr)

_US_PER_DAY = 86_400_000_000


def _impl_last_day_of_month(ctx: Ctx, rt, vals: List[Val]) -> Val:
    v = vals[0]
    days = v.data
    if isinstance(v.type, T.TimestampType):
        days = (days // _US_PER_DAY).to(torch.int32)
    y, m, _d = civil_from_days(days)
    last = days_in_month(y, m)
    return Val(days_from_civil(y, m, last).to(torch.int32), None, T.DATE)


register("last_day_of_month", lambda a: T.DATE, _impl_last_day_of_month)


def _impl_date_parse(ctx: Ctx, rt, vals: List[Val]) -> Val:
    """date_parse(varchar, mysql-format) -> timestamp (reference:
    MySQL-compatible DateTimeFunctions.dateParse). Supported
    specifiers: %Y %y %m %c %d %e %H %k %i %s %f."""
    fmt = str(_require_const(vals[1], "date_parse format"))
    pyfmt = (fmt.replace("%c", "%m").replace("%e", "%d")
             .replace("%k", "%H").replace("%i", "%M")
             .replace("%s", "%S"))

    def one(v):
        try:
            dt = datetime.datetime.strptime(str(v), pyfmt)
        except Exception:  # noqa: BLE001 - unparseable datetime text
            return None    # yields NULL (reference semantics)
        epoch = datetime.datetime(1970, 1, 1)
        return int((dt - epoch).total_seconds() * 1_000_000)

    return _elem_result_val(ctx, vals[0], ("date_parse", fmt), one,
                            T.TIMESTAMP)


register("date_parse", lambda a: T.TIMESTAMP, _impl_date_parse)

register("to_hex", _str_resolve,
         lambda ctx, rt, vals: _varchar_results(
             ctx, vals[0], ("to_hex",),
             lambda v: str(v).encode("utf-8").hex().upper()))


def _from_hex_one(v):
    try:
        return bytes.fromhex(str(v)).decode("utf-8")
    except Exception:  # noqa: BLE001 - undecodable input yields
        return None    # NULL (reference semantics)


register("from_hex", _str_resolve,
         lambda ctx, rt, vals: _varchar_results(
             ctx, vals[0], ("from_hex",), _from_hex_one))


def _impl_hash_fn(algo):
    import hashlib

    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        return _varchar_results(
            ctx, vals[0], ("hexdigest", algo),
            lambda v: hashlib.new(algo, str(v).encode("utf-8")).hexdigest())

    return impl


# hex-digest flavors of the reference's varbinary md5/sha256 (varbinary
# payloads stay host-side, in dictionaries)
register("md5", _str_resolve, _impl_hash_fn("md5"))
register("sha256", _str_resolve, _impl_hash_fn("sha256"))
register("sha1", _str_resolve, _impl_hash_fn("sha1"))


def _to_base64_one(v):
    import base64

    return base64.b64encode(str(v).encode("utf-8")).decode("ascii")


def _from_base64_one(v):
    import base64

    try:
        return base64.b64decode(str(v)).decode("utf-8")
    except Exception:  # noqa: BLE001 - undecodable input yields
        return None    # NULL (reference semantics)


register("to_base64", _str_resolve,
         lambda ctx, rt, vals: _varchar_results(
             ctx, vals[0], ("to_base64",), _to_base64_one))
register("from_base64", _str_resolve,
         lambda ctx, rt, vals: _varchar_results(
             ctx, vals[0], ("from_base64",), _from_base64_one))


def _impl_normalize(ctx: Ctx, rt, vals: List[Val]) -> Val:
    import unicodedata

    form = "NFC"
    if len(vals) > 1:
        form = str(_require_const(vals[1], "normalize form")).upper()
    return _varchar_results(ctx, vals[0], ("normalize", form),
                            lambda v: unicodedata.normalize(form, str(v)))


register("normalize", _str_resolve, _impl_normalize)


def _impl_starts_with(ctx: Ctx, rt, vals: List[Val]) -> Val:
    prefix = str(_require_const(vals[1], "starts_with prefix"))
    return _elem_result_val(ctx, vals[0], ("starts_with", prefix),
                            lambda v: str(v).startswith(prefix), T.BOOLEAN)


register("starts_with", lambda a: T.BOOLEAN, _impl_starts_with)


# ------------------------------------------------- higher-order (lambdas)

def _infer_elem_type(vals_, declared):
    if declared is not None and not isinstance(declared, T.UnknownType):
        return declared
    for v in vals_:
        if v is None:
            continue
        if isinstance(v, bool):
            return T.BOOLEAN
        if isinstance(v, int):
            return T.BIGINT
        if isinstance(v, float):
            return T.DOUBLE
        if isinstance(v, str):
            return T.VARCHAR
        if isinstance(v, (list, tuple)):
            return T.ArrayType(T.UNKNOWN)
    return T.BIGINT


def _host_block(vals_, t) -> Block:
    """One lambda parameter's element column as a CPU Block."""
    n = len(vals_)
    isnull = np.array([v is None for v in vals_], bool)

    def stage(a):
        return XF.to_device(a, "cpu", label="lambda-eval")

    nulls = stage(isnull) if isnull.any() else None
    if t.is_dictionary_encoded:
        uniq: dict = {}
        codes = np.zeros(n, np.int32)
        for i, v in enumerate(vals_):
            if v is not None:
                codes[i] = uniq.setdefault(v, len(uniq))
        return Block(data=stage(codes), type=t, nulls=nulls,
                     dictionary=Dictionary(list(uniq)))
    data = np.zeros(n, np.dtype(t.numpy_dtype))
    for i, v in enumerate(vals_):
        if v is not None:
            data[i] = v
    return Block(data=stage(data), type=t, nulls=nulls)


def _val_to_pylist(val: Val, n: int) -> list:
    """A CPU Val of n positions as Python values (None = NULL)."""
    if isinstance(val.data, tuple):
        raise TypeError("lambda bodies over long decimals unsupported")
    arr = XF.np_host(val.data, label="lambda-eval")
    if arr.ndim == 0:
        arr = np.broadcast_to(arr, (n,))
    nulls = (XF.np_host(val.nulls, label="lambda-eval")
             if val.nulls is not None else np.zeros(n, bool))
    if nulls.ndim == 0:
        nulls = np.broadcast_to(nulls, (n,))
    scale = (val.type.scale
             if isinstance(val.type, T.DecimalType) else None)
    out = []
    for i in range(n):
        if nulls[i]:
            out.append(None)
        elif val.dictionary is not None:
            out.append(val.dictionary.values[
                int(np.clip(arr[i], 0, len(val.dictionary) - 1))])
        else:
            v = arr[i].item()
            if scale is not None:
                # unscaled decimal -> exact Decimal value
                from decimal import Decimal

                v = Decimal(v).scaleb(-scale)
            out.append(v)
    return out


def _run_lambda(lam, columns, param_types) -> list:
    """Evaluate a lambda body over parallel element columns on the host:
    a CPU page of the elements through the port's evaluator (the
    per-distinct-value translation of the reference's per-row lambda
    invocation). Returns the body's results (None = NULL)."""
    from presto_tpu_torch.expr.eval import evaluate

    n = len(columns[0]) if columns else 0
    if n == 0:
        return []
    blocks = tuple(_host_block(c, _infer_elem_type(c, t))
                   for c, t in zip(columns, param_types))
    page = Page(blocks=blocks, valid=torch.ones(n, dtype=torch.bool))
    return _val_to_pylist(evaluate(lam.body, page), n)


def _lam_of(vals: List, i: int):
    from presto_tpu_torch.expr import ir

    if not isinstance(vals[i], ir.Lambda):
        raise TypeError("expected a lambda argument")
    return vals[i]


def _elem_type(col: Val):
    return (col.type.element if isinstance(col.type, T.ArrayType)
            else T.UNKNOWN)


def _impl_transform(ctx: Ctx, rt, vals: List) -> Val:
    col, lam = vals[0], _lam_of(vals, 1)
    elem_t = _elem_type(col)
    return _elem_result_val(
        ctx, col, ("transform", lam),
        lambda v: tuple(_run_lambda(lam, [list(v)], [elem_t])), rt)


def _impl_filter(ctx: Ctx, rt, vals: List) -> Val:
    col, lam = vals[0], _lam_of(vals, 1)
    elem_t = _elem_type(col)

    def one(v):
        v = tuple(v)
        keep = _run_lambda(lam, [list(v)], [elem_t])
        return tuple(x for x, k in zip(v, keep)
                     if k is True or k == 1 and k is not None)

    return _elem_result_val(ctx, col, ("filter", lam), one, rt)


def _match_impl(mode: str):
    def impl(ctx: Ctx, rt, vals: List) -> Val:
        col, lam = vals[0], _lam_of(vals, 1)
        elem_t = _elem_type(col)

        def one(v):
            res = _run_lambda(lam, [list(v)], [elem_t])
            trues = sum(1 for r in res if r)
            has_null = any(r is None for r in res)
            if mode == "any":
                return True if trues else (None if has_null else False)
            if mode == "all":
                return (False if any(r is False or r == 0 and r is not None
                                     for r in res)
                        else (None if has_null else True))
            return False if trues else (None if has_null else True)

        return _elem_result_val(ctx, col, (mode + "_match", lam), one,
                                T.BOOLEAN)

    return impl


def _hof_array_resolve_elem(args):
    if not isinstance(args[0], T.ArrayType):
        raise TypeError(f"expected array, got {args[0]}")
    return T.ArrayType(args[1])


register("transform", _hof_array_resolve_elem, _impl_transform)
register("filter", lambda a: a[0], _impl_filter)
register("any_match", lambda a: T.BOOLEAN, _match_impl("any"))
register("all_match", lambda a: T.BOOLEAN, _match_impl("all"))
register("none_match", lambda a: T.BOOLEAN, _match_impl("none"))


def _map_kv_columns(v):
    v = tuple(tuple(kv) for kv in v)
    return v, [kv[0] for kv in v], [kv[1] for kv in v]


def _impl_transform_values(ctx: Ctx, rt, vals: List) -> Val:
    col, lam = vals[0], _lam_of(vals, 1)
    t = col.type

    def one(v):
        _, ks, vs_ = _map_kv_columns(v)
        if lam.n_params == 1:
            res = _run_lambda(lam, [vs_], [t.value])
        else:
            res = _run_lambda(lam, [ks, vs_], [t.key, t.value])
        return tuple(zip(ks, res))

    return _elem_result_val(ctx, col, ("transform_values", lam), one, rt)


def _impl_transform_keys(ctx: Ctx, rt, vals: List) -> Val:
    col, lam = vals[0], _lam_of(vals, 1)
    t = col.type

    def one(v):
        _, ks, vs_ = _map_kv_columns(v)
        if lam.n_params == 1:
            res = _run_lambda(lam, [ks], [t.key])
        else:
            res = _run_lambda(lam, [ks, vs_], [t.key, t.value])
        return tuple(zip(res, vs_))

    return _elem_result_val(ctx, col, ("transform_keys", lam), one, rt)


def _impl_map_filter(ctx: Ctx, rt, vals: List) -> Val:
    col, lam = vals[0], _lam_of(vals, 1)
    t = col.type

    def one(v):
        v, ks, vs_ = _map_kv_columns(v)
        keep = _run_lambda(lam, [ks, vs_], [t.key, t.value])
        return tuple(kv for kv, k in zip(v, keep) if k)

    return _elem_result_val(ctx, col, ("map_filter", lam), one, rt)


def _map_hof_resolve(kind):
    def resolve(args):
        t = args[0]
        if not isinstance(t, T.MapType):
            raise TypeError(f"expected map, got {t}")
        if kind == "values":
            return T.MapType(t.key, args[1])
        if kind == "keys":
            return T.MapType(args[1], t.value)
        return t

    return resolve


register("transform_values", _map_hof_resolve("values"),
         _impl_transform_values)
register("transform_keys", _map_hof_resolve("keys"),
         _impl_transform_keys)
register("map_filter", _map_hof_resolve("filter"), _impl_map_filter)


def _impl_reduce(ctx: Ctx, rt, vals: List) -> Val:
    """reduce(array, init, (acc, x) -> acc', acc -> out): host fold per
    distinct value (init must be a constant). The result type is
    inferred from the folded values, as in the reference."""
    from presto_tpu_torch.expr import ir

    col = vals[0]
    init = _require_const(vals[1], "reduce initial state")
    combine = _lam_of(vals, 2)
    output = vals[3] if len(vals) > 3 else None
    if not isinstance(output, ir.Lambda):
        output = None
    elem_t = _elem_type(col)
    d = _dict_of(col)

    def one(v):
        acc = init
        for x in tuple(v):
            r = _run_lambda(combine, [[acc], [x]], [None, elem_t])
            acc = r[0] if r else None
        if output is not None:
            r = _run_lambda(output, [[acc]], [None])
            acc = r[0] if r else None
        return acc

    key = ("reduce", type(init), init, combine, output)
    outs = F._dict_cached(d, ("reduce-fold",) + key,
                          lambda: [one(v) for v in d.values])
    res_t = _infer_elem_type(outs, None)
    return _elem_result_val(ctx, col, key,
                            lambda v: outs[d.code_of(v)], res_t)


register("reduce", lambda a: a[-1] if a else T.UNKNOWN, _impl_reduce)
