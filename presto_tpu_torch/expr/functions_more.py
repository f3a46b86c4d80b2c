"""Function registry breadth: the remaining reference scalar families.

Port of presto_tpu/expr/functions_more.py (reference: presto-main
operator/scalar/* — RegexpFunctions (the full regexp_* set),
StringFunctions (translate/levenshtein/hamming/soundex),
VarbinaryFunctions (to_utf8/crc32/xxhash64/sha512/hmac_*/big-endian),
BitwiseFunctions (shifts), UrlFunctions (component extractors),
ArrayFunctions (set algebra/zip), MapFunctions (concat/from_entries)).

All string/array/map work rides the dictionary pattern of functions.py
and functions_ext.py: host transforms over the distinct values plus a
code remap on the device. Binary (column, column) string/array ops go
through a bounded pair universe: the cross product of both
dictionaries' values is enumerated on the host when small enough and
refused, with a clear error, when it would explode.

Varbinary values are Python ``bytes`` living in dictionaries; the
hash/codec functions return them as first-class values.
"""

from __future__ import annotations

import re
import zlib
from typing import List, Optional

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.expr.functions import (
    Ctx,
    _dict_int,
    _dict_map,
    _dict_map_nullable,
    register,
)
from presto_tpu_torch.expr.functions_ext import (
    _array_resolve_same,
    _dict_of,
    _elem_result_val,
    _lam_of,
    _require_const,
    _run_lambda,
    _str_resolve,
    _strcol,
    _varchar_results,
)
from presto_tpu_torch.expr.values import Val, union_nulls
from presto_tpu_torch.obs.sanitizer import make_lock
from presto_tpu_torch.page import Dictionary

_PAIR_LIMIT = 1 << 16

# (id(a), id(b)) -> (a, b, the pair universe's placeholder dictionary),
# so the per-dictionary result cache hits for the same two dictionaries
_PAIR_UNIVERSES: dict = {}
_pair_lock = make_lock("expr.functions_more._pair_lock")


def _pair_universe(da: Dictionary, db: Dictionary) -> Dictionary:
    hit = _PAIR_UNIVERSES.get((id(da), id(db)))
    if hit is not None and hit[0] is da and hit[1] is db:
        return hit[2]
    uni = Dictionary(range(len(da) * len(db)))
    with _pair_lock:
        if len(_PAIR_UNIVERSES) >= 1024:
            _PAIR_UNIVERSES.clear()
        _PAIR_UNIVERSES[(id(da), id(db))] = (da, db, uni)
    return uni


def _pair_map(ctx: Ctx, a: Val, b: Val, key: tuple, fn, rt) -> Val:
    """Binary op over two dictionary-coded columns via the bounded
    cross-product universe: result[i] = fn(a_val[i], b_val[i]) computed
    per distinct (a, b) PAIR, with codes pair_code = a*len(db) + b."""
    a, b = _strcol(a), _strcol(b)
    da, db = _dict_of(a), _dict_of(b)
    if len(da) * max(len(db), 1) > _PAIR_LIMIT:
        raise TypeError(
            "dictionary pair universe too large for host evaluation "
            f"({len(da)}x{len(db)}); reduce distinct values or make "
            "one side a constant"
        )
    nb = max(len(db), 1)
    ca = a.data.clamp(0, max(len(da) - 1, 0)).to(torch.int64)
    cb = b.data.clamp(0, max(len(db) - 1, 0)).to(torch.int64)
    pair = Val((ca * nb + cb).to(torch.int32), union_nulls(a.nulls, b.nulls),
               a.type, _pair_universe(da, db))
    return _elem_result_val(
        ctx, pair, key, lambda i: fn(da.values[i // nb], db.values[i % nb]),
        rt)


# ------------------------------------------------------------------ regexp


def _const_pat(vals: List[Val], idx: int = 1) -> str:
    return str(_require_const(vals[idx], "regexp pattern"))


def _impl_regexp_extract_all(ctx: Ctx, rt, vals: List[Val]) -> Val:
    pat = _const_pat(vals)
    rx = re.compile(pat)
    group = int(_require_const(vals[2], "regexp group")) \
        if len(vals) > 2 else 0
    return _elem_result_val(
        ctx, vals[0], ("regexp_extract_all", pat, group),
        lambda v: tuple(m.group(group) for m in rx.finditer(str(v))),
        T.ArrayType(T.VARCHAR))


register("regexp_extract_all", lambda a: T.ArrayType(T.VARCHAR),
         _impl_regexp_extract_all)


def _impl_regexp_split(ctx: Ctx, rt, vals: List[Val]) -> Val:
    pat = _const_pat(vals)
    rx = re.compile(pat)
    return _elem_result_val(ctx, vals[0], ("regexp_split", pat),
                            lambda v: tuple(rx.split(str(v))),
                            T.ArrayType(T.VARCHAR))


register("regexp_split", lambda a: T.ArrayType(T.VARCHAR),
         _impl_regexp_split)


def _impl_regexp_count(ctx: Ctx, rt, vals: List[Val]) -> Val:
    pat = _const_pat(vals)
    rx = re.compile(pat)
    return _dict_int(ctx, _strcol(vals[0]), ("regexp_count", pat),
                     lambda v: sum(1 for _ in rx.finditer(str(v))))


def _impl_regexp_position(ctx: Ctx, rt, vals: List[Val]) -> Val:
    pat = _const_pat(vals)
    rx = re.compile(pat)

    def one(v):
        m = rx.search(str(v))
        return m.start() + 1 if m else -1

    return _dict_int(ctx, _strcol(vals[0]), ("regexp_position", pat), one)


register("regexp_count", lambda a: T.BIGINT, _impl_regexp_count)
register("regexp_position", lambda a: T.BIGINT, _impl_regexp_position)


# ------------------------------------------------------------------ string


def _impl_translate(ctx: Ctx, rt, vals: List[Val]) -> Val:
    src = str(_require_const(vals[1], "translate from"))
    dst = str(_require_const(vals[2], "translate to"))
    tbl = {}
    for i, ch in enumerate(src):
        tbl.setdefault(ord(ch), dst[i] if i < len(dst) else None)
    return _dict_map(
        ctx, _strcol(vals[0]), ("translate", src, dst),
        lambda v: "".join(tbl.get(ord(c), c) for c in str(v)
                          if tbl.get(ord(c), c) is not None),
        T.VARCHAR)


register("translate", lambda a: T.VARCHAR, _impl_translate)


def _soundex(s: str) -> str:
    codes = {**dict.fromkeys("BFPV", "1"), **dict.fromkeys("CGJKQSXZ", "2"),
             **dict.fromkeys("DT", "3"), "L": "4",
             **dict.fromkeys("MN", "5"), "R": "6"}
    s = "".join(c for c in str(s).upper() if c.isalpha())
    if not s:
        return ""
    out, prev = s[0], codes.get(s[0], "")
    for c in s[1:]:
        code = codes.get(c, "")
        if code and code != prev:
            out += code
        if c not in "HW":
            prev = code
    return (out + "000")[:4]


register("soundex", lambda a: T.VARCHAR,
         lambda ctx, rt, vals: _dict_map(ctx, _strcol(vals[0]),
                                         ("soundex",), _soundex, T.VARCHAR))


def _levenshtein(a: str, b: str) -> int:
    a, b = str(a), str(b)
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _impl_levenshtein(ctx: Ctx, rt, vals: List[Val]) -> Val:
    if vals[1].is_const:
        w = str(vals[1].py_value)
        return _dict_int(ctx, _strcol(vals[0]), ("levenshtein", w),
                         lambda v: _levenshtein(str(v), w))
    return _pair_map(ctx, vals[0], vals[1], ("levenshtein",),
                     lambda x, y: _levenshtein(str(x), str(y)), T.BIGINT)


register("levenshtein_distance", lambda a: T.BIGINT, _impl_levenshtein)


def _hamming(a: str, b: str) -> Optional[int]:
    a, b = str(a), str(b)
    if len(a) != len(b):
        return None  # the reference engine raises; masked eval -> NULL
    return sum(1 for x, y in zip(a, b) if x != y)


def _impl_hamming(ctx: Ctx, rt, vals: List[Val]) -> Val:
    if vals[1].is_const:
        w = str(vals[1].py_value)
        return _dict_map_nullable(ctx, _strcol(vals[0]), ("hamming", w),
                                  lambda v: _hamming(str(v), w), T.BIGINT)
    return _pair_map(ctx, vals[0], vals[1], ("hamming",), _hamming,
                     T.BIGINT)


register("hamming_distance", lambda a: T.BIGINT, _impl_hamming)


def _luhn(s: str) -> bool:
    digits = str(s)
    if not digits.isdigit():
        return False
    total = 0
    for i, ch in enumerate(reversed(digits)):
        d = int(ch)
        if i % 2 == 1:
            d *= 2
            if d > 9:
                d -= 9
        total += d
    return total % 10 == 0


register("luhn_check", lambda a: T.BOOLEAN,
         lambda ctx, rt, vals: _dict_map(ctx, _strcol(vals[0]), ("luhn",),
                                         _luhn, T.BOOLEAN))


# --------------------------------------------------------------- varbinary
# varbinary values are Python bytes living in dictionaries


def _as_bytes(v) -> bytes:
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    return str(v).encode("utf-8")


register("to_utf8", lambda a: T.VARBINARY,
         lambda ctx, rt, vals: _elem_result_val(
             ctx, vals[0], ("to_utf8",), _as_bytes, T.VARBINARY))
register("from_utf8", lambda a: T.VARCHAR,
         lambda ctx, rt, vals: _varchar_results(
             ctx, vals[0], ("from_utf8",),
             lambda v: _as_bytes(v).decode("utf-8", "replace")))
register("crc32", lambda a: T.BIGINT,
         lambda ctx, rt, vals: _dict_int(
             ctx, _strcol(vals[0]), ("crc32",),
             lambda v: zlib.crc32(_as_bytes(v)) & 0xFFFFFFFF))


def _xxhash64_bytes(v) -> bytes:
    from presto_tpu_torch.ops.hashing import xxhash64_host

    return (xxhash64_host(_as_bytes(v)) & (2**64 - 1)).to_bytes(8, "big")


register("xxhash64", lambda a: T.VARBINARY,
         lambda ctx, rt, vals: _elem_result_val(
             ctx, vals[0], ("xxhash64",), _xxhash64_bytes, T.VARBINARY))


def _impl_hashfn_bytes(algo):
    import hashlib

    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        return _elem_result_val(
            ctx, vals[0], ("digest", algo),
            lambda v: hashlib.new(algo, _as_bytes(v)).digest(), T.VARBINARY)

    return impl


register("sha512", lambda a: T.VARBINARY, _impl_hashfn_bytes("sha512"))


def _const_value(val: Val, what: str):
    """A constant py_value OR the single entry of a one-entry
    dictionary (a constant that went through a function, e.g.
    to_utf8('key'))."""
    if val.is_const:
        return val.py_value
    if val.dictionary is not None and len(val.dictionary) == 1:
        return val.dictionary.values[0]
    raise TypeError(f"{what} must be a constant")


def _impl_hmac(algo):
    import hashlib  # noqa: F401 - hmac resolves the digest by name
    import hmac as hmac_mod

    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        key = _as_bytes(_const_value(vals[1], "hmac key"))
        return _elem_result_val(
            ctx, vals[0], ("hmac", algo, key),
            lambda v: hmac_mod.new(key, _as_bytes(v), algo).digest(),
            T.VARBINARY)

    return impl


register("hmac_md5", lambda a: T.VARBINARY, _impl_hmac("md5"))
register("hmac_sha1", lambda a: T.VARBINARY, _impl_hmac("sha1"))
register("hmac_sha256", lambda a: T.VARBINARY, _impl_hmac("sha256"))
register("hmac_sha512", lambda a: T.VARBINARY, _impl_hmac("sha512"))

register("from_big_endian_64", lambda a: T.BIGINT,
         lambda ctx, rt, vals: _dict_int(
             ctx, _strcol(vals[0]), ("from_big_endian", 8),
             lambda v: int.from_bytes(_as_bytes(v)[:8], "big", signed=True)))
register("from_big_endian_32", lambda a: T.INTEGER,
         lambda ctx, rt, vals: _dict_int(
             ctx, _strcol(vals[0]), ("from_big_endian", 4),
             lambda v: int.from_bytes(_as_bytes(v)[:4], "big", signed=True)))


# ---------------------------------------------------------------- bitwise


def _impl_shift(kind):
    """Shifts with the reference's overflow semantics. A count outside
    0..63 is undefined behaviour for a CUDA shift, so every shift here
    runs on a count clamped into 0..63 and the out-of-range rows are
    selected after: left and logical right shifts by 64 or more give 0,
    the arithmetic right shift saturates to the sign fill (the clamp to
    63 gives it), and a negative count shifts by 0."""

    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        x = vals[0].data.to(torch.int64)
        n = vals[1].data.to(torch.int64)
        nc = n.clamp(0, 63)
        if kind == "left":
            out = torch.where(n >= 64, 0, x << nc)
        elif kind == "arith":
            out = x >> nc
        else:
            # logical right shift on the u64 bit-view: the arithmetic
            # shift with the nc sign-filled top bits cleared (the mask's
            # own shift stays in 1..63; nc == 0 takes x as it is)
            keep = ~(torch.full_like(x, -1) << (64 - nc).clamp(1, 63))
            out = torch.where(nc == 0, x, (x >> nc) & keep)
            out = torch.where(n >= 64, 0, out)
        return Val(out, union_nulls(vals[0].nulls, vals[1].nulls), T.BIGINT)

    return impl


register("bitwise_left_shift", lambda a: T.BIGINT, _impl_shift("left"),
         propagate_nulls=False)
register("bitwise_right_shift", lambda a: T.BIGINT,
         _impl_shift("logical"), propagate_nulls=False)
register("bitwise_right_shift_arithmetic", lambda a: T.BIGINT,
         _impl_shift("arith"), propagate_nulls=False)
register("bit_length", lambda a: T.BIGINT,
         lambda ctx, rt, vals: _dict_int(
             ctx, _strcol(vals[0]), ("bit_length",),
             lambda v: len(_as_bytes(v)) * 8))


# -------------------------------------------------------------------- url


def _impl_url_part(part):
    from urllib.parse import urlparse

    def one(v):
        try:
            u = urlparse(str(v))
        except Exception:  # noqa: BLE001 - url functions yield NULL
            return None    # on malformed input (reference semantics)
        got = {
            "host": u.hostname, "path": u.path or "",
            "protocol": u.scheme, "query": u.query,
            "fragment": u.fragment,
        }[part]
        return None if got is None else str(got)

    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        return _dict_map_nullable(ctx, _strcol(vals[0]), ("url_parse", part),
                                  one, T.VARCHAR)

    return impl


for _p in ("host", "path", "protocol", "query", "fragment"):
    register(f"url_extract_{_p}", _str_resolve, _impl_url_part(_p))


def _url_port_one(v):
    from urllib.parse import urlparse

    try:
        return urlparse(str(v)).port
    except Exception:  # noqa: BLE001 - url functions yield NULL
        return None    # on malformed input (reference semantics)


register("url_extract_port", lambda a: T.BIGINT,
         lambda ctx, rt, vals: _elem_result_val(
             ctx, vals[0], ("url_parse", "port"), _url_port_one, T.BIGINT))

# url_encode / url_decode already live in functions_ext.py


# ------------------------------------------------------------- array sets


def _impl_array_setop(op):
    def fn(x, y):
        x, y = tuple(x), tuple(y)
        if op == "union":
            return tuple(dict.fromkeys(x + y))
        ys = set(y)
        if op == "intersect":
            return tuple(dict.fromkeys(v for v in x if v in ys))
        return tuple(dict.fromkeys(v for v in x if v not in ys))

    def impl(ctx: Ctx, rt, vals: List[Val]) -> Val:
        return _pair_map(ctx, vals[0], vals[1], ("array_" + op,), fn, rt)

    return impl


register("array_union", _array_resolve_same, _impl_array_setop("union"))
register("array_intersect", _array_resolve_same,
         _impl_array_setop("intersect"))
register("array_except", _array_resolve_same, _impl_array_setop("except"))
register("arrays_overlap", lambda a: T.BOOLEAN,
         lambda ctx, rt, vals: _pair_map(
             ctx, vals[0], vals[1], ("arrays_overlap",),
             lambda x, y: bool(set(x) & set(y)), T.BOOLEAN))


def _zip_type(a):
    return T.ArrayType(T.RowType((
        a[0].element if isinstance(a[0], T.ArrayType) else T.UNKNOWN,
        a[1].element if isinstance(a[1], T.ArrayType) else T.UNKNOWN,
    )))


def _impl_zip(ctx: Ctx, rt, vals: List[Val]) -> Val:
    return _pair_map(
        ctx, vals[0], vals[1], ("zip",),
        lambda x, y: tuple(
            (x[i] if i < len(x) else None, y[i] if i < len(y) else None)
            for i in range(max(len(x), len(y)))),
        _zip_type([vals[0].type, vals[1].type]))


register("zip", _zip_type, _impl_zip)


def _impl_zip_with(ctx: Ctx, rt, vals: List) -> Val:
    a, b, lam = vals[0], vals[1], _lam_of(vals, 2)
    ta = a.type.element if isinstance(a.type, T.ArrayType) else T.UNKNOWN
    tb = b.type.element if isinstance(b.type, T.ArrayType) else T.UNKNOWN

    def fn(x, y):
        x, y = tuple(x), tuple(y)
        n = max(len(x), len(y))
        xs = [x[i] if i < len(x) else None for i in range(n)]
        ys = [y[i] if i < len(y) else None for i in range(n)]
        return tuple(_run_lambda(lam, [xs, ys], [ta, tb]))

    return _pair_map(ctx, a, b, ("zip_with", lam), fn, rt)


register(
    "zip_with",
    # args = (array, array, lambda-body type): the result element type
    # is the lambda's
    lambda a: T.ArrayType(a[2] if len(a) > 2 else T.UNKNOWN),
    _impl_zip_with,
)


# -------------------------------------------------------------------- maps


def _map_concat_one(x, y):
    out = dict(tuple(kv) for kv in x)
    out.update(dict(tuple(kv) for kv in y))
    return tuple(out.items())


register("map_concat",
         lambda a: a[0] if isinstance(a[0], T.MapType) else T.UNKNOWN,
         lambda ctx, rt, vals: _pair_map(ctx, vals[0], vals[1],
                                         ("map_concat",), _map_concat_one,
                                         vals[0].type))


def _impl_map_from_entries(ctx: Ctx, rt, vals: List[Val]) -> Val:
    t = vals[0].type
    elem = t.element if isinstance(t, T.ArrayType) else None
    kt = elem.fields[0] if isinstance(elem, T.RowType) else T.UNKNOWN
    vt = elem.fields[1] if isinstance(elem, T.RowType) else T.UNKNOWN
    return _elem_result_val(
        ctx, vals[0], ("map_from_entries",),
        lambda v: tuple(dict(tuple(kv) for kv in v).items()),
        T.MapType(kt, vt))


register(
    "map_from_entries",
    lambda a: T.MapType(
        a[0].element.fields[0], a[0].element.fields[1]
    ) if (isinstance(a[0], T.ArrayType)
          and isinstance(a[0].element, T.RowType)) else T.UNKNOWN,
    _impl_map_from_entries,
)


def _impl_split_to_map(ctx: Ctx, rt, vals: List[Val]) -> Val:
    entry_d = str(_require_const(vals[1], "entry delimiter"))
    kv_d = str(_require_const(vals[2], "key/value delimiter"))

    def one(v):
        s = str(v)
        if not s:
            return ()
        out = {}
        for part in s.split(entry_d):
            k, _, val = part.partition(kv_d)
            out[k] = val
        return tuple(out.items())

    return _elem_result_val(ctx, vals[0], ("split_to_map", entry_d, kv_d),
                            one, T.MapType(T.VARCHAR, T.VARCHAR))


register("split_to_map", lambda a: T.MapType(T.VARCHAR, T.VARCHAR),
         _impl_split_to_map)
