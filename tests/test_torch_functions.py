"""The scalar function registry of presto_tpu_torch against presto_tpu's,
run with ``xp=numpy`` over one seeded page: abs, the date parts on DATE
and TIMESTAMP (year and leap boundaries, dates before 1970, negative
microseconds), the dictionary string and regexp functions (LIKE with %,
_ and an escape; substr with negative and zero starts), the math
functions (round at +-x.5, mod with negative operands), nullif and the
temporal functions. Integers, decimals, dates and strings exact; doubles
to 9 significant digits."""

import datetime

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.expr import eval as REV
from presto_tpu.expr import ir as RIR
from presto_tpu.page import Block as RBlock
from presto_tpu.page import Dictionary as RDictionary
from presto_tpu.page import Page as RPage
from presto_tpu_torch import interop
from presto_tpu_torch import types as T
from presto_tpu_torch.expr import eval as EV
from presto_tpu_torch.expr import functions as F
from presto_tpu_torch.expr import ir as IR

N = 512
_US_DAY = 86_400_000_000

STRINGS = ["", "a", "abc", " padded  ", "a_c", "a%c", "50% off", "x\\y",
           "Hello World", "special requests here", "green almond",
           "ab ab", "forest green", "ZZ top", "under_score_", "tail end"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test files at once, one per worker process:
    one intra-op thread per process keeps the port's CPU runs from
    oversubscribing the cores (measured: 10-40x slower with 6 workers at
    the default thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


# year, leap-day and pre-1970 boundaries
DATES = [_days(y, m, d) for (y, m, d) in [
    (1900, 1, 1), (1900, 2, 28), (1900, 3, 1), (1969, 12, 31),
    (1970, 1, 1), (1972, 2, 29), (1999, 12, 31), (2000, 1, 1),
    (2000, 2, 29), (2000, 12, 31), (2004, 1, 4), (2020, 12, 31),
    (2021, 1, 3), (2100, 1, 1), (1904, 12, 30), (1953, 6, 15)]]


def _columns():
    rng = np.random.default_rng(20261017)
    dates = np.where(rng.random(N) < 0.5,
                     rng.choice(DATES, N),
                     rng.integers(-25567, 47482, N)).astype(np.int32)
    dates2 = (dates + rng.integers(-800, 800, N)).astype(np.int32)
    ts = (dates.astype(np.int64) * _US_DAY
          + rng.integers(-_US_DAY, _US_DAY, N))
    ts2 = ts + rng.integers(-40 * _US_DAY, 40 * _US_DAY, N)
    halves = rng.integers(-40, 40, N) + 0.5
    dbl = np.where(rng.random(N) < 0.4, halves, rng.normal(size=N) * 50)
    dbl[:4] = [0.0, -0.0, 2.5, -2.5]
    cols = [
        rng.integers(0, len(STRINGS), N).astype(np.int32),  # 0 varchar
        dates,                                             # 1 date
        dates2,                                            # 2 date
        ts,                                                # 3 timestamp
        ts2,                                               # 4 timestamp
        dbl,                                               # 5 double
        rng.integers(-30, 30, N).astype(np.int64),         # 6 bigint
        rng.integers(-4, 5, N).astype(np.int32),           # 7 integer
        rng.integers(-10**6, 10**6, N).astype(np.int64)
        // 50 * 50 + rng.choice([0, 50, -50], N),         # 8 decimal .x5
    ]
    nulls = [None] * len(cols)
    nulls[0] = rng.random(N) < 0.1
    nulls[6] = rng.random(N) < 0.1
    return cols, nulls


TYPES = ["varchar", "date", "date", "timestamp", "timestamp", "double",
         "bigint", "integer", "decimal(12,2)"]


def _ref_page():
    cols, nulls = _columns()
    blocks = tuple(
        RBlock(data=c, type=RT.parse_type(t), nulls=n,
               dictionary=RDictionary(STRINGS) if i == 0 else None)
        for i, (c, n, t) in enumerate(zip(cols, nulls, TYPES)))
    return RPage(blocks=blocks, valid=np.ones(N, bool))


def _exprs(ir, T):
    """The same expression trees, built from either package's IR."""
    s = ir.InputRef(0, T.VARCHAR)
    d, d2 = ir.InputRef(1, T.DATE), ir.InputRef(2, T.DATE)
    ts, ts2 = ir.InputRef(3, T.TIMESTAMP), ir.InputRef(4, T.TIMESTAMP)
    x = ir.InputRef(5, T.DOUBLE)
    b, i = ir.InputRef(6, T.BIGINT), ir.InputRef(7, T.INTEGER)
    dec = ir.InputRef(8, T.DecimalType(12, 2))

    def v(text):
        return ir.Constant(text, T.VARCHAR)

    def n(k):
        return ir.Constant(k, T.BIGINT)

    def f(k):
        return ir.Constant(k, T.DOUBLE)

    c = ir.call
    out = {
        "abs_bigint": c("abs", b), "abs_double": c("abs", x),
        "abs_decimal": c("abs", dec),
    }
    for part in ("year", "month", "day", "quarter", "week", "day_of_week",
                 "day_of_year"):
        out[f"{part}_date"] = c(part, d)
        out[f"{part}_ts"] = c(part, ts)
    for name, pat in [("pct", "%a%"), ("under", "a_c"), ("prefix", "a%"),
                      ("suffix", "%end"), ("exact", "abc"), ("empty", ""),
                      ("all", "%"), ("two", "__"),
                      ("q13", "%special%requests%")]:
        out[f"like_{name}"] = c("like", s, v(pat))
    out["like_escape_under"] = c("like", s, v("%\\_%"), v("\\"))
    out["like_escape_pct"] = c("like", s, v("%\\%%"), v("\\"))
    out["like_escape_other"] = c("like", s, v("%!%%"), v("!"))
    for name, args in [("2", (2,)), ("neg3", (-3,)), ("zero", (0,)),
                       ("2_3", (2, 3)), ("neg4_2", (-4, 2)),
                       ("1_0", (1, 0)), ("big", (40,)), ("neg_big", (-40,))]:
        out[f"substr_{name}"] = c("substr", s, *(n(a) for a in args))
    out["substring"] = c("substring", s, n(1), n(2))
    for fn in ("lower", "upper", "trim", "ltrim", "rtrim", "reverse",
               "length", "codepoint"):
        out[fn] = c(fn, s)
    out.update({
        "strpos": c("strpos", s, v("a")),
        "position": c("position", s, v("en")),
        "replace3": c("replace", s, v("a"), v("xy")),
        "replace2": c("replace", s, v(" ")),
        "lpad": c("lpad", s, n(5), v("*")),
        "rpad": c("rpad", s, n(6), v("ab")),
        "split_part": c("split_part", s, v(" "), n(2)),
        "concat_after": c("concat", s, v("-x")),
        "concat_before": c("concat", v("p-"), s),
        "regexp_like": c("regexp_like", s, v("^[a-c]+$")),
        "regexp_extract": c("regexp_extract", s,
                            v("([a-z]+) ([a-z]+)"), n(2)),
        "regexp_extract0": c("regexp_extract", s, v("e.")),
        "regexp_replace": c("regexp_replace", s, v("(a)(b)?"), v("$1X")),
        "round_double": c("round", x),
        "round_double_1": c("round", x, n(1)),
        "round_double_neg1": c("round", x, n(-1)),
        "round_decimal": c("round", dec),
        "round_decimal_1": c("round", dec, n(1)),
        "round_bigint": c("round", b),
        "floor_double": c("floor", x), "ceil_double": c("ceil", x),
        "floor_decimal": c("floor", dec),
        "ceiling_decimal": c("ceiling", dec),
        "power": c("power", x, i), "pow_half": c("pow", b, f(0.5)),
        "greatest": c("greatest", b, i), "least": c("least", x, b),
        "atan2": c("atan2", x, b), "log": c("log", b, x),
        "mod_int": c("mod", b, i), "mod_double": c("mod", x, b),
        "mod_decimal": c("mod", dec, ir.Constant(700, T.DecimalType(5, 2))),
        "sign_bigint": c("sign", b), "sign_double": c("sign", x),
        "pi": c("pi"), "e": c("e"), "infinity": c("infinity"),
        "nan": c("nan"),
        "is_nan": c("is_nan", c("sqrt", x)),
        "is_finite": c("is_finite", c("ln", x)),
        "is_infinite": c("is_infinite", c("exp", x)),
        "width_bucket": c("width_bucket", x, f(-100.0), f(100.0), n(10)),
        "nullif_int": c("nullif", b, n(3)),
        "nullif_str": c("nullif", s, v("abc")),
        "from_unixtime": c("from_unixtime", x),
        "to_unixtime": c("to_unixtime", ts),
    })
    for fn in ("sqrt", "ln", "exp", "log2", "log10", "cbrt", "sin", "cos",
               "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
               "degrees", "radians", "truncate"):
        arg = c("divide", x, f(40.0)) if fn in ("asin", "acos") else x
        out[f"dbl_{fn}"] = c(fn, arg)
    for unit in ("day", "week", "month", "quarter", "year"):
        out[f"date_trunc_{unit}"] = c("date_trunc", v(unit), d)
        out[f"date_trunc_{unit}_ts"] = c("date_trunc", v(unit), ts)
        out[f"date_diff_{unit}"] = c("date_diff", v(unit), d, d2)
        out[f"date_diff_{unit}_ts"] = c("date_diff", v(unit), ts, ts2)
    for unit in ("hour", "minute", "second", "millisecond"):
        out[f"date_trunc_{unit}_ts"] = c("date_trunc", v(unit), ts)
        out[f"date_trunc_{unit}_date"] = c("date_trunc", v(unit), d)
        out[f"date_diff_{unit}_ts"] = c("date_diff", v(unit), ts, ts2)
        out[f"date_add_{unit}_ts"] = c("date_add", v(unit), b, ts)
        out[f"ts_part_{unit}"] = c(unit, ts)
    for unit in ("day", "week", "month", "quarter", "year"):
        out[f"date_add_{unit}"] = c("date_add", v(unit), i, d)
        out[f"date_add_{unit}_ts"] = c("date_add", v(unit), b, ts)
    return out


NAMES = sorted(_exprs(RIR, RT))


def _host(a):
    return np.asarray(a.numpy() if hasattr(a, "numpy") else a)


def _nulls(val):
    if val.nulls is None:
        return np.zeros(N, bool)
    return np.broadcast_to(_host(val.nulls), (N,))


def _values(val):
    data = np.broadcast_to(_host(val.data), (N,))
    if val.dictionary is not None:
        vals = np.asarray(list(val.dictionary.values), dtype=object)
        return vals[np.clip(data, 0, len(vals) - 1)]
    return data


@pytest.mark.parametrize("name", NAMES)
def test_function_matches_reference(name):
    ref_page = _ref_page()
    port_page = interop.page_from_numpy(**interop.page_arrays(ref_page))
    with np.errstate(all="ignore"):
        want = REV.evaluate(_exprs(RIR, RT)[name], ref_page, np)
    got = EV.evaluate(_exprs(IR, T)[name], port_page)
    assert str(got.type) == str(want.type)
    wn, gn = _nulls(want), _nulls(got)
    np.testing.assert_array_equal(gn, wn)
    wd, gd = _values(want), _values(got)
    keep = ~wn
    if wd.dtype == object:
        assert list(gd[keep]) == list(wd[keep])
        return
    assert gd.dtype == wd.dtype
    if np.issubdtype(wd.dtype, np.floating):
        np.testing.assert_allclose(gd[keep], wd[keep], rtol=1e-9)
    else:
        np.testing.assert_array_equal(gd[keep], wd[keep])


def test_round_is_half_away_from_zero():
    page = interop.page_from_numpy(
        columns=[np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])],
        valid=np.ones(6, bool), nulls=[None], dictionaries=[None],
        types=["double"])
    got = EV.evaluate(IR.call("round", IR.InputRef(0, T.DOUBLE)), page)
    assert got.data.tolist() == [1.0, 2.0, 3.0, -1.0, -2.0, -3.0]


def test_dictionary_work_runs_once_per_dictionary_and_pattern():
    """A (dictionary, pattern) pair is evaluated on the host once, however
    many pages reach it."""
    page = interop.page_from_numpy(**interop.page_arrays(_ref_page()))
    expr = IR.call("like", IR.InputRef(0, T.VARCHAR),
                   IR.Constant("%once%", T.VARCHAR))
    EV.evaluate(expr, page)
    dic = page.block(0).dictionary
    calls = []
    orig = F._dict_cached

    def spy(d, key, build):
        calls.append(key)
        return orig(d, key, lambda: pytest.fail("rebuilt"))

    F._dict_cached = spy
    try:
        for _ in range(3):
            EV.evaluate(expr, page)
    finally:
        F._dict_cached = orig
    assert calls == [("pred", "like", "%once%", None)] * 3
    assert page.block(0).dictionary is dic
