"""The math, regexp, string and temporal builtins of functions.py:
presto_tpu_torch against presto_tpu.

Every case of tests/test_functions3.py runs through both engines over
TPC-H SF 0.001 (page_rows 2^12): the port's value equals the reference
engine's (doubles to 9 significant digits) and the reference test's
expected value, and the temporal batch's 50 orders rows match the
Python date arithmetic."""

import calendar
import datetime
import math

import pytest
import torch

from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.runner import LocalRunner


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    return LocalRunner({"tpch": TpchConnector(0.001, device="cpu")},
                       session={"page_rows": 1 << 12}, device="cpu")


@pytest.fixture(scope="module")
def reference():
    return RefRunner({"tpch": RefTpch(0.001)}, page_rows=1 << 12)


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=1e-9)
    return a == b and type(a) is type(b)


def both(port, reference, sql):
    got = port.execute(sql).rows
    want = reference.execute(sql).rows
    assert len(got) == len(want), sql
    for g, w in zip(got, want):
        assert all(_same(a, b) for a, b in zip(g, w)), (sql, g, w)
    return got


def one(port, reference, expr, frm="region"):
    return both(port, reference, f"select {expr} from {frm} limit 1")[0][0]


AFRICA = "region where r_regionkey = 0"

CASES = [
    ("log2(8e0)", 3.0, "region"),
    ("log10(1000e0)", 3.0, "region"),
    ("log(3e0, 81e0)", 4.0, "region"),
    ("cbrt(-27e0)", -3.0, "region"),
    ("mod(10, 3)", 1, "region"),
    ("mod(-10, 3)", -1, "region"),
    ("sign(-5)", -1, "region"),
    ("truncate(-1.7e0)", -1.0, "region"),
    ("degrees(pi())", 180.0, "region"),
    ("width_bucket(5e0, 0e0, 10e0, 5)", 3, "region"),
    ("atan2(1e0, 1e0)", math.pi / 4, "region"),
    ("is_nan(nan())", True, "region"),
    ("is_finite(infinity())", False, "region"),
    ("is_infinite(infinity())", True, "region"),
    ("sin(0e0)", 0.0, "region"),
    ("cos(0e0)", 1.0, "region"),
    ("tanh(0e0)", 0.0, "region"),
    ("acos(1e0)", 0.0, "region"),
    ("mod(10, 0)", None, "region"),
    ("nullif(3, 3)", None, "region"),
    ("nullif(3, 4)", 3, "region"),
    ("nullif(r_name, 'AFRICA')", None, AFRICA),
    ("nullif(r_name, 'ASIA')", "AFRICA", AFRICA),
    ("regexp_like(r_name, '^AF')", True, AFRICA),
    ("regexp_like(r_name, 'ZZZ')", False, AFRICA),
    ("regexp_extract(r_name, '([A-Z]+)ICA', 1)", "AFR", AFRICA),
    ("regexp_replace(r_name, 'AFR', 'X')", "XICA", AFRICA),
    ("regexp_extract(r_name, 'ZZZ')", None, AFRICA),
    ("length(r_name)", 6, AFRICA),
    ("reverse(r_name)", "ACIRFA", AFRICA),
    ("strpos(r_name, 'RIC')", 3, AFRICA),
    ("strpos(r_name, 'ZZ')", 0, AFRICA),
    ("replace(r_name, 'AFR', 'AMER')", "AMERICA", AFRICA),
    ("lpad(r_name, 8, '*')", "**AFRICA", AFRICA),
    ("rpad(r_name, 8, '*')", "AFRICA**", AFRICA),
    ("split_part(r_name, 'R', 1)", "AF", AFRICA),
    ("codepoint(r_name)", ord("A"), AFRICA),
    ("to_unixtime(from_unixtime(1456e0))", 1456.0, "region"),
]


@pytest.mark.parametrize("expr,want,frm", CASES)
def test_single_values(port, reference, expr, want, frm):
    got = one(port, reference, expr, frm)
    if isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12), expr
    else:
        assert got == want, expr


def test_date_diff_truncates_toward_zero(port, reference):
    rows = both(port, reference,
                "select date_diff('day', from_unixtime(82800e0), "
                "from_unixtime(90000e0)), "
                "date_diff('hour', from_unixtime(5400e0), "
                "from_unixtime(0e0)) from region limit 1")
    assert rows[0] == (0, -1)


def test_temporal_batch(port, reference):
    rows = both(port, reference,
                "select o_orderdate, date_trunc('month', o_orderdate), "
                "date_trunc('year', o_orderdate), "
                "date_add('day', 31, o_orderdate), "
                "date_add('month', 2, o_orderdate), "
                "date_diff('day', o_orderdate, "
                "date_add('day', 45, o_orderdate)), "
                "date_diff('month', o_orderdate, "
                "date_add('day', 65, o_orderdate)) from orders limit 50")
    epoch = datetime.date(1970, 1, 1)

    def day(v):
        return epoch + datetime.timedelta(days=int(v))

    for (d, tm, ty, plus31, plus2m, diff45, diffm) in rows:
        base = day(d)
        assert day(tm) == base.replace(day=1)
        assert day(ty) == base.replace(month=1, day=1)
        assert day(plus31) == base + datetime.timedelta(days=31)
        m0 = base.month - 1 + 2
        y, m = base.year + m0 // 12, m0 % 12 + 1
        dd = min(base.day, calendar.monthrange(y, m)[1])
        assert day(plus2m) == datetime.date(y, m, dd)
        assert diff45 == 45
        plus65 = base + datetime.timedelta(days=65)
        months = (plus65.year - base.year) * 12 + (
            plus65.month - base.month)
        if plus65.day < base.day:
            months -= 1
        assert diffm == months, (d, diffm, months)


def test_week_trunc_is_monday(port, reference):
    rows = both(port, reference, "select date_trunc('week', o_orderdate) "
                "from orders limit 20")
    epoch = datetime.date(1970, 1, 1)
    for (d,) in rows:
        assert (epoch + datetime.timedelta(days=int(d))).weekday() == 0
