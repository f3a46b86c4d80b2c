"""The presto_tpu_torch expression evaluator against presto_tpu's, run with
``xp=numpy``: the slice's expressions (Q1/Q3/Q5/Q6 arithmetic, decimal
multiply and cast, date literals and interval arithmetic, comparisons,
BETWEEN, string equality over dictionary codes, three-valued AND/OR,
IF/COALESCE/IN/IS NULL) over the same seeded page. Exact: integers,
decimals and dates bit for bit, doubles to 9 significant digits."""

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
from presto_tpu_torch.expr import ir as IR


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once, and torch's default of one thread per core spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 256
FLAGS = ["A", "N", "R"]


def _columns():
    rng = np.random.default_rng(20261016)
    cols = [
        rng.integers(100, 5001, N).astype(np.int64),        # quantity
        rng.integers(90000, 10**7, N).astype(np.int64),     # price
        rng.integers(0, 11, N).astype(np.int64),            # discount
        rng.integers(8000, 10600, N).astype(np.int32),      # shipdate
        rng.integers(0, 3, N).astype(np.int32),             # flag codes
        rng.integers(-20, 20, N).astype(np.int64),          # bigint
        rng.integers(-3, 4, N).astype(np.int32),            # integer
        rng.normal(size=N) * 1e3,                           # double
    ]
    nulls = [None] * len(cols)
    nulls[5] = rng.random(N) < 0.2
    nulls[6] = rng.random(N) < 0.2
    nulls[7] = rng.random(N) < 0.1
    return cols, nulls


TYPES = ["decimal(12,2)", "decimal(12,2)", "decimal(12,2)", "date",
         "varchar(1)", "bigint", "integer", "double"]


def _ref_page():
    cols, nulls = _columns()
    blocks = tuple(
        RBlock(data=c, type=RT.parse_type(t), nulls=n,
               dictionary=RDictionary(FLAGS) if i == 4 else None)
        for i, (c, n, t) in enumerate(zip(cols, nulls, TYPES)))
    valid = np.random.default_rng(3).random(N) < 0.9
    return RPage(blocks=blocks, valid=valid)


def _exprs(ir, T):
    """The same expression trees, built from either package's IR."""
    dec = T.DecimalType(12, 2)
    q, p, d = (ir.InputRef(i, dec) for i in range(3))
    ship = ir.InputRef(3, T.DATE)
    flag = ir.InputRef(4, T.VarcharType(1))
    b, i32 = ir.InputRef(5, T.BIGINT), ir.InputRef(6, T.INTEGER)
    dbl = ir.InputRef(7, T.DOUBLE)
    one = ir.Constant(1, T.BIGINT)
    d94 = ir.Constant(8766, T.DATE)
    disc_price = ir.call("multiply", p, ir.call("subtract", one, d))
    return {
        "q1_disc_price": disc_price,
        "q1_charge": ir.call("multiply", disc_price,
                             ir.call("add", one, d)),
        "q1_date_minus_days": ir.call("le", ship, ir.call(
            "subtract", ir.Constant(10561, T.DATE),
            ir.Constant(90 * 86_400_000_000, T.INTERVAL_DAY_TIME))),
        "q6_predicate": ir.and_(
            ir.call("ge", ship, d94),
            ir.call("lt", ship, ir.call(
                "add", d94, ir.Constant(12, T.INTERVAL_YEAR_MONTH))),
            ir.SpecialForm(ir.BETWEEN, (
                d,
                ir.call("subtract", ir.Constant(6, T.DecimalType(2, 2)),
                        ir.Constant(1, T.DecimalType(2, 2))),
                ir.call("add", ir.Constant(6, T.DecimalType(2, 2)),
                        ir.Constant(1, T.DecimalType(2, 2))),
            ), T.BOOLEAN),
            ir.call("lt", q, ir.Constant(24, T.BIGINT))),
        "q6_revenue_term": ir.call("multiply", p, d),
        "date_plus_months_end_clamp": ir.call(
            "add", ship, ir.Constant(13, T.INTERVAL_YEAR_MONTH)),
        "string_eq": ir.call("eq", flag, ir.Constant("R", T.VARCHAR)),
        "string_ne_absent": ir.call("ne", flag, ir.Constant("Q", T.VARCHAR)),
        "string_lt": ir.call("lt", flag, ir.Constant("N", T.VARCHAR)),
        "and_or_3vl": ir.SpecialForm(ir.OR, (
            ir.call("gt", b, ir.Constant(3, T.BIGINT)),
            ir.and_(ir.call("lt", i32, ir.Constant(0, T.INTEGER)),
                    ir.call("ne", b, ir.Constant(0, T.BIGINT)))),
            T.BOOLEAN),
        "int_divide_by_zero": ir.call("divide", b, i32),
        "int_modulus": ir.call("modulus", b, i32),
        "decimal_divide": ir.call("divide", p, q),
        "negate": ir.call("negate", b),
        "cast_bigint_double": ir.Call("cast", (b,), T.DOUBLE),
        "cast_decimal_bigint": ir.Call("cast", (p,), T.BIGINT),
        "cast_double_decimal": ir.Call("cast", (dbl,), T.DecimalType(12, 2)),
        "double_arith": ir.call("add", ir.call("multiply", dbl, dbl), b),
        "if_else": ir.SpecialForm(ir.IF, (
            ir.call("gt", b, ir.Constant(0, T.BIGINT)), q, p), dec),
        "coalesce": ir.SpecialForm(ir.COALESCE, (b, i32, one), T.BIGINT),
        "is_null": ir.SpecialForm(ir.IS_NULL, (b,), T.BOOLEAN),
        "in_list": ir.SpecialForm(ir.IN, (
            i32, ir.Constant(1, T.INTEGER), ir.Constant(-2, T.INTEGER)),
            T.BOOLEAN),
    }


NAMES = sorted(_exprs(RIR, RT))


def _nulls(v, n):
    if v.nulls is None:
        return np.zeros(n, bool)
    return np.broadcast_to(np.asarray(v.nulls.numpy() if hasattr(
        v.nulls, "numpy") else v.nulls), (n,))


@pytest.mark.parametrize("name", NAMES)
def test_expression_matches_reference(name):
    ref_page = _ref_page()
    port_page = interop.page_from_numpy(**interop.page_arrays(ref_page))
    want = REV.evaluate(_exprs(RIR, RT)[name], ref_page, np)
    got = EV.evaluate(_exprs(IR, T)[name], port_page)
    assert str(got.type) == str(want.type)
    wn, gn = _nulls(want, N), _nulls(got, N)
    np.testing.assert_array_equal(gn, wn)
    wd = np.broadcast_to(np.asarray(want.data), (N,))
    gd = np.broadcast_to(got.data.numpy(), (N,))
    assert gd.dtype == wd.dtype
    keep = ~wn
    if np.issubdtype(wd.dtype, np.floating):
        np.testing.assert_allclose(gd[keep], wd[keep], rtol=1e-9)
    else:
        np.testing.assert_array_equal(gd[keep], wd[keep])


@pytest.mark.parametrize("name", [n for n in NAMES if n in (
    "q1_date_minus_days", "q6_predicate", "string_eq", "and_or_3vl",
    "in_list")])
def test_filter_matches_reference(name):
    ref_page = _ref_page()
    port_page = interop.page_from_numpy(**interop.page_arrays(ref_page))
    want = REV.evaluate_filter(_exprs(RIR, RT)[name], ref_page, np)
    got = EV.evaluate_filter(_exprs(IR, T)[name], port_page)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_unported_function_names_the_slice():
    """The last slice of the registry (functions_ext, functions_more) is
    ported: json_extract resolves, and a name neither engine knows
    raises the reference's KeyError."""
    call = IR.call("json_extract", IR.Constant("a", T.VARCHAR),
                   IR.Constant("b", T.VARCHAR))
    assert call.type == T.VARCHAR
    with pytest.raises(KeyError, match="unknown function: no_such_fn"):
        IR.call("no_such_fn", IR.Constant("a", T.VARCHAR))
