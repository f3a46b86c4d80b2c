"""Expression evaluator: lower a RowExpression tree over a Page.

Port of presto_tpu/expr/eval.py onto torch tensors. Null semantics follow
the reference engine: scalar functions propagate NULL; AND/OR use SQL
three-valued logic; IF/CASE treat NULL conditions as false; COALESCE
picks the first non-null. Short-circuit evaluation becomes eager
evaluate-both + select, as in presto_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.expr import functions as F
from presto_tpu_torch.expr import ir
from presto_tpu_torch.expr.values import Val, broadcast_val, cast_data
from presto_tpu_torch.ops import consts
from presto_tpu_torch.page import Dictionary, Page


def _const_val(ctx: F.Ctx, node: ir.Constant) -> Val:
    t = node.type
    dev = ctx.device
    if node.value is None:
        return Val(
            torch.zeros((), dtype=t.device_dtype, device=dev),
            torch.ones(ctx.capacity, dtype=torch.bool, device=dev),
            t,
            py_value=None,
        )
    if T.is_string(t):
        # dictionary code resolution happens at the consuming function
        # (comparison), where the column dictionary is known
        return Val(torch.zeros((), dtype=torch.int32, device=dev), None, t,
                   py_value=node.value)
    if t.is_dictionary_encoded:
        # complex constants (array/map/row literals): a one-entry
        # dictionary makes the value first-class, as the reference does
        return Val(torch.zeros((), dtype=torch.int32, device=dev), None, t,
                   Dictionary([node.value]), py_value=node.value)
    return Val(torch.full((), node.value, dtype=t.device_dtype, device=dev),
               None, t, py_value=node.value)


def evaluate(node: ir.RowExpression, page: Page) -> Val:
    """Evaluate an expression over every position of a page (the
    selection mask does not gate evaluation — masked lanes compute
    garbage safely and are dropped downstream)."""
    ctx = F.Ctx(device=page.device, capacity=page.capacity)
    return _eval(ctx, node, page)


def _eval(ctx: F.Ctx, node: ir.RowExpression, page: Page) -> Val:
    if isinstance(node, ir.InputRef):
        blk = page.block(node.channel)
        return Val(blk.data, blk.nulls, blk.type, blk.dictionary)
    if isinstance(node, ir.ParamRef):
        # lambda parameter over the element page a higher-order
        # function builds per distinct collection value
        blk = page.block(node.index)
        return Val(blk.data, blk.nulls, blk.type, blk.dictionary)
    if isinstance(node, ir.Constant):
        return _const_val(ctx, node)
    if isinstance(node, ir.Call):
        # lambda arguments pass through unevaluated; the higher-order
        # function's implementation evaluates the body itself
        vals = [a if isinstance(a, ir.Lambda) else _eval(ctx, a, page)
                for a in node.args]
        return F.eval_call(ctx, node.name, node.type, vals)
    if isinstance(node, ir.SpecialForm):
        return _eval_special(ctx, node, page)
    raise TypeError(
        f"expression node not ported to presto_tpu_torch: {node!r}"
    )


def _zeros_bool(ctx: F.Ctx) -> torch.Tensor:
    return torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)


def _as_bool3(ctx: F.Ctx, val: Val):
    """(value, is_null) pair for three-valued logic."""
    v = broadcast_val(val, ctx.capacity)
    data = v.data.to(torch.bool)
    if v.nulls is None:
        return data, _zeros_bool(ctx)
    return data & ~v.nulls, v.nulls


def _unify_string_vals(ctx: F.Ctx, vals):
    """Remap string-typed branch Vals onto ONE merged dictionary, so the
    codes IF/SWITCH/COALESCE select decode through one universe."""
    dicts = [v.dictionary for v in vals]
    nondict_consts = [
        v for v in vals
        if v.dictionary is None and v.is_const and v.py_value is not None
    ]
    if not any(d is not None for d in dicts) and not nondict_consts:
        return vals  # all NULL literals: nothing to decode
    if (
        len({d for d in dicts if d is not None}) == 1
        and not nondict_consts
        and all(d is not None for d in dicts)
    ):
        return vals  # one shared dictionary already
    universe: dict = {}
    for v in vals:
        if v.dictionary is not None:
            for x in v.dictionary.values:
                universe.setdefault(x, len(universe))
        elif v.is_const and v.py_value is not None:
            universe.setdefault(v.py_value, len(universe))
    merged = Dictionary(list(universe))
    out = []
    for v in vals:
        if v.dictionary is not None and len(v.dictionary):
            lut = np.array([universe[x] for x in v.dictionary.values],
                           np.int32)
            codes = v.data.clamp(0, len(v.dictionary) - 1).to(torch.int64)
            data = consts.lut(lut, ctx.device)[codes]
        elif v.is_const and v.py_value is not None:
            data = torch.full((ctx.capacity,), universe[v.py_value],
                              dtype=torch.int32, device=ctx.device)
        else:  # NULL literal or empty dictionary: codes are never read
            data = torch.zeros(ctx.capacity, dtype=torch.int32,
                               device=ctx.device)
        out.append(Val(data, v.nulls, v.type, merged, v.py_value))
    return out


def _nulls_of(ctx: F.Ctx, v: Val) -> torch.Tensor:
    return v.nulls if v.nulls is not None else _zeros_bool(ctx)


def _eval_special(ctx: F.Ctx, node: ir.SpecialForm, page: Page) -> Val:
    form = node.form

    if form == ir.AND:
        # SQL 3VL: FALSE dominates NULL
        acc = any_false = any_null = None
        for a in node.args:
            v, n = _as_bool3(ctx, _eval(ctx, a, page))
            acc = v if acc is None else (acc & v)
            f = ~v & ~n
            any_false = f if any_false is None else (any_false | f)
            any_null = n if any_null is None else (any_null | n)
        out_null = any_null & ~any_false
        return Val(acc & ~out_null, out_null, T.BOOLEAN)

    if form == ir.OR:
        # TRUE dominates NULL
        acc = any_null = None
        for a in node.args:
            v, n = _as_bool3(ctx, _eval(ctx, a, page))
            acc = v if acc is None else (acc | v)
            any_null = n if any_null is None else (any_null | n)
        out_null = any_null & ~acc
        return Val(acc & ~out_null, out_null, T.BOOLEAN)

    if form == ir.IS_NULL:
        v = broadcast_val(_eval(ctx, node.args[0], page), ctx.capacity)
        return Val(_nulls_of(ctx, v), None, T.BOOLEAN)

    if form == ir.IF:
        cond, _ = _as_bool3(ctx, _eval(ctx, node.args[0], page))
        t = _coerced(ctx, node.args[1], page, node.type)
        f = _coerced(ctx, node.args[2], page, node.type)
        if T.is_string(node.type):
            t, f = _unify_string_vals(ctx, [t, f])
        data = _select(cond, t.data, f.data)
        nulls = torch.where(cond, _nulls_of(ctx, t), _nulls_of(ctx, f))
        return Val(data, nulls, node.type, t.dictionary or f.dictionary)

    if form == ir.COALESCE:
        branches = [_coerced(ctx, a, page, node.type) for a in node.args]
        if T.is_string(node.type):
            branches = _unify_string_vals(ctx, branches)
        data = nulls = dic = None
        for v in branches:
            vn = _nulls_of(ctx, v)
            if data is None:
                data, nulls, dic = v.data, vn, v.dictionary
            else:
                take_new = nulls & ~vn
                data = _select(take_new, v.data, data)
                nulls = nulls & vn
                dic = dic or v.dictionary
        return Val(data, nulls, node.type, dic)

    if form == ir.BETWEEN:
        v, lo, hi = node.args
        expanded = ir.and_(
            ir.Call("ge", (v, lo), T.BOOLEAN),
            ir.Call("le", (v, hi), T.BOOLEAN),
        )
        return _eval_special(ctx, expanded, page)

    if form == ir.IN:
        value = node.args[0]
        clauses = tuple(
            ir.Call("eq", (value, c), T.BOOLEAN) for c in node.args[1:]
        )
        return _eval_special(
            ctx, ir.SpecialForm(ir.OR, clauses, T.BOOLEAN), page
        )

    if form == ir.SWITCH:
        *pairs, default = node.args
        whens = pairs[0::2]
        thens = pairs[1::2]
        out = _coerced(ctx, default, page, node.type)
        branch_vals = [_coerced(ctx, t_, page, node.type) for t_ in thens]
        if T.is_string(node.type):
            unified = _unify_string_vals(ctx, [out] + branch_vals)
            out, branch_vals = unified[0], unified[1:]
        data = out.data
        nulls = _nulls_of(ctx, out)
        dic = out.dictionary
        # later WHENs must not override earlier ones: fold right-to-left
        for when, t in reversed(list(zip(whens, branch_vals))):
            c, _ = _as_bool3(ctx, _eval(ctx, when, page))
            data = _select(c, t.data, data)
            nulls = torch.where(c, _nulls_of(ctx, t), nulls)
            dic = t.dictionary or dic
        return Val(data, nulls, node.type, dic)

    raise TypeError(f"special form not ported to presto_tpu_torch: {form}")


def _select(cond, a, b):
    if isinstance(a, tuple):
        return tuple(torch.where(cond, x, y) for x, y in zip(a, b))
    return torch.where(cond, a, b)


def _coerced(ctx: F.Ctx, node: ir.RowExpression, page: Page,
             to: T.SqlType) -> Val:
    v = broadcast_val(_eval(ctx, node, page), ctx.capacity)
    if v.type == to or T.is_string(to):
        return v
    data, nulls = cast_data(v, to, ctx.capacity)
    return Val(data, nulls, to, v.dictionary)


def evaluate_filter(node: ir.RowExpression, page: Page) -> Page:
    """FilterNode semantics: keep rows where the predicate is TRUE (NULL
    and FALSE both drop — reference: FilterAndProjectOperator)."""
    ctx = F.Ctx(device=page.device, capacity=page.capacity)
    cond, nulls = _as_bool3(ctx, _eval(ctx, node, page))
    return page.with_valid(page.valid & cond & ~nulls)
