"""Physical-plan fragment serde for DCN plan SHIPPING.

Port of presto_tpu/dist/plan_serde.py (reference: presto-main
server/TaskUpdateRequest.java carrying a serialized PlanFragment): the
coordinator serializes the physical subtree it wants executed and the
worker executes THAT tree.

Every plan/expression/type object is a frozen dataclass of tuples and
scalars (exec/plan.py, expr/ir.py, types.py, ops/sort.SortKey), so one
tagged-JSON walker covers the whole IR:

    dataclass  -> {"$c": "ClassName", "fieldname": value, ...}
    tuple      -> {"$t": [items...]}
    bytes      -> {"$b": base64}
    Decimal    -> {"$d": str}
    non-finite -> {"$fl": "nan" | "inf" | "-inf"}
    None/bool/int/str/finite float -> JSON natives

The class registry is the port's IR modules' own dataclasses (with
SortKey and the window nodes' WindowFunc); a class
outside it raises on encode and on decode.
"""

from __future__ import annotations

import base64
import dataclasses
import decimal
import json
import math
from typing import Any, Dict

_REG: Dict[str, type] = {}


def _reg() -> Dict[str, type]:
    if not _REG:
        from presto_tpu_torch import types as T
        from presto_tpu_torch.exec import plan as P
        from presto_tpu_torch.expr import ir as E
        from presto_tpu_torch.ops.sort import SortKey
        from presto_tpu_torch.ops.window import WindowFunc

        for mod in (T, P, E):
            for name in dir(mod):
                cls = getattr(mod, name)
                if isinstance(cls, type) and dataclasses.is_dataclass(cls):
                    _REG[name] = cls
        _REG["SortKey"] = SortKey
        _REG["WindowFunc"] = WindowFunc
    return _REG


def to_obj(x: Any) -> Any:
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        name = type(x).__name__
        if _reg().get(name) is not type(x):
            raise TypeError(f"unregistered plan class: {name}")
        out = {"$c": name}
        for f in dataclasses.fields(x):
            if not f.init:  # class-constant (e.g. SqlType.name)
                continue
            out[f.name] = to_obj(getattr(x, f.name))
        return out
    if isinstance(x, tuple):
        return {"$t": [to_obj(v) for v in x]}
    if isinstance(x, bytes):
        return {"$b": base64.b64encode(x).decode()}
    if isinstance(x, decimal.Decimal):
        return {"$d": str(x)}
    if isinstance(x, float) and not math.isfinite(x):
        return {"$fl": "nan" if math.isnan(x)
                else ("inf" if x > 0 else "-inf")}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, list):
        return [to_obj(v) for v in x]
    raise TypeError(f"unserializable plan value: {type(x).__name__}")


def from_obj(x: Any) -> Any:
    if isinstance(x, dict):
        if "$c" in x:
            cls = _reg().get(x["$c"])
            if cls is None:
                raise TypeError(
                    f"unknown plan class {x['$c']!r} (coordinator/"
                    "worker version skew?)")
            return cls(**{k: from_obj(v) for k, v in x.items()
                          if k != "$c"})
        if "$t" in x:
            return tuple(from_obj(v) for v in x["$t"])
        if "$b" in x:
            return base64.b64decode(x["$b"])
        if "$d" in x:
            return decimal.Decimal(x["$d"])
        if "$fl" in x:
            return float(x["$fl"])
        raise TypeError(f"unrecognized tagged object: {list(x)[:4]}")
    if isinstance(x, list):
        return [from_obj(v) for v in x]
    return x


def dumps(node: Any) -> str:
    return json.dumps(to_obj(node), separators=(",", ":"))


def loads(s: str) -> Any:
    return from_obj(json.loads(s))
