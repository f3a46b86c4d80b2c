"""Plugin SPI: connectors, scalar and aggregate functions, types, event
listeners and access control.

Port of presto_tpu/plugin.py. Reference: presto-spi spi/Plugin.java — a
plugin contributes ConnectorFactories, functions (@ScalarFunction and
@AggregationFunction classes), types, event listeners and a system
access control; presto-main's PluginManager installs them into the
engine registries at startup. Here a Plugin contributes Connector
instances, EventListeners, scalar functions that register into the
expression registry (expr/functions.py; from there they resolve,
type-check and evaluate like builtins), aggregates that register into
exec/agg_states.py, named types (types.register_type) and at most one
AccessControl (security.py), which only an engine entry point can
enforce: LocalRunner(plugins=...) and PrestoTpuServer(plugins=...).

UDF authoring surface: ``scalar_function`` wraps an elementwise tensor
function ``fn(torch, *data_tensors) -> data_tensor`` (the reference's
takes ``jax.numpy``; the first argument is the array namespace in both)
with a fixed signature; the evaluator applies generic NULL propagation
like any default-null-convention scalar.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.base import Connector
from presto_tpu_torch.events import EventListener
from presto_tpu_torch.exec import agg_states as AS
from presto_tpu_torch.expr import functions as F
from presto_tpu_torch.expr.values import Val, cast_data


@dataclasses.dataclass(frozen=True)
class ScalarFunctionSpec:
    """One UDF: fixed argument types, result type, elementwise impl
    ``fn(torch, *data_tensors) -> data_tensor`` (reference: one
    @ScalarFunction method signature)."""

    name: str
    arg_types: Sequence[T.SqlType]
    result_type: T.SqlType
    fn: Callable
    propagate_nulls: bool = True


def scalar_function(
    name: str,
    arg_types: Sequence[T.SqlType],
    result_type: T.SqlType,
    propagate_nulls: bool = True,
):
    """Decorator form:

        @scalar_function("clamp01", [T.DOUBLE], T.DOUBLE)
        def clamp01(xp, x):
            return xp.clamp(x, 0.0, 1.0)
    """

    def deco(fn):
        spec = ScalarFunctionSpec(
            name, tuple(arg_types), result_type, fn, propagate_nulls)
        fn.__presto_tpu_spec__ = spec
        return fn

    return deco


class Plugin:
    """Reference: spi/Plugin.java. Override any subset."""

    name: str = "plugin"

    def connectors(self) -> Dict[str, Connector]:
        """catalog name -> Connector instance (reference:
        getConnectorFactories; these are instances, config-free)."""
        return {}

    def scalar_functions(self) -> List[ScalarFunctionSpec]:
        """UDFs to install (reference: getFunctions): ScalarFunctionSpec
        entries or functions decorated with @scalar_function."""
        return []

    def aggregate_functions(self):
        """Aggregate UDFs (reference: @AggregationFunction classes in
        getFunctions): exec/agg_states.AggregateFunctionSpec entries,
        whose state columns decompose into the primitive segmented
        reductions, so a plugin aggregate inherits partial/final
        splits, spill partitioning and mesh repartition."""
        return []

    def event_listeners(self) -> List[EventListener]:
        """Reference: getEventListenerFactories."""
        return []

    def types(self) -> Dict[str, object]:
        """Named types to register (reference: getTypes): name ->
        SqlType; they then resolve in CAST and DDL like builtins."""
        return {}

    def access_control(self):
        """An AccessControl to install (reference:
        getSystemAccessControlFactories); None contributes none. At
        most one plugin of an engine may contribute one."""
        return None


def _as_spec(item) -> ScalarFunctionSpec:
    if isinstance(item, ScalarFunctionSpec):
        return item
    spec = getattr(item, "__presto_tpu_spec__", None)
    if spec is None:
        raise TypeError(
            f"not a scalar function spec: {item!r} (use "
            f"@scalar_function or ScalarFunctionSpec)")
    return spec


def _install_function(spec: ScalarFunctionSpec) -> None:
    want = tuple(spec.arg_types)

    def resolve(args: List[T.SqlType]) -> T.SqlType:
        if len(args) != len(want):
            raise TypeError(
                f"{spec.name}: expected {len(want)} args, got {len(args)}")
        for got, exp in zip(args, want):
            if T.common_super_type(got, exp) is None:
                raise TypeError(
                    f"{spec.name}: argument {got} not coercible to {exp}")
        return spec.result_type

    def impl(ctx, rt, vals: List[Val]) -> Val:
        # coerce arguments to the declared signature (resolve proved
        # coercibility; a decimal literal passed to a DOUBLE parameter
        # arrives as unscaled integers and must be scaled)
        datas = []
        for v, exp in zip(vals, want):
            if v.type == exp:
                datas.append(v.data)
            else:
                d, _ = cast_data(v, exp, ctx.capacity)
                datas.append(d)
        return Val(spec.fn(torch, *datas), None, rt)

    F.register(spec.name, resolve, impl,
               propagate_nulls=spec.propagate_nulls)


def install(
    plugin: Plugin,
    catalogs: Optional[Dict] = None,
    allow_access_control: bool = False,
) -> Plugin:
    """Install a plugin into the process-wide registries; with a
    catalogs dict (the LocalRunner / PrestoTpuServer wiring) its
    connectors join it (reference: PluginManager.installPlugin +
    ConnectorManager.createConnection).

    A plugin contributing an AccessControl must be installed through an
    engine that enforces it (LocalRunner(plugins=...) /
    PrestoTpuServer(plugins=...)), which pass allow_access_control=True
    and wire it themselves; a direct install() raises rather than drop
    the policy silently."""
    if not allow_access_control and plugin.access_control() is not None:
        raise ValueError(
            "plugin contributes an AccessControl that install() cannot "
            "enforce; install it via LocalRunner(plugins=...) or "
            "PrestoTpuServer(plugins=...)")
    for item in plugin.scalar_functions():
        _install_function(_as_spec(item))
    for agg in plugin.aggregate_functions():
        AS.register_aggregate(agg)
    for name, t in plugin.types().items():
        T.register_type(name, t)
    if catalogs is not None:
        for name, conn in plugin.connectors().items():
            if name in catalogs:
                raise ValueError(f"catalog already exists: {name}")
            catalogs[name] = conn
    return plugin
