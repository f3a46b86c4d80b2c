"""The plugin SPI, access control and the verifier's checksums:
presto_tpu_torch against presto_tpu.

The counterparts of the 9 cases of tests/test_plugin.py. A port plugin
gives each UDF and aggregate a torch body equal to the reference
plugin's jax.numpy body (the first argument of a body is the array
namespace on both engines); every case runs the same statements through
both engines and holds rows (and the denials) equal: UDFs and a plugin
connector through SQL, argument type checks, a plugin's event listener
on the server, a duplicate catalog, a plugin aggregate (partial/final
split, finalize), a plugin type in CAST, the access-control choke points
(select, subquery, drop, SET SESSION, filtered listings, views, a
user-sensitive allow), a type that would shadow a builtin, and install()
refusing an access control it cannot enforce. Then verifier.py: the
per-value hash equals the device xxhash64 and the reference's, and
row checksums of real results are the reference's bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from presto_tpu import plugin as RPL
from presto_tpu import security as RSEC
from presto_tpu import types as RT
from presto_tpu import verifier as RV
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.events import EventListener as RefListener
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import plugin as PL
from presto_tpu_torch import security as SEC
from presto_tpu_torch import types as T
from presto_tpu_torch import verifier as V
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.events import EventListener
from presto_tpu_torch.runner import LocalRunner


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- the plugins, twice
def _demo_plugins():
    """(port plugin class, reference plugin class): one UDF connector
    plugin per engine, the same bodies over each array namespace."""

    def make(base, sf, t, mem, listener_base, memory_kw):
        @sf("double_it", [t.BIGINT], t.BIGINT)
        def double_it(xp, x):
            return x * 2

        class Demo(base):
            name = "demo"

            def __init__(self):
                self.listener_events = []

            def connectors(self):
                m = mem(**memory_kw)
                m.create_table("plugin_t", ["k"], [t.BIGINT],
                               [(i,) for i in range(10)])
                return {"demo": m}

            def scalar_functions(self):
                return [double_it, (PL if base is PL.Plugin else RPL)
                        .ScalarFunctionSpec(
                            "hypot2", (t.DOUBLE, t.DOUBLE), t.DOUBLE,
                            lambda xp, a, b: xp.sqrt(a * a + b * b))]

            def event_listeners(self):
                rec = self

                class L(listener_base):
                    def query_completed(self, e):
                        rec.listener_events.append(e.state)

                return [L()]

        return Demo

    return (make(PL.Plugin, PL.scalar_function, T, MemoryConnector,
                 EventListener, {"device": "cpu"}),
            make(RPL.Plugin, RPL.scalar_function, RT, RefMemory,
                 RefListener, {}))


PORT_DEMO, REF_DEMO = _demo_plugins()


def _pair(sf, plugins, page_rows=None, extra=None):
    """(port runner, reference runner) over TPC-H at ``sf`` plus
    ``extra`` catalogs, each with its engine's plugins."""
    pc = {"tpch": TpchConnector(sf, device="cpu"),
          **{k: v[0] for k, v in (extra or {}).items()}}
    rc = {"tpch": RefTpch(sf), **{k: v[1] for k, v in
                                  (extra or {}).items()}}
    sess = {"page_rows": page_rows} if page_rows else None
    port = LocalRunner(pc, device="cpu", session=sess, plugins=plugins[0])
    ref = RefRunner(rc, plugins=plugins[1],
                    **({"page_rows": page_rows} if page_rows else {}))
    return port, ref


def _same(pair, sql):
    got, want = (r.execute(sql).rows for r in pair)
    assert got == want, sql
    return got


def test_udf_and_connector_through_sql():
    pair = _pair(0.001, ([PORT_DEMO()], [REF_DEMO()]))
    assert _same(pair, "select double_it(n_nationkey), hypot2(3.0, 4.0) "
                       "from tpch.nation where n_nationkey = 7") == \
        [(14, 5.0)]
    # the plugin connector became a catalog
    assert _same(pair, "select count(*), sum(k) from demo.plugin_t "
                       "where k >= 5") == [(5, 35)]
    # UDFs compose with engine expressions, and nulls propagate
    assert _same(pair, "select double_it(cast(null as bigint))") == \
        [(None,)]


def test_type_checking_of_udf_args():
    for r in _pair(0.001, ([PORT_DEMO()], [REF_DEMO()])):
        with pytest.raises(Exception):
            r.execute("select double_it('abc')")


def test_plugin_event_listener_on_server():
    from presto_tpu.client import StatementClient as RefClient
    from presto_tpu.server import PrestoTpuServer as RefServer
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.server import PrestoTpuServer

    out = []
    for plug, srv_cls, cli_cls, kw, conn in (
            (PORT_DEMO(), PrestoTpuServer, StatementClient,
             {"device": "cpu"}, TpchConnector(0.001, device="cpu")),
            (REF_DEMO(), RefServer, RefClient, {}, RefTpch(0.001))):
        srv = srv_cls({"tpch": conn}, port=0, plugins=[plug], **kw)
        srv.start()
        try:
            c = cli_cls(server=f"http://127.0.0.1:{srv.port}")
            out.append(c.execute("select double_it(21)").rows)
        finally:
            srv.stop()
        out.append(plug.listener_events)
    assert out[:2] == out[2:] == [[[42]], ["FINISHED"]]


def test_duplicate_catalog_rejected():
    with pytest.raises(ValueError):
        LocalRunner({"demo": MemoryConnector(device="cpu"),
                     "tpch": TpchConnector(0.001, device="cpu")},
                    device="cpu", plugins=[PORT_DEMO()])
    with pytest.raises(ValueError):
        RefRunner({"demo": RefMemory(), "tpch": RefTpch(0.001)},
                  plugins=[REF_DEMO()])


# ------------------------------------------------ aggregate-function SPI
def _log_pre(data):
    return torch.log(torch.clamp(data.to(torch.float64), min=1e-300))


def _ref_log_pre(data):
    import jax.numpy as jnp

    return jnp.log(jnp.maximum(data.astype(jnp.float64), 1e-300))


def _geo_mean_finalize(xp, states):
    (logsum, nulls), (count, _) = states
    n = torch.clamp(count, min=1).to(torch.float64)
    return torch.exp(logsum / n), nulls


def _ref_geo_mean_finalize(xp, states):
    (logsum, nulls), (count, _) = states
    n = xp.maximum(count, 1).astype(xp.float64)
    return xp.exp(logsum / n), nulls


def _agg_plugins():
    from presto_tpu.exec import agg_states as RAS
    from presto_tpu.ops import agg as RA
    from presto_tpu_torch.exec import agg_states as AS
    from presto_tpu_torch.ops import agg as A

    def make(base, mod, ops, t, pre, fin):
        class Agg(base):
            name = "agg-demo"

            def aggregate_functions(self):
                return [mod.AggregateFunctionSpec(
                    name="geometric_mean",
                    state=(mod.StateCol("logsum", ops.SUM, ops.SUM,
                                        t.DOUBLE, pre=pre),
                           mod.StateCol("count", ops.COUNT, ops.SUM,
                                        t.BIGINT)),
                    result=t.DOUBLE, finalize=fin)]

        return Agg()

    return (make(PL.Plugin, AS, A, T, _log_pre, _geo_mean_finalize),
            make(RPL.Plugin, RAS, RA, RT, _ref_log_pre,
                 _ref_geo_mean_finalize))


def test_plugin_aggregate_function():
    """A plugin aggregate resolves, plans, splits partial/final and
    finalizes like a builtin, with the reference's values."""
    port, ref = _agg_plugins()
    pair = _pair(0.01, ([port], [ref]), page_rows=1 << 12)
    sql = ("select o_orderpriority, geometric_mean(o_totalprice), "
           "avg(o_totalprice) from orders group by o_orderpriority "
           "order by 1")
    got, want = (r.execute(sql).rows for r in pair)
    assert len(got) == 5 and [g[0] for g in got] == [w[0] for w in want]
    for (_, gm, av), (_, rgm, rav) in zip(got, want):
        assert 0 < gm < av  # AM-GM, strict for spread data
        assert gm == pytest.approx(rgm, rel=1e-12) and av == rav
    got = pair[0].execute(
        "select geometric_mean(n_nationkey + 1) from nation").rows[0][0]
    want = math.exp(sum(math.log(k + 1) for k in range(25)) / 25)
    assert abs(got - want) / want < 1e-9
    assert got == pytest.approx(pair[1].execute(
        "select geometric_mean(n_nationkey + 1) from nation").rows[0][0],
        rel=1e-12)


def test_plugin_type_registration():
    """A contributed named type resolves in CAST (reference:
    spi/Plugin.getTypes + TypeRegistry.addType)."""
    class PortTypes(PL.Plugin):
        def types(self):
            return {"money": T.DecimalType(18, 2)}

    class RefTypes(RPL.Plugin):
        def types(self):
            return {"money": RT.DecimalType(18, 2)}

    pair = _pair(0.01, ([PortTypes()], [RefTypes()]), page_rows=1 << 12)
    got = _same(pair, "select cast(o_totalprice as money) from orders "
                      "where o_orderkey = 1")
    assert len(got) == 1
    assert T.parse_type("money") == T.DecimalType(18, 2)


def _restrictive(sec):
    class Restrictive(sec.AccessControl):
        def check_can_select(self, user, catalog, table, columns):
            if table == "customer" and user != "admin":
                self.deny(f"select from {table}")

        def check_can_drop_table(self, user, catalog, table):
            self.deny(f"drop {table}")

        def check_can_set_session(self, user, name):
            if name == "tpu_offload_enabled":
                self.deny(f"set {name}")

    class NoDrop(Restrictive):
        def check_can_drop_view(self, user, catalog, name):
            self.deny(f"drop view {name}")

    return Restrictive, NoDrop


def test_access_control_plugin():
    """Select, write, session and view checks at the reference's choke
    points, with the same denials and listings on both engines."""
    engines = []
    for pl, sec in ((PL, SEC), (RPL, RSEC)):
        restrictive, no_drop = _restrictive(sec)

        class SecPlugin(pl.Plugin):
            name = "security"

            def access_control(self, _r=restrictive):
                return _r()

        engines.append((SecPlugin(), sec, restrictive, no_drop))
    port, ref = _pair(
        0.01, ([engines[0][0]], [engines[1][0]]), page_rows=1 << 12,
        extra={"memory": (MemoryConnector(device="cpu"), RefMemory())})
    for r, (_plug, sec, restrictive, no_drop) in ((port, engines[0]),
                                                  (ref, engines[1])):
        deny = sec.AccessDeniedError
        assert r.execute("select count(*) from nation").rows == [(25,)]
        with pytest.raises(deny):
            r.execute("select count(*) from customer")
        with pytest.raises(deny):
            r.execute("select count(*) from orders where o_custkey in "
                      "(select c_custkey from customer)")
        r.execute("create table memory.t1 as select 1 as x")
        with pytest.raises(deny):
            r.execute("drop table memory.t1")
        with pytest.raises(deny):
            r.execute("set session tpu_offload_enabled = false")
        r.execute("create view v_ok as select 1 as x")
        r.access_control = no_drop()
        with pytest.raises(deny):
            r.execute("drop view v_ok")
        r.access_control = restrictive()
        # a user-sensitive allow
        r.session.user = "admin"
        assert r.execute("select count(*) from customer").rows[0][0] > 0
        r.session.user = "presto"
    # listings hide the denied table (reference: filterTables)
    listed = _same((port, ref), "select table_name from system.tables "
                                "where table_catalog = 'tpch'")
    names = {t[0] for t in listed}
    assert "customer" not in names and "nation" in names


def test_type_plugin_cannot_shadow_builtin():
    class PortShadow(PL.Plugin):
        def types(self):
            return {"decimal": T.DecimalType(10, 0)}

    class RefShadow(RPL.Plugin):
        def types(self):
            return {"decimal": RT.DecimalType(10, 0)}

    with pytest.raises(ValueError):
        LocalRunner({"tpch": TpchConnector(0.01, device="cpu")},
                    device="cpu", plugins=[PortShadow()])
    with pytest.raises(ValueError):
        RefRunner({"tpch": RefTpch(0.01)}, plugins=[RefShadow()])


def test_install_rejects_unwired_access_control():
    for pl, sec in ((PL, SEC), (RPL, RSEC)):
        class ACPlugin(pl.Plugin):
            def access_control(self, _s=sec):
                return _s.AccessControl()

        with pytest.raises(ValueError):
            pl.install(ACPlugin())


# ------------------------------------------------------------ verifier
def test_verifier_value_hash_is_the_device_xxhash64():
    """xxhash64_long over int64 values equals ops/hashing.xxhash64_u64
    on the device and the reference's host hash."""
    from presto_tpu_torch.ops import hashing as H

    rng = np.random.default_rng(7)
    vals = np.concatenate([rng.integers(-2 ** 63, 2 ** 63 - 1, 64,
                                        dtype=np.int64),
                           np.array([0, 1, -1, 2 ** 63 - 1, -2 ** 63])])
    dev = H.xxhash64_u64(torch.from_numpy(vals)).numpy().view(np.uint64)
    for v, d in zip(vals.tolist(), dev.tolist()):
        assert V.xxhash64_long(v) == RV.xxhash64_long(v) == d


@pytest.mark.parametrize("sql", [
    "select l_returnflag, l_linestatus, count(*), sum(l_quantity), "
    "avg(l_discount) from lineitem group by 1, 2",
    "select n_name, n_regionkey, n_comment from nation",
    "select o_orderkey, o_orderdate, o_totalprice, o_orderpriority "
    "from orders where o_orderkey < 200",
])
def test_verifier_checksums_equal_the_reference(sql):
    """checksum_rows over a real result set is the reference's bit for
    bit (decimals, doubles, strings, dates, NULLs); row order does not
    matter; a changed row changes it."""
    pair = _pair(0.01, ((), ()), page_rows=1 << 12)
    got, want = (r.execute(sql).rows for r in pair)
    rows = got + [(None,) * len(got[0])]
    assert V.checksum_rows(rows) == RV.checksum_rows(rows)
    assert V.checksum_rows(got) == RV.checksum_rows(want)
    V.assert_same_results(got, list(reversed(want)), sql)
    bad = [tuple(reversed(r)) for r in got[:1]] + got[1:]
    with pytest.raises(AssertionError):
        V.assert_same_results(bad, want, sql)
