"""The port's wire formats against presto_tpu's.

  - dist/serde.serialize_page: for the same page, blobs byte-identical to
    the reference's (wire v3, default codec mode) for every type family
    and the codec paths (RLE, downcast, delta, boolpack, zlib, live
    prefix), and for TPC-H pages the two generators produce;
  - deserialize_page: the round trip, and the reference's blobs decode;
  - dist/plan_serde: the round trip; an unknown class raises;
  - dist/fragmenter.fragment_dag: a Q3-family and the Q5 plan cut into
    the same fragments (count, output kinds and keys, sharded flags,
    split tables, inputs) as the reference's."""

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.dist import fragmenter as RFR
from presto_tpu.dist import serde as RSERDE
from presto_tpu.page import Page as RefPage
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist import fragmenter as FR
from presto_tpu_torch.dist import plan_serde
from presto_tpu_torch.dist import serde as SERDE
from presto_tpu_torch.page import Page
from presto_tpu_torch.runner import LocalRunner
from tests.test_sql_tpch import ENGINE_SQL


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once, and torch's default of one thread per core spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 300


def _cols(family: str, rng):
    """(values with NULLs, sorted values, constant values) of a type."""
    if family in ("BIGINT", "TIMESTAMP"):
        vals = rng.integers(-(1 << 60), 1 << 60, N).tolist()
    elif family in ("INTEGER", "DATE"):
        vals = rng.integers(-(1 << 30), 1 << 30, N).tolist()
    elif family == "SMALLINT":
        vals = rng.integers(-30000, 30000, N).tolist()
    elif family == "TINYINT":
        vals = rng.integers(-100, 100, N).tolist()
    elif family in ("DOUBLE", "REAL"):
        vals = (rng.standard_normal(N) * 1e3).tolist()
        vals[3], vals[4], vals[5] = -0.0, float("nan"), float("inf")
    elif family == "BOOLEAN":
        vals = [bool(v) for v in rng.integers(0, 2, N)]
    elif family == "VARCHAR":
        vals = [f"s{v}" for v in rng.integers(0, 40, N)]
    elif family == "SHORT_DECIMAL":
        vals = rng.integers(-(10**12), 10**12, N).tolist()
    else:  # LONG_DECIMAL
        vals = [int(v) * 10**15 for v in rng.integers(-(10**6), 10**6, N)]
    with_nulls = [None if i % 7 == 0 else v for i, v in enumerate(vals)]
    ordered = sorted(v for v in vals if v == v)  # NaN-free for sorting
    return with_nulls, ordered, [vals[1]] * N


FAMILIES = ["BIGINT", "INTEGER", "SMALLINT", "TINYINT", "DOUBLE", "REAL",
            "BOOLEAN", "DATE", "TIMESTAMP", "VARCHAR", "SHORT_DECIMAL",
            "LONG_DECIMAL"]


def _type(mod, family):
    if family == "SHORT_DECIMAL":
        return mod.DecimalType(12, 2)
    if family == "LONG_DECIMAL":
        return mod.DecimalType(30, 4)
    return getattr(mod, family)


def _page_pair(columns, family, capacity=None):
    ref = RefPage.from_arrays(columns, [_type(RT, family)] * len(columns),
                              capacity=capacity)
    port = Page.from_arrays(columns, [_type(T, family)] * len(columns),
                            capacity=capacity, device="cpu")
    return ref, port


@pytest.mark.parametrize("family", FAMILIES)
def test_serialize_page_is_byte_identical(family):
    rng = np.random.default_rng(len(family))
    with_nulls, ordered, const = _cols(family, rng)
    for columns, cap in (([with_nulls], None), ([ordered[:N // 2]], None),
                         ([const], None), ([with_nulls[:40]], 1024),
                         ([with_nulls, ordered[:N], const], None)):
        columns = [c[:len(columns[0])] for c in columns]
        ref, port = _page_pair(columns, family, capacity=cap)
        blob = SERDE.serialize_page(port)
        assert blob == RSERDE.serialize_page(ref), family
        back = SERDE.deserialize_page(blob)
        assert repr(back.to_pylist()) == repr(port.to_pylist())
        assert back.capacity == port.capacity


def test_empty_page_is_byte_identical():
    ref, port = _page_pair([[1, 2, 3]], "BIGINT", capacity=16)
    ref = ref.with_valid(ref.valid & False)
    port = port.with_valid(port.valid & False)
    assert SERDE.serialize_page(port) == RSERDE.serialize_page(ref)


@pytest.mark.parametrize("table", ["lineitem", "orders", "customer",
                                   "nation"])
def test_tpch_pages_are_byte_identical(table):
    ref_conn, conn = RefConnector(0.002), TpchConnector(0.002,
                                                        device="cpu")
    split = conn.splits(table, 1 << 12)[0]
    rsplit = ref_conn.splits(table, 1 << 12)[0]
    blob = SERDE.serialize_page(conn.page_for_split(split))
    assert blob == RSERDE.serialize_page(ref_conn.page_for_split(rsplit))
    # and the reference's blob decodes to the same rows
    ref_back = SERDE.deserialize_page(blob)
    assert ref_back.to_pylist() == conn.page_for_split(split).to_pylist()


def test_corrupt_blob_raises():
    _ref, port = _page_pair([list(range(100))], "BIGINT")
    blob = SERDE.serialize_page(port)
    with pytest.raises(SERDE.PageWireError):
        SERDE.deserialize_page(blob[:-3])
    with pytest.raises(SERDE.PageWireError):
        SERDE.deserialize_page(b"PTP2" + blob[4:])


# ---------------------------------------------------------- plans

Q3_FAMILY = (
    "select o_orderkey, count(*) c from lineitem "
    "join orders on l_orderkey = o_orderkey "
    "where o_orderkey < 1000 group by o_orderkey order by o_orderkey"
)
SF = 0.01


@pytest.fixture(scope="module")
def runners():
    port = LocalRunner({"tpch": TpchConnector(SF, device="cpu")},
                       device="cpu")
    ref = RefRunner({"tpch": RefConnector(SF)})
    ref.session.set("generated_join_enabled", False)
    return port, ref


@pytest.mark.parametrize("sql", [Q3_FAMILY, ENGINE_SQL[3], ENGINE_SQL[5]])
def test_plan_serde_round_trip(sql, runners):
    plan = runners[0].plan(sql)
    blob = plan_serde.dumps(plan)
    assert plan_serde.loads(blob) == plan
    assert plan_serde.dumps(plan_serde.loads(blob)) == blob


def test_plan_serde_refuses_unknown_classes():
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Stranger:
        x: int = 1

    with pytest.raises(TypeError, match="unregistered"):
        plan_serde.dumps(Stranger())
    with pytest.raises(TypeError, match="unknown plan class"):
        plan_serde.loads('{"$c": "Stranger", "x": 1}')


def _shape(dag):
    return [(f.fid, f.output_kind, tuple(f.output_keys), f.sharded,
             f.split_table, tuple(f.inputs)) for f in dag.fragments]


@pytest.mark.parametrize("broadcast_rows", [0, 1 << 21])
@pytest.mark.parametrize("sql", [Q3_FAMILY, ENGINE_SQL[3], ENGINE_SQL[5]])
def test_fragment_dag_matches_the_reference(sql, broadcast_rows, runners):
    port, ref = runners
    opts = {"broadcast_rows": broadcast_rows, "gather_capacity": 1 << 17}
    dag = FR.fragment_dag(port.executor, port.plan(sql), port.catalogs,
                          **opts)
    rdag = RFR.fragment_dag(ref.executor, ref.plan(sql), ref.catalogs,
                            **opts)
    assert dag is not None and rdag is not None
    assert _shape(dag) == _shape(rdag)
    assert dag.root_inputs == rdag.root_inputs
    # every shipped fragment survives the plan round trip
    for f in dag.fragments:
        clipped = FR.clip_for_shipping(f.root)
        assert plan_serde.loads(plan_serde.dumps(clipped)) == clipped
