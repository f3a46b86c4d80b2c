"""The mesh's repartitioned paths against presto_tpu's DistExecutor on
the conftest's 8 virtual CPU devices (TPC-H SF 0.005, page_rows 2^13).

The counterparts of tests/test_dist.py's forced-threshold cases
(broadcast_rows=64, gather_capacity=16: every join partitions both
sides and every group-by repartitions its partial states through the
all_to_all): the 5 repartition queries and the 4 round-2 aggregates
equal the reference mesh's and the port's single-process rows. Shard by
shard against the reference: ``_repartition_fn`` and ``_residue_fn``
put the same rows on each shard, in the same order, for int, double
(with -0.0 and NaN), dictionary varchar, NULL and two-column keys, and
under hash_partition_count; the partial and final aggregation states
of a repartitioned group-by hold the same groups per shard. The
all_to_all's per-sender send layout (the path shards on different cards
take) equals its one-device sort.

Tolerances: integers, decimals, strings, hashes and shard placement
compare exactly; doubles in query rows to 9 significant digits (the
mesh sums in a different order); aggregation states compare exactly
(each shard reduces the same rows in the same order)."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import page as RPG
from presto_tpu import types as RT
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.dist.executor import DistExecutor as RefDistExecutor
from presto_tpu.dist.executor import make_mesh as ref_make_mesh
from presto_tpu.exec import plan as RP
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import interop
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist import executor as DX
from presto_tpu_torch.dist.executor import DistExecutor, make_mesh
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.runner import LocalRunner
from tests.test_sql_tpch import ENGINE_SQL

SF = 0.005
PAGE_ROWS = 1 << 13
D = 8
REPART = dict(broadcast_rows=64, gather_capacity=16)
REPART_QUERIES = [1, 3, 6, 10, 13]
ROUND2_QUERIES = [
    # variance family through partial/final state merge across shards
    "select l_returnflag, stddev(l_quantity), var_samp(l_extendedprice),"
    " count(*) from lineitem group by l_returnflag",
    # global variance (gather of moment sums)
    "select stddev_pop(o_totalprice), variance(o_totalprice) from orders",
    # MarkDistinct: mixed DISTINCT/plain and multiple distinct columns
    "select count(distinct n_regionkey), count(distinct n_name), "
    "count(*) from nation",
    "select o_orderpriority, count(distinct o_custkey), sum(o_totalprice)"
    " from orders group by o_orderpriority",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def canon_row(row):
    return tuple(f"{v:.9e}" if isinstance(v, float) else repr(v)
                 for v in row)


def rows_equal(a, b):
    return collections.Counter(map(canon_row, a)) == \
        collections.Counter(map(canon_row, b))


@pytest.fixture(scope="module")
def conn():
    return TpchConnector(SF, device="cpu")


@pytest.fixture(scope="module")
def ref_conn():
    return RefConnector(SF)


@pytest.fixture(scope="module")
def single(conn):
    return LocalRunner({"tpch": conn}, session={"page_rows": PAGE_ROWS},
                       device="cpu")


@pytest.fixture(scope="module")
def dist(conn):
    return LocalRunner({"tpch": conn}, session={"page_rows": PAGE_ROWS},
                       mesh=make_mesh(D, device="cpu"))


@pytest.fixture(scope="module")
def dist_repart(conn):
    return LocalRunner({"tpch": conn}, session={"page_rows": PAGE_ROWS},
                       mesh=make_mesh(D, device="cpu"), dist_options=REPART)


@pytest.fixture(scope="module")
def ref_dist_repart(ref_conn):
    return RefRunner({"tpch": ref_conn}, page_rows=PAGE_ROWS,
                     mesh=ref_make_mesh(D), dist_options=REPART)


@pytest.mark.parametrize("qnum", REPART_QUERIES)
def test_repartition_matches_reference_and_single(qnum, single, dist_repart,
                                                  ref_dist_repart):
    got = dist_repart.execute(ENGINE_SQL[qnum]).rows
    assert rows_equal(got, ref_dist_repart.execute(ENGINE_SQL[qnum]).rows)
    assert rows_equal(got, single.execute(ENGINE_SQL[qnum]).rows)
    assert dist_repart.executor.mesh_local_exchanges > 0


@pytest.mark.parametrize("qi", range(len(ROUND2_QUERIES)))
def test_round2_aggregates(qi, single, dist, dist_repart, ref_dist_repart):
    q = ROUND2_QUERIES[qi]
    want = single.execute(q).rows
    assert rows_equal(dist.execute(q).rows, want)
    got = dist_repart.execute(q).rows
    assert rows_equal(got, want)
    assert rows_equal(got, ref_dist_repart.execute(q).rows)


# ------------------------------------------------- shard-by-shard parity
R = 64  # rows per shard of the module-level cases


def _key_case(name, rng):
    """(arrays for page_from_numpy, key channels) of one key type over
    D * R rows; channel 0 is a row id so every row is identifiable."""
    n = D * R
    rid = np.arange(n, dtype=np.int64)
    valid = rng.random(n) < 0.9
    none = [None, None]
    if name == "int":
        k = rng.integers(-50, 50, n).astype(np.int64)
        cols, nulls, dicts, types = [rid, k], none, none, ["bigint"] * 2
    elif name == "double":
        k = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.25, 1e300]), n)
        cols, nulls, dicts, types = [rid, k], none, none, ["bigint",
                                                          "double"]
    elif name == "varchar":
        k = rng.integers(0, 7, n).astype(np.int32)
        cols, nulls = [rid, k], none
        dicts = [None, [f"s{i}" for i in range(7)]]
        types = ["bigint", "varchar"]
    elif name == "null":
        k = rng.integers(0, 20, n).astype(np.int64)
        cols, dicts, types = [rid, k], none, ["bigint"] * 2
        nulls = [None, rng.random(n) < 0.3]
    else:  # two columns
        k1 = rng.integers(0, 5, n).astype(np.int64)
        k2 = rng.integers(0, 9, n).astype(np.int32)
        cols, nulls = [rid, k1, k2], [None, None, rng.random(n) < 0.2]
        dicts, types = [None] * 3, ["bigint", "bigint", "integer"]
        return dict(columns=cols, valid=valid, nulls=nulls,
                    dictionaries=dicts, types=types), (1, 2)
    return dict(columns=cols, valid=valid, nulls=nulls, dictionaries=dicts,
                types=types), (1,)


def _ref_page(arrays):
    blocks = []
    for col, nl, dic, typ in zip(arrays["columns"], arrays["nulls"],
                                 arrays["dictionaries"], arrays["types"]):
        blocks.append(RPG.Block(
            data=jnp.asarray(col), type=RT.parse_type(typ),
            nulls=None if nl is None else jnp.asarray(nl),
            dictionary=None if dic is None else RPG.Dictionary(dic)))
    return RPG.Page(blocks=tuple(blocks),
                    valid=jnp.asarray(arrays["valid"]))


def _head(arrays, n):
    """The first n rows of a page's arrays."""
    return dict(
        columns=[col[:n] for col in arrays["columns"]],
        valid=arrays["valid"][:n],
        nulls=[None if nl is None else nl[:n] for nl in arrays["nulls"]],
        dictionaries=arrays["dictionaries"], types=arrays["types"])


def _rows(arrays, lo, hi):
    """The valid rows of [lo, hi) as tuples of decoded values (NaN as a
    string so rows compare equal)."""
    out = []
    valid = arrays["valid"]
    for i in range(lo, hi):
        if not valid[i]:
            continue
        row = []
        for col, nl, dic in zip(arrays["columns"], arrays["nulls"],
                                arrays["dictionaries"]):
            if isinstance(col, tuple):
                v = tuple(int(c[i]) for c in col)
            else:
                v = col[i].item()
            if dic is not None:
                v = dic[v]
            if nl is not None and nl[i]:
                v = None
            if isinstance(v, float) and v != v:
                v = "nan"
            row.append(v)
        out.append(tuple(row))
    return out


def _port_shard_rows(sp):
    out = []
    for s in sp.shards:
        a = interop.page_arrays(s)
        out.append(_rows(a, 0, s.capacity))
    return out


def _ref_shard_rows(page, d=D):
    a = interop.page_arrays(page)
    local = len(a["valid"]) // d
    return [_rows(a, j * local, (j + 1) * local) for j in range(d)]


@pytest.fixture(scope="module")
def executors(conn, ref_conn):
    return (DistExecutor({"tpch": conn}, make_mesh(D, device="cpu")),
            RefDistExecutor({"tpch": ref_conn}, ref_make_mesh(D)))


KEY_CASES = ["int", "double", "varchar", "null", "two_columns"]


@pytest.mark.parametrize("hash_partitions", [0, 3])
@pytest.mark.parametrize("name", KEY_CASES)
def test_repartition_and_residue_shards_equal_reference(name,
                                                        hash_partitions,
                                                        executors):
    port_ex, ref_ex = executors
    port_ex.hash_partitions = ref_ex.hash_partitions = hash_partitions
    arrays, keys = _key_case(name, np.random.default_rng(len(name)))
    ref_page = _ref_page(arrays)
    port_page = interop.page_from_numpy(**arrays)
    # sharded -> sharded: the all_to_all
    shards = DX.ShardedPage(tuple(
        DX.slice_page(port_page, j * R, R) for j in range(D)))
    out, overflow = port_ex._repartition_fn(keys)(shards)
    ref_out, ref_overflow = ref_ex._repartition_fn(keys)(ref_page)
    assert _port_shard_rows(out) == _ref_shard_rows(ref_out)
    assert bool(overflow) == bool(ref_overflow)
    # replicated -> sharded: the residue split of one replicated page
    rep_arrays = _head(arrays, R)
    res, _none = port_ex._residue_fn(keys)(
        interop.page_from_numpy(**rep_arrays))
    ref_res, _ = ref_ex._residue_fn(keys)(_ref_page(rep_arrays))
    assert _port_shard_rows(res) == _ref_shard_rows(ref_res)
    port_ex.hash_partitions = ref_ex.hash_partitions = 0


def test_send_layout_equals_one_device_sort():
    """The per-sender [D, R] send layout (shards on different devices)
    lands every receiver's rows exactly as the one-device sort. The
    layout follows the device list: D names of the host make D
    devices, and every peer copy between them is a host copy."""
    arrays, keys = _key_case("null", np.random.default_rng(5))
    page = interop.page_from_numpy(**arrays)
    senders = [DX.slice_page(page, j * R, R) for j in range(D)]
    tgts = [torch.where(s.valid, DX.u64.umod(DX._key_hash(s, keys), D), D)
            for s in senders]
    one = (torch.device("cpu"),) * D
    many = tuple(torch.device("cpu", j) for j in range(D))
    for out_cap in (D * R, 16):  # room for every row, and overflowing
        a, na = DX._all_to_all(senders, tgts, one, out_cap)
        b, nb = DX._all_to_all(senders, tgts, many, out_cap)
        assert [_rows(interop.page_arrays(x), 0, out_cap) for x in a] == \
            [_rows(interop.page_arrays(x), 0, out_cap) for x in b]
        assert na.tolist() == nb.tolist()
        assert sum(na.tolist()) == int(page.num_rows())
        assert bool((na > out_cap).any()) == (out_cap == 16)


def _find(node, pred):
    if pred(node):
        return node
    for c in node.children():
        hit = _find(c, pred)
        if hit is not None:
            return hit
    return None


def test_partial_and_final_states_per_shard(dist_repart, ref_dist_repart):
    """A repartitioned group-by's partial states (per scan shard) and
    final states (per receiving shard) hold the same groups and the
    same states on every shard as the reference's."""
    q = ("select o_orderpriority, o_orderstatus, count(*), "
         "sum(o_totalprice), max(o_custkey) from orders "
         "group by o_orderpriority, o_orderstatus")
    port_plan, ref_plan = dist_repart.plan(q), ref_dist_repart.plan(q)
    ex, rex = dist_repart.executor, ref_dist_repart.executor
    ex.kernels = False
    for step in ("partial", "final"):
        node = _find(port_plan, lambda n, s=step: isinstance(
            n, P.Aggregation) and n.step == s)
        rnode = _find(ref_plan, lambda n, s=step: isinstance(
            n, RP.Aggregation) and n.step == s)
        got = [_port_shard_rows(p) for p in ex.pages(node)]
        want = [_ref_shard_rows(p) for p in rex.pages(rnode)]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert [sorted(map(repr, s)) for s in g] == \
                [sorted(map(repr, s)) for s in w]
