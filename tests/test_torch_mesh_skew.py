"""Skew on the mesh: presto_tpu_torch's DistExecutor against
presto_tpu's on the conftest's 8 virtual CPU devices, one key owning
50% of a memory table's rows (the counterparts of tests/test_skew.py,
same table, same thresholds).

1. Aggregation: the partial/final split pre-reduces each shard to <= 1
   state row per group before the repartition, so a hot group moves at
   most D state rows.
2. Repartitioned joins: the hot key's probe rows land on one shard; the
   landing capacity's slack plus the deferred-overflow boost ladder
   absorb it.
3. The operator escape: join_distribution_type=broadcast replicates the
   build side, so probe rows never move.

Each equals the reference mesh's rows and the port's single-process
rows; doubles to 9 significant digits, everything else exactly."""

import collections

import jax
import pytest
import torch

from presto_tpu.dist.executor import make_mesh as ref_make_mesh
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.dist.executor import make_mesh
from presto_tpu_torch.runner import LocalRunner
from tests.test_skew import N_ROWS
from tests.test_skew import _skewed_catalog as ref_catalog
from tests.torch_memory import MemoryConnector

D = 8
PAGE_ROWS = 1 << 10
FORCED = dict(broadcast_rows=16, gather_capacity=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skewed_catalog():
    """tests/test_skew.py's tables in the port's memory connector."""
    mem = MemoryConnector(device="cpu")
    rows = []
    for i in range(N_ROWS):
        key = 7 if i % 2 == 0 else (i % 97) + 100
        rows.append((key, i, float(i % 13)))
    mem.create_table("fact", ["k", "seq", "v"],
                     [T.BIGINT, T.BIGINT, T.DOUBLE], rows)
    mem.create_table(
        "dim", ["k", "label"], [T.BIGINT, T.BIGINT],
        [(k, k * 10) for k in [7] + [i + 100 for i in range(97)]])
    return mem


def canon_row(row):
    return tuple(f"{v:.9e}" if isinstance(v, float) else repr(v)
                 for v in row)


def rows_eq(a, b):
    return collections.Counter(map(canon_row, a)) == \
        collections.Counter(map(canon_row, b))


def _runner(mesh=None, **kw):
    return LocalRunner({"memory": _skewed_catalog()},
                       default_catalog="memory",
                       session={"page_rows": PAGE_ROWS}, device="cpu",
                       mesh=mesh, **kw)


@pytest.fixture(scope="module")
def single():
    return _runner()


@pytest.fixture(scope="module")
def dist():
    return _runner(make_mesh(D, device="cpu"), dist_options=FORCED)


@pytest.fixture(scope="module")
def ref_dist():
    assert len(jax.devices()) >= D
    return RefRunner({"memory": ref_catalog()}, default_catalog="memory",
                     page_rows=PAGE_ROWS, mesh=ref_make_mesh(D),
                     dist_options=FORCED)


def test_skewed_aggregation_parity(single, dist, ref_dist):
    q = "select k, count(*), sum(v), max(seq) from fact group by k"
    got = dist.execute(q).rows
    assert rows_eq(got, single.execute(q).rows)
    assert rows_eq(got, ref_dist.execute(q).rows)
    hot = [r for r in got if r[0] == 7][0]
    assert hot[1] == N_ROWS // 2  # the hot key really is 50%
    assert "repartition" in str(dist.plan(q))


def test_skewed_repartitioned_join_parity(single, dist, ref_dist):
    # broadcast_rows=16 forces the dim build (98 rows) to partition, so
    # the hot key's probe rows all route to one shard
    q = ("select count(*), sum(label), sum(v) from fact, dim "
         "where fact.k = dim.k")
    got = dist.execute(q).rows
    assert rows_eq(got, single.execute(q).rows)
    assert rows_eq(got, ref_dist.execute(q).rows)


def test_broadcast_escape_hatch(single):
    r = _runner(make_mesh(D, device="cpu"))
    r.session.set("join_distribution_type", "broadcast")
    ref = RefRunner({"memory": ref_catalog()}, default_catalog="memory",
                    page_rows=PAGE_ROWS, mesh=ref_make_mesh(D))
    ref.session.set("join_distribution_type", "broadcast")
    q = ("select count(*), sum(label) from fact, dim "
         "where fact.k = dim.k")
    got = r.execute(q).rows
    assert rows_eq(got, single.execute(q).rows)
    assert rows_eq(got, ref.execute(q).rows)
    assert "broadcast" in str(r.plan(q))
