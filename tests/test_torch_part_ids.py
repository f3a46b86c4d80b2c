"""K4 and the exchange partitioning of presto_tpu_torch against presto_tpu.

The same key pages, built from the same Python values on both sides, go
through the reference's partitioning (presto_tpu/dist/spool.py: the
splitmix64 host and device hashes, the Pallas partition-id kernel in
interpret mode, device_partition_pages) and the port's
(presto_tpu_torch/dist/spool.py, ops/cuda_part.py on the CPU). Every
comparison is exact: partition ids on int32, hashes on their 64 bits,
partition pages row for row in order."""

import jax
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.tpch import TpchConnector as RefConnector
from presto_tpu.dist import spool as RSPOOL
from presto_tpu.exec import xfer as XF
from presto_tpu.exec.executor import Executor as RefExecutor
from presto_tpu.page import Page as RefPage
from presto_tpu_torch import cuda
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist import spool as SPOOL
from presto_tpu_torch.exec import shapes as SH
from presto_tpu_torch.exec.executor import Executor
from presto_tpu_torch.ops import cuda_part as CP
from presto_tpu_torch.page import Page


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once, and torch's default of one thread per core spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NPARTS = (2, 3, 4, 8)

# every partitionable key family with NULLs, -0.0 and NaN
# (tests/test_device_exchange.py's _key_page)
KEY_COLUMNS = [
    [1, -7, None, 4, 0, 2**40, -1, 5],
    [1.5, -0.0, 0.0, None, float("nan"), 2.5, -3.5, 1e300],
    [True, False, None, True, False, True, False, True],
    ["a", "b", "a", None, "c", "b", "zz", "a"],
    [105, None, -205, 305, 0, 105, 42, 7],          # decimal(9,2)
    [10**20, -(10**20), None, 7, 0, 10**20, 1, 2],  # decimal(30,2)
]
KEY_TYPES = ["BIGINT", "DOUBLE", "BOOLEAN", "VARCHAR", "DecimalType(9, 2)",
             "DecimalType(30, 2)"]
FAMILIES = [(0,), (1,), (2,), (3,), (4,), (5,), (0, 1, 2, 3, 4, 5)]


def _types(mod, names):
    return [eval(n, {"DecimalType": mod.DecimalType}) if "(" in n
            else getattr(mod, n) for n in names]


def _pages(columns, type_names):
    ref = RefPage.from_arrays(columns, _types(RT, type_names))
    port = Page.from_arrays(columns, _types(T, type_names), device="cpu")
    return ref, port


def _random_pages(cols: int, n: int = 4096):
    rng = np.random.default_rng(cols)
    columns = [rng.integers(-(1 << 62), 1 << 62, n).tolist()
               for _ in range(cols)]
    return _pages(columns, ["BIGINT"] * cols), tuple(range(cols))


def _ref_luts(page, keys):
    return tuple(
        XF.to_device(RSPOOL._dict_value_hashes(page.block(k).dictionary))
        if page.block(k).dictionary is not None else None for k in keys)


def _port_ids(page, keys, nparts):
    enc = SPOOL.part_id_encodings(page, keys,
                                  SPOOL._dict_luts(page, keys))
    return CP.part_ids(enc, nparts).numpy()


def _ref_ids(page, keys, nparts):
    return np.asarray(RSPOOL._pallas_part_ids(
        page, keys, _ref_luts(page, keys), nparts, interpret=True))


@pytest.mark.parametrize("nparts", NPARTS)
@pytest.mark.parametrize("keys", FAMILIES)
def test_k4_twin_equals_the_pallas_kernel_per_key_family(keys, nparts):
    ref, port = _pages(KEY_COLUMNS, KEY_TYPES)
    cuda.reset_counts()
    got = _port_ids(port, keys, nparts)
    assert cuda.plain_calls["part_ids"] == 1
    assert not cuda.launches  # the CPU tensor took the twin
    want = _ref_ids(ref, keys, nparts)
    assert got.dtype == np.int32 and want.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nparts", NPARTS)
@pytest.mark.parametrize("cols", [1, 2, 3])
def test_k4_twin_equals_the_pallas_kernel_on_random_keys(cols, nparts):
    (ref, port), keys = _random_pages(cols)
    got = _port_ids(port, keys, nparts)
    assert np.array_equal(got, _ref_ids(ref, keys, nparts))
    assert got.min() >= 0 and got.max() < nparts


@pytest.mark.parametrize("keys", FAMILIES)
def test_row_hashes_equal_the_reference_bit_for_bit(keys):
    ref, port = _pages(KEY_COLUMNS, KEY_TYPES)
    want = RSPOOL.row_hash_u64(jax.device_get(ref), keys)
    assert np.array_equal(SPOOL.row_hash_u64(port, keys), want)
    dev = SPOOL.device_row_hash_u64(port, keys,
                                    SPOOL._dict_luts(port, keys))
    assert np.array_equal(dev.numpy().view(np.uint64), want)
    want_dev = np.asarray(RSPOOL.device_row_hash_u64(
        ref, keys, _ref_luts(ref, keys)))
    assert np.array_equal(dev.numpy().view(np.uint64), want_dev)


def test_tpch_dictionary_values_hash_like_the_reference():
    """The LUT hashes repr() of each dictionary VALUE: the port's TPC-H
    dictionaries must hold the same Python values as the reference's
    (a numpy scalar would repr differently)."""
    port = TpchConnector(0.001, device="cpu")
    ref = RefConnector(0.001)
    for table, col in (("nation", "n_name"), ("customer", "c_mktsegment"),
                       ("orders", "o_orderpriority"),
                       ("customer", "c_name")):
        pd = port.page_for_split(port.splits(table, 1 << 20)[0],
                                 [col]).block(0).dictionary
        rd = ref.page_for_split(ref.splits(table, 1 << 20)[0],
                                [col]).block(0).dictionary
        assert np.array_equal(SPOOL._dict_value_hashes(pd),
                              RSPOOL._dict_value_hashes(rd)), (table, col)


def _executors(kernels: bool):
    ref = RefExecutor({"tpch": RefConnector(0.001)})
    ref.device_exchange = "true"
    if kernels:
        ref.pallas_join = "force"
    port = Executor({}, device="cpu", kernels=kernels)
    port.device_exchange = "true"
    return ref, port


def _assert_same_partitions(ref_ex, port_ex, ref_page, port_page, keys,
                            nparts):
    r_pairs, r_counts = RSPOOL.device_partition_pages(
        ref_ex, ref_page, keys, nparts, with_counts=True)
    p_pairs, p_counts = SPOOL.device_partition_pages(
        port_ex, port_page, keys, nparts, with_counts=True)
    assert [p for p, _ in p_pairs] == [p for p, _ in r_pairs]
    for (_, rp), (_, pp) in zip(r_pairs, p_pairs):
        assert pp.capacity == rp.capacity
        assert repr(pp.to_pylist()) == repr(rp.to_pylist())
    assert np.array_equal(p_counts, r_counts)
    assert port_ex._overflow_flagged() == bool(ref_ex._overflow_flagged())


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("keys", [(0,), (3,), (0, 1), (0, 1, 2, 3, 4, 5)])
def test_device_partition_pages_equal_the_reference(keys, kernels):
    ref_ex, port_ex = _executors(kernels)
    ref, port = _pages(KEY_COLUMNS, KEY_TYPES)
    cuda.reset_counts()
    _assert_same_partitions(ref_ex, port_ex, ref, port, keys, 4)
    assert cuda.plain_calls["part_ids"] == (1 if kernels else 0)


@pytest.mark.parametrize("kernels", [True, False])
def test_device_partition_pages_random_keys(kernels):
    ref_ex, port_ex = _executors(kernels)
    (ref, port), keys = _random_pages(2)
    _assert_same_partitions(ref_ex, port_ex, ref, port, keys, 3)


@pytest.mark.parametrize("boost", [1, 4])
@pytest.mark.parametrize("kernels", [True, False])
def test_skewed_partition_overflows_like_the_reference(kernels, boost):
    """Every row on one key: the hot partition overflows the landing
    capacity and raises the deferred flag at boost 1; one boost rung up
    it fits (tests/test_device_exchange.py's skew case)."""
    ref_ex, port_ex = _executors(kernels)
    ref_ex._capacity_boost = port_ex._capacity_boost = boost
    ref, port = _pages([[7] * 8192], ["BIGINT"])
    _assert_same_partitions(ref_ex, port_ex, ref, port, (0,), 8)
    cap = SH.exchange_partition_cap(8192, 8, boost)
    assert port_ex._overflow_flagged() == (cap < 8192)


def test_host_tier_partitions_equal_the_reference():
    ref, port = _pages(KEY_COLUMNS, KEY_TYPES)
    for keys in ((0,), (3,), (0, 1)):
        want = RSPOOL.partition_host_page(jax.device_get(ref), keys, 4)
        got = SPOOL.partition_host_page(port, keys, 4)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, gp), (_, wp) in zip(got, want):
            assert gp.capacity == wp.capacity
            assert repr(gp.to_pylist()) == repr(wp.to_pylist())


def test_wrapper_takes_the_twin_only_on_the_cpu():
    enc = torch.arange(12, dtype=torch.int64).reshape(2, 6)
    cuda.reset_counts()
    CP.part_ids(enc, 4)
    assert cuda.plain_calls["part_ids"] == 1 and not cuda.launches
