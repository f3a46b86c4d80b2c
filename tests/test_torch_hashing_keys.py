"""presto_tpu_torch hashing, key encodings, sorts and compaction against
presto_tpu, bit for bit. Port hashes and u64 keys are int64 bit-views;
they compare to the reference's uint64 arrays through a uint64 view."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import types as RT
from presto_tpu.ops import compact as RC
from presto_tpu.ops import hashing as RH
from presto_tpu.ops import keys as RK
from presto_tpu.ops import sort as RS
from presto_tpu.page import Dictionary as RDictionary
from presto_tpu.page import Page as RPage
from presto_tpu_torch import interop
from presto_tpu_torch.ops import compact as C
from presto_tpu_torch.ops import hashing as H
from presto_tpu_torch.ops import keys as K
from presto_tpu_torch.ops import sort as S
from presto_tpu_torch.ops import u64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once, and torch's default of one thread per core spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EDGE = np.array([0, 1, -1, 2**63 - 1, -(2**63), -2, 12345], dtype=np.int64)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _values(seed=0, n=200):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        EDGE, rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)])


@pytest.mark.parametrize("seed", [0, 97, 2**32 + 5])
def test_xxhash64_matches_host_and_reference(seed):
    vals = _values(seed)
    got = _u64(H.xxhash64_u64(torch.from_numpy(vals), seed=seed))
    want = np.asarray(RH.xxhash64_u64(jnp.asarray(vals), seed=seed))
    np.testing.assert_array_equal(got, want)
    for v, g in zip(vals[:20], got[:20]):
        assert int(g) == RH.xxhash64_host(
            int(v).to_bytes(8, "little", signed=True), seed)


def test_xxhash64_of_poison_and_host_long_inputs():
    poison = torch.tensor([u64.POISON], dtype=torch.int64)
    assert int(_u64(H.xxhash64_u64(poison))[0]) == int(
        np.asarray(RH.xxhash64_u64(jnp.asarray(
            np.array([0xFFFFFFFFFFFFFFFF], np.uint64))))[0])
    for data in (b"", b"abc", bytes(range(40)), b"x" * 97):
        assert H.xxhash64_host(data, 7) == RH.xxhash64_host(data, 7)


def test_combine_hash_columns_and_checksum():
    rng = np.random.default_rng(1)
    a, b = _values(1, 60), _values(2, 60)
    nulls = rng.random(len(a)) < 0.3
    got = H.hash_columns([torch.from_numpy(a), torch.from_numpy(b)],
                         [torch.from_numpy(nulls), None])
    want = RH.hash_columns(
        [jnp.asarray(a).astype(jnp.uint64), jnp.asarray(b).astype(jnp.uint64)],
        [jnp.asarray(nulls), None])
    np.testing.assert_array_equal(_u64(got), np.asarray(want))
    valid = rng.random(len(a)) < 0.8
    assert int(_u64(H.checksum(got, torch.from_numpy(valid))[None])[0]) == \
        int(RH.checksum(want, jnp.asarray(valid)))
    h = H.combine_hash(torch.tensor([7]), torch.tensor([5]))
    assert int(h) == 7 * 31 + 5


def _block_pair(type_text, vals, dictionary=None):
    rt = RT.parse_type(type_text)
    ref = RPage.from_arrays([vals], [rt], dictionaries=(
        None if dictionary is None else [RDictionary(dictionary)]))
    port = interop.page_from_numpy(**interop.page_arrays(ref))
    return ref.block(0), port.block(0)


BLOCKS = {
    "bigint": ("bigint", [5, -1, None, 2**63 - 1, -(2**63), 0]),
    "integer": ("integer", [7, -(2**31), None, 2**31 - 1]),
    "date": ("date", [0, 10561, None, -5]),
    "double": ("double", [1.5, -0.0, 0.0, float("nan"), None,
                          float("-inf"), -2.25]),
    "boolean": ("boolean", [True, None, False]),
    "decimal": ("decimal(12,2)", [12345, -99, None, 10**17]),
    "long_decimal": ("decimal(38,2)", [10**25 + 7, -(10**30), None, -1]),
    "varchar": ("varchar", ["b", "a", None, "c", "a"]),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_equality_encoding_matches_reference(name):
    rb, pb = _block_pair(*BLOCKS[name])
    got = K.equality_encoding(pb)
    want = RK.equality_encoding(rb)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u64(g), np.asarray(w))


def test_equality_encoding_canonicalizes_duplicate_dictionary_values():
    rb, pb = _block_pair("varchar", ["x", "y", "x2", None],
                         dictionary=["x", "y", "x2", "x"])
    rb.data = jnp.asarray(np.array([3, 1, 0, 2], np.int32))
    pb.data = torch.tensor([3, 1, 0, 2], dtype=torch.int32)
    np.testing.assert_array_equal(_u64(K.equality_encoding(pb)[0]),
                                  np.asarray(RK.equality_encoding(rb)[0]))


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("nulls_first", [True, False])
def test_order_encoding_and_packing_match_reference(name, ascending,
                                                    nulls_first):
    rb, pb = _block_pair(*BLOCKS[name])
    got = K.order_encoding_parts(pb, ascending=ascending,
                                 nulls_first=nulls_first)
    want = RK.order_encoding_parts(rb, ascending=ascending,
                                   nulls_first=nulls_first)
    assert [b for _, b in got] == [b for _, b in want]
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(_u64(g), np.asarray(w))
    for g, w in zip(K.pack_sort_keys(got), RK.pack_sort_keys(want)):
        np.testing.assert_array_equal(_u64(g), np.asarray(w))


def _mixed_pages(seed=3, n=300, cap=512):
    rng = np.random.default_rng(seed)
    a = rng.integers(-50, 50, n).tolist()
    a[::17] = [None] * len(a[::17])
    d = rng.integers(0, 10**6, n).tolist()
    s = [str(x) for x in rng.choice(["k", "b", "zz", "a"], n)]
    f = rng.normal(size=n).round(1).tolist()
    types = ["bigint", "decimal(12,2)", "varchar", "double"]
    ref = RPage.from_arrays([a, d, s, f], [RT.parse_type(t) for t in types],
                            capacity=cap)
    valid = rng.random(cap) < 0.8
    ref = ref.with_valid(jnp.asarray(valid) & ref.valid)
    return ref, interop.page_from_numpy(**interop.page_arrays(ref))


@pytest.mark.parametrize("keys", [
    [(0, True, None)],
    [(2, True, None), (0, False, True)],
    [(3, False, None), (1, True, None), (2, False, False)],
])
def test_sort_page_matches_reference(keys):
    ref, port = _mixed_pages()
    rkeys = [RS.SortKey(c, a, nf) for c, a, nf in keys]
    pkeys = [S.SortKey(c, a, nf) for c, a, nf in keys]
    np.testing.assert_array_equal(
        S.sort_permutation(port, pkeys).numpy(),
        np.asarray(RS.sort_permutation(ref, rkeys)))
    assert S.sort_page(port, pkeys, limit=25).to_pylist() == \
        RS.sort_page(ref, rkeys, limit=25).to_pylist()
    assert S.limit_page(port, 7, offset=3).to_pylist() == \
        RS.limit_page(ref, 7, offset=3).to_pylist()


def test_compact_gather_concat_slice_match_reference():
    ref, port = _mixed_pages(seed=5)
    for cap in (None, 128, 1024):
        assert C.compact_page(port, cap).to_pylist() == \
            RC.compact_page(ref, cap).to_pylist()
    idx = np.random.default_rng(2).integers(-3, 600, 64)
    valid = np.arange(64) % 3 != 0
    assert C.gather_rows(port, torch.from_numpy(idx),
                         torch.from_numpy(valid)).to_pylist() == \
        RC.gather_rows(ref, jnp.asarray(idx), jnp.asarray(valid)).to_pylist()
    ref2, port2 = _mixed_pages(seed=6, n=100, cap=128)
    got = C.concat_all([port, port2])
    want = RC.concat_all([ref, ref2])
    assert got.to_pylist() == want.to_pylist()
    assert list(got.block(2).dictionary.values) == \
        list(want.block(2).dictionary.values)
    assert C.slice_page(port, 100, 50).to_pylist() == \
        RC.slice_page(ref, 100, 50).to_pylist()


def test_u64_helpers_match_numpy_uint64():
    vals = _values(9)
    u = vals.view(np.uint64)
    t = torch.from_numpy(vals)
    for r in (1, 7, 32, 33, 63):
        np.testing.assert_array_equal(_u64(u64.srl(t, r)), u >> np.uint64(r))
    for m in (1, 3, 10, 20001, 2**40 + 7):
        np.testing.assert_array_equal(u64.umod(t, m).numpy(),
                                      (u % np.uint64(m)).astype(np.int64))
    order = np.argsort(u, kind="stable")
    np.testing.assert_array_equal(
        torch.argsort(u64.order(t), stable=True).numpy(), order)
    np.testing.assert_array_equal(u64.lo32(t).numpy(),
                                  (u & np.uint64(0xFFFFFFFF)).astype(
                                      np.uint32).view(np.int32))
    np.testing.assert_array_equal(u64.hi32(t).numpy(),
                                  (u >> np.uint64(32)).astype(
                                      np.uint32).view(np.int32))
