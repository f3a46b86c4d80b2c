"""K1 — the segmented-sum aggregation kernel's plain twin
(presto_tpu_torch.ops.cuda_agg) against presto_tpu's Pallas kernel run in
interpret mode (ops/pallas_agg.py) and against ops/agg.aggregate, plus the
port's grouping paths (ops/agg.py) against the reference's. All exact.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against this same plain twin at the main path's shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.ops import agg as RA
from presto_tpu.ops import pallas_agg as RPA
from presto_tpu_torch import cuda
from presto_tpu_torch.ops import agg as A
from presto_tpu_torch.ops import cuda_agg as CA


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once, and torch's default of one thread per core spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both_sums(vals, ids, groups):
    got = CA.segmented_sum_i64(torch.from_numpy(vals), torch.from_numpy(ids),
                               groups).numpy()
    want = np.asarray(RPA.segmented_sum_i64(
        jnp.asarray(vals), jnp.asarray(ids), groups, interpret=True))
    return got, want


def _oracle_sum(vals, ids, groups):
    out = [0] * groups
    for g, v in zip(ids, vals):
        if 0 <= g < groups:
            out[g] += int(v)
    wrap = [((x + 2**63) % 2**64) - 2**63 for x in out]
    return np.array(wrap, dtype=np.int64)


def test_seeded_case_of_the_pallas_smoke_tool():
    # tools/pallas_smoke.py: values +-2^40, group 13 deliberately empty
    rng = np.random.default_rng(18)
    n, groups = 3000, 97
    ids = rng.integers(0, groups, n)
    ids[ids == 13] = 14
    vals = rng.integers(-(1 << 40), 1 << 40, n)
    got, want = _both_sums(vals, ids, groups)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle_sum(vals, ids, groups))
    assert got[13] == 0
    cgot = CA.segmented_count(torch.from_numpy(ids), groups).numpy()
    cwant = np.asarray(RPA.segmented_count(jnp.asarray(ids), groups,
                                           interpret=True))
    np.testing.assert_array_equal(cgot, cwant)
    np.testing.assert_array_equal(cgot, np.bincount(ids, minlength=groups))


def test_wraparound_sums_near_int64_limits():
    big, small = 2**63 - 1, -(2**63)
    vals = np.array([big, big, 5, small, small, -7, big, 1], dtype=np.int64)
    ids = np.array([0, 0, 0, 1, 1, 1, 2, 2])
    got, want = _both_sums(vals, ids, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle_sum(vals, ids, 3))


def test_ids_outside_range_drop():
    rng = np.random.default_rng(5)
    ids = rng.integers(-3, 12, 700)
    vals = rng.integers(-(1 << 50), 1 << 50, 700)
    got, want = _both_sums(vals, ids, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle_sum(vals, ids, 8))


@pytest.mark.parametrize("groups", [1, 4, 4096])
def test_group_counts(groups):
    rng = np.random.default_rng(groups)
    n = 2500
    ids = rng.integers(0, groups + 1, n)  # id == groups drops
    vals = rng.integers(-(1 << 40), 1 << 40, n)
    got, want = _both_sums(vals, ids, groups)
    np.testing.assert_array_equal(got, want)
    cgot = CA.segmented_count(torch.from_numpy(ids), groups).numpy()
    cwant = np.asarray(RPA.segmented_count(jnp.asarray(ids), groups,
                                           interpret=True))
    np.testing.assert_array_equal(cgot, cwant)


def _mask(kind, rng, n):
    if kind == "none":
        return None
    if kind == "all_out":
        return np.zeros(n, dtype=bool)
    return rng.random(n) < 0.7


def _reference_pass(vals, ids, mask, groups):
    """The reference's (sum, count) per group, fed the ``cids`` that
    pallas_agg.aggregate forms from the mask and the ids."""
    contributing = np.ones(len(vals), bool) if mask is None else mask
    cids = jnp.where(jnp.asarray(contributing), jnp.asarray(ids),
                     groups).astype(jnp.int32)
    return (np.asarray(RPA.segmented_sum_i64(jnp.asarray(vals), cids, groups,
                                             interpret=True)),
            np.asarray(RPA.segmented_count(cids, groups, interpret=True)))


@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("mask", ["none", "random", "all_out"])
@pytest.mark.parametrize("id_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("groups", [1, 8, 4096])
def test_one_pass_sums_and_counts_match_reference(groups, id_dtype, mask,
                                                  order):
    # the kernel's signature: raw ids (int64 or int32, some outside
    # [0, G)), a row mask, values over the whole int64 range (every sum
    # wraps), sums and counts from one call
    rng = np.random.default_rng(groups + 10 * (id_dtype == np.int32))
    n = 1500
    ids = rng.integers(-3, groups + 3, n).astype(id_dtype)
    if order == "sorted":
        ids = np.sort(ids)
    vals = rng.integers(-2**63, 2**63, n, dtype=np.int64)
    m = _mask(mask, rng, n)
    sums, counts = CA.segsum(torch.from_numpy(ids), torch.from_numpy(vals),
                             None if m is None else torch.from_numpy(m),
                             groups)
    want_sums, want_counts = _reference_pass(vals, ids, m, groups)
    np.testing.assert_array_equal(sums.numpy(), want_sums)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    keep = np.ones(n, bool) if m is None else m
    np.testing.assert_array_equal(
        sums.numpy(), _oracle_sum(vals[keep], ids[keep], groups))
    if mask == "all_out":
        assert not sums.numpy().any() and not counts.numpy().any()
    # counts alone, and sums alone, are the same function's halves
    only_counts = CA.segsum(torch.from_numpy(ids), None,
                            None if m is None else torch.from_numpy(m),
                            groups)
    assert only_counts[0] is None
    np.testing.assert_array_equal(only_counts[1].numpy(), want_counts)
    only_sums = CA.segsum(torch.from_numpy(ids), torch.from_numpy(vals),
                          None if m is None else torch.from_numpy(m),
                          groups, counts=False)
    assert only_sums[1] is None
    np.testing.assert_array_equal(only_sums[0].numpy(), want_sums)


@pytest.mark.parametrize("mask", ["none", "random", "all_out"])
def test_ungrouped_pass_matches_reference(mask):
    # no ids: every contributing row in group 0 (the global aggregate)
    rng = np.random.default_rng(77)
    n = 900
    vals = rng.integers(-2**63, 2**63, n, dtype=np.int64)
    m = _mask(mask, rng, n)
    sums, counts = CA.segsum(None, torch.from_numpy(vals),
                             None if m is None else torch.from_numpy(m), 1)
    want_sums, want_counts = _reference_pass(vals, np.zeros(n, np.int64), m,
                                             1)
    np.testing.assert_array_equal(sums.numpy(), want_sums)
    np.testing.assert_array_equal(counts.numpy(), want_counts)


def test_plain_path_counts_dispatches_not_launches():
    cuda.reset_counts()
    CA.segmented_count(torch.zeros(10, dtype=torch.int32), 2)
    assert cuda.plain_calls["segsum"] == 1
    assert cuda.launches["segsum"] == 0


def _groups_pair(kind_path, rng, n=600, cap=64):
    """Identical group assignments in both packages."""
    valid = rng.random(n) < 0.85
    if kind_path == "dense":
        gid = rng.integers(0, 6, n)
        gid[gid == 4] = 5  # group 4 empty
        ref = RA.compute_groups_dense(jnp.asarray(gid), jnp.asarray(valid),
                                      6, out_capacity=8)
        port = A.compute_groups_dense(torch.from_numpy(gid),
                                      torch.from_numpy(valid), 6,
                                      out_capacity=8)
        return ref, port, 8
    keys = rng.integers(0, 40, n).astype(np.int64)
    knull = rng.random(n) < 0.1
    args_r = ([jnp.asarray(keys).astype(jnp.uint64)], [jnp.asarray(knull)],
              jnp.asarray(valid), cap)
    args_p = ([torch.from_numpy(keys)], [torch.from_numpy(knull)],
              torch.from_numpy(valid), cap)
    if kind_path == "sorted":
        return (RA.compute_groups_sorted(*args_r),
                A.compute_groups_sorted(*args_p), cap)
    return (RA.compute_groups_hashed(*args_r),
            A.compute_groups_hashed(*args_p), cap)


@pytest.mark.parametrize("path", ["dense", "sorted", "hashed"])
def test_grouping_paths_match_reference(path):
    ref, port, cap = _groups_pair(path, np.random.default_rng(11))
    for field in ("group_ids", "row_valid", "rep_index", "group_valid"):
        np.testing.assert_array_equal(
            getattr(port, field).numpy(), np.asarray(getattr(ref, field)),
            err_msg=field)
    assert int(port.num_groups) == int(ref.num_groups)
    assert bool(port.overflow) == bool(ref.overflow)


@pytest.mark.parametrize("path", ["dense", "sorted", "hashed"])
@pytest.mark.parametrize("kind", [A.SUM, A.COUNT, A.COUNT_STAR, A.BOOL_OR,
                                  A.BOOL_AND, A.MIN, A.MAX, A.ANY])
def test_aggregate_sql_semantics_match_reference(path, kind):
    rng = np.random.default_rng(23)
    ref, port, cap = _groups_pair(path, rng)
    n = ref.row_valid.shape[0]
    data = (rng.random(n) < 0.5 if kind in (A.BOOL_OR, A.BOOL_AND)
            else rng.integers(-(1 << 45), 1 << 45, n))
    # all-null values in one group: SUM -> NULL, COUNT -> 0
    nulls = (rng.random(n) < 0.3) | (np.asarray(ref.group_ids) == 2)
    rd, rn = jnp.asarray(data), jnp.asarray(nulls)
    pd_, pn = torch.from_numpy(data), torch.from_numpy(nulls)
    if kind == A.COUNT_STAR:  # no input column, as the executor calls it
        rd = rn = pd_ = pn = None
    want_pallas = RPA.aggregate(ref, kind, cap, rd, rn, interpret=True)
    want_plain = RA.aggregate(ref, kind, cap, rd, rn)
    got = CA.aggregate(port, kind, cap, pd_, pn)
    gv = np.asarray(port.group_valid)
    for want in (want_pallas, want_plain):
        w_null = (np.zeros(cap, bool) if want[1] is None
                  else np.asarray(want[1]))
        g_null = (np.zeros(cap, bool) if got[1] is None
                  else got[1].numpy())
        np.testing.assert_array_equal(g_null[gv], w_null[gv])
        live = gv & ~w_null
        np.testing.assert_array_equal(got[0].numpy()[live],
                                      np.asarray(want[0])[live])


@pytest.mark.parametrize("path,dispatches", [("dense", 2), ("sorted", 3)])
def test_states_without_nulls_share_one_group_count(path, dispatches):
    # the executor's dense path (sizes given) rebuilds the keys from the
    # group id, so it scatters no representative rows, and its valid-row
    # counts serve every state without nulls; other paths count once
    rng = np.random.default_rng(41)
    n, cap = 600, 8
    gid = rng.integers(0, 6, n)
    valid = rng.random(n) < 0.85
    data = rng.integers(-(1 << 45), 1 << 45, n)
    ref = RA.compute_groups_dense(jnp.asarray(gid), jnp.asarray(valid), 6,
                                  out_capacity=cap)
    if path == "dense":
        port = A.compute_groups_dense(torch.from_numpy(gid),
                                      torch.from_numpy(valid), 6,
                                      out_capacity=cap, sizes=(2, 3))
        assert port.rep_index is None
    else:
        port = A.compute_groups_sorted([torch.from_numpy(gid)], [None],
                                       torch.from_numpy(valid), cap)
        assert port.valid_counts is None
    gv = np.asarray(ref.group_valid)
    np.testing.assert_array_equal(port.group_valid.numpy(), gv)
    cuda.reset_counts()
    for kind in (A.COUNT_STAR, A.COUNT, A.SUM, A.SUM):
        with_data = kind != A.COUNT_STAR
        got = CA.aggregate(port, kind, cap,
                           torch.from_numpy(data) if with_data else None)
        want = RA.aggregate(ref, kind, cap,
                            jnp.asarray(data) if with_data else None)
        np.testing.assert_array_equal(got[0].numpy()[gv],
                                      np.asarray(want[0])[gv])
    assert cuda.plain_calls["segsum"] == dispatches


@pytest.mark.parametrize("path", ["dense", "sorted"])
def test_states_with_nulls_take_one_dispatch_each(path):
    # the sum and the count of the contributing rows come from one pass:
    # COUNT, SUM and BOOL_OR over a column with nulls, one call each
    rng = np.random.default_rng(43)
    ref, port, cap = _groups_pair(path, rng)
    n = ref.row_valid.shape[0]
    ints = rng.integers(-(1 << 45), 1 << 45, n)
    bools = rng.random(n) < 0.5
    nulls = rng.random(n) < 0.3
    gv = np.asarray(port.group_valid)
    cuda.reset_counts()
    for kind, data in ((A.COUNT, ints), (A.SUM, ints), (A.BOOL_OR, bools)):
        got = CA.aggregate(port, kind, cap, torch.from_numpy(data),
                           torch.from_numpy(nulls))
        want = RPA.aggregate(ref, kind, cap, jnp.asarray(data),
                             jnp.asarray(nulls), interpret=True)
        w_null = (np.zeros(cap, bool) if want[1] is None
                  else np.asarray(want[1]))
        g_null = np.zeros(cap, bool) if got[1] is None else got[1].numpy()
        np.testing.assert_array_equal(g_null[gv], w_null[gv])
        live = gv & ~w_null
        np.testing.assert_array_equal(got[0].numpy()[live],
                                      np.asarray(want[0])[live])
    assert cuda.plain_calls["segsum"] == 3


def test_a_sum_shares_its_valid_counts_with_later_states():
    # a SUM without nulls on the sorted path counts the valid rows in its
    # own pass, and COUNT(*) and COUNT after it reuse them
    rng = np.random.default_rng(47)
    ref, port, cap = _groups_pair("sorted", rng)
    n = ref.row_valid.shape[0]
    data = rng.integers(-(1 << 45), 1 << 45, n)
    gv = np.asarray(port.group_valid)
    cuda.reset_counts()
    for kind in (A.SUM, A.SUM, A.COUNT_STAR, A.COUNT):
        with_data = kind != A.COUNT_STAR
        got = CA.aggregate(port, kind, cap,
                           torch.from_numpy(data) if with_data else None)
        want = RA.aggregate(ref, kind, cap,
                            jnp.asarray(data) if with_data else None)
        np.testing.assert_array_equal(got[0].numpy()[gv],
                                      np.asarray(want[0])[gv])
    assert cuda.plain_calls["segsum"] == 2


@pytest.mark.parametrize("kind", [A.SUM, A.COUNT, A.COUNT_STAR, A.BOOL_OR,
                                  A.BOOL_AND])
@pytest.mark.parametrize("empty", [False, True])
def test_global_aggregate_matches_reference(kind, empty):
    rng = np.random.default_rng(31)
    n = 500
    valid = (rng.random(n) < 0.7) & (not empty)
    data = (rng.random(n) < 0.5 if kind in (A.BOOL_OR, A.BOOL_AND)
            else rng.integers(-(1 << 60), 1 << 60, n))
    nulls = rng.random(n) < 0.2
    want = RA.global_aggregate(kind, jnp.asarray(valid), jnp.asarray(data),
                               jnp.asarray(nulls))
    got = CA.global_aggregate(kind, torch.from_numpy(valid),
                              torch.from_numpy(data),
                              torch.from_numpy(nulls))
    assert bool(got[1]) == bool(want[1])
    if not bool(want[1]):
        assert int(got[0]) == int(want[0])


@pytest.mark.parametrize("kind", [A.SUM, A.COUNT, A.COUNT_STAR, A.BOOL_OR])
def test_global_states_take_one_dispatch(kind):
    rng = np.random.default_rng(53)
    n = 400
    valid = rng.random(n) < 0.7
    data = (rng.random(n) < 0.5 if kind == A.BOOL_OR
            else rng.integers(-(1 << 60), 1 << 60, n))
    nulls = rng.random(n) < 0.2
    cuda.reset_counts()
    got = CA.global_aggregate(kind, torch.from_numpy(valid),
                              torch.from_numpy(data), torch.from_numpy(nulls))
    want = RA.global_aggregate(kind, jnp.asarray(valid), jnp.asarray(data),
                               jnp.asarray(nulls))
    assert cuda.plain_calls["segsum"] == 1
    assert bool(got[1]) == bool(want[1])
    assert int(got[0]) == int(want[0])


def test_unsupported_shapes_route_to_the_segment_ops():
    assert CA.supported(A.SUM, 4096, torch.zeros(3, dtype=torch.int64))
    assert not CA.supported(A.SUM, 4097, torch.zeros(3, dtype=torch.int64))
    assert not CA.supported(A.SUM, 8, torch.zeros(3))  # float SUM
    assert not CA.supported(A.SUM, 8, (torch.zeros(3), torch.zeros(3)))
    assert not CA.supported(A.MIN, 8, torch.zeros(3, dtype=torch.int64))
    for k in (A.SUM, A.COUNT, A.COUNT_STAR, A.BOOL_OR, A.BOOL_AND):
        assert RPA.supported(k, 16, jnp.zeros(3, jnp.int64)) == \
            CA.supported(k, 16, torch.zeros(3, dtype=torch.int64))


def test_merge_kinds_match_reference():
    assert A.MERGE_KIND == RA.MERGE_KIND
