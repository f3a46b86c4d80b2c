"""K2/K3 — the hash-join range index and probe (presto_tpu_torch.ops.
cuda_join) against presto_tpu's ops/pallas_join.py: ``build_index`` must
yield the same tables, ``perm`` and overflow flag on the same hashes,
and the plain probe the same (start, count) ranges as the Pallas dim and
radix kernels run in interpret mode. Includes the cases of
tests/test_pallas_join.py. All exact.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against this same plain twin at the main path's shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.ops import pallas_join as RPJ
from presto_tpu_torch import cuda
from presto_tpu_torch.ops import cuda_join as CJ


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once, and torch's default of one thread per core spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = np.uint64(0x9E3779B97F4A7C15)
MAXH = np.uint64(0xFFFFFFFFFFFFFFFF)


def _t(a: np.ndarray) -> torch.Tensor:
    """A uint64/int array as the port's int64 bit-view tensor."""
    return torch.from_numpy(np.asarray(a).view(np.int64).copy())


def _flat_ref_tables(tabs, layout):
    if layout[0] == "dim":  # [T, 8, 128] row-replicated -> flat [T * 128]
        return [np.asarray(t)[:, 0, :].reshape(-1) for t in tabs]
    return [np.asarray(t) for t in tabs]


def _check_build_and_probe(bhash, bvalid, phash, layout):
    rtabs, rperm, rovf = RPJ.build_index(jnp.asarray(bhash),
                                         jnp.asarray(bvalid), layout)
    tabs, perm, ovf = CJ.build_index(_t(bhash), torch.from_numpy(bvalid),
                                     layout)
    assert bool(ovf) == bool(rovf)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))
    for got, want in zip(tabs, _flat_ref_tables(rtabs, layout)):
        np.testing.assert_array_equal(got.numpy(), want)
    rstart, rcnt = RPJ.probe_index(jnp.asarray(phash), rtabs, layout,
                                   interpret=True)
    start, cnt = CJ.probe_index(_t(phash), CJ.pack_tables(tabs), layout)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt))
    np.testing.assert_array_equal(start.numpy(), np.asarray(rstart))
    return start.numpy(), cnt.numpy(), perm.numpy()


def _ranges_oracle(bhash, bvalid, phash):
    poisoned = np.where(bvalid, bhash, MAXH)
    sh = np.sort(poisoned, kind="stable")
    lo = np.searchsorted(sh, phash, side="left")
    hi = np.searchsorted(sh, phash, side="right")
    return lo.astype(np.int32), (hi - lo).astype(np.int32)


@pytest.mark.parametrize("nb", [5, 25, 2048, 2049, 4096])
def test_build_and_probe_match_reference(nb):
    rng = np.random.default_rng(nb)
    universe = max(nb // 2, 3)  # duplicate keys: segments longer than 1
    bhash = rng.choice(universe, size=nb).astype(np.uint64) * GOLDEN
    bvalid = rng.random(nb) < 0.9  # invalid build rows the probe skips
    phash = np.concatenate([
        rng.choice(universe, size=700).astype(np.uint64) * GOLDEN,
        rng.integers(1, 2**63, size=300, dtype=np.uint64),  # absent keys
    ])
    layout = CJ.plan_layout(nb)
    assert layout == RPJ.plan_layout(nb)
    assert layout[0] == ("dim" if nb <= CJ.DIM_MAX_BUILD else "radix")
    start, cnt, _ = _check_build_and_probe(bhash, bvalid, phash, layout)
    want_lo, want_cnt = _ranges_oracle(bhash, bvalid, phash)
    np.testing.assert_array_equal(cnt, want_cnt)
    hit = want_cnt > 0
    np.testing.assert_array_equal(start[hit], want_lo[hit])
    assert np.all(start[~hit] == -1)


@pytest.mark.parametrize(
    "layout", [("radix", (1, 4096)), ("radix", (4, 1024)), ("dim", 16)])
def test_ranges_on_reference_test_layouts(layout):
    rng = np.random.default_rng(3)
    nb, np_ = 1500, 2048
    bhash = rng.choice(500, size=nb).astype(np.uint64) * GOLDEN
    bvalid = rng.random(nb) < 0.9
    phash = np.concatenate([
        rng.choice(500, size=np_ - 64).astype(np.uint64) * GOLDEN,
        rng.integers(1, 2**63, size=64, dtype=np.uint64)])
    _check_build_and_probe(bhash, bvalid, phash, layout)


def test_colliding_low_bits_resolve_through_chains():
    build = np.arange(0, 64 * 1024, 1024, dtype=np.uint64)  # 64 keys
    probe = np.concatenate([build, build + np.uint64(1)])
    rid, ovf = CJ.join_unique(_t(build), torch.ones(64, dtype=torch.bool),
                              _t(probe), torch.ones(128, dtype=torch.bool))
    rrid, rovf = RPJ.join_unique(jnp.asarray(build), jnp.ones(64, bool),
                                 jnp.asarray(probe), jnp.ones(128, bool),
                                 interpret=True)
    assert not bool(ovf) and not bool(rovf)
    np.testing.assert_array_equal(rid.numpy(), np.asarray(rrid))
    np.testing.assert_array_equal(rid.numpy()[:64], np.arange(64))
    assert np.all(rid.numpy()[64:] == -1)


def test_poison_hash_conflict_raises_overflow():
    bhash = np.array([MAXH, 5, MAXH, 7], dtype=np.uint64)
    bvalid = np.array([True, False, True, True])
    layout = ("radix", (1, 64))
    start, cnt, _ = _check_build_and_probe(
        bhash, bvalid, np.array([MAXH, 7, 6], dtype=np.uint64), layout)
    _, _, ovf = CJ.build_index(_t(bhash), torch.from_numpy(bvalid), layout)
    assert bool(ovf)
    assert cnt[0] == 0 and cnt[1] == 1 and cnt[2] == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_join_unique_matches_reference_and_oracle(seed):
    rng = np.random.default_rng(seed)
    nb, np_ = 1000, 2048
    build = rng.choice(100000, size=nb, replace=False).astype(np.uint64)
    bvalid = rng.random(nb) < 0.9
    probe = rng.choice(100000, size=np_).astype(np.uint64)
    pvalid = rng.random(np_) < 0.95
    rid, ovf = CJ.join_unique(_t(build), torch.from_numpy(bvalid),
                              _t(probe), torch.from_numpy(pvalid))
    rrid, rovf = RPJ.join_unique(jnp.asarray(build), jnp.asarray(bvalid),
                                 jnp.asarray(probe), jnp.asarray(pvalid),
                                 interpret=True)
    assert not bool(ovf) and not bool(rovf)
    np.testing.assert_array_equal(rid.numpy(), np.asarray(rrid))
    lookup = {int(k): i for i, (k, v) in enumerate(zip(build, bvalid)) if v}
    want = [lookup.get(int(k), -1) if v else -1
            for k, v in zip(probe, pvalid)]
    np.testing.assert_array_equal(rid.numpy(), np.array(want, np.int32))


def test_big_key_values_split_into_words():
    rng = np.random.default_rng(7)
    build = np.unique(rng.integers(0, 2**63, size=256, dtype=np.uint64))
    build = np.concatenate([build, np.array([2**64 - 2], np.uint64)])
    nb = len(build)
    probe = np.concatenate([build[: nb // 2],
                            rng.integers(0, 2**63, size=128,
                                         dtype=np.uint64)])
    rid, ovf = CJ.join_unique(_t(build), torch.ones(nb, dtype=torch.bool),
                              _t(probe),
                              torch.ones(len(probe), dtype=torch.bool))
    rrid, _ = RPJ.join_unique(jnp.asarray(build), jnp.ones(nb, bool),
                              jnp.asarray(probe), jnp.ones(len(probe), bool),
                              interpret=True)
    assert not bool(ovf)
    np.testing.assert_array_equal(rid.numpy(), np.asarray(rrid))
    np.testing.assert_array_equal(rid.numpy()[: nb // 2],
                                  np.arange(nb // 2))


def test_mix32_and_split_match_reference():
    vals = np.random.default_rng(9).integers(0, 2**64, 500, dtype=np.uint64)
    lo, hi = CJ._split64(_t(vals))
    rlo, rhi = RPJ._split64(jnp.asarray(vals))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    np.testing.assert_array_equal(
        CJ._mix32(lo, hi).numpy(),
        np.asarray(RPJ._mix32(rlo, rhi)).astype(np.int64))


@pytest.mark.parametrize("nb", [25, 2049])
def test_packed_keys_are_the_slot_hashes(nb):
    # the probe's table: per slot its 64-bit hash (EMPTY_KEY where
    # empty) and its (start, count), from the reference-equal tables
    rng = np.random.default_rng(nb + 1)
    bhash = rng.integers(0, 2**64 - 1, size=nb, dtype=np.uint64)
    bvalid = rng.random(nb) < 0.9
    layout = CJ.plan_layout(nb)
    tabs, _, ovf = CJ.build_index(_t(bhash), torch.from_numpy(bvalid),
                                  layout)
    assert not bool(ovf)
    keys, payload = CJ.pack_tables(tabs)
    lo, hi, start, count = (t.numpy() for t in tabs)
    full = count > 0
    words = (hi.astype(np.int64) << 32) | (lo.astype(np.int64) & 0xFFFFFFFF)
    np.testing.assert_array_equal(keys.numpy()[full], words[full])
    assert np.all(keys.numpy()[~full] == CJ.EMPTY_KEY)
    np.testing.assert_array_equal(np.sort(keys.numpy()[full].view(np.uint64)),
                                  np.unique(bhash[bvalid]))
    np.testing.assert_array_equal(payload.numpy(), np.stack([start, count],
                                                            axis=1))


@pytest.mark.parametrize("layout", [("dim", 1), ("radix", (1, 64))])
def test_probe_of_the_empty_key_misses(layout):
    # a probe hash equal to EMPTY_KEY (the poison hash) meets only empty
    # slots' keys: a miss, as in the reference
    bhash = np.array([3, 5, 7], dtype=np.uint64) * GOLDEN
    bvalid = np.ones(3, bool)
    phash = np.concatenate([[MAXH], bhash[1:2], [MAXH],
                            np.array([4], np.uint64) * GOLDEN])
    start, cnt, _ = _check_build_and_probe(bhash, bvalid, phash, layout)
    assert list(cnt) == [0, 1, 0, 0] and start[0] == -1


def test_visited_reads_a_key_per_step_and_a_payload_per_hit():
    rng = np.random.default_rng(12)
    nb = 500
    bhash = rng.choice(400, size=nb).astype(np.uint64) * GOLDEN
    layout = CJ.plan_layout(nb)
    tabs, _, _ = CJ.build_index(_t(bhash), torch.ones(nb, dtype=torch.bool),
                                layout)
    phash = _t(rng.choice(800, size=3000).astype(np.uint64) * GOLDEN)
    visited = {}
    start, cnt = CJ.probe_plain(phash, CJ.pack_tables(tabs), layout,
                                visited=visited)
    assert sum(len(v) for v in visited["payload"]) == int((cnt > 0).sum())
    assert sum(len(v) for v in visited["keys"]) >= phash.shape[0]


def test_plain_probe_dispatch_counts_per_layout():
    cuda.reset_counts()
    CJ.join_unique(_t(np.arange(10, dtype=np.uint64)),
                   torch.ones(10, dtype=torch.bool),
                   _t(np.arange(20, dtype=np.uint64)),
                   torch.ones(20, dtype=torch.bool))
    assert cuda.plain_calls["probe_dim"] == 1
    assert cuda.launches["probe_dim"] == 0
