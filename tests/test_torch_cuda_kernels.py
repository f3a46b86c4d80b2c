"""The CUDA kernels of presto_tpu_torch against their plain PyTorch twins,
on the card. These tests need a CUDA device and nvcc; without them they
skip. Run them on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest`` where jax is not installed: the suite's conftest
imports it.)
"""

import importlib.util
import pathlib

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("groups", [1, 2, 3, 6, 8, 9, 100, 4096])
def test_segsum_kernel_equals_plain(dev, groups):
    # every tier: 1, 2, 4 and 8 register slots, the shared tier above 8;
    # int64, int32 and sorted ids, with and without a mask, sums and
    # counts together and apart, and inputs off 16-byte alignment
    from presto_tpu_torch.ops import cuda_agg as CA

    gen = torch.Generator().manual_seed(groups)
    n = 100_003
    ids = torch.randint(-2, groups + 2, (n,), generator=gen,
                        dtype=torch.int64)
    vals = torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen,
                         dtype=torch.int64)
    mask = torch.rand(n, generator=gen) < 0.8
    id_cases = [ids, ids.to(torch.int32), torch.sort(ids).values, ids[1:]]
    if groups == 1:
        id_cases.append(None)
    for i in id_cases:
        rows = n if i is None else i.shape[0]
        v, m = vals[n - rows:], mask[n - rows:]
        for mm in (None, m):
            for vv, counts in ((v, True), (v, False), (None, True)):
                if i is None and mm is None and vv is None:
                    continue  # no input gives the rows' number
                got = CA.segsum_cuda(
                    None if i is None else i.to(dev), vv if vv is None
                    else vv.to(dev), None if mm is None else mm.to(dev),
                    groups, counts)
                torch.cuda.synchronize()
                want = CA.segsum_plain(i, vv, mm, groups, counts)
                for g, w in zip(got, want):
                    assert (g is None) == (w is None)
                    if w is not None:
                        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("build_rows", [5, 2048, 2049, 1 << 16])
def test_probe_kernel_equals_plain(dev, build_rows):
    from presto_tpu_torch.ops import cuda_join as CJ
    from presto_tpu_torch.ops import hashing as H

    gen = torch.Generator().manual_seed(build_rows)
    keys = torch.randint(0, 2 * build_rows, (build_rows,), generator=gen,
                         dtype=torch.int64).to(dev)
    valid = (torch.rand(build_rows, generator=gen) < 0.9).to(dev)
    layout = CJ.plan_layout(build_rows)
    tables, _perm, ovf = CJ.build_index(H.xxhash64_u64(keys), valid, layout)
    assert not bool(ovf)
    packed = CJ.pack_tables(tables)
    probe = H.xxhash64_u64(torch.randint(
        0, 4 * build_rows, (100_003,), generator=gen,
        dtype=torch.int64).to(dev))
    # a ragged length, and a view one row off 16-byte alignment
    for ph in (probe, probe[1:]):
        got = CJ.probe_cuda(ph, packed, layout)
        torch.cuda.synchronize()
        want = CJ.probe_plain(ph, packed, layout)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_queries_on_the_card_equal_the_cpu(dev):
    from presto_tpu_torch import cuda
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.runner import LocalRunner

    # by path: this file also runs without the suite's conftest, where a
    # site-installed ``tests`` package may shadow this directory
    spec = importlib.util.spec_from_file_location(
        "tpch_queries", pathlib.Path(__file__).with_name("tpch_queries.py"))
    queries = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(queries)
    QUERIES = queries.QUERIES

    # the materialized joins: with the generated join (the default) no
    # TPC-H join reaches the probe kernels
    session = {"page_rows": 1 << 15, "generated_join_enabled": "false"}
    gpu = LocalRunner({"tpch": TpchConnector(0.01, device=dev)},
                      session=session, device=dev)
    cpu = LocalRunner({"tpch": TpchConnector(0.01, device="cpu")},
                      session=session, device="cpu")
    cuda.reset_counts()
    for q in (1, 3, 5, 6):
        assert gpu.execute(QUERIES[q]).rows == cpu.execute(QUERIES[q]).rows
    for name in ("segsum", "probe_dim", "probe_radix"):
        assert cuda.launches[name] > 0, name


@pytest.mark.parametrize("cols,nparts", [(1, 4), (2, 4), (3, 7)])
def test_part_ids_kernel_equals_plain(dev, cols, nparts):
    from presto_tpu_torch.ops import cuda_part as CP

    gen = torch.Generator().manual_seed(cols * 100 + nparts)
    enc = torch.randint(-(1 << 62), 1 << 62, (cols, 100_003),
                        generator=gen, dtype=torch.int64)
    got = CP.part_ids_cuda(enc.to(dev), nparts)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), CP.part_ids_plain(enc, nparts))


def test_distributed_q3_family_on_the_card_equals_the_cpu(dev):
    from presto_tpu_torch import cuda
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.dist.dcn import DcnRunner
    from presto_tpu_torch.runner import LocalRunner
    from presto_tpu_torch.server.worker import WorkerServer

    sql = ("select o_orderkey, count(*) c from lineitem "
           "join orders on l_orderkey = o_orderkey "
           "where o_orderkey < 1000 group by o_orderkey "
           "order by o_orderkey")
    workers = [WorkerServer({"tpch": TpchConnector(0.01, device=dev)},
                            node_id=f"w{i}", device=dev) for i in range(2)]
    try:
        for w in workers:
            w.start()
        coord = DcnRunner({"tpch": TpchConnector(0.01, device=dev)},
                          [w.uri for w in workers], device=dev,
                          session_props={"join_distribution_type":
                                         "partitioned",
                                         "stage_scheduler": "true"})
        cuda.reset_counts()
        rows = coord.execute(sql)
        assert cuda.launches["part_ids"] > 0
        cpu = LocalRunner({"tpch": TpchConnector(0.01, device="cpu")},
                          device="cpu")
        assert rows == cpu.execute(sql).rows
    finally:
        for w in workers:
            w.stop()


@pytest.mark.parametrize("groups", [1, 8, 100])
def test_segsum_kernel_replays_in_a_cuda_graph(dev, groups):
    """K1 captured into a CUDA graph (exec/graphs.py) and replayed on new
    inputs written into its static buffers equals segsum_plain, and each
    replay adds the captured launch to the count."""
    from presto_tpu_torch import cuda
    from presto_tpu_torch.exec import graphs
    from presto_tpu_torch.ops import cuda_agg as CA

    n = 1 << 16
    ids = torch.zeros(n, dtype=torch.int64, device=dev)
    vals = torch.zeros(n, dtype=torch.int64, device=dev)

    def fn(starts, counts):
        # the inputs live in the program's static buffers: each call
        # derives its rows from the start it was given
        seed = starts[0] * n + torch.arange(n, device=dev)
        ids.copy_(seed % (groups + 2) - 1)
        vals.copy_(seed * 7919 - counts[0])
        return CA.segsum_cuda(ids, vals, None, groups)

    prog = graphs.Program(fn, 1, dev)
    for start in (0, 3, 11):  # the capture, then two replays
        before = cuda.launches["segsum"]
        got = prog([start], [start + 5])
        torch.cuda.synchronize()
        assert cuda.launches["segsum"] == before + 1
        seed = start * n + torch.arange(n)
        want = CA.segsum_plain(seed % (groups + 2) - 1,
                               seed * 7919 - (start + 5), None, groups)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_failed_graph_capture_raises(dev):
    """A fused program that reads the device on the host cannot be
    captured: its first call raises, and nothing runs it op by op in
    its place."""
    from presto_tpu_torch.exec import graphs

    def fn(starts, counts):
        x = starts * 2
        if bool(x.sum() > 0):  # a host read, illegal while capturing
            x = x + 1
        return x

    prog = graphs.Program(fn, 1, dev)
    with pytest.raises(RuntimeError):
        prog([3], [1])
    torch.cuda.synchronize()
    # the card is still usable after the failed capture
    assert torch.equal(graphs.Program(lambda s, c: s + c, 1, dev)(
        [2], [5]).cpu(), torch.tensor([7]))
