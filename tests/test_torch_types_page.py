"""presto_tpu_torch types and pages against presto_tpu: the same host
values build pages in both engines that decode to the same rows, for
every type of tests/test_page.py the slice carries (integers, booleans,
doubles, short and long decimals, dates, varchar dictionaries, NULLs).
Integers and decimals compare exactly."""

import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.page import Page as RPage
from presto_tpu_torch import interop
from presto_tpu_torch import types as T
from presto_tpu_torch.page import Dictionary, Page


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once, and torch's default of one thread per core spins
    against the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


rng = np.random.default_rng(20261016)

CASES = {
    "bigint": ([1, -2, None, 2**63 - 1, -(2**63)], "bigint"),
    "integer": ([7, None, -(2**31), 2**31 - 1], "integer"),
    "smallint": ([1, -3, None], "smallint"),
    "tinyint": ([5, None, -128], "tinyint"),
    "boolean": ([True, False, None, True], "boolean"),
    "double": ([1.5, None, -0.0, 2.5e300], "double"),
    "short_decimal": ([12345, -99, None, 10**17], "decimal(12,2)"),
    "long_decimal": ([10**25 + 7, -(10**30), None, 42], "decimal(38,2)"),
    "date": ([0, 10561, None, -719468], "date"),
    "varchar": (["apple", "banana", None, "apple"], "varchar"),
    "varchar1": (["A", "R", "N", None], "varchar(1)"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_from_arrays_decodes_like_reference(name):
    vals, type_text = CASES[name]
    ref = RPage.from_arrays([vals], [RT.parse_type(type_text)])
    port = Page.from_arrays([vals], [T.parse_type(type_text)])
    assert port.capacity == ref.capacity
    assert port.to_pylist() == ref.to_pylist() == [(v,) for v in vals]


@pytest.mark.parametrize("name", sorted(CASES))
def test_interop_roundtrip_of_reference_page(name):
    vals, type_text = CASES[name]
    ref = RPage.from_arrays([vals, list(range(len(vals)))],
                            [RT.parse_type(type_text), RT.BIGINT])
    port = interop.page_from_numpy(**interop.page_arrays(ref))
    assert port.to_pylist() == ref.to_pylist()
    # and back: the port page's arrays equal the reference page's
    a, b = interop.page_arrays(port), interop.page_arrays(ref)
    for x, y in zip(a["columns"], b["columns"]):
        if isinstance(x, tuple):
            assert all(np.array_equal(p, q) for p, q in zip(x, y))
        else:
            assert np.array_equal(x, y)
    assert a["types"] == b["types"]


def test_every_device_dtype_matches_reference_numpy_dtype():
    for text in ("bigint", "integer", "smallint", "tinyint", "double",
                 "real", "boolean", "date", "decimal(12,2)", "varchar",
                 "timestamp"):
        assert T.parse_type(text).numpy_dtype == \
            RT.parse_type(text).numpy_dtype, text
        assert str(T.parse_type(text)) == str(RT.parse_type(text))


def test_seeded_mixed_page_with_nulls_and_padding():
    n = 37
    ints = rng.integers(-(2**40), 2**40, n).tolist()
    ints[3] = None
    decs = rng.integers(-(10**12), 10**12, n).tolist()
    decs[5] = None
    strs = [str(x) for x in rng.choice(["x", "y", "zz"], n)]
    strs[7] = None
    types = ["bigint", "decimal(15,2)", "varchar"]
    ref = RPage.from_arrays([ints, decs, strs],
                            [RT.parse_type(t) for t in types], capacity=64)
    port = Page.from_arrays([ints, decs, strs],
                            [T.parse_type(t) for t in types], capacity=64)
    assert port.capacity == 64
    assert int(port.num_rows()) == n
    assert port.to_pylist() == ref.to_pylist()
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(ref.valid))


def test_dictionary_semantics_match_reference():
    from presto_tpu.page import Dictionary as RDictionary

    vals = ["pear", "apple", "fig", "apple"]
    d, r = Dictionary(vals), RDictionary(vals)
    assert hash(d) == hash(r)
    assert d.code_of("fig") == r.code_of("fig") == 2
    assert d.code_of("nope") == -1
    np.testing.assert_array_equal(d.sort_rank(), r.sort_rank())
    assert d.has_duplicate_values() and r.has_duplicate_values()
    codes = np.array([0, 3, -1, 9])
    assert list(d.decode(codes)) == list(r.decode(codes))


def test_capacity_and_dictionary_errors():
    with pytest.raises(ValueError):
        Page.from_arrays([[1, 2, 3]], [T.BIGINT], capacity=2)
    with pytest.raises(ValueError, match="not in supplied dictionary"):
        Page.from_arrays([["a", "x"]], [T.VARCHAR],
                         dictionaries=[Dictionary(["a", "b"])])


def test_pages_are_torch_tensors_on_the_requested_device():
    page = Page.from_arrays([[1, 2], ["a", None]], [T.BIGINT, T.VARCHAR],
                            device="cpu")
    assert isinstance(page.valid, torch.Tensor)
    assert page.block(0).data.dtype == torch.int64
    assert page.block(1).data.dtype == torch.int32
    assert page.block(1).nulls.tolist()[:2] == [False, True]
