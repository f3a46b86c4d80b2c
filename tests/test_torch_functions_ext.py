"""The extended scalar builtins (presto_tpu_torch/expr/functions_ext.py):
presto_tpu_torch against presto_tpu.

Every case of tests/test_functions_ext.py runs through both engines on
the same memory table (JSON, URL, numeric-text and NULL rows) and TPC-H
SF 0.001: the port's rows equal the reference engine's and the
reference test's expected values. Also: the two registries hold the
same names (189), the reference's lambda refusals hold, and the
functions run on a TPC-H dictionary column (p_name, p_type)."""

import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.expr import functions as RF
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.expr import functions as F
from presto_tpu_torch.runner import LocalRunner

ROWS = [('{"a": {"b": [1, 2, 3]}, "n": 7, "t": true}',
         'https://user@example.com:8080/p/q?x=1&y=2#frag', 'abc', '17'),
        ('[10, 20]', 'http://h/pp', 'def', '  42 '),
        ('{bad json', 'not a url at all', 'ghi', '3.9'),
        (None, None, None, None)]
COLS = ["j", "u", "s", "num"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    mem = MemoryConnector(device="cpu")
    mem.create_table("t", COLS, [T.VARCHAR] * 4, ROWS)
    return LocalRunner({"mem": mem,
                        "tpch": TpchConnector(0.001, device="cpu")},
                       default_catalog="mem", device="cpu")


@pytest.fixture(scope="module")
def reference():
    mem = RefMemory()
    mem.create_table("t", COLS, [RT.VARCHAR] * 4, ROWS)
    return RefRunner({"mem": mem, "tpch": RefTpch(0.001)},
                     default_catalog="mem")


def both(port, reference, sql):
    got = port.execute(sql).rows
    want = reference.execute(sql).rows
    assert got == want, sql
    return got


def col(port, reference, expr):
    return [r[0] for r in both(port, reference, f"select {expr} from t")]


def one(port, reference, expr):
    return both(port, reference, f"select {expr} from t limit 1")[0][0]


COL_CASES = [
    ("json_extract(j, '$.a.b')", ["[1,2,3]", None, None, None]),
    ("json_extract(j, '$.a')", ['{"b":[1,2,3]}', None, None, None]),
    ("json_extract_scalar(j, '$.n')", ["7", None, None, None]),
    ("json_extract_scalar(j, '$.t')", ["true", None, None, None]),
    ("json_extract_scalar(j, '$.a')", [None, None, None, None]),
    ("json_extract(j, '$[1]')", [None, "20", None, None]),
    ("json_array_length(j)", [None, 2, None, None]),
    ("json_size(j, '$.a')", [1, None, None, None]),
    ("json_size(j, '$.n')", [0, None, None, None]),
    ("json_array_contains(j, 20)", [None, True, None, None]),
    ("try_cast(num as bigint)", [17, 42, None, None]),
    ("try_cast(num as double)", [17.0, 42.0, 3.9, None]),
    ("cast(num as bigint)", [17, 42, None, None]),
    ("url_extract_host(u)", ["example.com", "h", None, None]),
    ("url_extract_port(u)", [8080, None, None, None]),
    ("url_extract_path(u)", ["/p/q", "/pp", "not a url at all", None]),
    ("url_extract_query(u)", ["x=1&y=2", "", "", None]),
    ("url_extract_parameter(u, 'y')", ["2", None, None, None]),
    ("starts_with(s, 'ab')", [True, False, False, None]),
]


@pytest.mark.parametrize("expr,want", COL_CASES)
def test_column_functions(port, reference, expr, want):
    assert col(port, reference, expr) == want


ONE_CASES = [
    ("try_cast('2024-02-29' as date)", 19782),
    ("try_cast('zzz' as date)", None),
    ("cast('42' as bigint)", 42),
    ("cast('1.5' as double)", 1.5),
    ("try(1/0)", None),
    ("try(41 + 1)", 42),
    ("bitwise_and(12, 10)", 8),
    ("bitwise_or(12, 10)", 14),
    ("bitwise_xor(12, 10)", 6),
    ("bitwise_not(0)", -1),
    ("bit_count(255)", 8),
    ("bit_count(-1)", 64),
    ("bit_count(255, 8)", 8),
    ("url_encode('a b&c')", "a%20b%26c"),
    ("url_decode('a%20b%26c')", "a b&c"),
    ("array_distinct(array[1, 2, 2, 3, 1])", (1, 2, 3)),
    ("array_sort(array[3, 1, 2])", (1, 2, 3)),
    ("array_join(array[1, 2, 3], '-')", "1-2-3"),
    ("array_position(array[5, 6, 7], 6)", 2),
    ("array_position(array[5, 6, 7], 9)", 0),
    ("array_remove(array[1, 2, 1, 3], 1)", (2, 3)),
    ("slice(array[1, 2, 3, 4], 2, 2)", (2, 3)),
    ("slice(array[1, 2, 3, 4], -2, 2)", (3, 4)),
    ("sequence(1, 5)", (1, 2, 3, 4, 5)),
    ("sequence(5, 1, -2)", (5, 3, 1)),
    ("repeat(7, 3)", (7, 7, 7)),
    ("reverse(array[1, 2, 3])", (3, 2, 1)),
    ("flatten(array[array[1, 2], array[3]])", (1, 2, 3)),
    ("split('a,b,c', ',')", ("a", "b", "c")),
    ("split('a,b,c', ',', 2)", ("a", "b,c")),
    ("map_entries(map(array['a'], array[1]))", (("a", 1),)),
    ("transform(array[1, 2, 3], x -> x * 2)", (2, 4, 6)),
    ("transform(array[1, 2], x -> x + 0.5)", (1.5, 2.5)),
    ("filter(array[1, 2, 3, 4], x -> x > 2)", (3, 4)),
    ("filter(array[1, 2], x -> false)", ()),
    ("any_match(array[1, 2], x -> x > 1)", True),
    ("any_match(array[1, 2], x -> x > 5)", False),
    ("all_match(array[1, 2], x -> x > 0)", True),
    ("all_match(array[1, 2], x -> x > 1)", False),
    ("none_match(array[1, 2], x -> x > 5)", True),
    ("reduce(array[1, 2, 3, 4], 0, (s, x) -> s + x, s -> s)", 10),
    ("reduce(array[2, 3], 1, (s, x) -> s * x, s -> s * 10)", 60),
    ("transform_values(map(array['a','b'], array[1,2]), v -> v * 10)",
     (("a", 10), ("b", 20))),
    ("transform_keys(map(array['a'], array[1]), k -> upper(k))",
     (("A", 1),)),
    ("map_filter(map(array['a','b'], array[1,2]), (k, v) -> v > 1)",
     (("b", 2),)),
    ("transform(array['a', 'b'], x -> upper(x))", ("A", "B")),
    ("md5('abc')", "900150983cd24fb0d6963f7d28e17f72"),
    ("sha256('abc')", "ba7816bf8f01cfea414140de5dae2223"
                      "b00361a396177a9cb410ff61f20015ad"),
    ("to_hex('AB')", "4142"),
    ("from_hex('4142')", "AB"),
    ("to_base64('ab')", "YWI="),
    ("from_base64('YWI=')", "ab"),
    ("chr(65)", "A"),
    ("normalize('Å')", "Å"),
    ("typeof(1)", "bigint"),
    ("typeof(num)", "varchar"),
    ("year(date_parse('2024-02-05', '%Y-%m-%d'))", 2024),
    ("last_day_of_month(date '2024-02-05')", 19782),
]


@pytest.mark.parametrize("expr,want", ONE_CASES)
def test_single_values(port, reference, expr, want):
    assert one(port, reference, expr) == want


def test_json_parse_canonicalizes(port, reference):
    got = col(port, reference, "json_parse(j)")
    assert got[0] == '{"a":{"b":[1,2,3]},"n":7,"t":true}'
    assert got[2] is None  # invalid JSON -> NULL
    assert col(port, reference, "json_format(json_parse(j))")[1] == \
        "[10,20]"


@pytest.mark.parametrize("sql", [
    "select transform(array[1], x -> x + cast(num as bigint)) from t",
    "select transform(sequence(1, 2), "
    "x -> transform(sequence(10, 11), y -> x + y)) from t",
])
def test_lambda_capture_rejected(port, sql):
    with pytest.raises(Exception, match="capture"):
        port.execute(sql)


def test_registries_hold_the_same_names():
    assert sorted(F.registered_names()) == sorted(RF.registered_names())
    assert len(F.registered_names()) == 189


TPCH_CASES = [
    "select p_partkey, starts_with(p_name, 'b'), to_hex(p_brand), "
    "split(p_type, ' ', 2), bitwise_and(p_partkey, 7), bit_count(p_size) "
    "from tpch.part order by p_partkey",
    "select p_partkey, transform(split(p_type, ' '), x -> lower(x)), "
    "any_match(split(p_name, ' '), x -> x = 'red') "
    "from tpch.part order by p_partkey",
    "select p_partkey, try_cast(substr(p_name, 1, 1) as bigint), "
    "url_encode(p_name), md5(p_container) from tpch.part "
    "order by p_partkey",
]


@pytest.mark.parametrize("sql", TPCH_CASES)
def test_tpch_dictionaries(port, reference, sql):
    assert both(port, reference, sql)
