"""The remaining scalar families (presto_tpu_torch/expr/functions_more.py):
presto_tpu_torch against presto_tpu.

Every case of tests/test_functions_more.py runs through both engines:
the port's value equals the reference engine's and the reference
test's expected value (regexp_*, string distances, varbinary codecs
and hashes, shifts with their overflow semantics, URL extractors, array
set algebra, zip/zip_with, map builders; column pairs through the
bounded pair universe). Also: the shifts against a per-value Python
model over every count from -2 to 70, bit_count over seeded values,
the pair universe's size refusal, typed dictionary values through the
wire serde, the functions over TPC-H dictionaries, and every text of
queries.FUNCTIONS_SQL (what chip_smoke.py runs on the card) against
presto_tpu at SF 0.001."""

import hashlib
import hmac

import numpy as np
import pytest
import torch

from presto_tpu.connectors.memory import MemoryConnector as RefMemory
from presto_tpu.connectors.tpch import TpchConnector as RefTpch
from presto_tpu.runner import LocalRunner as RefRunner
from presto_tpu_torch import queries as PQ
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.serde import deserialize_page, serialize_page
from presto_tpu_torch.page import Block, Dictionary, Page
from presto_tpu_torch.runner import LocalRunner


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
    return LocalRunner({"mem": MemoryConnector(device="cpu"),
                        "tpch": TpchConnector(0.001, device="cpu")},
                       default_catalog="mem", device="cpu")


@pytest.fixture(scope="module")
def reference():
    return RefRunner({"mem": RefMemory(), "tpch": RefTpch(0.001)},
                     default_catalog="mem")


def both(port, reference, sql):
    got = port.execute(sql).rows
    want = reference.execute(sql).rows
    assert got == want, sql
    return got


def one(port, reference, sql):
    rows = both(port, reference, sql)
    assert len(rows) == 1 and len(rows[0]) == 1, rows
    return rows[0][0]


CASES = [
    ("select regexp_extract_all('1a22b', '[0-9]+')", ("1", "22")),
    ("select regexp_extract_all('ab12cd', '([a-z])([0-9])', 2)", ("1",)),
    ("select regexp_count('1a2b3', '[0-9]')", 3),
    ("select regexp_position('ab1', '[0-9]')", 3),
    ("select regexp_position('abc', '[0-9]')", -1),
    ("select regexp_split('1a2b', '[ab]')", ("1", "2", "")),
    ("select levenshtein_distance('kitten', 'sitting')", 3),
    ("select hamming_distance('abc', 'abd')", 1),
    ("select hamming_distance('a', 'ab')", None),
    ("select translate('abcda', 'ab', 'x')", "xcdx"),
    ("select soundex('Robert')", "R163"),
    ("select soundex('Rupert')", "R163"),
    ("select luhn_check('79927398713')", True),
    ("select luhn_check('79927398714')", False),
    ("select crc32(to_utf8('abc'))", 891568578),
    ("select from_utf8(to_utf8('héllo'))", "héllo"),
    ("select sha512(to_utf8('abc'))", hashlib.sha512(b"abc").digest()),
    ("select hmac_sha256(to_utf8('msg'), to_utf8('key'))",
     hmac.new(b"key", b"msg", "sha256").digest()),
    ("select hmac_md5(to_utf8('msg'), 'key')",
     hmac.new(b"key", b"msg", "md5").digest()),
    ("select from_big_endian_64(xxhash64(to_utf8('abc')))",
     int.from_bytes(bytes.fromhex("44bc2cf5ad770999"), "big", signed=True)),
    ("select bitwise_left_shift(1, 64)", 0),
    ("select bitwise_right_shift(-1, 64)", 0),
    ("select bitwise_right_shift_arithmetic(-16, 64)", -1),
    ("select bitwise_left_shift(1, 3)", 8),
    ("select bitwise_right_shift(-1, 60)", 15),
    ("select bitwise_right_shift_arithmetic(-16, 2)", -4),
    ("select bit_length('ab')", 16),
    ("select url_extract_host('http://user@h.com:8080/a/b?q=1&r=2#frag')",
     "h.com"),
    ("select url_extract_port('http://user@h.com:8080/a/b?q=1&r=2#frag')",
     8080),
    ("select url_extract_path('http://user@h.com:8080/a/b?q=1&r=2#frag')",
     "/a/b"),
    ("select url_extract_protocol('http://user@h.com:8080/a/b')", "http"),
    ("select url_extract_query('http://h.com/a/b?q=1&r=2#frag')",
     "q=1&r=2"),
    ("select url_extract_fragment('http://h.com/a/b?q=1&r=2#frag')",
     "frag"),
    ("select url_encode('a b/c')", "a%20b%2Fc"),
    ("select url_decode('a%20b')", "a b"),
    ("select array_union(array[1,2,2], array[2,3])", (1, 2, 3)),
    ("select array_intersect(array[1,2], array[2,3])", (2,)),
    ("select array_except(array[1,2], array[2,3])", (1,)),
    ("select arrays_overlap(array[1,2], array[2,9])", True),
    ("select arrays_overlap(array[1,2], array[3])", False),
    ("select zip(array[1,2], array[9])", ((1, 9), (2, None))),
    ("select zip_with(array[1,2], array[10,20], (x, y) -> x + y)",
     (11, 22)),
    ("select map_concat(map(array[1], array[10]), "
     "map(array[1,2], array[11,12]))", ((1, 11), (2, 12))),
    ("select split_to_map('a=1,b=2', ',', '=')", (("a", "1"), ("b", "2"))),
    ("select map_from_entries(map_entries(map(array[5], array[6])))",
     ((5, 6),)),
]


@pytest.mark.parametrize("sql,want", CASES)
def test_single_values(port, reference, sql, want):
    assert one(port, reference, sql) == want


@pytest.mark.parametrize("sql,want", [
    ("select levenshtein_distance(a, b) from ("
     "  select 'abc' a, 'axc' b union all select 'x', 'xyz')", [1, 2]),
    ("select array_union(a, b) from ("
     "  select array[1] a, array[2] b "
     "  union all select array[3], array[3])", [(1, 2), (3,)]),
    ("select hamming_distance(a, b) from ("
     "  select 'abc' a, 'abd' b union all select 'x', 'xyz')", [1, None]),
])
def test_column_pairs(port, reference, sql, want):
    got = [v for (v,) in both(port, reference, sql)]
    assert sorted(got, key=repr) == sorted(want, key=repr)


def _shift_model(kind, x, n):
    """The reference's shift semantics on one value."""
    if kind == "left":
        return 0 if n >= 64 else np.int64(x) << np.int64(max(n, 0))
    if kind == "arith":
        return np.int64(x) >> np.int64(min(max(n, 0), 63))
    if n >= 64:
        return 0
    u = np.uint64(np.int64(x).view(np.uint64)) >> np.uint64(max(n, 0))
    return np.uint64(u).view(np.int64)


@pytest.mark.parametrize("kind,fn", [
    ("left", "bitwise_left_shift"), ("logical", "bitwise_right_shift"),
    ("arith", "bitwise_right_shift_arithmetic")])
def test_shift_counts(port, kind, fn):
    """Every count from -2 to 70 over values with the sign bit set and
    clear: the clamp keeps every device shift in 0..63."""
    xs = [-(1 << 63), -16, -1, 1, 12345678901234, (1 << 63) - 1]
    ns = list(range(-2, 71))
    mem = port.catalogs["mem"]
    mem.create_table("shifts", ["x", "n"], [T.BIGINT, T.BIGINT],
                     [(x, n) for x in xs for n in ns], replace=True)
    got = port.execute(f"select x, n, {fn}(x, n) from shifts").rows
    with np.errstate(over="ignore"):
        for x, n, v in got:
            assert v == int(_shift_model(kind, x, n)), (x, n)


def test_bit_count_seeded(port):
    rng = np.random.default_rng(20261017)
    xs = [int(v) for v in rng.integers(-(1 << 63), (1 << 63) - 1, 64,
                                       dtype=np.int64)]
    xs += [0, -1, -(1 << 63), (1 << 63) - 1]
    mem = port.catalogs["mem"]
    mem.create_table("bits", ["x"], [T.BIGINT], [(x,) for x in xs],
                     replace=True)
    got = port.execute("select x, bit_count(x), bit_count(x, 17) "
                       "from bits").rows
    for x, c64, c17 in got:
        assert c64 == bin(x & ((1 << 64) - 1)).count("1")
        assert c17 == bin(x & ((1 << 17) - 1)).count("1")


def test_pair_universe_refused(port):
    with pytest.raises(TypeError, match="pair universe"):
        port.execute("select levenshtein_distance(o_comment, c_comment) "
                      "from tpch.orders, tpch.customer "
                      "where o_custkey = c_custkey")


def test_serde_preserves_typed_dictionary_values():
    pg = Page(blocks=(
        Block(data=torch.zeros(4, dtype=torch.int32), type=T.VARBINARY,
              dictionary=Dictionary([b"hello"])),
        Block(data=torch.zeros(4, dtype=torch.int32),
              type=T.ArrayType(T.BIGINT),
              dictionary=Dictionary([(1, 2, None)])),
    ), valid=torch.ones(4, dtype=torch.bool))
    out = deserialize_page(serialize_page(pg))
    assert out.blocks[0].dictionary.values[0] == b"hello"
    assert out.blocks[1].dictionary.values[0] == (1, 2, None)


TPCH_CASES = [
    "select c_custkey, regexp_count(c_phone, '[0-9]'), "
    "regexp_extract_all(c_phone, '[0-9]+'), soundex(c_name), "
    "crc32(to_utf8(c_phone)), luhn_check(regexp_replace(c_phone, '-', ''))"
    " from tpch.customer order by c_custkey",
    "select c_custkey, levenshtein_distance(c_mktsegment, 'BUILDING'), "
    "to_hex(c_mktsegment), bitwise_right_shift(c_custkey, 3), "
    "bitwise_left_shift(c_acctbal_int, 2) from (select c_custkey, "
    "c_mktsegment, cast(c_acctbal as bigint) c_acctbal_int "
    "from tpch.customer) order by c_custkey",
    "select n_nationkey, array_union(split(n_name, 'A'), split(r_name, 'A')),"
    " map_concat(split_to_map('k=' || n_name, ',', '='), "
    "split_to_map('r=' || r_name, ',', '=')) "
    "from tpch.nation, tpch.region where n_regionkey = r_regionkey "
    "order by n_nationkey",
]


@pytest.mark.parametrize("sql", TPCH_CASES)
def test_tpch_dictionaries(port, reference, sql):
    assert both(port, reference, sql)


@pytest.fixture(scope="module")
def tpch_pair():
    return (LocalRunner({"tpch": TpchConnector(0.001, device="cpu")},
                        session={"page_rows": 1 << 12}, device="cpu"),
            RefRunner({"tpch": RefTpch(0.001)}, page_rows=1 << 12))


@pytest.mark.parametrize("name", sorted(PQ.FUNCTIONS_SQL))
def test_chip_function_texts(tpch_pair, name):
    """The texts chip_smoke.py runs on the card (queries.FUNCTIONS_SQL):
    the port's rows equal presto_tpu's as multisets."""
    sql = PQ.FUNCTIONS_SQL[name]
    got, want = (sorted(r.execute(sql).rows, key=repr) for r in tpch_pair)
    assert got and got == want
