"""TPC-H connector: deterministic on-device data generation.

Port of presto_tpu/connectors/tpch.py. Every column is a pure function
of the global row index, computed on the device from counter-based
xxhash64 streams keyed on (table.column, row key), so the generated
values are BIT-IDENTICAL to the reference generator for the same table,
scale and row range — one sqlite oracle serves both engines.

Structural formulas follow the TPC-H spec / dbgen where they matter
(cardinalities, sparse orderkeys, the skip-every-3rd-customer rule,
retail price and extended price, partsupp supplier spread, date windows,
returnflag/linestatus against CURRENTDATE 1995-06-17, value pools).
The randomness differs from C dbgen, as in the reference.

Reference: presto-tpch (TpchConnectorFactory/TpchMetadata/TpchRecordSet).
"""

from __future__ import annotations

import datetime
import functools
import zlib
from typing import Dict, List

import numpy as np
import torch

from presto_tpu_torch import resolve_device
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.base import (
    ColumnSchema,
    Connector,
    GeneratorConnector,
    Split,
    TableSchema,
)
from presto_tpu_torch.ops import u64
from presto_tpu_torch.ops.hashing import xxhash64_u64
from presto_tpu_torch.page import Dictionary

_EPOCH = datetime.date(1970, 1, 1)


def _days(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - _EPOCH).days


STARTDATE = _days(1992, 1, 1)
ENDDATE = _days(1998, 12, 31)
CURRENTDATE = _days(1995, 6, 17)
ORDERDATE_MAX = ENDDATE - 151

DEC = T.DecimalType(12, 2)

MAX_LINES_PER_ORDER = 7


class PatternDictionary(Dictionary):
    """Virtual dictionary for formatted key strings ('Customer#%09d'):
    decodes lazily, so key-name columns never materialize millions of
    strings. Zero-padding makes lexicographic order numeric order, so
    sort_rank is the identity."""

    def __init__(self, prefix: str, count: int, offset: int = 1,
                 width: int = 9):
        self.prefix = prefix
        self.count = count
        self.offset = offset
        self.width = width
        self._materialized = None
        self._hash = hash(("pattern", prefix, count, offset, width))

    def __len__(self) -> int:
        return self.count

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PatternDictionary)
            and (self.prefix, self.count, self.offset, self.width)
            == (other.prefix, other.count, other.offset, other.width)
        )

    @property
    def values(self) -> np.ndarray:
        if self._materialized is None:
            self._materialized = np.array(
                [self.prefix + str(i + self.offset).zfill(self.width)
                 for i in range(self.count)],
                dtype=object,
            )
        return self._materialized

    @property
    def _index(self):
        return _PatternIndex(self)

    def code_of(self, value) -> int:
        try:
            s = str(value)
            if not s.startswith(self.prefix):
                return -1
            i = int(s[len(self.prefix):]) - self.offset
            return i if 0 <= i < self.count else -1
        except (ValueError, TypeError):
            return -1

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(codes.shape, dtype=object)
        flat = codes.reshape(-1)
        res = out.reshape(-1)
        for j, c in enumerate(flat):
            c = int(c)
            if 0 <= c < self.count:
                res[j] = self.prefix + str(c + self.offset).zfill(self.width)
            else:
                res[j] = None
        return out

    def sort_rank(self) -> np.ndarray:
        return np.arange(self.count, dtype=np.int32)

    def has_duplicate_values(self) -> bool:
        return False  # unique by construction, never materialize


class _PatternIndex:
    """Mapping-protocol shim over PatternDictionary.code_of."""

    def __init__(self, d: PatternDictionary):
        self._d = d

    def get(self, value, default=None):
        c = self._d.code_of(value)
        return default if c < 0 else c

    def __contains__(self, value):
        return self._d.code_of(value) >= 0


# ------------------------------------------------------------- value pools

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIP_MODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
SHIP_INSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE",
                 "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow"
).split()

_COMMENT_A = ("carefully quickly furiously slyly blithely fluffily ruthlessly"
              " boldly daringly evenly silently finally ironically sometimes"
              " never always rarely closely").split()
_COMMENT_B = ("special pending final ironic express regular unusual bold even"
              " silent quick careful idle busy").split()
_COMMENT_C = ("requests deposits accounts packages instructions foxes ideas"
              " theodolites pinto beans dependencies excuses platelets"
              " asymptotes courts dolphins").split()


def _lcg_words(n_entries: int, seed: int, pools: List[List[str]]) -> List[str]:
    """Deterministic host-side word-combination strings (comment pools)."""
    state = seed & 0x7FFFFFFF or 1
    out = []
    for _ in range(n_entries):
        words = []
        for pool in pools:
            state = (state * 48271) % 2147483647
            words.append(pool[state % len(pool)])
        out.append(" ".join(words))
    return out


@functools.lru_cache(maxsize=None)
def _comment_dictionary(n_entries: int, seed: int) -> Dictionary:
    return Dictionary(
        _lcg_words(n_entries, seed,
                   [_COMMENT_A, _COMMENT_B, _COMMENT_C, _COMMENT_A,
                    _COMMENT_C])
    )


@functools.lru_cache(maxsize=None)
def _pname_dictionary(n_entries: int = 4096) -> Dictionary:
    state = 7919
    out = []
    for _ in range(n_entries):
        words = []
        for _ in range(5):
            state = (state * 48271) % 2147483647
            w = COLORS[state % len(COLORS)]
            if w not in words:
                words.append(w)
        out.append(" ".join(words))
    return Dictionary(out)


@functools.lru_cache(maxsize=None)
def _type_dictionary() -> Dictionary:
    return Dictionary(
        [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3]
    )


@functools.lru_cache(maxsize=None)
def _container_dictionary() -> Dictionary:
    return Dictionary(
        [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
    )


@functools.lru_cache(maxsize=None)
def _brand_dictionary() -> Dictionary:
    return Dictionary(
        [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]
    )


@functools.lru_cache(maxsize=None)
def _mfgr_dictionary() -> Dictionary:
    return Dictionary([f"Manufacturer#{m}" for m in range(1, 6)])


_PHONE_LOCALS = 400


@functools.lru_cache(maxsize=None)
def _phone_dictionary() -> Dictionary:
    """code = nation_code*_PHONE_LOCALS + local; country code nation+10."""
    state = 104729
    vals = []
    for nation in range(25):
        cc = nation + 10
        st = state + nation
        for _ in range(_PHONE_LOCALS):
            st = (st * 48271) % 2147483647
            a = 100 + st % 900
            st = (st * 48271) % 2147483647
            b = 100 + st % 900
            st = (st * 48271) % 2147483647
            c = 1000 + st % 9000
            vals.append(f"{cc}-{a}-{b}-{c}")
    return Dictionary(vals)


@functools.lru_cache(maxsize=None)
def _address_dictionary(n_entries: int = 1024) -> Dictionary:
    state = 50021
    vals = []
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ,"
    for _ in range(n_entries):
        state = (state * 48271) % 2147483647
        ln = 10 + state % 25
        chars = []
        st = state
        for _ in range(ln):
            st = (st * 48271) % 2147483647
            chars.append(alphabet[st % len(alphabet)])
        vals.append("".join(chars))
    return Dictionary(vals)


# --------------------------------------------------------- random streams

def _stream_seed(table: str, column: str) -> int:
    return zlib.crc32(f"tpch.{table}.{column}".encode())


def _draw(keys: torch.Tensor, table: str, column: str) -> torch.Tensor:
    """u64 stream value (int64 bit-view) per key, independent per
    (table, column)."""
    return xxhash64_u64(keys.to(torch.int64),
                        seed=_stream_seed(table, column))


def _unif(keys, table, column, lo: int, hi: int) -> torch.Tensor:
    """Uniform int64 in [lo, hi] keyed by row key (chunk-independent):
    the UNSIGNED stream value mod the span, as the reference computes."""
    h = _draw(keys, table, column)
    return u64.umod(h, hi - lo + 1) + lo


class _Lazy:
    """Column-pruned generation: entries are thunks evaluated only for
    the requested column set, memoized per page."""

    def __init__(self):
        self._thunks: Dict[str, object] = {}
        self._memo: Dict[str, object] = {}

    def put(self, name: str, thunk):
        self._thunks[name] = thunk

    def get(self, name: str):
        if name not in self._memo:
            self._memo[name] = self._thunks[name]()
        return self._memo[name]

    __getitem__ = get

    def merge(self, other: "_Lazy") -> None:
        """Adopt another lazy's thunks (later put() calls override); their
        memoization stays shared through the adopted thunks' closures."""
        self._thunks.update(other._thunks)


# ------------------------------------------------------------- connector


class TpchConnector(GeneratorConnector, Connector):
    """Reference: presto-tpch TpchConnectorFactory. ``device=None``
    generates on the card (and raises without one)."""

    name = "tpch"

    def __init__(self, scale: float = 1.0, device=None):
        self.scale = scale
        self.device = resolve_device(device)
        self.n_customer = max(int(150_000 * scale), 3)
        self.n_orders = self.n_customer * 10
        self.n_part = max(int(200_000 * scale), 4)
        self.n_supplier = max(int(10_000 * scale), 4)
        self.n_partsupp = self.n_part * 4
        self.n_clerk = max(int(1000 * scale), 10)
        self._schemas = _build_schemas()
        self._dicts = self._build_dictionaries()
        self._region_of_nation = torch.tensor(
            [r for _, r in NATIONS], dtype=torch.int64, device=self.device)

    def _build_dictionaries(self) -> Dict[str, Dict[str, Dictionary]]:
        return {
            "region": {
                "r_name": Dictionary(REGIONS),
                "r_comment": _comment_dictionary(512, 11),
            },
            "nation": {
                "n_name": Dictionary([nm for nm, _ in NATIONS]),
                "n_comment": _comment_dictionary(512, 13),
            },
            "part": {
                "p_name": _pname_dictionary(),
                "p_mfgr": _mfgr_dictionary(),
                "p_brand": _brand_dictionary(),
                "p_type": _type_dictionary(),
                "p_container": _container_dictionary(),
                "p_comment": _comment_dictionary(2048, 17),
            },
            "supplier": {
                "s_name": PatternDictionary("Supplier#", self.n_supplier),
                "s_address": _address_dictionary(),
                "s_phone": _phone_dictionary(),
                "s_comment": _comment_dictionary(2048, 19),
            },
            "partsupp": {
                "ps_comment": _comment_dictionary(2048, 23),
            },
            "customer": {
                "c_name": PatternDictionary("Customer#", self.n_customer),
                "c_address": _address_dictionary(),
                "c_phone": _phone_dictionary(),
                "c_mktsegment": Dictionary(SEGMENTS),
                "c_comment": _comment_dictionary(4096, 29),
            },
            "orders": {
                "o_orderstatus": Dictionary(["F", "O", "P"]),
                "o_orderpriority": Dictionary(PRIORITIES),
                "o_clerk": PatternDictionary("Clerk#", self.n_clerk),
                "o_comment": _comment_dictionary(8192, 31),
            },
            "lineitem": {
                "l_returnflag": Dictionary(["A", "R", "N"]),
                "l_linestatus": Dictionary(["F", "O"]),
                "l_shipinstruct": Dictionary(SHIP_INSTRUCT),
                "l_shipmode": Dictionary(SHIP_MODES),
                "l_comment": _comment_dictionary(8192, 37),
            },
        }

    # ------------------------------------------------------------ metadata
    def tables(self) -> List[str]:
        return list(self._schemas)

    def table_schema(self, table: str) -> TableSchema:
        try:
            return self._schemas[table]
        except KeyError:
            raise KeyError(f"tpch has no table {table!r}")

    def row_count(self, table: str) -> int:
        """Slot count for split planning. For lineitem this is the padded
        slot capacity (orders x 7); true cardinality arrives via page
        validity masks."""
        return {
            "region": 5,
            "nation": 25,
            "part": self.n_part,
            "supplier": self.n_supplier,
            "partsupp": self.n_partsupp,
            "customer": self.n_customer,
            "orders": self.n_orders,
            "lineitem": self.n_orders * MAX_LINES_PER_ORDER,
        }[table]

    def splits(self, table: str, target_rows: int) -> List[Split]:
        if table == "lineitem":
            # align split boundaries to whole orders (7 slots)
            target_rows = max(
                (target_rows // MAX_LINES_PER_ORDER) * MAX_LINES_PER_ORDER,
                MAX_LINES_PER_ORDER,
            )
        return super().splits(table, target_rows)

    def unique_columns(self, table: str) -> frozenset:
        return {
            "region": frozenset({"r_regionkey"}),
            "nation": frozenset({"n_nationkey"}),
            "part": frozenset({"p_partkey"}),
            "supplier": frozenset({"s_suppkey"}),
            "customer": frozenset({"c_custkey"}),
            "orders": frozenset({"o_orderkey"}),
        }.get(table, frozenset())

    def monotonic_row_bound(self, table: str, column: str):
        """Key columns are monotonic in the row index (spec layout), so a
        pushed key range prunes whole generator splits."""

        def okey_row(v: int) -> int:
            # smallest order idx with sparse orderkey >= v
            # (okey(i) = (i//8)*32 + i%8 + 1, dbgen mk_sparse)
            v0 = max(v - 1, 0)
            block, w = divmod(v0, 32)
            return block * 8 + min(w, 8)

        return {
            ("orders", "o_orderkey"): okey_row,
            ("lineitem", "l_orderkey"):
                lambda v: okey_row(v) * MAX_LINES_PER_ORDER,
            ("customer", "c_custkey"): lambda v: v - 1,
            ("part", "p_partkey"): lambda v: v - 1,
            ("supplier", "s_suppkey"): lambda v: v - 1,
            ("partsupp", "ps_partkey"): lambda v: (v - 1) * 4,
            ("nation", "n_nationkey"): lambda v: v,
            ("region", "r_regionkey"): lambda v: v,
        }.get((table, column))

    def key_inverse(self, table: str, column: str):
        """Closed-form key -> row inverses (Connector.key_inverse): every
        TPC-H key column is an arithmetic function of the row index
        (spec 4.2.3 layouts), so the inverse is elementwise — the basis
        of the build-free generated join."""
        n = self.row_count(table) if table in self._schemas else 0

        def dense_from_1(vals):  # key = row + 1
            found = (vals >= 1) & (vals <= n)
            return vals - 1, found

        def dense_from_0(vals):  # key = row
            found = (vals >= 0) & (vals < n)
            return vals, found

        def okey_inv(vals):  # sparse keys, 8 used per 32 (mk_sparse)
            m = vals - 1
            oidx = (m // 32) * 8 + m % 32
            found = (vals >= 1) & (m % 32 < 8) & (oidx < n)
            return oidx, found

        return {
            ("region", "r_regionkey"): dense_from_0,
            ("nation", "n_nationkey"): dense_from_0,
            ("part", "p_partkey"): dense_from_1,
            ("supplier", "s_suppkey"): dense_from_1,
            ("customer", "c_custkey"): dense_from_1,
            ("orders", "o_orderkey"): okey_inv,
        }.get((table, column))

    # ---- per-table generators: a _Lazy of column thunks over global row
    # keys; every value is a pure function of the row keys

    def _gen_region_at(self, idx) -> _Lazy:
        lz = _Lazy()
        lz.put("r_regionkey", lambda: idx)
        lz.put("r_name", lambda: idx.to(torch.int32))
        lz.put("r_comment", lambda: _unif(
            idx, "region", "comment", 0, 511).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_nation_at(self, idx) -> _Lazy:
        lz = _Lazy()
        lz.put("n_nationkey", lambda: idx)
        lz.put("n_name", lambda: idx.to(torch.int32))
        lz.put("n_regionkey",
               lambda: self._region_of_nation[idx.clamp(0, 24)])
        lz.put("n_comment", lambda: _unif(
            idx, "nation", "comment", 0, 511).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    @staticmethod
    def _retail_price_cents(partkey: torch.Tensor) -> torch.Tensor:
        """Spec 4.2.3: (90000 + ((pk/10) mod 20001) + 100*(pk mod 1000))."""
        pk = partkey.to(torch.int64)
        return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)

    def _gen_part_at(self, idx) -> _Lazy:
        pk = idx + 1
        lz = _Lazy()
        lz.put("p_partkey", lambda: pk)
        lz.put("p_name", lambda: _unif(
            pk, "part", "name", 0, len(_pname_dictionary()) - 1
        ).to(torch.int32))
        lz.put("p_mfgr", lambda: _unif(pk, "part", "mfgr", 0, 4)
               .to(torch.int32))
        lz.put("p_brand", lambda: (
            _unif(pk, "part", "mfgr", 0, 4) * 5
            + _unif(pk, "part", "brand", 0, 4)
        ).to(torch.int32))
        lz.put("p_type", lambda: _unif(
            pk, "part", "type", 0, len(_type_dictionary()) - 1
        ).to(torch.int32))
        lz.put("p_size", lambda: _unif(pk, "part", "size", 1, 50)
               .to(torch.int32))
        lz.put("p_container", lambda: _unif(
            pk, "part", "container", 0, len(_container_dictionary()) - 1
        ).to(torch.int32))
        lz.put("p_retailprice", lambda: self._retail_price_cents(pk))
        lz.put("p_comment", lambda: _unif(
            pk, "part", "comment", 0, 2047).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(pk, dtype=torch.bool))
        return lz

    def _gen_supplier_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()
        lz.put("s_nationkey",
               lambda: _unif(sk, "supplier", "nationkey", 0, 24))
        lz.put("s_suppkey", lambda: sk)
        lz.put("s_name", lambda: (sk - 1).to(torch.int32))
        lz.put("s_address", lambda: _unif(
            sk, "supplier", "address", 0, 1023).to(torch.int32))
        lz.put("s_phone", lambda: (
            lz.get("s_nationkey") * _PHONE_LOCALS
            + _unif(sk, "supplier", "phone", 0, _PHONE_LOCALS - 1)
        ).to(torch.int32))
        lz.put("s_acctbal", lambda: _unif(
            sk, "supplier", "acctbal", -99_999, 999_999))
        lz.put("s_comment", lambda: _unif(
            sk, "supplier", "comment", 0, 2047).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(sk, dtype=torch.bool))
        return lz

    def _ps_suppkey(self, pk: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """Spec 4.2.3 partsupp supplier spread (join-consistent)."""
        S = self.n_supplier
        return (pk + i * (S // 4 + (pk - 1) // S)) % S + 1

    def _gen_partsupp_at(self, idx) -> _Lazy:
        pk = idx // 4 + 1
        i = idx % 4
        key = pk * 4 + i
        lz = _Lazy()
        lz.put("ps_partkey", lambda: pk)
        lz.put("ps_suppkey", lambda: self._ps_suppkey(pk, i))
        lz.put("ps_availqty", lambda: _unif(
            key, "partsupp", "availqty", 1, 9999).to(torch.int32))
        lz.put("ps_supplycost", lambda: _unif(
            key, "partsupp", "supplycost", 100, 100_000))
        lz.put("ps_comment", lambda: _unif(
            key, "partsupp", "comment", 0, 2047).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(pk, dtype=torch.bool))
        return lz

    def _gen_customer_at(self, idx) -> _Lazy:
        ck = idx + 1
        lz = _Lazy()
        lz.put("c_nationkey",
               lambda: _unif(ck, "customer", "nationkey", 0, 24))
        lz.put("c_custkey", lambda: ck)
        lz.put("c_name", lambda: (ck - 1).to(torch.int32))
        lz.put("c_address", lambda: _unif(
            ck, "customer", "address", 0, 1023).to(torch.int32))
        lz.put("c_phone", lambda: (
            lz.get("c_nationkey") * _PHONE_LOCALS
            + _unif(ck, "customer", "phone", 0, _PHONE_LOCALS - 1)
        ).to(torch.int32))
        lz.put("c_acctbal", lambda: _unif(
            ck, "customer", "acctbal", -99_999, 999_999))
        lz.put("c_mktsegment", lambda: _unif(
            ck, "customer", "mktsegment", 0, 4).to(torch.int32))
        lz.put("c_comment", lambda: _unif(
            ck, "customer", "comment", 0, 4095).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(ck, dtype=torch.bool))
        return lz

    # ---- orders + lineitem share per-order line computations

    @staticmethod
    def _orderkey(order_idx: torch.Tensor) -> torch.Tensor:
        """Sparse keys, 8 used per 32 (spec 4.2.3 / dbgen mk_sparse)."""
        return (order_idx // 8) * 32 + order_idx % 8 + 1

    def _order_custkey(self, okey: torch.Tensor) -> torch.Tensor:
        """Customers whose key % 3 == 0 place no orders (dbgen rule)."""
        n_active = (self.n_customer // 3) * 2
        j = _unif(okey, "orders", "custkey", 0, max(n_active - 1, 0))
        return 3 * (j // 2) + j % 2 + 1

    def _order_date(self, okey: torch.Tensor) -> torch.Tensor:
        return _unif(okey, "orders", "orderdate", STARTDATE, ORDERDATE_MAX)

    def _lines_per_order(self, okey: torch.Tensor) -> torch.Tensor:
        return _unif(okey, "lineitem", "count", 1, MAX_LINES_PER_ORDER)

    def _line_values(self, okey: torch.Tensor, line: torch.Tensor):
        """Per-(order, line) column values; key mixes okey and line."""
        key = okey * (MAX_LINES_PER_ORDER + 1) + line
        qty = _unif(key, "lineitem", "quantity", 1, 50)
        pk = _unif(key, "lineitem", "partkey", 1, self.n_part)
        supp_i = _unif(key, "lineitem", "suppi", 0, 3)
        disc = _unif(key, "lineitem", "discount", 0, 10)
        tax = _unif(key, "lineitem", "tax", 0, 8)
        odate = self._order_date(okey)
        ship = odate + _unif(key, "lineitem", "shipdate", 1, 121)
        commit = odate + _unif(key, "lineitem", "commitdate", 30, 90)
        receipt = ship + _unif(key, "lineitem", "receiptdate", 1, 30)
        ext = qty * self._retail_price_cents(pk)  # decimal(12,2) cents
        # charge per line at cents precision, round-half-up
        gross = ext * (100 - disc) * (100 + tax)
        charge = (gross + 5000) // 10_000
        return dict(
            key=key, qty=qty, pk=pk, supp_i=supp_i, disc=disc, tax=tax,
            odate=odate, ship=ship, commit=commit, receipt=receipt, ext=ext,
            charge=charge,
        )

    def _gen_orders_at(self, oidx) -> _Lazy:
        n = oidx.shape[0]
        okey = self._orderkey(oidx)
        lz = _Lazy()

        @functools.lru_cache(maxsize=1)
        def line_matrix():
            # [n, 7] per-line values for totalprice/orderstatus
            line = torch.arange(1, MAX_LINES_PER_ORDER + 1,
                                dtype=torch.int64, device=oidx.device)
            lv = self._line_values(
                okey[:, None].expand(n, MAX_LINES_PER_ORDER),
                line[None, :].expand(n, MAX_LINES_PER_ORDER),
            )
            nlines = self._lines_per_order(okey)
            live = line[None, :] <= nlines[:, None]
            return lv, live

        def totalprice():
            lv, live = line_matrix()
            return torch.where(live, lv["charge"], 0).sum(dim=1)

        def orderstatus():
            lv, live = line_matrix()
            shipped = lv["ship"] > CURRENTDATE  # linestatus 'O'
            all_o = (shipped | ~live).all(dim=1)
            all_f = (~shipped | ~live).all(dim=1)
            return torch.where(
                all_f, 0, torch.where(all_o, 1, 2)).to(torch.int32)

        lz.put("o_orderkey", lambda: okey)
        lz.put("o_custkey", lambda: self._order_custkey(okey))
        lz.put("o_orderstatus", orderstatus)
        lz.put("o_totalprice", totalprice)
        lz.put("o_orderdate",
               lambda: self._order_date(okey).to(torch.int32))
        lz.put("o_orderpriority", lambda: _unif(
            okey, "orders", "priority", 0, 4).to(torch.int32))
        lz.put("o_clerk", lambda: _unif(
            okey, "orders", "clerk", 0, self.n_clerk - 1).to(torch.int32))
        lz.put("o_shippriority",
               lambda: torch.zeros_like(okey, dtype=torch.int32))
        lz.put("o_comment", lambda: _unif(
            okey, "orders", "comment", 0, 8191).to(torch.int32))
        lz.put("__valid__",
               lambda: torch.ones_like(okey, dtype=torch.bool))
        return lz

    def _gen_lineitem(self, start, n: int) -> _Lazy:
        slot = (start + torch.arange(n, dtype=torch.int64,
                                     device=self.device)).reshape(-1)
        oidx = slot // MAX_LINES_PER_ORDER
        line = slot % MAX_LINES_PER_ORDER + 1
        okey = self._orderkey(oidx)
        lz = _Lazy()

        @functools.lru_cache(maxsize=1)
        def lv():
            return self._line_values(okey, line)

        lz.put("l_orderkey", lambda: okey)
        lz.put("l_partkey", lambda: lv()["pk"])
        lz.put("l_suppkey",
               lambda: self._ps_suppkey(lv()["pk"], lv()["supp_i"]))
        lz.put("l_linenumber", lambda: line.to(torch.int32))
        lz.put("l_quantity", lambda: lv()["qty"] * 100)
        lz.put("l_extendedprice", lambda: lv()["ext"])
        lz.put("l_discount", lambda: lv()["disc"])
        lz.put("l_tax", lambda: lv()["tax"])
        lz.put("l_returnflag", lambda: torch.where(
            lv()["receipt"] <= CURRENTDATE,
            _unif(lv()["key"], "lineitem", "rflag", 0, 1),
            2,
        ).to(torch.int32))
        lz.put("l_linestatus",
               lambda: (lv()["ship"] > CURRENTDATE).to(torch.int32))
        lz.put("l_shipdate", lambda: lv()["ship"].to(torch.int32))
        lz.put("l_commitdate", lambda: lv()["commit"].to(torch.int32))
        lz.put("l_receiptdate", lambda: lv()["receipt"].to(torch.int32))
        lz.put("l_shipinstruct", lambda: _unif(
            lv()["key"], "lineitem", "shipinstruct", 0, 3).to(torch.int32))
        lz.put("l_shipmode", lambda: _unif(
            lv()["key"], "lineitem", "shipmode", 0, 6).to(torch.int32))
        lz.put("l_comment", lambda: _unif(
            lv()["key"], "lineitem", "comment", 0, 8191).to(torch.int32))
        lz.put("__valid__", lambda: line <= self._lines_per_order(okey))
        return lz


def _build_schemas() -> Dict[str, TableSchema]:
    V = T.VARCHAR

    def tbl(name, *cols):
        return TableSchema(
            name, tuple(ColumnSchema(n, t) for n, t in cols)
        )

    return {
        s.name: s
        for s in [
            tbl("region", ("r_regionkey", T.BIGINT), ("r_name", V),
                ("r_comment", V)),
            tbl("nation", ("n_nationkey", T.BIGINT), ("n_name", V),
                ("n_regionkey", T.BIGINT), ("n_comment", V)),
            tbl("part", ("p_partkey", T.BIGINT), ("p_name", V),
                ("p_mfgr", V), ("p_brand", V), ("p_type", V),
                ("p_size", T.INTEGER), ("p_container", V),
                ("p_retailprice", DEC), ("p_comment", V)),
            tbl("supplier", ("s_suppkey", T.BIGINT), ("s_name", V),
                ("s_address", V), ("s_nationkey", T.BIGINT),
                ("s_phone", V), ("s_acctbal", DEC), ("s_comment", V)),
            tbl("partsupp", ("ps_partkey", T.BIGINT),
                ("ps_suppkey", T.BIGINT), ("ps_availqty", T.INTEGER),
                ("ps_supplycost", DEC), ("ps_comment", V)),
            tbl("customer", ("c_custkey", T.BIGINT), ("c_name", V),
                ("c_address", V), ("c_nationkey", T.BIGINT),
                ("c_phone", V), ("c_acctbal", DEC), ("c_mktsegment", V),
                ("c_comment", V)),
            tbl("orders", ("o_orderkey", T.BIGINT), ("o_custkey", T.BIGINT),
                ("o_orderstatus", V), ("o_totalprice", DEC),
                ("o_orderdate", T.DATE), ("o_orderpriority", V),
                ("o_clerk", V), ("o_shippriority", T.INTEGER),
                ("o_comment", V)),
            tbl("lineitem", ("l_orderkey", T.BIGINT),
                ("l_partkey", T.BIGINT), ("l_suppkey", T.BIGINT),
                ("l_linenumber", T.INTEGER), ("l_quantity", DEC),
                ("l_extendedprice", DEC), ("l_discount", DEC),
                ("l_tax", DEC), ("l_returnflag", T.VarcharType(1)),
                ("l_linestatus", T.VarcharType(1)),
                ("l_shipdate", T.DATE), ("l_commitdate", T.DATE),
                ("l_receiptdate", T.DATE), ("l_shipinstruct", V),
                ("l_shipmode", V), ("l_comment", V)),
        ]
    }
