"""TPC-DS connector: deterministic on-device data generation.

Port of presto_tpu/connectors/tpcds.py: all 24 tables, every column a
pure function of the global row index computed on the device from the
counter-based xxhash64 streams keyed on (tpcds.table.column, row key),
so the generated values are BIT-IDENTICAL to the reference generator for
the same table, scale and row range.

Structure (the reference's, where query behaviour depends on it):
  - customer_demographics and household_demographics are mixed-radix
    cross products decoded from the surrogate key; date_dim covers
    1900-01-01..2100-01-01 with d_date_sk = 2415022 + day index;
  - store_sales is ticket-structured (slot = ticket * 11 + line, 1..11
    live lines per ticket), store_returns shares its slot space (~10%
    of sale lines return); catalog and web sales/returns are order-
    structured alike, and ~30% of catalog lines re-purchase a returned
    store sale (the Q17 correlation);
  - ticket and order numbers pin a fact row to its 11-slot window
    (``key_window_inverse``), which the windowed generated join uses.

Reference: presto-tpcds (TpcdsConnectorFactory/TpcdsMetadata).
"""

from __future__ import annotations

import datetime
import functools
import math
import zlib
from typing import Dict, List

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
from presto_tpu_torch.connectors.tpch import (
    _COMMENT_A,
    _COMMENT_B,
    _COMMENT_C,
    COLORS,
    PatternDictionary,
    _Lazy,
    _lcg_words,
)
from presto_tpu_torch.expr.values import civil_from_days
from presto_tpu_torch.ops import u64
from presto_tpu_torch.ops.hashing import xxhash64_u64
from presto_tpu_torch.page import Dictionary

_EPOCH = datetime.date(1970, 1, 1)


def _days1900(y: int, m: int, d: int) -> int:
    """Days since 1900-01-01 (the date_dim row index)."""
    return (datetime.date(y, m, d) - datetime.date(1900, 1, 1)).days


# dsdgen convention: d_date_sk of 1900-01-01; sk = JULIAN_BASE + day index
JULIAN_BASE = 2415022
N_DATE = _days1900(2100, 1, 1) + 1  # 73049
# days since unix epoch of 1900-01-01 (negative) — DATE column encoding
_EPOCH_1900 = (datetime.date(1900, 1, 1) - _EPOCH).days

SALES_START = _days1900(1998, 1, 1)
SALES_END = _days1900(2002, 12, 31)

MAX_LINES = 11  # slots per store ticket / catalog order (1..11 live)
SS_RETURN_PCT = 10  # ~10% of store sale lines are returned (spec ratio)
CS_RETURN_PCT = 10
CS_REPURCHASE_PCT = 30  # catalog lines re-purchasing a returned store sale
WS_RETURN_PCT = 10
N_INV_WEEKS = 261  # weekly inventory snapshots over the 5 sales years

DEC72 = T.DecimalType(7, 2)
DEC52 = T.DecimalType(5, 2)


# ------------------------------------------------------------ calendar math

# --------------------------------------------------------- random streams

def _stream_seed(table: str, column: str) -> int:
    return zlib.crc32(f"tpcds.{table}.{column}".encode())


def _draw(keys: torch.Tensor, table: str, column: str) -> torch.Tensor:
    """u64 stream value (int64 bit-view) per key, independent per
    (table, column)."""
    return xxhash64_u64(keys.to(torch.int64),
                        seed=_stream_seed(table, column))


def _unif(keys, table, column, lo: int, hi: int) -> torch.Tensor:
    """Uniform int64 in [lo, hi] keyed by row key (chunk-independent):
    the UNSIGNED stream value mod the span, as the reference computes."""
    return u64.umod(_draw(keys, table, column), hi - lo + 1) + lo


# ------------------------------------------------------------- value pools

GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree",
             "4 yr Degree", "Advanced Degree", "Unknown"]
CREDIT_RATING = ["Low Risk", "Good", "High Risk", "Unknown"]
BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000",
                 "0-500", "Unknown"]
STATES = ["AL", "CA", "CO", "FL", "GA", "IA", "IL", "IN", "KS", "KY",
          "MI", "MN", "MO", "NC", "NY", "OH", "OK", "TN", "TX", "VA"]
LOCATION_TYPES = ["apartment", "condo", "single family"]
STREET_TYPES = ["Ave", "Blvd", "Court", "Dr", "Lane", "Pkwy", "RD",
                "ST", "Way", "Circle"]
ITEM_SIZES = ["small", "medium", "large", "extra large", "economy",
              "petite", "N/A"]
ITEM_UNITS = ["Each", "Dozen", "Case", "Pallet", "Gross", "Box",
              "Bunch", "Carton", "Cup", "Dram", "Lb", "Oz", "Ton",
              "Tbl", "Tsp", "Unknown"]
# 30-color pool; the first six are Q64's qualification colors so the
# filter keeps a stable ~20% item selectivity at every scale
ITEM_COLORS = ["purple", "burlywood", "indian", "spring", "floral",
               "medium"] + [c for c in COLORS if c not in (
                   "purple", "burlywood", "indian", "spring", "floral",
                   "medium")][:24]
CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry",
              "Men", "Music", "Shoes", "Sports", "Women"]
CLASSES = ["accent", "accessories", "archery", "athletic", "baseball",
           "basketball", "bedding", "blinds/shades", "bracelets",
           "camcorders", "camping", "classical", "computers", "consignment",
           "country", "curtains/drapes"]
STORE_NAMES = ["ought", "able", "ese", "anti", "cally", "ation", "eing",
               "n st", "bar", "pri"]
PROMO_NAMES = ["ought", "able", "ese", "anti", "cally", "ation", "eing",
               "n st", "bar", "pri"]
SHIP_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY"]
SHIP_CODES = ["AIR", "SURFACE", "SEA"]
SHIP_CARRIERS = ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU",
                 "LATVIAN", "UDEN", "GREAT EASTERN", "DIAMOND", "RUPEKSA",
                 "ORIENTAL", "BOXBUNDLES", "ALLIANCE", "HARMSTORF",
                 "PRIVATECARRIER", "GERMA", "MSC", "BARIAN"]
REASON_DESCS = ["Package was damaged", "Stopped working",
                "Did not get it on time", "Not the product that was "
                "ordred", "Parts missing", "Does not work with a product "
                "that I have", "Gift exchange", "Did not like the color",
                "Did not like the model", "Did not like the make",
                "Did not like the warranty", "No service location in my "
                "area", "Found a better price in a store",
                "Found a better extended warranty in a store",
                "Not working any more", "reason 16", "reason 17",
                "reason 18", "reason 19", "reason 20"]
CC_NAMES = ["NY Metro", "Mid Atlantic", "California", "Pacific Northwest",
            "North Midwest", "Central"]
WP_TYPES = ["ad", "dynamic", "feedback", "general", "order", "protected",
            "welcome"]
AM_PM = ["AM", "PM"]
SHIFTS = ["first", "second", "third"]
SUB_SHIFTS = ["morning", "afternoon", "evening", "night"]
MEAL_TIMES = ["", "breakfast", "lunch", "dinner"]
CC_CLASSES = ["small", "medium", "large"]
CP_TYPES = ["bi-annual", "quarterly", "monthly"]
WEB_NAMES = ["site_0", "site_1", "site_2", "site_3", "site_4", "site_5"]
WEB_COMPANIES = ["pri", "unusual", "able", "ese", "anti", "cally"]
DAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday"]  # 1900-01-01 was a Monday
HOURS = ["8AM-4PM", "8AM-8PM", "8AM-12AM"]

_WORDS_A = ("pleasant oak cedar elm maple pine walnut sunset lake hill"
            " ridge view park green spring forest river meadow wilson"
            " franklin").split()
_WORDS_B = ("first second third fourth fifth sixth seventh eighth ninth"
            " tenth main center church mill north south east west highland"
            " college").split()


@functools.lru_cache(maxsize=None)
def _word_pool_dictionary(n: int, seed: int) -> Dictionary:
    return Dictionary(_lcg_words(n, seed, [_WORDS_A, _WORDS_B]))


@functools.lru_cache(maxsize=None)
def _desc_dictionary(n: int = 4096) -> Dictionary:
    return Dictionary(
        _lcg_words(n, 20260730,
                   [_COMMENT_A, _COMMENT_B, _COMMENT_C, _COMMENT_B,
                    _COMMENT_C, _COMMENT_A, _COMMENT_C])
    )


@functools.lru_cache(maxsize=None)
def _zip_dictionary(n: int = 4096) -> Dictionary:
    state = 60601
    vals = []
    for _ in range(n):
        state = (state * 48271) % 2147483647
        vals.append(str(10000 + state % 89999).zfill(5))
    return Dictionary(vals)


@functools.lru_cache(maxsize=None)
def _street_number_dictionary(n: int = 1000) -> Dictionary:
    return Dictionary([str(i + 1) for i in range(n)])


@functools.lru_cache(maxsize=None)
def _quarter_dictionary() -> Dictionary:
    """code = (year - 1900) * 4 + quarter-1, 1900..2100."""
    return Dictionary(
        [f"{y}Q{q}" for y in range(1900, 2101) for q in (1, 2, 3, 4)]
    )


@functools.lru_cache(maxsize=None)
def _brand_dictionary(n: int = 1000) -> Dictionary:
    return Dictionary([f"Brand#{i + 1}" for i in range(n)])


@functools.lru_cache(maxsize=None)
def _name_dictionary(n: int, seed: int) -> Dictionary:
    pool = ("james mary john patricia robert jennifer michael linda"
            " william elizabeth david barbara richard susan joseph jessica"
            " thomas sarah charles karen lisa nancy betty margaret sandra"
            " ashley dorothy kimberly emily donna michelle carol amanda"
            " melissa deborah stephanie rebecca sharon laura cynthia"
            " kathleen amy shirley angela helen anna brenda pamela nicole"
            " ruth katherine").split()
    state = seed & 0x7FFFFFFF or 1
    out = []
    for _ in range(n):
        state = (state * 48271) % 2147483647
        out.append(pool[state % len(pool)].capitalize())
    return Dictionary(out)


# ------------------------------------------------------------- connector


class TpcdsConnector(GeneratorConnector, Connector):
    """Reference: presto-tpcds TpcdsConnectorFactory. ``device=None``
    generates on the card (and raises without one)."""

    name = "tpcds"

    def __init__(self, scale: float = 1.0, device=None):
        self.scale = scale
        self.device = resolve_device(device)
        self.n_customer = max(int(100_000 * scale), 200)
        self.n_addr = max(self.n_customer // 2, 100)
        # spec: fixed full cross product; scaled down below SF1 so tiny
        # test fixtures stay tiny (truncation of the same decode)
        self.n_cdemo = (1_920_800 if scale >= 1
                        else max(int(1_920_800 * scale), 1_000))
        self.n_hdemo = 7_200
        self.n_income_band = 20
        self.n_item = max(int(18_000 * math.sqrt(scale)), 100)
        self.n_store = max(int(12 * scale ** 0.75), 2)
        self.n_promo = max(int(300 * scale ** 0.25), 10)
        # 480k tickets x avg 6 live lines = spec's ~2.88M rows at SF1
        self.n_ticket = max(int(480_000 * scale), 64)
        self.n_corder = max(int(240_000 * scale), 32)
        # web channel + remaining dims (round 3: full 24-table census)
        self.n_worder = max(int(120_000 * scale), 16)
        self.n_warehouse = max(int(5 * scale ** 0.5), 2)
        self.n_ship_mode = 20
        self.n_reason = max(int(35 * scale ** 0.25), 5)
        self.n_call_center = max(int(6 * scale ** 0.5), 2)
        self.n_catalog_page = max(int(11_718 * scale ** 0.5), 64)
        self.n_web_site = max(int(30 * scale ** 0.25), 2)
        self.n_web_page = max(int(60 * scale ** 0.5), 4)
        self._schemas = _build_schemas()
        self._dicts = self._build_dictionaries()

    # ------------------------------------------------------------ metadata
    def tables(self) -> List[str]:
        return list(self._schemas)

    def table_schema(self, table: str) -> TableSchema:
        try:
            return self._schemas[table]
        except KeyError:
            raise KeyError(f"tpcds has no table {table!r}")

    def row_count(self, table: str) -> int:
        """Slot count for split planning; fact-table true cardinality
        arrives via page validity masks (see module docstring)."""
        return {
            "date_dim": N_DATE,
            "item": self.n_item,
            "store": self.n_store,
            "customer": self.n_customer,
            "customer_address": self.n_addr,
            "customer_demographics": self.n_cdemo,
            "household_demographics": self.n_hdemo,
            "income_band": self.n_income_band,
            "promotion": self.n_promo,
            "store_sales": self.n_ticket * MAX_LINES,
            "store_returns": self.n_ticket * MAX_LINES,
            "catalog_sales": self.n_corder * MAX_LINES,
            "catalog_returns": self.n_corder * MAX_LINES,
            "web_sales": self.n_worder * MAX_LINES,
            "web_returns": self.n_worder * MAX_LINES,
            "warehouse": self.n_warehouse,
            "ship_mode": self.n_ship_mode,
            "reason": self.n_reason,
            "time_dim": 86_400,
            "call_center": self.n_call_center,
            "catalog_page": self.n_catalog_page,
            "web_site": self.n_web_site,
            "web_page": self.n_web_page,
            "inventory": N_INV_WEEKS * self.n_item * self.n_warehouse,
        }[table]

    def splits(self, table: str, target_rows: int) -> List[Split]:
        if table in ("store_sales", "store_returns", "catalog_sales",
                     "catalog_returns", "web_sales", "web_returns"):
            # align split boundaries to whole tickets/orders
            target_rows = max(
                (target_rows // MAX_LINES) * MAX_LINES, MAX_LINES
            )
        return super().splits(table, target_rows)

    def unique_columns(self, table: str) -> frozenset:
        return {
            "date_dim": frozenset({"d_date_sk"}),
            "item": frozenset({"i_item_sk"}),
            "store": frozenset({"s_store_sk"}),
            "customer": frozenset({"c_customer_sk"}),
            "customer_address": frozenset({"ca_address_sk"}),
            "customer_demographics": frozenset({"cd_demo_sk"}),
            "household_demographics": frozenset({"hd_demo_sk"}),
            "income_band": frozenset({"ib_income_band_sk"}),
            "promotion": frozenset({"p_promo_sk"}),
            "warehouse": frozenset({"w_warehouse_sk"}),
            "ship_mode": frozenset({"sm_ship_mode_sk"}),
            "reason": frozenset({"r_reason_sk"}),
            "time_dim": frozenset({"t_time_sk"}),
            "call_center": frozenset({"cc_call_center_sk"}),
            "catalog_page": frozenset({"cp_catalog_page_sk"}),
            "web_site": frozenset({"web_site_sk"}),
            "web_page": frozenset({"wp_web_page_sk"}),
        }.get(table, frozenset())

    def monotonic_row_bound(self, table: str, column: str):
        """Surrogate keys are monotonic in the row index, so pushed sk
        ranges prune generator splits (e.g. date_dim filtered to a
        quarter scans ~90 rows, not 73k)."""
        simple = {
            ("date_dim", "d_date_sk"): lambda v: v - JULIAN_BASE,
            ("item", "i_item_sk"): lambda v: v - 1,
            ("store", "s_store_sk"): lambda v: v - 1,
            ("customer", "c_customer_sk"): lambda v: v - 1,
            ("customer_address", "ca_address_sk"): lambda v: v - 1,
            ("customer_demographics", "cd_demo_sk"): lambda v: v - 1,
            ("household_demographics", "hd_demo_sk"): lambda v: v - 1,
            ("income_band", "ib_income_band_sk"): lambda v: v - 1,
            ("promotion", "p_promo_sk"): lambda v: v - 1,
            ("store_sales", "ss_ticket_number"):
                lambda v: (v - 1) * MAX_LINES,
            ("store_returns", "sr_ticket_number"):
                lambda v: (v - 1) * MAX_LINES,
            ("catalog_sales", "cs_order_number"):
                lambda v: (v - 1) * MAX_LINES,
            ("catalog_returns", "cr_order_number"):
                lambda v: (v - 1) * MAX_LINES,
            ("web_sales", "ws_order_number"):
                lambda v: (v - 1) * MAX_LINES,
            ("web_returns", "wr_order_number"):
                lambda v: (v - 1) * MAX_LINES,
            ("warehouse", "w_warehouse_sk"): lambda v: v - 1,
            ("ship_mode", "sm_ship_mode_sk"): lambda v: v - 1,
            ("reason", "r_reason_sk"): lambda v: v - 1,
            ("time_dim", "t_time_sk"): lambda v: v,
            ("call_center", "cc_call_center_sk"): lambda v: v - 1,
            ("catalog_page", "cp_catalog_page_sk"): lambda v: v - 1,
            ("web_site", "web_site_sk"): lambda v: v - 1,
            ("web_page", "wp_web_page_sk"): lambda v: v - 1,
            # inventory is week-major: value = base + 7 * (row // stride)
            ("inventory", "inv_date_sk"): lambda v: (
                -(-(v - JULIAN_BASE - SALES_START) // 7)
                * self.n_item * self.n_warehouse
            ),
        }
        return simple.get((table, column))

    def key_inverse(self, table: str, column: str):
        """Closed-form key->row inverses (Connector.key_inverse): every
        dimension surrogate key is row+1 (or row+JULIAN_BASE for
        date_dim, row for time_dim) — the basis of the build-free
        generated join against the dims."""
        offsets = {
            ("date_dim", "d_date_sk"): JULIAN_BASE,
            ("item", "i_item_sk"): 1,
            ("store", "s_store_sk"): 1,
            ("customer", "c_customer_sk"): 1,
            ("customer_address", "ca_address_sk"): 1,
            ("customer_demographics", "cd_demo_sk"): 1,
            ("household_demographics", "hd_demo_sk"): 1,
            ("income_band", "ib_income_band_sk"): 1,
            ("promotion", "p_promo_sk"): 1,
            ("warehouse", "w_warehouse_sk"): 1,
            ("ship_mode", "sm_ship_mode_sk"): 1,
            ("reason", "r_reason_sk"): 1,
            ("time_dim", "t_time_sk"): 0,
            ("call_center", "cc_call_center_sk"): 1,
            ("catalog_page", "cp_catalog_page_sk"): 1,
            ("web_site", "web_site_sk"): 1,
            ("web_page", "wp_web_page_sk"): 1,
        }
        off = offsets.get((table, column))
        if off is None:
            return None
        n = self.row_count(table)

        def inv(vals, off=off, n=n):
            ridx = vals - off
            return ridx, (ridx >= 0) & (ridx < n)

        return inv

    def key_window_inverse(self, table: str, column: str):
        """Ticket/order numbers pin a fact row to its MAX_LINES-slot
        window (slot = (ticket-1)*MAX_LINES + line): the windowed
        generated join resolves the line by generating the remaining
        key columns at the 11 candidates — even fact⋈fact joins
        (store_sales ⋈ store_returns on ticket+item, Q17/Q64) run
        build-free."""
        tickets = {
            ("store_sales", "ss_ticket_number"): self.n_ticket,
            ("store_returns", "sr_ticket_number"): self.n_ticket,
            ("catalog_sales", "cs_order_number"): self.n_corder,
            ("catalog_returns", "cr_order_number"): self.n_corder,
            ("web_sales", "ws_order_number"): self.n_worder,
            ("web_returns", "wr_order_number"): self.n_worder,
        }
        n = tickets.get((table, column))
        if n is None:
            return None

        def inv(vals, n=n):
            base = (vals - 1) * MAX_LINES
            return base, (vals >= 1) & (vals <= n)

        return inv, MAX_LINES

    def _build_dictionaries(self):
        return {
            "date_dim": {
                "d_date_id": PatternDictionary("D", N_DATE, offset=0),
                "d_day_name": Dictionary(DAY_NAMES),
                "d_quarter_name": _quarter_dictionary(),
                "d_holiday": Dictionary(["N", "Y"]),
                "d_weekend": Dictionary(["N", "Y"]),
            },
            "item": {
                "i_item_id": PatternDictionary("ITEM", self.n_item),
                "i_item_desc": _desc_dictionary(),
                "i_brand": _brand_dictionary(),
                "i_class": Dictionary(CLASSES),
                "i_category": Dictionary(CATEGORIES),
                "i_size": Dictionary(ITEM_SIZES),
                "i_color": Dictionary(ITEM_COLORS),
                "i_units": Dictionary(ITEM_UNITS),
                "i_product_name": _word_pool_dictionary(8192, 41),
            },
            "store": {
                "s_store_id": PatternDictionary("STORE", self.n_store),
                "s_store_name": Dictionary(STORE_NAMES),
                "s_hours": Dictionary(HOURS),
                "s_manager": _name_dictionary(512, 43),
                "s_city": _word_pool_dictionary(1024, 47),
                "s_county": _word_pool_dictionary(64, 53),
                "s_state": Dictionary(STATES),
                "s_zip": _zip_dictionary(),
            },
            "customer": {
                "c_customer_id": PatternDictionary(
                    "CUSTOMER", self.n_customer),
                "c_first_name": _name_dictionary(1024, 59),
                "c_last_name": _name_dictionary(2048, 61),
            },
            "customer_address": {
                "ca_address_id": PatternDictionary("ADDR", self.n_addr),
                "ca_street_number": _street_number_dictionary(),
                "ca_street_name": _word_pool_dictionary(1024, 67),
                "ca_street_type": Dictionary(STREET_TYPES),
                "ca_city": _word_pool_dictionary(1024, 47),
                "ca_county": _word_pool_dictionary(64, 53),
                "ca_state": Dictionary(STATES),
                "ca_zip": _zip_dictionary(),
                "ca_country": Dictionary(["United States"]),
                "ca_location_type": Dictionary(LOCATION_TYPES),
            },
            "customer_demographics": {
                "cd_gender": Dictionary(GENDERS),
                "cd_marital_status": Dictionary(MARITAL),
                "cd_education_status": Dictionary(EDUCATION),
                "cd_credit_rating": Dictionary(CREDIT_RATING),
            },
            "household_demographics": {
                "hd_buy_potential": Dictionary(BUY_POTENTIAL),
            },
            "promotion": {
                "p_promo_id": PatternDictionary("PROMO", self.n_promo),
                "p_promo_name": Dictionary(PROMO_NAMES),
                "p_channel_dmail": Dictionary(["N", "Y"]),
                "p_channel_email": Dictionary(["N", "Y"]),
                "p_channel_tv": Dictionary(["N", "Y"]),
            },
            "warehouse": {
                "w_warehouse_id": PatternDictionary(
                    "WH", self.n_warehouse),
                "w_warehouse_name": _word_pool_dictionary(1024, 71),
                "w_city": _word_pool_dictionary(1024, 47),
                "w_county": _word_pool_dictionary(64, 53),
                "w_state": Dictionary(STATES),
                "w_zip": _zip_dictionary(),
                "w_country": Dictionary(["United States"]),
            },
            "ship_mode": {
                "sm_ship_mode_id": PatternDictionary(
                    "SM", self.n_ship_mode),
                "sm_type": Dictionary(SHIP_TYPES),
                "sm_code": Dictionary(SHIP_CODES),
                "sm_carrier": Dictionary(SHIP_CARRIERS),
                "sm_contract": _word_pool_dictionary(1024, 73),
            },
            "reason": {
                "r_reason_id": PatternDictionary("REASON", self.n_reason),
                "r_reason_desc": Dictionary(REASON_DESCS),
            },
            "time_dim": {
                "t_time_id": PatternDictionary("TIME", 86_400, offset=0),
                "t_am_pm": Dictionary(AM_PM),
                "t_shift": Dictionary(SHIFTS),
                "t_sub_shift": Dictionary(SUB_SHIFTS),
                "t_meal_time": Dictionary(MEAL_TIMES),
            },
            "call_center": {
                "cc_call_center_id": PatternDictionary(
                    "CC", self.n_call_center),
                "cc_name": Dictionary(CC_NAMES),
                "cc_class": Dictionary(CC_CLASSES),
                "cc_hours": Dictionary(HOURS),
                "cc_manager": _name_dictionary(512, 43),
                "cc_county": _word_pool_dictionary(64, 53),
                "cc_state": Dictionary(STATES),
            },
            "catalog_page": {
                "cp_catalog_page_id": PatternDictionary(
                    "CP", self.n_catalog_page),
                "cp_department": Dictionary(["DEPARTMENT"]),
                "cp_description": _desc_dictionary(),
                "cp_type": Dictionary(CP_TYPES),
            },
            "web_site": {
                "web_site_id": PatternDictionary(
                    "WEB", self.n_web_site),
                "web_name": Dictionary(WEB_NAMES),
                "web_manager": _name_dictionary(512, 79),
                "web_company_name": Dictionary(WEB_COMPANIES),
            },
            "web_page": {
                "wp_web_page_id": PatternDictionary(
                    "WP", self.n_web_page),
                "wp_autogen_flag": Dictionary(["N", "Y"]),
                "wp_url": Dictionary(["http://www.foo.com"]),
                "wp_type": Dictionary(WP_TYPES),
            },
        }

    # ------------------------------------------------------ dimension gens

    def _gen_date_dim_at(self, idx) -> _Lazy:
        lz = _Lazy()

        @functools.lru_cache(maxsize=1)
        def ymd():
            return civil_from_days(idx + _EPOCH_1900)

        lz.put("d_date_sk", lambda: idx + JULIAN_BASE)
        lz.put("d_date_id", lambda: idx.to(torch.int32))
        lz.put("d_date", lambda: (idx + _EPOCH_1900)
               .to(torch.int32))
        lz.put("d_year", lambda: ymd()[0].to(torch.int32))
        lz.put("d_moy", lambda: ymd()[1].to(torch.int32))
        lz.put("d_dom", lambda: ymd()[2].to(torch.int32))
        lz.put("d_qoy", lambda: ((ymd()[1] - 1) // 3 + 1).to(torch.int32))
        lz.put("d_quarter_name", lambda: (
            (ymd()[0] - 1900) * 4 + (ymd()[1] - 1) // 3
        ).to(torch.int32))
        lz.put("d_month_seq", lambda: (
            (ymd()[0] - 1900) * 12 + ymd()[1] - 1).to(torch.int32))
        lz.put("d_week_seq", lambda: (idx // 7 + 1).to(torch.int32))
        lz.put("d_dow", lambda: (idx % 7).to(torch.int32))
        lz.put("d_day_name", lambda: (idx % 7).to(torch.int32))
        lz.put("d_weekend", lambda: (idx % 7 >= 5).to(torch.int32))
        lz.put("d_holiday", lambda: (_unif(
            idx, "date_dim", "holiday", 0, 99) < 5).to(torch.int32))
        lz.put("d_fy_year", lambda: ymd()[0].to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_item_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()
        lz.put("i_item_sk", lambda: sk)
        lz.put("i_item_id", lambda: (sk - 1).to(torch.int32))
        lz.put("i_item_desc", lambda: _unif(
            sk, "item", "desc", 0, 4095).to(torch.int32))
        # current_price 50.00..89.99: Q64's qualification band (64..79)
        # keeps a stable ~25% selectivity at every scale
        lz.put("i_current_price", lambda: _unif(
            sk, "item", "price", 5000, 8999))
        lz.put("i_wholesale_cost", lambda: _unif(
            sk, "item", "wholesale", 100, 7000))
        lz.put("i_brand_id", lambda: _unif(
            sk, "item", "brand", 1, 1000).to(torch.int32))
        lz.put("i_brand", lambda: (
            _unif(sk, "item", "brand", 1, 1000) - 1).to(torch.int32))
        lz.put("i_class_id", lambda: _unif(
            sk, "item", "class", 1, len(CLASSES)).to(torch.int32))
        lz.put("i_class", lambda: (
            _unif(sk, "item", "class", 1, len(CLASSES)) - 1
        ).to(torch.int32))
        lz.put("i_category_id", lambda: _unif(
            sk, "item", "category", 1, len(CATEGORIES)).to(torch.int32))
        lz.put("i_category", lambda: (
            _unif(sk, "item", "category", 1, len(CATEGORIES)) - 1
        ).to(torch.int32))
        lz.put("i_manufact_id", lambda: _unif(
            sk, "item", "manufact", 1, 1000).to(torch.int32))
        lz.put("i_manager_id", lambda: _unif(
            sk, "item", "manager", 1, 100).to(torch.int32))
        lz.put("i_size", lambda: _unif(
            sk, "item", "size", 0, len(ITEM_SIZES) - 1).to(torch.int32))
        lz.put("i_color", lambda: _unif(
            sk, "item", "color", 0, len(ITEM_COLORS) - 1).to(torch.int32))
        lz.put("i_units", lambda: _unif(
            sk, "item", "units", 0, len(ITEM_UNITS) - 1).to(torch.int32))
        lz.put("i_product_name", lambda: _unif(
            sk, "item", "pname", 0, 8191).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_store_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()
        lz.put("s_store_sk", lambda: sk)
        lz.put("s_store_id", lambda: (sk - 1).to(torch.int32))
        lz.put("s_store_name", lambda: (
            (sk - 1) % len(STORE_NAMES)).to(torch.int32))
        lz.put("s_number_employees", lambda: _unif(
            sk, "store", "employees", 200, 300).to(torch.int32))
        lz.put("s_floor_space", lambda: _unif(
            sk, "store", "floor", 5_000_000, 10_000_000).to(torch.int32))
        lz.put("s_hours", lambda: _unif(
            sk, "store", "hours", 0, 2).to(torch.int32))
        lz.put("s_manager", lambda: _unif(
            sk, "store", "manager", 0, 511).to(torch.int32))
        lz.put("s_market_id", lambda: _unif(
            sk, "store", "market", 1, 10).to(torch.int32))
        lz.put("s_company_id", lambda: torch.ones_like(idx, dtype=torch.int32))
        lz.put("s_city", lambda: _unif(
            sk, "store", "city", 0, 1023).to(torch.int32))
        lz.put("s_county", lambda: _unif(
            sk, "store", "county", 0, 63).to(torch.int32))
        lz.put("s_state", lambda: _unif(
            sk, "store", "state", 0, len(STATES) - 1).to(torch.int32))
        lz.put("s_zip", lambda: _unif(
            sk, "store", "zip", 0, 4095).to(torch.int32))
        lz.put("s_gmt_offset", lambda: -100 * _unif(
            sk, "store", "gmt", 5, 8))
        lz.put("s_tax_precentage", lambda: _unif(
            sk, "store", "tax", 0, 11))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_customer_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()

        def first_sales_day():
            return _unif(sk, "customer", "first_sales",
                         _days1900(1990, 1, 1), _days1900(2002, 1, 1))

        lz.put("c_customer_sk", lambda: sk)
        lz.put("c_customer_id", lambda: (sk - 1).to(torch.int32))
        lz.put("c_current_cdemo_sk", lambda: _unif(
            sk, "customer", "cdemo", 1, self.n_cdemo))
        lz.put("c_current_hdemo_sk", lambda: _unif(
            sk, "customer", "hdemo", 1, self.n_hdemo))
        lz.put("c_current_addr_sk", lambda: _unif(
            sk, "customer", "addr", 1, self.n_addr))
        lz.put("c_first_sales_date_sk",
               lambda: first_sales_day() + JULIAN_BASE)
        lz.put("c_first_shipto_date_sk", lambda: (
            first_sales_day()
            + _unif(sk, "customer", "shipto", 0, 120)
            + JULIAN_BASE
        ))
        lz.put("c_first_name", lambda: _unif(
            sk, "customer", "fname", 0, 1023).to(torch.int32))
        lz.put("c_last_name", lambda: _unif(
            sk, "customer", "lname", 0, 2047).to(torch.int32))
        lz.put("c_birth_year", lambda: _unif(
            sk, "customer", "byear", 1924, 1992).to(torch.int32))
        lz.put("c_birth_month", lambda: _unif(
            sk, "customer", "bmonth", 1, 12).to(torch.int32))
        lz.put("c_birth_day", lambda: _unif(
            sk, "customer", "bday", 1, 28).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_customer_address_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()
        lz.put("ca_address_sk", lambda: sk)
        lz.put("ca_address_id", lambda: (sk - 1).to(torch.int32))
        lz.put("ca_street_number", lambda: _unif(
            sk, "customer_address", "stno", 0, 999).to(torch.int32))
        lz.put("ca_street_name", lambda: _unif(
            sk, "customer_address", "stname", 0, 1023).to(torch.int32))
        lz.put("ca_street_type", lambda: _unif(
            sk, "customer_address", "sttype", 0, len(STREET_TYPES) - 1
        ).to(torch.int32))
        lz.put("ca_city", lambda: _unif(
            sk, "customer_address", "city", 0, 1023).to(torch.int32))
        lz.put("ca_county", lambda: _unif(
            sk, "customer_address", "county", 0, 63).to(torch.int32))
        lz.put("ca_state", lambda: _unif(
            sk, "customer_address", "state", 0, len(STATES) - 1
        ).to(torch.int32))
        lz.put("ca_zip", lambda: _unif(
            sk, "customer_address", "zip", 0, 4095).to(torch.int32))
        lz.put("ca_country", lambda: torch.zeros_like(idx, dtype=torch.int32))
        lz.put("ca_gmt_offset", lambda: -100 * _unif(
            sk, "customer_address", "gmt", 5, 8))
        lz.put("ca_location_type", lambda: _unif(
            sk, "customer_address", "loctype", 0, 2).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_customer_demographics_at(self, idx) -> _Lazy:
        """Mixed-radix decode of the spec's full cross product:
        2 x 5 x 7 x 20 x 4 x 7 x 7 x 7 = 1,920,800."""
        sk = idx + 1
        x = sk - 1
        lz = _Lazy()
        gender = x % 2
        x1 = x // 2
        marital = x1 % 5
        x2 = x1 // 5
        edu = x2 % 7
        x3 = x2 // 7
        purch = x3 % 20
        x4 = x3 // 20
        credit = x4 % 4
        x5 = x4 // 4
        dep = x5 % 7
        x6 = x5 // 7
        depemp = x6 % 7
        depcol = (x6 // 7) % 7
        lz.put("cd_demo_sk", lambda: sk)
        lz.put("cd_gender", lambda: gender.to(torch.int32))
        lz.put("cd_marital_status", lambda: marital.to(torch.int32))
        lz.put("cd_education_status", lambda: edu.to(torch.int32))
        lz.put("cd_purchase_estimate",
               lambda: ((purch + 1) * 500).to(torch.int32))
        lz.put("cd_credit_rating", lambda: credit.to(torch.int32))
        lz.put("cd_dep_count", lambda: dep.to(torch.int32))
        lz.put("cd_dep_employed_count", lambda: depemp.to(torch.int32))
        lz.put("cd_dep_college_count", lambda: depcol.to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_household_demographics_at(self, idx) -> _Lazy:
        """20 income bands x 6 buy potentials x 10 dep x 6 vehicles."""
        sk = idx + 1
        x = sk - 1
        lz = _Lazy()
        lz.put("hd_demo_sk", lambda: sk)
        lz.put("hd_income_band_sk", lambda: x % 20 + 1)
        lz.put("hd_buy_potential",
               lambda: ((x // 20) % 6).to(torch.int32))
        lz.put("hd_dep_count", lambda: ((x // 120) % 10).to(torch.int32))
        lz.put("hd_vehicle_count",
               lambda: ((x // 1200) % 6).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_income_band_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()
        lz.put("ib_income_band_sk", lambda: sk)
        lz.put("ib_lower_bound", lambda: (
            (sk - 1) * 10_000 + torch.where(sk > 1, 1, 0)).to(torch.int32))
        lz.put("ib_upper_bound", lambda: (sk * 10_000).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_promotion_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()
        lz.put("p_promo_sk", lambda: sk)
        lz.put("p_promo_id", lambda: (sk - 1).to(torch.int32))
        lz.put("p_promo_name", lambda: (
            (sk - 1) % len(PROMO_NAMES)).to(torch.int32))
        lz.put("p_cost", lambda: torch.full_like(idx, 100_000))
        lz.put("p_response_target", lambda: torch.ones_like(idx, dtype=torch.int32))
        lz.put("p_channel_dmail", lambda: _unif(
            sk, "promotion", "dmail", 0, 1).to(torch.int32))
        lz.put("p_channel_email", lambda: _unif(
            sk, "promotion", "email", 0, 1).to(torch.int32))
        lz.put("p_channel_tv", lambda: _unif(
            sk, "promotion", "tv", 0, 1).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    # ----------------------------------------------------- store channel

    def _ticket_values(self, ticket: torch.Tensor) -> _Lazy:
        """Per-ticket (visit-level) draws shared by every line (LAZY:
        each field traces only when pulled — see _Lazy)."""
        v = _Lazy()
        v.put("customer", lambda: _unif(
            ticket, "store_sales", "customer", 1, self.n_customer))
        v.put("cdemo", lambda: _unif(
            ticket, "store_sales", "cdemo", 1, self.n_cdemo))
        v.put("hdemo", lambda: _unif(
            ticket, "store_sales", "hdemo", 1, self.n_hdemo))
        v.put("addr", lambda: _unif(
            ticket, "store_sales", "addr", 1, self.n_addr))
        v.put("store", lambda: _unif(
            ticket, "store_sales", "store", 1, self.n_store))
        v.put("day", lambda: _unif(
            ticket, "store_sales", "day", SALES_START, SALES_END))
        v.put("nlines", lambda: _unif(
            ticket, "store_sales", "nlines", 1, MAX_LINES))
        return v

    @staticmethod
    def _line_money(stream: str, key: torch.Tensor) -> _Lazy:
        """The per-line pricing model every sales channel shares
        (wholesale -> markup list price -> discounted sale price -> tax),
        drawn from the channel's own RNG streams. net_paid here has no
        coupon; the store channel overlays its coupon on top."""
        m = _Lazy()
        m.put("qty", lambda: _unif(key, stream, "qty", 1, 100))
        m.put("whole", lambda: _unif(key, stream, "wholesale",
                                     100, 10_000))
        m.put("lst", lambda: (
            m["whole"] * _unif(key, stream, "markup", 100, 300)
            // 100))
        m.put("sprice", lambda: (
            m["lst"] * (100 - _unif(key, stream, "disc",
                                               0, 100))
            // 100))
        m.put("taxp", lambda: _unif(key, stream, "taxp", 0, 9))
        m.put("ext_sales", lambda: m["qty"] * m["sprice"])
        m.put("net_paid", lambda: m["ext_sales"])
        m.put("ext_tax", lambda: (
            m["ext_sales"] * m["taxp"] // 100))
        return m

    def _ss_values(self, slot: torch.Tensor) -> _Lazy:
        """Per-slot store_sales values: pure functions of the global slot
        index (ticket * MAX_LINES + line-1); shared by store_returns and
        the catalog re-purchase correlation."""
        ticket = slot // MAX_LINES
        line = slot % MAX_LINES + 1
        tv = self._ticket_values(ticket)
        key = slot
        m = self._line_money("store_sales", key)
        v = _Lazy()
        v.merge(m)
        v.merge(tv)
        v.put("ticket", lambda: ticket)
        v.put("line", lambda: line)
        v.put("key", lambda: key)
        v.put("coupon", lambda: torch.where(
            _unif(key, "store_sales", "hascoup", 0, 9) < 2,
            m["ext_sales"] * _unif(key, "store_sales", "cfrac", 0, 50)
            // 100,
            0,
        ))
        # store channel overlays the coupon on the shared money model
        v.put("net_paid", lambda: m["ext_sales"] - v["coupon"])
        v.put("ext_tax", lambda: (
            v["net_paid"] * m["taxp"] // 100))
        v.put("valid", lambda: line <= tv["nlines"])
        v.put("returned", lambda: v["valid"] & (
            _unif(key, "store_returns", "flag", 0, 99) < SS_RETURN_PCT
        ))
        # items within a ticket are DISTINCT (dsdgen picks store-order
        # items from a permutation): base + line*stride mod n_item with
        # stride < n_item/MAX_LINES guarantees the 11 lines collide
        # never — and (ss_ticket_number, ss_item_sk) is a true key,
        # which the windowed generated join relies on
        v.put("item", lambda: (
            _unif(ticket, "store_sales", "itembase", 0, self.n_item - 1)
            + line * (1 + _unif(
                ticket, "store_sales", "itemstride", 0,
                max(self.n_item // (MAX_LINES + 1) - 1, 0)))
        ) % self.n_item + 1)
        v.put("promo", lambda: _unif(
            key, "store_sales", "promo", 1, self.n_promo))
        return v

    def _gen_store_sales_at(self, idx) -> _Lazy:
        slot = idx
        lz = _Lazy()

        @functools.lru_cache(maxsize=1)
        def sv():
            return self._ss_values(slot)

        lz.put("ss_sold_date_sk",
               lambda: sv()["day"] + JULIAN_BASE)
        lz.put("ss_sold_time_sk", lambda: _unif(
            slot, "store_sales", "time", 28800, 75600))
        lz.put("ss_item_sk", lambda: sv()["item"])
        lz.put("ss_customer_sk", lambda: sv()["customer"])
        lz.put("ss_cdemo_sk", lambda: sv()["cdemo"])
        lz.put("ss_hdemo_sk", lambda: sv()["hdemo"])
        lz.put("ss_addr_sk", lambda: sv()["addr"])
        lz.put("ss_store_sk", lambda: sv()["store"])
        lz.put("ss_promo_sk", lambda: sv()["promo"])
        lz.put("ss_ticket_number", lambda: sv()["ticket"] + 1)
        lz.put("ss_quantity", lambda: sv()["qty"].to(torch.int32))
        lz.put("ss_wholesale_cost", lambda: sv()["whole"])
        lz.put("ss_list_price", lambda: sv()["lst"])
        lz.put("ss_sales_price", lambda: sv()["sprice"])
        lz.put("ss_ext_discount_amt",
               lambda: sv()["qty"] * (sv()["lst"] - sv()["sprice"]))
        lz.put("ss_ext_sales_price", lambda: sv()["ext_sales"])
        lz.put("ss_ext_wholesale_cost",
               lambda: sv()["qty"] * sv()["whole"])
        lz.put("ss_ext_list_price", lambda: sv()["qty"] * sv()["lst"])
        lz.put("ss_ext_tax", lambda: sv()["ext_tax"])
        lz.put("ss_coupon_amt", lambda: sv()["coupon"])
        lz.put("ss_net_paid", lambda: sv()["net_paid"])
        lz.put("ss_net_paid_inc_tax",
               lambda: sv()["net_paid"] + sv()["ext_tax"])
        lz.put("ss_net_profit", lambda: (
            sv()["net_paid"] - sv()["qty"] * sv()["whole"]))
        lz.put("__valid__", lambda: sv()["valid"])
        return lz

    @staticmethod
    def _return_money(stream: str, key, sv: _Lazy) -> _Lazy:
        """Shared return-line money model for both channels: quantity,
        amount/tax, and the refunded/reversed/store-credit split of the
        amount (stream names the RNG streams so the channels differ).
        sv supplies the sale line's qty/sprice/taxp/day lazily."""
        rv = _Lazy()
        rv.put("rqty", lambda: (
            _unif(key, stream, "qty", 1, 100) % sv["qty"] + 1))
        rv.put("ramt", lambda: rv["rqty"] * sv["sprice"])
        rv.put("rtax", lambda: (
            rv["ramt"] * sv["taxp"] // 100))
        rv.put("refunded", lambda: (
            rv["ramt"] * _unif(key, stream, "reffrac", 0, 100)
            // 100))
        rv.put("reversed_c", lambda: (
            (rv["ramt"] - rv["refunded"])
            * _unif(key, stream, "revfrac", 0, 100) // 100))
        rv.put("credit", lambda: (
            rv["ramt"] - rv["refunded"] - rv["reversed_c"]))
        rv.put("fee", lambda: _unif(key, stream, "fee", 100, 10_000))
        rv.put("ship", lambda: _unif(key, stream, "ship", 0, 5_000))
        rv.put("rday", lambda: (
            sv["day"] + _unif(key, stream, "lag", 1, 90)))
        return rv

    def _sr_values(self, slot: torch.Tensor) -> _Lazy:
        sv = self._ss_values(slot)
        rv = self._return_money("store_returns", slot, sv)
        rv.put("sv", lambda: sv)
        return rv

    def _gen_store_returns_at(self, idx) -> _Lazy:
        slot = idx
        lz = _Lazy()

        @functools.lru_cache(maxsize=1)
        def rv():
            return self._sr_values(slot)

        def sv():
            return rv()["sv"]

        lz.put("sr_returned_date_sk",
               lambda: rv()["rday"] + JULIAN_BASE)
        lz.put("sr_return_time_sk", lambda: _unif(
            slot, "store_returns", "time", 28800, 75600))
        lz.put("sr_item_sk", lambda: sv()["item"])
        lz.put("sr_customer_sk", lambda: sv()["customer"])
        lz.put("sr_cdemo_sk", lambda: sv()["cdemo"])
        lz.put("sr_hdemo_sk", lambda: sv()["hdemo"])
        lz.put("sr_addr_sk", lambda: sv()["addr"])
        lz.put("sr_store_sk", lambda: sv()["store"])
        lz.put("sr_reason_sk", lambda: _unif(
            slot, "store_returns", "reason", 1, self.n_reason))
        lz.put("sr_ticket_number", lambda: sv()["ticket"] + 1)
        lz.put("sr_return_quantity",
               lambda: rv()["rqty"].to(torch.int32))
        lz.put("sr_return_amt", lambda: rv()["ramt"])
        lz.put("sr_return_tax", lambda: rv()["rtax"])
        lz.put("sr_return_amt_inc_tax",
               lambda: rv()["ramt"] + rv()["rtax"])
        lz.put("sr_fee", lambda: rv()["fee"])
        lz.put("sr_return_ship_cost", lambda: rv()["ship"])
        lz.put("sr_refunded_cash", lambda: rv()["refunded"])
        lz.put("sr_reversed_charge", lambda: rv()["reversed_c"])
        lz.put("sr_store_credit", lambda: rv()["credit"])
        lz.put("sr_net_loss", lambda: (
            rv()["fee"] + rv()["ship"] + rv()["rtax"]))
        lz.put("__valid__", lambda: sv()["returned"])
        return lz

    # ---------------------------------------------------- catalog channel

    def _cs_values(self, slot: torch.Tensor) -> _Lazy:
        """Per-slot catalog_sales values. The re-purchase correlation: a
        line targets a pseudo-random store-sales slot; when that slot is a
        returned sale (and this line drew the 30% correlation), the line
        copies the return's (customer, item) and is dated after it."""
        order = slot // MAX_LINES
        line = slot % MAX_LINES + 1
        key = slot
        m = self._line_money("catalog_sales", key)
        v = _Lazy()
        v.merge(m)
        v.put("order", lambda: order)
        v.put("line", lambda: line)
        v.put("key", lambda: key)
        v.put("valid", lambda: line <= _unif(
            order, "catalog_sales", "nlines", 1, MAX_LINES))
        # correlation target: a returned store sale re-purchased by
        # catalog; pure function of the target slot index
        n_ss = self.n_ticket * MAX_LINES

        def t_vals():
            t_slot = _unif(key, "catalog_sales", "corrslot", 0, n_ss - 1)
            return self._sr_values(t_slot)

        v.put("_t", t_vals)
        v.put("corr", lambda: v["valid"] & v["_t"]["sv"]["returned"] & (
            _unif(key, "catalog_sales", "corr", 0, 99)
            < CS_REPURCHASE_PCT
        ))
        v.put("customer", lambda: torch.where(
            v["corr"], v["_t"]["sv"]["customer"],
            _unif(order, "catalog_sales", "customer",
                  1, self.n_customer),
        ))
        v.put("item", lambda: torch.where(
            v["corr"], v["_t"]["sv"]["item"],
            _unif(key, "catalog_sales", "item", 1, self.n_item),
        ))
        v.put("day", lambda: torch.where(
                v["corr"],
                v["_t"]["rday"] + _unif(key, "catalog_sales",
                                        "lag", 1, 60),
                _unif(order, "catalog_sales", "day",
                      SALES_START, SALES_END),
            ).clamp(SALES_START, SALES_END))
        v.put("returned", lambda: v["valid"] & (
            _unif(key, "catalog_returns", "flag", 0, 99) < CS_RETURN_PCT
        ))
        v.put("cdemo", lambda: _unif(
            order, "catalog_sales", "cdemo", 1, self.n_cdemo))
        v.put("hdemo", lambda: _unif(
            order, "catalog_sales", "hdemo", 1, self.n_hdemo))
        v.put("addr", lambda: _unif(
            order, "catalog_sales", "addr", 1, self.n_addr))
        v.put("promo", lambda: _unif(
            key, "catalog_sales", "promo", 1, self.n_promo))
        return v

    def _gen_catalog_sales_at(self, idx) -> _Lazy:
        slot = idx
        lz = _Lazy()

        @functools.lru_cache(maxsize=1)
        def cv():
            return self._cs_values(slot)

        lz.put("cs_sold_date_sk",
               lambda: cv()["day"] + JULIAN_BASE)
        lz.put("cs_ship_date_sk", lambda: (
            cv()["day"] + _unif(slot, "catalog_sales", "shiplag", 2, 30)
            + JULIAN_BASE))
        lz.put("cs_bill_customer_sk", lambda: cv()["customer"])
        lz.put("cs_bill_cdemo_sk", lambda: cv()["cdemo"])
        lz.put("cs_bill_hdemo_sk", lambda: cv()["hdemo"])
        lz.put("cs_bill_addr_sk", lambda: cv()["addr"])
        lz.put("cs_ship_customer_sk", lambda: cv()["customer"])
        lz.put("cs_ship_addr_sk", lambda: cv()["addr"])
        lz.put("cs_item_sk", lambda: cv()["item"])
        lz.put("cs_promo_sk", lambda: cv()["promo"])
        lz.put("cs_order_number", lambda: cv()["order"] + 1)
        lz.put("cs_quantity", lambda: cv()["qty"].to(torch.int32))
        lz.put("cs_wholesale_cost", lambda: cv()["whole"])
        lz.put("cs_list_price", lambda: cv()["lst"])
        lz.put("cs_sales_price", lambda: cv()["sprice"])
        lz.put("cs_ext_discount_amt",
               lambda: cv()["qty"] * (cv()["lst"] - cv()["sprice"]))
        lz.put("cs_ext_sales_price", lambda: cv()["ext_sales"])
        lz.put("cs_ext_wholesale_cost",
               lambda: cv()["qty"] * cv()["whole"])
        lz.put("cs_ext_list_price", lambda: cv()["qty"] * cv()["lst"])
        lz.put("cs_ext_tax", lambda: cv()["ext_tax"])
        lz.put("cs_coupon_amt", lambda: torch.zeros_like(idx, dtype=torch.int64))
        lz.put("cs_ext_ship_cost", lambda: _unif(
            slot, "catalog_sales", "shipcost", 0, 5_000))
        lz.put("cs_net_paid", lambda: cv()["net_paid"])
        lz.put("cs_net_paid_inc_tax",
               lambda: cv()["net_paid"] + cv()["ext_tax"])
        lz.put("cs_net_profit", lambda: (
            cv()["net_paid"] - cv()["qty"] * cv()["whole"]))
        lz.put("__valid__", lambda: cv()["valid"])
        return lz

    def _gen_catalog_returns_at(self, idx) -> _Lazy:
        slot = idx
        lz = _Lazy()

        @functools.lru_cache(maxsize=1)
        def cv():
            return self._cs_values(slot)

        @functools.lru_cache(maxsize=1)
        def rv():
            c = cv()
            return self._return_money("catalog_returns", c["key"], c)

        lz.put("cr_returned_date_sk",
               lambda: rv()["rday"] + JULIAN_BASE)
        lz.put("cr_item_sk", lambda: cv()["item"])
        lz.put("cr_refunded_customer_sk", lambda: cv()["customer"])
        lz.put("cr_returning_customer_sk", lambda: cv()["customer"])
        lz.put("cr_order_number", lambda: cv()["order"] + 1)
        lz.put("cr_return_quantity",
               lambda: rv()["rqty"].to(torch.int32))
        lz.put("cr_return_amount", lambda: rv()["ramt"])
        lz.put("cr_return_tax", lambda: rv()["rtax"])
        lz.put("cr_return_amt_inc_tax",
               lambda: rv()["ramt"] + rv()["rtax"])
        lz.put("cr_fee", lambda: rv()["fee"])
        lz.put("cr_return_ship_cost", lambda: rv()["ship"])
        lz.put("cr_refunded_cash", lambda: rv()["refunded"])
        lz.put("cr_reversed_charge", lambda: rv()["reversed_c"])
        lz.put("cr_store_credit", lambda: rv()["credit"])
        lz.put("cr_net_loss", lambda: (
            rv()["fee"] + rv()["ship"] + rv()["rtax"]))
        lz.put("cr_reason_sk", lambda: _unif(
            cv()["key"], "catalog_returns", "reason", 1, self.n_reason))
        lz.put("__valid__", lambda: cv()["returned"])
        return lz

    # ------------------------------------------------- remaining dims
    # (round 3: the 24-table census — web channel, inventory, and the
    # small dimensions the long-tail queries touch)

    def _gen_warehouse_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()
        lz.put("w_warehouse_sk", lambda: sk)
        lz.put("w_warehouse_id", lambda: (sk - 1).to(torch.int32))
        lz.put("w_warehouse_name", lambda: _unif(
            sk, "warehouse", "name", 0, 1023).to(torch.int32))
        lz.put("w_warehouse_sq_ft", lambda: _unif(
            sk, "warehouse", "sqft", 50_000, 1_000_000).to(torch.int32))
        lz.put("w_city", lambda: _unif(
            sk, "warehouse", "city", 0, 1023).to(torch.int32))
        lz.put("w_county", lambda: _unif(
            sk, "warehouse", "county", 0, 63).to(torch.int32))
        lz.put("w_state", lambda: _unif(
            sk, "warehouse", "state", 0, len(STATES) - 1
        ).to(torch.int32))
        lz.put("w_zip", lambda: _unif(
            sk, "warehouse", "zip", 0, 4095).to(torch.int32))
        lz.put("w_country", lambda: torch.zeros_like(idx, dtype=torch.int32))
        lz.put("w_gmt_offset", lambda: -100 * _unif(
            sk, "warehouse", "gmt", 5, 8))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_ship_mode_at(self, idx) -> _Lazy:
        sk = idx + 1
        x = sk - 1
        lz = _Lazy()
        lz.put("sm_ship_mode_sk", lambda: sk)
        lz.put("sm_ship_mode_id", lambda: x.to(torch.int32))
        lz.put("sm_type", lambda: (
            x % len(SHIP_TYPES)).to(torch.int32))
        lz.put("sm_code", lambda: (
            (x // len(SHIP_TYPES)) % len(SHIP_CODES)).to(torch.int32))
        lz.put("sm_carrier", lambda: (
            x % len(SHIP_CARRIERS)).to(torch.int32))
        lz.put("sm_contract", lambda: _unif(
            sk, "ship_mode", "contract", 0, 1023).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_reason_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()
        lz.put("r_reason_sk", lambda: sk)
        lz.put("r_reason_id", lambda: (sk - 1).to(torch.int32))
        lz.put("r_reason_desc", lambda: (
            (sk - 1) % len(REASON_DESCS)).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_time_dim_at(self, idx) -> _Lazy:
        """86,400 rows, one per second of day; every column decodes
        arithmetically from t_time_sk (like date_dim from the day
        index)."""
        sk = idx
        hour = sk // 3600
        lz = _Lazy()
        lz.put("t_time_sk", lambda: sk)
        lz.put("t_time_id", lambda: sk.to(torch.int32))
        lz.put("t_time", lambda: sk.to(torch.int32))
        lz.put("t_hour", lambda: hour.to(torch.int32))
        lz.put("t_minute", lambda: ((sk // 60) % 60).to(torch.int32))
        lz.put("t_second", lambda: (sk % 60).to(torch.int32))
        lz.put("t_am_pm", lambda: (hour >= 12).to(torch.int32))
        lz.put("t_shift", lambda: (hour // 8).to(torch.int32))
        lz.put("t_sub_shift", lambda: (
            (hour - 4) // 6).clamp(0, 3).to(torch.int32))
        lz.put("t_meal_time", lambda: torch.where(
            (hour >= 6) & (hour <= 8), 1,
            torch.where((hour >= 11) & (hour <= 13), 2,
                      torch.where((hour >= 17) & (hour <= 19), 3, 0)),
        ).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_call_center_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()
        lz.put("cc_call_center_sk", lambda: sk)
        lz.put("cc_call_center_id", lambda: (sk - 1).to(torch.int32))
        lz.put("cc_name", lambda: (
            (sk - 1) % len(CC_NAMES)).to(torch.int32))
        lz.put("cc_class", lambda: (
            (sk - 1) % 3).to(torch.int32))
        lz.put("cc_employees", lambda: _unif(
            sk, "call_center", "emp", 10, 700).to(torch.int32))
        lz.put("cc_sq_ft", lambda: _unif(
            sk, "call_center", "sqft", 1_000, 50_000).to(torch.int32))
        lz.put("cc_hours", lambda: (
            (sk - 1) % len(HOURS)).to(torch.int32))
        lz.put("cc_manager", lambda: _unif(
            sk, "call_center", "mgr", 0, 511).to(torch.int32))
        lz.put("cc_market_id", lambda: _unif(
            sk, "call_center", "mkt", 1, 6).to(torch.int32))
        lz.put("cc_county", lambda: _unif(
            sk, "call_center", "county", 0, 63).to(torch.int32))
        lz.put("cc_state", lambda: _unif(
            sk, "call_center", "state", 0, len(STATES) - 1
        ).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_catalog_page_at(self, idx) -> _Lazy:
        sk = idx + 1
        pages_per_cat = 108  # spec: ~108 pages per catalog number
        lz = _Lazy()
        lz.put("cp_catalog_page_sk", lambda: sk)
        lz.put("cp_catalog_page_id", lambda: (sk - 1).to(torch.int32))
        lz.put("cp_start_date_sk", lambda: JULIAN_BASE
               + SALES_START + ((sk - 1) // pages_per_cat) * 30)
        lz.put("cp_end_date_sk", lambda: JULIAN_BASE
               + SALES_START + ((sk - 1) // pages_per_cat) * 30 + 90)
        lz.put("cp_department", lambda: torch.zeros_like(idx, dtype=torch.int32))
        lz.put("cp_catalog_number", lambda: (
            (sk - 1) // pages_per_cat + 1).to(torch.int32))
        lz.put("cp_catalog_page_number", lambda: (
            (sk - 1) % pages_per_cat + 1).to(torch.int32))
        lz.put("cp_description", lambda: _unif(
            sk, "catalog_page", "desc", 0, 4095).to(torch.int32))
        lz.put("cp_type", lambda: (
            (sk - 1) % 3).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_web_site_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()
        lz.put("web_site_sk", lambda: sk)
        lz.put("web_site_id", lambda: (sk - 1).to(torch.int32))
        lz.put("web_name", lambda: (
            (sk - 1) % 6).to(torch.int32))
        lz.put("web_open_date_sk", lambda: JULIAN_BASE
               + SALES_START - _unif(sk, "web_site", "open", 100, 2000))
        lz.put("web_manager", lambda: _unif(
            sk, "web_site", "mgr", 0, 511).to(torch.int32))
        lz.put("web_market_id", lambda: _unif(
            sk, "web_site", "mkt", 1, 6).to(torch.int32))
        lz.put("web_company_id", lambda: (
            (sk - 1) % 6 + 1).to(torch.int32))
        lz.put("web_company_name", lambda: (
            (sk - 1) % 6).to(torch.int32))
        lz.put("web_gmt_offset", lambda: -100 * _unif(
            sk, "web_site", "gmt", 5, 8))
        lz.put("web_tax_percentage", lambda: _unif(
            sk, "web_site", "tax", 0, 12))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_web_page_at(self, idx) -> _Lazy:
        sk = idx + 1
        lz = _Lazy()
        lz.put("wp_web_page_sk", lambda: sk)
        lz.put("wp_web_page_id", lambda: (sk - 1).to(torch.int32))
        lz.put("wp_creation_date_sk", lambda: JULIAN_BASE
               + SALES_START - _unif(sk, "web_page", "created", 1, 1000))
        lz.put("wp_access_date_sk", lambda: JULIAN_BASE
               + SALES_START + _unif(sk, "web_page", "access", 0, 100))
        lz.put("wp_autogen_flag", lambda: _unif(
            sk, "web_page", "autogen", 0, 1).to(torch.int32))
        lz.put("wp_customer_sk", lambda: _unif(
            sk, "web_page", "cust", 1, self.n_customer))
        lz.put("wp_url", lambda: torch.zeros_like(idx, dtype=torch.int32))
        lz.put("wp_type", lambda: (
            (sk - 1) % len(WP_TYPES)).to(torch.int32))
        lz.put("wp_char_count", lambda: _unif(
            sk, "web_page", "chars", 100, 8_000).to(torch.int32))
        lz.put("wp_link_count", lambda: _unif(
            sk, "web_page", "links", 2, 25).to(torch.int32))
        lz.put("wp_image_count", lambda: _unif(
            sk, "web_page", "images", 1, 7).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    def _gen_inventory_at(self, idx) -> _Lazy:
        """Weekly (date x item x warehouse) cross product, decoded
        mixed-radix from the row index — the spec's weekly snapshots."""
        wh = idx % self.n_warehouse
        rest = idx // self.n_warehouse
        item = rest % self.n_item
        week = rest // self.n_item
        lz = _Lazy()
        lz.put("inv_date_sk", lambda: JULIAN_BASE
               + SALES_START + week * 7)
        lz.put("inv_item_sk", lambda: item + 1)
        lz.put("inv_warehouse_sk", lambda: wh + 1)
        lz.put("inv_quantity_on_hand", lambda: _unif(
            idx, "inventory", "qoh", 0, 1_000).to(torch.int32))
        lz.put("__valid__", lambda: torch.ones_like(idx, dtype=torch.bool))
        return lz

    # ------------------------------------------------------ web channel

    def _ws_values(self, slot: torch.Tensor) -> _Lazy:
        """Per-slot web_sales values; order-structured like the catalog
        channel (order = one customer session, 1..11 live lines)."""
        order = slot // MAX_LINES
        line = slot % MAX_LINES + 1
        key = slot
        m = self._line_money("web_sales", key)
        v = _Lazy()
        v.merge(m)
        v.put("order", lambda: order)
        v.put("line", lambda: line)
        v.put("key", lambda: key)
        v.put("valid", lambda: line <= _unif(
            order, "web_sales", "nlines", 1, MAX_LINES))
        v.put("returned", lambda: v["valid"] & (
            _unif(key, "web_returns", "flag", 0, 99) < WS_RETURN_PCT
        ))
        v.put("customer", lambda: _unif(
            order, "web_sales", "customer", 1, self.n_customer))
        v.put("cdemo", lambda: _unif(
            order, "web_sales", "cdemo", 1, self.n_cdemo))
        v.put("hdemo", lambda: _unif(
            order, "web_sales", "hdemo", 1, self.n_hdemo))
        v.put("addr", lambda: _unif(
            order, "web_sales", "addr", 1, self.n_addr))
        v.put("site", lambda: _unif(
            order, "web_sales", "site", 1, self.n_web_site))
        v.put("page", lambda: _unif(
            order, "web_sales", "page", 1, self.n_web_page))
        v.put("day", lambda: _unif(
            order, "web_sales", "day", SALES_START, SALES_END))
        v.put("tod", lambda: _unif(order, "web_sales", "tod", 0, 86_399))
        v.put("warehouse", lambda: _unif(
            key, "web_sales", "wh", 1, self.n_warehouse))
        v.put("ship_mode", lambda: _unif(
            key, "web_sales", "sm", 1, self.n_ship_mode))
        v.put("item", lambda: _unif(
            key, "web_sales", "item", 1, self.n_item))
        v.put("promo", lambda: _unif(
            key, "web_sales", "promo", 1, self.n_promo))
        return v

    def _gen_web_sales_at(self, idx) -> _Lazy:
        slot = idx
        lz = _Lazy()

        @functools.lru_cache(maxsize=1)
        def wv():
            return self._ws_values(slot)

        lz.put("ws_sold_date_sk",
               lambda: wv()["day"] + JULIAN_BASE)
        lz.put("ws_sold_time_sk", lambda: wv()["tod"])
        lz.put("ws_ship_date_sk", lambda: (
            # up to 120 days so Q62's 30/60/90+ buckets all populate
            wv()["day"] + _unif(slot, "web_sales", "shiplag", 2, 120)
            + JULIAN_BASE))
        lz.put("ws_bill_customer_sk", lambda: wv()["customer"])
        lz.put("ws_bill_cdemo_sk", lambda: wv()["cdemo"])
        lz.put("ws_bill_hdemo_sk", lambda: wv()["hdemo"])
        lz.put("ws_bill_addr_sk", lambda: wv()["addr"])
        lz.put("ws_ship_customer_sk", lambda: wv()["customer"])
        lz.put("ws_ship_addr_sk", lambda: wv()["addr"])
        lz.put("ws_web_site_sk", lambda: wv()["site"])
        lz.put("ws_web_page_sk", lambda: wv()["page"])
        lz.put("ws_warehouse_sk", lambda: wv()["warehouse"])
        lz.put("ws_ship_mode_sk", lambda: wv()["ship_mode"])
        lz.put("ws_item_sk", lambda: wv()["item"])
        lz.put("ws_promo_sk", lambda: wv()["promo"])
        lz.put("ws_order_number", lambda: wv()["order"] + 1)
        lz.put("ws_quantity", lambda: wv()["qty"].to(torch.int32))
        lz.put("ws_wholesale_cost", lambda: wv()["whole"])
        lz.put("ws_list_price", lambda: wv()["lst"])
        lz.put("ws_sales_price", lambda: wv()["sprice"])
        lz.put("ws_ext_discount_amt",
               lambda: wv()["qty"] * (wv()["lst"] - wv()["sprice"]))
        lz.put("ws_ext_sales_price", lambda: wv()["ext_sales"])
        lz.put("ws_ext_wholesale_cost",
               lambda: wv()["qty"] * wv()["whole"])
        lz.put("ws_ext_list_price", lambda: wv()["qty"] * wv()["lst"])
        lz.put("ws_ext_tax", lambda: wv()["ext_tax"])
        lz.put("ws_coupon_amt", lambda: torch.zeros_like(idx, dtype=torch.int64))
        lz.put("ws_ext_ship_cost", lambda: _unif(
            slot, "web_sales", "shipcost", 0, 5_000))
        lz.put("ws_net_paid", lambda: wv()["net_paid"])
        lz.put("ws_net_paid_inc_tax",
               lambda: wv()["net_paid"] + wv()["ext_tax"])
        lz.put("ws_net_profit", lambda: (
            wv()["net_paid"] - wv()["qty"] * wv()["whole"]))
        lz.put("__valid__", lambda: wv()["valid"])
        return lz

    def _gen_web_returns_at(self, idx) -> _Lazy:
        slot = idx
        lz = _Lazy()

        @functools.lru_cache(maxsize=1)
        def wv():
            return self._ws_values(slot)

        @functools.lru_cache(maxsize=1)
        def rv():
            w = wv()
            return self._return_money("web_returns", w["key"], w)

        lz.put("wr_returned_date_sk",
               lambda: rv()["rday"] + JULIAN_BASE)
        lz.put("wr_item_sk", lambda: wv()["item"])
        lz.put("wr_refunded_customer_sk", lambda: wv()["customer"])
        lz.put("wr_returning_customer_sk", lambda: wv()["customer"])
        lz.put("wr_web_page_sk", lambda: wv()["page"])
        lz.put("wr_order_number", lambda: wv()["order"] + 1)
        lz.put("wr_reason_sk", lambda: _unif(
            wv()["key"], "web_returns", "reason", 1, self.n_reason))
        lz.put("wr_return_quantity",
               lambda: rv()["rqty"].to(torch.int32))
        lz.put("wr_return_amt", lambda: rv()["ramt"])
        lz.put("wr_return_tax", lambda: rv()["rtax"])
        lz.put("wr_return_amt_inc_tax",
               lambda: rv()["ramt"] + rv()["rtax"])
        lz.put("wr_fee", lambda: rv()["fee"])
        lz.put("wr_return_ship_cost", lambda: rv()["ship"])
        lz.put("wr_refunded_cash", lambda: rv()["refunded"])
        lz.put("wr_reversed_charge", lambda: rv()["reversed_c"])
        lz.put("wr_account_credit", lambda: rv()["credit"])
        lz.put("wr_net_loss", lambda: (
            rv()["fee"] + rv()["ship"] + rv()["rtax"]))
        lz.put("__valid__", lambda: wv()["returned"])
        return lz


def _build_schemas() -> Dict[str, TableSchema]:
    V = T.VARCHAR
    B = T.BIGINT
    I = T.INTEGER  # noqa: E741

    def tbl(name, *cols):
        return TableSchema(name, tuple(ColumnSchema(n, t) for n, t in cols))

    return {
        s.name: s
        for s in [
            tbl("date_dim",
                ("d_date_sk", B), ("d_date_id", V), ("d_date", T.DATE),
                ("d_month_seq", I), ("d_week_seq", I), ("d_year", I),
                ("d_dow", I), ("d_moy", I), ("d_dom", I), ("d_qoy", I),
                ("d_quarter_name", V), ("d_day_name", V),
                ("d_weekend", V), ("d_holiday", V), ("d_fy_year", I)),
            tbl("item",
                ("i_item_sk", B), ("i_item_id", V), ("i_item_desc", V),
                ("i_current_price", DEC72), ("i_wholesale_cost", DEC72),
                ("i_brand_id", I), ("i_brand", V), ("i_class_id", I),
                ("i_class", V), ("i_category_id", I), ("i_category", V),
                ("i_manufact_id", I), ("i_manager_id", I), ("i_size", V),
                ("i_color", V), ("i_units", V), ("i_product_name", V)),
            tbl("store",
                ("s_store_sk", B), ("s_store_id", V), ("s_store_name", V),
                ("s_number_employees", I), ("s_floor_space", I),
                ("s_hours", V), ("s_manager", V), ("s_market_id", I),
                ("s_company_id", I), ("s_city", V), ("s_county", V),
                ("s_state", V), ("s_zip", V), ("s_gmt_offset", DEC52),
                ("s_tax_precentage", DEC52)),
            tbl("customer",
                ("c_customer_sk", B), ("c_customer_id", V),
                ("c_current_cdemo_sk", B), ("c_current_hdemo_sk", B),
                ("c_current_addr_sk", B), ("c_first_shipto_date_sk", B),
                ("c_first_sales_date_sk", B), ("c_first_name", V),
                ("c_last_name", V), ("c_birth_day", I),
                ("c_birth_month", I), ("c_birth_year", I)),
            tbl("customer_address",
                ("ca_address_sk", B), ("ca_address_id", V),
                ("ca_street_number", V), ("ca_street_name", V),
                ("ca_street_type", V), ("ca_city", V), ("ca_county", V),
                ("ca_state", V), ("ca_zip", V), ("ca_country", V),
                ("ca_gmt_offset", DEC52), ("ca_location_type", V)),
            tbl("customer_demographics",
                ("cd_demo_sk", B), ("cd_gender", V),
                ("cd_marital_status", V), ("cd_education_status", V),
                ("cd_purchase_estimate", I), ("cd_credit_rating", V),
                ("cd_dep_count", I), ("cd_dep_employed_count", I),
                ("cd_dep_college_count", I)),
            tbl("household_demographics",
                ("hd_demo_sk", B), ("hd_income_band_sk", B),
                ("hd_buy_potential", V), ("hd_dep_count", I),
                ("hd_vehicle_count", I)),
            tbl("income_band",
                ("ib_income_band_sk", B), ("ib_lower_bound", I),
                ("ib_upper_bound", I)),
            tbl("promotion",
                ("p_promo_sk", B), ("p_promo_id", V), ("p_cost", DEC72),
                ("p_response_target", I), ("p_promo_name", V),
                ("p_channel_dmail", V), ("p_channel_email", V),
                ("p_channel_tv", V)),
            tbl("store_sales",
                ("ss_sold_date_sk", B), ("ss_sold_time_sk", B),
                ("ss_item_sk", B), ("ss_customer_sk", B),
                ("ss_cdemo_sk", B), ("ss_hdemo_sk", B), ("ss_addr_sk", B),
                ("ss_store_sk", B), ("ss_promo_sk", B),
                ("ss_ticket_number", B), ("ss_quantity", I),
                ("ss_wholesale_cost", DEC72), ("ss_list_price", DEC72),
                ("ss_sales_price", DEC72),
                ("ss_ext_discount_amt", DEC72),
                ("ss_ext_sales_price", DEC72),
                ("ss_ext_wholesale_cost", DEC72),
                ("ss_ext_list_price", DEC72), ("ss_ext_tax", DEC72),
                ("ss_coupon_amt", DEC72), ("ss_net_paid", DEC72),
                ("ss_net_paid_inc_tax", DEC72), ("ss_net_profit", DEC72)),
            tbl("store_returns",
                ("sr_returned_date_sk", B), ("sr_return_time_sk", B),
                ("sr_item_sk", B), ("sr_customer_sk", B),
                ("sr_cdemo_sk", B), ("sr_hdemo_sk", B), ("sr_addr_sk", B),
                ("sr_store_sk", B), ("sr_reason_sk", B),
                ("sr_ticket_number", B), ("sr_return_quantity", I),
                ("sr_return_amt", DEC72), ("sr_return_tax", DEC72),
                ("sr_return_amt_inc_tax", DEC72), ("sr_fee", DEC72),
                ("sr_return_ship_cost", DEC72),
                ("sr_refunded_cash", DEC72),
                ("sr_reversed_charge", DEC72),
                ("sr_store_credit", DEC72), ("sr_net_loss", DEC72)),
            tbl("catalog_sales",
                ("cs_sold_date_sk", B), ("cs_ship_date_sk", B),
                ("cs_bill_customer_sk", B), ("cs_bill_cdemo_sk", B),
                ("cs_bill_hdemo_sk", B), ("cs_bill_addr_sk", B),
                ("cs_ship_customer_sk", B), ("cs_ship_addr_sk", B),
                ("cs_item_sk", B), ("cs_promo_sk", B),
                ("cs_order_number", B), ("cs_quantity", I),
                ("cs_wholesale_cost", DEC72), ("cs_list_price", DEC72),
                ("cs_sales_price", DEC72),
                ("cs_ext_discount_amt", DEC72),
                ("cs_ext_sales_price", DEC72),
                ("cs_ext_wholesale_cost", DEC72),
                ("cs_ext_list_price", DEC72), ("cs_ext_tax", DEC72),
                ("cs_coupon_amt", DEC72), ("cs_ext_ship_cost", DEC72),
                ("cs_net_paid", DEC72), ("cs_net_paid_inc_tax", DEC72),
                ("cs_net_profit", DEC72)),
            tbl("catalog_returns",
                ("cr_returned_date_sk", B), ("cr_item_sk", B),
                ("cr_refunded_customer_sk", B),
                ("cr_returning_customer_sk", B), ("cr_order_number", B),
                ("cr_return_quantity", I), ("cr_return_amount", DEC72),
                ("cr_return_tax", DEC72),
                ("cr_return_amt_inc_tax", DEC72), ("cr_fee", DEC72),
                ("cr_return_ship_cost", DEC72),
                ("cr_refunded_cash", DEC72),
                ("cr_reversed_charge", DEC72),
                ("cr_store_credit", DEC72), ("cr_net_loss", DEC72),
                ("cr_reason_sk", B)),
            # ---- round 3: web channel + remaining dims (24 tables)
            tbl("warehouse",
                ("w_warehouse_sk", B), ("w_warehouse_id", V),
                ("w_warehouse_name", V), ("w_warehouse_sq_ft", I),
                ("w_city", V), ("w_county", V), ("w_state", V),
                ("w_zip", V), ("w_country", V),
                ("w_gmt_offset", DEC52)),
            tbl("ship_mode",
                ("sm_ship_mode_sk", B), ("sm_ship_mode_id", V),
                ("sm_type", V), ("sm_code", V), ("sm_carrier", V),
                ("sm_contract", V)),
            tbl("reason",
                ("r_reason_sk", B), ("r_reason_id", V),
                ("r_reason_desc", V)),
            tbl("time_dim",
                ("t_time_sk", B), ("t_time_id", V), ("t_time", I),
                ("t_hour", I), ("t_minute", I), ("t_second", I),
                ("t_am_pm", V), ("t_shift", V), ("t_sub_shift", V),
                ("t_meal_time", V)),
            tbl("call_center",
                ("cc_call_center_sk", B), ("cc_call_center_id", V),
                ("cc_name", V), ("cc_class", V), ("cc_employees", I),
                ("cc_sq_ft", I), ("cc_hours", V), ("cc_manager", V),
                ("cc_market_id", I), ("cc_county", V), ("cc_state", V)),
            tbl("catalog_page",
                ("cp_catalog_page_sk", B), ("cp_catalog_page_id", V),
                ("cp_start_date_sk", B), ("cp_end_date_sk", B),
                ("cp_department", V), ("cp_catalog_number", I),
                ("cp_catalog_page_number", I), ("cp_description", V),
                ("cp_type", V)),
            tbl("web_site",
                ("web_site_sk", B), ("web_site_id", V), ("web_name", V),
                ("web_open_date_sk", B), ("web_manager", V),
                ("web_market_id", I), ("web_company_id", I),
                ("web_company_name", V), ("web_gmt_offset", DEC52),
                ("web_tax_percentage", DEC52)),
            tbl("web_page",
                ("wp_web_page_sk", B), ("wp_web_page_id", V),
                ("wp_creation_date_sk", B), ("wp_access_date_sk", B),
                ("wp_autogen_flag", V), ("wp_customer_sk", B),
                ("wp_url", V), ("wp_type", V), ("wp_char_count", I),
                ("wp_link_count", I), ("wp_image_count", I)),
            tbl("inventory",
                ("inv_date_sk", B), ("inv_item_sk", B),
                ("inv_warehouse_sk", B), ("inv_quantity_on_hand", I)),
            tbl("web_sales",
                ("ws_sold_date_sk", B), ("ws_sold_time_sk", B),
                ("ws_ship_date_sk", B), ("ws_bill_customer_sk", B),
                ("ws_bill_cdemo_sk", B), ("ws_bill_hdemo_sk", B),
                ("ws_bill_addr_sk", B), ("ws_ship_customer_sk", B),
                ("ws_ship_addr_sk", B), ("ws_web_site_sk", B),
                ("ws_web_page_sk", B), ("ws_warehouse_sk", B),
                ("ws_ship_mode_sk", B), ("ws_item_sk", B),
                ("ws_promo_sk", B), ("ws_order_number", B),
                ("ws_quantity", I), ("ws_wholesale_cost", DEC72),
                ("ws_list_price", DEC72), ("ws_sales_price", DEC72),
                ("ws_ext_discount_amt", DEC72),
                ("ws_ext_sales_price", DEC72),
                ("ws_ext_wholesale_cost", DEC72),
                ("ws_ext_list_price", DEC72), ("ws_ext_tax", DEC72),
                ("ws_coupon_amt", DEC72), ("ws_ext_ship_cost", DEC72),
                ("ws_net_paid", DEC72), ("ws_net_paid_inc_tax", DEC72),
                ("ws_net_profit", DEC72)),
            tbl("web_returns",
                ("wr_returned_date_sk", B), ("wr_item_sk", B),
                ("wr_refunded_customer_sk", B),
                ("wr_returning_customer_sk", B), ("wr_web_page_sk", B),
                ("wr_order_number", B), ("wr_reason_sk", B),
                ("wr_return_quantity", I), ("wr_return_amt", DEC72),
                ("wr_return_tax", DEC72),
                ("wr_return_amt_inc_tax", DEC72), ("wr_fee", DEC72),
                ("wr_return_ship_cost", DEC72),
                ("wr_refunded_cash", DEC72),
                ("wr_reversed_charge", DEC72),
                ("wr_account_credit", DEC72), ("wr_net_loss", DEC72)),
        ]
    }
