"""Columnar Page/Block model over torch tensors.

Reference: presto-spi spi/Page.java (positionCount + Block[]) and
spi/block/*, through presto_tpu/page.py, whose contract this keeps
unchanged so every port module compares page by page with its
reference:

  - every Block tensor has length ``capacity`` (static, padded),
  - a per-page ``valid: bool[capacity]`` mask is the selection vector,
  - per-block ``nulls: bool[capacity]`` masks SQL NULLs (True = null),
  - strings are dictionary blocks: int32 codes + a host-side Dictionary.

Filtering flips bits in ``valid``; physical row compaction happens only
at join builds and blocking operators (presto_tpu_torch.ops.compact).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from presto_tpu_torch import types as T


def _round_up(n: int, multiple: int = 8) -> int:
    return ((max(n, 1) + multiple - 1) // multiple) * multiple


class Dictionary:
    """Immutable host-side value dictionary for string/binary blocks.

    Reference: spi/block/DictionaryBlock.java. Hashable by content so
    pages and caches can key on it."""

    __slots__ = ("values", "_index", "_hash")

    def __init__(self, values: Sequence[Any]):
        vals = list(values)
        # element-wise fill: np.array(list_of_equal_length_tuples) would
        # build a 2-D object array
        arr = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            arr[i] = v
        self.values = arr
        self._index = {v: i for i, v in enumerate(vals)}
        self._hash = hash(tuple(vals))

    def __len__(self) -> int:
        return len(self.values)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Dictionary)
            and self._hash == other._hash
            and len(self.values) == len(other.values)
            and all(a == b for a, b in zip(self.values, other.values))
        )

    def code_of(self, value: Any) -> int:
        """Code for value, or -1 if absent (-1 never matches any row code)."""
        return self._index.get(value, -1)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(codes.shape, dtype=object)
        in_range = (codes >= 0) & (codes < len(self.values))
        out[in_range] = self.values[codes[in_range]]
        out[~in_range] = None
        return out

    def sort_rank(self) -> np.ndarray:
        """rank[code] = position of that value in sorted order — makes code
        comparison order-correct for ORDER BY on dictionary columns."""
        order = np.argsort(self.values, kind="stable")
        rank = np.empty(len(self.values), dtype=np.int32)
        rank[order] = np.arange(len(self.values), dtype=np.int32)
        return rank

    def has_duplicate_values(self) -> bool:
        """Transform-produced dictionaries may map many codes to one
        value; equality on raw codes is then wrong (ops/keys)."""
        return len(self._index) < len(self.values)

    def __repr__(self) -> str:  # pragma: no cover
        head = ", ".join(repr(v) for v in self.values[:4])
        more = "..." if len(self.values) > 4 else ""
        return f"Dictionary([{head}{more}], n={len(self.values)})"


@dataclasses.dataclass
class Block:
    """One column of a Page.

    data: tensor [capacity] (dtype per SqlType.device_dtype). For long
          decimals (p > 18), a tuple (hi, lo) of int64 tensors.
    nulls: optional bool[capacity], True = SQL NULL. None = no nulls.
    type: SqlType.
    dictionary: host Dictionary for string/binary types.
    """

    data: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
    type: T.SqlType
    nulls: Optional[torch.Tensor] = None
    dictionary: Optional[Dictionary] = None

    @property
    def capacity(self) -> int:
        arr = self.data[0] if isinstance(self.data, tuple) else self.data
        return arr.shape[0]

    @property
    def device(self) -> torch.device:
        arr = self.data[0] if isinstance(self.data, tuple) else self.data
        return arr.device

    def nulls_or_false(self) -> torch.Tensor:
        if self.nulls is None:
            return torch.zeros(self.capacity, dtype=torch.bool,
                               device=self.device)
        return self.nulls

    def with_data(self, data, nulls="keep") -> "Block":
        return Block(
            data=data,
            type=self.type,
            nulls=self.nulls if nulls == "keep" else nulls,
            dictionary=self.dictionary,
        )

    def take(self, idx, extra_nulls=None) -> "Block":
        """Row gather: output row j = self row idx[j], with
        ``extra_nulls`` ORed over the gathered null mask. Callers clamp
        idx into range; masked-off rows gather garbage that validity and
        null masks hide."""
        if isinstance(self.data, tuple):
            data = tuple(d[idx] for d in self.data)
        else:
            data = self.data[idx]
        nulls = self.nulls[idx] if self.nulls is not None else None
        if extra_nulls is not None:
            nulls = extra_nulls if nulls is None else (nulls | extra_nulls)
        return Block(data=data, type=self.type, nulls=nulls,
                     dictionary=self.dictionary)


@dataclasses.dataclass
class Page:
    """A columnar batch: blocks + selection mask."""

    blocks: Tuple[Block, ...]
    valid: torch.Tensor  # bool[capacity]

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def channel_count(self) -> int:
        return len(self.blocks)

    def num_rows(self) -> torch.Tensor:
        """Device count of selected rows (no host sync)."""
        return self.valid.sum(dtype=torch.int64)

    def block(self, channel: int) -> Block:
        return self.blocks[channel]

    def with_valid(self, valid: torch.Tensor) -> "Page":
        return Page(blocks=self.blocks, valid=valid)

    def select_channels(self, channels: Sequence[int]) -> "Page":
        return Page(
            blocks=tuple(self.blocks[c] for c in channels), valid=self.valid
        )

    # ---------------------------------------------------------------- host IO
    @staticmethod
    def from_arrays(
        columns: Sequence[Any],
        types: Sequence[T.SqlType],
        *,
        capacity: Optional[int] = None,
        dictionaries: Optional[Sequence[Optional[Dictionary]]] = None,
        device="cpu",
    ) -> "Page":
        """Build a Page from host data (numpy arrays or Python lists; None =
        NULL). String columns are dictionary-encoded here."""
        if not columns:
            raise ValueError("page needs at least one column")
        n = len(columns[0])
        cap = capacity or _round_up(n)
        dictionaries = dictionaries or [None] * len(columns)
        blocks: List[Block] = []
        for col, typ, dic in zip(columns, types, dictionaries):
            blocks.append(_encode_column(col, typ, cap, dic, device))
        valid = np.zeros(cap, dtype=bool)
        valid[:n] = True
        # metered h2d boundary (exec/xfer.py; imported lazily — the page
        # module loads before the exec package)
        from presto_tpu_torch.exec import xfer as XF

        return Page(blocks=tuple(blocks),
                    valid=XF.to_device(valid, device, label="page-build"))

    def to_pylist(self) -> List[tuple]:
        """Materialize selected rows as Python tuples (test/client
        boundary); the pulls are metered d2h crossings (exec/xfer.py).
        A host page (numpy leaves) decodes with no crossing."""
        from presto_tpu_torch.exec import xfer as XF

        valid = XF.np_host(self.valid, label="decode-valid")
        rows_idx = np.nonzero(valid)[0]
        cols = [_decode_block(blk, rows_idx) for blk in self.blocks]
        return [tuple(col[i] for col in cols) for i in range(len(rows_idx))]


def _encode_column(col, typ: T.SqlType, cap: int,
                   dictionary: Optional[Dictionary], device) -> Block:
    vals = list(col) if not isinstance(col, np.ndarray) else col.tolist()
    n = len(vals)
    if n > cap:
        raise ValueError(f"column length {n} exceeds capacity {cap}")
    null_mask = np.array([v is None for v in vals] + [True] * (cap - n))
    has_nulls = bool(null_mask[:n].any())
    # metered h2d boundary: every encoded column stages host values
    # onto the device (exec/xfer.py)
    from presto_tpu_torch.exec import xfer as XF

    def stage(a):
        return XF.to_device(a, device, label="page-build")

    nulls = stage(null_mask) if has_nulls else None

    if typ.is_dictionary_encoded:
        if dictionary is None:
            dictionary = Dictionary(sorted({v for v in vals if v is not None}))
        codes = np.zeros(cap, dtype=np.int32)
        for i, v in enumerate(vals):
            if v is None:
                continue
            code = dictionary.code_of(v)
            if code < 0:
                raise ValueError(f"value {v!r} not in supplied dictionary")
            codes[i] = code
        return Block(data=stage(codes), type=typ, nulls=nulls,
                     dictionary=dictionary)

    if isinstance(typ, T.DecimalType) and not typ.is_short:
        hi = np.zeros(cap, dtype=np.int64)
        lo = np.zeros(cap, dtype=np.int64)
        for i, v in enumerate(vals):
            if v is None:
                continue
            u = int(v) & ((1 << 64) - 1)
            lo[i] = u - (1 << 64) if u >> 63 else u
            hi[i] = int(v) >> 64
        return Block(data=(stage(hi), stage(lo)), type=typ, nulls=nulls)

    arr = np.zeros(cap, dtype=typ.numpy_dtype)
    for i, v in enumerate(vals):
        if v is not None:
            arr[i] = v
    return Block(data=stage(arr), type=typ, nulls=nulls)


def _host(t) -> np.ndarray:
    """One block array as host numpy: the metered d2h pull of result
    decode (a numpy array passes through, no crossing)."""
    from presto_tpu_torch.exec import xfer as XF

    return XF.np_host(t)


def _collect_elem_decoder(elem_t, dictionary):
    """int64 collect-state slot -> Python element value (the inverse of
    exec/executor._collect_encode)."""
    if dictionary is not None:
        values = dictionary.values
        return lambda v: values[int(np.clip(v, 0, len(values) - 1))]
    if isinstance(elem_t, (T.DoubleType, T.RealType)):
        def dec_float(v):
            v = int(v)
            if v == 0:
                return 0.0
            mag = abs(v)
            out = math.ldexp(0.5 + (mag & ((1 << 52) - 1)) * 2.0 ** -53,
                             (mag >> 52) - 1100 + 1)
            return -out if v < 0 else out
        return dec_float
    if isinstance(elem_t, T.BooleanType):
        return lambda v: bool(v)
    return lambda v: int(v)


def _decode_collect(blk: Block, rows_idx: np.ndarray) -> list:
    """A collect result: (vals2d, elem-null-flags2d, counts) for
    array_agg, (k2d, v2d, value-null-flags2d, counts) for map_agg."""
    *mats, counts = blk.data
    mats = [_host(m)[rows_idx] for m in mats]
    counts = _host(counts)[rows_idx]
    if isinstance(blk.type, T.ArrayType):
        dec = _collect_elem_decoder(blk.type.element, blk.dictionary)
        return [tuple(None if nf else dec(v)
                      for v, nf in zip(mats[0][i, :int(c)],
                                       mats[1][i, :int(c)]))
                for i, c in enumerate(counts)]
    kdec = _collect_elem_decoder(blk.type.key, blk.dictionary)
    vdec = _collect_elem_decoder(blk.type.value, None)
    return [tuple((kdec(k), None if nf else vdec(v))
                  for k, v, nf in zip(mats[0][i, :int(c)],
                                      mats[1][i, :int(c)],
                                      mats[2][i, :int(c)]))
            for i, c in enumerate(counts)]


def _decode_block(blk: Block, rows_idx: np.ndarray) -> list:
    """Selected rows of one block as Python values (presto_tpu's
    page._decode_block: collect results, long-decimal limbs, dictionary
    codes, booleans, integers, floats)."""
    nulls = _host(blk.nulls) if blk.nulls is not None else None
    if (isinstance(blk.type, (T.ArrayType, T.MapType))
            and isinstance(blk.data, tuple)):
        vals = _decode_collect(blk, rows_idx)
    elif isinstance(blk.data, tuple):
        hi = _host(blk.data[0])[rows_idx].astype(object)
        lo = _host(blk.data[1])[rows_idx].astype(object)
        vals = [(int(h) << 64) | (int(l) & ((1 << 64) - 1))
                for h, l in zip(hi, lo)]
    elif blk.dictionary is not None:
        vals = list(blk.dictionary.decode(_host(blk.data)[rows_idx]))
    else:
        arr = _host(blk.data)[rows_idx]
        if arr.dtype == np.bool_:
            vals = [bool(v) for v in arr]
        elif np.issubdtype(arr.dtype, np.integer):
            vals = [int(v) for v in arr]
        else:
            vals = [float(v) for v in arr]
    if nulls is not None:
        sel = nulls[rows_idx]
        vals = [None if is_null else v for v, is_null in zip(vals, sel)]
    return vals
