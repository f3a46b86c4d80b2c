"""Key encodings: map typed Blocks to u64 keys for equality (join /
group-by) and total order (sort / merge).

Port of presto_tpu/ops/keys.py. Every u64 key is an int64 bit-view
(ops/u64.py); an unsigned comparison or sort goes through
``u64.order``, which flips the sign bit.

Equality encoding: values are equal iff encodings are equal (plus null
flags). Order encoding: encoding order == SQL ascending order for
non-null values:
  - signed ints: flip sign bit (x ^ 0x8000...),
  - floats: IEEE-754 total order (flip all bits if negative, else set
    the sign bit); -0.0 normalized to +0.0 first; NaN sorts above +inf,
  - dictionary codes: order via Dictionary.sort_rank, equality via codes,
  - booleans: 0/1.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.ops import consts, u64
from presto_tpu_torch.page import Block


def _int_order_u64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) ^ u64.SIGN


def _float_order_u64(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 total-order u64 key for DOUBLE/REAL values (the
    reference's true-f64 branch: a bitcast, not the TPU's (hi, lo) f32
    pair). -0.0 normalized to +0.0; NaN sorts above +inf."""
    x64 = x.to(torch.float64)
    x64 = torch.where(x64 == 0.0, 0.0, x64)  # -0.0 -> +0.0
    bits = x64.view(torch.int64)
    out = torch.where(bits < 0, ~bits, bits | u64.SIGN)
    return torch.where(torch.isnan(x64), u64.POISON, out)


def equality_encoding(block: Block) -> List[torch.Tensor]:
    """u64 tensor(s) such that rows are SQL-equal iff encodings equal.

    Floats use the order encoding (NaN groups with NaN, as in the
    reference). Dictionary columns with duplicate values canonicalize
    codes by value through a host lut."""
    t = block.type
    if isinstance(block.data, tuple):  # long decimal limbs
        hi, lo = block.data
        return [hi.to(torch.int64), lo.to(torch.int64)]
    if isinstance(t, (T.DoubleType, T.RealType)):
        return [_float_order_u64(block.data)]
    if isinstance(t, T.BooleanType):
        return [block.data.to(torch.int64)]
    if (
        block.dictionary is not None
        and len(block.dictionary)
        and block.dictionary.has_duplicate_values()
    ):
        values = block.dictionary.values
        first: dict = {}
        lut = np.empty(len(values), dtype=np.int64)
        for i, v in enumerate(values):
            lut[i] = first.setdefault(v, i)
        codes = block.data.clamp(0, len(values) - 1).to(torch.int64)
        return [consts.lut(lut, block.data.device)[codes]]
    return [block.data.to(torch.int64)]


def order_encoding_parts(
    block: Block,
    *,
    ascending: bool = True,
    nulls_first: bool = False,
) -> List[Tuple[torch.Tensor, int]]:
    """(u64 key, bits) pairs whose MSB-first concatenation orders rows
    correctly; narrow static widths let pack_sort_keys fuse several keys
    into one u64 word."""
    t = block.type
    dev = block.device
    if isinstance(block.data, tuple):  # long decimal limbs
        hi, lo = block.data
        parts = [(_int_order_u64(hi), 64), (lo.to(torch.int64), 64)]
    elif isinstance(t, (T.DoubleType, T.RealType)):
        parts = [(_float_order_u64(block.data), 64)]
    elif isinstance(t, T.BooleanType):
        parts = [(block.data.to(torch.int64), 1)]
    elif t.is_dictionary_encoded and block.dictionary is not None:
        if len(block.dictionary) == 0:
            parts = [(torch.zeros(block.data.shape, dtype=torch.int64,
                                  device=dev), 1)]
        else:
            rank = consts.lut(
                block.dictionary.sort_rank().astype(np.int64), dev)
            codes = block.data.clamp(0, len(block.dictionary) - 1)
            bits = max(1, (len(block.dictionary) - 1).bit_length())
            parts = [(rank[codes.to(torch.int64)], bits)]
    else:
        bits = 64
        if isinstance(t, T.DateType):
            bits = 24  # Presto DATE range (years 1582..9999) < 2^23 days
        elif isinstance(t, T.IntegerType):
            bits = 32
        elif isinstance(t, T.SmallintType):
            bits = 16
        elif isinstance(t, T.TinyintType):
            bits = 8
        x = block.data.to(torch.int64)
        if bits == 64:
            enc = x ^ u64.SIGN
        else:
            lo_b, hi_b = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
            enc = x.clamp(lo_b, hi_b) + (1 << (bits - 1))
        parts = [(enc, bits)]

    if not ascending:
        parts = [
            ((~k if b == 64 else ((1 << b) - 1) - k), b) for k, b in parts
        ]

    null = block.nulls
    shape = parts[0][0].shape
    if null is None:
        null_key = torch.zeros(shape, dtype=torch.int64, device=dev)
    elif nulls_first:
        null_key = (~null).to(torch.int64)
    else:
        null_key = null.to(torch.int64)
    return [(null_key, 1)] + parts


def pack_sort_keys(
    parts: List[Tuple[torch.Tensor, int]]
) -> List[torch.Tensor]:
    """Greedily pack (key, bits) pairs MSB-first into u64 words.
    Lexicographic UNSIGNED order of the packed words equals the order
    of the unpacked key sequence."""
    words: List[torch.Tensor] = []
    acc = None
    used = 0
    for key, bits in parts:
        if acc is not None and used + bits > 64:
            words.append(acc)
            acc, used = None, 0
        if acc is None:
            acc = key.to(torch.int64)
            used = bits
        else:
            acc = (acc << bits) | key.to(torch.int64)
            used += bits
    if acc is not None:
        words.append(acc)
    return words


def block_key_columns(
    blocks,
) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
    """Equality encodings + null masks for a list of key Blocks
    (a long-decimal key contributes two columns sharing one null)."""
    cols: List[torch.Tensor] = []
    nulls: List[Optional[torch.Tensor]] = []
    for b in blocks:
        enc = equality_encoding(b)
        cols.extend(enc)
        nulls.extend([b.nulls] * len(enc))
    return cols, nulls
