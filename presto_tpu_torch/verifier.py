"""Result checksum utilities.

Port of presto_tpu/verifier.py: the checksums are the reference's bit
for bit (host Python over decoded rows). Reference: presto-verifier —
replays query suites against two clusters and compares row counts +
ORDER-INSENSITIVE checksums (aggregate over per-row hashes) rather than
sorted row lists. Ours is the same idea for
single-vs-distributed and engine-vs-oracle comparisons:

    checksum = sum(row_hash(row)) mod 2^64
    row_hash = 31*h + column_hash chain (CombineHashFunction), with
    xxhash64 per column value — bit-compatible with
    ops/hashing.xxhash64_u64 over u64 words.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

_MASK = (1 << 64) - 1

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK


def xxhash64_long(value: int, seed: int = 0) -> int:
    """xxhash64 of one 8-byte little-endian value; bit-exact with
    io.airlift.slice.XxHash64.hash(long)."""
    v = value & _MASK
    acc = (seed + _P5 + 8) & _MASK
    k1 = (v * _P2) & _MASK
    k1 = _rotl(k1, 31)
    k1 = (k1 * _P1) & _MASK
    acc ^= k1
    acc = (_rotl(acc, 27) * _P1 + _P4) & _MASK
    acc ^= acc >> 33
    acc = (acc * _P2) & _MASK
    acc ^= acc >> 29
    acc = (acc * _P3) & _MASK
    acc ^= acc >> 32
    return acc


def _value_hash(v) -> int:
    """Per-type canonical hash. NULL -> 0 (reference:
    TypeUtils.hashPosition's NULL_HASH_CODE)."""
    if v is None:
        return 0
    if isinstance(v, bool):
        return xxhash64_long(1 if v else 0)
    if isinstance(v, int):
        return xxhash64_long(v)
    if isinstance(v, float):
        # canonicalize to the double's bit pattern (NaNs normalized)
        import math
        import struct

        if math.isnan(v):
            bits = 0x7FF8000000000000
        else:
            bits = struct.unpack("<q", struct.pack("<d", v))[0]
        return xxhash64_long(bits)
    if isinstance(v, str):
        # chain of char-code hashes (strings are dictionary-coded on
        # device; host side hashes the decoded value canonically)
        h = 0
        for b in v.encode("utf-8"):
            h = (h * 31 + b) & _MASK
        return xxhash64_long(h)
    raise TypeError(f"unhashable result value: {v!r} ({type(v)})")


def row_hash(row: Iterable) -> int:
    """Reference: CombineHashFunction.getHash: h = 31*h + col_hash."""
    h = 0
    for v in row:
        h = (h * 31 + _value_hash(v)) & _MASK
    return h


def checksum_rows(rows: List[tuple]) -> dict:
    """Order-insensitive result digest (verifier-style)."""
    total = 0
    for r in rows:
        total = (total + row_hash(r)) & _MASK
    return {"count": len(rows), "checksum": total}


def assert_same_results(
    a: List[tuple], b: List[tuple], label: str = ""
) -> None:
    ca, cb = checksum_rows(a), checksum_rows(b)
    assert ca["count"] == cb["count"], (
        f"{label}: row count {ca['count']} != {cb['count']}"
    )
    assert ca["checksum"] == cb["checksum"], (
        f"{label}: checksums differ over {ca['count']} rows "
        f"({ca['checksum']:#x} vs {cb['checksum']:#x})\n"
        f"a head: {a[:3]}\nb head: {b[:3]}"
    )
