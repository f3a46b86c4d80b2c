"""K2 + K3: the hash-join range index, its probe kernel and the plain twin.

Port of presto_tpu/ops/pallas_join.py. The join contract is shared with
the sort join (ops/join.py): an index over the HASH-SORTED build side
where equal-hash rows form contiguous segments, and a probe returning,
per probe row, the segment (start, count) of equal-hash valid build rows
or (-1, 0). ops/join.expand_matches flattens ranges into verified
matches identically for every range finder.

Two layouts, picked by plan_layout(build_capacity) exactly as in the
reference: "dim" (T tiles of 128 slots, builds <= 2048 rows — the K2
counterpart) and "radix" (buckets of 2^14 slots addressed by the top
hash bits, builds <= 2^20 rows — the K3 counterpart). The table build
(_sorted_segments, _insert, build_index) stays torch code and yields the
same tables, ``perm`` and overflow flag as the reference, flat for both
layouts (the TPU's 8x sublane replication of dim tables has no use
here).

The probe reads the tables as ``pack_tables`` splits them once per build:
a 64-bit key per slot (the slot's hash, EMPTY_KEY where empty) and a
(start, count) payload read only on a hit. It is csrc/hash_probe.cu on a
CUDA tensor (or raises) and a vectorized lock-step loop of gathers on a
CPU tensor. Launches count per layout, so a run shows that each TPU
kernel's counterpart ran.

u64 handling: hashes are int64 bit-views (ops/u64.py); the built tables
are int32 (lo, hi, start, count) as in the reference; fmix32 runs in
int64 masked to 32 bits, torch lacking uint32 shifts.
"""

from __future__ import annotations

from typing import Optional

import torch

from presto_tpu_torch import cuda
from presto_tpu_torch.ops import u64

# dim layout: T (pow2) tiles x 128 slots; chains wrap within a tile.
# 2x-entries load factor => builds up to DIM_TILES_MAX * 128 / 2 rows.
DIM_TILES_MAX = 32
DIM_MAX_BUILD = DIM_TILES_MAX * 128 // 2  # 2048 rows
DIM_WIDTH = 128

# radix layout: buckets of 2^14 slots
BUCKET_CAP = 1 << 14
RADIX_MAX_BUILD = 1 << 20

_MAX_ITERS = 64
MAX_PROBES = _MAX_ITERS + 1

# rounds between host checks for convergence in the lock-step loops; a
# round after convergence changes nothing, so results match checking
# every round
_CHECK_EVERY = 8

KERNELS = {"dim": "probe_dim", "radix": "probe_radix"}

# the key of an empty slot in the probe's key array: the poison hash,
# which build_index never stores
EMPTY_KEY = u64.POISON


def _split64(keys: torch.Tensor):
    """(lo, hi) int32 words of the u64 bit pattern."""
    return u64.lo32(keys), u64.hi32(keys)


def _mix32(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over both words, as a uint32 value in int64."""
    m = u64.MASK32
    h = u64.u32(lo) ^ ((u64.u32(hi) * 0x85EBCA6B) & m)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & m
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & m
    return h ^ (h >> 16)


def plan_layout(build_cap: int):
    """Static layout for a build of ``build_cap`` rows: ("dim", tiles)
    or ("radix", (num_buckets, bucket_cap))."""
    if build_cap <= DIM_MAX_BUILD:
        total = max(128, 1 << (2 * build_cap - 1).bit_length())
        return ("dim", total // 128)
    total = max(BUCKET_CAP, 1 << (2 * build_cap - 1).bit_length())
    return ("radix", (total // BUCKET_CAP, BUCKET_CAP))


def _log2b(num_buckets: int) -> int:
    return (num_buckets - 1).bit_length() if num_buckets > 1 else 0


def _span(h32: torch.Tensor, layout):
    """(base slot, width) of each hash's probe span."""
    kind, spec = layout
    if kind == "dim":
        tile = (h32 >> 7) & (spec - 1) if spec > 1 else torch.zeros_like(h32)
        return tile * DIM_WIDTH, DIM_WIDTH
    log2b = _log2b(spec[0])
    bucket = h32 >> (32 - log2b) if log2b else torch.zeros_like(h32)
    return bucket * spec[1], spec[1]


def _table_slots(layout) -> int:
    kind, spec = layout
    return spec * DIM_WIDTH if kind == "dim" else spec[0] * spec[1]


# ----------------------------------------------------------- index build


def _sorted_segments(bhash: torch.Tensor, bvalid: torch.Tensor):
    """Hash-sort the build side (stable, unsigned order); equal-hash runs
    become segments. Per sorted row: the segment's first VALID position
    and valid count. Invalid rows poison to the max hash and sort last."""
    n = bhash.shape[0]
    dev = bhash.device
    poisoned = torch.where(bvalid, bhash, u64.POISON)
    perm = torch.argsort(u64.order(poisoned), stable=True)
    sorted_h = poisoned[perm]
    valid_s = bvalid[perm]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    seg_start = torch.ones(n, dtype=torch.bool, device=dev)
    seg_start[1:] = sorted_h[1:] != sorted_h[:-1]
    seg_id = torch.cumsum(seg_start.to(torch.int64), 0) - 1
    vcnt = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, seg_id, valid_s.to(torch.int64))[seg_id]
    vstart = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    vstart.scatter_reduce_(0, torch.where(valid_s, seg_id, n), idx, "amin",
                           include_self=True)
    vstart = vstart[:n][seg_id]
    # one entry per segment with >= 1 valid row, at its first valid row
    entry = valid_s & (idx == vstart) & (vcnt > 0)
    return perm, sorted_h, entry, vstart, vcnt


def _insert(sorted_h, entry, vstart, vcnt, base, width, table_cap,
            max_iters: int = _MAX_ITERS):
    """Vectorized open-addressing insert of segment entries by
    scatter-min, lock-step linear probing within each entry's
    [base, base + width) span. Returns flat (lo, hi, start, count) int32
    tables and an overflow flag (entries unsettled after max_iters)."""
    n = sorted_h.shape[0]
    dev = sorted_h.device
    lo, hi = _split64(sorted_h)
    h32 = _mix32(lo, hi)
    slot = base + (h32 & (width - 1))
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    def settled(owner, slot):
        return entry & (owner[slot] == idx)

    owner = torch.full((table_cap,), n, dtype=torch.int64, device=dev)
    for it in range(max_iters):
        if it % _CHECK_EVERY == 0 and not bool(
                (entry & ~settled(owner, slot)).any()):
            break
        done = settled(owner, slot)
        claim = torch.where(done | ~entry, n, idx)
        owner.scatter_reduce_(0, slot, claim, "amin", include_self=True)
        done2 = settled(owner, slot)
        nxt = base + ((slot - base + 1) & (width - 1))
        slot = torch.where(done2 | ~entry, slot, nxt)
    ok = settled(owner, slot)
    overflow = (entry & ~ok).any()
    tgt = torch.where(ok, slot, table_cap)

    def table(values):
        t = torch.zeros(table_cap + 1, dtype=torch.int32, device=dev)
        t[tgt] = values.to(torch.int32)
        return t[:table_cap]

    return (table(lo), table(hi), table(vstart), table(vcnt)), overflow


def build_index(bhash: torch.Tensor, bvalid: torch.Tensor, layout):
    """Build the (start, count) range index for ``layout``.

    Returns (tables, perm, overflow): ``perm`` is the hash-sorted build
    order the ranges refer to; ``tables`` is four flat int32 tensors
    (lo, hi, start, count) of _table_slots(layout) entries.

    A VALID row whose hash equals the poison value would interleave with
    poisoned invalid rows inside the max-hash segment and lose matches —
    such rows are excluded and raise overflow, so the query retries on
    the exact sort join (identity-encoded BIGINT -1 hits this)."""
    poison_conflict = (bvalid & (bhash == u64.POISON)).any()
    bvalid = bvalid & (bhash != u64.POISON)
    perm, sorted_h, entry, vstart, vcnt = _sorted_segments(bhash, bvalid)
    h32 = _mix32(*_split64(sorted_h))
    base, width = _span(h32, layout)
    tables, overflow = _insert(sorted_h, entry, vstart, vcnt, base, width,
                               _table_slots(layout))
    return tables, perm, overflow | poison_conflict


def pack_tables(tables):
    """The four flat tables as the probe reads them: (keys, payload).
    ``keys`` is int64 [slots], each slot's 64-bit hash (the (lo, hi)
    words) or EMPTY_KEY where the slot is empty; ``payload`` is int32
    [slots, 2], the slot's (start, count). A probe step reads a key and,
    on a hit only, the payload. EMPTY_KEY is the poison hash, which
    build_index never stores."""
    lo, hi, start, count = tables
    keys = (hi.to(torch.int64) << 32) | u64.u32(lo)
    keys = torch.where(count > 0, keys, EMPTY_KEY)
    return keys, torch.stack((start, count), dim=1).contiguous()


# ------------------------------------------------------------ probe


def probe_plain(probe_hash: torch.Tensor, packed, layout,
                max_probes: int = MAX_PROBES,
                visited: Optional[dict] = None):
    """The plain version: a vectorized lock-step probe loop of gathers.
    A ``visited`` dict receives, per step, the key slots the live probes
    read (under "keys") and the payload slots their hits read (under
    "payload"), for counting the table traffic of a run."""
    keys, payload = packed
    n = probe_hash.shape[0]
    dev = probe_hash.device
    h32 = _mix32(*_split64(probe_hash))
    base, width = _span(h32, layout)
    slot = h32 & (width - 1)
    start = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    for i in range(max_probes):
        if i % _CHECK_EVERY == 0 and not bool(live.any()):
            break
        idx = base + slot
        k = keys[idx]
        empty = k == EMPTY_KEY
        hit = live & ~empty & (k == probe_hash)
        e = payload[torch.where(hit, idx, 0)]
        if visited is not None:
            visited.setdefault("keys", []).append(idx[live])
            visited.setdefault("payload", []).append(idx[hit])
        start = torch.where(hit, e[:, 0], start)
        cnt = torch.where(hit, e[:, 1], cnt)
        live = live & ~(hit | empty)
        slot = torch.where(live, (slot + 1) & (width - 1), slot)
    return start, cnt


def probe_cuda(probe_hash: torch.Tensor, packed, layout,
               max_probes: int = MAX_PROBES):
    """The kernel: same function as probe_plain, on the card."""
    keys, payload = packed
    dev = probe_hash.device
    cuda.check_tensor(probe_hash, "probe_hash", torch.int64, dev)
    cuda.check_tensor(keys, "keys", torch.int64, dev)
    cuda.check_tensor(payload, "payload", torch.int32, dev, ndim=2)
    kind, spec = layout
    slots = _table_slots(layout)
    if keys.shape != (slots,) or payload.shape != (slots, 2):
        raise ValueError(f"table shapes {tuple(keys.shape)}, "
                         f"{tuple(payload.shape)} do not fit layout "
                         f"{layout}")
    param = spec if kind == "dim" else _log2b(spec[0])
    n = probe_hash.shape[0]
    start = torch.empty(n, dtype=torch.int32, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    cuda.call("hash_probe", "presto_hash_probe", dev, probe_hash.data_ptr(),
              n, keys.data_ptr(), payload.data_ptr(), int(kind == "dim"),
              param, max_probes, start.data_ptr(), cnt.data_ptr())
    cuda.count(cuda.launches, KERNELS[kind])
    return start, cnt


def probe_index(probe_hash: torch.Tensor, packed, layout):
    """Per probe row, the hash-sorted build segment (start, count) of
    equal-hash valid build rows ((-1, 0) when none)."""
    if probe_hash.is_cuda:
        return probe_cuda(probe_hash.contiguous(), packed, layout)
    cuda.count(cuda.plain_calls, KERNELS[layout[0]])
    return probe_plain(probe_hash, packed, layout)


# ------------------------------------------------------- unique wrapper


def join_unique(build_keys: torch.Tensor, build_valid: torch.Tensor,
                probe_keys: torch.Tensor, probe_valid: torch.Tensor):
    """Unique-build-key inner-join mapping: per probe row the matching
    VALID build row id, or -1. Uses the IDENTITY u64 encoding as the
    hash, so (lo, hi) equality IS key equality.

    Returns (row_ids int32, overflow)."""
    layout = plan_layout(int(build_keys.shape[0]))
    tables, perm, overflow = build_index(build_keys.to(torch.int64),
                                         build_valid, layout)
    start, cnt = probe_index(probe_keys.to(torch.int64),
                             pack_tables(tables), layout)
    hit = probe_valid & (cnt > 0)
    rid = torch.where(hit, perm[start.clamp(min=0).to(torch.int64)]
                      .to(torch.int32), -1)
    return rid, overflow
