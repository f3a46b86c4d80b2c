"""HyperLogLog approx_distinct as segmented reductions.

Port of presto_tpu/ops/hll.py (reference: presto-main
operator/aggregation/ApproximateCountDistinctAggregation.java):

- registers: M_REGS = 256 byte-wide registers per group (standard error
  1.04/sqrt(256) ~= 6.5%);
- insert: one xxhash64 per row; the low 8 bits pick the register, the
  rank = 1 + count-leading-zeros of the remaining 56 bits. One
  ``scatter_reduce_(..., "amax")`` over composite segment ids (group *
  M_REGS + register) on a zeroed int64 buffer computes every (group,
  register) max (the reference's ``jax.ops.segment_max``, whose
  INT_MIN identity it clamps to 0);
- state: the [cap, M_REGS] byte matrix packs into WORDS = 32 int64
  columns carried as ONE tuple-data Block, so HLL state pages flow
  through compaction, gathers, concatenation, the page stores and the
  exchange serde like a long-decimal limb block;
- merge: unpack to bytes, register-wise max per group, repack;
- estimate: alpha_m * m^2 / sum(2^-reg) with the small-range
  linear-counting correction (Flajolet et al. 2007).

Hashes are u64 bit-views (ops/u64.py): the register rank takes a
LOGICAL shift of the hash, since an arithmetic shift would smear the
sign bit into the top of the rank's 56 bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from presto_tpu_torch.ops import u64

M_REGS = 256  # registers per group (SE ~= 1.04/sqrt(256) ~= 6.5%)
WORDS = M_REGS // 8  # int64 words per group (8-bit registers)
# alpha_256 per the HLL paper (m >= 128: 0.7213 / (1 + 1.079/m))
_ALPHA = 0.7213 / (1.0 + 1.079 / M_REGS)


def _reg_rank(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(register index, rank) per row from a u64 hash: the low log2(m)
    bits pick the register; rank = 1 + leading zeros of the top 56 bits
    (max rank 57 fits in a byte)."""
    reg = h & (M_REGS - 1)
    rest = u64.srl(h, 8)  # 56 significant bits, non-negative
    # exact integer highest-set-bit via bisection
    x = rest
    pos = torch.zeros_like(h)
    for s in (32, 16, 8, 4, 2, 1):
        y = x >> s
        take = y != 0
        pos = pos + torch.where(take, s, 0)
        x = torch.where(take, y, x)
    # rest > 0: highest set bit at pos -> rank = 56 - pos; rest == 0 ->
    # rank 57
    rank = torch.where(rest == 0, 57, 56 - pos)
    return reg, rank


def _pack(bytes2d: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """[cap, M_REGS] int64 byte values -> WORDS int64 tensors of [cap]
    (byte k of word w is register 8w + k; ranks <= 57 keep the top
    byte's sign bit clear)."""
    shifts = torch.arange(0, 64, 8, dtype=torch.int64,
                          device=bytes2d.device)
    words = (bytes2d.reshape(-1, WORDS, 8) << shifts).sum(dim=2)
    return tuple(words.unbind(dim=1))


def _unpack(words: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """WORDS int64 tensors of [cap] -> [cap, M_REGS] int64 byte values."""
    w = torch.stack(words, dim=1)  # [cap, WORDS]
    shifts = torch.arange(0, 64, 8, dtype=torch.int64, device=w.device)
    return ((w.unsqueeze(2) >> shifts) & 0xFF).reshape(w.shape[0], M_REGS)


def _segment_max(vals: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=torch.int64, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, "amax", include_self=True)


def insert(
    group_ids: torch.Tensor,
    contributing: torch.Tensor,
    out_capacity: int,
    hashes: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Per-group HLL registers from raw input hashes (the PARTIAL input
    step). Returns WORDS packed int64 tensors of [out_capacity]."""
    reg, rank = _reg_rank(hashes)
    sink = out_capacity * M_REGS
    seg = torch.where(contributing, group_ids.to(torch.int64) * M_REGS
                      + reg, sink)
    flat = _segment_max(torch.where(contributing, rank, 0), seg,
                        sink + 1)[:sink]
    return _pack(flat.reshape(out_capacity, M_REGS))


def merge(
    group_ids: torch.Tensor,
    contributing: torch.Tensor,
    out_capacity: int,
    words: Tuple[torch.Tensor, ...],
) -> Tuple[torch.Tensor, ...]:
    """Merge partial HLL states by group (register-wise max)."""
    bytes2d = _unpack(words)  # [n, M_REGS]
    regs = torch.arange(M_REGS, dtype=torch.int64,
                        device=bytes2d.device)[None, :]
    sink = out_capacity * M_REGS
    live = contributing[:, None]
    seg = torch.where(live, group_ids.to(torch.int64)[:, None] * M_REGS
                      + regs, sink)
    flat = _segment_max(torch.where(live, bytes2d, 0).reshape(-1),
                        seg.reshape(-1), sink + 1)[:sink]
    return _pack(flat.reshape(out_capacity, M_REGS))


def estimate(words: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """HLL cardinality estimate per group: [cap] int64."""
    bytes2d = _unpack(words).to(torch.float64)  # [cap, M_REGS]
    inv_sum = torch.exp2(-bytes2d).sum(dim=1)
    raw = _ALPHA * M_REGS * M_REGS / inv_sum
    zeros = (bytes2d == 0).to(torch.float64).sum(dim=1)
    # small-range correction: linear counting while any register is
    # empty and the raw estimate is below 2.5m
    lc = M_REGS * torch.log(M_REGS / zeros.clamp(min=1.0))
    use_lc = (raw <= 2.5 * M_REGS) & (zeros > 0)
    est = torch.round(torch.where(use_lc, lc, raw))
    # saturate past int64 as the reference's conversion does (a cast
    # would wrap)
    return torch.where(est >= 2.0 ** 63, torch.iinfo(torch.int64).max,
                       est.to(torch.int64))


def global_insert(valid: torch.Tensor,
                  hashes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Ungrouped insert: one group's registers as WORDS tensors of [1]."""
    return insert(torch.zeros_like(hashes), valid, 1, hashes)


def global_merge(valid: torch.Tensor,
                 words: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    return merge(torch.zeros(valid.shape, dtype=torch.int64,
                             device=valid.device), valid, 1, words)
