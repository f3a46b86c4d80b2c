"""K4: exchange partition ids, the kernel and its plain twin.

Port of presto_tpu/dist/spool.py::_pallas_part_ids. Input is the stacked
u64 value encodings of the partition key columns as an int64 [C, N]
bit-view tensor (NULL keys already on the sentinel encoding); output is
one int32 partition id per row:

    acc = fold over c of  acc * 31 + fmix32(lo_c, hi_c)    (uint32)
    part = fmix32(acc, 0) % nparts

NOT hash-compatible with the splitmix64 tier of dist/spool.py: routing
needs only self-consistency across the producers of one exchange, and
the session-distributed ``pallas_join_enabled`` decides the tier for
all of them alike.

The kernel is csrc/part_ids.cu on a CUDA tensor (or raises); the plain
twin runs the same uint32 arithmetic in int64 masked to 32 bits (torch
lacks uint32 shifts) on a CPU tensor.
"""

from __future__ import annotations

import torch

from presto_tpu_torch import cuda
from presto_tpu_torch.ops import u64
from presto_tpu_torch.ops.cuda_join import _mix32

KERNEL = "part_ids"


def part_ids_plain(enc: torch.Tensor, nparts: int) -> torch.Tensor:
    """The plain version over int64 [C, N] encodings -> int32 [N]."""
    acc = torch.zeros(enc.shape[1], dtype=torch.int64, device=enc.device)
    for c in range(enc.shape[0]):
        h = _mix32(u64.lo32(enc[c]), u64.hi32(enc[c]))
        acc = (acc * 31 + h) & u64.MASK32
    acc = _mix32(acc, torch.zeros_like(acc))
    return (acc % nparts).to(torch.int32)


def part_ids_cuda(enc: torch.Tensor, nparts: int) -> torch.Tensor:
    """The kernel: same function as part_ids_plain, on the card."""
    dev = enc.device
    cuda.check_tensor(enc, "enc", torch.int64, dev, ndim=2)
    if not 1 <= nparts < (1 << 31):
        raise ValueError(f"nparts must be in [1, 2^31), got {nparts}")
    cols, n = enc.shape
    out = torch.empty(n, dtype=torch.int32, device=dev)
    cuda.call("part_ids", "presto_part_ids", dev, enc.data_ptr(), cols, n,
              nparts, out.data_ptr())
    cuda.count(cuda.launches, KERNEL)
    return out


def part_ids(enc: torch.Tensor, nparts: int) -> torch.Tensor:
    """Per row, the exchange partition id in [0, nparts)."""
    if enc.is_cuda:
        return part_ids_cuda(enc.contiguous(), nparts)
    cuda.count(cuda.plain_calls, KERNEL)
    return part_ids_plain(enc, nparts)
