"""Forced device synchronization for honest timing.

Port of presto_tpu/devsync.py. Every timing path of the port that wants
device time rather than enqueue time (EXPLAIN ANALYZE's ``stats_drain``
mode) calls THIS helper, so a change of the protocol lands in one
place.

The reference reads one element of the last output because its TPU
runtime's ``block_until_ready`` returns at dispatch. On CUDA the honest
counterpart is ``torch.cuda.synchronize(device)``: it returns when every
kernel queued on the device has finished, which is what the reference's
one-element read proves through FIFO order. It moves no data, so it is
not a metered crossing.
"""

from __future__ import annotations

import torch


def drain(device) -> None:
    """Wait until all work queued on ``device`` has finished: a
    ``torch.cuda.synchronize``. A no-op on the CPU, where every op has
    finished when it returns."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
