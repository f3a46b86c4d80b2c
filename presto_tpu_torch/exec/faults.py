"""THE device-fault classifier: one marker list, one predicate.

Port of presto_tpu/exec/faults.py (reference: presto-main's
StandardErrorCode taxonomy — every layer that reacts to an error class
consults the same classification). The class is "device memory /
allocation fault": the signal that admits an execution into the
OOM-degradation ladder (Executor.stream_fragment re-enters under a
halved device-memory budget).

One change from the reference: the card's own allocator failure,
``torch.cuda.OutOfMemoryError``, subclasses RuntimeError, so the
reference's exact-type gate would reject it. It is accepted explicitly.
A kernel wrapper's launch failure (``RuntimeError("CUDA kernel ...
cudaError N")``, presto_tpu_torch/cuda.py) carries no memory marker and
stays unmatched: the port's kernels allocate nothing, so their launch
errors are bugs to surface, not footprints to shrink.
"""

from __future__ import annotations

import torch

# Substrings that mark a device memory/allocation failure in runtime
# error text (the reference's list: RESOURCE_EXHAUSTED is the injected
# hook's and XLA's status; the allocator variants match torch's too)
DEVICE_FAULT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
    "Failed to allocate",
)


def text_matches(msg: str) -> bool:
    """Whether error TEXT carries a device-memory marker."""
    return any(m in msg for m in DEVICE_FAULT_MARKERS)


def is_device_fault(e: BaseException) -> bool:
    """Whether an exception is a device memory/allocation fault the
    OOM-degradation ladder may absorb. ``torch.cuda.OutOfMemoryError``
    always is. Otherwise only EXACTLY RuntimeError (the fault hook's
    type) with a memory marker: engine control-flow exceptions
    (MemoryBudgetExceeded, QueryDeadlineExceeded, ...) subclass
    RuntimeError and are rejected by the exact-type check even when
    they quote device-fault text."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    if type(e) is not RuntimeError:
        return False
    return text_matches(str(e))
