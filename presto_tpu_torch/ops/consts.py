"""Host-built constant tensors (dictionary remap tables, rank tables),
staged to the device once per content and kept.

A stream that captures a CUDA graph may not copy from pageable host
memory, and every tensor a captured graph reads must outlive the graph.
So a constant built on the host goes through ``lut``: the first call
(an eager run, or the warm-up run before a capture) copies it to the
card, and every later call with the same content — a capture or any
later page — gets that same tensor back. On the CPU it is a view of the
array, as ``torch.from_numpy`` gives.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.obs.sanitizer import make_lock

_cache: Dict[tuple, torch.Tensor] = {}
_lock = make_lock("ops.consts._lock")


def lut(values, device, dtype=None) -> torch.Tensor:
    """``values`` (array-like) as a tensor on ``device``; on a CUDA
    device the same tensor for the same content, for the life of the
    process."""
    arr = np.ascontiguousarray(values, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return torch.from_numpy(arr)  # a view: no crossing on the CPU
    key = (device, arr.dtype.str, arr.shape, arr.tobytes())
    t = _cache.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a host constant was first built during a CUDA graph "
                "capture; the warm-up run should have staged it")
        t = XF.to_device(arr, device, label="lut")
        with _lock:
            t = _cache.setdefault(key, t)
    return t
