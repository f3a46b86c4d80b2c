"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

Each source compiles on first use with nvcc for Hopper (``sm_90a``) into
a shared library with a plain C interface, written to ``_build/`` beside
this file (a directory git ignores), and loads with ctypes. Sources
build in parallel: one nvcc per source, all started together. Nothing
here runs at import time, so the CPU tests import every module without
a CUDA toolkit.

Every C entry point that launches does so on the caller's current
stream, allocates nothing and returns cudaGetLastError(); ``call``
raises if that is not 0. There is no fallback: a failed build or launch
raises.

``launches`` counts kernel launches by kernel name (a wrapper calls
``count(launches, name)`` exactly where it launches); ``plain_calls``
counts calls that took the plain PyTorch version because their tensors
lay on the CPU. Worker tasks launch from several threads at once, so
the counts move under a lock. A wrapper called while its thread
captures a CUDA graph launches nothing yet: its count goes to the
capture's own counter (``capturing``), and exec/graphs.py adds that
counter to ``launches`` on every replay of the graph.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from presto_tpu_torch.obs.sanitizer import make_lock

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

# library -> (source, {C symbol: argtypes})
LIBRARIES = {
    "segsum": ("segsum.cu", {
        # device, ids|NULL, ids_bytes, mask|NULL, values|NULL, n, groups,
        # with_sum, with_count, out, scratch|NULL, stream
        "presto_segsum_i64": [_I, _P, _I, _P, _P, _I64, _I, _I, _I, _P, _P,
                              _P],
        # device, groups -> the bytes of scratch presto_segsum_i64 needs
        "presto_segsum_scratch_bytes": [_I, _I],
    }),
    "hash_probe": ("hash_probe.cu", {
        # device, hashes, n, keys, payload, dim_layout, layout_param,
        # max_probes, out_start, out_count, stream
        "presto_hash_probe": [_I, _P, _I64, _P, _P, _I, _I, _I, _P, _P,
                              _P],
    }),
    "part_ids": ("part_ids.cu", {
        # device, enc, cols, n, nparts, out, stream
        "presto_part_ids": [_I, _P, _I, _I64, _I, _P, _P],
    }),
}

launches: collections.Counter = collections.Counter()
plain_calls: collections.Counter = collections.Counter()

_loaded: Dict[str, ctypes.CDLL] = {}
# C symbol -> its resolved ctypes function, filled once when its library
# loads: a launch reads it without the load lock and without getattr
_functions: Dict[str, Callable[..., int]] = {}
_lock = make_lock("cuda._lock")
_count_lock = make_lock("cuda._count_lock")
# per thread: the Counter of the graph capture in progress, if any
_capture = threading.local()


def count(counter: collections.Counter, name: str) -> None:
    """Add one to ``counter[name]`` (``launches`` or ``plain_calls``);
    during a graph capture on this thread, a launch is recorded in the
    capture's counter instead."""
    recorded = getattr(_capture, "counter", None)
    if recorded is not None and counter is launches:
        recorded[name] += 1
        return
    with _count_lock:
        counter[name] += 1


def add_counts(counter: collections.Counter,
               counts: collections.Counter) -> None:
    """Add a graph's captured launches to ``counter`` (one replay)."""
    if counts:
        with _count_lock:
            counter.update(counts)


@contextlib.contextmanager
def capturing():
    """Record this thread's kernel launches in a Counter of their own
    (yielded) while a CUDA graph captures them."""
    recorded: collections.Counter = collections.Counter()
    prev = getattr(_capture, "counter", None)
    _capture.counter = recorded
    try:
        yield recorded
    finally:
        _capture.counter = prev


def launch_counts() -> Dict[str, int]:
    """A copy of ``launches`` (worker threads launch meanwhile)."""
    with _count_lock:
        return dict(launches)


def load_all() -> None:
    """Build what is not built yet (in parallel), then load every
    library: a process that serves the card fails at its start, not at
    its first query, when a kernel cannot load."""
    build()
    for lib in LIBRARIES:
        library(lib)


def reset_counts() -> None:
    with _count_lock:
        launches.clear()
        plain_calls.clear()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "",
            "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(lib: str) -> str:
    """The library path, keyed by the source and flags' content so an
    edited source never loads a stale build."""
    src = os.path.join(CSRC, LIBRARIES[lib][0])
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{lib}-{digest.hexdigest()[:12]}.so")


def build(libs: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named libraries (all by default) that are not built
    yet, one nvcc process per source, all running at once. Returns the
    wall seconds of each compile; raises with nvcc's output on failure."""
    todo = [lib for lib in (libs or LIBRARIES)
            if not os.path.exists(_target(lib))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for lib in todo:
        out = _target(lib)
        tmp = f"{out}.{os.getpid()}.tmp"
        src = os.path.join(CSRC, LIBRARIES[lib][0])
        procs[lib] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out, time.perf_counter())
    secs, errors = {}, []
    for lib, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[lib] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {lib} ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def library(lib: str) -> ctypes.CDLL:
    """The loaded library, building it first if needed."""
    with _lock:
        handle = _loaded.get(lib)
        if handle is None:
            # concheck: blocking-ok - single-flight build: every caller needs this library, and function() skips the lock once loaded
            build([lib])
            handle = ctypes.CDLL(_target(lib))
            for sym, argtypes in LIBRARIES[lib][1].items():
                fn = getattr(handle, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _functions[sym] = fn
            _loaded[lib] = handle
        return handle


def function(lib: str, sym: str) -> Callable[..., int]:
    """The ctypes function ``sym`` of ``lib``, loading it first if
    needed."""
    fn = _functions.get(sym)
    if fn is None:
        library(lib)
        fn = _functions[sym]
    return fn


def device_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def call(lib: str, sym: str, device: torch.device, *args) -> None:
    """Launch ``sym`` of ``lib`` on ``device``'s current stream; raises
    if the launch reports an error."""
    fn = function(lib, sym)
    dev = device_index(device)
    # the raw cudaStream_t of the current stream, without building a
    # torch.cuda.Stream object per launch
    err = fn(dev, *args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {sym} failed to launch: "
                           f"cudaError {err}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 device: torch.device, ndim: int = 1) -> None:
    """The checks every kernel wrapper makes before a launch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
