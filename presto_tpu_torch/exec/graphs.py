"""Captured CUDA graphs of the fused per-split programs.

The port's counterpart of presto_tpu's ``Executor._jit``: where the
reference compiles one XLA program per canonical key and launches it per
split (or per batch of splits), the port captures the same per-split
function once into a ``torch.cuda.CUDAGraph`` and replays it. A split
then pays one graph launch instead of one kernel launch per operator.

A ``Program`` is a function ``fn(starts, counts) -> outputs`` of two
int64 device tensors of B split starts and row counts, whose outputs are
Pages, tensors and tuples of them. On a CUDA device:

  - the first call writes the inputs into static buffers, runs ``fn``
    once op by op on a side stream (the warm-up of torch's recipe: it
    builds the kernels, stages host constants and fills lazy caches,
    and its outputs are this call's result), then captures ``fn`` on
    that stream in ``thread_local`` mode, so worker threads that touch
    the card meanwhile do not break the capture;
  - every later call writes the inputs into the static buffers, replays
    the graph and clones the outputs, which the next replay overwrites.

A failed capture or replay raises; nothing falls back to op-by-op
execution. On the CPU a Program runs ``fn`` op by op: that is this
module's plain version, and what the CPU tests exercise.

Programs live in one process-wide cache keyed like the reference's jit
cache (chain identity, n_pad, batch size, capacity boost, plus the
generators the chain reads), so the tasks of a distributed query and
repeated queries replay one capture. A Program runs one call at a time
(its lock), on the caller's current stream. Each graph holds a private
memory pool; the cache keeps at most MAX_PROGRAMS and frees the least
recently used beyond that. A query's device fault releases that query's
programs (``release``) and, while the card stays short, the least
recently used others one by one (``release_lru``), never the whole
cache at once.

Kernel launch counts (presto_tpu_torch.cuda): the warm-up launches and
counts as any op-by-op run; the capture records its launches apart; each
replay adds them to ``cuda.launches``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from presto_tpu_torch import cuda
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.obs.sanitizer import make_lock, register_owner
from presto_tpu_torch.page import Block, Page

MAX_PROGRAMS = 64

_LEAF = "leaf"

# process totals: graphs captured, seconds spent capturing them (warm-up
# included), graph replays
stats: Dict[str, float] = {"captures": 0, "capture_s": 0.0, "replays": 0}
_stats_lock = make_lock("exec.graphs._stats_lock")


def snapshot() -> Dict[str, float]:
    """A copy of the process totals (the baseline of delta())."""
    with _stats_lock:
        return dict(stats)


def delta(base: Dict[str, float]) -> Dict[str, float]:
    """The process totals' growth since ``base``: the executor's
    programs_compiled (captures), compile_wall_s (capture seconds) and
    program_cache_hits (replays) of one query."""
    now = snapshot()
    return {k: now[k] - base.get(k, 0) for k in now}


def flatten(obj, leaves: list):
    """The arrays of a page tree — a program's output, or a host page's
    numpy arrays — (appended to ``leaves``) and its skeleton; host
    metadata (types, dictionaries) rides in the skeleton."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        leaves.append(obj)
        return _LEAF
    if isinstance(obj, Page):
        return ("page", tuple(flatten(b, leaves) for b in obj.blocks),
                flatten(obj.valid, leaves))
    if isinstance(obj, Block):
        return ("block", flatten(obj.data, leaves),
                flatten(obj.nulls, leaves), obj.type, obj.dictionary)
    if isinstance(obj, tuple):
        return ("tuple", tuple(flatten(x, leaves) for x in obj))
    if obj is None:
        return None
    raise TypeError(f"not a page tree: {type(obj).__name__}")


def unflatten(spec, leaves):
    """Inverse of flatten over an iterator of arrays."""
    if spec is None:
        return None
    if spec == _LEAF:
        return next(leaves)
    kind = spec[0]
    if kind == "page":
        blocks = tuple(unflatten(b, leaves) for b in spec[1])
        return Page(blocks=blocks, valid=unflatten(spec[2], leaves))
    if kind == "block":
        data = unflatten(spec[1], leaves)
        return Block(data=data, type=spec[3], nulls=unflatten(spec[2], leaves),
                     dictionary=spec[4])
    return tuple(unflatten(x, leaves) for x in spec[1])


def leaves_of(obj) -> List[torch.Tensor]:
    """Every tensor of a program's output, in a fixed order."""
    leaves: List[torch.Tensor] = []
    flatten(obj, leaves)
    return leaves


_side = threading.local()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """This thread's warm-up and capture stream (one per thread, so
    concurrent captures never share a stream, and reused, so the memory
    its warm-ups free stays usable)."""
    streams = getattr(_side, "streams", None)
    if streams is None:
        streams = _side.streams = {}
    key = cuda.device_index(device)
    if key not in streams:
        streams[key] = torch.cuda.Stream(device)
    return streams[key]


class Program:
    """One fused program: ``fn(starts, counts)`` over ``batch`` splits,
    captured into a CUDA graph on its first call on a CUDA device.

    Every call runs under ``_lock``, the capture and the host-to-device
    copies included, and that blocking is deliberate: the graph replays
    into ONE set of static input and output buffers, so two replays (or
    a replay and the capture) of one program cannot overlap; a caller
    that arrives during the capture needs the graph it makes; and ``fn``
    is a closure over one chain, written to run one call at a time. The
    lock is the program's own: calls of other programs, and the cache's
    lookups (``_programs_lock``), never wait on it."""

    # the graph, its static buffers and the call record, written only
    # under _lock (by __call__ and its *_locked helpers)
    _shared_attrs = ("_graph", "_starts", "_counts", "_outputs", "_spec",
                     "_launches", "capture_s", "calls", "last_call")

    def __init__(self, fn: Callable, batch: int, device: torch.device):
        self.fn = fn
        self.batch = batch
        self.device = torch.device(device)
        self._lock = make_lock("exec.graphs.Program._lock")
        self._graph = None
        self._starts = None
        self._counts = None
        self._outputs: List[torch.Tensor] = []
        self._spec = None
        self._launches: collections.Counter = collections.Counter()
        self.capture_s = 0.0
        # calls made, and the inputs of the latest (a check replays it)
        self.calls = 0
        self.last_call = None
        register_owner(self)

    def _inputs(self, values: Sequence[int]) -> torch.Tensor:
        if len(values) != self.batch:
            raise ValueError(f"{len(values)} splits for a program of "
                             f"{self.batch}")
        return XF.to_device(np.asarray(list(values), dtype=np.int64),
                            self.device, label="batch-starts")

    def eager(self, starts: Sequence[int], counts: Sequence[int]):
        """``fn`` op by op on the program's device, on fresh inputs: the
        plain version a replay is held against."""
        return self.fn(self._inputs(starts), self._inputs(counts))

    def __call__(self, starts: Sequence[int], counts: Sequence[int]):
        with self._lock:
            self.calls += 1
            self.last_call = (list(starts), list(counts))
            if self.device.type != "cuda":
                # concheck: blocking-ok - fn runs one call at a time
                return self.eager(starts, counts)
            if self._graph is None:
                # concheck: blocking-ok - the static buffers' one writer
                return self._capture_locked(starts, counts)
            # concheck: blocking-ok - the static buffers' one writer
            return self._replay_locked(starts, counts)

    def _capture_locked(self, starts, counts):
        t0 = time.perf_counter()
        # concheck: blocking-ok - the capture's static inputs (class doc)
        self._starts = self._inputs(starts)
        # concheck: blocking-ok - the capture's static inputs (class doc)
        self._counts = self._inputs(counts)
        current = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            out = self.fn(self._starts, self._counts)
            with cuda.capturing() as launched:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static = self.fn(self._starts, self._counts)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is void; the first error wins
                    raise
                graph.capture_end()
        current.wait_stream(side)
        for t in leaves_of(out):
            # made on the side stream, consumed on the caller's
            t.record_stream(current)
        self._outputs = []
        self._spec = flatten(static, self._outputs)
        self._launches = launched
        self._graph = graph
        self.capture_s = time.perf_counter() - t0
        with _stats_lock:
            stats["captures"] += 1
            stats["capture_s"] += self.capture_s
        return out

    def _replay_locked(self, starts, counts):
        # concheck: blocking-ok - the replay's static inputs (class doc)
        XF.stage_into(self._starts, np.asarray(starts, dtype=np.int64),
                      "batch-starts")
        # concheck: blocking-ok - the replay's static inputs (class doc)
        XF.stage_into(self._counts, np.asarray(counts, dtype=np.int64),
                      "batch-starts")
        self._graph.replay()
        cuda.add_counts(cuda.launches, self._launches)
        with _stats_lock:
            stats["replays"] += 1
        return unflatten(self._spec, iter([t.clone() for t in self._outputs]))


_programs: "collections.OrderedDict[tuple, Program]" = \
    collections.OrderedDict()
_programs_lock = make_lock("exec.graphs._programs_lock")


def program(key: tuple, build: Callable[[], Callable], batch: int,
            device: torch.device) -> Program:
    """The cached Program of ``key``, made from ``build()`` on a miss.
    ``build()`` runs off the cache's lock, so one query's miss never
    stalls another's lookup; of two racing misses the first to insert
    wins and the other's build is dropped."""
    with _programs_lock:
        prog = _programs.get(key)
        if prog is not None:
            _programs.move_to_end(key)
            return prog
    fn = build()
    with _programs_lock:
        prog = _programs.get(key)
        if prog is None:
            prog = _programs[key] = Program(fn, batch, device)
            while len(_programs) > MAX_PROGRAMS:
                _programs.popitem(last=False)
        else:
            _programs.move_to_end(key)
        return prog


def cached() -> List[tuple]:
    """(key, Program) of every cached program, least recently used
    first."""
    with _programs_lock:
        return list(_programs.items())


def clear() -> None:
    """Drop every cached program (and its graph's memory pool)."""
    with _programs_lock:
        _programs.clear()


def release(keys) -> List[tuple]:
    """Drop the cached programs of ``keys`` (one query's, on its device
    fault); returns the keys that were cached, least recently used
    first. A caller still holding a Program keeps it alive until it is
    done with it."""
    keys = set(keys)
    with _programs_lock:
        out = [k for k in _programs if k in keys]
        for k in out:
            del _programs[k]
    return out


def release_lru():
    """Drop the least recently used cached program; its key, or None
    when the cache is empty."""
    with _programs_lock:
        if not _programs:
            return None
        return _programs.popitem(last=False)[0]
