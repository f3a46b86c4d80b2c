"""THE host<->device transfer plane: every data-plane crossing routes
through the choke points below, and every crossing site of the port is
declared in TRANSFER_REGISTRY.

Port of presto_tpu/exec/xfer.py. Two sides, one discipline:

  static   tests/test_torch_xfer.py sweeps presto_tpu_torch/ for the
           transfer primitives (``.cpu()``, ``.numpy()``,
           ``torch.from_numpy``/``torch.as_tensor``/``torch.tensor``
           and ``.to(<device>)``) and fails on a site missing from
           TRANSFER_REGISTRY, a stale registry row, a ``data``-plane
           row outside DATA_PLANE_MODULES, and a RAW primitive inside a
           data-plane module that does not route through the choke
           points (escape: ``# xfercheck: raw-ok - <why>`` on the call
           line or the line above).
  dynamic  the choke points (``to_host`` / ``to_device`` / ``np_host``)
           meter every crossing — bytes, count, wall — onto the
           process totals here AND onto the thread-bound executor's
           registry counters (h2d_bytes / d2h_bytes / h2d_transfers /
           d2h_transfers + the computed transfer_wall_s), and emit an
           ``xfer`` span when that executor is traced.

What a crossing is: a host page holds numpy arrays and a device page
holds tensors (CPU tensors when the executor runs on the CPU), so a
choke point meters by what the leaf is, not by the device. A numpy
array going in is h2d; a tensor coming out to numpy is d2h — as the
reference's CPU backend meters jax arrays, so the counts on the CPU are
comparable with it, and on the card they are real PCIe copies.

What a wall means: ``.cpu()`` waits for all the work queued on the
device before it, so a d2h wall on the card includes the compute queued
ahead of the pull, as the reference's ``device_get`` does. No choke
point adds a synchronize of its own.

Sink binding is per thread (execute()/stream_fragment() install the
running executor via swap_sink), so concurrent tasks never cross-count.
The process totals are plain attribute adds under the GIL — a lost
increment under contention is a metric error, never a correctness one.

Plane vocabulary for registry rows:
  data     the per-page query path — scan/exchange/spill/decode pages
           of live queries. Only modules listed in DATA_PLANE_MODULES
           may host ``data`` sites.
  control  setup, diagnostics, plan-time constants — crossings that
           never scale with query data volume.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------
# site -> (direction, plane, justification)
#   direction: "h2d" | "d2h" | "h2d+d2h" (the site crosses both ways)
#   plane:     "data" | "control"  (see module docstring)
# Site names are canonical ``module[.Class].function`` paths under
# presto_tpu_torch/ (nested defs attribute to their enclosing top-level
# function). Every row is cross-checked against a real primitive call
# site: a stale row fails like a stale QUERY_COUNTERS entry.
# ---------------------------------------------------------------------
TRANSFER_REGISTRY: Dict[str, Tuple[str, str, str]] = {
    # ---- the choke points themselves (the only raw-primitive sites
    # allowed in data-plane modules without an escape)
    "exec.xfer._to_numpy": (
        "d2h", "data",
        "THE d2h primitive of to_host/np_host: one tensor to host "
        "numpy, metered by its caller"),
    "exec.xfer._stage": (
        "h2d", "data",
        "THE h2d primitive of to_device: one numpy array onto the "
        "target device, metered by its caller"),
    "exec.xfer.stage_into": (
        "h2d", "data",
        "THE in-place h2d primitive: one numpy array copied into an "
        "existing device tensor, metered here"),
    # ---- page construction (the host-values -> device ingest edge)
    "page.Page.from_arrays": (
        "h2d", "data",
        "page construction stages the validity mask onto the device "
        "(column blocks stage via _encode_column) — the ingest "
        "boundary of Values and test pages"),
    "page._encode_column": (
        "h2d", "data",
        "encoded column data/null arrays stage host values onto the "
        "device at page construction"),
    # ---- result decode (the client/test boundary)
    "page.Page.to_pylist": (
        "d2h", "data",
        "row materialization reads the validity mask (block columns "
        "follow via _host)"),
    "page._host": (
        "d2h", "data",
        "column decode pulls block data/null arrays to host"),
    # ---- the memory connector (BASELINE config 1's ingest)
    "connectors.memory.MemoryConnector.page_for_split": (
        "h2d", "data",
        "a stored table's split stages its column slices onto the "
        "device, one copy per array (page-build)"),
    "connectors.memory._column_from_blocks": (
        "d2h", "data",
        "table writes (CTAS/INSERT/DELETE/UPDATE) pull each result "
        "block to host numpy once per write"),
    "connectors.memory._columns_of_pages": (
        "d2h", "data",
        "table writes read each result page's validity mask"),
    "connectors.blackhole.BlackholeConnector._count": (
        "d2h", "data",
        "a write into the blackhole reads each result page's validity "
        "mask to acknowledge its row count"),
    # ---- executor data plane
    "exec.executor.Executor._pages_impl": (
        "h2d", "data",
        "RemoteSource ingest: deserialized exchange pages stage onto "
        "the device before entering the consumer fragment"),
    "exec.executor.Executor._cached_pages": (
        "d2h", "data",
        "a result-cache hit at the host sink counts its EXPLAIN ANALYZE "
        "rows from the stored host valid mask (numpy: nothing crosses)"),
    "exec.executor.Executor._stage_replay": (
        "h2d", "data",
        "a result-cache hit below the host sink stages its stored host "
        "pages onto the device for the consumer above (cache-replay)"),
    "exec.executor.Executor._join_partition_rebalanced": (
        "d2h", "data",
        "grace-join skew rebalance reads per-piece row counts (host "
        "decision point, on the boosted retry path)"),
    "exec.graphs.Program._inputs": (
        "h2d", "data",
        "a fused program run op by op stages its B int64 split starts "
        "and counts per launch (not page data)"),
    "exec.graphs.Program._replay": (
        "h2d", "data",
        "a captured graph's replay copies its B split starts and "
        "counts into the graph's static input buffers per launch"),
    # ---- spill tiers
    "exec.pagestore.PageStore.put": (
        "d2h", "data",
        "host/disk spill tiers pull materialized pages off the "
        "device"),
    "exec.pagestore.PageStore.stream": (
        "h2d", "data",
        "spilled intermediates re-stage onto the device per restream "
        "pass"),
    # ---- DCN exchange serialization plane
    "dist.serde._host": (
        "d2h", "data",
        "page wire format reads block arrays host-side; pages arrive "
        "already host at the process boundary, so bytes cross only "
        "when a caller serializes a device page"),
    "dist.spool._np": (
        "d2h", "data",
        "host-tier partitioning (hash, compaction) reads the arrays "
        "of already-host pages; the one accounted pull is "
        "server.worker's task-emit"),
    "dist.spool._dict_luts": (
        "h2d", "data",
        "device-tier exchange partitioning stages a dictionary "
        "value-hash LUT per key dictionary per page (dict-hash)"),
    "dist.spool.device_partition_pages": (
        "h2d+d2h", "data",
        "device-tier exchange partitioning: a host-resident input "
        "stages through the choke point (device pages pass free), and "
        "the nparts-long per-partition row-count vector pulls back "
        "per page (spool-stats)"),
    "dist.spool.spool_blob": (
        "d2h", "data",
        "lazy spool materialization: device-resident exchange pages "
        "serialize to wire bytes only when an HTTP fetch or the "
        "spool budget needs host bytes"),
    # ---- the mesh (dist/executor.py)
    "dist.executor._to_dev": (
        "h2d", "data",
        "a peer copy of a shard's tensor between two cards of the mesh "
        "(all_to_all landing, replicas, gathers); no host crossing, and "
        "on one card every shard shares the device and nothing moves"),
    "dist.executor.ici_exchange_pages": (
        "h2d+d2h", "data",
        "ICI exchange staging: spooled producer pages onto the exchange "
        "mesh (device-resident pages cross ZERO bytes; a host-resident "
        "input, a spool that serialized past its budget, pays its h2d "
        "once); each round pulls its landing pages' row counts back "
        "(ici-counts, 8 bytes per page and partition)"),
    # ---- worker task runtime
    "server.worker.TaskRuntime.serve_cached_fragment": (
        "d2h", "data",
        "the fleet cache probe's serve counts each cached host page's "
        "rows from its valid mask (numpy: nothing crosses)"),
    "server.worker.TaskRuntime._run_task": (
        "d2h", "data",
        "host-tier fragment output leaves the device exactly once, at "
        "the serialization boundary (task-emit)"),
    # ---- expression evaluation
    "expr.functions_ext._host_block": (
        "h2d", "data",
        "host-side lambda evaluation (array higher-order functions) "
        "builds its element column as a CPU block once per "
        "distinct-argument page"),
    "expr.functions_ext._val_to_pylist": (
        "d2h", "data",
        "host-side lambda evaluation pulls the element column once "
        "per distinct-argument page"),
    # ---- constants staged once (sized by dictionary cardinality or a
    # fixed table, never by query data volume)
    "ops.consts.lut": (
        "h2d", "control",
        "host-built constant tables (dictionary remaps, rank tables) "
        "staged once per content before any graph capture (metered "
        "h2d:lut on the card; a view on the CPU)"),
    "connectors.tpch.TpchConnector.__init__": (
        "h2d", "control",
        "the nation->region map (25 entries) staged once per "
        "connector"),
    # ---- the interop boundary (tests and chip_smoke.py)
    "interop.page_from_numpy": (
        "h2d", "control",
        "a reference engine page's numpy arrays become a port page"),
    "interop.page_arrays": (
        "d2h", "control",
        "a port page's tensors become numpy for the reference "
        "engine"),
}

# modules (dotted paths under presto_tpu_torch/) whose crossings are
# per-page query work: `data`-plane rows must live here, and raw
# primitives here must route through the choke points above.
DATA_PLANE_MODULES = frozenset({
    "page",
    "connectors.blackhole",
    "connectors.memory",
    "exec.executor",
    "exec.graphs",
    "exec.pagestore",
    "exec.xfer",
    "dist.executor",
    "dist.serde",
    "dist.spool",
    "server.worker",
    "expr.functions_ext",
})


# ------------------------------------------------------ process totals
class _Totals:
    """Process-lifetime transfer tallies (per-query executors come and
    go; the process truth lives here)."""

    __slots__ = ("h2d_bytes", "d2h_bytes", "h2d_transfers",
                 "d2h_transfers", "transfer_wall_s")

    def __init__(self) -> None:
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.h2d_transfers = 0
        self.d2h_transfers = 0
        self.transfer_wall_s = 0.0


_totals = _Totals()
_tls = threading.local()


def process_totals() -> Dict[str, float]:
    """Snapshot of the process-lifetime transfer counters under the
    registry counter names (+ transfer_wall_s)."""
    return {
        "h2d_bytes": _totals.h2d_bytes,
        "d2h_bytes": _totals.d2h_bytes,
        "h2d_transfers": _totals.h2d_transfers,
        "d2h_transfers": _totals.d2h_transfers,
        "transfer_wall_s": round(_totals.transfer_wall_s, 6),
    }


def swap_sink(sink) -> Optional[object]:
    """Install ``sink`` (an Executor, or None) as THIS thread's
    metering target and return the previous one — execute()/
    stream_fragment() bracket their run with a swap/restore pair so
    nested executors and concurrent task threads never cross-count."""
    prev = getattr(_tls, "sink", None)
    _tls.sink = sink
    return prev


def current_sink() -> Optional[object]:
    """THIS thread's metering sink (an Executor, or None)."""
    return getattr(_tls, "sink", None)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _stage(a, device: torch.device):
    """A numpy leaf onto ``device``; a tensor (a device page's leaf)
    stays as it is."""
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return a


def _meter(direction: str, nbytes: int, wall: float, label: str) -> None:
    if direction == "h2d":
        _totals.h2d_transfers += 1
        _totals.h2d_bytes += nbytes
    else:
        _totals.d2h_transfers += 1
        _totals.d2h_bytes += nbytes
    _totals.transfer_wall_s += wall
    sink = getattr(_tls, "sink", None)
    if sink is None:
        return
    sink.count_transfer(direction, nbytes, wall)
    tr = sink.trace
    if tr is not None:
        t1 = tr.now()
        tr.complete("xfer", f"{direction}:{label}", t1 - wall, t1,
                    bytes=nbytes)
        sink.trace_spans += 1


# --------------------------------------------------------- choke points
def to_host(tree, label: str = "page"):
    """Pull a page (or tensor, or tuple of them) to a host page — THE
    metered d2h crossing: the result has numpy leaves. Input with no
    tensor leaf passes through with nothing metered."""
    from presto_tpu_torch.exec import graphs  # graphs imports xfer

    leaves: list = []
    spec = graphs.flatten(tree, leaves)
    nbytes = sum(a.nbytes for a in leaves if isinstance(a, torch.Tensor))
    if nbytes == 0:
        return tree
    t0 = time.perf_counter()
    host = [_to_numpy(a) if isinstance(a, torch.Tensor) else a
            for a in leaves]
    _meter("d2h", nbytes, time.perf_counter() - t0, label)
    return graphs.unflatten(spec, iter(host))


def to_device(tree, device, label: str = "page"):
    """Stage a host page (or array, or tuple of them) onto ``device`` —
    THE metered h2d crossing: the result has tensor leaves on
    ``device``. Tensor leaves are a device page's and stay as they
    are, with no bytes metered."""
    from presto_tpu_torch.exec import graphs  # graphs imports xfer

    device = torch.device(device)
    leaves: list = []
    spec = graphs.flatten(tree, leaves)
    nbytes = sum(a.nbytes for a in leaves if isinstance(a, np.ndarray))
    t0 = time.perf_counter()
    out = [_stage(a, device) for a in leaves]
    if nbytes:
        _meter("h2d", nbytes, time.perf_counter() - t0, label)
    return graphs.unflatten(spec, iter(out))


def stage_into(dst: torch.Tensor, arr: np.ndarray, label: str) -> None:
    """Copy the host array ``arr`` into the device tensor ``dst`` in
    place — the metered h2d crossing of a buffer that must keep its
    address (a captured CUDA graph's static inputs)."""
    t0 = time.perf_counter()
    dst.copy_(torch.from_numpy(arr))
    _meter("h2d", arr.nbytes, time.perf_counter() - t0, label)


def np_host(arr, label: str = "array") -> np.ndarray:
    """numpy of ONE array, metered as d2h only when ``arr`` is a tensor
    (a device page's leaf) — the accounted replacement for scattered
    ``.cpu().numpy()`` pulls (page decode, wire serde, spool
    partitioning). A host page's numpy leaf passes through: zero
    copies, zero meters."""
    if isinstance(arr, torch.Tensor):
        t0 = time.perf_counter()
        out = _to_numpy(arr)
        _meter("d2h", out.nbytes, time.perf_counter() - t0, label)
        return out
    return np.asarray(arr)
