"""Spooled-exchange data plane of the stage-DAG scheduler.

Port of presto_tpu/dist/spool.py (reference: presto-main
operator/PartitionedOutputOperator.java — the producer half of a
hash-repartition exchange, routing each row to a partition buffer by
hash(keys) % P — and operator/ExchangeClient.java — the consumer half,
token-acked page fetch from every producer task). Partition buffers are
SPOOLED on the producing worker (server/worker._TaskSpool) and outlive
the producing task's execution.

Two partitioning tiers, as in the reference:

  - HOST tier (`partition_host_page`): numpy on a page pulled to the
    host, splitmix64 value-hash, pages compacted to ladder capacities
    and serialized into the spool;
  - DEVICE tier (`device_partition_pages`): partition ids and the
    per-partition compaction run on the page's device, and the spool
    holds the partition Pages themselves, serialized lazily
    (`spool_blob`) only when an HTTP fetch needs bytes. Its partition
    ids come from the same splitmix64 hash (`device_row_hash_u64`,
    bit-identical to the host tier), or — when the session's
    ``pallas_join_enabled`` is true — from K4 (ops/cuda_part.py, the
    port of `_pallas_part_ids`), whose fmix32 fold is NOT splitmix64-
    compatible: routing needs only self-consistency across the
    producers of one exchange, and the session decides the tier for
    all of them alike.

Keys hash from VALUE encodings (int64 bit-views, IEEE-754 bit-views
with -0.0/NaN normalization, dictionary VALUES via a host xxhash64 LUT)
so equal SQL values land in the same partition whichever task emitted
them; NULL keys hash to a fixed sentinel. u64 values live as int64
bit-views (ops/u64.py).

The consumer half: `fetch_spool_blobs` (worker-to-worker HTTP fetch,
token-dedupe, `?part=p&max=N` streamed frames), `local_source_pages`
(a same-process producer's spooled Pages handed over with no HTTP or
serde) and `iter_source_pages` (one RemoteSource edge).
"""

from __future__ import annotations

import functools
import json
import struct
import time
import urllib.error
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.exec import shapes as SH
from presto_tpu_torch.exec import xfer as XF
from presto_tpu_torch.exec.executor import check_deadline
from presto_tpu_torch.ops import cuda_part as CP
from presto_tpu_torch.ops import u64
from presto_tpu_torch.ops.hashing import xxhash64_host
from presto_tpu_torch.page import Block, Page

_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_NULL_SENTINEL = np.uint64(0x9E3779B185EBCA87)
_NAN_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)
_C31 = np.uint64(31)

# int64 bit-views of the same constants for the device tier
_MIX1_I = u64.const(int(_MIX1))
_MIX2_I = u64.const(int(_MIX2))
_NULL_SENTINEL_I = u64.const(int(_NULL_SENTINEL))
_NAN_KEY_I = u64.const(int(_NAN_KEY))


def _np(t) -> np.ndarray:
    """Host numpy of one array: a metered d2h pull for a tensor, a
    view of a host page's numpy leaf (exec/xfer.py)."""
    return XF.np_host(t)


# ------------------------------------------------------------ host tier
def _mix64(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized, natural uint64 wraparound)."""
    with np.errstate(over="ignore"):
        h = (h ^ (h >> np.uint64(30))) * _MIX1
        h = (h ^ (h >> np.uint64(27))) * _MIX2
        return h ^ (h >> np.uint64(31))


@functools.lru_cache(maxsize=64)
def _dict_value_hashes(dictionary) -> np.ndarray:
    """Per-code value hashes of one Dictionary (xxhash64 of each
    value's repr), memoized by content."""
    return np.array(
        [xxhash64_host(repr(v).encode()) for v in dictionary.values],
        dtype=np.uint64,
    )


def _block_value_u64(blk: Block) -> np.ndarray:
    """Per-row uint64 VALUE encoding of one key block (host numpy)."""
    data = blk.data
    if isinstance(data, tuple):
        # long decimal (hi, lo): combine the two words
        arrs = [_np(d) for d in data]
        h = np.zeros(arrs[0].shape[0], dtype=np.uint64)
        with np.errstate(over="ignore"):
            for a in arrs:
                h = h * _C31 + a.astype(np.int64).view(np.uint64)
        return h
    arr = _np(data)
    if blk.dictionary is not None:
        # dictionary VALUES, not task-local codes
        vh = _dict_value_hashes(blk.dictionary)
        if len(vh) == 0:
            return np.zeros(arr.shape[0], dtype=np.uint64)
        codes = np.clip(arr.astype(np.int64), 0, len(vh) - 1)
        return vh[codes]
    if arr.dtype == np.bool_:
        return arr.astype(np.uint64)
    if np.issubdtype(arr.dtype, np.floating):
        f = arr.astype(np.float64)
        f = np.where(f == 0.0, 0.0, f)  # -0.0 == +0.0 (SQL equality)
        bits = f.view(np.uint64)
        return np.where(np.isnan(f), _NAN_KEY, bits)
    return arr.astype(np.int64).view(np.uint64)


def row_hash_u64(page: Page, keys: Sequence[int]) -> np.ndarray:
    """Per-row partition hash over the key channels (31*h + mix(col),
    the reference's CombineHashFunction shape over splitmix-dispersed
    column encodings)."""
    h = np.zeros(page.capacity, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for k in keys:
            blk = page.block(k)
            col = _mix64(_block_value_u64(blk))
            if blk.nulls is not None:
                col = np.where(_np(blk.nulls), _NULL_SENTINEL, col)
            h = h * _C31 + col
    return _mix64(h)


def take_rows_host(page: Page, idx: np.ndarray) -> Page:
    """Compact the given row indices of a host page into a fresh host
    page (numpy leaves) whose capacity sits on the shapes.py bucket
    ladder."""
    n = len(idx)
    cap = SH.bucket(max(n, 1))
    pad = np.zeros(cap, dtype=np.int64)
    pad[:n] = idx
    blocks: List[Block] = []
    for blk in page.blocks:
        data = (tuple(_np(d)[pad] for d in blk.data)
                if isinstance(blk.data, tuple) else _np(blk.data)[pad])
        nulls = _np(blk.nulls)[pad] if blk.nulls is not None else None
        blocks.append(Block(data=data, type=blk.type, nulls=nulls,
                            dictionary=blk.dictionary))
    valid = np.zeros(cap, dtype=bool)
    valid[:n] = True
    return Page(blocks=tuple(blocks), valid=valid)


def partition_host_page(page: Page, keys: Sequence[int],
                        nparts: int) -> List[Tuple[int, Page]]:
    """Split one page on the host into per-partition compacted pages.
    Partitions with zero rows are skipped (deterministically)."""
    valid = _np(page.valid)
    if nparts <= 1:
        return [(0, page)] if valid.any() else []
    part = (row_hash_u64(page, keys) % np.uint64(nparts)).astype(np.int64)
    out: List[Tuple[int, Page]] = []
    for p in range(nparts):
        idx = np.nonzero(valid & (part == p))[0]
        if len(idx):
            out.append((p, take_rows_host(page, idx)))
    return out


# ---------------------------------------------------------- device tier
def _mix64_dev(h: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit-views — bit-identical to the
    host `_mix64` (int64 multiplies wrap like uint64's; right shifts
    are logical through u64.srl)."""
    h = (h ^ u64.srl(h, 30)) * _MIX1_I
    h = (h ^ u64.srl(h, 27)) * _MIX2_I
    return h ^ u64.srl(h, 31)


def _block_value_u64_dev(blk: Block, vh) -> torch.Tensor:
    """Device mirror of `_block_value_u64` as an int64 bit-view. `vh`
    is the block's dictionary value-hash LUT (int64 tensor) or None."""
    data = blk.data
    if isinstance(data, tuple):
        h = torch.zeros(data[0].shape[0], dtype=torch.int64,
                        device=data[0].device)
        for a in data:
            h = h * 31 + a.to(torch.int64)
        return h
    if vh is not None:
        if vh.shape[0] == 0:
            return torch.zeros(data.shape[0], dtype=torch.int64,
                               device=data.device)
        return vh[data.to(torch.int64).clamp(0, vh.shape[0] - 1)]
    if data.dtype == torch.bool:
        return data.to(torch.int64)
    if data.is_floating_point():
        f = data.to(torch.float64)
        f = torch.where(f == 0.0, torch.zeros_like(f), f)
        return torch.where(torch.isnan(f), _NAN_KEY_I,
                           f.contiguous().view(torch.int64))
    return data.to(torch.int64)


def _dict_luts(page: Page, keys: Sequence[int]):
    """Per key, the dictionary value-hash LUT on the page's device (or
    None for a block without a dictionary)."""
    out = []
    for k in keys:
        d = page.block(k).dictionary
        out.append(None if d is None else XF.to_device(
            _dict_value_hashes(d).view(np.int64), page.device,
            label="dict-hash"))
    return tuple(out)


def device_row_hash_u64(page: Page, keys: Sequence[int],
                        dict_luts=()) -> torch.Tensor:
    """Device mirror of `row_hash_u64` (int64 bit-view): 31*h +
    mix(col) over splitmix-dispersed column encodings, NULL keys to the
    fixed sentinel. `dict_luts` aligns with `keys`."""
    luts = tuple(dict_luts) or (None,) * len(keys)
    h = torch.zeros(page.capacity, dtype=torch.int64, device=page.device)
    for k, vh in zip(keys, luts):
        blk = page.block(k)
        col = _mix64_dev(_block_value_u64_dev(blk, vh))
        if blk.nulls is not None:
            col = torch.where(blk.nulls, _NULL_SENTINEL_I, col)
        h = h * 31 + col
    return _mix64_dev(h)


def part_id_encodings(page: Page, keys: Sequence[int],
                      dict_luts=()) -> torch.Tensor:
    """K4's input: the stacked u64 value encodings of the key columns,
    int64 [C, N], NULL keys replaced by the sentinel encoding (on the
    RAW encoding, unlike the splitmix64 tier, which replaces the mixed
    column)."""
    luts = tuple(dict_luts) or (None,) * len(keys)
    encs = []
    for k, vh in zip(keys, luts):
        blk = page.block(k)
        enc = _block_value_u64_dev(blk, vh)
        if blk.nulls is not None:
            enc = torch.where(blk.nulls, _NULL_SENTINEL_I, enc)
        encs.append(enc)
    return torch.stack(encs)


def device_partition_pages(ex, page: Page, keys: Sequence[int],
                           nparts: int, with_counts: bool = False,
                           k4: Optional[bool] = None):
    """Device-tier `partition_host_page`: the partition assignment and
    the compaction of all `nparts` output pages to their ladder-bucket
    capacity run on the page's device. Every partition is emitted
    (empties carry all-False validity), so a re-run task regenerates an
    identical page sequence. A partition overflowing its landing
    capacity raises the executor's deferred overflow flag: skew
    degrades to a boosted retry.

    ``with_counts=True`` also returns the exact per-partition row
    counts, pulled as one nparts-long vector per page; the return shape
    is then ``(pairs, counts_np)``. ``k4`` overrides the session's
    choice of partition function (the ICI plane's fallback passes the
    one its collective routes with)."""
    page = XF.to_device(page, ex.device, label="spool-stage")
    if nparts <= 1:
        if with_counts:
            return [(0, page)], np.asarray(
                [int(XF.np_host(page.num_rows(), label="spool-stats"))],
                dtype=np.int64)
        return [(0, page)]
    luts = _dict_luts(page, keys)
    cap = SH.exchange_partition_cap(page.capacity, nparts,
                                    ex._capacity_boost)
    if ex._pallas_exchange_on() if k4 is None else k4:
        ex.pallas_kernels_used += 1
        part = CP.part_ids(part_id_encodings(page, keys, luts), nparts)
    else:
        part = u64.umod(device_row_hash_u64(page, keys, luts), nparts)
    # one stable sort by partition id (invalid rows last) makes every
    # partition a contiguous run of row indices in original order;
    # partition p gathers its run into its landing capacity. Rows past
    # the capacity are dropped and flag overflow, as the reference's
    # scatter drops them; slots past the row count hold gathered
    # garbage that the validity mask hides
    key = torch.where(page.valid, part.to(torch.int64), nparts)
    order = torch.argsort(key, stable=True)
    nums_t = torch.bincount(key, minlength=nparts + 1)[:nparts]
    starts = torch.cumsum(nums_t, 0) - nums_t
    slot = torch.arange(cap, dtype=torch.int64, device=page.device)
    outs = []
    for p in range(nparts):
        src = order[(starts[p] + slot).clamp(max=page.capacity - 1)]
        outs.append(Page(blocks=tuple(b.take(src) for b in page.blocks),
                         valid=slot < nums_t[p]))
    ex._pending_overflow.append((nums_t > cap).any())
    pairs = list(enumerate(outs))
    if with_counts:
        # one nparts-long pull per page (the reference's design); an
        # overflowing partition never publishes (the deferred flag
        # re-runs the attempt), so clamping only guards that transient
        counts = XF.np_host(nums_t, label="spool-stats").astype(np.int64)
        return pairs, np.minimum(counts, cap)
    return pairs


def trim_partition_page(page: Page, rows: int) -> Page:
    """A device partition page (nparts > 1: its rows are a dense
    prefix) cut to the ladder bucket of its row count, as a copy. With
    empty pages skipped as well, the spool then holds
    no empty pages and no landing-capacity padding: every exchange
    multiplies the page count by its partition count, so untrimmed
    landing pages compound through a chain of repartitioned joins. The
    host tier's pages have the same shape (take_rows_host)."""
    cap = min(SH.bucket(rows), page.capacity)
    if cap == page.capacity:
        return page
    idx = torch.arange(cap, device=page.device)
    return Page(blocks=tuple(b.take(idx) for b in page.blocks),
                valid=page.valid[:cap].clone())


def spool_blob(page: Page) -> bytes:
    """Materialize one spooled page to wire bytes — the lazy host
    materialization of the device-resident spool tier, called only when
    an HTTP fetch (or the spool budget) needs bytes. Deterministic, so
    a re-fetch serializes byte-identically."""
    from presto_tpu_torch.dist import serde

    return serde.serialize_page(XF.to_host(page, label="spool-blob"))


# ------------------------------------------------------------ client
class SourceTaskFailed(RuntimeError):
    """The upstream task itself failed (X-Task-Error), or its spool
    partition was already released."""


class SourceLost(RuntimeError):
    """An upstream task's spool is unreachable (node death)."""

    def __init__(self, uri: str, task_id: str, cause: str):
        super().__init__(f"[source-lost {uri} {task_id}] {cause}")
        self.uri = uri
        self.task_id = task_id


# the bounded in-flight-bytes window of one streaming fetch response:
# the server packs consecutive page frames up to this many bytes and
# the client decodes frame-at-a-time off the socket
FETCH_WINDOW_BYTES = 4 << 20


def pack_frames(blobs: Sequence[bytes]) -> bytes:
    """Server-side framing of a streamed results response: each page
    blob rides as `<q len | bytes>`."""
    out = bytearray()
    for b in blobs:
        out.extend(struct.pack("<q", len(b)))
        out.extend(b)
    return bytes(out)


def _read_exact(r, n: int, *, eof_ok: bool = False) -> Optional[bytes]:
    """Exactly n bytes from a response; None at a clean EOF when
    `eof_ok` (frame boundary). A mid-frame EOF raises ConnectionError."""
    chunks = []
    got = 0
    while got < n:
        c = r.read(n - got)
        if not c:
            if eof_ok and got == 0:
                return None
            raise ConnectionError(
                f"truncated page frame: got {got} of {n} bytes")
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def iter_response_frames(r) -> Iterator[bytes]:
    """Client half of `pack_frames`: yield each page blob as it comes
    off the socket, holding at most ONE frame in memory."""
    while True:
        head = _read_exact(r, 8, eof_ok=True)
        if head is None:
            return
        (ln,) = struct.unpack("<q", head)
        if ln < 0:
            raise ConnectionError(f"corrupt page-frame length {ln}")
        yield _read_exact(r, ln)


def fetch_spool_blobs(uri: str, task_id: str, part: int, *,
                      retries: int = 3, backoff_s: float = 0.1,
                      deadline: Optional[float] = None,
                      decode=None) -> Iterator:
    """Token-acked streaming fetch of one spool partition
    (at-least-once + dedupe-by-token, the HttpPageBufferClient protocol
    with the partition dimension added). The token advances one per
    yielded frame, so a mid-stream transport failure resumes at the
    first unconsumed page. With ``decode`` each frame is yielded as
    ``decode(frame)``, and a frame it rejects as corrupt
    (serde.PageWireError) is fetched again at the same token, as the
    coordinator's root fetch does; past the retries the PageWireError
    fails the consuming task. Raises SourceTaskFailed on X-Task-Error
    or a released partition, SourceLost after bounded transport
    retries."""
    from presto_tpu_torch.dist import connpool as CONNPOOL
    from presto_tpu_torch.dist.serde import PageWireError

    token = 0
    while True:
        attempt = 0
        while True:
            check_deadline(deadline, "in a spool fetch")
            try:
                with CONNPOOL.request(
                    f"{uri}/v1/task/{task_id}/results/{token}"
                    f"?part={part}&max={FETCH_WINDOW_BYTES}", timeout=60,
                ) as r:
                    if r.status == 204:
                        if r.headers.get("X-Done") == "1":
                            return
                        break  # long-poll timeout; re-ask same token
                    for body in iter_response_frames(r):
                        item = body if decode is None else decode(body)
                        token += 1
                        # the retries bound one token's failures, not
                        # the stream's: the next token gets all of them
                        attempt = 0
                        yield item
                    break
            except PageWireError:
                attempt += 1
                if attempt > retries:
                    raise
                time.sleep(backoff_s * attempt)
            except urllib.error.HTTPError as e:
                if e.headers.get("X-Task-Error"):
                    try:
                        msg = json.loads(e.read().decode()).get(
                            "error", "")
                    except (ValueError, OSError):
                        msg = str(e)
                    raise SourceTaskFailed(
                        f"upstream task {task_id} on {uri} FAILED: "
                        f"{msg}") from e
                if e.code == 410:
                    raise SourceTaskFailed(
                        f"spool partition {part} of task {task_id} on "
                        f"{uri} was already released (acked)") from e
                attempt += 1
                if attempt > retries:
                    raise SourceLost(uri, task_id, str(e)) from e
                time.sleep(backoff_s * attempt)
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                attempt += 1
                if attempt > retries:
                    raise SourceLost(uri, task_id, str(e)) from e
                time.sleep(backoff_s * attempt)


def local_source_pages(uri: str, task_id: str,
                       part: int) -> Optional[Iterator[Page]]:
    """Mesh-local exchange fast path: when `uri` names a task runtime
    in THIS process and the task has finished, an iterator over its
    spooled partition Pages — no HTTP, no serde for lazy entries, and
    device-resident Pages handed over as they are (one card, one
    default stream). None = not local (or not yet done): the caller
    falls back to the HTTP fetch, which also provides the long-poll.

    The released/done checks and the entry-list snapshot happen under
    the task lock, so a concurrent release never yields a silently
    empty stream; pages then materialize one at a time outside it."""
    from presto_tpu_torch.server.worker import local_runtime

    rt = local_runtime(uri)
    if rt is None:
        return None
    task = rt.get_task(task_id)
    if task is None:
        return None
    with task.lock:
        done, err = task.done, task.error
        spool = task.spool
        released = task.part_released(part)
        entries = (
            list(spool.parts[part].entries)
            if (done and not err and not released and spool is not None
                and part < len(spool.parts))
            else []
        )
    if err:
        raise SourceTaskFailed(
            f"upstream task {task_id} on {uri} FAILED: {err}")
    if released:
        raise SourceTaskFailed(
            f"spool partition {part} of task {task_id} on {uri} was "
            f"already released (acked)")
    if not done or spool is None:
        return None

    def gen() -> Iterator[Page]:
        from presto_tpu_torch.dist import serde

        for entry in entries:
            if entry[0] == "page":
                yield entry[1]
                continue
            store, i = entry
            try:
                blob = store.blob_at(i)
            except (OSError, IndexError) as e:
                raise SourceTaskFailed(
                    f"spool partition {part} of task {task_id} on {uri} "
                    f"was released during a local read") from e
            yield serde.deserialize_page(blob)

    return gen()


def iter_source_pages(spec: dict, *, retries: int = 3,
                      backoff_s: float = 0.1,
                      deadline: Optional[float] = None, on_local=None):
    """Worker-side exchange ingest: the pages of one RemoteSource edge
    — partition `spec['partition']` of every producer task, in payload
    order (deterministic, so a replayed consumer regenerates the same
    stream from the same spools). Same-process producers serve their
    spooled Pages directly (`on_local` fires once per such read).

    An adaptive BROADCAST READ of a repartitioned spool passes
    ``spec['partitions']``, an explicit list: every listed partition of
    every producer task is drained (their union is the producer's whole
    output, the rows a broadcast spool would have held)."""
    from presto_tpu_torch.dist import serde

    parts = [int(p) for p in (spec.get("partitions")
                              or (spec.get("partition", 0),))]
    for t in spec["tasks"]:
        for part in parts:
            pages = local_source_pages(t["uri"], t["taskId"], part)
            if pages is not None:
                if on_local is not None:
                    on_local()
                yield from pages
                continue
            yield from fetch_spool_blobs(
                t["uri"], t["taskId"], part, retries=retries,
                backoff_s=backoff_s, deadline=deadline,
                decode=serde.deserialize_page)


def ack_spool(uri: str, task_id: str, part: int,
              timeout: float = 5.0) -> bool:
    """Release one consumed spool partition on the producer. Best-
    effort: a dead producer has nothing left to free."""
    from presto_tpu_torch.dist import connpool as CONNPOOL

    try:
        with CONNPOOL.request(
            f"{uri}/v1/task/{task_id}/spool/{part}", method="DELETE",
            timeout=timeout,
        ) as r:
            r.read()
        return True
    except (urllib.error.URLError, OSError, TimeoutError):
        return False
