"""Drive presto_tpu_torch on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py                 # every phase (needs one card)
    python3 chip_smoke.py --phases build,kernels   # a quick kernel check
    python3 chip_smoke.py --phases build,kernels,profile   # kernel times

Phases:
  build    compile the CUDA kernels from presto_tpu_torch/csrc (first use)
  kernels  each kernel against its plain PyTorch version on the card, at
           the shapes the main path gives it (exact), with its device time
           per launch (ms: 60 back-to-back launches between two CUDA
           events, inputs rotated over more than twice the 50 MB L2, the
           stream held by a sleep kernel while the host enqueues them),
           the time of one wrapper call (call_ms: host plus device), the
           bound the card's memory rate sets, and a library yardstick
           timed the same way as the kernel; then the float group sums a
           replayed task repeats bit for bit (segment_sum_ordered and the
           sorted grouping's spans) timed beside index_add_ at 2^20 rows
  check    all 22 TPC-H queries at SF 0.01 and the 16 TPC-DS queries at
           SF 0.01 (Q64 again at SF 0.025) on the card == the same
           queries on the CPU == a sqlite3 oracle loaded from the port's
           own pages (generated join off: the joins hold the probe
           kernels); the card launches exactly the kernels whose twins
           the CPU run dispatches
  fused    the reference's default path (generated joins, the windowed
           form on TPC-DS's fact-to-fact joins, fused per-split programs
           as CUDA graphs, split batching): the same queries under the
           default session on the card == the CPU with fusion forced ==
           sqlite, with the fusion counters and kernel sets equal; the
           distributed path under the default session == the single
           process; every captured program replayed == its op-by-op run
           on the card
  scale    the main path at size, through LocalRunner: Q1 and Q6 at SF
           10, Q3, Q5 and Q17 at SF 1 under the default session, with the
           three fusion switches off, and op by op (SCALE_MODES; Q3, Q5
           and Q17 op by op again with late materialization off), and the
           15 other TPC-H queries and TPC-DS Q17 and Q64 at SF 1 under
           the same three sessions: per-query wall time, first-run
           graph captures, peak memory, program launches and kernel
           launch counts (through graph replays); rows equal across
           sessions; every kernel the same query's CPU run dispatched
           must launch, unless this size puts that dispatch point beyond
           the kernel's range (DispatchPoints); then the BASELINE
           ladder's memory-governed rungs at their stated scale, Q3 and
           Q5 at SF 10 under default and eager, Q1 at SF 100 under
           default; Q1
           and Q6 at SF 10 must match the reference's row checksums
           (val_q1_sf10.json, val_q6_sf10.json)
  dist     the distributed path: 4 in-process WorkerServers on the card
           and a DcnRunner (the stage DAG forced, partitioned joins,
           every exchange partitioned on the card through K4). Q3 and Q5 at SF 0.01 ==
           the card's LocalRunner == sqlite; then Q1 at SF 10, Q3 and Q5
           at SF 1 (page_rows 2^20): one warm-up and TIMED_RUNS timed
           runs each, rows == the single-process rows, and == again
           with K4 off;
           the peak with spools kept to the query's end beside the one
           with task_retry_attempts=0's eager acks. Then the replay
           part at SF 1: a worker stopped after the first stage and one
           after a non-leaf stage ([source-lost] replays) on Q3 and Q5,
           each restarted on its uri and back in the next query's pool;
           a worker lost while the root drains a double-column task it
           hosts, after the first fetch (the replayed pages hash equal
           to the consumed prefix); submit and fetch drops on Q5; a
           straggler raced by speculation on Q3 (under its delay);
           adaptive re-planning against the static plan on Q3 and Q5
           over a catalog that misstates its build tables (== the single
           process == sqlite, at least one distribution flip); every
           run's wall, fault-free and faulted, its counters and the
           host's accept-queue drops (TcpExt ListenOverflows and
           ListenDrops); each dist rung logs its adaptive counters.
           Then the legacy part on the default session (stage_scheduler
           auto): the aggregation cut of Q1 and Q6 at SF 10 (== the
           reference's checksums), Q3 and Q5 at SF 1 with the generated
           join off fanned out round-robin and by key hash, a top-N over
           orders joined to lineitem through the union cut (== sqlite),
           each
           beside the forced DAG and == the single process, K1-K3
           counted; Q3 with a worker killed after its first results
           fetch, recovered by re-running its split share
  surface  the relational surface at size, under default and eager (one
           warm-up, median of TIMED_RUNS): the ten window shapes over
           orders SF 1 (== sqlite), count(DISTINCT) beside plain aggregates
           (MarkDistinct, SF 1, == sqlite), ROLLUP over lineitem SF 10
           under default (== the plain GROUP BY rolled up on the host,
           also under default; at SF 1 through
           the stage DAG == the single process, and a rollup over
           integer keys whose exchange repartitions through K4),
           approx_distinct over lineitem SF 10 (within 4 standard errors
           of 15,000,000), array_agg/approx_percentile/map_agg by
           o_custkey at SF 1 with 64 slots a group (== sqlite, elements
           sorted) and CROSS JOIN UNNEST of those arrays (== orders' own
           pairs); walls, peaks, kernel launches and governor counters
           beside the card's name and power limit.
           The check and fused phases also run the relational surface at
           SF 0.01 (presto_tpu_torch/queries.py WINDOW_SQL, SURFACE_SQL)
           and the extended function families (FUNCTIONS_SQL, card == CPU)
  statements  the SQL surface's statements at size: CREATE TABLE AS
           copies of TPC-H SF 1 in the memory connector, timed; BASELINE
           config 1, Q1 over the memory copy of lineitem (==
           val_q1_sf1.json), and Q6, Q3, Q5 over the copies (== the same
           queries over tpch) under default and eager, with the kernels
           each launches (K1 on Q1 and Q6, hash probes on Q3 and Q5); DELETE,
           UPDATE, INSERT, DROP TABLE and SHOW TABLES, each held to its
           predicate over tpch (Q1 again after the DELETE); a view, a
           prepared statement and EXPLAIN; FUNCTIONS_SQL over tpch SF 1,
           card == CPU port
  governed Q3 and Q5 at SF 10, Q18 and TPC-DS Q64 at SF 1 on the eager
           session: unbounded, then under a small device_memory_budget
           and with the spill variants that reach the host and the disk
           tiers (GOVERNED): rows equal the unbounded run's, with the
           governor's counters, peaks and kernel launches
  oom      the device-OOM ladder: an injected fault (one retry, equal
           rows), then the card's own torch.cuda.OutOfMemoryError under a
           lowered per-process memory fraction, absorbed by a retry at a
           halved budget with equal rows
  serve    the coordinator's /v1/statement protocol through
           StatementClient, the lock sanitizer armed: a serial server
           (Q1, Q6, Q3, Q5 at SF 10; Q3, Q5 at SF 1 with the generated
           join off, which reach K2 and K3) == a direct LocalRunner, Q1
           and Q6 == the reference's checksums, client walls beside
           direct walls; ~194,000 rows of paged delivery; a concurrent
           server (memory arbiter, two resource groups): 8 clients x 3
           rounds of one-split statements with cross-query batching off
           and on (rows equal, shared launches, histogram p50/p95, graph
           captures), Q1 and Q5 at SF 10 from 4 clients at once (peak
           memory against the arbiter's estimates) and again beside an
           injected device OOM (the programs its ladder drops); a server
           over the DistCluster's 4 workers running Q3 at SF 1
           partitioned (K4); (e) a server with a checkpoint journal:
           Q3 at SF 1 parked before its root drain and the server
           replaced (the stream resumes, one re-attach, no task
           relaunched), again with a dead root-input spool (only .ra
           tasks), and a paged orders stream cut after its first page
           (resumed at its token, no row missing or repeated)
  mesh     the in-process mesh (dist/executor.py), 4 shards on the one
           card: (a) LocalRunner(mesh=make_mesh(4)) on Q1 and Q6 at SF 10
           (== val_q1_sf10.json / val_q6_sf10.json) and Q3 and Q5 at SF 1
           (== sqlite, in a child process), each at the default
           thresholds and with every join and group-by forced through
           the all_to_all, each == the single-process runner, walls
           beside it, peaks, K1 launches, boost retries; one profiled
           forced Q1 SF 10; (b) a 6M-row memory table (CTAS on the
           card) whose hot key owns half the rows: the grouped
           aggregation, the repartitioned join the boost ladder absorbs
           and the broadcast escape, == single process, with the
           per-shard row counts; (c) the ICI plane: Q3 and Q5 at SF 1
           through the stage DAG over the 4 workers under
           mesh_exchange_mode auto and false (equal rows; auto lowers
           its exchanges with K4 and no fallback), and Q3 on the mesh
           runner with hash_partition_count=2
  reuse    the result cache, the system catalog and plugins: Q1 and Q6
           at SF 10 and Q5 at SF 1 with result_cache_enabled (a miss, a
           statement hit, a fragment hit: no program, no kernel, no
           byte on a hit; == the uncached run, val_q*_sf10.json,
           sqlite), invalidation through INSERT into a memory copy of
           orders SF 1 (K2/K3 on the join's misses), the warm-start
           tier, Q3 SF 1 over the 4 workers with the cache on (the
           forced DAG with K4, then the legacy cut served by the
           workers' caches through the fleet probe), Q6 SF 10 from 8
           clients of a concurrent server (one execution, the rest
           admitted as hits; system.runtime_queries, SHOW TABLES FROM
           system, a plugin's access control denying a statement), and
           Q1 SF 10 on make_mesh(4) (a root hit with no crossing)
  stream   the streaming plane: an append log of lineitem SF 10's Q1
           columns (CREATE TABLE AS of 90%, then ten 1% INSERTs); TPC-H
           Q1 as a maintained view refreshed after each append (the
           delta rows, delta pages, K1 launches and ledger bytes of each
           fold) beside a cold recompute at the same offset (rows
           equal; the last == val_q1_sf10.json), one refresh with
           ivm_enabled=false; a server with two tailing cursors (the
           Q1 view, a per-row filter) while three appends land, the
           lock sanitizer armed
  chaos    tools/chaos_torch.py on the card as OS processes: this
           process (the single-process oracle, the DcnRunner), 2 worker
           processes and, for kill-coordinator, 2 coordinator processes
           in turn, every one on the card and the lock sanitizer armed
           in all. (a) 8 seeded iterations over TPC-H Q3, Q5 and the
           DAG query at SF 1 with the stage DAG forced, visiting the
           delay, drop, kill, submit-drop, kill-nonleaf and corrupt
           faults (killed workers reboot on their ports); (b) one
           kill-coordinator iteration, the successor re-attaching from
           the journal. Every row == the oracle's, nonleaf_replays >= 1
           in (a), coordinator_reattaches >= 1 in (b), 0 sanitizer
           violations in every process, K4 launched in the workers (their
           /v1/info launch counts) and K1 here; the card's free memory
           before and after
  profile  (only when asked for) the base scale rungs under each session
           and the dist queries once more under torch.profiler: device
           busy share, device kernels, graph replays, device time by
           kernel, and each of the port's kernels' device time per launch

Prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero without that line. Imports nothing but
presto_tpu_torch, tools/chaos_torch.py, torch, numpy and the standard
library.
"""

from __future__ import annotations

import argparse
import collections
import datetime
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import zlib

import torch

# H100 SXM device-memory rate (NVIDIA data sheet), for the bound_ms column
HBM_BYTES_PER_S = 3.35e12

ALL_PHASES = ("build", "kernels", "check", "fused", "scale", "dist",
              "surface", "statements", "governed", "oom", "analyze",
              "serve", "mesh", "reuse", "stream", "chaos")

# timed runs of each rung of every phase, after one warm-up: three ran
# the whole script in 1,067.8-1,323.3 s of its 1,200 s on an H100, the
# hosts a run lands on differing by up to 1.6x (PERF.md section 4)
TIMED_RUNS = 1

# kernel timing: back-to-back launches per event pair, event pairs per
# reading, and the bytes of rotated inputs (twice the H100's 50 MB L2)
DEVICE_REPS = 60
DEVICE_ROUNDS = 3
ROTATE_BYTES = 100 * 10**6


# where the disk spill tier writes (git-ignored; emptied as each query
# ends)
SPILL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_spill")


def log(msg: str) -> None:
    print(msg, flush=True)


def memory_peaks(dev) -> tuple:
    """(max allocated, max reserved) bytes since the last reset."""
    return (torch.cuda.max_memory_allocated(dev),
            torch.cuda.max_memory_reserved(dev))


def fresh_memory(dev) -> None:
    """Drop the program cache's graphs and the allocator's free blocks,
    and restart the peak counters: a reading then holds its own memory
    only."""
    from presto_tpu_torch.exec import graphs

    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def rows_checksum(rows) -> int:
    """Order-insensitive digest of result rows: the sum of each row's
    crc32 over its repr, mod 2^32 (the digest of the reference's
    val_q*_sf10.json files, written by tools/validate_rung.py)."""
    csum = 0
    for row in rows:
        csum = (csum + zlib.crc32(repr(row).encode())) & 0xFFFFFFFF
    return csum


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of ONE call, by CUDA events around it: the host's
    wrapper (checks, allocation, the ctypes launch) plus the device's
    work. On a host-bound path this is what a call costs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rotated(*tensors: torch.Tensor) -> list:
    """Copies of one launch's input ``tensors``, enough that together
    they hold more than ROTATE_BYTES: launches that rotate over them
    read their inputs from device memory, not from L2."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = ROTATE_BYTES // nbytes + 1
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(copies - 1)]


def device_ms(launch, sets, reps: int = DEVICE_REPS,
              rounds: int = DEVICE_ROUNDS) -> float:
    """Device time per launch: ``launch(s)`` REPS times back to back over
    the rotated input ``sets`` between two CUDA events, divided by REPS;
    the median of ROUNDS such runs. A sleep kernel holds the stream while
    the host enqueues the launches, so the card runs them without waiting
    for the host between two launches."""
    for s in sets:  # warm-up, and every set touched once
        launch(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(reps):
        launch(sets[r % len(sets)])
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # hold the stream for twice the measured enqueue time (clock64
        # cycles at up to 2 GHz)
        torch.cuda._sleep(int(2 * enqueue_s * 2e9) + 1_000_000)
        start.record()
        for r in range(reps):
            launch(sets[r % len(sets)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over int tensors, exact (wrapping-safe: compares
    bit patterns first)."""
    if torch.equal(a, b):
        return 0
    diff = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
    return int(diff.item()) or 1


# ------------------------------------------------------------------ kernels


def segsum_inputs(gen: torch.Generator, dev, groups: int, live: int,
                  n: int = 1 << 20):
    """K1's inputs at the main path's shape: int64 group ids over ``live``
    groups of a capacity-``groups`` state page, with one row in 20 given
    an id outside [0, G) (G or -1, rows that drop out), a row mask with a
    tenth of the rows invalid, int64 values."""
    ids = torch.randint(0, live, (n,), generator=gen, dtype=torch.int64)
    out = torch.rand(n, generator=gen) < 0.05
    ids[out] = torch.where(torch.rand(n, generator=gen) < 0.5, groups,
                           -1)[out]
    mask = torch.rand(n, generator=gen) >= 0.1
    vals = torch.randint(-(1 << 40), 1 << 40, (n,), generator=gen,
                         dtype=torch.int64)
    return ids.to(dev), mask.to(dev), vals.to(dev)


def segsum_err(ids, vals, mask, groups: int, counts: bool = True) -> int:
    """Largest difference of the kernel's (sums, counts) from the twin's
    on the same inputs."""
    from presto_tpu_torch.ops import cuda_agg as CA

    got = CA.segsum_cuda(ids, vals, mask, groups, counts)
    want = CA.segsum_plain(ids, vals, mask, groups, counts)
    return max(max_abs_err(g, w) for g, w in zip(got, want)
               if w is not None)


def check_segsum(gen: torch.Generator, dev) -> dict:
    from presto_tpu_torch.ops import cuda_agg as CA

    n = 1 << 20
    results = {}
    # Q6's shape: one group (every row on one address); Q1's: 6 flag
    # groups in a capacity-8 state page; Q5's: 25 nations in a page of 32;
    # and the largest capacity the kernel takes (the shared tier)
    for groups, live in ((1, 1), (8, 6), (32, 25), (4096, 4096)):
        ids, mask, vals = segsum_inputs(gen, dev, groups, live, n)
        # ids sorted, as the sorted grouping path delivers them; int32
        # ids; no mask; rows one off 16-byte alignment (the scalar loads)
        cases = {"random": (ids, vals, mask, True),
                 "sum only": (ids, vals, mask, False),
                 "count only": (ids, None, mask, True),
                 "sorted": (torch.sort(ids).values, vals, mask, True),
                 "int32 ids": (ids.to(torch.int32), vals, mask, True),
                 "no mask": (ids, vals, None, True),
                 "unaligned": (ids[1:], vals[1:], mask[1:], True)}
        if groups == 1:
            cases["no ids"] = (None, vals, mask, True)
        # wrap-around: every row near +2^62, all in group 0
        cases["wrap"] = (torch.zeros_like(ids),
                         torch.full_like(vals, (1 << 62) + 12345), None,
                         True)
        for label, (i, v, m, c) in cases.items():
            err = segsum_err(i, v, m, groups, c)
            if err:
                raise AssertionError(f"K1 G={groups} {label}: kernel != "
                                     f"plain (max err {err})")
        ms = device_ms(lambda s: CA.segsum_cuda(s[0], s[1], s[2], groups),
                       rotated(ids, vals, mask))
        sum_ms = device_ms(
            lambda s: CA.segsum_cuda(s[0], s[1], s[2], groups, False),
            rotated(ids, vals, mask))
        cms = call_ms(lambda: CA.segsum_cuda(ids, vals, mask, groups))
        plain_ms = call_ms(lambda: CA.segsum_plain(ids, vals, mask, groups))
        # the library call: index_add_ of the values over ids with the
        # mask and the range already folded in (the sums alone)
        idx64 = torch.where(mask & (ids >= 0) & (ids < groups), ids, groups)
        out = torch.zeros(groups + 1, dtype=torch.int64, device=dev)
        lib_ms = device_ms(lambda s: out.index_add_(0, s[0], s[1]),
                           rotated(idx64, vals))
        # each input byte read once (8 B id, 1 B mask, 8 B value), each
        # output written once (a sum and a count per group)
        bound = bytes_ms(n * (8 + 1 + 8) + groups * 16)
        log(f"K1 segsum n={n} G={groups}: kernel {ms:.4f} ms (sums alone "
            f"{sum_ms:.4f} ms; call {cms:.4f} ms), plain {plain_ms:.4f} "
            f"ms, index_add_ {lib_ms:.4f} ms, bound {bound:.4f} ms (exact "
            f"in {len(cases)} cases)")
        results[groups] = dict(ms=ms, call_ms=cms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=bound,
                               max_abs_err=0)
    return results


def check_float_sums(gen: torch.Generator, dev) -> dict:
    """The card's float group sums (ops/agg), which a replayed task must
    repeat bit for bit, at the main path's shape (2^20 double rows, a
    tenth invalid, G of 1, 32 and 4,096 groups): index_add_ (atomics in
    any order, the route before replay), segment_sum_ordered (the route
    of dense and hash groupings: a stable sort of the ids, a count, a
    gather, torch.segment_reduce) and the sorted grouping's span
    reduction (_sorted_aggregate: rows already in group order, one
    gather and torch.segment_reduce). Device ms per call as for the
    kernels. Both ordered routes must repeat bit for bit and equal
    index_add_ to 1e-9 relative."""
    from presto_tpu_torch.ops import agg

    n = 1 << 20
    results = {}
    for groups in (1, 32, 4096):
        ids = torch.randint(0, groups, (n,), generator=gen).to(dev)
        valid = (torch.rand(n, generator=gen) >= 0.1).to(dev)
        data = (torch.randn(n, generator=gen, dtype=torch.float64)
                * 1e4).to(dev)
        sets = [(torch.where(v, i, groups), d,
                 agg.compute_groups_sorted([i], [None], v, groups))
                for i, v, d in rotated(ids, valid, data)]

        def lib(s):
            return torch.zeros(groups + 1, dtype=torch.float64,
                               device=dev).index_add_(0, s[0], s[1])

        def ordered(s):
            return agg.segment_sum_ordered(s[1], s[0], groups + 1)

        def spans(s):
            return agg._sorted_aggregate(s[2], agg.SUM, groups, s[1],
                                         None)[0]

        want = lib(sets[0])[:groups]
        for label, fn in (("ordered", ordered), ("spans", spans)):
            got, again = fn(sets[0])[:groups], fn(sets[0])[:groups]
            if not torch.equal(got.view(torch.int64),
                               again.view(torch.int64)) \
                    or not torch.allclose(got, want, rtol=1e-9, atol=1e-6):
                raise AssertionError(f"float sums G={groups} {label}: "
                                     f"not ordered or != index_add_")
        ms = {label: device_ms(fn, sets) for label, fn in
              (("index_add_", lib), ("segment_sum_ordered", ordered),
               ("sorted spans", spans))}
        log(f"float sums n={n} G={groups} (double): device ms "
            f"{ {k: round(v, 4) for k, v in ms.items()} }; both ordered "
            f"routes repeat bit for bit, == index_add_ to 1e-9")
        results[groups] = ms
    return results


def check_probe(gen: torch.Generator, dev, build_rows: int,
                n_probe: int = 1 << 20) -> dict:
    from presto_tpu_torch.ops import cuda_join as CJ
    from presto_tpu_torch.ops import hashing as H
    from presto_tpu_torch.ops import u64

    layout = CJ.plan_layout(build_rows)
    keys = torch.randint(0, 4 * build_rows, (build_rows,), generator=gen,
                         dtype=torch.int64).to(dev)
    bvalid = torch.rand(build_rows, generator=gen).to(dev) < 0.9
    bhash = H.xxhash64_u64(keys)
    tables, perm, ovf = CJ.build_index(bhash, bvalid, layout)
    if bool(ovf):
        raise AssertionError(f"probe build {layout} overflowed")
    packed = CJ.pack_tables(tables)
    pkeys = torch.randint(0, 4 * build_rows, (n_probe,), generator=gen,
                          dtype=torch.int64).to(dev)
    phash = H.xxhash64_u64(pkeys)
    # the page as it comes, and one row off 16-byte alignment with a
    # ragged tail (the kernel's scalar loads and stores)
    for label, ph in (("aligned", phash), ("unaligned", phash[1:-2])):
        got = CJ.probe_cuda(ph, packed, layout)
        want = CJ.probe_plain(ph, packed, layout)
        err = max(max_abs_err(got[0], want[0]),
                  max_abs_err(got[1], want[1]))
        if err:
            raise AssertionError(f"probe {layout} {label}: kernel != plain")
    got = CJ.probe_cuda(phash, packed, layout)
    hits = int((got[1] > 0).sum())
    # the sort join's range finder on the same build, as the yardstick
    sorted_h = u64.order(torch.where(bvalid, bhash, u64.POISON)[perm])
    # the table is built once per join and probed page after page: only
    # the probe hashes rotate
    sets = rotated(phash)
    ms = device_ms(lambda s: CJ.probe_cuda(s[0], packed, layout), sets)
    cms = call_ms(lambda: CJ.probe_cuda(phash, packed, layout))
    plain_ms = call_ms(lambda: CJ.probe_plain(phash, packed, layout),
                       reps=5)
    lib_ms = device_ms(
        lambda s: (torch.searchsorted(sorted_h, s[0], side="left"),
                   torch.searchsorted(sorted_h, s[0], side="right")),
        [(u64.order(s[0]),) for s in sets])
    # distinct table slots this run's probes read, 8 B keys on every
    # step and 8 B payloads on hits: the data-dependent table traffic of
    # the bound
    visited: dict = {}
    CJ.probe_plain(phash, packed, layout, visited=visited)
    touched = {part: int(torch.unique(torch.cat(idx)).numel())
               for part, idx in visited.items()}
    bound = bytes_ms(n_probe * (8 + 4 + 4) + touched["keys"] * 8
                     + touched["payload"] * 8)
    log(f"probe {layout} build={build_rows} n={n_probe}: hits {hits}, "
        f"kernel {ms:.4f} ms (call {cms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"searchsorted x2 {lib_ms:.4f} ms, bound {bound:.4f} ms "
        f"({touched['keys']} key and {touched['payload']} payload slots "
        f"read; exact)")
    return dict(ms=ms, call_ms=cms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, max_abs_err=0)


def check_part_ids(gen: torch.Generator, dev) -> dict:
    """K4 against its twin at the exchange's shapes: one 2^20-row page,
    C key columns, 4 partitions (the dist phase's worker count)."""
    from presto_tpu_torch.ops import cuda_part as CP

    n, nparts = 1 << 20, 4
    results = {}
    for cols in (1, 2, 3):
        enc = torch.randint(-(1 << 62), 1 << 62, (cols, n), generator=gen,
                            dtype=torch.int64).to(dev)
        err = max_abs_err(CP.part_ids_cuda(enc, nparts),
                          CP.part_ids_plain(enc, nparts))
        if err:
            raise AssertionError(f"K4 C={cols}: kernel != plain "
                                 f"(max err {err})")
        ms = device_ms(lambda s: CP.part_ids_cuda(s[0], nparts),
                       rotated(enc))
        cms = call_ms(lambda: CP.part_ids_cuda(enc, nparts))
        plain_ms = call_ms(lambda: CP.part_ids_plain(enc, nparts))
        bound = bytes_ms(cols * n * 8 + n * 4)
        log(f"K4 part_ids n={n} C={cols} nparts={nparts}: kernel "
            f"{ms:.4f} ms (call {cms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms (exact; no single PyTorch call computes "
            f"this function)")
        results[cols] = dict(ms=ms, call_ms=cms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound, max_abs_err=0)
    return results


# ----------------------------------------------------- the sqlite oracle

def _days(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


TPCH_ALL = tuple(range(1, 23))
# the TPC-DS queries of the test suite (presto_tpu_torch/queries.py);
# Q64's chain is longer at SF 0.025, where check and fused run it again
TPCDS_ALL = (3, 7, 17, 19, 25, 26, 29, 37, 42, 52, 55, 62, 64, 82, 93, 96)
Q64_SF = 0.025


def sql(suite: str, q: int) -> str:
    """The engine SQL of one query (presto_tpu_torch/queries.py: the test
    suite's query texts, with its tiebreakers)."""
    from presto_tpu_torch import queries as PQ

    return (PQ.TPCH_SQL if suite == "tpch" else PQ.TPCDS_SQL)[q]


def make_conn(suite: str, sf: float, dev):
    if suite == "tpch":
        from presto_tpu_torch.connectors.tpch import TpchConnector

        return TpchConnector(sf, device=dev)
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector

    return TpcdsConnector(sf, device=dev)


def make_runner(suite: str, conn, dev, session: dict):
    from presto_tpu_torch.runner import LocalRunner

    return LocalRunner({suite: conn}, suite, session=session, device=dev)


def tables_read(suite: str, conn, queries) -> list:
    """The tables any of ``queries`` names: the oracle loads only those."""
    text = " ".join(sql(suite, q) for q in queries)
    return [t for t in conn.tables() if re.search(rf"\b{t}\b", text)]


def check_oracle(suite: str, q: int, rows, db) -> None:
    """The test suite's comparison of engine rows with sqlite's."""
    from presto_tpu_torch import queries as PQ

    if suite == "tpch":
        oracle_sql, modes = PQ.TPCH_ORACLE[q]
        PQ.compare_tpch(q, rows, db.execute(oracle_sql).fetchall(), modes)
        return
    oracle_sql, float_cols, round_cols = PQ.TPCDS_ORACLE[q]
    want = db.execute(oracle_sql).fetchall()
    if not want:
        raise AssertionError(f"TPC-DS Q{q}: the oracle returned no rows")
    PQ.compare_tpcds(q, rows, want, float_cols, round_cols)


def same_rows(got, want) -> bool:
    """Rows equal: doubles to 9 significant digits (two devices, or two
    sessions, may sum in another order), everything else exactly."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                if not math.isclose(a, b, rel_tol=1e-9):
                    return False
            elif a != b or type(a) is not type(b):
                return False
    return True


def kernel_set(counts: dict) -> list:
    return sorted(k for k, v in counts.items() if v)


def run_pair(suite, q, gpu, cpu, label, text=None):
    """One query (``text``, else the suite's query ``q``) on the card and
    on the CPU: (card rows, CPU rows, the kernels launched). The sets of
    kernels must be equal: the same data, the same dispatch
    decisions."""
    from presto_tpu_torch import cuda

    text = text or sql(suite, q)
    cuda.reset_counts()
    got = gpu.execute(text).rows
    launched = kernel_set(cuda.launches)
    cuda.reset_counts()
    want = cpu.execute(text).rows
    dispatched = kernel_set(cuda.plain_calls)
    if launched != dispatched:
        raise AssertionError(f"{label}: the card launched {launched}, the "
                             f"CPU dispatched the twins of {dispatched}")
    return got, want, launched


def same_bag(got, want) -> bool:
    """Rows equal as multisets (same_rows after a sort that rounds
    doubles, so two summation orders sort alike)."""
    def key(row):
        return repr(tuple(round(v, 6) if isinstance(v, float) else v
                          for v in row))
    return same_rows(sorted(got, key=key),
                     sorted((tuple(r) for r in want), key=key))


def run_slice(gpu, cpu, db, label, counters: bool = False) -> dict:
    """The relational surface at SF 0.01 (presto_tpu_torch/queries.py:
    the window cases, SURFACE_SQL, then FUNCTIONS_SQL, the extended
    function families): card rows == CPU rows (in order
    for the window cases, which order their rows; as multisets for the
    rest) == sqlite where sqlite can express the query, with equal
    kernel sets and, with ``counters``, equal fusion counters. Returns
    the kernels launched per query."""
    from presto_tpu_torch import queries as PQ

    cases = [(f"window {i}", q, True, True)
             for i, q in enumerate(PQ.WINDOW_SQL)]
    cases += [(name, q, oracle, False)
              for name, (q, oracle) in PQ.SURFACE_SQL.items()]
    cases += [(f"functions {name}", q, None, False)
              for name, q in PQ.FUNCTIONS_SQL.items()]
    kernels = {}
    for name, text, oracle, ordered in cases:
        tag = f"{label} {name}"
        gen0 = (gpu.executor.generated_joins_used,
                cpu.executor.generated_joins_used)
        got, want, launched = run_pair("tpch", None, gpu, cpu, tag,
                                       text=text)
        equal = same_rows(got, want) if ordered else same_bag(got, want)
        if counters:
            ctr = (fusion_counters(gpu.executor, gen0[0]),
                   fusion_counters(cpu.executor, gen0[1]))
            equal = equal and ctr[0] == ctr[1]
        if not equal:
            raise AssertionError(f"{tag}: card != CPU\n card {got[:3]}\n"
                                 f" cpu  {want[:3]}")
        if oracle is not None:
            rows = db.execute(text if oracle is True else oracle).fetchall()
            same = (same_rows(got, [tuple(r) for r in rows]) if ordered
                    else same_bag(got, rows))
            if not same:
                raise AssertionError(f"{tag}: card != sqlite\n card "
                                     f"{got[:3]}\n sqlite {rows[:3]}")
        if not got:
            raise AssertionError(f"{tag}: no rows")
        kernels[name] = launched
        log(f"{tag}: {len(got)} rows, card == CPU"
            f"{' == sqlite' if oracle is not None else ''}; kernels "
            f"{launched} on both")
    return kernels


def phase_check(dev) -> dict:
    """Every TPC-H query at SF 0.01 and every TPC-DS query at SF 0.01 (Q64
    again at SF 0.025) with the generated join off: card rows == CPU rows
    == sqlite, and the card launches the kernels whose twins the CPU
    dispatches. Returns those kernels per (suite, query, sf, "check")."""
    from presto_tpu_torch import queries as PQ

    session = {"page_rows": 1 << 15, "generated_join_enabled": "false"}
    runs = [("tpch", 0.01, TPCH_ALL), ("tpcds", 0.01, TPCDS_ALL),
            ("tpcds", Q64_SF, (64,))]
    dispatched = {}
    for suite, sf, qs in runs:
        cpu_conn = make_conn(suite, sf, "cpu")
        gpu = make_runner(suite, make_conn(suite, sf, dev), dev, session)
        cpu = make_runner(suite, cpu_conn, "cpu", session)
        t0 = time.perf_counter()
        db = PQ.load_sqlite(cpu_conn, tables_read(suite, cpu_conn, qs))
        log(f"check: {suite} sqlite oracle loaded at SF {sf} in "
            f"{time.perf_counter() - t0:.1f} s")
        for q in qs:
            label = f"check: {suite} Q{q} SF {sf}"
            t0 = time.perf_counter()
            got, want, kernels = run_pair(suite, q, gpu, cpu, label)
            if not same_rows(got, want):
                raise AssertionError(f"{label}: card rows != CPU rows\n "
                                     f"card {got[:3]}\n cpu  {want[:3]}")
            check_oracle(suite, q, got, db)
            dispatched[(suite, q, sf, "check")] = kernels
            log(f"{label}: {len(got)} rows, card == CPU == sqlite; kernels "
                f"{kernels} on both ({time.perf_counter() - t0:.1f} s)")
        if suite == "tpch":
            t0 = time.perf_counter()
            run_slice(gpu, cpu, db, f"check: SF {sf}")
            log(f"check: the relational surface in "
                f"{time.perf_counter() - t0:.1f} s")
    return dispatched


# ------------------------------------------------------ the fused path

# what each TPC-H query's default session must fuse at least: a partial-aggregation
# tail (Q1, Q6, Q17's outer sum) and generated joins (Q3, Q5, Q17)
FUSED_AGG = (1, 6, 17)
FUSED_JOINS = (3, 5, 17)


def program_shape(key) -> str:
    """A captured program's chain shape: per split or batched, and its
    tail (a page-emitting chain, or the partial-aggregation step)."""
    extra = key[2]
    return f"{key[0]}/{extra[0] if extra else 'page'}"


def check_programs() -> dict:
    """Every program captured on the card, replayed at its latest inputs,
    against the same function run op by op on the card on the same
    inputs: equal tensor for tensor (max_abs_err 0)."""
    from presto_tpu_torch.exec import graphs

    shapes: dict = {}
    for key, prog in graphs.cached():
        if prog.device.type != "cuda" or prog.last_call is None:
            continue
        starts, counts = prog.last_call
        got = graphs.leaves_of(prog(starts, counts))
        want = graphs.leaves_of(prog.eager(starts, counts))
        if len(got) != len(want):
            raise AssertionError(f"{program_shape(key)}: replay returned "
                                 f"{len(got)} tensors, op by op {len(want)}")
        err = max((max_abs_err(g, w) for g, w in zip(got, want)), default=0)
        sh = shapes.setdefault(program_shape(key), dict(
            programs=0, max_abs_err=0, capture_s=0.0, batch=set()))
        sh["programs"] += 1
        sh["max_abs_err"] = max(sh["max_abs_err"], err)
        sh["capture_s"] += prog.capture_s
        sh["batch"].add(prog.batch)
    for name, sh in shapes.items():
        sh["batch"] = sorted(sh["batch"])
        if sh["max_abs_err"] != 0:
            raise AssertionError(f"{name}: graph replay != op by op "
                                 f"(max_abs_err {sh['max_abs_err']})")
    return shapes


def fusion_counters(ex, gen_before: int) -> dict:
    return dict(program_launches=ex.program_launches,
                splits_scanned=ex.splits_scanned,
                fused_partial_aggs=ex.fused_partial_aggs,
                generated_joins=ex.generated_joins_used - gen_before)


def phase_fused(dev, cluster) -> dict:
    """The reference's default path on the card: generated joins (the
    windowed form on TPC-DS's fact-to-fact joins) and fused per-split
    programs replayed as CUDA graphs. At SF 0.01 (TPC-DS Q64 also at SF
    0.025) every query's card default session == the CPU with fusion
    forced == sqlite, with equal fusion counters and kernel sets; every
    captured chain shape replays equal to its op-by-op run; and the
    distributed path under the default session == the single process.
    Returns the kernels each query launched, per (suite, query, sf,
    "fused")."""
    from presto_tpu_torch import queries as PQ
    from presto_tpu_torch.exec import graphs

    page_rows = 1 << 13  # 13 lineitem splits at SF 0.01: a padded batch
    forced = {"page_rows": page_rows, "fused_partial_agg_enabled": "true",
              "split_batch_size": "64"}
    runs = [("tpch", 0.01, TPCH_ALL), ("tpcds", 0.01, TPCDS_ALL),
            ("tpcds", Q64_SF, (64,))]
    dispatched = {}
    for suite, sf, qs in runs:
        cpu_conn = make_conn(suite, sf, "cpu")
        gpu = make_runner(suite, make_conn(suite, sf, dev), dev,
                          {"page_rows": page_rows})
        cpu = make_runner(suite, cpu_conn, "cpu", forced)
        db = PQ.load_sqlite(cpu_conn, tables_read(suite, cpu_conn, qs))
        for q in qs:
            label = f"fused: {suite} Q{q} SF {sf}"
            gen0 = (gpu.executor.generated_joins_used,
                    cpu.executor.generated_joins_used)
            got, want, kernels = run_pair(suite, q, gpu, cpu, label)
            counters = fusion_counters(gpu.executor, gen0[0])
            cpu_counters = fusion_counters(cpu.executor, gen0[1])
            if not same_rows(got, want) or counters != cpu_counters:
                raise AssertionError(
                    f"{label}: card != CPU with fusion forced\n"
                    f" card {got[:3]} {counters}\n cpu  {want[:3]} "
                    f"{cpu_counters}")
            if suite == "tpch" and q in FUSED_AGG + FUSED_JOINS and (
                    counters["program_launches"] <= 0
                    or (q in FUSED_AGG and counters["fused_partial_aggs"] <= 0)
                    or (q in FUSED_JOINS and counters["generated_joins"] <= 0)):
                raise AssertionError(f"{label}: the default session did not "
                                     f"fuse: {counters}")
            check_oracle(suite, q, got, db)
            dispatched[(suite, q, sf, "fused")] = kernels
            log(f"{label}: {len(got)} rows, card == CPU (fusion forced) == "
                f"sqlite; {counters}; kernels {kernels} on both")
        if suite == "tpch":
            run_slice(gpu, cpu, db, f"fused: SF {sf}", counters=True)
    # the distributed path under the default session: 4 worker threads
    # capture and replay the leaf fragments' programs on one card
    sf = 0.01
    coord = cluster.coordinator(sf, page_rows, FUSED_DIST_SESSION)
    single = cluster.local(sf, page_rows, {})
    for q in (1, 3, 5):
        got, _, _ = _dist_run(coord, sql("tpch", q))
        want = single.execute(sql("tpch", q)).rows
        if got != want:
            raise AssertionError(f"fused dist Q{q}: rows != single process")
        log(f"fused: dist Q{q} SF {sf} x{N_WORKERS} workers, default "
            f"session: {len(got)} rows == single process")
    shapes = check_programs()
    log("fused: graph replay == op by op on the card, per chain shape: "
        + json.dumps(shapes) + f"; process totals {graphs.stats}")
    return dispatched


# -------------------------------------------------------------- the scale

# the main path's rungs (the BASELINE ladder's TPC-H queries and Q17),
# then the rest of the query surface at SF 1: the 15 other TPC-H
# queries and TPC-DS Q17 and Q64, each under every session of
# SCALE_MODES
BASE_SCALE = ((1, 10.0), (6, 10.0), (3, 1.0), (5, 1.0), (17, 1.0))
NEW_TPCH = (2, 4, 7, 8, 9, 11, 13, 14, 15, 16, 18, 19, 20, 21, 22)
NEW_TPCDS = (17, 64)
KERNEL_NAMES = ("segsum", "probe_dim", "probe_radix", "part_ids")
# a substring of each kernel's device symbol(s) in a profile
KERNEL_SYMBOLS = {"segsum": "segsum_", "probe_dim": "probe_dim_",
                  "probe_radix": "probe_radix_", "part_ids": "part_ids_"}
# the sessions each scale query runs under: the reference's defaults
# (generated join, fusion and split batching on the card: CUDA graphs);
# the three switches off, which leaves per-split graphs of the
# filter/project chains; and nothing fused, op by op (the path before
# graphs), whose materialized joins hold the probe kernels
SCALE_MODES = {
    "default": {},
    "three_off": {"generated_join_enabled": "false",
                  "fused_partial_agg_enabled": "false",
                  "split_batch_size": "false"},
    "eager": {"generated_join_enabled": "false",
              "tpu_offload_enabled": "false"},
    # eager with late materialization off (its "auto" is on on the card):
    # what deferring the carried build columns does to the join rungs
    "eager_lm_off": {"generated_join_enabled": "false",
                     "tpu_offload_enabled": "false",
                     "late_materialization_enabled": "false"},
}
EAGER_SESSION = SCALE_MODES["eager"]
# the base rungs with joins, which also run eager_lm_off
LATE_MAT_RUNGS = ((3, 1.0), (5, 1.0), (17, 1.0))
# the BASELINE ladder's memory-governed rungs at their stated scale
# (bench.py: q3_sf10, q5_sf10, q1_sf100), under default and eager
# (Q1 SF 100 under default only: its eager warm-up and run took 21.9 s
# on an H100 on a slow host, PERF.md section 4: the script's time limit)
STATED_SCALE = ((3, 10.0), (5, 10.0), (1, 100.0))
STATED_MODES = {(1, 100.0): ("default",)}
SCALE_RUNS = (tuple(("tpch", q, sf) for q, sf in BASE_SCALE)
              + tuple(("tpch", q, 1.0) for q in NEW_TPCH)
              + tuple(("tpcds", q, 1.0) for q in NEW_TPCDS)
              + tuple(("tpch", q, sf) for q, sf in STATED_SCALE))
# the reference's row checksums (rows, checksum_crc32); Q1 at SF 1 is
# BASELINE config 1, run over the memory copies (statements)
VALIDATED = {(1, 10.0): "val_q1_sf10.json", (6, 10.0): "val_q6_sf10.json",
             (1, 1.0): "val_q1_sf1.json"}


def scale_modes(suite: str, q: int, sf: float) -> tuple:
    if suite == "tpch" and (q, sf) in STATED_SCALE:
        return STATED_MODES.get((q, sf), ("default", "eager"))
    if suite == "tpch" and (q, sf) in LATE_MAT_RUNGS:
        return tuple(SCALE_MODES)
    return ("default", "three_off", "eager")


def check_validated(q: int, sf: float, rows) -> str:
    """Rows against the reference's checksum file of (q, sf), if any."""
    name = VALIDATED.get((q, sf))
    if name is None:
        return ""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           name)) as f:
        want = json.load(f)
    got = rows_checksum(rows)
    if len(rows) != want["rows"] or got != want["checksum_crc32"]:
        raise AssertionError(
            f"Q{q} SF {sf:g}: {len(rows)} rows, checksum {got}; "
            f"{name} has {want['rows']} rows, {want['checksum_crc32']}")
    return f", checksum {got} == {name}"
# kernels the base rungs' main paths must launch, per session
REQUIRED = {
    "default": {1: ("segsum",), 6: ("segsum",), 3: (), 5: (), 17: ()},
    "three_off": {1: ("segsum",), 6: ("segsum",), 3: ("probe_radix",),
                  5: ("probe_dim", "probe_radix"), 17: ()},
    "eager": {1: ("segsum",), 6: ("segsum",), 3: ("probe_radix",),
              5: ("probe_dim", "probe_radix"), 17: ()},
}
REQUIRED["eager_lm_off"] = REQUIRED["eager"]


# a kernel's dispatch point: K1, or the hash-join probe, whose layout
# (K2 up to 2,048 build slots, K3 up to 2^20) follows the build's size
FAMILY = {"segsum": "segsum", "probe_dim": "probe",
          "probe_radix": "probe"}


def required_families(cpu_dispatch: dict, suite: str, q: int, mode: str):
    """The dispatch points a new scale run must reach with a kernel: those
    whose twins the same query dispatched on the CPU at SF 0.01 in the
    check (eager: generated join off) or fused (default) phase. None
    when that phase did not run."""
    phase = "fused" if mode == "default" else "check"
    kernels = cpu_dispatch.get((suite, q, 0.01, phase))
    if kernels is None:
        return None
    return sorted({FAMILY[k] for k in kernels})


class DispatchPoints:
    """Observes, while a scale query runs, each K1 and probe dispatch
    point the executor reaches and whether the kernel's range admits it
    at this size: K1 takes at most cuda_agg.MAX_GROUPS group slots, the
    probe kernels builds of at most RADIX_MAX_BUILD slots and only on a
    query's first attempt (a capacity-boost retry takes the sort join,
    as the reference does). It changes no decision."""

    def __init__(self):
        self.seen = collections.Counter()

    def __enter__(self):
        from presto_tpu_torch.exec.executor import Executor
        from presto_tpu_torch.ops import cuda_agg as CA
        from presto_tpu_torch.ops import cuda_join as CJ

        seen = self.seen
        supported = CA.supported
        radix = Executor._radix_join_eligible
        unique = Executor._unique_kernel_eligible

        def k1(kind, num_groups, data):
            ok = supported(kind, num_groups, data)
            if ok:
                seen["segsum", "in range"] += 1
            elif supported(kind, 1, data):
                seen["segsum", f"{num_groups} group slots > "
                               f"{CA.MAX_GROUPS}"] += 1
            return ok

        def probe(ex, node, build):
            ok = radix(ex, node, build)
            if ok:
                seen["probe", "in range"] += 1
            elif ex.kernels and build.capacity > CJ.RADIX_MAX_BUILD:
                seen["probe", f"build of {build.capacity} slots > "
                              f"{CJ.RADIX_MAX_BUILD}"] += 1
            elif ex.kernels and ex._capacity_boost > 1:
                seen["probe", "a capacity-boost retry"] += 1
            return ok

        def probe_unique(ex, node, build, *args):
            ok = unique(ex, node, build, *args)
            if ok:
                seen["probe", "in range"] += 1
            return ok

        self._saved = [(CA, "supported", supported),
                       (Executor, "_radix_join_eligible", radix),
                       (Executor, "_unique_kernel_eligible", unique)]
        CA.supported = k1
        Executor._radix_join_eligible = probe
        Executor._unique_kernel_eligible = probe_unique
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    def missing(self, families, counts) -> list:
        """Required families with no launch: a family in range at some
        dispatch point must launch; one out of range at every dispatch
        point it reached is excused, and ``excused`` says why."""
        out = []
        for fam in families:
            launched = sum(v for k, v in counts.items()
                           if FAMILY.get(k) == fam)
            in_range = self.seen[fam, "in range"]
            declined = [why for (f, why) in self.seen
                        if f == fam and why != "in range"]
            if not launched and (in_range or not declined):
                out.append(fam)
        return out

    def excused(self, counts) -> dict:
        return {f: sorted(why for (ff, why) in self.seen
                          if ff == f and why != "in range")
                for f in ("segsum", "probe")
                if not sum(v for k, v in counts.items()
                           if FAMILY.get(k) == f)}


def filtered_lineitem_rows(conn, cutoff: int, page_rows: int) -> int:
    """Lineitem rows with l_shipdate <= cutoff, counted straight from the
    connector's pages (no engine operator involved)."""
    total = 0
    for page in conn.pages("lineitem", ["l_shipdate"],
                           target_rows=page_rows):
        ship = page.block(0).data
        total += int((page.valid & (ship <= cutoff)).sum())
    return total


def phase_scale(dev, cpu_dispatch: dict) -> dict:
    """Each scale query under each of its sessions: one warm-up (its
    graph captures timed apart), then TIMED_RUNS timed runs. Rows must be
    equal across a query's sessions, and each run must launch its
    required kernels (checked after every reading is logged)."""
    from presto_tpu_torch import cuda
    from presto_tpu_torch.exec import graphs

    page_rows = 1 << 20
    conns = {}
    launches_total = {k: 0 for k in KERNEL_NAMES}
    per_query = {}
    missing = []
    cuda.reset_counts()  # counts cover the main-path runs below only
    for suite, q, sf in SCALE_RUNS:
        if (suite, sf) not in conns:
            t0 = time.perf_counter()
            conns[(suite, sf)] = make_conn(suite, sf, dev)
            log(f"scale: {suite} SF {sf:g} connector built in "
                f"{time.perf_counter() - t0:.2f} s")
        name = f"{suite} Q{q} SF {sf:g}"
        for mode in scale_modes(suite, q, sf):
            runner = make_runner(suite, conns[(suite, sf)], dev,
                                 {"page_rows": page_rows,
                                  **SCALE_MODES[mode]})
            # each reading holds its own graphs' memory only
            fresh_memory(dev)
            before = dict(cuda.launches)
            cap0 = dict(graphs.stats)
            gen0 = runner.executor.generated_joins_used
            t0 = time.perf_counter()
            with DispatchPoints() as points:  # the timed runs repeat it
                res = runner.execute(sql(suite, q))  # warm-up
                torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            captures = graphs.stats["captures"] - cap0["captures"]
            capture_s = graphs.stats["capture_s"] - cap0["capture_s"]
            gen_first = runner.executor.generated_joins_used - gen0
            walls = []
            for _ in range(TIMED_RUNS):
                t0 = time.perf_counter()
                res = runner.execute(sql(suite, q))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            counts = {k: cuda.launches.get(k, 0) - before.get(k, 0)
                      for k in KERNEL_NAMES}
            ex = runner.executor
            fused = dict(program_launches=ex.program_launches,
                         splits_scanned=ex.splits_scanned,
                         splits_per_launch=(
                             ex.splits_scanned / ex.program_launches
                             if ex.program_launches else 0.0),
                         fused_partial_aggs=ex.fused_partial_aggs,
                         generated_joins=gen_first)
            peak, reserved = memory_peaks(dev)
            runs = 1 + TIMED_RUNS
            base = suite == "tpch" and (q, sf) in BASE_SCALE
            valid = check_validated(q, sf, res.rows) if suite == "tpch" \
                else ""
            required = (REQUIRED[mode][q] if base
                        else required_families(cpu_dispatch, suite, q,
                                               mode))
            log(f"scale: {name} {mode}: rows {len(res.rows)}{valid}, "
                f"wall s {[round(w, 4) for w in walls]} (median "
                f"{statistics.median(walls):.4f}), first run "
                f"{first_s:.3f} s with {captures} graph captures taking "
                f"{capture_s:.3f} s, peak alloc {peak / 2**30:.3f} GiB "
                f"(reserved {reserved / 2**30:.3f} GiB), per run {fused}, "
                f"kernel launches per run "
                f"{ {k: v // runs for k, v in counts.items()} }, required "
                f"{required}, out of range here {points.excused(counts)}, "
                f"boost retries {ex.capacity_boost_retries}, governor "
                f"{governor_counters(ex)}")
            if base:
                missing += [f"{name} {mode}: {k}" for k in required
                            if counts[k] <= 0]
            elif required is not None:
                missing += [f"{name} {mode}: {f}"
                            for f in points.missing(required, counts)]
            if (suite, q) == ("tpch", 1):
                cutoff = _days(1998, 12, 1) - 90
                want = filtered_lineitem_rows(conns[(suite, sf)], cutoff,
                                              page_rows)
                got = sum(r[-1] for r in res.rows)
                if got != want:
                    raise AssertionError(
                        f"Q1 {mode}: count_order {got} != connector rows "
                        f"{want}")
            rows = per_query.setdefault(name, {"sf": sf, "rows": res.rows})
            if not same_rows(res.rows, rows["rows"]):
                raise AssertionError(f"{name} {mode}: rows differ from "
                                     f"{next(iter(SCALE_MODES))}")
            if not res.rows:
                raise AssertionError(f"{name}: no rows")
            rows[mode] = dict(wall_s=walls, first_run_s=first_s,
                              captures=captures, capture_s=capture_s,
                              peak_bytes=peak, reserved_bytes=reserved,
                              launches=counts, **fused,
                              **governor_counters(ex))
            for k in KERNEL_NAMES:
                launches_total[k] += counts[k]
    for v in per_query.values():
        v["rows"] = len(v["rows"])
    log("scale: " + json.dumps({"per_query": per_query}))
    graphs.clear()
    torch.cuda.empty_cache()
    if missing:
        raise AssertionError("scale: required kernels never launched: "
                             + "; ".join(missing))
    return launches_total


def governor_counters(ex) -> dict:
    """The memory governor's and spill's counters of the last query."""
    return dict(spill_partitions_used=ex.spill_partitions_used,
                memory_chunked_pipelines=ex.memory_chunked_pipelines,
                host_spill_pages=ex.host_spill_pages,
                disk_spill_pages=ex.disk_spill_pages,
                skew_chunks_used=ex.skew_chunks_used,
                device_oom_retries=ex.device_oom_retries)


# ------------------------------------------------------- the statements

# BASELINE config 1 (BASELINE.md: TPC-H SF 1 Q1 on the memory connector)
# and its neighbours over the memory copies of TPC-H SF 1
STATEMENTS_SF = 1.0
STATEMENTS_QUERIES = (1, 6, 3, 5)
STATEMENTS_MODES = ("default", "eager")
STATEMENTS_PAGE_ROWS = 1 << 20
# the kernel families each memory rung must launch at SF 1: K1 on the
# dense grouping and the global sum; a hash probe on the joins (the
# CTAS copies keep TPC-H's declared keys, so K2's unique-key path takes
# the single-key joins of unique builds, K3 the others; which layout a
# probe takes depends on its build's size)
STATEMENTS_REQUIRED = {1: ("segsum",), 6: ("segsum",), 3: ("probe",),
                       5: ("probe",)}


def _memory_catalogs(sf: float, dev) -> dict:
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.connectors.tpch import TpchConnector

    return {"tpch": TpchConnector(sf, device=dev),
            "memory": MemoryConnector(device=dev)}


def _statements_runner(catalogs, dev, mode: str, catalog: str = "memory"):
    from presto_tpu_torch.runner import LocalRunner

    return LocalRunner(catalogs, catalog, session={
        "page_rows": STATEMENTS_PAGE_ROWS, **SCALE_MODES[mode]}, device=dev)


def _load_memory_copies(runner) -> dict:
    """CREATE TABLE AS memory.<t> of every statement table: seconds each
    (the query on the card, the host decode and the store)."""
    from presto_tpu_torch import queries as PQ

    walls = {}
    for t in PQ.STATEMENT_TABLES:
        t0 = time.perf_counter()
        n = runner.execute(PQ.STATEMENT_SQL["ctas"].format(t=t)).rows[0][0]
        walls[t] = (time.perf_counter() - t0, n)
        want = runner.execute(f"select count(*) from tpch.{t}").rows[0][0]
        if n != want:
            raise AssertionError(f"statements: CTAS {t}: {n} rows, tpch "
                                 f"has {want}")
    return walls


def _memory_dispatches() -> dict:
    """The kernel twins the same memory rungs dispatch on the CPU over
    memory copies of TPC-H SF 0.01: per (query, mode)."""
    from presto_tpu_torch import cuda

    cats = _memory_catalogs(0.01, "cpu")
    _load_memory_copies(_statements_runner(cats, "cpu", "eager"))
    out = {}
    for q in STATEMENTS_QUERIES:
        for mode in STATEMENTS_MODES:
            cuda.reset_counts()
            _statements_runner(cats, "cpu", mode).execute(sql("tpch", q))
            out[q, mode] = kernel_set(cuda.plain_calls)
    return out


def phase_statements(dev) -> dict:
    """The SQL surface's statements at size on the card. CREATE TABLE AS
    copies TPC-H SF 1 into the memory connector (lineitem 6,001,215 rows
    x 16 columns, orders, customer, supplier, nation, region); then
    BASELINE config 1, Q1 over the memory copy (== val_q1_sf1.json), and
    Q6, Q3 and Q5 over the copies (== the same queries over tpch), each
    under default and eager (one warm-up, median of TIMED_RUNS, peaks), with the
    kernels each must launch; DELETE, UPDATE, INSERT and DROP at size,
    each held to its predicate over tpch, and Q1 again after the DELETE;
    a view over Q1, a prepared statement against its literal query and
    EXPLAIN of Q5 against the CPU port's text; and queries.FUNCTIONS_SQL
    over tpch SF 1, card == CPU port. Returns the kernel launches of
    the memory rungs' runs."""
    from presto_tpu_torch import cuda

    card = card_line()
    t_phase = time.perf_counter()
    cpu_kernels = _memory_dispatches()
    log(f"statements: kernel twins the memory rungs dispatch on the CPU "
        f"at SF 0.01: { {f'Q{q} {m}': k for (q, m), k in cpu_kernels.items()} }")
    cats = _memory_catalogs(STATEMENTS_SF, dev)
    runner = _statements_runner(cats, dev, "default")
    walls = _load_memory_copies(runner)
    log("statements: CTAS at SF 1: " + ", ".join(
        f"{t} {n} rows {w:.4f} s" for t, (w, n) in walls.items())
        + f"; {card}")
    readings = {"ctas": walls}
    launches_total = {k: 0 for k in KERNEL_NAMES}
    on_tpch = _statements_runner(cats, dev, "default", catalog="tpch")
    for q in STATEMENTS_QUERIES:
        text = sql("tpch", q)
        want = on_tpch.execute(text).rows
        for mode in STATEMENTS_MODES:
            run = _statements_runner(cats, dev, mode)
            cuda.reset_counts()
            rows, ws, peak, reserved = _timed(run, text)
            counts = {k: cuda.launches.get(k, 0) for k in KERNEL_NAMES}
            for k in KERNEL_NAMES:
                launches_total[k] += counts[k]
            # the same kernel families as the CPU run at SF 0.01 (which
            # probe layout a join takes depends on its build's size)
            launched = sorted({FAMILY[k] for k in kernel_set(counts)})
            dispatched = sorted({FAMILY[k] for k in cpu_kernels[q, mode]})
            if launched != dispatched:
                raise AssertionError(
                    f"statements: memory Q{q} {mode}: the card launched "
                    f"{launched}, the CPU dispatched the twins of "
                    f"{dispatched}")
            for k in STATEMENTS_REQUIRED[q]:
                if k not in launched:
                    raise AssertionError(f"statements: memory Q{q} {mode}: "
                                         f"no {k} kernel launched")
            if not same_rows(rows, want):
                raise AssertionError(f"statements: memory Q{q} {mode}: rows "
                                     f"!= tpch\n mem {rows[:3]}\n tpch "
                                     f"{want[:3]}")
            note = check_validated(q, STATEMENTS_SF, rows)
            readings[f"Q{q} {mode}"] = dict(
                wall_s=ws, median_s=statistics.median(ws), peak_bytes=peak,
                reserved_bytes=reserved, launches=counts)
            log(f"statements: memory Q{q} SF 1 {mode}: rows {len(rows)} (== "
                f"tpch{note}), wall s {[round(w, 4) for w in ws]} (median "
                f"{statistics.median(ws):.4f}), peak alloc "
                f"{peak / 2**30:.3f} GiB (reserved {reserved / 2**30:.3f} "
                f"GiB), launches per 4 runs {counts}; {card}")
    _statements_dml(runner, cats, card, readings)
    t0 = time.perf_counter()
    _statements_functions(cats["tpch"], dev, card)
    readings["functions_s"] = time.perf_counter() - t0
    log(f"statements: phase {time.perf_counter() - t_phase:.1f} s; "
        + json.dumps({"readings": readings}, default=str))
    return launches_total


def _statements_dml(runner, cats, card, readings) -> None:
    """DELETE, UPDATE, INSERT, DROP, a view, a prepared statement and
    EXPLAIN over the memory copies, each against its oracle."""
    from presto_tpu_torch import queries as PQ
    from presto_tpu_torch.runner import LocalRunner

    S = PQ.STATEMENT_SQL

    def timed(text):
        t0 = time.perf_counter()
        res = runner.execute(text)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    res, w = timed(S["delete"])
    want = runner.execute(S["delete_count"]).rows[0][0]
    if res.rows != [(want,)] or res.update_type != "DELETE":
        raise AssertionError(f"statements: DELETE removed {res.rows}, the "
                             f"predicate holds on {want} tpch rows")
    q1 = runner.execute(sql("tpch", 1)).rows
    note = check_validated(1, STATEMENTS_SF, q1)
    log(f"statements: DELETE {want} lineitem rows in {w:.4f} s; Q1 after "
        f"it{note}; {card}")
    readings["delete_s"] = w
    res, w = timed(S["update"])
    matched, total = runner.execute(S["update_oracle"]).rows[0]
    got_total = runner.execute(S["update_sum"]).rows[0][0]
    if res.rows != [(matched,)] or got_total != total:
        raise AssertionError(f"statements: UPDATE matched {res.rows}, sum "
                             f"{got_total}; tpch says {matched}, {total}")
    log(f"statements: UPDATE {matched} orders rows in {w:.4f} s; "
        f"sum(o_totalprice) {got_total} == tpch's; {card}")
    readings["update_s"] = w
    runner.execute(S["view"].format(q1=sql("tpch", 1)))
    if not same_rows(runner.execute(S["view_query"]).rows, q1):
        raise AssertionError("statements: the view over Q1 != Q1")
    runner.execute(S["prepare"])
    got, want = (runner.execute(S[k]).rows for k in ("execute", "literal"))
    if got != want:
        raise AssertionError(f"statements: EXECUTE {got} != literal {want}")
    text = S["explain"].format(q5=sql("tpch", 5))
    plan = runner.execute(text).rows
    if plan != LocalRunner(cats, "memory", device="cpu").execute(text).rows:
        raise AssertionError("statements: EXPLAIN Q5 != the CPU port's")
    res, w = timed(S["insert"])
    count = runner.execute(S["region_count"]).rows
    if res.rows != [(5,)] or count != [(10,)]:
        raise AssertionError(f"statements: INSERT {res.rows}, count {count}")
    runner.execute(S["drop"])
    tables = [t for (t,) in runner.execute(S["show_tables"]).rows]
    if "region" in tables or "lineitem" not in tables:
        raise AssertionError(f"statements: SHOW TABLES after DROP: {tables}")
    readings["insert_s"] = w
    log(f"statements: view == Q1; EXECUTE p USING 24 == literal {got}; "
        f"EXPLAIN Q5 ({len(plan)} lines) == CPU port; INSERT 5 region rows "
        f"in {w:.4f} s (count 10), DROP, SHOW TABLES {tables}")


def _statements_functions(tpch_card, dev, card) -> None:
    """queries.FUNCTIONS_SQL over tpch SF 1: card rows == CPU port rows
    (as multisets), each timed on the card (its host work runs once per
    distinct value)."""
    from presto_tpu_torch import queries as PQ
    from presto_tpu_torch.connectors.tpch import TpchConnector

    cats_cpu = {"tpch": TpchConnector(STATEMENTS_SF, device="cpu")}
    gpu = _statements_runner({"tpch": tpch_card}, dev, "default", "tpch")
    cpu = _statements_runner(cats_cpu, "cpu", "default", "tpch")
    for name, text in PQ.FUNCTIONS_SQL.items():
        t0 = time.perf_counter()
        got = gpu.execute(text).rows
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = cpu.execute(text).rows
        if not got or not same_bag(got, want):
            raise AssertionError(f"statements: functions {name} SF 1: card "
                                 f"!= CPU\n card {got[:2]}\n cpu {want[:2]}")
        log(f"statements: functions {name} SF 1: {len(got)} rows, card == "
            f"CPU port, first run {wall:.4f} s on the card; {card}")


# ----------------------------------------------------- the governed paths

# the BASELINE SF 10 join rungs and the SF 1 rungs with the largest
# footprints (Q18 eager above 11 GiB, DS Q64 default above 22 GiB), on the
# eager session (materialized joins: the grace passes have builds), each
# with its forced variants besides the unbounded run: "budget" is the
# device_memory_budget that makes the governor bind at its scale (an 80
# GB card's auto budget, ~70 GiB, rarely does at SF 10); "host" is a
# spill_threshold_bytes with host_spill_bytes (grace passes by
# threshold, their restreamed sides in host RAM); "disk" adds
# disk_spill_bytes to the budget or to the threshold (the stores go to
# files). Each threshold partitions only the builds named: Q3's
# orders build (its passes re-read a regenerated lineitem scan, so no
# store exists to spill, and Q3 has no disk variant); in each of TPC-DS Q64's two CTE halves, the
# catalog-side build (95 MB by estimate) over a stored chain that holds
# the store_sales x store_returns join (111 MB), so that those two nest
# (its final self-join, 327 MB, has string keys and stays single-pass;
# a budget small enough for grace passes nests six of its joins, and
# their stores outgrew the 96 GiB of host memory of a one-card
# machine). Q5 SF 1 at a 2 MiB threshold nests two grace joins: 16
# passes over orders inside 8 over customer, the inner join's output
# stored for the outer's passes. Q3's host-tier variant runs at SF 1
# (at SF 10 it took 55.8 s on an H100, PERF.md: the script's time limit
# once the mesh phase came): grace passes by threshold whose probe side
# re-reads its scan, where the other host-tier rungs store theirs
GOVERNED = (
    ("tpch", 3, 10.0, {"budget": {"device_memory_budget": 2 << 30}}),
    ("tpch", 3, 1.0, {"host": {"spill_threshold_bytes": 24 << 20,
                               "host_spill_bytes": 1}}),
    # no host or disk variant (21.5 and 26.3 s on an H100 on a slow
    # host, PERF.md section 4: the script's time limit); Q5 SF 1 and
    # Q18 reach the host tier, Q18 the disk tier
    ("tpch", 5, 10.0, {"budget": {"device_memory_budget": 2 << 30}}),
    ("tpch", 5, 1.0, {"host": {"spill_threshold_bytes": 2 << 20,
                               "host_spill_bytes": 1}}),
    ("tpch", 18, 1.0, {"budget": {"device_memory_budget": 256 << 20},
                       "host": {"spill_threshold_bytes": 32 << 20,
                                "host_spill_bytes": 1},
                       "disk": {"device_memory_budget": 256 << 20,
                                "disk_spill_bytes": 1}}),
    # no disk variant here (58.9 s on an H100, PERF.md: the script's
    # time limit); Q18 reaches the disk tier
    ("tpcds", 64, 1.0, {"budget": {"device_memory_budget": 2 << 30},
                        "host": {"spill_threshold_bytes": 64 << 20,
                                 "host_spill_bytes": 1}}),
)


def watch_grace_depth(ex) -> dict:
    """Wrap one executor's grace-partitioned join so that the returned
    dict reads the deepest nesting of live grace joins ("depth": 2 = a
    grace join whose input is another grace join's output)."""
    orig = ex._exec_join_partitioned
    state = {"live": 0, "depth": 0}

    def wrapped(*args, **kwargs):
        state["live"] += 1
        state["depth"] = max(state["depth"], state["live"])
        try:
            yield from orig(*args, **kwargs)
        finally:
            state["live"] -= 1

    ex._exec_join_partitioned = wrapped
    return state


def phase_governed(dev) -> dict:
    """Each GOVERNED query on the eager session, unbounded and then under
    each of its forced variants: rows equal the unbounded run's, and the
    phase must reach grace passes, nested grace joins, governed
    rewrites, the host tier and the disk tier (files under SPILL_DIR).
    Returns the kernels the forced runs launched."""
    from presto_tpu_torch import cuda

    page_rows = 1 << 20
    os.makedirs(SPILL_DIR, exist_ok=True)
    launches_total = {k: 0 for k in KERNEL_NAMES}
    reached = collections.Counter()
    per_query = {}
    conns = {}
    for suite, q, sf, forced in GOVERNED:
        if (suite, sf) not in conns:
            conns[(suite, sf)] = make_conn(suite, sf, dev)
        conn = conns[(suite, sf)]
        variants = {"unbounded": {}, **{
            v: {**props, "spill_path": SPILL_DIR} if "disk" in v
            else props for v, props in forced.items()}}
        name = f"{suite} Q{q} SF {sf:g}"
        want = None
        for variant, props in variants.items():
            runner = make_runner(suite, conn, dev, {
                "page_rows": page_rows, **EAGER_SESSION, **props})
            grace = watch_grace_depth(runner.executor)
            fresh_memory(dev)
            cuda.reset_counts()
            t0 = time.perf_counter()
            res = runner.execute(sql(suite, q))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: cuda.launches.get(k, 0) for k in KERNEL_NAMES}
            peak, reserved = memory_peaks(dev)
            ctr = {**governor_counters(runner.executor),
                   "grace_join_depth": grace["depth"]}
            if want is None:
                want = res.rows
                if not want:
                    raise AssertionError(f"governed: {name}: no rows")
            elif not same_rows(res.rows, want):
                raise AssertionError(f"governed: {name} {variant}: rows "
                                     f"differ from the unbounded run")
            else:
                for k in KERNEL_NAMES:
                    launches_total[k] += counts[k]
                reached["grace passes"] += ctr["spill_partitions_used"] > 1
                reached["nested grace joins"] += ctr["grace_join_depth"] > 1
                reached["governed rewrites"] += \
                    ctr["memory_chunked_pipelines"] > 0
                reached["host tier"] += ctr["host_spill_pages"] > 0
                reached["disk tier"] += ctr["disk_spill_pages"] > 0
            log(f"governed: {name} {variant} {props}: rows {len(res.rows)}"
                f"{' == unbounded' if variant != 'unbounded' else ''}, "
                f"wall {wall:.4f} s, peak alloc {peak / 2**30:.3f} GiB "
                f"(reserved {reserved / 2**30:.3f} GiB), {ctr}, kernels "
                f"launched {counts}, boost retries "
                f"{runner.executor.capacity_boost_retries}")
            per_query.setdefault(name, {})[variant] = dict(
                wall_s=wall, peak_bytes=peak, reserved_bytes=reserved,
                launches=counts, **ctr)
    fresh_memory(dev)
    left = os.listdir(SPILL_DIR)
    if not left:
        os.rmdir(SPILL_DIR)
    log("governed: " + json.dumps({"reached": reached,
                                   "per_query": per_query}))
    if left:
        raise AssertionError(f"governed: spill files left behind: {left}")
    missing = [t for t in ("grace passes", "nested grace joins",
                           "governed rewrites", "host tier", "disk tier")
               if not reached[t]]
    if missing:
        raise AssertionError(f"governed: never reached {missing}")
    return launches_total


# --------------------------------------------- the relational surface

# the ten window shapes of tests/test_window.py over orders at SF 1
# (1,500,000 rows, ~100,000 o_custkey partitions, one 2^21-slot merged
# page), each folded into a checksum row so that neither side decodes
# 1.5M rows per run; sqlite runs the same SQL
SURFACE_WINDOWS = tuple(
    f"select count(*), {sums} from (select {cols} from orders{where}) t"
    for sums, cols, where in (
        ("sum(rn), sum(rk), sum(drk)",
         "row_number() over (partition by o_custkey order by o_orderdate, "
         "o_orderkey) rn, rank() over (partition by o_custkey order by "
         "o_orderdate) rk, dense_rank() over (partition by o_custkey "
         "order by o_orderdate) drk", ""),
        ("sum(rk), sum(drk)",
         "rank() over (partition by o_custkey order by o_orderpriority) "
         "rk, dense_rank() over (partition by o_custkey order by "
         "o_orderstatus) drk", ""),
        ("sum(c), sum(s), sum(mn), sum(mx)",
         "count(*) over (partition by o_custkey) c, sum(o_totalprice) over "
         "(partition by o_custkey) s, min(o_orderdate) over (partition by "
         "o_custkey) mn, max(o_orderdate) over (partition by o_custkey) mx",
         ""),
        ("sum(s), sum(c), sum(mn), sum(mx)",
         "sum(o_totalprice) over (partition by o_custkey order by "
         "o_orderdate) s, count(*) over (partition by o_custkey order by "
         "o_orderdate) c, min(o_totalprice) over (partition by o_custkey "
         "order by o_orderdate) mn, max(o_totalprice) over (partition by "
         "o_custkey order by o_orderdate) mx", ""),
        ("sum(a), sum(b), sum(c), sum(d), count(a), count(c)",
         "lag(o_orderkey) over (partition by o_custkey order by "
         "o_orderdate, o_orderkey) a, lead(o_orderkey) over (partition by "
         "o_custkey order by o_orderdate, o_orderkey) b, lag(o_orderkey, 2) "
         "over (partition by o_custkey order by o_orderdate, o_orderkey) c, "
         "first_value(o_orderkey) over (partition by o_custkey order by "
         "o_orderdate, o_orderkey) d", ""),
        ("sum(rk), max(s), min(s)",
         "rank() over (order by o_orderdate) rk, sum(o_totalprice) over "
         "(order by o_orderdate) s", ""),
        ("sum(s)",
         "sum(o_totalprice) over (partition by o_orderpriority order by "
         "o_orderkey) s", " where o_custkey % 5 = 0"),
        ("sum(nt), sum(pr), sum(cd)",
         "ntile(4) over (partition by o_custkey order by o_orderkey) nt, "
         "percent_rank() over (partition by o_custkey order by "
         "o_orderdate) pr, cume_dist() over (partition by o_custkey order "
         "by o_orderdate) cd", ""),
        ("sum(s), sum(mn), sum(mx), count(mx), sum(c)",
         "sum(o_totalprice) over (partition by o_custkey order by "
         "o_orderkey rows between 2 preceding and current row) s, "
         "min(o_totalprice) over (partition by o_custkey order by "
         "o_orderkey rows between 1 preceding and 1 following) mn, "
         "max(o_totalprice) over (partition by o_custkey order by "
         "o_orderkey rows between 3 preceding and 1 preceding) mx, "
         "count(*) over (partition by o_custkey order by o_orderkey rows "
         "between current row and unbounded following) c", ""),
        ("sum(nv), count(nv), sum(lv)",
         "nth_value(o_orderkey, 2) over (partition by o_custkey order by "
         "o_orderkey rows between unbounded preceding and unbounded "
         "following) nv, last_value(o_orderkey) over (partition by "
         "o_custkey order by o_orderdate range between unbounded "
         "preceding and unbounded following) lv", ""),
    ))
SURFACE_ROLLUP = (
    "select l_returnflag, l_linestatus, sum(l_quantity), "
    "sum(l_extendedprice), count(*) from lineitem "
    "group by rollup(l_returnflag, l_linestatus)")
SURFACE_ROLLUP_PLAIN = (
    "select l_returnflag, l_linestatus, sum(l_quantity), "
    "sum(l_extendedprice), count(*) from lineitem "
    "group by l_returnflag, l_linestatus")
# the fragmenter degrades a repartition on dictionary-coded keys to a
# gather (codes are page-local), so SURFACE_ROLLUP's stage DAG gathers
# its partial states; this rollup over integer keys repartitions them,
# through K4
SURFACE_ROLLUP_INT = (
    "select l_linenumber, l_shipdate, count(*), sum(l_quantity) "
    "from lineitem group by rollup(l_linenumber, l_shipdate)")
SURFACE_DISTINCT = (
    "select o_orderpriority, count(distinct o_custkey), count(*), "
    "sum(o_totalprice) from orders group by o_orderpriority")
SURFACE_HLL = "select approx_distinct(l_orderkey) from lineitem"
SURFACE_COLLECT = (
    "select o_custkey, array_agg(o_orderkey), "
    "approx_percentile(o_totalprice, 0.5), map_agg(o_orderkey, "
    "o_totalprice) from orders group by o_custkey")
SURFACE_UNNEST = ("select count(*), sum(x), sum(c * x) from aggs "
                  "cross join unnest(a) as u(x)")
SURFACE_UNNEST_ROWS = "select c, x from aggs cross join unnest(a) as u(x)"
SURFACE_MODES = ("default", "eager")
# the collect rung's slots per group. The reference's design sizes
# collect state by group CAPACITY (the planner's 1,500,000-group
# estimate, 2^18 slots after the optimistic clamp), not by the ~100,000
# real groups: at the default 1,024 slots a 2^18-group partial page
# holds 2 GiB per collect column, 12 GiB for this query's six, and
# grace passes (a 2 MiB spill threshold: 64 passes) keep every pass's
# output until the attempt ends, 2^21 groups x 5 result columns x 8 KiB
# = 80 GiB: an 80 GB card runs out (PERF.md §6). 64 slots hold every
# customer's orders at SF 1 (a group past them re-runs the query with
# the slots doubled)
COLLECT_SESSION = {"array_agg_max_elements": 64}
SURFACE_PAGE_ROWS = 1 << 18


def _timed(runner, text):
    """One warm-up and TIMED_RUNS timed runs: (rows, walls, peak
    allocated, peak reserved), the peaks over all four runs."""
    fresh_memory(runner.executor.device)
    res = runner.execute(text)
    torch.cuda.synchronize()
    walls = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        res = runner.execute(text)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return (res.rows, walls) + memory_peaks(runner.executor.device)


def _rollup_on_host(rows):
    """ROLLUP(flag, status) of plain GROUP BY rows, in exact integers."""
    out = {}
    for f, st, q, p, c in rows:
        for key in ((f, st), (f, None), (None, None)):
            cur = out.get(key, (0, 0, 0))
            out[key] = (cur[0] + q, cur[1] + p, cur[2] + c)
    return [k + v for k, v in out.items()]


# the scale of the surface's sqlite oracles (orders)
SURFACE_ORACLE_SF = 1.0


def _surface_oracles(sf: float) -> dict:
    """Every sqlite answer the surface phase compares with, from orders
    at ``sf`` generated on the CPU. It runs in a child process beside
    the card runs: on a thread its Python work would hold the GIL that
    the timed runs' host side needs."""
    from presto_tpu_torch import queries as PQ

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    db = PQ.load_sqlite(make_conn("tpch", sf, "cpu"), ["orders"])
    out = {"load_s": time.perf_counter() - t0}
    out["windows"] = [[tuple(r) for r in db.execute(text).fetchall()]
                      for text in SURFACE_WINDOWS]
    out["distinct"] = db.execute(SURFACE_DISTINCT).fetchall()
    out["collect"] = _collect_oracle(db)
    out["pairs"] = sorted(db.execute(
        "select o_custkey, o_orderkey from orders").fetchall())
    out["total_s"] = time.perf_counter() - t0
    db.close()
    return out


def _collect_oracle(db):
    """Per o_custkey from sqlite: the sorted orderkeys, the lower 0.5
    percentile of o_totalprice (index ceil(p n) - 1 of the sorted
    values) and the sorted (orderkey, totalprice) pairs."""
    groups = collections.defaultdict(list)
    for c, k, p in db.execute(
            "select o_custkey, o_orderkey, o_totalprice from orders"):
        groups[c].append((k, p))
    out = {}
    for c, pairs in groups.items():
        prices = sorted(p for _, p in pairs)
        out[c] = (tuple(sorted(k for k, _ in pairs)),
                  prices[math.ceil(0.5 * len(prices)) - 1],
                  tuple(sorted(pairs)))
    return out


def phase_surface(dev, cluster: "DistCluster", oracle_future) -> dict:
    """The relational surface at the size users run it, each rung under
    default and eager (one warm-up, median of TIMED_RUNS): the window shapes,
    MarkDistinct and the collect aggregates over orders SF 1, ROLLUP and
    approx_distinct over lineitem SF 10, and CROSS JOIN UNNEST of the
    collected arrays, each against its oracle (sqlite, the plain GROUP
    BY rolled up on the host, the exact distinct count, orders' own
    pairs). The ROLLUP also runs through the stage DAG at SF 1 (4
    workers), beside an integer-key rollup whose exchange launches K4.
    The sqlite oracles run in a child process meanwhile (main() starts
    it after `check`: ``oracle_future``). Prints every rung's walls,
    peaks, kernel launches and governor counters beside the card's name
    and power limit; returns the kernel launches of the rungs' runs."""
    from presto_tpu_torch.connectors.memory import MemoryConnector

    card = card_line()
    t_phase = time.perf_counter()
    return _surface_rungs(dev, cluster, card, oracle_future,
                          MemoryConnector, t_phase)


def _surface_rungs(dev, cluster, card, oracle_future, MemoryConnector,
                   t_phase) -> dict:
    """phase_surface's rungs, with the oracles' future."""
    from presto_tpu_torch import cuda
    from presto_tpu_torch import types as T
    from presto_tpu_torch.runner import LocalRunner

    sf1, sf10 = cluster.catalogs[_catalog(1.0)], \
        cluster.catalogs[_catalog(10.0)]
    launches_total = {k: 0 for k in KERNEL_NAMES}
    readings = {}

    def rung(name, conn, text, session=None, modes=SURFACE_MODES):
        """The query under each of ``modes`` over ``conn`` (the catalog
        "tpch", or "mem" for a memory connector): rows equal across
        modes; returns the first mode's rows."""
        catalog = "mem" if isinstance(conn, MemoryConnector) else "tpch"
        first = None
        for mode in modes:
            runner = LocalRunner({catalog: conn}, catalog, session={
                "page_rows": SURFACE_PAGE_ROWS, **SCALE_MODES[mode],
                **(session or {})}, device=dev)
            cuda.reset_counts()
            rows, walls, peak, reserved = _timed(runner, text)
            counts = {k: cuda.launches.get(k, 0) for k in KERNEL_NAMES}
            for k in KERNEL_NAMES:
                launches_total[k] += counts[k]
            gov = governor_counters(runner.executor)
            readings.setdefault(name, {})[mode] = dict(
                wall_s=walls, median_s=statistics.median(walls),
                peak_bytes=peak, reserved_bytes=reserved, launches=counts,
                **gov)
            log(f"surface: {name} {mode}: rows {len(rows)}, wall s "
                f"{[round(w, 4) for w in walls]} (median "
                f"{statistics.median(walls):.4f}), peak alloc "
                f"{peak / 2**30:.3f} GiB (reserved {reserved / 2**30:.3f} "
                f"GiB), launches per 4 runs {counts}, governor {gov}, "
                f"boost retries {runner.executor.capacity_boost_retries}; "
                f"{card}")
            if first is None:
                first = rows
            elif not same_bag(rows, first):
                raise AssertionError(f"surface: {name} {mode}: rows differ "
                                     f"from {modes[0]}")
        return first

    # windows and MarkDistinct: held to sqlite below, when its thread
    # is done
    windows = [rung(f"window {i}", sf1, text)
               for i, text in enumerate(SURFACE_WINDOWS)]
    distinct = rung("distinct", sf1, SURFACE_DISTINCT)
    # ROLLUP at SF 10: the plain GROUP BY rolled up on the host, then the
    # stage DAG; under default only (eager, the rollup and its oracle
    # took 28.5 s on an H100 on a slow host, PERF.md section 4: the
    # script's time limit)
    got = rung("rollup", sf10, SURFACE_ROLLUP, modes=("default",))
    plain = rung("rollup oracle (plain group by)", sf10,
                 SURFACE_ROLLUP_PLAIN, modes=("default",))
    if not same_bag(got, _rollup_on_host(plain)):
        raise AssertionError(f"surface: rollup: card {sorted(got, key=repr)}"
                             f" != host rollup of the plain GROUP BY")
    # the stage DAG at SF 1: a partial step emits one input-sized state
    # page per input page (the reference's design: a rollup's partial
    # states take no dense path), so at SF 10 its exchanges would carry
    # 3 x 60M slots
    coord = cluster.coordinator(1.0, SURFACE_PAGE_ROWS, FUSED_DIST_SESSION)
    single = {}
    for name, text in (("rollup dist", SURFACE_ROLLUP),
                       ("rollup dist (integer keys)", SURFACE_ROLLUP_INT)):
        cuda.reset_counts()
        drows, dwall, spooled = _dist_run(coord, text)
        dcounts = {k: cuda.launches.get(k, 0) for k in KERNEL_NAMES}
        for k in KERNEL_NAMES:
            launches_total[k] += dcounts[k]
        kinds = [f.output_kind for f in coord.last_scheduler.dag.fragments]
        readings[name] = dict(wall_s=dwall, launches=dcounts,
                              spooled_pages=spooled[0],
                              exchange_rows=spooled[1], edges=kinds)
        log(f"surface: {name} x{N_WORKERS} workers: rows {len(drows)}, "
            f"wall {dwall:.4f} s, edges {kinds}, spooled pages "
            f"{spooled[0]}, exchange rows {spooled[1]}, launches "
            f"{dcounts}; {card}")
        if text not in single:
            single[text] = cluster.local(1.0, SURFACE_PAGE_ROWS, {}) \
                .execute(text).rows
        if not same_bag(drows, single[text]):
            raise AssertionError(f"surface: {name} != single process")
    if "repartition" not in kinds or dcounts["part_ids"] <= 0:
        raise AssertionError("surface: the integer-key dist rollup did not "
                             "repartition through K4")
    # approx_distinct at SF 10: within 4 standard errors of the exact count
    got = rung("hll", sf10, SURFACE_HLL)
    exact = sf10.row_count("orders")
    if abs(got[0][0] - exact) > 4 * 0.065 * exact:
        raise AssertionError(f"surface: hll: estimate {got[0][0]} vs "
                             f"exact {exact}")
    log(f"surface: hll: estimate {got[0][0]} vs exact distinct "
        f"l_orderkey {exact} ({got[0][0] / exact - 1:+.4%})")
    # the collect aggregates: sqlite, elements sorted
    got = rung("collect", sf1, SURFACE_COLLECT, COLLECT_SESSION)
    oracle = oracle_future.result()
    log(f"surface: sqlite oracle (orders SF {SURFACE_ORACLE_SF:g} loaded "
        f"in {oracle['load_s']:.1f} s) done in {oracle['total_s']:.1f} "
        f"s, in a child process beside the card runs")
    for i, (g, w) in enumerate(zip(windows, oracle["windows"])):
        if not same_rows(g, w):
            raise AssertionError(f"surface: window {i}: card {g} != "
                                 f"sqlite {w}")
    if not same_bag(distinct, oracle["distinct"]):
        raise AssertionError("surface: distinct: card != sqlite")
    want = oracle["collect"]
    if len(got) != len(want):
        raise AssertionError(f"surface: collect: {len(got)} groups vs "
                             f"{len(want)}")
    for c, arr, pct, mp in got:
        w = want[c]
        if (tuple(sorted(arr)), pct, tuple(sorted(mp))) != w:
            raise AssertionError(f"surface: collect: group {c}: "
                                 f"{arr} {pct} != sqlite {w[:2]}")
    # CROSS JOIN UNNEST of the collected arrays (a collect result feeds
    # no device expression, in the reference too: it comes back through
    # a host table)
    mem = MemoryConnector(device=dev)
    mem.create_table("aggs", ["c", "a"], [T.BIGINT, T.ArrayType(T.BIGINT)],
                     [(c, tuple(a)) for c, a, _, _ in got])
    rung("unnest", mem, SURFACE_UNNEST)
    pairs = sorted(LocalRunner({"mem": mem}, "mem", session={
        "page_rows": SURFACE_PAGE_ROWS}, device=dev).execute(
            SURFACE_UNNEST_ROWS).rows)
    if pairs != oracle["pairs"]:
        raise AssertionError("surface: unnest: pairs != orders' pairs")
    log(f"surface: unnest: {len(pairs)} (o_custkey, o_orderkey) pairs == "
        f"orders' own")
    if launches_total["segsum"] <= 0:
        raise AssertionError("surface: K1 never launched")
    log("surface: " + json.dumps({"card": card, "readings": readings}))
    log(f"surface: phase wall {time.perf_counter() - t_phase:.1f} s")
    fresh_memory(dev)
    return launches_total


# ---------------------------------------------------------- the OOM ladder

# the real out-of-memory run: TPC-H Q1 SF 10 on the eager session in
# 2^23-row pages under a 4 GiB budget, which keeps the full page
# (membudget.rows_cap: 4 GiB / 8 over Q1's 46-byte rows); a quarter of
# it (two ladder halvings) governs the pages down to 2^21 rows
OOM_PAGE_ROWS = 1 << 23
OOM_BUDGET = 4 << 30


def phase_oom(dev) -> dict:
    """The device-OOM ladder on the card. First an injected fault on the
    default session (Q1 SF 10, its graphs captured): one retry, equal
    rows. Then the card's own torch.cuda.OutOfMemoryError: two
    calibration runs measure the peaks of the first attempt (budget B)
    and of the ladder's second halving (B / 4); the per-process memory
    fraction is set between them, so the first attempt cannot fit; the
    ladder must then finish the query under a halved budget with equal
    rows. The fraction is restored afterwards. Returns the kernels the
    ladder's runs launched."""
    from presto_tpu_torch import cuda

    conn = make_conn("tpch", 10.0, dev)
    launches_total = {k: 0 for k in KERNEL_NAMES}
    q1 = sql("tpch", 1)

    # the injected fault, default session
    plain = make_runner("tpch", conn, dev, {"page_rows": 1 << 20})
    fresh_memory(dev)
    want = plain.execute(q1).rows
    runner = make_runner("tpch", conn, dev, {"page_rows": 1 << 20})
    runner.executor.inject_device_oom = 1
    cuda.reset_counts()
    t0 = time.perf_counter()
    got = runner.execute(q1).rows
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ex = runner.executor
    for k in KERNEL_NAMES:
        launches_total[k] += cuda.launches.get(k, 0)
    if ex.device_oom_retries != 1 or not same_rows(got, want):
        raise AssertionError(f"oom: injected fault: device_oom_retries "
                             f"{ex.device_oom_retries}, rows equal "
                             f"{same_rows(got, want)}")
    log(f"oom: injected device fault, Q1 SF 10 default: "
        f"device_oom_retries 1, rows == the plain run's, wall {wall:.4f} s")

    # the card's own OOM, eager session
    session = {"page_rows": OOM_PAGE_ROWS, **EAGER_SESSION}
    peaks = {}
    for div in (1, 4):
        r = make_runner("tpch", conn, dev, {
            **session, "device_memory_budget": OOM_BUDGET // div})
        fresh_memory(dev)
        rows = r.execute(q1).rows
        torch.cuda.synchronize()
        peaks[div] = memory_peaks(dev)
        if not same_rows(rows, want):
            raise AssertionError(f"oom: calibration at budget / {div}: "
                                 f"rows differ")
        lineitem = [r.executor.output_types(n) for n in _scans(
            r.plan(q1))][0]
        log(f"oom: calibration, budget {OOM_BUDGET // div / 2**30:g} GiB: "
            f"page rows {r.executor._governed_target_rows(lineitem, False)}"
            f", peak alloc {peaks[div][0] / 2**30:.3f} GiB, reserved "
            f"{peaks[div][1] / 2**30:.3f} GiB")
    # the limit sits between the second halving's reserve and the first
    # attempt's allocation
    low, high = peaks[4][1], peaks[1][0]
    if not low < high:
        raise AssertionError(f"oom: calibration does not separate: B / 4 "
                             f"reserves {low}, B allocates {high}")
    total = torch.cuda.mem_get_info(dev)[1]
    limit = (low + high) // 2
    runner = make_runner("tpch", conn, dev, {
        **session, "device_memory_budget": OOM_BUDGET})
    fresh_memory(dev)
    cuda.reset_counts()
    torch.cuda.set_per_process_memory_fraction(limit / total, dev)
    try:
        t0 = time.perf_counter()
        got = runner.execute(q1).rows
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = memory_peaks(dev)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    ex = runner.executor
    for k in KERNEL_NAMES:
        launches_total[k] += cuda.launches.get(k, 0)
    # the ladder must have absorbed the card's own error type, not some
    # other RuntimeError that mentions memory
    faults = [t.__qualname__ for t in ex.device_oom_faults]
    ok = (ex.device_oom_retries >= 1 and same_rows(got, want)
          and all(t is torch.cuda.OutOfMemoryError
                  for t in ex.device_oom_faults))
    log(f"oom: the card's own OOM, Q1 SF 10 eager, {OOM_PAGE_ROWS}-row "
        f"pages, budget {OOM_BUDGET / 2**30:g} GiB, memory limit "
        f"{limit / 2**30:.3f} GiB: device_oom_retries "
        f"{ex.device_oom_retries} absorbing {faults}, final budget {ex._budget() / 2**30:g} "
        f"GiB, rows {'==' if same_rows(got, want) else '!='} the plain "
        f"run's, wall {wall:.4f} s, peak alloc {peak[0] / 2**30:.3f} GiB "
        f"(reserved {peak[1] / 2**30:.3f} GiB)")
    if not ok:
        raise AssertionError(f"oom: the card's OOM was not absorbed "
                             f"(faults {faults})")
    fresh_memory(dev)
    return launches_total


def _scans(node):
    """The TableScan nodes of a plan."""
    from presto_tpu_torch.exec import plan as P

    if isinstance(node, P.TableScan):
        return [node]
    return [s for c in node.children() for s in _scans(c)]


# ------------------------------------------------------ the distributed path

N_WORKERS = 4
DIST_SCALE = ((1, 10.0), (3, 1.0), (5, 1.0))
# the distributed phase's session: every join partitioned and every
# exchange through K4 on the card, with the generated join off (the
# materialized joins this phase has always held)
# (stage_scheduler pinned to true: the default, auto, would take the
# legacy cuts first, which the dist phase's legacy part drives)
DIST_SESSION = {"join_distribution_type": "partitioned",
                "device_exchange_enabled": "true",
                "generated_join_enabled": "false",
                "stage_scheduler": "true"}
# the fused phase's: the same distribution, the default TPC-H path
FUSED_DIST_SESSION = {"join_distribution_type": "partitioned",
                      "device_exchange_enabled": "true",
                      "stage_scheduler": "true"}
# kernels each distributed query must launch (K4 wherever an exchange
# repartitions: Q1's 4 groups gather)
DIST_REQUIRED = {1: ("segsum",), 3: ("part_ids",), 5: ("part_ids",)}


def _catalog(sf: float) -> str:
    return "tpch_sf" + f"{sf:g}".replace(".", "_")


class DistCluster:
    """N_WORKERS in-process WorkerServers on the card sharing one
    connector per scale, and coordinators over them."""

    def __init__(self, dev, scales):
        from presto_tpu_torch.connectors.tpch import TpchConnector
        from presto_tpu_torch.server.worker import WorkerServer

        self.dev = dev
        self.catalogs = {_catalog(sf): TpchConnector(sf, device=dev)
                         for sf in scales}
        self.workers = [WorkerServer(self.catalogs, node_id=f"w{i}",
                                     device=dev)
                        for i in range(N_WORKERS)]
        for w in self.workers:
            w.start()
        # every coordinator built here, closed (its heartbeat thread)
        # with the cluster
        self.coords = []

    def coordinator(self, sf: float, page_rows: int,
                    session: dict = DIST_SESSION, **kw):
        from presto_tpu_torch.dist.dcn import DcnRunner

        name = _catalog(sf)
        coord = DcnRunner({name: self.catalogs[name]},
                          [w.uri for w in self.workers],
                          default_catalog=name, device=self.dev,
                          session_props={"page_rows": page_rows, **session},
                          **kw)
        self.coords.append(coord)
        return coord

    def local(self, sf: float, page_rows: int,
              session: dict = EAGER_SESSION):
        from presto_tpu_torch.runner import LocalRunner

        name = _catalog(sf)
        return LocalRunner({name: self.catalogs[name]}, name,
                           session={"page_rows": page_rows, **session},
                           device=self.dev)

    def coordinator_over(self, catalog, page_rows: int, session: dict):
        """A coordinator whose planner reads ``catalog`` (a wrapper of
        one of the cluster's connectors) while the workers scan the
        real one."""
        from presto_tpu_torch.dist.dcn import DcnRunner

        name = next(n for n, c in self.catalogs.items()
                    if c is catalog._inner)
        coord = DcnRunner({name: catalog}, [w.uri for w in self.workers],
                          default_catalog=name, device=self.dev,
                          session_props={"page_rows": page_rows, **session})
        self.coords.append(coord)
        return coord

    def restart(self, i: int) -> None:
        """Worker i, stopped (its death), up again on its uri."""
        from presto_tpu_torch.server.worker import WorkerServer

        old = self.workers[i]
        old.stop()
        self.workers[i] = WorkerServer(self.catalogs, port=old.port,
                                       node_id=old.node_id, device=self.dev)
        self.workers[i].start()

    def close_coordinators(self) -> None:
        """Close every coordinator built so far (their heartbeat
        threads): each phase's are done when the phase ends."""
        for c in self.coords:
            c.close()
        self.coords = []

    def stop(self) -> None:
        self.close_coordinators()
        for w in self.workers:
            w.stop()


def _dist_run(coord, sql):
    ex = coord.runner.executor
    pages0, rows0 = ex.spooled_exchange_pages, ex.spooled_exchange_rows
    t0 = time.perf_counter()
    rows = coord.execute(sql)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if coord.last_distribution != "stage-dag":
        raise AssertionError("the stage DAG did not engage")
    return rows, wall, (ex.spooled_exchange_pages - pages0,
                        ex.spooled_exchange_rows - rows0)


def phase_dist(dev, cluster: "DistCluster", oracles: dict,
               oracle_future) -> dict:
    """The distributed path (see the module docstring), then its replay
    part (_dist_replay) and its legacy part (_dist_legacy). The sqlite
    oracles of both parts load in a child process (main() starts it
    after `check`: ``oracle_future``); ``oracles`` (a dict) keeps them by
    SF for the mesh phase."""
    launches = _dist_rungs(dev, cluster)
    replay = _dist_replay(dev, cluster, oracle_future)
    oracle = oracles[REPLAY_SF] = oracle_future.result()
    legacy = _dist_legacy(dev, cluster, oracle)
    return {k: launches[k] + replay[k] + legacy[k] for k in KERNEL_NAMES}


def _dist_rungs(dev, cluster: "DistCluster") -> dict:
    from presto_tpu_torch import cuda
    from presto_tpu_torch import queries as PQ
    from presto_tpu_torch.connectors.tpch import TpchConnector

    # SF 0.01: card DcnRunner == card LocalRunner == sqlite
    cpu_conn = TpchConnector(0.01, device="cpu")
    db = PQ.load_sqlite(cpu_conn, tables_read("tpch", cpu_conn, (3, 5)))
    coord = cluster.coordinator(0.01, 1 << 13)
    single = cluster.local(0.01, 1 << 13)
    for q in (3, 5):
        got, _, _ = _dist_run(coord, sql("tpch", q))
        want = single.execute(sql("tpch", q)).rows
        if got != want:
            raise AssertionError(f"dist Q{q} SF 0.01: rows != single "
                                 f"process\n dist {got[:3]}\n local "
                                 f"{want[:3]}")
        check_oracle("tpch", q, got, db)
        log(f"dist: Q{q} SF 0.01: {len(got)} rows, DcnRunner on the card "
            f"== LocalRunner == sqlite")

    page_rows = 1 << 20
    launches_total = {k: 0 for k in KERNEL_NAMES}
    per_query = {}
    cuda.reset_counts()  # counts cover the main-path runs below only
    cluster.close_coordinators()
    for q, sf in DIST_SCALE:
        coord = cluster.coordinator(sf, page_rows)
        ex = coord.runner.executor
        adaptive0 = {k: getattr(ex, k) for k in ADAPTIVE_COUNTERS}
        before = dict(cuda.launches)
        torch.cuda.reset_peak_memory_stats()
        rows, _, _ = _dist_run(coord, sql("tpch", q))  # warm-up
        walls, spooled = [], None
        for _ in range(TIMED_RUNS):
            rows, wall, spooled = _dist_run(coord, sql("tpch", q))
            walls.append(wall)
        counts = {k: cuda.launches.get(k, 0) - before.get(k, 0)
                  for k in KERNEL_NAMES}
        adaptive = {k: getattr(ex, k) - adaptive0[k]
                    for k in ADAPTIVE_COUNTERS}
        peak = torch.cuda.max_memory_allocated()
        runs = 1 + TIMED_RUNS
        for k in DIST_REQUIRED[q]:
            if counts[k] <= 0:
                raise AssertionError(f"dist Q{q}: kernel {k} never "
                                     f"launched")
        for k in KERNEL_NAMES:
            launches_total[k] += counts[k]
        # one warm run each: spools kept to the query's end (replay
        # inputs) against the eager acks of task_retry_attempts=0,
        # which release each consumed partition at its consumer's
        # stage barrier
        torch.cuda.reset_peak_memory_stats()
        _dist_run(coord, sql("tpch", q))
        peak_kept = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _dist_run(cluster.coordinator(sf, page_rows, {
            **DIST_SESSION, "task_retry_attempts": 0}), sql("tpch", q))
        peak_acked = torch.cuda.max_memory_allocated()
        # outside the counted runs: the single-process rows and K4 off
        want = cluster.local(sf, page_rows).execute(sql("tpch", q)).rows
        off, off_wall, _ = _dist_run(
            cluster.coordinator(sf, page_rows, {
                **DIST_SESSION, "pallas_join_enabled": "false"}),
            sql("tpch", q))
        if rows != want or off != want:
            raise AssertionError(
                f"dist Q{q} SF {sf:g}: rows differ (K4 on == single "
                f"{rows == want}, K4 off == single {off == want})")
        log(f"dist: Q{q} SF {sf:g} x{N_WORKERS} workers: rows {len(rows)} "
            f"(== single process, == with K4 off), wall s "
            f"{[round(w, 4) for w in walls]} (median "
            f"{statistics.median(walls):.4f}; K4 off {off_wall:.4f}), "
            f"peak alloc {peak / 2**30:.3f} GiB (one warm run: "
            f"{peak_kept / 2**30:.3f} GiB with spools kept to the query's "
            f"end, {peak_acked / 2**30:.3f} GiB with "
            f"task_retry_attempts=0's eager acks), spooled pages "
            f"{spooled[0]}, rows through the exchanges {spooled[1]}, "
            f"launches per run { {k: v // runs for k, v in counts.items()} }"
            f", adaptive counters over the {runs} runs {adaptive}")
        per_query[q] = dict(sf=sf, wall_s=walls, rows=len(rows),
                            peak_bytes=peak, peak_kept_bytes=peak_kept,
                            peak_acked_bytes=peak_acked,
                            spooled_pages=spooled[0],
                            exchange_rows=spooled[1], launches=counts,
                            k4_off_wall_s=off_wall, adaptive=adaptive)
        # each rung's coordinators (their heartbeat threads) end with it
        cluster.close_coordinators()
    log("dist: " + json.dumps({"per_query": per_query}))
    return launches_total


# the stage-boundary re-planner's counters, logged on every dist rung
ADAPTIVE_COUNTERS = ("adaptive_replans", "adaptive_capacity_seeds",
                     "adaptive_dist_flips", "adaptive_replan_rejected")


# the dist phase's replay part: fault-tolerant stage scheduling and
# adaptive re-planning over the same 4 workers
REPLAY_SF = 1.0
REPLAY_PAGE_ROWS = 1 << 20
# traced: each faulted run logs its slowest spans (stages, tasks,
# retries, the root's fetches)
# (mesh_exchange_mode pinned to false: this part is about the spool
# plane's recovery, and the mesh plane's landing task is not replayed)
REPLAY_SESSION = {**DIST_SESSION, "retry_backoff_ms": 20,
                  "query_trace_enabled": "true",
                  "mesh_exchange_mode": "false"}
REPLAY_QUERIES = (3, 5)
# the root drain's query: a double column summed on the card in both of
# its stages, so the replay's prefix check holds float work to bit
# identity (atomic float adds would break it)
REPLAY_DOUBLE = (
    "select l_orderkey, sum(cast(l_extendedprice as double) * "
    "(1 - cast(l_discount as double))) rev, count(*) c from lineitem "
    "where l_orderkey < 600000 group by l_orderkey")
# its grouping repartitions (K4) into a final, non-leaf stage, whose
# task is the one the root drains
DOUBLE_SESSION = {**REPLAY_SESSION, "agg_gather_capacity": 1 << 12}
STRAGGLER_MS = 8000
# the adaptive runs' catalog claims these build tables hold 2^31 rows:
# the static plan partitions their joins, the observed spools flip them
MISSTATED = ("customer", "orders", "supplier")
RECOVERY_COUNTERS = ("task_retries", "nonleaf_replays", "workers_excluded",
                     "speculative_tasks_won", "speculative_tasks_lost"
                     ) + ADAPTIVE_COUNTERS


def _replay_oracles(sf: float) -> dict:
    """sqlite's answers to REPLAY_QUERIES at ``sf``, from tables
    generated on the CPU: it runs in a child process beside the card
    runs."""
    from presto_tpu_torch import queries as PQ

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    conn = make_conn("tpch", sf, "cpu")
    db = PQ.load_sqlite(conn, tables_read("tpch", conn, REPLAY_QUERIES))
    # Q5's plan: sqlite's own automatic indexes pair every customer
    # with every supplier of its nation (146 s for both queries at SF 1
    # on the card's host); keyed indexes drive it from orders instead.
    # The same rows either way
    db.execute("PRAGMA automatic_index = OFF")
    for table, col in (("orders", "o_custkey"), ("customer", "c_custkey"),
                       ("supplier", "s_suppkey")):
        db.execute(f"CREATE INDEX {table}_{col} ON {table} ({col})")
    db.execute("ANALYZE")
    out = {"load_s": time.perf_counter() - t0}
    for q in REPLAY_QUERIES:
        out[q] = db.execute(PQ.TPCH_ORACLE[q][0]).fetchall()
    # the legacy part's union cut under top-N (decimals as the engine's
    # scaled integers)
    out["topn"] = db.execute(LEGACY_TOPN_ORACLE).fetchall()
    out["total_s"] = time.perf_counter() - t0
    db.close()
    return out


def _post_fault(uri: str, **cfg) -> None:
    import urllib.request

    req = urllib.request.Request(
        f"{uri}/v1/fault", data=json.dumps(cfg).encode(),
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=5).close()


def _replay_run(coord, text):
    """(rows, wall s, this run's recovery and re-plan counters and the
    host's accept-queue drops, K4 launches) of one run (the
    coordinator's counters are lifetime ones: the run's are their
    deltas)."""
    from presto_tpu_torch import cuda

    ex = coord.runner.executor
    k4 = cuda.launches.get("part_ids", 0)
    before = {k: getattr(ex, k) for k in RECOVERY_COUNTERS}
    listen0 = _listen_counters()
    rows, wall, _spooled = _dist_run(coord, text)
    ctr = {k: getattr(ex, k) - before[k] for k in RECOVERY_COUNTERS}
    ctr.update({k: v - listen0[k]
                for k, v in _listen_counters().items()})
    return rows, wall, ctr, cuda.launches.get("part_ids", 0) - k4


def _listen_counters() -> dict:
    """The kernel's TcpExt ListenOverflows and ListenDrops (connects
    dropped by a full accept queue) from /proc/net/netstat, read only;
    {} where the file is missing."""
    try:
        with open("/proc/net/netstat") as f:
            lines = [ln.split() for ln in f]
    except OSError:
        return {}
    for head, vals in zip(lines[::2], lines[1::2]):
        if head and head[0] == "TcpExt:":
            d = dict(zip(head[1:], vals[1:]))
            return {k: int(d.get(k, 0)) for k in ("ListenOverflows",
                                                  "ListenDrops")}
    return {}


def _slowest(coord, n: int = 8) -> list:
    """The last traced run's n longest spans below the root: (kind,
    name's tail, s)."""
    tr = coord.runner.last_trace
    if tr is None:
        return []
    spans = sorted((sp for sp in tr.spans() if sp.kind != "query"),
                   key=lambda sp: -sp.dur())
    return [(sp.kind, sp.name[-22:], round(sp.dur(), 4))
            for sp in spans[:n]]


def _timed_stop(w, stops: list) -> None:
    """Stop (kill) worker w, recording how long its stop took."""
    t0 = time.perf_counter()
    w.stop()
    stops.append(round(time.perf_counter() - t0, 4))


def _close_rows(got, want) -> bool:
    """Two row sets of REPLAY_DOUBLE equal: the same keys and counts,
    the double sums to 9 significant digits (the single process sums
    in another order than the stages)."""
    return same_rows(sorted(got), sorted(want))


def _dist_replay(dev, cluster: "DistCluster", oracle_future) -> dict:
    """The replay part: (a) a worker stopped after the first stage, one
    stopped after a non-leaf stage (its consumers' [source-lost]
    replays), and one lost while the root drains a task it hosts after
    the root consumed its first fetch (the replayed task's pages must
    hash equal to the consumed prefix), each then restarted on its uri
    and back in the next query's pool; (b) injected submit and fetch
    drops; (c) a straggler raced by speculation; (d) adaptive
    re-planning against the static plan over a catalog that misstates
    its build tables' row counts. Rows equal the single process (and
    sqlite in (d)); every run's wall, fault-free and faulted, and its
    recovery counters are logged. Returns the kernel launches of its
    runs, counted from 0."""
    from presto_tpu_torch import cuda
    from presto_tpu_torch import queries as PQ
    from presto_tpu_torch.connectors.misestimate import Misestimate
    from presto_tpu_torch.server.worker import (
        register_local_runtime,
        unregister_local_runtime,
    )

    card = card_line()
    t_part = time.perf_counter()
    sf, pr = REPLAY_SF, REPLAY_PAGE_ROWS
    readings = {}
    cuda.reset_counts()
    single = cluster.local(sf, pr)
    want = {q: single.execute(sql("tpch", q)).rows for q in REPLAY_QUERIES}
    want["double"] = single.execute(REPLAY_DOUBLE).rows
    texts = [(q, sql("tpch", q), REPLAY_SESSION) for q in REPLAY_QUERIES]
    texts.append(("double", REPLAY_DOUBLE, DOUBLE_SESSION))

    def clean(label, key, rows, ctr, k4) -> None:
        ok = (_close_rows(rows, want[key]) if key == "double"
              else rows == want[key])
        if not ok:
            raise AssertionError(f"dist replay {label}: rows != the "
                                 f"single process")
        readings[label] = dict(ctr, k4_launches=k4)

    # fault-free walls of every query the faults hit
    free = {}
    for key, text, session in texts:
        coord = cluster.coordinator(sf, pr, session)
        _replay_run(coord, text)  # warm-up
        rows, wall, ctr, k4 = _replay_run(coord, text)
        clean(f"fault-free {key}", key, rows, ctr, k4)
        free[key] = wall
        coord.close()

    # (a) node loss
    for q in REPLAY_QUERIES:
        text = sql("tpch", q)
        # 1: a worker stopped after the first stage
        coord = cluster.coordinator(sf, pr, REPLAY_SESSION)
        victim = cluster.workers[3]
        stops = []
        coord._stage_hook = (lambda fid, w=victim:
                             fid == 0 and _timed_stop(w, stops))
        rows, wall, ctr, k4 = _replay_run(coord, text)
        clean(f"Q{q} first stage", q, rows, ctr, k4)
        if ctr["task_retries"] < 1 or ctr["workers_excluded"] != 1 \
                or k4 <= 0:
            raise AssertionError(f"dist replay Q{q} first stage: {ctr}, "
                                 f"K4 {k4}")
        cluster.restart(3)
        coord._stage_hook = None
        time.sleep(coord.heartbeat.interval_s)  # the probe's rate limit
        rows2, wall2, _c, _k = _replay_run(coord, text)
        if coord.last_pool != [w.uri for w in cluster.workers] \
                or rows2 != want[q]:
            raise AssertionError(f"dist replay Q{q}: the restarted worker "
                                 f"did not rejoin ({coord.last_pool})")
        log(f"dist replay: Q{q} SF {sf:g}, worker stopped after stage 0 "
            f"(its stop {stops} s): {wall:.4f} s (fault-free "
            f"{free[q]:.4f} s), {ctr}, K4 {k4}; slowest spans "
            f"{_slowest(coord)}; restarted, back in the pool: "
            f"{wall2:.4f} s; {card}")
        coord.close()

        # 2: a worker stopped after a non-leaf stage that feeds another
        coord = cluster.coordinator(sf, pr, REPLAY_SESSION)
        victim = cluster.workers[2]

        def hook(fid, coord=coord, w=victim):
            dag = coord.last_scheduler.dag
            if dag.fragment(fid).inputs and dag.consumers(fid) \
                    and not getattr(hook, "done", False):
                hook.done = fid
                _timed_stop(w, stops)

        stops = []
        coord._stage_hook = hook
        rows, wall, ctr, k4 = _replay_run(coord, text)
        clean(f"Q{q} non-leaf", q, rows, ctr, k4)
        if ctr["nonleaf_replays"] < 1 or ctr["workers_excluded"] != 1 \
                or k4 <= 0:
            raise AssertionError(f"dist replay Q{q} non-leaf: {ctr}, "
                                 f"K4 {k4}")
        log(f"dist replay: Q{q} SF {sf:g}, worker stopped after non-leaf "
            f"stage {getattr(hook, 'done', None)} (its stop {stops} s): "
            f"{wall:.4f} s (fault-free {free[q]:.4f} s), {ctr}, K4 {k4}; "
            f"slowest spans {_slowest(coord)}; {card}")
        coord.close()
        cluster.restart(2)

    # 3: the root's drain of a double-column task, its worker lost on
    # its second results fetch; the worker serves only over HTTP for
    # that run, so the root's drain and the prefix check cross the wire
    coord = cluster.coordinator(sf, pr, DOUBLE_SESSION)
    checks = []
    real_check = coord._prefix_matches

    def checked(uri, task_id, st, deadline):
        ok = real_check(uri, task_id, st, deadline)
        checks.append((st.next_token, ok))
        return ok

    coord._prefix_matches = checked
    victim = {}

    def root_hook(sched):
        t = sched.tasks[sched.dag.root_inputs[0]][0]
        victim["uri"] = t.placement.uri
        unregister_local_runtime(t.placement.uri)
        _post_fault(t.placement.uri, FAULT_KILL_AFTER_FETCHES=1)

    coord._root_hook = root_hook
    rows, wall, ctr, k4 = _replay_run(coord, REPLAY_DOUBLE)
    clean("double root drain", "double", rows, ctr,
          k4)
    if not checks or not all(ok and n >= 1 for n, ok in checks) \
            or ctr["workers_excluded"] != 1 or ctr["task_retries"] < 1 \
            or ctr["nonleaf_replays"] < 1 or k4 <= 0:
        raise AssertionError(f"dist replay root drain: prefix checks "
                             f"{checks}, {ctr}")
    readings["double root drain"]["prefix_checks"] = checks
    log(f"dist replay: the root drain lost {victim['uri']} after the "
        f"first fetch: {wall:.4f} s (fault-free {free['double']:.4f} s), "
        f"{len(rows)} rows, prefix checks (pages, equal) {checks}, {ctr}; "
        f"slowest spans {_slowest(coord)}; {card}")
    coord.close()
    cluster.restart(next(i for i, w in enumerate(cluster.workers)
                         if w.uri == victim["uri"]))

    # (b) injected submit and fetch drops on Q5: worker 1 serves only
    # over HTTP (so its spools cross the wire) and drops every 3rd fetch,
    # worker 2 refuses every 2nd task submit
    w1, w2 = cluster.workers[1], cluster.workers[2]
    unregister_local_runtime(w1.uri)
    _post_fault(w1.uri, FAULT_DROP_EVERY=3)
    _post_fault(w2.uri, FAULT_SUBMIT_DROP_EVERY=2)
    try:
        coord = cluster.coordinator(sf, pr, REPLAY_SESSION)
        rows, wall, ctr, k4 = _replay_run(coord, sql("tpch", 5))
    finally:
        _post_fault(w1.uri)
        _post_fault(w2.uri)
        register_local_runtime(w1.uri, w1)
    clean("Q5 drops", 5, rows, ctr, k4)
    if ctr["task_retries"] < 1:
        raise AssertionError(f"dist replay drops: {ctr}")
    log(f"dist replay: Q5 SF {sf:g} under submit and fetch drops: "
        f"{wall:.4f} s (fault-free {free[5]:.4f} s), {ctr}; slowest spans "
        f"{_slowest(coord)}; {card}")
    coord.close()

    # (c) a straggler: every task on worker 3 stalls STRAGGLER_MS
    _post_fault(cluster.workers[3].uri,
                FAULT_TASK_EXEC_DELAY_MS=STRAGGLER_MS)
    try:
        coord = cluster.coordinator(sf, pr, {**REPLAY_SESSION,
                                             "speculation_enabled": True})
        rows, wall, ctr, k4 = _replay_run(coord, sql("tpch", 3))
    finally:
        _post_fault(cluster.workers[3].uri)
    clean("Q3 straggler", 3, rows, ctr, k4)
    if ctr["speculative_tasks_won"] < 1 or wall >= STRAGGLER_MS / 1000:
        raise AssertionError(f"dist replay straggler: {wall:.4f} s, {ctr}")
    log(f"dist replay: Q3 SF {sf:g} with a {STRAGGLER_MS} ms straggler, "
        f"speculation on: {wall:.4f} s (fault-free {free[3]:.4f} s), "
        f"{ctr}; slowest spans {_slowest(coord)}; {card}")
    coord.close()

    # (d) adaptive against static, the join distribution automatic
    misstated = Misestimate(cluster.catalogs[_catalog(sf)],
                            {t: 1 << 31 for t in MISSTATED})
    oracle = oracle_future.result()
    flipped = False
    for q in REPLAY_QUERIES:
        out = {}
        for mode in ("auto", "false"):
            coord = cluster.coordinator_over(misstated, pr, {
                "device_exchange_enabled": "true",
                "generated_join_enabled": "false",
                "stage_scheduler": "true",
                "retry_backoff_ms": 20, "adaptive_execution": mode})
            _replay_run(coord, sql("tpch", q))  # warm-up
            torch.cuda.reset_peak_memory_stats()
            rows, wall, ctr, k4 = _replay_run(coord, sql("tpch", q))
            peak = torch.cuda.max_memory_allocated()
            clean(f"Q{q} adaptive {mode}", q, rows, ctr, k4)
            PQ.compare_tpch(q, rows, oracle[q], PQ.TPCH_ORACLE[q][1])
            kinds = [f.output_kind
                     for f in coord.last_scheduler.dag.fragments]
            out[mode] = (wall, peak, ctr, kinds)
            flipped = flipped or (ctr["adaptive_replans"] >= 1
                                  and ctr["adaptive_dist_flips"] >= 1)
            coord.close()
        log(f"dist replay: Q{q} SF {sf:g}, build tables misstated, "
            f"adaptive auto {out['auto'][0]:.4f} s (peak "
            f"{out['auto'][1] / 2**30:.3f} GiB, {out['auto'][2]}, stages "
            f"{out['auto'][3]}) vs false {out['false'][0]:.4f} s (peak "
            f"{out['false'][1] / 2**30:.3f} GiB, stages {out['false'][3]})"
            f"; rows == single process == sqlite; {card}")
        readings[f"Q{q} adaptive"] = {m: dict(wall_s=v[0], peak_bytes=v[1],
                                              stages=v[3])
                                      for m, v in out.items()}
    if not flipped:
        raise AssertionError("dist replay: no adaptive run re-planned "
                             "with a distribution flip")
    launches = {k: cuda.launches.get(k, 0) for k in KERNEL_NAMES}
    log(f"dist replay: part {time.perf_counter() - t_part:.1f} s (sqlite "
        f"load {oracle['load_s']:.1f} s, oracles {oracle['total_s']:.1f} "
        f"s in a child process); launches {launches}; "
        + json.dumps({"readings": readings}, default=str))
    return launches


# the dist phase's legacy part: the reference's default distributed path
# (stage_scheduler auto) over the same 4 workers
LEGACY_PAGE_ROWS = 1 << 20
LEGACY_SESSION = {"retry_backoff_ms": 20}
LEGACY_GJ_OFF = {**LEGACY_SESSION, "generated_join_enabled": "false"}
# the union cut under top-N: a join with no aggregation (~600,000
# joined rows reach the coordinator)
LEGACY_TOPN = (
    "select o_orderkey, o_orderdate, l_extendedprice from orders "
    "join lineitem on l_orderkey = o_orderkey "
    "where l_quantity > 45 "
    "order by l_extendedprice desc, o_orderkey, o_orderdate limit 100")
LEGACY_TOPN_ORACLE = LEGACY_TOPN.replace("> 45", "> 4500")
# (label, query, sf, session, partition_threshold, the distribution the
# cut analysis must choose, the kernels its runs must launch). At the
# default threshold (2^17) customer is big at SF 1 and orders would
# need two partition keys, so Q3 and Q5 fan out round-robin; at 2^20
# only orders and lineitem are big and co-partition on orderkey
LEGACY_RUNGS = (
    ("Q1", 1, 10.0, LEGACY_SESSION, 1 << 17, "roundrobin", ("segsum",)),
    ("Q6", 6, 10.0, LEGACY_SESSION, 1 << 17, "roundrobin", ("segsum",)),
    ("Q3", 3, 1.0, LEGACY_GJ_OFF, 1 << 17, "roundrobin", ("probe_radix",)),
    ("Q3 hash", 3, 1.0, LEGACY_GJ_OFF, 1 << 20, "hash", ("probe_radix",)),
    ("Q5", 5, 1.0, LEGACY_GJ_OFF, 1 << 17, "roundrobin",
     ("probe_dim", "probe_radix")),
    ("Q5 hash", 5, 1.0, LEGACY_GJ_OFF, 1 << 20, None,
     ("probe_dim", "probe_radix")),
    # at the default threshold orders and lineitem co-partition
    # ("union-hash", the masked scans the hash rungs time); above
    # lineitem's 6,000,000 rows the union cut splits round-robin
    ("top-N", "topn", 1.0, LEGACY_SESSION, 1 << 23, "union-roundrobin",
     ()),
)


def _legacy_timed(coord, text):
    """(rows, walls of TIMED_RUNS runs after one warm-up)."""
    coord.execute(text)
    walls, rows = [], None
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        rows = coord.execute(text)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return rows, walls


def _dist_legacy(dev, cluster: "DistCluster", oracle: dict) -> dict:
    """The legacy part: the reference's default distributed path
    (stage_scheduler auto) — the partial-aggregation cut of Q1 and Q6
    at SF 10, the round-robin and hash fan-outs of Q3 and Q5 at SF 1
    with the generated join off, the union cut under top-N at SF 1 —
    each (median of TIMED_RUNS after a warm-up) beside the same query
    with the stage DAG forced, rows == the single process on the card
    and == sqlite (Q1 and Q6 SF 10: == the reference's checksums);
    then Q3 at SF 1 with a worker killed after its first results fetch,
    recovered by re-running only its split share (_recover_task).
    Returns the kernel launches of the default-session runs, counted
    from 0."""
    from presto_tpu_torch import cuda
    from presto_tpu_torch import queries as PQ

    card = card_line()
    t_part = time.perf_counter()
    cuda.reset_counts()
    launches = {k: 0 for k in KERNEL_NAMES}
    readings = {}
    fault_free_q3 = None
    # the forced DAG's walls and the single process's rows of each
    # (query, session): a hash rung shares its round-robin rung's (the
    # threshold steers the legacy cuts only)
    yardsticks = {}
    for label, q, sf, session, thr, dist, required in LEGACY_RUNGS:
        text = LEGACY_TOPN if q == "topn" else sql("tpch", q)
        coord = cluster.coordinator(sf, LEGACY_PAGE_ROWS, session,
                                    partition_threshold=thr)
        before = dict(cuda.launches)
        rows, walls = _legacy_timed(coord, text)
        counts = {k: cuda.launches.get(k, 0) - before.get(k, 0)
                  for k in KERNEL_NAMES}
        got_dist = coord.last_distribution
        if (dist is not None and got_dist != dist) or \
                got_dist in ("stage-dag", "local"):
            raise AssertionError(f"legacy {label}: distribution "
                                 f"{got_dist}, expected {dist}")
        for k in required:
            if counts[k] <= 0:
                raise AssertionError(f"legacy {label}: kernel {k} never "
                                     f"launched")
        for k in KERNEL_NAMES:
            launches[k] += counts[k]
        # outside the counted runs: the DAG forced, the single process
        key = (q, sf, id(session))
        if key not in yardsticks:
            dag = cluster.coordinator(sf, LEGACY_PAGE_ROWS,
                                      {**session, "stage_scheduler": "true"})
            dag_rows, dag_walls = _legacy_timed(dag, text)
            if dag.last_distribution != "stage-dag":
                raise AssertionError(f"legacy {label}: the forced DAG did "
                                     f"not engage")
            yardsticks[key] = (dag_rows, dag_walls, cluster.local(
                sf, LEGACY_PAGE_ROWS, session).execute(text).rows)
        dag_rows, dag_walls, want = yardsticks[key]
        if not (same_rows(rows, want) and same_rows(dag_rows, want)):
            raise AssertionError(f"legacy {label}: rows != the single "
                                 f"process\n cut {rows[:3]}\n local "
                                 f"{want[:3]}")
        if q == "topn":
            if [tuple(r) for r in rows] != \
                    [tuple(r) for r in oracle["topn"]]:
                raise AssertionError("legacy top-N: rows != sqlite")
            checked = "== sqlite"
        elif sf == REPLAY_SF and q in oracle:
            PQ.compare_tpch(q, rows, oracle[q], PQ.TPCH_ORACLE[q][1])
            checked = "== sqlite"
        else:
            checked = check_validated(q, sf, rows).lstrip(", ")
        if label == "Q3":
            fault_free_q3 = rows
        med, dag_med = statistics.median(walls), statistics.median(dag_walls)
        log(f"legacy: {label} SF {sf:g} x{N_WORKERS} workers, "
            f"{got_dist}: {len(rows)} rows (== single process, {checked}),"
            f" wall s {[round(w, 4) for w in walls]} (median {med:.4f}) "
            f"against the forced DAG's median {dag_med:.4f}, launches per "
            f"run { {k: v // (1 + TIMED_RUNS) for k, v in counts.items()} }"
            f"; {card}")
        readings[label] = dict(sf=sf, distribution=got_dist, wall_s=walls,
                               dag_wall_s=dag_walls, rows=len(rows),
                               launches=counts)
        cluster.close_coordinators()

    # Q3 with worker 3 killed after serving its first results fetch: its
    # split share re-runs on a survivor, the fetch resuming at the
    # consumed token after the prefix check
    coord = cluster.coordinator(REPLAY_SF, LEGACY_PAGE_ROWS, LEGACY_GJ_OFF)
    coord.execute(sql("tpch", 3))  # warm
    ex = coord.runner.executor
    retries0, excl0 = ex.task_retries, ex.workers_excluded
    _post_fault(cluster.workers[3].uri, FAULT_KILL_AFTER_FETCHES=1)
    try:
        t0 = time.perf_counter()
        rows = coord.execute(sql("tpch", 3))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cluster.restart(3)
    retries = ex.task_retries - retries0
    excluded = ex.workers_excluded - excl0
    if rows != fault_free_q3 or retries < 1 or excluded != 1:
        raise AssertionError(f"legacy Q3 recovery: rows == fault-free "
                             f"{rows == fault_free_q3}, task_retries "
                             f"{retries}, workers_excluded {excluded}")
    log(f"legacy: Q3 SF {REPLAY_SF:g}, worker 3 killed after its first "
        f"results "
        f"fetch: {wall:.4f} s (fault-free median "
        f"{statistics.median(readings['Q3']['wall_s']):.4f} s), "
        f"task_retries {retries}, workers_excluded {excluded}, rows == "
        f"fault-free; {card}")
    readings["Q3 recovered"] = dict(wall_s=wall, task_retries=retries,
                                    workers_excluded=excluded)
    cluster.close_coordinators()
    log(f"legacy: part {time.perf_counter() - t_part:.1f} s; launches "
        f"{launches}; " + json.dumps({"readings": readings}))
    return launches


def phase_profile(dev, cluster: "DistCluster") -> None:
    """Where the time goes: each scale query under each session of
    SCALE_MODES, each dist query, and the statements phase's memory
    rungs (Q1, Q6, Q3, Q5 over CTAS copies of TPC-H SF 1), once more
    under torch.profiler — the device's busy share of the wall time, the
    number of device kernels, device time by kernel name, and the time
    of the host-to-device copies (a memory scan stages every split)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from presto_tpu_torch.exec import graphs

    runs = [("local", q, sf, mode, cluster.local(sf, 1 << 20, props))
            for q, sf in BASE_SCALE for mode, props in SCALE_MODES.items()]
    runs += [("dist", q, sf, "dist", cluster.coordinator(sf, 1 << 20))
             for q, sf in DIST_SCALE]
    mem_cats = _memory_catalogs(STATEMENTS_SF, dev)
    _load_memory_copies(_statements_runner(mem_cats, dev, "default"))
    runs += [("memory", q, STATEMENTS_SF, mode,
              _statements_runner(mem_cats, dev, mode))
             for q in STATEMENTS_QUERIES for mode in STATEMENTS_MODES]
    for path, q, sf, mode, runner in runs:
        graphs.clear()
        runner.execute(sql("tpch", q))  # warm-up (and graph captures)
        torch.cuda.synchronize()
        replays0 = graphs.stats["replays"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.execute(sql("tpch", q))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        replays = graphs.stats["replays"] - replays0
        by_name: dict = {}
        calls: dict = {}
        n_kernels = 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
            calls[e.name] = calls.get(e.name, 0) + 1
        busy = sum(by_name.values())
        h2d = sum(us for name, us in by_name.items() if "HtoD" in name)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"profile: {path} Q{q} SF {sf:g} {mode}: wall "
            f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"({100 * busy / wall_us:.1f}%), host-to-device copies "
            f"{h2d / 1e3:.2f} ms, {n_kernels} device kernels, "
            f"{replays} graph replays; top: " + "; ".join(
                f"{name[:60]} {us / 1e3:.2f} ms" for name, us in top))
        # the port's kernels as the profiler sees them on the path: device
        # time per launch, to cross-check the kernels phase's events
        for kernel, symbol in KERNEL_SYMBOLS.items():
            names = [nm for nm in by_name if symbol in nm]
            count = sum(calls[nm] for nm in names)
            if count:
                us = sum(by_name[nm] for nm in names)
                log(f"profile: {path} Q{q} SF {sf:g} {mode}: {kernel} "
                    f"{count} launches, {us / 1e3:.3f} ms, "
                    f"{us / 1e3 / count:.4f} ms per launch")
    graphs.clear()


# ------------------------------------------------------------- analyze
ANALYZE_PAGE_ROWS = 1 << 20
# EXPLAIN ANALYZE's runs: (query, SF, session), each with stats_drain
# off and on
ANALYZE_RUNS = ((1, 10.0, "default"), (1, 10.0, "eager"),
                (3, 1.0, "eager"), (5, 1.0, "eager"))
# the counters the Counters line must carry
ANALYZE_COUNTERS = ("pallas_joins_used", "program_launches",
                    "programs_compiled", "h2d_bytes", "d2h_bytes",
                    "transfer_wall_s")
# the queries traced with query_trace_dir: (label, query, SF, session)
TRACE_RUNS = (("Q1 SF 10 default", 1, 10.0, "default"),
              ("Q5 SF 1 eager", 5, 1.0, "eager"))
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_traces")
ONE_MIB = 1 << 20
# with the drain on, what runs outside the top node's next() calls is
# the row-count resolution and the row decode: the top node's wall
# must hold at least this share of the host-timed query wall
TOP_WALL_SHARE = 0.9


def _node_rows(plan, stats) -> list:
    """(label, pages, rows) per plan node in pre-order (None where the
    node ran inside a fused program)."""
    out = []

    def walk(n):
        st = stats.get(id(n))
        out.append((type(n).__name__, None if st is None
                    else (st.label, st.pages, st.rows)))
        for c in n.children():
            walk(c)

    walk(plan)
    return out


def _own_walls(plan, stats) -> list:
    """(label, own wall s) of each node with stats, in pre-order: its
    wall less its inputs' (a node's wall includes the next() calls of
    its inputs). The inputs are the nearest descendants with stats: a
    node that ran inside a fused program or a late-materialized join
    chain has none, and its inputs' walls lie inside the wall of the
    node above it. A negative own wall is an accounting fault: inputs
    timed outside their consumer's next()."""
    def measured(n) -> list:
        """The nearest descendants of ``n`` that carry stats."""
        out = []
        for c in n.children():
            out.extend([c] if id(c) in stats else measured(c))
        return out

    out = []
    for n in [plan] + _descendants(plan):
        st = stats.get(id(n))
        if st is not None:
            out.append((st.label, st.wall_s - sum(stats[id(c)].wall_s
                                                   for c in measured(n))))
    return out


def _descendants(n) -> list:
    out = []
    for c in n.children():
        out.append(c)
        out.extend(_descendants(c))
    return out


def _analyzed(runner, text, drain: bool):
    """One EXPLAIN ANALYZE run: (plan, rows, stats, wall s)."""
    runner.apply_session()
    ex = runner.executor
    plan = runner.plan(text)
    ex.stats_drain = drain
    try:
        t0 = time.perf_counter()
        _names, rows, stats = ex.execute_with_stats(plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ex.stats_drain = False
    return plan, rows, stats, wall


def _plain_wall(runner, text) -> tuple:
    """(rows, wall s) of one plain run."""
    t0 = time.perf_counter()
    rows = runner.execute(text).rows
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0


def _analyze_case(label, runner, text, card, eager: bool) -> dict:
    """EXPLAIN ANALYZE of one query with the drain off and on (one
    warm-up, median of TIMED_RUNS each), beside its plain wall."""
    from presto_tpu_torch.runner import explain_text

    rows, _ = _plain_wall(runner, text)  # warm-up: graph captures
    plain = statistics.median(
        _plain_wall(runner, text)[1] for _ in range(TIMED_RUNS))
    if runner.executor.trace_spans:
        raise AssertionError(f"analyze: {label}: trace_spans "
                             f"{runner.executor.trace_spans} untraced")
    out = {"rows": len(rows), "plain_s": plain}
    for drain in (False, True):
        _analyzed(runner, text, drain)  # warm-up
        runs = [_analyzed(runner, text, drain) for _ in range(TIMED_RUNS)]
        plan, arows, stats, _wall = runs[-1]
        walls = [r[3] for r in runs]
        top = stats[id(plan)]
        if top.rows != len(arows) or not same_rows(arows, rows):
            raise AssertionError(
                f"analyze: {label} drain={drain}: top node {top.rows} "
                f"rows, the query {len(arows)} (plain {len(rows)})")
        owns = _own_walls(plan, stats)
        negative = [(nm, w) for nm, w in owns if w < 0]
        if negative:
            raise AssertionError(f"analyze: {label} drain={drain}: "
                                 f"negative own walls {negative}")
        own = sum(w for _nm, w in owns)
        if own > walls[-1]:
            raise AssertionError(
                f"analyze: {label} drain={drain}: per-node own walls sum "
                f"to {own:.4f} s, past the query's {walls[-1]:.4f} s")
        if drain and top.wall_s < TOP_WALL_SHARE * walls[-1]:
            raise AssertionError(
                f"analyze: {label}: with the drain the top node's wall "
                f"{top.wall_s:.4f} s is under {TOP_WALL_SHARE:.0%} of "
                f"the query's {walls[-1]:.4f} s")
        ctr = stats["counters"]
        missing = [c for c in ANALYZE_COUNTERS if c not in ctr]
        if missing:
            raise AssertionError(f"analyze: {label}: Counters line lacks "
                                 f"{missing}")
        text_lines = explain_text(plan, stats=stats).splitlines()
        key = "drain" if drain else "enqueue"
        out[key] = dict(wall_s=walls, median_s=statistics.median(walls),
                        node_self_sum_s=own, top_wall_s=top.wall_s,
                        own_walls_s=owns, counters=ctr)
        least = min(owns, key=lambda o: o[1])
        log(f"analyze: {label} EXPLAIN ANALYZE stats_drain={drain} "
            f"(walls are {'device' if drain else 'enqueue'} time): wall s "
            f"{[round(w, 4) for w in walls]} (median "
            f"{statistics.median(walls):.4f}; plain {plain:.4f}), top "
            f"node {top.wall_s:.4f} s ({top.wall_s / walls[-1]:.1%} of "
            f"the last), {len(owns)} timed nodes, least own wall "
            f"{least[1] * 1e3:.3f} ms ({least[0]}); {card}")
        for line in text_lines[:-1]:
            log(f"analyze:   {line}")
        log(f"analyze:   {text_lines[-1]}")
    return out


def _profiled_memcpy(prof_json: str) -> list:
    """(bytes or None, device us) of every host-to-device copy in an
    exported profiler trace."""
    with open(prof_json) as f:
        doc = json.load(f)
    out = []
    for e in doc.get("traceEvents", []):
        if e.get("cat") != "gpu_memcpy" or "HtoD" not in e.get("name", ""):
            continue
        b = (e.get("args") or {}).get("bytes")
        out.append((None if b is None else int(b), float(e.get("dur", 0))))
    return out


def _ledger_vs_profiler(runner, text, card) -> dict:
    """BASELINE config 1 (memory Q1 SF 1) under torch.profiler and
    tracing: the ledger's h2d crossings against the profiler's HtoD
    copies; every copy of 1 MiB or more must be a metered crossing."""
    from torch.profiler import ProfilerActivity, profile

    runner.session.set("query_trace_enabled", "true")
    try:
        runner.execute(text)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            runner.execute(text)
            torch.cuda.synchronize()
    finally:
        runner.session.unset("query_trace_enabled")
    ex = runner.executor
    tr = runner.last_trace
    metered = collections.Counter(
        int(s.attrs.get("bytes", 0)) for s in tr.spans()
        if s.kind == "xfer" and s.name.startswith("h2d:"))
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "profile_memory_q1.json")
    prof.export_chrome_trace(path)
    copies = _profiled_memcpy(path)
    copy_us = sum(us for _b, us in copies)
    sized = [b for b, _us in copies if b is not None]
    big = collections.Counter(b for b in sized if b >= ONE_MIB)
    unmetered = big - metered
    log(f"analyze: memory Q1 SF 1 ledger vs profiler: h2d_transfers "
        f"{ex.h2d_transfers}, h2d_bytes {ex.h2d_bytes}, d2h_transfers "
        f"{ex.d2h_transfers}, d2h_bytes {ex.d2h_bytes}; profiler HtoD "
        f"copies {len(copies)} ({len(sized)} with bytes, "
        f"{sum(sized)} bytes), HtoD device time {copy_us / 1e3:.4f} ms; "
        f"transfer_wall_s {ex.transfer_wall_s:.6f} s; copies of 1 MiB or "
        f"more {sum(big.values())}, unmetered {sum(unmetered.values())}; "
        f"{card}")
    if len(sized) != len(copies):
        raise AssertionError("analyze: the profiler's trace carries no "
                             "bytes for some HtoD copies")
    if unmetered:
        raise AssertionError(f"analyze: HtoD copies of 1 MiB or more "
                             f"that no crossing metered: {dict(unmetered)}")
    return dict(h2d_transfers=ex.h2d_transfers, h2d_bytes=ex.h2d_bytes,
                d2h_transfers=ex.d2h_transfers, d2h_bytes=ex.d2h_bytes,
                transfer_wall_s=ex.transfer_wall_s,
                profiler_htod_copies=len(copies),
                profiler_htod_bytes=sum(sized),
                profiler_htod_ms=copy_us / 1e3,
                copies_1mib=sum(big.values()))


def _check_trace(label, trace, ex, wall, kinds, card) -> dict:
    """A finished trace: its Chrome file valid with the expected kinds,
    the executor's own xfer spans summing to its transfer_wall_s, the
    root's wall within 5% of the host-timed wall."""
    from presto_tpu_torch import obs as OBS
    from presto_tpu_torch.obs.trace import critical_path

    path = os.path.join(TRACE_DIR, f"{trace.query_id}.trace.json")
    with open(path) as f:
        doc = json.load(f)
    cats = {e["cat"] for e in doc["traceEvents"]}
    if not set(kinds) <= cats or not cats <= set(OBS.SPAN_KINDS):
        raise AssertionError(f"analyze: trace {label}: kinds {sorted(cats)}"
                             f", want {sorted(kinds)}")
    spans = trace.spans()
    by_id = {s.span_id: s for s in spans}

    def under_task(s):
        while s is not None:
            if s.kind == "task":
                return True
            s = by_id.get(s.parent_id)
        return False

    xfer = sum(s.dur() for s in spans
               if s.kind == "xfer" and not under_task(s))
    if abs(xfer - ex.transfer_wall_s) > 1e-6:
        raise AssertionError(f"analyze: trace {label}: xfer spans "
                             f"{xfer:.6f} s != transfer_wall_s "
                             f"{ex.transfer_wall_s:.6f} s")
    root = trace.root.dur()
    if abs(root - wall) > 0.05 * wall:
        raise AssertionError(f"analyze: trace {label}: root span "
                             f"{root:.4f} s, host wall {wall:.4f} s")
    cp = critical_path(trace)
    log(f"analyze: trace {label}: {len(spans)} spans, kinds "
        f"{dict(collections.Counter(s.kind for s in spans))}, root "
        f"{root:.4f} s vs host wall {wall:.4f} s, xfer spans {xfer:.6f} s "
        f"== transfer_wall_s; critical path {cp['chain']}; by kind ms "
        f"{cp['by_kind_ms']}; {card}")
    return dict(spans=len(spans), root_s=root, wall_s=wall, xfer_s=xfer,
                critical_path=cp)


def _traced_wall(run_fn, set_prop, unset_prop, last_trace) -> tuple:
    """(result, wall s, trace-file write s) of one run with
    query_trace_dir set. The wall is the host clock around the call and
    the final synchronize, less the trace file's write (QueryTrace.
    write_s), which runs after the root span ends and which the root
    cannot cover (a root once read 5.1% under a wall that included it).
    Everything else after the root's end (the detach, the synchronize)
    stays inside the wall, so a root that closes before the query's
    work is done still fails the 5% check. A collection first keeps a
    GC pause out of the few ms between the call and the root's start
    (the parse, the session)."""
    set_prop("query_trace_dir", TRACE_DIR)
    try:
        gc.collect()
        t0 = time.perf_counter()
        out = run_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        write = last_trace().write_s
        return out, wall - write, write
    finally:
        unset_prop("query_trace_dir")


def phase_analyze(dev, cluster: "DistCluster") -> dict:
    """The guard and stats planes on the card: EXPLAIN ANALYZE with the
    drain off and on (Q1 SF 10 default and eager, Q3 and Q5 SF 1 eager,
    BASELINE config 1 = memory Q1 SF 1), the card's per-node rows and
    pages == the CPU port's at SF 0.01; the transfer ledger against
    torch.profiler on memory Q1; traces of Q1 SF 10 default, Q5 SF 1
    eager and the dist Q3 SF 1 (critical paths, walls with tracing off,
    on and under EXPLAIN ANALYZE); the profile store on Q18 SF 1 eager;
    and the plan verifier over the 22 TPC-H and 16 TPC-DS plans at
    SF 1. Returns the kernel launches of its main-path runs."""
    import shutil

    from presto_tpu_torch import cuda
    from presto_tpu_torch import queries as PQ
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.exec import plan_check as PC
    from presto_tpu_torch.runner import LocalRunner

    card = card_line()
    t_phase = time.perf_counter()
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    readings = {}

    # the card's per-node rows and pages == the CPU port's (eager, SF
    # 0.01), outside the counted runs; late materialization's "auto"
    # (on a CUDA device) is set on both, so the two take one path
    small = {**EAGER_SESSION, "late_materialization_enabled": "true"}
    small_gpu = cluster.local(0.01, 1 << 13, small)
    small_cpu = LocalRunner({_catalog(0.01): TpchConnector(0.01,
                                                           device="cpu")},
                            _catalog(0.01), device="cpu",
                            session={"page_rows": 1 << 13, **small})
    for q in (1, 3, 5):
        gp, _gr, gs, _ = _analyzed(small_gpu, sql("tpch", q), True)
        cp_, _cr, cs, _ = _analyzed(small_cpu, sql("tpch", q), False)
        got, want = _node_rows(gp, gs), _node_rows(cp_, cs)
        if got != want:
            raise AssertionError(f"analyze: Q{q} SF 0.01 eager: per-node "
                                 f"rows/pages on the card {got} != the "
                                 f"CPU's {want}")
    log("analyze: Q1, Q3, Q5 SF 0.01 eager: every node's rows and pages "
        "on the card == the CPU port's")

    mem_cats = _memory_catalogs(STATEMENTS_SF, dev)
    mem = _statements_runner(mem_cats, dev, "default")
    mem.execute(PQ.STATEMENT_SQL["ctas"].format(t="lineitem"))

    cuda.reset_counts()  # the main-path runs of this phase from here
    for q, sf, mode in ANALYZE_RUNS:
        runner = cluster.local(sf, ANALYZE_PAGE_ROWS, SCALE_MODES[mode])
        readings[f"Q{q} SF {sf:g} {mode}"] = _analyze_case(
            f"Q{q} SF {sf:g} {mode}", runner, sql("tpch", q), card,
            eager=(mode == "eager"))
    readings["memory Q1 SF 1 default"] = _analyze_case(
        "memory Q1 SF 1 default (BASELINE config 1)", mem, sql("tpch", 1),
        card, eager=False)
    readings["ledger"] = _ledger_vs_profiler(mem, sql("tpch", 1), card)

    # traces: walls off / on / under EXPLAIN ANALYZE side by side
    for label, q, sf, mode in TRACE_RUNS:
        runner = cluster.local(sf, ANALYZE_PAGE_ROWS, SCALE_MODES[mode])
        text = sql("tpch", q)
        off = readings.get(f"Q{q} SF {sf:g} {mode}", {})
        walls, writes = [], []
        for _ in range(TIMED_RUNS):
            res, wall, write = _traced_wall(
                lambda: runner.execute(text), runner.session.set,
                runner.session.unset, lambda: runner.last_trace)
            walls.append(wall)
            writes.append(round(write, 6))
        tr = runner.last_trace
        kinds = ("query", "execute", "attempt", "operator", "xfer")
        got = _check_trace(label, tr, runner.executor, walls[-1], kinds,
                           card)
        got.update(traced_wall_s=walls, trace_write_s=writes,
                   plain_s=off.get("plain_s"),
                   analyze_s=off.get("enqueue", {}).get("median_s"))
        log(f"analyze: {label} walls: tracing off {got['plain_s']:.4f} s, "
            f"on {statistics.median(walls):.4f} s (median of "
            f"{TIMED_RUNS}; trace file writes {writes} s, outside the wall), EXPLAIN "
            f"ANALYZE {got['analyze_s']:.4f} s; {card}")
        readings[f"trace {label}"] = got
    coord = cluster.coordinator(1.0, ANALYZE_PAGE_ROWS)
    _dist_run(coord, sql("tpch", 3))  # warm-up, untraced
    if coord.runner.executor.trace_spans:
        raise AssertionError("analyze: untraced dist run recorded spans")
    _r, plain = _dist_run(coord, sql("tpch", 3))[:2]
    before = dict(cuda.launches)
    (rows, _w, _s), wall, write = _traced_wall(
        lambda: _dist_run(coord, sql("tpch", 3)), coord.runner.session.set,
        coord.runner.session.unset, lambda: coord.runner.last_trace)
    if cuda.launches.get("part_ids", 0) <= before.get("part_ids", 0):
        raise AssertionError("analyze: the traced dist Q3 launched no K4")
    got = _check_trace("dist Q3 SF 1", coord.runner.last_trace,
                       coord.runner.executor, wall,
                       ("query", "stage", "task", "dispatch", "queue",
                        "run", "fetch", "execute", "attempt", "xfer"),
                       card)
    got.update(plain_s=plain, trace_write_s=write)
    log(f"analyze: dist Q3 SF 1 walls: tracing off {plain:.4f} s, on "
        f"{wall:.4f} s (trace file write {write:.6f} s, outside the "
        f"wall); {card}")
    readings["trace dist Q3 SF 1"] = got

    # the profile store: Q18 SF 1 eager twice
    prof_dir = os.path.join(TRACE_DIR, "profiles")
    runs = []
    for _ in range(2):
        runner = cluster.local(1.0, ANALYZE_PAGE_ROWS, {
            **EAGER_SESSION, "stats_profile_dir": prof_dir})
        fresh_memory(dev)
        rows, wall = _plain_wall(runner, sql("tpch", 18))
        ex = runner.executor
        runs.append(dict(wall_s=wall, rows=len(rows),
                         peak_bytes=memory_peaks(dev)[0],
                         capacity_boost_retries=ex.capacity_boost_retries,
                         profile_store_hits=ex.profile_store_hits,
                         boost=ex._capacity_boost, result=rows))
    first, second = runs
    log(f"analyze: Q18 SF 1 eager with stats_profile_dir: first run "
        f"{first['wall_s']:.4f} s, peak {first['peak_bytes'] / 2**30:.3f} "
        f"GiB, boost retries {first['capacity_boost_retries']} (settled "
        f"boost {first['boost']}); second {second['wall_s']:.4f} s, peak "
        f"{second['peak_bytes'] / 2**30:.3f} GiB, retries "
        f"{second['capacity_boost_retries']}, profile hits "
        f"{second['profile_store_hits']}; {card}")
    if not (first["capacity_boost_retries"] > 0
            and second["capacity_boost_retries"] == 0
            and second["profile_store_hits"] == 1
            and same_rows(first.pop("result"), second.pop("result"))):
        raise AssertionError("analyze: Q18's repeat did not start from its "
                             "profile with equal rows")
    readings["profile Q18 SF 1 eager"] = runs
    launches = {k: cuda.launches.get(k, 0) for k in KERNEL_NAMES}

    # the plan verifier over both corpora at SF 1, on the card's executor
    t0 = time.perf_counter()
    checked = 0
    for suite, conn in (("tpch", cluster.catalogs[_catalog(1.0)]),
                        ("tpcds", TpcdsConnector(1.0, device=dev))):
        name = _catalog(1.0) if suite == "tpch" else "tpcds"
        runner = LocalRunner({name: conn}, name, device=dev,
                             session={"plan_check": "true"})
        runner.apply_session()
        texts = PQ.TPCH_SQL if suite == "tpch" else PQ.TPCDS_SQL
        for q in sorted(texts):
            PC.verify(runner.executor, runner.plan(texts[q]))
            checked += 1
    log(f"analyze: plan_check.verify: {checked} plans at SF 1 (22 TPC-H, "
        f"{checked - 22} TPC-DS) verify clean in "
        f"{time.perf_counter() - t0:.2f} s; {card}")
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    log(f"analyze: phase {time.perf_counter() - t_phase:.1f} s; "
        + json.dumps({"readings": readings}, default=str))
    return launches


# ------------------------------------------------------ the HTTP server

SERVE_SF = 10.0
SERVE_SMALL_SF = 1.0
SERVE_PAGE_ROWS = 1 << 20
# (a) the serial server: (catalog, query, X-Presto-Session properties);
# the SF 1 runs with the generated join off reach K2 and K3
SERVE_SERIAL = (
    ("tpch", 1, {}), ("tpch", 6, {}), ("tpch", 3, {}), ("tpch", 5, {}),
    ("tpch_small", 3, {"generated_join_enabled": "false"}),
    ("tpch_small", 5, {"generated_join_enabled": "false"}),
)
# (b) paged delivery: ~190,000 rows at SF 10, 4,096 rows a protocol page
SERVE_PAGED = ("select o_orderkey, o_custkey, o_totalprice from orders "
               "where o_orderdate < date '1992-02-01'")
# (c) the concurrent server: one-split statements (nation, region) for
# the cross-query batching race, then Q1 and Q5 at SF 10 at once
SERVE_STATEMENTS = (
    "select count(*), sum(n_nationkey) from nation",
    "select r_name, count(*) from region group by r_name order by r_name",
    "select n_regionkey, count(*), max(n_name) from nation "
    "group by n_regionkey order by n_regionkey",
)
SERVE_CLIENTS = 8
SERVE_ROUNDS = 3
SERVE_WARMUPS = 3
SERVE_BUDGET = 64 << 30
SERVE_HEAVY = (1, 1, 5, 5)
# kernels the phase's server runs must launch
SERVE_REQUIRED = ("segsum", "probe_dim", "probe_radix", "part_ids")


def _serve_client(url: str, catalog: str, props: dict, user="presto"):
    from presto_tpu_torch.client import StatementClient

    c = StatementClient(url, user=user, catalog=catalog)
    c.session_properties.update({k: str(v) for k, v in props.items()})
    return c


def _client_run(client, text):
    """(ClientResult, wall s, protocol requests) of one statement."""
    n = [0]
    request = client._request

    def counted(*a, **kw):
        n[0] += 1
        return request(*a, **kw)

    client._request = counted
    try:
        t0 = time.perf_counter()
        res = client.execute(text)
        wall = time.perf_counter() - t0
    finally:
        client._request = request
    if res.error is not None or res.state != "FINISHED":
        raise AssertionError(f"server: {text[:60]!r} {res.state} "
                             f"{res.error}")
    return res, wall, n[0]


def _json_rows(result):
    from presto_tpu_torch.server.http_server import _json_row

    return [_json_row(r, result.column_types) for r in result.rows]


def _direct_timed(runner, text):
    """Rows and the median wall of TIMED_RUNS direct runs after one
    warm-up, each ending in a synchronize."""
    runner.execute(text)
    walls = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        res = runner.execute(text)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return res, statistics.median(walls)


def _scrape(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^presto_tpu_(\w+) (\S+)$", text, re.M)}


def _race(url: str, batching: str) -> tuple:
    """SERVE_CLIENTS clients x SERVE_ROUNDS rounds of SERVE_STATEMENTS
    at once: ({sql: {rows variant}}, wall s)."""
    import threading

    out, errors = [[] for _ in range(SERVE_CLIENTS)], []

    def client(i):
        # the concurrent path caches by default: pinned off, so the
        # rounds time executions and the launch batcher, not hits
        c = _serve_client(url, "tpch", {"cross_query_batching": batching,
                                        "result_cache_enabled": "false"},
                          user=f"dash{i}")
        for _ in range(SERVE_ROUNDS):
            for text in SERVE_STATEMENTS:
                try:
                    res, _w, _n = _client_run(c, text)
                    out[i].append((text, tuple(map(tuple, res.rows))))
                except Exception as e:  # noqa: BLE001 - raised below
                    errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve: race with batching={batching}: "
                             f"{errors[:3]}")
    by_sql = collections.defaultdict(set)
    for rows in out:
        for text, r in rows:
            by_sql[text].add(r)
    return dict(by_sql), wall


def _heavy_at_once(url: str, texts: dict) -> dict:
    """SERVE_HEAVY's queries from one client each, all at once, on the
    scan group: {client index: (query, json rows, wall s)}."""
    import threading

    out, errors = {}, []

    def client(i, q):
        # pinned off: repeated rounds execute (and the OOM round's
        # injected fault is reached), where a cache hit would execute
        # nothing
        c = _serve_client(url, "tpch", {"result_cache_enabled": "false"},
                          user=f"scan{i}")
        try:
            res, wall, _n = _client_run(c, texts[q])
            out[i] = (q, res.rows, wall)
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i, q))
               for i, q in enumerate(SERVE_HEAVY)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or len(out) != len(SERVE_HEAVY):
        raise AssertionError(f"serve: concurrent Q1/Q5: {errors[:3]}")
    return out


# (e) re-attach: the journal's directory (git-ignored, emptied first)
JOURNAL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "_journal")
# the stream a restart cuts after its first 4,096-row protocol page
REATTACH_STREAM = ("select o_orderkey, o_custkey, o_totalprice from orders "
                   "where o_orderdate < date '1992-04-01' "
                   "order by o_orderkey")
# (mesh_exchange_mode pinned to false: re-attach resumes from spooled
# stages, and the mesh plane's landing task is not journaled)
REATTACH_PROPS = {"join_distribution_type": "partitioned",
                  "stage_scheduler": "true",
                  "mesh_exchange_mode": "false"}


def _journal_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _serve_reattach(dev, cluster, counted, servers, card) -> None:
    """(e) A server with a checkpoint journal over the cluster's
    workers: (1) Q3 SF 1 through the stage DAG, parked before the root's
    drain, the server stopped and a successor booted on the journal: the
    client's stream resumes with the uninterrupted rows, one re-attach,
    no producer task relaunched; (2) the same with one root-input spool
    deleted: only .ra tasks re-dispatch; (3) a 4,096-row-paged stream
    over orders cut after its first page: it resumes at the client's
    token, no row missing or repeated. Logs each re-attach wall against
    the uninterrupted one, checkpoints_written and the journal's
    bytes."""
    import shutil
    import threading
    import urllib.request

    from presto_tpu_torch.server import PrestoTpuServer

    name = _catalog(SERVE_SMALL_SF)
    shutil.rmtree(JOURNAL_DIR, ignore_errors=True)

    def boot():
        srv = PrestoTpuServer(
            {name: cluster.catalogs[name]}, name, port=0,
            page_rows=SERVE_PAGE_ROWS, device=dev,
            worker_uris=[w.uri for w in cluster.workers],
            checkpoint_dir=JOURNAL_DIR)
        servers.append(srv)
        return srv, f"http://127.0.0.1:{srv.start()}"

    def get(url):
        with urllib.request.urlopen(url, timeout=600) as r:
            return json.loads(r.read().decode())

    def post(url, text, props):
        headers = {"X-Presto-Catalog": name, "Content-Type": "text/plain"}
        if props:
            headers["X-Presto-Session"] = ",".join(
                f"{k}={v}" for k, v in props.items())
        req = urllib.request.Request(f"{url}/v1/statement",
                                     data=text.encode(), headers=headers)
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read().decode())

    def drain(doc):
        rows = []
        while True:
            if doc.get("error"):
                raise AssertionError(f"serve (e): {doc['error']}")
            rows.extend(doc.get("data") or [])
            if not doc.get("nextUri"):
                return rows
            doc = get(doc["nextUri"])

    def uninterrupted(text, props):
        srv, url = boot()
        counted(lambda: drain(post(url, text, props)))  # warm-up
        t0 = time.perf_counter()
        rows = counted(lambda: drain(post(url, text, props)))
        wall = time.perf_counter() - t0
        srv.stop()
        return rows, wall

    def created_counter():
        created, saved = [], []
        for w in cluster.workers:
            orig = w.create_task
            saved.append((w, orig))
            w.create_task = (lambda req, _o=orig:
                             (created.append(req.get("taskId")), _o(req))[1])
        return created, lambda: [setattr(w, "create_task", o)
                                 for w, o in saved]

    q3 = sql("tpch", 3)
    want, free_wall = uninterrupted(q3, REATTACH_PROPS)
    for label, kill_spool in (("zero relaunch", False),
                              ("dead spool", True)):
        shutil.rmtree(JOURNAL_DIR, ignore_errors=True)
        srv, url = boot()
        park = threading.Event()

        def hook(sched, park=park):
            park.wait(300)
            raise RuntimeError("superseded coordinator: parked root drain "
                               "aborted")

        srv._dcn._root_hook = hook
        qid = post(url, q3, REATTACH_PROPS)["id"]
        rec = None
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            rec = srv._journal.pending().get(qid)
            if rec and rec.get("root") and all(
                    str(f) in rec["stages"] for f in rec["root_inputs"]):
                break
            time.sleep(0.05)
        else:
            raise AssertionError("serve (e): the journal never reached the "
                                 "root barrier")
        written = srv._runner.executor.checkpoints_written
        journal_bytes = _journal_bytes(JOURNAL_DIR)
        srv.manager.get(qid).checkpoint.detach()  # the crash
        srv.stop()
        if kill_spool:
            victim = rec["stages"][str(rec["root_inputs"][0])]["tasks"][0]
            urllib.request.urlopen(urllib.request.Request(
                f"{victim['uri']}/v1/task/{victim['task_id']}",
                method="DELETE"), timeout=30).close()
        created, restore = created_counter()
        try:
            t0 = time.perf_counter()
            srv2, url2 = boot()
            got = counted(lambda: drain(get(
                f"{url2}/v1/statement/{qid}/0")))
            wall = time.perf_counter() - t0
        finally:
            restore()
            park.set()
        ex = srv2._runner.executor
        ok_tasks = (all(".ra" in t for t in created) and created
                    if kill_spool else not created)
        if got != want or ex.coordinator_reattaches != 1 or not ok_tasks \
                or (ex.reattach_redispatches >= 1) != kill_spool:
            raise AssertionError(
                f"serve (e) {label}: rows == uninterrupted {got == want}, "
                f"reattaches {ex.coordinator_reattaches}, redispatches "
                f"{ex.reattach_redispatches}, tasks created {created}")
        log(f"serve: (e) {label}: Q3 SF {SERVE_SMALL_SF:g} re-attached "
            f"after a coordinator restart at the root drain: {len(got)} "
            f"rows == uninterrupted; reattach wall (boot to last row) "
            f"{wall:.4f} s against the uninterrupted {free_wall:.4f} s; "
            f"coordinator_reattaches 1, reattach_redispatches "
            f"{ex.reattach_redispatches}, tasks created {created}; "
            f"checkpoints_written before the crash {written}, journal "
            f"{journal_bytes} bytes; {card}")
        srv2.stop()

    # (3) the paged stream, cut after its first protocol page
    want, free_wall = uninterrupted(REATTACH_STREAM, {})
    shutil.rmtree(JOURNAL_DIR, ignore_errors=True)
    srv, url = boot()
    doc = post(url, REATTACH_STREAM, {})
    rows = []
    while not doc.get("data"):
        doc = get(doc["nextUri"])
    rows.extend(doc["data"])
    token = int(doc["nextUri"].rstrip("/").rsplit("/", 1)[1])
    qid = doc["id"]
    written = srv._runner.executor.checkpoints_written
    journal_bytes = _journal_bytes(JOURNAL_DIR)
    srv.stop()
    t0 = time.perf_counter()
    srv2, url2 = boot()
    rest = counted(lambda: drain(get(f"{url2}/v1/statement/{qid}/{token}")))
    wall = time.perf_counter() - t0
    got = rows + rest
    ex = srv2._runner.executor
    if got != want or ex.coordinator_reattaches != 1 or \
            qid in srv2._journal.pending():
        raise AssertionError(
            f"serve (e) stream: {len(got)} rows against {len(want)}, "
            f"equal {got == want}, reattaches {ex.coordinator_reattaches}")
    log(f"serve: (e) a {len(want)}-row stream cut after page 1 (token "
        f"{token}) resumed: no row missing or repeated; reattach wall "
        f"(boot to last row) {wall:.4f} s against the uninterrupted "
        f"{free_wall:.4f} s; checkpoints_written before the cut {written}, "
        f"journal {journal_bytes} bytes; {card}")
    srv2.stop()
    shutil.rmtree(JOURNAL_DIR, ignore_errors=True)


def phase_serve(dev, cluster: "DistCluster") -> dict:
    """The coordinator's /v1/statement protocol on the card, driven by
    StatementClient with the lock sanitizer armed: (a) a serial server
    answering Q1, Q6, Q3, Q5 at SF 10 and Q3, Q5 at SF 1 with the
    generated join off in the header, rows == a direct LocalRunner in
    this process (Q1/Q6 == the reference's checksums), client walls
    beside direct walls; (b) paged delivery of ~190,000 rows; (c) a
    concurrent server (memory arbiter, two resource groups; the result
    cache pinned off, the rounds time executions): 8 clients
    x 3 rounds of one-split statements with cross-query batching off,
    then on (rows equal, shared launches, walls, histogram p50/p95,
    graph captures), then Q1 and Q5 SF 10 from 4 clients at once (rows
    == (a), peak memory against the arbiter's estimates); (d) a server
    over the DistCluster's workers running Q3 SF 1 partitioned (K4);
    (e) coordinator checkpoints and re-attach (_serve_reattach).
    Returns the kernel launches of the server runs."""
    from presto_tpu_torch import cuda
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.exec import graphs
    from presto_tpu_torch.obs import sanitizer as SAN
    from presto_tpu_torch.obs.histo import Histogram
    from presto_tpu_torch.runner import LocalRunner
    from presto_tpu_torch.server import PrestoTpuServer
    from presto_tpu_torch.server.http_server import _json_row
    from presto_tpu_torch.server.resource_groups import (
        ResourceGroupManager,
        ResourceGroupSpec,
    )

    card = card_line()
    t_phase = time.perf_counter()
    SAN.arm()
    SAN.reset()
    catalogs = {"tpch": TpchConnector(SERVE_SF, device=dev),
                "tpch_small": TpchConnector(SERVE_SMALL_SF, device=dev)}
    sfs = {"tpch": SERVE_SF, "tpch_small": SERVE_SMALL_SF}
    servers = []
    launches = collections.Counter()

    def counted(fn):
        before = collections.Counter(cuda.launches)
        out = fn()
        after = collections.Counter(cuda.launches)
        launches.update({k: after[k] - before[k] for k in KERNEL_NAMES})
        return out

    def serve(**kw):
        srv = PrestoTpuServer(catalogs, "tpch", port=0,
                              page_rows=SERVE_PAGE_ROWS, device=dev, **kw)
        servers.append(srv)
        return srv, f"http://127.0.0.1:{srv.start()}"

    try:
        # ---- (a) the serial server against a direct runner
        srv, url = serve()
        expect = {}
        for cat, q, props in SERVE_SERIAL:
            text = sql("tpch", q)
            direct = LocalRunner(catalogs, cat, device=dev, session={
                "page_rows": SERVE_PAGE_ROWS, **props})
            res, direct_wall = _direct_timed(direct, text)
            note = (check_validated(q, sfs[cat], res.rows)
                    if not props else "")
            want = _json_rows(res)
            client = _serve_client(url, cat, props)
            counted(lambda: _client_run(client, text))  # warm-up
            walls = []
            for _ in range(TIMED_RUNS):
                got, wall, nreq = counted(
                    lambda: _client_run(client, text))
                walls.append(wall)
                if got.rows != want or [c["type"] for c in got.columns] \
                        != res.column_types:
                    raise AssertionError(
                        f"serve: Q{q} SF {sfs[cat]:g} {props}: server "
                        f"rows != direct rows\n {got.rows[:2]}\n "
                        f"{want[:2]}")
            expect[(cat, q)] = want
            log(f"serve: (a) Q{q} SF {sfs[cat]:g} {props or 'default'}: "
                f"{len(want)} rows == direct{note}; client wall median "
                f"{statistics.median(walls):.4f} s "
                f"{[round(w, 4) for w in walls]} against direct "
                f"{direct_wall:.4f} s; {nreq} protocol requests")

        # ---- (b) paged delivery
        direct = LocalRunner(catalogs, "tpch", device=dev,
                             session={"page_rows": SERVE_PAGE_ROWS})
        res, direct_wall = _direct_timed(direct, SERVE_PAGED)
        want = _json_rows(res)
        client = _serve_client(url, "tpch", {})
        counted(lambda: _client_run(client, SERVE_PAGED))
        walls, pages = [], 0
        for _ in range(TIMED_RUNS):
            got, wall, pages = counted(
                lambda: _client_run(client, SERVE_PAGED))
            walls.append(wall)
            if sorted(got.rows) != sorted(want):
                raise AssertionError("serve: paged rows != direct rows")
        wall = statistics.median(walls)
        log(f"serve: (b) paged: {len(want)} rows in {pages} protocol "
            f"requests, client wall median {wall:.4f} s "
            f"({len(want) / wall:.0f} rows/s) against direct "
            f"{direct_wall:.4f} s")
        srv.stop()

        # ---- (c) the concurrent server
        rg = ResourceGroupManager([ResourceGroupSpec(
            "global", ".*", hard_concurrency=16, max_queued=256,
            sub_groups=(
                ResourceGroupSpec("dash", "dash.*", hard_concurrency=8,
                                  max_queued=128, priority=10),
                ResourceGroupSpec("scan", ".*", hard_concurrency=4,
                                  max_queued=64, memory_share=0.25),
            ))])
        srv, url = serve(memory_budget_bytes=SERVE_BUDGET,
                         resource_groups=rg)
        direct = LocalRunner(catalogs, "tpch", device=dev,
                             session={"page_rows": SERVE_PAGE_ROWS})
        small_want = {t: tuple(map(tuple, _json_rows(direct.execute(t))))
                      for t in SERVE_STATEMENTS}
        # warm-up passes with batching on capture the batched programs
        # (one per statement and dispatch width, which vary from pass to
        # pass) until a pass captures none, so the timed passes replay
        for n in range(SERVE_WARMUPS):
            caps0 = graphs.snapshot()["captures"]
            counted(lambda: _race(url, "true"))
            new = graphs.snapshot()["captures"] - caps0
            log(f"serve: (c) warm-up pass {n + 1}, batching=true: {new} "
                f"graph captures")
            if not new:
                break
        passes = {}
        for batching in ("false", "true"):
            srv.manager.latency_histo = Histogram()
            caps0, cached0 = graphs.snapshot()["captures"], len(
                graphs.cached())
            m0 = _scrape(url)
            rows, wall = counted(lambda: _race(url, batching))
            m1 = _scrape(url)
            for text in SERVE_STATEMENTS:
                if rows[text] != {small_want[text]}:
                    raise AssertionError(
                        f"serve: batching={batching}: {text!r} rows "
                        f"{len(rows[text])} variants, != direct")
            h = srv.manager.latency_histo
            passes[batching] = dict(
                wall_s=wall, p50_s=h.quantile(0.5), p95_s=h.quantile(0.95),
                batches=m1["cross_query_batches_total"]
                - m0["cross_query_batches_total"],
                batched_queries=m1["cross_query_batched_queries_total"]
                - m0["cross_query_batched_queries_total"],
                launches=m1["program_launches"] - m0["program_launches"],
                mean_width=round((m1["cross_query_batched_queries_total"]
                                  - m0["cross_query_batched_queries_total"])
                                 / max(m1["cross_query_batches_total"]
                                       - m0["cross_query_batches_total"],
                                       1), 3),
                queries_per_launch=m1["queries_per_launch"],
                fallbacks=m1["split_batch_fallbacks_total"]
                - m0["split_batch_fallbacks_total"],
                captures=graphs.snapshot()["captures"] - caps0,
                programs_cached=(cached0, len(graphs.cached())))
            log(f"serve: (c) {SERVE_CLIENTS} clients x {SERVE_ROUNDS} "
                f"rounds, batching={batching}: rows == direct; "
                + json.dumps(passes[batching]))
        on = passes["true"]
        if on["batches"] <= 0 or on["mean_width"] <= 1 \
                or on["fallbacks"] != 0 or passes["false"]["batches"]:
            raise AssertionError(f"serve: no shared launch: {on}")
        texts = {q: sql("tpch", q) for q in set(SERVE_HEAVY)}
        est = {q: direct.estimate_memory(texts[q]) for q in texts}
        # a warm-up round: under the scan group's memory share the
        # governor sizes these queries' splits apart from (a), so their
        # programs are captured here, not in the timed round
        counted(lambda: _heavy_at_once(url, texts))
        torch.cuda.reset_peak_memory_stats(dev)
        out = counted(lambda: _heavy_at_once(url, texts))
        unfaulted = out
        peak = memory_peaks(dev)
        for i, (q, rows, _w) in out.items():
            if rows != expect[("tpch", q)]:
                raise AssertionError(f"serve: concurrent Q{q} (client "
                                     f"{i}) rows != (a)")
        retries = sum(q.runner.executor.device_oom_retries
                      for q in srv.manager.queries()
                      if q.runner is not None)
        est_sum = sum(est[q] for q in SERVE_HEAVY)
        log(f"serve: (c) Q1, Q1, Q5, Q5 SF {SERVE_SF:g} from 4 clients at "
            f"once: rows == (a); walls s "
            f"{[round(out[i][2], 4) for i in sorted(out)]}; peak alloc "
            f"{peak[0] / 2**30:.3f} GiB, reserved {peak[1] / 2**30:.3f} "
            f"GiB; the arbiter's estimates Q1 {est[1] / 2**30:.3f} GiB, "
            f"Q5 {est[5] / 2**30:.3f} GiB, sum {est_sum / 2**30:.3f} GiB "
            f"({est_sum / max(peak[0], 1):.3f} of the allocated peak); "
            f"device_oom_retries {retries}; {card}")
        # the same round with one query's device-OOM ladder (an injected
        # fault at its first attempt's start): the release frees only
        # the faulting query's programs (none touched yet at that point)
        # and the other queries' captures stay cached
        factory = srv.manager._runner_factory
        faulted = []

        def faulting(session):
            r = factory(session)
            if session.user == "scan0":
                r.executor.inject_device_oom = 1
                faulted.append(r.executor)
            return r

        seen = {q.id for q in srv.manager.queries()}
        cached0 = len(graphs.cached())
        caps0 = graphs.snapshot()["captures"]
        srv.manager._runner_factory = faulting
        try:
            out = counted(lambda: _heavy_at_once(url, texts))
        finally:
            srv.manager._runner_factory = factory
        for i, (q, rows, _w) in out.items():
            if rows != expect[("tpch", q)]:
                raise AssertionError(f"serve: Q{q} (client {i}) beside an "
                                     f"OOM retry: rows != (a)")
        retries = sum(q.runner.executor.device_oom_retries
                      for q in srv.manager.queries()
                      if q.id not in seen and q.runner is not None)
        if retries != 1:
            raise AssertionError(f"serve: {retries} OOM retries, not 1")
        released = sum(len(ex.programs_released) for ex in faulted)
        log(f"serve: (c) the same round with one injected device OOM: "
            f"rows == (a); 1 retry; programs cached {cached0} -> "
            f"{len(graphs.cached())}, released by the fault {released}, "
            f"captures in the round "
            f"{graphs.snapshot()['captures'] - caps0}; walls s "
            f"{[round(out[i][2], 4) for i in sorted(out)]} against the "
            f"unfaulted round's "
            f"{[round(unfaulted[i][2], 4) for i in sorted(unfaulted)]}")
        srv.stop()

        # ---- (d) a server over the worker fleet
        name = _catalog(SERVE_SMALL_SF)
        fleet = PrestoTpuServer(
            {name: cluster.catalogs[name]}, name, port=0,
            page_rows=SERVE_PAGE_ROWS, device=dev,
            worker_uris=[w.uri for w in cluster.workers])
        servers.append(fleet)
        url = f"http://127.0.0.1:{fleet.start()}"
        text = sql("tpch", 3)
        # the stage DAG's rows come back untyped (decimals and dates as
        # engine integers), so the direct rows render without types
        want = [_json_row(r) for r in cluster.local(
            SERVE_SMALL_SF, SERVE_PAGE_ROWS, {}).execute(text).rows]
        client = _serve_client(url, name,
                               {"join_distribution_type": "partitioned",
                                "stage_scheduler": "true"})
        before = cuda.launches["part_ids"]
        counted(lambda: _client_run(client, text))
        walls = []
        for _ in range(TIMED_RUNS):
            got, wall, _n = counted(lambda: _client_run(client, text))
            walls.append(wall)
            if got.rows != want:
                raise AssertionError("serve: fleet Q3 rows != direct")
        k4 = cuda.launches["part_ids"] - before
        if fleet._dcn.last_distribution != "stage-dag" or k4 <= 0:
            raise AssertionError(f"serve: fleet Q3: distribution "
                                 f"{fleet._dcn.last_distribution}, K4 "
                                 f"launches {k4}")
        log(f"serve: (d) Q3 SF {SERVE_SMALL_SF:g} over {N_WORKERS} workers, "
            f"partitioned: {len(want)} rows == direct; K4 launches {k4}; "
            f"client wall median {statistics.median(walls):.4f} s")
        fleet.stop()

        # ---- (e) coordinator checkpoints and re-attach
        _serve_reattach(dev, cluster, counted, servers, card)
    finally:
        for s in servers:
            s.stop()
        violations = SAN.violation_count()
        report = SAN.report()
        SAN.disarm()
    if violations:
        raise AssertionError(f"serve: sanitizer: {report}")
    for k in SERVE_REQUIRED:
        if launches[k] <= 0:
            raise AssertionError(f"serve: kernel {k} never launched")
    log(f"serve: sanitizer 0 violations; launches "
        f"{dict(launches)}; phase {time.perf_counter() - t_phase:.1f} s")
    return {k: launches[k] for k in KERNEL_NAMES}



# ---------------------------------------------------------------- mesh
MESH_SHARDS = 4
MESH_PAGE_ROWS = 1 << 20
MESH_RUNS = ((1, 10.0), (6, 10.0), (3, 1.0), (5, 1.0))
# K1 on every shard's partial aggregation (Q3's and Q5's revenue sums
# are long decimals, which K1 does not take, as on one device)
MESH_REQUIRED = {1: ("segsum",), 6: ("segsum",), 3: (), 5: ()}
# every join partitions both sides and every group-by repartitions its
# partial states: the all_to_all on every exchange
MESH_FORCED = dict(broadcast_rows=64, gather_capacity=16)
# the skew tables, CTAS on the card from TPC-H SF 1: half of lineitem's
# 6,001,215 rows (the even order keys) carry the hot key 7, the rest
# keys 100..1099, each in the dim table once
SKEW_FACT = ("create table memory.skew_fact as select case when "
             "l_orderkey % 2 = 0 then 7 else l_orderkey % 1000 + 100 end "
             "as k, l_partkey as seq, cast(l_extendedprice as double) as v "
             "from tpch.lineitem")
SKEW_DIM = ("create table memory.skew_dim as select case when s_suppkey "
            "= 1 then 7 else s_suppkey + 98 end as k, s_suppkey * 10 as "
            "label from tpch.supplier where s_suppkey <= 1001")
SKEW_AGG = ("select k, count(*), sum(v), max(seq) from skew_fact "
            "group by k order by k")
SKEW_JOIN = ("select count(*), sum(label), sum(v) from skew_fact, "
             "skew_dim where skew_fact.k = skew_dim.k")
# dim forced to partition (its ~1,001 rows > 16): the hot key's probe
# rows land on one shard
SKEW_FORCED = dict(broadcast_rows=16, gather_capacity=16)
SKEW_SF = 1.0
SKEW_MIN_ROWS = 1 << 22
ICI_SF = 1.0
ICI_QUERIES = (3, 5)
ICI_MODES = ("auto", "false")


def _mesh_timed(runner, text) -> tuple:
    """(rows, walls of TIMED_RUNS runs after one warm-up, peak
    allocated bytes over them)."""
    runner.execute(text)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        rows = runner.execute(text).rows
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return rows, walls, torch.cuda.max_memory_allocated()


def _mesh_profile(runner, text) -> None:
    """One profiled run: the device's busy share of the wall and the
    top 5 device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.execute(text)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"mesh: profiled forced Q1: wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%); "
        f"top: " + "; ".join(f"{nm[:60]} {us / 1e3:.2f} ms"
                             for nm, us in top))


def _exchange_shard_rows(runner, text, table: str) -> list:
    """Rows per shard after the repartition of ``table``'s side of the
    plan, re-run at the settled boost of the last execute."""
    from presto_tpu_torch.exec import plan as P

    def scans(n):
        return ((isinstance(n, P.TableScan) and n.table == table)
                or any(scans(c) for c in n.children()))

    def find(n):
        if (isinstance(n, P.Exchange) and n.kind == "repartition"
                and scans(n.source)):
            return n
        for c in n.children():
            hit = find(c)
            if hit is not None:
                return hit
        return None

    node = find(runner.plan(text))
    ex = runner.executor
    counts = [0] * MESH_SHARDS
    for page in ex.pages(node):
        for j, shard in enumerate(page.shards):
            counts[j] += int(shard.num_rows())
    ex._pending_overflow = []
    return counts


def phase_mesh(dev, cluster: "DistCluster", oracles=None) -> dict:
    """The in-process mesh on the card (see the module docstring):
    (a) LocalRunner over make_mesh(4), (b) skew, (c) the ICI plane.
    sqlite's Q3 and Q5 come from ``oracles`` (the dist phase's) or a
    child process of its own. Returns the main paths' kernel launches:
    the mesh runs of (a) and (b) and the auto runs of (c), each counted
    from 0."""
    import concurrent.futures
    import multiprocessing

    from presto_tpu_torch import cuda
    from presto_tpu_torch import queries as PQ
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.dist.executor import DistExecutor, make_mesh
    from presto_tpu_torch.runner import LocalRunner

    mesh = make_mesh(MESH_SHARDS)
    log(f"mesh: {mesh.size} shards on {len(mesh.distinct_devices())} "
        f"card(s) ({', '.join(str(d) for d in mesh.distinct_devices())}); "
        f"{card_line()}")
    launches = {k: 0 for k in KERNEL_NAMES}

    def counted(fn):
        before = dict(cuda.launches)
        out = fn()
        delta = {k: cuda.launches.get(k, 0) - before.get(k, 0)
                 for k in KERNEL_NAMES}
        for k in KERNEL_NAMES:
            launches[k] += delta[k]
        return out, delta

    def runner(sf, mesh_=None, dist_options=None, **props):
        name = _catalog(sf)
        return LocalRunner({name: cluster.catalogs[name]}, name,
                           session={"page_rows": MESH_PAGE_ROWS, **props},
                           device=dev, mesh=mesh_,
                           dist_options=dist_options)

    sf_of = dict(MESH_RUNS)
    oracle = (oracles or {}).get(sf_of[3])
    pool = None
    if oracle is None:
        pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
        oracle_future = pool.submit(_replay_oracles, sf_of[3])
    try:
        # (a) LocalRunner over the mesh
        readings = {}
        for q, sf in MESH_RUNS:
            text = sql("tpch", q)
            want, s_walls, s_peak = _mesh_timed(runner(sf), text)
            check_validated(q, sf, want)
            for label, opts in (("default", None), ("forced", MESH_FORCED)):
                r = runner(sf, mesh, opts)
                if not isinstance(r.executor, DistExecutor):
                    raise AssertionError("the mesh runner has no "
                                         "DistExecutor")
                cuda.reset_counts()
                (got, walls, peak), delta = counted(
                    lambda r=r: _mesh_timed(r, text))
                if not same_rows(got, want):
                    raise AssertionError(
                        f"mesh Q{q} SF {sf:g} {label}: rows != single "
                        f"process\n mesh {got[:3]}\n single {want[:3]}")
                for k in MESH_REQUIRED[q]:
                    if delta[k] <= 0:
                        raise AssertionError(f"mesh Q{q} {label}: {k} "
                                             f"never launched")
                extra = check_validated(q, sf, got)
                retries = r.executor.capacity_boost_retries
                log(f"mesh: Q{q} SF {sf:g} {label} x{MESH_SHARDS} shards: "
                    f"{len(got)} rows == single process{extra}, wall s "
                    f"{[round(w, 4) for w in walls]} (median "
                    f"{statistics.median(walls):.4f}; single process "
                    f"{statistics.median(s_walls):.4f}), peak alloc "
                    f"{peak / 2**30:.3f} GiB (single {s_peak / 2**30:.3f}), "
                    f"K1 launches per run {delta['segsum'] // (1 + TIMED_RUNS)}"
                    f", K4 {delta['part_ids'] // (1 + TIMED_RUNS)}, boost "
                    f"retries {retries}, mesh exchanges "
                    f"{r.executor.mesh_local_exchanges}")
                readings[(q, label)] = dict(
                    wall_s=walls, single_wall_s=s_walls, peak_bytes=peak,
                    launches=delta, boost_retries=retries)
                if q in (3, 5):
                    readings[(q, label)]["rows"] = got
        _mesh_profile(runner(sf_of[1], mesh, MESH_FORCED), sql("tpch", 1))
        # (b) skew
        mem = MemoryConnector(device=dev)
        cats = {"tpch": cluster.catalogs[_catalog(SKEW_SF)], "memory": mem}
        loader = LocalRunner(cats, "memory", device=dev,
                             session={"page_rows": MESH_PAGE_ROWS})
        n_fact = loader.execute(SKEW_FACT).rows[0][0]
        n_dim = loader.execute(SKEW_DIM).rows[0][0]
        if n_fact < SKEW_MIN_ROWS:
            raise AssertionError(f"skew fact holds {n_fact} rows < "
                                 f"{SKEW_MIN_ROWS}")

        def mem_runner(mesh_=None, opts=None, **props):
            return LocalRunner({"memory": mem}, "memory", device=dev,
                               mesh=mesh_, dist_options=opts,
                               session={"page_rows": MESH_PAGE_ROWS,
                                        **props})

        single_mem = mem_runner()
        forced = mem_runner(mesh, SKEW_FORCED)
        escape = mem_runner(mesh, join_distribution_type="broadcast")
        for label, text, r in (("aggregation", SKEW_AGG, forced),
                               ("repartitioned join", SKEW_JOIN, forced),
                               ("broadcast escape", SKEW_JOIN, escape)):
            t = time.perf_counter()
            want = single_mem.execute(text).rows
            torch.cuda.synchronize()
            s_wall = time.perf_counter() - t
            cuda.reset_counts()
            t = time.perf_counter()
            (res, delta) = counted(lambda r=r: r.execute(text).rows)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if not same_rows(res, want):
                raise AssertionError(f"mesh skew {label}: rows != single "
                                     f"process\n mesh {res[:3]}\n single "
                                     f"{want[:3]}")
            shards = (_exchange_shard_rows(r, text, "skew_fact")
                      if label != "broadcast escape" else None)
            hot = ""
            if label == "aggregation":
                hot_rows = next(row[1] for row in res if row[0] == 7)
                hot = (f", hot key {hot_rows} rows "
                       f"({100 * hot_rows / n_fact:.1f}%)")
            log(f"mesh: skew {label} over {n_fact} fact / {n_dim} dim "
                f"rows == single process{hot}, first-run wall {wall:.4f} s "
                f"(single process {s_wall:.4f}), boost retries "
                f"{r.executor.capacity_boost_retries}, fact rows per "
                f"shard after the repartition {shards}, K1 launches "
                f"{delta['segsum']}")
        # (c) the ICI plane over the DistCluster's workers
        from presto_tpu_torch.exec import xfer as XF

        local = cluster.local(ICI_SF, MESH_PAGE_ROWS)
        for q in ICI_QUERIES:
            text = sql("tpch", q)
            want = local.execute(text).rows
            per_mode = {}
            for mode in ICI_MODES:
                coord = cluster.coordinator(ICI_SF, MESH_PAGE_ROWS, {
                    **DIST_SESSION, "mesh_exchange_mode": mode})
                ex = coord.runner.executor
                cuda.reset_counts()
                k4_0 = cuda.launches.get("part_ids", 0)

                snaps, t0 = [], {}

                def runs(coord=coord):
                    out = []
                    for i in range(1 + TIMED_RUNS):
                        if i == TIMED_RUNS:
                            # the last run snapshots each stage barrier:
                            # the exchange phase's crossings from the
                            # transfer ledger
                            coord._stage_hook = lambda fid: snaps.append(
                                XF.process_totals())
                            t0.update(XF.process_totals())
                        out.append(_dist_run(coord, text)[:2])
                    coord._stage_hook = None
                    return out

                ici0 = (ex.ici_exchanges, ex.ici_bytes)
                if mode == "auto":
                    out, delta = counted(runs)
                else:
                    out = runs()
                k4 = cuda.launches.get("part_ids", 0) - k4_0
                rows = out[-1][0]
                walls = [w for _r, w in out[1:]]
                h2d = snaps[-2]["h2d_bytes"] - t0["h2d_bytes"]
                d2h = snaps[-2]["d2h_bytes"] - t0["d2h_bytes"]
                n_runs = 1 + TIMED_RUNS
                if not same_rows(rows, want):
                    raise AssertionError(f"ici Q{q} {mode}: rows != single"
                                         f" process")
                if mode == "auto":
                    if ex.ici_exchanges - ici0[0] < 1 or \
                            ex.mesh_exchange_fallbacks:
                        raise AssertionError(
                            f"ici Q{q} auto: {ex.ici_exchanges} exchanges, "
                            f"{ex.mesh_exchange_fallbacks} fallbacks")
                    if k4 <= 0:
                        raise AssertionError(f"ici Q{q}: K4 never "
                                             f"launched")
                per_mode[mode] = rows
                log(f"mesh: ici Q{q} SF {ICI_SF:g} x{N_WORKERS} workers "
                    f"mesh_exchange_mode={mode}: {len(rows)} rows == single "
                    f"process, wall s {[round(w, 4) for w in walls]} "
                    f"(median {statistics.median(walls):.4f}), ici "
                    f"exchanges {(ex.ici_exchanges - ici0[0]) // n_runs} "
                    f"per run, ici_bytes {(ex.ici_bytes - ici0[1]) // n_runs}"
                    f" per run, "
                    f"fallbacks {ex.mesh_exchange_fallbacks}, exchange "
                    f"phase h2d {h2d} B d2h {d2h} B, K4 launches per run "
                    f"{k4 // (1 + TIMED_RUNS)}")
                cluster.close_coordinators()
            if not same_rows(per_mode["auto"], per_mode["false"]):
                raise AssertionError(f"ici Q{q}: auto != false")
        hp = runner(sf_of[3], mesh, MESH_FORCED, hash_partition_count=2)
        cuda.reset_counts()
        (got, delta) = counted(lambda: hp.execute(sql("tpch", 3)).rows)
        if not same_rows(got, readings[(3, "forced")]["rows"]):
            raise AssertionError("mesh Q3 hash_partition_count=2 differs")
        log(f"mesh: Q3 SF {sf_of[3]:g} forced, hash_partition_count=2 "
            f"(rows to 2 of "
            f"{MESH_SHARDS} shards): {len(got)} rows == the other runs, "
            f"K1 launches {delta['segsum']}")
        if oracle is None:
            oracle = oracle_future.result()
        for q in (3, 5):
            for label in ("default", "forced"):
                PQ.compare_tpch(q, readings[(q, label)]["rows"], oracle[q],
                                PQ.TPCH_ORACLE[q][1])
        log(f"mesh: Q3 and Q5 SF {sf_of[3]:g} on the mesh == sqlite "
            f"(oracle load "
            f"{oracle['load_s']:.1f} s, total {oracle['total_s']:.1f} s)")
        log("mesh: " + json.dumps({
            f"Q{q} {label}": {k: v for k, v in r.items() if k != "rows"}
            for (q, label), r in readings.items()}))
        return launches
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)


# --------------------------------------------------------------- reuse
REUSE_SF = 10.0
REUSE_SMALL_SF = 1.0
REUSE_PAGE_ROWS = 1 << 20
# (a)'s queries: (q, sf); the fragment-hit run re-plans the same query
# written differently and runs it through the executor, which has no
# statement cache
REUSE_RUNS = ((1, REUSE_SF), (6, REUSE_SF), (5, REUSE_SMALL_SF))
# (b): a memory-connector copy of orders, its aggregation, and a join
# whose builds reach K3 (customer) and K2 (nation) with the generated
# join off
REUSE_ORDERS = ("select o_orderpriority, count(*), sum(o_totalprice) "
                "from memory.orders group by o_orderpriority "
                "order by o_orderpriority")
REUSE_JOIN = ("select n_name, count(*), sum(o_totalprice) "
              "from memory.orders join tpch.customer on o_custkey = "
              "c_custkey join tpch.nation on c_nationkey = n_nationkey "
              "group by n_name order by n_name")
REUSE_INSERT = ("insert into memory.orders select * from tpch.orders "
                "where o_orderkey < 1000")
# (c): the warm-start tier's directory (git-ignored, emptied first)
REUSE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_cache")
# (e): 8 clients of Q6 at REUSE_SF on the concurrent server
REUSE_CLIENTS = 8
REUSE_DENIED = "select count(*) from lineitem"


def _reuse_run(runner, text, via_executor: bool = False) -> dict:
    """One run from kernel counts 0: rows, wall, program launches,
    K1-K4 launches, the ledger's bytes and the cache counters."""
    from presto_tpu_torch import cuda

    ex = runner.executor
    c0 = {n: getattr(ex, n) for n in ("result_cache_hits",
                                      "result_cache_misses")}
    cuda.reset_counts()
    t0 = time.perf_counter()
    if via_executor:
        runner.apply_session()
        rows = ex.execute(runner.plan(text))[1]
    else:
        rows = runner.execute(text).rows
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(
        rows=rows, wall_s=round(wall, 4),
        program_launches=ex.program_launches,
        launches={k: cuda.launches.get(k, 0) for k in KERNEL_NAMES},
        h2d_bytes=ex.h2d_bytes, d2h_bytes=ex.d2h_bytes,
        hits=ex.result_cache_hits - c0["result_cache_hits"],
        misses=ex.result_cache_misses - c0["result_cache_misses"])


def _reuse_log(label: str, run: dict) -> None:
    log(f"reuse: {label}: " + json.dumps(
        {k: v for k, v in run.items() if k != "rows"}))


def _check_hit(label: str, run: dict, want, zero_bytes: bool) -> None:
    """A hit launches no program and no kernel, crosses no byte where
    ``zero_bytes``, and gives the uncached run's rows."""
    if run["hits"] < 1 or run["misses"]:
        raise AssertionError(f"reuse: {label}: not a hit: {run}")
    if run["program_launches"] or any(run["launches"].values()):
        raise AssertionError(f"reuse: {label}: a hit launched: {run}")
    if zero_bytes and (run["h2d_bytes"] or run["d2h_bytes"]):
        raise AssertionError(f"reuse: {label}: a hit crossed bytes: {run}")
    if not same_rows(run["rows"], want):
        raise AssertionError(f"reuse: {label}: rows != the uncached run")


def _reworded(text: str) -> str:
    """The same query written differently: a leading comment and
    collapsed whitespace (it plans to the same tree)."""
    return "-- reworded\n" + " ".join(text.split())


def phase_reuse(dev, cluster: "DistCluster", oracles=None) -> dict:
    """The result cache, the system catalog and plugins on the card:
    (a) Q1 and Q6 at SF 10 and Q5 at SF 1 on a single-process runner
    with result_cache_enabled: a miss, a statement hit (no program, no
    kernel, no byte), a fragment hit (the query reworded and run through
    the executor: the root fragment entry serves it); rows == the
    uncached run, val_q*_sf10.json and sqlite. (b) invalidation over a
    memory-connector copy of orders SF 1: miss, hit, INSERT, miss with
    the uncached run's rows; the same over a join with the generated
    join off (K2, K3 on the misses). (c) the warm-start tier: a fresh
    store over the same result_cache_persist_dir warm-loads and hits.
    (d) Q3 at SF 1 through the forced stage DAG over the 4 workers with
    the cache on (K4, == sqlite), then on the legacy dispatch with the
    fleet probe: the second run's leaf tasks are served by the workers'
    caches (cache_remote_hits). (e) a concurrent server (cache at its
    default, on) with a plugin's access control: Q6 SF 10 executed once,
    then from 8 clients at once (all hits, admitted without a slot),
    /metrics, system.runtime_queries, SHOW TABLES FROM system, and a
    statement the plugin denies. (f) Q1 at SF 10 on make_mesh(4): a miss
    then a root hit with zero crossings. Returns the misses' kernel
    launches."""
    import shutil
    import threading
    import urllib.request

    from presto_tpu_torch import cuda
    from presto_tpu_torch import queries as PQ
    from presto_tpu_torch.cache import shared_cache_if_exists
    from presto_tpu_torch.cache import store as STORE
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.dist.executor import make_mesh
    from presto_tpu_torch.obs import sanitizer as SAN
    from presto_tpu_torch.plugin import Plugin
    from presto_tpu_torch.runner import LocalRunner
    from presto_tpu_torch.security import AccessControl
    from presto_tpu_torch.server import PrestoTpuServer

    card = card_line()
    launches = {k: 0 for k in KERNEL_NAMES}

    def missed(run):
        for k in KERNEL_NAMES:
            launches[k] += run["launches"][k]

    def fresh_store():
        rc = shared_cache_if_exists()
        if rc is not None:
            rc.configure(persist_dir="")
            rc.clear()
        STORE._shared = None

    def runner(cats, catalog, **props):
        return LocalRunner(cats, catalog, device=dev, session={
            "page_rows": REUSE_PAGE_ROWS, **props})

    big = {"tpch": cluster.catalogs[_catalog(REUSE_SF)]}
    small = {"tpch": cluster.catalogs[_catalog(REUSE_SMALL_SF)]}
    oracle = (oracles or {}).get(REUSE_SMALL_SF)
    fresh_store()
    try:
        # ---- (a) single process: miss, statement hit, fragment hit
        for q, sf in REUSE_RUNS:
            cats = big if sf == REUSE_SF else small
            text = sql("tpch", q)
            want = runner(cats, "tpch").execute(text).rows
            note = check_validated(q, sf, want)
            if not note and oracle is not None and q in oracle:
                PQ.compare_tpch(q, want, oracle[q], PQ.TPCH_ORACLE[q][1])
                note = ", == sqlite"
            r = runner(cats, "tpch", result_cache_enabled="true")
            miss = _reuse_run(r, text)
            if miss["misses"] < 1 or not same_rows(miss["rows"], want):
                raise AssertionError(f"reuse: Q{q}: miss {miss}")
            missed(miss)
            stmt = _reuse_run(r, text)
            _check_hit(f"Q{q} statement hit", stmt, want, True)
            frag = _reuse_run(r, _reworded(text), via_executor=True)
            _check_hit(f"Q{q} fragment hit", frag, want, True)
            for label, run in (("miss", miss), ("statement hit", stmt),
                               ("fragment hit", frag)):
                _reuse_log(f"(a) Q{q} SF {sf:g} {label}", run)
            log(f"reuse: (a) Q{q} SF {sf:g}: {len(want)} rows == the "
                f"uncached run{note}; {card}")
        if launches["segsum"] <= 0:
            raise AssertionError("reuse: (a) K1 never launched")

        # ---- (b) invalidation through the memory connector
        mem = MemoryConnector(device=dev)
        cats = {**small, "memory": mem}
        loader = runner(cats, "memory")
        loader.execute("create table memory.orders as "
                       "select * from tpch.orders")
        for label, text, props in (
                ("aggregation", REUSE_ORDERS, {}),
                ("join, generated join off", REUSE_JOIN,
                 {"generated_join_enabled": "false"})):
            r = runner(cats, "memory", result_cache_enabled="true", **props)
            uncached = runner(cats, "memory", **props)
            want = uncached.execute(text).rows
            miss = _reuse_run(r, text)
            missed(miss)
            hit = _reuse_run(r, text)
            _check_hit(f"(b) {label} hit", hit, want, True)
            inv0 = r.executor.result_cache_invalidations
            r.execute(REUSE_INSERT)
            after = _reuse_run(r, text)
            missed(after)
            want2 = uncached.execute(text).rows
            if after["misses"] < 1 or after["hits"] or \
                    r.executor.result_cache_invalidations <= inv0 or \
                    not same_rows(after["rows"], want2) or \
                    same_rows(want2, want):
                raise AssertionError(f"reuse: (b) {label}: the write did "
                                     f"not invalidate: {after}")
            for name, run in (("miss", miss), ("hit", hit),
                              ("miss after INSERT", after)):
                _reuse_log(f"(b) {label} {name}", run)
            # the copy back at its loaded size for the next query
            loader.execute("delete from memory.orders "
                           "where o_orderkey < 1000")
            loader.execute("insert into memory.orders select * from "
                           "tpch.orders where o_orderkey < 1000")
        if launches["probe_dim"] <= 0 or launches["probe_radix"] <= 0:
            raise AssertionError(f"reuse: (b) K2/K3 never launched: "
                                 f"{launches}")

        # ---- (c) the warm-start tier
        shutil.rmtree(REUSE_DIR, ignore_errors=True)
        text = sql("tpch", 1)
        want = runner(big, "tpch").execute(text).rows
        fresh_store()
        first = runner(big, "tpch", result_cache_enabled="true",
                       result_cache_persist_dir=REUSE_DIR)
        miss = _reuse_run(first, text)
        missed(miss)
        fresh_store()  # the process's store gone, its directory kept
        second = runner(big, "tpch", result_cache_enabled="true",
                        result_cache_persist_dir=REUSE_DIR)
        warm = _reuse_run(second, text)
        _check_hit("(c) warm-loaded hit", warm, want, True)
        loads = second.executor.cache_warm_loads
        if loads < 1 or second.executor.cache_manifest_drops:
            raise AssertionError(f"reuse: (c) warm loads {loads}, drops "
                                 f"{second.executor.cache_manifest_drops}")
        _reuse_log("(c) Q1 persisted miss", miss)
        _reuse_log(f"(c) Q1 after a fresh store, {loads} warm loads", warm)
        fresh_store()

        # ---- (d) distributed: the stage DAG, then the fleet probe
        text = sql("tpch", 3)
        coord = cluster.coordinator(REUSE_SMALL_SF, REUSE_PAGE_ROWS, {
            **DIST_SESSION, "result_cache_enabled": "true"})
        cuda.reset_counts()
        t0 = time.perf_counter()
        rows = coord.execute(text)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k = {n: cuda.launches.get(n, 0) for n in KERNEL_NAMES}
        for n in KERNEL_NAMES:
            launches[n] += k[n]
        if coord.last_distribution != "stage-dag" or k["part_ids"] <= 0:
            raise AssertionError(f"reuse: (d) DAG {coord.last_distribution}"
                                 f", K4 {k['part_ids']}")
        if oracle is not None:
            PQ.compare_tpch(3, rows, oracle[3], PQ.TPCH_ORACLE[3][1])
        log(f"reuse: (d) Q3 SF {REUSE_SMALL_SF:g} stage DAG, cache on: "
            f"{len(rows)} rows{' == sqlite' if oracle else ''}, wall "
            f"{wall:.4f} s, launches {k}")
        probe = cluster.coordinator(REUSE_SMALL_SF, REUSE_PAGE_ROWS, {
            "result_cache_enabled": "true",
            "result_cache_remote_probe": "true",
            "generated_join_enabled": "false"})
        runs = []
        for i in range(2):
            if i:
                probe.heartbeat.check_once()  # the workers' blooms
            ex = probe.runner.executor
            h0 = ex.cache_remote_hits
            cuda.reset_counts()
            t0 = time.perf_counter()
            got = probe.execute(text)
            torch.cuda.synchronize()
            runs.append(dict(
                rows=got, wall_s=round(time.perf_counter() - t0, 4),
                distribution=probe.last_distribution,
                remote_hits=ex.cache_remote_hits - h0,
                launches={n: cuda.launches.get(n, 0)
                          for n in KERNEL_NAMES}))
            _reuse_log(f"(d) Q3 SF {REUSE_SMALL_SF:g} legacy dispatch, "
                       f"fleet probe, run {i + 1}", runs[-1])
        for n in KERNEL_NAMES:
            launches[n] += runs[0]["launches"][n]
        if runs[1]["remote_hits"] < 1 or runs[0]["remote_hits"] or \
                sorted(runs[1]["rows"]) != sorted(runs[0]["rows"]) or \
                sorted(runs[0]["rows"]) != sorted(rows):
            shown = [{k: v for k, v in r.items() if k != "rows"}
                     for r in runs]
            raise AssertionError(f"reuse: (d) fleet probe: {shown}")
        fresh_store()

        # ---- (e) the concurrent server: cache by default, a plugin
        class Deny(AccessControl):
            def check_can_select(self, user, catalog, table, columns):
                if user == "denied" and table == "lineitem":
                    self.deny(f"select from {table}")

        class DenyPlugin(Plugin):
            name = "deny"

            def access_control(self):
                return Deny()

        SAN.arm()
        SAN.reset()
        srv = PrestoTpuServer(big, "tpch", port=0, device=dev,
                              page_rows=REUSE_PAGE_ROWS,
                              memory_budget_bytes=SERVE_BUDGET,
                              plugins=[DenyPlugin()])
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            text = sql("tpch", 6)
            want = _json_rows(runner(big, "tpch").execute(text))
            m0 = _scrape(url)
            cuda.reset_counts()
            first, wall, _n = _client_run(
                StatementClient(url, user="dash0", catalog="tpch"), text)
            k = {n: cuda.launches.get(n, 0) for n in KERNEL_NAMES}
            for n in KERNEL_NAMES:
                launches[n] += k[n]
            out, errors = [None] * REUSE_CLIENTS, []

            def client(i):
                try:
                    res, w, _n = _client_run(StatementClient(
                        url, user=f"dash{i}", catalog="tpch"), text)
                    out[i] = (res.rows, w)
                except Exception as e:  # noqa: BLE001 - raised below
                    errors.append(repr(e))

            cuda.reset_counts()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(REUSE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            race_wall = time.perf_counter() - t0
            hit_launches = sum(cuda.launches.get(n, 0)
                               for n in KERNEL_NAMES)
            m1 = _scrape(url)
            if errors or any(o is None or o[0] != want for o in out) or \
                    first.rows != want:
                raise AssertionError(f"reuse: (e) rows: {errors[:3]}")
            delta = {n: m1[n] - m0.get(n, 0) for n in (
                "result_cache_hits_total", "result_cache_misses_total",
                "admission_cache_bypasses_total")}
            # the one execution misses at both levels (the statement
            # and its root fragment); every later client hits
            if delta["result_cache_misses_total"] != 2 or \
                    delta["result_cache_hits_total"] != REUSE_CLIENTS or \
                    delta["admission_cache_bypasses_total"] < \
                    REUSE_CLIENTS or hit_launches:
                raise AssertionError(f"reuse: (e) not one execution: "
                                     f"{delta}, hit launches {hit_launches}")
            c = StatementClient(url, catalog="tpch")
            queries = c.execute("select * from system.runtime_queries")
            tables = c.execute("show tables from system")
            if queries.error or len(queries.rows) < REUSE_CLIENTS + 1 or \
                    tables.error or ["runtime_queries"] not in tables.rows:
                raise AssertionError(f"reuse: (e) system: {queries.error} "
                                     f"{tables.error} {tables.rows}")
            denied = StatementClient(url, user="denied",
                                     catalog="tpch").execute(REUSE_DENIED)
            if denied.error is None or \
                    denied.error["errorName"] != "AccessDeniedError":
                raise AssertionError(f"reuse: (e) not denied: "
                                     f"{denied.error}")
            with urllib.request.urlopen(url + "/metrics", timeout=60) as f:
                metrics = f.read().decode()
            if "presto_tpu_result_cache_hits_total" not in metrics:
                raise AssertionError("reuse: (e) /metrics lacks the cache")
            log(f"reuse: (e) Q6 SF {REUSE_SF:g}: one execution ({wall:.4f} "
                f"s, launches {k}), then {REUSE_CLIENTS} clients at once in "
                f"{race_wall:.4f} s (walls "
                f"{[round(o[1], 4) for o in out]}), all hits with 0 "
                f"launches, rows == direct; /metrics deltas {delta}; "
                f"system.runtime_queries {len(queries.rows)} rows; SHOW "
                f"TABLES FROM system {len(tables.rows)} rows; the plugin "
                f"denied user 'denied': {denied.error['message']!r}")
        finally:
            srv.stop()
            violations = SAN.violation_count()
            report = SAN.report()
            SAN.disarm()
        if violations:
            raise AssertionError(f"reuse: (e) sanitizer: {report}")
        fresh_store()

        # ---- (f) the mesh: a miss, then a root hit
        text = sql("tpch", 1)
        want = runner(big, "tpch").execute(text).rows
        r = LocalRunner(big, "tpch", device=dev, mesh=make_mesh(4),
                        session={"page_rows": REUSE_PAGE_ROWS,
                                 "result_cache_enabled": "true"})
        miss = _reuse_run(r, text)
        missed(miss)
        hit = _reuse_run(r, text)
        _check_hit("(f) mesh root hit", hit, want, True)
        if not same_rows(miss["rows"], want):
            raise AssertionError("reuse: (f) mesh miss rows != uncached")
        check_validated(1, REUSE_SF, hit["rows"])
        _reuse_log(f"(f) Q1 SF {REUSE_SF:g} mesh x4 miss", miss)
        _reuse_log(f"(f) Q1 SF {REUSE_SF:g} mesh x4 root hit", hit)
    finally:
        fresh_store()
        shutil.rmtree(REUSE_DIR, ignore_errors=True)
    log(f"reuse: launches of the misses {launches}; {card}")
    return launches

STREAM_SF = 10.0
STREAM_PAGE_ROWS = 1 << 20
STREAM_COLUMNS = ("l_orderkey, l_linenumber, l_quantity, l_extendedprice, "
                  "l_discount, l_tax, l_returnflag, l_linestatus, "
                  "l_shipdate")
# (a): lineitem SF 10's order keys run to 60,000,000: the log is seeded
# with the keys <= 54,000,000 (about 90% of 59,994,468 rows), then
# STREAM_APPENDS INSERTs of 600,000 keys each (about 1%) complete it
STREAM_SEED_KEY = 54_000_000
STREAM_STEP = 600_000
STREAM_APPENDS = 10
# (c): the delta cursor's statement and the appends that land while
# both cursors tail: copies of the first three batches with
# l_linenumber + 8, so the log stays append-only with fresh rows
STREAM_DELTA_SQL = ("select l_orderkey, l_linenumber, l_quantity "
                    "from lineitem where l_quantity = 50")
STREAM_TAIL_APPENDS = 3
STREAM_POLL_MS = 400


def _stream_batch(i: int, linenumber: str = "l_linenumber") -> str:
    lo = STREAM_SEED_KEY + STREAM_STEP * i
    cols = STREAM_COLUMNS.replace("l_linenumber", linenumber, 1)
    return (f"select {cols} from tpch.lineitem where l_orderkey > {lo} "
            f"and l_orderkey <= {lo + STREAM_STEP}")


def _tail_post(url: str, text: str) -> dict:
    import urllib.request

    req = urllib.request.Request(
        url + "/v1/statement", data=text.encode(), method="POST",
        headers={"X-Presto-User": "tailer", "X-Presto-Catalog": "stream",
                 "X-Presto-Session": f"stream_tail_enabled=true,"
                                     f"stream_poll_ms={STREAM_POLL_MS}"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read().decode())


def _tail_get(uri: str, method: str = "GET") -> dict:
    import urllib.request

    req = urllib.request.Request(uri, method=method,
                                 headers={"X-Presto-User": "tailer"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read().decode())


def phase_stream(dev) -> dict:
    """The streaming plane on the card. (a) An append log of lineitem SF
    10's Q1 columns: CREATE TABLE AS of the order keys <= 54,000,000
    (about 54M rows, host arrays), then 10 INSERTs of about 1% each,
    until the log holds all of lineitem. (b) TPC-H Q1 over the log as a
    registered view: after each append a refresh (its wall, the delta
    rows it scanned == the rows appended, delta_pages_folded, its K1
    launches > 0, the ledger's h2d/d2h bytes) beside a cold recompute
    at the same offset (result_cache_enabled=false; rows equal, exact
    but for doubles at 9 digits); after the last append the refresh ==
    val_q1_sf10.json; a refresh under ivm_enabled=false counts one full
    recompute. (c) A server over the stream and tpch catalogs, the lock
    sanitizer armed: one client tails the Q1 view (view mode), one
    tails STREAM_DELTA_SQL (delta mode) while three appends land; the
    delta cursor delivers exactly the matching appended rows (count and
    checksum), the view cursor's changed groups rebuild the cold Q1 at
    the final offset, cursor_polls and stream_appends_seen count, 0
    sanitizer violations, DELETE ends both cursors. Returns the K1-K4
    launches of the refreshes, the cold runs and the server part."""
    import threading

    from presto_tpu_torch import cuda
    from presto_tpu_torch.connectors.stream import StreamConnector
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.exec import xfer as XF
    from presto_tpu_torch.obs import sanitizer as SAN
    from presto_tpu_torch.runner import LocalRunner
    from presto_tpu_torch.server import PrestoTpuServer
    from presto_tpu_torch.server.http_server import _json_row
    from presto_tpu_torch.streaming import ivm as IVM

    card = card_line()
    launches = {k: 0 for k in KERNEL_NAMES}

    def counted(fn, *a):
        """fn(*a) with the kernel counts from 0; adds its launches."""
        cuda.reset_counts()
        out = fn(*a)
        torch.cuda.synchronize()
        got = {k: cuda.launches.get(k, 0) for k in KERNEL_NAMES}
        for k in KERNEL_NAMES:
            launches[k] += got[k]
        return out, got

    SAN.arm()
    SAN.reset()
    try:
        log_conn = StreamConnector(device=dev)
        cats = {"tpch": TpchConnector(STREAM_SF, device=dev),
                "stream": log_conn}
        session = {"page_rows": STREAM_PAGE_ROWS,
                   "result_cache_enabled": "false"}
        runner = LocalRunner(cats, "stream", device=dev, session=session)
        cold = LocalRunner(cats, "stream", device=dev, session=session)
        text = sql("tpch", 1)

        # ---- (a) the seed
        t0 = time.perf_counter()
        seeded = runner.execute(
            f"create table stream.lineitem as "
            f"select {STREAM_COLUMNS} from tpch.lineitem "
            f"where l_orderkey <= {STREAM_SEED_KEY}").rows[0][0]
        seed_wall = time.perf_counter() - t0
        log(f"stream: (a) seed {seeded:,} rows in {seed_wall:.4f} s "
            f"(CREATE TABLE AS into host arrays); {card}")

        # ---- (b) Q1 as a view, refreshed after each append
        view = IVM.IvmRegistry().register(runner, "q1", text)
        if not view.ivm_safe:
            raise AssertionError(f"stream: Q1 not IVM-safe: "
                                 f"{view.unsafe_reason}")
        ex = runner.executor

        def refresh():
            x0 = XF.process_totals()
            f0 = ex.delta_pages_folded
            t = time.perf_counter()
            (_names, rows, _types), k = counted(
                IVM.refresh, view, runner.session, ex)
            wall = time.perf_counter() - t
            x1 = XF.process_totals()
            return rows, dict(
                wall_s=round(wall, 4), delta_rows=view.last_delta_rows,
                delta_pages_folded=ex.delta_pages_folded - f0,
                h2d_bytes=x1["h2d_bytes"] - x0["h2d_bytes"],
                d2h_bytes=x1["d2h_bytes"] - x0["d2h_bytes"], launches=k)

        rows, first = refresh()
        log(f"stream: (b) initial refresh over {seeded:,} rows: "
            f"{json.dumps(first)}")
        if first["delta_rows"] != seeded:
            raise AssertionError(f"stream: initial fold {first}")
        readings = []
        for i in range(STREAM_APPENDS):
            t = time.perf_counter()
            appended = runner.execute(
                "insert into stream.lineitem " + _stream_batch(i)
            ).rows[0][0]
            insert_wall = time.perf_counter() - t
            rows, r = refresh()
            t = time.perf_counter()
            want, k_cold = counted(lambda: cold.execute(text).rows)
            cold_wall = time.perf_counter() - t
            r.update(append=i + 1, appended=appended,
                     offset=log_conn.offset("lineitem"),
                     insert_wall_s=round(insert_wall, 4),
                     cold_wall_s=round(cold_wall, 4),
                     cold_k1=k_cold["segsum"])
            log(f"stream: (b) {json.dumps(r)}")
            if r["delta_rows"] != appended or appended <= 0:
                raise AssertionError(f"stream: delta rows {r}")
            if r["launches"]["segsum"] <= 0 or r["delta_pages_folded"] < 1:
                raise AssertionError(f"stream: no K1 on the fold {r}")
            if not same_rows(rows, want):
                raise AssertionError(f"stream: refresh {i + 1} != cold")
            readings.append(r)
        note = check_validated(1, STREAM_SF, rows)
        if ex.ivm_full_recomputes or ex.ivm_refreshes != STREAM_APPENDS + 1:
            raise AssertionError("stream: refresh counters "
                                 f"{ex.ivm_refreshes} "
                                 f"{ex.ivm_full_recomputes}")
        # ivm_enabled=false: one counted full recompute (a view of its
        # own, so the main view keeps its settled state)
        full_view = IVM.IvmRegistry().register(runner, "q1_full", text)
        runner.session.set("ivm_enabled", False)
        try:
            t = time.perf_counter()
            (_n, full_rows, _t), _k = counted(
                IVM.refresh, full_view, runner.session, ex)
            full_wall = time.perf_counter() - t
        finally:
            runner.session.unset("ivm_enabled")
        if ex.ivm_full_recomputes != 1 or not same_rows(full_rows, rows):
            raise AssertionError("stream: ivm_enabled=false refresh")
        refresh_walls = [r["wall_s"] for r in readings]
        cold_walls = [r["cold_wall_s"] for r in readings]
        log(f"stream: (b) {STREAM_APPENDS} appends: refresh walls "
            f"{refresh_walls} s against cold {cold_walls} s; final "
            f"offset {log_conn.offset('lineitem'):,}{note}; "
            f"ivm_enabled=false refresh {full_wall:.4f} s (1 full "
            f"recompute); {card}")

        # ---- (c) tailing cursors on a server
        srv = PrestoTpuServer(cats, "stream", port=0, device=dev,
                              page_rows=STREAM_PAGE_ROWS)
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            sex = srv._runner.executor
            IVM.shared_registry().register(srv._runner, "q1_tail", text)
            c0 = {n: getattr(sex, n) for n in (
                "cursor_polls", "stream_appends_seen", "ivm_refreshes",
                "delta_pages_folded")}
            cuda.reset_counts()
            t = time.perf_counter()
            vdoc = _tail_post(url, text)
            view_wall = time.perf_counter() - t
            t = time.perf_counter()
            ddoc = _tail_post(url, STREAM_DELTA_SQL)
            delta_wall = time.perf_counter() - t
            if "nextUri" not in vdoc or "nextUri" not in ddoc:
                raise AssertionError(f"stream: (c) not tailing: "
                                     f"{vdoc.get('error')} "
                                     f"{ddoc.get('error')}")
            vtypes = [c["type"] for c in vdoc["columns"]]
            dtypes = [c["type"] for c in ddoc["columns"]]
            snapshot = {tuple(r[:2]): r for r in vdoc["data"]}
            initial_delta = len(ddoc.get("data", []))
            log(f"stream: (c) initial snapshots: view {len(snapshot)} "
                f"groups in {view_wall:.4f} s, delta {initial_delta:,} "
                f"rows in {delta_wall:.4f} s "
                f"({initial_delta / delta_wall:,.0f} rows/s)")
            # the rows the appends must deliver, straight from tpch
            want_rows, want_view = [], None
            for i in range(STREAM_TAIL_APPENDS):
                res = cold.execute(
                    "select l_orderkey, l_linenumber + 8, l_quantity from "
                    + _stream_batch(i).split(" from ", 1)[1]
                    + " and l_quantity = 50")
                want_rows += [_json_row(r, dtypes) for r in res.rows]
            got = {"delta": [], "view": []}
            last = {}
            stop = threading.Event()
            errors = []

            def tail(kind, doc):
                try:
                    while not stop.is_set() and "nextUri" in doc:
                        doc = _tail_get(doc["nextUri"])
                        if doc.get("error"):
                            raise AssertionError(doc["error"])
                        if doc.get("data"):
                            got[kind].append(
                                (time.perf_counter(), doc["data"]))
                    last[kind] = doc
                except Exception as e:  # noqa: BLE001 - checked below
                    errors.append(f"{kind}: {e!r}")

            threads = [threading.Thread(target=tail, args=(k, d),
                                        daemon=True)
                       for k, d in (("view", vdoc), ("delta", ddoc))]
            for th in threads:
                th.start()
            appended_at = []
            for i in range(STREAM_TAIL_APPENDS):
                srv._runner.execute(
                    "insert into stream.lineitem "
                    + _stream_batch(i, "l_linenumber + 8"))
                appended_at.append(time.perf_counter())
                time.sleep(STREAM_POLL_MS / 1000.0)
            final = log_conn.offset("lineitem")
            want_view = [_json_row(r, vtypes)
                         for r in cold.execute(text).rows]
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and not errors:
                delivered = sum(len(d) for _t, d in got["delta"])
                rebuilt = dict(snapshot)
                for _t, page in got["view"]:
                    rebuilt.update({tuple(r[:2]): r for r in page})
                if delivered >= len(want_rows) and \
                        sorted(rebuilt.values()) == sorted(want_view):
                    break
                time.sleep(0.05)
            stop.set()
            for doc in (vdoc, ddoc):
                _tail_get(f"{url}/v1/statement/{doc['id']}", "DELETE")
            for th in threads:
                th.join(timeout=STREAM_POLL_MS / 100.0 + 30)
            k_srv = {k: cuda.launches.get(k, 0) for k in KERNEL_NAMES}
            for k in KERNEL_NAMES:
                launches[k] += k_srv[k]
            if errors or any(th.is_alive() for th in threads):
                raise AssertionError(f"stream: (c) tail errors {errors}")
            delta_rows = [tuple(r) for _t, d in got["delta"] for r in d]
            want_t = [tuple(r) for r in want_rows]
            if len(delta_rows) != len(want_t) or \
                    rows_checksum(delta_rows) != rows_checksum(want_t):
                raise AssertionError(
                    f"stream: (c) delta cursor {len(delta_rows)} rows, "
                    f"checksum {rows_checksum(delta_rows)}; want "
                    f"{len(want_t)}, {rows_checksum(want_t)}")
            changed = {tuple(r[:2]) for _t, d in got["view"] for r in d}
            if sorted(rebuilt.values()) != sorted(want_view) or not changed:
                raise AssertionError("stream: (c) the view cursor's "
                                     "groups do not rebuild Q1")
            for doc in last.values():
                # the page after the DELETE ends the cursor
                end = _tail_get(doc["nextUri"]) if "nextUri" in doc \
                    else doc
                if "nextUri" in end or end["stats"]["state"] != "CANCELED":
                    raise AssertionError(f"stream: (c) DELETE: {end}")
            c1 = {n: getattr(sex, n) - c0[n] for n in c0}
            if c1["cursor_polls"] < 2 or c1["stream_appends_seen"] < 1:
                raise AssertionError(f"stream: (c) counters {c1}")
            # each append's delivery: its first delta page after it
            lags = [round(min((t for t, _d in got["delta"] if t > a),
                              default=float("nan")) - a, 4)
                    for a in appended_at]
            log(f"stream: (c) {STREAM_TAIL_APPENDS} appends to offset "
                f"{final:,} while tailing: the delta cursor got "
                f"{len(delta_rows):,} rows == the matching appended rows "
                f"(checksum {rows_checksum(delta_rows)}), each append's "
                f"rows delivered {lags} s after it; the view "
                f"cursor sent {len(got['view'])} pages changing groups "
                f"{sorted(changed)} == cold Q1; counters {json.dumps(c1)}; "
                f"launches {k_srv}")
        finally:
            srv.stop()
    finally:
        violations = SAN.violation_count()
        report = SAN.report()
        SAN.disarm()
    if violations:
        raise AssertionError(f"stream: sanitizer: {report}")
    log(f"stream: sanitizer 0 violations; launches {launches}; {card}")
    return launches


CHAOS_SF = 1.0
CHAOS_ITERATIONS = 8
CHAOS_WORKERS = 2
# 2^16, not the harness's 2^13: Q5 SF 1 through the DAG ran 14.6-38.3 s
# a query at 2^13 on an H100 (PERF.md section 4)
CHAOS_PAGE_ROWS = 1 << 16
CHAOS_QUERIES = ("q3", "q5", "dag")
# the first six iterations' faults; the seeded draws pick the last two
CHAOS_COVER = ("delay", "drop", "kill", "submit-drop", "kill-nonleaf",
               "corrupt")
CHAOS_SESSION = {"stage_scheduler": "true"}
CHAOS_LOGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_chaos_logs")


def phase_chaos(dev) -> dict:
    """tools/chaos_torch.py's two runs on the card (the chaos line of the
    docstring's phase list). The harness prints each iteration's query,
    fault and wall; each child's stderr lands under CHAOS_LOGS. Returns
    the K1-K4 launches of this process (the oracle and the coordinator's
    root fragments)."""
    from presto_tpu_torch import cuda
    from tools import chaos_torch as CHAOS

    card = card_line()
    # the workers and coordinators load the libraries this build made:
    # a library's path is keyed by its source, so none rebuilds
    cuda.build()
    fresh_memory(dev)
    free0, total = torch.cuda.mem_get_info(dev)
    log(f"chaos: card memory free {free0:,} of {total:,} bytes before")
    common = ["--scale", str(CHAOS_SF), "--workers", str(CHAOS_WORKERS),
              "--page-rows", str(CHAOS_PAGE_ROWS), "--device", dev.type,
              "--sanitize", "--log-dir", CHAOS_LOGS]
    cuda.reset_counts()
    t0 = time.perf_counter()
    rep_a = CHAOS.run_faults(
        CHAOS.parse_args(["--seed", "0", "--iterations",
                          str(CHAOS_ITERATIONS)] + common),
        names=CHAOS_QUERIES, cover=CHAOS_COVER, session=CHAOS_SESSION)
    wall_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep_b = CHAOS.run_kill_coordinator(CHAOS.parse_args(
        ["--mode", "kill-coordinator", "--iterations", "1"] + common))
    wall_b = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: cuda.launches.get(k, 0) for k in KERNEL_NAMES}
    # this process's own cache goes too: what stays is what a child left
    fresh_memory(dev)
    free1, _ = torch.cuda.mem_get_info(dev)
    log(f"chaos: card memory free {free1:,} of {total:,} bytes after")
    by_mode = collections.defaultdict(list)
    for it in rep_a["iterations"] + rep_b["iterations"]:
        by_mode[it["mode"]].append(round(it["wall_s"], 4))
    workers = {k: rep_a["worker_kernel_launches"].get(k, 0)
               + rep_b["worker_kernel_launches"].get(k, 0)
               for k in KERNEL_NAMES}
    log(f"chaos: (a) {wall_a:.1f} s, (b) {wall_b:.1f} s; walls by mode "
        f"{json.dumps(by_mode)}; worker boots "
        f"{[round(x, 2) for x in rep_a['worker_boot_s'] + rep_b['worker_boot_s']]}"
        f" s, reboots {[round(x, 2) for x in rep_a['worker_reboot_s']]} "
        f"s; re-attach {[round(x, 4) for x in rep_b['reattach_s']]} s; "
        f"task_retries {rep_a['task_retries']}, nonleaf_replays "
        f"{rep_a['nonleaf_replays']}, workers_excluded "
        f"{rep_a['workers_excluded']}, coordinator_reattaches "
        f"{rep_b['coordinator_reattaches']}; sanitizer violations "
        f"{rep_a['violations'] + rep_b['violations']}; launches here "
        f"{launches}, in the workers {workers}; {card}")
    problems = []
    if rep_a["failures"] or rep_b["failures"]:
        problems.append(f"{rep_a['failures']} + {rep_b['failures']} "
                        f"failed iterations or violations")
    seen = {it["mode"] for it in rep_a["iterations"]}
    if not set(CHAOS_COVER) <= seen:
        problems.append(f"faults not visited: {set(CHAOS_COVER) - seen}")
    if rep_a["nonleaf_replays"] < 1:
        problems.append("no nonleaf_replays in (a)")
    if rep_b["coordinator_reattaches"] < 1:
        problems.append("no coordinator_reattaches in (b)")
    if rep_a["violations"] or rep_b["violations"]:
        problems.append("sanitizer violations")
    if workers["part_ids"] < 1:
        problems.append("the workers launched no K4")
    if launches["segsum"] < 1:
        problems.append("this process launched no K1")
    if problems:
        raise AssertionError(f"chaos: {'; '.join(problems)} (logs under "
                             f"{CHAOS_LOGS})")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from presto_tpu_torch import cuda

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind}; {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    secs = cuda.build()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f} s")

    walls = {}
    cluster = None
    def timed(name, fn, *a):
        """Run one phase and log its wall."""
        t = time.perf_counter()
        out = fn(*a)
        walls[name] = round(time.perf_counter() - t, 1)
        log(f"{name}: phase wall {walls[name]} s")
        if cluster is not None:
            cluster.close_coordinators()
        return out

    gen = torch.Generator().manual_seed(20261016)
    measured = {}
    if "kernels" in phases:
        t = time.perf_counter()
        k1 = check_segsum(gen, dev)
        measured["segsum"] = k1[8]  # Q1's shape
        dim_t1 = check_probe(gen, dev, 64)  # nation/region: one tile
        check_probe(gen, dev, 2048)  # the largest dim layout: 32 tiles
        measured["probe_dim"] = dim_t1
        measured["probe_radix"] = check_probe(gen, dev, 1 << 20)
        measured["part_ids"] = check_part_ids(gen, dev)[1]  # one key
        check_float_sums(gen, dev)
        walls["kernels"] = round(time.perf_counter() - t, 1)
    cpu_dispatch = {}  # the kernels the CPU runs dispatched, per query
    if "check" in phases:
        cpu_dispatch.update(timed("check", phase_check, dev))
    # the sqlite oracles of dist and surface load in two child processes
    # from here on, beside the card's phases (each took 85-100 s of host
    # time that its phase waited for): beside `fused` and `scale`, whose
    # readings share the host with them (PERF.md section 4); started
    # after `scale`, they kept `dist` waiting on a slow host
    oracle_children = None
    if phases & {"dist", "surface"}:
        import concurrent.futures
        import multiprocessing

        oracle_children = concurrent.futures.ProcessPoolExecutor(
            max_workers=2, mp_context=multiprocessing.get_context("spawn"))
        oracle_futures = {
            name: oracle_children.submit(fn, sf)
            for name, fn, sf in (
                ("dist", _replay_oracles, REPLAY_SF),
                ("surface", _surface_oracles, SURFACE_ORACLE_SF))
            if name in phases}
    # launches: the sum over the main paths that ran (the single-process
    # scale runs, the distributed runs, the governed and the OOM-ladder
    # runs), each counted from 0
    launches = {k: None for k in KERNEL_NAMES}
    try:
        if phases & {"fused", "dist", "surface", "profile", "analyze",
                     "serve", "mesh", "reuse"}:
            cluster = DistCluster(dev, (0.01, 1.0, 10.0))
        # fused before scale: the scale runs' required kernels come from
        # the check and fused phases' CPU runs
        if "fused" in phases:
            cpu_dispatch.update(timed("fused", phase_fused, dev, cluster))
        if "scale" in phases:
            launches = timed("scale", phase_scale, dev, cpu_dispatch)
        oracles = {}  # sqlite's answers by SF, the dist phase's for mesh
        if "dist" in phases:
            dist = timed("dist", phase_dist, dev, cluster, oracles,
                         oracle_futures["dist"])
            launches = {k: (launches[k] or 0) + dist[k]
                        for k in KERNEL_NAMES}
        if "surface" in phases:
            sur = timed("surface", phase_surface, dev, cluster,
                        oracle_futures["surface"])
            launches = {k: (launches[k] or 0) + sur[k]
                        for k in KERNEL_NAMES}
        if "statements" in phases:
            st = timed("statements", phase_statements, dev)
            launches = {k: (launches[k] or 0) + st[k]
                        for k in KERNEL_NAMES}
        if "governed" in phases:
            gov = timed("governed", phase_governed, dev)
            launches = {k: (launches[k] or 0) + gov[k]
                        for k in KERNEL_NAMES}
        if "oom" in phases:
            oom = timed("oom", phase_oom, dev)
            launches = {k: (launches[k] or 0) + oom[k]
                        for k in KERNEL_NAMES}
        if "analyze" in phases:
            ana = timed("analyze", phase_analyze, dev, cluster)
            launches = {k: (launches[k] or 0) + ana[k]
                        for k in KERNEL_NAMES}
        if "serve" in phases:
            srv = timed("serve", phase_serve, dev, cluster)
            launches = {k: (launches[k] or 0) + srv[k]
                        for k in KERNEL_NAMES}
        if "mesh" in phases:
            msh = timed("mesh", phase_mesh, dev, cluster, oracles)
            launches = {k: (launches[k] or 0) + msh[k]
                        for k in KERNEL_NAMES}
        if "reuse" in phases:
            reu = timed("reuse", phase_reuse, dev, cluster, oracles)
            launches = {k: (launches[k] or 0) + reu[k]
                        for k in KERNEL_NAMES}
        if "stream" in phases:
            stm = timed("stream", phase_stream, dev)
            launches = {k: (launches[k] or 0) + stm[k]
                        for k in KERNEL_NAMES}
        if "chaos" in phases:
            cha = timed("chaos", phase_chaos, dev)
            launches = {k: (launches[k] or 0) + cha[k]
                        for k in KERNEL_NAMES}
        if "profile" in phases:
            timed("profile", phase_profile, dev, cluster)
    finally:
        if cluster is not None:
            cluster.stop()
        if oracle_children is not None:
            oracle_children.shutdown(cancel_futures=True)

    replaces = {
        "segsum": "presto_tpu/ops/pallas_agg.py:71",
        "probe_dim": "presto_tpu/ops/pallas_join.py:262",
        "probe_radix": "presto_tpu/ops/pallas_join.py:371",
        "part_ids": "presto_tpu/dist/spool.py:243",
    }
    source = {
        "segsum": "presto_tpu_torch/csrc/segsum.cu",
        "probe_dim": "presto_tpu_torch/csrc/hash_probe.cu",
        "probe_radix": "presto_tpu_torch/csrc/hash_probe.cu",
        "part_ids": "presto_tpu_torch/csrc/part_ids.cu",
    }
    kernels = []
    for name in KERNEL_NAMES:
        m = measured.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": m.get("max_abs_err"), "ms": m.get("ms"),
            "plain_ms": m.get("plain_ms"), "bound_ms": m.get("bound_ms"),
            "bound_by": "bytes", "library_ms": m.get("library_ms"),
            "call_ms": m.get("call_ms"),
        })
    log(f"phase walls s: {json.dumps(walls)}; script "
        f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
