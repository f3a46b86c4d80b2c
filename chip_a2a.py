"""Time the two layouts of the mesh's all_to_all on one card.

    python3 chip_a2a.py [ROUNDS]

presto_tpu_torch/dist/executor.py's ``_all_to_all`` picks its layout by
the mesh's devices: shards that share one device land through ONE
stable sort of the concatenated senders; shards on different devices
build each sender's [D, R] send layout and concatenate the j-th slice
of every sender on receiver j. This script runs both on the card at the
mesh phase's shapes (chip_smoke.py, 4 shards, pages of 2^20 rows) and
prints their times side by side. The second layout is reached on one
card by naming it twice in the device list (``cuda:0`` and ``cuda``):
the devices differ as names, so the layout is chosen, and every peer
copy is a no-op, as it would be for shards that share a card.

Two shapes, each from chip_smoke.py's mesh phase:

  repartition  _repartition_fn: 4 senders of 2^20 rows, landing
               capacity 2^21 (min(D R, 2 R boost))
  ici          _ici_program: one 2^20-row page sliced into 4 senders,
               landing capacity exchange_partition_cap(2^20, 4, 1)

The page has 6 columns (3 bigint, 2 double, 1 integer with 10% NULLs),
95% of its rows valid, keys drawn uniformly. Each layout's time is the
median of ROUNDS (default 20) calls, each timed by CUDA events around
it after 3 warm-up calls, taken in the order sort, send, send, sort.
The two layouts' landing pages and counts must be equal. The last line
is one JSON object with every time; the line before it is the card's
name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from presto_tpu_torch import interop
from presto_tpu_torch.dist import executor as DX
from presto_tpu_torch.exec import shapes as SH

D = 4
R = 1 << 20


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def make_page(rows: int, dev, rng):
    nulls = rng.random(rows) < 0.10
    return interop.page_from_numpy(
        columns=[rng.integers(0, 1 << 40, rows), rng.integers(-5, 5, rows),
                 rng.integers(0, 1 << 20, rows), rng.random(rows),
                 rng.random(rows) * 1e6,
                 rng.integers(0, 1 << 30, rows).astype(np.int32)],
        valid=rng.random(rows) < 0.95,
        nulls=[None, None, None, None, None, nulls],
        dictionaries=[None] * 6,
        types=["bigint", "bigint", "bigint", "double", "double", "integer"],
        device=dev)


def targets(senders):
    return [torch.where(s.valid, DX.u64.umod(DX._key_hash(s, (0,)), D), D)
            for s in senders]


def time_ms(fn, rounds: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def landed(out):
    pages, nums = out
    return ([interop.page_arrays(p) for p in pages], nums.cpu().tolist())


def same(x, y) -> bool:
    (pa, na), (pb, nb) = x, y
    if na != nb:
        return False
    for a, b, n in zip(pa, pb, na):
        keep = min(n, len(a["valid"]))
        for ca, cb in zip(a["columns"], b["columns"]):
            if not np.array_equal(ca[:keep], cb[:keep]):
                return False
        if not np.array_equal(a["valid"], b["valid"]):
            return False
    return True


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_a2a: no card", file=sys.stderr)
        return 1
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    dev = torch.device("cuda", 0)
    one = (dev,) * D
    two = tuple(dev if j % 2 == 0 else torch.device("cuda")
                for j in range(D))
    rng = np.random.default_rng(0)
    shapes = {
        "repartition": ([make_page(R, dev, rng) for _ in range(D)],
                        min(D * R, 2 * R)),
        "ici": ([DX.slice_page(make_page(R, dev, rng), j * (R // D),
                               R // D) for j in range(D)],
                SH.exchange_partition_cap(R, D, 1)),
    }
    result = {}
    for name, (senders, out_cap) in shapes.items():
        tgts = targets(senders)

        def run(devs):
            return DX._all_to_all(senders, tgts, devs, out_cap)

        if not same(landed(run(one)), landed(run(two))):
            raise AssertionError(f"{name}: the layouts land different rows")
        sort1 = time_ms(lambda: run(one), rounds)
        send1 = time_ms(lambda: run(two), rounds)
        send2 = time_ms(lambda: run(two), rounds)
        sort2 = time_ms(lambda: run(one), rounds)
        result[name] = dict(
            senders=D, sender_rows=senders[0].capacity, out_cap=out_cap,
            sort_ms=[sort1, sort2], send_layout_ms=[send1, send2])
        print(f"{name}: {D} senders x {senders[0].capacity} rows -> "
              f"{out_cap}: one sort {sort1:.4f} / {sort2:.4f} ms, send "
              f"layout {send1:.4f} / {send2:.4f} ms", flush=True)
    print(card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
