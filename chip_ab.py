"""Compare query walls of presto_tpu_torch between two checkouts on one
card.

    python3 chip_ab.py DIR_A DIR_B

Each DIR is the root of a checkout of the repo (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory). The
script runs A, B, B, A four times over, each in a fresh process in that
checkout: the kernels build from its sources, then TPC-H Q1 at SF 10
runs under the default session three times over, each time from a new
CUDA-graph capture (the program cache cleared, one warm-up that
captures, five timed runs), and once under the eager session; then the
host-bound TPC-H queries of HOST_BOUND run at SF 1 under both sessions
(one warm-up, five timed runs each). A wall is the host clock around
``execute``, ending in ``torch.cuda.synchronize()``. Q1 SF 10 default's
wall is bimodal, so the script prints every wall, the median of each
capture, the medians per checkout, and the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

ROUNDS = 4
CAPTURES = 3
RUNS = 5
HOST_BOUND = (11, 13, 15, 16, 20)

CHILD = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
from presto_tpu_torch import cuda
cuda.build()
from presto_tpu_torch import queries as PQ
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.exec import graphs
from presto_tpu_torch.runner import LocalRunner

captures, runs = int(sys.argv[1]), int(sys.argv[2])
host_bound = json.loads(sys.argv[3])
sessions = {"default": {}, "eager": {"generated_join_enabled": "false",
                                     "tpu_offload_enabled": "false"}}


def runner(sf, mode):
    return LocalRunner({"tpch": TpchConnector(sf)},
                       session={"page_rows": 1 << 20, **sessions[mode]})


def timed(r, q):
    r.execute(PQ.TPCH_SQL[q])  # warm-up (a capture on a cleared cache)
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        r.execute(PQ.TPCH_SQL[q])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


out = {"Q1 SF 10 default": [], "Q1 SF 10 eager": []}
r = runner(10.0, "default")
for _ in range(captures):
    graphs.clear()
    out["Q1 SF 10 default"].append(timed(r, 1))
out["Q1 SF 10 eager"].append(timed(runner(10.0, "eager"), 1))
for mode in sessions:
    r = runner(1.0, mode)
    for q in host_bound:
        out[f"Q{q} SF 1 {mode}"] = [timed(r, q)]
print("RESULT " + json.dumps(out))
'''


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    dir_a, dir_b = sys.argv[1:]
    walls: dict = {}
    for d in [dir_a, dir_b, dir_b, dir_a] * ROUNDS:
        p = subprocess.run(
            [sys.executable, "-c", CHILD, str(CAPTURES), str(RUNS),
             json.dumps(HOST_BOUND)],
            cwd=d, capture_output=True, text=True, timeout=600)
        line = [ln for ln in p.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if not line:
            print(f"{d}: failed\n{p.stderr[-3000:]}", file=sys.stderr)
            return 1
        for key, caps in json.loads(line[0][len("RESULT "):]).items():
            walls.setdefault(key, {}).setdefault(d, []).append(caps)
            print(f"{d} {key}: "
                  + "; ".join(f"{[round(w, 4) for w in ws]} median "
                              f"{statistics.median(ws):.4f}"
                              for ws in caps), flush=True)
    for key, by in walls.items():
        for d, procs in by.items():
            meds = [[round(statistics.median(ws), 4) for ws in caps]
                    for caps in procs]
            every = [w for caps in procs for ws in caps for w in ws]
            print(f"{key} {d}: medians per process "
                  f"{meds}, all runs median "
                  f"{statistics.median(every):.4f}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
