"""Compare the distributed rungs of presto_tpu_torch between two
checkouts on one card, and rehearse the worker's accept queue.

    python3 chip_ab_dist.py DIR_A DIR_B
    python3 chip_ab_dist.py --rehearse DIR [RUNS]   # the rehearsal alone

Each DIR is the root of a checkout of the repo (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory). The
script runs A, B, B', B', B, A, each in a fresh process in that
checkout, where B' is DIR_B with Nagle's algorithm back on in the
workers' HTTP handlers (``disable_nagle_algorithm`` False, as before
the port turned it off): the kernels build from its sources, 4 in-process
WorkerServers start on the card, and chip_smoke.py's dist rungs run
through a DcnRunner under its DIST_SESSION (partitioned joins, the
exchange on the card, the generated join off), page_rows 2^20: Q1 at
SF 10, Q3 and Q5 at SF 1. Each query runs under every variant the
checkout has, one warm-up each, then RUNS rounds that take the
variants in turn (a new coordinator per variant):

  default        the session as it is
  adaptive off   adaptive_execution=false (no stage-boundary re-plan)
  retries 0      task_retry_attempts=0 (eager acks, no heartbeat gate)
  no heartbeat   the coordinator's heartbeat thread stopped at once

A checkout without the re-planner or the heartbeat (one from before
they were ported), and B', run ``default`` alone. A wall is the host clock
around ``execute``, ending in ``torch.cuda.synchronize()``. Every
variant's rows must equal the default's. Each B process also prints
the adaptive counters of its default runs.

Then the accept-queue rehearsal, twice in DIR_B: the workers' listen
backlog set to 5 (socketserver's default), then to 128 (the port's),
with STALE_COORDS coordinators left open (their heartbeat threads
pinging every worker each second, as unclosed coordinators did before
each phase closed its own), and Q3 and Q5 at SF 1 run with a worker
stopped after stage 0 and restarted, FAULTED_RUNS (or RUNS) times
each. Each run prints its wall, the delta of TcpExt ListenOverflows
and ListenDrops (read-only, /proc/net/netstat; empty where the file
is not readable) and its HTTP connects that reached themselves (a
local address equal to the peer's). A run past 15 s writes every
thread's stack, the url/uri of each frame and the /proc/net/tcp rows
of the workers' ports to chiprun_out/stall_*.txt. The script ends
with the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

RUNS = 3
STALE_COORDS = 24
FAULTED_RUNS = 3

COMMON = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
from presto_tpu_torch import cuda
cuda.build()
from presto_tpu_torch import queries as PQ
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.dcn import DcnRunner
from presto_tpu_torch.server import worker as W

dev = torch.device("cuda")
SESSION = {"join_distribution_type": "partitioned",
           "device_exchange_enabled": "true",
           "generated_join_enabled": "false", "page_rows": 1 << 20}


def catalog(sf):
    return "tpch_sf" + f"{sf:g}".replace(".", "_")


def start_workers(catalogs):
    ws = [W.WorkerServer(catalogs, node_id=f"w{i}", device=dev)
          for i in range(4)]
    for w in ws:
        w.start()
    return ws


def coordinator(catalogs, workers, sf, **props):
    name = catalog(sf)
    return DcnRunner({name: catalogs[name]}, [w.uri for w in workers],
                     default_catalog=name, device=dev,
                     session_props={**SESSION, **props})


def close(c):
    if hasattr(c, "close"):
        c.close()


def timed(c, q):
    t0 = time.perf_counter()
    rows = c.execute(PQ.TPCH_SQL[q])
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0
'''

AB_CHILD = COMMON + r'''
runs, nagle = int(sys.argv[1]), sys.argv[2] == "nagle"
variants = {"default": {}}
if nagle:
    W._WorkerHandler.disable_nagle_algorithm = False
elif hasattr(DcnRunner, "close"):  # the heartbeat and the re-planner
    variants.update({"adaptive off": {"adaptive_execution": "false"},
                     "retries 0": {"task_retry_attempts": 0},
                     "no heartbeat": {}})
scales = (10.0, 1.0)
catalogs = {catalog(sf): TpchConnector(sf, device=dev) for sf in scales}
workers = start_workers(catalogs)
ADAPTIVE = ("adaptive_replans", "adaptive_capacity_seeds",
            "adaptive_dist_flips", "adaptive_replan_rejected")
out, counters = {}, {}
try:
    for q, sf in ((1, 10.0), (3, 1.0), (5, 1.0)):
        coords = {}
        for v, p in variants.items():
            coords[v] = coordinator(catalogs, workers, sf, **p)
            if v == "no heartbeat":
                coords[v].heartbeat.stop()
        want, _ = timed(coords["default"], q)  # warm-up
        for v in variants:
            if v != "default":
                rows, _ = timed(coords[v], q)
                assert rows == want, (q, v)
        ex = coords["default"].runner.executor
        before = {k: getattr(ex, k, 0) for k in ADAPTIVE}
        names = list(variants)
        for r in range(runs):
            for v in names[r % len(names):] + names[:r % len(names)]:
                rows, wall = timed(coords[v], q)
                assert rows == want, (q, v)
                out.setdefault(f"Q{q} SF {sf:g}", {}).setdefault(
                    v, []).append(wall)
        counters[f"Q{q} SF {sf:g}"] = {
            k: getattr(ex, k, 0) - before[k] for k in ADAPTIVE}
        for c in coords.values():
            close(c)
finally:
    for w in workers:
        w.stop()
print("RESULT " + json.dumps({"walls": out, "adaptive": counters,
                              "variants": list(variants)}))
'''

LISTEN_CHILD = COMMON + r'''
import http.client, threading, traceback

backlog, stale, runs = (int(a) for a in sys.argv[1:4])
W._TrackingHTTPServer.request_queue_size = backlog
STALL_S = 15.0

# every HTTP connect of the process (the coordinators' requests, the
# workers' fetches, the heartbeats): one whose local address equals
# its peer's connected to itself, a port no longer listening
self_connects = [0]
_connect = http.client.HTTPConnection.connect


def connect(conn):
    _connect(conn)
    try:
        if conn.sock.getsockname() == conn.sock.getpeername():
            self_connects[0] += 1
    except OSError:
        pass


http.client.HTTPConnection.connect = connect
current = {"t0": None, "label": "", "dumped": False}


def tcp_rows(ports):
    """/proc/net/tcp rows (read only) that touch a worker's port."""
    try:
        with open("/proc/net/tcp") as f:
            rows = [ln.split() for ln in f][1:]
    except OSError:
        return ["/proc/net/tcp unreadable"]
    out = []
    for r in rows:
        lp, rp = (int(a.split(":")[1], 16) for a in r[1:3])
        if lp in ports or rp in ports:
            out.append(f"{lp} -> {rp} state {r[3]}")
    return out


def watchdog():
    """A run past STALL_S: every thread's stack, the url/uri locals of
    its frames, and the worker ports' sockets, into chiprun_out."""
    while True:
        time.sleep(1.0)
        t0 = current["t0"]
        if t0 is None or current["dumped"] \
                or time.perf_counter() - t0 < STALL_S:
            continue
        current["dumped"] = True
        path = f"chiprun_out/stall_{current['label']}.txt"
        with open(path, "w") as f:
            f.write(f"worker ports {ports}\n")
            for tid, frame in sys._current_frames().items():
                f.write(f"--- thread {tid}\n")
                f.write("".join(traceback.format_stack(frame)))
                fr = frame
                while fr is not None:
                    for k in ("url", "uri"):
                        v = fr.f_locals.get(k)
                        if isinstance(v, str):
                            f.write(f"  {fr.f_code.co_name}: {k}={v}\n")
                    fr = fr.f_back
            f.write("\n".join(tcp_rows(set(ports))) + "\n")
        print(f"stall past {STALL_S} s: stacks in {path}", flush=True)


def netstat():
    try:
        with open("/proc/net/netstat") as f:
            lines = [ln.split() for ln in f]
    except OSError:
        return {}
    for head, vals in zip(lines[::2], lines[1::2]):
        if head[0] == "TcpExt:":
            d = dict(zip(head[1:], map(int, vals[1:])))
            return {k: d.get(k, 0) for k in ("ListenOverflows",
                                              "ListenDrops")}
    return {}


catalogs = {catalog(1.0): TpchConnector(1.0, device=dev)}
workers = start_workers(catalogs)
ports = [w.port for w in workers]
stale_coords = [coordinator(catalogs, workers, 1.0) for _ in range(stale)]
threading.Thread(target=watchdog, daemon=True).start()
out = []
try:
    for q in (3, 5):
        c = coordinator(catalogs, workers, 1.0, retry_backoff_ms=20)
        want, _ = timed(c, q)  # warm-up, fault-free
        for i in range(runs):
            c._stage_hook = lambda fid: fid == 0 and workers[1].stop()
            n0, s0 = netstat(), self_connects[0]
            current.update(t0=time.perf_counter(), dumped=False,
                           label=f"backlog{backlog}_q{q}_{i}")
            rows, wall = timed(c, q)
            current["t0"] = None
            n1 = netstat()
            c._stage_hook = None
            assert rows == want, q
            ex = c.runner.executor
            out.append({"q": q, "wall_s": wall,
                        "delta": {k: n1[k] - n0[k] for k in n1},
                        "self_connects": self_connects[0] - s0,
                        "task_retries": ex.task_retries})
            print(f"backlog {backlog}: Q{q} SF 1 worker stopped after "
                  f"stage 0: wall {wall:.4f} s, netstat delta "
                  f"{out[-1]['delta']}, self-connects "
                  f"{out[-1]['self_connects']}", flush=True)
            workers[1] = W.WorkerServer(catalogs, port=ports[1],
                                        node_id="w1", device=dev)
            workers[1].start()
            time.sleep(c.heartbeat.interval_s)  # the probe's rate limit
        close(c)
finally:
    for c in stale_coords:
        close(c)
    for w in workers:
        w.stop()
print("RESULT " + json.dumps(out))
'''


def child(code, cwd, *args):
    p = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                       cwd=cwd, capture_output=True, text=True,
                       timeout=900)
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    if not line:
        print(f"{cwd}: failed\n{p.stdout[-2000:]}\n{p.stderr[-4000:]}",
              file=sys.stderr)
        return None
    for ln in p.stdout.splitlines():
        if not ln.startswith("RESULT "):
            print(ln, flush=True)
    return json.loads(line[0][len("RESULT "):])


def main() -> int:
    if sys.argv[1:2] == ["--rehearse"] and len(sys.argv) in (3, 4):
        return rehearse(sys.argv[2], int(sys.argv[3]) if len(sys.argv) == 4
                        else FAULTED_RUNS)
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    dir_a, dir_b = sys.argv[1:]
    walls: dict = {}
    a, b, b_nagle = (dir_a, "-"), (dir_b, "-"), (dir_b, "nagle")
    for i, (d, nagle) in enumerate([a, b, b_nagle, b_nagle, b, a]):
        name = {a: "A", b: "B", b_nagle: "B'"}[(d, nagle)]
        res = child(AB_CHILD, d, RUNS, nagle)
        if res is None:
            return 1
        for key, by in res["walls"].items():
            for v, ws in by.items():
                walls.setdefault(key, {}).setdefault(
                    (name, v), []).append(ws)
                print(f"process {i} {name} {key} {v}: "
                      f"{[round(w, 4) for w in ws]}", flush=True)
        if name == "B":
            print(f"process {i} B adaptive counters of the default "
                  f"runs: {res['adaptive']}", flush=True)
    for key, by in walls.items():
        for (d, v), procs in by.items():
            every = [w for ws in procs for w in ws]
            print(f"{key} {d} {v}: medians per process "
                  f"{[round(statistics.median(ws), 4) for ws in procs]}, "
                  f"all runs median {statistics.median(every):.4f} "
                  f"(n {len(every)})", flush=True)
    return rehearse(dir_b, FAULTED_RUNS)


def rehearse(dir_b: str, runs: int) -> int:
    for backlog in (5, 128):
        res = child(LISTEN_CHILD, dir_b, backlog, STALE_COORDS, runs)
        if res is None:
            return 1
        total = {}
        for r in res:
            for k, v in r["delta"].items():
                total[k] = total.get(k, 0) + v
        print(f"backlog {backlog}, {STALE_COORDS} stale coordinators: "
              f"faulted walls {[round(r['wall_s'], 4) for r in res]}, "
              f"netstat deltas summed {total}, self-connects "
              f"{sum(r['self_connects'] for r in res)}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
