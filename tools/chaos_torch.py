"""Chaos harness over the port's worker and coordinator processes: a small
TPC-H query matrix under seeded fault schedules (delay / drop / kill /
submit-drop / kill-nonleaf / corrupt) against presto_tpu_torch's
fault-tolerant distributed path, and the coordinator-loss schedule
(kill-coordinator).

The port's counterpart of tools/chaos.py, with its flags, modes, query
matrix, seeded schedule and exit contract, plus ``--device``. Every
worker is an OS process (``python -m presto_tpu_torch.server.worker``)
on that device; every iteration picks a query and a fault mode, applies
the fault to one worker through its ``POST /v1/fault`` surface, runs the
query through an in-process DcnRunner with task retries on, and compares
the rows with a single-process LocalRunner oracle on the same device.
Killed workers reboot on the SAME port before the next iteration (the
coordinator re-admits them on a fresh ping). ``kill-nonleaf`` kills a
worker while it serves spool fetches mid-DAG, so recovery must come from
spooled NON-LEAF replay (the run fails if it records none).
``kill-coordinator`` boots a coordinator process (``python -m
presto_tpu_torch.server.http_server``) with a checkpoint journal and
FAULT_COORD_STALL_MS parking it between the last stage barrier and the
root's drain, SIGKILLs it there, boots a successor on the same journal,
and drains the client's statement from it: the rows must equal the
oracle's and the successor must count a re-attach.

``--sanitize`` arms the runtime lock sanitizer here and, through the
environment, in every child process; the run fails on any violation in
any process. Children report theirs on /v1/info, polled before every
iteration; a worker a kill fault hard-exits leaves its counts since
that poll in its log's exit record, and a stalled coordinator is polled
just before its SIGKILL.

Each child's stderr goes to a log file under ``--log-dir`` (a fresh
temporary directory by default), and the harness prints a log's tail
when its process fails to boot, dies unexpectedly or an iteration
fails. Nothing falls back from one device to another: a child that
cannot start on ``--device`` fails the run.

Exits nonzero on ANY wrong result, error, hang past the deadline or
(with --sanitize) violation. It imports neither jax nor presto_tpu.

Usage: chaos_torch.py [--iterations 20] [--seed 0] [--scale 0.01]
                      [--workers 2] [--deadline-ms 180000]
                      [--mode kill-nonleaf] [--sanitize] [--device cpu]
                      [--page-rows 8192] [--log-dir DIR]
"""

import argparse
import collections
import http.client
import json
import os
import random
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

PAGE_ROWS = 1 << 13
FAULT_KEYS = (
    "FAULT_DELAY_MS", "FAULT_DROP_EVERY", "FAULT_KILL_AFTER_FETCHES",
    "FAULT_SUBMIT_DROP_EVERY", "FAULT_DEVICE_OOM",
    "FAULT_TASK_EXEC_DELAY_MS", "FAULT_SPOOL_CORRUPT_EVERY",
    "FAULT_COORD_STALL_MS",
)
FAULT_MODES = ("none", "delay", "drop", "kill", "submit-drop",
               "kill-nonleaf", "corrupt")
# kill-coordinator is not a per-iteration worker fault: it SIGKILLs the
# coordinator process mid-query and re-attaches on a successor
# (run_kill_coordinator), so it is --mode-only, never drawn
ALL_MODES = FAULT_MODES + ("kill-coordinator",)

# the 3-stage DAG shape (left join -> hash agg -> join -> agg) the
# legacy agg/union cuts fall back local on; the stage scheduler
# distributes it and spools every exchange
DAG_QUERY = (
    "select n_name, count(*), sum(top.c_count) from nation join ("
    "  select c_nationkey nk, c_custkey ck, count(o_orderkey) c_count"
    "  from customer left join orders on c_custkey = o_custkey"
    "  group by c_nationkey, c_custkey) top on n_nationkey = top.nk "
    "group by n_name order by n_name"
)
# the reference harness's matrix; query_matrix() also knows q5
MATRIX = ("q1", "q6", "q3", "approx", "dag")

# a child's boot: interpreter, torch import, device initialisation, the
# kernel libraries' load (on a card) and the catalog's set-up, before it
# prints its port; a reboot waits for the killed process's port too
BOOT_TIMEOUT_S = 300.0
BOOT_TRIES = 10
# a fault kill's exit code (server/worker.TaskRuntime._kill) and ours
EXPECTED_DEATHS = (137, -signal.SIGKILL)


def query_matrix(names=MATRIX):
    from presto_tpu_torch.queries import TPCH_SQL

    every = {
        "q1": TPCH_SQL[1],
        "q6": TPCH_SQL[6],
        "q3": TPCH_SQL[3],
        "q5": TPCH_SQL[5],
        "approx": (
            "select o_orderpriority, approx_distinct(o_custkey), "
            "sum(o_totalprice) from orders group by o_orderpriority"
        ),
        "dag": DAG_QUERY,
    }
    return {name: every[name] for name in names}


def schedule(seed, iterations, names, n_workers, mode=None, cover=()):
    """[(query, mode, victim worker index, fault config)] per iteration,
    drawn from random.Random(seed) in the reference harness's order:
    the mode, the query (kill-nonleaf always runs the DAG), the victim,
    then every mode's parameter. ``cover`` pins the modes of the first
    iterations (a run that must visit each of them once)."""
    rng = random.Random(seed)
    out = []
    for i in range(iterations):
        m = cover[i] if i < len(cover) else (mode or rng.choice(FAULT_MODES))
        qname = "dag" if m == "kill-nonleaf" else rng.choice(sorted(names))
        victim = rng.choice(range(n_workers))
        config = {
            "none": {},
            "delay": {"FAULT_DELAY_MS": rng.choice((10, 30, 60))},
            "drop": {"FAULT_DROP_EVERY": rng.choice((2, 3))},
            "kill": {"FAULT_KILL_AFTER_FETCHES": rng.choice((1, 2))},
            "submit-drop": {"FAULT_SUBMIT_DROP_EVERY": 2},
            "kill-nonleaf": {"FAULT_KILL_AFTER_FETCHES":
                             rng.choice((1, 2))},
            # sparse wire bit-rot: every nth served results body flips
            # one byte; the consumer's re-fetch at the same token must
            # absorb it
            "corrupt": {"FAULT_SPOOL_CORRUPT_EVERY": rng.choice((5, 9))},
        }[m]
        out.append((qname, m, victim, config))
    return out


def rows_equal(a, b) -> bool:
    return collections.Counter(map(repr, a)) == collections.Counter(
        map(repr, b)
    )


def child_env(sanitize: bool, stall_ms: int = 0) -> dict:
    env = dict(os.environ)
    for k in FAULT_KEYS:
        env.pop(k, None)
    if sanitize:
        env["PRESTO_TPU_LOCK_SANITIZER"] = "1"
    if stall_ms:
        env["FAULT_COORD_STALL_MS"] = str(stall_ms)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    return env


def log_tail(path: str, lines: int = 30) -> str:
    try:
        with open(path, errors="replace") as f:
            tail = f.read().splitlines()[-lines:]
    except OSError as e:
        return f"  (no log: {e})"
    return "\n".join(f"  | {ln}" for ln in tail)


class BootError(RuntimeError):
    pass


class _Child:
    """One child process that prints a JSON line with its port once it
    serves; its stderr goes to ``log_path``."""

    def __init__(self, name: str, log_path: str):
        self.name = name
        self.log_path = log_path
        self.proc = None
        self.port = 0
        self.uri = ""
        self.boots = []  # seconds of each boot, the first included

    def spawn(self, argv, env) -> None:
        with open(self.log_path, "a") as log:
            log.write(f"# {' '.join(argv)}\n")
            log.flush()
            self._log_start = log.tell()  # where this boot's stderr starts
            self.proc = subprocess.Popen(
                [sys.executable, "-m", *argv], stdout=subprocess.PIPE,
                stderr=log, env=env, cwd=REPO, text=True)
        self._t0 = time.monotonic()

    def wait_ready(self) -> None:
        """Read the port line; raise BootError if the child dies or
        stays silent past BOOT_TIMEOUT_S."""
        ready, _, _ = select.select([self.proc.stdout], [], [],
                                    BOOT_TIMEOUT_S)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            if not ready:
                self.kill()
            self.proc.wait(timeout=30)
            raise BootError(
                f"{self.name} did not boot (exit {self.proc.returncode}"
                f"{'' if ready else f', silent {BOOT_TIMEOUT_S:.0f}s'})")
        self.port = json.loads(line)["port"]
        self.uri = f"http://127.0.0.1:{self.port}"
        self.boots.append(time.monotonic() - self._t0)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def info(self) -> dict:
        with urllib.request.urlopen(f"{self.uri}/v1/info", timeout=5) as r:
            return json.load(r)

    def exit_counts(self):
        """The dead process's exit record (server/worker.EXIT_RECORD:
        its counts as it hard-exited), or None if it left none."""
        from presto_tpu_torch.server.worker import EXIT_RECORD

        try:
            with open(self.log_path, errors="replace") as f:
                f.seek(self._log_start)
                lines = f.read().splitlines()
        except OSError:
            return None
        for ln in reversed(lines):
            if ln.startswith(EXIT_RECORD):
                return json.loads(ln[len(EXIT_RECORD):])
        return None

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


class Worker(_Child):
    """One worker process, rebootable on a sticky port."""

    def __init__(self, index: int, args, log_dir: str):
        super().__init__(f"worker {index}",
                         os.path.join(log_dir, f"worker{index}.log"))
        self.index = index
        self.args = args

    def start(self) -> None:
        # port 0 = OS-assigned on the first boot, sticky after
        self.spawn(["presto_tpu_torch.server.worker",
                    "--port", str(self.port), "--suite", "tpch",
                    "--scale", str(self.args.scale),
                    "--node-id", f"w{self.index}",
                    "--page-rows", str(self.args.page_rows),
                    "--device", self.args.device],
                   child_env(self.args.sanitize))

    def boot(self) -> None:
        self.start()
        self.wait_ready()

    def ensure(self) -> bool:
        """Reboot if dead; True when a reboot happened."""
        if self.alive():
            return False
        if self.proc is not None:
            self.proc.wait(timeout=30)
            if self.proc.returncode not in EXPECTED_DEATHS:
                print(f"# chaos: {self.name} exited "
                      f"{self.proc.returncode}:\n{log_tail(self.log_path)}",
                      flush=True)
        # the killed process's port lingers in TIME_WAIT briefly;
        # retry the bind a few times before giving up
        for attempt in range(BOOT_TRIES):
            try:
                self.boot()
                return True
            except (BootError, ValueError, KeyError):
                time.sleep(0.3 * (attempt + 1))
        print(log_tail(self.log_path), flush=True)
        raise RuntimeError(f"{self.name} on port {self.port} failed to "
                           f"boot {BOOT_TRIES} times")

    def set_fault(self, config) -> None:
        req = urllib.request.Request(
            f"{self.uri}/v1/fault", data=json.dumps(config).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=5).close()


class Coordinator(_Child):
    """One coordinator process over a worker fleet and a durable
    checkpoint journal — the kill-coordinator mode's victim. A
    ``stall_ms`` boot parks every stage-DAG query between the last
    stage barrier and the root's drain (FAULT_COORD_STALL_MS,
    dist/scheduler.StageScheduler._pre_root_hook): the window where
    every producer spool is live and nothing was consumed."""

    def __init__(self, name: str, args, worker_uris, ckdir: str,
                 log_dir: str, stall_ms: int = 0):
        super().__init__(name, os.path.join(log_dir, f"{name}.log"))
        self.spawn(["presto_tpu_torch.server.http_server",
                    "--port", "0", "--scale", str(args.scale),
                    "--page-rows", str(args.page_rows),
                    "--workers", ",".join(worker_uris),
                    "--checkpoint-dir", ckdir, "--device", args.device],
                   child_env(args.sanitize, stall_ms))
        self.wait_ready()

    def submit(self, sql: str) -> dict:
        req = urllib.request.Request(
            f"{self.uri}/v1/statement", data=sql.encode(),
            headers={"X-Presto-Session": "stage_scheduler=true",
                     "Content-Type": "text/plain"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read().decode())

    def metric(self, name: str) -> float:
        """One counter off /metrics (Prometheus text)."""
        with urllib.request.urlopen(f"{self.uri}/metrics",
                                    timeout=10) as r:
            for ln in r.read().decode().splitlines():
                if ln.startswith(f"presto_tpu_{name}"):
                    return float(ln.rsplit(None, 1)[1])
        return 0.0


def _wait_for_journal_barriers(ckdir: str, qid: str,
                               timeout: float) -> None:
    """Poll the journal (read-only, from the parent) until ``qid`` has
    its root fragment and every feeding stage checkpointed — the
    coordinator is then inside its stall window."""
    from presto_tpu_torch.cache.persist import read_manifest_doc

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            doc = read_manifest_doc(ckdir, stem="journal")
        except ValueError:
            doc = None  # a generation caught mid-write
        rec = ((doc or {}).get("entries") or {}).get(qid)
        if rec and rec.get("root") and rec.get("root_inputs") and \
                all(str(f) in rec.get("stages", {})
                    for f in rec["root_inputs"]):
            return
        time.sleep(0.05)
    raise RuntimeError(
        f"query {qid}: stage/root barriers never reached the journal")


def _drain_statement(uri: str, qid: str, deadline_s: float):
    """Restart-tolerant protocol drain from token 0: the successor may
    still be re-attaching when the first poll lands, so transient
    refusals retry until the deadline."""
    rows = []
    url = f"{uri}/v1/statement/{qid}/0"
    deadline = time.monotonic() + deadline_s
    while True:
        if time.monotonic() > deadline:
            raise RuntimeError(f"query {qid}: drain past deadline")
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                doc = json.loads(r.read().decode())
        except (OSError, ValueError):
            time.sleep(0.2)
            continue
        if doc.get("error"):
            raise RuntimeError(str(doc["error"]))
        rows.extend(doc.get("data") or [])
        nxt = doc.get("nextUri")
        if not nxt:
            return rows
        url = nxt
        time.sleep(0.02)


class _Run:
    """One harness run's set-up and verdicts: the workers, the oracle,
    the sanitizer, the per-worker violation and kernel-launch polls, and
    the report the CLI prints and chip_smoke.py checks."""

    def __init__(self, args):
        self.args = args
        self.log_dir = args.log_dir or tempfile.mkdtemp(
            prefix="presto-tpu-chaos-")
        os.makedirs(self.log_dir, exist_ok=True)
        self.san = None
        self._disarm = False
        if args.sanitize:
            from presto_tpu_torch.obs import sanitizer as san

            # a caller's process (chip_smoke.py) keeps its own setting
            self._disarm = not san.is_armed()
            san.arm()
            san.reset()
            self.san = san
        self.failures = 0
        self.iterations = []
        self.violations = 0
        self._seen = {}  # (worker, boot) -> last polled count
        self._reaped = set()  # (worker, boot) of dead processes read
        self.launches = collections.Counter()  # workers' kernel launches
        self.workers = [Worker(i, args, self.log_dir)
                        for i in range(args.workers)]

    def oracle(self, matrix):
        import torch

        from presto_tpu_torch.connectors.tpch import TpchConnector
        from presto_tpu_torch.runner import LocalRunner

        print(f"# oracle: single-process run at SF{self.args.scale} on "
              f"{self.args.device}", flush=True)
        dev = torch.device(self.args.device)
        single = LocalRunner(
            {"tpch": TpchConnector(self.args.scale, device=dev)},
            page_rows=self.args.page_rows, device=dev)
        return {name: single.execute(sql).rows
                for name, sql in matrix.items()}

    def boot_workers(self) -> None:
        for w in self.workers:
            w.start()
        for w in self.workers:
            try:
                w.wait_ready()
            except (BootError, ValueError, KeyError):
                print(log_tail(w.log_path), flush=True)
                raise

    def poll_workers(self) -> None:
        """Accumulate each worker's sanitizer violations and kernel
        launches: a live one's from /v1/info, a dead one's from its exit
        record, which holds what it counted after its last poll. Runs
        before every iteration, ahead of the reboots; counts are per
        boot of a worker. A dead worker with no exit record fails the
        run: its counts are unknown."""
        for w in self.workers:
            key = (w.index, len(w.boots))
            if w.alive():
                try:
                    info = w.info()
                except (OSError, ValueError, http.client.HTTPException):
                    continue  # dying mid-response: read once it is dead
            elif w.proc is None or key in self._reaped:
                continue
            else:
                self._reaped.add(key)
                info = w.exit_counts()
                if info is None:
                    print(f"# chaos: {w.name} died (exit "
                          f"{w.proc.poll()}) without an exit record: "
                          f"its sanitizer violations are unknown",
                          flush=True)
                    self.failures += 1
                    continue
            self.count(key, info)

    def count(self, key, info) -> None:
        """Add a process's counts (/v1/info's or an exit record's) past
        what ``key`` reported before."""
        last_n, last_l = self._seen.get(key, (0, collections.Counter()))
        n = int(info.get("sanitizerViolations", 0) or 0)
        launched = collections.Counter(info.get("kernelLaunches") or {})
        self.violations += n - last_n
        self.launches.update(launched - last_l)
        self._seen[key] = (n, launched)

    def note(self, i, qname, mode, wall, status, extra="") -> None:
        self.iterations.append(dict(i=i, query=qname, mode=mode,
                                    wall_s=wall, status=status))
        print(f"iter {i:02d} q={qname:<6} fault={mode:<12} "
              f"wall={wall:6.2f}s{extra}: {status}", flush=True)
        if status != "ok":
            for w in self.workers:
                print(f"# {w.name} log tail:\n{log_tail(w.log_path)}",
                      flush=True)

    def finish(self) -> None:
        self.poll_workers()
        if self.san is not None:
            if self.violations:
                print(f"# chaos: child processes recorded "
                      f"{self.violations} sanitizer violation(s)")
                self.failures += self.violations
            own = self.san.violation_count()
            if own:
                print(self.san.report())
                self.failures += own
                self.violations += own
            if self._disarm:
                self.san.disarm()
        for w in self.workers:
            w.kill()

    def report(self, **counters) -> dict:
        return dict(
            iterations=self.iterations, failures=self.failures,
            violations=self.violations,
            worker_boot_s=[w.boots[0] for w in self.workers if w.boots],
            worker_reboot_s=[s for w in self.workers for s in w.boots[1:]],
            worker_kernel_launches=dict(self.launches),
            log_dir=self.log_dir, **counters)


def run_faults(args, names=MATRIX, cover=(), session=None) -> dict:
    """The worker-fault schedule (every mode but kill-coordinator) over
    the queries ``names``; ``session`` adds properties to the
    coordinator's session. Returns the run's report."""
    import torch

    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.dist.dcn import DcnRunner

    run = _Run(args)
    plan = schedule(args.seed, args.iterations, names, args.workers,
                    args.mode, cover)
    matrix = query_matrix(sorted({q for q, *_ in plan}))
    want = run.oracle(matrix)
    coord = None
    try:
        run.boot_workers()
        dev = torch.device(args.device)
        coord = DcnRunner(
            {"tpch": TpchConnector(args.scale, device=dev)},
            [w.uri for w in run.workers], default_catalog="tpch",
            session_props={
                "page_rows": args.page_rows,
                "task_retry_attempts": 2,
                "retry_backoff_ms": 50,
                "query_max_run_time": args.deadline_ms,
                # the dag query engages the stage scheduler through the
                # auto gate (the legacy cuts cannot distribute its shape)
                "agg_gather_capacity": 64,
                **(session or {}),
            },
            device=dev,
        )
        ex = coord.runner.executor
        for i, (qname, mode, victim, config) in enumerate(plan):
            run.poll_workers()
            for w in run.workers:
                w.ensure()
            for w in run.workers:
                w.set_fault(config if w.index == victim else {})
            retries0, excl0 = ex.task_retries, ex.workers_excluded
            nonleaf0 = ex.nonleaf_replays
            t0 = time.monotonic()
            status = "ok"
            try:
                got = coord.execute(matrix[qname])
                if not rows_equal(got, want[qname]):
                    status = "WRONG RESULT"
                    run.failures += 1
            except Exception as e:  # noqa: BLE001 - harness verdict
                status = f"ERROR {type(e).__name__}: {e}"
                run.failures += 1
            wall = time.monotonic() - t0
            if wall * 1000 > args.deadline_ms:
                status += " + HANG past deadline"
                run.failures += 1
            run.note(i, qname, mode, wall, status,
                     f" task_retries=+{ex.task_retries - retries0}"
                     f" excluded=+{ex.workers_excluded - excl0}"
                     f" nonleaf=+{ex.nonleaf_replays - nonleaf0}"
                     f" dist={coord.last_distribution}")
    finally:
        run.finish()
        if coord is not None:
            coord.close()
    if args.mode == "kill-nonleaf" and ex.nonleaf_replays == 0:
        print("# chaos: kill-nonleaf run recorded ZERO nonleaf_replays"
              " — the spooled-replay path was never exercised")
        run.failures += 1
    print(f"# chaos: {args.iterations} iterations, {run.failures} "
          f"failures, task_retries={ex.task_retries} "
          f"workers_excluded={ex.workers_excluded} "
          f"nonleaf_replays={ex.nonleaf_replays} "
          f"release_skips={ex.release_skips}", flush=True)
    return run.report(task_retries=ex.task_retries,
                      workers_excluded=ex.workers_excluded,
                      nonleaf_replays=ex.nonleaf_replays)


def run_kill_coordinator(args) -> dict:
    """A multi-stage distributed query with every producer stage
    spooled survives its coordinator's SIGKILL: the successor process
    on the same checkpoint directory re-attaches, the client's nextUri
    stream resumes, the rows equal the oracle's and the successor counts
    coordinator_reattaches >= 1. Returns the run's report."""
    run = _Run(args)
    want = [list(r) for r in run.oracle({"dag": DAG_QUERY})["dag"]]
    reattaches = 0
    reattach_s = []
    try:
        run.boot_workers()
        uris = [w.uri for w in run.workers]
        for i in range(args.iterations):
            run.poll_workers()
            for w in run.workers:
                w.ensure()
            ckdir = tempfile.mkdtemp(prefix="presto-tpu-ckpt-")
            status = "ok"
            t0 = time.monotonic()
            coord = succ = None
            try:
                # boot A stalled wide open, submit, wait for the
                # barriers, SIGKILL mid-stall: every producer spool is
                # live, nothing consumed, the journal has it all
                coord = Coordinator(f"coordinator{i}a", args, uris, ckdir,
                                    run.log_dir, stall_ms=args.deadline_ms)
                qid = coord.submit(DAG_QUERY)["id"]
                _wait_for_journal_barriers(ckdir, qid,
                                           args.deadline_ms / 1000.0)
                # its counts up to the park, which it holds till killed
                run.count((coord.name, 0), coord.info())
                coord.kill()
                # boot B on the same journal; the client re-polls its
                # persisted nextUri against the successor
                t1 = time.monotonic()
                succ = Coordinator(f"coordinator{i}b", args, uris, ckdir,
                                   run.log_dir)
                got = [list(r) for r in _drain_statement(
                    succ.uri, qid, args.deadline_ms / 1000.0)]
                reattach_s.append(time.monotonic() - t1)
                if not rows_equal(got, want):
                    status = "WRONG RESULT"
                    run.failures += 1
                re_n = succ.metric("coordinator_reattaches")
                reattaches += int(re_n)
                if re_n < 1:
                    status = "NO REATTACH RECORDED"
                    run.failures += 1
                run.count((succ.name, 0), succ.info())
            except Exception as e:  # noqa: BLE001 - harness verdict
                status = f"ERROR {type(e).__name__}: {e}"
                run.failures += 1
                for c in (coord, succ):
                    if c is not None:
                        print(f"# {c.name} log tail:\n"
                              f"{log_tail(c.log_path)}", flush=True)
            finally:
                for c in (coord, succ):
                    if c is not None:
                        c.kill()
                shutil.rmtree(ckdir, ignore_errors=True)
            wall = time.monotonic() - t0
            if wall * 1000 > args.deadline_ms:
                status += " + HANG past deadline"
                run.failures += 1
            run.note(i, "dag", "kill-coordinator", wall, status)
    finally:
        run.finish()
    if reattaches < args.iterations:
        print(f"# chaos: only {reattaches} re-attaches across "
              f"{args.iterations} kill-coordinator iterations")
    print(f"# chaos: {args.iterations} iterations, {run.failures} "
          f"failures, coordinator_reattaches={reattaches}", flush=True)
    return run.report(coordinator_reattaches=reattaches,
                      reattach_s=reattach_s)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--deadline-ms", type=int, default=180_000)
    ap.add_argument("--mode", choices=ALL_MODES, default=None,
                    help="pin every iteration to one fault mode "
                    "(kill-nonleaf additionally requires at least one "
                    "nonleaf_replay across the run; kill-coordinator "
                    "SIGKILLs the coordinator process mid-query and "
                    "re-attaches on a successor over the same "
                    "checkpoint journal)")
    ap.add_argument("--sanitize", action="store_true",
                    help="arm the runtime lock sanitizer here and in "
                    "every child process; fail on any violation")
    ap.add_argument("--page-rows", type=int, default=PAGE_ROWS,
                    help="page size of every process")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every process (cpu or cuda)")
    ap.add_argument("--log-dir", default="",
                    help="where the children's stderr logs go (default: "
                    "a fresh temporary directory)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mode == "kill-coordinator":
        report = run_kill_coordinator(args)
    else:
        report = run_faults(args)
    return 1 if report["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
