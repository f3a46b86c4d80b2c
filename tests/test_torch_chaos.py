"""The chaos harness over the port's processes (tools/chaos_torch.py) and
the fault surfaces it drives:

  - the harness's seeded schedule equals the reference harness's
    (tools/chaos.py, driven with fake workers and runners): the same seed
    gives the same queries, modes and per-worker fault configs;
  - FAULT_COORD_STALL_MS parks the port's coordinator once, between the
    last stage barrier and the root's drain, as presto_tpu's
    StageScheduler._pre_root_hook does;
  - a worker's /v1/info carries uptime_s and, while the sanitizer is
    armed, sanitizerViolations, like the reference worker's;
  - a long spool stream under FAULT_SPOOL_CORRUPT_EVERY recovers: the
    fetch retries bound one token's failures, not the stream's (the
    card's chaos run found the stream-wide count failing Q5 at SF 1);
  - one end-to-end kill iteration over two CPU worker processes;
  - a violation a worker records just before a kill fault hard-exits it
    reaches the harness through the process's exit record;
  - slow: the counterparts of tests/test_chaos.py's three runs.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist import dcn as DCN
from presto_tpu_torch.dist import scheduler as SCHED
from presto_tpu_torch.dist import serde
from presto_tpu_torch.dist import spool as SPOOL
from presto_tpu_torch.obs import sanitizer as SAN
from presto_tpu_torch.page import Page
from presto_tpu_torch.runner import LocalRunner
from presto_tpu_torch.server import worker as W
from tools import chaos_torch as CT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.005


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- schedule
def _reference_schedule(monkeypatch, capsys, seed, iterations, mode):
    """(query, mode, per-worker fault configs) of each iteration of
    tools/chaos.py's main(), its workers, runners and connector faked."""
    import presto_tpu.connectors.tpch as RTPCH
    import presto_tpu.dist.dcn as RDCN
    import presto_tpu.runner as RRUN
    import tools.chaos as RC

    posted = []  # (worker index, config), in call order

    class FakeWorker:
        made = 0

        def __init__(self, scale):
            self.index = FakeWorker.made
            FakeWorker.made += 1
            self.uri = f"http://fake/{self.index}"

        def boot(self):
            pass

        def ensure(self):
            return False

        def alive(self):
            return False

        def set_fault(self, config):
            posted.append((self.index, dict(config)))

        def kill(self):
            pass

    class FakeDcn:
        def __init__(self, *a, **kw):
            self.runner = types.SimpleNamespace(
                executor=types.SimpleNamespace(
                    task_retries=0, workers_excluded=0,
                    nonleaf_replays=0))
            self.last_distribution = "fake"
            self.release_skips = 0

        def execute(self, sql):
            return []

        def close(self):
            pass

    class FakeLocal:
        def __init__(self, *a, **kw):
            pass

        def execute(self, sql):
            return types.SimpleNamespace(rows=[])

    monkeypatch.setattr(RC, "Worker", FakeWorker)
    monkeypatch.setattr(RDCN, "DcnRunner", FakeDcn)
    monkeypatch.setattr(RRUN, "LocalRunner", FakeLocal)
    monkeypatch.setattr(RTPCH, "TpchConnector", lambda *a, **kw: None)
    argv = ["chaos.py", "--iterations", str(iterations), "--seed",
            str(seed), "--workers", "2"]
    if mode:
        argv += ["--mode", mode]
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    rc = RC.main()
    lines = re.findall(r"^iter \d+ q=(\S+)\s+fault=(\S+)",
                       capsys.readouterr().out, re.M)
    assert len(lines) == iterations and len(posted) == 2 * iterations
    # faults kill nothing here, so a kill-nonleaf run "fails" for want
    # of replays; the schedule is what is compared
    assert rc in (0, 1)
    return [(q, m, [posted[2 * i][1], posted[2 * i + 1][1]])
            for i, (q, m) in enumerate(lines)]


@pytest.mark.parametrize("seed,mode", [(0, None), (1, "kill-nonleaf"),
                                       (2, None), (7, "corrupt"),
                                       (11, None)])
def test_schedule_equals_the_reference(monkeypatch, capsys, seed, mode):
    want = _reference_schedule(monkeypatch, capsys, seed, 12, mode)
    got = [(q, m, [cfg if i == victim else {} for i in range(2)])
           for q, m, victim, cfg in CT.schedule(seed, 12, CT.MATRIX, 2,
                                                mode)]
    assert got == want


def test_schedule_cover_pins_the_first_modes():
    cover = ("delay", "drop", "kill", "submit-drop", "kill-nonleaf",
             "corrupt")
    plan = CT.schedule(0, 8, ("q3", "q5", "dag"), 2, None, cover)
    assert tuple(m for _q, m, _v, _c in plan[:6]) == cover
    assert plan[4][0] == "dag"  # kill-nonleaf always runs the DAG
    assert all(q in ("q3", "q5", "dag") for q, *_ in plan)


# ------------------------------------------------------------ stall park
@pytest.fixture(scope="module")
def cluster():
    cat = {"tpch": TpchConnector(SF, device="cpu")}
    workers = [W.WorkerServer(cat, node_id=f"w{i}", default_catalog="tpch",
                              page_rows=1 << 13, device="cpu")
               for i in range(2)]
    for w in workers:
        w.start()
    yield cat, workers
    for w in workers:
        w.stop()


def test_stall_park_runs_once_before_the_root_drain(cluster, monkeypatch):
    cat, workers = cluster
    events = []
    real_time = SCHED.time

    class ParkedClock:
        def __getattr__(self, name):
            return getattr(real_time, name)

        def sleep(self, s):
            if s == 4.321:
                events.append("stall")
            else:
                real_time.sleep(s)

    monkeypatch.setattr(SCHED, "time", ParkedClock())
    coord = DCN.DcnRunner(cat, [w.uri for w in workers], device="cpu",
                          session_props={"stage_scheduler": "true",
                                         "page_rows": 1 << 13,
                                         "agg_gather_capacity": 64})
    try:
        ex = coord.runner.executor
        execute = ex.execute

        def root_execute(*a, **kw):
            events.append("root")
            return execute(*a, **kw)

        monkeypatch.setattr(ex, "execute", root_execute)
        coord._root_hook = lambda sched: events.append("hook")
        want = LocalRunner(cat, page_rows=1 << 13,
                           device="cpu").execute(CT.DAG_QUERY).rows
        monkeypatch.setenv("FAULT_COORD_STALL_MS", "4321")
        assert CT.rows_equal(coord.execute(CT.DAG_QUERY), want)
        assert coord.last_distribution == "stage-dag"
        assert events == ["stall", "hook", "root"]
        events.clear()
        monkeypatch.delenv("FAULT_COORD_STALL_MS")
        assert CT.rows_equal(coord.execute(CT.DAG_QUERY), want)
        assert events == ["hook", "root"]
    finally:
        coord.close()


# ------------------------------------------------------------- /v1/info
def _info(uri):
    with urllib.request.urlopen(f"{uri}/v1/info", timeout=10) as r:
        return json.load(r)


def test_worker_info_fields_match_the_reference():
    from presto_tpu.connectors.tpch import TpchConnector as RefConnector
    from presto_tpu.obs import sanitizer as RSAN
    from presto_tpu.server import worker as RW

    ref = RW.WorkerServer({"tpch": RefConnector(scale=0.001)},
                          default_catalog="tpch")
    port = W.WorkerServer({"tpch": TpchConnector(0.001, device="cpu")},
                          default_catalog="tpch", device="cpu")
    armed = (SAN.is_armed(), RSAN.is_armed())
    ref.start()
    port.start()
    try:
        time.sleep(0.2)
        for on in (True, False):
            for s in (SAN, RSAN):
                s.arm() if on else s.disarm()
            got = _info(port.uri)
            want = _info(f"http://127.0.0.1:{ref.port}")
            for info in (got, want):
                assert isinstance(info["uptime_s"], float)
                assert 0.0 <= info["uptime_s"] < 600
                assert ("sanitizerViolations" in info) == on
            assert {k: type(got[k]) for k in ("uptime_s", "tasks")} == \
                {k: type(want[k]) for k in ("uptime_s", "tasks")}
            if on:
                assert got["sanitizerViolations"] == \
                    SAN.violation_count()
            assert isinstance(got["kernelLaunches"], dict)
    finally:
        for s, was in zip((SAN, RSAN), armed):
            s.arm() if was else s.disarm()
        port.stop()
        ref.stop()


# ------------------------------------------------- corrupt frame retries
def _spooled_worker(n_pages):
    """A worker with one finished task whose spool holds ``n_pages``
    small pages, and those pages' blobs."""
    w = W.WorkerServer({"tpch": TpchConnector(0.001, device="cpu")},
                       default_catalog="tpch", device="cpu")
    w.start()
    spool = W._TaskSpool(1, 0)
    blobs = []
    for i in range(n_pages):
        page = Page.from_arrays(
            [np.arange(i * 8, i * 8 + 8, dtype=np.int64)], [T.BIGINT])
        blob = serde.serialize_page(page)
        blobs.append(blob)
        spool.put(0, blob, rows=8)
    w.register_finished_task("t-long", spool)
    # every 3rd served frame flips a byte: a response carries every
    # remaining frame, so each re-fetch decodes a frame or more before
    # its corrupt one; no token fails twice, but a stream-wide retry
    # count reaches four at the fourth corrupt frame
    w.set_fault_config({"FAULT_SPOOL_CORRUPT_EVERY": 3})
    return w, blobs


def test_corrupt_frames_retry_per_token_worker_side():
    w, blobs = _spooled_worker(12)
    try:
        got = list(SPOOL.fetch_spool_blobs(
            w.uri, "t-long", 0, retries=3, backoff_s=0.0,
            decode=serde.deserialize_page))
    finally:
        w.stop()
    assert [serde.serialize_page(p) for p in got] == blobs


def test_corrupt_frames_retry_per_token_at_the_root():
    w, blobs = _spooled_worker(12)
    coord = DCN.DcnRunner({"tpch": TpchConnector(0.001, device="cpu")},
                          [w.uri], device="cpu",
                          session_props={"retry_backoff_ms": 0})
    try:
        got = list(coord._fetch_pages(DCN._TaskState(w.uri, "t-long"),
                                      None))
    finally:
        coord.close()
        w.stop()
    assert [serde.serialize_page(p) for p in got] == blobs


# ----------------------------------------------------- end to end (CPU)
def _harness(*argv, timeout=900):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "chaos_torch.py"),
         "--device", "cpu", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_kill_iteration_over_worker_processes():
    """One seeded kill iteration whose query is the stage DAG: a worker
    process hard-exits after its first results fetch, the scheduler
    replays its tasks, and the rows equal the oracle's."""
    seed = next(s for s in range(100)
                if CT.schedule(s, 1, CT.MATRIX, 2, "kill")[0][0] == "dag")
    proc = _harness("--iterations", "1", "--seed", str(seed),
                    "--scale", str(SF), "--mode", "kill", timeout=300)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    line = re.search(r"^iter 00 q=dag .*$", proc.stdout, re.M).group(0)
    assert line.endswith(": ok") and "dist=stage-dag" in line
    assert "task_retries=+0 " not in line, line


# a worker process that breaks the lock discipline (fault_config written
# off its lock) on SIGUSR1, after the harness's poll, then hard-exits
# through the kill fault's own path
_PLANTED_WORKER = """
import json, signal, time
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.server.worker import WorkerServer

srv = WorkerServer({"tpch": TpchConnector(0.001, device="cpu")},
                   device="cpu")
srv.owns_process = True


def die(*_):
    srv.fault_config = {}
    srv._kill()


signal.signal(signal.SIGUSR1, die)
print(json.dumps({"port": srv.start()}), flush=True)
while True:
    time.sleep(1)
"""


def test_violation_of_a_killed_worker_is_counted(tmp_path):
    """A sanitizer violation a worker process records after the
    harness's last /v1/info poll, just before a kill fault hard-exits
    it, reaches the harness through the process's exit record: the run
    counts it and fails."""
    (tmp_path / "planted_worker.py").write_text(_PLANTED_WORKER)
    args = CT.parse_args(["--device", "cpu", "--sanitize", "--workers",
                          "1", "--log-dir", str(tmp_path)])

    class Planted(CT.Worker):
        def start(self):
            env = CT.child_env(True)
            env["PYTHONPATH"] = os.pathsep.join(
                (str(tmp_path), env["PYTHONPATH"]))
            self.spawn(["planted_worker"], env)

    run = CT._Run(args)
    w = run.workers[0] = Planted(0, args, run.log_dir)
    try:
        w.boot()
        run.poll_workers()
        assert run.violations == 0
        w.proc.send_signal(signal.SIGUSR1)
        assert w.proc.wait(timeout=60) == 137
        record = w.exit_counts()
        assert record["sanitizerViolations"] == 1
        assert "kernelLaunches" in record
        run.poll_workers()
        run.poll_workers()  # a dead boot is read once
        assert run.violations == 1
    finally:
        run.finish()
    assert run.failures >= 1


@pytest.mark.slow
def test_chaos_harness_exits_zero():
    proc = _harness("--iterations", "4", "--seed", "0", "--scale", "0.005")
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "failures" in proc.stdout


@pytest.mark.slow
def test_chaos_kill_nonleaf_recovers_via_spool_replay():
    proc = _harness("--iterations", "2", "--seed", "1", "--scale", "0.005",
                    "--mode", "kill-nonleaf")
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "nonleaf_replays=" in proc.stdout


@pytest.mark.slow
def test_chaos_kill_coordinator_reattaches():
    proc = _harness("--iterations", "2", "--seed", "2", "--scale", "0.005",
                    "--mode", "kill-coordinator", "--sanitize")
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "coordinator_reattaches=" in proc.stdout


def test_every_flipped_byte_is_a_wire_error_or_a_page():
    """The corrupt fault flips the middle byte of a blob, which lands in
    the JSON header of a small page: every single-byte flip decodes or
    raises PageWireError (a consumer's re-fetch trigger), never another
    error."""
    page = Page.from_arrays([np.arange(8, dtype=np.int64),
                             np.array(["a", "b"] * 4, dtype=object)],
                            [T.BIGINT, T.VARCHAR])
    blob = serde.serialize_page(page)
    for i in range(len(blob)):
        flipped = bytearray(blob)
        flipped[i] ^= 0x01
        try:
            serde.deserialize_page(bytes(flipped))
        except serde.PageWireError:
            pass
