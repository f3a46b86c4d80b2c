"""The port's static gate: tools/lint_torch, tools/concheck_torch.py and
tools/plan_audit_torch.py.

  1. the port is clean under each of them (the gate itself);
  2. each CLI exits 1 on a finding;
  3. every seeded case of tests/test_static_analysis.py's lint rules and
     of tests/test_concheck.py goes through the reference's tool and the
     port's, and the two report the same rule at the same line. Where a
     rule names primitives, the port's file uses the port's (`.cpu()`
     where the reference's has `jax.device_get`, a program-cache key
     where it has a jit key) on the same lines; the rules that read the
     registries (session-props, counters, spans) are seeded by adding
     an entry or a site to both engines alike.

Pure AST and host planning: nothing runs on a device.
"""

import sys
import textwrap

import pytest
import torch

import tools.concheck as RCON
import tools.lint as RLINT
from tools import concheck_torch as PCON
from tools import lint_torch as PLINT
from tools import plan_audit_torch as PAUDIT


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- gates
def test_port_is_lint_clean():
    findings = PLINT.run_lint()
    assert not findings, "\n".join(str(f) for f in findings)


def test_port_is_concheck_clean():
    findings = PCON.run_concheck()
    assert not findings, "\n".join(str(f) for f in findings)


def test_port_registry_covers_every_lock_and_thread():
    from presto_tpu_torch.obs import sanitizer as SAN

    assert len(SAN.LOCK_REGISTRY) >= 12
    assert len(SAN.THREAD_REGISTRY) >= 4
    for name, help_text in SAN.LOCK_REGISTRY.items():
        assert help_text.strip(), f"{name} has empty help text"


def test_port_plan_audit_is_clean():
    n, failures, dags, replans = PAUDIT.run_audit()
    assert not failures, failures
    assert n == 38  # 22 TPC-H + 16 TPC-DS plans
    assert sum(1 for s in dags if s >= 2) >= 30
    assert sum(replans) > 0


def test_clis_exit_one_on_a_finding(monkeypatch, capsys):
    from tools.lint_torch import __main__ as LINT_MAIN

    seeded = [PLINT.Finding("locks", "seeded.py", 3, "seeded")]
    monkeypatch.setattr(LINT_MAIN, "run_lint", lambda rules: seeded)
    assert LINT_MAIN.main([]) == 1
    assert LINT_MAIN.main(["no-such-rule"]) == 2
    monkeypatch.setattr(PCON, "run_concheck", lambda: seeded)
    assert PCON.main() == 1
    monkeypatch.setattr(PAUDIT, "queries", lambda suite: {
        1: "select no_such_column from nation"})
    monkeypatch.setattr(sys, "argv", ["plan_audit_torch.py",
                                      "--corpus", "tpch"])
    assert PAUDIT.main() == 1
    assert "planning failed" in capsys.readouterr().out


# ----------------------------------------------- seeded, tool against tool
def _seeded(tmp_path, side: str, body: str) -> str:
    d = tmp_path / side
    d.mkdir(exist_ok=True)
    p = d / "seeded.py"
    p.write_text(textwrap.dedent(body))
    return str(p)


def _run(tool: str, mod, path: str, kw: dict):
    if tool == "excepts":
        return mod.check_excepts([path])
    if tool == "locks":
        return mod.check_locks(paths=[path])
    if tool == "purity":
        return mod.check_purity(paths=[path])
    if tool == "concheck":
        return mod.run_concheck(paths=[path], **kw)
    return mod.check_registry(mod.collect([path]), **kw)


def _rule_lines(found):
    return sorted((f.rule, f.line) for f in found)


# (name, tool, reference source, port source or None for the same file,
#  tool keywords, the rule the case must raise — or "no <rule>" where the
#  case must raise none of it — and a phrase the port's message carries)
CASES = [
    ("lock_order_cycle_lexical", "concheck", """
        import threading

        class X:
            _shared_attrs = ()
            def __init__(self):
                self.a = threading.Lock()
                self.b = threading.Lock()
            def forward(self):
                with self.a:
                    with self.b:
                        pass
            def backward(self):
                with self.b:
                    with self.a:
                        pass
     """, None, {}, "con-graph", "seeded.X.a"),
    ("lock_order_cycle_one_call_deep", "concheck", """
        import threading

        class X:
            _shared_attrs = ()
            def __init__(self):
                self.a = threading.Lock()
                self.b = threading.Lock()
            def forward(self):
                with self.a:
                    self.helper()
            def helper(self):
                with self.b:
                    pass
            def backward(self):
                with self.b:
                    with self.a:
                        pass
     """, None, {}, "con-graph", "lock-order cycle"),
    ("no_cycle_on_consistent_order", "concheck", """
        import threading

        class X:
            _shared_attrs = ()
            def __init__(self):
                self.a = threading.Lock()
                self.b = threading.Lock()
            def m1(self):
                with self.a:
                    with self.b:
                        pass
            def m2(self):
                with self.a:
                    with self.b:
                        pass
     """, None, {}, "no con-graph", None),
    ("blocking_sleep_under_lock", "concheck", """
        import threading
        import time

        class X:
            _shared_attrs = ()
            def __init__(self):
                self._lock = threading.Lock()
            def bad(self):
                with self._lock:
                    time.sleep(0.1)
     """, None, {}, "con-blocking", "time.sleep"),
    ("blocking_escape_comment_is_honored", "concheck", """
        import threading
        import time

        class X:
            _shared_attrs = ()
            def __init__(self):
                self._lock = threading.Lock()
            def annotated(self):
                with self._lock:
                    # concheck: blocking-ok - seeded test exemption
                    time.sleep(0.1)
     """, None, {}, "no con-blocking", None),
    ("blocking_one_call_level_deep", "concheck", """
        import threading
        import urllib.request

        class X:
            _shared_attrs = ()
            def __init__(self):
                self._lock = threading.Lock()
            def bad(self):
                with self._lock:
                    self.fetch()
            def fetch(self):
                return urllib.request.urlopen("http://x").read()
     """, None, {}, "con-blocking", "urlopen"),
    ("blocking_in_locked_helper", "concheck", """
        import threading
        import time

        class X:
            _shared_attrs = ()
            def __init__(self):
                self._lock = threading.Lock()
            def _evict_locked(self):
                time.sleep(0.1)
     """, None, {}, "con-blocking", "time.sleep"),
    ("raw_lock_construction_flagged", "concheck", """
        import threading

        class X:
            _shared_attrs = ()
            def __init__(self):
                self._lock = threading.Lock()
     """, None, {}, "con-registry", "raw threading.Lock()"),
    ("misnamed_and_undeclared_factory_lock", "concheck", """
        from presto_tpu.obs.sanitizer import make_lock

        class X:
            _shared_attrs = ()
            def __init__(self):
                self._lock = make_lock("totally.wrong.name")
     """, """
        from presto_tpu_torch.obs.sanitizer import make_lock

        class X:
            _shared_attrs = ()
            def __init__(self):
                self._lock = make_lock("totally.wrong.name")
     """, {"lock_registry": {}, "thread_registry": {}}, "con-registry",
     "'seeded.X._lock'"),
    ("unregistered_thread_target", "concheck", """
        import threading

        class X:
            def go(self):
                threading.Thread(target=self._loop, daemon=True).start()
            def _loop(self):
                pass
     """, None, {"lock_registry": {}, "thread_registry": {}},
     "con-registry", "seeded:self._loop"),
    ("stale_registry_entries", "registry", """
        def nothing():
            pass
     """, None, {"lock_registry": {"ghost.Lock._lock": "gone"},
                 "thread_registry": {"ghost:self._loop": "gone"},
                 "full_sweep": True}, "con-registry", "stale"),
    ("locks_rule_generalizes_to_any_lock_attr", "locks", """
        import threading

        class Racy:
            _shared_attrs = ("n",)
            def __init__(self):
                self._fault_lock = threading.Lock()
                self.n = 0
            def locked_bump(self):
                with self._fault_lock:
                    self.n += 1
            def racy_bump(self):
                self.n += 1
     """, None, {}, "locks", "OUTSIDE"),
    ("locks_rule_flags_undeclared_owner", "locks", """
        import threading

        class Silent:
            def __init__(self):
                self._cv = threading.Condition()

        # lint: single-threaded - built and polled by one test thread
        class Annotated:
            def __init__(self):
                self._cv = threading.Condition()
     """, None, {}, "locks", "_shared_attrs"),
    ("locks_rule_honors_locked_helper", "locks", """
        import threading

        class Store:
            _shared_attrs = ("evictions",)
            def __init__(self):
                self._lock = threading.Lock()
                self.evictions = 0
            def drop(self):
                with self._lock:
                    self._evict_locked()
            def _evict_locked(self):
                self.evictions += 1
     """, None, {}, "no locks", None),
    ("locks_rule_class_level_lock", "locks", """
        import threading

        class Registry:
            _instances_lock = threading.Lock()
            def __init__(self):
                self.n = 0
     """, None, {}, "locks", "Registry"),
    ("excepts_bare_and_broad", "excepts", """
        def f():
            try:
                pass
            except:
                pass
            try:
                pass
            except Exception:
                pass
            try:
                pass
            except Exception:  # noqa: BLE001 - explained, allowed
                pass
            try:
                pass
            except Exception as e:
                raise RuntimeError("x") from e
     """, None, {}, "excepts", "broad"),
    ("locks_undeclared_and_unlocked", "locks", """
        import threading

        class Undeclared:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
            def bump(self):
                with self._lock:
                    self.n += 1

        class Racy:
            _shared_attrs = ("n",)
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
            def bump(self):
                self.n += 1  # write OUTSIDE the lock
     """, None, {}, "locks", "declares no `_shared_attrs`"),
    ("purity_impure_keys_and_traced_code", "purity", """
        import time
        import jax

        class X:
            def _jit(self, key, fn):
                return fn
            def bad_key(self, node, fn):
                return self._jit(("agg", id(node)), fn)
            def bad_traced(self):
                def kern(x):
                    return x * time.time()
                return jax.jit(kern)
     """, """
        import time
        from presto_tpu_torch.exec import graphs

        class X:
            def compile(self, key, fn):
                return fn
            def bad_key(self, node, fn):
                return graphs.program(("agg", id(node)), fn, 1, "cuda")
            def bad_captured(self):
                def kern(s, c):
                    return s * time.time()
                return graphs.Program(kern, 1, "cuda")
     """, {}, "purity", "time.time"),
    ("purity_direct_cache_stores", "purity", """
        import time
        import jax

        class X:
            def impure_store(self, node):
                key = ("d_repart", id(node))
                self._jit_cache[key] = jax.jit(lambda x: x)
            def unrelated_memo(self, node):
                key = id(node)          # NOT a jit cache — no finding
                self._memo[key] = node
            def traced_shard_body(self):
                def body(x):
                    return x + time.time()
                self._jit_cache["k"] = jax.jit(
                    jax.shard_map(body, mesh=None))
     """, """
        import time
        from presto_tpu_torch.exec import graphs

        class X:
            def impure_store(self, node):
                key = ("d_repart", id(node))
                self._programs[key] = graphs.Program(lambda s, c: s, 1, 0)
            def unrelated_memo(self, node):
                key = id(node)          # NOT the program cache
                self._memo[key] = node
            def captured_body(self):
                def body(s, c):
                    return s + time.time()
                self._programs["k"] = graphs.Program(
                    functools.partial(body), 1, "cuda")
     """, {}, "purity", "'body'"),
]

# the blocking primitives each engine names, one per line of the same
# seeded file: (the reference's call, the port's call, port phrase)
PRIMITIVES = [
    ("jax.device_get(x)", "x.cpu()", ".cpu()"),
    ("jax.block_until_ready(x)", "torch.cuda.synchronize()",
     "synchronize"),
    ("jax.device_get(x)", "x.sum().item()", ".item()"),
    ("jax.device_get(x)", "x.numpy()", ".numpy()"),
    ("jax.device_put(x)", "XF.stage_into(x, y, 'seeded')", "stage_into"),
    ("XF.to_host(x)", "XF.to_host(x)", "to_host"),
    ("XF.np_host(x)", "XF.np_host(x)", "np_host"),
    ("SPOOL.spool_blob(x)", "SPOOL.spool_blob(x)", "spool_blob"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_seeded_case_matches_the_reference(tmp_path, case):
    _name, tool, ref_src, port_src, kw, rule, phrase = case
    ref = _run(tool, RLINT if tool in ("excepts", "locks", "purity")
               else RCON, _seeded(tmp_path, "ref", ref_src), kw)
    port = _run(tool, PLINT if tool in ("excepts", "locks", "purity")
                else PCON, _seeded(tmp_path, "port", port_src or ref_src),
                kw)
    assert _rule_lines(port) == _rule_lines(ref), (
        [str(f) for f in port], [str(f) for f in ref])
    if rule.startswith("no "):
        assert not [f for f in port if f.rule == rule[3:]]
    else:
        hits = [f for f in port if f.rule == rule]
        assert hits, [str(f) for f in port]
        assert any(phrase in f.message for f in hits), \
            [f.message for f in hits]


@pytest.mark.parametrize("ref_call,port_call,phrase", PRIMITIVES,
                         ids=[p[2] for p in PRIMITIVES])
def test_blocking_primitive_matches_the_reference(tmp_path, ref_call,
                                                  port_call, phrase):
    body = """
        import threading

        class X:
            _shared_attrs = ()
            def __init__(self):
                self._lock = threading.Lock()
            def bad(self, x, y):
                with self._lock:
                    return {call}
    """
    ref = RCON.run_concheck(paths=[_seeded(
        tmp_path, "ref", body.format(call=ref_call))])
    port = PCON.run_concheck(paths=[_seeded(
        tmp_path, "port", body.format(call=port_call))])
    assert _rule_lines(port) == _rule_lines(ref) == [
        ("con-blocking", 10), ("con-registry", 7)]
    blocking = [f for f in port if f.rule == "con-blocking"][0]
    assert phrase in blocking.message and "seeded.X._lock" in \
        blocking.message


def test_spans_rule_matches_the_reference(tmp_path):
    body = """
        def trace(tr):
            tr.begin("query", 0)
            tr.complete("seeded_kind", 0, 1)
    """
    ref = [f for f in RLINT.check_spans(
        paths=[_seeded(tmp_path, "ref", body)]) if "seeded" in f.path]
    port = [f for f in PLINT.check_spans(
        paths=[_seeded(tmp_path, "port", body)]) if "seeded" in f.path]
    assert _rule_lines(port) == _rule_lines(ref) == [("spans", 4)]
    assert "seeded_kind" in port[0].message


def test_counters_rule_matches_the_reference(tmp_path, monkeypatch):
    body = """
        class Executor:
            def __init__(self):
                self.seeded_counter = 0
            def bump(self):
                self.seeded_counter += 1
    """
    found = {}
    for side, mod in (("ref", RLINT), ("port", PLINT)):
        path = _seeded(tmp_path, side, body)
        monkeypatch.setattr(mod, "_py_files", lambda *roots, p=path: [p])
        found[side] = [f for f in mod.check_counters()
                       if "seeded" in f.path]
    assert _rule_lines(found["port"]) == _rule_lines(found["ref"]) == \
        [("counters", 6)]
    assert "seeded_counter" in found["port"][0].message


def test_session_props_rule_matches_the_reference(monkeypatch):
    import presto_tpu.session as RS
    import presto_tpu_torch.session as PS

    found = {}
    for side, sess, mod in (("ref", RS, RLINT), ("port", PS, PLINT)):
        props = dict(sess.SYSTEM_SESSION_PROPERTIES)
        props["seeded_prop"] = sess.PropertyMetadata(
            "seeded_prop", "", int, 0)
        monkeypatch.setattr(sess, "SYSTEM_SESSION_PROPERTIES", props)
        found[side] = [f for f in mod.check_session_props()
                       if "seeded_prop" in f.message]
    # an empty description, no etc key, no consumption site
    assert _rule_lines(found["port"]) == _rule_lines(found["ref"]) == \
        [("session-props", 1)] * 3


# ------------------------------------------------ repairs the gate found
def test_program_build_runs_off_the_cache_lock(monkeypatch):
    """graphs.program calls the caller's build() with _programs_lock
    free (a miss never stalls another query's lookup); two racing misses
    of one key get one Program, and a hit builds nothing."""
    import threading

    from presto_tpu_torch.exec import graphs

    monkeypatch.setattr(graphs, "_programs", type(graphs._programs)())
    builds = []
    started = threading.Barrier(2, timeout=10)

    def build():
        builds.append(graphs._programs_lock.locked())
        started.wait()
        return lambda starts, counts: starts

    got = []
    threads = [threading.Thread(target=lambda: got.append(graphs.program(
        ("seeded",), build, 1, "cpu"))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert builds == [False, False]
    assert got[0] is got[1]
    assert graphs.program(("seeded",), build, 1, "cpu") is got[0]
    assert len(builds) == 2


def test_task_and_runtime_writes_are_checked_by_the_sanitizer():
    """_Task and TaskRuntime declare their shared attributes and register
    with the runtime sanitizer, as the reference's do: a write outside
    the lock is a violation, one under it is not."""
    from presto_tpu_torch.obs import sanitizer as SAN
    from presto_tpu_torch.server import worker as W

    was = SAN.is_armed()
    SAN.arm()
    try:
        task = W._Task("t-seeded")
        rt = W.TaskRuntime({"tpch": None}, default_catalog="tpch",
                           device="cpu")
        SAN.reset()
        with task.lock:
            task.done = True
        rt.set_fault_config({"FAULT_DELAY_MS": 1})
        assert SAN.violations() == []
        task.error = "unlocked"
        rt.fault_config = {}
        got = SAN.violations()
        assert len(got) == 2, got
        assert "_Task.error" in got[0] and "TaskRuntime.fault_config" \
            in got[1]
    finally:
        SAN.reset()
        if not was:
            SAN.disarm()
