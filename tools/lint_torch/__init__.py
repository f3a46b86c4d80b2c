"""Engine-invariant linter over presto_tpu_torch/: AST checks for the
repo-specific rules no generic linter knows.

The port's counterpart of tools/lint (which holds presto_tpu/ to the
same rules). It imports neither jax nor presto_tpu nor the reference's
tools, so it runs where only torch is installed. Each rule holds the port
to what the reference rule holds presto_tpu/ to:

  session-props   every session property in presto_tpu_torch/session.py
                  has an etc key registered in config.ETC_SESSION_KEYS,
                  a typed default, a non-empty doc description, a doc row
                  in the README's port section, and a consumption site
                  (session.get(...)).
  counters        every integer counter the executor family maintains
                  (initialized to 0 in __init__, incremented with += in
                  exec/ or dist/) is declared in
                  exec/counters.QUERY_COUNTERS.
  excepts         no bare `except:`; a broad `except Exception` must
                  re-raise or carry an explained annotation
                  (`# noqa: BLE001 - <why>` or `# lint: broad-ok -
                  <why>`).
  locks           every class owning a threading lock or Condition
                  (created directly or via obs.sanitizer.make_lock/
                  make_condition) declares its shared attributes
                  (`_shared_attrs`) or carries `# lint: single-threaded
                  - <why>`; writes to declared attributes outside
                  __init__ happen under `with self.<lock>`, and an
                  under-lock write to an undeclared attribute fails.
                  The runtime half is obs/sanitizer.py; the acquisition
                  order half is tools/concheck_torch.py.
  purity          no time/random/uuid/id() reachable from the program-
                  cache keys of exec/graphs.py (the first argument of
                  `program(key, build, ...)`) or from the functions
                  handed to a graph capture (`program`'s build function,
                  `Program(fn, ...)`): a key or a captured program that
                  depends on the clock or on identity breaks the cache's
                  canonical keys and replays a graph that no longer
                  matches its inputs.
  spans           every trace-span kind emitted (a constant first
                  argument to a .begin(...)/.complete(...) recorder call)
                  is declared in obs.SPAN_KINDS, and every declared kind
                  has an emission site.

Run: `python -m tools.lint_torch` (exit 1 on findings);
tools/ci_static_torch.sh runs it first in the port's pre-PR gate.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Set, Tuple

REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

# the instrumentation layer itself is exempt from the lock-discipline
# sweep (its wrapper class OWNS a raw lock by design; concheck exempts
# it from the raw-lock rule for the same reason)
_LOCK_EXEMPT_FILES = ("presto_tpu_torch/obs/sanitizer.py",)

# the broad-except annotation: a trailing comment on the except line
# (or the line above) naming the suppression AND a reason after " - "
_BROAD_OK = re.compile(r"#\s*(noqa: BLE001|lint:\s*broad-ok)\s*-\s*\S")
_UNLOCKED_OK = re.compile(r"#\s*lint:\s*unlocked-ok\s*-\s*\S")
_SINGLE_THREADED_OK = re.compile(
    r"#\s*lint:\s*single-threaded\s*-\s*\S")

_PKG = "presto_tpu_torch"
# what the port runs besides its package: the tools that drive it and the
# card's smoke script (read by the consumption and emission sweeps)
_PORT_TOOLS = ("tools/chaos_torch.py", "tools/concheck_torch.py",
               "tools/lint_torch", "tools/plan_audit_torch.py",
               "chip_smoke.py")
_README_SECTION = "## PyTorch/CUDA port"

# callables that must not be reachable from program keys / captured code
_IMPURE_CALLS = {
    "id": "object identity (varies per process/run)",
    "time.time": "wall clock",
    "time.monotonic": "wall clock",
    "time.perf_counter": "wall clock",
    "time.time_ns": "wall clock",
    "random.random": "RNG",
    "random.randint": "RNG",
    "random.Random": "RNG",
    "uuid.uuid4": "RNG identity",
    "uuid.uuid1": "host identity",
    "datetime.now": "wall clock",
    "np.random": "RNG",
    "numpy.random": "RNG",
}


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _py_files(*rel_roots: str) -> List[str]:
    out = []
    for root in rel_roots:
        abs_root = os.path.join(REPO, root)
        if os.path.isfile(abs_root):
            out.append(abs_root)
            continue
        for dirpath, dirnames, filenames in os.walk(abs_root):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and
                           not d.startswith(".")]
            out.extend(os.path.join(dirpath, f)
                       for f in filenames if f.endswith(".py"))
    return sorted(out)


def _rel(path: str) -> str:
    return os.path.relpath(path, REPO)


def _parse(path: str) -> Tuple[ast.AST, List[str]]:
    with open(path) as f:
        src = f.read()
    return ast.parse(src, filename=path), src.splitlines()


def _dotted(node: ast.AST) -> Optional[str]:
    """Dotted name of a call target: Name -> 'f', Attribute chains ->
    'a.b.c'; None for dynamic targets."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ---------------------------------------------------------- rule: excepts
def check_excepts(paths: List[str]) -> List[Finding]:
    out: List[Finding] = []
    for path in paths:
        tree, lines = _parse(path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                out.append(Finding(
                    "excepts", _rel(path), node.lineno,
                    "bare `except:` — name the exception types (a "
                    "bare except swallows KeyboardInterrupt and "
                    "engine control-flow exceptions)"))
                continue
            names = []
            types = (node.type.elts
                     if isinstance(node.type, ast.Tuple)
                     else [node.type])
            for t in types:
                n = _dotted(t)
                if n:
                    names.append(n.rsplit(".", 1)[-1])
            if not ({"Exception", "BaseException"} & set(names)):
                continue
            # re-raise in the handler body is self-documenting
            if any(isinstance(x, ast.Raise) for b in node.body
                   for x in ast.walk(b)):
                continue
            ctx = "\n".join(lines[max(node.lineno - 2, 0):node.lineno])
            if _BROAD_OK.search(ctx):
                continue
            out.append(Finding(
                "excepts", _rel(path), node.lineno,
                "broad `except Exception` without re-raise or an "
                "explained annotation — narrow the types, re-raise, "
                "or annotate `# noqa: BLE001 - <why this is safe>`"))
    return out


# ------------------------------------------------------ rule: session-props
def check_session_props() -> List[Finding]:
    from presto_tpu_torch import config as CFG
    from presto_tpu_torch.session import SYSTEM_SESSION_PROPERTIES

    out: List[Finding] = []
    sess_path = os.path.join(REPO, _PKG, "session.py")
    mapped = set(CFG.ETC_SESSION_KEYS.values())
    for name, prop in sorted(SYSTEM_SESSION_PROPERTIES.items()):
        if not (prop.description or "").strip():
            out.append(Finding(
                "session-props", _rel(sess_path), 1,
                f"property {name!r} has an empty description (the "
                f"SHOW SESSION doc row)"))
        if prop.type not in (bool, int, str):
            out.append(Finding(
                "session-props", _rel(sess_path), 1,
                f"property {name!r} has unsupported type "
                f"{prop.type!r} (bool|int|str)"))
        elif not isinstance(prop.default, prop.type) and not (
            prop.type is int and isinstance(prop.default, int)
        ):
            out.append(Finding(
                "session-props", _rel(sess_path), 1,
                f"property {name!r} default {prop.default!r} is not "
                f"a {prop.type.__name__}"))
        if name not in mapped:
            out.append(Finding(
                "session-props", _rel(sess_path), 1,
                f"property {name!r} has no etc key in "
                f"config.ETC_SESSION_KEYS — deployments cannot pin "
                f"it fleet-wide (register e.g. "
                f"'{name.replace('_', '-')}')"))
    for etc_key, name in sorted(CFG.ETC_SESSION_KEYS.items()):
        if name not in SYSTEM_SESSION_PROPERTIES:
            out.append(Finding(
                "session-props", f"{_PKG}/config.py", 1,
                f"etc key {etc_key!r} names unknown session "
                f"property {name!r}"))
    # consumption: every property must be read somewhere in the engine
    consumed: Set[str] = set()
    for path in _py_files(_PKG, *_PORT_TOOLS):
        tree, _ = _parse(path)
        for node in ast.walk(tree):
            # READS only — a session.set() write is not consumption
            # (a write-only property is exactly the plumbing gap this
            # rule exists to flag)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("get", "is_set") and \
                    node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                consumed.add(node.args[0].value)
    for name in sorted(set(SYSTEM_SESSION_PROPERTIES) - consumed):
        out.append(Finding(
            "session-props", _rel(sess_path), 1,
            f"property {name!r} is declared but never consumed "
            f"(no session.get/is_set site in the engine)"))
    # doc row: the etc key must appear in the config table of README's
    # port section (the rest of README documents presto_tpu/)
    readme = _readme_port_section()
    for etc_key in sorted(CFG.ETC_SESSION_KEYS):
        if f"`{etc_key}`" not in readme:
            out.append(Finding(
                "session-props", "README.md", 1,
                f"etc key {etc_key!r} is undocumented — add it to the "
                f"deployment-config table of README's port section"))
    # K4's exchange partition-id hash (an fmix32 fold) is NOT compatible
    # with the splitmix64 tier, so pallas-join.enabled's doc row must
    # carry the warning that a per-process backend auto-probe would
    # mis-route co-partitioned keys on a mixed pool — a silently dropped
    # caveat here re-opens a wrong-results hole, hence a build gate
    pj_row = next(
        (ln for ln in readme.splitlines()
         if ln.strip().startswith("| `pallas-join.enabled`")), "")
    if "mixed pool" not in pj_row or "mis-route" not in pj_row:
        out.append(Finding(
            "session-props", "README.md", 1,
            "the `pallas-join.enabled` config-table row must state "
            "the mixed-pool hashing caveat (K4 partition ids "
            "are not splitmix64-compatible; auto-probing the "
            "backend per process would mis-route co-partitioned "
            "keys)"))
    return out


def _readme_port_section() -> str:
    """README.md from the port's heading to the next level-2 heading."""
    with open(os.path.join(REPO, "README.md")) as f:
        lines = f.read().splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith(_README_SECTION))
    end = next((i for i in range(start + 1, len(lines))
                if lines[i].startswith("## ")), len(lines))
    return "\n".join(lines[start:end])


# --------------------------------------------------------- rule: counters
# executor attributes that look like counters but are deliberately not
# in the per-query registry, with the reason
_COUNTER_EXEMPT = {
    "host_spill_bytes_used": "byte volume, reported via "
                             "host_spill_pages + page sizes",
    "_capacity_boost": "retry-ladder state, not a counter",
    "_oom_divisor": "retry-ladder state, not a counter",
    "_live_bytes": "accounting intermediate",
    "peak_memory_bytes": "high-water gauge surfaced as "
                         "peak_device_bytes (computed entry)",
    "compile_wall_s": "float wall surfaced as a computed entry",
    "transfer_wall_s": "float wall surfaced as a computed entry "
                       "(exec/xfer.py crossing wall)",
    "spooled_exchange_rows": "the spool's row volume, a reading of the "
                             "chip check (chip_smoke.py dist phase), "
                             "not a registry counter",
}


# the classes whose integer state IS the per-query counter surface
_COUNTER_CLASSES = ("Executor", "DistExecutor", "DcnRunner")


def check_counters() -> List[Finding]:
    from presto_tpu_torch.exec.counters import QUERY_COUNTERS

    out: List[Finding] = []
    # counters = attrs initialized to integer 0 in the __init__ of an
    # executor-family class AND incremented with += anywhere in exec/
    # or dist/ (a PageStore's internal byte tally is not a query
    # counter; the executor's classes define the observable surface)
    zero_init: Dict[str, Tuple[str, int]] = {}
    incremented: Dict[str, Tuple[str, int]] = {}
    written: Set[str] = set()  # non-__init__ writes (registry health)
    for path in _py_files(f"{_PKG}/exec", f"{_PKG}/dist"):
        tree, _ = _parse(path)
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            in_counter_cls = cls.name in _COUNTER_CLASSES
            for meth in (n for n in cls.body
                         if isinstance(n, ast.FunctionDef)):
                for node in ast.walk(meth):
                    if isinstance(node, ast.Assign) and \
                            meth.name == "__init__" and \
                            in_counter_cls and \
                            len(node.targets) == 1 and \
                            isinstance(node.targets[0],
                                       ast.Attribute) and \
                            isinstance(node.targets[0].value,
                                       ast.Name) and \
                            node.targets[0].value.id == "self" and \
                            isinstance(node.value, ast.Constant) and \
                            node.value.value == 0 and \
                            not isinstance(node.value.value, bool):
                        zero_init.setdefault(
                            node.targets[0].attr,
                            (_rel(path), node.lineno))
                    if meth.name != "__init__" and isinstance(
                            node, (ast.Assign, ast.AugAssign)):
                        tgts = (node.targets if isinstance(
                            node, ast.Assign) else [node.target])
                        for t in tgts:
                            if isinstance(t, ast.Attribute):
                                written.add(t.attr)
                    if isinstance(node, ast.AugAssign) and \
                            isinstance(node.op, ast.Add) and \
                            isinstance(node.target, ast.Attribute):
                        incremented.setdefault(
                            node.target.attr,
                            (_rel(path), node.lineno))
    counters = set(zero_init) & set(incremented)
    for name in sorted(counters):
        if name in QUERY_COUNTERS or name in _COUNTER_EXEMPT:
            continue
        path, line = incremented[name]
        out.append(Finding(
            "counters", path, line,
            f"counter {name!r} (zero-initialized and incremented) is "
            f"not declared in exec/counters.QUERY_COUNTERS — it will "
            f"not reach EXPLAIN ANALYZE, /metrics, system.metrics, "
            f"or analyze_rung"))
    for name in sorted(QUERY_COUNTERS):
        if name not in zero_init or name not in written:
            out.append(Finding(
                "counters", f"{_PKG}/exec/counters.py", 1,
                f"registry declares {name!r} but no executor-family "
                f"zero-init + write site exists in exec/ or dist/ "
                f"(stale entry?)"))
    return out


# ------------------------------------------------------------ rule: locks
# a lock-owning class is detected by VALUE, not attribute name: any
# assignment whose RHS constructs a threading primitive or goes
# through the sanitizer factory counts, so `_fault_lock`, `_cv`, and
# class-level `_instances_lock` all bind their owner to the contract
_LOCKISH_TAILS = ("Lock", "RLock", "Condition",
                  "make_lock", "make_condition")


def _lockish(value: ast.AST) -> bool:
    return isinstance(value, ast.Call) and \
        (_dotted(value.func) or "").rsplit(".", 1)[-1] in _LOCKISH_TAILS


def _lock_classes(tree: ast.AST) -> List[Tuple[ast.ClassDef, Set[str]]]:
    """(class, lock-attribute names) for every lock-owning class."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        attrs: Set[str] = set()
        for stmt in node.body:  # class-level locks (Name targets)
            if isinstance(stmt, ast.Assign) and _lockish(stmt.value):
                attrs.update(t.id for t in stmt.targets
                             if isinstance(t, ast.Name))
        for sub in ast.walk(node):  # instance locks (self.X targets)
            if isinstance(sub, ast.Assign) and _lockish(sub.value):
                attrs.update(t.attr for t in sub.targets
                             if isinstance(t, ast.Attribute) and
                             isinstance(t.value, ast.Name) and
                             t.value.id == "self")
        if attrs:
            out.append((node, attrs))
    return out


def _declared_shared(cls: ast.ClassDef) -> Optional[Set[str]]:
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign) and \
                any(isinstance(t, ast.Name) and
                    t.id == "_shared_attrs" for t in stmt.targets):
            try:
                return set(ast.literal_eval(stmt.value))
            except ValueError:
                return set()
    return None


class _LockWalk(ast.NodeVisitor):
    """Per-method walk tracking lexical `with self.<lock>:` nesting
    for the owning class's detected lock attributes (a Condition
    fronting the lock counts: holding it IS holding the lock)."""

    def __init__(self, lock_attrs: Optional[Set[str]] = None):
        self.lock_attrs = lock_attrs or {"_lock", "lock"}
        self.depth = 0
        # attr -> [(line, under_lock)]
        self.writes: List[Tuple[str, int, bool]] = []

    def visit_With(self, node: ast.With):
        # only SELF's lock protects self's shared attributes — a
        # `with q.lock:` on some other object must not count
        locked = any(
            isinstance(item.context_expr, ast.Attribute) and
            item.context_expr.attr in self.lock_attrs and
            isinstance(item.context_expr.value, ast.Name) and
            item.context_expr.value.id in ("self", "cls")
            for item in node.items
        )
        if locked:
            self.depth += 1
        self.generic_visit(node)
        if locked:
            self.depth -= 1

    def _record(self, target, line):
        # self.attr = / self.attr += / self.attr[k] =
        if isinstance(target, ast.Subscript):
            target = target.value
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            self.writes.append((target.attr, line, self.depth > 0))

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._record(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._record(node.target, node.lineno)
        self.generic_visit(node)


def check_locks(paths=None) -> List[Finding]:
    out: List[Finding] = []
    if paths is None:
        paths = [_rel(p) for p in _py_files(_PKG)
                 if _rel(p) not in _LOCK_EXEMPT_FILES]
    for rel in paths:
        path = rel if os.path.isabs(rel) else os.path.join(REPO, rel)
        rel = _rel(path)
        tree, lines = _parse(path)
        for cls, lock_attrs in _lock_classes(tree):
            declared = _declared_shared(cls)
            observed: Dict[str, int] = {}
            unlocked: List[Tuple[str, int]] = []
            for meth in (n for n in cls.body
                         if isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))):
                walker = _LockWalk(lock_attrs | {"_lock", "lock"})
                # `*_locked` helper convention: the suffix documents
                # "caller holds the lock" — the walker starts held.
                # The convention's HONESTY is enforced at runtime by
                # obs/sanitizer.py (a caller that doesn't hold the
                # lock trips the unlocked-shared-write check live)
                if meth.name.endswith("_locked"):
                    walker.depth = 1
                walker.visit(meth)
                init = meth.name == "__init__"
                for attr, line, under in walker.writes:
                    if attr in lock_attrs or attr.endswith("lock"):
                        continue
                    if under:
                        observed.setdefault(attr, line)
                    elif not init:
                        unlocked.append((attr, line))
            if declared is None:
                ctx = "\n".join(
                    lines[max(cls.lineno - 2, 0):cls.lineno])
                if not _SINGLE_THREADED_OK.search(ctx):
                    out.append(Finding(
                        "locks", rel, cls.lineno,
                        f"class {cls.name} owns a lock "
                        f"({sorted(lock_attrs)}) but declares no "
                        f"`_shared_attrs` — declare the shared set "
                        f"(observed under-lock writes: "
                        f"{sorted(observed)}) so the race contract "
                        f"is reviewable, or annotate the class "
                        f"`# lint: single-threaded - <why>`"))
                declared = set(observed)
            declared = declared or set()
            for attr in sorted(set(observed) - declared):
                out.append(Finding(
                    "locks", rel, observed[attr],
                    f"class {cls.name}: attribute {attr!r} is "
                    f"written under the lock but missing from "
                    f"_shared_attrs"))
            for attr, line in unlocked:
                if attr not in declared:
                    continue
                ctx = "\n".join(lines[max(line - 2, 0):line])
                if _UNLOCKED_OK.search(ctx):
                    continue
                out.append(Finding(
                    "locks", rel, line,
                    f"class {cls.name}: shared attribute {attr!r} "
                    f"written OUTSIDE `with self._lock` — a write "
                    f"race with the background thread (annotate "
                    f"`# lint: unlocked-ok - <why>` if provably "
                    f"single-threaded)"))
    return out


# ----------------------------------------------------------- rule: purity
def _impure_name(call: ast.Call) -> Optional[str]:
    name = _dotted(call.func)
    if name is None:
        return None
    if name in _IMPURE_CALLS:
        return name
    # match module-qualified tails: _time.monotonic, np.random.normal
    for bad in _IMPURE_CALLS:
        if "." in bad and (name.endswith("." + bad)
                           or name.startswith(bad + ".")
                           or ("." in name and
                               name.split(".", 1)[1] == bad)):
            return bad
    return None


def _scan_key_expr(expr, path, out: List[Finding]) -> None:
    """Flag impure calls / dict literals inside a program-cache key."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            bad = _impure_name(sub)
            if bad:
                out.append(Finding(
                    "purity", _rel(path), sub.lineno,
                    f"program-cache key computed from {bad}() "
                    f"[{_IMPURE_CALLS[bad]}] — keys must be "
                    f"canonical and re-key byte-identical"))
        if isinstance(sub, ast.Dict):
            out.append(Finding(
                "purity", _rel(path), sub.lineno,
                "program-cache key contains a dict literal "
                "(iteration-order-dependent)"))


# exec/graphs.py's cache surface: `program(key, build, batch, device)`
# keys the process-wide cache and captures what `build()` returns;
# `Program(fn, ...)` captures ``fn``; `_programs[key] = ...` stores
_KEYED = "program"
_CAPTURES = {"program": 1, "Program": 0}  # call tail -> first fn arg
_STORE = "_programs"


def check_purity(paths=None) -> List[Finding]:
    out: List[Finding] = []
    for path in (paths or _py_files(f"{_PKG}/exec", f"{_PKG}/ops",
                                    f"{_PKG}/dist")):
        tree, _ = _parse(path)
        # module-local function defs by name (incl. nested). Same-name
        # nested defs (the executor's many `build` closures) ALL
        # collect — reachability checks every candidate, an
        # over-approximation in the safe direction.
        defs: Dict[str, List[ast.FunctionDef]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef):
                defs.setdefault(node.name, []).append(node)
        # simple `name = <expr>` assignments resolved WITHIN the
        # enclosing function only, so a key built as `gkey = (...)`
        # then `graphs.program(gkey, ...)` checks, while an unrelated
        # `key = id(node)` in a DIFFERENT method (a memo that is not
        # the program cache) does not bleed into the candidates
        enclosing: Dict[int, ast.FunctionDef] = {}

        def _map_parents(fn_stack, node):
            if isinstance(node, ast.FunctionDef):
                fn_stack = fn_stack + [node]
            enclosing[id(node)] = fn_stack[-1] if fn_stack else None
            for child in ast.iter_child_nodes(node):
                _map_parents(fn_stack, child)

        _map_parents([], tree)

        def local_exprs(store_node, name: str) -> List[ast.AST]:
            fn = enclosing.get(id(store_node))
            if fn is None:
                return []
            return [n.value for n in ast.walk(fn)
                    if isinstance(n, ast.Assign) and
                    len(n.targets) == 1 and
                    isinstance(n.targets[0], ast.Name) and
                    n.targets[0].id == name]

        def key_exprs(node, expr) -> List[ast.AST]:
            return ([expr] if not isinstance(expr, ast.Name)
                    else local_exprs(node, expr.id))

        def impure_in(fn: ast.FunctionDef, seen: Set[str]):
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call):
                    bad = _impure_name(sub)
                    if bad:
                        return bad, sub.lineno
                    callee = _dotted(sub.func)
                    if callee in defs and callee not in seen:
                        seen.add(callee)
                        for cand in defs[callee]:
                            hit = impure_in(cand, seen)
                            if hit:
                                return hit
            return None

        def check_captured(fname: str):
            for cand in defs.get(fname, ()):
                hit = impure_in(cand, {fname})
                if hit:
                    bad, line = hit
                    out.append(Finding(
                        "purity", _rel(path), line,
                        f"{bad}() [{_IMPURE_CALLS[bad]}] reachable "
                        f"from captured function {fname!r} — a graph "
                        f"replays what its capture recorded, so "
                        f"captured programs must be deterministic"))

        for node in ast.walk(tree):
            # direct cache stores: _programs[key] = Program(...)
            if isinstance(node, ast.Assign) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Subscript) and \
                    (_dotted(node.targets[0].value) or "").rsplit(
                        ".", 1)[-1] == _STORE:
                for e in key_exprs(node, node.targets[0].slice):
                    _scan_key_expr(e, path, out)
                continue
            if not isinstance(node, ast.Call):
                continue
            tail = (_dotted(node.func) or "").rsplit(".", 1)[-1]
            # (a) key expressions: first arg of program(key, build, ...)
            if tail == _KEYED and node.args:
                for e in key_exprs(node, node.args[0]):
                    _scan_key_expr(e, path, out)
            # (b) captured functions: the function args of program/
            #     Program, by name, through functools.partial, or as
            #     the factory call that makes them (build_xq(n, w))
            if tail in _CAPTURES:
                for arg in node.args[_CAPTURES[tail]:]:
                    fname = None
                    if isinstance(arg, ast.Name):
                        fname = arg.id
                    elif isinstance(arg, ast.Call):
                        callee = _dotted(arg.func) or ""
                        if callee.endswith("partial") and arg.args and \
                                isinstance(arg.args[0], ast.Name):
                            fname = arg.args[0].id
                        elif isinstance(arg.func, ast.Name):
                            fname = arg.func.id
                    if fname:
                        check_captured(fname)
    return out


# ------------------------------------------------------------ rule: spans
# the span-recorder emission methods (obs/trace.QueryTrace; _new is
# the internal constructor the root "query" span uses). A call
# `<anything>.begin("kind", ...)` / `.complete("kind", ...)` with a
# constant first argument IS an emission site; dynamic kinds (the
# ingest path re-materializing remote spans) are invisible here by
# design — every dynamic kind originates at some constant site.
_SPAN_EMIT_METHODS = ("begin", "complete", "_new")


def check_spans(paths=None) -> List[Finding]:
    from presto_tpu_torch.obs import SPAN_KINDS

    out: List[Finding] = []
    emitted: Dict[str, Tuple[str, int]] = {}
    for path in (paths or _py_files(_PKG, *_PORT_TOOLS)):
        tree, _ = _parse(path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SPAN_EMIT_METHODS and \
                    node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                emitted.setdefault(node.args[0].value,
                                   (_rel(path), node.lineno))
    for kind, (path, line) in sorted(emitted.items()):
        if kind not in SPAN_KINDS:
            out.append(Finding(
                "spans", path, line,
                f"span kind {kind!r} is emitted but not declared in "
                f"obs.SPAN_KINDS — trace surfaces (QueryInfo tree, "
                f"Chrome export, analyze_rung) would carry an "
                f"undocumented vocabulary; declare it with help text"))
    for kind in sorted(set(SPAN_KINDS) - set(emitted)):
        out.append(Finding(
            "spans", f"{_PKG}/obs/__init__.py", 1,
            f"SPAN_KINDS declares {kind!r} but no "
            f".begin()/.complete() emission site exists in the "
            f"engine (stale entry?)"))
    return out


# ------------------------------------------------------------------ entry
ALL_RULES = ("excepts", "session-props", "counters", "locks",
             "purity", "spans")


def run_lint(rules=ALL_RULES) -> List[Finding]:
    findings: List[Finding] = []
    if "excepts" in rules:
        findings += check_excepts(
            _py_files(_PKG, *_PORT_TOOLS))
    if "session-props" in rules:
        findings += check_session_props()
    if "counters" in rules:
        findings += check_counters()
    if "locks" in rules:
        findings += check_locks()
    if "purity" in rules:
        findings += check_purity()
    if "spans" in rules:
        findings += check_spans()
    return findings
