#!/usr/bin/env python
"""concheck_torch: the static concurrency soundness pass over
presto_tpu_torch/ — the build-time half of the layer whose runtime half
is presto_tpu_torch/obs/sanitizer.py.

The port's counterpart of tools/concheck.py, with the same three AST
rules, held against the port's obs/sanitizer.LOCK_REGISTRY and
THREAD_REGISTRY. It imports neither jax nor presto_tpu nor the
reference's tools.

  con-registry   the lock inventory. Every lock/Condition is created
                 through obs.sanitizer.make_lock/make_condition with a
                 canonical site name (module.Class.attr) declared in
                 sanitizer.LOCK_REGISTRY; raw threading.Lock/RLock/
                 Condition construction outside the sanitizer is a
                 finding. Every threading.Thread target is declared in
                 sanitizer.THREAD_REGISTRY. Stale registry entries fail
                 like stale QUERY_COUNTERS entries.
  con-graph      the static lock-acquisition graph: which locks can be
                 HELD WHILE ACQUIRING which others — lexical `with`
                 nesting plus calls resolved ONE level deep (`*_locked`
                 helper methods count as holding their class's locks).
                 A cycle is a potential deadlock and fails.
  con-blocking   no blocking call while any registered lock is held —
                 directly, inside a `*_locked` helper, or one call level
                 deep. The blocking primitives are the port's:
                 time.sleep, urlopen, subprocess, torch.cuda.synchronize
                 and the host reads `.cpu()`, `.item()`, `.numpy()`,
                 and the exec/xfer.py choke points (to_host, to_device,
                 np_host, stage_into) with dist/spool.spool_blob. A
                 deliberate exception carries `# concheck: blocking-ok
                 - <why>` on the call line (or the line above).

Known approximations, chosen to be safe-but-quiet: locks are tracked per
NAME (class granularity); call resolution is by method/function name
across the tree (same-named functions all count); unresolvable receivers
(`x._lock` where several classes own a `_lock`) are treated as held for
the blocking rule but excluded from the graph, so ambiguity can never
fabricate a cycle.

Run: `python tools/concheck_torch.py` (exit 1 on findings);
tools/ci_static_torch.sh runs it after tools/lint_torch.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, List, Optional, Set, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # direct `python tools/concheck_torch.py` runs
    sys.path.insert(0, REPO)

from tools.lint_torch import (  # noqa: E402
    _LOCK_EXEMPT_FILES,
    Finding,
    _dotted,
    _parse,
    _py_files,
    _rel,
)

# the instrumentation layer itself (owns the one raw meta-lock): one
# shared exemption list with the lint locks rule, so the two gates
# can never disagree about what is instrumentation-layer code
_EXEMPT_FILES = _LOCK_EXEMPT_FILES

_BLOCKING_OK = re.compile(r"#\s*concheck:\s*blocking-ok\s*-\s*\S")

_LOCK_CTORS = ("Lock", "RLock", "Condition")
_FACTORIES = ("make_lock", "make_condition")

# blocking tails; subprocess entry points additionally require the
# `subprocess.` prefix ("run"/"call" alone are far too generic)
_BLOCKING_TAILS = {
    "sleep": "stalls the holder while every other thread queues on "
             "the lock",
    "urlopen": "network I/O under a lock serializes the engine behind "
               "a peer's latency",
    "synchronize": "a device fence under a lock serializes readers "
                   "behind the card",
    "cpu": "a device-to-host copy under a lock waits for the card's "
           "queue and serializes readers behind it",
    "item": "a host read of a device scalar under a lock waits for the "
            "card's queue",
    "numpy": "a host view of a tensor under a lock (a device sync when "
             "the tensor is on the card)",
    # the metered choke points (exec/xfer.py) are still device syncs:
    # routing a crossing does not make it lock-safe
    "to_host": "a metered d2h pull under a lock serializes readers "
               "behind the card",
    "to_device": "a metered h2d stage under a lock serializes readers "
                 "behind the card",
    "np_host": "a metered d2h view under a lock serializes readers "
               "behind the card when the array is device-backed",
    "stage_into": "a metered h2d copy into a device buffer under a lock "
                  "serializes readers behind the card",
    # lazy spool materialization (dist/spool.spool_blob) is a d2h pull
    # plus serialization — never under a task or registry lock
    "spool_blob": "lazy spool materialization (d2h + serialize) under "
                  "a lock stalls every consumer and status poll "
                  "behind the card",
}
_SUBPROCESS_TAILS = ("run", "call", "check_call", "check_output",
                     "Popen")


def _call_name(func: ast.AST) -> Optional[str]:
    """The dotted call target, or `<expr>.attr` for a method called on
    a computed receiver (`t.detach().cpu()`): the port's host reads are
    methods of whatever tensor expression precedes them."""
    name = _dotted(func)
    if name is None and isinstance(func, ast.Attribute):
        return f"<expr>.{func.attr}"
    return name


def _is_blocking(dotted: Optional[str]) -> Optional[str]:
    if not dotted:
        return None
    tail = dotted.rsplit(".", 1)[-1]
    if tail in _BLOCKING_TAILS:
        return dotted
    if tail in _SUBPROCESS_TAILS and "subprocess" in dotted:
        return dotted
    return None


def _modrel(path: str) -> str:
    """Dotted module path under presto_tpu_torch/ ('cache.store'); files
    outside the tree (seeded test files) use their basename."""
    rel = os.path.relpath(os.path.abspath(path),
                          os.path.join(REPO, "presto_tpu_torch"))
    if rel.startswith(".."):
        rel = os.path.basename(path)
    return rel[:-3].replace(os.sep, ".") if rel.endswith(".py") \
        else rel.replace(os.sep, ".")


def _body_walk(node: ast.AST):
    """Walk a function body WITHOUT descending into nested function/
    class definitions (closures are separate functions with their own
    lock context) or lambdas."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


class _Fn:
    """One function/method with its lock-resolution context."""

    def __init__(self, node, module: "_Module", cls_name: Optional[str]):
        self.node = node
        self.module = module
        self.cls_name = cls_name
        self.name = node.name
        self.qual = (f"{module.modrel}."
                     f"{cls_name + '.' if cls_name else ''}{node.name}")


class _Module:
    def __init__(self, path: str):
        self.path = path
        self.rel = _rel(path)
        self.modrel = _modrel(path)
        self.tree, self.lines = _parse(path)
        # lock attr -> canonical name, per class / module-level
        self.class_locks: Dict[str, Dict[str, str]] = {}
        self.module_locks: Dict[str, str] = {}
        # (expected canonical, literal-or-None, line, has_name_arg)
        self.factory_sites: List[Tuple[str, Optional[str], int, bool]] \
            = []
        self.raw_sites: List[Tuple[int, str]] = []
        self.thread_targets: List[Tuple[Optional[str], int]] = []
        self.functions: List[_Fn] = []

    def escape_ok(self, line: int) -> bool:
        ctx = "\n".join(self.lines[max(line - 2, 0):line])
        return bool(_BLOCKING_OK.search(ctx))


def _name_literal(call: ast.Call) -> Tuple[Optional[str], bool]:
    """(string literal of the name argument, name-arg-present)."""
    args = list(call.args)
    for kw in call.keywords:
        if kw.arg == "name":
            args.insert(0, kw.value)
    if not args:
        return None, False
    a = args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value, True
    return None, True


def _has_lock_kwarg(call: ast.Call) -> bool:
    return any(kw.arg == "lock" for kw in call.keywords)


def collect(paths: List[str]) -> List[_Module]:
    mods: List[_Module] = []
    for path in paths:
        if _rel(path) in _EXEMPT_FILES:
            continue
        m = _Module(path)
        mods.append(m)

        def note_lock(owner_cls: Optional[str], attr: str,
                      call: ast.Call, line: int) -> None:
            tail = (_dotted(call.func) or "").rsplit(".", 1)[-1]
            canonical = (f"{m.modrel}."
                         f"{owner_cls + '.' if owner_cls else ''}"
                         f"{attr}")
            if tail in _FACTORIES:
                if tail == "make_condition" and _has_lock_kwarg(call):
                    # alias: Condition fronting an existing lock — the
                    # attr resolves to the backing lock's name
                    lk = None
                    for kw in call.keywords:
                        if kw.arg == "lock" and isinstance(
                                kw.value, ast.Attribute):
                            lk = kw.value.attr
                    owner = m.class_locks.get(owner_cls or "", {})
                    canonical = owner.get(lk, canonical)
                else:
                    literal, has = _name_literal(call)
                    m.factory_sites.append(
                        (canonical, literal, line, has))
                    if literal:
                        canonical = literal
            else:
                m.raw_sites.append((line, tail))
            if owner_cls is None:
                m.module_locks[attr] = canonical
            else:
                m.class_locks.setdefault(owner_cls, {})[attr] = \
                    canonical

        # pass 1: lock definitions + thread targets + functions
        def scan(node, cls_name: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    scan(child, child.name)
                    continue
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    m.functions.append(_Fn(child, m, cls_name))
                    scan(child, cls_name)
                    continue
                if isinstance(child, ast.Assign) and isinstance(
                        child.value, ast.Call):
                    tail = (_dotted(child.value.func) or
                            "").rsplit(".", 1)[-1]
                    if tail in _LOCK_CTORS + _FACTORIES:
                        root = (_dotted(child.value.func) or
                                "").split(".", 1)[0]
                        is_threading = (tail in _LOCK_CTORS and
                                        root == "threading")
                        if is_threading or tail in _FACTORIES:
                            for t in child.targets:
                                if isinstance(t, ast.Attribute) and \
                                        isinstance(t.value, ast.Name) \
                                        and t.value.id in ("self",
                                                           "cls"):
                                    note_lock(cls_name, t.attr,
                                              child.value,
                                              child.lineno)
                                elif isinstance(t, ast.Name):
                                    note_lock(
                                        cls_name if isinstance(
                                            node, ast.ClassDef)
                                        else None,
                                        t.id, child.value,
                                        child.lineno)
                scan(child, cls_name)

        scan(m.tree, None)
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Call) and \
                    (_dotted(node.func) or "").endswith(
                        "threading.Thread"):
                target = None
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = _dotted(kw.value)
                m.thread_targets.append((target, node.lineno))
    return mods


class _Index:
    """Cross-module resolution index."""

    def __init__(self, mods: List[_Module]):
        self.mods = mods
        self.fn_by_name: Dict[str, List[_Fn]] = {}
        self.init_by_class: Dict[str, List[_Fn]] = {}
        self.attr_owners: Dict[str, Set[str]] = {}
        for m in mods:
            for fn in m.functions:
                self.fn_by_name.setdefault(fn.name, []).append(fn)
                if fn.name == "__init__" and fn.cls_name:
                    self.init_by_class.setdefault(
                        fn.cls_name, []).append(fn)
            for cls, locks in m.class_locks.items():
                for attr, canon in locks.items():
                    self.attr_owners.setdefault(attr, set()).add(canon)
            for attr, canon in m.module_locks.items():
                self.attr_owners.setdefault(attr, set()).add(canon)
        self._acquires: Dict[int, List[str]] = {}
        self._blocking: Dict[int, List[Tuple[str, int]]] = {}

    # ------------------------------------------------- lock resolution
    def resolve_lock(self, expr, fn: _Fn) -> Optional[str]:
        """Canonical lock name for a `with` target; '?attr' when the
        receiver is ambiguous (held for blocking, excluded from the
        graph); None when it is not a known lock."""
        if isinstance(expr, ast.Name):
            return fn.module.module_locks.get(expr.id)
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        if isinstance(expr.value, ast.Name):
            recv = expr.value.id
            if recv in ("self", "cls") and fn.cls_name:
                hit = fn.module.class_locks.get(
                    fn.cls_name, {}).get(attr)
                if hit:
                    return hit
            for m in self.mods:  # ClassName._class_lock
                if recv in m.class_locks and \
                        attr in m.class_locks[recv]:
                    return m.class_locks[recv][attr]
        owners = self.attr_owners.get(attr, set())
        if len(owners) == 1:
            return next(iter(owners))
        if owners:
            return f"?{attr}"
        return None

    def resolve_callees(self, call: ast.Call) -> List[_Fn]:
        name = _dotted(call.func)
        if not name:
            return []
        tail = name.rsplit(".", 1)[-1]
        if tail in self.init_by_class:
            return self.init_by_class[tail]
        return self.fn_by_name.get(tail, [])

    # --------------------------------------- per-function derived facts
    def direct_acquires(self, fn: _Fn) -> List[str]:
        got = self._acquires.get(id(fn))
        if got is None:
            got = []
            for n in _body_walk(fn.node):
                if isinstance(n, ast.With):
                    for item in n.items:
                        canon = self.resolve_lock(
                            item.context_expr, fn)
                        if canon and not canon.startswith("?"):
                            got.append(canon)
            self._acquires[id(fn)] = got
        return got

    def direct_blocking(self, fn: _Fn) -> List[Tuple[str, int]]:
        got = self._blocking.get(id(fn))
        if got is None:
            got = []
            for n in _body_walk(fn.node):
                if isinstance(n, ast.Call):
                    bad = _is_blocking(_call_name(n.func))
                    if bad:
                        got.append((bad, n.lineno))
            self._blocking[id(fn)] = got
        return got


# ------------------------------------------------------- rule: registry
def check_registry(mods: List[_Module], lock_registry=None,
                   thread_registry=None,
                   full_sweep: bool = False) -> List[Finding]:
    if lock_registry is None or thread_registry is None:
        from presto_tpu_torch.obs import sanitizer as SAN

        lock_registry = (SAN.LOCK_REGISTRY if lock_registry is None
                         else lock_registry)
        thread_registry = (SAN.THREAD_REGISTRY if thread_registry
                           is None else thread_registry)
    out: List[Finding] = []
    seen_locks: Set[str] = set()
    seen_threads: Set[str] = set()
    for m in mods:
        for line, tail in m.raw_sites:
            out.append(Finding(
                "con-registry", m.rel, line,
                f"raw threading.{tail}() construction — create engine "
                f"locks through obs.sanitizer.make_lock/make_condition "
                f"so the runtime sanitizer can instrument them and "
                f"this pass can name them"))
        for canonical, literal, line, has_name in m.factory_sites:
            if not has_name or literal is None:
                out.append(Finding(
                    "con-registry", m.rel, line,
                    f"lock factory call needs a string-literal site "
                    f"name (expected {canonical!r}) — dynamic names "
                    f"defeat the registry cross-check"))
                continue
            seen_locks.add(literal)
            if literal != canonical:
                out.append(Finding(
                    "con-registry", m.rel, line,
                    f"lock name {literal!r} does not match its site — "
                    f"the canonical name here is {canonical!r} "
                    f"(module.Class.attr), which is what the runtime "
                    f"sanitizer's reports and the lock graph key on"))
            if literal not in lock_registry:
                out.append(Finding(
                    "con-registry", m.rel, line,
                    f"lock {literal!r} is not declared in "
                    f"obs.sanitizer.LOCK_REGISTRY — declare it with "
                    f"help text (the QUERY_COUNTERS discipline "
                    f"applied to locks)"))
        for target, line in m.thread_targets:
            if target is None:
                out.append(Finding(
                    "con-registry", m.rel, line,
                    "threading.Thread with a dynamic target — use a "
                    "named method so the thread inventory stays "
                    "auditable"))
                continue
            key = f"{m.modrel}:{target}"
            seen_threads.add(key)
            if key not in thread_registry:
                out.append(Finding(
                    "con-registry", m.rel, line,
                    f"thread target {key!r} is not declared in "
                    f"obs.sanitizer.THREAD_REGISTRY — declare it with "
                    f"help text"))
    if full_sweep:
        for name in sorted(set(lock_registry) - seen_locks):
            out.append(Finding(
                "con-registry", "presto_tpu_torch/obs/sanitizer.py", 1,
                f"LOCK_REGISTRY declares {name!r} but no "
                f"make_lock/make_condition site exists (stale entry?)"))
        for name in sorted(set(thread_registry) - seen_threads):
            out.append(Finding(
                "con-registry", "presto_tpu_torch/obs/sanitizer.py", 1,
                f"THREAD_REGISTRY declares {name!r} but no "
                f"threading.Thread site exists (stale entry?)"))
    return out


# ------------------------------------------------- graph + blocking walk
def _held_regions(idx: _Index, fn: _Fn):
    """Yield (held_names, node) for every Call and With reached while
    at least one lock is held in ``fn`` (lexical; `*_locked` methods
    start holding their class's locks)."""
    held0: List[str] = []
    if fn.name.endswith("_locked") and fn.cls_name:
        held0 = sorted(set(
            fn.module.class_locks.get(fn.cls_name, {}).values()))

    def walk(node, held: List[str]):
        """Process ``node`` itself, then descend (nested defs/lambdas
        are separate functions with their own lock context)."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.With):
            names = []
            for item in node.items:
                canon = idx.resolve_lock(item.context_expr, fn)
                if canon:
                    names.append(canon)
            if names and held:
                yield held, node
            inner = held + names
            for stmt in node.body:
                yield from walk(stmt, inner)
            # with-item expressions themselves evaluate un-held
            return
        if isinstance(node, ast.Call) and held:
            yield held, node
        for child in ast.iter_child_nodes(node):
            yield from walk(child, held)

    for stmt in ast.iter_child_nodes(fn.node):
        yield from walk(stmt, held0)


def build_lock_graph(idx: _Index):
    """edges: (held, acquired) -> 'path:line' witness site."""
    edges: Dict[Tuple[str, str], str] = {}

    def note(h: str, m: str, rel: str, line: int):
        if h.startswith("?") or m.startswith("?") or h == m:
            return
        edges.setdefault((h, m), f"{rel}:{line}")

    for m in idx.mods:
        for fn in m.functions:
            for held, node in _held_regions(idx, fn):
                if isinstance(node, ast.With):
                    for item in node.items:
                        canon = idx.resolve_lock(item.context_expr, fn)
                        if canon:
                            for h in held:
                                note(h, canon, m.rel, node.lineno)
                elif isinstance(node, ast.Call):
                    for callee in idx.resolve_callees(node):
                        for acq in idx.direct_acquires(callee):
                            for h in held:
                                note(h, acq, m.rel, node.lineno)
    return edges


def check_cycles(edges) -> List[Finding]:
    adj: Dict[str, List[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
    out: List[Finding] = []
    seen_cycles: Set[Tuple[str, ...]] = set()

    def dfs(start: str):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in adj.get(node, ()):
                if nxt == start:
                    cyc = path + [start]
                    key = tuple(sorted(set(cyc)))
                    if key in seen_cycles:
                        continue
                    seen_cycles.add(key)
                    hops = " -> ".join(cyc)
                    sites = "; ".join(
                        f"{a}->{b} at {edges[(a, b)]}"
                        for a, b in zip(cyc, cyc[1:]))
                    site = edges[(cyc[0], cyc[1])]
                    rel, line = site.rsplit(":", 1)
                    out.append(Finding(
                        "con-graph", rel, int(line),
                        f"lock-order cycle (potential deadlock): "
                        f"{hops} [{sites}] — pick one global order "
                        f"and acquire in it, or drop the nested "
                        f"acquisition"))
                elif nxt not in path and len(path) < 16:
                    stack.append((nxt, path + [nxt]))

    for start in sorted(adj):
        dfs(start)
    return out


def check_blocking(idx: _Index) -> List[Finding]:
    blocking_fn_names = {
        fn.name for m in idx.mods for fn in m.functions
        if idx.direct_blocking(fn)
    }
    out: List[Finding] = []
    seen: Set[Tuple[str, int, str]] = set()

    def note(m: _Module, line: int, held, msg: str):
        key = (m.rel, line, msg[:60])
        if key in seen or m.escape_ok(line):
            return
        seen.add(key)
        out.append(Finding(
            "con-blocking", m.rel, line,
            f"{msg} while holding {'/'.join(sorted(set(held)))} — "
            f"move it off the lock or annotate "
            f"`# concheck: blocking-ok - <why>`"))

    for m in idx.mods:
        for fn in m.functions:
            for held, node in _held_regions(idx, fn):
                if not isinstance(node, ast.Call):
                    continue
                bad = _is_blocking(_call_name(node.func))
                if bad:
                    why = _BLOCKING_TAILS.get(
                        bad.rsplit(".", 1)[-1], "blocks the holder")
                    note(m, node.lineno, held,
                         f"blocking call {bad}() [{why}]")
                    continue
                for callee in idx.resolve_callees(node):
                    for bad, bline in idx.direct_blocking(callee):
                        note(m, node.lineno, held,
                             f"call into {callee.qual}() which makes "
                             f"blocking call {bad}() (line {bline})")
                    for n2 in _body_walk(callee.node):
                        if isinstance(n2, ast.Call):
                            t2 = (_dotted(n2.func) or
                                  "").rsplit(".", 1)[-1]
                            if t2 in blocking_fn_names and \
                                    not callee.module.escape_ok(
                                        n2.lineno):
                                note(m, node.lineno, held,
                                     f"call into {callee.qual}() "
                                     f"which calls {t2}() (line "
                                     f"{n2.lineno}), a function that "
                                     f"blocks directly")
    return out


# ----------------------------------------------------------------- entry
def run_concheck(paths: Optional[List[str]] = None,
                 lock_registry=None, thread_registry=None
                 ) -> List[Finding]:
    full = paths is None
    if paths is None:
        paths = _py_files("presto_tpu_torch")
    mods = collect(paths)
    idx = _Index(mods)
    findings = check_registry(mods, lock_registry=lock_registry,
                              thread_registry=thread_registry,
                              full_sweep=full)
    findings += check_cycles(build_lock_graph(idx))
    findings += check_blocking(idx)
    return findings


def main() -> int:
    import time

    t0 = time.monotonic()
    findings = run_concheck()
    for f in findings:
        print(f)
    mods = len(_py_files("presto_tpu_torch"))
    print(f"# concheck_torch: {len(findings)} finding(s) across {mods} "
          f"files in {time.monotonic() - t0:.1f}s", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
