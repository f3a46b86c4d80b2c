"""presto_tpu_torch stands alone: importing every one of its modules,
chip_smoke.py and the port's tools (the chaos harness, the linter, the
concurrency pass, the plan audit) in a fresh interpreter loads neither
jax nor any presto_tpu module."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_TOOLS = ("tools.chaos_torch", "tools.lint_torch",
              "tools.lint_torch.__main__", "tools.concheck_torch",
              "tools.plan_audit_torch")


def _port_modules():
    pkg = ROOT / "presto_tpu_torch"
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_neither_jax_nor_presto_tpu():
    mods = list(_port_modules()) + ["chip_smoke"] + list(PORT_TOOLS)
    assert "presto_tpu_torch.exec.executor" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'presto_tpu' "
        "or m.startswith('presto_tpu.'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
