"""CLI: `python -m tools.lint_torch [rule ...]` — run the engine-invariant
lint rules (default: all) over presto_tpu_torch/ and exit 1 on findings.
The port's pre-PR gate (tools/ci_static_torch.sh) runs the same code."""

import sys

from tools.lint_torch import ALL_RULES, run_lint


def main(argv) -> int:
    rules = tuple(argv) or ALL_RULES
    unknown = set(rules) - set(ALL_RULES)
    if unknown:
        print(f"unknown rules: {sorted(unknown)} "
              f"(known: {list(ALL_RULES)})", file=sys.stderr)
        return 2
    findings = run_lint(rules)
    for f in findings:
        print(f)
    print(f"# tools.lint_torch: {len(findings)} finding"
          f"{'s' if len(findings) != 1 else ''} across "
          f"{len(rules)} rule{'s' if len(rules) != 1 else ''}",
          file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
