#!/usr/bin/env bash
# The port's pre-PR static gate, over presto_tpu_torch/: the
# engine-invariant linter (tools/lint_torch), the concurrency soundness
# pass (tools/concheck_torch.py: lock registry, acquisition graph,
# blocking under a lock), the host<->device transfer audit (the
# registry sweep of tests/test_torch_xfer.py), the plan audit
# (tools/plan_audit_torch.py: the TPC-H and TPC-DS corpora, their stage
# DAGs and the seeded re-planner sweep, strict mode), and the pure-serde
# subset of tests/test_torch_wire.py (page and plan codecs against the
# reference's bytes; the cases that run queries stay in the test
# suite). Every leg is host Python on the CPU: nothing needs a card.
# The two pytest legs compare with presto_tpu, so they need jax here.
#
# Usage: tools/ci_static_torch.sh   (exit nonzero on any finding)
set -euo pipefail
cd "$(dirname "$0")/.."
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"

t0=$(date +%s)
echo "# ci_static_torch: engine-invariant lint (python -m tools.lint_torch)" >&2
python -m tools.lint_torch

echo "# ci_static_torch: concurrency soundness (tools/concheck_torch.py)" >&2
python tools/concheck_torch.py

echo "# ci_static_torch: transfer audit (tests/test_torch_xfer.py sweep)" >&2
python -m pytest tests/test_torch_xfer.py -q -p no:cacheprovider \
    -k "registry_rows or sweep_"

echo "# ci_static_torch: plan audit (tools/plan_audit_torch.py)" >&2
python tools/plan_audit_torch.py

echo "# ci_static_torch: wire-serde subset (tests/test_torch_wire.py)" >&2
python -m pytest tests/test_torch_wire.py -q -p no:cacheprovider \
    -k "byte_identical or corrupt_blob or plan_serde"

echo "# ci_static_torch: clean in $(( $(date +%s) - t0 ))s" >&2
