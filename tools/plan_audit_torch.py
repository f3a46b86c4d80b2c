"""Static plan audit over presto_tpu_torch: sweep the TPC-H and TPC-DS
corpora through the port's pre-launch plan verifier (exec/plan_check.py,
strict mode), cut each plan into the stage DAG and verify that too, and
drive the adaptive re-planner over every DAG with seeded misestimates;
exit nonzero on any violation.

The port's counterpart of tools/plan_audit.py (whose bench-rung sweep has
no counterpart yet: the port has no benchmark). Planning is pure host
Python — nothing runs on a device — so the sweep is cheap enough for the
port's pre-PR gate (tools/ci_static_torch.sh). It imports neither jax nor
presto_tpu; the corpora are presto_tpu_torch/queries.py's.

Usage:
    python tools/plan_audit_torch.py                 # both corpora
    python tools/plan_audit_torch.py --corpus tpch   # one corpus only
    python tools/plan_audit_torch.py --sf 0.001      # corpus scale factor
"""

import argparse
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def make_runner(suite: str, sf: float):
    """A CPU LocalRunner over the named generator suite (planning reads
    row counts, never rows)."""
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector
    from presto_tpu_torch.connectors.tpch import TpchConnector
    from presto_tpu_torch.runner import LocalRunner

    cls = TpchConnector if suite == "tpch" else TpcdsConnector
    runner = LocalRunner({suite: cls(sf, device="cpu")},
                         default_catalog=suite, device="cpu")
    runner.apply_session()
    return runner


def queries(suite: str):
    from presto_tpu_torch import queries as PQ

    return PQ.TPCH_SQL if suite == "tpch" else PQ.TPCDS_SQL


def _seeded_misestimate_sweep(runner, label: str, dag,
                              failures: list) -> int:
    """Drive the runtime re-planner over this DAG with SYNTHETIC
    >=10x-off observations (alternating over- and under-estimates, an
    80/20 skewed partition histogram, wire bytes 8x under raw) at every
    stage boundary, and require the LIVE DAG to pass STRICT verification
    after each replan — whether the mutation applied or rolled back.
    Returns the number of applied re-plans."""
    from presto_tpu_torch.adaptive import Replanner, StageStats
    from presto_tpu_torch.exec import plan_check as PC

    ex = runner.executor
    rp = Replanner(ex, dag, broadcast_rows=1 << 21,
                   max_replans=16, strict=True)
    dispatched: set = set()
    applied = 0
    for frag in dag.fragments:
        dispatched.add(frag.fid)
        est = max(int(ex.estimate_rows(frag.root)), 2)
        obs = est * 10 if frag.fid % 2 else max(est // 10, 1)
        hot = max(int(obs * 0.8), 1)
        rp.observe(StageStats(
            fid=frag.fid, rows=obs, bytes=obs * 16,
            part_rows=(hot, max(obs - hot, 0)),
            part_bytes=(hot * 16, max(obs - hot, 0) * 16),
            task_rows=(obs // 2, obs - obs // 2),
            wire_bytes=obs * 2,
        ))
        out = rp.replan(set(dispatched))
        if out is not None and not out.rejected:
            applied += 1
        try:
            PC.verify_dag(ex, dag, strict=True)
        except PC.PlanCheckError as e:
            failures.append((label, [
                f"[adaptive seeded-misestimate, after stage "
                f"{frag.fid}] {v}" for v in e.violations]))
            print(f"# {label}: ADAPTIVE SWEEP FAILED after stage "
                  f"{frag.fid}", file=sys.stderr)
            return applied
    return applied


def _pinned_cases(failures: list) -> None:
    """The re-planner's broadcast test on fixed freights: a build whose
    raw spool bytes blow the broadcast share but whose measured wire
    bytes fit must flip (and raw-only stats must not), and the same
    build observed on the ICI plane must not flip — broadcast would move
    its freight back onto the wire — unless it is truly tiny."""
    from presto_tpu_torch.adaptive import Replanner, StageStats

    rp = Replanner(None, None, broadcast_bytes=1 << 20)
    big = dict(fid=0, rows=1 << 16, part_rows=(1 << 16,),
               part_bytes=(1 << 24,), task_rows=(1 << 16,))
    small = dict(fid=0, rows=1 << 14, part_rows=(1 << 14,),
                 part_bytes=(1 << 19,), task_rows=(1 << 14,))
    cases = {
        "wire-misestimate case": [
            (not rp._fits_broadcast(StageStats(bytes=1 << 24, **big)),
             "raw 16MiB build with no wire stats must NOT fit a 1MiB "
             "broadcast share"),
            (rp._fits_broadcast(StageStats(bytes=1 << 24,
                                           wire_bytes=1 << 18, **big)),
             "16MiB build measuring 256KiB on the wire must fit a 1MiB "
             "broadcast share"),
            (not rp._fits_broadcast(StageStats(bytes=1 << 24,
                                               wire_bytes=1 << 22, **big)),
             "build measuring 4MiB on the wire must NOT fit a 1MiB "
             "broadcast share"),
        ],
        "ici-flip case": [
            (rp._fits_broadcast(StageStats(bytes=1 << 19,
                                           wire_bytes=1 << 19, **small)),
             "512KiB spooled build must fit a 1MiB broadcast share"),
            (not rp._fits_broadcast(StageStats(bytes=1 << 19,
                                               ici_bytes=1 << 19, **small)),
             "the SAME 512KiB build observed on the ICI plane must NOT "
             "flip"),
            (rp._fits_broadcast(StageStats(bytes=1 << 13,
                                           ici_bytes=1 << 13, **small)),
             "an 8KiB ICI-plane build must still flip"),
        ],
    }
    for label, checks in cases.items():
        bad = [msg for ok, msg in checks if not ok]
        if bad:
            failures.append((label, bad))
            for msg in bad:
                print(f"# {label}: {msg}", file=sys.stderr)
        else:
            print(f"# {label}: ok", file=sys.stderr)


def _audit_one(runner, label: str, sql: str, failures: list,
               dag_stats: list, replans: list) -> None:
    from presto_tpu_torch.dist.fragmenter import fragment_dag
    from presto_tpu_torch.exec import plan_check as PC

    try:
        plan = runner.plan(sql)
    except Exception as e:  # noqa: BLE001 - a plan failure is a verdict
        failures.append((label, [f"planning failed: {e!r}"]))
        print(f"# {label}: PLANNING FAILED {e!r}", file=sys.stderr)
        return
    try:
        PC.verify(runner.executor, plan, strict=True)
    except PC.PlanCheckError as e:
        failures.append((label, e.violations))
        print(f"# {label}: {len(e.violations)} violation(s)",
              file=sys.stderr)
        for v in e.violations:
            print(f"#   - {v}", file=sys.stderr)
        return
    # fragment the SAME plan through the stage-DAG cutter and verify the
    # multi-stage DAG (edge types, repartition keys, co-partitioning)
    try:
        dag = fragment_dag(runner.executor, plan, runner.catalogs)
    except Exception as e:  # noqa: BLE001 - a cut failure is a verdict
        failures.append((label, [f"fragment_dag failed: {e!r}"]))
        print(f"# {label}: FRAGMENTATION FAILED {e!r}",
              file=sys.stderr)
        return
    if dag is None:
        print(f"# {label}: ok (not dag-distributable)", file=sys.stderr)
        return
    try:
        PC.verify_dag(runner.executor, dag)
    except PC.PlanCheckError as e:
        failures.append((label, [f"[stage-dag] {v}"
                                 for v in e.violations]))
        print(f"# {label}: {len(e.violations)} DAG violation(s)",
              file=sys.stderr)
        for v in e.violations:
            print(f"#   - {v}", file=sys.stderr)
        return
    dag_stats.append(len(dag.fragments))
    # the sweep mutates the (already verified) DAG; nothing re-reads it
    applied = _seeded_misestimate_sweep(runner, label, dag, failures)
    replans.append(applied)
    print(f"# {label}: ok ({len(dag.fragments)}-stage dag, "
          f"{applied} seeded re-plans)", file=sys.stderr)


def run_audit(corpora=("tpch", "tpcds"), sf: float = 0.001):
    """(plans audited, failures, stage-DAG sizes, applied re-plans)."""
    failures: list = []
    dag_stats: list = []
    replans: list = []
    n = 0
    _pinned_cases(failures)
    for suite in corpora:
        runner = make_runner(suite, sf)
        for qid, sql in sorted(queries(suite).items()):
            _audit_one(runner, f"{suite} q{qid}", sql, failures,
                       dag_stats, replans)
            n += 1
    return n, failures, dag_stats, replans


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", choices=("tpch", "tpcds", "all"),
                    default="all")
    ap.add_argument("--sf", type=float, default=0.001,
                    help="corpus scale factor (planning-only)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    corpora = (("tpch", "tpcds") if args.corpus == "all"
               else (args.corpus,))
    t0 = time.time()
    n, failures, dag_stats, replans = run_audit(corpora, args.sf)
    wall = time.time() - t0
    multi = sum(1 for s in dag_stats if s >= 2)
    print(f"# plan_audit_torch: {n} plans, {len(failures)} with "
          f"violations, {len(dag_stats)} dag-distributable ({multi} "
          f"multi-stage), {sum(replans)} seeded adaptive re-plans "
          f"applied, {wall:.1f}s", file=sys.stderr)
    if failures:
        print("PLAN AUDIT FAILED:")
        for label, violations in failures:
            for v in violations:
                print(f"  {label}: {v}")
        return 1
    print(f"plan audit clean: {n} plans verified ({len(dag_stats)} stage "
          f"DAGs, {sum(replans)} seeded adaptive re-plans) in {wall:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
