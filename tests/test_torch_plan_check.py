"""The pre-launch plan verifier (presto_tpu_torch/exec/plan_check.py):
the port against presto_tpu.

  - ``plan_check=auto`` is on under pytest, and the session property
    plumbs through to the executor;
  - a broken plan is rejected by execute() before anything runs;
  - each of the reference's mutation cases (tests/test_static_analysis.py),
    built in both engines from the same description, raises
    PlanCheckError with the SAME violation list as the reference's —
    all but the device fault-line case, which has no counterpart (the
    port has no fault line);
  - the task-payload checks hold the reference's cases;
  - the TPC-H and TPC-DS corpora and the stage DAGs verify clean, and
    verify_dag catches a bad repartition key and an unknown edge.
"""

import dataclasses

import pytest
import torch

from presto_tpu_torch import queries as PQ
from presto_tpu_torch import types as T
from presto_tpu_torch.connectors.tpcds import TpcdsConnector
from presto_tpu_torch.connectors.tpch import TpchConnector
from presto_tpu_torch.dist.fragmenter import fragment_dag
from presto_tpu_torch.exec import membudget as MB
from presto_tpu_torch.exec import plan as P
from presto_tpu_torch.exec import plan_check as PC
from presto_tpu_torch.expr import ir as E
from presto_tpu_torch.runner import LocalRunner

SF = 0.001


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per worker process: the suite runs several
    files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    from presto_tpu.connectors.tpch import TpchConnector as RefConnector
    from presto_tpu.runner import LocalRunner as RefRunner

    port = LocalRunner({"tpch": TpchConnector(SF, device="cpu")},
                       device="cpu")
    ref = RefRunner({"tpch": RefConnector(scale=SF)},
                    default_catalog="tpch")
    port.apply_session()
    ref.apply_session()
    return port, ref


def _ref_mods():
    from presto_tpu import types as RT
    from presto_tpu.exec import plan as RP
    from presto_tpu.exec import plan_check as RPC
    from presto_tpu.expr import ir as RE

    return RP, RE, RT, RPC


# ------------------------------------------------------------- wiring
def test_plan_check_auto_on_under_pytest(tiny):
    ex = tiny[0].executor
    assert ex.plan_check == "auto"
    assert ex._plan_check_on()  # PYTEST_CURRENT_TEST is set
    ex.plan_check = "false"
    try:
        assert not ex._plan_check_on()
    finally:
        ex.plan_check = "auto"


def test_plan_check_env_opt_out_and_opt_in(tiny, monkeypatch):
    ex = tiny[0].executor
    monkeypatch.setenv("PRESTO_TPU_PLAN_CHECK", "0")
    assert not ex._plan_check_on()
    monkeypatch.setenv("PRESTO_TPU_PLAN_CHECK", "1")
    monkeypatch.delenv("PYTEST_CURRENT_TEST")
    assert ex._plan_check_on()
    monkeypatch.setenv("PRESTO_TPU_PLAN_CHECK", "maybe")
    assert not ex._plan_check_on()  # a typo never forces it on


def test_plan_check_session_prop_plumbs(tiny):
    port = tiny[0]
    port.session.set("plan_check", "false")
    try:
        port.apply_session()
        assert port.executor.plan_check == "false"
    finally:
        port.session.unset("plan_check")
        port.apply_session()
    assert port.executor.plan_check == "auto"


def test_execute_rejects_broken_plan_before_it_runs(tiny):
    scan = P.TableScan("tpch", "nation", ("n_nationkey", "n_name"))
    bad = P.Output(source=P.Filter(source=scan,
                                   predicate=E.input_ref(9, T.BOOLEAN)),
                   names=("a", "b"))
    calls = []
    ex = tiny[0].executor
    orig = ex._pages_impl
    ex._pages_impl = lambda node: calls.append(node) or orig(node)
    try:
        with pytest.raises(PC.PlanCheckError, match="channel #9"):
            ex.execute(bad)
    finally:
        del ex._pages_impl
    assert calls == []


# ------------------------------------------------------ mutation suite
def _values2(P_, T_):
    return P_.Values(types=(T_.BIGINT, T_.DOUBLE), rows=((1, 2.0),))


def _m_schema(P_, E_, T_):
    return P_.Filter(source=_values2(P_, T_),
                     predicate=E_.input_ref(5, T_.BOOLEAN))


def _m_project(P_, E_, T_):
    return P_.Project(source=_values2(P_, T_),
                      exprs=(E_.input_ref(3, T_.BIGINT),))


def _m_join_arity(P_, E_, T_):
    v = _values2(P_, T_)
    return P_.HashJoin(left=v, right=v, left_keys=(0, 1), right_keys=(0,))


def _m_join_types(P_, E_, T_):
    strings = P_.Values(types=(T_.VARCHAR,), rows=(("x",),))
    return P_.HashJoin(left=_values2(P_, T_), right=strings,
                       left_keys=(0,), right_keys=(0,))


def _m_exchange_partitioning(P_, E_, T_):
    v = _values2(P_, T_)
    left = P_.Exchange(source=v, kind="repartition", keys=(0,))
    right = P_.Exchange(source=v, kind="repartition", keys=(1,))
    return P_.HashJoin(left=left, right=right, left_keys=(0,),
                       right_keys=(0,))


def _m_broadcast_keys(P_, E_, T_):
    return P_.Exchange(source=_values2(P_, T_), kind="broadcast",
                       keys=(0,))


def _m_jit_key_dict(P_, E_, T_):
    return P_.Values(types=(T_.BIGINT,), rows=(({"a": 1},),))


def _m_constraint_dict(P_, E_, T_):
    scan = P_.TableScan("tpch", "nation", ("n_nationkey",))
    return dataclasses.replace(scan, constraint={"n_nationkey": 1})


def _m_remote_schema(P_, E_, T_):
    agg = P_.Aggregation(source=_values2(P_, T_), group_channels=(0,),
                         aggregates=(P_.AggSpec("sum", channel=1),),
                         step="partial")
    return P_.RemoteSource(types=(T_.BIGINT,), key="k", origin=agg)


def _m_output_names(P_, E_, T_):
    return P_.Output(source=_values2(P_, T_), names=("only_one",))


def _m_agg_step_capacity(P_, E_, T_):
    return P_.Aggregation(source=_values2(P_, T_), group_channels=(0,),
                          aggregates=(P_.AggSpec("sum", channel=1),),
                          capacity=-4, step="both")


def _m_unknown_column(P_, E_, T_):
    return P_.TableScan("tpch", "nation", ("n_nationkey", "bogus"))


def _m_all_at_once(P_, E_, T_):
    v = _values2(P_, T_)
    return P_.Output(source=P_.HashJoin(left=v, right=v, left_keys=(0, 1),
                                        right_keys=(5,)),
                     names=("a",))


MUTATIONS = {
    "schema_mismatched_edge": (_m_schema, "channel #5"),
    "project_stale_channel": (_m_project, "stale channel mapping"),
    "join_key_arity_mismatch": (_m_join_arity, "arity mismatch"),
    "join_key_type_mismatch": (_m_join_types, "never match"),
    "mismatched_exchange_partitioning": (_m_exchange_partitioning,
                                         "partitioning disagrees"),
    "broadcast_exchange_with_keys": (
        _m_broadcast_keys, "only repartition partitions by key"),
    "non_canonical_jit_key_dict": (_m_jit_key_dict,
                                   "non-canonical jit-key material"),
    "constraint_dict": (_m_constraint_dict, "constraint"),
    "remote_source_schema_mismatch": (
        _m_remote_schema, "schema-inconsistent fragment edge"),
    "output_names_arity": (_m_output_names,
                           "1 output names for 2 channels"),
    "bad_agg_step_and_capacity": (_m_agg_step_capacity,
                                  "negative group capacity"),
    "unknown_scan_column": (_m_unknown_column, "'bogus'"),
    "reports_all_violations_at_once": (_m_all_at_once, "arity"),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_mutation_matches_the_reference(tiny, case):
    build, needle = MUTATIONS[case]
    RP, RE, RT, RPC = _ref_mods()
    with pytest.raises(PC.PlanCheckError) as got:
        PC.verify(tiny[0].executor, build(P, E, T))
    with pytest.raises(RPC.PlanCheckError) as want:
        RPC.verify(tiny[1].executor, build(RP, RE, RT))
    assert got.value.violations == want.value.violations
    assert needle in str(got.value)


def test_mutation_off_ladder_capacity():
    report = MB.AuditReport(
        budget=1 << 34,
        buffers=[MB.BufferPlan("join build inner (1/1 pass)", rows=3000,
                               row_bytes=16)])
    violations = []
    PC.check_buffers(report, violations)
    assert len(violations) == 1
    assert "OFF the shapes.py bucket ladder" in violations[0]
    assert "3000" in violations[0]


def test_mutation_over_budget_buffer():
    report = MB.AuditReport(
        budget=1 << 20,
        buffers=[MB.BufferPlan("agg state", rows=1 << 20, row_bytes=64)])
    violations = []
    PC.check_buffers(report, violations)
    assert violations and "past the device-memory budget" in violations[0]
    # a blocking merge is exempt unless strict
    report = MB.AuditReport(
        budget=1 << 20,
        buffers=[MB.BufferPlan("sort merge", rows=1 << 20, row_bytes=64)])
    lax, strict = [], []
    PC.check_buffers(report, lax)
    PC.check_buffers(report, strict, strict=True)
    assert lax == [] and len(strict) == 1


def test_mutation_non_canonical_jit_key_object():
    class Opaque:
        pass

    violations = []
    PC.check_canonical_key_material(
        P.Values(types=(T.BIGINT,), rows=((Opaque(),),)), violations)
    assert violations and "id() leaks" in violations[0]


def test_canonical_rekey_is_byte_identical(tiny):
    plan = tiny[0].plan("select n_name, count(*) from nation group by 1")
    violations = []
    PC.check_canonical_key_material(plan, violations)
    assert violations == []


# ------------------------------------------------------- task payloads
_MISSING = object()


def _payload(**over):
    base = {"taskId": "q.0", "fragment": "{}", "splitTable": "lineitem",
            "splitIndex": 0, "splitCount": 4, "session": {}}
    base.update(over)
    return {k: v for k, v in base.items() if v is not _MISSING}


PAYLOADS = {
    "missing_split_index": (_payload(splitIndex=_MISSING), "splitIndex"),
    "missing_split_count": (_payload(splitCount=_MISSING), "splitCount"),
    "split_out_of_range": (_payload(splitIndex=4), "outside"),
    "hash_without_columns": (_payload(splitMode="hash"),
                             "partitionColumns"),
    "no_split_table": (_payload(splitTable=None), "splitTable"),
    "no_producer_placements": (
        _payload(splitTable=None, sources={"stage0": {
            "partition": 0, "tasks": []}}), "producer placements"),
    "negative_partition": (
        _payload(sources={"stage0": {"partition": -1, "tasks": [
            {"uri": "http://h:1", "taskId": "t"}]}}), "negative spool"),
    "repartition_without_keys": (_payload(outputPartitions=4),
                                 "outputKeys"),
}


def test_payload_ok():
    PC.check_task_payload(_payload())
    PC.check_task_payload(_payload(
        splitMode="hash", partitionColumns={"tpch.lineitem": "l_orderkey"}))
    PC.check_task_payload(_payload(splitTable=None, outputPartitions=1,
                                   sources={"stage0": {
                                       "partition": 0, "tasks": [{
                                           "uri": "http://h:1",
                                           "taskId": "q.f0.t0"}]}}))


@pytest.mark.parametrize("case", sorted(PAYLOADS))
def test_payload_mutation_matches_the_reference(case):
    payload, needle = PAYLOADS[case]
    RPC = _ref_mods()[3]
    with pytest.raises(PC.PlanCheckError, match=needle) as got:
        PC.check_task_payload(payload)
    with pytest.raises(RPC.PlanCheckError) as want:
        RPC.check_task_payload(payload)
    assert got.value.violations == want.value.violations


# -------------------------------------------------------- clean sweeps
def test_tpch_corpus_verifies_clean(tiny):
    for q in sorted(PQ.TPCH_SQL):
        PC.verify(tiny[0].executor, tiny[0].plan(PQ.TPCH_SQL[q]))


def test_tpcds_corpus_verifies_clean():
    r = LocalRunner({"tpcds": TpcdsConnector(SF, device="cpu")},
                    default_catalog="tpcds", device="cpu")
    for q in sorted(PQ.TPCDS_SQL):
        PC.verify(r.executor, r.plan(PQ.TPCDS_SQL[q]))


def _dags(runner):
    for q in (3, 5, 9, 18):
        plan = runner.plan(PQ.TPCH_SQL[q])
        dag = fragment_dag(runner.executor, plan, runner.catalogs,
                           broadcast_rows=0, gather_capacity=64)
        if dag is not None:
            yield q, dag


def test_distributed_plans_verify_clean(tiny):
    n = 0
    for _q, dag in _dags(tiny[0]):
        PC.verify_dag(tiny[0].executor, dag)
        n += 1
    assert n >= 3


def test_verify_dag_catches_bad_repartition_keys_and_edges(tiny):
    _q, dag = next(_dags(tiny[0]))
    idx = next(i for i, f in enumerate(dag.fragments)
               if f.output_kind == "repartition")
    bad = dataclasses.replace(
        dag, fragments=[dataclasses.replace(f, output_keys=(99,))
                        if i == idx else f
                        for i, f in enumerate(dag.fragments)])
    with pytest.raises(PC.PlanCheckError, match="out of range"):
        PC.verify_dag(tiny[0].executor, bad)
    lost = dataclasses.replace(dag, fragments=list(dag.fragments[1:]))
    with pytest.raises(PC.PlanCheckError, match="names no fragment"):
        PC.verify_dag(tiny[0].executor, lost)
