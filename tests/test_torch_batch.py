"""The port's front-door batching against the JAX package's.

``merge_dags`` / ``coalesce_submissions`` / ``batch_signature`` are held to
the reference field by field; ``merge_device_lowerings`` runs 2-3 members
through one super-table, and every member's outputs must be bitwise equal
to its lowering walked alone (the reference's contract,
``tests/test_admission.py``'s device batching test), on the plain walker
and on the host pool. Against the reference's merged walk (Pallas,
interpret mode) float sums agree to 1e-5 of the output's largest magnitude
(PyTorch and XLA sum a tile in different orders), top items exactly.
The CUDA walker's refusals (mixed programs, more than 8 members) are pure
Python and are checked here; ``tests/test_torch_cuda.py`` repeats them on
the card, where they must launch nothing.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import admission as jadm
from repro.core.dag import PipelineDAG as JDAG, Stage as JStage, StageDep as JDep
from repro.core.submit import Submission as JSubmission
from repro.vee import apps as japps
from repro_torch.core import (BatchPolicy, PipelineDAG, PipelineExecutor,
                              SchedulerConfig, Stage, StageDep, Submission,
                              batch_signature, coalesce_submissions, merge_dags)
from repro_torch.core.admission import BATCH_SEP
from repro_torch.kernels import dag_walk as twalk
from repro_torch.vee import apps as tapps
from repro_torch.vee import ml_apps as tml

FLOAT_RTOL = 1e-5


def _op_a(offset):
    return lambda i, s, z: np.arange(s, s + z, dtype=np.int64) + offset


def _op_b(i, s, z):
    return int(i["a"][s:s + z].sum())


def _two_stage(pkg, offset=0, n=32, deadline=None, **kw):
    """The reference test's two-stage DAG, built with ``pkg``'s data model."""
    DAG, St, Dep, Sub = pkg
    a = St("a", n, _op_a(offset), combine="concat")
    b = St("b", n, _op_b, combine="sum", deps=(Dep("a", "elementwise"),))
    costs = {"a": np.full(n, 1e-5), "b": np.full(n, 1e-5)}
    return Sub(dag=DAG([a, b]), deadline_s=deadline, stage_costs=costs, **kw)


PORT = (PipelineDAG, Stage, StageDep, Submission)
REF = (JDAG, JStage, JDep, JSubmission)


def _fields(dag):
    return [(n, s.n_rows, s.combine, [(d.producer, d.kind) for d in s.deps],
             s.config, s.cost_of_range)
            for n, s in dag.stages.items()]


def test_merge_dags_field_by_field():
    port = [_two_stage(PORT, offset=100 * j).dag for j in range(3)]
    ref = [_two_stage(REF, offset=100 * j).dag for j in range(3)]
    got, want = merge_dags(port), jadm.merge_dags(ref)
    assert got.stage_names == want.stage_names
    assert _fields(got) == _fields(want)
    for j in range(3):
        name = f"a{BATCH_SEP}{j}"
        assert np.array_equal(got.stages[name].op({}, 2, 5),
                              want.stages[name].op({}, 2, 5))
        ins = {f"a{BATCH_SEP}{j}": np.arange(32)}
        assert got.stages[f"b{BATCH_SEP}{j}"].op(ins, 0, 8) == \
            want.stages[f"b{BATCH_SEP}{j}"].op(ins, 0, 8)
    bad = PipelineDAG([Stage(f"x{BATCH_SEP}1", 4, _op_a(0))])
    with pytest.raises(ValueError, match="reserved"):
        merge_dags([bad])


def test_batch_signature_matches_reference():
    for kw in ({}, {"n": 16}, {"tenant": "t2"}):
        assert batch_signature(_two_stage(PORT, **kw)) == \
            jadm.batch_signature(_two_stage(REF, **kw))
    assert batch_signature(_two_stage(PORT)) != batch_signature(_two_stage(PORT, n=16))


def _subs(pkg):
    return [
        _two_stage(pkg, name="a", priority=1, arrival_s=0.0, deadline=1.0),
        _two_stage(pkg, name="b", priority=3, arrival_s=0.4, deadline=None,
                   weight=2.5),
        _two_stage(pkg, name="c", arrival_s=0.5, deadline=2.0,
                   per_stage={"a": SchedulerConfig(technique="GSS")}),
    ]


def test_coalesce_submissions_field_by_field():
    got = coalesce_submissions(_subs(PORT), name="batch")
    want = jadm.coalesce_submissions(_subs(REF), name="batch")
    for f in ("name", "tenant", "priority", "weight", "arrival_s", "deadline_s"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.deadline_s == pytest.approx(0.5)
    assert sorted(got.stage_costs) == sorted(want.stage_costs)
    for k in got.stage_costs:
        assert np.array_equal(got.stage_costs[k], want.stage_costs[k])
    assert list(got.per_stage) == list(want.per_stage) == [f"a{BATCH_SEP}2"]
    assert got.dag.stage_names == want.dag.stage_names
    assert coalesce_submissions(_subs(PORT)).name == \
        jadm.coalesce_submissions(_subs(REF)).name
    lone = _two_stage(PORT, name="solo")
    assert coalesce_submissions([lone]) is lone
    for subs, match in (([], "empty"),
                        ([_two_stage(PORT, name="x"),
                          _two_stage(PORT, name="y", tenant="t2")], "tenants"),
                        ([_two_stage(PORT), _two_stage(PORT, placement="p")],
                         "placement")):
        with pytest.raises(ValueError, match=match):
            coalesce_submissions(subs)


def test_batch_policy():
    pol = BatchPolicy()
    ref = jadm.BatchPolicy()
    assert (pol.window_s, pol.max_batch) == (ref.window_s, ref.max_batch)
    assert pol.max_batch == twalk.MAX_MEMBERS
    assert pol.batchable(_two_stage(PORT))
    assert not pol.batchable(_two_stage(PORT, online=object()))
    assert not BatchPolicy(max_batch=1).batchable(_two_stage(PORT))


def test_host_batched_execution_bitwise():
    subs = [_two_stage(PORT, offset=100 * j, name=f"q{j}") for j in range(4)]
    merged = coalesce_submissions(subs)
    out = PipelineExecutor(merged.dag, SchedulerConfig(n_workers=2)).run().values
    for j, s in enumerate(subs):
        ref = PipelineExecutor(s.dag, SchedulerConfig(n_workers=2)).run()
        assert np.array_equal(out[f"a{BATCH_SEP}{j}"], ref.values["a"])
        assert out[f"b{BATCH_SEP}{j}"] == ref.values["b"]


# ---------------------------------------------------------------------------
# merged device lowerings
# ---------------------------------------------------------------------------

def _linreg(seed):
    return tapps.linreg_device_lowering(256, 9, tile=64, seed=seed, device="cpu")


def _rec(seed):
    return tapps.recommendation_device_lowering(128, 16, tile=32, seed=seed,
                                                device="cpu")


@pytest.mark.parametrize("build,seeds", [(_linreg, (1, 2)), (_linreg, (1, 2, 3)),
                                         (_rec, (0, 5)), (_rec, (0, 5, 9))])
@pytest.mark.parametrize("tech", ["SS", "GSS"])
def test_merged_walk_bitwise_equal_to_single_walks(build, seeds, tech):
    lows = [build(s) for s in seeds]
    singles = [tapps.run_device_dag(low, tech)[0] for low in lows]
    merged = tapps.merge_device_lowerings(lows)
    assert [s.member for s in merged.stages] == \
        [int(n.rpartition(BATCH_SEP)[2]) for n in merged.dag.stage_names]
    vals, ddt = tapps.run_device_dag(merged, tech)
    per_unit = sum(s.n_rows // low.tile for low in lows for s in low.stages)
    assert ddt.tables.shape == (1, per_unit, 3)          # ONE super-table
    members = tapps.split_device_values(vals, len(lows))
    for j in range(len(lows)):
        assert set(members[j]) == set(singles[j])
        for k in singles[j]:
            assert torch.equal(members[j][k], singles[j][k]), (j, k)
    fin = merged.finalize(vals)
    for j, low in enumerate(lows):
        want = low.finalize(singles[j]) if low.finalize else singles[j]
        if isinstance(want, dict):
            assert all(torch.equal(fin[j][k], want[k]) for k in want)
        else:
            assert np.array_equal(fin[j], want)
    # the merged host DAG on the pool gives the members' host values (one
    # worker: with more, a sum stage folds its chunks in finishing order)
    host = PipelineExecutor(merged.dag, SchedulerConfig(technique=tech,
                                                        n_workers=1)).run()
    for j, low in enumerate(lows):
        alone = PipelineExecutor(low.dag, SchedulerConfig(technique=tech,
                                                          n_workers=1)).run()
        for k in alone.values:
            assert torch.equal(torch.as_tensor(host.values[f"{k}{BATCH_SEP}{j}"]),
                               torch.as_tensor(alone.values[k]))


def test_merged_walk_near_reference_merged_walk():
    lows = [_linreg(s) for s in (1, 2)]
    jlows = [japps.linreg_device_lowering(256, 9, tile=64, seed=s) for s in (1, 2)]
    vals, _ = tapps.run_device_dag(tapps.merge_device_lowerings(lows), "SS")
    jvals, _ = japps.run_device_dag(japps.merge_device_lowerings(jlows), "SS")
    assert sorted(vals) == sorted(jvals)
    for k in vals:
        want = np.asarray(jvals[k])
        np.testing.assert_allclose(vals[k].numpy(), want, rtol=FLOAT_RTOL,
                                   atol=FLOAT_RTOL * np.abs(want).max(), err_msg=k)
    rlows = [_rec(s) for s in (0, 5)]
    jrlows = [japps.recommendation_device_lowering(128, 16, tile=32, seed=s)
              for s in (0, 5)]
    vals, _ = tapps.run_device_dag(tapps.merge_device_lowerings(rlows), "GSS")
    jvals, _ = japps.run_device_dag(japps.merge_device_lowerings(jrlows), "GSS")
    for j in range(2):
        assert np.array_equal(vals[f"scores{BATCH_SEP}{j}"].numpy(),
                              np.asarray(jvals[f"scores{BATCH_SEP}{j}"]))


def test_merged_moe_walk_bitwise():
    lows = [tml.moe_device_lowering(tml.moe_dispatch_lowering(n_tokens=24, seed=s,
                                                              device="cpu"))
            for s in (0, 1)]
    singles = [tapps.run_device_dag(low, "GSS")[0] for low in lows]
    vals, _ = tapps.run_device_dag(tapps.merge_device_lowerings(lows), "GSS")
    for j, member in enumerate(tapps.split_device_values(vals, 2)):
        assert torch.equal(member["experts"], singles[j]["experts"])


def test_merged_seed_is_renamed_per_member():
    lows = [_linreg(s) for s in (1, 2)]
    ref = [tapps.run_device_dag(low, "SS")[0] for low in lows]
    seeded = []
    for j, low in enumerate(lows):
        st = [dataclasses.replace(low.stages[0], seed="mom0"), low.stages[1]]
        vals = dict(low.values, mom0=torch.full((2, 8), float(j + 1)))
        seeded.append(dataclasses.replace(low, stages=st, values=vals))
    merged = tapps.merge_device_lowerings(seeded)
    assert [s.seed for s in merged.stages if s.seed] == [f"mom0{BATCH_SEP}0",
                                                         f"mom0{BATCH_SEP}1"]
    assert {f"mom0{BATCH_SEP}0", f"mom0{BATCH_SEP}1"} <= set(merged.values)
    singles = [tapps.run_device_dag(low, "SS")[0] for low in seeded]
    vals, _ = tapps.run_device_dag(merged, "SS")
    for j, member in enumerate(tapps.split_device_values(vals, 2)):
        for k in singles[j]:
            assert torch.equal(member[k], singles[j][k]), (j, k)
        assert not torch.equal(member["moments"], ref[j]["moments"])


def test_merge_device_lowerings_refuses_bad_batches():
    with pytest.raises(ValueError, match="empty"):
        tapps.merge_device_lowerings([])
    with pytest.raises(ValueError, match="mixed tiles"):
        tapps.merge_device_lowerings([_linreg(1), _rec(0)])


# ---------------------------------------------------------------------------
# the CUDA walker's batch rules (pure Python: no card needed)
# ---------------------------------------------------------------------------

def test_cuda_program_accepts_whole_member_copies():
    merged = tapps.merge_device_lowerings([_linreg(s) for s in range(1, 9)])
    prog, body_map = twalk.cuda_program(merged.stages)
    assert prog == "linreg" and sorted(body_map) == [0] * 8 + [1] * 8
    rec = tapps.merge_device_lowerings([_rec(s) for s in (0, 1)])
    assert twalk.cuda_program(rec.stages)[0] == "recommendation"


def test_cuda_program_refuses_more_than_eight_members():
    merged = tapps.merge_device_lowerings([_linreg(s) for s in range(1, 10)])
    with pytest.raises(ValueError, match="batch of 9 members.*at most 8"):
        twalk.cuda_program(merged.stages)


def test_cuda_program_refuses_a_mixed_batch():
    lin = tapps.merge_device_lowerings([_linreg(1)]).stages
    rec = [dataclasses.replace(s, name=f"{s.name}#1", member=1)
           for s in _rec(0).stages]
    with pytest.raises(ValueError, match="stage 'item_norms#1' of member 1 runs the "
                                         "'recommendation' program"):
        twalk.cuda_program(lin + rec)
    half = [s for s in tapps.merge_device_lowerings([_linreg(1), _linreg(2)]).stages
            if s.name != f"syrk_gemv{BATCH_SEP}1"]
    with pytest.raises(ValueError, match="one copy of the walk"):
        twalk.cuda_program(half)
    moe = tml.moe_device_lowering(tml.moe_dispatch_lowering(n_tokens=8,
                                                            device="cpu"))
    with pytest.raises(ValueError, match="stage 'experts' runs 'moe.experts', not "
                                         "a body of stage 'moments'"):
        twalk.cuda_program(_linreg(1).stages + moe.stages)
    twice = [s for s in _linreg(1).stages] + [
        dataclasses.replace(_linreg(1).stages[0], name="again")]
    with pytest.raises(ValueError, match="repeat"):
        twalk.cuda_program(twice)
