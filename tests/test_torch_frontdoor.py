"""The port's ``FrontDoor`` on the real pool against the JAX package's.

``FrontDoor.serve`` plans in trace time — admission on the submissions'
declared costs, batching windows and sizes — and that plan must be the
reference's exactly: the sheds with their reasons, the number of batches,
the launches (which members rode in which batch) and the admit / shed /
batch markers. The pool then runs real threads, so a test asserts only
what the threads cannot change: each member's values are bitwise its solo
run's (int stages, and a placed float job whose ``sum`` stages fold in row
order), every chunk runs once, and only the walker lane's chunks of the
placed job carry ``F_DEVICE``. No latency, percentile, event order or
count of steals is asserted, admission reads no ``FeedbackLog`` filled by
a timed run, and deadlines are None, 0.0 or far away.
"""

import numpy as np
import pytest

from repro.core import admission as jadm
from repro.core import dag as jdag
from repro.core import executor as jexec
from repro.core import submit as jsub
from repro.core import telemetry as jtel
from repro_torch.core import admission as tadm
from repro_torch.core import dag as tdag
from repro_torch.core import executor as texec
from repro_torch.core import registry as treg
from repro_torch.core import submit as tsub
from repro_torch.core import telemetry as ttel
from repro_torch.vee import apps as tapps

PKGS = {"port": (tadm, tdag, texec, tsub, ttel),
        "ref": (jadm, jdag, jexec, jsub, jtel)}
MARKS = ("admit", "shed", "batch")


def _two_stage(pkg, offset=0, n=32, deadline=None, **kw):
    """The reference's two-stage int job: ``a`` rows -> ``b`` their sum."""
    _, dag_mod, _, sub_mod, _ = PKGS[pkg]
    a = dag_mod.Stage("a", n, lambda i, s, z: np.arange(s, s + z, dtype=np.int64)
                      + offset, combine="concat")
    b = dag_mod.Stage("b", n, lambda i, s, z: int(i["a"][s:s + z].sum()),
                      combine="sum", deps=(dag_mod.StageDep("a", "elementwise"),))
    costs = {"a": np.full(n, 1e-5), "b": np.full(n, 1e-5)}
    return sub_mod.Submission(dag=dag_mod.PipelineDAG([a, b]), deadline_s=deadline,
                              stage_costs=costs, **kw)


def _trace(pkg):
    """Same-shape members to coalesce (a window of 3, one past its window,
    a group of 5 that fills ``max_batch`` 4), another tenant, another
    shape, an expired job, a throttled one and one with a far deadline."""
    subs = [_two_stage(pkg, offset=10 * j, name=f"m{j}", arrival_s=1e-4 * j)
            for j in range(3)]
    subs.append(_two_stage(pkg, offset=7, name="m_late", arrival_s=9e-3))
    subs += [_two_stage(pkg, offset=100 + j, n=16, name=f"g{j}", tenant="grp",
                        arrival_s=2e-4 + 1e-4 * j) for j in range(5)]
    subs += [_two_stage(pkg, offset=3, name="other", tenant="t2", arrival_s=3e-4),
             _two_stage(pkg, name="late", arrival_s=0.0, deadline=0.0),
             _two_stage(pkg, name="quota", tenant="z", arrival_s=1e-4),
             _two_stage(pkg, offset=5, name="far", tenant="t2", arrival_s=5e-4,
                        deadline=1e6)]
    return subs


def _front_door(pkg, n_workers=2, **kw):
    adm_mod, _, exe, _, _ = PKGS[pkg]
    return adm_mod.FrontDoor(
        exe.SchedulerConfig(n_workers=n_workers),
        admission=adm_mod.AdmissionController(
            buckets={"z": adm_mod.TokenBucket(rate=5.0, capacity=0)}),
        batching=adm_mod.BatchPolicy(window_s=5e-3, max_batch=4), **kw)


def _marks(tracer):
    return sorted((s.kind, s.t0, s.job, s.detail) for s in tracer.spans()
                  if s.kind in MARKS)


def _solo(pkg, sub):
    _, dag_mod, exe, _, _ = PKGS[pkg]
    return dag_mod.PipelineExecutor(sub.dag, exe.SchedulerConfig(n_workers=2)).run()


def test_front_door_plan_and_members_equal_reference():
    out = {}
    for pkg in ("port", "ref"):
        tracer = PKGS[pkg][4].Tracer()
        fd = _front_door(pkg, tracer=tracer)
        subs = _trace(pkg)
        for s in subs:
            fd.submit(s)
        res = fd.serve()
        out[pkg] = (res, subs, _marks(tracer))
    (got, subs, got_marks), (want, _, want_marks) = out["port"], out["ref"]
    assert got.shed == want.shed == {"late": "expired", "quota": "throttled"}
    assert got.n_batches == want.n_batches == 3
    assert sorted(got.server_result.jobs) == sorted(want.server_result.jobs)
    assert sorted(got.jobs) == sorted(want.jobs)
    assert got_marks == want_marks
    for sub in subs:
        if sub.name in got.shed:
            continue
        r, solo = got.jobs[sub.name], _solo("port", sub)
        assert np.array_equal(r.values["a"], solo.values["a"]), sub.name
        assert r.values["b"] == solo.values["b"] == want.jobs[sub.name].values["b"]
        assert np.array_equal(r.values["a"], want.jobs[sub.name].values["a"])
        assert r.n_tasks > 0


def test_front_door_without_admission_or_batching():
    """No admission, no batching: every submission is its own launch."""
    for pkg in ("port", "ref"):
        adm_mod, _, exe, _, _ = PKGS[pkg]
        res = adm_mod.FrontDoor(exe.SchedulerConfig(n_workers=2)).serve(_trace(pkg))
        names = sorted(s.name for s in _trace(pkg))
        assert (res.shed, res.n_batches) == ({}, 0)
        assert sorted(res.jobs) == sorted(res.server_result.jobs) == names


@pytest.mark.parametrize("placement", ["device", "split:0.5"])
def test_front_door_sends_a_placed_job_to_the_walker_lane(placement):
    """A placed submission with its lowering never batches: it reaches the
    pool under its own name, its device rows walked by the lane (the plain
    walker on the CPU), bitwise the host-only one-worker SS run; the
    same-shape members beside it still coalesce."""
    low = tapps.linreg_device_lowering(1024, 9, tile=64, seed=5, device="cpu")
    names = low.dag.stage_names
    placed = tsub.Submission(
        dag=low.dag, name="placed", tenant="ml", arrival_s=1e-4,
        placement=treg.make_placement(placement, names),
        per_stage={n: ("SS", "CENTRALIZED", "SEQ") for n in names}, lowering=low)
    members = [_two_stage("port", offset=10 * j, name=f"m{j}", arrival_s=1e-4 * j)
               for j in range(3)]
    tracer = ttel.Tracer()
    fd = tadm.FrontDoor(texec.SchedulerConfig(technique="GSS", queue_layout="PERCORE",
                                              n_workers=3),
                        admission=tadm.AdmissionController(),
                        batching=tadm.BatchPolicy(window_s=5e-3, max_batch=8),
                        tracer=tracer)
    res = fd.serve(members + [placed])
    assert res.n_batches == 1 and res.shed == {}
    assert sorted(res.server_result.jobs) == ["batch1(m0x3)", "placed"]
    host = tdag.PipelineExecutor(low.dag, texec.SchedulerConfig(
        technique="SS", n_workers=1)).run()
    for k in names:
        assert np.array_equal(np.asarray(res.jobs["placed"].values[k]),
                              np.asarray(host.values[k])), k
    for m in members:
        assert res.jobs[m.name].values["b"] == _solo("port", m).values["b"]
    events = res.server_result.events
    for name in names:
        spans = sorted((e.start, e.size) for e in events
                       if e.job == "placed" and e.stage == name)
        ends = np.cumsum([0] + [z for _, z in spans])
        assert [s for s, _ in spans] == list(ends[:-1])
        assert ends[-1] == low.dag.stages[name].n_rows
    flagged = {(s.job, s.stage, s.chunk) for s in tracer.spans()
               if s.kind == "exec" and s.device}
    assert flagged == {(e.job, e.stage, e.task_id) for e in events
                       if e.worker >= 3 and e.job == "placed"}


def test_front_door_refuses_job_records_and_drains_its_queue():
    fd = _front_door("port")
    job = _two_stage("port", name="j").to_job()
    with pytest.raises(TypeError, match="FrontDoor.submit"):
        fd.submit(job)
    with pytest.raises(TypeError, match="FrontDoor.serve"):
        fd.serve([job])
    fd.submit(_two_stage("port", name="q"))
    assert sorted(fd.serve().jobs) == ["q"]
    assert fd.serve().jobs == {}
