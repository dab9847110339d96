"""The port's multi-tenant server against the JAX package's.

The arbiters are pure functions of the job states and the clock, so
``order`` and ``charge`` are driven by one script on both packages'
``JobState``s (the preemptive arbiter on a scripted clock) and must rank,
charge and log alike. The registry's specs and the ``Submission`` <->
``Job`` bridge are compared directly. ``PipelineServer`` runs real
threads: a job's values are held to the reference's serve on the same
submissions — bitwise on one worker, where both pools pop every stage
in row order, and on more workers bitwise for concat and int stages and
within a stated limit for float sums (the reference folds them in
completion order, the port in row order) — and every chunk must run
exactly once. No test compares latencies or reads an order of events,
which the threads decide.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import executor as jexec
from repro.core import placement as jpl
from repro.core import preempt as jpre
from repro.core import registry as jreg
from repro.core import server as jsrv
from repro.core import submit as jsub
from repro.launch import serve as jserve
from repro_torch.core import dag as tdag
from repro_torch.core import executor as texec
from repro_torch.core import hetero as thet
from repro_torch.core import placement as tpl
from repro_torch.core import preempt as tpre
from repro_torch.core import registry as treg
from repro_torch.core import server as tsrv
from repro_torch.core import submit as tsub
from repro_torch.core import telemetry as ttel
from repro_torch.launch import serve as tserve
from repro_torch.vee import apps as tapps

# float sums of the mixed set's host DAGs (float64 numpy) folded in
# another order, of the stage's largest |entry|
SUM_RTOL = 1e-12


def _noop(inputs, s, z):
    return None


def _one_stage(pkg_dag, n=8):
    return pkg_dag.PipelineDAG([pkg_dag.Stage("a", n, _noop, combine="concat")])


# ------------------------------------------------------------- arbiters

JOBS = [  # name, priority, tenant, weight, arrival, deadline
    ("a", 0, "t1", 1.0, 0.0, None),
    ("b", 2, "t2", 4.0, 0.1, 1.0),
    ("c", 1, "t1", 1.0, 0.2, None),
    ("d", 2, "t3", 2.0, 0.3, 0.5),
]


def _states(srv, dag_mod):
    out = []
    for seq, (name, prio, tenant, w, arr, dl) in enumerate(JOBS):
        job = srv.Job(name=name, dag=_one_stage(dag_mod), priority=prio,
                      tenant=tenant, weight=w, arrival_s=arr, deadline_s=dl,
                      stage_costs={"a": np.full(8, 0.05 * (seq + 1))})
        out.append(srv.JobState(job=job, seq=seq, arrival=arr))
    return out


def _script(arbiter, states, steps=40, seed=0):
    """Order the arrived unfinished jobs, charge the first one, now and
    then finish one; return everything observable."""
    rng = np.random.default_rng(seed)
    log = []
    t = 0.0
    for k in range(steps):
        t += float(rng.uniform(0.0, 0.08))
        live = [js for js in states if js.arrival <= t and not js.done]
        ordered = arbiter.order(live, t)
        log.append((round(t, 12), [js.job.name for js in ordered],
                    [js.boosted for js in states], [js.preempted for js in states]))
        if ordered:
            dt = float(rng.uniform(0.001, 0.05))
            arbiter.charge(ordered[0], dt, t)
        if k % 9 == 8 and live:
            live[int(rng.integers(len(live)))].done = True
    log.append([(js.service, js.last_service) for js in states])
    return log


ARBS = [("fifo", {}), ("priority", {}), ("priority", {"starve_after_s": 0.1}),
        ("fair", {}), ("preemptive", {"inner": "fair", "n_workers": 2,
                                      "slack_s": 0.2}),
        ("preemptive", {"inner": "priority", "n_workers": 1, "slack_s": 0.5})]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", range(len(ARBS)))
def test_arbiters_order_and_charge_equal_reference(k, seed):
    from repro.core import dag as jdag

    spec, kw = ARBS[k]
    t_arb, j_arb = tsrv.make_arbiter(spec, **kw), jsrv.make_arbiter(spec, **kw)
    assert type(t_arb).__name__ == type(j_arb).__name__
    got = _script(t_arb, _states(tsrv, tdag), seed=seed)
    want = _script(j_arb, _states(jsrv, jdag), seed=seed)
    assert got == want
    if spec == "preemptive":
        assert ([tuple(vars(e).values()) for e in t_arb.preemption_log]
                == [tuple(vars(e).values()) for e in j_arb.preemption_log])
    if spec == "fair":
        assert t_arb._v == j_arb._v


def test_preemptive_arbiter_on_a_scripted_clock():
    """A deadline job under pressure parks the lower-priority jobs without
    a live deadline, which come back when the pressure clears."""
    from repro.core import dag as jdag

    logs = []
    for srv, pre, dag_mod in ((tsrv, tpre, tdag), (jsrv, jpre, jdag)):
        arb = pre.PreemptiveArbiter(inner="fifo", n_workers=1, slack_s=0.0)
        states = _states(srv, dag_mod)
        seen = []
        for t in (0.05, 0.15, 0.35, 0.45, 0.6, 1.2, 1.3):
            live = [js for js in states if js.arrival <= t and not js.done]
            seen.append([js.job.name for js in arb.order(live, t)])
            if t == 0.6:
                states[3].done = True    # d drains
        logs.append((seen, [tuple(vars(e).values()) for e in arb.preemption_log],
                     arb.slack(states[1], 0.2)))
    assert logs[0] == logs[1]
    kinds = [e[2] for e in logs[0][1]]
    assert "preempt" in kinds and "resume" in kinds


def test_arbiter_errors_equal_reference():
    for mod in (tsrv, jsrv):
        with pytest.raises(ValueError, match="unknown arbiter"):
            mod.make_arbiter("lottery")
        with pytest.raises(ValueError, match="weight must be > 0"):
            mod.Job(name="x", dag=None, weight=0.0)
    arb = tsrv.FairShareArbiter()
    assert tsrv.make_arbiter(arb) is arb
    assert sorted(tsrv.ARBITERS) == sorted(jsrv.ARBITERS)


def test_job_stage_costs_equal_reference():
    from repro.core import dag as jdag

    for srv, dag_mod in ((tsrv, tdag), (jsrv, jdag)):
        stages = [dag_mod.Stage("a", 6, _noop, combine="concat",
                                cost_of_range=lambda s, z: float(s + 1)),
                  dag_mod.Stage("b", 6, _noop, combine="concat"),
                  dag_mod.Stage("c", 6, _noop, combine="concat")]
        job = srv.Job("j", dag_mod.PipelineDAG(stages),
                      stage_costs={"c": np.arange(6.0)})
        costs = srv.job_stage_costs(job)
        assert [costs[k].tolist() for k in "abc"] == [
            [1.0, 2.0, 3.0, 4.0, 5.0, 6.0], [1.0] * 6, list(np.arange(6.0))]
        with pytest.raises(ValueError, match="costs"):
            srv.job_stage_costs(srv.Job("k", dag_mod.PipelineDAG(stages[:1]),
                                        stage_costs={"a": np.ones(3)}))


# ------------------------------------------------ registry and bridge

SPECS = [("config", "gss/percore", {"n_workers": 3}),
         ("config", "MFSC/pergroup/rnd", {}),
         ("config", ("SS", "CENTRALIZED"), {}),
         ("placement", "device", {"stage_names": ["a", "b"]}),
         ("placement", "split:0.3", {"stage_names": ["a", "b"]}),
         ("placement", "a=host,b=split:0.25,", {}),
         ("arbiter", "fair", {}),
         ("arbiter", "priority", {"starve_after_s": 0.5})]


def _norm(obj):
    if isinstance(obj, (jexec.SchedulerConfig, texec.SchedulerConfig)):
        return tuple(vars(obj).items())
    if isinstance(obj, (jpl.Placement, tpl.Placement)):
        return obj.describe()
    return (type(obj).__name__, sorted(
        (k, v) for k, v in vars(obj).items() if not isinstance(v, dict)))


@pytest.mark.parametrize("k", range(len(SPECS)))
def test_make_specs_equal_reference(k):
    kind, spec, kw = SPECS[k]
    assert _norm(treg.make(kind, spec, **kw)) == _norm(jreg.make(kind, spec, **kw))


@pytest.mark.parametrize("bad", [("widget", "x", {}), ("config", "zz", {}),
                                 ("config", "gss/ring", {}),
                                 ("placement", "split", {"stage_names": ["a"]}),
                                 ("placement", "device", {}),
                                 ("placement", "a=", {}),
                                 ("placement", "gpu", {"stage_names": ["a"]})])
def test_make_errors_equal_reference(bad):
    kind, spec, kw = bad
    with pytest.raises(ValueError) as got:
        treg.make(kind, spec, **kw)
    with pytest.raises(ValueError) as want:
        jreg.make(kind, spec, **kw)
    assert str(got.value) == str(want.value)


def test_make_placement_passes_through_and_reexports():
    pl = tpl.Placement.all_host(["a"])
    assert treg.make_placement(pl) is pl
    assert treg.make_arbiter is tsrv.make_arbiter
    assert sorted(treg.REGISTRY) == sorted(jreg.REGISTRY)


def test_to_job_and_the_job_type_error():
    from repro.core import dag as jdag

    kw = dict(name="s", tenant="t", priority=3, weight=2.0, arrival_s=0.5,
              deadline_s=1.5, per_stage={"a": ("SS", "CENTRALIZED", "SEQ")},
              stage_costs={"a": np.ones(8)})
    tj = tsub.Submission(dag=_one_stage(tdag), **kw).to_job()
    jj = jsub.Submission(dag=_one_stage(jdag), **kw).to_job()
    fields = ("name", "priority", "tenant", "weight", "arrival_s", "deadline_s",
              "per_stage")
    assert isinstance(tj, tsrv.Job)
    assert [getattr(tj, f) for f in fields] == [getattr(jj, f) for f in fields]
    with pytest.raises(ValueError, match="carries no dag"):
        tsub.Submission(name="x").to_job()
    # internal surfaces coerce a Job, public ones refuse it
    back = tsub.as_submission(tj)
    assert (back.name, back.tenant, back.deadline_s) == ("s", "t", 1.5)
    with pytest.raises(TypeError, match="no longer accepts core.server.Job"):
        tsub.as_submission(tj, surface="PipelineServer.submit")
    srv = tsrv.PipelineServer(texec.SchedulerConfig(n_workers=1))
    with pytest.raises(TypeError, match="PipelineServer.submit"):
        srv.submit(tj)
    with pytest.raises(TypeError, match="PipelineServer.serve"):
        srv.serve([tj])
    with pytest.raises(TypeError, match="expected Submission or Job"):
        tsub.as_submission(3)


# ----------------------------------------------------- the threaded pool

def _mixed(pkg_serve):
    """The launcher's mixed set, with the CC job at one row a chunk, where
    the reference's CSR gather is exact (ROADMAP C3)."""
    subs = pkg_serve._pipeline_submissions()
    ss = {"propagate": ("SS", "CENTRALIZED", "SEQ"),
          "changed": ("SS", "CENTRALIZED", "SEQ")}
    return [s.replace(per_stage=ss) if s.name == "cc_batch" else s for s in subs]


def _exactly_once(res, subs):
    """Every chunk of every job ran once: each stage's rows are covered by
    its events without gap or overlap."""
    for sub in subs:
        for name in sub.dag.stage_names:
            spans = sorted((e.start, e.size) for e in res.events
                           if e.job == sub.name and e.stage == name)
            starts = np.cumsum([0] + [z for _, z in spans])
            assert [s for s, _ in spans] == list(starts[:-1]), (sub.name, name)
            assert starts[-1] == sub.dag.stages[name].n_rows, (sub.name, name)
    assert sum(r.n_tasks for r in res.jobs.values()) == len(res.events)


def _compare(got, want, exact: bool):
    for job, jr in want.jobs.items():
        for stage, w in jr.values.items():
            g = np.asarray(got.jobs[job].values[stage])
            w = np.asarray(w)
            assert g.shape == w.shape, (job, stage)
            if exact or w.dtype.kind in "iub":
                assert np.array_equal(g, w), (job, stage)
            else:
                lim = SUM_RTOL * max(float(np.abs(w).max()), 1e-300)
                assert float(np.abs(g - w).max()) <= lim, (job, stage)


@pytest.mark.parametrize("arbiter", ["fifo", "priority", "fair", "preemptive"])
@pytest.mark.parametrize("workers", [1, 3])
def test_server_mixed_set_equals_reference(arbiter, workers):
    runs = []
    for srv, exe, serve in ((tsrv, texec, tserve), (jsrv, jexec, jserve)):
        cfg = exe.SchedulerConfig(technique="GSS", queue_layout="PERCORE",
                                  n_workers=workers)
        kw = ({"inner": "fair", "n_workers": workers, "slack_s": 0.5}
              if arbiter == "preemptive" else {})
        subs = _mixed(serve)
        runs.append((srv.PipelineServer(cfg, arbiter=arbiter,
                                        arbiter_kwargs=kw).serve(subs), subs))
    (got, subs), (want, _) = runs
    assert set(got.jobs) == set(want.jobs) == {s.name for s in subs}
    _exactly_once(got, subs)
    _compare(got, want, exact=workers == 1)
    assert set(got.tenant_service_s) == {"graph", "ml", "interactive"}


def test_server_values_do_not_depend_on_the_lanes():
    """The row-order sum fold: on one chunk plan (one config), a job's
    values are bitwise the same whichever lanes ran its chunks, under
    every arbiter's interleaving."""
    subs = _mixed(tserve)
    cfg = texec.SchedulerConfig(technique="GSS", queue_layout="PERCORE",
                                n_workers=4)
    res = [tsrv.PipelineServer(cfg, arbiter=arb).serve(subs)
           for arb in ("fifo", "priority", "fair")]
    for other in res[1:]:
        _compare(other, res[0], exact=True)


@pytest.mark.parametrize("placement", ["device", "split:0.5"])
def test_server_placed_job_is_its_solo_hetero_run(placement):
    low = tapps.linreg_device_lowering(1024, 9, tile=64, seed=2, device="cpu")
    names = low.dag.stage_names
    pl = treg.make_placement(placement, names)
    ss = {n: ("SS", "CENTRALIZED", "SEQ") for n in names}
    cfg = texec.SchedulerConfig(technique="GSS", queue_layout="PERCORE",
                                n_workers=3)
    subs = [tsub.Submission(dag=low.dag, name="placed", tenant="a",
                            placement=pl, per_stage=ss)] + _mixed(tserve)[1:]
    res = tsrv.PipelineServer(cfg, arbiter="fair", n_device=1).serve(subs)
    solo = thet.HeteroExecutor(low.dag, texec.SchedulerConfig(
        technique="SS", n_workers=3), pl, n_device=1).run()
    for k in names:
        assert np.array_equal(np.asarray(res.jobs["placed"].values[k]),
                              np.asarray(solo.values[k])), k
    assert np.array_equal(low.finalize(res.jobs["placed"].values),
                          low.finalize(solo.values))
    _exactly_once(res, subs)


@pytest.mark.parametrize("placement", ["device", "split:0.5"])
def test_server_walks_a_placed_jobs_lowering(placement):
    """A submission that carries its lowering has its device rows walked
    (the plain walker on the CPU): bitwise its solo walked
    ``HeteroExecutor`` run and the host-only one-worker SS run."""
    low = tapps.linreg_device_lowering(1024, 9, tile=64, seed=5, device="cpu")
    names = low.dag.stage_names
    pl = treg.make_placement(placement, names)
    ss = {n: ("SS", "CENTRALIZED", "SEQ") for n in names}
    subs = [tsub.Submission(dag=low.dag, name="placed", tenant="a",
                            placement=pl, per_stage=ss, lowering=low)
            ] + _mixed(tserve)[1:]
    tracer = ttel.Tracer()
    res = tsrv.PipelineServer(texec.SchedulerConfig(
        technique="GSS", queue_layout="PERCORE", n_workers=3),
        arbiter="fair", n_device=1, tracer=tracer).serve(subs)
    solo = thet.HeteroExecutor(low.dag, texec.SchedulerConfig(
        technique="SS", n_workers=3), pl, n_device=1, lowering=low).run()
    host = tdag.PipelineExecutor(low.dag, texec.SchedulerConfig(
        technique="SS", n_workers=1)).run()
    for k in names:
        assert torch.equal(res.jobs["placed"].values[k], solo.values[k]), k
        assert torch.equal(res.jobs["placed"].values[k], host.values[k]), k
    _exactly_once(res, subs)
    # only the walker lane's chunks of the lowered job carry F_DEVICE
    flagged = {(s.job, s.stage, s.chunk) for s in tracer.spans()
               if s.kind == "exec" and s.device}
    assert flagged == {(e.job, e.stage, e.task_id) for e in res.events
                       if e.worker >= 3 and e.job == "placed"}


def test_server_telemetry_and_metrics():
    tracer, reg = ttel.Tracer(), ttel.MetricsRegistry()
    subs = _mixed(tserve)
    res = tsrv.PipelineServer(texec.SchedulerConfig(n_workers=2), tracer=tracer,
                              metrics=reg).serve(subs)
    execs = [s for s in tracer.spans() if s.kind == "exec"]
    assert (sorted((s.job, s.stage, s.chunk) for s in execs)
            == sorted((e.job, e.stage, e.task_id) for e in res.events))
    assert ttel.validate_chrome_trace(tracer.to_chrome_trace()) == []
    rep = ttel.analyze_critical_path(tracer, makespan=res.makespan_s)
    rep.reconcile(res.stats, res.makespan_s, rel_tol=0.05, abs_tol=1e-6)
    snap = reg.snapshot()
    assert snap["counters"]["sched_chunks"] == len(res.events)
    assert snap["histograms"]["sched_job_latency_seconds"]["count"] == len(subs)
    assert {k for k in snap["counters"] if k.startswith("sched_tenant")} == {
        f'sched_tenant_service_seconds{{tenant="{t}"}}'
        for t in ("graph", "ml", "interactive")}


def test_server_surfaces_op_errors():
    def boom(inputs, s, z):
        raise RuntimeError("stage exploded")

    dag = tdag.PipelineDAG([tdag.Stage("a", 8, boom, combine="concat")])
    with pytest.raises(RuntimeError, match="stage exploded"):
        tsrv.PipelineServer(texec.SchedulerConfig(n_workers=2)).serve(
            [tsub.Submission(dag=dag, name="x")])
    with pytest.raises(ValueError, match="duplicate job names"):
        tsrv.PipelineServer(texec.SchedulerConfig(n_workers=1)).serve(
            [tsub.Submission(dag=dag, name="x"), tsub.Submission(dag=dag, name="x")])


# ------------------------------------------------------------ launcher

def test_serve_pipelines_on_the_cpu(tmp_path, capsys):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    runs = tserve.main(["--mode", "pipelines", "--workers", "2", "--compare",
                        "--trace-out", str(trace), "--metrics-out", str(metrics)])
    assert list(runs) == ["fifo", "priority", "fair", "preemptive"]
    for arb, (res, subs, tracer, reg) in runs.items():
        assert sorted(res.jobs) == sorted(s.name for s in subs), arb
        _exactly_once(res, subs)
    out = capsys.readouterr().out
    assert out.count("[serve:pipelines] arbiter=") == 4
    assert "critical path (preemptive)" in out
    assert ttel.validate_chrome_trace(json.loads(trace.read_text())) == []
    snap = json.loads(metrics.read_text())
    assert snap["counters"]["sched_chunks"] == len(runs["preemptive"][0].events)
    prom = metrics.with_suffix(".prom").read_text()
    assert "# TYPE sched_chunks counter" in prom


def test_serve_one_arbiter_untraced(capsys):
    runs = tserve.main(["--mode", "pipelines", "--workers", "2", "--arbiter",
                        "priority", "--config", "static"])
    assert list(runs) == ["priority"]
    assert runs["priority"][2] is None and runs["priority"][3] is None
    assert "critical path" not in capsys.readouterr().out
