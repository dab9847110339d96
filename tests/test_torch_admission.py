"""The port's open-loop front door against the JAX package's.

``heavy_tailed_trace`` draws with numpy (``default_rng(seed)``) in both
packages, and ``TokenBucket``, ``AdmissionController``,
``AutoscalePolicy`` and ``replay_open_loop`` decide on a virtual clock, so
every result must be the reference's to the bit on the same trace: each
member's outcome and latency, the shed reasons, the batches and their
members, the pool timeline, each lane's busy time, the preemptions, the
tracer's spans and the metrics snapshot. The sizes are the reference's
tests' (``tests/test_admission.py``): traces of 120-400 jobs on at most 8
workers.
"""

import argparse

import numpy as np
import pytest

from repro.core import admission as jadm
from repro.core import dag as jdag
from repro.core import online as jonline
from repro.core import submit as jsub
from repro.core import telemetry as jtel
from repro.launch import serve as jserve
from repro_torch.core import admission as tadm
from repro_torch.core import dag as tdag
from repro_torch.core import online as tonline
from repro_torch.core import submit as tsub
from repro_torch.core import telemetry as ttel
from repro_torch.launch import serve as tserve

PKGS = {"port": (tadm, tdag, tonline, tsub, ttel),
        "ref": (jadm, jdag, jonline, jsub, jtel)}


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


def _sub_fields(s):
    dag = s.dag
    return (s.name, s.tenant, s.priority, s.weight, s.arrival_s, s.deadline_s,
            [(n, dag.stages[n].n_rows, dag.stages[n].combine,
              [(d.producer, d.kind) for d in dag.stages[n].deps])
             for n in dag.stage_names],
            {k: v.tolist() for k, v in s.stage_costs.items()})


def _openloop(res):
    """Everything an ``OpenLoopResult`` holds, as plain values."""
    return ({k: tuple(vars(m).values()) for k, m in res.members.items()},
            res.n_jobs, res.n_admitted, res.n_shed, res.shed_reasons,
            res.n_batches, res.n_coalesced, res.n_chunks, res.makespan_s,
            res.queue_wait_s, res.pool_timeline, res.worker_busy_s,
            [tuple(vars(p).values()) for p in res.preemptions],
            res.shed_rate, res.latencies(), res.deadline_hit_rate(),
            res.avg_pool(), [res.latency_percentile(q) for q in (50, 99, 99.9)])


# ------------------------------------------------------- the trace

@pytest.mark.parametrize("n,seed,load,workers", [
    (400, 3, 1.5, 8), (120, 1, 1.2, 4), (150, 7, 1.0, 4), (240, 3, 5.0, 8)])
def test_heavy_tailed_trace_bitwise(n, seed, load, workers):
    got = tadm.heavy_tailed_trace(n, seed=seed, load=load, n_workers=workers)
    want = jadm.heavy_tailed_trace(n, seed=seed, load=load, n_workers=workers)
    assert [_sub_fields(s) for s in got] == [_sub_fields(s) for s in want]
    assert isinstance(got[0], tsub.Submission)


# ---------------------------------------------- admission and autoscaling

def test_token_bucket_equals_reference():
    script = [(0.0, 1), (0.0, 1), (0.0, 1), (0.1, 1), (0.1, 1), (0.35, 2),
              (10.0, 1), (10.0, 1), (10.0, 1), (9.0, 1), (10.5, 0.5)]
    for rate, cap in ((10.0, 2), (100.0, 0), (0.0, 3), (2.5, 1.5)):
        got, want = tadm.TokenBucket(rate, cap), jadm.TokenBucket(rate, cap)
        assert ([got.take(t, k) for t, k in script]
                == [want.take(t, k) for t, k in script])
        assert (got.level, got.t_last) == (want.level, want.t_last)
    for bad in ((-1.0, 2), (1.0, -2)):
        with pytest.raises(ValueError, match="rate/capacity"):
            tadm.TokenBucket(*bad)


def _feedback(online_mod, rate):
    fb = online_mod.FeedbackLog()
    for i in range(16):
        for stage in ("a", "b"):
            fb.record(online_mod.ChunkObservation(stage, i, i, 1, rate, 0, 0.0))
    return fb


@pytest.mark.parametrize("rate", [None, 1e-3, 1e-7])
def test_admission_decisions_equal_reference(rate):
    cases = [  # (name, tenant, arrival, deadline, t, backlog, workers)
        ("late", "t", 0.0, 0.0, 0.0, 0.0, 4),
        ("late2", "t", 0.0, 0.5, 0.5, 0.0, 4),
        ("tight", "t", 0.0, 1e-3, 0.0, 0.0, 1),
        ("tight2", "t", 0.0, 1e-3, 0.0, 1.0, 1),
        ("slack", "u", 0.1, 2.0, 0.2, 0.5, 8),
        ("free", "u", 0.0, None, 0.0, 9.0, 2),
        ("free2", "u", 0.3, None, 0.3, 0.0, 0),
        ("z", "z", 0.0, None, 0.0, 0.0, 4),
        ("z2", "z", 1.0, None, 1.0, 0.0, 4),
    ]
    out = []
    for pkg in ("port", "ref"):
        adm_mod, _, online_mod, _, _ = PKGS[pkg]
        fb = None if rate is None else _feedback(online_mod, rate)
        adm = adm_mod.AdmissionController(
            buckets={"u": adm_mod.TokenBucket(rate=5.0, capacity=1),
                     "z": adm_mod.TokenBucket(rate=5.0, capacity=0)},
            safety=0.9, feedback=fb)
        row = []
        for name, tenant, arr, dl, t, backlog, workers in cases:
            job = _two_stage(pkg, name=name, tenant=tenant, arrival_s=arr,
                             deadline=dl).to_job()
            dec = adm.decide(job, t, backlog, workers)
            row.append((dec.admitted, dec.reason, adm.estimate_service_s(job)))
        out.append(row)
    assert out[0] == out[1]
    assert {r[1] for r in out[0]} >= {"expired", "no_slack", "throttled", "admitted"}


def test_autoscale_decisions_equal_reference():
    grid = [(a, d, s) for a in (1, 4, 8) for d in (0, 3, 8, 100)
            for s in (None, -1.0, 0.0, 0.5)]
    for kw in (dict(min_workers=2, max_workers=8),
               dict(min_workers=1, max_workers=4, depth_per_worker=0.5,
                    slack_low_s=0.1, step=3)):
        got, want = tadm.AutoscalePolicy(**kw), jadm.AutoscalePolicy(**kw)
        assert [got.decide(*g) for g in grid] == [want.decide(*g) for g in grid]
    for bad in (dict(min_workers=0, max_workers=4), dict(min_workers=4, max_workers=2),
                dict(min_workers=1, max_workers=2, interval_s=0.0)):
        with pytest.raises(ValueError):
            tadm.AutoscalePolicy(**bad)


# ------------------------------------------------------ the replayer

def _front(pkg, trace, **kw):
    """The ``pipeline_server_openloop`` front door: fair, the etl tenant's
    token bucket, same-shape batching and a feedback log shared by
    admission and the replay."""
    adm_mod, _, online_mod, _, _ = PKGS[pkg]
    fb = online_mod.FeedbackLog()
    adm = adm_mod.AdmissionController(
        buckets={"etl": adm_mod.TokenBucket(rate=400.0, capacity=20)}, feedback=fb)
    return adm_mod.replay_open_loop(trace, n_workers=8, arbiter="fair",
                                    admission=adm, batching=adm_mod.BatchPolicy(2e-3, 8),
                                    feedback=fb, **kw)


def _replays(case):
    """One replay configuration, run on both packages' own traces."""
    out = []
    for pkg in ("port", "ref"):
        adm_mod = PKGS[pkg][0]
        if case == "plain":
            trace = adm_mod.heavy_tailed_trace(300, seed=3, load=0.5, n_workers=8)
            res = adm_mod.replay_open_loop(trace, n_workers=8)
        elif case == "fifo":
            trace = adm_mod.heavy_tailed_trace(400, seed=3, load=1.5, n_workers=8)
            res = adm_mod.replay_open_loop(trace, n_workers=8, arbiter="fifo")
        elif case == "front_door":
            trace = adm_mod.heavy_tailed_trace(400, seed=3, load=1.5, n_workers=8)
            res = _front(pkg, trace)
        elif case == "admission":
            trace = adm_mod.heavy_tailed_trace(150, seed=7, load=1.0, n_workers=4)
            res = adm_mod.replay_open_loop(
                trace, n_workers=4, admission=adm_mod.AdmissionController(safety=0.5))
        elif case == "autoscale":
            trace = adm_mod.heavy_tailed_trace(120, seed=1, load=1.2, n_workers=4)
            res = adm_mod.replay_open_loop(
                trace, n_workers=4, autoscale=adm_mod.AutoscalePolicy(
                    min_workers=1, max_workers=4, interval_s=2e-3))
        elif case == "autoscale_slack":
            trace = adm_mod.heavy_tailed_trace(200, seed=2, load=2.0, n_workers=6)
            res = adm_mod.replay_open_loop(
                trace, n_workers=6, arbiter="priority",
                batching=adm_mod.BatchPolicy(1e-3, 4),
                autoscale=adm_mod.AutoscalePolicy(
                    min_workers=2, max_workers=6, interval_s=1e-3,
                    slack_low_s=1e-3))
        elif case in ("fair_pressured", "preemptive"):
            trace = adm_mod.heavy_tailed_trace(240, seed=3, load=5.0, n_workers=8)
            kw = ({"arbiter": "preemptive", "arbiter_kwargs": {
                "inner": "fair", "n_workers": 8, "slack_s": 0.5}}
                if case == "preemptive" else {"arbiter": "fair"})
            res = adm_mod.replay_open_loop(trace, n_workers=8, **kw)
        out.append(_openloop(res))
    return out


CASES = ["plain", "fifo", "front_door", "admission", "autoscale",
         "autoscale_slack", "fair_pressured", "preemptive"]


@pytest.mark.parametrize("case", CASES)
def test_replay_open_loop_bitwise(case):
    got, want = _replays(case)
    assert got == want
    members, n_jobs = got[0], got[1]
    assert len(members) == n_jobs
    if case.startswith("autoscale"):
        assert len({n for _, n in got[10]}) > 1          # the pool resized
    if case == "preemptive":
        assert got[12]                                   # and it preempted


def test_front_door_beats_fifo_on_overload():
    """The reference's own property (``tests/test_admission.py``): on the
    overloaded trace the front door's p99.9 and deadline hit rate are no
    worse than the FIFO baseline's, and batching coalesced."""
    trace = tadm.heavy_tailed_trace(400, seed=3, load=1.5, n_workers=8)
    base = tadm.replay_open_loop(trace, n_workers=8, arbiter="fifo")
    front = _front("port", trace)
    assert front.latency_percentile(99.9) <= base.latency_percentile(99.9)
    assert front.deadline_hit_rate() >= base.deadline_hit_rate()
    assert front.n_batches > 0 and front.n_coalesced > front.n_batches


def test_replay_batching_flushes_on_window_and_size():
    out = []
    for pkg in ("port", "ref"):
        adm_mod = PKGS[pkg][0]
        subs = [_two_stage(pkg, name=f"j{i}", arrival_s=t)
                for i, t in enumerate((0.0, 1e-4, 2e-4, 9e-3))]
        out.append([_openloop(adm_mod.replay_open_loop(
            subs, n_workers=2, batching=adm_mod.BatchPolicy(window_s=5e-3,
                                                            max_batch=m)))
            for m in (8, 2, 1)])
    assert out[0] == out[1]
    (window, size, off) = out[0]
    assert (window[5], window[6]) == (1, 3)   # one batch of the first three
    assert (size[5], size[6]) == (1, 2)       # a pair, then singletons
    assert (off[5], off[6]) == (0, 0)         # max_batch 1 never batches


def test_replay_sheds_everything_expired():
    out = []
    for pkg in ("port", "ref"):
        adm_mod = PKGS[pkg][0]
        subs = [_two_stage(pkg, name=f"j{i}", arrival_s=i * 1e-4, deadline=0.0)
                for i in range(8)]
        out.append(_openloop(adm_mod.replay_open_loop(
            subs, n_workers=2, admission=adm_mod.AdmissionController())))
    assert out[0] == out[1]
    res = out[0]
    assert res[4] == {"expired": 8} and res[14] == {} and res[15] == 0.0


def test_replay_refuses_duplicate_names():
    subs = [_two_stage("port", name="x"), _two_stage("port", name="x")]
    with pytest.raises(ValueError, match="duplicate submission names"):
        tadm.replay_open_loop(subs, n_workers=2)


def test_replay_traces_and_metrics_equal_reference():
    """The tracer's admit / shed / batch / exec / preempt spans and the
    ``collect_openloop_metrics`` snapshot of one replay."""
    out = []
    for pkg in ("port", "ref"):
        adm_mod, _, _, _, tel = PKGS[pkg]
        trace = adm_mod.heavy_tailed_trace(200, seed=3, load=5.0, n_workers=8)
        tracer, reg = tel.Tracer(), tel.MetricsRegistry()
        adm = adm_mod.AdmissionController(
            buckets={"etl": adm_mod.TokenBucket(rate=400.0, capacity=20)})
        res = adm_mod.replay_open_loop(
            trace, n_workers=8, arbiter="preemptive",
            arbiter_kwargs={"inner": "fair", "n_workers": 8, "slack_s": 0.5},
            admission=adm, batching=adm_mod.BatchPolicy(2e-3, 8),
            tracer=tracer, metrics=reg)
        out.append(([tuple(vars(s).values()) for s in tracer.spans()],
                    reg.snapshot(), _openloop(res),
                    tel.validate_chrome_trace(tracer.to_chrome_trace())))
    assert out[0] == out[1]
    kinds = {s[0] for s in out[0][0]}
    assert {"admit", "shed", "batch", "exec", "preempt"} <= kinds
    assert out[0][3] == []


# ------------------------------------------------------- the launcher

def test_serve_openloop_prints_the_references_lines(capsys, tmp_path):
    argv = ["--mode", "openloop", "--requests", "240", "--workers", "4",
            "--load", "2.5", "--arbiter", "preemptive", "--slack", "0.2"]
    runs = tserve.main(argv + ["--trace-out", str(tmp_path / "t.json"),
                               "--metrics-out", str(tmp_path / "m.json")])
    got = capsys.readouterr().out.splitlines()
    assert list(runs) == ["fifo baseline", "front door"]
    jserve.serve_openloop(argparse.Namespace(
        requests=240, workers=4, load=2.5, arbiter="preemptive", slack=0.2,
        trace_out=None, metrics_out=None))
    want = capsys.readouterr().out.splitlines()
    assert [ln for ln in got if ln.startswith("[serve:openloop]")] == want
    assert any("-> " + str(tmp_path / "t.json") in ln for ln in got)
    assert (tmp_path / "m.prom").exists()
    assert runs["front door"].n_batches > 0
