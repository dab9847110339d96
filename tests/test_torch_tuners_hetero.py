"""The port's serving replay, its online substrate bandit and its hetero
and server tuners against the JAX package's.

``simulate_server``, ``replay_online_hetero``, ``select_offline_hetero``,
``tune_online_hetero`` and ``select_offline_server`` run in virtual time
on numpy in both packages, so on the same seeded inputs every result must
be the reference's to the bit: the chosen configuration or placement, the
predicted makespans and latencies, every simulated chunk, the bandits'
histories and the preemption logs.
"""

import numpy as np
import pytest

from repro.core import admission as jadm
from repro.core import autotune as jtune
from repro.core import dag as jdag
from repro.core import online as jonline
from repro.core import placement as jpl
from repro.core import server as jsrv
from repro.core import simulator as jsim
from repro.core import telemetry as jtel
from repro.vee import apps as japps
from repro_torch.core import admission as tadm
from repro_torch.core import autotune as ttune
from repro_torch.core import dag as tdag
from repro_torch.core import online as tonline
from repro_torch.core import placement as tpl
from repro_torch.core import server as tsrv
from repro_torch.core import simulator as tsim
from repro_torch.core import telemetry as ttel
from repro_torch.vee import apps as tapps

PKGS = {"ref": (jdag, jsrv, jsim, jtune, jonline, jpl),
        "port": (tdag, tsrv, tsim, ttune, tonline, tpl)}


def _noop(inputs, s, z):
    return None


def _sim_jobs(pkg, specs):
    """Cost-only jobs, the shape of the reference's server tests: a skewed
    ``prop`` -> streamed ``check`` (+ a ``reduce`` behind a full edge).
    ``specs``: (name, n, arrival, tenant, weight, priority, seed, tail)."""
    dag_mod, srv = PKGS[pkg][:2]
    jobs = []
    for name, n, arrival, tenant, weight, prio, seed, tail in specs:
        rng = np.random.default_rng(seed)
        stages = [dag_mod.Stage("prop", n, _noop),
                  dag_mod.Stage("check", n, _noop, combine="sum",
                                deps=(dag_mod.StageDep("prop", "elementwise"),))]
        costs = {"prop": rng.pareto(1.2, n) * 1e-5 + 1e-6,
                 "check": np.full(n, 1e-7)}
        if tail:
            m = max(8, n // 64)
            stages.append(dag_mod.Stage("reduce", m, _noop, combine="sum",
                                        deps=(dag_mod.StageDep("prop", "full"),)))
            costs["reduce"] = np.full(m, 2e-5)
        jobs.append(srv.Job(name, dag_mod.PipelineDAG(stages), tenant=tenant,
                            weight=weight, priority=prio, arrival_s=arrival,
                            stage_costs=costs))
    return jobs


MIXED = [("batch", 1200, 0.0, "analytics", 1.0, 0, 0, True),
         ("inter1", 200, 0.002, "interactive", 4.0, 2, 1, True),
         ("inter2", 200, 0.004, "interactive", 4.0, 1, 2, False)]


def _server_sim(res):
    """Everything a ``ServerSimResult`` holds, as plain values."""
    return (res.makespan, res.job_finish, res.job_latency, res.tenant_service,
            res.per_worker_busy, res.queue_wait,
            [tuple(vars(e).values()) for e in res.events],
            [tuple(vars(p).values()) for p in res.preemptions])


def _spans(tracer):
    return [tuple(vars(s).values()) for s in tracer.spans()]


# ------------------------------------------------------- simulate_server

ARBS = [("fifo", None), ("priority", None), ("priority", {"starve_after_s": 0.01}),
        ("fair", None),
        ("preemptive", {"inner": "fair", "n_workers": 4, "slack_s": 0.01})]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("k", range(len(ARBS)))
def test_simulate_server_bitwise(k, seed):
    arbiter, kw = ARBS[k]
    got, want = (PKGS[p][2].simulate_server(
        _sim_jobs(p, MIXED), n_workers=4, arbiter=arbiter, arbiter_kwargs=kw,
        seed=seed) for p in ("port", "ref"))
    assert _server_sim(got) == _server_sim(want)
    assert got.latency_percentile(99) == want.latency_percentile(99)
    assert got.latencies() == want.latencies()


@pytest.mark.parametrize("tech", ["STATIC", "SS", "GSS", "TSS"])
def test_simulate_server_per_stage_configs_and_tracer(tech):
    """Per-job stage configs, staggered Submissions and the tracer."""
    out = []
    for p, tel in (("port", ttel), ("ref", jtel)):
        jobs = [j.__class__(**{**vars(j), "per_stage": {
            "prop": (tech, "PERCORE", "SEQ"), "check": ("GSS", "CENTRALIZED", "SEQ")}})
            for j in _sim_jobs(p, MIXED[1:])]
        tracer = tel.Tracer()
        res = PKGS[p][2].simulate_server(jobs, n_workers=3, arbiter="fair",
                                         seed=1, tracer=tracer)
        out.append((_server_sim(res), _spans(tracer)))
    assert out[0] == out[1]


def test_simulate_server_replays_a_preemptive_open_loop_trace():
    """The reference's pressured trace (load 5 on 4 workers): Submissions
    in, the same preemptions out."""
    kw = {"inner": "fair", "n_workers": 4, "slack_s": 0.5}
    got, want = (sim.simulate_server(adm.heavy_tailed_trace(80, seed=3, load=5.0,
                                                            n_workers=8),
                                     n_workers=4, arbiter="preemptive",
                                     arbiter_kwargs=kw)
                 for sim, adm in ((tsim, tadm), (jsim, jadm)))
    assert _server_sim(got) == _server_sim(want)
    assert got.preemptions


def test_simulate_server_refuses_duplicate_names():
    jobs = _sim_jobs("port", [MIXED[1], MIXED[1]])
    with pytest.raises(ValueError, match="duplicate job names"):
        tsim.simulate_server(jobs, n_workers=2)


# ------------------------------------------------- the substrate bandit

LINREG_LIKE = [("moments", "sum", ()),
               ("syrk", "sum", (("moments", "full"),))]
REC_LIKE = [("norms", "sum", ()), ("bias", "concat", ()),
            ("scores", "concat", (("norms", "full"), ("bias", "elementwise")))]


def _hetero(pkg, spec, n=256, seed=7):
    """The same DAG and a ``HeteroCostModel`` of seeded host and device
    rates in one package."""
    dag_mod, pl = PKGS[pkg][0], PKGS[pkg][5]
    dag = dag_mod.PipelineDAG([
        dag_mod.Stage(name, n, _noop, combine=comb,
                      deps=tuple(dag_mod.StageDep(p, k) for p, k in deps))
        for name, comb, deps in spec])
    rng = np.random.default_rng(seed)
    names = [s[0] for s in spec]
    host = {k: rng.uniform(1e-7, 5e-6, n) for k in names}
    dev = {k: rng.uniform(1e-8, 2e-6, n) for k in names}
    return dag, pl.HeteroCostModel(host=host, device=dev,
                                   transfer=pl.TransferModel(bytes_per_row=64.0))


def _history(hist):
    return [tuple(vars(r).values()) for r in hist]


@pytest.mark.parametrize("selector", ["ucb", "exp3"])
@pytest.mark.parametrize("spec", [LINREG_LIKE, REC_LIKE], ids=["linreg", "rec"])
def test_replay_online_hetero_bitwise(spec, selector):
    out = []
    for p in ("port", "ref"):
        dag, cm = _hetero(p, spec)
        online = PKGS[p][4].OnlineScheduler(
            selector=selector, arms=PKGS[p][4].default_hetero_arms(),
            resize=False, seed=5)
        hist = PKGS[p][5].replay_online_hetero(dag, cm, online, rounds=30,
                                               n_workers=4, seed=2)
        out.append((_history(hist), online.best_combos(list(dag.stage_names))))
    assert out[0] == out[1]
    assert len(out[0][0]) == 30


def test_replay_online_hetero_plain_costs():
    """A plain per-row dict stands for both substrates, as in the
    reference."""
    out = []
    for p in ("port", "ref"):
        dag, cm = _hetero(p, LINREG_LIKE, n=128, seed=3)
        online = PKGS[p][4].OnlineScheduler(
            arms=PKGS[p][4].default_hetero_arms(False), resize=False, seed=0)
        out.append(_history(PKGS[p][5].replay_online_hetero(
            dag, cm.host, online, rounds=12, n_workers=2)))
    assert out[0] == out[1]


# ------------------------------------------------------- the tuners

@pytest.mark.parametrize("spec", [LINREG_LIKE, REC_LIKE], ids=["linreg", "rec"])
def test_select_offline_hetero_bitwise(spec):
    got, want = [], []
    for p, out in (("port", got), ("ref", want)):
        dag, cm = _hetero(p, spec)
        for kw in (dict(n_workers=8), dict(n_workers=4, passes=1,
                                           fractions=(0.5,), seed=2,
                                           stage_configs=("GSS", "PERCORE", "SEQ"))):
            pl, ms, base = PKGS[p][3].select_offline_hetero(dag, cm, **kw)
            out.append((pl.describe(), ms, base))
    assert got == want
    for _, ms, base in got:
        assert ms <= min(base.values())


@pytest.mark.parametrize("selector", ["ucb", "exp3"])
def test_tune_online_hetero_bitwise(selector):
    out = []
    for p in ("port", "ref"):
        dag, cm = _hetero(p, REC_LIKE, n=128)
        res = PKGS[p][3].tune_online_hetero(dag, cm, n_workers=4, rounds=24,
                                            selector=selector, seed=1)
        out.append((res.assign, res.makespan, _history(res.history)))
    assert out[0] == out[1]


def test_tune_online_hetero_on_the_affinity_dag():
    """The reference's mixed-affinity DAG: the same arms and the same
    makespan after 48 rounds."""
    out = []
    for apps, tune in ((tapps, ttune), (japps, jtune)):
        dag, costs = apps.hetero_affinity_dag(512)
        res = tune.tune_online_hetero(dag, costs, n_workers=8, rounds=48, seed=0)
        out.append((res.assign, res.makespan))
    assert out[0] == out[1]


@pytest.mark.parametrize("objective", ["p99", "p50", "mean", "makespan"])
def test_select_offline_server_bitwise(objective):
    specs = [("a", 240, 0.0, "t1", 1.0, 0, 5, False),
             ("b", 160, 0.001, "t2", 2.0, 1, 6, False)]
    got, want = (PKGS[p][3].select_offline_server(
        _sim_jobs(p, specs), n_workers=4, arbiter="fair", objective=objective,
        passes=1) for p in ("port", "ref"))
    assert got == want
    assign, tuned, baseline = got
    assert tuned <= baseline
    assert set(assign) == {"a", "b"}


def test_select_offline_server_refuses_an_unknown_objective():
    msgs = []
    for p in ("port", "ref"):
        with pytest.raises(ValueError, match="objective") as err:
            PKGS[p][3].select_offline_server(
                _sim_jobs(p, [MIXED[2]]), n_workers=2, objective="p17th")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
