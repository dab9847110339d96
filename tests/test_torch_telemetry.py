"""The port's telemetry against the JAX package's.

Spans, the Chrome-trace export, the metrics registry and its collectors,
the critical-path report and the trace validator are pure functions of
what was recorded, so each is held to the reference on the same input:
the same raw span rows give equal ``to_chrome_trace`` dicts, the same
metric operations give equal snapshots and Prometheus text, the same span
log gives an equal critical-path report, and malformed traces give the
same errors. ``device_walk_spans`` folds the port's plain-walk stamps
into the spans the reference folds from its Pallas walk (interpret mode)
on the same lowering. Real thread pools appear only where the check is
exact whatever the threads do (one exec span per chunk, a report that
telescopes to its makespan by construction).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import device_schedule as jsched
from repro.core import online as jonline
from repro.core import telemetry as jtel
from repro.kernels import dag_walk as jwalk
from repro.vee import apps as japps
from repro_torch.core import dag as tdag
from repro_torch.core import device_schedule as tsched
from repro_torch.core import executor as texec
from repro_torch.core import online as tonline
from repro_torch.core import telemetry as ttel
from repro_torch.kernels import dag_walk as twalk
from repro_torch.vee import apps as tapps

KINDS = ("exec", "exec", "exec", "transfer", "admission", "preempt", "resize")


def _raw_rows(seed: int, n: int = 60) -> list[tuple]:
    """Seeded raw span rows over a few jobs, stages, lanes and kinds."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        kind = KINDS[int(rng.integers(len(KINDS)))]
        job = f"job{int(rng.integers(3))}"
        stage = ("", "a", "b", "c")[int(rng.integers(4))]
        t0 = float(rng.uniform(0.0, 1.0))
        if kind in ("exec", "transfer"):
            t1 = t0 + float(rng.uniform(0.0, 0.2))
            lane = int(rng.integers(-1, 5))
            wait = float(rng.uniform(0.0, 0.05)) if rng.random() < 0.5 else 0.0
        else:
            t1, lane, wait = t0, -1, 0.0
        chunk = int(rng.integers(-1, 8))
        flag = int(rng.integers(0, 4))
        detail = "" if rng.random() < 0.6 else f"d{int(rng.integers(9))}"
        rows.append((kind, job, stage, chunk, lane, t0, t1, flag, wait, detail))
    return rows


def _fill(mod, rows, how: str):
    tr = mod.Tracer(job="tj")
    if how == "extend":
        tr.extend_raw(rows)
    else:
        for r in rows:
            if r[0] in ("exec", "transfer"):
                tr.record_raw(*r)
            else:
                tr.mark(r[0], r[5], r[1], r[2], r[3], r[9])
    return tr


# ------------------------------------------------------ spans and traces

@pytest.mark.parametrize("how", ["extend", "record"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chrome_trace_equals_reference(seed, how, tmp_path):
    rows = _raw_rows(seed)
    t, j = _fill(ttel, rows, how), _fill(jtel, rows, how)
    assert len(t) == len(j) == len(rows)
    assert ([tuple(vars(s).values()) for s in t.spans()]
            == [tuple(vars(s).values()) for s in j.spans()])
    got, want = t.to_chrome_trace(), j.to_chrome_trace()
    assert got == want
    assert ttel.validate_chrome_trace(got) == []
    t.write_chrome_trace(tmp_path / "t.json")
    j.write_chrome_trace(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def test_chrome_trace_of_a_real_pool():
    """Exactly one exec span per executed chunk, identity-matched to the
    events, and a trace that validates: whatever the threads did."""
    stages = [tdag.Stage("s0", 48, lambda i, s, z: np.arange(s, s + z),
                         combine="concat"),
              tdag.Stage("s1", 48, lambda i, s, z: i["s0"][s:s + z] + 1,
                         combine="concat",
                         deps=(tdag.StageDep("s0", "elementwise"),))]
    tracer = ttel.Tracer(job="pool")
    res = tdag.PipelineExecutor(
        tdag.PipelineDAG(stages),
        texec.SchedulerConfig(technique="GSS", queue_layout="PERCORE",
                              n_workers=3), tracer=tracer).run()
    execs = [s for s in tracer.spans() if s.kind == "exec"]
    assert (sorted((s.stage, s.chunk) for s in execs)
            == sorted((e.stage, e.task_id) for e in res.events))
    obj = json.loads(json.dumps(tracer.to_chrome_trace()))
    assert ttel.validate_chrome_trace(obj) == []
    assert {e["pid"] for e in obj["traceEvents"]} == {1, 2}


MALFORMED = [
    {},
    {"traceEvents": 3},
    {"traceEvents": [5]},
    {"traceEvents": [{"ph": "Z", "pid": 1, "tid": 0, "name": "x", "ts": 0}]},
    {"traceEvents": [{"ph": "X", "pid": "1", "tid": 0, "name": "x", "ts": 0,
                      "dur": 1}]},
    {"traceEvents": [{"ph": "X", "pid": 1, "name": 3, "ts": 0, "dur": 1}]},
    {"traceEvents": [{"ph": "X", "pid": 1, "tid": 0, "name": "x", "dur": 1}]},
    {"traceEvents": [{"ph": "X", "pid": 1, "tid": 0, "name": "x", "ts": 0.0,
                      "dur": -1}]},
    {"traceEvents": [{"ph": "X", "pid": 1, "tid": 0, "name": "x", "ts": 0.0,
                      "dur": "1"}]},
    {"traceEvents": [{"ph": "M", "pid": 1, "tid": 0, "name": "thread_name"},
                     {"ph": "i", "pid": 1, "tid": 0, "name": "m", "ts": 1,
                      "args": {"bad": {1, 2}}}]},
    {"traceEvents": [{"ph": "X", "pid": 1, "tid": 0, "name": "ok", "ts": 0,
                      "dur": 0}]},
]


@pytest.mark.parametrize("k", range(len(MALFORMED)))
def test_validate_chrome_trace_equals_reference(k):
    obj = MALFORMED[k]
    got = ttel.validate_chrome_trace(obj)
    assert got == jtel.validate_chrome_trace(obj)
    assert (got == []) == (k == len(MALFORMED) - 1)


# ------------------------------------------------------------- metrics

def _metric_script(mod, seed: int):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    for _ in range(40):
        what = int(rng.integers(3))
        name = ("sched_steals", "sched chunks", "lat-s")[int(rng.integers(3))]
        labels = (None, {"tenant": "a"}, {"tenant": "b", "arm": "GSS/PERCORE"}
                  )[int(rng.integers(3))]
        help_ = "" if rng.random() < 0.5 else "some help"
        v = float(rng.uniform(0.0, 5.0))
        if what == 0:
            reg.counter(name, help_, labels).inc(v)
        elif what == 1:
            reg.gauge(name, help_, labels).set(v)
        else:
            reg.histogram(name, help_, labels).observe(v)
    reg.histogram("empty")
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_registry_equals_reference(seed):
    t, j = _metric_script(ttel, seed), _metric_script(jtel, seed)
    assert t.snapshot() == j.snapshot()
    assert t.to_json() == j.to_json()
    assert t.to_prometheus() == j.to_prometheus()
    json.loads(t.to_json())
    c = t.counter("memo")
    assert t.counter("memo") is c


def _queue_counters():
    return {"depth": 5, "pops": 7, "steals": 2, "failed_steals": 1}


def _server_like():
    jobs = {"a": SimpleNamespace(latency_s=0.25), "b": SimpleNamespace(latency_s=1.5),
            "c": SimpleNamespace(latency_s=None)}
    pre = [SimpleNamespace(kind="preempt"), SimpleNamespace(kind="resume"),
           SimpleNamespace(kind="preempt")]
    return SimpleNamespace(steals=3, events=list(range(17)), jobs=jobs,
                           tenant_service_s={"t1": 0.5, "t2": 2.0},
                           preemptions=pre)


def _openloop_like():
    members = {"m1": SimpleNamespace(admitted=True, latency_s=0.1),
               "m2": SimpleNamespace(admitted=False, latency_s=None),
               "m3": SimpleNamespace(admitted=True, latency_s=0.4)}
    return SimpleNamespace(n_admitted=2, n_shed=1, shed_reasons={"rate": 1},
                           n_batches=2, n_coalesced=3, n_chunks=40,
                           pool_timeline=[(0.0, 2), (1.0, 4)], members=members,
                           preemptions=[SimpleNamespace(kind="preempt")])


@pytest.mark.parametrize("which", ["queue", "server", "openloop", "bandit"])
def test_collectors_equal_reference(which):
    regs = []
    for tel, online in ((ttel, tonline), (jtel, jonline)):
        reg = tel.MetricsRegistry()
        if which == "queue":
            tel.collect_queue_metrics(reg, _queue_counters(), {"impl": "slot"})
            tel.collect_queue_metrics(reg, _queue_counters())
        elif which == "server":
            tel.collect_server_metrics(reg, _server_like())
        elif which == "openloop":
            tel.collect_openloop_metrics(reg, _openloop_like())
        else:
            sched = online.OnlineScheduler(selector="ucb", resize=False, seed=3)
            for k in range(30):
                stage = ("s0", "s1")[k % 2]
                ch = sched.suggest(stage)
                sched.observe(ch, 1.0 + 0.1 * (k % 7))
            tel.collect_bandit_metrics(reg, sched)
        regs.append(reg)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].to_prometheus() == regs[1].to_prometheus()


def test_collect_cache_metrics_reads_both_caches():
    dag = tdag.PipelineDAG([tdag.Stage("a", 64, lambda i, s, z: None)])
    tsched.clear_dag_table_cache()
    twalk.clear_device_table_cache()
    tsched.build_dag_tables_cached(dag, 1, "GSS", n_workers=2)
    tsched.build_dag_tables_cached(dag, 1, "GSS", n_workers=2)
    reg = ttel.MetricsRegistry()
    ttel.collect_cache_metrics(reg)
    snap = reg.snapshot()
    assert snap["counters"]["sched_lowering_cache_hits"] == 1
    assert snap["counters"]["sched_lowering_cache_misses"] == 1
    assert snap["gauges"]["sched_lowering_cache_hit_rate"] == 0.5
    assert snap["counters"]["sched_device_table_cache_hits"] == 0
    assert snap["gauges"]["sched_device_table_cache_hit_rate"] == 0.0


# --------------------------------------------------------- critical path

def _report(rep):
    return (rep.makespan, rep.exec_s, rep.queue_wait_s, rep.transfer_s,
            rep.sched_overhead_s,
            [tuple(vars(s).values()) for s in rep.path])


@pytest.mark.parametrize("makespan", [None, 2.5])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_critical_path_equals_reference(seed, makespan):
    rows = _raw_rows(seed, n=80)
    for origin in (0.0, -0.1):
        got = ttel.analyze_critical_path(_fill(ttel, rows, "extend"), makespan,
                                         t_origin=origin)
        want = jtel.analyze_critical_path(_fill(jtel, rows, "extend"), makespan,
                                          t_origin=origin)
        assert _report(got) == _report(want)
        assert got.breakdown == want.breakdown
        assert got.describe() == want.describe()


def test_critical_path_synthetic_and_empty():
    rep = ttel.analyze_critical_path(ttel.Tracer(), makespan=1.0)
    assert rep.sched_overhead_s == {"_idle": 1.0} and rep.total == 1.0
    t = ttel.Tracer(job="synth")
    t.record_raw("exec", "synth", "a", 0, 0, 0.0, 1.0)
    t.record_raw("exec", "synth", "b", 0, 0, 2.0, 3.0, 0, 0.6)
    t.record_raw("transfer", "synth", "b", 1, 0, 3.0, 3.5)
    rep = ttel.analyze_critical_path(t, makespan=4.0)
    b = rep.breakdown
    assert b["exec"] == pytest.approx(2.0)
    assert b["transfer"] == pytest.approx(0.5)
    assert b["queue_wait"] == pytest.approx(0.6)
    assert b["sched_overhead"] == pytest.approx(0.9)
    assert rep.total == pytest.approx(4.0)


def test_critical_path_reconciles_with_dag_stats():
    """On a real pool the report telescopes to the measured makespan and
    puts no stage on the path longer than DagStats says it ran: both
    hold by construction, whatever the threads did."""
    stages = [tdag.Stage("s0", 64, lambda i, s, z: np.arange(s, s + z),
                         combine="concat"),
              tdag.Stage("s1", 64, lambda i, s, z: i["s0"][s:s + z] * 2,
                         combine="concat",
                         deps=(tdag.StageDep("s0", "elementwise"),)),
              tdag.Stage("s2", 64, lambda i, s, z: i["s1"][:1] + np.arange(z),
                         combine="concat", deps=(tdag.StageDep("s1", "full"),))]
    tracer = ttel.Tracer(job="cp")
    res = tdag.PipelineExecutor(
        tdag.PipelineDAG(stages),
        texec.SchedulerConfig(technique="GSS", queue_layout="PERCORE",
                              n_workers=4), tracer=tracer).run()
    rep = ttel.analyze_critical_path(tracer, makespan=res.wall_time_s)
    rep.reconcile(res.stats, res.wall_time_s, rel_tol=0.05, abs_tol=1e-6)
    assert rep.path and rep.breakdown["exec"] > 0
    bad = dict(res.stats.exec_s)
    bad[next(iter(rep.exec_s))] = 0.0
    with pytest.raises(ValueError, match="exceeds DagStats"):
        rep.reconcile(SimpleNamespace(exec_s=bad, transfer_s={}),
                      res.wall_time_s)


# ---------------------------------------------------- device-walk spans

def test_device_walk_spans_scripted_equals_reference():
    stamps = np.array([[0, 0, 8, 0], [0, 8, 8, 1], [1, 0, 16, 2],
                       [1, 0, 0, 3]], dtype=np.int32)   # last row: padding
    costs = {"a": np.linspace(1.0, 2.0, 16), "b": np.ones(16)}
    for kw in ({}, {"row_costs": costs}, {"row_costs": costs, "h_local": 0.5,
                                           "t0": 3.0, "lane": 7, "job": "d"}):
        t, j = ttel.Tracer(job="dev"), jtel.Tracer(job="dev")
        n = tsched.device_walk_spans(stamps, ["a", "b"], t, **kw)
        assert n == jsched.device_walk_spans(stamps, ["a", "b"], j, **kw) == 3
        assert t.to_chrome_trace() == j.to_chrome_trace()
        assert all(s.device for s in t.spans() if s.kind == "exec")
    assert tsched.device_walk_spans(stamps, ["a", "b"], ttel.NULL_TRACER) == 0
    assert tsched.device_walk_spans(stamps, ["a", "b"], None) == 0


@pytest.mark.parametrize("pipe", ["linreg", "recommendation"])
def test_device_walk_spans_from_walks_equal_reference(pipe):
    """The port's plain walk and the reference's Pallas walk (interpret)
    stamp the same slots, which fold into the same device spans."""
    if pipe == "linreg":
        tl = tapps.linreg_device_lowering(256, 6, tile=32, seed=2, device="cpu")
        jl = japps.linreg_device_lowering(256, 6, tile=32, seed=2)
    else:
        tl = tapps.recommendation_device_lowering(128, 16, tile=32, seed=3,
                                                  device="cpu")
        jl = japps.recommendation_device_lowering(128, 16, tile=32, seed=3)
    ddt = tsched.build_dag_tables(tl.dag, 1, "GSS", n_shards=1, n_workers=2)
    rows = ddt.tables[0].copy()
    rows[:, 1:] *= tl.tile
    _, tst = twalk.dag_walk(tl.stages, tl.operands, tl.values, rows, tl.tile,
                            stamp=True)
    _, jst = jwalk.dag_walk(jl.stages, jl.operands, jl.values, rows, jl.tile,
                            stamp=True)
    jst = np.asarray(jst)
    assert np.array_equal(tst, jst)
    names = [s.name for s in tl.stages]
    n_rows = {s.name: s.n_rows for s in tl.stages}
    costs = {n: np.full(n_rows[n], 1e-6 * (k + 1)) for k, n in enumerate(names)}
    t, j = ttel.Tracer(job="walk"), jtel.Tracer(job="walk")
    n = tsched.device_walk_spans(tst, names, t, lane=9, row_costs=costs)
    assert n == jsched.device_walk_spans(jst, names, j, lane=9, row_costs=costs)
    assert n == int((rows[:, 2] > 0).sum())
    assert t.to_chrome_trace() == j.to_chrome_trace()
    rep = ttel.analyze_critical_path(t)
    assert rep.total == pytest.approx(sum(s.dur for s in t.spans()
                                          if s.kind == "exec"), rel=1e-12)
    assert _report(rep) == _report(jtel.analyze_critical_path(j))
