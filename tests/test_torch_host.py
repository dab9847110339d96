"""The port's host executor stack against the JAX package's.

Tasks, victim orders, queues, the threaded executors, the online feedback
loop, telemetry and the submission record are numpy and threads in both
packages, so with one worker every schedule, pop sequence and task order
must be identical, and with several workers every task must still run
exactly once. ``PipelineExecutor`` runs the pipelines' host DAGs (tile
units): the chunk schedules and event order must match the reference's,
and float sums agree to a relative 1e-5 (``FLOAT_RTOL``: PyTorch and XLA
sum a tile's rows in different orders); concat and int32 stages match
exactly.
"""

import threading

import numpy as np
import pytest
import torch

from repro.core import dag as jdag
from repro.core import executor as jexec
from repro.core import online as jonline
from repro.core import queues as jqueues
from repro.core import task as jtask
from repro.core import telemetry as jtel
from repro.core import victim as jvictim
from repro.vee import apps as japps
from repro_torch.core import dag as tdag
from repro_torch.core import executor as texec
from repro_torch.core import online as tonline
from repro_torch.core import queues as tqueues
from repro_torch.core import submit as tsubmit
from repro_torch.core import task as ttask
from repro_torch.core import telemetry as ttel
from repro_torch.core import victim as tvictim
from repro_torch.core.partitioners import PARTITIONERS
from repro_torch.vee import apps as tapps

TECHS = sorted(PARTITIONERS)
LAYOUTS = ["CENTRALIZED", "PERCORE", "PERGROUP"]
FLOAT_RTOL = 1e-5


def _op(s, z):
    return s * 1000 + z


def _run_flat(pkg_exec, pkg_task, cfg, n):
    order = []
    ex = pkg_exec.ScheduledExecutor(cfg, observer=lambda o: order.append(o.task_id))
    tasks = [pkg_task.RangeTask(i, i, 1, _op) for i in range(n)]
    results, stats = ex.run(tasks)
    return order, results, stats


@pytest.mark.parametrize("impl", ["slot", "deque"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tech", TECHS)
def test_scheduled_executor_one_worker_matches_reference(tech, layout, impl):
    kw = dict(technique=tech, queue_layout=layout, victim_strategy="SEQ",
              n_workers=1, seed=3, queue_impl=impl)
    want = _run_flat(jexec, jtask, jexec.SchedulerConfig(**kw), 97)
    got = _run_flat(texec, ttask, texec.SchedulerConfig(**kw), 97)
    assert got[0] == want[0]
    assert got[1] == want[1]
    for k in ("per_worker_tasks", "steals", "failed_steals", "queue_pops"):
        assert getattr(got[2], k) == getattr(want[2], k), k


@pytest.mark.parametrize("impl", ["slot", "deque"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tech", ["STATIC", "SS", "GSS", "FAC2", "PSS"])
def test_scheduled_executor_four_workers_exactly_once(tech, layout, impl):
    cfg = texec.SchedulerConfig(technique=tech, queue_layout=layout,
                                victim_strategy="RND", n_workers=4,
                                numa_domains=(0, 0, 1, 1), seed=1,
                                queue_impl=impl)
    order, results, stats = _run_flat(texec, ttask, cfg, 301)
    assert sorted(order) == list(range(301))
    assert results == {i: _op(i, 1) for i in range(301)}
    assert sum(stats.per_worker_tasks) == 301


def test_scheduler_config_rejects_unknown_queue_impl():
    with pytest.raises(ValueError, match="queue_impl"):
        texec.SchedulerConfig(queue_impl="ring")


@pytest.mark.parametrize("strategy", sorted(jvictim.VICTIM_STRATEGIES))
def test_victim_candidates_match_reference(strategy):
    domains = [0, 0, 1, 1, 2, 2]
    j = jvictim.make_victim_selector(strategy, 6, numa_domains=domains, seed=4)
    t = tvictim.make_victim_selector(strategy, 6, numa_domains=domains, seed=4)
    for thief in [0, 3, 5, 1, 1, 4, 2, 0]:
        assert t.candidates(thief) == j.candidates(thief)
    with pytest.raises(ValueError, match="unknown victim strategy"):
        tvictim.make_victim_selector("NEAREST", 2)


def _queue_trace(pkg_q, pkg_task, cls, tech, layout, n, p):
    tasks = [pkg_task.RangeTask(i, i, 1, None) for i in range(n)]
    q = getattr(pkg_q, cls)(tasks, tech, p, layout=layout,
                            groups=[w % 2 for w in range(p)], seed=2)
    trace = []
    rng = np.random.default_rng(0)
    while len(q):
        w = int(rng.integers(p))
        got = q.pop_local(w)
        if not got:
            got = q.steal(w, int(rng.integers(q.n_queues)))
            q.push_local(w, got)
        trace.append([t.task_id for t in got])
    return trace, q.counters()


@pytest.mark.parametrize("cls", ["DistributedQueues", "SlotDistributedQueues"])
@pytest.mark.parametrize("layout", ["PERCORE", "PERGROUP"])
@pytest.mark.parametrize("tech", ["STATIC", "GSS", "TSS", "FISS", "PLS"])
def test_distributed_queues_match_reference(tech, layout, cls):
    want = _queue_trace(jqueues, jtask, cls, tech, layout, 211, 4)
    got = _queue_trace(tqueues, ttask, cls, tech, layout, 211, 4)
    assert got == want


@pytest.mark.parametrize("tech", TECHS)
def test_centralized_queues_match_reference(tech):
    from repro.core.partitioners import make_partitioner as jmake
    from repro_torch.core.partitioners import make_partitioner as tmake

    def pops(q):
        out = []
        while True:
            c = [t.task_id for t in q.pop(0)]
            if not c:
                return out, q.counters()
            out.append(c)

    jt = [jtask.RangeTask(i, i, 1, None) for i in range(150)]
    tt = [ttask.RangeTask(i, i, 1, None) for i in range(150)]
    want = pops(jqueues.CentralizedQueue(jt, jmake(tech, 150, 6, seed=1)))
    assert pops(tqueues.CentralizedQueue(tt, tmake(tech, 150, 6, seed=1))) == want
    assert pops(tqueues.SlotCentralizedQueue(tt, tech, 6, seed=1)) == want
    assert tqueues.QUEUE_LAYOUTS == jqueues.QUEUE_LAYOUTS
    assert tqueues.QUEUE_IMPLS == jqueues.QUEUE_IMPLS


def test_tasks_from_schedule_matches_reference():
    sched = np.array([[0, 3], [3, 5], [8, 1]])
    cost = lambda s, z: 2.0 * z  # noqa: E731
    want = jtask.tasks_from_schedule(sched, _op, cost)
    got = ttask.tasks_from_schedule(sched, _op, cost)
    assert [(t.task_id, t.start, t.size, t.cost_hint, t.run()) for t in got] \
        == [(t.task_id, t.start, t.size, t.cost_hint, t.run()) for t in want]


@pytest.mark.parametrize("pending,target", [
    ([(0, 10)], 3), ([(5, 2), (0, 5), (20, 7)], 4), ([(3, 1), (9, 9), (4, 5)], 1),
    ([], 5), ([(0, 100), (100, 1)], 64)])
def test_rechunk_pending_matches_reference(pending, target):
    assert tonline.rechunk_pending(pending, target) \
        == jonline.rechunk_pending(pending, target)


@pytest.mark.parametrize("selector", ["ucb", "exp3"])
def test_online_scheduler_matches_reference(selector):
    arms = tonline.default_online_arms(include_ss=False)
    assert arms == jonline.default_online_arms(include_ss=False)
    j = jonline.OnlineScheduler(selector, arms=arms, seed=7, min_observe=2)
    t = tonline.OnlineScheduler(selector, arms=arms, seed=7, min_observe=2)
    rng = np.random.default_rng(1)
    for _ in range(40):
        cj, ct = j.suggest("s"), t.suggest("s")
        assert (ct.arm, ct.combo, ct.prob) == (cj.arm, cj.combo, cj.prob)
        cost = float(rng.uniform(1, 2)) * (1 + ct.arm % 5)
        j.observe(cj, cost)
        t.observe(ct, cost)
    assert t.best_combos(["s"]) == j.best_combos(["s"])
    # moldable resizing: the same skewed feedback gives the same plan
    for k in range(12):
        z, c = 4, float(rng.pareto(1.0)) + 1e-4
        j.record_raw("r", z, c)
        t.record_raw("r", z, c)
    pending = [(s, 16) for s in range(0, 320, 16)]
    assert t.may_resize("r") == j.may_resize("r")
    assert t.plan_resize("r", pending, 4) == j.plan_resize("r", pending, 4)
    assert t.resizes == j.resizes
    fb_t, fb_j = t.feedback.stage("r"), j.feedback.stage("r")
    assert (fb_t.n, fb_t.rows, fb_t.cv) == (fb_j.n, fb_j.rows, fb_j.cv)


def test_tracer_spans_match_reference():
    rows = [("exec", "job", "a", 0, 0, 0.0, 1.0, 0, 0.25, ""),
            ("exec", "job", "b", 1, 1, 0.5, 2.0, ttel.F_STOLEN, 0.0, ""),
            ("resize", "job", "a", -1, -1, 1.5, 1.5, 0, 0.0, "chunks=2")]
    j, t = jtel.Tracer(), ttel.Tracer()
    for r in rows:
        j.record_raw(*r)
        t.record_raw(*r)
    t.mark("migrate", 3.0, detail="to_device")
    j.mark("migrate", 3.0, detail="to_device")
    assert [tuple(vars(s).values()) for s in t.spans()] \
        == [tuple(vars(s).values()) for s in j.spans()]
    assert ttel.as_tracer(None) is ttel.NULL_TRACER and not ttel.NULL_TRACER.enabled
    ttel.NULL_TRACER.record_raw(*rows[0])
    assert len(ttel.NULL_TRACER) == 0
    assert (ttel.WORK_KINDS, ttel.F_STOLEN, ttel.F_DEVICE) \
        == (jtel.WORK_KINDS, jtel.F_STOLEN, jtel.F_DEVICE)


def test_submission_surface():
    sub = tsubmit.Submission(name="a", weight=2.0)
    assert tsubmit.as_submission(sub) is sub
    assert sub.replace(name="b").name == "b"
    with pytest.raises(TypeError, match="expected Submission or Job"):
        tsubmit.as_submission(object())
    with pytest.raises(ValueError, match="weight"):
        tsubmit.Submission(weight=0)
    with pytest.raises(ValueError, match="deadline_s"):
        tsubmit.Submission(deadline_s=-1.0)


def _pipelines():
    return {
        "linreg": (japps.linreg_device_lowering(256, 9, tile=64),
                   tapps.linreg_device_lowering(256, 9, tile=64, device="cpu")),
        "recommendation": (
            japps.recommendation_device_lowering(128, 192, tile=64),
            tapps.recommendation_device_lowering(128, 192, tile=64, device="cpu")),
    }


@pytest.mark.parametrize("which", ["linreg", "recommendation"])
def test_pipeline_executor_matches_reference(which):
    jlow, tlow = _pipelines()[which]
    kw = dict(technique="SS", queue_layout="CENTRALIZED", n_workers=1)
    want = jdag.PipelineExecutor(jlow.dag, jexec.SchedulerConfig(**kw)).run()
    got = tdag.PipelineExecutor(tlow.dag, texec.SchedulerConfig(**kw)).run()
    assert [(e.stage, e.task_id, e.start, e.size, e.worker) for e in got.events] \
        == [(e.stage, e.task_id, e.start, e.size, e.worker) for e in want.events]
    for name in tlow.dag.order:
        assert np.array_equal(got.stages[name].schedule, want.stages[name].schedule)
        g, w = got.values[name], np.asarray(want.values[name])
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), name
        else:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL,
                                       atol=FLOAT_RTOL * np.abs(w).max())
    assert got.steals == want.steals == 0


@pytest.mark.parametrize("which", ["linreg", "recommendation"])
def test_pipeline_executor_equals_port_walker(which):
    """SS on one worker folds tiles in ascending order from the first: the
    plain walker's association, so the host pool is bit-equal to it."""
    _, tlow = _pipelines()[which]
    cfg = texec.SchedulerConfig(technique="SS", queue_layout="CENTRALIZED",
                                n_workers=1)
    host = tdag.PipelineExecutor(tlow.dag, cfg).run()
    walked, _ = tapps.run_device_dag(tlow, "SS")
    for ws in tlow.stages:
        v = host.values[ws.name]
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
        assert torch.equal(v.reshape(ws.out_shape), walked[ws.name]), ws.name


def _int_dag(n):
    a = tdag.Stage("a", n, lambda i, s, z: np.arange(s, s + z) * 3 + 1,
                   combine="concat")
    b = tdag.Stage("b", n, lambda i, s, z: i["a"][s:s + z] + 7, combine="concat",
                   deps=(tdag.StageDep("a", "elementwise"),))
    c = tdag.Stage("c", n, lambda i, s, z: int(i["a"][s:s + z].sum()),
                   combine="sum", deps=(tdag.StageDep("a", "full"),))
    d = tdag.Stage("d", n, lambda i, s, z: int(i["b"][s:s + z].sum()) + i["c"],
                   combine="sum", deps=(tdag.StageDep("b", "elementwise"),
                                        tdag.StageDep("c", "full")))
    return tdag.PipelineDAG([a, b, c, d])


@pytest.mark.parametrize("impl", ["slot", "deque"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tech", ["STATIC", "SS", "GSS", "FAC2"])
def test_pipeline_executor_multi_worker_exact(tech, layout, impl):
    n = 150
    cfg = texec.SchedulerConfig(technique=tech, queue_layout=layout,
                                victim_strategy="SEQPRI", n_workers=4,
                                numa_domains=(0, 0, 1, 1), queue_impl=impl)
    res = tdag.PipelineExecutor(_int_dag(n), cfg).run()
    a = np.arange(n) * 3 + 1
    assert np.array_equal(res.values["a"], a)
    assert np.array_equal(res.values["b"], a + 7)
    assert res.values["c"] == a.sum()
    per_task = {}
    for e in res.events:
        per_task.setdefault(e.stage, []).append((e.start, e.size))
    for name in "abcd":  # every row of every stage ran exactly once
        rows = sorted(r for s, z in per_task[name] for r in range(s, s + z))
        assert rows == list(range(n)), name
    cz = [z for _, z in per_task["c"]]
    assert res.values["d"] == (a + 7).sum() + len(cz) * a.sum()


def test_pipeline_executor_online_and_overrides():
    dag = _int_dag(64)
    online = tonline.OnlineScheduler("ucb", seed=0)
    ex = tdag.PipelineExecutor(dag, texec.SchedulerConfig(n_workers=2))
    first = ex.run(tsubmit.Submission(online=online))
    pinned = ex.run(tsubmit.Submission(
        per_stage={"a": ("GSS", "PERCORE", "SEQ")}, online=online))
    assert pinned.stages["a"].config.technique == "GSS"
    assert np.array_equal(first.values["b"], pinned.values["b"])
    assert sum(online.selector_for(n).counts.sum() for n in "abcd") == 7
    with pytest.raises(TypeError):
        ex.run(object())


def test_pipeline_executor_op_error_propagates():
    def boom(inputs, s, z):
        raise RuntimeError("op failed")

    dag = tdag.PipelineDAG([tdag.Stage("a", 8, boom)])
    with pytest.raises(RuntimeError, match="op failed"):
        tdag.PipelineExecutor(dag, texec.SchedulerConfig(n_workers=2)).run()


def test_null_event_log_and_tracer_record():
    dag = _int_dag(16)
    tracer = ttel.Tracer()
    cfg = texec.SchedulerConfig(technique="GSS", n_workers=2)
    res = tdag.PipelineExecutor(dag, cfg, record_events=False, tracer=tracer).run()
    assert len(res.events) == 0 and not res.events
    execs = [s for s in tracer.spans() if s.kind == "exec"]
    assert len(execs) == sum(len(r.schedule) for r in res.stages.values())
    assert {s.stage for s in tracer.spans() if s.kind == "stage"} == set("abcd")


def test_scheduled_executor_stress_many_workers():
    """More threads than cores with a short switch interval: a lost update
    in the queue cursors would drop or duplicate a task."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for impl in ("slot", "deque"):
            cfg = texec.SchedulerConfig(technique="SS", queue_layout="PERCORE",
                                        victim_strategy="RND", n_workers=16,
                                        queue_impl=impl)
            seen = []
            lock = threading.Lock()

            def op(s, z):
                with lock:
                    seen.append(s)
                return s

            tasks = [ttask.RangeTask(i, i, 1, op) for i in range(2000)]
            results, _ = texec.ScheduledExecutor(cfg).run(tasks)
            assert sorted(seen) == list(range(2000))
            assert results == {i: i for i in range(2000)}
    finally:
        sys.setswitchinterval(old)
