"""The port's placement solver and co-execution against the JAX package's.

``calibrate_hetero_costs``, ``simulate_hetero_dag`` and ``select_placement``
run in virtual time on numpy in both packages, so their results must be
identical to the bit on the same inputs. The device-shard helpers
(``split_device_tasks``, ``pop_device_task``, ``steal_device_tail``) are
driven by a script on both packages' stage runs and must leave the same
queues. ``HeteroExecutor`` runs real threads: its values are held bitwise
to the host-only one-worker SS run, which its ascending sum fold makes
exact whatever the threads do; no test reads an absorption count or a
latency, which the threads decide. ``linear_regression_hetero`` and
``recommendation_hetero`` are held to the reference's: the placement
and the int32 top items bitwise, float reductions (sums, ``user_bias``'s
row mean) within ``SUM_RTOL``, beta within 1e-6, as
``tests/test_torch_apps.py`` holds the walker's.
"""

import numpy as np
import pytest
import torch

from repro.core import dag as jdag
from repro.core import executor as jexec
from repro.core import hetero as jhet
from repro.core import online as jonline
from repro.core import placement as jpl
from repro.vee import apps as japps
from repro_torch.core import dag as tdag
from repro_torch.core import executor as texec
from repro_torch.core import hetero as thet
from repro_torch.core import online as tonline
from repro_torch.core import placement as tpl
from repro_torch.core import preempt as tpre
from repro_torch.core import telemetry as ttel
from repro_torch.vee import apps as tapps

# a float reduction of the port's host path against the reference's, of
# the stage's largest |entry|: the bar tests/test_torch_apps.py holds the
# walker's sums to, above the drift the reference shows between its own
# host and device sums (ROADMAP C: 3.8e-6 on entries near 10)
SUM_RTOL = 1e-5


def _noop(inputs, s, z):
    return None


def _dags(spec, n):
    """The same DAG in both packages. ``spec``: (name, combine, deps)."""
    return [pkg.PipelineDAG([
        pkg.Stage(name, n, _noop, combine=comb,
                  deps=tuple(pkg.StageDep(p, k) for p, k in deps))
        for name, comb, deps in spec]) for pkg in (jdag, tdag)]


LINREG_LIKE = [("moments", "sum", ()),
               ("syrk", "sum", (("moments", "full"),))]
REC_LIKE = [("norms", "sum", ()), ("bias", "concat", ()),
            ("scores", "concat", (("norms", "full"), ("bias", "elementwise")))]


def _costs(names, n, seed):
    rng = np.random.default_rng(seed)
    return ({k: rng.uniform(1e-7, 5e-6, n) for k in names},
            {k: rng.uniform(1e-8, 2e-6, n) for k in names})


def _cost_models(names, n, seed, **transfer):
    host, dev = _costs(names, n, seed)
    return [pkg.HeteroCostModel(host=host, device=dev,
                                transfer=pkg.TransferModel(**transfer))
            for pkg in (jpl, tpl)]


def _placements(pkg, names):
    P, SP = pkg.Placement, pkg.StagePlacement
    out = [P.all_host(names), P.all_device(names),
           P({n: SP(pkg.SPLIT, 0.25 + 0.25 * (k % 3)) for k, n in enumerate(names)}),
           P({n: SP(pkg.DEVICE if k % 2 else pkg.HOST) for k, n in enumerate(names)})]
    return out


def _sim(res):
    st = res.stats
    return (res.makespan, res.per_worker_busy, res.stage_start, res.stage_finish,
            res.queue_wait, res.transfer_s,
            [tuple(vars(e).values()) for e in res.transfer_events],
            st.exec_s, st.queue_wait_s, st.transfer_s, st.chunks, st.transfers,
            res.placement.describe())


# ------------------------------------------------------ the cost model

def test_stage_placement_and_transfer_model():
    for pkg in (jpl, tpl):
        with pytest.raises(ValueError):
            pkg.StagePlacement("gpu")
        with pytest.raises(ValueError):
            pkg.StagePlacement(pkg.SPLIT, 1.0)
    for frac in (0.01, 0.3, 0.99):
        for n in (2, 7, 100):
            assert (tpl.StagePlacement(tpl.SPLIT, frac).device_rows(n)
                    == jpl.StagePlacement(jpl.SPLIT, frac).device_rows(n))
    tm, jm = (pkg.TransferModel(bytes_per_row={"a": 64.0}) for pkg in (tpl, jpl))
    for stage, rows in (("a", 10), ("b", 10), ("a", 0)):
        assert tm.seconds(stage, rows) == jm.seconds(stage, rows)
    pl = tpl.Placement({"a": tpl.StagePlacement(tpl.SPLIT, 0.5)})
    assert repr(pl) == repr(jpl.Placement({"a": jpl.StagePlacement(jpl.SPLIT, 0.5)}))
    assert pl.get("zz").substrate == tpl.HOST


@pytest.mark.parametrize("case", ["feedback", "speedup", "per_stage", "explicit",
                                  "odd_tile"])
def test_calibrate_hetero_costs_bitwise(case):
    jd, td = _dags(LINREG_LIKE, 96)
    out = []
    for pkg_pl, pkg_on, dag in ((jpl, jonline, jd), (tpl, tonline, td)):
        kw = dict(tile=8)
        if case == "feedback":
            fb = pkg_on.FeedbackLog()
            for i in range(12):
                fb.record(pkg_on.ChunkObservation("moments", i, i * 8, 8,
                                                  8 * (2e-6 + 1e-7 * i)))
            kw.update(feedback=fb, device_speedup=4.0)
        elif case == "speedup":
            kw.update(host_costs={"moments": np.full(96, 3e-6),
                                  "syrk": np.linspace(1e-6, 9e-6, 96)},
                      device_speedup=8.0)
        elif case == "per_stage":
            kw.update(device_speedup={"moments": 2.0, "syrk": 16.0})
        elif case == "explicit":
            kw.update(host_costs={"moments": np.full(96, 7.0)},
                      device_costs={"syrk": np.full(96, 9.0)},
                      transfer=pkg_pl.TransferModel(latency_s=1e-4))
        else:
            kw.update(tile=7)
        out.append(pkg_pl.calibrate_hetero_costs(dag, **kw))
    j, t = out
    for side in ("host", "device"):
        assert set(getattr(t, side)) == set(getattr(j, side))
        for k in getattr(j, side):
            assert np.array_equal(getattr(t, side)[k], getattr(j, side)[k]), (side, k)
    assert t.transfer.seconds("moments", 100) == j.transfer.seconds("moments", 100)


# --------------------------------------------------- virtual co-execution

@pytest.mark.parametrize("spec", [LINREG_LIKE, REC_LIKE], ids=["linreg", "rec"])
@pytest.mark.parametrize("cfg", [None, ("SS", "CENTRALIZED", "SEQ"),
                                 ("GSS", "PERCORE", "SEQ")],
                         ids=["default", "ss", "gss"])
@pytest.mark.parametrize("workers", [1, 4])
def test_simulate_hetero_dag_bitwise(spec, cfg, workers):
    n = 128
    jd, td = _dags(spec, n)
    jc, tc = _cost_models(jd.stage_names, n, seed=5, latency_s=1e-6,
                          bytes_per_row=32.0)
    for jp, tp in zip(_placements(jpl, jd.stage_names),
                      _placements(tpl, td.stage_names)):
        want = jpl.simulate_hetero_dag(jd, jc, jp, stage_configs=cfg,
                                       n_workers=workers, seed=1)
        got = tpl.simulate_hetero_dag(td, tc, tp, stage_configs=cfg,
                                      n_workers=workers, seed=1)
        assert _sim(got) == _sim(want)
        for a, b in zip(td.stage_names, td.stage_names[1:]):
            assert got.overlap_s(a, b) == want.overlap_s(a, b)


def test_simulate_hetero_dag_plain_costs_and_affinity():
    jd, jc = japps.hetero_affinity_dag(512)
    td, tc = tapps.hetero_affinity_dag(512)
    assert td.stage_names == jd.stage_names
    for jp, tp in zip(_placements(jpl, jd.stage_names),
                      _placements(tpl, td.stage_names)):
        assert (_sim(tpl.simulate_hetero_dag(td, tc, tp, n_workers=8))
                == _sim(jpl.simulate_hetero_dag(jd, jc, jp, n_workers=8)))
        plain = {k: v for k, v in tc.host.items()}
        assert (_sim(tpl.simulate_hetero_dag(td, plain, tp, n_workers=3))
                == _sim(jpl.simulate_hetero_dag(jd, plain, jp, n_workers=3)))


@pytest.mark.parametrize("which", ["affinity", "linreg", "rec"])
def test_select_placement_bitwise(which):
    if which == "affinity":
        (jd, jc), (td, tc) = japps.hetero_affinity_dag(1024), tapps.hetero_affinity_dag(1024)
    else:
        jd, td = _dags(LINREG_LIKE if which == "linreg" else REC_LIKE, 256)
        jc, tc = _cost_models(jd.stage_names, 256, seed=7)
    for kw in (dict(n_workers=8), dict(n_workers=4, passes=1,
                                       fractions=(0.5,), seed=2)):
        jp, jm, jb = jpl.select_placement(jd, jc, **kw)
        tp, tm, tb = tpl.select_placement(td, tc, **kw)
        assert (tp.describe(), tm, tb) == (jp.describe(), jm, jb)
        assert tm <= min(tb.values())
    if which == "affinity":
        assert {tp[n].substrate for n in td.stage_names} == {tpl.HOST, tpl.DEVICE}


def test_replay_online_hetero_on_the_affinity_dag():
    """The substrate bandit's replay over the mixed-affinity DAG and its own
    cost model: the same rounds as the reference's, to the bit."""
    out = []
    for apps, online, pl in ((tapps, tonline, tpl), (japps, jonline, jpl)):
        dag, costs = apps.hetero_affinity_dag(512)
        sched = online.OnlineScheduler(arms=online.default_hetero_arms(),
                                       resize=False, seed=3)
        hist = pl.replay_online_hetero(dag, costs, sched, rounds=24, n_workers=8)
        out.append(([tuple(vars(r).values()) for r in hist],
                    sched.best_combos(list(dag.stage_names))))
    assert out[0] == out[1]


def test_default_hetero_arms_equal_reference():
    for ss in (True, False):
        assert tonline.default_hetero_arms(ss) == jonline.default_hetero_arms(ss)


# ------------------------------------------------ device-shard helpers

def _runs(pkg_dag, pkg_exec, combine, n=40, technique="GSS", layout="CENTRALIZED"):
    cfg = pkg_exec.SchedulerConfig(technique=technique, queue_layout=layout,
                                   n_workers=3)
    src = pkg_dag.Stage("src", n, _noop, combine="concat")
    st = pkg_dag.Stage("st", n, _noop, combine=combine,
                       deps=(pkg_dag.StageDep("src", "elementwise"),))
    runs = {s.name: pkg_dag._StageRun(s, cfg, [0, 0, 0]) for s in (src, st)}
    return runs


def _state(sr, shards):
    return ([list(q) for q in sr.queues], [list(d) for d in shards],
            np.asarray(sr.schedule).tolist(), sr.remaining, sr.resizes,
            len(sr.costs), int(sr.executed.sum()))


@pytest.mark.parametrize("combine", ["concat", "sum"])
@pytest.mark.parametrize("k,n_device", [(0, 1), (17, 1), (17, 2), (40, 3),
                                        (23, 2)])
def test_device_shard_helpers_scripted(combine, k, n_device):
    """Split, pop and steal on both packages' stage runs, in one scripted
    order, with the producer's rows marked done in two steps."""
    states = []
    for pkg_dag, pkg_exec, het in ((jdag, jexec, jhet), (tdag, texec, thet)):
        runs = _runs(pkg_dag, pkg_exec, combine)
        sr = runs["st"]
        shards, delta = het.split_device_tasks(sr, k, n_device)
        log = [delta, _state(sr, shards)]
        runs["src"].row_done[:20] = True
        for step in range(12):
            if step == 6:
                runs["src"].row_done[:] = True
            if step % 3 == 2:
                got, d = het.steal_device_tail(shards, sr, runs)
                log.append(("steal", got, d))
            else:
                log.append(("pop", het.pop_device_task(shards, step % n_device,
                                                       sr, runs)))
            log.append(_state(sr, shards))
        states.append(log)
    assert states[0] == states[1]


# ------------------------------------------------- threaded co-execution

def _host_only(low):
    return tdag.PipelineExecutor(low.dag, texec.SchedulerConfig(
        technique="SS", n_workers=1)).run()


def _bitwise(want, got):
    for k in want.values:
        a, b = want.values[k], got.values[k]
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), k
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


@pytest.mark.parametrize("which", ["all_device", "split", "mixed", "all_host"])
@pytest.mark.parametrize("rebalance", [True, False])
def test_hetero_executor_linreg_bitwise(which, rebalance):
    low = tapps.linreg_device_lowering(1024, 9, tile=64, seed=1, device="cpu")
    names = low.dag.stage_names
    pl = {"all_device": tpl.Placement.all_device(names),
          "all_host": tpl.Placement.all_host(names),
          "split": tpl.Placement({n: tpl.StagePlacement(tpl.SPLIT, 0.5) for n in names}),
          "mixed": tpl.Placement({"moments": tpl.StagePlacement(tpl.DEVICE),
                                  "syrk_gemv": tpl.StagePlacement(tpl.HOST)})}[which]
    het = thet.HeteroExecutor(low.dag, texec.SchedulerConfig(technique="SS",
                                                             n_workers=3),
                              pl, n_device=2, rebalance=rebalance).run()
    _bitwise(_host_only(low), het)
    # every chunk exactly once, per stage
    for n in names:
        rows = sorted((e.start, e.size) for e in het.events if e.stage == n)
        assert sum(z for _, z in rows) == low.dag.stages[n].n_rows
        assert [s for s, _ in rows] == list(np.cumsum([0] + [z for _, z in rows])[:-1])
    assert sum(het.per_worker_tasks) == len(het.events)
    if not rebalance:
        dev_rows = {n: pl.device_rows(n, low.dag.stages[n].n_rows) for n in names}
        for e in het.events:
            assert (e.worker >= 3) == (e.start < dev_rows[e.stage])


@pytest.mark.parametrize("layout", ["CENTRALIZED", "PERCORE", "PERGROUP"])
def test_hetero_executor_recommendation_bitwise(layout):
    low = tapps.recommendation_device_lowering(256, 32, tile=32, seed=0,
                                               device="cpu")
    pl = tpl.Placement({"item_norms": tpl.StagePlacement(tpl.DEVICE),
                        "user_bias": tpl.StagePlacement(tpl.SPLIT, 0.5),
                        "scores": tpl.StagePlacement(tpl.HOST)})
    cfg = texec.SchedulerConfig(technique="SS", queue_layout=layout, n_workers=2,
                                numa_domains=[0, 1])
    het = thet.HeteroExecutor(low.dag, cfg, pl, n_device=2).run()
    _bitwise(_host_only(low), het)
    st = het.stats
    assert st.total_chunks == len(het.events)
    # how many chunks read rows of the other substrate is the threads'
    # choice; each one is one transfer event, folded into the stats
    assert sum(het.cross_consumptions.values()) == len(het.transfer_events)
    assert sum(st.transfers.values()) == len(het.transfer_events)


@pytest.mark.parametrize("cut", [1, 5, 11])
def test_hetero_run_preemptible_resumes_bitwise(cut):
    low = tapps.linreg_device_lowering(768, 9, tile=64, seed=4, device="cpu")
    ss = texec.SchedulerConfig(technique="SS", n_workers=2)
    ex = thet.HeteroExecutor(low.dag, ss, tpl.Placement(
        {n: tpl.StagePlacement(tpl.SPLIT, 0.5) for n in low.dag.stage_names}))
    res, ck = ex.run_preemptible(cut)
    assert res is None and ck is not None and ck.substrate == "hetero"
    fin = tpre.resume_on_host(ck, low.dag, texec.SchedulerConfig(
        technique="SS", n_workers=1))
    _bitwise(_host_only(low), fin)


def test_hetero_executor_surfaces_worker_errors():
    def boom(inputs, s, z):
        raise RuntimeError("stage exploded")

    dag = tdag.PipelineDAG([tdag.Stage("a", 8, boom, combine="concat")])
    with pytest.raises(RuntimeError, match="stage exploded"):
        thet.HeteroExecutor(dag, texec.SchedulerConfig(technique="SS", n_workers=2),
                            tpl.Placement({"a": tpl.StagePlacement(tpl.SPLIT, 0.5)})
                            ).run()


# ------------------------------------------------------ walker lanes
#
# Given the DAG's lowering, a device lane walks a run of its shard's head
# slots in one ``dag_walk`` launch (the plain walker on a CPU lowering).
# The values stay bitwise the host-only run's: a sum run at the fold's
# frontier walks on from the prefix, one tile after another, as the fold
# adds them. Walker calls are counted only with ``rebalance=False``, where
# no host worker can take a device slot first.


def _count_walks(monkeypatch):
    calls = []
    real = thet.dag_walk

    def counted(stages, operands, values, table, tile, **kw):
        calls.append((stages[0].name, len(table)))
        return real(stages, operands, values, table, tile, **kw)

    monkeypatch.setattr(thet, "dag_walk", counted)
    return calls


def _lane_run(combine, n, k, n_device):
    dag = tdag.PipelineDAG([tdag.Stage("a", n, _noop, combine=combine)])
    sr = tpre.PreemptableStageRun(dag.stages["a"], texec.SchedulerConfig(
        technique="SS", n_workers=2), [0, 0])
    shards, _ = thet.split_device_tasks(sr, k, n_device)
    return sr, shards


@pytest.mark.parametrize("combine", ["concat", "sum"])
def test_pop_device_run_takes_half_the_shard_from_its_head(combine):
    sr, shards = _lane_run(combine, 24, 16, 1)
    runs = {"a": sr}
    got = thet.pop_device_run(shards, 0, sr, runs)
    # a sum stage's fold starts at row 0, so both kinds take a run there
    assert [t[1] for t in got] == list(range(8))
    if combine == "sum":
        # the fold has not reached row 8: one task, its partial parked
        (t8,) = thet.pop_device_run(shards, 0, sr, runs)
        assert t8[1] == 8
        sr.record(t8, torch.ones(1), 0.0, 0.0, 0.0)
        assert sr.frontier() == 0
        sr.record_prefix(got, torch.zeros(1), [(0.0, 0.0, 0.0)] * len(got))
        assert sr.frontier() == 9 and torch.equal(sr.prefix(), torch.ones(1))
    else:
        assert [t[1] for t in thet.pop_device_run(shards, 0, sr, runs)] == \
            list(range(8, 12))
    rest = [t[1] for t in thet.pop_device_run(shards, 0, sr, runs, limit=2)]
    assert rest == list(range(9, 11) if combine == "sum" else range(12, 14))


def test_pop_device_run_takes_one_task_from_a_neighbours_shard():
    sr, shards = _lane_run("concat", 24, 16, 2)
    runs = {"a": sr}
    shards[1].clear()
    head = shards[0][0]
    # lane 1's own shard is empty: it helps lane 0 one task at a time
    assert thet.pop_device_run(shards, 1, sr, runs) == [head]
    assert len(shards[0]) == 7
    assert thet.pop_device_run([], 0, sr, runs) == []


def test_record_prefix_refuses_a_run_off_the_frontier():
    sr, _ = _lane_run("sum", 8, 0, 1)
    with pytest.raises(ValueError, match="frontier"):
        sr.record_prefix([(3, 3, 1)], torch.zeros(1), [(0.0, 0.0, 0.0)])


def test_run_spans_share_the_launch_by_rows():
    spans = thet.run_spans([(0, 0, 1), (1, 1, 3)], 1.0, 3.0)
    assert spans == [(0.5, 1.0, 1.5), (1.5, 1.5, 3.0)]


@pytest.mark.parametrize("app", ["linreg", "rec"])
def test_walk_device_run_is_the_host_ops(app):
    """One walk over a run gives each task's host-op rows (concat) and the
    ascending fold of its tiles from the seed (sum), bitwise."""
    low = (tapps.linreg_device_lowering(640, 9, tile=64, seed=3, device="cpu")
           if app == "linreg" else
           tapps.recommendation_device_lowering(320, 24, tile=32, seed=3,
                                                device="cpu"))
    host = _host_only(low)
    tasks = [(0, 2, 1), (1, 3, 2), (2, 5, 1)]
    for name in low.dag.order:
        stage = low.dag.stages[name]
        inputs = {d.producer: host.values[d.producer] for d in stage.deps}
        if stage.combine == "concat":
            got = thet.walk_device_run(low, name, tasks, inputs)
            for (_, s, z), v in zip(tasks, got):
                assert torch.equal(v, stage.op(inputs, s, z)), name
            continue
        seed = stage.op(inputs, 0, 2)
        (got,) = thet.walk_device_run(low, name, tasks, inputs, seed=seed)
        want = seed
        for t in range(2, 6):
            want = want + stage.op(inputs, t, 1)
        assert torch.equal(got, want), name


@pytest.mark.parametrize("which", ["all_device", "split", "mixed"])
@pytest.mark.parametrize("n_device", [1, 2])
@pytest.mark.parametrize("rebalance", [True, False])
def test_hetero_executor_walks_the_lowering_bitwise(which, n_device, rebalance,
                                                    monkeypatch):
    calls = _count_walks(monkeypatch)
    low = tapps.linreg_device_lowering(1536, 9, tile=64, seed=1, device="cpu")
    names = low.dag.stage_names
    pl = {"all_device": tpl.Placement.all_device(names),
          "split": tpl.Placement({n: tpl.StagePlacement(tpl.SPLIT, 0.5)
                                  for n in names}),
          "mixed": tpl.Placement({"moments": tpl.StagePlacement(tpl.DEVICE),
                                  "syrk_gemv": tpl.StagePlacement(tpl.HOST)})
          }[which]
    tracer = None if rebalance else ttel.Tracer()
    het = thet.HeteroExecutor(low.dag, texec.SchedulerConfig(technique="SS",
                                                             n_workers=3),
                              pl, n_device=n_device, rebalance=rebalance,
                              tracer=tracer, lowering=low).run()
    _bitwise(_host_only(low), het)
    for n in names:
        rows = sorted((e.start, e.size) for e in het.events if e.stage == n)
        assert [s for s, _ in rows] == list(range(low.dag.stages[n].n_rows))
    if tracer is None:
        return
    dev = [e for e in het.events if e.worker >= 3]
    dev_rows = {n: pl.device_rows(n, low.dag.stages[n].n_rows) for n in names}
    assert len(dev) == sum(dev_rows.values())
    # every device slot went through the walker; one lane walks runs, two
    # lanes' shards interleave, so their sum stages walk a task a launch
    assert sum(z for _, z in calls) == len(dev)
    assert 0 < len(calls) < len(dev) if n_device == 1 else len(calls) == len(dev)
    flagged = [s for s in tracer.spans() if s.kind == "exec" and s.device]
    assert sorted((s.stage, s.chunk) for s in flagged) == sorted(
        (e.stage, e.task_id) for e in dev)


def test_hetero_executor_without_a_lowering_flags_no_device_spans():
    low = tapps.linreg_device_lowering(512, 9, tile=64, seed=1, device="cpu")
    tracer = ttel.Tracer()
    het = thet.HeteroExecutor(low.dag, texec.SchedulerConfig(technique="SS",
                                                             n_workers=2),
                              tpl.Placement.all_device(low.dag.stage_names),
                              rebalance=False, tracer=tracer).run()
    assert any(e.worker >= 2 for e in het.events)
    assert not any(s.device for s in tracer.spans() if s.kind == "exec")


@pytest.mark.parametrize("layout", ["CENTRALIZED", "PERCORE"])
def test_hetero_executor_walks_the_recommendation_lowering_bitwise(
        layout, monkeypatch):
    calls = _count_walks(monkeypatch)
    low = tapps.recommendation_device_lowering(512, 32, tile=32, seed=0,
                                               device="cpu")
    pl = tpl.Placement({"item_norms": tpl.StagePlacement(tpl.DEVICE),
                        "user_bias": tpl.StagePlacement(tpl.SPLIT, 0.5),
                        "scores": tpl.StagePlacement(tpl.DEVICE)})
    cfg = texec.SchedulerConfig(technique="SS", queue_layout=layout, n_workers=2,
                                numa_domains=[0, 1])
    het = thet.HeteroExecutor(low.dag, cfg, pl, rebalance=False,
                              lowering=low).run()
    _bitwise(_host_only(low), het)
    assert {n for n, _ in calls} == {"item_norms", "user_bias", "scores"}


@pytest.mark.parametrize("cut", [1, 7, 20])
def test_walked_hetero_run_preemptible_resumes_bitwise(cut):
    low = tapps.linreg_device_lowering(1024, 9, tile=64, seed=4, device="cpu")
    ss = texec.SchedulerConfig(technique="SS", n_workers=2)
    ex = thet.HeteroExecutor(low.dag, ss, tpl.Placement(
        {n: tpl.StagePlacement(tpl.SPLIT, 0.5) for n in low.dag.stage_names}),
        lowering=low)
    res, ck = ex.run_preemptible(cut)
    assert res is None and ck is not None
    fin = tpre.resume_on_host(ck, low.dag, texec.SchedulerConfig(
        technique="SS", n_workers=1))
    _bitwise(_host_only(low), fin)


# ------------------------------------------------------ entry points

def _close_sums(got, want, what):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    lim = SUM_RTOL * max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= lim, (what, np.abs(got - want).max(), lim)


@pytest.mark.parametrize("costs", ["calibrated", "given"])
def test_linear_regression_hetero_matches_reference(costs):
    rows, cols, tile = 512, 9, 64
    units = rows // tile
    cms = [pkg.HeteroCostModel(
        host={"moments": np.full(units, 2e-5), "syrk_gemv": np.full(units, 6e-4)},
        device={"moments": np.full(units, 1e-5), "syrk_gemv": np.full(units, 5e-5)})
        if costs == "given" else None for pkg in (jpl, tpl)]
    jb, jres, jp = japps.linear_regression_hetero(
        rows, cols, jexec.SchedulerConfig(n_workers=3), tile=tile, costs=cms[0])
    tb, tres, tp = tapps.linear_regression_hetero(
        rows, cols, texec.SchedulerConfig(n_workers=3), tile=tile, costs=cms[1],
        device="cpu")
    assert tp.describe() == jp.describe()
    for k in ("moments", "syrk_gemv"):
        _close_sums(tres.values[k], jres.values[k], k)
    np.testing.assert_allclose(tb, jb, atol=1e-6)
    low = tapps.linreg_device_lowering(rows, cols, tile=tile, device="cpu")
    assert np.array_equal(tb, low.finalize(_host_only(low).values))


def test_recommendation_hetero_matches_reference():
    cfg = dict(n_workers=2)
    jt, jres, jp = japps.recommendation_hetero(256, 32, jexec.SchedulerConfig(**cfg),
                                               tile=32, seed=0)
    tt, tres, tp = tapps.recommendation_hetero(256, 32, texec.SchedulerConfig(**cfg),
                                               tile=32, seed=0, device="cpu")
    assert tp.describe() == jp.describe()
    # user_bias is a concat stage, but each row is a float mean
    for k in ("item_norms", "user_bias"):
        _close_sums(tres.values[k], jres.values[k], k)
    assert np.array_equal(tt, np.asarray(jt).reshape(-1))
    assert tt.dtype == np.int32
