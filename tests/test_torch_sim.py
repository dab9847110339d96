"""The port's simulator, tuners and re-balancing against the JAX package's.

Everything here runs in virtual time (or is pure table arithmetic) on
numpy in both packages, so every result must be identical to the bit on
the same seeded inputs: simulated makespans and per-worker times, DAG
stats, frozen super-table replays, the offline searches, the online
replays, and the re-balanced chunk -> shard assignments and tables. The
one exception is ``stats_from_events`` over a real pool's timeline, whose
exact times are the pool's own; it is held to the reference's function
on the same events.
"""

import numpy as np
import pytest

from repro.core import autotune as jtune
from repro.core import dag as jdag
from repro.core import device_schedule as jsched
from repro.core import online as jonline
from repro.core import simulator as jsim
from repro.core import telemetry as jtel
from repro_torch.core import autotune as ttune
from repro_torch.core import dag as tdag
from repro_torch.core import device_schedule as tsched
from repro_torch.core import executor as texec
from repro_torch.core import online as tonline
from repro_torch.core import simulator as tsim
from repro_torch.core import telemetry as ttel
from repro_torch.core.partitioners import PARTITIONERS

TECHS = sorted(PARTITIONERS)
LAYOUTS = ["CENTRALIZED", "PERCORE", "PERGROUP"]
VICTIMS = ["SEQ", "SEQPRI", "RND", "RNDPRI"]


def _sparse_costs(n, seed=0):
    """Spatially correlated heavy-tailed costs (hub blocks), as the
    reference's simulator tests draw them."""
    rng = np.random.default_rng(seed)
    base = rng.pareto(1.3, n) * 2e-6 + 5e-7
    for _ in range(10):
        lo = int(rng.integers(0, n - n // 100))
        base[lo: lo + n // 100] *= 8.0
    return base


def _noop(inputs, s, z):
    return None


def _dags(spec, n):
    """The same DAG in both packages' data models. ``spec``: one
    (name, combine, deps) triple per stage."""
    out = []
    for pkg in (jdag, tdag):
        out.append(pkg.PipelineDAG([
            pkg.Stage(name, n, _noop, combine=comb,
                      deps=tuple(pkg.StageDep(p, k) for p, k in deps))
            for name, comb, deps in spec]))
    return out


CC_LIKE = [("prop", "concat", ()), ("chk", "sum", (("prop", "elementwise"),))]
LINREG_LIKE = [("a", "sum", ()), ("b", "sum", (("a", "full"),))]
BRANCHES = [("x", "sum", ()), ("y", "concat", ()),
            ("z", "concat", (("x", "full"), ("y", "elementwise")))]


def _stage_costs(names, n, seed):
    rng = np.random.default_rng(seed)
    return {nm: (rng.pareto(1.3, n) * 1e-6 + 1e-7) if i % 2 == 0
            else np.full(n, 3e-7) for i, nm in enumerate(names)}


def _same_sim(a, b):
    assert a.makespan == b.makespan
    assert a.per_worker_busy == b.per_worker_busy
    assert a.per_worker_finish == b.per_worker_finish
    assert a.steals == b.steals and a.queue_wait == b.queue_wait


def _same_dag_sim(a, b):
    assert a.makespan == b.makespan
    assert a.per_worker_busy == b.per_worker_busy
    assert a.stage_start == b.stage_start
    assert a.stage_finish == b.stage_finish
    assert a.queue_wait == b.queue_wait
    for f in ("exec_s", "queue_wait_s", "transfer_s", "chunks", "transfers"):
        assert getattr(a.stats, f) == getattr(b.stats, f), f


# ---------------------------------------------------------------- simulate

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tech", TECHS)
def test_simulate_bitwise(tech, layout):
    costs = _sparse_costs(1500, seed=1)
    domains = [i // 4 for i in range(8)]
    victims = ["SEQ"] if layout == "CENTRALIZED" else VICTIMS
    for victim in victims:
        kw = dict(technique=tech, queue_layout=layout, victim_strategy=victim,
                  n_workers=8, numa_domains=domains, seed=3)
        _same_sim(tsim.simulate(costs, **kw), jsim.simulate(costs, **kw))


def test_simulate_overheads_and_load_imbalance():
    costs = _sparse_costs(800, seed=2)
    ov = dict(h_access=1e-5, h_local=2e-6, h_probe=3e-6, numa_mult=2.0,
              locality_penalty=0.5, h_launch=1e-4)
    for layout in LAYOUTS:
        a = tsim.simulate(costs, "FAC2", layout, "RNDPRI", n_workers=6,
                          numa_domains=[0, 0, 0, 1, 1, 1],
                          overheads=tsim.SimOverheads(**ov), seed=5)
        b = jsim.simulate(costs, "FAC2", layout, "RNDPRI", n_workers=6,
                          numa_domains=[0, 0, 0, 1, 1, 1],
                          overheads=jsim.SimOverheads(**ov), seed=5)
        _same_sim(a, b)
        assert a.load_imbalance == b.load_imbalance
    assert tsim.SimOverheads() == tsim.SimOverheads(
        **{f: getattr(jsim.SimOverheads(), f) for f in ov})


def test_simulate_mirrors_paper_claims():
    """The reference's qualitative checks (tests/test_simulator.py) on the
    port: SS explodes under contention, DLS beats STATIC on sparse work,
    STATIC wins on dense work, busy time conserves the work."""
    dense = np.full(20000, 1e-6)
    assert (tsim.simulate(dense, technique="SS", n_workers=56).makespan
            > 5 * tsim.simulate(dense, technique="STATIC", n_workers=56).makespan)
    sparse = _sparse_costs(20000)
    static = tsim.simulate(sparse, technique="STATIC", n_workers=20).makespan
    for t in ("MFSC", "GSS"):
        assert tsim.simulate(sparse, technique=t, n_workers=20).makespan < static
    flat = np.full(50000, 2e-6)
    static = tsim.simulate(flat, technique="STATIC", n_workers=20).makespan
    for t in ("MFSC", "TFSS", "PLS", "PSS"):
        assert tsim.simulate(flat, technique=t, n_workers=20).makespan >= static * 0.999
    small = _sparse_costs(5000)
    for layout in LAYOUTS:
        res = tsim.simulate(small, technique="GSS", queue_layout=layout,
                            n_workers=8, numa_domains=[i // 4 for i in range(8)])
        assert sum(res.per_worker_busy) >= small.sum() * 0.999


# ------------------------------------------------------------ simulate_dag

@pytest.mark.parametrize("spec", [CC_LIKE, LINREG_LIKE, BRANCHES],
                         ids=["cc", "linreg", "branches"])
@pytest.mark.parametrize("combo", [("STATIC", "CENTRALIZED", "SEQ"),
                                   ("GSS", "PERCORE", "SEQ"),
                                   ("MFSC", "PERGROUP", "SEQ"),
                                   ("FAC2", "CENTRALIZED", "SEQ")])
def test_simulate_dag_host_bitwise(spec, combo):
    jd, td = _dags(spec, 512)
    costs = _stage_costs(td.stage_names, 512, seed=4)
    for workers in (1, 3, 8):
        a = tsim.simulate_dag(td, costs, combo, n_workers=workers, seed=2)
        b = jsim.simulate_dag(jd, costs, combo, n_workers=workers, seed=2)
        _same_dag_sim(a, b)


def test_simulate_dag_per_stage_tracer_and_cost_of_range():
    """A per-stage map with SchedulerConfigs, costs from ``cost_of_range``
    and unit fallbacks, and the tracer's exec spans: all identical."""
    from repro.core.executor import SchedulerConfig as JCfg

    def cor(s, z):
        return float(1 + (s % 7)) * 1e-6
    mk = []
    for pkg in (jdag, tdag):
        mk.append(pkg.PipelineDAG([
            pkg.Stage("a", 300, _noop, cost_of_range=cor),
            pkg.Stage("b", 300, _noop, deps=(pkg.StageDep("a", "elementwise"),)),
        ]))
    jd, td = mk
    per = {"a": ("TSS", "PERCORE", "SEQ")}
    a_tr, b_tr = ttel.Tracer("j"), jtel.Tracer("j")
    a = tsim.simulate_dag(td, None, {**per, "b": texec.SchedulerConfig(
        technique="GSS", queue_layout="PERGROUP")}, n_workers=4, tracer=a_tr)
    b = jsim.simulate_dag(jd, None, {**per, "b": JCfg(
        technique="GSS", queue_layout="PERGROUP")}, n_workers=4, tracer=b_tr)
    _same_dag_sim(a, b)
    assert a_tr._raw == b_tr._raw and len(a_tr._raw) == a.stats.total_chunks
    with pytest.raises(ValueError, match="costs for"):
        tsim.simulate_dag(td, {"a": np.ones(3)})


@pytest.mark.parametrize("spec", [CC_LIKE, BRANCHES], ids=["cc", "branches"])
def test_simulate_dag_frozen_and_makespans_bitwise(spec):
    jd, td = _dags(spec, 256)
    costs = _stage_costs(td.stage_names, 256, seed=6)
    for techs in ("GSS", {n: t for n, t in zip(td.stage_names,
                                                ("MFSC", "STATIC", "TSS"))}):
        for shards in (1, 2) if spec is CC_LIKE else (1,):
            jt = jsched.build_dag_tables(jd, 8, techs, n_shards=shards, n_workers=4)
            tt = tsched.build_dag_tables(td, 8, techs, n_shards=shards, n_workers=4)
            assert np.array_equal(tt.tables, jt.tables)
            _same_dag_sim(tsim.simulate_dag(td, costs, frozen=tt),
                          jsim.simulate_dag(jd, costs, frozen=jt))
            assert (tsim.frozen_dag_makespans(tt, costs)
                    == jsim.frozen_dag_makespans(jt, costs))
            fused, seq = tsim.frozen_dag_makespans(tt, costs)
            assert fused <= seq
    # frozen=True freezes the DAG itself (techniques from the combos)
    a_tr, b_tr = ttel.Tracer(), jtel.Tracer()
    a = tsim.simulate_dag(td, costs, ("TSS", "CENTRALIZED", "SEQ"), frozen=True,
                          tile=4, n_shards=1, tracer=a_tr)
    b = jsim.simulate_dag(jd, costs, ("TSS", "CENTRALIZED", "SEQ"), frozen=True,
                          tile=4, n_shards=1, tracer=b_tr)
    _same_dag_sim(a, b)
    assert a_tr._raw == b_tr._raw
    with pytest.raises(ValueError, match="host-pool only"):
        tsim.simulate_dag(td, costs, frozen=True,
                          online=tonline.OnlineScheduler(seed=0))


def test_dag_stats_reconcile():
    """The reference's reconciliation invariants (tests/test_simulator.py)
    hold on the port's DagStats."""
    (_, td) = _dags([("a", "concat", ())], 256)
    ov = tsim.SimOverheads()
    res = tsim.simulate_dag(td, {"a": np.full(256, 1e-6)},
                            ("GSS", "CENTRALIZED", "SEQ"), n_workers=1,
                            overheads=ov)
    expect = res.stats.total_exec_s + res.stats.total_chunks * ov.h_access
    assert res.makespan == pytest.approx(expect)
    assert res.stats.total_queue_wait_s == pytest.approx(res.queue_wait)
    assert res.stats.total_transfer_s == 0.0
    _, td = _dags(CC_LIKE, 4096)
    rng = np.random.default_rng(3)
    costs = {"prop": rng.pareto(1.3, 4096) * 1e-6 + 1e-7,
             "chk": np.full(4096, 2e-8)}
    res = tsim.simulate_dag(td, costs, ("MFSC", "PERCORE", "SEQ"), n_workers=8)
    assert sum(res.per_worker_busy) == pytest.approx(res.stats.total_exec_s)
    assert set(res.stats.chunks) == {"prop", "chk"}
    assert res.makespan >= res.stats.total_exec_s / 8 - 1e-12
    assert res.makespan >= max(res.stage_finish.values()) - 1e-12
    assert res.overlap_s("prop", "chk") > 0


def test_stats_from_events_matches_reference_on_one_timeline():
    """A real pool's timeline: the port's stats (raw-tuple fast path and
    the event path) equal the reference's function over the same events,
    and reconcile with the events."""
    dag = tdag.PipelineDAG([
        tdag.Stage("a", 64, lambda i, s, z: np.zeros(z)),
        tdag.Stage("b", 64, lambda i, s, z: np.zeros(z),
                   deps=(tdag.StageDep("a", "elementwise"),))])
    res = tdag.PipelineExecutor(dag, texec.SchedulerConfig(
        technique="GSS", n_workers=2)).run()
    stats = res.stats
    events = list(res.events)
    for other in (tsim.stats_from_events(events), jsim.stats_from_events(events),
                  jsim.stats_from_events(res.events)):
        assert other.exec_s == stats.exec_s
        assert other.queue_wait_s == stats.queue_wait_s
        assert other.chunks == stats.chunks
    assert stats.total_chunks == len(events)
    assert stats.total_exec_s == pytest.approx(
        sum(e.t_end - e.t_start for e in events))
    assert stats.total_queue_wait_s == pytest.approx(sum(e.wait_s for e in events))
    assert res.wall_time_s >= stats.total_exec_s / 2 - 1e-9
    raw = list(res.events.iter_stat_tuples())
    assert raw == [(e.stage, e.t_end - e.t_start, e.wait_s) for e in events]


def test_simulate_server_on_submissions_bitwise():
    """Submissions in (the front door's surface) and the reference's
    per-job replay out, every simulated chunk included."""
    from repro.core import submit as jsub
    from repro_torch.core import submit as tsub

    out = []
    for dag_mod, sub_mod, sim in ((tdag, tsub, tsim), (jdag, jsub, jsim)):
        subs = []
        for k, spec in enumerate((CC_LIKE, LINREG_LIKE)):
            dag = dag_mod.PipelineDAG([
                dag_mod.Stage(name, 96, _noop, combine=comb,
                              deps=tuple(dag_mod.StageDep(p, kd) for p, kd in deps))
                for name, comb, deps in spec])
            subs.append(sub_mod.Submission(
                dag=dag, name=f"j{k}", tenant=f"t{k}", arrival_s=1e-4 * k,
                stage_costs=_stage_costs(dag.stage_names, 96, seed=k)))
        res = sim.simulate_server(subs, n_workers=3, arbiter="fair", seed=1)
        out.append((res.makespan, res.job_finish, res.tenant_service,
                    res.per_worker_busy, [tuple(vars(e).values()) for e in res.events]))
    assert out[0] == out[1]
    assert set(out[0][1]) == {"j0", "j1"}


# ------------------------------------------------------- offline searches

def test_select_offline_bitwise():
    costs = _sparse_costs(600, seed=7)
    for kw in (dict(n_workers=4), dict(n_workers=6, numa_domains=[0, 0, 0, 1, 1, 1],
                                       include_ss=True, seed=2)):
        assert ttune.select_offline(costs, **kw) == jtune.select_offline(costs, **kw)
    assert (list(ttune.default_search_space(True))
            == list(jtune.default_search_space(True)))
    dense = np.full(4000, 2e-6)
    _, scores = ttune.select_offline(dense, n_workers=8,
                                     numa_domains=[i // 4 for i in range(8)])
    static_best = min(v for (t, _, _), v in scores.items() if t == "STATIC")
    assert static_best <= min(scores.values()) * 1.02


@pytest.mark.parametrize("spec", [CC_LIKE, LINREG_LIKE], ids=["cc", "linreg"])
def test_select_offline_dag_bitwise(spec):
    jd, td = _dags(spec, 256)
    costs = _stage_costs(td.stage_names, 256, seed=8)
    got = ttune.select_offline_dag(td, costs, n_workers=4, passes=2)
    want = jtune.select_offline_dag(jd, costs, n_workers=4, passes=2)
    assert got == want
    assign, best, uniform = got
    assert best <= min(uniform.values())


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_select_offline_device_dag_bitwise(shards):
    jd, td = _dags([("prop", "concat", ()),
                    ("chk", "concat", (("prop", "elementwise"),))], 64)
    rng = np.random.default_rng(2)
    costs = {"prop": rng.pareto(1.2, 64) + 0.05, "chk": np.full(64, 0.3)}
    got = ttune.select_offline_device_dag(td, costs, tile=4, n_shards=shards,
                                          passes=2)
    want = jtune.select_offline_device_dag(jd, costs, tile=4, n_shards=shards,
                                           passes=2)
    assert got == want
    assign, best, uniform = got
    assert set(assign) == {"prop", "chk"}
    assert best <= min(uniform.values()) + 1e-12


# --------------------------------------------------- online, virtual time

@pytest.mark.parametrize("resize", [False, True])
@pytest.mark.parametrize("selector", ["ucb", "exp3"])
def test_replay_online_dag_bitwise(selector, resize):
    jd, td = _dags(CC_LIKE, 256)
    costs = _stage_costs(td.stage_names, 256, seed=5)
    t_on = tonline.OnlineScheduler(selector=selector, resize=resize, seed=7)
    j_on = jonline.OnlineScheduler(selector=selector, resize=resize, seed=7)
    got = tonline.replay_online_dag(td, costs, t_on, rounds=12, n_workers=4)
    want = jonline.replay_online_dag(jd, costs, j_on, rounds=12, n_workers=4)
    assert [(r.combos, r.makespan, r.stage_span) for r in got] == [
        (r.combos, r.makespan, r.stage_span) for r in want]
    assert t_on.resizes == j_on.resizes
    assert t_on.best_combos(["prop", "chk"]) == j_on.best_combos(["prop", "chk"])


def test_ucb_converges_exactly_after_full_exploration():
    """The reference's property (tests/test_online.py): UCB plays every
    arm once, and with deterministic rewards its best arm is the static
    argmin; the replay is the same on a second run."""
    (_, td) = _dags([("hot", "concat", ())], 256)
    rng = np.random.default_rng(9)
    costs = {"hot": rng.pareto(1.3, 256) * 2e-6 + 1e-7}
    arms = tonline.default_online_arms(include_ss=False)
    statics = {c: tsim.simulate_dag(td, costs, c, n_workers=4).makespan for c in arms}

    def run():
        online = tonline.OnlineScheduler(selector="ucb", arms=arms, resize=False, seed=0)
        hist = tonline.replay_online_dag(td, costs, online, rounds=len(arms), n_workers=4)
        return online.best_combos(["hot"])["hot"], [r.makespan for r in hist]

    best, history = run()
    assert statics[best] == min(statics.values())
    assert sorted(history) == sorted(statics.values())
    assert run() == (best, history)


def test_tune_online_dag_bitwise_and_near_offline():
    jd, td = _dags([("a", "concat", ()),
                    ("b", "sum", (("a", "elementwise"),))], 1024)
    rng = np.random.default_rng(11)
    costs = {"a": rng.pareto(1.5, 1024) * 1e-7 + 2e-8, "b": np.full(1024, 3e-7)}
    got = ttune.tune_online_dag(td, costs, n_workers=8, rounds=40, seed=0)
    want = jtune.tune_online_dag(jd, costs, n_workers=8, rounds=40, seed=0)
    assert got.assign == want.assign and got.makespan == want.makespan
    assert [r.makespan for r in got.history] == [r.makespan for r in want.history]
    assert len(got.history) == 40
    _, offline_ms, _ = ttune.select_offline_dag(td, costs, n_workers=8, passes=1)
    assert got.makespan <= offline_ms * 1.10


def test_online_tuner_and_dag_tuner_draws_bitwise():
    """Same seeded draws, same observations: the same arms every round."""
    costs = _sparse_costs(2000, seed=4)
    t_tun, j_tun = ttune.OnlineTuner.default(seed=3), jtune.OnlineTuner.default(seed=3)
    for _ in range(60):
        combo = t_tun.suggest()
        assert combo == j_tun.suggest()
        t, l, v = combo
        ms = tsim.simulate(costs, t, l, v, n_workers=8,
                           numa_domains=[i // 4 for i in range(8)]).makespan
        t_tun.observe(ms)
        j_tun.observe(ms)
    assert t_tun.best == j_tun.best
    cfg = t_tun.as_config(t_tun.best, 4)
    assert (cfg.technique, cfg.queue_layout, cfg.victim_strategy) == t_tun.best
    td_tun = ttune.DagTuner(["prop", "chk"], seed=5)
    jd_tun = jtune.DagTuner(["prop", "chk"], seed=5)
    for r in range(30):
        assert td_tun.suggest() == jd_tun.suggest()
        td_tun.observe(1.0 + (r * 7919 % 13) * 0.1)
        jd_tun.observe(1.0 + (r * 7919 % 13) * 0.1)
    assert td_tun.best == jd_tun.best


# ------------------------------------------------- persistent re-balancing

@pytest.mark.parametrize("seed", range(6))
def test_rebalance_bitwise(seed):
    rng = np.random.default_rng(seed)
    shards = int(rng.integers(2, 9))
    n = int(rng.integers(shards, 80))
    assign = rng.integers(0, shards, n).astype(np.int32)
    costs = rng.pareto(1.2, n) + 0.1
    load = np.array([costs[assign == s].sum() for s in range(shards)])
    nf = None if seed % 2 else rng.integers(0, 4, (shards, shards))
    got = tsched.rebalance(assign, load, costs, neighbors_first=nf, max_moves=n)
    want = jsched.rebalance(assign, load, costs, neighbors_first=nf, max_moves=n)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_rebalance_moves_work_toward_balance():
    n = 40
    costs = np.ones(n)
    assign = np.zeros(n, dtype=np.int32)
    new = tsched.rebalance(assign, np.array([float(n)] + [0.0] * 7), costs,
                           max_moves=n)
    loads = np.array([costs[new == s].sum() for s in range(8)])
    assert loads.max() < n and loads[0] > 0
    for _ in range(30):
        load = np.array([costs[new == s].sum() for s in range(8)])
        new = tsched.rebalance(new, load, costs, max_moves=n)
    load = np.array([costs[new == s].sum() for s in range(8)])
    assert load.max() <= np.ceil(n / 8) * 1.5


@pytest.mark.parametrize("techs", ["MFSC", {"prop": "GSS", "chk": "STATIC"}],
                         ids=["mfsc", "gss-static"])
@pytest.mark.parametrize("mode", ["contiguous", "roundrobin"])
def test_rebalance_dag_bitwise(techs, mode):
    tiles, tile = 32, 4
    jd, td = _dags([("prop", "concat", ()),
                    ("chk", "concat", (("prop", "elementwise"),))], tiles * tile)
    jt = jsched.build_dag_tables(jd, tile, techs, n_shards=4, n_workers=4,
                                 assignment=mode)
    tt = tsched.build_dag_tables(td, tile, techs, n_shards=4, n_workers=4,
                                 assignment=mode)
    rng = np.random.default_rng(0)
    tile_load = {}
    for name in tt.stage_names:
        base = rng.uniform(1.0, 2.0, tiles)
        base[: tiles // 4] *= 10
        tile_load[name] = base

    def measured(d):
        return {n: np.array([tile_load[n][s:s + z].sum()
                             for s, z in d.stage_chunks[n]])
                for n in d.stage_names}

    def max_shard_load(d):
        load = np.zeros(d.n_shards)
        for n in d.stage_names:
            for c, sh in zip(measured(d)[n], d.chunk_shard[n]):
                load[sh] += c
        return load.max()

    for _ in range(3):
        got = tsched.rebalance_dag(tt, measured(tt))
        want = jsched.rebalance_dag(jt, measured(jt))
        assert np.array_equal(got.tables, want.tables)
        for n in got.stage_names:
            assert np.array_equal(got.stage_chunks[n], want.stage_chunks[n])
            assert np.array_equal(got.chunk_shard[n], want.chunk_shard[n])
            assert got.stage_rows(n) == tt.stage_rows(n)
        costs = {n: np.repeat(tile_load[n], tile) for n in got.stage_names}
        assert (tsim.frozen_dag_makespans(got, costs)
                == jsim.frozen_dag_makespans(want, costs))
        if mode == "contiguous" and tt is not got:
            assert max_shard_load(got) <= max_shard_load(tt)
        tt, jt = got, want
