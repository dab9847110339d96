"""The port's host entry points against the JAX package's.

The VEE, Listings 1 and 2, the pipeline-DAG and online entry points and
the coordinator are numpy on real thread pools in both packages. What a
run may depend on decides what is held bitwise:

* ``concat``, max and int32 results do not depend on thread timing:
  Listing 1's labels and iteration counts, the coordinator's rows, the
  recommendation ``user_bias`` stage are bitwise under any worker count.
  The reference's CSR gather (``CSRMatrix.row_max_gather``) drops the last
  neighbour of a block's last non-empty row when the block ends in empty
  rows; the port's is exact. So Listing 1 is held to the reference run at
  one row a chunk (``SS``), where the reference's gather is exact, and to
  the dense step.
* The VEE folds ``sum`` partials in chunk order, so Listing 2 is bitwise
  under any worker count too.
* The DAG runtime folds ``sum`` stages in completion order, so linreg's
  ``moments`` / ``syrk_gemv`` and recommendation's ``item_norms`` are
  bitwise only with one worker. With more, a sum over n rows is held to
  the reference's within ``n * eps64 * sum|terms|`` (``sum_limit``: the
  worst case of any two summation orders of n float64 terms, so the check
  cannot fail on an order a run happens to take), ``syrk_gemv`` to its own
  ``moments`` within the same limit, and a top item to the reference's
  wherever the top two scores differ by more than 1e-9.
* Online loops pick arms by measured time; a loop is held bitwise only
  where its picks cannot depend on timing (UCB's first rounds play the
  arms in order, resizing off) and otherwise to the float64 oracle.
"""

import numpy as np
import pytest

from repro.core import autotune as jtune
from repro.core import coordinator as jcoord
from repro.core import online as jonline
from repro.core.executor import SchedulerConfig as JCfg
from repro.vee import apps as japps
from repro.vee import engine as jengine
from repro.vee import sparse as jsparse
from repro_torch.core import autotune as ttune
from repro_torch.core import coordinator as tcoord
from repro_torch.core import online as tonline
from repro_torch.core.executor import SchedulerConfig as TCfg
from repro_torch.vee import apps as tapps
from repro_torch.vee import engine as tengine
from repro_torch.vee import sparse as tsparse

EPS64 = np.finfo(np.float64).eps
# the combos the reference's tests/test_vee.py runs Listing 1 under
CC_COMBOS = [("STATIC", "CENTRALIZED"), ("MFSC", "CENTRALIZED"),
             ("GSS", "PERCORE"), ("TFSS", "PERGROUP")]


def _cfgs(**kw):
    return TCfg(**kw), JCfg(**kw)


def _graphs(scale, edge_factor=4, seed=1):
    return (tsparse.rmat_graph(scale=scale, edge_factor=edge_factor, seed=seed),
            jsparse.rmat_graph(scale=scale, edge_factor=edge_factor, seed=seed))


def sum_limit(terms_abs_sum: np.ndarray, n: int) -> np.ndarray:
    """n eps64 sum|terms|: how far two summation orders of n float64 terms
    can differ (each is within (n - 1) eps64 / 2 sum|terms| of the exact
    sum)."""
    return n * EPS64 * terms_abs_sum


def _exact_step(jG, c: np.ndarray) -> np.ndarray:
    """One propagation step by the reference's gather, one row at a time
    (a one-row block never ends in an empty row)."""
    return np.concatenate([jG.row_max_gather(c, i, i + 1) for i in range(jG.n_rows)])


def _labels_oracle(G) -> np.ndarray:
    """Union-find components (undirected), roots as labels."""
    parent = np.arange(G.n_rows)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(G.n_rows):
        for j in G.indices[G.indptr[i]:G.indptr[i + 1]]:
            ri, rj = find(i), find(int(j))
            if ri != rj:
                parent[max(ri, rj)] = min(ri, rj)
    return np.array([find(i) for i in range(G.n_rows)])


# ----------------------------------------------------------- sparse / VEE

def test_replicated_graph_and_cc_step_bitwise():
    for kw in (dict(base_scale=10, copies=3), dict(base_scale=7, copies=3,
                                                   edge_factor=4, seed=2,
                                                   relabel=False)):
        tg, jg = tsparse.replicated_graph(**kw), jsparse.replicated_graph(**kw)
        assert np.array_equal(tg.indptr, jg.indptr)
        assert np.array_equal(tg.indices, jg.indices) and tg.n_cols == jg.n_cols
    c = np.random.default_rng(0).integers(1, 10**6, tg.n_rows).astype(np.int64)
    got, want = tapps.cc_step_numpy(tg, c), _exact_step(jg, c)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    dense = tg.to_dense() > 0
    assert np.array_equal(got, np.maximum(np.where(dense, c[None, :], 0).max(1), c))


def test_row_max_gather_exact_on_blocks_ending_in_empty_rows():
    """Every block of every chunking gives the exact step (the
    reference's gather misses neighbours on such blocks)."""
    tg, jg = _graphs(9, seed=0)
    c = np.random.default_rng(0).permutation(tg.n_rows).astype(np.int64) + 1
    want = _exact_step(jg, c)
    missed = 0
    for step in (7, 64, 300):
        blocks = range(0, tg.n_rows, step)
        got = np.concatenate([tg.row_max_gather(c, i, i + step) for i in blocks])
        assert np.array_equal(got, want), step
        ref = np.concatenate([jg.row_max_gather(c, i, i + step) for i in blocks])
        missed += int((ref != want).sum())
    assert missed > 0  # the draw does exercise the reference's fault


@pytest.mark.parametrize("workers", [1, 3])
def test_vee_run_matches_reference(workers):
    """Concat rows, chunk-order sums, the schedule and the cost vector's
    shape; ``measure_row_costs`` gives one non-negative cost a row."""
    x = np.random.default_rng(3).standard_normal((500, 6))
    for tech in ("STATIC", "GSS", "FAC2"):
        tc, jc = _cfgs(technique=tech, n_workers=workers, seed=4)
        for comb, op in (("concat", lambda s, z: x[s:s + z] * 2.0),
                         ("sum", lambda s, z: x[s:s + z].sum(axis=0))):
            got = tengine.VEE(tc).run(500, op, combine=comb)
            want = jengine.VEE(jc).run(500, op, combine=comb)
            assert np.array_equal(got.value, want.value)
            assert np.array_equal(got.schedule, want.schedule)
            assert got.per_task_costs.shape == (len(got.schedule),)
            assert (got.per_task_costs >= 0).all()
            assert sum(got.stats.per_worker_tasks) == len(got.schedule)
    with pytest.raises(ValueError, match="combine"):
        tengine.VEE(tc).run(10, lambda s, z: 0, combine="max")
    costs = tengine.VEE(tc).measure_row_costs(20, lambda s, z: x[s:s + z].sum())
    assert costs.shape == (20,) and (costs >= 0).all()


# ------------------------------------------------------------- Listing 1

@pytest.mark.parametrize("technique,layout", CC_COMBOS)
def test_connected_components_bitwise(technique, layout):
    tg, jg = _graphs(9)
    tc, jc = _cfgs(technique=technique, queue_layout=layout,
                   victim_strategy="SEQ", n_workers=4, numa_domains=(0, 0, 1, 1))
    labels, iters, hist = tapps.connected_components(tg, tc)
    want_labels, want_iters, want_hist = japps.connected_components(
        jg, JCfg(technique="SS", n_workers=2))
    schedules = japps.connected_components(jg, jc, max_iter=1)[2]
    assert labels.dtype == want_labels.dtype
    assert np.array_equal(labels, want_labels) and iters == want_iters < 100
    assert len(hist) == len(want_hist) == iters
    assert np.array_equal(hist[0].schedule, schedules[0].schedule)
    for a, b in zip(hist, want_hist):
        assert np.array_equal(a.value, b.value)
    roots = _labels_oracle(tg)
    for comp in np.unique(roots):
        assert len(np.unique(labels[roots == comp])) == 1
    assert len(np.unique(labels)) == len(np.unique(roots))


def test_connected_components_max_iter():
    tg, jg = _graphs(8, seed=0)
    tc, _ = _cfgs(technique="MFSC", n_workers=2)
    got = tapps.connected_components(tg, tc, max_iter=2)
    want = japps.connected_components(jg, JCfg(technique="SS"), max_iter=2)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] == 2
    assert got[2][0].schedule[:, 1].sum() == tg.n_rows


# ------------------------------------------------------------- Listing 2

@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("technique", ["STATIC", "GSS", "FAC2", "PSS"])
def test_linear_regression_bitwise(technique, workers):
    """The VEE sums in chunk order: bitwise under any worker count."""
    tc, jc = _cfgs(technique=technique, n_workers=workers, seed=9)
    beta, hist = tapps.linear_regression(5_000, 9, tc, seed=2)
    want, want_hist = japps.linear_regression(5_000, 9, jc, seed=2)
    assert np.array_equal(hist[0].value, want_hist[0].value)
    assert np.array_equal(beta, want)
    np.testing.assert_allclose(beta, tapps.linear_regression_oracle(5_000, 9, seed=2),
                               rtol=1e-8)
    assert abs(beta[-1, 0] - 0.5) < 0.05


# ------------------------------------------------------ DAG entry points

def _linreg_data(rows, cols, seed):
    rng = np.random.default_rng(seed)
    XY = rng.uniform(0.0, 1.0, size=(rows, cols))
    return XY[:, :-1], XY[:, -1:]


@pytest.mark.parametrize("per_stage", [None, {"moments": ("GSS", "CENTRALIZED", "SEQ"),
                                              "syrk_gemv": ("FAC2", "PERCORE", "SEQ")}])
def test_linear_regression_dag_one_worker_bitwise(per_stage):
    tc, jc = _cfgs(technique="TSS", n_workers=1)
    beta, res = tapps.linear_regression_dag(3_000, 7, tc, seed=3, per_stage=per_stage)
    want, wres = japps.linear_regression_dag(3_000, 7, jc, seed=3, per_stage=per_stage)
    for n in ("moments", "syrk_gemv"):
        assert np.array_equal(res.values[n], wres.values[n])
        assert np.array_equal(res.stages[n].schedule, wres.stages[n].schedule)
    assert np.array_equal(beta, want)
    assert [(e.stage, e.start, e.size) for e in res.events] == [
        (e.stage, e.start, e.size) for e in wres.events]
    assert res.stats.chunks == wres.stats.chunks


def test_linear_regression_dag_many_workers_within_limit():
    rows, cols = 3_000, 7
    tc, jc = _cfgs(technique="GSS", n_workers=4)
    beta, res = tapps.linear_regression_dag(rows, cols, tc, seed=3)
    want, wres = japps.linear_regression_dag(rows, cols, jc, seed=3)
    X, y = _linreg_data(rows, cols, 3)
    m_terms = np.stack([np.abs(X).sum(0), (X ** 2).sum(0)])
    assert (np.abs(res.values["moments"] - wres.values["moments"])
            <= sum_limit(m_terms, rows)).all()
    for values in (res.values, wres.values):
        # syrk_gemv standardizes with the run's own moments, bitwise as
        # here; only its sum over the rows may take another order
        m = values["moments"]
        mean = m[0] / rows
        std = np.sqrt(np.maximum(m[1] / rows - mean ** 2, 0.0))
        std[std == 0] = 1.0
        X1 = np.concatenate([(X - mean) / std, np.ones((rows, 1))], axis=1)
        exact = np.concatenate([X1.T @ X1, X1.T @ y], axis=1)
        terms = np.concatenate([np.abs(X1).T @ np.abs(X1), np.abs(X1).T @ y], axis=1)
        assert (np.abs(values["syrk_gemv"] - exact) <= sum_limit(terms, rows)).all()
    np.testing.assert_allclose(beta, want, rtol=1e-8)
    np.testing.assert_allclose(beta, tapps.linear_regression_oracle(rows, cols, seed=3),
                               rtol=1e-8)


def _rec_data(users, items, density, seed):
    rng = np.random.default_rng(seed)
    R = rng.uniform(0.0, 1.0, size=(users, items))
    R *= rng.uniform(size=(users, items)) < density
    return R


def test_recommendation_pipeline_one_worker_bitwise():
    for per_stage in (None, {"item_norms": ("MFSC", "CENTRALIZED", "SEQ"),
                             "scores": ("GSS", "PERGROUP", "SEQ")}):
        tc, jc = _cfgs(technique="FAC2", n_workers=1)
        top, res = tapps.recommendation_pipeline(400, 24, tc, per_stage=per_stage)
        want, wres = japps.recommendation_pipeline(400, 24, jc, per_stage=per_stage)
        for n in ("item_norms", "user_bias", "scores"):
            assert np.array_equal(res.values[n], wres.values[n])
        assert np.array_equal(top, want)
        assert res.overlap_s("item_norms", "user_bias") >= 0.0


def _check_rec_many_workers(top, values, want_values, users, items, seed):
    R = _rec_data(users, items, 0.3, seed)
    assert np.array_equal(values["user_bias"], want_values["user_bias"])
    lim = sum_limit((R ** 2).sum(0), users)
    assert (np.abs(values["item_norms"] - want_values["item_norms"]) <= lim).all()
    # the top item is the argmax over the run's own norms; it agrees with
    # the reference's wherever the top two scores are further apart than
    # the norms' limit (relative 1e-13 here) can move them
    s = R / (np.sqrt(values["item_norms"]) + 1e-9) - values["user_bias"][:, None]
    assert np.array_equal(top, np.argmax(s, axis=1))
    srt = np.sort(s, axis=1)
    gap = srt[:, -1] - srt[:, -2]
    clear = gap > 1e-9
    assert np.array_equal(top[clear], want_values["scores"][clear])


def test_recommendation_pipeline_many_workers_within_limit():
    tc, jc = _cfgs(technique="GSS", n_workers=4)
    top, res = tapps.recommendation_pipeline(400, 24, tc, seed=2)
    want, wres = japps.recommendation_pipeline(400, 24, jc, seed=2)
    _check_rec_many_workers(top, res.values, wres.values, 400, 24, 2)
    agree = (top == tapps.recommendation_oracle(400, 24, seed=2)).mean()
    assert agree > 0.99


@pytest.mark.parametrize("per_stage", [None, {"propagate": ("MFSC", "PERCORE", "SEQ"),
                                              "changed": ("STATIC", "CENTRALIZED", "SEQ")}])
@pytest.mark.parametrize("workers", [1, 4])
def test_connected_components_dag_bitwise(workers, per_stage):
    """``changed`` is an int sum: labels and iteration counts are bitwise
    under any worker count, and equal Listing 1's on the VEE."""
    tg, jg = _graphs(8, seed=2)
    tc, jc = _cfgs(technique="GSS", n_workers=workers)
    labels, iters, hist = tapps.connected_components_dag(tg, tc, per_stage=per_stage)
    exact = {"propagate": ("SS", "CENTRALIZED", "SEQ")}
    want, want_iters, want_hist = japps.connected_components_dag(jg, jc,
                                                                 per_stage=exact)
    assert np.array_equal(labels, want) and iters == want_iters
    assert [int(r.values["changed"]) for r in hist] == [
        int(r.values["changed"]) for r in want_hist]
    vee_labels, vee_iters, _ = tapps.connected_components(tg, tc)
    assert np.array_equal(labels, vee_labels) and iters == vee_iters


def test_connected_components_dag_with_tuner():
    """The tuner picks per-stage combos by measured wall time, so only
    the result and the tuner's structure are checked: the labels are
    Listing 1's whatever it picked."""
    tg, jg = _graphs(8, seed=3)
    tc, jc = _cfgs(technique="STATIC", n_workers=2)
    tuner = ttune.DagTuner.for_dag(tapps.cc_iteration_dag(tg, np.arange(1, tg.n_rows + 1)),
                                   seed=0)
    labels, iters, hist = tapps.connected_components_dag(tg, tc, tuner=tuner)
    want, want_iters, _ = japps.connected_components(jg, JCfg(technique="SS"))
    assert np.array_equal(labels, want) and iters == want_iters == len(hist)
    space = set(ttune.default_search_space())
    assert set(tuner.best) == {"propagate", "changed"}
    assert all(c in space for c in tuner.best.values())
    assert sum(int(t._count.sum()) for t in tuner._tuners.values()) == iters


# ---------------------------------------------------- online entry points

def _ucb_no_resize(pkg):
    return pkg.OnlineScheduler(selector="ucb", resize=False, seed=0,
                               arms=pkg.default_online_arms(include_ss=False))


def test_linear_regression_online_one_worker_bitwise():
    """UCB plays unexplored arms in order and resizing is off, so the
    rounds' combos cannot depend on timing: bitwise with one worker."""
    tc, jc = _cfgs(technique="STATIC", n_workers=1)
    t_on, j_on = _ucb_no_resize(tonline), _ucb_no_resize(jonline)
    beta, hist, got_on = tapps.linear_regression_online(2_000, 6, tc, rounds=3,
                                                        online=t_on, seed=4)
    want, whist, _ = japps.linear_regression_online(2_000, 6, jc, rounds=3,
                                                    online=j_on, seed=4)
    assert got_on is t_on and len(hist) == len(whist) == 3
    for a, b in zip(hist, whist):
        for n in ("moments", "syrk_gemv"):
            assert np.array_equal(a.stages[n].schedule, b.stages[n].schedule)
            assert np.array_equal(a.values[n], b.values[n])
    assert np.array_equal(beta, want)


def test_recommendation_online_one_worker_bitwise():
    tc, jc = _cfgs(technique="STATIC", n_workers=1)
    top, hist, _ = tapps.recommendation_online(300, 16, tc, rounds=3,
                                               online=_ucb_no_resize(tonline))
    want, whist, _ = japps.recommendation_online(300, 16, jc, rounds=3,
                                                 online=_ucb_no_resize(jonline))
    for a, b in zip(hist, whist):
        for n in ("item_norms", "user_bias", "scores"):
            assert np.array_equal(a.values[n], b.values[n])
    assert np.array_equal(top, want)


def test_online_entry_points_default_loop():
    """The default loop (UCB, resizing on) on four workers: whatever it
    picks, every round covers every row once and answers within limits."""
    tc = TCfg(technique="GSS", n_workers=4)
    beta, hist, online = tapps.linear_regression_online(3_000, 7, tc, rounds=3, seed=3)
    assert len(hist) == 3 and isinstance(online, tonline.OnlineScheduler)
    for r in hist:
        for n in ("moments", "syrk_gemv"):
            sched = r.stages[n].schedule
            assert np.array_equal(np.sort(np.concatenate(
                [np.arange(s, s + z) for s, z in sched])), np.arange(3_000))
    np.testing.assert_allclose(beta, tapps.linear_regression_oracle(3_000, 7, seed=3),
                               rtol=1e-8)
    top, hist, _ = tapps.recommendation_online(400, 24, tc, rounds=2, seed=2)
    _, wres = japps.recommendation_pipeline(400, 24, JCfg(technique="GSS",
                                                          n_workers=1), seed=2)
    _check_rec_many_workers(top, hist[-1].values, wres.values, 400, 24, 2)


# ---------------------------------------------------------- coordinator

def _coords(n_nodes, pkg_t=tcoord, pkg_j=jcoord, **kw):
    out = []
    for pkg in (pkg_t, pkg_j):
        out.append(pkg.Coordinator(pkg.CoordinatorConfig(n_nodes=n_nodes, **kw)))
    return out


@pytest.mark.parametrize("kill", [None, 0, 1])
def test_coordinator_listing1_step_bitwise(kill):
    """Listing 1's first propagation over the CSR graph on 2 nodes x 4
    workers, with and without a node killed: every row of ``cc_step_numpy``
    and the same keyed partials as the reference's coordinator running the
    same program."""
    tg, jg = _graphs(9, seed=4)
    c = np.arange(1, tg.n_rows + 1, dtype=np.int64)
    results = []
    for co in _coords(2, node_workers=4):
        co.broadcast("c", c)
        co.ship_program(lambda store, s, z: tg.row_max_gather(store["c"], s, s + z))
        if kill is not None:
            co.kill_node(kill)
        results.append(co.run(tg.n_rows))
    got, want = results
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.array_equal(got[k], want[k])
    rows = np.concatenate([got[k] for k in sorted(got)])
    assert np.array_equal(rows, tapps.cc_step_numpy(tg, c))
    assert np.array_equal(rows, _exact_step(jg, c))


def test_coordinator_divides_distributes_and_fails():
    for n_nodes, kill in ((3, None), (3, 1)):
        co, jco = _coords(n_nodes, node_workers=2, technique="FAC2",
                          node_technique="GSS")
        for x in (co, jco):
            x.broadcast("scale", np.array(2.0))
            x.ship_program(lambda store, s, z: (np.arange(s, s + z)
                                                * store["scale"]).sum())
            if kill is not None:
                x.kill_node(kill)
        got, want = co.run(1000), jco.run(1000)
        assert got == want and sum(got.values()) == np.arange(1000).sum() * 2.0
    co, _ = _coords(2)
    co.distribute("X", np.arange(10).reshape(10, 1))
    assert [nd.store["X"].shape[0] for nd in co.nodes] == [5, 5]
    with pytest.raises(ValueError, match="unknown message"):
        co.nodes[0].recv(("bogus",))
    co.kill_node(0)
    co.kill_node(1)
    with pytest.raises(ConnectionError):
        co.nodes[0].recv(("run", 0, 1))
    with pytest.raises(RuntimeError, match="no alive"):
        co.run(10)


def test_tuner_space_matches_reference():
    assert list(ttune.default_search_space()) == list(jtune.default_search_space())
