"""Automatic scheduling-option selection (the paper's stated future work).

The paper closes: "the multitude of scheduling options ... renders the
offline or online selection of the right scheduling option very challenging.
We plan to extend DaphneSched to support automatic selection."

We implement both modes as a beyond-paper feature:

* ``select_offline``: simulate every (technique × layout × victim) combination
  on the measured task-cost vector (cheap — the simulator runs in ms) and
  return the argmin-makespan configuration. This formalizes the paper's own
  observation that sparse/imbalanced work wants moderate dynamic chunks and
  dense/balanced work wants STATIC.

* ``OnlineTuner``: epsilon-greedy bandit over configurations for iterative
  pipelines (e.g. the connected-components while-loop): each iteration
  executes under one configuration and observes wall time; exploitation
  converges to the best arm within a few iterations.

The per-stage searches (``select_offline_dag``, ``select_offline_device_dag``,
``tune_online_dag``, ``DagTuner``) extend both modes to pipeline DAGs.
The placement searches (``select_offline_hetero``, ``tune_online_hetero``)
and the per-job search under contention (``select_offline_server``) score
co-execution and serving replays. All of it is numpy over the port's
simulator, bitwise the reference's.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass

import numpy as np

from .executor import SchedulerConfig
from .online import OnlineScheduler, default_online_arms, replay_online_dag
from .partitioners import PARTITIONERS
from .simulator import SimOverheads, simulate, simulate_dag, simulate_server
from .victim import VICTIM_STRATEGIES

__all__ = ["select_offline", "OnlineTuner", "default_search_space",
           "select_offline_dag", "DagTuner", "select_offline_server",
           "select_offline_device_dag", "OnlineTuneResult", "tune_online_dag",
           "select_offline_hetero", "tune_online_hetero"]


def default_search_space(include_ss: bool = False):
    """Yield every (technique, layout, victim) combo worth simulating."""
    techniques = [t for t in PARTITIONERS if include_ss or t != "SS"]
    layouts = ["CENTRALIZED", "PERCORE", "PERGROUP"]
    victims = list(VICTIM_STRATEGIES)
    for t, l in itertools.product(techniques, layouts):
        if l == "CENTRALIZED":
            yield (t, l, "SEQ")  # victim strategy irrelevant
        else:
            for v in victims:
                yield (t, l, v)


def select_offline(
    task_costs: np.ndarray,
    n_workers: int,
    numa_domains: list[int] | None = None,
    overheads: SimOverheads = SimOverheads(),
    include_ss: bool = False,
    seed: int = 0,
) -> tuple[tuple[str, str, str], dict[tuple, float]]:
    """Exhaustive simulated search; returns (best_combo, all_makespans)."""
    scores: dict[tuple, float] = {}
    for combo in default_search_space(include_ss):
        t, l, v = combo
        res = simulate(
            task_costs, technique=t, queue_layout=l, victim_strategy=v,
            n_workers=n_workers, numa_domains=numa_domains,
            overheads=overheads, seed=seed,
        )
        scores[combo] = res.makespan
    best = min(scores, key=scores.get)
    return best, scores


@dataclass
class OnlineTuner:
    """Epsilon-greedy selection across pipeline iterations."""

    arms: list[tuple[str, str, str]]
    epsilon: float = 0.2
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._mean = np.zeros(len(self.arms))
        self._count = np.zeros(len(self.arms), dtype=int)
        self._last = None

    @classmethod
    def default(cls, epsilon: float = 0.2, seed: int = 0) -> "OnlineTuner":
        """Tuner over the full default search space."""
        return cls(list(default_search_space()), epsilon=epsilon, seed=seed)

    def suggest(self) -> tuple[str, str, str]:
        """Pick the next arm: unexplored first, else epsilon-greedy."""
        unexplored = np.where(self._count == 0)[0]
        if len(unexplored) and self._rng.uniform() < 0.8:
            i = int(unexplored[0])
        elif self._rng.uniform() < self.epsilon:
            i = int(self._rng.integers(len(self.arms)))
        else:
            with np.errstate(invalid="ignore"):
                means = np.where(self._count > 0, self._mean, np.inf)
            i = int(np.argmin(means))
        self._last = i
        return self.arms[i]

    def observe(self, wall_time: float) -> None:
        """Reward the last suggested arm with its measured wall time."""
        i = self._last
        if i is None:
            return
        self._count[i] += 1
        self._mean[i] += (wall_time - self._mean[i]) / self._count[i]

    @property
    def best(self) -> tuple[str, str, str]:
        """The arm with the lowest observed mean wall time."""
        means = np.where(self._count > 0, self._mean, np.inf)
        return self.arms[int(np.argmin(means))]

    def as_config(self, combo: tuple[str, str, str], n_workers: int, **kw) -> SchedulerConfig:
        """Materialize a combo into a SchedulerConfig."""
        t, l, v = combo
        return SchedulerConfig(
            technique=t, queue_layout=l, victim_strategy=v, n_workers=n_workers, **kw
        )


# ---------------------------------------------------------------------------
# per-stage selection for pipeline DAGs (the tentpole extension)
# ---------------------------------------------------------------------------

def select_offline_dag(
    dag,
    stage_costs: dict[str, np.ndarray],
    n_workers: int,
    overheads: SimOverheads = SimOverheads(),
    include_ss: bool = False,
    seed: int = 0,
    passes: int = 2,
) -> tuple[dict[str, tuple[str, str, str]], float, dict[tuple, float]]:
    """Per-stage (technique x layout x victim) selection for a PipelineDAG.

    Strategy: score every *uniform* assignment (same combo for all stages)
    with ``simulate_dag`` — that is exactly the best a single global
    SchedulerConfig could do — then coordinate-descend per stage from that
    argmin, accepting only improvements. The result is therefore guaranteed
    no worse than the best single-global-config baseline on the same
    workload, and strictly better whenever stages want different options
    (sparse CC propagation vs its dense convergence check, say).

    Returns (per_stage_assignment, tuned_makespan, uniform_scores) where
    ``uniform_scores`` maps each combo to its uniform-assignment makespan
    (``min(uniform_scores.values())`` is the global-config baseline).

    The DAG simulator models layouts via queue-access overheads but not
    victim order, so the search space is collapsed to unique
    (technique, layout) pairs with victim fixed to SEQ — victim variants
    would score identically and only waste simulations. The baseline is
    unaffected: a victim change can't alter a uniform score either.
    """
    space = list(dict.fromkeys(
        (t, l, "SEQ") for t, l, _ in default_search_space(include_ss)))
    names = dag.stage_names

    def score(assign: dict[str, tuple[str, str, str]]) -> float:
        """Simulated DAG makespan of one per-stage assignment."""
        return simulate_dag(dag, stage_costs, assign, n_workers=n_workers,
                            overheads=overheads, seed=seed).makespan

    uniform = {c: score({n: c for n in names}) for c in space}
    best_combo = min(uniform, key=uniform.get)
    assign = {n: best_combo for n in names}
    best = uniform[best_combo]

    for _ in range(max(1, passes)):
        improved = False
        for n in names:
            for c in space:
                if c == assign[n]:
                    continue
                trial = dict(assign)
                trial[n] = c
                v = score(trial)
                if v < best:
                    best, assign, improved = v, trial, True
        if not improved:
            break
    return assign, best, uniform


def select_offline_device_dag(
    dag,
    stage_costs: dict[str, np.ndarray],
    tile: int = 1,
    n_shards: int = 1,
    overheads: SimOverheads = SimOverheads(),
    include_ss: bool = False,
    seed: int = 0,
    passes: int = 2,
) -> tuple[dict[str, str], float, dict[str, float]]:
    """Per-stage TECHNIQUE selection for the device-DAG path (the walker).

    The device analogue of ``select_offline_dag``: scores assignments with
    ``simulate_dag(frozen=True)`` — the fused-launch super-table replay —
    instead of the host-pool model. Queue layout and victim strategy do
    not exist on device (tables are frozen, stealing is persistent
    re-balancing, ``core/device_schedule.py:rebalance_dag``), so the
    space is the partitioning techniques alone.
    Scores every uniform assignment first, then coordinate-descends per
    stage accepting only improvements, so the result is never worse than
    the best uniform technique. Returns
    (per_stage_techniques, tuned_makespan, uniform_scores).
    """
    techs = [t for t in PARTITIONERS if include_ss or t != "SS"]
    names = dag.stage_names

    def score(assign: dict[str, str]) -> float:
        """Frozen-replay makespan of one per-stage technique assignment."""
        return simulate_dag(dag, stage_costs, assign, overheads=overheads,
                            seed=seed, frozen=True, tile=tile,
                            n_shards=n_shards).makespan

    uniform = {t: score({n: t for n in names}) for t in techs}
    best_tech = min(uniform, key=uniform.get)
    assign = {n: best_tech for n in names}
    best = uniform[best_tech]

    for _ in range(max(1, passes)):
        improved = False
        for n in names:
            for t in techs:
                if t == assign[n]:
                    continue
                trial = dict(assign)
                trial[n] = t
                v = score(trial)
                if v < best:
                    best, assign, improved = v, trial, True
        if not improved:
            break
    return assign, best, uniform


# ---------------------------------------------------------------------------
# heterogeneous placement selection (host pool + device walker)
# ---------------------------------------------------------------------------

def select_offline_hetero(
    dag,
    costs,
    n_workers: int = 20,
    stage_configs: dict | tuple | None = None,
    fractions: tuple[float, ...] = (0.25, 0.5, 0.75),
    passes: int = 2,
    overheads: SimOverheads = SimOverheads(),
    seed: int = 0,
):
    """Offline substrate placement: the placement counterpart of the
    dag/device searches.

    Thin entry point over ``core/placement.py:select_placement``: scores
    the all-HOST and all-DEVICE baselines with ``simulate_hetero_dag``,
    then coordinate-descends per stage over {HOST, DEVICE, SPLIT(f)}
    accepting only improvements — so the returned placement is never
    worse than min(host-only, device-only) by construction. ``costs`` is a
    ``HeteroCostModel`` (see ``calibrate_hetero_costs``) or a plain
    per-row dict applied to both substrates. Returns
    ``(placement, makespan, baselines)``.
    """
    from .placement import select_placement

    return select_placement(
        dag, costs, n_workers=n_workers, stage_configs=stage_configs,
        fractions=fractions, passes=passes, overheads=overheads, seed=seed)


def tune_online_hetero(
    dag,
    costs,
    n_workers: int = 20,
    rounds: int = 40,
    selector: str = "ucb",
    arms: list[tuple[str, str, str, str]] | None = None,
    include_ss: bool = False,
    overheads: SimOverheads = SimOverheads(),
    seed: int = 0,
    online: OnlineScheduler | None = None,
) -> OnlineTuneResult:
    """ONLINE substrate placement: bandit arms extended with WHERE to run.

    The closed-loop counterpart of ``select_offline_hetero``: trains an
    OnlineScheduler whose per-stage arms are
    ``(technique, layout, victim, substrate)`` 4-tuples
    (``default_hetero_arms``) over ``rounds`` virtual-time co-execution
    replays (``replay_online_hetero``); each stage's realized span
    rewards its arm, so the bandit learns the stage's substrate affinity
    together with its chunking. Returns an OnlineTuneResult whose
    ``assign`` maps stages to the converged 4-tuple arms and whose
    ``makespan`` is the final placement's simulated co-execution
    makespan. Moldable resizing is disabled (placement replays do not
    re-chunk mid-run).
    """
    from .online import default_hetero_arms
    from .placement import (DEVICE, HOST, Placement, StagePlacement,
                            replay_online_hetero, simulate_hetero_dag)

    if online is None:
        online = OnlineScheduler(
            selector=selector,
            arms=arms if arms is not None else default_hetero_arms(include_ss),
            resize=False, seed=seed)
    history = replay_online_hetero(
        dag, costs, online, rounds=rounds, n_workers=n_workers,
        overheads=overheads, seed=seed)
    assign = online.best_combos(list(dag.stage_names))
    placement = Placement({
        n: StagePlacement(DEVICE if c[3] == DEVICE else HOST)
        for n, c in assign.items()})
    final = simulate_hetero_dag(
        dag, costs, placement,
        stage_configs={n: c[:3] for n, c in assign.items()},
        n_workers=n_workers, overheads=overheads, seed=seed).makespan
    return OnlineTuneResult(assign, final, history, online)


# ---------------------------------------------------------------------------
# per-job selection under contention (multi-tenant serving)
# ---------------------------------------------------------------------------

def select_offline_server(
    jobs,
    n_workers: int,
    arbiter="fair",
    objective: str = "p99",
    overheads: SimOverheads = SimOverheads(),
    include_ss: bool = False,
    seed: int = 0,
    passes: int = 1,
):
    """Per-job, per-stage scheduling selection under inter-job contention.

    Each job tuned in isolation (``select_offline_dag``) ignores that it
    shares the pool: a combo that wins alone can lose under contention
    (e.g. SS-like fine chunks amplify queue traffic exactly when other
    jobs keep every worker busy). This search scores full serving replays:

    1. Seed every job with its isolated ``select_offline_dag`` assignment
       — the contention-blind baseline.
    2. Coordinate-descend over (job, stage) pairs, re-simulating the whole
       mixed workload with ``simulate_server`` under ``arbiter`` and
       accepting a combo only when it improves ``objective``.

    ``objective`` is ``"p99"`` / ``"p50"`` (percentile of per-job latency),
    ``"mean"`` (mean latency), or ``"makespan"``. Returns
    ``(per_job_assignment, tuned_score, baseline_score)`` where the
    assignment maps job name -> {stage -> (technique, layout, victim)};
    the tuned score is never worse than the baseline by construction.
    """
    from .server import job_stage_costs

    def measure(res):
        """Extract the objective value from a ServerSimResult."""
        if objective == "makespan":
            return res.makespan
        if objective == "mean":
            return float(np.mean(list(res.job_latency.values())))
        if objective in ("p50", "p99"):
            return res.latency_percentile(float(objective[1:]))
        raise ValueError(f"unknown objective {objective!r}")

    def score(assign):
        """Objective of one per-job assignment under the full mixed replay."""
        staged = [dataclasses.replace(j, per_stage=dict(assign[j.name]))
                  for j in jobs]
        return measure(simulate_server(
            staged, n_workers=n_workers, arbiter=arbiter,
            overheads=overheads, seed=seed))

    space = list(dict.fromkeys(
        (t, l, "SEQ") for t, l, _ in default_search_space(include_ss)))
    assign = {}
    for j in jobs:
        iso, _, _ = select_offline_dag(
            j.dag, job_stage_costs(j), n_workers=n_workers,
            overheads=overheads, include_ss=include_ss, seed=seed, passes=1)
        assign[j.name] = iso
    baseline = best = score(assign)

    for _ in range(max(1, passes)):
        improved = False
        for j in jobs:
            for stage_name in j.dag.stage_names:
                for c in space:
                    if c == assign[j.name][stage_name]:
                        continue
                    trial = {n: dict(a) for n, a in assign.items()}
                    trial[j.name][stage_name] = c
                    v = score(trial)
                    if v < best:
                        best, assign, improved = v, trial, True
        if not improved:
            break
    return assign, best, baseline


@dataclass
class OnlineTuneResult:
    """Outcome of one ``tune_online_dag`` feedback-loop run.

    ``assign`` is the converged per-stage combo map, ``makespan`` its
    simulated makespan (the "online-tuned" number the CI gate compares
    against the offline search), ``history`` the per-round OnlineRound
    records, and ``online`` the trained OnlineScheduler — hand it to a
    PipelineExecutor to keep learning on the real pool.
    """

    assign: dict[str, tuple[str, str, str]]
    makespan: float
    history: list
    online: OnlineScheduler


def tune_online_dag(
    dag,
    stage_costs: dict[str, np.ndarray],
    n_workers: int,
    rounds: int = 40,
    selector: str = "ucb",
    arms: list[tuple[str, str, str]] | None = None,
    include_ss: bool = False,
    resize: bool = True,
    overheads: SimOverheads = SimOverheads(),
    seed: int = 0,
    online: OnlineScheduler | None = None,
) -> OnlineTuneResult:
    """ONLINE per-stage selection: the closed-loop counterpart of
    ``select_offline_dag``.

    Where the offline search sweeps every combo against the cost model up
    front, this entry point trains a core.online.OnlineScheduler by
    actually *running* the DAG ``rounds`` times in virtual time
    (``replay_online_dag``): each round the per-stage bandits pick combos,
    the replay feeds chunk observations (and moldable resizes) back, and
    the stage spans reward the bandits. Converges to within the bandit's
    regret of the best static technique without ever enumerating the
    space — the mode that works when the workload drifts or the cost
    model lies. Pass ``online`` to continue training an existing
    scheduler (e.g. one already warmed on the real pool).
    """
    if online is None:
        online = OnlineScheduler(
            selector=selector,
            arms=arms if arms is not None else default_online_arms(include_ss),
            resize=resize, seed=seed)
    history = replay_online_dag(
        dag, stage_costs, online, rounds=rounds, n_workers=n_workers,
        overheads=overheads, seed=seed)
    assign = online.best_combos(list(dag.stage_names))
    final = simulate_dag(dag, stage_costs, assign, n_workers=n_workers,
                         overheads=overheads, seed=seed).makespan
    return OnlineTuneResult(assign, final, history, online)


@dataclass
class DagTuner:
    """Per-stage epsilon-greedy tuner for iterative pipeline DAGs.

    One OnlineTuner arm-set per stage, trained coordinate-wise: each
    ``suggest``/``observe`` round lets ONE focus stage deviate (explore)
    while the others play their current best, so the shared reward (the
    DAG wall time) is attributable to the deviating stage. The focus
    rotates round-robin across stages.
    """

    stage_names: list[str]
    epsilon: float = 0.2
    seed: int = 0

    def __post_init__(self):
        self._tuners = {
            n: OnlineTuner.default(epsilon=self.epsilon, seed=self.seed + i)
            for i, n in enumerate(self.stage_names)
        }
        self._round = 0
        self._focus: str | None = None

    @classmethod
    def for_dag(cls, dag, epsilon: float = 0.2, seed: int = 0) -> "DagTuner":
        """Build a tuner with one arm-set per stage of ``dag``."""
        return cls(list(dag.stage_names), epsilon=epsilon, seed=seed)

    def suggest(self) -> dict[str, tuple[str, str, str]]:
        """Per-stage combos: the focus stage explores, the rest exploit."""
        self._focus = self.stage_names[self._round % len(self.stage_names)]
        self._round += 1
        out = {}
        for n, t in self._tuners.items():
            if n == self._focus:
                out[n] = t.suggest()
            else:
                explored = int(t._count.sum()) > 0
                out[n] = t.best if explored else t.suggest()
        return out

    def observe(self, wall_time: float) -> None:
        """Attribute the DAG wall time to the deviating focus stage."""
        if self._focus is not None:
            self._tuners[self._focus].observe(wall_time)

    @property
    def best(self) -> dict[str, tuple[str, str, str]]:
        """Current best combo per stage."""
        return {n: t.best for n, t in self._tuners.items()}
