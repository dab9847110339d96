"""Online adaptive scheduling: the runtime feedback loop.

The port's copy of the reference's feedback loop (``repro/core/online.py``);
``default_hetero_arms`` extends the arms with the substrate choice:

  ``ChunkObservation``  one completed chunk: (stage, range, measured cost).
  ``FeedbackLog``       thread-safe streaming statistics per stage —
                        chunk counts, per-row rate mean/variance (Welford),
                        the dispersion signal the resizer keys on.
  ``UCB1Selector``      deterministic UCB1 bandit over scheduling combos;
  ``EXP3Selector``      adversarial-regret EXP3 (seeded, reproducible).
                        Arms are (technique, layout, victim) combos — by
                        default the 11 partitioners x 3 assignment layouts.
  ``OnlineScheduler``   the closed loop: a per-stage bandit that re-picks a
                        stage's SchedulerConfig each scheduling round, plus
                        *moldable chunk resizing* — when the observed
                        per-row cost dispersion says the static partitioner
                        guessed wrong, the not-yet-popped remainder of a
                        stage's schedule is re-chunked mid-run (finer under
                        high variance, coarser when overhead-bound).

Integration points (all feed the same OnlineScheduler object):

  * ``core/executor.py``: ``ScheduledExecutor(cfg, observer=...)`` streams
    every completed task through the worker ``record`` path.
  * ``core/dag.py``: ``PipelineExecutor(dag, cfg).run(Submission(online=...))``
    consults the bandit per stage per run and resizes stage remainders
    mid-run.
  * ``replay_online_dag``: the same loop over ``simulate_dag`` rounds in
    virtual time (core/simulator.py), deterministic given the seeds.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

import numpy as np

from .partitioners import PARTITIONERS

__all__ = [
    "ChunkObservation", "StageFeedback", "FeedbackLog", "OnlineChoice",
    "BanditSelector", "UCB1Selector", "EXP3Selector", "SELECTORS",
    "OnlineScheduler", "default_online_arms", "default_hetero_arms",
    "rechunk_pending",
    "OnlineRound", "replay_online_dag",
]

_LAYOUTS = ("CENTRALIZED", "PERCORE", "PERGROUP")


def default_online_arms(include_ss: bool = True) -> list[tuple[str, str, str]]:
    """The bandit's arm set: 11 partitioners x 3 assignment layouts.

    Victim strategy is fixed to SEQ — the virtual-time replay that trains
    selectors cannot distinguish victim orders (see select_offline_dag), so
    extra victim arms would only slow exploration. ``include_ss=False``
    drops the pathological chunk=1 technique for faster convergence.
    """
    techs = [t for t in PARTITIONERS if include_ss or t != "SS"]
    return [(t, l, "SEQ") for t in techs for l in _LAYOUTS]


def default_hetero_arms(
    include_ss: bool = True,
) -> list[tuple[str, str, str, str]]:
    """Bandit arms extended with the SUBSTRATE choice.

    Each arm is ``(technique, layout, victim, substrate)``: the host arms
    are ``default_online_arms`` tagged "host"; the device arms carry one
    entry per technique (queue layout and victim strategy do not exist on
    the frozen device walker, so extra device arms would only slow
    exploration). ``placement.replay_online_hetero`` /
    ``autotune.tune_online_hetero`` play them — the per-stage bandit learns
    WHERE a stage runs along with how it is chunked.
    """
    techs = [t for t in PARTITIONERS if include_ss or t != "SS"]
    host = [(t, l, "SEQ", "host") for t in techs for l in _LAYOUTS]
    device = [(t, "CENTRALIZED", "SEQ", "device") for t in techs]
    return host + device


@dataclass(frozen=True)
class ChunkObservation:
    """One executed chunk as seen by the feedback loop."""

    stage: str
    task_id: int
    start: int
    size: int
    cost_s: float
    worker: int = 0
    t_end: float = 0.0


class StageFeedback:
    """Streaming per-stage chunk statistics over per-row rates.

    The rate mean/variance are *exponentially weighted* (``decay`` is the
    EW step), so a long-lived scheduler tracks the current workload
    instead of averaging over everything it ever saw — when the skew
    drifts, the CV follows within ~1/decay chunks. Until 1/decay chunks
    have been seen the estimate is the exact running mean/variance
    (Welford), so short runs aren't biased toward the init value.
    """

    __slots__ = ("n", "rows", "total_s", "decay", "_mean", "_var")

    def __init__(self, decay: float = 0.05):
        self.n = 0          # chunks observed (lifetime)
        self.rows = 0       # rows covered by those chunks
        self.total_s = 0.0  # summed chunk cost
        self.decay = decay
        self._mean = 0.0    # EW mean of per-row rate (s/row)
        self._var = 0.0     # EW variance of per-row rate

    def add(self, obs: ChunkObservation) -> None:
        """Fold one chunk observation in."""
        self.add_raw(obs.size, obs.cost_s)

    def add_raw(self, size: int, cost_s: float) -> None:
        """Fold one chunk in from its raw (size, cost) — the statistics
        only ever read those two fields, so hot paths can skip building
        a ChunkObservation per chunk (DESIGN.md §16)."""
        rate = cost_s / max(1, size)
        self.n += 1
        self.rows += size
        self.total_s += cost_s
        a = max(self.decay, 1.0 / self.n)  # exact stats until the window fills
        d = rate - self._mean
        self._mean += a * d
        self._var = (1.0 - a) * (self._var + a * d * d)

    @property
    def rate_mean(self) -> float:
        """Windowed mean of the observed per-row cost (seconds/row)."""
        return self._mean

    @property
    def rate_std(self) -> float:
        """Windowed standard deviation of per-row cost across chunks."""
        return math.sqrt(max(self._var, 0.0)) if self.n > 1 else 0.0

    @property
    def cv(self) -> float:
        """Coefficient of variation of per-row chunk rates (0 = uniform)."""
        return self.rate_std / self._mean if self._mean > 0 else 0.0


class FeedbackLog:
    """Thread-safe map of stage name -> StageFeedback."""

    def __init__(self):
        self.stages: dict[str, StageFeedback] = {}
        self._lock = threading.Lock()

    def record(self, obs: ChunkObservation) -> None:
        """Fold one observation into its stage's statistics."""
        self.record_raw(obs.stage, obs.size, obs.cost_s)

    def record_raw(self, stage: str, size: int, cost_s: float) -> None:
        """Allocation-free record: fold raw (size, cost) into ``stage``'s
        statistics without a ChunkObservation object on the hot path."""
        with self._lock:
            fb = self.stages.get(stage)
            if fb is None:
                fb = self.stages[stage] = StageFeedback()
            fb.add_raw(size, cost_s)

    def stage(self, name: str) -> StageFeedback | None:
        """The statistics collected for ``name`` so far (None if nothing)."""
        with self._lock:
            return self.stages.get(name)


@dataclass(frozen=True)
class OnlineChoice:
    """One bandit consultation: which arm a stage plays this round.

    Returned by ``OnlineScheduler.suggest`` and handed back to ``observe``
    with the realized cost, so concurrent consultations (many server jobs
    sharing one selector) attribute rewards to the right arm. ``prob`` is
    the draw probability (EXP3's importance weight; 1.0 for UCB).
    """

    stage: str
    arm: int
    combo: tuple[str, str, str]
    prob: float = 1.0


class BanditSelector:
    """Base bandit over scheduling combos; rewards are COSTS (lower wins)."""

    def __init__(self, arms: list[tuple[str, str, str]], seed: int = 0):
        if not arms:
            raise ValueError("bandit needs at least one arm")
        self.arms = list(arms)
        self.seed = seed
        self.counts = np.zeros(len(arms), dtype=int)
        self.means = np.zeros(len(arms))   # mean observed cost per arm
        self.t = 0                         # total observations
        self.min_cost = math.inf           # normalization scale

    def suggest(self) -> tuple[int, float]:
        """Pick the next arm; returns (arm index, draw probability)."""
        raise NotImplementedError

    def observe(self, arm: int, cost_s: float, prob: float = 1.0) -> None:
        """Credit ``arm`` with a realized cost (seconds; lower is better)."""
        cost = max(float(cost_s), 1e-12)
        self.t += 1
        self.counts[arm] += 1
        self.means[arm] += (cost - self.means[arm]) / self.counts[arm]
        self.min_cost = min(self.min_cost, cost)
        self._after_observe(arm, cost, prob)

    def _after_observe(self, arm: int, cost: float, prob: float) -> None:
        pass

    def _reward(self, cost: float) -> float:
        """Normalize a cost into a (0, 1] reward (1 = best seen so far)."""
        return self.min_cost / max(cost, 1e-12)

    @property
    def best(self) -> tuple[str, str, str]:
        """The arm with the lowest mean observed cost (ties: lowest index)."""
        if not self.counts.any():
            return self.arms[0]
        means = np.where(self.counts > 0, self.means, np.inf)
        return self.arms[int(np.argmin(means))]


class UCB1Selector(BanditSelector):
    """Deterministic UCB1: optimism in the face of unexplored combos.

    Plays every arm once (in index order), then maximizes
    ``reward_mean + c * sqrt(2 ln t / n_arm)`` where rewards are
    min-cost-normalized into (0, 1]. Fully deterministic — no RNG — so
    virtual-time replays reproduce exactly.
    """

    def __init__(self, arms, seed: int = 0, exploration: float = 0.5):
        super().__init__(arms, seed)
        self.exploration = exploration

    def suggest(self) -> tuple[int, float]:
        """Next arm: first unplayed, else the UCB argmax."""
        unplayed = np.where(self.counts == 0)[0]
        if len(unplayed):
            return int(unplayed[0]), 1.0
        rewards = self.min_cost / np.maximum(self.means, 1e-12)
        bonus = self.exploration * np.sqrt(
            2.0 * math.log(max(2, self.t)) / self.counts)
        return int(np.argmax(rewards + bonus)), 1.0


class EXP3Selector(BanditSelector):
    """EXP3 [Auer et al. 2002]: exponential weights, adversarial regret.

    Seeded draws make runs reproducible; ``gamma`` mixes in uniform
    exploration. Rewards are min-cost-normalized and importance-weighted
    by the draw probability handed back through ``observe``.
    """

    def __init__(self, arms, seed: int = 0, gamma: float = 0.15):
        super().__init__(arms, seed)
        self.gamma = gamma
        self._rng = np.random.default_rng(seed)
        self._logw = np.zeros(len(arms))

    def _probs(self) -> np.ndarray:
        w = np.exp(self._logw - self._logw.max())
        k = len(self.arms)
        return (1.0 - self.gamma) * w / w.sum() + self.gamma / k

    def suggest(self) -> tuple[int, float]:
        """Draw an arm from the exponential-weights distribution."""
        p = self._probs()
        arm = int(self._rng.choice(len(self.arms), p=p))
        return arm, float(p[arm])

    def _after_observe(self, arm: int, cost: float, prob: float) -> None:
        r_hat = self._reward(cost) / max(prob, 1e-9)
        self._logw[arm] += self.gamma * r_hat / len(self.arms)


SELECTORS: dict[str, type[BanditSelector]] = {
    "ucb": UCB1Selector,
    "exp3": EXP3Selector,
}


def rechunk_pending(
    pending: list[tuple[int, int]], target: int
) -> list[tuple[int, int]]:
    """Re-chunk not-yet-popped (start, size) chunks to ~``target`` rows each.

    Merges the pending chunks into maximal contiguous row runs (chunks may
    be non-contiguous after out-of-order pops/steals), then splits each run
    into balanced pieces no larger than ``target``. Row coverage is
    preserved exactly; starts come back ascending.
    """
    chunks = sorted((int(s), int(z)) for s, z in pending if z > 0)
    runs: list[tuple[int, int]] = []
    for s, z in chunks:
        if runs and runs[-1][0] + runs[-1][1] == s:
            runs[-1] = (runs[-1][0], runs[-1][1] + z)
        else:
            runs.append((s, z))
    out: list[tuple[int, int]] = []
    target = max(1, int(target))
    for s, z in runs:
        k = max(1, math.ceil(z / target))
        base, extra = divmod(z, k)
        pos = s
        for i in range(k):
            size = base + (1 if i < extra else 0)
            out.append((pos, size))
            pos += size
    return out


class OnlineScheduler:
    """The runtime feedback loop: per-stage bandits + moldable resizing.

    One object serves a whole deployment: PipelineExecutor rounds and
    virtual-time simulate_dag replays all ``suggest``/``record``/``observe``
    against it, so learning transfers across rounds and (in tests)
    simulated rounds.

    Selection: each stage gets its own bandit (``selector`` in SELECTORS)
    over ``arms``; ``suggest(stage)`` returns an OnlineChoice whose combo
    becomes the stage's SchedulerConfig for the round, and
    ``observe(choice, cost)`` feeds back the stage's realized span.

    Moldable resizing: ``record`` streams chunk costs into a FeedbackLog;
    ``plan_resize(stage, pending, n_workers)`` proposes a re-chunking of
    the stage's unpopped remainder when the observed per-row dispersion
    (coefficient of variation) crosses ``cv_split`` — the static guess was
    too coarse for the skew, split finer — or stays under ``cv_merge``
    with many tiny chunks left — uniform work, coalesce to cut queue
    traffic. At most ``max_resizes`` interventions per stage key, so the
    loop cannot thrash.

    All public methods are thread-safe (one internal lock).
    """

    def __init__(
        self,
        selector: str = "ucb",
        arms: list[tuple[str, str, str]] | None = None,
        resize: bool = True,
        cv_split: float = 0.5,
        cv_merge: float = 0.05,
        split_factor: float = 4.0,
        min_observe: int = 3,
        max_resizes: int = 4,
        seed: int = 0,
        selector_kwargs: dict | None = None,
    ):
        if selector not in SELECTORS:
            raise ValueError(
                f"unknown selector {selector!r}; options: {sorted(SELECTORS)}")
        self.selector_name = selector
        self.arms = list(arms) if arms is not None else default_online_arms()
        self.resize = resize
        self.cv_split = cv_split
        self.cv_merge = cv_merge
        self.split_factor = split_factor
        self.min_observe = min_observe
        self.max_resizes = max_resizes
        self.seed = seed
        self._selector_kwargs = dict(selector_kwargs or {})
        self.feedback = FeedbackLog()
        self._selectors: dict[str, BanditSelector] = {}
        self._resizes: dict[str, int] = {}
        self._probes: dict[str, int] = {}  # fb.n at the last allowed probe
        self._lock = threading.RLock()

    # -- selection ----------------------------------------------------------
    def selector_for(self, stage: str) -> BanditSelector:
        """The stage's bandit (created on first consultation)."""
        with self._lock:
            sel = self._selectors.get(stage)
            if sel is None:
                cls = SELECTORS[self.selector_name]
                sel = cls(self.arms, seed=self.seed + 9973 * len(self._selectors),
                          **self._selector_kwargs)
                self._selectors[stage] = sel
            return sel

    def suggest(self, stage: str) -> OnlineChoice:
        """Pick the combo ``stage`` plays next (returns the choice token)."""
        with self._lock:
            sel = self.selector_for(stage)
            arm, prob = sel.suggest()
            return OnlineChoice(stage, arm, sel.arms[arm], prob)

    def observe(self, choice: OnlineChoice, cost_s: float) -> None:
        """Credit a prior ``suggest`` with its realized cost (seconds)."""
        with self._lock:
            self.selector_for(choice.stage).observe(
                choice.arm, cost_s, prob=choice.prob)

    def best_combos(self, stage_names: list[str]) -> dict[str, tuple[str, str, str]]:
        """Current lowest-mean-cost combo per stage."""
        with self._lock:
            return {n: self.selector_for(n).best for n in stage_names}

    # -- feedback + moldable resizing --------------------------------------
    def record(self, obs: ChunkObservation) -> None:
        """Stream one completed chunk into the feedback statistics."""
        self.feedback.record_raw(obs.stage, obs.size, obs.cost_s)

    def record_raw(self, stage: str, size: int, cost_s: float) -> None:
        """Allocation-free variant of ``record`` for executor hot paths."""
        self.feedback.record_raw(stage, size, cost_s)

    def may_resize(self, stage: str, resizes_done: int = 0) -> bool:
        """Cheap pre-check: could ``plan_resize`` possibly act for ``stage``?

        Callers hold their runtime lock while materializing the pending
        chunk list; this O(1) test (budget + evidence + probe throttle)
        lets them skip that work entirely once the stage run's resize
        budget is spent or before enough chunks have been observed.
        ``resizes_done`` is the CURRENT stage run's intervention count
        (``max_resizes`` bounds thrash per run, not per scheduler
        lifetime — later runs get a fresh budget). Probes are throttled
        to one per ``min_observe`` new observations per stage, so a
        fine-grained schedule whose CV sits in the no-action band can't
        pay O(pending) planning work on every chunk completion.
        """
        if not self.resize:
            return False
        with self._lock:
            if resizes_done >= self.max_resizes:
                return False
            fb = self.feedback.stage(stage)
            if fb is None or fb.n < self.min_observe:
                return False
            if fb.n - self._probes.get(stage, 0) < self.min_observe:
                return False
            self._probes[stage] = fb.n
            return True

    def plan_resize(
        self,
        stage: str,
        pending: list[tuple[int, int]],
        n_workers: int,
        resizes_done: int = 0,
    ) -> list[tuple[int, int]] | None:
        """Propose a re-chunking of ``pending`` (unpopped) chunks, or None.

        ``pending`` holds (start, size) pairs not yet handed to a worker;
        the return value covers exactly the same rows. None means "leave
        the schedule alone" — not enough evidence, this stage run's
        ``max_resizes`` budget exhausted (``resizes_done``), or the
        observed dispersion doesn't warrant intervention.
        """
        if not self.resize:
            return None
        with self._lock:
            if resizes_done >= self.max_resizes:
                return None
            fb = self.feedback.stage(stage)
            if fb is None or fb.n < self.min_observe:
                return None
            sizes = [int(z) for _, z in pending if z > 0]
            if not sizes:
                return None
            total = sum(sizes)
            cv = fb.cv
            if cv > self.cv_split:
                # skewed rows: split the remainder finer so stragglers
                # can't hide a hot range inside one huge chunk
                target = max(1, math.ceil(total / (self.split_factor * n_workers)))
                if max(sizes) < 2 * target:
                    return None
            elif cv < self.cv_merge:
                # uniform rows: coalesce chunk dust into ~2P pieces to cut
                # queue traffic (the paper's SS-explodes effect)
                target = max(1, math.ceil(total / (2 * n_workers)))
                if len(sizes) <= 2 * n_workers or target < 2 * max(sizes):
                    return None
            else:
                return None
            new = rechunk_pending(pending, target)
            if [z for _, z in new] == sizes:
                return None
            self._resizes[stage] = self._resizes.get(stage, 0) + 1
            return new

    @property
    def resizes(self) -> dict[str, int]:
        """Lifetime count of remainder re-chunks per stage (reporting)."""
        with self._lock:
            return dict(self._resizes)


# ---------------------------------------------------------------------------
# deterministic round-based replay (convergence harness)
# ---------------------------------------------------------------------------

@dataclass
class OnlineRound:
    """One scheduling round of a replay: combos played and the outcome."""

    combos: dict[str, tuple[str, str, str]]
    makespan: float
    stage_span: dict[str, float] = field(default_factory=dict)


def replay_online_dag(
    dag,
    stage_costs: dict[str, np.ndarray],
    online: OnlineScheduler,
    rounds: int,
    n_workers: int = 20,
    overheads=None,
    seed: int = 0,
    resize_in_sim: bool = True,
) -> list[OnlineRound]:
    """Train ``online`` on ``rounds`` virtual-time replays of one DAG.

    Each round consults the bandit per stage, replays the DAG with
    ``simulate_dag`` under the chosen combos (feeding chunk observations —
    and moldable resizes, when ``resize_in_sim`` — through the same online
    object the real pool would), then credits each stage's bandit with the
    stage's realized span. Deterministic given the selector seeds, so the
    convergence property tests replay exactly.
    """
    from .simulator import SimOverheads, simulate_dag

    ov = overheads if overheads is not None else SimOverheads()
    history: list[OnlineRound] = []
    names = list(dag.stage_names)
    for _ in range(max(1, rounds)):
        choices = {n: online.suggest(n) for n in names}
        res = simulate_dag(
            dag, stage_costs, {n: c.combo for n, c in choices.items()},
            n_workers=n_workers, overheads=ov, seed=seed,
            online=online if resize_in_sim else None)
        spans = {}
        for n, c in choices.items():
            span = max(0.0, res.stage_finish[n] - res.stage_start[n])
            spans[n] = span
            # per-ROW reward, matching the real executor/server paths
            rows = max(1, dag.stages[n].n_rows)
            online.observe(c, (span if span > 0 else res.makespan) / rows)
        history.append(OnlineRound(
            {n: c.combo for n, c in choices.items()}, res.makespan, spans))
    return history
