"""Lowering toolkit: express arbitrary step computations as PipelineDAGs.

DESIGN.md §17. The vee apps hand-build their DAGs; real workloads (a
transformer forward step, MoE expert dispatch, a serving pair) share a
small set of shapes that this module packages model-agnostically:

  ``row_stage``    a concat Stage whose op maps a per-row function over
                   its chunk — the unit every lowering reduces to. Row
                   functions see only their own row (plus dep rows), so
                   the stage output is bit-identical under ANY chunking,
                   layout, worker count, stealing, or moldable resize:
                   disjoint buffer writes commute. This is the
                   bit-equality contract the model zoo relies on.
  ``chain_dag``    a linear stage chain joined by elementwise streaming
                   edges — e.g. embed -> N x block -> head over a batch.
  ``fanout_stage`` an irregular fan-out stage whose rows are *groups*
                   with data-dependent sizes (MoE experts with router
                   token counts); ``cost_of_range`` exposes the skew to
                   the partitioners, bandits, and moldable resizer.
  ``run_direct``   the unscheduled oracle: execute the same stage ops
                   serially in topological order. Because scheduled and
                   direct paths call the SAME per-row functions, equality
                   is exact (bit-wise), not approximate.
  ``Lowered``      the bundle handed to callers: dag + per-row virtual
                   stage costs + finalize, with §14 ``Submission``
                   construction and a one-call ``run``.

Per-row functions must use fixed shapes (batch-1 / fixed capacity):
PyTorch picks its reduction order by shape, so only "same function, same
shapes, same inputs" means "same bits" (DESIGN.md §11). The port's copy of
``core/lower.py``; the code is the reference's, line for line.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import field
from typing import Any, Callable

import numpy as np

from .dag import DEP_ELEMENTWISE, PipelineDAG, PipelineExecutor, Stage, StageDep
from .registry import make_config
from .submit import Submission

__all__ = [
    "Lowered", "row_stage", "chain_dag", "fanout_stage",
    "costs_from_sizes", "run_direct", "measure_stage_costs",
]


def row_stage(
    name: str,
    fn: Callable[[dict, int], Any],
    n_rows: int,
    deps: tuple[StageDep, ...] = (),
    config=None,
    cost_of_range: Callable[[int, int], float] | None = None,
) -> Stage:
    """A concat Stage mapping ``fn(row_inputs, r) -> row`` over its chunk.

    ``row_inputs`` maps each producer name to its row ``r`` (elementwise
    deps) or its full combined value (full deps). Rows are stacked into
    the ``(size, ...)`` block the concat combiner expects, so the stage
    value is independent of how the scheduler chunked it.
    """
    deps = tuple(deps)

    def op(inputs, s, z):
        rows = []
        for r in range(s, s + z):
            ri = {d.producer: (inputs[d.producer][r]
                               if d.kind == DEP_ELEMENTWISE
                               else inputs[d.producer]) for d in deps}
            rows.append(np.asarray(fn(ri, r)))
        return np.stack(rows)

    return Stage(name, n_rows, op, combine="concat", deps=deps,
                 config=config, cost_of_range=cost_of_range)


def chain_dag(n_rows: int, steps: list[tuple[str, Callable]]) -> PipelineDAG:
    """A linear chain of row stages joined by elementwise streaming edges.

    ``steps`` is ``[(name, row_fn), ...]``; the first stage's ``row_fn``
    receives ``(prev_row=None, r)``, later stages receive the previous
    stage's row ``r``. Streaming edges let a completed producer chunk
    unlock the overlapping consumer chunks before the stage barrier, so
    the whole chain pipelines over the row dimension.
    """
    if not steps:
        raise ValueError("chain_dag needs at least one step")
    stages = []
    prev = None
    for name, fn in steps:
        deps = (StageDep(prev, DEP_ELEMENTWISE),) if prev is not None else ()

        def rf(ins, r, _fn=fn, _prev=prev):
            return _fn(None if _prev is None else ins[_prev], r)

        stages.append(row_stage(name, rf, n_rows, deps=deps))
        prev = name
    return PipelineDAG(stages)


def costs_from_sizes(sizes, per_unit: float = 1.0, base: float = 1.0) -> np.ndarray:
    """Per-row virtual cost vector for group rows: ``base + per_unit*size``."""
    sizes = np.asarray(sizes, np.float64)
    return base + per_unit * sizes


def fanout_stage(
    name: str,
    group_fn: Callable[[dict, int], Any],
    group_sizes,
    deps: tuple[StageDep, ...] = (),
    config=None,
) -> Stage:
    """An irregular fan-out stage: one row per *group*, sized by data.

    ``group_sizes[g]`` is the amount of work behind group ``g`` (e.g. the
    router's token count for expert ``g``); ``cost_of_range`` sums it so
    the partitioners and the §12 resizer see the skew instead of assuming
    uniform rows. ``group_fn(inputs, g)`` must return a fixed-shape row
    (fixed capacity) so chunks stack.
    """
    sizes = np.asarray(group_sizes, np.float64)

    def cost_of_range(s, z):
        return float(sizes[s:s + z].sum() + z)

    return row_stage(name, group_fn, len(sizes), deps=deps, config=config,
                     cost_of_range=cost_of_range)


def run_direct(dag: PipelineDAG) -> dict[str, Any]:
    """The unscheduled oracle: run every stage op serially, in topo order.

    One ``op(inputs, 0, n_rows)`` call per stage — no pool, no chunking,
    no stealing. Because the scheduled path calls the same ops over
    disjoint sub-ranges and row ops are row-independent, concat stage
    values here are bit-identical to any scheduled run's.
    """
    values: dict[str, Any] = {}
    for name in dag.stage_names:
        stage = dag.stages[name]
        inputs = {d.producer: values[d.producer] for d in stage.deps}
        values[name] = stage.op(inputs, 0, stage.n_rows)
    return values


def measure_stage_costs(
    dag: PipelineDAG, repeats: int = 1, sample: int | None = None,
) -> dict[str, np.ndarray]:
    """Measured per-row wall-clock cost vectors (seconds) for every stage.

    Runs the DAG serially once (the direct oracle) to obtain real inputs,
    then times ``op(inputs, r, 1)`` per row — ``sample`` rows evenly
    spaced (default: all), other rows interpolated from the sampled mean.
    Feeds ``select_placement`` / ``tune_online_dag`` with costs that came
    from the actual computation rather than a guess.
    """
    values: dict[str, Any] = {}
    costs: dict[str, np.ndarray] = {}
    for name in dag.stage_names:
        stage = dag.stages[name]
        inputs = {d.producer: values[d.producer] for d in stage.deps}
        values[name] = stage.op(inputs, 0, stage.n_rows)  # warm + real inputs
        n = stage.n_rows
        idx = (range(n) if sample is None or sample >= n
               else np.linspace(0, n - 1, sample).astype(int))
        vec = np.zeros(n, np.float64)
        seen = np.zeros(n, bool)
        for r in idx:
            t0 = time.perf_counter()
            for _ in range(repeats):
                stage.op(inputs, int(r), 1)
            vec[r] = (time.perf_counter() - t0) / max(1, repeats)
            seen[r] = True
        if not seen.all():
            vec[~seen] = vec[seen].mean()
        costs[name] = vec
    return costs


@dataclasses.dataclass
class Lowered:
    """A computation lowered onto the scheduler (DESIGN.md §17).

    ``stage_costs`` are per-row virtual cost vectors (simulator units)
    capturing the *shape* of the work — e.g. router token counts for an
    MoE fan-out; ``finalize`` maps the DAG's stage values to the
    computation's answer; ``meta`` carries lowering-specific context
    (params, inputs, routing plans) for oracles and device lowerings.
    """

    dag: PipelineDAG
    stage_costs: dict[str, np.ndarray] = field(default_factory=dict)
    finalize: Callable[[dict], Any] | None = None
    meta: dict = field(default_factory=dict)

    def submission(self, name: str = "job", **overrides) -> Submission:
        """A §14 Submission carrying this lowering's dag + stage costs."""
        kw = {"stage_costs": self.stage_costs or None}
        kw.update(overrides)
        return Submission(dag=self.dag, name=name, **kw)

    def run(self, config="gss", per_stage=None, online=None, name="job",
            **kwargs):
        """Execute on a real pool; returns ``(finalized value, DagResult)``.

        ``config`` is a ``make_config`` spec (or SchedulerConfig);
        ``kwargs`` (``n_workers``, ``seed``, ...) shape the pool.
        """
        cfg = make_config(config, **kwargs)
        sub = self.submission(name=name, per_stage=per_stage, online=online)
        res = PipelineExecutor(self.dag, cfg).run(sub)
        return self.value(res.values), res

    def run_direct(self):
        """The unscheduled oracle value (see ``run_direct``)."""
        return self.value(run_direct(self.dag))

    def value(self, values: dict):
        """Finalize stage ``values`` (identity on the dict if no finalize)."""
        return self.finalize(values) if self.finalize is not None else values
