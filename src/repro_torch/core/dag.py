"""Pipeline-DAG data model: stages joined by data dependencies.

The paper schedules *integrated data analysis pipelines* — multi-stage
DM+HPC+ML workloads. A ``Stage`` is an operator over its own row range; a
``PipelineDAG`` is a validated, topologically ordered graph of stages.
``core/device_schedule.py:build_dag_tables`` freezes such a graph into
per-shard super-tables for the walker kernel.

Dependency kinds (``StageDep.kind``):

  ``full``         the consumer needs the producer's combined value; its
                   chunks become runnable only when the producer finishes.
  ``elementwise``  consumer rows [s, s+z) need only producer rows [s, s+z);
                   the producer must be row-shaped (combine='concat') with
                   the same row count. This is the streaming edge.

Stage ops have signature ``op(inputs, start, size)`` where ``inputs`` maps
each producer name to its output.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = ["DEP_FULL", "DEP_ELEMENTWISE", "Stage", "StageDep", "PipelineDAG"]

DEP_FULL = "full"
DEP_ELEMENTWISE = "elementwise"


@dataclass(frozen=True)
class StageDep:
    """A data dependency on ``producer``; see module docstring for kinds."""

    producer: str
    kind: str = DEP_FULL

    def __post_init__(self):
        if self.kind not in (DEP_FULL, DEP_ELEMENTWISE):
            raise ValueError(f"unknown dep kind {self.kind!r}")


@dataclass(frozen=True)
class Stage:
    """An operator with its own task range, cost model, and scheduler config.

    ``combine`` is 'concat' (partials are row blocks of an (n_rows, ...)
    output) or 'sum' (partials are additive reductions). Only 'concat'
    stages can be elementwise producers. ``config`` is the stage's
    scheduler configuration, opaque to the data model.
    """

    name: str
    n_rows: int
    op: Callable[[dict, int, int], Any] = field(compare=False, repr=False)
    combine: str = "concat"
    deps: tuple[StageDep, ...] = ()
    config: Any = None
    cost_of_range: Callable[[int, int], float] | None = field(
        compare=False, repr=False, default=None)

    def __post_init__(self):
        if self.combine not in ("concat", "sum"):
            raise ValueError(f"unknown combine {self.combine!r}")
        if self.n_rows < 0:
            raise ValueError("n_rows must be >= 0")


class PipelineDAG:
    """Validated, topologically-ordered stage graph."""

    def __init__(self, stages: list[Stage]):
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names in {names}")
        self.stages: dict[str, Stage] = {s.name: s for s in stages}
        for s in stages:
            for d in s.deps:
                if d.producer not in self.stages:
                    raise ValueError(
                        f"stage {s.name!r} depends on unknown stage {d.producer!r}")
                prod = self.stages[d.producer]
                if d.kind == DEP_ELEMENTWISE:
                    if prod.combine != "concat":
                        raise ValueError(
                            f"elementwise dep {s.name!r}->{d.producer!r} needs a "
                            f"'concat' producer, got {prod.combine!r}")
                    if prod.n_rows != s.n_rows:
                        raise ValueError(
                            f"elementwise dep {s.name!r}->{d.producer!r} needs equal "
                            f"row counts ({s.n_rows} vs {prod.n_rows})")
        self.order: list[str] = self._toposort(stages)

    @staticmethod
    def _toposort(stages: list[Stage]) -> list[str]:
        indeg = {s.name: len(s.deps) for s in stages}
        consumers: dict[str, list[str]] = {s.name: [] for s in stages}
        for s in stages:
            for d in s.deps:
                consumers[d.producer].append(s.name)
        ready = deque(s.name for s in stages if indeg[s.name] == 0)
        order = []
        while ready:
            n = ready.popleft()
            order.append(n)
            for c in consumers[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(stages):
            cyc = sorted(n for n, d in indeg.items() if d > 0)
            raise ValueError(f"dependency cycle through stages {cyc}")
        return order

    @property
    def stage_names(self) -> list[str]:
        """Stage names in topological order."""
        return list(self.order)
