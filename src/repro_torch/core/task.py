"""Task abstractions.

In DAPHNE a *task* combines an operator with the data items it applies to;
task granularity is the size of that data (paper §2 Terminology). Since the
current DAPHNE engine exploits data parallelism over matrix rows, our task is
an operator applied to a contiguous row range — ``RangeTask``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(frozen=True)
class RangeTask:
    """An operator applied to rows [start, start+size) of the pipeline input.

    ``op`` receives (start, size) and returns the partial result; the VEE
    combines partials. ``cost_hint`` carries an optional a-priori cost
    estimate (e.g. nnz in the row range) used by the simulator and by
    locality-aware assignment.
    """

    task_id: int
    start: int
    size: int
    op: Callable[[int, int], Any] = field(compare=False, repr=False, default=None)
    cost_hint: float = field(compare=False, default=0.0)

    def run(self) -> Any:
        """Execute the operator on this task's row range."""
        return self.op(self.start, self.size)


def tasks_from_schedule(schedule, op, cost_of_range=None) -> list[RangeTask]:
    """Build RangeTasks from a ``(n_chunks, 2)`` (start, size) schedule."""
    out = []
    for i, (start, size) in enumerate(schedule):
        cost = float(cost_of_range(int(start), int(size))) if cost_of_range else float(size)
        out.append(RangeTask(i, int(start), int(size), op, cost))
    return out
