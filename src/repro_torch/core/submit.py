"""The submission surface: one record for what is being submitted.

Every knob that describes WHAT is being submitted — the DAG, its
tenant/priority/deadline metadata, per-stage overrides, an optional
placement, an optional online scheduler — rides on ONE record,
``Submission``, which ``PipelineExecutor.run`` accepts. The port's copy of
the reference's ``core/submit.py``; the serving record (``Job``) and its
bridge are not part of the port yet, so ``as_submission`` takes a
``Submission`` and nothing else.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = ["Submission", "as_submission"]


@dataclass(frozen=True)
class Submission:
    """One unit of work for an execution surface.

    ``dag`` may be None when the target executor was constructed with
    the DAG already (``PipelineExecutor(dag, cfg).run(Submission())``).
    ``per_stage`` / ``online`` / ``placement`` travel with the submission
    instead of the executor: the same pool object can run submissions
    with different overrides. ``tenant``/``weight``/``priority``/
    ``arrival_s``/``deadline_s`` are the serving metadata (weight drives
    weighted-fair sharing, ``deadline_s`` is relative to arrival);
    ``stage_costs`` carries per-row cost estimates.
    """

    dag: Any = None
    name: str = "job"
    tenant: str = "default"
    priority: int = 0
    weight: float = 1.0
    arrival_s: float = 0.0
    deadline_s: float | None = None
    per_stage: dict | None = field(compare=False, default=None)
    stage_costs: dict[str, np.ndarray] | None = field(compare=False, default=None)
    placement: Any = field(compare=False, default=None)
    online: Any = field(compare=False, default=None)

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"submission {self.name!r}: weight must be > 0")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError(
                f"submission {self.name!r}: deadline_s must be >= 0")

    def replace(self, **changes) -> "Submission":
        """A copy with ``changes`` applied (frozen-dataclass update)."""
        return dataclasses.replace(self, **changes)


def as_submission(item) -> Submission:
    """``item`` if it is a Submission; raise TypeError otherwise."""
    if isinstance(item, Submission):
        return item
    raise TypeError(f"expected Submission or Job, got {type(item).__name__}")
