"""The submission surface: one record for what is being submitted.

Every knob that describes WHAT is being submitted — the DAG, its
tenant/priority/deadline metadata, per-stage overrides, an optional
placement, an optional online scheduler — rides on ONE record,
``Submission``, accepted uniformly by ``PipelineExecutor.run``,
``HeteroExecutor.run`` and ``PipelineServer.submit`` / ``serve``. The
port's copy of the reference's ``core/submit.py``.

``core.server.Job`` remains the *internal* serving record (what the
arbiters account against); ``to_job()`` is the bridge. Public surfaces
reject a ``Job`` with a ``TypeError`` naming the replacement.
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
    ``stage_costs`` carries per-row cost estimates. ``lowering`` (the
    DAG's vee ``DeviceLowering``) lets the walker lanes walk the rows a
    ``placement`` gives the device; without it they run the host ops.
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
    lowering: Any = field(compare=False, default=None)

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"submission {self.name!r}: weight must be > 0")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError(
                f"submission {self.name!r}: deadline_s must be >= 0")

    def to_job(self):
        """The internal core.server.Job record for this submission."""
        from .server import Job

        if self.dag is None:
            raise ValueError(f"submission {self.name!r} carries no dag")
        return Job(name=self.name, dag=self.dag, priority=self.priority,
                   tenant=self.tenant, weight=self.weight,
                   arrival_s=self.arrival_s, deadline_s=self.deadline_s,
                   per_stage=self.per_stage, stage_costs=self.stage_costs)

    def replace(self, **changes) -> "Submission":
        """A copy with ``changes`` applied (frozen-dataclass update)."""
        return dataclasses.replace(self, **changes)


def as_submission(item, surface: str | None = None) -> Submission:
    """Coerce ``item`` into a Submission.

    ``surface`` names a *public* calling surface: there, ``core.server.Job``
    records are rejected with a TypeError naming the replacement. Internal
    surfaces (``surface=None``) keep the silent Job -> Submission
    coercion.
    """
    if isinstance(item, Submission):
        return item
    from .server import Job

    if isinstance(item, Job):
        if surface:
            raise TypeError(
                f"{surface} no longer accepts core.server.Job records; pass "
                "a core.submit.Submission instead")
        return Submission(dag=item.dag, name=item.name, tenant=item.tenant,
                          priority=item.priority, weight=item.weight,
                          arrival_s=item.arrival_s, deadline_s=item.deadline_s,
                          per_stage=item.per_stage,
                          stage_costs=item.stage_costs)
    raise TypeError(f"expected Submission or Job, got {type(item).__name__}")
