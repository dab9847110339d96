"""Same-shape batch coalescing at the serving front door (the port's copy
of the batching part of ``core/admission.py``).

Submissions whose DAGs share a signature merge into ONE PipelineDAG of
per-member stage copies (``stage#member``), so the device path freezes one
super-table and pays one walker launch for the whole batch
(``vee/apps.py:merge_device_lowerings``) — bit-equal to unbatched
execution because every member keeps its own op over its own rows.

The rest of the reference's front door — ``TokenBucket``,
``AdmissionController``, ``AutoscalePolicy``, ``replay_open_loop``,
``heavy_tailed_trace`` and ``FrontDoor`` — is the second half of ROADMAP
A14: each raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

from dataclasses import dataclass

from .dag import PipelineDAG, Stage, StageDep
from .submit import Submission

__all__ = ["BATCH_SEP", "batch_signature", "merge_dags",
           "coalesce_submissions", "BatchPolicy", "TokenBucket",
           "AdmissionController", "AutoscalePolicy", "replay_open_loop",
           "heavy_tailed_trace", "FrontDoor"]

BATCH_SEP = "#"


# ---------------------------------------------------------------------------
# same-shape batch coalescing
# ---------------------------------------------------------------------------

def batch_signature(sub: Submission) -> tuple:
    """Hashable shape key: submissions with equal signatures may coalesce.

    Two submissions coalesce when they share a tenant and their DAGs are
    structurally identical — same stage names, row counts, combine
    modes, and dependency edges. Ops may differ (each member keeps its
    own closure), which is what makes the merged run bit-equal to the
    unbatched runs.
    """
    dag = sub.dag
    shape = tuple(
        (n, dag.stages[n].n_rows, dag.stages[n].combine,
         tuple((d.producer, d.kind) for d in dag.stages[n].deps))
        for n in dag.stage_names)
    return (sub.tenant, shape)


def _strip_member(name: str) -> str:
    """Drop the ``#member`` suffix a merged stage name carries."""
    return name.rsplit(BATCH_SEP, 1)[0]


def _wrap_op(op):
    """Wrap a member op so it sees its original producer names."""
    def wrapped(inputs, s, z):
        """Forward to the member op with member suffixes stripped."""
        return op({_strip_member(k): v for k, v in inputs.items()}, s, z)
    return wrapped


def merge_dags(dags: list[PipelineDAG]) -> PipelineDAG:
    """Merge DAGs into one: member ``j``'s stage ``s`` becomes ``s#j``.

    Members stay disjoint subgraphs — no cross-member edge, every stage
    keeps its own op (wrapped to strip the member suffix from its inputs
    dict) and cost model — so executing the merged DAG is bit-equal to
    executing the members separately, on the host pool and on the §11
    device walker alike. One merged DAG freezes into ONE super-table:
    the whole batch pays a single fused launch.
    """
    stages: list[Stage] = []
    for j, dag in enumerate(dags):
        for n in dag.stage_names:
            st = dag.stages[n]
            if BATCH_SEP in st.name:
                raise ValueError(
                    f"stage name {st.name!r} contains the reserved batch "
                    f"separator {BATCH_SEP!r}")
            stages.append(Stage(
                name=f"{st.name}{BATCH_SEP}{j}", n_rows=st.n_rows,
                op=_wrap_op(st.op), combine=st.combine,
                deps=tuple(StageDep(f"{d.producer}{BATCH_SEP}{j}", d.kind)
                           for d in st.deps),
                config=st.config, cost_of_range=st.cost_of_range))
    return PipelineDAG(stages)


def coalesce_submissions(subs: list[Submission],
                         name: str | None = None) -> Submission:
    """Coalesce same-shape submissions into one merged Submission.

    The merged submission carries the merged DAG (``merge_dags``), the
    union of per-stage overrides and cost vectors under member-suffixed
    names, the max priority, and the TIGHTEST member deadline (each
    member's absolute deadline re-expressed relative to the merged
    arrival, the latest member arrival). All members must share a tenant
    and carry no placement/online of their own. A single submission
    passes through unchanged.
    """
    if not subs:
        raise ValueError("cannot coalesce an empty batch")
    if len(subs) == 1:
        return subs[0]
    tenants = {s.tenant for s in subs}
    if len(tenants) != 1:
        raise ValueError(f"cannot coalesce across tenants {sorted(tenants)}")
    if any(s.placement is not None or s.online is not None for s in subs):
        raise ValueError("cannot coalesce submissions carrying placement "
                         "or online overrides")
    arrival = max(s.arrival_s for s in subs)
    deadline = None
    for s in subs:
        if s.deadline_s is not None:
            rel = (s.arrival_s + s.deadline_s) - arrival
            deadline = rel if deadline is None else min(deadline, rel)
    per_stage: dict = {}
    costs: dict = {}
    for j, s in enumerate(subs):
        for n, c in (s.per_stage or {}).items():
            per_stage[f"{n}{BATCH_SEP}{j}"] = c
        for n, c in (s.stage_costs or {}).items():
            costs[f"{n}{BATCH_SEP}{j}"] = c
    return Submission(
        dag=merge_dags([s.dag for s in subs]),
        name=name or f"batch({subs[0].name}x{len(subs)})",
        tenant=subs[0].tenant,
        priority=max(s.priority for s in subs),
        weight=max(s.weight for s in subs),
        arrival_s=arrival,
        deadline_s=None if deadline is None else max(deadline, 0.0),
        per_stage=per_stage or None,
        stage_costs=costs or None)


@dataclass
class BatchPolicy:
    """Coalescing policy: hold same-shape arrivals up to a window/size.

    An admitted submission whose ``batch_signature`` matches an open
    batch joins it; the batch flushes when it reaches ``max_batch``
    members or ``window_s`` after its first member arrived, whichever
    comes first. Submissions carrying a placement or online override
    never batch.
    """

    window_s: float = 2e-3
    max_batch: int = 8

    def batchable(self, sub: Submission) -> bool:
        """May this submission join a coalescing window at all?"""
        return (self.max_batch > 1 and sub.placement is None
                and sub.online is None)


# ---------------------------------------------------------------------------
# the open-loop front door: the second half of ROADMAP A14
# ---------------------------------------------------------------------------

def _front_door(name: str):
    raise NotImplementedError(
        f"{name} is part of the serving front door (admission, autoscaling, "
        "open-loop replay), which is not ported yet (ROADMAP A14, second "
        "half)")


class TokenBucket:
    """Per-tenant rate limiter of the front door: not ported yet."""

    def __init__(self, *args, **kwargs):
        _front_door("TokenBucket")


class AdmissionController:
    """Admit / shed / defer decisions of the front door: not ported yet."""

    def __init__(self, *args, **kwargs):
        _front_door("AdmissionController")


class AutoscalePolicy:
    """Pool autoscaling of the front door: not ported yet."""

    def __init__(self, *args, **kwargs):
        _front_door("AutoscalePolicy")


def replay_open_loop(trace, *args, **kwargs):
    """Virtual-time open-loop replay through the front door: not ported
    yet."""
    _front_door("replay_open_loop")


def heavy_tailed_trace(n_jobs, *args, **kwargs):
    """The heavy-tailed open-loop arrival trace: not ported yet."""
    _front_door("heavy_tailed_trace")


class FrontDoor:
    """The threaded front door over a PipelineServer: not ported yet."""

    def __init__(self, *args, **kwargs):
        _front_door("FrontDoor")
