"""String-spec registry for the scheduling surfaces (the port's copy of
``core/registry.py``).

A short string names a policy, kwargs refine it, instances pass through:

  ``make_config("gss/percore")``         -> SchedulerConfig
  ``make_config("mfsc/pergroup/rand")``  -> technique/layout/victim
  ``make_placement("device", names)``    -> Placement (uniform)
  ``make_placement("split:0.5", names)`` -> SPLIT(0.5) on every stage
  ``make_placement("a=host,b=split:0.3")`` -> per-stage assignment
  ``make_arbiter("priority")``           -> re-exported from core.server

``make(kind, spec, **kw)`` dispatches by kind — the single entry point
``launch/serve.py`` wires its CLI flags through.
"""

from __future__ import annotations

import dataclasses

from .executor import SchedulerConfig
from .partitioners import PARTITIONERS
from .placement import SPLIT, Placement, StagePlacement
from .queues import QUEUE_LAYOUTS
from .server import make_arbiter
from .victim import VICTIM_STRATEGIES

__all__ = ["make_config", "make_placement", "make_arbiter", "REGISTRY",
           "make"]


def make_config(spec, **kwargs) -> SchedulerConfig:
    """Build a SchedulerConfig from a ``technique[/layout[/victim]]`` spec.

    Segments are case-insensitive and validated against the 11
    partitioning techniques, the 3 queue layouts, and the 4 victim
    strategies; omitted segments keep the SchedulerConfig defaults
    (CENTRALIZED, SEQ). ``kwargs`` (``n_workers``, ``numa_domains``,
    ``seed``) shape the pool. A SchedulerConfig passes through with
    ``kwargs`` applied on top.
    """
    if isinstance(spec, SchedulerConfig):
        return dataclasses.replace(spec, **kwargs) if kwargs else spec
    if isinstance(spec, tuple):
        spec = "/".join(spec)
    parts = [p.strip().upper() for p in str(spec).split("/") if p.strip()]
    if not parts or len(parts) > 3:
        raise ValueError(
            f"config spec {spec!r} must be technique[/layout[/victim]]")
    fields = {"technique": parts[0]}
    if len(parts) > 1:
        fields["queue_layout"] = parts[1]
    if len(parts) > 2:
        fields["victim_strategy"] = parts[2]
    if fields["technique"] not in PARTITIONERS:
        raise ValueError(f"unknown technique {parts[0]!r}; options: "
                         f"{sorted(PARTITIONERS)}")
    if fields.get("queue_layout", "CENTRALIZED") not in QUEUE_LAYOUTS:
        raise ValueError(f"unknown queue layout {parts[1]!r}; options: "
                         f"{sorted(QUEUE_LAYOUTS)}")
    if fields.get("victim_strategy", "SEQ") not in VICTIM_STRATEGIES:
        raise ValueError(f"unknown victim strategy {parts[2]!r}; options: "
                         f"{sorted(VICTIM_STRATEGIES)}")
    return SchedulerConfig(**fields, **kwargs)


def _stage_placement(token: str) -> StagePlacement:
    """Parse one ``host`` / ``device`` / ``split:F`` token."""
    token = token.strip().lower()
    if token.startswith("split"):
        _, _, frac = token.partition(":")
        if not frac:
            raise ValueError(
                f"placement token {token!r} needs a fraction: split:0.5")
        return StagePlacement(SPLIT, float(frac))
    return StagePlacement(token)  # validates host/device


def make_placement(spec, stage_names=None) -> Placement:
    """Build a Placement from a spec string.

    Uniform specs (``"host"``, ``"device"``, ``"split:0.5"``) apply one
    StagePlacement to every stage in ``stage_names`` (required). Keyed
    specs (``"a=host,b=split:0.3"``) assign listed stages; unlisted
    stages default to HOST as everywhere else. A Placement passes
    through unchanged.
    """
    if isinstance(spec, Placement):
        return spec
    text = str(spec).strip()
    if "=" in text:
        assign = {}
        for part in text.split(","):
            if not part.strip():
                continue
            name, _, tok = part.partition("=")
            if not tok:
                raise ValueError(f"placement entry {part!r} must be "
                                 "stage=host|device|split:F")
            assign[name.strip()] = _stage_placement(tok)
        return Placement(assign)
    if stage_names is None:
        raise ValueError(
            f"uniform placement spec {text!r} needs stage_names")
    sp = _stage_placement(text)
    return Placement({n: sp for n in stage_names})


REGISTRY = {
    "config": make_config,
    "placement": make_placement,
    "arbiter": make_arbiter,
}


def make(kind: str, spec, **kwargs):
    """Dispatch ``spec`` to the ``kind`` factory in REGISTRY."""
    try:
        factory = REGISTRY[kind]
    except KeyError:
        raise ValueError(
            f"unknown registry kind {kind!r}; options: {sorted(REGISTRY)}"
        ) from None
    return factory(spec, **kwargs)
