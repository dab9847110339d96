"""String-spec registry for scheduler configs (the port's copy of
``core/registry.py:make_config``).

  ``make_config("gss/percore")``         -> SchedulerConfig
  ``make_config("mfsc/pergroup/rand")``  -> technique/layout/victim

``make_placement``, ``make_arbiter`` and the ``make`` dispatcher need the
placement solver and the server, and wait for ROADMAP A14.
"""

from __future__ import annotations

import dataclasses

from .executor import SchedulerConfig
from .partitioners import PARTITIONERS
from .queues import QUEUE_LAYOUTS
from .victim import VICTIM_STRATEGIES

__all__ = ["make_config"]


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
