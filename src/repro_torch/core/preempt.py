"""Chunk-boundary checkpoints, preemption, and host<->device migration.

The port of the reference's ``core/preempt.py``:

* ``StageCheckpoint`` freezes one stage's unpopped remainder — the
  queued ``(start, size)`` chunks plus everything needed to resume
  bit-equal: the concat row buffer, the ascending-prefix sum
  accumulator, and any out-of-order sum partials.
* ``PreemptableStageRun`` is a ``_StageRun`` that folds sum partials in
  ascending row order so a checkpoint taken at ANY chunk boundary has a
  well-defined resumable accumulator.
* ``PreemptiveRunner`` runs a DAG on the host thread pool with
  chunk-boundary preemption: workers finish the chunk they hold, then
  stop popping; ``run`` returns either a ``DagResult`` or a
  ``JobCheckpoint``. ``run(resume_from=ck)`` continues a checkpoint.
* ``migrate_to_device`` re-lowers a host checkpoint's remainder onto the
  walker (kernels/dag_walk.py) via ``build_dag_tables``: completed
  stages become plain operands, partially-done sum stages start from
  their prefix accumulator (``WalkStage.seed``), and completed concat
  tiles still read by pending elementwise consumers are replayed
  (bit-identical rewrites). ``run_device_prefix`` + ``resume_on_host`` is
  the reverse direction.
* ``PreemptiveArbiter`` wraps any serving arbiter: when a deadline job's
  fluid slack goes negative, lower-priority jobs with no live deadline
  are parked at their next chunk boundary and resume when the pressure
  clears (``make_arbiter("preemptive", ...)``).

Why chunk-boundary-only preemption keeps bit-equality: ops run outside
the runtime lock and fold at ``record()``; a preempted worker never
abandons a chunk mid-op, so the checkpoint sees each chunk either fully
folded or still queued — never a torn partial. Resuming replays the
queued remainder through the same ascending fold the unpreempted run
uses, so the float association is identical.

Where data lives: the host pool computes on CPU tensors, so checkpoints
hold CPU tensors (sum accumulators) and numpy arrays (concat buffers).
The walker's values and outputs lie on the lowering's device; checkpoint
values are copied there before a launch, and walker outputs are copied to
the CPU before a device prefix becomes a checkpoint.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..kernels.dag_walk import WalkOperand, dag_walk
from .dag import (DagResult, EventLog, PipelineDAG, StageResult, TaskEvent,
                  _StageRun, _resolve_stage_config, _stage_inputs, _try_pop)
from .device_schedule import build_dag_tables_cached
from .online import rechunk_pending
from .server import ARBITERS, Arbiter, job_stage_costs, make_arbiter
from .telemetry import F_STOLEN, as_tracer

__all__ = [
    "StageCheckpoint", "JobCheckpoint", "PreemptableStageRun",
    "PreemptiveRunner", "resume_on_host", "DeviceRemainder",
    "device_remainder", "migrate_to_device", "run_device_prefix",
    "checkpoint_from_reference", "PreemptionEvent", "PreemptiveArbiter",
]


# ---------------------------------------------------------------------------
# checkpoint format


@dataclass(frozen=True, eq=False)
class StageCheckpoint:
    """One stage frozen at a chunk boundary.

    ``pending`` is the unpopped remainder as ascending disjoint
    ``(start, size)`` row ranges; together with the True rows of
    ``row_done`` it covers the stage's row space exactly once (no chunk
    is lost or duplicated — ``validate`` proves it). ``out`` is the
    concat buffer (rows outside ``row_done`` are unspecified), ``acc``
    the ascending-prefix sum accumulator covering rows
    ``[0, acc_next)``, and ``parts`` any completed sum chunks that
    arrived out of order (``(start, size, value)``, waiting for the
    prefix to reach them). ``executed`` counts chunks folded before the
    checkpoint — the exactly-once ledger the tests audit.
    """

    stage: str
    n_rows: int
    combine: str
    pending: tuple[tuple[int, int], ...]
    row_done: np.ndarray
    out: np.ndarray | None = None
    acc: Any = None
    acc_next: int = 0
    parts: tuple[tuple[int, int, Any], ...] = ()
    executed: int = 0

    @property
    def empty(self) -> bool:
        """True when the preemption landed after the stage's last pop."""
        return not self.pending

    @property
    def remaining_rows(self) -> int:
        """Rows still to execute."""
        return int(sum(z for _, z in self.pending))

    def validate(self) -> None:
        """Prove the exactly-once invariant: pending ∪ done == rows, disjoint."""
        cover = np.zeros(self.n_rows, dtype=int)
        for s, z in self.pending:
            if z <= 0 or s < 0 or s + z > self.n_rows:
                raise ValueError(
                    f"stage {self.stage!r}: pending chunk ({s},{z}) out of "
                    f"range for n_rows={self.n_rows}")
            cover[s:s + z] += 1
        if (cover > 1).any():
            raise ValueError(f"stage {self.stage!r}: overlapping pending chunks")
        done = np.asarray(self.row_done, dtype=bool)
        if done.shape != (self.n_rows,):
            raise ValueError(f"stage {self.stage!r}: row_done shape mismatch")
        if (cover[done] > 0).any():
            raise ValueError(
                f"stage {self.stage!r}: pending chunk overlaps completed rows")
        if not (done | (cover > 0)).all():
            raise ValueError(
                f"stage {self.stage!r}: rows neither done nor pending (lost)")
        if self.combine == "sum":
            if not done[:self.acc_next].all():
                raise ValueError(
                    f"stage {self.stage!r}: acc_next={self.acc_next} exceeds "
                    "the completed prefix")
            if self.acc_next > 0 and self.acc is None:
                raise ValueError(
                    f"stage {self.stage!r}: non-empty prefix with acc=None")
            for s, z, _v in self.parts:
                if s < self.acc_next:
                    raise ValueError(
                        f"stage {self.stage!r}: partial at {s} already folded")
                if not done[s:s + z].all():
                    raise ValueError(
                        f"stage {self.stage!r}: partial at {s} not marked done")
            if not self.pending and self.parts:
                raise ValueError(
                    f"stage {self.stage!r}: complete stage with unfolded "
                    "partials (hole in row space)")
        elif self.combine == "concat":
            if done.any() and self.out is None:
                raise ValueError(
                    f"stage {self.stage!r}: completed rows but no out buffer")
            if self.out is not None and self.out.shape[0] != self.n_rows:
                raise ValueError(f"stage {self.stage!r}: out buffer shape "
                                 f"{self.out.shape} != n_rows {self.n_rows}")


@dataclass(frozen=True, eq=False)
class JobCheckpoint:
    """A whole job frozen at a chunk boundary, ready to resume anywhere.

    ``substrate`` records where the work ran before the freeze ("host"
    or "device") — informational; the checkpoint format is
    substrate-agnostic, which is what makes mid-flight migration a plain
    resume on the other side.
    """

    job: str
    stages: dict[str, StageCheckpoint]
    substrate: str = "host"
    taken_at: float = 0.0
    reason: str = "preempted"

    @property
    def empty(self) -> bool:
        """True when no stage has pending work (resume completes at once)."""
        return all(s.empty for s in self.stages.values())

    @property
    def remaining_chunks(self) -> int:
        """Unpopped chunks across all stages."""
        return sum(len(s.pending) for s in self.stages.values())

    def validate(self, dag: PipelineDAG | None = None) -> None:
        """Per-stage invariants, plus shape agreement with ``dag`` if given."""
        for name, sck in self.stages.items():
            if name != sck.stage:
                raise ValueError(f"checkpoint key {name!r} != stage {sck.stage!r}")
            sck.validate()
        if dag is not None:
            if set(self.stages) != set(dag.order):
                raise ValueError(
                    f"checkpoint stages {sorted(self.stages)} != DAG stages "
                    f"{sorted(dag.order)}")
            for name in dag.order:
                st = dag.stages[name]
                sck = self.stages[name]
                if sck.n_rows != st.n_rows or sck.combine != st.combine:
                    raise ValueError(
                        f"stage {name!r}: checkpoint ({sck.n_rows}, "
                        f"{sck.combine!r}) != DAG ({st.n_rows}, {st.combine!r})")


def _host_value(v):
    """A reference value (numpy or JAX array, Python scalar) as a CPU tensor."""
    return None if v is None else torch.from_numpy(np.array(v))


def checkpoint_from_reference(ck) -> JobCheckpoint:
    """A reference package's ``JobCheckpoint`` as the port's.

    The reference holds its sum accumulators and partials as JAX (or
    numpy) arrays and its concat buffers as numpy arrays; the port's host
    pool folds CPU tensors. Every array is copied (JAX hands out
    read-only buffers), so the two checkpoints share no memory.
    """
    stages = {
        name: StageCheckpoint(
            stage=s.stage, n_rows=int(s.n_rows), combine=s.combine,
            pending=tuple((int(a), int(z)) for a, z in s.pending),
            row_done=np.array(s.row_done, dtype=bool),
            out=None if s.out is None else np.array(s.out),
            acc=_host_value(s.acc), acc_next=int(s.acc_next),
            parts=tuple((int(a), int(z), _host_value(v)) for a, z, v in s.parts),
            executed=int(s.executed))
        for name, s in ck.stages.items()}
    out = JobCheckpoint(job=ck.job, stages=stages, substrate=ck.substrate,
                        taken_at=float(ck.taken_at), reason=ck.reason)
    out.validate()
    return out


# ---------------------------------------------------------------------------
# preemptable host execution


class PreemptableStageRun(_StageRun):
    """A ``_StageRun`` whose sum fold is ascending-prefix, hence freezable.

    The base class folds sum chunks in completion order — fine for a run
    that always finishes, but a checkpoint taken mid-run would hold an
    accumulator with an unreproducible association. This subclass parks
    completed chunks in ``sum_state`` until the ascending prefix reaches
    them, so at ANY chunk boundary ``acc`` covers exactly
    ``[0, acc_next)`` in row order and the leftover partials are
    explicit. Under the SS / single-worker regime the result is bit-equal
    to the plain walker, which folds tiles in ascending slot order.
    """

    __slots__ = ("sum_state",)

    def __init__(self, stage, cfg, domains):
        super().__init__(stage, cfg, domains)
        # [prefix acc, next row to fold, {start: (value, size)}]
        self.sum_state = None if stage.combine == "concat" else [None, 0, {}]

    def record(self, task, value, dt, rel0, rel1) -> None:
        """The ascending sum fold; concat rows as the base writes them
        (caller holds the lock)."""
        if self.sum_state is None:
            super().record(task, value, dt, rel0, rel1)
            return
        _i, s, z = task
        self.sum_state[2][int(s)] = (value, int(z))
        self._account(task, dt, rel0, rel1)
        self._advance()

    def frontier(self) -> int | None:
        """The next row the ascending sum fold takes (None: a concat stage)."""
        return None if self.sum_state is None else self.sum_state[1]

    def prefix(self):
        """The ascending sum fold's accumulator over ``[0, frontier)``."""
        return self.sum_state[0]

    def record_prefix(self, tasks, value, spans) -> None:
        """Fold a run of chunks walked on from the prefix (lock held).

        ``tasks`` are contiguous and start at the ``frontier``; ``value``
        is the ``prefix`` with their rows added in ascending order, as a
        walk seeded with the prefix accumulates it, and becomes the new
        prefix. ``spans`` gives each task's ``(dt, rel0, rel1)``.
        """
        st = self.sum_state
        if st is None or st[1] != int(tasks[0][1]):
            raise ValueError(
                f"stage {self.stage.name!r}: a run from row {tasks[0][1]} is "
                f"not at the sum fold's frontier {self.frontier()}")
        _i, s, z = tasks[-1]
        st[0], st[1] = value, int(s + z)
        for task, (dt, rel0, rel1) in zip(tasks, spans):
            self._account(task, dt, rel0, rel1)
        self._advance()

    def _advance(self) -> None:
        """Fold the parked partials the prefix has reached; at the last
        chunk the prefix is the stage's value (lock held)."""
        acc, nxt, parts = self.sum_state
        while nxt in parts:
            v, zz = parts.pop(nxt)
            acc = v if acc is None else acc + v
            nxt += zz
        self.sum_state[0], self.sum_state[1] = acc, nxt
        if self.done:
            self.acc = self.value = acc

    def checkpoint(self) -> StageCheckpoint:
        """Freeze the unpopped remainder (caller holds the lock)."""
        pend = tuple(sorted((int(s), int(z))
                            for (s, z) in self.pending_chunks()))
        if self.sum_state is not None:
            acc, nxt, parts = self.sum_state
            parts_t = tuple((int(s), int(z), v)
                            for s, (v, z) in sorted(parts.items()))
        else:
            acc, nxt, parts_t = None, 0, ()
        return StageCheckpoint(
            stage=self.stage.name, n_rows=int(self.stage.n_rows),
            combine=self.stage.combine, pending=pend,
            row_done=self.row_done.copy(),
            out=None if self.out is None else self.out.copy(),
            acc=acc, acc_next=int(nxt), parts=parts_t,
            executed=int(self.executed.sum()))

    @classmethod
    def restore(cls, ck: StageCheckpoint, stage, cfg, domains,
                rechunk_target: int | None = None) -> "PreemptableStageRun":
        """Rebuild a run whose queued work is the checkpoint's remainder.

        The pending ranges are dealt as fresh tasks under this run's
        queue layout (optionally re-chunked to ``rechunk_target`` rows
        for concat stages — sum remainders keep their boundaries, which
        the ascending fold's bit-equality depends on). An empty
        remainder restores directly to ``done`` with the checkpointed
        value — the preempt-after-last-pop edge.
        """
        if (ck.stage != stage.name or ck.n_rows != stage.n_rows
                or ck.combine != stage.combine):
            raise ValueError(
                f"checkpoint ({ck.stage!r}, {ck.n_rows}, {ck.combine!r}) does "
                f"not match stage ({stage.name!r}, {stage.n_rows}, "
                f"{stage.combine!r})")
        sr = cls(stage, cfg, domains)
        pend = [(int(s), int(z)) for s, z in ck.pending]
        if rechunk_target is not None and stage.combine == "concat" and pend:
            pend = [(int(s), int(z))
                    for s, z in rechunk_pending(pend, rechunk_target)]
        tasks = [(i, s, z) for i, (s, z) in enumerate(pend)]
        for q in sr.queues:
            q.clear()
        sr.tasks = tasks
        sr.schedule = np.array([[s, z] for _, s, z in tasks],
                               dtype=np.int32).reshape(-1, 2)
        sr._deal(tasks)
        sr.row_done = np.asarray(ck.row_done, dtype=bool).copy()
        sr.remaining = len(tasks)
        sr.out = None if ck.out is None else np.array(ck.out, copy=True)
        sr.acc = ck.acc
        sr.costs = np.zeros(len(tasks))
        sr.executed = np.zeros(len(tasks), dtype=bool)
        sr.resizes = 0
        if sr.sum_state is not None:
            sr.sum_state = [ck.acc, int(ck.acc_next),
                            {int(s): (v, int(z)) for s, z, v in ck.parts}]
        sr.done = sr.remaining == 0
        if sr.done:
            sr.value = sr.out if stage.combine == "concat" else ck.acc
        return sr


class PreemptiveRunner:
    """PipelineExecutor with chunk-boundary preemption and resume.

    ``preempt_after`` stops the run once that many chunks have been
    folded *this run* (workers finish the chunk they hold first);
    ``trigger(n_done)`` is the programmable form. ``run`` returns
    ``(DagResult, None)`` on completion or ``(None, JobCheckpoint)``
    when preempted with work left; ``run(resume_from=ck)`` continues a
    checkpoint (from this runner or a device prefix — the format is
    substrate-agnostic).
    """

    def __init__(self, dag: PipelineDAG, config,
                 preempt_after: int | None = None,
                 trigger: Callable[[int], bool] | None = None,
                 rechunk_target: int | None = None,
                 job: str = "job", tracer=None):
        self.dag = dag
        self.config = config
        d = config.numa_domains
        self._domains = list(d) if d is not None else [0] * config.n_workers
        self.preempt_after = preempt_after
        self.trigger = trigger
        self.rechunk_target = rechunk_target
        self.job = job
        self.tracer = as_tracer(tracer)

    def _want_preempt(self, n_done: int) -> bool:
        if self.preempt_after is not None and n_done >= self.preempt_after:
            return True
        return self.trigger is not None and self.trigger(n_done)

    def run(self, resume_from: JobCheckpoint | None = None, overrides=None):
        """Execute (or continue) the DAG; see the class docstring."""
        overrides = dict(overrides or {})
        if resume_from is not None:
            resume_from.validate(self.dag)
        runs: dict[str, PreemptableStageRun] = {}
        for name in self.dag.order:
            stage = self.dag.stages[name]
            cfg = _resolve_stage_config(self.config, stage,
                                        overrides.get(name))
            if resume_from is None:
                runs[name] = PreemptableStageRun(stage, cfg, self._domains)
            else:
                runs[name] = PreemptableStageRun.restore(
                    resume_from.stages[name], stage, cfg, self._domains,
                    rechunk_target=self.rechunk_target)
        order = [runs[n] for n in self.dag.order]
        nstages = len(order)
        n_workers = self.config.n_workers
        cond = threading.Condition()
        remaining_total = sum(sr.remaining for sr in order)
        events = EventLog(TaskEvent)
        tracer = self.tracer
        traced = tracer.enabled
        if traced and resume_from is not None:
            tracer.mark("resume", 0.0, self.job, detail=resume_from.reason)
        errors: list[BaseException] = []
        busy = [0.0] * n_workers
        ntasks = [0] * n_workers
        steals = [0]
        n_done = [0]
        stop = [False]
        t0_run = time.perf_counter()

        def record(sr, task, value, dt, wid, rel0, rel1, stolen, wait_s=0.0):
            nonlocal remaining_total
            i, s, z = task
            sr.record(task, value, dt, rel0, rel1)
            remaining_total -= 1
            events.append_raw(sr.stage.name, i, s, z, wid, rel0, rel1,
                              stolen, wait_s)
            if traced:
                tracer.record_raw("exec", self.job, sr.stage.name, i, wid,
                                  rel0, rel1, F_STOLEN if stolen else 0,
                                  wait_s)
            busy[wid] += dt
            ntasks[wid] += 1
            steals[0] += int(stolen)
            n_done[0] += 1
            # the preemption point: every chunk boundary, after the fold
            if (not stop[0] and remaining_total > 0
                    and self._want_preempt(n_done[0])):
                stop[0] = True

        def worker(wid: int) -> None:
            cursor = wid % nstages
            while True:
                sr = task = None
                stolen = False
                t_idle = time.perf_counter()
                with cond:
                    while True:
                        if errors or stop[0] or remaining_total == 0:
                            return
                        for k in range(nstages):
                            idx = (cursor + k) % nstages
                            cand = order[idx]
                            if cand.remaining == 0:
                                continue
                            got, stolen = _try_pop(cand, runs, wid)
                            if got is not None:
                                sr, task = cand, got
                                cursor = (idx + 1) % nstages
                                break
                        if task is not None:
                            break
                        cond.wait(timeout=0.05)
                    inputs = _stage_inputs(sr, runs)
                _, s, z = task
                t0 = time.perf_counter()
                try:
                    value = sr.stage.op(inputs, s, z)
                    t1 = time.perf_counter()
                    with cond:
                        record(sr, task, value, t1 - t0, wid,
                               t0 - t0_run, t1 - t0_run, stolen, t0 - t_idle)
                        cond.notify_all()
                except BaseException as e:  # surfaced to the caller below
                    with cond:
                        errors.append(e)
                        cond.notify_all()
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        wall = time.perf_counter() - t0_run
        if stop[0] and remaining_total > 0:
            ck = JobCheckpoint(
                job=self.job,
                stages={n: runs[n].checkpoint() for n in self.dag.order},
                substrate="host", taken_at=wall, reason="trigger")
            ck.validate(self.dag)
            if traced:
                tracer.mark("checkpoint", wall, self.job,
                            detail=f"chunks_left={ck.remaining_chunks}")
            return None, ck
        stage_results = {
            name: StageResult(value=sr.value, schedule=sr.schedule,
                              per_task_costs=sr.costs, config=sr.cfg,
                              t_first=sr.t_first, t_last=sr.t_last)
            for name, sr in runs.items()
        }
        res = DagResult(
            values={n: r.value for n, r in stage_results.items()},
            stages=stage_results, events=events, wall_time_s=wall,
            steals=steals[0], per_worker_busy_s=busy, per_worker_tasks=ntasks)
        return res, None


def resume_on_host(ck: JobCheckpoint, dag: PipelineDAG, config,
                   overrides=None, tracer=None) -> DagResult:
    """Run a checkpoint's remainder to completion on the host pool."""
    res, left = PreemptiveRunner(dag, config, job=ck.job,
                                 tracer=tracer).run(
        resume_from=ck, overrides=overrides)
    assert left is None  # no trigger installed, the run cannot re-preempt
    return res


# ---------------------------------------------------------------------------
# host <-> device mid-flight migration


def _tile_sets(ck: JobCheckpoint) -> dict[str, set[int]]:
    """Pending tile indices per stage (checkpoint rows ARE tile units)."""
    pending: dict[str, set[int]] = {}
    for n, sck in ck.stages.items():
        tiles: set[int] = set()
        for s, z in sck.pending:
            tiles.update(range(s, s + z))
        pending[n] = tiles
    return pending


def _walk_device(lowering) -> torch.device:
    """The device the lowering's walker operands lie on."""
    return lowering.values[lowering.operands[0].name].device


def _on(x, shape, dtype, device) -> torch.Tensor:
    """Checkpoint value ``x`` (tensor or numpy) as a ``shape`` tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.reshape(shape).to(device=device, dtype=dtype)


def _ss_table(dag) -> tuple[np.ndarray, list[str]]:
    """The SS super-table of ``dag`` (one tile per slot) and its stage names."""
    ddt = build_dag_tables_cached(dag, 1, "SS", n_shards=1)
    return ddt.tables[0], list(ddt.stage_names)


@dataclass
class DeviceRemainder:
    """A host checkpoint's remainder lowered for ONE walker launch.

    ``stages`` / ``operands`` / ``values`` / ``table`` (row space) /
    ``tile`` are ``dag_walk``'s arguments; a partially-done sum stage
    carries ``seed=`` naming its prefix accumulator in ``values``.
    ``need`` lists the tiles each kept stage runs on the device.
    """

    stages: list
    operands: list
    values: dict
    table: np.ndarray
    tile: int
    need: dict[str, set[int]]

    def walk(self) -> dict[str, torch.Tensor]:
        """Drain the remainder table in one launch ({} when it is empty)."""
        if not len(self.table):
            return {}
        return dag_walk(self.stages, self.operands, self.values, self.table,
                        self.tile)


def device_remainder(ck: JobCheckpoint, lowering) -> DeviceRemainder:
    """Re-lower a host checkpoint's remainder for the walker.

    ``lowering`` is the vee ``DeviceLowering`` whose tile-unit host DAG
    produced ``ck``. The remainder is re-lowered with ``build_dag_tables``
    (technique SS — one tile per slot, matching the checkpoint's tile
    granularity) and filtered to the pending tiles:

    * fully-completed stages are dropped from the walker and their
      checkpointed values fed back as plain operands;
    * partially-done sum stages keep their pending slots and start from
      the checkpoint's prefix accumulator (``WalkStage.seed``), so the
      fold continues the exact host association (requires an
      ascending-prefix checkpoint: out-of-order partials raise, resume
      those on host);
    * completed concat tiles still read by a pending elementwise
      consumer are replayed — the rewrite is bit-identical, so replay
      beats shipping per-tile state into the kernel.

    Checkpoint values are copied to the lowering's device here.
    """
    dag = lowering.dag
    tile = lowering.tile
    ck.validate(dag)
    table, names = _ss_table(dag)
    by_name = {s.name: s for s in lowering.stages}
    device = _walk_device(lowering)

    pending = _tile_sets(ck)
    for n, sck in ck.stages.items():
        if sck.combine == "sum" and sck.parts:
            raise ValueError(
                f"stage {n!r}: out-of-order sum partials cannot be seeded "
                "into the walker's ascending fold; resume on host instead")

    # tiles each stage must execute on-device: its pending tiles, plus
    # replays of completed producer tiles that pending consumers read
    need = {n: set(pending[n]) for n in names}
    changed = True
    while changed:
        changed = False
        for n in names:
            for prod, kind in by_name[n].reads:
                if kind != "rows":
                    continue  # full reads see the (seeded) final accumulator
                missing = {t for t in need[n]
                           if t not in need[prod] and t not in pending[prod]}
                if missing:
                    need[prod] |= missing
                    changed = True

    kept = [n for n in names if need[n]]
    kept_set = set(kept)
    new_id = {n: k for k, n in enumerate(kept)}

    operands = list(lowering.operands)
    values = dict(lowering.values)
    stages = []
    for n in kept:
        ws = by_name[n]
        sck = ck.stages[n]
        if ws.combine == "sum" and sck.acc is not None:
            # the prefix accumulator the stage's output starts from
            key = f"{n}__resume"
            values[key] = _on(sck.acc, ws.out_shape, ws.out_dtype, device)
            ws = dataclasses.replace(ws, seed=key)
        stages.append(ws)

    # dropped stages read by kept ones come back as plain operands
    for ws in stages:
        for prod, kind in ws.reads:
            if prod in kept_set:
                continue
            p = by_name[prod]
            sck = ck.stages[prod]
            if kind == "full":
                operands.append(WalkOperand(prod, tuple(p.out_shape),
                                            ("zero",) * len(p.out_shape)))
                values[prod] = _on(sck.acc, p.out_shape, p.out_dtype, device)
            else:
                operands.append(WalkOperand(
                    prod, (tile,) + tuple(p.out_shape[1:]),
                    ("row",) + ("zero",) * (len(p.out_shape) - 1)))
                values[prod] = _on(sck.out, p.out_shape, p.out_dtype, device)

    rows_tbl = [(new_id[names[sid]], start * tile, size * tile)
                for sid, start, size in table.tolist()
                if size > 0 and names[sid] in kept_set
                and start in need[names[sid]]]
    new_table = np.asarray(rows_tbl, dtype=np.int32).reshape(-1, 3)
    return DeviceRemainder(stages, operands, values, new_table, tile,
                           {n: need[n] for n in kept})


def _tile_rows(tiles, tile: int, n_rows: int, device) -> torch.Tensor:
    """Boolean row mask of the given tile indices."""
    mask = np.zeros(n_rows // tile, dtype=bool)
    mask[sorted(tiles)] = True
    return torch.from_numpy(np.repeat(mask, tile)).to(device)


def migrate_to_device(ck: JobCheckpoint, lowering) -> dict[str, torch.Tensor]:
    """Resume a host checkpoint on the walker, in one launch.

    Re-lowers the remainder with ``device_remainder`` and walks it on the
    device the lowering's values lie on (the CUDA kernel for CUDA
    tensors, the plain walker for CPU ones). Returns ``{stage: tensor}``
    in row space on that device for every stage — the shape
    ``run_device_dag`` produces. On the CPU the values are bit-equal to
    ``run_device_dag(lowering, "SS")`` under the SS / single-worker host
    regime; on the card the seeded kernel continues the host prefix in
    ascending slot order.
    """
    plan = device_remainder(ck, lowering)
    walked = plan.walk()
    device = _walk_device(lowering)
    tile = lowering.tile
    final: dict[str, torch.Tensor] = {}
    for ws in lowering.stages:
        n = ws.name
        sck = ck.stages[n]
        if ws.combine == "sum":
            final[n] = (walked[n] if n in plan.need
                        else _on(sck.acc, ws.out_shape, ws.out_dtype, device))
            continue
        buf = (torch.zeros(ws.out_shape, dtype=ws.out_dtype, device=device)
               if sck.out is None
               else _on(sck.out, ws.out_shape, ws.out_dtype, device).clone())
        if n in plan.need:
            rows = _tile_rows(plan.need[n], tile, ws.n_rows, device)
            buf[rows] = walked[n][rows]
        final[n] = buf
    return final


def run_device_prefix(lowering, n_slots: int):
    """Run the first ``n_slots`` super-table slots, then checkpoint.

    The device side of mid-flight migration: freeze the lowering with
    ``build_dag_tables`` (SS, one tile per slot), drain only a prefix of
    the table in one launch — a prefix is always dependency-closed,
    since every producer slot precedes its consumers — and package the
    rest as a ``JobCheckpoint`` in the host format (tile-unit rows):
    concat tiles land in the ``out`` buffer, sum slots fold into an
    ascending-prefix ``acc``. The walker's outputs are copied to the CPU
    first, where the host pool computes. ``resume_on_host`` then finishes
    the job.

    Returns ``(checkpoint, walked)`` where ``walked`` is the raw
    row-space walker output of the prefix, on the lowering's device.
    """
    dag = lowering.dag
    tile = lowering.tile
    table, names = _ss_table(dag)
    live = table[table[:, 2] > 0]
    by_name = {s.name: s for s in lowering.stages}
    n_slots = max(0, min(int(n_slots), len(live)))
    prefix = live[:n_slots]

    if n_slots:
        scaled = prefix.copy()
        scaled[:, 1:] *= tile
        walked = dag_walk(lowering.stages, lowering.operands, lowering.values,
                          scaled, tile)
    else:
        walked = {}
    host = {n: v.cpu() for n, v in walked.items()}

    stages: dict[str, StageCheckpoint] = {}
    for k, n in enumerate(names):
        ws = by_name[n]
        units = int(dag.stages[n].n_rows)
        done_tiles = sorted(int(s) for sid, s, _z in prefix if int(sid) == k)
        if done_tiles != list(range(len(done_tiles))):
            raise ValueError(
                f"stage {n!r}: prefix executed non-contiguous tiles "
                f"{done_tiles}; cannot form an ascending checkpoint")
        p = len(done_tiles)
        row_done = np.zeros(units, dtype=bool)
        row_done[:p] = True
        pend = tuple((t, 1) for t in range(p, units))
        acc = out = None
        if p and ws.combine == "sum":
            acc = host[n]
        elif p:
            dev = host[n].numpy().reshape((units, tile) + tuple(ws.out_shape[1:]))
            out = np.zeros_like(dev)
            out[:p] = dev[:p]
        stages[n] = StageCheckpoint(
            stage=n, n_rows=units, combine=ws.combine, pending=pend,
            row_done=row_done, out=out, acc=acc, acc_next=p, parts=(),
            executed=p)
    ck = JobCheckpoint(job="device", stages=stages, substrate="device",
                       reason="prefix")
    ck.validate(dag)
    return ck, walked


# ---------------------------------------------------------------------------
# the preemptive arbiter


@dataclass(frozen=True)
class PreemptionEvent:
    """One park/resume decision: when, who, which way, and why."""

    t: float
    job: str
    kind: str      # "preempt" | "resume"
    reason: str


class PreemptiveArbiter(Arbiter):
    """Wrap any arbiter with deadline-pressure eviction.

    Per ``order`` call (one per chunk boundary of the server), a
    deadline job is *pressured* when its fluid slack — time to deadline
    minus remaining-work estimate spread over ``n_workers`` — drops
    below ``slack_s``. While any job is pressured, jobs at or below the
    most urgent pressured priority whose deadline is absent or already
    expired are parked: dropped from the dispatch order, so their next
    chunk never pops, which is exactly a chunk-boundary preemption of
    the pipeline runtime. The moment pressure clears they reappear — their
    queued remainder is intact in the live ``_StageRun`` state, so
    "resume" is simply being schedulable again (an implicit checkpoint;
    no state is copied). Already-expired deadline jobs are never
    pressured (the miss is unavoidable) and ARE victim-eligible.

    ``admission`` (an object with ``estimate_service_s(job)``, the
    reference's AdmissionController) sharpens the remaining-work estimate
    with feedback rates; without it the estimate is the job's declared
    stage costs. Park/resume transitions land in ``preemption_log``,
    which the server's result surfaces.
    """

    name = "preemptive"

    def __init__(self, inner: str | Any = "fair", n_workers: int = 1,
                 slack_s: float = 0.0, admission=None, **inner_kwargs):
        self.inner = (inner if not isinstance(inner, str)
                      else make_arbiter(inner, **inner_kwargs))
        self.n_workers = max(1, int(n_workers))
        self.slack_s = float(slack_s)
        self.admission = admission
        self.preemption_log: list[PreemptionEvent] = []
        self._est: dict[str, float] = {}

    def _estimate(self, js) -> float:
        """Total service-seconds estimate for this job (cached)."""
        key = js.job.name
        if key not in self._est:
            if self.admission is not None:
                self._est[key] = float(
                    self.admission.estimate_service_s(js.job))
            else:
                self._est[key] = float(sum(
                    np.asarray(c, dtype=float).sum()
                    for c in job_stage_costs(js.job).values()))
        return self._est[key]

    def slack(self, js, now: float) -> float:
        """Fluid slack: deadline minus projected finish, seconds."""
        deadline = js.arrival + js.job.deadline_s
        left = max(self._estimate(js) - js.service, 0.0)
        return deadline - (now + left / self.n_workers)

    def order(self, jobs, now: float):
        """Inner order minus the currently-parked victims."""
        ordered = self.inner.order(jobs, now)
        pressured = []
        for js in jobs:
            if js.job.deadline_s is None or js.done:
                continue
            if now >= js.arrival + js.job.deadline_s:
                continue  # expired: the miss is sunk, don't thrash for it
            if self.slack(js, now) < self.slack_s:
                pressured.append(js)
        victims: set[str] = set()
        if pressured:
            pmax = max(p.job.priority for p in pressured)
            pressed = {p.job.name for p in pressured}
            for js in jobs:
                if js.done or js.job.name in pressed:
                    continue
                if js.job.priority > pmax:
                    continue
                live_deadline = (js.job.deadline_s is not None
                                 and now < js.arrival + js.job.deadline_s)
                if not live_deadline:
                    victims.add(js.job.name)
        for js in jobs:
            parked = js.job.name in victims
            if parked and not js.preempted:
                self.preemption_log.append(PreemptionEvent(
                    now, js.job.name, "preempt", "deadline_pressure"))
            elif js.preempted and not parked:
                self.preemption_log.append(PreemptionEvent(
                    now, js.job.name, "resume", "pressure_cleared"))
            js.preempted = parked
        if not victims:
            return ordered
        return [js for js in ordered if js.job.name not in victims]

    def charge(self, js, dt: float, now: float) -> None:
        """Delegate accounting to the wrapped arbiter."""
        self.inner.charge(js, dt, now)


# make_arbiter("preemptive", ...) resolves to this module
ARBITERS.setdefault("preemptive", PreemptiveArbiter)
