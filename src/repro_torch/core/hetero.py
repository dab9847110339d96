"""Heterogeneous co-execution: host chunk workers + device walker lanes.

The port's copy of the reference's ``core/hetero.py``.
``core/placement.py`` decides WHERE each stage runs; this module runs the
decision. A ``HeteroExecutor`` executes one PipelineDAG on BOTH substrates
at once:

* **Host side** — ``config.n_workers`` threads drive the PipelineExecutor
  machinery unchanged: per-stage queues/techniques, victim-ordered
  stealing, FIFO-head dependency gating, rotating stage cursors.
* **Device side** — ``n_device`` walker lanes each drain a frozen
  super-table shard: the stage's device row range [0, k) in ascending
  row order (exactly the ``build_dag_tables`` slot order), streaming
  behind producers via the same row-completion gates. Given the DAG's
  walker lowering (``lowering=``, a vee ``DeviceLowering``), a lane pops a
  run of its shard's runnable head slots (up to half the shard, so idle
  host workers can still absorb the tail) and walks them in ONE
  ``dag_walk`` launch on the device the lowering's values lie on: K1 on
  the card for CUDA tensors, the plain walker for CPU ones. A sum run
  that starts where the stage's ascending fold has reached is seeded
  with the folded prefix and becomes the new prefix; elsewhere a lane
  walks one task, its partial parked for the fold. Without a lowering a
  lane is a thread that runs the stage's host op (the reference's
  stand-in), and its spans carry no ``F_DEVICE`` flag.
* **Cross-substrate streaming** — elementwise consumers on either side
  pop as soon as the producer rows complete, regardless of which side
  produced them (the shared ``row_done`` gate is substrate-blind).
* **Cross-substrate rebalancing** — an idle host worker absorbs the TAIL
  of a device shard's unpopped remainder (coalescing contiguous concat
  tiles to its own granularity via ``rechunk_pending``), and a device
  lane whose shards are drained or blocked absorbs host chunks via the
  ordinary ``_try_pop`` path — so neither substrate idles while the other
  has work.

**Bit-equality.** Sum stages fold their per-chunk partials in ascending
row order (not completion order), so on the host the combined value
depends only on the chunk boundaries — not on which thread ran each
chunk, nor on absorption. Run at tile granularity (technique ``SS`` on a
tile-unit DAG) this reproduces the host-only
``PipelineExecutor(technique="SS", n_workers=1)`` result bit-wise on the
vee linreg/recommendation lowerings, also when lanes walk a CPU
lowering: the plain walker adds a seeded run's tiles to the prefix one
by one, as the fold does. On the card K1 sums a run's tiles in its own
association, so a co-executed value differs from the host-only one by
rounding, and with the run boundaries, which thread timing sets. Concat
stages write disjoint rows and are bit-equal under any
placement/technique on the host.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.dag_walk import WalkOperand, dag_walk
from .dag import (
    DagResult,
    EventLog,
    PipelineDAG,
    StageResult,
    TaskEvent,
    _resolve_stage_config,
    _stage_inputs,
    _StageRun,
    _task_ready,
    _try_pop,
)
from .executor import SchedulerConfig
from .online import rechunk_pending
from .placement import Placement, TransferEvent
from .telemetry import F_DEVICE, F_STOLEN, as_tracer

__all__ = ["HeteroExecutor", "HeteroResult", "split_device_tasks",
           "pop_device_task", "pop_device_run", "walk_device_run",
           "steal_device_tail"]

#: one walker launch at a time: lanes share the device-table cache
_WALK_LOCK = threading.Lock()


def split_device_tasks(
    sr: _StageRun, k: int, n_device: int
) -> tuple[list[deque], int]:
    """Carve the device row range [0, k) out of a freshly built stage run.

    Re-chunks the queued schedule so no chunk straddles the boundary
    (via ``_StageRun.resize_remaining``), then moves every task starting
    below ``k`` from the host queues into ``n_device`` shard deques
    (ascending rows, dealt round-robin — the ``assign_chunks`` analogue).
    Returns ``(shard_deques, remaining_delta)``; the caller folds the
    delta into its outstanding-task totals. Call before any pop.
    """
    shards: list[deque] = [deque() for _ in range(max(1, n_device))]
    if k <= 0:
        return shards, 0
    pend = sr.pending_chunks()
    split = []
    for s, z in pend:
        if s < k < s + z:
            split += [(s, k - s), (k, s + z - k)]
        else:
            split.append((s, z))
    delta = 0
    if split != pend:
        delta = sr.resize_remaining(split)
    dev_tasks = []
    for q in sr.queues:
        keep = [t for t in q if t[1] >= k]
        dev_tasks += [t for t in q if t[1] < k]
        q.clear()
        q.extend(keep)
    dev_tasks.sort(key=lambda t: t[1])
    for j, t in enumerate(dev_tasks):
        shards[j % len(shards)].append(t)
    return shards, delta


def pop_device_task(shards: list[deque], lane: int, sr: _StageRun,
                    runs: dict) -> tuple | None:
    """Pop the next runnable device slot for walker lane ``lane``.

    FIFO head of the lane's own shard first (super-table order), then the
    other shards' heads (a drained lane helps its neighbours before
    absorbing host work). Returns the task tuple or None.
    """
    n = len(shards)
    for j in range(n):
        dq = shards[(lane + j) % n]
        if dq and _task_ready(sr, runs, dq[0]):
            return dq.popleft()
    return None


def pop_device_run(shards: list[deque], lane: int, sr: _StageRun,
                   runs: dict, limit: int | None = None) -> list[tuple]:
    """Pop walker lane ``lane``'s next run of device slots.

    The head task is the one ``pop_device_task`` picks. When it heads the
    lane's own shard, the shard's next runnable tasks join it, up to half
    the shard and at most ``limit`` tasks; the rest stays for idle host
    workers to absorb. A concat stage takes them as they come. A sum
    stage takes a run only from where its ascending fold has reached, so
    the walk can start from the folded prefix, and only tasks that
    continue it row by row: with several lanes, whose shards interleave,
    that is one task a launch. Returns the tasks in row order, empty when
    none is runnable.
    """
    n = len(shards)
    for j in range(n):
        dq = shards[(lane + j) % n]
        if not (dq and _task_ready(sr, runs, dq[0])):
            continue
        cap = max(1, (len(dq) + 1) // 2)
        if limit is not None:
            cap = min(cap, max(1, limit))
        run = [dq.popleft()]
        concat = sr.stage.combine == "concat"
        if j > 0 or not (concat or _frontier(sr) == run[0][1]):
            return run
        while (len(run) < cap and dq and _task_ready(sr, runs, dq[0])
               and (concat or dq[0][1] == run[-1][1] + run[-1][2])):
            run.append(dq.popleft())
        return run
    return []


def _frontier(sr: _StageRun) -> int | None:
    """The row a sum stage's ascending fold takes next (None: not kept)."""
    front = getattr(sr, "frontier", None)
    return None if front is None else front()


def walk_device_run(lowering, stage: str, tasks: list[tuple], inputs: dict,
                    seed=None) -> list:
    """Walk ``tasks`` (tile-unit chunks of ``stage``) in one launch.

    ``lowering`` is the vee ``DeviceLowering`` of the DAG. The walk runs
    one slot a tile, in the tasks' order, on the device the lowering's
    values lie on (K1 for CUDA tensors, the plain walker for CPU ones).
    The producers the stage reads come from the host's ``inputs``, copied
    to that device; a sum stage starts from ``seed`` when one is given.
    Returns host values: for a concat stage each task's rows, shaped as
    the stage's host op returns them; for a sum stage a one-element list,
    the run's sum.
    """
    by_name = {s.name: s for s in lowering.stages}
    ws = by_name[stage]
    tile = lowering.tile
    device = lowering.values[lowering.operands[0].name].device

    def on_device(x, spec):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        return t.reshape(spec.out_shape).to(device=device, dtype=spec.out_dtype)

    operands = [op for op in lowering.operands if op.name in ws.operands]
    values = {n: lowering.values[n] for n in ws.operands}
    for prod, kind in ws.reads:
        p = by_name[prod]
        rest = tuple(p.out_shape[1:])
        operands.append(
            WalkOperand(prod, tuple(p.out_shape), ("zero",) * len(p.out_shape))
            if kind == "full" else
            WalkOperand(prod, (tile,) + rest, ("row",) + ("zero",) * len(rest)))
        values[prod] = on_device(inputs[prod], p)
    if seed is not None:
        key = f"{stage}__prefix"
        values[key] = on_device(seed, ws)
        ws = dataclasses.replace(ws, seed=key)
    table = np.asarray([(0, t * tile, tile) for _, s, z in tasks
                        for t in range(s, s + z)], dtype=np.int32).reshape(-1, 3)
    with _WALK_LOCK:
        out = dag_walk([ws], operands, values, table, tile)[stage].cpu()
    if ws.combine == "sum":
        return [out]
    rest = tuple(ws.out_shape[1:])
    return [out[s * tile:(s + z) * tile].reshape((z, tile) + rest)
            for _, s, z in tasks]


def run_tasks(lowering, sr: _StageRun, tasks: list[tuple], inputs: dict,
              seed=None) -> list:
    """The values of ``tasks``: walked over ``lowering`` when one is given
    (``walk_device_run``), else the stage's host op on the one task."""
    if lowering is not None:
        return walk_device_run(lowering, sr.stage.name, tasks, inputs, seed)
    _, s, z = tasks[0]
    return [sr.stage.op(inputs, s, z)]


def at_frontier(sr: _StageRun, tasks: list[tuple]) -> bool:
    """Do ``tasks`` start a sum stage's run where its ascending fold has
    reached? Such a run walks on from the prefix and becomes the prefix."""
    return sr.stage.combine == "sum" and _frontier(sr) == tasks[0][1]


def run_spans(tasks: list[tuple], rel0: float, rel1: float) -> list[tuple]:
    """``(dt, rel0, rel1)`` of each task of a run walked over
    ``[rel0, rel1]``: the launch's time shared out by rows, in row order."""
    rows = np.cumsum([0] + [z for _, _, z in tasks], dtype=float)
    edges = rel0 + (rel1 - rel0) * rows / rows[-1]
    return [(float(b - a), float(a), float(b))
            for a, b in zip(edges[:-1], edges[1:])]


def steal_device_tail(shards: list[deque], sr: _StageRun,
                      runs: dict) -> tuple[tuple | None, int]:
    """Absorb part of a device shard's unpopped tail onto the host side.

    Steals from the TAIL of the fullest shard deque (the thief
    discipline of the distributed queues). For concat stages a contiguous, runnable tail run of up
    to half the deque is coalesced into ONE host-granularity chunk via
    ``rechunk_pending`` (appended to the stage's realized schedule); sum
    stages move a single task unchanged, preserving the chunk boundaries
    the ascending partial fold depends on. Returns
    ``(task_or_None, remaining_delta)`` for the caller's totals.
    """
    dq = max(shards, key=len, default=None)
    if not dq:
        return None, 0
    if not _task_ready(sr, runs, dq[-1]):
        return None, 0
    if sr.stage.combine != "concat" or len(dq) < 2:
        return dq.pop(), 0
    # longest runnable, contiguous tail run (bounded to half the deque)
    run: list[tuple] = [dq[-1]]
    limit = max(1, len(dq) // 2)
    idx = len(dq) - 2
    while len(run) < limit and idx >= 0:
        t = dq[idx]
        if t[1] + t[2] != run[0][1] or not _task_ready(sr, runs, t):
            break
        run.insert(0, t)
        idx -= 1
    for _ in run:
        dq.pop()
    if len(run) == 1:
        return run[0], 0
    # the run is contiguous by construction, so merging at target=total
    # always collapses it to exactly one host-granularity chunk
    total = sum(z for _, _, z in run)
    (s0, z0), = rechunk_pending([(s, z) for _, s, z in run], total)
    task = (len(sr.costs), int(s0), int(z0))
    sr.schedule = np.vstack([
        np.asarray(sr.schedule).reshape(-1, 2),
        np.array([[s0, z0]]).reshape(-1, 2),
    ]).astype(np.int32)
    sr.costs = np.concatenate([sr.costs, np.zeros(1)])
    sr.executed = np.concatenate([sr.executed, np.zeros(1, dtype=bool)])
    sr.remaining += 1 - len(run)
    sr.resizes += 1
    return task, 1 - len(run)


@dataclass
class HeteroResult(DagResult):
    """Whole-DAG outcome of one heterogeneous co-execution run.

    Extends DagResult: ``per_worker_busy_s``/``per_worker_tasks`` list the
    host workers first, then the ``n_device`` walker lanes.
    ``absorbed_by_host`` / ``absorbed_by_device`` count cross-substrate
    rebalancing moves; ``cross_consumptions`` counts chunks that consumed
    at least one row the other substrate produced. Each such consumption
    also lands as a ``TransferEvent`` in ``transfer_events`` (zero
    duration — the copy is not separately timed on the threaded pool), so
    the inherited ``DagResult.stats`` folds the same counts into
    ``DagStats.transfers``/``transfer_s`` that the hetero simulator
    reports.
    """

    n_host_workers: int = 0
    n_device: int = 0
    absorbed_by_host: int = 0
    absorbed_by_device: int = 0
    cross_consumptions: dict[str, int] = field(default_factory=dict)
    placement: Placement | None = None


class HeteroExecutor:
    """Run a PipelineDAG across the host pool AND device walker lanes.

    ``config`` shapes the host side exactly as in PipelineExecutor
    (``Submission.per_stage`` overrides included); ``placement`` (a
    core.placement.Placement) assigns each stage HOST, DEVICE, or
    SPLIT(fraction) — the device owning the leading rows. ``n_device``
    walker lanes drain the device ranges in super-table order; with
    ``rebalance=True`` (default) idle host workers absorb device tails
    and drained device lanes absorb host chunks. ``lowering`` (the DAG's
    vee ``DeviceLowering``) makes the lanes walk their runs on the
    walker; without it they run the stages' host ops. See the module
    docstring for the substrate, streaming, and bit-equality semantics.
    """

    def __init__(
        self,
        dag: PipelineDAG,
        config: SchedulerConfig,
        placement: Placement,
        n_device: int = 1,
        rebalance: bool = True,
        tracer=None,
        lowering=None,
    ):
        self.dag = dag
        self.config = config
        self.placement = placement
        d = config.numa_domains
        self._domains = list(d) if d is not None else [0] * config.n_workers
        self.n_device = max(1, n_device)
        self.rebalance = rebalance
        self.tracer = as_tracer(tracer)
        self.lowering = lowering

    def run(self, sub=None) -> HeteroResult:
        """Execute every stage to completion across both substrates.

        ``sub`` (a ``Submission``) may carry per-submission knobs:
        ``sub.dag`` replaces the constructor DAG for this run,
        ``sub.per_stage`` supplies per-stage overrides,
        ``sub.placement`` replaces the constructor placement, and
        ``sub.lowering`` the constructor lowering.
        """
        res, _ck = self._run(sub, preempt_after=None)
        return res

    def run_preemptible(self, preempt_after: int, sub=None):
        """Run until ``preempt_after`` chunks have folded, then checkpoint.

        The eviction protocol on the co-execution pool: once the
        count is reached, host workers and device lanes stop *popping*
        but finish the chunk they hold (chunk-boundary semantics), and
        the unpopped remainder — host queues AND device shard deques —
        freezes into a ``core.preempt.JobCheckpoint``. Returns
        ``(HeteroResult, None)`` when the run drains first, else
        ``(None, checkpoint)``; ``core.preempt.resume_on_host`` (or a
        fresh device lowering) continues it bit-equal, because the sum
        fold here is already the ascending-prefix association the
        checkpoint format requires.
        """
        return self._run(sub, preempt_after=int(preempt_after))

    def _run(self, sub, preempt_after: int | None):
        """Shared body of run/run_preemptible."""
        overrides = {}
        if sub is not None:
            from .submit import as_submission

            sub = as_submission(sub)
            if (sub.dag is not None and sub.dag is not self.dag) \
                    or sub.placement is not None or sub.lowering is not None:
                ex = HeteroExecutor(
                    sub.dag if sub.dag is not None else self.dag,
                    self.config,
                    sub.placement if sub.placement is not None
                    else self.placement,
                    n_device=self.n_device, rebalance=self.rebalance,
                    tracer=self.tracer,
                    lowering=sub.lowering if sub.lowering is not None
                    else self.lowering)
                return ex._run(sub.replace(dag=None, placement=None,
                                           lowering=None), preempt_after)
            overrides.update(sub.per_stage or {})
        from .preempt import JobCheckpoint, PreemptableStageRun

        # PreemptableStageRun folds sum partials in ascending row order
        runs = {name: PreemptableStageRun(
                    self.dag.stages[name],
                    _resolve_stage_config(self.config, self.dag.stages[name],
                                          overrides.get(name)),
                    self._domains)
                for name in self.dag.order}
        order = [runs[n] for n in self.dag.order]
        nstages = len(order)
        n_workers = self.config.n_workers
        n_device = self.n_device
        low = self.lowering
        n_lanes = n_workers + n_device

        device_qs: dict[str, list[deque]] = {}
        remaining_total = sum(sr.remaining for sr in order)
        for name in self.dag.order:
            sr = runs[name]
            k = self.placement.device_rows(name, sr.stage.n_rows)
            shards, delta = split_device_tasks(sr, k, n_device)
            device_qs[name] = shards
            remaining_total += delta

        # which substrate produced each row (0 host, 1 device): feeds the
        # cross-substrate consumption accounting in HeteroResult.stats
        row_side = {n: np.zeros(runs[n].stage.n_rows, dtype=np.int8)
                    for n in self.dag.order}
        full_cross: dict[tuple[str, int], bool] = {}

        cond = threading.Condition()
        events = EventLog(TaskEvent)
        tracer = self.tracer
        traced = tracer.enabled
        tjob = tracer.job
        transfers: list[TransferEvent] = []
        errors: list[BaseException] = []
        busy = [0.0] * n_lanes
        ntasks = [0] * n_lanes
        steals = [0]
        absorbed = [0, 0]   # [by_host, by_device]
        cross: dict[str, int] = {}
        n_done = [0]
        stop = [False]      # lanes stop popping at the next chunk boundary
        t0_run = time.perf_counter()

        def consumed_cross(sr: _StageRun, task, is_dev: bool) -> str | None:
            """Producer whose rows crossed the substrate boundary, or None."""
            _, s, z = task
            me = 1 if is_dev else 0
            for d in sr.stage.deps:
                side = row_side[d.producer]
                if d.kind == "full":
                    # the producer is done (pop gating), so its row sides
                    # are final: scan once per (producer, substrate)
                    key = (d.producer, me)
                    if key not in full_cross:
                        full_cross[key] = bool((side != me).any())
                    if full_cross[key]:
                        return d.producer
                elif (side[s:s + z] != me).any():
                    return d.producer
            return None

        def record(sr, task, value, dt, lane, rel0, rel1, stolen, wait_s,
                   is_dev, walked=False, fold=True):
            """Fold one chunk into stage + run accounting (lock held);
            ``fold=False``: the stage has it already (a prefix run)."""
            nonlocal remaining_total
            i, s, z = task
            # the ascending-row fold: bit-equal to the host-only SS/1-worker
            # accumulation no matter which lane ran which chunk
            if fold:
                sr.record(task, value, dt, rel0, rel1)
            if is_dev:
                row_side[sr.stage.name][s:s + z] = 1
            name = sr.stage.name
            remaining_total -= 1
            events.append_raw(name, i, s, z, lane, rel0, rel1, stolen, wait_s)
            if traced:
                tracer.record_raw(
                    "exec", tjob, name, i, lane, rel0, rel1,
                    (F_STOLEN if stolen else 0) | (F_DEVICE if walked else 0),
                    wait_s)
            busy[lane] += dt
            ntasks[lane] += 1
            steals[0] += int(stolen)
            n_done[0] += 1
            if (preempt_after is not None and not stop[0]
                    and remaining_total > 0 and n_done[0] >= preempt_after):
                stop[0] = True

        def pick(lane: int, is_dev: bool, cursor: int):
            """Next (run, tasks, stolen, absorbed, cursor, remaining-delta)
            for this lane, or None (lock held). ``tasks`` is one task, or
            a walker lane's run (``pop_device_run``)."""
            if is_dev:
                d = lane - n_workers
                limit = (None if preempt_after is None
                         else preempt_after - n_done[0])
                for kk in range(nstages):
                    idx = (cursor + kk) % nstages
                    sr = order[idx]
                    if low is not None:
                        got = pop_device_run(device_qs[sr.stage.name], d, sr,
                                             runs, limit)
                    else:
                        got = pop_device_task(device_qs[sr.stage.name], d, sr,
                                              runs)
                        got = [got] if got is not None else []
                    if got:
                        return sr, got, False, False, (idx + 1) % nstages, 0
                if self.rebalance:
                    for kk in range(nstages):
                        idx = (cursor + kk) % nstages
                        sr = order[idx]
                        if sr.remaining == 0:
                            continue
                        got, stolen = _try_pop(sr, runs, lane)
                        if got is not None:
                            absorbed[1] += 1
                            return (sr, [got], stolen, True,
                                    (idx + 1) % nstages, 0)
                return None
            for kk in range(nstages):
                idx = (cursor + kk) % nstages
                sr = order[idx]
                if sr.remaining == 0:
                    continue
                got, stolen = _try_pop(sr, runs, lane)
                if got is not None:
                    return sr, [got], stolen, False, (idx + 1) % nstages, 0
            if self.rebalance:
                for kk in range(nstages):
                    idx = (cursor + kk) % nstages
                    sr = order[idx]
                    got, delta = steal_device_tail(
                        device_qs[sr.stage.name], sr, runs)
                    if got is not None:
                        absorbed[0] += 1
                        return (sr, [got], True, True, (idx + 1) % nstages,
                                delta)
            return None

        def worker(lane: int) -> None:
            """Pool/walker thread: pop runnable chunks until the DAG drains.

            The whole loop runs under one error boundary: an exception
            anywhere (pick/steal bookkeeping as much as a stage op) lands
            in ``errors`` and is re-raised by run() — a lane must never
            die silently and leave the run to report success without it.
            """
            nonlocal remaining_total
            is_dev = lane >= n_workers
            walks = is_dev and low is not None
            cursor = lane % nstages
            try:
                while True:
                    sr = tasks = None
                    stolen = was_absorbed = False
                    t_idle = time.perf_counter()
                    with cond:
                        while True:
                            if errors or stop[0] or remaining_total == 0:
                                return
                            got = pick(lane, is_dev, cursor)
                            if got is not None:
                                (sr, tasks, stolen, was_absorbed, cursor,
                                 delta) = got
                                remaining_total += delta
                                break
                            cond.wait(timeout=0.05)
                        inputs = _stage_inputs(sr, runs)
                        crossed = [consumed_cross(sr, t, is_dev)
                                   for t in tasks]
                        at_front = walks and at_frontier(sr, tasks)
                        seed = sr.prefix() if at_front else None
                    t0 = time.perf_counter()
                    values = run_tasks(low if walks else None, sr, tasks,
                                       inputs, seed)
                    t1 = time.perf_counter()
                    with cond:
                        spans = run_spans(tasks, t0 - t0_run, t1 - t0_run)
                        if at_front:
                            sr.record_prefix(tasks, values[0], spans)
                        for k, task in enumerate(tasks):
                            dt, r0, r1 = spans[k]
                            record(sr, task, values[min(k, len(values) - 1)],
                                   dt, lane, r0, r1, stolen or was_absorbed,
                                   t0 - t_idle if k == 0 else 0.0, is_dev,
                                   walked=walks, fold=not at_front)
                            if crossed[k] is None:
                                continue
                            name = sr.stage.name
                            cross[name] = cross.get(name, 0) + 1
                            # zero duration: the threaded pool shares
                            # memory, the copy is not separately timed
                            transfers.append(TransferEvent(
                                crossed[k], name, task[2], r0, r0, is_dev))
                            if traced:
                                tracer.record_raw(
                                    "transfer", tjob, name, task[0], lane,
                                    r0, r0, F_DEVICE if walks else 0, 0.0,
                                    f"from={crossed[k]}")
                        cond.notify_all()
            except BaseException as e:  # surfaced to the caller below
                with cond:
                    errors.append(e)
                    cond.notify_all()

        threads = [threading.Thread(target=worker, args=(lane,), daemon=True)
                   for lane in range(n_lanes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        wall = time.perf_counter() - t0_run

        if stop[0] and remaining_total > 0:
            stages_ck = {}
            for name in self.dag.order:
                # the host queues' remainder, plus the device shards'
                sck = runs[name].checkpoint()
                dev = [(int(s), int(z)) for dq in device_qs[name]
                       for _i, s, z in dq]
                stages_ck[name] = dataclasses.replace(
                    sck, pending=tuple(sorted(sck.pending + tuple(dev))))
            ck = JobCheckpoint(job="hetero", stages=stages_ck,
                               substrate="hetero", taken_at=wall,
                               reason="preempt_after")
            ck.validate(self.dag)
            if traced:
                tracer.mark("checkpoint", wall, tjob,
                            detail="preempt_after")
            return None, ck

        stage_results = {
            name: StageResult(value=sr.value, schedule=sr.schedule,
                              per_task_costs=sr.costs, config=sr.cfg,
                              t_first=sr.t_first, t_last=sr.t_last)
            for name, sr in runs.items()
        }
        res = HeteroResult(
            values={n: r.value for n, r in stage_results.items()},
            stages=stage_results, events=events, wall_time_s=wall,
            steals=steals[0], per_worker_busy_s=busy, per_worker_tasks=ntasks,
            n_host_workers=n_workers, n_device=n_device,
            absorbed_by_host=absorbed[0], absorbed_by_device=absorbed[1],
            cross_consumptions=cross, placement=self.placement,
            transfer_events=transfers)
        return res, None
