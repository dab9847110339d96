"""Queue layouts of DaphneSched (paper §3 'Queue management').

Three layouts:
  CENTRALIZED  one lock-protected queue per computing-resource type; workers
               self-schedule chunks from it via the partitioner.
  PERCORE      one queue per worker; empty workers steal.
  PERGROUP     one queue per worker group (NUMA domain / CPU socket); the
               input is pre-partitioned into #groups blocks first (the paper
               shows this restores locality for STATIC).

The centralized layout computes chunks lazily (Partitioner.next_chunk at pop
time). Distributed layouts pre-fill queues with the partitioner's chunk
sequence (round-robin across queues, preserving the technique's granularity
sequence), and *stealing amounts follow the partitioning technique* — the
paper's contribution C.2: a thief steals ``getNextChunk(R_victim)`` tasks
from the victim's queue tail.

Two implementations of each layout (DESIGN.md §16):

  ``deque``  the original lock-guarded ``collections.deque`` queues — kept
             as the reference for differential testing.
  ``slot``   preallocated slot-array queues over numpy index buffers:
             tasks live in one shared table, each queue holds int32 task
             indices between a head and a tail cursor, and fill-time chunk
             boundaries sit in a second index buffer. pop/steal are cursor
             bumps plus one slice; the steal amount (``next_chunk`` against
             the victim's remaining work) is memoized per remaining-count,
             since a fresh partitioner's first chunk is a pure function of
             (technique, remaining, n_workers, seed).

Both produce bit-identical pop/steal sequences (property-tested in
tests/test_torch_host.py against the reference package);
``SchedulerConfig.queue_impl`` selects.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

from .partitioners import (Partitioner, chunk_sizes, first_chunk_fn,
                           make_partitioner)
from .task import RangeTask

__all__ = [
    "CentralizedQueue", "DistributedQueues", "SlotCentralizedQueue",
    "SlotDistributedQueues", "QUEUE_LAYOUTS", "QUEUE_IMPLS",
]


class CentralizedQueue:
    """Single work queue + partitioner: classic self-scheduling.

    ``pop(worker_id)`` returns a list of RangeTasks forming one chunk.
    Lock contention on this queue is the effect the paper measures (P5);
    ``contended_pops`` counts pops that had to wait on the lock.
    """

    def __init__(self, tasks: list[RangeTask], partitioner: Partitioner):
        self._tasks = deque(tasks)
        self._part = partitioner
        self._lock = threading.Lock()
        self.contended_pops = 0
        self.pops = 0

    def pop(self, worker_id: int = 0) -> list[RangeTask]:
        """Take the next technique-sized chunk off the shared queue."""
        acquired = self._lock.acquire(blocking=False)
        if not acquired:
            self._lock.acquire()
            self.contended_pops += 1
        try:
            self.pops += 1
            n = self._part.next_chunk(worker_id)
            out = []
            while n > 0 and self._tasks:
                out.append(self._tasks.popleft())
                n -= 1
            return out
        finally:
            self._lock.release()

    def __len__(self) -> int:
        with self._lock:
            return len(self._tasks)

    def counters(self) -> dict[str, int]:
        """Uniform counter snapshot for core.telemetry collectors."""
        return {"pops": self.pops, "contended_pops": self.contended_pops,
                "depth": len(self)}


class _WorkerQueue:
    __slots__ = ("dq", "lock", "partitioner", "chunks", "pops", "steals",
                 "failed_steals")

    def __init__(self, partitioner: Partitioner):
        self.dq: deque[RangeTask] = deque()
        self.lock = threading.Lock()
        self.partitioner = partitioner
        # fill-time chunk boundaries (task counts), head-to-tail: pop_local
        # takes a whole pre-filled chunk per lock round-trip (paper
        # self-scheduling granularity), steal re-aligns the tail boundaries.
        self.chunks: deque[int] = deque()
        # per-queue counters, each mutated only under THIS queue's lock
        # (a shared counter would race across queues); DistributedQueues
        # sums them on read.
        self.pops = 0
        self.steals = 0
        self.failed_steals = 0


class DistributedQueues:
    """PERCORE / PERGROUP queues with technique-driven stealing (paper C.2).

    ``n_queues`` == n_workers (PERCORE) or #groups (PERGROUP).
    ``owner_of(worker_id)`` maps a worker to its home queue.

    Pre-filling: the global chunk sequence of the chosen partitioner is dealt
    round-robin to queues (PERCORE), or the input is pre-partitioned into
    #groups contiguous blocks and each block's chunks go to that group's
    queue (PERGROUP — preserves spatial locality, paper Fig 8/9 discussion).

    Stealing: a thief pops from the victim queue's *tail* an amount equal to
    ``steal_partitioner.next_chunk()`` recomputed against the victim's
    remaining tasks — i.e. stolen granularity follows the self-scheduling
    technique.
    """

    def __init__(
        self,
        tasks: list[RangeTask],
        technique: str,
        n_workers: int,
        layout: str = "PERCORE",
        groups: list[int] | None = None,
        seed: int = 0,
    ):
        layout = layout.upper()
        if layout not in ("PERCORE", "PERGROUP"):
            raise ValueError(f"layout must be PERCORE or PERGROUP, got {layout}")
        self.layout = layout
        self.n_workers = n_workers
        self.technique = technique
        self.seed = seed
        groups = list(groups) if groups is not None else [0] * n_workers
        self._group_of = groups
        n_groups = max(groups) + 1

        if layout == "PERCORE":
            self.n_queues = n_workers
            self._home = list(range(n_workers))
        else:
            self.n_queues = n_groups
            self._home = groups

        self._queues = [
            _WorkerQueue(make_partitioner(technique, max(1, len(tasks)), n_workers, seed=seed + q))
            for q in range(self.n_queues)
        ]
        self._fill(tasks)

    # -- filling ---------------------------------------------------------------
    def _fill(self, tasks: list[RangeTask]) -> None:
        n = len(tasks)
        if n == 0:
            return
        if self.layout == "PERGROUP":
            # Pre-partition into #queues contiguous blocks (spatial locality),
            # then chunk each block with the technique.
            block = -(-n // self.n_queues)
            for q in range(self.n_queues):
                blk = tasks[q * block : (q + 1) * block]
                part = make_partitioner(
                    self.technique, max(1, len(blk)), max(1, self.n_workers // self.n_queues),
                    seed=self.seed + q,
                )
                i = 0
                while i < len(blk):
                    c = part.next_chunk()
                    if c == 0:
                        break
                    self._queues[q].dq.extend(blk[i : i + c])
                    self._queues[q].chunks.append(min(c, len(blk) - i))
                    i += c
                if i < len(blk):  # safety: never drop tasks
                    self._queues[q].dq.extend(blk[i:])
                    self._queues[q].chunks.append(len(blk) - i)
        else:
            # PERCORE: global chunk sequence dealt round-robin to workers —
            # no pre-partitioning (the paper observes STATIC then loses
            # locality, matching its Fig 8 discussion).
            part = make_partitioner(self.technique, n, self.n_workers, seed=self.seed)
            i, q = 0, 0
            while i < n:
                c = part.next_chunk()
                if c == 0:
                    break
                self._queues[q % self.n_queues].dq.extend(tasks[i : i + c])
                self._queues[q % self.n_queues].chunks.append(min(c, n - i))
                i += c
                q += 1
            if i < n:  # safety: never drop tasks
                self._queues[0].dq.extend(tasks[i:])
                self._queues[0].chunks.append(n - i)

    # -- worker API --------------------------------------------------------------
    @property
    def local_pops(self) -> int:
        """Total pop_local lock round-trips (incl. empty pops), all queues."""
        return sum(q.pops for q in self._queues)

    @property
    def steals(self) -> int:
        """Total successful steals across all victim queues."""
        return sum(q.steals for q in self._queues)

    @property
    def failed_steals(self) -> int:
        """Total steal probes that found an empty victim."""
        return sum(q.failed_steals for q in self._queues)

    def owner_of(self, worker_id: int) -> int:
        """Home queue id of ``worker_id`` (its own, or its NUMA domain's)."""
        return self._home[worker_id]

    def pop_local(self, worker_id: int) -> list[RangeTask]:
        """Take the next pre-filled chunk off the head of the home queue.

        Queues are filled in technique-sized chunks; one lock round-trip
        returns the WHOLE chunk recorded at fill time (the paper's
        self-scheduling granularity) instead of a single task — restoring
        chunked semantics at pop time and cutting lock traffic by the
        chunk size. Returns [] when the queue is empty.
        """
        q = self._queues[self.owner_of(worker_id)]
        with q.lock:
            q.pops += 1
            if not q.dq:
                return []
            c = q.chunks.popleft() if q.chunks else len(q.dq)
            c = max(1, min(c, len(q.dq)))
            return [q.dq.popleft() for _ in range(c)]

    def steal(self, thief_id: int, victim_queue: int) -> list[RangeTask]:
        """Steal from the victim's tail; amount follows the technique (C.2).

        The stolen tasks are a contiguous tail run in their original
        (ascending-range) order — the paper steals a chunk, not a reversed
        chunk — so PERGROUP pre-partitioning locality survives the theft.
        """
        q = self._queues[victim_queue]
        with q.lock:
            r = len(q.dq)
            if r == 0:
                q.failed_steals += 1
                return []
            # chunk computed against the victim's remaining work
            part = make_partitioner(self.technique, r, self.n_workers, seed=self.seed)
            c = max(1, min(r, part.next_chunk(thief_id)))
            stolen = [q.dq.pop() for _ in range(c)]
            stolen.reverse()  # tail run, original task order
            rem = c  # re-align the victim's fill-time tail boundaries
            while rem and q.chunks:
                last = q.chunks.pop()
                if last > rem:
                    q.chunks.append(last - rem)
                    rem = 0
                else:
                    rem -= last
            q.steals += 1
            return stolen

    def queue_sizes(self) -> list[int]:
        """Current length of every queue (diagnostics)."""
        return [len(q.dq) for q in self._queues]

    def push_local(self, worker_id: int, tasks: list[RangeTask]) -> None:
        """Append ``tasks`` to the worker's home queue (steal returns).

        The pushed run is recorded as ONE chunk boundary, so the thief
        drains its loot in a single pop_local round-trip.
        """
        q = self._queues[self.owner_of(worker_id)]
        with q.lock:
            q.dq.extend(tasks)
            if tasks:
                q.chunks.append(len(tasks))

    def __len__(self) -> int:
        return sum(self.queue_sizes())

    def counters(self) -> dict[str, int]:
        """Uniform counter snapshot for core.telemetry collectors."""
        return {"pops": self.local_pops, "steals": self.steals,
                "failed_steals": self.failed_steals, "depth": len(self)}


class SlotCentralizedQueue:
    """Slot-array centralized queue: head cursor over a frozen chunk table.

    Behaviourally identical to ``CentralizedQueue``: the k-th pop receives
    the k-th chunk of the technique's sequence no matter which worker pops
    (``Partitioner._chunk`` never reads the worker id and pops serialize
    under the queue lock in both implementations), so the whole boundary
    table can be materialized once at fill time and each pop becomes two
    cursor bumps plus one list slice — no partitioner lock, no per-task
    deque traffic.
    """

    __slots__ = ("_tasks", "_bounds", "_ci", "_head", "_lock",
                 "contended_pops", "pops")

    def __init__(self, tasks: list[RangeTask], technique: str,
                 n_workers: int, seed: int = 0):
        self._tasks = list(tasks)
        sizes = chunk_sizes(technique, len(tasks), n_workers, seed=seed)
        self._bounds = np.cumsum(np.asarray(sizes, dtype=np.int64))
        self._ci = 0          # chunk cursor into the boundary table
        self._head = 0        # first unpopped task
        self._lock = threading.Lock()
        self.contended_pops = 0
        self.pops = 0

    def pop_range(self, worker_id: int = 0) -> tuple[int, int]:
        """O(1) pop: the [start, end) slice of the task list forming the
        next chunk — two cursor bumps under the lock, nothing else. The
        caller slices the (shared, immutable) task list itself; this is
        the primitive the executor hot path drains."""
        acquired = self._lock.acquire(blocking=False)
        if not acquired:
            self._lock.acquire()
            self.contended_pops += 1
        try:
            self.pops += 1
            if self._ci >= len(self._bounds):
                return (0, 0)
            h = self._head
            e = min(int(self._bounds[self._ci]), len(self._tasks))
            self._ci += 1
            self._head = e
            return (h, e)
        finally:
            self._lock.release()

    def pop(self, worker_id: int = 0) -> list[RangeTask]:
        """Take the next technique-sized chunk off the shared queue."""
        h, e = self.pop_range(worker_id)
        return self._tasks[h:e]

    def __len__(self) -> int:
        with self._lock:
            return len(self._tasks) - self._head

    def counters(self) -> dict[str, int]:
        """Uniform counter snapshot for core.telemetry collectors."""
        return {"pops": self.pops, "contended_pops": self.contended_pops,
                "depth": len(self)}


_EMPTY_IDX = np.empty(0, dtype=np.int32)


class _SlotWorkerQueue:
    """One queue of the slot-array layout: index buffers + cursors.

    ``idx[head:tail]`` are the queued task indices (into the shared task
    table); ``bsz[bhead:btail]`` are the fill-time chunk sizes covering
    them head-to-tail. All cursors move under ``lock``.
    """

    __slots__ = ("idx", "head", "tail", "bsz", "bhead", "btail", "lock",
                 "pops", "steals", "failed_steals")

    def __init__(self, cap: int):
        self.idx = np.empty(max(1, cap), dtype=np.int32)
        self.head = 0
        self.tail = 0
        self.bsz = np.empty(max(1, cap), dtype=np.int32)
        self.bhead = 0
        self.btail = 0
        self.lock = threading.Lock()
        self.pops = 0
        self.steals = 0
        self.failed_steals = 0

    def _ensure(self, extra: int) -> None:
        """Room for ``extra`` more indices at the tail.

        Growth always REALLOCATES (never compacts in place): popped slices
        are handed out as views of the old buffer, and readers keeping a
        reference to it must never see their region overwritten.
        """
        if self.tail + extra <= len(self.idx):
            return
        cnt = self.tail - self.head
        new = np.empty(max(cnt + extra, 2 * len(self.idx)), dtype=np.int32)
        new[:cnt] = self.idx[self.head:self.tail]
        self.idx = new
        self.head, self.tail = 0, cnt

    def _ensure_bound(self) -> None:
        if self.btail < len(self.bsz):
            return
        cnt = self.btail - self.bhead
        new = np.empty(max(cnt + 1, 2 * len(self.bsz)), dtype=np.int32)
        new[:cnt] = self.bsz[self.bhead:self.btail]
        self.bsz = new
        self.bhead, self.btail = 0, cnt


class SlotDistributedQueues:
    """Slot-array PERCORE / PERGROUP queues (DESIGN.md §16).

    Same fill, pop, steal, and counter semantics as ``DistributedQueues``
    (bit-identical sequences, property-tested), with the deque replaced by
    numpy index buffers: ``pop_local`` bumps the head cursor over one
    fill-time chunk, ``steal`` slices the victim's tail (already in
    ascending order — no reversal needed), and ``steal_to_home`` moves the
    stolen index run straight into the thief's home buffer without ever
    materializing task objects, which the executor's steal path uses to
    make the whole theft one int32 copy.
    """

    def __init__(
        self,
        tasks: list[RangeTask],
        technique: str,
        n_workers: int,
        layout: str = "PERCORE",
        groups: list[int] | None = None,
        seed: int = 0,
    ):
        layout = layout.upper()
        if layout not in ("PERCORE", "PERGROUP"):
            raise ValueError(f"layout must be PERCORE or PERGROUP, got {layout}")
        self.layout = layout
        self.n_workers = n_workers
        self.technique = technique
        self.seed = seed
        groups = list(groups) if groups is not None else [0] * n_workers
        self._group_of = groups
        n_groups = max(groups) + 1

        if layout == "PERCORE":
            self.n_queues = n_workers
            self._home = list(range(n_workers))
        else:
            self.n_queues = n_groups
            self._home = groups

        # shared task table the int32 index buffers point into (a plain
        # list: numpy object arrays pay ~1 us per element to fill)
        self._tasks = list(tasks)
        self._steal_cache: dict[int, int] = {}
        # specialized r -> first-chunk closure: every steal recomputes the
        # technique chunk against the victim's remaining count, so even
        # the generic first_chunk dispatch is measurable on this path
        self._first_chunk = first_chunk_fn(technique, n_workers, seed=seed)
        self._queues = [_SlotWorkerQueue(0) for _ in range(self.n_queues)]
        self._fill(len(tasks))

    # -- filling ---------------------------------------------------------------
    def _fill(self, n: int) -> None:
        """Deal the chunk sequence exactly as the deque implementation does,
        then write each queue's task indices/boundaries into preallocated
        buffers in one pass."""
        if n == 0:
            return
        deals: list[list[tuple[int, int]]] = [[] for _ in range(self.n_queues)]
        if self.layout == "PERGROUP":
            block = -(-n // self.n_queues)
            for q in range(self.n_queues):
                lo, hi = q * block, min(n, (q + 1) * block)
                blen = hi - lo
                if blen <= 0:
                    continue
                part = make_partitioner(
                    self.technique, max(1, blen),
                    max(1, self.n_workers // self.n_queues),
                    seed=self.seed + q,
                )
                i = 0
                while i < blen:
                    c = part.next_chunk()
                    if c == 0:
                        break
                    deals[q].append((lo + i, min(c, blen - i)))
                    i += c
                if i < blen:  # safety: never drop tasks
                    deals[q].append((lo + i, blen - i))
        else:
            part = make_partitioner(self.technique, n, self.n_workers,
                                    seed=self.seed)
            i, k = 0, 0
            while i < n:
                c = part.next_chunk()
                if c == 0:
                    break
                deals[k % self.n_queues].append((i, min(c, n - i)))
                i += c
                k += 1
            if i < n:  # safety: never drop tasks
                deals[0].append((i, n - i))
        for q, chunks in enumerate(deals):
            total = sum(c for _, c in chunks)
            wq = _SlotWorkerQueue(total)
            wq.bsz = np.empty(max(1, len(chunks)), dtype=np.int32)
            pos = 0
            for b, (i, c) in enumerate(chunks):
                wq.idx[pos:pos + c] = np.arange(i, i + c, dtype=np.int32)
                wq.bsz[b] = c
                pos += c
            wq.tail = total
            wq.btail = len(chunks)
            self._queues[q] = wq

    # -- worker API --------------------------------------------------------------
    @property
    def local_pops(self) -> int:
        """Total pop_local lock round-trips (incl. empty pops), all queues."""
        return sum(q.pops for q in self._queues)

    @property
    def steals(self) -> int:
        """Total successful steals across all victim queues."""
        return sum(q.steals for q in self._queues)

    @property
    def failed_steals(self) -> int:
        """Total steal probes that found an empty victim."""
        return sum(q.failed_steals for q in self._queues)

    def owner_of(self, worker_id: int) -> int:
        """Home queue id of ``worker_id`` (its own, or its NUMA domain's)."""
        return self._home[worker_id]

    def _steal_amount(self, r: int, thief_id: int) -> int:
        """Technique chunk against ``r`` remaining tasks, memoized on ``r``.

        A fresh partitioner's first chunk is deterministic given
        (technique, r, n_workers, seed) — no ``_chunk`` implementation
        reads the worker id and seeded RNG state is per-instance — so the
        closed-form ``first_chunk`` (property-tested bit-equal to the real
        partitioners) reproduces ``DistributedQueues.steal`` exactly
        without paying partitioner+RNG construction per theft.
        """
        c = self._steal_cache.get(r)
        if c is None:
            c = self._steal_cache[r] = self._first_chunk(r)
        return c

    def pop_local_idx(self, worker_id: int) -> np.ndarray:
        """O(1) pop: the next fill-time chunk as an int32 index view.

        One lock round-trip does a boundary-cursor bump and a head-cursor
        bump; the returned array is a VIEW of the queue's index buffer —
        safe because the buffer is append-only at the tail (growth
        reallocates, never compacts) so a popped head region is never
        rewritten. The caller resolves indices against ``task_table()``
        as it executes — this is the primitive the executor hot path
        drains; ``pop_local`` wraps it for the task-list surface.
        """
        q = self._queues[self.owner_of(worker_id)]
        with q.lock:
            q.pops += 1
            cnt = q.tail - q.head
            if cnt == 0:
                return _EMPTY_IDX
            if q.bhead < q.btail:
                c = int(q.bsz[q.bhead])
                q.bhead += 1
            else:
                c = cnt
            c = max(1, min(c, cnt))
            h = q.head
            q.head = h + c
            return q.idx[h:h + c]

    def task_table(self) -> list[RangeTask]:
        """The shared task table the index buffers point into."""
        return self._tasks

    def pop_local(self, worker_id: int) -> list[RangeTask]:
        """Take the next fill-time chunk off the head of the home queue.

        Queues are filled in technique-sized chunks; one lock round-trip
        returns the WHOLE chunk recorded at fill time. Returns [] when
        the queue is empty.
        """
        got = self.pop_local_idx(worker_id)
        if not len(got):
            return []
        return list(map(self._tasks.__getitem__, got.tolist()))

    def _steal_indices(self, thief_id: int, victim_queue: int):
        """Cut the technique-sized tail run out of the victim (lock held
        by caller via this method); returns the index slice copy or None."""
        q = self._queues[victim_queue]
        cache = self._steal_cache
        with q.lock:
            tail = q.tail
            r = tail - q.head
            if r == 0:
                q.failed_steals += 1
                return None
            c = cache.get(r)
            if c is None:
                c = cache[r] = self._first_chunk(r)
            if c < 1:
                c = 1
            elif c > r:
                c = r
            s = tail - c
            loot = q.idx[s:tail].copy()   # tail run, ascending order
            q.tail = s
            rem = c  # re-align the victim's fill-time tail boundaries
            bsz, btail = q.bsz, q.btail
            while rem and btail > q.bhead:
                last = int(bsz[btail - 1])
                if last > rem:
                    bsz[btail - 1] = last - rem
                    rem = 0
                else:
                    rem -= last
                    btail -= 1
            q.btail = btail
            q.steals += 1
            return loot

    def steal(self, thief_id: int, victim_queue: int) -> list[RangeTask]:
        """Steal from the victim's tail; amount follows the technique (C.2).

        Returns the stolen tasks (ascending original order) exactly as
        ``DistributedQueues.steal`` does.
        """
        loot = self._steal_indices(thief_id, victim_queue)
        if loot is None:
            return []
        return list(map(self._tasks.__getitem__, loot.tolist()))

    def steal_to_home(self, thief_id: int, victim_queue: int) -> int:
        """Steal + push_local fused on index buffers: the victim's tail run
        lands in the thief's home queue as ONE chunk without materializing
        task objects. Returns the number of tasks moved (0 on failure)."""
        loot = self._steal_indices(thief_id, victim_queue)
        if loot is None:
            return 0
        q = self._queues[self.owner_of(thief_id)]
        with q.lock:
            c = len(loot)
            q._ensure(c)
            q.idx[q.tail:q.tail + c] = loot
            q.tail += c
            q._ensure_bound()
            q.bsz[q.btail] = c
            q.btail += 1
        return c

    def queue_sizes(self) -> list[int]:
        """Current length of every queue (diagnostics)."""
        return [q.tail - q.head for q in self._queues]

    def push_local(self, worker_id: int, tasks: list[RangeTask]) -> None:
        """Append ``tasks`` to the worker's home queue (steal returns).

        The pushed run is recorded as ONE chunk boundary, so the thief
        drains its loot in a single pop_local round-trip. This is the
        deque-compatible surface (differential tests, external callers);
        the executor's slot path fuses it into ``steal_to_home``, which
        never leaves the index space. Pushed tasks are appended to the
        task table — their old indices were already cut from the victim,
        so exactly-once is preserved.
        """
        if not tasks:
            return
        base = len(self._tasks)
        self._tasks.extend(tasks)
        q = self._queues[self.owner_of(worker_id)]
        with q.lock:
            c = len(tasks)
            q._ensure(c)
            q.idx[q.tail:q.tail + c] = np.arange(base, base + c,
                                                 dtype=np.int32)
            q.tail += c
            q._ensure_bound()
            q.bsz[q.btail] = c
            q.btail += 1

    def __len__(self) -> int:
        return sum(self.queue_sizes())

    def counters(self) -> dict[str, int]:
        """Uniform counter snapshot for core.telemetry collectors."""
        return {"pops": self.local_pops, "steals": self.steals,
                "failed_steals": self.failed_steals, "depth": len(self)}


QUEUE_LAYOUTS = ("CENTRALIZED", "PERCORE", "PERGROUP")
QUEUE_IMPLS = ("slot", "deque")
