"""Host data pipeline scheduled by DaphneSched (the port's copy of
``data/pipeline.py``; DESIGN.md §6.1).

Batch assembly for LM training is row-parallel work: each task packs one
range of sample rows into the global batch buffer. The pipeline
partitions each step's rows with a DLS technique (``chunk_schedule``),
turns the chunks into tasks (``tasks_from_schedule``) and runs them on the
port's threaded ``ScheduledExecutor`` (per-worker queues and stealing by
default): the paper's scheduler at the data layer, where task costs vary
(variable-length documents).

The token matrices are numpy int32, bitwise the reference's for each step:
a row's documents come from a generator seeded by the row's own index, so
which worker packs a row never changes what goes in it. ``prefetch``
assembles batch t + 1 on a background thread while the device runs batch
t.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from ..core.executor import ScheduledExecutor, SchedulerConfig
from ..core.partitioners import chunk_schedule
from ..core.task import tasks_from_schedule

__all__ = ["SyntheticCorpus", "DataPipeline"]


@dataclass
class SyntheticCorpus:
    """Length-skewed synthetic documents over a vocab (no I/O)."""

    vocab_size: int
    mean_len: float = 512.0
    sigma: float = 1.0
    seed: int = 0

    def sample_doc(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, doc_id))
        n = max(8, int(rng.lognormal(np.log(self.mean_len), self.sigma)))
        return rng.integers(0, self.vocab_size, n, dtype=np.int32)


class DataPipeline:
    """Packs documents into ``(global_batch, seq_len + 1)`` token matrices."""

    def __init__(self, corpus: SyntheticCorpus, global_batch: int, seq_len: int,
                 sched: SchedulerConfig | None = None):
        self.corpus = corpus
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.sched = sched or SchedulerConfig(
            technique="GSS", queue_layout="PERCORE", victim_strategy="SEQPRI",
            n_workers=4)
        self._executor = ScheduledExecutor(self.sched)
        self.last_stats = None

    # -- one batch = global_batch row-tasks ------------------------------------
    def assemble(self, step: int) -> np.ndarray:
        """The token matrix of ``step``."""
        out = np.zeros((self.global_batch, self.seq_len + 1), np.int32)
        base = step * self.global_batch

        def pack_rows(start: int, size: int):
            for r in range(start, start + size):
                buf, fill, d = [], 0, 0
                while fill < self.seq_len + 1:
                    doc = self.corpus.sample_doc(base * 131 + r * 17 + d)
                    buf.append(doc)
                    fill += len(doc)
                    d += 1
                out[r] = np.concatenate(buf)[: self.seq_len + 1]  # rows disjoint
            return size

        schedule = chunk_schedule(self.sched.technique, self.global_batch,
                                  self.sched.n_workers, seed=self.sched.seed)
        results, stats = self._executor.run(tasks_from_schedule(schedule, pack_rows))
        if sum(results.values()) != self.global_batch:
            raise RuntimeError(f"packed {sum(results.values())} rows of "
                               f"{self.global_batch}")
        self.last_stats = stats
        return out

    def batches(self, n_steps: int, start_step: int = 0):
        for s in range(start_step, start_step + n_steps):
            yield {"tokens": self.assemble(s)}

    def prefetch(self, n_steps: int, depth: int = 2, start_step: int = 0):
        """Background-thread prefetch: overlap host assembly with the device
        step. An exception in the producer is raised in the consumer."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = object()

        def producer():
            try:
                for b in self.batches(n_steps, start_step):
                    q.put(b)
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)
            q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, Exception):
                raise item
            yield item
