"""Distributed-memory DaphneSched (the paper's Fig. 5).

The coordinator interfaces between the runtime and multiple shared-memory
DaphneSched instances ("nodes"). It divides pipeline inputs (distribute /
broadcast), ships the pipeline program, collects results, and performs the
cross-node analogue of work assignment. Nodes are in-process objects here
(one host); the message protocol is explicit so an MPI/RPC transport can
replace ``_send`` without touching scheduling logic — mirroring the
paper's "ongoing efforts ... via MPI and RPC".

Fault tolerance: each node carries an ``alive`` flag, and ``run``
re-schedules the row ranges of a failed node onto survivors (a node
failure costs one re-execution of its chunks, not a job restart).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from .executor import ScheduledExecutor, SchedulerConfig
from .partitioners import chunk_schedule
from .task import tasks_from_schedule

__all__ = ["NodeSched", "Coordinator", "CoordinatorConfig"]


@dataclass(frozen=True)
class CoordinatorConfig:
    """Cluster shape + cross-node/within-node scheduling knobs (Fig. 5)."""

    n_nodes: int = 2
    node_workers: int = 4
    technique: str = "GSS"          # cross-node partitioning technique
    node_technique: str = "GSS"     # within-node technique
    node_queue_layout: str = "CENTRALIZED"
    victim_strategy: str = "SEQ"
    seed: int = 0


class NodeSched:
    """One shared-memory DaphneSched instance (paper Fig. 5 right side).

    Listens for messages: ('broadcast', name, array), ('distribute', name,
    array_slice), ('program', fn), ('run', row_offset) → returns partials.
    """

    def __init__(self, node_id: int, config: CoordinatorConfig):
        self.node_id = node_id
        self.config = config
        self.store: dict[str, np.ndarray] = {}
        self.program: Callable | None = None
        self.alive = True

    def recv(self, msg: tuple) -> Any:
        """Handle one coordinator message (the node's transport endpoint)."""
        if not self.alive:
            raise ConnectionError(f"node {self.node_id} is down")
        kind = msg[0]
        if kind == "broadcast" or kind == "distribute":
            _, name, arr = msg
            self.store[name] = arr
            return None
        if kind == "program":
            self.program = msg[1]
            return None
        if kind == "run":
            _, lo, hi = msg
            return self._run_local(lo, hi)
        raise ValueError(f"unknown message {kind!r}")

    def _run_local(self, lo: int, hi: int) -> dict[int, Any]:
        """Generate local tasks for rows [lo, hi) and execute them."""
        cfg = self.config
        n = hi - lo

        def op(start: int, size: int):
            """Apply the shipped program to one local row range."""
            return self.program(self.store, lo + start, size)

        sched = chunk_schedule(cfg.node_technique, n, cfg.node_workers, seed=cfg.seed)
        tasks = tasks_from_schedule(sched, op)
        ex = ScheduledExecutor(
            SchedulerConfig(
                technique=cfg.node_technique,
                queue_layout=cfg.node_queue_layout,
                victim_strategy=cfg.victim_strategy,
                n_workers=cfg.node_workers,
                seed=cfg.seed,
            )
        )
        results, _ = ex.run(tasks)
        # re-key by global row start
        return {lo + tasks[tid].start: val for tid, val in results.items()}


class Coordinator:
    """Entry point the runtime talks to (paper Fig. 5 left side)."""

    def __init__(self, config: CoordinatorConfig):
        self.config = config
        self.nodes = [NodeSched(i, config) for i in range(config.n_nodes)]

    # -- messaging (transport seam) ---------------------------------------------
    def _send(self, node: NodeSched, msg: tuple) -> Any:
        return node.recv(msg)

    # -- API ----------------------------------------------------------------------
    def broadcast(self, name: str, arr: np.ndarray) -> None:
        """Replicate ``arr`` to every alive node's store."""
        for nd in self.nodes:
            if nd.alive:
                self._send(nd, ("broadcast", name, arr))

    def distribute(self, name: str, arr: np.ndarray) -> None:
        """Row-partition ``arr`` across nodes (relaxes LB4MPI's replication)."""
        splits = np.array_split(np.arange(arr.shape[0]), len(self.nodes))
        for nd, idx in zip(self.nodes, splits):
            if nd.alive:
                self._send(nd, ("distribute", name, arr[idx]))

    def ship_program(self, fn: Callable) -> None:
        """Install the per-range operator on every alive node."""
        for nd in self.nodes:
            if nd.alive:
                self._send(nd, ("program", fn))

    def run(self, n_rows: int) -> dict[int, Any]:
        """Divide rows across nodes by the cross-node technique, run, collect.

        Failed nodes' row ranges are re-executed on survivors (fault path).
        """
        cfg = self.config
        alive = [nd for nd in self.nodes if nd.alive]
        if not alive:
            raise RuntimeError("no alive nodes")
        sched = chunk_schedule(cfg.technique, n_rows, len(alive), seed=cfg.seed)
        results: dict[int, Any] = {}
        pending: list[tuple[int, int]] = [(int(s), int(s + z)) for s, z in sched]
        # round-robin ranges over alive nodes; on failure, requeue the range
        i = 0
        while pending:
            lo, hi = pending.pop(0)
            alive = [nd for nd in self.nodes if nd.alive]
            if not alive:
                raise RuntimeError("all nodes failed")
            nd = alive[i % len(alive)]
            i += 1
            try:
                results.update(self._send(nd, ("run", lo, hi)))
            except ConnectionError:
                pending.append((lo, hi))  # reschedule on survivors
        return results

    # -- fault injection (tests) ---------------------------------------------------
    def kill_node(self, node_id: int) -> None:
        """Mark a node dead (fault-injection for tests)."""
        self.nodes[node_id].alive = False
