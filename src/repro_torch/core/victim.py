"""Victim-selection strategies for work-stealing (paper §2).

SEQ     round-robin from the thief's position in the topology.
SEQPRI  like SEQ but exhausts the thief's own NUMA domain first.
RND     uniform random victim.
RNDPRI  uniform random within the thief's NUMA domain first, then outside.

The "topology" is a list of NUMA-domain ids per worker (e.g. [0,0,1,1] = two
sockets with two cores each).
"""

from __future__ import annotations

import numpy as np

__all__ = ["VictimSelector", "make_victim_selector", "VICTIM_STRATEGIES"]


class VictimSelector:
    """Victim-ordering base: yields queue ids for a thief to probe (paper C.2)."""

    def __init__(self, n_workers: int, numa_domains: list[int] | None = None, seed: int = 0):
        self.n_workers = n_workers
        self.domains = list(numa_domains) if numa_domains is not None else [0] * n_workers
        if len(self.domains) != n_workers:
            raise ValueError("numa_domains must have one entry per worker")
        self._rng = np.random.default_rng(seed)

    def candidates(self, thief: int) -> list[int]:
        """Victim ids in the order the thief should try them."""
        raise NotImplementedError

    def _others(self, thief: int) -> list[int]:
        return [w for w in range(self.n_workers) if w != thief]


class SeqVictim(VictimSelector):
    """SEQ: round-robin starting after the thief's position."""

    def candidates(self, thief: int) -> list[int]:
        """Every other queue in round-robin order after the thief."""
        return [(thief + i) % self.n_workers for i in range(1, self.n_workers)]


class SeqPriVictim(VictimSelector):
    """SEQPRI: SEQ order, same-NUMA-domain victims first."""

    def candidates(self, thief: int) -> list[int]:
        """SEQ order, stably partitioned into same-domain then remote."""
        seq = [(thief + i) % self.n_workers for i in range(1, self.n_workers)]
        dom = self.domains[thief]
        return [w for w in seq if self.domains[w] == dom] + [
            w for w in seq if self.domains[w] != dom
        ]


class RndVictim(VictimSelector):
    """RND: uniform random permutation of all other workers."""

    def candidates(self, thief: int) -> list[int]:
        """A fresh random permutation of every other queue."""
        others = self._others(thief)
        self._rng.shuffle(others)
        return others


class RndPriVictim(VictimSelector):
    """RNDPRI: random within the thief's NUMA domain first, then outside."""

    def candidates(self, thief: int) -> list[int]:
        """Shuffled same-domain queues, then shuffled remote ones."""
        dom = self.domains[thief]
        local = [w for w in self._others(thief) if self.domains[w] == dom]
        remote = [w for w in self._others(thief) if self.domains[w] != dom]
        self._rng.shuffle(local)
        self._rng.shuffle(remote)
        return local + remote


VICTIM_STRATEGIES = {
    "SEQ": SeqVictim,
    "SEQPRI": SeqPriVictim,
    "RND": RndVictim,
    "RNDPRI": RndPriVictim,
}


def make_victim_selector(
    name: str, n_workers: int, numa_domains: list[int] | None = None, seed: int = 0
) -> VictimSelector:
    """Build a VictimSelector by name from VICTIM_STRATEGIES (DESIGN.md §2)."""
    try:
        cls = VICTIM_STRATEGIES[name.upper()]
    except KeyError:
        raise ValueError(
            f"unknown victim strategy {name!r}; available: {sorted(VICTIM_STRATEGIES)}"
        ) from None
    return cls(n_workers, numa_domains, seed)
