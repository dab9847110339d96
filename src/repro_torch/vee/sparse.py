"""Minimal CSR sparse matrix + RMAT generator (numpy only).

The paper's connected-components input is the SNAP Amazon co-purchasing
graph scaled x50 (20.2M nodes, 244M edges, 0.002% nnz). Offline we generate
an RMAT graph with the same structural character (power-law degrees, dense
communities, symmetric edges) at configurable scale. The device CC step
takes the dense adjacency (``CSRMatrix.to_dense``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["CSRMatrix", "rmat_graph", "replicated_graph"]


@dataclass
class CSRMatrix:
    """Pattern-only CSR (values are implicitly 1 — adjacency)."""

    indptr: np.ndarray   # (n_rows + 1,) int64
    indices: np.ndarray  # (nnz,) int32
    n_cols: int

    @property
    def n_rows(self) -> int:
        """Number of rows."""
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        """Number of stored (nonzero) entries."""
        return int(self.indptr[-1])

    def row_nnz(self) -> np.ndarray:
        """Stored entries per row."""
        return np.diff(self.indptr)

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, n: int) -> "CSRMatrix":
        """An ``n x n`` pattern from edge lists (duplicates kept)."""
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        counts = np.bincount(src, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr, dst.astype(np.int32), n)

    def row_max_gather(self, c: np.ndarray, lo: int = 0,
                       hi: int | None = None) -> np.ndarray:
        """u[i] = max(max_{j in N(i)} c[j], c[i]) for rows in [lo, hi).

        The paper's Listing-1 kernel ``max(rowMaxs(G * t(c)), c)``
        restricted to a row block: the host CC body, one chunk of the
        ``propagate`` stage (``vee/apps.py:cc_iteration_dag``).
        """
        hi = self.n_rows if hi is None else hi
        ip = self.indptr[lo:hi + 1]
        vals = c[self.indices[ip[0]:ip[-1]]]
        out = c[lo:hi].copy()
        if len(vals) == 0:
            return out
        # reduce over the non-empty rows' starts only: each segment then
        # ends where the row does. (Clipping every start into range instead
        # would cut the last non-empty row of a block that ends in empty
        # rows short of its last neighbour.)
        nonempty = np.diff(ip) > 0
        seg_max = np.maximum.reduceat(vals, (ip[:-1] - ip[0])[nonempty])
        out[nonempty] = np.maximum(out[nonempty], seg_max)
        return out

    def to_dense(self) -> np.ndarray:
        """Dense ``(n_rows, n_cols)`` float32 {0, 1} adjacency."""
        d = np.zeros((self.n_rows, self.n_cols), dtype=np.float32)
        rows = np.repeat(np.arange(self.n_rows), self.row_nnz())
        d[rows, self.indices] = 1.0
        return d


def rmat_graph(
    scale: int = 14,
    edge_factor: int = 8,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    symmetric: bool = True,
    relabel: bool | str = False,
) -> CSRMatrix:
    """RMAT power-law graph: n = 2**scale nodes, ~edge_factor * n edges.

    Defaults are the Graph500 RMAT parameters, giving the hub-heavy,
    community-clustered degree distribution of co-purchase graphs.
    ``relabel`` applies a random node permutation: raw RMAT concentrates
    hubs at low ids, which over-states contiguous-block imbalance relative
    to real co-purchase graphs (SNAP Amazon has no id-degree correlation).
    """
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.uniform(size=m)
        src_bit = (r >= a + b).astype(np.int64)
        r2 = rng.uniform(size=m)
        thr_dst = np.where(src_bit == 0, a / (a + b), c / (1.0 - a - b))
        dst_bit = (r2 >= thr_dst).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    if relabel:
        if relabel == "blocks":
            # cluster-preserving: permute 1024-node blocks. Raw RMAT has a
            # global id-degree gradient (overstates block imbalance); a full
            # shuffle erases ALL locality (understates it). Real co-purchase
            # graphs sit in between: hub communities exist but are spread
            # over the id space.
            blk = 1024
            nb = n // blk
            bperm = rng.permutation(nb)
            perm = (bperm[np.arange(n) // blk] * blk + np.arange(n) % blk)
        else:
            perm = rng.permutation(n)
        src, dst = perm[src], perm[dst]
    if symmetric:  # paper: "two-directional edges"
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    keep = src != dst  # drop self-loops
    return CSRMatrix.from_edges(src[keep], dst[keep], n)


def replicated_graph(base_scale: int = 10, copies: int = 50, edge_factor: int = 8,
                     seed: int = 0, relabel: bool | str = "blocks") -> CSRMatrix:
    """The paper's dataset construction: a base co-purchase-like graph scaled
    up by replication ("a scale-up factor of 50 was applied", in the
    paper's evaluation).

    Returns a block-diagonal CSR of ``copies`` disjoint RMAT copies:
    coarse-grain loads are homogeneous across copies (the property that makes
    STATIC competitive under PERGROUP pre-partitioning) while within-copy
    hub skew preserves the fine-grain imbalance DLS techniques exploit.
    """
    base = rmat_graph(scale=base_scale, edge_factor=edge_factor, seed=seed,
                      relabel=relabel)
    nb = base.n_rows
    n = nb * copies
    src_parts, dst_parts = [], []
    rows = np.repeat(np.arange(nb), np.diff(base.indptr))
    for c in range(copies):
        src_parts.append(rows + c * nb)
        dst_parts.append(base.indices.astype(np.int64) + c * nb)
    return CSRMatrix.from_edges(np.concatenate(src_parts),
                                np.concatenate(dst_parts), n)
