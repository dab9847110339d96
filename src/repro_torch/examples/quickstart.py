"""Quickstart: DaphneSched in 60 seconds (the port of ``examples/quickstart.py``).

Runs the paper's two IDA pipelines on the host pool under different
scheduling configurations and prints the simulated 20-core comparison
(paper Fig 7a analogue). Host only, as the reference: nothing runs on the
card (``--torch-device`` is checked all the same).

    PYTHONPATH=src python -m repro_torch.examples.quickstart --torch-device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ._common import add_device_flag, resolve_device

__all__ = ["main", "run"]


def run(scale: int = 12, linreg_rows: int = 50_000, linreg_cols: int = 17,
        workers: int = 4, sim_workers: int = 20, torch_device="cuda") -> dict:
    """Listing 1 (CC on an RMAT graph of ``scale``), Listing 2 (linreg of
    ``linreg_rows`` x ``linreg_cols``) on ``workers`` host workers, then the
    simulated makespans and the auto-selected config on ``sim_workers``."""
    from ..core import SchedulerConfig, select_offline, simulate
    from ..vee import connected_components, linear_regression, rmat_graph

    resolve_device(torch_device)
    out: dict = {}
    # --- 1. the paper's Listing 1: connected components on a sparse graph ---
    G = rmat_graph(scale=scale, edge_factor=8, seed=0, relabel="blocks")
    print(f"graph: {G.n_rows} nodes, {G.nnz} edges "
          f"({G.nnz / G.n_rows**2 * 100:.3f}% dense)")
    cfg = SchedulerConfig(technique="MFSC", queue_layout="PERCORE",
                          victim_strategy="SEQPRI", n_workers=workers,
                          numa_domains=tuple(i * 2 // workers for i in range(workers)))
    labels, iters, _ = connected_components(G, cfg)
    out.update(labels=labels, components=int(len(np.unique(labels))), cc_iterations=iters)
    print(f"connected components: {out['components']} components "
          f"in {iters} iterations (MFSC + per-core queues + SEQPRI stealing)")

    # --- 2. the paper's Listing 2: linear regression (dense) ----------------
    beta, _ = linear_regression(linreg_rows, linreg_cols,
                                SchedulerConfig(technique="STATIC", n_workers=workers))
    out["beta"] = beta
    print(f"linear regression: beta[:3] = {beta[:3, 0].round(4)} "
          f"(STATIC — the right choice for dense work, paper Fig 10)")

    # --- 3. simulated 20-core comparison (paper Fig 7a analogue) ------------
    costs = G.row_nnz().astype(float) + 5.0
    costs *= 1e-7
    print(f"\nsimulated {sim_workers}-core makespans (centralized queue):")
    out["simulated_makespans"] = {}
    for tech in ("STATIC", "MFSC", "GSS", "TSS", "FAC2"):
        ms = simulate(costs, technique=tech, n_workers=sim_workers).makespan
        out["simulated_makespans"][tech] = ms
        print(f"  {tech:7s} {ms * 1e3:8.2f} ms")

    # --- 4. the paper's future work: automatic selection --------------------
    half = sim_workers // 2
    best, scores = select_offline(costs, n_workers=sim_workers,
                                  numa_domains=[0] * half + [1] * (sim_workers - half))
    out.update(auto_selected=list(best), auto_selected_makespan=scores[best],
               static_centralized_makespan=scores[("STATIC", "CENTRALIZED", "SEQ")])
    print(f"\nauto-selected config: {best} "
          f"({scores[best] * 1e3:.2f} ms vs STATIC/CENTRALIZED "
          f"{scores[('STATIC', 'CENTRALIZED', 'SEQ')] * 1e3:.2f} ms)")
    return out


def main(argv: list[str] | None = None) -> dict:
    """Parse the flags (``--torch-device`` only) and run the quickstart."""
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    args = ap.parse_args(argv)
    return run(torch_device=args.torch_device)


if __name__ == "__main__":
    main()
