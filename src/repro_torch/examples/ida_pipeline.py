"""The paper's two IDA pipelines end to end, with the distributed
coordinator (paper Fig. 5) and the device-side DLS kernel path (the port of
``examples/ida_pipeline.py``).

    PYTHONPATH=src python -m repro_torch.examples.ida_pipeline               # the card
    PYTHONPATH=src python -m repro_torch.examples.ida_pipeline --torch-device cpu

The host parts run on the pool as the reference's. The device part is one
DLS-scheduled CC step over the first ``dense_n`` rows of the graph, dense,
under STATIC, MFSC and GSS (``kernels/ops.py:cc_step``): on the card K2
(``csrc/cc_propagate.cu``), on the CPU its plain version. A max of
maxima is exact in any order, so either is held bitwise to
``cc_propagate_ref``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ._common import add_device_flag, kernel_launches, resolve_device, sync

__all__ = ["main", "run"]


def run(scale: int = 11, workers: int = 4, linreg_rows: int = 20_000,
        linreg_cols: int = 101, rec_users: int = 4096, rec_items: int = 64,
        dense_n: int = 1024, torch_device="cuda") -> dict:
    """The pipelines on an RMAT graph of ``scale`` with ``workers`` host
    workers, linreg ``linreg_rows`` x ``linreg_cols``, recommendation
    ``rec_users`` x ``rec_items``, the coordinator over 3 nodes, and the
    device CC step at ``dense_n`` rows (tiles 128 x 256)."""
    from ..core import (Coordinator, CoordinatorConfig, DagTuner, SchedulerConfig,
                        select_offline_dag)
    from ..kernels import ops, ref
    from ..vee import connected_components_dag, recommendation_pipeline, rmat_graph
    from ..vee.apps import cc_iteration_dag, linear_regression_dag

    device = resolve_device(torch_device)
    out: dict = {}
    # --- shared-memory DaphneSched via the pipeline-DAG runtime ------------
    G = rmat_graph(scale=scale, edge_factor=8, seed=3, relabel="blocks")
    cfg = SchedulerConfig(technique="TFSS", queue_layout="PERGROUP",
                          victim_strategy="RNDPRI", n_workers=workers,
                          numa_domains=tuple(i * 2 // workers for i in range(workers)))
    labels, iters, hist = connected_components_dag(G, cfg)
    ol = sum(h.overlap_s("propagate", "changed") for h in hist)
    out.update(labels=labels, components=int(len(np.unique(labels))), cc_iterations=iters)
    print(f"[shared] CC-DAG: {out['components']} components in {iters} iters "
          f"(TFSS/PERGROUP/RNDPRI); propagate/changed streamed overlap "
          f"{ol * 1e3:.1f} ms total")

    # per-stage OFFLINE selection: simulate the DAG makespan for every
    # uniform combo, then coordinate-descend per stage (core/autotune.py)
    nnz = G.row_nnz().astype(float)
    stage_costs = {"propagate": nnz * 2e-7 + 5e-8, "changed": np.full(G.n_rows, 2e-8)}
    dag = cc_iteration_dag(G, np.arange(1, G.n_rows + 1, dtype=np.int64))
    assign, tuned_ms, uniform = select_offline_dag(dag, stage_costs, n_workers=8, passes=1)
    base = min(uniform.values())
    out.update(offline_assign={s: list(c) for s, c in assign.items()},
               offline_makespan=tuned_ms, best_uniform_makespan=base)
    print(f"[autotune] per-stage offline: {assign} -> {tuned_ms * 1e3:.2f} ms "
          f"vs best single global config {base * 1e3:.2f} ms "
          f"({(base - tuned_ms) / base * 100:+.1f}%)")

    # per-stage ONLINE selection across the CC while-loop iterations
    tuner = DagTuner(["propagate", "changed"], seed=0)
    _, it_t, _ = connected_components_dag(G, cfg, max_iter=12, tuner=tuner)
    print(f"[autotune] online per-stage after {it_t} iters: {tuner.best}")

    # --- recommendation flow: two independent branches overlap -------------
    top_items, rec = recommendation_pipeline(rec_users, rec_items, SchedulerConfig(
        technique="MFSC", queue_layout="CENTRALIZED", n_workers=workers))
    out.update(top_items=np.asarray(top_items), recommendation_values=rec.values)
    print(f"[recommend] {len(top_items)} users scored; independent branches "
          f"(item_norms/user_bias) overlapped "
          f"{rec.overlap_s('item_norms', 'user_bias') * 1e3:.1f} ms")

    # --- linear regression (paper Listing 2) through the DAG runtime -------
    beta, _ = linear_regression_dag(linreg_rows, linreg_cols, SchedulerConfig(
        technique="STATIC", queue_layout="CENTRALIZED", n_workers=workers))
    out["beta"] = beta
    print(f"[linreg] DAG moments->syrk/gemv->solve: beta norm {np.linalg.norm(beta):.4f}")

    # --- distributed DaphneSched: coordinator + node instances (Fig 5) -----
    co = Coordinator(CoordinatorConfig(n_nodes=3, node_workers=2,
                                       technique="FAC2", node_technique="GSS"))
    c0 = np.arange(1, G.n_rows + 1, dtype=np.int64)
    co.broadcast("labels", c0)
    co.ship_program(lambda store, start, size:
                    G.row_max_gather(store["labels"], start, start + size))
    t0 = time.perf_counter()
    partials = co.run(G.n_rows)
    out.update(coordinator_partials=len(partials),
               coordinator_seconds=time.perf_counter() - t0)
    print(f"[distributed] one CC step across 3 nodes: {len(partials)} partials "
          f"in {out['coordinator_seconds']:.2f}s; node failure tolerated "
          f"(tests/test_torch_vee.py)")

    # --- device path: the DLS-scheduled CC step (K2 on the card) -----------
    n = dense_n
    Gd = torch.from_numpy(G.to_dense()[:n, :n]).to(device)
    c = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    want = ref.cc_propagate_ref(Gd, c)
    out["device"] = {}
    with kernel_launches() as launches:
        for technique in ("STATIC", "MFSC", "GSS"):
            u = ops.cc_step(Gd, c, technique=technique, tile_r=128, tile_c=256)
            sync(device)
            ok = bool(torch.equal(u, want))
            out["device"][technique] = "bitwise" if ok else "MISMATCH"
            print(f"[device] cc_propagate ({device.type}), {technique:6s} schedule: "
                  f"{'exact' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"cc_step under {technique} differs from "
                                     "cc_propagate_ref")
    out["launches"] = launches
    print("[device] execution order is a scheduler artifact; results identical "
          "(the tests sweep all 11 techniques)")
    return out


def main(argv: list[str] | None = None) -> dict:
    """Parse the flags (``--torch-device`` only) and run the example."""
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    args = ap.parse_args(argv)
    return run(torch_device=args.torch_device)


if __name__ == "__main__":
    main()
