"""Multi-tenant pipeline serving end to end (the port of
``examples/serve_pipelines.py``): virtual-time policy search across
inter-job arbiters, contention-aware per-job stage tuning, then a real
threaded ``PipelineServer`` drain of the winning policy. Host only, as the
reference: nothing runs on the card (``--torch-device`` is checked all the
same).

    PYTHONPATH=src python -m repro_torch.examples.serve_pipelines --torch-device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from ._common import add_device_flag, resolve_device

__all__ = ["main", "make_jobs", "run"]


def make_jobs(scale: int = 11, linreg_rows: int = 20_000, linreg_cols: int = 21,
              rec_users: int = 4096, rec_items: int = 64) -> list:
    """Three tenants, four heterogeneous pipelines (fresh Job records: ops
    capture arrays, metadata is immutable). graph: one heavy, skewed CC
    iteration (batch analytics); ml: a dense linreg training job (uniform
    row costs); interactive: two small recommendation queries with
    deadlines, weight 4."""
    from ..core import Job
    from ..vee import linreg_dag, recommendation_dag, rmat_graph
    from ..vee.apps import cc_iteration_dag

    G = rmat_graph(scale=scale, edge_factor=8, seed=5, relabel="blocks")
    labels = np.arange(1, G.n_rows + 1, dtype=np.int64)
    nnz = G.row_nnz().astype(float)
    lr_dag, _ = linreg_dag(linreg_rows, linreg_cols)
    rec_costs = {"item_norms": np.full(rec_users, 4e-7),
                 "user_bias": np.full(rec_users, 2e-7),
                 "scores": np.full(rec_users, 6e-7)}
    return [
        Job("cc_batch", cc_iteration_dag(G, labels), tenant="graph",
            weight=1.0, priority=0,
            stage_costs={"propagate": nnz * 4e-6 + 1e-6,
                         "changed": np.full(G.n_rows, 4e-7)}),
        Job("linreg_train", lr_dag, tenant="ml", weight=2.0, priority=1,
            arrival_s=0.005,
            stage_costs={"moments": np.full(linreg_rows, 5e-7),
                         "syrk_gemv": np.full(linreg_rows, 2e-6)}),
        Job("recommend_1", recommendation_dag(rec_users, rec_items, seed=1),
            tenant="interactive", weight=4.0, priority=2, arrival_s=0.01,
            deadline_s=2.0, stage_costs=rec_costs),
        Job("recommend_2", recommendation_dag(rec_users, rec_items, seed=2),
            tenant="interactive", weight=4.0, priority=2, arrival_s=0.02,
            deadline_s=2.0, stage_costs=rec_costs),
    ]


def run(scale: int = 11, linreg_rows: int = 20_000, linreg_cols: int = 21,
        rec_users: int = 4096, rec_items: int = 64, workers: int = 8,
        drain_workers: int = 4, torch_device="cuda") -> dict:
    """The search and tuning in virtual time on ``workers``, then the drain
    on ``drain_workers`` real host workers (``make_jobs``' sizes)."""
    from ..core import (PipelineServer, SchedulerConfig, Submission,
                        select_offline_server, simulate_server)

    resolve_device(torch_device)

    def jobs():
        return make_jobs(scale, linreg_rows, linreg_cols, rec_users, rec_items)

    out: dict = {"search": {}}
    # --- 1. virtual-time policy search: which arbiter fits this mix? -------
    print("[search] virtual-time replay of the mixed arrival trace:")
    for arb in ("fifo", "priority", "fair"):
        r = simulate_server(jobs(), n_workers=workers, arbiter=arb)
        out["search"][arb] = dict(p50=r.latency_percentile(50),
                                  p99=r.latency_percentile(99), makespan=r.makespan)
        print(f"  {arb:>8}: p50={r.latency_percentile(50) * 1e3:6.2f}ms "
              f"p99={r.latency_percentile(99) * 1e3:6.2f}ms "
              f"makespan={r.makespan * 1e3:6.2f}ms")

    # --- 2. contention-aware per-job stage configs -------------------------
    assign, tuned, baseline = select_offline_server(
        jobs(), n_workers=workers, arbiter="fair", objective="p99", passes=1)
    out.update(assign={j: {s: list(c) for s, c in st.items()} for j, st in assign.items()},
               tuned_p99=tuned, isolated_p99=baseline)
    print(f"[autotune] per-job configs under contention: p99 "
          f"{baseline * 1e3:.2f}ms (isolated-tuned) -> {tuned * 1e3:.2f}ms "
          f"({(baseline - tuned) / baseline * 100:+.1f}%)")
    for jname, stages in assign.items():
        tag = " ".join(f"{s}={'/'.join(c)}" for s, c in stages.items())
        print(f"  {jname}: {tag}")

    # --- 3. real threaded drain under the tuned fair-share policy ----------
    server = PipelineServer(SchedulerConfig(n_workers=drain_workers, queue_layout="PERCORE"),
                            arbiter="fair")
    for j in jobs():
        server.submit(Submission(
            dag=j.dag, name=j.name, priority=j.priority, tenant=j.tenant,
            weight=j.weight, arrival_s=j.arrival_s, deadline_s=j.deadline_s,
            per_stage=assign[j.name], stage_costs=j.stage_costs))
    res = server.serve()
    out.update(drained_jobs=len(res.jobs), drain_seconds=res.wall_time_s,
               drain_p99=res.latency_percentile(99),
               job_values={n: r.values for n, r in res.jobs.items()})
    print(f"[serve] real pool drained {len(res.jobs)} jobs in "
          f"{res.wall_time_s * 1e3:.1f}ms "
          f"(p99 latency {res.latency_percentile(99) * 1e3:.1f}ms, "
          f"{res.steals} steals)")
    for name, r in sorted(res.jobs.items()):
        dl = "" if r.deadline_met is None else f" deadline_met={r.deadline_met}"
        print(f"  {name:>14}: latency={r.latency_s * 1e3:7.1f}ms "
              f"tasks={r.n_tasks}{dl}")
    per_tenant = ", ".join(f"{t}={s * 1e3:.1f}ms"
                           for t, s in sorted(res.tenant_service_s.items()))
    print(f"[serve] service by tenant: {per_tenant}")
    return out


def main(argv: list[str] | None = None) -> dict:
    """Parse the flags (``--torch-device`` only) and run the example."""
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    args = ap.parse_args(argv)
    return run(torch_device=args.torch_device)


if __name__ == "__main__":
    main()
