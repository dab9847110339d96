"""Heterogeneous placement and co-execution end to end (the port of
``examples/hetero_pipeline.py``): calibrate per-substrate stage costs, solve
a transfer-aware placement, replay it in virtual time against the
homogeneous baselines, then run the real ``HeteroExecutor`` (host chunk
workers and a device walker lane) and hold it to the host-only path.

    PYTHONPATH=src python -m repro_torch.examples.hetero_pipeline            # the card
    PYTHONPATH=src python -m repro_torch.examples.hetero_pipeline --torch-device cpu

The walker lane walks its runs of the linreg lowering's slots on the
device the lowering's data lie on: on the card K1's linreg program, a
``sum`` run at the fold's frontier seeded with the host's prefix (K3). On
the CPU the lane runs the host ops' arithmetic and the values are bitwise
the host-only run's, as the reference claims; on the card each sum is held
within twice eps32 * sqrt(tiles) * sum|terms| an entry
(``examples/_common.py:hold_linreg``) and the worst share is printed.
"""

from __future__ import annotations

import argparse

import numpy as np

from ._common import (add_device_flag, checks_line, hold_linreg, kernel_launches,
                      resolve_device, sync)

__all__ = ["main", "run"]


def run(affinity_rows: int = 4096, workers: int = 8, rounds: int = 160,
        rows: int = 512, cols: int = 9, torch_device="cuda") -> dict:
    """Steps 1 and 2 on ``hetero_affinity_dag(affinity_rows)`` over
    ``workers`` (virtual time, ``rounds`` bandit rounds), steps 3 and 4 on
    the linreg lowering of ``rows`` x ``cols`` (tile 64) on the device."""
    from ..core import (HeteroExecutor, PipelineExecutor, SchedulerConfig, Submission,
                        make_placement, select_placement, simulate_hetero_dag,
                        tune_online_hetero)
    from ..vee import hetero_affinity_dag, linear_regression_hetero
    from ..vee.apps import linear_regression_oracle, linreg_device_lowering

    dev = resolve_device(torch_device)
    exact = dev.type == "cpu"
    out: dict = {"launches": {}}
    # --- 1. a transfer-heavy synthetic DAG with opposite substrate affinities
    # ingest feeds two independent branches: `featurize` is host-friendly,
    # `embed` wants the accelerator; `join` consumes both elementwise. The
    # transfer term makes naive per-stage greedy ping-pong expensive: the
    # solver keeps branches substrate-resident and overlaps them.
    dag, costs = hetero_affinity_dag(affinity_rows)
    placement, hetero_ms, base = select_placement(dag, costs, n_workers=workers)
    host_ms, dev_ms = base["host"], base["device"]
    res = simulate_hetero_dag(dag, costs, placement, n_workers=workers)
    out.update(all_host_makespan=host_ms, all_device_makespan=dev_ms,
               placed_makespan=hetero_ms, placement=placement.describe(),
               transfers=int(sum(res.stats.transfers.values())), link_seconds=res.transfer_s)
    print("— transfer-aware placement solver —")
    print(f"all-HOST   makespan: {host_ms * 1e6:10.1f} us")
    print(f"all-DEVICE makespan: {dev_ms * 1e6:10.1f} us")
    print(f"solved placement:    {hetero_ms * 1e6:10.1f} us  "
          f"({(min(host_ms, dev_ms) - hetero_ms) / min(host_ms, dev_ms) * 100:.1f}% "
          f"under the best homogeneous run)")
    print(f"  {placement.describe()}")
    print(f"  transfers={out['transfers']} ({res.transfer_s * 1e6:.1f} us on the link), "
          f"branch overlap featurize/embed = "
          f"{res.overlap_s('featurize', 'embed') * 1e6:.1f} us")

    # --- 2. the online counterpart: bandit arms carry the substrate choice -
    # one focus stage explores per round (DagTuner discipline), so 160
    # rounds let each stage's bandit play its full 40-arm hetero set once
    tuned = tune_online_hetero(dag, costs, n_workers=workers, rounds=rounds, seed=0)
    out.update(online_assign={k: list(v) for k, v in tuned.assign.items()},
               online_makespan=tuned.makespan)
    print(f"\n— online substrate bandit ({rounds} virtual rounds) —")
    for name, arm in tuned.assign.items():
        print(f"  {name}: {'/'.join(arm[:3])} on {arm[3]}")
    print(f"  converged makespan: {tuned.makespan * 1e6:.1f} us")

    # --- 3. real co-execution: linreg split across both substrates ---------
    cfg = SchedulerConfig(n_workers=2)
    with kernel_launches() as out["launches"]["co_execution"]:
        beta, hres, used = linear_regression_hetero(rows, cols, cfg, device_speedup=4.0,
                                                    device=dev)
        sync(dev)
    low = linreg_device_lowering(rows, cols, tile=64, device=dev)
    host_only = PipelineExecutor(low.dag, SchedulerConfig(technique="SS", n_workers=1)).run()
    out["co_execution"] = hold_linreg(low, hres.values, host_only.values, exact,
                                      "co-execution")
    out["beta"] = beta
    out["beta_matches_oracle"] = bool(np.allclose(beta, linear_regression_oracle(rows, cols),
                                                  atol=1e-4))
    print("\n— real HeteroExecutor (linreg, host pool + device walker lane) —")
    print(f"  placement: {used.describe()}")
    print(f"  against host-only: {checks_line(out['co_execution'])}")
    print(f"  beta matches oracle: {out['beta_matches_oracle']}")
    print(f"  absorbed by host/device: {hres.absorbed_by_host}/"
          f"{hres.absorbed_by_device}, cross-substrate consumptions: "
          f"{sum(hres.cross_consumptions.values())}")
    if not out["beta_matches_oracle"]:
        raise AssertionError("co-executed beta is off the float64 oracle")

    # --- 4. the unified surface: placement rides on the Submission ---------
    # Given the lowering, the lane walks its runs (K1 on the card; a run
    # that continues a sum's fold starts from the folded prefix, K3). With
    # rebalancing off the lane takes every device-placed chunk: at these
    # sizes an idle host worker absorbs a device tail in microseconds, and
    # on the card the host took them all in step 3 before the lane's first
    # launch.
    pool = HeteroExecutor(low.dag, SchedulerConfig(technique="SS", n_workers=1),
                          make_placement("host", low.dag.stage_names), lowering=low,
                          rebalance=False)
    sub = Submission(placement=make_placement("moments=device,syrk_gemv=split:0.5"))
    with kernel_launches() as out["launches"]["submission_placement"]:
        hres2 = pool.run(sub)
        sync(dev)
    out["submission_placement"] = hold_linreg(low, hres2.values, host_only.values, exact,
                                              "submission-scoped placement")
    print("\n— Submission-scoped placement on the same pool —")
    print("  spec: moments=device,syrk_gemv=split:0.5 (against host-only: "
          f"{checks_line(out['submission_placement'])})")
    return out


def main(argv: list[str] | None = None) -> dict:
    """Parse the flags (``--torch-device`` only) and run the example."""
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    args = ap.parse_args(argv)
    return run(torch_device=args.torch_device)


if __name__ == "__main__":
    main()
