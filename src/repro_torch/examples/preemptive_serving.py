"""Preemptive multi-tenancy end to end (the port of
``examples/preemptive_serving.py``): checkpoint a running job at a chunk
boundary, migrate the remainder host <-> device mid-flight, then put the
``preemptive`` arbiter under a deeply overloaded heavy-tailed trace and
compare deadline hit rates against plain non-preemptive weighted-fair.

    PYTHONPATH=src python -m repro_torch.examples.preemptive_serving \
        --trace-out preempt_trace.json
    PYTHONPATH=src python -m repro_torch.examples.preemptive_serving --torch-device cpu

On the card the device side is K1's linreg program: the never-preempted
walk (``run_device_dag``), the device prefix (``run_device_prefix``) and
the migrated remainder, which resumes a ``sum`` stage from the host's
partial sum (K3, ``migrate_to_device``). The walker folds its partial sums
in its own order, so there the migrated runs are held to the unmigrated
ones within twice eps32 * sqrt(tiles) * sum|terms| a sum entry
(``examples/_common.py:hold_linreg``) and the worst share of that limit is
printed; on the CPU, where the walker runs the host ops' arithmetic, they
are bitwise, as the reference claims.
"""

from __future__ import annotations

import argparse

from ._common import (add_device_flag, checks_line, hold_linreg, kernel_launches,
                      resolve_device, sync)

__all__ = ["main", "run"]


def run(rows: int = 256, cols: int = 9, tile: int = 64, preempt_after: int = 2,
        prefix_slots: int = 3, jobs: int = 600, load: float = 5.0, workers: int = 8,
        trace_out: str | None = None, torch_device="cuda") -> dict:
    """Steps 1 and 2 on the tile-unit linreg lowering of ``rows`` x ``cols``
    (its data on the device), step 3 on a heavy-tailed trace of ``jobs``
    jobs at ``load`` on ``workers`` (virtual time)."""
    from ..core import (PipelineExecutor, PreemptiveRunner, SchedulerConfig, Tracer,
                        heavy_tailed_trace, migrate_to_device, replay_open_loop,
                        resume_on_host, run_device_prefix)
    from ..kernels.limits import hold
    from ..vee.apps import linreg_device_lowering, run_device_dag

    dev = resolve_device(torch_device)
    exact = dev.type == "cpu"
    tracer = Tracer(job="linreg") if trace_out else None
    out: dict = {"launches": {}}

    # --- 1. checkpoint + resume on the host pool ---------------------------
    # the tile-unit linreg DAG under the bit-equality regime (SS, 1 worker);
    # preempt after 2 chunks, inspect the frozen remainder, resume exact
    low = linreg_device_lowering(rows, cols, tile=tile, device=dev)
    cfg = SchedulerConfig(technique="SS", queue_layout="CENTRALIZED", n_workers=1)
    ref = PipelineExecutor(low.dag, cfg).run()
    _, ck = PreemptiveRunner(low.dag, cfg, preempt_after=preempt_after, job="linreg",
                             tracer=tracer).run()
    out["checkpoint"] = {name: dict(executed=sck.executed, pending=len(sck.pending),
                                    remaining_tiles=sck.remaining_rows)
                         for name, sck in ck.stages.items()}
    print("— chunk-boundary checkpoint —")
    for name, sck in ck.stages.items():
        print(f"  {name:>10}: executed={sck.executed} "
              f"pending={len(sck.pending)} chunks ({sck.remaining_rows} tiles)")
    resumed = resume_on_host(ck, low.dag, cfg, tracer=tracer)
    out["host_resume"] = {k: hold(resumed.values[k], ref.values[k], None, 0,
                                  f"host resume {k}", exact=True) for k in ref.values}
    print("  host resume bit-equal:", True)

    # --- 2. mid-flight migration, both directions --------------------------
    # host -> device: the checkpointed remainder is re-lowered onto the
    # fused walker (completed stages become operands, partial sums are
    # seeded: K3); device -> host: freeze a super-table prefix, finish on
    # the thread pool
    with kernel_launches() as out["launches"]["unmigrated_walk"]:
        dev_ref, _ = run_device_dag(low, "SS")
        sync(dev)
    with kernel_launches() as out["launches"]["host_to_device"]:
        vals = migrate_to_device(ck, low)
        sync(dev)
    print("\n— mid-flight migration —")
    out["host_to_device"] = hold_linreg(low, vals, dev_ref, exact, "host->device")
    print("  host->device", checks_line(out["host_to_device"]))
    with kernel_launches() as out["launches"]["device_prefix"]:
        ck_dev, _ = run_device_prefix(low, prefix_slots)
        sync(dev)
    fin = resume_on_host(ck_dev, low.dag, cfg, tracer=tracer)
    out["device_to_host"] = hold_linreg(low, fin.values, ref.values, exact, "device->host")
    print("  device->host", checks_line(out["device_to_host"]))

    # --- 3. the preemptive arbiter under deadline pressure -----------------
    # load 5.0 on 8 workers: weighted-fair spreads capacity so thin that
    # interactive deadlines blow; the preemptive wrapper parks deadline-free
    # batch jobs (and already-expired stragglers) at their next chunk
    # boundary while any live deadline is pressured
    trace = heavy_tailed_trace(jobs, seed=3, load=load, n_workers=workers)
    fair = replay_open_loop(trace, n_workers=workers, arbiter="fair")
    pre = replay_open_loop(trace, n_workers=workers, arbiter="preemptive",
                           arbiter_kwargs={"inner": "fair", "n_workers": workers,
                                           "slack_s": 0.5})
    first = next(e for e in pre.preemptions if e.kind == "preempt")
    out.update(fair_hit_rate=fair.deadline_hit_rate(), preemptive_hit_rate=pre.deadline_hit_rate(),
               preemption_events=len(pre.preemptions),
               first_preemption=dict(t=first.t, job=first.job, reason=first.reason))
    print(f"\n— deadline hit-rate under overload ({jobs} jobs, load {load}) —")
    print(f"  weighted-fair:        hit={fair.deadline_hit_rate():.3f}")
    print(f"  preemptive(fair):     hit={pre.deadline_hit_rate():.3f}  "
          f"park/resume events={len(pre.preemptions)}")
    print(f"  first preemption: t={first.t:.3f}s job={first.job} ({first.reason})")

    if tracer is not None:
        kinds = sorted({s.kind for s in tracer.spans()})
        tracer.write_chrome_trace(trace_out)
        print(f"\ntrace: {len(tracer)} events, kinds={kinds} -> {trace_out}")
    return out


def main(argv: list[str] | None = None) -> dict:
    """Parse the reference's flag and ``--torch-device``; run the example."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace covering the checkpoint "
                         "and resume marks")
    add_device_flag(ap)
    a = ap.parse_args(argv)
    return run(trace_out=a.trace_out, torch_device=a.torch_device)


if __name__ == "__main__":
    main()
