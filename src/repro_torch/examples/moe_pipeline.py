"""MoE expert dispatch as an irregular DaphneSched pipeline (the port of
``examples/moe_pipeline.py``).

Lowers a skewed-router MoE layer (Qwen1.5-MoE-A2.7B's reduced widths) into
a route -> experts -> combine PipelineDAG whose fan-out stage's rows are
EXPERTS, each row's cost the router's token count for that expert: the
canonical irregular workload from the paper. The example then

  1. runs the DAG under several DLS techniques on the host pool and checks
     every one bitwise equal to the direct (unscheduled) oracle;
  2. replays the skewed costs in the deterministic simulator with the
     online bandit, showing ``rechunk_pending`` moldable resizes and the
     adaptive-vs-best-static-uniform makespan gap;
  3. with ``--device``, re-runs the expert stage through the device walker
     and holds the token-side combine to the direct oracle: bitwise on the
     CPU (the walker's plain version runs the host op's arithmetic), and
     on the card (K1's MoE-expert program, 3xTF32 on ``wgmma``) within
     the float64-derived limit of ``kernels/limits.py:moe_limits`` carried
     through the combine (``moe_combined_limit``); it prints the worst
     share of that limit.

    PYTHONPATH=src python -m repro_torch.examples.moe_pipeline --tokens 384 --device
    PYTHONPATH=src python -m repro_torch.examples.moe_pipeline --device --torch-device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ._common import add_device_flag, kernel_launches, resolve_device, sync

__all__ = ["device_combine_check", "main", "run"]


def device_combine_check(low, dlow, slabs, y, direct) -> dict:
    """The walked combine ``y`` against the host's ``direct`` on the card:
    each slab entry's float64 limit (``moe_limits``, both of them) and the
    combine's (``moe_combined_limit``). Raises past a limit; returns the
    worst shares."""
    from ..kernels.limits import beyond, moe_combined_limit, moe_limits
    from ..vee.ml_apps import _dispatch_plan

    e, cap = low.meta["n_experts"], low.meta["capacity"]
    wi, wo, xdisp = dlow.values["wi"], dlow.values["wo"], dlow.values["xdisp"]
    lim = torch.empty(slabs.shape, dtype=torch.float64, device=slabs.device)
    shares = {"slabs_vs_float64": 0.0, "slabs_vs_float64_rss": 0.0}
    for g in range(e):
        sl = slice(g * cap, (g + 1) * cap)
        ref, lim[sl], lim_rss = moe_limits(xdisp[sl].double(), wi[g].double(),
                                           wo[g].double())
        for key, limit in (("slabs_vs_float64", lim[sl]),
                           ("slabs_vs_float64_rss", lim_rss)):
            bad, err, share = beyond(slabs[sl], ref, limit)
            if bad:
                raise AssertionError(f"expert {g}: {bad} slab entries beyond the "
                                     f"float64 limit ({key}); max abs err {err:.3g}")
            shares[key] = max(shares[key], share)
    idx, w, pos, _ = _dispatch_plan(low.meta["route_build"], e, cap)
    want = torch.from_numpy(np.asarray(direct)).to(y.device)
    bad, err, share = beyond(y, want, moe_combined_limit(lim, slabs, idx, w, pos, cap))
    if bad:
        raise AssertionError(f"device combine vs direct: {bad} entries beyond the "
                             f"limit; max abs err {err:.3g}")
    shares["combine_vs_direct"] = share
    return shares


def run(tokens: int = 384, experts: int = 32, skew: float = 1.6,
        capacity_factor: float = 6.0, workers: int = 4, device: bool = False,
        trace_out: str | None = None, torch_device="cuda", params=None) -> dict:
    """The three steps above; ``device`` adds step 3. ``params``: the MoE
    weights (``router``, ``experts``; the reference's through
    ``moe_params_from_reference``), drawn from seed 0 on the device by
    default."""
    from ..core import OnlineScheduler, Tracer, select_offline_dag, simulate_dag
    from ..core.autotune import tune_online_dag
    from ..vee.apps import run_device_dag
    from ..vee.ml_apps import moe_device_lowering, moe_dispatch_lowering

    dev = resolve_device(torch_device)
    low = moe_dispatch_lowering(n_tokens=tokens, skew=skew, seed=0, n_experts=experts,
                                capacity_factor=capacity_factor, params=params,
                                device=dev)
    kept = low.meta["expert_tokens"]
    out: dict = {"expert_tokens": kept}
    print(f"router load (tokens/expert): max={kept.max()} min={kept.min()} "
          f"mean={kept.mean():.1f} cv={kept.std() / kept.mean():.2f}")

    # 1. scheduled == direct, bit for bit, whatever the technique
    direct = low.run_direct()
    out.update(direct=direct, scheduled={})
    for spec in ("static", "gss/percore", "fac2", "tss/pergroup"):
        t0 = time.perf_counter()
        sched, res = low.run(spec, n_workers=workers)
        dt = (time.perf_counter() - t0) * 1e3
        ok = np.array_equal(direct, sched)
        chunks = len(res.stages["experts"].schedule)
        out["scheduled"][spec] = "bitwise" if ok else "MISMATCH"
        print(f"  {spec:<14} expert_chunks={chunks:<3} steals={res.steals:<3} "
              f"{dt:6.1f}ms  bit-equal={'yes' if ok else 'NO'}")
        if not ok:
            raise AssertionError(f"{spec}: scheduled != direct")

    # 2. online adaptation over the skewed per-expert costs
    assign, best, uniform = select_offline_dag(
        low.dag, low.stage_costs, n_workers=workers, passes=1)
    statics = sorted(uniform.values())
    on = OnlineScheduler(seed=0)
    tuned = tune_online_dag(low.dag, low.stage_costs, n_workers=workers, rounds=40,
                            seed=0)
    tracer = Tracer(job="moe") if trace_out else None
    simulate_dag(low.dag, low.stage_costs, n_workers=workers, online=on, tracer=tracer)
    gain = (statics[0] - tuned.makespan) / statics[0] * 100
    out.update(offline_experts=list(assign["experts"]), offline_makespan=best,
               best_static_makespan=statics[0], online_makespan=tuned.makespan,
               resizes=dict(on.resizes))
    print(f"offline oracle: {assign['experts']} makespan={best:.0f}")
    print(f"online bandit:  makespan={tuned.makespan:.0f} "
          f"({gain:+.1f}% vs best static uniform {statics[0]:.0f}); "
          f"moldable resizes={on.resizes}")
    if tracer is not None:
        n_resize = sum(1 for s in tracer.spans() if s.kind == "resize")
        tracer.write_chrome_trace(trace_out)
        print(f"trace: {len(tracer)} events ({n_resize} resize marks) -> {trace_out}")
    if tokens >= 384 and experts >= 32 and on.resizes.get("experts", 0) < 1:
        raise AssertionError("skew should force a resize")

    # 3. the device walker (K1's MoE-expert program on the card)
    if device:
        dlow = moe_device_lowering(low)
        with kernel_launches() as launches:
            t0 = time.perf_counter()
            vals, _ = run_device_dag(dlow, "GSS")
            y = dlow.finalize(vals)
            sync(dev)
            dt = (time.perf_counter() - t0) * 1e3
        out["device"] = dict(ms=dt, launches=launches)
        if dev.type == "cpu":
            ok = np.array_equal(y.numpy(), direct)
            out["device"]["combine_vs_direct"] = "bitwise" if ok else "MISMATCH"
            print(f"device walker (plain, cpu): {dt:.1f}ms  bit-equal={'yes' if ok else 'NO'}")
            if not ok:
                raise AssertionError("device combine != direct")
        else:
            shares = device_combine_check(low, dlow, vals["experts"], y, direct)
            out["device"].update(shares)
            print(f"device walker (K1, {dev.type}): {dt:.1f}ms  combine within "
                  f"{shares['combine_vs_direct']:.3f} of its limit against direct "
                  f"(slabs {shares['slabs_vs_float64']:.3f} / "
                  f"{shares['slabs_vs_float64_rss']:.3f} of their float64 limits)")
    return out


def main(argv: list[str] | None = None) -> dict:
    """Parse the reference's flags and ``--torch-device``; run the example."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=384)
    ap.add_argument("--experts", type=int, default=32)
    ap.add_argument("--skew", type=float, default=1.6)
    ap.add_argument("--capacity-factor", type=float, default=6.0)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", action="store_true",
                    help="also run the expert stage through the device walker")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the online-bandit replay, "
                         "including the moldable `resize` marks")
    add_device_flag(ap)
    a = ap.parse_args(argv)
    return run(tokens=a.tokens, experts=a.experts, skew=a.skew,
               capacity_factor=a.capacity_factor, workers=a.workers, device=a.device,
               trace_out=a.trace_out, torch_device=a.torch_device)


if __name__ == "__main__":
    main()
