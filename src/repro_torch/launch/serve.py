"""Serving launcher: LM continuous batching with DLS-technique admission
chunks, and multi-tenant IDA pipeline serving through the PipelineServer
(the port's copy of ``launch/serve.py``).

    # on the card, Granite-8B at full size
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --requests 8 --slots 4 --prompt-len 2048 --gen-len 16 --technique GSS
    # RWKV6-3B, Zamba2-7B, Qwen1.5-MoE-A2.7B or DeepSeek-V2-Lite the same
    # way: --arch rwkv6-3b / zamba2-7b / qwen2-moe-a2.7b / deepseek-v2-lite-16b
    # on the CPU, the reduced config
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

    # concurrent IDA pipelines from three tenants on one host pool, under
    # all four arbiters, with a Chrome trace and a metrics snapshot
    PYTHONPATH=src python -m repro_torch.launch.serve --mode pipelines \
        --workers 8 --compare --trace-out trace.json --metrics-out m.json

``--mode lm``: the partitioner of ``--technique`` cuts the backlog into
chunks (``next_chunk() or 1``); a chunk is padded to a multiple of
``--slots`` by repeating its last request; each slot batch gets a fresh
cache, one prefill and ``gen_len - 1`` greedy decode steps (argmax over
the unmasked padded-vocab logits, the token at position ``prompt_len +
t``). The weights are fp32, drawn on ``--device`` from a
``torch.Generator`` seeded 0 (the reference's ``jax.random`` key 0 gives
other numbers). The cache (KV for the dense family; token shifts and the
WKV state for RWKV6; conv rows, SSM state and the shared attention's KV
for Zamba2; the latent ``ckv`` and ``kpe`` for MLA) is updated in place
where the reference donates it to a functional update. On a CUDA device a
prompt over 1,024 tokens prefills its attention through K4
(``models/attention.py:chunked_attention``; MLA's at q and k 192 wide, v
128), an RWKV6 prompt its WKV through K6 and a Zamba2 prompt its SSD scan
through K5; the MoE layers' experts are ``torch.einsum`` products, as the
reference computes them.

``--mode pipelines`` serves the reference's mixed four-job submission set
(a CC iteration over a scale-11 RMAT graph, linreg 20,000 x 21, two
recommendation passes 4,096 x 64; three tenants, staggered arrivals, a
deadline on the interactive tenant) on one host pool of ``--workers``
threads under ``--arbiter`` (or all four with ``--compare``). The
pipelines are the host DAGs, numpy on the host pool as in the reference,
so the mode runs the same on the CPU and beside the card.

``--mode openloop`` replays a seeded heavy-tailed trace of ``--requests``
arrivals at offered load ``--load`` on ``--workers`` virtual workers,
FIFO against the front door (admission with a token bucket on the etl
tenant, same-shape batching, ``--arbiter``), in virtual time on the host:

    PYTHONPATH=src python -m repro_torch.launch.serve --mode openloop \
        --requests 2000 --workers 8 --load 1.5
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..configs import get_config
from ..core import make_partitioner
from ..models import Model

__all__ = ["ServeResult", "serve_lm", "serve_pipelines", "serve_openloop",
           "main"]


@dataclass
class ServeResult:
    """What ``serve_lm`` served, and how long it took.

    Per slot batch: the requests of its rows (a padded chunk repeats its
    last request), the generated tokens ``(slots, gen_len)`` and the
    logits each token was taken from ``(slots, gen_len, padded_vocab)``.
    Seconds are host-clock, synchronised with the device at the end of
    each batch's prefill and of its decode steps.
    """

    model: Any
    params: dict
    prompts: np.ndarray
    requests: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    logits: list = field(default_factory=list)
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    seconds: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(args, params: dict | None = None) -> ServeResult:
    """LM continuous batching with DLS-technique admission chunks.

    ``args`` carries the command line's fields (``arch``, ``smoke``,
    ``requests``, ``slots``, ``prompt_len``, ``gen_len``, ``technique``,
    ``device``). ``params`` are the weights to serve (for instance the
    reference's, through ``model_params_from_reference``); None draws them.
    Prints the reference's summary line. Prompts are tokens only, as the
    reference's: InternVL2 serves as a text-only LM, and an
    encoder-decoder (Whisper, which needs its frames) raises ValueError
    before any weight is drawn.
    """
    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if cfg.encdec is not None:
        raise ValueError(f"{args.arch}: serve_lm gives token prompts only, and an "
                         "encoder-decoder's prefill needs its frames too; drive "
                         "Model.prefill and Model.decode_step with batch['frames']")
    if args.smoke:
        cfg = cfg.reduced()
    model = Model(cfg)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = model.init_params(gen, device)
    s_max = args.prompt_len + args.gen_len

    rng = np.random.default_rng(0)
    prompts = np.stack([rng.integers(0, cfg.vocab_size, args.prompt_len,
                                     dtype=np.int32) for _ in range(args.requests)])
    part = make_partitioner(args.technique, args.requests, args.slots)
    res = ServeResult(model, params, prompts)

    served, t0 = 0, time.perf_counter()
    while served < args.requests:
        n = min(part.next_chunk() or 1, args.requests - served)
        reqs = list(range(served, served + n))
        served += n
        reqs += [reqs[-1]] * ((-len(reqs)) % args.slots)
        for i in range(0, len(reqs), args.slots):
            rows = reqs[i:i + args.slots]
            toks = torch.from_numpy(prompts[rows]).to(device)
            t = time.perf_counter()
            cache = model.init_cache(len(rows), s_max, device=device)
            logits, cache = model.prefill(params, {"tokens": toks}, cache)
            step_logits = [logits[:, -1]]
            tok = logits[:, -1].argmax(-1)[:, None]
            out = [tok]
            _sync(device)
            t1 = time.perf_counter()
            for step in range(args.gen_len - 1):
                logits, cache = model.decode_step(params, tok, cache,
                                                  args.prompt_len + step)
                step_logits.append(logits[:, 0])
                tok = logits[:, 0].argmax(-1)[:, None]
                out.append(tok)
            _sync(device)
            res.prefill_seconds += t1 - t
            res.decode_seconds += time.perf_counter() - t1
            res.requests.append(rows)
            res.tokens.append(torch.cat(out, dim=1))
            res.logits.append(torch.stack(step_logits, dim=1))
    res.seconds = time.perf_counter() - t0
    print(f"[serve] {args.requests} requests x {args.gen_len} tokens in "
          f"{res.seconds:.1f}s ({args.requests * args.gen_len / res.seconds:.1f} tok/s)",
          flush=True)
    return res


def _pipeline_submissions(scale: int = 11):
    """A mixed multi-tenant submission set: graph analytics + ML training +
    interactive recommendations (heterogeneous stage costs, staggered
    arrivals)."""
    from ..core import Submission
    from ..vee import linreg_dag, recommendation_dag, rmat_graph
    from ..vee.apps import cc_iteration_dag

    G = rmat_graph(scale=scale, edge_factor=8, seed=5, relabel="blocks")
    labels = np.arange(1, G.n_rows + 1, dtype=np.int64)
    nnz = G.row_nnz().astype(float)
    cc_costs = {"propagate": nnz * 2e-7 + 5e-8,
                "changed": np.full(G.n_rows, 2e-8)}
    lr_dag, _ = linreg_dag(20_000, 21)
    return [
        Submission(name="cc_batch", dag=cc_iteration_dag(G, labels),
                   tenant="graph", weight=1.0, priority=0,
                   stage_costs=cc_costs),
        Submission(name="linreg_train", dag=lr_dag, tenant="ml", weight=2.0,
                   priority=1, arrival_s=0.005),
        Submission(name="recommend_1", dag=recommendation_dag(4096, 64, seed=1),
                   tenant="interactive", weight=4.0, priority=2,
                   arrival_s=0.01, deadline_s=2.0),
        Submission(name="recommend_2", dag=recommendation_dag(4096, 64, seed=2),
                   tenant="interactive", weight=4.0, priority=2,
                   arrival_s=0.02, deadline_s=2.0),
    ]


def _telemetry(args):
    """Build the (tracer, metrics) pair requested by ``--trace-out`` /
    ``--metrics-out``; either is None when its flag is absent, which the
    runtimes treat as the NullTracer path."""
    from ..core import MetricsRegistry, Tracer

    tracer = Tracer() if args.trace_out else None
    metrics = MetricsRegistry() if args.metrics_out else None
    return tracer, metrics


def _dump_telemetry(args, tracer, metrics) -> None:
    """Write the Chrome trace and the metrics snapshot (JSON + a ``.prom``
    Prometheus-text sibling) after a traced run."""
    from pathlib import Path

    if tracer is not None:
        tracer.write_chrome_trace(args.trace_out)
        print(f"[serve] trace: {len(tracer)} events -> {args.trace_out}",
              flush=True)
    if metrics is not None:
        out = Path(args.metrics_out)
        out.write_text(metrics.to_json() + "\n")
        prom = out.with_suffix(".prom")
        prom.write_text(metrics.to_prometheus())
        print(f"[serve] metrics -> {out} (+ {prom})", flush=True)


def _make_serving_arbiter(spec: str, args):
    """Resolve an --arbiter spec; ``preemptive`` wraps weighted-fair with
    the pool size and slack from the command line."""
    from ..core import make_arbiter

    if spec == "preemptive":
        return make_arbiter("preemptive", inner="fair",
                            n_workers=args.workers, slack_s=args.slack)
    return make_arbiter(spec)


def serve_pipelines(args) -> dict:
    """Serve the mixed submission set on one shared pool per arbiter.

    Prints the reference's lines (per arbiter: makespan, p50 and p99 job
    latency, then one line per job and the critical path when traced) and
    writes ``--trace-out`` / ``--metrics-out`` after the last arbiter.
    Returns ``{arbiter: (ServerResult, submissions, tracer, metrics)}``.
    """
    from ..core import PipelineServer, analyze_critical_path, make

    cfg = make("config", args.config, n_workers=args.workers)
    arbiters = (("fifo", "priority", "fair", "preemptive") if args.compare
                else (args.arbiter,))
    tracer = metrics = None
    runs = {}
    for arb in arbiters:
        # fresh tracer per arbiter: job names repeat across compare runs and
        # would otherwise merge into one misleading job hull
        tracer, metrics = _telemetry(args)
        subs = _pipeline_submissions()
        tenant_of = {s.name: s.tenant for s in subs}
        server = PipelineServer(cfg, arbiter=_make_serving_arbiter(arb, args),
                                tracer=tracer, metrics=metrics)
        for s in subs:
            server.submit(s)
        res = server.serve()
        preempt = (f" preemptions={len(res.preemptions)}"
                   if arb == "preemptive" else "")
        print(f"[serve:pipelines] arbiter={arb} jobs={len(res.jobs)}{preempt} "
              f"makespan={res.makespan_s * 1e3:.1f}ms "
              f"p50={res.latency_percentile(50) * 1e3:.1f}ms "
              f"p99={res.latency_percentile(99) * 1e3:.1f}ms", flush=True)
        for name, r in sorted(res.jobs.items()):
            dl = ("" if r.deadline_met is None
                  else f" deadline_met={r.deadline_met}")
            print(f"  {name:>14} tenant={tenant_of[name]:<12} "
                  f"latency={r.latency_s * 1e3:8.1f}ms "
                  f"service={r.service_s * 1e3:7.1f}ms "
                  f"tasks={r.n_tasks}{dl}", flush=True)
        if tracer is not None:
            cp = analyze_critical_path(tracer, makespan=res.makespan_s)
            print(f"  critical path ({arb}): {cp.describe()}", flush=True)
        runs[arb] = (res, subs, tracer, metrics)
    _dump_telemetry(args, tracer, metrics)
    return runs


def serve_openloop(args) -> dict:
    """Replay a heavy-tailed open-loop trace through the front door.

    ``heavy_tailed_trace(--requests, seed=3, load=--load, n_workers=
    --workers)`` through a FIFO baseline, then through the front door:
    ``--arbiter``, the etl tenant's ``TokenBucket(400, 20)``,
    ``BatchPolicy(2e-3, 8)`` and a ``FeedbackLog`` shared by admission
    and the replay. Virtual time on the host, no device work. Prints the
    reference's summary lines and writes ``--trace-out`` /
    ``--metrics-out`` of the front door's replay. Returns
    ``{"fifo baseline": OpenLoopResult, "front door": OpenLoopResult}``.
    """
    from ..core import (
        AdmissionController, BatchPolicy, TokenBucket, heavy_tailed_trace,
        replay_open_loop)
    from ..core.online import FeedbackLog

    trace = heavy_tailed_trace(args.requests, seed=3, load=args.load,
                               n_workers=args.workers)
    base = replay_open_loop(trace, n_workers=args.workers, arbiter="fifo")
    fb = FeedbackLog()
    adm = AdmissionController(
        buckets={"etl": TokenBucket(rate=400.0, capacity=20)}, feedback=fb)
    kwargs = ({"inner": "fair", "n_workers": args.workers,
               "slack_s": args.slack}
              if args.arbiter == "preemptive" else None)
    tracer, metrics = _telemetry(args)
    front = replay_open_loop(trace, n_workers=args.workers,
                             arbiter=args.arbiter, arbiter_kwargs=kwargs,
                             admission=adm,
                             batching=BatchPolicy(2e-3, 8), feedback=fb,
                             tracer=tracer, metrics=metrics)
    runs = {"fifo baseline": base, "front door": front}
    for tag, r in runs.items():
        preempt = f" preemptions={len(r.preemptions)}" if r.preemptions else ""
        print(f"[serve:openloop] {tag}: p50={r.latency_percentile(50) * 1e3:.2f}ms "
              f"p99={r.latency_percentile(99) * 1e3:.2f}ms "
              f"p99.9={r.latency_percentile(99.9) * 1e3:.2f}ms "
              f"hit={r.deadline_hit_rate():.3f} shed={r.shed_rate:.3f} "
              f"batches={r.n_batches}{preempt}", flush=True)
    _dump_telemetry(args, tracer, metrics)
    return runs


def main(argv: list[str] | None = None):
    """Entry point: LM serving, multi-tenant pipeline serving, or the
    open-loop front door. Returns what the mode's function returns."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["lm", "pipelines", "openloop"], default="lm")
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--technique", default="GSS",
                    help="admission-chunk technique for --mode lm (11 options)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve --mode lm on (the tests pass cpu)")
    ap.add_argument("--config", default="gss/percore",
                    help="technique[/layout[/victim]] registry spec for "
                         "--mode pipelines (core.make_config)")
    ap.add_argument("--load", type=float, default=1.5,
                    help="offered-load factor for --mode openloop")
    ap.add_argument("--arbiter", default="fair",
                    choices=["fifo", "priority", "fair", "preemptive"],
                    help="inter-job policy for --mode pipelines/openloop")
    ap.add_argument("--slack", type=float, default=0.5,
                    help="deadline-pressure slack (s) for --arbiter preemptive")
    ap.add_argument("--workers", type=int, default=4,
                    help="shared pool size for --mode pipelines")
    ap.add_argument("--compare", action="store_true",
                    help="pipelines mode: run all four arbiters")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="write a Chrome/Perfetto trace of the run "
                         "(pipelines/openloop modes)")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS.json",
                    help="write a metrics snapshot as JSON plus a .prom "
                         "Prometheus-text sibling (pipelines/openloop modes)")
    args = ap.parse_args(argv)
    if args.mode == "pipelines":
        return serve_pipelines(args)
    if args.mode == "openloop":
        return serve_openloop(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
