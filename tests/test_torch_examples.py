"""The port's examples (``repro_torch.examples``) on the CPU, against the JAX
package's functions that the reference examples (``examples/*.py``) call,
on the same inputs at reduced sizes.

Each test runs one example through its ``run`` (or ``main``) with
``torch_device="cpu"``, where the kernels' plain versions run, and
recomputes the example's deterministic outputs with the reference's own
functions. Held bitwise: virtual-time outputs (simulated makespans, the
offline and online tuners' choices, placements, open-loop hit rates and
preemptions), component labels and iteration counts (a max and an int sum,
the same in any order), routing loads, greedy tokens, and the examples'
own host-vs-device claims (the plain walker runs the host ops'
arithmetic). Held within a stated tolerance: float sums a pool folds in
completion order or that XLA sums in another order:

* linreg beta from a multi-worker DAG run: ``rtol`` 1e-8 (float64 sums);
* the recommendation's top items: bitwise wherever the two best scores
  lie more than 1e-9 apart (``test_torch_vee.py``'s rule);
* the MoE combine against the reference's direct run: 1e-5 of the largest
  entry (``test_torch_moe.py``'s ``FLOAT_RTOL``: float32 expert products
  summed in another order);
* train_lm's first step through the scheduler (two pool workers, float32
  activations: ``_T32`` / ``_J32``): the loss within 1e-5 of the
  reference's, each gradient leaf within 1e-3 of its largest entry
  (``test_torch_train.py``'s ``F32_GRAD_TOL``); with the model's own
  bfloat16 activations the first loss within 1e-3 (``LOSS_RTOL``).

Nothing that thread timing moves is asserted: no latency, percentile,
steal count, overlap or ``cross_consumptions``. Tests write only under
``tmp_path`` and restore torch's thread count.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.core.autotune import tune_online_dag as jtune_online_dag
from repro.core.executor import SchedulerConfig as JCfg
from repro.vee import apps as japps
from repro.vee import ml_apps as jml
from repro.vee import sparse as jsparse
from repro_torch.core import make_config, validate_chrome_trace
from repro_torch.data import DataPipeline, SyntheticCorpus
from repro_torch.examples import (hetero_pipeline, ida_pipeline, moe_pipeline,
                                  preemptive_serving, quickstart, serve_lm, serve_pipelines,
                                  train_lm)
from repro_torch.models import model_params_from_reference
from repro_torch.optim.adamw import tree_leaves
from repro_torch.vee import ml_apps as tml
from test_torch_rwkv import _J32, _T32
from test_torch_train import F32_GRAD_TOL, LOSS_RTOL, assert_grads_close
from test_torch_vee import _check_rec_many_workers, _exact_step

NAMES = ("train_lm", "serve_lm", "moe_pipeline", "ida_pipeline", "preemptive_serving",
         "hetero_pipeline", "serve_pipelines", "quickstart")
MOE_RTOL = 1e-5
BETA_RTOL = 1e-8
F32_LOSS_RTOL = 1e-5
HETERO_BETA_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module (the examples' pools are the
    parallelism); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# every module
# ---------------------------------------------------------------------------

def test_modules_do_nothing_at_import(capsys):
    """Importing (again) runs nothing: no output, and ``run`` / ``main``
    exist in each."""
    for name in NAMES:
        module = importlib.reload(importlib.import_module(f"repro_torch.examples.{name}"))
        assert callable(module.run) and callable(module.main)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", NAMES)
def test_cuda_without_a_card_raises_before_any_work(name, monkeypatch, capsys):
    """``--torch-device cuda`` (the default) without a card raises; the
    example prints nothing first, so nothing ran on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
    assert capsys.readouterr().out == ""


def test_train_lm_refuses_a_mesh_naming_a17(tmp_path):
    with pytest.raises(NotImplementedError, match="A17"):
        train_lm.run(data=2, ckpt_dir=str(tmp_path), torch_device="cpu")
    with pytest.raises(SystemExit):
        train_lm.main(["--batch", "6", "--microbatches", "4", "--torch-device", "cpu"])


# ---------------------------------------------------------------------------
# quickstart and serve_pipelines: the host pool and virtual time
# ---------------------------------------------------------------------------

def test_quickstart_matches_reference():
    out = quickstart.run(scale=10, linreg_rows=4_000, torch_device="cpu")
    jG = jsparse.rmat_graph(scale=10, edge_factor=8, seed=0, relabel="blocks")
    # labels: the reference's exact regime (one row a chunk; ROADMAP C3)
    labels, iters, _ = japps.connected_components(jG, JCfg(technique="SS", n_workers=2))
    assert np.array_equal(out["labels"], labels) and out["cc_iterations"] == iters
    assert out["components"] == len(np.unique(labels))
    beta, _ = japps.linear_regression(4_000, 17, JCfg(technique="STATIC", n_workers=4))
    assert np.array_equal(out["beta"], beta)     # the VEE sums in chunk order
    costs = (jG.row_nnz().astype(float) + 5.0) * 1e-7
    for tech, ms in out["simulated_makespans"].items():
        assert ms == jcore.simulate(costs, technique=tech, n_workers=20).makespan, tech
    best, scores = jcore.select_offline(costs, n_workers=20, numa_domains=[0] * 10 + [1] * 10)
    assert tuple(out["auto_selected"]) == best
    assert out["auto_selected_makespan"] == scores[best]
    assert out["static_centralized_makespan"] == scores[("STATIC", "CENTRALIZED", "SEQ")]


def _reference_jobs(scale, rows, cols, users, items):
    """``examples/serve_pipelines.py``'s ``make_jobs`` on the reference."""
    G = jsparse.rmat_graph(scale=scale, edge_factor=8, seed=5, relabel="blocks")
    labels = np.arange(1, G.n_rows + 1, dtype=np.int64)
    nnz = G.row_nnz().astype(float)
    lr_dag, _ = japps.linreg_dag(rows, cols)
    rec = {"item_norms": np.full(users, 4e-7), "user_bias": np.full(users, 2e-7),
           "scores": np.full(users, 6e-7)}
    return [
        jcore.Job("cc_batch", japps.cc_iteration_dag(G, labels), tenant="graph", weight=1.0,
                  priority=0, stage_costs={"propagate": nnz * 4e-6 + 1e-6,
                                           "changed": np.full(G.n_rows, 4e-7)}),
        jcore.Job("linreg_train", lr_dag, tenant="ml", weight=2.0, priority=1,
                  arrival_s=0.005, stage_costs={"moments": np.full(rows, 5e-7),
                                                "syrk_gemv": np.full(rows, 2e-6)}),
        jcore.Job("recommend_1", japps.recommendation_dag(users, items, seed=1),
                  tenant="interactive", weight=4.0, priority=2, arrival_s=0.01,
                  deadline_s=2.0, stage_costs=rec),
        jcore.Job("recommend_2", japps.recommendation_dag(users, items, seed=2),
                  tenant="interactive", weight=4.0, priority=2, arrival_s=0.02,
                  deadline_s=2.0, stage_costs=rec),
    ]


def test_serve_pipelines_matches_reference():
    sizes = dict(scale=10, linreg_rows=2_000, linreg_cols=21, rec_users=512, rec_items=64)
    out = serve_pipelines.run(**sizes, torch_device="cpu")
    jobs = lambda: _reference_jobs(10, 2_000, 21, 512, 64)  # noqa: E731
    for arb, got in out["search"].items():
        r = jcore.simulate_server(jobs(), n_workers=8, arbiter=arb)
        assert got == dict(p50=r.latency_percentile(50), p99=r.latency_percentile(99),
                           makespan=r.makespan), arb
    assign, tuned, baseline = jcore.select_offline_server(
        jobs(), n_workers=8, arbiter="fair", objective="p99", passes=1)
    assert out["assign"] == {j: {s: list(c) for s, c in st.items()}
                             for j, st in assign.items()}
    assert (out["tuned_p99"], out["isolated_p99"]) == (tuned, baseline)
    # the drain: every job ran; CC's propagate is a max, the same in any order
    assert out["drained_jobs"] == 4
    G = jsparse.rmat_graph(scale=10, edge_factor=8, seed=5, relabel="blocks")
    want = _exact_step(G, np.arange(1, G.n_rows + 1, dtype=np.int64))
    assert np.array_equal(out["job_values"]["cc_batch"]["propagate"], want)


# ---------------------------------------------------------------------------
# ida_pipeline: Listing 1 and 2 on the DAG runtime, the coordinator, K2
# ---------------------------------------------------------------------------

def test_ida_pipeline_matches_reference():
    out = ida_pipeline.run(scale=10, linreg_rows=3_000, linreg_cols=33, rec_users=400,
                           rec_items=24, dense_n=256, torch_device="cpu")
    jG = jsparse.rmat_graph(scale=10, edge_factor=8, seed=3, relabel="blocks")
    labels, iters, _ = japps.connected_components(jG, JCfg(technique="SS", n_workers=2))
    assert np.array_equal(out["labels"], labels) and out["cc_iterations"] == iters
    nnz = jG.row_nnz().astype(float)
    costs = {"propagate": nnz * 2e-7 + 5e-8, "changed": np.full(jG.n_rows, 2e-8)}
    dag = japps.cc_iteration_dag(jG, np.arange(1, jG.n_rows + 1, dtype=np.int64))
    assign, tuned_ms, uniform = jcore.select_offline_dag(dag, costs, n_workers=8, passes=1)
    assert out["offline_assign"] == {s: list(c) for s, c in assign.items()}
    assert out["offline_makespan"] == tuned_ms
    assert out["best_uniform_makespan"] == min(uniform.values())
    top, wres = japps.recommendation_pipeline(400, 24, JCfg(technique="SS", n_workers=1))
    _check_rec_many_workers(out["top_items"], out["recommendation_values"], wres.values,
                            400, 24, 0)
    beta, _ = japps.linear_regression_dag(3_000, 33, JCfg(technique="STATIC", n_workers=4))
    np.testing.assert_allclose(out["beta"], beta, rtol=BETA_RTOL)
    co = jcore.Coordinator(jcore.CoordinatorConfig(n_nodes=3, node_workers=2,
                                                   technique="FAC2", node_technique="GSS"))
    co.broadcast("labels", np.arange(1, jG.n_rows + 1, dtype=np.int64))
    co.ship_program(lambda store, s, z: jG.row_max_gather(store["labels"], s, s + z))
    assert out["coordinator_partials"] == len(co.run(jG.n_rows))
    assert out["device"] == {t: "bitwise" for t in ("STATIC", "MFSC", "GSS")}
    assert out["launches"] == {}     # the plain version launches nothing


# ---------------------------------------------------------------------------
# moe_pipeline: the host techniques, the tuners, the device walker
# ---------------------------------------------------------------------------

MOE = dict(tokens=96, experts=8, skew=1.6, capacity_factor=6.0, workers=2)


def test_moe_pipeline_matches_reference(tmp_path):
    jlow = jml.moe_dispatch_lowering(n_tokens=MOE["tokens"], skew=MOE["skew"], seed=0,
                                     n_experts=MOE["experts"],
                                     capacity_factor=MOE["capacity_factor"])
    params = tml.moe_params_from_reference(jlow.meta["params"], device="cpu")
    trace = tmp_path / "moe_trace.json"
    out = moe_pipeline.run(**MOE, device=True, trace_out=str(trace), torch_device="cpu",
                           params=params)
    assert np.array_equal(out["expert_tokens"], np.asarray(jlow.meta["expert_tokens"]))
    direct = np.asarray(jlow.run_direct())
    np.testing.assert_allclose(out["direct"], direct, rtol=MOE_RTOL,
                               atol=MOE_RTOL * float(np.abs(direct).max()))
    assert set(out["scheduled"].values()) == {"bitwise"}
    assign, best, uniform = jcore.select_offline_dag(jlow.dag, jlow.stage_costs,
                                                     n_workers=MOE["workers"], passes=1)
    assert out["offline_experts"] == list(assign["experts"])
    assert out["offline_makespan"] == best
    assert out["best_static_makespan"] == sorted(uniform.values())[0]
    tuned = jtune_online_dag(jlow.dag, jlow.stage_costs, n_workers=MOE["workers"],
                             rounds=40, seed=0)
    assert out["online_makespan"] == tuned.makespan
    on = jcore.OnlineScheduler(seed=0)
    jcore.simulate_dag(jlow.dag, jlow.stage_costs, n_workers=MOE["workers"], online=on)
    assert out["resizes"] == dict(on.resizes)
    assert out["device"]["combine_vs_direct"] == "bitwise"
    assert out["device"]["launches"] == {}
    assert validate_chrome_trace(json.loads(trace.read_text())) == []


# ---------------------------------------------------------------------------
# preemptive_serving and hetero_pipeline: migration and co-execution
# ---------------------------------------------------------------------------

def test_preemptive_serving_matches_reference(tmp_path):
    trace = tmp_path / "preempt_trace.json"
    out = preemptive_serving.run(jobs=120, trace_out=str(trace), torch_device="cpu")
    low = japps.linreg_device_lowering(256, 9, tile=64)
    cfg = JCfg(technique="SS", queue_layout="CENTRALIZED", n_workers=1)
    _, ck = jcore.PreemptiveRunner(low.dag, cfg, preempt_after=2, job="linreg").run()
    assert out["checkpoint"] == {n: dict(executed=s.executed, pending=len(s.pending),
                                         remaining_tiles=s.remaining_rows)
                                 for n, s in ck.stages.items()}
    for part in ("host_resume", "host_to_device", "device_to_host"):
        assert out[part] == {"moments": "bitwise", "syrk_gemv": "bitwise"}, part
    trace_jobs = jcore.heavy_tailed_trace(120, seed=3, load=5.0, n_workers=8)
    fair = jcore.replay_open_loop(trace_jobs, n_workers=8, arbiter="fair")
    pre = jcore.replay_open_loop(trace_jobs, n_workers=8, arbiter="preemptive",
                                 arbiter_kwargs={"inner": "fair", "n_workers": 8,
                                                 "slack_s": 0.5})
    first = next(e for e in pre.preemptions if e.kind == "preempt")
    assert out["fair_hit_rate"] == fair.deadline_hit_rate()
    assert out["preemptive_hit_rate"] == pre.deadline_hit_rate()
    assert out["preemption_events"] == len(pre.preemptions)
    assert out["first_preemption"] == dict(t=first.t, job=first.job, reason=first.reason)
    assert validate_chrome_trace(json.loads(trace.read_text())) == []


def test_hetero_pipeline_matches_reference():
    out = hetero_pipeline.run(affinity_rows=512, rounds=40, torch_device="cpu")
    dag, costs = japps.hetero_affinity_dag(512)
    placement, hetero_ms, base = jcore.select_placement(dag, costs, n_workers=8)
    assert (out["placed_makespan"], out["all_host_makespan"], out["all_device_makespan"]) \
        == (hetero_ms, base["host"], base["device"])
    assert out["placement"] == placement.describe()
    res = jcore.simulate_hetero_dag(dag, costs, placement, n_workers=8)
    assert out["transfers"] == sum(res.stats.transfers.values())
    assert out["link_seconds"] == res.transfer_s
    tuned = jcore.tune_online_hetero(dag, costs, n_workers=8, rounds=40, seed=0)
    assert out["online_assign"] == {k: list(v) for k, v in tuned.assign.items()}
    assert out["online_makespan"] == tuned.makespan
    for part in ("co_execution", "submission_placement"):
        assert out[part] == {"moments": "bitwise", "syrk_gemv": "bitwise"}, part
    jlow = japps.linreg_device_lowering(512, 9, tile=64)
    host_only = jcore.PipelineExecutor(jlow.dag, JCfg(technique="SS", n_workers=1)).run()
    np.testing.assert_allclose(out["beta"], jlow.finalize(host_only.values),
                               rtol=HETERO_BETA_RTOL)
    assert out["beta_matches_oracle"]


# ---------------------------------------------------------------------------
# serve_lm: scheduled generation, greedy tokens against the reference's
# ---------------------------------------------------------------------------

SERVE = dict(requests=5, slots=2, prompt_len=8, gen_len=4)


def _reference_generate(jm, jp, prompts, gen_len):
    """``examples/serve_lm.py``'s ``generate`` over every request."""
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    s_max = prompts.shape[1] + gen_len
    rows = []
    for r in range(len(prompts)):
        cache = jm.init_cache(1, s_max, dtype=jnp.float32)
        logits, cache = prefill(jp, {"tokens": jnp.asarray(prompts[r][None])}, cache)
        out = [jnp.argmax(logits[:, -1], -1)]
        for t in range(gen_len - 1):
            logits, cache = decode(jp, out[-1][:, None], cache,
                                   jnp.int32(prompts.shape[1] + t))
            out.append(jnp.argmax(logits[:, 0], -1))
        rows.append(np.asarray(jnp.stack(out)[:, 0], np.int32))
    return np.stack(rows)


def test_serve_lm_tokens_match_reference(capsys):
    """The reference's weights in float32 activations on both sides: the
    scheduled tokens (GSS chunks on two pool threads) are the reference's
    greedy tokens, bitwise."""
    cfg = serve_lm.config()
    jcfg = dataclasses.replace(jget_config("granite-8b").reduced(), n_layers=4, d_model=128,
                               d_ff=256)
    jm = _J32(jcfg)
    jp = jm.init_params(jax.random.key(0))
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    out = serve_lm.run(**SERVE, torch_device="cpu", params=tp, model=_T32(cfg))
    rng = np.random.default_rng(0)
    prompts = np.stack([rng.integers(0, cfg.vocab_size, SERVE["prompt_len"])
                        for _ in range(SERVE["requests"])]).astype(np.int32)
    want = _reference_generate(jm, jp, prompts, SERVE["gen_len"])
    assert out["tokens"].dtype == np.int32
    assert np.array_equal(out["tokens"], want)
    assert out["scheduled_vs_direct"] == "bitwise"
    assert sum(out["chunks"]) == SERVE["requests"]
    assert f"served {SERVE['requests']} requests" in capsys.readouterr().out


def test_serve_lm_main_on_the_cpu(capsys):
    out = serve_lm.main(["--requests", "3", "--slots", "2", "--prompt-len", "6",
                         "--gen-len", "3", "--torch-device", "cpu"])
    assert out["tokens"].shape == (3, 3) and out["launches"] == {}
    assert "admission chunks (gss/percore)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# train_lm: gradients through the scheduler, the loop
# ---------------------------------------------------------------------------

WIDTHS = dict(d_model=64, layers=2, heads=4, d_ff=128, vocab=512)


def _pair():
    """The scaled config on both sides (float32 activations) and the
    reference's weights (jax key 0) carried to the port."""
    cfg = train_lm.scaled_config(**WIDTHS)
    jcfg = dataclasses.replace(
        jget_config("granite-8b"), n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, d_head=0, vocab_size=512, vocab_pad_multiple=64, moe=None, mla=None,
        ssm=None, rwkv=None, encdec=None, frontend=None, family="dense",
        first_layer_dense=False, tie_embeddings=False)
    jm = _J32(jcfg)
    jp = jm.init_params(jax.random.key(0))
    return cfg, jcfg, jm, jp, model_params_from_reference(jax.tree.map(np.asarray, jp),
                                                          "cpu")


def test_flatten_round_trips():
    *_, tp = _pair()
    flat = train_lm.flatten(tp)
    back = train_lm.unflatten(flat, tp)
    assert flat.dtype == torch.float32
    assert flat.numel() == sum(t.numel() for t in tree_leaves(tp))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(tp)))
    assert torch.equal(train_lm.flatten(back), flat)


def test_train_lm_scheduled_gradients_match_reference():
    """One step's gradient stage: 4 microbatches as the rows of a ``sum``
    stage on two pool threads (FAC2), against the reference's
    ``jax.value_and_grad`` of each microbatch summed."""
    cfg, _, jm, jp, tp = _pair()
    seq, batch, n_micro = 24, 4, 4
    pipe = DataPipeline(SyntheticCorpus(vocab_size=512, mean_len=seq // 2), batch, seq)
    toks = pipe.assemble(0)
    summed, res = train_lm.scheduled_grads(_T32(cfg), tp, torch.from_numpy(toks), n_micro,
                                           make_config("fac2", n_workers=2))
    assert res.stages["micrograds"].schedule is not None
    mb = toks.reshape(n_micro, batch // n_micro, -1)
    fn = jax.jit(jax.value_and_grad(lambda p, t: jm.train_loss(p, {"tokens": t}),
                                    has_aux=True))
    loss, grads = 0.0, None
    for m in range(n_micro):
        (l_m, _), g_m = fn(jp, jnp.asarray(mb[m]))
        loss += float(l_m)
        grads = g_m if grads is None else jax.tree.map(jnp.add, grads, g_m)
    got = train_lm.unflatten(summed[1:] / n_micro, tp)
    assert abs(float(summed[0]) / n_micro - loss / n_micro) <= F32_LOSS_RTOL * loss / n_micro
    assert_grads_close(got, jax.tree.map(lambda g: np.asarray(g) / n_micro, grads),
                       F32_GRAD_TOL)


def test_train_lm_runs_and_its_first_loss_is_the_reference(tmp_path, capsys):
    """The whole loop on the reference's weights (the model's own bfloat16
    activations): its first loss is the reference's on the first batch,
    the loss decreases, and a checkpoint is written in ``tmp_path``."""
    cfg, jcfg, _, jp, tp = _pair()
    from repro.models import Model as JModel

    jm = JModel(jcfg)
    kw = dict(WIDTHS, seq=32, batch=4, microbatches=2, steps=6, lr=3e-3,
              ckpt_dir=str(tmp_path), torch_device="cpu")
    out = train_lm.run(**kw, params=tp)
    toks = DataPipeline(SyntheticCorpus(vocab_size=512, mean_len=16), 4, 32).assemble(0)
    loss = np.mean([float(jm.train_loss(jp, {"tokens": jnp.asarray(m)})[0])
                    for m in toks.reshape(2, 2, -1)])
    assert abs(out["first_loss"] - loss) <= LOSS_RTOL[torch.bfloat16] * loss
    assert out["steps_run"] == 6 and out["last_loss"] < out["first_loss"]
    assert out["resumed_from"] is None and 0 < out["pool_wait_share"] <= 1
    assert any(p.name.startswith("step_") for p in tmp_path.iterdir())
    assert "DECREASED" in capsys.readouterr().out
