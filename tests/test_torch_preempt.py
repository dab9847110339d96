"""The port's checkpoints and host<->device migration, on the CPU.

Three kinds of check, at the reference's own sizes (linreg 256 x 9,
recommendation 128 x 192, tile 64):

* the port's own migration matrix is BITWISE: on the CPU the walker is the
  plain walker, whose stage bodies do the host ops' per-tile math, and
  ``WalkStage.seed`` starts a resumed sum from the host's ascending prefix,
  so ``migrate_to_device`` equals ``run_device_dag(low, "SS")`` and
  ``resume_on_host(run_device_prefix(...))`` equals ``PipelineExecutor``
  bit for bit. No thread pinning is needed: every per-tile reduction is
  below PyTorch's parallel grain, so it runs on one thread wherever it is
  called (pool worker or main thread);
* the port against the JAX package: beta to 1e-6 and top items exactly;
  a JAX host checkpoint migrated by the port agrees with JAX's own
  migration to a relative 1e-5 (``FLOAT_RTOL``: PyTorch and XLA sum a
  tile's rows in different orders), concat int32 stages exactly;
* ``WalkStage.seed``'s checks raise, naming the stage.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import PreemptiveRunner as JRunner
from repro.core import SchedulerConfig as JConfig
from repro.core.preempt import migrate_to_device as j_migrate
from repro.vee import apps as japps
from repro_torch.core import (JobCheckpoint, PipelineDAG, PipelineExecutor,
                              PreemptableStageRun, PreemptiveRunner,
                              SchedulerConfig, Stage, StageCheckpoint, StageDep,
                              checkpoint_from_reference, migrate_to_device,
                              resume_on_host, run_device_prefix)
from repro_torch.core.preempt import device_remainder
from repro_torch.kernels import dag_walk as twalk
from repro_torch.vee import apps as tapps

FLOAT_RTOL = 1e-5
SS1 = dict(technique="SS", queue_layout="CENTRALIZED", n_workers=1)


def _lowering(which):
    if which == "linreg":
        return tapps.linreg_device_lowering(256, 9, tile=64, device="cpu")
    return tapps.recommendation_device_lowering(128, 192, tile=64, device="cpu")


def _total(low):
    return sum(low.dag.stages[n].n_rows for n in low.dag.order)


def _host_values(low, values):
    out = {}
    for ws in low.stages:
        v = values[ws.name]
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out[ws.name] = v.reshape(ws.out_shape)
    return out


# ---------------------------------------------------------------------------
# the port's own migration matrix, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cut", ["1", "2", "total-1"])
@pytest.mark.parametrize("which", ["linreg", "recommendation"])
def test_migration_matrix_bit_equal(which, cut):
    low = _lowering(which)
    cfg = SchedulerConfig(**SS1)
    p = {"1": 1, "2": 2, "total-1": _total(low) - 1}[cut]
    host_ref = _host_values(low, PipelineExecutor(low.dag, cfg).run().values)
    dev_ref, _ = tapps.run_device_dag(low, "SS")
    # host -> device: preempt the host run, re-lower the remainder
    res, ck = PreemptiveRunner(low.dag, cfg, preempt_after=p).run()
    assert res is None, f"cut {p} did not preempt"
    vals = migrate_to_device(ck, low)
    assert set(vals) == set(dev_ref)
    for k in dev_ref:
        assert torch.equal(vals[k], dev_ref[k]), (p, k)
    # device -> host: freeze a device prefix, finish on the pool
    ck2, walked = run_device_prefix(low, p)
    assert ck2.substrate == "device" and all(v.device.type == "cpu"
                                             for v in walked.values())
    fin = _host_values(low, resume_on_host(ck2, low.dag, cfg).values)
    for k in host_ref:
        assert torch.equal(fin[k], host_ref[k]), (p, k)


@pytest.mark.parametrize("which", ["linreg", "recommendation"])
def test_migrated_entry_points_bit_equal(which):
    ref_fn = {"linreg": tapps.linear_regression_device,
              "recommendation": tapps.recommendation_device}[which]
    mig_fn = {"linreg": tapps.linear_regression_migrated,
              "recommendation": tapps.recommendation_migrated}[which]
    size = (256, 9) if which == "linreg" else (128, 192)
    want, want_vals, _ = ref_fn(*size, stage_techniques="SS", device="cpu")
    for direction in ("host_to_device", "device_to_host"):
        for cut in (3, 10**6):  # the second cut lies past the job's end
            got, vals, seconds = mig_fn(*size, cut=cut, direction=direction,
                                        device="cpu")
            assert set(seconds) == {"host", "walk"}
            if which == "linreg":
                assert np.array_equal(got, want), (direction, cut)
            else:
                assert torch.equal(got, want), (direction, cut)
            for k in want_vals:
                assert torch.equal(vals[k], want_vals[k]), (direction, cut, k)
    with pytest.raises(ValueError, match="migration direction"):
        mig_fn(*size, cut=1, direction="sideways", device="cpu")


def test_device_prefix_bounds():
    low = _lowering("linreg")
    cfg = SchedulerConfig(technique="SS", n_workers=1)
    ref = _host_values(low, PipelineExecutor(low.dag, cfg).run().values)
    # n_slots=0: nothing ran on-device, the host does everything
    ck, walked = run_device_prefix(low, 0)
    assert walked == {} and ck.remaining_chunks > 0
    got = _host_values(low, resume_on_host(ck, low.dag, cfg).values)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    # n_slots past the table end clamps: resume completes immediately
    ck_all, _ = run_device_prefix(low, _total(low) + 99)
    assert ck_all.empty
    got = _host_values(low, resume_on_host(ck_all, low.dag, cfg).values)
    assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_migrate_rejects_out_of_order_sum_partials():
    low = _lowering("linreg")
    cfg = SchedulerConfig(technique="SS", n_workers=1)
    _, ck = PreemptiveRunner(low.dag, cfg, preempt_after=1).run()
    name = next(n for n, s in ck.stages.items() if s.combine == "sum")
    sck = ck.stages[name]
    done = sck.row_done.copy()
    done[2] = True
    pend = tuple((s, z) for s, z in sck.pending if s != 2)
    bad = dict(ck.stages)
    bad[name] = StageCheckpoint(
        stage=sck.stage, n_rows=sck.n_rows, combine="sum", pending=pend,
        row_done=done, acc=sck.acc, acc_next=sck.acc_next,
        parts=((2, 1, torch.zeros(2, 8)),), executed=sck.executed + 1)
    with pytest.raises(ValueError, match="resume on host"):
        migrate_to_device(JobCheckpoint(job=ck.job, stages=bad), low)


def test_remainder_plan_seeds_and_drops():
    """A cut inside syrk_gemv: moments is complete (a plain operand), and
    syrk_gemv alone is walked, seeded with the host prefix."""
    low = _lowering("linreg")
    cfg = SchedulerConfig(**SS1)
    _, ck = PreemptiveRunner(low.dag, cfg, preempt_after=6).run()
    plan = device_remainder(ck, low)
    assert [s.name for s in plan.stages] == ["syrk_gemv"]
    assert plan.stages[0].seed == "syrk_gemv__resume"
    assert torch.equal(plan.values["syrk_gemv__resume"], ck.stages["syrk_gemv"].acc)
    assert torch.equal(plan.values["moments"], ck.stages["moments"].acc)
    assert plan.table.tolist() == [[0, 128, 64], [0, 192, 64]]
    # the seed is what makes the sum right: zeroed, the walk misses the prefix
    want, _ = tapps.run_device_dag(low, "SS")
    assert torch.equal(plan.walk()["syrk_gemv"], want["syrk_gemv"])
    zero = dict(plan.values, syrk_gemv__resume=torch.zeros(9, 10))
    out = twalk.dag_walk(plan.stages, plan.operands, zero, plan.table, plan.tile)
    assert not torch.allclose(out["syrk_gemv"], want["syrk_gemv"])


def test_recommendation_replays_completed_producer_tiles():
    low = _lowering("recommendation")
    cfg = SchedulerConfig(**SS1)
    _, ck = PreemptiveRunner(low.dag, cfg, preempt_after=2).run()
    plan = device_remainder(ck, low)
    # item_norms tile 0 is folded into the seed; user_bias tile 0 is done
    # on the host but scores tile 0 reads it, so the walk replays it
    assert plan.need == {"item_norms": {1}, "user_bias": {0, 1},
                         "scores": {0, 1}}
    assert [s.seed for s in plan.stages] == ["item_norms__resume", None, None]


# ---------------------------------------------------------------------------
# checkpoint format and the host runner (the port's copy of the harness)
# ---------------------------------------------------------------------------

def _int_dag(n, kind):
    a = Stage("a", n, lambda i, s, z: np.arange(s, s + z, dtype=np.int64) * 3 + 1,
              combine="concat")
    b = Stage("b", n, lambda i, s, z: i["a"][s:s + z] + 7, combine="concat",
              deps=(StageDep("a", "elementwise"),))
    c = Stage("c", n, lambda i, s, z: int(i["a"][s:s + z].sum()), combine="sum",
              deps=(StageDep("a", kind),))
    d = Stage("d", n, lambda i, s, z: int(i["b"][s:s + z].sum()) + i["c"],
              combine="sum", deps=(StageDep("b", "elementwise"),
                                   StageDep("c", "full")))
    return PipelineDAG([a, b, c, d])


@pytest.mark.parametrize("n,workers,tech,layout,impl,kind,cut", [
    (1, 1, "SS", "CENTRALIZED", "slot", "full", 1),
    (37, 2, "GSS", "PERCORE", "deque", "elementwise", 5),
    (120, 3, "FAC2", "PERGROUP", "slot", "full", 17),
    (200, 4, "STATIC", "PERCORE", "slot", "elementwise", 2),
    (64, 4, "SS", "CENTRALIZED", "deque", "full", 60),
    (90, 1, "TSS", "PERGROUP", "deque", "elementwise", 9),
])
def test_exactly_once_under_preemption(n, workers, tech, layout, impl, kind, cut):
    dag = _int_dag(n, kind)
    cfg = SchedulerConfig(technique=tech, queue_layout=layout,
                          victim_strategy="RND", n_workers=workers,
                          numa_domains=tuple(w % 2 for w in range(workers)),
                          queue_impl=impl)
    ref = PipelineExecutor(dag, cfg).run()
    res, ck = PreemptiveRunner(dag, cfg, preempt_after=cut).run()
    if ck is None:
        fin = res
    else:
        ck.validate(dag)
        fin = resume_on_host(ck, dag, cfg)
        assert len(fin.events) == ck.remaining_chunks
    for k in "abcd":
        assert np.array_equal(np.asarray(fin.values[k]), np.asarray(ref.values[k])), k


def test_trigger_form_repreempt_and_rechunk():
    dag = _int_dag(64, "elementwise")
    cfg = SchedulerConfig(**SS1)
    ref = PipelineExecutor(dag, cfg).run()
    _, ck = PreemptiveRunner(dag, cfg, trigger=lambda d: d >= 5).run()
    assert ck is not None and ck.substrate == "host"
    res2, ck2 = PreemptiveRunner(dag, cfg, preempt_after=3).run(resume_from=ck)
    assert res2 is None
    fin, left = PreemptiveRunner(dag, cfg, rechunk_target=8).run(resume_from=ck2)
    assert left is None
    for k in "abcd":
        assert np.array_equal(np.asarray(fin.values[k]), np.asarray(ref.values[k]))


def test_validate_rejects_torn_checkpoints():
    base = dict(stage="a", n_rows=4, combine="concat", pending=((2, 2),),
                row_done=np.array([1, 1, 0, 0], bool), out=np.zeros(4))
    for change, msg in [(dict(pending=((3, 2),)), "out of range"),
                        (dict(pending=((2, 2), (3, 1))), "overlapping"),
                        (dict(pending=((1, 3),)), "overlaps completed"),
                        (dict(pending=((2, 1),)), "lost"),
                        (dict(out=None), "no out buffer")]:
        with pytest.raises(ValueError, match=msg):
            StageCheckpoint(**{**base, **change}).validate()
    s = dict(stage="s", n_rows=4, combine="sum", pending=((2, 2),),
             row_done=np.array([1, 1, 0, 0], bool))
    with pytest.raises(ValueError, match="exceeds the completed prefix"):
        StageCheckpoint(acc=1.0, acc_next=3, **s).validate()
    with pytest.raises(ValueError, match="acc=None"):
        StageCheckpoint(acc=None, acc_next=2, **s).validate()
    with pytest.raises(ValueError, match="already folded"):
        StageCheckpoint(acc=1.0, acc_next=2, parts=((0, 2, 5.0),), **s).validate()
    dag = _int_dag(8, "full")
    _, ck = PreemptiveRunner(dag, SchedulerConfig(technique="SS", n_workers=1),
                             preempt_after=1).run()
    with pytest.raises(ValueError, match="!= DAG"):
        ck.validate(_int_dag(16, "full"))
    other = Stage("a", 16, lambda i, s, z: np.zeros(z), combine="concat")
    with pytest.raises(ValueError, match="does not match"):
        PreemptableStageRun.restore(ck.stages["a"], other,
                                    SchedulerConfig(n_workers=1), [0])


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def test_migrated_entry_points_match_jax():
    jbeta = japps.linear_regression_migrated(256, 9, cut=2)
    jtop = japps.recommendation_migrated(128, 192, cut=3)
    for direction in ("host_to_device", "device_to_host"):
        beta, _, _ = tapps.linear_regression_migrated(256, 9, cut=2,
                                                      direction=direction,
                                                      device="cpu")
        np.testing.assert_allclose(beta, jbeta, atol=1e-6)
        top, _, _ = tapps.recommendation_migrated(128, 192, cut=3,
                                                  direction=direction,
                                                  device="cpu")
        assert np.array_equal(top.numpy(), jtop)


@pytest.mark.parametrize("which,cut", [("linreg", 2), ("linreg", 6),
                                       ("recommendation", 3)])
def test_jax_checkpoint_migrated_by_port(which, cut):
    if which == "linreg":
        jlow = japps.linreg_device_lowering(256, 9, tile=64)
    else:
        jlow = japps.recommendation_device_lowering(128, 192, tile=64)
    tlow = _lowering(which)
    _, jck = JRunner(jlow.dag, JConfig(**SS1), preempt_after=cut).run()
    want = j_migrate(jck, jlow)
    ck = checkpoint_from_reference(jck)
    ck.validate(tlow.dag)
    for n, s in ck.stages.items():
        js = jck.stages[n]
        assert s.pending == js.pending and np.array_equal(s.row_done, js.row_done)
        if s.acc is not None:
            assert np.array_equal(s.acc.numpy(), np.asarray(js.acc))
    got = migrate_to_device(ck, tlow)
    for ws in tlow.stages:
        w = np.asarray(want[ws.name])
        g = got[ws.name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        if np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), ws.name
        else:
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL,
                                       atol=FLOAT_RTOL * np.abs(w).max())


def test_entry_points_default_to_cuda():
    import inspect

    for fn in (tapps.linear_regression_migrated, tapps.recommendation_migrated):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# WalkStage.seed checks
# ---------------------------------------------------------------------------

def _seeded(low, name, seed_value, key="seed"):
    stages = [dataclasses.replace(s, seed=key) if s.name == name else s
              for s in low.stages]
    return stages, dict(low.values, **{key: seed_value})


def _rows(low):
    from repro_torch.core import build_dag_tables

    rows = build_dag_tables(low.dag, 1, "SS").tables[0].copy()
    rows[:, 1:] *= low.tile
    return rows


@pytest.mark.parametrize("walker", ["plain", "dispatch", "stagewise"])
def test_seed_checks_raise(walker):
    low = _lowering("recommendation")
    rows = _rows(low)
    walk = {"plain": twalk.dag_walk_plain, "dispatch": twalk.dag_walk,
            "stagewise": twalk.dag_walk_stagewise}[walker]
    cases = [
        ("user_bias", torch.zeros(128), "only a sum stage"),
        ("item_norms", torch.zeros(191), "seed 'seed' is torch.float32 \\(191,\\)"),
        ("item_norms", torch.zeros(192, dtype=torch.float64), "torch.float64"),
        ("item_norms", torch.zeros(192, device="meta"), "lies on meta"),
    ]
    for name, value, msg in cases:
        stages, values = _seeded(low, name, value)
        with pytest.raises(ValueError, match=f"stage '{name}': .*{msg}"):
            walk(stages, low.operands, values, rows, low.tile)
    stages, _ = _seeded(low, "item_norms", None)
    with pytest.raises(ValueError, match="stage 'item_norms': seed 'seed' is not"):
        walk(stages, low.operands, low.values, rows, low.tile)


def test_seeded_walk_starts_from_seed():
    low = _lowering("recommendation")
    rows = _rows(low)
    seed = torch.arange(192, dtype=torch.float32)
    stages, values = _seeded(low, "item_norms", seed)
    got = twalk.dag_walk(stages, low.operands, values, rows, low.tile)
    # the first fold is seed + tile_0, then + tile_1: not seed + (tile_0 + tile_1)
    R = low.values["R"]
    t0, t1 = (R[:64] * R[:64]).sum(0), (R[64:] * R[64:]).sum(0)
    assert torch.equal(got["item_norms"], (seed + t0) + t1)
    assert torch.equal(seed, torch.arange(192, dtype=torch.float32))  # not written
    sw = twalk.dag_walk_stagewise(stages, low.operands, values, rows, low.tile)
    assert torch.equal(sw["item_norms"], got["item_norms"])


def test_seeded_stage_refuses_multi_shard_walk():
    low = _lowering("recommendation")
    keep = [s for s in low.stages if s.name != "scores"]
    stages = [dataclasses.replace(keep[0], seed="seed"), keep[1]]
    dag = PipelineDAG([Stage(s.name, 2, None, combine=s.combine) for s in keep])
    from repro_torch.core import build_dag_tables

    rows = build_dag_tables(dag, 1, "STATIC", n_shards=2).tables.copy()
    rows[:, :, 1:] *= low.tile
    values = dict(low.values, seed=torch.zeros(192))
    with pytest.raises(ValueError, match="'item_norms' starts from seed 'seed': "
                                         "a 2-shard walk"):
        twalk.dag_walk_sharded(stages, low.operands, values, rows, low.tile)
    one = rows[:1]
    out = twalk.dag_walk_sharded(stages, low.operands, values, one, low.tile)
    assert out["item_norms"].shape == (192,)
