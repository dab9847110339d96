"""The port's fault-tolerant loop (``runtime/fault.py``) and training
launcher (``launch/train.py``) on the CPU: copies of the reference's
``tests/test_fault.py``, its straggler case fed fixed step times through
the module's ``perf_counter`` (no sleeps, no dependence on the machine's
load), and ``launch.train.main`` with a checkpoint and a resumed run.
Threads (the data pipeline's executor and prefetch, the async save) can
change only timing here: the tests assert step and retry counts, tokens
and restored values."""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, restore
from repro_torch.launch import train as ttrain
from repro_torch.runtime import fault
from repro_torch.runtime.fault import FaultConfig, RunReport, run_loop


def test_retry_on_transient_failure():
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == 2:  # second call fails once
            raise RuntimeError("transient")
        return state + 1, {}

    state, report = run_loop(step, 0, range(5), config=FaultConfig(max_retries=3))
    assert state == 5
    assert report.retries == 1 and report.steps_run == 5


def test_retries_exhausted_raises():
    def step(state, batch):
        raise RuntimeError("persistent")

    with pytest.raises(RuntimeError):
        run_loop(step, 0, range(3), config=FaultConfig(max_retries=2))


def test_straggler_detected(monkeypatch):
    """Step 8 takes 0.12 s against 0.005 s for the others: flagged beyond
    5 times the rolling median, and no other step is."""
    durations = {b: (0.12 if b == 8 else 0.005) for b in range(12)}
    clock = {"t": 0.0, "batch": None}

    def perf_counter():
        return clock["t"]

    def step(state, batch):
        clock["t"] += durations[batch]
        return state, {}

    monkeypatch.setattr(fault, "perf_counter", perf_counter)
    _, report = run_loop(step, 0, range(12), config=FaultConfig(straggler_factor=5.0))
    assert report.stragglers == [8]
    assert report.step_times == pytest.approx([durations[b] for b in range(12)])


def test_crash_restart_resumes(tmp_path):
    """Kill the loop mid-run; a fresh loop resumes from the checkpoint."""
    cfg = FaultConfig(checkpoint_every=5, async_checkpoint=False)

    class Boom(Exception):
        pass

    def step(state, batch):
        if batch == 12 and int(state["phase"]) == 0:
            raise Boom()
        return {"x": state["x"] + 1, "phase": state["phase"]}, {}

    state0 = {"x": torch.zeros(()), "phase": torch.tensor(0)}
    with pytest.raises(Boom):
        run_loop(step, state0, range(20), ckpt_dir=tmp_path,
                 config=FaultConfig(checkpoint_every=5, max_retries=1,
                                    async_checkpoint=False), restore_device="cpu")
    saved = latest_step(tmp_path)
    assert saved == 9  # steps 4 and 9 were checkpointed before batch 12 failed

    def step2(state, batch):
        return {"x": state["x"] + 1, "phase": torch.tensor(1)}, {}

    state, report = run_loop(step2, state0, range(saved + 1, 20), ckpt_dir=tmp_path,
                             config=cfg, start_step=0, restore_device="cpu")
    assert report.resumed_from == saved
    assert float(state["x"]) == saved + 1 + 10 and report.steps_run == 10


def test_checkpoint_cadence_and_gc(tmp_path):
    """Saves every 2 steps (synchronous, so the pruning does not race a
    writer thread), the newest 3 kept; the last holds the final state."""
    def step(state, batch):
        return {"x": state["x"] + batch}, {}

    state, report = run_loop(step, {"x": torch.zeros(())}, range(10), ckpt_dir=tmp_path,
                             config=FaultConfig(checkpoint_every=2, keep_checkpoints=3,
                                                async_checkpoint=False),
                             restore_device="cpu")
    assert isinstance(report, RunReport) and report.steps_run == 10
    kept = sorted(int(p.name.split("_")[1].split(".")[0])
                  for p in tmp_path.glob("step_*.COMMITTED"))
    assert kept == [5, 7, 9]
    tree, _, step = restore(tmp_path, device="cpu")
    assert step == 9 and float(tree["x"]) == float(state["x"]) == 45.0


def test_train_launcher_smoke_then_resume(tmp_path, capsys):
    """``launch.train.main --smoke --device cpu``: 3 steps with a checkpoint
    after the last, the reference's report lines, finite losses; then a
    resumed run of 2 more steps from step 2 whose restored state is the
    first run's (its step counters go on from 3)."""
    argv = ["--smoke", "--device", "cpu", "--arch", "qwen2-0.5b", "--seq", "32",
            "--global-batch", "4", "--ckpt-dir", str(tmp_path), "--checkpoint-every", "3"]
    run = ttrain.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[train] qwen2-0.5b: ") and out[0].endswith("M params (smoke)")
    assert out[1].startswith("[train] 3 steps, ") and out[1].endswith(
        "retries=0, stragglers=0, resumed_from=None")
    assert run.report.steps_run == 3 and len(run.metrics) == 3
    assert all(np.isfinite(m["loss"]) and m["lr"] > 0 for m in run.metrics)
    assert latest_step(tmp_path) == 2
    tree, _, _ = restore(tmp_path, device="cpu")
    assert torch.equal(tree["params"]["embed"]["table"], run.state.params["embed"]["table"])
    assert int(tree["step"]) == int(run.state.step) == 3

    resumed = ttrain.main(argv + ["--steps", "2"])
    assert resumed.report.resumed_from == 2 and resumed.report.steps_run == 2
    assert int(resumed.state.step) == 5 and int(resumed.state.opt["step"]) == 5
    assert "resumed_from=2" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--data", "2"], ["--model", "2"], ["--multi-pod"],
                                  ["--coordinator", "localhost:1"],
                                  ["--num-processes", "2"]])
def test_train_launcher_refuses_a_mesh(flag):
    with pytest.raises(NotImplementedError, match="A17"):
        ttrain.main(["--smoke", "--device", "cpu", "--steps", "1"] + flag)
