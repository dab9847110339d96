"""The port's checkpoints (``checkpoint/checkpoint.py``): copies of the
reference's ``tests/test_checkpoint.py`` (its elastic restore onto a mesh
waits for ROADMAP A17: here ``shardings`` raises), the port's own
guarantees (an async save's snapshot, bfloat16 refused, lists kept), and
checkpoints crossing between the two packages, bitwise both ways."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch.checkpoint import (gc_keep_last, latest_step, restore, save, save_async,
                                    wait_for_pending)


def _tree():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)},
        "opt": {"mu": {"w": torch.zeros(3, 4)}, "step": torch.tensor(7, dtype=torch.int32)},
    }


def test_roundtrip(tmp_path):
    save(tmp_path, 5, _tree(), extra={"loss": 1.25})
    tree, extra, step = restore(tmp_path, device="cpu")
    assert step == 5
    assert extra["loss"] == 1.25
    np.testing.assert_array_equal(tree["params"]["w"].numpy(), np.arange(12.0).reshape(3, 4))
    assert int(tree["opt"]["step"]) == 7 and tree["opt"]["step"].dtype == torch.int32


def test_uncommitted_checkpoint_ignored(tmp_path):
    save(tmp_path, 1, _tree())
    save(tmp_path, 2, _tree())
    (tmp_path / "step_00000002.COMMITTED").unlink()  # a crash before the marker
    assert latest_step(tmp_path) == 1
    _, _, step = restore(tmp_path, device="cpu")
    assert step == 1


def test_async_save(tmp_path):
    save_async(tmp_path, 3, _tree())
    wait_for_pending()
    assert latest_step(tmp_path) == 3


def test_gc_keep_last(tmp_path):
    for s in range(6):
        save(tmp_path, s, _tree())
    removed = gc_keep_last(tmp_path, keep=2)
    assert removed == [0, 1, 2, 3]
    assert latest_step(tmp_path) == 5
    restore(tmp_path, 4, device="cpu")  # second-newest still restorable


def test_async_save_snapshots_before_returning(tmp_path):
    """An in-place update after ``save_async`` returns cannot reach the file."""
    tree = _tree()
    save_async(tmp_path, 4, tree)
    tree["params"]["w"].add_(100.0)
    tree["opt"]["step"].fill_(99)
    wait_for_pending()
    got, _, _ = restore(tmp_path, device="cpu")
    np.testing.assert_array_equal(got["params"]["w"].numpy(), np.arange(12.0).reshape(3, 4))
    assert int(got["opt"]["step"]) == 7


def test_refusals(tmp_path):
    """A bfloat16 leaf (numpy has no such dtype) raises rather than being
    cast; a restore onto a mesh names ROADMAP A17."""
    with pytest.raises(TypeError, match="bfloat16"):
        save(tmp_path, 0, {"w": torch.ones(2, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="bfloat16"):
        save_async(tmp_path, 0, {"w": torch.ones(2, dtype=torch.bfloat16)})
    assert latest_step(tmp_path) is None
    save(tmp_path, 1, _tree())
    with pytest.raises(NotImplementedError, match="A17"):
        restore(tmp_path, shardings={"params": None})


def test_lists_roundtrip(tmp_path):
    """The port's per-layer lists (nested, as Zamba2's ``mamba_main``) come
    back as lists, bitwise, in the reference's file layout."""
    rng = np.random.default_rng(0)
    tree = {"layers": [{"w": torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))}
                       for _ in range(3)],
            "mamba_main": [[torch.tensor([float(i * 2 + j)]) for j in range(2)]
                           for i in range(2)],
            "step": torch.tensor(3, dtype=torch.int32)}
    save(tmp_path, 7, tree)
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert set(manifest) == {"step", "extra", "leaves", "lists"}
    assert "layers/1/w" in manifest["leaves"]
    got, _, _ = restore(tmp_path, device="cpu")
    assert isinstance(got["layers"], list) and isinstance(got["mamba_main"][1], list)
    for i in range(3):
        assert torch.equal(got["layers"][i]["w"], tree["layers"][i]["w"])
    assert [[float(t) for t in row] for row in got["mamba_main"]] == [[0.0, 1.0], [2.0, 3.0]]


def _mixed():
    rng = np.random.default_rng(1)
    return {"params": {"w": rng.standard_normal((4, 5)).astype(np.float32),
                       "b": (rng.standard_normal(5) * 1e-30).astype(np.float32)},
            "opt": {"mu": {"w": rng.standard_normal((4, 5)).astype(np.float32)},
                    "step": np.int32(11)},
            "ids": rng.integers(0, 1000, 7).astype(np.int32)}


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield "/".join(path), tree


def test_reference_checkpoint_restores_bitwise_in_the_port(tmp_path):
    want = _mixed()
    jckpt.save(tmp_path, 12, jax.tree.map(jnp.asarray, want), extra={"note": "ref"})
    got, extra, step = restore(tmp_path, device="cpu")
    assert step == 12 and extra == {"note": "ref"}
    for path, w in _walk(want):
        g = dict(_walk(got))[path]
        assert g.numpy().dtype == np.asarray(w).dtype, path
        assert np.array_equal(g.numpy(), np.asarray(w)), path


def test_port_checkpoint_restores_bitwise_in_the_reference(tmp_path):
    want = _mixed()
    tree = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), want)
    tree["layers"] = [{"w": torch.full((2,), float(i))} for i in range(2)]
    save(tmp_path, 13, tree, extra={"note": "port"})
    got, extra, step = jckpt.restore(tmp_path)
    assert step == 13 and extra == {"note": "port"}
    flat = dict(_walk(got))
    for path, w in _walk(want):
        assert np.asarray(flat[path]).dtype == np.asarray(w).dtype, path
        assert np.array_equal(np.asarray(flat[path]), np.asarray(w)), path
    # a list of the port is a dict keyed "0", "1", ... in the reference
    assert [float(got["layers"][str(i)]["w"][0]) for i in range(2)] == [0.0, 1.0]
