"""The port's scheduler core against the JAX package's, bit for bit.

Partitioner schedules, pipeline-DAG super-tables and their signatures are
numpy in both packages; the port keeps its own copy, so every table must
be identical. Also guards the port's imports: it must load with ``jax``
and ``repro`` blocked.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.core import partitioners as jparts
from repro.core import device_schedule as jsched
from repro.core.dag import PipelineDAG as JDAG, Stage as JStage, StageDep as JDep
from repro.vee import sparse as jsparse
from repro_torch.core import partitioners as tparts
from repro_torch.core import device_schedule as tsched
from repro_torch.core.dag import PipelineDAG as TDAG, Stage as TStage, StageDep as TDep
from repro_torch.vee import sparse as tsparse

ROOT = Path(__file__).resolve().parents[1]
TECHS = sorted(jparts.PARTITIONERS)


def test_same_techniques():
    assert sorted(tparts.PARTITIONERS) == TECHS


@pytest.mark.parametrize("tech", TECHS)
def test_chunk_schedule_bitwise(tech):
    for n, workers, seed in [(1, 1, 0), (37, 3, 1), (1000, 8, 2), (4096, 16, 3)]:
        want = jparts.chunk_schedule(tech, n, workers, seed=seed)
        got = tparts.chunk_schedule(tech, n, workers, seed=seed)
        assert got.dtype == want.dtype and np.array_equal(got, want), (n, workers)
        for r in (0, 1, n):
            assert (tparts.first_chunk(tech, r, workers, seed)
                    == jparts.first_chunk(tech, r, workers, seed))
            assert (tparts.first_chunk_fn(tech, workers, seed)(r)
                    == jparts.first_chunk_fn(tech, workers, seed)(r))


def _dummy(inputs, s, z):
    return np.zeros(z)


def _random_dags(rng, n_stages, n_rows):
    """The same random DAG built with both packages' data models."""
    deps = [()]
    for i in range(1, n_stages):
        kind = "elementwise" if rng.random() < 0.5 else "full"
        deps.append(((f"s{int(rng.integers(0, i))}", kind),))
    ew_producers = {p for d in deps for p, k in d if k == "elementwise"}
    combine = ["sum" if f"s{i}" not in ew_producers and rng.random() < 0.3
               else "concat" for i in range(n_stages)]
    jdag = JDAG([JStage(f"s{i}", n_rows, _dummy, combine=combine[i],
                        deps=tuple(JDep(p, k) for p, k in deps[i]))
                 for i in range(n_stages)])
    tdag = TDAG([TStage(f"s{i}", n_rows, _dummy, combine=combine[i],
                        deps=tuple(TDep(p, k) for p, k in deps[i]))
                 for i in range(n_stages)])
    return jdag, tdag


@pytest.mark.parametrize("seed", range(8))
def test_build_dag_tables_bitwise(seed):
    rng = np.random.default_rng(seed)
    tile = 4
    jdag, tdag = _random_dags(rng, int(rng.integers(2, 5)),
                              tile * int(rng.integers(2, 12)))
    assert tdag.stage_names == jdag.stage_names
    has_full = any(d.kind == "full" for s in jdag.stages.values() for d in s.deps)
    techs = {n: TECHS[int(rng.integers(len(TECHS)))] for n in jdag.stage_names}
    for n_shards in ([1] if has_full else [1, 2, 3]):
        for assignment in ("roundrobin", "contiguous"):
            kw = dict(n_shards=n_shards, n_workers=4, assignment=assignment,
                      seed=seed)
            want = jsched.build_dag_tables(jdag, tile, techs, **kw)
            got = tsched.build_dag_tables(tdag, tile, techs, **kw)
            assert np.array_equal(got.tables, want.tables)
            assert got.stage_names == want.stage_names
            for n in jdag.stage_names:
                assert np.array_equal(got.stage_chunks[n], want.stage_chunks[n])
                assert np.array_equal(got.chunk_shard[n], want.chunk_shard[n])
            assert (tsched.dag_signature(tdag, tile, techs, **kw)
                    == jsched.dag_signature(jdag, tile, techs, **kw))


def test_build_dag_tables_cost_balanced_bitwise():
    rng = np.random.default_rng(5)
    jdag, tdag = _random_dags(np.random.default_rng(1), 1, 64)
    costs = {"s0": rng.pareto(1.5, 64)}
    want = jsched.build_dag_tables(jdag, 4, "GSS", n_shards=4, chunk_costs=costs)
    got = tsched.build_dag_tables(tdag, 4, "GSS", n_shards=4, chunk_costs=costs)
    assert np.array_equal(got.tables, want.tables)


def test_build_dag_tables_cache():
    _, tdag = _random_dags(np.random.default_rng(2), 3, 32)
    tsched.clear_dag_table_cache()
    a = tsched.build_dag_tables_cached(tdag, 4, "FAC2")
    b = tsched.build_dag_tables_cached(tdag, 4, "FAC2")
    assert a is b and not a.tables.flags.writeable
    assert tsched.dag_table_cache_stats() == {"hits": 1, "misses": 1, "size": 1}
    tsched.clear_dag_table_cache()
    assert tsched.dag_table_cache_stats() == {"hits": 0, "misses": 0, "size": 0}


def test_build_task_table_bitwise():
    for tech in TECHS:
        assert np.array_equal(tsched.build_task_table(tech, 100, 4, max_chunks=120),
                              jsched.build_task_table(tech, 100, 4, max_chunks=120))


def test_dag_validation_errors():
    with pytest.raises(ValueError, match="cycle"):
        TDAG([TStage("a", 4, _dummy, deps=(TDep("b"),)),
              TStage("b", 4, _dummy, deps=(TDep("a"),))])
    with pytest.raises(ValueError, match="concat"):
        TDAG([TStage("a", 4, _dummy, combine="sum"),
              TStage("b", 4, _dummy, deps=(TDep("a", "elementwise"),))])
    with pytest.raises(ValueError, match="full dep"):
        tsched.build_dag_tables(
            TDAG([TStage("a", 8, _dummy, combine="sum"),
                  TStage("b", 8, _dummy, deps=(TDep("a", "full"),))]),
            2, n_shards=2)


def test_rmat_dense_bitwise():
    jg = jsparse.rmat_graph(scale=9, edge_factor=8, seed=3)
    tg = tsparse.rmat_graph(scale=9, edge_factor=8, seed=3)
    assert np.array_equal(jg.indptr, tg.indptr)
    assert np.array_equal(jg.indices, tg.indices)
    assert np.array_equal(jg.to_dense(), tg.to_dense())


_GUARD = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(m.name)
    from repro_torch.vee.apps import (linear_regression_device,
                                      recommendation_migrated)
    beta, _, _ = linear_regression_device(256, 5, device="cpu")
    assert beta.shape == (5, 1)
    top, _, _ = recommendation_migrated(128, 16, cut=3, device="cpu")
    assert top.shape == (128,)
    from repro_torch.configs import list_configs
    from repro_torch.vee.apps import (linreg_device_lowering,
                                      merge_device_lowerings, run_device_dag)
    from repro_torch.vee.ml_apps import moe_device_lowering, moe_dispatch_lowering
    assert len(list_configs()) == 10
    low = moe_dispatch_lowering(n_tokens=8, device="cpu")
    assert moe_device_lowering(low).finalize(
        run_device_dag(moe_device_lowering(low))[0]).shape == (8, 64)
    merged = merge_device_lowerings([linreg_device_lowering(128, 5, seed=s,
                                                            device="cpu")
                                     for s in (1, 2)])
    assert len(run_device_dag(merged)[0]) == 4
    for m in ("task", "victim", "queues", "online", "telemetry", "executor",
              "submit", "dag", "preempt", "registry", "lower", "admission",
              "simulator", "autotune", "coordinator"):
        assert f"repro_torch.core.{m}" in sys.modules, m
    for m in ("configs.base", "configs.qwen2_moe_a2_7b", "models.layers",
              "models.moe", "vee.ml_apps", "vee.engine"):
        assert f"repro_torch.{m}" in sys.modules, m
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    print("ok")
""")


def test_port_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _GUARD], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_chip_smoke_and_port_import_no_jax_or_repro():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    for f in files:
        tops = {m.split(".")[0] for m in _imported_modules(f)}
        assert not tops & {"jax", "jaxlib", "repro"}, (f, tops)
