"""The paper's IDA pipelines, on the host pool and on the device walker.

Connected components (sparse, load-imbalanced — paper Listing 1):

    c = seq(1, n)
    while diff > 0 and iter <= maxi:
        u = max(rowMaxs(G * t(c)), c)   # neighbour propagation
        diff = sum(u != c)
        c = u

Linear regression training (dense, balanced — paper Listing 2):

    X, y <- random; standardize X; X1 = [X, 1]
    A = syrk(X1) + lambda*I ; b = gemv(X1, y) ; beta = solve(A, b)

as two sum stages joined by a barrier edge (``moments`` -> ``syrk_gemv``),
the two-branch recommendation pipeline (``item_norms``, ``user_bias``
-> ``scores``), and one connected-components iteration (``propagate`` ->
``changed``, the walker program with an inner axis over column tiles).

On the host, both listings run on the VEE (``connected_components``,
``linear_regression``) and as pipeline DAGs on one shared pool
(``connected_components_dag``, ``linear_regression_dag``,
``recommendation_pipeline``, and the ``*_online`` loops under the online
feedback scheduler), on numpy as the reference runs them. On the device,
each pipeline is frozen into a super-table by
``core/device_schedule.py:build_dag_tables_cached`` and drained by the
walker (kernels/dag_walk.py) in one launch. Data is made with numpy from a
seed, exactly as the JAX package's lowerings make it, and lies on the
lowering's ``device``.

``linear_regression_migrated`` / ``recommendation_migrated`` run the same
pipelines with one mid-flight move between the host pool and the walker
(core/preempt.py); ``linear_regression_hetero`` / ``recommendation_hetero``
split them across host workers and walker lanes by a solved placement
(core/placement.py, core/hetero.py). ``merge_device_lowerings`` coalesces same-tile
lowerings into one super-table, the front door's batching on the device
path: one walker launch drains the whole batch.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.admission import BATCH_SEP, merge_dags
from ..core.dag import (DEP_ELEMENTWISE, DEP_FULL, DagResult, PipelineDAG,
                        PipelineExecutor, Stage, StageDep)
from ..core.device_schedule import build_dag_tables_cached
from ..core.executor import SchedulerConfig
from ..core.online import OnlineScheduler, default_online_arms
from ..core.preempt import (PreemptiveRunner, migrate_to_device,
                            resume_on_host, run_device_prefix)
from ..core.submit import Submission
from ..kernels.cc_propagate import propagate_body
from ..kernels.dag_walk import (WalkOperand, WalkStage, dag_walk_sharded,
                                dag_walk_stagewise)
from .engine import VEE, PipelineResult
from .sparse import CSRMatrix

__all__ = [
    "cc_step_numpy", "connected_components", "linear_regression",
    "connected_components_dag", "linreg_dag", "linear_regression_dag",
    "linear_regression_online", "recommendation_online",
    "recommendation_dag", "recommendation_pipeline",
    "linear_regression_oracle", "recommendation_oracle", "DeviceLowering",
    "run_device_dag", "linreg_device_lowering", "linear_regression_device",
    "recommendation_device_lowering", "recommendation_device",
    "scores_plain", "scores_den", "sqrt_rn", "values_from_reference",
    "linear_regression_migrated", "recommendation_migrated", "merge_device_lowerings",
    "split_device_values",
    "CC_TECHNIQUES", "cc_iteration_dag", "cc_iteration_lowering",
    "cc_iteration_device", "hetero_affinity_dag", "linear_regression_hetero",
    "recommendation_hetero",
]


def linear_regression_oracle(num_rows: int, num_cols: int, lam: float = 0.001,
                             seed: int = 1) -> np.ndarray:
    """Serial float64 numpy oracle for the linear-regression pipeline."""
    rng = np.random.default_rng(seed)
    XY = rng.uniform(0.0, 1.0, size=(num_rows, num_cols))
    X, y = XY[:, :-1], XY[:, -1:]
    Xm, Xs = X.mean(0), X.std(0)
    Xs[Xs == 0] = 1.0
    X1 = np.concatenate([(X - Xm) / Xs, np.ones((num_rows, 1))], axis=1)
    A = X1.T @ X1 + np.eye(num_cols) * lam
    b = X1.T @ y
    return np.linalg.solve(A, b)


def recommendation_oracle(n_users: int, n_items: int, density: float = 0.3,
                          seed: int = 0) -> np.ndarray:
    """Serial float64 numpy oracle: each user's top item."""
    rng = np.random.default_rng(seed)
    R = rng.uniform(0.0, 1.0, size=(n_users, n_items))
    R *= rng.uniform(size=(n_users, n_items)) < density
    norms = np.sqrt((R ** 2).sum(axis=0)) + 1e-9
    bias = R.mean(axis=1)
    return np.argmax(R / norms - bias[:, None], axis=1)


# ---------------------------------------------------------------- host pool
# The paper's Listings 1 and 2 on the VEE and the pipeline-DAG runtime, on
# numpy, as the reference runs them.

def cc_step_numpy(G: CSRMatrix, c: np.ndarray) -> np.ndarray:
    """Serial oracle for one propagation step (whole matrix)."""
    return G.row_max_gather(c)


def connected_components(
    G: CSRMatrix,
    config: SchedulerConfig,
    max_iter: int = 100,
) -> tuple[np.ndarray, int, list[PipelineResult]]:
    """Paper Listing 1 on DaphneSched. Returns (labels, iters, per-iter results)."""
    n = G.n_rows
    c = np.arange(1, n + 1, dtype=np.int64)
    row_nnz = G.row_nnz()

    def cost_of_range(start: int, size: int) -> float:
        return float(row_nnz[start : start + size].sum() + size)

    history: list[PipelineResult] = []
    vee = VEE(config)
    for it in range(1, max_iter + 1):
        c_cur = c  # bind for the closure

        def op(start, size, c_cur=c_cur):
            return G.row_max_gather(c_cur, start, start + size)

        res = vee.run(n, op, combine="concat", cost_of_range=cost_of_range)
        u = res.value
        history.append(res)
        diff = int((u != c).sum())
        c = u
        if diff == 0:
            return c, it, history
    return c, max_iter, history


def linear_regression(
    num_rows: int,
    num_cols: int,
    config: SchedulerConfig,
    lam: float = 0.001,
    seed: int = 1,
) -> tuple[np.ndarray, list[PipelineResult]]:
    """Paper Listing 2 on DaphneSched. Returns (beta, stage results)."""
    rng = np.random.default_rng(seed)
    XY = rng.uniform(0.0, 1.0, size=(num_rows, num_cols))
    X, y = XY[:, :-1], XY[:, -1:]

    # normalization / standardization (dense row-parallel)
    Xmean = X.mean(axis=0)
    Xstd = X.std(axis=0)
    Xstd[Xstd == 0] = 1.0

    vee = VEE(config)
    history: list[PipelineResult] = []

    # A = syrk(X1) = X1^T X1 and b = gemv(X1, y), partial-summed over row
    # blocks; X1 = [(X - mean)/std, 1]
    def partial_syrk_gemv(start: int, size: int):
        Xb = (X[start : start + size] - Xmean) / Xstd
        Xb = np.concatenate([Xb, np.ones((Xb.shape[0], 1))], axis=1)
        yb = y[start : start + size]
        return np.concatenate([Xb.T @ Xb, Xb.T @ yb], axis=1)

    res = vee.run(num_rows, partial_syrk_gemv, combine="sum")
    history.append(res)
    Ab = res.value
    A, b = Ab[:, :-1], Ab[:, -1:]
    A = A + np.eye(A.shape[0]) * lam
    beta = np.linalg.solve(A, b)
    return beta, history


def connected_components_dag(
    G: CSRMatrix,
    config: SchedulerConfig,
    per_stage: dict | None = None,
    max_iter: int = 100,
    tuner=None,
) -> tuple[np.ndarray, int, list[DagResult]]:
    """Paper Listing 1 through the pipeline-DAG runtime.

    ``per_stage`` maps stage name -> (technique, layout, victim) combo or
    SchedulerConfig; ``tuner`` (a core.DagTuner) overrides it per iteration
    and observes the iteration wall time (online per-stage selection).
    """
    n = G.n_rows
    c = np.arange(1, n + 1, dtype=np.int64)
    history: list[DagResult] = []
    for it in range(1, max_iter + 1):
        if tuner is not None:
            per_stage = tuner.suggest()
        dag = cc_iteration_dag(G, c)
        res = PipelineExecutor(dag, config).run(Submission(per_stage=per_stage))
        if tuner is not None:
            tuner.observe(res.wall_time_s)
        history.append(res)
        diff = int(res.values["changed"])
        c = res.values["propagate"]
        if diff == 0:
            return c, it, history
    return c, max_iter, history


def linreg_dag(
    num_rows: int,
    num_cols: int,
    lam: float = 0.001,
    seed: int = 1,
):
    """Paper Listing 2 as a composable DAG (no execution).

    Returns ``(dag, finalize)``: stage ``moments`` partial-sums column
    sums and squared sums (for mean/std standardization); ``syrk_gemv``
    depends on it in full and accumulates X1^T X1 and X1^T y over row
    blocks. ``finalize(values)`` performs the tiny host-side solve and
    returns beta. Used by linear_regression_dag and the online loop.
    """
    rng = np.random.default_rng(seed)
    XY = rng.uniform(0.0, 1.0, size=(num_rows, num_cols))
    X, y = XY[:, :-1], XY[:, -1:]

    def moments_op(inputs, s, z):
        Xb = X[s:s + z]
        return np.stack([Xb.sum(axis=0), (Xb ** 2).sum(axis=0)])

    def syrk_gemv_op(inputs, s, z):
        m = inputs["moments"]
        mean = m[0] / num_rows
        std = np.sqrt(np.maximum(m[1] / num_rows - mean ** 2, 0.0))
        std[std == 0] = 1.0
        Xb = (X[s:s + z] - mean) / std
        Xb = np.concatenate([Xb, np.ones((Xb.shape[0], 1))], axis=1)
        yb = y[s:s + z]
        return np.concatenate([Xb.T @ Xb, Xb.T @ yb], axis=1)

    dag = PipelineDAG([
        Stage("moments", num_rows, moments_op, combine="sum"),
        Stage("syrk_gemv", num_rows, syrk_gemv_op, combine="sum",
              deps=(StageDep("moments", DEP_FULL),)),
    ])

    def finalize(values: dict) -> np.ndarray:
        Ab = values["syrk_gemv"]
        A, b = Ab[:, :-1], Ab[:, -1:]
        A = A + np.eye(A.shape[0]) * lam
        return np.linalg.solve(A, b)

    return dag, finalize


def linear_regression_dag(
    num_rows: int,
    num_cols: int,
    config: SchedulerConfig,
    lam: float = 0.001,
    seed: int = 1,
    per_stage: dict | None = None,
) -> tuple[np.ndarray, DagResult]:
    """Paper Listing 2 as a DAG: moments -> standardized syrk/gemv -> solve.

    The DAG comes from ``linreg_dag``; the tiny solve happens on the host
    after the run. Returns (beta, DagResult).
    """
    dag, finalize = linreg_dag(num_rows, num_cols, lam=lam, seed=seed)
    res = PipelineExecutor(dag, config).run(Submission(per_stage=per_stage))
    return finalize(res.values), res


def _make_online(online, selector: str, seed: int):
    """Default OnlineScheduler for real-pool loops (SS excluded: chunk=1
    over thousands of rows swamps a thread pool with task dust)."""
    if online is not None:
        return online
    return OnlineScheduler(selector=selector,
                           arms=default_online_arms(include_ss=False),
                           seed=seed)


def linear_regression_online(
    num_rows: int,
    num_cols: int,
    config: SchedulerConfig,
    rounds: int = 3,
    online=None,
    selector: str = "ucb",
    lam: float = 0.001,
    seed: int = 1,
) -> tuple[np.ndarray, list[DagResult], object]:
    """Paper Listing 2 served repeatedly under the online feedback loop.

    Each round replays the linreg DAG on a real PipelineExecutor pool with
    the same core.online.OnlineScheduler: the per-stage bandits pick the
    round's configs, measured chunk times stream back, and stage
    remainders resize mid-run — the closed-loop counterpart of passing a
    ``select_offline_dag`` assignment in ``per_stage``. Returns
    (beta from the final round, per-round DagResults, the trained
    scheduler — reusable across calls to keep learning).
    """
    online = _make_online(online, selector, seed)
    dag, finalize = linreg_dag(num_rows, num_cols, lam=lam, seed=seed)
    history: list[DagResult] = []
    for _ in range(max(1, rounds)):
        res = PipelineExecutor(dag, config).run(Submission(online=online))
        history.append(res)
    return finalize(history[-1].values), history, online


def recommendation_online(
    n_users: int,
    n_items: int,
    config: SchedulerConfig,
    rounds: int = 3,
    online=None,
    selector: str = "ucb",
    density: float = 0.3,
    seed: int = 0,
) -> tuple[np.ndarray, list[DagResult], object]:
    """The recommendation DAG served repeatedly under the feedback loop.

    Same closed loop as ``linear_regression_online`` over the two-branch
    recommendation pipeline. Returns (final top items, per-round
    DagResults, the trained OnlineScheduler).
    """
    online = _make_online(online, selector, seed)
    dag = recommendation_dag(n_users, n_items, density=density, seed=seed)
    history: list[DagResult] = []
    for _ in range(max(1, rounds)):
        res = PipelineExecutor(dag, config).run(Submission(online=online))
        history.append(res)
    return history[-1].values["scores"], history, online


def recommendation_dag(
    n_users: int,
    n_items: int,
    density: float = 0.3,
    seed: int = 0,
) -> PipelineDAG:
    """The two-branch recommendation DAG (no execution).

    ``item_norms`` (reduction over the ratings matrix) and ``user_bias``
    (per-user mean) have no edge between them, so they overlap on a
    shared pool; ``scores`` consumes item_norms in full and user_bias
    elementwise and emits each user's top item.
    """
    rng = np.random.default_rng(seed)
    R = rng.uniform(0.0, 1.0, size=(n_users, n_items))
    R *= rng.uniform(size=(n_users, n_items)) < density

    item_norms = Stage(
        "item_norms", n_users,
        lambda inputs, s, z: (R[s:s + z] ** 2).sum(axis=0), combine="sum")
    user_bias = Stage(
        "user_bias", n_users,
        lambda inputs, s, z: R[s:s + z].mean(axis=1), combine="concat")

    def scores_op(inputs, s, z):
        norms = np.sqrt(inputs["item_norms"]) + 1e-9
        bias = inputs["user_bias"][s:s + z]
        return np.argmax(R[s:s + z] / norms - bias[:, None], axis=1)

    scores = Stage(
        "scores", n_users, scores_op, combine="concat",
        deps=(StageDep("item_norms", DEP_FULL),
              StageDep("user_bias", DEP_ELEMENTWISE)))
    return PipelineDAG([item_norms, user_bias, scores])


def recommendation_pipeline(
    n_users: int,
    n_items: int,
    config: SchedulerConfig,
    per_stage: dict | None = None,
    density: float = 0.3,
    seed: int = 0,
) -> tuple[np.ndarray, DagResult]:
    """Run the recommendation DAG on one PipelineExecutor pool.

    See ``recommendation_dag`` for the stage graph (the two independent
    branches overlap on the shared pool). Returns (top_items, result).
    """
    dag = recommendation_dag(n_users, n_items, density=density, seed=seed)
    res = PipelineExecutor(dag, config).run(Submission(per_stage=per_stage))
    return res.values["scores"], res


def values_from_reference(values: dict[str, np.ndarray],
                          device: str | torch.device = "cuda"
                          ) -> dict[str, torch.Tensor]:
    """A JAX lowering's ``values`` (as numpy arrays) as the port's values.

    Both packages can then be driven from one set of arrays: the arrays
    are copied (JAX hands out read-only buffers) and moved to ``device``.
    """
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in values.items()}


@dataclass
class DeviceLowering:
    """A pipeline lowered for the device walker, host-checkable.

    ``dag`` is a host PipelineDAG in TILE units (one task row = one
    walker row tile) whose ops do the same per-tile torch math as the
    walker's plain stage bodies; host concat values are ``(n_tiles, tile,
    ...)``. ``stages`` / ``operands`` / ``values`` are the walker's specs
    and tensors (row space). ``finalize`` maps stage values to the
    pipeline's answer (e.g. the linreg solve).
    """

    dag: PipelineDAG
    stages: list
    operands: list
    values: dict
    tile: int
    finalize: object = None


def run_device_dag(
    lowering: DeviceLowering,
    stage_techniques: dict | str | None = None,
    n_shards: int = 1,
    n_workers: int | None = None,
    chunk_costs: dict | None = None,
    seed: int = 0,
    stagewise: bool = False,
):
    """Execute a DeviceLowering end-to-end on the walker.

    Freezes the tile-unit DAG with ``build_dag_tables_cached`` (per-stage
    techniques), scales the super-table slots to row space, then drains
    them with the fused walker on the device the lowering's values lie on
    — or one launch per stage when ``stagewise=True``. Returns ``(values,
    tables)``: stage outputs as tensors (row space) and the
    DeviceDagTables (tile units) walked. Repeat jobs of one shape hit the
    host lowering memo (keyed by the ``dag_signature``) and the walker's
    device-resident table cache (keyed by the table's content).
    """
    ddt = build_dag_tables_cached(
        lowering.dag, 1, stage_techniques, n_shards=n_shards,
        n_workers=n_workers, chunk_costs=chunk_costs, seed=seed)
    rows = ddt.tables.copy()
    rows[:, :, 1:] *= lowering.tile  # tile units -> row space for the walker
    if stagewise:
        if n_shards != 1:
            raise ValueError("stagewise baseline runs single-shard")
        out = dag_walk_stagewise(lowering.stages, lowering.operands,
                                 lowering.values, rows[0], lowering.tile)
    else:
        out = dag_walk_sharded(lowering.stages, lowering.operands,
                               lowering.values, rows, lowering.tile)
    return out, ddt


def merge_device_lowerings(lowerings: list[DeviceLowering]) -> DeviceLowering:
    """Coalesce same-tile DeviceLowerings into ONE super-table launch.

    The front door's batching on the device path: member ``j``'s stages,
    operands, values and seeds are renamed ``name#j`` (the batch
    convention of ``core/admission.py``), bodies and host ops wrapped to
    see their original names, each stage tagged ``member=j``, and the host
    DAGs merged with ``merge_dags`` — so ``build_dag_tables`` freezes one
    super-table covering every member and the walker drains the whole
    batch in one launch (the CUDA walker holds up to ``MAX_MEMBERS`` of
    one program). Members stay disjoint (each keeps its own operands and
    accumulators), so the merged run is bit-equal to running each lowering
    alone. ``finalize`` returns the list of per-member finalize results;
    ``split_device_values`` recovers per-member stage values.
    """
    if not lowerings:
        raise ValueError("cannot merge an empty batch of lowerings")
    tiles = {low.tile for low in lowerings}
    if len(tiles) != 1:
        raise ValueError(f"cannot merge lowerings with mixed tiles {tiles}")

    def _wrap_body(body):
        def wrapped(ctx, ins, out):
            body(ctx, {k.rsplit(BATCH_SEP, 1)[0]: v for k, v in ins.items()},
                 out)
        return wrapped

    by_name, operands, values = {}, [], {}
    for j, low in enumerate(lowerings):
        for st in low.stages:
            renamed = dataclasses.replace(
                st, name=f"{st.name}{BATCH_SEP}{j}",
                body=_wrap_body(st.body),
                operands=tuple(f"{o}{BATCH_SEP}{j}" for o in st.operands),
                reads=tuple((f"{p}{BATCH_SEP}{j}", kind)
                            for p, kind in st.reads),
                seed=None if st.seed is None else f"{st.seed}{BATCH_SEP}{j}",
                member=j)
            by_name[renamed.name] = renamed
        for op in low.operands:
            operands.append(dataclasses.replace(
                op, name=f"{op.name}{BATCH_SEP}{j}"))
        for k, v in low.values.items():
            values[f"{k}{BATCH_SEP}{j}"] = v

    merged_dag = merge_dags([low.dag for low in lowerings])
    # build_dag_tables numbers stage ids by the merged DAG's topological
    # order (members interleave): the walker's stage list must match it
    stages = [by_name[n] for n in merged_dag.stage_names]

    members = list(lowerings)

    def finalize(stage_values: dict) -> list:
        per_member = split_device_values(stage_values, len(members))
        return [low.finalize(vals) if low.finalize is not None else vals
                for low, vals in zip(members, per_member)]

    return DeviceLowering(merged_dag, stages, operands, values,
                          lowerings[0].tile, finalize)


def split_device_values(values: dict, n_members: int) -> list[dict]:
    """Split merged ``name#j`` stage values back into per-member dicts."""
    out: list[dict] = [{} for _ in range(n_members)]
    for name, v in values.items():
        base, _, idx = name.rpartition(BATCH_SEP)
        out[int(idx)][base] = v
    return out


def _rows(a: np.ndarray, t: int, tile: int) -> torch.Tensor:
    return torch.from_numpy(a[t * tile:(t + 1) * tile])


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """The float32 square root, correctly rounded on every entry, as
    ``jnp.sqrt`` and the kernel's ``__fsqrt_rn`` give it. PyTorch's CPU
    float32 ``sqrt`` can sit one unit in the last place off, so on the CPU
    the root is taken in float64 and rounded once to float32 (a double
    root rounds to the correct float root: sqrt never lies that close to a
    float32 rounding boundary). On the card ``torch.sqrt`` rounds
    correctly, and is taken as it is."""
    if t.device.type == "cpu" and t.dtype == torch.float32:
        return torch.sqrt(t.double()).float()
    return torch.sqrt(t)


# ---------------------------------------------------------------- linreg

def _moments_tile(Xb: torch.Tensor) -> torch.Tensor:
    return torch.stack([Xb.sum(dim=0), (Xb * Xb).sum(dim=0)])


def _syrk_tile(Xb: torch.Tensor, yb: torch.Tensor, M: torch.Tensor,
               n: int) -> torch.Tensor:
    mean = M[0] / n
    std = sqrt_rn(torch.clamp(M[1] / n - mean * mean, min=0.0))
    std = torch.where(std == 0, torch.ones_like(std), std)
    X1 = torch.cat([(Xb - mean) / std,
                    torch.ones((Xb.shape[0], 1), dtype=Xb.dtype,
                               device=Xb.device)], dim=1)
    # broadcast-multiply + reduce, as the JAX lowering writes it
    A = (X1[:, :, None] * X1[:, None, :]).sum(dim=0)
    b = (X1 * yb).sum(dim=0)
    return torch.cat([A, b[:, None]], dim=1)


def linreg_device_lowering(
    num_rows: int,
    num_cols: int,
    tile: int = 64,
    lam: float = 0.001,
    seed: int = 1,
    device: str | torch.device = "cuda",
) -> DeviceLowering:
    """Paper Listing 2 lowered for the walker.

    Two sum stages joined by a barrier edge: ``moments`` accumulates
    column sums/squared sums; ``syrk_gemv`` standardizes each row tile
    against the FULL moments (read from the walker's accumulator in the
    middle of the walk) and accumulates X1^T X1 | X1^T y.
    """
    if num_rows % tile:
        raise ValueError(f"num_rows={num_rows} must be a multiple of tile={tile}")
    rng = np.random.default_rng(seed)
    XY = rng.uniform(0.0, 1.0, size=(num_rows, num_cols)).astype(np.float32)
    X, y = np.ascontiguousarray(XY[:, :-1]), np.ascontiguousarray(XY[:, -1:])
    del XY
    d = num_cols - 1
    n = num_rows
    units = n // tile

    def moments_op(inputs, s, z):
        acc = None
        for t in range(s, s + z):
            v = _moments_tile(_rows(X, t, tile))
            acc = v if acc is None else acc + v
        return acc

    def syrk_op(inputs, s, z):
        M = torch.as_tensor(inputs["moments"])
        acc = None
        for t in range(s, s + z):
            v = _syrk_tile(_rows(X, t, tile), _rows(y, t, tile), M, n)
            acc = v if acc is None else acc + v
        return acc

    dag = PipelineDAG([
        Stage("moments", units, moments_op, combine="sum"),
        Stage("syrk_gemv", units, syrk_op, combine="sum",
              deps=(StageDep("moments", DEP_FULL),)),
    ])

    def moments_body(ctx, ins, out):
        out += _moments_tile(ins["X"])

    def syrk_body(ctx, ins, out):
        out += _syrk_tile(ins["X"], ins["y"], ins["moments"], n)

    stages = [
        WalkStage("moments", n, (2, d), torch.float32, "sum", moments_body,
                  operands=("X",), device_body="linreg.moments"),
        WalkStage("syrk_gemv", n, (d + 1, d + 2), torch.float32, "sum",
                  syrk_body, operands=("X", "y"),
                  reads=(("moments", "full"),),
                  device_body="linreg.syrk_gemv"),
    ]
    operands = [
        WalkOperand("X", (tile, d), ("row", "zero")),
        WalkOperand("y", (tile, 1), ("row", "zero")),
    ]
    values = {"X": torch.from_numpy(X).to(device),
              "y": torch.from_numpy(y).to(device)}

    def finalize(stage_values: dict) -> np.ndarray:
        Ab = stage_values["syrk_gemv"].cpu().numpy()
        A, b = Ab[:, :-1], Ab[:, -1:]
        A = A + np.eye(A.shape[0], dtype=A.dtype) * lam
        return np.linalg.solve(A, b)

    return DeviceLowering(dag, stages, operands, values, tile, finalize)


def linear_regression_device(
    num_rows: int,
    num_cols: int,
    tile: int = 64,
    stage_techniques: dict | str | None = None,
    lam: float = 0.001,
    seed: int = 1,
    stagewise: bool = False,
    device: str | torch.device = "cuda",
):
    """Paper Listing 2 end-to-end on the walker.

    Returns (beta, stage values, DeviceDagTables). ``stagewise=True``
    runs the one-launch-per-stage baseline instead of the fused walker.
    """
    low = linreg_device_lowering(num_rows, num_cols, tile=tile, lam=lam,
                                 seed=seed, device=device)
    vals, ddt = run_device_dag(low, stage_techniques, stagewise=stagewise)
    return low.finalize(vals), vals, ddt


# -------------------------------------------------------- recommendation

def _norms_tile(Rb: torch.Tensor) -> torch.Tensor:
    return (Rb * Rb).sum(dim=0)


def _bias_tile(Rb: torch.Tensor) -> torch.Tensor:
    return Rb.mean(dim=1)


def scores_den(norms: torch.Tensor) -> torch.Tensor:
    """``sqrt(norms) + 1e-9`` in float32, the root correctly rounded: the
    reference's ``jnp.sqrt(norms) + 1e-9`` and the kernel's ``den``,
    bitwise."""
    return sqrt_rn(norms) + 1e-9


def _scores_tile(Rb: torch.Tensor, norms: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    return torch.argmax(Rb / scores_den(norms) - bias[:, None],
                        dim=1).to(torch.int32)


def scores_plain(R: torch.Tensor, norms: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The ``scores`` body over every user at once (a check's reference)."""
    return _scores_tile(R, norms, bias)


def recommendation_device_lowering(
    n_users: int,
    n_items: int,
    tile: int = 64,
    density: float = 0.3,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> DeviceLowering:
    """The two-branch recommendation DAG lowered for the walker.

    ``item_norms`` (sum) and ``user_bias`` (concat) are independent;
    ``scores`` reads item_norms in full (the sum accumulator) and
    user_bias elementwise (its own row tile of the concat buffer) —
    every edge kind the walker supports in one super-table.
    """
    if n_users % tile:
        raise ValueError(f"n_users={n_users} must be a multiple of tile={tile}")
    rng = np.random.default_rng(seed)
    R = rng.uniform(0.0, 1.0, size=(n_users, n_items))
    R = (R * (rng.uniform(size=(n_users, n_items)) < density)).astype(np.float32)
    units = n_users // tile

    def item_norms_op(inputs, s, z):
        acc = None
        for t in range(s, s + z):
            v = _norms_tile(_rows(R, t, tile))
            acc = v if acc is None else acc + v
        return acc

    def user_bias_op(inputs, s, z):
        return torch.stack([_bias_tile(_rows(R, t, tile))
                            for t in range(s, s + z)])

    def scores_op(inputs, s, z):
        norms = torch.as_tensor(inputs["item_norms"])
        return torch.stack([
            _scores_tile(_rows(R, t, tile), norms,
                         torch.as_tensor(inputs["user_bias"][t]))
            for t in range(s, s + z)
        ])

    dag = PipelineDAG([
        Stage("item_norms", units, item_norms_op, combine="sum"),
        Stage("user_bias", units, user_bias_op, combine="concat"),
        Stage("scores", units, scores_op, combine="concat",
              deps=(StageDep("item_norms", DEP_FULL),
                    StageDep("user_bias", DEP_ELEMENTWISE))),
    ])

    def item_norms_body(ctx, ins, out):
        out += _norms_tile(ins["R"])

    def user_bias_body(ctx, ins, out):
        out.copy_(_bias_tile(ins["R"]))

    def scores_body(ctx, ins, out):
        out.copy_(_scores_tile(ins["R"], ins["item_norms"], ins["user_bias"]))

    stages = [
        WalkStage("item_norms", n_users, (n_items,), torch.float32, "sum",
                  item_norms_body, operands=("R",),
                  device_body="recommendation.item_norms"),
        WalkStage("user_bias", n_users, (n_users,), torch.float32, "concat",
                  user_bias_body, operands=("R",),
                  device_body="recommendation.user_bias"),
        WalkStage("scores", n_users, (n_users,), torch.int32, "concat",
                  scores_body, operands=("R",),
                  reads=(("item_norms", "full"), ("user_bias", "rows")),
                  device_body="recommendation.scores"),
    ]
    operands = [WalkOperand("R", (tile, n_items), ("row", "zero"))]
    values = {"R": torch.from_numpy(R).to(device)}
    return DeviceLowering(dag, stages, operands, values, tile)


def recommendation_device(
    n_users: int,
    n_items: int,
    tile: int = 64,
    stage_techniques: dict | str | None = None,
    density: float = 0.3,
    seed: int = 0,
    stagewise: bool = False,
    device: str | torch.device = "cuda",
):
    """The recommendation pipeline end-to-end on the walker.

    Returns (top_items, stage values, DeviceDagTables).
    """
    low = recommendation_device_lowering(n_users, n_items, tile=tile,
                                         density=density, seed=seed,
                                         device=device)
    vals, ddt = run_device_dag(low, stage_techniques, stagewise=stagewise)
    return vals["scores"], vals, ddt


# ------------------------------------------------------ CC iteration

#: per-stage techniques of the CC-iteration super-table: MFSC over the
#: skewed ``propagate`` rows, STATIC over the uniform ``changed`` count
CC_TECHNIQUES = {"propagate": "MFSC", "changed": "STATIC"}


def cc_iteration_dag(G: CSRMatrix, c_cur: np.ndarray) -> PipelineDAG:
    """One CC iteration as a two-stage host DAG.

    ``propagate`` (sparse, skewed: per-row cost ~ nnz) produces the new
    labels; ``changed`` (dense, uniform) counts label flips. The edge is
    elementwise, so convergence checking streams over completed label
    chunks instead of waiting for the propagation barrier.
    """
    n = G.n_rows
    row_nnz = G.row_nnz()

    def cost_of_range(start: int, size: int) -> float:
        return float(row_nnz[start:start + size].sum() + size)

    propagate = Stage(
        "propagate", n,
        lambda inputs, s, z: G.row_max_gather(c_cur, s, s + z),
        combine="concat", cost_of_range=cost_of_range)
    changed = Stage(
        "changed", n,
        lambda inputs, s, z: int((inputs["propagate"][s:s + z]
                                  != c_cur[s:s + z]).sum()),
        combine="sum", deps=(StageDep("propagate", DEP_ELEMENTWISE),))
    return PipelineDAG([propagate, changed])


def cc_iteration_lowering(n: int, tile_r: int = 256, tile_c: int = 1024):
    """The CC iteration as a walker super-table over a dense ``(n, n)`` G.

    Returns ``(dag, stages, operands)``: the row-unit host DAG that
    ``build_dag_tables`` freezes (tile ``tile_r``), and the walker's
    specs. ``propagate`` is a float32 concat stage with ``n // tile_c``
    inner steps over ``G (tile_r, tile_c)`` blocks (``("row", "inner")``),
    ``c_col (tile_c,)`` (``("inner",)``) and ``c_row (tile_r,)``
    (``("row",)``), running ``propagate_body``; ``changed`` is an int32
    ``(1,)`` sum stage that reads ``propagate`` by rows and counts
    ``propagate != c_row``. Values: ``G``, ``c_col`` and ``c_row`` (the
    labels, twice).
    """
    if n % tile_r or n % tile_c:
        raise ValueError(f"n={n} must be a multiple of tile_r={tile_r} and "
                         f"tile_c={tile_c}")

    def prop_body(ctx, ins, out):
        propagate_body(ctx.inner, ins["G"], ins["c_col"], ins["c_row"], out)

    def changed_body(ctx, ins, out):
        out += (ins["propagate"] != ins["c_row"]).sum().to(torch.int32)[None]

    dag = PipelineDAG([
        Stage("propagate", n, None, combine="concat"),
        Stage("changed", n, None, combine="sum",
              deps=(StageDep("propagate", DEP_ELEMENTWISE),)),
    ])
    stages = [
        WalkStage("propagate", n, (n,), torch.float32, "concat", prop_body,
                  operands=("G", "c_col", "c_row"), inner=n // tile_c,
                  device_body="cc.propagate"),
        WalkStage("changed", n, (1,), torch.int32, "sum", changed_body,
                  operands=("c_row",), reads=(("propagate", "rows"),),
                  device_body="cc.changed"),
    ]
    operands = [
        WalkOperand("G", (tile_r, tile_c), ("row", "inner")),
        WalkOperand("c_col", (tile_c,), ("inner",)),
        WalkOperand("c_row", (tile_r,), ("row",)),
    ]
    return dag, stages, operands


def cc_iteration_device(G: torch.Tensor, c: torch.Tensor, n_shards: int = 1,
                        tile_r: int = 256,
                        tile_c: int = 1024) -> dict[str, torch.Tensor]:
    """One CC iteration (``propagate`` then ``changed``) on the walker.

    ``G`` is the dense ``(n, n)`` float32 {0, 1} adjacency, ``c`` the
    labels; the walk runs on ``G``'s device, one launch per shard of the
    super-table (``CC_TECHNIQUES``, four workers). Returns
    ``{"propagate": (n,) float32 new labels, "changed": (1,) int32 flips}``.
    """
    n = G.shape[0]
    dag, stages, operands = cc_iteration_lowering(n, tile_r, tile_c)
    ddt = build_dag_tables_cached(dag, tile_r, CC_TECHNIQUES, n_shards=n_shards,
                                  n_workers=4)
    c = c.to(device=G.device, dtype=torch.float32).contiguous()
    values = {"G": G, "c_col": c, "c_row": c}
    return dag_walk_sharded(stages, operands, values, ddt.tables, tile_r)


# ------------------------------------------------ mid-flight migration

def _row_space(low: DeviceLowering, values: dict, device) -> dict:
    """Host DAG values (tile units) as walker-shaped tensors on ``device``."""
    out = {}
    for ws in low.stages:
        v = values[ws.name]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out[ws.name] = t.reshape(ws.out_shape).to(device)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_migrated(low: DeviceLowering, cut: int,
                  direction: str) -> tuple[dict, dict]:
    """Run ``low`` with one mid-flight substrate migration at chunk ``cut``.

    ``host_to_device`` starts the tile-unit DAG on the host pool
    (technique SS, one worker: the bit-equality regime), preempts after
    ``cut`` chunks, and re-lowers the checkpointed remainder onto the
    walker in one launch. ``device_to_host`` drains ``cut`` super-table
    slots on the walker in one launch, freezes the rest, and finishes on
    the host pool. On the CPU either way is bit-equal to a never-preempted
    run. Returns ``(values, seconds)``: row-space stage values on the
    lowering's device, and the seconds of the ``host`` part and the
    ``walk`` part (each ended by a device synchronise).
    """
    cfg = SchedulerConfig(technique="SS", queue_layout="CENTRALIZED",
                          n_workers=1)
    device = low.values[low.operands[0].name].device
    t0 = time.perf_counter()
    if direction == "host_to_device":
        res, ck = PreemptiveRunner(low.dag, cfg, preempt_after=cut).run()
        t1 = time.perf_counter()
        values = (_row_space(low, res.values, device) if ck is None
                  else migrate_to_device(ck, low))
        _sync(device)
        return values, {"host": t1 - t0, "walk": time.perf_counter() - t1}
    if direction == "device_to_host":
        ck, _ = run_device_prefix(low, cut)
        t1 = time.perf_counter()
        values = _row_space(low, resume_on_host(ck, low.dag, cfg).values, device)
        _sync(device)
        return values, {"walk": t1 - t0, "host": time.perf_counter() - t1}
    raise ValueError(f"unknown migration direction {direction!r}; expected "
                     "'host_to_device' or 'device_to_host'")


def linear_regression_migrated(
    num_rows: int,
    num_cols: int,
    cut: int,
    direction: str = "host_to_device",
    tile: int = 64,
    lam: float = 0.001,
    seed: int = 1,
    device: str | torch.device = "cuda",
):
    """Listing 2 with a mid-flight substrate migration at chunk ``cut``.

    Returns (beta, stage values, seconds of the host and walk parts).
    ``direction`` is ``host_to_device`` or ``device_to_host``.
    """
    low = linreg_device_lowering(num_rows, num_cols, tile=tile, lam=lam,
                                 seed=seed, device=device)
    values, seconds = _run_migrated(low, cut, direction)
    return low.finalize(values), values, seconds


def recommendation_migrated(
    n_users: int,
    n_items: int,
    cut: int,
    direction: str = "host_to_device",
    tile: int = 64,
    density: float = 0.3,
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """The recommendation pipeline with one mid-flight migration.

    Returns (top items in row space, stage values, seconds of the host
    and walk parts).
    """
    low = recommendation_device_lowering(n_users, n_items, tile=tile,
                                         density=density, seed=seed,
                                         device=device)
    values, seconds = _run_migrated(low, cut, direction)
    return values["scores"], values, seconds


# --------------------------------------- heterogeneous co-execution

def hetero_affinity_dag(n: int = 4096):
    """The transfer-heavy co-execution demo workload: opposite branch
    affinities.

    ``ingest`` feeds two independent branches — ``featurize`` is
    host-friendly, ``embed`` wants the accelerator — and ``join``
    consumes both elementwise. The transfer term is priced so that
    ping-ponging rows across the boundary is expensive: the solver must
    keep each branch substrate-resident and overlap them to win. Returns
    ``(dag, HeteroCostModel)``; the ops are placeholders (virtual-time
    replays never execute stage bodies).
    """
    from ..core.placement import HeteroCostModel, TransferModel

    def _op(inputs, s, z):
        return np.zeros(z)

    dag = PipelineDAG([
        Stage("ingest", n, _op, combine="concat"),
        Stage("featurize", n, _op, combine="concat",
              deps=(StageDep("ingest", DEP_ELEMENTWISE),)),
        Stage("embed", n, _op, combine="concat",
              deps=(StageDep("ingest", DEP_ELEMENTWISE),)),
        Stage("join", n, _op, combine="concat",
              deps=(StageDep("featurize", DEP_ELEMENTWISE),
                    StageDep("embed", DEP_ELEMENTWISE))),
    ])
    costs = HeteroCostModel(
        host={"ingest": np.full(n, 1e-7), "featurize": np.full(n, 1e-7),
              "embed": np.full(n, 1e-5), "join": np.full(n, 1e-7)},
        device={"ingest": np.full(n, 2e-7), "featurize": np.full(n, 2e-6),
                "embed": np.full(n, 1e-8), "join": np.full(n, 2e-6)},
        transfer=TransferModel(latency_s=5e-5, bytes_per_row=64.0,
                               gb_per_s=4.0))
    return dag, costs


def _run_hetero(low: DeviceLowering, config, placement, costs,
                device_speedup, n_device: int):
    """Solve a placement for ``low.dag`` (if none given) and co-execute it.

    The executor runs at tile granularity (technique pinned to ``SS`` on
    the tile-unit DAG), so sum stages fold per-tile partials in ascending
    order. The device lanes walk their runs over ``low`` on its device
    (core/hetero.py): on the CPU the values are bit-equal to the
    host-only ``PipelineExecutor(technique="SS", n_workers=1)`` run
    whatever the placement; on the card the walker's sums differ from it
    by rounding. Returns (values, HeteroResult, Placement).
    """
    from ..core.hetero import HeteroExecutor
    from ..core.placement import calibrate_hetero_costs, select_placement

    if placement is None:
        cm = costs if costs is not None else calibrate_hetero_costs(
            low.dag, device_speedup=device_speedup)
        placement, _, _ = select_placement(
            low.dag, cm, n_workers=config.n_workers, passes=1)
    cfg = dataclasses.replace(config, technique="SS",
                              queue_layout="CENTRALIZED")
    res = HeteroExecutor(low.dag, cfg, placement, n_device=n_device,
                         lowering=low).run()
    return res.values, res, placement


def linear_regression_hetero(
    num_rows: int,
    num_cols: int,
    config: SchedulerConfig,
    placement=None,
    costs=None,
    device_speedup: float = 4.0,
    tile: int = 64,
    n_device: int = 1,
    lam: float = 0.001,
    seed: int = 1,
    device: str | torch.device = "cuda",
):
    """Paper Listing 2 split across the host pool and device walker lanes.

    Lowers linreg for the device path (``linreg_device_lowering``, its
    data on ``device``), solves a placement with ``select_placement`` over
    calibrated per-substrate costs (unless ``placement``/``costs`` are
    given), and co-executes it with a HeteroExecutor — host chunk workers
    and ``n_device`` walker lanes sharing the DAG, the lanes walking their
    rows on ``device`` (results bit-equal to the host-only path on the
    CPU, within rounding of it on the card). Returns (beta,
    HeteroResult, Placement).
    """
    low = linreg_device_lowering(num_rows, num_cols, tile=tile, lam=lam,
                                 seed=seed, device=device)
    values, res, placement = _run_hetero(low, config, placement, costs,
                                         device_speedup, n_device)
    return low.finalize(values), res, placement


def recommendation_hetero(
    n_users: int,
    n_items: int,
    config: SchedulerConfig,
    placement=None,
    costs=None,
    device_speedup: float = 4.0,
    tile: int = 64,
    n_device: int = 1,
    density: float = 0.3,
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """The two-branch recommendation DAG split across both substrates.

    Same flow as ``linear_regression_hetero`` over the
    ``recommendation_device_lowering`` stage graph (independent branches
    can land on different substrates and overlap in real time). Returns
    (top_items, HeteroResult, Placement) — top items in row space, a
    numpy array.
    """
    low = recommendation_device_lowering(n_users, n_items, tile=tile,
                                         density=density, seed=seed,
                                         device=device)
    values, res, placement = _run_hetero(low, config, placement, costs,
                                         device_speedup, n_device)
    return np.asarray(values["scores"]).reshape(-1), res, placement
