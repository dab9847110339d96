"""Model-zoo lowerings on DaphneSched: MoE expert dispatch, one dense LM
step and a two-model serving pair (the port of ``vee/ml_apps.py``).

``moe_dispatch_lowering`` lowers one MoE layer's expert dispatch into an
irregular fan-out pipeline: ``route`` (rows = tokens; per-token top-k over
the router) -> ``experts`` (rows = experts; each row scatters its kept
tokens into a fixed-capacity slab and runs the gated FFN, and its cost is
the router's token count, so chunk costs carry the skew) -> ``combine``
(rows = tokens; weighted gather honouring capacity drops).
``moe_device_lowering`` lowers the ``experts`` fan-out for the walker: one
``concat`` stage over ``E * C`` rows with tile ``C``, one slab a slot,
drained by the walker's MoE program (``csrc/dag_walk.cu``) in one launch.

Bit-equality contract, as in the reference: every stage is a row stage
whose per-row function has a fixed shape, so scheduled and direct host
runs are bit-equal under any technique, and the plain walker's slab body
is the host op's own ``expert_tile``, so on the CPU the plain walk equals
the host ``experts`` stage bit for bit. The CUDA body sums in another order
(see the kernel's source note); ``chip_smoke.py`` states its tolerance.

Host DAG ops run on the CPU, whatever device the weights lie on (they copy
the weights to the host on first use); the walker's values lie on the
lowering's device.

``transformer_step_lowering`` lowers one inference step of a dense LM
(embed -> N x block -> head over the batch rows) whose per-row functions
run the port's model on the lowering's device, and ``serving_pair``
serves two such lowerings, placed across substrates on their transfer
costs, on one ``PipelineServer`` pool.
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import get_config
from ..configs.base import ArchConfig
from ..core.dag import DEP_FULL, PipelineDAG, Stage, StageDep
from ..core.lower import (Lowered, chain_dag, costs_from_sizes, fanout_stage,
                          measure_stage_costs)
from ..kernels.dag_walk import WalkOperand, WalkStage
from ..models import blocks
from ..models.model import Model
from ..models.moe import NEG_INF, init_moe, top_k
from .apps import DeviceLowering

__all__ = [
    "transformer_step_lowering", "skewed_tokens", "moe_dispatch_lowering",
    "moe_dispatch_lowering_for", "moe_device_lowering",
    "moe_params_from_reference", "expert_tile", "serving_pair",
]


# ---------------------------------------------------------------------------
# (a) transformer inference step: embed -> N x block -> head over the batch
# ---------------------------------------------------------------------------

def transformer_step_lowering(
    arch: str = "qwen2-0.5b",
    batch: int = 8,
    seq: int = 12,
    seed: int = 0,
    params: dict | None = None,
    tokens=None,
    device: str | torch.device = "cuda",
) -> Lowered:
    """Lower one inference step of a dense LM into a streamed stage chain.

    Rows are batch elements. Stage ``embed`` turns a token row into
    ``(seq, d)`` activations, ``block{l}`` applies layer ``l``, ``head``
    produces last-position logits ``(padded vocab,)``. Each per-row
    function runs the model's own components on one row (batch 1, fixed
    shapes) on ``device``; activations cross stage boundaries as float32
    numpy rows (bf16 -> f32 -> bf16 round-trips exactly), as in the
    reference, so the lowered step is bit-equal to the direct
    (unscheduled) composition of the same functions on the same device.

    The config is ``get_config(arch).reduced()``, dense archs only.
    ``params`` (the reference's, through ``model_params_from_reference``)
    and ``tokens`` (``(batch, seq)`` int32) replace the weights and prompt
    drawn from a ``torch.Generator`` on ``device`` seeded by ``seed``.
    """
    cfg = get_config(arch).reduced()
    if cfg.family != "dense":
        raise ValueError(f"transformer_step_lowering needs a dense arch, "
                         f"got {arch!r} ({cfg.family})")
    device = torch.device(device)
    model = Model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if params is None:
        params = model.init_params(gen, device)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                               device=device, dtype=torch.int32)
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    tokens = np.array(tokens, np.int32)
    if tokens.shape != (batch, seq):
        raise ValueError(f"tokens of shape {tokens.shape}, expected "
                         f"{(batch, seq)}")
    positions = torch.arange(seq, device=device)

    def _row(x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x)).to(device)

    def _embed1(tok):
        x = model._embed_inputs(params, {"tokens": _row(tok)[None]})
        return x[0].float().cpu().numpy()

    def _make_block(layer):
        lp = params["layers"][layer]

        def _block1(x):
            y, _, _ = blocks.apply_dense_layer(
                lp, _row(x).to(torch.bfloat16)[None], cfg, positions=positions,
                impl="full", cache=None, cache_index=None)
            return y[0].float().cpu().numpy()
        return _block1

    def _head1(x):
        logits = model._logits(params, _row(x).to(torch.bfloat16)[None, -1:])
        return logits[0, 0].float().cpu().numpy()

    steps = [("embed", lambda _prev, r: _embed1(tokens[r]))]
    for layer in range(cfg.n_layers):
        steps.append((f"block{layer}",
                      lambda prev, _r, _bf=_make_block(layer): _bf(prev)))
    steps.append(("head", lambda prev, _r: _head1(prev)))

    dag = chain_dag(batch, steps)
    stage_costs = {"embed": np.full(batch, 1.0), "head": np.full(batch, 2.0)}
    for layer in range(cfg.n_layers):
        stage_costs[f"block{layer}"] = np.full(batch, 4.0)

    def finalize(values):
        return np.asarray(values["head"])  # (batch, vocab_padded) f32

    return Lowered(dag, stage_costs, finalize,
                   meta={"model": model, "params": params, "tokens": tokens,
                         "cfg": cfg, "arch": arch, "seq": seq,
                         "device": device})


def skewed_tokens(router_w: np.ndarray, n_tokens: int, skew: float = 1.2,
                  seed: int = 0) -> np.ndarray:
    """Token activations whose router logits prefer a Zipf-skewed expert.

    Each token is a noisy multiple of the router column of its target
    expert, with targets drawn from ``p_e ∝ 1/(e+1)^skew`` — the
    imbalanced token-to-expert distribution that makes expert chunk
    costs non-uniform. numpy, seeded: the reference's draws exactly.
    """
    rng = np.random.default_rng(seed)
    d, e = router_w.shape
    p = 1.0 / np.arange(1, e + 1, dtype=np.float64) ** skew
    p /= p.sum()
    targets = rng.choice(e, size=n_tokens, p=p)
    cols = router_w[:, targets].T                      # (T, d)
    norms = np.linalg.norm(cols, axis=1, keepdims=True)
    cols = cols / np.maximum(norms, 1e-6)
    x = 3.0 * cols + 0.1 * rng.standard_normal((n_tokens, d))
    return x.astype(np.float32)


def _dispatch_plan(route_out: np.ndarray, n_experts: int, capacity: int):
    """Routing plan from packed route rows ``[idx_k..., w_k...]``.

    Replicates models/moe.py's capacity semantics exactly: position
    within an expert counts over the flattened ``(T*k)`` t-major order,
    and a slot is kept iff its position is below capacity. Returns
    ``(idx (T,k) int, w (T,k) f32, pos (T,k) int, kept (E,) int)`` with
    ``pos = -1`` for dropped slots.
    """
    k = route_out.shape[1] // 2
    idx = route_out[:, :k].astype(np.int64)
    w = route_out[:, k:].astype(np.float32)
    flat = idx.reshape(-1)
    pos = np.zeros(flat.size, np.int64)
    for e in range(n_experts):
        m = flat == e
        pos[m] = np.arange(m.sum())
    keep = pos < capacity
    pos = np.where(keep, pos, -1).reshape(idx.shape)
    kept = np.bincount(flat[keep], minlength=n_experts)
    return idx, w, pos, kept


def expert_tile(buf: torch.Tensor, wi: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """Gated expert FFN on a fixed-capacity slab, in plain PyTorch.

    ``buf (C, d)``, ``wi (d, 2f)``, ``wo (f, d)``. Matrix products are
    broadcast-multiply + ``sum(dim=1)``, as the reference writes them, so
    the host op and the plain walker body compute the same bits. The
    temporary is ``C * d * 2f`` floats: at full width a host run is for
    the card only.
    """
    h = (buf[:, :, None] * wi[None]).sum(dim=1)        # (C, 2f)
    g, u = torch.chunk(h, 2, dim=-1)
    h = F.silu(g) * u
    return (h[:, :, None] * wo[None]).sum(dim=1)       # (C, d)


def moe_params_from_reference(tree, device: str | torch.device = "cuda") -> dict:
    """The reference's ``init_moe`` tree (arrays as numpy) as the port's
    tensors on ``device``: ``router``, ``experts.wi``, ``experts.wo`` and
    ``shared``, same layout, copied (JAX hands out read-only buffers)."""
    if isinstance(tree, dict):
        return {k: moe_params_from_reference(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def _tree_to(tree, device: torch.device):
    """A params tree with every tensor moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _rows_op(fn):
    """Chunk op mapping ``fn(inputs, r)`` over rows (deps pass through)."""
    def op(inputs, s, z):
        return np.stack([np.asarray(fn(inputs, r)) for r in range(s, s + z)])
    return op


def _combine(out: torch.Tensor, idx: np.ndarray, w: np.ndarray,
             pos: np.ndarray, capacity: int) -> torch.Tensor:
    """Token-side combine of expert slabs ``out (E*C, d)``: for each token,
    ``y = 0 + w_0 * out[slot_0] + w_1 * out[slot_1] ...`` over its kept
    slots in k order — the reference's per-token loop, one k at a time over
    all tokens (the same IEEE operations per element)."""
    dev = out.device
    t, k = idx.shape
    y = torch.zeros((t, out.shape[1]), dtype=out.dtype, device=dev)
    for j in range(k):
        keep = torch.from_numpy(pos[:, j] >= 0).to(dev)
        rows = torch.from_numpy(idx[:, j] * capacity
                                + np.maximum(pos[:, j], 0)).to(dev)
        wj = torch.from_numpy(np.ascontiguousarray(w[:, j:j + 1])).to(dev)
        y = torch.where(keep[:, None], y + wj * out[rows], y)
    return y


def moe_dispatch_lowering_for(
    cfg: ArchConfig,
    n_tokens: int = 96,
    skew: float = 1.2,
    seed: int = 0,
    n_experts: int | None = None,
    capacity_factor: float | None = None,
    params: dict | None = None,
    device: str | torch.device = "cuda",
) -> Lowered:
    """``moe_dispatch_lowering`` for any MoE ``ArchConfig`` (full or reduced).

    Weights are ``params`` (moved to ``device``) or ``init_moe`` drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device``; tokens come
    from ``skewed_tokens`` over the router. Routing, the capacity plan and
    the host DAG ops run on the CPU.
    """
    moe = cfg.moe
    if moe is None:
        raise ValueError(f"{cfg.name!r} has no MoE config")
    if n_experts is not None:
        moe = dataclasses.replace(moe, n_routed=n_experts, n_routed_padded=0)
    if capacity_factor is not None:
        moe = dataclasses.replace(moe, capacity_factor=capacity_factor)
    d = cfg.d_model
    e = moe.n_routed_padded or moe.n_routed
    k = moe.top_k
    f = moe.d_ff_expert
    device = torch.device(device)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = init_moe(gen, d, moe, device=device)
    else:
        params = _tree_to(params, device)
    shapes = {"router": (d, e), "wi": (e, d, 2 * f), "wo": (e, f, d)}
    got = {"router": params["router"].shape, "wi": params["experts"]["wi"].shape,
           "wo": params["experts"]["wo"].shape}
    for name, shape in shapes.items():
        if tuple(got[name]) != shape:
            raise ValueError(f"params {name!r} is {tuple(got[name])}, the "
                             f"config needs {shape}")
    router_w = params["router"].detach().cpu().numpy().astype(np.float32)
    x_flat = skewed_tokens(router_w, n_tokens, skew=skew, seed=seed)
    cap = max(1, int(math.ceil(k * n_tokens * moe.capacity_factor / e)))

    router = torch.from_numpy(router_w)
    routed = moe.n_routed
    padding = torch.arange(e) >= routed

    def route_fn(_ins, r):
        xt = torch.from_numpy(x_flat[r])
        logits = (xt[:, None] * router).sum(dim=0)      # (e,) mul-reduce
        if e > routed:
            logits = torch.where(padding, torch.full_like(logits, NEG_INF), logits)
        p = torch.softmax(logits, dim=0)
        w, idx = top_k(p, k)
        w = w / torch.clamp(w.sum(), min=1e-9)
        return torch.cat([idx.to(torch.float32), w])

    host, lock = {}, threading.Lock()

    def host_weights():
        """The expert weights on the CPU, copied once (pool threads share it)."""
        with lock:
            if not host:
                host["wi"] = params["experts"]["wi"].detach().cpu()
                host["wo"] = params["experts"]["wo"].detach().cpu()
        return host["wi"], host["wo"]

    def expert_fn(ins, g):
        idx, _w, pos, _kept = _dispatch_plan(np.asarray(ins["route"]), e, cap)
        buf = np.zeros((cap, d), np.float32)
        t_sel, k_sel = np.nonzero((idx == g) & (pos >= 0))
        buf[pos[t_sel, k_sel]] = x_flat[t_sel]
        wi, wo = host_weights()
        return expert_tile(torch.from_numpy(buf), wi[g], wo[g])

    def combine_fn(ins, t):
        idx, w, pos, _kept = _dispatch_plan(np.asarray(ins["route"]), e, cap)
        out = np.asarray(ins["experts"])                # (e, cap, d)
        y = np.zeros(d, np.float32)
        for j in range(k):
            if pos[t, j] >= 0:
                y = y + w[t, j] * out[idx[t, j], pos[t, j]]
        return y

    # routing is known at build time (the same per-token function the
    # scheduled route stage runs): per-expert counts size the fan-out
    route_build = _rows_op(route_fn)(None, 0, n_tokens)
    _, _, _, kept = _dispatch_plan(route_build, e, cap)

    route = Stage("route", n_tokens, _rows_op(route_fn), combine="concat")
    experts = fanout_stage("experts", expert_fn, kept,
                           deps=(StageDep("route", DEP_FULL),))
    combine = Stage("combine", n_tokens, _rows_op(combine_fn),
                    combine="concat",
                    deps=(StageDep("route", DEP_FULL),
                          StageDep("experts", DEP_FULL)))
    dag = PipelineDAG([route, experts, combine])

    stage_costs = {
        "route": np.full(n_tokens, 1.0),
        "experts": costs_from_sizes(kept, per_unit=1.0, base=1.0),
        "combine": np.full(n_tokens, 1.0),
    }

    def finalize(values):
        return np.asarray(values["combine"])            # (T, d) f32

    return Lowered(dag, stage_costs, finalize,
                   meta={"params": params, "moe": moe, "cfg": cfg,
                         "x_flat": x_flat, "capacity": cap, "n_experts": e,
                         "expert_tokens": kept, "route_build": route_build,
                         "d_model": d, "host_weights": host_weights})


def moe_dispatch_lowering(
    arch: str = "qwen2-moe-a2.7b",
    n_tokens: int = 96,
    skew: float = 1.2,
    seed: int = 0,
    n_experts: int | None = None,
    capacity_factor: float | None = None,
    params: dict | None = None,
    device: str | torch.device = "cuda",
) -> Lowered:
    """Lower MoE expert dispatch of ``arch`` at its reduced widths.

    Stages ``route`` -> ``experts`` -> ``combine`` (see the module
    docstring). ``meta['expert_tokens']`` holds the kept counts;
    ``stage_costs['experts']`` is the matching per-row cost vector.
    ``params`` (the reference's weights through
    ``moe_params_from_reference``) replaces the seeded ``init_moe``.
    """
    return moe_dispatch_lowering_for(
        get_config(arch).reduced(), n_tokens=n_tokens, skew=skew, seed=seed,
        n_experts=n_experts, capacity_factor=capacity_factor, params=params,
        device=device)


def moe_device_lowering(low: Lowered) -> DeviceLowering:
    """The MoE ``experts`` fan-out lowered for the walker.

    One WalkStage over ``E * capacity`` rows with ``tile = capacity``:
    each slot is one expert's slab. The dispatch buffer is built on the
    host from the build-time routing plan and copied to the weights'
    device. Unlike the reference, which repeats each expert's weights
    ``capacity`` times along the rows so a ``row`` block index selects
    expert ``start // capacity``, ``wi (E, d, 2f)`` and ``wo (E, f, d)``
    are passed once with the ``tile`` block index, which selects the same
    slab. The plain body runs the host op's ``expert_tile``; ``finalize``
    applies the token-side combine to the walk's slabs on their device and
    returns the ``(T, d)`` tensor there.
    """
    meta = low.meta
    e, cap, d = meta["n_experts"], meta["capacity"], meta["d_model"]
    x_flat = meta["x_flat"]
    idx, w, pos, _kept = _dispatch_plan(meta["route_build"], e, cap)

    xdisp = np.zeros((e * cap, d), np.float32)
    t_sel, k_sel = np.nonzero(pos >= 0)
    xdisp[idx[t_sel, k_sel] * cap + pos[t_sel, k_sel]] = x_flat[t_sel]

    wi = meta["params"]["experts"]["wi"].contiguous()     # (E, d, 2f)
    wo = meta["params"]["experts"]["wo"].contiguous()     # (E, f, d)
    f = wo.shape[1]
    host_xdisp = torch.from_numpy(xdisp)

    def experts_tile_op(inputs, s, z):
        hwi, hwo = meta["host_weights"]()
        return torch.stack([
            expert_tile(host_xdisp[g * cap:(g + 1) * cap], hwi[g], hwo[g])
            for g in range(s, s + z)])                  # (z, cap, d)

    dag = PipelineDAG([Stage("experts", e, experts_tile_op, combine="concat")])

    def experts_body(ctx, ins, out):
        out.copy_(expert_tile(ins["xdisp"], ins["wi"][0], ins["wo"][0]))

    stages = [WalkStage("experts", e * cap, (e * cap, d), torch.float32,
                        "concat", experts_body,
                        operands=("xdisp", "wi", "wo"),
                        device_body="moe.experts")]
    operands = [
        WalkOperand("xdisp", (cap, d), ("row", "zero")),
        WalkOperand("wi", (1, d, 2 * f), ("tile", "zero", "zero")),
        WalkOperand("wo", (1, f, d), ("tile", "zero", "zero")),
    ]
    values = {"xdisp": host_xdisp.to(wi.device), "wi": wi, "wo": wo}

    def finalize(stage_values: dict) -> torch.Tensor:
        return _combine(stage_values["experts"], idx, w, pos, cap)

    return DeviceLowering(dag, stages, operands, values, cap, finalize)


# ---------------------------------------------------------------------------
# (c) two-model serving pair: Submissions + placement on real costs
# ---------------------------------------------------------------------------

def serving_pair(
    archs: tuple[str, str] = ("qwen2-0.5b", "granite-8b"),
    batch: int = 4,
    seq: int = 8,
    seed: int = 0,
    n_workers: int = 2,
    n_device: int = 1,
    device_speedup: float = 4.0,
    measured: bool = False,
    params: dict | None = None,
    tokens: dict | None = None,
    device: str | torch.device = "cuda",
):
    """Serve two models' transformer steps through one shared pool.

    Builds a ``transformer_step_lowering`` per arch on ``device`` (arch
    ``i`` seeded ``seed + i``; ``params`` / ``tokens``, dicts by arch,
    replace its draws), derives hetero cost models — host costs measured
    from the real stage ops when ``measured`` (virtual otherwise), device
    costs scaled by ``device_speedup``, and a ``TransferModel`` fed the
    REAL activation byte sizes each edge moves (``seq * d_model * 4``
    bytes per row; ``vocab * 4`` for the head) — solves placement per
    model, and serves both submissions on one ``PipelineServer`` pool of
    ``n_workers`` host workers and ``n_device`` lanes. The submissions
    carry no lowering for the walker, so a lane runs the stage's own row
    functions. Returns ``(results, subs, placements, lows)`` where
    ``results[arch]`` is the finalized logits, which the caller holds
    bit-equal to ``lows[i].run_direct()``.
    """
    from ..core.placement import HeteroCostModel, TransferModel, select_placement
    from ..core.registry import make_config
    from ..core.server import PipelineServer

    lows, subs, placements = [], [], {}
    for i, arch in enumerate(archs):
        low = transformer_step_lowering(
            arch, batch=batch, seq=seq, seed=seed + i,
            params=(params or {}).get(arch), tokens=(tokens or {}).get(arch),
            device=device)
        cfg = low.meta["cfg"]
        host = (measure_stage_costs(low.dag, sample=2) if measured
                else {k: v.astype(np.float64) for k, v in low.stage_costs.items()})
        dev_costs = {k: v / device_speedup for k, v in host.items()}
        bytes_per_row = {name: float(seq * cfg.d_model * 4)
                         for name in low.dag.stage_names}
        bytes_per_row["head"] = float(cfg.vocab_size * 4)
        costs = HeteroCostModel(host=host, device=dev_costs,
                                transfer=TransferModel(bytes_per_row=bytes_per_row))
        pl, _het_ms, _pure = select_placement(low.dag, costs, n_workers)
        placements[arch] = pl
        lows.append(low)
        subs.append(low.submission(name=arch, tenant=arch, placement=pl,
                                   stage_costs=host))

    server = PipelineServer(make_config("gss/percore", n_workers=n_workers),
                            arbiter="fair", n_device=n_device)
    served = server.serve(subs)
    results = {arch: low.value(served.jobs[arch].values)
               for arch, low in zip(archs, lows)}
    return results, subs, placements, lows
