"""The port's dense decoder stack and LM serving against the JAX package's.

Weights are the reference's own ``Model.init_params`` (jax key 0), carried
across by ``model_params_from_reference``; prompts are drawn with numpy.

Tolerance (``MODEL_TOL``): logits and cache entries agree to 4% of the
compared tensor's largest magnitude, about ten bfloat16 steps there. A
bfloat16 value carries 8 bits, and a layer rounds its activations about
ten times (projections, RoPE, attention, norms, the MLP); XLA and PyTorch
round the same operations but sum products in other orders, so an entry
can move by a step at each rounding. On the chunked path (prompts over
1,024 tokens) the reference also rounds each block's scores and p.v to
bfloat16, where K4 keeps them in float32. The largest differences seen on
these configs were under 2% of the scale.
"""

import argparse
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import make_partitioner as jmake_partitioner
from repro.models import Model as JModel
from repro.models import model as jmodel
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import serve as tserve
from repro_torch.models import (Model, count_active_params, count_params,
                                model_params_from_reference)
from repro_torch.models import model as tmodel

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["granite-8b", "yi-9b", "qwen2-0.5b", "qwen1.5-4b"]
MODEL_TOL = 0.04


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= MODEL_TOL * scale, (what, err, scale)


def _models(arch: str):
    jm, tm = JModel(jget_config(arch).reduced()), Model(get_config(arch).reduced())
    jp = jm.init_params(jax.random.key(0))
    tp = model_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# (c) prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("prompt_len", [32, 1088])
def test_prefill_and_decode_match_reference(arch, prompt_len):
    """32 tokens take the full impl, 1,088 the chunked one (K4's plain
    version); then three decode steps on the reference's tokens."""
    jm, jp, tm, tp = _models(arch)
    assert tm._impl(prompt_len) == jm._impl(prompt_len)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, prompt_len), dtype=np.int32)
    s_max = prompt_len + 4
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(2, s_max))
    cache = tm.init_cache(2, s_max, device="cpu")
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache)
    assert tc is cache and tl.dtype == torch.bfloat16
    _close(tl, jl, "prefill logits")
    for kv in ("k", "v"):
        _close(tc[kv], jc[kv], f"prefill cache {kv}")
    decode = jax.jit(jm.decode_step)
    for step in range(3):
        tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None].astype(np.int32)
        jl, jc = decode(jp, jnp.asarray(tok), jc, jnp.int32(prompt_len + step))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, prompt_len + step)
        _close(tl, jl, f"decode {step} logits")
    for kv in ("k", "v"):
        _close(tc[kv], jc[kv], f"decode cache {kv}")


def test_params_from_reference_keep_names_and_layouts():
    jm, jp, tm, tp = _models("qwen2-0.5b")
    mine = tm.init_params(torch.Generator().manual_seed(0), "cpu")
    assert sorted(tp) == sorted(mine) == ["embed", "final_norm", "layers"]  # tied
    assert len(tp["layers"]) == len(mine["layers"]) == tm.cfg.n_layers
    for got, made in zip(tp["layers"], mine["layers"]):
        assert got.keys() == made.keys()
        assert got["attn"].keys() == made["attn"].keys() >= {"bq", "bk", "bv"}
        for k in ("wq", "wk", "wv", "wo", "bq"):
            assert got["attn"][k].shape == made["attn"][k].shape
    np.testing.assert_array_equal(tp["layers"][1]["mlp"]["wi"].numpy(),
                                  np.asarray(jp["layers"]["mlp"]["wi"][1]))


def test_mask_vocab_padding():
    x = np.linspace(-1, 1, 2 * 70, dtype=np.float32).reshape(2, 70)
    got = tmodel.mask_vocab_padding(torch.from_numpy(x), 64)
    want = jmodel.mask_vocab_padding(jnp.asarray(x), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# (d) serve_lm on the CPU against the reference's loop
# ---------------------------------------------------------------------------

def _serve_args(**kw):
    base = dict(arch="granite-8b", smoke=True, requests=5, slots=2, prompt_len=32,
                gen_len=4, technique="GSS", device="cpu")
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("prompt_len", [32, 1088])
def test_serve_lm_matches_reference_loop(prompt_len, capsys):
    """The port's loop on the reference's weights: the same chunks and
    slot batches, and at every step logits within MODEL_TOL of the
    reference's prefill / decode fed the port's tokens (teacher forcing)."""
    args = _serve_args(prompt_len=prompt_len)
    jm, jp, _, tp = _models(args.arch)
    res = tserve.serve_lm(args, params=tp)
    assert "[serve] 5 requests x 4 tokens" in capsys.readouterr().out
    # the reference's chunks (next_chunk() or 1), padded to the slots
    part = jmake_partitioner(args.technique, args.requests, args.slots)
    batches, served = [], 0
    while served < args.requests:
        n = min(part.next_chunk() or 1, args.requests - served)
        reqs = list(range(served, served + n))
        served += n
        reqs += [reqs[-1]] * ((-len(reqs)) % args.slots)
        batches += [reqs[i:i + args.slots] for i in range(0, len(reqs), args.slots)]
    assert res.requests == batches
    rng = np.random.default_rng(0)
    prompts = np.stack([rng.integers(0, jm.cfg.vocab_size, prompt_len, dtype=np.int32)
                        for _ in range(args.requests)])
    np.testing.assert_array_equal(res.prompts, prompts)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    for rows, toks, logits in zip(res.requests, res.tokens, res.logits):
        assert toks.shape == (args.slots, args.gen_len)
        assert torch.equal(toks, logits.float().argmax(-1))
        jl, jc = prefill(jp, {"tokens": jnp.asarray(prompts[rows])},
                         jm.init_cache(len(rows), prompt_len + args.gen_len))
        _close(logits[:, 0], jl[:, -1], "prefill logits")
        for t in range(args.gen_len - 1):
            tok = jnp.asarray(toks[:, t:t + 1].numpy().astype(np.int32))
            jl, jc = decode(jp, tok, jc, jnp.int32(prompt_len + t))
            _close(logits[:, t + 1], jl[:, 0], f"decode {t} logits")
    assert res.prefill_seconds > 0 and res.decode_seconds > 0


def test_serve_main_on_the_cpu(capsys):
    tserve.main(["--smoke", "--device", "cpu", "--requests", "3", "--gen-len", "2"])
    assert "[serve] 3 requests x 2 tokens" in capsys.readouterr().out
    # --mode pipelines and openloop run on the host (tests/test_torch_server.py,
    # tests/test_torch_admission.py): a short open-loop replay
    runs = tserve.main(["--mode", "openloop", "--device", "cpu", "--requests", "120"])
    assert list(runs) == ["fifo baseline", "front door"]
    assert runs["front door"].n_jobs == 120
    assert "[serve:openloop] front door: p50=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (e) parameter counts
# ---------------------------------------------------------------------------

RECURRENT = {"rwkv6-3b": 3_073_477_120, "zamba2-7b": 6_751_130_832}
#: (all, active) parameters: routed experts count top_k / E of theirs
MOE = {"qwen2-moe-a2.7b": (14_316_259_328, 2_689_648_640),
       "deepseek-v2-lite-16b": (15_706_484_224, 2_661_150_208)}
#: Whisper's encoder-decoder and InternVL2's vision frontend (with its
#: 48 layers: 79.48 GB of fp32 weights)
FRONTENDS = {"whisper-small": 278_373_120, "internvl2-26b": 19_869_020_160}


@pytest.mark.parametrize("arch", DENSE + sorted(RECURRENT) + sorted(MOE) + sorted(FRONTENDS))
def test_param_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert count_params(cfg) == jmodel.count_params(jcfg) == cfg.param_count()
    assert count_active_params(cfg) == jmodel.count_active_params(jcfg)
    assert count_params(cfg.reduced()) == jmodel.count_params(jcfg.reduced())
    assert count_active_params(cfg.reduced()) == jmodel.count_active_params(jcfg.reduced())
    if arch in RECURRENT:  # the reference's counts, as the configs cite them
        assert count_params(cfg) == count_active_params(cfg) == RECURRENT[arch]
    if arch in MOE:
        assert (count_params(cfg), count_active_params(cfg)) == MOE[arch]
    if arch in FRONTENDS:
        assert count_params(cfg) == count_active_params(cfg) == FRONTENDS[arch]
        assert set(list_configs()) == set(DENSE) | set(RECURRENT) | set(MOE) | set(FRONTENDS)


# ---------------------------------------------------------------------------
# (g) the import guard covers the new modules
# ---------------------------------------------------------------------------

_GUARD = textwrap.dedent("""
    import importlib, importlib.abc, sys, argparse

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    torch.set_num_threads(1)   # the suite's workers fill the cores: no oversubscription
    from repro_torch.kernels.ops import attention, mamba2_chunk_scan, wkv6
    from repro_torch.launch.serve import serve_lm
    from repro_torch.vee import apps
    from repro_torch.vee.sparse import rmat_graph
    res = serve_lm(argparse.Namespace(arch="yi-9b", smoke=True, requests=2, slots=2,
                                      prompt_len=1088, gen_len=2, technique="GSS",
                                      device="cpu"))
    assert res.tokens[0].shape == (2, 2)
    g = rmat_graph(scale=8)
    G = torch.from_numpy(g.to_dense())
    out = apps.cc_iteration_device(G, torch.arange(1, 257.0), tile_r=64,
                                   tile_c=128, n_shards=2)
    assert out["propagate"].shape == (256,)
    assert attention(*[torch.ones(1, 2, 8, 16)] * 3).shape == (1, 2, 8, 16)
    for arch in ("rwkv6-3b", "zamba2-7b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b"):
        res = serve_lm(argparse.Namespace(arch=arch, smoke=True, requests=2, slots=2,
                                          prompt_len=16, gen_len=2, technique="GSS",
                                          device="cpu"))
        assert res.tokens[0].shape == (2, 2)
    x = torch.ones(1, 8, 2, 16)
    assert mamba2_chunk_scan(x, torch.ones(1, 8, 2), -torch.ones(2), x[:, :, 0],
                             x[:, :, 0], torch.ones(2), chunk=4).shape == (1, 8, 2, 16)
    assert wkv6(*[torch.ones(1, 2, 8, 16)] * 3, -torch.ones(1, 2, 8, 16),
                torch.ones(2, 16), chunk=4).shape == (1, 2, 8, 16)
    import tempfile
    from repro_torch.launch.train import main as train_main
    with tempfile.TemporaryDirectory() as ckpt_dir:
        run = train_main(["--smoke", "--device", "cpu", "--arch", "qwen2-0.5b",
                          "--seq", "1088", "--global-batch", "2", "--steps", "1",
                          "--ckpt-dir", ckpt_dir, "--checkpoint-every", "1"])
    assert run.report.steps_run == 1 and run.metrics[0]["loss"] > 0
    for m in ("models.attention", "models.blocks", "models.model", "launch.serve",
              "kernels.flash_attention", "kernels.ops", "vee.sparse", "models.rwkv",
              "models.ssm", "kernels.rwkv6_scan", "kernels.ssm_scan", "models.moe",
              "launch.train", "optim.adamw", "runtime.steps", "runtime.fault",
              "checkpoint.checkpoint", "data.pipeline"):
        assert f"repro_torch.{m}" in sys.modules, m
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    print("ok")
""")


def test_new_modules_import_and_run_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _GUARD], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_flash_attention_source_calls_no_library():
    """K4 is written by hand: its source names no library attention."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu").read_text()
    for word in ("scaled_dot_product_attention", "cudnn", "cublas", "cutlass", "torch"):
        assert word not in src.lower(), word


def test_flash_attention_bwd_source_calls_no_library():
    """K4's backward is written by hand: its source names no library."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu").read_text()
    for word in ("scaled_dot_product_attention", "cudnn", "cublas", "cutlass", "torch",
                 "triton"):
        assert word not in src.lower(), word


@pytest.mark.parametrize("source", ["ssm_scan.cu", "rwkv6_scan.cu", "dag_walk.cu"])
def test_scan_sources_call_no_library(source):
    """K5, K6 and the walker (K1, K3) are written by hand: their sources
    name no library."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / source).read_text()
    for word in ("cudnn", "cublas", "cutlass", "torch", "triton"):
        assert word not in src.lower(), word
