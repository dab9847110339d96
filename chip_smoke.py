#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main path on the card — the paper's IDA pipelines on the
super-table walker kernel and the DLS-scheduled CC step — at real sizes:

* linear regression, 1,000,000 rows x 101 columns (the repo's Fig. 10 size);
* recommendation, 65,536 users x 2,048 items at density 0.3;
* one CC propagation step on the dense scale-14 RMAT graph (n = 16,384);
* MoE expert dispatch at Qwen1.5-MoE-A2.7B's full widths (60 routed experts,
  top-4, d_model 2,048, d_ff_expert 1,408, capacity factor 1.25) over 4,096
  tokens (skew 1.2, seed 0): 60 slabs of capacity 342;
* front-door batches of 8 members (``BatchPolicy.max_batch``): linreg
  8 x (131,072 x 101) and recommendation 8 x (8,192 x 2,048), seeds 1-8;
* one CC iteration (``propagate`` -> ``changed``) on the walker's
  CC-iteration program over the same n = 16,384 graph, tiles 256 x 1,024
  (16 inner steps a slot), on 1 and 2 shards;
* the paper's own host entry points beside the card: Listing 2
  (``linear_regression``) on the VEE's host pool at 1,000,000 x 101,
  Listing 1 (``connected_components``) over the scale-14 CSR graph against
  a loop of ``cc_iteration_device`` on the card, the device tuner's and
  persistent re-balancing's CC tables (tile 256, 2 shards) walked on the
  card, the simulator's fused and sequential makespans of the linreg table
  beside the measured walks, and the coordinator (2 nodes x 4 workers,
  then one node killed);
* telemetry and the multi-tenant server beside the card: the linreg
  walk's stamps as device spans with their critical path, the linreg
  pipeline co-executed at 1,000,000 x 101 by 8 host workers and a device
  lane (``linear_regression_hetero``), ``serve --mode pipelines
  --compare`` on 8 workers with a trace and metrics, and a linreg job of
  131,072 x 101 placed on the device lane of a shared server;
* the serving front door beside the card: ``serve --mode openloop`` on 8
  workers (800 heavy-tailed arrivals at load 1.5, FIFO against admission,
  a token bucket and batching), 400 arrivals at load 5.0 under fair and
  preemptive arbitration, ``FrontDoor`` over 8 host workers and a walker
  lane serving the launcher's mixed set with the 1,000,000 x 101 linreg
  job placed on the lane, the hetero and server tuners on the walker's
  measured stage costs, and ``serving_pair`` (Qwen2-0.5B and Granite-8B
  at their reduced widths, one inference step each) on the card;
* LM serving of Granite-8B at full size (36 layers, d_model 4,096, 32 heads
  over 8 kv heads, d_ff 14,336, vocab 49,152; 33.0 GB of fp32 weights drawn
  on the card): 8 requests of 2,048 tokens in GSS chunks over 4 slots, 16
  tokens each, its prefill attention through K4 (flash attention);
* LM serving of RWKV6-3B (32 layers, d_model 2,560, 40 WKV heads x 64,
  d_ff 8,960, vocab 65,536; 3.07 B parameters, 12.3 GB fp32) and of
  Zamba2-7B (81 Mamba2 layers in 13 super-blocks of 6, each followed by
  the shared attention block, then 3 tail layers; d_model 3,584, 112 SSM
  heads x 64, d_state 64, shared attention 32 heads x 112; 6.75 B
  parameters, 27.0 GB fp32), each at full size with Granite's traffic,
  their prefills through K6 (rwkv6_scan) and K5 (ssm_scan) and K4 at
  dh 112;
* LM serving of Qwen1.5-MoE-A2.7B (24 layers of MHA, 16 heads x 128, and
  an MoE block of 60 routed experts, top-4, d_ff_expert 1,408, plus 4
  shared; vocab 151,936; 14.32 B parameters, 57.27 GB fp32) and of
  DeepSeek-V2-Lite (27 layers of MLA, 16 heads, q and k 192, v 128, kv
  rank 512; layer 0 a dense FFN of 10,944, layers 1-26 MoE of 64 routed
  experts, top-6, plus 2 shared; vocab 102,400; 15.71 B parameters, 62.83
  GB fp32), each at full size with Granite's traffic, after Zamba2's with
  everything before freed, their prefill attention through K4 at (128,
  128) and at MLA's (192, 128);
* serving of the two frontend families through ``Model.prefill`` and
  ``Model.decode_step`` (the serving loop gives token prompts only):
  Whisper-small at full size (12 encoder and 12 decoder layers, d_model
  768, 12 heads x 64, d_ff 3,072, vocab 51,865; 278,373,120 parameters),
  8 requests of 1,500 stub frames each, a 4-token decoder prompt and 60
  new tokens, then 4 with a 2,048-token decoder prompt, K4 on the
  encoder (non-causal, 1,500 keys) and on the long prompt's self and
  cross attention (2,048 queries against 1,500 keys); and InternVL2-26B
  at full width (d_model 6,144, 48 heads over 8 kv heads x 128, d_ff
  16,384, vocab 92,553) with its depth cut from 48 layers to 32
  (13,627,699,200 parameters, 54.51 GB fp32), Granite's traffic with
  each prompt's first 256 positions patch embeddings, K4 at group 6;
* training of Qwen2-0.5B at full width (24 layers, d_model 896, 14 heads
  over 2 kv heads of 64, d_ff 4,864, vocab 151,936, tied embeddings;
  494,147,456 parameters, fp32 master weights with AdamW's two moments)
  through ``python -m repro_torch.launch.train``: 8 x 2,048 tokens a step
  packed by the DaphneSched data pipeline, remat "full", the attention's
  forward and gradient through K4's forward and backward kernels, 3 steps,
  a checkpoint written, restored bitwise and resumed from, in a temporary
  directory deleted afterwards;
* training of RWKV6-3B at full width and depth (3,073,477,120 parameters)
  through the launcher, 4 x 2,048 tokens a step, 3 steps, a checkpoint of
  its 36.9 GB of weights and moments restored bitwise on the card, one
  resumed step; and of Zamba2-7B at full width with its depth cut from 81
  layers to 18 (three super-blocks; 1,838,512,800 parameters: all 81
  layers' fp32 weights, gradients and moments take 108.0 GB) through
  ``build_train_step``, 4 x 2,048 tokens, 3 steps: the scans' forward and
  gradient through K6 and K6', K5 and K5', Zamba2's shared attention
  through K4 and K4' at dh 112;
* training of the MoE, MLA and frontend families at full width through
  ``build_train_step``, 4 x 2,048 tokens a step, 3 steps (FRONTIER_TRAIN):
  Qwen1.5-MoE-A2.7B (4 of 24 layers, 2,905,090,048 parameters),
  DeepSeek-V2-Lite (4 of 27: the dense layer 0 and 3 MoE layers,
  2,254,983,168), Whisper-small whole (its frames drawn by the caller) and
  InternVL2-26B (4 of 48, 2,705,387,520; its patch embeddings drawn by the
  caller): K4 and K4' at (128, 128), MLA's (192, 128), non-causal over
  1,500 encoder frames and 2,048 x 1,500 cross attention, and group 6;
* the README's eight examples as a user runs them
  (``python -m repro_torch.examples.<name>``), each through its module's
  ``run`` on the card: ``train_lm`` at the reference's "~100M" flags,
  d_model 768, 12 layers, 8 heads over 2 kv heads of 96 (58,608,384
  parameters; K4 and K4' at (96, 96)), 8 x 2,048 tokens a step
  in 4 microbatches, the rows of a ``sum`` stage on 2 pool threads, 20
  steps (K4, K4'); ``serve_lm`` with 24 prompts of 2,048 tokens (K4);
  ``moe_pipeline --device`` (K1's MoE-expert program), ``ida_pipeline``
  (K2 under STATIC, MFSC and GSS), ``preemptive_serving`` (K1's linreg
  program and K3), ``hetero_pipeline`` (K1 and K3 on the walker lane),
  ``serve_pipelines`` and ``quickstart`` (host only) at the reference's
  sizes.

Phases, each printed as one JSON line with its seconds: environment, build
of the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
started together), each kernel against its plain PyTorch version on the
card at the main path's shapes, the main path itself through the port's
entry points with the launch counters set to 0 just before and read just
after, and times (CUDA events, warm-up, median of repeats) beside each
kernel's bound. Then the migration path: both pipelines at the same sizes,
moved host -> device and device -> host mid-flight through
``linear_regression_migrated`` / ``recommendation_migrated`` (counters set
to 0 just before each call and read just after), each cut where a ``sum``
stage is partly done, so the resumed walk starts from a seed (K3). Then the
MoE path (``moe_dispatch_lowering_for`` -> ``moe_device_lowering`` ->
``run_device_dag`` -> combine: exactly one walker launch) held to the plain
walk and to a float64 oracle, and the batched path (``merge_device_lowerings``
-> ``run_device_dag``: one launch per batch, every member bitwise equal to
its single-launch walk). Then the CC-iteration path
(``cc_iteration_device``: one walker launch per shard, bitwise equal to
``cc_propagate_ref``, to the CC step and to the plain walk, the flip count
exact), the paper's entry points (phase ``paper_entry_points``: each
card drive with the counters set to 0 just before and read just after),
telemetry, co-execution and the server (phase ``server_telemetry``: the
walker lane's runs launched on K1, the co-executed beta within the linreg
limits of the walk's, a placed job's walked on the card within the limits
of its solo run and its host-only run, every chunk once under each
arbiter), the serving front door (phase ``front_door``: the open-loop
replays' property against FIFO, ``FrontDoor`` on the real pool with the
placed 1,000,000 x 101 linreg job walking K1 on the lane, its beta within
the linreg limits, the hetero and server tuners, and ``serving_pair``
bitwise its direct composition on the card) and the serving path
(``serve_lm``: exactly 36 x 6 = 216 K4
launches, none in decode; the first batch's logits through K4 against the
same weights through K4's plain version; K4 alone at the serving shape
against its plain version and a float64 oracle), then the two recurrent
serving paths (``serve_lm --arch rwkv6-3b``: exactly 32 x 6 = 192 K6
launches and no other; ``--arch zamba2-7b``: exactly 81 x 6 = 486 K5 and
13 x 6 = 78 K4 launches at dh 112), each scan held to its float64 oracle
and its plain version, output and final state, on the served call's own
inputs and on randn (fast decay for K6), and K4 at dh 112 to its float64
oracle; then the two MoE serving paths (``--arch qwen2-moe-a2.7b``:
exactly 24 x 6 = 144 K4 launches; ``--arch deepseek-v2-lite-16b``: 27 x 6
= 162 at (192, 128), v the view ``kv[..., 128:]`` read in place), each
config's widths, MoE and MLA sub-configs and parameter counts checked,
nothing launched in decode, the first batch's logits through K4 against
K4's plain version, and K4 alone on the served call's own q, k, v and on
randn against its float64 oracle and plain version; then the frontend
families (``serve_whisper_small``: exactly 2 x 12 + 36 = 60 K4 launches,
every call's shape, causal flag and tile checked, the first batch's and
the long prompt's logits against K4's plain version, K4's encoder and
cross calls held non-causal to their float64 oracle and plain version,
the encoder's share of a prefill; ``serve_internvl2_26b``: exactly 2 x 32
= 64 at group 6, the first batch's logits against plain K4, other patch
embeddings giving other logits); then training
(``train_qwen2_0_5b``: the config's widths and parameter count; the first
step's loss and every gradient leaf through K4 against the same step
through K4's plain forward and backward, within TRAIN_GRAD_TOL, and the
control with the attention output detached failing it; exactly 48 K4
forward and 24 backward launches a step; finite losses; the checkpoint
restored bitwise the final state; ``resumed_from`` right; K4's forward and
backward at the training shape against their float64 oracles and plain
versions, the backward twice bitwise and without its D term failing; each
of its bf16 kernels issuing HGMMA with no stack frame or local memory, and
its dK/dV and dQ kernels' device ms apart); then the recurrent families'
training (``train_rwkv6_3b``: exactly 2 x 32 K6 and 32 K6' launches a
step; ``train_zamba2_7b``: 2 x 18 K5, 18 K5', 2 x 3 K4 and 3 K4'; the
first step's loss and gradient leaves on 4 and 6 layers at full width
within TRAIN_GRAD_TOL of the same step through the scans' (and K4's)
plain pairs (RWKV6: within its limit derived from the float64 witness,
see RWKV_TRAIN), the control with the scan's outputs detached failing it;
finite losses; K6' and K5' alone at the training shape against a float64
gradient and their plain versions within ``scan_bwd_limits``, bitwise
twice, the control with the carried state dropped failing the limit, HMMA
in the SASS of their product kernels with no stack frame or local memory,
with ms, device ms of each of their three kernels, plain ms and bound);
then the MoE, MLA and frontend families' training (``train_qwen2_moe_a2_7b``,
``train_deepseek_v2_lite_16b``, ``train_whisper_small``,
``train_internvl2_26b``: the config's widths and parameter count; the
first step at 2 layers through K4 and K4' within TRAIN_GRAD_TOL of K4's
plain pair, the MoE models' plain run replaying the K4 run's routing, the
detached-attention control failing; exactly 2 K4 and 1 K4' launch a K4
call of a forward, none padded; finite losses and params; peak memory; a
K4' row for each shape new to training on the first step's own call,
against its float64 oracle and plain version, the no-D control failing);
last, the examples (phase ``examples``: one line each, its seconds, its launches,
exactly as ``EXAMPLES`` says, and its checks: bitwise where both sides run
the same operations, else the worst share of ``kernels/limits.py``'s
limits, past which the example raises; train_lm's losses, the last below
the first, its step and pool-wait seconds and tokens/s; K4 and K4' at
train_lm's shape against their float64 oracles and plain versions, rows
of the kernels line). K5 and K6 run split
TF32 on the tensor cores in two launches a call (counted once): each
one's row gives the device ms of both by ``torch.profiler`` and requires
the profiler to record the two launches a call, requires a tensor-core
instruction (HMMA) in the SASS of each of its kernels, and takes the
least bound over chunk lengths and over two routes, fp32 FMA and split
TF32; the serving line gives the design's own bytes, reckoned from the
shapes. K2's and K4's rows give their device ms too. The rows of the
kernels redesigned since their first port carry ``redesigned: true``
(``REDESIGNED``). Each phase frees its weights before the next draws its
own. TF32 is off for every check and time (``allow_tf32 = False``), so
library calls run in full fp32, and so are cuBLAS's reduced-precision
bf16 reductions: a bf16 product sums in fp32 and rounds once. Any failed
check exits non-zero. Without a CUDA device, or without the
repository around it, the script fails and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the limits the smoke holds float sums to, shared with the examples
# (src/repro_torch/kernels/limits.py, their derivations beside EPS32 and
# SILU_SLOPE): eps32 * sqrt(adds) * sum|terms|, twice it for a migrated
# run, the MoE slab's float64 limits; ``beyond`` / ``excess`` count the
# entries past them
from repro_torch.kernels.limits import (EPS32, MIGRATED_FACTOR, beyond,  # noqa: E402
                                        excess, moe_combined_limit, moe_limits)

LINREG_ROWS, LINREG_COLS = 1_000_000, 101
REC_USERS, REC_ITEMS = 65_536, 2_048
CC_SCALE, CC_SMALL_N = 14, 4_096
TILE = 64

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor) flop/s,
# bf16 and TF32 dense tensor-core flop/s
PEAK_BYTES, PEAK_FP32, PEAK_BF16, PEAK_TF32 = 3.35e12, 67e12, 989e12, 495e12

BETA_RTOL = 1e-2          # beta vs the float64 oracle, of the largest |beta|
# a walked float32 linreg sum vs the host-only run's, of its largest |entry|
# (the bar tests/test_torch_apps.py holds the walker's sums to; at 131,072
# rows the host's tile-by-tile fold is 1.4e-6 off a float64 sum)
SUM_RTOL = 1e-5
REC_AGREEMENT = 0.9999    # scores vs the float64 oracle (see RecOracle)

# Migration cuts, in chunks (one 64-row tile each, SS on one host worker).
# Each leaves a `sum` stage partly done. linreg host -> device runs all of
# `moments` and 128 `syrk_gemv` tiles on the host (a moments tile is cheap,
# a syrk_gemv tile is not), so the walk is `syrk_gemv` alone, seeded, with
# `moments` fed back as a plain value; device -> host leaves 256
# `syrk_gemv` tiles to the host. Recommendation host -> device stops after
# 128 tiles each of `item_norms` and `user_bias`; device -> host stops 128
# tiles before the end of `item_norms`, the only sum stage, which ends at
# two thirds of the table.
LIN_UNITS, REC_UNITS = LINREG_ROWS // TILE, REC_USERS // TILE

MOE_ARCH, MOE_TOKENS, MOE_SKEW = "qwen2-moe-a2.7b", 4_096, 1.2
BATCH = 8
B_LIN_ROWS, B_REC_USERS = 131_072, 8_192
# a batch member's top items vs the float64 oracle: 8,192 users each, where
# a float32 near-tie flips about one user in 10,000 (the 65,536-user run above)
B_REC_AGREEMENT = 0.999
# LM serving: the reference's --mode lm at Granite-8B's full size. GSS over
# 8 requests and 4 slots gives chunks [2, 2, 1, 1, 1, 1]: 6 prefills of
# 4 x 2,048 tokens (the chunked impl, so one K4 launch a layer) and 15
# decode steps each.
SERVE = dict(arch="granite-8b", smoke=False, requests=8, slots=4, prompt_len=2048,
             gen_len=16, technique="GSS", device="cuda")
SERVE_BATCHES, GRANITE_LAYERS = 6, 36
# K4 against a float64 oracle of its own function: p is rounded to bf16
# before p . v and the output to bf16, each by at most half a step of an
# 8-bit significand, 2^-8 of the value; the fp32 sums and expf add under
# 2^-16 of sum_j w_j |v_j|. Each entry's limit is 2^-8 (|o| + sum_j w_j
# |v_j|) + 2^-16 sum_j w_j |v_j|; against the plain version both sides
# round, so twice the limit.
K4_ULP, K4_FP32 = 2.0 ** -8, 2.0 ** -16
# K4's gradient (the backward kernel, on the forward's output and LSE)
# against a float64 gradient of the same inputs (`k4_grad_oracle`): the
# kernel's fp32 part is its sums over up to group x Skv terms (eps32 sqrt(k)
# of the sum of |terms|: 2^-16 at 7 x 2,048), the forward's LSE and expf of
# a score whose own fp32 sum errs by eps32 sqrt(dh) of its |terms|; 2^-14 of
# each entry's sum of |terms| holds them with a margin of 4.
K4_BWD_FP32 = 2.0 ** -14
# In bfloat16 the kernel also rounds P and dS to bfloat16 (u = 2^-8, half a
# step of an 8-bit significand) as the A operands of dV += P^T dO, dQ += dS K
# and dK += dS^T Q. A rounded operand x' = x (1 + e), |e| <= u, moves each
# product by u |x| |y| at most, so an entry moves by at most u times its sum
# of |operand products|: dv by u sum_i P |dO|, dq by u scale sum_j |dS| |K|,
# dk by u scale sum_i |dS| |Q|. With |dS| = P |dP - D| <= P (|dP| + |D|),
# each is at most u T, T the entry's sum of |terms| that the fp32 part
# already carries: the bf16 limits gain u T. Against the plain version,
# which rounds at the same places, the two sides round P and dS from fp32
# values that differ in their last bits, so a rounding can flip, and that
# limit gains u T too. float32 inputs are not rounded: nothing is added.
# The first batch's last-position logits through K4 against the same
# weights through K4's plain version: the two attention outputs differ in
# fp32 rounding, which flips bf16 roundings downstream; 36 layers of bf16
# activations carry such a flip on, as the CPU parity tests see 1-2% of the
# largest logit over 2 layers (ten-odd roundings each). Limit: 10% of the
# largest |logit|; greedy-token agreement is reported, not required.
LOGIT_TOL = 0.10
# LM serving of the two recurrent families, at full size, with the same
# traffic as Granite's: RWKV6-3B (32 layers: one K6 launch a layer in a
# prefill) and Zamba2-7B (81 Mamba2 layers: one K5 launch each; 13
# super-blocks, each followed by the shared attention block: one K4 launch
# at dh 112).
RWKV_SERVE = dict(SERVE, arch="rwkv6-3b")
ZAMBA_SERVE = dict(SERVE, arch="zamba2-7b")
RWKV_LAYERS, ZAMBA_MAMBA_LAYERS, ZAMBA_SUPER_BLOCKS = 32, 81, 13
# LM serving of the two MoE families, at full size, with the same traffic:
# Qwen1.5-MoE-A2.7B (24 layers: one K4 launch each, dh 128) and
# DeepSeek-V2-Lite (27 layers of MLA: one K4 launch each at (192, 128)).
# Their (all, active) parameter counts are the reference's count_params /
# count_active_params.
QWEN_MOE_SERVE = dict(SERVE, arch="qwen2-moe-a2.7b")
DEEPSEEK_SERVE = dict(SERVE, arch="deepseek-v2-lite-16b")
QWEN_MOE_LAYERS, DEEPSEEK_LAYERS = 24, 27
QWEN_MOE_PARAMS = (14_316_259_328, 2_689_648_640)
# LM serving of the two frontend families (phases `serve_whisper_small`,
# `serve_internvl2_26b`), after the MoE families' with everything before
# freed. The reference's serving loop passes prompts of tokens only, so
# both drive Model.prefill and Model.decode_step directly (`serve_slots`),
# slot batches of 4 as serve_lm serves them. Whisper-small at full size
# (the reference's count_params): 8 requests, each with 1,500 frames of
# 128-wide stub embeddings from a seed, a 4-token decoder prompt and 60 new
# tokens (s_max 64, under Whisper's 448 positions): 2 prefills with K4 on
# the 12 encoder layers only (the decoder's prompt takes "full"); then one
# batch of 4 with a 2,048-token decoder prompt and 16 new tokens: K4 on the
# encoder (12), the decoder's causal self-attention (12) and its cross
# attention, 2,048 queries against 1,500 keys (12), so 2 x 12 + 36 = 60.
# InternVL2-26B at full width with its depth cut from 48 layers to 32
# (13,627,699,200 parameters, 54.51 GB of fp32 weights; all 48 layers take
# 79.48 GB, which leaves the 80 GB card nothing for activations), 8
# requests of 2,048 tokens in 2 prefills of 4, 16 new tokens, the first 256
# positions of each prompt one image tile's 1,024-wide patch embeddings
# from a seed: K4 at (128, 128), 48 heads over 8 kv heads (group 6), once
# a layer: 2 x 32 = 64.
WHISPER_SERVE = dict(arch="whisper-small", requests=8, slots=4, prompt_len=4, gen_len=60,
                     long_prompt_len=2048, long_gen_len=16)
WHISPER_LAYERS, WHISPER_PARAMS = 12, 278_373_120
INTERNVL_SERVE = dict(arch="internvl2-26b", n_layers=32, requests=8, slots=4,
                      prompt_len=2048, gen_len=16)
# (all 48 layers, the 32 served)
INTERNVL_PARAMS = (19_869_020_160, 13_627_699_200)
# Training (phase `train_qwen2_0_5b`): Qwen2-0.5B at full width through
# `launch/train.py`, 8 x 2,048 tokens a step, remat "full", 3 steps with a
# checkpoint after the last, then one resumed step. Each step runs K4's
# forward twice a layer (the forward and the remat recompute) and its
# backward once.
TRAIN = dict(arch="qwen2-0.5b", seq=2048, global_batch=8, steps=3)
TRAIN_LAYERS, QWEN2_PARAMS = 24, 494_147_456
# The first step's gradients through K4 against the same step through K4's
# plain forward and backward: the two attentions round in fp32 apart, which
# flips bf16 roundings downstream and through 24 layers of the backward;
# each leaf within 10% of its largest |gradient| (LOGIT_TOL's share; a k
# bias, whose exact gradient is 0, within 10% of its wk's), the loss within
# 1e-2 of itself. The control, the attention output detached, takes every
# gradient of q, k and v away and must fail the limit.
TRAIN_GRAD_TOL, TRAIN_LOSS_RTOL = 0.10, 1e-2
DEEPSEEK_PARAMS = (15_706_484_224, 2_661_150_208)
# Training the recurrent families (phases `train_rwkv6_3b`, `train_zamba2_7b`),
# after Qwen2-0.5B's: RWKV6-3B at full width and depth through the launcher
# (3,073,477,120 parameters: 36.9 GB of fp32 weights and AdamW moments,
# updated in place, beside 12.3 GB of gradients), 4 x 2,048 tokens a step,
# 3 steps with a checkpoint after the last and one resumed step; Zamba2-7B
# at full width with its depth cut from 81 layers to 18 (three super-blocks
# of attn_every = 6, no tail: 1,838,512,800 parameters; all 81 layers'
# 6,751,130,832 take 108.0 GB at 16 bytes a parameter, beyond the card's
# 80) through build_train_step on dataclasses.replace(cfg, n_layers=18), 4 x
# 2,048 tokens, 3 steps. Each scan layer runs its forward twice a step (the
# forward and the remat recompute) and its backward once; Zamba2's shared
# attention block K4 twice and K4' once a super-block. The first-step
# gradient check runs at full width on fewer layers (RWKV6 4, Zamba2 6, one
# super-block), at the same TRAIN_GRAD_TOL, with its detached-scan control.
# Both are held to the plain pairs. RWKV6's step is steep at
# initialisation (u = 0, a zero w_lora_b): a head's output at a step is a
# few recent values weighted by dot products r . k, cast to bfloat16 and
# divided by their size in its group norm (ln_x, eps 1e-5), so a scan's
# last-bit differences move its gradients far: through the kernels against
# the plain pairs the embedding's gradient moves by 5.1 times
# TRAIN_GRAD_TOL (an H100 80GB HBM3 at 700 W). Its check therefore carries
# a witness, the same step with the scan in float64 (`rwkv6_float64_pair`:
# the sequential oracle forward, the plain backward in float64), and every
# K6 call of the step's forward held to K6's float64 limit at the call's
# own inputs, the plain version's too (`rwkv6_forward_witness`). With
# rho_P the plain pairs' step's worst share against the float64 step for a
# leaf kind (a leaf's name without its layer index), a scan as sound as the
# plain one may lie as far from that step on the other side, so RWKV6's
# limit for the kind is max(1, 2 rho_P) of TRAIN_GRAD_TOL, for the
# kernels' step against the plain pairs' and against the float64 step; the
# detached control must fail it. (Against the float64 step the plain pairs
# read 4.84 on the embedding and 1.2-3.4 elsewhere, the kernels 3.95 and
# 1.1-3.3, on the same card.)
RWKV_TRAIN = dict(arch="rwkv6-3b", seq=2048, global_batch=4, steps=3)
ZAMBA_TRAIN = dict(arch="zamba2-7b", seq=2048, global_batch=4, steps=3, n_layers=18)
RWKV_TRAIN_PARAMS, ZAMBA_PARAMS, ZAMBA_TRAIN_PARAMS = (3_073_477_120, 6_751_130_832,
                                                       1_838_512_800)
GRAD_CHECK_LAYERS = {"rwkv6-3b": 4, "zamba2-7b": 6}
# Training the MoE, MLA and frontend families (phases `train_qwen2_moe_a2_7b`,
# `train_deepseek_v2_lite_16b`, `train_whisper_small`, `train_internvl2_26b`,
# after `train_zamba2_7b`), each at full width through build_train_step on
# dataclasses.replace(cfg, n_layers=...), 4 x 2,048 tokens a step from the
# DaphneSched data pipeline, remat "full", AdamW in place, 3 steps.
# Whisper-small trains whole; the others' depth is cut to 4 layers
# (DeepSeek-V2-Lite: its dense layer 0 and 3 MoE layers), as all their
# layers' weights, gradients and moments take 229, 251 and 318 GB at 16
# bytes a parameter, beyond the card's 80 (full depth waits for the mesh
# layer, ROADMAP A17). The reference's launcher gives tokens only, so the
# caller draws the frontend inputs from a seeded torch.Generator at the
# shapes of the reference's launch/specs.py: Whisper's frames (4, 1,500,
# 128) and InternVL2's patch_embeds (4, 256, 1,024), fp32. The first step
# is checked at full width on 2 layers (DeepSeek: layer 0 and one MoE
# layer; Whisper: 2 encoder and 2 decoder layers) through K4 and K4'
# against K4's plain pair at TRAIN_GRAD_TOL and TRAIN_LOSS_RTOL, with the
# detached-attention control (`first_step_grad_check`); and each K4' shape
# new to training on that step's own call against its float64 oracle
# (`k4_bwd_row`).
FRONTIER_TRAIN = dict(seq=2048, global_batch=4, steps=3)
FRONTIER_GRAD_LAYERS = 2
# K5 and K6 against a float64 oracle of the same recurrence, per entry.
# Let M be the entry's sum of |terms| (the oracle run on |inputs|: every
# gate and decay is positive) and c the largest |chunk-end cumsum| of the
# log-decays of its (batch, head). The kernel's sums round about
# k = 2 dh + Q = 3 Q times along any term's path, each by eps32 of at most
# M, and roundings of either sign add as sqrt(k) (K1's sums: eps32 sqrt(k)
# M). Each gate exp(cum_a - cum_b) takes a difference of two fp32 prefix
# sums, whose roundings are eps32 of |cum| <= c, so its relative error
# grows with c. The limit is eps32 sqrt(3 Q) (1 + c) M; the state takes the
# same limit with M its own sum of |terms|. Against the plain version both
# sides round, so twice the limit. The control that shows the limit can
# fail: the kernel on the same inputs with its decays (K6's logw, K5's dt)
# rounded to bfloat16, held to the oracle of the unrounded inputs, must
# pass the limit somewhere.
SCAN_ROUNDINGS = 3
# K5' and K6' (the scans' gradients) against a float64 gradient of the same
# inputs (`scan_bwd_limits`: the plain backward in float64, the gradient
# the CPU tests hold to jax.vjp of the reference). T is each entry's sum of
# |terms| (the plain backward's `magnitude` run: |inputs|, every difference
# a sum). Along any term's path the kernel's fp32 sums take a dot product
# over dh, a sum over the chunk's steps, the reverse cumsum over them and
# the carried state's dot product over dh: about 4 Q additions at dh = Q,
# and the reverse pass's fmaf chain over the chunks; 6 Q holds them with a
# margin. dA and du also sum over (batch, chunk), dB and dC over the heads:
# those add to k. Each gate's exponent is a difference of fp32 prefix sums
# (the (1 + c) of SCAN_ROUNDINGS). So an entry's limit is u |g| +
# eps32 sqrt(k) (1 + c) T, u the unit roundoff of the gradient's own type
# (bfloat16 dx, dB, dC, dr, dk, dv round once); against the plain version
# both sides round: twice it. The control: the backward kernel with the
# state carried between chunks dropped (`scan_bwd_dropped_carry`: the
# forward's entering states zeroed), which must pass the limit somewhere.
# (Decays rounded to bfloat16, the forward's control, do not serve under
# fast decay: there the limit's (1 + c) is over a thousand, and the clamp
# value -30 is exact in bfloat16.)
SCAN_BWD_ROUNDINGS = 6
# Launches of a small kernel that open each profiler session of
# `kernel_device_ms`, in the places whose records the profiler drops
PROFILE_FILLER = 1000
# K4's kernels in the profiler's records (flash_wgmma for bf16, flash_fwd
# for fp32)
K4_NAMES = ("flash_",)
# H100 SXM special-function units: 16 results (expf's ex2) a clock per SM,
# 132 SMs at 1.98 GHz (the clock that gives PEAK_FP32)
PEAK_SFU = 132 * 16 * 1.98e9
# The rows of the kernels redesigned since their first port: each such row
# of the kernels line carries `redesigned: true` (PERF.md keeps their times
# before the redesign; every number on the line is this run's).
REDESIGNED = frozenset({
    "dag_walk[linreg]", "dag_walk[recommendation]", "dag_walk[linreg, batched x8]",
    "dag_walk[recommendation, batched x8]", "dag_walk[linreg, seeded]",
    "dag_walk[recommendation, seeded]", "flash_attention", "flash_attention[dh 112, Zamba2]",
    "dag_walk[moe.experts]", "dag_walk[cc_iteration]", "ssm_scan", "rwkv6_scan",
    "cc_propagate", "flash_attention_bwd[dh 64, group 7, Qwen2-0.5B train]",
    "ssm_scan_bwd[Zamba2-7B train]", "rwkv6_scan_bwd[RWKV6-3B train]",
})
# The paper's own host entry points beside the card (phase
# `paper_entry_points`): Listings 1 and 2 on the VEE's host pool, the
# device tuner's and persistent re-balancing's tables walked on the card,
# the simulator beside the measured walks, and the coordinator. The
# tuner's costs are Listing 1's own `cost_of_range`, nnz + 1 a row; the
# walk's tiles are the CC-iteration program's, on 2 shards; the
# coordinator runs 2 nodes x 4 workers.
PAPER_WORKERS, PAPER_SHARDS, CC_TILE = 8, 2, 256
COORD_NODES, COORD_WORKERS = 2, 4
# The serving front door (phase `front_door`): the reference's open-loop
# rows (`benchmarks/run.py:bench_openloop`, `bench_preemptive`) run 2,000
# arrivals; a replay costs time quadratic in its length on the host, so
# the phase cuts them to 800 (the rows' own quick size) at load 1.5 and
# 400 at load 5.0 to stay near 20 s.
OPENLOOP_REQUESTS, PRESSURED_REQUESTS = 800, 400
# The examples (phase `examples`, last): each module of
# `repro_torch.examples` run on the card through its own `run`, as a user
# runs `python -m repro_torch.examples.<name>`; train_lm at the reference's
# "~100M" flags (--d-model 768 --layers 12, the default 8 heads of 96 over
# 2 kv heads: K4 and K4' at (96, 96)) and serve_lm at head width 16, both
# over 1,024 tokens so that K4 runs, the others at the reference's sizes;
# and the kernel entries each must launch. train_lm launches K4 twice a
# layer and microbatch (remat "full" recomputes the forward) and K4' once;
# serve_lm launches K4 once a layer and prefill: the requests, the warm-up
# and the 3 direct requests it checks against.
EXAMPLE_TRAIN = dict(d_model=768, layers=12, heads=8, seq=2048, batch=8, microbatches=4,
                     steps=20)
EXAMPLE_SERVE = dict(requests=24, prompt_len=2048)
EXAMPLE_TRAIN_K4 = 2 * EXAMPLE_TRAIN["layers"] * EXAMPLE_TRAIN["microbatches"]
EXAMPLES = (
    ("train_lm", EXAMPLE_TRAIN,
     {"flash_attention": EXAMPLE_TRAIN_K4 * EXAMPLE_TRAIN["steps"],
      "flash_attention_bwd": EXAMPLE_TRAIN_K4 // 2 * EXAMPLE_TRAIN["steps"]}),
    ("serve_lm", EXAMPLE_SERVE, {"flash_attention": 4 * (EXAMPLE_SERVE["requests"] + 4)}),
    ("moe_pipeline", dict(device=True), {"walk_moe": 1}),
    ("ida_pipeline", {}, {"cc_propagate": 3}),
    ("preemptive_serving", {}, {"walk_linreg": 3}),
    ("hetero_pipeline", {}, None),     # the lane's runs: K1, as many as it takes
    ("serve_pipelines", {}, {}),
    ("quickstart", {}, {}),
)
MIGRATIONS = (
    ("linreg", "host_to_device", LIN_UNITS + 128),
    ("linreg", "device_to_host", 2 * LIN_UNITS - 256),
    ("recommendation", "host_to_device", 256),
    ("recommendation", "device_to_host", 2 * REC_UNITS - 256),
)


# MoE routing between two runs of one model whose arithmetic differs by
# rounding (K4 against its plain version on the card; the port against the
# reference on the CPU, tests/test_torch_moe_layer.py). Where two router
# logits nearly tie, the runs can pick different experts at a position,
# whose output then differs by a whole expert, and the difference grows
# through the later layers. ``routing_flips`` holds every logit of one run
# within what the two router inputs' difference explains: |dx| @ |W|, plus
# one bf16 ulp of each run's logit (its rounding), plus 2 d eps32 |x| @ |W|
# (the two runs' fp32 sums over d terms; the smoke turns off cuBLAS's
# reduced-precision bf16 reductions, so a product sums in fp32 and rounds
# once). A position whose expert set differs is a flip on a near tie when
# the other run's k-th and (k+1)-th logits lie within TIE_ULPS bf16 ulps
# of the larger, or within those two experts' bounds; a position whose set
# agrees and only its capacity drop differs follows from a flip before it
# in the (T*k) capacity count. Anything else fails.
TIE_ULPS = 2


def bf16_ulp(t):
    """The spacing of bf16 values at magnitude |t| (8 significant bits)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126))) - 7)


def kept_slots(idx, cap: int):
    """The capacity rule on ``idx (T, k)``: a slot is kept when fewer than
    ``cap`` slots of its expert come before it in t-major order."""
    import torch
    import torch.nn.functional as F

    flat = idx.reshape(-1).long()
    pos = torch.cumsum(F.one_hot(flat), dim=0).gather(1, flat[:, None])[:, 0] - 1
    return (pos < cap).reshape(idx.shape)


def routing_flips(ref: tuple, got: tuple, router, moe) -> dict:
    """One MoE call's routing in two runs: ``ref`` ``(x, logits, idx)``
    (its router input, float32 logits and expert indices), ``got``
    ``(x, idx)``; ``router`` the call's weights. Returns the positions
    (flattened ``b * S + s``) of near-tie flips and of capacity-only
    differences, the worst share of its bound a logit moved by, and
    ``unexplained``, the positions no rounding explains (empty when all
    is well)."""
    import torch

    ref_x, ref_logits, ref_idx = ref
    got_x, got_idx = got
    ref_idx, got_idx = ref_idx.long(), got_idx.long()
    w = router.to(torch.bfloat16)
    w_abs = w.float().abs()
    got_logits = (got_x.to(torch.bfloat16) @ w).float()
    bound = ((got_x.float() - ref_x.float()).abs() @ w_abs
             + bf16_ulp(got_logits) + bf16_ulp(ref_logits)
             + 2 * w.shape[0] * EPS32 * (ref_x.float().abs() @ w_abs))
    share = float(((got_logits - ref_logits).abs() / bound).max())
    t, k = ref_idx.shape
    cap = max(1, math.ceil(k * t * moe.capacity_factor / (moe.n_routed_padded or moe.n_routed)))
    sets_differ = (ref_idx.sort(1).values != got_idx.sort(1).values).any(1)
    ref_kept = torch.where(kept_slots(ref_idx, cap), ref_idx, -1).sort(1).values
    got_kept = torch.where(kept_slots(got_idx, cap), got_idx, -1).sort(1).values
    capacity = (ref_kept != got_kept).any(1) & ~sets_differ
    order = torch.sort(ref_logits, dim=1, descending=True, stable=True).indices
    a = ref_logits.gather(1, order[:, k - 1:k])[:, 0]
    b = ref_logits.gather(1, order[:, k:k + 1])[:, 0]
    pair = bound.gather(1, order[:, k - 1:k])[:, 0] + bound.gather(1, order[:, k:k + 1])[:, 0]
    explained = ((a - b) / bf16_ulp(torch.maximum(a.abs(), b.abs())) <= TIE_ULPS) \
        | (a - b <= pair)
    near_tie = torch.nonzero(sets_differ).flatten()
    cap_pos = torch.nonzero(capacity).flatten()
    early = cap_pos[cap_pos < near_tie.min()] if near_tie.numel() else cap_pos
    bad = (sets_differ & ~explained) | ((got_logits - ref_logits).abs() > bound).any(1)
    unexplained = sorted(set(torch.nonzero(bad).flatten().tolist()) | set(early.tolist()))
    return dict(near_tie=near_tie.tolist(), capacity=cap_pos.tolist(), worst_share=share,
                unexplained=unexplained)


@contextlib.contextmanager
def route_log():
    """Record each ``models/moe.py:_route`` call of the port: its router
    input, expert indices and router weights (detached), in call order."""
    from unittest import mock

    from repro_torch.models import moe as moe_module

    calls = []
    route = moe_module._route

    def spy(router_w, x_flat, moe):
        out = route(router_w, x_flat, moe)
        calls.append((x_flat.detach(), out[0], router_w.detach()))
        return out

    with mock.patch.object(moe_module, "_route", spy):
        yield calls


@contextlib.contextmanager
def replayed_routing(calls: list):
    """``models/moe.py:_route`` routing to the experts of ``calls`` (a
    ``route_log`` of another run of the same model, in call order), each
    weighted by this run's own router probabilities, so gradients reach
    the router as in a free run. Fails unless every logged call is
    replayed."""
    from unittest import mock

    import torch

    from repro_torch.models import moe as moe_module

    logged = iter([idx for _, idx, _ in calls])
    route = moe_module._route

    def replay(router_w, x_flat, moe):
        _, _, probs = route(router_w, x_flat, moe)
        idx = next(logged)
        w_ = probs.gather(1, idx)
        return idx, w_ / torch.clamp(w_.sum(-1, keepdim=True), min=1e-9), probs

    with mock.patch.object(moe_module, "_route", replay):
        yield
    require(next(logged, None) is None, "the replayed run routed fewer MoE calls")


def emit(phase: str, **fields) -> None:
    """One phase's numbers as a JSON line."""
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    """Report a failed check and exit non-zero."""
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(ok: bool, msg: str) -> None:
    """Fail with ``msg`` unless ``ok``."""
    if not ok:
        fail(msg)


def max_err(a, b) -> float:
    """Largest absolute difference, in float64."""
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def launch_counts(kernels) -> dict:
    """Every kernel entry point's launch count, by entry name."""
    return {e: n for k in kernels for e, n in k.launches.items()}


def close(kernel, plain, abs_sum, adds: int, what: str,
          factor: float = 1.0) -> tuple[float, float]:
    """Fail unless every entry lies within its limit (see ``excess``).

    Returns the largest absolute error and the largest share of its limit
    that an entry's error takes.
    """
    bad, err, share = excess(kernel, plain, abs_sum, adds, factor)
    require(bad == 0, f"{what}: {bad} entries beyond {factor:g}*eps*sqrt({adds})"
                      f"*sum|terms|; max abs err {err:.3g}")
    return err, share


class RecOracle:
    """The recommendation's float64 oracle on the card.

    The data are the recommendation lowering's draw (the same seed,
    unrounded), and ``best`` is each user's top item by the float64
    scores R / (sqrt(norm) + 1e-9) - bias. The scores body rounds R / den
    and then subtracts the user's bias in float32, which decides near-ties:
    float32 stage sums rounded once from float64 (exact sums) still part
    from the oracle's item on more users than REC_AGREEMENT allows
    (``users_off_the_oracles_item_with_exact_norms``). So a user agrees
    when the port picks the oracle's item, or an item whose float64 score
    lies within ``tie_band`` of the best: a rounding of the subtraction on
    each item (2^-24 |score| each, doubled), the quotient's roundings (R's,
    the square root's, the add's, the division's: 2^-22 of each quotient),
    and the item_norms entries' own limit carried into R / den (eps32
    sqrt(k) of the norm, halved by the square root). A wrong sum must still
    fail: ``dropped_tile_scores`` is the control.
    """

    def __init__(self, n_users: int, n_items: int, dev, density: float = 0.3,
                 seed: int = 0):
        import numpy as np
        import torch

        rng = np.random.default_rng(seed)
        R = rng.uniform(0.0, 1.0, size=(n_users, n_items))
        R *= rng.uniform(size=(n_users, n_items)) < density
        R = torch.from_numpy(R).to(dev)
        self.q = R / (torch.sqrt((R * R).sum(0)) + 1e-9)
        self.s = self.q - R.mean(1, keepdim=True)
        del R
        self.best = self.s.argmax(1)
        self.eta = EPS32 * math.sqrt(n_users // TILE)

    def tie_band(self, users, pick):
        """Each user's tau: how far below the best a pick's float64 score
        may lie and still agree."""
        s_b, s_p = self.s[users, self.best[users]], self.s[users, pick]
        q_b, q_p = self.q[users, self.best[users]], self.q[users, pick]
        return (2.0 ** -23 * (s_b.abs() + s_p.abs())
                + (q_b + q_p) * (2.0 ** -22 + self.eta / 2))

    def agreement(self, top) -> tuple[float, float]:
        """(share of users that agree, share that pick the oracle's item)."""
        import torch

        pick = torch.as_tensor(top, device=self.q.device).long()
        u = torch.arange(len(pick), device=self.q.device)
        same = pick == self.best
        near = self.s[u, pick] >= self.s[u, self.best] - self.tie_band(u, pick)
        return float((same | near).double().mean()), float(same.double().mean())


def dropped_tile_scores(R, norms, bias):
    """The scores body on ``norms`` less R's first 64-row tile: the
    smallest wrong sum a walk can make, a control ``RecOracle.agreement``
    must fail."""
    from repro_torch.vee import apps

    return apps.scores_plain(R, norms - (R[:TILE] * R[:TILE]).sum(0), bias)


def rec_chain(R, norms=None):
    """The recommendation's whole function as three PyTorch calls over R
    (users, items), or a stack of them: item norms, user biases, the top
    item (``norms`` given: a seeded walk's). A yardstick only."""
    import torch

    if norms is None:
        norms = R.square().sum(-2, keepdim=True)
    bias = R.mean(-1, keepdim=True)
    return torch.argmax(R / (norms.sqrt() + 1e-9) - bias, -1)


#: the three calls ``rec_chain`` makes, as the kernels line names them
REC_CHAIN_CALL = ("R.square().sum(0) -> R.mean(1) -> "
                  "torch.argmax(R / (norms.sqrt() + 1e-9) - bias[:, None], 1)")


def rec_bytes(users: int, items: int) -> int:
    """Least bytes of the recommendation's function: the `full` edge from
    item_norms to scores needs every norm before any score, and R (537 MB
    at 65,536 x 2,048) is far past the 50 MB L2, so R is read twice; the
    norms, biases and scores once each."""
    return 4 * (2 * users * items + items + 2 * users)


def solo_walk(low, rows, name: str, values: dict, plain: bool = False):
    """Stage ``name`` of ``low`` walked alone over its own slots of
    ``rows``, reading its producers from ``values``: the stage on the same
    inputs as a walk that read them. Returns ``(walk, result)``, ``walk``
    the call that repeats it, on the plain walker or on the card's."""
    import dataclasses

    from repro_torch.kernels.dag_walk import WalkOperand, dag_walk, dag_walk_plain

    k, st = next((k, st) for k, st in enumerate(low.stages) if st.name == name)
    sub = rows[(rows[:, 0] == k) & (rows[:, 2] > 0)].copy()
    sub[:, 0] = 0
    solo = dataclasses.replace(st, operands=st.operands + tuple(p for p, _ in st.reads),
                               reads=())
    ops = [o for o in low.operands if o.name in st.operands]
    for prod, kind in st.reads:
        v = values[prod]
        ops.append(WalkOperand(prod, (TILE,) + tuple(v.shape[1:]) if kind == "rows"
                               else tuple(v.shape),
                               ("row" if kind == "rows" else "zero",)
                               + ("zero",) * (v.dim() - 1)))
    vals = dict(low.values, **{p: values[p] for p, _ in st.reads})
    fn = dag_walk_plain if plain else dag_walk
    walk = lambda: fn([solo], ops, vals, sub, TILE)[name]  # noqa: E731
    return walk, walk()


def syrk_oracle(X, y, moments):
    """``syrk_gemv`` in float64 on the float64 ``moments`` of X, and each
    entry's sum of |terms|."""
    import torch

    n = X.shape[0]
    X64, mom = X.double(), moments.double()
    mean = mom[0] / n
    std = torch.sqrt(torch.clamp(mom[1] / n - mean * mean, min=0.0))
    z = torch.cat([(X64 - mean) / torch.where(std == 0, torch.ones_like(std), std),
                   torch.ones((n, 1), dtype=torch.float64, device=X.device), y.double()], 1)
    del X64
    d1 = z.shape[1] - 1
    return z[:, :d1].T @ z, z[:, :d1].abs().T @ z.abs()


def timed(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_device_ms(fn, names: tuple = ("walk_kernel",), reps: int = 5) -> dict:
    """Device milliseconds of one call of ``fn()`` by ``torch.profiler``:
    the kernels' own time, without the host's enqueue, which the CUDA-event
    ``ms`` also holds: the device time of the kernels named in ``names``
    (the walker's by default) over ``reps`` calls, divided by ``reps``.
    ``fn`` launches each of them at least once a call; where the session
    recorded fewer than ``reps`` launches of a name, ``device_ms`` is "not
    measured". ``device_launches_per_call``: the launches of ``names`` the
    session recorded, over ``reps``. After sessions of thousands of
    launches (the decode steps'), the profiler drops the first records of
    each later session as outside its window (Kineto's "Out-of-range"),
    a few more after each such session; so the session opens with
    ``PROFILE_FILLER`` launches of a small kernel that take those places."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    filler = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_FILLER):
            filler.add_(1)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    counts = [sum(e.count for e in device_rows if name in e.key) for name in names]
    ms = sum(e.self_device_time_total for e in device_rows
             if any(name in e.key for name in names)) / 1e3 / reps
    return dict(device_ms=ms if min(counts) >= reps else
                f"not measured ({len(device_rows)} device rows, launches of {list(names)}: "
                f"{counts} in {reps} calls)",
                device_launches_per_call=sum(counts) / reps)


def walk_stages(low, rows, values: dict) -> dict:
    """Each stage of ``low`` walked alone on the card (``solo_walk``),
    reading the fused walk's ``values``: the walker kernel's device ms of
    each stage and the launches it recorded."""
    return {st.name: kernel_device_ms(solo_walk(low, rows, st.name, values)[0])
            for st in low.stages}


def moe_one_tf32(x, wi, wo):
    """One MoE slab with each product taken once in TF32 (operands rounded
    to 11 bits, products and sums in fp32): the control that the limit
    must catch."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import tf32_round

    f = wo.shape[0]
    h = tf32_round(x) @ tf32_round(wi)
    return tf32_round(F.silu(h[:, :f]) * h[:, f:]) @ tf32_round(wo)


def bound_ms(n_bytes: float, flops: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    """Least time for the work on the card, and whether bytes or operations
    (at the ``peak`` rate of their type) set it."""
    tb, tf = n_bytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def scan_bound(n_bytes: float, work, q_max: int, tf32_work=None) -> dict:
    """Least time for a chunked scan's function on the card: its bytes at
    the memory rate, or the least over chunk lengths q dividing ``q_max``
    (q = 1 is the step-by-step recurrence) and over routes of its
    operations, each kind at its peak rate, the slowest kind setting the
    time. Routes: fp32 FMA, ``work(q)`` giving ``(flops, exps)`` for the
    whole input at chunk q; and, where ``tf32_work`` is given, split TF32
    on the tensor cores, ``tf32_work(q)`` giving ``(tf32 flops of the
    products, counted once a TF32 product, fp32 flops of the rest, exps)``.
    Chunk boundaries choose how the sums are grouped, not what the
    function is."""
    routes = [(max(f / PEAK_FP32, e / PEAK_SFU) * 1e3, q, "fp32", f, e)
              for q in range(1, q_max + 1) if q_max % q == 0 for f, e in [work(q)]]
    if tf32_work is not None:
        routes += [(max(t / PEAK_TF32, f / PEAK_FP32, e / PEAK_SFU) * 1e3, q, "split TF32",
                    t + f, e)
                   for q in range(1, q_max + 1) if q_max % q == 0
                   for t, f, e in [tf32_work(q)]]
    t_ops, q, route, flops, exps = min(routes)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else f"operations, {route}",
                bound_chunk=q, bound_route=route, ops_bound_ms=t_ops, flops=flops, exps=exps,
                bytes=n_bytes)


def sass_functions(kernel) -> list[str]:
    """The SASS of each function in ``kernel``'s built library (a
    ``_build.Kernel``), by ``cuobjdump -sass``: one string a function, its
    mangled name on the first line."""
    import re

    sass = cuobjdump("-sass", kernel)
    return re.split(r"\n\s*Function : ", sass)[1:]


def cuobjdump(option: str, kernel) -> str:
    """``cuobjdump option`` of ``kernel``'s built library (a
    ``_build.Kernel``), the tool beside ``nvcc``."""
    import shutil

    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    require(bool(tool), "cuobjdump not found beside nvcc")
    return subprocess.run([tool, option, str(kernel.library)],
                          capture_output=True, text=True, check=True, timeout=120).stdout


def kernel_resources(kernel) -> dict:
    """Each function's resources in ``kernel``'s built library as ptxas
    fixed them (``cuobjdump -res-usage``): mangled name -> ``{"REG":
    registers a thread, "STACK": bytes, "SHARED": bytes, "LOCAL": bytes}``.
    A function that spills registers has a stack frame or local memory."""
    import re

    text = cuobjdump("-res-usage", kernel)
    return {name: {k: int(n) for k, n in re.findall(r"([A-Z]+):(\d+)", line)}
            for name, line in re.findall(r"Function ([^\s:]+):[ \t]*\n\s*([^\n]*)", text)}


def k4_bwd_kernels() -> dict:
    """K4's bfloat16 backward kernels (``bwd_*_wgmma``): readable name ->
    ``[registers, stack bytes, local bytes, HGMMA in the SASS]``."""
    import re

    from repro_torch.kernels import _build

    def readable(mangled: str) -> str:
        name = re.search(r"\d+(bwd_[a-z_]+?)I", mangled).group(1)
        args = re.findall(r"Li(\d+)E", mangled)
        return f"{name}<{', '.join(args)}>"

    res = kernel_resources(_build.FLASH_ATTENTION_BWD)
    sass = {f.split("\n", 1)[0].strip(): f for f in sass_functions(_build.FLASH_ATTENTION_BWD)}
    return {readable(m): [r.get("REG"), r.get("STACK"), r.get("LOCAL"),
                          "HGMMA" in sass.get(m, "")]
            for m, r in res.items() if "_wgmma" in m}


def walk_sass_has(program: str, word: str) -> bool:
    """Whether the SASS of the walker kernel of ``program`` (csrc/dag_walk.cu's
    walk_kernel<program>) holds ``word``."""
    from repro_torch.kernels import _build

    funcs = [f for f in sass_functions(_build.DAG_WALK)
             if "walk_kernel" in f.split("\n", 1)[0]
             and f"{len(program)}{program}E" in f.split("\n", 1)[0]]
    require(len(funcs) == 1, f"walk_kernel<{program}> not found in the SASS")
    return word in funcs[0]


# The scans' kernels that issue products, each built for both input types:
# K5's and K6's two launches, and the reverse pass and chunk kernels of K5'
# and K6' (their third launch, the fold, only adds)
SCAN_KERNELS = {"ssm_scan": ("ssm_states", "ssm_outputs"),
                "rwkv6_scan": ("rwkv6_states", "rwkv6_outputs"),
                "ssm_scan_bwd": ("ssm_bwd_states", "ssm_bwd_chunks"),
                "rwkv6_scan_bwd": ("rwkv6_bwd_states", "rwkv6_bwd_chunks")}


def scan_library(scan: str):
    """The built ``_build.Kernel`` of the scan ``scan`` (``SCAN_KERNELS``)."""
    from repro_torch.kernels import _build

    return {"ssm_scan": _build.SSM_SCAN, "rwkv6_scan": _build.RWKV6_SCAN,
            "ssm_scan_bwd": _build.SSM_SCAN_BWD, "rwkv6_scan_bwd": _build.RWKV6_SCAN_BWD}[scan]


def scan_sass_has(scan: str, words: tuple) -> dict:
    """For each kernel of the scan ``scan`` that issues products
    (``SCAN_KERNELS``: K5's csrc/ssm_scan.cu, K6's csrc/rwkv6_scan.cu, and
    their gradients' csrc/ssm_scan_bwd.cu, csrc/rwkv6_scan_bwd.cu; two
    kernels each, each built for both input types), whether its SASS holds
    any of ``words``."""
    funcs = {f.split("\n", 1)[0].strip(): f for f in sass_functions(scan_library(scan))
             if any(k in f.split("\n", 1)[0] for k in SCAN_KERNELS[scan])}
    require(len(funcs) == 4, f"{scan}'s four kernels not found in the SASS: {sorted(funcs)}")
    return {name: any(w in f for w in words) for name, f in funcs.items()}


def scan_bwd_kernels(scan: str) -> dict:
    """K5''s (``scan`` "ssm_scan_bwd") or K6''s ("rwkv6_scan_bwd") kernels
    that issue products, both input types: mangled name -> ``[registers,
    stack bytes, local bytes, HMMA in the SASS]`` (``cuobjdump
    -res-usage`` and ``-sass``)."""
    res = kernel_resources(scan_library(scan))
    hmma = scan_sass_has(scan, ("HMMA",))
    return {name: [r.get("REG"), r.get("STACK"), r.get("LOCAL"), hmma.get(name, False)]
            for name, r in res.items() if any(k in name for k in SCAN_KERNELS[scan])}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def moe_phase(dev, walk_inputs) -> dict:
    """The MoE path at full width: one walker launch of the MoE program.

    Returns the kernel's row for the ``kernels`` line.
    """
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.dag_walk import dag_walk, dag_walk_plain
    from repro_torch.vee import apps, ml_apps

    cfg = get_config(MOE_ARCH)
    for k in _build.KERNELS:
        k.launches.clear()
    t0 = time.perf_counter()
    low = ml_apps.moe_dispatch_lowering_for(cfg, n_tokens=MOE_TOKENS, skew=MOE_SKEW,
                                            seed=0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dlow = ml_apps.moe_device_lowering(low)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    vals, ddt = apps.run_device_dag(dlow)
    y = dlow.finalize(vals)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = launch_counts(_build.KERNELS)
    require(launches == {"walk_moe": 1}, f"moe: launches {launches}, want one walk_moe")

    E, C, d = low.meta["n_experts"], low.meta["capacity"], low.meta["d_model"]
    wi, wo, xdisp = dlow.values["wi"], dlow.values["wo"], dlow.values["xdisp"]
    f, k = wo.shape[1], low.meta["moe"].top_k
    require((E, C, d, f, k) == (60, 342, 2048, 1408, 4),
            f"moe widths {(E, C, d, f, k)} are not Qwen1.5-MoE-A2.7B's at T={MOE_TOKENS}")
    require(y.shape == (MOE_TOKENS, d) and bool(torch.isfinite(y).all()),
            "moe combined output malformed")
    rows = walk_inputs(dlow)
    walk = lambda: dag_walk(dlow.stages, dlow.operands, dlow.values, rows, C)["experts"]  # noqa: E731
    plain = lambda: dag_walk_plain(dlow.stages, dlow.operands, dlow.values, rows,  # noqa: E731
                                   C)["experts"]
    got, want = walk(), plain()
    require(torch.equal(got, vals["experts"]), "moe walk differs from the main path's")

    # float64 oracle and each entry's limits, one expert at a time; the
    # control: each product taken once in TF32
    ref = torch.empty((E * C, d), dtype=torch.float64, device=dev)
    lim, lim_rss = torch.empty_like(ref), torch.empty_like(ref)
    one_tf32 = torch.empty((E * C, d), dtype=torch.float32, device=dev)
    for g in range(E):
        sl = slice(g * C, (g + 1) * C)
        ref[sl], lim[sl], lim_rss[sl] = moe_limits(xdisp[sl].double(), wi[g].double(),
                                                   wo[g].double())
        one_tf32[sl] = moe_one_tf32(xdisp[sl], wi[g], wo[g])
    bad_o, err_o, share_o = beyond(got, ref, lim)
    require(bad_o == 0, f"moe walk vs float64: {bad_o} entries beyond the limit, "
                        f"max abs err {err_o:.3g}")
    bad_r, _, share_r = beyond(got, ref, lim_rss)
    require(bad_r == 0, f"moe walk vs float64: {bad_r} entries beyond the limit "
                        "with the first product's part added as roundings add")
    ctl_bad, _, ctl_share = beyond(one_tf32, ref, lim_rss)
    require(ctl_bad > 0, "moe: one TF32 product a slab passed the limit the "
                         "3xTF32 walk is held to")
    ctl_share_wide = beyond(one_tf32, ref, lim)[2]
    del one_tf32, lim_rss
    require(walk_sass_has("Moe", "HGMMA"), "walk_moe issues no HGMMA (wgmma)")
    bad_p, err_p, share_p = beyond(got, want, 2 * lim)
    require(bad_p == 0, f"moe walk vs plain: {bad_p} entries beyond twice the limit, "
                        f"max abs err {err_p:.3g}")
    # the combined (T, d) answer: the slabs' limits carried through the
    # weighted gather, plus the gather's own roundings (k terms), both sides
    idx, w, pos, _ = ml_apps._dispatch_plan(low.meta["route_build"], E, C)
    y_plain = dlow.finalize({"experts": want})
    require(torch.equal(y, dlow.finalize({"experts": got})),
            "moe combine differs from the main path's")
    y_lim = moe_combined_limit(lim, got, idx, w, pos, C)
    bad_y, err_y, share_y = beyond(y, y_plain, y_lim)
    require(bad_y == 0, f"moe combined vs plain: {bad_y} entries beyond the limit, "
                        f"max abs err {err_y:.3g}")
    del ref

    xd = xdisp.view(E, C, d)

    def library():
        h = torch.bmm(xd, wi)
        return torch.bmm(F.silu(h[..., :f]) * h[..., f:], wo)

    kept = int(low.meta["expert_tokens"].sum())
    # what this run's data needs: the kept token rows through both products,
    # every weight read once, every output row written once. The products
    # take the least of fp32 FMA and three TF32 products a multiply-add
    # (3xTF32, the kernel's arithmetic); the gating runs on fp32 units.
    mm_flops, gate_flops = 6 * kept * d * f, 4 * kept * f
    moe_bytes = 4 * (kept * d + E * d * 2 * f + E * f * d + E * C * d) + 12 * len(rows)
    t_ops = min(mm_flops / PEAK_FP32, 3 * mm_flops / PEAK_TF32) + gate_flops / PEAK_FP32
    t_bytes = moe_bytes / PEAK_BYTES
    full_flops = 6 * E * C * d * f
    ms = timed(walk, 5)
    emit("moe", arch=MOE_ARCH, tokens=MOE_TOKENS, skew=MOE_SKEW, experts=E, top_k=k,
         capacity=C, d_model=d, d_ff_expert=f, kept_rows=kept, slab_rows=E * C,
         launches=launches, walk_ms=ms, seconds=t3 - t0, lowering_seconds=t1 - t0,
         device_lowering_seconds=t2 - t1, walk_and_combine_seconds=t3 - t2,
         tol="eps32 * ((sqrt(f) + 4) * |a| @ |wo| + sqrt(d) * B @ |wo|), "
             "B = 1.1 |u| (|x| @ |wi_g|) + |silu(g)| (|x| @ |wi_u|); x2 vs plain",
         tol_rss="eps32 * ((sqrt(f) + 4) * |a| @ |wo| + sqrt(d) * sqrt(B^2 @ wo^2))",
         vs_float64=[err_o, share_o], vs_float64_rss_share=share_r,
         vs_plain=[err_p, share_p], combined_vs_plain=[err_y, share_y],
         one_tf32_control=dict(entries_beyond_rss_limit=ctl_bad,
                               worst_share_of_rss_limit=ctl_share,
                               worst_share_of_limit=ctl_share_wide),
         walk_sass_has_hgmma=True,
         bound_ms_full_slabs=3 * full_flops / PEAK_TF32 * 1e3)
    return dict(
        name="dag_walk[moe.experts]", route="cuda", source="src/repro_torch/csrc/dag_walk.cu",
        replaces="src/repro/kernels/dag_walk.py:218 (MoE program, "
                 "src/repro/vee/ml_apps.py:301)",
        launches=launches["walk_moe"], max_abs_err=err_p, max_abs_err_vs_float64=err_o,
        ms=ms, **kernel_device_ms(walk), plain_ms=timed(plain, 1, warmup=0),
        library_ms=timed(library, 5),
        library_call="torch.bmm(x, wi) -> silu(g) * u -> torch.bmm(., wo) on (E, C, .)",
        shapes=f"x ({E * C}, {d}), wi ({E}, {d}, {2 * f}), wo ({E}, {f}, {d}) f32, "
               f"{len(rows)} slots, tile {C}, {kept} kept rows",
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes")


def batched_phase(dev, walk_inputs) -> list[dict]:
    """Front-door batches of BATCH members, one launch each, against the
    members' single launches. Returns the kernels' rows."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.dag_walk import dag_walk, dag_walk_plain
    from repro_torch.vee import apps

    seeds = range(1, BATCH + 1)
    rows_out = []
    for pipe in ("linreg", "recommendation"):
        t = time.perf_counter()
        if pipe == "linreg":
            lows = [apps.linreg_device_lowering(B_LIN_ROWS, LINREG_COLS, tile=TILE,
                                                seed=s, device=dev) for s in seeds]
        else:
            lows = [apps.recommendation_device_lowering(B_REC_USERS, REC_ITEMS,
                                                        tile=TILE, seed=s, device=dev)
                    for s in seeds]
        merged = apps.merge_device_lowerings(lows)
        torch.cuda.synchronize()
        lowering_s = time.perf_counter() - t
        for k in _build.KERNELS:
            k.launches.clear()
        t = time.perf_counter()
        vals, _ = apps.run_device_dag(merged)
        answers = merged.finalize(vals)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t
        batch_launches = launch_counts(_build.KERNELS)
        require(batch_launches == {f"walk_{pipe}": 1},
                f"{pipe} batch: launches {batch_launches}, want one walk_{pipe}")
        for k in _build.KERNELS:
            k.launches.clear()
        t = time.perf_counter()
        singles = [apps.run_device_dag(low)[0] for low in lows]
        torch.cuda.synchronize()
        singles_s = time.perf_counter() - t
        single_launches = launch_counts(_build.KERNELS)
        require(single_launches == {f"walk_{pipe}": BATCH},
                f"{pipe} singles: launches {single_launches}, want {BATCH}")
        members = apps.split_device_values(vals, BATCH)
        for j in range(BATCH):
            for name, v in singles[j].items():
                require(torch.equal(members[j][name], v),
                        f"{pipe} batch member {j}: {name} differs bitwise from "
                        "its single-launch walk")

        rows = walk_inputs(merged)
        walk = lambda: dag_walk(merged.stages, merged.operands, merged.values, rows, TILE)  # noqa: E731
        plain = lambda: dag_walk_plain(merged.stages, merged.operands,  # noqa: E731
                                       merged.values, rows, TILE)
        got, want = walk(), plain()
        single_rows = [walk_inputs(low) for low in lows]

        def walk_singles():
            for low, r in zip(lows, single_rows):
                dag_walk(low.stages, low.operands, low.values, r, TILE)

        checks, errs, shares = {}, [], []
        chain = {}
        if pipe == "linreg":
            n, d = B_LIN_ROWS, LINREG_COLS - 1
            X1ys = []
            for j, low in enumerate(lows):
                X, y = low.values["X"], low.values["y"]
                X1y = torch.cat([(X - X.mean(0)) / X.std(0, unbiased=False),
                                 torch.ones(n, 1, device=dev), y], dim=1)
                A1y = X1y.abs()
                abs_sum = {"moments": torch.stack([X.abs().sum(0), (X * X).sum(0)]),
                           "syrk_gemv": (A1y.T @ A1y)[:d + 1]}
                # syrk_gemv against the plain stage on the member's own moments
                p_syrk = solo_walk(merged, rows, f"syrk_gemv#{j}", got, plain=True)[1]
                for s, want_s in (("moments", want[f"moments#{j}"]), ("syrk_gemv", p_syrk)):
                    e, r = close(got[f"{s}#{j}"], want_s, abs_sum[s],
                                 n // TILE, f"batched linreg member {j} {s}")
                    errs.append(e)
                    shares.append(r)
                del p_syrk
                X1ys.append(X1y)
                beta = answers[j].astype("float64")
                ref = apps.linear_regression_oracle(n, LINREG_COLS, seed=seeds[j])
                babs = abs(beta - ref)
                require(float(babs[:-1].max()) <= BETA_RTOL * float(abs(ref[:-1]).max())
                        and float(babs[-1].max()) <= BETA_RTOL * float(abs(ref[-1]).max()),
                        f"batched linreg member {j}: beta beyond the oracle's limits")
                checks.setdefault("beta_max_abs_err", []).append(float(babs.max()))
            X1yb = torch.stack(X1ys)
            del X1ys
            library = lambda: torch.bmm(X1yb.transpose(1, 2), X1yb)  # noqa: E731
            library_call = "torch.bmm(X1y^T, X1y) over the 8 members (syrk_gemv only)"
            b_bytes = BATCH * (4 * (n * d + n + 2 * d + (d + 1) * (d + 2))) + 12 * len(rows)
            b_flops = BATCH * (5 * n * d + n * (d + 1) * (d + 2) + 2 * n * (d + 1))
            shapes = f"{BATCH} x X ({n}, {d}) f32, {len(rows)} slots, tile {TILE}"
        else:
            U, I = B_REC_USERS, REC_ITEMS
            Rs = []
            for j, low in enumerate(lows):
                R = low.values["R"]
                for s, a, adds in (("item_norms", (R * R).sum(0), U // TILE),
                                   ("user_bias", R.abs().sum(1) / I, I)):
                    e, r = close(got[f"{s}#{j}"], want[f"{s}#{j}"], a, adds,
                                 f"batched recommendation member {j} {s}")
                    errs.append(e)
                    shares.append(r)
                top = answers[j]["scores"]
                require(torch.equal(top, apps.scores_plain(R, answers[j]["item_norms"],
                                                           answers[j]["user_bias"])),
                        f"batched recommendation member {j}: scores differ bitwise "
                        "from the plain body")
                agree = float((top.cpu().numpy() == apps.recommendation_oracle(
                    U, I, seed=seeds[j])).mean())
                require(agree >= B_REC_AGREEMENT, f"batched recommendation member {j}: "
                                                  f"scores agree on {agree:.6f}")
                checks.setdefault("scores_agreement", []).append(agree)
                Rs.append(R)
            Rb = torch.stack(Rs)
            del Rs
            library = lambda: Rb.square().sum(1)  # noqa: E731
            library_call = "R.square().sum(1) over the 8 members' stacked R (item_norms only)"
            chain = dict(library_chain_ms=timed(lambda: rec_chain(Rb), 10),
                         library_chain_call=REC_CHAIN_CALL + ", over the 8 members' "
                                                             "stacked R")
            b_bytes = BATCH * rec_bytes(U, I) + 12 * len(rows)
            b_flops = BATCH * (6 * U * I + 2 * I)
            shapes = f"{BATCH} x R ({U}, {I}) f32, {len(rows)} slots, tile {TILE}"
        for name in got:
            require(torch.equal(got[name], vals[name]),
                    f"{pipe} batch: {name} differs from the main path's walk")
        ms = timed(walk, 5)
        singles_ms = timed(walk_singles, 5)
        emit("batched", pipeline=pipe, members=BATCH, slots=len(rows),
             batch_launches=batch_launches, single_launches=single_launches,
             batch_ms=ms, singles_ms=singles_ms, batch_seconds=batch_s,
             singles_seconds=singles_s, lowering_seconds=lowering_s,
             members_bitwise_equal_to_singles=True,
             sum_tol="eps32 * sqrt(adds) * sum|terms|",
             worst_share_of_limit=max(shares), checks=checks)
        rows_out.append(dict(
            name=f"dag_walk[{pipe}, batched x{BATCH}]", route="cuda",
            source="src/repro_torch/csrc/dag_walk.cu",
            replaces="src/repro/kernels/dag_walk.py:218 (batched, "
                     "src/repro/vee/apps.py:485)",
            launches=batch_launches[f"walk_{pipe}"], max_abs_err=max(errs), ms=ms,
            **kernel_device_ms(walk),
            singles_ms=singles_ms, plain_ms=timed(plain, 1, warmup=0),
            library_ms=timed(library, 10), library_call=library_call, shapes=shapes,
            **chain, **dict(zip(("bound_ms", "bound_by"), bound_ms(b_bytes, b_flops)))))
    return rows_out


def cc_iteration_phase(G, c, step) -> dict:
    """One CC iteration on the walker's CC-iteration program, 1 and 2
    shards, one launch each; bitwise against ``cc_propagate_ref``, the CC
    step ``step`` (K2) and the plain walk. Returns the kernel's row."""
    import torch

    from repro_torch.core.device_schedule import build_dag_tables_cached
    from repro_torch.kernels import _build
    from repro_torch.kernels.dag_walk import (dag_walk, dag_walk_plain,
                                              dag_walk_stagewise, fold_plan, sync_flags)
    from repro_torch.kernels.ref import cc_propagate_ref
    from repro_torch.vee import apps

    n = G.shape[0]
    want = cc_propagate_ref(G, c)
    flips = int((want != c).sum())
    runs = {}
    for n_shards in (1, 2):
        for k in _build.KERNELS:
            k.launches.clear()
        t = time.perf_counter()
        out = apps.cc_iteration_device(G, c, n_shards=n_shards)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = launch_counts(_build.KERNELS)
        require(launches == {"walk_cc": n_shards},
                f"cc_iteration, {n_shards} shards: launches {launches}")
        require(torch.equal(out["propagate"], want),
                f"cc_iteration, {n_shards} shards: labels differ from cc_propagate_ref")
        require(torch.equal(out["propagate"], step),
                f"cc_iteration, {n_shards} shards: labels differ from the CC step")
        require(int(out["changed"][0]) == flips,
                f"cc_iteration, {n_shards} shards: changed {int(out['changed'][0])} "
                f"!= {flips}")
        runs[n_shards] = dict(launches=launches, seconds=seconds)
    dag, stages, operands = apps.cc_iteration_lowering(n)
    table = build_dag_tables_cached(dag, 256, apps.CC_TECHNIQUES, n_workers=4).tables[0]
    values = {"G": G, "c_col": c, "c_row": c}
    walk = lambda: dag_walk(stages, operands, values, table, 256)  # noqa: E731
    plain = lambda: dag_walk_plain(stages, operands, values, table, 256)  # noqa: E731
    got, ref = walk(), plain()
    for name in got:
        require(torch.equal(got[name], ref[name]), f"cc_iteration walk {name} != plain")
    # stagewise: `changed` alone reads the labels of an earlier launch (its
    # owner body); the same bits
    sw = dag_walk_stagewise(stages, operands, values, table, 256)
    for name in got:
        require(torch.equal(sw[name], ref[name]), f"cc_iteration stagewise {name} != plain")
    slots = {s.name: int(((table[:, 0] == i) & (table[:, 2] > 0)).sum())
             for i, s in enumerate(stages)}
    plan = fold_plan(stages, table)
    emit("cc_iteration", n=n, tiles=[256, 1024], inner_steps=stages[0].inner,
         slots=slots, changed=flips, bitwise=True, stagewise_bitwise=True,
         barriers=int(plan.flags.sum()), counted_slots=int(plan.counts.sum()),
         barriers_without_count_fusion=int(sync_flags(stages, table).sum()),
         runs={str(k): v for k, v in runs.items()})
    cc_bytes = 4 * (n * n + 3 * n + 1) + 12 * len(table)
    return dict(
        name="dag_walk[cc_iteration]", route="cuda",
        source="src/repro_torch/csrc/dag_walk.cu",
        replaces="src/repro/kernels/dag_walk.py:218 (CC-iteration program, "
                 "tests/test_device_dag.py:193)",
        launches=runs[1]["launches"]["walk_cc"], max_abs_err=max_err(got["propagate"], want),
        ms=timed(walk, 20), **kernel_device_ms(walk), plain_ms=timed(plain, 3),
        library_ms=timed(lambda: torch.maximum((G * c).amax(1), c), 10),
        library_call="torch.maximum((G * c).amax(1), c) (propagate only)",
        shapes=f"G ({n}, {n}) f32, {len(table)} slots, tiles 256 x 1024",
        **dict(zip(("bound_ms", "bound_by"), bound_ms(cc_bytes, 2 * n * n + 2 * n))))


def paper_entry_points_phase(graph, G, c, lin, lin_rows, stage_device_ms: dict,
                             fused_device_ms, beta_dev, beta_ref, beta_limits) -> None:
    """The paper's host entry points beside the card, at the smoke's sizes.

    Listing 2 (``linear_regression``) on the VEE's host pool at Fig. 10's
    size, held to the float64 oracle and to ``linear_regression_device``'s
    beta within the end-to-end limits ``beta_limits``. Listing 1
    (``connected_components``) on the host pool over the CSR ``graph`` to
    convergence, its labels and iteration count bitwise those of a loop of
    ``cc_iteration_device`` on the card until no label flips. The device
    tuner (``select_offline_device_dag``, Listing 1's per-row costs) picks
    the CC iteration's techniques on 2 shards, and persistent re-balancing
    (``rebalance_dag`` on the per-chunk nnz) moves chunks of a contiguous
    assignment; each table is walked on the card (``dag_walk_sharded``),
    bitwise ``cc_propagate_ref`` with exact flips. ``frozen_dag_makespans``
    on the linreg table, with costs spread from the walker's measured
    per-stage device ms, printed beside the measured fused and stagewise
    walks. The coordinator (2 nodes x 4 workers) runs Listing 1's first
    propagation, then again with a node killed; both bitwise
    ``cc_step_numpy``. Launch counters are set to 0 before each card drive
    and read after it. Prints one line, ``paper_entry_points``."""
    import numpy as np
    import torch

    from repro_torch.core import (Coordinator, CoordinatorConfig, SchedulerConfig,
                                  build_dag_tables, build_dag_tables_cached,
                                  frozen_dag_makespans, rebalance_dag,
                                  select_offline_device_dag)
    from repro_torch.kernels import _build
    from repro_torch.kernels.dag_walk import dag_walk_sharded, dag_walk_stagewise
    from repro_torch.kernels.ref import cc_propagate_ref
    from repro_torch.vee import apps

    t_phase = time.perf_counter()
    out = {}

    def zero_counts():
        for k in _build.KERNELS:
            k.launches.clear()

    # Listing 2 on the VEE
    feat_lim, icpt_lim = beta_limits
    t = time.perf_counter()
    beta_vee, hist = apps.linear_regression(
        LINREG_ROWS, LINREG_COLS, SchedulerConfig(technique="GSS", n_workers=PAPER_WORKERS))
    seconds = time.perf_counter() - t
    errs = {}
    for what, other in (("oracle", beta_ref), ("device", beta_dev.astype("float64"))):
        diff = np.abs(beta_vee - other)
        errs[what] = [float(diff[:-1].max()), float(diff[-1].max())]
        require(errs[what][0] <= feat_lim and errs[what][1] <= icpt_lim,
                f"listing 2 on the VEE: beta vs the {what} {errs[what]} beyond "
                f"{[feat_lim, icpt_lim]}")
    out["listing2"] = dict(seconds=seconds, chunks=len(hist[0].schedule),
                           feature_and_intercept_abs_err=errs,
                           limits=[feat_lim, icpt_lim])

    # Listing 1 on the VEE, and the same loop on the card
    n = graph.n_rows
    t = time.perf_counter()
    labels, iters, _ = apps.connected_components(
        graph, SchedulerConfig(technique="MFSC", n_workers=PAPER_WORKERS))
    host_s = time.perf_counter() - t
    zero_counts()
    t = time.perf_counter()
    cd, dev_iters = c, 0
    while dev_iters < 100:
        o = apps.cc_iteration_device(G, cd)
        dev_iters += 1
        cd = o["propagate"]
        if int(o["changed"][0]) == 0:
            break
    dev_s = time.perf_counter() - t
    launches = launch_counts(_build.KERNELS)
    require(launches == {"walk_cc": dev_iters},
            f"listing 1 on the card: launches {launches}, want {dev_iters} walk_cc")
    require(dev_iters == iters, f"listing 1: {iters} iterations on the VEE, "
                                f"{dev_iters} on the card")
    dev_labels = cd.cpu().numpy()
    require(np.array_equal(dev_labels.astype(np.int64), labels)
            and np.array_equal(labels.astype(np.float32), dev_labels),
            "listing 1: the VEE's labels differ from the card's")
    out["listing1"] = dict(iterations=iters, components=int(len(np.unique(labels))),
                           host_seconds=host_s, card_seconds=dev_s, launches=launches)

    # the device tuner's table, walked
    want = cc_propagate_ref(G, c)
    flips = int((want != c).sum())
    dag, stages, operands = apps.cc_iteration_lowering(n, CC_TILE)
    values = {"G": G, "c_col": c, "c_row": c}
    nnz = graph.row_nnz()
    t = time.perf_counter()
    techs, tuned_ms, uniform = select_offline_device_dag(
        dag, {"propagate": (nnz + 1).astype(np.float64)}, tile=CC_TILE,
        n_shards=PAPER_SHARDS)
    tune_s = time.perf_counter() - t
    require(tuned_ms <= min(uniform.values()), "the device tuner lost to a uniform technique")

    def walked(tables, what):
        zero_counts()
        got = dag_walk_sharded(stages, operands, values, tables, CC_TILE)
        counts = launch_counts(_build.KERNELS)
        require(counts == {"walk_cc": tables.shape[0]},
                f"{what}: launches {counts}, want {tables.shape[0]} walk_cc")
        require(torch.equal(got["propagate"], want), f"{what}: labels differ from "
                                                     "cc_propagate_ref")
        require(int(got["changed"][0]) == flips, f"{what}: changed "
                                                 f"{int(got['changed'][0])} != {flips}")
        walk = lambda: dag_walk_sharded(stages, operands, values, tables, CC_TILE)  # noqa: E731
        return dict(launches=counts, slots=int((tables[:, :, 2] > 0).sum()),
                    **kernel_device_ms(walk))

    tuned = build_dag_tables_cached(dag, CC_TILE, techs, n_shards=PAPER_SHARDS)
    out["tuned_walk"] = dict(techniques=techs, simulated_makespan=tuned_ms,
                             best_uniform=min(uniform.values()), tune_seconds=tune_s,
                             **walked(tuned.tables, "the tuned table"))

    # persistent re-balancing's table, walked
    def chunk_nnz(d):
        return {name: np.array([nnz[s * CC_TILE:(s + z) * CC_TILE].sum()
                                for s, z in d.stage_chunks[name]], dtype=np.float64)
                for name in d.stage_names}

    def shard_loads(d):
        load = np.zeros(d.n_shards)
        for name, per_chunk in chunk_nnz(d).items():
            np.add.at(load, d.chunk_shard[name], per_chunk)
        return load

    old = build_dag_tables(dag, CC_TILE, techs, n_shards=PAPER_SHARDS, n_workers=4,
                           assignment="contiguous")
    new = rebalance_dag(old, chunk_nnz(old))
    old_load, new_load = shard_loads(old), shard_loads(new)
    require(new_load.max() < old_load.max(), f"re-balancing did not lower the largest "
                                             f"shard load: {old_load} -> {new_load}")
    out["rebalance"] = dict(
        shard_nnz_before=old_load.tolist(), shard_nnz_after=new_load.tolist(),
        before=walked(old.tables, "the contiguous table"),
        after=walked(new.tables, "the re-balanced table"))

    # the simulator beside the card: the linreg table walked above
    ddt = build_dag_tables_cached(lin.dag, 1, None)
    costs = {}
    for name in ddt.stage_names:
        ms_ = stage_device_ms[name]["device_ms"]
        require(isinstance(ms_, float), f"walk_stages measured no device ms for {name}")
        units = lin.dag.stages[name].n_rows
        costs[name] = np.full(units, ms_ / 1e3 / units)
    sim_fused, sim_seq = frozen_dag_makespans(ddt, costs)
    require(sim_fused <= sim_seq, f"simulated fused {sim_fused} > sequential {sim_seq}")
    stagewise = kernel_device_ms(lambda: dag_walk_stagewise(
        lin.stages, lin.operands, lin.values, lin_rows, TILE))
    out["simulator"] = dict(
        table_slots=int(len(ddt.slots(0))), stage_device_ms={
            k: stage_device_ms[k]["device_ms"] for k in ddt.stage_names},
        simulated_fused_ms=sim_fused * 1e3, simulated_sequential_ms=sim_seq * 1e3,
        measured_fused_device_ms=fused_device_ms,
        measured_stagewise_device_ms=stagewise["device_ms"],
        stagewise_launches_per_call=stagewise["device_launches_per_call"])

    # the coordinator: Listing 1's first propagation, then with a node down
    c_host = np.arange(1, n + 1, dtype=np.int64)
    step = apps.cc_step_numpy(graph, c_host)
    require(np.array_equal(step.astype(np.float32), want.cpu().numpy()),
            "cc_step_numpy differs from cc_propagate_ref")
    co = Coordinator(CoordinatorConfig(n_nodes=COORD_NODES, node_workers=COORD_WORKERS))
    co.broadcast("c", c_host)
    co.ship_program(lambda store, s, z: graph.row_max_gather(store["c"], s, s + z))
    runs = {}
    for killed in (None, COORD_NODES - 1):
        if killed is not None:
            co.kill_node(killed)
        t = time.perf_counter()
        parts = co.run(n)
        rows = np.concatenate([parts[k] for k in sorted(parts)])
        require(np.array_equal(rows, step), f"coordinator (node killed: {killed}): rows "
                                            "differ from cc_step_numpy")
        runs["one_node_down" if killed is not None else "all_nodes"] = dict(
            ranges=len(parts), seconds=time.perf_counter() - t)
    out["coordinator"] = dict(nodes=COORD_NODES, workers=COORD_WORKERS, **runs)
    emit("paper_entry_points", **out, seconds=time.perf_counter() - t_phase)


def server_telemetry_phase(dev, lin, lin_rows, lin_stamps, stage_device_ms: dict,
                           beta_dev, beta_limits) -> None:
    """Telemetry, co-execution and the multi-tenant server, on the card.

    The walk trace: the main path's linreg stamps (one row a slot of the
    1,000,000 x 101 walk) folded into device spans by ``device_walk_spans``,
    each stage's measured device ms spread evenly over its rows; one span a
    live slot, a Chrome trace that validates, and a critical path that
    telescopes to the span sum and reconciles with the spans' ``DagStats``
    (an identity: the spans' times are the measured ms, shared out).
    Co-execution: ``linear_regression_hetero`` at the same size on a
    lowering on ``dev``, 8 host workers and one walker lane, its costs from
    ``calibrate_hetero_costs`` (device rates: the walker's per-stage device
    ms; host rates: the chunk times of a host-only one-worker SS run of the
    131,072 x 101 lowering, a tile's cost not depending on the row count);
    the lane must launch K1 for its runs, and the beta lie within the
    smoke's linreg limits ``beta_limits`` of the K1 walk's ``beta_dev``.
    The server: ``serve --mode pipelines --compare`` on 8 workers with
    ``--trace-out`` and ``--metrics-out`` (every job drained under each
    arbiter, every chunk once, the trace valid, the metrics JSON and the
    Prometheus text parsed), then the mixed set again with the 131,072 x
    101 linreg job placed all on the walker lane (``n_device=1``, the
    submission carrying its lowering): the lane launches K1 in the server
    and in the job's solo ``HeteroExecutor`` run, both within ``SUM_RTOL``
    of the host-only run's sums, and the three betas within the linreg
    limits of one another. Prints the launcher's lines, then
    ``server_arbiters`` (each arbiter's makespan, p50 and p99 job latency)
    and ``server_telemetry``."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import (DagStats, HeteroExecutor, PipelineExecutor,
                                  PipelineServer, Placement, SchedulerConfig,
                                  Submission, Tracer, analyze_critical_path,
                                  calibrate_hetero_costs, device_walk_spans, make,
                                  select_placement, validate_chrome_trace)
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.vee import apps

    t_phase = time.perf_counter()
    out = {}
    feat_lim, icpt_lim = beta_limits

    def exactly_once(res, subs, what):
        for sub in subs:
            for name in sub.dag.stage_names:
                spans = sorted((e.start, e.size) for e in res.events
                               if e.job == sub.name and e.stage == name)
                ends = np.cumsum([0] + [z for _, z in spans])
                require([s_ for s_, _ in spans] == list(ends[:-1])
                        and ends[-1] == sub.dag.stages[name].n_rows,
                        f"{what}: {sub.name}/{name} not run exactly once")
        require(sorted(res.jobs) == sorted(s_.name for s_ in subs),
                f"{what}: jobs {sorted(res.jobs)} did not all drain")

    # the walk trace
    names = [st.name for st in lin.stages]
    stage_ms = {k: stage_device_ms[k]["device_ms"] for k in names}
    require(all(isinstance(v, float) and v > 0 for v in stage_ms.values()),
            f"walk_stages measured no device ms: {stage_ms}")
    row_costs = {k: np.full(LINREG_ROWS, stage_ms[k] / 1e3 / LINREG_ROWS) for k in names}
    tracer = Tracer(job="linreg_walk")
    t = time.perf_counter()
    n_spans = device_walk_spans(lin_stamps, names, tracer, row_costs=row_costs)
    live = int((lin_rows[:, 2] > 0).sum())
    require(n_spans == live, f"walk trace: {n_spans} spans for {live} live slots")
    problems = validate_chrome_trace(tracer.to_chrome_trace())
    require(problems == [], f"walk trace: {problems[:3]}")
    execs = [sp for sp in tracer.spans() if sp.kind == "exec"]
    require(all(sp.device for sp in execs), "walk trace: a span without F_DEVICE")
    stats = DagStats()
    for sp in execs:
        stats.add_chunk(sp.stage, sp.dur)
    span_sum = sum(sp.dur for sp in execs)
    cp = analyze_critical_path(tracer)
    cp.reconcile(stats, span_sum)
    require(abs(cp.total - span_sum) <= 1e-9 * span_sum,
            f"walk trace: critical path {cp.total} != span sum {span_sum}")
    for k in names:
        require(abs(cp.exec_s[k] * 1e3 - stage_ms[k]) <= 1e-6 * stage_ms[k],
                f"walk trace: {k} on the path {cp.exec_s[k] * 1e3} ms, measured "
                f"{stage_ms[k]} ms")
    out["walk_trace"] = dict(spans=n_spans, span_sum_ms=span_sum * 1e3,
                             critical_path_ms={k: v * 1e3 for k, v in cp.exec_s.items()},
                             seconds=time.perf_counter() - t)

    # co-execution: device rates from the card, host rates from a host-only
    # one-worker run of the 131,072 x 101 lowering (per tile, as at full size)
    walks = lambda: _build.DAG_WALK.launches["walk_linreg"]  # noqa: E731
    low_b = apps.linreg_device_lowering(B_LIN_ROWS, LINREG_COLS, tile=TILE, device=dev)
    ref_b = apps.linear_regression_oracle(B_LIN_ROWS, LINREG_COLS)
    lim_b = (BETA_RTOL * float(abs(ref_b[:-1]).max()), BETA_RTOL * float(abs(ref_b[-1]).max()))

    def beta_err(got, want):
        b_abs = np.abs(np.asarray(got, "float64") - np.asarray(want, "float64"))
        return [float(b_abs[:-1].max()), float(b_abs[-1].max())]

    def within(err, lim, what):
        require(err[0] <= lim[0] and err[1] <= lim[1], f"{what}: beta off by {err}, "
                                                       f"limits {list(lim)}")

    ss1 = SchedulerConfig(technique="SS", queue_layout="CENTRALIZED", n_workers=1)
    t = time.perf_counter()
    host = PipelineExecutor(low_b.dag, ss1).run()
    host_s = time.perf_counter() - t
    beta_host = low_b.finalize(host.values)
    within(beta_err(beta_host, ref_b), lim_b, "the host-only run")
    host_costs, device_costs = {}, {}
    for k in names:
        r = host.stages[k]
        sizes = np.asarray(r.schedule).reshape(-1, 2)[:, 1]
        units = lin.dag.stages[k].n_rows
        host_costs[k] = np.full(units, float(np.sum(r.per_task_costs)) / float(sizes.sum()))
        device_costs[k] = np.full(units, stage_ms[k] / 1e3 / units)
    cm = calibrate_hetero_costs(lin.dag, host_costs=host_costs, device_costs=device_costs)
    t = time.perf_counter()
    placement, sim_makespan, baselines = select_placement(lin.dag, cm, n_workers=PAPER_WORKERS,
                                                          passes=1)
    solve_s = time.perf_counter() - t
    dev_rows = sum(placement.device_rows(k, lin.dag.stages[k].n_rows) for k in names)
    require(dev_rows > 0, f"co-execution: the solver put no row on the card ({placement})")
    w0 = walks()
    t = time.perf_counter()
    beta_het, het, chosen = apps.linear_regression_hetero(
        LINREG_ROWS, LINREG_COLS, SchedulerConfig(n_workers=PAPER_WORKERS), costs=cm,
        n_device=1, device=dev)
    het_s = time.perf_counter() - t
    het_walks, lane_chunks = walks() - w0, het.per_worker_tasks[-1]
    require(chosen.describe() == placement.describe(),
            f"co-execution solved {chosen} where the smoke solved {placement}")
    # the lane walks a run of its shard a launch on the card
    require(lane_chunks > 0 and 0 < het_walks <= lane_chunks,
            f"co-execution: the walker lane ran {lane_chunks} chunks in {het_walks} launches")
    het_err = beta_err(beta_het, beta_dev)
    within(het_err, (feat_lim, icpt_lim), "co-execution against the K1 walk")
    out["coexecution"] = dict(
        placement=chosen.describe(), simulated_makespan_s=sim_makespan,
        simulated_baselines_s=baselines, solve_seconds=solve_s,
        measured_seconds=het_s, host_only_rows=B_LIN_ROWS, host_only_seconds=host_s,
        host_s_per_tile={k: float(host_costs[k][0]) for k in names},
        device_s_per_tile={k: float(device_costs[k][0]) for k in names},
        chunks=len(het.events), device_lane_chunks=lane_chunks, walker_launches=het_walks,
        absorbed_by_host=het.absorbed_by_host, absorbed_by_device=het.absorbed_by_device,
        beta_vs_walk_abs_err=het_err, limits=[feat_lim, icpt_lim])
    del het

    # the server: the launcher's mixed set under the four arbiters
    with tempfile.TemporaryDirectory() as tmp:
        trace_p, metrics_p = Path(tmp) / "trace.json", Path(tmp) / "metrics.json"
        t = time.perf_counter()
        runs = serve.main(["--mode", "pipelines", "--workers", str(PAPER_WORKERS),
                           "--compare", "--trace-out", str(trace_p),
                           "--metrics-out", str(metrics_p)])
        serve_s = time.perf_counter() - t
        require(list(runs) == ["fifo", "priority", "fair", "preemptive"],
                f"serve --compare ran {list(runs)}")
        arbiters = {}
        for arb, (res, subs, _, _) in runs.items():
            exactly_once(res, subs, f"serve --arbiter {arb}")
            arbiters[arb] = dict(makespan_ms=res.makespan_s * 1e3,
                                 p50_ms=res.latency_percentile(50) * 1e3,
                                 p99_ms=res.latency_percentile(99) * 1e3,
                                 chunks=len(res.events), steals=res.steals,
                                 preemptions=len(res.preemptions))
        trace = json.loads(trace_p.read_text())
        problems = validate_chrome_trace(trace)
        require(problems == [], f"serve --trace-out: {problems[:3]}")
        snap = json.loads(metrics_p.read_text())
        require(snap["counters"]["sched_chunks"] == len(runs["preemptive"][0].events),
                "serve --metrics-out: sched_chunks differs from the run's chunks")
        prom = metrics_p.with_suffix(".prom").read_text().splitlines()
        samples = [ln for ln in prom if ln and not ln.startswith("#")]
        require(samples and all(math.isfinite(float(ln.rsplit(" ", 1)[1]))
                                for ln in samples), "serve --metrics-out: bad .prom")
    emit("server_arbiters", arbiters=arbiters)
    out["server"] = dict(arbiters=arbiters, seconds=serve_s, trace_events=len(
        trace["traceEvents"]), prometheus_samples=len(samples))

    # one more job: linreg on the card's lowering, placed all on the device lane
    lnames = low_b.dag.stage_names
    all_dev = Placement.all_device(lnames)
    subs = serve._pipeline_submissions() + [Submission(
        dag=low_b.dag, name="linreg_device", tenant="ml", placement=all_dev,
        per_stage={k: ("SS", "CENTRALIZED", "SEQ") for k in lnames}, lowering=low_b)]
    w0 = walks()
    t = time.perf_counter()
    res = PipelineServer(make("config", "gss/percore", n_workers=PAPER_WORKERS),
                         arbiter="fair", n_device=1).serve(subs)
    placed_s = time.perf_counter() - t
    placed_walks = walks() - w0
    exactly_once(res, subs, "the placed job's server")
    lane = sum(1 for e in res.events if e.worker >= PAPER_WORKERS and e.job == "linreg_device")
    require(lane > 0 and 0 < placed_walks <= lane,
            f"the placed job: the walker lane ran {lane} chunks in {placed_walks} launches")
    w0 = walks()
    solo = HeteroExecutor(low_b.dag, SchedulerConfig(technique="SS", n_workers=PAPER_WORKERS),
                          all_dev, n_device=1, lowering=low_b).run()
    solo_walks = walks() - w0
    require(solo.per_worker_tasks[-1] > 0 and solo_walks > 0,
            f"the placed job's solo run: {solo_walks} walker launches")
    placed = res.jobs["linreg_device"].values
    for k in lnames:
        want = host.values[k].double()
        lim = SUM_RTOL * float(want.abs().max())
        for what, got in (("server", placed[k]), ("solo", solo.values[k])):
            err = float((got.double() - want).abs().max())
            require(err <= lim, f"the placed job's {what} {k} off the host-only run's "
                                f"by {err} > {lim}")
    beta_placed, beta_solo = low_b.finalize(placed), low_b.finalize(solo.values)
    errs = {what: beta_err(b_, want) for what, b_, want in (
        ("server_vs_solo", beta_placed, beta_solo), ("server_vs_host", beta_placed, beta_host),
        ("solo_vs_host", beta_solo, beta_host))}
    for what, err in errs.items():
        within(err, lim_b, f"the placed job ({what})")
    out["placed_job"] = dict(
        rows=B_LIN_ROWS, seconds=placed_s, makespan_ms=res.makespan_s * 1e3,
        device_lane_chunks=lane, walker_launches=placed_walks, solo_walker_launches=solo_walks,
        placed_job_chunks=res.jobs["linreg_device"].n_tasks, beta_abs_err=errs,
        limits=list(lim_b))
    emit("server_telemetry", **out, seconds=time.perf_counter() - t_phase)
    return cm


def front_door_phase(dev, lin, beta_dev, beta_limits, costs) -> dict:
    """The serving front door, its replays and its tuners, beside the card.

    Open loop, in virtual time on the host: ``serve --mode openloop
    --requests 800 --workers 8`` (the ``pipeline_server_openloop`` row's
    settings: ``heavy_tailed_trace(seed=3, load=1.5, n_workers=8)``, FIFO
    against the fair front door with the etl tenant's ``TokenBucket(400,
    20)``, ``BatchPolicy(2e-3, 8)`` and a ``FeedbackLog``), which must keep
    the reference's property: the front door's p99.9 no worse than FIFO's
    and its deadline hit rate no lower. Then ``load=5.0``, fair against
    ``preemptive`` (``bench_preemptive``'s settings), whose hit rate must
    be no lower. ``FrontDoor`` on the real pool, 8 host workers (technique
    SS) and one walker lane: the launcher's mixed set (``_pipeline_
    submissions``, the recommendation passes without their deadline, whose
    unit declared costs would shed them, so the two coalesce in a 20 ms
    window), an expired copy of a pass that admission sheds, and the
    linreg job on ``lin`` (the main path's lowering on the card) placed all
    on the lane with its lowering: every admitted host member bitwise its
    one-worker SS run, the placed job's beta within ``beta_limits`` of the
    K1 walk's ``beta_dev``, at least one K1 launch, exactly the lane's
    chunks of the placed job flagged ``F_DEVICE``, every chunk once. The
    tuners on ``costs`` (``calibrate_hetero_costs`` of the walker's
    per-stage device ms, from ``server_telemetry``): ``select_offline_
    hetero``, ``tune_online_hetero``, ``replay_online_hetero``, the chosen
    placement run once through ``HeteroExecutor`` at tile granularity
    (technique SS, as ``linear_regression_hetero`` runs it; predicted and measured
    seconds printed side by side; nothing claimed), and ``simulate_server``
    and ``select_offline_server`` on the mixed set. Last, ``serving_pair()``
    at its defaults on ``dev``: each model's logits bitwise the direct
    composition of the same per-row functions on the card."""
    import numpy as np

    from repro_torch.core import (AdmissionController, BatchPolicy, FrontDoor,
                                  HeteroExecutor, OnlineScheduler, PipelineExecutor,
                                  Placement, SchedulerConfig, Submission, Tracer,
                                  default_hetero_arms, heavy_tailed_trace,
                                  replay_online_hetero, replay_open_loop,
                                  select_offline_hetero, select_offline_server,
                                  simulate_server, tune_online_hetero)
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.vee import ml_apps

    t_phase = time.perf_counter()
    out = {}

    def summary(r, seconds):
        return dict(p50_ms=r.latency_percentile(50) * 1e3,
                    p99_ms=r.latency_percentile(99) * 1e3,
                    p999_ms=r.latency_percentile(99.9) * 1e3,
                    hit_rate=r.deadline_hit_rate(), shed_rate=r.shed_rate,
                    batches=r.n_batches, coalesced=r.n_coalesced,
                    preemptions=len(r.preemptions), jobs=r.n_jobs,
                    host_seconds=seconds)

    # the open loop: the launcher's replay pair, then the pressured trace
    t = time.perf_counter()
    runs = serve.main(["--mode", "openloop", "--requests", str(OPENLOOP_REQUESTS),
                       "--workers", str(PAPER_WORKERS)])
    open_s = time.perf_counter() - t
    base, front = runs["fifo baseline"], runs["front door"]
    require(front.latency_percentile(99.9) <= base.latency_percentile(99.9)
            and front.deadline_hit_rate() >= base.deadline_hit_rate(),
            f"open loop: the front door (p99.9 {front.latency_percentile(99.9)}, hit "
            f"{front.deadline_hit_rate()}) is worse than FIFO's (p99.9 "
            f"{base.latency_percentile(99.9)}, hit {base.deadline_hit_rate()})")
    require(front.n_batches > 0, "open loop: the front door coalesced nothing")
    out["openloop"] = dict(load=1.5, workers=PAPER_WORKERS, seconds=open_s,
                           fifo=summary(base, None), front_door=summary(front, None))
    trace = heavy_tailed_trace(PRESSURED_REQUESTS, seed=3, load=5.0,
                               n_workers=PAPER_WORKERS)
    pressured = {}
    for arb, kw in (("fair", None), ("preemptive", {"inner": "fair",
                                                     "n_workers": PAPER_WORKERS,
                                                     "slack_s": 0.5})):
        t = time.perf_counter()
        r = replay_open_loop(trace, n_workers=PAPER_WORKERS, arbiter=arb, arbiter_kwargs=kw)
        pressured[arb] = (r, time.perf_counter() - t)
    require(pressured["preemptive"][0].deadline_hit_rate()
            >= pressured["fair"][0].deadline_hit_rate(),
            "load 5.0: preemptive's hit rate is below fair's")
    out["pressured"] = dict(load=5.0, workers=PAPER_WORKERS, **{
        arb: summary(r, sec) for arb, (r, sec) in pressured.items()})

    # FrontDoor on the real pool, a placed job walking K1 on the lane
    walks = lambda: _build.DAG_WALK.launches["walk_linreg"]  # noqa: E731
    feat_lim, icpt_lim = beta_limits
    mixed = [s.replace(deadline_s=None) if s.name.startswith("recommend") else s
             for s in serve._pipeline_submissions()]
    expired = mixed[2].replace(name="recommend_late", arrival_s=0.015, deadline_s=0.0)
    lnames = lin.dag.stage_names
    placed = Submission(dag=lin.dag, name="linreg_placed", tenant="ml", arrival_s=0.005,
                        placement=Placement.all_device(lnames),
                        per_stage={k: ("SS", "CENTRALIZED", "SEQ") for k in lnames},
                        lowering=lin)
    subs = mixed + [expired, placed]
    tracer = Tracer()
    fd = FrontDoor(SchedulerConfig(technique="SS", n_workers=PAPER_WORKERS),
                   admission=AdmissionController(),
                   batching=BatchPolicy(window_s=2e-2, max_batch=8), tracer=tracer)
    w0 = walks()
    t = time.perf_counter()
    res = fd.serve(subs)
    fd_s = time.perf_counter() - t
    fd_walks = walks() - w0
    srv = res.server_result
    require(res.shed == {"recommend_late": "expired"}, f"FrontDoor shed {res.shed}")
    require(res.n_batches == 1 and "batch1(recommend_1x2)" in srv.jobs,
            f"FrontDoor launched {sorted(srv.jobs)}")
    require(sorted(res.jobs) == sorted(s.name for s in subs if s.name != "recommend_late"),
            f"FrontDoor returned {sorted(res.jobs)}")
    dag_of = {s_.name: s_.dag for s_ in subs}   # the batch: recommend_1's shape
    for launch, r in srv.jobs.items():
        dag = dag_of.get(launch, dag_of["recommend_1"])
        for name in r.values:
            spans = sorted((e.start, e.size) for e in srv.events
                           if e.job == launch and e.stage == name)
            ends = np.cumsum([0] + [z for _, z in spans])
            require([s_ for s_, _ in spans] == list(ends[:-1])
                    and ends[-1] == dag.stages[name.split("#")[0]].n_rows,
                    f"FrontDoor: {launch}/{name} not run exactly once")
        require(r.n_tasks == sum(1 for e in srv.events if e.job == launch),
                f"FrontDoor: {launch}'s task count")
    t = time.perf_counter()
    ss1 = SchedulerConfig(technique="SS", n_workers=1)
    for sub in mixed:
        solo = PipelineExecutor(sub.dag, ss1).run()
        for k, want in solo.values.items():
            require(np.array_equal(np.asarray(res.jobs[sub.name].values[k]),
                                   np.asarray(want)),
                    f"FrontDoor: {sub.name}/{k} differs from its one-worker SS run")
    solo_s = time.perf_counter() - t
    lane = [e for e in srv.events if e.worker >= PAPER_WORKERS and e.job == "linreg_placed"]
    require(lane and 0 < fd_walks <= len(lane),
            f"FrontDoor: the walker lane ran {len(lane)} chunks in {fd_walks} K1 launches")
    flagged = {(s_.job, s_.stage, s_.chunk) for s_ in tracer.spans()
               if s_.kind == "exec" and s_.device}
    require(flagged == {(e.job, e.stage, e.task_id) for e in lane},
            "FrontDoor: F_DEVICE is not exactly on the lane's chunks of the placed job")
    beta_fd = lin.finalize(res.jobs["linreg_placed"].values)
    b_abs = np.abs(np.asarray(beta_fd, "float64") - np.asarray(beta_dev, "float64"))
    fd_err = [float(b_abs[:-1].max()), float(b_abs[-1].max())]
    require(fd_err[0] <= feat_lim and fd_err[1] <= icpt_lim,
            f"FrontDoor: the placed job's beta off the K1 walk's by {fd_err}, limits "
            f"{[feat_lim, icpt_lim]}")
    out["front_door_pool"] = dict(
        host_workers=PAPER_WORKERS, device_lanes=1, seconds=fd_s, launches=sorted(srv.jobs),
        shed=res.shed, batches=res.n_batches, chunks=len(srv.events),
        placed_chunks=res.jobs["linreg_placed"].n_tasks, device_lane_chunks=len(lane),
        walker_launches=fd_walks, beta_vs_walk_abs_err=fd_err,
        limits=[feat_lim, icpt_lim], solo_runs_seconds=solo_s)

    # the tuners on the walker's measured per-stage device ms
    t = time.perf_counter()
    placement, predicted, baselines = select_offline_hetero(lin.dag, costs,
                                                            n_workers=PAPER_WORKERS, passes=1)
    tuned = tune_online_hetero(lin.dag, costs, n_workers=PAPER_WORKERS, seed=0)
    online = OnlineScheduler(arms=default_hetero_arms(False), resize=False, seed=0)
    hist = replay_online_hetero(lin.dag, costs, online, rounds=24, n_workers=PAPER_WORKERS)
    tune_s = time.perf_counter() - t
    w0 = walks()
    t = time.perf_counter()
    het = HeteroExecutor(lin.dag, SchedulerConfig(technique="SS", n_workers=PAPER_WORKERS),
                         placement, n_device=1, lowering=lin).run()
    het_s = time.perf_counter() - t
    het_walks = walks() - w0
    dev_rows = sum(placement.device_rows(k, lin.dag.stages[k].n_rows) for k in lnames)
    require(het_walks > 0 or dev_rows == 0 or het.per_worker_tasks[-1] == 0,
            f"the tuned placement ({placement.describe()}): the lane walked nothing")
    b_abs = np.abs(np.asarray(lin.finalize(het.values), "float64")
                   - np.asarray(beta_dev, "float64"))
    het_err = [float(b_abs[:-1].max()), float(b_abs[-1].max())]
    require(het_err[0] <= feat_lim and het_err[1] <= icpt_lim,
            f"the tuned placement's beta off the K1 walk's by {het_err}")
    jobs = [s.to_job() for s in mixed]
    t = time.perf_counter()
    sim = simulate_server(mixed, n_workers=PAPER_WORKERS, arbiter="fair")
    assign, tuned_p99, base_p99 = select_offline_server(jobs, n_workers=PAPER_WORKERS,
                                                        arbiter="fair", objective="p99")
    server_s = time.perf_counter() - t
    require(tuned_p99 <= base_p99, "select_offline_server made p99 worse")
    out["tuners"] = dict(
        hetero_placement=placement.describe(), predicted_seconds=predicted,
        measured_seconds=het_s, baselines=baselines, walker_launches=het_walks,
        beta_vs_walk_abs_err=het_err, online_assign=tuned.assign,
        online_predicted_seconds=tuned.makespan, replay_rounds=len(hist),
        replay_last_makespan=hist[-1].makespan, seconds=tune_s,
        simulated_mixed_makespan=sim.makespan, server_assign=assign,
        server_p99=tuned_p99, server_p99_isolated=base_p99, server_seconds=server_s)

    # two models' steps on the card through one shared pool
    t = time.perf_counter()
    results, _, placements, lows = ml_apps.serving_pair(device=dev)
    pair_s = time.perf_counter() - t
    for arch, low in zip(results, lows):
        require(np.array_equal(results[arch], low.run_direct()),
                f"serving_pair: {arch}'s served logits differ from the direct composition")
        require(bool(np.isfinite(results[arch]).all()), f"serving_pair: {arch} not finite")
    out["serving_pair"] = dict(
        placements={a: p.describe() for a, p in placements.items()},
        logits_shape={a: list(v.shape) for a, v in results.items()}, seconds=pair_s)
    out["seconds"] = time.perf_counter() - t_phase
    emit("front_door", **out)
    return out


def decode_profile(model, params, tok, cache, index: int, served_step_ms: float,
                   steps: int = 3) -> dict:
    """Device ms of a decode step by ``torch.profiler``: the device rows'
    time (a CPU op's device time repeats its kernels', so only device rows
    are summed); "not measured" where the profiler reports no device row.
    The profiler slows the host, so the busy share is given twice: of the
    profiled step's wall time, and of ``served_step_ms``, the same run's
    unprofiled decode step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(steps):
            model.decode_step(params, tok, cache, index + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                served_step_ms=served_step_ms,
                device_ms_per_step=device_ms / steps if rows else "not measured",
                device_busy_share_profiled=device_ms / wall_ms if rows
                else "not measured",
                device_busy_share_served=device_ms / steps / served_step_ms if rows
                else "not measured",
                device_launches_per_step=sum(e.count for e in rows) / steps,
                top_device_rows_ms={e.key[:60]: e.self_device_time_total / 1e3 / steps
                                    for e in top})


def k4_randn(dev, q, k, v, seed: int = 1):
    """Contiguous bf16 randn tensors of q's, k's and v's shapes."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn(t.shape, generator=gen, device=dev).bfloat16() for t in (q, k, v)]


def k4_check(dev, cases: dict, tile_k: int, causal: bool = True) -> dict:
    """K4 (``causal`` or not) against its float64 oracle and its plain
    version on each of ``cases`` (label -> (q, k, v); v may be narrower
    than q and k, and the keys more or fewer than the queries). Fails on an
    entry beyond its limit (see K4_ULP); returns the worst absolute error
    and share of the limit of each comparison."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    checks = {}
    for what, (q_, k_, v_) in cases.items():
        b, h, sq, dh = q_.shape
        g, skv = h // k_.shape[1], k_.shape[2]
        mask = (torch.arange(sq, device=dev)[:, None]
                >= torch.arange(skv, device=dev)[None, :]) if causal else None
        got = flash_attention(q_, k_, v_, causal=causal, tile_k=tile_k)
        want = flash_attention_plain(q_, k_, v_, causal=causal, tile_k=tile_k)
        worst = dict(err_o=0.0, share_o=0.0, err_p=0.0, share_p=0.0)
        for i in range(b):
            k64 = k_[i].double().repeat_interleave(g, dim=0)
            v64 = v_[i].double().repeat_interleave(g, dim=0)
            s = (q_[i].double() @ k64.transpose(1, 2)) / math.sqrt(dh)
            w = torch.softmax(s if mask is None else s.masked_fill(~mask, -1e30), dim=-1)
            o = w @ v64
            wv = w @ v64.abs()
            lim = K4_ULP * (o.abs() + wv) + K4_FP32 * wv
            bad_o, err_o, share_o = beyond(got[i], o, lim)
            bad_p, err_p, share_p = beyond(got[i], want[i], 2 * lim)
            require(bad_o == 0, f"K4 ({what}, dh {dh}) vs float64: {bad_o} entries beyond "
                                f"the limit (batch {i}), max abs err {err_o:.3g}")
            require(bad_p == 0, f"K4 ({what}, dh {dh}) vs plain: {bad_p} entries beyond "
                                f"twice the limit (batch {i}), max abs err {err_p:.3g}")
            for key, val in (("err_o", err_o), ("share_o", share_o),
                             ("err_p", err_p), ("share_p", share_p)):
                worst[key] = max(worst[key], val)
            del k64, v64, s, w, o, wv, lim
        checks[what] = worst
        del got, want
    return checks


def k4_grad_oracle(q, k, v, dout, causal: bool = True,
                   rounded_operands: bool | None = None) -> dict:
    """K4's gradient in float64 on the same inputs, and each entry's limits
    (see K4_BWD_FP32): ``{name: (exact, limit, limit_vs_plain)}`` for dq,
    dk and dv, one batch at a time.

    The kernels round each gradient once to the inputs' type (unit
    roundoff ``u``: 2^-8 for bfloat16, 2^-24 for float32), and D = rowsum(dO
    * O) reads the forward's output rounded to that type, which moves dS
    by up to ``u P rowsum(|dO| |O|)``; the fp32 sums, expf and the LSE add
    under ``K4_BWD_FP32`` of each entry's sum of |terms| ``T``. So a dq
    entry's limit is ``u (|dq| + scale (P Dabs) |K|) + K4_BWD_FP32 T``, dk's
    the same with Q, and dv's ``u |dv| + K4_BWD_FP32 T``. Against the plain
    backward on the same output and LSE only the fp32 part and the final
    rounding differ: ``2 u |g| + 2 K4_BWD_FP32 T``. Where the kernel rounds
    P and dS as operands (``rounded_operands``, by default for bfloat16
    inputs), both limits gain ``u T`` (derived beside K4_BWD_FP32)."""
    import torch

    b, h, sq, dh = q.shape
    kvh, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kvh
    u = K4_ULP if q.dtype == torch.bfloat16 else 2.0 ** -24
    if rounded_operands is None:
        rounded_operands = q.dtype == torch.bfloat16
    fp32 = K4_BWD_FP32 + (u if rounded_operands else 0.0)  # each T's share
    fp32_plain = 2 * K4_BWD_FP32 + (u if rounded_operands else 0.0)
    scale = 1.0 / math.sqrt(dh)
    mask = (torch.arange(sq, device=q.device)[:, None]
            >= torch.arange(skv, device=q.device)[None, :]) if causal else None
    parts = {n: ([], [], []) for n in ("dq", "dk", "dv")}
    for i in range(b):
        q64, do64 = q[i].double(), dout[i].double()
        k64 = k[i].double().repeat_interleave(g, dim=0)
        v64 = v[i].double().repeat_interleave(g, dim=0)
        s = (q64 @ k64.transpose(1, 2)) * scale
        if causal:
            s = s.masked_fill(~mask, -1e30)
        w = torch.softmax(s, dim=-1)
        del s
        o = w @ v64
        dp = do64 @ v64.transpose(1, 2)
        delta = (do64 * o).sum(-1, keepdim=True)
        dabs = (do64.abs() * o.abs()).sum(-1, keepdim=True)
        ds = w * (dp - delta)
        terms = w * (dp.abs() + delta.abs())
        del dp
        wd = w * dabs
        grp = lambda t: t.reshape(kvh, g, *t.shape[1:]).sum(1)  # noqa: E731
        dq = scale * (ds @ k64)
        dk = grp(scale * (ds.transpose(1, 2) @ q64))
        dvv = grp(w.transpose(1, 2) @ do64)
        t_q = scale * (terms @ k64.abs())
        t_k = grp(scale * (terms.transpose(1, 2) @ q64.abs()))
        t_v = grp(w.transpose(1, 2) @ do64.abs())
        r_q = scale * (wd @ k64.abs())
        r_k = grp(scale * (wd.transpose(1, 2) @ q64.abs()))
        for n, exact, t, r in (("dq", dq, t_q, r_q), ("dk", dk, t_k, r_k),
                               ("dv", dvv, t_v, 0.0)):
            parts[n][0].append(exact)
            parts[n][1].append(u * (exact.abs() + r) + fp32 * t)
            parts[n][2].append(2 * u * exact.abs() + fp32_plain * t)
        del w, o, ds, terms, wd, k64, v64
    return {n: tuple(torch.stack(x) for x in p) for n, p in parts.items()}


def logits_vs_plain_k4(dev, res, serve: dict, logits_k) -> tuple:
    """The first batch's last-position logits through K4 (``logits_k``,
    from ``serve_checked``) against the same weights and prompts through
    K4's plain version: fails beyond LOGIT_TOL of the largest |logit|.

    In an MoE model the two attentions' fp32 roundings flip bf16 roundings
    downstream, and where a router's logits nearly tie, an expert: at full
    width such flips reach a few percent of the positions a layer and
    compound over the layers (PERF.md §6), a discrete difference
    that is not K4's. So there the K4 prefill runs again routed as the
    plain one routed (its own router's probabilities at the plain run's
    experts), and its logits are the ones held to LOGIT_TOL; the unforced
    K4 prefill's routing must differ from the plain one's only where
    rounding explains it (``routing_flips``), and its logits' error and
    flips are reported. Returns the error, the scale, the greedy tokens'
    agreement and the routing's numbers (None for a dense model)."""
    from unittest import mock

    import torch

    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import attention as attention_module

    model, params, cfg = res.model, res.params, res.model.cfg
    rows = res.requests[0]
    toks = torch.from_numpy(res.prompts[rows]).to(dev)
    s_max = serve["prompt_len"] + serve["gen_len"]

    def prefill():
        return model.prefill(params, {"tokens": toks},
                             model.init_cache(len(rows), s_max, device=dev))[0]

    with route_log() as plain_calls, \
            mock.patch.object(attention_module, "flash_attention", flash_attention_plain):
        logits_p = prefill()
    routing = None
    if cfg.moe is not None:
        by_layer, worst = [], 0.0
        with route_log() as k4_calls:
            unforced = prefill()
        for (px, pidx, w), (kx, kidx, _) in zip(plain_calls, k4_calls, strict=True):
            ref_logits = (px.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
            flips = routing_flips((px, ref_logits, pidx), (kx, kidx), w, cfg.moe)
            require(not flips["unexplained"],
                    f"serve_lm {serve['arch']} layer {len(by_layer)}: K4 and its plain "
                    f"version route otherwise beyond rounding at {flips['unexplained'][:8]}")
            by_layer.append(len(flips["near_tie"]) + len(flips["capacity"]))
            worst = max(worst, flips["worst_share"])
        del k4_calls
        with replayed_routing(plain_calls):
            logits_k = prefill()
        u_err = max_err(unforced[:, -1].float(), logits_p[:, -1].float())
        routing = dict(positions_routed_otherwise_by_layer=by_layer,
                       positions=len(rows) * serve["prompt_len"],
                       logits_worst_share_of_bound=worst, unforced_logits_max_abs_err=u_err)
    del plain_calls
    lk, lp = logits_k[:, -1].float(), logits_p[:, -1].float()
    logit_scale = float(lp.abs().max())
    logit_err = max_err(lk, lp)
    require(logit_err <= LOGIT_TOL * logit_scale,
            f"serve_lm {serve['arch']} first-batch logits through K4 vs plain: max abs "
            f"err {logit_err:.4g} > {LOGIT_TOL} x {logit_scale:.4g}")
    greedy = float((lk[:, :cfg.vocab_size].argmax(-1)
                    == lp[:, :cfg.vocab_size].argmax(-1)).float().mean())
    return logit_err, logit_scale, greedy, routing


def serve_phase(dev) -> dict:
    """Granite-8B LM serving at full size through ``serve_lm``: K4 on every
    prefill layer and nowhere else. Returns K4's row."""
    import torch

    from repro_torch.models import attention as attention_module

    res, numbers, kept, logits_k = serve_checked(
        dev, SERVE, dict(n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
                         d_ff=14336, vocab_size=49152),
        {"flash_attention": GRANITE_LAYERS * SERVE_BATCHES},
        {attention_module: "flash_attention"})
    cfg = res.model.cfg
    logit_err, logit_scale, greedy, _ = logits_vs_plain_k4(dev, res, SERVE, logits_k)
    del res
    # K4 alone at the serving shape: on the served call's own bf16 inputs
    # (the last layer of the first batch's prefill: q and k leave RoPE
    # contiguous, v is _split_heads's transposed view), then on randn
    (q, k, v), kw = kept["flash_attention"]
    b, h, kvh, sq, dh = SERVE["slots"], cfg.n_heads, cfg.n_kv_heads, SERVE["prompt_len"], \
        cfg.head_dim
    require(q.shape == (b, h, sq, dh) and k.shape == v.shape == (b, kvh, sq, dh)
            and q.dtype == k.dtype == v.dtype == torch.bfloat16 and not v.is_contiguous()
            and kw == dict(causal=True, tile_k=cfg.attn_chunk_kv),
            f"served K4 call: q {tuple(q.shape)} {q.dtype} strides {q.stride()}, "
            f"k {tuple(k.shape)} strides {k.stride()}, {kw}")
    row, checks = k4_served_row(dev, "flash_attention", (q, k, v), kw,
                                numbers["launches"]["flash_attention"],
                                "the last layer's q, k, v of the first batch's prefill")
    forwards = SERVE_BATCHES * SERVE["gen_len"]
    emit("serve_lm", **numbers, k4_seconds=row["launches"] * row["ms"] / 1e3,
         forwards=forwards,
         weight_cast_seconds=forwards * numbers["weight_cast_ms_per_forward"] / 1e3,
         logits_vs_plain=[logit_err, logit_err / (LOGIT_TOL * logit_scale)],
         logit_scale=logit_scale, greedy_agreement=greedy,
         k4_tol="2^-8 (|o| + sum w|v|) + 2^-16 sum w|v| vs float64; x2 vs plain",
         k4_vs_float64={w_: [c["err_o"], c["share_o"]] for w_, c in checks.items()},
         k4_vs_plain={w_: [c["err_p"], c["share_p"]] for w_, c in checks.items()})
    return row


def scan_limits(abs_oracle, cmaxes, q: int) -> tuple:
    """Each entry's limit against the float64 oracle, for y and the state
    (``abs_oracle``: each entry's sum of |terms|; ``cmaxes``: the largest
    |chunk cumsum|, broadcast to the entries)."""
    return tuple(EPS32 * math.sqrt(SCAN_ROUNDINGS * q) * (1.0 + c) * m
                 for m, c in zip(abs_oracle, cmaxes))


def scan_check(name: str, got, plain, oracle, limits, control) -> dict:
    """Hold a scan's (y, state) to the float64 oracle within ``limits``
    and to the plain version within twice them; fail on an entry beyond.
    ``control`` (the scan with its decays rounded to bfloat16) must pass
    the limit in y or the state. Returns the worst absolute errors and
    shares of the limit, the control's included."""
    out = {}
    control_bad = 0
    for part, g, p, o, lim, ctl in zip(("y", "state"), got, plain, oracle, limits, control):
        bad_o, err_o, share_o = beyond(g, o, lim)
        bad_p, err_p, share_p = beyond(g, p, 2 * lim)
        bad_c, err_c, share_c = beyond(ctl, o, lim)
        require(bad_o == 0, f"{name} {part} vs float64: {bad_o} entries beyond the limit, "
                            f"max abs err {err_o:.3g}")
        require(bad_p == 0, f"{name} {part} vs plain: {bad_p} entries beyond twice the "
                            f"limit, max abs err {err_p:.3g}")
        control_bad += bad_c
        out[part] = dict(vs_float64=[err_o, share_o], vs_plain=[err_p, share_p],
                         bf16_decay_control_vs_float64=[err_c, share_c, bad_c])
    require(control_bad > 0, f"{name}: the scan with bfloat16 decays stayed within the "
                             "limit; the limit cannot tell that precision apart")
    return out


def rwkv6_limits(r, k, v, logw, u, q: int) -> tuple:
    """K6's float64 oracle of (y, state) at chunk ``q``, each entry's limit
    against it (``scan_limits``) and the largest |chunk cumsum| of logw,
    for every check of K6, the smoke's and the tests'."""
    import torch

    from repro_torch.kernels.ref import rwkv6_scan_ref

    b, h, s, dh = r.shape
    oracle = rwkv6_scan_ref(r, k, v, logw, u, dtype=torch.float64, return_state=True)
    abs_oracle = rwkv6_scan_ref(r.abs(), k.abs(), v.abs(), logw, u.abs(),
                                dtype=torch.float64, return_state=True)
    cmax = logw.double().reshape(b, h, s // q, q, dh).sum(3).abs().amax((2, 3))
    limits = scan_limits(abs_oracle, (cmax[:, :, None, None], cmax[:, :, None, None]), q)
    return oracle, limits, float(cmax.max())


def rwkv6_checks(inputs: dict, chunk: int) -> tuple[dict, float]:
    """K6 on ``inputs`` (r, k, v, logw, u) against the float64 oracle and
    the plain version. Returns the checks and the largest abs error."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain, rwkv6_scan_state

    r, k, v, logw, u = (inputs[n] for n in ("r", "k", "v", "logw", "u"))
    got = rwkv6_scan_state(r, k, v, logw, u, chunk)
    plain = rwkv6_scan_plain(r, k, v, logw, u, chunk)
    control = rwkv6_scan_state(r, k, v, logw.bfloat16().float(), u, chunk)
    oracle, limits, cmax = rwkv6_limits(r, k, v, logw, u, min(chunk, r.shape[2]))
    checks = scan_check("K6", got, plain, oracle, limits, control)
    err = max(max_err(g, p) for g, p in zip(got, plain))
    checks["largest_chunk_cumsum"] = cmax
    return checks, err


def ssm_limits(x, dt, A, B, C, q: int) -> tuple:
    """K5's float64 oracle of (y, state) at chunk ``q`` (without D * x),
    each entry's limit against it (``scan_limits``) and the largest
    |chunk cumsum| of dt A, for every check of K5, the smoke's and the
    tests'."""
    import torch

    from repro_torch.kernels.ref import ssm_scan_ref

    bt, s, h, _ = x.shape
    zero = torch.zeros_like(A)
    oracle = ssm_scan_ref(x, dt, A, B, C, zero, dtype=torch.float64, return_state=True)
    abs_oracle = ssm_scan_ref(x.abs(), dt, A, B.abs(), C.abs(), zero,
                              dtype=torch.float64, return_state=True)
    cmax = (dt.double() * A.double()).reshape(bt, s // q, q, h).sum(2).abs().amax(1)
    limits = scan_limits(abs_oracle, (cmax[:, None, :, None], cmax[:, :, None, None]), q)
    return oracle, limits, float(cmax.max())


def ssm_checks(inputs: dict, chunk: int) -> tuple[dict, float]:
    """K5 on ``inputs`` (x, dt, A, B, C) against the float64 oracle and
    the plain version (both without D * x, which lies outside the scan).
    Returns the checks and the largest abs error."""
    from repro_torch.kernels.ssm_scan import ssm_scan_plain, ssm_scan_state

    x, dt, A, B, C = (inputs[n] for n in ("x", "dt", "A", "B", "C"))
    q = min(chunk, x.shape[1])
    got = ssm_scan_state(x, dt, A, B, C, chunk)
    plain = ssm_scan_plain(x, dt, A, B, C, chunk)
    control = ssm_scan_state(x, dt.bfloat16().float(), A, B, C, chunk)
    oracle, limits, cmax = ssm_limits(x, dt, A, B, C, q)
    checks = scan_check("K5", got, plain, oracle, limits, control)
    err = max(max_err(g, p) for g, p in zip(got, plain))
    checks["largest_chunk_cumsum"] = cmax
    return checks, err


def scan_bwd_limits(kind: str, inputs: dict, dy, dstate, q: int) -> dict:
    """K5''s (``kind`` "ssm") or K6''s ("rwkv6") float64 gradient of
    ``inputs`` for y's gradient ``dy`` and the final state's ``dstate``, and
    each entry's limits (see SCAN_BWD_ROUNDINGS): ``{name: (exact, limit,
    limit_vs_plain)}``, for every check of K5' and K6', the smoke's and the
    tests'. ``q`` is the kernel's chunk."""
    import torch

    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd_plain
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_plain

    def unit(t):
        return 2.0 ** -8 if t.dtype == torch.bfloat16 else 2.0 ** -24

    if kind == "ssm":
        x, dt, A, B, C = (inputs[n] for n in ("x", "dt", "A", "B", "C"))
        bt, s, h, _ = x.shape
        nc = s // q
        args = (x, dt, A, B, C, dy, dstate, q)
        names = ("dx", "ddt", "dA", "dB", "dC")
        c = (dt.double() * A.double()).reshape(bt, nc, q, h).sum(2).abs().amax(1)   # (Bt, H)
        cmax = (c[:, None, :, None], c[:, None, :], c.amax(0), c.amax(1)[:, None, None],
                c.amax(1)[:, None, None])
        extra = (0, 0, bt * nc, h, h)
        units = (unit(x), 2.0 ** -24, 2.0 ** -24, unit(B), unit(C))
        bwd = ssm_scan_bwd_plain
    else:
        r, k, v, logw, u = (inputs[n] for n in ("r", "k", "v", "logw", "u"))
        b, h, s, dh = r.shape
        nc = s // q
        args = (r, k, v, logw, u, dy, dstate, q)
        names = ("dr", "dk", "dv", "dlogw", "du")
        c = logw.double().reshape(b, h, nc, q, dh).sum(3).abs().amax((2, 3))        # (B, H)
        cmax = (c[:, :, None, None],) * 4 + (c.amax(0)[:, None],)
        extra = (0, 0, 0, 0, b * nc)
        units = (unit(r), unit(k), unit(v), 2.0 ** -24, 2.0 ** -24)
        bwd = rwkv6_scan_bwd_plain
    exact = bwd(*args, dtype=torch.float64)
    terms = bwd(*args, dtype=torch.float64, magnitude=True)
    out = {}
    for name, g, t, cm, ex, un in zip(names, exact, terms, cmax, extra, units):
        fp32 = EPS32 * math.sqrt(SCAN_BWD_ROUNDINGS * q + ex) * (1.0 + cm) * t
        out[name] = (g, un * g.abs() + fp32, 2 * un * g.abs() + 2 * fp32)
    return out


def scan_bwd_dropped_carry(kind: str, args, chunk: int, dy, dstate) -> tuple:
    """The control of K5' and K6' (see SCAN_BWD_ROUNDINGS): the backward
    kernel on ``args`` with the forward's entering states zeroed."""
    import torch

    from repro_torch.kernels import rwkv6_scan, ssm_scan

    if kind == "ssm":
        _, _, cum, states = ssm_scan._forward(*args, chunk)
        return ssm_scan.ssm_scan_bwd(*args, cum, torch.zeros_like(states), dy, dstate)
    _, final, states = rwkv6_scan._forward(*args, chunk)
    return rwkv6_scan.rwkv6_scan_bwd(*args, torch.zeros_like(states), final, dy, dstate)


def serve_checked(dev, serve: dict, widths: dict, want_launches: dict, patches: dict):
    """``serve_lm`` of ``serve["arch"]`` at full size, launch counters set
    to 0 just before and read just after, its config's ``widths`` and its
    parameter count checked; then the first batch's prefill again with
    each kernel wrapper of ``patches`` (module -> wrapper name) wrapped to
    keep its last call's arguments, and decode steps, which must launch
    nothing (one, then three under ``torch.profiler``). Returns the serve
    result, its numbers, the kept calls and the repeated prefill's
    logits."""
    import argparse
    from unittest import mock

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.model import _leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = argparse.Namespace(**serve)
    for k in _build.KERNELS:
        k.launches.clear()
    t0 = time.perf_counter()
    res = serve_lm(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts(_build.KERNELS)
    require(launches == want_launches,
            f"serve_lm {serve['arch']}: launches {launches}, want {want_launches}")
    model, params, cfg = res.model, res.params, res.model.cfg
    got_widths = {name: getattr(cfg, name) for name in widths}
    require(got_widths == widths, f"serve_lm {serve['arch']} widths {got_widths}, "
                                  f"want {widths}")
    n_params = sum(t.numel() for t in _leaves(params))
    require(n_params == cfg.param_count(),
            f"serve_lm {serve['arch']}: served params {n_params} != param_count")
    require(len(res.requests) == SERVE_BATCHES
            and sum(len(set(r)) for r in res.requests) == serve["requests"],
            f"serve_lm slot batches {res.requests}")
    for toks, logits in zip(res.tokens, res.logits):
        require(toks.shape == (serve["slots"], serve["gen_len"])
                and logits.shape == (serve["slots"], serve["gen_len"], cfg.padded_vocab)
                and bool(torch.isfinite(logits).all()),
                f"serve_lm {serve['arch']} output malformed")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    rows = res.requests[0]
    toks = torch.from_numpy(res.prompts[rows]).to(dev)
    kept: dict = {}
    with contextlib.ExitStack() as stack:
        for module, fn_name in patches.items():
            fn = getattr(module, fn_name)

            def keep(*a, _fn=fn, _name=fn_name, **kw):
                kept[_name] = (a, kw)
                return _fn(*a, **kw)

            stack.enter_context(mock.patch.object(module, fn_name, keep))
        for k in _build.KERNELS:
            k.launches.clear()
        logits, cache = model.prefill(params, {"tokens": toks}, model.init_cache(
            len(rows), serve["prompt_len"] + serve["gen_len"], device=dev))
    prefill_launches = launch_counts(_build.KERNELS)
    nxt = logits[:, -1].argmax(-1)[:, None]
    model.decode_step(params, nxt, cache, serve["prompt_len"])
    torch.cuda.synchronize()
    per_prefill = {e: n // SERVE_BATCHES for e, n in want_launches.items()}
    require(prefill_launches == per_prefill == launch_counts(_build.KERNELS),
            f"{serve['arch']}: launches {prefill_launches} in a prefill (want "
            f"{per_prefill}), then {launch_counts(_build.KERNELS)} after a decode step")
    repeat_equal = torch.equal(logits[:, -1], res.logits[0][:, 0])
    decode_steps = SERVE_BATCHES * (serve["gen_len"] - 1)
    decode_busy = decode_profile(model, params, nxt, cache, serve["prompt_len"] + 1,
                                 res.decode_seconds / decode_steps * 1e3)
    del cache
    # the per-use casts of one forward: every 2-D weight but the embedding
    # table (``dense``, the router, MLA's wkv_b) and the 3-D routed experts
    # (``moe._dispatch_compute_combine``), one tensor at a time as the
    # forward casts them, so at most one cast copy is alive
    weights = [t for key, part in params.items() if key != "embed"
               for t in _leaves(part) if t.dim() in (2, 3)]

    def cast_ms(dim: int) -> float:
        group = [w_ for w_ in weights if w_.dim() == dim]

        def cast():
            for w_ in group:
                w_.to(torch.bfloat16)

        return timed(cast, 3) if group else 0.0

    casts = {"experts": cast_ms(3), "rest": cast_ms(2)}
    del weights
    tokens = serve["requests"] * serve["gen_len"]
    numbers = dict(arch=serve["arch"], requests=serve["requests"], slots=serve["slots"],
                   prompt_len=serve["prompt_len"], gen_len=serve["gen_len"],
                   technique=serve["technique"], batches=res.requests, params=n_params,
                   launches=launches, prefill_launches=prefill_launches,
                   seconds_with_weights=seconds, seconds=res.seconds,
                   prefill_seconds=res.prefill_seconds, decode_seconds=res.decode_seconds,
                   tokens_per_second=tokens / res.seconds, peak_memory_gb=peak_gb,
                   first_batch_repeats_bitwise=repeat_equal,
                   weight_cast_ms_per_forward=casts["experts"] + casts["rest"],
                   weight_cast_ms_per_forward_split=casts, decode_step_profile=decode_busy)
    return res, numbers, kept, logits


def rwkv6_phase(dev) -> dict:
    """RWKV6-3B LM serving at full size through ``serve_lm``: K6 on every
    prefill layer and nowhere else. Returns K6's row."""
    import torch

    from repro_torch.configs.base import RWKVConfig
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain, rwkv6_scan_state
    from repro_torch.models import rwkv as rwkv_module

    res, numbers, kept, _ = serve_checked(
        dev, RWKV_SERVE, dict(n_layers=32, d_model=2560, n_heads=40, d_ff=8960,
                              vocab_size=65536, rwkv=RWKVConfig(64, 64, 64)),
        {"rwkv6_scan": RWKV_LAYERS * SERVE_BATCHES}, {rwkv_module: "rwkv6_scan_state"})
    cfg = res.model.cfg
    chunk = cfg.rwkv.chunk
    del res
    (r, k, v, logw, u, q_), kw = kept["rwkv6_scan_state"]
    b, h, s, dh = SERVE["slots"], cfg.n_heads, SERVE["prompt_len"], cfg.rwkv.head_dim
    require(r.shape == k.shape == v.shape == logw.shape == (b, h, s, dh)
            and r.dtype == torch.bfloat16 and logw.dtype == torch.float32
            and not r.is_contiguous() and q_ == chunk and not kw,
            f"served K6 call: r {tuple(r.shape)} {r.dtype} strides {r.stride()}, "
            f"logw {logw.dtype}, chunk {q_}")
    served = dict(r=r, k=k, v=v, logw=logw, u=u)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rnd = [torch.randn((b, h, s, dh), generator=gen, device=dev).bfloat16()
           for _ in range(3)]
    fast = torch.clamp(-torch.exp(torch.randn((b, h, s, dh), generator=gen, device=dev)
                                  * 4.0), min=-30.0)
    randn = dict(r=rnd[0], k=rnd[1], v=rnd[2], logw=fast,
                 u=torch.randn((h, dh), generator=gen, device=dev) * 0.1)
    checks, errs = {}, []
    for what, inputs in (("served", served), ("randn_fast_decay", randn)):
        checks[what], err = rwkv6_checks(inputs, chunk)
        errs.append(err)
    del randn
    kernel = lambda: rwkv6_scan_state(r, k, v, logw, u, chunk)  # noqa: E731
    plain = lambda: rwkv6_scan_plain(r, k, v, logw, u, chunk)  # noqa: E731
    k6_ms, plain_ms = timed(kernel, 10), timed(plain, 3)
    k6_device = kernel_device_ms(kernel, SCAN_KERNELS["rwkv6_scan"])
    require(k6_device["device_launches_per_call"] == 2,
            f"K6 under the profiler: {k6_device}; want 2 launches a call, rwkv6_states "
            "and rwkv6_outputs")
    k6_sass = scan_sass_has("rwkv6_scan", ("HMMA", "HGMMA"))
    require(all(k6_sass.values()), f"K6 issues no tensor-core instruction: {k6_sass}")
    # per token and head at chunk q: the carry-in r' S and the update k'^T v
    # (2 dh^2 each), the state's decay once a chunk, (q - 1) / 2 earlier
    # steps of the chunk each (gate product and A: 3 dh; A v: 2 dh), the
    # bonus (5 dh), the scalings and the cumsum (3 dh); expf: the exact
    # gate's (q - 1) / 2 dh, exp(cum_{t-1}) and exp(cum_q - cum) for all
    # but one step of the chunk, exp(cum_q) once a chunk. On split TF32 the
    # carry-in takes three TF32 products (r' and S split) and the update
    # three, or two when v is bf16 (exact in TF32); the pairs keep the
    # exact gate on fp32 FMA.
    exps = lambda q: b * h * s * ((q - 1) / 2 * dh + 2 * (q - 1) / q * dh + dh / q)  # noqa: E731
    rest = lambda q: b * h * s * (dh * dh / q + (q - 1) / 2 * 5 * dh + 8 * dh)  # noqa: E731
    update_products = 2 if v.dtype == torch.bfloat16 else 3
    bound = scan_bound(
        sum(t.numel() * t.element_size() for t in (r, k, v, logw, u))
        + 4 * (b * h * s * dh + b * h * dh * dh),
        lambda q: (b * h * s * 4 * dh * dh + rest(q), exps(q)),
        chunk,
        tf32_work=lambda q: (b * h * s * (3 + update_products) * 2 * dh * dh, rest(q), exps(q)))
    # the two launches' own bytes, reckoned from the shapes (not a
    # measurement): rwkv6_states reads k and logw once a CTA (two CTAs a
    # head), v once, writes the entering states (chunks 1 ..) and the final
    # state; rwkv6_outputs reads r, k, v, logw and the entering states and
    # writes y
    seq_bytes = r.element_size() * b * h * s * dh     # one of r, k, v
    states_bytes = 4 * b * h * (s // chunk - 1) * dh * dh
    design_bytes = (2 * (seq_bytes + logw.numel() * 4) + seq_bytes + states_bytes
                    + 4 * b * h * dh * dh
                    + 3 * seq_bytes + logw.numel() * 4 + states_bytes + 4 * b * h * s * dh)
    launches = numbers["launches"]["rwkv6_scan"]
    emit("serve_rwkv6", **numbers, k6_seconds=launches * k6_ms / 1e3,
         k6_share_of_prefill=launches * k6_ms / 1e3 / numbers["prefill_seconds"],
         k6_tol="eps32 sqrt(3 Q) (1 + max|chunk cumsum|) sum|terms| vs float64; x2 vs "
                "plain; the scan on bf16-rounded logw must pass it",
         k6_inputs={"served": f"the last layer's r, k, v, logw, u of the first batch's "
                              f"prefill, r strides {list(r.stride())}",
                    "randn_fast_decay": "bf16 randn r, k, v; logw = max(-exp(4 randn), -30)"},
         k6_checks=checks, k6_design_bytes=design_bytes,
         k6_design_bytes_ms=design_bytes / PEAK_BYTES * 1e3)
    return dict(
        name="rwkv6_scan", route="cuda", source="src/repro_torch/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:70",
        launches=launches, max_abs_err=max(errs),
        max_abs_err_vs_float64=max(c[p]["vs_float64"][0] for c in checks.values()
                                   for p in ("y", "state")),
        ms=k6_ms, **k6_device, plain_ms=plain_ms, library_ms=None,
        library_call="none: no one PyTorch call computes the RWKV6 WKV recurrence",
        sass_has_tensor_core_op=k6_sass,
        shapes=f"r, k, v ({b}, {h}, {s}, {dh}) bf16 (transposed views), logw f32, "
               f"chunk {chunk}; y and final state f32",
        **bound)


def zamba2_phase(dev) -> list[dict]:
    """Zamba2-7B LM serving at full size through ``serve_lm``: K5 on every
    Mamba2 prefill layer and K4 (dh 112) on every shared-attention prefill
    call, nowhere else. Returns K5's row and K4's dh 112 row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import SSMConfig
    from repro_torch.kernels.ssm_scan import ssm_scan_plain, ssm_scan_state
    from repro_torch.models import attention as attention_module
    from repro_torch.models import ssm as ssm_module

    res, numbers, kept, _ = serve_checked(
        dev, ZAMBA_SERVE, dict(n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
                               head_dim=112, d_ff=14336, vocab_size=32000,
                               ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=64,
                                             conv_width=4, attn_every=6)),
        {"ssm_scan": ZAMBA_MAMBA_LAYERS * SERVE_BATCHES,
         "flash_attention": ZAMBA_SUPER_BLOCKS * SERVE_BATCHES},
        {ssm_module: "ssm_scan_state", attention_module: "flash_attention"})
    cfg = res.model.cfg
    chunk, tile_k = cfg.ssm.chunk, cfg.attn_chunk_kv
    del res
    (x, dt, A, B, C, q_), kw = kept["ssm_scan_state"]
    bt, s, h, dh, n = SERVE["slots"], SERVE["prompt_len"], 112, 64, 64
    require(x.shape == (bt, s, h, dh) and B.shape == C.shape == (bt, s, n)
            and dt.shape == (bt, s, h) and x.dtype == B.dtype == torch.bfloat16
            and not x.is_contiguous() and not B.is_contiguous() and q_ == chunk and not kw,
            f"served K5 call: x {tuple(x.shape)} {x.dtype} strides {x.stride()}, "
            f"B strides {B.stride()}, chunk {q_}")
    served = dict(x=x, dt=dt, A=A, B=B, C=C)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    randn = dict(x=torch.randn((bt, s, h, dh), generator=gen, device=dev).bfloat16(),
                 dt=F.softplus(torch.randn((bt, s, h), generator=gen, device=dev)),
                 A=-torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.5),
                 B=torch.randn((bt, s, n), generator=gen, device=dev).bfloat16(),
                 C=torch.randn((bt, s, n), generator=gen, device=dev).bfloat16())
    checks, errs = {}, []
    for what, inputs in (("served", served), ("randn", randn)):
        checks[what], err = ssm_checks(inputs, chunk)
        errs.append(err)
    del randn
    kernel = lambda: ssm_scan_state(x, dt, A, B, C, chunk)  # noqa: E731
    plain = lambda: ssm_scan_plain(x, dt, A, B, C, chunk)  # noqa: E731
    k5_ms, plain_ms = timed(kernel, 10), timed(plain, 3)
    k5_device = kernel_device_ms(kernel, SCAN_KERNELS["ssm_scan"])
    require(k5_device["device_launches_per_call"] == 2,
            f"K5 under the profiler: {k5_device}; want 2 launches a call, ssm_states "
            "and ssm_outputs")
    k5_sass = scan_sass_has("ssm_scan", ("HMMA", "HGMMA"))
    require(all(k5_sass.values()), f"K5 issues no tensor-core instruction: {k5_sass}")
    # per token and head at chunk q: the carry-in C S^T and the update
    # (dt x w)^T B (2 dh N each), the state's decay once a chunk, (q + 1) / 2
    # steps of the chunk each (gate and dt: 2; scores x: 2 dh; C B^T: 2 N,
    # once for all h heads), the carry-in's scaling and dt x (2 dh), the
    # cumsum and w dt (2); expf: the gate's (q - 1) / 2, exp(cum_t) and
    # exp(cum_q - cum_s) for all but one step, exp(cum_q) once a chunk. On
    # split TF32 (bf16 x, B, C: exact in TF32) C B^T takes one TF32 product
    # and the other three, each with one fp32 operand, two.
    exps = lambda q: bt * s * h * ((q - 1) / 2 + 2 * (q - 1) / q + 1 / q)  # noqa: E731
    rest = lambda q: bt * s * h * (dh * n / q + (q + 1) + 2 * dh + 2)  # noqa: E731
    bound = scan_bound(
        x.numel() * 2 + dt.numel() * 4 + A.numel() * 4 + 2 * B.numel() * 2
        + 4 * (bt * s * h * dh + bt * h * dh * n),
        lambda q: (bt * s * h * (4 * dh * n + (q + 1) / 2 * (2 * dh + 2 * n / h)) + rest(q),
                   exps(q)),
        chunk,
        tf32_work=lambda q: (bt * s * h * (2 * 4 * dh * n + (q + 1) / 2
                                           * (2 * 2 * dh + 2 * n / h)), rest(q), exps(q)))
    # the two launches' own bytes, reckoned from the shapes (the serve line's
    # k5_design_bytes, not a measurement): ssm_states reads x, B, dt, writes cum
    # and reads it back, writes the entering states (chunks 1 ..) and the
    # final state; ssm_outputs reads x, B, C, dt, cum and the entering
    # states and writes y
    states_bytes = 4 * bt * h * (s // chunk - 1) * dh * n
    design_bytes = (2 * x.numel() * 2 + 3 * B.numel() * 2 + 2 * dt.numel() * 4
                    + 3 * 4 * bt * h * s + 2 * states_bytes
                    + 4 * (bt * s * h * dh + bt * h * dh * n))

    # K4 at dh 112: the last shared-attention call of the first prefill
    (q, k, v), kw4 = kept["flash_attention"]
    ha = cfg.n_heads
    require(q.shape == k.shape == v.shape == (bt, ha, s, 112) and q.dtype == torch.bfloat16
            and kw4 == dict(causal=True, tile_k=tile_k),
            f"served K4 call: q {tuple(q.shape)} {q.dtype}, {kw4}")
    k4_row, k4 = k4_served_row(dev, "flash_attention[dh 112, Zamba2]", (q, k, v), kw4,
                               numbers["launches"]["flash_attention"],
                               "the last shared-attention call of the first batch's prefill")
    k5_launches = numbers["launches"]["ssm_scan"]
    k4_seconds = k4_row["launches"] * k4_row["ms"] / 1e3
    emit("serve_zamba2", **numbers, k5_seconds=k5_launches * k5_ms / 1e3,
         k4_seconds=k4_seconds,
         kernel_share_of_prefill=(k5_launches * k5_ms / 1e3 + k4_seconds)
         / numbers["prefill_seconds"],
         k5_tol="eps32 sqrt(3 Q) (1 + max|chunk cumsum|) sum|terms| vs float64; x2 vs "
                "plain; the scan on bf16-rounded dt must pass it",
         k5_inputs={"served": f"the last Mamba2 layer's x, dt, A, B, C of the first "
                              f"batch's prefill, x strides {list(x.stride())}, B strides "
                              f"{list(B.stride())}", "randn": "bf16 randn x, B, C; "
                              "dt = softplus(randn), A = -exp(randn / 2)"},
         k5_checks=checks, k5_design_bytes=design_bytes,
         k5_design_bytes_ms=design_bytes / PEAK_BYTES * 1e3,
         k4_dh112_vs_float64={w_: [c["err_o"], c["share_o"]] for w_, c in k4.items()},
         k4_dh112_vs_plain={w_: [c["err_p"], c["share_p"]] for w_, c in k4.items()})
    return [dict(
        name="ssm_scan", route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:57",
        launches=k5_launches, max_abs_err=max(errs),
        max_abs_err_vs_float64=max(c[p]["vs_float64"][0] for c in checks.values()
                                   for p in ("y", "state")),
        ms=k5_ms, **k5_device, plain_ms=plain_ms, library_ms=None,
        library_call="none: no one PyTorch call computes the Mamba2 SSD scan",
        sass_has_tensor_core_op=k5_sass,
        shapes=f"x ({bt}, {s}, {h}, {dh}) bf16 (a strided view of the conv output), "
               f"B, C ({bt}, {s}, {n}) bf16 views, dt f32, chunk {chunk}; y and final "
               "state f32",
        **bound), k4_row]


def moe_serve_checked(dev, serve: dict, widths: dict, layers: int, counts: tuple):
    """``serve_checked`` for an MoE family at full size: K4 on every
    prefill layer (one launch each), nowhere else; the config's widths and
    MoE / MLA sub-configs, its (all, active) parameter counts, and the
    first batch's logits through K4 against K4's plain version. Returns
    the serve line's numbers and the last K4 call of the repeated
    prefill ((q, k, v), kwargs)."""
    from repro_torch.models import attention as attention_module
    from repro_torch.models.model import count_active_params, count_params

    res, numbers, kept, logits_k = serve_checked(
        dev, serve, widths, {"flash_attention": layers * SERVE_BATCHES},
        {attention_module: "flash_attention"})
    cfg = res.model.cfg
    got = (count_params(cfg), count_active_params(cfg))
    require(got == counts, f"serve_lm {serve['arch']}: (all, active) params {got}, want {counts}")
    logit_err, logit_scale, greedy, routing = logits_vs_plain_k4(dev, res, serve, logits_k)
    del res
    numbers.update(active_params=got[1],
                   logits_vs_plain=[logit_err, logit_err / (LOGIT_TOL * logit_scale)],
                   logit_scale=logit_scale, greedy_agreement=greedy,
                   routing_k4_vs_plain=routing)
    (q, k, v), kw = kept["flash_attention"]
    return numbers, (q, k, v), kw


def k4_served_row(dev, name: str, qkv: tuple, kw: dict, launches: int, what: str) -> tuple:
    """K4 alone on a served call's own ``qkv`` (``kw``: its causal flag and
    kv tile) and on contiguous randn tensors of the same shapes, against
    its float64 oracle and plain version; then its ms, device ms, plain
    ms and SDPA's ms (None where SDPA refuses the shapes on the card).
    The bound counts the (query, key) pairs the call scores: Sq (Sq + 1) /
    2 when causal (every causal call served has Skv = Sq), Sq Skv when
    not. Returns the kernels line's row and the checks."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = qkv
    b, h, sq, dh = q.shape
    kvh, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    tile_k, causal = kw["tile_k"], kw["causal"]
    require(not causal or skv == sq, f"{name}: a causal call with Sq {sq} != Skv {skv}")
    checks = k4_check(dev, {"served": (q, k, v), "randn": k4_randn(dev, q, k, v)}, tile_k,
                      causal)
    kernel = lambda: flash_attention(q, k, v, causal=causal, tile_k=tile_k)  # noqa: E731
    plain = lambda: flash_attention_plain(q, k, v, causal=causal,  # noqa: E731
                                          tile_k=tile_k)
    gqa = dict(enable_gqa=True) if kvh != h else {}
    call = (f"F.scaled_dot_product_attention(q, k, v, is_causal={causal}"
            f"{', enable_gqa=True' if gqa else ''})" + (f", v {dv} wide" if dv != dh else ""))
    try:
        library_ms = timed(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                  **gqa), 10)
    except RuntimeError as e:  # the yardstick only: the port never calls it
        library_ms, call = None, f"none: SDPA refused these shapes on the card ({e})"
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    row = dict(
        name=name, route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:63", launches=launches,
        max_abs_err=max(c["err_p"] for c in checks.values()),
        max_abs_err_vs_float64=max(c["err_o"] for c in checks.values()),
        ms=timed(kernel, 10), **kernel_device_ms(kernel, K4_NAMES), plain_ms=timed(plain, 3),
        library_ms=library_ms, library_call=call,
        shapes=f"q ({b}, {h}, {sq}, {dh}), k ({b}, {kvh}, {skv}, {dh}), v ({b}, {kvh}, "
               f"{skv}, {dv}) bf16, {'causal' if causal else 'non-causal'}, {what}; strides "
               f"q {list(q.stride())}, k "
               f"{list(k.stride())}, v {list(v.stride())}",
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            2 * (q.numel() + k.numel() + v.numel() + b * h * sq * dv),
            2 * b * h * pairs * (dh + dv), PEAK_BF16))))
    return row, checks


def serve_qwen2_moe_phase(dev) -> dict:
    """Qwen1.5-MoE-A2.7B LM serving at full size through ``serve_lm``: K4
    (dh 128, 16 heads over 16 kv heads) on every prefill layer and nowhere
    else. Returns K4's row at this shape."""
    import torch

    from repro_torch.configs.base import MoEConfig

    numbers, qkv, kw = moe_serve_checked(
        dev, QWEN_MOE_SERVE,
        dict(n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128, d_ff=5632,
             vocab_size=151936, qkv_bias=True,
             moe=MoEConfig(n_routed=60, n_shared=4, top_k=4, d_ff_expert=1408)),
        QWEN_MOE_LAYERS, QWEN_MOE_PARAMS)
    q, k, v = qkv
    b, sq = SERVE["slots"], SERVE["prompt_len"]
    require(q.shape == k.shape == v.shape == (b, 16, sq, 128) and q.dtype == torch.bfloat16
            and kw == dict(causal=True, tile_k=1024),
            f"served K4 call: q {tuple(q.shape)} {q.dtype}, {kw}")
    row, checks = k4_served_row(
        dev, "flash_attention[dh 128, MHA, Qwen1.5-MoE]", qkv, kw,
        numbers["launches"]["flash_attention"],
        "the last layer's q, k, v of the first batch's prefill")
    emit("serve_qwen2_moe", **numbers,
         k4_seconds=row["launches"] * row["ms"] / 1e3,
         kernel_share_of_prefill=row["launches"] * row["ms"] / 1e3 / numbers["prefill_seconds"],
         k4_tol="2^-8 (|o| + sum w|v|) + 2^-16 sum w|v| vs float64; x2 vs plain",
         k4_vs_float64={w_: [c["err_o"], c["share_o"]] for w_, c in checks.items()},
         k4_vs_plain={w_: [c["err_p"], c["share_p"]] for w_, c in checks.items()})
    return row


def serve_deepseek_v2_lite_phase(dev) -> dict:
    """DeepSeek-V2-Lite LM serving at full size through ``serve_lm``: K4 at
    MLA's widths (q and k 192 = nope 128 + rope 64, v 128; 16 heads) on
    every prefill layer and nowhere else, v the view ``kv[..., 128:]`` of
    the reconstructed kv, read in place. Returns K4's (192, 128) row: the
    served call's own q, k, v, then randn (seed 1), against its float64
    oracle and plain version."""
    import torch

    from repro_torch.configs.base import MLAConfig, MoEConfig
    from repro_torch.kernels.flash_attention import kernel_reads_in_place

    numbers, qkv, kw = moe_serve_checked(
        dev, DEEPSEEK_SERVE,
        dict(n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
             vocab_size=102400, first_layer_dense=True,
             mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                           nope_head_dim=128, v_head_dim=128),
             moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408)),
        DEEPSEEK_LAYERS, DEEPSEEK_PARAMS)
    q, k, v = qkv
    b, sq = SERVE["slots"], SERVE["prompt_len"]
    require(q.shape == k.shape == (b, 16, sq, 192) and v.shape == (b, 16, sq, 128)
            and q.dtype == v.dtype == torch.bfloat16 and not v.is_contiguous()
            and v.storage_offset() % 256 == 128 and kernel_reads_in_place(v)
            and kw == dict(causal=True, tile_k=1024),
            f"served K4 call at MLA's widths: q {tuple(q.shape)}, v {tuple(v.shape)} strides "
            f"{v.stride()} offset {v.storage_offset()}, {kw}")
    row, checks = k4_served_row(
        dev, "flash_attention[dh 192, dv 128, MLA]", qkv, kw,
        numbers["launches"]["flash_attention"],
        "the last layer's q, k, v of the first batch's prefill (v the view kv[..., 128:])")
    emit("k4_mla", dh=192, dv=128, heads=16, batch=b, tokens=sq,
         launches=numbers["launches"],
         k4_vs_float64={w_: [c["err_o"], c["share_o"]] for w_, c in checks.items()},
         k4_vs_plain={w_: [c["err_p"], c["share_p"]] for w_, c in checks.items()})
    emit("serve_deepseek_v2_lite", **numbers,
         k4_seconds=row["launches"] * row["ms"] / 1e3,
         kernel_share_of_prefill=row["launches"] * row["ms"] / 1e3 / numbers["prefill_seconds"],
         k4_tol="2^-8 (|o| + sum w|v|) + 2^-16 sum w|v| vs float64; x2 vs plain")
    return row


def serve_slots(model, params, batches: list, s_max: int, gen_len: int, dev) -> dict:
    """Greedy serving of ``batches`` (prefill inputs on the card, one slot
    batch each) through ``Model.prefill`` and ``Model.decode_step``, as
    ``serve_lm`` serves a slot batch: a fresh cache, one prefill, ``gen_len
    - 1`` decode steps, host seconds synchronised at the end of each
    prefill and of its decode steps. Each batch's logits must be finite
    and shaped, and its decode steps must launch no kernel. Returns the
    seconds, each prefill's launches, the first prefill's last-position
    logits and the generated tokens."""
    import torch

    from repro_torch.kernels import _build

    cfg = model.cfg
    out = dict(prefill_seconds=0.0, decode_seconds=0.0, prefill_launches=[], tokens=[])
    for batch in batches:
        b, prompt_len = batch["tokens"].shape
        before = launch_counts(_build.KERNELS)
        t = time.perf_counter()
        logits, cache = model.prefill(params, batch,
                                      model.init_cache(b, s_max, device=dev))
        steps = [logits[:, -1]]
        tok = logits[:, -1].argmax(-1)[:, None]
        toks = [tok]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after = launch_counts(_build.KERNELS)
        for step in range(gen_len - 1):
            logits, cache = model.decode_step(params, tok, cache, prompt_len + step)
            steps.append(logits[:, 0])
            tok = logits[:, 0].argmax(-1)[:, None]
            toks.append(tok)
        torch.cuda.synchronize()
        out["prefill_seconds"] += t1 - t
        out["decode_seconds"] += time.perf_counter() - t1
        require(launch_counts(_build.KERNELS) == after,
                f"{cfg.name}: decode steps launched {launch_counts(_build.KERNELS)}, "
                f"after {after}")
        out["prefill_launches"].append({e: n - before.get(e, 0) for e, n in after.items()
                                        if n != before.get(e, 0)})
        logits = torch.stack(steps, dim=1)
        require(logits.shape == (b, gen_len, cfg.padded_vocab)
                and bool(torch.isfinite(logits).all()), f"{cfg.name}: logits malformed")
        out.setdefault("first_logits", steps[0])
        out["tokens"].append(torch.cat(toks, dim=1))
        del cache, logits, steps
    return out


def k4_calls_of(model, params, batch: dict, s_max: int, keep_all: bool) -> tuple:
    """The prefill of ``batch`` again, with the model's K4 entry point
    (``models/attention.py``'s ``flash_attention``) wrapped to keep its
    calls' arguments: all of them in order, or only the last. Returns the
    logits and the calls ``[((q, k, v), kwargs)]``."""
    from unittest import mock

    from repro_torch.models import attention as attention_module

    calls, real = [], attention_module.flash_attention

    def keep(*a, **kw):
        if not keep_all:
            calls.clear()
        calls.append((a, kw))
        return real(*a, **kw)

    with mock.patch.object(attention_module, "flash_attention", keep):
        logits, _ = model.prefill(params, batch, model.init_cache(
            batch["tokens"].shape[0], s_max, device=batch["tokens"].device))
    return logits, calls


def prefill_vs_plain_k4(model, params, batch: dict, s_max: int, logits_k, what: str) -> dict:
    """A prefill's last-position logits through K4 (``logits_k``) against
    the same weights and inputs with K4's plain version in its place:
    fails beyond LOGIT_TOL of the largest |logit|. Returns the error, its
    share of the limit, the scale and the greedy tokens' agreement."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import attention as attention_module

    vocab = model.cfg.vocab_size
    with mock.patch.object(attention_module, "flash_attention", flash_attention_plain):
        logits_p, _ = model.prefill(params, batch, model.init_cache(
            batch["tokens"].shape[0], s_max, device=batch["tokens"].device))
    lk, lp = logits_k.float(), logits_p[:, -1].float()
    scale, err = float(lp.abs().max()), max_err(lk, lp)
    require(err <= LOGIT_TOL * scale, f"{model.cfg.name} {what} logits through K4 vs plain: "
                                      f"max abs err {err:.4g} > {LOGIT_TOL} x {scale:.4g}")
    greedy = float((lk[:, :vocab].argmax(-1) == lp[:, :vocab].argmax(-1)).float().mean())
    return dict(max_abs_err=err, share_of_limit=err / (LOGIT_TOL * scale), scale=scale,
                greedy_agreement=greedy)


def serve_whisper_small_phase(dev) -> list[dict]:
    """Whisper-small served at full size (WHISPER_SERVE) through
    ``serve_slots``: K4 on every encoder layer of each prefill, and with
    the 2,048-token decoder prompt on the decoder's self and cross
    attention too, nowhere else. The first batch's logits and the long
    batch's through K4 against K4's plain version. Returns K4's rows for
    the last layer's encoder call and its cross call."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import EncDecConfig
    from repro_torch.kernels import _build
    from repro_torch.models import Model, count_params
    from repro_torch.models.model import FRONTEND_DIM, _leaves

    sv, n_l = WHISPER_SERVE, WHISPER_LAYERS
    cfg = get_config(sv["arch"])
    widths = dict(n_layers=n_l, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
                  d_ff=3072, vocab_size=51865, rope_theta=10000.0, tie_embeddings=False,
                  encdec=EncDecConfig(n_enc_layers=n_l, n_enc_positions=1500))
    got = {name: getattr(cfg, name) for name in widths}
    require(got == widths, f"{sv['arch']} widths {got}, want {widths}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init_params(gen, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    require(n_params == count_params(cfg) == cfg.param_count() == WHISPER_PARAMS,
            f"{sv['arch']}: served params {n_params}, want {WHISPER_PARAMS}")
    n_enc, slots = cfg.encdec.n_enc_positions, sv["slots"]
    gen.manual_seed(1)
    frames = torch.randn((sv["requests"], n_enc, FRONTEND_DIM["audio"]), generator=gen,
                         device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (sv["requests"],
                                            sv["prompt_len"]), dtype=np.int32)).to(dev)
    long_prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        slots, sv["long_prompt_len"]), dtype=np.int32)).to(dev)
    short = [{"tokens": prompts[i:i + slots], "frames": frames[i:i + slots]}
             for i in range(0, sv["requests"], slots)]
    long = {"tokens": long_prompts, "frames": frames[:slots]}
    s_short = sv["prompt_len"] + sv["gen_len"]
    s_long = sv["long_prompt_len"] + sv["long_gen_len"]
    require(model._impl(sv["prompt_len"]) == "full" and model._impl(n_enc) == "chunked"
            and model._impl(sv["long_prompt_len"]) == "chunked",
            "whisper-small: the prompts do not take the impls the phase counts on")
    setup_seconds = time.perf_counter() - t0

    for k in _build.KERNELS:
        k.launches.clear()
    t = time.perf_counter()
    res_s = serve_slots(model, params, short, s_short, sv["gen_len"], dev)
    res_l = serve_slots(model, params, [long], s_long, sv["long_gen_len"], dev)
    seconds = time.perf_counter() - t
    launches = launch_counts(_build.KERNELS)
    want = {"flash_attention": 2 * n_l + 3 * n_l}
    require(launches == want, f"{sv['arch']}: launches {launches}, want {want}")
    require(res_s["prefill_launches"] == [{"flash_attention": n_l}] * 2
            and res_l["prefill_launches"] == [{"flash_attention": 3 * n_l}],
            f"{sv['arch']}: prefill launches {res_s['prefill_launches']}, "
            f"{res_l['prefill_launches']}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # K4's calls in the long batch's prefill: the encoder's 12 (non-causal,
    # 1,500 x 1,500), then each decoder layer's self (causal, 2,048) and
    # cross (non-causal, 2,048 x 1,500) attention
    logits_rep, calls = k4_calls_of(model, params, long, s_long, keep_all=True)
    repeat_equal = torch.equal(logits_rep[:, -1], res_l["first_logits"])
    b, h, dh = slots, cfg.n_heads, cfg.head_dim
    kinds = ([("encoder", (b, h, n_enc, dh), n_enc, dict(causal=False, tile_k=750))] * n_l
             + [("self", (b, h, sv["long_prompt_len"], dh), sv["long_prompt_len"],
                 dict(causal=True, tile_k=1024)),
                ("cross", (b, h, sv["long_prompt_len"], dh), n_enc,
                 dict(causal=False, tile_k=750))] * n_l)
    require(len(calls) == len(kinds), f"{sv['arch']}: {len(calls)} K4 calls in the long "
                                      f"prefill, want {len(kinds)}")
    for ((q, k, v), kw), (kind, q_shape, skv, want_kw) in zip(calls, kinds):
        require(tuple(q.shape) == q_shape and k.shape == v.shape == (b, h, skv, dh)
                and q.dtype == k.dtype == v.dtype == torch.bfloat16 and kw == want_kw,
                f"{sv['arch']} {kind} K4 call: q {tuple(q.shape)}, k {tuple(k.shape)} "
                f"{k.dtype}, {kw}")
    enc_call, cross_call = calls[n_l - 1], calls[-1]
    del calls, logits_rep

    vs_plain = {"first_batch": prefill_vs_plain_k4(model, params, short[0], s_short,
                                                   res_s["first_logits"], "first batch"),
                "long_prompt": prefill_vs_plain_k4(model, params, long, s_long,
                                                   res_l["first_logits"], "long prompt")}
    encoder_ms = timed(lambda: model._encoder(params, short[0]["frames"]), 3)
    prefill_ms = {
        "first_batch": timed(lambda: model.prefill(params, short[0], model.init_cache(
            slots, s_short, device=dev)), 3),
        "long_prompt": timed(lambda: model.prefill(params, long, model.init_cache(
            slots, s_long, device=dev)), 3)}
    rows, checks = [], {}
    for (name, call, n, what) in (
            ("flash_attention[dh 64, non-causal, Whisper encoder]", enc_call, 3 * n_l,
             "the last encoder layer's q, k, v of the long batch's prefill"),
            ("flash_attention[dh 64, cross 2048 x 1500, Whisper decoder]", cross_call, n_l,
             "the last decoder layer's cross-attention q, k, v of the long batch's prefill")):
        row, checks[name] = k4_served_row(dev, name, call[0], call[1], n, what)
        rows.append(row)
    tokens = sv["requests"] * sv["gen_len"] + slots * sv["long_gen_len"]
    served = res_s["prefill_seconds"] + res_s["decode_seconds"] + res_l["prefill_seconds"] \
        + res_l["decode_seconds"]
    emit("serve_whisper_small", card=card_line(), arch=sv["arch"], params=n_params,
         requests=sv["requests"], slots=slots, frames=n_enc, prompt_len=sv["prompt_len"],
         gen_len=sv["gen_len"], long_prompt_len=sv["long_prompt_len"],
         long_gen_len=sv["long_gen_len"], launches=launches,
         prefill_launches=res_s["prefill_launches"] + res_l["prefill_launches"],
         setup_seconds=setup_seconds, seconds=seconds,
         prefill_seconds=res_s["prefill_seconds"], decode_seconds=res_s["decode_seconds"],
         long_prefill_seconds=res_l["prefill_seconds"],
         long_decode_seconds=res_l["decode_seconds"],
         tokens_per_second=tokens / served, peak_memory_gb=peak_gb,
         encoder_ms=encoder_ms, prefill_ms=prefill_ms,
         encoder_share_of_prefill={w_: encoder_ms / ms for w_, ms in prefill_ms.items()},
         long_prefill_repeats_bitwise=repeat_equal, logits_vs_plain=vs_plain,
         k4_seconds=sum(r["launches"] * r["ms"] for r in rows) / 1e3,
         k4_tol="2^-8 (|o| + sum w|v|) + 2^-16 sum w|v| vs float64; x2 vs plain",
         k4_vs_float64={n_: {w_: [c["err_o"], c["share_o"]] for w_, c in ch.items()}
                        for n_, ch in checks.items()},
         k4_vs_plain={n_: {w_: [c["err_p"], c["share_p"]] for w_, c in ch.items()}
                      for n_, ch in checks.items()})
    return rows


def serve_internvl2_26b_phase(dev) -> dict:
    """InternVL2-26B served at full width and 32 of its 48 layers
    (INTERNVL_SERVE) through ``serve_slots``: each prompt's first 256
    positions its patch embeddings, K4 (128, 128) at group 6 on every
    prefill layer and nowhere else; the first batch's logits through K4
    against K4's plain version, and other patch embeddings must give other
    logits. Returns K4's row at this shape."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import Model, count_params
    from repro_torch.models.model import FRONTEND_DIM, _leaves

    sv = INTERNVL_SERVE
    full = get_config(sv["arch"])
    cfg = dataclasses.replace(full, n_layers=sv["n_layers"])
    widths = dict(n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
                  d_ff=16384, vocab_size=92553, frontend="vision", n_frontend_tokens=256)
    got = {name: getattr(full, name) for name in widths}
    require(got == widths, f"{sv['arch']} widths {got}, want {widths}")
    counts = (count_params(full), count_params(cfg))
    require(counts == INTERNVL_PARAMS, f"{sv['arch']}: params {counts}, want "
                                       f"{INTERNVL_PARAMS}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init_params(gen, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    require(n_params == INTERNVL_PARAMS[1], f"{sv['arch']}: served params {n_params}")
    slots, n_img = sv["slots"], cfg.n_frontend_tokens
    gen.manual_seed(1)
    patches = torch.randn((sv["requests"], n_img, FRONTEND_DIM["vision"]), generator=gen,
                          device=dev)
    other = torch.randn((slots, n_img, FRONTEND_DIM["vision"]), generator=gen, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (sv["requests"],
                                            sv["prompt_len"]), dtype=np.int32)).to(dev)
    batches = [{"tokens": prompts[i:i + slots], "patch_embeds": patches[i:i + slots]}
               for i in range(0, sv["requests"], slots)]
    s_max = sv["prompt_len"] + sv["gen_len"]
    setup_seconds = time.perf_counter() - t0

    for k in _build.KERNELS:
        k.launches.clear()
    t = time.perf_counter()
    res = serve_slots(model, params, batches, s_max, sv["gen_len"], dev)
    seconds = time.perf_counter() - t
    launches = launch_counts(_build.KERNELS)
    n_l = sv["n_layers"]
    want = {"flash_attention": len(batches) * n_l}
    require(launches == want, f"{sv['arch']}: launches {launches}, want {want}")
    require(res["prefill_launches"] == [{"flash_attention": n_l}] * len(batches),
            f"{sv['arch']}: prefill launches {res['prefill_launches']}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    logits_rep, calls = k4_calls_of(model, params, batches[0], s_max, keep_all=False)
    repeat_equal = torch.equal(logits_rep[:, -1], res["first_logits"])
    (q, k, v), kw = calls[0]
    del calls, logits_rep
    b, sq = slots, sv["prompt_len"]
    require(q.shape == (b, 48, sq, 128) and k.shape == v.shape == (b, 8, sq, 128)
            and q.dtype == torch.bfloat16 and kw == dict(causal=True, tile_k=1024),
            f"served K4 call: q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, {kw}")
    vs_plain = prefill_vs_plain_k4(model, params, batches[0], s_max, res["first_logits"],
                                   "first batch")
    # the frontend is live: the same prompts with other patch embeddings
    logits_o, _ = model.prefill(params, {**batches[0], "patch_embeds": other},
                                model.init_cache(slots, s_max, device=dev))
    frontend_diff = max_err(logits_o[:, -1].float(), res["first_logits"].float())
    require(frontend_diff > 0, f"{sv['arch']}: other patch embeddings gave the same logits")
    del logits_o
    row, checks = k4_served_row(
        dev, "flash_attention[dh 128, group 6, InternVL2-26B]", (q, k, v), kw,
        launches["flash_attention"], "the last layer's q, k, v of the first batch's prefill")
    tokens = sv["requests"] * sv["gen_len"]
    emit("serve_internvl2_26b", card=card_line(), arch=sv["arch"], layers=n_l,
         layers_of_the_config=full.n_layers, params=n_params, params_all_layers=counts[0],
         requests=sv["requests"], slots=slots, prompt_len=sv["prompt_len"],
         image_tokens=n_img, gen_len=sv["gen_len"], launches=launches,
         prefill_launches=res["prefill_launches"], setup_seconds=setup_seconds,
         seconds=seconds, prefill_seconds=res["prefill_seconds"],
         decode_seconds=res["decode_seconds"],
         tokens_per_second=tokens / (res["prefill_seconds"] + res["decode_seconds"]),
         peak_memory_gb=peak_gb, first_batch_repeats_bitwise=repeat_equal,
         logits_vs_plain=vs_plain,
         other_patches_logits_max_abs_diff=[frontend_diff, frontend_diff / vs_plain["scale"]],
         k4_seconds=row["launches"] * row["ms"] / 1e3,
         kernel_share_of_prefill=row["launches"] * row["ms"] / 1e3 / res["prefill_seconds"],
         k4_tol="2^-8 (|o| + sum w|v|) + 2^-16 sum w|v| vs float64; x2 vs plain",
         k4_vs_float64={w_: [c["err_o"], c["share_o"]] for w_, c in checks.items()},
         k4_vs_plain={w_: [c["err_p"], c["share_p"]] for w_, c in checks.items()})
    return row


def leaf_scale(leaves: dict, path: str) -> float:
    """The largest |entry| of leaf ``path`` of a gradient tree (``leaves``:
    path -> tensor); for a k bias, self or cross attention's, whose exact
    gradient is 0 (softmax is invariant to a shift shared by a query's
    keys), its layer's ``wk``'s if larger (``tests/test_torch_train.py``
    holds gradients the same way)."""
    scale = float(leaves[path].abs().max())
    if path.endswith(("attn/bk", "cross/bk")):
        scale = max(scale, float(leaves[path[:-2] + "wk"].abs().max()))
    return scale


def tree_paths(tree, path: tuple = ()) -> dict:
    """path -> leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items() for p, t in tree_paths(v, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: t for i, v in enumerate(tree)
                for p, t in tree_paths(v, path + (str(i),)).items()}
    return {"/".join(path): tree}


def grad_shares(got, want) -> dict:
    """Per leaf: the largest |got - want| over ``leaf_scale`` of want, over
    TRAIN_GRAD_TOL (1 is the limit). A leaf whose gradient is 0 in want
    (RWKV6's ``w_lora_a`` at initialisation, behind a zero ``w_lora_b``)
    must be 0 in got too: its share is 0, or infinite."""
    g, w = tree_paths(got), tree_paths(want)

    def share(p: str) -> float:
        err, scale = float((g[p].float() - w[p].float()).abs().max()), leaf_scale(w, p)
        return err / (TRAIN_GRAD_TOL * scale) if scale else (0.0 if err == 0 else math.inf)

    return {p: share(p) for p in w}


def k4_bwd_row(dev, qkv: tuple, dout, launches: int, launches_per_step: int,
               name: str = "flash_attention_bwd[dh 64, group 7, Qwen2-0.5B train]",
               causal: bool = True, what: str = "the last layer's q, k, v of the first "
                                                "train step") -> tuple:
    """K4's backward kernel (``causal`` or not, Skv may differ from Sq) on
    a train call's own q, k, v (with randn dout) and on randn tensors of
    the same shapes: against its float64 gradient (``k4_grad_oracle``) and
    its plain version on the same output and LSE, the same bits on a
    second call, and the no-D control (a zero output) beyond the float64
    limit; then its ms, device ms (three kernels a call, and each kernel's
    apart), plain ms and SDPA's backward (forward + backward less forward;
    None where SDPA refuses the shapes); first, that every bf16 backward
    kernel issues HGMMA and has no stack frame or local memory (no spill).
    The bound counts the (query, key) pairs the call scores, as
    ``k4_served_row``'s. Returns the kernels line's row and the checks."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (WIDTHS, _forward, flash_attention_bwd,
                                                     flash_attention_bwd_plain)

    q, k, v = qkv
    b, h, sq, dh = q.shape
    kvh, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    require(not causal or skv == sq, f"{name}: a causal call with Sq {sq} != Skv {skv}")
    # every bf16 backward kernel (two a compiled pair) runs on wgmma and spills nothing
    resources = k4_bwd_kernels()
    require(len(resources) == 2 * len(WIDTHS) and all(r[3] and r[1] == 0 and r[2] == 0
                                                      for r in resources.values()),
            f"K4 backward's bf16 kernels (registers, stack, local, HGMMA): {resources}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    checks = {}
    for case, (q_, k_, v_) in (("train", (q, k, v)), ("randn", k4_randn(dev, q, k, v))):
        do = torch.randn((b, h, sq, dv), generator=gen, device=dev).bfloat16()
        out, lse = _forward(q_, k_, v_, causal, with_lse=True)
        got = flash_attention_bwd(q_, k_, v_, out, do, lse, causal)
        again = flash_attention_bwd(q_, k_, v_, out, do, lse, causal)
        plain = flash_attention_bwd_plain(q_, k_, v_, out, do, lse, causal, 1024)
        oracle = k4_grad_oracle(q_, k_, v_, do, causal)
        worst = dict(err_o=0.0, share_o=0.0, err_p=0.0, share_p=0.0)
        for n, g_, a_, p_ in zip(("dq", "dk", "dv"), got, again, plain):
            exact, lim, lim_p = oracle[n]
            require(torch.equal(g_, a_), f"K4 backward ({case}) {n}: two calls differ")
            bad_o, err_o, share_o = beyond(g_, exact, lim)
            bad_p, err_p, share_p = beyond(g_, p_, lim_p)
            require(bad_o == 0, f"K4 backward ({case}) {n} vs float64: {bad_o} entries "
                                f"beyond the limit, max abs err {err_o:.3g}")
            require(bad_p == 0, f"K4 backward ({case}) {n} vs plain: {bad_p} entries "
                                f"beyond the limit, max abs err {err_p:.3g}")
            for key, val in (("err_o", err_o), ("share_o", share_o), ("err_p", err_p),
                             ("share_p", share_p)):
                worst[key] = max(worst[key], val)
        no_d = flash_attention_bwd(q_, k_, v_, torch.zeros_like(out), do, lse, causal)
        worst["no_d_control_entries_beyond"] = sum(
            beyond(g_, oracle[n][0], oracle[n][1])[0] for n, g_ in zip(("dq", "dk"), no_d))
        require(worst["no_d_control_entries_beyond"] > 0,
                f"K4 backward ({case}): the control without the D term passes the limit")
        checks[case] = worst
        del out, lse, got, again, plain, oracle, no_d
    do = torch.randn((b, h, sq, dv), generator=gen, device=dev).bfloat16()
    out, lse = _forward(q, k, v, causal, with_lse=True)
    kernel = lambda: flash_attention_bwd(q, k, v, out, do, lse, causal)  # noqa: E731
    plain = lambda: flash_attention_bwd_plain(q, k, v, out, do, lse, causal, 1024)  # noqa: E731
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    gqa = dict(enable_gqa=True) if kvh != h else {}

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, **gqa)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), do)

    call = (f"F.scaled_dot_product_attention(q, k, v, is_causal={causal}"
            f"{', enable_gqa=True' if gqa else ''}) forward + backward")
    try:
        fwd_ms, fwd_bwd_ms = timed(sdpa_fwd, 10), timed(sdpa_fwd_bwd, 10)
        library_ms = fwd_bwd_ms - fwd_ms
        call += f" ({fwd_bwd_ms:.4g} ms) less forward ({fwd_ms:.4g} ms)"
    except RuntimeError as e:  # the yardstick only: the port never calls it
        library_ms, call = None, f"none: SDPA refused these shapes on the card ({e})"
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    row = dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:63 (its gradient: the reference "
                 "differentiates src/repro/models/attention.py:136 chunked_attention "
                 "with jax.value_and_grad; it has no Pallas backward)",
        launches=launches, launches_per_step=launches_per_step,
        max_abs_err=max(c["err_p"] for c in checks.values()),
        max_abs_err_vs_float64=max(c["err_o"] for c in checks.values()),
        ms=timed(kernel, 5), **kernel_device_ms(kernel, ("bwd_",), reps=3),
        device_ms_by_kernel={n: kernel_device_ms(kernel, (n,), reps=3)["device_ms"]
                             for n in ("bwd_delta", "bwd_dkdv", "bwd_dq")},
        bf16_kernels=resources,
        bf16_kernels_keys="[registers a thread, stack bytes, local bytes, HGMMA in the "
                          "SASS] (cuobjdump -res-usage and -sass of the built library)",
        plain_ms=timed(plain, 2), library_ms=library_ms, library_call=call,
        shapes=f"q ({b}, {h}, {sq}, {dh}), k ({b}, {kvh}, {skv}, {dh}), v ({b}, {kvh}, "
               f"{skv}, {dv}), dout ({b}, {h}, {sq}, {dv}) bf16, "
               f"{'causal' if causal else 'non-causal'}; {what}, dout randn",
        # the function's five products (s, dP, dV, dK, dQ) at the bf16 peak;
        # bytes: q, k, v, out, dout and the LSE read, dq, dk, dv written
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + 2 * out.numel())
            + 4 * lse.numel(),
            2 * b * h * pairs * (3 * dh + 2 * dv), PEAK_BF16))))
    return row, checks


def train_qwen2_0_5b_phase(dev) -> list[dict]:
    """Qwen2-0.5B training at full width through ``launch/train.py``: 8 x
    2,048 tokens a step, packed by the DaphneSched data pipeline, remat
    "full", AdamW, a checkpoint written and restored. First the first
    step's loss and gradients through K4 (forward and backward kernels)
    against the same step through K4's two plain versions, and the control
    with the attention output detached; then the launcher's run with the
    counters set to 0 just before and read just after (exactly 48 forward
    and 24 backward K4 launches a step), the restored checkpoint bitwise
    the final state, and a resumed run. Returns K4's forward and backward
    rows at (64, 64), group 7."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_launch
    from repro_torch.models import count_params

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN["arch"])
    widths = dict(n_layers=TRAIN_LAYERS, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
                  d_ff=4864, vocab_size=151936, tie_embeddings=True, remat=True,
                  remat_policy="full", attn_impl="chunked", attn_chunk_kv=1024)
    got = {n: getattr(cfg, n) for n in widths}
    require(got == widths, f"{TRAIN['arch']} widths {got}, want {widths}")
    require(count_params(cfg) == QWEN2_PARAMS,
            f"{TRAIN['arch']}: {count_params(cfg)} params, want {QWEN2_PARAMS}")
    b, seq = TRAIN["global_batch"], TRAIN["seq"]

    # -- the first step's gradients: K4 against its plain pair ---------------
    pipe = DataPipeline(SyntheticCorpus(vocab_size=cfg.vocab_size, mean_len=seq // 2), b, seq)
    t = time.perf_counter()
    tokens = pipe.assemble(0)
    assembly_s = time.perf_counter() - t
    grad, calls = first_step_grad_check(dev, cfg, {"tokens": torch.from_numpy(tokens).to(dev)},
                                        k4_checked())
    require(grad["launches"] == {"flash_attention": 2 * TRAIN_LAYERS,
                                 "flash_attention_bwd": TRAIN_LAYERS},
            f"one K4 gradient of the train loss launched {grad['launches']}")
    (q, k, v), kw = calls[-1]
    del calls

    # -- the launcher's run, a checkpoint, and a resumed run ------------------
    tmp = Path(tempfile.mkdtemp(prefix="train_ckpt_"))
    try:
        def argv(n_steps: int) -> list[str]:
            return ["--arch", TRAIN["arch"], "--seq", str(seq), "--global-batch", str(b),
                    "--steps", str(n_steps), "--ckpt-dir", str(tmp),
                    "--checkpoint-every", str(TRAIN["steps"]), "--device", "cuda"]

        for k_ in _build.KERNELS:
            k_.launches.clear()
        run = train_launch.main(argv(TRAIN["steps"]))
        torch.cuda.synchronize()
        launches = launch_counts(_build.KERNELS)
        steps = TRAIN["steps"]
        require(launches == {"flash_attention": 2 * TRAIN_LAYERS * steps,
                             "flash_attention_bwd": TRAIN_LAYERS * steps},
                f"train: launches {launches} in {steps} steps")
        rep = run.report
        require(rep.steps_run == steps and rep.retries == 0 and rep.resumed_from is None,
                f"train report {rep}")
        losses = [m["loss"] for m in run.metrics]
        require(len(losses) == steps and all(math.isfinite(x) for x in losses),
                f"train losses {losses}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        require(ckpt.latest_step(tmp) == steps - 1, f"checkpoint steps in {list(tmp.iterdir())}")
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / f"step_{steps - 1:08d}").iterdir())
        t = time.perf_counter()
        tree, _, step = ckpt.restore(tmp, device=dev)
        restore_s = time.perf_counter() - t
        saved, final = tree_paths(tree), tree_paths(run.state.__dict__)
        require(step == steps - 1 and set(saved) == set(final)
                and all(torch.equal(saved[p], final[p]) for p in final),
                "the restored checkpoint differs from the final state")
        del tree, saved
        # the step's device busy share, one step under the profiler
        busy = train_step_busy(run.model, run.state, dict(tokens=torch.from_numpy(
            run.pipeline.assemble(TRAIN["steps"])).to(dev)))
        run_tps = run.tokens_per_second
        del run
        gc.collect()
        torch.cuda.empty_cache()
        for k_ in _build.KERNELS:
            k_.launches.clear()
        resumed = train_launch.main(argv(1))
        require(resumed.report.resumed_from == steps - 1 and resumed.report.steps_run == 1
                and launch_counts(_build.KERNELS) == {
                    "flash_attention": 2 * TRAIN_LAYERS, "flash_attention_bwd": TRAIN_LAYERS},
                f"resumed run: {resumed.report}, launches {launch_counts(_build.KERNELS)}")
        require(math.isfinite(resumed.metrics[0]["loss"]), "resumed loss not finite")
        step_times = rep.step_times
        # a save of the resumed run's state, timed (the host copy, then the
        # write), the run's checkpoint gone first: one state on disk at a time
        shutil.rmtree(tmp)
        t = time.perf_counter()
        ckpt.save_async(tmp, steps, resumed.state.__dict__)
        snapshot_s = time.perf_counter() - t
        ckpt.wait_for_pending()
        write_s = time.perf_counter() - t - snapshot_s
        del resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- K4 at the training shape ----------------------------------------------
    require(q.shape == (b, 14, seq, 64) and k.shape == v.shape == (b, 2, seq, 64)
            and q.dtype == torch.bfloat16 and kw == dict(causal=True, tile_k=1024),
            f"the train call of K4: q {tuple(q.shape)} {q.dtype}, {kw}")
    fwd_row, fwd_checks = k4_served_row(
        dev, "flash_attention[dh 64, group 7, Qwen2-0.5B train]", (q, k, v), kw,
        launches["flash_attention"], "the last layer's q, k, v of the first train step")
    fwd_row["launches_per_step"] = 2 * TRAIN_LAYERS
    do = torch.randn((b, 14, seq, 64), device=dev).bfloat16()
    bwd_row, bwd_checks = k4_bwd_row(dev, (q, k, v), do, launches["flash_attention_bwd"],
                                     TRAIN_LAYERS)
    del q, k, v, do
    step_s = statistics.median(step_times)
    emit("train_qwen2_0_5b", arch=TRAIN["arch"], params=QWEN2_PARAMS, batch=b, seq=seq,
         steps=TRAIN["steps"], launches=launches,
         losses=losses, step_seconds=step_times, step_seconds_median=step_s,
         tokens_per_second=b * seq / step_s, run_tokens_per_second=run_tps,
         assembly_seconds=assembly_s, assembly_share_of_step=assembly_s / step_s,
         first_gradient_seconds=grad["seconds"], peak_memory_gb=peak_gb, step_busy=busy,
         checkpoint_bytes=ckpt_bytes, checkpoint_snapshot_seconds=snapshot_s,
         checkpoint_write_seconds=write_s, restore_seconds=restore_s,
         resumed_from=steps - 1,
         first_step_loss=grad["loss"], first_step_loss_err=grad["loss_err"],
         grad_tol=f"{TRAIN_GRAD_TOL} of each leaf's largest |gradient| (a k bias: its "
                  "wk's) through K4's plain pair",
         grad_worst=grad["worst"], grad_shares_by_leaf_kind=grad["shares_by_leaf_kind"],
         detached_control_worst=grad["detached_control_worst"],
         k4_tol="2^-8 (|o| + sum w|v|) + 2^-16 sum w|v| vs float64; x2 vs plain",
         k4_vs_float64={w_: [c["err_o"], c["share_o"]] for w_, c in fwd_checks.items()},
         k4_bwd_tol="u (|g| + D's rounding carried) + (2^-14 + u) sum|terms| vs float64; "
                    "2u|g| + (2^-13 + u) sum|terms| vs plain (u = 2^-8: P and dS rounded "
                    "to bf16 as operands)",
         k4_bwd_vs_float64={w_: [c["err_o"], c["share_o"]] for w_, c in bwd_checks.items()},
         k4_bwd_vs_plain={w_: [c["err_p"], c["share_p"]] for w_, c in bwd_checks.items()},
         k4_bwd_no_d_control={w_: c["no_d_control_entries_beyond"]
                              for w_, c in bwd_checks.items()},
         dout_copies=dict(fa.DOUT_COPIES),
         seconds=time.perf_counter() - t_phase)
    return [fwd_row, bwd_row]


def first_step_grad_check(dev, cfg, batch: dict, checked: tuple, plain: tuple = (),
                          truth=None) -> tuple[dict, list]:
    """The first step's loss and gradient leaves of ``cfg`` on ``batch``
    through the kernels against the same step through plain pairs, each
    leaf within the limit and the loss within TRAIN_LOSS_RTOL; then the
    control, the kernels' step with the checked function's output
    detached, which must fail the limit. ``checked``: ``(module, name,
    plain pair)`` of the function whose calls are recorded and detached
    (K4, or a scan's wrapper); ``plain``: more such triples whose pairs
    join the yardstick run (Zamba2's K4). The limit is TRAIN_GRAD_TOL, or
    with ``truth`` (the checked function in float64, see RWKV_TRAIN)
    max(1, 2 rho_P) of it for each leaf kind, rho_P the plain pairs'
    step's worst share of that kind against the step through ``truth``,
    and the kernels' step is held to that step within it too. In an MoE
    model a near tie flips an expert between two runs whose attention
    rounds apart (see TIE_ULPS), so the other runs replay the kernel run's
    routing (``replayed_routing``), and a free plain run's routing is
    reported against it (``routing_flips``). Returns the numbers, with the
    kernel run's launches, and its calls of the checked function ``(args,
    kwargs)``, tensors detached, in call order (the forward's, then the
    remat recomputes')."""
    from unittest import mock

    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import Model
    from repro_torch.runtime import loss_and_grads

    module, fn_name, pair = checked
    model = Model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init_params(gen)
    fn = getattr(module, fn_name)
    calls = []

    def keep(*a, **kw):
        calls.append((tuple(x.detach() if isinstance(x, torch.Tensor) else x for x in a), kw))
        return fn(*a, **kw)

    def detached(*a, **kw):
        out = fn(*a, **kw)
        return tuple(t.detach() for t in out) if isinstance(out, tuple) else out.detach()

    def through(checked_fn, others=(), routes=None):
        with contextlib.ExitStack() as stack:
            for mod, name, f in ((module, fn_name, checked_fn), *others):
                stack.enter_context(mock.patch.object(mod, name, f))
            if routes is not None:
                stack.enter_context(replayed_routing(routes))
            return loss_and_grads(model, params, batch)

    for k_ in _build.KERNELS:
        k_.launches.clear()
    t = time.perf_counter()
    with route_log() as routes:
        loss_k, _, grads_k = through(keep)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t
    launches = launch_counts(_build.KERNELS)
    replay = routes if cfg.moe is not None else None
    loss_p, _, grads_p = through(pair, plain, replay)
    torch.cuda.synchronize()
    require(launch_counts(_build.KERNELS) == launches,
            f"the plain pairs launched {launch_counts(_build.KERNELS)} after {launches}")
    shares = grad_shares(grads_k, grads_p)
    limits, witness = None, None    # limits: per leaf kind, in TRAIN_GRAD_TOL
    if truth is not None:
        _, _, grads_t = through(truth, plain, replay)
        torch.cuda.synchronize()
        require(launch_counts(_build.KERNELS) == launches,
                f"the float64 step launched {launch_counts(_build.KERNELS)} after {launches}")
        rho_p, rho_k = grad_shares(grads_p, grads_t), grad_shares(grads_k, grads_t)
        del grads_t
        limits = {kind: max(1.0, 2.0 * v) for kind, v in share_summary(rho_p).items()}
        witness = dict(plain_pairs_vs_float64=share_summary(rho_p),
                       kernels_vs_float64=share_summary(rho_k))

    def over(sh: dict) -> dict:  # each leaf's share over its limit
        return {q: v / (limits[leaf_kind(q)] if limits else 1.0) for q, v in sh.items()}

    def worst_of(sh: dict) -> list:
        o = over(sh)
        q = max(o, key=o.get)
        return [q, sh[q], o[q]]

    loss_err = abs(float(loss_k) - float(loss_p))
    worst = worst_of(shares)
    require(math.isfinite(float(loss_k)) and loss_err <= TRAIN_LOSS_RTOL * abs(float(loss_p)),
            f"{cfg.name} first-step loss through the kernels {float(loss_k)} vs plain "
            f"{float(loss_p)}")
    require(worst[2] <= 1.0, f"{cfg.name} first-step gradient through the kernels vs the "
                             f"plain pairs: {worst} (leaf, share, share of its limit)")
    if witness is not None:
        witness["kernels_vs_float64_worst"] = worst_of(rho_k)
        require(witness["kernels_vs_float64_worst"][2] <= 1.0,
                f"{cfg.name} first-step gradient through the kernels vs the float64 step: "
                f"{witness['kernels_vs_float64_worst']} (leaf, share, share of its limit)")
    del grads_k
    routing = None
    if replay is not None:
        with route_log() as free:
            through(pair, plain)
        flips = []
        for (kx, kidx, w), (px, pidx, _) in zip(routes, free, strict=True):
            k_logits = (kx.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
            flips.append(routing_flips((kx, k_logits, kidx), (px, pidx), w, cfg.moe))
        routing = dict(calls=len(flips), positions_a_call=int(routes[0][1].shape[0]),
                       near_tie_by_call=[len(f["near_tie"]) for f in flips],
                       capacity_by_call=[len(f["capacity"]) for f in flips],
                       unexplained_by_call=[len(f["unexplained"]) for f in flips],
                       logits_worst_share_of_bound=max(f["worst_share"] for f in flips))
        del free, flips
    _, _, grads_d = through(detached, routes=replay)
    control = worst_of(grad_shares(grads_d, grads_p))
    require(control[2] > 1.0, f"{cfg.name}: the control with {fn_name}'s output detached "
                              f"passes the gradient limit: {control} (leaf, share, share "
                              "of its limit)")
    del grads_d, grads_p, params, model, routes
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(layers=cfg.n_layers, launches=launches, seconds=grad_s,
               yardstick=" and ".join(p.__name__ for _, _, p in (checked, *plain))
               + (", the kernel run's routing replayed" if replay is not None else ""),
               loss=[float(loss_k), float(loss_p)], loss_err=loss_err,
               worst=worst, shares_by_leaf_kind=share_summary(shares),
               detached_control_worst=control)
    if limits is not None:
        out["limits_by_leaf_kind"] = limits
        out["float64_witness"] = witness
    if routing is not None:
        out["routing_two_free_runs"] = routing
    if cfg.encdec is not None:
        out["enc_layers"] = cfg.encdec.n_enc_layers
    return out, calls


def k4_checked():
    """K4 as ``first_step_grad_check`` takes it: the model's attention
    module, the name it calls K4 by, and K4's plain pair."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attention_module

    return attention_module, "flash_attention", fa.flash_attention_plain_pair


def rwkv6_float64_pair(r, k, v, logw, u, chunk: int = 64):
    """``rwkv6_scan_state``'s function and gradient in float64: the
    sequential oracle (``kernels/ref.py:rwkv6_scan_ref``) forward and
    ``rwkv6_scan_bwd_plain`` in float64, given back in float32 and the
    inputs' dtypes. The truth RWKV6's train steps are read against (see
    RWKV_TRAIN)."""
    import torch

    from repro_torch.kernels.ref import rwkv6_scan_ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd_plain

    class Float64Scan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, logw, u):
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(r, k, v, logw, u)
            y, state = rwkv6_scan_ref(r, k, v, logw, u, dtype=torch.float64,
                                      return_state=True)
            return y.float(), state.float()

        @staticmethod
        def backward(ctx, dy, dstate):
            r, k, v, logw, u = ctx.saved_tensors
            if dy is None:
                dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
            grads = rwkv6_scan_bwd_plain(r, k, v, logw, u, dy, dstate, chunk,
                                         dtype=torch.float64)
            return tuple(g.to(t.dtype) for g, t in zip(grads, (r, k, v, logw, u)))

    return Float64Scan.apply(r, k, v, logw, u)


def rwkv6_forward_witness(calls: list) -> dict:
    """K6 and its plain version on each of a train step's forward calls
    (``calls``: ``((r, k, v, logw, u, chunk), kwargs)``) against the float64 oracle
    within K6's limit (``rwkv6_limits``), y and the final state. Returns
    the worst share of the limit of each, per call."""
    import torch

    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain, rwkv6_scan_state

    out = []
    for i, ((r, k, v, logw, u, chunk), _) in enumerate(calls):
        with torch.no_grad():
            got = rwkv6_scan_state(r, k, v, logw, u, chunk)
            plain = rwkv6_scan_plain(r, k, v, logw, u, chunk)
        oracle, limits, cmax = rwkv6_limits(r, k, v, logw, u, min(chunk, r.shape[2]))
        row = dict(largest_chunk_cumsum=cmax)
        for part, g, pl, o, lim in zip(("y", "state"), got, plain, oracle, limits):
            bad_k, err_k, share_k = beyond(g, o, lim)
            bad_p, err_p, share_p = beyond(pl, o, lim)
            require(bad_k == 0 and bad_p == 0,
                    f"RWKV6 train call {i} {part} vs float64: {bad_k} entries of K6 and "
                    f"{bad_p} of the plain version beyond K6's limit (max abs err "
                    f"{err_k:.3g}, {err_p:.3g})")
            row[part] = dict(k6=[err_k, share_k], plain=[err_p, share_p])
        out.append(row)
        del got, plain, oracle, limits
        torch.cuda.empty_cache()
    return out


def scan_bwd_row(dev, kind: str, args: tuple, chunk: int, launches: int,
                 launches_per_step: int, what: str) -> tuple:
    """K5' (``kind`` "ssm") or K6' ("rwkv6") alone, on a train call's own
    inputs (``args``, ``what``) and on randn inputs of the same shapes (K6:
    fast decay), y's gradient randn and the final state's none (as in
    training): against the float64 gradient within ``scan_bwd_limits`` and
    the plain backward within twice it, the same bits on a second call, the
    dropped-carry control beyond the limit; HMMA in the SASS of its two
    product kernels in both input types, with no stack frame or local
    memory; then its ms, device ms (three launches a call, and each
    kernel's apart), plain ms and bound. Returns the kernels line's row and
    the checks."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rwkv6_scan, ssm_scan

    mod = ssm_scan if kind == "ssm" else rwkv6_scan
    # the two kernels that issue products, in both input types, run on the
    # tensor cores (HMMA: mma.sync) and spill nothing
    resources = scan_bwd_kernels(f"{kind}_scan_bwd")
    require(len(resources) == 4 and all(r[3] and r[1] == 0 and r[2] == 0
                                        for r in resources.values()),
            f"{kind} backward's product kernels (registers, stack, local, HMMA): {resources}")
    bwd = mod.ssm_scan_bwd if kind == "ssm" else mod.rwkv6_scan_bwd
    plain_bwd = mod.ssm_scan_bwd_plain if kind == "ssm" else mod.rwkv6_scan_bwd_plain
    names = ("x", "dt", "A", "B", "C") if kind == "ssm" else ("r", "k", "v", "logw", "u")
    kernels = (("ssm_bwd_states", "ssm_bwd_chunks", "ssm_bwd_fold") if kind == "ssm" else
               ("rwkv6_bwd_states", "rwkv6_bwd_chunks", "rwkv6_bwd_fold"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    if kind == "ssm":
        x, dt, A, B, C = args
        randn = (torch.randn(x.shape, generator=gen, device=dev).to(x.dtype),
                 F.softplus(torch.randn(dt.shape, generator=gen, device=dev)),
                 -torch.exp(torch.randn(A.shape, generator=gen, device=dev) * 0.5),
                 torch.randn(B.shape, generator=gen, device=dev).to(B.dtype),
                 torch.randn(C.shape, generator=gen, device=dev).to(C.dtype))
    else:
        r = args[0]
        randn = (*(torch.randn(r.shape, generator=gen, device=dev).to(r.dtype)
                   for _ in range(3)),
                 torch.clamp(-torch.exp(torch.randn(r.shape, generator=gen, device=dev) * 4.0),
                             min=-30.0),
                 torch.randn(args[4].shape, generator=gen, device=dev) * 0.1)
    q = mod.kernel_chunk(mod.seq_chunk(args[0].shape[2 if kind == "rwkv6" else 1], chunk),
                         mod.MAX_CHUNK)
    def forward(inputs):  # y and the backward's scratch: (cum, states) or (states, final)
        out = mod._forward(*inputs, chunk)
        return out[0], (out[2:] if kind == "ssm" else (out[2], out[1]))

    checks = {}
    for which, inputs in (("train", args), ("randn", randn)):
        y, scratch = forward(inputs)
        dy = torch.randn(y.shape, generator=gen, device=dev)
        del y
        got = bwd(*inputs, *scratch, dy, None)
        again = bwd(*inputs, *scratch, dy, None)
        plain = plain_bwd(*inputs, dy, None, chunk)
        limits = scan_bwd_limits(kind, dict(zip(names, inputs)), dy, None, q)
        control = scan_bwd_dropped_carry(kind, inputs, chunk, dy, None)
        worst = dict(err_o=0.0, share_o=0.0, err_p=0.0, share_p=0.0, control_beyond=0)
        for name, g, a, p, c in zip(limits, got, again, plain, control):
            exact, lim, lim_p = limits[name]
            require(torch.equal(g, a), f"{kind} backward ({which}) {name}: two calls differ")
            bad_o, err_o, share_o = beyond(g, exact, lim)
            bad_p, err_p, share_p = beyond(g, p, lim_p)
            require(bad_o == 0, f"{kind} backward ({which}) {name} vs float64: {bad_o} "
                                f"entries beyond the limit, max abs err {err_o:.3g}")
            require(bad_p == 0, f"{kind} backward ({which}) {name} vs plain: {bad_p} "
                                f"entries beyond the limit, max abs err {err_p:.3g}")
            worst["control_beyond"] += beyond(c, exact, lim)[0]
            for key, val in (("err_o", err_o), ("share_o", share_o), ("err_p", err_p),
                             ("share_p", share_p)):
                worst[key] = max(worst[key], val)
        require(worst["control_beyond"] > 0, f"{kind} backward ({which}): the dropped-carry "
                                             "control passes the limit")
        checks[which] = worst
        del got, again, plain, limits, control, scratch
    torch.cuda.empty_cache()
    y, scratch = forward(args)
    dy = torch.randn(y.shape, generator=gen, device=dev)
    del y
    kernel = lambda: bwd(*args, *scratch, dy, None)  # noqa: E731
    plain = lambda: plain_bwd(*args, dy, None, chunk)  # noqa: E731
    device = kernel_device_ms(kernel, kernels, reps=3)
    require(device["device_launches_per_call"] == 3,
            f"{kind} backward under the profiler: {device}; want 3 launches a call")
    # the function's bytes: its inputs read once (dy float32), its gradients
    # written once; its operations at chunk q, per token and head (products
    # counted at 2 flops a multiply-add, as the forward's rows count them)
    elem = args[0].element_size()
    if kind == "ssm":
        x, dt, A, B, C = args
        bt, s, h, dh = x.shape
        n = B.shape[-1]
        n_bytes = (2 * (x.numel() + B.numel() + C.numel()) * elem + 2 * dt.numel() * 4
                   + 2 * A.numel() * 4 + dy.numel() * 4)
        # the reverse pass, Y, the carry-in and dx's state term (2 dh N
        # each); within the chunk, (q + 1) / 2 earlier or later steps of
        # dy . x, G^T dy and C . B (once for the h heads), dB's and dC's
        # shares (2 N each), and the scalars; expf: E's (q - 1) / 2 and
        # three more a step
        prod = lambda q: bt * s * h * (8 * dh * n + (q + 1) / 2 * (4 * dh + 4 * n + 2 * n / h))  # noqa: E731
        rest = lambda q: bt * s * h * (dh * n / q + 20)  # noqa: E731
        exps = lambda q: bt * s * h * ((q - 1) / 2 + 3)  # noqa: E731
        shapes = (f"x ({bt}, {s}, {h}, {dh}) {x.dtype} (a strided view), B, C ({bt}, {s}, "
                  f"{n}), dt f32, dy f32, chunk {chunk}; dx, dB, dC {x.dtype}, ddt, dA f32")
        replaces = ("src/repro/kernels/ssm_scan.py:57 (its gradient: the reference "
                    "differentiates src/repro/models/ssm.py:116 chunk_step with "
                    "jax.value_and_grad; it has no Pallas backward)")
        name = "ssm_scan_bwd[Zamba2-7B train]"
    else:
        r, k, v, logw, u = args
        b, h, s, dh = r.shape
        n_bytes = (2 * 3 * r.numel() * elem + 2 * logw.numel() * 4 + 2 * u.numel() * 4
                   + dy.numel() * 4)
        # the reverse pass, the carry-in, dv's and dk's state terms (2 dh^2
        # each); within the chunk, (q + 1) / 2 steps of dA, A, A^T dy and
        # the gated parts of dr and dk (2 dh each), and the scalars; expf:
        # the exact gate's (q - 1) / 2 dh three times, and 4 dh more a step
        prod = lambda q: b * h * s * (8 * dh * dh + (q + 1) / 2 * 10 * dh)  # noqa: E731
        rest = lambda q: b * h * s * (dh * dh / q + 12 * dh)  # noqa: E731
        exps = lambda q: b * h * s * (3 * (q - 1) / 2 * dh + 4 * dh)  # noqa: E731
        shapes = (f"r, k, v ({b}, {h}, {s}, {dh}) {r.dtype} (transposed views), logw f32, "
                  f"dy f32, chunk {chunk}; dr, dk, dv {r.dtype}, dlogw, du f32")
        replaces = ("src/repro/kernels/rwkv6_scan.py:70 (its gradient: the reference "
                    "differentiates src/repro/models/rwkv.py:88 _wkv_chunked with "
                    "jax.value_and_grad; it has no Pallas backward)")
        name = "rwkv6_scan_bwd[RWKV6-3B train]"
    bound = scan_bound(n_bytes, lambda q: (prod(q) + rest(q), exps(q)), q,
                       tf32_work=lambda q: (3 * prod(q), rest(q), exps(q)))
    row = dict(
        name=name, route="cuda",
        source=f"src/repro_torch/csrc/{kind}_scan_bwd.cu", replaces=replaces,
        launches=launches, launches_per_step=launches_per_step,
        max_abs_err=max(c["err_p"] for c in checks.values()),
        max_abs_err_vs_float64=max(c["err_o"] for c in checks.values()),
        ms=timed(kernel, 5), **device,
        device_ms_by_kernel={n_: kernel_device_ms(kernel, (n_,), reps=3)["device_ms"]
                             for n_ in kernels},
        plain_ms=timed(plain, 2), library_ms=None,
        library_call="none: no one PyTorch call computes the scan's gradient",
        kernel_resources=resources,
        shapes=shapes + f"; {what}, dy randn", **bound)
    return row, checks


def train_step_seconds(step, state, batch_of, first: int, steps: int) -> tuple:
    """``steps`` calls of ``step`` on the batches ``batch_of(i)`` from
    ``first``: the final state, each step's host seconds (to a
    synchronise) and losses."""
    import torch

    seconds, losses = [], []
    for i in range(first, first + steps):
        batch = batch_of(i)
        t = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
    return state, seconds, losses


def train_rwkv6_3b_phase(dev) -> dict:
    """RWKV6-3B training at full width and depth through
    ``launch/train.py``: 4 x 2,048 tokens a step, remat "full", AdamW in
    place, 3 steps with a checkpoint after the last, restored bitwise, and
    one resumed step. First the first step's gradients at full width on
    ``GRAD_CHECK_LAYERS`` layers through K6 and K6' against K6's plain
    pair, and the detached-scan control. Then the launcher's run with the
    counters set to 0 just before and read just after: exactly 2 x 32 K6
    and 32 K6' launches a step, nothing else. Returns K6''s row."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RWKVConfig
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain_pair
    from repro_torch.launch import train as train_launch
    from repro_torch.models import count_params
    from repro_torch.models import rwkv as rwkv_module

    t_phase = time.perf_counter()
    spec = RWKV_TRAIN
    cfg = get_config(spec["arch"])
    widths = dict(n_layers=RWKV_LAYERS, d_model=2560, n_heads=40, d_ff=8960,
                  vocab_size=65536, rwkv=RWKVConfig(64, 64, 64), remat=True,
                  remat_policy="full")
    got = {n: getattr(cfg, n) for n in widths}
    require(got == widths, f"{spec['arch']} widths {got}, want {widths}")
    require(count_params(cfg) == RWKV_TRAIN_PARAMS,
            f"{spec['arch']}: {count_params(cfg)} params, want {RWKV_TRAIN_PARAMS}")
    b, seq, steps = spec["global_batch"], spec["seq"], spec["steps"]
    pipe = DataPipeline(SyntheticCorpus(vocab_size=cfg.vocab_size, mean_len=seq // 2), b, seq)
    batch = {"tokens": torch.from_numpy(pipe.assemble(0)).to(dev)}
    layers = GRAD_CHECK_LAYERS[spec["arch"]]
    grad, calls = first_step_grad_check(
        dev, dataclasses.replace(cfg, n_layers=layers), batch,
        (rwkv_module, "rwkv6_scan_state", rwkv6_scan_plain_pair), truth=rwkv6_float64_pair)
    require(grad["launches"] == {"rwkv6_scan": 2 * layers, "rwkv6_scan_bwd": layers},
            f"one gradient of {layers} RWKV6 layers launched {grad['launches']}")
    grad["float64_witness"]["forward_calls"] = rwkv6_forward_witness(calls[:layers])
    call = calls[-1]
    del calls
    del batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tmp = Path(tempfile.mkdtemp(prefix="train_ckpt_"))
    try:
        def argv(n_steps: int) -> list[str]:
            return ["--arch", spec["arch"], "--seq", str(seq), "--global-batch", str(b),
                    "--steps", str(n_steps), "--ckpt-dir", str(tmp),
                    "--checkpoint-every", str(steps), "--device", "cuda"]

        for k_ in _build.KERNELS:
            k_.launches.clear()
        run = train_launch.main(argv(steps))
        torch.cuda.synchronize()
        launches = launch_counts(_build.KERNELS)
        require(launches == {"rwkv6_scan": 2 * RWKV_LAYERS * steps,
                             "rwkv6_scan_bwd": RWKV_LAYERS * steps},
                f"train {spec['arch']}: launches {launches} in {steps} steps")
        rep = run.report
        require(rep.steps_run == steps and rep.retries == 0 and rep.resumed_from is None,
                f"train report {rep}")
        losses = [m["loss"] for m in run.metrics]
        require(len(losses) == steps and all(math.isfinite(x) for x in losses),
                f"train losses {losses}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        require(ckpt.latest_step(tmp) == steps - 1, f"checkpoint steps in {list(tmp.iterdir())}")
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / f"step_{steps - 1:08d}").iterdir())
        gc.collect()
        torch.cuda.empty_cache()  # the final state and its restored copy: 73.8 GB
        t = time.perf_counter()
        tree, _, step = ckpt.restore(tmp, device=dev)
        restore_s = time.perf_counter() - t
        saved, final = tree_paths(tree), tree_paths(run.state.__dict__)
        require(step == steps - 1 and set(saved) == set(final)
                and all(torch.equal(saved[p], final[p]) for p in final),
                "the restored checkpoint differs from the final state")
        del tree, saved, final
        torch.cuda.empty_cache()
        busy = train_step_busy(run.model, run.state, dict(tokens=torch.from_numpy(
            run.pipeline.assemble(steps)).to(dev)), in_place=True)
        run_tps, step_times = run.tokens_per_second, rep.step_times
        del run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k_ in _build.KERNELS:
            k_.launches.clear()
        resumed = train_launch.main(argv(1))
        require(resumed.report.resumed_from == steps - 1 and resumed.report.steps_run == 1
                and launch_counts(_build.KERNELS) == {"rwkv6_scan": 2 * RWKV_LAYERS,
                                                      "rwkv6_scan_bwd": RWKV_LAYERS},
                f"resumed run: {resumed.report}, launches {launch_counts(_build.KERNELS)}")
        require(math.isfinite(resumed.metrics[0]["loss"]), "resumed loss not finite")
        resumed_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    (r, k, v, logw, u, chunk), _ = call
    require(r.shape == (b, 40, seq, 64) and r.dtype == torch.bfloat16 and chunk == 64,
            f"the train call of K6: r {tuple(r.shape)} {r.dtype}, chunk {chunk}")
    row, checks = scan_bwd_row(dev, "rwkv6", (r, k, v, logw, u), chunk,
                               launches["rwkv6_scan_bwd"], RWKV_LAYERS,
                               f"layer 0's r, k, v, logw, u in the {layers}-layer first-step "
                               "gradient (the last call: the backward's remat recompute)")
    step_s = statistics.median(step_times)
    emit("train_rwkv6_3b", arch=spec["arch"], params=RWKV_TRAIN_PARAMS, batch=b, seq=seq,
         steps=steps, launches=launches, losses=losses, step_seconds=step_times,
         step_seconds_median=step_s, tokens_per_second=b * seq / step_s,
         run_tokens_per_second=run_tps, peak_memory_gb=peak_gb,
         resumed_peak_memory_gb=resumed_peak_gb, step_busy=busy,
         checkpoint_bytes=ckpt_bytes, restore_seconds=restore_s, resumed_from=steps - 1,
         grad_check=grad,
         grad_tol=f"max(1, 2 rho_P) x {TRAIN_GRAD_TOL} of each leaf's largest |gradient| "
                  "through the plain pairs and through the float64 step, rho_P the plain "
                  "pairs' worst share of the leaf's kind vs the step with the scan in float64 "
                  f"(RWKV_TRAIN), {layers} layers at full width; a leaf 0 in both (w_lora_a "
                  "behind a zero w_lora_b) must be 0",
         k6_bwd_tol="u |g| + eps32 sqrt(6 Q + k') (1 + c) sum|terms| vs float64; twice it vs "
                    "plain; the backward with the carried state dropped must pass it",
         k6_bwd_checks=checks, seconds=time.perf_counter() - t_phase)
    return row


def train_zamba2_7b_phase(dev) -> dict:
    """Zamba2-7B training at full width, its depth cut to 18 layers (see
    ZAMBA_TRAIN), through ``build_train_step`` on
    ``dataclasses.replace(cfg, n_layers=18)``: 4 x 2,048 tokens a step from
    the DaphneSched data pipeline, remat "full", AdamW in place, 3 steps.
    First the first step's gradients at full width on one super-block (6
    layers) through K5, K5', K4 and K4' against their plain pairs, and the
    detached-scan control. Then the steps with the counters set to 0 just
    before and read just after: exactly 2 x 18 K5, 18 K5', 2 x 3 K4 and 3
    K4' launches a step. Returns K5''s row."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SSMConfig
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan import ssm_scan_plain_pair
    from repro_torch.models import Model, count_params
    from repro_torch.models import ssm as ssm_module
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import build_train_step, init_train_state

    t_phase = time.perf_counter()
    spec = ZAMBA_TRAIN
    full = get_config(spec["arch"])
    widths = dict(n_layers=ZAMBA_MAMBA_LAYERS, d_model=3584, n_heads=32, n_kv_heads=32,
                  head_dim=112, d_ff=14336, vocab_size=32000, remat=True, remat_policy="full",
                  ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=64, conv_width=4,
                                attn_every=6))
    got = {n: getattr(full, n) for n in widths}
    require(got == widths, f"{spec['arch']} widths {got}, want {widths}")
    cfg = dataclasses.replace(full, n_layers=spec["n_layers"])
    require(count_params(full) == ZAMBA_PARAMS and count_params(cfg) == ZAMBA_TRAIN_PARAMS,
            f"{spec['arch']}: {count_params(full)} params, {count_params(cfg)} at "
            f"{spec['n_layers']} layers")
    b, seq, steps = spec["global_batch"], spec["seq"], spec["steps"]
    n_sb = spec["n_layers"] // full.ssm.attn_every
    pipe = DataPipeline(SyntheticCorpus(vocab_size=cfg.vocab_size, mean_len=seq // 2), b, seq)
    batch = {"tokens": torch.from_numpy(pipe.assemble(0)).to(dev)}
    layers = GRAD_CHECK_LAYERS[spec["arch"]]
    grad, calls = first_step_grad_check(
        dev, dataclasses.replace(full, n_layers=layers), batch,
        (ssm_module, "ssm_scan_state", ssm_scan_plain_pair), (k4_checked(),))
    call = calls[-1]
    del calls
    require(grad["launches"] == {"ssm_scan": 2 * layers, "ssm_scan_bwd": layers,
                                 "flash_attention": 2, "flash_attention_bwd": 1},
            f"one gradient of {layers} Zamba2 layers launched {grad['launches']}")
    del batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    opt = AdamWConfig()
    state = init_train_state(model, gen, opt)
    step = build_train_step(model, opt, in_place=True)
    want = {"ssm_scan": 2 * spec["n_layers"], "ssm_scan_bwd": spec["n_layers"],
            "flash_attention": 2 * n_sb, "flash_attention_bwd": n_sb}
    for k_ in _build.KERNELS:
        k_.launches.clear()
    state, step_times, losses = train_step_seconds(
        step, state, lambda i: {"tokens": torch.from_numpy(pipe.assemble(i)).to(dev)}, 0, steps)
    launches = launch_counts(_build.KERNELS)
    require(launches == {e: n * steps for e, n in want.items()},
            f"train {spec['arch']} at {spec['n_layers']} layers: launches {launches} in "
            f"{steps} steps, want {want} a step")
    require(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    require(all(bool(torch.isfinite(t_).all()) for t_ in tree_paths(state.params).values()),
            "the trained params are not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy = train_step_busy(model, state, {"tokens": torch.from_numpy(pipe.assemble(steps))
                                          .to(dev)}, in_place=True)
    del state, model, step
    gc.collect()
    torch.cuda.empty_cache()
    (x, dt, A, B, C, chunk), _ = call
    require(x.shape == (b, seq, 112, 64) and x.dtype == torch.bfloat16 and chunk == 64
            and not x.is_contiguous(),
            f"the train call of K5: x {tuple(x.shape)} {x.dtype}, chunk {chunk}")
    row, checks = scan_bwd_row(dev, "ssm", (x, dt, A, B, C), chunk,
                               launches["ssm_scan_bwd"], spec["n_layers"],
                               f"layer 0's x, dt, A, B, C in the {layers}-layer first-step "
                               "gradient (the last call: the backward's remat recompute)")
    step_s = statistics.median(step_times)
    emit("train_zamba2_7b", arch=spec["arch"], n_layers=spec["n_layers"],
         depth_cut=f"{ZAMBA_MAMBA_LAYERS} -> {spec['n_layers']} layers ({n_sb} super-blocks "
                   f"of {full.ssm.attn_every}, no tail): {ZAMBA_PARAMS} params take "
                   f"{16 * ZAMBA_PARAMS / 1e9:.1f} GB at 16 bytes a parameter",
         params=ZAMBA_TRAIN_PARAMS, batch=b, seq=seq, steps=steps, launches=launches,
         launches_per_step=want, losses=losses, step_seconds=step_times,
         step_seconds_median=step_s, tokens_per_second=b * seq / step_s,
         peak_memory_gb=peak_gb, step_busy=busy, grad_check=grad,
         grad_tol=f"{TRAIN_GRAD_TOL} of each leaf's largest |gradient| through K5's and K4's "
                  f"plain pairs, {layers} layers (one super-block) at full width",
         k5_bwd_tol="u |g| + eps32 sqrt(6 Q + k') (1 + c) sum|terms| vs float64; twice it vs "
                    "plain; the backward with the carried state dropped must pass it",
         k5_bwd_checks=checks, seconds=time.perf_counter() - t_phase)
    return row


def attention_calls(cfg) -> int:
    """K4 calls in one forward of ``cfg``'s trunk at a prompt over 1,024
    tokens: one a layer; Whisper's encoder layers and each decoder layer's
    cross attention besides."""
    if cfg.encdec is None:
        return cfg.n_layers
    return 2 * cfg.n_layers + cfg.encdec.n_enc_layers


@contextlib.contextmanager
def k4_launches_by_shape():
    """Count K4's and K4''s launches by the call's ``(q shape, k shape, dv,
    causal)``: each call of the models' ``flash_attention`` and of the
    backward wrapper ``flash_attention_bwd`` adds what its kernel's launch
    count grew by. Yields the two Counters, forward's and backward's."""
    import inspect
    from collections import Counter
    from unittest import mock

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attention_module

    fwd, bwd = Counter(), Counter()

    def spy(counts, fn, kernel, entry):
        sig = inspect.signature(fn)

        def call(*a, **kw):
            args = sig.bind(*a, **kw)
            args.apply_defaults()
            q, k, v, causal = (args.arguments[n] for n in ("q", "k", "v", "causal"))
            before = kernel.launches[entry]
            out = fn(*a, **kw)
            counts[(tuple(q.shape), tuple(k.shape), v.shape[-1], bool(causal))] += \
                kernel.launches[entry] - before
            return out
        return call

    with mock.patch.object(attention_module, "flash_attention",
                           spy(fwd, attention_module.flash_attention, _build.FLASH_ATTENTION,
                               "flash_attention")), \
            mock.patch.object(fa, "flash_attention_bwd",
                              spy(bwd, fa.flash_attention_bwd, _build.FLASH_ATTENTION_BWD,
                                  "flash_attention_bwd")):
        yield fwd, bwd


def frontier_train_phase(dev, spec: dict) -> list[dict]:
    """One of the four families of FRONTIER_TRAIN trained at full width on
    the card: the config's widths and the parameter count at the phase's
    depth required; the first step's gradients at FRONTIER_GRAD_LAYERS
    layers against K4's plain pair (``first_step_grad_check``); then 3
    steps through ``build_train_step`` (in place) with the counters set to
    0 just before and read just after: exactly 2 K4 and 1 K4' launch a
    K4 call of a forward (``attention_calls``), and so for each shape
    (``k4_launches_by_shape``), no K4 call padded, finite
    losses and params, and the peak memory; then a step under the
    profiler; then each K4' shape of ``spec["rows"]`` on the first step's
    own call against its float64 oracle and plain version, with its times
    and the K4' launches the steps made at its shape (``k4_bwd_row``). ``spec``: ``phase``, ``arch``, ``widths``,
    ``n_layers`` (the depth on the card), ``params`` (at that depth),
    ``short`` (the gradient check's config from the full one) and
    ``rows``: ``(name, q shape, k shape, dv, causal, launches a step)``.
    Returns the rows."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline, SyntheticCorpus
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model, count_params
    from repro_torch.models.model import FRONTEND_DIM
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import build_train_step, init_train_state

    t_phase = time.perf_counter()
    full = get_config(spec["arch"])
    got = {n: getattr(full, n) for n in spec["widths"]}
    require(got == spec["widths"], f"{spec['arch']} widths {got}, want {spec['widths']}")
    require(full.remat and full.remat_policy == "full",
            f"{spec['arch']}: remat {full.remat} {full.remat_policy}, want full")
    cfg = dataclasses.replace(full, n_layers=spec["n_layers"])
    require(count_params(cfg) == spec["params"],
            f"{spec['arch']}: {count_params(cfg)} params at {spec['n_layers']} layers, want "
            f"{spec['params']}")
    b, seq, steps = (FRONTIER_TRAIN[k] for k in ("global_batch", "seq", "steps"))
    pipe = DataPipeline(SyntheticCorpus(vocab_size=cfg.vocab_size, mean_len=seq // 2), b, seq)
    gen = torch.Generator(device=dev)

    def batch_of(i: int) -> dict:
        """Step i's tokens (b, seq + 1), and the frontend's fp32 inputs at
        the reference's launch/specs.py shapes from a seeded generator."""
        batch = {"tokens": torch.from_numpy(pipe.assemble(i)).to(dev)}
        gen.manual_seed(1000 + i)
        if cfg.frontend == "audio":
            batch["frames"] = torch.randn((b, cfg.encdec.n_enc_positions, FRONTEND_DIM["audio"]),
                                          generator=gen, device=dev)
        elif cfg.frontend == "vision":
            batch["patch_embeds"] = torch.randn(
                (b, cfg.n_frontend_tokens, FRONTEND_DIM["vision"]), generator=gen, device=dev)
        return batch

    pads = dict(fa.PAD_COPIES)
    short = spec["short"](full)
    grad, calls = first_step_grad_check(dev, short, batch_of(0), k4_checked())
    n_short = attention_calls(short)
    require(grad["launches"] == {"flash_attention": 2 * n_short,
                                 "flash_attention_bwd": n_short},
            f"one gradient of {short.n_layers} {spec['arch']} layers launched "
            f"{grad['launches']}")
    picked = []
    for name, q_shape, k_shape, dv, causal, per_step in spec["rows"]:
        match = [c for c in calls if tuple(c[0][0].shape) == q_shape
                 and tuple(c[0][1].shape) == k_shape and c[0][2].shape[-1] == dv
                 and c[1]["causal"] == causal and c[0][0].dtype == torch.bfloat16]
        require(bool(match), f"{name}: no K4 call of the first step has q {q_shape}, k "
                             f"{k_shape}, dv {dv}, causal {causal}")
        picked.append((name, causal, per_step, match[-1][0]))
    del calls
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    gen0 = torch.Generator(device=dev)
    gen0.manual_seed(0)
    opt = AdamWConfig()
    state = init_train_state(model, gen0, opt)
    step = build_train_step(model, opt, in_place=True)
    n_calls = attention_calls(cfg)
    want = {"flash_attention": 2 * n_calls, "flash_attention_bwd": n_calls}
    for k_ in _build.KERNELS:
        k_.launches.clear()
    with k4_launches_by_shape() as (fwd, bwd):
        state, step_times, losses = train_step_seconds(step, state, batch_of, 0, steps)
    launches = launch_counts(_build.KERNELS)
    require(launches == {e: n * steps for e, n in want.items()},
            f"train {spec['arch']} at {spec['n_layers']} layers: launches {launches} in "
            f"{steps} steps, want {want} a step")
    by_shape = sorted([list(key), fwd[key], bwd[key]] for key in set(fwd) | set(bwd))
    require(sum(fwd.values()) == launches["flash_attention"]
            and sum(bwd.values()) == launches["flash_attention_bwd"]
            and all(f_ == 2 * b_ for _, f_, b_ in by_shape),
            f"train {spec['arch']}: K4 / K4' launches by shape {by_shape}, want two K4 a "
            f"K4' in each, {launches} in all")
    require(all(math.isfinite(x) for x in losses), f"train {spec['arch']} losses {losses}")
    require(all(bool(torch.isfinite(t_).all()) for t_ in tree_paths(state.params).values()),
            f"the trained {spec['arch']} params are not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(peak_gb < 80, f"train {spec['arch']}: peak {peak_gb:.2f} GB")
    busy = train_step_busy(model, state, batch_of(steps), in_place=True)
    del state, model, step
    gc.collect()
    torch.cuda.empty_cache()
    require(dict(fa.PAD_COPIES) == pads,
            f"train {spec['arch']}: K4 padded a full-width call ({dict(fa.PAD_COPIES)})")

    rows, k4_bwd = [], {}
    for name, causal, per_step, (q, k, v) in picked:
        n_bwd = bwd[(tuple(q.shape), tuple(k.shape), v.shape[-1], causal)]
        require(n_bwd == per_step * steps, f"{name}: {n_bwd} K4' launches in {steps} steps, "
                                           f"want {per_step} a step")
        do = torch.randn((*q.shape[:3], v.shape[-1]), device=dev).bfloat16()
        row, checks = k4_bwd_row(dev, (q, k, v), do, n_bwd, n_bwd // steps, name=name,
                                 causal=causal,
                                 what=f"a layer's q, k, v of the {short.n_layers}-layer "
                                      "first-step gradient")
        rows.append(row)
        k4_bwd[name] = {w_: dict(vs_float64=[c["err_o"], c["share_o"]],
                                 vs_plain=[c["err_p"], c["share_p"]],
                                 no_d_control_entries_beyond=c["no_d_control_entries_beyond"])
                        for w_, c in checks.items()}
        del q, k, v, do
    step_s = statistics.median(step_times)
    depth = (f"{full.n_layers} -> {spec['n_layers']} layers: all {full.n_layers} take "
             f"{16 * count_params(full) / 1e9:.1f} GB at 16 bytes a parameter"
             if spec["n_layers"] != full.n_layers else "none: whole")
    emit(spec["phase"], arch=spec["arch"], n_layers=spec["n_layers"], depth_cut=depth,
         params=spec["params"], batch=b, seq=seq, steps=steps,
         batch_keys=sorted(batch_of(0)), launches=launches, launches_per_step=want,
         k4_launches_by_shape=by_shape,
         losses=losses, step_seconds=step_times, step_seconds_median=step_s,
         tokens_per_second=b * seq / step_s, peak_memory_gb=peak_gb, step_busy=busy,
         grad_check=grad, pad_copies=dict(fa.PAD_COPIES),
         grad_tol=f"{TRAIN_GRAD_TOL} of each leaf's largest |gradient| (a k bias: its wk's) "
                  f"through K4's plain pair, {short.n_layers} layers at full width",
         k4_bwd_tol="u (|g| + D's rounding carried) + (2^-14 + u) sum|terms| vs float64; "
                    "2u|g| + (2^-13 + u) sum|terms| vs plain (u = 2^-8); the backward "
                    "without the D term must fail the float64 limit",
         k4_bwd=k4_bwd, seconds=time.perf_counter() - t_phase)
    return rows


def train_qwen2_moe_a2_7b_phase(dev) -> list[dict]:
    """Qwen1.5-MoE-A2.7B trained at full width, 4 of its 24 layers
    (FRONTIER_TRAIN): K4 and K4' at (128, 128), 16 heads, group 1."""
    from repro_torch.configs.base import MoEConfig

    b, s = FRONTIER_TRAIN["global_batch"], FRONTIER_TRAIN["seq"]
    return frontier_train_phase(dev, dict(
        phase="train_qwen2_moe_a2_7b", arch="qwen2-moe-a2.7b", n_layers=4,
        params=2_905_090_048,
        widths=dict(n_layers=QWEN_MOE_LAYERS, d_model=2048, n_heads=16, n_kv_heads=16,
                    head_dim=128, d_ff=5632, vocab_size=151936, qkv_bias=True,
                    moe=MoEConfig(n_routed=60, n_shared=4, top_k=4, d_ff_expert=1408)),
        short=lambda c: dataclasses.replace(c, n_layers=FRONTIER_GRAD_LAYERS),
        rows=[("flash_attention_bwd[dh 128, MHA, Qwen1.5-MoE train]", (b, 16, s, 128),
               (b, 16, s, 128), 128, True, 4)]))


def train_deepseek_v2_lite_16b_phase(dev) -> list[dict]:
    """DeepSeek-V2-Lite trained at full width, 4 of its 27 layers (the
    dense layer 0 and 3 MoE layers, FRONTIER_TRAIN): K4 and K4' at MLA's
    (192, 128), v the view ``kv[..., 128:]``."""
    from repro_torch.configs.base import MLAConfig, MoEConfig

    b, s = FRONTIER_TRAIN["global_batch"], FRONTIER_TRAIN["seq"]
    return frontier_train_phase(dev, dict(
        phase="train_deepseek_v2_lite_16b", arch="deepseek-v2-lite-16b", n_layers=4,
        params=2_254_983_168,
        widths=dict(n_layers=DEEPSEEK_LAYERS, d_model=2048, n_heads=16, n_kv_heads=16,
                    d_ff=10944, vocab_size=102400, first_layer_dense=True,
                    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                                  nope_head_dim=128, v_head_dim=128),
                    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408)),
        short=lambda c: dataclasses.replace(c, n_layers=FRONTIER_GRAD_LAYERS),
        rows=[("flash_attention_bwd[dh 192, dv 128, MLA, DeepSeek-V2-Lite train]",
               (b, 16, s, 192), (b, 16, s, 192), 128, True, 4)]))


def train_whisper_small_phase(dev) -> list[dict]:
    """Whisper-small trained whole (FRONTIER_TRAIN), frames from the
    caller: K4 and K4' non-causal over the encoder's 1,500 frames, causal
    on the decoder's 2,048 tokens, and non-causal on the cross attention's
    2,048 queries against 1,500 keys."""
    from repro_torch.configs.base import EncDecConfig

    b, s = FRONTIER_TRAIN["global_batch"], FRONTIER_TRAIN["seq"]
    n_l, n_enc = WHISPER_LAYERS, 1500
    return frontier_train_phase(dev, dict(
        phase="train_whisper_small", arch="whisper-small", n_layers=n_l,
        params=WHISPER_PARAMS,
        widths=dict(n_layers=n_l, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
                    d_ff=3072, vocab_size=51865, frontend="audio",
                    encdec=EncDecConfig(n_enc_layers=n_l, n_enc_positions=n_enc)),
        short=lambda c: dataclasses.replace(
            c, n_layers=FRONTIER_GRAD_LAYERS,
            encdec=dataclasses.replace(c.encdec, n_enc_layers=FRONTIER_GRAD_LAYERS)),
        rows=[("flash_attention_bwd[dh 64, encoder 1,500 x 1,500, non-causal, "
               "Whisper-small train]", (b, 12, n_enc, 64), (b, 12, n_enc, 64), 64, False, n_l),
              ("flash_attention_bwd[dh 64, cross 2,048 x 1,500, Whisper-small train]",
               (b, 12, s, 64), (b, 12, n_enc, 64), 64, False, n_l)]))


def train_internvl2_26b_phase(dev) -> list[dict]:
    """InternVL2-26B trained at full width, 4 of its 48 layers
    (FRONTIER_TRAIN), patch embeddings from the caller: K4 and K4' at
    (128, 128), 48 heads over 8 kv heads (group 6)."""
    b, s = FRONTIER_TRAIN["global_batch"], FRONTIER_TRAIN["seq"]
    return frontier_train_phase(dev, dict(
        phase="train_internvl2_26b", arch="internvl2-26b", n_layers=4, params=2_705_387_520,
        widths=dict(n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
                    d_ff=16384, vocab_size=92553, frontend="vision", n_frontend_tokens=256),
        short=lambda c: dataclasses.replace(c, n_layers=FRONTIER_GRAD_LAYERS),
        rows=[("flash_attention_bwd[dh 128, group 6, InternVL2-26B train]", (b, 48, s, 128),
               (b, 8, s, 128), 128, True, 4)]))


def leaf_kind(path: str) -> str:
    """A gradient leaf's name with its layer indices dropped."""
    return "/".join(k for k in path.split("/") if not k.isdigit())


def share_summary(shares: dict) -> dict:
    """The worst share of the limit per leaf kind (``leaf_kind``)."""
    out: dict = {}
    for p, v in shares.items():
        name = leaf_kind(p)
        out[name] = max(out.get(name, 0.0), v)
    return out


def train_step_busy(model, state, batch: dict, in_place: bool = False) -> dict:
    """One more train step of ``model`` from ``state`` on ``batch`` under
    ``torch.profiler`` (``in_place``: written over ``state``): the sum of
    its kernels' device time over the step's host seconds (the profiler's
    own overhead makes the share a lower bound; the sum holds the
    ``PROFILE_FILLER`` launches that open the session, a few ms), and the
    kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import build_train_step

    step = build_train_step(model, AdamWConfig(), in_place=in_place)
    filler = torch.zeros(1, device=batch["tokens"].device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_FILLER):
            filler.add_(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    del state
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in rows) / 1e6
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_seconds=wall, device_seconds=device_s, busy_share=device_s / wall,
                top=[[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top])


def jsonable(value):
    """``value`` without its arrays and tensors (an example's returned
    tokens, labels, values): what a JSON line can hold."""
    import numpy as np
    import torch

    if isinstance(value, dict):
        kept = {str(k): jsonable(v) for k, v in value.items()}
        return {k: v for k, v in kept.items() if v is not None}
    if isinstance(value, (list, tuple)):
        return [jsonable(v) for v in value]
    if isinstance(value, (np.ndarray, torch.Tensor)) or not isinstance(
            value, (str, int, float, bool, np.integer, np.floating)):
        return None
    return value.item() if isinstance(value, (np.integer, np.floating)) else value


def examples_phase(dev) -> list[dict]:
    """The eight examples of ``repro_torch.examples`` on the card, each
    through its module's ``run`` with the counters set to 0 just before and
    read just after (``EXAMPLES``): one JSON line each with its seconds,
    launches and checks (the example's own: bitwise where both sides run
    the same operations, else the worst share of the limits of
    ``kernels/limits.py``; each raises past them), the lines it printed
    kept out of the smoke's output. train_lm adds its losses (the last
    below the first), step and pool-wait seconds and tokens/s; its K4 and
    K4' calls give the kernels line's rows at its shape (q, k, v of a layer
    of its last step). Returns those two rows."""
    import importlib
    import io
    import shutil
    import tempfile
    from unittest import mock

    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import attention as attention_module

    t_phase = time.perf_counter()
    kept, fn = {}, attention_module.flash_attention

    def keep(*a, **kw):
        kept["call"] = (tuple(x.detach() for x in a), kw)
        return fn(*a, **kw)

    seconds, launches_of = {}, {}
    for name, kw, want in EXAMPLES:
        module = importlib.import_module(f"repro_torch.examples.{name}")
        tmp = tempfile.mkdtemp(prefix=f"{name}_") if name == "train_lm" else None
        extra = {"ckpt_dir": tmp} if tmp else {}
        patch = (mock.patch.object(attention_module, "flash_attention", keep) if tmp
                 else contextlib.nullcontext())
        printed = io.StringIO()
        for k_ in _build.KERNELS:
            k_.launches.clear()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed), patch:
                out = module.run(torch_device="cuda", **kw, **extra)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported, then the smoke fails
            fail(f"example {name}: {e!r}; it printed:\n{printed.getvalue()}")
        finally:
            if tmp:
                shutil.rmtree(tmp, ignore_errors=True)
        seconds[name] = time.perf_counter() - t
        launches = launch_counts(_build.KERNELS)
        if want is None:
            require(set(launches) == {"walk_linreg"} and launches["walk_linreg"] > 0,
                    f"example {name}: launches {launches}, want walk_linreg")
        else:
            require(launches == want, f"example {name}: launches {launches}, want {want}")
        line = dict(name=name, seconds=seconds[name], launches=launches, arguments=kw,
                    results=jsonable(out))
        if name == "train_lm":
            losses = out["losses"]
            require(out["steps_run"] == kw["steps"] and len(losses) == kw["steps"]
                    and all(math.isfinite(x) for x in losses)
                    and out["last_loss"] < out["first_loss"],
                    f"train_lm: {out['steps_run']} steps, losses {losses}")
            line.update(step_tokens_per_second=kw["batch"] * kw["seq"] / out["step_seconds"],
                        launches_per_step={k: n // kw["steps"] for k, n in launches.items()})
        if name == "preemptive_serving":
            ck = out["checkpoint"]["moments"]
            require(out["launches"]["host_to_device"] == {"walk_linreg": 1}
                    and 0 < ck["executed"] and ck["pending"] > 0,
                    f"preemptive_serving: the migration {out['launches']}, checkpoint {ck}: "
                    "want one seeded walk (K3) of a partly summed moments")
        emit("example", **line)
        launches_of[name] = launches
        del out
        gc.collect()
        torch.cuda.empty_cache()

    # K4 and K4' at train_lm's shape, on a layer's own q, k, v
    (q, k, v), kw = kept.pop("call")
    tr, train_launches = EXAMPLE_TRAIN, launches_of["train_lm"]
    mb = tr["batch"] // tr["microbatches"]
    dh = tr["d_model"] // tr["heads"]
    require(dh == 96 and q.shape == (mb, tr["heads"], tr["seq"], dh)
            and k.shape == v.shape == (mb, tr["heads"] // 4, tr["seq"], dh)
            and q.dtype == torch.bfloat16 and kw["causal"],
            f"train_lm's K4 call: q {tuple(q.shape)} {q.dtype}, {kw}")
    fwd_row, fwd_checks = k4_served_row(
        dev, "flash_attention[dh 96, group 4, train_lm example]", (q, k, v), kw,
        train_launches["flash_attention"], "a layer's q, k, v of the last train step")
    fwd_row["launches_per_step"] = EXAMPLE_TRAIN_K4
    do = torch.randn(q.shape, device=dev).bfloat16()
    bwd_row, bwd_checks = k4_bwd_row(
        dev, (q, k, v), do, train_launches["flash_attention_bwd"], EXAMPLE_TRAIN_K4 // 2,
        name="flash_attention_bwd[dh 96, group 4, train_lm example]",
        what="a layer's q, k, v of the last train step")
    emit("examples", seconds=seconds,
         k4_vs_float64={w_: [c["err_o"], c["share_o"]] for w_, c in fwd_checks.items()},
         k4_bwd_vs_float64={w_: [c["err_o"], c["share_o"]] for w_, c in bwd_checks.items()},
         k4_bwd_vs_plain={w_: [c["err_p"], c["share_p"]] for w_, c in bwd_checks.items()},
         total_seconds=time.perf_counter() - t_phase)
    return [fwd_row, bwd_row]


def main() -> None:
    """Run every phase; exit non-zero on the first failed check."""
    t_all = time.perf_counter()
    import numpy as np
    import torch

    require(torch.cuda.is_available(), "no CUDA device; this script runs on a GPU only")
    require((ROOT / "src" / "repro_torch" / "csrc").is_dir(),
            "src/repro_torch not found beside chip_smoke.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")

    from repro_torch.core import PreemptiveRunner, SchedulerConfig
    from repro_torch.core.device_schedule import build_dag_tables_cached
    from repro_torch.core.preempt import device_remainder
    from repro_torch.kernels import _build
    from repro_torch.kernels.cc_propagate import cc_propagate, cc_propagate_plain
    from repro_torch.kernels.dag_walk import (dag_walk, dag_walk_plain,
                                              dag_walk_stagewise)
    from repro_torch.kernels.ops import cc_step, dls_tile_schedule
    from repro_torch.kernels.ref import cc_propagate_ref
    from repro_torch.core.partitioners import PARTITIONERS
    from repro_torch.vee import apps
    from repro_torch.vee.sparse import rmat_graph

    # -- 1. environment ----------------------------------------------------
    t = time.perf_counter()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    card = card_line()
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], nvcc=nvcc.splitlines()[-1],
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=card, seconds=time.perf_counter() - t)

    # -- 2. build ----------------------------------------------------------
    t = time.perf_counter()
    _build.build_all()
    emit("build", libraries=[k.library.name for k in _build.KERNELS],
         seconds=time.perf_counter() - t)

    # -- 3. each kernel against its plain version, main-path shapes ---------
    t = time.perf_counter()
    results = {}

    def walk_inputs(low):
        ddt = build_dag_tables_cached(low.dag, 1, None)
        rows = ddt.tables[0].copy()
        rows[:, 1:] *= low.tile
        return rows

    t_low = time.perf_counter()
    lin = apps.linreg_device_lowering(LINREG_ROWS, LINREG_COLS, tile=TILE, device=dev)
    torch.cuda.synchronize()
    lowering_s = {"linreg": time.perf_counter() - t_low}
    lin_rows = walk_inputs(lin)
    k_out, lin_stamps = dag_walk(lin.stages, lin.operands, lin.values, lin_rows, TILE,
                                 stamp=True)
    p_out = dag_walk_plain(lin.stages, lin.operands, lin.values, lin_rows, TILE)
    X, y = lin.values["X"], lin.values["y"]
    n, d = X.shape
    X1y = torch.cat([(X - X.mean(0)) / X.std(0, unbiased=False),
                     torch.ones(n, 1, device=dev), y], dim=1)   # [X1 | y]
    A1y = X1y.abs()
    abs_lin = {"moments": torch.stack([X.abs().sum(0), (X * X).sum(0)]),
               "syrk_gemv": (A1y.T @ A1y)[:d + 1]}
    del A1y
    # moments against the plain walk's; syrk_gemv against the plain stage
    # on the walk's own moments, and against the float64 oracle
    X64 = X.double()
    mom64 = torch.stack([X64.sum(0), (X64 * X64).sum(0)])
    del X64
    syrk64, _ = syrk_oracle(X, y, mom64)
    p_syrk = solo_walk(lin, lin_rows, "syrk_gemv", k_out, plain=True)[1]
    lin_checks = [close(k_out["moments"], p_out["moments"], abs_lin["moments"], n // TILE,
                        "linreg moments"),
                  close(k_out["syrk_gemv"], p_syrk, abs_lin["syrk_gemv"], n // TILE,
                        "linreg syrk_gemv vs the plain stage on its moments"),
                  close(k_out["syrk_gemv"], syrk64, abs_lin["syrk_gemv"], n // TILE,
                        "linreg syrk_gemv vs float64")]
    # the plain walk's own drift from the float64 oracle, reported
    lin_plain_vs_float64 = {
        "moments": excess(p_out["moments"], mom64, abs_lin["moments"], n // TILE),
        "syrk_gemv": excess(p_out["syrk_gemv"], syrk64, abs_lin["syrk_gemv"], n // TILE)}
    del syrk64, p_syrk
    err_lin = max(e for e, _ in lin_checks)
    expect = [[*row, i] for i, row in enumerate(lin_rows.tolist())]
    require(lin_stamps.tolist() == expect, "linreg stamps differ from the table")
    sw = dag_walk_stagewise(lin.stages, lin.operands, lin.values, lin_rows, TILE)
    for s in ("moments", "syrk_gemv"):
        require(torch.equal(sw[s], k_out[s]), f"linreg stagewise {s} != fused walk")
    results["linreg"] = dict(max_abs_err=err_lin, slots=len(lin_rows))
    torch.cuda.synchronize()

    t_low = time.perf_counter()
    rec = apps.recommendation_device_lowering(REC_USERS, REC_ITEMS, tile=TILE, device=dev)
    torch.cuda.synchronize()
    lowering_s["recommendation"] = time.perf_counter() - t_low
    rec_rows = walk_inputs(rec)
    k_rec, stamps = dag_walk(rec.stages, rec.operands, rec.values, rec_rows, TILE,
                             stamp=True)
    p_rec = dag_walk_plain(rec.stages, rec.operands, rec.values, rec_rows, TILE)
    R = rec.values["R"]
    U, I = R.shape
    rec_checks = [close(k_rec["item_norms"], p_rec["item_norms"], (R * R).sum(0),
                        U // TILE, "recommendation item_norms"),
                  close(k_rec["user_bias"], p_rec["user_bias"], R.abs().sum(1) / I,
                        I, "recommendation user_bias")]
    err_rec = max(e for e, _ in rec_checks)
    want = apps.scores_plain(rec.values["R"], k_rec["item_norms"], k_rec["user_bias"])
    require(torch.equal(k_rec["scores"], want),
            "recommendation scores differ bitwise from the plain scores body")
    expect = [[*row, i] for i, row in enumerate(rec_rows.tolist())]
    require(stamps.tolist() == expect, "recommendation stamps differ from the table")
    sw = dag_walk_stagewise(rec.stages, rec.operands, rec.values, rec_rows, TILE)
    for s in ("item_norms", "user_bias", "scores"):
        require(torch.equal(sw[s], k_rec[s]), f"recommendation stagewise {s} != fused walk")
    results["recommendation"] = dict(max_abs_err=err_rec, slots=len(rec_rows))

    graph = rmat_graph(scale=CC_SCALE, edge_factor=8)
    G_host = graph.to_dense()
    n_cc = G_host.shape[0]
    G = torch.from_numpy(G_host).to(dev)
    c = torch.arange(1, n_cc + 1, dtype=torch.float32, device=dev)
    Gs = G[:CC_SMALL_N, :CC_SMALL_N].contiguous()
    cs = c[:CC_SMALL_N].contiguous()
    want_small = cc_propagate_ref(Gs, cs)
    for tech in sorted(PARTITIONERS):
        sched = torch.from_numpy(dls_tile_schedule(tech, CC_SMALL_N, 256, 8)).to(dev)
        got = cc_propagate(Gs, cs, sched)
        require(torch.equal(got, cc_propagate_plain(Gs, cs, sched)),
                f"cc_propagate != plain under {tech} at n={CC_SMALL_N}")
        require(torch.equal(got, want_small), f"cc_propagate != ref under {tech}")
    sched = torch.from_numpy(dls_tile_schedule("MFSC", n_cc, 256, 8)).to(dev)
    got = cc_propagate(G, c, sched)
    plain_cc = cc_propagate_plain(G, c, sched)
    require(torch.equal(got, plain_cc), f"cc_propagate != plain at n={n_cc}")
    results["cc_propagate"] = dict(max_abs_err=max_err(got, plain_cc))
    torch.cuda.synchronize()
    emit("kernels_vs_plain", linreg_max_abs_err=err_lin, rec_max_abs_err=err_rec,
         sum_tol="eps32 * sqrt(adds) * sum|terms|",
         linreg_worst_share_of_limit=max(r for _, r in lin_checks),
         linreg_shares_of_limit={"moments_vs_plain": lin_checks[0][1],
                                 "syrk_vs_plain_stage": lin_checks[1][1],
                                 "syrk_vs_float64": lin_checks[2][1]},
         linreg_plain_walk_vs_float64={
             s_: dict(beyond=b_, max_abs_err=e_, worst_share=r_)
             for s_, (b_, e_, r_) in lin_plain_vs_float64.items()},
         rec_worst_share_of_limit=max(r for _, r in rec_checks),
         rec_shares_of_limit={"item_norms_vs_plain": rec_checks[0][1],
                              "user_bias_vs_plain": rec_checks[1][1]},
         cc_techniques=len(PARTITIONERS),
         lowering_seconds=lowering_s, seconds=time.perf_counter() - t)

    # -- 4. the main path through the entry points -------------------------
    for k in _build.KERNELS:
        k.launches.clear()
    t = time.perf_counter()
    beta, _, _ = apps.linear_regression_device(LINREG_ROWS, LINREG_COLS)
    t_lin = time.perf_counter() - t
    t = time.perf_counter()
    top, _, _ = apps.recommendation_device(REC_USERS, REC_ITEMS)
    top = top.cpu().numpy()
    t_rec = time.perf_counter() - t
    t = time.perf_counter()
    u = cc_step(G, c)
    torch.cuda.synchronize()
    t_cc = time.perf_counter() - t
    launches = launch_counts(_build.KERNELS)
    emit("main_path", launches=launches, linreg_seconds=t_lin,
         recommendation_seconds=t_rec, cc_seconds=t_cc)
    for entry in ("walk_linreg", "walk_recommendation", "cc_propagate"):
        require(launches.get(entry, 0) > 0, f"{entry} was not launched on the main path")

    t = time.perf_counter()
    beta_ref = apps.linear_regression_oracle(LINREG_ROWS, LINREG_COLS)
    beta_abs = abs(beta.astype("float64") - beta_ref)
    beta_err = float(beta_abs.max())
    # the features' betas are ~3e-4 (y is drawn apart from X); the intercept ~0.5
    feat_lim = BETA_RTOL * float(abs(beta_ref[:-1]).max())
    icpt_lim = BETA_RTOL * float(abs(beta_ref[-1]).max())
    require(float(beta_abs[:-1].max()) <= feat_lim,
            f"feature beta max abs err {float(beta_abs[:-1].max())} > {feat_lim}")
    require(float(beta_abs[-1].max()) <= icpt_lim,
            f"intercept abs err {float(beta_abs[-1].max())} > {icpt_lim}")
    rec_oracle = RecOracle(REC_USERS, REC_ITEMS, dev)
    agree, agree_exact = rec_oracle.agreement(top)
    require(agree >= REC_AGREEMENT, f"scores agree with the oracle on {agree:.6f}"
                                    f" < {REC_AGREEMENT} of users")
    # why the tie band: exact item norms (a float64 sum rounded once) still
    # leave users off the oracle's item, by the scores body's own roundings
    exact_off = round(REC_USERS * (1 - rec_oracle.agreement(apps.scores_plain(
        R, (R.double() ** 2).sum(0).float(), k_rec["user_bias"]))[1]))
    # and the control: a wrong sum must not agree
    agree_ctl, _ = rec_oracle.agreement(dropped_tile_scores(R, k_rec["item_norms"],
                                                            k_rec["user_bias"]))
    require(agree_ctl < REC_AGREEMENT, f"the dropped-tile control agrees on {agree_ctl:.6f}"
                                       f" >= {REC_AGREEMENT} of users")
    require(torch.equal(u, cc_propagate_ref(G, c)), "cc_step differs from the reference")
    require(bool(torch.isfinite(u).all()) and u.shape == (n_cc,), "cc_step output malformed")
    emit("end_to_end", beta_max_abs_err=beta_err,
         feature_beta_max_abs_err=float(beta_abs[:-1].max()), feature_beta_limit=feat_lim,
         intercept_abs_err=float(beta_abs[-1].max()), intercept_limit=icpt_lim,
         scores_agreement=agree, scores_min_agreement=REC_AGREEMENT,
         scores_same_item_as_oracle=agree_exact,
         users_off_the_oracles_item_with_exact_norms=exact_off,
         dropped_tile_control_agreement=agree_ctl,
         cc_n=n_cc, cc_exact=True, seconds=time.perf_counter() - t)

    # -- 5. times beside the bounds -----------------------------------------
    t = time.perf_counter()
    kernels = []

    lin_bytes = 4 * (n * d + n + 2 * d + (d + 1) * (d + 2)) + 12 * len(lin_rows)
    # moments 3nd, standardizing 2nd, one triangle of the symmetric syrk
    # (d+1)(d+2)/2 entries of 2n flop, the gemv (d+1) entries of 2n flop
    lin_flops = 5 * n * d + n * (d + 1) * (d + 2) + 2 * n * (d + 1)
    walk_lin = lambda: dag_walk(lin.stages, lin.operands, lin.values, lin_rows, TILE)  # noqa: E731
    kernels.append(dict(
        name="dag_walk[linreg]", route="cuda", source="src/repro_torch/csrc/dag_walk.cu",
        replaces="src/repro/kernels/dag_walk.py:218",
        launches=launches.get("walk_linreg", 0), max_abs_err=results["linreg"]["max_abs_err"],
        ms=timed(walk_lin, 5), **kernel_device_ms(walk_lin),
        plain_ms=timed(lambda: dag_walk_plain(lin.stages, lin.operands, lin.values,
                                              lin_rows, TILE), 2, warmup=0),
        library_ms=timed(lambda: X1y.T @ X1y, 10),
        library_call="X1y.T @ X1y (syrk_gemv only, X1y = [X1 | y] precomputed)",
        shapes=f"X ({n}, {d}) f32, {len(lin_rows)} slots, tile {TILE}",
        **dict(zip(("bound_ms", "bound_by"), bound_ms(lin_bytes, lin_flops)))))
    del X1y

    # item_norms 2UI, user_bias UI, scores: sqrt + add per item, then a
    # divide, subtract and compare per entry
    rec_flops = 2 * U * I + U * I + 2 * I + 3 * U * I
    walk_rec = lambda: dag_walk(rec.stages, rec.operands, rec.values, rec_rows, TILE)  # noqa: E731
    kernels.append(dict(
        name="dag_walk[recommendation]", route="cuda",
        source="src/repro_torch/csrc/dag_walk.cu",
        replaces="src/repro/kernels/dag_walk.py:218",
        launches=launches.get("walk_recommendation", 0),
        max_abs_err=results["recommendation"]["max_abs_err"],
        ms=timed(walk_rec, 10), **kernel_device_ms(walk_rec),
        plain_ms=timed(lambda: dag_walk_plain(rec.stages, rec.operands, rec.values,
                                              rec_rows, TILE), 3),
        library_ms=timed(lambda: R.square().sum(0), 10),
        library_call="R.square().sum(0) (item_norms only)",
        library_chain_ms=timed(lambda: rec_chain(R), 10), library_chain_call=REC_CHAIN_CALL,
        shapes=f"R ({U}, {I}) f32, {len(rec_rows)} slots, tile {TILE}",
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(rec_bytes(U, I) + 12 * len(rec_rows), rec_flops)))))

    cc_bytes = 4 * (n_cc * n_cc + 2 * n_cc) + 4 * (n_cc // 256)
    cc_flops = 2 * n_cc * n_cc
    kernels.append(dict(
        name="cc_propagate", route="cuda", source="src/repro_torch/csrc/cc_propagate.cu",
        replaces="src/repro/kernels/cc_propagate.py:56",
        launches=launches.get("cc_propagate", 0),
        max_abs_err=results["cc_propagate"]["max_abs_err"],
        ms=timed(lambda: cc_propagate(G, c, sched), 20),
        **kernel_device_ms(lambda: cc_propagate(G, c, sched), ("cc_propagate_kernel",)),
        plain_ms=timed(lambda: cc_propagate_plain(G, c, sched), 5),
        library_ms=timed(lambda: torch.maximum((G * c).amax(1), c), 10),
        library_call="torch.maximum((G * c).amax(1), c)",
        shapes=f"G ({n_cc}, {n_cc}) f32, tiles 256 x 1024",
        **dict(zip(("bound_ms", "bound_by"), bound_ms(cc_bytes, cc_flops)))))
    # where the walker's time goes: each stage alone
    stage_device_ms = {"linreg": walk_stages(lin, lin_rows, k_out),
                       "recommendation": walk_stages(rec, rec_rows, k_rec)}
    emit("walk_stages", device_ms=stage_device_ms)
    emit("times", card=card, seconds=time.perf_counter() - t)

    # -- 6. migration: host <-> device mid-flight, the seeded walk (K3) -------
    # the never-preempted walks above ran the same tables as SS does
    for low, rows in ((lin, lin_rows), (rec, rec_rows)):
        ss = build_dag_tables_cached(low.dag, 1, "SS").tables[0].copy()
        ss[:, 1:] *= TILE
        require(np.array_equal(ss, rows), "the SS table differs from the walked one")
    abs_rec = {"item_norms": ((R * R).sum(0), U // TILE),
               "user_bias": (R.abs().sum(1) / I, I)}
    migrated = {}
    for pipe, direction, cut in MIGRATIONS:
        for k in _build.KERNELS:
            k.launches.clear()
        t = time.perf_counter()
        if pipe == "linreg":
            answer, vals, split = apps.linear_regression_migrated(
                LINREG_ROWS, LINREG_COLS, cut, direction=direction)
        else:
            answer, vals, split = apps.recommendation_migrated(
                REC_USERS, REC_ITEMS, cut, direction=direction)
        seconds = time.perf_counter() - t
        mig_launches = launch_counts(_build.KERNELS)
        require(mig_launches == {f"walk_{pipe}": 1},
                f"{pipe} {direction}: launches {mig_launches}, want one walk_{pipe}")
        checks = {}
        if pipe == "linreg":
            # syrk_gemv against the never-preempted walk on the run's moments
            want_syrk = solo_walk(lin, lin_rows, "syrk_gemv", vals)[1]
            for s, want_s in (("moments", k_out["moments"]), ("syrk_gemv", want_syrk)):
                checks[s] = close(vals[s], want_s, abs_lin[s], n // TILE,
                                  f"migrated linreg {direction} {s}", MIGRATED_FACTOR)
            del want_syrk
            b_abs = abs(answer.astype("float64") - beta_ref)
            require(float(b_abs[:-1].max()) <= feat_lim and float(b_abs[-1].max()) <= icpt_lim,
                    f"migrated linreg {direction}: beta beyond the oracle's limits")
            checks["beta_max_abs_err"] = float(b_abs.max())
        else:
            for s, (a, adds) in abs_rec.items():
                checks[s] = close(vals[s], k_rec[s], a, adds,
                                  f"migrated recommendation {direction} {s}",
                                  MIGRATED_FACTOR)
            require(torch.equal(answer, apps.scores_plain(R, vals["item_norms"],
                                                          vals["user_bias"])),
                    f"migrated recommendation {direction}: scores differ bitwise "
                    "from the plain body given the run's own norms and bias")
            agree_m, same_m = rec_oracle.agreement(answer)
            require(agree_m >= REC_AGREEMENT, f"migrated recommendation {direction}: "
                                              f"scores agree on {agree_m:.6f} of users")
            checks["scores_agreement"] = agree_m
            checks["scores_same_item_as_oracle"] = same_m
        migrated[(pipe, direction)] = dict(vals=vals, launches=mig_launches)
        emit("migration", pipeline=pipe, direction=direction, cut=cut,
             launches=mig_launches, seconds=seconds, host_seconds=split["host"],
             walk_seconds=split["walk"], sum_tol="2 * eps32 * sqrt(adds) * sum|terms|",
             checks={k: list(v) if isinstance(v, tuple) else v for k, v in checks.items()})

    t = time.perf_counter()
    ss1 = SchedulerConfig(technique="SS", queue_layout="CENTRALIZED", n_workers=1)

    def seeded_plan(low, pipe):
        """The remainder the host -> device entry point walked, from the
        same data and cut; its walk must repeat that run's bits."""
        cut = next(c for p_, d_, c in MIGRATIONS if (p_, d_) == (pipe, "host_to_device"))
        _, ck = PreemptiveRunner(low.dag, ss1, preempt_after=cut).run()
        plan = device_remainder(ck, low)
        got = plan.walk()
        want = migrated[(pipe, "host_to_device")]["vals"]
        for name in got:
            require(torch.equal(got[name], want[name]),
                    f"{pipe}: the seeded walk differs from the entry point's {name}")
        return plan, ck

    def zero_seed_fails(plan, stage, ref, abs_sum, adds, what):
        """The negative control: the same walk from a zero seed must fail."""
        key = next(s.seed for s in plan.stages if s.name == stage)
        values = dict(plan.values, **{key: torch.zeros_like(plan.values[key])})
        out = dag_walk(plan.stages, plan.operands, values, plan.table, TILE)[stage]
        bad, _, share = excess(out, ref, abs_sum, adds, MIGRATED_FACTOR)
        require(bad > 0, f"{what}: a zero seed passed the migrated sum check")
        return bad, share

    # linreg: `syrk_gemv` alone, seeded; `moments` a plain value
    plan, ck = seeded_plan(lin, "linreg")
    require([s.name for s in plan.stages] == ["syrk_gemv"] and plan.stages[0].seed,
            "linreg host -> device: the walk is not syrk_gemv alone, seeded")
    zero_lin = zero_seed_fails(plan, "syrk_gemv", k_out["syrk_gemv"],
                               abs_lin["syrk_gemv"], n // TILE, "linreg syrk_gemv")
    walk_k3 = plan.walk
    plain_k3 = lambda: dag_walk_plain(plan.stages, plan.operands, plan.values,  # noqa: E731
                                      plan.table, TILE)
    err_k3, _ = close(walk_k3()["syrk_gemv"], plain_k3()["syrk_gemv"],
                      abs_lin["syrk_gemv"], n // TILE, "seeded linreg walk vs plain")
    m0 = (ck.stages["syrk_gemv"].acc_next) * TILE   # rows the host summed
    mom = plan.values["moments"]
    mean = mom[0] / n
    std = torch.sqrt(torch.clamp(mom[1] / n - mean * mean, min=0.0))
    X1yr = torch.cat([(X[m0:] - mean) / std, torch.ones(n - m0, 1, device=dev),
                      y[m0:]], dim=1)
    seed_syrk = plan.values[plan.stages[0].seed]
    m = n - m0
    k3_bytes = 4 * (m * d + m + 2 * d + 2 * (d + 1) * (d + 2)) + 12 * len(plan.table)
    k3_flops = 2 * m * d + m * (d + 1) * (d + 2) + 2 * m * (d + 1)
    kernels.append(dict(
        name="dag_walk[linreg, seeded]", route="cuda",
        source="src/repro_torch/csrc/dag_walk.cu",
        replaces="src/repro/core/preempt.py:583",
        launches=migrated[("linreg", "host_to_device")]["launches"]["walk_linreg"],
        max_abs_err=err_k3, ms=timed(walk_k3, 5), **kernel_device_ms(walk_k3),
        plain_ms=timed(plain_k3, 1, warmup=0),
        library_ms=timed(lambda: torch.addmm(seed_syrk, X1yr[:, :d + 1].T, X1yr), 10),
        library_call="torch.addmm(seed, X1r.T, [X1r | yr]) over the walked rows, "
                     "X1r precomputed",
        shapes=f"X ({n}, {d}) f32, rows {m0}..{n} walked, {len(plan.table)} slots, "
               f"seed ({d + 1}, {d + 2}), tile {TILE}",
        **dict(zip(("bound_ms", "bound_by"), bound_ms(k3_bytes, k3_flops)))))
    del X1yr

    # recommendation: `item_norms` seeded, `user_bias` replayed, `scores`
    plan, ck = seeded_plan(rec, "recommendation")
    require(plan.stages[0].name == "item_norms" and plan.stages[0].seed,
            "recommendation host -> device: item_norms is not seeded")
    zero_rec = zero_seed_fails(plan, "item_norms", k_rec["item_norms"],
                               *abs_rec["item_norms"], "recommendation item_norms")
    walk_k3r = plan.walk
    plain_k3r = lambda: dag_walk_plain(plan.stages, plan.operands, plan.values,  # noqa: E731
                                       plan.table, TILE)
    got_r, plain_r = walk_k3r(), plain_k3r()
    err_k3r, _ = close(got_r["item_norms"], plain_r["item_norms"],
                       *abs_rec["item_norms"], "seeded recommendation walk vs plain")
    require(torch.equal(got_r["scores"], apps.scores_plain(R, got_r["item_norms"],
                                                           got_r["user_bias"])),
            "seeded recommendation walk: scores differ from the plain body")
    m1 = (REC_UNITS - ck.stages["item_norms"].acc_next) * TILE  # item_norms rows walked
    seed_r = next(plan.values[s.seed] for s in plan.stages if s.name == "item_norms")
    # the seed read once more, the replayed user_bias rows written again
    k3r_bytes = rec_bytes(U, I) + 4 * I + 4 * U + 12 * len(plan.table)
    k3r_flops = 2 * m1 * I + U * I + 2 * I + 3 * U * I
    kernels.append(dict(
        name="dag_walk[recommendation, seeded]", route="cuda",
        source="src/repro_torch/csrc/dag_walk.cu",
        replaces="src/repro/core/preempt.py:583",
        launches=migrated[("recommendation", "host_to_device")]["launches"][
            "walk_recommendation"],
        max_abs_err=err_k3r, ms=timed(walk_k3r, 10),
        **kernel_device_ms(walk_k3r), plain_ms=timed(plain_k3r, 3),
        library_ms=None,
        library_call="none: no one PyTorch call computes norms, bias and scores",
        library_chain_ms=timed(lambda: rec_chain(
            R, seed_r + R[U - m1:].square().sum(0, keepdim=True)), 10),
        library_chain_call=REC_CHAIN_CALL + ", norms from the seed and the walked rows",
        shapes=f"R ({U}, {I}) f32, item_norms rows {U - m1}..{U} walked, "
               f"{len(plan.table)} slots, tile {TILE}",
        **dict(zip(("bound_ms", "bound_by"), bound_ms(k3r_bytes, k3r_flops)))))
    emit("seeded_walks", zero_seed_entries_beyond_limit={
             "linreg syrk_gemv": zero_lin[0], "recommendation item_norms": zero_rec[0]},
         zero_seed_worst_share_of_limit={
             "linreg syrk_gemv": zero_lin[1], "recommendation item_norms": zero_rec[1]},
         seconds=time.perf_counter() - t)

    del rec_oracle
    kernels.append(moe_phase(dev, walk_inputs))
    kernels.extend(batched_phase(dev, walk_inputs))
    kernels.append(cc_iteration_phase(G, c, u))
    paper_entry_points_phase(graph, G, c, lin, lin_rows, stage_device_ms["linreg"],
                             kernels[0]["device_ms"], beta, beta_ref,
                             (feat_lim, icpt_lim))
    lin_costs = server_telemetry_phase(dev, lin, lin_rows, lin_stamps,
                                       stage_device_ms["linreg"], beta, (feat_lim, icpt_lim))
    front_door_phase(dev, lin, beta, (feat_lim, icpt_lim), lin_costs)
    kernels.append(serve_phase(dev))
    gc.collect()
    kernels.append(rwkv6_phase(dev))
    gc.collect()
    kernels.extend(zamba2_phase(dev))
    # the MoE families' fp32 weights take 57.27 and 62.83 GB of the card's
    # 80: everything before is freed, and each model before the next
    for phase in (serve_qwen2_moe_phase, serve_deepseek_v2_lite_phase):
        gc.collect()
        torch.cuda.empty_cache()
        kernels.append(phase(dev))
    # the frontend families: Whisper-small whole, InternVL2-26B's 54.51 GB
    # of weights (32 of its 48 layers) with everything before freed
    gc.collect()
    torch.cuda.empty_cache()
    kernels.extend(serve_whisper_small_phase(dev))
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(serve_internvl2_26b_phase(dev))
    # training after every serving phase, with everything before freed
    gc.collect()
    torch.cuda.empty_cache()
    kernels.extend(train_qwen2_0_5b_phase(dev))
    for phase in (train_rwkv6_3b_phase, train_zamba2_7b_phase):
        gc.collect()
        torch.cuda.empty_cache()
        kernels.append(phase(dev))
    # the MoE, MLA and frontend families, each model freed before the next
    for phase in (train_qwen2_moe_a2_7b_phase, train_deepseek_v2_lite_16b_phase,
                  train_whisper_small_phase, train_internvl2_26b_phase):
        gc.collect()
        torch.cuda.empty_cache()
        kernels.extend(phase(dev))
    # the examples, each through its user's entry point, everything before freed
    gc.collect()
    torch.cuda.empty_cache()
    kernels.extend(examples_phase(dev))

    for row in kernels:
        row["redesigned"] = row["name"] in REDESIGNED
    require(sum(row["redesigned"] for row in kernels) == len(REDESIGNED),
            "a redesigned kernel's row is missing from the kernels line")
    emit("done", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
