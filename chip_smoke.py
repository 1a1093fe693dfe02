#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no result is printed:

1. Card and build: the card's name and power limit, then every CUDA
   source under ``src/repro_torch/kernels/csrc`` compiled with nvcc, all
   at once (registers, shared memory and spills from ptxas, and the
   seconds).
2. Kernels against their plain versions on the card at main-path shapes,
   bit for bit: ``quant_matmul`` at the stem (K = 27), a conv of each
   resnet34-cifar stage at 32 slots, two M tails, mobilenetv2's K = 24
   and a head (int8 and fp32 output), w K-major as the export stores it,
   each line ending with its route and plan (TMA + ``wgmma`` with K split
   over a cluster where K % 16 == 0, else ``mma.sync``);
   ``fake_quant_fused`` at the three head weights; ``depthwise_conv`` at
   every mobilenetv2-cifar depthwise shape at 32 slots plus a
   channel-multiplier case, each line ending with its route and plan
   (``dw_plan``: the tile route, a band's halo tile staged by TMA and a
   register window over 16-byte channel groups, required there), held bit
   for bit in int8 and fp32 output with and without ReLU; then its general
   route, which must take them: an odd shape (3, 7, 9, 5) at stride 2 and
   stage 0's shape with x one byte off 16;
   ``lowrank_conv`` at the factored resnet34-cifar shapes inside the fused
   envelope (ranks from the real factorization at energy 0.6), u and v
   K-major as the export stores them, each line ending with its plan
   (``lr_plan``) and route, and beside each shape the chained lowering
   (two ``quant_matmul`` calls, bit-exact against the fused one) timed
   and the choice ``lowering_costs`` makes at the measured launch term;
   then its ``mma.sync`` route, which must take them: K1 = 24 and 72
   (K1 % 16 != 0) and stage 2's shape on patches one byte off 16.
   Each case prints the wrapper call's time, the kernel's device time
   (torch.profiler), the plain version's time, a library yardstick the
   port never calls (``torch._int_mm`` on operands zero-padded to its
   shape rules, or a grouped ``F.conv2d``, plus a torch epilogue) and the
   bound: bytes once in and once out at 3.35 TB/s against the operations
   at the card's peak.  The launch term of the low-rank cost model is
   measured here: one wrapper call at the head shape.  The fake-quant
   wrappers at path (f)'s shapes, bit for bit (both launch the CUDA
   cluster kernel): the two-pass ``fake_quant``
   at tinyllama-1.1b's MLP ``wo`` (5632, 2048), a ragged (5000, 1000) and
   (4160, 256), bf16 and fp32, and ``fake_quant_fused``
   in bf16 at (2048, 5632), (2048, 2048) and (2048, 256), in fp32
   at (2048, 2048) and at a (100000, 10) head whose slices fit no shared
   memory, against the yardstick ``torch.amax`` +
   ``torch.fake_quantize_per_channel_affine`` (on an fp32 upcast); each
   line ends with the launch plan (BN, C, R, blocks, shared memory).  Then
   ``decode_attention`` and ``decode_attention_int8`` at
   tinyllama-1.1b's heads (H 32, K 4, D 64): B 1 and 8, S 584 (the served
   cache) and 2048, a valid prefix and a case with a hole; fp32, bf16 and
   an int8 cache under bf16 q; and the int8 cache with 40 valid slots of
   584 (whole blocks of its split masked), each within ``DECODE_TOL`` x
   max|plain| (fp32 1e-5; bf16 output 8e-3, about one bf16 ulp), the
   yardstick ``F.scaled_dot_product_attention(enable_gqa=True)`` on the
   same masked cache (dequantized first for int8), the bound the valid
   slots' k/v (and scale) bytes plus q and the output once at 3.35 TB/s;
   and an fp32 cache at head_dim 128 (6 warps a block, the most its shared
   memory allows); each line ends with the split kernel's plan (S split
   over a cluster, the same kernel for the three caches).
3. End to end, three CNN paths, each at full width and depth with random
   weights from seed 0, exit heads at the default stages, W8A8,
   ``export_cnn(device='cuda', calibrate=<32 images>)``, the exit
   threshold calibrated, and 256 Poisson requests served through
   ``ContinuousBatchScheduler`` at 32 slots:
   (a) ``resnet34-cifar``; (b) ``mobilenetv2-cifar``, its depthwise layers
   on ``depthwise_conv``; (c) ``resnet34-cifar`` factored
   (``factorize(energy=0.6, min_rank=2)``) and exported with
   ``select_kernels='fused'``, its factored convs inside the envelope on
   ``lowrank_conv`` and the rest chained on ``quant_matmul``.  The kernel
   counts are set to 0 just before each path and read just after.  On
   every path: every request completes, the launches of each kernel while
   serving equal the plan's per executed segment, the plain versions do
   not run, each kernel of the path was launched, ``quant_matmul`` and
   ``lowrank_conv`` relaid no weight (the export stores them K-major), their
   launches by route are those of the operand rule (TMA + ``wgmma`` where
   K % 16 == 0, ``mma.sync`` else), every ``depthwise_conv`` launch took
   the tile route, 16 sampled requests are
   bit-exact against the monolithic ``fn_exits`` on the request alone at
   the same slot geometry; the card's calibration agrees with the CPU's
   scale by scale (to float noise up to the first fake-quant code that
   differs, which must lie at a rounding tie, and within ``SCALE_RTOL``
   after it); and the served logits agree with the port's plain CPU path
   on a small batch, on the same static scales, within 4e-2 x max|logit|.
   Then two LM decode paths through the functions ``launch/serve.py``
   uses, ``tinyllama-1.1b`` at full width and depth, random weights from a
   CUDA generator seeded 0, batch 8, prompt 512, 64 greedy decode tokens,
   after a warm-up: (d) bf16 weights and cache on ``decode_attention``;
   (e) ``export_lm`` int8 weights and ``kv_cache_bits=8`` on
   ``decode_attention_int8``.  Counted from zero: the path's kernel
   launches 22 x 64 times, the other decode kernel and the plain versions
   never.  Printed: prefill ms, ms/token, tokens/s, peak memory, and under
   the profiler 8 more steps' device busy share and the kernel's share of
   device time.  Gates: the first-step logits within ``LM_PLAIN_TOL`` x
   max|logit| of the same model on the kernels' plain versions on the
   card; a 2-layer fp32 cut of the config (batch 2, prompt 32, 4 steps,
   TF32 off) within ``LM_CPU_TOL`` of the port's CPU path.
   Then (f) the paper's Q pass (QAT fine-tuning) of ``tinyllama-1.1b`` at
   full width and depth in bf16, through ``init_chain_state``, the
   registry's ``Q`` and ``ChainState.metrics``: random weights from a
   CUDA generator seeded 0, batches of 8 x 128 tokens, one warm-up step on
   a clone, then 8 counted steps.  Counted from zero: the two-pass
   ``fake_quant`` 22 launches a step (MLP ``wo``), ``fake_quant_fused``
   132 (the other six projections), every other kernel and every plain
   version 0.  Printed: the loss at every step (all finite, gated), the
   params changed (gated), ms/step, tokens/s, peak memory, the Q record
   (BitOpsCR 16 and CR 4, gated) and one profiled step's device busy
   share and device ms by kernel.  A 2-layer fp32 cut at full width, one
   Q-pass step on the card and on the CPU from the same params and batch
   (TF32 off), at W8A0 and at W8A8 (``QAT_CUTS``): the loss and the new
   params within each one's bands.
   Then (g) the paper's compression chain on ``resnet34-cifar`` at its
   published widths and depth: ``Pipeline.from_sequence('DPLQE')`` with
   the hyperparameters of ``examples/chain_cnn.py --sequence DPLQE`` (D
   factor 0.5, P ratio 0.3, L energy 0.9, Q W2A8, E threshold 0.85),
   batches of 64, a 30-step baseline and 10 steps a pass (D's student 30),
   a checkpoint after every pass, counted from zero; printed: each pass's
   record (acc, BitOpsCR, CR), last loss and wall time, the student's and
   the pruned config, the factored weights' ranks, peak memory.  Gates:
   the labels and finite losses; every record's BitOpsCR and CR recomputed
   on the CPU from the checkpoints; P of checkpoint 1 and L of checkpoint 2
   on the card equal to the CPU's bit for bit (with the smallest relative
   importance gap at P's boundary); the ``fake_quant_fused`` calls of one
   Q step bit-exact; one Q step from checkpoint 3 on the card and on the
   CPU within ``CHAIN_CUTS``' bands; a second run on the checkpoints
   applying nothing and returning the final params bit for bit.  The chain
   is then exported with ``export_chain(calibrate=...)`` and served at its
   own exit threshold through the same steps and gates as (a)-(c), the
   launches by route held to the operand rule (``wgmma`` where K % 16 ==
   0): P keeps 44-358 channels, so pruned convs and their factored halves
   take ``mma.sync``.
   Then the dynamic-scale exports (a'), (b'), (c') and (g'): the models of
   (a)-(c) through ``export_cnn(calibrate=None)`` and (g)'s chain through
   ``Pipeline.export``, counted from zero: ``fn_exits`` on a fixed batch of
   32 images on the kernels (every ``quant_matmul`` call with K % 16 == 0
   on ``wgmma``, every depthwise call on the tile route, no weight relaid,
   no plain version), bit for bit against the same model with every
   kernel call swapped for its plain version, the stage segments chained
   bit for bit against ``fn_exits``, and against the CPU export layer by
   layer, each CPU layer fed the card's int8 input: every dynamic scale
   within 1e-5, every code that differs at a rounding tie, the logits
   within 4e-2 x max|logit| (end to end on their own scales, printed);
   (a') also served through the scheduler (req/s, p50, p99;
   a dynamic scale depends on a request's batch mates, so its requests
   are checked for completion only and the bit-exact gates hold at fixed
   batches).
   Then (h) the paper's chain on ``tinyllama-1.1b`` at its published width:
   ``Pipeline.from_sequence('DPLQE')`` with ``examples/chain_lm.py``'s
   hyperparameters (D factor 0.5: an 11-layer student of the 22-layer
   bf16 teacher; P ratio 0.3: d_ff 3942; L energy 0.6, which factors every
   stacked MLP weight; Q W8A8; E threshold 0.8), batches of 8 x 128
   tokens, 2 baseline steps and 2 a pass (D's student 6), a checkpoint
   after every pass, counted from zero; printed: each pass's record, last
   loss and wall time, the peak memory, the ranks, the exit fractions, a
   profiled Q step and the exit frontier of ``sweep_exit_thresholds``.
   Gates: the records recomputed on the CPU from the checkpoints; the
   110 fake-quant calls of one Q step and the 112 of one E step bit-exact;
   the resumed run bit for bit; on a 2-layer fp32 cut at full width, P,
   L (an fp64 Gram eigendecomposition on the card, numpy on the CPU), the
   exit
   decisions and a W8A8 Q step of the pruned, factored cut against the
   CPU; some tokens leave at a head on the frontier.  Then
   ``Pipeline.export`` and a decode through ``launch/serve.py``'s
   functions at batch 8, prompt 512, 64 tokens on the bf16 cache (11
   ``decode_attention`` launches a token), its first-step logits within
   ``LM_PLAIN_TOL`` of the plain decode attention; prefill ms and
   ms/token printed.
   Then (i) the serving runtime's other half on ``resnet34-cifar`` at its
   published widths, (a)'s weights and requests, counted from zero (the
   request-alone oracle and the plain-version twin not counted): (a)'s
   state saved as a chain checkpoint and loaded through
   ``ModelRegistry.load`` (``export_cnn(calibrate=32 images)`` on the
   card), the stage costs from CUDA events (the median of 5 after a
   warm-up, ``serve_cnn._measure_stage_costs``), printed.  (i-slo):
   ``ContinuousBatchScheduler`` with an ``SLOPolicy`` on the simulated
   clock at a loose deadline (4 x the sum of the costs; every request
   served) and a tight one (between costs[0] + costs[1] and the sum;
   some request must degrade to an exit head or be rejected); at both no
   request late and every completion bit-exact against ``fn_exits`` on
   the request alone at 32 slots (a degraded one against its exit head's
   row); attainment, rejections, degradations and their exit mix
   printed.  (i-pool): ``ReplicaPoolScheduler`` with 2 replicas (up to 4)
   under ``ChaosPlan.seeded(0, 2, horizon)`` as ``serve_cnn --chaos``
   builds it, failing over through ``ModelRegistry.restore`` (a re-export
   from the checkpoint on the card): at least one kill and one failover,
   every request completed bit-exact against ``fn_exits``, and the
   restored model's ``fn_exits`` equal to the original's; availability,
   kills, failovers, straggler flags, evictions and peak replicas
   printed.  (i-trace): that run traced, a strict ``check_trace`` green
   before and after a Chrome round trip through a file with the same
   span count, the kill and the failover in it.  (i-measure):
   ``export_cnn(select_kernels='measure')`` on (c)'s factored model:
   every factored conv inside the fused envelope gets a measured choice
   (its measured and modeled fused/chained microseconds printed, and how
   many the cost model got wrong), ``lowrank_conv`` and ``quant_matmul``
   both launch, and ``fn_exits`` bit for bit against its plain-version
   twin.
4. Every kernel call of one full-depth 32-slot pass of each CNN path,
   every decode-attention call of one decode step of (d) and (e) (22
   each), and every fake-quant call of one step of (f), captured at its
   inputs (132 fused, 22 two-pass), held against its plain version on the
   card at its own shapes (bit for bit; the decode kernels within
   ``DECODE_TOL``) and timed, each line ending with its plan; every
   ``quant_matmul`` and ``lowrank_conv`` call with K (K1) % 16 == 0 must
   take the TMA + ``wgmma`` route and every other call ``mma.sync``, every
   ``depthwise_conv`` call the tile route; the fake-quant calls of path
   (g)'s Q step and its export, the calls of one pass of each dynamic
   export at their own inputs and the fake-quant calls of one Q step of
   (h) are held too, and every call of one pass of (i)'s measure-mode
   export.  The ``{"kernels": [...]}``
   line: every ported kernel, summed over the pass or step of the path
   that calls it most (``quant_matmul``: path (a); ``depthwise_conv``: (b);
   ``lowrank_conv``: (c); the decode kernels: (d) and (e); both
   fake-quant wrappers: (f)), every path's pass under ``by_path``, its
   launches over all the paths' counted runs (path (g): its chain and
   its serving; (h): its chain and its decode; (i): its export, stage
   costs, SLO, pool and measure-mode runs), and ``excess_ms``: those
   launches times (its time a call less its bound a call).

The last line of standard output is ``{"ok": true, "device": {...}}``.
This script imports no JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, 'src'))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 peak outside the tensor cores
CUDA_CORE_OPS_PER_S = FP32_OPS_PER_S   # the guide's CUDA-core rate; the
#                                depthwise kernel's int32 multiply-adds
#                                issue at this rate or below
SLOTS = 32
N_REQUESTS = 256
RATE = 2000.0                  # Poisson arrivals per second
N_ORACLE = 16
SEED = 0
# Card calibration against the CPU's (check_calibrations): scales agree
# to float noise until an activation's fake-quant codes first differ, those
# codes sit at rounding ties, and later scales agree within SCALE_RTOL.  On
# an H100 80GB HBM3 (PERF.md) the scales before the first flip were equal,
# the flipped codes within 1e-6 of a tie, and later scales within 1.9e-2
# (resnet34), 3.0e-2 (mobilenetv2) and 3.0e-2 (factored resnet34).
SCALE_RTOL_EXACT = 1e-5
TIE_TOL = 1e-4
SCALE_RTOL = 5e-2
LOWRANK = dict(energy=0.6, min_rank=2)
# LM decode serving (paths d and e): tinyllama-1.1b at full width and depth,
# random weights from a CUDA generator seeded SEED, batch 8, prompt 512, 64
# greedy decode tokens, a cache of 512 + 64 + 8 slots
LM_ARCH = 'tinyllama-1.1b'
LM_BATCH, LM_PROMPT, LM_TOKENS = 8, 512, 64
LM_PROFILE_STEPS = 8           # the cache's 8 spare slots, under the profiler
LM_PATHS = (
    dict(key='tinyllama-bf16', int8_weights=False, kv_cache_bits=0,
         kernel='decode_attention', other='decode_attention_int8'),
    dict(key='tinyllama-int8', int8_weights=True, kv_cache_bits=8,
         kernel='decode_attention_int8', other='decode_attention'),
)
# Decode attention against its plain version, max|kernel - plain| over
# max|plain|: fp32 sums in another order; a bf16 output within about one
# bf16 ulp (the int8-KV path serves bf16 q and output)
DECODE_TOL = {'fp32': 1e-5, 'bf16': 8e-3, 'int8': 8e-3}
# the compiled kernel behind each decode wrapper, as the profiler names it
DA_DEVICE_NAME = {'decode_attention': 'decode_split_kernel',
                  'decode_attention_int8': 'decode_split_kernel'}
# the compiled kernels behind the quant_matmul and lowrank_conv wrappers,
# one for each route
QMM_DEVICE_NAMES = ('qmm_wgmma_kernel', 'qmm_kernel')
LR_DEVICE_NAMES = ('lr_wgmma_kernel', 'lr_kernel')
DW_DEVICE_NAMES = ('dw_tile_kernel', 'dw_kernel')
# quant_matmul's and lowrank_conv's launches by route and weight relayouts,
# and depthwise_conv's launches by route, while each CNN path served,
# filled by serve_path
QMM_ROUTES = {}
LR_ROUTES = {}
DW_ROUTES = {}
LM_PLAIN_TOL = 2e-2            # card logits: kernel vs plain decode attention
LM_CPU_TOL = 1e-3              # 2-layer fp32 cut: card vs CPU
LM_CUT = dict(layers=2, batch=2, prompt=32, tokens=4)
# LM QAT through the Q pass (path f): tinyllama-1.1b at full width and
# depth, bf16, random weights from a CUDA generator seeded SEED, batches of
# 8 x 128 tokens, Q at lr / 10 with weight decay 1e-4 (core/passes.py),
# one warm-up step on a clone, then QAT_STEPS counted steps
QAT_KEY = 'tinyllama-qat'
QAT_HP = {'w_bits': 8, 'a_bits': 8}
QAT_SEQ, QAT_BATCH, QAT_STEPS, QAT_LR = 128, 8, 8, 1e-3
# fake-quant launches a step: per layer wq, wk, wv, attn wo, MLP wi and wg
# on the fused wrapper; MLP wo (5632, 2048) on the two-pass wrapper
QAT_PER_LAYER = {'fake_quant_fused': 6, 'fake_quant': 1}
# The 2-layer fp32 cut: one Q-pass step on the card and on the CPU from the
# same params and batch, held to bands on the loss (relative) and on the new
# params: no element more than max_lr x lr apart and at most ``share`` of
# the elements more than QAT_NEAR_LR x lr apart (lr the Q pass's).  AdamW's
# first step is about +-lr whatever |g| is, so an element whose gradient
# differs in sign between the devices moves 2 x lr apart.  W8A0 holds the
# tight bands.  W8A8 cannot: the activation fake quant (a per-tensor
# abs-max grid) flips a code wherever the two devices' fp32 matmuls round a
# value at a rounding tie differently, and each flip moves the gradients
# of whole weight rows.  Emulated on the CPU at this cut (fp32 against
# float64-rounded products), W8A8 moved the loss by 8.3e-5 of itself and
# 1.6% of the elements by more than 1e-2 x lr, W8A0 by 0 and 2e-6.
QAT_CUT_BATCH = 2
QAT_NEAR_LR = 1e-2
QAT_CUTS = (   # (hp, loss rtol, max_lr, share)
    ({'w_bits': 8, 'a_bits': 0}, 1e-4, 2.5, 1e-3),
    (QAT_HP, 1e-3, 2.5, 5e-2))
# Path (g): the paper's chain D->P->L->Q->E on resnet34-cifar at its
# published widths and depth, random weights from seed 0, the
# hyperparameters of examples/chain_cnn.py --sequence DPLQE: D factor 0.5,
# P ratio 0.3, L energy 0.9 (min_rank 4), Q W2A8, E threshold 0.85;
# baseline 30 steps, 10 fine-tune steps a pass (D's student 30), checkpoints
# after every pass; then exported with export_chain(calibrate=<32 images>)
# and served as paths (a)-(c) are
CHAIN_KEY = 'resnet34-chain'
CHAIN_CONFIG = 'resnet34-cifar'
CHAIN_SEQUENCE = 'DPLQE'
CHAIN_HPS = {'D': {'factor': 0.5}, 'P': {'ratio': 0.3},
             'L': {'energy': 0.9, 'min_rank': 4},
             'Q': {'w_bits': 2, 'a_bits': 8}, 'E': {'threshold': 0.85}}
CHAIN_TRAINER = dict(batch=64, steps=10, lr=2e-3, eval_n=2, eval_batch=256)
CHAIN_PRETRAIN = 30
CHAIN_DIFFICULTY = 0.55
# One fine-tune step of Q's loss on the trained student (the params Q
# starts from, checkpoint step 3), card against CPU from the same params and
# a batch of CHAIN_CUT_BATCH images, TF32 off: (hp, bands), the bands
# (loss rtol, max_lr, share) of QAT_CUTS.  W2A0 holds them tight (five
# runs on an H100 80GB HBM3: the loss 6.1e-8 to 9.5e-8 x itself apart, the
# params 4.4e-3 to 0.54 x lr, at most 33 of 7.6 M elements 1e-2 x lr
# apart).  W2A8 flips activation codes at rounding ties, as path (f)'s
# W8A8 does (act_code_flips prints the first: one code, exactly on a tie),
# and each flip moves every later abs-max scale, the loss and whole rows
# of gradients: the loss 1.4e-4 to 5.4e-3 x itself apart, 4.3% to 19.7% of
# the elements more than 1e-2 x lr apart, so W2A8 is reported and held to
# finite values only (bands None), as the card test of path (f)'s Q step
# holds W8A8.
CHAIN_CUT_BATCH = 16
CHAIN_CUTS = (({'w_bits': 2, 'a_bits': 0}, (1e-4, 2.5, 1e-3)),
              ({'w_bits': 2, 'a_bits': 8}, None))
# Path (h): the paper's chain D->P->L->Q->E on tinyllama-1.1b at its
# published width (arXiv:2401.02385), bf16, a 22-layer teacher, random
# weights from a CUDA generator seeded SEED, batches of 8 x 128 synthetic
# tokens; examples/chain_lm.py's hyperparameters (D factor 0.5: an 11-layer
# student; P ratio 0.3: d_ff 3942; Q W8A8; E threshold 0.8, heads after
# groups 3 and 7; lr 2e-3) with L at the paper's position.  L's energy is
# 0.6: on these near-random weights the spectrum is flat, 0.95 keeps about
# 1900 of 2048 singular values, past the rank r < d f / (d + f) = 1348
# below which a factorization saves MACs, so L would factor nothing; 0.6
# keeps about 640 (path c takes 0.6 too).  Cut in steps only: H_PRETRAIN
# baseline steps and H_STEPS a pass (D's student 3 x), checkpoints after
# every pass; then Pipeline.export and a decode at batch 8 x (512 + 64).
H_KEY = 'tinyllama-chain'
H_SEQUENCE = 'DPLQE'
H_HPS = {'D': {'factor': 0.5}, 'P': {'ratio': 0.3},
         'L': {'energy': 0.6, 'min_rank': 8},
         'Q': {'w_bits': 8, 'a_bits': 8}, 'E': {'threshold': 0.8}}
H_TRAINER = dict(batch=8, steps=2, lr=2e-3, eval_n=1, eval_batch=8)
H_PRETRAIN = 2
# fake-quant launches a training step of the pruned, factored student: per
# layer wq, wk, wv, attn wo and both halves of MLP wi, wg and wo, all on
# the fused wrapper (K <= 3942 passes its gate); E adds the two adapters
H_PER_LAYER = {'fake_quant_fused': 10, 'fake_quant': 0}
# exit decisions, card vs CPU on the 2-layer cut: a token may leave at
# another head only where a head's confidence lies within H_NEAR x the
# threshold of it (random heads over 32000 tokens are about 1e-3 confident)
H_NEAR = 1e-4
H_UV_RTOL = 1e-4               # u @ v, card vs CPU, over max|u @ v|
# the dynamic-scale exports (export_cnn(calibrate=None), Pipeline.export):
# paths (a)-(c) and the chain of (g) again, on fixed batches of SLOTS
# images; (a') is also served through the scheduler
DYN_TOL = 4e-2                 # card vs CPU export, over max|logit|
RT_KEY = 'resnet34-runtime'    # path (i): SLO, replica pool, trace, measure
RT_COST_ITERS = 5              # stage costs: median of 5 after a warm-up
RT_POOL = dict(replicas=2, max_replicas=4)
PATHS = (
    dict(key='resnet34', config='resnet34-cifar', factorize=False,
         kernels=('quant_matmul', 'fake_quant_fused')),
    dict(key='mobilenetv2', config='mobilenetv2-cifar', factorize=False,
         kernels=('quant_matmul', 'fake_quant_fused', 'depthwise_conv')),
    dict(key='resnet34-lowrank', config='resnet34-cifar', factorize=True,
         kernels=('quant_matmul', 'fake_quant_fused', 'lowrank_conv')),
)


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr)
    sys.exit(1)


def smi_line():
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f'nvidia-smi failed: {r.stderr.strip()}')
    return r.stdout.strip().splitlines()[0]


def bound(nbytes, ops, peak):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def time_ms(torch, fn, iters=20):
    """Mean milliseconds per call over ``iters`` calls, CUDA events, after
    one warm-up call.  A call shorter than its host work reads as that."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fns, match, iters=10):
    """Device milliseconds of the kernels whose name contains ``match`` (a
    string, or a tuple of strings any of which may match), per run of every
    call in ``fns``, under torch.profiler (None when the profiler recorded
    no such kernel: then it is not measured)."""
    match = (match,) if isinstance(match, str) else match
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, 'device_time_total', 0.0)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(m in e.key for m in match))
    return total / 1e3 / iters if total else None


def profile_device(torch, fn):
    """Run ``fn`` under torch.profiler: (wall ms, device kernel ms, top
    kernels by device time).  Device time is None when the profiler saw no
    device activity (it is then not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(getattr(e, 'device_time_total', 0.0) / 1e3, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(ms for ms, _, _ in kernels)
    return wall, (busy if kernels else None), sorted(kernels, reverse=True)


def same_bits(torch, a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b))


def max_err(torch, a, b):
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def rand_i8(torch, g, *shape):
    return torch.randint(-128, 128, shape, generator=g, device='cuda',
                         dtype=torch.int32).to(torch.int8)


# ------------------------------------------------------------------ phase 1


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    secs = time.perf_counter() - t0
    for name, i in info.items():
        print(f"[build] {name}: {'built' if i['built'] else 'cached'} "
              f"-> {os.path.relpath(i['path'], HERE)}")
        fn, spill = '?', ''
        for line in i['log'].splitlines():       # one line per kernel
            if 'Compiling entry' in line:
                fn = re.sub(r".*function '([^']+)'.*", r'\1', line)
            elif 'spill stores' in line:
                spill = line.strip()
            elif re.search(r'Used \d+ registers', line):
                regs = re.sub(r'.*Used (\d+) registers.*', r'\1', line)
                print(f'[build]   {fn}: {regs} registers; {spill}')
        if re.search(r'[1-9]\d* bytes spill stores', i['log']):
            print(f'[build] WARNING: {name} spills registers')
    print(f'[build] {len(info)} CUDA source(s) in {secs:.2f} s')


# ------------------------------------------------------------------ phase 2


def int_mm_operands(torch, x, w):
    """``torch._int_mm`` takes M > 16 and K, N multiples of 8: w (static)
    zero-padded to (K8, N8) once, and a zeroed (M', K8) buffer for x, M'
    at least 17 (x copied there too where it does not start on 16 bytes).
    Zero codes add nothing to the products, so the first M rows and N
    columns of the padded product are the product."""
    M, K = x.shape
    N = w.shape[1]
    k8, n8, mp = -(-K // 8) * 8, -(-N // 8) * 8, max(M, 17)
    wp = torch.zeros((k8, n8), dtype=torch.int8, device='cuda')
    wp[:K, :N] = w
    if (mp, k8) == (M, K) and x.data_ptr() % 16 == 0:
        return (lambda: x), wp
    xp = torch.zeros((mp, k8), dtype=torch.int8, device='cuda')

    def padded_x():
        xp[:M, :K].copy_(x)
        return xp
    return padded_x, wp


def qmm_library(torch, x, w, sx, sw, bias, relu, out_scale, out_qmax):
    """The yardstick: ``torch._int_mm`` plus a torch epilogue, the operands
    zero-padded to _int_mm's shape rules (the activation inside the call,
    the static weight once outside it) and the output sliced back."""
    from repro_torch.kernels.ref import requantize
    M = x.shape[0]
    N = w.shape[1]
    xin, wp = int_mm_operands(torch, x, w)

    def call():
        acc = torch._int_mm(xin(), wp)[:M, :N]
        y = acc.to(torch.float32) * (sx[:, None] * sw)
        if bias is not None:
            y = y + bias
        if relu:
            y = torch.clamp_min(y, 0.0)
        return requantize(y, out_scale, out_qmax) if out_scale else y
    return call


def qmm_case(torch, x, w, sx, sw, bias, relu, out_scale, out_qmax=127.0,
             iters=20):
    """Kernel vs plain version on one call: bit-exactness and times."""
    from repro_torch.kernels.quant_matmul import (qmm_plan, qmm_route,
                                                  quant_matmul,
                                                  quant_matmul_plain)
    kw = dict(relu=relu, out_scale=out_scale, out_qmax=out_qmax)
    before = dict(quant_matmul.launches_by_route)
    got = quant_matmul(x, w, sx, sw, bias, **kw)
    route = [r for r, n in quant_matmul.launches_by_route.items()
             if n != before[r]]
    want = quant_matmul_plain(x, w, sx, sw, bias, **kw)
    torch.cuda.synchronize()
    M, K = x.shape
    N = w.shape[1]
    nbytes = M * K + K * N + 4 * (M + N) + (4 * N if bias is not None else 0) \
        + M * N * (1 if out_scale else 4)
    b_ms, b_by = bound(nbytes, 2 * M * N * K, INT8_OPS_PER_S)
    lib = qmm_library(torch, x, w, sx, sw, bias, relu, out_scale, out_qmax)
    call = lambda: quant_matmul(x, w, sx, sw, bias, **kw)  # noqa: E731
    if route != [qmm_route(x, w)] or (K % 16 == 0) != (route[0] == 'wgmma'):
        fail(f'quant_matmul at {(M, K, N)} took route {route}')
    plan = 'mma_sync 64 x 64 tiles' if route[0] == 'mma_sync' else \
        'wgmma BM={} BN={} stages={} C={} smem={} B'.format(
            *qmm_plan(M, N, K))
    return {
        'shape': (M, K, N), 'int8_out': out_scale is not None,
        'route': route[0], 'plan': plan,
        'exact': same_bits(torch, got, want),
        'max_abs_err': max_err(torch, got, want), 'call': call,
        'ms': time_ms(torch, call, iters),
        'plain_ms': time_ms(torch, lambda: quant_matmul_plain(
            x, w, sx, sw, bias, **kw), iters),
        'library_ms': time_ms(torch, lib, iters),
        'bound_ms': b_ms, 'bound_by': b_by}


FQ_KERNELS = {   # wrapper: (its plain version, its kernels' names)
    'fake_quant_fused': ('fake_quant_plain', ('fq_cluster_kernel',)),
    'fake_quant': ('fake_quant_two_pass_plain', ('fq_cluster_kernel',)),
}


def fq_library(torch, w, bits):
    """The yardstick the port never calls: the column abs-max, then
    ``torch.fake_quantize_per_channel_affine`` (fp32 only: a bf16 weight is
    upcast first and the result cast back)."""
    qmax = 2 ** (bits - 1) - 1
    zero = torch.zeros(w.shape[1], dtype=torch.int32, device=w.device)

    def call():
        wf = w.float()
        scale = torch.clamp_min(torch.amax(wf.abs(), 0), 1e-8) / qmax
        return torch.fake_quantize_per_channel_affine(
            wf, scale, zero, 1, -qmax - 1, qmax).to(w.dtype)
    return call


def fq_case(torch, w, kernel='fake_quant_fused', bits=8, iters=20):
    """A fake-quant wrapper (``kernel``: the fused one or the two-pass
    one) against its plain version on one weight: bit-exactness and
    times.  Bound: w read once and the output written once (its dtype), or
    seven fp32 operations an element (abs, max, div, rint, two clips, mul)
    at the card's fp32 rate."""
    from repro_torch.kernels import fake_quant as fq
    fn = getattr(fq, kernel)
    plain = getattr(fq, FQ_KERNELS[kernel][0])
    got = fn(w, bits=bits)
    want = plain(w, bits=bits)
    lib = fq_library(torch, w, bits)
    lib_err = max_err(torch, lib(), want)
    torch.cuda.synchronize()
    K, N = w.shape
    b_ms, b_by = bound(2 * w.numel() * w.element_size(), 7 * K * N,
                       FP32_OPS_PER_S)
    call = lambda: fn(w, bits=bits)  # noqa: E731
    return {'shape': (K, N), 'dtype': str(w.dtype).replace('torch.', ''),
            'plan': fq_plan(w),
            'exact': same_bits(torch, got, want),
            'max_abs_err': max_err(torch, got, want), 'call': call,
            'ms': time_ms(torch, call, iters),
            'plain_ms': time_ms(torch, lambda: plain(w, bits=bits), iters),
            'library_ms': time_ms(torch, lib, iters),
            'library_err': lib_err, 'bound_ms': b_ms, 'bound_by': b_by}


def dw_library(torch, x, w, sx, sw, bias, stride, relu, out_scale,
               out_qmax):
    """The yardstick: ``F.conv2d(groups=CIN)`` on the fp32 codes (exact:
    every partial sum is an integer below 2**24) plus a torch epilogue."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import requantize, same_pads
    B, H, W, C = x.shape
    kh, kw, _, n = w.shape
    (ph, pw), _ = same_pads(H, W, kh, kw, stride)
    wf = w.permute(3, 2, 0, 1).to(torch.float32).contiguous()
    scale = torch.full((), sx, dtype=torch.float32, device='cuda') * sw

    def call():
        xf = F.pad(x.permute(0, 3, 1, 2).to(torch.float32),
                   (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(xf, wf, stride=stride, groups=C).permute(0, 2, 3, 1)
        y = y * scale
        if bias is not None:
            y = y + bias
        if relu:
            y = torch.clamp_min(y, 0.0)
        return requantize(y, out_scale, out_qmax) if out_scale else y
    return call


def dw_plan_str(plan):
    if plan.route == 'general':
        return 'general: a thread per 4 channels of a pixel'
    return ('tile slice={} rows={} cols={} threads={} smem={} B grid={} '
            'box={}'.format(plan.slice, plan.rows, plan.cols, plan.threads,
                            plan.smem_bytes, plan.grid, plan.box))


def dw_case(torch, x, w, sx, sw, bias, *, stride, relu=False,
            out_scale=None, out_qmax=127.0, iters=20, route=None):
    """Kernel vs plain version on one call: bit-exactness, route, plan and
    times; ``route``, where given, the route the call must take."""
    from repro_torch.kernels.depthwise_conv import (depthwise_conv,
                                                    depthwise_conv_plain,
                                                    dw_plan, dw_route)
    kw = dict(stride=stride, relu=relu, out_scale=out_scale,
              out_qmax=out_qmax)
    before = dict(depthwise_conv.launches_by_route)
    got = depthwise_conv(x, w, sx, sw, bias, **kw)
    took = [r for r, n in depthwise_conv.launches_by_route.items()
            if n != before[r]]
    want = depthwise_conv_plain(x, w, sx, sw, bias, **kw)
    n = w.shape[3]
    shape = tuple(x.shape) + (n, stride)
    if took != [dw_route(x, w, stride, out_scale, out_qmax)] or (
            route is not None and took != [route]):
        fail(f'depthwise_conv at {shape} took route {took}'
             + (f', not {route}' if route else ''))
    lib = dw_library(torch, x, w, sx, sw, bias, stride, relu, out_scale,
                     out_qmax)
    lib_out = lib()
    torch.cuda.synchronize()
    nbytes = x.numel() + w.numel() + 4 * n * (1 + (bias is not None)) + \
        got.numel() * got.element_size()
    b_ms, b_by = bound(nbytes, 2 * w.shape[0] * w.shape[1] * got.numel(),
                       CUDA_CORE_OPS_PER_S)
    plan = dw_plan(*x.shape, n, w.shape[0], w.shape[1], stride)
    call = lambda: depthwise_conv(x, w, sx, sw, bias, **kw)  # noqa: E731
    return {'shape': shape, 'int8_out': out_scale is not None,
            'route': took[0],
            'plan': dw_plan_str(plan if took[0] == plan.route else
                                plan._replace(route='general')),
            'exact': same_bits(torch, got, want),
            'library_agrees': same_bits(torch, lib_out, want),
            'max_abs_err': max_err(torch, got, want), 'call': call,
            'ms': time_ms(torch, call, iters),
            'plain_ms': time_ms(torch, lambda: depthwise_conv_plain(
                x, w, sx, sw, bias, **kw), iters),
            'library_ms': time_ms(torch, lib, iters),
            'bound_ms': b_ms, 'bound_by': b_by}


def dw_exact(torch, x, w, sx, sw, bias, *, stride, route, **kw):
    """One more epilogue of the kernel held bit for bit on ``route``."""
    from repro_torch.kernels.depthwise_conv import (depthwise_conv,
                                                    depthwise_conv_plain)
    before = depthwise_conv.launches_by_route[route]
    got = depthwise_conv(x, w, sx, sw, bias, stride=stride, **kw)
    want = depthwise_conv_plain(x, w, sx, sw, bias, stride=stride, **kw)
    torch.cuda.synchronize()
    if depthwise_conv.launches_by_route[route] != before + 1:
        fail(f'depthwise_conv at {tuple(x.shape)} {kw} left the {route} '
             f'route')
    if not same_bits(torch, got, want):
        fail(f'depthwise_conv disagrees with its plain version at '
             f'{tuple(x.shape)} stride {stride} {kw}')


def lr_library(torch, x, u, v, su, sv, bu, bv, sx, h_scale, relu,
               out_scale, h_qmax, out_qmax):
    """The yardstick: two ``torch._int_mm`` calls with torch epilogues, the
    operands zero-padded to _int_mm's shape rules (u, v and the rank's
    scales once, outside the call; the patches inside it) and the output
    sliced back."""
    from repro_torch.kernels.ref import requantize
    M = x.shape[0]
    R, N = v.shape
    xin, up = int_mm_operands(torch, x, u)
    r8 = up.shape[1]
    vp = torch.zeros((r8, -(-N // 8) * 8), dtype=torch.int8, device='cuda')
    vp[:R, :N] = v
    s_u = torch.zeros(r8, device='cuda')
    s_u[:R] = torch.full((), sx, dtype=torch.float32, device='cuda') * su
    b_u = torch.zeros(r8, device='cuda')
    b_u[:R] = bu
    s_v = torch.full((), h_scale, dtype=torch.float32, device='cuda') * sv

    def call():     # rows past M (zero patches) are computed and dropped
        h = torch._int_mm(xin(), up).to(torch.float32) * s_u + b_u
        h = requantize(h, h_scale, h_qmax)
        y = torch._int_mm(h, vp)[:M, :N].to(torch.float32) * s_v + bv
        if relu:
            y = torch.clamp_min(y, 0.0)
        return requantize(y, out_scale, out_qmax) if out_scale else y
    return call


def lr_case(torch, x, u, v, su, sv, bu, bv, *, sx, h_scale, relu=False,
            out_scale=None, h_qmax=127.0, out_qmax=127.0, iters=20):
    """Kernel vs plain version on one call: bit-exactness, route, plan and
    times (u and v as given: K-major, as the export stores them)."""
    from repro_torch.kernels.lowrank_conv import (lowrank_conv,
                                                  lowrank_conv_plain, lr_plan,
                                                  lr_route)
    kw = dict(sx=sx, h_scale=h_scale, relu=relu, out_scale=out_scale,
              h_qmax=h_qmax, out_qmax=out_qmax)
    before = dict(lowrank_conv.launches_by_route)
    got = lowrank_conv(x, u, v, su, sv, bu, bv, **kw)
    route = [r for r, n in lowrank_conv.launches_by_route.items()
             if n != before[r]]
    want = lowrank_conv_plain(x, u, v, su, sv, bu, bv, **kw)
    torch.cuda.synchronize()
    (M, K1), (R, N) = x.shape, v.shape
    if route != [lr_route(x, u, v)]:
        fail(f'lowrank_conv at {(M, K1, R, N)} took route {route}')
    plan = 'mma_sync 32-row tiles' if route[0] == 'mma_sync' else \
        'wgmma BM={} RP={} VN={} stages={} C={} smem={} B'.format(
            *lr_plan(M, K1, R, N))
    nbytes = M * K1 + K1 * R + R * N + 8 * (R + N) + \
        got.numel() * got.element_size()
    b_ms, b_by = bound(nbytes, 2 * M * R * (K1 + N), INT8_OPS_PER_S)
    lib = lr_library(torch, x, u, v, su, sv, bu, bv, sx, h_scale, relu,
                     out_scale, h_qmax, out_qmax)
    call = lambda: lowrank_conv(x, u, v, su, sv, bu, bv, **kw)  # noqa: E731
    return {'shape': (M, K1, R, N), 'int8_out': out_scale is not None,
            'route': route[0], 'plan': plan,
            'exact': same_bits(torch, got, want),
            'max_abs_err': max_err(torch, got, want), 'call': call,
            'ms': time_ms(torch, call, iters),
            'plain_ms': time_ms(torch, lambda: lowrank_conv_plain(
                x, u, v, su, sv, bu, bv, **kw), iters),
            'library_ms': time_ms(torch, lib, iters),
            'bound_ms': b_ms, 'bound_by': b_by}


def lr_chained(torch, x, u, v, su, sv, bu, bv, *, sx, h_scale, relu,
               out_scale, launch_us):
    """The chained lowering of one factored conv (two quant_matmul calls:
    u with the h_scale requantize, then v), bit-exact against the fused
    kernel, timed beside it, and the choice the cost model makes."""
    from repro_torch.kernels.lowrank_conv import lowering_costs, lowrank_conv
    from repro_torch.kernels.quant_matmul import quant_matmul
    M = x.shape[0]
    R, N = v.shape
    sxv = torch.full((M,), sx, dtype=torch.float32, device='cuda')
    shv = torch.full((M,), h_scale, dtype=torch.float32, device='cuda')

    def call():
        h = quant_matmul(x, u, sxv, su, bu, out_scale=h_scale)
        return quant_matmul(h, v, shv, sv, bv, relu=relu,
                            out_scale=out_scale)
    fused = lowrank_conv(x, u, v, su, sv, bu, bv, sx=sx, h_scale=h_scale,
                         relu=relu, out_scale=out_scale)
    exact = same_bits(torch, call(), fused)
    c = lowering_costs(M, x.shape[1], R, N, launch_us=launch_us)
    return {'exact': exact, 'ms': time_ms(torch, call),
            'device_ms': device_ms(torch, [call], QMM_DEVICE_NAMES),
            'choice': 'fused' if c['fused_us'] <= c['chained_us']
            else 'chained', 'fused_us': c['fused_us'],
            'chained_us': c['chained_us']}


def fmt_case(name, c):
    dev = c.get('device_ms')
    return (f"[kernel] {name} {c['shape']}"
            + (f" {'int8' if c['int8_out'] else 'fp32'}-out"
               if 'int8_out' in c else '')
            + (f" {c['dtype']}" if 'dtype' in c else '')
            + (f" route={c['route']}" if 'route' in c else '')
            + f": exact={c['exact']} max_abs_err={c['max_abs_err']:g} "
              f"ms={c['ms']:.4f}"
            + ('' if 'device_ms' not in c else
               f" device_ms={'not measured' if dev is None else f'{dev:.4f}'}")
            + f" plain_ms={c['plain_ms']:.4f} "
              f"library_ms={c['library_ms']:.4f} "
              f"bound_ms={c['bound_ms']:.4f} ({c['bound_by']})")


def need_exact(c, name):
    if not c['exact']:
        fail(f'{name} disagrees with its plain version at {c["shape"]}')


# mobilenetv2-cifar's depthwise layers at 32 slots: (input NHWC, stride)
DW_SHAPES = [((SLOTS, 32, 32, 96), 1), ((SLOTS, 32, 32, 96), 2),
             ((SLOTS, 16, 16, 144), 1), ((SLOTS, 16, 16, 144), 2),
             ((SLOTS, 8, 8, 192), 1), ((SLOTS, 8, 8, 192), 2),
             ((SLOTS, 4, 4, 384), 1)]


def lowrank_shapes(params):
    """The fused-envelope shapes of a factored resnet34-cifar at 32 slots,
    one per (stage, K1, COUT), with the rank the factorization gave, and
    every rank by stage."""
    from repro_torch.kernels.lowrank_conv import fits_fused
    shapes, ranks = {}, {}
    for s, blocks in enumerate(params['stages']):
        hw = 32 >> s
        for blk in blocks:
            for k in ('conv1', 'conv2', 'proj'):
                p = blk.get(k)
                if p is None or 'u' not in p:
                    continue
                kh, kw, cin, r = p['u']['w'].shape
                n = p['v']['w'].shape[-1]
                ranks.setdefault(s, []).append(r)
                key = (s, kh * kw * cin, n)
                if fits_fused(r, n) and key not in shapes:
                    shapes[key] = (SLOTS * hw * hw, kh * kw * cin, r, n)
    return list(shapes.values()), ranks


def phase_depthwise_kernels(torch, g):
    """``depthwise_conv`` at mobilenetv2-cifar's shapes and the x2 case on
    the tile route, then at an odd shape and on a misaligned x on the
    general route; each route required, every epilogue bit-exact."""
    def f32(*shape, scale=1.0):
        return torch.rand(shape, generator=g, device='cuda') * scale

    dw = [(shape, stride, 1) for shape, stride in DW_SHAPES] + \
        [((SLOTS, 16, 16, 48), 1, 2)]          # channel multiplier 2
    for shape, stride, mult in dw:             # the tile route, required
        n = shape[-1] * mult
        x, w = rand_i8(torch, g, *shape), rand_i8(torch, g, 3, 3, 1, n)
        sw, bias = f32(n, scale=1e-2), torch.randn(n, generator=g,
                                                   device='cuda')
        c = dw_case(torch, x, w, 0.05, sw, bias, stride=stride,
                    out_scale=0.37, out_qmax=127.0, route='tile')
        c['device_ms'] = device_ms(torch, [c['call']], DW_DEVICE_NAMES)
        print(fmt_case(f'depthwise_conv[x{mult}]', c)
              + f" library_agrees={c['library_agrees']}; {c['plan']}")
        need_exact(c, 'depthwise_conv')
        for kw in (dict(relu=True, out_scale=0.37), dict(),
                   dict(relu=True)):
            dw_exact(torch, x, w, 0.05, sw, bias, stride=stride,
                     route='tile', **kw)
    print('[kernel] depthwise_conv tile route: int8 and fp32 output, with '
          'and without ReLU, bit-exact at every shape above')
    # the general route, required: an odd shape, and stage 0's x one byte
    # off 16 bytes
    x_odd = rand_i8(torch, g, 3, 7, 9, 5)
    w_odd = rand_i8(torch, g, 3, 3, 1, 5)
    shape = DW_SHAPES[0][0]
    buf = rand_i8(torch, g, math.prod(shape) + 1)
    x_off = buf[1:].view(shape)
    for x, w, stride in ((x_odd, w_odd, 2),
                         (x_off, rand_i8(torch, g, 3, 3, 1, shape[-1]), 1)):
        n = w.shape[3]
        sw, bias = f32(n, scale=1e-2), torch.randn(n, generator=g,
                                                   device='cuda')
        c = dw_case(torch, x, w, 0.05, sw, bias, stride=stride,
                    out_scale=0.37, route='general')
        c['device_ms'] = device_ms(torch, [c['call']], DW_DEVICE_NAMES)
        print(fmt_case('depthwise_conv[general]', c)
              + f" library_agrees={c['library_agrees']}; {c['plan']}"
              + ('; x one byte off 16' if x is x_off else ''))
        need_exact(c, 'depthwise_conv')
        for kw in (dict(relu=True, out_scale=0.37), dict(),
                   dict(relu=True)):
            dw_exact(torch, x, w, 0.05, sw, bias, stride=stride,
                     route='general', **kw)


def phase_kernels(torch, factored):
    """Returns the launch term (us) the low-rank cost model is priced
    with: one quant_matmul wrapper call at the head shape."""
    g = torch.Generator(device='cuda').manual_seed(SEED)

    def f32(*shape, scale=1.0):
        return torch.rand(shape, generator=g, device='cuda') * scale

    # resnet34-cifar at 32 slots: the stem, a conv of each stage, M tails,
    # a head; mobilenetv2's K = 24; w K-major, as export_cnn stores it
    cases = [('stem', 32 * 32 * 32, 27, 64), ('stage0', 32768, 576, 64),
             ('stage1', 8192, 1152, 128), ('stage2', 2048, 2304, 256),
             ('stage3', 512, 4608, 512), ('stage3 M tail', 300, 4608, 512),
             ('stage1 M tail', 129, 1152, 128), ('K=24', 8192, 24, 144),
             ('head', 32, 512, 10)]
    launch_us = None
    for name, M, K, N in cases:
        x = rand_i8(torch, g, M, K)
        w = rand_i8(torch, g, N, K).t()          # (K, N), strides (1, K)
        sx, sw = f32(M, scale=1e-2), f32(N, scale=1e-2)
        bias = torch.randn(N, generator=g, device='cuda')
        for out_scale in (0.37, None):
            c = qmm_case(torch, x, w, sx, sw, bias, True, out_scale)
            c['device_ms'] = device_ms(torch, [c['call']], QMM_DEVICE_NAMES)
            print(fmt_case(f'quant_matmul[{name}]', c)
                  + f"; {c['plan']}")
            need_exact(c, 'quant_matmul')
            if name == 'head' and out_scale is None:
                launch_us = c['ms'] * 1e3
    print(f'[kernel] launch term (one quant_matmul wrapper call at the head '
          f'shape, the cost model\'s launch_us): {launch_us:.1f} us')
    for K in (128, 256, 512):
        w = torch.randn((K, 10), generator=g, device='cuda')
        c = fq_case(torch, w)
        c['device_ms'] = device_ms(torch, [c['call']],
                                   FQ_KERNELS['fake_quant_fused'][1])
        print(fmt_case('fake_quant_fused[head]', c) + '; ' + fq_plan(w))
        need_exact(c, 'fake_quant_fused')
    phase_fake_quant_kernels(torch, g)

    phase_depthwise_kernels(torch, g)

    shapes, ranks = lowrank_shapes(factored)
    print('[kernel] resnet34-cifar ranks at energy 0.6, min_rank 2, by '
          'stage: ' + '; '.join(f's{s}: {sorted(r)}'
                                 for s, r in sorted(ranks.items())))
    for M, K1, R, N in shapes:           # u and v K-major, as exported
        x = rand_i8(torch, g, M, K1)
        u, v = rand_i8(torch, g, R, K1).t(), rand_i8(torch, g, N, R).t()
        su, sv = f32(R, scale=1e-3), f32(N, scale=1e-2)
        bu, bv = (torch.randn(R, generator=g, device='cuda'),
                  torch.randn(N, generator=g, device='cuda'))
        kw = dict(sx=0.05, h_scale=0.9, relu=True)
        for out_scale in (None, 0.37):     # the int8 one beside the chain
            c = lr_case(torch, x, u, v, su, sv, bu, bv, out_scale=out_scale,
                        **kw)
            c['device_ms'] = device_ms(torch, [c['call']], LR_DEVICE_NAMES)
            print(fmt_case('lowrank_conv', c) + f"; {c['plan']}")
            need_exact(c, 'lowrank_conv')
        ch = lr_chained(torch, x, u, v, su, sv, bu, bv, out_scale=0.37,
                        launch_us=launch_us, **kw)
        dev = ch['device_ms']
        print(f"[kernel] lowrank_conv {(M, K1, R, N)} chained on two "
              f"quant_matmul calls: exact={ch['exact']} ms={ch['ms']:.4f} "
              f"device_ms={'not measured' if dev is None else f'{dev:.4f}'}"
              f"; the fused call above ms={c['ms']:.4f} device_ms="
              + ('not measured' if c['device_ms'] is None
                 else f"{c['device_ms']:.4f}")
              + f"; lowering_costs at launch_us={launch_us:.1f} picks "
              f"{ch['choice']} (fused {ch['fused_us']:.1f} us, chained "
              f"{ch['chained_us']:.1f} us)")
        if not ch['exact']:
            fail(f'lowrank_conv at {(M, K1, R, N)}: the chained pair '
                 f'disagrees with the fused kernel')
    # the mma.sync route, which TMA leaves to it: mobilenetv2's K1 = 24 and
    # a 3x3 conv over 8 channels (K1 % 16 != 0), and stage 2's shape on
    # patches that start one byte off 16
    for M, K1, R, N, off in ((8192, 24, 12, 144, 0), (8192, 72, 30, 40, 0),
                             (2048, 2304, 118, 256, 1)):
        x = rand_i8(torch, g, M * K1 + off)[off:].view(M, K1)
        u, v = rand_i8(torch, g, R, K1).t(), rand_i8(torch, g, N, R).t()
        su, sv = f32(R, scale=1e-3), f32(N, scale=1e-2)
        bu, bv = (torch.randn(R, generator=g, device='cuda'),
                  torch.randn(N, generator=g, device='cuda'))
        for out_scale in (None, 0.37):
            c = lr_case(torch, x, u, v, su, sv, bu, bv, out_scale=out_scale,
                        sx=0.05, h_scale=0.9, relu=True)
            c['device_ms'] = device_ms(torch, [c['call']], LR_DEVICE_NAMES)
            print(fmt_case('lowrank_conv', c) + f"; {c['plan']}"
                  + (f'; patches {off} byte off 16' if off else ''))
            need_exact(c, 'lowrank_conv')
            if c['route'] != 'mma_sync':
                fail(f"lowrank_conv at {c['shape']} took {c['route']}, "
                     f"not mma_sync")
    return launch_us


# path (f)'s fake-quant shapes: tinyllama-1.1b's MLP wo on the two-pass
# wrapper (and a ragged case, and the smallest K routed there); its other six
# projections' (K, N) on the fused kernel, in bf16 as QAT runs them
FQ_SHAPES = {'fake_quant': [((5632, 2048), 'bf16'), ((5632, 2048), 'fp32'),
                            ((5000, 1000), 'bf16'), ((5000, 1000), 'fp32'),
                            ((4160, 256), 'bf16'), ((4160, 256), 'fp32')],
             'fake_quant_fused': [((2048, 5632), 'bf16'),
                                  ((2048, 2048), 'bf16'),
                                  ((2048, 256), 'bf16'),
                                  ((2048, 2048), 'fp32'),
                                  ((100000, 10), 'fp32')]}


def fq_plan(w):
    """The launch plan of the fake-quant cluster kernel on w (both wrappers
    launch it on ``fused_plan``), for a case line."""
    K, N = w.shape
    from repro_torch.kernels.fake_quant import fused_plan
    bn, c, r, smem, staged = fused_plan(K, N, w.element_size())
    return (f'BN={bn} C={c} R={r} {-(-N // bn) * c} blocks, {smem} B '
            f"shared, {'staged' if staged else 'not staged'}")


def phase_fake_quant_kernels(torch, g):
    """Both fake-quant wrappers at path (f)'s shapes, bit for bit against
    their plain versions, with the kernels' device time."""
    dtypes = {'bf16': torch.bfloat16, 'fp32': torch.float32}
    for kernel, cases in FQ_SHAPES.items():
        for shape, dt in cases:
            w = torch.randn(shape, generator=g, device='cuda').to(dtypes[dt])
            c = fq_case(torch, w, kernel)
            c['device_ms'] = device_ms(torch, [c['call']],
                                       FQ_KERNELS[kernel][1])
            print(fmt_case(kernel, c)
                  + f" library_max_abs_err={c['library_err']:g}; "
                  + c['plan'])
            need_exact(c, kernel)


def da_inputs(torch, g, B, S, kind, valid_len, hole=False, H=32, K=4, D=64):
    """Decode-attention operands at tinyllama's head shapes: ``kind`` fp32,
    bf16 (q, k, v in that type) or int8 (bf16 q, an int8 cache with fp32
    scales from ``kv_quantize``).  Returns (args, valid)."""
    from repro_torch.models.attention import kv_quantize
    q = torch.randn((B, H, D), generator=g, device='cuda')
    k = torch.randn((B, S, K, D), generator=g, device='cuda')
    v = torch.randn((B, S, K, D), generator=g, device='cuda')
    valid = torch.arange(S, device='cuda') < valid_len
    if hole:
        valid[S // 3:S // 3 + 16] = False
    if kind == 'int8':
        kq, ks = kv_quantize(k)
        vq, vs = kv_quantize(v)
        return (q.to(torch.bfloat16), kq, vq, ks, vs), valid
    dt = torch.float32 if kind == 'fp32' else torch.bfloat16
    return (q.to(dt), k.to(dt), v.to(dt)), valid


def da_library(torch, args, valid):
    """The yardstick the port never calls: ``F.scaled_dot_product_attention
    (enable_gqa=True)`` on the same masked cache (the int8 cache
    dequantized first, inside the call)."""
    import torch.nn.functional as F
    from repro_torch.models.attention import kv_dequantize
    q = args[0]
    mask = valid[None, None, None, :]

    def call():
        if len(args) == 5:
            k = kv_dequantize(args[1], args[3], q.dtype)
            v = kv_dequantize(args[2], args[4], q.dtype)
        else:
            k, v = args[1], args[2]
        o = F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
        return o[:, :, 0, :]
    return call


def da_case(torch, args, valid, kind, iters=20):
    """Decode-attention kernel vs its plain version on one call: the error
    relative to max|plain| against DECODE_TOL, and times.  Bound: the k/v
    rows of the valid slots (and their scales), q, the mask and the output
    once at 3.35 TB/s, against 4*B*H*D flops a valid slot at the card's
    fp32 rate."""
    from repro_torch.kernels import decode_attention as da
    int8 = len(args) == 5
    fn = da.decode_attention_int8 if int8 else da.decode_attention
    plain = da.decode_attention_int8_plain if int8 else \
        da.decode_attention_plain
    got = fn(*args, valid)
    want = plain(*args, valid)
    lib = da_library(torch, args, valid)
    lib_out = lib()
    torch.cuda.synchronize()
    q = args[0]
    B, H, D = q.shape
    S, K = args[1].shape[1], args[1].shape[2]
    n_valid = int(valid.sum())
    kv_bytes = B * n_valid * K * (2 * D * args[1].element_size()
                                  + (8 if int8 else 0))
    nbytes = kv_bytes + 2 * q.numel() * q.element_size() + S
    b_ms, b_by = bound(nbytes, 4 * B * H * D * n_valid, FP32_OPS_PER_S)
    scale = float(want.float().abs().max())
    err = max_err(torch, got, want)
    call = lambda: fn(*args, valid)  # noqa: E731
    return {'shape': (B, H, K, D, S), 'kind': kind, 'n_valid': n_valid,
            'max_abs_err': err, 'rel_err': err / scale,
            'within': err <= DECODE_TOL[kind] * scale,
            'library_rel_err': max_err(torch, lib_out, want) / scale,
            'call': call, 'ms': time_ms(torch, call, iters),
            'plain_ms': time_ms(torch, lambda: plain(*args, valid), iters),
            'library_ms': time_ms(torch, lib, iters),
            'bound_ms': b_ms, 'bound_by': b_by}


def fmt_da_case(name, c):
    dev = c.get('device_ms')
    return (f"[kernel] {name} {c['kind']} (B,H,K,D,S)={c['shape']} "
            f"valid={c['n_valid']}: rel_err={c['rel_err']:.3e} (limit "
            f"{DECODE_TOL[c['kind']]:g}) ms={c['ms']:.4f}"
            + ('' if 'device_ms' not in c else ' device_ms=' + (
                'not measured' if dev is None else f'{dev:.4f}'))
            + f" plain_ms={c['plain_ms']:.4f} library_ms="
              f"{c['library_ms']:.4f} (library rel_err "
              f"{c['library_rel_err']:.2e}) bound_ms={c['bound_ms']:.5f} "
              f"({c['bound_by']})")


def need_within(c, name):
    if not c['within']:
        fail(f"{name} disagrees with its plain version at {c['shape']} "
             f"({c['kind']}): rel_err {c['rel_err']:.3e}")


def da_plan(args):
    """The split kernel's launch plan for a decode case, for its line."""
    from repro_torch.kernels.decode_attention import (group_pad, split_plan,
                                                      split_smem_bytes)
    q, k = args[0], args[1]
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    elem, G = k.element_size(), group_pad(H // K)
    c, spb, warps = split_plan(B, K, S, elem=elem, D=D, G=G)
    return (f'split C={c} slots/block={spb} warps={warps} '
            f'{K * B * c} blocks, {split_smem_bytes(warps, G, D, elem)} B '
            f'shared')


def phase_decode_kernels(torch):
    """Both decode-attention wrappers (one split kernel) against their
    plain versions at tinyllama's shapes: B 1 and 8, S 584 (the served
    cache) and 2048, a valid prefix, and a case with a hole; fp32, bf16 and
    int8-KV; the int8 cache with a prefix of 40 valid slots (blocks 1-7 of
    each cluster hold masked slots only); and an fp32 cache at head_dim
    128 (6 warps, the most its shared memory allows)."""
    g = torch.Generator(device='cuda').manual_seed(SEED + 11)
    cases = [(kind, B, S, S * 7 // 8, hole, 64)
             for kind in ('fp32', 'bf16', 'int8')
             for B, S in ((1, 584), (8, 584), (8, 2048))
             for hole in ((False, True) if (B, S) == (8, 584) else (False,))]
    cases += [('int8', 8, 584, 40, False, 64),
              ('fp32', 1, 2048, 2048 * 7 // 8, False, 128)]
    for kind, B, S, valid_len, hole, D in cases:
        args, valid = da_inputs(torch, g, B, S, kind, valid_len=valid_len,
                                hole=hole, H=32 if D == 64 else 16, D=D)
        name = 'decode_attention_int8' if kind == 'int8' else \
            'decode_attention'
        c = da_case(torch, args, valid, kind)
        c['device_ms'] = device_ms(torch, [c['call']], DA_DEVICE_NAME[name])
        print(fmt_da_case(name + ('[hole]' if hole else ''), c) + '; '
              + da_plan(args))
        need_within(c, name)


# ------------------------------------------------------------------ phase 3


def path_model(torch, spec):
    """(family, params, cfg) of one path: random weights from SEED, the
    low-rank factorization where the path asks for it, exit heads at the
    default stages, W8A8."""
    from repro_torch.configs.cnn import CNN_REGISTRY
    from repro_torch.core.family import CNNFamily
    from repro_torch.data import SyntheticImages
    fam = CNNFamily(SyntheticImages(), device='cuda')
    cfg = CNN_REGISTRY[spec['config']]
    params = fam.init(torch.Generator().manual_seed(SEED), cfg)
    if spec['factorize']:
        params, cfg, _ = fam.factorize(params, cfg, **LOWRANK)
    params, cfg = fam.add_exits(torch.Generator().manual_seed(SEED + 1),
                                params, cfg, fam.default_exit_points(cfg))
    return fam, params, cfg.replace(w_bits=8, a_bits=8)


def check_calibrations(torch, tag, params, cfg, x):
    """The card's calibration forward against the CPU's on the same batch,
    scale by scale in forward order (``compare_calibrations``).  Up to the
    first activation whose fake-quant codes differ, every scale agrees
    within SCALE_RTOL_EXACT; the codes that differ there move one step and
    lie within TIE_TOL of a rounding tie (the two devices' fp32 convs
    round their sums differently, by ulps); after it, scales agree within
    SCALE_RTOL.  Returns the readings."""
    from repro_torch.core.export import (calibration_tensors,
                                         compare_calibrations)
    c = compare_calibrations(calibration_tensors(params, cfg, x),
                             calibration_tensors(params, cfg, x.cpu()))
    cut = len(c['rel']) if c['flip'] is None else c['flip'] + 1
    before, after = max(c['rel'][:cut]), max(c['rel'][cut:], default=0.0)
    print(f"{tag} calibration, card vs CPU on {x.shape[0]} images: scales "
          f"up to the first code flip agree within {before:.3e} (limit "
          f"{SCALE_RTOL_EXACT:g})")
    if c['flip'] is None:
        print(f'{tag}   no fake-quant code differs')
    else:
        print(f"{tag}   first code flip at {c['at']}: {c['codes']} of "
              f"{c['of']} codes, by at most {c['step']:g} step, the "
              f"farthest {c['tie']:.3e} from a rounding tie (limit "
              f"{TIE_TOL:g}); the {len(c['rel']) - cut} scales after it "
              f"agree within {after:.3e} (limit {SCALE_RTOL:g})")
    if before > SCALE_RTOL_EXACT:
        fail(f'{tag}: calibration scales differ before any code flip')
    if c['flip'] is not None and (c['tie'] > TIE_TOL or c['step'] > 1):
        fail(f'{tag}: the first calibration codes that differ are not '
             f'rounding-tie flips')
    if after > SCALE_RTOL:
        fail(f'{tag}: calibration scales disagree after the first code '
             f'flip ({after:.3e})')
    return dict(c, before=before, after=after)


def share_scales(src, dst):
    """Give layer plan ``dst`` the static scales of ``src`` (same model)."""
    for name, e in src.layers.items():
        for key in ('sx', 'out_scale', 'h_scale'):
            if key in e:
                dst.layers[name][key] = e[key]
    dst.glues.update(src.glues)


def print_model_selection(model, launch_us):
    """What ``select_kernels='model'`` would pick for each factored conv:
    the export's own selection, priced with the launch term measured in
    phase 2."""
    from repro_torch.core.export import _select_lowering
    picks = {'fused': 0, 'chained': 0}
    for name, e in model.plan.layers.items():
        if not (e['kind'] == 'conv' and e['factored']):
            continue
        B, _, _, C = e['in_shape']
        _, oh, ow, n = e['out_shape']
        kh, kw = e['kernel']
        m, k1 = B * oh * ow, kh * kw * C
        sel = _select_lowering(m, k1, e['rank'], n, fuse_lowrank=True,
                               select_kernels='model', launch_us=launch_us)
        picks[sel['choice']] += 1
        print(f"[plan]   {name}: rank {e['rank']} (M={m}, K1={k1}, N={n}) "
              f"served {'fused' if e['fused'] else 'chained'}; 'model' "
              f"would pick {sel['choice']} ({sel['why']})")
    print(f"[plan] 'model' selection at launch_us={launch_us:.1f}: {picks}")


def layer_routes(model, name, e):
    """``{'kernel/route': launches}`` one plan entry makes a batch, by the
    operand rule: TMA + ``wgmma`` where K (K1 for a fused pair) % 16 == 0,
    ``mma.sync`` else (the export's operands are 16-byte aligned)."""
    from repro_torch.core.export import _resolve_layer_params
    if e.get('depthwise'):
        return {}
    p = _resolve_layer_params(model.params, name)

    def route(w_q):
        return 'wgmma' if (w_q.numel() // w_q.shape[-1]) % 16 == 0 \
            else 'mma_sync'
    if e.get('fused'):
        return {f"lowrank_conv/{route(p['u']['w_q'])}": 1}
    out = {}
    for half in ((p['u'], p['v']) if e['factored'] else (p,)):
        k = f"quant_matmul/{route(half['w_q'])}"
        out[k] = out.get(k, 0) + 1
    return out


def add_routes(store, key, routes):
    """Add one serving run's launches by route to ``store[key]``."""
    acc = store.setdefault(key, {'launches_by_route': {}})
    for r, n in routes.items():
        acc['launches_by_route'][r] = acc['launches_by_route'].get(r, 0) + n


def serve_trace(torch, tag, spec, model, xs, t_arr, threshold, label):
    """Serve the Poisson trace of ``xs`` once at ``threshold`` and hold the
    run to the plan: each kernel's launches, the launches by route against
    the operand rule, no weight relayout, no plain-version call, and the
    sampled requests bit-exact against ``fn_exits`` on the request alone.
    ``label`` names the threshold in the printed lines.  Returns the
    completions, how many left at an exit head, and each kernel's launches
    in the scheduler's run (the oracle's are not counted)."""
    import numpy as np
    from repro_torch.core.export import _layer_segments
    from repro_torch.kernels import counts
    from repro_torch.kernels.depthwise_conv import depthwise_conv
    from repro_torch.kernels.lowrank_conv import lowrank_conv
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                     exit_decisions)

    tag = f'{tag}[{label} {threshold:.6f}]'
    before = counts()
    routes0 = dict(quant_matmul.launches_by_route)
    lr_routes0 = dict(lowrank_conv.launches_by_route)
    dw_routes0 = dict(depthwise_conv.launches_by_route)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sched = ContinuousBatchScheduler(model, slots=SLOTS, threshold=threshold,
                                     max_wait=0.05)
    reqs = [Request(i, xs[i], float(t_arr[i])) for i in range(N_REQUESTS)]
    t0 = time.perf_counter()
    completions, metrics = sched.run_trace(reqs)
    t_serve = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    after = counts()
    routes = {r: n - routes0[r]
              for r, n in quant_matmul.launches_by_route.items()}
    lr_routes = {r: n - lr_routes0[r]
                 for r, n in lowrank_conv.launches_by_route.items()}
    dw_routes = {r: n - dw_routes0[r]
                 for r, n in depthwise_conv.launches_by_route.items()}

    m = metrics.summary()
    print(f"{tag} served {m['n_requests']} of {N_REQUESTS} requests "
          f"(Poisson {RATE:.0f}/s, {sched.slots} slots) in {t_serve:.3f} s "
          f"wall: throughput {m['throughput_rps']} req/s, p50 "
          f"{m['p50_latency_s'] * 1e3:.3f} ms, p99 "
          f"{m['p99_latency_s'] * 1e3:.3f} ms, exit mix {m['exit_mix']}, "
          f"batches {m['n_batches']}, occupancy {m['batch_occupancy']}, "
          f"peak memory {peak / 2 ** 20:.1f} MiB, "
          f"{(peak - base) / 2 ** 20:.1f} MiB of it above what was "
          f"allocated when serving began")
    print(f"{tag} execute p50 {m['p50_execute_s'] * 1e3:.3f} ms p99 "
          f"{m['p99_execute_s'] * 1e3:.3f} ms | queue-wait p50 "
          f"{m['p50_queue_wait_s'] * 1e3:.3f} ms p99 "
          f"{m['p99_queue_wait_s'] * 1e3:.3f} ms")
    if len(completions) != N_REQUESTS:
        fail(f'{spec["key"]}: {N_REQUESTS - len(completions)} requests '
             f'never completed')
    plain = sum(after[k]['plain_calls'] - before[k]['plain_calls']
                for k in after)
    for name in after:
        want = sum(model.segment_launches[k].get(name, 0)
                   for k, _, _ in metrics.batches)
        got = after[name]['launches'] - before[name]['launches']
        print(f'{tag} {name} launches while serving: {got} (plan: {want} '
              f'over {len(metrics.batches)} segment batches)')
        if got != want:
            fail(f'{spec["key"]}: serving launched {name} {got} times, the '
                 f'plan says {want}')
    relaid = quant_matmul.weight_relayouts
    add_routes(QMM_ROUTES, spec['key'], routes)
    QMM_ROUTES[spec['key']]['weight_relayouts'] = relaid
    print(f'{tag} quant_matmul launches by route while serving: {routes}; '
          f'weight relayouts since export: {relaid}')
    if relaid:
        fail(f"{spec['key']}: quant_matmul relaid {relaid} weights: the "
             f'export must store them K-major')
    lr_relaid = lowrank_conv.weight_relayouts
    add_routes(LR_ROUTES, spec['key'], lr_routes)
    LR_ROUTES[spec['key']]['weight_relayouts'] = lr_relaid
    print(f'{tag} lowrank_conv launches by route while serving: '
          f'{lr_routes}; weight relayouts since export: {lr_relaid}')
    if lr_relaid:
        fail(f"{spec['key']}: lowrank_conv relaid {lr_relaid} factors: the "
             f'export stores them K-major')
    # the routes by the operand rule, each layer times the batches its
    # segment ran
    segment = _layer_segments(model.plan, model.cfg, model.stage_exits)
    ran = {}
    for k, _, _ in metrics.batches:
        ran[k] = ran.get(k, 0) + 1
    want_routes = {}
    for name, e in model.plan.layers.items():
        for r, n in layer_routes(model, name, e).items():
            want_routes[r] = want_routes.get(r, 0) + \
                n * ran.get(segment[name], 0)
    want_routes = {r: n for r, n in want_routes.items() if n}
    got_routes = {f'{kern}/{r}': n for kern, rs in
                  (('quant_matmul', routes), ('lowrank_conv', lr_routes))
                  for r, n in rs.items() if n}
    print(f'{tag} launches by route while serving: {got_routes}; by the '
          f'operand rule (wgmma where K % 16 == 0): {want_routes}')
    if got_routes != want_routes:
        fail(f"{spec['key']}: the launches by route {got_routes} are not "
             f'those of the operand rule {want_routes}')
    add_routes(DW_ROUTES, spec['key'], dw_routes)
    print(f'{tag} depthwise_conv launches by route while serving: '
          f'{dw_routes}')
    if dw_routes['general']:
        fail(f"{spec['key']}: depthwise_conv took the general route "
             f"{dw_routes['general']} times: every mobilenetv2-cifar layer "
             f'fits the tile route')
    print(f'{tag} plain-version calls while serving: {plain}')
    if plain:
        fail(f'{spec["key"]}: the plain versions ran {plain} times while '
             f'serving')

    # the scheduler's contract: each request alone through fn_exits
    for rid in np.linspace(0, N_REQUESTS - 1, N_ORACLE).astype(int):
        x = xs[rid][None]
        xb = torch.cat([x, torch.zeros((SLOTS - 1,) + tuple(x.shape[1:]),
                                       device=x.device)])
        logits, exits = model.fn_exits(model.params, xb)
        stage, ans = exit_decisions(logits, exits, threshold)
        c = completions[int(rid)]
        if int(stage[0]) != c.exit_stage or \
                not np.array_equal(ans[0].view(np.int32),
                                   c.logits.view(np.int32)):
            fail(f'{spec["key"]}: request {rid} differs from the '
                 f'monolithic fn_exits oracle')
    early = sum(c.exit_stage != -1 for c in completions.values())
    served = {k: after[k]['launches'] - before[k]['launches'] for k in after}
    print(f'{tag} {N_ORACLE} sampled requests bit-exact against fn_exits '
          f'on the request alone at {SLOTS} slots; {early} of '
          f'{len(completions)} requests left at an exit head')
    seg_ms = {}
    for _, k, _, _, cost in metrics.batch_samples:
        seg_ms.setdefault(k, []).append(cost * 1e3)
    print(f'{tag} execute ms per segment batch (mean of n): ' + ', '.join(
        f'seg{k} {sum(v) / len(v):.3f} (n={len(v)})'
        for k, v in sorted(seg_ms.items())))
    return completions, early, served


def serve_path(torch, spec, launch_us, built=None):
    """Export and serve one CNN path, counted from zero.  ``built`` is
    (family, params, cfg, export) of a model made elsewhere, ``export``
    taking the calibration images to the served model (path g's chain
    through ``export_chain``); else ``path_model`` makes the model and
    ``export_cnn`` exports it.  The trace is served at the exit threshold
    calibrated on those images, where some requests must leave at an exit
    head; where ``spec['own_threshold']`` is set, it is served first at the
    model's own operating point (the chain's E threshold), which the
    profiled run then uses."""
    import numpy as np
    from repro_torch.core.export import calibrate_exit_threshold, export_cnn
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.serving import ContinuousBatchScheduler, Request

    tag = f"[serve:{spec['key']}]"
    select = 'fused' if spec['factorize'] else 'model'
    if built is None:
        fam, params, cfg = path_model(torch, spec)

        def export(calib):
            return export_cnn(params, cfg, device='cuda', calibrate=calib,
                              select_kernels=select)
    else:
        fam, params, cfg, export = built
    stream = fam.eval_batches(N_REQUESTS // 64 + 1, 64)
    xs = torch.cat([x for x, _ in stream])
    calib, xs = xs[:SLOTS], xs[SLOTS:SLOTS + N_REQUESTS]
    rng = np.random.default_rng(SEED)
    t_arr = np.cumsum(rng.exponential(1.0 / RATE, size=N_REQUESTS))
    torch.cuda.synchronize()

    # ---- the path, counted from zero
    reset_counts()
    t0 = time.perf_counter()
    model = export(calib)
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    s = model.summary()
    print(f"{tag} {cfg.name} exported in {t_export:.2f} s "
          f"(select_kernels={select}): {s['n_layers']} layers, "
          f"{s['kernel_launches']} launches (+{s['exit_head_launches']} exit "
          f"heads), {s['n_depthwise']} depthwise, {s['n_fused_lowrank']} "
          f"fused low-rank, {s['n_chained_lowrank']} chained low-rank, "
          f"{s['total_macs'] / 1e6:.1f} MMACs/image, exit stages "
          f"{cfg.exit_stages}")
    print(f'{tag} launches per segment {list(model.segment_launches)}')
    if s['n_fused_lowrank'] + s['n_chained_lowrank']:
        print_model_selection(model, launch_us)
    if spec['factorize']:
        if s['n_fused_lowrank'] == 0 or s['n_chained_lowrank'] == 0:
            fail(f"{spec['key']}: the plan needs a fused and a chained "
                 f"layer, has {s['n_fused_lowrank']} and "
                 f"{s['n_chained_lowrank']}")
    thresholds = [('calibrated', calibrate_exit_threshold(model, calib))]
    if spec.get('own_threshold'):
        thresholds.insert(0, ('own', model.exit_threshold))
    print(f'{tag} exit thresholds: ' + ', '.join(
        f'{label} {t:.6f}' for label, t in thresholds))
    ContinuousBatchScheduler(model, slots=SLOTS, threshold=2.0).run_trace(
        [Request(-1 - i, xs[i], 0.0) for i in range(4)])     # warm-up
    # the path's launches: the export, the warm-up and each serving run
    launches = {k: v['launches'] for k, v in counts().items()}
    for label, threshold in thresholds:
        _, early, served = serve_trace(torch, tag, spec, model, xs, t_arr,
                                       threshold, label)
        for k, n in served.items():
            launches[k] += n
        if label == 'calibrated' and not early:
            fail(f"{spec['key']}: no request left at an exit head at the "
                 f'calibrated threshold {threshold:.6f}')
    for name in spec['kernels']:
        if launches[name] == 0:
            fail(f'{spec["key"]}: {name} was never launched on this path')


    # where the time goes: the first run's trace again under the profiler
    threshold = thresholds[0][1]

    def serve_again():
        ContinuousBatchScheduler(model, slots=SLOTS, threshold=threshold,
                                 max_wait=0.05).run_trace(
            [Request(i, xs[i], float(t_arr[i])) for i in range(N_REQUESTS)])
    wall, busy, top = profile_device(torch, serve_again)
    if busy is None:
        print(f'{tag} profile: serving wall {wall:.3f} ms; device time not '
              f'measured (the profiler recorded no device activity)')
    else:
        print(f'{tag} profile: serving wall {wall:.3f} ms, device kernels '
              f'{busy:.3f} ms: device busy {busy / wall:.1%}, idle '
              f'{1 - busy / wall:.1%} (profiled run)')
        for ms, n, name in top[:8]:
            print(f'{tag}   {ms:9.3f} ms  {n:6d} x  {name[:90]}')

    # the card's calibration against the CPU's, then the served logits
    # against the port's plain CPU path on a small batch.  A fake-quant
    # code that flips at a rounding tie in calibration moves every later
    # abs-max scale (check_calibrations shows where), so the CPU model
    # serves on the card's scales and the two then run the same int8 math
    # (the own-scale difference is printed beside it).
    calib_cmp = check_calibrations(torch, tag, params, cfg, calib)
    small = calib[:4]
    gpu = export_cnn(params, cfg, device='cuda', calibrate=small,
                     select_kernels=select)
    cpu = export_cnn(params, cfg, device='cpu', calibrate=small.cpu(),
                     select_kernels=select)
    lg_gpu = gpu.serve(small).cpu()
    own = float((lg_gpu - cpu.serve(small.cpu())).abs().max())
    share_scales(gpu.plan, cpu.plan)
    lg_cpu = cpu.serve(small.cpu())
    if tuple(lg_gpu.shape) != (4, cfg.num_classes) or \
            not bool(torch.isfinite(lg_gpu).all()):
        fail(f'{spec["key"]}: served logits malformed: shape '
             f'{tuple(lg_gpu.shape)}')
    scale = max(float(lg_cpu.abs().max()), 1.0)
    diff = float((lg_gpu - lg_cpu).abs().max())
    print(f'{tag} card vs CPU plain path on 4 images, same static scales: '
          f'max |diff| {diff:.3e} (max |logit| {scale:.3e}, tolerance 4e-2 '
          f'x that); each calibrated on its own device: {own:.3e}')
    if diff > 4e-2 * scale:
        fail(f'{spec["key"]}: served logits disagree with the CPU plain '
             f'path')
    return model, params, launches, calib_cmp


def clone_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


@contextlib.contextmanager
def plain_decode_attention():
    """Serve with the decode kernels' plain versions in place of the
    kernels (models/attention.py calls them through kernels.ops); for the
    comparison only, never on a counted path."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    saved = ops.decode_attention, ops.decode_attention_int8
    ops.decode_attention = da.decode_attention_plain
    ops.decode_attention_int8 = da.decode_attention_int8_plain
    try:
        yield
    finally:
        ops.decode_attention, ops.decode_attention_int8 = saved


def check_lm_against_cpu(torch, tag, spec):
    """A 2-layer cut of the full-width config in fp32 (weights from the same
    CUDA generator, int8-exported on the card for path e) against the port's
    CPU path on the same weights: prefill and LM_CUT['tokens'] decode steps,
    both fed the CPU's greedy tokens, every step's logits within LM_CPU_TOL
    x max|logit|, TF32 off."""
    from repro_torch.configs import get_config
    from repro_torch.core.export import to_device
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.launch import serve
    cfg = get_config(LM_ARCH).replace(num_layers=LM_CUT['layers'],
                                      dtype='float32',
                                      kv_cache_bits=spec['kv_cache_bits'])
    model, params = serve.build(cfg, 'cuda', seed=SEED,
                                int8_weights=spec['int8_weights'])
    prompt = SyntheticTokens(vocab=cfg.vocab_size).batch(
        torch.Generator().manual_seed(SEED + 2), LM_CUT['batch'],
        LM_CUT['prompt'])['tokens']
    max_len = LM_CUT['prompt'] + LM_CUT['tokens'] + 8
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        feed = None
        for dev, p in (('cpu', to_device(params, 'cpu')), ('cuda', params)):
            reset_counts()
            with torch.inference_mode():
                logits, cache = model.prefill(p, {'tokens': prompt.to(dev)},
                                              max_len=max_len)
                out = [logits.cpu()]
                tok = torch.zeros((LM_CUT['batch'],), dtype=torch.int64,
                                  device=dev)
                for t in range(LM_CUT['tokens']):
                    if feed is not None:
                        tok = feed[t].to(dev)
                    logits, cache = model.decode_step(
                        p, tok, LM_CUT['prompt'] + t, cache)
                    out.append(logits.cpu())
                    tok = torch.argmax(logits, -1)
            runs[dev] = (out, counts()[spec['kernel']])
            if feed is None:
                feed = [torch.zeros(LM_CUT['batch'], dtype=torch.int64)] + \
                    [torch.argmax(lg, -1) for lg in out[1:-1]]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    n_steps = LM_CUT['tokens']
    if runs['cuda'][1] != {'launches': LM_CUT['layers'] * n_steps,
                           'plain_calls': 0} or \
            runs['cpu'][1] != {'launches': 0,
                               'plain_calls': LM_CUT['layers'] * n_steps}:
        fail(f"{spec['key']}: the 2-layer cut ran {runs['cuda'][1]} on the "
             f"card and {runs['cpu'][1]} on the CPU")
    worst = 0.0
    for a, b in zip(runs['cuda'][0], runs['cpu'][0]):
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
    print(f"{tag} 2-layer fp32 cut (batch {LM_CUT['batch']}, prompt "
          f"{LM_CUT['prompt']}, {n_steps} decode steps), card vs CPU plain "
          f"path: max |diff| / max |logit| over prefill and every step "
          f"{worst:.3e} (limit {LM_CPU_TOL:g})")
    if worst > LM_CPU_TOL:
        fail(f"{spec['key']}: the card disagrees with the CPU on the 2-layer "
             f"cut")
    return worst


def serve_lm_path(torch, spec):
    """Path (d) or (e): tinyllama-1.1b at full width and depth through the
    functions launch/serve.py uses, counted from zero.  Returns (the
    launches of every kernel in the counted run, the 22 decode-attention
    calls of one more step for phase 4, readings)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models.model import param_count

    tag = f"[serve:{spec['key']}]"
    cfg = get_config(LM_ARCH).replace(kv_cache_bits=spec['kv_cache_bits'])
    t0 = time.perf_counter()
    model, params = serve.build(cfg, 'cuda', seed=SEED,
                                int8_weights=spec['int8_weights'])
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(params))
    print(f"{tag} {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {param_count(params) / 1e9:.3f} G parameters, "
          f"{weight_bytes / 1e9:.3f} GB of weights "
          f"({'int8 export_lm' if spec['int8_weights'] else 'bf16'}), "
          f"kv_cache_bits {cfg.kv_cache_bits}; built in "
          f"{time.perf_counter() - t0:.2f} s")
    prompt = SyntheticTokens(vocab=cfg.vocab_size).batch(
        torch.Generator().manual_seed(SEED + 1), LM_BATCH, LM_PROMPT,
        'cuda')['tokens']
    max_len = LM_PROMPT + LM_TOKENS + 8
    zeros = torch.zeros((LM_BATCH,), dtype=torch.int64, device='cuda')
    # warm-up (cuBLAS handles and plans, the allocator): a prefill and two
    # steps on a cache of their own, before the count starts
    _, warm = serve.prefill_step(model, params, prompt, max_len=max_len)
    serve.decode(model, params, warm, zeros, pos0=LM_PROMPT, tokens=2)
    del warm
    torch.cuda.synchronize()

    # ---- the path, counted from zero
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    _, cache = serve.prefill_step(model, params, prompt, max_len=max_len)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = serve.decode(model, params, cache, zeros, pos0=LM_PROMPT,
                        tokens=LM_TOKENS)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    after = counts()
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(cache))
    print(f"{tag} prefill of {LM_BATCH} x {LM_PROMPT} tokens "
          f"{t_prefill * 1e3:.3f} ms; {LM_TOKENS} greedy decode steps "
          f"{t_decode * 1e3:.3f} ms: {t_decode / LM_TOKENS * 1e3:.3f} "
          f"ms/token, {LM_BATCH * LM_TOKENS / t_decode:.1f} tokens/s at "
          f"batch {LM_BATCH}; cache {cache_bytes / 2 ** 20:.1f} MiB "
          f"({max_len} slots); peak memory {peak / 2 ** 20:.1f} MiB, "
          f"{(peak - base) / 2 ** 20:.1f} MiB above the weights")
    if tuple(toks.shape) != (LM_TOKENS, LM_BATCH) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{spec['key']}: the decoded tokens are malformed")
    want = cfg.num_layers * LM_TOKENS
    for name in (spec['kernel'], spec['other']):
        print(f"{tag} {name}: {after[name]['launches']} launches, "
              f"{after[name]['plain_calls']} plain calls")
    if after[spec['kernel']]['launches'] != want:
        fail(f"{spec['key']}: {spec['kernel']} launched "
             f"{after[spec['kernel']]['launches']} times, want {want} "
             f"({cfg.num_layers} layers x {LM_TOKENS} steps)")
    if after[spec['other']]['launches']:
        fail(f"{spec['key']}: {spec['other']} ran on this path")
    plain = sum(c['plain_calls'] for c in after.values())
    if plain:
        fail(f"{spec['key']}: the plain versions ran {plain} times")

    # where the time goes: the cache's spare slots, under the profiler
    def more_steps():
        serve.decode(model, params, cache, zeros,
                     pos0=LM_PROMPT + LM_TOKENS, tokens=LM_PROFILE_STEPS)
    wall, busy, top = profile_device(torch, more_steps)
    if busy is None:
        print(f'{tag} profile: {LM_PROFILE_STEPS} steps in {wall:.3f} ms '
              f'wall; device time not measured (the profiler recorded no '
              f'device activity)')
    else:
        kern = sum(ms for ms, _, name in top
                   if DA_DEVICE_NAME[spec['kernel']] in name)
        print(f'{tag} profile: {LM_PROFILE_STEPS} decode steps in '
              f'{wall:.3f} ms wall ({wall / LM_PROFILE_STEPS:.3f} ms/token '
              f'profiled), device kernels {busy:.3f} ms: device busy '
              f'{busy / wall:.1%}; the decode-attention kernel {kern:.3f} '
              f'ms, {kern / busy:.1%} of device time')
        for ms, n, name in top[:8]:
            print(f'{tag}   {ms:9.3f} ms  {n:6d} x  {name[:90]}')

    # the first step's logits against the same model served with the
    # plain decode attention on the card (the kernels' plain versions in
    # their place), and beside it the reference's decode math
    _, fresh = serve.prefill_step(model, params, prompt, max_len=max_len)
    twins = [clone_tree(fresh), clone_tree(fresh)]
    with torch.inference_mode():
        lg_k, _ = model.decode_step(params, zeros, LM_PROMPT, fresh)
        with plain_decode_attention():
            lg_p, _ = model.decode_step(params, zeros, LM_PROMPT, twins[0])
        lg_r, _ = model.decode_step(
            params, zeros, LM_PROMPT, twins[1],
            ctx={'decode_attn': attn.decode_attn_reference})
    del twins
    if tuple(lg_k.shape) != (LM_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(lg_k).all()):
        fail(f"{spec['key']}: first-step logits malformed")
    scale = float(lg_p.float().abs().max())
    diff = max_err(torch, lg_k, lg_p)
    agree = float((lg_k.argmax(-1) == lg_p.argmax(-1)).float().mean())
    print(f'{tag} first-step logits, decode kernel vs the plain decode '
          f'attention on the card: max |diff| {diff:.3e} (max |logit| '
          f'{scale:.3e}, limit {LM_PLAIN_TOL:g} x that); greedy tokens agree '
          f'on {agree:.0%} of the batch; against decode_attn_reference '
          f'(q scaled in bf16, bf16 probabilities): max |diff| '
          f'{max_err(torch, lg_k, lg_r):.3e}')
    if diff > LM_PLAIN_TOL * scale:
        fail(f"{spec['key']}: the kernel path disagrees with the plain "
             f"decode attention")

    # every decode-attention call of one more step, for phase 4
    calls = []

    def capture(q, nk, nv, c, cur, **kw):
        out, c = attn.decode_attn_kernel(q, nk, nv, c, cur, **kw)
        calls.append((q, c, attn._valid(c['meta']['pos'], int(cur), 0)))
        return out, c
    with torch.inference_mode():
        model.decode_step(params, zeros, LM_PROMPT + 1, fresh,
                          ctx={'decode_attn': capture})
    cpu_err = check_lm_against_cpu(torch, tag, spec)
    return {k: v['launches'] for k, v in after.items()}, calls, {
        'prefill_ms': t_prefill * 1e3,
        'ms_per_token': t_decode / LM_TOKENS * 1e3,
        'tokens_per_s': LM_BATCH * LM_TOKENS / t_decode,
        'peak_mib': peak / 2 ** 20, 'plain_diff': diff, 'cpu_err': cpu_err}



def recording_family(losses, cfg, device):
    """An LMFamily whose loss appends each step's loss (a device tensor,
    read after the run) to ``losses``."""
    from repro_torch.core.family import LMFamily
    from repro_torch.data import SyntheticTokens

    class Recording(LMFamily):
        def loss(self, params, cfg, batch):
            ce, lg = super().loss(params, cfg, batch)
            losses.append(ce.detach())
            return ce, lg
    return Recording(SyntheticTokens(vocab=cfg.vocab_size), seq=QAT_SEQ,
                     device=device)


def check_qat_against_cpu(torch, tag):
    """A 2-layer cut of the full-width config in fp32 (weights from a CUDA
    generator seeded SEED): one Q-pass step from the same params and batch
    on the card (the fake-quant kernels) and on the CPU (the reference's
    CPU path, plain tensor ops), TF32 off, at each of QAT_CUTS' hps."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config(LM_ARCH).replace(num_layers=2, dtype='float32')
    params = tfm.init_lm(torch.Generator(device='cuda').manual_seed(SEED),
                         cfg, 'cuda')
    return qat_step_against_cpu(torch, tag, QAT_KEY, cfg, params,
                                QAT_PER_LAYER, QAT_CUTS)


def qat_step_against_cpu(torch, tag, key, cfg, params, per_layer, cuts):
    """One Q-pass step of ``params`` (on the card) from the same params and
    batch on the card (the fake-quant kernels, ``per_layer`` launches of
    each wrapper a layer) and on the CPU (plain tensor ops), TF32 off, at
    each ``(hp, loss rtol, max_lr, share)`` of ``cuts``."""
    from repro_torch.core import registry
    from repro_torch.core.export import to_device
    from repro_torch.core.passes import ChainState, Trainer
    from repro_torch.kernels import counts, reset_counts
    tr = Trainer(batch=QAT_CUT_BATCH, steps=1, lr=QAT_LR, seed=SEED)
    lr = QAT_LR / 10
    out = []
    for hp, loss_rtol, max_lr, share in cuts:
        runs = {}
        for dev, p in (('cpu', to_device(params, 'cpu')),
                       ('cuda', params)):
            losses = []
            st = ChainState(family=recording_family(losses, cfg, dev),
                            cfg=cfg, params=p, key=SEED)
            reset_counts()
            t0 = time.perf_counter()
            new = registry.get_pass('Q').apply(st, hp, tr)
            runs[dev] = (float(losses[0]),
                         _leaves(to_device(new.params, 'cpu')), counts(),
                         time.perf_counter() - t0)
        want = {k: n * cfg.num_layers for k, n in per_layer.items()}
        got = {k: runs['cuda'][2][k]['launches'] for k in want}
        plain = sum(c['plain_calls'] for r in runs.values()
                    for c in r[2].values())
        if got != want or plain or any(c['launches'] for c in
                                       runs['cpu'][2].values()):
            fail(f'{key}: the 2-layer cut launched {got} on the card '
                 f'(want {want}), the plain versions ran {plain} times')
        l_cpu, l_gpu = runs['cpu'][0], runs['cuda'][0]
        worst, near, n = 0.0, 0, 0
        for a, b in zip(runs['cuda'][1], runs['cpu'][1]):
            d = (a - b).abs()
            worst = max(worst, float(d.max()))
            near += int((d > QAT_NEAR_LR * lr).sum())
            n += d.numel()
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        print(f'{tag} 2-layer fp32 cut, one Q-pass step at {hp} (batch '
              f'{QAT_CUT_BATCH} x {QAT_SEQ}), card vs CPU: loss '
              f'{l_gpu:.7f} vs {l_cpu:.7f} (|diff| {rel:.3e} x |loss|, '
              f'limit {loss_rtol:g}); new params max |diff| '
              f'{worst / lr:.3e} x lr (limit {max_lr:g}), {near} of {n} '
              f'elements ({near / n:.3e}) more than {QAT_NEAR_LR:g} x lr '
              f'apart (limit {share:g}); the step took '
              f'{runs["cuda"][3]:.3f} s on the card, '
              f'{runs["cpu"][3]:.3f} s on the CPU')
        if not rel <= loss_rtol:
            fail(f"{key}: at {hp} the card's loss disagrees with the "
                 f"CPU's")
        if not (worst <= max_lr * lr and near <= share * n):
            fail(f"{key}: at {hp} the card's updated params disagree "
                 f"with the CPU's")
        out.append({'hp': hp, 'loss_rel': rel, 'max_lr': worst / lr,
                    'near_share': near / n})
    return out


def train_lm_path(torch):
    """Path (f): the Q pass on tinyllama-1.1b at full width and depth,
    through the functions a chain calls (``init_chain_state``, the
    registry's Q, ``ChainState.metrics``), counted from zero.  Returns (the
    launches of every kernel in the counted run, every fake-quant call of
    one more step for phase 4 as (wrapper, weight), readings)."""
    from repro_torch.configs import get_config
    from repro_torch.core import registry
    from repro_torch.core.passes import Trainer, init_chain_state
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.models.model import param_count

    tag = f'[train:{QAT_KEY}]'
    cfg = get_config(LM_ARCH)
    losses = []
    fam = recording_family(losses, cfg, 'cuda')
    tr = Trainer(batch=QAT_BATCH, steps=QAT_STEPS, lr=QAT_LR, eval_n=1,
                 eval_batch=QAT_BATCH, seed=SEED)
    t0 = time.perf_counter()
    st = init_chain_state(fam, cfg, SEED, tr, pretrain_steps=0)
    torch.cuda.synchronize()
    print(f'{tag} {cfg.name}: {cfg.num_layers} layers, d_model '
          f'{cfg.d_model}, {param_count(st.params) / 1e9:.3f} G parameters '
          f'({cfg.dtype}); built and evaluated in '
          f'{time.perf_counter() - t0:.2f} s; baseline {st.history[0]}')
    qcfg = cfg.replace(**QAT_HP)
    # warm-up (cuBLAS handles and plans, the kernel libraries, the
    # allocator): one Q step on a clone of the params
    tr.fit(fam, qcfg, clone_tree(st.params), lr=tr.lr / 10, steps=1)
    torch.cuda.synchronize()
    losses.clear()

    # ---- the path, counted from zero
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new = registry.get_pass('Q').apply(st, QAT_HP, tr)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    after = counts()
    peak = torch.cuda.max_memory_allocated()
    loss = [float(v) for v in losses]
    tokens = QAT_STEPS * QAT_BATCH * QAT_SEQ
    print(f'{tag} Q pass ({QAT_HP}, lr {tr.lr / 10:g}, weight decay '
          f'{tr.weight_decay:g}): {QAT_STEPS} steps of {QAT_BATCH} x '
          f'{QAT_SEQ} tokens in {t_train * 1e3:.3f} ms: '
          f'{t_train / QAT_STEPS * 1e3:.3f} ms/step, {tokens / t_train:.1f} '
          f'tokens/s; peak memory {peak / 2 ** 20:.1f} MiB')
    print(f'{tag} loss by step: ' + ', '.join(f'{v:.5f}' for v in loss))
    if len(loss) != QAT_STEPS or not all(math.isfinite(v) for v in loss):
        fail(f'{QAT_KEY}: the losses are not {QAT_STEPS} finite values')
    changed = sum(int((a != b).sum()) for a, b in
                  zip(_leaves(new.params), _leaves(st.params)))
    print(f'{tag} {changed} of {param_count(st.params)} parameters changed')
    if not changed:
        fail(f'{QAT_KEY}: the Q pass left the parameters as they were')
    for name in after:
        want = QAT_PER_LAYER.get(name, 0) * cfg.num_layers * QAT_STEPS
        print(f"{tag} {name}: {after[name]['launches']} launches (want "
              f"{want}), {after[name]['plain_calls']} plain calls")
        if after[name]['launches'] != want or after[name]['plain_calls']:
            fail(f"{QAT_KEY}: {name} launched {after[name]['launches']} "
                 f"times, want {want} ({cfg.num_layers} layers x "
                 f"{QAT_STEPS} steps), or its plain version ran")
    rec = new.metrics(tr, 'Q')
    print(f'{tag} Q history record: {rec}')
    if rec['BitOpsCR'] != 16.0 or rec['CR'] != 4.0 or \
            not 0.0 <= rec['acc'] <= 1.0:
        fail(f'{QAT_KEY}: the Q record is not W8A8 over fp32 (BitOpsCR '
             f'16, CR 4): {rec}')

    # where the time goes: one more step under the profiler
    opt = tr.optimizer(tr.lr / 10)
    opt_state = opt.init(new.params)
    batch = fam.train_batch(torch.Generator().manual_seed(SEED + 3),
                            QAT_BATCH)

    def one_step():
        tr.train_step(opt, fam.loss, qcfg, new.params, opt_state, batch)
    wall, busy, top = profile_device(torch, one_step)
    if busy is None:
        print(f'{tag} profile: one step in {wall:.3f} ms wall; device time '
              f'not measured (the profiler recorded no device activity)')
    else:
        names = [m for _, ms_ in FQ_KERNELS.values() for m in ms_]
        fq = sum(ms for ms, _, name in top if any(m in name for m in names))
        print(f'{tag} profile: one step in {wall:.3f} ms wall, device '
              f'kernels {busy:.3f} ms: device busy {busy / wall:.1%}; the '
              f'fake-quant kernels {fq:.3f} ms, {fq / busy:.1%} of device '
              f'time')
        for ms, n, name in top[:12]:
            print(f'{tag}   {ms:9.3f} ms  {n:6d} x  {name[:90]}')

    # every fake-quant call of one more step, for phase 4
    calls = capture_fake_quants(torch, one_step)
    del opt_state
    cut = check_qat_against_cpu(torch, tag)
    return {k: v['launches'] for k, v in after.items()}, calls, {
        'ms_per_step': t_train / QAT_STEPS * 1e3,
        'tokens_per_s': tokens / t_train, 'peak_mib': peak / 2 ** 20,
        'losses': loss, 'record': rec, 'cut': cut}


def tree_bits_equal(torch, a, b):
    """Two trees of tensors, leaf for leaf, bit for bit (on the CPU)."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        same_bits(torch, x.detach().cpu(), y.detach().cpu())
        for x, y in zip(la, lb))


def factored_ranks(params):
    """``{path: rank}`` of every low-rank pair of a CNN tree."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            if 'u' in t and 'v' in t:
                out[path] = int(t['u']['w'].shape[-1])
                return
            for k, v in t.items():
                walk(v, f'{path}.{k}' if path else k)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f'{path}.{i}')
    walk(params, '')
    return out


def prune_gap(torch, params, ratio):
    """The smallest relative gap, over the pruned convs, between the last
    channel P keeps and the first it drops (float64 L2 importance)."""
    gaps = []
    for blocks in params['stages']:
        for blk in blocks:
            w = blk['conv1']['w'].detach().cpu().to(torch.float64)
            imp = torch.sort(torch.sqrt((w * w).sum((0, 1, 2))),
                             descending=True).values
            keep = max(4, int(w.shape[-1] * (1 - ratio)))
            gaps.append(float((imp[keep - 1] - imp[keep]) / imp[keep - 1]))
    return min(gaps)


def act_code_flips(torch, card, cpu):
    """The activation codes of one QAT forward on the card against the
    CPU's, site by site in forward order, from ``fake_quant_act``'s inputs
    ``(x, bits)``, each coded as the training step codes it (the jitted
    scale).  Returns the codes that differ over all sites, of how many,
    and at the first site that differs: its index, the codes that differ
    there, the largest code change, and the largest distance of a
    differing code's x/scale from a rounding tie (k + 0.5), on the nearer
    side."""
    from repro_torch.core.quantization import _scale, jitted_scales
    out = {'sites': len(card), 'differ': 0, 'of': 0, 'first': None}
    for i, ((u, bits), (v, _)) in enumerate(zip(card, cpu)):
        qmax = 2.0 ** (bits - 1) - 1.0
        with jitted_scales():
            tu, tv = (t / _scale(t.abs().amax(), qmax) for t in (u, v))
        cu, cv = (torch.clamp(torch.round(t), -qmax - 1.0, qmax)
                  for t in (tu, tv))
        differ = cu != cv
        out['differ'] += int(differ.sum())
        out['of'] += differ.numel()
        if out['first'] is None and bool(differ.any()):
            tie = torch.minimum((tu - torch.floor(tu) - 0.5).abs(),
                                (tv - torch.floor(tv) - 0.5).abs())[differ]
            out['first'] = {'site': i, 'codes': int(differ.sum()),
                            'of': differ.numel(),
                            'step': float((cu - cv).abs().max()),
                            'tie': float(tie.max())}
    return out


def check_chain_step_against_cpu(torch, tag, ckpt, data, tr, problems):
    """One fine-tune step of Q's loss from checkpoint step 3 (the params Q
    starts from), on the card and on the CPU from the same params and
    batch, at each of CHAIN_CUTS' hps (TF32 off in both).  Where the hp
    quantizes activations, the step's activation codes on the two devices
    are compared too (``act_code_flips``)."""
    from repro_torch.checkpoint import load_chain_state
    from repro_torch.core.family import CNNFamily
    from repro_torch.models import cnn as cnn_lib
    lr = tr.lr / 10
    batch = CNNFamily(data, device='cpu').train_batch(
        torch.Generator().manual_seed(SEED + 11), CHAIN_CUT_BATCH)
    real_act = cnn_lib.fake_quant_act
    out = []
    for hp, bands in CHAIN_CUTS:
        runs, acts = {}, {}
        for dev in ('cpu', 'cuda'):
            st, _ = load_chain_state(ckpt, CNNFamily(data, device=dev), 3)
            qcfg = st.cfg.replace(**hp)
            opt = tr.optimizer(lr)
            b = tuple(t.to(dev) for t in batch)
            acts[dev] = []

            def recording_act(x, bits, **kw):
                if bits > 0:
                    acts[dev].append((x.detach().cpu(), bits))
                return real_act(x, bits, **kw)
            cnn_lib.fake_quant_act = recording_act
            try:
                params, _, loss = tr.train_step(
                    opt, st.family.loss, qcfg, st.params,
                    opt.init(st.params), b)
            finally:
                cnn_lib.fake_quant_act = real_act
            runs[dev] = (float(loss), _leaves(params))
        flips = act_code_flips(torch, acts['cuda'], acts['cpu']) \
            if acts['cuda'] else None
        if flips is not None:
            f = flips['first']
            print(f"{tag} the step at {hp}: activation codes of its forward "
                  f"at {flips['sites']} sites, card vs CPU: "
                  f"{flips['differ']} of {flips['of']} differ"
                  + ('' if f is None else
                     f"; the first at site {f['site']}: {f['codes']} of "
                     f"{f['of']} codes, by at most {f['step']:g} step, the "
                     f"farthest {f['tie']:.3e} from a rounding tie"))
        worst, near, n = 0.0, 0, 0
        for a, b in zip(runs['cuda'][1], runs['cpu'][1]):
            d = (a.cpu() - b).abs()
            worst = max(worst, float(d.max()))
            near += int((d > QAT_NEAR_LR * lr).sum())
            n += d.numel()
        l_gpu, l_cpu = runs['cuda'][0], runs['cpu'][0]
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        print(f'{tag} one Q step at {hp} from the trained student (batch '
              f'{CHAIN_CUT_BATCH}), card vs CPU: loss {l_gpu:.7f} vs '
              f'{l_cpu:.7f} (|diff| {rel:.3e} x |loss|); new params max '
              f'|diff| {worst / lr:.3e} x lr, {near} of {n} elements '
              f'({near / n:.3e}) more than {QAT_NEAR_LR:g} x lr apart; '
              + ('reported, held to finite values' if bands is None else
                 'limits {:g}, {:g} x lr, {:g}'.format(*bands)))
        if bands is None:
            ok = math.isfinite(l_gpu) and all(
                bool(torch.isfinite(t).all()) for t in runs['cuda'][1])
        else:
            loss_rtol, max_lr, share = bands
            ok = rel <= loss_rtol and worst <= max_lr * lr and \
                near <= share * n
        if not ok:
            problems.append(f'the Q step at {hp} disagrees with the CPU')
        out.append({'hp': hp, 'loss_rel': rel, 'max_lr': worst / lr,
                    'near_share': near / n, 'act_codes': flips})
    return out


def recording_trainer(fits):
    """A ``Trainer`` class whose ``fit`` appends each fit's (last loss, wall
    seconds) to ``fits``."""
    from repro_torch.core.passes import Trainer

    class Recording(Trainer):
        def fit(self, *args, **kw):
            t0 = time.perf_counter()
            params, last = super().fit(*args, **kw)
            fits.append((last, time.perf_counter() - t0))
            return params, last
    return Recording


def timed_pass(torch, walls):
    """``timed(p)``: the registered pass ``p`` whose transform appends
    (key, start, wall seconds after a synchronize) to ``walls``."""
    import dataclasses

    def timed(p):
        def fn(state, hp, trainer):
            t0 = time.perf_counter()
            new = p.fn(state, hp, trainer)
            torch.cuda.synchronize()
            walls.append((p.key, t0, time.perf_counter() - t0))
            return new
        return dataclasses.replace(p, fn=fn)
    return timed


def chain_path(torch, launch_us):
    """Path (g): the paper's compression chain on resnet34-cifar through
    ``Pipeline.from_sequence(CHAIN_SEQUENCE).run`` with checkpoints,
    counted from zero; the gates on what the card computed; the finished
    chain exported with ``export_chain(calibrate=...)`` and served through
    ``serve_path``.  Returns (the exported model, the chain's params, the
    launches of every kernel in the counted runs, every fake-quant call of
    one Q step as (wrapper, weight, bits), readings)."""
    import tempfile
    from repro_torch.checkpoint import load_chain_state
    from repro_torch.configs.cnn import CNN_REGISTRY
    from repro_torch.core.chain import Pipeline
    from repro_torch.core.export import export_chain
    from repro_torch.core.family import CNNFamily
    from repro_torch.data import SyntheticImages
    from repro_torch.kernels import counts, reset_counts

    tag = f'[chain:{CHAIN_KEY}]'
    data = SyntheticImages(difficulty=CHAIN_DIFFICULTY)
    fam = CNNFamily(data, device='cuda')
    cfg = CNN_REGISTRY[CHAIN_CONFIG]
    fits, walls = [], []
    tr = recording_trainer(fits)(**CHAIN_TRAINER, seed=SEED)
    timed = timed_pass(torch, walls)
    pipe = Pipeline.from_sequence(CHAIN_SEQUENCE, CHAIN_HPS)
    problems = []
    with tempfile.TemporaryDirectory(prefix='chain_smoke_') as ckpt:
        # ---- the chain, counted from zero
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st = Pipeline(tuple((timed(p), hp) for p, hp in pipe.steps)).run(
            fam, cfg, tr, key=SEED, pretrain_steps=CHAIN_PRETRAIN,
            checkpoint_dir=ckpt)
        torch.cuda.synchronize()
        t_chain = time.perf_counter() - t0
        trained = counts()
        peak = torch.cuda.max_memory_allocated()
        labels = [h['pass'] for h in st.history]
        pass_wall = {'baseline': walls[0][1] - t0 if walls else t_chain}
        pass_wall.update({k: w for k, _, w in walls})
        print(f"{tag} {cfg.name} -> {CHAIN_SEQUENCE} {CHAIN_HPS} in "
              f"{t_chain:.2f} s ({tr.batch} images a step, baseline "
              f"{CHAIN_PRETRAIN} steps, {tr.steps} a pass, D's student "
              f"{3 * tr.steps}); peak memory {peak / 2 ** 20:.1f} MiB")
        for h, (loss, fit_s) in zip(st.history, fits):
            print(f"{tag}   {h['pass']:8s} acc {h['acc']:.4f} BitOpsCR "
                  f"{h['BitOpsCR']:.4f} CR {h['CR']:.4f} | last loss "
                  f"{loss:.5f}, training {fit_s:.2f} s, pass "
                  f"{pass_wall.get(h['pass'], 0.0):.2f} s")
        losses = [loss for loss, _ in fits]
        if labels != ['baseline'] + list(CHAIN_SEQUENCE) or \
                len(losses) != len(labels) or \
                not all(v is not None and math.isfinite(v) for v in losses):
            fail(f'{CHAIN_KEY}: history {labels}, last losses {losses}: '
                 f'want baseline + {CHAIN_SEQUENCE}, each loss finite')
        for name in trained:
            print(f"{tag} {name}: {trained[name]['launches']} launches, "
                  f"{trained[name]['plain_calls']} plain calls in the chain")
        if trained['fake_quant_fused']['launches'] == 0 or any(
                c['plain_calls'] for c in trained.values()):
            fail(f'{CHAIN_KEY}: the chain did not fake-quantize on the card '
                 f'or ran a plain version: {trained}')
        ranks = factored_ranks(st.params)
        d_cpu, _ = load_chain_state(ckpt, CNNFamily(data, device='cpu'), 1)
        p_cpu, _ = load_chain_state(ckpt, CNNFamily(data, device='cpu'), 2)
        widths = [[b['conv1']['w'].shape[-1] for b in blocks]
                  for blocks in p_cpu.params['stages']]
        print(f'{tag} student {d_cpu.cfg}; after P {p_cpu.cfg}, conv1 '
              f'widths by stage {widths}')
        print(f'{tag} final cfg {st.cfg}; {len(ranks)} factored weights, '
              f'ranks {ranks}; exit_probs {st.exit_probs} at threshold '
              f'{st.exit_threshold}')

        # (2) every record's BitOpsCR and CR from the card's checkpointed
        # cfg, params and exit_probs, recomputed on the CPU
        for k, h in enumerate(st.history):
            c, _ = load_chain_state(ckpt, CNNFamily(data, device='cpu'), k)
            bops = c.family.bitops(c.cfg, c.exit_probs, c.mac_scale)
            bits = c.family.storage_bits(c.params, c.cfg)
            want = (c.base_bitops / max(bops, 1), c.base_bits / max(bits, 1))
            if (h['BitOpsCR'], h['CR']) != want:
                fail(f"{CHAIN_KEY}: record {h['pass']} {h} differs from "
                     f'the CPU recomputation {want}')
        print(f'{tag} every record\'s BitOpsCR and CR equal the CPU\'s '
              f'recomputation from the checkpoints')

        # (3) P and L on the card's own weights equal the CPU's
        ratio = CHAIN_HPS['P']['ratio']
        d_gpu, _ = load_chain_state(ckpt, CNNFamily(data, device='cuda'), 1)
        pg, cg = d_gpu.family.prune(d_gpu.params, d_gpu.cfg, ratio)
        pc, cc = d_cpu.family.prune(d_cpu.params, d_cpu.cfg, ratio)
        gap = prune_gap(torch, d_cpu.params, ratio)
        same_p = cg == cc and tree_bits_equal(torch, pg, pc)
        p_gpu, _ = load_chain_state(ckpt, CNNFamily(data, device='cuda'), 2)
        lhp = CHAIN_HPS['L']
        fg = p_gpu.family.factorize(p_gpu.params, p_gpu.cfg, **lhp)
        fc = p_cpu.family.factorize(p_cpu.params, p_cpu.cfg, **lhp)
        same_l = (factored_ranks(fg[0]) == factored_ranks(fc[0])
                  and fg[2] == fc[2] and tree_bits_equal(torch, fg[0], fc[0]))
        print(f'{tag} P on the card vs the CPU from checkpoint 1: bit for '
              f'bit {same_p}, smallest relative importance gap at the '
              f'boundary {gap:.3e}; L from checkpoint 2: ranks and factors '
              f'equal {same_l}')
        if not same_p:
            problems.append('P on the card differs from the CPU')
        if not same_l:
            problems.append('L on the card differs from the CPU')

        # (4) every fake_quant_fused call of one Q step on the card
        q_in, _ = load_chain_state(ckpt, CNNFamily(data, device='cuda'), 3)
        qcfg = q_in.cfg.replace(**CHAIN_HPS['Q'])
        opt = tr.optimizer(tr.lr / 10)
        opt_state = opt.init(q_in.params)
        batch = fam.train_batch(torch.Generator().manual_seed(SEED + 5),
                                tr.batch)

        def q_step():
            tr.train_step(opt, fam.loss, qcfg, q_in.params, opt_state, batch)
        calls = capture_fake_quants(torch, q_step)
        # where a training step's time goes: one more Q step, profiled
        wall, busy, top = profile_device(torch, q_step)
        if busy is None:
            print(f'{tag} profile: one Q step in {wall:.3f} ms wall; device '
                  f'time not measured (the profiler recorded no device '
                  f'activity)')
        else:
            print(f'{tag} profile: one Q step in {wall:.3f} ms wall, device '
                  f'kernels {busy:.3f} ms: device busy {busy / wall:.1%}')
            for ms, n, name in top[:10]:
                print(f'{tag}   {ms:9.3f} ms  {n:6d} x  {name[:90]}')
        cases = [fq_case(torch, w, name, bits, iters=5)
                 for name, w, bits in calls]
        for c in cases:
            need_exact(c, 'fake_quant_fused')
        print(f'{tag} the {len(cases)} fake_quant_fused calls of one Q step '
              f'({[tuple(w.shape) for _, w, _ in calls]}) bit-exact against '
              f'fake_quant_plain')
        if not cases:
            fail(f'{CHAIN_KEY}: a Q step made no fake_quant_fused call')

        # (5) one Q step on the card against the CPU
        cut = check_chain_step_against_cpu(torch, tag, ckpt, data, tr,
                                           problems)

        # (6) resume: nothing left to apply, the final params bit for bit
        n_fits, n_walls = len(fits), len(walls)
        again = Pipeline(tuple((timed(p), hp) for p, hp in pipe.steps)).run(
            fam, cfg, tr, checkpoint_dir=ckpt)
        resumed = (len(fits) == n_fits and len(walls) == n_walls
                   and tree_bits_equal(torch, again.params, st.params)
                   and again.history == st.history)
        print(f'{tag} a second run on the checkpoints applied '
              f'{len(walls) - n_walls} passes and returned the final params '
              f'bit for bit: {resumed}')
        if not resumed:
            problems.append('the resumed run is not the finished chain')
    if problems:
        fail(f'{CHAIN_KEY}: ' + '; '.join(problems))

    # (7) the finished chain, exported and served as paths (a)-(c)
    spec = dict(key=CHAIN_KEY, config=CHAIN_CONFIG, factorize=False,
                kernels=('quant_matmul', 'fake_quant_fused', 'lowrank_conv'),
                own_threshold=True)
    model, params, served, calib_cmp = serve_path(
        torch, spec, launch_us, built=(
            fam, st.params, st.cfg,
            lambda calib: export_chain(st, device='cuda', calibrate=calib)))
    launches = {k: trained[k]['launches'] + served[k] for k in served}
    return model, params, launches, calls, {
        'history': st.history, 'chain_s': t_chain, 'pass_s': pass_wall,
        'peak_mib': peak / 2 ** 20, 'ranks': ranks, 'prune_gap': gap,
        'cut': cut, 'calibration': calib_cmp, 'state': st}


def factored_lm_ranks(params):
    """``{'wi' | 'wg' | 'wo': rank}`` of the stacked MLP weights of an LM
    tree (None where a weight is not factored)."""
    mlp = params['blocks'][0]['mlp']
    return {k: (int(mlp[k]['u']['w'].shape[-1]) if 'u' in mlp[k] else None)
            for k in ('wi', 'wg', 'wo')}


def capture_fake_quants(torch, fn):
    """Run ``fn()`` with a spy on ``ops.fake_quant_fused`` and
    ``ops.fake_quant_two_pass``: every call as (wrapper, weight, bits)."""
    from repro_torch.kernels import ops
    calls = []
    saved = ops.fake_quant_fused, ops.fake_quant_two_pass

    def capture(name, real):
        def call(w, bits=8):
            calls.append((name, w.detach(), bits))
            return real(w, bits=bits)
        return call
    ops.fake_quant_fused = capture('fake_quant_fused', saved[0])
    ops.fake_quant_two_pass = capture('fake_quant', saved[1])
    try:
        fn()
    finally:
        ops.fake_quant_fused, ops.fake_quant_two_pass = saved
    return calls


def exit_confidences(torch, fam, params, cfg, batch):
    """Each exit head's per-token fp32 softmax maximum, on the CPU: what
    ``LMFamily.exit_stats`` holds against its threshold."""
    from repro_torch.core.quantization import full_fp32, jitted_scales
    with torch.no_grad(), jitted_scales(), full_fp32():
        _, exits = fam.exit_logits(params, cfg, batch)
    return {g: torch.softmax(exits[g].float(), -1).amax(-1).reshape(-1)
            .cpu() for g in sorted(exits)}


def first_exit(torch, conf, threshold):
    """Per token, the first head whose confidence exceeds ``threshold``,
    else -1."""
    stage = torch.full_like(conf[min(conf)], -1, dtype=torch.int64)
    for g in sorted(conf):
        stage = torch.where((stage < 0) & (conf[g] > threshold),
                            torch.full_like(stage, g), stage)
    return stage


def check_lm_hooks_against_cpu(torch, tag, problems):
    """The LM chain hooks on the card against the CPU, on a 2-layer fp32
    cut of tinyllama-1.1b at full width (weights from a CUDA generator
    seeded SEED), TF32 off: P keeps the same channels in the same order
    (bit for bit, float64 importance); L gives the same ranks and ``u @ v``
    within H_UV_RTOL (an fp64 Gram eigendecomposition on the card, numpy's
    SVD on the CPU); the exit heads' per-token decisions are equal but for tokens
    within H_NEAR x the threshold of it (counted); one W8A8 Q step of the
    pruned, factored cut within path (f)'s bands."""
    from repro_torch.configs import get_config
    from repro_torch.core.export import to_device
    from repro_torch.core.family import LMFamily
    from repro_torch.data import SyntheticTokens
    cfg = get_config(LM_ARCH).replace(num_layers=2, dtype='float32')
    fams = {dev: LMFamily(SyntheticTokens(cfg.vocab_size), seq=QAT_SEQ,
                          device=dev) for dev in ('cpu', 'cuda')}
    params = fams['cuda'].init(fams['cuda'].generator(SEED), cfg)
    out = {}
    for dev, fam in fams.items():
        p = to_device(params, dev)
        t0 = time.perf_counter()
        pp, pc = fam.prune(p, cfg, H_HPS['P']['ratio'])
        t1 = time.perf_counter()
        fp, fc, scale = fam.factorize(pp, pc, **H_HPS['L'])
        if dev == 'cuda':
            torch.cuda.synchronize()
        out[dev] = (pp, pc, fp, scale, t1 - t0, time.perf_counter() - t1)
    same_p = out['cuda'][1] == out['cpu'][1] and \
        tree_bits_equal(torch, out['cuda'][0], out['cpu'][0])
    ranks = {dev: factored_lm_ranks(o[2]) for dev, o in out.items()}
    worst = 0.0
    for lg, lc in zip(out['cuda'][2]['blocks'], out['cpu'][2]['blocks']):
        for k in ('wi', 'wg', 'wo'):
            g, c = lg['mlp'][k], lc['mlp'][k]
            if 'u' not in g or 'u' not in c:
                continue
            want = c['u']['w'] @ c['v']['w']
            got = (g['u']['w'] @ g['v']['w']).cpu()
            worst = max(worst, float((got - want).abs().max()
                                     / want.abs().max()))
    same_l = ranks['cuda'] == ranks['cpu'] and \
        out['cuda'][3] == out['cpu'][3] and worst <= H_UV_RTOL
    print(f"{tag} 2-layer fp32 cut: P on the card vs the CPU bit for bit "
          f"{same_p} (d_ff {out['cuda'][1].d_ff}; {out['cuda'][4]:.2f} s vs "
          f"{out['cpu'][4]:.2f} s); L ranks {ranks['cuda']} vs "
          f"{ranks['cpu']}, mac_scale {out['cuda'][3]:.6f} vs "
          f"{out['cpu'][3]:.6f}, max |u@v diff| / max|u@v| {worst:.3e} "
          f"(limit {H_UV_RTOL:g}); SVDs {out['cuda'][5]:.2f} s on the card "
          f"(fp64 Gram eigendecomposition), {out['cpu'][5]:.2f} s on the CPU "
          f"(numpy)")
    if not same_p:
        problems.append('P on the card differs from the CPU')
    if not same_l or None in ranks['cuda'].values():
        problems.append('L on the card differs from the CPU or factored '
                        'nothing')
    fp, fc = fams['cuda'].add_exits(fams['cuda'].generator(SEED + 1),
                                    out['cuda'][2], out['cuda'][1], (0, 1))
    batch = fams['cuda'].train_batch(torch.Generator().manual_seed(SEED + 2),
                                     QAT_CUT_BATCH)
    conf = {dev: exit_confidences(torch, fam, to_device(fp, dev), fc,
                                  to_device(batch, dev))
            for dev, fam in fams.items()}
    thr = float(conf['cpu'][0].median())
    near = torch.zeros_like(conf['cpu'][0], dtype=torch.bool)
    for g in conf['cpu']:
        near |= (conf['cpu'][g] - thr).abs() <= H_NEAR * thr
    stage = {dev: first_exit(torch, c, thr) for dev, c in conf.items()}
    differ = stage['cuda'] != stage['cpu']
    off = int((differ & ~near).sum())
    print(f"{tag} exit decisions at threshold {thr:.6f} (head 0's median "
          f"confidence), card vs CPU: {int(differ.sum())} of "
          f"{differ.numel()} tokens differ, {int(near.sum())} tokens within "
          f"{H_NEAR:g} x the threshold of it, {off} differing tokens outside "
          f"that; tokens leaving at head 0 / 1 on the card: "
          f"{int((stage['cuda'] == 0).sum())} / "
          f"{int((stage['cuda'] == 1).sum())}")
    if off:
        problems.append('exit decisions on the card differ from the CPU')
    cut = qat_step_against_cpu(
        torch, tag, H_KEY, out['cuda'][1], out['cuda'][2], H_PER_LAYER,
        (QAT_CUTS[1],))
    return {'prune_same': same_p, 'ranks': ranks['cuda'], 'uv_err': worst,
            'exit_differ': int(differ.sum()), 'exit_near': int(near.sum()),
            'cut': cut}


def lm_chain_path(torch):
    """Path (h): the paper's chain on tinyllama-1.1b at full width through
    ``Pipeline.from_sequence(H_SEQUENCE).run`` with checkpoints, counted
    from zero; the gates on what the card computed; the chain exported with
    ``Pipeline.export`` and decoded through ``launch/serve.py``'s functions
    at batch 8, prompt 512, 64 tokens.  Returns (the launches of every
    kernel in the counted runs, the fake-quant calls of one Q step, the
    decode-attention calls of one decode step, readings)."""
    import tempfile
    from repro_torch.checkpoint import load_chain_state
    from repro_torch.configs import get_config
    from repro_torch.core.chain import Pipeline, sweep_exit_thresholds
    from repro_torch.core.family import LMFamily
    from repro_torch.core.passes import mask_like
    from repro_torch.core.quantization import jitted_scales
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models.model import build_model, param_count

    tag = f'[chain:{H_KEY}]'
    cfg = get_config(LM_ARCH)
    data = SyntheticTokens(vocab=cfg.vocab_size)
    fam = LMFamily(data, seq=QAT_SEQ, device='cuda')
    fits, walls = [], []
    tr = recording_trainer(fits)(**H_TRAINER, seed=SEED)
    timed = timed_pass(torch, walls)
    pipe = Pipeline.from_sequence(H_SEQUENCE, H_HPS)
    problems = []
    with tempfile.TemporaryDirectory(prefix='lm_chain_smoke_') as ckpt:
        # ---- the chain, counted from zero
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st = Pipeline(tuple((timed(p), hp) for p, hp in pipe.steps)).run(
            fam, cfg, tr, key=SEED, pretrain_steps=H_PRETRAIN,
            checkpoint_dir=ckpt)
        torch.cuda.synchronize()
        t_chain = time.perf_counter() - t0
        trained = counts()
        peak = torch.cuda.max_memory_allocated()
        labels = [h['pass'] for h in st.history]
        pass_wall = {'baseline': walls[0][1] - t0 if walls else t_chain}
        pass_wall.update({k: w for k, _, w in walls})
        print(f"{tag} {cfg.name} ({cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, d_ff {cfg.d_ff}, {cfg.dtype}) -> "
              f"{H_SEQUENCE} {H_HPS} in {t_chain:.2f} s ({tr.batch} x "
              f"{fam.seq} tokens a step, baseline {H_PRETRAIN} steps, "
              f"{tr.steps} a pass, D's student {3 * tr.steps}); peak memory "
              f"{peak / 2 ** 20:.1f} MiB")
        for h, (loss, fit_s) in zip(st.history, fits):
            print(f"{tag}   {h['pass']:8s} acc {h['acc']:.4f} BitOpsCR "
                  f"{h['BitOpsCR']:.4f} CR {h['CR']:.4f} | last loss "
                  f"{loss:.5f}, training {fit_s:.2f} s, pass "
                  f"{pass_wall.get(h['pass'], 0.0):.2f} s")
        losses = [loss for loss, _ in fits]
        if labels != ['baseline'] + list(H_SEQUENCE) or \
                len(losses) != len(labels) or \
                not all(v is not None and math.isfinite(v) for v in losses):
            fail(f'{H_KEY}: history {labels}, last losses {losses}: want '
                 f'baseline + {H_SEQUENCE}, each loss finite')
        for name in trained:
            print(f"{tag} {name}: {trained[name]['launches']} launches, "
                  f"{trained[name]['plain_calls']} plain calls in the chain")
        if trained['fake_quant_fused']['launches'] == 0 or any(
                c['plain_calls'] for c in trained.values()):
            fail(f'{H_KEY}: the chain did not fake-quantize on the card or '
                 f'ran a plain version: {trained}')
        ranks = factored_lm_ranks(st.params)
        limit = cfg.d_model * st.cfg.d_ff // (cfg.d_model + st.cfg.d_ff)
        print(f'{tag} student: {st.cfg.num_layers} layers, d_ff '
              f'{st.cfg.d_ff}, {param_count(st.params) / 1e9:.3f} G '
              f'parameters; L ranks of the stacked MLP weights {ranks} (a '
              f'rank saves MACs below {limit + 1}); exit heads after groups '
              f'{st.cfg.exit_layers}, exit fractions {st.exit_probs} at '
              f'threshold {st.exit_threshold}')
        shape = (round(cfg.num_layers * H_HPS['D']['factor']),
                 int(cfg.d_ff * (1 - H_HPS['P']['ratio'])))
        if (st.cfg.num_layers, st.cfg.d_ff) != shape or \
                None in ranks.values() or max(ranks.values()) > limit:
            fail(f'{H_KEY}: want a student of {shape} (layers, d_ff), every '
                 f'stacked MLP weight factored: {st.cfg}, {ranks}')

        # (2) every record's BitOpsCR and CR recomputed on the CPU from the
        # card's checkpointed cfg, params and exit_probs
        cpu_fam = LMFamily(data, seq=QAT_SEQ, device='cpu')
        for k, h in enumerate(st.history):
            c, _ = load_chain_state(ckpt, cpu_fam, k)
            bops = c.family.bitops(c.cfg, c.exit_probs, c.mac_scale)
            bits = c.family.storage_bits(c.params, c.cfg)
            want = (c.base_bitops / max(bops, 1), c.base_bits / max(bits, 1))
            if (h['BitOpsCR'], h['CR']) != want:
                fail(f"{H_KEY}: record {h['pass']} {h} differs from the CPU "
                     f'recomputation {want}')
        print(f"{tag} every record's BitOpsCR and CR equal the CPU's "
              f'recomputation from the checkpoints')

        # (3) the fake_quant_fused calls of one Q step (from checkpoint 3,
        # the params Q starts from) and of one E step (the final tree), bit
        # for bit against the plain version
        q_in, _ = load_chain_state(ckpt, fam, 3)
        qcfg = q_in.cfg.replace(**H_HPS['Q'])
        batch = fam.train_batch(torch.Generator().manual_seed(SEED + 5),
                                tr.batch)
        opt = tr.optimizer(tr.lr / 10)
        q_state = opt.init(q_in.params)

        def q_step():
            tr.train_step(opt, fam.loss, qcfg, q_in.params, q_state, batch)
        q_calls = capture_fake_quants(torch, q_step)
        wall, busy, top = profile_device(torch, q_step)
        if busy is None:
            print(f'{tag} profile: one Q step in {wall:.3f} ms wall; device '
                  f'time not measured (the profiler recorded no device '
                  f'activity)')
        else:
            print(f'{tag} profile: one Q step in {wall:.3f} ms wall, device '
                  f'kernels {busy:.3f} ms: device busy {busy / wall:.1%}')
            for ms, n, name in top[:10]:
                print(f'{tag}   {ms:9.3f} ms  {n:6d} x  {name[:90]}')
        del q_state
        e_opt = tr.optimizer()
        e_state = e_opt.init(st.params)
        e_calls = capture_fake_quants(torch, lambda: tr.train_step(
            e_opt, fam.exit_loss, st.cfg, st.params, e_state, batch,
            mask_like(st.params, lambda k: k == 'exit_heads')))
        del e_state
        from repro_torch.kernels.fake_quant import (fake_quant_fused,
                                                    fake_quant_plain)
        e_exact = all(
            same_bits(torch, fake_quant_fused(w, bits=b),
                      fake_quant_plain(w, bits=b)) for _, w, b in e_calls)
        q_shapes = sorted({tuple(w.shape) for _, w, _ in q_calls})
        n_layers = st.cfg.num_layers
        want_q = H_PER_LAYER['fake_quant_fused'] * n_layers
        print(f'{tag} one Q step: {len(q_calls)} fake-quant calls (want '
              f'{want_q}), shapes {q_shapes}; one E step: {len(e_calls)} '
              f'(want {want_q + len(st.cfg.exit_layers)}), every one '
              f'bit-exact against fake_quant_plain {e_exact}')
        if [n for n, _, _ in q_calls] != ['fake_quant_fused'] * want_q or \
                len(e_calls) != want_q + len(st.cfg.exit_layers) or \
                not e_exact:
            problems.append('the fake-quant calls of a Q or E step are not '
                            'those of the pruned, factored student, or '
                            'disagree with the plain version')

        # (4) the checkpoints: a second run applies nothing and returns the
        # final params bit for bit
        n_fits, n_walls = len(fits), len(walls)
        again = Pipeline(tuple((timed(p), hp) for p, hp in pipe.steps)).run(
            fam, cfg, tr, checkpoint_dir=ckpt)
        resumed = (len(fits) == n_fits and len(walls) == n_walls
                   and tree_bits_equal(torch, again.params, st.params)
                   and again.history == st.history)
        del again
        print(f'{tag} a second run on the checkpoints applied '
              f'{len(walls) - n_walls} passes and returned the final params '
              f'bit for bit: {resumed}')
        if not resumed:
            problems.append('the resumed run is not the finished chain')

    # (5) the hooks on the card against the CPU, on a 2-layer cut
    hooks = check_lm_hooks_against_cpu(torch, tag, problems)

    # (6) the exit frontier: E's threshold and two taken from the final
    # model's confidences, where some tokens leave
    eval_b = fam.eval_batches(tr.eval_n, tr.eval_batch)
    conf = exit_confidences(torch, fam, st.params, st.cfg, eval_b[0])
    g0 = conf[min(conf)]
    thresholds = [H_HPS['E']['threshold'], float(g0.quantile(0.9)),
                  float(g0.quantile(0.5))]
    frontier = sweep_exit_thresholds(st, tr, thresholds)
    _, probs = fam.exit_stats(st.params, st.cfg, eval_b, thresholds[-1])
    print(f'{tag} exit frontier: ' + '; '.join(
        f"threshold {r['threshold']:.6f} acc {r['acc']:.4f} BitOpsCR "
        f"{r['BitOpsCR']:.4f}" for r in frontier)
        + f'; exit fractions at {thresholds[-1]:.6f}: {probs}')
    if not any(v > 0 for v in probs.values()):
        problems.append('no token leaves at an exit head on the frontier')
    if problems:
        fail(f'{H_KEY}: ' + '; '.join(problems))

    # (7) Pipeline.export, then decode at batch 8 x (512 + 64) on the bf16
    # cache, counted from zero
    t0 = time.perf_counter()
    exported = pipe.export(st, device='cuda')
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    p = exported.params
    mlp = p['blocks'][0]['mlp']
    if not all(mlp[k][h]['w_q'].dtype == torch.int8
               for k in ('wi', 'wg', 'wo') for h in ('u', 'v')):
        fail(f'{H_KEY}: the export left a factored MLP weight unquantized')
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(p))
    model = build_model(exported.cfg)
    prompt = data.batch(torch.Generator().manual_seed(SEED + 1), LM_BATCH,
                        LM_PROMPT, 'cuda')['tokens']
    max_len = LM_PROMPT + LM_TOKENS + 8
    zeros = torch.zeros((LM_BATCH,), dtype=torch.int64, device='cuda')
    _, warm = serve.prefill_step(model, p, prompt, max_len=max_len)
    serve.decode(model, p, warm, zeros, pos0=LM_PROMPT, tokens=2)
    del warm
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, cache = serve.prefill_step(model, p, prompt, max_len=max_len)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = serve.decode(model, p, cache, zeros, pos0=LM_PROMPT,
                        tokens=LM_TOKENS)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    decoded = counts()
    dpeak = torch.cuda.max_memory_allocated()
    print(f'{tag} Pipeline.export in {t_export:.3f} s: '
          f'{weight_bytes / 1e9:.3f} GB of int8 weights and their scales; '
          f'prefill of {LM_BATCH} x {LM_PROMPT} tokens {t_prefill * 1e3:.3f} '
          f'ms; {LM_TOKENS} greedy decode steps {t_decode * 1e3:.3f} ms: '
          f'{t_decode / LM_TOKENS * 1e3:.3f} ms/token, '
          f'{LM_BATCH * LM_TOKENS / t_decode:.1f} tokens/s; peak memory '
          f'{dpeak / 2 ** 20:.1f} MiB')
    want = exported.cfg.num_layers * LM_TOKENS
    if tuple(toks.shape) != (LM_TOKENS, LM_BATCH) or \
            decoded['decode_attention'] != {'launches': want,
                                            'plain_calls': 0} or \
            decoded['decode_attention_int8']['launches'] or \
            any(c['plain_calls'] for c in decoded.values()):
        fail(f'{H_KEY}: the decode ran {decoded}, want {want} '
             f'decode_attention launches and no plain version')
    _, fresh = serve.prefill_step(model, p, prompt, max_len=max_len)
    twin = clone_tree(fresh)
    # the reference jits the step: activation scales by the jitted rule
    with torch.inference_mode(), jitted_scales():
        lg_k, _ = model.decode_step(p, zeros, LM_PROMPT, fresh)
        reset_counts()
        with plain_decode_attention():
            lg_p, _ = model.decode_step(p, zeros, LM_PROMPT, twin)
        plain = counts()['decode_attention']
    del twin
    scale = float(lg_p.float().abs().max())
    diff = max_err(torch, lg_k, lg_p)
    print(f'{tag} first-step logits of the exported model, decode kernel '
          f'vs the plain decode attention ({plain}): max |diff| {diff:.3e} '
          f'(max |logit| {scale:.3e}, limit {LM_PLAIN_TOL:g} x that)')
    if tuple(lg_k.shape) != (LM_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(lg_k).all()) or \
            diff > LM_PLAIN_TOL * scale or plain != {
                'launches': 0, 'plain_calls': exported.cfg.num_layers}:
        fail(f'{H_KEY}: the exported model\'s decode logits are malformed '
             f'or disagree with the plain decode attention')
    da_calls = []

    def capture(q, nk, nv, c, cur, **kw):
        out, c = attn.decode_attn_kernel(q, nk, nv, c, cur, **kw)
        da_calls.append((q, c, attn._valid(c['meta']['pos'], int(cur), 0)))
        return out, c
    with torch.inference_mode(), jitted_scales():
        model.decode_step(p, zeros, LM_PROMPT + 1, fresh,
                          ctx={'decode_attn': capture})
    launches = {k: trained[k]['launches'] + decoded[k]['launches']
                for k in trained}
    return launches, q_calls, da_calls, {
        'history': st.history, 'chain_s': t_chain, 'pass_s': pass_wall,
        'peak_mib': peak / 2 ** 20, 'ranks': ranks, 'hooks': hooks,
        'frontier': frontier, 'prefill_ms': t_prefill * 1e3,
        'ms_per_token': t_decode / LM_TOKENS * 1e3}


@contextlib.contextmanager
def plain_int8_kernels():
    """The int8 kernels' plain versions in their wrappers' places, in every
    module that calls them; for a comparison only, never on a counted
    path."""
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import lowrank_conv as lr
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_conv as qc
    from repro_torch.kernels import quant_matmul as qmm
    saved = (ops.quant_matmul, qc.quant_matmul, ops.depthwise_conv,
             ops.lowrank_conv)
    ops.quant_matmul = qc.quant_matmul = qmm.quant_matmul_plain
    ops.depthwise_conv = dw.depthwise_conv_plain
    ops.lowrank_conv = lr.lowrank_conv_plain
    try:
        yield
    finally:
        (ops.quant_matmul, qc.quant_matmul, ops.depthwise_conv,
         ops.lowrank_conv) = saved


def capture_int8_calls(torch, fn):
    """Run ``fn()`` with spies on the int8 wrappers the dynamic path calls:
    ``[(kernel, args as the wrapper binds them)]`` in call order."""
    import inspect
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_conv as qc
    from repro_torch.kernels import quant_matmul as qmm
    calls = []

    def spy(name, real):
        sig = inspect.signature(real)

        def call(*a, **kw):
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            calls.append((name, dict(b.arguments)))
            return real(*a, **kw)
        return call
    saved = ops.quant_matmul, qc.quant_matmul, ops.depthwise_conv
    ops.quant_matmul = qc.quant_matmul = spy('quant_matmul',
                                             qmm.quant_matmul)
    ops.depthwise_conv = spy('depthwise_conv', dw.depthwise_conv)
    try:
        out = fn()
    finally:
        ops.quant_matmul, qc.quant_matmul, ops.depthwise_conv = saved
    return out, calls


def dyn_cases(torch, calls):
    """Phase 4's cases from captured calls: each kernel call against its
    plain version at its own inputs, timed."""
    out = {'quant_matmul': [], 'depthwise_conv': []}
    for name, a in calls:
        if name == 'quant_matmul':
            out[name].append(qmm_case(
                torch, a['x_q'], a['w_q'], a['sx'], a['sw'], a['bias'],
                a['relu'], a['out_scale'], a['out_qmax'], iters=10))
        else:
            out[name].append(dw_case(
                torch, a['x_q'], a['w_q'], a['sx'], a['sw'], a['bias'],
                stride=a['stride'], relu=a['relu'], out_scale=a['out_scale'],
                out_qmax=a['out_qmax'], iters=10, route='tile'))
    return {k: v for k, v in out.items() if v}


def call_routes(calls):
    """``{'kernel/route': n}`` of captured calls by the operand rule:
    ``quant_matmul`` on ``wgmma`` where K % 16 == 0 (the operands are
    16-byte aligned), ``depthwise_conv`` on its tile route."""
    from repro_torch.kernels.depthwise_conv import dw_route
    out = {}
    for name, a in calls:
        if name == 'quant_matmul':
            r = 'wgmma' if a['x_q'].shape[1] % 16 == 0 else 'mma_sync'
        else:
            r = dw_route(a['x_q'], a['w_q'], a['stride'], a['out_scale'],
                         a['out_qmax'])
        out[f'{name}/{r}'] = out.get(f'{name}/{r}', 0) + 1
    return out


def launched_routes(before):
    """``{'kernel/route': n}`` launched since the snapshot ``before``."""
    from repro_torch.kernels.depthwise_conv import depthwise_conv
    from repro_torch.kernels.quant_matmul import quant_matmul
    now = {f'quant_matmul/{r}': n
           for r, n in quant_matmul.launches_by_route.items()}
    now.update({f'depthwise_conv/{r}': n
                for r, n in depthwise_conv.launches_by_route.items()})
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n - before.get(k, 0)}


def act_sites(torch, fn, forced=None):
    """Run ``fn()`` recording every dynamic activation quantization
    (``ops.quantize_act``) in call order: ``(out, [(x, a_bits, scale)] on
    the CPU, comparisons)``.  With ``forced`` (another run's sites, in
    order) each site compares its own codes and scale with that run's,
    then goes on with that run's, so every layer reads the other run's
    int8 input: a comparison per site, the scales' relative difference,
    the codes that differ, the largest change and the largest distance
    of a differing code's x/scale from a rounding tie (k + 0.5), on the
    nearer side."""
    from repro_torch.kernels import ops
    real = ops.quantize_act
    sites, cmp = [], []

    def spy(x, *, a_bits=8, per_row=False):
        xq, sc = real(x, a_bits=a_bits, per_row=per_row)
        if forced is not None:
            fx, _, fs = forced[len(sites)]
            qmax = 2.0 ** (a_bits - 1) - 1.0
            t_own = (x / (sc[:, None] if per_row else sc)).cpu()
            t_in = fx / (fs[:, None] if per_row else fs)
            codes = torch.clamp(torch.round(t_in), -qmax - 1.0, qmax)
            step = (xq.cpu().to(torch.float32) - codes).abs()
            differ = step > 0
            tie = torch.minimum((t_own - torch.floor(t_own) - 0.5).abs(),
                                (t_in - torch.floor(t_in) - 0.5).abs())
            cmp.append({'rel': float((sc.cpu() - fs).abs().max()
                                     / fs.abs().max()),
                        'codes': int(differ.sum()), 'of': differ.numel(),
                        'step': float(step.max()),
                        'tie': float(tie[differ].max())
                        if bool(differ.any()) else 0.0})
            xq, sc = codes.to(torch.int8).to(x.device), fs.to(x.device)
        sites.append((x.detach().cpu(), a_bits, sc.detach().cpu()))
        return xq, sc
    ops.quantize_act = spy
    try:
        out = fn()
    finally:
        ops.quantize_act = real
    return out, sites, cmp


def dynamic_path(torch, key, export, params, cfg, fam, kernels,
                 serve=False):
    """A dynamic-scale export (``export()``: ``export_cnn(calibrate=None)``
    or ``Pipeline.export``), counted from zero: ``fn_exits`` on a fixed
    batch of SLOTS images on the kernels, every ``quant_matmul`` call with K
    % 16 == 0 on ``wgmma`` and every depthwise call on the tile route, no
    weight relaid, bit for bit against the same model with every kernel
    call swapped for its plain version (``fn`` too); the stage segments
    chained bit for bit against ``fn_exits``; against the CPU export layer
    by layer, each CPU layer fed the card's int8 input (``act_sites``):
    every scale within SCALE_RTOL_EXACT of the card's, every code that
    differs one step apart and within TIE_TOL of a rounding tie, the
    logits within DYN_TOL x max|logit| (the two run end to end on their
    own scales: the difference printed, as the resident paths'
    calibration prints its own).  With ``serve``, the Poisson trace served through the
    scheduler at the exit threshold calibrated on the batch (a dynamic
    scale depends on a request's batch mates, so the served requests are
    checked for completion and launches only; the bit-exact gates hold at
    fixed batches).  Returns (the launches of every kernel in the counted
    run, phase 4's cases, readings)."""
    import numpy as np
    from repro_torch.core.export import (calibrate_exit_threshold,
                                         export_cnn, to_device)
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.serving import ContinuousBatchScheduler, Request

    tag = f'[dynamic:{key}]'
    stream = fam.eval_batches(N_REQUESTS // 64 + 1, 64)
    xs = torch.cat([x for x, _ in stream])
    x, xs = xs[:SLOTS], xs[SLOTS:SLOTS + N_REQUESTS]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    model = export()
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    if model.plan is not None or model.backend != 'cuda':
        fail(f'{key}: not a dynamic-scale export on the card')
    routes0 = launched_routes({})
    ((lg, exits), sites, _), calls = capture_int8_calls(
        torch, lambda: act_sites(torch,
                                 lambda: model.fn_exits(model.params, x)))
    got_routes = launched_routes(routes0)
    want_routes = call_routes(calls)
    c = counts()
    relaid = quant_matmul.weight_relayouts
    n_calls = {k: sum(n == k for n, _ in calls) for k in kernels}
    print(f'{tag} {cfg.name} exported in {t_export:.3f} s (dynamic scales, '
          f'no plan); fn_exits on {SLOTS} images: launches {n_calls}, by '
          f'route {got_routes} (the operand rule: {want_routes}), weight '
          f'relayouts {relaid}, plain-version calls '
          f'{sum(v["plain_calls"] for v in c.values())}')
    if got_routes != want_routes or relaid or any(
            v['plain_calls'] for v in c.values()) or not all(
            c[k]['launches'] == n_calls[k] > 0 for k in kernels):
        fail(f'{key}: the dynamic export did not run on the kernels by the '
             f'operand rule without relayout')
    lg_fn = model.fn(model.params, x)
    with plain_int8_kernels():
        lg_p, exits_p = model.fn_exits(model.params, x)
        lg_fn_p = model.fn(model.params, x)
    twin = same_bits(torch, lg, lg_p) and all(
        same_bits(torch, exits[s], exits_p[s]) for s in exits) and \
        same_bits(torch, lg_fn, lg_fn_p) and same_bits(torch, lg_fn, lg)
    lg_s, exits_s = model.serve_stages(x)
    staged = same_bits(torch, lg, lg_s) and all(
        same_bits(torch, exits[s], exits_s[s]) for s in exits)
    cpu = export_cnn(to_device(params, 'cpu'), cfg, device='cpu')

    def diff(a, b):
        (la, ea), (lb, eb) = a, b
        return max([float((la.cpu() - lb).abs().max()
                          / max(float(lb.abs().max()), 1.0))]
                   + [float((ea[s].cpu() - eb[s]).abs().max()
                            / max(float(eb[s].abs().max()), 1.0))
                      for s in ea])
    own, _, _ = act_sites(torch, lambda: cpu.fn_exits(cpu.params, x.cpu()))
    fed, _, cmp = act_sites(torch, lambda: cpu.fn_exits(cpu.params, x.cpu()),
                            forced=sites)
    d_own, d_fed = diff((lg, exits), own), diff((lg, exits), fed)
    rel = max(c['rel'] for c in cmp)
    flips = sum(c['codes'] for c in cmp)
    tie = max(c['tie'] for c in cmp)
    step = max(c['step'] for c in cmp)
    if tuple(lg.shape) != (SLOTS, cfg.num_classes) or \
            not bool(torch.isfinite(lg).all()):
        fail(f'{key}: the logits are malformed')
    ms = time_ms(torch, lambda: model.fn(model.params, x), iters=10)
    print(f'{tag} fn and fn_exits bit for bit against their plain-version '
          f'twins (and fn against fn_exits) {twin}; the '
          f'{model.n_stages} stage segments chained == fn_exits {staged}; '
          f'fn {ms:.3f} ms a batch of {SLOTS} ({SLOTS / ms * 1e3:.1f} '
          f'images/s)')
    print(f'{tag} card vs CPU export, each CPU layer fed the card\'s int8 '
          f'input, over {len(cmp)} dynamic scales: scales within {rel:.3e} '
          f'(limit {SCALE_RTOL_EXACT:g}); {flips} of '
          f'{sum(c["of"] for c in cmp)} codes differ, by at most {step:g} '
          f'step, the farthest {tie:.3e} from a rounding tie (limit '
          f'{TIE_TOL:g}); logits max |diff| / max|logit| {d_fed:.3e} (limit '
          f'{DYN_TOL:g}); end to end, each on its own scales, {d_own:.3e}')
    if not (twin and staged and rel <= SCALE_RTOL_EXACT and step <= 1
            and tie <= TIE_TOL and d_fed <= DYN_TOL):
        fail(f'{key}: the dynamic export disagrees with its plain twin, its '
             f'stage chain or the CPU')
    launches = {k: v['launches'] for k, v in c.items()}
    readings = {'fn_ms': ms, 'cpu_diff': d_fed, 'cpu_own_diff': d_own,
                'code_flips': flips}
    if serve:
        threshold = calibrate_exit_threshold(model, x)
        rng = np.random.default_rng(SEED)
        t_arr = np.cumsum(rng.exponential(1.0 / RATE, size=N_REQUESTS))
        before = counts()
        ContinuousBatchScheduler(model, slots=SLOTS, threshold=2.0).run_trace(
            [Request(-1 - i, xs[i], 0.0) for i in range(4)])     # warm-up
        sched = ContinuousBatchScheduler(model, slots=SLOTS,
                                         threshold=threshold, max_wait=0.05)
        t0 = time.perf_counter()
        done, metrics = sched.run_trace(
            [Request(i, xs[i], float(t_arr[i])) for i in range(N_REQUESTS)])
        t_serve = time.perf_counter() - t0
        after = counts()
        m = metrics.summary()
        served = {k: after[k]['launches'] - before[k]['launches']
                  for k in after}
        early = sum(r.exit_stage != -1 for r in done.values())
        print(f"{tag} served {m['n_requests']} of {N_REQUESTS} requests "
              f"(Poisson {RATE:.0f}/s, {SLOTS} slots, threshold "
              f"{threshold:.6f}) in {t_serve:.3f} s: throughput "
              f"{m['throughput_rps']} req/s, p50 "
              f"{m['p50_latency_s'] * 1e3:.3f} ms, p99 "
              f"{m['p99_latency_s'] * 1e3:.3f} ms, exit mix {m['exit_mix']}, "
              f"{early} left at an exit head, batches {m['n_batches']}; "
              f"launches with the warm-up "
              f"{dict((k, n) for k, n in served.items() if n)}; checked "
              f"at fixed batches only (a dynamic "
              f"scale depends on a request's batch mates)")
        if len(done) != N_REQUESTS or any(
                after[k]['plain_calls'] != before[k]['plain_calls']
                for k in after) or quant_matmul.weight_relayouts:
            fail(f'{key}: serving left requests, ran a plain version or '
                 f'relaid a weight')
        for k in served:
            launches[k] += served[k]
        readings.update(rps=m['throughput_rps'],
                        p50_ms=m['p50_latency_s'] * 1e3,
                        p99_ms=m['p99_latency_s'] * 1e3)
    return launches, dyn_cases(torch, calls), readings


# ------------------------------------------------------------------ phase 4


def count_delta(before):
    """Each kernel's launches and plain calls since ``before`` (a
    ``counts()`` reading)."""
    from repro_torch.kernels import counts
    return {k: {f: v[f] - before[k][f] for f in v}
            for k, v in counts().items()}


def add_launches(acc, delta):
    for k, v in delta.items():
        acc[k] = acc.get(k, 0) + v['launches']


def runtime_oracle(torch, model, xs, threshold):
    """Each request alone through the monolithic ``fn_exits`` at SLOTS
    slots: ``[(exit stage, answering logits, {head: row})]`` (numpy)."""
    from repro_torch.serving import exit_decisions
    out = []
    for i in range(xs.shape[0]):
        xb = torch.cat([xs[i][None], torch.zeros(
            (SLOTS - 1,) + tuple(xs.shape[1:]), device=xs.device)])
        logits, exits = model.fn_exits(model.params, xb)
        stage, ans = exit_decisions(logits, exits, threshold)
        out.append((int(stage[0]), ans[0],
                    {s: v[0].float().cpu().numpy() for s, v in
                     exits.items()}))
    return out


def check_against_oracle(tag, key, completions, oracle):
    """Every completion bit-exact against the request-alone oracle: a
    served one its exit stage and logits, a degraded one the row of the
    exit head it was forced to.  Returns (served, degraded) counts."""
    import numpy as np
    degraded = 0
    for rid, c in completions.items():
        stage, ans, heads = oracle[rid]
        if c.degraded:
            degraded += 1
            want = heads.get(c.exit_stage)
            ok = want is not None and np.array_equal(
                want.view(np.int32), c.logits.view(np.int32))
        else:
            ok = c.exit_stage == stage and np.array_equal(
                ans.view(np.int32), c.logits.view(np.int32))
        if not ok:
            fail(f'{key}: request {rid} (degraded={c.degraded}, exit '
                 f'{c.exit_stage}) differs from the fn_exits oracle')
    print(f'{tag} all {len(completions)} completions bit-exact against '
          f'fn_exits on the request alone at {SLOTS} slots '
          f'({len(completions) - degraded} served, {degraded} degraded to '
          f'their head row)')
    return len(completions) - degraded, degraded


def runtime_path(torch):
    """Path (i): the serving runtime's other half on resnet34-cifar at its
    published widths, counted from zero (the oracle and twin comparisons
    excluded).  (a)'s model is persisted as a chain checkpoint and loaded
    through ``ModelRegistry.load`` (``export_cnn(calibrate=32 images)`` on
    the card); stage costs from CUDA events (median of 5 after a warm-up);
    256 Poisson requests at 2000/s on 32 slots.  (i-slo): the SLO
    scheduler on the simulated clock at a loose and a tight deadline;
    (i-pool): the replica pool under ``ChaosPlan.seeded`` with
    ``ModelRegistry.restore`` as failover, traced (i-trace) and checked
    before and after a Chrome round trip; (i-measure): measure-mode
    selection on (c)'s factored model.  Returns (launches, the measure
    export and its params for phase 4, readings)."""
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import save_chain_state
    from repro_torch.core.export import (calibrate_exit_threshold,
                                         export_cnn)
    from repro_torch.core.passes import ChainState
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.kernels.lowrank_conv import fits_fused
    from repro_torch.launch.serve_cnn import _measure_stage_costs
    from repro_torch.obs import (TraceInvariantError, Tracer, check_trace,
                                 load_chrome_trace)
    from repro_torch.serving import (ChaosPlan, ContinuousBatchScheduler,
                                     ModelRegistry, ReplicaPoolScheduler,
                                     Request, SLOPolicy)

    tag = f'[runtime:{RT_KEY}]'
    fam, params, cfg = path_model(torch, PATHS[0])
    stream = fam.eval_batches(N_REQUESTS // 64 + 1, 64)
    xs = torch.cat([x for x, _ in stream])
    calib, xs = xs[:SLOTS], xs[SLOTS:SLOTS + N_REQUESTS]
    t_arr = np.cumsum(np.random.default_rng(SEED).exponential(
        1.0 / RATE, size=N_REQUESTS))
    launches, out = {}, {}
    restores = []
    with tempfile.TemporaryDirectory(prefix='runtime_smoke_') as ckpt:
        save_chain_state(ckpt, ChainState(family=fam, cfg=cfg,
                                          params=params, key=SEED), step=0)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        registry = ModelRegistry()
        model = registry.load(RT_KEY, ckpt, fam, device='cuda',
                              calibrate=calib)
        threshold = calibrate_exit_threshold(model, calib)
        costs = _measure_stage_costs(model, calib, iters=RT_COST_ITERS)
        torch.cuda.synchronize()
        add_launches(launches, counts())
        print(f'{tag} {cfg.name} loaded through ModelRegistry.load and '
              f'exported on the card in {time.perf_counter() - t0:.2f} s; '
              f'exit threshold {threshold:.6f}; stage costs at {SLOTS} '
              f'slots (CUDA events, median of {RT_COST_ITERS}): '
              + ', '.join(f'seg{k} {c * 1e3:.4f} ms'
                          for k, c in enumerate(costs))
              + f', sum {sum(costs) * 1e3:.4f} ms')
        out['stage_costs_ms'] = [c * 1e3 for c in costs]
        oracle = runtime_oracle(torch, model, xs, threshold)

        # ---- (i-slo): two deadlines on the simulated clock.  The tight one
        # lies between costs[0] + costs[1] and the sum of the costs, above
        # what admission asks of a request that finds the queue empty
        # (costs[0] + the largest cost) where the costs leave room for it
        floor = max(costs[0] + costs[1], costs[0] + max(costs))
        if floor >= sum(costs):
            floor = costs[0] + costs[1]
        deadlines = {'loose': 4.0 * sum(costs),
                     'tight': (floor + sum(costs)) / 2}
        for label, budget in deadlines.items():
            reqs = [Request(i, xs[i], float(t_arr[i]),
                            deadline=float(t_arr[i]) + budget)
                    for i in range(N_REQUESTS)]
            before = counts()
            comp, metrics = ContinuousBatchScheduler(
                model, slots=SLOTS, threshold=threshold, stage_costs=costs,
                slo=SLOPolicy()).run_trace(reqs)
            torch.cuda.synchronize()
            add_launches(launches, count_delta(before))
            m = metrics.summary()
            slo = m['slo']
            print(f"{tag}[slo {label} {budget * 1e3:.4f} ms] served "
                  f"{m['n_requests']} of {N_REQUESTS}: attainment "
                  f"{slo['attainment']}, on time {slo['n_on_time']}, late "
                  f"{slo['n_late']}, rejected {m['n_rejected']}, degraded "
                  f"{m['n_degraded']} (exit mix {m['degraded_exit_mix']}), "
                  f"exit mix {m['exit_mix']}, batches {m['n_batches']}, "
                  f"simulated p50 {m['p50_latency_s'] * 1e3:.4f} ms, p99 "
                  f"{m['p99_latency_s'] * 1e3:.4f} ms")
            if slo['n_late']:
                fail(f"{RT_KEY}: {slo['n_late']} requests completed late "
                     f'at the {label} deadline')
            if len(comp) + m['n_rejected'] != N_REQUESTS:
                fail(f'{RT_KEY}: requests lost at the {label} deadline')
            if label == 'loose' and len(comp) != N_REQUESTS:
                fail(f"{RT_KEY}: the loose deadline served {len(comp)} of "
                     f'{N_REQUESTS} requests')
            if label == 'tight' and not (m['n_degraded'] + m['n_rejected']):
                fail(f'{RT_KEY}: the tight deadline degraded and rejected '
                     f'nothing')
            check_against_oracle(f'{tag}[slo {label}]', RT_KEY, comp,
                                 oracle)
            out[f'slo_{label}'] = dict(
                deadline_ms=budget * 1e3, attainment=slo['attainment'],
                n_late=slo['n_late'], rejected=m['n_rejected'],
                degraded=m['n_degraded'],
                degraded_exit_mix=m['degraded_exit_mix'])

        # ---- (i-pool) and (i-trace): the replica pool under chaos
        horizon = max(float(t_arr[-1]), N_REQUESTS / SLOTS * sum(costs)
                      / RT_POOL['replicas'])
        plan = ChaosPlan.seeded(SEED, RT_POOL['replicas'], horizon)

        def restore():
            t = time.perf_counter()
            fresh = registry.restore(RT_KEY)
            torch.cuda.synchronize()
            restores.append(time.perf_counter() - t)
            return fresh
        tracer = Tracer()
        reqs = [Request(i, xs[i], float(t_arr[i]))
                for i in range(N_REQUESTS)]
        before = counts()
        t0 = time.perf_counter()
        comp, metrics = ReplicaPoolScheduler(
            model, slots=SLOTS, threshold=threshold, stage_costs=costs,
            replicas=RT_POOL['replicas'], min_replicas=RT_POOL['replicas'],
            max_replicas=RT_POOL['max_replicas'], restore=restore,
            restore_delay=costs[0], chaos=plan, tracer=tracer).run_trace(
                reqs)
        torch.cuda.synchronize()
        t_pool = time.perf_counter() - t0
        add_launches(launches, count_delta(before))
        m = metrics.summary()
        r = m['resilience']
        print(f"{tag}[pool] ChaosPlan.seeded({SEED}, "
              f"{RT_POOL['replicas']}, {horizon:.6f}): kills {plan.kills}, "
              f"slowdowns {plan.slowdowns}; served {m['n_requests']} of "
              f"{N_REQUESTS} in {t_pool:.3f} s wall: availability "
              f"{m['availability']}, kills {r['kills']}, failovers "
              f"{r['failovers']}, straggler flags {r['straggler_flags']}, "
              f"evictions {r['evictions']}, scale-ups {r['scale_ups']}, "
              f"peak replicas {r['peak_replicas']}, {len(restores)} "
              f"restores through ModelRegistry.restore in "
              f"{sum(restores):.3f} s wall; simulated p50 "
              f"{m['p50_latency_s'] * 1e3:.4f} ms, p99 "
              f"{m['p99_latency_s'] * 1e3:.4f} ms")
        if r['kills'] < 1 or r['failovers'] < 1 or not restores:
            fail(f'{RT_KEY}: the pool saw no kill and failover')
        if len(comp) != N_REQUESTS or m['availability'] != 1.0:
            fail(f'{RT_KEY}: the pool completed {len(comp)} of '
                 f'{N_REQUESTS} requests')
        check_against_oracle(f'{tag}[pool]', RT_KEY, comp, oracle)
        restored = registry.get(RT_KEY)
        if restored is model or restored.backend != 'cuda':
            fail(f'{RT_KEY}: the registry holds no restored model on the '
                 f'card')
        a = model.fn_exits(model.params, calib)
        b = restored.fn_exits(restored.params, calib)
        if not (same_bits(torch, a[0], b[0]) and all(
                same_bits(torch, a[1][s], b[1][s]) for s in a[1])):
            fail(f'{RT_KEY}: the restored replica\'s fn_exits differ from '
                 f'the original\'s')
        print(f'{tag}[pool] the restored model, re-exported on the card '
              f'from the checkpoint, gives fn_exits equal bit for bit to '
              f'the original\'s on {SLOTS} images')
        out['pool'] = dict(availability=m['availability'],
                           restore_s=sum(restores), **{
            k: r[k] for k in ('kills', 'failovers', 'straggler_flags',
                              'evictions', 'peak_replicas')})

        # (i-trace): the pool's trace, checked, written and read back
        try:
            check_trace(tracer, comp, strict=True)
            path = os.path.join(ckpt, 'pool_trace.json')
            tracer.write(path)
            loaded = load_chrome_trace(path)
            check_trace(loaded, comp, strict=True)
        except TraceInvariantError as e:
            fail(f'{RT_KEY}: the pool trace breaks its invariants: {e}')
        names = [s.name for s in tracer.spans]
        killed = sum(1 for s in tracer.spans if s.name == 'stage.exec'
                     and s.args.get('killed'))
        print(f'{tag}[trace] {len(tracer.spans)} spans, strict check_trace '
              f'green before and after the Chrome round trip '
              f'({len(loaded)} spans read back from '
              f'{os.path.getsize(path)} bytes); kill {names.count("kill")}, '
              f'failover.restore {names.count("failover.restore")}, killed '
              f'stage.exec {killed}, request.queue '
              f'{names.count("request.queue")}, stage.exec '
              f'{names.count("stage.exec")}')
        if len(loaded) != len(tracer.spans) or 'kill' not in names or \
                'failover.restore' not in names:
            fail(f'{RT_KEY}: the trace lost spans or shows no kill and '
                 f'failover')
        out['trace_spans'] = len(tracer.spans)

    # ---- (i-measure): measure-mode selection on (c)'s factored model
    _, fparams, fcfg = path_model(torch, PATHS[2])
    tracer = Tracer()
    before = counts()
    t0 = time.perf_counter()
    measured = export_cnn(fparams, fcfg, device='cuda', calibrate=calib,
                          select_kernels='measure', tracer=tracer)
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    delta = count_delta(before)
    add_launches(launches, delta)
    eligible = [n for n, e in measured.plan.layers.items()
                if e['kind'] == 'conv' and e['factored']
                and fits_fused(e['rank'], e['out_shape'][-1])]
    cost_delta = measured.plan.summary()['lowering_cost_delta']
    spans = [s for s in tracer.spans if s.name == 'kernel.launch']
    for n in eligible:
        d, sel = cost_delta.get(n), measured.plan.layers[n]['selection']
        if d is None or not sel['why'].startswith('measured'):
            fail(f'{RT_KEY}: factored layer {n} got no measured choice')
        print(f"[plan]   {n}: measured fused {d['measured_fused_us']} us, "
              f"chained {d['measured_chained_us']} us -> {sel['choice']}; "
              f"modeled fused {d['modeled_fused_us']} us, chained "
              f"{d['modeled_chained_us']} us; the model "
              f"{'agrees' if d['model_agrees'] else 'DISAGREES'}")
    wrong = sum(1 for d in cost_delta.values() if not d['model_agrees'])
    picks = {c: sum(1 for n in eligible
                    if measured.plan.layers[n]['selection']['choice'] == c)
             for c in ('fused', 'chained')}
    print(f"{tag}[measure] {fcfg.name} factored, export_cnn("
          f"select_kernels='measure') in {t_export:.2f} s: {len(eligible)} "
          f'eligible factored convs, every one measured ({picks}), the cost '
          f'model wrong on {wrong}; {len(spans)} kernel.launch spans; '
          f"launches while exporting: lowrank_conv "
          f"{delta['lowrank_conv']['launches']}, quant_matmul "
          f"{delta['quant_matmul']['launches']}, plain calls "
          f"{sum(v['plain_calls'] for v in delta.values())}")
    if not eligible or {s.args['variant'] for s in spans} != {
            'fused', 'chained'} or not delta['lowrank_conv']['launches'] \
            or not delta['quant_matmul']['launches'] or any(
                v['plain_calls'] for v in delta.values()):
        fail(f'{RT_KEY}: measure mode did not race both lowerings on the '
             f'card')
    x = xs[:SLOTS]
    before = counts()
    lg, exits = measured.fn_exits(measured.params, x)
    torch.cuda.synchronize()
    add_launches(launches, count_delta(before))
    with plain_int8_kernels():
        lg_p, exits_p = measured.fn_exits(measured.params, x)
    if not (same_bits(torch, lg, lg_p) and all(
            same_bits(torch, exits[s], exits_p[s]) for s in exits)):
        fail(f'{RT_KEY}: the measure-mode export differs from its '
             f'plain-version twin')
    print(f'{tag}[measure] fn_exits on {SLOTS} images bit for bit against '
          f'its plain-version twin')
    out['measure'] = dict(eligible=len(eligible), picks=picks,
                          model_wrong=wrong, spans=len(spans))
    for name in ('quant_matmul', 'lowrank_conv'):
        if not launches.get(name):
            fail(f'{RT_KEY}: {name} was never launched on this path')
    return launches, (measured, fparams), out


def pass_calls(torch, model, g):
    """Inputs for every kernel call one full-depth pass of ``model`` makes:
    ``{kernel: [(plan entry, params), ...]}``."""
    from repro_torch.core.export import _resolve_layer_params
    from repro_torch.core.export import layer_kernel_launches
    out = {}
    for name, e in model.plan.layers.items():
        for k in layer_kernel_launches(e):
            out.setdefault(k, []).append(
                (e, _resolve_layer_params(model.params, name)))
    return out


def qmm_pass_cases(torch, model, g):
    """One quant_matmul case per call of a pass (a chained factored conv
    is two calls: u with the h_scale requantize, then v)."""
    qmax = model.plan.a_qmax
    cases = []

    def add(M, K, w, sw, bias, sx, out_scale):
        x = rand_i8(torch, g, M, K)
        cases.append(qmm_case(torch, x, w, torch.full((M,), sx, device='cuda'),
                              sw.reshape(-1), bias, False, out_scale, qmax,
                              iters=10))

    for e, p in pass_calls(torch, model, g).get('quant_matmul', []):
        if e['kind'] == 'conv':
            B, H, W, C = e['in_shape']
            kh, kw = e['kernel']
            _, oh, ow, n = e['out_shape']
            M = B * oh * ow
            if e['factored']:
                u, v = p['u'], p['v']
                r = e['rank']
                add(M, kh * kw * C, u['w_q'].reshape(-1, r), u['scale'],
                    u['b'], e['sx'], e['h_scale'])
                add(M, r, v['w_q'].reshape(r, n), v['scale'], v['b'],
                    e['h_scale'], e['out_scale'])
            else:
                add(M, kh * kw * C, p['w_q'].reshape(-1, n), p['scale'],
                    p.get('b'), e['sx'], e['out_scale'])
        else:
            M, K = e['in_shape']
            if e['factored']:
                u, v = p['u'], p['v']
                r = u['w_q'].shape[1]
                add(M, K, u['w_q'], u['scale'], u.get('b'), e['sx'],
                    e['h_scale'])
                add(M, r, v['w_q'], v['scale'], v.get('b'), e['h_scale'],
                    None)
            else:
                add(M, K, p['w_q'], p['scale'], p.get('b'), e['sx'], None)
    return cases


def dw_pass_cases(torch, model, g):
    qmax = model.plan.a_qmax
    cases = []
    for e, p in pass_calls(torch, model, g).get('depthwise_conv', []):
        x = rand_i8(torch, g, *e['in_shape'])
        cases.append(dw_case(torch, x, p['w_q'], e['sx'], p['scale'],
                             p.get('b'), stride=e['stride'],
                             out_scale=e['out_scale'], out_qmax=qmax,
                             iters=10, route='tile'))
    return cases


def lr_pass_cases(torch, model, g):
    from repro_torch.kernels.quant_conv import im2col_nhwc
    qmax = model.plan.a_qmax
    cases = []
    for e, p in pass_calls(torch, model, g).get('lowrank_conv', []):
        u, v = p['u'], p['v']
        kh, kw, _, r = u['w_q'].shape
        n = v['w_q'].shape[-1]
        patches, _ = im2col_nhwc(rand_i8(torch, g, *e['in_shape']), kh, kw,
                                 e['stride'])
        cases.append(lr_case(torch, patches, u['w_q'].reshape(-1, r),
                             v['w_q'].reshape(r, n), u['scale'], v['scale'],
                             u['b'], v['b'], sx=e['sx'],
                             h_scale=e['h_scale'], out_scale=e['out_scale'],
                             h_qmax=qmax, out_qmax=qmax, iters=10))
    return cases


def fc_weights(params):
    """The 2-D weights the calibration forward fake-quantizes on the card
    (``fake_quant_fused``): the head and every exit head, both halves of a
    factored one."""
    out = []
    for p in [params['head']] + [params['exits'][k]
                                 for k in sorted(params['exits'])]:
        out += [p['u']['w'], p['v']['w']] if 'u' in p else [p['w']]
    return out


KERNEL_META = {   # name: (route, source, the TPU kernel it replaces, match)
    'quant_matmul': ('cuda', 'src/repro_torch/kernels/csrc/quant_matmul.cu',
                     'src/repro/kernels/quant_matmul.py:109',
                     QMM_DEVICE_NAMES),
    'fake_quant_fused': ('cuda', 'src/repro_torch/kernels/csrc/fake_quant.cu',
                         'src/repro/kernels/fake_quant.py:101',
                         FQ_KERNELS['fake_quant_fused'][1]),
    'depthwise_conv': ('cuda', 'src/repro_torch/kernels/csrc/'
                       'depthwise_conv.cu',
                       'src/repro/kernels/depthwise_conv.py:129',
                       DW_DEVICE_NAMES),
    'lowrank_conv': ('cuda', 'src/repro_torch/kernels/csrc/lowrank_conv.cu',
                     'src/repro/kernels/lowrank_conv.py:203',
                     LR_DEVICE_NAMES),
    'fake_quant': ('cuda', 'src/repro_torch/kernels/csrc/fake_quant.cu',
                   'src/repro/kernels/fake_quant.py:70',
                   FQ_KERNELS['fake_quant'][1]),
}
# the routes of the wrappers that have more than one kernel
ROUTES = {'quant_matmul': ('wgmma', 'mma_sync'),
          'lowrank_conv': ('wgmma', 'mma_sync'),
          'depthwise_conv': ('tile', 'general')}
# the second pallas_call a wrapper replaces (the reference's two-pass
# quantize)
ALSO_REPLACES = {'fake_quant': 'src/repro/kernels/fake_quant.py:78'}


def phase_report(torch, served, launches, qat_calls, dyn_cases):
    """Hold every kernel call one full-depth pass of each served path makes,
    and every fake-quant call of one training step of paths (f), (g) and
    (h) (``qat_calls``: path key -> [(wrapper, weight, bits)]), against its
    plain version, and time them; ``served`` maps a path key to (model,
    params), ``dyn_cases`` a dynamic-scale path's key to its cases, made
    from the calls of one pass at their own inputs.  A kernel's line
    reports the path that calls it most, with every path's pass under
    ``by_path``."""
    g = torch.Generator(device='cuda').manual_seed(SEED + 7)
    per_path = {}
    for key, (model, params) in served.items():
        per_path[key] = {
            'quant_matmul': qmm_pass_cases(torch, model, g),
            'fake_quant_fused': [fq_case(torch, w, bits=model.cfg.w_bits,
                                         iters=10)
                                 for w in fc_weights(params)],
            'depthwise_conv': dw_pass_cases(torch, model, g),
            'lowrank_conv': lr_pass_cases(torch, model, g)}
    per_path.update((k, dict(v)) for k, v in dyn_cases.items())
    for key, calls in qat_calls.items():
        per_path.setdefault(key, {})
        for name, w, bits in calls:
            per_path[key].setdefault(name, []).append(
                fq_case(torch, w, name, bits, iters=5))
    for key in per_path:
        for name, cs in per_path[key].items():
            for c in cs:
                print(fmt_case(f'{name}[{key}]', c)
                      + (f"; {c['plan']}" if 'plan' in c else ''))
                need_exact(c, name)
        if per_path[key].get('quant_matmul'):
            by = {}
            for c in per_path[key]['quant_matmul']:
                by[c['route']] = by.get(c['route'], 0) + 1
            print(f'[report] quant_matmul[{key}]: every call of the pass '
                  f'bit-exact, by route {by} (K % 16 == 0 on wgmma)')
        if per_path[key].get('lowrank_conv'):
            cs = per_path[key]['lowrank_conv']
            off = [c['shape'] for c in cs
                   if (c['shape'][1] % 16 == 0) != (c['route'] == 'wgmma')]
            if off:
                fail(f'lowrank_conv[{key}]: calls off the operand rule\'s '
                     f'route at {off}')
            by = {}
            for c in cs:
                by[c['route']] = by.get(c['route'], 0) + 1
            print(f'[report] lowrank_conv[{key}]: all {len(cs)} calls of the '
                  f'pass bit-exact, by route {by} (K1 % 16 == 0 on wgmma)')
        if per_path[key].get('depthwise_conv'):
            cs = per_path[key]['depthwise_conv']
            print(f'[report] depthwise_conv[{key}]: all {len(cs)} calls of '
                  f'the pass bit-exact, every one on the tile route')

    def total(cs, k):
        return sum(c[k] for c in cs)

    out = []
    for name, (route, source, replaces, match) in KERNEL_META.items():
        paths = {k: v[name] for k, v in per_path.items() if v.get(name)}
        if not paths:
            fail(f'{name}: no call on any path')
        top = max(paths, key=lambda k: len(paths[k]))
        cs = paths[top]
        out.append({
            'name': name, 'route': route, 'source': source,
            'replaces': replaces,
            **({'also_replaces': ALSO_REPLACES[name]}
               if name in ALSO_REPLACES else {}),
            'launches': sum(launches[k][name] for k in launches),
            'max_abs_err': max(c['max_abs_err'] for v in paths.values()
                               for c in v),
            'ms': total(cs, 'ms'), 'plain_ms': total(cs, 'plain_ms'),
            'bound_ms': total(cs, 'bound_ms'),
            'bound_by': max(('bytes', 'operations'), key=lambda b: sum(
                c['bound_ms'] for c in cs if c['bound_by'] == b)),
            'library_ms': total(cs, 'library_ms'),
            'device_ms': device_ms(torch, [c['call'] for c in cs], match,
                                   iters=5),
            'pass_of': top, 'calls_per_pass': len(cs),
            'launches_by_path': {k: launches[k][name] for k in launches},
            **({'serving_routes': {'quant_matmul': QMM_ROUTES,
                                   'lowrank_conv': LR_ROUTES,
                                   'depthwise_conv': DW_ROUTES}[name],
                'calls_by_route': {r: sum(c['route'] == r for c in cs)
                                   for r in ROUTES[name]}}
               if name in ROUTES else {}),
            'by_path': {k: {'calls_per_pass': len(v),
                            'exact': all(c['exact'] for c in v),
                            'ms': total(v, 'ms'),
                            'plain_ms': total(v, 'plain_ms'),
                            'bound_ms': total(v, 'bound_ms'),
                            'library_ms': total(v, 'library_ms')}
                        for k, v in paths.items()}})
    return out


LM_KERNEL_META = {   # name: (route, source, the TPU kernel it replaces)
    'decode_attention': ('cuda', 'src/repro_torch/kernels/csrc/'
                         'decode_attention.cu',
                         'src/repro/kernels/decode_attention.py:147'),
    'decode_attention_int8': ('cuda', 'src/repro_torch/kernels/csrc/'
                              'decode_attention.cu',
                              'src/repro/kernels/decode_attention.py:115'),
}


def lm_report(torch, lm_calls, lm_launches):
    """Hold every decode-attention call of one decode step of each LM path
    (22 each) against its plain version at DECODE_TOL and time them;
    ``lm_calls`` maps a path key to its (kernel, captured calls)."""
    per_path = {}
    for key, (name, calls) in lm_calls.items():
        cs = []
        for q, c, valid in calls:
            args = (q, c['k'], c['v'], c['k_s'], c['v_s']) if 'k_s' in c \
                else (q, c['k'], c['v'])
            kind = 'int8' if 'k_s' in c else (
                'bf16' if q.dtype == torch.bfloat16 else 'fp32')
            cs.append(da_case(torch, args, valid, kind, iters=10))
        for i, c in enumerate(cs):
            print(fmt_da_case(f'{name}[{key}, layer {i}]', c))
            need_within(c, name)
        per_path[key] = (name, cs)
    out = []
    for name, (route, source, replaces) in LM_KERNEL_META.items():
        paths = {k: cs for k, (n, cs) in per_path.items() if n == name}
        if not paths:
            fail(f'{name}: no call on any path')
        top = max(paths, key=lambda k: len(paths[k]))
        cs = paths[top]
        out.append({
            'name': name, 'route': route, 'source': source,
            'replaces': replaces,
            'launches': sum(v[name] for v in lm_launches.values()),
            'max_abs_err': max(c['max_abs_err'] for v in paths.values()
                               for c in v),
            'ms': sum(c['ms'] for c in cs),
            'plain_ms': sum(c['plain_ms'] for c in cs),
            'bound_ms': sum(c['bound_ms'] for c in cs),
            'bound_by': max(('bytes', 'operations'), key=lambda b: sum(
                c['bound_ms'] for c in cs if c['bound_by'] == b)),
            'library_ms': sum(c['library_ms'] for c in cs),
            'device_ms': device_ms(torch, [c['call'] for c in cs],
                                   DA_DEVICE_NAME[name], iters=5),
            'max_rel_err': max(c['rel_err'] for v in paths.values()
                               for c in v),
            'pass_of': top, 'calls_per_pass': len(cs),
            'launches_by_path': {k: v[name] for k, v in lm_launches.items()},
            'by_path': {k: {'calls_per_pass': len(v),
                            'within': all(c['within'] for c in v),
                            'ms': sum(c['ms'] for c in v),
                            'plain_ms': sum(c['plain_ms'] for c in v),
                            'bound_ms': sum(c['bound_ms'] for c in v),
                            'library_ms': sum(c['library_ms'] for c in v)}
                        for k, v in paths.items()}})
    return out



def main():
    sys.stdout.reconfigure(line_buffering=True)
    import functools
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke test needs a '
             'card')
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f'the port (src/repro_torch) is not beside this script: {e}')
    from repro_torch.core.chain import Pipeline
    from repro_torch.core.export import export_cnn
    from repro_torch.core.family import CNNFamily
    from repro_torch.data import SyntheticImages
    t_start = time.perf_counter()
    print(f'[card] {smi_line()}')
    print(f'[card] torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)} x '
          f'{torch.cuda.device_count()}')
    phase_build()
    print(f'[time] build done at {time.perf_counter() - t_start:.1f} s')
    torch.backends.cuda.matmul.allow_tf32 = False
    launch_us = phase_kernels(torch, path_model(torch, PATHS[2])[1])
    phase_decode_kernels(torch)
    print(f'[time] kernels done at {time.perf_counter() - t_start:.1f} s')
    served, launches = {}, {}
    for spec in PATHS:
        model, params, counted, _ = serve_path(torch, spec, launch_us)
        served[spec['key']] = (model, params)
        launches[spec['key']] = counted
        print(f"[time] path {spec['key']} done at "
              f"{time.perf_counter() - t_start:.1f} s")
    lm_calls, lm_launches = {}, {}
    for spec in LM_PATHS:
        counted, calls, _ = serve_lm_path(torch, spec)
        lm_calls[spec['key']] = (spec['kernel'], calls)
        lm_launches[spec['key']] = counted
        print(f"[time] path {spec['key']} done at "
              f"{time.perf_counter() - t_start:.1f} s")
    launches[QAT_KEY], qat_calls, _ = train_lm_path(torch)
    print(f"[time] path {QAT_KEY} done at "
          f"{time.perf_counter() - t_start:.1f} s")
    model, params, launches[CHAIN_KEY], chain_calls, chain = chain_path(
        torch, launch_us)
    served[CHAIN_KEY] = (model, params)
    print(f"[time] path {CHAIN_KEY} done at "
          f"{time.perf_counter() - t_start:.1f} s")
    dyn = {}
    for spec in PATHS + (None,):
        if spec is None:                 # (g'): the chain, Pipeline.export
            st = chain['state']
            key, fam, p, cfg = CHAIN_KEY, st.family, st.params, st.cfg
            kern = ('quant_matmul',)
            export = functools.partial(
                Pipeline.from_sequence(CHAIN_SEQUENCE, CHAIN_HPS).export, st,
                device='cuda')
        else:
            key, (model, p) = spec['key'], served[spec['key']]
            fam, cfg = CNNFamily(SyntheticImages(), device='cuda'), model.cfg
            kern = tuple(k for k in ('quant_matmul', 'depthwise_conv')
                         if k in spec['kernels'])
            export = functools.partial(export_cnn, p, cfg, device='cuda')
        key += '-dynamic'
        launches[key], dyn[key], _ = dynamic_path(
            torch, key, export, p, cfg, fam, kern, serve=spec is PATHS[0])
        print(f"[time] path {key} done at "
              f"{time.perf_counter() - t_start:.1f} s")
    del chain
    launches[H_KEY], h_calls, h_decode, _ = lm_chain_path(torch)
    lm_calls[H_KEY] = ('decode_attention', h_decode)
    lm_launches[H_KEY] = launches[H_KEY]
    print(f"[time] path {H_KEY} done at "
          f"{time.perf_counter() - t_start:.1f} s")
    launches[RT_KEY], served[RT_KEY + '-measure'], _ = runtime_path(torch)
    print(f"[time] path {RT_KEY} done at "
          f"{time.perf_counter() - t_start:.1f} s")
    kernels = phase_report(torch, served, launches,
                           {QAT_KEY: qat_calls, CHAIN_KEY: chain_calls,
                            H_KEY: h_calls}, dyn) + \
        lm_report(torch, lm_calls, lm_launches)
    # the time each kernel loses to its bound over all its launches in the
    # counted runs (its device time where the profiler measured one): the
    # order in which ROADMAP queue B redesigns the kernels
    for k in kernels:
        t = k['ms'] if k['device_ms'] is None else k['device_ms']
        k['excess_ms'] = k['launches'] * (t - k['bound_ms']) / \
            k['calls_per_pass']
    print(f'[done] {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
