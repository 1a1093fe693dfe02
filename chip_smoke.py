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
   memory allows); then gemma2-9b's decode call (B, H, K, D, S) = (8, 16,
   8, 256, 584), bf16 and int8-KV, with its attention softcap 50 and
   without (the yardstick then computes the function without the cap), a
   row with every slot masked under the softcap, and the fp32 cache at
   head_dim 256 (3 warps, the fewest of any plan); each line ends with the
   split kernel's plan (S split over a cluster, the same kernel for the
   three caches) and the instantiation's registers and spills;
   mixtral-8x7b's call (8, 32, 8, 128, 584), a group of 4, bf16 and
   int8-KV; last recurrentgemma-9b's MQA call (8, 16, 1, 256, 584), a
   group of 16 at head_dim 256 that runs as two chunks of 8 in one launch
   (the plan names its chunks), bf16 and int8-KV.
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
   on a small batch, on the same static scales, layer by layer: the CPU
   export runs with every static requantize outside the kernels (the
   input's, each glue's, each head's pooled feature) fed the card's int8
   codes (``static_sites``, ``fed_check``), every code that differs there
   must be one step from the card's and within ``TIE_TOL`` of a rounding
   tie, and the fed logits must agree within 4e-2 x max|logit| (the unfed
   difference and the first code that flips, with its x/s on each side,
   printed).
   Then two LM decode paths through the functions ``launch/serve.py``
   uses, ``tinyllama-1.1b`` at full width and depth, random weights from a
   CUDA generator seeded 0, batch 8, prompt 512, 64 greedy decode tokens,
   after a warm-up: (d) bf16 weights and cache on ``decode_attention``;
   (e) ``export_lm`` int8 weights and ``kv_cache_bits=8`` on
   ``decode_attention_int8``.  Counted from zero: the path's kernel
   launches 22 x 64 times, the other decode kernel and the plain versions
   never.  Printed: prefill ms, ms/token, tokens/s, peak memory, and under
   the profiler ``LM_PROFILE_STEPS`` more steps' device busy share and the kernel's share of
   device time.  Gates: the first-step logits within ``LM_PLAIN_TOL`` x
   max|logit| of the same model on the kernels' plain versions on the
   card (where the gap passes that limit, the model's rounding
   sensitivity is measured: the plain path with one output of its first
   decode-attention call one bf16 ulp up; where that alone moves the
   logits more than ``LM_PLAIN_TOL``, as recurrentgemma-9b's on path (o),
   the limit becomes ``LM_SENS_FACTOR`` x the sensitivity, else it
   stays: ``first_step_sensitivity``); a 2-layer
   fp32 cut of the config (batch 2, prompt 32, 4 steps, TF32 off) within
   ``LM_CPU_TOL`` of the port's CPU path.
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
   Then (j) the analyzer (``repro_torch.analysis``) on the card, counted
   from zero: (g)'s pipeline was built with
   ``Pipeline.from_sequence(..., verify_order=True)``; all 120 orders of
   DPLQE linted by ``Pipeline.verify_order`` (the green ones must be the
   orders ``planner.theoretical_dag`` allows); (a)-(c) exported again at
   full width with ``export_cnn(verify='strict')`` on 32 images and (g)'s
   served chain export checked with ``analysis.check(strict=True)``, each
   report printed (the rules run and skipped with their reasons, the
   kernel calls recorded against the wrappers' counters with no plain
   call, op-traffic's measured over predicted bytes); each export's
   recorded writes on the card and on the CPU for one ``fn`` call on 2
   images (the first op that differs named); and the CI gate
   ``analysis.gate.main(['--device', 'cuda'])``, which must return 0.
   After (j), (k) ``gemma2-9b`` at its published width and depth (42 layers,
   local/global, window 4096, d_model 3584, 16/8 heads of 256, softcaps
   50/30, a tied 256000-row embedding: 9.24 G parameters) served as (d)
   and (e), bf16 weights and cache on ``decode_attention`` with the
   softcap, then ``export_lm`` int8 weights and ``kv_cache_bits=8`` on
   ``decode_attention_int8``: 42 launches a token, the other decode kernel
   and the plain versions never; printed as (d), with the computed
   weight-streaming bound; gated as (d) on the first-step logits against
   the plain decode and a 2-layer fp32 cut (one local, one global layer)
   against the CPU.  Then (l) the other dense-attention archs at their
   published widths, bf16, unprofiled, each gated the same way:
   ``gemma3-12b`` at prompt 1536, its 40 local layers' 1024-slot rings
   wrapped (checked slot by slot); ``qwen2-72b`` cut to 16 of its 80
   layers (QKV bias; its fp32 cut one layer); ``internvl2-2b`` whole, 256 zero patch rows before a
   512-token prompt, decoding from position 768; ``whisper-small`` whole,
   its 12-layer encoder over 1500 frames, a 64-token prompt and 64 steps
   with cross-attention.  Each model is freed before the next is built;
   each path's seconds are printed.  Then (m) ``mixtral-8x7b`` at its
   published width cut in depth only to 12 of its 32 layers (8 experts
   of 14336 top-2 at capacity factor 1.25, every layer local: 17.68 G
   parameters), served as (k): bf16, then ``export_lm`` int8 weights
   (experts included, quantized slice by slice) with an int8 cache, 12
   decode-kernel launches a token; each leg profiled over ``LM_PROFILE_STEPS`` steps with
   the device ms inside ``moe_block``, inside the int8 experts'
   dequantization and of ``aten::bmm``.  Then (n) ``deepseek-v3-671b``
   at its published width cut to its 3 dense layers and one MoE layer
   (256 experts of 2048 top-8 and a shared one, MLA: 15.11 G parameters),
   bf16, MLA decoding in torch ops: no decode kernel may launch.  Each
   has an fp32 cut against the CPU at ``MOE_CPU_TOL``
   (``MOE_KV8_CPU_TOL`` with the int8 cache; mixtral's one layer,
   deepseek's one dense and one MoE layer with 32 of the 256 experts), every MoE routing
   recorded on both devices and a token routed apart only at a near-tie
   (``MOE_NEAR_TIE``); on the bf16 legs' cuts ``export_lm`` on the card
   against the CPU's, bit for bit, and on mixtral's ``LMFamily.prune``
   keeping the same 5 experts on both devices.  Then (o)
   ``recurrentgemma-9b`` at its published width and depth (38 layers:
   RG-LRU blocks of width 4096 and 12 local MQA layers, 16 query heads
   over one kv head of 256: 9.396 G parameters), served as (k): bf16,
   then ``export_lm`` int8 weights with an int8 cache on the local
   layers, 12 decode-kernel launches a token (the group of 16 in two
   chunks); and (p) ``mamba2-2.7b`` at its published width and depth (64
   SSD layers, d_inner 5120, 80 heads of 64, state 128, chunk 256: 2.831
   G parameters), bf16 then int8 weights, no decode kernel (its counters
   must read 0).  Each leg prints the weight-streaming bound with the
   recurrent state read and written once a step, and profiles a prefill
   and ``LM_PROFILE_STEPS`` decode steps with the device ms inside the
   recurrent blocks
   (``profile_recurrent``: the scan, the gates, ``ssd_chunked``, the
   products and their int8 dequant).  Their fp32 cuts against the CPU:
   (o) one whole (rec, rec, local) group, (p) 2 layers at prompt 300 (two
   SSD chunks, the second padded); logits within ``REC_CPU_TOL`` (1e-3
   with the int8 cache), the recurrent states after the prefill within
   ``REC_STATE_TOL``, and on the bf16 legs ``export_lm`` bit for bit.
   Then (q), the training launcher and the mesh code on one rank
   (``train_mesh_path``; a world of one rank, backend nccl, its store a
   ``HashStore``; the 1 x 1 mesh, every placement ``Replicate()``): (q1)
   ``launch.train.main --drill`` at tinyllama-1.1b's published width and
   depth (bf16 params, fp32 AdamW moments), batch 8 x 128, ``Q_STEPS``
   steps, a failure at the middle step: printing ms/step (the median after
   the first), tokens/s, peak memory, the checkpoint's bytes (about 11 GB
   a step), its save seconds (the host snapshot and the write) and the
   restore's seconds, and the device busy share of one profiled step; the
   checkpoint directory goes after the leg.  (q2) the drill's check: one
   restart, and the losses step for step and the final params and moments
   bit-equal to a plain loop of the same step (``build_train_step``, as
   ``main`` wires it) with no failure and no checkpoint.  (q3) a 2-layer
   fp32 cut: one ``build_train_step`` step on the card against the same
   step on a CPU mesh (TF32 off), the loss, the grad norm and every
   moment leaf within ``Q_CPU_TOL`` x its max, every updated param within
   ``Q_NEAR_MAX`` x lr (``Q_NEAR_SHARE`` of them at most beyond
   ``Q_NEAR_LR`` x lr).  (q4)
   ``build_prefill_step`` + ``build_serve_step`` at full width, batch 8,
   prompt 512, ``Q_SERVE_TOKENS`` greedy tokens (the plain decode math,
   as the reference's mesh path runs it): the tokens equal to
   ``launch/serve.py``'s kernel path on the same weights (a token may
   differ only where the kernel path's two candidates lie within
   ``LM_PLAIN_TOL`` x max|logit|, a near tie; the steps after it are not
   compared), the first-step logits within ``LM_PLAIN_TOL`` x max|logit|.
   The mesh steps compute tensor-parallel on 'model' (``models/tp.py``)
   where the axis has more than one rank; on the card's one rank the
   policy has no tensor-parallel axis, every shard is the whole leaf, and
   (q1)-(q4) compute what the single-device step computes.  (q5)
   (``tp_parts_leg``) checks the tensor-parallel math at tinyllama-1.1b's
   full width (d_model 2048, 32 heads, 4 kv heads of 64, d_ff 5632, vocab
   32000), fp32, on a (1, ``Q5_MODEL``) layout played out in one process:
   for each of the four 'model' ranks one layer's attention and MLP on
   that rank's column and row shards through the rank-local functions
   (``attention.gqa_partial``, ``layers.mlp_partial``: the parts before
   the all-reduce), the four parts summed as the all-reduce would, within
   ``Q5_TOL`` x max|out| of the unsharded layer on the card; the
   vocab-parallel embedding's parts bit-equal to the lookup, and the
   cross-entropy from four vocab chunks' parts within ``Q5_TOL`` of the
   plain one (its lap in (q)'s ``Laps`` line).
   No kernel is on path (q): the reference's train step runs
   ``model.forward`` at quant (0, 0) and its mesh decode the plain math.
   Then (r), pipeline-parallel serving (``pipeline_path``): path (a)'s
   export (``resnet34-cifar``, exits after stages 1 and 2, int8-resident)
   served by ``PipelineParallelScheduler`` over ``R_ORDINALS`` ordinals of
   the one card (``devices=(cuda:0,) * 4``, ``place_stages``) on the
   card's measured stage costs, the 256-request trace in compacting,
   static and chaos modes (a kill at ``R_KILL_AT`` of the compacting
   makespan), counted from zero: every completion's exit stage and logits
   bit-exact against ``fn_exits`` on the request alone at 32 slots, a
   strict ``check_trace``, ``placement-consistency`` strict-green on the
   placed model, ``transfer.carry`` spans, under chaos a kill and a
   re-solve, ``quant_matmul``'s launches those of the plan over the landed
   batches (plus at most one flight's per kill), no plain call; printed:
   each placement, the simulated makespan and throughput, batches and
   carry transfers by ordinal, the wall seconds.  Then ``serve_cnn
   --server --pipeline --chaos`` in process on the card's one device,
   where the seeded kill must be ``kill_skipped``.  Then (s), the MoE
   block's expert-parallel path on the card's 1 x 1 mesh
   (``moe_ep_path``; a world of one rank, NCCL): one ``mixtral-8x7b`` MoE
   layer at its published width (8 experts of 14336, top 2, d_model
   4096), fp32, through ``moe_block`` under the mesh policy (a2a mode over
   a group of one: two all-to-alls) within ``S_TOL`` x max of the dense
   block on the card, both timed; then ``launch.train.main`` on
   ``mixtral-8x7b`` cut in depth to ``S_LAYERS`` layers at full width,
   fp32, ``S_STEPS`` steps (the launcher's loop keeping no checkpoint:
   37 GB a save at this size), with the EP path and under
   ``REPRO_MOE_MODE=dense``: loss and grad norm within ``S_TOL``
   relative, params within (q)'s AdamW band.  No TPU kernel runs on (s)
   (the expert products are ``torch.bmm``, as on (m)); the multi-rank
   collectives are checked on gloo ranks in the CPU tests only.
   Then (u), the grouped-conv fp32 fallback, served
   (``grouped_conv_path``): path (a)'s resnet34-cifar with ``U_LAYER``
   cut into ``U_GROUPS`` groups of depth 32 (its input ``U_SHAPE``),
   ``cnn_forward`` reading each conv's groups off its weight (no
   configuration has such a conv), through ``export_cnn`` at both tiers
   (calibrated with ``verify='strict'``, and dynamic) and ``serve`` on 32
   images: the served model's plan marks the layer ``fallback`` with 0
   launches and is the only fallback, ``quant_matmul`` launches as often
   as the plan counts, the one fallback call (int8 ``U_SHAPE`` codes in,
   fp32 out) within ``U_TOL`` x max|y| of ``ref.quant_conv_ref`` on the
   CPU on the same codes, and the served logits of 4 images against the
   CPU export's fed the card's codes, as (a) and (a') are held.  Last
   (t), the multi-pod dry-run (``start_dryruns`` after the timed kernel
   phases, ``dryrun_path`` here): (t1) ``python -m
   repro_torch.launch.dryrun`` on each of ``T_CELLS`` (a fake world of
   256 or 512 ranks, fake tensors on the card's device type), each in a
   process of its own beside the paths, its record printed, its argument
   bytes equal to the sharding rules' shard bytes, its collective kinds
   among ``T_KINDS``; (t2) the dry-run of (q1)'s step (the 1 x 1 mesh, 8
   x 128): its FLOPs equal to ``FlopCounterMode`` over one more real step
   after (q2)'s comparison (``step_readings``; FlopCounterMode decomposes
   composite ops, which moves the step's bits and its peak), its argument
   + temp bytes within ``T_MEM_TOL`` of the peak memory over (q2)'s last
   plain step plus that step's params and AdamW state.
4. Every kernel call of one full-depth 32-slot pass of each CNN path,
   every decode-attention call of one decode step of (d) and (e) (22
   each), (k) (42 each, with the softcap), (l), (m) and (o) (12 each), and
   every fake-quant
   call of one step of (f), captured at its
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
   ``lowrank_conv``: (c); the decode kernels: the LM path with the most
   calls a step; both
   fake-quant wrappers: (f)), every path's pass under ``by_path``, its
   launches over all the paths' counted runs (path (g): its chain and
   its serving; (h): its chain and its decode; (i): its export, stage
   costs, SLO, pool and measure-mode runs; (j): its exports and the
   analyzer's runs; (r): its three runs and the CLI's serving; (s): none),
   and ``excess_ms``: those
   launches times (its time a call less its bound a call).

The last line of standard output is ``{"ok": true, "device": {...}}``.
This script imports no JAX and nothing of the JAX package.
"""
from __future__ import annotations

import atexit
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
LM_SPARE = 8                   # the cache's spare slots after the tokens
# decode steps under the profiler, in the spare slots: the profiler's own
# processing grows with the steps' events (about 20 s a path at 8 steps)
LM_PROFILE_STEPS = 2
LM_PATHS = (
    dict(key='tinyllama-bf16', int8_weights=False, kv_cache_bits=0,
         kernel='decode_attention', other='decode_attention_int8'),
    dict(key='tinyllama-int8', int8_weights=True, kv_cache_bits=8,
         kernel='decode_attention_int8', other='decode_attention'),
)
# Path (k): gemma2-9b (arXiv:2408.00118) at its published width and depth
# (42 layers alternating local (window 4096) and global, d_model 3584, 16
# heads over 8 kv heads of 256, attention softcap 50, logit softcap 30, a
# tied 256000-row embedding), served as (d) and (e): bf16 weights and
# cache, then export_lm int8 weights with an int8 cache
K_PATHS = (
    dict(key='gemma2-bf16', arch='gemma2-9b', int8_weights=False,
         kv_cache_bits=0, kernel='decode_attention',
         other='decode_attention_int8'),
    dict(key='gemma2-int8', arch='gemma2-9b', int8_weights=True,
         kv_cache_bits=8, kernel='decode_attention_int8',
         other='decode_attention'),
)
# Path (l): the other dense-attention archs at their published widths,
# bf16, batch 8, 64 greedy tokens, unprofiled: gemma3-12b at prompt 1536,
# so that its 40 local layers' 1024-slot rings wrap; qwen2-72b cut to 16 of
# its 80 layers (145 GB of bf16 weights whole; 33 GB cut); internvl2-2b
# whole, 256 zero patch rows before a 512-token prompt; whisper-small
# whole, its 12-layer encoder over 1500 frames and a 64-token prompt (its
# decoder holds at most 448 tokens).  qwen2's fp32 cut against the CPU is
# one layer (8.6 GB of host memory; its layers are all global)
L_PATHS = tuple(
    dict(kv_cache_bits=0, int8_weights=False, kernel='decode_attention',
         other='decode_attention_int8', profile=False, **kw)
    for kw in (dict(key='gemma3-bf16', arch='gemma3-12b', prompt=1536),
               dict(key='qwen2-bf16', arch='qwen2-72b', layers=16,
                    cut_layers=1),
               dict(key='internvl2-bf16', arch='internvl2-2b'),
               dict(key='whisper-bf16', arch='whisper-small', prompt=64)))
# Path (m): mixtral-8x7b (arXiv:2401.04088) at its published width, cut in
# depth only to 12 of its 32 layers (46.7 G parameters whole, 93.4 GB of
# bf16, which the card cannot hold; 12 layers are 17.68 G, 35.4 GB bf16,
# 17.7 GB int8, both live while the export is made): every layer local
# (window 4096), 32 heads over 8 kv heads of 128, 8 experts of 14336, top
# 2; bf16 weights and cache, then export_lm int8 weights with an int8 cache.
# Its fp32 cut, one layer (6.4 GB; every layer is alike), is held against
# the CPU at MOE_CPU_TOL (MOE_KV8_CPU_TOL with the int8 cache: codes at
# rounding ties, ROADMAP C)
MOE_CPU_TOL = 1e-4
MOE_KV8_CPU_TOL = 1e-3
M_PATHS = (
    dict(key='mixtral-bf16', arch='mixtral-8x7b', layers=12,
         int8_weights=False, kv_cache_bits=0, kernel='decode_attention',
         other='decode_attention_int8', cpu_tol=MOE_CPU_TOL, hooks=True,
         prune=True, cut_layers=1),
    dict(key='mixtral-int8', arch='mixtral-8x7b', layers=12,
         int8_weights=True, kv_cache_bits=8, kernel='decode_attention_int8',
         other='decode_attention', cpu_tol=MOE_KV8_CPU_TOL, cut_layers=1),
)
# Path (n): deepseek-v3-671b (arXiv:2412.19437) at its published width (MLA
# with q/kv ranks 1536/512, 128 heads of rope 64 + nope 128, v 128; 256
# routed experts of 2048 top-8 and a shared one; vocab 129280 untied), cut
# in depth only to 4 of its 61 layers, its 3 dense layers (d_ff 18432) and
# one MoE layer: 15.1 G parameters, 30.2 GB bf16.  bf16 only: MLA decodes
# in its latent space in torch ops (the reference has no kernel for it),
# so no decode kernel runs.  Its 2-layer fp32 cut keeps one dense and one
# MoE layer at full width with 32 of the 256 experts (16.3 GB of host
# memory; 256 would take 56 GB)
N_PATHS = (
    dict(key='deepseek-bf16', arch='deepseek-v3-671b', layers=4,
         int8_weights=False, kv_cache_bits=0, kernel=None, other=None,
         cpu_tol=MOE_CPU_TOL, hooks=True,
         cut=dict(first_dense_layers=1, n_experts=32)),
)
# Path (o): recurrentgemma-9b (arXiv:2402.19427) at its published width and
# depth: 38 layers, 12 groups of (RG-LRU, RG-LRU, local attention) then 2
# RG-LRU layers, d_model 4096, RG-LRU width 4096, MQA with 16 query heads
# over 1 kv head of 256 (the decode kernel's group of 16 at head_dim 256:
# two chunks of 8 in one launch), window 2048, d_ff 12288, a tied
# 256000-row embedding: 9.396 G parameters, 18.79 GB bf16.  bf16 weights
# and cache, then export_lm int8 weights with an int8 cache on its 12 local
# layers (the RG-LRU states stay fp32).  Its fp32 cut against the CPU is
# one whole (rec, rec, local) group at full width (about 7 GB of host
# memory), so that the cut holds a local layer and the kernel
REC_CPU_TOL = 1e-4
REC_STATE_TOL = 1e-4           # the recurrent states after the cut's prefill
O_PATHS = (
    dict(key='recurrentgemma-bf16', arch='recurrentgemma-9b',
         int8_weights=False, kv_cache_bits=0, kernel='decode_attention',
         other='decode_attention_int8', cpu_tol=REC_CPU_TOL, hooks=True,
         cut_layers=3),
    dict(key='recurrentgemma-int8', arch='recurrentgemma-9b',
         int8_weights=True, kv_cache_bits=8, kernel='decode_attention_int8',
         other='decode_attention', cpu_tol=MOE_KV8_CPU_TOL, cut_layers=3),
)
# Path (p): mamba2-2.7b (arXiv:2405.21060) at its published width and depth:
# 64 SSD layers, d_model 2560, d_inner 5120, 80 heads of 64, state 128,
# chunk 256, untied 50280-row embeddings: 2.831 G parameters, 5.66 GB
# bf16; its fp32 state is 1.36 GB at batch 8.  bf16, then export_lm int8
# weights; it has no KV cache, so kv_cache_bits does not apply.  It runs no
# TPU kernel: the decode kernels' counters must read 0.  Its 2-layer fp32
# cut runs at prompt 300: two SSD chunks, the second padded, so that the
# cut covers the padding and the inter-chunk scan on both devices
P_PATHS = (
    dict(key='mamba2-bf16', arch='mamba2-2.7b', int8_weights=False,
         kv_cache_bits=0, kernel=None, other=None, cpu_tol=REC_CPU_TOL,
         hooks=True, cut_prompt=300),
    dict(key='mamba2-int8', arch='mamba2-2.7b', int8_weights=True,
         kv_cache_bits=0, kernel=None, other=None, cpu_tol=REC_CPU_TOL,
         cut_prompt=300),
)
# a token may route to other experts on the card than on the CPU only where
# its k-th and (k+1)-th router probabilities lie within MOE_NEAR_TIE
# Path (q): the training launcher and the mesh code on the card's 1 x 1
# mesh: tinyllama-1.1b at its published width and depth through
# launch.train.main (batch 8 x 128, Q_STEPS steps), the drill cut in
# depth, a 2-layer fp32 cut against a CPU mesh, and the mesh serve steps
Q_KEY = 'tinyllama-train'
Q_STEPS = 4
Q_BATCH, Q_SEQ = 8, 128
Q_LR = 3e-4
Q_CUT_BATCH, Q_CUT_SEQ = 1, 32
Q_CPU_TOL = 1e-4
# the updated params of the cut: AdamW's first step is g / (|g| + eps)
# times lr, about +-lr whatever |g| is, so a gradient within float noise
# of 0 moves its element by up to lr either way (tests/test_torch_train.py
# holds the Q step so): no element more than Q_NEAR_MAX x lr apart, at
# most Q_NEAR_SHARE of them more than Q_NEAR_LR x lr
Q_NEAR_MAX, Q_NEAR_LR, Q_NEAR_SHARE = 0.25, 1e-2, 1e-3
Q_SERVE_TOKENS = 8
# (q5): tinyllama-1.1b's attention and MLP at full width, fp32, cut over a
# model axis of Q5_MODEL played out in one process, on Q5_BATCH x Q5_SEQ
# tokens: the ranks' parts before the all-reduce summed against the whole
# layer, and the vocab-parallel cross-entropy's chunk parts against the
# plain one, within Q5_TOL x max (relative for the loss)
Q5_MODEL = 4
Q5_BATCH, Q5_SEQ = 2, 256
Q5_TOL = 1e-5
# Path (r): pipeline-parallel serving of path (a)'s export over R_ORDINALS
# ordinals of the one card (PipelineParallelScheduler, place_stages) in
# compacting, static and chaos modes on the card's measured stage costs,
# the chaos kill at R_KILL_AT of the compacting makespan; then
# serve_cnn --pipeline --chaos on the card's one device, its Poisson rate
# R_CLI_RATE (arrivals then outlast the seeded kill's 0.6-0.9 of the
# horizon, so the kill falls inside the run, as kill_skipped)
R_KEY = 'resnet34-pipeline'
R_ORDINALS = 4
R_KILL_AT = 0.4
R_CLI_RATE = 1000.0
# Path (s): mixtral-8x7b's MoE block on the expert-parallel path under the
# card's 1 x 1 mesh policy (a2a mode over a group of one), fp32 at the
# published width, against the dense block; then launch.train cut in depth
# to S_LAYERS layers at full width, fp32, S_STEPS steps with the EP path
# and the same steps under REPRO_MOE_MODE=dense
S_KEY = 'mixtral-ep'
S_ARCH = 'mixtral-8x7b'
S_BATCH, S_SEQ = 8, 128
S_TOL = 1e-5
S_LAYERS, S_STEPS = 2, 3
S_TRAIN_BATCH, S_TRAIN_SEQ = 2, 128
MOE_NEAR_TIE = 1e-6
MOE_PRUNE_RATIO = 0.3          # mixtral's cut keeps max(2, int(8 x 0.7)) = 5
# (t): the multi-pod dry-run, each cell in a process of its own started
# after the timed kernel phases and run beside the other paths (fake
# tensors on the card's device type: no memory, no kernel); T_WAIT_S from
# their start
T_CELLS = (('tinyllama-1.1b', 'train_4k', 'pod'),
           ('deepseek-v3-671b', 'decode_32k', 'pod'),
           ('mamba2-2.7b', 'long_500k', 'multipod'))
T_WAIT_S = 900
T_KINDS = ('all-gather', 'all-reduce', 'reduce-scatter', 'all-to-all',
           'collective-permute')
# (t2): the dry-run's argument + temp bytes of (q1)'s step against the
# card's peak over a plain step of it (argument bytes added), either way
T_MEM_TOL = 0.25
# (u): the grouped-conv fp32 fallback: path (a)'s resnet34-cifar with the
# second conv of stage 1's second block cut into U_GROUPS groups (per-group
# depth 32; its input U_SHAPE at a batch of 32 images)
U_BLOCK, U_GROUPS = (1, 1), 4
U_LAYER = 's1b1.conv2'
U_SHAPE = (32, 16, 16, 128)
U_TOL = 1e-5                   # x max|y|: card against CPU, fp32 convs
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
# Where one output of the first decode-attention call one bf16 ulp up moves
# a model's first-step logits more than LM_PLAIN_TOL x max|logit| (its
# sensitivity), the first-step limit is this many times the sensitivity:
# the kernel's and the plain version's roundings differ in a few outputs
# by a few ulps, and their gap read 0.79 and 1.06 x the sensitivity on
# recurrentgemma-9b's two legs (PERF.md's findings)
LM_SENS_FACTOR = 2
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
VERIFY_KEY = 'verify'          # path (j): the analyzer on the card
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


# ptxas's registers and spill line of every compiled kernel, by its
# mangled name (filled by phase_build)
BUILD_REGS = {}


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


class Laps:
    """Wall seconds of a path's sections, in order: ``laps(name)`` closes
    the section that began at the previous call (or at construction)."""

    def __init__(self):
        self.t, self.secs = time.perf_counter(), {}

    def __call__(self, name):
        t = time.perf_counter()
        self.secs[name] = self.secs.get(name, 0.0) + t - self.t
        self.t = t

    def __str__(self):
        return ', '.join(f'{k} {v:.1f}' for k, v in self.secs.items())


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


def _profiled(torch, fn):
    """Run ``fn`` under torch.profiler (CPU and CUDA): (wall ms, the
    profiler's averaged events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, prof.key_averages()


def _device_kernels(events, skip=()):
    """(device kernel ms, top kernels by device time) of profiled events,
    leaving out the keys in ``skip``; the ms is None when the profiler saw
    no device activity (it is then not measured)."""
    from torch.autograd import DeviceType
    kernels = [(getattr(e, 'device_time_total', 0.0) / 1e3, e.count, e.key)
               for e in events if e.device_type == DeviceType.CUDA
               and e.key not in skip]
    busy = sum(ms for ms, _, _ in kernels)
    return (busy if kernels else None), sorted(kernels, reverse=True)


def profile_device(torch, fn):
    """Run ``fn`` under torch.profiler: (wall ms, device kernel ms, top
    kernels by device time).  Device time is None when the profiler saw no
    device activity (it is then not measured)."""
    wall, events = _profiled(torch, fn)
    return (wall, *_device_kernels(events))


def profile_parts(torch, fn, targets, ops):
    """:func:`profile_device` with the device ms of the kernels launched
    inside each function of ``targets`` ({part: (module, attribute)}; each
    runs inside a profiler range of that name for the call, and the
    ranges' own device-side spans are left out of the device time) and by
    each aten op of ``ops``: (wall ms, device ms, top kernels, {part:
    device ms}).  Nested parts overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function
    saved = {name: getattr(m, a) for name, (m, a) in targets.items()}

    def ranged(name, f):
        def run(*args, **kw):
            with record_function(name):
                return f(*args, **kw)
        return run
    for name, (m, a) in targets.items():
        setattr(m, a, ranged(name, saved[name]))
    try:
        wall, events = _profiled(torch, fn)
    finally:
        for name, (m, a) in targets.items():
            setattr(m, a, saved[name])
    parts = {k: sum(getattr(e, 'device_time_total', 0.0) for e in events
                    if e.key == k and e.device_type == DeviceType.CPU) / 1e3
             for k in (*targets, *ops)}
    return (wall, *_device_kernels(events, skip=targets), parts)


def profile_moe(torch, fn):
    """:func:`profile_parts` inside ``moe.moe_block`` (routing, dispatch,
    the expert products, the combine, the shared expert), inside
    ``moe._maybe_quant_w`` (the int8 experts' dequantization) and of
    ``aten::bmm`` (the expert products; MLA's einsums too)."""
    from repro_torch.models import moe
    return profile_parts(torch, fn, {
        'moe_block': (moe, 'moe_block'),
        'moe_dequant': (moe, '_maybe_quant_w')}, ('aten::bmm',))


def profile_recurrent(torch, fn):
    """:func:`profile_parts` inside the recurrent blocks
    (``models/recurrent.py``): a decode step's ``rglru_decode`` and
    ``mamba2_decode``; RG-LRU's gates (``_rglru_gates``); the prefill's
    ``linear_scan`` and ``ssd_chunked``; inside every ``dense`` (the
    products with, for int8 weights, the dequant before each) and of
    ``aten::mm`` (the products alone)."""
    from repro_torch.models import attention, layers, recurrent
    targets = {k: (recurrent, k) for k in (
        'rglru_decode', 'mamba2_decode', '_rglru_gates', 'linear_scan',
        'ssd_chunked')}
    targets.update({f'dense ({m.__name__.rsplit(".", 1)[-1]})': (m, 'dense')
                    for m in (layers, attention, recurrent)})
    return profile_parts(torch, fn, targets, ('aten::mm',))


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
                BUILD_REGS[fn] = (int(regs), spill)
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
    """Decode-attention operands (tinyllama's head shapes by default):
    ``kind`` fp32, bf16 (q, k, v in that type) or int8 (bf16 q, an int8
    cache with fp32 scales from ``kv_quantize``).  Returns (args, valid)."""
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
    dequantized first, inside the call).  It takes no softcap: beside a
    softcapped call it computes the function without the cap."""
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


def da_case(torch, args, valid, kind, iters=20, cap=0.0):
    """Decode-attention kernel vs its plain version on one call (with the
    attention softcap ``cap``, 0 = off): the error relative to max|plain|
    against DECODE_TOL, and times.  Bound: the k/v rows of the valid
    slots (and their scales), q, the mask and the output once at 3.35
    TB/s, against 4*B*H*D flops a valid slot at the card's fp32 rate."""
    import functools
    from repro_torch.kernels import decode_attention as da
    int8 = len(args) == 5
    fn = functools.partial(
        da.decode_attention_int8 if int8 else da.decode_attention,
        attn_softcap=cap)
    plain = functools.partial(
        da.decode_attention_int8_plain if int8 else
        da.decode_attention_plain, attn_softcap=cap)
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
            'cap': cap, 'max_abs_err': err, 'rel_err': err / max(scale,
                                                                  1e-30),
            'within': err <= DECODE_TOL[kind] * scale,
            'library_rel_err': max_err(torch, lib_out, want) / scale,
            'call': call, 'ms': time_ms(torch, call, iters),
            'plain_ms': time_ms(torch, lambda: plain(*args, valid), iters),
            'library_ms': time_ms(torch, lib, iters),
            'bound_ms': b_ms, 'bound_by': b_by}


def fmt_da_case(name, c):
    dev = c.get('device_ms')
    return (f"[kernel] {name} {c['kind']} (B,H,K,D,S)={c['shape']} "
            f"valid={c['n_valid']}"
            + (f" softcap={c['cap']:g}" if c['cap'] else '')
            + f": rel_err={c['rel_err']:.3e} (limit "
            f"{DECODE_TOL[c['kind']]:g}) ms={c['ms']:.4f}"
            + ('' if 'device_ms' not in c else ' device_ms=' + (
                'not measured' if dev is None else f'{dev:.4f}'))
            + f" plain_ms={c['plain_ms']:.4f} library_ms="
              f"{c['library_ms']:.4f} ("
            + ('library without the softcap' if c['cap'] else
               f"library rel_err {c['library_rel_err']:.2e}")
            + f") bound_ms={c['bound_ms']:.5f} "
              f"({c['bound_by']})")


def need_within(c, name):
    if not c['within']:
        fail(f"{name} disagrees with its plain version at {c['shape']} "
             f"({c['kind']}): rel_err {c['rel_err']:.3e}")


def da_plan(args):
    """The split kernel's launch plan for a decode case, for its line."""
    from repro_torch.kernels.decode_attention import (group_split,
                                                      split_plan,
                                                      split_smem_bytes)
    q, k = args[0], args[1]
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    elem = k.element_size()
    G, chunks = group_split(H // K, D)
    c, spb, warps = split_plan(B, K, S, elem=elem, D=D, G=G, chunks=chunks)
    tq = 'f' if q.element_size() == 4 else '13__nv_bfloat16'
    tkv = {1: 'a', 2: 'S1_', 4: 'f'}[elem]
    inst = f'decode_split_kernelI{tq}{tkv}Li{D}ELi{G}E'
    regs = [f'{r} registers; {sp}' for fn, (r, sp) in BUILD_REGS.items()
            if inst in fn]
    return (f'split C={c} slots/block={spb} warps={warps} '
            + (f'group chunks={chunks} of {G} heads ' if chunks > 1 else '')
            + f'{K * chunks * B * c} blocks, '
            f'{split_smem_bytes(warps, G, D, elem)} B shared; <{D}, {G}> '
            + (regs[0] if regs else 'registers not read (library cached)'))


def phase_decode_kernels(torch):
    """Both decode-attention wrappers (one split kernel) against their
    plain versions at tinyllama's shapes: B 1 and 8, S 584 (the served
    cache) and 2048, a valid prefix, and a case with a hole; fp32, bf16 and
    int8-KV; the int8 cache with a prefix of 40 valid slots (blocks 1-7 of
    each cluster hold masked slots only); an fp32 cache at head_dim 128 (6
    warps, the most its shared memory allows); gemma2-9b's calls at head_dim
    256; mixtral-8x7b's group of 4 at head_dim 128 and recurrentgemma-9b's
    group of 16 at head_dim 256 (two chunks), bf16 and int8-KV."""
    g = torch.Generator(device='cuda').manual_seed(SEED + 11)
    cases = [(kind, B, S, S * 7 // 8, hole, 64)
             for kind in ('fp32', 'bf16', 'int8')
             for B, S in ((1, 584), (8, 584), (8, 2048))
             for hole in ((False, True) if (B, S) == (8, 584) else (False,))]
    cases += [('int8', 8, 584, 40, False, 64),
              ('fp32', 1, 2048, 2048 * 7 // 8, False, 128)]
    cases = [c + ((32, 4, 0.0),) if c[-1] == 64 else c + ((16, 4, 0.0),)
             for c in cases]
    # gemma2-9b's decode call (B, H, K, D, S) = (8, 16, 8, 256, 584), bf16
    # and int8-KV, with its attention softcap 50 and without; a row whose
    # slots are all masked under the softcap; the fp32 cache at head_dim
    # 256, where the plan has the fewest warps (3)
    cases += [(kind, 8, 584, 584 - 8, False, 256, (16, 8, cap))
              for kind in ('bf16', 'int8') for cap in (50.0, 0.0)]
    cases += [('bf16', 8, 584, 0, False, 256, (16, 8, 50.0)),
              ('int8', 8, 584, 0, False, 256, (16, 8, 50.0)),
              ('fp32', 8, 584, 584 - 8, False, 256, (16, 8, 50.0))]
    # mixtral-8x7b's decode call (8, 32, 8, 128, 584): group 4 at head_dim
    # 128, bf16 and int8-KV (path m)
    cases += [(kind, 8, 584, 584 - 8, False, 128, (32, 8, 0.0))
              for kind in ('bf16', 'int8')]
    # recurrentgemma-9b's decode call (8, 16, 1, 256, 584): MQA, a group of
    # 16 at head_dim 256 in two chunks of 8, bf16 and int8-KV (path o)
    cases += [(kind, 8, 584, 584 - 8, False, 256, (16, 1, 0.0))
              for kind in ('bf16', 'int8')]
    for kind, B, S, valid_len, hole, D, (H, K, cap) in cases:
        args, valid = da_inputs(torch, g, B, S, kind, valid_len=valid_len,
                                hole=hole, H=H, K=K, D=D)
        name = 'decode_attention_int8' if kind == 'int8' else \
            'decode_attention'
        c = da_case(torch, args, valid, kind, cap=cap)
        c['device_ms'] = device_ms(torch, [c['call']], DA_DEVICE_NAME[name])
        print(fmt_da_case(name + ('[hole]' if hole else '')
                          + ('[all masked]' if not valid_len else ''), c)
              + '; ' + da_plan(args))
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


def fed_calibration(torch, params, cfg, card, x):
    """The CPU's calibration forward (``calibration_tensors``) on ``x``
    with every conv's and fc's input replaced by the card's (the ``'sx'``
    tensors of the card's record ``card``): each layer computes from the
    card's input, so a code flipped at a rounding tie cannot carry into
    later layers, and each scale differs only by its own layer's
    rounding."""
    from repro_torch.core.export import calibration_tensors, cnn_lib
    inputs = {name: v.cpu() for name, key, v in card if key == 'sx'}
    forward = cnn_lib.cnn_forward

    def fed_forward(params, cfg, x, *, conv_fn, fc_fn, **kw):
        def conv(p, cx, **k):
            return conv_fn(p, inputs[k['name']], **k)

        def fc(p, cx, **k):
            return fc_fn(p, inputs[k['name']], **k)
        return forward(params, cfg, x, conv_fn=conv, fc_fn=fc, **kw)
    cnn_lib.cnn_forward = fed_forward
    try:
        return calibration_tensors(params, cfg, x)
    finally:
        cnn_lib.cnn_forward = forward


def check_calibrations(torch, tag, params, cfg, x):
    """The card's calibration forward against the CPU's on the same batch,
    scale by scale in forward order (``compare_calibrations``).  Up to the
    first activation whose fake-quant codes differ, every scale agrees
    within SCALE_RTOL_EXACT; the codes that differ there move one step and
    lie within TIE_TOL of a rounding tie (the two devices' fp32 convs
    round their sums differently, by ulps); after it, scales agree within
    SCALE_RTOL.  Where they do not, the flips' drift must be all of the
    gap: the CPU forward fed the card's layer inputs
    (:func:`fed_calibration`) then agrees with the card on every scale
    within SCALE_RTOL_EXACT.  Returns the readings."""
    from repro_torch.core.export import (calibration_tensors,
                                         compare_calibrations)
    card = calibration_tensors(params, cfg, x)
    c = compare_calibrations(card, calibration_tensors(params, cfg,
                                                       x.cpu()))
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
    fed = None
    if after > SCALE_RTOL:
        fed = max(compare_calibrations(
            card, fed_calibration(torch, params, cfg, card, x.cpu()))['rel'])
        print(f"{tag}   the scales after it {after:.3e} apart, above "
              f"{SCALE_RTOL:g}: fed the card's layer inputs, the CPU's "
              f"scales agree with the card's within {fed:.3e} (limit "
              f"{SCALE_RTOL_EXACT:g})")
    if fed is not None and fed > SCALE_RTOL_EXACT:
        fail(f'{tag}: calibration scales disagree after the first code '
             f'flip ({after:.3e}), and fed the same layer inputs '
             f'({fed:.3e})')
    return dict(c, before=before, after=after, fed=fed)


def share_scales(src, dst):
    """Give layer plan ``dst`` the static scales of ``src`` (same model)."""
    for name, e in src.layers.items():
        for key in ('sx', 'out_scale', 'h_scale'):
            if key in e:
                dst.layers[name][key] = e[key]
    dst.glues.update(src.glues)


def static_sites(torch, fn, forced=None):
    """Run ``fn()`` recording every static requantize outside the kernel
    wrappers (``ref.requantize`` in the resident export's ``as_qact``,
    ``fc_fn`` and ``glue_fn``) in call order: ``(out, [(layer, codes, x/s)]
    on the CPU, comparisons)``.  The kernels' fused epilogues are left out:
    given the same int8 inputs they are bit-exact against their plain
    versions (phases 2 and 4).  With ``forced`` (another run's sites, in
    order; sites past its end run on their own codes) each site compares
    its codes with that run's and goes on with that run's, so every layer
    reads the other run's int8 input: per site
    the codes that differ, the largest change, the largest distance of a
    differing code's x/s from a rounding tie (k + 0.5) on the nearer side,
    and the first differing code: its flat index and x/s on each side."""
    from repro_torch.kernels import inside_wrapper, recording, ref
    real = ref.requantize
    sites, cmp = [], []

    def spy(y, out_scale, qmax=127.0):
        q = real(y, out_scale, qmax)
        if inside_wrapper():             # a plain version's epilogue
            return q
        f, name = sys._getframe(1), None
        while f is not None and name is None:
            name, f = f.f_locals.get('name'), f.f_back
        t = (y * ref.recip32(out_scale)).cpu()
        if forced is not None and len(sites) < len(forced):
            _, fq, ft = forced[len(sites)]
            step = (q.cpu().to(torch.float32) - fq.to(torch.float32)).abs()
            differ = (step > 0).reshape(-1)
            tie = torch.minimum((t - torch.floor(t) - 0.5).abs(),
                                (ft - torch.floor(ft) - 0.5).abs()).reshape(-1)
            c = {'site': len(sites), 'at': name, 'codes': int(differ.sum()),
                 'of': differ.numel(), 'step': float(step.max()),
                 'tie': float(tie[differ].max()) if bool(differ.any())
                 else 0.0}
            if bool(differ.any()):
                i = int(torch.nonzero(differ)[0])
                c.update(first=i, own=float(t.reshape(-1)[i]),
                         card=float(ft.reshape(-1)[i]),
                         first_tie=float(tie[i]))
            cmp.append(c)
            q = fq.to(y.device)
        sites.append((name, q.cpu(), t))
        return q
    ref.requantize = spy
    try:
        with recording():
            out = fn()
    finally:
        ref.requantize = real
    return out, sites, cmp


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
    # serves on the card's scales.  Its fp32 glue (GroupNorm, the pool)
    # still sums in another order than the card's, so a requantized code
    # at a tie can flip, and at W2 one flipped code moves a logit by about
    # sx x amax(w): the CPU model runs layer by layer on the card's int8
    # codes at every static requantize (static_sites), each code that
    # differs there must be one step at a rounding tie, and the logits so
    # fed must agree (the unfed difference is printed beside them).
    calib_cmp = check_calibrations(torch, tag, params, cfg, calib)
    small = calib[:4]
    gpu = export_cnn(params, cfg, device='cuda', calibrate=small,
                     select_kernels=select)
    cpu = export_cnn(params, cfg, device='cpu', calibrate=small.cpu(),
                     select_kernels=select)
    lg_gpu, sites, _ = static_sites(torch, lambda: gpu.serve(small))
    lg_gpu = lg_gpu.cpu()
    own = float((lg_gpu - cpu.serve(small.cpu())).abs().max())
    share_scales(gpu.plan, cpu.plan)
    unfed = float((lg_gpu - cpu.serve(small.cpu())).abs().max())
    if tuple(lg_gpu.shape) != (4, cfg.num_classes) or \
            not bool(torch.isfinite(lg_gpu).all()):
        fail(f'{spec["key"]}: served logits malformed: shape '
             f'{tuple(lg_gpu.shape)}')
    fed = fed_check(torch, lg_gpu, sites, lambda: cpu.serve(small.cpu()))
    print(f"{tag} card vs CPU plain path on 4 images, same static scales, "
          f"the CPU fed the card's int8 codes at each of {fed['sites']} "
          f"static requantizes: {fed['flips']} of {fed['codes']} codes "
          f"differ, by at most {fed['step']:g} step, the farthest "
          f"{fed['tie']:.3e} from a rounding tie (limit {TIE_TOL:g}); "
          f"logits max |diff| {fed['diff']:.3e} (max |logit| "
          f"{fed['scale']:.3e}, tolerance 4e-2 x that); unfed "
          f"{unfed:.3e}; each calibrated on its own device: {own:.3e}")
    first = fed['first']
    if first is None:
        print(f'{tag}   no requantized code differs')
    else:
        print(f"{tag}   first code flip at site {first['site']} "
              f"({first['at']}), element {first['first']}: x/s "
              f"{first['own']:.6f} on the CPU, {first['card']:.6f} on the "
              f"card, {first['first_tie']:.3e} from the tie; "
              f"{first['codes']} of {first['of']} codes there")
    if not fed['ok']:
        fail(f'{spec["key"]}: served logits disagree with the CPU plain '
             f'path fed the card\'s codes, or a code differs off a '
             f'rounding tie')
    return model, params, launches, dict(calib_cmp, served_flips=fed['flips'],
                                         served_diff=fed['diff'], unfed=unfed)


def fed_check(torch, lg_card, sites, cpu_fn):
    """The served logits ``lg_card`` of the card against ``cpu_fn()`` (the
    same export on the CPU, on the card's static scales) run with every
    static requantize fed the card's codes (``sites``, from
    ``static_sites``).  ``ok`` when every code that differs is one step
    from the card's and within TIE_TOL of a rounding tie, and the fed
    logits agree within 4e-2 x max|logit|; the readings beside it, with
    the first site whose codes differ (None when none does)."""
    lg_cpu, _, cmp = static_sites(torch, cpu_fn, forced=sites)
    scale = max(float(lg_cpu.abs().max()), 1.0)
    diff = float((lg_card.cpu() - lg_cpu).abs().max())
    step = max(c['step'] for c in cmp)
    tie = max(c['tie'] for c in cmp)
    return {'ok': diff <= 4e-2 * scale and step <= 1 and tie <= TIE_TOL,
            'diff': diff, 'scale': scale, 'sites': len(cmp),
            'codes': sum(c['of'] for c in cmp),
            'flips': sum(c['codes'] for c in cmp), 'step': step, 'tie': tie,
            'first': next((c for c in cmp if c['codes']), None)}


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


def lm_config(spec, **kw):
    """A path's full-width config: the arch at its published width and
    depth (``spec['layers']`` cuts the depth), the path's cache bits."""
    from repro_torch.configs import get_config
    cfg = get_config(spec.get('arch', LM_ARCH))
    if spec.get('layers'):
        cfg = cfg.replace(num_layers=spec['layers'])
    return cfg.replace(kv_cache_bits=spec['kv_cache_bits'], **kw)


def lm_frontend(torch, model, params, cfg, batch, device, seed):
    """(prefill inputs, encoder output) of a prompt batch: a VLM's zero
    patches as launch/serve.py gives them; an encoder-decoder's frames
    (normal, from a generator seeded ``seed``) and their encoding."""
    from repro_torch.launch import serve
    from repro_torch.models.transformer import torch_dtype
    extra = serve.frontend_inputs(cfg, batch, device)
    enc = None
    if cfg.arch_kind == 'encdec':
        frames = torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                             generator=torch.Generator().manual_seed(seed))
        extra['frames'] = frames.to(device, torch_dtype(cfg.dtype))
        with torch.inference_mode():
            enc = model.encode(params, extra['frames'])
    return extra, enc


@contextlib.contextmanager
def recording_routes(torch, log):
    """Record every MoE routing (models/moe.py calls ``moe.route``): each
    call appends (top-k experts, router probabilities) on the CPU."""
    from repro_torch.models import moe
    route = moe.route

    def recording(p, xf, cfg):
        out = route(p, xf, cfg)
        log.append((out[2].cpu(), out[0].float().cpu()))
        return out
    moe.route = recording
    try:
        yield log
    finally:
        moe.route = route


def routing_flips(torch, key, card, cpu, k):
    """Tokens routed to other experts on the card than on the CPU, over
    every recorded call: each must lie at a near-tie (its k-th and (k+1)-th
    CPU probabilities within MOE_NEAR_TIE).  Returns (flips, tokens)."""
    if len(card) != len(cpu):
        fail(f'{key}: {len(card)} MoE calls on the card, {len(cpu)} on the '
             f'CPU')
    n = tot = 0
    for (ea, _), (eb, pb) in zip(card, cpu):
        rows = (ea.sort(-1).values != eb.sort(-1).values).any(-1)
        tot += ea.shape[0]
        if bool(rows.any()):
            top = pb[rows].sort(-1, descending=True).values
            margin = top[:, k - 1] - top[:, k]
            print(f'{key}: {int(rows.sum())} tokens route apart, margins '
                  f'{margin.tolist()}')
            if bool((margin >= MOE_NEAR_TIE).any()):
                fail(f'{key}: a token routes apart away from a near-tie')
            n += int(rows.sum())
    return n, tot


def n_attention(cfg):
    """The GQA layers of a config (each calls a decode kernel a step)."""
    return sum(k in ('global', 'local') for k in cfg.layer_kinds())


def recurrent_state_bytes(cache, cfg):
    """Bytes of the recurrent layers' decode states (``h`` and ``conv``) in
    a cache."""
    from repro_torch.models.transformer import _layers
    return sum(t.numel() * t.element_size()
               for kind, c in _layers(cache, cfg)
               if kind in ('recurrent', 'ssm') for t in (c['h'], c['conv']))


def recurrent_states(torch, cache, cfg):
    """Copies of the recurrent layers' decode states (``h``, ``conv``) of a
    cache, on the CPU in fp32, in layer order."""
    from repro_torch.models.transformer import _layers
    return [t.to('cpu', torch.float32, copy=True)
            for kind, c in _layers(cache, cfg)
            if kind in ('recurrent', 'ssm') for t in (c['h'], c['conv'])]


def cut_config(spec):
    """The path's fp32 cut: LM_CUT['layers'] layers at full width
    (``spec['cut_layers']`` changes the depth, ``spec['cut']`` more), an
    encoder-decoder's encoder cut to LM_CUT['layers'] too."""
    cut = dict(num_layers=spec.get('cut_layers', LM_CUT['layers']),
               dtype='float32', **spec.get('cut', {}))
    if lm_config(spec).arch_kind == 'encdec':
        cut['num_encoder_layers'] = LM_CUT['layers']
    return lm_config(spec, **cut)


def check_lm_against_cpu(torch, tag, spec, built=None):
    """A 2-layer cut of the full-width config in fp32 (``spec['cut']``
    changes more: deepseek's keeps one dense and one MoE layer and 32
    experts; ``spec['cut_layers']`` and ``spec['cut_prompt']`` change the
    depth and the prompt; weights from the same CUDA generator,
    int8-exported on the card for an int8 path; an encoder-decoder's
    encoder cut to 2 layers too) against the port's CPU path on the same
    weights and inputs: prefill and LM_CUT['tokens'] decode steps, both
    fed the CPU's greedy tokens, every step's logits within
    ``spec['cpu_tol']`` (LM_CPU_TOL) x max|logit|, TF32 off; a recurrent
    cut's states after the prefill within REC_STATE_TOL x max.  An MoE cut
    records every routing on both devices: a token may route apart only
    at a near-tie.  ``built`` is (model, card params, their CPU copy) of
    the bf16 cut that :func:`check_export_against_cpu` made already."""
    from repro_torch.core.export import to_device
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.launch import serve
    prompt_len = spec.get('cut_prompt', LM_CUT['prompt'])
    cfg = cut_config(spec)
    n_cut = cfg.num_layers
    tol = spec.get('cpu_tol', LM_CPU_TOL)
    laps = Laps()
    if built is None:
        model, params = serve.build(cfg, 'cuda', seed=SEED,
                                    int8_weights=spec['int8_weights'])
        torch.cuda.synchronize()
        laps('build')
        built = model, params, to_device(params, 'cpu')
        laps('copy to the CPU')
    model, params, host = built
    del built
    prompt = SyntheticTokens(vocab=cfg.vocab_size).batch(
        torch.Generator().manual_seed(SEED + 2), LM_CUT['batch'],
        prompt_len)['tokens']
    pos0 = serve.decode_start(cfg, prompt_len)
    max_len = pos0 + LM_CUT['tokens'] + 8
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        feed = None
        for dev, p in (('cpu', host), ('cuda', params)):
            if dev == 'cuda':
                laps('CPU run')
            reset_counts()
            with torch.inference_mode(), \
                    recording_routes(torch, []) as routes:
                extra, enc = lm_frontend(torch, model, p, cfg,
                                         LM_CUT['batch'], dev, SEED + 3)
                logits, cache = model.prefill(
                    p, {'tokens': prompt.to(dev), **extra}, max_len=max_len)
                states = recurrent_states(torch, cache, cfg)
                out = [logits.cpu()]
                tok = torch.zeros((LM_CUT['batch'],), dtype=torch.int64,
                                  device=dev)
                for t in range(LM_CUT['tokens']):
                    if feed is not None:
                        tok = feed[t].to(dev)
                    logits, cache = model.decode_step(p, tok, pos0 + t,
                                                      cache, enc=enc)
                    out.append(logits.cpu())
                    tok = torch.argmax(logits, -1)
            runs[dev] = (out, {k: counts()[k] for k in LM_KERNEL_META},
                         routes, states)
            if feed is None:
                feed = [torch.zeros(LM_CUT['batch'], dtype=torch.int64)] + \
                    [torch.argmax(lg, -1) for lg in out[1:-1]]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    laps('card run')
    n_steps = LM_CUT['tokens']
    n = 0 if spec['kernel'] is None else n_attention(cfg) * n_steps
    for name, c in runs['cuda'][1].items():
        on = name == spec['kernel']
        if c != {'launches': n if on else 0, 'plain_calls': 0} or \
                runs['cpu'][1][name] != {'launches': 0,
                                         'plain_calls': n if on else 0}:
            fail(f"{spec['key']}: the {n_cut}-layer cut ran {name} {c} on "
                 f"the card and {runs['cpu'][1][name]} on the CPU")
    worst = 0.0
    for a, b in zip(runs['cuda'][0], runs['cpu'][0]):
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
    kinds = '/'.join(cfg.layer_kinds())
    moe_note = ''
    if cfg.is_moe:
        flips, toks = routing_flips(torch, spec['key'], runs['cuda'][2],
                                    runs['cpu'][2], cfg.top_k)
        moe_note = (f"; {len(runs['cpu'][2])} MoE calls ({cfg.n_experts} "
                    f"experts top-{cfg.top_k}), {flips} of {toks} tokens "
                    f"routed apart")
    state_note, state_err = '', None
    if runs['cuda'][3]:
        state_err = max(float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(runs['cuda'][3], runs['cpu'][3]))
        state_note = (f"; recurrent states (h, conv of "
                      f"{len(runs['cpu'][3]) // 2} layers) after the prefill "
                      f"{state_err:.3e} x max (limit {REC_STATE_TOL:g})")
    print(f"{tag} {n_cut}-layer fp32 cut ({kinds}"
          + (f", {cfg.first_dense_layers} dense" if cfg.first_dense_layers
             else '')
          + f"; batch {LM_CUT['batch']}, prompt {prompt_len}, "
          f"{n_steps} decode steps), card vs CPU plain path: max |diff| / "
          f"max |logit| over prefill and every step {worst:.3e} (limit "
          f"{tol:g}){moe_note}{state_note}; seconds: {laps}")
    if worst > tol:
        fail(f"{spec['key']}: the card disagrees with the CPU on the "
             f"{n_cut}-layer cut")
    if state_err is not None and state_err > REC_STATE_TOL:
        fail(f"{spec['key']}: the card's recurrent states disagree with the "
             f"CPU's after the cut's prefill")
    return worst


def check_export_against_cpu(torch, tag, spec):
    """On the path's fp32 cut (``spec['cut']`` and ``spec['cut_layers']``
    as in :func:`check_lm_against_cpu`): ``export_lm`` on the card against
    the CPU's on the same weights, every code and scale bit for bit (MoE
    experts, quantized slice by slice, the router and the shared expert
    included; the recurrent blocks' projections quantized and their conv
    taps, decays and norms kept), and where ``spec['prune']`` says so
    ``LMFamily.prune(MOE_PRUNE_RATIO)`` keeping the same 5 experts on both
    devices.  Returns (model, the cut's params on the card, their CPU
    copy) for :func:`check_lm_against_cpu`."""
    from repro_torch.core.export import export_lm, to_device
    from repro_torch.core.family import LMFamily
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import serve
    cfg = cut_config(spec)
    t0 = time.perf_counter()
    model, params = serve.build(cfg, 'cuda', seed=SEED)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = to_device(params, 'cpu')
    t_copy = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_q = export_lm(params, cfg).params
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_q = export_lm(cpu, cfg).params
    t_host = time.perf_counter() - t0
    leaves = list(zip(_leaves(card_q), _leaves(host_q)))
    off = sum(not same_bits(torch, a.cpu(), b) if a.is_floating_point()
              else not bool(torch.equal(a.cpu(), b)) for a, b in leaves)
    n_int8 = sum(t.numel() for t in _leaves(host_q) if t.dtype == torch.int8)
    what = ''
    if cfg.is_moe:
        moe_q = [lp['moe'] for lp in host_q['blocks'] + host_q['tail']]
        n_exp = sum(lp['wi']['w_q'].numel() + lp['wg']['w_q'].numel()
                    + lp['wo']['w_q'].numel() for lp in moe_q)
        what = (f', {n_exp / 1e9:.3f} G expert codes among them; router '
                f'{tuple(moe_q[0]["router"]["w_q"].shape)} int8, expert '
                f'scales {tuple(moe_q[0]["wi"]["scale"].shape)}')
    print(f'{tag} export_lm of the {cfg.num_layers}-layer cut on the card '
          f'({t_card:.2f} s) and on the CPU ({t_host:.2f} s): '
          f'{len(leaves) - off} of {len(leaves)} leaves bit-equal, '
          f'{n_int8 / 1e9:.3f} G int8 codes{what}; built on the card in '
          f'{t_build:.2f} s, copied to the CPU in {t_copy:.2f} s')
    if off:
        fail(f"{spec['key']}: the card's int8 export differs from the "
             f"CPU's in {off} leaves")
    del card_q, host_q
    if spec.get('prune'):
        data = SyntheticTokens(vocab=cfg.vocab_size)
        on_card, c2 = LMFamily(data, device='cuda').prune(
            params, cfg, MOE_PRUNE_RATIO)
        on_card = to_device(on_card, 'cpu')
        on_host, _ = LMFamily(data, device='cpu').prune(
            cpu, cfg, MOE_PRUNE_RATIO)
        full = cpu['blocks'][0]['moe']['router']['w']

        def kept(tree):
            got = tree['blocks'][0]['moe']['router']['w']
            return [[int((full[g].T == col).all(1).nonzero()[0])
                     for col in got[g].T] for g in range(got.shape[0])]
        same = all(bool(torch.equal(a, b)) for a, b in
                   zip(_leaves(on_card), _leaves(on_host)))
        print(f"{tag} LMFamily.prune(ratio {MOE_PRUNE_RATIO}): "
              f"{c2.n_experts} of {cfg.n_experts} experts kept a layer, "
              f"card {kept(on_card)}, CPU {kept(on_host)} (importance "
              f"order); pruned trees bit-equal: {same}")
        if kept(on_card) != kept(on_host) or not same or c2.n_experts != 5:
            fail(f"{spec['key']}: the card prunes other experts than the CPU")
        del on_card, on_host
    torch.cuda.empty_cache()
    return model, params, cpu


def ring_check(torch, tag, spec, cfg, cache, cur):
    """A local layer's cache, after the step at position ``cur``: a ring of
    min(window, slots) slots holding the last positions up to ``cur``,
    wrapped (a slot holding another position than its index) once ``cur``
    passed the ring."""
    from repro_torch.models.transformer import _layers
    for kind, c in _layers(cache, cfg):
        if kind != 'local':
            continue
        pos = c['meta']['pos'].cpu()
        n = pos.numel()
        held = sorted(p for p in pos.tolist() if p >= 0)
        if held != list(range(max(0, cur - n + 1), cur + 1)):
            fail(f"{spec['key']}: a local ring of {n} slots holds "
                 f"{held[:4]}..., not the last positions up to {cur}")
        slot = torch.arange(n, dtype=pos.dtype)
        wrapped = bool(((pos >= 0) & (pos != slot)).any())
        print(f'{tag} local rings: {n} slots (window {cfg.window}), holding '
              f'positions {held[0]}..{held[-1]}, wrapped: {wrapped}')
        if cur >= n and not wrapped:
            fail(f"{spec['key']}: the local ring did not wrap")
        return


def first_step_sensitivity(torch, model, params, tok, pos0, cache, enc,
                           lg_p):
    """A model's rounding sensitivity at its first decode step: the plain
    path on ``cache`` (a copy of the prefilled cache) with one output
    element of its first decode-attention call one bf16 ulp up, the
    logits' change from ``lg_p`` (the plain step) over max|logit|."""
    from repro_torch.models import attention as attn

    def bumped(q, nk, nv, c, cur, **kw):
        out, c = attn.decode_attn_kernel(q, nk, nv, c, cur, **kw)
        if not bumped.done:
            out = out.clone()
            v = out[0, 0, 0].float()
            e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
            out[0, 0, 0] = (v + torch.exp2(e - 7)).to(out.dtype)
            bumped.done = True
        return out, c
    bumped.done = False
    with torch.inference_mode(), plain_decode_attention():
        lg_b, _ = model.decode_step(params, tok, pos0, cache, enc=enc,
                                    ctx={'decode_attn': bumped})
    return max_err(torch, lg_b, lg_p) / float(lg_p.float().abs().max())


def serve_lm_path(torch, spec):
    """An LM decode path: the arch at full width (depth cut where
    ``spec['layers']`` says) through the functions launch/serve.py uses,
    counted from zero.  Returns (the launches of every kernel in the
    counted run, the decode-attention calls of one more step for phase 4,
    readings)."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models.model import param_count

    tag = f"[serve:{spec['key']}]"
    t_path = time.perf_counter()
    laps = Laps()
    prompt_len = spec.get('prompt', LM_PROMPT)
    cfg = lm_config(spec)
    t0 = time.perf_counter()
    model, params = serve.build(cfg, 'cuda', seed=SEED,
                                int8_weights=spec['int8_weights'])
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(params))
    print(f"{tag} {cfg.name}: {cfg.num_layers} layers"
          + (f" (cut from {lm_config(dict(spec, layers=None)).num_layers})"
             if spec.get('layers') else '')
          + f", d_model {cfg.d_model}, "
          + (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
             if cfg.num_heads else '')
          + (f"RG-LRU width {cfg.rglru_width} (conv {cfg.rglru_conv}), "
             if cfg.rglru_width else '')
          + (f"SSD d_inner {cfg.ssm_expand * cfg.d_model}, "
             f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim} heads of "
             f"{cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
             f"{cfg.ssm_chunk} (no KV cache: kv_cache_bits does not apply), "
             if cfg.ssm_state else '')
          + f"{param_count(params) / 1e9:.3f} G "
          f"parameters, {weight_bytes / 1e9:.3f} GB of weights "
          f"({'int8 export_lm' if spec['int8_weights'] else 'bf16'}), "
          f"kv_cache_bits {cfg.kv_cache_bits}, attn_softcap "
          f"{cfg.attn_softcap:g}"
          + (f", {cfg.n_experts} experts of {cfg.moe_d_ff} top-{cfg.top_k}"
             f" ({cfg.n_shared_experts} shared, {cfg.first_dense_layers} "
             f"dense layers first)" if cfg.is_moe else '')
          + (f", MLA ranks q {cfg.q_lora_rank} kv {cfg.kv_lora_rank}, rope "
             f"{cfg.rope_head_dim} + nope {cfg.nope_head_dim}, v "
             f"{cfg.v_head_dim} (its cache ignores kv_cache_bits)"
             if cfg.use_mla else '')
          + f"; built in {time.perf_counter() - t0:.2f} s")
    prompt = SyntheticTokens(vocab=cfg.vocab_size).batch(
        torch.Generator().manual_seed(SEED + 1), LM_BATCH, prompt_len,
        'cuda')['tokens']
    extra, enc = lm_frontend(torch, model, params, cfg, LM_BATCH, 'cuda',
                             SEED + 3)
    pos0 = serve.decode_start(cfg, prompt_len)
    max_len = pos0 + LM_TOKENS + LM_SPARE
    zeros = torch.zeros((LM_BATCH,), dtype=torch.int64, device='cuda')
    # warm-up (cuBLAS handles and plans, the allocator): a prefill and two
    # steps on a cache of their own, before the count starts
    _, warm = serve.prefill_step(model, params, prompt, max_len=max_len,
                                 **extra)
    serve.decode(model, params, warm, zeros, pos0=pos0, tokens=2, enc=enc)
    del warm
    torch.cuda.synchronize()
    laps('build and warm-up')

    # ---- the path, counted from zero
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    _, cache = serve.prefill_step(model, params, prompt, max_len=max_len,
                                  **extra)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = serve.decode(model, params, cache, zeros, pos0=pos0,
                        tokens=LM_TOKENS, enc=enc)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    after = counts()
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(cache))
    state_bytes = recurrent_state_bytes(cache, cfg)
    front = (f' after {cfg.frontend_tokens} zero patch rows'
             if cfg.arch_kind == 'vlm' else
             f' (encoder over {cfg.frontend_tokens} frames)'
             if cfg.arch_kind == 'encdec' else '')
    print(f"{tag} prefill of {LM_BATCH} x {prompt_len} tokens{front} "
          f"{t_prefill * 1e3:.3f} ms; {LM_TOKENS} greedy decode steps "
          f"{t_decode * 1e3:.3f} ms: {t_decode / LM_TOKENS * 1e3:.3f} "
          f"ms/token, {LM_BATCH * LM_TOKENS / t_decode:.1f} tokens/s at "
          f"batch {LM_BATCH}; cache {cache_bytes / 2 ** 20:.1f} MiB "
          f"({max_len} slots); peak memory {peak / 2 ** 20:.1f} MiB, "
          f"{(peak - base) / 2 ** 20:.1f} MiB above the weights; "
          f"weight-streaming bound (computed: {weight_bytes / 1e9:.3f} GB at "
          f"{HBM_BYTES_PER_S / 1e12:g} TB/s) "
          f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms/token"
          + (f"; with the recurrent state read and written once a step "
             f"({state_bytes / 1e9:.3f} GB) "
             f"{(weight_bytes + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3:.3f}"
             f" ms/token" if state_bytes else ''))
    if tuple(toks.shape) != (LM_TOKENS, LM_BATCH) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{spec['key']}: the decoded tokens are malformed")
    ring_check(torch, tag, spec, cfg, cache, pos0 + LM_TOKENS - 1)
    want = n_attention(cfg) * LM_TOKENS
    for name in LM_KERNEL_META:
        print(f"{tag} {name}: {after[name]['launches']} launches, "
              f"{after[name]['plain_calls']} plain calls")
    if spec['kernel'] is None:
        if any(after[name]['launches'] for name in LM_KERNEL_META):
            fail(f"{spec['key']}: a decode kernel ran on a path with no "
                 f"GQA layer")
        print(f'{tag} ' + (
            'MLA decodes in its latent space in torch ops '
            '(attention.decode_mla_reference)' if cfg.use_mla else
            'its SSD layers decode in torch ops (recurrent.mamba2_decode)')
            + ': no decode kernel')
    elif after[spec['kernel']]['launches'] != want:
        fail(f"{spec['key']}: {spec['kernel']} launched "
             f"{after[spec['kernel']]['launches']} times, want {want} "
             f"({n_attention(cfg)} attention layers x {LM_TOKENS} steps)")
    if spec['other'] and after[spec['other']]['launches']:
        fail(f"{spec['key']}: {spec['other']} ran on this path")
    plain = sum(c['plain_calls'] for c in after.values())
    if plain:
        fail(f"{spec['key']}: the plain versions ran {plain} times")
    laps('counted run')

    # where the time goes: the cache's spare slots, under the profiler
    def more_steps():
        serve.decode(model, params, cache, zeros, pos0=pos0 + LM_TOKENS,
                     tokens=LM_PROFILE_STEPS, enc=enc)
    parts = prefill_parts = None
    recurrent = bool(cfg.rglru_width or cfg.ssm_state)
    if spec.get('profile', True):
        if recurrent:      # the prefill's scans, then the decode steps
            pwall, pbusy, _, prefill_parts = profile_recurrent(
                torch, lambda: serve.prefill_step(
                    model, params, prompt, max_len=max_len, **extra))
            if pbusy is not None:
                print(f'{tag} profile: one prefill in {pwall:.3f} ms wall, '
                      f'device kernels {pbusy:.3f} ms (busy '
                      f'{pbusy / pwall:.1%}); by part, device ms: ' +
                      ', '.join(f'{k} {v:.3f} ({v / pbusy:.1%})'
                                for k, v in prefill_parts.items() if v))
        if cfg.is_moe:
            wall, busy, top, parts = profile_moe(torch, more_steps)
        elif recurrent:
            wall, busy, top, parts = profile_recurrent(torch, more_steps)
        else:
            wall, busy, top = profile_device(torch, more_steps)
        if busy is None:
            print(f'{tag} profile: {LM_PROFILE_STEPS} steps in {wall:.3f} '
                  f'ms wall; device time not measured (the profiler '
                  f'recorded no device activity)')
        else:
            kern = sum(ms for ms, _, name in top if spec['kernel'] and
                       DA_DEVICE_NAME[spec['kernel']] in name)
            print(f'{tag} profile: {LM_PROFILE_STEPS} decode steps in '
                  f'{wall:.3f} ms wall ({wall / LM_PROFILE_STEPS:.3f} '
                  f'ms/token profiled), device kernels {busy:.3f} ms: '
                  f'device busy {busy / wall:.1%}; the decode-attention '
                  f'kernel {kern:.3f} ms, {kern / busy:.1%} of device time')
            if parts is not None:
                print(f'{tag} profile by part, device ms over '
                      f'{LM_PROFILE_STEPS} steps: ' + ', '.join(
                          f'{k} {v:.3f} ({v / busy:.1%})'
                          for k, v in parts.items() if v))
            for ms, n, name in top[:8]:
                print(f'{tag}   {ms:9.3f} ms  {n:6d} x  {name[:90]}')
    del cache
    laps('profile')

    # the first step's logits against the same model served with the
    # plain decode attention on the card (the kernels' plain versions in
    # their place), and beside it the reference's decode math
    _, fresh = serve.prefill_step(model, params, prompt, max_len=max_len,
                                  **extra)
    twins = [clone_tree(fresh) for _ in range(3)]
    with torch.inference_mode():
        lg_k, _ = model.decode_step(params, zeros, pos0, fresh, enc=enc)
        with plain_decode_attention():
            lg_p, _ = model.decode_step(params, zeros, pos0, twins[0],
                                        enc=enc)
        lg_r, _ = model.decode_step(
            params, zeros, pos0, twins[1], enc=enc,
            ctx={'decode_attn': attn.decode_attn_reference})
    if tuple(lg_k.shape) != (LM_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(lg_k).all()):
        fail(f"{spec['key']}: first-step logits malformed")
    scale = float(lg_p.float().abs().max())
    if spec['kernel'] is None and max_err(torch, lg_k, lg_p):
        fail(f"{spec['key']}: the step changed with no decode kernel in it")
    diff = max_err(torch, lg_k, lg_p)
    agree = float((lg_k.argmax(-1) == lg_p.argmax(-1)).float().mean())
    if spec['kernel'] is None:
        print(f'{tag} first-step logits (max |logit| {scale:.3e}): the same '
              f'with the plain decode attention swapped in, as no decode '
              f'kernel runs')
    else:
        print(f'{tag} first-step logits, decode kernel vs the plain decode '
              f'attention on the card: max |diff| {diff:.3e} (max |logit| '
              f'{scale:.3e}, limit {LM_PLAIN_TOL:g} x that); greedy tokens '
              f'agree on {agree:.0%} of the batch; against '
              f'decode_attn_reference (q scaled in bf16, bf16 '
              f'probabilities): max |diff| {max_err(torch, lg_k, lg_r):.3e}')
    limit = LM_PLAIN_TOL
    if spec['kernel'] is not None and diff > limit * scale:
        sens = first_step_sensitivity(torch, model, params, zeros, pos0,
                                      twins[2], enc, lg_p)
        if sens > LM_PLAIN_TOL:
            limit = LM_SENS_FACTOR * sens
        print(f"{tag} first-step logits {diff / scale:.3e} x max apart, "
              f"above {LM_PLAIN_TOL:g}: one output of the first "
              f"decode-attention call one bf16 ulp up moves the plain "
              f"path's logits {sens:.3e} x max (the model's sensitivity); limit "
              f"{limit:.3e} x max ({LM_SENS_FACTOR} x the sensitivity where "
              f"it passes {LM_PLAIN_TOL:g}, else {LM_PLAIN_TOL:g})")
    del twins
    if spec['kernel'] is not None and diff > limit * scale:
        fail(f"{spec['key']}: the kernel path disagrees with the plain "
             f"decode attention")

    # every decode-attention call of one more step, for phase 4
    calls = []

    def capture(q, nk, nv, c, cur, **kw):
        out, c = attn.decode_attn_kernel(q, nk, nv, c, cur, **kw)
        calls.append((q, c, attn._valid(c['meta']['pos'], int(cur),
                                        kw['window']), kw['attn_softcap']))
        return out, c
    with torch.inference_mode():
        model.decode_step(params, zeros, pos0 + 1, fresh, enc=enc,
                          ctx={'decode_attn': capture})
    if cfg.use_mla:
        experts = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff
        print(f'{tag} the int8 export is checked on the 2-layer cut: its MoE '
              f'forward (the reference\'s _maybe_quant_w) would dequantize '
              f'{experts / 1e9:.3f} G expert elements a layer every step, '
              f'{experts * 4 / 1e9:.1f} GB in fp32 and '
              f'{experts * 2 / 1e9:.1f} GB kept as bf16 (computed)')
    del params, fresh, enc, extra, model
    torch.cuda.empty_cache()
    laps('first step')
    built = None
    if spec.get('hooks'):
        if spec['int8_weights']:
            fail(f"{spec['key']}: the export check runs on a bf16 leg")
        built = check_export_against_cpu(torch, tag, spec)
        laps('export check')
    cpu_err = check_lm_against_cpu(torch, tag, spec, built)
    del built
    torch.cuda.empty_cache()
    laps('cut')
    secs = time.perf_counter() - t_path
    print(f'{tag} path took {secs:.1f} s ({laps})')
    return {k: v['launches'] for k, v in after.items()}, calls, {
        'prefill_ms': t_prefill * 1e3,
        'ms_per_token': t_decode / LM_TOKENS * 1e3,
        'tokens_per_s': LM_BATCH * LM_TOKENS / t_decode,
        'peak_mib': peak / 2 ** 20, 'plain_diff': diff, 'cpu_err': cpu_err,
        'secs': secs, 'parts': parts, 'prefill_parts': prefill_parts}


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


def full_leaves(tree):
    """The leaves of a tree of DTensors as whole tensors."""
    return [x.full_tensor() if hasattr(x, 'full_tensor') else x
            for x in _leaves(tree)]


def leaf_gap(torch, a, b):
    """max over leaves of max|a - b| / max|b| (0 where b is all zero)."""
    worst = 0.0
    for x, y in zip(a, b):
        scale = float(y.to(torch.float64).abs().max())
        if scale:
            worst = max(worst, max_err(torch, x, y) / scale)
    return worst


def train_mesh_leg(torch, tag, args):
    """(q1, q2): ``launch.train.main(args + ['--drill'])`` counted, its
    checkpoints timed (the snapshot in ``save``, the write in
    ``checkpoint.manager._write``, the restore in ``restore_latest``), one
    more step profiled; then the same step in a plain loop from the same
    seed, with no failure and no checkpoint, against the drill's losses
    and final state.  Returns the readings."""
    import shutil
    import statistics
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as mgr_mod
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adamw

    ckpt = tempfile.mkdtemp(prefix='q_ckpt_')
    free = shutil.disk_usage(ckpt).free
    print(f'{tag} checkpoint directory {ckpt}: {free / 1e9:.1f} GB free')
    snaps, writes, restores = [], [], []
    orig_write = mgr_mod._write

    def timed_write(*a, **k):
        t0 = time.perf_counter()
        out = orig_write(*a, **k)
        writes.append(time.perf_counter() - t0)
        return out

    class TimedManager(CheckpointManager):
        def save(self, step, tree):
            self.wait()                 # the previous write, not this save
            t0 = time.perf_counter()
            super().save(step, tree)
            snaps.append(time.perf_counter() - t0)

        def restore_latest(self, tree_like):
            self.wait()
            t0 = time.perf_counter()
            out = super().restore_latest(tree_like)
            torch.cuda.synchronize()
            restores.append(time.perf_counter() - t0)
            return out

    mgr_mod._write, train.CheckpointManager = timed_write, TimedManager
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, end, loop = train.main(args + ['--drill', '--ckpt', ckpt])
        torch.cuda.synchronize()
        t_main = time.perf_counter() - t0
    finally:
        mgr_mod._write, train.CheckpointManager = orig_write, \
            CheckpointManager
    peak = torch.cuda.max_memory_allocated()
    dts = [e[2] for e in loop.events if e[0] == 'step']
    by_step = {e[1] - 1: e[3]['loss'] for e in loop.events if e[0] == 'step'}
    losses = [by_step.get(i, float('nan')) for i in range(Q_STEPS)]
    last = max(int(d.split('_')[1]) for d in os.listdir(ckpt))
    sdir = os.path.join(ckpt, f'step_{last:08d}')
    nbytes = sum(os.path.getsize(os.path.join(sdir, f))
                 for f in os.listdir(sdir))
    shutil.rmtree(ckpt, ignore_errors=True)
    ms = statistics.median(dts[1:]) * 1e3
    tokens = Q_BATCH * Q_SEQ
    print(f'{tag} (q1) launch.train.main {" ".join(args)} --drill: finished '
          f'at step {end}, restarts {loop.restarts}, events '
          f'{[(e[0], e[1]) for e in loop.events]}, in {t_main:.1f} s; '
          f'ms/step {ms:.3f} (median of the {len(dts) - 1} steps after the '
          f'first, {dts[0] * 1e3:.3f}), {tokens / ms * 1e3:.1f} training '
          f'tokens/s; peak memory {peak / 2 ** 30:.2f} GiB; loss by step: '
          + ', '.join(f'{v:.6f}' for v in losses))
    print(f'{tag} (q1) checkpoint: {len(writes)} saves of {nbytes / 1e9:.3f} '
          f'GB; host snapshot s ' + ', '.join(f'{v:.2f}' for v in snaps)
          + '; write s ' + ', '.join(f'{v:.2f}' for v in writes)
          + '; restore s ' + ', '.join(f'{v:.2f}' for v in restores))
    if end != Q_STEPS or loop.restarts != 1 or len(restores) != 1 or \
            not all(math.isfinite(v) for v in losses):
        fail(f'{Q_KEY}: launch.train.main --drill did not run {Q_STEPS} '
             f'finite steps with one restart')

    # one more step under the profiler
    cfg = get_config(LM_ARCH)
    data = SyntheticTokens(vocab=cfg.vocab_size)

    def batch_fn(step):
        return data.batch(torch.Generator().manual_seed(step), Q_BATCH,
                          Q_SEQ)
    mesh = make_local_mesh('cuda')
    fn, model, (_, _, p_sh, o_sh) = steps.build_train_step(
        cfg, mesh, batch_fn(0), lr=Q_LR)
    want = [x.to_local().clone() for x in _leaves(state)]
    params, opt_state = state
    batch = batch_fn(end)

    def one_step():
        fn(params, opt_state, batch)
    wall, busy, top = profile_device(torch, one_step)
    if busy is None:
        print(f'{tag} (q1) profile: one step in {wall:.3f} ms wall; device '
              f'time not measured (the profiler recorded no device '
              f'activity)')
    else:
        print(f'{tag} (q1) profile: one step in {wall:.3f} ms wall, device '
              f'kernels {busy:.3f} ms: device busy {busy / wall:.1%}')
        for ms_, n, name in top[:8]:
            print(f'{tag}   {ms_:9.3f} ms  {n:6d} x  {name[:90]}')
    del state, params, opt_state

    # (q2) the plain loop of the same step from the same seed
    with torch.no_grad():
        p = model.init(torch.Generator(device='cuda').manual_seed(0), 'cuda')
    st = (steps.place_tree(p, p_sh),
          steps.place_tree(adamw(Q_LR).init(p), o_sh))
    del p
    clean = []
    t0 = time.perf_counter()
    for s_ in range(Q_STEPS):
        last = s_ == Q_STEPS - 1
        if last:                         # (t2)'s memory reading, plain step
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            arg_bytes = sum(x.to_local().untyped_storage().nbytes()
                            for x in _leaves(st))
        pp, oo, m = fn(st[0], st[1], batch_fn(s_))
        if last:
            torch.cuda.synchronize()
            step_peak = torch.cuda.max_memory_allocated() - base
        st = (pp, oo)
        clean.append(float(m['loss']))
    t_clean = time.perf_counter() - t0
    same = all(torch.equal(a.to_local(), b)
               for a, b in zip(_leaves(st), want))
    gap = 0.0 if same else leaf_gap(torch, [a.to_local() for a in
                                            _leaves(st)], want)
    print(f'{tag} (q2) the drill against a plain loop of the same step '
          f'({Q_STEPS} steps in {t_clean:.1f} s, no checkpoint): losses '
          + ', '.join(f'{v:.6f}' for v in clean) + f'; equal step for step: '
          f'{losses == clean}; final params and moments equal bit for bit: '
          f'{same}' + ('' if same else f' (max |diff| {gap:.3e} x max)'))
    if losses != clean or not same:
        fail(f'{Q_KEY}: the drill did not replay the plain loop exactly')
    del want
    # (t2)'s FLOPs on one more step, after the comparison: FlopCounterMode
    # decomposes composite ops, which moves the step's bits (and its peak)
    _, reads = step_readings(torch, fn, st, batch_fn(Q_STEPS))
    reads.update(step_peak_bytes=step_peak, step_arg_bytes=arg_bytes)
    print(f'{tag} (q2) the last plain step\'s peak above its arguments '
          f'{step_peak} B, its params and AdamW state {arg_bytes} B; one '
          f'more step under FlopCounterMode for (t2): {reads}')
    del st
    return {'ms_per_step': ms, 'tokens_per_s': tokens / ms * 1e3,
            'peak_gib': peak / 2 ** 30, 'ckpt_gb': nbytes / 1e9,
            'snapshot_s': snaps, 'write_s': writes, 'restore_s': restores,
            'busy': None if busy is None else busy / wall, 'losses': losses,
            'restarts': loop.restarts, **reads}


def step_readings(torch, fn, st, batch):
    """One call of the train step ``fn`` on the state ``st`` under
    ``FlopCounterMode``: (its outputs, {'step_flops', 'step_peak_counted':
    its peak memory above what was allocated before it, which the mode's
    decompositions move, printed beside the plain step's})."""
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        out = fn(st[0], st[1], batch)
    torch.cuda.synchronize()
    return out, {'step_flops': fc.get_total_flops(), 'step_peak_counted':
                 torch.cuda.max_memory_allocated() - base}


def train_cut_leg(torch, tag, mesh):
    """(q3): one build_train_step step of a 2-layer fp32 cut at full width
    on the card and on a CPU mesh, from the same params and batch."""
    from repro_torch.configs import get_config
    from repro_torch.core.export import to_device
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    cfg = get_config(LM_ARCH).replace(num_layers=2, dtype='float32')
    params = tfm.init_lm(torch.Generator(device='cuda').manual_seed(SEED),
                         cfg, 'cuda')
    batch = SyntheticTokens(vocab=cfg.vocab_size).batch(
        torch.Generator().manual_seed(SEED + 5), Q_CUT_BATCH, Q_CUT_SEQ)
    runs = {}
    for name, m, p in (('cuda', mesh, params),
                       ('cpu', make_local_mesh('cpu'),
                        to_device(params, 'cpu'))):
        fn, _, _ = steps.build_train_step(cfg, m, batch, lr=Q_LR)
        t0 = time.perf_counter()
        p_new, o_new, met = fn(clone_tree(p), adamw(Q_LR).init(p), batch)
        t_step = time.perf_counter() - t0
        # both legs' leaves compared on the card
        runs[name] = (float(met['loss']), float(met['grad_norm']),
                      [x.to('cuda') for x in full_leaves(p_new)],
                      [x.to('cuda') for x in full_leaves(o_new.mu)
                       + full_leaves(o_new.nu)], t_step)
    (lg, ng, pg, og, tg), (lc, nc, pc, oc, tc) = runs['cuda'], runs['cpu']
    loss_rel, norm_rel = abs(lg - lc) / abs(lc), abs(ng - nc) / abs(nc)
    p_gap, o_gap = leaf_gap(torch, pg, pc), leaf_gap(torch, og, oc)
    worst, near, n = 0.0, 0, 0
    for a, b in zip(pg, pc):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        near += int((d > Q_NEAR_LR * Q_LR).sum())
        n += d.numel()
    print(f'{tag} (q3) 2-layer fp32 cut, one build_train_step step (batch '
          f'{Q_CUT_BATCH} x {Q_CUT_SEQ}), card vs CPU: loss {lg:.7f} vs '
          f'{lc:.7f} ({loss_rel:.3e} x), grad norm {ng:.6f} vs {nc:.6f} '
          f'({norm_rel:.3e} x), moments max |diff| {o_gap:.3e} x max '
          f'(limit {Q_CPU_TOL:g} each); updated params max |diff| '
          f'{worst / Q_LR:.3e} x lr (limit {Q_NEAR_MAX:g}; {p_gap:.3e} x '
          f'max|param|), {near} of {n} elements ({near / n:.3e}) more than '
          f'{Q_NEAR_LR:g} x lr apart (limit {Q_NEAR_SHARE:g}); the step '
          f'took {tg:.3f} s on the card, {tc:.3f} s on the CPU')
    if max(loss_rel, norm_rel, o_gap) > Q_CPU_TOL or \
            worst > Q_NEAR_MAX * Q_LR or near > Q_NEAR_SHARE * n:
        fail(f"{Q_KEY}: the card's train step disagrees with the CPU's")
    return {'loss_rel': loss_rel, 'norm_rel': norm_rel,
            'params_lr': worst / Q_LR, 'params_near': near / n,
            'moments': o_gap}


def serve_mesh_leg(torch, tag, mesh):
    """(q4): build_prefill_step + build_serve_step at full width against
    launch/serve.py's kernel path on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import jitted_scales
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import serve, steps
    from repro_torch.launch.serving import make_decode_ctx

    cfg = get_config(LM_ARCH)
    B, S, T = LM_BATCH, LM_PROMPT, Q_SERVE_TOKENS
    max_len = S + T + LM_SPARE
    model, params = serve.build(cfg, 'cuda', seed=SEED)
    prompt = SyntheticTokens(vocab=cfg.vocab_size).batch(
        torch.Generator().manual_seed(SEED + 1), B, S, 'cuda')['tokens']
    zeros = torch.zeros((B,), dtype=torch.int64, device='cuda')

    # the kernel path: launch/serve.py's prefill, then its decode step
    # with every step's logits kept
    _, cache = serve.prefill_step(model, params, prompt, max_len=max_len)
    k_toks, k_logits, tok = [], [], zeros
    with torch.inference_mode(), jitted_scales():
        for t in range(T):
            lg, cache = model.decode_step(params, tok, S + t, cache)
            tok = torch.argmax(lg, -1)
            k_toks.append(tok)
            k_logits.append(lg.float())
    del cache

    # the mesh path
    pre, _, (_, p_sh) = steps.build_prefill_step(
        cfg, mesh, {'tokens': prompt}, max_len=max_len)
    step, _, _ = steps.build_serve_step(cfg, mesh, batch=B, max_len=max_len)
    placed = steps.place_tree(params, p_sh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, mcache = pre(placed, {'tokens': prompt})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    from repro_torch.tree import tree_map
    first = tree_map(lambda x: x.to_local().clone(), mcache)
    m_toks, tok = [], zeros.to(torch.int32)
    t0 = time.perf_counter()
    for t in range(T):
        tok, mcache = step(placed, tok, S + t, mcache)
        m_toks.append(tok.full_tensor())
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    with torch.inference_mode(), jitted_scales():
        lg_m, _ = model.decode_step(params, zeros, S, first,
                                    ctx=make_decode_ctx(mesh, cfg,
                                                        max_len=max_len))
    lg_k = k_logits[0]
    scale = float(lg_k.abs().max())
    diff = max_err(torch, lg_m.float(), lg_k)
    flip = None
    for t in range(T):
        bad = (m_toks[t].to(torch.int64) != k_toks[t]).nonzero()
        if len(bad):
            flip = (t, int(bad[0, 0]))
            break
    near = None
    if flip is not None:
        t, b = flip
        lg = k_logits[t][b]
        near = float((lg[k_toks[t][b]] - lg[int(m_toks[t][b])]).abs())
    print(f'{tag} (q4) build_prefill_step + build_serve_step at batch {B}, '
          f'prompt {S}: prefill {t_prefill * 1e3:.3f} ms, {T} greedy steps '
          f'{t_decode / T * 1e3:.3f} ms/token (the plain decode math); '
          f'first-step logits against the kernel path: max |diff| '
          f'{diff:.3e} (max |logit| {scale:.3e}, limit {LM_PLAIN_TOL:g} x '
          f'that); greedy tokens equal to the kernel path\'s '
          + ('at every step' if flip is None else
             f'up to step {flip[0]}, where batch row {flip[1]} picks '
             f'another token: the kernel path\'s logits of the two lie '
             f'{near:.3e} apart (limit {LM_PLAIN_TOL:g} x max|logit| = '
             f'{LM_PLAIN_TOL * scale:.3e}, a near tie)'))
    if diff > LM_PLAIN_TOL * scale:
        fail(f'{Q_KEY}: the mesh serve step disagrees with the kernel path')
    if flip is not None and near > LM_PLAIN_TOL * scale:
        fail(f"{Q_KEY}: the mesh serve step's greedy tokens differ from "
             f"the kernel path's away from a near tie")
    return {'prefill_ms': t_prefill * 1e3, 'ms_per_token': t_decode / T * 1e3,
            'logit_gap': diff / scale, 'flip': flip}


def tp_parts_leg(torch, tag):
    """(q5): the tensor-parallel math at full width on a (1, Q5_MODEL)
    layout played out in one process: each rank's column and row shards
    of one layer's attention and MLP through the rank-local functions
    (``gqa_partial``, ``mlp_partial``: the parts before the all-reduce),
    the parts summed as the all-reduce would, against the unsharded
    layer; the vocab-parallel embedding's parts against the lookup and
    the cross-entropy from Q5_MODEL vocab chunks against the plain one."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import (init_embedding, init_mlp, mlp,
                                           mlp_partial)
    from repro_torch.models.tp import (TPAxis, ce_from_parts, rank_shard,
                                       vocab_ce_parts, vocab_embed)
    cfg = get_config(LM_ARCH).replace(dtype='float32')
    m, B, S = Q5_MODEL, Q5_BATCH, Q5_SEQ
    gen = torch.Generator(device='cuda').manual_seed(SEED + 7)
    a = attn.init_attention(gen, cfg, device='cuda')
    f = init_mlp(gen, cfg, device='cuda')
    table = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                           device='cuda')
    x = torch.randn((B, S, cfg.d_model), generator=gen, device='cuda')
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device='cuda')
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device='cuda')
    pos = torch.arange(S, dtype=torch.int32, device='cuda')
    t0 = time.perf_counter()
    with torch.no_grad():
        whole_a, _ = attn.gqa_forward(a, x, pos, cfg, kind='global')
        whole_f = mlp(f, x)
        sum_a = sum_f = emb = 0
        for r in range(m):
            tp = TPAxis(m, r)
            pa = {n: rank_shard(a[n], 'col', r, m)
                  for n in ('wq', 'wk', 'wv')}
            pa['wo'] = rank_shard(a['wo'], 'row', r, m)
            pf = {n: rank_shard(f[n], 'col', r, m) for n in ('wi', 'wg')}
            pf['wo'] = rank_shard(f['wo'], 'row', r, m)
            part, (k, _) = attn.gqa_partial(pa, x, pos, cfg, kind='global',
                                            tp=tp)
            if k.shape[2] != cfg.num_kv_heads // m:
                fail(f'{Q_KEY}: (q5) rank {r} holds {k.shape[2]} kv heads, '
                     f'not {cfg.num_kv_heads // m}')
            sum_a = sum_a + part
            sum_f = sum_f + mlp_partial(pf, x, tp)
            emb = emb + vocab_embed(rank_shard(table, 'vocab', r, m)['table'],
                                    toks, torch.float32, tp)
        logits = torch.matmul(whole_f, table['table'].t())
        plain = -torch.gather(torch.log_softmax(logits, -1), -1,
                              labels[..., None])[..., 0].mean()
        n = cfg.vocab_size // m
        chunks = [logits[..., r * n:(r + 1) * n] for r in range(m)]
        mx = torch.stack([c.amax(-1) for c in chunks]).amax(0)
        s = t = 0
        for r, c in enumerate(chunks):
            sr, tr = vocab_ce_parts(c, labels, r * n, mx)
            s, t = s + sr, t + tr
        ce = ce_from_parts(s, t, mx)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    err_a = float((sum_a - whole_a).abs().max() / whole_a.abs().max())
    err_f = float((sum_f - whole_f).abs().max() / whole_f.abs().max())
    err_ce = abs(float(ce) - float(plain)) / abs(float(plain))
    emb_same = bool(torch.equal(emb, table['table'][toks]))
    print(f'{tag} (q5) tensor-parallel parts at full width (d_model '
          f'{cfg.d_model}, {cfg.num_heads} heads, {cfg.num_kv_heads} kv '
          f'heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab '
          f'{cfg.vocab_size}), fp32, model axis {m} in one process, '
          f'{B} x {S} tokens: attention parts summed vs the whole layer '
          f'{err_a:.3e} x max, MLP {err_f:.3e} x max, cross-entropy from '
          f'{m} vocab chunks {float(ce):.7f} vs {float(plain):.7f} '
          f'({err_ce:.3e} x), embedding parts bit-equal {emb_same} (limit '
          f'{Q5_TOL:g} each); {secs:.2f} s')
    if max(err_a, err_f, err_ce) > Q5_TOL or not emb_same:
        fail(f'{Q_KEY}: (q5) the rank-local parts disagree with the whole '
             f'layer: attention {err_a:.3e}, MLP {err_f:.3e}, cross-entropy '
             f'{err_ce:.3e}, embedding bit-equal {emb_same}')
    return {'attn': err_a, 'mlp': err_f, 'ce': err_ce, 'secs': secs}


def train_mesh_path(torch):
    """Path (q): the training launcher and the mesh code on the card's one
    rank.  Returns readings."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    tag = f'[train:{Q_KEY}]'
    t_path = time.perf_counter()
    laps = Laps()
    started = init_distributed('cuda')
    try:
        print(f'{tag} process group: world {dist.get_world_size()}, '
              f'backend {dist.get_backend()}')
        mesh = make_local_mesh('cuda')
        out = {'q1': train_mesh_leg(torch, tag, [
            '--steps', str(Q_STEPS), '--batch', str(Q_BATCH), '--seq',
            str(Q_SEQ), '--lr', str(Q_LR)])}
        laps('q1-q2 main and drill')
        out['q3'] = train_cut_leg(torch, tag, mesh)
        laps('q3 cut')
        out['q4'] = serve_mesh_leg(torch, tag, mesh)
        laps('q4 serve')
        out['q5'] = tp_parts_leg(torch, tag)
        laps('q5 tp parts')
    finally:
        if started:
            dist.destroy_process_group()
    secs = time.perf_counter() - t_path
    print(f'{tag} path took {secs:.1f} s ({laps})')
    return out


def pipeline_run(torch, tag, model, xs, t_arr, threshold, costs, oracle,
                 calib, mode, compact, plan):
    """One (r) run: the trace through ``PipelineParallelScheduler`` over
    R_ORDINALS ordinals of the card, gated.  Returns (launches, makespan,
    the run's readings)."""
    from repro_torch.analysis import AnalysisError, check
    from repro_torch.kernels import counts
    from repro_torch.obs import TraceInvariantError, Tracer, check_trace
    from repro_torch.serving import PipelineParallelScheduler, Request
    tracer = Tracer()
    reqs = [Request(i, xs[i], float(t_arr[i])) for i in range(N_REQUESTS)]
    sched = PipelineParallelScheduler(
        model, slots=SLOTS, threshold=threshold, stage_costs=costs,
        devices=(torch.device('cuda', 0),) * R_ORDINALS, compact=compact,
        chaos=plan, tracer=tracer)
    placement0 = sched.placement.summary()
    before = counts()
    t0 = time.perf_counter()
    comp, metrics = sched.run_trace(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = count_delta(before)
    tag = f'{tag}[{mode}]'
    m = metrics.summary()
    makespan = max(c.t_done for c in comp.values()) - float(t_arr[0])
    kinds = [e[0] for e in metrics.events]
    batches, transfers = {}, {}
    for _, _, dev in metrics.device_samples:
        batches[dev] = batches.get(dev, 0) + 1
    for sp in tracer.spans:
        if sp.name == 'transfer.carry':
            d = sp.args['dst_device']
            transfers[d] = transfers.get(d, 0) + 1
    print(f"{tag} placement over {placement0['n_devices']} ordinals: "
          f"{placement0['assignment']} loads {placement0['loads']} balance "
          f"{placement0['balance']} (LPT bound {placement0['bound']})"
          + (f'; after the kill: {sched.placement.summary()["assignment"]} '
             f'over ordinals {sched.alive}' if plan is not None else ''))
    print(f"{tag} served {m['n_requests']} of {N_REQUESTS} in {wall:.3f} s "
          f"wall: simulated makespan {makespan * 1e3:.4f} ms, throughput "
          f"{m['throughput_rps']} req/s, p50 {m['p50_latency_s'] * 1e3:.4f} "
          f"ms, p99 {m['p99_latency_s'] * 1e3:.4f} ms, exit mix "
          f"{m['exit_mix']}; batches by ordinal "
          f"{dict(sorted(batches.items()))}, carry transfers by ordinal "
          f"{dict(sorted(transfers.items()))}; "
          f"events {kinds}")
    if len(comp) != N_REQUESTS:
        fail(f'{R_KEY}: {mode} completed {len(comp)} of {N_REQUESTS}')
    check_against_oracle(tag, R_KEY, comp, oracle)
    try:
        check_trace(tracer, comp, strict=True)
    except TraceInvariantError as e:
        fail(f'{R_KEY}: the {mode} trace breaks its invariants: {e}')
    if not transfers:
        fail(f'{R_KEY}: {mode} moved no carry between ordinals')
    if plan is not None and ('kill' not in kinds
                             or kinds.count('placement') < 2):
        fail(f'{R_KEY}: {mode} saw no kill and re-solve ({kinds})')
    plain = sum(v['plain_calls'] for v in delta.values())
    got = delta['quant_matmul']['launches']
    want = sum(model.segment_launches[k].get('quant_matmul', 0)
               for k, _, _ in metrics.batches)
    most = max(sum(seg.values()) for seg in model.segment_launches)
    lost = kinds.count('kill') * most      # a killed flight ran, then died
    print(f'{tag} quant_matmul launches {got} (the plan over the '
          f'{len(metrics.batches)} landed segment batches: {want}'
          + (f', plus at most {lost} of killed flights' if lost else '')
          + f'); plain-version calls {plain}')
    if plain or not want <= got <= want + lost:
        fail(f'{R_KEY}: {mode} launched quant_matmul {got} times (plan '
             f'{want}), plain versions {plain}')
    try:
        rep = check(sched.model, x=calib, rules=('placement-consistency',),
                    strict=True)
    except AnalysisError as e:
        fail(f'{R_KEY}: placement-consistency is red on the {mode} '
             f'placement: {e}')
    if 'placement-consistency' not in rep.checked:
        fail(f'{R_KEY}: placement-consistency did not run ({rep.skipped})')
    print(f'{tag} placement-consistency strict-green on the placed model '
          f'(stage devices {[str(d) for d in sched.model.stage_devices]})')
    return delta, makespan, dict(
        wall_s=wall, makespan_ms=makespan * 1e3,
        throughput_rps=m['throughput_rps'], batches=batches,
        transfers=transfers, events=kinds)


def pipeline_path(torch, model):
    """Path (r): path (a)'s export served pipeline-parallel over
    R_ORDINALS ordinals of the card in compacting, static and chaos modes
    (counted from zero; the oracle and the analyzer's runs excluded), then
    ``serve_cnn --pipeline --chaos`` on the card's one device.  Returns
    (launches, readings)."""
    import numpy as np
    from repro_torch.core.export import calibrate_exit_threshold
    from repro_torch.core.family import CNNFamily
    from repro_torch.data import SyntheticImages
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.launch import serve_cnn
    from repro_torch.launch.serve_cnn import _measure_stage_costs
    from repro_torch.serving import ChaosPlan
    tag = f'[pipeline:{R_KEY}]'
    t_path = time.perf_counter()
    laps = Laps()
    fam = CNNFamily(SyntheticImages(), device='cuda')
    stream = fam.eval_batches(N_REQUESTS // 64 + 1, 64)
    xs = torch.cat([x for x, _ in stream])
    calib, xs = xs[:SLOTS], xs[SLOTS:SLOTS + N_REQUESTS]
    t_arr = np.cumsum(np.random.default_rng(SEED).exponential(
        1.0 / RATE, size=N_REQUESTS))
    threshold = calibrate_exit_threshold(model, calib)
    costs = _measure_stage_costs(model, calib, iters=RT_COST_ITERS)
    oracle = runtime_oracle(torch, model, xs, threshold)
    laps('costs and oracle')
    print(f'{tag} {model.cfg.name} (path (a)\'s export), exit threshold '
          f'{threshold:.6f}; stage costs at {SLOTS} slots (CUDA events, '
          f'median of {RT_COST_ITERS}): '
          + ', '.join(f'seg{k} {c * 1e3:.4f} ms' for k, c in enumerate(costs)))
    torch.cuda.synchronize()
    reset_counts()
    launches, out, makespan = {}, {}, None
    for mode, compact, chaos in (('compacting', True, False),
                                 ('static', False, False),
                                 ('chaos', True, True)):
        plan = (ChaosPlan(kills=((float(t_arr[0]) + R_KILL_AT * makespan,
                                  None),)) if chaos else None)
        delta, span, out[mode] = pipeline_run(
            torch, tag, model, xs, t_arr, threshold, costs, oracle, calib,
            mode, compact, plan)
        add_launches(launches, delta)
        if makespan is None:
            makespan = span
        laps(mode)
    # the CLI on the card's one device: its kill is kill_skipped
    t0 = time.perf_counter()
    comp, metrics = serve_cnn.main([
        '--server', '--pipeline', '--chaos', '--config', PATHS[0]['config'],
        '--steps', '0', '--requests', str(N_REQUESTS), '--slots',
        str(SLOTS), '--rate', str(R_CLI_RATE)])
    torch.cuda.synchronize()
    add_launches(launches, counts())       # serve_cnn counts from zero
    kinds = [e[0] for e in metrics.events]
    print(f'{tag}[cli] serve_cnn --server --pipeline --chaos --rate '
          f'{R_CLI_RATE:.0f} on the card\'s one device in '
          f'{time.perf_counter() - t0:.1f} s: {len(comp)} served, events '
          f'{kinds}')
    if len(comp) != N_REQUESTS or 'kill_skipped' not in kinds or \
            'kill' in kinds:
        fail(f'{R_KEY}: serve_cnn --pipeline --chaos on one device served '
             f'{len(comp)} and recorded {kinds}: the kill must be '
             f'kill_skipped')
    laps('cli')
    if not launches.get('quant_matmul'):
        fail(f'{R_KEY}: quant_matmul was never launched on this path')
    secs = time.perf_counter() - t_path
    print(f'{tag} path took {secs:.1f} s ({laps})')
    out['secs'] = secs
    return launches, out


class _NoCheckpoints:
    """A checkpoint manager that keeps nothing: path (s)'s launcher runs
    write no checkpoint (37 GB a save at its size; path (q) times them)."""

    def __init__(self, *a, **k):
        pass

    def save(self, step, tree):
        pass

    def wait(self):
        pass

    def restore_latest(self, tree_like):
        raise FileNotFoundError('no checkpoints are kept')


def moe_ep_train(torch, tag, mode, on_host):
    """One ``launch.train.main`` run of mixtral-8x7b cut to S_LAYERS layers
    at full width, fp32, S_STEPS steps, under ``REPRO_MOE_MODE=mode``:
    (losses, grad norms, final params (copied to the host where
    ``on_host``, else the card's), EP collectives called, ms/step, peak
    GiB)."""
    import statistics
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.models import moe
    cut = get_config(S_ARCH).replace(num_layers=S_LAYERS, dtype='float32')
    norms, calls = [], {'a2a': 0, 'sum': 0}
    build0, get0, mgr0 = (steps.build_train_step, train.get_config,
                          train.CheckpointManager)
    a2a0, sum0 = moe._AllToAll.apply, moe._Sum.apply

    def build(*a, **k):
        fn, model, rest = build0(*a, **k)

        def step(params, opt_state, batch):
            out = fn(params, opt_state, batch)
            norms.append(float(out[2]['grad_norm']))
            return out
        return step, model, rest

    def counted(key, apply):
        def f(*a):
            calls[key] += 1
            return apply(*a)
        return f
    env0 = os.environ.get('REPRO_MOE_MODE')
    os.environ['REPRO_MOE_MODE'] = mode
    steps.build_train_step, train.get_config = build, lambda arch: cut
    train.CheckpointManager = _NoCheckpoints
    moe._AllToAll.apply = counted('a2a', a2a0)
    moe._Sum.apply = counted('sum', sum0)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, end, loop = train.main([
            '--arch', S_ARCH, '--steps', str(S_STEPS), '--batch',
            str(S_TRAIN_BATCH), '--seq', str(S_TRAIN_SEQ), '--lr',
            str(Q_LR)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        steps.build_train_step, train.get_config = build0, get0
        train.CheckpointManager = mgr0
        moe._AllToAll.apply, moe._Sum.apply = a2a0, sum0
        if env0 is None:
            os.environ.pop('REPRO_MOE_MODE', None)
        else:
            os.environ['REPRO_MOE_MODE'] = env0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dts = [e[2] for e in loop.events if e[0] == 'step']
    losses = [e[3]['loss'] for e in loop.events if e[0] == 'step']
    params = [x.to_local().cpu() if on_host else x.to_local()
              for x in _leaves(state[0])]
    del state
    ms = statistics.median(dts[1:]) * 1e3
    print(f'{tag}[train {mode}] launch.train.main --arch {S_ARCH} cut to '
          f'{S_LAYERS} layers at full width, fp32, {end} steps of '
          f'{S_TRAIN_BATCH} x {S_TRAIN_SEQ} tokens in {wall:.1f} s: ms/step '
          f'{ms:.3f} (median after the first, {dts[0] * 1e3:.3f}), peak '
          f'memory {peak:.2f} GiB; losses '
          + ', '.join(f'{v:.6f}' for v in losses) + '; grad norms '
          + ', '.join(f'{v:.6f}' for v in norms)
          + f'; all-to-alls {calls["a2a"]}, f-TP sums {calls["sum"]}')
    if end != S_STEPS or len(norms) != S_STEPS or not all(
            math.isfinite(v) for v in losses + norms):
        fail(f'{S_KEY}: launch.train ({mode}) did not run {S_STEPS} '
             f'finite steps')
    return losses, norms, params, calls, ms, peak


def moe_ep_path(torch):
    """Path (s): the MoE block's expert-parallel path on the card's 1 x 1
    mesh (a world of one rank, NCCL), counted from zero: one mixtral-8x7b
    MoE layer at its published width, fp32, through ``moe_block`` under
    the mesh policy (a2a mode over a group of one) against the dense block
    on the card; then ``launch.train`` cut in depth with the EP path
    against the same steps under ``REPRO_MOE_MODE=dense``.  No TPU kernel
    is on this path (the expert products are ``torch.bmm``).  Returns
    (launches, readings)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.actsharding import (activation_sharding,
                                                make_mesh_policy)
    tag = f'[moe-ep:{S_KEY}]'
    t_path = time.perf_counter()
    laps = Laps()
    cfg = get_config(S_ARCH).replace(dtype='float32')
    out = {}
    torch.cuda.empty_cache()
    print(f'{tag} on the card before the path: '
          f'{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, '
          f'{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved')
    started = init_distributed('cuda')
    try:
        policy = make_mesh_policy(make_local_mesh('cuda'))
        g = torch.Generator(device='cuda').manual_seed(SEED)
        p = moe.init_moe(g, cfg, device='cuda')
        x = torch.randn((S_BATCH, S_SEQ, cfg.d_model), generator=g,
                        device='cuda') * 0.3
        torch.cuda.synchronize()
        reset_counts()
        calls = {'a2a': 0}
        a2a0 = moe._AllToAll.apply

        def counted(*a):
            calls['a2a'] += 1
            return a2a0(*a)
        moe._AllToAll.apply = counted
        try:
            with torch.no_grad(), activation_sharding(policy):
                y_ep = moe.moe_block(p, x, cfg)
            n_a2a = calls['a2a']

            def ep():
                with torch.no_grad(), activation_sharding(policy):
                    moe.moe_block(p, x, cfg)
            ms_ep = time_ms(torch, ep, iters=5)
        finally:
            moe._AllToAll.apply = a2a0
        with torch.no_grad():
            y_dense = moe._moe_block_dense(p, x, cfg)

            def dense():
                moe._moe_block_dense(p, x, cfg)
            ms_dense = time_ms(torch, dense, iters=5)
        torch.cuda.synchronize()
        err = max_err(torch, y_ep, y_dense) / float(y_dense.abs().max())
        E, f = cfg.n_experts, cfg.moe_d_ff
        print(f'{tag} one {S_ARCH} MoE layer at its published width ({E} '
              f'experts of {f}, top {cfg.top_k}, d_model {cfg.d_model}), '
              f'fp32, x ({S_BATCH}, {S_SEQ}, {cfg.d_model}): moe_block under '
              f'the 1 x 1 mesh policy took the a2a path ({n_a2a} '
              f'all-to-alls over a group of one) in {ms_ep:.3f} ms, the '
              f'dense block {ms_dense:.3f} ms; max|ep - dense| {err:.3e} x '
              f'max|dense|')
        if n_a2a != 2 or err > S_TOL:
            fail(f'{S_KEY}: the EP layer ran {n_a2a} all-to-alls and lies '
                 f'{err:.3e} x max from the dense one (limit {S_TOL})')
        out['layer'] = dict(ms_ep=ms_ep, ms_dense=ms_dense, err=err)
        del p, x, y_ep, y_dense
        torch.cuda.empty_cache()
        laps('layer')
        runs = {}
        for mode in ('auto', 'dense'):       # the EP params wait on the host
            runs[mode] = moe_ep_train(torch, tag, mode, mode == 'auto')
            torch.cuda.empty_cache()
            laps(f'train {mode}')
        (l_ep, n_ep, p_ep, c_ep, ms_ep, pk_ep), \
            (l_d, n_d, p_d, c_d, ms_d, pk_d) = runs['auto'], runs['dense']
        if not c_ep['a2a'] or c_ep['sum'] or c_d['a2a'] or c_d['sum']:
            fail(f'{S_KEY}: the EP run called {c_ep}, the dense run {c_d}: '
                 f'the EP run must take the a2a path and the dense none')
        worst = max(abs(a - b) / abs(b) for a, b in zip(l_ep + n_ep,
                                                       l_d + n_d))
        far, n_el, near = 0, 0, 0.0
        for a, b in zip(p_ep, p_d):
            d = (a.to(b.device) - b).abs()
            near = max(near, float(d.max()) / Q_LR)
            far += int((d > Q_NEAR_LR * Q_LR).sum())
            n_el += d.numel()
        print(f'{tag} EP against dense over {S_STEPS} steps: loss and grad '
              f'norm within {worst:.3e} relative (limit {S_TOL}); params: '
              f'max |diff| {near:.3e} x lr (limit {Q_NEAR_MAX}), {far} of '
              f'{n_el} elements beyond {Q_NEAR_LR} x lr (limit '
              f'{Q_NEAR_SHARE:.0e} of them)')
        if worst > S_TOL or near > Q_NEAR_MAX or far > Q_NEAR_SHARE * n_el:
            fail(f'{S_KEY}: the EP train steps left the dense ones\' bands')
        out['train'] = dict(ms_ep=ms_ep, ms_dense=ms_d, peak_gib=max(
            pk_ep, pk_d), loss_gap=worst, param_gap_lr=near)
        del p_ep, p_d
        laps('compare')
    finally:
        if started:
            dist.destroy_process_group()
    launched = {k: v['launches'] for k, v in counts().items()}
    plain = sum(v['plain_calls'] for v in counts().values())
    if any(launched.values()) or plain:
        fail(f'{S_KEY}: a TPU kernel ran on path (s): {launched}, plain '
             f'calls {plain}')
    secs = time.perf_counter() - t_path
    print(f'{tag} no TPU kernel launched (the expert products are '
          f'torch.bmm); path took {secs:.1f} s ({laps})')
    out['secs'] = secs
    return {k: 0 for k in counts()}, out


T2_SCRIPT = '''
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
a = json.loads(sys.argv[1])
with dryrun.fake_world(1):
    res = dryrun.trace_cell(get_config(a['arch']), make_local_mesh(),
                            dict(kind='train', batch=a['batch'],
                                 seq=a['seq']))
print(json.dumps(res))
'''


def start_dryruns():
    """(t): start ``python -m repro_torch.launch.dryrun`` on each of
    ``T_CELLS`` (t1) and the dry-run of (q1)'s step on the 1 x 1 mesh
    (t2), each in a process of its own at a lower priority, one thread
    each, beside the paths that follow; :func:`dryrun_path` reads them."""
    import tempfile
    d = tempfile.mkdtemp(prefix='dryrun_')
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, 'src'),
               OMP_NUM_THREADS='1')
    jobs = [(f'{a}/{sh}/{m}', ['-m', 'repro_torch.launch.dryrun', '--arch',
                               a, '--shape', sh, '--mesh', m, '--out', d])
            for a, sh, m in T_CELLS]
    jobs.append(('t2', ['-c', T2_SCRIPT, json.dumps(
        {'arch': LM_ARCH, 'batch': Q_BATCH, 'seq': Q_SEQ})]))
    procs = {}
    for name, argv in jobs:
        log = open(os.path.join(d, name.replace('/', '__') + '.log'), 'w')
        procs[name] = (subprocess.Popen(
            [sys.executable] + argv, cwd=HERE, env=env, stdout=log,
            stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(10)), log)
    atexit.register(_stop, procs)     # a failed phase leaves none behind
    print(f'[dryrun] started {len(procs)} dry-runs beside the paths '
          f'(output under {d})')
    return {'dir': d, 'procs': procs, 't0': time.perf_counter()}


def _stop(procs):
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def _dryrun_log(jobs, name):
    with open(os.path.join(jobs['dir'], name.replace('/', '__') + '.log')) \
            as f:
        return f.read()


def dryrun_path(torch, jobs, q1):
    """Path (t): the dry-runs :func:`start_dryruns` started, awaited.  (t1)
    each cell completes, its record printed; its ``argument_bytes`` equal
    the rules' shard bytes of the same trees (``rule_argument_bytes``,
    computed from the specs alone), every collective kind is one of
    ``T_KINDS``.  (t2) the dry-run of (q1)'s step: its FLOPs equal
    ``FlopCounterMode`` over the card's step exactly (the same op stream),
    its argument + temp bytes within ``T_MEM_TOL`` of the card's peak over
    (q2)'s last plain step with that step's argument bytes added (the
    peak under FlopCounterMode printed beside it).  Returns readings."""
    import shutil
    tag = '[dryrun]'
    t_wait = time.perf_counter()
    out = {}
    try:
        for name, (proc, log) in jobs['procs'].items():
            left = T_WAIT_S - (time.perf_counter() - jobs['t0'])
            try:
                proc.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                fail(f'(t) {name}: no result within {T_WAIT_S} s of its '
                     f'start:\n{_dryrun_log(jobs, name)[-3000:]}')
            if proc.returncode != 0:
                fail(f'(t) {name} exited {proc.returncode}:\n'
                     f'{_dryrun_log(jobs, name)[-3000:]}')
        waited = time.perf_counter() - t_wait
        for arch, shape, mesh in T_CELLS:
            path = os.path.join(jobs['dir'], mesh, f'{arch}__{shape}.json')
            with open(path) as f:
                rec = json.load(f)
            print(f'{tag} (t1) {json.dumps(rec)}')
            mem = rec['memory']
            kinds = set(rec['collective_bytes'])
            live = (mem['argument_bytes'] + mem['temp_bytes']) / 2 ** 30
            print(f'{tag} (t1) {arch} {shape} {mesh}: traced in '
                  f"{rec['trace_s']} s; argument bytes "
                  f"{mem['argument_bytes']} (the rules: "
                  f"{rec['rule_argument_bytes']}), argument + temp "
                  f'{live:.2f} GiB a device, collectives {sorted(kinds)}')
            if mem['argument_bytes'] != rec['rule_argument_bytes']:
                fail(f'(t1) {arch} {shape} {mesh}: the recorded argument '
                     f'bytes are not the rules\' shard bytes')
            if not kinds <= set(T_KINDS):
                fail(f'(t1) {arch} {shape} {mesh}: collective kinds '
                     f'{sorted(kinds - set(T_KINDS))} of no known name')
            out[(arch, shape, mesh)] = rec
        t2 = json.loads(_dryrun_log(jobs, 't2').strip().splitlines()[-1])
    finally:
        _stop(jobs['procs'])
        shutil.rmtree(jobs['dir'], ignore_errors=True)
    dry = t2['memory']['argument_bytes'] + t2['memory']['temp_bytes']
    card = q1['step_peak_bytes'] + q1['step_arg_bytes']
    ratio = dry / card
    counted = (q1['step_peak_counted'] + q1['step_arg_bytes']) / card
    print(f'{tag} (t2) {LM_ARCH} train step {Q_BATCH} x {Q_SEQ} on the '
          f"1 x 1 mesh: FLOPs dry-run {t2['flops']:.6e}, FlopCounterMode "
          f"over the card's step {q1['step_flops']:.6e}; argument + temp "
          f'{dry / 2 ** 30:.3f} GiB against the card\'s peak '
          f"{q1['step_peak_bytes'] / 2 ** 30:.3f} GiB over (q2)'s last "
          f"plain step + its arguments {q1['step_arg_bytes'] / 2 ** 30:.3f} "
          f'GiB: ratio {ratio:.4f} (limit {T_MEM_TOL} either way); the '
          f'step under FlopCounterMode peaks at {counted:.4f} x the plain '
          f"step's; traced in {t2['trace_s']} s")
    if t2['flops'] != q1['step_flops']:
        fail('(t2): the dry-run\'s FLOPs are not those of the card\'s step')
    if abs(ratio - 1) > T_MEM_TOL:
        fail(f'(t2): the dry-run\'s memory is {ratio:.3f} x the card\'s')
    print(f'{tag} (t) waited {waited:.1f} s for the dry-runs '
          f'({time.perf_counter() - jobs["t0"]:.1f} s since their start)')
    return {'t1': out, 't2': t2, 't2_mem_ratio': ratio, 'waited_s': waited}


def grouped_by_weight(forward, default_conv):
    """``forward`` (``cnn_forward``) with every unfactored conv's groups
    read off its weight: the input's depth over the weight's input depth,
    which is what the forward passes for every conv of a configuration.
    No configuration has a grouped conv of per-group depth > 1; so a model
    with one goes through ``export_cnn`` and serving."""
    def fwd(params, cfg, x, *, conv_fn=None, **kw):
        inner = conv_fn or default_conv

        def conv(p, h, *, groups=1, **k):
            if 'u' not in p:
                w = p['w'] if 'w' in p else p['w_q']
                groups = h.shape[-1] // w.shape[2]
            return inner(p, h, groups=groups, **k)
        return forward(params, cfg, x, conv_fn=conv, **kw)
    return fwd


@contextlib.contextmanager
def grouped_forward():
    from repro_torch.models import cnn as cnn_lib
    real = cnn_lib.cnn_forward
    cnn_lib.cnn_forward = grouped_by_weight(real, cnn_lib.conv)
    try:
        yield
    finally:
        cnn_lib.cnn_forward = real


@contextlib.contextmanager
def recording_fallback(calls):
    """Append (args, kwargs, output) of every ``ref.quant_conv_ref`` call
    outside a kernel wrapper (the fp32 fallback at both tiers) to
    ``calls``."""
    from repro_torch.kernels import inside_wrapper, ref
    real = ref.quant_conv_ref

    def spy(*a, **k):
        y = real(*a, **k)
        if not inside_wrapper():
            calls.append((a, k, y))
        return y
    ref.quant_conv_ref = spy
    try:
        yield
    finally:
        ref.quant_conv_ref = real


def grouped_tier(torch, tag, tier, params, cpu_params, cfg, x,
                 want_launches=None):
    """One (u) tier: ``export_cnn`` on the card (``resident``: calibrated
    on ``x``, ``verify='strict'``; ``dynamic``: no plan) and
    ``model.serve(x)`` counted (``quant_matmul`` launched as often as the
    plan counts, ``want_launches`` where there is none); its one fallback
    call held against
    ``ref.quant_conv_ref`` on the CPU on the same int8 codes and scales;
    the served logits of 4 images against the CPU export's with every
    quantization site fed the card's codes (the resident tier on the
    card's scales, as path (a))."""
    from repro_torch.core.export import export_cnn
    from repro_torch.kernels import counts, ref, reset_counts
    resident = tier == 'resident'
    small = x[:4]
    model = export_cnn(params, cfg, device='cuda',
                       calibrate=x if resident else None,
                       verify='strict' if resident else None)
    out = {}
    if resident:
        e, summ = model.plan.layers[U_LAYER], model.plan.summary()
        want_launches = summ['kernel_launches']
        out.update(mac_fraction=summ['fallback_mac_fraction'],
                   plan_launches=want_launches)
        print(f"{tag} {tier}: the served model's plan: {U_LAYER} "
              f"fallback={e['fallback']} launches={e['launches']} groups "
              f"{e['groups']} macs {e['macs']}; n_fallback "
              f"{summ['n_fallback']}, fallback MAC fraction "
              f"{summ['fallback_mac_fraction']:.4f}, kernel launches "
              f"{summ['kernel_launches']}; analyzer ok "
              f'{model.analysis.ok}')
        if not e['fallback'] or e['launches'] != 0 or \
                summ['n_fallback'] != 1 or not model.analysis.ok:
            fail(f'(u) {tier}: the grouped conv is not the plan\'s only '
                 f'fallback, or the analyzer found an error')
    calls = []
    torch.cuda.synchronize()
    reset_counts()
    with recording_fallback(calls):
        lg = model.serve(x)
        torch.cuda.synchronize()
    launched = {k: v['launches'] for k, v in counts().items()
                if v['launches']}
    plain = sum(v['plain_calls'] for v in counts().values())
    out['launches'] = launched
    if len(calls) != 1:
        fail(f'(u) {tier}: {len(calls)} fallback calls in one pass')
    a, k, y = calls[0]
    host = [t.cpu() if torch.is_tensor(t) else t for t in a]
    want = ref.quant_conv_ref(*host, **k)
    err = max_err(torch, y.cpu(), want) / float(want.abs().max())
    out['err'] = err
    print(f'{tag} {tier}: served {tuple(x.shape)} -> {tuple(lg.shape)}; '
          f'launches {launched}, plain calls {plain}; the fallback on '
          f'{tuple(a[0].shape)} {a[0].dtype} codes, groups '
          f"{k.get('groups')}, {tuple(y.shape)} {y.dtype} out: card against "
          f'the CPU on the same codes {err:.3e} x max|y| (limit {U_TOL})')
    if tuple(a[0].shape) != U_SHAPE or a[0].dtype != torch.int8 or \
            y.dtype != torch.float32 or err > U_TOL:
        fail(f'(u) {tier}: the card\'s fallback conv is {err:.3e} x max '
             f'from the CPU\'s, or not int8 {U_SHAPE} in and fp32 out')
    if plain or launched != {'quant_matmul': want_launches}:
        fail(f'(u) {tier}: served on other kernels than the plan counts')
    if tuple(lg.shape) != (x.shape[0], cfg.num_classes) or \
            not bool(torch.isfinite(lg).all()):
        fail(f'(u) {tier}: the served logits are malformed')
    cpu = export_cnn(cpu_params, cfg, device='cpu',   # on the card's scales
                     calibrate=small.cpu() if resident else None)
    if resident:
        share_scales(model.plan, cpu.plan)
        lg4, sites, _ = static_sites(torch, lambda: model.serve(small))
        fed = fed_check(torch, lg4, sites, lambda: cpu.serve(small.cpu()))
        ok, diff = fed['ok'], fed['diff'] / fed['scale']
        print(f"{tag} {tier}: card vs CPU on 4 images, the CPU on the "
              f"card's scales and fed its codes at each of {fed['sites']} "
              f"static requantizes: {fed['flips']} of {fed['codes']} codes "
              f"differ, by at most {fed['step']:g} step, the farthest "
              f"{fed['tie']:.3e} from a tie (limit {TIE_TOL:g}); logits "
              f'{diff:.3e} x max|logit| (limit 4e-2)')
    else:
        lg4, sites, _ = act_sites(torch, lambda: model.serve(small))
        fed, _, cmp = act_sites(torch, lambda: cpu.serve(small.cpu()),
                                forced=sites)
        rel = max(c['rel'] for c in cmp)
        step = max(c['step'] for c in cmp)
        tie = max(c['tie'] for c in cmp)
        diff = float((lg4.cpu() - fed).abs().max()) / max(
            float(fed.abs().max()), 1.0)
        ok = rel <= SCALE_RTOL_EXACT and step <= 1 and tie <= TIE_TOL and \
            diff <= DYN_TOL
        print(f'{tag} {tier}: card vs CPU on 4 images, each CPU layer fed '
              f"the card's int8 input at {len(cmp)} dynamic scales: scales "
              f'within {rel:.3e} (limit {SCALE_RTOL_EXACT:g}), '
              f"{sum(c['codes'] for c in cmp)} codes differ, by at most "
              f'{step:g} step, the farthest {tie:.3e} from a tie; logits '
              f'{diff:.3e} x max(max|logit|, 1) (limit {DYN_TOL:g})')
    out['cpu_diff'] = diff
    if not ok:
        fail(f'(u) {tier}: the served model disagrees with the CPU\'s '
             f'export fed the card\'s codes')
    return out


def grouped_conv_path(torch):
    """Path (u): the grouped-conv fp32 fallback, served.  Path (a)'s
    resnet34-cifar (W8A8, random weights from SEED, exit heads) with
    ``U_LAYER`` cut to ``U_GROUPS`` groups of depth 32, ``cnn_forward``
    reading each conv's groups off its weight (``grouped_forward``):
    ``export_cnn`` at both tiers on the card and on the CPU and
    ``serve`` (:func:`grouped_tier`).  Returns readings."""
    from repro_torch.core.export import to_device
    tag = '[grouped-conv]'
    t0 = time.perf_counter()
    fam, params, cfg = path_model(torch, PATHS[0])
    conv = params['stages'][U_BLOCK[0]][U_BLOCK[1]]['conv2']
    depth = conv['w'].shape[2] // U_GROUPS
    conv['w'] = conv['w'][:, :, :depth, :].contiguous()
    x = fam.eval_batches(1, U_SHAPE[0])[0][0]
    cpu_params = to_device(params, 'cpu')
    out = {}
    with grouped_forward():
        out['resident'] = grouped_tier(torch, tag, 'resident', params,
                                       cpu_params, cfg, x)
        out['dynamic'] = grouped_tier(
            torch, tag, 'dynamic', params, cpu_params, cfg, x,
            want_launches=out['resident']['plan_launches'])
    out['secs'] = time.perf_counter() - t0
    print(f"{tag} {cfg.name} with {U_LAYER} in {U_GROUPS} groups of depth "
          f"{depth}: path took {out['secs']:.1f} s")
    return out


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
    pipe = Pipeline.from_sequence(CHAIN_SEQUENCE, CHAIN_HPS,
                                  verify_order=True)
    print(f'{tag} {CHAIN_SEQUENCE} built with verify_order=True: '
          f'{pipe.verify_order()}')
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
    max_len = LM_PROMPT + LM_TOKENS + LM_SPARE
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
    """Run ``fn()`` under the kernel-call recorder (``kernels.recording``):
    ``[(kernel, args as the wrapper binds them)]`` in call order."""
    from repro_torch.kernels import recording
    with recording(keep_args=True) as calls:
        out = fn()
    return out, [(c.kernel, c.args) for c in calls]


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


def op_diff(a, b):
    """The first difference between two recorded runs' writes (ops outside
    the kernel wrappers, then kernel calls), as text, or None."""
    ka = [(o.name, o.nbytes) for o in a.ops if o.transfer != 'h2d']
    kb = [(o.name, o.nbytes) for o in b.ops if o.transfer != 'h2d']
    ca = [(c.kernel, c.out_bytes) for c in a.calls]
    cb = [(c.kernel, c.out_bytes) for c in b.calls]
    for what, x, y in (('op', ka, kb), ('kernel call', ca, cb)):
        for i, (u, v) in enumerate(zip(x, y)):
            if u != v:
                return f'{what} {i}: card {u}, CPU {v}'
        if len(x) != len(y):
            return f'{len(x)} {what}s on the card, {len(y)} on the CPU'
    return None


def verify_path(torch, served):
    """Path (j): the analyzer (``repro_torch.analysis``) on the card,
    counted from zero.  Every order of CHAIN_SEQUENCE linted by
    ``Pipeline.verify_order`` (the green ones must be those
    ``planner.theoretical_dag`` allows); (a)-(c) re-exported at full width
    with ``export_cnn(verify='strict')`` on 32 images and (g)'s served
    chain export checked with ``analysis.check(strict=True)``, each
    report printed (rules run and skipped, the recorded kernel calls
    against the wrappers' counters, op-traffic's measured over predicted
    bytes); each export's recorded writes on the card against the CPU's
    on 2 images (printed, the first op that differs named); then the
    gate, ``analysis.gate.main(['--device', 'cuda'])``, which must return
    0.  Returns (the launches of every kernel, readings)."""
    import itertools
    from repro_torch import analysis
    from repro_torch.analysis import gate
    from repro_torch.analysis.walker import record_run
    from repro_torch.core import planner
    from repro_torch.core.chain import Pipeline
    from repro_torch.core.export import export_cnn, to_device
    from repro_torch.core.family import CNNFamily
    from repro_torch.data import SyntheticImages
    from repro_torch.kernels import counts, reset_counts

    tag = '[verify]'
    fam = CNNFamily(SyntheticImages(), device='cuda')
    calib = fam.eval_batches(1, SLOTS)[0][0]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    perms = [''.join(p) for p in itertools.permutations(CHAIN_SEQUENCE)]
    edges = planner.theoretical_dag(CHAIN_SEQUENCE)
    green = [q for q in perms if Pipeline.from_sequence(q).verify_order().ok]
    allowed = [q for q in perms
               if all(q.index(a) < q.index(b) for a, b in edges)]
    print(f'{tag} order-dag over all {len(perms)} orders of '
          f'{CHAIN_SEQUENCE}: {len(green)} green {green}; the theoretical '
          f'DAG {edges} allows {len(allowed)}')
    if green != allowed:
        fail('order-dag: the green orders are not those the DAG allows')
    readings = {'orders_green': len(green)}
    targets = [(spec['key'], spec, *served[spec['key']]) for spec in PATHS]
    targets.append((CHAIN_KEY, None, *served[CHAIN_KEY]))
    for key, spec, model, params in targets:
        select = 'fused' if spec and spec['factorize'] else 'model'
        t1 = time.perf_counter()
        try:
            if spec is None:
                rep = analysis.check(model, strict=True,
                                     target=f'{model.cfg.name} chain')
            else:
                rep = export_cnn(params, model.cfg, device='cuda',
                                 calibrate=calib, select_kernels=select,
                                 verify='strict').analysis
        except analysis.AnalysisError as e:
            print(e.report)
            fail(f'{key}: the export is not strict-green on the card')
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        print(f'{tag} {key}: ' + str(rep).replace('\n', f'\n{tag}   '))
        traffic = next(f.message for f in rep.by_rule('op-traffic'))
        ratio = float(re.search(r'\(([0-9.]+)x', traffic).group(1))
        small = calib[:2]
        card = export_cnn(params, model.cfg, device='cuda', calibrate=small,
                          select_kernels=select)
        cpu = export_cnn(to_device(params, 'cpu'), model.cfg, device='cpu',
                         calibrate=small.cpu(), select_kernels=select)
        rc = record_run(card.fn, card.params, small)
        rp = record_run(cpu.fn, cpu.params, small.cpu())
        print(f'{tag} {key}: {secs:.2f} s (export and analysis, '
              f'{calib.shape[0]} images); one fn call on 2 images writes '
              f'{rc.written_bytes()} bytes on the card, '
              f'{rp.written_bytes()} on the CPU ({len(rc.ops)} and '
              f'{len(rp.ops)} ops, {len(rc.calls)} and {len(rp.calls)} '
              f'kernel calls): '
              + (op_diff(rc, rp) or 'equal, op by op'))
        readings[key] = {'checked': rep.checked, 'skipped': rep.skipped,
                         'traffic_ratio': ratio, 'secs': secs,
                         'card_bytes': rc.written_bytes(),
                         'cpu_bytes': rp.written_bytes()}
    t1 = time.perf_counter()
    rc = gate.main(['--device', 'cuda'])
    print(f'{tag} analysis.gate --device cuda returned {rc} in '
          f'{time.perf_counter() - t1:.2f} s')
    if rc:
        fail('the analysis gate failed on the card')
    launches = {k: v['launches'] for k, v in counts().items()}
    for name in ('quant_matmul', 'depthwise_conv', 'lowrank_conv'):
        if not launches[name]:
            fail(f'verify: {name} was never launched on this path')
    readings['secs'] = time.perf_counter() - t0
    return launches, readings


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
        for q, c, valid, *cap in calls:
            args = (q, c['k'], c['v'], c['k_s'], c['v_s']) if 'k_s' in c \
                else (q, c['k'], c['v'])
            kind = 'int8' if 'k_s' in c else (
                'bf16' if q.dtype == torch.bfloat16 else 'fp32')
            cs.append(da_case(torch, args, valid, kind, iters=10,
                              cap=cap[0] if cap else 0.0))
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
    dryruns = start_dryruns()            # after the timed kernel phases
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
    launches[VERIFY_KEY], verified = verify_path(torch, served)
    print(f"[time] path {VERIFY_KEY} took {verified['secs']:.1f} s, done at "
          f"{time.perf_counter() - t_start:.1f} s")
    for label, specs in (('k', K_PATHS), ('l', L_PATHS), ('m', M_PATHS),
                         ('n', N_PATHS), ('o', O_PATHS), ('p', P_PATHS)):
        t0 = time.perf_counter()
        for spec in specs:
            counted, calls, _ = serve_lm_path(torch, spec)
            if spec['kernel']:
                lm_calls[spec['key']] = (spec['kernel'], calls)
            lm_launches[spec['key']] = counted
            print(f"[time] path {spec['key']} done at "
                  f"{time.perf_counter() - t_start:.1f} s")
        print(f'[time] path ({label}) took {time.perf_counter() - t0:.1f} s')
    q = train_mesh_path(torch)
    print(f'[time] path (q) done at {time.perf_counter() - t_start:.1f} s')
    launches[R_KEY], _ = pipeline_path(torch, served[PATHS[0]['key']][0])
    print(f'[time] path (r) done at {time.perf_counter() - t_start:.1f} s')
    launches[S_KEY], _ = moe_ep_path(torch)
    print(f'[time] path (s) done at {time.perf_counter() - t_start:.1f} s')
    grouped_conv_path(torch)
    print(f'[time] path (u) done at {time.perf_counter() - t_start:.1f} s')
    dryrun_path(torch, dryruns, q['q1'])
    print(f'[time] path (t) done at {time.perf_counter() - t_start:.1f} s')
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
