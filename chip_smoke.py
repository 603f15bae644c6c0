"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for matmuls and convolutions.
2. build   — nvcc builds ``src/repro_torch/csrc/*.cu`` into one library.
3. kernels — each hand-written kernel against its plain torch version
   on the card over a sweep of shapes, then timed with CUDA events
   (median of 21 blocks after warm-up) beside its bound; the public
   ``softmax_confidence`` op on (..., V) card tensors against the CPU.
   The exit gate at every case of ``gate_cases`` (V from 1 to 129 280,
   1 to 1500 rows, each dtype, logits not 16-byte aligned, each side of
   each threshold of its C launcher between routes and between classes
   of the warp route): conf and entropy within
   1e-5 of float64 and of the plain version, pred equal to it and to
   the planted first argmax (ties across a split chunk boundary, the
   max in the last chunk), fire equal outside edge rows; each row
   carries its route, the library call's time
   (``torch.softmax(x.float(), -1).max(-1)``), bound_fraction and the
   launch floor (an empty kernel timed the same way), and the cases
   must take every route.  The floor and the main path's gate are also
   timed behind a one-element torch kernel, as the engine calls the gate.
   The LM exit head at (n_slots in 1, 16, 64, 100; 2048; 32000) and
   (7, 72, 1003) in bf16 and f32, at (256, 2048, 32000) bf16 (one table
   read for 256 rows) and at (5, 70, 1003) bf16 (rows that TMA cannot
   describe): conf within 1e-5 of a float64
   evaluation of the kernel's own fp32 semantics, pred equal to it
   outside rows whose float64 top-2 gap is < 1e-4, and against the
   plain bf16 chain pred equal outside its bf16 ties (top-2 gap within
   one ulp of the max) and fire equal outside |conf - tau'| < 1e-5, both
   exemptions counted; planted tau' = conf rows never fire.  Each row of
   exit_head and difficulty carries bound_fraction = bound_ms / ms and
   host_ms, the host's time for one call of the wrapper.  The
   paged gather bit-equal to its plain version at the decoder's shapes,
   with page ids past both ends in the table.
4. engine  — VGG-16/CIFAR-10 at full width (4 exits, ~15.5 M params,
   seeded random init) through ``DartEngine``: calibration on
   synth-CIFAR, the joint-DP policy, then a median policy so rows exit
   at several stages; batches of 1, 64, 256, 1024 and 1500 (split) in
   masked and compacted mode; ``update()`` and ``stats()``.  Masked and
   compacted must agree outside the counted threshold-edge rows, at
   least two exits must be taken, the kernel launch counts of this run
   must be exactly what the path implies, and a small batch must agree
   with the same engine on the CPU (plain torch versions).
   Each batch is served five times in each mode; samples/s is the
   median of the last four.  Then one row is served masked ten times
   with a ``count_macs`` scope open and ten times closed, alternated:
   what the MAC count costs the serving path when it is on.
5. engine  — the same for AlexNet/CIFAR-10, and for ResNet-18/CIFAR-10
   (basic blocks 2-2-2-2, width 64, inference batchnorm, 4 exits,
   ~11.2 M params), whose phase first runs ``measure_costs`` and emits
   the cumulative MACs per exit it installs; then for LeViT-256 (Table
   II; 3 exits, ~13.2 M params, batchnorm on the (B, N, C) tokens),
   whose ``measure_costs`` must also agree with XLA's count pinned in
   ``LEVIT_XLA_CUM_MACS`` to ``LEVIT_MACS_RTOL``.
   vision — the assigned vision archs at full width, bf16 and 224 x 224
   on seeded random init, each built from its arch id
   (``DartEngine.from_config("vit-s16", params)``): ViT-S/16, ConvNeXt-B,
   ViT-H/14 and ResNet-152 (bottleneck blocks, the ImageNet stem).  One
   pool of 1280 synth-CIFAR images at 224 pixels is drawn first in
   worker processes and shared: 256 calibration rows, then batches of
   1, 64, 256 and 1024 rows (ViT-H/14 and ResNet-152 stop at 256).  Each
   phase is an ``engine`` phase as above: ``measure_costs`` within
   ``LEVIT_MACS_RTOL`` of ``VISION_XLA_CUM_MACS``, joint-DP then a median
   policy, both modes, launch counts exact, at least two exits, masked
   and compacted equal outside edge rows (in bf16 also rows whose conf
   is within ``BF16_EDGE_RTOL`` of tau': the modes' other batch shapes
   may take other kernels); ViT-S/16 (8 rows) and ConvNeXt-B (4 rows)
   against the CPU in bf16 (``check_against_cpu_bf16``).
   train   — AlexNet, VGG-16 and ResNet-18 on CIFAR-10 at full width,
   each from the port's seeded init (seed 0), trained through
   ``Trainer`` with Table I's protocol (synth-CIFAR, 4096 training rows,
   batch 32, lr 3e-3, AdamW under warmup-cosine; 150, 100 and 120
   steps), its batches from ``DataPipeline``'s prefetch thread.  Step 1
   on the card must match the same step on the CPU: the loss, each
   leaf's gradient, the update that the CPU's optimizer makes from the
   card's gradients, and the batchnorm statistics; then the mean loss
   of the last 10 steps must be below that of the first 10 (VGG-16,
   which has no batchnorm, is reported if it does not learn).  Each
   line: ms per step (median, p90), the share of the run spent waiting
   on the data thread, ms per step of a second trainer with no data
   thread running and ms to draw one batch, the first and last loss,
   per-exit accuracy on 512 eval rows, and for ResNet-18 whether every
   running statistic moved and is finite.  No fused kernel may launch
   while training, and serving the trained ResNet-18 (policies) must
   launch both of the classifier path's.
   policies — on the ResNet-18 weights the train phase trained:
   calibration (512 rows) and a
   holdout (512 rows at offset 1024); ``static``, ``branchynet``,
   ``rl_agent`` and ``joint_dp`` fitted on the calibration rows and the
   holdout routed with ``route_policy``; per method the exit histogram,
   mean normalised MACs, accuracy and ``daes.summary_row`` against
   static, whose time column is the cumulative stage time at the routed
   exit (stem, stages and exit heads timed with CUDA events at batch 64,
   per sample; DART adds the difficulty kernel's time).  One short run
   on synthetic data: the rows are no Table I result.
   The installed cumulative MACs and each method's routed MACs must
   agree to 1 % with XLA's count of ResNet-18 (``RESNET18_XLA_CUM_MACS``);
   static must route every row to the last exit; and the holdout served
   on the card under joint_dp's policy, and under that policy with tau
   at each exit's calibration median (masked and compacted, no
   adaptation), must leave at ``route_policy``'s exits outside rows at a
   gate's edge.  joint_dp's exit histogram is reported; no early exit
   is asserted.
   serving — the trained ResNet-18 under joint_dp's policy (no
   adaptation) behind ``repro_torch.serving.AsyncDartServer``: open-loop
   Poisson streams of single eval images from a 1024-image pool drawn
   before the phase, deadline 50 ms, priorities 0/1, each 2 s long:
   masked with the default ``SchedulerConfig`` at 200, 2000 and 20000
   offered requests/s, then compacted and compacted with
   ``predict="conservative"`` at 2000/s.  Per run: offered and
   submitted rate, completed samples/s, p50/p95/p99 latency from the
   scheduled arrival, miss rate, shed and rejected counts, buckets by
   flush reason and mean size, and the median and p99 host time of
   ``submit()``.  Checks: every future resolves, completed + shed +
   rejected = submitted, every completed result leaves at the exit and
   with the pred of its image served alone through ``engine.infer``
   (outside that oracle's gate-edge rows: conf within EDGE of a tau'
   below 1; a saturated head, conf = 1 at a tau' clipped to 1, cannot
   fire, so its rows are compared and counted apart), the conservative
   run answers
   as the run with prediction off, one ``difficulty`` launch per
   admission and the gate launched.  Then the reference's baseline (one
   ``engine.infer`` per request, FIFO) on the first 1000 requests of the
   2000/s stream; the host time of admission (on the default stream,
   and on a stream of its own), idle and with a 64-row bucket in
   flight on another thread; a one-row ``infer`` alone and with a
   thread submitting back to back; and the scheduler with one
   launching thread at a time (2048 requests submitted to a stopped
   server, then served); last, the 200/s stream once more with
   ``repro_torch.obs`` on, whose spans say where the latency goes
   (admission, submit to dispatch, dispatch to completion).  The phase
   must take at most 60 s.
   resilience — the same trained ResNet-18 and policy: (a) its
   ``EngineState`` saved and restored into a fresh engine, every leaf
   bit-equal and the next masked infer equal bit for bit (save/restore
   ms, MB); (b) ``PooledDartServer`` over two engines in compacted mode
   (every engine call gates through ``exit_gate``), 384 single images
   submitted back to back, once without faults and once under a seeded
   ``FaultPlan`` (a straggler the pool hedges, a NaN output it
   quarantines, a raise at dispatch it retries, a queue stall, an
   engine death): every future resolves exactly once, requests no fault
   or rung touched equal their bucket served by one engine alone bit for
   bit, one ``difficulty`` launch per submit, ``exit_gate`` launches
   equal to the stages the engine calls gated; samples/s, retries,
   hedges, quarantines, requeues, the rung timeline and the ms from a
   death to the next success; (c) two engines behind four pool slots
   drained to rung 4 (priority 0 shed, the requeue bounded) and joined
   back from a snapshot (the joining engine's state is the snapshot's):
   rungs 1-2-3-4, then 3-2-1-0; at rung 3 no row of a 64-row bucket
   leaves past the cap stage, in either mode; (d) the trainer's
   crash-resume at Table I's batch (8 steps straight against 4 + crash
   + resume 4): the restored tree bit-equal to the one saved; with
   cuDNN's default algorithms the resumed losses within RES_LOSS_RTOL
   of the straight run's, with its deterministic ones the resumed
   losses and final tree bit-equal to it; and the checkpoint's MB and
   save, async copy, background write and restore ms.  Checkpoints go
   under ``build/`` and are removed.
   table2 — Table II's protocol (benchmarks/table2.py) on weights the
   port trained: LeViT-128S, LeViT-192 and LeViT-256 at full width, each
   trained as in the train phase (120 steps, one ``table2-train`` line
   each, step 1 against the CPU, the loss must fall, every running
   statistic must move), then ``static`` and ``joint_dp`` fitted and
   routed as in the policies phase (one ``table2`` line each: accuracy,
   routed MACs, time at the routed exit from CUDA-event stage times,
   speedup, exit histogram and ``levit_macs``).  Checks: no fused
   kernel launched while training; installed and routed MACs within
   ``LEVIT_MACS_RTOL`` of XLA's count; static at the last exit; the
   holdout served on the card leaves at ``route_policy``'s exits.  No
   accuracy and no early exit is asserted: synth-CIFAR is no Table II
   result.
6. lm-strict — TinyLlama-1.1B at full width in fp32, 11 of its 22
   layers (exits after layers 2, 5 and 7; the script's time; seeded
   random weights, tau per exit from quantiles of the first step's
   conf): 40 requests of 16 new tokens over 16 slots (prompts of 16 to
   64 tokens, admitted at most 4 a step, so admission and release happen
   mid-run) through ``ContinuousLMDecoder`` (both kernels), against the
   eager oracle on the card (plain head), decision by decision on the
   served context (``lm_decisions``: every (request, step) is one row;
   the two sides' hidden rows through one float32 head within
   LM_TRUNK_TOL; a decision may differ only where the two sides'
   measured logit or conf difference allows it; the compared decisions
   at least half).
7. lm-serving — the published bf16 configuration at a cut depth (6 of
   22 layers, exits after layers 1, 2 and 3: the script's time) at
   n_slots 16 and 64 (max_len
   1024): tokens/s (median of the timed runs), the decode step and
   per-request prefill times, the exit-stage histogram, the mean
   layer fraction, peak memory, a torch.profiler window of decode steps
   (device busy share, kernels per step, the exit heads' device ms per
   step, the kernels that take the time), and the launches of exit_head
   and paged_gather, exactly 4 and 12 per decode step; at 16 slots the
   untimed warm-up run held to the bf16 eager oracle as in lm-strict.
8. lm-train — TinyLlama-1.1B at full width and 11 of its 22 layers
   (exits as lm-strict's; d_model 2048, vocab 32000, bf16, ``remat``;
   the script's time) trained through
   ``Trainer`` from the port's seeded init: AdamW, batch 8 of
   synth-tokens sequences of 257 tokens (max_seq cut to 256: a length,
   not a width) whose motifs use the first 256 token ids, 60 steps.
   Step 1 at a cut depth (2 layers, full width, float32) on the card
   against the CPU: loss and every leaf's gradient.  Prints ms a step
   (the first 57), a torch.profiler window of the last 3 steps, peak
   memory and the loss at steps 1, 10 and 60; the loss at step 60 must
   be below step 1's, and no fused kernel may launch while training.
9. lm-session — the weights lm-train trained, tau from the conf of
   motif prompts: (a) ``LMContinuousSession`` (16 slots, max_len 1024)
   fed 64 requests (prompts of 16-64 tokens of the motif grammar's eval
   sequences, 16-48 new tokens) from a second thread as an open-loop
   Poisson stream at 0.8 x the tokens/s of a drain of the same requests
   just before, divided by the mean new tokens, deadline 2 s: tokens/s,
   p50/p95/p99 latency, misses, ``starved``, launches a decode step
   (exactly 4 exit heads and 22 gathers); every decision held to the
   eager oracle as in lm-strict;
   (b) ``LMDecodeSession`` over the same engine: four lanes forced out
   as four buckets, each request equal to ``generate`` on its bucket;
   (c) ``pooled_lm_session`` over two engines sharing one param tree
   under a seeded plan that kills one engine once: every request
   resolves exactly once, each untouched one bit-equal to its bucket on
   one engine.
10. lm-internlm — InternLM2-20B at its published width (d_model 6144,
   48/8 heads, d_ff 16384, vocab 92544) and 24 of its 48 layers (exits
   after layers 5, 11 and 17; the script's time; ~10.5 B parameters in
   bf16, seeded random weights drawn on the card) through
   ``ContinuousLMDecoder`` at 16 slots and max_len 512, 32 requests:
   tokens/s, decode-step ms, peak memory, exits, launches exact, a
   profiler window of decode steps with 16 slots full (as lm-serving's); 4
   requests of the served bf16 run held to the eager oracle as in
   lm-strict, and as a witness beside it the same requests at full
   width in float32 at 8 layers (``lm_internlm_fp32``).
   The kernels phase holds
   exit_head at (16, 6144, 92544) bf16 and paged_gather at InternLM2's
   K/V views against their plain versions.
11. lm-granite — granite-moe-3b-a800m at its published width and depth
   (32 layers, d_model 1536, 24/8 heads, a MoE FFN in every layer: 40
   experts of d_ff 512, top-8; vocab 49155; ~3.3 B parameters, ~0.8 B
   active a token, bf16, seeded random weights drawn on the card)
   through ``ContinuousLMDecoder`` at 16 slots, page 8, max_len 512, 32
   requests drawn as lm-internlm's.  A MoE call's capacity drops the
   later pairs of a busy expert, so a row's output depends on the rows
   that share the call: the eager oracle (compacted survivors) routes
   other rows, and the served run is held instead to the step-replay
   oracle (``lm_step_replay``): each served step runs again from its
   snapshot with the plain exit head and gather and the served fire
   pattern imposed; every stage's hidden rows must be bit-equal to the
   served ones, and every decision of the plain head is compared as in
   lm-strict.  A second run from a fresh pool is timed (tokens/s,
   decode-step and admission ms, launches exact, peak memory, a
   profiler window) and must decide the same.  The independent MoE
   check (``moe_card_check``) holds the bf16 ``moe_apply`` on one
   served decode step's and one 64-token prefill's MoE inputs at three
   layers to a float32 per-token reference routed in float64 on the
   host: the kept pairs equal, the outputs within a tolerance derived
   from the dense SwiGLU's measured bf16 error; the prefill must drop
   pairs.  The kernels phase holds exit_head at (16, 1536, 49155) bf16
   and paged_gather at granite's views against their plain versions.
12. the kernels summary line, every number in it measured or computed
   in this run (the gate's and the difficulty kernel's launches in the
   serving, resilience (the faulted run), LeViT-256 engine and table2
   phases beside VGG-16's; under
   ``vision224`` each one timed at the vision phases' shape, the gate
   at (1024, 1000) bf16 and ``difficulty`` at (1024, 224, 224, 3), with
   the launches of those phases; the LM kernels' launches in lm-session
   (a), lm-internlm and lm-granite, and under ``internlm`` and
   ``granite`` their times at those models' shapes), then the ``ok``
   line.

Every decision check that exempts rows at a gate's edge (masked against
compacted, card against CPU, the card's routes, serving against each
image alone, the LM against its eager oracle) prints the rows it
compared and exempted and must compare at least half (COMPARED_FLOOR);
where its policy cannot (saturated heads), a second check beside it
runs under a policy whose tau' stays below 1 - 10 tol (``low_tau``).
The LM checks' rows are decisions, each made by the served path and
the oracle on the same context.

Any failed check raises: the script exits non-zero and prints no ``ok``
line.  Without CUDA it exits 1 before printing anything.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside
#: the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: tensor-core peaks, dense: bf16 and TF32
BF16_TC_OPS_PER_S = 989e12
TF32_TC_OPS_PER_S = 495e12

#: tolerances of the kernel checks (and why)
CONF_TOL = 1e-5       # fp32 sums over V in another order
EDGE = 1e-5           # |conf - tau'| below this may flip the strict `>`
ALPHA_TOL = 1e-6      # alpha_var / alpha_grad: fp32 means
CPU_EDGE = 1e-4       # card vs CPU: convolutions by other algorithms
CPU_CONF_TOL = 1e-4

#: RESNET18_CIFAR's cumulative MACs per exit as XLA's cost analysis counts
#: them: the JAX engine's ``measure_costs((32, 32, 3))`` on the CPU, which
#: tests/test_torch_engine.py holds the port's count against.  The card's
#: count and each method's routed MACs must agree with it to MACS_RTOL.
RESNET18_XLA_CUM_MACS = np.array([145720069.0, 270493381.0, 385371717.0,
                                  482118981.0])
MACS_RTOL = 0.01
#: LEVIT_128S/192/256's (Table II) cumulative MACs per exit, counted the
#: same way (tests/test_torch_levit.py pins the same numbers).  The port
#: counts the products and the token layers' elementwise flops as XLA
#: does; XLA's fusion counts the scale and bias of the attention scores
#: twice, which leaves the port 0.06-0.2 % below at these widths
LEVIT_XLA_CUM_MACS = {
    "levit-128s": np.array([16643622.0, 44686024.0, 63443367.0]),
    "levit-192": np.array([55225398.0, 95464062.0, 112654589.0]),
    "levit-256": np.array([96710726.0, 165505926.0, 195993989.0]),
}
LEVIT_MACS_RTOL = 0.005
#: the assigned vision architectures (full width, bf16, 224 x 224,
#: seeded random init) and the largest batch each engine phase serves
VISION_ARCHS = (("vit-s16", 1024), ("convnext-b", 1024), ("vit-h14", 256),
                ("resnet-152", 256))
#: their cumulative MACs per exit as XLA's cost analysis counts them: the
#: JAX engine's ``measure_costs((224, 224, 3))`` on the CPU, from
#: tools/xla_cum_macs.py (tests/test_torch_vit.py pins the same numbers;
#: XLA's count includes its CPU backend's bf16 converts and its fusion's
#: recomputed residual chains, which ``count_macs`` counts as XLA does).
#: The card's count must agree to LEVIT_MACS_RTOL
VISION_XLA_CUM_MACS = {
    "vit-s16": np.array([1540830725.0, 3081172229.0, 4621687493.0]),
    "vit-h14": np.array([41963774301.0, 83925004637.0, 125886234973.0,
                         167847184349.0]),
    "convnext-b": np.array([1389402181.0, 2806292421.0, 14549518789.0,
                            15917610309.0]),
    "resnet-152": np.array([702401540.0, 2668827140.0, 11164841988.0,
                            11935906564.0]),
}
#: the vision phases' images: synth-CIFAR drawn at 224 x 224 once, in
#: worker processes, and shared by the four phases: VISION_CAL_ROWS
#: calibration rows, then 1024 rows that each phase serves (its batches
#: are prefixes of them); rows of the card checked against the CPU
VISION_CAL_ROWS = 256
VISION_OFFSET = 20000
VISION_CPU_ROWS = {"vit-s16": 8, "convnext-b": 4}
#: card vs CPU in bf16: each side rounds every op's result to 8 bits in
#: its own order, so the logits differ by a few units of bf16's last
#: place (2^-8 of the largest logit) after 12-36 blocks: held to this
#: share of the largest logit; conf to BF16_CONF_RTOL of itself.  A row
#: whose top-2 logit gap, or whose |conf - tau'| at a gate, is within
#: twice the two sides' own difference there may decide otherwise: such
#: rows are counted, not compared, and may be at most half
BF16_LOGIT_TOL = 0.05
BF16_CONF_RTOL = 0.05
#: masked vs compacted on the card in bf16: a gate's conf within this
#: share of itself of tau' (beside EDGE) counts as an edge row.  The
#: modes' other batch shapes may take other kernels; their conf at the
#: same exit differed by at most 1.3e-4 of itself (this script's
#: ``max_mode_conf_rdiff`` on an H100 80GB HBM3 at 700 W), rows of a
#: two-way tie apart
BF16_EDGE_RTOL = 2.0 ** -10

#: passes over each engine batch in each mode; all but the first timed
PASSES = 5

#: every decision check that exempts rows at a gate's edge prints the
#: rows it compared and exempted, and must compare at least this share
#: of its rows.  Where the check's own policy cannot (saturated heads:
#: conf 1 at a tau' clipped to 1), a second check beside it runs under
#: LOW_TAU_Q: tau at that quantile of conf - beta_diff*alpha, capped so
#: that tau' stays below 1 - 10 tol on every row; the saturated rows
#: then fire on both sides and are compared
COMPARED_FLOOR = 0.5
LOW_TAU_Q = 0.25

#: LM exit head: the largest |conf - float64| and the float64 top-2 gap
#: below which the first argmax may differ
HEAD_CONF_TOL = 1e-5
HEAD_GAP = 1e-4
#: LM decode against its eager oracle (``lm_decisions``): the served and
#: the oracle's hidden rows at the same context, through one float32
#: head, held to these shares (logits: of the largest logit; conf: of
#: itself): in bf16 the card-vs-CPU tolerances of the vision phases, in
#: float32 CPU_CONF_TOL.  Where a decision may differ is measured per
#: decision, not set here
LM_TRUNK_TOL = {"bfloat16": (BF16_LOGIT_TOL, BF16_CONF_RTOL),
                "float32": (CPU_CONF_TOL, CPU_CONF_TOL)}
#: Eq. 19 beta_diff of the LM runs: untrained heads give conf near 1/V
#: (~1e-3 at V = 32000), so the paper's 0.3 * alpha would put every tau'
#: far above any conf; 1e-4 keeps the difficulty term a fraction of the
#: spread of conf
LM_BETA = 1e-4
#: timed serving runs per pool size (after one warm-up run)
SERVE_RUNS = 3
#: lm-train: TinyLlama-1.1B at full width (bf16, remat, AdamW
#: under warmup-cosine) on synth-tokens; max_seq cut from 4096 to 256
#: (a sequence length, not a width)
LM_TRAIN_SEQ = 256
LM_TRAIN_BATCH = 8
LM_TRAIN_STEPS = 60
LM_TRAIN_LR = 1e-3
LM_TRAIN_WARMUP = 10
#: its last steps run under torch.profiler (not in the timed median)
LM_TRAIN_PROFILED = 3
#: the token sequences draw their motifs from the first 256 of the 32000
#: ids (``synth_tokens_sample``'s vocab): over all 32000 ids each id is
#: seen a few times in 60 steps and the motif task needs in-context
#: copying, which 60 steps do not teach; over 256 the heads learn the
#: ids in use and the loss falls (PERF.md section 6)
LM_TRAIN_DATA_VOCAB = 256
#: its step 1 against the CPU at a cut depth (full width, float32, TF32
#: off on the card): layers and batch; the loss to fp32 rounding of
#: 2048-long sums in another order, each leaf's gradient relative to its
#: norm to the same rounding carried through two layers and the chunked
#: cross-entropy
LM_CPU_LAYERS = 2
LM_CPU_BATCH = 2
LM_STEP1_LOSS_RTOL = 1e-4
LM_STEP1_GRAD_RTOL = 1e-3
#: lm-session: requests of the continuous session's stream, its slots,
#: the share of the drain's tokens/s offered, each request's deadline;
#: the seed of its arrivals, prompts and fault plan
LM_SESSION_REQUESTS = 64
LM_SESSION_SLOTS = 16
LM_SESSION_LOAD = 0.8
LM_SESSION_DEADLINE_MS = 2000.0
LM_SESSION_SEED = 5
#: lm-internlm: requests served, and how many of them the eager oracle
#: holds
LM_INTERNLM_REQUESTS = 32
LM_INTERNLM_ORACLE = 4
#: its oracle check's second check (``lm_internlm_fp32``): full width in
#: float32 at a cut depth, exits at InternLM2's fractions of depth
LM_INTERNLM_FP32_LAYERS = 8
LM_INTERNLM_FP32_EXITS = (1, 3, 5)
#: lm-granite: requests served (drawn as lm-internlm draws them), the
#: decoder's slots and max_len, and the prompt length of the prefill
#: whose MoE inputs the independent MoE check takes (64 tokens: capacity
#: 16 against a mean load of 12.8 pairs an expert)
LM_GRANITE_REQUESTS = 32
LM_GRANITE_SLOTS = 16
LM_GRANITE_MAX_LEN = 512
LM_GRANITE_PREFILL = 64
#: lm-serving runs TinyLlama at full width and a cut depth (exits at its
#: fractions of depth), which keeps the script within its time with the
#: lm-train, lm-session and lm-internlm phases (PERF.md section 6)
LM_SERVING_LAYERS = 6
LM_SERVING_EXITS = (1, 2, 3)
#: lm-strict, lm-train and lm-session run TinyLlama at full width and 11
#: of its 22 layers, and lm-internlm InternLM2-20B at 24 of its 48, exits
#: at their fractions of depth: with lm-granite added the whole script
#: took 1 098 s of its 1 200 on a slow host (PERF.md section 6)
LM_TINYLLAMA_LAYERS = 11
LM_TINYLLAMA_EXITS = (2, 5, 7)
LM_INTERNLM_LAYERS = 24
LM_INTERNLM_EXITS = (5, 11, 17)

#: the serving phase: open-loop Poisson streams of single eval images
#: (a pool drawn before the phase), each SERVE_SECS long, at these
#: offered rates (requests/s); the deadline of every request; the FIFO
#: baseline's prefix of the 2000/s stream; the phase's time budget
SERVE_RATES = (200, 2000, 20000)
SERVE_SECS = 2.0
SERVE_GRACE_S = 0.5
SERVE_DEADLINE_MS = 50.0
SERVE_POOL = 1024
SERVE_POOL_OFFSET = 3072
SERVE_BASELINE = 1000
SERVE_PHASE_S = 60.0

#: the resilience phase: single eval images (the serving pool) through a
#: PooledDartServer over two engines in compacted mode (every call gates
#: through the exit_gate kernel), buckets of at most RES_MAX_BATCH so
#: that the pool makes many calls; the seeded fault plan's kinds; the
#: trainer crash-resume's steps and crash step (Table I's batch and lr),
#: and the resumed losses' tolerance against the straight run's under
#: cuDNN's default algorithms (card training is then not bit-repeatable
#: after step 1: its backward convolutions sum in a varying order; with
#: its deterministic algorithms the resume is held bit for bit)
RES_REQUESTS = 384
RES_MAX_BATCH = 16
RES_STRAGGLER_S = 0.5
RES_STALL_S = 0.02
RES_STEPS = 8
RES_FAIL_AT = 4
RES_LOSS_RTOL = 1e-2
RES_REPS = 5

#: the train phase: Table I's protocol (benchmarks/table1.py,
#: benchmarks/common.py::train_model): synth-CIFAR with 4096 training and
#: 2048 eval rows, batch 32, lr 3e-3, and each testbed's steps
TRAIN_STEPS = {"alexnet-cifar": 150, "resnet18-cifar": 120,
               "vgg16-cifar": 100, "levit-128s": 120, "levit-192": 120,
               "levit-256": 120}
TRAIN_BATCH = 32
TRAIN_LR = 3e-3
#: eval rows for the per-exit accuracy after training
TRAIN_EVAL_ROWS = 512
#: VGG-16 has no batchnorm, and lr 3e-3 may not train it in 100 steps:
#: a loss that does not fall there is reported, not raised
MAY_NOT_LEARN = ("vgg16-cifar",)
#: step 1 on the card against the same step on the CPU (TF32 off): the
#: loss to fp32 rounding of convolutions by other algorithms; each
#: leaf's gradient relative to its norm: the exit heads to that
#: rounding, every leaf to the ~1e-2 that a ReLU or max-pool input at
#: rounding level of a tie moves the leaves upstream of it (the CPU
#: tests see the same against JAX); the optimizer's update from the
#: same gradients to one fp32 rounding (weights ~1, lr_1 1.5e-4); the
#: batchnorm running statistics as fp32 means over a batch
STEP1_LOSS_RTOL = 1e-5
STEP1_HEAD_GRAD_RTOL = 1e-4
STEP1_GRAD_RTOL = 2e-2
STEP1_UPDATE_TOL = 1e-6
STEP1_STATS_TOL = 1e-5
#: LeViT's step-1 gradients: a leaf whose norm is below this share of
#: the whole gradient's norm is held to STEP1_GRAD_RTOL of that share.
#: A train-mode batchnorm downstream removes what a leaf before it
#: shifts (the batch mean), so such a leaf's gradient is zero in exact
#: arithmetic and only rounding is left (norms and errors ~1e-9 of the
#: whole on the CPU against JAX: the stage-2 blocks before head_bn)
STEP1_GRAD_FLOOR = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def emit(**obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=21, block=20):
    """Median device time of one call: each of ``reps`` blocks queues
    ``block`` calls behind a sleep kernel (so the host's launch overhead
    is hidden) between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(block):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / block)
    return float(np.median(times))


def after_op_ms(fn):
    """Device time that ``fn`` adds when it follows a one-element torch
    kernel, as the engine's gate follows the torch ops of an exit: blocks
    of (op, fn) less blocks of the op alone.  The torch kernel does not
    let the next kernel start early, so ``fn`` cannot overlap it."""
    one = torch.zeros(1, device="cuda")
    op_ms = time_ms(lambda: one.add_(1))
    return time_ms(lambda: (one.add_(1), fn())) - op_ms


def host_ms(fn, calls=100):
    """Host time of one call (argument checks, allocations and launches),
    with the calls queued behind a sleep kernel so that the device never
    holds the host back."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


# ---------------------------------------------------------------------------
# bounds: max(bytes moved / HBM rate, operations / fp32 rate), in ms
# ---------------------------------------------------------------------------

def gate_bound(b, v, itemsize):
    nbytes = b * v * itemsize + b * 4 + b * 16   # logits, tau' | 4 outputs
    ops = 6 * b * v                  # sub, exp, add, sub, mul, add per logit
    return bound(nbytes, ops)


def difficulty_bound(b, h, w, c):
    nbytes = b * h * w * c * 4 + b * 16
    # per pixel: channel sums and squared deviations (4c), gray (5); per
    # valid pixel: Sobel pair (22), magnitude + compare (5), |Laplacian|
    # and its sum (8)
    ops = b * (h * w * (4 * c + 5) + (h - 2) * (w - 2) * 35)
    return bound(nbytes, ops)


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def exact_gate(lg):
    """conf and entropy of the same chain in float64 (the yardstick for
    the rounding of both fp32 versions)."""
    x = lg.double()
    d = x - x.amax(dim=1, keepdim=True)
    e = d.exp()
    s = e.sum(dim=1)
    return 1.0 / s, s.log() - (d * e).sum(dim=1) / s


def gate_inputs(b, v, gen, chunk):
    """Logits (b, v), 4 * N(0, 1), with a planted top value per row: an
    exact tie at i < v // 2 and i + v // 2 in rows 0 mod 4, a tie across
    the boundary of two split chunks of ``chunk`` columns in rows 2 mod 4
    (columns k * chunk - 1 and k * chunk; v // 2 - 1 and v // 2 when the
    row is one chunk), and the max in the last column, so in the last
    chunk, in rows 1 mod 4.  Returns (logits, thresholds, the planted
    first argmax of each row or -1)."""
    lg = torch.randn(b, v, device="cuda", generator=gen) * 4
    want = torch.full((b,), -1, dtype=torch.long, device="cuda")
    if v >= 2:
        top = lg.amax(dim=1) + 1.0
        every = torch.arange(b, device="cuda")
        rows = every[0::4]
        i = torch.randint(0, v // 2, (len(rows),), device="cuda",
                          generator=gen)
        lg[rows, i] = lg[rows, i + v // 2] = top[rows]
        want[rows] = i
        rows = every[2::4]
        chunks = -(-v // chunk)
        if chunks > 1:
            j = torch.randint(1, chunks, (len(rows),), device="cuda",
                              generator=gen) * chunk - 1
        else:
            j = torch.full((len(rows),), v // 2 - 1, device="cuda")
        lg[rows, j] = lg[rows, j + 1] = top[rows]
        want[rows] = j
        rows = every[1::4]
        lg[rows, v - 1] = top[rows]
        want[rows] = v - 1
    th = torch.rand(b, device="cuda", generator=gen)
    return lg, th, want


#: (rows, V, dtype, offset): the logits start ``offset`` elements into a
#: flat buffer, so offset 1 is not 16-byte aligned.  The classifier's
#: 10 classes and 1000 (the ImageNet heads) at 1 to 1500 rows (the
#: engine's two-chunk request; (1024, 1000) bf16 is the vision phases'
#: gate), LM vocabularies (TinyLlama 32 000,
#: DeepSeek 129 280), V = 1, each dtype at V = 10 and 32 000; each side
#: of each route threshold is added by ``gate_cases``.
GATE_CASES = ([(b, v, torch.float32, 0) for b in (1, 7, 256, 1024)
               for v in (10, 1000, 32000, 129280)]
              + [(256, 1000, torch.bfloat16, 0),
                 (1024, 1000, torch.bfloat16, 0),
                 (7, 129280, torch.float16, 0),
                 (1, 1, torch.float32, 0), (1024, 1, torch.float32, 0),
                 (1500, 10, torch.float32, 0)]
              + [(b, v, dt, 0) for b, v in ((1024, 10), (256, 32000))
                 for dt in (torch.bfloat16, torch.float16)]
              + [(1024, 10, torch.float32, 1), (256, 1000, torch.float32, 1),
                 (7, 32000, torch.float32, 1),
                 (7, 32000, torch.bfloat16, 1)])


def gate_cases(kern):
    """GATE_CASES, and 1024 rows at the last V of each route or class of
    the warp route (a route's unit holds another number of columns) and
    the first V of the next, found from the C launcher's own plan."""
    edges = []
    unit = kern.plan(1, 1, torch.float32)[::2]
    for v in range(2, 1 << 16):
        u = kern.plan(1, v, torch.float32)[::2]
        if u != unit:
            edges += [v - 1, v]
            unit = u
    return GATE_CASES + [(1024, v, torch.float32, 0) for v in edges]


def check_exit_gate(ref, kern, gen):
    """Each case against float64 and the plain version; returns the worst
    errors and the launch floor, back to back and behind a torch op."""
    worst = {"conf": 0.0, "entropy": 0.0, "conf_vs_exact": 0.0,
             "entropy_vs_exact": 0.0}
    # an empty kernel timed as the gate is: what any one launch costs
    floor_ms = time_ms(lambda: torch.cuda._sleep(0))
    floor = {"launch_floor_ms": floor_ms,
             "floor_after_op_ms": after_op_ms(lambda: torch.cuda._sleep(0))}
    emit(phase="kernels", kernel="launch_floor", **floor)
    routes = set()
    for b, v, dtype, offset in gate_cases(kern):
        route, _, chunk = kern.plan(b, v, dtype)
        routes.add(route)
        x, th, planted = gate_inputs(b, v, gen, chunk)
        buf = torch.empty(b * v + offset, dtype=dtype, device="cuda")
        lg = buf[offset:].view(b, v)
        lg.copy_(x)               # the plain version upcasts the same
        check((lg.data_ptr() % 16 != 0) == bool(offset),
              f"exit_gate case {(b, v, offset)} not aligned as meant")
        planted_th = torch.arange(b, device="cuda") % 3 == 1
        th = torch.where(planted_th, ref.ref_exit_gate(lg, th)[0], th)
        want = ref.ref_exit_gate(lg, th)
        got = kern.exit_gate_cuda(lg, th)
        torch.cuda.synchronize()
        conf64, ent64 = exact_gate(lg)
        errs = {}
        for name, k, p, x in (("conf", got[0], want[0], conf64),
                              ("entropy", got[1], want[1], ent64)):
            k, p = k.double(), p.double()
            gap, own = (k - p).abs(), (p - x).abs()
            errs[name] = float(gap.max())
            errs[name + "_vs_exact"] = float((k - x).abs().max())
            errs["plain_" + name + "_vs_exact"] = float(own.max())
            # the kernel must be within CONF_TOL of the exact value and
            # of the plain fp32 version, up to that version's own
            # rounding (fp32 sums of 129 280 terms)
            check(errs[name + "_vs_exact"] <= CONF_TOL,
                  f"exit_gate {name} off the exact value at {(b, v)}")
            check(bool((gap <= CONF_TOL + own).all()),
                  f"exit_gate {name} off the plain version at {(b, v)}")
        check(torch.equal(got[2], want[2]),
              f"exit_gate pred differs at {(b, v, dtype, offset)}")
        rows = planted >= 0
        check(torch.equal(got[2][rows].long(), planted[rows]),
              f"exit_gate planted tie or last-column max missed at "
              f"{(b, v, dtype, offset)}")
        edge = (want[0] - th).abs() < EDGE
        check(int(edge.sum()) >= int(planted_th.sum()),
              "planted tau' == conf rows not counted as edge rows")
        check(torch.equal(got[3][~edge], want[3][~edge]),
              f"exit_gate fire differs outside edge rows at {(b, v)}")
        check(not bool(got[3][planted_th & (got[0] == th)].any()),
              "exit_gate fires at conf == tau'")
        ms = time_ms(lambda: kern.exit_gate_cuda(lg, th))
        plain_ms = time_ms(lambda: ref.ref_exit_gate(lg, th))
        # (conf, pred) in one call; entropy and fire are not in it
        lib_ms = time_ms(lambda: torch.softmax(lg.float(), -1).max(-1))
        bms, by = gate_bound(b, v, lg.element_size())
        emit(phase="kernels", kernel="exit_gate", shape=[b, v],
             dtype=str(dtype).removeprefix("torch."), offset=offset,
             route=route, columns=chunk, edge_rows=int(edge.sum()), ms=ms,
             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
             bound_by=by, bound_fraction=bms / ms,
             launch_floor_ms=floor_ms, **errs)
        for key in worst:
            worst[key] = max(worst[key], errs[key])
    check(routes == set(kern.ROUTES),
          f"exit_gate cases took routes {sorted(routes)}, not all of "
          f"{kern.ROUTES}")
    return worst, floor


def check_softmax_confidence(gen):
    """``dispatch.softmax_confidence`` (the gate kernel with tau' = 1) on
    (..., V) card tensors, one of them not contiguous, against the same
    op on the CPU, which takes the plain version."""
    from repro_torch.kernels import dispatch
    worst = 0.0
    for shape, dtype in (((4, 64, 10), torch.float32),
                         ((3, 5, 1000), torch.bfloat16)):
        lg = (torch.randn(*shape, device="cuda", generator=gen) * 4).to(dtype)
        lg = lg.transpose(0, 1)
        conf, pred = dispatch.softmax_confidence(lg)
        want_conf, want_pred = dispatch.softmax_confidence(lg.cpu())
        check(conf.device.type == pred.device.type == "cuda",
              "softmax_confidence left the card")
        check(conf.shape == pred.shape == want_conf.shape == lg.shape[:-1],
              f"softmax_confidence shape {tuple(conf.shape)} at {shape}")
        err = float((conf.cpu() - want_conf).abs().max())
        check(err <= CONF_TOL, f"softmax_confidence conf off at {shape}")
        check(torch.equal(pred.cpu(), want_pred),
              f"softmax_confidence pred differs at {shape}")
        emit(phase="kernels", kernel="exit_gate", op="softmax_confidence",
             shape=list(lg.shape), dtype=str(dtype).removeprefix("torch."),
             err_conf=err)
        worst = max(worst, err)
    return worst


def check_difficulty(ref, kern, gen, cfg):
    kw = dict(tau_edge=cfg.tau_edge, var_scale=cfg.var_scale,
              grad_scale=cfg.grad_scale, w1=cfg.w_edge, w2=cfg.w_variance,
              w3=cfg.w_gradient)
    worst = 0.0
    for b in (1, 256, 1024):
        for h, w, c in ((32, 32, 3), (28, 28, 1), (224, 224, 3)):
            x = torch.rand(b, h, w, c, device="cuda", generator=gen)
            x[: b // 2] = torch.round(x[: b // 2])          # hard edges
            want = ref.ref_components(x, **kw)
            got = kern.difficulty_cuda(x, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().amax(dim=0).tolist()
            pixel = 1.0 / ((h - 2) * (w - 2))
            check(err[0] <= pixel + 1e-7, f"alpha_edge off at {(b, h, w, c)}")
            check(max(err[1:3]) <= ALPHA_TOL,
                  f"alpha_var/alpha_grad off at {(b, h, w, c)}")
            check(err[3] <= cfg.w_edge * pixel + ALPHA_TOL,
                  f"alpha off at {(b, h, w, c)}")
            ms = time_ms(lambda: kern.difficulty_cuda(x, **kw))
            host = host_ms(lambda: kern.difficulty_cuda(x, **kw))
            plain_ms = time_ms(lambda: ref.ref_components(x, **kw))
            bms, by = difficulty_bound(b, h, w, c)
            emit(phase="kernels", kernel="difficulty", shape=[b, h, w, c],
                 err_edge=err[0], err_var=err[1], err_grad=err[2],
                 err_alpha=err[3], ms=ms, plain_ms=plain_ms, bound_ms=bms,
                 bound_by=by, bound_fraction=bms / ms, host_ms=host)
            worst = max(worst, max(err))
    return worst


# ---------------------------------------------------------------------------
# phase 3: the LM kernels
# ---------------------------------------------------------------------------

def head_bounds(b, d, v, itemsize):
    """(bound ms, bound_by, bytes ms, fp32-FMA ms) of the exit head.  The
    bytes: table, h and scale read once, tau' read and three outputs
    written once.  The operations: B*V*D products kept at fp32 accuracy,
    which the tensor cores can give as three split-precision passes
    (bf16 for 2-byte inputs, TF32 for fp32).  The last number is the
    bound of the SIMT design that f32 and f16 tables take, fp32 FMAs
    outside the tensor cores."""
    nbytes = (v * d + b * d + d) * itemsize + b * 4 + b * 12
    peak = BF16_TC_OPS_PER_S if itemsize == 2 else TF32_TC_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * 2 * b * v * d / peak * 1e3
    fma = 2 * b * v * d / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", t_bytes, fma)


def exact_head(h, scale, table, eps=1e-6):
    """conf, first argmax and top-2 logit gap of the kernel's own fp32
    semantics (normalised row never cast back), in float64."""
    x = h.double()
    hn = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.double()
    lg = hn @ table.double().T
    top2 = lg.topk(2, dim=-1).values
    conf = 1.0 / torch.exp(lg - top2[:, :1]).sum(-1)
    return conf, lg.argmax(-1), top2[:, 0] - top2[:, 1]


def plain_head_logits(h, scale, table, eps=1e-6):
    """The plain chain's logits (normalised row cast to the model dtype,
    unembedding in that dtype), for its tie exemption."""
    x = h.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * scale.float()).to(h.dtype) @ table.T


def head_inputs(b, d, v, dtype, gen):
    """An LM-like hidden batch (rms 1), rmsnorm scale near 1 and an
    unembedding of std 0.02, with an exact tie at the top in even rows:
    two equal table rows (one in each half of V) along the row's
    direction."""
    h = torch.randn(b, d, device="cuda", generator=gen)
    scale = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=gen)
    tab = 0.02 * torch.randn(v, d, device="cuda", generator=gen)
    rows = torch.arange(0, b, 2, device="cuda")
    i = (rows * 97) % (v // 2)
    dirn = h[rows] * scale
    dirn = 0.2 * dirn / dirn.norm(dim=1, keepdim=True)
    tab[i] = dirn
    tab[i + v // 2] = dirn
    return h.to(dtype), scale.to(dtype), tab.to(dtype), i


#: (rows, D, V, dtype) of InternLM2-20B's exit head in the lm-internlm
#: phase, and (slots, pages a slot, page size, trailing, dtype) of its
#: K/V views (max_len 512)
INTERNLM_HEAD = (16, 6144, 92544, torch.bfloat16)
INTERNLM_PAGED = (16, 64, 8, (8, 128), torch.bfloat16)
#: the same of granite-moe-3b-a800m in the lm-granite phase: V = 49155
#: is odd, so the last vocabulary tile is partial with an odd count
GRANITE_HEAD = (16, 1536, 49155, torch.bfloat16)
GRANITE_PAGED = (16, 64, 8, (8, 64), torch.bfloat16)

HEAD_CASES = ([(b, 2048, 32000, dt) for dt in (torch.bfloat16, torch.float32)
               for b in (1, 16, 64)]
              + [(100, 2048, 32000, torch.bfloat16),
                 (256, 2048, 32000, torch.bfloat16)]
              # InternLM2-20B's exit heads at the decoder's 16 slots: K
              # of 96 tiles, V not a multiple of the vocabulary tile
              + [INTERNLM_HEAD, GRANITE_HEAD]
              + [(7, 72, 1003, dt) for dt in (torch.bfloat16, torch.float32)]
              + [(5, 70, 1003, torch.bfloat16)])


def check_exit_head(ref, kern, gen):
    """Each case against a float64 evaluation and the plain chain; returns
    (worst conf error, {"main", "internlm", "granite"}: the rows of the
    main-path case and of InternLM2's and granite's heads)."""
    worst, rows = 0.0, {}
    named = {(64, 2048, 32000, torch.bfloat16): "main",
             INTERNLM_HEAD: "internlm", GRANITE_HEAD: "granite"}
    for b, d, v, dtype in HEAD_CASES:
        h, scale, tab, tie_idx = head_inputs(b, d, v, dtype, gen)
        conf0 = kern.exit_head_gate_cuda(
            h, scale, tab, torch.zeros(b, device="cuda"))[0]
        # tau' 25 % either side of conf, and tau' == conf in rows 1 mod 4
        sign = torch.where(torch.rand(b, device="cuda", generator=gen) < 0.5,
                           -1.0, 1.0)
        th = conf0 * (1 + 0.25 * sign)
        planted = torch.arange(b, device="cuda") % 4 == 1
        th = torch.where(planted, conf0, th).contiguous()
        conf, pred, fire = kern.exit_head_gate_cuda(h, scale, tab, th)
        pconf, ppred, pfire = ref.ref_exit_head_gate(h, scale, tab, th)
        torch.cuda.synchronize()
        xconf, xpred, xgap = exact_head(h, scale, tab)
        err = float((conf.double() - xconf).abs().max())
        check(err <= HEAD_CONF_TOL,
              f"exit_head conf off float64 by {err} at {(b, d, v, dtype)}")
        near = xgap < HEAD_GAP
        check(torch.equal(pred[~near].long(), xpred[~near]),
              f"exit_head pred differs from float64 at {(b, d, v, dtype)}")
        check(torch.equal(pred[0::2].long(), tie_idx),
              "exit_head tie not resolved to the lowest index")
        check(torch.equal(ppred[0::2].long(), tie_idx),
              "plain exit head tie not resolved to the lowest index")
        top2 = plain_head_logits(h, scale, tab).float().topk(2, -1).values
        ulp = torch.finfo(dtype).eps * torch.exp2(
            torch.floor(torch.log2(top2[:, 0].abs())))
        plain_tie = (top2[:, 0] - top2[:, 1]) <= ulp
        check(torch.equal(pred[~plain_tie], ppred[~plain_tie]),
              f"exit_head pred differs from the plain chain outside its "
              f"ties at {(b, d, v, dtype)}")
        edge = (conf - th).abs() < HEAD_CONF_TOL
        check(torch.equal(fire[~edge], pfire[~edge]),
              f"exit_head fire differs from the plain chain at "
              f"{(b, d, v, dtype)}")
        check(torch.equal(fire, (conf > th).int()), "exit_head fire != conf > tau'")
        check(not bool(fire[planted].any()), "exit_head fires at conf == tau'")
        ms = time_ms(lambda: kern.exit_head_gate_cuda(h, scale, tab, th))
        host = host_ms(lambda: kern.exit_head_gate_cuda(h, scale, tab, th))
        plain_ms = time_ms(lambda: ref.ref_exit_head_gate(h, scale, tab, th))
        gemm_ms = time_ms(lambda: h @ tab.T)
        bms, by, bytes_ms, fma_ms = head_bounds(b, d, v, h.element_size())
        row = dict(phase="kernels", kernel="exit_head", shape=[b, d, v],
                   dtype=str(dtype).removeprefix("torch."),
                   conf_vs_exact=err,
                   plain_conf_vs_exact=float(
                       (pconf.double() - xconf).abs().max()),
                   conf_rel_vs_plain=float(
                       ((conf - pconf).abs() / pconf).max()),
                   exact_near_ties=int(near.sum()),
                   plain_ties=int(plain_tie.sum()),
                   edge_rows=int(edge.sum()), planted=int(planted.sum()),
                   fired=int(fire.sum()), ms=ms, plain_ms=plain_ms,
                   gemm_floor_ms=gemm_ms, bound_ms=bms, bound_by=by,
                   bound_fraction=bms / ms, host_ms=host,
                   bytes_bound_ms=bytes_ms,
                   fp32_fma_bound_ms=fma_ms)
        emit(**row)
        worst = max(worst, err)
        if (b, d, v, dtype) in named:
            rows[named[(b, d, v, dtype)]] = row
        del h, scale, tab
    return worst, rows


#: (slots, pages per slot, page size, trailing dims, dtype): the serving
#: decoder's K/V views at 16 and 64 slots, InternLM2-20B's, an fp32 one,
#: and an odd page of 60 bytes (the byte-copy path)
PAGED_CASES = [(16, 128, 8, (4, 64), torch.bfloat16),
               (64, 128, 8, (4, 64), torch.bfloat16),
               INTERNLM_PAGED, GRANITE_PAGED,
               (16, 16, 8, (4, 64), torch.float32),
               (5, 7, 3, (5,), torch.float32)]


def paged_bound(s, p, page_bytes):
    nbytes = 2 * s * p * page_bytes + s * p * 4
    return bound(nbytes, 0)


def check_paged_gather(ref, kern, gen):
    """Each case bit-equal to the plain version; returns {"main",
    "internlm", "granite"}: the rows of the main-path case and of
    InternLM2's and granite's views."""
    rows = {}
    named = {INTERNLM_PAGED: "internlm", GRANITE_PAGED: "granite"}
    for s, p, psz, trailing, dtype in PAGED_CASES:
        n = s * p
        # the decoder's store: n pages and a sink page, gathered as [:-1]
        store = torch.randn(n + 1, psz, *trailing, device="cuda",
                            generator=gen).to(dtype)
        pages = store[:-1]
        table = torch.randint(0, n, (s, p), device="cuda", generator=gen,
                              dtype=torch.int32)
        table[0, 0], table[0, 1], table[-1, -1] = n, n + 5, -3
        got = kern.paged_gather_cuda(pages, table)
        want = ref.ref_paged_gather(pages, table)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"paged_gather differs from the plain version at "
              f"{(s, p, psz, trailing)}")
        check(torch.equal(got[0, :psz], pages[n - 1])
              and torch.equal(got[-1, -psz:], pages[0]),
              "paged_gather does not clamp out-of-range page ids")
        ids = table.reshape(-1).clamp(0, n - 1).long()
        ms = time_ms(lambda: kern.paged_gather_cuda(pages, table))
        plain_ms = time_ms(lambda: ref.ref_paged_gather(pages, table))
        lib_ms = time_ms(lambda: pages.index_select(0, ids))
        page_bytes = psz * math.prod(trailing) * pages.element_size()
        bms, by = paged_bound(s, p, page_bytes)
        row = dict(phase="kernels", kernel="paged_gather",
                   shape=[n, psz, *trailing], table=[s, p],
                   dtype=str(dtype).removeprefix("torch."),
                   page_bytes=page_bytes, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bms, bound_by=by)
        emit(**row)
        if (s, p, dtype) == (64, 128, torch.bfloat16):
            rows["main"] = row
        if (s, p, psz, trailing, dtype) in named:
            rows[named[(s, p, psz, trailing, dtype)]] = row
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the engine on the main path
# ---------------------------------------------------------------------------

def edge_rows(masked, tol, shared_tau=False, rtol=0.0):
    """Rows with a gate whose conf lies within ``tol`` (plus ``rtol`` of
    conf) of its tau': there the strict ``conf > tau'`` may flip between
    two computations.  With ``shared_tau`` both sides gate on this very
    tau' (the same alpha, so the same tau' bit for bit): at a tau'
    clipped to 1 a saturated head (conf = 1) fires on neither side, so
    those rows are compared."""
    conf = masked["conf_stack"][:-1].T
    th = masked["eff_thresholds"]
    near = (conf - th).abs() < tol + rtol * conf
    if shared_tau:
        near &= th < 1
    return near.any(dim=1).cpu().numpy()


def saturated_rows(masked, tol):
    """Rows with a gate at conf within ``tol`` of a tau' clipped to 1
    (printed beside the edge rows: these are compared)."""
    conf = masked["conf_stack"][:-1].T
    th = masked["eff_thresholds"]
    return (((conf - th).abs() < tol) & (th >= 1)).any(dim=1).cpu().numpy()


def mode_diff(masked, comp, bad, k=4):
    """The first ``k`` rows where masked and compacted decide otherwise:
    the masked mode's conf and tau' at every gate, both modes' exit,
    pred and conf (what a failed mode check prints)."""
    conf = masked["conf_stack"].T.cpu().numpy()
    th = masked["eff_thresholds"].cpu().numpy()
    return [{"row": int(i), "masked_conf": conf[i].tolist(),
             "tau_eff": th[i].tolist(),
             "masked": [int(masked["exit_idx"][i]), int(masked["pred"][i]),
                        float(masked["conf"][i])],
             "compacted": [int(comp["exit_idx"][i]), int(comp["pred"][i]),
                           float(comp["conf"][i])]}
            for i in np.nonzero(bad)[0][:k]]


def rows_compared(rows, exempted):
    """What every decision check prints: its rows, those it compared and
    those it exempted, and whether the compared reach COMPARED_FLOOR."""
    rows, exempted = int(rows), int(exempted)
    return {"rows": rows, "compared": rows - exempted, "exempted": exempted,
            "floor_met": rows - exempted >= COMPARED_FLOOR * rows}


def low_tau(conf, alpha, beta_diff, coef, tol):
    """The second check's tau per gate: the LOW_TAU_Q quantile of conf -
    beta_diff*alpha over calibration rows (conf (N, E), alpha (N,)),
    capped so that tau' = coef*tau + beta_diff*alpha < 1 - 10 tol for
    every alpha in [0, 1]."""
    q = np.array([np.quantile(conf[:, s] - beta_diff * alpha, LOW_TAU_Q)
                  for s in range(conf.shape[1] - 1)])
    if torch.is_tensor(coef):
        coef = coef.cpu().numpy()
    cap = (1.0 - 10 * tol - beta_diff) / np.asarray(coef, np.float64)
    return np.minimum(q, cap).astype(np.float32)


def floor_or_second(name, first, second):
    """The floor on a check's compared rows: met by the check itself, or
    by ``second()``, the same check on the same path and rows under the
    low policy, where no gate's tau' is clipped to 1 (run only when the
    first falls short); returns the first's counts, with the second's
    under ``low_tau``."""
    if not first["floor_met"]:
        first["low_tau"] = second()
        check(first["low_tau"]["floor_met"],
              f"{name}: compared {first['low_tau']['compared']} of "
              f"{first['low_tau']['rows']} rows in the second check too")
    return first


def drive_engine(cfg, name, data, offset=0, measure_costs=False,
                 xla_cum_macs=None, pool=None, cpu_rows=64):
    """One engine phase; returns (launch counts, the engine).  With
    ``xla_cum_macs`` (LeViT-256's, the vision archs') the installed count
    must agree with it to LEVIT_MACS_RTOL.  ``cfg`` may be an arch id.
    Without ``pool`` the phase draws its images from ``data`` at
    ``offset``: 512 calibration rows, then batches of 1, 64, 256, 1024
    and 1500 (two chunks); with ``pool`` = (calibration images,
    labels, served images) it calibrates on the first two and serves
    prefixes of the third of 1, 64, 256, ... rows up to all of it.
    ``cpu_rows`` of the card's answers are checked against the CPU (0:
    none)."""
    from repro_torch.configs import registry
    from repro_torch.convert import leaves
    from repro_torch.data.datasets import make_batch
    from repro_torch.engine import DartEngine
    from repro_torch.kernels import dispatch
    from repro_torch.models import get_family

    t_start = time.perf_counter()
    arch = cfg
    if isinstance(cfg, str):
        cfg = registry.get(cfg)
    params = get_family(cfg).init(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in leaves(params))
    eng = DartEngine.from_config(arch, params)         # the card by default
    check(eng.device.type == "cuda", "engine not on the card")
    if pool is None:
        batches = [make_batch(data, range(offset + a, offset + a + n),
                              split="eval")[0]
                   for a, n in ((0, 1), (1, 64), (65, 256), (321, 1024),
                                (1345, 1500))]
        cal_data, cal_rows = data, 512
    else:
        cal_x, cal_y, served = pool
        batches = [served[:n] for n in (1, 64, 256, 1024)
                   if n <= len(served)]
        cal_data, cal_rows = (cal_x, cal_y), len(cal_x)

    cum_macs = None
    if measure_costs:
        cum_macs = eng.measure_costs((data.img_res, data.img_res,
                                      data.channels)).tolist()
        check(all(0 < a < b for a, b in zip(cum_macs, cum_macs[1:])),
              f"{name}: cumulative MACs {cum_macs} not increasing")
        if xla_cum_macs is not None:
            check(np.allclose(cum_macs, xla_cum_macs, rtol=LEVIT_MACS_RTOL,
                              atol=0),
                  f"{name}: cumulative MACs {cum_macs} off XLA's "
                  f"{xla_cum_macs.tolist()}")

    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    cal = eng.collect_calibration(cal_data, n=cal_rows, batch=64)
    pol = eng.calibrate(cal)
    cal_s = time.perf_counter() - t0
    expect = {"difficulty": -(-cal_rows // 64), "exit_gate": 0,
              "exit_head": 0, "paged_gather": 0}
    # tau at each exit's median of conf - beta_diff*alpha: about half the
    # rows reaching a gate leave there, so compaction really runs
    bd = float(pol.beta_diff)
    tau = np.array([np.median(cal.conf[:, s] - bd * cal.alpha)
                    for s in range(eng.n_exits - 1)], np.float32)
    eng.state = eng.state.with_policy(tau=tau)

    edge_rtol = BF16_EDGE_RTOL if cfg.compute_dtype == torch.bfloat16 else 0.0

    def modes(x, record=True):
        """Both modes on one batch, held equal outside edge rows; the
        launches they make go into ``expect``."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masked = eng.infer(x, mode="masked")           # records nothing
        m_idx = masked["exit_idx"].cpu().numpy()
        torch.cuda.synchronize()
        t_m = time.perf_counter() - t0
        t0 = time.perf_counter()
        comp = eng.infer(x, mode="compacted", record=record)
        torch.cuda.synchronize()
        t_c = time.perf_counter() - t0
        expect["difficulty"] += 1 + len(eng.compactor.chunks(len(x)))
        for a, z in eng.compactor.chunks(len(x)):
            expect["exit_gate"] += int(comp["exit_idx"][a:z].max()) + 1
        edge = edge_rows(masked, EDGE, rtol=edge_rtol)
        ok = ~edge
        m_pred = masked["pred"].cpu().numpy()
        check(np.array_equal(comp["exit_idx"][ok], m_idx[ok]),
              f"{name}: masked and compacted exits differ, b={len(x)}: "
              f"{mode_diff(masked, comp, ok & (comp['exit_idx'] != m_idx))}")
        check(np.array_equal(comp["pred"][ok], m_pred[ok]),
              f"{name}: masked and compacted preds differ, b={len(x)}: "
              f"{mode_diff(masked, comp, ok & (comp['pred'] != m_pred))}")
        check(np.isfinite(comp["conf"]).all(), f"{name}: non-finite conf")
        return masked, comp, m_idx, edge, t_m, t_c

    def low_policy_modes(x):
        """The same check once more under the low policy (no telemetry
        recorded), then the phase's policy back."""
        keep = eng.state.tau
        coef = eng._coef().cpu().numpy()
        eng.state = eng.state.with_policy(tau=low_tau(
            cal.conf, cal.alpha, bd, coef, EDGE + edge_rtol))
        try:
            masked, _, _, edge, _, _ = modes(x, record=False)
        finally:
            eng.state = eng.state.with_policy(tau=keep)
        top = float(masked["eff_thresholds"].max())
        check(top < 1 - 10 * (EDGE + edge_rtol),
              f"{name}: the low policy's tau' reaches {top}")
        return {**rows_compared(len(x), edge.sum()), "max_tau": top}

    rows, exits, total_edge = [], np.zeros(eng.n_exits, np.int64), 0
    for x in batches:
        t_masked, t_comp, mode_rdiff, batch_edge = [], [], 0.0, 0
        for _ in range(PASSES):
            masked, comp, m_idx, edge, t_m, t_c = modes(x)
            t_masked.append(t_m)
            t_comp.append(t_c)
            same = comp["exit_idx"] == m_idx
            conf_m = masked["conf"].cpu().numpy()
            mode_rdiff = max(mode_rdiff, float(
                (np.abs(comp["conf"] - conf_m) / conf_m)[same].max(
                    initial=0.0)))
            exits += np.bincount(comp["exit_idx"], minlength=eng.n_exits)
            batch_edge += int(edge.sum())
        total_edge += batch_edge
        compared = floor_or_second(
            f"{name} masked vs compacted, b={len(x)}",
            rows_compared(PASSES * len(x), batch_edge),
            lambda x=x: low_policy_modes(x))
        # the first pass meets new shapes; the median of the rest
        rows.append({"batch": len(x), "edge_rows": int(edge.sum()),
                     "compared": compared,
                     # conf of the two modes at the same exit, relative
                     "max_mode_conf_rdiff": mode_rdiff,
                     "exit_counts": np.bincount(
                         comp["exit_idx"], minlength=eng.n_exits).tolist(),
                     "masked_samples_per_s":
                         len(x) / float(np.median(t_masked[1:])),
                     "compacted_samples_per_s":
                         len(x) / float(np.median(t_comp[1:]))})
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    check(counts == expect, f"{name}: launch counts {counts} != {expect}")
    check(counts["exit_gate"] > 0 and counts["difficulty"] > 0,
          f"{name}: a kernel never ran")
    check(int((exits > 0).sum()) >= 2, f"{name}: fewer than 2 exits taken")
    counting = one_row_counting(eng, batches[0])
    profiled = infer_profile(eng, batches[-1]) if pool is not None else None

    eng.update()
    st = eng.stats()
    check(st["served"] == PASSES * sum(len(x) for x in batches),
          f"{name}: served {st['served']}")
    check(np.array_equal(st["exit_counts"], exits),
          f"{name}: stats exit counts {st['exit_counts']} != {exits}")
    cpu_check = None
    if cpu_rows:
        x = batches[1][:cpu_rows]
        if cfg.compute_dtype == torch.bfloat16:
            cpu_check = check_against_cpu_bf16(cfg, params, eng, x)
        else:
            cpu_check = check_against_cpu(cfg, params, eng, x)

            def low_cpu(x=x):
                keep = eng.state.tau
                eng.state = eng.state.with_policy(tau=low_tau(
                    cal.conf, cal.alpha, bd, eng._coef().cpu().numpy(),
                    CPU_EDGE))
                try:
                    return check_against_cpu(cfg, params, eng, x)
                finally:
                    eng.state = eng.state.with_policy(tau=keep)
            floor_or_second(f"{name} card vs CPU", cpu_check, low_cpu)
    emit(phase="engine", model=name, params=n_params,
         dtype=str(cfg.compute_dtype).removeprefix("torch."),
         img_res=data.img_res, calibration_rows=cal_rows,
         exits=eng.n_exits, calibration_s=cal_s, tau=tau.tolist(),
         joint_dp_tau=np.asarray(pol.tau).tolist(), launches=counts,
         edge_rows=total_edge,
         compared=rows_compared(PASSES * sum(len(x) for x in batches),
                                total_edge),
         exit_counts=exits.tolist(),
         served=st["served"], active_strategy=st["active_strategy"],
         mean_macs=st["mean_macs"], cum_macs=cum_macs, batches=rows,
         one_row_counting=counting, cpu_reference=cpu_check,
         profile=profiled,
         phase_s=time.perf_counter() - t_start)
    return counts, eng


def draw_pool(data, start, n, workers=8):
    """Eval rows [start, start + n) of ``data`` as (images, labels),
    drawn in chunks of 64 by ``workers`` spawned processes (at 224
    pixels one image is tens of ms of numpy)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.data.datasets import make_batch
    chunks = [range(a, min(a + 64, start + n))
              for a in range(start, start + n, 64)]
    # a spawned worker runs the main script's file again, unless it has
    # none: hidden for the pool's start, the workers import numpy and
    # the dataset module only (not torch)
    main = sys.modules["__main__"]
    path = main.__dict__.pop("__file__", None)
    try:
        with ProcessPoolExecutor(
                workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            parts = list(ex.map(make_batch, [data] * len(chunks), chunks,
                                ["eval"] * len(chunks)))
    finally:
        if path is not None:
            main.__file__ = path
    return (np.concatenate([x for x, _ in parts]),
            np.concatenate([y for _, y in parts]))


def drive_vision(data):
    """The engine phases of the assigned vision archs on one pool of
    224-pixel images; returns their launch counts, summed."""
    t0 = time.perf_counter()
    x, y = draw_pool(data, VISION_OFFSET, VISION_CAL_ROWS + 1024)
    emit(phase="vision-pool", rows=len(x), img_res=data.img_res,
         seconds=time.perf_counter() - t0)
    cal = (x[:VISION_CAL_ROWS], y[:VISION_CAL_ROWS])
    total = {}
    for arch, largest in VISION_ARCHS:
        counts, _ = drive_engine(
            arch, arch, data, measure_costs=True,
            xla_cum_macs=VISION_XLA_CUM_MACS[arch],
            pool=(*cal, x[VISION_CAL_ROWS:VISION_CAL_ROWS + largest]),
            cpu_rows=VISION_CPU_ROWS.get(arch, 0))
        torch.cuda.empty_cache()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    return total


def infer_profile(eng, x):
    """Where one masked ``infer`` of ``x`` spends its time: its wall ms
    from the host's numpy images and from the same images already on the
    card (the difference is the host-to-device copy), then, under
    torch.profiler, the infer from the card: device ms, busy share and
    the kernels that take the device time (kernels of one stream do not
    overlap, so their summed time is busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    xd = torch.as_tensor(x, device="cuda")

    def wall_ms(images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.infer(images, mode="masked")["exit_idx"].cpu()
        return 1e3 * (time.perf_counter() - t0)

    wall_ms(x), wall_ms(xd)
    host, card = wall_ms(x), wall_ms(xd)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = wall_ms(xd)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"rows": len(x), "wall_ms": host, "wall_ms_from_card": card,
            "input_copy_ms": host - card, "device_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / profiled,
            "kernels": sum(e.count for e in kern),
            "top_kernels_ms": [[e.key[:70], e.self_device_time_total / 1e3,
                                e.count] for e in top]}


def one_row_counting(eng, x):
    """Masked samples/s at one row with a ``count_macs`` scope open and
    closed, alternated in one loop: what the MAC count costs the serving
    path when it is on (off, the layers compute no taps)."""
    from repro_torch.models import layers as L

    def per_s(counting):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if counting:
            with L.count_macs():
                eng.infer(x, mode="masked", record=False)
        else:
            eng.infer(x, mode="masked", record=False)
        torch.cuda.synchronize()
        return len(x) / (time.perf_counter() - t0)

    on, off = [], []
    for _ in range(2 * PASSES):
        off.append(per_s(False))
        on.append(per_s(True))
    return {"off_samples_per_s": float(np.median(off[1:])),
            "on_samples_per_s": float(np.median(on[1:]))}


def check_against_cpu_bf16(cfg, params, eng, x):
    """A bf16 model's answers on the card against the same engine on the
    CPU (plain torch versions of both kernels): the exit logits within
    BF16_LOGIT_TOL of the largest, conf within BF16_CONF_RTOL, and the
    exits and preds equal outside rows that the two sides' own
    difference may flip (counted)."""
    from repro_torch.engine import DartEngine
    cpu = DartEngine.from_config(eng.cfg, params, device="cpu", adapt=False)
    cpu.state = cpu.state.with_policy(
        tau=eng.state.tau.cpu(), coef=eng._coef().cpu(),
        beta_diff=eng.state.beta_diff.cpu())
    masked = cpu.infer(x, mode="masked")
    card = eng.infer(x, mode="masked")
    card = {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in card.items()}
    want = cpu._forward(cpu._input(x))["exit_logits"].float()
    got = eng._forward(eng._input(x))["exit_logits"].float().cpu()
    scale = float(want.abs().max())
    logit_err = float((got - want).abs().max())
    check(logit_err <= BF16_LOGIT_TOL * scale,
          f"card and CPU bf16 logits differ by {logit_err} (max {scale})")
    conf_card = card["conf_stack"]
    conf_cpu = masked["conf_stack"]
    conf_err = (conf_card - conf_cpu).abs()
    check(bool((conf_err <= BF16_CONF_RTOL * conf_cpu).all()),
          f"card and CPU bf16 conf differ by {float(conf_err.max())}")
    idx = masked["exit_idx"]
    rows = torch.arange(len(idx))
    top2 = want[idx, rows].topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    row_err = (got - want).abs()[idx, rows].amax(dim=-1)
    tie = gap <= 2 * row_err
    th = masked["eff_thresholds"]
    edge = ((conf_cpu[:-1].T - th).abs() <= 2 * conf_err[:-1].T).any(dim=1)
    ok = (~tie & ~edge).numpy()
    compared = rows_compared(len(x), (~ok).sum())
    check(compared["floor_met"],
          f"card vs CPU: {int((~ok).sum())} of {len(x)} rows exempt")
    check(np.array_equal(card["exit_idx"].numpy()[ok], idx.numpy()[ok]),
          "card and CPU exits differ (bf16)")
    check(np.array_equal(card["pred"].numpy()[ok],
                         masked["pred"].numpy()[ok]),
          "card and CPU preds differ (bf16)")
    return {**compared, "edge_rows": int(edge.sum()),
            "tie_rows": int(tie.sum()), "max_logit_err": logit_err,
            "max_logit": scale, "max_conf_err": float(conf_err.max())}


def check_against_cpu(cfg, params, eng, x):
    """The card's compacted answers on one batch against the same engine
    on the CPU (plain torch versions of both kernels)."""
    from repro_torch.engine import DartEngine
    cpu = DartEngine.from_config(cfg, params, device="cpu", adapt=False)
    cpu.state = cpu.state.with_policy(
        tau=eng.state.tau.cpu(), coef=eng._coef().cpu(),
        beta_diff=eng.state.beta_diff.cpu())
    masked = cpu.infer(x, mode="masked")
    card = eng.infer(x, mode="compacted", record=False)
    ok = ~edge_rows(masked, CPU_EDGE)
    check(np.array_equal(card["exit_idx"][ok],
                         masked["exit_idx"].numpy()[ok]),
          "card and CPU exits differ")
    check(np.array_equal(card["pred"][ok], masked["pred"].numpy()[ok]),
          "card and CPU preds differ")
    err = float(np.abs(card["conf"][ok] - masked["conf"].numpy()[ok]).max())
    check(err <= CPU_CONF_TOL, f"card and CPU conf differ by {err}")
    return {**rows_compared(len(x), (~ok).sum()),
            "edge_rows": int((~ok).sum()), "max_conf_err": err}


# ---------------------------------------------------------------------------
# the train phase: each testbed trained from the port's seeded init
# ---------------------------------------------------------------------------

def _pairs(a, b, key=None):
    """(key, leaf of a, leaf of b) over two trees of one structure."""
    if isinstance(a, dict):
        return [t for k in a for t in _pairs(a[k], b[k], k)]
    if isinstance(a, list):
        return [t for x, y in zip(a, b) for t in _pairs(x, y)]
    return [(key, a, b)]


def train_step1_against_cpu(cfg, tc, data, init, tr, grad_floor=0.0):
    """Step 1 of the card's trainer ``tr`` against the same step on the
    CPU, from the same weights and batch, in three layers: the loss; the
    gradients; the update that the CPU's optimizer makes from the card's
    gradients, against the card's (an update from gradients that differ
    in their low bits is no yardstick: AdamW maps a gradient at rounding
    level to +-lr).  The batchnorm running statistics card vs CPU.
    ``grad_floor``: the least share of the whole gradient's norm that a
    leaf's error is taken relative to (STEP1_GRAD_FLOOR)."""
    from repro_torch.convert import tree_map
    from repro_torch.data.datasets import make_batch
    from repro_torch.data.pipeline import batch_indices
    from repro_torch.models.batchnorm import STATS_KEYS
    from repro_torch.optim import value_and_grad
    from repro_torch.runtime.trainer import Trainer

    x, y = make_batch(data, batch_indices(data, 0, tc.batch_size))
    host = tree_map(lambda t: t.cpu(), init)
    cpu = Trainer(cfg, tc, data, params=host, device="cpu")
    on_card = (torch.as_tensor(x, device="cuda"),
               torch.as_tensor(y, device="cuda"))
    # one cuDNN algorithm choice for both backward passes on the card, so
    # the step's own gradients are the ones compared here
    torch.backends.cudnn.deterministic = True
    try:
        _, g_card = value_and_grad(tr._loss_fn, tr.params, on_card)
        card_loss = tr.train_step((x, y))
    finally:
        torch.backends.cudnn.deterministic = False
    _, g_cpu = value_and_grad(cpu._loss_fn, cpu.params, (torch.as_tensor(x),
                                                         torch.as_tensor(y)))
    cpu_loss = cpu.train_step((x, y))
    check(math.isclose(card_loss, cpu_loss, rel_tol=STEP1_LOSS_RTOL),
          f"train {cfg.name}: step 1 loss {card_loss} on the card, "
          f"{cpu_loss} on the CPU")
    grad_err = {"heads": 0.0, "all": 0.0}
    whole = math.sqrt(sum(float(gh.double().square().sum())
                          for key, _, gh in _pairs(g_card, g_cpu)
                          if key not in STATS_KEYS))
    for key, gc, gh in _pairs(g_card, g_cpu):
        norm = float(gh.norm())
        if key in STATS_KEYS or norm == 0.0:
            continue
        err = float((gc.cpu() - gh).norm()) / max(norm, grad_floor * whole)
        grad_err["all"] = max(grad_err["all"], err)
    # the linear heads: downstream of every ReLU and max pool
    linear = [(g_card["head"], g_cpu["head"])] + [
        (g_card["exit_heads"][k].get("fc", g_card["exit_heads"][k]),
         g_cpu["exit_heads"][k].get("fc", g_cpu["exit_heads"][k]))
        for k in g_cpu["exit_heads"]]
    heads = [(gc, gh) for a, b in linear for _, gc, gh in _pairs(a, b)]
    grad_err["heads"] = max(float((gc.cpu() - gh).norm() / gh.norm())
                            for gc, gh in heads)
    check(grad_err["heads"] <= STEP1_HEAD_GRAD_RTOL
          and grad_err["all"] <= STEP1_GRAD_RTOL,
          f"train {cfg.name}: step 1 gradients off the CPU's {grad_err}")
    # the CPU optimizer from the card's gradients, against the card
    want, _ = cpu.opt.update(tree_map(lambda t: t.cpu(), g_card),
                             cpu.opt.init(host), host)
    upd_err = max(float((got.cpu() - w).abs().max())
                  for key, got, w in _pairs(tr.params, want)
                  if key not in STATS_KEYS)
    check(upd_err <= STEP1_UPDATE_TOL,
          f"train {cfg.name}: the card's update is {upd_err} off the CPU "
          f"optimizer's from the same gradients")
    stats_err = max([float((a.cpu() - b).abs().max())
                     for key, a, b in _pairs(tr.params, cpu.params)
                     if key in STATS_KEYS], default=0.0)
    check(stats_err <= STEP1_STATS_TOL,
          f"train {cfg.name}: batchnorm statistics {stats_err} off the "
          f"CPU's after step 1")
    # for the record: weights that the two steps moved apart
    off = [int(((a.cpu() - b).abs() > STEP1_UPDATE_TOL).sum())
           for key, a, b in _pairs(tr.params, cpu.params)
           if key not in STATS_KEYS]
    return {"loss_card": card_loss, "loss_cpu": cpu_loss,
            "grad_rel_err": grad_err, "update_err": upd_err,
            "max_stats_err": stats_err, "weights_apart": sum(off),
            "weights": sum(t.numel() for key, t, _ in
                           _pairs(tr.params, tr.params)
                           if key not in STATS_KEYS)}


def step_ms_without_data_thread(cfg, tc, data, init, steps=10):
    """Median ms of a train step on a batch already on the card, with no
    data thread running: what a step costs the trainer alone (a fresh
    trainer from the same init; its weights are thrown away)."""
    from repro_torch.data.datasets import make_batch
    from repro_torch.data.pipeline import batch_indices
    from repro_torch.runtime.trainer import Trainer

    x, y = make_batch(data, batch_indices(data, 0, tc.batch_size))
    t0 = time.perf_counter()
    for s in range(1, 6):
        make_batch(data, batch_indices(data, s, tc.batch_size))
    draw_ms = (time.perf_counter() - t0) / 5 * 1e3
    batch = (torch.as_tensor(x, device="cuda"),
             torch.as_tensor(y, device="cuda"))
    tr = Trainer(cfg, tc, data, params=init)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(batch)
        times.append(time.perf_counter() - t0)
    return float(np.median(times[1:])) * 1e3, draw_ms


def eval_accuracy(fam, params, cfg, data, rows):
    """Per-exit accuracy on the first ``rows`` eval rows (inference
    mode, no autograd graph)."""
    from repro_torch.data.pipeline import eval_batches
    hits, n = 0, 0
    with torch.no_grad():
        for x, y in eval_batches(data, 128, n=rows):
            logits = fam.forward(params, torch.as_tensor(x, device="cuda"),
                                 cfg)["exit_logits"]
            hits = hits + (logits.argmax(-1).cpu().numpy() == y[None]).sum(1)
            n += len(y)
    return (hits / n).tolist()


def drive_train(cfg, name, data, phase="train", grad_floor=0.0):
    """Train ``cfg`` from the port's seeded init on the card with Table
    I's (or Table II's) protocol; returns the trained params."""
    from repro_torch.convert import leaves
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import get_family
    from repro_torch.models.batchnorm import STATS_KEYS
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    steps = TRAIN_STEPS[name]
    tc = TrainConfig(batch_size=TRAIN_BATCH, steps=steps, lr=TRAIN_LR,
                     log_every=1)
    fam = get_family(cfg)
    init = fam.init(cfg, seed=0, device="cuda")
    t_start = time.perf_counter()
    tr = Trainer(cfg, tc, data, params=init)          # the card by default
    check(tr.device.type == "cuda", f"train {name}: trainer not on the card")
    step1 = train_step1_against_cpu(cfg, tc, data, init, tr, grad_floor)
    alone_ms, draw_ms = step_ms_without_data_thread(cfg, tc, data, init)
    pipe = DataPipeline(data, TRAIN_BATCH, start_step=1)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = tr.run(pipeline=pipe)
        run_s = time.perf_counter() - t0
    finally:
        pipe.close()
    check(tr.step == steps and len(hist) == steps - 1,
          f"train {name}: {tr.step} steps, {len(hist)} logged")
    losses = [step1["loss_card"]] + [h["loss"] for h in hist]
    check(all(math.isfinite(v) for v in losses), f"train {name}: loss nan")
    step_ms = np.diff([0.0] + [h["elapsed_s"] for h in hist]) * 1e3
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    learned = last < first
    check(learned or name in MAY_NOT_LEARN,
          f"train {name}: loss did not fall ({first} -> {last})")
    check(not any(t.requires_grad for t in leaves(tr.params)),
          f"train {name}: trained leaves require grad")
    stats = None
    if name.startswith(("resnet", "levit")):
        pairs = [(a, b) for key, a, b in _pairs(tr.params, init)
                 if key in STATS_KEYS]
        stats = {"leaves": len(pairs),
                 "moved": sum(not torch.equal(a, b) for a, b in pairs),
                 "finite": all(bool(torch.isfinite(a).all())
                               for a, _ in pairs)}
        check(stats["moved"] == stats["leaves"] and stats["finite"],
              f"train {name}: running statistics {stats}")
    emit(phase=phase, model=name, steps=steps, batch=TRAIN_BATCH,
         lr=TRAIN_LR, optimizer=tc.optimizer, warmup=tc.warmup,
         n_train=data.n_train, seed=0, step1_vs_cpu=step1,
         ms_per_step_median=float(np.median(step_ms)),
         ms_per_step_p90=float(np.percentile(step_ms, 90)),
         data_wait_share=pipe.wait_s / run_s, run_s=run_s,
         ms_per_step_without_data_thread=alone_ms,
         ms_to_draw_a_batch=draw_ms,
         phase_s=time.perf_counter() - t_start,
         loss_first=losses[0], loss_last=losses[-1],
         loss_mean_first10=first, loss_mean_last10=last, learned=learned,
         eval_rows=TRAIN_EVAL_ROWS,
         exit_accuracy=eval_accuracy(fam, tr.params, cfg, data,
                                     TRAIN_EVAL_ROWS),
         running_stats=stats)
    return tr.params


def stage_ms(eng, img_shape, batch=64):
    """Per-sample device ms of the stem with stage 0 and exit 0, then of
    each later stage with its exit head (CUDA events, median of
    blocks), and of the difficulty kernel, at ``batch`` rows."""
    from repro_torch.kernels import dispatch
    fam, cfg, p = eng.family, eng.cfg, eng.params
    x = torch.rand((batch,) + tuple(img_shape), device="cuda")
    hs = [fam.apply_stem(p, x, cfg)]
    for s in range(eng.n_exits):
        hs.append(fam.apply_stage(p, hs[-1], s, cfg))

    def step(s):
        h = fam.apply_stage(p, hs[s], s, cfg)
        fam.apply_exit(p, h, s, cfg)

    ms = [time_ms(lambda s=s: step(s), reps=11, block=5) / batch
          for s in range(eng.n_exits)]
    ms[0] += time_ms(lambda: fam.apply_stem(p, x, cfg), reps=11,
                     block=5) / batch
    diff = time_ms(lambda: dispatch.image_difficulty(x), reps=11,
                   block=5) / batch
    return np.asarray(ms), diff


def drive_policies(eng, data, weights, xla_cum_macs, *, phase="policies",
                   methods=("static", "branchynet", "rl_agent", "joint_dp"),
                   macs_rtol=MACS_RTOL, table="Table I",
                   holdout_offset=1024, **extra):
    """The ``methods`` (static first) fitted on one calibration set and
    routed on a holdout of the same engine (its ``weights`` described in
    the line), the MACs held to XLA's count ``xla_cum_macs``; ``extra``
    goes into the line as it is."""
    from repro_torch.core import daes as DAES
    from repro_torch.core import difficulty as DIFF
    from repro_torch.engine import get_optimizer, route_policy

    img = (data.img_res, data.img_res, data.channels)
    cal = eng.collect_calibration(data, n=512, batch=64)
    hold = eng.collect_calibration(data, n=512, batch=64,
                                   offset=holdout_offset)
    ms, diff_ms = stage_ms(eng, img)
    cum_ms = np.cumsum(ms)
    cum_macs = np.asarray(eng.cum_costs)
    check(np.allclose(cum_macs, xla_cum_macs, rtol=macs_rtol, atol=0),
          f"{phase}: cumulative MACs {cum_macs} off XLA's {xla_cum_macs}")
    norm = cum_macs / cum_macs[-1]
    est_macs = DIFF.estimator_flops(*img) / 2.0
    n, e = hold.conf.shape
    rows, meas = [], []
    for method in methods:
        t0 = time.perf_counter()
        pol = (eng.calibrate(cal) if method == "joint_dp"
               else get_optimizer(method)(cal, beta_opt=0.5))
        fit_s = time.perf_counter() - t0
        idx = route_policy(pol, hold)
        hist = np.bincount(idx, minlength=e)
        dart = method == "joint_dp"
        acc = float(hold.correct[np.arange(n), idx].mean())
        m = DAES.MethodMeasurement(
            method, acc,
            time_s=float(cum_ms[idx].mean() + (diff_ms if dart else 0.0))
            / 1e3,
            macs=float(cum_macs[idx].mean() + (est_macs if dart else 0.0)))
        # the routed MACs against XLA's count of the same routes
        xla = float(xla_cum_macs[idx].mean())
        check(math.isclose(m.macs - (est_macs if dart else 0.0), xla,
                           rel_tol=macs_rtol),
              f"{phase}: {method} routed MACs {m.macs} off XLA's {xla}")
        if method == "static":
            check(bool((idx == e - 1).all()),
                  f"{phase}: static routed a row before the last exit")
        if dart:
            # joint_dp may keep every row to the last exit (it did on
            # random weights); its policy with tau at each exit's
            # calibration median splits the rows, so the card's routing
            # is really tested
            mid = dataclasses.replace(pol, tau=np.array(
                [np.median(cal.conf[:, s] - pol.beta_diff * cal.alpha)
                 for s in range(e - 1)]))
            mid_idx = route_policy(mid, hold)
            check(len(np.unique(mid_idx)) >= 2,
                  f"{phase}: the median-tau policy took fewer than 2 exits")
            low = dataclasses.replace(pol, tau=low_tau(
                cal.conf, cal.alpha, pol.beta_diff, pol.coef, EDGE))

            def low_route():
                return check_card_route(eng, low, route_policy(low, hold),
                                        data, holdout_offset)
            card_route = {
                key: floor_or_second(
                    f"{phase} {key} on the card",
                    check_card_route(eng, p, ix, data, holdout_offset),
                    low_route)
                for key, p, ix in (("joint_dp", pol, idx),
                                   ("joint_dp_median_tau", mid, mid_idx))}
        meas.append(m)
        rows.append({"method": method, "tau": np.asarray(pol.tau).tolist(),
                     "beta_diff": float(pol.beta_diff),
                     "objective": float(pol.objective), "fit_s": fit_s,
                     "exit_counts": hist.tolist(),
                     "mean_norm_macs": float(norm[idx].mean()),
                     "accuracy": acc})
    mean_alpha = float(hold.alpha.mean())
    for r, m in zip(rows, meas):
        r["daes_row"] = DAES.summary_row(meas[0], m, mean_alpha)
    emit(phase=phase, model=eng.cfg.name, weights=weights,
         note="one short training run on synthetic data: these rows are "
              f"no {table} result", **extra,
         calibration_rows=len(cal.conf), holdout_rows=n,
         holdout_offset=holdout_offset, cum_macs=cum_macs.tolist(),
         stage_ms_per_sample=ms.tolist(),
         difficulty_ms_per_sample=diff_ms, estimator_macs=est_macs,
         mean_alpha=mean_alpha, joint_dp_card_route=card_route,
         methods=rows)
    return rows


def check_card_route(eng, pol, idx, data, offset, batch=64):
    """The holdout served by an engine on the card under ``pol`` (no
    adaptation) leaves at ``route_policy``'s exits ``idx`` in both modes,
    outside rows at a gate's edge."""
    from repro_torch.data.datasets import make_batch
    from repro_torch.engine import DartEngine
    card = DartEngine.from_config(eng.cfg, eng.params, adapt=False)
    card.state = card.state.with_policy(tau=pol.tau, coef=pol.coef,
                                        beta_diff=pol.beta_diff)
    masked, comp, edge = [], [], []
    for start in range(offset, offset + len(idx), batch):
        x, _ = make_batch(data, range(start, start + batch), split="eval")
        out = card.infer(x, mode="masked", record=False)
        masked.append(out["exit_idx"].cpu().numpy())
        edge.append(edge_rows(out, EDGE))
        comp.append(card.infer(x, mode="compacted", record=False)["exit_idx"])
    masked, comp, edge = map(np.concatenate, (masked, comp, edge))
    ok = ~edge
    check(np.array_equal(masked[ok], idx[ok]),
          f"{eng.cfg.name}: joint_dp on the card (masked) left off "
          "route_policy")
    check(np.array_equal(comp[ok], idx[ok]),
          f"{eng.cfg.name}: joint_dp on the card (compacted) left off "
          "route_policy")
    return {**rows_compared(len(idx), edge.sum()),
            "edge_rows": int(edge.sum()),
            "exit_counts": np.bincount(comp, minlength=eng.n_exits).tolist()}


def drive_table2(data):
    """Table II's protocol on the three LeViTs: each trained from the
    port's seeded init, then static and joint_dp fitted and routed on
    the trained weights.  Returns the launch counts of the serving
    half (training launches no fused kernel)."""
    from repro_torch.configs.paper_testbeds import (LEVIT_128S, LEVIT_192,
                                                    LEVIT_256)
    from repro_torch.engine import DartEngine
    from repro_torch.kernels import dispatch
    from repro_torch.models.cnn_zoo import levit_macs

    t0 = time.perf_counter()
    beds = ((LEVIT_128S, "levit-128s"), (LEVIT_192, "levit-192"),
            (LEVIT_256, "levit-256"))
    dispatch.reset_launch_counts()
    trained = {name: drive_train(cfg, name, data, phase="table2-train",
                                 grad_floor=STEP1_GRAD_FLOOR)
               for cfg, name in beds}
    train_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    check(not any(launches.values()),
          f"table2: fused kernels launched while training {launches}")
    for cfg, name in beds:
        eng = DartEngine.from_config(cfg, trained[name])
        eng.measure_costs((data.img_res, data.img_res, data.channels))
        drive_policies(eng, data,
                       weights=f"trained in this phase "
                               f"({TRAIN_STEPS[name]} steps)",
                       xla_cum_macs=LEVIT_XLA_CUM_MACS[name],
                       phase="table2", methods=("static", "joint_dp"),
                       macs_rtol=LEVIT_MACS_RTOL, table="Table II",
                       levit_macs=levit_macs(cfg))
    launches = dispatch.launch_counts()
    check(launches["difficulty"] > 0 and launches["exit_gate"] > 0,
          f"table2: the trained engines' kernels never ran {launches}")
    emit(phase="table2_summary", launches=launches, train_s=train_s,
         phase_s=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# the serving phase: AsyncDartServer over the trained ResNet-18
# ---------------------------------------------------------------------------

def arrival_times(rate, secs, rng):
    """Open-loop Poisson arrival offsets (s) over ``secs``."""
    gaps = rng.exponential(1.0 / rate, int(rate * secs * 1.2) + 16)
    t = np.cumsum(gaps)
    return t[t < secs]


def serve_stream(eng, pool, stream, **cfg):
    """One open-loop run: submit each request (one pool image, deadline
    SERVE_DEADLINE_MS) at its arrival time, whatever the server's state,
    and wait for every future.  Latency counts from the scheduled
    arrival, so the submitting loop's own lag is charged to the server.
    Arrivals the loop has not reached SERVE_GRACE_S after the stream's
    end are not sent (``unsent``).  Returns (the run's line, results by
    submitted request: dict or the exception name)."""
    from concurrent.futures import wait

    from repro_torch.serving import AsyncDartServer, SchedulerConfig
    arrivals, idx, prios = stream
    srv = AsyncDartServer(eng, SchedulerConfig(**cfg))
    futs, submit_ms, lags = [], [], []
    t0 = time.perf_counter()
    for t_arr, i, prio in zip(arrivals, idx, prios):
        now = time.perf_counter() - t0
        if now > SERVE_SECS + SERVE_GRACE_S:
            break
        if now < t_arr:
            time.sleep(t_arr - now)
            now = time.perf_counter() - t0
        s0 = time.perf_counter()
        futs.append(srv.submit(pool[i], deadline_ms=SERVE_DEADLINE_MS,
                               priority=int(prio)))
        submit_ms.append((time.perf_counter() - s0) * 1e3)
        lags.append(max(0.0, now - t_arr))
    t_submitted = time.perf_counter() - t0
    done, pending = wait(futs, timeout=60)
    t_done = time.perf_counter() - t0
    check(not pending, f"serving: {len(pending)} futures never resolved")
    srv.close()
    results, lat = [], []
    for f, lag in zip(futs, lags):
        if f.exception() is not None:
            results.append(type(f.exception()).__name__)
            continue
        res = f.result()
        results.append(res)
        lat.append(res["latency_ms"] + lag * 1e3)
    c = srv.counters
    n = len(futs)
    check(c.get("dispatch_errors", 0) == 0
          and c.get("complete_errors", 0) == 0,
          f"serving: a bucket failed: {srv.last_error!r}")
    check(c["completed"] + srv.queue.shed + srv.queue.rejected == n,
          f"serving: completed {c['completed']} + shed {srv.queue.shed} + "
          f"rejected {srv.queue.rejected} != submitted {n}")
    flushes = {k[6:]: v for k, v in c.items() if k.startswith("flush_")}
    lat = np.asarray(lat)
    line = {"offered_per_s": len(arrivals) / SERVE_SECS,
            "submitted": n, "unsent": len(arrivals) - n,
            "submitted_per_s": n / t_submitted,
            "completed": c["completed"], "shed": srv.queue.shed,
            "rejected": srv.queue.rejected,
            "samples_per_s": c["completed"] / t_done,
            "latency_ms": dict(zip(("p50", "p95", "p99"), np.percentile(
                lat, [50, 95, 99]).tolist())) if len(lat) else None,
            "miss_rate": float(np.mean(lat > SERVE_DEADLINE_MS))
            if len(lat) else None,
            "flushes": flushes,
            "mean_bucket": c["completed"] / max(sum(flushes.values()), 1),
            "submit_ms": {"p50": float(np.median(submit_ms)),
                          "p99": float(np.percentile(submit_ms, 99))},
            "lag_ms_p99": float(np.percentile(lags, 99)) * 1e3,
            "service_ms_ema": srv._service_s * 1e3,
            "seconds": t_done}
    return line, results


def uncontended(eng, pool, n=2048):
    """The scheduler with one launching thread at a time: ``n`` best-effort
    requests submitted to a stopped server (admission alone), then
    served by its dispatcher with no submitter running."""
    from concurrent.futures import wait

    from repro_torch.serving import AsyncDartServer, SchedulerConfig
    srv = AsyncDartServer(eng, SchedulerConfig(max_queue=n), start=False)
    t0 = time.perf_counter()
    futs = [srv.submit(pool[i % len(pool)]) for i in range(n)]
    t_fill = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv.start()
    _, pending = wait(futs, timeout=60)
    t_drain = time.perf_counter() - t0
    srv.close()
    check(not pending and srv.counters["completed"] == n,
          "serving: the uncontended drain left requests")
    buckets = sum(v for k, v in srv.counters.items()
                  if k.startswith("flush_"))
    return {"requests": n, "submit_per_s": n / t_fill,
            "samples_per_s": n / t_drain, "buckets": buckets,
            "ms_per_bucket": t_drain / buckets * 1e3}


def traced_run(eng, pool, stream):
    """The 200/s stream once more with ``repro_torch.obs`` on: where a
    request's latency goes, from its spans (admission, submit to
    dispatch, dispatch to completion), and what the tracing costs."""
    from repro_torch import obs
    obs.configure(enabled=True)
    try:
        line, _ = serve_stream(eng, pool, stream)
        tr = obs.get_tracer()
        fams = obs.parse_prometheus(obs.get_registry().render())
    finally:
        obs.reset()

    def pct(name):
        d = np.asarray([sp["dur"] for sp in tr.spans(name)]) * 1e3
        check(len(d) > 0, f"serving: no {name} spans")
        return dict(zip(("p50", "p95", "p99"),
                        np.percentile(d, [50, 95, 99]).tolist()))
    check(len(tr.spans("exit")) == line["completed"],
          "serving: exit spans != completed requests")
    check("dart_request_latency_ms" in fams, "serving: no latency family")
    return {"latency_ms": line["latency_ms"], "miss_rate": line["miss_rate"],
            "submit_ms": line["submit_ms"], "admit_ms": pct("admit"),
            "queue_wait_ms": pct("queue_wait"),
            "dispatch_to_done_ms": pct("compiled_step")}


def held_to_oracle(results, idx, oracle):
    """Completed results whose exit or pred differ from the image served
    alone, outside the oracle's edge rows; the edge rows met (the only
    results not compared), and the saturated rows met (compared)."""
    exit_o, pred_o, edge_o, sat_o = oracle
    bad = edge = sat = 0
    for res, i in zip(results, idx):
        if isinstance(res, str):
            continue
        if edge_o[i]:
            edge += 1
            continue
        sat += int(sat_o[i])
        if res["exit_idx"][0] != exit_o[i] or res["pred"][0] != pred_o[i]:
            bad += 1
    return bad, edge, sat


def timed_under(fn, background, calls=200):
    """Median and p99 host ms of ``fn`` (synchronised) while
    ``background`` runs in a thread (``None``: alone)."""
    import threading
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            background()

    t = None
    if background is not None:
        t = threading.Thread(target=loop)
        t.start()
        time.sleep(0.05)
    ms = []
    try:
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        stop.set()
        if t is not None:
            t.join(timeout=30)
    torch.cuda.synchronize()
    return {"p50": float(np.median(ms)), "p99": float(np.percentile(ms, 99))}


def drive_serving(cfg, params, policy_state, cum_costs, data):
    """The serving phase: single images with deadlines and priorities
    through ``AsyncDartServer`` on the card (see the module docstring)."""
    from repro_torch.data.datasets import make_batch
    from repro_torch.engine import DartEngine
    from repro_torch.kernels import dispatch
    from repro_torch.serving import AdmissionPlanner

    t_start = time.perf_counter()
    eng = DartEngine.from_config(cfg, params, adapt=False,
                                 cum_costs=cum_costs)
    eng.state = eng.state.with_policy(tau=policy_state.tau,
                                      coef=policy_state.coef,
                                      beta_diff=policy_state.beta_diff)
    pool = make_batch(data, range(SERVE_POOL_OFFSET,
                                  SERVE_POOL_OFFSET + SERVE_POOL), "eval")[0]
    rng = np.random.default_rng(0)
    streams = {}
    for rate in SERVE_RATES:
        arr = arrival_times(rate, SERVE_SECS, rng)
        streams[rate] = (arr, rng.integers(0, SERVE_POOL, len(arr)),
                         rng.integers(0, 2, len(arr)))
    # the oracle: each pool image served alone; warms every bucket shape
    exit_o, pred_o, edge_o, sat_o = [], [], [], []
    for i in range(SERVE_POOL):
        out = eng.infer(pool[i:i + 1], mode="masked")
        exit_o.append(int(out["exit_idx"][0]))
        pred_o.append(int(out["pred"][0]))
        edge_o.append(bool(edge_rows(out, EDGE, shared_tau=True)[0]))
        sat_o.append(bool(saturated_rows(out, EDGE)[0]))
    oracle = tuple(map(np.asarray, (exit_o, pred_o, edge_o, sat_o)))
    for b in eng.compactor.buckets:
        if b <= 64:
            eng.infer(pool[:b], mode="masked")
            eng.infer(pool[:b], mode="compacted", record=False)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t_start

    runs = [(f"masked-{rate}", rate, {}) for rate in SERVE_RATES] + [
        ("compacted-2000", 2000, {"mode": "compacted"}),
        ("compacted-conservative-2000", 2000,
         {"mode": "compacted", "predict": "conservative"})]
    dispatch.reset_launch_counts()
    lines, outs = {}, {}
    for name, rate, kw in runs:
        line, res = serve_stream(eng, pool, streams[rate], **kw)
        bad, edge, sat = held_to_oracle(res, streams[rate][1], oracle)
        check(bad == 0, f"serving {name}: {bad} results differ from the "
                        f"image served alone")
        compared = rows_compared(
            sum(not isinstance(r, str) for r in res), edge)
        check(compared["floor_met"],
              f"serving {name}: compared {compared['compared']} of "
              f"{compared['rows']} results")
        line.update(run=name, edge_rows=edge, saturated_rows=sat,
                    compared=compared)
        lines[name], outs[name] = line, res
        emit(phase="serving", model=cfg.name, **line)
    launches = dispatch.launch_counts()
    n_submits = sum(line["submitted"] for line in lines.values())
    check(launches["difficulty"] == n_submits,
          f"serving: {launches['difficulty']} difficulty launches for "
          f"{n_submits} admissions")
    check(launches["exit_gate"] > 0, "serving: the gate never launched")
    # the conservative run answers as the run with prediction off
    off, cons = outs["compacted-2000"], outs["compacted-conservative-2000"]
    diff = sum(1 for a, b, i in zip(off, cons, streams[2000][1])
               if not isinstance(a, str) and not isinstance(b, str)
               and not oracle[2][i]
               and (a["exit_idx"][0] != b["exit_idx"][0]
                    or a["pred"][0] != b["pred"][0]))
    check(diff == 0, f"serving: conservative differs from off on {diff}")

    # the baseline: one engine.infer per request, FIFO, on a prefix of
    # the 2000/s stream
    arr, idx, _ = (a[:SERVE_BASELINE] for a in streams[2000])
    lat = []
    t0 = time.perf_counter()
    for t_arr, i in zip(arr, idx):
        now = time.perf_counter() - t0
        if now < t_arr:
            time.sleep(t_arr - now)
        out = eng.infer(pool[i:i + 1], mode="masked", record=True)
        out["exit_idx"].cpu()
        lat.append((time.perf_counter() - t0 - t_arr) * 1e3)
    base_s = time.perf_counter() - t0
    baseline = {"requests": len(arr), "offered_per_s": 2000,
                "samples_per_s": len(arr) / base_s,
                "latency_ms": dict(zip(("p50", "p95", "p99"), np.percentile(
                    lat, [50, 95, 99]).tolist())),
                "miss_rate": float(np.mean(np.asarray(lat)
                                           > SERVE_DEADLINE_MS))}

    # where a submit waits: admission (the default stream) and the same
    # admission on a stream of its own, alone and with a 64-row bucket in
    # flight on another thread; a one-row infer alone and with a thread
    # submitting back to back
    planner = AdmissionPlanner(eng)
    bucket = pool[:64]
    alpha64 = planner.admit(bucket)[0]
    side = torch.cuda.Stream()

    def dispatcher():
        eng.infer(bucket, mode="masked", alpha=alpha64)

    def own_stream():
        with torch.cuda.stream(side):
            planner.admit(pool[:1])

    contention = {
        "admit_default_stream_ms": {
            "idle": timed_under(lambda: planner.admit(pool[:1]), None),
            "bucket_in_flight": timed_under(
                lambda: planner.admit(pool[:1]), dispatcher)},
        "admit_own_stream_ms": {
            "idle": timed_under(own_stream, None),
            "bucket_in_flight": timed_under(own_stream, dispatcher)},
        "one_row_infer_ms": {
            "alone": timed_under(
                lambda: eng.infer(pool[:1], mode="masked"), None, 100),
            "submitter_running": timed_under(
                lambda: eng.infer(pool[:1], mode="masked"),
                lambda: planner.admit(pool[:1]), 100)}}
    contention["uncontended"] = uncontended(eng, pool)
    traced = traced_run(eng, pool, streams[200])
    phase_s = time.perf_counter() - t_start
    emit(phase="serving", model=cfg.name, summary=True, launches=launches,
         baseline_fifo=baseline, contention=contention,
         traced_200=traced,
         oracle_edge_rows=int(oracle[2].sum()),
         oracle_saturated_rows=int(oracle[3].sum()), pool=SERVE_POOL,
         deadline_ms=SERVE_DEADLINE_MS, setup_s=t_setup, phase_s=phase_s)
    check(phase_s <= SERVE_PHASE_S,
          f"serving: the phase took {phase_s:.1f} s > {SERVE_PHASE_S}")
    return launches


def res_plan():
    """The resilience phase's fault plan: a straggler (delay) that the
    pool hedges, a NaN output it quarantines, a raise out of the
    dispatch cut point it retries, a queue stall at completion, and an
    engine death late enough that the NaN's engine serves again first."""
    from repro_torch.runtime.chaos import FaultPlan, FaultSpec
    return FaultPlan([
        FaultSpec("straggler", "step", 2, engine="e0",
                  delay_s=RES_STRAGGLER_S),
        FaultSpec("engine_death", "dispatch", 3, engine="e0"),
        FaultSpec("nan_output", "step", 5, engine="e1"),
        FaultSpec("queue_stall", "complete", 10, delay_s=RES_STALL_S),
        FaultSpec("engine_death", "step", 8, engine="e0")])


def log_engine_calls(engines):
    """Wrap each engine's ``infer`` to note the calls that reached an
    engine and the stages each gated (0 for a masked call): a list of
    (engine, stages)."""
    import threading
    lock, calls = threading.Lock(), []
    for name, eng in engines.items():
        orig = eng.infer

        def infer(x, *a, _orig=orig, _name=name, **kw):
            out = _orig(x, *a, **kw)
            stages = int(np.max(out["exit_idx"])) + 1 \
                if kw.get("mode") == "compacted" else 0
            with lock:
                calls.append((_name, stages))
            return out
        eng.infer = infer
    return calls


def pooled_run(engines, pool_imgs, idx, plan):
    """One PooledDartServer run over ``engines`` (name -> DartEngine):
    ``idx`` single images submitted back to back to the started server,
    then every future waited for.  Returns (line, futures, the bucket of
    each request id, the server, the engine calls)."""
    import threading
    from concurrent.futures import wait

    from repro_torch.kernels import dispatch
    from repro_torch.runtime.chaos import FaultInjector, NullInjector
    from repro_torch.serving import (EnginePool, PooledDartServer,
                                     ResilienceConfig, SchedulerConfig)
    inj = FaultInjector(plan) if plan is not None else NullInjector()
    pool = EnginePool(engines, ResilienceConfig(), injector=inj)
    # each pool worker thread's first card call creates its cuBLAS and
    # cuDNN handles (slow): make it before the run, one engine call per
    # thread, outside the fault plan and the launch counts
    barrier = threading.Barrier(len(engines))

    def warm(eng):
        barrier.wait(timeout=60)
        eng.infer(pool_imgs[:1], mode="compacted", record=False)
    for f in [pool._exec.submit(warm, e) for e in engines.values()]:
        f.result(timeout=120)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    calls = log_engine_calls(engines)
    # every request admitted: the lane may hold the whole burst
    srv = PooledDartServer(pool, SchedulerConfig(
        mode="compacted", max_batch=RES_MAX_BATCH, edges=(),
        max_queue=len(idx)))
    buckets = {}
    infer_batch = srv._infer_batch

    def logged(reqs, x, alpha):
        for i, r in enumerate(reqs):
            buckets[r.rid] = (reqs, x, alpha, i)
        return infer_batch(reqs, x, alpha)
    srv._infer_batch = logged
    resolutions = {}
    futs = []
    t0 = time.perf_counter()
    for rid, i in enumerate(idx):
        f = srv.submit(pool_imgs[i])
        f.add_done_callback(
            lambda _f, rid=rid: resolutions.__setitem__(
                rid, resolutions.get(rid, 0) + 1))
        futs.append(f)
    _, pending = wait(futs, timeout=120)
    seconds = time.perf_counter() - t0
    check(not pending, f"resilience: {len(pending)} futures never resolved")
    srv.close()
    pool.close()
    pool._exec.shutdown(wait=True)      # a held straggler's call ends too
    torch.cuda.synchronize()
    check(sorted(resolutions) == list(range(len(idx)))
          and set(resolutions.values()) == {1},
          "resilience: a future did not resolve exactly once")
    launches = dispatch.launch_counts()
    st = srv.stats()["pool"]
    errors = [type(f.exception()).__name__ for f in futs
              if f.exception() is not None]
    n_ok = len(futs) - len(errors)
    line = {"requests": len(idx), "completed": n_ok,
            "failed": len(errors),
            "errors": {e: errors.count(e) for e in sorted(set(errors))},
            "seconds": seconds,
            "samples_per_s": n_ok / seconds,
            "calls": st["calls"], "engine_calls": len(calls),
            "retries": st["retries"], "hedges": st["hedges"],
            "stragglers": st["stragglers"],
            "quarantined": st["quarantined"], "requeues": st["requeues"],
            "deaths": st["deaths"], "faults_injected": st["faults_injected"],
            "hedge_deadline_ms_at_end": st["straggler_deadline_ms"],
            "touched_requests": st["touched_rids"],
            "engines": st["engines"],
            "rung_timeline": [(h["from"], h["to"])
                              for h in st["rung_history"]],
            "recovery_ms": [None if r is None else r * 1e3
                            for r in pool.recovery_s()],
            "trace": [(t["point"], t["kind"], t["engine"])
                      for t in inj.trace], "launches": launches}
    return line, futs, buckets, srv, calls


def untouched_against_alone(futs, buckets, srv, alone):
    """Requests no fault or rung touched, against their bucket served by
    ``alone`` (one engine, the policy before any rung): pred, exit and
    conf bit for bit.  Returns the number compared."""
    n = 0
    for rid, f in enumerate(futs):
        if rid in srv.touched_rids or f.exception() is not None:
            continue
        reqs, x, alpha, i = buckets[rid]
        lo = sum(r.n for r in reqs[:i])
        ref = alone.infer(x, mode="compacted", record=False, alpha=alpha)
        out = f.result()
        for k in ("pred", "exit_idx", "conf"):
            check(np.array_equal(out[k], ref[k][lo:lo + reqs[i].n]),
                  f"resilience: request {rid}'s {k} differs from its "
                  f"bucket served by the engine alone")
        n += 1
    return n


def engine_state_roundtrip(eng, x, root):
    """(a): the serving engine's EngineState saved, then restored into a
    fresh engine: every leaf bit-equal, the next masked infer equal bit
    for bit; save / restore ms (median of RES_REPS) and MB."""
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.engine import DartEngine
    path = str(root / "engine_state")
    save_ms, restore_ms = [], []
    fresh = DartEngine.from_config(eng.cfg, eng.params, adapt=False,
                                   cum_costs=eng.cum_costs)
    for rep in range(RES_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.save_state(path, step=rep)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        fresh.restore_state(path, step=rep)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
    a, b = flatten(eng.state), flatten(fresh.state)
    check(len(a) == len(b) and all(
        u.dtype == v.dtype and v.device == eng.device and torch.equal(u, v)
        for u, v in zip(a, b)),
        "resilience: a restored EngineState leaf differs")
    m1, m2 = eng.infer(x, mode="masked"), fresh.infer(x, mode="masked")
    for k in ("exit_idx", "pred", "conf", "conf_stack"):
        check(torch.equal(m1[k], m2[k]),
              f"resilience: masked {k} differs after the restore")
    mb = sum(t.numel() * t.element_size() for t in a) / 1e6
    return {"part": "a", "leaves": len(a), "mb": mb,
            "save_ms": float(np.median(save_ms)),
            "restore_ms": float(np.median(restore_ms)),
            "rows": len(x)}


def ladder_drain_join(eng0, eng1, pool_imgs, root):
    """(c): two engines behind four pool slots (a replica pair each, so
    that every rung can be reached), drained one slot at a time to rung
    4, then joined back from a snapshot: the rung climbs, then returns
    to 0; at rung 3 (tau from the cap stage on at the always-fire
    sentinel, tau' clipped to 0) no row of a 64-row bucket leaves past
    the cap stage, in either mode."""
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.kernels import dispatch
    from repro_torch.serving import (DispatchError, EnginePool,
                                     PooledDartServer, RequestShed,
                                     ResilienceConfig, SchedulerConfig)
    from repro_torch.serving.resilience import (DEPTH_CAP_FRAC,
                                                _TAU_ALWAYS_FIRE)
    slots = {"a": eng0, "b": eng1, "c": eng0, "d": eng1}
    pool = EnginePool(slots, ResilienceConfig(requeue_limit=2,
                                              requeue_backoff_s=0.001),
                      heartbeat=False)
    srv = PooledDartServer(pool, SchedulerConfig(
        mode="compacted", max_batch=RES_MAX_BATCH, edges=()), start=False)
    warm = [srv.submit(pool_imgs[i]) for i in range(8)]
    srv.flush()
    check(all(f.exception() is None for f in warm),
          "resilience: a warm request failed")
    snap = str(root / "snapshot")
    srv.snapshot(snap, step=1)
    saved = [t.clone() for t in flatten(eng0.state)]
    x = pool_imgs[:64]
    orig_tau = eng0.state.tau.cpu().numpy()
    cap = int(np.floor(orig_tau.size * DEPTH_CAP_FRAC))
    climb, capped = [], []

    def at_rung3(label):
        tau = pool.primary.state.tau.cpu().numpy()
        check((tau[cap:] == _TAU_ALWAYS_FIRE).all(),
              f"resilience: rung 3 did not install the cap ({tau})")
        for mode in ("compacted", "masked"):
            out = pool.call(lambda e: e.infer(x, mode=mode, record=False))
            top = int(np.max(out["exit_idx"]))
            check(top <= cap, f"resilience: at rung 3 a row left at exit "
                              f"{top} past the cap {cap} ({mode})")
            capped.append({"when": label, "mode": mode, "max_exit": top,
                           "exit_counts": np.bincount(
                               out["exit_idx"],
                               minlength=eng0.n_exits).tolist()})

    for name in "abcd":
        pool.drain(name)
        climb.append(pool.rung)
        if pool.rung == 3:
            at_rung3("draining")
    check(climb == [1, 2, 3, 4], f"resilience: drain rungs {climb}")
    shed = srv.submit(pool_imgs[0], priority=0)
    check(isinstance(shed.exception(timeout=5), RequestShed),
          "resilience: rung 4 did not shed priority 0")
    kept = srv.submit(pool_imgs[1], priority=1)
    srv.flush()
    check(isinstance(kept.exception(timeout=5), DispatchError)
          and srv.counters["requeued"] == 2,
          "resilience: the bounded requeue with no live engine")
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    pool.join("a", snapshot=snap)
    join_ms = (time.perf_counter() - t0) * 1e3
    warm_launches = dispatch.launch_counts()
    restored = flatten(eng0.state)
    check(all(torch.equal(u, v) for u, v in zip(saved[1:], restored[1:])),
          "resilience: the joined engine's state is not the snapshot's")
    back = [pool.rung]
    at_rung3("joining")
    for name in "bcd":
        pool.join(name, warm=False)
        back.append(pool.rung)
    check(back == [3, 2, 1, 0], f"resilience: join rungs {back}")
    check(np.array_equal(eng0.state.tau.cpu().numpy(), orig_tau)
          and np.array_equal(eng1.state.tau.cpu().numpy(), orig_tau),
          "resilience: the ladder did not restore tau")
    after = srv.submit(pool_imgs[2])
    srv.flush()
    check(after.exception(timeout=5) is None,
          "resilience: no service after the joins")
    srv.close()
    pool.close()
    return {"part": "c", "drain_rungs": climb, "join_rungs": back,
            "cap_stage": cap, "rung3": capped, "join_ms": join_ms,
            "warm_shapes": len(pool._warm_shapes),
            "warm_launches": warm_launches,
            "rung_timeline": [(h["from"], h["to"])
                              for h in pool.rung_history]}


def trainer_crash_resume(cfg, data, root, deterministic):
    """(d): Table I's batch and lr, RES_STEPS straight against
    RES_FAIL_AT + crash + resume: the restored tree bit-equal to the one
    saved at the crash step; the resumed losses within RES_LOSS_RTOL of
    the straight run's, or, with cuDNN's deterministic algorithms, the
    resumed losses and final tree bit-equal to the straight run's.
    Returns (line, the resumed trainer)."""
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.runtime import fault
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    def tc(d):
        return TrainConfig(batch_size=TRAIN_BATCH, steps=RES_STEPS,
                           lr=TRAIN_LR, log_every=1, ckpt_every=RES_FAIL_AT,
                           ckpt_dir=str(root / d))
    mode = "deterministic" if deterministic else "default"
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        straight = Trainer(cfg, tc(f"straight-{mode}"), data)
        hist = straight.run()
        t1 = Trainer(cfg, tc(f"crash-{mode}"), data)
        t1.run(steps=RES_FAIL_AT)
        t1.manager.wait()
        saved = [t.detach().cpu().clone() if isinstance(t, torch.Tensor)
                 else t for t in flatten(t1.state_tree())]
        del t1                                    # the crash
        t0 = time.perf_counter()
        t2 = fault.resume(cfg, tc(f"crash-{mode}"), data_cfg=data)
        resume_s = time.perf_counter() - t0
        got = flatten(t2.state_tree())
        check(t2.step == RES_FAIL_AT and len(got) == len(saved) and all(
            (torch.equal(u.cpu(), v) and u.device == t2.device)
            if isinstance(v, torch.Tensor) else u == v
            for u, v in zip(got, saved)),
            f"resilience: the restored trainer tree differs from the "
            f"saved one ({mode})")
        t2.run(steps=RES_STEPS)
    finally:
        torch.backends.cudnn.deterministic = prev
    a = {h["step"]: h["loss"] for h in hist}
    b = {h["step"]: h["loss"] for h in t2.history}
    steps = list(range(RES_FAIL_AT + 1, RES_STEPS + 1))
    rdiff = [abs(a[s] - b[s]) / abs(a[s]) for s in steps]
    check(t2.step == RES_STEPS and sorted(b) == steps,
          f"resilience: resumed steps {sorted(b)} ({mode})")
    if deterministic:
        check(max(rdiff) == 0.0 and all(
            torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v
            for u, v in zip(flatten(straight.state_tree()),
                            flatten(t2.state_tree()))),
            f"resilience: with deterministic cuDNN the resumed run is not "
            f"the straight run bit for bit ({b} vs {a})")
    else:
        check(max(rdiff) <= RES_LOSS_RTOL,
              f"resilience: resumed losses {b} vs straight {a}")
    kept = sorted(os.listdir(root / f"crash-{mode}"))
    check(kept == [f"step_{RES_FAIL_AT:08d}", f"step_{RES_STEPS:08d}"],
          f"resilience: checkpoints kept {kept}")
    step_ms = np.diff([0.0] + [h["elapsed_s"] for h in hist]) * 1e3
    return {"part": "d", "cudnn": mode, "batch": TRAIN_BATCH,
            "steps": RES_STEPS, "crash_at": RES_FAIL_AT,
            "leaves": len(got), "loss_straight": [a[s] for s in steps],
            "loss_resumed": [b[s] for s in steps],
            "max_loss_rdiff": max(rdiff), "resume_s": resume_s,
            "ms_per_step_median": float(np.median(step_ms[1:]))}, t2


def checkpoint_times(tree, root):
    """A trainer tree's checkpoint: its MB and the median ms (of three)
    of a synchronous save, of ``save_async``'s host copy (until it
    returns) and its background write, and of a restore onto the
    card."""
    import shutil

    from repro_torch import checkpoint as CK
    from repro_torch.checkpoint.checkpoint import flatten
    mb = sum(t.numel() * t.element_size() for t in flatten(tree)
             if isinstance(t, torch.Tensor)) / 1e6
    save_ms, copy_ms, write_ms, restore_ms = [], [], [], []
    for rep in range(3):
        d = str(root / f"timed{rep}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CK.save(d, 1, tree)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        fut = CK.save_async(d, 2, tree)
        t1 = time.perf_counter()
        fut.result()
        copy_ms.append((t1 - t0) * 1e3)
        write_ms.append((time.perf_counter() - t1) * 1e3)
        t0 = time.perf_counter()
        CK.restore(d, tree, step=1)
        torch.cuda.synchronize()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
        shutil.rmtree(d)
    return {"part": "d", "checkpoint_mb": mb,
            "save_ms": float(np.median(save_ms)),
            "save_async_copy_ms": float(np.median(copy_ms)),
            "save_async_write_ms": float(np.median(write_ms)),
            "restore_ms": float(np.median(restore_ms))}


def drive_resilience(cfg, params, policy_state, cum_costs, data, train_data):
    """The resilience phase (see the module docstring): (a) the
    EngineState round-trip, (b) a PooledDartServer under a seeded fault
    plan and without one, (c) the ladder through drain and join, (d) the
    trainer's crash-resume.  Returns the kernel launches of (b)."""
    import shutil

    from repro_torch.data.datasets import make_batch
    from repro_torch.engine import DartEngine
    from repro_torch.kernels import dispatch

    t_start = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_resilience"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)

    def engine():
        e = DartEngine.from_config(cfg, params, adapt=False,
                                   cum_costs=cum_costs)
        e.state = e.state.with_policy(tau=policy_state.tau,
                                      coef=policy_state.coef,
                                      beta_diff=policy_state.beta_diff)
        return e
    imgs = make_batch(data, range(SERVE_POOL_OFFSET,
                                  SERVE_POOL_OFFSET + SERVE_POOL), "eval")[0]
    idx = np.random.default_rng(1).integers(0, SERVE_POOL, RES_REQUESTS)

    # (a) the EngineState round-trip, after some serving
    served = engine()
    for a in range(0, 256, 64):
        served.infer(imgs[a:a + 64], mode="compacted")
    served.record_requests(np.linspace(1.0, 9.0, 32), np.arange(32) % 5 == 0)
    part_a = engine_state_roundtrip(served, imgs[:64], root)
    emit(phase="resilience", model=cfg.name, **part_a)

    # (b) the pool, without and with faults; one more engine serves
    # each untouched bucket alone
    alone = engine()
    for b in (1, 2, 4, 8, 16):                   # warm every bucket shape
        alone.infer(imgs[:b], mode="compacted", record=False)
    lines = {}
    for label, plan in (("no-faults", None), ("faults", res_plan())):
        engines = {"e0": engine(), "e1": engine()}
        line, futs, buckets, srv, calls = pooled_run(engines, imgs, idx,
                                                     plan)
        launches = line["launches"]
        implied = sum(stages for _, stages in calls)
        check(launches["difficulty"] == RES_REQUESTS,
              f"resilience {label}: {launches['difficulty']} difficulty "
              f"launches for {RES_REQUESTS} submits")
        check(launches["exit_gate"] == implied,
              f"resilience {label}: {launches['exit_gate']} gate launches, "
              f"the engine calls imply {implied}")
        line["untouched_checked"] = untouched_against_alone(futs, buckets,
                                                            srv, alone)
        # exempted here: the requests a fault or a rung touched (no edge
        # rows: bit for bit against the same bucket on one engine)
        line["compared"] = rows_compared(
            RES_REQUESTS, RES_REQUESTS - line["untouched_checked"])
        line.update(run=label, implied_gate=implied)
        lines[label] = line
        emit(phase="resilience", model=cfg.name, part="b", **line)
    clean, faulted = lines["no-faults"], lines["faults"]
    check(clean["compared"]["floor_met"],
          f"resilience: the fault-free run compared {clean['compared']}")
    check(clean["failed"] == 0 and clean["deaths"] == 0
          and clean["untouched_checked"]
          == RES_REQUESTS - clean["touched_requests"],
          f"resilience: the fault-free run failed {clean}")
    check(faulted["faults_injected"] == len(res_plan())
          and faulted["hedges"] >= 1 and faulted["quarantined"] >= 1
          and faulted["deaths"] >= 1 and faulted["retries"] >= 2
          and faulted["failed"] == 0,
          f"resilience: the fault plan did not play out {faulted}")
    check(faulted["untouched_checked"] > 0,
          "resilience: no request left untouched to compare")
    check(all(r is not None for r in faulted["recovery_ms"]),
          "resilience: no success after a death")

    # (c) the ladder through drain and join
    part_c = ladder_drain_join(engine(), engine(), imgs, root)
    emit(phase="resilience", model=cfg.name, **part_c)

    # (d) the trainer's crash-resume, with cuDNN's default algorithms and
    # with its deterministic ones; then the checkpoint's costs
    for deterministic in (False, True):
        line, trainer = trainer_crash_resume(cfg, train_data, root,
                                             deterministic)
        emit(phase="resilience", model=cfg.name, **line)
    emit(phase="resilience", model=cfg.name,
         **checkpoint_times(trainer.state_tree(), root))
    shutil.rmtree(root, ignore_errors=True)
    emit(phase="resilience", model=cfg.name, summary=True,
         phase_s=time.perf_counter() - t_start,
         samples_per_s={k: v["samples_per_s"] for k, v in lines.items()})
    return lines["faults"]["launches"], lines["no-faults"]["launches"]


# ---------------------------------------------------------------------------
# phases 6-7: LM decode on the main path
# ---------------------------------------------------------------------------

def lm_engine(cfg):
    from repro_torch.core.routing import DartParams
    from repro_torch.engine.lm import LMDecodeEngine
    from repro_torch.models.transformer_lm import lm_init

    params = lm_init(cfg, seed=0)                      # drawn on the card
    e = cfg.n_exits - 1
    eng = LMDecodeEngine(cfg, params, DartParams(
        tau=torch.full((e,), 2.0), coef=torch.ones(e), beta_diff=LM_BETA))
    check(eng.device.type == "cuda", "LM engine not on the card")
    return eng


def lm_calibrate(eng, rs, quantiles=(0.75, 0.5, 0.5), prompts=None):
    """tau per gate from the first decode step's conf of 16 prompts
    (random tokens, or ``prompts`` (16, 16)); the probing step fires
    nowhere: the quantile of conf - beta_diff*alpha, so every stage
    takes some rows."""
    if prompts is None:
        prompts = rs.randint(0, eng.cfg.vocab, (16, 16))
    b, s0 = prompts.shape
    confs = {}

    def probe(s, active, h, logits, conf, eff):
        confs[s] = conf.float().cpu().numpy()

    cache = eng.prefill(prompts[:, :-1], eng.init_cache(b, s0))
    _, stages, _, alpha = eng.decode_step(
        prompts[:, -1], cache, s0 - 1, np.full(b, 0.5, np.float32),
        record=False, probe=probe)
    check(np.all(stages == eng.n_exits - 1), "the probing step fired early")
    tau = np.array([np.quantile(confs[s] - LM_BETA * alpha, q)
                    for s, q in enumerate(quantiles)], np.float32)
    eng.state = eng.state.with_policy(tau=tau)
    return tau


def lm_requests(rs, n, vocab, n_new=None):
    """n one-row requests, prompts of 16 to 64 tokens; n_new fixed or
    drawn from 16..48."""
    return [(i, rs.randint(0, vocab, (1, int(rs.randint(16, 65)))),
             n_new or int(rs.randint(16, 49))) for i in range(n)]


def lm_drive(dec, reqs, admit_per_step=None):
    """Admit FIFO whenever the pool has room (at most ``admit_per_step``
    a step) and step until every request finished.  Returns (results,
    decode steps, seconds in all, seconds of admission and prefill)."""
    results, pending, steps, admit_s = {}, list(reqs), 0, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(results) < len(reqs):
        k = 0
        t1 = time.perf_counter()
        while pending and k != admit_per_step and dec.can_admit(
                1, pending[0][1].shape[1], pending[0][2]):
            tag, p, n = pending.pop(0)
            dec.admit(p, n, tag=tag)
            k += 1
        if k:
            torch.cuda.synchronize()
            admit_s += time.perf_counter() - t1
        check(dec.active_rows > 0, "LM decoder stalled")
        for tag, toks, stgs in dec.step():
            results[tag] = (toks[0], stgs[0])
        steps += 1
    torch.cuda.synchronize()
    return results, steps, time.perf_counter() - t0, admit_s


def lm_capture(eng, dec, tags=None):
    """The served path's hidden row at every exit head, keyed by
    (request tag, step, stage), for the one-row requests in ``tags``
    (None: all): the engine's head call is wrapped (whichever thread
    steps the decoder makes it), and the decoder says which slot holds
    which request at which step.  Returns (rows, undo)."""
    rows = {}
    inner = eng._head_traced

    def traced(params, h, exit_name, eff):
        s = eng.exit_names.index(exit_name)
        keys, slots = [], []
        for slot, (rid, row) in dec._slot_req.items():
            rec = dec._requests[rid]
            if dec.active[slot] and (tags is None or rec["tag"] in tags):
                keys.append((rec["tag"], len(rec["toks"][row]), s))
                slots.append(slot)
        if slots:
            picked = h[torch.as_tensor(slots, device=h.device)]
            for i, key in enumerate(keys):
                rows[key] = picked[i]
        return inner(params, h, exit_name, eff)

    eng._head_traced = traced
    return rows, lambda: eng.__dict__.pop("_head_traced", None)


def lm_head32(eng, table32, h, s):
    """Exit ``s``'s float32 logits of hidden rows ``h`` (B, d): the
    rmsnorm in float32, never cast back, as the kernel head computes
    it."""
    name = eng.exit_names[s]
    norm = eng.params["final_norm"] if name == "final" \
        else eng.params["exit_heads"][name]["norm"]
    x = h.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
        * norm["scale"].float()
    return x @ table32.T


#: what ``lm_stage_record`` measures at one stage of one decision
LM_STAGE_FIELDS = ("gap_o", "eps_o", "delta", "scale", "conf_o", "conf_s",
                   "conf_o32", "gap_s", "eff")


def lm_stage_records(eng, table32, s, h_o, logits, conf, eff, h_s):
    """One stage of oracle decisions, row by row, beside the served
    path's at the same context: the oracle's own top-2 logit gap (its
    bf16 logits) and their distance from float32 logits of its hidden
    row (``eps_o``); the served and the oracle's hidden rows through the
    one float32 head: their largest logit difference (``delta``), the
    largest logit (``scale``), the served conf and top-2 gap; the
    oracle's conf and tau' (-1 at the final stage, which always
    accepts).  Returns one dict a row."""
    lo = logits.float()
    l32 = lm_head32(eng, table32, h_o, s)
    ls = lm_head32(eng, table32, h_s, s)
    top_o = lo.topk(2, dim=-1).values
    top_s = ls.topk(2, dim=-1).values
    vals = torch.stack([
        top_o[:, 0] - top_o[:, 1], (lo - l32).abs().amax(-1),
        (ls - l32).abs().amax(-1), l32.abs().amax(-1), conf.float(),
        torch.softmax(ls, -1).amax(-1), torch.softmax(l32, -1).amax(-1),
        top_s[:, 0] - top_s[:, 1],
        eff.float() if eff is not None else lo.new_full((len(lo),), -1.0)],
        dim=1)
    return [dict(zip(LM_STAGE_FIELDS, row)) for row in vals.cpu().tolist()]


def lm_stage_record(eng, table32, s, h_o, logits, conf, eff, h_s):
    """``lm_stage_records`` of the first oracle row against the served
    row ``h_s`` (d,)."""
    return lm_stage_records(eng, table32, s, h_o[:1], logits[:1], conf[:1],
                            None if eff is None else eff[:1], h_s[None])[0]


def lm_replay(eng, reqs, results, view_len, served, width):
    """Every decision of the served ``results`` made again by the eager
    oracle (plain head) at the decoder's view length, on the served
    context: step t feeds the served token of step t - 1, and the KV of
    the layers past the served exit stage is propagated from that
    stage, as the served path did.  The request's row is repeated
    ``width`` times (the decoder's slots), so the oracle's products
    have the served batch's shapes; its prompt is prefilled as one
    row, as the decoder prefills it.  Each step runs once on a copy of
    the cache under the engine's policy (the oracle's own decision,
    probed stage by stage against the served hidden rows ``served``);
    where the oracle left at another stage, once more on the cache
    under a policy that fires exactly at the served stage.  Returns
    {(tag, step): (token, stage, {stage: lm_stage_record})}."""
    from repro_torch.models.transformer_lm import _unembed_table

    table32 = _unembed_table(eng.params, eng.cfg).float()
    keep = eng.state.tau
    out = {}
    for tag, p, n in reqs:
        gt, gs = results[tag]
        s0 = p.shape[1]
        cache = eng.init_cache(1, view_len)
        if s0 > 1:
            cache = eng.prefill(p[:, :-1], cache)
        cache = [{k: c.expand(width, *c.shape[1:]).contiguous()
                  for k, c in layer.items()} for layer in cache]
        alpha = np.full(width, 0.5, np.float32)
        tok = np.repeat(p[:, -1], width)
        for t in range(n):
            recs = {}

            def probe(s, active, h, logits, conf, eff, t=t, recs=recs):
                recs[s] = lm_stage_record(eng, table32, s, h, logits, conf,
                                          eff, served[(tag, t, s)])

            trial = [{k: c.clone() for k, c in layer.items()}
                     for layer in cache]
            own_t, own_s, trial, new_alpha = eng.decode_step(
                tok, trial, s0 - 1 + t, alpha, record=False, probe=probe)
            check(len(set(own_t)) == 1 and len(set(own_s)) == 1,
                  "LM replay: the repeated rows decided otherwise")
            if own_s[0] == gs[t]:
                cache = trial
            else:
                forced = torch.full_like(keep, math.inf)
                if gs[t] < eng.n_exits - 1:
                    forced[int(gs[t])] = -math.inf
                eng.state = eng.state.with_policy(tau=forced)
                try:
                    _, st, cache, _ = eng.decode_step(
                        tok, cache, s0 - 1 + t, alpha, record=False)
                finally:
                    eng.state = eng.state.with_policy(tau=keep)
                check(bool((st == gs[t]).all()), "LM replay: the forced "
                      f"stage did not fire ({st[0]} != {gs[t]})")
            out[(tag, t)] = (int(own_t[0]), int(own_s[0]), recs)
            alpha = new_alpha
            tok = np.repeat(gt[t:t + 1], width)
    del table32
    return out


def lm_decisions(name, reqs, results, replay, dtype):
    """The decision check of an LM path against its eager oracle: every
    (request, step) decision is one row, made by both on the same
    context (``lm_replay``).  At every stage where both ran, the two
    hidden rows through one float32 head must agree: logits within
    LM_TRUNK_TOL's share of the largest, conf within its share of
    itself.  A decision may differ only where the measured differences
    allow it at the stage where the two part: a tie, the oracle's top-2
    gap within twice the logit difference of the two sides (``delta``
    plus the oracle's own bf16 rounding ``eps_o``), or the served
    head's exact gap below HEAD_GAP; or an edge, the oracle's
    |conf - tau'| within the two sides' conf difference plus the kernel
    head's HEAD_CONF_TOL.  Those are counted and exempted, any other
    difference fails, and the compared decisions must reach
    COMPARED_FLOOR."""
    logit_tol, conf_rtol = LM_TRUNK_TOL[dtype]
    c = {"requests": len(reqs), "requests_equal": 0, "decisions": 0,
         "equal": 0, "tie": 0, "edge": 0, "requests_with_exempt": 0,
         "max_logit_err_share": 0.0, "max_conf_rerr": 0.0,
         "max_eps_o_share": 0.0}
    unexplained = []
    for tag, _, n in reqs:
        gt, gs = results[tag]
        diff = exempt = 0
        for t in range(n):
            own_t, own_s, recs = replay[(tag, t)]
            m = min(own_s, int(gs[t]))
            for s in range(m + 1):
                r = recs[s]
                c["max_logit_err_share"] = max(c["max_logit_err_share"],
                                               r["delta"] / r["scale"])
                c["max_eps_o_share"] = max(c["max_eps_o_share"],
                                           r["eps_o"] / r["scale"])
                c["max_conf_rerr"] = max(
                    c["max_conf_rerr"],
                    abs(r["conf_s"] - r["conf_o32"]) / r["conf_o32"])
            c["decisions"] += 1
            if own_t == gt[t] and own_s == gs[t]:
                c["equal"] += 1
                continue
            diff += 1
            r = recs[m]
            if own_s == gs[t]:
                ok = (r["gap_o"] <= 2 * (r["delta"] + r["eps_o"])
                      or r["gap_s"] < HEAD_GAP)
                kind = "tie"
            else:
                ok = abs(r["conf_o"] - r["eff"]) <= \
                    abs(r["conf_s"] - r["conf_o"]) + HEAD_CONF_TOL
                kind = "edge"
            if ok:
                c[kind] += 1
                exempt += 1
            else:
                unexplained.append({"request": tag, "step": t, "stage": m,
                                    "served": [int(gt[t]), int(gs[t])],
                                    "oracle": [own_t, own_s], **r})
        c["requests_equal"] += diff == 0
        c["requests_with_exempt"] += exempt > 0
    c["compared"] = rows_compared(c["decisions"], c["tie"] + c["edge"])
    check(c["max_logit_err_share"] <= logit_tol,
          f"{name}: served and oracle logits differ by "
          f"{c['max_logit_err_share']} of the largest")
    check(c["max_conf_rerr"] <= conf_rtol,
          f"{name}: served and oracle conf differ by {c['max_conf_rerr']} "
          "of itself")
    check(not unexplained,
          f"{name}: unexplained decisions {unexplained[:3]}")
    check(c["compared"]["floor_met"], f"{name}: compared {c['compared']}")
    return c


def profile_window(step, steps):
    """Device busy share over ``steps`` calls of ``step()`` and the
    kernels that take the device time (torch.profiler; kernels of one
    stream do not overlap, so their summed time is busy time).  Returns
    (summary, the CUDA kernels' averages)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernels_per_step": sum(e.count for e in kern) / steps,
            "top_kernels_ms_per_step": [
                [e.key[:70], e.self_device_time_total / 1e3 / steps]
                for e in top]}, kern


def lm_profile(eng, reqs, n_slots, steps=8, max_len=1024):
    """``profile_window`` over decode steps with a full pool, and the
    exit heads' share of the device time."""
    dec = eng.continuous(n_slots=n_slots, page_size=8, max_len=max_len)
    for tag, p, n in reqs[:n_slots]:
        dec.admit(p, n, tag=tag)
    dec.step()
    dec.step()
    out, kern = profile_window(dec.step, steps)
    # every kernel of an exit_head launch (csrc/exit_head.cu) is head_*
    out["exit_head_ms_per_step"] = sum(
        e.self_device_time_total for e in kern
        if "::head_" in e.key) / 1e3 / steps
    return out


def lm_launches(eng, steps):
    """This run's launches of the LM kernels, checked exactly: one exit
    head per stage and two gathers per layer in every decode step."""
    from repro_torch.kernels import dispatch
    counts = dispatch.launch_counts()
    want = {"exit_gate": 0, "difficulty": 0,
            "exit_head": eng.n_exits * steps,
            "paged_gather": 2 * eng.cfg.n_layers * steps}
    check(counts == want, f"LM launch counts {counts} != {want}")
    return counts


def tinyllama(**kw):
    """TinyLlama-1.1B's published config at LM_TINYLLAMA_LAYERS layers
    (exits at its fractions of depth), with ``kw`` replaced."""
    from repro_torch.configs.tinyllama_1_1b import CONFIG
    return dataclasses.replace(CONFIG, n_layers=LM_TINYLLAMA_LAYERS,
                               exit_layers=LM_TINYLLAMA_EXITS, **kw)


def lm_strict():
    """TinyLlama at full width and LM_TINYLLAMA_LAYERS in fp32: the
    continuous decoder (kernels) against the eager oracle (plain head),
    decision by decision (``lm_decisions``)."""
    from repro_torch.kernels import dispatch

    cfg = tinyllama(param_dtype=torch.float32, compute_dtype=torch.float32)
    eng = lm_engine(cfg)
    rs = np.random.RandomState(1)
    tau = lm_calibrate(eng, rs)
    reqs = lm_requests(rs, 40, cfg.vocab, n_new=16)
    dec = eng.continuous(n_slots=16, page_size=8, max_len=128)
    served, undo = lm_capture(eng, dec)
    dispatch.reset_launch_counts()
    results, steps, secs, _ = lm_drive(dec, reqs, admit_per_step=4)
    counts = lm_launches(eng, steps)
    undo()
    stages = np.stack([results[t][1] for t, _, _ in reqs])
    hist = np.bincount(stages.ravel(), minlength=eng.n_exits)
    check(bool((hist > 0).all()), f"LM strict: a stage took no token {hist}")
    cmp = lm_decisions("lm-strict", reqs, results, lm_replay(
        eng, reqs, results, dec.view_len, served, dec.n_slots), "float32")
    emit(phase="lm-strict", model=cfg.name, dtype="float32",
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
         exits=list(cfg.exit_layers), tau=tau.tolist(), beta_diff=LM_BETA,
         n_slots=dec.n_slots, max_len=dec.max_len, requests=len(reqs),
         decode_steps=steps, seconds=secs, launches=counts,
         exit_counts=hist.tolist(), oracle_agreement=cmp)
    del eng, dec
    torch.cuda.empty_cache()


def lm_serving():
    """The published bf16 configuration at a cut depth
    (LM_SERVING_LAYERS) at 16 and 64 slots: throughput, exits, launches,
    memory; at 16 slots the agreement with the bf16 eager oracle,
    explained."""
    from repro_torch.configs.tinyllama_1_1b import CONFIG
    from repro_torch.convert import leaves
    from repro_torch.kernels import dispatch

    cfg = dataclasses.replace(CONFIG, n_layers=LM_SERVING_LAYERS,
                              exit_layers=LM_SERVING_EXITS)
    eng = lm_engine(cfg)
    n_params = sum(t.numel() for t in leaves(eng.params))
    rs = np.random.RandomState(2)
    tau = lm_calibrate(eng, rs)
    main = None
    for n_slots in (16, 64):
        reqs = lm_requests(np.random.RandomState(100 + n_slots),
                           4 * n_slots, cfg.vocab)
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for k in range(1 + SERVE_RUNS):             # the first warms up
            dec = eng.continuous(n_slots=n_slots, page_size=8, max_len=1024)
            if k == 0 and n_slots == 16:
                # the untimed run's hidden rows, for the oracle check
                served, undo = lm_capture(eng, dec)
            dispatch.reset_launch_counts()
            results, steps, secs, admit_s = lm_drive(dec, reqs)
            counts = lm_launches(eng, steps)
            if k == 0 and n_slots == 16:
                undo()
            runs.append((results, steps, secs, counts, admit_s))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        results, steps, _, counts, _ = runs[-1]
        tokens = sum(n for _, _, n in reqs)
        secs = [r[2] for r in runs[1:]]
        decode_ms = [1e3 * (r[2] - r[4]) / r[1] for r in runs[1:]]
        prefill_ms = [1e3 * r[4] / len(reqs) for r in runs[1:]]
        stages = np.concatenate([results[t][1] for t, _, _ in reqs])
        repeatable = all(np.array_equal(results[t][0], r[0][t][0])
                         and np.array_equal(results[t][1], r[0][t][1])
                         for r in runs for t, _, _ in reqs)
        row = dict(phase="lm-serving", model=cfg.name, dtype="bfloat16",
                   layers=cfg.n_layers, exits=list(cfg.exit_layers),
                   params=n_params, tau=tau.tolist(), beta_diff=LM_BETA,
                   n_slots=n_slots, max_len=dec.max_len,
                   view_len=dec.view_len, page_size=dec.page_size,
                   requests=len(reqs), tokens=tokens, decode_steps=steps,
                   seconds=secs, tokens_per_s=tokens / float(np.median(secs)),
                   decode_step_ms=float(np.median(decode_ms)),
                   admit_prefill_ms_per_request=float(np.median(prefill_ms)),
                   exit_counts=np.bincount(
                       stages, minlength=eng.n_exits).tolist(),
                   mean_layer_fraction=float(eng.cum_costs[stages].mean()),
                   launches=counts, peak_memory_gb=peak_gb,
                   runs_repeat=repeatable)
        row["profile"] = lm_profile(eng, reqs, n_slots)
        if n_slots == 16:
            warm = runs[0][0]
            row["oracle_agreement"] = lm_decisions(
                "lm-serving", reqs, warm,
                lm_replay(eng, reqs, warm, dec.view_len, served,
                          dec.n_slots), "bfloat16")
            del served
        emit(**row)
        main = row
        del dec, runs
        torch.cuda.empty_cache()
    return main


# ---------------------------------------------------------------------------
# phases 8-10: the LM trained, served by the sessions, and InternLM2-20B
# ---------------------------------------------------------------------------

def lm_token_data():
    from repro_torch.data.datasets import DatasetConfig
    return DatasetConfig(name="synth-tokens", n_train=4096, n_eval=1024)


def lm_step1_against_cpu(cfg, tc, data, seq):
    """Step 1 of the LM trainer at a cut depth (LM_CPU_LAYERS layers, one
    exit, full width, float32) on the card against the same step on the
    CPU, from the same init and batch: the loss within
    LM_STEP1_LOSS_RTOL, each leaf's gradient within LM_STEP1_GRAD_RTOL
    of its norm."""
    from repro_torch.convert import tree_map
    from repro_torch.data.datasets import make_batch
    from repro_torch.models.transformer_lm import lm_init
    from repro_torch.optim import value_and_grad
    from repro_torch.runtime.trainer import Trainer

    cut = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS, exit_layers=(0,),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    init = lm_init(cut, seed=0, device="cuda")
    x, y = make_batch(data, range(LM_CPU_BATCH), kind="tokens",
                      seq_len=seq + 1, vocab=LM_TRAIN_DATA_VOCAB)
    card = Trainer(cut, tc, data, params=init)
    cpu = Trainer(cut, tc, data, params=tree_map(lambda t: t.cpu(), init),
                  device="cpu")
    grads = []
    for tr, dev in ((card, "cuda"), (cpu, "cpu")):
        batch = tr._prepare(torch.as_tensor(x, device=dev),
                            torch.as_tensor(y, device=dev))
        (loss, _), g = value_and_grad(tr._loss_fn, tr.params, batch)
        grads.append((float(loss), g))
    (l_card, g_card), (l_cpu, g_cpu) = grads
    check(math.isclose(l_card, l_cpu, rel_tol=LM_STEP1_LOSS_RTOL),
          f"lm-train: step 1 loss {l_card} on the card, {l_cpu} on the CPU")
    err = max(float((gc.cpu() - gh).norm() / gh.norm())
              for _, gc, gh in _pairs(g_card, g_cpu) if float(gh.norm()))
    check(err <= LM_STEP1_GRAD_RTOL,
          f"lm-train: step 1 gradients {err} off the CPU's")
    return {"layers": cut.n_layers, "d_model": cut.d_model,
            "vocab": cut.vocab, "dtype": "float32", "batch": LM_CPU_BATCH,
            "seq": seq, "loss_card": l_card, "loss_cpu": l_cpu,
            "grad_rel_err": err}


def lm_train():
    """TinyLlama-1.1B at full width and LM_TINYLLAMA_LAYERS trained
    through ``Trainer`` (bf16, remat, AdamW) on synth-tokens; returns the
    trained params."""
    from repro_torch.convert import leaves
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer_lm import lm_init
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    t_start = time.perf_counter()
    cfg = tinyllama(max_seq=LM_TRAIN_SEQ)
    data = lm_token_data()
    tc = TrainConfig(batch_size=LM_TRAIN_BATCH, steps=LM_TRAIN_STEPS,
                     lr=LM_TRAIN_LR, warmup=LM_TRAIN_WARMUP, log_every=1)
    step1 = lm_step1_against_cpu(cfg, tc, data, LM_TRAIN_SEQ)
    torch.cuda.empty_cache()
    dispatch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, data, params=lm_init(cfg, seed=0))
    check(tr.device.type == "cuda" and cfg.remat, "lm-train: not on the card")
    pipe = DataPipeline(data, tc.batch_size, kind="tokens",
                        seq_len=cfg.max_seq + 1, vocab=LM_TRAIN_DATA_VOCAB)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = list(tr.run(pipeline=pipe,
                            steps=LM_TRAIN_STEPS - LM_TRAIN_PROFILED))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        # the last steps under the profiler: where a step's time goes
        profiled, _ = profile_window(
            lambda: tr.run(pipeline=pipe, steps=tr.step + 1),
            LM_TRAIN_PROFILED)
        hist = tr.history
    finally:
        pipe.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = {h["step"]: h["loss"] for h in hist}
    check(sorted(losses) == list(range(1, LM_TRAIN_STEPS + 1)),
          f"lm-train: logged steps {sorted(losses)}")
    check(all(math.isfinite(v) for v in losses.values()),
          "lm-train: a loss is not finite")
    check(losses[LM_TRAIN_STEPS] < losses[1],
          f"lm-train: loss did not fall ({losses[1]} -> "
          f"{losses[LM_TRAIN_STEPS]})")
    train_launches = dispatch.launch_counts()
    check(not any(train_launches.values()),
          f"lm-train: fused kernels launched while training {train_launches}")
    step_ms = np.diff([0.0] + [h["elapsed_s"] for h in timed]) * 1e3
    emit(phase="lm-train", model=cfg.name, dtype="bfloat16",
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
         params=sum(t.numel() for t in leaves(tr.params)), remat=cfg.remat,
         max_seq=cfg.max_seq,
         note="max_seq cut from 4096 to 256 (sequence length, not width)",
         data_vocab=LM_TRAIN_DATA_VOCAB,
         optimizer=tc.optimizer, lr=tc.lr, warmup=tc.warmup,
         batch=tc.batch_size, steps=tc.steps, step1_vs_cpu=step1,
         ms_per_step_median=float(np.median(step_ms[1:])),
         ms_per_step_first=float(step_ms[0]), run_s=run_s,
         peak_memory_gb=peak_gb, profile=profiled,
         loss={k: losses[k] for k in (1, 10, LM_TRAIN_STEPS)},
         loss_mean_last10=float(np.mean(
             [losses[k] for k in range(LM_TRAIN_STEPS - 9,
                                       LM_TRAIN_STEPS + 1)])),
         launches=train_launches,
         phase_s=time.perf_counter() - t_start)
    params = tr.params
    del tr
    torch.cuda.empty_cache()
    return params


def lm_prompts(data, rs, n, vocab):
    """n one-row requests whose prompts (16 to 64 tokens) are prefixes of
    eval sequences of the training set's motif grammar, n_new from
    16..48."""
    from repro_torch.data.datasets import make_batch
    seqs, _ = make_batch(data, range(n), "eval", kind="tokens", seq_len=64,
                         vocab=vocab)
    return [(i, seqs[i:i + 1, :int(rs.randint(16, 65))],
             int(rs.randint(16, 49))) for i in range(n)]


def lm_session_stream(eng, reqs, rate):
    """(a): ``LMContinuousSession`` (16 slots, max_len 1024, its own
    dispatcher thread) fed ``reqs`` from a second thread as an open-loop
    Poisson stream at ``rate`` requests/s, deadline
    LM_SESSION_DEADLINE_MS each.  The session tags each request in the
    decoder with its id, which counts submissions from 0, so request i
    of ``reqs`` (tag i) is the session's request i.  Returns (line,
    results by tag, view_len, the served hidden rows)."""
    import threading
    from repro_torch.kernels import dispatch
    from repro_torch.serving import SchedulerConfig

    rng = np.random.default_rng(LM_SESSION_SEED)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, len(reqs)))
    sess = eng.session(SchedulerConfig(policy="reject", max_queue=len(reqs)),
                       continuous=True, n_slots=LM_SESSION_SLOTS,
                       page_size=8, max_len=1024)
    check([t for t, _, _ in reqs] == list(range(len(reqs))),
          "lm-session: request tags are not 0, 1, ...")
    served, undo = lm_capture(eng, sess.decoder)
    futs = {}
    steps0 = int(eng.state.decode_steps)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()

    def submitter():
        for (tag, p, n), t_arr in zip(reqs, arrivals):
            wait = t_arr - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            futs[tag] = sess.submit(p, deadline_ms=LM_SESSION_DEADLINE_MS,
                                    n_new=n)
    th = threading.Thread(target=submitter, name="lm-submitter")
    th.start()
    th.join(timeout=300)
    check(not th.is_alive() and len(futs) == len(reqs),
          "lm-session: the submitter did not finish")
    outs = {tag: f.result(timeout=300) for tag, f in futs.items()}
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    steps = int(eng.state.decode_steps) - steps0
    counts = lm_launches(eng, steps)
    sched = sess.stats()["scheduler"]
    view_len = sess.decoder.view_len
    sess.close()
    undo()
    steps_of = {}
    for tag, t, s in served:
        steps_of[tag] = max(steps_of.get(tag, 0), t + 1)
    check(steps_of == {t: n for t, _, n in reqs},
          "lm-session: the captured steps are not the requests'")
    lat = np.array([o["latency_ms"] for o in outs.values()])
    tokens = sum(n for _, _, n in reqs)
    stages = np.concatenate([outs[t]["stages"][0] for t, _, _ in reqs])
    line = {"requests": len(reqs), "offered_per_s": rate,
            "tokens": tokens, "seconds": secs, "tokens_per_s": tokens / secs,
            "latency_ms": dict(zip(("p50", "p95", "p99"), np.percentile(
                lat, [50, 95, 99]).tolist())),
            "deadline_ms": LM_SESSION_DEADLINE_MS,
            "misses": int(sum(o["deadline_missed"] for o in outs.values())),
            "starved": sched["starved"], "completed": sched["completed"],
            "decode_steps": steps, "launches": counts,
            "launches_per_step": {k: v / max(steps, 1)
                                  for k, v in counts.items()},
            "exit_counts": np.bincount(stages,
                                       minlength=eng.n_exits).tolist()}
    check(sched["completed"] == len(reqs),
          f"lm-session: completed {sched['completed']} of {len(reqs)}")
    results = {t: (outs[t]["tokens"][0], outs[t]["stages"][0])
               for t, _, _ in reqs}
    return line, results, view_len, served


def lm_log_buckets(sess):
    """Record each bucket ``sess`` dispatches: (rids, prompts, n_new)."""
    log = []
    inner = sess._dispatch_safe

    def logged(reqs, reason):
        log.append(([r.rid for r in reqs],
                    np.concatenate([r.x for r in reqs]),
                    reqs[0].payload["n_new"]))
        return inner(reqs, reason)
    sess._dispatch_safe = logged
    return log


def lm_bucket_requests(data, rs, vocab):
    """Four lanes (prompt length, n_new) of one- and two-row requests."""
    from repro_torch.data.datasets import make_batch
    seqs, _ = make_batch(data, range(64, 96), "eval", kind="tokens",
                         seq_len=48, vocab=vocab)
    out = []
    for k, (s0, n) in enumerate(((16, 16), (32, 16), (16, 24), (48, 8))):
        for j in range(3):
            rows = 1 + (j + k) % 2
            a = int(rs.randint(0, len(seqs) - rows))
            out.append((seqs[a:a + rows, :s0], n))
    return out


def lm_buckets_against_generate(eng, reqs):
    """(b): ``LMDecodeSession`` over the engine: four lanes forced out as
    four buckets, each request equal to ``generate`` on its bucket."""
    from repro_torch.serving import SchedulerConfig
    sess = eng.session(SchedulerConfig(max_batch=8, policy="reject"),
                       start=False)
    log = lm_log_buckets(sess)
    futs = [sess.submit(p, n_new=n) for p, n in reqs]
    sess.close()
    outs = [f.result(timeout=300) for f in futs]
    check(len(log) == 4, f"lm-session (b): {len(log)} buckets, not 4")
    rows = 0
    for rids, prompts, n in log:
        tok, stg = eng.generate(prompts, n)
        check(np.array_equal(np.concatenate([outs[i]["tokens"]
                                             for i in rids]), tok)
              and np.array_equal(np.concatenate([outs[i]["stages"]
                                                 for i in rids]), stg),
              "lm-session (b): a bucket differs from generate")
        rows += len(prompts)
    return {"requests": len(reqs), "buckets": len(log), "rows": rows,
            "bucket_sizes": [len(p) for _, p, _ in log],
            "equal_to_generate": True}


def lm_pooled(eng, reqs):
    """(c): ``pooled_lm_session`` over two engines sharing one param tree,
    under a seeded plan that kills one engine once: every request
    resolves exactly once, and each request no fault touched is bit-equal
    to its bucket on one engine."""
    from repro_torch.engine.lm import LMDecodeEngine
    from repro_torch.runtime.chaos import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.serving import (EnginePool, ResilienceConfig,
                                     SchedulerConfig, pooled_lm_session)

    def twin():
        e = LMDecodeEngine(eng.cfg, eng.params, eng.dart)
        check(e.params["embed"]["table"].data_ptr()
              == eng.params["embed"]["table"].data_ptr(),
              "lm-session (c): the engines do not share the param tree")
        return e
    at = int(np.random.RandomState(LM_SESSION_SEED).randint(0, 2))
    plan = FaultPlan([FaultSpec("engine_death", "step", at, engine="l1")])
    pool = EnginePool({"l0": twin(), "l1": twin()}, ResilienceConfig(),
                      injector=FaultInjector(plan), heartbeat=False)
    sess = pooled_lm_session(pool, SchedulerConfig(max_batch=4,
                                                   policy="reject"),
                             start=False)
    log = lm_log_buckets(sess)
    resolutions = {}
    futs = []
    for rid, (p, n) in enumerate(reqs):
        f = sess.submit(p, n_new=n)
        f.add_done_callback(lambda _f, rid=rid: resolutions.__setitem__(
            rid, resolutions.get(rid, 0) + 1))
        futs.append(f)
    for _ in range(200):
        if all(f.done() for f in futs):
            break
        sess.flush()
    check(all(f.done() for f in futs), "lm-session (c): a future is pending")
    check(sorted(resolutions) == list(range(len(reqs)))
          and set(resolutions.values()) == {1},
          "lm-session (c): a future did not resolve exactly once")
    failed = [rid for rid, f in enumerate(futs) if f.exception() is not None]
    pst = sess.stats()["pool"]
    touched = set(sess.touched_rids)
    sess.close()
    pool.close()
    alone = twin()
    bucket_of = {}
    for rids, prompts, n in log:
        for i in rids:
            bucket_of[i] = (rids, prompts, n)
    compared = 0
    for rid, f in enumerate(futs):
        if rid in touched or rid in failed:
            continue
        rids, prompts, n = bucket_of[rid]
        tok, stg = alone.generate(prompts, n)
        lo = sum(len(reqs[i][0]) for i in rids[:rids.index(rid)])
        hi = lo + len(reqs[rid][0])
        out = f.result()
        check(np.array_equal(out["tokens"], tok[lo:hi])
              and np.array_equal(out["stages"], stg[lo:hi]),
              f"lm-session (c): request {rid} differs from its bucket on "
              "one engine")
        compared += 1
    check(pst["deaths"] == 1, f"lm-session (c): deaths {pst['deaths']}")
    return {"requests": len(reqs), "death_at_step": at,
            "deaths": pst["deaths"], "retries": pst["retries"],
            "requeues": pst["requeues"], "failed": len(failed),
            "touched": len(touched), "untouched_compared": compared,
            "exactly_once": True}


def lm_session(params):
    """The weights lm-train trained behind the LM sessions: (a) the
    continuous session under an open-loop stream, held to the eager
    oracle; (b) the bucketed session against ``generate``; (c) the pooled
    session through an engine death."""
    from repro_torch.core.routing import DartParams
    from repro_torch.engine.lm import LMDecodeEngine

    t_start = time.perf_counter()
    data = lm_token_data()
    cfg = tinyllama()
    e = cfg.n_exits - 1
    eng = LMDecodeEngine(cfg, params, DartParams(
        tau=torch.full((e,), 2.0), coef=torch.ones(e), beta_diff=LM_BETA))
    rs = np.random.RandomState(LM_SESSION_SEED)
    reqs = lm_prompts(data, rs, LM_SESSION_REQUESTS, LM_TRAIN_DATA_VOCAB)
    cal = np.concatenate([p[:, :16] for _, p, _ in reqs[:16]])
    tau = lm_calibrate(eng, rs, prompts=cal)
    # an lm-serving drain of the same requests: the rate to offer
    dec = eng.continuous(n_slots=16, page_size=8, max_len=1024)
    _, steps, drain_s, _ = lm_drive(dec, reqs)
    del dec
    tokens = sum(n for _, _, n in reqs)
    drain_tps = tokens / drain_s
    rate = LM_SESSION_LOAD * drain_tps / (tokens / len(reqs))
    line, results, view_len, served = lm_session_stream(eng, reqs, rate)
    cmp = lm_decisions("lm-session (a)", reqs, results, lm_replay(
        eng, reqs, results, view_len, served, LM_SESSION_SLOTS), "bfloat16")
    del served
    emit(phase="lm-session", part="a", model=cfg.name, dtype="bfloat16",
         layers=cfg.n_layers, exits=list(cfg.exit_layers),
         weights="trained in the lm-train phase", tau=tau.tolist(),
         beta_diff=LM_BETA, n_slots=LM_SESSION_SLOTS, max_len=1024,
         load=LM_SESSION_LOAD,
         drain_tokens_per_s=drain_tps, drain_decode_steps=steps, **line,
         oracle_agreement=cmp, phase_s=time.perf_counter() - t_start)
    part_b = lm_buckets_against_generate(
        eng, lm_bucket_requests(data, rs, LM_TRAIN_DATA_VOCAB))
    emit(phase="lm-session", part="b", model=cfg.name, **part_b,
         phase_s=time.perf_counter() - t_start)
    part_c = lm_pooled(eng, lm_bucket_requests(data, rs,
                                               LM_TRAIN_DATA_VOCAB))
    emit(phase="lm-session", part="c", model=cfg.name, **part_c,
         phase_s=time.perf_counter() - t_start)
    del eng
    torch.cuda.empty_cache()
    return line["launches"]


def lm_internlm():
    """InternLM2-20B at its published width (d_model 6144, 48/8 heads,
    d_ff 16384, vocab 92544) and LM_INTERNLM_LAYERS of its 48 layers
    (bf16, seeded random weights drawn on the card) through
    ``ContinuousLMDecoder`` at 16 slots, max_len 512."""
    from repro_torch.configs import registry
    from repro_torch.convert import leaves
    from repro_torch.kernels import dispatch
    from repro_torch.models.transformer_lm import lm_param_count

    t_start = time.perf_counter()
    cfg = dataclasses.replace(registry.get("internlm2-20b"),
                              n_layers=LM_INTERNLM_LAYERS,
                              exit_layers=LM_INTERNLM_EXITS)
    torch.cuda.reset_peak_memory_stats()
    eng = lm_engine(cfg)
    n_params = sum(t.numel() for t in leaves(eng.params))
    check(n_params == lm_param_count(cfg) + cfg.n_exits * cfg.d_model,
          f"lm-internlm: {n_params} parameters")
    init_s = time.perf_counter() - t_start
    rs = np.random.RandomState(3)
    tau = lm_calibrate(eng, rs)
    reqs = lm_requests(rs, LM_INTERNLM_REQUESTS, cfg.vocab)
    held = reqs[:LM_INTERNLM_ORACLE]
    dec = eng.continuous(n_slots=16, page_size=8, max_len=512)
    served, undo = lm_capture(eng, dec, tags={t for t, _, _ in held})
    dispatch.reset_launch_counts()
    results, steps, secs, admit_s = lm_drive(dec, reqs)
    counts = lm_launches(eng, steps)
    undo()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = sum(n for _, _, n in reqs)
    stages = np.concatenate([results[t][1] for t, _, _ in reqs])
    profiled = lm_profile(eng, reqs, 16)
    cmp = lm_decisions("lm-internlm", held, results, lm_replay(
        eng, held, results, dec.view_len, served, dec.n_slots), "bfloat16")
    del served
    exit_counts = np.bincount(stages, minlength=eng.n_exits).tolist()
    layer_fraction = float(eng.cum_costs[stages].mean())
    n_slots, max_len, view_len = dec.n_slots, dec.max_len, dec.view_len
    del eng, dec
    torch.cuda.empty_cache()
    witness = lm_internlm_fp32(cfg, held)
    emit(phase="lm-internlm", model=cfg.name, dtype="bfloat16",
         params=n_params, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads], d_ff=cfg.d_ff,
         vocab=cfg.vocab, exits=list(cfg.exit_layers), tau=tau.tolist(),
         beta_diff=LM_BETA, n_slots=n_slots, max_len=max_len,
         requests=len(reqs), tokens=tokens, decode_steps=steps,
         seconds=secs, tokens_per_s=tokens / secs,
         decode_step_ms=1e3 * (secs - admit_s) / steps,
         admit_prefill_ms_per_request=1e3 * admit_s / len(reqs),
         exit_counts=exit_counts, mean_layer_fraction=layer_fraction,
         launches=counts, peak_memory_gb=peak_gb, init_s=init_s,
         view_len=view_len, profile=profiled, oracle_requests=len(held),
         oracle_agreement=cmp, fp32_witness=witness,
         phase_s=time.perf_counter() - t_start)
    return counts


def lm_internlm_fp32(cfg, held):
    """A witness beside lm-internlm's oracle check (which holds the
    served bf16 path itself): InternLM2-20B at full width
    in float32, cut to LM_INTERNLM_FP32_LAYERS layers (its exits at the
    same fractions of depth), the same requests through
    ``ContinuousLMDecoder`` against the eager oracle, checked as the
    other LM paths are."""
    cut = dataclasses.replace(
        cfg, n_layers=LM_INTERNLM_FP32_LAYERS,
        exit_layers=LM_INTERNLM_FP32_EXITS, param_dtype=torch.float32,
        compute_dtype=torch.float32)
    eng = lm_engine(cut)
    tau = lm_calibrate(eng, np.random.RandomState(4))
    dec = eng.continuous(n_slots=16, page_size=8, max_len=512)
    served, undo = lm_capture(eng, dec)
    results, steps, _, _ = lm_drive(dec, held)
    undo()
    cmp = lm_decisions("lm-internlm fp32 witness", held, results, lm_replay(
        eng, held, results, dec.view_len, served, dec.n_slots), "float32")
    del eng, dec, served
    torch.cuda.empty_cache()
    return {"layers": cut.n_layers, "exits": list(cut.exit_layers),
            "dtype": "float32", "tau": tau.tolist(), "decode_steps": steps,
            "oracle_agreement": cmp}


# ---------------------------------------------------------------------------
# phase 11: granite-moe-3b-a800m, the MoE FFN
# ---------------------------------------------------------------------------

def lm_step_replay(eng, dec, href, pref):
    """The step-replay oracle of a continuous decoder, for a MoE model:
    there a row's output depends on which rows share each MoE call (the
    capacity drops the later pairs of a busy expert), and the eager
    oracle of ``lm_replay`` routes the compacted survivors of each stage
    instead of the whole slot pool.  ``dec.step`` is wrapped: before
    each served step the pool's state is kept (pages, tokens, positions,
    active, fresh, page table, alpha and the engine state); after it,
    the same continuous step runs again from that state with the plain
    versions of ``exit_head`` and ``paged_gather`` (``href``, ``pref``)
    and the served step's fire pattern imposed at every stage, so that
    CALM propagation, and with it every row's routing, is the served
    one.  Every stage's hidden rows must equal the served ones bit for
    bit.  The plain head's own conf, pred and fire give the oracle's
    decision for each active row on the served context, with a
    ``lm_stage_records`` record at every stage.  Returns (replay
    {(tag, step): (token, stage, {stage: record})} as ``lm_replay``
    gives it; counts: steps, rows, steps with an idle slot below an
    active one, MoE pairs the replayed steps dropped; undo)."""
    from repro_torch.kernels import dispatch as KD
    from repro_torch.models import moe as MOE
    from repro_torch.models.transformer_lm import _unembed_table

    table = _unembed_table(eng.params, eng.cfg)
    table32 = table.float()
    dev = eng.device
    out = {}
    counts = {"steps": 0, "rows": 0, "idle_below_active": 0}
    dropped = torch.zeros((), dtype=torch.long, device=dev)
    served_step = dec.step
    served_head = eng._head_traced
    moe_apply = MOE.moe_apply

    def norm(name):
        return eng.params["final_norm"] if name == "final" \
            else eng.params["exit_heads"][name]["norm"]

    def counted_moe(p, x, cfg, **kw):
        ids = MOE._route(x.reshape(-1, x.shape[-1]), p["router"], cfg)[1]
        dropped.add_((~MOE.dispatch_plan(ids, cfg)["keep"]).sum())
        return moe_apply(p, x, cfg, **kw)

    def step():
        if not dec.active.any():
            return served_step()
        held = {}
        for slot, (rid, row) in dec._slot_req.items():
            if dec.active[slot]:
                rec = dec._requests[rid]
                held[slot] = (rec["tag"], len(rec["toks"][row]))
        host = {k: torch.as_tensor(getattr(dec, k).copy(), device=dev)
                for k in ("tokens", "fresh", "pos", "active", "page_table")}
        snap = ([{k: v.clone() for k, v in layer.items()}
                 for layer in dec.pages], dec.alpha.clone(), eng.state)
        served = []

        def capture(params, h, exit_name, eff):
            conf, pred, fire = served_head(params, h, exit_name, eff)
            served.append((h.clone(), fire.clone()))
            return conf, pred, fire

        eng._head_traced = capture
        try:
            events = served_step()
        finally:
            del eng._head_traced
        kept = (dec.pages, dec.alpha, eng.state)
        dec.pages, dec.alpha, eng.state = snap
        plain = []

        def replay(params, h, exit_name, eff):
            scale = norm(exit_name)["scale"]
            conf, pred, fire = href.ref_exit_head_gate(h, scale, table, eff)
            plain.append((h, plain_head_logits(h, scale, table), conf, pred,
                          fire, eff))
            return conf, pred, served[len(plain) - 1][1]

        eng._head_traced = replay
        gather = KD.paged_gather
        KD.paged_gather = pref.ref_paged_gather
        MOE.moe_apply = counted_moe
        try:
            x = dec._embed_step(host["tokens"].long(), host["fresh"])
            dec._decode_step(x, host["pos"], host["active"],
                             host["page_table"])
        finally:
            MOE.moe_apply = moe_apply
            KD.paged_gather = gather
            del eng._head_traced
            dec.pages, dec.alpha, eng.state = kept
        check(len(plain) == len(served) == eng.n_exits,
              "step replay: not one head call a stage")
        for s, ((h_s, _), (h_o, *_)) in enumerate(zip(served, plain)):
            check(torch.equal(h_s, h_o), f"step replay: stage {s}'s hidden "
                  "rows differ from the served step's")
        slots = sorted(held)
        idx = torch.as_tensor(slots, device=dev)
        recs, fires, preds = [], [], []
        for s, (h_o, logits, conf, pred, fire, eff) in enumerate(plain):
            recs.append(lm_stage_records(eng, table32, s, h_o[idx],
                                         logits[idx], conf[idx], eff[idx],
                                         served[s][0][idx]))
            fires.append(fire[idx].cpu().numpy() > 0)
            preds.append(pred[idx].cpu().numpy())
        last = eng.n_exits - 1
        for i, slot in enumerate(slots):
            own_s = next(s for s in range(eng.n_exits)
                         if s == last or fires[s][i])
            out[held[slot]] = (int(preds[own_s][i]), own_s,
                               {s: recs[s][i] for s in range(eng.n_exits)})
        counts["steps"] += 1
        counts["rows"] += len(slots)
        counts["idle_below_active"] += int(len(slots) < max(slots) + 1)
        return events

    def undo():
        dec.__dict__.pop("step", None)
        counts["moe_pairs_dropped"] = int(dropped)

    dec.step = step
    return out, counts, undo


def moe_capture(fn):
    """``fn()`` with the input rows of every ``moe_apply`` call recorded
    in call order (a layer's call follows the one before it).  Returns
    (fn's result, [(T, D) rows])."""
    from repro_torch.models import moe as MOE

    inner = MOE.moe_apply
    rows = []

    def traced(p, x, cfg, **kw):
        rows.append(x.reshape(-1, x.shape[-1]).clone())
        return inner(p, x, cfg, **kw)

    MOE.moe_apply = traced
    try:
        return fn(), rows
    finally:
        MOE.moe_apply = inner


def moe_card_check(eng, rows, layers, what):
    """The port's bf16 ``moe_apply`` on captured input rows of
    ``layers`` against a per-token reference built apart from it: top-k
    from the router in float64 on the host, the kept pairs from the
    capacity rule in numpy, and y_t = sum over t's kept pairs of p *
    W_down(silu(W_gate x) * W_up x) in float32 (TF32 off).  The kept
    sets must be equal; where a token's k-th and (k+1)-th router
    probabilities lie within twice the largest float32-vs-float64
    probability difference of the call, the reference takes the port's
    choice, and such tokens are counted.  Each token's output must be
    within ``tol`` of sum_j p_j max|y_j| (its scale): ``tol`` is the
    dense SwiGLU's measured error at this shape (expert 0's weights on
    the same rows, bf16 against float32, as a share of each row's
    largest) plus (k + 1) bf16 roundings (2^-8 each): the probability's
    cast, its product and the k - 1 adds of the combine."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE

    m = eng.cfg.moe
    k = m.top_k
    res = []
    for layer in layers:
        x = rows[layer]
        p = eng.params["layers"][layer]["moe"]
        t = x.shape[0]
        y, _ = MOE.moe_apply(p, x, m)
        _, ids, _ = MOE._route(x, p["router"], m)
        plan = MOE.dispatch_plan(ids, m)
        keep = plan["keep"].cpu().numpy()
        port_kept = {(int(a), int(b)) for a, b, c in zip(
            plan["s_tok"].cpu().numpy(), plan["s_eid"].cpu().numpy(), keep)
            if c}
        lg = x.double().cpu().numpy() @ p["router"].double().cpu().numpy()
        pr = np.exp(lg - lg.max(1, keepdims=True))
        pr /= pr.sum(1, keepdims=True)
        p32 = torch.softmax(x.float() @ p["router"].float(), -1).cpu().numpy()
        ptol = 2 * float(np.abs(p32 - pr).max())
        order = np.argsort(-pr, axis=1, kind="stable")
        srt = np.take_along_axis(pr, order, 1)
        near = srt[:, k - 1] - srt[:, k] <= ptol
        ids_ref = order[:, :k].copy()
        port_ids = ids.cpu().numpy()
        differ = [i for i in range(t)
                  if set(ids_ref[i]) != set(port_ids[i])]
        check(all(near[i] for i in differ),
              f"moe check {what} layer {layer}: top-k differs from float64 "
              f"outside near-ties at tokens {differ[:5]}")
        ids_ref[differ] = port_ids[differ]
        cap = MOE.capacity(t, m)
        load, kept = {}, set()
        for tok in range(t):
            for e in ids_ref[tok]:
                load[e] = load.get(e, 0) + 1
                if load[e] <= cap:
                    kept.add((tok, int(e)))
        check(kept == port_kept, f"moe check {what} layer {layer}: kept "
              f"pairs differ ({len(kept ^ port_kept)})")
        p_ref = np.take_along_axis(pr, ids_ref, 1)
        p_ref /= p_ref.sum(1, keepdims=True)
        y_ref = torch.zeros(t, x.shape[1], dtype=torch.float32,
                            device=x.device)
        scale = torch.zeros(t, dtype=torch.float32, device=x.device)
        for e in range(m.n_experts):
            pairs = [(tok, j) for tok in range(t) for j in range(k)
                     if ids_ref[tok, j] == e and (tok, e) in kept]
            if not pairs:
                continue
            toks = torch.as_tensor([a for a, _ in pairs], device=x.device)
            w = torch.as_tensor([p_ref[a, b] for a, b in pairs],
                                dtype=torch.float32, device=x.device)
            xe = x[toks].float()
            h = torch.nn.functional.silu(xe @ p["w_gate"][e].float()) \
                * (xe @ p["w_up"][e].float())
            ye = h @ p["w_down"][e].float()
            y_ref.index_add_(0, toks, w[:, None] * ye)
            scale.index_add_(0, toks, w * ye.abs().amax(-1))
        err = (y.float() - y_ref).abs().amax(-1)
        routed = scale > 0
        check(bool((err[~routed] == 0).all()), f"moe check {what} layer "
              f"{layer}: a token whose every pair was dropped is not 0")
        share = float((err[routed] / scale[routed]).max())
        dense = {n: {"w": p[f"w_{n}"][0]} for n in ("gate", "up", "down")}
        d32 = {n: {"w": v["w"].float()} for n, v in dense.items()}
        yd = L.swiglu(dense, x).float()
        yd32 = L.swiglu(d32, x.float())
        dense_share = float(((yd - yd32).abs().amax(-1)
                             / yd32.abs().amax(-1)).max())
        tol = dense_share + (k + 1) * 2.0 ** -8
        check(share <= tol, f"moe check {what} layer {layer}: {share} of "
              f"the scale > {tol}")
        res.append({"layer": layer, "tokens": t, "capacity": cap,
                    "pairs": t * k, "dropped": t * k - len(kept),
                    "near_ties": int(near.sum()),
                    "near_ties_taken_from_port": len(differ),
                    "prob_tol": ptol, "err_share": share,
                    "dense_err_share": dense_share, "tol": tol})
    return res


def lm_granite(href, pref):
    """granite-moe-3b-a800m at its published width and depth (32 layers,
    d_model 1536, 24/8 heads, 40 experts top-8 of d_ff 512, vocab 49155;
    bf16, seeded random weights drawn on the card) through
    ``ContinuousLMDecoder`` at 16 slots, page 8, max_len 512, requests
    admitted FIFO.  One run is held decision by decision to the
    step-replay oracle (``lm_step_replay``); a second, from a fresh
    pool, is timed and must decide the same; then the profile, and the
    independent MoE check (``moe_card_check``) on one served decode
    step's and one prefill's MoE inputs."""
    from repro_torch.configs import registry
    from repro_torch.convert import leaves
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer_lm as TLM

    t_start = time.perf_counter()
    cfg = registry.get("granite-moe-3b-a800m")
    torch.cuda.reset_peak_memory_stats()
    eng = lm_engine(cfg)
    n_params = sum(t.numel() for t in leaves(eng.params))
    check(n_params == TLM.lm_param_count(cfg) + cfg.n_exits * cfg.d_model,
          f"lm-granite: {n_params} parameters")
    init_s = time.perf_counter() - t_start
    rs = np.random.RandomState(6)
    tau = lm_calibrate(eng, rs)
    reqs = lm_requests(rs, LM_GRANITE_REQUESTS, cfg.vocab)
    pool = dict(n_slots=LM_GRANITE_SLOTS, page_size=8,
                max_len=LM_GRANITE_MAX_LEN)

    t_oracle = time.perf_counter()
    dec = eng.continuous(**pool)
    replay, rcounts, undo = lm_step_replay(eng, dec, href, pref)
    results, _, _, _ = lm_drive(dec, reqs)
    undo()
    cmp = lm_decisions("lm-granite", reqs, results, replay, "bfloat16")
    del replay, dec
    oracle_s = time.perf_counter() - t_oracle

    dec = eng.continuous(**pool)
    dispatch.reset_launch_counts()
    timed, steps, secs, admit_s = lm_drive(dec, reqs)
    counts = lm_launches(eng, steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.array_equal(timed[t][0], results[t][0])
              and np.array_equal(timed[t][1], results[t][1])
              for t, _, _ in reqs),
          "lm-granite: the timed run decided otherwise than the oracle's")
    tokens = sum(n for _, _, n in reqs)
    stages = np.concatenate([timed[t][1] for t, _, _ in reqs])
    view_len = dec.view_len
    del dec
    profiled = lm_profile(eng, reqs, LM_GRANITE_SLOTS,
                          max_len=LM_GRANITE_MAX_LEN)

    layers = (0, cfg.exit_layers[0], cfg.n_layers - 1)
    dec = eng.continuous(**pool)
    for tag, p, n in reqs[:LM_GRANITE_SLOTS]:
        dec.admit(p, n, tag=tag)
    _, step_rows = moe_capture(dec.step)
    del dec
    prompt = torch.as_tensor(
        np.random.RandomState(7).randint(0, cfg.vocab,
                                         (1, LM_GRANITE_PREFILL)),
        device="cuda")
    cache = TLM.lm_init_cache(cfg, 1, LM_GRANITE_PREFILL, device="cuda")
    _, prefill_rows = moe_capture(
        lambda: TLM.lm_prefill(eng.params, prompt, cfg, cache))
    check(len(step_rows) == len(prefill_rows) == cfg.n_layers,
          "lm-granite: not one MoE call a layer")
    moe = {"decode_step": moe_card_check(eng, step_rows, layers,
                                         "decode step"),
           "prefill": moe_card_check(eng, prefill_rows, layers, "prefill")}
    check(sum(r["dropped"] for r in moe["prefill"]) > 0,
          "lm-granite: the prefill dropped no MoE pair")
    del step_rows, prefill_rows, cache
    exit_counts = np.bincount(stages, minlength=eng.n_exits).tolist()
    layer_fraction = float(eng.cum_costs[stages].mean())
    emit(phase="lm-granite", model=cfg.name, dtype="bfloat16",
         nvidia_smi=nvidia_smi(), params=n_params,
         active_params_per_token=TLM.lm_active_param_count(cfg),
         layers=cfg.n_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads],
         experts=[cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff],
         vocab=cfg.vocab, exits=list(cfg.exit_layers), tau=tau.tolist(),
         beta_diff=LM_BETA, n_slots=LM_GRANITE_SLOTS,
         max_len=LM_GRANITE_MAX_LEN, view_len=view_len,
         requests=len(reqs), tokens=tokens, decode_steps=steps,
         seconds=secs, tokens_per_s=tokens / secs,
         decode_step_ms=1e3 * (secs - admit_s) / steps,
         admit_prefill_ms_per_request=1e3 * admit_s / len(reqs),
         exit_counts=exit_counts, mean_layer_fraction=layer_fraction,
         launches=counts,
         launches_per_step={k: v / steps for k, v in counts.items()},
         peak_memory_gb=peak_gb, init_s=init_s, profile=profiled,
         oracle=rcounts, oracle_s=oracle_s, oracle_agreement=cmp,
         moe_check=moe, phase_s=time.perf_counter() - t_start)
    del eng
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if os.environ.get("PYTHONHASHSEED") != "0":
        # the synthetic datasets seed each sample from hash((seed, split)),
        # a str hash: fix it so every run serves the same images
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.paper_testbeds import (ALEXNET_CIFAR,
                                                    LEVIT_256,
                                                    RESNET18_CIFAR,
                                                    VGG16_CIFAR)
    from repro_torch.core.difficulty import DEFAULT
    from repro_torch.data.datasets import CIFAR
    from repro_torch.engine import DartEngine
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.difficulty import kernel as dkern
    from repro_torch.kernels.difficulty import ref as dref
    from repro_torch.kernels.exit_gate import kernel as gkern
    from repro_torch.kernels.exit_gate import ref as gref
    from repro_torch.kernels.exit_head import kernel as hkern
    from repro_torch.kernels.exit_head import ref as href
    from repro_torch.kernels.paged_gather import kernel as pkern
    from repro_torch.kernels.paged_gather import ref as pref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         tf32_matmul=False, tf32_cudnn=False)

    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    emit(phase="build", seconds=time.perf_counter() - t0, library=str(lib))

    gen = torch.Generator(device="cuda").manual_seed(0)
    gate_err, gate_floor = check_exit_gate(gref, gkern, gen)
    softmax_err = check_softmax_confidence(gen)
    diff_err = check_difficulty(dref, dkern, gen, DEFAULT)
    head_err, head = check_exit_head(href, hkern, gen)
    paged = check_paged_gather(pref, pkern, gen)
    head_main, paged_main = head["main"], paged["main"]

    vgg, _ = drive_engine(VGG16_CIFAR, "vgg16-cifar", CIFAR, offset=2000)
    drive_engine(ALEXNET_CIFAR, "alexnet-cifar", CIFAR, offset=6000)
    _, resnet = drive_engine(RESNET18_CIFAR, "resnet18-cifar", CIFAR,
                             offset=7000, measure_costs=True)
    levit, _ = drive_engine(LEVIT_256, "levit-256", CIFAR, offset=11000,
                            measure_costs=True,
                            xla_cum_macs=LEVIT_XLA_CUM_MACS["levit-256"])
    torch.cuda.empty_cache()
    vision224 = dataclasses.replace(CIFAR, img_res=224)
    vision = drive_vision(vision224)
    torch.cuda.empty_cache()
    # train, then serve what was trained: the training step runs no
    # fused kernel; serving the trained ResNet-18 runs both of its own
    table1_cifar = dataclasses.replace(CIFAR, n_train=4096, n_eval=2048)
    dispatch.reset_launch_counts()
    trained = {name: drive_train(cfg, name, table1_cifar)
               for cfg, name in ((ALEXNET_CIFAR, "alexnet-cifar"),
                                 (VGG16_CIFAR, "vgg16-cifar"),
                                 (RESNET18_CIFAR, "resnet18-cifar"))}
    train_launches = dispatch.launch_counts()
    check(not any(train_launches.values()),
          f"train: fused kernels launched while training {train_launches}")
    resnet = DartEngine.from_config(RESNET18_CIFAR,
                                    trained["resnet18-cifar"])
    resnet.measure_costs((32, 32, 3))
    drive_policies(resnet, CIFAR,
                   weights=f"trained in the train phase "
                           f"({TRAIN_STEPS['resnet18-cifar']} steps)",
                   xla_cum_macs=RESNET18_XLA_CUM_MACS)
    serve_launches = dispatch.launch_counts()
    check(serve_launches["difficulty"] > 0
          and serve_launches["exit_gate"] > 0,
          f"policies: the trained engine's kernels never ran "
          f"{serve_launches}")
    emit(phase="train_then_serve_launches", train=train_launches,
         serve=serve_launches)
    # serve the trained ResNet-18 to single-image requests under
    # joint_dp's policy (installed by the policies phase)
    serving_launches = drive_serving(RESNET18_CIFAR,
                                     trained["resnet18-cifar"],
                                     resnet.state, resnet.cum_costs, CIFAR)
    # the same engine under injected faults, its state round-trip, and
    # the trainer's crash-resume
    resilience_launches, _ = drive_resilience(
        RESNET18_CIFAR, trained["resnet18-cifar"], resnet.state,
        resnet.cum_costs, CIFAR, table1_cifar)
    del resnet, trained
    torch.cuda.empty_cache()
    # Table II: the three LeViTs trained, then served (static, joint_dp)
    table2 = drive_table2(table1_cifar)
    torch.cuda.empty_cache()
    lm_strict()
    lm = lm_serving()
    # the LM trained, then served by the sessions; then InternLM2-20B,
    # once every TinyLlama engine is gone
    trained = lm_train()
    session_launches = lm_session(trained)
    del trained
    torch.cuda.empty_cache()
    internlm_launches = lm_internlm()
    granite_launches = lm_granite(href, pref)

    # main-path shapes: one 1024-row bucket, 10 classes / 32x32x3 images
    lg, th, _ = gate_inputs(1024, 10, gen, 10)
    img = torch.rand(1024, 32, 32, 3, device="cuda", generator=gen)
    kw = dict(tau_edge=DEFAULT.tau_edge, var_scale=DEFAULT.var_scale,
              grad_scale=DEFAULT.grad_scale, w1=DEFAULT.w_edge,
              w2=DEFAULT.w_variance, w3=DEFAULT.w_gradient)
    gate_b, gate_by = gate_bound(1024, 10, 4)
    gate_ms = time_ms(lambda: gkern.exit_gate_cuda(lg, th))
    diff_b, diff_by = difficulty_bound(1024, 32, 32, 3)
    diff_ms = time_ms(lambda: dkern.difficulty_cuda(img, **kw))
    # the vision phases' shapes: (1024, 1000) bf16 logits, 224-pixel images
    lg224, th224, _ = gate_inputs(1024, 1000, gen, 1000)
    lg224 = lg224.to(torch.bfloat16)
    img224 = torch.rand(1024, 224, 224, 3, device="cuda", generator=gen)
    gate224_b, gate224_by = gate_bound(1024, 1000, 2)
    diff224_b, diff224_by = difficulty_bound(1024, 224, 224, 3)
    gate224 = {
        "shape": [1024, 1000], "dtype": "bfloat16",
        "gate_route": gkern.plan(1024, 1000, torch.bfloat16)[0],
        "ms": time_ms(lambda: gkern.exit_gate_cuda(lg224, th224)),
        "plain_ms": time_ms(lambda: gref.ref_exit_gate(lg224, th224)),
        "library_ms": time_ms(
            lambda: torch.softmax(lg224.float(), -1).max(-1)),
        "bound_ms": gate224_b, "bound_by": gate224_by,
        "launches": vision["exit_gate"]}
    diff224 = {
        "shape": [1024, 224, 224, 3],
        "ms": time_ms(lambda: dkern.difficulty_cuda(img224, **kw)),
        "plain_ms": time_ms(lambda: dref.ref_components(img224, **kw)),
        "library_ms": None, "bound_ms": diff224_b, "bound_by": diff224_by,
        "launches": vision["difficulty"]}
    for row in (gate224, diff224):
        row["bound_fraction"] = row["bound_ms"] / row["ms"]
    summary = {"kernels": [
        {"name": "exit_gate", "route": "cuda",
         "source": "src/repro_torch/csrc/exit_gate.cu",
         "replaces": "src/repro/kernels/exit_gate/exit_gate_kernel.py:65",
         "launches": vgg["exit_gate"],
         "serving_launches": serving_launches["exit_gate"],
         "resilience_launches": resilience_launches["exit_gate"],
         "levit_engine_launches": levit["exit_gate"],
         "table2_launches": table2["exit_gate"],
         "max_abs_err": max(gate_err["conf"], gate_err["entropy"],
                            softmax_err),
         "ms": gate_ms,
         "plain_ms": time_ms(lambda: gref.ref_exit_gate(lg, th)),
         "bound_ms": gate_b, "bound_by": gate_by,
         "bound_fraction": gate_b / gate_ms,
         # (conf, pred) in one call; entropy and fire are not in it
         "library_ms": time_ms(lambda: torch.softmax(lg.float(), -1).max(-1)),
         # "route" is the contract's cuda / triton; the launcher's route
         "gate_route": gkern.plan(1024, 10, torch.float32)[0],
         # the gate as the engine calls it, behind a torch kernel
         "after_op_ms": after_op_ms(lambda: gkern.exit_gate_cuda(lg, th)),
         **gate_floor, "shape": [1024, 10], "vision224": gate224},
        {"name": "difficulty", "route": "cuda",
         "source": "src/repro_torch/csrc/difficulty.cu",
         "replaces": "src/repro/kernels/difficulty/difficulty_kernel.py:86",
         "launches": vgg["difficulty"], "max_abs_err": diff_err,
         "serving_launches": serving_launches["difficulty"],
         "resilience_launches": resilience_launches["difficulty"],
         "levit_engine_launches": levit["difficulty"],
         "table2_launches": table2["difficulty"],
         "ms": diff_ms,
         "plain_ms": time_ms(lambda: dref.ref_components(img, **kw)),
         "bound_ms": diff_b, "bound_by": diff_by,
         "bound_fraction": diff_b / diff_ms, "library_ms": None,
         "shape": [1024, 32, 32, 3], "vision224": diff224},
        {"name": "exit_head", "route": "cuda",
         "source": "src/repro_torch/csrc/exit_head.cu",
         "replaces": "src/repro/kernels/exit_head/exit_head_kernel.py:98",
         "launches": lm["launches"]["exit_head"], "max_abs_err": head_err,
         "lm_session_launches": session_launches["exit_head"],
         "internlm_launches": internlm_launches["exit_head"],
         "granite_launches": granite_launches["exit_head"],
         **{name: {k: head[name][k] for k in (
             "shape", "dtype", "ms", "plain_ms", "gemm_floor_ms",
             "bound_ms", "bound_by", "bound_fraction")}
            for name in ("internlm", "granite")},
         "ms": head_main["ms"],
         "plain_ms": head_main["plain_ms"],
         "bound_ms": head_main["bound_ms"],
         "bound_by": head_main["bound_by"],
         "bound_fraction": head_main["bound_fraction"], "library_ms": None,
         "gemm_floor_ms": head_main["gemm_floor_ms"],
         "fp32_fma_bound_ms": head_main["fp32_fma_bound_ms"],
         "shape": head_main["shape"], "dtype": head_main["dtype"]},
        {"name": "paged_gather", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_gather.cu",
         "replaces":
             "src/repro/kernels/paged_gather/paged_gather_kernel.py:50",
         "launches": lm["launches"]["paged_gather"], "max_abs_err": 0.0,
         "lm_session_launches": session_launches["paged_gather"],
         "internlm_launches": internlm_launches["paged_gather"],
         "granite_launches": granite_launches["paged_gather"],
         **{name: {k: paged[name][k] for k in (
             "shape", "table", "dtype", "ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by")} for name in ("internlm", "granite")},
         "ms": paged_main["ms"], "plain_ms": paged_main["plain_ms"],
         "bound_ms": paged_main["bound_ms"],
         "bound_by": paged_main["bound_by"],
         "library_ms": paged_main["library_ms"],
         "shape": paged_main["shape"], "table": paged_main["table"],
         "dtype": paged_main["dtype"]},
    ]}
    for k in summary["kernels"] + [gate224, diff224]:
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                "bound_ms")),
              "non-finite timing")
    check(vision["exit_gate"] > 0 and vision["difficulty"] > 0,
          f"the vision phases launched {vision}")
    print(nvidia_smi(), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
