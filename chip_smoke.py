#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit; imports nothing of JAX or of the JAX package.  Phases, each of
which fails the run (non-zero exit, no result line) if it fails:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all started together) and time the build;
3. hold each kernel against its plain torch version on the card, at the
   main paths' shapes and at ragged, short, batched and empty cases, in
   float32 and bfloat16 (flash attention 2e-4 and, on its 3xTF32 path,
   also 2e-5 x (1 + |o|), the limit under which 3xTF32 is kept there; SSD
   scan 3e-3 x (1 + |y|) and in float32 also 3e-4 x (1 + |y|), the limit
   under which its 3xTF32 products are kept, matmul 2e-4 x (1 + |c|),
   stencil 1e-5; bfloat16 2e-2), the copy bit for bit (also int32, and
   uint8 at the edges of its bulk ring's stages) into a fresh buffer;
   each matmul and flash case names the
   kernel path it took and checks that path's launch counter, and every
   path is taken (matmul: ``wgmma``, ``fma_pipelined``, ``general``;
   flash attention: ``wgmma``, ``tf32x3``, ``fma``; among its cases
   internvl2-76b's 64 query heads over 8 at the prefixed lengths 556 and
   1280, musicgen-large's at 364, and on every path stablelm-3b's head
   dim 80 and qwen2.5-14b's GQA group of 5, aligned and ragged, T > S,
   non-causal and off 16 bytes); flash attention's
   backward (dq, dk, dv) at the training shapes (granite-8b's, zamba2's,
   qwen3-moe's, stablelm-3b's D 80 and qwen2.5-14b's group 5) and at
   ragged, non-causal,
   short, GQA 1 / 4 / 5 / 8, D 80 and q-off-16-byte cases, each naming its path
   (``tf32x3`` for aligned float32, also held to ``FLASH_BWD_F32_KEEP``;
   ``wgmma`` for aligned bfloat16, also held to ``FLASH_BWD_BF16_KEEP`` as
   a whole; ``fma`` off a 16-byte boundary; each
   dtype takes its two), at the forward's tolerance
   x (1 + |g|), its counters checked; the SSD scan's backward (dx, da, db,
   dc) at zamba2's training shape, mLSTM's values and normalizer, ragged,
   short, batched, untiled and strong-decay cases at ``SSD_TOL`` x (1 +
   |g|) and in float32 also at ``SSD_BWD_F32_KEEP`` x (1 + |g|), reading
   the forward kernel's kept scratch, one count a call and no forward
   launched, and a second call, which runs the forward for its scratch,
   equal bit for bit; the sLSTM scan's forward (hs, the last carry, the
   kept carry) and backward (dgx, dr, the initial carry's gradient) at
   ``SLSTM_CASES`` (xlstm-125m's prefill, training and decode shapes, a
   ragged S, d off the warp's 32, a random carry) at ``TOL`` x (1 + |v|)
   and in float32 also at ``SLSTM_F32_KEEP`` x (1 + |v|) (the backward
   against its plain version in float64), one count a call each (d 33 and
   bfloat16 d 100 through the wrapper's zero padding to 16 bytes), and a
   second call's hs, carries and kept carry equal bit for bit; AdamW's
   update and gradient norm (``check_adamw``) in float32, bfloat16 with a
   float32 master copy and bfloat16 params with float32 gradients, on
   leaves of 1, 7, 4097 (off 16 bytes) and 2^24 + 3 elements: 2 steps bit
   for bit the eager update with the clip not binding, each leaf's update
   bit for bit on the same scalars with it binding, a second run bit for
   bit, the norm within 1e-6 of a float64 sum; the sLSTM forward with a
   padded prefill's lengths (``SLSTM_LENGTH_CASES``: length 1 and S at the
   prefill shape, a ragged batch, d 100) against its plain version with
   them;
4. time each kernel beside its plain version, the PyTorch library call
   for the same function (SDPA for attention, ``torch.matmul``,
   ``Tensor.clone``, ``F.conv2d`` with the stencil's cross; none computes
   the SSD scan) and its bound, at the paths' shapes (the stencil's bound
   row at [8, 4096, 4096], past the L2), the matmul and flash attention
   in both dtypes (flash also at stablelm-3b's heads of 80; bfloat16
   flash also at qwen3-moe's, moonshot's, internvl2-76b's, qwen2.5-14b's
   and nemotron-4-15b's heads), each row naming its path (float32 flash rows also time
   the FMA kernel on the same values off a 16-byte boundary and give its
   bound), flash attention's backward at the training shape on both
   float32 paths beside SDPA's backward (also at stablelm-3b's, D 80),
   and in bfloat16 on the ``wgmma``
   kernels a bfloat16 train step takes, at granite-8b's, qwen3-moe's,
   zamba2's, stablelm-3b's and qwen2.5-14b's training shapes, beside the
   ``fma`` kernels on the same values
   off a 16-byte boundary and SDPA's bfloat16 backward (both kernel paths
   held to the plain version there too), the
   SSD rows with the
   wrapper's time per call (host included) and the passes' scratch, the
   SSD backward at the training shapes (no library call computes it); the
   sLSTM scan at the prefill shape and, with its backward, at the training
   shape, each beside the plain loop (no library call computes it); AdamW
   (``time_adamw``) for each phase-8 configuration at its largest leaf
   (checked there bit for bit too) and over its whole tree, beside the
   eager update and, for scale only, ``torch._fused_adamw_`` over the same
   float32 leaves (another function: it decays before the step and keeps
   no master copy);
5. run the node path: the paper's node kernels as the payloads of a
   96-task ``mixed_dag`` (matmul 4096^3, copy [8192, 8192], 4 stencil
   sweeps of [1, 2048, 2048], float32) on the port's threaded runtime, on
   ``tpu_pod_slices(2, 2)`` under DAM-C with place 0 slowed 4x; every task
   commits, each kernel's launch count equals its tasks (the stencil's 4
   a task), every matmul takes the pipelined float32 kernel, the outputs
   of a type are equal and agree with the plain version;
6. serve, one after the other, full-width granite-8b, zamba2-1.2b and
   xlstm-125m in float32, then qwen3-moe-30b-a3b and moonshot-v1-16b-a3b
   in bfloat16 (30.1 B and 28.9 B parameters: an 80 GB card holds them
   only so), internvl2-76b in bfloat16 at full width cut to 32 of its 80
   layers (29.48 B parameters, 58.96 GB; all 80 take 141 GB),
   musicgen-large in float32 at full width and depth, stablelm-3b in
   float32 (2.80 B, head dim 80) and qwen2.5-14b (14.77 B, QKV bias, GQA
   group 5) and nemotron-4-15b (15.63 B, squared ReLU) in bfloat16, all
   at full width and depth, each on its text
   path (the engine takes no frontend, as the reference's), random
   weights from a seed, through the port's
   PTT-scheduled ``ServingEngine``: 8 requests of 256-1024 prompt tokens
   (one ragged) and 16 new tokens each, on the same places and scheduler;
   the launch counts are set to 0 just before
   each model's run and read just after, and must equal the counts that
   the model's ``layer_plan`` gives per prefill (flash attention once per
   attention or MoE block or shared-block application, the SSD scan once
   per Mamba-2 layer and twice per mLSTM layer, the sLSTM scan once per
   sLSTM layer) times the prefills, plus the sLSTM scan once per sLSTM
   layer a decode step, and
   every flash launch takes its dtype's path (float32 ``tf32x3``,
   bfloat16 ``wgmma``); every decode step is a replay of a CUDA graph
   captured by the engine (one a worker thread, 4, captured before the
   run), the replays equal to the decode steps, each adding the launches
   its graph holds; every prefill is a replay of the graph of its length
   bucket (one a bucket up to ``max_len`` 1,040: 16, 32, ..., 1024, 1040,
   captured before the run, each bucket's capture seconds and pool
   printed), the replays equal to the prefills, into buckets 256, 512 and
   1024;
7. check what came out, for each model: every request finished with its
   tokens; for the prompts of 300 (ragged, bucket 512) and 1024 tokens a
   prefill through the engine's bucket (a replay) equals the eager padded
   prefill on the graph's capture stream, logits and every state leaf bit
   for bit, and the engine's first token is its argmax; the eager padded
   prefill agrees with the unpadded one (float32: logits, the caches' rows
   before S and the recurrent states under rel 5e-3; bfloat16: the logits
   at the model's served limit, and in float32 at the cut depth below
   under 5e-3 at the served capacity factor; the rows from S on zero and
   the caches' length S); one prefill of 256, 512 and 1024 tokens, eager
   and graphed, timed (host, wall and card ms); prefill +
   decode agrees with a full forward at full width (an MoE model at
   capacity factor 16, where a forward drops no token that a one-token
   decode keeps); the reduced model on the card agrees with the CPU path
   in float32 (rel 5e-3, the model tolerance of the tests, greedy tokens
   equal) and, for a bfloat16 model, also in bfloat16; an MoE model's
   prefill + decode also agrees with its forward at full width and
   ``MOE_CHECK_LAYERS`` layers in float32 (rel 5e-3, every step), where a
   decode fault shows that 48 layers of bfloat16 drift would hide, and so
   does each bfloat16 dense model's at ``DENSE_CHECK_LAYERS`` layers
   (internvl2-76b's after its prefix); stablelm-3b's and qwen2.5-14b's
   reduced models also at their own head layouts (``REAL_HEADS``: head dim
   80; 10 heads over 2), card against CPU in float32.  For the vlm and audio models, with their
   frontend prefix (N(0, 1), internvl2 256 positions, musicgen 64):
   ``make_prefill_step`` + 16 decode steps against ``forward`` at full
   width (float32 rel 5e-3, bfloat16 on the median), ``make_forward_step``
   against ``forward``, a prefix of zeros changes the logits, and the
   reduced models' card-against-CPU checks take a prefix of 16.
   bfloat16 logits are held on the median over tokens of each token's
   rel, at ``BF16_FULL_TOL`` (48 layers; ``DENSE_BF16_FULL_TOL`` of the
   arch for the dense models, ``tools/dense_bf16_drift.py``) or
   ``BF16_REDUCED_TOL`` (4), grounded in the reference's own drift
   (``tools/moe_bf16_drift.py``):
   a routing flip moves one token's logits by 0.2-0.9 in the reference
   itself, and its drift grows with depth.
   For xlstm-125m it also times one 1024-token prefill and its sLSTM blocks
   inside it.  For every model, 16 greedy steps from one prefill through
   the engine's decode graph equal, logits and tokens bit for bit, the
   eager step's on the stream the graph was captured on (the eager step
   on the default stream is compared and its difference reported); and
   one decode step's host and card time (``torch.profiler``), eager and
   graphed (its state copies timed alone), for a model of attention blocks
   against the bytes of the weights it must read;
8. train, one model after the other (``TRAIN_RUNS``): granite-8b at full
   width cut to 1 layer (0.62 B parameters, B 2 x S 2048), zamba2-1.2b
   at full width cut to 6 of 38 layers (0.35 B, B 2 x S 2048) and
   xlstm-125m at full width and depth (B 2 x S 2048), in float32; then in
   bfloat16 (bfloat16 params, a float32 master copy and moments)
   qwen3-moe-30b-a3b at full width cut to 1 of 48 layers (1.24 B
   parameters, capacity factor 1.25), granite-8b and zamba2-1.2b as in
   float32, xlstm-125m whole, stablelm-3b at full width and depth (2.80 B, the ``wgmma``
   backward at D 80) and qwen2.5-14b at full width cut to 4 of 48 layers
   (2.66 B: the QKV bias's gradients, the backward at GQA group 5).
   Each: the reduced model on the card against the CPU path in float32
   (loss rel 1e-5, gradient leaves at 1e-4, the hybrid's at 3e-3, of each
   leaf's largest; 3 AdamW steps' losses rel 1e-4; stablelm-3b's and
   qwen2.5-14b's also at their own heads, ``REAL_HEADS``), and for a bfloat16
   run also in bfloat16 against the CPU's float32 run of the same weights
   under the rule (``bf16_grad_limits``: the loss, the worst gradient leaf
   but zamba2's, 3 AdamW steps' losses); an MoE model's backward at the
   training shape repeats bit for bit under the deterministic mode
   (``moe_bwd_determinism``); then the eager ``make_train_step``, 8
   steps from the run's init and batches (``eager_steps``: each timed, the
   state's ``_fingerprint`` after each of steps 1-4), freed; then through
   the port's ``Trainer``, whose step is a captured CUDA graph
   (``TrainStepGraph``: step 1 eager on the graph's stream, then the
   capture, steps 2-8 replays): 8 steps straight through with a
   checkpoint at step 4, every loss and the state after each of steps 1-4
   the eager run's bit for bit (so the capture left the state as it
   was), the graph's capture seconds and pool; a
   fresh trainer that restores it (its state, a bfloat16 run's float32
   master copy with it, equal to the straight run's at step 4) and takes
   steps 5-8 with the same losses and state bit for bit, graph against
   graph, one more
   gradient with and without remat (the same loss and gradient norm);
   every loss finite, the first near a random init's ln V + 1/2, the last
   below the first; per step the launches the layer plan gives (flash
   forward and backward once per attention block or shared-block
   application, on the dtype's paths: float32 ``tf32x3`` both ways,
   bfloat16 ``wgmma`` both ways; the SSD forward and
   backward once per Mamba-2 layer and twice per mLSTM layer, so no
   backward runs the forward again; the sLSTM scan forward and backward
   once per sLSTM layer; remat runs
   every stacked layer's forward twice; the AdamW kernels' update once a
   leaf and the norm's pass once a leaf and its finalize once); the step
   time, tokens per second, peak memory, the checkpoint's write and
   restore seconds, the graphed and the eager step's times (medians of
   steps 2-8) and, from one traced step run as ``split_step``
   composes it, the share of the card time of the flash, SSD and sLSTM
   kernels, forward and backward, and the card time of the gradient's and
   the update's ranges by class of kernel (the update's in the AdamW
   kernels).  zamba2-1.2b in bfloat16 also takes 4 steps with the AdamW
   kernels and, re-initialised each time, the same 4 with the eager leaf
   update on the kernels' norm and with the eager update whole
   (``update_vs_plain``): the first two's losses equal bit for bit, the
   third's within the bfloat16 rule's step-loss limit (its float32 norm
   moves the clip factor's last bits).
   Then (``TRAIN_PREFIXED``) musicgen-large at full width and depth with
   its frontend prefix, in float32 and then in bfloat16 (a float32 master
   copy and moments; its reduced model also under the bfloat16 rule),
   B 2 x (P 64 + 1984 text tokens) as
   ``train_batch_specs`` lays them out, and (``TRAIN_DIRECT``, B 2 x S
   2048, bfloat16) moonshot-v1-16b-a3b at full width cut to 4 of 48
   layers (3.02 B; its ``moe_bwd_determinism`` too) and nemotron-4-15b at
   full width cut to 1 of 32 layers (3.54 B, 3.15 B of them its untied
   256,000-row embeddings), each through a ``TrainStepGraph`` outside the
   ``Trainer`` (its stream emits no frontend, in the reference too; its
   checkpoint costs ~35 s a billion parameters) (``train_direct``): its
   reduced model card against CPU (with a prefix; under the bfloat16 rule),
   the eager steps as above, freed, then 8 graphed steps from the same
   init held to them bit for bit (losses finite, the first near ln V +
   1/2, the last below the first; musicgen's 48 flash forward and 48
   backward launches a step, all ``tf32x3`` in float32 and ``wgmma`` in
   bfloat16), the peak memory, the graph's pool, the graphed and eager
   step times, tokens per second and one traced step;
9. dry-run and placement: (a) the port's dry-run (``launch/dryrun.py``)
   of every arch x shape at full width and depth, its step run as
   DTensors (meta shards) on both production meshes over a fake process
   group, all 80 cells, one process an arch, all started together on the
   host right after phase 2 (they run beside phases 3 and 4, whose kernel
   times are the card's, and are collected before phase 5); no
   cell may fail, every OK cell carries its observed and derived
   collectives, every ``train_4k`` cell a gradient reduction over the data
   axes; per cell the per-device flops, bytes and peak, their ratio to the
   even split, the observed and derived collective totals and the dominant
   roofline term are printed, and the count of cells each term dominates;
   (b) its host-mesh cell of
   granite-8b x 8 (B 2 x S 2048, remat), in float32 and in bfloat16 (a
   float32 master copy and moments), as DTensors on the card's (1, 1)
   CUDA mesh, against the same step on the card, plain and then as
   DTensors on that mesh (the flash and AdamW kernels through their
   sharding rules): the same loss bit for bit and the same launches, the
   predicted argument bytes within 1e-6 of what the card allocates for
   them, the predicted peak's ratio to the measured one within 1e-4 of 1,
   the counted flops beside 6 N tokens; (c) the node DAG once more under DAM-C with a
   queue penalty and ``placement_backend="torch"`` (the score on the
   card), held to phase 5's checks, its score calls counted and timed,
   and 10,000 seeded draws scored on the card held to numpy (1 float32
   ulp of its float32 evaluation, 2 of its float64, the same argmin);
10. the twins of ``examples/`` (``repro_torch/examples``) on the card,
   each with the launch counts set to 0 just before it and read just
   after: the quickstart (reduced qwen2.5-14b, 20 steps, a greedy
   generation; losses finite, the last below the first; flash forward and
   backward launches as the layer plan gives them, its step with remat, a
   ``TrainStepGraph`` whose losses and trained params are the eager
   ``make_train_step``'s bit for bit;
   each generated token's logits finite, not constant, and against a
   forward at the next position under rel 5e-3),
   serve_lm (reduced
   stablelm-3b under RWS and DAM-P, place 0 slowed 4x; 10 of 10 requests
   each; one flash launch per attention block a prefill) and train_lm at
   full-width xlstm-125m with its own seq 256 x batch 4, cut to
   ``TRAIN_LM_STEPS`` of its 300 steps: the resumed steps' losses equal an
   uninterrupted run's bit for bit, the SSD and sLSTM forward and backward
   launches are the plan's, and the step time is printed beside the card's name and
   power limit.

Prints ``{"kernels": [...]}`` (the matmul's and flash attention's rows
carry their bfloat16 numbers under ``"bfloat16"``; the backwards' and
AdamW's launches are phases 8 and 10's; AdamW's row times the whole tree
of stablelm-3b in bfloat16, the largest, every configuration under
``by_config``), then the
``nvidia-smi`` line, then, last,
``{"ok": true, "device": {...}}``.  The details (every case's error, every
timing shape, the compiler's register report) go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the kernels' work from their shapes and the H100's dense peaks: one copy,
# which the kernels' meta path (the dry-run) reads too
from repro_torch.kernels.work import (H100_BYTES_PER_S, attention_bwd_work,  # noqa: E402
                                      attention_work, bound, slstm_bwd_work,
                                      slstm_work, ssd_bwd_work, ssd_work)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SSD_TOL = {"float32": 3e-3, "bfloat16": 2e-2}
SSD_F32_KEEP = 3e-4    # the SSD kernel's 3xTF32 stays only this far inside
FLASH_F32_KEEP = 2e-5  # flash attention's 3xTF32 path stays only this far
# ... and its backward's: ~4x the FMA kernel's worst, 1.05e-5 x (1 + |g|),
# which a single TF32 product would exceed
FLASH_BWD_F32_KEEP = 4e-5
# The bfloat16 backward on wgmma, each of dq, dk and dv as a whole beside
# the elementwise TOL: ||g - plain|| / ||plain|| at most about twice its
# worst over FLASH_BWD_CASES (2.72e-3; SDPA's own bfloat16 backward reads
# up to 3.4e-3 on the same inputs; PERF.md row 1d), where P and dS rounded
# to bfloat16 and the output's own rounding each move a term by up to 2^-9
FLASH_BWD_BF16_KEEP = 5.5e-3
# The SSD backward's 3xTF32 stays only this far inside, x (1 + |g|), per
# gradient: ~4x the worst of the FMA kernel it replaced over
# SSD_BWD_CASES (dx 1.47e-4, db 2.64e-4, dc 2.12e-4); da, whose per-token
# sums cancel (1.22e-3 at the strong decays), ~2x, inside SSD_TOL
SSD_BWD_F32_KEEP = {"dx": 6e-4, "da": 2.5e-3, "db": 1.1e-3, "dc": 8.5e-4}
# The SSD kernels in bfloat16, each output as a whole beside the elementwise
# SSD_TOL: ||g - plain|| / ||plain|| at about twice the worst of the
# kernels before their bfloat16 redesign over SSD_CASES, SSD_BWD_CASES and
# the card tests' SSD cases (y 5.63e-5; dx 1.39e-4, da 2.32e-4, db
# 1.29e-4, dc 1.38e-4, the largest at the tests' short S = 37, where one
# flipped bfloat16 rounding weighs most; tools/torch_ssd_ab.py --errors,
# PERF.md rows 2e-2f).  Both versions round float32 values to bfloat16
# alike, so these count the elements whose float32 values straddle a
# rounding boundary; an error of a few ulps on a whole tile or on every
# element, inside SSD_TOL, exceeds them.
SSD_BF16_KEEP = {"y": 1.2e-4, "dx": 2.8e-4, "da": 4.6e-4, "db": 2.6e-4,
                 "dc": 2.8e-4}
# The sLSTM kernels stay this far inside, x (1 + |v|), in float32, set
# from the first sLSTM kernels over SLSTM_CASES before their redesign:
# the forward 4x its worst against the float32 plain loop (1.12e-5, the
# kept carry); the backward about its worst against the plain backward,
# which computes in float64 since the redesign (dgx 1.1e-4 at the
# training shape; its dr, 4.9e-4, failed TOL there, as the float32
# plain's own did, both summing the reverse chain's rounding into dr
# alike).  That rounding put dr at up to 1.53e-4 over seeds 0-15 at the
# training shape (tools/torch_slstm_ab.py --seeds); the chain sums its
# long-lived carries compensated since (slstm::carry_sum), and the limit
# stayed where it was.
SLSTM_F32_KEEP = {"fwd": 4.5e-5, "bwd": 1.2e-4}
# the unit whose peak prices each flash path's products in its bound
FLASH_UNIT = {"wgmma": "bfloat16", "tf32x3": "3xtf32", "fma": "float32"}

DEVICE = "cuda"
# (arch, dtype) served in phase 6, one after another
SERVED = (("granite-8b", "float32"), ("zamba2-1.2b", "float32"),
          ("xlstm-125m", "float32"), ("qwen3-moe-30b-a3b", "bfloat16"),
          ("moonshot-v1-16b-a3b", "bfloat16"), ("internvl2-76b", "bfloat16"),
          ("musicgen-large", "float32"), ("stablelm-3b", "float32"),
          ("qwen2.5-14b", "bfloat16"), ("nemotron-4-15b", "bfloat16"))
# the served models cut in depth: internvl2-76b at full width is 76 B
# parameters (141 GB in bfloat16 at 80 layers); 32 of its layers are
# 29.48 B, 58.96 GB
SERVED_LAYERS = {"internvl2-76b": 32}
# the flash path every served launch of a dtype takes
SERVED_FLASH_PATH = {"float32": "tf32x3", "bfloat16": "wgmma"}
# the served head layouts (Hq, Hkv, D) by dtype: granite-8b, zamba2's
# shared attention (and musicgen-large's) and stablelm-3b (D 80) in
# float32, qwen3-moe, moonshot, internvl2-76b, qwen2.5-14b (GQA group 5)
# and nemotron-4-15b in bfloat16
SERVED_LAYOUTS = {"float32": {(32, 8, 128), (32, 32, 64), (32, 32, 80)},
                  "bfloat16": {(32, 4, 64), (16, 16, 128), (64, 8, 128),
                               (40, 8, 128), (48, 8, 128)}}
# bfloat16 logits are held on the median over tokens of each token's rel
# (a routing flip moves one token's logits by 0.2-0.9 in the reference
# itself); tools/moe_bf16_drift.py measures the reference on the CPU.
# The reduced models, card against CPU: twice the reference's largest
# median drift from its float32 run at their 4 layers (0.051, 16 runs).
# The prefixed dense plan (internvl2-76b) drifts less in the reference
# (tools/dense_bf16_drift.py, reduced width, a prefix of 16, 8 seeds):
# 0.0117-0.0139 at 4 layers, twice that 0.028, inside this limit.
BF16_REDUCED_TOL = 0.1
# The served 48-layer models' prefill + decode against their forward: the
# reference's largest median drift on that same comparison at 48 layers
# (0.017-0.194 over 8 runs, 4 seeds each; 0.004-0.008 at 4 layers).
# internvl2-76b's at its served 32 layers with a prefix of 256 and 16
# decode steps: 0.019-0.025 over 8 seeds (tools/dense_bf16_drift.py).
BF16_FULL_TOL = 0.2
# ... and a dense model's, which no routing flip moves, by arch: twice the
# reference's largest median on the same comparison at the served depth,
# 8 seeds, 16 decode steps (tools/dense_bf16_drift.jsonl, reduced width):
# internvl2-76b at 32 layers, P 256 (0.0253) or no prefix (0.0181);
# qwen2.5-14b at 48 (0.0221) and nemotron-4-15b at 32 (0.0183), no prefix;
# each decode path's structure is held in float32 at DENSE_CHECK_LAYERS,
# where a fault shows.
DENSE_BF16_FULL_TOL = {"internvl2-76b": 0.05, "qwen2.5-14b": 0.0443,
                       "nemotron-4-15b": 0.0366}
# bfloat16 training is held to the exact function, the float32 run of the
# same weights and batch: a bfloat16 loss, its gradients (each leaf's largest
# error over its largest magnitude, worst leaf) and 3 AdamW steps' losses
# within twice the reference's own largest bfloat16-vs-float32 drift over 8
# seeds, per arch (tools/bf16_grad_drift.py: reduced models, B 2 x S 48; its
# output is BF16_GRAD_DRIFT).  zamba2-1.2b is held on its loss and step
# losses only: its reduced bfloat16 gradients carry no signal in either
# package (the reference's own drift reaches several times a leaf's largest).
BF16_GRAD_DRIFT = ROOT / "tools" / "bf16_grad_drift.jsonl"
BF16_LOSS_ONLY = ("zamba2-1.2b",)
# ... on these inputs: the batch at numpy seed 4 + seed (bf16_drift_batch),
# then 3 AdamW steps with this optimizer on the batches of these seeds
BF16_STEP_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10,
                     weight_decay=0.1)
BF16_STEP_SEEDS = (10, 11, 12)


def bf16_drift_batch(cfg, seed: int, mask: bool = True, b: int = 2,
                     s: int = 48) -> dict:
    """The numpy batch the rule is grounded on: ``tests/test_torch_train.py``'s
    ``_batch`` at numpy seed ``seed`` (tokens, labels, a loss mask), and for
    a prefixed model a frontend [b, P, d] drawn N(0, 1) after it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["loss_mask"] = (rng.random((b, s)) > 0.2).astype(np.float32)
    if cfg.frontend_len:
        out["frontend"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def bf16_grad_limits(rows=None) -> dict:
    """``{arch: {"loss", "grad", "steps"}}``, each twice the largest over
    the seeds of the reference's bfloat16 run against its float32 run
    (``grad`` None for the archs of ``BF16_LOSS_ONLY``), from ``rows`` of
    ``tools/bf16_grad_drift.py`` (default: those of ``BF16_GRAD_DRIFT``)."""
    if rows is None:
        rows = [json.loads(line) for line in
                BF16_GRAD_DRIFT.read_text().splitlines() if line.strip()]
    limits: dict = {}
    for row in (r for r in rows if "arch" in r):
        ref = row["ref_bf16_vs_f32"]
        lim = limits.setdefault(row["arch"], {"loss": 0.0, "grad": 0.0,
                                              "steps": 0.0})
        lim["loss"] = max(lim["loss"], 2 * ref["loss"])
        lim["grad"] = max(lim["grad"], 2 * ref["grad"])
        lim["steps"] = max(lim["steps"], 2 * row["steps"]["ref_bf16_vs_f32"])
    for arch in BF16_LOSS_ONLY:
        if arch in limits:
            limits[arch]["grad"] = None
    return limits


# The head layouts that reduced() hides (4 heads of 32 for every arch) and
# the card runs at full width: stablelm-3b's head dim 80 (the flash
# kernels' D = 80 instantiations) and qwen2.5-14b's GQA group of 5 with its
# QKV bias.  The reduced models' card-against-CPU checks run them too, and
# the CPU tests hold them to the JAX package.
REAL_HEADS = {"stablelm-3b": {"head_dim": 80},
              "qwen2.5-14b": {"n_heads": 10, "n_kv_heads": 2}}


def real_heads(cfg):
    """``cfg``'s reduced config at the arch's own head layout
    (``REAL_HEADS``), or None for an arch whose layout reduced() keeps."""
    import dataclasses
    over = REAL_HEADS.get(cfg.name)
    return dataclasses.replace(cfg.reduced(), **over) if over else None


MOE_CHECK_CAPACITY = 16.0  # prefill + decode against forward, MoE models
MOE_CHECK_LAYERS = 6       # ... and at full width in float32 at this depth
DENSE_CHECK_LAYERS = 4     # the same for a bfloat16 dense model (internvl2)
PROMPT_LENS = (256, 1024, 300, 512, 768, 640, 384, 896)   # 300 is ragged
NEW_TOKENS = 16
SLOW_PLACE = {0: 4.0}


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def _require(cond, what) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


RUN_AHEAD_CYCLES = 50_000_000   # ~25 ms of a spin kernel at ~2 GHz


def _time_ms(fn, iters: int, warmup: int = 2, run_ahead: bool = True) -> float:
    """Card time per call of ``fn``, from CUDA events around ``iters``
    calls.  With ``run_ahead`` a spin kernel first holds the stream, so the
    host queues the calls (and the start event) while it runs and the
    events time the card's work alone, not the host's time to launch it;
    without, the time per call is the larger of the two.  The plain
    versions, whose host time exceeds the spin, are timed without."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if run_ahead:
        torch.cuda._sleep(RUN_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _qkv(b, hq, hkv, s, t, d, dtype, seed):
    import torch
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    return [torch.randn(shape, generator=g, device=DEVICE).to(dtype)
            for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d))]


def _off16(x):
    """A contiguous copy of ``x`` that starts off a 16-byte boundary."""
    import torch
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    flat.copy_(x.reshape(-1))
    return flat.view(x.shape)


def check_flash(report: dict) -> dict:
    """Kernels against their plain version on the card, each case naming
    the path it took (aligned float32: the 3xTF32 kernel, held also to
    ``FLASH_F32_KEEP``; aligned bfloat16: the wgmma one; a q off a 16-byte
    boundary, in either dtype: the FMA kernel) and checking that path's
    counter.  Returns the largest error in each dtype at the head layouts
    served in it (``SERVED_LAYOUTS``)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     flash_path, path_launches)
    cases = [  # (b, hq, hkv, s, t, d, causal, q off a 16-byte boundary)
        (1, 32, 8, 128, 128, 128, True),
        (1, 32, 8, 512, 512, 128, True),
        (1, 32, 8, 2048, 2048, 128, True),
        (1, 32, 8, 300, 300, 128, True),        # ragged S = T
        (1, 32, 8, 256, 768, 128, True),        # T > S
        (1, 32, 8, 300, 300, 128, False),
        (2, 8, 2, 200, 200, 32, True),          # D = 32 (the reduced model)
        (1, 16, 4, 384, 384, 64, True),         # D = 64
        (1, 32, 32, 1024, 1024, 64, True),      # zamba2's shared attention
        (1, 32, 32, 300, 300, 64, True),        # the same, ragged
        (1, 32, 4, 1024, 1024, 64, True),       # qwen3-moe: GQA group 8
        (1, 32, 4, 300, 300, 64, True),         # the same, ragged
        (1, 32, 4, 1024, 1024, 128, True),      # group 8 at D 128: no model's
        (1, 16, 16, 1024, 1024, 128, True),     # moonshot
        (1, 16, 16, 300, 300, 128, True),       # the same, ragged
        (1, 64, 8, 1280, 1280, 128, True),      # internvl2: P 256 + 1024
        (1, 64, 8, 556, 556, 128, True),        # the same, P 256 + 300
        (1, 32, 32, 364, 364, 64, True),        # musicgen: P 64 + 300
        (2, 32, 32, 2048, 2048, 64, True),      # musicgen's training shape
        (1, 8, 2, 40, 40, 32, True),            # S < 64, one ragged tile
        (1, 16, 4, 200, 200, 64, True, True),   # the FMA kernel
        # stablelm-3b's head dim 80 (32 heads over 32), qwen2.5-14b's GQA
        # group of 5 (40 over 8) and nemotron-4-15b's 48 over 8: aligned
        # and ragged, T > S, non-causal, S < 64, and off 16 bytes (FMA)
        (1, 32, 32, 1024, 1024, 80, True),      # stablelm-3b's prefill
        (1, 32, 32, 300, 300, 80, True),        # the same, ragged
        (1, 32, 32, 256, 768, 80, True),        # D 80, T > S
        (1, 32, 32, 300, 300, 80, False),       # D 80, non-causal
        (1, 8, 8, 40, 40, 80, True),            # D 80, S < 64
        (1, 32, 32, 300, 300, 80, True, True),  # D 80 on the FMA kernel
        (1, 40, 8, 1024, 1024, 128, True),      # qwen2.5-14b: group 5
        (1, 40, 8, 300, 300, 128, True),        # the same, ragged
        (1, 40, 8, 256, 768, 128, True),        # group 5, T > S
        (1, 40, 8, 300, 300, 128, False),       # group 5, non-causal
        (1, 10, 2, 300, 300, 80, True),         # group 5 at D 80
        (1, 40, 8, 300, 300, 128, True, True),  # group 5 on the FMA kernel
        (1, 48, 8, 1024, 1024, 128, True),      # nemotron-4-15b: group 6
        (2, 32, 32, 2048, 2048, 80, True),      # stablelm-3b's training
    ]
    worst_main = {"float32": 0.0, "bfloat16": 0.0}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, (b, hq, hkv, s, t, d, causal, *off) in enumerate(cases):
            q, k, v = _qkv(b, hq, hkv, s, t, d, dtype, seed=i)
            if off:
                q = _off16(q)
            path = flash_path(q, k, v)
            before = path_launches[path].count
            got = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = flash_attention_plain(q, k, v, causal=causal)
            err = (got.float() - want.float()).abs()
            limit = TOL[name] * (1.0 + want.float().abs())
            rel = float((err / (1.0 + want.float().abs())).max())
            ok = (bool((err <= limit).all()) and bool(torch.isfinite(got).all())
                  and path_launches[path].count == before + 1
                  and (path != "tf32x3" or rel <= FLASH_F32_KEEP))
            row = {"dtype": name, "path": path, "shape": [b, hq, hkv, s, t, d],
                   "causal": causal, "max_abs_err": float(err.max()),
                   "max_rel_err": rel, "tol": TOL[name], "ok": ok}
            rows.append(row)
            print(f"[check] flash_attention {row}", flush=True)
            _require(ok, f"flash attention kernel against its plain "
                         f"version: {row}")
            if (hq, hkv, d) in SERVED_LAYOUTS[name]:
                worst_main[name] = max(worst_main[name], row["max_abs_err"])
    _require({r["path"] for r in rows} == {"wgmma", "tf32x3", "fma"},
             "flash attention checks took every path")
    report["flash_attention_checks"] = rows
    return worst_main


def time_flash(report: dict) -> list[dict]:
    """Kernel, plain version, SDPA and the bound at the prefill shapes:
    granite-8b's heads (Hq 32, Hkv 8, D 128) at S = 256, 512 and 1024 and
    zamba2-1.2b's shared attention (Hq = Hkv = 32, D 64) at S = 1024, in
    both dtypes (musicgen-large's heads are zamba2's), and qwen3-moe's
    (Hq 32, Hkv 4, D 64), moonshot's (Hq = Hkv = 16, D 128) and
    internvl2-76b's (Hq 64, Hkv 8, D 128), qwen2.5-14b's (Hq 40, Hkv 8, D
    128: GQA group 5) and nemotron-4-15b's (Hq 48, Hkv 8, D 128) at S =
    1024 in bfloat16, the dtype they are served in, and stablelm-3b's (Hq
    = Hkv = 32, D 80) at S = 1024 in both and, in bfloat16, at its
    training shape (B 2, S 2048: the forward of its bfloat16 training
    step); each row names the kernel's path and prices its products
    at that path's unit (``FLASH_UNIT``).  A float32 row also times the
    FMA kernel on the same values with q off a 16-byte boundary
    (``fma_ms``) and gives the FMA-priced bound (``fma_bound_ms``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     flash_path)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        bf16_only = ((1, 32, 4, 1024, 64), (1, 16, 16, 1024, 128),
                     (1, 64, 8, 1024, 128), (1, 40, 8, 1024, 128),
                     (1, 48, 8, 1024, 128), (2, 32, 32, 2048, 80))
        for b, hq, hkv, s, d in ((1, 32, 8, 256, 128), (1, 32, 8, 512, 128),
                                 (1, 32, 8, 1024, 128),
                                 (1, 32, 32, 1024, 64),
                                 (1, 32, 32, 1024, 80),
                                 *(bf16_only if dtype == torch.bfloat16
                                   else ())):
            q, k, v = _qkv(b, hq, hkv, s, s, d, dtype, seed=99)
            ms = _time_ms(lambda: flash_attention(q, k, v), iters=20)
            plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v),
                                iters=3, warmup=1, run_ahead=False)
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), iters=20)
            flops, nbytes = attention_work(b, hq, hkv, s, s, d, dtype)
            path = flash_path(q, k, v)
            bound_ms, bound_by = bound({FLASH_UNIT[path]: flops}, nbytes)
            # the wrapper's time per call, host included: at these sizes
            # its Python and launch cost can exceed the kernel's
            call_ms = _time_ms(lambda: flash_attention(q, k, v), iters=20,
                               run_ahead=False)
            row = {"dtype": name, "path": path,
                   "shape": [b, hq, hkv, s, s, d], "ms": ms,
                   "call_ms": call_ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "tflops": flops / (ms * 1e-3) / 1e12}
            if dtype == torch.float32:
                q_off = _off16(q)
                _require(flash_path(q_off, k, v) == "fma", "fma timing path")
                row["fma_ms"] = _time_ms(lambda: flash_attention(q_off, k, v),
                                         iters=20)
                row["fma_bound_ms"] = bound({"float32": flops}, nbytes)[0]
            rows.append(row)
            print(f"[time] flash_attention {row}", flush=True)
    report["flash_attention_timing"] = rows
    return rows


# flash attention's backward: the training shapes (B 2, S = T = 2048:
# granite-8b's heads, then musicgen-large's and zamba2's shared
# attention's, Hq = Hkv = 32, D 64) first, then the edges: ragged S < T (end-aligned),
# non-causal S > T, S shorter than one tile, GQA group 1 and 8, D 32 and 64,
# S and T one past a 32-row step (ragged in the 16-row q steps and 32-key
# tiles of the 3xTF32 kernels), and q off a 16-byte boundary (float32 on
# the FMA kernels); last, qwen3-moe-30b-a3b's training shape (GQA group 8
# at D 64), after the others so that their seeds (200 + the index) stay;
# after it stablelm-3b's head dim 80 and qwen2.5-14b's GQA group of 5: their
# training shapes, ragged, non-causal, one past a 32-row step, off 16 bytes
FLASH_BWD_CASES = [  # (b, hq, hkv, s, t, d, causal[, q off 16 bytes])
    (2, 32, 8, 2048, 2048, 128, True),
    (2, 32, 32, 2048, 2048, 64, True),
    (1, 32, 8, 300, 700, 128, True),
    (1, 8, 2, 130, 70, 64, False),
    (2, 8, 2, 40, 40, 32, True),
    (1, 8, 8, 200, 200, 64, True),
    (1, 32, 4, 256, 256, 128, True),
    (1, 4, 1, 100, 356, 32, False),
    (1, 8, 2, 33, 97, 128, True),
    (1, 16, 4, 200, 200, 64, True, True),
    (2, 32, 4, 2048, 2048, 64, True),   # qwen3-moe-30b-a3b's: group 8, D 64
    (2, 32, 32, 2048, 2048, 80, True),  # stablelm-3b's: D 80
    (1, 32, 32, 300, 700, 80, True),    # D 80, ragged S < T
    (1, 8, 8, 33, 97, 80, True),        # D 80, one past 32-row steps
    (1, 8, 8, 200, 200, 80, True, True),   # D 80 on the FMA kernels
    (2, 40, 8, 2048, 2048, 128, True),  # qwen2.5-14b's: group 5
    (1, 10, 2, 130, 70, 80, False),     # group 5 at D 80, non-causal S > T
    (1, 40, 8, 300, 300, 128, True, True),  # group 5 on the FMA kernels
]
# the bfloat16 training shapes of the backward, by model: granite-8b's
# heads, qwen3-moe-30b-a3b's (GQA group 8 at D 64), zamba2-1.2b's shared
# attention's (Hq = Hkv = 32, D 64), stablelm-3b's (Hq = Hkv = 32, D 80)
# and qwen2.5-14b's (Hq 40, Hkv 8: GQA group 5), B 2, S = T = 2048, causal
FLASH_BWD_BF16_SHAPES = (
    ("granite-8b", (2, 32, 8, 2048, 2048, 128, True)),
    ("qwen3-moe-30b-a3b", (2, 32, 4, 2048, 2048, 64, True)),
    ("zamba2-1.2b", (2, 32, 32, 2048, 2048, 64, True)),
    ("stablelm-3b", (2, 32, 32, 2048, 2048, 80, True)),
    ("qwen2.5-14b", (2, 40, 8, 2048, 2048, 128, True)),
)
# ... and in float32 beside granite-8b's (FLASH_BWD_CASES[0]): stablelm-3b's
# head dim 80
FLASH_BWD_F32_SHAPES = (
    ("stablelm-3b", (2, 32, 32, 2048, 2048, 80, True)),
)


def _bwd_inputs(b, hq, hkv, s, t, d, dtype, causal, seed):
    """q, k, v, the forward kernel's output o and a random gradient dO."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _qkv(b, hq, hkv, s, t, d, dtype, seed)
    with torch.no_grad():
        o = flash_attention(q, k, v, causal=causal)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 1000)
    do = torch.randn(q.shape, generator=g, device=DEVICE).to(dtype)
    return q, k, v, o, do


def bwd_errors(got, want) -> dict:
    """Each of dq, dk and dv against the plain version's: the largest
    |g - w|, the largest |g - w| / (1 + |w|) and ||g - w|| / ||w||."""
    import torch
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        out[name] = {
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / (1.0 + w.abs())).max()),
            "norm_rel_err": float(torch.linalg.vector_norm(g - w)
                                  / torch.linalg.vector_norm(w))}
    return out


def _bwd_ok(path: str, got, want, errs: dict) -> bool:
    """The backward of ``path`` holds: dq, dk and dv finite, of the inputs'
    dtype and shape, inside ``TOL`` x (1 + |w|) everywhere, ``tf32x3`` also
    inside ``FLASH_BWD_F32_KEEP`` x (1 + |w|) and ``wgmma`` inside
    ``FLASH_BWD_BF16_KEEP`` as a whole (``errs`` from ``bwd_errors``)."""
    import torch
    ok = True
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        tol = TOL[str(w.dtype).removeprefix("torch.")]
        e = errs[name]
        ok = (ok and g.dtype == w.dtype and g.shape == w.shape
              and bool(torch.isfinite(g).all())
              and bool(((g.float() - w.float()).abs()
                        <= tol * (1.0 + w.float().abs())).all())
              and (path != "tf32x3" or e["max_rel_err"] <= FLASH_BWD_F32_KEEP)
              and (path != "wgmma"
                   or e["norm_rel_err"] <= FLASH_BWD_BF16_KEEP))
    return ok


def check_flash_bwd(report: dict) -> dict:
    """The backward kernels against their plain version on the card, every
    case in both dtypes, at the forward's tolerance x (1 + |g|) on each of
    dq, dk and dv, float32 on ``tf32x3`` also at ``FLASH_BWD_F32_KEEP`` and
    bfloat16 on ``wgmma`` at ``FLASH_BWD_BF16_KEEP`` (``_bwd_ok``); each
    case names its path (``flash_bwd_path``: aligned float32 on the 3xTF32
    kernels, aligned bfloat16 on the wgmma ones, a q off a 16-byte boundary
    on the FMA kernels) and checks that the total and that path's counter
    moved by one, and no other path's.  Returns the largest error in each
    dtype at the training shapes (S = T = 2048)."""
    import torch
    from repro_torch.kernels.flash_attention import (bwd_launches,
                                                     bwd_path_launches,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_bwd_path)
    worst = {}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, (b, hq, hkv, s, t, d, causal, *off) in enumerate(
                FLASH_BWD_CASES):
            q, k, v, o, do = _bwd_inputs(b, hq, hkv, s, t, d, dtype, causal,
                                         seed=200 + i)
            if off:
                q = _off16(q)
            path = flash_bwd_path(q, k, v, o, do)
            before = (bwd_launches.count,
                      {p: c.count for p, c in bwd_path_launches.items()})
            got = flash_attention_bwd(q, k, v, o, do, causal=causal)
            torch.cuda.synchronize()
            by_path = {p: c.count - before[1][p]
                       for p, c in bwd_path_launches.items()}
            want = flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
            row = {"dtype": name, "path": path,
                   "shape": [b, hq, hkv, s, t, d], "causal": causal,
                   "tol": TOL[name], "launches": by_path[path]}
            errs = bwd_errors(got, want)
            for gname, e in errs.items():
                row.update({f"{gname}_{key}": x for key, x in e.items()})
            row["ok"] = ok = (bwd_launches.count - before[0] == 1
                              and by_path == {p: int(p == path)
                                              for p in by_path}
                              and _bwd_ok(path, got, want, errs))
            rows.append(row)
            print(f"[check] flash_attention_bwd {row}", flush=True)
            _require(ok, f"flash attention backward kernel against its plain "
                         f"version: {row}")
            if s == t == 2048:
                worst[name] = max(worst.get(name, 0.0),
                                  *(row[f"{g}_max_abs_err"]
                                    for g in ("dq", "dk", "dv")))
            del q, k, v, o, do, got, want
    for name, paths in (("float32", {"tf32x3", "fma"}),
                        ("bfloat16", {"wgmma", "fma"})):
        _require({r["path"] for r in rows if r["dtype"] == name} == paths,
                 f"the {name} backward checks took the paths {paths}")
    report["flash_attention_bwd_checks"] = rows
    return worst


def _time_bwd_turns(dtype, seed: int, case=FLASH_BWD_CASES[0]) -> tuple:
    """At ``case`` (b, hq, hkv, s, t, d, causal) in ``dtype``: the backward
    kernels on aligned inputs and on the same values with q off a 16-byte
    boundary (``fma``), and SDPA's backward (``torch.autograd.grad`` of its
    output on a graph recorded once and kept, so only the backward is
    timed), in turns over two rounds; the plain version once, and both
    kernels' gradients held to its own (``_bwd_ok``).  Returns (each call's
    median ms, its rounds, the plain ms, the kernels' path on the aligned
    inputs, the shape, each kernel path's ``bwd_errors``)."""
    import statistics
    import torch.nn.functional as F
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_bwd_path)
    b, hq, hkv, s, t, d, causal = case
    q, k, v, o, do = _bwd_inputs(b, hq, hkv, s, t, d, dtype, causal, seed)
    path = flash_bwd_path(q, k, v, o, do)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         enable_gqa=True)
    q_off = _off16(q)
    _require(flash_bwd_path(q_off, k, v, o, do) == "fma",
             "backward timing paths")
    calls = {path: lambda: flash_attention_bwd(q, k, v, o, do,
                                               causal=causal),
             "fma": lambda: flash_attention_bwd(q_off, k, v, o, do,
                                                causal=causal),
             "sdpa": lambda: torch.autograd.grad(out, leaves, do,
                                                 retain_graph=True)}
    rounds = {name: [] for name in calls}
    for _ in range(2):
        for name, fn in calls.items():
            rounds[name].append(_time_ms(fn, iters=5))
    ms = {name: statistics.median(r) for name, r in rounds.items()}
    plain = []
    plain_ms = _time_ms(lambda: plain.append(flash_attention_bwd_plain(
        q, k, v, o, do, causal=causal)), iters=1, warmup=1, run_ahead=False)
    errs = {}
    for name in (path, "fma"):
        got = calls[name]()
        errs[name] = bwd_errors(got, plain[-1])
        _require(_bwd_ok(name, got, plain[-1], errs[name]),
                 f"the {name} backward against its plain version at "
                 f"{list(case)} in {dtype}: {errs[name]}")
    del q, k, v, o, do, leaves, out, calls, plain, got
    torch.cuda.empty_cache()
    return ms, rounds, plain_ms, path, [b, hq, hkv, s, t, d], errs


def _bwd_by_model(dtype, model: str, case, seed: int) -> dict:
    """One model's training shape ``case`` in ``dtype`` (``_time_bwd_turns``):
    the aligned path a train step takes (float32 ``tf32x3``, bfloat16
    ``wgmma``), ``fma`` on the same values off a 16-byte boundary and SDPA's
    backward, with the bound at the aligned path's unit, its ``tflops``
    (the 5 products over its time), ``bound_share`` and the ratios
    ``vs_library`` (time over SDPA's) and ``fma_over_path``."""
    name = str(dtype).removeprefix("torch.")
    ms, rounds, plain_ms, path, shape, errs = _time_bwd_turns(dtype, seed,
                                                              case=case)
    want = SERVED_FLASH_PATH[name]
    _require(path == want, f"the {name} backward's timing path {path}")
    flops, nbytes = attention_bwd_work(*shape, dtype, case[6])
    bound_ms, bound_by = bound({FLASH_UNIT[path]: flops}, nbytes)
    out = {
        "dtype": name, "path": path, "shape": shape,
        "ms": ms[path], "ms_rounds": rounds[path],
        "fma_ms": ms["fma"], "fma_ms_rounds": rounds["fma"],
        "plain_ms": plain_ms,
        "library_ms": ms["sdpa"], "library_ms_rounds": rounds["sdpa"],
        "library": f"SDPA backward ({name}, autograd.grad on a kept graph)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "fma_bound_ms": bound({"float32": flops}, nbytes)[0],
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        "tflops": flops / (ms[path] * 1e-3) / 1e12,
        "bound_share": bound_ms / ms[path],
        "vs_library": ms[path] / ms["sdpa"],
        "fma_over_path": ms["fma"] / ms[path], "errors": errs}
    print(f"[time] flash_attention_bwd {name} {model} {out}", flush=True)
    return out


def time_flash_bwd(report: dict) -> dict:
    """Both backward paths, the plain version, SDPA's backward and the
    bound at the training shape, float32 (``_time_bwd_turns``):
    ``tf32x3`` on the aligned inputs, ``fma`` on the same values with q
    off a 16-byte boundary, SDPA's backward without TF32.  The bound
    prices the 5 products the function needs at 3xTF32's rate, the least
    time at float32's accuracy (``fma_bound_ms`` at the FMA peak, the
    units of the FMA kernels); each path's ``tflops`` is those 5 products
    over its time and ``bound_share`` its unit's bound over its time.
    Each row keeps both kernel paths' errors against the plain version
    (``"errors"``).  Then ``_bwd_by_model`` under ``"float32_by_model"``
    at each of ``FLASH_BWD_F32_SHAPES`` and under ``"bfloat16_by_model"``
    at each of ``FLASH_BWD_BF16_SHAPES`` (the bound at the bfloat16 tensor
    cores' peak there)."""
    import torch
    ms, rounds, plain_ms, path, shape, errs = _time_bwd_turns(torch.float32,
                                                              299)
    _require(path == "tf32x3", "backward timing paths")
    flops, nbytes = attention_bwd_work(*shape, torch.float32)
    bound_ms, bound_by = bound({"3xtf32": flops}, nbytes)
    fma_bound_ms = bound({"float32": flops}, nbytes)[0]
    paths = {path: {"ms": ms[path], "ms_rounds": rounds[path],
                    "tflops": flops / (ms[path] * 1e-3) / 1e12,
                    "bound_ms": bound, "bound_share": bound / ms[path]}
             for path, bound in (("tf32x3", bound_ms),
                                 ("fma", fma_bound_ms))}
    row = {"dtype": "float32", "path": "tf32x3", "shape": shape,
           "ms": ms["tf32x3"], "fma_ms": ms["fma"], "plain_ms": plain_ms,
           "library_ms": ms["sdpa"], "library_ms_rounds": rounds["sdpa"],
           "library": "SDPA backward (autograd.grad on a kept graph)",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "fma_bound_ms": fma_bound_ms, "paths": paths,
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           "tflops": paths["tf32x3"]["tflops"], "errors": errs}
    print(f"[time] flash_attention_bwd {row}", flush=True)
    row["float32_by_model"] = {
        model: _bwd_by_model(torch.float32, model, case, 297)
        for model, case in FLASH_BWD_F32_SHAPES}
    by_model = {model: _bwd_by_model(torch.bfloat16, model, case, 298)
                for model, case in FLASH_BWD_BF16_SHAPES}
    row["bfloat16_by_model"] = by_model
    report["flash_attention_bwd_timing"] = row
    return row


def _ssd_inputs(b, s, h, d, n, dtype, decay, seed):
    """x, a, b, c on the card.  ``decay``: "mild" (a = -|z| / 10, Mamba-2
    like), "mlstm" (a = log(sigmoid(z) + 1e-6), the mLSTM forget gate) or
    "strong" (a uniform down to log 1e-6 a token)."""
    import torch
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=DEVICE)
    x, z, bm, cm = rn(b, s, h, d) * 0.5, rn(b, s, h), rn(b, s, n), rn(b, s, n)
    if decay == "mild":
        a = -z.abs() * 0.1
    elif decay == "mlstm":
        a = torch.log(torch.sigmoid(z) + 1e-6)
    else:
        a = math.log(1e-6) * torch.rand(b, s, h, generator=g, device=DEVICE)
    # b, c ~ N^-1/4 keep C . B^T of order one whatever N is
    return [t.to(dtype) for t in (x, a, bm * n ** -0.25, cm * n ** -0.25)]


# (b, s, h, d, n, decay): zamba2's heads (H 32, D 128, N 64), the mLSTM
# values (B * 4 heads folded, D = N = 384) and normalizer (D 1), a ragged S,
# S shorter than one chunk, B > 1 with D and N that the tiles do not divide;
# 64 chunks of state passing; B > 1 and H > 1 with states that underflow;
# the normalizer at the served length
SSD_CASES = [
    (1, 256, 32, 128, 64, "mild"),
    (1, 1024, 32, 128, 64, "mild"),
    (1, 300, 32, 128, 64, "mild"),
    (4, 512, 1, 384, 384, "mlstm"),
    (4, 512, 1, 1, 384, "mlstm"),
    (4, 300, 1, 384, 384, "strong"),
    (2, 37, 4, 32, 16, "mild"),
    (3, 200, 2, 48, 100, "mlstm"),
    (1, 4096, 32, 128, 64, "mild"),
    (2, 1024, 32, 128, 64, "strong"),
    (4, 1024, 1, 1, 384, "mlstm"),
]


def ssd_errors(names, got, want) -> dict:
    """Each named output of the SSD kernels against the plain version's:
    the largest |g - w|, the largest |g - w| / (1 + |w|), ||g - w|| /
    ||w|| (0 where w is all zeros and g equals it) and the largest |w|."""
    import torch
    out = {}
    for name, g, w in zip(names, got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        norm = float(torch.linalg.vector_norm(w))
        out[name] = {
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / (1.0 + w.abs())).max()),
            "norm_rel_err": (float(torch.linalg.vector_norm(g - w)) / norm
                             if norm else 0.0 if not err.max() else math.inf),
            "max_abs": float(w.abs().max())}
    return out


def _ssd_ok(got, want, errs: dict, dtype, shapes) -> bool:
    """The SSD outputs hold (``errs`` from ``ssd_errors``): finite, of the
    inputs' ``dtype`` and ``shapes`` (one an output), inside ``SSD_TOL`` x
    (1 + |w|) everywhere; in float32 also inside ``SSD_F32_KEEP`` (y) or
    ``SSD_BWD_F32_KEEP`` (a gradient) x (1 + |w|), in bfloat16 inside
    ``SSD_BF16_KEEP`` as a whole."""
    import torch
    name_of = str(dtype).removeprefix("torch.")
    ok = True
    for (name, e), g, w, shape in zip(errs.items(), got, want, shapes):
        keep = (SSD_BF16_KEEP[name] >= e["norm_rel_err"]
                if name_of == "bfloat16" else
                (SSD_F32_KEEP if name == "y" else SSD_BWD_F32_KEEP[name])
                >= e["max_rel_err"])
        ok = (ok and keep and g.dtype == dtype and tuple(g.shape) == shape
              and bool(torch.isfinite(g).all())
              and bool(((g.float() - w.float()).abs()
                        <= SSD_TOL[name_of] * (1.0 + w.float().abs())).all()))
    return ok


def _fresh_route(dtype: str, d: int, n: int, route: str) -> str:
    """The route fresh (aligned) inputs of D and N must take: in bfloat16
    "bf16_async" where N is a multiple of 8 and D one too or below 16,
    else "plain"; in float32 ``route``, the one ``ssd_route`` named."""
    if dtype != "bfloat16":
        return route
    return "bf16_async" if n % 8 == 0 and (d % 8 == 0 or d < 16) else "plain"


def _moved(counters: dict, before: dict) -> dict:
    """The counters of ``counters`` (name: LaunchCounter) that moved since
    ``before`` (name: count), by how much."""
    return {k: c.count - before[k] for k, c in counters.items()
            if c.count != before[k]}


def check_ssd(report: dict) -> float:
    """Kernel against its plain version on the card, every case in both
    dtypes (``_ssd_ok``); each call counts one launch on the route
    ``ssd_route`` gives, a bfloat16 one on "bf16_async" where b's and c's
    rows are on 16 bytes (N a multiple of 8) and x's too or D is below 16,
    else on "plain".  Returns the largest float32 error over the cases."""
    import torch
    from repro_torch.kernels.ssd_scan import (path_launches, ssd_route,
                                              ssd_scan, ssd_scan_plain)
    worst = 0.0
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, (b, s, h, d, n, decay) in enumerate(SSD_CASES):
            x, a, bm, cm = _ssd_inputs(b, s, h, d, n, dtype, decay, seed=i)
            route = ssd_route(x, bm, cm)
            before = {k: c.count for k, c in path_launches.items()}
            got = ssd_scan(x, a, bm, cm)
            torch.cuda.synchronize()
            moved = _moved(path_launches, before)
            want = ssd_scan_plain(x, a, bm, cm)
            errs = ssd_errors(("y",), (got,), (want,))
            ok = (_ssd_ok((got,), (want,), errs, dtype, (tuple(x.shape),))
                  and moved == {route: 1}
                  and route == _fresh_route(name, d, n, route))
            row = {"dtype": name, "shape": [b, s, h, d, n], "decay": decay,
                   "route": route, **errs["y"], "tol": SSD_TOL[name],
                   "ok": ok}
            if name == "bfloat16":
                row["keep"] = SSD_BF16_KEEP["y"]
            rows.append(row)
            print(f"[check] ssd_scan {row}", flush=True)
            _require(ok, f"SSD scan kernel against its plain version: {row}")
            if name == "float32":
                worst = max(worst, row["max_abs_err"])
    report["ssd_scan_checks"] = rows
    return worst


# what the bfloat16 SSD rows' bound counts
SSD_BF16_BOUND = ("work.ssd_work / ssd_bwd_work at bfloat16's bytes; a "
                  "product of two inputs (C . B^T, M = dy x^T) at the "
                  "bfloat16 peak, of an input and a float32 value at "
                  "2xTF32 (half of TF32's peak) where D >= 16")
# the kinds of work.H100_PEAK_FLOPS that run on the tensor cores
TENSOR_KINDS = ("3xtf32", "2xtf32", "bfloat16")


def time_ssd(report: dict) -> list[dict]:
    """Kernel, plain version and the bound (``work.ssd_work``: float32's
    tensor-core products in 3xTF32 at that rate) at the served shapes, float32
    (no single PyTorch call computes the scan: library_ms is null), with
    the wrapper's time per call, host included (``call_ms``), and the
    passes' scratch (``scratch_mb``, the design's cost, not in the
    bound); then in bfloat16 at ``SSD_BWD_TRAIN``'s shapes (a training
    step's forwards), with the route taken and the bound as
    ``SSD_BF16_BOUND`` says."""
    import torch
    from repro_torch.kernels.ssd_scan import (NARROW_D, narrow_d,
                                              scratch_floats, ssd_route,
                                              ssd_scan, ssd_scan_plain)
    _require(narrow_d() == NARROW_D,
             f"the built SSD kernel's NARROW_D {narrow_d()} is the meta "
             f"path's {NARROW_D}")
    cases = [(label, torch.float32, (b, s, h, d, n, decay))
             for s in (256, 1024)
             for label, (b, h, d, n, decay) in (
                 ("zamba2", (1, 32, 128, 64, "mild")),
                 ("mlstm_values", (4, 1, 384, 384, "mlstm")),
                 ("mlstm_normalizer", (4, 1, 1, 384, "mlstm")))]
    cases += [(f"{label}_train", torch.bfloat16, shape)
              for label, shape in SSD_BWD_TRAIN.items()]
    rows = []
    for label, dtype, (b, s, h, d, n, decay) in cases:
        x, a, bm, cm = _ssd_inputs(b, s, h, d, n, dtype, decay, seed=99)
        ms = _time_ms(lambda: ssd_scan(x, a, bm, cm), iters=20)
        plain_ms = _time_ms(lambda: ssd_scan_plain(x, a, bm, cm),
                            iters=3 if s < 2048 else 2, warmup=1,
                            run_ahead=False)
        call_ms = _time_ms(lambda: ssd_scan(x, a, bm, cm), iters=20,
                           run_ahead=False)
        flops, nbytes = ssd_work(b, s, h, d, n, dtype, narrow_d())
        bound_ms, bound_by = bound(flops, nbytes)
        row = {"case": label, "dtype": str(dtype).removeprefix("torch."),
               "shape": [b, s, h, d, n], "ms": ms, "call_ms": call_ms,
               "scratch_mb": scratch_floats(b, s, h, d, n) * 4 / 1e6,
               "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gflop": sum(flops.values()) / 1e9,
               "tensor_core_gflop": sum(flops.get(k, 0)
                                        for k in TENSOR_KINDS) / 1e9,
               "mbytes": nbytes / 1e6,
               "tflops": sum(flops.values()) / (ms * 1e-3) / 1e12}
        if dtype == torch.bfloat16:
            row["route"] = ssd_route(x, bm, cm)
            row["bound_counts"] = SSD_BF16_BOUND
        rows.append(row)
        print(f"[time] ssd_scan {row}", flush=True)
        del x, a, bm, cm
        torch.cuda.empty_cache()
    report["ssd_scan_timing"] = rows
    return rows


def _ssd_bwd_bound(b, s, h, d, n, dtype) -> dict:
    """The SSD backward's bound: the least time of the gradient, the
    smaller of its two ways' (``work.ssd_bwd_work``: C . B^T, Acum and h_c
    kept, which the kernel reads, or computed again).  Both ways' bounds,
    and the smaller's ms, bytes or operations, way and FMA-priced
    bound."""
    ways = {}
    for way in ("kept", "recompute"):
        flops, nbytes = ssd_bwd_work(b, s, h, d, n, dtype, way == "kept")
        ways[way] = (*bound(flops, nbytes), flops, nbytes)
    way = min(ways, key=lambda k: ways[k][0])
    ms, by, flops, nbytes = ways[way]
    return {"bound_ms": ms, "bound_by": by, "bound_way": way,
            "bound_ms_by_way": {k: v[0] for k, v in ways.items()},
            "fma_bound_ms": bound({"float32": sum(flops.values())},
                                   nbytes)[0]}


def _ssd_bwd_inputs(b, s, h, d, n, dtype, decay, seed):
    """(x, a, b, c, the forward kernel's output y, a random dy) and the
    forward's kept scratch (``ssd_scan_keep``)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_keep
    x, a, bm, cm = _ssd_inputs(b, s, h, d, n, dtype, decay, seed)
    y, saved = ssd_scan_keep(x, a, bm, cm)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 1000)
    dy = torch.randn(y.shape, generator=g, device=DEVICE).to(dtype)
    return (x, a, bm, cm, y, dy), saved


# (b, s, h, d, n, decay) of the backward at phase 8's training shapes:
# zamba2's heads at B 2 x S 2048, and xlstm's B 2 x S 2048 with its 4 mLSTM
# heads folded into the batch (``mlstm_block``): the values (B 8, D = N =
# 384) and the normalizer (D 1)
SSD_BWD_TRAIN = {"zamba2": (2, 2048, 32, 128, 64, "mild"),
                 "mlstm_values": (8, 2048, 1, 384, 384, "mlstm"),
                 "mlstm_normalizer": (8, 2048, 1, 1, 384, "mlstm")}
# the training shapes, then a ragged S, S shorter than one chunk, B > 1
# with D and N that the tiles do not divide, and strong decays down to
# log 1e-6
SSD_BWD_CASES = [
    *SSD_BWD_TRAIN.values(),
    (1, 300, 32, 128, 64, "mild"),
    (2, 37, 4, 32, 16, "mild"),
    (3, 200, 2, 48, 100, "mlstm"),
    (4, 300, 1, 384, 384, "strong"),
    (2, 1024, 32, 128, 64, "strong"),
    (3, 130, 1, 1, 100, "strong"),
]


# (b, s, h, d, n) of the backward's bit-for-bit repeat in each dtype: D and
# N that the tiles do not divide, in bfloat16 on "bf16_async" (N 96)
SSD_BWD_REPEAT = {"float32": (3, 200, 2, 48, 100),
                  "bfloat16": (3, 200, 2, 48, 96)}


def check_ssd_bwd(report: dict) -> dict:
    """The backward kernel (dx, da, db, dc), reading the forward kernel's
    kept scratch as training runs it, against its plain version on the
    card, every case in both dtypes (``_ssd_ok``: ``SSD_TOL`` x (1 + |g|),
    float32 also ``SSD_BWD_F32_KEEP`` x (1 + |g|), bfloat16 also
    ``SSD_BF16_KEEP`` as a whole), and at ``SSD_BWD_TRAIN``'s shapes the
    forward kernel's y it reads too; each call moves the backward's counter
    and its route's by one (a bfloat16 case on "bf16_async" where the
    forward's is) and launches no forward; in each dtype, two calls on one
    input agree bit for bit (no atomics), the second without the kept
    scratch (it runs the forward first).  Returns the largest error in
    each dtype at zamba2's training shape."""
    import torch
    from repro_torch.kernels.ssd_scan import (bwd_launches,
                                              bwd_path_launches, launches,
                                              ssd_route, ssd_scan_bwd,
                                              ssd_scan_bwd_plain,
                                              ssd_scan_plain)
    worst = {}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, (b, s, h, d, n, decay) in enumerate(SSD_BWD_CASES):
            ins, saved = _ssd_bwd_inputs(b, s, h, d, n, dtype, decay,
                                         seed=300 + i)
            route = ssd_route(ins[0], ins[2], ins[3], ins[4], ins[5])
            before = (bwd_launches.count, launches.count)
            paths = {k: c.count for k, c in bwd_path_launches.items()}
            got = ssd_scan_bwd(*ins, saved=saved)
            torch.cuda.synchronize()
            launched = [bwd_launches.count - before[0],
                        launches.count - before[1]]
            moved = _moved(bwd_path_launches, paths)
            del saved
            want = ssd_scan_bwd_plain(*ins)
            names = ("dx", "da", "db", "dc")
            shapes = tuple(tuple(t.shape) for t in ins[:4])
            if i < len(SSD_BWD_TRAIN):  # the forward's y at phase 8's shapes
                got = (ins[4], *got)
                want = (ssd_scan_plain(*ins[:4]), *want)
                names, shapes = ("y", *names), (shapes[0], *shapes)
            errs = ssd_errors(names, got, want)
            ok = (launched == [1, 0] and moved == {route: 1}
                  and route == _fresh_route(name, d, n, route)
                  and _ssd_ok(got, want, errs, dtype, shapes))
            row = {"dtype": name, "shape": [b, s, h, d, n], "decay": decay,
                   "tol": SSD_TOL[name], "route": route,
                   "launches": launched[0], "forward_launches": launched[1],
                   **{f"{g}_{k}": v for g, e in errs.items()
                      for k, v in e.items()},
                   "keep": ({"y": SSD_F32_KEEP, **SSD_BWD_F32_KEEP}
                            if name == "float32" else SSD_BF16_KEEP),
                   "ok": ok}
            rows.append(row)
            print(f"[check] ssd_scan_bwd {row}", flush=True)
            _require(ok, f"SSD scan backward kernel against its plain "
                         f"version: {row}")
            if i == 0:
                worst[name] = max(row[f"{g}_max_abs_err"]
                                  for g in ("dx", "da", "db", "dc"))
            del ins, got, want
        again, saved = _ssd_bwd_inputs(*SSD_BWD_REPEAT[name], dtype,
                                       "mlstm", 399)
        first = ssd_scan_bwd(*again, saved=saved)
        second = ssd_scan_bwd(*again)
        torch.cuda.synchronize()
        _require(all(torch.equal(u, v) for u, v in zip(first, second)),
                 f"the SSD backward repeats bit for bit in {name}, also "
                 f"when it runs the forward for its scratch")
    report["ssd_scan_bwd_checks"] = rows
    return worst


def time_ssd_bwd(report: dict) -> dict:
    """The backward kernel, reading the forward kernel's kept scratch as
    training runs it, its plain version on the same inputs and the bound
    (``_ssd_bwd_bound``) at each of ``SSD_BWD_TRAIN``'s shapes, in float32
    and in bfloat16 (with the route taken; the bound as ``SSD_BF16_BOUND``
    says).  No PyTorch call computes the scan's gradient, so library_ms is
    null.  Also the wrapper's time per call, host included (``call_ms``),
    the backward's own scratch, the kept forward scratch it reads, and the
    work it does (``gflop``, ``mbytes``, ``tflops``).  The float32 row of
    zamba2's shape, with the other float32 rows under their names and the
    bfloat16 rows under ``bfloat16``."""
    import torch
    from repro_torch.kernels.ssd_scan import (bwd_scratch_floats,
                                              scratch_floats, ssd_route,
                                              ssd_scan_bwd,
                                              ssd_scan_bwd_plain)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for label, (b, s, h, d, n, decay) in SSD_BWD_TRAIN.items():
            ins, saved = _ssd_bwd_inputs(b, s, h, d, n, dtype, decay,
                                         seed=399)
            ms = _time_ms(lambda: ssd_scan_bwd(*ins, saved=saved), iters=10)
            call_ms = _time_ms(lambda: ssd_scan_bwd(*ins, saved=saved),
                               iters=10, run_ahead=False)
            plain_ms = _time_ms(
                lambda: ssd_scan_bwd_plain(*ins, saved=saved), iters=2,
                warmup=1, run_ahead=False)
            flops, nbytes = ssd_bwd_work(b, s, h, d, n, dtype, True)
            row = {
                "case": f"{label}_train", "dtype": name,
                "shape": [b, s, h, d, n], "ms": ms, "call_ms": call_ms,
                "plain_ms": plain_ms, "library_ms": None,
                **_ssd_bwd_bound(b, s, h, d, n, dtype),
                "scratch_mb": bwd_scratch_floats(b, s, h, d, n) * 4 / 1e6,
                "kept_mb": scratch_floats(b, s, h, d, n) * 4 / 1e6,
                "gflop": sum(flops.values()) / 1e9, "mbytes": nbytes / 1e6,
                "tflops": sum(flops.values()) / (ms * 1e-3) / 1e12}
            if dtype == torch.bfloat16:
                row["route"] = ssd_route(ins[0], ins[2], ins[3], ins[4],
                                         ins[5])
                row["bound_counts"] = SSD_BF16_BOUND
            rows.setdefault(name, {})[label] = row
            del ins, saved
            torch.cuda.empty_cache()
    row = rows["float32"].pop("zamba2")
    row.update(rows["float32"])
    row["bfloat16"] = rows["bfloat16"]
    print(f"[time] ssd_scan_bwd {row}", flush=True)
    report["ssd_scan_bwd_timing"] = row
    return row


def _slstm_inputs(b, s, d, dtype, carry, seed):
    """gx, r and a carry on the card: gx ~ N(0, 1) (a unit-RMS hidden
    state's gate inputs), r ~ N(0, 0.1^2) (``init_slstm``'s scale); the
    carry zero (a prefill's) or random (a decode's: h N(0, 1/4), c N(0, 1),
    n |N(0, 1)| + 1, m N(0, 1))."""
    import torch
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=DEVICE)
    gx, r = rn(b, s, 4, d), rn(4, d) * 0.1
    if carry == "zero":
        cs = [torch.zeros(b, d, device=DEVICE) for _ in range(4)]
    else:
        cs = [rn(b, d) * 0.5, rn(b, d), rn(b, d).abs() + 1.0, rn(b, d)]
    return gx.to(dtype), r.to(dtype), tuple(t.to(dtype) for t in cs)


def slstm_grad_inputs(b, s, d, dtype, carry, seed):
    """``_slstm_inputs`` at ``seed`` and a backward's output gradients:
    dhs ``[B, S, d]`` and the last carry's four ``[B, d]``, N(0, 1) from a
    generator seeded ``seed + 100``: (gx, r, carry, dhs, dlast)."""
    import torch
    gx, r, carry = _slstm_inputs(b, s, d, dtype, carry, seed)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed + 100)
    dhs = torch.randn((b, s, d), generator=g, device=DEVICE).to(dtype)
    dlast = tuple(torch.randn((b, d), generator=g, device=DEVICE).to(dtype)
                  for _ in range(4))
    return gx, r, carry, dhs, dlast


# the runs of the sLSTM kernels on one input that check_slstm holds equal
# bit for bit
SLSTM_REPEATS = 5


# (b, s, d) of the sLSTM recurrence at xlstm-125m's d 768: a 1024-token
# prefill, phase 8's training shape (B 2 x S 2048) and a decode step
SLSTM_PREFILL, SLSTM_TRAIN = (1, 1024, 768), (2, 2048, 768)
# (b, s, d, carry): the main paths' shapes, then B > 1 at S = 1, a ragged S
# with d off the warp's 32, a longer ragged S, a short S with B = 3
SLSTM_CASES = [
    (*SLSTM_PREFILL, "zero"),
    (*SLSTM_TRAIN, "zero"),
    (1, 1, 768, "random"),
    (8, 1, 768, "random"),
    (3, 37, 100, "random"),
    (1, 300, 48, "random"),
    (3, 13, 33, "zero"),
]


def check_slstm(report: dict) -> dict:
    """The sLSTM forward kernel (hs, the last carry, and, as training runs
    it, hs again beside the kept carry the backward reads; ``keep_equal``
    says whether the two runs' hs, last carry and kept carry agree bit for
    bit with a second call's) and backward kernel (dgx, dr, the initial
    carry's gradient, from random dhs and last-carry gradients, on the
    kernel's own hs and kept carry) against their plain versions on the
    card, every case of ``SLSTM_CASES`` in both dtypes, at ``TOL`` x (1 +
    |v|), and in float32 each direction also at ``SLSTM_F32_KEEP`` x (1 +
    |v|) (the plain backward computes in float64); one count a call each;
    ``SLSTM_REPEATS`` runs of the forward keeping the carry and of the
    backward on one input give every output bit for bit alike
    (``repeats_equal``).  Returns the largest error of each direction in each dtype over the
    cases, absolute and (``*_rel``) over (1 + |v|)."""
    import torch
    from repro_torch.kernels.slstm_scan import (bwd_launches, launches,
                                                slstm_scan, slstm_scan_bwd,
                                                slstm_scan_bwd_plain,
                                                slstm_scan_keep,
                                                slstm_scan_plain)
    worst, rows = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, (b, s, d, carry_kind) in enumerate(SLSTM_CASES):
            gx, r, carry, dhs, dlast = slstm_grad_inputs(b, s, d, dtype,
                                                         carry_kind, 500 + i)
            before = (launches.count, bwd_launches.count)
            with torch.no_grad():
                hs0, last0 = slstm_scan(gx, r, carry)
            hs, last, kept = slstm_scan_keep(gx, r, carry)
            hs1, last1, kept1 = slstm_scan_keep(gx, r, carry)
            grads = slstm_scan_bwd(gx, r, carry, hs, kept, dhs, dlast)
            torch.cuda.synchronize()
            launched = [launches.count - before[0],
                        bwd_launches.count - before[1]]
            runs = [(hs, kept, *last, grads[0], grads[1], *grads[2])]
            for _ in range(SLSTM_REPEATS - 1):
                hs2, last2, kept2 = slstm_scan_keep(gx, r, carry)
                g2 = slstm_scan_bwd(gx, r, carry, hs2, kept2, dhs, dlast)
                runs.append((hs2, kept2, *last2, g2[0], g2[1], *g2[2]))
            torch.cuda.synchronize()
            repeats = all(torch.equal(u, v) for run in runs[1:]
                          for u, v in zip(run, runs[0]))
            del runs
            want_hs, want_last, want_kept = slstm_scan_plain(gx, r, carry,
                                                             keep=True)
            want = slstm_scan_bwd_plain(gx, r, carry, hs, kept, dhs, dlast)
            row = {"dtype": name, "shape": [b, s, d], "carry": carry_kind,
                   "tol": TOL[name], "launches": launched,
                   "keep_equal": torch.equal(hs0, hs) and torch.equal(
                       hs1, hs) and torch.equal(kept1, kept) and all(
                       torch.equal(u, v) and torch.equal(w, v)
                       for u, v, w in zip(last0, last, last1)),
                   "repeats_equal": repeats}
            ok = launched == [3, 1] and row["keep_equal"] and repeats
            fwd = [("hs", hs0, want_hs), ("hs_kept", hs, want_hs),
                   ("kept", kept, want_kept),
                   *((f"last_{k}", u, v)
                     for k, u, v in zip("hcnm", last, want_last))]
            bwd = [("dgx", grads[0], want[0]), ("dr", grads[1], want[1]),
                   *((f"d{k}0", u, v)
                     for k, u, v in zip("hcnm", grads[2], want[2]))]
            for part, pairs in (("fwd", fwd), ("bwd", bwd)):
                errs = []
                for label, got, ref in pairs:
                    good, err = _close(got, ref, TOL[name])
                    rel = _rel_err(got, ref)
                    if dtype == torch.float32:
                        good = good and rel <= SLSTM_F32_KEEP[part]
                    ok = ok and good
                    errs.append(err)
                    row[f"{label}_max_abs_err"] = err
                    row[f"{label}_rel_err"] = rel
                    row[f"{label}_max_abs"] = float(ref.float().abs().max())
                key = f"{part}_{name}"
                worst[key] = max(worst.get(key, 0.0), *errs)
                rkey = f"{part}_{name}_rel"
                worst[rkey] = max(worst.get(rkey, 0.0),
                                  *(row[f"{lb}_rel_err"] for lb, _, _ in pairs))
            if dtype == torch.float32:
                row["keep"] = SLSTM_F32_KEEP
            row["ok"] = ok
            rows.append(row)
            print(f"[check] slstm_scan {row}", flush=True)
            _require(ok, f"sLSTM kernels against their plain versions: {row}")
            del gx, r, carry, hs, last, kept, hs1, last1, kept1, grads, want
    report["slstm_scan_checks"] = rows
    return worst


# (b, s, d, lengths) of the forward kernel with a padded prefill's lengths:
# xlstm-125m's prefill shape at length 1 and S, a ragged batch at a ragged
# S, and d 100 through the wrapper's zero padding
SLSTM_LENGTH_CASES = [
    (1, 1024, 768, (1,)),
    (1, 1024, 768, (1024,)),
    (3, 300, 768, (300, 1, 137)),
    (2, 70, 100, (70, 33)),
]


def check_slstm_lengths(report: dict) -> dict:
    """The sLSTM forward kernel with ``lengths`` (a padded prefill's: each
    row's steps from its length on hold the carry) against its plain
    version with the same lengths, ``SLSTM_LENGTH_CASES`` in both dtypes,
    hs and the last carry at ``TOL`` x (1 + |v|) and in float32 also at
    ``SLSTM_F32_KEEP["fwd"]``, one count a call.  Reported beside: whether
    each row's last carry and hs before its length equal, bit for bit, the
    unbounded kernel's on that row cut to its length (``cut_equal``).
    Returns the largest error in each dtype."""
    import torch
    from repro_torch.kernels.slstm_scan import (launches, slstm_scan,
                                                slstm_scan_plain)
    worst, rows = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, (b, s, d, lens) in enumerate(SLSTM_LENGTH_CASES):
            gx, r, carry = _slstm_inputs(b, s, d, dtype, "random", 900 + i)
            lengths = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
            before = launches.count
            with torch.no_grad():
                hs, last = slstm_scan(gx, r, carry, lengths=lengths)
                torch.cuda.synchronize()
                launched = launches.count - before
                cut = []
                for row, n in enumerate(lens):
                    hs_c, last_c = slstm_scan(
                        gx[row:row + 1, :n].contiguous(), r,
                        tuple(t[row:row + 1].contiguous() for t in carry))
                    cut.append(torch.equal(hs_c[0], hs[row, :n]) and all(
                        torch.equal(u[0], v[row])
                        for u, v in zip(last_c, last)))
            want_hs, want_last = slstm_scan_plain(gx, r, carry,
                                                  lengths=lengths)
            row = {"dtype": name, "shape": [b, s, d], "lengths": list(lens),
                   "tol": TOL[name], "launches": launched,
                   "cut_equal": cut}
            ok = launched == 1
            errs = []
            for label, got, ref in (("hs", hs, want_hs),
                                    *((f"last_{k}", u, v) for k, u, v in
                                      zip("hcnm", last, want_last))):
                good, err = _close(got, ref, TOL[name])
                rel = _rel_err(got, ref)
                if dtype == torch.float32:
                    good = good and rel <= SLSTM_F32_KEEP["fwd"]
                ok = ok and good
                errs.append(err)
                row[f"{label}_max_abs_err"] = err
                row[f"{label}_rel_err"] = rel
            worst[name] = max(worst.get(name, 0.0), *errs)
            row["ok"] = ok
            rows.append(row)
            print(f"[check] slstm_scan lengths {row}", flush=True)
            _require(ok, f"sLSTM kernel with lengths against its plain "
                         f"version: {row}")
    report["slstm_scan_length_checks"] = rows
    return worst


def _slstm_bwd_bound(b, s, d, dtype) -> dict:
    """The sLSTM backward's bound: the least time of the gradient, the
    smaller of its two ways' (``work.slstm_bwd_work``: hs and the carry
    kept by the forward, which the kernel reads, or computed again), and
    both ways' bounds."""
    ways = {way: bound(*slstm_bwd_work(b, s, d, dtype, way == "kept"))
            for way in ("kept", "recompute")}
    way = min(ways, key=lambda k: ways[k][0])
    return {"bound_ms": ways[way][0], "bound_by": ways[way][1],
            "bound_way": way,
            "bound_ms_by_way": {k: v[0] for k, v in ways.items()}}


def time_slstm(report: dict) -> dict:
    """The forward kernel at the prefill shape (serving: nothing kept) and
    at the training shape (the carry kept for the backward), and the
    backward kernel at the training shape, float32, each beside its plain
    version on the same inputs, its bound and the wrapper's time per call,
    host included (``call_ms``).  The forward's bound is the function's
    bytes (``work.slstm_work``), the kept carry's apart (``kept_mbytes``;
    ``bound_ms_with_kept`` counts them too); the backward's the smaller of
    its two ways' (``_slstm_bwd_bound``).  ``ns_per_step`` is the kernel's
    time over S, the pace of its serial chain.  No PyTorch call computes
    the recurrence, so library_ms is null."""
    import torch
    from repro_torch.kernels.slstm_scan import (slstm_scan, slstm_scan_bwd,
                                                slstm_scan_bwd_plain,
                                                slstm_scan_keep,
                                                slstm_scan_plain)
    rows = {}
    for label, (b, s, d) in (("prefill", SLSTM_PREFILL),
                             ("train", SLSTM_TRAIN)):
        keep = label == "train"
        gx, r, carry = _slstm_inputs(b, s, d, torch.float32, "zero", 700)
        if keep:
            fwd = lambda: slstm_scan_keep(gx, r, carry)
            plain = lambda: slstm_scan_plain(gx, r, carry, keep=True)
        else:
            fwd = lambda: slstm_scan(gx, r, carry)
            plain = lambda: slstm_scan_plain(gx, r, carry)
        with torch.no_grad():
            ms = _time_ms(fwd, iters=20)
            call_ms = _time_ms(fwd, iters=20, run_ahead=False)
            plain_ms = _time_ms(plain, iters=1, warmup=1, run_ahead=False)
        flops, nbytes = slstm_work(b, s, d, torch.float32, False)
        bound_ms, bound_by = bound(flops, nbytes)
        rows[label] = {"case": label, "dtype": "float32", "shape": [b, s, d],
                       "kept": keep, "ms": ms, "call_ms": call_ms,
                       "plain_ms": plain_ms, "library_ms": None,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "mbytes": nbytes / 1e6,
                       "ns_per_step": ms * 1e6 / s}
        if keep:
            _, kept_bytes = slstm_work(b, s, d, torch.float32, True)
            rows[label]["kept_mbytes"] = (kept_bytes - nbytes) / 1e6
            rows[label]["bound_ms_with_kept"] = bound(
                flops, kept_bytes)[0]
            hs, last, kept = slstm_scan_keep(gx, r, carry)
            g = torch.Generator(device=DEVICE)
            g.manual_seed(701)
            dhs = torch.randn(hs.shape, generator=g, device=DEVICE)
            dlast = tuple(torch.zeros_like(t) for t in last)
            ins = (gx, r, carry, hs, kept, dhs, dlast)
            ms = _time_ms(lambda: slstm_scan_bwd(*ins), iters=20)
            call_ms = _time_ms(lambda: slstm_scan_bwd(*ins), iters=20,
                               run_ahead=False)
            plain_ms = _time_ms(lambda: slstm_scan_bwd_plain(*ins), iters=1,
                                warmup=1, run_ahead=False)
            rows["bwd"] = {"case": "train_bwd", "dtype": "float32",
                           "shape": [b, s, d], "ms": ms, "call_ms": call_ms,
                           "plain_ms": plain_ms, "library_ms": None,
                           **_slstm_bwd_bound(b, s, d, torch.float32),
                           "ns_per_step": ms * 1e6 / s}
    for row in rows.values():
        print(f"[time] slstm_scan {row}", flush=True)
    report["slstm_scan_timing"] = rows
    return rows


# -- AdamW's update and gradient norm (csrc/adamw.cu) -----------------------------
# (param dtype, gradient dtype) of the checks: float32 (no master copy),
# bfloat16 with a float32 master copy, bfloat16 params with float32
# gradients (the dry-run's accumulation step)
ADAMW_KINDS = {"float32": ("float32", "float32"),
               "bfloat16": ("bfloat16", "bfloat16"),
               "bfloat16_f32_grads": ("bfloat16", "float32")}
# the checks' leaves: one element, less than a chunk of 8, a ragged length
# whose tensors all lie off 16 bytes (ADAMW_OFF16, its index), 2^24 + 3
ADAMW_SIZES = (1, 7, 4097, (1 << 24) + 3)
ADAMW_OFF16 = 2
ADAMW_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
ADAMW_NORM_TOL = 1e-6     # the norm kernel against a float64 sum, relative
ADAMW_GRAD_SCALE = 1e-4   # the timed trees' gradients: N(0, 1) x this
# the configuration whose whole tree heads the AdamW row: the largest
ADAMW_HEADLINE = "train:stablelm-3bx32:bfloat16"


def _adamw_state(kind: str, seed: int):
    """(params, opt_state) over ``ADAMW_SIZES``' leaves in ``kind``'s param
    dtype: N(0, 1) weights, moments as after a few steps; the
    ``ADAMW_OFF16`` leaf's tensors off 16 bytes."""
    import torch
    from repro_torch.optim import init_opt_state
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    pdt = getattr(torch, ADAMW_KINDS[kind][0])
    params = [torch.randn(n, generator=g, device=DEVICE).to(pdt)
              for n in ADAMW_SIZES]
    state = init_opt_state(params)
    state["m"] = [torch.randn(n, generator=g, device=DEVICE) * 1e-3
                  for n in ADAMW_SIZES]
    state["v"] = [torch.rand(n, generator=g, device=DEVICE) * 1e-6
                  for n in ADAMW_SIZES]
    for tree in (params, *(state[k] for k in ("m", "v", "master")
                           if k in state)):
        tree[ADAMW_OFF16] = _off16(tree[ADAMW_OFF16])
    return params, state


def _adamw_grads(kind: str, scale: float, seed: int):
    import torch
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    gdt = getattr(torch, ADAMW_KINDS[kind][1])
    grads = [(torch.randn(n, generator=g, device=DEVICE) * scale).to(gdt)
             for n in ADAMW_SIZES]
    grads[ADAMW_OFF16] = _off16(grads[ADAMW_OFF16])
    return grads


def _same_bits(a, b) -> bool:
    import torch
    return all(torch.equal(_bits(x), _bits(y))
               for x, y in zip(_leaves(a), _leaves(b)))


def _max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(_leaves(a), _leaves(b)))


def _adamw_scalars(cfg, grads):
    """The step-1 scalars ``apply_updates`` hands a leaf, the clip factor
    from the norm kernel's norm of ``grads``: (lr, scale, b1c, b2c)."""
    import torch
    from repro_torch.kernels import adamw
    from repro_torch.optim import schedule
    step = torch.ones((), dtype=torch.int32, device=DEVICE)
    gnorm = adamw.global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    return (schedule(cfg, step), scale, 1 - cfg.b1 ** step.to(torch.float32),
            1 - cfg.b2 ** step.to(torch.float32))


def _adamw_consts(cfg) -> dict:
    return dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                weight_decay=cfg.weight_decay)


def check_adamw(report: dict) -> float:
    """The update and norm kernels against their plain versions on the
    card, for each of ``ADAMW_KINDS`` over ``ADAMW_SIZES``' leaves: 2 steps
    of ``apply_updates`` with the clip not binding (its factor exactly 1.0,
    whatever the norm's bits) bit for bit ``apply_updates_plain``'s (params,
    moments, master copy), one update launch a leaf, the norm's pass a leaf
    and one finalize a step, and a second run from the same state bit for
    bit the first; with the clip binding (gradients N(0, 1)), each leaf's
    update on the same scalars bit for bit the plain one's; the norm within
    ``ADAMW_NORM_TOL`` of the gradients' float64 sum, the eager norm's
    distance beside it.  Returns the largest difference from the plain
    version (0.0: bit for bit)."""
    import torch
    from repro_torch.kernels import adamw
    from repro_torch.optim import AdamWConfig, apply_updates
    from repro_torch.optim.adamw import apply_updates_plain, tree_map
    cfg = AdamWConfig(**ADAMW_OPT)
    clone = lambda tree: tree_map(      # off 16 bytes where the original is
        lambda t: _off16(t) if t.data_ptr() % 16 else t.clone(), tree)
    moved = lambda st: {k: st[k] for k in st if k != "step"}
    rows, worst = [], 0.0
    for kind in ADAMW_KINDS:
        params, state = _adamw_state(kind, 0)
        runs = []
        for fn in (apply_updates, apply_updates, apply_updates_plain):
            p, st = clone(params), clone(state)
            before = (adamw.launches.count, adamw.norm_launches.count)
            norms = [float(fn(p, _adamw_grads(kind, 1e-5, 10 + i), st,
                              cfg)[2]["grad_norm"]) for i in range(2)]
            torch.cuda.synchronize()
            runs.append((p, st, norms, [
                adamw.launches.count - before[0],
                adamw.norm_launches.count - before[1]]))
        (pk, sk, nk, lk), (pk2, sk2, _, _), (pp, sp, _, lp) = runs
        n = len(ADAMW_SIZES)
        grads = _adamw_grads(kind, 1.0, 20)
        scalars = _adamw_scalars(cfg, grads)
        clipped = {}                        # the clip binding
        for name, update in (("kernel", adamw.update),
                             ("plain", adamw.update_plain)):
            p, st = clone(params), clone(state)
            masters = st.get("master", p)
            with torch.no_grad():
                for i in range(n):
                    update(p[i], masters[i], grads[i], st["m"][i],
                           st["v"][i], *scalars, **_adamw_consts(cfg))
            clipped[name] = (p, moved(st))
        want = torch.sqrt(sum(torch.sum(torch.square(g.double()))
                              for g in grads))
        norm_rel = {name: float(abs(fn(grads).double() - want) / want)
                    for name, fn in (("kernel", adamw.global_norm),
                                     ("eager", adamw.global_norm_plain))}
        row = {"kind": kind, "sizes": list(ADAMW_SIZES),
               "off16_leaf": ADAMW_SIZES[ADAMW_OFF16],
               "unclipped_norms": nk,
               "unclipped_bit_for_bit": (_same_bits(pk, pp)
                                         and _same_bits(moved(sk), moved(sp))),
               "repeat_bit_for_bit": (_same_bits(pk, pk2)
                                      and _same_bits(moved(sk), moved(sk2))),
               "clipped_scale": float(scalars[1]),
               "clipped_bit_for_bit": (
                   _same_bits(clipped["kernel"][0], clipped["plain"][0])
                   and _same_bits(clipped["kernel"][1], clipped["plain"][1])),
               "launches": lk, "plain_launches": lp,
               "norm_rel_err": norm_rel["kernel"],
               "eager_norm_rel_err": norm_rel["eager"],
               "max_abs_err": max(_max_diff(pk, pp),
                                  _max_diff(moved(sk), moved(sp)),
                                  _max_diff(clipped["kernel"][0],
                                            clipped["plain"][0]))}
        row["ok"] = (row["unclipped_bit_for_bit"] and row["repeat_bit_for_bit"]
                     and row["clipped_bit_for_bit"] and max(nk) < cfg.clip_norm
                     and row["clipped_scale"] < 1.0
                     and lk == [2 * n, 2 * (n + 1)] and lp == [0, 0]
                     and norm_rel["kernel"] <= ADAMW_NORM_TOL)
        rows.append(row)
        print(f"[check] adamw {row}", flush=True)
        _require(row["ok"], f"AdamW kernels against the eager update: {row}")
        worst = max(worst, row["max_abs_err"])
        del params, state, runs, clipped, grads
    report["adamw_checks"] = rows
    return worst


def _train_cfg(run: dict):
    """A phase-8 run's model: full width, in the run's dtype, at its
    depth."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(run["arch"]), dtype=run["dtype"])
    if run["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=run["layers"])
    return cfg


def _fused_adamw_ms(p32, g32, m, v, cfg) -> float:
    """``torch._fused_adamw_`` over float32 leaves, timed: the yardstick
    for scale only, another function (it decays the weight before the step
    and keeps no master copy)."""
    import torch
    steps = [torch.ones((), device=DEVICE) for _ in p32]
    return _time_ms(lambda: torch._fused_adamw_(
        p32, g32, m, v, [], steps, lr=cfg.lr, beta1=cfg.b1, beta2=cfg.b2,
        weight_decay=cfg.weight_decay, eps=cfg.eps, amsgrad=False,
        maximize=False), iters=3, warmup=1)


def _time_adamw_leaf(cfg, opt) -> dict:
    """The update kernel at the model's largest leaf alone (N(0, 1)
    weights and gradients, moments as after a few steps), checked bit for
    bit against the plain version on the same scalars (the clip binding),
    then timed beside the plain version and the fused yardstick over its
    float32 leaves; the bound of the update's bytes."""
    import torch
    from repro_torch.kernels import adamw, work
    from repro_torch.models import init_params
    shape = max((t.shape for t in _leaves(init_params(cfg, device="meta"))),
                key=lambda sh: math.prod(sh))
    pdt = getattr(torch, cfg.dtype)
    master = pdt != torch.float32
    g = torch.Generator(device=DEVICE)
    g.manual_seed(7)
    rn = lambda: torch.randn(shape, generator=g, device=DEVICE)
    p = rn().to(pdt)
    p32 = p.float() if master else p
    grad = rn().to(pdt)
    m, v = rn() * 1e-3, torch.rand(shape, generator=g, device=DEVICE) * 1e-6
    scalars = _adamw_scalars(opt, [grad])
    consts = _adamw_consts(opt)
    p_, m_, v_ = p.clone(), m.clone(), v.clone()
    p32_ = p32.clone() if master else p_
    with torch.no_grad():
        adamw.update(p, p32, grad, m, v, *scalars, **consts)
        adamw.update_plain(p_, p32_, grad, m_, v_, *scalars, **consts)
    same = _same_bits([p, p32, m, v], [p_, p32_, m_, v_])
    del p_, p32_, m_, v_
    torch.cuda.empty_cache()
    _require(same, f"the AdamW kernel at {cfg.name}'s largest leaf "
                   f"{list(shape)} against the plain version")
    n = math.prod(shape)
    nbytes = work.adamw_work(n, pdt, pdt, master)[1]
    with torch.no_grad():
        ms = _time_ms(lambda: adamw.update(p, p32, grad, m, v, *scalars,
                                           **consts), iters=5, warmup=1)
        plain_ms = _time_ms(lambda: adamw.update_plain(
            p, p32, grad, m, v, *scalars, **consts), iters=2, warmup=1)
    del p
    g32 = grad.float() if master else grad
    del grad
    fused_ms = _fused_adamw_ms([p32], [g32], [m], [v], opt)
    return {"shape": list(shape), "elements": n, "bit_for_bit": same,
            "ms": ms, "plain_ms": plain_ms, "library_ms": fused_ms,
            "bytes": nbytes, **dict(zip(("bound_ms", "bound_by"),
                                        work.bound({}, nbytes))),
            "tb_per_s": nbytes / (ms * 1e-3) / 1e12}


def _time_adamw_tree(cfg, opt) -> dict:
    """``apply_updates`` (the norm and the update kernels) over the model's
    whole tree (``init_params`` seed 0, gradients N(0, 1) x
    ``ADAMW_GRAD_SCALE`` in the params' dtype) beside the eager update
    (``apply_updates_plain``), in turns (kernel, plain, plain, kernel; one
    call each: each moves the state), the bound of the bytes they need,
    each norm against the float64 sum; then the fused yardstick over the
    float32 leaves (the master copy, or the float32 params) with float32
    gradients."""
    import torch
    from repro_torch.kernels import adamw, work
    from repro_torch.models import init_params
    from repro_torch.optim import apply_updates, init_opt_state
    from repro_torch.optim.adamw import apply_updates_plain, tree_map
    params = init_params(cfg, seed=0, device=DEVICE)
    state = init_opt_state(params)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    draw = lambda p, dtype: (torch.randn(p.shape, generator=g, device=DEVICE)
                             * ADAMW_GRAD_SCALE).to(dtype)
    grads = tree_map(lambda p: draw(p, p.dtype), params)
    master = "master" in state
    pairs = list(zip(_leaves(params), _leaves(grads)))
    nbytes = sum(work.adamw_work(p.numel(), p.dtype, gr.dtype, master)[1]
                 for p, gr in pairs) + work.adamw_norm_work(
        [(gr.numel(), gr.dtype) for _, gr in pairs])[1]
    calls = {"kernel": lambda: apply_updates(params, grads, state, opt),
             "plain": lambda: apply_updates_plain(params, grads, state, opt)}
    calls["kernel"]()
    ms = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        ms[name].append(_time_ms(calls[name], iters=1, warmup=0))
    flat = list(_leaves(grads))
    want = torch.sqrt(sum(torch.sum(torch.square(t.double())) for t in flat))
    norm_rel = {name: float(abs(fn(flat).double() - want) / want)
                for name, fn in (("kernel", adamw.global_norm),
                                 ("eager", adamw.global_norm_plain))}
    out = {"params_b": sum(p.numel() for p, _ in pairs) / 1e9,
           "leaves": len(pairs), "ms_runs": ms, "ms": min(ms["kernel"]),
           "plain_ms": min(ms["plain"]), "bytes": nbytes,
           **dict(zip(("bound_ms", "bound_by"), work.bound({}, nbytes))),
           "norm_rel_err": norm_rel["kernel"],
           "eager_norm_rel_err": norm_rel["eager"]}
    out["tb_per_s"] = nbytes / (out["ms"] * 1e-3) / 1e12
    _require(norm_rel["kernel"] <= ADAMW_NORM_TOL,
             f"{cfg.name}'s gradient norm against its float64 sum: {out}")
    weights = list(_leaves(state["master"] if master else params))
    del flat, grads, pairs, calls
    if master:                 # room for the float32 gradients
        del params
    g32 = [draw(w, torch.float32) for w in weights]
    out["library_ms"] = _fused_adamw_ms(weights, g32, list(_leaves(state["m"])),
                                        list(_leaves(state["v"])), opt)
    return out


def time_adamw(report: dict) -> dict:
    """For each phase-8 configuration (``TRAIN_RUNS``, ``TRAIN_PREFIXED``):
    the update kernel at its largest leaf (``_time_adamw_leaf``) and the
    norm and update kernels over its whole tree (``_time_adamw_tree``),
    each beside the plain version, the fused yardstick and the bound."""
    import gc
    import torch
    from repro_torch.optim import AdamWConfig
    rows = {}
    for run in (*TRAIN_RUNS, *TRAIN_PREFIXED):
        cfg = _train_cfg(run)
        opt = AdamWConfig(lr=run["lr"], warmup_steps=TRAIN_WARMUP,
                          total_steps=run["steps"])
        key = _train_key({"arch": cfg.name, "layers": cfg.n_layers,
                          "dtype": cfg.dtype})
        t0 = time.perf_counter()
        rows[key] = {"leaf": _time_adamw_leaf(cfg, opt)}
        gc.collect()
        torch.cuda.empty_cache()
        rows[key]["tree"] = _time_adamw_tree(cfg, opt)
        gc.collect()
        torch.cuda.empty_cache()
        rows[key]["seconds"] = time.perf_counter() - t0
        print(f"[time] adamw {key} {rows[key]}", flush=True)
    report["adamw_timing"] = rows
    return rows


def _randn(shape, dtype, seed):
    import torch
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=DEVICE).to(dtype)


def _rel_err(got, want) -> float:
    """The largest ``|got - want| / (1 + |want|)``."""
    want = want.float()
    err = (got.float() - want).abs() / (1.0 + want.abs())
    return float(err.max()) if err.numel() else 0.0


def _close(got, want, tol) -> tuple[bool, float]:
    """``|got - want| <= tol * (1 + |want|)`` everywhere, finite; and the
    largest absolute error."""
    import torch
    err = (got.float() - want.float()).abs()
    ok = (bool((err <= tol * (1.0 + want.float().abs())).all())
          and bool(torch.isfinite(got).all()) and got.dtype == want.dtype
          and got.shape == want.shape)
    return ok, float(err.max()) if err.numel() else 0.0


# (m, k, n): the node path's 4096^3 first, the JAX sweep's aligned shapes,
# then ragged M, N and K, a 1 x 1 x 1 and an empty K (these five take the
# general kernel), then two whose M, N and K edges the fast paths' TMA or
# cp.async loads fill with zeros
MATMUL_CASES = [(4096, 4096, 4096), (128, 128, 128), (256, 384, 128),
                (512, 256, 256), (128, 512, 384), (130, 200, 70),
                (37, 513, 129), (300, 1000, 77), (1, 1, 1), (64, 0, 32),
                (300, 512, 200), (37, 4096, 264)]


def check_matmul(report: dict) -> float:
    """Kernel against its plain version on the card, at 2e-4 (float32) and
    2e-2 (bfloat16) x (1 + |c|), on inputs N(0, 1) x K^-1/4.  The scale
    keeps the partial sums of order one, as the reference's 2e-4 assumed
    (its sweep has K <= 512): with N(0, 1) inputs at K = 4096 they reach
    ~64, and the kernel's float32 sum in k order then differs from the
    plain version's blocked sums by up to ~1e-3 where c is near 0 (an
    error of ~1.6e-5 of the partial sums' size).  Each case names the
    kernel it took and checks that path's counter; every path must be
    taken.  Returns the largest error in each dtype at the node path's
    shape."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.matmul import (matmul_path, matmul_plain,
                                            path_launches)
    worst, rows = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, (m, k, n) in enumerate(MATMUL_CASES):
            scale = max(k, 1) ** -0.25
            a = _randn((m, k), torch.float32, 2 * i).mul_(scale).to(dtype)
            b = _randn((k, n), torch.float32, 2 * i + 1).mul_(scale).to(dtype)
            path = matmul_path(a, b)
            before = path_launches[path].count
            got = ops.matmul(a, b)
            torch.cuda.synchronize()
            ok, err = _close(got, matmul_plain(a, b), TOL[name])
            ok = ok and path_launches[path].count == before + 1
            row = {"dtype": name, "path": path, "mkn": [m, k, n],
                   "max_abs_err": err, "tol": TOL[name], "ok": ok}
            rows.append(row)
            print(f"[check] matmul {row}", flush=True)
            _require(ok, f"matmul kernel against its plain version: {row}")
            if (m, k, n) == MATMUL_CASES[0]:
                worst[name] = err
    _require({r["path"] for r in rows} == set(path_launches),
             "matmul checks took every path")
    report["matmul_checks"] = rows
    return worst


COPY_CASES = [(8192, 8192), (512, 1024), (1000, 77), (12345,), (3, 5, 7),
              ()]


def _copy_edge_bytes() -> list[int]:
    """uint8 sizes at the bulk copy ring's edges: one byte under one stage,
    exactly one stage, one stage and one 16-byte word, and a size that is
    not a multiple of 16 bytes."""
    from repro_torch.kernels.copy import stage_bytes
    stage = stage_bytes()
    return [stage - 1, stage, stage + 16, 3 * stage + 5]


def check_copy(report: dict) -> float:
    """Kernel against its plain version on the card, bit for bit, in
    float32, bfloat16 and int32, at the node path's [8192, 8192], aligned,
    ragged (a byte count that is not a multiple of 16) and 0-d shapes, and
    from a view that does not start on a 16-byte boundary.  The output is
    a fresh buffer: another address, and writing to it leaves x as it
    was.  Then uint8 at the bulk copy ring's edges (``_copy_edge_bytes``).
    Returns 0.0, the error of a run in which every case is exact."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.copy import copy_plain
    rows = []

    def check(x, shape_label):
        got = ops.copy(x)
        torch.cuda.synchronize()
        want = copy_plain(x)
        ok = (torch.equal(got, want) and torch.equal(got, x)
              and got.dtype == x.dtype and got.data_ptr() != x.data_ptr())
        if ok:
            got.zero_()                       # the input must not move
            ok = torch.equal(x, want)
        row = {"dtype": str(x.dtype).removeprefix("torch."),
               "shape": shape_label, "x_mod_16": x.data_ptr() % 16,
               "exact": ok}
        rows.append(row)
        print(f"[check] copy {row}", flush=True)
        _require(ok, f"copy kernel against its plain version: {row}")

    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        for i, shape in enumerate(COPY_CASES):
            check((_randn(shape, torch.float32, 40 + i) * 1000).to(dtype),
                  list(shape))
        base = _randn((1 + 4099,), torch.float32, 50) * 1000
        check(base.to(dtype)[1:], "offset 1, [4099]")  # contiguous, 1 in
    g = torch.Generator(device=DEVICE)
    g.manual_seed(41)
    for n in _copy_edge_bytes():
        check(torch.randint(0, 256, (n,), generator=g, device=DEVICE,
                            dtype=torch.uint8), [n])
    report["copy_checks"] = rows
    return 0.0


STENCIL_CASES = [(1, 2048, 2048), (8, 4096, 4096), (2, 512, 256),
                 (1, 128, 128), (2, 100, 70), (1, 33, 65), (4, 31, 129),
                 (3, 1, 1)]
STENCIL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def check_stencil(report: dict) -> float:
    """Kernel against its plain version and the dense oracle on the card,
    at 1e-5 (float32, the reference's tolerance) and 2e-2 (bfloat16: the
    oracle sums in bfloat16, the kernel in float32) x (1 + |out|), at the
    node path's [1, 2048, 2048], the timing shape past L2, aligned and
    ragged shapes.  Returns the largest float32 error against the plain
    version."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.stencil import stencil_plain
    worst, rows = 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, shape in enumerate(STENCIL_CASES):
            if dtype == torch.bfloat16 and shape == (8, 4096, 4096):
                continue
            u = _randn(shape, dtype, 60 + i)
            got = ops.stencil(u)
            torch.cuda.synchronize()
            ok, err = _close(got, stencil_plain(u), STENCIL_TOL[name])
            ok_ref, err_ref = _close(got, ref.stencil_ref(u), STENCIL_TOL[name])
            row = {"dtype": name, "shape": list(shape), "max_abs_err": err,
                   "max_abs_err_ref": err_ref, "tol": STENCIL_TOL[name],
                   "ok": ok and ok_ref}
            rows.append(row)
            print(f"[check] stencil {row}", flush=True)
            _require(ok and ok_ref,
                     f"stencil kernel against its plain version: {row}")
            if name == "float32":
                worst = max(worst, err)
    # the Dirichlet edge: ones give 0.5 in a corner, 0.75 on an edge, 1 inside
    ones = ops.stencil(torch.ones((1, 128, 128), device=DEVICE))
    _require([float(ones[0, 0, 0]), float(ones[0, 0, 64]),
              float(ones[0, 64, 64])] == [0.5, 0.75, 1.0],
             "stencil Dirichlet boundary")
    report["stencil_checks"] = rows
    return worst


def _timing_row(kernel, plain, library, flops, nbytes, dtype_name, *,
                iters, plain_iters=1, **extra) -> dict:
    ms = _time_ms(kernel, iters=iters)
    plain_ms = _time_ms(plain, iters=plain_iters, warmup=1, run_ahead=False)
    lib_ms = _time_ms(library, iters=iters)
    bound_ms, bound_by = bound({dtype_name: flops}, nbytes)
    return {"dtype": dtype_name, **extra, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_over_bound": ms / bound_ms}


def time_matmul(report: dict) -> list[dict]:
    """Kernel, plain version, ``torch.matmul`` (cuBLAS, no TF32) and the
    bound at the node path's 4096^3, float32 (the pipelined FMA path) and
    bfloat16 (the wgmma path)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.matmul import matmul_path, matmul_plain
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        m = k = n = NODE_TILES["matmul"]
        a, b = _randn((m, k), dtype, 90), _randn((k, n), dtype, 91)
        row = _timing_row(lambda: ops.matmul(a, b), lambda: matmul_plain(a, b),
                          lambda: torch.matmul(a, b), 2 * m * n * k,
                          (m * k + k * n + m * n) * dtype.itemsize, name,
                          iters=10, shape=[m, k, n],
                          path=matmul_path(a, b))
        row["tflops"] = 2 * m * n * k / (row["ms"] * 1e-3) / 1e12
        rows.append(row)
        print(f"[time] matmul {row}", flush=True)
    report["matmul_timing"] = rows
    return rows


def time_copy(report: dict) -> list[dict]:
    """Kernel, plain version, ``Tensor.clone`` and the bound (bytes: read
    once, written once) at the node path's [8192, 8192] float32, 10x the
    L2."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.copy import copy_plain
    t = NODE_TILES["copy"]
    x = _randn((t, t), torch.float32, 92)
    row = _timing_row(lambda: ops.copy(x), lambda: copy_plain(x), x.clone,
                      0, 2 * x.numel() * 4, "float32", iters=20,
                      plain_iters=3, shape=[t, t])
    row["tb_per_s"] = 2 * x.numel() * 4 / (row["ms"] * 1e-3) / 1e12
    print(f"[time] copy {row}", flush=True)
    report["copy_timing"] = [row]
    return [row]


def time_stencil(report: dict) -> list[dict]:
    """Kernel, plain version, ``F.conv2d`` with the 3 x 3 cross (cuDNN, no
    TF32) and the bound (4 operations a point; bytes read once, written
    once), float32: at [8, 4096, 4096] (1.07 GB moved, past the 50 MB L2:
    the row the bound speaks for) and at the node path's [1, 2048, 2048],
    which stays in L2 when swept again and again, so its bound is no
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.stencil import stencil_plain
    cross = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                          [0.0, 0.25, 0.0]], device=DEVICE)[None, None]
    rows = []
    for shape, resident in (((8, 4096, 4096), False),
                            ((1, NODE_TILES["stencil"],
                              NODE_TILES["stencil"]), True)):
        u = _randn(shape, torch.float32, 93)
        row = _timing_row(lambda: ops.stencil(u), lambda: stencil_plain(u),
                          lambda: F.conv2d(u[:, None], cross, padding=1),
                          4 * u.numel(), 2 * u.numel() * 4, "float32",
                          iters=20, shape=list(shape), l2_resident=resident)
        row["tb_per_s"] = 2 * u.numel() * 4 / (row["ms"] * 1e-3) / 1e12
        rows.append(row)
        print(f"[time] stencil {row}", flush=True)
    report["stencil_timing"] = rows
    return rows


# -- the node path: the paper's node kernels as task payloads -----------------
# Sizes follow what each node is for (a type's ``tile`` is its payload's
# size, as core/task.py defines it): a 4096^3 float32 GEMM, far above the
# ridge; a [8192, 8192] float32 copy, 10x the L2; a [1, 2048, 2048] float32
# grid, resident in L2.
NODE_TILES = {"matmul": 4096, "copy": 8192, "stencil": 2048}
NODE_TASKS, NODE_PARALLELISM = 96, 4
STENCIL_SWEEPS = 4     # stencil_type's cost: 4 sweeps a task


def node_inputs(tiles: dict, seed: int = 0) -> dict:
    """Each node type's inputs as numpy float32 arrays, made once from
    ``seed``: N(0, 1), the matmul's scaled by K^-1/4 (see
    :func:`check_matmul`)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t_mm, t_cp, t_st = tiles["matmul"], tiles["copy"], tiles["stencil"]
    normal = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    scale = np.float32(t_mm ** -0.25)
    return {"matmul": (normal(t_mm, t_mm) * scale, normal(t_mm, t_mm) * scale),
            "copy": (normal(t_cp, t_cp),),
            "stencil": (normal(1, t_st, t_st),)}


def node_work(kind: str, inputs):
    """One task's work through the port's ops: a matmul or a copy is one
    launch; a stencil task is ``STENCIL_SWEEPS`` Jacobi sweeps, each
    reading the buffer the last one wrote (two buffers alive at a time)."""
    from repro_torch.kernels import ops
    if kind == "matmul":
        return ops.matmul(*inputs)
    if kind == "copy":
        return ops.copy(*inputs)
    u = inputs[0]
    for _ in range(STENCIL_SWEEPS):
        u = ops.stencil(u)
    return u


def run_node_dag(tiles: dict, device, *, slowdown=SLOW_PLACE, seed=0,
                 timeout: float = 300.0, sched=None):
    """``mixed_dag`` of the matmul, copy and stencil types (96 tasks, 4 a
    layer, the first of each layer HIGH) on the port's threaded runtime:
    ``tpu_pod_slices(2, 2)`` under DAM-C (or the scheduler ``sched``), with
    ``slowdown`` injected.
    Every task's payload runs its kernel on the type's inputs and, on the
    card, returns when the card has finished (so the PTT learns card
    time).  Returns (metrics, scheduler, {kind: [output of each task]},
    {kind: inputs on ``device``}, {type name: kind})."""
    import torch
    from repro_torch.core import (copy_type, make_scheduler, matmul_type,
                                  mixed_dag, run_threaded, stencil_type,
                                  tpu_pod_slices)
    device = torch.device(device)
    inputs = {kind: tuple(torch.from_numpy(a).to(device) for a in arrays)
              for kind, arrays in node_inputs(tiles, seed).items()}
    types = {"matmul": matmul_type(tiles["matmul"]),
             "copy": copy_type(tiles["copy"]),
             "stencil": stencil_type(tiles["stencil"])}
    kind_of = {t.name: kind for kind, t in types.items()}
    outputs = {kind: [] for kind in types}

    def payload(width, kind):
        out = node_work(kind, inputs[kind])
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        outputs[kind].append(out)

    if sched is None:
        sched = make_scheduler("DAM-C", tpu_pod_slices(2, 2), seed=seed)
    dag = mixed_dag(list(types.values()), parallelism=NODE_PARALLELISM,
                    total_tasks=NODE_TASKS)
    for task in dag.all_tasks():
        task.payload, task.args = payload, (kind_of[task.type.name],)
    metrics = run_threaded(dag, sched, slowdown=slowdown, timeout=timeout)
    return metrics, sched, outputs, inputs, kind_of


def _counted_node_run(sched=None) -> dict:
    """One run of the node DAG on the card (under ``sched``, if given),
    the launch counts set to 0 just before it and read just after, held to
    the node path's checks: every task commits, each kernel's launches
    equal its tasks (the stencil's 4 a task), every matmul takes the
    pipelined float32 kernel, the outputs of a type are equal and agree
    with the plain version.  Returns the run's pieces by name."""
    import torch
    from repro_torch.kernels import copy, matmul, stencil
    from repro_torch.kernels.copy import copy_plain
    from repro_torch.kernels.matmul import matmul_plain
    from repro_torch.kernels.stencil import stencil_plain
    counters = {"matmul": matmul.launches, "copy": copy.launches,
                "stencil": stencil.launches}
    mm_paths = matmul.path_launches
    for c in (*counters.values(), *mm_paths.values()):
        c.reset()
    t0 = time.perf_counter()
    metrics, sched, outputs, inputs, kind_of = run_node_dag(
        NODE_TILES, DEVICE, sched=sched)
    wall = time.perf_counter() - t0
    n_launch = {name: c.count for name, c in counters.items()}
    n_mm_path = {path: c.count for path, c in mm_paths.items()}

    _require(not metrics.errors, f"node DAG payload errors: {metrics.errors}")
    _require(metrics.n_tasks == NODE_TASKS,
             f"node DAG committed {metrics.n_tasks} of {NODE_TASKS} tasks")
    n_tasks = {kind: len(outs) for kind, outs in outputs.items()}
    want = {"matmul": n_tasks["matmul"], "copy": n_tasks["copy"],
            "stencil": STENCIL_SWEEPS * n_tasks["stencil"]}
    _require(n_launch == want and sum(n_tasks.values()) == NODE_TASKS,
             f"node DAG launches {n_launch}, want {want} for tasks "
             f"{n_tasks}")
    _require(n_mm_path["fma_pipelined"] == n_launch["matmul"],
             f"node DAG matmul paths {n_mm_path}: every float32 4096^3 "
             f"product should take the pipelined FMA kernel")

    # same inputs and a deterministic kernel: every output of a type equal;
    # the first against the plain version
    for kind, outs in outputs.items():
        _require(all(torch.equal(o, outs[0]) for o in outs[1:]),
                 f"node DAG: the {kind} outputs differ between tasks")
    x = inputs["stencil"][0]
    for _ in range(STENCIL_SWEEPS):
        x = stencil_plain(x)
    agree = {"matmul": _close(outputs["matmul"][0],
                              matmul_plain(*inputs["matmul"]), TOL["float32"]),
             "copy": (torch.equal(outputs["copy"][0],
                                  copy_plain(*inputs["copy"])), 0.0),
             "stencil": _close(outputs["stencil"][0], x,
                               STENCIL_TOL["float32"])}
    for kind, (ok, err) in agree.items():
        _require(ok, f"node DAG {kind} output against the plain version: "
                     f"max abs err {err}")
    return {"metrics": metrics, "sched": sched, "outputs": outputs,
            "inputs": inputs, "kind_of": kind_of, "wall": wall,
            "launches": n_launch, "mm_paths": n_mm_path, "agree": agree,
            "tasks_by_type": n_tasks}


def node_dag(report: dict) -> dict:
    """The node path on the card: a warm-up run of the DAG (it fills the
    allocator's cache with the outputs' blocks), then the counted run
    (``_counted_node_run``)."""
    import statistics
    import torch
    warm, *_ = run_node_dag(NODE_TILES, DEVICE)
    _require(warm.n_tasks == NODE_TASKS and not warm.errors,
             f"warm-up node DAG: {warm.n_tasks} tasks, {warm.errors}")
    del warm, _
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    run = _counted_node_run()
    metrics, sched, kind_of = run["metrics"], run["sched"], run["kind_of"]
    n_tasks, n_launch, agree = (run["tasks_by_type"], run["launches"],
                                run["agree"])

    def unslowed(r):
        return not any(c in SLOW_PLACE for c in range(r.leader,
                                                      r.leader + r.width))
    median_ms = {}
    for name, kind in kind_of.items():
        ds = [r.duration for r in metrics.records
              if r.type_name == name and unslowed(r)]
        median_ms[kind] = 1e3 * statistics.median(ds) if ds else None
    high = [r for r in metrics.records if r.priority == 1]
    ptt = {kind: {repr(p): sched.ptt.for_type(name).get(p) * 1e3
                  for p in sched.topology.places()}
           for name, kind in kind_of.items()}
    out = {
        "tiles": NODE_TILES, "tasks": NODE_TASKS,
        "parallelism": NODE_PARALLELISM, "scheduler": "DAM-C",
        "slowdown": {str(k): v for k, v in SLOW_PLACE.items()},
        "committed": metrics.n_tasks, "tasks_by_type": n_tasks,
        "makespan_s": metrics.makespan, "wall_with_inputs_s": run["wall"],
        "tasks_per_s": metrics.throughput,
        "median_task_ms_unslowed": median_ms,
        "high_share_on_slowed_place": (sum(not unslowed(r) for r in high)
                                       / len(high)),
        "high_placement": metrics.priority_placement(),
        "placement_counts": metrics.placement_counts(),
        "ptt_ms": ptt, "launches": n_launch,
        "matmul_launches_by_path": run["mm_paths"],
        "plain_agreement_max_abs_err": {k: v[1] for k, v in agree.items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"[node_dag] {out}", flush=True)
    del run
    torch.cuda.empty_cache()
    report["node_dag"] = out
    return out


def _launches_per_prefill(cfg) -> dict:
    """Kernel launches one prefill makes, from the model's layer plan (a
    replay of the engine's prefill graph adds the launches its capture
    counted: the same)."""
    from repro_torch.models import layer_plan
    plan = layer_plan(cfg)
    return {"flash_attention": sum(k in ("attn", "attn_moe", "shared_attn")
                                   for k in plan),
            "ssd_scan": plan.count("mamba2") + 2 * plan.count("mlstm"),
            "slstm_scan": plan.count("slstm")}


def _launches_per_decode(cfg) -> dict:
    """Kernel launches one decode step makes: the sLSTM scan once per sLSTM
    layer (S = 1 from the request's carry); attention, Mamba-2 and mLSTM
    decode in plain torch, as the reference's.  A replay of the engine's
    decode graph adds the launches its capture counted."""
    from repro_torch.models import layer_plan
    return {"flash_attention": 0, "ssd_scan": 0,
            "slstm_scan": layer_plan(cfg).count("slstm")}


def serve(report: dict, cfg) -> dict:
    """The main path: the model of ``cfg`` through the port's engine."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import tpu_pod_slices
    from repro_torch.kernels import flash_attention, slstm_scan, ssd_scan
    from repro_torch.models import prefill
    from repro_torch.serve import ServingEngine
    from repro_torch.serve.engine import _bucket
    from repro_torch.serve.prefill_graph import prefill_buckets

    counters = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches,
                "slstm_scan": slstm_scan.launches}
    flash_paths = flash_attention.path_launches

    max_len = max(PROMPT_LENS) + NEW_TOKENS
    topo = tpu_pod_slices(2, 2)
    torch.cuda.reset_peak_memory_stats()     # the engine's own, captures in
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, topo, scheduler="DAM-C",
                           max_len=max_len, slowdown=SLOW_PLACE, seed=0,
                           device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(engine.params))
    graphs = engine.decode_graph_stats()
    _require(graphs["captures"] == graphs["slots"] == topo.n_cores,
             f"{cfg.name}: one decode graph captured a worker thread "
             f"({topo.n_cores}): {graphs}")
    print(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B params initialised on "
          f"the card in {init_s:.2f} s, {graphs['slots']} decode graphs "
          f"captured in {sum(graphs['capture_s']):.2f} s, holding "
          f"{[round(b / 2**20, 1) for b in graphs['device_bytes']]} MiB "
          f"(state {graphs['state_bytes'][0] / 2**20:.1f} MiB, graph pools "
          f"{[round(b / 2**20, 1) for b in graphs['pool_bytes']]} MiB)",
          flush=True)
    pre = engine.prefill_graph_stats()
    want_buckets = prefill_buckets(max_len, _bucket)
    _require(pre["buckets"] == want_buckets
             and pre["captures"] == len(want_buckets) and pre["steps"] == 0,
             f"{cfg.name}: one prefill graph captured a bucket "
             f"{want_buckets} before the run: {pre}")
    print(f"[serve] {cfg.name}: prefill graphs of buckets {pre['buckets']} "
          f"captured in {[round(t, 3) for t in pre['capture_s']]} s, pools "
          f"{[round(b / 2**20, 1) for b in pre['pool_bytes']]} MiB, states "
          f"{pre['state_bytes'][0] / 2**20:.1f} MiB each; card memory after "
          f"the captures {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({report.get('nvidia_smi', '')})", flush=True)
    peak_init_gb = torch.cuda.max_memory_allocated() / 1e9

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in PROMPT_LENS]
    # warm-up outside the counted run: cuBLAS handles and the first
    # launches (the served run then shows steady-state TTFT)
    with torch.inference_mode():
        prefill(engine.params, cfg,
                torch.as_tensor(prompts[0][:64], device=DEVICE)[None], 64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for c in (*counters.values(), *flash_paths.values()):
        c.reset()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    metrics = engine.run(timeout=900)
    wall = time.perf_counter() - t0
    n_launch = {name: c.count for name, c in counters.items()}
    n_flash_path = {path: c.count for path, c in flash_paths.items()}

    stats = engine.latency_stats()
    n_prefill = sum(1 for r in metrics.records if r.priority == 1)
    _require(stats["completed"] == len(prompts), f"completed {stats}")
    for r in reqs:
        _require(len(r.out_tokens) == NEW_TOKENS
                 and all(0 <= t < cfg.vocab for t in r.out_tokens),
                 f"request {r.rid} tokens {r.out_tokens}")
    _require(n_prefill == len(prompts), f"{n_prefill} prefills")
    n_decode = sum(len(r.out_tokens) - 1 for r in reqs)
    per_prefill = _launches_per_prefill(cfg)
    per_decode = _launches_per_decode(cfg)
    for name, n in per_prefill.items():
        want = n * n_prefill + per_decode[name] * n_decode
        _require(n_launch[name] == want,
                 f"{cfg.name}: {name} launched {n_launch[name]} times for "
                 f"{n_prefill} prefills of {n} launches each and {n_decode} "
                 f"decode steps of {per_decode[name]}")
    # every decode step was a replay of a captured graph, and every
    # prefill a replay of its bucket's
    graphs = engine.decode_graph_stats()
    _require(graphs["replays"] == graphs["steps"] == n_decode,
             f"{cfg.name}: {n_decode} decode steps, decode graphs {graphs}")
    pre = engine.prefill_graph_stats()
    by_bucket = {b: sum(min(_bucket(n), max_len) == b for n in PROMPT_LENS)
                 for b in pre["buckets"]}
    _require(pre["replays"] == pre["steps"] == n_prefill
             and pre["steps_by_bucket"] == by_bucket,
             f"{cfg.name}: {n_prefill} prefills into buckets {by_bucket}, "
             f"prefill graphs {pre}")
    path = SERVED_FLASH_PATH[cfg.dtype]
    _require(n_flash_path[path] == n_launch["flash_attention"],
             f"{cfg.name}: flash launches by path {n_flash_path}: every "
             f"{cfg.dtype} prefill should take the {path} kernel")
    dec = sorted(r.duration for r in metrics.records
                 if r.type_name.startswith("decode"))
    n_tokens = sum(len(r.out_tokens) for r in reqs)
    out = {
        "arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
        "params_b": n_params / 1e9, "init_s": init_s,
        "requests": len(prompts), "prompt_lens": list(PROMPT_LENS),
        "new_tokens": NEW_TOKENS, "scheduler": "DAM-C",
        "slowdown": {str(k): v for k, v in SLOW_PLACE.items()},
        "wall_s": wall, "launches": n_launch,
        "flash_launches_by_path": n_flash_path,
        "launches_per_prefill": per_prefill, "prefills": n_prefill,
        "launches_per_decode": per_decode, "decode_steps": n_decode,
        "decode_graphs": graphs, "prefill_graphs": pre,
        "peak_mem_gb_after_captures": peak_init_gb,
        "ttft_ms_p50": stats["ttft_ms_p50"],
        "ttft_ms_p99": stats["ttft_ms_p99"],
        "e2e_ms_p99": stats["e2e_ms_p99"],
        "output_tokens_per_s": n_tokens / wall,
        "decode_step_ms_p50": 1e3 * dec[len(dec) // 2],
        "decode_tokens_per_s_single_stream": 1.0 / dec[len(dec) // 2],
        "prefill_placement": metrics.priority_placement(),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"[serve] {out}", flush=True)

    # -- what came out is right ---------------------------------------------
    # a replay of a bucket is the eager padded prefill, bit for bit, and the
    # engine's first token its argmax; the padded prefill is the unpadded one
    out["prefill_graph_vs_eager"] = prefill_graph_vs_eager(
        engine, cfg, prompts, reqs, max_len)
    out["prefill_times"] = prefill_times(engine, cfg, max_len)
    with torch.inference_mode():
        toks = torch.as_tensor(prompts[2], device=DEVICE)[None]
        # prefill + decode agrees with a full forward (full width); an MoE
        # model at a capacity where the forward drops nothing
        chk = cfg
        if cfg.family == "moe":
            chk = dataclasses.replace(cfg, capacity_factor=MOE_CHECK_CAPACITY)
        n_dec = 2 if cfg.dtype == "float32" else NEW_TOKENS
        rels, _ = decode_vs_forward(engine.params, chk, toks, n_dec)
        out["prefill_decode_vs_forward_rel"] = rels
        _require_decode_agrees(cfg, rels, "prefill + decode against forward")
        slot = engine.decode_slots[0]
        out["graph_vs_eager"] = graph_vs_eager(engine.params, cfg, slot,
                                               prompts[2], max_len)
        out["decode_step_card"] = decode_card_time(engine.params, cfg,
                                                   prompts[2], max_len, slot)
        if cfg.family == "ssm":
            out["prefill_split"] = slstm_share(engine.params, cfg, prompts[1])
        if cfg.frontend != "none":
            out["prefixed"] = prefixed_checks(engine.params, cfg, toks)
    engine.close()
    del engine
    torch.cuda.empty_cache()
    reduced = cfg.reduced()
    out["reduced_cuda_vs_cpu_rel"] = reduced_vs_cpu(
        dataclasses.replace(reduced, dtype="float32"))
    heads = real_heads(cfg)
    if heads is not None:           # the arch's own head layout, float32
        out["real_heads_cuda_vs_cpu_rel"] = reduced_vs_cpu(
            dataclasses.replace(heads, dtype="float32"))
    if cfg.dtype == "bfloat16":
        out["reduced_cuda_vs_cpu_bf16"] = reduced_vs_cpu_bf16(reduced)
        out["cut_depth_f32_decode_vs_forward"] = cut_depth_f32(cfg,
                                                               prompts[2])
    cut = out.get("cut_depth_f32_decode_vs_forward")
    print(f"[check] {cfg.name}: prefill+decode vs forward rel {rels}"
          + (f", at {cut['layers']} layers in float32 largest "
             f"{cut['max_rel']:.3e}" if cut else "") + "; "
          f"reduced model card vs CPU rel "
          f"{out['reduced_cuda_vs_cpu_rel']:.3e} (float32)"
          + (f", at its own heads {REAL_HEADS[cfg.name]} "
             f"{out['real_heads_cuda_vs_cpu_rel']:.3e} (float32)"
             if heads is not None else "")
          + (f", {out['reduced_cuda_vs_cpu_bf16']} (bfloat16)"
             if cfg.dtype == "bfloat16" else ""), flush=True)
    print(f"[serve] {cfg.name} ({cfg.dtype}): init {out['init_s']:.2f} s, "
          f"peak {out['peak_mem_gb']:.2f} GB, TTFT p50 / p99 "
          f"{out['ttft_ms_p50']:.1f} / {out['ttft_ms_p99']:.1f} ms, decode "
          f"step p50 {out['decode_step_ms_p50']:.1f} ms (graphed), "
          f"{out['output_tokens_per_s']:.2f} output tokens/s", flush=True)
    report.setdefault("serve", {})[cfg.name] = out
    return out


def _require_decode_agrees(cfg, rels: list[float], what: str) -> None:
    """A served model's decode steps against its forward: float32 every
    step under rel 5e-3, the model tolerance; bfloat16 the median over the
    steps under ``BF16_FULL_TOL`` (an MoE model) or its arch's
    ``DENSE_BF16_FULL_TOL`` (a dense one)."""
    import statistics
    if cfg.dtype == "float32":
        _require(max(rels) < 5e-3, f"{what}: rel {rels}")
    else:
        tol = (BF16_FULL_TOL if cfg.n_experts
               else DENSE_BF16_FULL_TOL[cfg.name])
        _require(statistics.median(rels) < tol,
                 f"{what}: rel {rels}, median over the tokens not under "
                 f"{tol}")


# the served prompts whose prefill graphs are held to the eager padded
# prefill: 300 tokens (ragged, bucket 512) and 1024 (its bucket's length)
PREFILL_CHECKS = (2, 1)
# the prompt lengths at which eager and graphed prefills are timed
PREFILL_TIME_LENS = (256, 512, 1024)
PREFILL_TIME_ITERS = 2


def _padded_prompt(cfg, prompt, max_len):
    """The token ids ``[1, b]`` of ``prompt`` padded with 0 to its bucket
    and the ``PadLength`` of its length, on the card."""
    import torch
    from repro_torch.models import pad_length
    from repro_torch.serve.engine import _bucket
    n = len(prompt)
    ids = torch.zeros((1, min(_bucket(n), max_len)), dtype=torch.int64)
    ids[0, :n] = torch.as_tensor(prompt)
    return ids.to(DEVICE), pad_length(cfg, n, DEVICE)


def padded_vs_unpadded(params, cfg, prompt, max_len, padded=None) -> dict:
    """The eager padded prefill of ``prompt`` (``padded``: its (logits,
    state), else run here) against the eager unpadded one: the logits' rel,
    the caches' rows before S (``kv_rel``), the recurrent states'
    (``state_rel``, the worst leaf), whether the rows from S on are all zero
    and the caches' ``length`` S."""
    import torch
    from repro_torch.models import prefill
    n = len(prompt)
    with torch.inference_mode():
        if padded is None:
            ids, pad = _padded_prompt(cfg, prompt, max_len)
            padded = prefill(params, cfg, ids, max_len, length=pad)
        toks = torch.as_tensor(prompt, device=DEVICE)[None]
        logits_u, state_u = prefill(params, cfg, toks, max_len)
    logits_p, state_p = padded
    out = {"tokens": n, "logits_rel": _rel(logits_p, logits_u),
           "kv_rel": 0.0, "state_rel": 0.0, "kv_pad_zero": True,
           "length_ok": True}
    for key, sub in state_p.items():
        for name, t in sub.items():
            u = state_u[key][name]
            if name == "length":
                out["length_ok"] &= bool((t == n).all()) and torch.equal(t, u)
            elif name in ("k", "v"):
                out["kv_rel"] = max(out["kv_rel"],
                                    _rel(t[:, :, :n], u[:, :, :n]))
                out["kv_pad_zero"] &= bool((t[:, :, n:] == 0).all())
            else:
                out["state_rel"] = max(out["state_rel"], _rel(t, u))
    return out


def _require_padded_agrees(cfg, rows: list[dict], what: str) -> None:
    """Padded prefills against unpadded ones: the rows from S on zero and
    the lengths S; in float32 the logits, the caches' rows before S and the
    recurrent states under rel 5e-3, the model tolerance; in bfloat16 the
    logits at the model's served limit (``_require_decode_agrees``)."""
    _require(all(r["kv_pad_zero"] and r["length_ok"] for r in rows),
             f"{cfg.name}: {what}: the caches' rows from S on zero, their "
             f"length S: {rows}")
    if cfg.dtype == "float32":
        _require(all(max(r["logits_rel"], r["kv_rel"], r["state_rel"])
                     < 5e-3 for r in rows), f"{cfg.name}: {what}: {rows}")
    else:
        _require_decode_agrees(cfg, [r["logits_rel"] for r in rows], what)


def prefill_graph_vs_eager(engine, cfg, prompts, reqs, max_len) -> dict:
    """For the ``PREFILL_CHECKS`` prompts: a prefill through the engine's
    bucket (a replay of its graph) against the eager padded prefill on the
    stream the graph was captured on, logits and every state leaf bit for
    bit, and the engine's first token for that prompt the replay's; the
    eager padded prefill on the default stream, its difference reported;
    and the eager padded prefill against the unpadded one
    (``padded_vs_unpadded``, ``_require_padded_agrees``)."""
    import torch
    from repro_torch.models import prefill
    params, rows = engine.params, []
    for i in PREFILL_CHECKS:
        prompt = prompts[i]
        bucket = engine.prefill_graphs.bucket(len(prompt))
        state_g, tok_g = bucket.prefill(prompt)
        logits_g = bucket.logits.clone()
        ids, pad = _padded_prompt(cfg, prompt, max_len)
        bucket.stream.wait_stream(torch.cuda.current_stream())
        with torch.inference_mode(), torch.cuda.stream(bucket.stream):
            logits_e, state_e = prefill(params, cfg, ids, max_len, length=pad)
        torch.cuda.current_stream().wait_stream(bucket.stream)
        with torch.inference_mode():
            logits_d, state_d = prefill(params, cfg, ids, max_len, length=pad)
        torch.cuda.synchronize()
        row = {"tokens": len(prompt), "bucket": bucket.bucket,
               "bit_for_bit": _same_bits(logits_g, logits_e)
               and _same_bits(state_g, state_e),
               "first_token_equal": reqs[i].out_tokens[0] == tok_g
               == int(torch.argmax(logits_e[0])),
               "default_stream_max_abs_diff": max(
                   float((logits_g - logits_d).abs().max()),
                   _max_diff(state_g, state_d)),
               "padded_vs_unpadded": padded_vs_unpadded(
                   params, cfg, prompt, max_len, (logits_e, state_e))}
        rows.append(row)
        del state_g, state_e, state_d
    print(f"[serve] {cfg.name} prefill graphs against the eager padded "
          f"prefill: {rows}", flush=True)
    _require(all(r["bit_for_bit"] and r["first_token_equal"] for r in rows),
             f"{cfg.name}: a bucket's replay against the eager padded "
             f"prefill on its capture stream, bit for bit, and the engine's "
             f"first token: {rows}")
    _require_padded_agrees(cfg, [r["padded_vs_unpadded"] for r in rows],
                           "padded prefill against unpadded")
    return {"checks": rows}


def prefill_times(engine, cfg, max_len) -> dict:
    """One prefill of ``PREFILL_TIME_LENS`` tokens each, eager (the
    unpadded ``prefill`` on the default stream) and graphed (through the
    engine's bucket of that length, a replay): its host time (the call's
    return, before the wait: the eager dispatch or the graph's launch and
    the state's copy), its wall time (to the argmax read, the one wait),
    each over ``PREFILL_TIME_ITERS`` calls after a warm-up from an idle
    card; its card time (the kernels' time in a ``torch.profiler`` trace of
    one call) and kernel count."""
    import numpy as np
    import torch
    from repro_torch.models import prefill
    params, rows = engine.params, {}
    rng = np.random.default_rng(11)
    for n in PREFILL_TIME_LENS:
        prompt = rng.integers(0, cfg.vocab, n)
        toks = torch.as_tensor(prompt, device=DEVICE)[None]
        bucket = engine.prefill_graphs.bucket(n)

        def eager():
            with torch.inference_mode():
                return prefill(params, cfg, toks, max_len)[0][0]

        def graphed():
            bucket.launch(prompt)
            return bucket.argmax
        row = {}
        for mode, launch in (("eager", eager), ("graphed", graphed)):
            host, wall = [], []
            for it in range(PREFILL_TIME_ITERS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = launch()
                t1 = time.perf_counter()
                int(torch.argmax(got) if got.ndim else got)     # the wait
                t2 = time.perf_counter()
                if it:                  # the first is the warm-up
                    host.append(1e3 * (t1 - t0))
                    wall.append(1e3 * (t2 - t0))
            kernels = _trace_kernels(launch, cpu=False)
            row[mode] = {"host_ms": host, "wall_ms": wall,
                         "card_ms": sum(ev.self_device_time_total
                                        for ev in kernels) / 1e3,
                         "kernels": sum(ev.count for ev in kernels)}
        rows[n] = row
    print(f"[serve] {cfg.name} prefill eager against graphed "
          f"({_smi()}): {rows}", flush=True)
    return rows


def decode_vs_forward(params, cfg, toks, n_dec: int, frontend=None):
    """A prefill (``make_prefill_step``) of all but the last ``n_dec``
    tokens of ``toks`` [1, S] and teacher-forced decode steps of those,
    against a forward of all of them, both after the ``frontend`` prefix if
    one is given: (each step's rel, the forward's logits)."""
    import torch
    from repro_torch.models import decode_step, forward
    from repro_torch.train import make_prefill_step
    full, _ = forward(params, cfg, toks, frontend)
    batch = {"tokens": toks[:, :-n_dec]}
    prefix = 0
    if frontend is not None:
        batch["frontend"], prefix = frontend, frontend.shape[1]
    _, state = make_prefill_step(cfg, prefix + toks.shape[1])(params, batch)
    rels = []
    for i in range(n_dec, 0, -1):
        step, state = decode_step(params, cfg, state, toks[:, -i])
        _require(bool(torch.isfinite(step).all()),
                 "prefill + decode: finite logits")
        rels.append(_rel(step, full[:, -i]))
    return rels, full


def cut_depth_f32(cfg, prompt) -> dict:
    """A bfloat16 served model at full width in float32, cut to
    ``MOE_CHECK_LAYERS`` layers (an MoE model, at capacity
    ``MOE_CHECK_CAPACITY``) or ``DENSE_CHECK_LAYERS`` (a dense one, after
    its frontend prefix if it takes one): prefill + ``NEW_TOKENS`` decode
    steps against a forward, every step under rel 5e-3, the model
    tolerance.  In bfloat16 at depth rounding drift hides a decode fault;
    here each one planted in the MoE models fails by far (PERF.md)."""
    import dataclasses
    import torch
    from repro_torch.models import init_params
    moe = cfg.family == "moe"
    layers = MOE_CHECK_LAYERS if moe else DENSE_CHECK_LAYERS
    chk = dataclasses.replace(cfg, n_layers=layers, dtype="float32",
                              **({"capacity_factor": MOE_CHECK_CAPACITY}
                                 if moe else {}))
    params = init_params(chk, seed=0, device=DEVICE)
    toks = torch.as_tensor(prompt, device=DEVICE)[None]
    front = _frontend(chk, 1, seed=5) if chk.frontend != "none" else None
    with torch.inference_mode():
        rels, _ = decode_vs_forward(params, chk, toks, NEW_TOKENS, front)
    # the padded prefill against the unpadded one at the served capacity
    served = dataclasses.replace(chk, capacity_factor=cfg.capacity_factor)
    padded = padded_vs_unpadded(params, served, prompt,
                                max(PROMPT_LENS) + NEW_TOKENS)
    n_params = sum(t.numel() for t in _leaves(params))
    del params
    torch.cuda.empty_cache()
    _require(max(rels) < 5e-3,
             f"{cfg.name} at {layers} layers in float32: prefill + decode "
             f"against forward: rel {rels}")
    _require_padded_agrees(served, [padded], f"{cfg.name} at {layers} "
                           f"layers in float32: padded prefill against "
                           f"unpadded")
    return {"layers": layers, "params_b": n_params / 1e9,
            "prefix": 0 if front is None else front.shape[1],
            "steps": NEW_TOKENS, "max_rel": max(rels), "rels": rels,
            "padded_vs_unpadded": padded}


def _frontend(cfg, batch: int, seed: int, device=DEVICE):
    """A frontend prefix [batch, ``frontend_len``, d] in float32, drawn
    N(0, 1) from a seeded generator on ``device``, as the reference's tests
    draw theirs (``tests/test_models.py``)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn((batch, cfg.frontend_len, cfg.d_model), generator=g,
                       device=device)


def prefixed_checks(params, cfg, toks) -> dict:
    """A served vlm or audio model with its frontend prefix at full width
    (``frontend_len`` positions): ``make_prefill_step`` over the prefix and
    all but the last ``NEW_TOKENS`` tokens of ``toks`` and teacher-forced
    decode steps of those, against ``forward`` over the prefix and all of
    them (float32: every step under rel 5e-3; bfloat16: the median over the
    steps under its ``DENSE_BF16_FULL_TOL``); ``make_forward_step`` on the same
    batch against ``forward``; and a prefix of zeros changes the logits."""
    import statistics
    import torch
    from repro_torch.models import forward
    from repro_torch.train import make_forward_step
    front = _frontend(cfg, toks.shape[0], seed=5)
    rels, full = decode_vs_forward(params, cfg, toks, NEW_TOKENS, front)
    _require_decode_agrees(cfg, rels, f"{cfg.name} with a prefix: prefill + "
                                      f"decode against forward")
    step = make_forward_step(cfg)(params, {"tokens": toks, "frontend": front})
    zeros, _ = forward(params, cfg, toks, torch.zeros_like(front))
    out = {"prefix": cfg.frontend_len, "tokens": int(toks.shape[1]),
           "decode_vs_forward_rel": rels,
           "decode_vs_forward_median": statistics.median(rels),
           "forward_step_vs_forward_rel": _rel(step, full),
           "zero_prefix_vs_prefix_rel": _rel(zeros, full)}
    _require(step.shape == full.shape == (1, toks.shape[1], cfg.vocab)
             and bool(torch.isfinite(full).all())
             and out["forward_step_vs_forward_rel"] < 1e-6,
             f"{cfg.name}: make_forward_step against forward, with a "
             f"prefix: {out}")
    _require(not torch.allclose(zeros, full),
             f"{cfg.name}: a prefix of zeros leaves the logits as they were")
    print(f"[check] {cfg.name} with a prefix of {cfg.frontend_len}: "
          f"{out}", flush=True)
    return out


def slstm_share(params, cfg, prompt) -> dict:
    """One prefill of ``prompt`` on one thread, and the sLSTM blocks of the
    model run alone on a hidden state of the same shape, in turns, 3 times
    each after a warm-up: the share of the prefill's wall time (medians)
    that the sLSTM blocks take (their projections and the sLSTM scan
    kernel, one launch a block)."""
    import statistics
    import torch
    from repro_torch.models import layer_plan, prefill
    from repro_torch.models.transformer import _layer
    from repro_torch.models.xlstm import slstm_block
    toks = torch.as_tensor(prompt, device=DEVICE)[None]
    n_sl = layer_plan(cfg).count("slstm")
    h = torch.randn((1, toks.shape[1], cfg.d_model), device=DEVICE)
    stack = params["stacks"]["slstm"]

    def run_slstm():
        for i in range(n_sl):
            slstm_block(_layer(stack, i)["slstm"], h, n_heads=cfg.n_heads)

    def run_prefill():
        prefill(params, cfg, toks, toks.shape[1])

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run_prefill()
    run_slstm()
    times = {"prefill": [], "slstm": []}
    for _ in range(3):
        times["prefill"].append(timed(run_prefill))
        times["slstm"].append(timed(run_slstm))
    prefill_s = statistics.median(times["prefill"])
    slstm_s = statistics.median(times["slstm"])
    out = {"tokens": int(toks.shape[1]), "prefill_ms": 1e3 * prefill_s,
           "slstm_ms": 1e3 * slstm_s, "slstm_layers": n_sl,
           "slstm_share": slstm_s / prefill_s,
           "runs_ms": {k: [1e3 * t for t in v] for k, v in times.items()}}
    print(f"[serve] {cfg.name} prefill split {out}", flush=True)
    return out


def _reduced_frontend(cfg, seed: int = 2):
    """The frontend prefix [2, ``frontend_len``, d] a reduced vlm or audio
    model is checked with, drawn on the CPU (the same values on the card
    and on the CPU); None for a model without one."""
    if cfg.frontend == "none":
        return None
    return _frontend(cfg, 2, seed, device="cpu")


def reduced_vs_cpu(cfg) -> float:
    """The reduced model on the card (kernel) against the CPU path (plain
    version) with the same weights, after its frontend prefix if it takes
    one: logits and greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, init_params, prefill

    cpu = init_params(cfg, seed=1, device="cpu")
    gpu = _tree_to(cpu, DEVICE)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 150))
    front = _reduced_frontend(cfg)
    worst = 0.0
    with torch.inference_mode():
        outs = []
        for params, dev in ((cpu, "cpu"), (gpu, DEVICE)):
            t = torch.as_tensor(toks, device=dev)
            f = None if front is None else front.to(dev)
            logits, state = prefill(params, cfg, t, 160 + cfg.frontend_len, f)
            seq = [logits.cpu()]
            nxt = torch.argmax(logits, dim=-1)
            for _ in range(4):
                logits, state = decode_step(params, cfg, state, nxt)
                seq.append(logits.cpu())
                nxt = torch.argmax(logits, dim=-1)
            outs.append(seq)
        for a, b in zip(*outs):
            worst = max(worst, _rel(b, a))
            _require(torch.equal(torch.argmax(a, -1), torch.argmax(b, -1)),
                     "reduced model greedy tokens, card against CPU")
    _require(worst < 5e-3, f"reduced model card against CPU: rel {worst}")
    return worst


def reduced_vs_cpu_bf16(cfg) -> dict:
    """The reduced model in bfloat16 on the card against the CPU path with
    the same weights, after its frontend prefix if it takes one, logits
    only, the tokens teacher-forced (a greedy choice may differ in
    bfloat16): the forward at every token and the
    served outputs (prefill's last token and 4 decode steps), each held at
    ``BF16_REDUCED_TOL`` on the median over tokens."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.models import decode_step, forward, init_params, prefill

    cpu = init_params(cfg, seed=1, device="cpu")
    gpu = _tree_to(cpu, DEVICE)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 154))
    front = _reduced_frontend(cfg)
    outs = []
    with torch.inference_mode():
        for params, dev in ((cpu, "cpu"), (gpu, DEVICE)):
            t = torch.as_tensor(toks, device=dev)
            f = None if front is None else front.to(dev)
            fwd, _ = forward(params, cfg, t[:, :150], f)
            logits, state = prefill(params, cfg, t[:, :150],
                                    160 + cfg.frontend_len, f)
            seq = [logits]
            for i in range(150, 154):
                logits, state = decode_step(params, cfg, state, t[:, i])
                seq.append(logits)
            outs.append((fwd.cpu(), torch.stack(seq).cpu()))
    res = {}
    for name, want, got in zip(("forward", "served"), *outs):
        _require(bool(torch.isfinite(got).all()),
                 f"reduced bfloat16 model on the card: finite {name} logits")
        per_token = _rel_by_token(got, want)
        res[name] = {"median": statistics.median(per_token),
                     "max": max(per_token), "tokens": len(per_token)}
        _require(res[name]["median"] < BF16_REDUCED_TOL,
                 f"reduced bfloat16 model card against CPU, {name}: {res}")
    return res


def _decode_weight_bytes(cfg, length: int) -> int:
    """Bytes one decode step of one sequence of an attention model must
    read: every attention projection, the FFN (of an MoE model each router,
    the chosen ``top_k`` experts and the shared expert) of every layer, the
    cache rows it attends to and the LM head, in the model's dtype (each
    read once)."""
    from repro_torch.models import layer_plan
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    if cfg.n_experts:
        ffn = (d * cfg.n_experts + cfg.top_k * 3 * d * cfg.d_ff
               + 3 * d * cfg.moe_shared_ff)
    else:
        ffn = (3 if cfg.act in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    cache = 2 * length * cfg.n_kv_heads * hd
    per_layer = attn + ffn + cache
    n = sum(k in ("attn", "attn_moe") for k in layer_plan(cfg))
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    return (n * per_layer + d * cfg.vocab) * itemsize


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.clone()


def graph_vs_eager(params, cfg, slot, prompt, max_len) -> dict:
    """``NEW_TOKENS`` greedy steps from one prefill of ``prompt``, each
    from its own copy of the state: through the engine's decode slot (a
    replay of its graph), and eagerly on the stream the graph was captured
    on, whose logits and tokens must equal the replays' bit for bit; and
    eagerly on the default stream, whose difference from the replays is
    reported (cuBLAS may pick another algorithm by stream or workspace)."""
    import torch
    from repro_torch.models import decode_step, prefill
    toks = torch.as_tensor(prompt, device=DEVICE)[None]
    with torch.inference_mode():
        logits, state = prefill(params, cfg, toks, max_len)
    tok = int(torch.argmax(logits[0]))
    runs = {}
    for mode in ("graphed", "eager_capture_stream", "eager_default_stream"):
        st, t, seq = _tree_clone(state), tok, []
        stream = (slot.stream if mode == "eager_capture_stream"
                  else torch.cuda.current_stream())
        stream.wait_stream(torch.cuda.current_stream())
        with torch.inference_mode(), torch.cuda.stream(stream):
            for _ in range(NEW_TOKENS):
                if mode == "graphed":
                    t = slot.step(st, t)
                    lg = slot.logits
                else:
                    lg, _ = decode_step(params, cfg, st,
                                        torch.tensor([t], device=DEVICE))
                    t = int(torch.argmax(lg[0]))
                seq.append((lg.clone(), t))
        torch.cuda.current_stream().wait_stream(stream)
        runs[mode] = seq
    torch.cuda.synchronize()
    out = {"steps": NEW_TOKENS}
    for mode in ("eager_capture_stream", "eager_default_stream"):
        same = [_same_bits(g, e) and gt == et for (g, gt), (e, et)
                in zip(runs["graphed"], runs[mode])]
        diff = max(float((g - e).abs().max()) for (g, _), (e, _)
                   in zip(runs["graphed"], runs[mode]))
        out[mode] = {"bit_for_bit_steps": sum(same), "max_abs_diff": diff,
                     "tokens_equal": [gt for _, gt in runs["graphed"]]
                     == [et for _, et in runs[mode]]}
    print(f"[serve] {cfg.name} graphed decode against eager over "
          f"{NEW_TOKENS} steps: {out}", flush=True)
    _require(out["eager_capture_stream"]["bit_for_bit_steps"] == NEW_TOKENS,
             f"{cfg.name}: the graphed decode's logits and tokens against "
             f"the eager step's on the capture stream, bit for bit: {out}")
    return out


def _trace_kernels(fn, cpu: bool = True) -> list:
    """The kernels' own events of a ``torch.profiler`` trace of one call
    of ``fn`` (an operator's event also carries the time of the kernels it
    launched); without ``cpu`` the trace records the card's activity only
    (an eager prefill's thousands of operators make a CPU trace take
    seconds to read)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.key not in STEP_RANGES]


def _attention_only(cfg) -> bool:
    from repro_torch.models import layer_plan
    return set(layer_plan(cfg)) <= {"attn", "attn_moe"}


def decode_card_time(params, cfg, prompt, max_len, slot) -> dict:
    """One decode step after a prefill of ``prompt``, on one thread,
    eager and through the engine's decode ``slot`` (a replay of its
    graph), each from its own copy of the state: its wall time until the
    card is done (``host_ms``, the larger of the host's and the card's
    time a step), its card time (``card_ms``, the kernels' time in a
    ``torch.profiler`` trace of one step, of which ``memcpy_card_ms`` in
    memory copies; for the graphed step also from CUDA events over 5
    replays queued behind a spin kernel, ``card_ms_events``) and kernel
    count; the graphed step's state copies (``state_copies_ms``: the
    request's state into a buffer of the same shapes and back, as the
    slot copies it, timed alone by CUDA events); and, for a model of
    attention blocks only, the least card time, the bytes of the weights
    the step must read (``_decode_weight_bytes``) at the memory rate."""
    import torch
    from repro_torch.models import decode_step, prefill
    toks = torch.as_tensor(prompt, device=DEVICE)[None]
    with torch.inference_mode():
        _, state = prefill(params, cfg, toks, max_len)
        graph_state = _tree_clone(state)
        nxt = toks[:, -1]
        tok = int(nxt[0])

        def step():
            decode_step(params, cfg, state, nxt)

        def replay():
            slot.launch(graph_state, tok)
        buffers = _tree_clone(state)

        def state_copies():
            for mine, theirs in zip(_leaves(buffers), _leaves(graph_state)):
                mine.copy_(theirs)
            for mine, theirs in zip(_leaves(buffers), _leaves(graph_state)):
                theirs.copy_(mine)
        host_ms = _time_ms(step, iters=3, warmup=1, run_ahead=False)
        kernels = _trace_kernels(step)
        graph_host_ms = _time_ms(replay, iters=3, warmup=1, run_ahead=False)
        graph_events_ms = _time_ms(replay, iters=5, warmup=0)
        graph_kernels = _trace_kernels(replay)
        copies_ms = _time_ms(state_copies, iters=5)
    card_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    _require(card_ms > 0, f"{cfg.name}: the traced decode step ran nothing "
                          f"on the card")

    def memcpy_ms(evs) -> float:
        return sum(ev.self_device_time_total for ev in evs
                   if ev.key.startswith("Memcpy")) / 1e3
    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:6]
    out = {"tokens_before": len(prompt), "host_ms": host_ms,
           "card_ms": card_ms, "memcpy_card_ms": memcpy_ms(kernels),
           "kernels": sum(ev.count for ev in kernels),
           "top_kernels_ms": {ev.key[:70]: ev.self_device_time_total / 1e3
                              for ev in top},
           "graphed": {
               "host_ms": graph_host_ms,
               "card_ms": sum(ev.self_device_time_total
                              for ev in graph_kernels) / 1e3,
               "memcpy_card_ms": memcpy_ms(graph_kernels),
               "card_ms_events": graph_events_ms,
               "kernels": sum(ev.count for ev in graph_kernels),
               "state_copies_ms": copies_ms,
               "state_bytes": sum(t.numel() * t.element_size()
                                  for t in _leaves(state))}}
    if _attention_only(cfg):
        nbytes = _decode_weight_bytes(cfg, len(prompt) + 5)
        out["weight_gb"] = nbytes / 1e9
        out["bound_ms"] = nbytes / H100_BYTES_PER_S * 1e3
    print(f"[serve] {cfg.name} decode step {out}", flush=True)
    return out


# -- phase 8: training ----------------------------------------------------------
# One run a model, one after the other, each through the port's Trainer:
# first in float32, then in bfloat16, the dtype the dry-run prices (bfloat16
# params, a float32 master copy and float32 moments, as the reference's
# AdamW keeps them), 16 bytes a parameter with the gradients either way.
# Most of a run's time is its checkpoint's write and restore (~35 s a
# billion parameters on the card's host: PERF.md §4), so the runs are cut
# in depth to keep the whole run well inside its time limit: granite-8b at
# full width is cut 36 -> 1 layer in both dtypes (0.62 B parameters),
# zamba2-1.2b 38 -> 6 Mamba-2 layers (0.35 B, the shared block applied
# once), all at B 2 x S 2048; xlstm-125m whole.  qwen3-moe-30b-a3b trains
# in bfloat16 only (30.1 B parameters): at full width cut 48 -> 1 layer,
# 9.4 M attention and 604 M expert parameters a layer and 0.62 B in the
# untied embeddings, 1.24 B parameters, ~20 GB at 16 bytes each, capacity
# factor 1.25.
# stablelm-3b trains whole (2.80 B, 44.7 GB; the wgmma backward at D 80)
# and qwen2.5-14b at full width cut 48 -> 4 layers (2.66 B, 42.5 GB: 1.56 B
# in its untied embeddings; the QKV bias's gradients, GQA group 5), both
# without remat: their activations fit beside the state.
#
# Two warm-up steps are far too few for granite's width (Adam moves every
# weight by about lr at once): at lr 3e-4 the loss rose from 11.1 to 23.2 by
# step 5 and ended at 9.7; at 3e-5 it rises to 14.8 by step 3 and ends at
# 7.4 (PERF.md).  qwen3-moe takes granite's lr.  The SSD models take the
# launcher's lr, 3e-4: at 3e-5 their loss hardly moves in 8 steps.  The
# check asks only that the last loss is below the first.  A run's
# ``grad_tol`` is its reduced model's float32 limit, card against CPU; in
# bfloat16 the reduced model is held under the rule (bf16_grad_limits).
TRAIN_RUNS = (
    {"arch": "granite-8b", "layers": 1, "dtype": "float32", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-5, "grad_tol": 1e-4},
    {"arch": "zamba2-1.2b", "layers": 6, "dtype": "float32", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-4, "grad_tol": 3e-3},
    {"arch": "xlstm-125m", "layers": None, "dtype": "float32", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-4, "grad_tol": 1e-4},
    {"arch": "qwen3-moe-30b-a3b", "layers": 1, "dtype": "bfloat16",
     "batch": 2, "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-5,
     "grad_tol": 1e-4},
    {"arch": "granite-8b", "layers": 1, "dtype": "bfloat16", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-5, "grad_tol": 1e-4},
    {"arch": "zamba2-1.2b", "layers": 6, "dtype": "bfloat16", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-4, "grad_tol": 3e-3,
     "plain_update_steps": 4},
    {"arch": "xlstm-125m", "layers": None, "dtype": "bfloat16", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-4, "grad_tol": 1e-4},
    {"arch": "stablelm-3b", "layers": None, "dtype": "bfloat16", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-5, "grad_tol": 1e-4},
    {"arch": "qwen2.5-14b", "layers": 4, "dtype": "bfloat16", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-5, "grad_tol": 1e-4},
)
# musicgen-large with its frontend prefix, at full width and depth: B 2 x
# (P 64 + 1984 text tokens), the 2048 positions of the others.  Its 2.42 B
# parameters, their gradients and AdamW moments take 38.8 GB; its
# activations fit beside them without remat.  It takes granite's lr, 3e-5:
# at the SSD models' 3e-4 its loss climbs through the two warm-up steps, as
# granite's does.
TRAIN_PREFIXED = (
    {"arch": "musicgen-large", "layers": None, "dtype": "float32",
     "batch": 2, "seq": 2048, "steps": 8, "lr": 3e-5, "grad_tol": 1e-4},
    {"arch": "musicgen-large", "layers": None, "dtype": "bfloat16",
     "batch": 2, "seq": 2048, "steps": 8, "lr": 3e-5, "grad_tol": 1e-4},
)
# Two more archs trained outside the Trainer as musicgen-large is (a
# Trainer run's checkpoint costs ~35 s a billion parameters), in
# bfloat16 at full width: moonshot-v1-16b-a3b cut 48 -> 4 layers (3.02 B
# parameters, 48.4 GB at 16 bytes each: its shared expert beside 64 routed
# ones, capacity 1.25), nemotron-4-15b cut 32 -> 1 layer (3.54 B: 3.15 B of
# them its untied 256,000-row embeddings; 56.6 GB), both at granite's lr.
TRAIN_DIRECT = (
    {"arch": "moonshot-v1-16b-a3b", "layers": 4, "dtype": "bfloat16",
     "batch": 2, "seq": 2048, "steps": 8, "lr": 3e-5, "grad_tol": 1e-4},
    {"arch": "nemotron-4-15b", "layers": 1, "dtype": "bfloat16",
     "batch": 2, "seq": 2048, "steps": 8, "lr": 3e-5, "grad_tol": 1e-4},
)
TRAIN_WARMUP = 2
TRAIN_CKPT_DIR = ROOT / ".train_ckpt"   # listed in .gitignore; removed after
# the steps before the checkpoint over which each graphed run's state is
# held to the eager step's, bit for bit (its losses over every step)
GRAPH_EQ_STEPS = 4
# The step-1 loss of a random init: its final rms_norm gives every token
# unit RMS and the fan-in LM head N(0, 1/d) weights, so each token's logits
# are N(0, 1) over the vocabulary, whose log-sum-exp is ln V + 1/2.
INIT_LOSS_SLACK = 0.5


def _tree_rel(got, want) -> float:
    """The largest over leaves of max |got - want| / max |want|."""
    return max(float((g.double().cpu() - w.double().cpu()).abs().max()
                     / w.double().abs().max().clamp_min(1e-30))
               for g, w in zip(_leaves(got), _leaves(want)))


def _train_counters():
    from repro_torch.kernels import adamw, flash_attention, slstm_scan, ssd_scan
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "tf32x3": flash_attention.path_launches["tf32x3"],
            "wgmma": flash_attention.path_launches["wgmma"],
            "bwd_tf32x3": flash_attention.bwd_path_launches["tf32x3"],
            "bwd_wgmma": flash_attention.bwd_path_launches["wgmma"],
            "bwd_fma": flash_attention.bwd_path_launches["fma"],
            "ssd_scan": ssd_scan.launches,
            "ssd_scan_bwd": ssd_scan.bwd_launches,
            **{f"ssd_{route}": ssd_scan.path_launches[route]
               for route in TRAIN_SSD_ROUTES},
            **{f"ssd_bwd_{route}": ssd_scan.bwd_path_launches[route]
               for route in TRAIN_SSD_ROUTES},
            "slstm_scan": slstm_scan.launches,
            "slstm_scan_bwd": slstm_scan.bwd_launches,
            "adamw": adamw.launches, "adamw_norm": adamw.norm_launches}


def _reset(counters) -> None:
    for c in counters.values():
        c.reset()


def _counts(counters) -> dict:
    return {name: c.count for name, c in counters.items()}


# the flash paths a train step's launches take, by the model's dtype: the
# forward's and the backward's
TRAIN_FLASH_PATHS = {"float32": ("tf32x3", "bwd_tf32x3"),
                     "bfloat16": ("wgmma", "bwd_wgmma")}
# the SSD load routes phase 8 counts: a bfloat16 step's every SSD launch,
# forward and backward, on "bf16_async" and none on "plain"; a float32
# step's on the float32 routes (not counted here), none on these two
TRAIN_SSD_ROUTES = ("bf16_async", "plain")


def _n_leaves(cfg) -> int:
    """The leaves of the model's parameter tree."""
    from repro_torch.models import init_params
    return sum(1 for _ in _leaves(init_params(cfg, device="meta")))


def _step_launches(cfg, remat: bool = False, update: bool = True) -> dict:
    """Kernel launches of one train step, from the layer plan: one flash
    forward and backward per attention block or shared-block application,
    all on the dtype's paths (``TRAIN_FLASH_PATHS``: float32 ``tf32x3``
    both ways, bfloat16 ``wgmma`` both ways); one SSD
    forward and backward per Mamba-2 layer, two per mLSTM layer (so no
    backward runs the forward again: it reads the forward's kept scratch),
    in bfloat16 all on the "bf16_async" route, none on "plain"
    (``TRAIN_SSD_ROUTES``);
    one sLSTM scan forward and backward per sLSTM layer.  With remat every
    stacked layer runs its forward again in the backward (the hybrid's
    shared block is not rematerialised).  With ``update`` (a train step,
    not a gradient alone) the AdamW kernels: one update a leaf, and the
    gradient norm's partial pass a leaf and its finalize."""
    per = _launches_per_prefill(cfg)
    from repro_torch.models import layer_plan
    again = sum(k in ("attn", "attn_moe") for k in layer_plan(cfg)) if (
        remat) else 0
    fwd, bwd = per["flash_attention"] + again, per["flash_attention"]
    ssd, sl = per["ssd_scan"], per["slstm_scan"]
    fwd_path, bwd_path = TRAIN_FLASH_PATHS[cfg.dtype]
    out = {"flash_attention": fwd, "flash_attention_bwd": bwd,
           "tf32x3": 0, "wgmma": 0, "bwd_tf32x3": 0, "bwd_wgmma": 0,
           "bwd_fma": 0,
           "ssd_scan": ssd * (2 if remat else 1), "ssd_scan_bwd": ssd,
           **{f"ssd_{r}": 0 for r in TRAIN_SSD_ROUTES},
           **{f"ssd_bwd_{r}": 0 for r in TRAIN_SSD_ROUTES},
           "slstm_scan": sl * (2 if remat else 1), "slstm_scan_bwd": sl,
           "adamw": 0, "adamw_norm": 0}
    if update:
        leaves = _n_leaves(cfg)
        out["adamw"], out["adamw_norm"] = leaves, leaves + 1
    out[fwd_path], out[bwd_path] = fwd, bwd
    if cfg.dtype == "bfloat16":
        out["ssd_bf16_async"] = out["ssd_scan"]
        out["ssd_bwd_bf16_async"] = ssd
    return out


def train_reduced_vs_cpu(run: dict, cfg=None) -> dict:
    """The reduced model on the card (the flash and SSD kernels forward and
    backward, cuBLAS) against the CPU path (plain versions), from the same
    init and batches (with a frontend prefix for a vlm or audio model): the
    loss (rel 1e-5) and its gradients (every leaf
    within ``grad_tol`` x its largest magnitude: 1e-4, and the SSD
    tolerance 3e-3 for the hybrid, as ``tests/test_torch_train.py``), then
    3 AdamW steps' losses (rel 1e-4).  ``cfg`` is the arch's reduced
    config by default; for that one, a bfloat16 run is also held under the
    rule (``train_reduced_bf16_vs_cpu``), and an arch of ``REAL_HEADS`` is
    also checked (float32) at its own head layout (``real_heads``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_grad_step, make_train_step
    default = cfg is None
    if default:
        cfg = get_config(run["arch"]).reduced()
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=256,
                                        global_batch=2, seed=3))
    cpu = init_params(cfg, seed=2, device="cpu")
    gpu = _tree_to(cpu, DEVICE)

    def batch_on(i, device):
        batch = {k: torch.as_tensor(np.asarray(v), device=device)
                 for k, v in stream.batch_at(i).items()}
        front = _reduced_frontend(cfg, seed=3 + i)
        if front is not None:
            batch["frontend"] = front.to(device)
        return batch

    counters = _train_counters()
    _reset(counters)
    out = {}
    grads = {}
    for params, dev in ((cpu, "cpu"), (gpu, DEVICE)):
        g, met = make_grad_step(cfg, remat=False)(params, batch_on(0, dev))
        grads[dev] = (g, float(met["total_loss"]))
    want = _step_launches(cfg, update=False)
    _require(_counts(counters) == want,
             f"reduced {cfg.name}'s grad step launches {_counts(counters)}, "
             f"want {want}")
    out["loss_rel"] = abs(grads[DEVICE][1] - grads["cpu"][1]) / grads["cpu"][1]
    out["grad_rel"] = _tree_rel(grads[DEVICE][0], grads["cpu"][0])
    out["grad_tol"] = run["grad_tol"]
    _require(out["loss_rel"] < 1e-5 and out["grad_rel"] < run["grad_tol"],
             f"reduced {cfg.name}'s loss and gradients, card against CPU: "
             f"{out}")
    losses = {}
    opt = AdamWConfig(lr=run["lr"], warmup_steps=TRAIN_WARMUP,
                      total_steps=run["steps"])
    for params, dev in ((cpu, "cpu"), (gpu, DEVICE)):
        state = init_opt_state(params)
        step = make_train_step(cfg, opt, remat=False)
        losses[dev] = []
        for i in range(3):
            params, state, met = step(params, state, batch_on(1 + i, dev))
            losses[dev].append(float(met["loss"]))
    out["step_losses"] = losses
    out["step_loss_rel"] = max(abs(a - b) / abs(b) for a, b in
                               zip(losses[DEVICE], losses["cpu"]))
    _require(out["step_loss_rel"] < 1e-4,
             f"reduced {cfg.name}'s 3 AdamW steps, card against CPU: {out}")
    heads = real_heads(get_config(run["arch"]))
    print(f"[train] reduced {cfg.name}"
          + ("" if default else f" at its own heads {REAL_HEADS[run['arch']]}")
          + f" card against CPU {out}", flush=True)
    if default and run["dtype"] == "bfloat16":
        out["bfloat16"] = train_reduced_bf16_vs_cpu(run)
    if default and heads is not None:
        out["real_heads"] = train_reduced_vs_cpu(run, heads)
    return out


def train_reduced_bf16_vs_cpu(run: dict) -> dict:
    """The reduced model in bfloat16 on the card against the exact
    function, the CPU path in float32 on the same weights cast up, on the
    inputs the rule is grounded on (``bf16_drift_batch``, ``BF16_STEP_OPT``,
    ``BF16_STEP_SEEDS``), under the rule (``bf16_grad_limits``): the loss,
    the worst gradient leaf (not for ``BF16_LOSS_ONLY``), and the losses of
    3 AdamW steps (the card's with a float32 master copy and moments); the
    grad step's launches on the bfloat16 paths."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import make_grad_step, make_train_step
    cfg32 = get_config(run["arch"]).reduced()
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    limits = bf16_grad_limits()[run["arch"]]
    params16 = init_params(cfg16, seed=2, device="cpu")
    runs = {"cpu": (cfg32, tree_map(lambda t: t.float(), params16)),
            DEVICE: (cfg16, _tree_to(params16, DEVICE))}

    def on(batch, device):
        return {k: torch.as_tensor(v, device=device)
                for k, v in batch.items()}

    counters = _train_counters()
    grads = {}
    for dev, (cfg, params) in runs.items():
        _reset(counters)
        g, met = make_grad_step(cfg, remat=False)(
            params, on(bf16_drift_batch(cfg32, 4), dev))
        grads[dev] = (g, float(met["total_loss"]))
    want = _step_launches(cfg16, update=False)
    _require(_counts(counters) == want,
             f"reduced {cfg16.name}'s bfloat16 grad step launches "
             f"{_counts(counters)}, want {want}")
    _require(all(g.dtype == torch.bfloat16 for g in _leaves(grads[DEVICE][0])),
             "bfloat16 gradients")
    out = {"limits": limits,
           "loss_rel": abs(grads[DEVICE][1] - grads["cpu"][1])
           / abs(grads["cpu"][1]),
           "grad_rel": _tree_rel(grads[DEVICE][0], grads["cpu"][0])}
    del grads
    losses = {}
    opt = AdamWConfig(**BF16_STEP_OPT)
    for dev, (cfg, params) in runs.items():
        params = tree_map(lambda t: t.detach().clone(), params)
        state = init_opt_state(params)
        step = make_train_step(cfg, opt, remat=False)
        losses[dev] = []
        for seed in BF16_STEP_SEEDS:
            params, state, met = step(params, state, on(
                bf16_drift_batch(cfg32, seed, mask=False), dev))
            losses[dev].append(float(met["loss"]))
        if dev == DEVICE:
            _require(set(state) == {"m", "v", "step", "master"}
                     and all(t.dtype == torch.float32 for key in
                             ("m", "v", "master")
                             for t in _leaves(state[key])),
                     "the bfloat16 run's float32 master copy and moments")
    out["step_losses"] = losses
    out["step_loss_rel"] = max(abs(a - b) / abs(b) for a, b in
                               zip(losses[DEVICE], losses["cpu"]))
    ok = (out["loss_rel"] <= limits["loss"]
          and out["step_loss_rel"] <= limits["steps"]
          and (limits["grad"] is None or out["grad_rel"] <= limits["grad"]))
    print(f"[train] reduced {cfg16.name} in bfloat16 on the card against "
          f"float32 on the CPU {out}", flush=True)
    _require(ok, f"reduced {cfg16.name} in bfloat16 under the rule: {out}")
    return out


# the kernels of a traced step, by the names their sources give them
FLASH_BWD_KERNELS = ("bwd_wgmma_dq", "bwd_wgmma_dkdv", "bwd_x3_dq",
                     "bwd_x3_dkdv", "bwd_prepass", "bwd_dkdv", "bwd_dq")
FLASH_BWD_PATH_KERNELS = {"bwd_wgmma": ("bwd_wgmma_dq", "bwd_wgmma_dkdv"),
                          "bwd_tf32x3": ("bwd_x3_dq", "bwd_x3_dkdv"),
                          "bwd_fma": ("bwd_prepass", "bwd_dkdv", "bwd_dq")}
FLASH_FWD_KERNELS = {"tf32x3": ("flash_tf32x3",),
                     "wgmma": ("flash_wgmma_bf16",)}
# the SSD backward's kernels (it reads the forward's kept scratch and
# launches none of the forward's passes 1 to 3): the dual's pass 2 (DUAL)
# and reversed pass 3, and its own passes 4 to 7
SSD_BWD_KERNELS = ("ssd_bwd_", "ssd_state_pass<true",
                   "ssd_chunk_state<true", "ssd_chunk_state_narrow<true")
SSD_FWD_KERNELS = ("ssd_chunk_out", "ssd_chunk_cb", "ssd_chunk_state<false",
                   "ssd_chunk_state_narrow<false", "ssd_state_pass<false")
SLSTM_FWD_KERNELS, SLSTM_BWD_KERNELS = ("slstm_scan_fwd",), ("slstm_scan_bwd",)
# a traced step's card time by class of kernel, the first class whose names
# a kernel's name holds: the port's kernels, cuBLAS's GEMMs, copies, then
# PyTorch's elementwise and reduction kernels
TRACE_CLASSES = (
    ("flash", ("flash_", *FLASH_BWD_KERNELS)),
    ("ssd", ("ssd_",)), ("slstm", ("slstm_",)), ("adamw", ("adamw_",)),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("copy", ("Memcpy", "Memset", "copy_kernel")),
    ("elementwise", ("elementwise",)), ("reduce", ("reduce",)))
# the ranges a traced train step runs in (``split_step``): the gradient,
# then the AdamW update with its gradient norm
STEP_RANGES = ("step:grad", "step:update")


def _trace_class(name: str) -> str:
    return next((kind for kind, names in TRACE_CLASSES
                 if any(n in name for n in names)), "other")


def split_step(grad_step, update):
    """A train step as ``make_train_step`` composes it, ``grad_step(params,
    batch)`` (``make_grad_step``'s) and then ``update(params, grads,
    opt_state)`` (``apply_updates``), each inside a
    ``torch.profiler.record_function`` range of ``STEP_RANGES``, so that a
    trace splits the step's card time between them (``_traced_step``);
    ``(params, opt_state, batch) -> (params, opt_state, metrics)``."""
    from torch.profiler import record_function

    def step(params, opt_state, batch):
        with record_function(STEP_RANGES[0]):
            grads, metrics = grad_step(params, batch)
        with record_function(STEP_RANGES[1]):
            params, opt_state, info = update(params, grads, opt_state)
        return params, opt_state, {**metrics, **info}

    return step


def _range_ms(traced: dict, i: int) -> float:
    """The card time of a traced step's ``STEP_RANGES[i]``."""
    return traced["card_ms_by_range"].get(STEP_RANGES[i], {}).get(
        "card_ms", 0.0)


def _card_ms_by_range(prof) -> dict:
    """The card time of each ``STEP_RANGES`` range of a trace of one
    ``split_step``, whole and by class of kernel, on the card's clock: the
    update's span there is the profiler's device-side annotation of its
    range (its first kernel to its last; the step's kernels run in order on
    one stream), a kernel that begins before it is the gradient's, one
    after it "outside" (the loss's copy to the host).  The host's spans of
    the ranges do not split the kernels (the host runs ahead of the card,
    and the profiler's two clocks differ by up to milliseconds), nor does
    the gradient's device-side annotation (it holds only the kernels
    launched from the thread that opened it, not the backward's).  {} where
    the trace has no such annotation."""
    from torch.autograd import DeviceType
    device = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    spans = [ev.time_range for ev in device if ev.name == STEP_RANGES[1]
             and getattr(ev, "is_user_annotation", False)]
    if not spans:
        return {}
    lo, hi = min(t.start for t in spans), max(t.end for t in spans)
    out: dict = {}
    for ev in device:
        if ev.name in STEP_RANGES or getattr(ev, "is_user_annotation", False):
            continue
        start = ev.time_range.start
        where = (STEP_RANGES[0] if start < lo else
                 STEP_RANGES[1] if start <= hi else "outside")
        row = out.setdefault(where, {"card_ms": 0.0, "by_class": {}})
        ms = ev.time_range.elapsed_us() / 1e3
        row["card_ms"] += ms
        kind = _trace_class(ev.name)
        row["by_class"][kind] = row["by_class"].get(kind, 0.0) + ms
    return out


def _require_losses(cfg, losses: list[float]) -> float:
    """A training run's losses: all finite, the first within
    ``INIT_LOSS_SLACK`` of a random init's ln V + 1/2, the last below the
    first.  Returns ln V + 1/2."""
    _require(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
    init_loss = math.log(cfg.vocab) + 0.5
    _require(abs(losses[0] - init_loss) < INIT_LOSS_SLACK,
             f"{cfg.name}'s step-1 loss {losses[0]} against a random init's "
             f"ln V + 1/2 = {init_loss}")
    _require(losses[-1] < losses[0],
             f"{cfg.name}'s loss falls: step 1 {losses[0]}, step "
             f"{len(losses)} {losses[-1]}")
    return init_loss


def _trace_step(run_step, dtype: str) -> dict:
    """One trace of ``run_step()`` for ``_traced_step``: the card time of
    its kernels, by kernel, class and range, and each family's time and
    share, the flash backward's on the dtype's path
    (``flash_bwd_path_ms``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)
               and ev.key not in STEP_RANGES]
    card_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    _require(card_ms > 0, "the traced train step ran nothing on the card")

    def share(names):
        return sum(ev.self_device_time_total for ev in kernels
                   if any(n in ev.key for n in names)) / 1e3

    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:8]
    by_class: dict = {}
    for ev in kernels:
        kind = _trace_class(ev.key)
        by_class[kind] = by_class.get(kind, 0.0) + (
            ev.self_device_time_total / 1e3)
    traced = {"card_ms": card_ms,
              "kernels": sum(ev.count for ev in kernels),
              "top_kernels_ms": {ev.key[:70]: ev.self_device_time_total
                                 / 1e3 for ev in top},
              "card_ms_by_class": by_class,
              "card_ms_by_range": _card_ms_by_range(prof)}
    fwd_path, bwd_path = TRAIN_FLASH_PATHS[dtype]
    for name, names in (("flash_bwd", FLASH_BWD_KERNELS),
                        ("flash_fwd", FLASH_FWD_KERNELS[fwd_path]),
                        ("ssd_bwd", SSD_BWD_KERNELS),
                        ("ssd_fwd", SSD_FWD_KERNELS),
                        ("slstm_bwd", SLSTM_BWD_KERNELS),
                        ("slstm_fwd", SLSTM_FWD_KERNELS)):
        traced[f"{name}_ms"] = share(names)
        traced[f"{name}_share"] = traced[f"{name}_ms"] / card_ms
    traced["flash_bwd_path_ms"] = share(
        FLASH_BWD_PATH_KERNELS[bwd_path])
    return traced


# a traced step's kernel families and the ``_step_launches`` key that says
# the step launches them
TRACED_FAMILIES = (("flash_bwd", "flash_attention_bwd"),
                   ("flash_fwd", "flash_attention"),
                   ("ssd_bwd", "ssd_scan_bwd"), ("ssd_fwd", "ssd_scan"),
                   ("slstm_bwd", "slstm_scan_bwd"), ("slstm_fwd", "slstm_scan"))
# traces of a step taken at most: the profiler may lose a trace's records
# (a run on the H100 lost 48 of a step's 391 kernels, its one flash
# forward among them), and a trace that lacks a family the step launched
# is taken again
TRACE_ATTEMPTS = 3


def _traced_step(run_step, per_step: dict, dtype: str = "float32") -> dict:
    """``run_step()`` (one train step) under ``torch.profiler``: the card
    time of its kernels, their count, the longest 8, and the time and share
    of the card time of the flash, SSD and sLSTM kernels, forward and
    backward;
    each kernel that ``per_step`` launches must show, the flash kernels all
    on the dtype's paths (``TRAIN_FLASH_PATHS``).  A trace that holds no
    record of a family the step launches is taken again, another step, up to
    ``TRACE_ATTEMPTS`` traces (``trace_attempts``); the checks hold the last
    one."""
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        traced = _trace_step(run_step, dtype)
        lost = [name for name, key in TRACED_FAMILIES
                if per_step[key] and not traced[f"{name}_ms"]]
        if not lost:
            break
        print(f"[train] trace {attempt} of the step holds no {lost} kernel "
              f"of the {traced['kernels']} it records", flush=True)
    traced["trace_attempts"] = attempt
    bwd_path = TRAIN_FLASH_PATHS[dtype][1]
    if per_step["flash_attention"]:
        _require(traced["flash_bwd_ms"] > 0 and traced["flash_fwd_ms"] > 0
                 and traced["flash_bwd_path_ms"] == traced["flash_bwd_ms"],
                 f"the traced step's flash kernels (the backward's all "
                 f"{bwd_path}): {traced}")
    if per_step["ssd_scan"]:
        _require(traced["ssd_bwd_ms"] > 0 and traced["ssd_fwd_ms"] > 0,
                 f"the traced step's SSD kernels: {traced}")
    if per_step["slstm_scan"]:
        _require(traced["slstm_bwd_ms"] > 0 and traced["slstm_fwd_ms"] > 0,
                 f"the traced step's sLSTM kernels: {traced}")
    ranges = traced["card_ms_by_range"]
    if per_step.get("adamw"):       # the update's card time in its kernels
        grad, upd = (ranges.get(name, {"card_ms": 0.0, "by_class": {}})
                     for name in STEP_RANGES)
        _require(upd["by_class"].get("adamw", 0.0) > 0.5 * upd["card_ms"]
                 and not grad["by_class"].get("adamw"),
                 f"the traced step's update in the AdamW kernels: {ranges}")
    return traced


_INT_OF_SIZE = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _bits(t):
    """``t``'s raw bits as integers of its element size."""
    import torch
    return t.detach().reshape(-1).view(
        getattr(torch, _INT_OF_SIZE[t.element_size()]))


def _fingerprint(tree) -> list[list[int]]:
    """Each leaf's raw bits as integers, summed on the card two ways in
    int64 (plainly, and weighted by position mod 65521, plus 1).  A change
    of any one element changes the plain sum, so trees with the same
    fingerprint are equal bit for bit but for changes that cancel in both
    sums; it reads each leaf once, where a host copy of a 43 GB state to
    compare with would not fit beside the next trainer."""
    import torch
    sums = []
    for leaf in _leaves(tree):
        flat = _bits(leaf)
        acc = torch.zeros(2, dtype=torch.int64, device=flat.device)
        for at in range(0, flat.numel(), 1 << 24):
            chunk = flat[at:at + (1 << 24)].to(torch.int64)
            pos = torch.arange(at, at + chunk.numel(), device=flat.device)
            acc[0] += chunk.sum()
            acc[1] += (chunk * (pos % 65521 + 1)).sum()
        sums.append(acc)
    return torch.stack(sums).tolist()


def _require_state_dtypes(cfg, params, opt_state) -> None:
    """The params in the model's dtype; float32 moments, and for bfloat16
    params a float32 master copy (the reference's AdamW)."""
    import torch
    dtype = getattr(torch, cfg.dtype)
    keys = {"m", "v", "step"} | ({"master"} if cfg.dtype != "float32"
                                 else set())
    _require(all(t.dtype == dtype for t in _leaves(params))
             and set(opt_state) == keys
             and all(t.dtype == torch.float32 for key in keys - {"step"}
                     for t in _leaves(opt_state[key])),
             f"{cfg.name}'s {cfg.dtype} params and float32 optimizer state "
             f"({sorted(opt_state)})")


def moe_bwd_determinism(cfg, batch: int, seq: int) -> dict:
    """Whether an atomic sum of non-zero rows reaches an MoE gradient, at
    the training shape: one full-width MoE block of ``cfg`` (in its dtype)
    on x [batch, seq, d] drawn N(0, 1) plus a part every token shares, its
    gradients (x, the router, the
    experts) for a random output gradient, twice as a train step takes
    them and once under ``torch.use_deterministic_algorithms``.  The gather
    back from the capacity slots (``models/moe.py``) has a ``scatter_add``
    for its backward, atomic on CUDA: every dropped (token, k) pair reads
    slot 0, so slot 0's gradient is such a sum, exact only if the dropped
    rows' gradients are exactly zero (their combine weight is 0).  The
    deterministic mode sums those rows in a fixed order; the three runs
    must agree bit for bit, with pairs dropped."""
    import warnings
    import torch
    from repro_torch.models.moe import dispatch_plan, init_moe, moe_block, route
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    params = init_moe(cfg.d_model, cfg.n_experts, cfg.d_ff,
                      cfg.moe_shared_ff, gen=gen, device=DEVICE, dtype=dtype)
    # a part shared by every token skews the routing, as a trained model's
    # hidden states do: experts overflow their capacity and pairs drop
    x = (torch.randn((batch, seq, cfg.d_model), generator=gen, device=DEVICE)
         + torch.randn(cfg.d_model, generator=gen, device=DEVICE)).to(dtype)
    dy = torch.randn(x.shape, generator=gen, device=DEVICE)
    inputs = [x, *_leaves(params)]
    for t in inputs:
        t.requires_grad_(True)

    def grads():
        y, aux = moe_block(params, x, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor)
        return torch.autograd.grad((y.float() * dy).sum() + aux, inputs)

    runs = [grads(), grads()]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs.append(grads())
        finally:
            torch.use_deterministic_algorithms(False)
    groups, sg, _, _ = dispatch_plan(batch * seq, cfg.top_k, cfg.n_experts,
                                     cfg.capacity_factor)
    with torch.no_grad():
        keep = route(params, x.reshape(groups, sg, -1), cfg.top_k,
                     cfg.capacity_factor, with_aux=False)[3]
    out = {"shape": [batch, seq, cfg.d_model], "dtype": cfg.dtype,
           "pairs": keep.numel(), "dropped": int((~keep).sum()),
           "equal_bit_for_bit": all(
               torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a),
                                                                _bits(c))
               for a, b, c in zip(*runs)),
           "nondeterministic_ops": sorted({str(w.message)[:120]
                                           for w in caught})}
    del params, x, dy, inputs, runs
    torch.cuda.empty_cache()
    print(f"[train] {cfg.name}'s MoE backward, atomics against the "
          f"deterministic mode: {out}", flush=True)
    _require(out["dropped"] > 0 and out["equal_bit_for_bit"],
             f"{cfg.name}'s MoE gradients repeat bit for bit: {out}")
    return out


def update_vs_plain(cfg, opt, data, steps: int) -> dict:
    """``steps`` train steps from ``init_params`` (seed 0) on the stream's
    first batches, three times, re-initialised from the same seed each
    time, one state at a time: with the AdamW kernels; with the eager leaf
    update on the kernels' gradient norm (``apply_updates_with``); with the
    eager update and the eager norm (``apply_updates_plain``, the update as
    it ran before the kernels).  The first two take the same scalars, so
    their losses must be equal, bit for bit.  The eager norm sums float32
    in another order, which moves the clip factor's last bits, and a
    bfloat16 step carries a last bit of its params into its losses: the
    third run's losses are held to the bfloat16 rule's step-loss limit
    (``bf16_grad_limits``, twice the reference's own bfloat16 drift); in
    float32 to rel 1e-4, the port's train-step convention.  The kernels'
    launches: one update a leaf, the norm's pass a leaf and a finalize a
    step; the eager run's none.  Each step's wall time."""
    import gc
    import numpy as np
    import torch
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import adamw
    from repro_torch.models import init_params
    from repro_torch.optim import apply_updates, init_opt_state
    from repro_torch.optim.adamw import apply_updates_plain, apply_updates_with
    from repro_torch.train import make_grad_step
    counters = _train_counters()
    per_step = _step_launches(cfg)
    arms = {"kernel": apply_updates,
            "plain_update": lambda p, g, s, opt: apply_updates_with(
                p, g, s, opt, norm=adamw.global_norm,
                update=adamw.update_plain),
            "plain": apply_updates_plain}
    out: dict = {}
    for name, apply in arms.items():
        params = init_params(cfg, seed=0, device=DEVICE)
        state = init_opt_state(params)
        step = split_step(make_grad_step(cfg, remat=False),
                          lambda p, g, s, apply=apply: apply(p, g, s, opt))
        stream = SyntheticStream(data)
        _reset(counters)
        losses, norms, walls = [], [], []
        for i in range(steps):
            batch = {k: torch.as_tensor(np.asarray(v), device=DEVICE)
                     for k, v in stream.batch_at(i).items()}
            t0 = time.perf_counter()
            params, state, met = step(params, state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            walls.append(time.perf_counter() - t0)
        n = _counts(counters)
        out[name] = {"losses": losses, "grad_norms": norms,
                     "step_ms": [1e3 * w for w in walls],
                     "adamw": n["adamw"], "adamw_norm": n["adamw_norm"]}
        del params, state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    limit = (bf16_grad_limits()[cfg.name]["steps"]
             if cfg.dtype == "bfloat16" else 1e-4)
    out["step_loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
        out["kernel"]["losses"], out["plain"]["losses"]))
    out["step_loss_limit"] = limit
    print(f"[train] {cfg.name} ({cfg.dtype}) {steps} steps with the AdamW "
          f"kernels, the eager update on their norm, and the eager update: "
          f"{out}", flush=True)
    _require(out["kernel"]["losses"] == out["plain_update"]["losses"]
             and out["step_loss_rel"] <= limit
             and out["kernel"]["adamw"] == steps * per_step["adamw"]
             and out["kernel"]["adamw_norm"] == steps * per_step["adamw_norm"]
             and out["plain_update"]["adamw"] == 0
             and out["plain_update"]["adamw_norm"]
             == steps * per_step["adamw_norm"]
             and out["plain"]["adamw"] == out["plain"]["adamw_norm"] == 0,
             f"{cfg.name}'s steps with the AdamW kernels against the eager "
             f"update: {out}")
    return out


def eager_steps(cfg, opt, batch_at, steps: int, remat: bool) -> dict:
    """The eager ``make_train_step`` (the step a ``TrainStepGraph``
    captures), ``steps`` steps from ``init_params(cfg, 0)`` on
    ``batch_at(i)``, i = 0, 1, ...: each step's loss and time to the card's
    end, the state's ``_fingerprint`` after each of the first
    ``GRAPH_EQ_STEPS``, as ``{"params", "opt"}`` (a ``Trainer``'s state
    tree), and the params' after the last.  The state is freed after: a
    second one of the largest runs does not fit beside the first."""
    import gc
    import statistics
    import torch
    from repro_torch.models import init_params
    from repro_torch.optim import init_opt_state
    from repro_torch.train import make_train_step
    params = init_params(cfg, seed=0, device=DEVICE)
    state = init_opt_state(params)
    step = make_train_step(cfg, opt, remat=remat)
    losses, walls, prints = [], [], []
    for i in range(steps):
        batch = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
        walls.append(time.perf_counter() - t0)
        if i < GRAPH_EQ_STEPS:
            prints.append(_fingerprint({"params": params, "opt": state}))
    final = _fingerprint(params)
    del params, state, met, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": [1e3 * w for w in walls],
            "step_ms_p50": 1e3 * statistics.median(walls[1:]),
            "fingerprints": prints, "final_params": final}


def _eager_summary(eager: dict) -> dict:
    """``eager_steps``'s result for the report: its losses and times."""
    return {k: eager[k] for k in ("losses", "step_ms", "step_ms_p50")}


def _graph_stats(graph) -> dict:
    """A ``TrainStepGraph``'s first step (its eager warm-up, then the
    capture), its replays and its pool."""
    return {"warmup_s": graph.warmup_s, "capture_s": graph.capture_s,
            "pool_gib": graph.pool_bytes / 2**30, "steps": graph.steps,
            "replays": graph.replays}


def _require_graph_is_eager(cfg, eager: dict, losses, prints) -> None:
    """A graphed run's losses and its state after each of the first
    ``GRAPH_EQ_STEPS`` steps against the eager run's, bit for bit.  Step 1
    is the graph's eager warm-up followed by its capture, so step 1's state
    equal to the eager step 1's shows that the capture left every leaf as it
    was."""
    _require(losses == eager["losses"][:len(losses)]
             and prints == eager["fingerprints"],
             f"{cfg.name}'s graphed steps against the eager make_train_step: "
             f"losses {losses} against {eager['losses']}, the state after "
             f"steps 1-{GRAPH_EQ_STEPS} "
             f"{[a == b for a, b in zip(prints, eager['fingerprints'])]}")


def train_one(run: dict) -> dict:
    """One model of phase 8 through the port's ``Trainer`` (its default pod
    monitor over 2 pods fed the measured step times), in the run's dtype,
    B x S of the synthetic Zipf stream.

    The straight run: a trainer takes steps 1 .. ckpt and checkpoints there
    (``save_async``; its run waits for the write at the end), then goes on
    to the last step with no further checkpoint.  A fresh trainer then
    restores the checkpoint (``try_restore``: params, AdamW state with a
    bfloat16 run's float32 master copy, the stream's skip-ahead): its state
    must equal the straight run's at the checkpoint, and after the
    remaining steps its losses and state must equal the straight run's, bit
    for bit (``_fingerprint``).  Then one more step's gradient with and
    without remat: the same loss and gradient norm.  The launch counts are
    set to 0 before each part and read after it, and must be
    ``_step_launches`` a step.  Last, one traced step: the card time of the
    flash, SSD and sLSTM kernels, forward and backward.  An MoE model first
    runs ``moe_bwd_determinism``."""
    import dataclasses
    import gc
    import shutil
    import statistics
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.optim import AdamWConfig, apply_updates, global_norm
    from repro_torch.train import make_grad_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    out = {"reduced_vs_cpu": train_reduced_vs_cpu(run)}
    cfg = dataclasses.replace(get_config(run["arch"]), dtype=run["dtype"])
    if run["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=run["layers"])
    if cfg.family == "moe":
        out["moe_bwd_determinism"] = moe_bwd_determinism(
            cfg, run["batch"], run["seq"])
    steps, ckpt = run["steps"], run["ckpt"]
    opt = AdamWConfig(lr=run["lr"], warmup_steps=TRAIN_WARMUP,
                      total_steps=steps)
    data = DataConfig(vocab=cfg.vocab, seq_len=run["seq"],
                      global_batch=run["batch"], seed=0)
    no_ckpt = 2 * steps                # a checkpoint interval never reached
    counters = _train_counters()
    per_step = _step_launches(cfg)
    stream = SyntheticStream(data)
    eager = eager_steps(
        cfg, opt, lambda i: {k: torch.as_tensor(np.asarray(v), device=DEVICE)
                             for k, v in stream.batch_at(i).items()},
        steps, remat=False)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        a = Trainer(cfg, opt, data,
                    TrainerConfig(total_steps=ckpt, checkpoint_every=ckpt,
                                  log_every=1, seed=0),
                    str(TRAIN_CKPT_DIR), device=DEVICE)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(a.params))
        _require_state_dtypes(cfg, a.params, a.opt_state)
        _reset(counters)
        first_s, prints = 0.0, []
        for k in range(1, ckpt + 1):          # steps 1 .. ckpt, one a run
            a.tcfg = dataclasses.replace(a.tcfg, total_steps=k)
            t0 = time.perf_counter()
            a.run()
            first_s += time.perf_counter() - t0
            if k <= GRAPH_EQ_STEPS:
                prints.append(_fingerprint(a._state_tree()))
        at_ckpt = prints[ckpt - 1]
        a.tcfg = dataclasses.replace(a.tcfg, total_steps=steps,
                                     checkpoint_every=no_ckpt)
        a.run()                                   # the rest
        n = _counts(counters)
        _require(n == {name: steps * k for name, k in per_step.items()},
                 f"{cfg.name}'s straight run's launches {n}: want "
                 f"{per_step} a step")
        at_end = _fingerprint(a._state_tree())
        out["launches_straight"] = n
        out["launches_per_step"] = per_step
        straight = [r["loss"] for r in a.history]
        walls = [r["wall_s"] for r in a.history]
        _require_graph_is_eager(cfg, eager, straight, prints)
        out["graph_is_eager_bit_for_bit"] = True
        out["eager"] = _eager_summary(eager)
        out["graph"] = _graph_stats(a.step_fn)
        _require(out["graph"]["replays"] == steps - 1,
                 f"{cfg.name}: steps 2-{steps} replays of the captured "
                 f"step: {out['graph']}")
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["checkpoint_s"] = first_s - sum(walls[:ckpt])
        out["losses"] = straight
        out["grad_norms"] = [r["grad_norm"] for r in a.history]
        out["step_ms"] = [1e3 * w for w in walls]
        out["step_ms_p50"] = 1e3 * statistics.median(walls[1:])
        out["tokens_per_s"] = run["batch"] * run["seq"] / (
            out["step_ms_p50"] / 1e3)
        out["rescale_events"] = [e.kind for e in a.supervisor.events]
        init_loss = _require_losses(cfg, straight)
        a.close()
        del a
        gc.collect()
        torch.cuda.empty_cache()

        b = Trainer(cfg, opt, data,
                    TrainerConfig(total_steps=steps, checkpoint_every=no_ckpt,
                                  log_every=1, seed=0),
                    str(TRAIN_CKPT_DIR), device=DEVICE)
        t0 = time.perf_counter()
        _require(b.try_restore() and b.step == ckpt and b.stream.step == ckpt,
                 f"restore of step {ckpt}: at step {b.step}")
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        _require_state_dtypes(cfg, b.params, b.opt_state)
        out["restored_state_bit_for_bit"] = (
            _fingerprint(b._state_tree()) == at_ckpt)
        _require(out["restored_state_bit_for_bit"],
                 f"{cfg.name}'s restored params and optimizer state against "
                 f"the straight run's at step {ckpt}")
        b.run()
        resumed = [r["loss"] for r in b.history]
        want = straight[ckpt:]
        out["resumed_losses"] = resumed
        out["resume_bit_for_bit"] = (resumed == want and _fingerprint(
            b._state_tree()) == at_end)
        _require(out["resume_bit_for_bit"],
                 f"{cfg.name}'s resumed steps {resumed} and state against "
                 f"the straight run's {want}")
        out["graph_resumed"] = _graph_stats(b.step_fn)
        b.close()               # its graph's pool, before the eager steps

        batch = {k: torch.as_tensor(np.asarray(v), device=DEVICE)
                 for k, v in b.stream.batch_at(steps).items()}
        remat = {}
        for on in (False, True):
            _reset(counters)
            grads, met = make_grad_step(cfg, remat=on)(b.params, batch)
            remat[on] = {"loss": float(met["total_loss"]),
                         "grad_norm": float(global_norm(grads)),
                         "launches": _counts(counters)}
            del grads, met
        out["remat"] = {str(k): v for k, v in remat.items()}
        for on in (False, True):      # the gradient, and the norm here
            want = {**_step_launches(cfg, on, update=False),
                    "adamw_norm": per_step["adamw_norm"]}
            _require(remat[on]["launches"] == want,
                     f"{cfg.name}'s grad step launches with remat={on}: "
                     f"{remat[on]['launches']}, want {want}")
        for key in ("loss", "grad_norm"):
            rel = abs(remat[True][key] - remat[False][key]) / abs(
                remat[False][key])
            out[f"remat_{key}_rel"] = rel
            _require(rel < 1e-5, f"remat changes the {key}: {remat}")

        # one more train step, traced: the kernels' card time by kernel and
        # by range (the gradient, the update)
        step = split_step(make_grad_step(cfg, remat=False),
                          lambda p, g, s: apply_updates(p, g, s, opt))

        def run_step():
            b.params, b.opt_state, met = step(b.params, b.opt_state, batch)
            float(met["loss"])
        traced = out["traced_step"] = _traced_step(run_step, per_step,
                                                   cfg.dtype)
        del b, batch, step
        gc.collect()
        torch.cuda.empty_cache()
        if run.get("plain_update_steps"):
            out["update_vs_plain"] = update_vs_plain(
                cfg, opt, data, run["plain_update_steps"])
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out.update(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
               params_b=n_params / 1e9, batch=run["batch"], seq=run["seq"],
               steps=steps, checkpoint_step=ckpt, lr=run["lr"],
               warmup_steps=TRAIN_WARMUP, init_loss_expected=init_loss,
               phase_s=time.perf_counter() - t_phase)
    print(f"[train] {out}", flush=True)
    print(f"[train] {cfg.name} x {cfg.n_layers} layers ({cfg.dtype}, "
          f"{out['params_b']:.3f} B params, B {run['batch']} x S "
          f"{run['seq']}): losses {straight}; step p50 "
          f"{out['step_ms_p50']:.1f} ms graphed against "
          f"{eager['step_ms_p50']:.1f} ms eager (steps 2-{steps}), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak "
          f"{out['peak_mem_gb']:.2f} GB, graph pool "
          f"{out['graph']['pool_gib']:.2f} GiB, capture "
          f"{out['graph']['capture_s']:.2f} s, bit for bit the eager step "
          f"(losses, state at steps 1-{GRAPH_EQ_STEPS}); checkpoint write "
          f"{out['checkpoint_s']:.1f} s, restore {out['restore_s']:.1f} s; "
          f"of a step's card time ({traced['card_ms']:.1f} ms) flash "
          f"forward {100 * traced['flash_fwd_share']:.1f}%, backward "
          f"{100 * traced['flash_bwd_share']:.1f}%, SSD backward "
          f"{100 * traced['ssd_bwd_share']:.1f}%, sLSTM forward and backward "
          f"{100 * (traced['slstm_fwd_share'] + traced['slstm_bwd_share']):.1f}"
          f"%; the gradient's range {_range_ms(traced, 0):.1f} ms, the "
          f"update's {_range_ms(traced, 1):.1f} ms of card time; resume "
          f"from step {ckpt} "
          f"bit for bit; {out['phase_s']:.0f} s", flush=True)
    return out


def prefixed_batch(cfg, shape, step: int, device) -> dict:
    """The train batch that ``train_batch_specs(cfg, shape)`` lays out, made
    real on ``device``: ``tokens`` and ``labels`` [B, S - P] of the
    synthetic Zipf stream's batch ``step`` (seed 0), and for a prefixed
    model a ``frontend`` [B, P, d] drawn N(0, 1) from a generator seeded
    with ``step``; each of the specs' shape and dtype."""
    import numpy as np
    import torch
    from repro_torch.configs import train_batch_specs
    from repro_torch.data import DataConfig, SyntheticStream
    specs = train_batch_specs(cfg, shape)
    stream = SyntheticStream(DataConfig(
        vocab=cfg.vocab, seq_len=specs["tokens"].shape[1],
        global_batch=shape.global_batch, seed=0))
    batch = {k: torch.as_tensor(np.asarray(v), device=device)
             for k, v in stream.batch_at(step).items()}
    if "frontend" in specs:
        g = torch.Generator(device=device)
        g.manual_seed(step)
        front = specs["frontend"]
        batch["frontend"] = torch.randn(front.shape, generator=g,
                                        device=device).to(front.dtype)
    for key, spec in specs.items():
        _require(batch[key].shape == spec.shape
                 and batch[key].dtype == spec.dtype,
                 f"the prefixed batch's {key}: {batch[key].shape} "
                 f"{batch[key].dtype}, the specs' {spec}")
    return batch


def train_direct(run: dict) -> dict:
    """A model of phase 8 outside the ``Trainer``, through a
    ``TrainStepGraph`` (the ``Trainer``'s step, without its checkpoint) on
    the batches ``prefixed_batch`` makes of ``train_batch_specs``: a vlm or
    audio model with its frontend prefix (the ``Trainer``'s synthetic
    stream emits no frontend, in the reference too), and the runs of
    ``TRAIN_DIRECT``.  First its reduced model card against CPU (and under
    the bfloat16 rule), an MoE model's ``moe_bwd_determinism``; then
    ``steps`` eager steps (``eager_steps``), freed; then ``steps`` graphed
    steps from the same init, each timed to the card's end, their launches
    set to 0 before the first and read after the last (``_step_launches``
    a step, no remat: the activations fit), their losses and the state
    after steps 1-4 the eager run's bit for bit; every loss finite, the
    first near a random init's ln V + 1/2, the last below the first; the
    peak memory and the graph's pool; one traced step."""
    import dataclasses
    import gc
    import statistics
    import torch
    from repro_torch.configs import InputShape, get_config, train_batch_specs
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state
    from repro_torch.train import make_grad_step
    from repro_torch.train.step_graph import TrainStepGraph

    t_phase = time.perf_counter()
    out = {"reduced_vs_cpu": train_reduced_vs_cpu(run)}
    cfg = dataclasses.replace(get_config(run["arch"]), dtype=run["dtype"])
    if run["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=run["layers"])
    if cfg.family == "moe":
        out["moe_bwd_determinism"] = moe_bwd_determinism(
            cfg, run["batch"], run["seq"])
    shape = InputShape("train", "train", run["seq"], run["batch"])
    steps = run["steps"]
    opt = AdamWConfig(lr=run["lr"], warmup_steps=TRAIN_WARMUP,
                      total_steps=steps)
    counters = _train_counters()
    per_step = _step_launches(cfg)
    eager = eager_steps(
        cfg, opt, lambda i: prefixed_batch(cfg, shape, i, DEVICE), steps,
        remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEVICE)
    opt_state = init_opt_state(params)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    _require_state_dtypes(cfg, params, opt_state)
    graph = TrainStepGraph(cfg, opt, params, opt_state,
                           train_batch_specs(cfg, shape), remat=False)
    losses, norms, walls, prints = [], [], [], []
    _reset(counters)
    for i in range(steps):
        batch = prefixed_batch(cfg, shape, i, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = {k: float(v) for k, v in graph.step(batch).items()}
        walls.append(time.perf_counter() - t0)
        losses.append(met["loss"])
        norms.append(met["grad_norm"])
        if i < GRAPH_EQ_STEPS:
            prints.append(_fingerprint({"params": params, "opt": opt_state}))
        print(f"[train] {cfg.name} step {i + 1} loss={met['loss']:.4f} "
              f"({walls[-1] * 1e3:.0f} ms)", flush=True)
    n = _counts(counters)
    _require(n == {name: steps * k for name, k in per_step.items()},
             f"{cfg.name}'s launches over {steps} graphed steps {n}: want "
             f"{per_step} a step")
    _require_graph_is_eager(cfg, eager, losses, prints)
    out["eager"] = _eager_summary(eager)
    out["graph"] = _graph_stats(graph)
    _require(out["graph"]["replays"] == steps - 1,
             f"{cfg.name}: steps 2-{steps} replays of the captured step: "
             f"{out['graph']}")
    n_text = batch["tokens"].numel()
    out.update(launches_straight=n, launches_per_step=per_step,
               graph_is_eager_bit_for_bit=True,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               losses=losses, grad_norms=norms,
               step_ms=[1e3 * w for w in walls],
               step_ms_p50=1e3 * statistics.median(walls[1:]),
               text_tokens_per_step=n_text)
    if "frontend" in batch:
        out["prefix_positions_per_step"] = (batch["frontend"].shape[0]
                                            * batch["frontend"].shape[1])
    out["tokens_per_s"] = n_text / (out["step_ms_p50"] / 1e3)
    init_loss = _require_losses(cfg, losses)
    graph.close()               # its graph's pool, before the eager step

    traced_step = split_step(make_grad_step(cfg, remat=False),
                             lambda p, g, s: apply_updates(p, g, s, opt))

    def run_step():
        float(traced_step(params, opt_state, batch)[2]["loss"])
    traced = out["traced_step"] = _traced_step(run_step, per_step, cfg.dtype)
    del params, opt_state, batch, graph, traced_step
    gc.collect()
    torch.cuda.empty_cache()
    out.update(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
               params_b=n_params / 1e9, batch=run["batch"], seq=run["seq"],
               prefix=cfg.frontend_len, steps=steps,
               lr=run["lr"], warmup_steps=TRAIN_WARMUP,
               init_loss_expected=init_loss,
               phase_s=time.perf_counter() - t_phase)
    print(f"[train] {out}", flush=True)
    layout = (f"B {run['batch']} x (P {cfg.frontend_len} + "
              f"{run['seq'] - cfg.frontend_len} text tokens)"
              if cfg.frontend_len and cfg.frontend != "none"
              else f"B {run['batch']} x S {run['seq']}")
    print(f"[train] {cfg.name} x {cfg.n_layers} layers ({cfg.dtype}, "
          f"{out['params_b']:.3f} B params, {layout}): losses {losses}; "
          f"step p50 {out['step_ms_p50']:.1f} ms graphed against "
          f"{eager['step_ms_p50']:.1f} ms eager (steps 2-{steps}), "
          f"{out['tokens_per_s']:.0f} text tokens/s, peak "
          f"{out['peak_mem_gb']:.2f} GB, graph pool "
          f"{out['graph']['pool_gib']:.2f} GiB, capture "
          f"{out['graph']['capture_s']:.2f} s, bit for bit the eager step; "
          f"of a step's card time ({traced['card_ms']:.1f} ms) flash forward "
          f"{100 * traced['flash_fwd_share']:.1f}%, backward "
          f"{100 * traced['flash_bwd_share']:.1f}%; the gradient's "
          f"range {_range_ms(traced, 0):.1f} ms, the update's "
          f"{_range_ms(traced, 1):.1f} ms of card time; "
          f"{out['phase_s']:.0f} s", flush=True)
    return out


def _train_key(out: dict) -> str:
    """A phase-8 run's name: ``train:<arch>x<layers>``, and ``:bfloat16``
    after it for a bfloat16 run."""
    key = f"train:{out['arch']}x{out['layers']}"
    return key if out["dtype"] == "float32" else f"{key}:{out['dtype']}"


def train(report: dict) -> dict:
    """Phase 8: ``train_one`` for each of ``TRAIN_RUNS``, then
    ``train_direct`` for each of ``TRAIN_PREFIXED`` and ``TRAIN_DIRECT``,
    one after the other.  Returns ``{_train_key(result): result}``."""
    trained = {}
    for run in TRAIN_RUNS:
        out = train_one(run)
        trained[_train_key(out)] = out
    for run in (*TRAIN_PREFIXED, *TRAIN_DIRECT):
        out = train_direct(run)
        trained[_train_key(out)] = out
    report["train"] = trained
    return trained


# -- phase 9: dry-run and placement -----------------------------------------------
# (a) The dry-run's sweep, its step as DTensors: every arch x shape on both
# production meshes (16 x 16 and 2 x 16 x 16 over a fake process group,
# meta shards; 80 cells), one process an arch, all started together (their
# CUDA hidden: the dry-run runs on the host)
DRYRUN_MESHES = ("single", "multi")
DRYRUN_TIMEOUT = 600
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun_torch"
# (b) granite-8b x 8 (a deeper cut than phase 8's), as a host-mesh cell, in
# float32 and bfloat16, its step as DTensors on the card's (1, 1) CUDA
# mesh: the argument bytes and the peak the dry-run predicts are held to
# what the card allocates for them (relative 1e-6; the peak's ratio within
# 1e-4 of 1), and the real step as DTensors to the plain step: the same
# loss, bit for bit, and the same kernel launches
GROUND = {"arch": "granite-8b", "layers": 8, "batch": 2, "seq": 2048}
GROUND_ARG_TOL = 1e-6
GROUND_PEAK_TOL = 1e-4
# (c) the torch placement score: the node DAG under a queue penalty, and
# seeded draws of (PTT values, loads) scored on the card
SCORE_PENALTY = 0.05
SCORE_DRAWS = 10_000


def start_dryrun_sweep() -> dict:
    """Start phase 9 (a)'s processes: each arch's cells in a process of its
    own (``python -m repro_torch.launch.dryrun``), all together, on the
    host with CUDA hidden.  ``main`` starts them right after the build, so
    that they run beside phases 3 and 4 (the checks, and kernel times taken
    on the card's clock), and collects them (``dryrun_sweep``) before
    phase 5; ``stop_dryrun_sweep`` ends any still running."""
    import subprocess
    from repro_torch.configs import ARCHS
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    mesh = "both" if len(DRYRUN_MESHES) == 2 else DRYRUN_MESHES[0]
    return {"t0": time.perf_counter(), "procs": {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--all", "--mesh", mesh, "--out", str(DRYRUN_OUT)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch in ARCHS}}


def stop_dryrun_sweep(started: dict) -> None:
    for proc in started["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_sweep(started: dict) -> dict:
    """Phase 9 (a): every arch x shape on each mesh of ``DRYRUN_MESHES``
    from the processes ``start_dryrun_sweep`` started; no cell may fail,
    every OK cell carries its observed and derived collectives, every
    train cell a gradient reduction over the data axes.  Per cell: the
    per-device flops, bytes and peak, their ratio to the even split (the
    whole step's over the devices), the observed and derived collective
    totals, ``dominant``; the count of cells each roofline term
    dominates; ``seconds`` from the start to the last process's end, and
    ``waited_s`` what collecting them waited."""
    import json
    from repro_torch.configs import ARCHS, SHAPES
    t0, procs = started["t0"], started["procs"]
    t_wait = time.perf_counter()
    logs = {}
    try:
        for arch, proc in procs.items():
            logs[arch], _ = proc.communicate(
                timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        stop_dryrun_sweep(started)
    waited_s = time.perf_counter() - t_wait
    recs = [json.loads((DRYRUN_OUT / f"{arch}__{shape}__{m}.json")
                       .read_text())
            for m in DRYRUN_MESHES for arch in ARCHS for shape in SHAPES]
    counts = {k: sum(r["status"] == k for r in recs)
              for k in ("OK", "SKIPPED", "FAIL")}
    ok = [r for r in recs if r["status"] == "OK"]
    dominant = {term: sum(r["roofline"]["dominant"] == term for r in ok)
                for term in ("compute", "memory", "collective")}
    out = {"counts": counts, "seconds": time.perf_counter() - t0,
           "waited_s": waited_s, "dominant": dominant, "cells": {}}
    for r in recs:
        cell = {k: r.get(k) for k in ("status", "seconds", "fits_hbm",
                                      "error")}
        if r["status"] == "OK":
            w = r["work"]
            coll, derived = r["collectives"], r["collectives_derived"]
            cell.update(
                flops_per_device=w["flops"], bytes_per_device=w["bytes"],
                peak_bytes_per_device=w["peak_bytes"],
                over_even_split=w["whole"]["per_device_over_even_split"],
                collective_bytes_observed=coll["bytes"]["total"],
                collective_bytes_derived=derived["bytes"]["total"],
                dominant=r["roofline"]["dominant"],
                roofline_s={k: r["roofline"][f"{k}_s"] for k in (
                    "compute", "memory", "collective")},
                dp_grad_bytes=_dp_grad_bytes(coll))
            even = cell["over_even_split"]     # x the even split
            print(f"[dryrun] {r['arch']} {r['shape']} {r['mesh']}: "
                  f"{w['flops']:.2e} fl {even['flops']:.2f}x, "
                  f"{w['bytes']:.2e} B {even['bytes']:.2f}x, "
                  f"{w['peak_bytes'] / 1e9:.2f} GB {even['peak_bytes']:.2f}x;"
                  f" coll {coll['bytes']['total']:.2e} / derived "
                  f"{derived['bytes']['total']:.2e}; {cell['dominant']}",
                  flush=True)
        out["cells"][f"{r['arch']}__{r['shape']}__{r['mesh']}"] = cell
    print(f"[dryrun] sweep as DTensors: {counts['OK']} OK, "
          f"{counts['SKIPPED']} skipped, {counts['FAIL']} failed of "
          f"{len(recs)} cells in {out['seconds']:.1f} s; the dominant "
          f"roofline term: {dominant}", flush=True)
    _require(all(p.returncode == 0 for p in procs.values()),
             "dry-run processes failed: " + "; ".join(
                 f"{a}: {logs.get(a, '')[-600:]}" for a, p in procs.items()
                 if p.returncode != 0))
    _require(counts["FAIL"] == 0, "dry-run cells failed: " + ", ".join(
        k for k, v in out["cells"].items() if v["status"] == "FAIL"))
    no_dp = [k for k, v in out["cells"].items() if "__train_4k__" in k
             and not v["dp_grad_bytes"]]
    _require(not no_dp, f"train cells with no DP gradient reduction: {no_dp}")
    return out


def _dp_grad_bytes(coll: dict) -> int:
    """The bytes of the reductions a cell's step issues over the data axis
    (observed: ``entries`` named by mesh axis), all-reduce 2x."""
    return sum((2 if e["kind"] == "all-reduce" else 1) * e["bytes_each"]
               * e["count"] for e in coll["entries"]
               if e["kind"] in ("all-reduce", "reduce-scatter")
               and e["axis"] in ("pod", "data"))


def _ground_step(cfg, shape, distributed: bool) -> dict:
    """The grounding cell's step on the card (one microbatch, remat, the
    dry-run's ``make_accum_train_step``), its leaves DTensors on the (1, 1)
    CUDA mesh where ``distributed`` (under ``sharding_ctx``: the kernels
    run through their sharding rules): the arguments' and the peak's
    growth of ``memory_allocated``, the loss, the launches, the seconds."""
    import contextlib
    import gc
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.parallel import (batch_specs, distribute,
                                      opt_moment_specs, param_specs,
                                      sharding_ctx)
    counters = _train_counters()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=0, device=DEVICE)
    opt_state = init_opt_state(params)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (shape.global_batch,
                                             shape.seq_len),
                              generator=g, device=DEVICE, dtype=torch.int32)
             for k in ("tokens", "labels")}
    ctx = contextlib.nullcontext()
    grad_specs = None
    if distributed:
        mesh = make_host_mesh()
        moments = opt_moment_specs(params, mesh)
        ospecs = {"m": moments, "v": moments, "step": ()}
        if "master" in opt_state:
            ospecs["master"] = moments
        params = distribute(params, param_specs(params, mesh), mesh)
        opt_state = distribute(opt_state, ospecs, mesh)
        batch = distribute(batch, batch_specs(batch, mesh), mesh)
        ctx, grad_specs = sharding_ctx(mesh), moments
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    micro_grad, update = dryrun.make_accum_train_step(
        cfg, AdamWConfig(), n_micro=1, grad_specs=grad_specs)
    t0 = time.perf_counter()
    with ctx:
        gsum, loss = micro_grad(params, batch, None)
        update(params, opt_state, gsum)
        if distributed:
            loss = loss.to_local()
    torch.cuda.synchronize()
    out = {"args": args, "peak": torch.cuda.max_memory_allocated() - base,
           "loss": float(loss), "launches": _counts(counters),
           "step_s": time.perf_counter() - t0}
    del params, opt_state, batch, gsum, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dryrun_grounding(dtype: str = "float32") -> dict:
    """Phase 9 (b): the host-mesh dry-run cell of ``GROUND`` (in ``dtype``,
    B x S, one microbatch, remat, the dry-run's step, as DTensors on the
    card's (1, 1) CUDA mesh) against the same step on the card: first
    plain, then as DTensors on that mesh (the flash and AdamW kernels
    through their sharding rules), the same loss bit for bit and the same
    launches; the predicted argument bytes (params, AdamW state with a
    bfloat16 cell's float32 master copy, batch) within ``GROUND_ARG_TOL``
    of what ``memory_allocated`` grows by when they are built and
    distributed; the predicted peak (arguments + the step's temporaries)
    within ``GROUND_PEAK_TOL`` of ``max_memory_allocated``'s growth over
    the DTensor step; the counted flops beside 6 N tokens."""
    import dataclasses
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    cfg = dataclasses.replace(get_config(GROUND["arch"]),
                              n_layers=GROUND["layers"], dtype=dtype)
    shape = InputShape("train_b2_s2048" + (
        "" if dtype == "float32" else f"_{dtype}"), "train", GROUND["seq"],
        GROUND["batch"])
    rec = dryrun.run_cell(cfg.name, shape.name, "host", DRYRUN_OUT, cfg=cfg,
                          shape=shape, mesh=make_host_mesh(), n_micro=1)
    _require(rec["status"] == "OK", f"host dry-run cell: {rec.get('error')}")
    pred_args = sum(rec["argument_bytes_per_device"].values())
    pred_peak = pred_args + rec["memory"]["temp_bytes_per_device"]
    plain = _ground_step(cfg, shape, distributed=False)
    dist = _ground_step(cfg, shape, distributed=True)
    args, peak = dist["args"], dist["peak"]
    out = {"cell": f"{cfg.name} x {cfg.n_layers} layers, {dtype}, B "
                   f"{shape.global_batch} x S {shape.seq_len}, remat",
           "mesh": rec["mesh_shape"], "mesh_device": rec["mesh_device"],
           "predicted_args_bytes": pred_args, "allocated_args_bytes": args,
           "args_rel_err": abs(args - pred_args) / pred_args,
           "plain_args_bytes": plain["args"],
           "predicted_peak_bytes": pred_peak, "measured_peak_bytes": peak,
           "plain_peak_bytes": plain["peak"],
           "peak_ratio": pred_peak / peak,
           "counted_flops": rec["work"]["flops"],
           "counted_flops_whole": rec["work"]["whole"]["flops"],
           "model_flops_6nt": rec["roofline"]["model_flops"],
           "counted_over_6nt": rec["work"]["flops"]
           / rec["roofline"]["model_flops"],
           "kernels": rec["work"]["parts"]["micro"]["kernels"],
           "launches": dist["launches"], "plain_launches": plain["launches"],
           "loss": dist["loss"], "plain_loss": plain["loss"],
           "step_s": dist["step_s"], "plain_step_s": plain["step_s"],
           "dryrun_s": rec["seconds"]}
    print(f"[dryrun] grounding {out['cell']} as DTensors on the "
          f"{out['mesh']} {out['mesh_device']} mesh: arguments predicted "
          f"{pred_args / 1e9:.4f} GB, allocated {args / 1e9:.4f} GB (rel "
          f"{out['args_rel_err']:.2e}); peak predicted {pred_peak / 1e9:.4f} "
          f"GB, measured {peak / 1e9:.4f} GB (ratio {out['peak_ratio']:.8f});"
          f" flops counted {out['counted_flops']:.4e}, 6 N tokens "
          f"{out['model_flops_6nt']:.4e} ({out['counted_over_6nt']:.3f}x); "
          f"loss {dist['loss']!r} (plain {plain['loss']!r}); launches "
          f"{dist['launches']} (plain {plain['launches']}); step "
          f"{dist['step_s']:.2f} s (plain {plain['step_s']:.2f})", flush=True)
    _require(out["args_rel_err"] <= GROUND_ARG_TOL,
             f"predicted argument bytes {pred_args} against {args} "
             f"allocated")
    _require(abs(out["peak_ratio"] - 1) <= GROUND_PEAK_TOL,
             f"predicted peak {pred_peak} against {peak} measured")
    _require(math.isfinite(dist["loss"]) and dist["loss"] == plain["loss"],
             f"grounding step's loss as DTensors {dist['loss']!r}, plain "
             f"{plain['loss']!r}")
    _require(dist["launches"] == plain["launches"]
             and dist["launches"]["flash_attention"] > 0
             and dist["launches"]["adamw"] > 0,
             f"grounding step's launches as DTensors {dist['launches']}, "
             f"plain {plain['launches']}")
    return out


def _ulps(a, b):
    """Distance in float32 ulps of float32 arrays of one sign."""
    import numpy as np
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def placement_on_card() -> dict:
    """Phase 9 (c): the node DAG once more under DAM-C with
    ``queue_penalty=SCORE_PENALTY``, ``track_load`` and
    ``placement_backend="torch"`` (the score on the card), held to the node
    path's checks (``_counted_node_run``), with the hook's calls counted
    and timed; then ``SCORE_DRAWS`` seeded draws of (PTT values, loads,
    penalty) scored on the card against numpy: within 1 float32 ulp of its
    float32 evaluation of the inputs rounded to float32 (as the hook takes
    them), within 2 of its float64 scores rounded (no float32 evaluation
    holds 1 there: the inputs are rounded first), and where the two lowest
    float32 scores lie more than 2 ulps apart, the same argmin."""
    import numpy as np
    import torch
    from repro_torch.core import make_scheduler, tpu_pod_slices
    sched = make_scheduler("DAM-C", tpu_pod_slices(2, 2), seed=0,
                           queue_penalty=SCORE_PENALTY, track_load=True,
                           placement_backend="torch")
    hook = sched.score_fn
    calls = []

    def timed(vals, load, penalty):
        t0 = time.perf_counter()
        score = hook(vals, load, penalty)
        calls.append((load is not None, time.perf_counter() - t0))
        return score

    sched.score_fn = timed
    run = _counted_node_run(sched)
    on_card = [dt for loaded, dt in calls if loaded]
    _require(on_card, "no placement search scored a load on the card")
    node = {"committed": run["metrics"].n_tasks,
            "makespan_s": run["metrics"].makespan,
            "launches": run["launches"], "score_calls": len(calls),
            "score_calls_on_card": len(on_card),
            "score_us_per_call": 1e6 * sum(on_card) / len(on_card),
            "plain_agreement_max_abs_err": {
                k: v[1] for k, v in run["agree"].items()}}
    del run
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    worst = {"float32": 0, "float64": 0}
    at = {"float32": [0, 0], "float64": [0, 0, 0]}
    argmin_checked = argmin_same = 0
    t0 = time.perf_counter()
    for _ in range(SCORE_DRAWS):
        n = int(rng.integers(2, 65))
        vals = rng.exponential(1e-3, n)
        load = rng.exponential(5e-3, n)
        penalty = float(rng.uniform(0.0, 1.0))
        got = hook(vals, load, penalty)
        want = {"float32": (vals.astype(np.float32) + np.float32(penalty)
                            * load.astype(np.float32)),
                "float64": (vals + penalty * load).astype(np.float32)}
        for k, w in want.items():
            u = _ulps(got, w)
            worst[k] = max(worst[k], int(u.max()))
            for i in range(len(at[k])):
                at[k][i] += int((u == i).sum())
        lo = np.argsort(want["float32"], kind="stable")[:2]
        if _ulps(want["float32"][lo[1:]], want["float32"][lo[:1]])[0] > 2:
            argmin_checked += 1
            argmin_same += int(np.argmin(got) == lo[0])
    draws_s = time.perf_counter() - t0
    out = {"node_dag": node, "draws": SCORE_DRAWS,
           "worst_ulps": worst, "elements_at_ulps": at,
           "argmin_checked": argmin_checked, "argmin_same": argmin_same,
           "draw_us_per_call": 1e6 * draws_s / SCORE_DRAWS}
    print(f"[placement] torch score on the card: node DAG {node['committed']}"
          f" tasks committed, {node['score_calls_on_card']} of "
          f"{node['score_calls']} score calls on the card, "
          f"{node['score_us_per_call']:.1f} us a call; {SCORE_DRAWS} draws: "
          f"worst {worst} ulps, argmin same {argmin_same} of "
          f"{argmin_checked}, {out['draw_us_per_call']:.1f} us a call",
          flush=True)
    _require(worst["float32"] <= 1 and worst["float64"] <= 2,
             f"card scores off numpy's by {worst} ulps")
    _require(argmin_same == argmin_checked,
             f"argmin differs on {argmin_checked - argmin_same} draws")
    return out


def dryrun_and_placement(report: dict, sweep: dict) -> dict:
    """Phase 9: (a) the meta sweep (collected before phase 5), (b) the
    grounding on the card, (c) the torch placement score on the card."""
    out = {"sweep": sweep, "grounding": dryrun_grounding(),
           "grounding_bf16": dryrun_grounding("bfloat16"),
           "placement": placement_on_card()}
    report["dryrun_placement"] = out
    return out


# -- phase 10: the examples' twins on the card ------------------------------------
# ``python -m repro_torch.examples.<name>`` through each twin's ``main``:
# the quickstart (reduced qwen2.5-14b, 20 steps and a greedy generation)
# and serve_lm (reduced stablelm-3b, RWS and DAM-P, place 0 slowed 4x) as
# they are; train_lm at full-width xlstm-125m with its own seq 256 x batch
# 4, cut from 300 steps to TRAIN_LM_STEPS (the cut this phase makes), beside
# an uninterrupted run of the same steps.
TRAIN_LM_STEPS = 20
TRAIN_LM_CKPT = TRAIN_CKPT_DIR / "train_lm"


def _twin_quickstart(counters) -> dict:
    """The quickstart: losses finite and the last below the first; flash
    attention forward twice per attention block a step (its step is
    ``make_train_step``'s default, which rematerialises, as the
    reference's) and once per block in the generation's prefill, backward
    once per block a step.  Its step is a ``TrainStepGraph`` (the
    original's is jitted): its losses and its trained params are the eager
    ``make_train_step``'s from the same init and batches, bit for bit.  The
    generation's logits, finite and not constant, against a forward of the
    prompt and the generated tokens on the trained weights at the next
    position, each under rel 5e-3, the model tolerance (its ids alone are
    the stream's most frequent token)."""
    import torch
    from repro_torch.data import SyntheticStream
    from repro_torch.examples import quickstart
    from repro_torch.models import forward
    _reset(counters)
    t0 = time.perf_counter()
    q = quickstart.main([])
    seconds = time.perf_counter() - t0
    got = _counts(counters)
    stream = SyntheticStream(q["data"])
    eager = eager_steps(q["cfg"], q["opt"], lambda i: {
        k: torch.as_tensor(v, device=DEVICE)
        for k, v in stream.batch_at(i).items()}, quickstart.STEPS,
        remat=True)
    _require(q["losses"] == eager["losses"]
             and _fingerprint(q["params"]) == eager["final_params"],
             f"the quickstart's graphed losses {q['losses']} and trained "
             f"params against the eager step's {eager['losses']}")
    toks = torch.cat([q["prompt"], torch.as_tensor(
        [q["generated"][:-1]], dtype=q["prompt"].dtype,
        device=q["prompt"].device)], dim=1)
    with torch.no_grad():
        full, _ = forward(q["params"], q["cfg"], toks)
    n = q["prompt"].shape[1]
    rels = []
    for i, step in enumerate(q["logits"]):
        _require(bool(torch.isfinite(step).all())
                 and bool(step.max() > step.min()),
                 f"quickstart logits of step {i}: finite, not constant")
        rels.append(_rel(step, full[:, n - 1 + i]))
    _require(max(rels) < 5e-3,
             f"quickstart generation against forward: rel {rels}")
    per_step = _step_launches(q["cfg"], remat=True)
    want = {"flash_attention": quickstart.STEPS * per_step["flash_attention"]
            + _launches_per_prefill(q["cfg"])["flash_attention"],
            "flash_attention_bwd": quickstart.STEPS
            * per_step["flash_attention_bwd"]}
    losses = q["losses"]
    _require(all(math.isfinite(x) for x in losses)
             and losses[-1] < losses[0], f"quickstart losses {losses}")
    _require(all(got[k] == v for k, v in want.items()),
             f"quickstart launches {got} against the plan's {want}")
    return {"losses": losses, "generated": q["generated"],
            "logits_rel_max": max(rels), "launches": got, "plan": want,
            "graph_is_eager_bit_for_bit": True,
            "eager_step_ms_p50": eager["step_ms_p50"], "seconds": seconds}


def _twin_serve_lm(counters) -> dict:
    """serve_lm: 10 of 10 requests complete under each scheduler; flash
    attention once per attention block a prefill, and a prefill graph's
    capture's warm-up run (``WARMUP_RUNS`` a bucket) a prefill too."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_lm
    from repro_torch.serve.prefill_graph import WARMUP_RUNS
    _reset(counters)
    t0 = time.perf_counter()
    res = serve_lm.main([])
    seconds = time.perf_counter() - t0
    got = _counts(counters)
    prefills = sum(r["prefills"] + WARMUP_RUNS * r["prefill_captures"]
                   for r in res.values())
    _require(all(r["prefill_captures"] == 3 for r in res.values()),
             f"serve_lm: a prefill graph a bucket (16, 32, 64): {res}")
    want = prefills * _launches_per_prefill(
        get_config("stablelm-3b").reduced())["flash_attention"]
    _require(all(r["stats"]["completed"] == serve_lm.REQUESTS
                 for r in res.values()), "serve_lm requests incomplete")
    _require(got["flash_attention"] == want,
             f"serve_lm flash launches {got['flash_attention']} against "
             f"{prefills} prefills' {want}")
    return {sched: {"completed": r["stats"]["completed"],
                    "ttft_ms_mean": r["stats"]["ttft_ms_mean"],
                    "ttft_ms_p95": r["stats"]["ttft_ms_p95"],
                    "prefills_on_slow": r["prefills_on_slow"]}
            for sched, r in res.items()} | {
        "launches": got, "plan": {"flash_attention": want},
        "seconds": seconds}


def _twin_train_lm(counters, smi: str) -> dict:
    """train_lm at full-width xlstm-125m (seq 256 x batch 4), cut to
    ``TRAIN_LM_STEPS``: its crash and resume, then an uninterrupted run of
    the same steps, whose losses the resumed steps equal bit for bit; the
    SSD forward and backward once per Mamba-2 layer and twice per mLSTM
    layer a step, the sLSTM scan's once per sLSTM layer; the step time beside the card's name and power limit.
    Both runs start from the same seed, so their first halves are equal
    too."""
    import shutil
    import statistics
    from repro_torch.examples import train_lm
    shutil.rmtree(TRAIN_LM_CKPT, ignore_errors=True)
    _reset(counters)
    t0 = time.perf_counter()
    t = train_lm.main(["--steps", str(TRAIN_LM_STEPS), "--ckpt-dir",
                       str(TRAIN_LM_CKPT / "resume")])
    seconds = time.perf_counter() - t0
    got = _counts(counters)
    per = _step_launches(t["cfg"])
    want = {k: TRAIN_LM_STEPS * per[k] for k in ("ssd_scan", "ssd_scan_bwd",
                                                 "slstm_scan",
                                                 "slstm_scan_bwd")}
    straight = train_lm.make_trainer(
        t["cfg"], t["steps"], t["steps"], t["seq"], t["batch"],
        str(TRAIN_LM_CKPT / "straight"), DEVICE, 2 * t["steps"])
    hist = straight.run()
    straight.close()
    shutil.rmtree(TRAIN_LM_CKPT, ignore_errors=True)
    crashed = [h["loss"] for h in t["first"] + t["resumed"]]
    uninterrupted = [h["loss"] for h in hist]
    walls = [h["wall_s"] for h in (t["first"] + t["resumed"])[1:]]
    step_ms = 1e3 * statistics.median(walls)
    tokens = t["seq"] * t["batch"]
    out = {"cut": f"steps {TRAIN_LM_STEPS} of the original's 300",
           "seq": t["seq"], "batch": t["batch"],
           "resumed_at": t["resumed_at"], "events": t["events"],
           "losses": crashed, "losses_uninterrupted": uninterrupted,
           "launches": got, "plan": want, "step_ms_median": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3), "card": smi,
           "seconds": seconds}
    print(f"[examples] train_lm xlstm-125m (seq {t['seq']} x batch "
          f"{t['batch']}, {TRAIN_LM_STEPS} steps, resumed at "
          f"{t['resumed_at']}): step {step_ms:.1f} ms median, "
          f"{out['tokens_per_s']:.0f} tokens/s on {smi}", flush=True)
    _require(crashed == uninterrupted,      # the resumed steps among them
             f"train_lm losses {crashed} against {uninterrupted}")
    _require(all(math.isfinite(x) for x in crashed), "train_lm losses")
    _require(all(got[k] == v for k, v in want.items()),
             f"train_lm launches {got} against the plan's {want}")
    return out


def examples_on_card(report: dict, smi: str) -> dict:
    """Phase 10: the twins of ``examples/`` on the card, each with the launch
    counts set to 0 just before it and read just after."""
    counters = _train_counters()
    out = {"quickstart": _twin_quickstart(counters),
           "serve_lm": _twin_serve_lm(counters),
           "train_lm": _twin_train_lm(counters, smi)}
    q, s = out["quickstart"], out["serve_lm"]
    print(f"[examples] quickstart: loss {q['losses'][0]:.4f} -> "
          f"{q['losses'][-1]:.4f}, generation against forward rel "
          f"{q['logits_rel_max']:.3g}, "
          f"flash {q['launches']['flash_attention']}"
          f" forward / {q['launches']['flash_attention_bwd']} backward "
          f"launches; serve_lm: 10 of 10 under RWS and DAM-P, "
          f"{s['launches']['flash_attention']} flash launches", flush=True)
    report["examples"] = out
    return out


def _rel_by_token(got, want) -> list[float]:
    """``_rel`` of each token's logits (the last axis) apart."""
    got, want = got.double().cpu(), want.double().cpu()
    err = (got - want).abs().amax(-1) / want.abs().amax(-1)
    return err.flatten().tolist()


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32,
    torch.backends.cudnn.allow_tf32 = False         # as the reference's
    phase_s: dict = {}              # each phase's wall seconds, in order
    mark = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now

    t_run = mark[0]
    smi = _smi()
    print(smi, flush=True)
    report: dict = {"nvidia_smi": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "device": torch.cuda.get_device_name(0)}

    t0 = time.perf_counter()
    built = build.build()
    report["build_s"] = time.perf_counter() - t0
    report["build"] = built
    for name, res in built.items():
        regs = [ln.strip() for ln in res["log"].splitlines()
                if "registers" in ln or "spill" in ln or "C75" in ln]
        print(f"[build] {name}: {res['seconds']:.1f} s {regs}", flush=True)
    lap("build")
    started = start_dryrun_sweep()
    try:
        return _phases(report, smi, phase_s, lap, mark, t_run, started)
    finally:
        stop_dryrun_sweep(started)


def _phases(report, smi, phase_s, lap, mark, t_run, started) -> int:
    """Phases 3-10 and the result lines (the module doc); phase 9's sweep
    processes, ``started`` after the build, run beside phases 3-4 and are
    collected after them."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config

    flash_err = check_flash(report)
    flash_bwd_err = check_flash_bwd(report)
    ssd_err = check_ssd(report)
    ssd_bwd_err = check_ssd_bwd(report)
    slstm_err = check_slstm(report)
    slstm_len_err = check_slstm_lengths(report)
    matmul_err = check_matmul(report)
    copy_err = check_copy(report)
    stencil_err = check_stencil(report)
    adamw_err = check_adamw(report)
    lap("check")
    flash_timing = time_flash(report)
    flash_bwd_timing = time_flash_bwd(report)
    ssd_timing = time_ssd(report)
    ssd_bwd_timing = time_ssd_bwd(report)
    slstm_timing = time_slstm(report)
    matmul_timing = time_matmul(report)
    copy_timing = time_copy(report)
    stencil_timing = time_stencil(report)
    adamw_timing = time_adamw(report)
    lap("time")
    sweep = dryrun_sweep(started)
    lap("dryrun_sweep_wait")
    node = node_dag(report)
    lap("node_dag")
    served = []
    t_serve = time.perf_counter()
    for arch, dtype in SERVED:
        served.append(serve(report, dataclasses.replace(
            get_config(arch), dtype=dtype,
            n_layers=SERVED_LAYERS.get(arch, get_config(arch).n_layers))))
        lap(f"serve:{arch}")
    report["serve_phase_s"] = time.perf_counter() - t_serve
    print(f"[time] serve phase {report['serve_phase_s']:.1f} s", flush=True)
    trained = train(report)
    for key, out in trained.items():
        phase_s[key] = out["phase_s"]
    mark[0] = time.perf_counter()
    dryrun_and_placement(report, sweep)
    lap("dryrun_placement")
    examples = examples_on_card(report, smi)
    lap("examples")
    report["phase_s"] = phase_s
    report["total_s"] = time.perf_counter() - t_run
    print(f"[time] {report['total_s']:.1f} s in all; by phase "
          f"{ {k: round(v, 1) for k, v in phase_s.items()} }", flush=True)

    def kernel_row(name, row, max_err, replaces, by_path, bf16=None,
                   bf16_err=None):
        out = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": max_err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"],
            "launches_by_path": by_path,
        }
        if "path" in row:
            out["path"] = row["path"]
        if bf16 is not None:        # the redesigned kernels' bfloat16 path
            out["bfloat16"] = {
                "path": bf16["path"], "shape": bf16["shape"],
                "max_abs_err": bf16_err, "ms": bf16["ms"],
                "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
                "bound_by": bf16["bound_by"],
                "library_ms": bf16["library_ms"]}
        return out

    def served_by(name):
        return {o["arch"]: o["launches"][name] for o in served}

    def trained_by(name):
        return {key: out["launches_straight"][name]
                for key, out in trained.items()
                if out["launches_straight"][name]}

    def node_by(name):
        return {"node_dag": node["launches"][name]}

    def examples_by(name):
        return {f"examples:{twin}": out["launches"][name]
                for twin, out in examples.items()
                if out["launches"].get(name)}

    def flash_at(dtype, heads=(32, 8, 1024, 128), b=1):  # granite-8b's
        return next(r for r in flash_timing if r["dtype"] == dtype
                    and r["shape"][0] == b
                    and r["shape"][1:4] + r["shape"][5:] == list(heads))

    flash_row = kernel_row("flash_attention", flash_at("float32"),
                           flash_err["float32"],
                           "src/repro/kernels/flash_attention.py:79",
                           {**served_by("flash_attention"),
                            **trained_by("flash_attention"),
                            **examples_by("flash_attention")},
                           flash_at("bfloat16"), flash_err["bfloat16"])
    flash_row["fma_ms"] = flash_at("float32")["fma_ms"]
    flash_row["fma_bound_ms"] = flash_at("float32")["fma_bound_ms"]
    flash_row["bfloat16_served"] = {
        arch: {k: r[k] for k in ("path", "shape", "ms", "plain_ms",
                                 "library_ms", "bound_ms", "bound_by")}
        for arch, r in (
            ("qwen3-moe-30b-a3b", flash_at("bfloat16", [32, 4, 1024, 64])),
            ("moonshot-v1-16b-a3b",
             flash_at("bfloat16", [16, 16, 1024, 128])),
            ("internvl2-76b", flash_at("bfloat16", [64, 8, 1024, 128])),
            ("qwen2.5-14b", flash_at("bfloat16", [40, 8, 1024, 128])),
            ("nemotron-4-15b", flash_at("bfloat16", [48, 8, 1024, 128])))}
    # stablelm-3b's head dim 80 in both dtypes (served in float32), and in
    # bfloat16 at its training shape
    flash_row["head_dim_80"] = {
        label: {k: r[k] for k in ("path", "shape", "ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by")}
        for label, r in (
            ("float32", flash_at("float32", [32, 32, 1024, 80])),
            ("bfloat16", flash_at("bfloat16", [32, 32, 1024, 80])),
            ("bfloat16_train", flash_at("bfloat16", [32, 32, 2048, 80], 2)))}
    flash_row["launches_by_kernel_path"] = {
        path: sum(o["flash_launches_by_path"][path] for o in served)
        for path in served[0]["flash_launches_by_path"]}
    for path in ("tf32x3", "wgmma"):
        flash_row["launches_by_kernel_path"][path] += sum(
            trained_by(path).values())
    ex_x3 = sum(examples_by("tf32x3").values())   # the twins run float32
    flash_row["launches_by_kernel_path"]["tf32x3"] += ex_x3
    flash_row["launches_by_kernel_path"]["fma"] += sum(
        examples_by("flash_attention").values()) - ex_x3
    bwd_row = kernel_row("flash_attention_bwd", flash_bwd_timing,
                         flash_bwd_err["float32"],
                         "src/repro/kernels/flash_attention.py:79",
                         {**trained_by("flash_attention_bwd"),
                          **examples_by("flash_attention_bwd")})
    bwd_row["gradient_of"] = ("flash_attention_pallas, which has no Pallas "
                              "backward: the JAX package's gradient is "
                              "autodiff of src/repro/kernels/ref.py:31 "
                              "attention_ref")
    bwd_row["fma_ms"] = flash_bwd_timing["fma_ms"]
    bwd_row["fma_bound_ms"] = flash_bwd_timing["fma_bound_ms"]
    bwd_row["launches_by_kernel_path"] = {
        path: sum({**trained_by(f"bwd_{path}"),
                   **examples_by(f"bwd_{path}")}.values())
        for path in ("wgmma", "tf32x3", "fma")}
    _require(sum(bwd_row["launches_by_kernel_path"].values())
             == bwd_row["launches"],
             f"the main path's backward launches by path "
             f"{bwd_row['launches_by_kernel_path']}")
    bf16_by_model = flash_bwd_timing["bfloat16_by_model"]
    bf16_bwd = bf16_by_model[FLASH_BWD_BF16_SHAPES[0][0]]    # granite-8b's
    keys = ("shape", "ms", "fma_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "tflops", "bound_share", "vs_library",
            "fma_over_path", "errors")
    bwd_row["float32_by_model"] = {
        model: {key: r[key] for key in keys}
        for model, r in flash_bwd_timing["float32_by_model"].items()}
    bwd_row["bfloat16"] = {
        "path": bf16_bwd["path"], "max_abs_err": flash_bwd_err["bfloat16"],
        "launches": sum(trained_by("bwd_wgmma").values()),
        **{key: bf16_bwd[key] for key in keys},
        "fma_bound_ms": bf16_bwd["fma_bound_ms"],
        "by_model": {model: {key: r[key] for key in keys}
                     for model, r in bf16_by_model.items()}}
    ssd_bwd_row = kernel_row("ssd_scan_bwd", ssd_bwd_timing,
                             ssd_bwd_err["float32"],
                             "src/repro/kernels/ssd_scan.py:68",
                             {**trained_by("ssd_scan_bwd"),
                              **examples_by("ssd_scan_bwd")})
    ssd_bwd_row["gradient_of"] = ("ssd_scan_pallas, which has no Pallas "
                                  "backward: the JAX package's gradient is "
                                  "autodiff of src/repro/kernels/ref.py:105 "
                                  "ssd_ref")
    ssd_bwd_row["fma_bound_ms"] = ssd_bwd_timing["fma_bound_ms"]
    ssd_bwd_row["bound_ms_by_way"] = ssd_bwd_timing["bound_ms_by_way"]
    ssd_bwd_row["launches_per_step"] = {
        key: out["launches_per_step"]["ssd_scan_bwd"]
        for key, out in trained.items()
        if out["launches_per_step"]["ssd_scan_bwd"]}
    ssd_bwd_row["bfloat16_max_abs_err"] = ssd_bwd_err["bfloat16"]
    for label in ("mlstm_values", "mlstm_normalizer"):
        ssd_bwd_row[label] = {key: ssd_bwd_timing[label][key] for key in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_ms_by_way")}
    bf16_keys = ("route", "shape", "ms", "call_ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")
    ssd_bwd_row["bfloat16"] = {
        label: {key: r[key] for key in (*bf16_keys, "bound_ms_by_way")}
        for label, r in ssd_bwd_timing["bfloat16"].items()}
    ssd_bwd_row["launches_by_route"] = {
        route: sum(trained_by(f"ssd_bwd_{route}").values())
        for route in TRAIN_SSD_ROUTES}
    ssd_row = kernel_row("ssd_scan",
                         next(r for r in ssd_timing if r["case"] == "zamba2"
                              and r["shape"][1] == 1024),
                         ssd_err, "src/repro/kernels/ssd_scan.py:68",
                         {**served_by("ssd_scan"), **trained_by("ssd_scan"),
                          **examples_by("ssd_scan")})
    ssd_row["bfloat16"] = {r["case"]: {key: r[key] for key in bf16_keys}
                           for r in ssd_timing if r["dtype"] == "bfloat16"}
    ssd_row["launches_by_route"] = {
        route: sum(trained_by(f"ssd_{route}").values())
        for route in TRAIN_SSD_ROUTES}
    slstm_rows = []
    for name, timing, err in (
            ("slstm_scan", slstm_timing["prefill"], slstm_err["fwd_float32"]),
            ("slstm_scan_bwd", slstm_timing["bwd"],
             slstm_err["bwd_float32"])):
        served_n = served_by(name) if name == "slstm_scan" else {}
        row = kernel_row(name, timing, err, "src/repro/models/xlstm.py:176",
                         {**served_n, **trained_by(name),
                          **examples_by(name)})
        row["replaces_tpu_kernel"] = (
            "none: the reference runs sLSTM as one jax.lax.scan of its "
            "_slstm_cell" + ("" if name == "slstm_scan" else
                             ", differentiated by autodiff"))
        row["ns_per_step"] = timing["ns_per_step"]
        row["call_ms"] = timing["call_ms"]
        row["bfloat16_max_abs_err"] = slstm_err[
            ("fwd" if name == "slstm_scan" else "bwd") + "_bfloat16"]
        row["float32_rel_err"] = slstm_err[
            ("fwd" if name == "slstm_scan" else "bwd") + "_float32_rel"]
        slstm_rows.append(row)
    slstm_rows[0]["lengths_max_abs_err"] = slstm_len_err
    slstm_rows[0]["train_kept"] = {k: slstm_timing["train"][k] for k in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "kept_mbytes",
        "bound_ms_with_kept", "ns_per_step")}
    slstm_rows[1]["bound_way"] = slstm_timing["bwd"]["bound_way"]
    slstm_rows[1]["bound_ms_by_way"] = slstm_timing["bwd"]["bound_ms_by_way"]
    tree = adamw_timing[ADAMW_HEADLINE]["tree"]
    adamw_row = kernel_row(
        "adamw", {**tree, "dtype": "bfloat16",
                  "shape": f"the whole tree of {ADAMW_HEADLINE}: "
                           f"{tree['params_b']:.3f} B params, "
                           f"{tree['leaves']} leaves"},
        adamw_err, "src/repro/optim/adamw.py:62",
        {**trained_by("adamw"), **examples_by("adamw")})
    adamw_row["replaces_tpu_kernel"] = (
        "none: the reference's AdamW update, fused by the jax.jit of its "
        "train step (src/repro/train/trainer.py:56)")
    adamw_row["library"] = (
        "torch._fused_adamw_ over the same float32 leaves (the master copy "
        "or the float32 params) with float32 gradients: another function "
        "(it decays before the step and keeps no master copy), for scale "
        "only")
    adamw_row["norm_launches"] = {**trained_by("adamw_norm"),
                                  **examples_by("adamw_norm")}
    adamw_row["by_config"] = adamw_timing
    kernels = [
        flash_row,
        bwd_row,
        ssd_row,
        ssd_bwd_row,
        *slstm_rows,
        kernel_row("matmul",
                   next(r for r in matmul_timing if r["dtype"] == "float32"),
                   matmul_err["float32"], "src/repro/kernels/matmul.py:39",
                   node_by("matmul"),
                   next(r for r in matmul_timing if r["dtype"] == "bfloat16"),
                   matmul_err["bfloat16"]),
        kernel_row("stencil",
                   next(r for r in stencil_timing if not r["l2_resident"]),
                   stencil_err, "src/repro/kernels/stencil.py:45",
                   node_by("stencil")),
        kernel_row("copy", copy_timing[0], copy_err,
                   "src/repro/kernels/copy.py:22", node_by("copy")),
        adamw_row,
    ]
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))
    _require(all(math.isfinite(k["ms"]) and k["launches"] > 0
                 for k in kernels), "kernel times and launches")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
