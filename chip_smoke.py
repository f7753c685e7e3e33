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
   1280, and musicgen-large's at 364); flash attention's
   backward (dq, dk, dv) at the training shape and at ragged, non-causal,
   short, GQA 1 / 4 / 8 and q-off-16-byte cases, each naming its path
   (``tf32x3`` for aligned float32, also held to ``FLASH_BWD_F32_KEEP``;
   ``fma`` otherwise; both taken in float32), at the forward's tolerance
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
   second call's hs, carries and kept carry equal bit for bit;
4. time each kernel beside its plain version, the PyTorch library call
   for the same function (SDPA for attention, ``torch.matmul``,
   ``Tensor.clone``, ``F.conv2d`` with the stencil's cross; none computes
   the SSD scan) and its bound, at the paths' shapes (the stencil's bound
   row at [8, 4096, 4096], past the L2), the matmul and flash attention
   in both dtypes (bfloat16 flash also at qwen3-moe's, moonshot's and
   internvl2-76b's heads), each row naming its path (float32 flash rows also time
   the FMA kernel on the same values off a 16-byte boundary and give its
   bound), flash attention's backward at the training shape on both
   paths beside SDPA's backward (float32), and in bfloat16 on the ``fma``
   kernels a bfloat16 train step takes beside SDPA's bfloat16 backward, the
   SSD rows with the
   wrapper's time per call (host included) and the passes' scratch, the
   SSD backward at the training shapes (no library call computes it); the
   sLSTM scan at the prefill shape and, with its backward, at the training
   shape, each beside the plain loop (no library call computes it);
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
   layers (29.48 B parameters, 58.96 GB; all 80 take 141 GB), and
   musicgen-large in float32 at full width and depth, each on its text
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
   bfloat16 ``wgmma``);
7. check what came out, for each model: every request finished with its
   tokens; the engine's first token equals a direct prefill's; prefill +
   decode agrees with a full forward at full width (an MoE model at
   capacity factor 16, where a forward drops no token that a one-token
   decode keeps); the reduced model on the card agrees with the CPU path
   in float32 (rel 5e-3, the model tolerance of the tests, greedy tokens
   equal) and, for a bfloat16 model, also in bfloat16; an MoE model's
   prefill + decode also agrees with its forward at full width and
   ``MOE_CHECK_LAYERS`` layers in float32 (rel 5e-3, every step), where a
   decode fault shows that 48 layers of bfloat16 drift would hide, and so
   does internvl2-76b's at ``DENSE_CHECK_LAYERS`` layers (5.5 B
   parameters) after its prefix.  For the vlm and audio models, with their
   frontend prefix (N(0, 1), internvl2 256 positions, musicgen 64):
   ``make_prefill_step`` + 16 decode steps against ``forward`` at full
   width (float32 rel 5e-3, bfloat16 on the median), ``make_forward_step``
   against ``forward``, a prefix of zeros changes the logits, and the
   reduced models' card-against-CPU checks take a prefix of 16.
   bfloat16 logits are held on the median over tokens of each token's
   rel, at ``BF16_FULL_TOL`` (48 layers; ``DENSE_BF16_FULL_TOL`` for
   internvl2-76b's 32) or ``BF16_REDUCED_TOL`` (4),
   grounded in the reference's own drift (``tools/moe_bf16_drift.py``):
   a routing flip moves one token's logits by 0.2-0.9 in the reference
   itself, and its drift grows with depth.
   For xlstm-125m it also times one 1024-token prefill and its sLSTM blocks
   inside it; for a bfloat16 model, the card time of one decode step
   (``torch.profiler``) against the bytes of the weights it must read;
8. train, one model after the other (``TRAIN_RUNS``): granite-8b at full
   width cut to 4 layers (1.27 B parameters, B 2 x S 2048), zamba2-1.2b
   at full width and depth (B 2 x S 2048) and xlstm-125m at full width
   and depth (B 2 x S 2048), in float32; then in bfloat16 (bfloat16
   params, a float32 master copy and moments) qwen3-moe-30b-a3b at full
   width cut to 4 of 48 layers (3.08 B parameters, capacity factor 1.25),
   granite-8b at 8 layers (2.15 B parameters), zamba2-1.2b and xlstm-125m
   as above.
   Each: the reduced model on the card against the CPU path in float32
   (loss rel 1e-5, gradient leaves at 1e-4, the hybrid's at 3e-3, of each
   leaf's largest; 3 AdamW steps' losses rel 1e-4), and for a bfloat16
   run also in bfloat16 against the CPU's float32 run of the same weights
   under the rule (``bf16_grad_limits``: the loss, the worst gradient leaf
   but zamba2's, 3 AdamW steps' losses); an MoE model's backward at the
   training shape repeats bit for bit under the deterministic mode
   (``moe_bwd_determinism``); then through the port's
   ``Trainer``: 8 steps straight through with a checkpoint at step 4, a
   fresh trainer that restores it (its state, a bfloat16 run's float32
   master copy with it, equal to the straight run's at step 4) and takes
   steps 5-8 with the same losses and state bit for bit, one more
   gradient with and without remat (the same loss and gradient norm);
   every loss finite, the first near a random init's ln V + 1/2, the last
   below the first; per step the launches the layer plan gives (flash
   forward and backward once per attention block or shared-block
   application, on the dtype's paths: float32 ``tf32x3`` both ways,
   bfloat16 ``wgmma`` forward and ``fma`` backward; the SSD forward and
   backward once per Mamba-2 layer and twice per mLSTM layer, so no
   backward runs the forward again; the sLSTM scan forward and backward
   once per sLSTM layer; remat runs
   every stacked layer's forward twice); the step time, tokens per
   second, peak memory, the checkpoint's write and restore seconds and,
   from one traced step, the share of the card time of the flash, SSD and
   sLSTM kernels, forward and backward.
   Then (``TRAIN_PREFIXED``) musicgen-large at full width and depth with
   its frontend prefix, float32, B 2 x (P 64 + 1984 text tokens) as
   ``train_batch_specs`` lays them out, through ``make_train_step`` (the
   ``Trainer``'s stream emits no frontend, in the reference too): its
   reduced model card against CPU with a prefix, then 8 steps (losses
   finite, the first near ln V + 1/2, the last below the first; 48 flash
   forward and 48 backward launches a step, all ``tf32x3``), the peak
   memory, the step time, text tokens per second and one traced step;
9. dry-run and placement: (a) the port's dry-run (``launch/dryrun.py``)
   of every arch x shape at full width and depth on the meta device, its
   leaves DTensors on both production meshes over a fake process group,
   all 80 cells; no cell may fail, every OK cell carries its collectives
   (``launch/collectives.py``), every ``train_4k`` cell a gradient
   reduction over the DP axes, and the count of cells each roofline term
   (compute, memory, collective) dominates is printed; (b) its host-mesh
   cell of granite-8b x 8 (B 2 x S 2048, remat), in float32 and in
   bfloat16 (a float32 master copy and moments), against the same step on
   the card: the
   predicted argument bytes within 1% of what the card allocates for
   them, the predicted peak beside the measured one, the counted flops
   beside 6 N tokens; (c) the node DAG once more under DAM-C with a
   queue penalty and ``placement_backend="torch"`` (the score on the
   card), held to phase 5's checks, its score calls counted and timed,
   and 10,000 seeded draws scored on the card held to numpy (1 float32
   ulp of its float32 evaluation, 2 of its float64, the same argmin);
10. the twins of ``examples/`` (``repro_torch/examples``) on the card,
   each with the launch counts set to 0 just before it and read just
   after: the quickstart (reduced qwen2.5-14b, 20 steps, a greedy
   generation; losses finite, the last below the first; flash forward and
   backward launches as the layer plan gives them, its step with remat;
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
carry their bfloat16 numbers under ``"bfloat16"``; the backwards' launches
are phases 8 and 10's), then the
``nvidia-smi`` line, then, last,
``{"ok": true, "device": {...}}``.  The details (every case's error, every
timing shape, the compiler's register report) go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
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
# The SSD backward's 3xTF32 stays only this far inside, x (1 + |g|), per
# gradient: ~4x the worst of the FMA kernel it replaced over
# SSD_BWD_CASES (dx 1.47e-4, db 2.64e-4, dc 2.12e-4); da, whose per-token
# sums cancel (1.22e-3 at the strong decays), ~2x, inside SSD_TOL
SSD_BWD_F32_KEEP = {"dx": 6e-4, "da": 2.5e-3, "db": 1.1e-3, "dc": 8.5e-4}
# The sLSTM kernels stay this far inside, x (1 + |v|), in float32, set
# from the first sLSTM kernels over SLSTM_CASES before their redesign:
# the forward 4x its worst against the float32 plain loop (1.12e-5, the
# kept carry); the backward about its worst against the plain backward,
# which computes in float64 since the redesign (dgx 1.1e-4 at the
# training shape; its dr, 4.9e-4, failed TOL there, as the float32
# plain's own did, both summing the reverse chain's rounding into dr
# alike).
SLSTM_F32_KEEP = {"fwd": 4.5e-5, "bwd": 1.2e-4}
# the unit whose peak prices each flash path's products in its bound
FLASH_UNIT = {"wgmma": "bfloat16", "tf32x3": "3xtf32", "fma": "float32"}

DEVICE = "cuda"
# (arch, dtype) served in phase 6, one after another
SERVED = (("granite-8b", "float32"), ("zamba2-1.2b", "float32"),
          ("xlstm-125m", "float32"), ("qwen3-moe-30b-a3b", "bfloat16"),
          ("moonshot-v1-16b-a3b", "bfloat16"), ("internvl2-76b", "bfloat16"),
          ("musicgen-large", "float32"))
# the served models cut in depth: internvl2-76b at full width is 76 B
# parameters (141 GB in bfloat16 at 80 layers); 32 of its layers are
# 29.48 B, 58.96 GB
SERVED_LAYERS = {"internvl2-76b": 32}
# the flash path every served launch of a dtype takes
SERVED_FLASH_PATH = {"float32": "tf32x3", "bfloat16": "wgmma"}
# the served head layouts (Hq, Hkv, D) by dtype: granite-8b and zamba2's
# shared attention (and musicgen-large's) in float32, qwen3-moe, moonshot
# and internvl2-76b in bfloat16
SERVED_LAYOUTS = {"float32": {(32, 8, 128), (32, 32, 64)},
                  "bfloat16": {(32, 4, 128), (16, 16, 128), (64, 8, 128)}}
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
# ... and a dense model's (internvl2-76b, served at 32 layers), which no
# routing flip moves: twice the reference's largest median on the same
# comparison at 32 layers, 8 seeds, P 256 (0.0253) or no prefix (0.0181)
# (tools/dense_bf16_drift.jsonl); its decode path's structure is held in
# float32 at DENSE_CHECK_LAYERS, where a fault shows.
DENSE_BF16_FULL_TOL = 0.05
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
        (1, 32, 4, 1024, 1024, 128, True),      # qwen3-moe: GQA group 8
        (1, 32, 4, 300, 300, 128, True),        # the same, ragged
        (1, 16, 16, 1024, 1024, 128, True),     # moonshot
        (1, 16, 16, 300, 300, 128, True),       # the same, ragged
        (1, 64, 8, 1280, 1280, 128, True),      # internvl2: P 256 + 1024
        (1, 64, 8, 556, 556, 128, True),        # the same, P 256 + 300
        (1, 32, 32, 364, 364, 64, True),        # musicgen: P 64 + 300
        (2, 32, 32, 2048, 2048, 64, True),      # musicgen's training shape
        (1, 8, 2, 40, 40, 32, True),            # S < 64, one ragged tile
        (1, 16, 4, 200, 200, 64, True, True),   # the FMA kernel
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
    (Hq 32, Hkv 4, D 128), moonshot's (Hq = Hkv = 16, D 128) and
    internvl2-76b's (Hq 64, Hkv 8, D 128) at S = 1024 in bfloat16, the
    dtype they are served in; each row names the kernel's path and prices its products
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
        bf16_only = ((32, 4, 1024, 128), (16, 16, 1024, 128),
                     (64, 8, 1024, 128))
        for hq, hkv, s, d in ((32, 8, 256, 128), (32, 8, 512, 128),
                              (32, 8, 1024, 128), (32, 32, 1024, 64),
                              *(bf16_only if dtype == torch.bfloat16
                                else ())):
            q, k, v = _qkv(1, hq, hkv, s, s, d, dtype, seed=99)
            ms = _time_ms(lambda: flash_attention(q, k, v), iters=20)
            plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v),
                                iters=3, warmup=1, run_ahead=False)
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), iters=20)
            flops, nbytes = attention_work(1, hq, hkv, s, s, d, dtype)
            path = flash_path(q, k, v)
            bound_ms, bound_by = bound({FLASH_UNIT[path]: flops}, nbytes)
            # the wrapper's time per call, host included: at these sizes
            # its Python and launch cost can exceed the kernel's
            call_ms = _time_ms(lambda: flash_attention(q, k, v), iters=20,
                               run_ahead=False)
            row = {"dtype": name, "path": path,
                   "shape": [1, hq, hkv, s, s, d], "ms": ms,
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
# the FMA kernels)
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
]


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


def check_flash_bwd(report: dict) -> dict:
    """The backward kernels against their plain version on the card, every
    case in both dtypes, at the forward's tolerance x (1 + |g|) on each of
    dq, dk and dv, and float32 on ``tf32x3`` also at ``FLASH_BWD_F32_KEEP``;
    each case names its path (``flash_bwd_path``: aligned float32 on the
    3xTF32 kernels, bfloat16 and a q off a 16-byte boundary on the FMA
    kernels) and checks that the total and that path's counter moved by
    one.  Returns the largest error in each dtype at the training shapes
    (S = T = 2048)."""
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
            before = (bwd_launches.count, bwd_path_launches[path].count)
            got = flash_attention_bwd(q, k, v, o, do, causal=causal)
            torch.cuda.synchronize()
            launched = (bwd_launches.count - before[0],
                        bwd_path_launches[path].count - before[1])
            want = flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
            row = {"dtype": name, "path": path,
                   "shape": [b, hq, hkv, s, t, d], "causal": causal,
                   "tol": TOL[name], "launches": launched[1]}
            ok = launched == (1, 1)
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - w.float()).abs()
                rel = float((err / (1.0 + w.float().abs())).max())
                ok = (ok and g.dtype == dtype and g.shape == w.shape
                      and bool(torch.isfinite(g).all())
                      and bool((err <= TOL[name] * (1.0 + w.float().abs())
                                ).all())
                      and (path != "tf32x3" or rel <= FLASH_BWD_F32_KEEP))
                row[f"{gname}_max_abs_err"] = float(err.max())
                row[f"{gname}_max_rel_err"] = rel
            row["ok"] = ok
            rows.append(row)
            print(f"[check] flash_attention_bwd {row}", flush=True)
            _require(ok, f"flash attention backward kernel against its plain "
                         f"version: {row}")
            if s == t == 2048:
                worst[name] = max(worst.get(name, 0.0),
                                  *(row[f"{g}_max_abs_err"]
                                    for g in ("dq", "dk", "dv")))
            del q, k, v, o, do, got, want
    _require({r["path"] for r in rows if r["dtype"] == "float32"}
             == {"tf32x3", "fma"}, "float32 backward checks took both paths")
    report["flash_attention_bwd_checks"] = rows
    return worst


def _time_bwd_turns(dtype, seed: int, off16: bool) -> tuple:
    """At ``FLASH_BWD_CASES[0]`` in ``dtype``: the backward kernels on
    aligned inputs (and, with ``off16``, on the same values with q off a
    16-byte boundary) and SDPA's backward (``torch.autograd.grad`` of its
    output on a graph recorded once and kept, so only the backward is
    timed), in turns over two rounds; the plain version once.  Returns
    (each call's median ms, its rounds, the plain ms, the kernels' path on
    the aligned inputs, the shape)."""
    import statistics
    import torch.nn.functional as F
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_bwd_path)
    b, hq, hkv, s, t, d, causal = FLASH_BWD_CASES[0]
    q, k, v, o, do = _bwd_inputs(b, hq, hkv, s, t, d, dtype, causal, seed)
    path = flash_bwd_path(q, k, v, o, do)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    calls = {path: lambda: flash_attention_bwd(q, k, v, o, do)}
    if off16:
        q_off = _off16(q)
        _require(flash_bwd_path(q_off, k, v, o, do) == "fma",
                 "backward timing paths")
        calls["fma"] = lambda: flash_attention_bwd(q_off, k, v, o, do)
    calls["sdpa"] = lambda: torch.autograd.grad(out, leaves, do,
                                                retain_graph=True)
    rounds = {name: [] for name in calls}
    for _ in range(2):
        for name, fn in calls.items():
            rounds[name].append(_time_ms(fn, iters=5))
    ms = {name: statistics.median(r) for name, r in rounds.items()}
    plain_ms = _time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do),
                        iters=1, warmup=1, run_ahead=False)
    del q, k, v, o, do, leaves, out, calls
    torch.cuda.empty_cache()
    return ms, rounds, plain_ms, path, [b, hq, hkv, s, t, d]


def time_flash_bwd(report: dict) -> dict:
    """Both backward paths, the plain version, SDPA's backward and the
    bound at the training shape, float32 (``_time_bwd_turns``):
    ``tf32x3`` on the aligned inputs, ``fma`` on the same values with q
    off a 16-byte boundary, SDPA's backward without TF32.  The bound
    prices the 5 products the function needs at 3xTF32's rate, the least
    time at float32's accuracy (``fma_bound_ms`` at the FMA peak, the
    units of the FMA kernels); each path's ``tflops`` is those 5 products
    over its time and ``bound_share`` its unit's bound over its time.
    Then, under ``"bfloat16"``, the path a bfloat16 train step takes
    (``fma``) beside SDPA's bfloat16 backward, its bound at the bfloat16
    tensor cores' peak."""
    import torch
    ms, rounds, plain_ms, path, shape = _time_bwd_turns(torch.float32, 299,
                                                        off16=True)
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
           "tflops": paths["tf32x3"]["tflops"]}
    print(f"[time] flash_attention_bwd {row}", flush=True)

    ms, rounds, plain_ms, path, shape = _time_bwd_turns(torch.bfloat16, 298,
                                                        off16=False)
    _require(path == "fma", f"the bfloat16 backward's timing path {path}")
    flops, nbytes = attention_bwd_work(*shape, torch.bfloat16)
    bound_ms, bound_by = bound({"bfloat16": flops}, nbytes)
    row["bfloat16"] = bf16 = {
        "dtype": "bfloat16", "path": path, "shape": shape, "ms": ms[path],
        "ms_rounds": rounds[path], "plain_ms": plain_ms,
        "library_ms": ms["sdpa"], "library_ms_rounds": rounds["sdpa"],
        "library": "SDPA backward (bfloat16, autograd.grad on a kept graph)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "fma_bound_ms": bound({"float32": flops}, nbytes)[0],
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        "tflops": flops / (ms[path] * 1e-3) / 1e12,
        "vs_library": ms[path] / ms["sdpa"]}
    print(f"[time] flash_attention_bwd bfloat16 {bf16}", flush=True)
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


def check_ssd(report: dict) -> float:
    """Kernel against its plain version on the card.  Returns the largest
    float32 error over the cases."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    worst = 0.0
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, (b, s, h, d, n, decay) in enumerate(SSD_CASES):
            x, a, bm, cm = _ssd_inputs(b, s, h, d, n, dtype, decay, seed=i)
            got = ssd_scan(x, a, bm, cm)
            torch.cuda.synchronize()
            want = ssd_scan_plain(x, a, bm, cm)
            err = (got.float() - want.float()).abs()
            limit = SSD_TOL[name] * (1.0 + want.float().abs())
            rel = float((err / (1.0 + want.float().abs())).max())
            ok = (bool((err <= limit).all())
                  and bool(torch.isfinite(got).all())
                  and got.dtype == dtype and got.shape == x.shape
                  and (name != "float32" or rel <= SSD_F32_KEEP))
            row = {"dtype": name, "shape": [b, s, h, d, n], "decay": decay,
                   "max_abs_err": float(err.max()), "max_rel_err": rel,
                   "max_abs_out": float(want.float().abs().max()),
                   "tol": SSD_TOL[name], "ok": ok}
            rows.append(row)
            print(f"[check] ssd_scan {row}", flush=True)
            _require(ok, f"SSD scan kernel against its plain version: {row}")
            if name == "float32":
                worst = max(worst, row["max_abs_err"])
    report["ssd_scan_checks"] = rows
    return worst


def time_ssd(report: dict) -> list[dict]:
    """Kernel, plain version and the bound (the products the kernel runs in
    3xTF32 at that rate, ``work.ssd_work``) at the served shapes, float32
    (no single PyTorch call computes the scan: library_ms is null), with
    the wrapper's time per call, host included (``call_ms``), and the
    passes' scratch (``scratch_mb``, the design's cost, not in the
    bound)."""
    import torch
    from repro_torch.kernels.ssd_scan import (NARROW_D, narrow_d,
                                              scratch_floats, ssd_scan,
                                              ssd_scan_plain)
    _require(narrow_d() == NARROW_D,
             f"the built SSD kernel's NARROW_D {narrow_d()} is the meta "
             f"path's {NARROW_D}")
    rows = []
    for s in (256, 1024):
        for label, (b, h, d, n, decay) in (
                ("zamba2", (1, 32, 128, 64, "mild")),
                ("mlstm_values", (4, 1, 384, 384, "mlstm")),
                ("mlstm_normalizer", (4, 1, 1, 384, "mlstm"))):
            x, a, bm, cm = _ssd_inputs(b, s, h, d, n, torch.float32, decay,
                                       seed=99)
            ms = _time_ms(lambda: ssd_scan(x, a, bm, cm), iters=20)
            plain_ms = _time_ms(lambda: ssd_scan_plain(x, a, bm, cm),
                                iters=3, warmup=1, run_ahead=False)
            call_ms = _time_ms(lambda: ssd_scan(x, a, bm, cm), iters=20,
                               run_ahead=False)
            flops, nbytes = ssd_work(b, s, h, d, n, torch.float32,
                                     narrow_d())
            bound_ms, bound_by = bound(flops, nbytes)
            row = {"case": label, "dtype": "float32", "shape": [b, s, h, d, n],
                   "ms": ms, "call_ms": call_ms,
                   "scratch_mb": scratch_floats(b, s, h, d, n) * 4 / 1e6,
                   "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "gflop": sum(flops.values()) / 1e9,
                   "tensor_core_gflop": flops.get("3xtf32", 0) / 1e9,
                   "mbytes": nbytes / 1e6,
                   "tflops": sum(flops.values()) / (ms * 1e-3) / 1e12}
            rows.append(row)
            print(f"[time] ssd_scan {row}", flush=True)
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


def check_ssd_bwd(report: dict) -> dict:
    """The backward kernel (dx, da, db, dc), reading the forward kernel's
    kept scratch as training runs it, against its plain version on the
    card, every case in both dtypes, at ``SSD_TOL`` x (1 + |g|) and in
    float32 also at ``SSD_BWD_F32_KEEP`` x (1 + |g|); each call moves the
    backward's counter by one and launches no forward; two calls on one
    input agree bit for bit (no atomics), the second without the kept
    scratch (it runs the forward first).  Returns the largest error in
    each dtype at zamba2's training shape."""
    import torch
    from repro_torch.kernels.ssd_scan import (bwd_launches, launches,
                                              ssd_scan_bwd,
                                              ssd_scan_bwd_plain)
    worst = {}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, (b, s, h, d, n, decay) in enumerate(SSD_BWD_CASES):
            ins, saved = _ssd_bwd_inputs(b, s, h, d, n, dtype, decay,
                                         seed=300 + i)
            before = (bwd_launches.count, launches.count)
            got = ssd_scan_bwd(*ins, saved=saved)
            torch.cuda.synchronize()
            launched = [bwd_launches.count - before[0],
                        launches.count - before[1]]
            del saved
            want = ssd_scan_bwd_plain(*ins)
            row = {"dtype": name, "shape": [b, s, h, d, n], "decay": decay,
                   "tol": SSD_TOL[name], "launches": launched[0],
                   "forward_launches": launched[1]}
            ok = launched == [1, 0]
            for gname, g, w, like in zip(("dx", "da", "db", "dc"), got, want,
                                         ins):
                err = (g.float() - w.float()).abs()
                limit = SSD_TOL[name] * (1.0 + w.float().abs())
                rel = float((err / (1.0 + w.float().abs())).max())
                ok = (ok and g.dtype == dtype and g.shape == like.shape
                      and bool(torch.isfinite(g).all())
                      and bool((err <= limit).all())
                      and (name != "float32"
                           or rel <= SSD_BWD_F32_KEEP[gname]))
                row[f"{gname}_max_abs_err"] = float(err.max())
                row[f"{gname}_max_rel_err"] = rel
                row[f"{gname}_max_abs"] = float(w.float().abs().max())
            if name == "float32":
                row["keep"] = SSD_BWD_F32_KEEP
            row["ok"] = ok
            rows.append(row)
            print(f"[check] ssd_scan_bwd {row}", flush=True)
            _require(ok, f"SSD scan backward kernel against its plain "
                         f"version: {row}")
            if i == 0:
                worst[name] = max(row[f"{g}_max_abs_err"]
                                  for g in ("dx", "da", "db", "dc"))
            del ins, got, want
    again, saved = _ssd_bwd_inputs(3, 200, 2, 48, 100, torch.float32,
                                   "mlstm", 399)
    first = ssd_scan_bwd(*again, saved=saved)
    second = ssd_scan_bwd(*again)
    torch.cuda.synchronize()
    _require(all(torch.equal(u, v) for u, v in zip(first, second)),
             "the SSD backward repeats bit for bit, also when it runs the "
             "forward for its scratch")
    report["ssd_scan_bwd_checks"] = rows
    return worst


def time_ssd_bwd(report: dict) -> dict:
    """The backward kernel, reading the forward kernel's kept scratch as
    training runs it, its plain version on the same inputs and the bound
    (``_ssd_bwd_bound``) at each of ``SSD_BWD_TRAIN``'s shapes, float32.
    No PyTorch call computes the scan's gradient, so library_ms is null.
    Also the wrapper's time per call, host included (``call_ms``), the
    backward's own scratch, the kept forward scratch it reads, and the
    work it does (``gflop``, ``mbytes``, ``tflops``).  The row of zamba2's
    shape, with the others under their names."""
    import torch
    from repro_torch.kernels.ssd_scan import (bwd_scratch_floats,
                                              scratch_floats, ssd_scan_bwd,
                                              ssd_scan_bwd_plain)
    rows = {}
    for label, (b, s, h, d, n, decay) in SSD_BWD_TRAIN.items():
        ins, saved = _ssd_bwd_inputs(b, s, h, d, n, torch.float32, decay,
                                     seed=399)
        ms = _time_ms(lambda: ssd_scan_bwd(*ins, saved=saved), iters=10)
        call_ms = _time_ms(lambda: ssd_scan_bwd(*ins, saved=saved),
                           iters=10, run_ahead=False)
        plain_ms = _time_ms(lambda: ssd_scan_bwd_plain(*ins, saved=saved),
                            iters=2, warmup=1, run_ahead=False)
        flops, nbytes = ssd_bwd_work(b, s, h, d, n, torch.float32, True)
        rows[label] = {
            "case": f"{label}_train", "dtype": "float32",
            "shape": [b, s, h, d, n], "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "library_ms": None,
            **_ssd_bwd_bound(b, s, h, d, n, torch.float32),
            "scratch_mb": bwd_scratch_floats(b, s, h, d, n) * 4 / 1e6,
            "kept_mb": scratch_floats(b, s, h, d, n) * 4 / 1e6,
            "gflop": sum(flops.values()) / 1e9, "mbytes": nbytes / 1e6,
            "tflops": sum(flops.values()) / (ms * 1e-3) / 1e12}
        del ins, saved
        torch.cuda.empty_cache()
    row = rows.pop("zamba2")
    row.update(rows)
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
    |v|) (the plain backward computes in float64); one count a call each.
    Returns the largest error of each direction in each dtype over the
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
            gx, r, carry = _slstm_inputs(b, s, d, dtype, carry_kind, 500 + i)
            before = (launches.count, bwd_launches.count)
            with torch.no_grad():
                hs0, last0 = slstm_scan(gx, r, carry)
            hs, last, kept = slstm_scan_keep(gx, r, carry)
            hs1, last1, kept1 = slstm_scan_keep(gx, r, carry)
            g = torch.Generator(device=DEVICE)
            g.manual_seed(600 + i)
            dhs = torch.randn(hs.shape, generator=g, device=DEVICE).to(dtype)
            dlast = tuple(torch.randn(t.shape, generator=g,
                                      device=DEVICE).to(dtype) for t in last)
            grads = slstm_scan_bwd(gx, r, carry, hs, kept, dhs, dlast)
            torch.cuda.synchronize()
            launched = [launches.count - before[0],
                        bwd_launches.count - before[1]]
            want_hs, want_last, want_kept = slstm_scan_plain(gx, r, carry,
                                                             keep=True)
            want = slstm_scan_bwd_plain(gx, r, carry, hs, kept, dhs, dlast)
            row = {"dtype": name, "shape": [b, s, d], "carry": carry_kind,
                   "tol": TOL[name], "launches": launched,
                   "keep_equal": torch.equal(hs0, hs) and torch.equal(
                       hs1, hs) and torch.equal(kept1, kept) and all(
                       torch.equal(u, v) and torch.equal(w, v)
                       for u, v, w in zip(last0, last, last1))}
            ok = launched == [3, 1] and row["keep_equal"]
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
    """Kernel launches one prefill makes, from the model's layer plan."""
    from repro_torch.models import layer_plan
    plan = layer_plan(cfg)
    return {"flash_attention": sum(k in ("attn", "attn_moe", "shared_attn")
                                   for k in plan),
            "ssd_scan": plan.count("mamba2") + 2 * plan.count("mlstm"),
            "slstm_scan": plan.count("slstm")}


def _launches_per_decode(cfg) -> dict:
    """Kernel launches one decode step makes: the sLSTM scan once per sLSTM
    layer (S = 1 from the request's carry); attention, Mamba-2 and mLSTM
    decode in plain torch, as the reference's."""
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

    counters = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches,
                "slstm_scan": slstm_scan.launches}
    flash_paths = flash_attention.path_launches

    max_len = max(PROMPT_LENS) + NEW_TOKENS
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, tpu_pod_slices(2, 2), scheduler="DAM-C",
                           max_len=max_len, slowdown=SLOW_PLACE, seed=0,
                           device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(engine.params))
    print(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B params initialised on "
          f"the card in {init_s:.2f} s", flush=True)

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
    with torch.inference_mode():
        # the engine's first token is a direct prefill's argmax
        r = reqs[2]
        toks = torch.as_tensor(prompts[2], device=DEVICE)[None]
        logits, _ = prefill(engine.params, cfg, toks, max_len)
        _require(int(torch.argmax(logits[0])) == r.out_tokens[0],
                 "engine's first token against a direct prefill")
        # prefill + decode agrees with a full forward (full width); an MoE
        # model at a capacity where the forward drops nothing
        chk = cfg
        if cfg.family == "moe":
            chk = dataclasses.replace(cfg, capacity_factor=MOE_CHECK_CAPACITY)
        n_dec = 2 if cfg.dtype == "float32" else NEW_TOKENS
        rels, _ = decode_vs_forward(engine.params, chk, toks, n_dec)
        out["prefill_decode_vs_forward_rel"] = rels
        _require_decode_agrees(cfg, rels, "prefill + decode against forward")
        if cfg.dtype == "bfloat16":
            out["decode_step_card"] = decode_card_time(engine.params, cfg,
                                                       prompts[2], max_len)
        if cfg.family == "ssm":
            out["prefill_split"] = slstm_share(engine.params, cfg, prompts[1])
        if cfg.frontend != "none":
            out["prefixed"] = prefixed_checks(engine.params, cfg, toks)
    del engine
    torch.cuda.empty_cache()
    reduced = cfg.reduced()
    out["reduced_cuda_vs_cpu_rel"] = reduced_vs_cpu(
        dataclasses.replace(reduced, dtype="float32"))
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
          + (f", {out['reduced_cuda_vs_cpu_bf16']} (bfloat16)"
             if cfg.dtype == "bfloat16" else ""), flush=True)
    print(f"[serve] {cfg.name} ({cfg.dtype}): init {out['init_s']:.2f} s, "
          f"peak {out['peak_mem_gb']:.2f} GB, TTFT p50 / p99 "
          f"{out['ttft_ms_p50']:.1f} / {out['ttft_ms_p99']:.1f} ms, decode "
          f"step p50 {out['decode_step_ms_p50']:.1f} ms, "
          f"{out['output_tokens_per_s']:.2f} output tokens/s", flush=True)
    report.setdefault("serve", {})[cfg.name] = out
    return out


def _require_decode_agrees(cfg, rels: list[float], what: str) -> None:
    """A served model's decode steps against its forward: float32 every
    step under rel 5e-3, the model tolerance; bfloat16 the median over the
    steps under ``BF16_FULL_TOL`` (an MoE model) or
    ``DENSE_BF16_FULL_TOL`` (a dense one)."""
    import statistics
    if cfg.dtype == "float32":
        _require(max(rels) < 5e-3, f"{what}: rel {rels}")
    else:
        tol = BF16_FULL_TOL if cfg.n_experts else DENSE_BF16_FULL_TOL
        _require(statistics.median(rels) < tol,
                 f"{what}: rel {rels}, median over the tokens not under "
                 f"{tol}")


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
    n_params = sum(t.numel() for t in _leaves(params))
    del params
    torch.cuda.empty_cache()
    _require(max(rels) < 5e-3,
             f"{cfg.name} at {layers} layers in float32: prefill + decode "
             f"against forward: rel {rels}")
    return {"layers": layers, "params_b": n_params / 1e9,
            "prefix": 0 if front is None else front.shape[1],
            "steps": NEW_TOKENS, "max_rel": max(rels), "rels": rels}


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
    steps under ``DENSE_BF16_FULL_TOL``); ``make_forward_step`` on the same
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


def decode_card_time(params, cfg, prompt, max_len) -> dict:
    """One decode step after a prefill of ``prompt``, on one thread: its
    wall time until the card is done (``host_ms``), its card time
    (``card_ms``, the kernels' time in a ``torch.profiler`` trace of one
    step) and kernel count, and the least card time, the bytes of the
    weights the step must read (``_decode_weight_bytes``) at the memory
    rate."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step, prefill
    toks = torch.as_tensor(prompt, device=DEVICE)[None]
    with torch.inference_mode():
        _, state = prefill(params, cfg, toks, max_len)
        nxt = toks[:, -1]

        def step():
            decode_step(params, cfg, state, nxt)
        host_ms = _time_ms(step, iters=3, warmup=1, run_ahead=False)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    # the kernels' own events (an operator's event also carries the time
    # of the kernels it launched)
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    card_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    _require(card_ms > 0, f"{cfg.name}: the traced decode step ran nothing "
                          f"on the card")
    nbytes = _decode_weight_bytes(cfg, len(prompt) + 5)
    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:6]
    out = {"tokens_before": len(prompt), "host_ms": host_ms,
           "card_ms": card_ms,
           "kernels": sum(ev.count for ev in kernels),
           "top_kernels_ms": {ev.key[:70]: ev.self_device_time_total / 1e3
                              for ev in top},
           "weight_gb": nbytes / 1e9,
           "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}
    print(f"[serve] {cfg.name} decode step {out}", flush=True)
    return out


# -- phase 8: training ----------------------------------------------------------
# One run a model, one after the other, each through the port's Trainer:
# first in float32, then in bfloat16, the dtype the dry-run prices (bfloat16
# params, a float32 master copy and float32 moments, as the reference's
# AdamW keeps them).  granite-8b at full width is cut in depth only (36 -> 8
# layers): 2.15 B parameters, whose params, gradients and two AdamW moments
# take 34.4 GB in bfloat16 (2 + 2 + 4 + 8 bytes a parameter) as in float32
# (all 36 layers would take 132 GB).  Its float32 run is cut to 4 layers
# (1.27 B parameters) since the bfloat16 runs joined the phase, to keep the
# whole run near 700 s: at 8 layers it took 70.5 s of 667.5 (PERF.md), most
# of it the checkpoint's write and restore.  zamba2-1.2b and xlstm-125m run
# at full width and depth, all at B 2 x S 2048.  qwen3-moe-30b-a3b trains
# in bfloat16 only (30.1 B parameters): at full width cut 48 -> 4 layers,
# 9.4 M attention and 604 M expert parameters a layer and 0.62 B in the
# untied embeddings, 3.08 B parameters, ~49 GB at 16 bytes each (6 layers
# would take ~69 GB beside the activations), capacity factor 1.25.
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
    {"arch": "granite-8b", "layers": 4, "dtype": "float32", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-5, "grad_tol": 1e-4},
    {"arch": "zamba2-1.2b", "layers": None, "dtype": "float32", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-4, "grad_tol": 3e-3},
    {"arch": "xlstm-125m", "layers": None, "dtype": "float32", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-4, "grad_tol": 1e-4},
    {"arch": "qwen3-moe-30b-a3b", "layers": 4, "dtype": "bfloat16",
     "batch": 2, "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-5,
     "grad_tol": 1e-4},
    {"arch": "granite-8b", "layers": 8, "dtype": "bfloat16", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-5, "grad_tol": 1e-4},
    {"arch": "zamba2-1.2b", "layers": None, "dtype": "bfloat16", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-4, "grad_tol": 3e-3},
    {"arch": "xlstm-125m", "layers": None, "dtype": "bfloat16", "batch": 2,
     "seq": 2048, "steps": 8, "ckpt": 4, "lr": 3e-4, "grad_tol": 1e-4},
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
)
TRAIN_WARMUP = 2
TRAIN_CKPT_DIR = ROOT / ".train_ckpt"   # listed in .gitignore; removed after
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
    from repro_torch.kernels import flash_attention, slstm_scan, ssd_scan
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "tf32x3": flash_attention.path_launches["tf32x3"],
            "wgmma": flash_attention.path_launches["wgmma"],
            "bwd_tf32x3": flash_attention.bwd_path_launches["tf32x3"],
            "bwd_fma": flash_attention.bwd_path_launches["fma"],
            "ssd_scan": ssd_scan.launches,
            "ssd_scan_bwd": ssd_scan.bwd_launches,
            "slstm_scan": slstm_scan.launches,
            "slstm_scan_bwd": slstm_scan.bwd_launches}


def _reset(counters) -> None:
    for c in counters.values():
        c.reset()


def _counts(counters) -> dict:
    return {name: c.count for name, c in counters.items()}


# the flash paths a train step's launches take, by the model's dtype: the
# forward's and the backward's (bfloat16's backward runs the FMA kernels)
TRAIN_FLASH_PATHS = {"float32": ("tf32x3", "bwd_tf32x3"),
                     "bfloat16": ("wgmma", "bwd_fma")}


def _step_launches(cfg, remat: bool = False) -> dict:
    """Kernel launches of one train step, from the layer plan: one flash
    forward and backward per attention block or shared-block application,
    all on the dtype's paths (``TRAIN_FLASH_PATHS``: float32 ``tf32x3``
    both ways, bfloat16 ``wgmma`` forward and ``fma`` backward); one SSD
    forward and backward per Mamba-2 layer, two per mLSTM layer (so no
    backward runs the forward again: it reads the forward's kept scratch);
    one sLSTM scan forward and backward per sLSTM layer.  With remat every
    stacked layer runs its forward again in the backward (the hybrid's
    shared block is not rematerialised)."""
    per = _launches_per_prefill(cfg)
    from repro_torch.models import layer_plan
    again = sum(k in ("attn", "attn_moe") for k in layer_plan(cfg)) if (
        remat) else 0
    fwd, bwd = per["flash_attention"] + again, per["flash_attention"]
    ssd, sl = per["ssd_scan"], per["slstm_scan"]
    fwd_path, bwd_path = TRAIN_FLASH_PATHS[cfg.dtype]
    out = {"flash_attention": fwd, "flash_attention_bwd": bwd,
           "tf32x3": 0, "wgmma": 0, "bwd_tf32x3": 0, "bwd_fma": 0,
           "ssd_scan": ssd * (2 if remat else 1), "ssd_scan_bwd": ssd,
           "slstm_scan": sl * (2 if remat else 1), "slstm_scan_bwd": sl}
    out[fwd_path], out[bwd_path] = fwd, bwd
    return out


def train_reduced_vs_cpu(run: dict) -> dict:
    """The reduced model on the card (the flash and SSD kernels forward and
    backward, cuBLAS) against the CPU path (plain versions), from the same
    init and batches (with a frontend prefix for a vlm or audio model): the
    loss (rel 1e-5) and its gradients (every leaf
    within ``grad_tol`` x its largest magnitude: 1e-4, and the SSD
    tolerance 3e-3 for the hybrid, as ``tests/test_torch_train.py``), then
    3 AdamW steps' losses (rel 1e-4)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_grad_step, make_train_step
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
    want = _step_launches(cfg)
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
    print(f"[train] reduced {cfg.name} card against CPU {out}", flush=True)
    if run["dtype"] == "bfloat16":
        out["bfloat16"] = train_reduced_bf16_vs_cpu(run)
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
    want = _step_launches(cfg16)
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
FLASH_BWD_KERNELS = ("bwd_x3_dq", "bwd_x3_dkdv", "bwd_prepass", "bwd_dkdv",
                     "bwd_dq")
FLASH_BWD_PATH_KERNELS = {"bwd_tf32x3": ("bwd_x3_dq", "bwd_x3_dkdv"),
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
    ("ssd", ("ssd_",)), ("slstm", ("slstm_",)),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("copy", ("Memcpy", "Memset", "copy_kernel")),
    ("elementwise", ("elementwise",)), ("reduce", ("reduce",)))


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


def _traced_step(run_step, per_step: dict, dtype: str = "float32") -> dict:
    """``run_step()`` (one train step) under ``torch.profiler``: the card
    time of its kernels, their count, the longest 8, and the time and share
    of the card time of the flash, SSD and sLSTM kernels, forward and
    backward;
    each kernel that ``per_step`` launches must show, the flash kernels all
    on the dtype's paths (``TRAIN_FLASH_PATHS``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    card_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    _require(card_ms > 0, "the traced train step ran nothing on the card")

    def share(names):
        return sum(ev.self_device_time_total for ev in kernels
                   if any(n in ev.key for n in names)) / 1e3

    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:8]
    by_class: dict = {}
    for ev in kernels:
        kind = next((kind for kind, names in TRACE_CLASSES
                     if any(n in ev.key for n in names)), "other")
        by_class[kind] = by_class.get(kind, 0.0) + (
            ev.self_device_time_total / 1e3)
    traced = {"card_ms": card_ms,
              "kernels": sum(ev.count for ev in kernels),
              "top_kernels_ms": {ev.key[:70]: ev.self_device_time_total
                                 / 1e3 for ev in top},
              "card_ms_by_class": by_class}
    fwd_path, bwd_path = TRAIN_FLASH_PATHS[dtype]
    for name, names in (("flash_bwd", FLASH_BWD_KERNELS),
                        ("flash_fwd", FLASH_FWD_KERNELS[fwd_path]),
                        ("ssd_bwd", SSD_BWD_KERNELS),
                        ("ssd_fwd", SSD_FWD_KERNELS),
                        ("slstm_bwd", SLSTM_BWD_KERNELS),
                        ("slstm_fwd", SLSTM_FWD_KERNELS)):
        traced[f"{name}_ms"] = share(names)
        traced[f"{name}_share"] = traced[f"{name}_ms"] / card_ms
    if per_step["flash_attention"]:
        _require(traced["flash_bwd_ms"] > 0 and traced["flash_fwd_ms"] > 0
                 and share(FLASH_BWD_PATH_KERNELS[bwd_path])
                 == traced["flash_bwd_ms"],
                 f"the traced step's flash kernels (the backward's all "
                 f"{bwd_path}): {traced}")
    if per_step["ssd_scan"]:
        _require(traced["ssd_bwd_ms"] > 0 and traced["ssd_fwd_ms"] > 0,
                 f"the traced step's SSD kernels: {traced}")
    if per_step["slstm_scan"]:
        _require(traced["slstm_bwd_ms"] > 0 and traced["slstm_fwd_ms"] > 0,
                 f"the traced step's sLSTM kernels: {traced}")
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
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.train import make_grad_step, make_train_step
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
        t0 = time.perf_counter()
        a.run()                                   # steps 1 .. ckpt
        first_s = time.perf_counter() - t0
        at_ckpt = _fingerprint(a._state_tree())
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
        for on in (False, True):
            _require(remat[on]["launches"] == _step_launches(cfg, on),
                     f"{cfg.name}'s grad step launches with remat={on}: "
                     f"{remat[on]['launches']}, want "
                     f"{_step_launches(cfg, on)}")
        for key in ("loss", "grad_norm"):
            rel = abs(remat[True][key] - remat[False][key]) / abs(
                remat[False][key])
            out[f"remat_{key}_rel"] = rel
            _require(rel < 1e-5, f"remat changes the {key}: {remat}")

        # one more train step, traced: the kernels' card time by kernel
        step = make_train_step(cfg, opt, remat=False)

        def run_step():
            b.params, b.opt_state, met = step(b.params, b.opt_state, batch)
            float(met["loss"])
        traced = out["traced_step"] = _traced_step(run_step, per_step,
                                                   cfg.dtype)
        del b, batch, step
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
          f"{out['step_ms_p50']:.1f} ms, {out['tokens_per_s']:.0f} tokens/s, "
          f"peak {out['peak_mem_gb']:.2f} GB; checkpoint write "
          f"{out['checkpoint_s']:.1f} s, restore {out['restore_s']:.1f} s; "
          f"of a step's card time ({traced['card_ms']:.1f} ms) flash "
          f"forward {100 * traced['flash_fwd_share']:.1f}%, backward "
          f"{100 * traced['flash_bwd_share']:.1f}%, SSD backward "
          f"{100 * traced['ssd_bwd_share']:.1f}%, sLSTM forward and backward "
          f"{100 * (traced['slstm_fwd_share'] + traced['slstm_bwd_share']):.1f}"
          f"%; resume from step {ckpt} "
          f"bit for bit; {out['phase_s']:.0f} s", flush=True)
    return out


def prefixed_batch(cfg, shape, step: int, device) -> dict:
    """The train batch that ``train_batch_specs(cfg, shape)`` lays out, made
    real on ``device``: ``tokens`` and ``labels`` [B, S - P] of the
    synthetic Zipf stream's batch ``step`` (seed 0), and a ``frontend``
    [B, P, d] drawn N(0, 1) from a generator seeded with ``step``; each of
    the specs' shape and dtype."""
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


def train_prefixed(run: dict) -> dict:
    """A vlm or audio model of phase 8 with its frontend prefix, float32,
    through ``make_train_step`` on the batches ``prefixed_batch`` makes of
    ``train_batch_specs`` (the ``Trainer``'s synthetic stream emits no
    frontend, in the reference too): first its reduced model card against
    CPU, then ``steps`` AdamW steps from a random init made on the card,
    each timed to the card's end, their launches set to 0 before the first
    and read after the last (``_step_launches`` a step, no remat: the
    activations fit); every loss finite, the first near a random init's
    ln V + 1/2, the last below the first; the peak memory; one traced
    step."""
    import dataclasses
    import gc
    import statistics
    import torch
    from repro_torch.configs import InputShape, get_config
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step

    t_phase = time.perf_counter()
    out = {"reduced_vs_cpu": train_reduced_vs_cpu(run)}
    cfg = get_config(run["arch"])
    if run["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=run["layers"])
    shape = InputShape("train", "train", run["seq"], run["batch"])
    steps = run["steps"]
    opt = AdamWConfig(lr=run["lr"], warmup_steps=TRAIN_WARMUP,
                      total_steps=steps)
    counters = _train_counters()
    per_step = _step_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEVICE)
    opt_state = init_opt_state(params)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    step = make_train_step(cfg, opt, remat=False)
    losses, norms, walls = [], [], []
    _reset(counters)
    for i in range(steps):
        batch = prefixed_batch(cfg, shape, i, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = step(params, opt_state, batch)
        met = {k: float(v) for k, v in met.items()}
        walls.append(time.perf_counter() - t0)
        losses.append(met["loss"])
        norms.append(met["grad_norm"])
        print(f"[train] {cfg.name} step {i + 1} loss={met['loss']:.4f} "
              f"({walls[-1] * 1e3:.0f} ms)", flush=True)
    n = _counts(counters)
    _require(n == {name: steps * k for name, k in per_step.items()},
             f"{cfg.name}'s launches over {steps} prefixed steps {n}: want "
             f"{per_step} a step")
    n_text = batch["tokens"].numel()
    out.update(launches_straight=n, launches_per_step=per_step,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses, grad_norms=norms,
               step_ms=[1e3 * w for w in walls],
               step_ms_p50=1e3 * statistics.median(walls[1:]),
               text_tokens_per_step=n_text,
               prefix_positions_per_step=batch["frontend"].shape[0]
               * batch["frontend"].shape[1])
    out["tokens_per_s"] = n_text / (out["step_ms_p50"] / 1e3)
    init_loss = _require_losses(cfg, losses)

    def run_step():
        float(step(params, opt_state, batch)[2]["loss"])
    traced = out["traced_step"] = _traced_step(run_step, per_step, cfg.dtype)
    del params, opt_state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    out.update(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
               params_b=n_params / 1e9, batch=run["batch"], seq=run["seq"],
               prefix=cfg.frontend_len, steps=steps,
               lr=run["lr"], warmup_steps=TRAIN_WARMUP,
               init_loss_expected=init_loss,
               phase_s=time.perf_counter() - t_phase)
    print(f"[train] {out}", flush=True)
    print(f"[train] {cfg.name} x {cfg.n_layers} layers ({cfg.dtype}, "
          f"{out['params_b']:.3f} B params, B {run['batch']} x (P "
          f"{cfg.frontend_len} + {run['seq'] - cfg.frontend_len} text "
          f"tokens)): losses {losses}; step p50 "
          f"{out['step_ms_p50']:.1f} ms, {out['tokens_per_s']:.0f} text "
          f"tokens/s, peak {out['peak_mem_gb']:.2f} GB; of a step's card "
          f"time flash forward {100 * traced['flash_fwd_share']:.1f}%, "
          f"backward {100 * traced['flash_bwd_share']:.1f}%; "
          f"{out['phase_s']:.0f} s", flush=True)
    return out


def _train_key(out: dict) -> str:
    """A phase-8 run's name: ``train:<arch>x<layers>``, and ``:bfloat16``
    after it for a bfloat16 run."""
    key = f"train:{out['arch']}x{out['layers']}"
    return key if out["dtype"] == "float32" else f"{key}:{out['dtype']}"


def train(report: dict) -> dict:
    """Phase 8: ``train_one`` for each of ``TRAIN_RUNS``, then
    ``train_prefixed`` for each of ``TRAIN_PREFIXED``, one after the other.
    Returns ``{_train_key(result): result}``."""
    trained = {}
    for run in TRAIN_RUNS:
        out = train_one(run)
        trained[_train_key(out)] = out
    for run in TRAIN_PREFIXED:
        out = train_prefixed(run)
        trained[_train_key(out)] = out
    report["train"] = trained
    return trained


# -- phase 9: dry-run and placement -----------------------------------------------
# (a) The dry-run's meta sweep in this process: every arch x shape on both
# production meshes (80 cells).
DRYRUN_MESHES = ("single", "multi")
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun_torch"
# (b) granite-8b x 8, phase 8's bfloat16 run, as a host-mesh cell, in
# float32 and bfloat16: the argument bytes the dry-run predicts are held to
# what the card allocates for them
GROUND = {"arch": "granite-8b", "layers": 8, "batch": 2, "seq": 2048}
GROUND_ARG_TOL = 0.01
# (c) the torch placement score: the node DAG under a queue penalty, and
# seeded draws of (PTT values, loads) scored on the card
SCORE_PENALTY = 0.05
SCORE_DRAWS = 10_000


def dryrun_sweep() -> dict:
    """Phase 9 (a): ``dryrun.run_cell`` for every mesh of ``DRYRUN_MESHES``
    (fake process group, meta device) x arch x shape; no cell may fail."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    recs = [dryrun.run_cell(arch, shape, mesh, DRYRUN_OUT)
            for mesh in DRYRUN_MESHES for arch in ARCHS for shape in SHAPES]
    counts = {k: sum(r["status"] == k for r in recs)
              for k in ("OK", "SKIPPED", "FAIL")}
    ok = [r for r in recs if r["status"] == "OK"]
    dominant = {term: sum(r["roofline"]["dominant"] == term for r in ok)
                for term in ("compute", "memory", "collective")}
    out = {"counts": counts, "seconds": time.perf_counter() - t0,
           "dominant": dominant,
           "cells": {f"{r['arch']}__{r['shape']}__{r['mesh']}": {
               k: r.get(k) for k in ("status", "seconds", "params_counted",
                                     "fits_hbm", "error")}
               for r in recs}}
    for r in ok:
        cell = out["cells"][f"{r['arch']}__{r['shape']}__{r['mesh']}"]
        coll = r["collectives"]
        cell.update(dominant=r["roofline"]["dominant"],
                    collective_s=r["roofline"]["collective_s"],
                    collective_bytes=None if coll is None else coll["bytes"],
                    dp_grad_bytes=None if coll is None
                    else _dp_grad_bytes(coll))
    print(f"[dryrun] sweep: {counts['OK']} OK, {counts['SKIPPED']} skipped, "
          f"{counts['FAIL']} failed of {len(recs)} cells in "
          f"{out['seconds']:.1f} s; the dominant roofline term: "
          f"{dominant}", flush=True)
    _require(counts["FAIL"] == 0, "dry-run cells failed: " + ", ".join(
        k for k, v in out["cells"].items() if v["status"] == "FAIL"))
    _require(all(r["collectives"] is not None for r in ok),
             "OK dry-run cells without collectives")
    no_dp = [k for k, v in out["cells"].items() if v.get("dp_grad_bytes")
             is not None and "__train_4k__" in k and not v["dp_grad_bytes"]]
    _require(not no_dp, f"train cells with no DP gradient reduction: {no_dp}")
    return out


def _dp_grad_bytes(coll: dict) -> int:
    """The bytes of a cell's gradient reductions over the DP axes (the
    update's, and FSDP's reduce-scatters in the backward), all-reduce
    2x."""
    return sum((2 if e["kind"] == "all-reduce" else 1) * e["bytes_each"]
               * e["count"] for e in coll["entries"]
               if e["kind"] in ("all-reduce", "reduce-scatter")
               and ({"pod", "data"} & set([e["axis"]] if isinstance(
                   e["axis"], str) else e["axis"])))


def dryrun_grounding(dtype: str = "float32") -> dict:
    """Phase 9 (b): the host-mesh dry-run cell of ``GROUND`` (in ``dtype``,
    B x S, one microbatch, remat, the dry-run's step) against the same step
    on the card: the predicted argument bytes (params, AdamW state with a
    bfloat16 cell's float32 master copy, batch) within ``GROUND_ARG_TOL``
    of what ``memory_allocated`` grows by when they are built; the
    predicted peak (arguments + the step's temporaries) beside
    ``max_memory_allocated``'s growth over the step; the counted flops
    beside 6 N tokens."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
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
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    micro_grad, update = dryrun.make_accum_train_step(cfg, AdamWConfig(),
                                                      n_micro=1)
    t0 = time.perf_counter()
    gsum, loss = micro_grad(params, batch, None)
    update(params, opt_state, gsum)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    loss = float(loss)
    del params, opt_state, batch, gsum
    gc.collect()
    torch.cuda.empty_cache()
    out = {"cell": f"{cfg.name} x {cfg.n_layers} layers, {dtype}, B "
                   f"{shape.global_batch} x S {shape.seq_len}, remat",
           "predicted_args_bytes": pred_args, "allocated_args_bytes": args,
           "args_rel_err": abs(args - pred_args) / pred_args,
           "predicted_peak_bytes": pred_peak, "measured_peak_bytes": peak,
           "peak_ratio": pred_peak / peak,
           "counted_flops": rec["work"]["flops"],
           "model_flops_6nt": rec["roofline"]["model_flops"],
           "counted_over_6nt": rec["work"]["flops"]
           / rec["roofline"]["model_flops"],
           "kernels": rec["work"]["parts"]["micro"]["kernels"],
           "step_s": step_s, "loss": loss,
           "dryrun_s": rec["seconds"]}
    print(f"[dryrun] grounding {out['cell']}: arguments predicted "
          f"{pred_args / 1e9:.4f} GB, allocated {args / 1e9:.4f} GB (rel "
          f"{out['args_rel_err']:.2e}); peak predicted {pred_peak / 1e9:.2f} "
          f"GB, measured {peak / 1e9:.2f} GB (ratio {out['peak_ratio']:.3f});"
          f" flops counted {out['counted_flops']:.4e}, 6 N tokens "
          f"{out['model_flops_6nt']:.4e} ({out['counted_over_6nt']:.3f}x); "
          f"step {step_s:.2f} s", flush=True)
    _require(out["args_rel_err"] <= GROUND_ARG_TOL,
             f"predicted argument bytes {pred_args} against {args} "
             f"allocated")
    _require(math.isfinite(loss), f"grounding step's loss {loss}")
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


def dryrun_and_placement(report: dict) -> dict:
    """Phase 9: (a) the meta sweep, (b) the grounding on the card, (c) the
    torch placement score on the card."""
    out = {"sweep": dryrun_sweep(), "grounding": dryrun_grounding(),
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
    once per block a step.  The generation's logits, finite and not
    constant, against a forward of the prompt and the generated tokens on
    the trained weights at the next position, each under rel 5e-3, the
    model tolerance (its ids alone are the stream's most frequent token)."""
    import torch
    from repro_torch.examples import quickstart
    from repro_torch.models import forward
    _reset(counters)
    t0 = time.perf_counter()
    q = quickstart.main([])
    seconds = time.perf_counter() - t0
    got = _counts(counters)
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
            "seconds": seconds}


def _twin_serve_lm(counters) -> dict:
    """serve_lm: 10 of 10 requests complete under each scheduler; flash
    attention once per attention block a prefill."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_lm
    _reset(counters)
    t0 = time.perf_counter()
    res = serve_lm.main([])
    seconds = time.perf_counter() - t0
    got = _counts(counters)
    prefills = sum(r["prefills"] for r in res.values())
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
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    import dataclasses
    import torch
    from repro_torch.configs import get_config
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

    flash_err = check_flash(report)
    flash_bwd_err = check_flash_bwd(report)
    ssd_err = check_ssd(report)
    ssd_bwd_err = check_ssd_bwd(report)
    slstm_err = check_slstm(report)
    matmul_err = check_matmul(report)
    copy_err = check_copy(report)
    stencil_err = check_stencil(report)
    lap("check")
    flash_timing = time_flash(report)
    flash_bwd_timing = time_flash_bwd(report)
    ssd_timing = time_ssd(report)
    ssd_bwd_timing = time_ssd_bwd(report)
    slstm_timing = time_slstm(report)
    matmul_timing = time_matmul(report)
    copy_timing = time_copy(report)
    stencil_timing = time_stencil(report)
    lap("time")
    node = node_dag(report)
    lap("node_dag")
    served = []
    for arch, dtype in SERVED:
        served.append(serve(report, dataclasses.replace(
            get_config(arch), dtype=dtype,
            n_layers=SERVED_LAYERS.get(arch, get_config(arch).n_layers))))
        lap(f"serve:{arch}")
    trained = train(report)
    for key, out in trained.items():
        phase_s[key] = out["phase_s"]
    mark[0] = time.perf_counter()
    dryrun_and_placement(report)
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

    def flash_at(dtype, heads=(32, 8, 1024)):  # granite-8b's, S = 1024
        return next(r for r in flash_timing if r["dtype"] == dtype
                    and r["shape"][1:4] == list(heads))

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
            ("qwen3-moe-30b-a3b", flash_at("bfloat16", [32, 4, 1024])),
            ("moonshot-v1-16b-a3b", flash_at("bfloat16", [16, 16, 1024])),
            ("internvl2-76b", flash_at("bfloat16", [64, 8, 1024])))}
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
    bwd_x3 = sum({**trained_by("bwd_tf32x3"),
                  **examples_by("bwd_tf32x3")}.values())
    bwd_row["launches_by_kernel_path"] = {
        "tf32x3": bwd_x3, "fma": bwd_row["launches"] - bwd_x3}
    bf16_bwd = flash_bwd_timing["bfloat16"]
    bwd_row["bfloat16"] = {
        "path": bf16_bwd["path"], "shape": bf16_bwd["shape"],
        "max_abs_err": flash_bwd_err["bfloat16"],
        "launches": sum(trained_by("bwd_fma").values()),
        "ms": bf16_bwd["ms"], "plain_ms": bf16_bwd["plain_ms"],
        "bound_ms": bf16_bwd["bound_ms"], "bound_by": bf16_bwd["bound_by"],
        "fma_bound_ms": bf16_bwd["fma_bound_ms"],
        "library_ms": bf16_bwd["library_ms"]}
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
    slstm_rows[0]["train_kept"] = {k: slstm_timing["train"][k] for k in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "kept_mbytes",
        "bound_ms_with_kept", "ns_per_step")}
    slstm_rows[1]["bound_way"] = slstm_timing["bwd"]["bound_way"]
    slstm_rows[1]["bound_ms_by_way"] = slstm_timing["bwd"]["bound_ms_by_way"]
    kernels = [
        flash_row,
        bwd_row,
        kernel_row("ssd_scan",
                   next(r for r in ssd_timing if r["case"] == "zamba2"
                        and r["shape"][1] == 1024),
                   ssd_err, "src/repro/kernels/ssd_scan.py:68",
                   {**served_by("ssd_scan"), **trained_by("ssd_scan"),
                    **examples_by("ssd_scan")}),
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
