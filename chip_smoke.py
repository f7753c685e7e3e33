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
   main path's shapes and at ragged, short, batched and strongly decayed
   cases, in float32 (flash attention 2e-4, SSD scan 3e-3) and bfloat16
   (2e-2);
4. time each kernel at the prefill shapes beside its plain version, the
   PyTorch library call for the same function (SDPA for attention; none
   computes the SSD scan) and its bound;
5. serve, one after the other, full-width granite-8b, zamba2-1.2b and
   xlstm-125m (random weights from a seed) through the port's
   PTT-scheduled ``ServingEngine``: 8 requests of 256-1024 prompt tokens
   (one ragged) and 16 new tokens each, on ``tpu_pod_slices(2, 2)`` under
   DAM-C with place 0 slowed 4x; the launch counts are set to 0 just before
   each model's run and read just after, and must equal the counts that
   the model's ``layer_plan`` gives per prefill (flash attention once per
   attention block or shared-block application, the SSD scan once per
   Mamba-2 layer and twice per mLSTM layer) times the prefills;
6. check what came out, for each model: every request finished with its
   tokens; the engine's first token equals a direct prefill's; prefill +
   decode agrees with a full forward at full width; the reduced model on
   the card agrees with the CPU path (rel 5e-3, the model tolerance of the
   tests).  For xlstm-125m it also times one 1024-token prefill and the
   sLSTM loop inside it.

Prints ``{"kernels": [...]}``, then the ``nvidia-smi`` line, then, last,
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

H100_BYTES_PER_S = 3.35e12            # HBM3, H100 SXM data sheet
H100_PEAK_FLOPS = {"float32": 67e12,  # float32 outside the tensor cores
                   "bfloat16": 989e12}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SSD_TOL = {"float32": 3e-3, "bfloat16": 2e-2}

DEVICE = "cuda"
ARCHS = ("granite-8b", "zamba2-1.2b", "xlstm-125m")
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


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_work(b, hq, hkv, s, t, d, dtype, causal=True):
    """(flops, bytes) the attention function needs on these shapes: 4*D
    flops per live (query, key) pair; q, k, v read once, o written once."""
    if causal:                       # row i sees keys 0 .. i + T - S
        pairs = s * (t - s) + s * (s + 1) // 2
    else:
        pairs = s * t
    flops = 4 * b * hq * d * pairs
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * t * d) * dtype.itemsize
    return flops, nbytes


def _bound(flops, nbytes, dtype_name):
    t_ops = flops / H100_PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _qkv(b, hq, hkv, s, t, d, dtype, seed):
    import torch
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    return [torch.randn(shape, generator=g, device=DEVICE).to(dtype)
            for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d))]


def check_flash(report: dict) -> float:
    """Kernel against its plain version on the card.  Returns the largest
    float32 error at the main path's head layouts: granite-8b's (Hq 32,
    Hkv 8, D 128) and zamba2-1.2b's shared attention (Hq = Hkv = 32, D 64)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    cases = [  # (b, hq, hkv, s, t, d, causal)
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
    ]
    main_layouts = {(32, 8, 128), (32, 32, 64)}
    worst_main = 0.0
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for i, (b, hq, hkv, s, t, d, causal) in enumerate(cases):
            q, k, v = _qkv(b, hq, hkv, s, t, d, dtype, seed=i)
            got = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = flash_attention_plain(q, k, v, causal=causal)
            err = (got.float() - want.float()).abs()
            limit = TOL[name] * (1.0 + want.float().abs())
            ok = bool((err <= limit).all()) and bool(torch.isfinite(got).all())
            row = {"dtype": name, "shape": [b, hq, hkv, s, t, d],
                   "causal": causal, "max_abs_err": float(err.max()),
                   "tol": TOL[name], "ok": ok}
            rows.append(row)
            print(f"[check] flash_attention {row}", flush=True)
            _require(ok, f"flash attention kernel against its plain "
                         f"version: {row}")
            if name == "float32" and (hq, hkv, d) in main_layouts:
                worst_main = max(worst_main, row["max_abs_err"])
    report["flash_attention_checks"] = rows
    return worst_main


def time_flash(report: dict) -> list[dict]:
    """Kernel, plain version, SDPA and the bound at the prefill shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    rows = []
    for dtype, s in ((torch.float32, 256), (torch.float32, 512),
                     (torch.float32, 1024), (torch.bfloat16, 1024)):
        name = str(dtype).removeprefix("torch.")
        q, k, v = _qkv(1, 32, 8, s, s, 128, dtype, seed=99)
        ms = _time_ms(lambda: flash_attention(q, k, v), iters=20)
        plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v), iters=3,
                            warmup=1)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters=20)
        flops, nbytes = _attention_work(1, 32, 8, s, s, 128, dtype)
        bound_ms, bound_by = _bound(flops, nbytes, name)
        row = {"dtype": name, "shape": [1, 32, 8, s, s, 128], "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": flops / (ms * 1e-3) / 1e12}
        rows.append(row)
        print(f"[time] flash_attention {row}", flush=True)
    report["flash_attention_timing"] = rows
    return rows


def _ssd_work(b, s, h, d, n, dtype):
    """(flops, bytes) the SSD scan needs at the kernel's chunk length L.
    Per chunk of l tokens, over the l (l + 1) / 2 live (t, u) pairs of the
    causal triangle: C . B^T once per batch (b and c are shared by the
    heads); per (batch, head) the decay of each pair, G @ x, and C . h^T
    and the state update over l x D x N each.  x, a, b, c read once, y
    written once."""
    from repro_torch.kernels.ssd_scan import CHUNK
    per_batch = per_head = 0
    for t0 in range(0, s, CHUNK):
        ln = min(CHUNK, s - t0)
        pairs = ln * (ln + 1) // 2
        per_batch += 2 * pairs * n
        per_head += 2 * pairs * d + pairs + 4 * ln * d * n
    flops = b * per_batch + b * h * per_head
    nbytes = (2 * b * s * h * d + b * s * h + 2 * b * s * n) * dtype.itemsize
    return flops, nbytes


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
# S shorter than one chunk, B > 1 with D and N that the tiles do not divide
SSD_CASES = [
    (1, 256, 32, 128, 64, "mild"),
    (1, 1024, 32, 128, 64, "mild"),
    (1, 300, 32, 128, 64, "mild"),
    (4, 512, 1, 384, 384, "mlstm"),
    (4, 512, 1, 1, 384, "mlstm"),
    (4, 300, 1, 384, 384, "strong"),
    (2, 37, 4, 32, 16, "mild"),
    (3, 200, 2, 48, 100, "mlstm"),
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
            ok = (bool((err <= limit).all())
                  and bool(torch.isfinite(got).all())
                  and got.dtype == dtype and got.shape == x.shape)
            row = {"dtype": name, "shape": [b, s, h, d, n], "decay": decay,
                   "max_abs_err": float(err.max()),
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
    """Kernel, plain version and the bound at the served shapes, float32
    (no single PyTorch call computes the scan: library_ms is null)."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
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
                                iters=3, warmup=1)
            flops, nbytes = _ssd_work(b, s, h, d, n, torch.float32)
            bound_ms, bound_by = _bound(flops, nbytes, "float32")
            row = {"case": label, "dtype": "float32", "shape": [b, s, h, d, n],
                   "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                   "tflops": flops / (ms * 1e-3) / 1e12}
            rows.append(row)
            print(f"[time] ssd_scan {row}", flush=True)
    report["ssd_scan_timing"] = rows
    return rows


def _launches_per_prefill(cfg) -> dict:
    """Kernel launches one prefill makes, from the model's layer plan."""
    from repro_torch.models import layer_plan
    plan = layer_plan(cfg)
    return {"flash_attention": sum(k in ("attn", "shared_attn") for k in plan),
            "ssd_scan": plan.count("mamba2") + 2 * plan.count("mlstm")}


def serve(report: dict, cfg) -> dict:
    """The main path: the model of ``cfg`` through the port's engine."""
    import numpy as np
    import torch
    from repro_torch.core import tpu_pod_slices
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.serve import ServingEngine

    counters = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches}

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

    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    metrics = engine.run(timeout=900)
    wall = time.perf_counter() - t0
    n_launch = {name: c.count for name, c in counters.items()}

    stats = engine.latency_stats()
    n_prefill = sum(1 for r in metrics.records if r.priority == 1)
    _require(stats["completed"] == len(prompts), f"completed {stats}")
    for r in reqs:
        _require(len(r.out_tokens) == NEW_TOKENS
                 and all(0 <= t < cfg.vocab for t in r.out_tokens),
                 f"request {r.rid} tokens {r.out_tokens}")
    _require(n_prefill == len(prompts), f"{n_prefill} prefills")
    per_prefill = _launches_per_prefill(cfg)
    for name, n in per_prefill.items():
        _require(n_launch[name] == n * n_prefill,
                 f"{cfg.name}: {name} launched {n_launch[name]} times for "
                 f"{n_prefill} prefills of {n} launches each")
    dec = sorted(r.duration for r in metrics.records
                 if r.type_name.startswith("decode"))
    n_tokens = sum(len(r.out_tokens) for r in reqs)
    out = {
        "arch": cfg.name, "params_b": n_params / 1e9, "init_s": init_s,
        "requests": len(prompts), "prompt_lens": list(PROMPT_LENS),
        "new_tokens": NEW_TOKENS, "scheduler": "DAM-C",
        "slowdown": {str(k): v for k, v in SLOW_PLACE.items()},
        "wall_s": wall, "launches": n_launch,
        "launches_per_prefill": per_prefill, "prefills": n_prefill,
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
        # prefill + decode agrees with a full forward (full width)
        full, _ = forward(engine.params, cfg, toks)
        _, state = prefill(engine.params, cfg, toks[:, :-2], max_len)
        for i in (2, 1):
            step, state = decode_step(engine.params, cfg, state, toks[:, -i])
            rel = _rel(step, full[:, -i])
            _require(bool(torch.isfinite(step).all()) and rel < 5e-3,
                     f"prefill + decode against forward: rel {rel}")
            out["prefill_decode_vs_forward_rel"] = rel
        if cfg.family == "ssm":
            out["prefill_split"] = slstm_share(engine.params, cfg, prompts[1])
    del engine
    torch.cuda.empty_cache()
    out["reduced_cuda_vs_cpu_rel"] = reduced_vs_cpu(cfg.reduced())
    print(f"[check] {cfg.name}: prefill+decode vs forward rel "
          f"{out['prefill_decode_vs_forward_rel']:.3e}; reduced model card "
          f"vs CPU rel {out['reduced_cuda_vs_cpu_rel']:.3e}", flush=True)
    report.setdefault("serve", {})[cfg.name] = out
    return out


def slstm_share(params, cfg, prompt) -> dict:
    """One prefill of ``prompt`` on one thread, and the sLSTM blocks of the
    model run alone on a hidden state of the same shape, in turns, 3 times
    each after a warm-up: the share of the prefill's wall time (medians)
    that the sLSTM Python loop takes."""
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


def reduced_vs_cpu(cfg) -> float:
    """The reduced model on the card (kernel) against the CPU path (plain
    version) with the same weights: logits and greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step, init_params, prefill

    cpu = init_params(cfg, seed=1, device="cpu")
    gpu = _tree_to(cpu, DEVICE)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 150))
    worst = 0.0
    with torch.inference_mode():
        outs = []
        for params, dev in ((cpu, "cpu"), (gpu, DEVICE)):
            t = torch.as_tensor(toks, device=dev)
            logits, state = prefill(params, cfg, t, 160)
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
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32,
    torch.backends.cudnn.allow_tf32 = False         # as the reference's
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
                if "registers" in ln or "smem" in ln]
        print(f"[build] {name}: {res['seconds']:.1f} s {regs}", flush=True)

    flash_err = check_flash(report)
    ssd_err = check_ssd(report)
    flash_timing = time_flash(report)
    ssd_timing = time_ssd(report)
    served = [serve(report, get_config(arch)) for arch in ARCHS]

    def kernel_row(name, row, max_err, replaces):
        by_path = {o["arch"]: o["launches"][name] for o in served}
        return {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": max_err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"],
            "launches_by_path": by_path,
        }

    kernels = [
        kernel_row("flash_attention",
                   next(r for r in flash_timing if r["dtype"] == "float32"
                        and r["shape"][3] == 1024),
                   flash_err, "src/repro/kernels/flash_attention.py:79"),
        kernel_row("ssd_scan",
                   next(r for r in ssd_timing if r["case"] == "zamba2"
                        and r["shape"][1] == 1024),
                   ssd_err, "src/repro/kernels/ssd_scan.py:68"),
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
