"""Where a served request's time goes in the PyTorch port, on the card.

    python tools/torch_serve_probe.py [--reduced] [--device cuda]

Full-width granite-8b (random weights from a seed) unless ``--reduced``.
Measures, outside the engine:

* one prefill (S = 1024): wall time, and the device time by kernel name
  from ``torch.profiler`` (flash attention against the GEMMs and the rest);
* one decode step on one thread: the host's dispatch time (until
  ``decode_step`` returns), the wall time (until ``int(argmax)`` returns,
  as the engine's payload does), the device time and the kernel count;
* decode steps on 4 threads at once, each with its own request state, as
  the engine's 4 places run them on one card: wall time per step.

Prints one JSON object and writes it to ``chiprun_out/serve_probe.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def _profile(fn, device):
    """Device time (ms) by kernel name for one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        _sync(device)
    rows = {}
    n_kernels = 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or getattr(
            ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows[ev.key] = rows.get(ev.key, 0.0) + dev_us / 1e3
            n_kernels += ev.count
    return dict(sorted(rows.items(), key=lambda kv: -kv[1])), n_kernels


def main(argv=None) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config("granite-8b")
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, 0, device)
    rng = np.random.default_rng(0)
    s = args.prompt_len
    max_len = s + args.steps + 8
    out: dict = {"arch": cfg.name, "device": str(device), "prompt_len": s}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)

    def one_prefill(tokens):
        with torch.inference_mode():
            logits, state = prefill(params, cfg, tokens, max_len)
            return state, int(torch.argmax(logits[0]))

    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, s),
                             device=device)[None]
    one_prefill(prompt)                                   # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, tok = one_prefill(prompt)
        walls.append(time.perf_counter() - t0)
    out["prefill_ms"] = 1e3 * statistics.median(walls)
    by_kernel, n = _profile(lambda: one_prefill(prompt), device)
    total = sum(by_kernel.values())
    flash = sum(v for k, v in by_kernel.items() if "flash_fwd" in k)
    out["prefill_device_ms"] = total
    out["prefill_flash_ms"] = flash
    out["prefill_kernels"] = n
    out["prefill_top_kernels_ms"] = dict(list(by_kernel.items())[:8])

    def step(st, t):
        with torch.inference_mode():
            toks = torch.tensor([t], device=device)
            t0 = time.perf_counter()
            logits, st = decode_step(params, cfg, st, toks)
            t1 = time.perf_counter()
            nxt = int(torch.argmax(logits[0]))
            return st, nxt, t1 - t0, time.perf_counter() - t0

    for _ in range(2):                                    # warm-up
        state, tok, _, _ = step(state, tok)
    host, wall = [], []
    for _ in range(args.steps):
        state, tok, h, w = step(state, tok)
        host.append(h)
        wall.append(w)
    out["decode_host_dispatch_ms"] = 1e3 * statistics.median(host)
    out["decode_wall_ms"] = 1e3 * statistics.median(wall)
    by_kernel, n = _profile(lambda: step(state, tok), device)
    out["decode_device_ms"] = sum(by_kernel.values())
    out["decode_kernels"] = n
    out["decode_top_kernels_ms"] = dict(list(by_kernel.items())[:6])

    # 4 threads at once, as the engine's 4 places on one card
    states = []
    for i in range(4):
        p = torch.as_tensor(rng.integers(0, cfg.vocab, min(256, s)),
                            device=device)[None]
        states.append(one_prefill(p))
    per_thread: list[list[float]] = [[] for _ in states]

    def worker(i):
        st, t = states[i]
        for _ in range(args.steps):
            st, t, _, w = step(st, t)
            per_thread[i].append(w)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(states))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    span = time.perf_counter() - t0
    all_w = [w for ws in per_thread for w in ws]
    out["decode_4threads_wall_ms"] = 1e3 * statistics.median(all_w)
    out["decode_4threads_steps_per_s"] = len(all_w) / span

    print(json.dumps(out), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "serve_probe.json").write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
