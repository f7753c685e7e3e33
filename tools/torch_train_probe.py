"""The eager train step against the captured one (``train/step_graph.py``),
on the card, in alternating calls within one run.

    python tools/torch_train_probe.py --arch musicgen-large --dtype bfloat16
    python tools/torch_train_probe.py --arch granite-8b --layers 1

Full-width ``--arch`` (random weights from seed 0) at ``--layers`` of its
depth (all by default), in ``--dtype`` (the config's by default; bfloat16
keeps a float32 master copy and moments), B ``--batch`` x S ``--seq`` (a
prefixed model's frontend takes P of the S positions, as
``train_batch_specs`` lays them out), no remat unless ``--remat``.

One set of params and optimizer state, which both steps update in place:
the eager ``make_train_step`` and a ``TrainStepGraph`` over the same
tensors (its first step its warm-up and capture).  After two warm-up
rounds, ``--rounds`` rounds of one step each, the order alternating
(eager, graphed; graphed, eager; ...).  For each: the host's dispatch time
(until the step returns, its work issued), the wall time (until the loss
reaches the host, as the ``Trainer`` reads it), and, from one step traced
with ``torch.profiler``, the card time and count of its kernels and the
largest of them; the wall time less the card time is what the card sat
idle for the host.  Also the graph's capture seconds and pool, the peak
memory, and the card's name and power limit.

Prints one JSON object and writes it to
``chiprun_out/train_probe-<arch>x<layers>-<dtype>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _profile(fn) -> tuple[dict, int]:
    """Card time (ms) by kernel name for one call of ``fn``, and the count
    of kernels: the kernels' own events only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, n = {}, 0
    for ev in prof.key_averages():
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            rows[ev.key] = rows.get(ev.key, 0.0) + (
                ev.self_device_time_total / 1e3)
            n += ev.count
    return dict(sorted(rows.items(), key=lambda kv: -kv[1])), n


def batch_maker(cfg, shape, device):
    """Batch ``i`` as ``train_batch_specs`` lays it out: the synthetic Zipf
    stream's tokens and labels, a frontend N(0, 1) for a prefixed model."""
    import numpy as np
    import torch
    from repro_torch.configs import train_batch_specs
    from repro_torch.data import DataConfig, SyntheticStream
    specs = train_batch_specs(cfg, shape)
    stream = SyntheticStream(DataConfig(
        vocab=cfg.vocab, seq_len=specs["tokens"].shape[1],
        global_batch=shape.global_batch, seed=0))

    def batch(i):
        out = {k: torch.as_tensor(np.asarray(v), device=device)
               for k, v in stream.batch_at(i).items()}
        if "frontend" in specs:
            g = torch.Generator(device=device).manual_seed(i)
            out["frontend"] = torch.randn(
                specs["frontend"].shape, generator=g,
                device=device).to(specs["frontend"].dtype)
        return out
    return specs, batch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-5)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_probe times the card: no CUDA device")
    from repro_torch.configs import InputShape, get_config
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import make_train_step
    from repro_torch.train.step_graph import TrainStepGraph

    device = torch.device("cuda")
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, dtype=args.dtype or cfg.dtype,
                              n_layers=args.layers or cfg.n_layers)
    shape = InputShape("train", "train", args.seq, args.batch)
    specs, batch = batch_maker(cfg, shape, device)
    opt = AdamWConfig(lr=args.lr, warmup_steps=2, total_steps=10_000)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=device)
    state = init_opt_state(params)
    eager_fn = make_train_step(cfg, opt, remat=args.remat)
    graph = TrainStepGraph(cfg, opt, params, state, specs, remat=args.remat)

    def eager(b):
        t0 = time.perf_counter()
        _, _, met = eager_fn(params, state, b)
        t1 = time.perf_counter()
        float(met["loss"])
        return t1 - t0, time.perf_counter() - t0

    def graphed(b):
        t0 = time.perf_counter()
        met = graph.step(b)
        t1 = time.perf_counter()
        float(met["loss"])
        return t1 - t0, time.perf_counter() - t0

    modes = {"eager": eager, "graphed": graphed}
    times = {m: {"host": [], "wall": []} for m in modes}
    i = 0
    for r in range(args.rounds + 2):
        order = ("eager", "graphed") if r % 2 == 0 else ("graphed", "eager")
        for m in order:
            b = batch(i)
            i += 1
            torch.cuda.synchronize()
            host, wall = modes[m](b)
            if r >= 2:                  # two warm-up rounds
                times[m]["host"].append(host)
                times[m]["wall"].append(wall)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "params_b": sum(t.numel() for t in leaves(params)) / 1e9,
           "batch": args.batch, "seq": args.seq, "remat": args.remat,
           "rounds": args.rounds,
           "graph": {"warmup_s": graph.warmup_s,
                     "capture_s": graph.capture_s,
                     "pool_gib": graph.pool_bytes / 2**30,
                     "replays": graph.replays}}
    for m in modes:
        b = batch(i)
        i += 1
        torch.cuda.synchronize()
        by_kernel, n = _profile(lambda: modes[m](b))
        card = sum(by_kernel.values())
        wall = 1e3 * statistics.median(times[m]["wall"])
        out[m] = {"host_dispatch_ms": 1e3 * statistics.median(
                      times[m]["host"]),
                  "wall_ms": wall, "wall_ms_all": [1e3 * w for w in
                                                   times[m]["wall"]],
                  "card_ms": card, "idle_ms": wall - card,
                  "kernels": n,
                  "top_kernels_ms": {k[:70]: v for k, v in
                                     list(by_kernel.items())[:6]}}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    graph.close()
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(out), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"train_probe-{args.arch}x{cfg.n_layers}-{cfg.dtype}.json"
     ).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
