"""Serving from the command line: batched requests through the
PTT-scheduled engine, showing criticality-aware placement under injected
interference.  Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --requests 8 --prompt-len 512 --scheduler DAM-C --slow-core 0:4

``--reduced`` serves the small same-family config (``ModelConfig.reduced``)
instead of the full-width one; ``--dtype`` overrides the config's dtype, as
the reference's dry-run does.  Every registered arch serves on one 80 GB
card at full width; stablelm-3b (head dim 80), granite-8b, zamba2-1.2b,
xlstm-125m and musicgen-large in float32, while the MoE models, qwen2.5-14b
and nemotron-4-15b fit only in bfloat16 (internvl2-76b only cut in depth):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --dtype bfloat16 --scheduler DAM-C
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2.5-14b --dtype bfloat16

Each decode step replays a captured CUDA graph on the card, and each
prefill the graph of its prompt's length bucket (the CPU runs their plain
versions through the same decode slots and prefill buckets).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..configs import ARCHS
from ..core import tpu_pod_slices
from ..serve import ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=4)
    ap.add_argument("--scheduler", default="DAM-P")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--slices", type=int, default=2)
    ap.add_argument("--slow-core", default=None,
                    help="core:factor, e.g. 0:4 = core 0 runs 4x slower")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                    help="override the config's dtype")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    topo = tpu_pod_slices(args.pods, args.slices)
    slowdown = None
    if args.slow_core:
        c, f = args.slow_core.split(":")
        slowdown = {int(c): float(f)}
    engine = ServingEngine(cfg, topo, scheduler=args.scheduler,
                           max_len=args.prompt_len + args.new_tokens + 8,
                           slowdown=slowdown, device=args.device)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        engine.submit(rng.integers(0, cfg.vocab, size=args.prompt_len),
                      max_new_tokens=args.new_tokens)
    metrics = engine.run(timeout=300.0)
    stats = engine.latency_stats()
    placement = dict(metrics.priority_placement())
    graphs = engine.decode_graph_stats()
    decode = "graphed" if graphs["captures"] else "slots, plain route"
    pre = engine.prefill_graph_stats()
    prefill = "graphed" if pre["captures"] else "buckets, plain route"
    engine.close()
    print(f"[serve] {stats}")
    print(f"[serve] prefill placement: {placement}")
    print(f"[serve] decode: {decode} ({graphs['steps']} steps through "
          f"{graphs['slots']} slots, {graphs['replays']} graph replays)")
    print(f"[serve] prefill: {prefill} ({pre['steps']} prefills through "
          f"buckets {pre['buckets']}, {pre['replays']} graph replays)")
    return {"stats": stats, "placement": placement, "dtype": cfg.dtype,
            "decode": decode, "decode_graphs": graphs, "prefill": prefill,
            "prefill_graphs": pre}


if __name__ == "__main__":
    main()
