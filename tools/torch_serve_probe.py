"""Where a served request's time goes in the PyTorch port, on the card.

    python tools/torch_serve_probe.py [--arch ARCH] [--dtype bfloat16]
        [--reduced] [--device cuda] [--graph]

Full-width ``--arch`` (granite-8b by default; random weights from a seed)
unless ``--reduced``, in the config's dtype unless ``--dtype`` overrides
it (the MoE models fit the card only in bfloat16).  Measures, outside the
engine:

* one prefill (S = 1024): wall time, and the device time by kernel name
  from ``torch.profiler`` (flash attention against the GEMMs and the rest);
* one decode step on one thread: the host's dispatch time (until
  ``decode_step`` returns), the wall time (until ``int(argmax)`` returns,
  as the engine's payload does), the device time and the kernel count;
* decode steps on 4 threads at once, each with its own request state, as
  the engine's 4 places run them on one card: wall time per step.

With ``--graph`` (on the card), the eager step against the engine's
graphed one (``serve/decode_graph.py``, one slot a thread), in alternating
calls within this one run (a decode p50 can move 2x between runs): for
each, the host's dispatch time (until the step is issued), the wall time
(until ``int(argmax)``), the card time and kernels of one traced step (its
memory copies apart), and the steps per second of 4 threads
at once; with each slot's capture seconds and card memory.  Also the card
time of each kind of block of one decode step, traced alone (the
attention's core, ``ops.decode_attention``, apart from its block), times
the blocks of that kind.

Prints one JSON object and writes it to
``chiprun_out/serve_probe-<arch>.json``.
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
    """Device time (ms) by kernel name for one call of ``fn``: the kernels'
    own events only (an operator's event carries the time of the kernels
    it launched too, so counting both would count each kernel twice)."""
    from torch.autograd import DeviceType
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
        if ev.device_type == DeviceType.CUDA:
            ms = ev.self_device_time_total / 1e3
            rows[ev.key] = rows.get(ev.key, 0.0) + ms
            n_kernels += ev.count
    return dict(sorted(rows.items(), key=lambda kv: -kv[1])), n_kernels


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.clone()


def _copies(by_kernel: dict) -> float:
    """The card time of a trace's memory copies (its ``Memcpy`` events:
    a graphed step's state copies and the copies the step makes itself)."""
    return sum(v for k, v in by_kernel.items() if k.startswith("Memcpy"))


def decode_parts(params, cfg, state, tok: int, device) -> dict:
    """The card time of one decode step by kind of block, each traced
    alone on a copy of ``state``: the first block of each kind once, times
    the blocks of that kind in the plan; for attention, the core
    (``ops.decode_attention`` on the first cache) apart too."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import layer_plan
    from repro_torch.models import transformer as tf
    plan = layer_plan(cfg)
    st = _tree_clone(state)
    x = tf._lookup(params["embed"], torch.tensor([tok], device=device))
    x = x[:, None, :]
    out: dict = {}
    seen: set = set()
    with torch.inference_mode():
        for kind, p, i in tf._walk(params, cfg):
            if kind in seen:
                continue
            seen.add(kind)
            slot = tf._layer(st[tf._STATE_KEY[kind]], i)
            by_kernel, n = _profile(
                lambda: tf._block_decode(cfg, kind, p, x, slot), device)
            count = plan.count(kind)
            out[f"{kind}_block"] = {"ms": sum(by_kernel.values()) * count,
                                    "kernels": n * count, "blocks": count}
            if kind in tf._ATTN:
                q = torch.randn((1, cfg.n_heads, cfg.resolved_head_dim),
                                device=device).to(slot["k"].dtype)
                by_kernel, n = _profile(
                    lambda: ops.decode_attention(q, slot["k"], slot["v"],
                                                 slot["length"]), device)
                out[f"{kind}_core"] = {"ms": sum(by_kernel.values()) * count,
                                       "kernels": n * count}
    return out


def graph_ab(params, cfg, device, max_len: int, start, steps: int) -> dict:
    """The eager step against the graphed one, in alternating calls, from
    the same prefill's state ``start = (state, token)`` (each mode on its
    own copy); the 4-thread rate likewise, in turns eager, graphed,
    graphed, eager."""
    import torch
    from repro_torch.models import decode_step
    from repro_torch.serve.decode_graph import DecodeSlot
    slots = [DecodeSlot(params, cfg, max_len, device) for _ in range(4)]
    out: dict = {"capture_s": [s.capture_s for s in slots],
                 "device_bytes": [s.device_bytes for s in slots],
                 "pool_bytes": [s.pool_bytes for s in slots],
                 "state_bytes": slots[0].state_bytes}

    def eager(st, t):
        with torch.inference_mode():
            toks = torch.tensor([t], device=device)
            t0 = time.perf_counter()
            logits, st = decode_step(params, cfg, st, toks)
            t1 = time.perf_counter()
            nxt = int(torch.argmax(logits[0]))
        return nxt, t1 - t0, time.perf_counter() - t0

    def graphed(st, t, slot=slots[0]):
        t0 = time.perf_counter()
        slot.launch(st, t)
        t1 = time.perf_counter()
        nxt = int(slot.argmax)
        return nxt, t1 - t0, time.perf_counter() - t0

    modes = {"eager": eager, "graphed": graphed}
    runs = {m: (_tree_clone(start[0]), start[1]) for m in modes}
    times: dict = {m: {"host": [], "wall": []} for m in modes}
    for i in range(steps + 2):
        order = ("eager", "graphed") if i % 2 == 0 else ("graphed", "eager")
        for m in order:
            st, t = runs[m]
            nxt, h, w = modes[m](st, t)
            runs[m] = (st, nxt)
            if i >= 2:                      # two warm-up turns
                times[m]["host"].append(h)
                times[m]["wall"].append(w)
    for m in modes:
        st, t = runs[m]
        by_kernel, n = _profile(lambda: modes[m](st, t), device)
        out[m] = {"host_dispatch_ms": 1e3 * statistics.median(
                      times[m]["host"]),
                  "wall_ms": 1e3 * statistics.median(times[m]["wall"]),
                  "card_ms": sum(by_kernel.values()),
                  "copies_card_ms": _copies(by_kernel),
                  "kernels": n,
                  "top_kernels_ms": dict(list(by_kernel.items())[:6])}

    def four_threads(mode) -> float:
        done = [0] * 4

        def worker(i):
            st, t = _tree_clone(start[0]), start[1]
            for _ in range(steps):
                if mode == "eager":
                    t = eager(st, t)[0]
                else:
                    t = graphed(st, t, slots[i])[0]
                done[i] += 1
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        span = time.perf_counter() - t0
        if sum(done) != 4 * steps:
            raise RuntimeError(f"4 threads ({mode}): {done} steps")
        return sum(done) / span

    rates: dict = {m: [] for m in modes}
    for m in ("eager", "graphed", "graphed", "eager"):
        rates[m].append(four_threads(m))
    for m in modes:
        out[m]["steps_per_s_4threads"] = rates[m]
    for slot in slots:
        slot.close()
    return out


def main(argv=None) -> dict:
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--graph", action="store_true",
                    help="time the eager step against the graphed one")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    params = init_params(cfg, 0, device)
    rng = np.random.default_rng(0)
    s = args.prompt_len
    max_len = s + args.steps + 8
    out: dict = {"arch": cfg.name, "dtype": cfg.dtype, "device": str(device),
                 "prompt_len": s}
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
    out["decode_parts"] = decode_parts(params, cfg, state, tok, device)
    if args.graph:
        if device.type != "cuda":
            raise SystemExit("--graph times CUDA graphs: it needs the card")
        out["graph"] = graph_ab(params, cfg, device, max_len,
                                one_prefill(prompt), args.steps)

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
    (out_dir / f"serve_probe-{cfg.name}.json").write_text(
        json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
