"""The torch placement score's time a call, on the card and on the CPU,
inside the node DAG and alone.

    python tools/torch_score_probe.py [--rounds 2]

Runs ``chip_smoke.py``'s node DAG (phase 5's: 96 tasks of the node
kernels on the threaded runtime, ``tpu_pod_slices(2, 2)`` under DAM-C,
place 0 slowed 4x) under ``queue_penalty=0.05``, ``track_load`` and
``placement_backend="torch"``, the hook on the card and on the CPU
(``make_score_fn("cpu")``) in turns (card, cpu, cpu, card a round), each
call timed on the host clock; then each hook alone on
``chip_smoke.py``'s seeded draws.  Both compute the same float32 score:
what the card's costs beside the CPU's is the card's part; what either
costs inside the DAG beyond alone is the runtime's (its threads, the
interpreter lock).  Prints one JSON object (the card's name and power
limit; µs a call, median and mean, by hook and where) and appends it to
``chiprun_out/score_probe.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _in_dag(cs, device: str) -> list[float]:
    """Seconds of each score call that reaches the hook's device in one
    node DAG run under the torch score on ``device``."""
    from repro_torch.core import make_scheduler, tpu_pod_slices
    from repro_torch.core.placement_torch import make_score_fn
    sched = make_scheduler("DAM-C", tpu_pod_slices(2, 2), seed=0,
                           queue_penalty=cs.SCORE_PENALTY, track_load=True)
    hook = make_score_fn(device)
    calls = []

    def timed(vals, load, penalty):
        t0 = time.perf_counter()
        score = hook(vals, load, penalty)
        if load is not None:
            calls.append(time.perf_counter() - t0)
        return score

    sched.score_fn = timed
    metrics, *_ = cs.run_node_dag(cs.NODE_TILES, cs.DEVICE, sched=sched)
    if metrics.errors or metrics.n_tasks != cs.NODE_TASKS:
        raise RuntimeError(f"node DAG: {metrics.n_tasks} tasks, "
                           f"{metrics.errors}")
    return calls


def _alone(device: str, draws: int) -> list[float]:
    import numpy as np
    from repro_torch.core.placement_torch import make_score_fn
    hook = make_score_fn(device)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(draws):
        n = int(rng.integers(2, 65))
        vals, load = rng.exponential(1e-3, n), rng.exponential(5e-3, n)
        penalty = float(rng.uniform(0.0, 1.0))
        t0 = time.perf_counter()
        hook(vals, load, penalty)
        out.append(time.perf_counter() - t0)
    return out


def _us(samples: list[float]) -> dict:
    return {"calls": len(samples),
            "median_us": 1e6 * statistics.median(samples),
            "mean_us": 1e6 * statistics.fmean(samples)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--draws", type=int, default=2000)
    args = ap.parse_args()
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_score_probe: no CUDA device")
    in_dag = {"cuda": [], "cpu": []}
    cs.run_node_dag(cs.NODE_TILES, cs.DEVICE)            # warm-up
    for _ in range(args.rounds):
        for device in ("cuda", "cpu", "cpu", "cuda"):
            in_dag[device] += _in_dag(cs, device)
    alone = {device: _alone(device, args.draws) for device in ("cuda", "cpu")}
    out = {"nvidia_smi": cs._smi(),
           "in_node_dag": {k: _us(v) for k, v in in_dag.items()},
           "alone": {k: _us(v) for k, v in alone.items()}}
    print(json.dumps(out), flush=True)
    path = ROOT / "chiprun_out" / "score_probe.jsonl"
    path.parent.mkdir(exist_ok=True)
    with path.open("a") as f:
        f.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    main()
