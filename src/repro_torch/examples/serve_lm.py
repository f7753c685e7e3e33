"""Serving example: batched requests through the PTT-scheduled engine,
comparing RWS vs DAM-P when one submesh is interfered (twin of
``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The places are worker slots of the threaded runtime sharing one device
(the card unless ``--device cpu``); place 0 is slowed 4x.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import get_config
from ..core import tpu_pod_slices
from ..serve import ServingEngine

SLOW = {0: 4.0}                                    # submesh 0 interfered 4x
REQUESTS = 10


def main(argv=None) -> dict:
    """Returns each scheduler's latency stats, prefill placement and the
    prefill graphs its engine captured (none on the CPU)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("stablelm-3b").reduced()
    topo = tpu_pod_slices(pods=2, slices_per_pod=2)   # 4 schedulable submeshes
    out = {}
    for sched in ("RWS", "DAM-P"):
        engine = ServingEngine(cfg, topo, scheduler=sched, max_len=64,
                               slowdown=SLOW, device=args.device)
        rng = np.random.default_rng(0)
        for _ in range(REQUESTS):
            engine.submit(rng.integers(0, cfg.vocab, size=24),
                          max_new_tokens=4)
        m = engine.run(timeout=300)
        stats = engine.latency_stats()
        captures = engine.prefill_graph_stats()["captures"]
        engine.close()
        pp = m.priority_placement()
        on_slow = sum(v for k, v in pp.items() if k.startswith("(C0"))
        print(f"{sched:6s}: completed={stats['completed']} "
              f"ttft_mean={stats['ttft_ms_mean']:.0f}ms "
              f"p95={stats['ttft_ms_p95']:.0f}ms "
              f"prefills_on_slow_submesh={on_slow*100:.0f}%")
        out[sched] = {"stats": stats, "prefills_on_slow": on_slow,
                      "prefills": sum(1 for r in m.records
                                      if r.priority == 1),
                      "prefill_captures": captures}
    print("\nDAM-P learns the slow submesh from measured wall times and "
          "steers prefills (critical tasks) away from it.  Wall times of "
          "requests this small are noisy — see "
          "tests/test_runtime_threaded.py and the simulator benchmarks for "
          "the controlled version of this experiment.")
    return out


if __name__ == "__main__":
    main()
